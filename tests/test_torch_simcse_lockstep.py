"""The stage-1 step of the port held in lockstep with the JAX package's, on the
CPU: the view corruption split into draws and arithmetic, the JAX package's
draws replayed through it, and the gradient where the two packages parted at
the H&M catalog (``scripts/torch_simcse_lockstep.py``): the pretrained text
encoder's projection bias, which the JAX package sums in bf16 over every RE
token of a batch (``ops/bias_sum.py``).

Tolerances, each stated where it is used: masks, draws and the bf16 sums bit
for bit; the projection's weight gradient at bf16's relative precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.models.text_encoder import PretrainedTextEncoder as JaxPretrainedTextEncoder
from recsys_tpu.ops.augment import corrupt_view as jax_corrupt_view
from recsys_tpu_torch.bridge import flax_to_torch
from recsys_tpu_torch.models.text_encoder import PretrainedTextEncoder
from recsys_tpu_torch.ops.augment import (MAX_VALUES, _bernoulli, apply_corrupt_view,
                                          corrupt_view, corrupt_view_draws)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def catalog_batch(B=192, F=9, T=32, Tn=32, seed=0):
    """Item tensors of the H&M catalog's shape: fields of 0..5 values of one
    or two tokens, names of 1..12 tokens."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 6, (B, F))
    per_value = rng.integers(1, 3, (B, F, MAX_VALUES))
    re_value = np.zeros((B, F, T), np.int32)
    for b in range(B):
        for f in range(F):
            toks = np.repeat(np.arange(1, values[b, f] + 1), per_value[b, f, :values[b, f]])
            re_value[b, f, :len(toks)] = toks[:T]
    re_mask = (re_value > 0).astype(np.int32)
    lens = rng.integers(1, 13, B)
    txt_mask = (np.arange(Tn)[None, :] < lens[:, None]).astype(np.int32)
    return {"std": rng.integers(1, 9, (B, 6)).astype(np.int32),
            "re_ids": (rng.integers(1, 500, (B, F, T)) * re_mask).astype(np.int32),
            "re_mask": re_mask, "re_value": re_value,
            "txt_ids": (rng.integers(1, 500, (B, Tn)) * txt_mask).astype(np.int32),
            "txt_mask": txt_mask}


def parent_corrupt_view(batch, generator, dropout_prob):
    """``corrupt_view`` as it was before its draws were split from its
    arithmetic, kept here as the reference of the split."""
    re_mask, re_value = batch["re_mask"], batch["re_value"]
    B, F, _ = re_mask.shape
    dev = re_mask.device
    value_drop = _bernoulli(dropout_prob, (B, F, MAX_VALUES), generator, dev)
    token_dropped = torch.gather(value_drop, 2,
                                 (re_value.long() - 1).clamp(0, MAX_VALUES - 1))
    key_drop = _bernoulli(max(dropout_prob - 0.1, 0.0), (B, F), generator, dev)
    keep = ~token_dropped & ~key_drop[..., None]
    new_re_mask = re_mask * keep.to(re_mask.dtype)
    txt_mask = batch["txt_mask"]
    gate = _bernoulli(0.5, (B,), generator, dev)
    scores = torch.rand(txt_mask.shape, generator=generator, device=dev)
    victim = torch.where(txt_mask > 0, scores, torch.full_like(scores, -1.0)).argmax(-1)
    one_hot = torch.nn.functional.one_hot(victim, txt_mask.shape[1]).to(txt_mask.dtype)
    delete = gate & (txt_mask.sum(-1) > 1)
    new_txt_mask = torch.where(delete[:, None], txt_mask * (1 - one_hot), txt_mask)
    return {**batch, "re_mask": new_re_mask, "txt_mask": new_txt_mask}


@pytest.mark.parametrize("p", [0.0, 0.2, 0.5])
def test_split_corrupt_view_gives_the_parents_masks(p):
    """The same generator state gives the same masks, bit for bit, and leaves
    the generator where the parent's left it."""
    batch = {k: torch.as_tensor(v) for k, v in catalog_batch().items()}
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    for _ in range(2):        # twice: the second view starts where the first ended
        got, ref = corrupt_view(batch, g1, p), parent_corrupt_view(batch, g2, p)
        for k in batch:
            assert torch.equal(got[k], ref[k]), k
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def jax_view_draws(batch, key, p):
    """``recsys_tpu/ops/augment.corrupt_view``'s draws from ``key``."""
    k_val, k_key, k_name_gate, k_name_pos = jax.random.split(key, 4)
    B, F, _ = batch["re_mask"].shape
    gumbel = jax.random.gumbel(k_name_pos, batch["txt_mask"].shape)
    return {"value_drop": jax.random.bernoulli(k_val, p, (B, F, MAX_VALUES)),
            "key_drop": jax.random.bernoulli(k_key, max(p - 0.1, 0.0), (B, F)),
            "name_gate": jax.random.bernoulli(k_name_gate, 0.5, (B,)),
            "victim": jnp.argmax(jnp.where(batch["txt_mask"] > 0, gumbel, -jnp.inf), -1)}


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_corrupt_view_on_the_jax_draws_is_the_jax_view(seed):
    """The JAX package's draws from one key through ``apply_corrupt_view``:
    the JAX view's masks bit for bit."""
    batch = catalog_batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    draws = {k: torch.as_tensor(np.array(v)) for k, v in
             jax_view_draws(batch, key, 0.2).items()}
    got = apply_corrupt_view({k: torch.as_tensor(v) for k, v in batch.items()}, draws)
    ref = jax_corrupt_view({k: jnp.asarray(v) for k, v in batch.items()}, key, 0.2)
    for k in ("re_mask", "txt_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert not np.array_equal(got["re_mask"].numpy(), batch["re_mask"])


def test_own_draws_have_the_jax_rates():
    """The port's own draws over the catalog-shaped batch: each drop rate
    and the name gate within 4 binomial sd of the JAX package's draws."""
    batch = catalog_batch()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    own = [corrupt_view_draws(tb, gen, 0.2) for _ in range(8)]
    jax_draws = [jax_view_draws(batch, k, 0.2) for k in jax.random.split(jax.random.PRNGKey(3), 8)]
    for name, p in (("value_drop", 0.2), ("key_drop", 0.1), ("name_gate", 0.5)):
        a = np.concatenate([d[name].numpy().ravel() for d in own])
        b = np.concatenate([np.asarray(d[name]).ravel() for d in jax_draws])
        sd = np.sqrt(p * (1 - p) / len(a))
        assert abs(a.mean() - p) < 4 * sd and abs(b.mean() - p) < 4 * sd, name


# -- the two packages' steps in lockstep -----------------------------------------------

TOY = ["data.num_users=60", "data.days=40",
       "vocab.text_vocab_size=512", "vocab.max_field_tokens=8", "vocab.max_name_tokens=8",
       "item_tower.head_hidden=[128]", "item_tower.fusion_layers=1", "item_tower.text_layers=1",
       "simcse.batch_size=16", "simcse.steps_per_epoch_min=1"]


def test_lockstep_script_keeps_both_packages_together(tmp_path):
    """``scripts/torch_simcse_lockstep.py`` at a toy world, dropout on: from
    the JAX init, with the JAX step's corruption draws and Flax's dropout
    masks, the port's step tracks the JAX package's. Each step's loss within
    2e-2 (bf16 towers at B = 16), every group's parameters within 1e-3
    relative after 3 steps, the item vectors of both within cosine 0.999."""
    import importlib.util
    import json
    import os

    spec = importlib.util.spec_from_file_location("torch_simcse_lockstep", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
        "torch_simcse_lockstep.py"))
    lockstep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lockstep)
    out = tmp_path / "lockstep.jsonl"
    assert lockstep.main(["--root", str(tmp_path / "w"), "--items", "120", "--threads", "2",
                          "--steps", "3", "--at", "1,3", "--dropout", "0.1", "--out", str(out),
                          *[a for kv in TOY for a in ("--set", kv)]]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    at = {r["at"]: r for r in rows if "at" in r}
    assert sorted(at) == [1, 3]
    losses = rows[-1]["losses"]
    assert len(losses) == 3 and all(abs(j - t) < 2e-2 for j, t in losses)
    for group in ("rest", "text"):
        gap = at[3]["gaps"][group]
        assert gap["param_gap"] < 1e-3 and gap["moved_jax"] > 0, (group, gap)
        assert gap["mu_gap"] < 0.1, (group, gap)
    assert rows[-2]["vectors"]["row_cos_min"] > 0.999


def test_jax_inits_drive_the_init_spread_script(tmp_path, capsys):
    """``torch_simcse_lockstep.py --save-jax-init`` writes the JAX package's
    init as the port's state_dict (every parameter but the frozen table);
    ``scripts/torch_init_spread.py`` trains the port from it and from its own
    init at a toy world: one line a run, the JAX-init run starting from the
    JAX init's bits. The port's own init is the JAX package's draw
    (``models/flax_init.py``), so both runs give the same numbers."""
    import importlib.util
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def script(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(repo, "scripts",
                                                                         f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    sets = [a for kv in TOY for a in ("--set", kv)]
    lockstep, spread = script("torch_simcse_lockstep"), script("torch_init_spread")
    assert lockstep.main(["--root", str(tmp_path / "w"), "--items", "120", "--threads", "2",
                          "--save-jax-init", str(tmp_path / "inits"),
                          "--save-jax-init-seeds", "42", *sets]) == 0
    saved = np.load(tmp_path / "inits" / "seed42.npz")
    assert "encoder.text_encoder.pretrained_proj.weight" in saved.files
    assert not any("pretrained_embedding" in k for k in saved.files)
    cfg = spread.cli.config_from_args(spread.cli.parse_args(
        ["train-item", "--set", "item_tower.text_encoder=pretrained", *sets]))
    table = np.zeros((512, 128), np.float32)
    start = spread.init_state("jax", 42, str(tmp_path / "inits"), table)
    np.testing.assert_array_equal(start["encoder.head.input_skip.weight"].numpy(),
                                  saved["encoder.head.input_skip.weight"])
    assert spread.init_state("own", 42, str(tmp_path / "inits"), table) is None
    assert spread.init_gap(42, str(tmp_path / "inits"), cfg, 6) <= 1e-6
    capsys.readouterr()
    assert spread.main(["--jax-init", str(tmp_path / "inits"), "--device", "cpu",
                        "--seeds", "42", "--set", "data.num_items=64", *sets]) == 0
    runs = [json.loads(line)["run"] for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"run"')]
    assert [r["init"] for r in runs] == ["own", "jax"]
    assert all(r["steps"] == 3 * 4 and 0 <= r["knn_purity"] <= 1 for r in runs)
    assert runs[1]["init_gap"] <= 1e-6
    assert [runs[0][k] for k in ("knn_purity", "cross_cos")] == [
        runs[1][k] for k in ("knn_purity", "cross_cos")]
