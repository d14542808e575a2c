"""Both packages' stage-1 SimCSE training in lockstep on the CPU, in one
interpreter, from one state, over one batch order and one set of random draws.

    JAX_PLATFORMS=cpu python scripts/torch_simcse_lockstep.py --root DIR
        [--items 105000] [--encoder pretrained|hash] [--dropout 0.1]
        [--steps N] [--at 1,10,100,546,1638] [--seed 42] [--threads 8]
        [--out FILE.jsonl] [--stats] [--set key=value ...]
        [--save-jax-init DIR [--save-jax-init-seeds 42,1,2,3,4,5]]

The world (``--items`` items, 1,000 users, 365 days, ``data.repeat_prob``
0.10, ``data.name_style_words`` 2: the H&M catalog of
``scripts/text_ab_seeds.py --world hm`` at 105,000) is made in ``DIR`` by the
port's ``gen-data`` and ``pretrain-text`` unless it is there already. Training
reads only the items, and the items do not depend on the users.

The JAX package's ``train_simcse`` is followed step by step: its init from
``PRNGKey(seed)`` with the frozen table loaded, its optimizer and its jitted
step, its ``batch_iterator`` over ``default_rng(seed)``, its key split once a
step. The port starts from the same parameters (``bridge.load_flax_params``)
and runs its own ``make_train_step`` with its own optimizer and schedule, fed
the JAX step's corruption draws (``jax.random`` from the same keys, as
``recsys_tpu/ops/augment.py`` draws them) through
``ops/augment.apply_corrupt_view``. With ``--dropout`` above 0 the JAX step
is the same loss traced with Flax's dropout masks captured, and the port's
``models/layers.dropout_keep`` hands the same masks out in the same order.
The training length is ``simcse.epochs=3``, as in ``text_ab_seeds.py``.

At each step of ``--at`` one JSON line (``"at"``): both losses and, for each
optimizer group (``text``, ``rest``) and each submodule, the parameters'
relative gap ``|P_torch - P_jax| / |P_jax|``, the same gap of Adam's two
moments, both packages' parameter norms and both distances from the start
state. bf16 rounding makes gaps that grow in no direction; a gap that grows
one way (a norm, a moment, a distance from the start) names the fault.
After the last step, both packages' item vectors of the whole catalog, each
from its own final parameters, and their kNN purity and cosines
(``"vectors"``); every step's two losses go into the last line
(``"losses"``).

``--stats`` prints, instead of training, what the lockstep cannot see
because it shares one state and one set of draws: each package's own draws
over the catalog's batches (the rates of the value and field drops, the
name gate, the victim's position, the dropout keep rate and its scale in
bf16), how each sums the bias gradient of a bf16 dense layer over the RE
tokens of a batch (``bias_sum_probe``), and each package's own init (mean,
standard deviation and largest value of every parameter) from the same seed.

``--save-jax-init DIR`` writes the JAX package's init of each seed as the
port's ``state_dict`` (``DIR/seed{S}.npz``, the frozen table left out), for
``scripts/torch_init_spread.py``, which trains the port from it on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from recsys_tpu.data.dataset import batch_iterator  # noqa: E402
from recsys_tpu.data.dataset import tokenize_items as jax_tokenize_items  # noqa: E402
from recsys_tpu.data.vocab import StdVocab  # noqa: E402
from recsys_tpu.ops import select_infonce as jax_select_infonce  # noqa: E402
from recsys_tpu.ops.augment import MAX_VALUES, two_views as jax_two_views  # noqa: E402
from recsys_tpu.train import simcse as JS  # noqa: E402
from recsys_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from recsys_tpu_torch.bridge import flax_to_torch, load_flax_params  # noqa: E402
from recsys_tpu_torch.config import load_config as torch_load_config  # noqa: E402
from recsys_tpu_torch.data.dataset import tokenize_items  # noqa: E402
from recsys_tpu_torch.data.text_pretrain import load_text_pretrain  # noqa: E402
from recsys_tpu_torch.models import layers as TL  # noqa: E402
from recsys_tpu_torch.ops.augment import apply_corrupt_view, corrupt_view_draws  # noqa: E402
from recsys_tpu_torch.pipeline import cli as torch_cli  # noqa: E402
from recsys_tpu_torch.train import simcse as TS  # noqa: E402
from recsys_tpu_torch.train.state import TrainState  # noqa: E402

WORLD = {"num_users": 1000, "days": 365, "repeat_prob": 0.10, "name_style_words": 2}


def world_sets(root: str, items: int, extra: list[str]) -> list[str]:
    """The world's ``--set`` arguments, then ``extra`` (``key=value`` each)."""
    return [a for kv in [f"data.root={root}", f"data.num_items={items}",
                         *[f"data.{k}={v}" for k, v in WORLD.items()], *extra]
            for a in ("--set", kv)]


def configs(args):
    """(the port's config, the JAX package's) from the same overrides, each
    ``--set`` value parsed as both CLIs parse it (JSON, else a string)."""
    from recsys_tpu.config import load_config as jax_load_config

    sets = [*world_sets(args.root, args.items, args.sets),
            "--set", f"data.seed={args.seed}", "--set", f"item_tower.text_encoder={args.encoder}",
            "--set", f"item_tower.dropout={args.dropout}", "--set", "simcse.epochs=3"]
    overrides: dict = {}
    for kv in sets[1::2]:
        key, _, raw = kv.partition("=")
        *path, leaf = key.split(".")
        node = overrides
        for part in path:
            node = node.setdefault(part, {})
        try:
            node[leaf] = json.loads(raw)
        except json.JSONDecodeError:
            node[leaf] = raw
    return torch_load_config(None, overrides), jax_load_config(None, overrides)


def make_world(args) -> None:
    """gen-data and pretrain-text of the port, unless ``--root`` holds them."""
    sets = [*world_sets(args.root, args.items, args.sets), "--device", "cpu"]
    if not os.path.exists(f"{args.root}/items.parquet"):
        torch_cli.main(["gen-data", *sets])
    if not os.path.exists(f"{args.root}/text_pretrain.npz"):
        torch_cli.main(["pretrain-text", *sets, "--set", "item_tower.text_encoder=pretrained"])


def load_tensors(tcfg) -> dict:
    """The tokenized catalog; both packages' tokenizers must agree on it."""
    items, _, _ = torch_cli._load_world(tcfg)
    tensors = tokenize_items(items, StdVocab(), tcfg.vocab)
    jt = jax_tokenize_items(items, StdVocab(), tcfg.vocab)
    for k in TS.ITEM_KEYS:
        np.testing.assert_array_equal(tensors[k], jt[k], err_msg=k)
    return tensors


def schedule_steps(cfg, n: int) -> tuple[int, int]:
    """(passes, total_steps) of ``train_simcse`` in both packages."""
    sc = cfg.simcse
    steps_per_epoch = max(n // sc.batch_size, 1)
    passes = max(1, -(-sc.steps_per_epoch_min // steps_per_epoch))
    return passes, steps_per_epoch * passes * sc.epochs


def view_draws(batch: dict, key, p: float) -> dict:
    """``recsys_tpu/ops/augment.corrupt_view``'s draws from ``key``, in the
    form of the port's ``corrupt_view_draws``."""
    k_val, k_key, k_name_gate, k_name_pos = jax.random.split(key, 4)
    B, F, _ = batch["re_mask"].shape
    txt_mask = batch["txt_mask"]
    gumbel = jax.random.gumbel(k_name_pos, txt_mask.shape)
    return {"value_drop": jax.random.bernoulli(k_val, p, (B, F, MAX_VALUES)),
            "key_drop": jax.random.bernoulli(k_key, max(p - 0.1, 0.0), (B, F)),
            "name_gate": jax.random.bernoulli(k_name_gate, 0.5, (B,)),
            "victim": jnp.argmax(jnp.where(txt_mask > 0, gumbel, -jnp.inf), axis=-1)}


def step_draws(batch: dict, key, p: float) -> tuple[dict, dict]:
    """Both views' draws of one JAX step from its key (``make_train_step``
    splits it into the views' key and the two dropout keys)."""
    kv, _, _ = jax.random.split(key, 3)
    k1, k2 = jax.random.split(kv)
    return view_draws(batch, k1, p), view_draws(batch, k2, p)


class MaskCapture:
    """Flax's dropout draws, recorded in call order while a step is traced;
    ``close()`` gives Flax back its ``jax.random``."""

    def __init__(self):
        import flax.linen.attention as attention
        import flax.linen.stochastic as stochastic

        self.masks: list = []
        self.modules = (attention, stochastic)
        outer = self

        class Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            @staticmethod
            def bernoulli(key, p=0.5, shape=None):
                keep = jax.random.bernoulli(key, p, shape)
                outer.masks.append(keep)
                return keep

        for module in self.modules:
            module.random = Random()

    def take(self) -> list:
        masks, self.masks = self.masks, []
        return masks

    def close(self) -> None:
        for module in self.modules:
            module.random = jax.random


def jax_capturing_step(model, cfg, capture: MaskCapture):
    """``recsys_tpu.train.simcse.make_train_step``'s step, returning the
    dropout keep masks of both forwards beside its outputs."""
    sc = cfg.simcse
    infonce = jax_select_infonce(sc.kernel)

    def loss_fn(params, batch, key):
        capture.take()
        kv, kd1, kd2 = jax.random.split(key, 3)
        v1, v2 = jax_two_views(batch, kv, sc.feature_dropout)
        emb1 = model.apply({"params": params}, v1["std"], v1["re_ids"], v1["re_mask"],
                           v1["txt_ids"], v1["txt_mask"], deterministic=False,
                           rngs={"dropout": kd1})
        emb2 = model.apply({"params": params}, v2["std"], v2["re_ids"], v2["re_mask"],
                           v2["txt_ids"], v2["txt_mask"], deterministic=False,
                           rngs={"dropout": kd2})
        return infonce(emb1, emb2, sc.temperature), capture.take()

    @jax.jit
    def step(state, batch, key):
        (loss, masks), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, key)
        return state.apply_gradients(grads), loss, masks

    return step


def adam_moments(opt_state) -> dict[str, dict[str, np.ndarray]]:
    """{"mu": state_dict, "nu": state_dict} of every optax Adam state in a
    ``multi_transform`` (each group's moments hold its own parameters)."""
    out = {"mu": {}, "nu": {}}
    states = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    for st in states:
        if not isinstance(st, optax.ScaleByAdamState):
            continue
        for which in ("mu", "nu"):
            tree: dict = {}
            for path, leaf in jax.tree_util.tree_leaves_with_path(getattr(st, which)):
                node = tree
                keys = [p.key for p in path]
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = np.asarray(leaf)
            out[which].update({k: v.numpy() for k, v in flax_to_torch(tree).items()})
    return out


def torch_moments(opt) -> dict[str, dict[str, np.ndarray]]:
    names = {id(p): n for n, p in opt.named_params.items()}
    out = {"mu": {}, "nu": {}}
    for g in opt.param_groups:
        for p in g["params"]:
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out["mu"][names[id(p)]] = st["exp_avg"].detach().numpy().copy()
                out["nu"][names[id(p)]] = st["exp_avg_sq"].detach().numpy().copy()
    return out


def submodule(name: str) -> str:
    parts = name.split(".")
    if "pretrained_proj" in parts:
        return name
    return ".".join(parts[:3] if parts[1:2] == ["text_encoder"] else parts[:2])


def group_of(name: str) -> str:
    if "pretrained_embedding" in name:
        return "frozen"
    return "text" if "text_encoder" in name else "rest"


def gaps(tp: dict, jp: dict, t0: dict, tm: dict, jm: dict) -> dict:
    """Relative gaps and norms over each group and each submodule."""
    buckets: dict[str, list[str]] = {}
    for name in jp:
        if group_of(name) == "frozen":
            continue
        buckets.setdefault(group_of(name), []).append(name)
        buckets.setdefault(submodule(name), []).append(name)

    def norm(arrs):
        return float(np.sqrt(sum(float(np.sum(np.square(a, dtype=np.float64))) for a in arrs)))

    out = {}
    for key, names in buckets.items():
        row = {"n": len(names),
               "param_gap": (norm([tp[n] - jp[n] for n in names])
                             / max(norm([jp[n] for n in names]), 1e-30)),
               "norm_torch": norm([tp[n] for n in names]),
               "norm_jax": norm([jp[n] for n in names]),
               "moved_torch": norm([tp[n] - t0[n] for n in names]),
               "moved_jax": norm([jp[n] - t0[n] for n in names])}
        for which in ("mu", "nu"):
            have = [n for n in names if n in tm[which] and n in jm[which]]
            if have:
                row[f"{which}_gap"] = (norm([tm[which][n] - jm[which][n] for n in have])
                                       / max(norm([jm[which][n] for n in have]), 1e-30))
                row[f"{which}_norm_torch"] = norm([tm[which][n] for n in have])
                row[f"{which}_norm_jax"] = norm([jm[which][n] for n in have])
        out[key] = row
    return out


def to_torch_draws(d: dict) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def run_lockstep(args, tcfg, jcfg, tensors, emit) -> None:
    n = tensors["std"].shape[0]
    passes, total_steps = schedule_steps(jcfg, n)
    last = min(args.steps or total_steps, total_steps)
    at = sorted({s for s in map(int, args.at.split(",")) if s <= last} | {last})
    emit({"world": {"items": n, "encoder": args.encoder, "dropout": args.dropout,
                    "seed": args.seed, "total_steps": total_steps, "steps": last,
                    "threads": args.threads}})

    jtensors = {k: v for k, v in tensors.items() if k != "item_ids"}
    model = JS.build_model(jcfg, StdVocab().size, tensors["std"].shape[1])
    key = jax.random.PRNGKey(args.seed)
    params = JS.init_params(model, jtensors, key)
    if args.encoder == "pretrained":
        te = dict(params["encoder"]["text_encoder"])
        te["pretrained_embedding"] = jnp.asarray(
            load_text_pretrain(f"{args.root}/text_pretrain.npz"), jnp.float32)
        params = {**params, "encoder": {**params["encoder"], "text_encoder": te}}
    state = JaxTrainState.create(params, JS.make_optimizer(jcfg, params, total_steps))
    capture = MaskCapture() if args.dropout > 0 else None
    jstep = (jax_capturing_step(model, jcfg, capture) if capture
             else JS.make_train_step(model, jcfg))
    draws_fn = jax.jit(step_draws, static_argnums=2)

    tmodel = TS.build_model(tcfg, StdVocab().size, tensors["std"].shape[1], "cpu")
    load_flax_params(tmodel, jax.device_get(params))
    opt, sched = TS.make_optimizer(tcfg, tmodel, total_steps)
    opt.named_params = dict(tmodel.named_parameters())
    tstate = TrainState(tmodel, opt, sched)
    given: dict = {}
    tstep = TS.make_train_step(tstate, tcfg, views=lambda batch, gen, p: (
        apply_corrupt_view(batch, given["d1"]), apply_corrupt_view(batch, given["d2"])))
    masks: list = []
    default_keep = TL.dropout_keep
    TL.dropout_keep = lambda shape, p, generator, device: masks.pop(0)
    start = {k: v.numpy().copy() for k, v in tmodel.state_dict().items()}

    rng = np.random.default_rng(args.seed)
    p = jcfg.simcse.feature_dropout
    losses, gstep, t0 = [], 0, time.perf_counter()
    try:
        for _epoch in range(jcfg.simcse.epochs):
            for _pass in range(passes):
                for idx in batch_iterator(n, jcfg.simcse.batch_size, rng):
                    if gstep >= last:
                        raise StopIteration
                    jb = {k: v[idx] for k, v in jtensors.items()}
                    key, sub = jax.random.split(key)
                    d1, d2 = draws_fn(jb, sub, p)
                    given["d1"], given["d2"] = to_torch_draws(d1), to_torch_draws(d2)
                    if capture:
                        state, jloss, jmasks = jstep(state, jb, sub)
                        masks[:] = [torch.as_tensor(np.array(m)) for m in jmasks]
                    else:
                        state, aux = jstep(state, jb, sub)
                        jloss = aux["loss"]
                    tloss, _, _ = tstep({k: torch.as_tensor(v[idx]) for k, v in tensors.items()
                                         if k in TS.ITEM_KEYS}, None)
                    if masks:
                        raise RuntimeError(f"{len(masks)} dropout masks left unused")
                    gstep += 1
                    losses.append((float(jloss), float(tloss)))
                    if gstep in at:
                        jp = {k: v.numpy() for k, v in
                              flax_to_torch(jax.device_get(state.params)).items()}
                        tp = {k: v.numpy() for k, v in tmodel.state_dict().items()}
                        emit({"at": gstep, "loss_jax": losses[-1][0],
                              "loss_torch": losses[-1][1],
                              "seconds": time.perf_counter() - t0,
                              "gaps": gaps(tp, jp, start, torch_moments(opt),
                                           adam_moments(state.opt_state))})
    except StopIteration:
        pass
    finally:
        TL.dropout_keep = default_keep
        if capture:
            capture.close()
    emit({"vectors": item_vector_stats(model, state.params, tmodel, tensors, args.root)})
    emit({"losses": losses})


def item_vector_stats(model, params, tmodel, tensors: dict, root: str,
                      batch_size: int = 2048) -> dict:
    """Both packages' item vectors of the whole catalog from their final
    parameters (each package's deterministic encode), and the kNN purity and
    cosines of ``scripts/torch_quality_hm.purity_stage`` (8,192 queries)."""
    import importlib.util

    import pandas as pd

    spec = importlib.util.spec_from_file_location(
        "torch_quality_hm", os.path.join(REPO, "scripts", "torch_quality_hm.py"))
    quality = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quality)
    n = tensors["std"].shape[0]
    inputs = ("std", "re_ids", "re_mask", "txt_ids", "txt_mask")
    encode = jax.jit(lambda p, *a: model.apply({"params": p}, *a,
                                               method=JS.SimCSEModel.encode))
    jvecs = np.concatenate([np.asarray(encode(params, *(tensors[k][s:s + batch_size]
                                                        for k in inputs)))
                            for s in range(0, n, batch_size)])
    tvecs = TS.encode_items(tmodel, TS.item_tensors_to(tensors, "cpu"), batch_size).numpy()
    items = pd.read_parquet(f"{root}/items.parquet")
    lab = items.set_index(items["item_id"].astype(str))["latent_cluster"]
    labels = lab.reindex([str(i) for i in tensors["item_ids"]]).to_numpy()
    cos = (jvecs * tvecs).sum(1) / (np.linalg.norm(jvecs, axis=1) * np.linalg.norm(tvecs, axis=1))
    return {"jax": quality.knn_purity(jvecs, labels, 10, sample=8192),
            "torch": quality.knn_purity(tvecs, labels, 10, sample=8192),
            "row_cos_min": float(cos.min()), "row_cos_mean": float(cos.mean())}


# -- the JAX package's inits, for scripts/torch_init_spread.py on the card ---------------

def save_jax_inits(args, tcfg, jcfg, tensors, emit) -> None:
    """The JAX package's init (``init_params`` from ``PRNGKey(seed)``) of each
    seed of ``--save-jax-init-seeds`` as a ``state_dict`` of the port, without
    the frozen table: ``DIR/seed{S}.npz``."""
    os.makedirs(args.save_jax_init, exist_ok=True)
    model = JS.build_model(jcfg, StdVocab().size, tensors["std"].shape[1])
    sample = {k: v[:2] for k, v in tensors.items() if k != "item_ids"}
    for seed in map(int, args.save_jax_init_seeds.split(",")):
        sd = flax_to_torch(jax.device_get(JS.init_params(model, sample, jax.random.PRNGKey(seed))))
        path = f"{args.save_jax_init}/seed{seed}.npz"
        np.savez(path, **{k: v.numpy() for k, v in sd.items() if "pretrained_embedding" not in k})
        emit({"jax_init": path, "seed": seed, "tensors": len(sd) - 1})


# -- each package's own draws and init ------------------------------------------------

def describe(arr: np.ndarray) -> dict:
    a = np.asarray(arr, np.float64)
    return {"mean": float(a.mean()), "std": float(a.std()), "max_abs": float(np.abs(a).max())}


def bias_sum_probe(jcfg, mean: float = 2e-3, sd: float = 1e-2) -> dict:
    """The bias gradient of a bf16 Dense over the RE tokens of a batch (B x
    9 x max_field_tokens rows), as each package sums one given bf16 output
    gradient (rows of ``mean`` and ``sd``): the JAX package's (XLA's
    ``reduce_sum`` of the bias's broadcast-add, in bf16) and PyTorch's
    (fp32, rounded once), each as a share short of the fp64 sum."""
    shape = (jcfg.simcse.batch_size, 9, jcfg.vocab.max_field_tokens, jcfg.item_tower.text_dim)
    g = np.random.default_rng(0).normal(mean, sd, shape).astype(np.float32)
    g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    grad = jax.jit(jax.grad(lambda b, dy: jnp.sum(
        (jnp.zeros(shape, jnp.bfloat16) + b.astype(jnp.bfloat16)).astype(jnp.float32) * dy)))
    sums = {"jax": np.asarray(grad(jnp.zeros(shape[-1], jnp.float32), g), np.float64),
            "torch": torch.as_tensor(g).to(torch.bfloat16).reshape(-1, shape[-1])
            .sum(0).double().numpy()}
    exact = g.reshape(-1, shape[-1]).sum(0, dtype=np.float64)
    norm = float(np.linalg.norm(exact))
    return {"shape": list(shape), "mean": mean, "sd": sd,
            **{f"{k}_short": 1 - float(np.linalg.norm(v)) / norm for k, v in sums.items()},
            **{f"{k}_rel_err": float(np.linalg.norm(v - exact)) / norm for k, v in sums.items()}}


def run_stats(args, tcfg, jcfg, tensors, emit, batches: int = 200) -> None:
    """Own draws over ``batches`` of the catalog's batches, and own inits."""
    n = tensors["std"].shape[0]
    p = jcfg.simcse.feature_dropout
    rng = np.random.default_rng(args.seed)
    key = jax.random.PRNGKey(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    Tn = tensors["txt_mask"].shape[1]
    sums = {pkg: {"value_drop": 0.0, "key_drop": 0.0, "name_gate": 0.0,
                  "token_kept": 0.0, "victim_hist": np.zeros(Tn)} for pkg in ("jax", "torch")}
    tokens = 0.0
    draws_fn = jax.jit(view_draws, static_argnums=2)
    seen = 0
    for idx in batch_iterator(n, jcfg.simcse.batch_size, rng):
        if seen >= batches:
            break
        seen += 1
        batch = {k: torch.as_tensor(tensors[k][idx]) for k in TS.ITEM_KEYS}
        key, sub = jax.random.split(key)
        own = {"jax": to_torch_draws(draws_fn({k: tensors[k][idx] for k in TS.ITEM_KEYS},
                                              sub, p)),
               "torch": corrupt_view_draws(batch, gen, p)}
        tokens += float(batch["re_mask"].sum())
        for pkg, d in own.items():
            view = apply_corrupt_view(batch, d)
            s = sums[pkg]
            s["value_drop"] += float(d["value_drop"].float().mean())
            s["key_drop"] += float(d["key_drop"].float().mean())
            s["name_gate"] += float(d["name_gate"].float().mean())
            s["token_kept"] += float(view["re_mask"].sum())
            s["victim_hist"] += np.bincount(d["victim"].numpy(), minlength=Tn)
    for pkg, s in sums.items():
        emit({"draws": pkg, "batches": seen, "value_drop_rate": s["value_drop"] / seen,
              "key_drop_rate": s["key_drop"] / seen,
              "name_gate_rate": s["name_gate"] / seen,
              "re_token_keep_rate": s["token_kept"] / tokens,
              "victim_position_share": (s["victim_hist"] / s["victim_hist"].sum()).tolist()})

    # dropout: the keep rate and the scale each package applies, in bf16
    rate = 0.1
    x = jnp.ones((4096, 512), jnp.bfloat16)
    from flax import linen as nn
    jd = np.asarray(nn.Dropout(rate).apply({}, x, deterministic=False,
                                           rngs={"dropout": jax.random.PRNGKey(0)}), np.float32)
    td = TL.dropout(torch.ones(4096, 512, dtype=torch.bfloat16), rate, True,
                    torch.Generator().manual_seed(0)).float().numpy()
    keep = jnp.asarray(1.0 - rate, jnp.bfloat16)
    emit({"dropout": {"rate": rate,
                      "keep_rate_jax": float((jd > 0).mean()),
                      "keep_rate_torch": float((td > 0).mean()),
                      "scale_jax": float(jd.max()), "scale_torch": float(td.max()),
                      "attention_scale_jax": float(jnp.ones((), jnp.bfloat16) / keep),
                      "attention_scale_torch": float((torch.ones((), dtype=torch.bfloat16)
                                                      / (1.0 - rate)).float())}})

    emit({"bias_sum": bias_sum_probe(jcfg)})

    jtensors = {k: v for k, v in tensors.items() if k != "item_ids"}
    model = JS.build_model(jcfg, StdVocab().size, tensors["std"].shape[1])
    jp = {k: v.numpy() for k, v in flax_to_torch(jax.device_get(
        JS.init_params(model, jtensors, jax.random.PRNGKey(args.seed)))).items()}
    tp = {k: v.numpy() for k, v in TS.build_model(
        tcfg, StdVocab().size, tensors["std"].shape[1], "cpu",
        seed=args.seed).state_dict().items()}
    for name in jp:
        emit({"init": name, "shape": list(jp[name].shape), "jax": describe(jp[name]),
              "torch": describe(tp[name])})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--items", type=int, default=105000)
    parser.add_argument("--encoder", choices=("pretrained", "hash"), default="pretrained")
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after this many steps (default: the whole run)")
    parser.add_argument("--at", default="1,10,100,546,1638")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--out", default=None)
    parser.add_argument("--stats", action="store_true")
    parser.add_argument("--save-jax-init", default=None, metavar="DIR",
                        help="write the JAX package's init of each seed and stop")
    parser.add_argument("--save-jax-init-seeds", default="42,1,2,3,4,5")
    parser.add_argument("--set", action="append", default=[], dest="sets",
                        help="more overrides after the world's (a smaller model for a test)")
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    make_world(args)
    tcfg, jcfg = configs(args)
    tensors = load_tensors(tcfg)
    sink = open(args.out, "w") if args.out else None

    def emit(row: dict) -> None:
        line = json.dumps(row)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        print(line if "losses" not in row else json.dumps({"losses": len(row["losses"])}),
              flush=True)

    try:
        run = (save_jax_inits if args.save_jax_init else
               run_stats if args.stats else run_lockstep)
        run(args, tcfg, jcfg, tensors, emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
