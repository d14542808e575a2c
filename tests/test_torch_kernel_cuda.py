"""Kernels K1 (csrc/diag_ce.cu), K2 (csrc/spmm.cu), K3 (csrc/fm.cu) and K4
(csrc/ring.cu) against their plain PyTorch forms, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. This file imports no JAX, so
on the GPU machine it runs without the JAX test harness:

    python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerances are the JAX suite's for the Pallas kernel
(tests/test_pallas.py): loss 1e-4 abs, grads 1e-5 abs. Both sides are fp32
with TF32 off in PyTorch; the kernel's products are three TF32 terms per
product on the tensor cores (tests/test_torch_tf32_split.py holds that
arithmetic to fp64 in numpy) and it sums in another order than cuBLAS. K2 is
held to 1e-5 abs (tests/test_spmm.py) in both of its modes, each against the
plain form of the same mode (in "bf16" both sides round x to bf16 and sum the
same values in fp32), on graphs whose rows sum up to a few thousand terms of
size ~1e-2; it sums a row in a fixed order, ``index_add_`` in the order its
atomics land. K3 is held to rtol 1e-4 / atol 1e-3, the JAX suite's
bound for the Pallas FM kernel (tests/test_pallas.py), forward and gradient.
K4 moves bytes between virtual ranks laid over the one card: it is held bit
for bit against its plain hop loop and against ``torch.cat``. Last, the
stage-2 and hybrid towers' time-bucket table (``models/layers.BucketEmbed``)
gives the same gradient bits in every run on the card.
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.ops import contrastive_kernel as K
from recsys_tpu_torch.ops import fm_kernel as FK
from recsys_tpu_torch.ops import select_fm
from recsys_tpu_torch.ops import spmm as S
from recsys_tpu_torch.ops.contrastive import bidirectional_infonce, inbatch_logq_loss
from recsys_tpu_torch.ops.fm import fm_interaction
from recsys_tpu_torch.parallel import ring as R

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _unit(rng, B, D):
    x = rng.normal(size=(B, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _logq_problem(B, D, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)
    return {"u": t(_unit(rng, B, D)), "i": t(_unit(rng, B, D)),
            "pos": t(rng.integers(1, max(B // 4, 2), B)),
            "uid": t(rng.integers(0, max(B // 3, 2), B)),
            "logq": t(rng.uniform(-8, -1, B).astype(np.float32)),
            "valid": t((rng.random(B) > 0.1).astype(np.int32))}


def _grads(fn, a, b):
    a = a.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    loss = fn(a, b)
    ga, gb = torch.autograd.grad(loss, (a, b))
    return loss.detach(), ga, gb


@pytest.mark.parametrize("B", [200, 768, 8192])
def test_kernel_logq_matches_plain(device, B):
    p = _logq_problem(B, 128, B, device)
    kw = dict(temperature=0.1, user_ids=p["uid"], valid=p["valid"])
    ref = _grads(lambda a, b: inbatch_logq_loss(a, b, p["pos"], p["logq"], **kw),
                 p["u"], p["i"])
    K.reset_launch_counts()
    got = _grads(lambda a, b: K.fused_inbatch_logq_loss(a, b, p["pos"], p["logq"], **kw),
                 p["u"], p["i"])
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"diag_ce_fwd": 1, "diag_ce_bwd_dq": 1, "diag_ce_bwd_dk": 1}
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= 1e-5


def _stage2_problem(users, positions, seed, device, catalog=47_000):
    """Rows as stage 2 makes them: ``positions`` per user in user order, user
    ids repeated, positive ids drawn with popularity skew from ``catalog``
    items (same-item collisions), and user 0 with one real position (its rows
    are that position's, repeated)."""
    rng = np.random.default_rng(seed)
    B = users * positions
    u, i = _unit(rng, B, 128), _unit(rng, B, 128)
    pos = 1 + (catalog * rng.random(B) ** 3).astype(np.int64)
    u[1:positions], i[1:positions], pos[1:positions] = u[0], i[0], pos[0]
    t = lambda a: torch.as_tensor(a, device=device)
    return {"u": t(u), "i": t(i), "pos": t(pos),
            "uid": t(np.repeat(np.arange(users), positions)),
            "logq": t(rng.normal(-8.0, 1.0, catalog + 1).astype(np.float32))}


@pytest.mark.parametrize("users,positions", [(768, 4), (16, 2), (1024, 4)],
                         ids=["B3072", "B32", "B4096"])
def test_kernel_at_the_stage2_shape(device, users, positions):
    """The default stage-2 step's loss (768 users x 4 positions = 3072 rows),
    the CPU test world's (16 x 2) and B = 4096, where an earlier design
    switched to larger blocks: the wrapper the step calls, no valid mask,
    against the plain loss; each kernel against its plain form; two dq and
    two dk calls give the same bits (both sum partial results of several
    blocks, in a fixed order)."""
    p = _stage2_problem(users, positions, users, device)
    kw = dict(temperature=0.1, user_ids=p["uid"])
    ref = _grads(lambda a, b: inbatch_logq_loss(a, b, p["pos"], p["logq"], **kw),
                 p["u"], p["i"])
    K.reset_launch_counts()
    got = _grads(lambda a, b: K.fused_inbatch_logq_loss(a, b, p["pos"], p["logq"], **kw),
                 p["u"], p["i"])
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"diag_ce_fwd": 1, "diag_ce_bwd_dq": 1, "diag_ce_bwd_dk": 1}
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= 1e-5
    B = users * positions
    valid = torch.ones(B, dtype=torch.int32, device=device)
    meta = (p["logq"][p["pos"]], p["pos"].int(), p["uid"].int(), valid)
    loss, lse = K.diag_ce_fwd_cuda(p["u"], p["i"], *meta, 0.1)
    loss_p, lse_p = K.diag_ce_fwd_plain(p["u"], p["i"], *meta, 0.1)
    assert float(torch.maximum((loss - loss_p).abs(), (lse - lse_p).abs()).max()) <= 1e-4
    args = (p["u"], p["i"], *meta, lse_p, torch.full((B,), 1.0 / B, device=device), 0.1)
    dk = K.diag_ce_bwd_dk_cuda(*args)
    dq = K.diag_ce_bwd_dq_cuda(*args)
    assert float((dq - K.diag_ce_bwd_dq_plain(*args)).abs().max()) <= 1e-5
    assert float((dk - K.diag_ce_bwd_dk_plain(*args)).abs().max()) <= 1e-5
    assert torch.equal(K.diag_ce_bwd_dk_cuda(*args), dk)
    assert torch.equal(K.diag_ce_bwd_dq_cuda(*args), dq)


@pytest.mark.parametrize("users,positions", [(96, 2), (768, 4)], ids=["B192", "B3072"])
def test_kernel_replays_from_a_cuda_graph_bit_for_bit_and_counted(device, users, positions):
    """K1's forward, dq and dk captured into one CUDA graph (on its capture
    stream, whose workspace the warm-up made) and replayed: every replay
    gives the eager calls' bits, and ``LAUNCHES`` counts each kernel once a
    replay (none at the capture)."""
    from recsys_tpu_torch.ops._build import captured_launches, count_replay

    p = _stage2_problem(users, positions, users, device)
    B = users * positions
    meta = (p["logq"][p["pos"]], p["pos"].int(), p["uid"].int(),
            torch.ones(B, dtype=torch.int32, device=device))
    g = torch.full((B,), 1.0 / B, device=device)

    def calls():
        loss, lse = K.diag_ce_fwd_cuda(p["u"], p["i"], *meta, 0.1)
        args = (p["u"], p["i"], *meta, lse, g, 0.1)
        return loss, lse, K.diag_ce_bwd_dq_cuda(*args), K.diag_ce_bwd_dk_cuda(*args)

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the capture stream's workspace is made before capture
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    K.reset_launch_counts()
    with captured_launches() as log, torch.cuda.graph(graph, stream=side):
        captured = calls()
    assert all(n == 0 for n in K.LAUNCHES.values()) and len(log) == 3
    for replay in range(1, 4):
        for out in captured:
            out.zero_()
        graph.replay()
        count_replay(log)
        torch.cuda.synchronize()
        assert all(torch.equal(c, e) for c, e in zip(captured, eager))
        assert all(n == replay for n in K.LAUNCHES.values())


class _TwoMaps(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        w = lambda: torch.nn.Parameter(torch.as_tensor(
            rng.normal(0, 0.1, (64, 128)).astype(np.float32)))
        self.a, self.b = w(), w()


def _k1_trainer(device, seed: int, pause_in_capture=None):
    """(model, state, step, data): two linear maps of a row's features, the
    bidirectional InfoNCE through K1 (each kernel twice a step) and the
    port's optimizer. ``pause_in_capture()`` runs in the step while its
    stream is being captured."""
    from recsys_tpu_torch.train.state import TrainState, grouped_adamw

    rng = np.random.default_rng(seed)
    model = _TwoMaps(rng).to(device)
    state = TrainState(model, grouped_adamw(model, lambda n: "all", {"all": 1e-2}, 0.01,
                                            grad_clip=1.0))
    data = {"x": torch.as_tensor(rng.normal(size=(1024, 64)).astype(np.float32),
                                 device=device)}

    def step(batch, generator):
        x = batch["x"]
        e1 = torch.nn.functional.normalize(x @ model.a, dim=1)
        e2 = torch.nn.functional.normalize(x @ model.b, dim=1)
        loss = K.fused_bidirectional_infonce(e1, e2, 0.08)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        if pause_in_capture is not None and torch.cuda.is_current_stream_capturing():
            pause_in_capture()
        return {"loss": loss.detach()}

    return model, state, step, data


def test_optimizer_resumes_a_cpu_checkpoint_fused_on_the_card(device):
    """A checkpoint of the optimizer written on the CPU (neither fused nor
    capturable) loads into the card's: the card's device choices stay, Adam's
    counts move to the card, and four more steps there give the CPU's
    weights within 1e-6 (fused AdamW sums in another order)."""
    from recsys_tpu_torch.train.state import TrainState, grouped_adamw, set_lr_factor

    rng = np.random.default_rng(0)
    grads = [[torch.as_tensor(rng.normal(size=(64, 128)).astype(np.float32)) for _ in range(2)]
             for _ in range(8)]
    runs = {}
    for where in ("cpu", "cuda"):
        model = _TwoMaps(np.random.default_rng(1)).to(where)
        state = TrainState(model, grouped_adamw(
            model, lambda n: "a" if n == "a" else "b", {"a": 1e-2, "b": 1e-3}, 0.01,
            grad_clip=1.0, freeze_steps={"b": 3}))
        runs[where] = (model, state.optimizer)
    cpu_model, cpu_opt = runs["cpu"]
    for g in grads[:4]:
        cpu_model.a.grad, cpu_model.b.grad = g
        cpu_opt.step()
    set_lr_factor(cpu_opt, 0.5)
    card_model, card_opt = runs["cuda"]
    card_model.load_state_dict(cpu_model.state_dict())
    card_opt.load_state_dict(cpu_opt.state_dict())
    for g in card_opt.param_groups:
        assert g["fused"] and g["capturable"] and g["updates"].device.type == "cuda"
        assert int(g["updates"]) == 4 and float(g["lr_factor"]) == 0.5
        assert all(card_opt.state[p]["step"].device.type == "cuda" for p in g["params"])
    for g in grads[4:]:
        cpu_model.a.grad, cpu_model.b.grad = g
        cpu_opt.step()
        card_model.a.grad, card_model.b.grad = (x.to(device) for x in g)
        card_opt.step()
    for c, d in zip(cpu_model.parameters(), card_model.parameters()):
        assert float((c.detach() - d.detach().cpu()).abs().max()) <= 1e-6


def test_two_runners_in_two_threads_one_capturing_while_the_other_replays(device):
    """Two trainers in two threads, as a server's /train/* routes run them:
    A replays while B is inside its capture (B's step waits there until A
    has replayed three times). B starts once A replays: one capture runs at
    a time, so A's would wait for B's paused one. Each gives the losses and
    weights of its eager run alone, and every launch is counted once: A's
    replays, B's warm-up steps and replays, none of B's capture. Tolerance
    1e-5: the captured matmuls may take other cuBLAS kernels than eager."""
    import threading

    from recsys_tpu_torch.train.step_graph import WARMUP_STEPS, StepGraph

    B, steps = 192, 10
    idx = [np.random.default_rng(s).choice(1024, B, replace=False) for s in range(steps)]
    ref = {}
    for seed in (0, 1):
        model, state, step, data = _k1_trainer(device, seed)
        run = StepGraph(step, state, data, B, None, capture=False)
        ref[seed] = ([float(run(i)["loss"]) for i in idx],
                     [p.detach().clone() for p in model.parameters()])

    a_replaying, b_capturing, a_replayed = threading.Event(), threading.Event(), threading.Event()

    def pause():
        b_capturing.set()
        assert a_replayed.wait(120), "A did not replay while B captured"

    trainers = [_k1_trainer(device, 0), _k1_trainer(device, 1, pause)]
    runs = [StepGraph(step, state, data, B, None) for _, state, step, data in trainers]
    losses, errors = {0: [], 1: []}, []

    def run_a():
        try:
            for n, i in enumerate(idx):
                if n == steps - 3:          # the last three replays run inside B's capture
                    assert b_capturing.wait(120), "B did not reach its capture"
                losses[0].append(float(runs[0](i)["loss"]))
                if runs[0].replays == 1:    # A's capture is done: B may capture
                    a_replaying.set()
            a_replayed.set()
        except BaseException as e:          # noqa: BLE001 - handed to the test's thread
            errors.append(e)
            a_replaying.set()
            a_replayed.set()

    def run_b():
        try:
            assert a_replaying.wait(120), "A did not reach its replays"
            losses[1].extend(float(runs[1](i)["loss"]) for i in idx)
        except BaseException as e:          # noqa: BLE001
            errors.append(e)
            b_capturing.set()

    K.reset_launch_counts()
    threads = [threading.Thread(target=run_a), threading.Thread(target=run_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    assert not errors, errors
    assert [r.replays for r in runs] == [steps - WARMUP_STEPS] * 2
    assert all(n == 2 * 2 * steps for n in K.LAUNCHES.values()), K.LAUNCHES
    for seed, (model, *_rest) in enumerate(trainers):
        np.testing.assert_allclose(losses[seed], ref[seed][0], atol=1e-5, rtol=0)
        for p, r in zip(model.parameters(), ref[seed][1]):
            assert float((p.detach() - r).abs().max()) <= 1e-5


@pytest.mark.parametrize("B", [192, 8192])
def test_kernel_infonce_matches_plain(device, B):
    rng = np.random.default_rng(B)
    a = torch.as_tensor(_unit(rng, B, 128), device=device)
    b = torch.as_tensor(_unit(rng, B, 128), device=device)
    ref = _grads(lambda x, y: bidirectional_infonce(x, y, 0.08), a, b)
    got = _grads(lambda x, y: K.fused_bidirectional_infonce(x, y, 0.08), a, b)
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= 1e-5


def test_kernel_per_row_outputs(device):
    """Per-row loss and both gradients under a random upstream gradient."""
    B, D = 333, 64
    p = _logq_problem(B, D, 7, device)
    corr = p["logq"][p["pos"]]
    args = (corr, p["pos"].int(), p["uid"].int(), p["valid"])
    g = torch.randn(B, device=device, generator=torch.Generator(device).manual_seed(0))
    ref = _grads(lambda a, b: (K.fused_diag_ce_reference(a, b, *args, 0.1) * g).sum(),
                 p["u"], p["i"])
    got = _grads(lambda a, b: (K.fused_diag_ce(a, b, *args, 0.1) * g).sum(),
                 p["u"], p["i"])
    assert abs(float(got[0]) - float(ref[0])) <= 1e-3  # a sum of 333 rows
    for x, r in zip(got[1:], ref[1:]):
        assert float((x - r).abs().max()) <= 1e-4  # per-row g ~ N(0, 1), not 1/B


@pytest.mark.parametrize("B,D", [(200, 64), (200, 256), (333, 100), (50, 6), (4100, 64),
                                 (4100, 160), (1, 8), (17, 3), (65, 129)])
def test_kernel_widths_and_ragged_batches(device, B, D):
    """Widths below, at and between the kernel's two padded widths (128, 256),
    a width that is no multiple of 4 (scalar loads), and ragged batches: fewer
    owner blocks than SMs (one tile a range), more pairs than SMs (ranges
    across two owner blocks), B = 1: each kernel against its plain form,
    per-row outputs."""
    p = _logq_problem(B, D, B + D, device)
    meta = (p["logq"][p["pos"] % B], p["pos"].int(), p["uid"].int(), p["valid"])
    loss, lse = K.diag_ce_fwd_cuda(p["u"], p["i"], *meta, 0.1)
    loss_p, lse_p = K.diag_ce_fwd_plain(p["u"], p["i"], *meta, 0.1)
    assert float((loss - loss_p).abs().max()) <= 1e-4
    assert float((lse - lse_p).abs().max()) <= 1e-4
    g = p["valid"].float() / p["valid"].float().sum().clamp(min=1.0)
    args = (p["u"], p["i"], *meta, lse_p, g, 0.1)
    dq, dk = K.diag_ce_bwd_dq_cuda(*args), K.diag_ce_bwd_dk_cuda(*args)
    assert float((dq - K.diag_ce_bwd_dq_plain(*args)).abs().max()) <= 1e-5
    assert float((dk - K.diag_ce_bwd_dk_plain(*args)).abs().max()) <= 1e-5
    # deterministic: partial results are merged in a fixed order
    assert torch.equal(K.diag_ce_bwd_dk_cuda(*args), dk)
    assert torch.equal(K.diag_ce_bwd_dq_cuda(*args), dq)
    assert torch.equal(K.diag_ce_fwd_cuda(p["u"], p["i"], *meta, 0.1)[0], loss)


def test_kernel_rejects_bad_inputs(device):
    q = torch.randn(8, 4, device=device)
    ids = torch.arange(8, device=device, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.diag_ce_fwd_cuda(q.double(), q, torch.zeros(8, device=device), ids, ids, ids, 0.1)
    with pytest.raises(ValueError):
        K.diag_ce_fwd_cuda(q, q.t().contiguous().t(), torch.zeros(8, device=device),
                           ids, ids, ids, 0.1)


# -- K2: the CSR sparse product ---------------------------------------------

def _normalized_edges(u, i, nu, ni):
    """Deduped (user, item) pairs -> both edge directions with D^-1/2 A D^-1/2
    weights, plus a tail of weight-0 padding edges on node 0."""
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1] + nu
    deg = np.bincount(np.concatenate([u, i]), minlength=nu + ni).clip(1)
    w = (1.0 / np.sqrt(deg[u] * deg[i])).astype(np.float32)
    pad = np.zeros(100, np.int64)
    return (np.concatenate([u, i, pad]), np.concatenate([i, u, pad]),
            np.concatenate([w, w, pad.astype(np.float32)]), nu + ni)


def _small_graph():
    rng = np.random.default_rng(0)
    return _normalized_edges(rng.integers(0, 700, 8000), rng.integers(0, 500, 8000),
                             700, 500)


def _skewed_graph():
    """~1M directed edges; item popularity ~ U^2.5, so the top items are hub
    rows of thousands of edges while a user has ~25."""
    rng = np.random.default_rng(1)
    nu, ni, e = 20_000, 5_000, 520_000
    return _normalized_edges(rng.integers(0, nu, e),
                             (ni * rng.random(e) ** 2.5).astype(np.int64), nu, ni)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 32, 128])
@pytest.mark.parametrize("graph,max_segment", [("small", 256), ("small", 8),
                                               ("skewed", 256)])
def test_spmm_kernel_matches_plain(device, graph, max_segment, D, precision):
    src, dst, w, n = _small_graph() if graph == "small" else _skewed_graph()
    layout = S.csr_graph(src, dst, w, n, max_segment=max_segment, device=device)
    assert layout.num_hubs > 0 or max_segment == 256 and graph == "small"
    rng = np.random.default_rng(D)
    x = torch.as_tensor(rng.normal(size=(n, D)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.normal(size=(n, D)).astype(np.float32), device=device)
    S.reset_launch_counts()
    xk = x.clone().requires_grad_(True)
    out = S.spmm(layout, xk, precision)
    (dx,) = torch.autograd.grad((out * g).sum(), xk)
    torch.cuda.synchronize()
    assert S.LAUNCHES == {"spmm_csr": 2}  # forward and backward, one launch each
    assert out.dtype == torch.float32 and dx.dtype == torch.float32
    assert float((out.detach() - S.spmm_plain(layout, x, precision)).abs().max()) <= 1e-5
    assert float((dx - S.spmm_plain(layout, g, precision)).abs().max()) <= 1e-5
    assert torch.equal(S.spmm_cuda(layout, x, precision), out.detach())  # deterministic
    isolated = torch.as_tensor(np.setdiff1d(np.arange(n), dst[w != 0]), device=device)
    assert float(out.detach()[isolated].abs().sum()) == 0.0
    if precision == "bf16":   # the mode does round: it is not the exact product
        assert float((out.detach() - S.spmm_plain(layout, x)).abs().max()) > 1e-4
        # the exact mode on the rounded input sums the same values, in another order
        rounded = S.spmm_cuda(layout, x.bfloat16().float(), "f32")
        assert float((out.detach() - rounded).abs().max()) <= 1e-5


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 32, 128])
@pytest.mark.parametrize("graph,max_segment", [("small", 8), ("skewed", 256)])
def test_spmm_hub_rows_bit_equal_to_the_plain_finish(device, graph, max_segment, D, precision):
    """The hub rows the kernel finishes inside its launch are, bit for bit,
    ``hub_finish_plain`` of the partial rows that launch wrote."""
    src, dst, w, n = _small_graph() if graph == "small" else _skewed_graph()
    layout = S.csr_graph(src, dst, w, n, max_segment=max_segment, device=device)
    assert layout.num_hubs > 0
    x = torch.randn(n, D, device=device)
    src_x = x.bfloat16() if precision == "bf16" else x
    out = torch.empty_like(x)
    partial = torch.empty((layout.num_partials, D), device=device)
    stream = torch.cuda.current_stream().cuda_stream
    S.reset_launch_counts()
    for _ in range(3):
        S.launch_csr(layout, src_x, out, partial, stream)
        torch.cuda.synchronize()
        hub_rows = out[layout.hub_row.long()]
        assert torch.equal(hub_rows, S.hub_finish_plain(layout, partial))
    assert S.LAUNCHES == {"spmm_csr": 0}   # the uncounted entry
    assert torch.equal(out, S.spmm_cuda(layout, x, precision))


def test_spmm_counters_are_zero_after_many_calls(device):
    """200 calls in a row: each is bit-identical to the first, and every
    arrival counter is back at zero (a missing fence or reset would show as
    an odd hub row once in many calls)."""
    src, dst, w, n = _skewed_graph()
    layout = S.csr_graph(src, dst, w, n, max_segment=64, device=device)
    x = torch.randn(n, 64, device=device)
    first = S.spmm_cuda(layout, x, "bf16")
    S.reset_launch_counts()
    differ = sum(not torch.equal(S.spmm_cuda(layout, x, "bf16"), first) for _ in range(200))
    assert differ == 0 and S.LAUNCHES == {"spmm_csr": 200}
    counters = S.hub_counters(layout, torch.cuda.current_stream().cuda_stream)
    assert counters.shape == (layout.num_hubs,) and int(counters.abs().sum()) == 0


def test_spmm_cuda_graph_replay_is_bit_equal_to_the_eager_call(device):
    src, dst, w, n = _skewed_graph()
    layout = S.csr_graph(src, dst, w, n, device=device)
    assert layout.num_hubs > 0
    x = torch.randn(n, 64, device=device)
    eager = S.spmm_cuda(layout, x, "bf16")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the capture stream's counters are made before capture
        S.spmm_cuda(layout, x, "bf16")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    S.reset_launch_counts()
    with torch.cuda.graph(graph, stream=side):
        captured = S.spmm_cuda(layout, x, "bf16")
    assert S.LAUNCHES == {"spmm_csr": 1}
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert int(S.hub_counters(layout, side.cuda_stream).abs().sum()) == 0


def test_trainer_mode_on_the_card(device):
    """``auto`` on the card: K2 in its "bf16" mode through the trainer's prop_fn."""
    from recsys_tpu_torch.config import GNNConfig
    from recsys_tpu_torch.ops.graph import BipartiteGraph
    from recsys_tpu_torch.train import gnn as G

    src, dst, w, n = _small_graph()
    graph = BipartiteGraph(700, 500, src, dst, w, np.zeros((n, 2), np.float32),
                           np.ones(2, np.float32), np.zeros((n, 2), np.float32))
    prop_fn, layout = G.select_propagation(GNNConfig(), graph, n, device)
    assert prop_fn is G.spmm_bf16 and isinstance(layout, S.CsrGraph)
    x = torch.randn(n, 64, device=device)
    S.reset_launch_counts()
    out = prop_fn(layout, x)
    assert S.LAUNCHES["spmm_csr"] == 1
    assert float((out - S.spmm_plain(layout, x, "bf16")).abs().max()) <= 1e-5


def test_spmm_kernel_rejects_bad_inputs(device):
    src, dst, w, n = _small_graph()
    layout = S.csr_graph(src, dst, w, n, device=device)
    x = torch.randn(n, 64, device=device)
    for bad in (x.double(), x[:-1], x.t().contiguous().t(), x.cpu()):
        with pytest.raises(ValueError):
            S.spmm_cuda(layout, bad) if bad.is_cuda else S.spmm(layout, bad)
    with pytest.raises(ValueError, match="precision"):
        S.spmm_cuda(layout, x, "fp16")
    with pytest.raises(ValueError, match="32, 64 or 128"):
        S.spmm_cuda(layout, torch.randn(n, 48, device=device))


# -- K3: the FM second-order term ---------------------------------------------

def _fm_value_and_grad(fn, v, g):
    x = v.clone().requires_grad_(True)
    out = fn(x)
    (dv,) = torch.autograd.grad((out * g).sum(), x)
    return out.detach(), dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [
    (200, 12, 16),       # the JAX suite's shape
    (2049, 3, 8),        # a ragged batch, four field groups a warp
    (2048, 20, 16),      # DeepFM training
    (131072, 20, 16),    # large-candidate scoring
    (77, 7, 12), (33, 4, 48), (65, 5, 1), (40, 6, 32), (1, 1, 64),   # any F, any K
])
def test_fm_kernel_matches_plain(device, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    v = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device).to(dtype)
    g = torch.as_tensor(rng.normal(size=shape[0]).astype(np.float32), device=device)
    ref_out, ref_dv = _fm_value_and_grad(fm_interaction, v, g)
    FK.reset_launch_counts()
    out, dv = _fm_value_and_grad(FK.fused_fm_interaction, v, g)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {"fm_fwd": 1, "fm_bwd": 1}
    assert out.dtype == torch.float32 and out.shape == (shape[0],)
    assert dv.dtype == dtype and dv.shape == shape
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-3)
    # dv is rounded to v's type on both sides; one unit in the last place apart at most
    ulp = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[dtype]
    torch.testing.assert_close(dv.float(), ref_dv.float(), rtol=1e-4 + ulp, atol=1e-3)
    torch.testing.assert_close(dv.float(), FK.fm_bwd_plain(v, g).float(),
                               rtol=1e-4 + ulp, atol=1e-3)
    assert torch.equal(FK.fm_fwd_cuda(v), out)            # deterministic
    assert torch.equal(FK.fm_bwd_cuda(v, g), dv)


# each edge case: its input and the kernel its plan takes (both directions)
_FM_EDGES = {
    # 6151 rows x 4 threads: the persistent grid's last block is part empty
    "tail_tile": ((6151, 20, 16), torch.float32, 0, "vector"),
    # 7 x 3 fp32 values a row: 84 bytes, no 16-byte loads
    "span_not_16_bytes": ((999, 7, 3), torch.float32, 0, "direct"),
    # one fp32 value into the storage: the base is 4 bytes off
    "storage_offset": ((2049, 20, 16), torch.float32, 1, "direct"),
    "fp16": ((4097, 20, 16), torch.float16, 0, "vector"),
    # K = 12: three 16-byte vectors a field, not a power of two
    "k_not_dividing_32": ((3001, 5, 12), torch.float32, 0, "direct"),
    "k_above_32": ((513, 3, 40), torch.float32, 0, "direct"),
    # 400 fields: more than a thread's registers hold, so the backward reads v again
    "fields_above_a_batch": ((32, 400, 16), torch.float32, 0, "vector"),
}


@pytest.mark.parametrize("case", list(_FM_EDGES))
def test_fm_kernel_edge_cases(device, case):
    shape, dtype, offset, kernel = _FM_EDGES[case]
    rng = np.random.default_rng(len(case))
    flat = rng.normal(size=offset + int(np.prod(shape))).astype(np.float32)
    v = torch.as_tensor(flat, device=device).to(dtype)[offset:].view(shape)
    g = torch.as_tensor(rng.normal(size=shape[0]).astype(np.float32), device=device)
    assert FK.kernel_of(v) == kernel
    assert FK.kernel_of(v, torch.empty_like(v)) == kernel
    ref_out, ref_dv = _fm_value_and_grad(fm_interaction, v, g)
    ulp = 2.0 ** -10 if dtype == torch.float16 else 0.0
    FK.reset_launch_counts()
    out = FK.fm_fwd_cuda(v)
    dv = FK.fm_bwd_cuda(v, g)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {"fm_fwd": 1, "fm_bwd": 1}
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dv.float(), ref_dv.float(), rtol=1e-4 + ulp, atol=1e-3)
    assert torch.equal(FK.fm_fwd_cuda(v), out)            # deterministic
    assert torch.equal(FK.fm_bwd_cuda(v, g), dv)


def test_fm_kernel_dispatch_and_bad_inputs(device):
    v = torch.randn(8, 3, 16, device=device)
    FK.reset_launch_counts()
    assert torch.equal(select_fm("auto")(v), FK.fm_fwd_cuda(v))
    assert torch.equal(select_fm("pallas")(v), FK.fm_fwd_cuda(v))
    assert FK.LAUNCHES["fm_fwd"] == 4
    select_fm("xla")(v)
    assert FK.LAUNCHES["fm_fwd"] == 4                     # the plain form launches nothing
    assert FK.fused_fm_interaction(v[:0]).shape == (0,)   # no rows: no launch
    assert FK.LAUNCHES["fm_fwd"] == 4
    # a view that is not contiguous is copied by the wrapper, refused by the kernel call
    t = v.transpose(1, 2)
    torch.testing.assert_close(FK.fused_fm_interaction(t), fm_interaction(t),
                               rtol=1e-4, atol=1e-3)
    for bad in (v.double(), t, v[0], v.cpu()):
        with pytest.raises((ValueError, RuntimeError)):
            FK.fm_fwd_cuda(bad)
    with pytest.raises(ValueError):
        FK.fm_bwd_cuda(v, torch.zeros(8, device=device, dtype=torch.float64))
    with pytest.raises(ValueError):
        FK.fm_bwd_cuda(v, torch.zeros(7, device=device))


# -- K4: the ring all-gather over virtual ranks -----------------------------------

def _ring_shards(S, shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed + S)
    return [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device).to(dtype)
            for _ in range(S)]


def _ring_name(S, bidirectional):
    return "ring_bidi" if bidirectional and S > 2 else "ring_uni"


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
@pytest.mark.parametrize("S", [2, 3, 4, 8])
@pytest.mark.parametrize("shape,dtype", [
    ((768, 1000), torch.float32),     # the packed top-k candidates: 3.07 MB a rank
    ((24, 128), torch.bfloat16),      # embeddings of a data shard
    ((7, 33), torch.float32),         # ragged: 924 bytes, places not 16-byte aligned
], ids=["f32_768x1000", "bf16_24x128", "f32_7x33"])
def test_ring_kernel_matches_plain(device, shape, dtype, S, bidirectional):
    shards = _ring_shards(S, shape, dtype, device)
    R.reset_launch_counts()
    out = R.ring_all_gather(shards, bidirectional)
    torch.cuda.synchronize()
    R.check_errors()
    name = _ring_name(S, bidirectional)
    assert R.LAUNCHES == {"ring_uni": 0, "ring_bidi": 0} | {name: 1}
    whole = torch.cat(shards)
    plain = R.ring_all_gather_plain(shards, bidirectional)
    assert len(out) == S and len({o.data_ptr() for o in out}) == S    # each rank its own
    for o, p in zip(out, plain):
        assert o.shape == whole.shape and o.dtype == dtype
        assert torch.equal(o, p) and torch.equal(o, whole)
    for o, again in zip(out, R.ring_all_gather(shards, bidirectional)):   # a second call
        assert torch.equal(o, again)
    torch.cuda.synchronize()
    R.check_errors()


@pytest.mark.parametrize("offset", [1, 4, 16])
def test_ring_kernel_moves_bytes_at_any_alignment(device, offset):
    """Shards that start 1, 4 or 16 bytes into an allocation: the byte, the
    4-byte and the 16-byte copy loops."""
    S, rows, cols = 3, 5, 37
    base = [torch.randint(0, 256, (offset + rows * cols,), dtype=torch.uint8, device=device)
            for _ in range(S)]                       # every allocation starts aligned
    shards = [b[offset:].view(rows, cols) for b in base]
    assert all(s.data_ptr() % 16 == offset % 16 for s in shards)
    for bidirectional in (False, True):
        out = R.ring_all_gather(shards, bidirectional)
        torch.cuda.synchronize()
        R.check_errors()
        assert all(torch.equal(o, torch.cat(shards)) for o in out)


def test_ring_kernel_on_the_strided_axis_of_a_mesh(device):
    """The data axis of a 4 x 2 mesh laid over the card: two rings of four,
    each over every second device of the grid, one gather per ring."""
    from recsys_tpu_torch.config import MeshConfig
    from recsys_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(MeshConfig(num_data=4, num_model=2), ["cuda:0"] * 8)
    rings = mesh.groups("data")
    assert len(rings) == 2 and all(len(ring) == 4 for ring in rings)
    R.reset_launch_counts()
    for g, ring in enumerate(rings):
        shards = [s.to(dev) for s, dev in zip(_ring_shards(4, (8, 4), torch.float32, device, g),
                                              ring)]
        for o in R.ring_all_gather(shards, bidirectional=True):
            assert torch.equal(o, torch.cat(shards))
    torch.cuda.synchronize()
    R.check_errors()
    assert R.LAUNCHES == {"ring_uni": 0, "ring_bidi": 2}


def test_ring_kernel_back_to_back(device):
    """100 calls with no synchronise between them: the flags carry the call's
    epoch, so no call waits on or is satisfied by another's."""
    S = 8
    sets = [_ring_shards(S, (64, 100), torch.float32, device, seed) for seed in range(4)]
    outs = [R.ring_all_gather(sets[i % 4], bidirectional=bool(i % 2)) for i in range(100)]
    torch.cuda.synchronize()
    R.check_errors()
    for i, out in enumerate(outs):
        whole = torch.cat(sets[i % 4])
        assert all(torch.equal(o, whole) for o in out), i


def test_ring_kernel_wait_gives_up_and_reports(device):
    """A launch that serves rank 0 only: rank 1 never sends, rank 0's wait
    runs out of its (short) budget, the kernel ends and ``check_errors``
    raises once. The next whole call is clean."""
    shards = _ring_shards(2, (16, 16), torch.float32, device)
    R._launch(shards, first=0, count=1, spin_seconds=0.01)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="rank 0 waited in vain for hop 0"):
        R.check_errors()
    R.check_errors()                                  # reported once
    out = R.ring_all_gather(shards)
    torch.cuda.synchronize()
    R.check_errors()
    assert torch.equal(out[0], torch.cat(shards)) and torch.equal(out[1], out[0])


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
@pytest.mark.parametrize("S", [4, 8])
def test_ring_sharded_topk_on_the_card(device, S, bidirectional):
    from recsys_tpu_torch.parallel.collectives import sharded_topk, sharded_topk_ring_merge

    B, N, k = 64, 4096, 100
    scores = torch.as_tensor(np.random.default_rng(S).normal(size=(B, N)).astype(np.float32),
                             device=device)
    shards = list(scores.chunk(S, dim=1))
    dense_vals, dense_idx = torch.topk(scores, k)
    R.reset_launch_counts()
    out = R.ring_sharded_topk(shards, k, bidirectional)
    torch.cuda.synchronize()
    R.check_errors()
    assert R.LAUNCHES[_ring_name(S, bidirectional)] == 1 and sum(R.LAUNCHES.values()) == 1
    for fn_out in (out, sharded_topk(shards, k), sharded_topk_ring_merge(shards, k)):
        assert len(fn_out) == S
        for vals, idx in fn_out:
            assert torch.equal(vals, dense_vals) and torch.equal(idx, dense_idx)


def test_ring_kernel_rejects_bad_inputs(device):
    x = torch.randn(4, 8, device=device)
    with pytest.raises(ValueError):
        R.ring_all_gather([x, x[:2]])
    with pytest.raises(ValueError):
        R.ring_all_gather([x, x.double()])
    with pytest.raises(ValueError):
        R.ring_all_gather_cuda([x])                       # S = 1 is the wrapper's
    with pytest.raises(ValueError):
        R.ring_all_gather_cuda([x.t(), x.t()])            # not contiguous
    with pytest.raises(RuntimeError, match="CUDA"):
        R.ring_all_gather_cuda([x, x.cpu()])
    assert R.ring_all_gather([x])[0] is x
    empty = R.ring_all_gather([x[:0], x[:0]])
    assert empty[0].shape == (0, 8)
    # more ranks than the card holds blocks for, or than the parameter tables hold
    with pytest.raises((RuntimeError, ValueError)):
        R.ring_all_gather([x] * 300)


def test_bucket_embed_gradient_is_the_same_every_run(device):
    """The time buckets' table of the stage-2 and hybrid towers (10 rows,
    every position of a 768 x 50 batch): ``BucketEmbed``'s gradient is the
    same bits in five runs, and within 1e-3 of the float64 sum (sums of
    ~3,840 unit terms in float32, as tests/test_torch_bucket_embed.py)."""
    from recsys_tpu_torch.models.layers import BF16, BucketEmbed

    torch.manual_seed(0)
    emb = BucketEmbed(10, 128).to(device)
    gen = torch.Generator(device).manual_seed(1)
    ids = torch.randint(0, 10, (768, 50), device=device, generator=gen)
    g = torch.randn(768, 50, 128, device=device, generator=gen)
    grads = []
    for _ in range(5):
        emb.weight.grad = None
        emb(ids).float().backward(g)
        grads.append(emb.weight.grad.clone())
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    want = torch.zeros(10, 128, dtype=torch.float64, device=device).index_add_(
        0, ids.reshape(-1), g.to(BF16).double().reshape(-1, 128))
    torch.testing.assert_close(grads[0].double(), want, atol=1e-3, rtol=0)
