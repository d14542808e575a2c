"""K1 (fused contrastive CE), K2 (sparse propagation) and K3 (the FM term) on
the card: build, check against the plain forms, time at the main path's
shapes.

    python3 scripts/torch_kernel_bench.py [--quick] [--baseline DIR] [--kernels K3,K1]
        [--hm-root DIR]

Needs one NVIDIA GPU and nvcc. ``--quick`` builds the kernels, prints what
ptxas reports, checks each once at its real widths and stops. ``--baseline
DIR`` names a second checkout of the repository (an older commit, unpacked with
``git archive``): its kernels are timed in a process of their own before and
after this checkout's (baseline, this, this, baseline), so that two versions
are compared on one card within one run. Every line printed is one JSON
object; the first names the card and its power limit.

K2 is timed at the reference-scale graph of ``chip_smoke.py`` (200,000 users,
47,000 items, 11.3M interactions -> 22.6M directed edges, D = 64): the kernel
in each mode it has: the wrapper's call (CUDA events), the plain form, the
segment kernel's time on the device (``torch.profiler``) and, for a checkout
that still finishes the hub rows in a second kernel, that kernel's (0 where
the segment kernel finishes them itself), and the launches a call. With
``--hm-root DIR`` (the ``data.root`` of a generated world, such as the H&M
world of ``scripts/torch_quality_hm.py``) K2 is timed instead at that world's
graph, built as ``train-gnn`` builds it (``graph_from_transactions`` over the
training transactions), D = 64, in both modes: the segment kernel's device
time, the wrapper's call, the plain form and ``torch.sparse.mm`` on the same
CSR (CUDA events), beside the byte bound (x in 2 bytes in "bf16", out in 4,
the CSR's column indices and weights and its row pointers in 4 each, at 3.35
TB/s), and the graph's nodes, edges, hub rows and largest degree. K1 is timed through the
loss wrappers the trainers call (forward and backward) at B = 192, 768 and
8192, D = 128, and per kernel there, in a loop (CUDA events: at small B this
is what the Python wrapper costs), on the device, and on the host clock
without waiting for the device (the wrapper's own cost); and at the shape stage 2
runs, B = 768 users x 4 positions = 3072 rows with user ids repeated and
positive ids drawn with popularity skew from a 47,000-item catalog (form
``stage2``, no valid mask), kernel against plain, fwd+bwd and per kernel.
K3 is timed at DeepFM's training shape (2048, 20, 16) and at the
large-candidate scoring shape (131072, 20, 16), each in fp32 and bf16, the
forward and the backward kernel, and at (131072, 20, 24) fp32, a width the
vector kernel does not take (each row names the kernel its plan takes; an older
checkout's one kernel as ``single``): the wrapper's call in a loop (CUDA events),
its time on the device (``torch.profiler``) and the plain form's, beside the
byte bound (v read once, out or dv written once, at 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int, repeats: int = 5) -> float:
    """Host time per call of ``fn`` in a loop, without waiting for the device:
    what the Python wrapper and the launches cost the host. The least of
    ``repeats`` loops (the host clock of a shared machine only adds noise)."""
    import torch

    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / iters


def device_ms(fn, iters: int, name: str) -> float:
    """Time on the device per call of the kernels whose name contains ``name``
    (``torch.profiler``): what a launch costs the card, without the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                   for e in prof.key_averages() if name in e.key)
    return total_us / 1e3 / iters


def reference_graph(seed: int = 0):
    import numpy as np

    users, items, interactions = 200_000, 47_000, 11_300_000
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, interactions).astype(np.int64)
    i = (items * rng.random(interactions) ** 2.5).astype(np.int64)
    n = users + items
    deg = np.bincount(u, minlength=n).astype(np.float64)
    deg[users:] += np.bincount(i, minlength=items)
    d_inv = 1.0 / np.sqrt(np.clip(deg, 1.0, None))
    w = (d_inv[u] * d_inv[users + i]).astype(np.float32)
    return (np.concatenate([u, users + i]).astype(np.int32),
            np.concatenate([users + i, u]).astype(np.int32), np.concatenate([w, w]), n)


def k2(tag: str, quick: bool) -> None:
    import numpy as np
    import torch

    from recsys_tpu_torch.ops import spmm as S

    S.load_library()
    emit(tag=tag, kernel="K2", build_seconds=S.BUILD_INFO.get("seconds"),
         ptxas=[ln.strip() for ln in S.BUILD_INFO.get("ptxas", "").splitlines()
                if "registers" in ln or "spill" in ln])
    modes = getattr(S, "PRECISIONS", None)   # an older checkout has the fp32 kernel only
    call = (lambda lay, x, m: S.spmm_cuda(lay, x, m)) if modes else (lambda lay, x, m: S.spmm_cuda(lay, x))
    plain = (lambda lay, x, m: S.spmm_plain(lay, x, m)) if modes else (lambda lay, x, m: S.spmm_plain(lay, x))
    src, dst, w, n = reference_graph()
    layout = S.csr_graph(src, dst, w, n, device="cuda")
    rng = np.random.default_rng(1)
    for dim in (64,) if quick else (64, 32, 128):
        x = torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32), device="cuda")
        for mode in modes or ("f32",):
            out = call(layout, x, mode)
            torch.cuda.synchronize()
            ref = plain(layout, x, mode)
            row = {"tag": tag, "kernel": "K2", "mode": mode, "dim": dim,
                   "max_abs_err": float((out - ref).abs().max()),
                   "bit_equal": bool(torch.equal(call(layout, x, mode), out))}
            del ref
            S.reset_launch_counts()
            call(layout, x, mode)
            row["launches_per_call"] = sum(S.LAUNCHES.values())
            if not quick:
                row["wrapper_ms"] = cuda_ms(lambda: call(layout, x, mode), 20)
                if dim == 64:
                    row["plain_ms"] = cuda_ms(lambda: plain(layout, x, mode), 5)
                    row["segments_kernel_device_ms"] = device_ms(
                        lambda: call(layout, x, mode), 20, "spmm_segments_kernel")
                    row["hub_kernel_device_ms"] = device_ms(
                        lambda: call(layout, x, mode), 20, "spmm_hub_reduce_kernel")
            emit(**row)


def k2_hm(tag: str, quick: bool, root: str) -> None:
    """K2 at the graph ``train-gnn`` builds from the world at ``root``."""
    import numpy as np
    import torch

    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.ops import spmm as S
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train.gnn import graph_from_transactions

    S.load_library()
    t0 = time.perf_counter()
    cfg = cli.config_from_args(cli.parse_args(["train-gnn", "--set", f"data.root={root}"]))
    items, _, tx = cli._load_world(cfg)
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    user_map = {u: r for r, u in enumerate(sorted(train_tx["user_id"].unique()))}
    item_map = {i: r for r, i in enumerate(sorted(items["item_id"].astype(str)))}
    graph = graph_from_transactions(train_tx, user_map, item_map, cfg.gnn, cfg.data.seed)
    del items, tx, train_tx
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cuda")
    n, dim, E = graph.num_nodes, cfg.gnn.emb_dim, layout.num_edges
    emit(tag=tag, kernel="K2", graph="hm", root=root, build_graph_seconds=time.perf_counter() - t0,
         **cli.graph_stats(graph), layout_edges=E, layout_hub_rows=layout.num_hubs,
         layout_segments=layout.num_segments)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(n, dim)).astype(np.float32),
                        device="cuda")
    csr = torch.sparse_csr_tensor(layout.rowptr.long(), layout.col.long(), layout.val, (n, n))
    library_ms = None if quick else cuda_ms(lambda: torch.sparse.mm(csr, x), 10)
    for mode in S.PRECISIONS:
        out = S.spmm_cuda(layout, x, mode)
        ref = S.spmm_plain(layout, x, mode)
        x_bytes = 2 if mode == "bf16" else 4
        n_bytes = n * dim * (x_bytes + 4) + 4 * (2 * E + n + 1)
        row = {"tag": tag, "kernel": "K2", "graph": "hm", "mode": mode, "dim": dim,
               "max_abs_err": float((out - ref).abs().max()),
               "bit_equal": bool(torch.equal(S.spmm_cuda(layout, x, mode), out)),
               "bound_ms": max(n_bytes / 3.35e12, 2.0 * E * dim / 67e12) * 1e3,
               "bound_by": "bytes" if n_bytes / 3.35e12 >= 2.0 * E * dim / 67e12 else "operations",
               "library_ms": library_ms}
        del out, ref
        S.reset_launch_counts()
        S.spmm_cuda(layout, x, mode)
        row["launches_per_call"] = sum(S.LAUNCHES.values())
        if not quick:
            row["segments_kernel_device_ms"] = device_ms(
                lambda: S.spmm_cuda(layout, x, mode), 20, "spmm_segments_kernel")
            row["wrapper_ms"] = cuda_ms(lambda: S.spmm_cuda(layout, x, mode), 20)
            row["plain_ms"] = cuda_ms(lambda: S.spmm_plain(layout, x, mode), 3)
        emit(**row)


def k1(tag: str, quick: bool) -> None:
    import numpy as np
    import torch

    from recsys_tpu_torch.ops import contrastive_kernel as K
    from recsys_tpu_torch.ops.contrastive import bidirectional_infonce, inbatch_logq_loss

    K.load_library()
    emit(tag=tag, kernel="K1", build_seconds=K.BUILD_INFO.get("seconds"),
         ptxas=[ln.strip() for ln in K.BUILD_INFO.get("ptxas", "").splitlines()
                if "registers" in ln or "spill" in ln])

    def grads(fn, a, b):
        a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        loss = fn(a, b)
        return (loss.detach(), *torch.autograd.grad(loss, (a, b)))

    for B, dim in ((192, 128), (200, 128), (200, 64), (200, 256), (768, 128), (8192, 128)):
        rng = np.random.default_rng(B + dim)
        unit = lambda: torch.as_tensor(
            (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
                rng.normal(size=(B, dim)).astype(np.float32)), device="cuda")
        q, k = unit(), unit()
        pos = torch.as_tensor(rng.integers(1, max(B // 4, 2), B), device="cuda")
        usr = torch.as_tensor(rng.integers(0, max(B // 3, 2), B), device="cuda")
        logq = torch.as_tensor(rng.uniform(-8, -1, B).astype(np.float32), device="cuda")
        valid = torch.as_tensor((rng.random(B) > 0.1).astype(np.int32), device="cuda")
        kw = dict(temperature=0.1, user_ids=usr, valid=valid)
        forms = {
            "logq": (lambda a, b: K.fused_inbatch_logq_loss(a, b, pos, logq, **kw),
                     lambda a, b: inbatch_logq_loss(a, b, pos, logq, **kw)),
            "simcse": (lambda a, b: K.fused_bidirectional_infonce(a, b, 0.08),
                       lambda a, b: bidirectional_infonce(a, b, 0.08))}
        for form, (kern, ref) in forms.items():
            got, want = grads(kern, q, k), grads(ref, q, k)
            torch.cuda.synchronize()
            row = {"tag": tag, "kernel": "K1", "B": B, "D": dim, "form": form,
                   "loss_err": abs(float(got[0]) - float(want[0])),
                   "grad_err": max(float((x - y).abs().max())
                                   for x, y in zip(got[1:], want[1:]))}
            if not quick and dim == 128:
                iters = 20 if B >= 4096 else 100
                row["fwd_bwd_ms"] = cuda_ms(lambda: grads(kern, q, k), iters)
                row["plain_fwd_bwd_ms"] = cuda_ms(lambda: grads(ref, q, k), iters)
            emit(**row)
        if not quick and dim == 128 and B in (192, 768, 8192):
            per_kernel(tag, B, dim, q, k, logq[pos], pos, usr, valid)
    stage2(tag, quick, grads)


def per_kernel(tag, B, dim, q, k, corr, pos, usr, valid) -> None:
    """Each K1 kernel in a loop (CUDA events) and on the device, and each
    plain form in the same loop."""
    import torch

    from recsys_tpu_torch.ops import contrastive_kernel as K

    meta = (corr, pos.int(), usr.int(), valid)
    _, lse = K.diag_ce_fwd_cuda(q, k, *meta, 0.1)
    g = valid.float() / valid.float().sum()
    args = (q, k, *meta, lse, g, 0.1)
    iters = 20 if B >= 4096 else 200
    calls = {"diag_ce_fwd": lambda: K.diag_ce_fwd_cuda(q, k, *meta, 0.1),
             "diag_ce_bwd_dq": lambda: K.diag_ce_bwd_dq_cuda(*args),
             "diag_ce_bwd_dk": lambda: K.diag_ce_bwd_dk_cuda(*args)}
    plain = {"diag_ce_fwd": lambda: K.diag_ce_fwd_plain(q, k, *meta, 0.1),
             "diag_ce_bwd_dq": lambda: K.diag_ce_bwd_dq_plain(*args),
             "diag_ce_bwd_dk": lambda: K.diag_ce_bwd_dk_plain(*args)}
    torch.cuda.synchronize()
    emit(tag=tag, kernel="K1", B=B, D=dim,
         per_kernel_ms={name: cuda_ms(fn, iters) for name, fn in calls.items()},
         per_kernel_plain_ms={name: cuda_ms(fn, iters) for name, fn in plain.items()},
         per_kernel_host_us={name: host_us(fn, iters) for name, fn in calls.items()},
         per_kernel_device_ms={name: device_ms(fn, iters, "diag_ce")
                               for name, fn in calls.items()})


def stage2(tag: str, quick: bool, grads) -> None:
    """K1 at stage 2's B = 768 x 4 = 3072 (the loss the stage-2 step calls)."""
    import numpy as np
    import torch

    from recsys_tpu_torch.ops import contrastive_kernel as K
    from recsys_tpu_torch.ops.contrastive import inbatch_logq_loss

    users, positions, catalog, dim = 768, 4, 47_000, 128
    B = users * positions
    rng = np.random.default_rng(B)
    unit = lambda: (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
        rng.normal(size=(B, dim)).astype(np.float32))
    q, k = torch.as_tensor(unit(), device="cuda"), torch.as_tensor(unit(), device="cuda")
    pos = torch.as_tensor(1 + (catalog * rng.random(B) ** 3).astype(np.int64), device="cuda")
    usr = torch.as_tensor(np.repeat(np.arange(users), positions), device="cuda")
    logq = torch.as_tensor(rng.normal(-8.0, 1.0, catalog + 1).astype(np.float32),
                           device="cuda")
    kw = dict(temperature=0.1, user_ids=usr)
    kern = lambda a, b: K.fused_inbatch_logq_loss(a, b, pos, logq, **kw)
    ref = lambda a, b: inbatch_logq_loss(a, b, pos, logq, **kw)
    got, want = grads(kern, q, k), grads(ref, q, k)
    torch.cuda.synchronize()
    row = {"tag": tag, "kernel": "K1", "B": B, "D": dim, "form": "stage2",
           "loss_err": abs(float(got[0]) - float(want[0])),
           "grad_err": max(float((x - y).abs().max()) for x, y in zip(got[1:], want[1:]))}
    if not quick:
        row["fwd_bwd_ms"] = cuda_ms(lambda: grads(kern, q, k), 50)
        row["plain_fwd_bwd_ms"] = cuda_ms(lambda: grads(ref, q, k), 50)
    emit(**row)
    if not quick:
        per_kernel(tag, B, dim, q, k, logq[pos], pos, usr,
                   torch.ones(B, dtype=torch.int32, device="cuda"))


def k3(tag: str, quick: bool) -> None:
    import numpy as np
    import torch

    from recsys_tpu_torch.ops import fm_kernel as FM
    from recsys_tpu_torch.ops.fm import fm_interaction

    FM.load_library()
    emit(tag=tag, kernel="K3", build_seconds=FM.BUILD_INFO.get("seconds"),
         ptxas=[ln.strip() for ln in FM.BUILD_INFO.get("ptxas", "").splitlines()
                if "registers" in ln or "spill" in ln])
    # K = 24 holds six 16-byte vectors of fp32, which the vector kernel does not take
    cases = [((B, 20, 16), dtype) for B in (2048, 131072)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append(((131072, 20, 24), torch.float32))
    for (B, F, K), dtype in cases:
        rng = np.random.default_rng(B + F)
        v = torch.as_tensor(rng.normal(size=(B, F, K)).astype(np.float32),
                            device="cuda").to(dtype)
        g = torch.as_tensor(rng.normal(size=B).astype(np.float32), device="cuda")
        n, size = B * F * K, v.element_size()
        calls = {"fwd": (lambda: FM.fm_fwd_cuda(v), lambda: fm_interaction(v), n * size + 4 * B),
                 "bwd": (lambda: FM.fm_bwd_cuda(v, g), lambda: FM.fm_bwd_plain(v, g),
                         2 * n * size + 4 * B)}
        # an older checkout has one kernel a direction
        row = {"tag": tag, "kernel": "K3",
               "takes": FM.kernel_of(v) if hasattr(FM, "kernel_of") else "single",
               "shape": [B, F, K], "dtype": str(dtype).split(".")[-1]}
        for d, (kernel, plain, n_bytes) in calls.items():
            got = kernel()
            torch.cuda.synchronize()
            row.update({f"{d}_err": float((got.float() - plain().float()).abs().max()),
                        f"{d}_bit_equal": bool(torch.equal(kernel(), got)),
                        f"{d}_bound_ms": 1e3 * n_bytes / 3.35e12})
            if not quick:
                iters = 500 if B <= 4096 else 100
                row.update({f"{d}_ms": cuda_ms(kernel, iters),
                            f"{d}_device_ms": device_ms(kernel, iters, f"fm_{d}"),
                            f"{d}_plain_ms": cuda_ms(plain, iters)})
        emit(**row)


KERNELS = {"K2": k2, "K1": k1, "K3": k3}


def run_here(tag: str, quick: bool, kernels: list[str], hm_root: str | None = None) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_bench: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in kernels:
        if name == "K2" and hm_root:
            k2_hm(tag, quick, hm_root)
        else:
            KERNELS[name](tag, quick)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--baseline", help="a second checkout whose kernels are timed in turns")
    ap.add_argument("--kernels", default="K2,K1,K3", help="which kernels, in order")
    ap.add_argument("--hm-root", dest="hm_root",
                    help="time K2 at the graph of the world in this data root")
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    if not args.baseline:
        sys.path.insert(0, args.root)
        if args.tag == "this":
            emit(card=smi.stdout.strip())
        run_here(args.tag, args.quick, args.kernels.split(","), args.hm_root)
        return
    emit(card=smi.stdout.strip())
    for tag, root in (("baseline_1", args.baseline), ("this_1", ROOT), ("this_2", ROOT),
                      ("baseline_2", args.baseline)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                               os.path.abspath(root), "--tag", tag, "--kernels", args.kernels]
                              + (["--quick"] if args.quick else [])
                              + (["--hm-root", args.hm_root] if args.hm_root else []), cwd=root)
        emit(tag=tag, exit_code=proc.returncode, seconds=time.perf_counter() - t0)
        if proc.returncode != 0:
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
