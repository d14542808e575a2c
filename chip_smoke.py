"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernel K1 (recsys_tpu_torch/csrc/diag_ce.cu, sm_90a) from the
checkout, then:

  1. kernel vs plain: K1's forward and both backward kernels against their
     plain PyTorch forms on the card, at the SimCSE shape (B=192, D=128),
     the stage-2 LogQ form (B=200 ragged and B=768, with LogQ corrections,
     same-item and same-user collisions and ~10% invalid columns) and
     B=8192. Tolerances are the JAX suite's: loss 1e-4, grads 1e-5 (abs).
     CUDA-event times of kernel and plain form.
  2. slice: the port's CLI stages gen-data -> train-item (full-width item
     tower, batch 192, ~10 steps) -> vectorize on the card. K1's launch
     counts are zeroed just before and read just after; every kernel must
     have launched.
  3. serve: the port's HTTP server with the trained encoder answers
     ingest -> process-pending -> similarity; served vectors must match the
     vectorize matrix.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
without it. TF32 is off, so the plain fp32 oracle is full fp32.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.request


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


try:
    import numpy as np
    import torch

    from recsys_tpu_torch.ops import contrastive_kernel as K
    from recsys_tpu_torch.ops.contrastive import bidirectional_infonce, inbatch_logq_loss
except ImportError as e:  # run outside the repository
    fail(f"cannot import the port ({e}); run from the repository root")

KERNEL_SOURCE = "recsys_tpu_torch/csrc/diag_ce.cu"
REPLACES = {
    "diag_ce_fwd": "recsys_tpu/ops/pallas_contrastive.py:73",
    "diag_ce_bwd_dq": "recsys_tpu/ops/pallas_contrastive.py:97",
    "diag_ce_bwd_dk": "recsys_tpu/ops/pallas_contrastive.py:97",
}
LOSS_TOL, GRAD_TOL = 1e-4, 1e-5
SERVE_TOL = 2e-2  # served vs materialized rows, as tests/test_serve.py
MAIN_B, D = 192, 128


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


# -- phase 1: kernel vs plain -------------------------------------------------

def make_problem(B: int, form: str, seed: int, device):
    """Inputs of one K1 call: (q, k, corr, pos, usr, valid, tau)."""
    rng = np.random.default_rng(seed)

    def unit():
        x = rng.normal(size=(B, D)).astype(np.float32)
        return torch.as_tensor(x / np.linalg.norm(x, axis=1, keepdims=True), device=device)

    q, k = unit(), unit()
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    if form == "simcse":
        uniq = -np.arange(B) - 500_000
        return (q, k, torch.zeros(B, device=device), i32(uniq), i32(uniq),
                i32(np.ones(B)), 0.08)
    pos = rng.integers(1, max(B // 4, 2), B)
    logq = rng.uniform(-8, -1, B).astype(np.float32)
    return (q, k, torch.as_tensor(logq[pos], device=device), i32(pos),
            i32(rng.integers(0, max(B // 3, 2), B)), i32(rng.random(B) > 0.1), 0.1)


def loss_fns(prob, form: str):
    """(kernel loss, plain loss) of the wrappers the trainers call."""
    q, k, corr, pos, usr, valid, tau = prob
    if form == "simcse":
        return (lambda a, b: K.fused_bidirectional_infonce(a, b, tau),
                lambda a, b: bidirectional_infonce(a, b, tau))
    logq = torch.zeros(int(pos.max()) + 1, device=q.device)
    logq[pos.long()] = corr
    kw = dict(temperature=tau, user_ids=usr, valid=valid)
    return (lambda a, b: K.fused_inbatch_logq_loss(a, b, pos, logq, **kw),
            lambda a, b: inbatch_logq_loss(a, b, pos, logq, **kw))


def value_and_grads(fn, q, k):
    a, b = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
    loss = fn(a, b)
    ga, gb = torch.autograd.grad(loss, (a, b))
    return loss.detach(), ga, gb


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(kernel_fn, plain_fn, iters: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain: the mean of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_phase(device) -> tuple[list[dict], dict]:
    shapes = [(MAIN_B, "simcse"), (200, "logq"), (768, "logq"), (8192, "logq"),
              (8192, "simcse")]
    errs = {name: 0.0 for name in K.LAUNCHES}
    per_kernel_ms = {}
    rows = []
    for B, form in shapes:
        prob = make_problem(B, form, seed=B, device=device)
        q, k, corr, pos, usr, valid, tau = prob
        meta = (corr, pos, usr, valid)
        # each kernel against its plain form, g = the mean-loss gradient
        loss_k, lse_k = K.diag_ce_fwd_cuda(q, k, *meta, tau)
        loss_p, lse_p = K.diag_ce_fwd_plain(q, k, *meta, tau)
        g = valid.float() / valid.float().sum()
        args = (q, k, *meta, lse_p, g, tau)
        dq_err = float((K.diag_ce_bwd_dq_cuda(*args) - K.diag_ce_bwd_dq_plain(*args)).abs().max())
        dk_err = float((K.diag_ce_bwd_dk_cuda(*args) - K.diag_ce_bwd_dk_plain(*args)).abs().max())
        fwd_err = float(torch.maximum((loss_k - loss_p).abs(), (lse_k - lse_p).abs()).max())
        check(fwd_err <= LOSS_TOL, f"B={B} {form}: fwd kernel err {fwd_err}")
        check(dq_err <= GRAD_TOL and dk_err <= GRAD_TOL,
              f"B={B} {form}: bwd kernel err dq {dq_err} dk {dk_err}")
        errs["diag_ce_fwd"] = max(errs["diag_ce_fwd"], fwd_err)
        errs["diag_ce_bwd_dq"] = max(errs["diag_ce_bwd_dq"], dq_err)
        errs["diag_ce_bwd_dk"] = max(errs["diag_ce_bwd_dk"], dk_err)

        # the loss the trainers call, through autograd, against the plain loss
        kern_fn, plain_fn = loss_fns(prob, form)
        got, ref = value_and_grads(kern_fn, q, k), value_and_grads(plain_fn, q, k)
        loss_err = abs(float(got[0]) - float(ref[0]))
        grad_err = max(float((x - y).abs().max()) for x, y in zip(got[1:], ref[1:]))
        check(loss_err <= LOSS_TOL and grad_err <= GRAD_TOL,
              f"B={B} {form}: loss err {loss_err}, grad err {grad_err}")
        iters = 20 if B >= 4096 else 100
        k_ms, p_ms = interleaved_ms(lambda: value_and_grads(kern_fn, q, k),
                                    lambda: value_and_grads(plain_fn, q, k), iters)
        rows.append({"B": B, "D": D, "form": form, "loss_err": loss_err,
                     "grad_err": grad_err, "fwd_bwd_ms": k_ms, "plain_fwd_bwd_ms": p_ms})
        print(json.dumps({"phase": "kernel", **rows[-1]}), flush=True)
        if B == MAIN_B:
            per_kernel_ms = {
                "diag_ce_fwd": interleaved_ms(
                    lambda: K.diag_ce_fwd_cuda(q, k, *meta, tau),
                    lambda: K.diag_ce_fwd_plain(q, k, *meta, tau), 200),
                "diag_ce_bwd_dq": interleaved_ms(
                    lambda: K.diag_ce_bwd_dq_cuda(*args),
                    lambda: K.diag_ce_bwd_dq_plain(*args), 200),
                "diag_ce_bwd_dk": interleaved_ms(
                    lambda: K.diag_ce_bwd_dk_cuda(*args),
                    lambda: K.diag_ce_bwd_dk_plain(*args), 200),
            }
    return rows, {"errs": errs, "ms": per_kernel_ms}


# -- phases 2 and 3: the slice and the server ------------------------------

def http(base: str, method: str, path: str, payload=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def product_json(row: dict) -> dict:
    std = ("product_type_name", "graphical_appearance_name", "colour_group_name",
           "department_name", "section_name", "perceived_colour_value_name")
    rf = row.get("reinforced_feature") or {}
    return {"product_id": str(row["item_id"]), "product_name": row["product_name"],
            "feature_data": {
                "reinforced_feature": {key: [str(v) for v in vals]
                                       for key, vals in rf.items() if vals is not None},
                **{f: row.get(f) for f in std}}}


def slice_phase(root: str, device: str = "cuda", extra_sets: tuple = ()) -> dict:
    import pandas as pd

    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.simcse import MODEL_INPUTS, restore_model, topk_items

    sets = ["--set", f"data.root={root}", "--set", "simcse.epochs=1",
            "--set", "simcse.steps_per_epoch_min=1", "--set", "serve.db_path=:memory:",
            *extra_sets, "--device", device]
    K.reset_launch_counts()  # the main path's run starts here
    gen = cli.main(["gen-data", *sets])
    n_items = gen["items"]
    train = cli.main(["train-item", *sets])
    counts_after_train = dict(K.LAUNCHES)
    check(all(n > 0 for n in counts_after_train.values()),
          f"train-item did not launch every K1 kernel: {counts_after_train}")
    check(train["steps"] >= 10, f"train-item took {train['steps']} steps")
    check(all(np.isfinite(train["losses"])), f"non-finite loss: {train['losses']}")
    vec = cli.main(["vectorize", *sets])
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    check(mat.shape == (n_items + 1, 128) and ids[0] == "<pad>", f"matrix {mat.shape}")
    check(bool(np.isfinite(mat).all()), "non-finite item vectors")
    norms = np.linalg.norm(mat[1:], axis=1)
    check(bool(np.allclose(norms, 1.0, atol=1e-3)), f"row norms {norms.min()}..{norms.max()}")
    nq = min(200, n_items)
    _, top = topk_items(mat, mat[1:nq + 1], k=1, device=device)
    self_rank1 = float((top[:, 0] == np.arange(1, nq + 1)).mean())
    check(self_rank1 >= 0.95, f"self-retrieval at rank 1: {self_rank1}")

    # the trained encoder on the card against the same weights on the CPU
    cfg = cli.config_from_args(cli.parse_args(["vectorize", *sets]))
    tensors = cli._item_tensors(cfg)
    nf = tensors["std"].shape[1]
    model, _ = restore_model(cfg, f"{root}/ckpt_item", nf, device)
    cpu_model, _ = restore_model(cfg, f"{root}/ckpt_item", nf, "cpu")
    with torch.inference_mode():
        on_card = model.encode(*(torch.as_tensor(tensors[k][:64], device=device)
                                 for k in MODEL_INPUTS)).cpu()
        on_cpu = cpu_model.encode(*(torch.as_tensor(tensors[k][:64]) for k in MODEL_INPUTS))
    card_cpu_err = float((on_card - on_cpu).abs().max())
    check(card_cpu_err <= SERVE_TOL, f"encoder card vs CPU: {card_cpu_err}")
    rows_err = float(np.abs(mat[1:65] - on_card.numpy()).max())
    check(rows_err <= SERVE_TOL, f"vectorize rows vs a direct encode: {rows_err}")

    # phase 3: serve with the trained encoder
    args = cli.parse_args(["serve", *sets, "--model-backed"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = http(base, "GET", "/")
        check(device == "cpu" or torch.cuda.get_device_name(0) in health["devices"],
              f"health: {health}")
        items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
        picked = items.iloc[::max(n_items // 64, 1)].head(64).to_dict("records")
        ing = http(base, "POST", "/api/controller/products/ingest",
                   {"products": [product_json(r) for r in picked]})
        check(ing.get("created") == len(picked), f"ingest: {ing}")
        t0, processed, loops = time.perf_counter(), 0, 0
        while True:
            r = http(base, "POST", "/ai-api/serving/vectors/process-pending", {})
            if r["processed_count"] == 0:
                break
            processed += r["processed_count"]
            loops += 1
        process_s = time.perf_counter() - t0
        check(processed == len(picked), f"processed {processed}")
        row_of = {pid: r for r, pid in enumerate(ids)}
        pids = [str(r["item_id"]) for r in picked]
        served = np.stack([ctx.store.get_vector(p) for p in pids])
        served_err = float(np.abs(served - mat[[row_of[p] for p in pids]]).max())
        check(served_err <= SERVE_TOL, f"served vs vectorize rows: {served_err}")
        score_err, t0 = 0.0, time.perf_counter()
        for pid in pids[:8]:
            sim = http(base, "GET", f"/api/controller/similarity/{pid}?top_k=10")
            res = sim["results"]
            check(0 < len(res) <= 10, f"similarity {pid}: {sim}")
            check(all(x["product_id"] != pid for x in res), f"query {pid} in its own list")
            for x in res:
                ref = float(mat[row_of[pid]] @ mat[row_of[x["product_id"]]])
                score_err = max(score_err, abs(x["score"] - ref))
        sim_ms = (time.perf_counter() - t0) * 1e3 / 8
        check(score_err <= SERVE_TOL, f"similarity scores vs vectorize: {score_err}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return {"train": {k: train[k] for k in ("steps", "seconds", "step_ms_median",
                                            "first_step_ms")},
            "final_loss": train["losses"][-1], "first_loss": train["losses"][0],
            "vectorize": {k: vec[k] for k in ("shape", "seconds", "items_per_s")},
            "self_rank1": self_rank1, "card_vs_cpu_encode_err": card_cpu_err,
            "serve": {"processed": processed, "loops": loops, "process_pending_s": process_s,
                      "served_vs_vectorize_err": served_err, "score_err": score_err,
                      "similarity_ms": sim_ms},
            "launches": dict(K.LAUNCHES)}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0], "allow_tf32": False}), flush=True)
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    K.load_library()
    print(json.dumps({"build": KERNEL_SOURCE, "seconds": time.perf_counter() - t0,
                      "nvcc_seconds": K.BUILD_INFO.get("seconds"),
                      "cached": K.BUILD_INFO.get("cached"),
                      "ptxas": [ln.strip() for ln in K.BUILD_INFO.get("ptxas", "").splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)

    _rows, kstats = kernel_phase(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        result = slice_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"phase": "slice", **result}), flush=True)

    kernels = [{"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": result["launches"][name],
                "max_abs_err": kstats["errs"][name],
                "ms": kstats["ms"][name][0], "plain_ms": kstats["ms"][name][1]}
               for name in K.LAUNCHES]
    check(all(k["launches"] > 0 for k in kernels), f"kernel not on the main path: {kernels}")
    check(not any(m.split(".")[0] in ("jax", "flax", "optax") for m in sys.modules),
          "the port pulled in JAX")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 — any failure is a failed smoke run
        traceback.print_exc()
        fail("uncaught exception")
