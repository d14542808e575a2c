"""The int8 approximate scan (``approx_scan_int8`` in
``recsys_tpu_torch/csrc/approx_topk.cu``) with parts of it taken out or
changed, to see where its time goes.

    python3 scripts/torch_approx_ablation.py [full,nomma,...]

Needs one NVIDIA GPU and nvcc. Writes variants of the source into its build
directory (gitignored): ``noturns`` lets the two consumer warpgroups start
their products as their tiles land instead of in turns; ``epi1`` bins one
score a thread out of 64 (the epilogue nearly gone); ``nomma`` runs no
``wgmma``; ``noload`` has the producer mark each stage full without loading
it (the queries still load); ``pipe`` is ``nomma`` and ``epi1`` together (the
loads, the barriers and the loop), ``pipe_noload``, ``epi1_noload`` and
``nomma_noload`` the same without the item loads; ``stages4`` keeps a ring
of 4 tiles, not 8; ``warp`` has a producer warp, not a warpgroup, and no
``setmaxnreg``. Only ``full``, ``noturns``, ``stages4`` and ``warp`` give
right bins, and only they are checked. Each version runs in a process of its
own, in turns (full, noturns, epi1, nomma, noload, pipe, pipe_noload,
epi1_noload, nomma_noload, stages4, warp, full, or the comma-separated list
given), and prints one JSON line: the scan's time in a loop (CUDA events)
at 1,000,000 items (k = 100, O = 2,048 bins, B = 1,024, D = 128,
``default_rng(0)`` int8 rows and alphas) and at 47,001 items (k = 50, 1,536
bins: the split slices), and where the bins are meant to be right, whether
they equal the plain form's bit for bit. The first line names the card and
its power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "recsys_tpu_torch", "csrc", "approx_topk.cu")
OUT_DIR = os.path.join(ROOT, "recsys_tpu_torch", "csrc", "build", "ablation")

TURNS = "  const bool turns = a.stages >= a.kc;\n"
EPILOGUE = "        for (int i = 0; i < 64; ++i) key[i] = max(key[i], acc[i] * mul + low);\n"
MMA = "wgmma_s8(acc, wgmma_desc(at + 32 * k), wgmma_desc(bt + 32 * k), (c | k) != 0);"
STAGES = "constexpr int kMaxStages = 8;"
THREADS = "constexpr int kThreads = kConsumers + 128;"
SETMAXNREG = ('asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));',
              'asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));')
FEED = "        mbar_expect_tx(full + st, stage_bytes);\n"
F32_EPILOGUE = "    if (kt != ktiles - 1) continue;\n"
F32_FETCH = "    if (s >= steps) return;\n"
F32_SYNC = "    __syncthreads();  // stage s landed for all; stage s - 1 is read by all\n"
F32_BK = "constexpr int kBK = 32; "
CHECKED = ("full", "noturns", "stages4", "warp")


def variants() -> dict[str, str]:
    src = open(SOURCE).read()
    if any(cut not in src for cut in (TURNS, EPILOGUE, MMA, STAGES, THREADS, FEED, F32_EPILOGUE,
                                      F32_FETCH, F32_SYNC, F32_BK, *SETMAXNREG)):
        sys.exit("torch_approx_ablation: the kernel's source no longer has the cut points")
    return {"full": src,
            "noturns": src.replace(TURNS, "  const bool turns = false;\n"),
            "epi1": src.replace(EPILOGUE, EPILOGUE.replace("for (int i = 0; i < 64; ++i) ",
                                                           "for (int i = 0; i < 1; ++i) ")),
            "nomma": src.replace(MMA, ";"),
            "noload": src.replace(FEED, "        mbar_arrive_if(full + st, true);\n"
                                        "        continue;\n"),
            "pipe": src.replace(MMA, ";").replace(EPILOGUE, EPILOGUE.replace(
                "for (int i = 0; i < 64; ++i) ", "for (int i = 0; i < 1; ++i) ")),
            "pipe_noload": src.replace(MMA, ";").replace(EPILOGUE, EPILOGUE.replace(
                "for (int i = 0; i < 64; ++i) ", "for (int i = 0; i < 1; ++i) "))
                              .replace(FEED, "        mbar_arrive_if(full + st, true);\n"
                                             "        continue;\n"),
            "epi1_noload": src.replace(EPILOGUE, EPILOGUE.replace(
                "for (int i = 0; i < 64; ++i) ", "for (int i = 0; i < 1; ++i) "))
                              .replace(FEED, "        mbar_arrive_if(full + st, true);\n"
                                             "        continue;\n"),
            "nomma_noload": src.replace(MMA, ";")
                               .replace(FEED, "        mbar_arrive_if(full + st, true);\n"
                                              "        continue;\n"),
            "stages4": src.replace(STAGES, "constexpr int kMaxStages = 4;"),
            "f32_full": src,
            "f32_noepi": src.replace(F32_EPILOGUE, "    continue;\n"),
            "f32_noload": src.replace(F32_FETCH, "    return;\n"),
            "f32_nosync": src.replace(F32_SYNC, ""),
            "f32_bk16": src.replace(F32_BK, "constexpr int kBK = 16; "),
            "warp": src.replace(THREADS, THREADS.replace("128", "32"))
                       .replace(SETMAXNREG[0], "").replace(SETMAXNREG[1], "")}


def time_one(name: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from pathlib import Path

    from recsys_tpu_torch.ops import approx_topk as A
    from torch_kernel_bench import cuda_ms

    if not torch.cuda.is_available():
        sys.exit("torch_approx_ablation: needs a CUDA device")
    A.LIBRARY.source = Path(OUT_DIR, f"approx_topk_{name}.cu")
    A.load_library()
    row = {"variant": name}
    rng = np.random.default_rng(0)
    if name.startswith("f32"):
        n, k = 1_000_001, 100
        u = torch.as_tensor(rng.normal(size=(1024, 128)).astype(np.float32), device="cuda")
        items = torch.as_tensor(rng.normal(size=(n, 128)).astype(np.float32), device="cuda")
        bins, red = A.approx_bins(n, k, 0.95)
        scan = lambda: A.approx_scan_f32_cuda(u, items, None, bins, red)  # noqa: E731
        row[f"ms_{n}"] = cuda_ms(scan, 20)
        if name in ("f32_full", "f32_bk16"):
            kv, kc = scan()
            pv, pc = A.approx_scan_f32_plain(u, items, None, bins, red)
            finite = torch.isfinite(pv)
            row["max_abs_err"] = float((kv[finite] - pv[finite]).abs().max())
            smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                                    "--format=csv,noheader,nounits", "-lms", "100"],
                                   stdout=subprocess.PIPE, text=True)
            cuda_ms(scan, 150)
            smi.terminate()
            samples = [line.split(",") for line in smi.communicate()[0].splitlines() if line]
            row["sm_mhz_watts_celsius_under_load"] = [[float(x) for x in v] for v in samples[-6:]]
        print(json.dumps(row), flush=True)
        return
    for n, k in ((1_000_001, 100), (47_001, 50)):
        uq = torch.as_tensor(rng.integers(-127, 128, (1024, 128)).astype(np.int8), device="cuda")
        q = torch.as_tensor(rng.integers(-127, 128, (n, 128)).astype(np.int8), device="cuda")
        alpha = torch.as_tensor(rng.random(1024).astype(np.float32), device="cuda") + 0.1
        bins, red = A.approx_bins(n, k, 0.95)
        scan = lambda: A.approx_scan_int8_cuda(uq, q, alpha, bins, red)  # noqa: E731
        row[f"ms_{n}"] = cuda_ms(scan, 50)
        if name in CHECKED:
            kv, kc = scan()
            pv, pc = A.approx_scan_int8_plain(uq, q, alpha, bins, red)
            row[f"bit_equal_{n}"] = bool(torch.equal(kv, pv) and torch.equal(kc, pc))
    print(json.dumps(row), flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        time_one(sys.argv[2])
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, text in variants().items():
        with open(os.path.join(OUT_DIR, f"approx_topk_{name}.cu"), "w") as f:
            f.write(text)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    names = sys.argv[1].split(",") if len(sys.argv) == 2 else (
        "full", "noturns", "epi1", "nomma", "noload", "pipe", "pipe_noload", "epi1_noload",
        "nomma_noload", "stages4", "warp", "full")
    for name in names:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name])
        if proc.returncode != 0:
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
