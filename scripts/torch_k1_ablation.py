"""K1's forward at B = 3072 and 8192 with parts of its work taken out, to see
which parts of a tile's time overlap.

    python3 scripts/torch_k1_ablation.py

Needs one NVIDIA GPU and nvcc. Writes two variants of
``recsys_tpu_torch/csrc/diag_ce.cu`` into its build directory (gitignored):
``noload`` loads no tile after a range's first two, ``nosoftmax`` drops the
forward's mask and online softmax. Both give wrong values: they are timed,
not checked. Each version runs in a process of its own, in turns (full,
noload, nosoftmax, full), and prints one JSON line with the forward's device
time (``torch.profiler``) at B = 3072 and 8192, D = 128; the first line
names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "recsys_tpu_torch", "csrc", "diag_ce.cu")
OUT_DIR = os.path.join(ROOT, "recsys_tpu_torch", "csrc", "build", "ablation")

LOAD = """      if (tt + 1 < t_last) {  // the next tile into the other stage
        float* nx = stages + (st ^ 1) * 2 * kPlane;"""
SOFTMAX_START = "      // on the accumulators: the masked logit of each entry, online softmax"
SOFTMAX_END = "      __syncthreads();  // the stage is consumed"


def variants() -> dict[str, str]:
    src = open(SOURCE).read()
    if LOAD not in src or SOFTMAX_START not in src or SOFTMAX_END not in src:
        sys.exit("torch_k1_ablation: the forward's source no longer has the cut points")
    noload = src.replace(LOAD, LOAD.replace("tt + 1 < t_last", "tt + 1 < t_last && tt == t_first"))
    i0 = src.index(SOFTMAX_START)
    i1 = src.index(SOFTMAX_END, i0)
    # keep a use of the products, so that the compiler keeps them
    nosoftmax = src[:i0] + "      diag[0] += acc[0][0] + acc[3][3];\n" + src[i1:]
    return {"full": src, "noload": noload, "nosoftmax": nosoftmax}


def time_one(name: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from pathlib import Path

    from recsys_tpu_torch.ops import contrastive_kernel as K
    from torch_kernel_bench import device_ms

    if not torch.cuda.is_available():
        sys.exit("torch_k1_ablation: needs a CUDA device")
    K.LIBRARY.source = Path(OUT_DIR, f"diag_ce_{name}.cu")
    row = {"variant": name}
    for B in (3072, 8192):
        rng = np.random.default_rng(B)
        q, k = (torch.as_tensor(rng.normal(size=(B, 128)).astype(np.float32), device="cuda")
                for _ in range(2))
        q, k = q / q.norm(dim=1, keepdim=True), k / k.norm(dim=1, keepdim=True)
        ids = torch.arange(B, dtype=torch.int32, device="cuda")
        corr, valid = torch.zeros(B, device="cuda"), torch.ones_like(ids)
        row[f"fwd_device_ms_B{B}"] = device_ms(
            lambda: K.diag_ce_fwd_cuda(q, k, corr, ids, ids, valid, 0.1), 50, "diag_ce")
    print(json.dumps(row), flush=True)


def main() -> None:
    if len(sys.argv) == 2:
        time_one(sys.argv[1])
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, text in variants().items():
        with open(os.path.join(OUT_DIR, f"diag_ce_{name}.cu"), "w") as f:
            f.write(text)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    for name in ("full", "noload", "nosoftmax", "full"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), name])
        if proc.returncode != 0:
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
