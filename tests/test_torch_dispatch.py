"""Kernel dispatch of the port, and that the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from recsys_tpu_torch.ops import contrastive as TC
from recsys_tpu_torch.ops import contrastive_kernel as TK
from recsys_tpu_torch.ops import select_infonce, select_logq_loss, use_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit(rng, B, D):
    x = torch.tensor(rng.normal(size=(B, D)), dtype=torch.float32)
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("mode,device,expected", [
    ("auto", "cpu", False), ("auto", "cuda", True),
    ("xla", "cpu", False), ("xla", "cuda", False),
    ("pallas", "cuda", True),
])
def test_use_kernel_modes(mode, device, expected):
    assert use_kernel(mode, device) is expected


def test_pallas_mode_on_cpu_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        use_kernel("pallas", "cpu")
    rng = np.random.default_rng(0)
    a, b = _unit(rng, 8, 4), _unit(rng, 8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        select_infonce("pallas")(a, b, 0.08)
    with pytest.raises(RuntimeError, match="CUDA"):
        select_logq_loss("pallas")(a, b, torch.arange(8), torch.zeros(8))
    with pytest.raises(ValueError):
        use_kernel("triton", "cpu")


def test_auto_on_cpu_takes_the_plain_form(monkeypatch):
    """On CPU tensors ``auto`` calls the plain loss and no kernel wrapper."""
    def boom(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")

    monkeypatch.setattr(TK, "fused_bidirectional_infonce", boom)
    monkeypatch.setattr(TK, "fused_inbatch_logq_loss", boom)
    rng = np.random.default_rng(1)
    a, b = _unit(rng, 16, 8), _unit(rng, 16, 8)
    got = select_infonce("auto")(a, b, 0.08)
    assert float(got) == float(TC.bidirectional_infonce(a, b, 0.08))
    pos, logq = torch.arange(1, 17), torch.full((17,), -2.0)
    got = select_logq_loss("auto")(a, b, pos, logq, temperature=0.1)
    assert float(got) == float(TC.inbatch_logq_loss(a, b, pos, logq, temperature=0.1))


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(4, 8)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TK.diag_ce_fwd_cuda(q, q, torch.zeros(4), ids, ids, ids, 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TK.diag_ce_bwd_dk_cuda(q, q, torch.zeros(4), ids, ids, ids,
                               torch.zeros(4), torch.zeros(4), 0.1)


def test_port_imports_no_jax_in_a_fresh_interpreter():
    """Every module of recsys_tpu_torch imports with jax/flax/optax blocked,
    and none of them is in sys.modules afterwards."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax")
for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import recsys_tpu_torch
for info in pkgutil.walk_packages(recsys_tpu_torch.__path__, "recsys_tpu_torch."):
    importlib.import_module(info.name)
for name in ("recsys_tpu_torch.pipeline.cli", "recsys_tpu_torch.serve.app",
             "recsys_tpu_torch.serve.server", "recsys_tpu_torch.train.simcse"):
    assert name in sys.modules, name
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
