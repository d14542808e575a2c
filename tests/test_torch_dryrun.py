"""The port's multi-shard dry run on virtual shards laid over the CPU.

Counterpart of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``):
the same sharded steps on tiny shapes, the same printed line. The stage-2
step reports its loss with the dense lookup and, on a model axis > 1, with the
all-to-all lookup; the hybrid step (``HYBRID``) reports a finite loss, in the
line too.
"""

import math
import re

import pytest
import torch

from recsys_tpu_torch.dryrun import dryrun_multichip

HYBRID = ("hybrid",)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_devices,mesh", [(8, {"data": 4, "model": 2}),
                                            (2, {"data": 1, "model": 2}),
                                            (4, {"data": 2, "model": 2}),
                                            (1, {"data": 1, "model": 1})])
def test_dryrun_multichip_on_cpu_shards(n_devices, mesh, capsys):
    out = dryrun_multichip(n_devices, device="cpu")
    assert out["mesh"] == mesh
    for key in ("stage1", "gnn", "ckpt_resume", "stage2"):
        assert math.isfinite(out[key]) and out[key] > 0, (key, out[key])
    # the a2a step from the same state and draws: the dense step's loss
    assert (math.isnan(out["a2a"]) if mesh["model"] == 1
            else abs(out["a2a"] - out["stage2"]) < 1e-3 * max(1.0, out["stage2"]))
    batch = max(16, mesh["data"] * 4)
    assert out["topk"] == (batch, 10) and out["blend_topk"] == (batch, 10)
    assert all(math.isfinite(out[key]) and out[key] > 0 for key in HYBRID)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip ok: mesh={mesh} ")
    # the JAX function's fields, in its order
    assert re.findall(r"(\w+)=", line.split("} ", 1)[1]) == [
        "stage2", "a2a", "stage1", "gnn", "hybrid", "topk", "ckpt_resume", "blend_topk"]
    assert all(f"{key}={out[key]:.4f}" in line for key in HYBRID)
    assert f"stage1={out['stage1']:.4f}" in line and f"gnn={out['gnn']:.4f}" in line
    assert f"stage2={out['stage2']:.4f}" in line and f"a2a={out['a2a']:.4f}" in line


def test_dryrun_module_runs_as_a_program():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-m", "recsys_tpu_torch.dryrun", "2", "--device", "cpu"],
                         cwd=repo, env={**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "2"},
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1].startswith(
        "dryrun_multichip ok: mesh={'data': 1, 'model': 2}")
