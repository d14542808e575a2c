"""The port stands alone: it imports neither JAX nor anything of the JAX
package ``recsys_tpu``, at top level or inside a function."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("recsys_tpu", "jax", "jaxlib", "flax", "optax")
PORT_FILES = sorted((REPO / "recsys_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_quality_hm.py",
    REPO / "scripts" / "torch_init_spread.py"]


def _imported_roots(path: Path) -> set[str]:
    """Top-level package of every import statement in the file, wherever it
    stands (module level, function body, ``try`` block)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_file_list_is_complete():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for expected in ("recsys_tpu_torch/config.py", "recsys_tpu_torch/data/etl.py",
                     "recsys_tpu_torch/serve/ann.py", "recsys_tpu_torch/ops/spmm.py",
                     "recsys_tpu_torch/train/gnn.py", "recsys_tpu_torch/pipeline/cli.py",
                     "recsys_tpu_torch/models/user_tower.py",
                     "recsys_tpu_torch/train/sasrec.py", "recsys_tpu_torch/eval/baselines.py",
                     "recsys_tpu_torch/ops/quant.py", "recsys_tpu_torch/ops/ivf.py",
                     "recsys_tpu_torch/ops/topk.py", "recsys_tpu_torch/ops/approx_topk.py",
                     "recsys_tpu_torch/serve/train_glue.py",
                     "recsys_tpu_torch/data/text_pretrain.py",
                     "recsys_tpu_torch/data/ingest.py", "recsys_tpu_torch/data/hm_adapter.py",
                     "recsys_tpu_torch/data/analysis.py", "recsys_tpu_torch/eval/viz.py",
                     "recsys_tpu_torch/entry.py", "chip_smoke.py",
                     "scripts/torch_quality_hm.py", "scripts/torch_init_spread.py"):
        assert expected in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_file_imports_nothing_of_jax_or_the_jax_package(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_runs_where_the_jax_package_cannot_be_imported(tmp_path):
    """Every module of the port imports, and the CLI's gen-data and etl
    stages run, in a process whose import system refuses jax, flax, optax and
    recsys_tpu."""
    code = r"""
import importlib, json, pkgutil, sys
BLOCKED = %r
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
from recsys_tpu_torch.pipeline import cli
sets = ["--set", "data.root=" + sys.argv[1], "--set", "data.num_items=60",
        "--set", "data.num_users=30", "--set", "data.days=30", "--device", "cpu"]
gen = cli.main(["gen-data", *sets])
etl = cli.main(["etl", *sets])
assert gen["items"] == 60 and etl["sanity"]["target_users"] > 0, (gen, etl)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
""" % (FORBIDDEN,)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "world")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "world" / "features_sequence.parquet").exists()
