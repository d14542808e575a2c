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


# -- propagation dispatch of the GNN trainer ------------------------------------

def _tiny_graph():
    from recsys_tpu_torch.ops.graph import build_graph

    rng = np.random.default_rng(0)
    return build_graph(rng.integers(0, 30, 200), rng.integers(0, 20, 200), 30, 20,
                       svd_rank=2, pad_multiple=64)


@pytest.mark.parametrize("mode", ["auto", "segment_sum"])
def test_select_propagation_takes_the_plain_form_on_the_cpu(mode, monkeypatch):
    """``auto`` on the CPU and ``segment_sum`` are ``ops/graph.propagate`` over
    the COO arrays; no CSR layout is built and no kernel wrapper is reached."""
    from recsys_tpu_torch.config import GNNConfig
    from recsys_tpu_torch.ops import spmm as S
    from recsys_tpu_torch.ops.graph import propagate
    from recsys_tpu_torch.train import gnn as G

    def boom(*a, **k):
        raise AssertionError("kernel path taken on the CPU")

    monkeypatch.setattr(G, "csr_graph", boom)
    monkeypatch.setattr(S, "spmm_cuda", boom)
    graph = _tiny_graph()
    prop_fn, args = G.select_propagation(GNNConfig(propagation=mode), graph,
                                         graph.num_nodes, "cpu")
    assert isinstance(args, tuple) and len(args) == 3 and args[0].device.type == "cpu"
    x = torch.randn(graph.num_nodes, 8)
    assert torch.equal(prop_fn(args, x), propagate(x, *args, graph.num_nodes))


def test_select_propagation_spmm_mode_uses_the_plain_version_on_cpu_tensors():
    """Its ``LAUNCHES`` check replaces the earlier one, which also named the
    separate hub kernel that the segment kernel's launch has absorbed."""
    from recsys_tpu_torch.config import GNNConfig
    from recsys_tpu_torch.ops import spmm as S
    from recsys_tpu_torch.train import gnn as G

    graph = _tiny_graph()
    prop_fn, layout = G.select_propagation(GNNConfig(propagation="spmm"), graph,
                                           graph.num_nodes, "cpu")
    # the trainer's mode is the JAX trainer's: spmm in "bf16"
    assert isinstance(layout, S.CsrGraph) and prop_fn is G.spmm_bf16
    x = torch.randn(graph.num_nodes, 8)
    S.reset_launch_counts()
    assert torch.equal(prop_fn(layout, x), S.spmm_plain(layout, x, "bf16"))
    assert torch.equal(prop_fn(layout, x), S.spmm_plain(layout, x.bfloat16().float()))
    assert not torch.equal(prop_fn(layout, x), S.spmm_plain(layout, x))
    assert S.LAUNCHES == {"spmm_csr": 0}   # one kernel; the hub pass has no launch of its own


def test_select_propagation_refuses_what_is_not_ported():
    from recsys_tpu_torch.config import GNNConfig
    from recsys_tpu_torch.train import gnn as G

    graph = _tiny_graph()
    # the edge-sharded form is ported: it wants a mesh, as the JAX function does
    with pytest.raises(ValueError, match="needs a mesh"):
        G.select_propagation(GNNConfig(propagation="segment_sum_sharded"), graph,
                             graph.num_nodes, "cpu")
    with pytest.raises(ValueError, match="unknown"):
        G.select_propagation(GNNConfig(propagation="pallas"), graph, graph.num_nodes, "cpu")


@pytest.mark.parametrize("stage", ["train-gnn", "distill", "gnn-eval"])
def test_gnn_stages_refuse_device_cuda_without_a_card(stage, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from recsys_tpu_torch.pipeline import cli

    assert cli.parse_args([stage]).device == "cuda"      # the default is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([stage, "--set", f"data.root={tmp_path}", "--device", "cuda"])


@pytest.mark.parametrize("entry", [
    "select_propagation", "final_embeddings", "export_gnn_artifacts",
    "gnn_propagation_check", "train_lightgcl", "train_distill",
    "topk_rows", "standalone_rows", "distill_fidelity", "topk_items",
    "csr_graph", "build_model", "build_mesh", "dryrun_multichip"])
def test_entry_points_take_the_card_by_default_and_raise_without_one(entry, tmp_path):
    """With no ``device`` given an entry point of the GNN slice runs on the
    card; without one it raises before any work and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from recsys_tpu_torch.config import Config, GNNConfig, MeshConfig
    from recsys_tpu_torch.dryrun import dryrun_multichip
    from recsys_tpu_torch.eval import gnn_eval as E
    from recsys_tpu_torch.models.lightgcl import LightGCL
    from recsys_tpu_torch.ops import spmm as S
    from recsys_tpu_torch.parallel.mesh import build_mesh
    from recsys_tpu_torch.train import gnn as G
    from recsys_tpu_torch.train import simcse

    graph = _tiny_graph()
    model = LightGCL(graph.num_users, graph.num_items, GNNConfig(emb_dim=8, svd_rank=2))
    u = np.random.default_rng(1).normal(size=(30, 8)).astype(np.float32)
    i = np.random.default_rng(2).normal(size=(20, 8)).astype(np.float32)
    edges = (np.zeros(4, np.int64), np.arange(4))
    calls = {
        "select_propagation": lambda: G.select_propagation(GNNConfig(), graph, graph.num_nodes),
        "final_embeddings": lambda: G.final_embeddings(model, graph),
        "export_gnn_artifacts": lambda: G.export_gnn_artifacts(
            model, graph, list(range(30)), list(range(20)), str(tmp_path / "gnn")),
        "gnn_propagation_check": lambda: G.gnn_propagation_check(model, graph),
        "train_lightgcl": lambda: G.train_lightgcl(Config(), graph, *edges, str(tmp_path)),
        "train_distill": lambda: G.train_distill(Config(), u, i, str(tmp_path)),
        "topk_rows": lambda: E.topk_rows(u, i, 5, normalize=False),
        "standalone_rows": lambda: E.standalone_rows(
            u, [str(k) for k in range(30)], i, [str(k) for k in range(20)], {"0": ["1"]}),
        "distill_fidelity": lambda: E.distill_fidelity(u, i, i, u, k=5),
        "topk_items": lambda: simcse.topk_items(i, u, k=3),
        "csr_graph": lambda: S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes),
        "build_model": lambda: simcse.build_model(Config(), 50, 6),
        "build_mesh": lambda: build_mesh(MeshConfig(num_model=1)),
        "dryrun_multichip": lambda: dryrun_multichip(8),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not list(tmp_path.iterdir())                  # nothing was written


def test_spmm_wrapper_refuses_cpu_tensors_and_a_layout_elsewhere():
    from recsys_tpu_torch.ops import spmm as S

    graph = _tiny_graph()
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        S.spmm_cuda(layout, torch.zeros(graph.num_nodes, 64))
    with pytest.raises(ValueError, match="layout on"):
        S.spmm(layout, torch.zeros(graph.num_nodes, 64, device="meta"))


# -- the sharded path ---------------------------------------------------------------

def test_ring_wrapper_takes_the_plain_form_only_for_cpu_shards(monkeypatch):
    """CPU shards run the plain hop loop and launch nothing; shards anywhere
    else go to the kernel's wrapper, which launches or raises; it never takes
    the plain form for them."""
    from recsys_tpu_torch.parallel import ring as R

    shards = [torch.full((2, 3), float(r)) for r in range(3)]
    R.reset_launch_counts()
    out = R.ring_all_gather(shards, bidirectional=True)
    assert torch.equal(out[2], torch.cat(shards)) and R.LAUNCHES == {"ring_uni": 0,
                                                                     "ring_bidi": 0}
    with pytest.raises(RuntimeError, match="CUDA"):
        R.ring_all_gather_cuda(shards)

    def boom(*a, **k):
        raise AssertionError("plain form taken for shards that are not on the CPU")

    monkeypatch.setattr(R, "ring_all_gather_plain", boom)
    meta = [s.to("meta") for s in shards]
    with pytest.raises(RuntimeError, match="CUDA"):
        R.ring_all_gather(meta)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.ring_sharded_topk(meta, 2)
    assert R.LAUNCHES == {"ring_uni": 0, "ring_bidi": 0}


def test_ring_blocks_per_rank_keeps_the_grid_resident():
    """A block spins on its neighbour's block, so the whole grid has to fit on
    the card at once: S ranks x directions x blocks never exceeds what the
    card holds, and a ring that cannot get one block a rank raises."""
    from recsys_tpu_torch.parallel.ring import MAX_BLOCKS, MIN_SLICE_BYTES, blocks_per_rank

    chunk = 768 * 1000 * 4
    for S in (2, 3, 4, 8, 32):
        for directions in (1, 2):
            blocks = blocks_per_rank(chunk, S, directions, resident_blocks=264)
            assert 1 <= blocks <= MAX_BLOCKS and S * directions * blocks <= 264
    assert blocks_per_rank(chunk, 8, 1, 264) == 33 and blocks_per_rank(chunk, 2, 1, 264) == 64
    assert blocks_per_rank(7 * 33 * 4, 8, 2, 264) == 1          # a small chunk: one block
    assert blocks_per_rank(3 * MIN_SLICE_BYTES, 2, 1, 264) == 3
    with pytest.raises(RuntimeError, match="resident at once"):
        blocks_per_rank(chunk, 32, 2, resident_blocks=48)


def test_cli_mesh_needs_the_cards_or_virtual_shards(tmp_path):
    """A mesh larger than the devices there are raises; ``--virtual-shards``
    lays it over them and changes nothing else. The default device is the card."""
    from recsys_tpu_torch.pipeline import cli

    sets = ["--set", f"data.root={tmp_path}", "--set", "mesh.num_data=4",
            "--set", "mesh.num_model=2"]
    args = cli.parse_args(["train-item", *sets, "--device", "cpu"])
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        cli._mesh(cli.config_from_args(args), args)
    data_only = cli.parse_args(["train-item", "--set", "mesh.num_data=4", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 4 devices, 1 given"):
        cli._mesh(cli.config_from_args(data_only), data_only)
    args = cli.parse_args(["train-item", *sets, "--device", "cpu", "--virtual-shards"])
    mesh = cli._mesh(cli.config_from_args(args), args)
    assert mesh.shape == {"data": 4, "model": 2}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    args = cli.parse_args(["vectorize", "--device", "cpu"])         # the default: 1 x 1
    assert cli._mesh(cli.config_from_args(args), args).shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        args = cli.parse_args(["train-item", *sets, "--virtual-shards"])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli._mesh(cli.config_from_args(args), args)


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
