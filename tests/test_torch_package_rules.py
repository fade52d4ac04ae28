"""Rules the port keeps as a package: it imports `torch`, never `jax`, and
nothing of `repro`; entry points default to the CUDA device and raise without
one; a CPU tensor takes the plain version of a kernel and launches nothing."""
import ast
import math
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.device import probe, resolve_backend, resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_walk_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/graph/vertex_program.py", "src/repro_torch/kernels/segment_spmm/kernel.py",
                 "src/repro_torch/experiments/sweep.py", "src/repro_torch/interop.py", "chip_smoke.py",
                 "src/repro_torch/configs/base.py", "src/repro_torch/configs/llama3_2_3b.py",
                 "src/repro_torch/configs/registry.py", "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/transformer.py", "src/repro_torch/kernels/flash_attention/ref.py",
                 "src/repro_torch/kernels/flash_attention/kernel.py", "src/repro_torch/kernels/flash_attention/ops.py",
                 "src/repro_torch/serve/engine.py", "src/repro_torch/launch/serve.py",
                 "src/repro_torch/kernels/embedding_bag/ref.py", "src/repro_torch/kernels/embedding_bag/kernel.py",
                 "src/repro_torch/kernels/embedding_bag/ops.py", "src/repro_torch/models/recsys.py",
                 "src/repro_torch/configs/dcn_v2.py", "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/train/optim.py", "src/repro_torch/train/checkpoint.py",
                 "src/repro_torch/train/loop.py", "src/repro_torch/train/pytree.py",
                 "src/repro_torch/launch/train.py", "src/repro_torch/nocsim/model.py",
                 "src/repro_torch/nocsim/batch.py", "src/repro_torch/nocsim/credit.py",
                 "src/repro_torch/faults/degraded.py", "src/repro_torch/obs/recorder.py",
                 "src/repro_torch/experiments/journal.py", "src/repro_torch/experiments/resilience.py",
                 "src/repro_torch/experiments/run.py", "src/repro_torch/experiments/report.py",
                 "src/repro_torch/models/gnn.py", "src/repro_torch/graph/sampler.py",
                 "src/repro_torch/configs/gin_tu.py", "src/repro_torch/configs/gat_cora.py",
                 "src/repro_torch/configs/pna.py", "src/repro_torch/configs/graphcast.py",
                 "tools/gnn_full_scale.py", "tools/gnn_reduce_hub.py", "tools/lm_train_step.py",
                 "src/repro_torch/graph/distributed.py", "src/repro_torch/graph/halo.py",
                 "src/repro_torch/models/gnn_dist.py"):
        assert must in names
    for cu in ("ell_spmm.cu", "flash_attention.cu", "flash_attention_bwd.cu", "embedding_bag.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / cu).is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('clean')\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert done.returncode == 0 and "clean" in done.stdout, done.stderr


def test_kernel_sources_include_no_torch_header():
    for cu in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"):
        text = cu.read_text()
        assert "torch/" not in text and "ATen" not in text, cu.name
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_resolve_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_resolve_backend_rule():
    assert resolve_backend("auto") == "torch"  # whatever the problem size
    assert resolve_backend("torch") == "torch" and resolve_backend("numpy") == "numpy"
    with pytest.raises(ValueError):
        resolve_backend("jax")
    assert repro_torch.resolve_backend is resolve_backend


def test_probe_reports_the_toolchain():
    info = probe()
    assert info["torch"] == torch.__version__
    assert info["cuda_available"] == torch.cuda.is_available()
    for key in ("device_name", "capability", "nvcc_on_path", "nvcc_release", "nvidia_smi", "device_count"):
        assert key in info
    if not info["cuda_available"]:
        assert info["device_name"] is None and info["device_count"] == 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.experiments.placement_batch import batch_descend, greedy_construct_batch
    from repro_torch.core.noc import Mesh2D
    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.structs import build_ell, to_device_edges
    from repro_torch.graph.vertex_program import run, run_traced
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import build_engine
    from repro_torch.data.pipeline import RecsysPipeline, to_device
    from repro_torch.launch.train import train
    from repro_torch.models import recsys as rec
    from repro_torch.models import transformer as tfm
    from repro_torch.core.placement import Placement
    from repro_torch.core.traffic import TrafficMatrix
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.experiments.resilience import run_resilience
    from repro_torch.experiments.run import main as run_main
    from repro_torch.faults import FaultSet, degraded_batch
    from repro_torch.nocsim import NocSimParams, build_credit_program, contended_batch, run_credit
    from repro_torch.nocsim.batch import _open_step_torch, open_step
    from repro_torch.nocsim.model import build_schedule, simulate_contended
    from repro_torch.data.pipeline import GraphBatcher
    from repro_torch.models import gnn
    from repro_torch.core.partition import powerlaw_partition
    from repro_torch.graph.distributed import DistributedEngine, EngineMesh, make_engines_mesh
    from repro_torch.graph.halo import build_halo_plan
    from repro_torch.models.gnn_dist import gin_forward_halo, pack_batch, shard_batch
    import numpy as np

    g = rmat(64, 256, seed=0)
    w = np.ones((4, 4))
    cfg = get_arch("llama3.2-3b").smoke_config()
    params = tfm.init_params(cfg, device="cpu")
    tm = TrafficMatrix(num_parts=1, bytes_matrix=np.ones((4, 4)) - np.eye(4), phase_bytes={})
    pl = Placement(Mesh2D(2, 2), np.arange(4), "test")
    noc = NocSimParams(windows=4, buffer_depth=2.0)
    prog = build_credit_program([build_schedule(tm, pl, noc_params=noc)], noc)
    # the open stepper runs where its input tensors lie; "auto" picks the torch one
    assert open_step() is open_step("auto") is open_step("torch") is _open_step_torch
    with pytest.raises(ValueError, match="unknown backend"):
        open_step("jax")
    # plans and packed batches stay host numpy; a mesh made for the card sends the entry points there
    card_mesh = EngineMesh(2, torch.device("cuda"))
    plan = build_halo_plan(g.src, g.dst, 64, 2)
    packed = pack_batch(plan, np.ones((64, 4), np.float32), np.zeros(64, np.int32), np.ones(64, bool))
    cpu_batch = shard_batch(packed, make_engines_mesh(num_engines=2, device="cpu"))
    gin_cfg = get_arch("gin-tu").smoke_config()
    gin_params = gnn.init_params(gin_cfg, device="cpu")
    calls = [
        lambda: run(g, alg.bfs_program()),
        lambda: run_traced(g, alg.bfs_program()),
        lambda: to_device_edges(g),
        lambda: build_ell(g),
        lambda: greedy_construct_batch([w], [Mesh2D(2, 2)]),
        lambda: batch_descend([w], [Mesh2D(2, 2)], [np.arange(4)]),
        lambda: tfm.init_params(cfg),
        lambda: tfm.init_kv_cache(cfg, 2, 16),
        lambda: build_engine(cfg, params, slots=2, max_seq=16),
        lambda: rec.init_params(get_arch("dcn-v2").smoke_config()),
        lambda: train("dcn-v2", smoke=True, steps=1),
        lambda: to_device(next(iter(RecsysPipeline(2, 3, 10, 4)))),
        lambda: contended_batch([tm], [pl], backend="torch"),
        lambda: contended_batch([tm], [pl]),  # "auto" is the torch arm
        lambda: degraded_batch([tm], [pl], [FaultSet()], backend="torch"),
        lambda: run_credit(prog, backend="torch"),
        lambda: run_credit(prog, backend="auto"),
        lambda: simulate_contended(tm, pl, noc_params=noc, backend="torch"),
        lambda: run_resilience(GRIDS["minifaults"]),
        lambda: run_resilience(GRIDS["minifaults"], backend="numpy"),
        lambda: run_main(["--grid", "mini", "-q"]),
        lambda: run_main(["--grid", "minifaults", "--backend", "numpy", "-q"]),
        lambda: gnn.init_params(get_arch("gin-tu").smoke_config()),
        lambda: gnn.batch_ell(GraphBatcher(g, d_feat=4, n_classes=2).full_batch()),
        lambda: make_engines_mesh(),
        lambda: make_engines_mesh(num_engines=4),
        lambda: DistributedEngine(alg.bfs_program(), card_mesh).run(g, powerlaw_partition(g.src, g.dst, 64, 2)),
        lambda: shard_batch(packed, card_mesh),
        lambda: gin_forward_halo(gin_params, cpu_batch, gin_cfg, card_mesh),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_gnn_training_waits_for_the_reduce_backward():
    """The GNN archs are ported (none is pending) and train: gin-tu, gat-cora
    and pna for a step on the host (GIN's sum through the ELL reduce, whose
    backward is the reduce over the transposed ELL), from `train` and from
    the CLI; graphcast is refused with the reference's message."""
    from repro_torch.configs.registry import PENDING, arch_ids
    from repro_torch.launch.train import GRAPHCAST_REFUSAL, main, train

    assert sorted(arch_ids("gnn")) == ["gat-cora", "gin-tu", "graphcast", "pna"]
    assert not {"gin-tu", "gat-cora", "pna", "graphcast"} & set(PENDING)
    assert not PENDING  # the MoE archs were the last pending ones
    assert {"qwen2-moe-a2.7b", "olmoe-1b-7b"} <= set(arch_ids("lm"))
    for arch in ("gin-tu", "gat-cora", "pna"):
        seen = []
        state = train(arch, smoke=True, steps=1, device="cpu", log_fn=lambda _: None,
                      on_step=lambda st, m, b: seen.append(float(m["loss"])))
        assert state.step == 1 and len(seen) == 1 and math.isfinite(seen[0])
        if arch == "gin-tu":
            assert _gnn_batch_has_transpose(arch)
    with pytest.raises(SystemExit, match="graphcast_regression"):
        train("graphcast", smoke=True, steps=1, device="cpu")
    assert GRAPHCAST_REFUSAL == "use examples/graphcast_regression.py for graphcast training"
    main(["--arch", "gin-tu", "--smoke", "--device", "cpu", "--steps", "1"])


def _gnn_batch_has_transpose(arch):
    """The batch `launch.train` builds for `arch` carries the ELL and its transpose."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import _gnn_setup

    *_, batches = _gnn_setup(get_arch(arch), smoke=True, seed=0, device=torch.device("cpu"))
    ell = next(iter(batches))["ell"]
    return ell.transpose is not None and ell.transpose.num_nodes == ell.num_nodes


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.structs import build_ell
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    assert isinstance(ell_spmm.launches, int)
    before = ell_spmm.launches
    g = rmat(80, 500, seed=0)
    out = segment_spmm(torch.ones((80, 1)), build_ell(g.reversed(), device="cpu"))
    assert out.shape == (80, 1) and ell_spmm.launches == before
    assert float(out.sum()) == g.num_edges  # all-ones x, unweighted: in-degrees

    from repro_torch.kernels.flash_attention.ops import flash_attention

    assert isinstance(flash_attention.launches, int)
    before = flash_attention.launches
    q = torch.ones((1, 5, 4, 32))
    out = flash_attention(q, torch.ones((1, 5, 2, 32)), torch.ones((1, 5, 2, 32)))
    assert out.shape == q.shape and flash_attention.launches == before

    from repro_torch.kernels.embedding_bag.ops import embedding_bag

    assert isinstance(embedding_bag.launches, int)
    before = embedding_bag.launches
    tables = torch.ones((3, 10, 16), requires_grad=True)
    out = embedding_bag(tables, torch.tensor([[[1, -1], [2, 10], [0, 0]]], dtype=torch.int32))
    out.sum().backward()  # the plain route, through the autograd.Function
    assert out.shape == (1, 3, 16) and embedding_bag.launches == before
    assert out[0, :, 0].tolist() == [1.0, 1.0, 2.0]  # padding ids add 0
    assert float(tables.grad.sum()) == 4 * 16


def test_kernels_without_a_backward_refuse_grad_before_anything_else():
    """`ell_spmm` (one bucket) on the CUDA route would silently detach its
    output from the graph: with grad on and an input that requires it, it
    raises before the device check — so this runs on the CPU.  Attention and
    the whole reduce have a backward now: with grad on, `flash_attention`
    (impl "auto") on a CPU tensor goes through its autograd Function's plain
    route, and impl "cuda" refuses a CPU tensor as it does without grad."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.segment_spmm.ops import ell_spmm

    q = torch.ones((1, 4, 2, 32), requires_grad=True)
    kv = torch.ones((1, 4, 2, 32))
    x = torch.ones((6, 16), requires_grad=True)
    cols = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(NotImplementedError, match="impl='ref'"):
        ell_spmm(x, cols, impl="cuda")
    with pytest.raises(NotImplementedError, match="no backward"):
        ell_spmm(x.detach(), cols, torch.ones((3, 2), requires_grad=True), impl="cuda")
    with torch.no_grad():  # no grad: the device check speaks
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q, kv, kv, impl="cuda")
        with pytest.raises(ValueError, match="CUDA"):
            ell_spmm(x, cols, impl="cuda")
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(q, kv, kv)
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and (flash_attention.launches, flash_attention_bwd.launches) == before
    assert flash_attention(q, kv, kv, impl="ref").requires_grad
    assert ell_spmm(x, cols, impl="ref").requires_grad


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True)
    assert done.returncode != 0 and '"ok"' not in done.stdout
