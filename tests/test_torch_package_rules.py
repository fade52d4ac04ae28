"""Rules the port keeps as a package: it imports `torch`, never `jax`, and
nothing of `repro`; entry points default to the CUDA device and raise without
one; a CPU tensor takes the plain version of a kernel and launches nothing."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.device import probe, resolve_backend, resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
                 "src/repro_torch/experiments/sweep.py", "src/repro_torch/interop.py", "chip_smoke.py"):
        assert must in names
    assert (ROOT / "src" / "repro_torch" / "csrc" / "ell_spmm.cu").is_file()


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
    import numpy as np

    g = rmat(64, 256, seed=0)
    w = np.ones((4, 4))
    calls = [
        lambda: run(g, alg.bfs_program()),
        lambda: run_traced(g, alg.bfs_program()),
        lambda: to_device_edges(g),
        lambda: build_ell(g),
        lambda: greedy_construct_batch([w], [Mesh2D(2, 2)]),
        lambda: batch_descend([w], [Mesh2D(2, 2)], [np.arange(4)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


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


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True)
    assert done.returncode != 0 and '"ok"' not in done.stdout
