"""`scripts/verify_torch.sh`, the port's verification script, checked without
running its arms: it parses (`bash -n`), every `python -m` in it names an
importable `repro_torch` module, it names no module of the JAX package, and
it refuses a device other than `cpu` or `cuda` before it runs anything."""
from __future__ import annotations

import importlib.util
import re
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "verify_torch.sh"
TEXT = SCRIPT.read_text()
MODULES = sorted(set(re.findall(r"python -m ([\w.]+)", TEXT)) - {"pytest"})


def test_the_script_parses():
    subprocess.run(["bash", "-n", str(SCRIPT)], check=True)


def test_it_runs_the_port_only():
    assert len(MODULES) >= 6
    assert all(m.startswith("repro_torch.") for m in MODULES), MODULES
    assert not re.search(r"\brepro\.", TEXT.replace("repro_torch.", "")), "names a module of the JAX package"
    assert "scripts/verify.sh" not in re.findall(r"^\s*(?:bash|source|\.)\s+(\S+)", TEXT, flags=re.M)
    assert TEXT.rstrip().endswith('echo "VERIFY TORCH OK"')


@pytest.mark.parametrize("module", MODULES)
def test_every_python_m_names_an_importable_port_module(module):
    assert importlib.util.find_spec(module) is not None, module


@pytest.mark.parametrize("device", ["gpu", "tpu", "cuda:0"])
def test_it_refuses_a_device_other_than_cpu_or_cuda(device):
    done = subprocess.run(["bash", str(SCRIPT), device], capture_output=True, text=True, timeout=60)
    assert done.returncode == 2 and "usage:" in done.stderr and done.stdout == ""
