"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points refuse to fall back to the CPU when CUDA is
asked for, and its kernel modules import (and run their plain versions)
without triton or nvcc."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, tp_sweep

pytestmark = pytest.mark.fast

ROOT = Path(__file__).resolve().parents[1]


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_jax_and_no_reference_package_imported():
    code = """
import importlib, pkgutil, sys
import gfdl_atmos_cubed_sphere_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "gfdl_atmos_cubed_sphere_tpu"
             or m.startswith("gfdl_atmos_cubed_sphere_tpu."))
print("BAD", bad)
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_port_sources_name_no_jax():
    pkg = ROOT / "gfdl_atmos_cubed_sphere_tpu_torch"
    for path in list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s.split("#")[0], (path, s)
                assert "gfdl_atmos_cubed_sphere_tpu." not in s and \
                    not s.startswith("from gfdl_atmos_cubed_sphere_tpu "), \
                    (path, s)


def test_build_grid_ops_defaults_to_cuda_and_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_grid_ops(13)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_grid_ops(13, dtype=torch.float64, device="cuda")


def test_kernel_modules_import_without_triton_or_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), NVCC=str(tmp_path / "none"))
    code = """
import sys
sys.modules["triton"] = None            # any import of triton fails
from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build, a2b, ke, tp_sweep
import torch
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
g = build_grid_ops(13, dtype=torch.float64, device="cpu")
a2b.a2b_ord4(torch.zeros(6, 1, 18, 18, dtype=torch.float64), g)
try:
    _build.nvcc_path()
    print("NVCC FOUND")
except RuntimeError:
    pass
print("LIBS", _build._libs, a2b.launches, ke.launches, tp_sweep.launches)
"""
    r = _python(code, env=env)
    assert r.returncode == 0, r.stderr
    assert "NVCC FOUND" not in r.stdout
    assert "LIBS {} 0 0 0" in r.stdout, r.stdout


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    g = build_grid_ops(13, dtype=torch.float64, device="cpu")
    q = torch.zeros(6, 1, 18, 18, dtype=torch.float64)
    with pytest.raises(ValueError):
        a2b._launch(q, g)                   # a CPU tensor: no launch
    with pytest.raises(ValueError, match="hord"):
        tp_sweep._launch(q, None, None, 14, None, None, None, None, None,
                         None, None, None, None)
    assert a2b.launches == 0 and tp_sweep.launches == 0
    assert np.isfinite(a2b.a2b_ord4_ref(q + 1.0, g).numpy()).all()
