"""waverange_tpu_torch as a package: no JAX and no `waverange_tpu` import,
no build at import, no implicit CPU device, and builders that raise
without nvcc or g++."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waverange_tpu_torch.core import codec as TC
from waverange_tpu_torch.native import build as host_build
from waverange_tpu_torch.ops import _build
from waverange_tpu_torch.ops import quant_cuda, rans_cuda, wavelet_cuda

REPO = Path(__file__).resolve().parent.parent

_NO_JAX = """
import sys
import numpy as np
import waverange_tpu_torch
from waverange_tpu_torch.core import codec
a = np.fromfunction(lambda k, j, i: np.sin(i / 3.0) * np.cos(j / 5.0) + k,
                    (9, 10, 11))
e = codec.encode_field(a, 1e-7, device="cpu")
r = codec.decode_field(e, device="cpu")
assert np.abs(r - a).max() <= 1.3e-7 * np.abs(a).max()
e = codec.encode_field(a, 1e-7, device="cpu", coder="rans", entropy="device")
r = codec.decode_field(e, device="cpu", entropy="device")
assert np.abs(r - a).max() <= 1.3e-7 * np.abs(a).max()
e = codec.encode_field(a, 1e-7, backend="exact64", device="cpu")
assert e.data == codec.encode_field(a, 1e-7, backend="native").data
import importlib, pkgutil
for m in pkgutil.walk_packages(waverange_tpu_torch.__path__,
                               "waverange_tpu_torch."):
    importlib.import_module(m.name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
frozen = sorted(m for m in sys.modules
                if m == "waverange_tpu" or m.startswith("waverange_tpu."))
assert not frozen, frozen
print("ok")
"""


def test_package_never_imports_jax_or_the_jax_package():
    # conftest imports JAX in this process, so the check runs in a new one
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [REPO / "chip_smoke.py", *(REPO / "waverange_tpu_torch").rglob("*.py")]))
def test_sources_import_neither_jax_nor_waverange_tpu(path):
    bad = {m for m in _imports(REPO / path)
           if m.split(".")[0] in ("jax", "jaxlib", "waverange_tpu")}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_host_builder_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_build, "lib_path",
                        lambda: tmp_path / "build" / "libwrnative-x.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        host_build.ensure_built()
    assert not (tmp_path / "build").exists()


def test_host_builder_raises_with_compiler_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'wr_native.cc:1: error: broken' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_build, "lib_path",
                        lambda: tmp_path / "build" / "libwrnative-x.so")
    with pytest.raises(RuntimeError, match="(?s)exit 3.*error: broken"):
        host_build.ensure_built()
    assert not list((tmp_path / "build").iterdir())


def test_host_build_is_keyed_by_the_cpu(monkeypatch):
    here = host_build.lib_path()
    monkeypatch.setattr(host_build, "_cpu_identity",
                        lambda: b"model name : another cpu")
    assert host_build.lib_path() != here
    assert host_build.lib_path().parent == host_build.BUILD_DIR


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.ensure_built()
    assert not (tmp_path / "build").exists()


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.encode_field(a, 1e-6)
    e = TC.encode_field(a, 1e-6, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.decode_field(e)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wavelet_cuda.lift_fwd_axis(x, (4, 4, 4), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wavelet_cuda.lift_inv_axis(x, (4, 4, 4), 2)
    flat = x.view(-1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant_cuda.quant_layer(flat, torch.zeros(64, dtype=torch.uint8),
                               torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant_cuda.accumulate(torch.zeros((1, 64), dtype=torch.uint8),
                              torch.ones(1, dtype=torch.float64),
                              torch.zeros(1, dtype=torch.float64))


@pytest.mark.parametrize("call", [
    lambda: rans_cuda.rans_hist(torch.zeros((1, 9), dtype=torch.uint8), 9),
    lambda: rans_cuda.rans_chain(torch.zeros((1, 9), dtype=torch.uint8), 9,
                                 torch.zeros((1, 256), dtype=torch.int32)),
    lambda: rans_cuda.rans_compact(
        torch.zeros((1, 8), dtype=torch.int32),
        torch.zeros((1, 1 << 15), dtype=torch.int16),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int64),
        16),
    lambda: rans_cuda.rans_decode(torch.zeros(8, dtype=torch.uint8),
                                  torch.zeros((1, 3), dtype=torch.int64), 1,
                                  9),
    lambda: rans_cuda.rans_frame(torch.zeros((1, 9), dtype=torch.uint8),
                                 torch.zeros((1, 256), dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int16),
                                 torch.zeros((1, 4), dtype=torch.int64), 2)],
    ids=["rans_hist", "rans_chain", "rans_compact", "rans_decode",
         "rans_frame"])
def test_rans_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
