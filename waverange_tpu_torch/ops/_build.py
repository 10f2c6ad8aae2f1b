"""Build and load the package's CUDA kernels (`csrc/*.cu`).

All kernels compile with one `nvcc` call into one shared library with a
plain C interface, loaded with ctypes. The library lands in
``build/waverange_tpu_torch/libwrtorch-<hash>.so`` at the repository root,
keyed by a hash of the sources and flags, and is built at first use.

`--fmad=false` is part of the codec's contract: the f64 path must match
the native C++ codec bit for bit, which holds only when no multiply and
add are contracted into an FMA (the native library pins
`-ffp-contract=off` for the same reason). Never build with
`--use_fast_math`.

A missing `nvcc` or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "waverange_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
]

_lib = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME (default
    /usr/local/cuda). Raises if there is none."""
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of waverange_tpu_torch are built with the CUDA toolkit "
        "at first use on a CUDA device; CPU tensors take the plain "
        "PyTorch path and need no build")


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwrtorch-{h.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = lib_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cus]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {r.returncode}): {' '.join(cmd)}\n"
            f"{r.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ct.CDLL:
    """The kernel library, built if needed, with every entry point's
    argument and result types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ct.CDLL(str(ensure_built()))
    vp, i64, i32 = ct.c_void_p, ct.c_longlong, ct.c_int
    for sfx in ("f64", "f32"):
        fn = getattr(lib, f"wr_lift_pass_{sfx}")
        # inverse, src, dst, s_sz, s_sy, d_sz, d_sy, az, ay, ax, axes,
        # consts, device, stream
        fn.argtypes = [i32, vp, vp, i64, i64, i64, i64, i64, i64, i64, i32,
                       vp, i32, vp]
        fn.restype = i32
        fn = getattr(lib, f"wr_quant_layer_{sfx}")
        # params, fld, plane, pmin, pmax, n, nblocks, device, stream
        fn.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, vp]
        fn.restype = i32
        fn = getattr(lib, f"wr_accumulate_{sfx}")
        # planes, deps, minv, nlay, n, out, device, stream
        fn.argtypes = [vp, vp, vp, i32, i64, vp, i32, vp]
        fn.restype = i32
    for name, args in (
            # planes, n, nblocks, etab, nsym, device, stream
            ("wr_rans_hist", [vp, i64, i64, vp, vp, i32, vp]),
            # planes, n, nblocks, etab, slab, x_fin, nwords, device, stream
            ("wr_rans_chain", [vp, i64, i64, vp, vp, vp, vp, i32, vp]),
            # x_fin, slab, nwords, dest, nblocks, out, device, stream
            ("wr_rans_compact", [vp, vp, vp, vp, i64, vp, i32, vp]),
            # data, data_len, table, n, nblocks, out, device, stream
            ("wr_rans_decode", [vp, i64, vp, i64, i64, vp, i32, vp]),
            # planes, n, nblocks, etab, payload, pay_len, table, out,
            # device, stream
            ("wr_rans_frame", [vp, i64, i64, vp, vp, i64, vp, vp, i32,
                               vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    _lib = lib
    return lib
