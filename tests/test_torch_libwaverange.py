"""The port's drop-in libwaverange (`waverange_tpu_torch.native.libwaverange`,
`python -m waverange_tpu_torch build-lib`), the counterpart of
tests/test_library_abi.py: built into a temporary directory, the C example
compiled against it (shared and static), and its ABI held to the reference
oracle's and to the JAX package's drop-in library (the same C++ source,
built by `waverange_tpu.native.build`) byte for byte, bit for bit."""
import ctypes as ct
import re
import shutil
import subprocess

import numpy as np
import pytest

from conftest import REPO, smooth_field
from waverange_tpu.native import build as jax_build
from waverange_tpu.native import libwaverange as JL
from waverange_tpu_torch.native import libwaverange as TL


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tree with the port's products in build/{lib,include} and a copy of
    examples/library/example.c, whose `#include "../../build/include/
    waverange.h"` then finds the port's header."""
    root = tmp_path_factory.mktemp("libwaverange")
    libdir = TL.build_libwaverange(root / "build")
    assert libdir == root / "build" / "lib"
    ex = root / "examples" / "library"
    ex.mkdir(parents=True)
    shutil.copy(REPO / "examples" / "library" / "example.c", ex)
    return root


F64 = ct.POINTER(ct.c_double)
U64 = ct.POINTER(ct.c_ulong)
U8 = ct.POINTER(ct.c_ubyte)
RECORD = [F64, F64, F64, U8, U8, U64, F64, F64, U64, U8]


def _load(path):
    """The library with the C prototypes of waverange.h declared."""
    lib = ct.CDLL(str(path))
    i3 = [ct.c_int] * 3
    lib.setup_wr.argtypes = i3 + [U8, U64]
    lib.encoding_wrap.argtypes = i3 + [F64, ct.c_int] + i3 + [F64] + RECORD
    lib.decoding_wrap.argtypes = i3 + [F64] + RECORD
    for f in (lib.setup_wr, lib.encoding_wrap, lib.decoding_wrap):
        f.restype = None
    return lib


def _run_example(ex, exe, link):
    subprocess.run(["gcc", "-O2", "-o", str(exe), "example.c", *link],
                   check=True, capture_output=True, cwd=ex)
    r = subprocess.run([str(exe)], check=True, capture_output=True,
                       text=True)
    assert "PASS" in r.stdout, r.stdout


def test_products(root):
    for f in ("build/lib/libwaverange.so", "build/lib/libwaverange.a",
              "build/include/waverange.h"):
        assert (root / f).is_file()
    # nothing half-written is left behind
    assert not [p for p in root.rglob("*") if ".tmp" in p.name]
    assert TL.DEFAULT_DIR == REPO / "build" / "waverange_tpu_torch"


def test_c_example_roundtrip(root):
    libdir = root / "build" / "lib"
    ex = root / "examples" / "library"
    _run_example(ex, ex / "example", [f"-L{libdir}", "-lwaverange",
                                      f"-Wl,-rpath,{libdir}", "-lm"])


def test_static_archive(root):
    ex = root / "examples" / "library"
    _run_example(ex, ex / "example_static",
                 [str(root / "build" / "lib" / "libwaverange.a"),
                  "-lstdc++", "-lpthread", "-lm"])


def _encode(lib, a, tol):
    nz, ny, nx = a.shape
    fld = np.ascontiguousarray(a, np.float64).copy()
    cutoff = np.array([tol])
    tolabs, midval, halfspan = ct.c_double(), ct.c_double(), ct.c_double()
    wlev, nlay, ntot = ct.c_ubyte(), ct.c_ubyte(), ct.c_ulong()
    deps, minv = np.zeros(8), np.zeros(8)
    lens = np.zeros(8, np.uint64)
    data = np.zeros(8 * max(a.size, 1024), np.uint8)
    dp = lambda arr: arr.ctypes.data_as(F64)
    lib.encoding_wrap(
        nx, ny, nz, dp(fld), 1, 1, 1, 1, dp(cutoff), ct.byref(tolabs),
        ct.byref(midval), ct.byref(halfspan), ct.byref(wlev),
        ct.byref(nlay), ct.byref(ntot), dp(deps), dp(minv),
        lens.ctypes.data_as(U64), data.ctypes.data_as(U8))
    return dict(tolabs=tolabs.value, midval=midval.value,
                halfspanval=halfspan.value, wlev=wlev.value,
                nlay=nlay.value, ntot_enc=ntot.value, deps_vec=deps,
                minval_vec=minv, len_enc_vec=lens,
                data=data[:ntot.value].tobytes())


def _decode(lib, m, shape):
    nz, ny, nx = shape
    rec = np.zeros(shape)
    data = np.frombuffer(m["data"], np.uint8).copy()
    lens = np.asarray(m["len_enc_vec"], np.uint64).copy()
    dp = lambda arr: arr.ctypes.data_as(F64)
    lib.decoding_wrap(
        nx, ny, nz, dp(rec), ct.byref(ct.c_double(m["tolabs"])),
        ct.byref(ct.c_double(m["midval"])),
        ct.byref(ct.c_double(m["halfspanval"])),
        ct.byref(ct.c_ubyte(m["wlev"])), ct.byref(ct.c_ubyte(m["nlay"])),
        ct.byref(ct.c_ulong(m["ntot_enc"])),
        dp(np.asarray(m["deps_vec"], np.float64).copy()),
        dp(np.asarray(m["minval_vec"], np.float64).copy()),
        lens.ctypes.data_as(U64), data.ctypes.data_as(U8))
    return rec


@pytest.fixture(params=["package", "oracle"])
def reference(request):
    """(encode(a, tol), decode(meta, shape)) of the JAX package's drop-in
    library, or of the reference oracle (skips where it cannot be
    built)."""
    if request.param == "package":
        lib = _load(jax_build.ensure_built())
        return (lambda a, tol: _encode(lib, a, tol),
                lambda m, shape: _decode(lib, m, shape))
    oracle = request.getfixturevalue("oracle")
    return (lambda a, tol: oracle.encode(a.copy(), 1, tol), oracle.decode)


@pytest.mark.parametrize("tol", [1e-7, 1e-16])
def test_abi_matches_reference(root, reference, tol):
    lib = _load(root / "build" / "lib" / "libwaverange.so")
    a = smooth_field((12, 10, 8))
    enc_ref, dec_ref = reference
    got, want = _encode(lib, a, tol), enc_ref(a, tol)
    assert got["nlay"] == want["nlay"] and got["wlev"] == want["wlev"]
    for k in ("tolabs", "midval", "halfspanval"):
        assert got[k] == want[k], k
    k = got["nlay"]
    for f in ("deps_vec", "minval_vec"):
        assert got[f][:k].tobytes() == np.asarray(
            want[f], np.float64)[:k].tobytes(), f
    assert np.array_equal(got["len_enc_vec"][:k],
                          np.asarray(want["len_enc_vec"], np.uint64)[:k])
    assert got["ntot_enc"] == want["ntot_enc"] and got["data"] == want["data"]
    rec = _decode(lib, got, a.shape)
    assert np.array_equal(rec.view(np.uint64),
                          dec_ref(want, a.shape).view(np.uint64))


def test_setup_wr(root):
    lib = _load(root / "build" / "lib" / "libwaverange.so")
    nlaymax, cap = ct.c_ubyte(), ct.c_ulong()
    lib.setup_wr(16, 16, 16, ct.byref(nlaymax), ct.byref(cap))
    assert nlaymax.value == 8
    assert cap.value == 8 * 16 * 16 * 16


def test_fortran_shims(root):
    """The `_f` shims are exported and run the flow of
    examples/fortran/example_wr.f90 (as tests/test_library_abi.py
    runs it): setup, encode, decode, error within the tolerance."""
    lib = ct.CDLL(str(root / "build" / "lib" / "libwaverange.so"))
    for sym in ("setup_wr_f", "encoding_wrap_f", "decoding_wrap_f"):
        assert hasattr(lib, sym), sym
    ip, lp = ct.POINTER(ct.c_int), ct.POINTER(ct.c_long)
    dp_ = ct.POINTER(ct.c_double)
    lib.setup_wr_f.argtypes = [ip] * 4 + [lp]
    lib.encoding_wrap_f.argtypes = [ip] * 3 + [dp_, ip, dp_] + [dp_] * 3 \
        + [U8, U8, lp, dp_, dp_, lp, U8]
    lib.decoding_wrap_f.argtypes = [ip] * 3 + [dp_] * 3 \
        + [U8, U8, lp, dp_, dp_, lp, U8]
    for sym in ("setup_wr_f", "encoding_wrap_f", "decoding_wrap_f"):
        getattr(lib, sym).restype = None
    nx, ny, nz = ct.c_int(24), ct.c_int(16), ct.c_int(12)
    nlaymax, cap = ct.c_int(), ct.c_long()
    lib.setup_wr_f(ct.byref(nx), ct.byref(ny), ct.byref(nz),
                   ct.byref(nlaymax), ct.byref(cap))
    assert nlaymax.value == 8 and cap.value == 8 * max(24 * 16 * 12, 1024)
    fld = smooth_field((12, 16, 24)).copy()
    orig = fld.copy()
    tolabs, midval, halfspan = ct.c_double(), ct.c_double(), ct.c_double()
    wlev, nlay, ntot = ct.c_ubyte(), ct.c_ubyte(), ct.c_long()
    deps, minv = np.zeros(8), np.zeros(8)
    lens = np.zeros(8, np.int64)
    data = np.zeros(cap.value, np.uint8)
    dp = lambda arr: arr.ctypes.data_as(ct.POINTER(ct.c_double))
    lp = lens.ctypes.data_as(ct.POINTER(ct.c_long))
    up = data.ctypes.data_as(ct.POINTER(ct.c_ubyte))
    lib.encoding_wrap_f(
        ct.byref(nx), ct.byref(ny), ct.byref(nz), dp(fld),
        ct.byref(ct.c_int(1)), ct.byref(ct.c_double(1e-7)),
        ct.byref(tolabs), ct.byref(midval), ct.byref(halfspan),
        ct.byref(wlev), ct.byref(nlay), ct.byref(ntot), dp(deps), dp(minv),
        lp, up)
    assert 1 <= nlay.value <= 8 and 0 < ntot.value <= cap.value
    rec = np.zeros_like(fld)
    lib.decoding_wrap_f(
        ct.byref(nx), ct.byref(ny), ct.byref(nz), dp(rec), ct.byref(midval),
        ct.byref(halfspan), ct.byref(wlev), ct.byref(nlay), ct.byref(ntot),
        dp(deps), dp(minv), lp, up)
    assert np.abs(rec - orig).max() <= 1.3 * 1e-7 * np.abs(orig).max()


def _prototypes(header: str):
    """The header's declarations, comments and whitespace stripped."""
    text = re.sub(r"/\*.*?\*/", "", header, flags=re.S)
    return [re.sub(r"\s+", " ", d).strip()
            for d in re.findall(r"void\s+\w+\s*\([^)]*\)\s*;", text)]


def test_header_prototypes_equal_the_jax_header(root):
    ours = _prototypes((root / "build" / "include" / "waverange.h")
                       .read_text())
    assert ours == _prototypes(JL.HEADER)
    assert len(ours) == 6  # C++ and C forms of the three entry points
