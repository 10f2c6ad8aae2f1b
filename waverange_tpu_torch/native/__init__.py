"""ctypes bindings of the port's own copy of the wr_native host library.

The C++ range coder (coder 0, the reference format) and turbo rANS coder
(coder 1, format v2), and the bit-exact f64 host pipeline that serves as
the byte-identity oracle of the port. The wrappers are copied from
`waverange_tpu/native/__init__.py`, limited to the entry points the port
and `chip_smoke.py` call: the coders, the f64 and f32 field pipelines
(`backend="native"` of the codec) and MSSG's mask separation. All take
and return numpy arrays; the work runs in C++ with the GIL released
(ctypes releases it around foreign calls).
The library is built by `native.build` at the first call.
"""
from __future__ import annotations

import ctypes as ct
import os
from typing import Tuple

import numpy as np

from .build import ensure_built

NLAYMAX = 8

_lib = None


def _default_threads() -> int:
    env = os.environ.get("WR_NUM_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def get_lib() -> ct.CDLL:
    global _lib
    if _lib is None:
        lib = ct.CDLL(str(ensure_built()))
        u64 = ct.c_uint64
        u8p = ct.POINTER(ct.c_uint8)
        u64p = ct.POINTER(ct.c_uint64)
        f64p = ct.POINTER(ct.c_double)

        lib.wrn_encode_plane.restype = u64
        lib.wrn_encode_plane.argtypes = [u8p, u64, u8p, u64, ct.c_int]
        lib.wrn_decode_plane.restype = u64
        lib.wrn_decode_plane.argtypes = [u8p, u64, u8p, u64, ct.c_int]
        lib.wrn_encode_planes_batch.restype = u64
        lib.wrn_encode_planes_batch.argtypes = [
            u8p, u64, u64, u8p, u64, u64p, ct.c_int, ct.c_int]
        lib.wrn_decode_planes_batch.restype = None
        lib.wrn_decode_planes_batch.argtypes = [
            u8p, u64p, u64, u8p, u64, ct.c_int, ct.c_int]
        lib.wrn_wavelet3d.restype = None
        lib.wrn_wavelet3d.argtypes = [f64p, u64, u64, u64, ct.c_int]
        i32p = ct.POINTER(ct.c_int)
        lib.wrn_index_p2w.restype = None
        lib.wrn_index_p2w.argtypes = [ct.c_int] * 7 + [i32p] * 4
        lib.wrn_encode_field_nc.restype = u64
        lib.wrn_encode_field_nc.argtypes = [
            f64p, u64, u64, u64, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
            f64p, f64p, f64p, f64p, u8p, u8p, f64p, f64p, u64p, u8p,
            ct.c_int]
        lib.wrn_decode_field.restype = None
        lib.wrn_decode_field.argtypes = [
            f64p, u64, u64, u64, ct.c_double, ct.c_uint8, ct.c_uint8, u64,
            f64p, f64p, u64p, u8p, ct.c_int]
        f32p = ct.POINTER(ct.c_float)
        lib.wrn_encode_field_f32.restype = u64
        lib.wrn_encode_field_f32.argtypes = [
            f32p] + lib.wrn_encode_field_nc.argtypes[1:]
        lib.wrn_decode_field_f32.restype = None
        lib.wrn_decode_field_f32.argtypes = [
            f32p] + lib.wrn_decode_field.argtypes[1:]
        lib.wrn_mask_separate.restype = ct.c_double
        lib.wrn_mask_separate.argtypes = [f64p, f64p, u64, ct.c_double,
                                          ct.c_double]
        lib.wrn_pool_trim.restype = None
        lib.wrn_pool_trim.argtypes = []
        lib.wrn_pool_warm.restype = None
        lib.wrn_pool_warm.argtypes = [u64, ct.c_int]
        _lib = lib
    return _lib


# encode overflow sentinel from the C ABI (encoded size exceeded the
# setup_wr safety-buffer contract; see wr_native.cc encode_layers)
_ENC_OVERFLOW = 2**64 - 1


def pool_trim() -> None:
    """Release the library's process-wide buffer pool (the recycled pages
    a large-field batch leaves mapped)."""
    get_lib().wrn_pool_trim()


def pool_warm(n: int, slots: int = 0) -> None:
    """Pre-fault the pool buffers a size-n encode/decode will use so the
    first timed call runs at steady state (first-touch page faults of a
    large field's working set cost seconds on virtualized hosts;
    benchmarks should pay that outside the timed region)."""
    get_lib().wrn_pool_warm(n, slots)
    # the calling thread's recycled sink (encode_field output staging)
    # faults on first touch too — pre-fault one page per 4 KiB
    buf = _sink_buffer(NLAYMAX * max(n, 1024))
    buf[::4096] = 0


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint8))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_double))


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint64))


def encode_plane(syms: np.ndarray, coder: int = 0) -> bytes:
    """Entropy-encode one uint8 symbol plane into its layer bitstream.

    coder 0 = reference-bit-exact range coder; 1 = turbo rANS (format
    v2, CODER_VERSION_TURBO)."""
    lib = get_lib()
    syms = np.ascontiguousarray(syms, dtype=np.uint8).ravel()
    n = syms.size
    cap = max(2 * n + 8192, 16384)
    out = np.empty(cap, dtype=np.uint8)
    ln = lib.wrn_encode_plane(_u8p(syms), n, _u8p(out), cap, coder)
    if ln > cap:  # extremely incompressible data; retry with exact size
        out = np.empty(ln, dtype=np.uint8)
        ln = lib.wrn_encode_plane(_u8p(syms), n, _u8p(out), ln, coder)
    return out[:ln].tobytes()


def decode_plane(data: bytes, n: int, coder: int = 0) -> np.ndarray:
    """Entropy-decode one layer bitstream into its n uint8 symbols."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    syms = np.empty(n, dtype=np.uint8)
    got = lib.wrn_decode_plane(_u8p(buf), buf.size, _u8p(syms), n, coder)
    if got != n:
        raise ValueError(f"decode_plane: expected {n} symbols, got {got}")
    return syms


def encode_planes_batch(planes: np.ndarray, nthreads: int | None = None,
                        coder: int = 0) -> Tuple[bytes, np.ndarray]:
    """Encode (nplanes, n) uint8 planes in parallel.

    Returns (payload bytes with planes back to back, per-plane lengths).
    """
    lib = get_lib()
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    nplanes, n = planes.shape
    cap = max(2 * planes.size + 8192 * nplanes, 16384)
    out = np.empty(cap, dtype=np.uint8)
    lens = np.zeros(nplanes, dtype=np.uint64)
    nt = nthreads or _default_threads()
    total = lib.wrn_encode_planes_batch(
        _u8p(planes), nplanes, n, _u8p(out), cap, _u64p(lens), nt, coder)
    if total > cap:
        out = np.empty(total, dtype=np.uint8)
        total = lib.wrn_encode_planes_batch(
            _u8p(planes), nplanes, n, _u8p(out), total, _u64p(lens), nt,
            coder)
    return out[:total].tobytes(), lens


def decode_planes_batch(payload: bytes | np.ndarray, lens: np.ndarray, n: int,
                        nthreads: int | None = None,
                        coder: int = 0) -> np.ndarray:
    lib = get_lib()
    buf = np.frombuffer(payload, dtype=np.uint8) if isinstance(
        payload, (bytes, bytearray)) else np.ascontiguousarray(payload, np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.uint64)
    nplanes = lens.size
    if buf.size < int(lens.sum()):
        raise ValueError(
            f"encoded payload truncated: {buf.size} bytes, lengths "
            f"declare {int(lens.sum())}")
    syms = np.empty((nplanes, n), dtype=np.uint8)
    lib.wrn_decode_planes_batch(
        _u8p(buf), _u64p(lens), nplanes, _u8p(syms), n,
        nthreads or _default_threads(), coder)
    return syms


def wavelet3d(fld: np.ndarray, levels: int) -> np.ndarray:
    """In-place separable CDF 9/7 transform on an (nz, ny, nx) f64 array.

    ``levels`` > 0 forward, < 0 inverse — axis x (last, contiguous) is the
    "first" axis in codec convention.
    """
    if fld.dtype != np.float64 or not fld.flags.c_contiguous \
            or fld.ndim != 3:
        raise ValueError("wavelet3d works in place on a C-contiguous "
                         "(nz, ny, nx) float64 array")
    nz, ny, nx = fld.shape
    get_lib().wrn_wavelet3d(_f64p(fld), nx, ny, nz, levels)
    return fld


def index_p2w(levels: int, n1: int, n2: int, n3: int,
              i1: int, i2: int, i3: int) -> Tuple[int, int, int, int]:
    """Where the point (i1, i2, i3) of an (n1, n2, n3) field lies after a
    `levels`-level transform: (level, o1, o2, o3)."""
    lvl = ct.c_int()
    o1, o2, o3 = ct.c_int(), ct.c_int(), ct.c_int()
    get_lib().wrn_index_p2w(levels, n1, n2, n3, i1, i2, i3, ct.byref(lvl),
                            ct.byref(o1), ct.byref(o2), ct.byref(o3))
    return lvl.value, o1.value, o2.value, o3.value


_sink_local = None


def _sink_buffer(cap: int) -> np.ndarray:
    """Per-thread recycled sink for encode_field's output.

    Reusing one buffer keeps its pages mapped (first-touch faults of a
    GiB-sized buffer cost seconds on virtualized hosts). Safe because the
    caller copies the stream out (`tobytes`) before return.
    """
    global _sink_local
    if _sink_local is None:
        import threading
        _sink_local = threading.local()
    buf = getattr(_sink_local, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.empty(cap, dtype=np.uint8)
        _sink_local.buf = buf
    return buf


def _cutoffvec(cutoff, mx: int, my: int, mz: int) -> np.ndarray:
    cutoffvec = np.ascontiguousarray(cutoff, dtype=np.float64).ravel()
    if cutoffvec.size != mx * my * mz:
        raise ValueError(f"cutoff holds {cutoffvec.size} values, "
                         f"mx*my*mz = {mx * my * mz}")
    return cutoffvec


def _encode(entry, fld: np.ndarray, ptr, wtflag: int, cutoffvec, mx: int,
            my: int, mz: int, coder: int) -> dict:
    """Run one of the field encoders (`wrn_encode_field_nc`, f64, or
    `wrn_encode_field_f32`) and return the record as a dict."""
    nz, ny, nx = fld.shape
    tolabs = ct.c_double()
    midval = ct.c_double()
    halfspanval = ct.c_double()
    wlev = ct.c_uint8()
    nlay = ct.c_uint8()
    deps_vec = np.zeros(NLAYMAX, dtype=np.float64)
    minval_vec = np.zeros(NLAYMAX, dtype=np.float64)
    len_enc_vec = np.zeros(NLAYMAX, dtype=np.uint64)
    data_enc = _sink_buffer(NLAYMAX * max(fld.size, 1024))
    ntot_enc = entry(
        ptr, nx, ny, nz, wtflag, mx, my, mz, _f64p(cutoffvec),
        ct.byref(tolabs), ct.byref(midval), ct.byref(halfspanval),
        ct.byref(wlev), ct.byref(nlay), _f64p(deps_vec), _f64p(minval_vec),
        _u64p(len_enc_vec), _u8p(data_enc), coder)
    if ntot_enc == _ENC_OVERFLOW:
        raise ValueError(
            "encoded size exceeds the 8*max(n,1024)-byte safety buffer "
            "(near-incompressible field); the stream was not produced")
    return dict(
        tolabs=tolabs.value, midval=midval.value,
        halfspanval=halfspanval.value, wlev=wlev.value, nlay=nlay.value,
        ntot_enc=int(ntot_enc), deps_vec=deps_vec, minval_vec=minval_vec,
        len_enc_vec=len_enc_vec, data=data_enc[:ntot_enc].tobytes())


def encode_field(fld: np.ndarray, wtflag: int = 1,
                 cutoff=None, mx: int = 1, my: int = 1, mz: int = 1,
                 coder: int = 0) -> dict:
    """Encode one (nz, ny, nx) f64 field. ``fld`` is read, not clobbered.

    Returns a dict with the codec metadata + payload, mirroring the
    reference encoding_wrap outputs (wrappers.h:53). `cutoff` holds the
    mx*my*mz local-cutoff tolerances (reference wrappers.cpp:343-379).
    """
    # no defensive copy: wrn_encode_field_nc reads `fld` const (the
    # first wavelet sweep lifts into a native-side scratch)
    fld = np.ascontiguousarray(fld, dtype=np.float64)
    if cutoff is None:
        cutoff = np.array([1e-16], dtype=np.float64)
    return _encode(get_lib().wrn_encode_field_nc, fld, _f64p(fld), wtflag,
                   _cutoffvec(cutoff, mx, my, mz), mx, my, mz, coder)


def encode_field_f32(fld: np.ndarray, tolrel: float, wtflag: int = 1,
                     coder: int = 0, cutoff=None, mx: int = 1,
                     my: int = 1, mz: int = 1) -> dict:
    """f32-native host encode: lifting, quantization and residuals all in
    f32 (no FMA contraction). Stream format identical (f64 metadata); not
    the bit-exact reference path. `cutoff`/(mx,my,mz) select the
    local-cutoff masked quantizer (reference wrappers.cpp:343-379);
    without them the uniform cutoff is `tolrel`. ``fld`` is copied: the
    f32 pipeline works in place."""
    fld = np.ascontiguousarray(fld, dtype=np.float32).copy()
    if cutoff is None:
        cutoff = np.array([tolrel], dtype=np.float64)
    return _encode(get_lib().wrn_encode_field_f32, fld,
                   fld.ctypes.data_as(ct.POINTER(ct.c_float)), wtflag,
                   _cutoffvec(cutoff, mx, my, mz), mx, my, mz, coder)


def _decode(entry, fld: np.ndarray, ptr, meta: dict, coder: int
            ) -> np.ndarray:
    nz, ny, nx = fld.shape
    data = np.frombuffer(meta["data"], dtype=np.uint8)
    need = int(np.asarray(meta["len_enc_vec"][:meta["nlay"]],
                          np.uint64).sum())
    if data.size < need:
        raise ValueError(
            f"encoded payload truncated: {data.size} bytes, header "
            f"declares {need}")
    deps_vec = np.ascontiguousarray(meta["deps_vec"], dtype=np.float64)
    minval_vec = np.ascontiguousarray(meta["minval_vec"], dtype=np.float64)
    len_enc_vec = np.ascontiguousarray(meta["len_enc_vec"], dtype=np.uint64)
    entry(ptr, nx, ny, nz, meta["midval"], meta["wlev"], meta["nlay"],
          meta["ntot_enc"], _f64p(deps_vec), _f64p(minval_vec),
          _u64p(len_enc_vec), _u8p(data), coder)
    return fld


def decode_field(meta: dict, shape: Tuple[int, int, int],
                 coder: int = 0) -> np.ndarray:
    """Decode to an (nz, ny, nx) f64 field from encode_field-style metadata."""
    fld = np.empty(shape, dtype=np.float64)
    return _decode(get_lib().wrn_decode_field, fld, _f64p(fld), meta, coder)


def decode_field_f32(meta: dict, shape: Tuple[int, int, int],
                     coder: int = 0) -> np.ndarray:
    """f32-native host decode to an (nz, ny, nx) f32 field."""
    fld = np.empty(shape, dtype=np.float32)
    return _decode(get_lib().wrn_decode_field_f32, fld,
                   fld.ctypes.data_as(ct.POINTER(ct.c_float)), meta, coder)


def mask_separate(fld: np.ndarray, thresh: float, minval: float
                  ) -> Tuple[np.ndarray, float]:
    """In-place MSSG mask separation: pad masked (< thresh) elements of
    `fld` with the sequential mean of unmasked elements; returns the mask
    field ({0, minval}) and the pad value (contract: mssg_enc.cpp:323-348;
    the left-to-right sum order is part of bit-exactness)."""
    if fld.dtype != np.float64 or not fld.flags.c_contiguous:
        raise ValueError("mask_separate works in place on a C-contiguous "
                         "float64 array")
    mask = np.empty_like(fld)
    pad = get_lib().wrn_mask_separate(_f64p(fld), _f64p(mask), fld.size,
                                      thresh, minval)
    return mask, pad
