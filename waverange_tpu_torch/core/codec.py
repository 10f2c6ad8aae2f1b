"""Field-level encode/decode with the device step on torch.

Port of the device path of `waverange_tpu.core.codec` (`_encode_jax`,
`_decode_jax`). The wavelet and the byte-layer quantizer run on the given
torch device (hand-written CUDA kernels on a GPU, the plain torch versions
on the CPU). The entropy stage is either the port's copy of the host C++
coder (`waverange_tpu_torch.native`, `entropy="host"`; codec.py:285-286,
:318-319 of the reference), or, for the turbo format v2 (`coder="rans"`),
the port's own rANS coder on the same device (`entropy="device"`,
`ops.rans`, codec.py:278-283, :310-316): then the symbol planes never
leave the device and only compressed bytes cross PCIe.

Streams are `EncodedField` records with the fields and values of
`waverange_tpu.core.codec.EncodedField`, so the native and JAX decoders
and the CLIs read them, and `decode_field` reads a record of either
package by its fields. On the f64 path they are byte identical to
`backend="native"` at every tolerance, 1e-16 included, and decode is bit
identical to the native decoder.

There is no implicit device: the default is "cuda", which fails where no
CUDA device is available.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native as wn
from ..ops import rans
from ..ops.quant import decode_step, encode_step

# f32 quantization floors at a few ulp of 2^-24: below this relative
# tolerance precision="native" cannot meet the error contract
# (waverange_tpu/core/codec.py:85-118). The f64 path has no floor.
F32_REL_FLOOR = 1e-6

NLAYMAX = 8
WAV_LVL = 4
CODER_VERSION = 31503        # reference-bit-exact range-coder format
CODER_VERSION_TURBO = 31600  # v2 interleaved-rANS format

_CODER_IDS = {"range": 0, "rans": 1, "turbo": 1}
_VERSION_BY_ID = {0: CODER_VERSION, 1: CODER_VERSION_TURBO}
_ID_BY_VERSION = {CODER_VERSION: 0, CODER_VERSION_TURBO: 1}


def coder_id(coder) -> int:
    """Resolve a coder name ("range" | "rans"/"turbo") or id to 0/1."""
    if isinstance(coder, str):
        return _CODER_IDS[coder]
    return int(coder)


def coder_id_for_version(version: int) -> int:
    if version not in _ID_BY_VERSION:
        raise ValueError(f"unsupported coder version {version}")
    return _ID_BY_VERSION[version]


@dataclass
class EncodedField:
    """Codec metadata + payload for one field (the reference's per-field
    header record, gen_aux.cpp:505-556; the same fields as
    `waverange_tpu.core.codec.EncodedField`)."""
    nx: int
    ny: int
    nz: int
    tolabs: float
    midval: float
    halfspanval: float
    wlev: int
    nlay: int
    ntot_enc: int
    deps_vec: np.ndarray       # (8,) f64
    minval_vec: np.ndarray     # (8,) f64
    len_enc_vec: np.ndarray    # (8,) u64
    data: bytes = b""
    coder_version: int = CODER_VERSION

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain torch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def state_from_numpy(planes, deps, minv, nlay, tolabs, midval, halfspanval,
                     trivial, device="cuda"):
    """Turn an `encode_step` result held as numpy (e.g. from
    `waverange_tpu.ops.quant.encode_step`) into this package's tensors on
    `device`, in the same order; the scalars become 0-d tensors."""
    dev = _device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    return (t(planes), t(deps), t(minv), t(np.int32(nlay)), t(tolabs),
            t(midval), t(halfspanval), t(np.bool_(trivial)))


def encode_field(fld: np.ndarray, tolrel: float, wtflag: int = 1,
                 precision: str = "f64", coder: str = "range",
                 conformance: str = "strict", device="cuda",
                 cutoff: Optional[np.ndarray] = None,
                 mx: int = 1, my: int = 1, mz: int = 1,
                 backend: str = "torch",
                 entropy: str = "host") -> EncodedField:
    """Encode one (nz, ny, nx) field with the device step on `device`.

    `precision`: "f64" (reference semantics; f32 input is widened) or
    "native" (keep f32 input in f32; refused under conformance="strict"
    below the f32 floor). `coder`: "range" (reference format) or
    "rans"/"turbo" (format v2). `entropy`: "host" (the native C++ coder)
    or "device" (format v2 only: the port's rANS coder on `device`).
    `cutoff`, when given, is the uniform cutoff (one value, mx=my=mz=1)
    and replaces `tolrel`, as in the native codec.
    """
    cid = coder_id(coder)
    if entropy == "device" and cid != 1:
        raise ValueError("entropy='device' requires coder='rans' (the v2 "
                         "format is the lane-parallel one; the v1 range "
                         "coder is sequential)")
    if entropy not in ("host", "device"):
        raise ValueError(f"unknown entropy stage {entropy!r}")
    if backend == "exact64":
        raise NotImplementedError(
            "backend='exact64' is not ported yet (ROADMAP: port modules, "
            "core/exact64.py)")
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    if conformance == "route":
        raise NotImplementedError(
            "conformance='route' is not ported yet (ROADMAP: port modules, "
            "core/exact64.py)")
    if conformance not in ("strict", "degraded"):
        raise ValueError("conformance must be 'strict' or 'degraded'")
    if not (mx == my == mz == 1):
        raise NotImplementedError(
            "non-uniform cutoffs (mx, my, mz != 1) are not ported yet "
            "(ROADMAP: port modules, io/CLI entries)")
    if precision not in ("f64", "native"):
        raise ValueError("precision must be 'f64' or 'native'")
    if cutoff is not None:
        cutoff = np.asarray(cutoff, np.float64).ravel()
        if cutoff.size != 1:
            raise ValueError("a uniform cutoff holds one value")
        tolrel = float(cutoff[0])
    keep_f32 = precision == "native" and fld.dtype == np.float32
    if keep_f32 and conformance == "strict" and tolrel < F32_REL_FLOOR:
        raise ValueError(
            f"tolerance {tolrel:g} is below the f32 path's error floor "
            f"({F32_REL_FLOOR:g} relative); use precision='f64' or pass "
            "conformance='degraded' to accept the floor")
    dev = _device(device)
    nz, ny, nx = fld.shape
    arr = np.ascontiguousarray(fld, np.float32 if keep_f32 else np.float64)
    x = torch.from_numpy(arr).to(dev)
    planes, deps, minv, nlay, tolabs, midval, halfspan, trivial = (
        encode_step(x, tolrel, wtflag=bool(wtflag), levels=WAV_LVL))
    wlev = WAV_LVL if wtflag else 0
    stats = torch.stack([tolabs, midval, halfspan, trivial.double(),
                         nlay.double()]).cpu().tolist()
    tolabs_f, midval_f, halfspan_f, trivial_f, nlay_f = stats
    if trivial_f:
        return EncodedField(
            nx=nx, ny=ny, nz=nz, tolabs=0.0, midval=midval_f,
            halfspanval=halfspan_f, wlev=wlev, nlay=0, ntot_enc=0,
            deps_vec=np.zeros(NLAYMAX), minval_vec=np.zeros(NLAYMAX),
            len_enc_vec=np.zeros(NLAYMAX, np.uint64), data=b"",
            coder_version=_VERSION_BY_ID[cid])
    nl = int(nlay_f)
    if entropy == "device":
        streams = rans.encode_planes_device(planes[:nl], planes.shape[1])
        payload = b"".join(streams)
        lens = np.array([len(s) for s in streams], np.uint64)
    else:
        payload, lens = wn.encode_planes_batch(planes[:nl].cpu().numpy(),
                                               coder=cid)
    deps_vec = np.zeros(NLAYMAX)
    minv_vec = np.zeros(NLAYMAX)
    len_vec = np.zeros(NLAYMAX, np.uint64)
    deps_vec[:nl] = deps[:nl].double().cpu().numpy()
    minv_vec[:nl] = minv[:nl].double().cpu().numpy()
    len_vec[:nl] = lens
    return EncodedField(
        nx=nx, ny=ny, nz=nz, tolabs=tolabs_f, midval=midval_f,
        halfspanval=halfspan_f, wlev=wlev, nlay=nl, ntot_enc=len(payload),
        deps_vec=deps_vec, minval_vec=minv_vec, len_enc_vec=len_vec,
        data=payload, coder_version=_VERSION_BY_ID[cid])


def decode_field(enc: EncodedField, device="cuda",
                 entropy: str = "host") -> np.ndarray:
    """Decode to an (nz, ny, nx) float64 array: the entropy decode (the
    native host coder, or with `entropy="device"`, for turbo v2 streams
    only, the port's rANS decoder on `device`, which uploads only the
    compressed bytes), then the layer accumulate and inverse wavelet on
    `device`."""
    cid = coder_id_for_version(enc.coder_version)
    if entropy == "device" and cid != 1:
        raise ValueError("entropy='device' requires a turbo (v2) stream")
    if entropy not in ("host", "device"):
        raise ValueError(f"unknown entropy stage {entropy!r}")
    dev = _device(device)
    shape = enc.shape_zyx
    if enc.ntot_enc == 0:
        return np.full(shape, enc.midval)
    nl = int(enc.nlay)
    n = enc.nx * enc.ny * enc.nz
    if entropy == "device":
        planes = rans.decode_planes_device(enc.data, n, device=dev,
                                           lens=enc.len_enc_vec[:nl])
    else:
        planes = torch.from_numpy(wn.decode_planes_batch(
            enc.data, enc.len_enc_vec[:nl], n, coder=cid)).to(dev)
    out = decode_step(
        planes,
        torch.as_tensor(np.asarray(enc.deps_vec[:nl], np.float64), device=dev),
        torch.as_tensor(np.asarray(enc.minval_vec[:nl], np.float64),
                        device=dev),
        shape, levels=int(enc.wlev))
    return out.cpu().numpy()
