"""Field-level encode/decode with pluggable backends.

Port of `waverange_tpu.core.codec`. Backends:
  * "torch" (the default): the device step on a torch device. The wavelet
    and the byte-layer quantizer run there (hand-written CUDA kernels on a
    GPU, the plain torch versions on the CPU), as the reference's "jax"
    backend runs them (`_encode_jax`, `_decode_jax`). The entropy stage is
    either the port's copy of the host C++ coder
    (`waverange_tpu_torch.native`, `entropy="host"`; codec.py:285-286,
    :318-319 of the reference), or, for the turbo format v2
    (`coder="rans"`), the port's own rANS coder on the same device
    (`entropy="device"`, `ops.rans`, codec.py:278-283, :310-316): then the
    symbol planes never leave the device and only compressed bytes cross
    PCIe.
  * "exact64": the reference's bit-exact f64 device backend
    (`core.exact64`), which on this hardware is the torch backend's f64
    path.
  * "native": the port's copy of the C++ host pipeline, f64 or f32, the
    only backend with local (mx, my, mz) cutoffs.

Streams are `EncodedField` records with the fields and values of
`waverange_tpu.core.codec.EncodedField`, so the native and JAX decoders
and the CLIs read them, and `decode_field` reads a record of either
package by its fields. On the f64 path they are byte identical to
`backend="native"` at every tolerance, 1e-16 included, and decode is bit
identical to the native decoder.

There is no implicit device: the default is "cuda", which fails where no
CUDA device is available.

Each backend's encode and decode is timed as a stage of `utils.diag`
(`encode.torch`, `encode.exact64`, `encode.native`, `encode.native.f32`,
`decode.torch`, `decode.exact64`, `decode.native`); WR_VERBOSE=1 prints
each stage's time. With `entropy="device"` the stages inside them are
timed too (`encode.h2d`, `encode.step`, ...; `utils/diag.py` lists them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native as wn
from ..ops import rans
from ..ops.quant import decode_step, encode_step
from ..utils import timed, timed_if
from . import staging

# f32 quantization floors at a few ulp of 2^-24: below this relative
# tolerance precision="native" on a device cannot meet the error contract
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


def _record(meta: dict, shape, cid: int) -> EncodedField:
    nz, ny, nx = shape
    return EncodedField(
        nx=nx, ny=ny, nz=nz, tolabs=meta["tolabs"], midval=meta["midval"],
        halfspanval=meta["halfspanval"], wlev=meta["wlev"],
        nlay=meta["nlay"], ntot_enc=meta["ntot_enc"],
        deps_vec=np.asarray(meta["deps_vec"], np.float64),
        minval_vec=np.asarray(meta["minval_vec"], np.float64),
        len_enc_vec=np.asarray(meta["len_enc_vec"], np.uint64),
        data=meta["data"], coder_version=_VERSION_BY_ID[cid])


def encode_field(fld: np.ndarray, tolrel: float, wtflag: int = 1, *,
                 cutoff: Optional[np.ndarray] = None,
                 mx: int = 1, my: int = 1, mz: int = 1,
                 backend: str = "torch",
                 precision: str = "f64",
                 coder: str = "range",
                 entropy: str = "host",
                 conformance: str = "strict",
                 device="cuda") -> EncodedField:
    """Encode one (nz, ny, nx) field.

    The parameters after `wtflag` are keyword-only; their names are the
    reference's (waverange_tpu/core/codec.py:121-128), with `device`
    added: the torch device of the "torch" and "exact64" backends
    ("native" runs on the host and ignores it).

    `cutoff` holds the mx*my*mz local-cutoff tolerances and replaces
    `tolrel`, as in the native codec. Only `backend="native"` runs
    mx*my*mz > 1; the device backends raise rather than drop the cutoff.
    `precision`: "f64" (reference semantics; f32 input is widened) or
    "native" (keep f32 input in f32; "exact64" is always f64). `coder`:
    "range" (reference format) or "rans"/"turbo" (format v2). `entropy`:
    "host" (the native C++ coder) or "device" (format v2 on a device
    backend: the port's rANS coder on `device`). `conformance`: "strict"
    refuses f32 on a device below its error floor, "route" encodes such
    a request on the f64 path of the same backend and device, "degraded"
    accepts the floor. The native backend has no floor check, as in the
    reference (:107-109).
    """
    cid = coder_id(coder)
    if backend not in ("torch", "exact64", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if entropy not in ("host", "device"):
        raise ValueError(f"unknown entropy stage {entropy!r}")
    if entropy == "device" and (backend == "native" or cid != 1):
        raise ValueError("entropy='device' requires backend='torch'/"
                         "'exact64' and coder='rans' (the v2 format is the "
                         "lane-parallel one; the v1 range coder is "
                         "sequential)")
    if conformance not in ("strict", "degraded", "route"):
        raise ValueError("conformance must be 'strict', 'degraded' or "
                         "'route'")
    if precision not in ("f64", "native"):
        raise ValueError("precision must be 'f64' or 'native'")
    if backend != "native" and not (mx == my == mz == 1):
        raise ValueError(f"backend={backend!r} supports the uniform cutoff "
                         "only (mx=my=mz=1); local cutoffs run on "
                         "backend='native'")
    if cutoff is None:
        cutoff = np.array([tolrel], dtype=np.float64)
    keep_f32 = (precision == "native" and fld.dtype == np.float32
                and backend != "exact64")
    if backend == "native":
        if keep_f32:
            with timed("encode.native.f32"):
                meta = wn.encode_field_f32(fld, tolrel, wtflag=wtflag,
                                           coder=cid, cutoff=cutoff, mx=mx,
                                           my=my, mz=mz)
        else:
            with timed("encode.native"):
                meta = wn.encode_field(fld, wtflag=wtflag, cutoff=cutoff,
                                       mx=mx, my=my, mz=mz, coder=cid)
        return _record(meta, fld.shape, cid)
    cutoff = np.asarray(cutoff, np.float64).ravel()
    if cutoff.size != 1:
        raise ValueError("a uniform cutoff holds one value")
    # the uniform cutoff replaces tolrel, as in native; the reference's
    # device backends are given tolrel only (codec.py:193-200)
    tolrel = float(cutoff[0])
    if keep_f32 and tolrel < F32_REL_FLOOR and conformance != "degraded":
        if conformance == "strict":
            raise ValueError(
                f"tolerance {tolrel:g} is below the f32 path's error floor "
                f"({F32_REL_FLOOR:g} relative); use precision='f64', "
                "conformance='route' (the f64 path of this backend), or "
                "conformance='degraded' to accept the floor")
        keep_f32 = False
    if backend == "exact64":
        from .exact64 import encode_field_exact64
        with timed("encode.exact64"):
            meta = encode_field_exact64(fld, tolrel, wtflag=wtflag,
                                        coder=cid, entropy=entropy,
                                        device=device)
    else:
        dev = _device(device)
        with timed("encode.torch"):
            meta = encode_device(
                np.ascontiguousarray(fld, np.float32 if keep_f32
                                     else np.float64),
                tolrel, wtflag, WAV_LVL, cid, entropy, dev)
    return _record(meta, fld.shape, cid)


def encode_device(arr: np.ndarray, tolrel: float, wtflag: int, levels: int,
                  cid: int, entropy: str, dev: torch.device) -> dict:
    """The device step of the encode of an f32 or f64 field on `dev`, then
    the entropy stage; returns the record as a dict (native's keys)."""
    spans = entropy == "device"
    with timed_if(spans, "encode.h2d"):
        x = staging.to_device(arr, dev)
    with timed_if(spans, "encode.step"):
        step = encode_step(x, tolrel, wtflag=bool(wtflag), levels=levels)
        del x
        # the trivial field's wlev follows native (wr_native.cc:1936)
        meta, nl = step_meta(step, levels if wtflag else 0)
    if not nl:
        return meta
    planes = step[0][:nl]
    if entropy == "device":
        payload, lens = rans.encode_planes_joined(planes, planes.shape[1])
    else:
        payload, lens = wn.encode_planes_batch(staging.to_numpy(planes),
                                               coder=cid)
    return with_payload(meta, payload, lens)


def step_meta(step, wlev: int):
    """The record (native's keys) of an `encode_step` result, all but its
    payload, and the number of planes to code: 0 for a trivial field,
    whose record is then complete."""
    planes, deps, minv, nlay, tolabs, midval, halfspan, trivial = step
    meta = dict(wlev=wlev, deps_vec=np.zeros(NLAYMAX),
                minval_vec=np.zeros(NLAYMAX),
                len_enc_vec=np.zeros(NLAYMAX, np.uint64))
    stats = torch.stack([tolabs, midval, halfspan, trivial.double(),
                         nlay.double()]).cpu().tolist()
    tolabs_f, meta["midval"], meta["halfspanval"], trivial_f, nlay_f = stats
    if trivial_f:
        meta.update(tolabs=0.0, nlay=0, ntot_enc=0, data=b"")
        return meta, 0
    nl = int(nlay_f)
    meta["deps_vec"][:nl] = deps[:nl].double().cpu().numpy()
    meta["minval_vec"][:nl] = minv[:nl].double().cpu().numpy()
    meta.update(tolabs=tolabs_f, nlay=nl)
    return meta, nl


def with_payload(meta: dict, payload: bytes, lens) -> dict:
    """`meta` completed with the coded planes, back to back in `payload`,
    and their lengths."""
    meta["len_enc_vec"][:meta["nlay"]] = lens
    meta.update(ntot_enc=len(payload), data=payload)
    return meta


def decode_field(enc: EncodedField, *, backend: str = "torch",
                 device="cuda", entropy: str = "host") -> np.ndarray:
    """Decode to an (nz, ny, nx) float64 array. The entropy coder is
    chosen by the stream's coder_version (31503 range / 31600 turbo).

    "torch" and "exact64": the entropy decode (the native host coder, or
    with `entropy="device"`, for turbo v2 streams only, the port's rANS
    decoder on `device`, which uploads only the compressed bytes), then
    the layer accumulate and inverse wavelet on `device`. "native": the
    port's copy of the C++ decoder."""
    cid = coder_id_for_version(enc.coder_version)
    if backend not in ("torch", "exact64", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if entropy not in ("host", "device"):
        raise ValueError(f"unknown entropy stage {entropy!r}")
    if entropy == "device" and (backend == "native" or cid != 1):
        raise ValueError("entropy='device' requires backend='torch'/"
                         "'exact64' and a turbo (v2) stream")
    meta = record_meta(enc)
    if backend == "native":
        with timed("decode.native"):
            return wn.decode_field(meta, enc.shape_zyx, coder=cid)
    if backend == "exact64":
        from .exact64 import decode_field_exact64
        with timed("decode.exact64"):
            return decode_field_exact64(meta, enc.shape_zyx, coder=cid,
                                        entropy=entropy, device=device)
    dev = _device(device)
    with timed("decode.torch"):
        return decode_device(meta, enc.shape_zyx, cid, entropy, dev)


def record_meta(enc) -> dict:
    """A record of either package as a dict (native's keys)."""
    return dict(tolabs=enc.tolabs, midval=enc.midval,
                halfspanval=enc.halfspanval, wlev=enc.wlev, nlay=enc.nlay,
                ntot_enc=enc.ntot_enc, deps_vec=enc.deps_vec,
                minval_vec=enc.minval_vec, len_enc_vec=enc.len_enc_vec,
                data=enc.data)


def decode_device(meta: dict, shape, cid: int, entropy: str,
                  dev: torch.device) -> np.ndarray:
    """The entropy decode, then the device step on `dev`, of a record
    given as a dict (native's keys); an f64 array."""
    if meta["ntot_enc"] == 0:
        return np.full(shape, meta["midval"])
    nl = int(meta["nlay"])
    n = int(np.prod(shape))
    lens = meta["len_enc_vec"][:nl]
    out = staging.host_result(shape, np.float64, dev)
    if entropy == "device":
        planes = rans.decode_planes_device(meta["data"], n, device=dev,
                                           lens=lens)
    else:
        planes = staging.to_device(wn.decode_planes_batch(
            meta["data"], lens, n, coder=cid), dev)
    spans = entropy == "device"
    with timed_if(spans, "decode.step"):
        fld = decode_planes(meta, planes, shape)
    with timed_if(spans, "decode.d2h"):
        return staging.to_numpy(fld, out)


def decode_planes(meta: dict, planes: torch.Tensor, shape) -> torch.Tensor:
    """The device step of a decode: the record's (nlay, n) symbol planes,
    on their device, to the (nz, ny, nx) field (a tensor there)."""
    nl, dev = int(meta["nlay"]), planes.device
    return decode_step(
        planes,
        torch.as_tensor(np.asarray(meta["deps_vec"][:nl], np.float64),
                        device=dev),
        torch.as_tensor(np.asarray(meta["minval_vec"][:nl], np.float64),
                        device=dev),
        shape, levels=int(meta["wlev"]))
