"""The bit-exact f64 codec backend on the device (`backend="exact64"`).

Port of `waverange_tpu.core.exact64`. Its contract: streams and decoded
fields bit-identical to the native C++ pipeline, computed on the device.
The reference meets it on TPUs, which have no f64, with software IEEE
binary64 built from u32 operations (`waverange_tpu/ops/softf64.py`). The
H100 has IEEE f64, and the torch backend's f64 path (kernels A-D, built
without FMA contraction, and E-H for `entropy="device"`) already is
bit-identical to native. So this backend is that path with the input
widened to f64; there is no soft-f64 here.

Where the port differs from the JAX `exact64`, it follows native:
  * the trivial (constant) field's record has wlev 4 when `wtflag` is
    set, as native writes it (wr_native.cc:1936); the JAX `exact64`
    writes 0 (waverange_tpu/core/exact64.py:132);
  * the codec passes a uniform `cutoff` in place of `tolrel`, as native
    takes it; the JAX codec gives `exact64` `tolrel` only
    (waverange_tpu/core/codec.py:193-195).

The codec times this backend as the stages `encode.exact64` and
`decode.exact64` (`utils.diag`). The JAX `exact64` also times its inner
stages (`exact64.pack_upload`, `.wavelet`, `.layers`, `.entropy`,
waverange_tpu/core/exact64.py:134-170); they time the software-f64 work,
which has no counterpart here, so they are not mirrored.
"""
from __future__ import annotations

import numpy as np

from .codec import WAV_LVL, _device, decode_device, encode_device


def encode_field_exact64(fld: np.ndarray, tolrel: float, wtflag: int = 1,
                         levels: int = WAV_LVL, coder: int = 1,
                         entropy: str = "device", device="cuda") -> dict:
    """Encode one (nz, ny, nx) field in f64 on `device`; bit-identical
    metadata, planes and (given the same coder) streams as
    `native.encode_field`. Returns the record as a dict (native's keys)."""
    return encode_device(np.ascontiguousarray(fld, np.float64), tolrel,
                         wtflag, levels, coder, entropy, _device(device))


def decode_field_exact64(meta: dict, shape, coder: int = 1,
                         entropy: str = "device", device="cuda"
                         ) -> np.ndarray:
    """Decode a record given as a dict on `device`; an f64 array
    bit-identical to `native.decode_field`."""
    return decode_device(meta, tuple(shape), coder, entropy,
                         _device(device))
