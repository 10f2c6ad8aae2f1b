"""Byte-layer quantization and the codec's device steps on torch tensors.

Port of `waverange_tpu.ops.quant`. The reference quantizes the wavelet
field into successive 8-bit "byte layers" with residual refinement until
the quantization step drops below the absolute tolerance
(wrappers.cpp:305-441). All NLAYMAX=8 layers are launched speculatively
with a done latch held on the device, so the host reads the layer count
once, at the end, and never waits between layers. Layers past the count
are undefined and never read.

Dispatch goes by the tensor's device: a CPU tensor takes the plain torch
version, a CUDA tensor the hand-written kernel of `quant_cuda` (kernels C
and D), or raises. There is no fallback.

Bit-exactness (f64, and f32 against the native f32 pipeline):
  * min/max are exact in any reduction order (NaN-free data);
  * `(mx-mn)/255`, `1/deps` and `/1.75` are true divisions by device
    tensors (torch turns a division by a CPU scalar on CUDA into a
    multiplication by its reciprocal, which rounds differently);
  * quantize is trunc(a*v + b) with separate mul and add, the residual
    v - (q*deps + mn), and the decode-side accumulate keeps the
    sequential layer order (wr_native.cc:1471-1474, :2128).
"""
from __future__ import annotations

import torch

from .wavelet import cdf97_forward, cdf97_inverse

NLAYMAX = 8
QALPHABET = 255.0   # q - 1
WAV_ACC_COEF = 1.75  # tolerance derating (reference WAV_ACC_COEF)
DBL_MIN = 2.2250738585072014e-308
FLT_MIN = 1.1754943508222875e-38


def quant_layer_plain(fld: torch.Tensor, plane: torch.Tensor,
                      params: torch.Tensor):
    """Plain version of kernel C: one byte layer of the flat field `fld`
    (updated in place to the residual) into `plane`, with `params` =
    (a, b, deps, mn, done). Returns the residual's (min, max)."""
    a, b, deps, mn, done = params.unbind()
    if bool(done):  # the field is frozen after the tolerance break
        return torch.aminmax(fld)
    q = torch.floor(a * fld + b).to(torch.uint8)
    resid = fld - (q.to(fld.dtype) * deps + mn)
    plane.copy_(q)
    fld.copy_(resid)
    return torch.aminmax(resid)


def quant_layer(fld: torch.Tensor, plane: torch.Tensor,
                params: torch.Tensor):
    """One byte layer: the plain version for CPU tensors, kernel C for
    CUDA tensors."""
    if fld.device.type == "cuda":
        from . import quant_cuda
        return quant_cuda.quant_layer(fld, plane, params)
    if fld.device.type == "cpu":
        return quant_layer_plain(fld, plane, params)
    raise ValueError(f"unsupported device {fld.device}")


def quantize_layers(w: torch.Tensor, tolabs, reduce=None):
    """Quantize a flat wavelet field into up to 8 byte layers.

    `w` is the caller's working copy: it is overwritten with the residual.
    `tolabs` is the absolute tolerance (already derated by WAV_ACC_COEF).
    `reduce`, for a field split across processes (`w` is this process's
    part), maps a local (min, max) pair of 0-d tensors to the pair over
    the whole field (an all-reduce MIN/MAX). It is applied to the first
    min/max and to each layer's residual min/max before the next layer's
    parameters are formed, so every part is quantized with the whole
    field's parameters, as the single-process quantizer would quantize
    the whole. It runs on the device and returns device tensors: nothing
    waits on the host between layers.

    Returns planes (8, n) uint8, deps (8,), minv (8,) in the dtype of `w`,
    and nlay, a 0-d int32 tensor: the number of valid layers (1..8).
    Entries past nlay are undefined.
    """
    dtype, dev = w.dtype, w.device
    n = w.numel()
    tolabs = torch.as_tensor(tolabs, dtype=dtype, device=dev)
    qalpha = torch.tensor(QALPHABET, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    planes = torch.empty((NLAYMAX, n), dtype=torch.uint8, device=dev)
    deps = torch.empty(NLAYMAX, dtype=dtype, device=dev)
    minv = torch.empty(NLAYMAX, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    nlay = torch.zeros((), dtype=torch.int32, device=dev)
    mn, mx = torch.aminmax(w)
    for ilay in range(NLAYMAX):
        if reduce is not None:
            mn, mx = reduce(mn, mx)
        deps0 = (mx - mn) / qalpha
        hit_tol = deps0 < tolabs
        d = torch.where(hit_tol, tolabs, deps0)
        a = one / d
        b = -mn * a + 0.5
        deps[ilay] = d
        minv[ilay] = mn
        # A layer is emitted if we were not already done before it.
        nlay += (~done).to(torch.int32)
        params = torch.stack([a, b, d, mn, done.to(dtype)])
        mn, mx = quant_layer(w, planes[ilay], params)
        done = done | hit_tol | (ilay >= NLAYMAX - 1)
    return planes, deps, minv, nlay


def accumulate_layers_plain(planes: torch.Tensor, deps: torch.Tensor,
                            minv: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel D: sum the dequantized (nlay, n) planes in
    layer order (reference wrappers.cpp:512-514), in the dtype of `deps`."""
    acc = torch.zeros(planes.shape[1], dtype=deps.dtype,
                      device=planes.device)
    for i in range(planes.shape[0]):
        acc = acc + (planes[i].to(deps.dtype) * deps[i] + minv[i])
    return acc


def accumulate_layers(planes: torch.Tensor, deps: torch.Tensor,
                      minv: torch.Tensor) -> torch.Tensor:
    """Decode-side layer sum: the plain version for CPU tensors, kernel D
    for CUDA tensors."""
    if planes.device.type == "cuda":
        from . import quant_cuda
        return quant_cuda.accumulate(planes, deps, minv)
    if planes.device.type == "cpu":
        return accumulate_layers_plain(planes, deps, minv)
    raise ValueError(f"unsupported device {planes.device}")


def field_params(mn: torch.Tensor, mx: torch.Tensor, tolrel: float,
                 dtype: torch.dtype):
    """The field's scalars from its min and max (0-d tensors of `dtype`):
    (tolabs, midval, halfspanval, trivial), float64 0-d tensors but
    `trivial`, a bool flagging the constant-field exit
    (wrappers.cpp:257-266)."""
    mn64, mx64 = mn.to(torch.float64), mx.to(torch.float64)
    halfspanval = (mx64 - mn64) / 2
    midval = mn64 + halfspanval
    tiny = 2 * (DBL_MIN if dtype == torch.float64 else FLT_MIN)
    trivial = halfspanval <= tiny
    wav_acc = torch.tensor(WAV_ACC_COEF, dtype=torch.float64,
                           device=mn.device)
    tolabs = tolrel * torch.maximum(mn64.abs(), mx64.abs()) / wav_acc
    return tolabs, midval, halfspanval, trivial


def encode_step(fld: torch.Tensor, tolrel: float, wtflag: bool = True,
                levels: int = 4):
    """Device-side encode of an (nz, ny, nx) float64 or float32 field:
    stats, forward wavelet and byte layers. `fld` is left unchanged.

    Returns (planes, deps, minv, nlay, tolabs, midval, halfspanval,
    trivial) as tensors on the field's device, as
    `waverange_tpu.ops.quant.encode_step` does; the host codes
    planes[:nlay]. `trivial` flags the constant-field exit
    (wrappers.cpp:257-266), where the caller emits ntot_enc=0.

    As in the native codec, midval, halfspanval and tolabs are float64 for
    both dtypes, and the f32 layer schedule uses tolabs rounded to f32.
    """
    mn, mx = torch.aminmax(fld)
    tolabs, midval, halfspanval, trivial = field_params(mn, mx, tolrel,
                                                        fld.dtype)
    w = cdf97_forward(fld, levels if wtflag else 0,
                      out=torch.empty_like(
                          fld, memory_format=torch.contiguous_format))
    planes, deps, minv, nlay = quantize_layers(w.view(-1),
                                               tolabs.to(fld.dtype))
    return planes, deps, minv, nlay, tolabs, midval, halfspanval, trivial


def decode_step(planes: torch.Tensor, deps: torch.Tensor, minv: torch.Tensor,
                shape, levels: int = 4) -> torch.Tensor:
    """Device-side decode: accumulate (nlay, n) planes, then the inverse
    wavelet; returns an (nz, ny, nx) tensor in the dtype of `deps`."""
    acc = accumulate_layers(planes, deps, minv)
    return cdf97_inverse(acc.view(tuple(shape)), levels)
