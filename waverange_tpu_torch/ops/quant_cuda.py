"""Wrappers of the CUDA quantizer kernels C (`quant_layer`) and D
(`accumulate`) in `csrc/quant.cu`.

Each wrapper checks its tensors, allocates outputs and scratch with
`torch.empty`, launches on the current CUDA stream of the tensors' device,
raises on a launch error, and adds one to its count in `LAUNCHES`. The
plain versions are `quant.quant_layer_plain` and
`quant.accumulate_layers_plain`.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"quant_layer": 0, "accumulate": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_THREADS = 256      # csrc/quant.cu kThreads
_MAX_BLOCKS = 2048  # min/max partials per layer


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def quant_layer(fld: torch.Tensor, plane: torch.Tensor,
                params: torch.Tensor):
    """Kernel C: one byte layer of the flat field `fld` (updated in place
    to the residual) into the uint8 `plane`, with `params` = (a, b, deps,
    mn, done) on the device. Returns the residual's (min, max) as 0-d
    tensors; they are undefined when `done` is set."""
    if fld.device.type != "cuda":
        raise ValueError(f"quant_layer: expected a CUDA tensor, got "
                         f"{fld.device}")
    if fld.dtype not in _SUFFIX:
        raise TypeError(f"quant_layer: dtype {fld.dtype} not supported "
                        "(float64 or float32)")
    n = fld.numel()
    if n < 1:
        raise ValueError("quant_layer: empty field")
    _check("quant_layer", fld, fld.device, fld.dtype, (n,))
    _check("quant_layer", plane, fld.device, torch.uint8, (n,))
    _check("quant_layer", params, fld.device, fld.dtype, (5,))
    nblocks = min(-(-n // _THREADS), _MAX_BLOCKS)
    pmin = torch.empty(nblocks, dtype=fld.dtype, device=fld.device)
    pmax = torch.empty(nblocks, dtype=fld.dtype, device=fld.device)
    fn = getattr(_build.load(), f"wr_quant_layer_{_SUFFIX[fld.dtype]}")
    stream = torch.cuda.current_stream(fld.device).cuda_stream
    _raise_on("quant_layer", fn(params.data_ptr(), fld.data_ptr(),
                                plane.data_ptr(), pmin.data_ptr(),
                                pmax.data_ptr(), n, nblocks,
                                fld.device.index, stream))
    LAUNCHES["quant_layer"] += 1
    return pmin.amin(), pmax.amax()


def accumulate(planes: torch.Tensor, deps: torch.Tensor,
               minv: torch.Tensor) -> torch.Tensor:
    """Kernel D: (nlay, n) uint8 planes -> (n,) sum of
    plane_i*deps_i + minv_i in layer order, in the dtype of `deps`."""
    if planes.device.type != "cuda":
        raise ValueError(f"accumulate: expected a CUDA tensor, got "
                         f"{planes.device}")
    if deps.dtype not in _SUFFIX:
        raise TypeError(f"accumulate: dtype {deps.dtype} not supported "
                        "(float64 or float32)")
    if planes.dim() != 2 or planes.shape[0] < 1 or planes.shape[1] < 1:
        raise ValueError(f"accumulate: expected (nlay, n) planes, got "
                         f"{tuple(planes.shape)}")
    nlay, n = planes.shape
    _check("accumulate", planes, planes.device, torch.uint8, (nlay, n))
    _check("accumulate", deps, planes.device, deps.dtype, (nlay,))
    _check("accumulate", minv, planes.device, deps.dtype, (nlay,))
    out = torch.empty(n, dtype=deps.dtype, device=planes.device)
    fn = getattr(_build.load(), f"wr_accumulate_{_SUFFIX[deps.dtype]}")
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    _raise_on("accumulate", fn(planes.data_ptr(), deps.data_ptr(),
                               minv.data_ptr(), nlay, n, out.data_ptr(),
                               planes.device.index, stream))
    LAUNCHES["accumulate"] += 1
    return out
