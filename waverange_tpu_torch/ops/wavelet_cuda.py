"""Wrappers of the CUDA lifting kernels A (`lift_fwd_axis`) and B
(`lift_inv_axis`) in `csrc/lift.cu`.

Each wrapper checks its tensor, launches on the current CUDA stream of the
tensor's device, raises on a launch error, and adds one to its count in
`LAUNCHES`. The plain versions are `wavelet.lift_fwd_axis_plain` and
`wavelet.lift_inv_axis_plain`.
"""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from .wavelet import EXT0, EXT1, EXT2, L0, L1, L2, L3, SCALE, SCALE_INV

LAUNCHES = {"lift_fwd_axis": 0, "lift_inv_axis": 0}

_CONSTS = (ct.c_double * 9)(L0, L1, L2, L3, SCALE, SCALE_INV, EXT0, EXT1,
                            EXT2)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _launch(name: str, cname: str, x: torch.Tensor, extents,
            axis: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float64 or float32)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (nz, ny, nx) "
                         f"tensor, got shape {tuple(x.shape)}")
    az, ay, ax = (int(e) for e in extents)
    nz, ny, nx = x.shape
    if not (1 <= az <= nz and 1 <= ay <= ny and 1 <= ax <= nx):
        raise ValueError(f"{name}: sub-box {extents} outside {tuple(x.shape)}")
    if axis not in (0, 1, 2) or (az, ay, ax)[axis] < 2:
        raise ValueError(f"{name}: axis {axis} of sub-box {extents} has no "
                         "line to lift")
    fn = getattr(_build.load(), f"{cname}_{_SUFFIX[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), nz, ny, nx, az, ay, ax, axis, ct.addressof(_CONSTS),
             x.device.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"(extents {extents}, axis {axis}, {x.dtype})")
    LAUNCHES[name] += 1


def lift_fwd_axis(x: torch.Tensor, extents, axis: int) -> None:
    """Kernel A: forward-lift, in place, every line of the active sub-box
    `extents` = (az, ay, ax) of the contiguous (nz, ny, nx) tensor `x`
    along `axis` (0 = z, 1 = y, 2 = x)."""
    _launch("lift_fwd_axis", "wr_lift_fwd", x, extents, axis)


def lift_inv_axis(x: torch.Tensor, extents, axis: int) -> None:
    """Kernel B: the inverse sweep of `lift_fwd_axis`, in place."""
    _launch("lift_inv_axis", "wr_lift_inv", x, extents, axis)
