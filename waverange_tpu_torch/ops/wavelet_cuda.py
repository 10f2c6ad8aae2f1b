"""Wrappers of the CUDA lifting kernels A (`lift_fwd_axis`) and B
(`lift_inv_axis`) in `csrc/lift.cu`.

A launch is one pass over the active sub-box, out of place: one axis, or x
and y fused (`lift_pass`). The wrapper checks its tensors, launches on the
current CUDA stream of their device, raises on a launch error, and adds
one to the kernel's count in `LAUNCHES` (A for a forward pass, B for an
inverse one). The plain version of a pass is `wavelet.lift_pass_plain`;
`wavelet.lift_fwd_level` / `lift_inv_level` run a level's passes between
the field and a scratch tensor.
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
# The tile of csrc/lift.cu (PX, PY, HALO there): output pairs along x and
# along the rows, and the pairs of halo on each side of a lifted axis.
TILE_PX, TILE_PY, HALO = 32, 16, 2


def pass_bytes(extents, axes, itemsize: int, inverse: bool = False) -> int:
    """Bytes one pass of kernel A or B moves: every tile's input with its
    halo, and the sub-box written once."""
    az, ay, ax = extents
    nc, nr, no = (ax, az, ay) if tuple(axes) == (0,) else (ax, ay, az)
    lx, ly = 2 in axes, tuple(axes) != (2,)
    hx = 16 // itemsize if inverse else HALO  # the inverse pads x to a vector
    cols = 2 * TILE_PX + (4 * hx if lx else 0)
    rows = 2 * TILE_PY + (4 * HALO if ly else 0)
    tiles = -(-nc // (2 * TILE_PX)) * -(-nr // (2 * TILE_PY)) * no
    return itemsize * (tiles * rows * cols + az * ay * ax)


# the kernel's code of a pass: the axes it lifts, in order
_FWD_AXES = {(0,): 0, (1,): 1, (2,): 2, (2, 1): 3}
_INV_AXES = {(0,): 0, (1,): 1, (2,): 2, (1, 2): 3}


def lift_pass(src: torch.Tensor, dst: torch.Tensor, extents, axes,
              inverse: bool) -> None:
    """Kernel A (or B, `inverse`): lift the active sub-box `extents` =
    (az, ay, ax) of the (nz, ny, nx) tensor `src` along `axes` (0 = z,
    1 = y, 2 = x; (2, 1) forward and (1, 2) inverse are x and y fused)
    into the same sub-box of `dst`, another tensor. Both have x
    contiguous; what lies outside the sub-box of `dst` is untouched."""
    name = "lift_inv_axis" if inverse else "lift_fwd_axis"
    for t in (src, dst):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dim() != 3 or t.stride(2) != 1:
            raise ValueError(f"{name}: expected (nz, ny, nx) tensors with x "
                             f"contiguous, got shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")
    if src.dtype not in _SUFFIX or dst.dtype != src.dtype:
        raise TypeError(f"{name}: dtypes {src.dtype}, {dst.dtype} not "
                        "supported (both float64 or both float32)")
    if dst.device != src.device:
        raise ValueError(f"{name}: tensors on {src.device} and {dst.device}")
    if (src.untyped_storage().data_ptr()
            == dst.untyped_storage().data_ptr()):
        raise ValueError(f"{name}: a pass works out of place; source and "
                         "destination share their memory")
    az, ay, ax = (int(e) for e in extents)
    for t in (src, dst):
        nz, ny, nx = t.shape
        if not (1 <= az <= nz and 1 <= ay <= ny and 1 <= ax <= nx):
            raise ValueError(f"{name}: sub-box {extents} outside "
                             f"{tuple(t.shape)}")
    code = (_INV_AXES if inverse else _FWD_AXES).get(tuple(axes))
    if code is None or any((az, ay, ax)[a] < 2 for a in axes):
        raise ValueError(f"{name}: axes {axes} of sub-box {extents} have no "
                         "line to lift")
    fn = getattr(_build.load(), f"wr_lift_pass_{_SUFFIX[src.dtype]}")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = fn(int(inverse), src.data_ptr(), dst.data_ptr(), src.stride(0),
             src.stride(1), dst.stride(0), dst.stride(1), az, ay, ax, code,
             ct.addressof(_CONSTS), src.device.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"(extents {extents}, axes {axes}, {src.dtype})")
    LAUNCHES[name] += 1


def _axis_in_place(x: torch.Tensor, extents, axis: int,
                   inverse: bool) -> None:
    az, ay, ax = (int(e) for e in extents)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("expected a contiguous (nz, ny, nx) tensor, got "
                         f"shape {tuple(x.shape)}")
    tmp = torch.empty((az, ay, ax), dtype=x.dtype, device=x.device)
    lift_pass(x, tmp, extents, (axis,), inverse)
    x[:az, :ay, :ax].copy_(tmp)


def lift_fwd_axis(x: torch.Tensor, extents, axis: int) -> None:
    """Kernel A on one axis: forward-lift every line of the active sub-box
    `extents` = (az, ay, ax) of the contiguous (nz, ny, nx) tensor `x`
    along `axis` (0 = z, 1 = y, 2 = x). The pass goes into a scratch
    sub-box made here and is copied back, so `x` is lifted in place."""
    _axis_in_place(x, extents, axis, False)


def lift_inv_axis(x: torch.Tensor, extents, axis: int) -> None:
    """Kernel B on one axis: the inverse sweep of `lift_fwd_axis`."""
    _axis_in_place(x, extents, axis, True)
