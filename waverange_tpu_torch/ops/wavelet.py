"""Separable 3-D CDF 9/7 lifting wavelet on torch tensors.

Port of `waverange_tpu.ops.wavelet`. Each level sweeps x (the fastest
axis), then y, then z over the shrinking active sub-box of extent
ceil(n/2^k), exactly as the reference (waveletcdf97_3d.c:73-276).

Dispatch goes by the tensor's device: a CPU tensor takes the plain torch
version below, a CUDA tensor the hand-written kernel of
`wavelet_cuda` (kernels A and B), or raises. There is no fallback.

Unlike the JAX functions, the transforms overwrite the tensor they are
given: `cdf97_forward` and `cdf97_inverse` rewrite each active sub-box and
return the tensor (`cdf97_forward(x, levels, out=...)` leaves `x` alone
and fills `out`). A level is two passes, each reading one buffer and
writing another (forward: x and y fused, then z; inverse: z, then y and
x fused), so a transform works between the field and one scratch tensor
of its size, and every level ends in the field.

Bit-exactness: in f64 every lifting update is a separate torch multiply
and add, so the transform equals `waverange_tpu.native.wavelet3d` bit for
bit (the native library builds with -ffp-contract=off; the CUDA kernels
with --fmad=false). The boundary terms are edge-replicated sums, which
round as the reference's doubled end points: round(l*(v+v)) ==
round((2l)*v).
"""
from __future__ import annotations

import torch

# Lifting coefficients (CDF 9/7, Getreuer convention), the values of
# waverange_tpu/ops/wavelet.py:26-38 (reference waveletcdf97_3d.c:41-45).
L0 = -1.5861343420693648
L1 = -0.0529801185718856
L2 = 0.8829110755411875
L3 = 0.4435068520511142
SCALE = 1.1496043988602418
SCALE_INV = 0.8698644516247808
# Odd-length tail extrapolation coefficients.
EXT0 = -0.1637033860500999
EXT1 = 0.10320902946753098
EXT2 = 1.0604943565807747


def _halve(n: int) -> int:
    return n // 2 + (n % 2)


def _shift_down(v: torch.Tensor) -> torch.Tensor:
    """v[i+1] along the last axis, edge-replicated at the end."""
    return torch.cat([v[..., 1:], v[..., -1:]], dim=-1)


def _shift_up(v: torch.Tensor) -> torch.Tensor:
    """v[i-1] along the last axis, edge-replicated at the start."""
    return torch.cat([v[..., :1], v[..., :-1]], dim=-1)


def _lift_fwd_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward-lift all lines of `v` along `axis` (length > 1); returns a
    new tensor of the same shape."""
    v = v.movedim(axis, -1)
    n = v.shape[-1]
    m = _halve(n)
    lo = v[..., 0::2]
    hi = v[..., 1::2]
    if n % 2:
        # Extrapolate the missing odd tail sample.
        tail = (lo[..., m - 2:m - 1] * EXT0 + hi[..., m - 2:m - 1] * EXT1
                + lo[..., m - 1:m] * EXT2)
        hi = torch.cat([hi, tail], dim=-1)

    # Four lifting stages; boundary handling == edge replication.
    hi = hi + L0 * (_shift_down(lo) + lo)
    lo = lo + L1 * (hi + _shift_up(hi))
    hi = hi + L2 * (_shift_down(lo) + lo)
    lo = lo + L3 * (hi + _shift_up(hi))

    lo = lo * SCALE
    hi = hi * SCALE_INV
    if n % 2:  # the extrapolated sample is not stored
        hi = hi[..., :n - m]
    return torch.cat([lo, hi], dim=-1).movedim(-1, axis)


def _lift_inv_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse-lift all lines of `v` along `axis` (length > 1); returns a
    new tensor of the same shape."""
    v = v.movedim(axis, -1)
    n = v.shape[-1]
    q = _halve(n)
    lo = v[..., :q] * SCALE_INV
    hi = v[..., q:] * SCALE
    if n % 2:  # re-append the (zeroed) extrapolated sample slot
        hi = torch.cat([hi, torch.zeros_like(hi[..., :1])], dim=-1)

    lo = lo - L3 * (hi + _shift_up(hi))
    hi = hi - L2 * (_shift_down(lo) + lo)
    lo = lo - L1 * (hi + _shift_up(hi))
    hi = hi - L0 * (_shift_down(lo) + lo)

    # Re-interleave even/odd.
    out = torch.stack([lo, hi], dim=-1).flatten(-2)
    if n % 2:
        out = out[..., :n]
    return out.movedim(-1, axis)


def lift_fwd_axis_plain(x: torch.Tensor, extents, axis: int) -> None:
    """Plain version of kernel A for one axis: forward-lift, in place,
    every line of the active sub-box `extents` = (az, ay, ax) of `x` along
    `axis`."""
    az, ay, ax = extents
    sub = x[:az, :ay, :ax]
    sub.copy_(_lift_fwd_axis(sub, axis))


def lift_inv_axis_plain(x: torch.Tensor, extents, axis: int) -> None:
    """Plain version of kernel B for one axis: the inverse of
    `lift_fwd_axis_plain`."""
    az, ay, ax = extents
    sub = x[:az, :ay, :ax]
    sub.copy_(_lift_inv_axis(sub, axis))


def lift_fwd_level_plain(x: torch.Tensor, extents) -> None:
    """Plain version of one forward level: the plain sweeps of x, y and z
    over the active sub-box, in place."""
    for axis in (2, 1, 0):
        if extents[axis] > 1:
            lift_fwd_axis_plain(x, extents, axis)


def lift_inv_level_plain(x: torch.Tensor, extents) -> None:
    """Plain version of one inverse level: the plain sweeps of z, y and x."""
    for axis in (0, 1, 2):
        if extents[axis] > 1:
            lift_inv_axis_plain(x, extents, axis)


# ---------------------------------------------------------------------------
# The passes of a level. A pass lifts one axis, or x and y fused, of the
# active sub-box, reading one buffer and writing another.

def level_passes(extents, inverse: bool = False) -> list:
    """The passes of one level, each the tuple of axes it lifts in order.
    Forward: x and y fused (or the one of them that has a line), then z;
    inverse: the mirror."""
    plane = tuple(a for a in (2, 1) if extents[a] > 1)
    fwd = ([plane] if plane else []) + ([(0,)] if extents[0] > 1 else [])
    if not inverse:
        return fwd
    return [p[::-1] for p in reversed(fwd)]


def lift_pass_plain(src: torch.Tensor, dst: torch.Tensor, extents, axes,
                    inverse: bool) -> None:
    """Plain version of one pass of kernel A or B: the plain sweeps of
    `axes`, in order, from the sub-box of `src` into that of `dst`."""
    az, ay, ax = extents
    sub = src[:az, :ay, :ax]
    for axis in axes:
        sub = (_lift_inv_axis if inverse else _lift_fwd_axis)(sub, axis)
    dst[:az, :ay, :ax].copy_(sub)


def lift_pass(src: torch.Tensor, dst: torch.Tensor, extents, axes,
              inverse: bool) -> None:
    """One pass: the plain version for CPU tensors, kernel A or B for CUDA
    tensors."""
    if src.device.type == "cuda":
        from . import wavelet_cuda
        wavelet_cuda.lift_pass(src, dst, extents, axes, inverse)
    elif src.device.type == "cpu":
        lift_pass_plain(src, dst, extents, axes, inverse)
    else:
        raise ValueError(f"unsupported device {src.device}")


def _run_level(src, field, scratch, extents, inverse):
    """The passes of one level, from `src` (the field itself, or another
    tensor that is left unchanged) into `field`; returns the scratch
    tensor, made here when a pass needs it. Two passes go through the
    scratch; a single pass from the field itself goes there and is copied
    back, so every level ends in the field."""
    passes = level_passes(extents, inverse)
    az, ay, ax = extents
    if scratch is None and (len(passes) == 2
                            or (passes and src is field)):
        scratch = torch.empty_like(field)
    if len(passes) == 2:
        lift_pass(src, scratch, extents, passes[0], inverse)
        lift_pass(scratch, field, extents, passes[1], inverse)
    elif passes and src is field:
        lift_pass(field, scratch, extents, passes[0], inverse)
        field[:az, :ay, :ax].copy_(scratch[:az, :ay, :ax])
    elif passes:
        lift_pass(src, field, extents, passes[0], inverse)
    elif src is not field:
        field[:az, :ay, :ax].copy_(src[:az, :ay, :ax])
    return scratch


def lift_fwd_level(x: torch.Tensor, extents, scratch=None, src=None):
    """One forward level of the active sub-box `extents` of `x`: x and y
    in one pass, then z, between `x` and a scratch tensor of its shape
    (made here if None and needed). The result is in `x`; what lies
    outside the sub-box is untouched. With `src`, a tensor of x's shape
    whose sub-box covers it, the level reads `src`, leaves it unchanged
    and writes `x`. Returns the scratch tensor, for the next level."""
    return _run_level(x if src is None else src, x, scratch, extents,
                      False)


def lift_inv_level(x: torch.Tensor, extents, scratch=None):
    """One inverse level: z, then y and x in one pass; as
    `lift_fwd_level`."""
    return _run_level(x, x, scratch, extents, True)


def lift_fwd_axis(x: torch.Tensor, extents, axis: int) -> None:
    """Forward sweep of one axis of the active sub-box, in place: the plain
    version for a CPU tensor, kernel A for a CUDA tensor."""
    if x.device.type == "cuda":
        from . import wavelet_cuda
        wavelet_cuda.lift_fwd_axis(x, extents, axis)
    elif x.device.type == "cpu":
        lift_fwd_axis_plain(x, extents, axis)
    else:
        raise ValueError(f"unsupported device {x.device}")


def lift_inv_axis(x: torch.Tensor, extents, axis: int) -> None:
    """Inverse sweep of one axis of the active sub-box, in place: the plain
    version for a CPU tensor, kernel B for a CUDA tensor."""
    if x.device.type == "cuda":
        from . import wavelet_cuda
        wavelet_cuda.lift_inv_axis(x, extents, axis)
    elif x.device.type == "cpu":
        lift_inv_axis_plain(x, extents, axis)
    else:
        raise ValueError(f"unsupported device {x.device}")


def cdf97_forward(x: torch.Tensor, levels: int, out=None) -> torch.Tensor:
    """Forward multiresolution transform of an (nz, ny, nx) tensor. With
    `out` None it works in place and returns `x`; with `out`, a tensor of
    x's shape and type, the first pass reads `x`, `x` stays unchanged and
    `out` is returned."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    src, field = (None, x) if out is None else (x, out)
    if src is not None and levels < 1:
        out.copy_(x)
    scratch = None
    az, ay, ax = x.shape
    for _ in range(levels):
        scratch = lift_fwd_level(field, (az, ay, ax), scratch, src)
        src = None
        az, ay, ax = _halve(az), _halve(ay), _halve(ax)
    return field


def cdf97_inverse(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse transform, in place: coarsest level first, axes z then y
    then x on the sub-box of extent ceil(n/2^(k-1)); returns `x`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    nz, ny, nx = x.shape
    scratch = None
    for k in range(levels, 0, -1):
        p = 1 << (k - 1)
        ext = (-(-nz // p), -(-ny // p), -(-nx // p))
        scratch = lift_inv_level(x, ext, scratch)
    return x


def cdf97_3d(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Reference-style signed-level entry: >0 forward, <0 inverse."""
    if levels >= 0:
        return cdf97_forward(x, levels)
    return cdf97_inverse(x, -levels)


# ---------------------------------------------------------------------------
# The tiling of kernels A and B, mirrored in plain torch from the kernels'
# index formulas (csrc/lift.cu): a tile of `tile` output pairs reads its
# window of pairs j0-HALO .. j1+HALO-1, positions outside the line mirrored
# into it (whole-sample symmetric extension, which is what the lifting's
# edge replication amounts to), and every output pair comes from its window
# of five input pairs alone. The results equal the whole-line plain
# versions bit for bit.

HALO = 2  # pairs of halo on each side of a tile


def _mirror(p: torch.Tensor, last: int) -> torch.Tensor:
    """Positions p mirrored into [0, last] (repeatedly, for short lines)."""
    while bool(((p < 0) | (p > last)).any()):
        p = torch.where(p < 0, -p, torch.where(p > last, 2 * last - p, p))
    return p


def _window(j0: int, j1: int, last: int) -> torch.Tensor:
    """Sample positions of the window of pairs j0..j1-1 with its halo."""
    return _mirror(torch.arange(2 * (j0 - HALO), 2 * (j1 + HALO)), last)


def _tail(v: torch.Tensor) -> torch.Tensor:
    """The extrapolated tail sample of the odd-length lines of v."""
    return v[..., -3:-2] * EXT0 + v[..., -2:-1] * EXT1 + v[..., -1:] * EXT2


def _fwd_stencil(w: torch.Tensor):
    """Forward-lift the T inner pairs of a window of T + 2*HALO interleaved
    pairs (last axis); returns (lo, hi), scaled."""
    lo, hi = w[..., 0::2], w[..., 1::2]
    h1 = hi[..., :-1] + L0 * (lo[..., 1:] + lo[..., :-1])
    l1 = lo[..., 1:-1] + L1 * (h1[..., 1:] + h1[..., :-1])
    h2 = h1[..., 1:-1] + L2 * (l1[..., 1:] + l1[..., :-1])
    l2 = l1[..., 1:-1] + L3 * (h2[..., 1:] + h2[..., :-1])
    return l2 * SCALE, h2[..., 1:] * SCALE_INV


def _inv_stencil(w: torch.Tensor) -> torch.Tensor:
    """Inverse-lift the T inner pairs of a window of T + 2*HALO interleaved
    (lo, hi) coefficient pairs; returns the 2T interleaved samples."""
    lo, hi = w[..., 0::2] * SCALE_INV, w[..., 1::2] * SCALE
    l1 = lo[..., 1:] - L3 * (hi[..., 1:] + hi[..., :-1])
    h1 = hi[..., 1:-1] - L2 * (l1[..., 1:] + l1[..., :-1])
    l2 = l1[..., 1:-1] - L1 * (h1[..., 1:] + h1[..., :-1])
    h2 = h1[..., 1:-1] - L0 * (l2[..., 1:] + l2[..., :-1])
    return torch.stack([l2[..., :-1], h2], dim=-1).flatten(-2)


def _inv_columns(j0: int, j1: int, n: int) -> torch.Tensor:
    """Where the window of pairs j0..j1-1 lies in a stored [lo | hi] line
    of length n, interleaved; index n is the zero slot of an odd line."""
    q = _halve(n)
    pos = _window(j0, j1, 2 * q - 1)
    return torch.where(pos % 2 == 1, q + pos // 2, pos // 2)


def _put_fwd(out, lo, hi, j0, j1, n):
    """Store a tile's pairs j0..j1-1 into the [lo | hi] line `out`."""
    m = _halve(n)
    out[..., j0:j1] = lo
    k = min(j1, n - m)  # the tail's hi is not stored
    out[..., m + j0:m + k] = hi[..., :k - j0]


def lift_fwd_axis_tiled_plain(x: torch.Tensor, extents, axis: int,
                              tile: int) -> None:
    """`lift_fwd_axis_plain`, computed tile by tile as kernel A does, with
    `tile` output pairs a tile."""
    az, ay, ax = extents
    sub = x[:az, :ay, :ax]
    v = sub.movedim(axis, -1)
    n = v.shape[-1]
    m = _halve(n)
    out = torch.empty_like(v)
    if n % 2:
        v = torch.cat([v, _tail(v)], dim=-1)
    for j0 in range(0, m, tile):
        j1 = min(j0 + tile, m)
        lo, hi = _fwd_stencil(v[..., _window(j0, j1, 2 * m - 1)])
        _put_fwd(out, lo, hi, j0, j1, n)
    sub.copy_(out.movedim(-1, axis))


def lift_inv_axis_tiled_plain(x: torch.Tensor, extents, axis: int,
                              tile: int) -> None:
    """`lift_inv_axis_plain`, computed tile by tile as kernel B does."""
    az, ay, ax = extents
    sub = x[:az, :ay, :ax]
    v = sub.movedim(axis, -1)
    n = v.shape[-1]
    out = torch.empty_like(v)
    v = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    for j0 in range(0, _halve(n), tile):
        j1 = min(j0 + tile, _halve(n))
        w = _inv_stencil(v[..., _inv_columns(j0, j1, n)])
        k = min(2 * j1, n)
        out[..., 2 * j0:k] = w[..., :k - 2 * j0]
    sub.copy_(out.movedim(-1, axis))


def lift_fwd_xy_tiled_plain(src: torch.Tensor, dst: torch.Tensor, extents,
                            tile_y: int, tile_x: int) -> None:
    """The fused forward pass of x and y as kernel A tiles it: every row of
    a (y, x) tile, halo rows too, is lifted along x; the tail row of an odd
    y extent is made from the three x-lifted rows before it; then the
    columns are lifted along y. Reads the sub-box of `src`, writes that of
    `dst`."""
    az, ay, ax = extents
    s = src[:az, :ay, :ax]
    my, mx = _halve(ay), _halve(ax)
    out = torch.empty_like(s)
    if ax % 2:
        s = torch.cat([s, _tail(s)], dim=-1)
    for jy0 in range(0, my, tile_y):
        jy1 = min(jy0 + tile_y, my)
        rows = _window(jy0, jy1, 2 * my - 1)
        for jx0 in range(0, mx, tile_x):
            jx1 = min(jx0 + tile_x, mx)
            t = s[:, rows.clamp(max=ay - 1)][..., _window(jx0, jx1,
                                                          2 * mx - 1)]
            mid = torch.cat(_fwd_stencil(t), dim=-1)
            if bool((rows == ay).any()):
                a = ay - 3 - 2 * (jy0 - HALO)  # local row of sample ay-3
                tail = (mid[:, a] * EXT0 + mid[:, a + 1] * EXT1
                        + mid[:, a + 2] * EXT2)
                mid[:, rows == ay] = tail[:, None]
            lo, hi = _fwd_stencil(mid.movedim(1, -1))
            # columns of `mid`: [x lo of pairs jx0..jx1-1 | x hi]
            tx = jx1 - jx0
            kx = min(jx1, ax - mx) - jx0
            for part, c0, w in ((slice(0, tx), jx0, tx),
                                (slice(tx, tx + kx), mx + jx0, kx)):
                _put_fwd(out[:, :, c0:c0 + w].movedim(1, -1),
                         lo[:, part], hi[:, part], jy0, jy1, ay)
    dst[:az, :ay, :ax].copy_(out)


def lift_inv_yx_tiled_plain(src: torch.Tensor, dst: torch.Tensor, extents,
                            tile_y: int, tile_x: int) -> None:
    """The fused inverse pass of y and x as kernel B tiles it: the columns
    of a tile, halo columns too, are lifted along y, then its rows along
    x."""
    az, ay, ax = extents
    s = src[:az, :ay, :ax]
    out = torch.empty_like(s)
    s = torch.cat([s, torch.zeros_like(s[:, :, :1])], dim=2)
    s = torch.cat([s, torch.zeros_like(s[:, :1])], dim=1)
    for jy0 in range(0, _halve(ay), tile_y):
        jy1 = min(jy0 + tile_y, _halve(ay))
        rows = _inv_columns(jy0, jy1, ay)
        for jx0 in range(0, _halve(ax), tile_x):
            jx1 = min(jx0 + tile_x, _halve(ax))
            cols = _inv_columns(jx0, jx1, ax)
            t = s[:, rows][..., cols]
            mid = _inv_stencil(t.movedim(1, -1)).movedim(-1, 1)
            w = _inv_stencil(mid)
            ky, kx = min(2 * jy1, ay), min(2 * jx1, ax)
            out[:, 2 * jy0:ky, 2 * jx0:kx] = w[:, :ky - 2 * jy0,
                                               :kx - 2 * jx0]
    dst[:az, :ay, :ax].copy_(out)
