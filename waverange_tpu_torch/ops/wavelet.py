"""Separable 3-D CDF 9/7 lifting wavelet on torch tensors.

Port of `waverange_tpu.ops.wavelet`. Each level sweeps x (the fastest
axis), then y, then z over the shrinking active sub-box of extent
ceil(n/2^k), exactly as the reference (waveletcdf97_3d.c:73-276).

Dispatch goes by the tensor's device: a CPU tensor takes the plain torch
version below, a CUDA tensor the hand-written kernel of
`wavelet_cuda` (kernels A and B), or raises. There is no fallback.

Unlike the JAX functions, the transforms work in place: `cdf97_forward`
and `cdf97_inverse` overwrite each active sub-box of the tensor they are
given and return it. Callers pass their own working copy.

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
    """Plain version of kernel A: forward-lift, in place, every line of the
    active sub-box `extents` = (az, ay, ax) of `x` along `axis`."""
    az, ay, ax = extents
    sub = x[:az, :ay, :ax]
    sub.copy_(_lift_fwd_axis(sub, axis))


def lift_inv_axis_plain(x: torch.Tensor, extents, axis: int) -> None:
    """Plain version of kernel B: the inverse of `lift_fwd_axis_plain`."""
    az, ay, ax = extents
    sub = x[:az, :ay, :ax]
    sub.copy_(_lift_inv_axis(sub, axis))


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


def cdf97_forward(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Forward multiresolution transform of an (nz, ny, nx) tensor, in
    place; returns `x`."""
    az, ay, ax = x.shape
    for _ in range(levels):
        ext = (az, ay, ax)
        if ax > 1:
            lift_fwd_axis(x, ext, 2)
        if ay > 1:
            lift_fwd_axis(x, ext, 1)
        if az > 1:
            lift_fwd_axis(x, ext, 0)
        az, ay, ax = _halve(az), _halve(ay), _halve(ax)
    return x


def cdf97_inverse(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse transform, in place: coarsest level first, axes z then y
    then x on the sub-box of extent ceil(n/2^(k-1)); returns `x`."""
    nz, ny, nx = x.shape
    for k in range(levels, 0, -1):
        p = 1 << (k - 1)
        az, ay, ax = (-(-nz // p), -(-ny // p), -(-nx // p))
        ext = (az, ay, ax)
        if az > 1:
            lift_inv_axis(x, ext, 0)
        if ay > 1:
            lift_inv_axis(x, ext, 1)
        if ax > 1:
            lift_inv_axis(x, ext, 2)
    return x


def cdf97_3d(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Reference-style signed-level entry: >0 forward, <0 inverse."""
    if levels >= 0:
        return cdf97_forward(x, levels)
    return cdf97_inverse(x, -levels)
