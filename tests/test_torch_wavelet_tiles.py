"""The tiling of the port's lifting kernels A and B, mirrored in plain torch
(`waverange_tpu_torch.ops.wavelet`): the tiled forms equal the whole-line
plain versions bit for bit; the level-wise entry points, their buffer plan
and the out-of-place forward transform equal the native C++ wavelet bit for
bit (f64) and the JAX function within the FMA envelope."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waverange_tpu import native as wn
from waverange_tpu.ops import wavelet as JW
from waverange_tpu_torch.ops import wavelet as TW

LENGTHS = [2, 3, 4, 5, 7, 8, 9, 31, 64, 130, 257]
TILES = [1, 2, 4, 16]
# the shapes of test_torch_wavelet.py: odd and length-1 axes included
SHAPES = [(16, 16, 16), (17, 13, 9), (32, 1, 7), (1, 1, 64), (5, 5, 5),
          (33, 31, 29)]
DTYPES = [torch.float64, torch.float32]


def _field(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a).to(dtype)


def _equal(a, b):
    return a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("n", LENGTHS)
def test_tiled_axis_equals_whole_line(n, tile, axis, dtype):
    ext = [3, 4, 5]
    ext[axis] = n
    shape = [e + 2 for e in ext]  # the sub-box lies inside a larger field
    x = _field(shape, dtype, seed=n)
    for tiled, plain in ((TW.lift_fwd_axis_tiled_plain,
                          TW.lift_fwd_axis_plain),
                         (TW.lift_inv_axis_tiled_plain,
                          TW.lift_inv_axis_plain)):
        a, b = x.clone(), x.clone()
        tiled(a, ext, axis, tile)
        plain(b, ext, axis)
        assert _equal(a, b), tiled.__name__


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 4), (4, 2), (16, 32)])
@pytest.mark.parametrize("ext", [(2, 2, 2), (3, 3, 3), (2, 5, 4), (3, 8, 9),
                                 (2, 31, 7), (1, 64, 66), (2, 67, 130),
                                 (1, 9, 257)])
def test_tiled_xy_equals_sweeps(ext, tiles, dtype):
    shape = [e + 1 for e in ext]
    x = _field(shape, dtype, seed=sum(ext))
    for tiled, axes, inverse in ((TW.lift_fwd_xy_tiled_plain, (2, 1), False),
                                 (TW.lift_inv_yx_tiled_plain, (1, 2), True)):
        a, b = torch.zeros_like(x), torch.zeros_like(x)
        keep = x.clone()
        tiled(x, a, ext, *tiles)
        TW.lift_pass_plain(x, b, ext, axes, inverse)
        assert _equal(a, b), tiled.__name__
        assert _equal(x, keep)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [1, 4])
def test_levels_f64_bitwise_native(shape, lvl):
    a = np.random.default_rng(2).standard_normal(shape)
    nw = wn.wavelet3d(a.copy(), lvl)
    # level by level, with the plain twins and with the planned passes
    for level in (TW.lift_fwd_level_plain, TW.lift_fwd_level):
        x = torch.from_numpy(a.copy())
        ext = shape
        for _ in range(lvl):
            level(x, ext)
            ext = tuple(-(-e // 2) for e in ext)
        assert x.numpy().tobytes() == nw.tobytes(), level.__name__
    ni = wn.wavelet3d(nw.copy(), -lvl)
    for level in (TW.lift_inv_level_plain, TW.lift_inv_level):
        x = torch.from_numpy(nw.copy())
        for k in range(lvl, 0, -1):
            level(x, tuple(-(-s // (1 << (k - 1))) for s in shape))
        assert x.numpy().tobytes() == ni.tobytes(), level.__name__


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [0, 1, 4])
def test_out_of_place_forward(shape, lvl):
    a = np.random.default_rng(6).standard_normal(shape)
    src = torch.from_numpy(a.copy())
    out = torch.full(shape, np.nan, dtype=torch.float64)
    got = TW.cdf97_forward(src, lvl, out=out)
    assert got is out
    assert src.numpy().tobytes() == a.tobytes()  # src is left unchanged
    assert out.numpy().tobytes() == wn.wavelet3d(a.copy(), lvl).tobytes()
    # XLA contracts FMAs: the envelope of test_jax_ops.py:46
    jw = np.asarray(jax.jit(JW.cdf97_3d, static_argnums=1)(jnp.asarray(a),
                                                           lvl))
    assert np.abs(out.numpy() - jw).max() <= 1e-13 * max(np.abs(jw).max(),
                                                         1.0)


PLAN_EXTENTS = [(8, 8, 8), (1, 1, 1), (1, 1, 9), (1, 7, 1), (6, 1, 1),
                (1, 2, 2), (2, 1, 2), (2, 2, 1), (2, 2, 2), (5, 1, 2)]


# in place forward and inverse; only the forward has an out-of-place form
@pytest.mark.parametrize("out_of_place,inverse", [(False, False),
                                                  (False, True),
                                                  (True, False)],
                         ids=["fwd", "inv", "fwd-out-of-place"])
@pytest.mark.parametrize("ext", PLAN_EXTENTS)
def test_level_plan_ends_in_field(ext, out_of_place, inverse, monkeypatch):
    shape = tuple(e + 1 for e in ext)
    if out_of_place:
        ext = shape  # the out-of-place level covers the whole field
    x0 = _field(shape, torch.float64, seed=7)
    src = x0.clone()
    field = (torch.full(shape, np.nan, dtype=torch.float64) if out_of_place
             else src)
    scratch = torch.full(shape, np.nan, dtype=torch.float64)
    names = {id(src): "src", id(field): "X", id(scratch): "S"}

    # record which pass reads and writes which buffer
    steps = []
    plain = TW.lift_pass

    def spy(a, b, extents, axes, inv):
        steps.append((tuple(axes), names[id(a)], names[id(b)]))
        plain(a, b, extents, axes, inv)

    monkeypatch.setattr(TW, "lift_pass", spy)
    if inverse:
        got = TW.lift_inv_level(field, ext, scratch)
    else:
        got = TW.lift_fwd_level(field, ext, scratch,
                                src if out_of_place else None)
    assert got is scratch

    passes = [axes for axes, _, _ in steps]
    assert passes == TW.level_passes(ext, inverse)
    lifted = [a for axes in passes for a in axes]
    order = [a for a in ((0, 1, 2) if inverse else (2, 1, 0)) if ext[a] > 1]
    assert lifted == order
    # every pass reads what the pass before wrote and never writes what it
    # reads; the first reads the source, and the source is never written
    holds = "X" if not out_of_place else "src"
    for _, a, b in steps:
        assert a == holds and b != a and b in ("X", "S")
        holds = b
    assert len(steps) < 2 or holds == "X"
    # the level ends in the field: it equals the plain sweeps, nothing
    # outside the sub-box changes, and the source is left alone
    want = x0.clone()
    (TW.lift_inv_level_plain if inverse else TW.lift_fwd_level_plain)(want,
                                                                     ext)
    assert _equal(field, want)
    if out_of_place:
        assert _equal(src, x0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_level_entry_touches_only_subbox(shape, dtype):
    ext = tuple(-(-s // 2) for s in shape)
    x0 = _field(shape, dtype, seed=8)
    for level, plain in ((TW.lift_fwd_level, TW.lift_fwd_level_plain),
                         (TW.lift_inv_level, TW.lift_inv_level_plain)):
        a, b = x0.clone(), x0.clone()
        level(a, ext)
        plain(b, ext)
        assert _equal(a, b), level.__name__


def test_wrapper_tile_constants_match_kernel_source():
    import re
    from pathlib import Path
    from waverange_tpu_torch.ops import wavelet_cuda as WC
    src = (Path(WC.__file__).resolve().parents[1] / "csrc"
           / "lift.cu").read_text()
    for pattern, want in ((r"constexpr int PX = (\d+);", WC.TILE_PX),
                          (r"constexpr int PY = (\d+);", WC.TILE_PY),
                          (r"constexpr int HALO = (\d+);", WC.HALO)):
        got = re.search(pattern, src)
        assert got and int(got.group(1)) == want, pattern
    assert WC.HALO == TW.HALO
    # a 64 x 32 x 64 f64 sub-box: xy tiles of 40 x 72 values, z tiles of
    # 40 x 64, and one write of the sub-box each
    n = 64 * 32 * 64
    assert WC.pass_bytes((64, 32, 64), (2, 1), 8) == 8 * (64 * 40 * 72 + n)
    assert WC.pass_bytes((64, 32, 64), (0,), 8) == 8 * (2 * 32 * 40 * 64 + n)
