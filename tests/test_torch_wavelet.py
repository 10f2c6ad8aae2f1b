"""waverange_tpu_torch.ops.wavelet (plain torch path, CPU) against the native
C++ wavelet (bitwise), the JAX package's XLA wavelet (FMA envelope) and its
Pallas kernels in interpret mode (f32)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waverange_tpu import native as wn
from waverange_tpu.ops import wavelet as JW
from waverange_tpu.ops import wavelet_pallas as WP
from waverange_tpu_torch.ops import wavelet as TW

# the shapes of test_jax_ops.py: odd and length-1 axes included
SHAPES = [(16, 16, 16), (17, 13, 9), (32, 1, 7), (1, 1, 64), (5, 5, 5),
          (33, 31, 29)]


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX package's pallas_call through the interpreter."""
    orig = WP.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(WP.pl, "pallas_call", interp)


def test_constants_equal_jax_package():
    for name in ("L0", "L1", "L2", "L3", "SCALE", "SCALE_INV", "EXT0", "EXT1",
                 "EXT2"):
        assert getattr(TW, name) == getattr(JW, name), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [1, 4])
def test_f64_bitwise_native(shape, lvl):
    a = np.random.default_rng(2).standard_normal(shape)
    nw = wn.wavelet3d(a.copy(), lvl)
    tw = TW.cdf97_forward(torch.from_numpy(a.copy()), lvl).numpy()
    assert tw.tobytes() == nw.tobytes()
    ni = wn.wavelet3d(nw.copy(), -lvl)
    ti = TW.cdf97_inverse(torch.from_numpy(nw.copy()), lvl).numpy()
    assert ti.tobytes() == ni.tobytes()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [1, 4])
def test_f64_close_to_jax(shape, lvl):
    # XLA contracts FMAs: the envelope of test_jax_ops.py:46
    a = np.random.default_rng(3).standard_normal(shape)
    f = jax.jit(JW.cdf97_3d, static_argnums=1)
    jw = np.asarray(f(jnp.asarray(a), lvl))
    tw = TW.cdf97_forward(torch.from_numpy(a.copy()), lvl).numpy()
    assert np.abs(tw - jw).max() <= 1e-13 * max(np.abs(jw).max(), 1.0)
    ji = np.asarray(f(jnp.asarray(jw), -lvl))
    ti = TW.cdf97_inverse(torch.from_numpy(jw.copy()), lvl).numpy()
    assert np.abs(ti - ji).max() <= 1e-13 * max(np.abs(ji).max(), 1.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", [1, 4])
def test_roundtrip(shape, lvl):
    a = np.random.default_rng(1).standard_normal(shape)
    w = TW.cdf97_3d(torch.from_numpy(a.copy()), lvl)
    r = TW.cdf97_3d(w, -lvl).numpy()
    assert np.abs(r - a).max() < 1e-12


@pytest.mark.parametrize("shape", [(8, 8, 256), (4, 16, 512), (4, 4, 130),
                                   (16, 32, 128)])
def test_f32_vs_pallas_interpret(shape, interpret):
    rng = np.random.default_rng(5)
    a = rng.standard_normal(shape).astype(np.float32)
    pw = np.asarray(WP.cdf97_forward_pallas(jnp.asarray(a), 2))
    tw = TW.cdf97_forward(torch.from_numpy(a.copy()), 2)
    np.testing.assert_allclose(tw.numpy(), pw, rtol=1e-5, atol=1e-5)
    pi = np.asarray(WP.cdf97_inverse_pallas(jnp.asarray(pw), 2))
    ti = TW.cdf97_inverse(torch.from_numpy(pw.copy()), 2).numpy()
    np.testing.assert_allclose(ti, pi, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_sweep_touches_only_subbox(axis):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((9, 10, 11))
    ext = (5, 5, 6)
    for sweep, ref in ((TW.lift_fwd_axis, JW._lift_fwd_axis),
                       (TW.lift_inv_axis, JW._lift_inv_axis)):
        x = torch.from_numpy(a.copy())
        sweep(x, ext, axis)
        got = x.numpy()
        inside = np.zeros(a.shape, bool)
        inside[:5, :5, :6] = True
        assert np.array_equal(got[~inside], a[~inside])
        want = np.asarray(ref(jnp.asarray(a[:5, :5, :6]), axis))
        np.testing.assert_allclose(got[:5, :5, :6], want, rtol=0,
                                   atol=1e-13 * np.abs(want).max())


def test_unsupported_device_raises():
    x = torch.empty((4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TW.cdf97_forward(x, 1)
