"""waverange_tpu_torch.ops.quant (plain torch path, CPU) against the JAX
package's quantizer and accumulate (XLA, and Pallas in interpret mode) and
the native codec."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waverange_tpu import native as wn
from waverange_tpu.ops import quant as JQ
from waverange_tpu.ops import quant_pallas as QP
from waverange_tpu_torch.ops import quant as TQ

from conftest import smooth_field


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX package's pallas_call through the interpreter."""
    orig = QP.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(QP.pl, "pallas_call", interp)


def _wavelet_field():
    a = smooth_field((24, 20, 16))
    return a, wn.wavelet3d(a.copy(), 4)


def test_quantize_layers_vs_jax():
    a, w = _wavelet_field()
    tolabs = 1e-7 * max(abs(a.min()), abs(a.max())) / 1.75
    jp, jd, jm, jn = JQ.quantize_layers(jnp.asarray(w.ravel()),
                                        jnp.float64(tolabs))
    tp, td, tm, tn = TQ.quantize_layers(torch.from_numpy(w.ravel().copy()),
                                        tolabs)
    nl = int(jn)
    assert int(tn) == nl
    assert np.array_equal(tp[:nl].numpy(), np.asarray(jp[:nl]))
    np.testing.assert_allclose(td[:nl].numpy(), np.asarray(jd[:nl]),
                               rtol=1e-12)


@pytest.mark.parametrize("tolrel", [1e-16, 1e-10, 1e-7, 1e-3])
def test_quantize_layers_vs_native(tolrel):
    a, w = _wavelet_field()
    tolabs = tolrel * max(abs(a.min()), abs(a.max())) / 1.75
    tp, td, tm, tn = TQ.quantize_layers(torch.from_numpy(w.ravel().copy()),
                                        tolabs)
    m = wn.encode_field(a.copy(), wtflag=1, cutoff=np.array([tolrel]))
    nl = int(tn)
    assert nl == m["nlay"]
    assert td[:nl].numpy().tobytes() == m["deps_vec"][:nl].tobytes()
    assert tm[:nl].numpy().tobytes() == m["minval_vec"][:nl].tobytes()
    payload, lens = wn.encode_planes_batch(tp[:nl].numpy())
    assert payload == m["data"]


def _f32_layers():
    # the inputs of test_pallas.py:test_fused_quantizer_matches_scan
    rng = np.random.default_rng(6)
    w = (rng.standard_normal(4096 * 8) * 5).astype(np.float32)
    return w, np.float32(2e-4)


def test_f32_bitwise_numpy_loop():
    # the quantizer's op sequence in numpy f32, no FMA anywhere
    w, tol = _f32_layers()
    tp, td, tm, tn = TQ.quantize_layers(torch.from_numpy(w.copy()),
                                        float(tol))
    v = w.copy()
    mn, mx = v.min(), v.max()
    for ilay in range(int(tn)):
        d = (mx - mn) / np.float32(255.0)
        last = d < tol
        d = tol if last else d
        a = np.float32(1.0) / d
        b = -mn * a + np.float32(0.5)
        q = np.floor(a * v + b).astype(np.uint8)
        assert np.array_equal(tp[ilay].numpy(), q)
        assert td[ilay].item() == d and tm[ilay].item() == mn
        v = v - (q.astype(np.float32) * d + mn)
        mn, mx = v.min(), v.max()
    assert last and int(tn) == 3


def test_f32_vs_pallas_interpret(interpret):
    # XLA contracts the residual update into an FMA (test_jax_ops.py
    # docstring), so after layer 0 the JAX f32 layers drift from the
    # port's by f32 rounding of the field: a few symbols per thousand flip
    # and deps/minv move by a few ulp of max|w|. Layer 0 and nlay agree.
    w, tol = _f32_layers()
    pp, pd, pm, pn = QP.quantize_layers_pallas(
        jnp.asarray(w), jnp.asarray(tol), jnp.asarray(255.0, jnp.float32))
    tp, td, tm, tn = TQ.quantize_layers(torch.from_numpy(w.copy()),
                                        float(tol))
    nl = int(pn)
    assert int(tn) == nl
    pp = np.asarray(pp[:nl])
    assert np.array_equal(tp[0].numpy(), pp[0])
    assert (tp[:nl].numpy() != pp).mean() < 1e-2
    ulp = np.finfo(np.float32).eps * np.abs(w).max()
    np.testing.assert_allclose(td[:nl].numpy(), np.asarray(pd[:nl]), rtol=0,
                               atol=4 * ulp)
    np.testing.assert_allclose(tm[:nl].numpy(), np.asarray(pm[:nl]), rtol=0,
                               atol=4 * ulp)


def test_accumulate_layers_order():
    # the numpy loop of test_jax_ops.py:test_accumulate_layers_order
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 256, (3, 100)).astype(np.uint8)
    deps = np.array([1.5, 0.25, 1e-3])
    minv = np.array([-7.0, 0.1, 3e-4])
    acc = TQ.accumulate_layers(torch.from_numpy(planes),
                               torch.from_numpy(deps), torch.from_numpy(minv))
    ref = np.zeros(100)
    for i in range(3):
        ref = ref + (planes[i].astype(np.float64) * deps[i] + minv[i])
    assert acc.numpy().tobytes() == ref.tobytes()


def test_accumulate_vs_pallas_interpret(interpret):
    rng = np.random.default_rng(7)
    nlay, n = 5, 4096 * 4
    planes = rng.integers(0, 256, (nlay, n)).astype(np.uint8)
    deps = rng.random(nlay).astype(np.float32)
    minv = rng.standard_normal(nlay).astype(np.float32)
    want = np.asarray(QP.accumulate_layers_pallas(
        jnp.asarray(planes), jnp.asarray(deps), jnp.asarray(minv)))
    got = TQ.accumulate_layers(torch.from_numpy(planes),
                               torch.from_numpy(deps), torch.from_numpy(minv))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_quant_layer_done_freezes_field(dtype):
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal(1000)).to(dtype)
    fld = w.clone()
    plane = torch.zeros(1000, dtype=torch.uint8)
    mn, mx = torch.aminmax(w)
    d = (mx - mn) / 255
    params = torch.stack([1 / d, -mn / d + 0.5, d, mn,
                          torch.ones((), dtype=dtype)])
    TQ.quant_layer(fld, plane, params)
    assert torch.equal(fld, w) and not plane.any()
    params[4] = 0
    rmn, rmx = TQ.quant_layer(fld, plane, params)
    assert plane.any() and rmn == fld.min() and rmx == fld.max()
    # the residual is below one quantization step
    assert float(fld.abs().max()) <= float(d)
