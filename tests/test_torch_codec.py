"""waverange_tpu_torch.core.codec on the CPU (plain torch path) against the
native codec (byte-identical streams, bit-identical decode) and the JAX
device path, with the host entropy coder and with the port's device rANS
coder (`entropy="device"`)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waverange_tpu import native as wn
from waverange_tpu.core import codec as JC
from waverange_tpu.ops import quant as JQ
from waverange_tpu_torch.core import codec as TC
from waverange_tpu_torch.ops import quant as TQ

from conftest import smooth_field

FIELDS = ["data", "nlay", "ntot_enc", "wlev", "tolabs", "midval",
          "halfspanval", "coder_version"]


def assert_same_stream(e, r):
    for f in FIELDS:
        assert getattr(e, f) == getattr(r, f), f
    for f in ("deps_vec", "minval_vec", "len_enc_vec"):
        assert getattr(e, f).tobytes() == getattr(r, f).tobytes(), f


@pytest.mark.parametrize("shape", [(32, 24, 20), (33, 31, 29), (32, 32, 32)])
@pytest.mark.parametrize("tol", [1e-16, 1e-10, 1e-7, 1e-3])
def test_stream_identical_to_native(shape, tol):
    a = smooth_field(shape)
    e = TC.encode_field(a, tol, device="cpu")
    r = JC.encode_field(a, tol, backend="native")
    assert_same_stream(e, r)
    d = TC.decode_field(r, device="cpu")
    assert d.tobytes() == JC.decode_field(r, backend="native").tobytes()


@pytest.mark.parametrize("tol", [1e-7, 1e-3])
def test_stream_identical_to_jax(tol):
    # the moderate tolerances where the JAX path matches native
    # (test_jax_ops.py:84-91)
    a = smooth_field((32, 24, 20))
    e = TC.encode_field(a, tol, device="cpu")
    j = JC.encode_field(a, tol, backend="jax")
    assert e.nlay == j.nlay and e.data == j.data and e.tolabs == j.tolabs


def test_trivial_field():
    a = np.full((8, 8, 8), 42.0)
    e = TC.encode_field(a, 1e-6, device="cpu")
    assert_same_stream(e, JC.encode_field(a, 1e-6, backend="native"))
    assert e.ntot_enc == 0 and e.nlay == 0
    assert np.array_equal(TC.decode_field(e, device="cpu"), a)


def test_wtflag0_matches_native():
    a = smooth_field((16, 16, 16))
    e = TC.encode_field(a, 1e-5, wtflag=0, device="cpu")
    r = JC.encode_field(a, 1e-5, wtflag=0, backend="native")
    assert e.wlev == 0
    assert_same_stream(e, r)
    assert (TC.decode_field(e, device="cpu").tobytes()
            == JC.decode_field(r, backend="native").tobytes())


def test_rans_coder_matches_native():
    a = smooth_field((24, 20, 16))
    e = TC.encode_field(a, 1e-8, coder="rans", device="cpu")
    r = JC.encode_field(a, 1e-8, coder="rans", backend="native")
    assert e.coder_version == JC.CODER_VERSION_TURBO
    assert_same_stream(e, r)
    assert (TC.decode_field(e, device="cpu").tobytes()
            == JC.decode_field(r, backend="native").tobytes())


def test_cutoff_replaces_tolrel():
    a = smooth_field((16, 16, 16))
    e = TC.encode_field(a, 1e-3, cutoff=np.array([1e-9]), device="cpu")
    r = JC.encode_field(a, 1e-3, cutoff=np.array([1e-9]), backend="native")
    assert_same_stream(e, r)


def test_f32_native_precision_matches_native_f32():
    a32 = smooth_field((32, 24, 16)).astype(np.float32)
    e = TC.encode_field(a32, 1e-4, precision="native", device="cpu")
    r = JC.encode_field(a32, 1e-4, precision="native", backend="native")
    assert_same_stream(e, r)
    d = TC.decode_field(e, device="cpu")
    err = np.abs(d - a32.astype(np.float64)).max()
    assert err <= 1.3e-4 * np.abs(a32).max() + 1e-5 * np.abs(a32).max()


def test_f32_floor_refused_under_strict():
    a32 = smooth_field((8, 8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="error floor"):
        TC.encode_field(a32, 1e-9, precision="native", device="cpu")
    e = TC.encode_field(a32, 1e-9, precision="native",
                        conformance="degraded", device="cpu")
    assert e.nlay >= 1


def _jax_step(a, tol):
    out = JQ.encode_step(jnp.asarray(a), jnp.asarray(tol, jnp.float64))
    return [np.asarray(o) for o in out]


def test_jax_encode_step_to_port_decode_step():
    a = smooth_field((20, 18, 16))
    planes, deps, minv, nlay, tolabs, midval, hsv, trivial = (
        TC.state_from_numpy(*_jax_step(a, 1e-9), device="cpu"))
    assert planes.dtype == torch.uint8 and deps.dtype == torch.float64
    assert nlay.dtype == torch.int32 and trivial.dtype == torch.bool
    nl = int(nlay)
    got = TQ.decode_step(planes[:nl], deps[:nl], minv[:nl], a.shape).numpy()
    want = np.asarray(JQ.decode_step(
        jnp.asarray(planes[:nl].numpy()), jnp.asarray(deps[:nl].numpy()),
        jnp.asarray(minv[:nl].numpy()), shape=a.shape))
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    assert np.abs(got - a).max() <= 1.3e-9 * np.abs(a).max()


def test_port_encode_step_to_jax_decode_step():
    a = smooth_field((20, 18, 16))
    planes, deps, minv, nlay, *_ = TQ.encode_step(torch.from_numpy(a), 1e-9)
    nl = int(nlay)
    want = TQ.decode_step(planes[:nl], deps[:nl], minv[:nl], a.shape).numpy()
    got = np.asarray(JQ.decode_step(
        jnp.asarray(planes[:nl].numpy()), jnp.asarray(deps[:nl].numpy()),
        jnp.asarray(minv[:nl].numpy()), shape=a.shape))
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # the JAX encode step agrees with the port's to the FMA envelope
    jnl = int(_jax_step(a, 1e-9)[3])
    assert jnl == nl


@pytest.mark.parametrize("shape", [(32, 24, 20), (33, 31, 29)])
@pytest.mark.parametrize("tol", [1e-16, 1e-10, 1e-7, 1e-3])
def test_device_entropy_identical_to_native(shape, tol):
    # exact: the same bytes and the same f64 bits
    a = smooth_field(shape)
    e = TC.encode_field(a, tol, coder="rans", entropy="device", device="cpu")
    assert_same_stream(e, TC.encode_field(a, tol, coder="rans",
                                          device="cpu"))
    r = JC.encode_field(a, tol, coder="rans", backend="native")
    assert_same_stream(e, r)
    d = TC.decode_field(r, device="cpu", entropy="device")
    assert d.tobytes() == JC.decode_field(r, backend="native").tobytes()


def test_device_entropy_identical_to_jax_device_entropy():
    a = smooth_field((32, 24, 20))
    e = TC.encode_field(a, 1e-7, coder="rans", entropy="device", device="cpu")
    j = JC.encode_field(a, 1e-7, backend="jax", coder="rans",
                        entropy="device")
    # the stream; deps_vec only within XLA's FMA envelope, as with host
    # entropy (test_stream_identical_to_jax)
    assert e.nlay == j.nlay and e.data == j.data and e.tolabs == j.tolabs
    assert e.len_enc_vec.tobytes() == j.len_enc_vec.tobytes()


def test_device_entropy_decoders_read_each_other():
    a = smooth_field((24, 20, 16))
    e = TC.encode_field(a, 1e-9, coder="rans", entropy="device", device="cpu")
    j = JC.encode_field(a, 1e-9, backend="jax", coder="rans",
                        entropy="device")
    # the port's device decoder on the JAX stream, the JAX one on the
    # port's: each equal to its own host-entropy decode, bit for bit
    assert (TC.decode_field(j, device="cpu", entropy="device").tobytes()
            == TC.decode_field(j, device="cpu").tobytes())
    assert (JC.decode_field(e, backend="jax", entropy="device").tobytes()
            == JC.decode_field(e, backend="jax").tobytes())


def test_device_entropy_trivial_field():
    a = np.full((8, 8, 8), 3.25)
    e = TC.encode_field(a, 1e-3, coder="rans", entropy="device", device="cpu")
    assert e.ntot_enc == 0
    assert np.array_equal(TC.decode_field(e, device="cpu", entropy="device"),
                          a)


def test_device_entropy_needs_turbo_streams():
    a = smooth_field((8, 8, 8))
    with pytest.raises(ValueError, match="coder='rans'"):
        TC.encode_field(a, 1e-6, entropy="device", device="cpu")
    e = TC.encode_field(a, 1e-6, device="cpu")  # v1: the range coder
    with pytest.raises(ValueError, match="turbo"):
        TC.decode_field(e, device="cpu", entropy="device")
    with pytest.raises(ValueError, match="unknown entropy"):
        TC.decode_field(e, device="cpu", entropy="gpu")


@pytest.mark.parametrize("kw", [dict(backend="exact64"),
                                dict(conformance="route"),
                                dict(mx=2, cutoff=np.array([1e-6, 1e-5]))])
def test_unported_options_raise(kw):
    # the three options the port once refused: exact64 and route now run
    # and give native's stream; local cutoffs run on backend="native" and
    # the device backends refuse them rather than drop them
    a = smooth_field((8, 8, 8))
    if "mx" in kw:
        with pytest.raises(ValueError, match="backend='native'"):
            TC.encode_field(a, 1e-6, device="cpu", **kw)
        assert_same_stream(
            TC.encode_field(a, 1e-6, backend="native", **kw),
            JC.encode_field(a, 1e-6, backend="native", **kw))
    else:
        assert_same_stream(TC.encode_field(a, 1e-6, device="cpu", **kw),
                           JC.encode_field(a, 1e-6, backend="native"))
