"""The codec's backends and conformance modes in waverange_tpu_torch on the
CPU: `backend="native"` (the port's host copy, f64 and f32, local
cutoffs), `backend="exact64"` (the f64 device path) with both entropy
stages, `conformance="route"`, and the keyword-only signatures, against
the reference package's native codec and its JAX `exact64`."""
import numpy as np
import pytest

from waverange_tpu import native as wn
from waverange_tpu.core import codec as JC
from waverange_tpu.core import exact64 as JX
from waverange_tpu_torch.core import codec as TC
from waverange_tpu_torch.core import exact64 as TX

from conftest import smooth_field
from test_torch_codec import assert_same_stream

META = ("tolabs", "midval", "halfspanval", "wlev", "nlay", "ntot_enc",
        "data")


def assert_same_meta(got: dict, want: dict):
    for k in META:
        assert got[k] == want[k], k
    for k in ("deps_vec", "minval_vec", "len_enc_vec"):
        assert (np.asarray(got[k]).tobytes()
                == np.asarray(want[k]).tobytes()), k


# --- backend="native" --------------------------------------------------------

@pytest.mark.parametrize("coder", ["range", "rans"])
@pytest.mark.parametrize("tol", [1e-16, 1e-7, 1e-3])
def test_native_f64_matches_reference_native(coder, tol):
    a = smooth_field((17, 12, 9))
    e = TC.encode_field(a, tol, backend="native", coder=coder)
    r = JC.encode_field(a, tol, backend="native", coder=coder)
    assert_same_stream(e, r)
    d = TC.decode_field(e, backend="native")
    assert d.tobytes() == JC.decode_field(r, backend="native").tobytes()


@pytest.mark.parametrize("tol", [1e-4, 1e-9])
def test_native_f32_matches_reference_native_f32(tol):
    # native has no f32 floor check (waverange_tpu/core/codec.py:107-109):
    # 1e-9 runs the f32 pipeline as the reference's does
    a32 = smooth_field((16, 11, 13)).astype(np.float32)
    e = TC.encode_field(a32, tol, backend="native", precision="native")
    r = JC.encode_field(a32, tol, backend="native", precision="native")
    assert_same_stream(e, r)
    ref = wn.encode_field_f32(a32, tol)
    assert e.data == ref["data"]
    assert (TC.decode_field(e, backend="native").tobytes()
            == JC.decode_field(r, backend="native").tobytes())


@pytest.mark.parametrize("precision,dtype", [("f64", np.float64),
                                             ("native", np.float32)])
@pytest.mark.parametrize("wtflag", [1, 0])
@pytest.mark.parametrize("blocks", [(2, 1, 1), (3, 2, 2), (2, 3, 1)])
def test_native_local_cutoff_matches_reference(precision, dtype, wtflag,
                                               blocks):
    # blocks that split the odd extents 13 x 11 x 9 unevenly
    mx, my, mz = blocks
    a = smooth_field((9, 11, 13)).astype(dtype)
    cut = np.geomspace(1e-3, 1e-8, mx * my * mz)
    kw = dict(cutoff=cut, mx=mx, my=my, mz=mz, backend="native",
              precision=precision)
    e = TC.encode_field(a, 1e-5, wtflag, **kw)
    r = JC.encode_field(a, 1e-5, wtflag, **kw)
    assert_same_stream(e, r)
    assert (TC.decode_field(e, backend="native").tobytes()
            == JC.decode_field(r, backend="native").tobytes())


def test_native_ignores_the_device():
    # the host pipeline runs without a card whatever `device` says
    a = smooth_field((8, 8, 8))
    e = TC.encode_field(a, 1e-6, backend="native", device="cuda:7")
    assert_same_stream(e, JC.encode_field(a, 1e-6, backend="native"))


# --- backend="exact64" -------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 12, 10), (21, 19, 17)])
@pytest.mark.parametrize("tol", [1e-16, 1e-10, 1e-4])
@pytest.mark.parametrize("coder,entropy", [("range", "host"),
                                           ("rans", "host"),
                                           ("rans", "device")])
def test_exact64_matches_native(shape, tol, coder, entropy):
    a = smooth_field(shape)
    e = TC.encode_field(a, tol, backend="exact64", coder=coder,
                        entropy=entropy, device="cpu")
    r = JC.encode_field(a, tol, backend="native", coder=coder)
    assert_same_stream(e, r)
    d = TC.decode_field(r, backend="exact64", entropy=entropy, device="cpu")
    assert d.tobytes() == JC.decode_field(r, backend="native").tobytes()


def test_exact64_widens_f32_input():
    # precision is always f64 on exact64, as the reference's
    a32 = smooth_field((12, 10, 8)).astype(np.float32)
    e = TC.encode_field(a32, 1e-9, backend="exact64", precision="native",
                        device="cpu")
    assert_same_stream(e, JC.encode_field(a32, 1e-9, backend="native"))


@pytest.mark.parametrize("tol", [1e-4, 1e-16])
def test_exact64_matches_jax_exact64(tol):
    """As tests/test_softf64.py:141-167: the port's exact64 and the JAX
    package's (software f64) give the native metadata, streams and
    decode, bit for bit."""
    a = smooth_field((10, 10, 10))
    ref = wn.encode_field(a, wtflag=1, cutoff=np.array([tol]), coder=1)
    got = TX.encode_field_exact64(a, tol, entropy="host", device="cpu")
    jax = JX.encode_field_exact64(a, tol, entropy="host")
    assert_same_meta(got, ref)
    assert_same_meta(got, jax)
    dref = wn.decode_field(ref, a.shape, coder=1)
    dgot = TX.decode_field_exact64(got, a.shape, entropy="host",
                                   device="cpu")
    djax = JX.decode_field_exact64(jax, a.shape, entropy="host")
    assert np.array_equal(dgot.view(np.uint64), dref.view(np.uint64))
    assert np.array_equal(dgot.view(np.uint64), djax.view(np.uint64))


def test_exact64_device_entropy_matches_jax_exact64():
    a = smooth_field((10, 10, 10))
    got = TX.encode_field_exact64(a, 1e-7, device="cpu")
    jax = JX.encode_field_exact64(a, 1e-7)
    assert_same_meta(got, jax)


def test_exact64_trivial_field_wlev_follows_native():
    # the documented deviation: wlev 4 as native (wr_native.cc:1936), where
    # the JAX exact64 writes 0 (exact64.py:132); both decode to the field
    c = np.full((6, 5, 4), 7.5)
    got = TX.encode_field_exact64(c, 1e-6, device="cpu")
    jax = JX.encode_field_exact64(c, 1e-6)
    ref = wn.encode_field(c, wtflag=1, cutoff=np.array([1e-6]), coder=1)
    assert got["ntot_enc"] == 0 and got["wlev"] == ref["wlev"] == 4
    assert jax["wlev"] == 0
    assert_same_meta(got, ref)
    assert np.array_equal(
        TX.decode_field_exact64(got, c.shape, device="cpu"), c)
    assert np.array_equal(JX.decode_field_exact64(jax, c.shape), c)


def test_exact64_uniform_cutoff_replaces_tolrel():
    # the documented deviation: the cutoff is the tolerance, as in native;
    # the JAX codec gives its exact64 tolrel only (codec.py:193-195); the
    # shape of test_exact64_matches_jax_exact64 reuses its compiled graphs
    a = smooth_field((10, 10, 10))
    cut = np.array([1e-9])
    e = TC.encode_field(a, 1e-3, cutoff=cut, backend="exact64",
                        coder="rans", device="cpu")
    r = JC.encode_field(a, 1e-3, cutoff=cut, backend="native", coder="rans")
    assert_same_stream(e, r)
    j = JC.encode_field(a, 1e-3, cutoff=cut, backend="exact64", coder="rans",
                        entropy="host")
    assert j.tolabs != e.tolabs and j.nlay < e.nlay


# --- conformance="route" -----------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "exact64"])
def test_route_below_the_f32_floor_gives_the_f64_stream(backend):
    a32 = smooth_field((16, 12, 10)).astype(np.float32)
    e = TC.encode_field(a32, 1e-9, precision="native", conformance="route",
                        backend=backend, device="cpu")
    assert_same_stream(e, TC.encode_field(a32, 1e-9, device="cpu"))
    assert_same_stream(e, JC.encode_field(a32, 1e-9, backend="native"))


def test_route_above_the_f32_floor_gives_the_f32_stream():
    a32 = smooth_field((16, 12, 10)).astype(np.float32)
    e = TC.encode_field(a32, 1e-4, precision="native", conformance="route",
                        device="cpu")
    assert_same_stream(e, TC.encode_field(a32, 1e-4, precision="native",
                                          device="cpu"))
    assert_same_stream(e, JC.encode_field(a32, 1e-4, backend="native",
                                          precision="native"))


def test_route_with_device_entropy():
    # the reference routes this request to exact64 with device entropy
    # (codec.py:176); here the same stream comes from the f64 path
    a32 = smooth_field((12, 12, 12)).astype(np.float32)
    e = TC.encode_field(a32, 1e-8, precision="native", conformance="route",
                        coder="rans", entropy="device", device="cpu")
    assert_same_stream(e, JC.encode_field(a32, 1e-8, backend="native",
                                          coder="rans"))


# --- signatures and errors ------------------------------------------------

def test_positional_cutoff_raises():
    a = smooth_field((8, 8, 8))
    with pytest.raises(TypeError):
        TC.encode_field(a, 1e-6, 1, np.array([1e-6]))
    e = TC.encode_field(a, 1e-6, 1, device="cpu")
    with pytest.raises(TypeError):
        TC.decode_field(e, "cpu")


@pytest.mark.parametrize("backend", ["torch", "exact64"])
def test_device_backends_refuse_local_cutoffs(backend):
    a = smooth_field((8, 8, 8))
    with pytest.raises(ValueError, match="backend='native'"):
        TC.encode_field(a, 1e-6, cutoff=np.array([1e-6, 1e-5]), mx=2,
                        backend=backend, device="cpu")


def test_native_refuses_device_entropy():
    a = smooth_field((8, 8, 8))
    with pytest.raises(ValueError, match="entropy='device'"):
        TC.encode_field(a, 1e-6, backend="native", coder="rans",
                        entropy="device")
    e = TC.encode_field(a, 1e-6, backend="native", coder="rans")
    with pytest.raises(ValueError, match="entropy='device'"):
        TC.decode_field(e, backend="native", entropy="device")


@pytest.mark.parametrize("kw,match", [
    (dict(backend="auto"), "unknown backend"),
    (dict(backend="jax"), "unknown backend"),
    (dict(conformance="lenient"), "conformance"),
    (dict(precision="f16"), "precision"),
    (dict(cutoff=np.array([1e-6, 1e-5])), "one value"),
    (dict(cutoff=np.array([1e-6, 1e-5]), mx=2, backend="native",
          my=2), "mx\\*my\\*mz")])
def test_bad_options_raise(kw, match):
    a = smooth_field((8, 8, 8))
    with pytest.raises(ValueError, match=match):
        TC.encode_field(a, 1e-6, device="cpu", **kw)
