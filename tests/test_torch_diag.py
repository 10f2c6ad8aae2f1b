"""waverange_tpu_torch.utils.diag on the CPU: the stage-timing registry,
the stages each backend of the port's codec records (the JAX codec's names
with `jax` read as `torch`), the WR_VERBOSE switch, and `native.pool_trim`.
"""
import numpy as np
import pytest

from conftest import smooth_field
from waverange_tpu import utils as JU
from waverange_tpu.core import codec as JC
from waverange_tpu_torch import native as tn
from waverange_tpu_torch import utils as U
from waverange_tpu_torch.core import codec as TC

# (backend, precision, input dtype): the encode and decode stages of each
BACKENDS = {
    ("torch", "f64", np.float64): ("encode.torch", "decode.torch"),
    ("exact64", "f64", np.float64): ("encode.exact64", "decode.exact64"),
    ("native", "f64", np.float64): ("encode.native", "decode.native"),
    ("native", "native", np.float32): ("encode.native.f32", "decode.native"),
}


def test_timed_registry():
    U.reset_timings()
    for _ in range(2):
        with U.timed("stage.a"):
            pass
    with pytest.raises(KeyError):
        with U.timed("stage.b"):
            raise KeyError("the stage is timed all the same")
    t = U.get_timings()
    assert set(t) == {"stage.a", "stage.b"}
    assert t["stage.a"]["count"] == 2 and t["stage.b"]["count"] == 1
    assert all(v["total_s"] >= 0 for v in t.values())
    U.reset_timings()
    assert U.get_timings() == {}


def _port_stages(backend, precision, dtype):
    a = smooth_field((10, 10, 10)).astype(dtype)
    U.reset_timings()
    e = TC.encode_field(a, 1e-4, backend=backend, precision=precision,
                        device="cpu")
    TC.decode_field(e, backend=backend, device="cpu")
    return U.get_timings()


@pytest.mark.parametrize("key", list(BACKENDS), ids=lambda k: "-".join(
    (k[0], k[1])))
def test_each_backend_records_its_stages(key):
    t = _port_stages(*key)
    assert set(t) == set(BACKENDS[key])
    assert all(v["count"] == 1 for v in t.values())


@pytest.mark.parametrize("key", list(BACKENDS), ids=lambda k: "-".join(
    (k[0], k[1])))
def test_stage_names_are_the_jax_codecs(key):
    """The JAX codec on the same call records the same names, `jax` read
    as `torch`; its `exact64.*` stages time the software f64, which the
    port has not (core/exact64.py)."""
    backend, precision, dtype = key
    a = smooth_field((10, 10, 10)).astype(dtype)
    jb = "jax" if backend == "torch" else backend
    JU.reset_timings()
    e = JC.encode_field(a, 1e-4, backend=jb, precision=precision)
    JC.decode_field(e, backend=jb)
    jax_names = {k.replace("jax", "torch") for k in JU.get_timings()
                 if not k.startswith("exact64.")}
    assert jax_names == set(_port_stages(*key))


def test_verbose_prints_only_with_wr_verbose(monkeypatch, capsys):
    a = smooth_field((8, 8, 8))
    monkeypatch.delenv("WR_VERBOSE", raising=False)
    e = TC.encode_field(a, 1e-6, device="cpu")
    TC.decode_field(e, device="cpu")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("WR_VERBOSE", "1")
    e = TC.encode_field(a, 1e-6, device="cpu")
    TC.decode_field(e, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    assert out[0].startswith("[wr] encode.torch: ") and out[0].endswith("s")
    assert out[1].startswith("[wr] decode.torch: ")
    assert U.verbose()


def test_pool_trim_then_encode_gives_the_same_bytes():
    a = smooth_field((16, 12, 10))
    before = tn.encode_field(a, wtflag=1, cutoff=np.array([1e-7]))
    tn.pool_trim()
    after = tn.encode_field(a, wtflag=1, cutoff=np.array([1e-7]))
    assert after["data"] == before["data"] and after["nlay"] == before["nlay"]
    tn.pool_trim()
    e = TC.encode_field(a, 1e-7, backend="native")
    assert e.data == before["data"]
