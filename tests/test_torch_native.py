"""waverange_tpu_torch.native, the port's own copy of the host coder
library, against the frozen `waverange_tpu.native`: the same source code,
the same output bytes (coders 0 and 1, the field pipeline), and records
that each package's decoder reads."""
import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

from waverange_tpu import native as wn
from waverange_tpu.core import codec as JC
from waverange_tpu_torch import native as tn
from waverange_tpu_torch.core import codec as TC

from conftest import smooth_field
from test_torch_rans import DISTS, dist_syms

REPO = Path(__file__).resolve().parent.parent
FIELD = (33, 31, 29)
CUTOFFS = [1e-16, 1e-7, 1e-3]


def test_source_is_the_frozen_one():
    def sha(p):  # of the code: the copy rewords one comment
        code = [ln for ln in (REPO / p).read_bytes().splitlines()
                if not ln.lstrip().startswith(b"//")]
        return hashlib.sha256(b"\n".join(code)).hexdigest()
    assert (sha("waverange_tpu_torch/native/src/wr_native.cc")
            == sha("waverange_tpu/native/src/wr_native.cc"))


@pytest.mark.parametrize("coder", [0, 1])
@pytest.mark.parametrize("name", DISTS)
def test_encode_plane_identical(name, coder):
    syms = dist_syms(name)
    got = tn.encode_plane(syms, coder=coder)
    assert got == wn.encode_plane(syms, coder=coder)
    back = tn.decode_planes_batch(got, np.array([len(got)], np.uint64),
                                  syms.size, coder=coder)
    assert np.array_equal(back[0], syms)


@pytest.mark.parametrize("coder", [0, 1])
def test_planes_batch_identical(coder):
    planes = np.stack([dist_syms(d) for d in ("two_skew", "steal", "ramp")])
    got, lens = tn.encode_planes_batch(planes, coder=coder)
    want, wlens = wn.encode_planes_batch(planes, coder=coder)
    assert got == want and lens.tobytes() == wlens.tobytes()
    n = planes.shape[1]
    back = tn.decode_planes_batch(got, lens, n, coder=coder)
    assert np.array_equal(back, planes)
    assert np.array_equal(back, wn.decode_planes_batch(want, wlens, n,
                                                       coder=coder))


@pytest.mark.parametrize("coder", [0, 1])
@pytest.mark.parametrize("cutoff", CUTOFFS)
def test_field_pipeline_identical(cutoff, coder):
    a = smooth_field(FIELD)
    got = tn.encode_field(a, cutoff=np.array([cutoff]), coder=coder)
    want = wn.encode_field(a, cutoff=np.array([cutoff]), coder=coder)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes(), k
    assert got["nlay"] >= 1
    back = tn.decode_field(got, FIELD, coder=coder)
    assert back.tobytes() == wn.decode_field(want, FIELD,
                                             coder=coder).tobytes()
    if cutoff > 1e-10:  # below, f64 round-off sets the error
        assert np.abs(back - a).max() <= 1.3 * cutoff * np.abs(a).max()


def test_pool_warm_runs():
    tn.pool_warm(1 << 12)


@pytest.mark.parametrize("coder", ["range", "rans"])
def test_records_cross_packages(coder):
    a = smooth_field(FIELD)
    # the port's record, read by the JAX package's native decoder
    e = TC.encode_field(a, 1e-7, coder=coder, device="cpu")
    assert type(e) is TC.EncodedField
    j = JC.EncodedField(**dataclasses.asdict(e))
    assert (JC.decode_field(j, backend="native").tobytes()
            == TC.decode_field(e, device="cpu").tobytes())
    # and the reverse
    r = JC.encode_field(a, 1e-7, coder=coder, backend="native")
    t = TC.EncodedField(**dataclasses.asdict(r))
    assert (TC.decode_field(t, device="cpu").tobytes()
            == JC.decode_field(r, backend="native").tobytes())
    assert t.data == e.data


def test_record_constants_match():
    for k in ("NLAYMAX", "WAV_LVL", "CODER_VERSION", "CODER_VERSION_TURBO"):
        assert getattr(TC, k) == getattr(JC, k), k
    for c in ("range", "rans", "turbo", 0, 1):
        assert TC.coder_id(c) == JC.coder_id(c)
    for v in (JC.CODER_VERSION, JC.CODER_VERSION_TURBO):
        assert TC.coder_id_for_version(v) == JC.coder_id_for_version(v)
    with pytest.raises(ValueError, match="unsupported coder version"):
        TC.coder_id_for_version(1)
    assert ([f.name for f in dataclasses.fields(TC.EncodedField)]
            == [f.name for f in dataclasses.fields(JC.EncodedField)])


@pytest.mark.parametrize("coder", [0, 1])
@pytest.mark.parametrize("name", ["two_skew", "steal", "constant", "ramp"])
def test_decode_plane_identical(name, coder):
    syms = dist_syms(name)
    stream = wn.encode_plane(syms, coder=coder)
    got = tn.decode_plane(stream, syms.size, coder=coder)
    assert got.tobytes() == wn.decode_plane(stream, syms.size,
                                            coder=coder).tobytes()
    assert np.array_equal(got, syms)


@pytest.mark.parametrize("levels", [-4, -1, 1, 4])
@pytest.mark.parametrize("shape", [(33, 31, 29), (16, 16, 16), (1, 5, 9)])
def test_wavelet3d_identical(shape, levels):
    a = smooth_field(shape)
    got = tn.wavelet3d(a.copy(), levels)
    assert got.tobytes() == wn.wavelet3d(a.copy(), levels).tobytes()
    if levels > 0:  # and back, as the native inverse gives it
        back = tn.wavelet3d(got.copy(), -levels)
        assert back.tobytes() == wn.wavelet3d(got.copy(), -levels).tobytes()
    with pytest.raises(ValueError, match="C-contiguous"):
        tn.wavelet3d(a.astype(np.float32), levels)


@pytest.mark.parametrize("levels", [0, 1, 4])
@pytest.mark.parametrize("dims", [(29, 31, 33), (16, 16, 16), (9, 5, 1)])
def test_index_p2w_identical(levels, dims):
    rng = np.random.default_rng(levels)
    for _ in range(25):
        pt = [int(rng.integers(0, d)) for d in dims]
        assert (tn.index_p2w(levels, *dims, *pt)
                == wn.index_p2w(levels, *dims, *pt))
