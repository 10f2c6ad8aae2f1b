"""The ragged plane API of waverange_tpu_torch.ops.rans on the CPU (the
plain versions of kernels E-H): `encode_planes` / `decode_planes` on planes
of different lengths, against the native turbo coder and the JAX package's
`ops.rans.encode_planes` / `decode_planes`; corrupt framing; the probe
`decode_compute_seconds`.

Every comparison is exact: equal bytes, equal symbols."""
import functools

import numpy as np
import pytest
import torch

from waverange_tpu.ops import rans as JR
from waverange_tpu_torch import native as tn
from waverange_tpu_torch.ops import rans as R

LENGTHS = [0, 1, 255, 65535, 65536, 65537, 200001]
DISTS = ["constant", "uniform", "skewed"]


@functools.lru_cache(maxsize=None)
def planes(dist: str):
    """One plane of each length in LENGTHS, of one symbol distribution."""
    rng = np.random.default_rng(DISTS.index(dist))
    if dist == "constant":
        return tuple(np.full(n, 42, np.uint8) for n in LENGTHS)
    if dist == "uniform":
        return tuple(rng.integers(0, 256, n, dtype=np.uint8)
                     for n in LENGTHS)
    return tuple(np.clip(rng.normal(100, 9, n), 0, 255).astype(np.uint8)
                 for n in LENGTHS)


@functools.lru_cache(maxsize=None)
def streams(dist: str):
    return tuple(R.encode_planes(list(planes(dist)), device="cpu"))


@pytest.mark.parametrize("dist", DISTS)
def test_encode_planes_matches_native(dist):
    got = streams(dist)
    assert len(got) == len(LENGTHS)
    assert got[0] == b""  # the empty plane
    assert list(got) == [tn.encode_plane(p, coder=1) for p in planes(dist)]


@pytest.mark.parametrize("dist", DISTS)
def test_encode_planes_matches_jax(dist):
    assert list(streams(dist)) == JR.encode_planes(list(planes(dist)))


@pytest.mark.parametrize("dist", DISTS)
def test_decode_planes_matches_jax(dist):
    s = list(streams(dist))
    got = R.decode_planes(s, LENGTHS, device="cpu")
    want = JR.decode_planes(s, LENGTHS)
    assert [g.dtype for g in got] == [np.uint8] * len(LENGTHS)
    for g, w, p in zip(got, want, planes(dist)):
        assert np.array_equal(g, w) and np.array_equal(g, p)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dist", DISTS)
def test_one_plane_round_trip(dist, n):
    """Each plane's stream of the ragged call decodes alone to the plane,
    as the native decoder decodes it."""
    p = planes(dist)[LENGTHS.index(n)]
    s = streams(dist)[LENGTHS.index(n)]
    (back,) = R.decode_planes([s], [n], device="cpu")
    assert np.array_equal(back, p)
    if n:
        assert np.array_equal(back, tn.decode_plane(s, n, coder=1))


def test_planes_are_grouped_by_length(monkeypatch):
    """One (k, n) upload per length, in first-seen order, each a fresh
    contiguous tensor at a 16-byte aligned address: nothing is padded to
    another plane's length."""
    calls = []
    real = R.encode_planes_device

    def spy(group, n):
        calls.append((tuple(group.shape), group.is_contiguous(),
                      group.data_ptr() % 16))
        return real(group, n)

    monkeypatch.setattr(R, "encode_planes_device", spy)
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, 4, n, dtype=np.uint8)
          for n in (9, 70001, 0, 9, 1, 70001, 9)]
    got = R.encode_planes(ps, device="cpu")
    assert calls == [((3, 9), True, 0), ((2, 70001), True, 0),
                     ((1, 1), True, 0)]
    assert got == [tn.encode_plane(p, coder=1) for p in ps]
    back = R.decode_planes(got, [p.size for p in ps], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(back, ps))


def _corrupt_cases():
    rng = np.random.default_rng(0)
    s = tn.encode_plane(
        np.clip(rng.normal(100, 9, 70001), 0, 255).astype(np.uint8), 1)
    assert s[0] == 0  # the first block is modeled
    plen = int.from_bytes(s[513:517], "little")
    return {
        "payload length past the end": (s[:-5], "block payload length"),
        "truncated at the second block": (s[:517 + plen],
                                          "truncated at block tag"),
        "unknown tag": (b"\x07" + s[1:], "unknown block tag 7"),
        "truncated constant block": (b"\x02", "truncated constant block"),
        "short raw block": (b"\x01" + bytes(100), "raw block declares"),
        "short model header": (b"\x00" + bytes(100),
                               "truncated model header"),
        "payload length below the states": (
            s[:513] + (5).to_bytes(4, "little") + s[517:],
            "block payload length 5 invalid"),
    }


@pytest.mark.parametrize("case", list(_corrupt_cases()))
def test_corrupt_framing_raises_as_jax(case):
    data, msg = _corrupt_cases()[case]
    with pytest.raises(ValueError, match=msg):
        R.decode_planes([data], [70001], device="cpu")
    with pytest.raises(ValueError, match=msg):
        JR.decode_planes([data], [70001])


def test_bad_model_sum_raises():
    """A model whose frequencies do not sum to 16384 is refused before the
    decode, as the C++ decoder stops there (the JAX decoder reads it)."""
    s = streams("skewed")[LENGTHS.index(65535)]
    assert s[0] == 0
    bad = s[:1] + bytes([s[1] ^ 1]) + s[2:]
    with pytest.raises(ValueError, match="model sums to"):
        R.decode_planes([bad], [65535], device="cpu")


def test_lengths_must_match_streams():
    with pytest.raises(ValueError, match="2 streams for 1 lengths"):
        R.decode_planes([b"", b""], [0], device="cpu")


def test_decode_compute_seconds_on_a_tiny_plane():
    p = np.clip(np.random.default_rng(3).normal(100, 9, 1000), 0,
                255).astype(np.uint8)
    s = tn.encode_plane(p, coder=1)
    t = R.decode_compute_seconds([s, s], 1000, device="cpu")
    assert isinstance(t, float) and t > 0


def test_defaults_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = np.zeros(9, np.uint8)
    s = tn.encode_plane(p, coder=1)
    for call in (lambda: R.encode_planes([p]),
                 lambda: R.decode_planes([s], [9]),
                 lambda: R.decode_compute_seconds([s], 9)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
