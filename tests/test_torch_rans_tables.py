"""The step arithmetic of the redesigned rANS kernels, mirrored in numpy by
`waverange_tpu_torch.ops.rans`, on the CPU: kernel F's division by the
reciprocal of the frequency and kernel H's bucketed slot -> symbol table.
Both are exact, so every comparison is equality."""
import numpy as np
import pytest
import torch

from waverange_tpu_torch.ops import rans as R

from test_torch_rans import dist_syms

M32 = (1 << 32) - 1
F_RANGES = [(lo, min(lo + 1024, R.PROB_SCALE + 1))
            for lo in range(1, R.PROB_SCALE + 1, 1024)]


@pytest.mark.parametrize("lo,hi", F_RANGES)
def test_reciprocal_divides_exactly(lo, hi):
    f = np.arange(lo, hi, dtype=np.uint64)
    m, l = R.div_magic(f)
    assert (m <= M32).all() and (l <= R.PROB_BITS).all()
    rng = np.random.default_rng(lo)
    fi = f.astype(np.int64)
    k = rng.integers(1, M32 // fi + 1)  # k*f <= 2^32 - 1
    edges = np.stack([
        np.zeros_like(fi), np.ones_like(fi), fi - 1, fi, k * fi - 1, k * fi,
        np.full_like(fi, 1 << 31), np.full_like(fi, M32),
        # the encoder's threshold f << 18, which wraps to 0 for f = 16384
        ((fi << 18) - 1) & M32, (fi << 18) & M32], 1).astype(np.uint64)
    rand = rng.integers(0, 1 << 32, (f.size, 1000), dtype=np.uint64)
    x = np.concatenate([edges, rand], 1)
    q = R.div_by_magic(x, m[:, None], l[:, None])
    assert np.array_equal(q, x // f[:, None])


def test_reciprocal_of_powers_of_two_is_a_shift():
    f = np.uint64(1) << np.arange(15, dtype=np.uint64)
    m, l = R.div_magic(f)
    assert not m.any() and np.array_equal(l, np.arange(15))


def _models(name: str) -> np.ndarray:
    syms = dist_syms(name)
    etab, _ = R.block_models_plain(torch.from_numpy(syms[None]), syms.size)
    return (etab.numpy() & 0xFFFF).astype(np.int64)


@pytest.mark.parametrize("name", ["steal", "constant", "uniform", "two_skew",
                                  "ramp"])
def test_bucket_table_resolves_every_slot(name):
    freqs = _models(name)
    assert (freqs.sum(1) == R.PROB_SCALE).all()
    lut = R.bucket_table(freqs)
    assert lut.shape == (freqs.shape[0], 1 << R.BUCKET_BITS)
    slots = np.broadcast_to(np.arange(R.PROB_SCALE), freqs.shape[:1]
                            + (R.PROB_SCALE,))
    got = R.bucket_lookup(freqs, lut, slots)
    cum = np.cumsum(freqs, 1) - freqs
    want = np.stack([np.searchsorted(c, np.arange(R.PROB_SCALE),
                                     side="right") - 1 for c in cum])
    assert np.array_equal(got, want)
    assert (freqs[np.arange(len(freqs))[:, None], got] > 0).all()
