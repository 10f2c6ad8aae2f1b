"""The schedule of the port's kernel E (`rans_hist`, csrc/rans.cu), mirrored
in numpy (`waverange_tpu_torch.ops.rans`): the parallel normalization by
packed-key reductions equals the C++ order (wr_native.cc:563-589), the plain
torch version and the JAX function; the cut of every block into a byte-wise
head, 16-byte pieces and a byte-wise tail counts every byte of the planes
once and reads nothing outside them.

Every comparison is exact: the arithmetic is integer, so the tolerance is
zero."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from waverange_tpu.ops import rans as JR
from waverange_tpu_torch.ops import rans as R
from test_torch_rans import DISTS, dist_syms, normalize_cpp

CSRC = Path(R.__file__).resolve().parent.parent / "csrc" / "rans.cu"


def _check_normalization(counts: np.ndarray, bs: np.ndarray) -> None:
    f, cum = R.normalize_keyed(counts, bs)
    plain = R.normalize_freqs_plain(torch.from_numpy(counts),
                                    torch.from_numpy(bs)).numpy()
    assert np.array_equal(f, plain)
    for b in range(len(bs)):
        assert np.array_equal(f[b], normalize_cpp(counts[b], int(bs[b])))
    assert np.array_equal(cum, np.cumsum(f, 1) - f)
    assert (f.sum(1) == R.PROB_SCALE).all()


@pytest.mark.parametrize("name", DISTS)
def test_keyed_models_equal_plain_cpp_and_jax(name):
    syms = dist_syms(name)
    n = syms.size
    planes = torch.from_numpy(syms[None])
    counts = R.histogram_plain(planes, n).numpy()
    bs = R.plane_bs(1, n)
    _check_normalization(counts, bs)
    f, cum = R.normalize_keyed(counts, bs)
    jf = np.asarray(JR._normalize_freqs(jnp.asarray(counts, jnp.int32),
                                        jnp.asarray(bs, jnp.int32)))
    assert np.array_equal(f, jf)
    etab, _ = R.block_models_plain(planes, n)
    assert np.array_equal((f | (cum << 16)).astype(np.int32), etab.numpy())


def _counts(spec):
    """(counts, bs) of one block from a list of (symbol, count)."""
    c = np.zeros(256, np.int64)
    for s, k in spec:
        c[s] += k
    return c, int(c.sum())


CASES = {
    # one present symbol: f = 16384 at once
    "one symbol, bs 1": [(0, 1)],
    "one symbol at 255, bs 1": [(255, 1)],
    "one symbol, bs 65536": [(77, 65536)],
    # 256 present symbols, equal counts: floors sum to exactly 16384
    "256 symbols of 256": [(i, 256) for i in range(256)],
    # equal counts at different bins: the deficit goes to the first
    "three equal counts, deficit to the first": [(200, 1), (10, 1), (99, 1)],
    "equal max counts, deficit": [(3, 5), (250, 5), (100, 1)],
    # many count-1 clamps: the steal loop takes from the big symbol
    "255 clamps and one big": [(i, 1) for i in range(255)] + [(255, 65281)],
    # clamps and two equal big symbols: each steal takes the first max
    "clamps, two equal maxima": [(i, 1) for i in range(2, 256)]
    + [(0, 32641), (1, 32641)],
    # the steal takes several rounds over many equal small frequencies
    "steal over equal frequencies": [(i, 1) for i in range(128)]
    + [(i, 3) for i in range(128, 256)],
    "256 present, bs 300": [(i, 1) for i in range(256)] + [(7, 44)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_keyed_normalization_cases(case):
    c, bs = _counts(CASES[case])
    _check_normalization(c[None], np.array([bs]))


@pytest.mark.parametrize("bs", [1, 2, 3, 255, 256, 257, 4096, 16383, 16384,
                                16385, 65535, 65536])
def test_keyed_normalization_block_sizes(bs):
    rng = np.random.default_rng(bs)
    rows = []
    for k in (1, 2, 17, 256):  # present symbols, where bs allows
        k = min(k, bs)
        sym = rng.choice(256, k, replace=False)
        cut = np.sort(rng.choice(np.arange(1, bs), k - 1, replace=False)) \
            if k > 1 else np.array([], np.int64)
        c = np.zeros(256, np.int64)
        c[sym] = np.diff(np.concatenate([[0], cut, [bs]]))
        rows.append(c)
    _check_normalization(np.stack(rows), np.full(len(rows), bs))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(bs=st.integers(1, 65536), k=st.integers(1, 256),
       shape=st.sampled_from(["spread", "skew", "ties", "clamps"]),
       seed=st.integers(0, 2**32 - 1))
def test_keyed_normalization_drawn(bs, k, shape, seed):
    """Drawn blocks: bs symbols over k present bins, spread at random, one
    bin taking most, counts from a few equal values (ties), or most bins
    at 1 (clamps to frequency 1 and the steal loop)."""
    rng = np.random.default_rng(seed)
    k = min(k, bs)
    sym = rng.choice(256, k, replace=False)
    if shape == "spread":
        w = rng.random(k)
    elif shape == "skew":
        w = np.where(np.arange(k) == 0, 1e3, rng.random(k))
    elif shape == "ties":
        w = rng.choice([1.0, 2.0, 3.0], k)
    else:
        w = np.where(np.arange(k) == 0, float(bs), 1e-9)
    c = np.ones(k, np.int64)  # every drawn bin present
    c += np.floor(w / w.sum() * (bs - k)).astype(np.int64)
    c[np.argmax(w)] += bs - c.sum()
    counts = np.zeros(256, np.int64)
    counts[sym] = c
    _check_normalization(counts[None], np.array([bs]))


@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 65535, 65537, 70001, 200001])
def test_byte_partition_counts_every_byte_once(n, L):
    rng = np.random.default_rng(n + L)
    planes = rng.integers(0, 256, (L, n), dtype=np.uint8)
    want = R.histogram_plain(torch.from_numpy(planes), n).numpy()
    nb = R.num_blocks(n)
    bs = R.plane_bs(L, n)
    for addr0 in (0, 1, 7, 15):  # the planes' first byte, modulo 16
        reads = R.hist_reads(addr0, L, n)
        blk, off, width = reads.T
        assert set(np.unique(width)) <= {1, 16}
        # 16-byte reads are aligned; every read lies inside its block
        assert ((addr0 + off[width == 16]) % 16 == 0).all()
        start = (blk // nb) * n + (blk % nb) * R.TBLOCK
        assert (off >= start).all() and (off + width <= start + bs[blk]).all()
        # every byte of the planes once, nothing past them
        touched = np.zeros(L * n + 16, np.int64)
        idx = off[:, None] + np.arange(16)[None, :]
        np.add.at(touched, idx[np.arange(16)[None, :] < width[:, None]], 1)
        assert (touched[:L * n] == 1).all() and not touched[L * n:].any()
        assert np.array_equal(R.histogram_reads_plain(planes, reads), want)


def test_partition_of_short_and_misaligned_blocks():
    for addr in range(16):
        for bs in range(1, 80):
            head, pieces, tail = R.hist_partition(addr, bs)
            assert 0 <= head < 16 and 0 <= tail < 16
            assert head + 16 * pieces + tail == bs
            assert pieces == 0 or (addr + head) % 16 == 0
            # the head stops at the first boundary, or holds the block
            assert head == min(bs, -addr % 16)


def test_mirror_constants_match_the_kernel():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kHistThreads") == R.HIST_THREADS
    assert const("kHistUnroll") == R.HIST_UNROLL


def test_encode_blocks_marks_each_step():
    syms = dist_syms("mixed_const_block")
    planes = torch.from_numpy(np.stack([syms, syms[::-1].copy()]))
    steps = []
    got = R.encode_blocks(planes, syms.size, steps.append)
    assert steps == ["hist", "chain", "layout_sync", "compact", "raw_gather"]
    want = R.encode_blocks(planes, syms.size)
    assert R.frame(got) == R.frame(want)
