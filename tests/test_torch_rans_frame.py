"""The device framing of the rANS encode on the CPU: `ops.rans.frame_plain`
(the plain version of kernel I), `frame_table` and the entry
`encode_planes_joined`, against the host framing (`frame` of `fetch` of
`encode_blocks`), the native turbo coder (`waverange_tpu_torch.native`,
coder 1, the format oracle) and the JAX device coder
(`waverange_tpu.ops.rans.encode_planes_device` on JAX's CPU backend).

Every comparison is exact: the frames are bytes, so the tolerance is zero."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waverange_tpu.ops import rans as JR
from waverange_tpu_torch import native as tn
from waverange_tpu_torch.ops import rans as R

KINDS = ("constant", "raw", "modeled")


def mixed_planes(L: int, n: int, shift: int) -> np.ndarray:
    """(L, n) uint8 planes whose block j of plane i is of kind (i + j +
    shift) % 3: one symbol (tag 2), uniform bytes (tag 1), or a narrow
    normal (tag 0 where the block is long enough to pay for its model)."""
    rng = np.random.default_rng([L, n, shift])
    p = np.empty((L, n), np.uint8)
    for i in range(L):
        for j in range(R.num_blocks(n)):
            lo, hi = j * R.TBLOCK, min(n, (j + 1) * R.TBLOCK)
            kind = KINDS[(i + j + shift) % 3]
            if kind == "constant":
                p[i, lo:hi] = 40 + i + j
            elif kind == "raw":
                p[i, lo:hi] = rng.integers(0, 256, hi - lo)
            else:
                p[i, lo:hi] = np.clip(rng.normal(100, 9, hi - lo), 0, 255)
    return p


# (L, n, shift): n = 1, n < 65536, 65537 (a last block of one symbol) and
# 200001 (a short last block), L = 1 and 8; the single-block single plane
# in each kind
CASES = [(1, 1, 0), (8, 1, 0), (1, 20000, 0), (1, 20000, 1),
         (1, 20000, 2), (8, 20000, 0), (1, 65537, 1), (8, 65537, 0),
         (1, 200001, 0), (8, 200001, 0)]
IDS = [f"L{L}-n{n}-{KINDS[s]}" for L, n, s in CASES]


@functools.lru_cache(maxsize=None)
def coded(L: int, n: int, shift: int):
    """The planes, their `code_blocks` result and the frame table."""
    p = mixed_planes(L, n, shift)
    planes = torch.from_numpy(p)
    c = R.code_blocks(planes, n)
    table, lens = R.frame_table(L, n, c.tags, c.wl, c.dest)
    return p, planes, c, table, lens


@functools.lru_cache(maxsize=None)
def native_streams(L: int, n: int, shift: int) -> tuple:
    return tuple(tn.encode_plane(row, coder=1)
                 for row in mixed_planes(L, n, shift))


def test_cases_hold_every_tag():
    tags = np.concatenate([coded(*case)[2].tags for case in CASES])
    assert set(np.unique(tags)) == {0, 1, 2}
    assert set(coded(1, 200001, 0)[2].tags) == {0, 1, 2}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_frame_plain_matches_host_framing_native_and_jax(case):
    L, n, _ = case
    p, planes, c, table, lens = coded(*case)
    got = R.frame_plain(planes, c.etab, c.payload, torch.from_numpy(table),
                        int(lens.sum()))
    assert got.dtype == torch.uint8 and got.shape == (int(lens.sum()),)
    got = got.numpy().tobytes()
    assert got == b"".join(R.frame(R.fetch(R.encode_blocks(planes, n))))
    assert got == b"".join(native_streams(*case))
    assert got == b"".join(JR.encode_planes_device(jnp.asarray(p), n))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_constant_block_symbol_is_its_first_and_its_models_argmax(case):
    # kernel I writes a constant block's first symbol, host framing the
    # argmax of its model (rans.frame): the two agree
    L, n, _ = case
    p, _, c, _, _ = coded(*case)
    one = np.nonzero(c.tags == 2)[0]
    nb = R.num_blocks(n)
    first = p.reshape(-1)[(one // nb) * n + (one % nb) * R.TBLOCK]
    freqs = c.etab.numpy()[one] & 0xFFFF
    assert np.array_equal(np.argmax(freqs, 1), first)
    assert (freqs.max(1) == R.PROB_SCALE).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_joined_lens_and_the_per_plane_split(case):
    L, n, _ = case
    _, planes, _, table, lens = coded(*case)
    want = native_streams(*case)
    data, got_lens = R.encode_planes_joined(planes, n)
    assert got_lens.dtype == np.int64
    assert got_lens.tolist() == [len(s) for s in want] == lens.tolist()
    assert data == b"".join(want)
    assert R.encode_planes_device(planes, n) == list(want)
    # the frames start where the table says, each with its tag
    assert table[0, 1] == 0
    assert bytes(data[o] for o in table[:, 1]) == bytes(table[:, 0].tolist())


def test_frame_table_sizes():
    # plane 0: a modeled, a raw and a constant block of 65536, 65536 and
    # 3 symbols; plane 1 the same blocks, modeled last
    tags = np.array([0, 1, 2, 1, 2, 0])
    wl = np.array([100, 0, 0, 0, 0, 20])
    dest = np.array([0, -1, -1, -1, -1, 100])
    table, lens = R.frame_table(2, 2 * R.TBLOCK + 3, tags, wl, dest)
    size = [517 + 200, 1 + R.TBLOCK, 2, 1 + R.TBLOCK, 2, 517 + 40]
    assert table.dtype == np.int64
    assert table[:, 1].tolist() == (np.cumsum(size) - size).tolist()
    assert lens.tolist() == [sum(size[:3]), sum(size[3:])]
    assert np.array_equal(table[:, 0], tags)
    assert np.array_equal(table[:, 2], dest)
    assert np.array_equal(table[:, 3], wl)


def test_empty_planes_join_to_nothing():
    data, lens = R.encode_planes_joined(torch.zeros((3, 0), dtype=torch.uint8),
                                        0)
    assert data == b"" and lens.tolist() == [0, 0, 0]
    data, lens = R.encode_planes_joined(torch.zeros((0, 5), dtype=torch.uint8),
                                        5)
    assert data == b"" and lens.size == 0


@pytest.mark.parametrize("bad", [torch.zeros((2, 4), dtype=torch.int16),
                                 torch.zeros(4, dtype=torch.uint8)],
                         ids=["int16", "1-D"])
def test_joined_refuses_what_the_kernels_do_not_take(bad):
    with pytest.raises(ValueError, match="uint8 planes"):
        R.encode_planes_joined(bad, 4)
