"""waverange_tpu_torch.ops.rans on the CPU: the plain torch versions of the
rANS kernels E-H and the numpy framing, against the native turbo coder
(`wr_native.cc` turbo::encode_plane_t / decode_plane_t, the format
oracle), the JAX device coder (`waverange_tpu.ops.rans`) and, in
interpret mode, the Pallas kernels of `waverange_tpu.ops.rans_kernels`.

Every comparison is exact: the coder's arithmetic is integer, so the
tolerance is zero (equal integers, equal bytes)."""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waverange_tpu import native as wn
from waverange_tpu.ops import rans as JR
from waverange_tpu.ops import rans_kernels as RK
from waverange_tpu_torch.ops import rans as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISTS = ["constant", "two_skew", "uniform", "steal", "ramp",
         "mixed_const_block"]
SIZES = [1, 7, 8, 9, 65535, 65537, 200001]


@functools.lru_cache(maxsize=None)
def dist_syms(name: str) -> np.ndarray:
    """The distribution classes of tests/test_rans_device.py, 3 blocks."""
    rng = np.random.default_rng(DISTS.index(name))
    n = 196608
    if name == "constant":
        return np.full(n, 42, np.uint8)
    if name == "two_skew":
        return np.where(rng.random(n) < 1e-4, 7, 200).astype(np.uint8)
    if name == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    if name == "steal":
        # ~220 rare symbols: the 0 -> 1 clamps and the steal loop
        syms = np.zeros(n, np.uint8)
        syms[:220] = np.arange(1, 221) % 256
        rng.shuffle(syms)
        return syms
    if name == "ramp":
        return (np.arange(n) % 251).astype(np.uint8)
    syms = np.clip(rng.normal(100, 9, n), 0, 255).astype(np.uint8)
    syms[65536:131072] = 9  # one single-symbol block between two others
    return syms


@functools.lru_cache(maxsize=None)
def size_syms(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    return np.clip(rng.normal(100, 9, n), 0, 255).astype(np.uint8)


def case_syms(case: str) -> np.ndarray:
    return size_syms(int(case[2:])) if case.startswith("n=") \
        else dist_syms(case)


CASES = [f"n={n}" for n in SIZES] + DISTS


@functools.lru_cache(maxsize=None)
def native_stream(case: str) -> bytes:
    return wn.encode_plane(case_syms(case), coder=1)


def planes_of(syms: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(syms)[None])


def normalize_cpp(counts: np.ndarray, bs: int) -> np.ndarray:
    """A loop transcription of wr_native.cc:563-589 (normalize_freqs)."""
    freqs = [0] * 256
    total, maxs = 0, -1
    for i in range(256):
        c = int(counts[i])
        if not c:
            continue
        f = c * R.PROB_SCALE // bs or 1
        freqs[i] = f
        total += f
        if maxs < 0 or c > counts[maxs]:
            maxs = i
    if total < R.PROB_SCALE:
        freqs[maxs] += R.PROB_SCALE - total
    else:
        while total > R.PROB_SCALE:
            b = -1
            for i in range(256):
                if freqs[i] > 1 and (b < 0 or freqs[i] > freqs[b]):
                    b = i
            take = min(freqs[b] - 1, total - R.PROB_SCALE)
            freqs[b] -= take
            total -= take
    return np.asarray(freqs, np.int64)


@functools.lru_cache(maxsize=None)
def jax_scan(name: str):
    """JAX `_encode_scan` of one distribution's blocks, as numpy."""
    blocks, bs, _ = JR._block_batch([dist_syms(name)])
    G = -(-int(bs.max()) // 8)
    out = JR._encode_scan(jnp.asarray(blocks), jnp.asarray(bs, jnp.int32),
                          G, 4)
    return bs, [np.asarray(o) for o in out]


@functools.lru_cache(maxsize=None)
def port_models_and_chain(name: str):
    syms = dist_syms(name)
    planes = planes_of(syms)
    etab, nsym = R.block_models_plain(planes, syms.size)
    return etab, nsym, R.chain_plain(planes, syms.size, etab)


# ----------------------------------------------------------------------------
# (a) Models: histogram and normalization (kernel E).
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", DISTS)
def test_model_matches_jax_and_cpp(name):
    syms = dist_syms(name)
    n = syms.size
    counts = R.histogram_plain(planes_of(syms), n)
    bs = R.plane_bs(1, n)
    blocks, jbs, _ = JR._block_batch([syms])
    jcounts = np.asarray(JR._histogram(jnp.asarray(blocks),
                                       jnp.asarray(jbs, jnp.int32)))
    assert np.array_equal(counts.numpy(), jcounts)
    freqs = R.normalize_freqs_plain(counts, torch.from_numpy(bs)).numpy()
    jfreqs = np.asarray(JR._normalize_freqs(jnp.asarray(jcounts),
                                            jnp.asarray(jbs, jnp.int32)))
    assert np.array_equal(freqs, jfreqs)
    for b in range(len(bs)):
        assert np.array_equal(freqs[b], normalize_cpp(jcounts[b], bs[b]))
    assert (freqs.sum(1) == R.PROB_SCALE).all()
    # E's output: freq | cum<<16 and the count of distinct symbols
    etab, nsym = R.block_models_plain(planes_of(syms), n)
    cum = np.cumsum(freqs, 1) - freqs
    assert np.array_equal(etab.numpy(), (freqs | (cum << 16)).astype(np.int32))
    assert np.array_equal(nsym.numpy(), (jcounts > 0).sum(1))


# ----------------------------------------------------------------------------
# (b) The lane chains (kernel F) and (c) the compaction (kernel G).
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", DISTS)
def test_chain_matches_jax_encode_scan(name):
    bs, (_, jnsym, jx_fin, jwords, jemits, jnwords) = jax_scan(name)
    _, nsym, (slab, x_fin, nwords) = port_models_and_chain(name)
    assert np.array_equal(nsym.numpy(), jnsym)
    assert np.array_equal(x_fin.numpy().view(np.uint32), jx_fin)
    assert np.array_equal(nwords.numpy(), jnwords)
    B = len(bs)
    words = jwords.transpose(2, 0, 1).reshape(B, -1)
    emits = jemits.transpose(2, 0, 1).reshape(B, -1)
    for b in range(B):
        # the words under the emits, in stream order, right-aligned in the
        # slab (a raw block keeps only its last SLAB_WORDS)
        stream = words[b][emits[b]]
        assert len(stream) == jnwords[b]
        keep = min(len(stream), R.SLAB_WORDS)
        got = slab[b].numpy().view(np.uint16)
        assert np.array_equal(got[R.SLAB_WORDS - keep:], stream[-keep:]
                              if keep else stream[:0])
        assert not got[:R.SLAB_WORDS - keep].any()


@pytest.mark.parametrize("name", DISTS)
def test_compact_matches_jax(name):
    bs, (_, jnsym, jx_fin, jwords, jemits, jnwords) = jax_scan(name)
    _, _, (slab, x_fin, nwords) = port_models_and_chain(name)
    tags, wl, dest = R.block_layout(bs, jnsym, jnwords)
    modeled = tags == 0
    total = int(wl.sum())
    got = R.compact_plain(x_fin, slab, nwords, torch.from_numpy(dest), total)
    want = np.asarray(JR._encode_compact(
        jnp.asarray(jx_fin), jnp.asarray(jwords), jnp.asarray(jemits),
        jnp.asarray(np.where(modeled, jnsym, 0), jnp.int32),
        jnp.asarray(bs, jnp.int32), jnp.asarray(wl, jnp.int32),
        max(total, 1)))
    assert np.array_equal(got.numpy().view(np.uint16), want[:total])


# ----------------------------------------------------------------------------
# (d) The Pallas kernels in interpret mode, 128 blocks, against the plain
# versions.
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def pallas_blocks():
    """128 full blocks as 128 planes of 65536 symbols: noise of rising
    spread, two constant blocks and one uniform block."""
    rng = np.random.default_rng(128)
    B = 128
    sd = np.linspace(0.3, 60, B)[:, None]
    blocks = np.clip(rng.normal(128, sd, (B, R.TBLOCK)), 0, 255).astype(
        np.uint8)
    blocks[5] = 3
    blocks[77] = 250
    blocks[100] = rng.integers(0, 256, R.TBLOCK)
    planes = torch.from_numpy(blocks)
    etab, nsym = R.block_models_plain(planes, R.TBLOCK)
    return blocks, planes, etab


def test_pallas_hist_interpret():
    blocks, planes, _ = pallas_blocks()
    got = np.asarray(RK.hist_blocks(jnp.asarray(blocks.T), True))
    want = R.histogram_plain(planes, R.TBLOCK).numpy()
    assert np.array_equal(got, want)


def test_pallas_pregather_interpret():
    # the lookup that kernel F makes from its shared-memory table
    blocks, planes, etab = pallas_blocks()
    etab_t = jnp.asarray(etab.numpy().view(np.uint32).T.copy())
    got = np.asarray(RK.pregather(jnp.asarray(blocks.T), etab_t, True))
    want = etab.gather(1, planes.long()).numpy().view(np.uint32)
    assert np.array_equal(got, want.T)


def test_pallas_chain_interpret():
    blocks, planes, etab = pallas_blocks()
    B = blocks.shape[0]
    e = etab.gather(1, planes.long()).numpy().view(np.uint32)
    e = jnp.asarray(e.T.reshape(R.TBLOCK // 8, 8, B))
    words, emits, x_fin = (np.asarray(o) for o in RK.chain(
        e, jnp.full((1, B), R.TBLOCK, jnp.int32), True))
    slab, px_fin, nwords = R.chain_plain(planes, R.TBLOCK, etab)
    assert np.array_equal(px_fin.numpy().view(np.uint32), x_fin.T)
    em = emits.transpose(2, 0, 1).reshape(B, -1).astype(bool)
    assert np.array_equal(nwords.numpy(), em.sum(1))
    wd = words.transpose(2, 0, 1).reshape(B, -1)
    got = slab.numpy().view(np.uint16)
    for b in range(B):
        stream = wd[b][em[b]]
        keep = min(len(stream), R.SLAB_WORDS)
        assert np.array_equal(got[b, R.SLAB_WORDS - keep:], stream[-keep:])


# ----------------------------------------------------------------------------
# (e) Encode and (f) decode, end to end.
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def port_stream(case: str) -> bytes:
    syms = case_syms(case)
    return R.encode_planes_device(planes_of(syms), syms.size)[0]


@pytest.mark.parametrize("case", CASES)
def test_encode_matches_native_and_jax(case):
    syms = case_syms(case)
    got = port_stream(case)
    assert got == native_stream(case)
    assert got == JR.encode_planes_device(jnp.asarray(syms[None]),
                                          syms.size)[0]


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_native_and_jax(case):
    syms = case_syms(case)
    n = syms.size
    stream = native_stream(case)
    got = R.decode_planes_device([stream], n, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (1, n)
    assert np.array_equal(got[0].numpy(), wn.decode_plane(stream, n, coder=1))
    assert np.array_equal(got[0].numpy(), syms)
    assert np.array_equal(got.numpy(),
                          np.asarray(JR.decode_planes_device([stream], n)))


def batch_planes(n: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    planes = np.clip(rng.normal(100, 25, (3, n)), 0, 255).astype(np.uint8)
    planes[1] = 7  # a single-symbol plane in the middle
    return planes


@pytest.mark.parametrize("n", [107520, 4096])
def test_multi_plane_batch(n):
    planes = batch_planes(n)
    streams = R.encode_planes_device(torch.from_numpy(planes), n)
    assert streams == [wn.encode_plane(p, coder=1) for p in planes]
    assert streams == JR.encode_planes_device(jnp.asarray(planes), n)
    # the codec's layout: one buffer, the streams back to back
    back = R.decode_planes_device(b"".join(streams), n, device="cpu",
                                  lens=[len(s) for s in streams])
    assert np.array_equal(back.numpy(), planes)
    assert np.array_equal(
        back.numpy(), np.asarray(JR.decode_planes_device(streams, n)))


def test_empty_inputs():
    assert R.encode_planes_device(torch.zeros((2, 0), dtype=torch.uint8),
                                  0) == [b"", b""]
    assert R.decode_planes_device([], 5, device="cpu").shape == (0, 5)
    with pytest.raises(ValueError, match="uint8 planes"):
        R.encode_planes_device(torch.zeros((2, 4), dtype=torch.int16), 4)


_DCHAIN = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
from waverange_tpu import native as wn
from waverange_tpu.ops import rans
from waverange_tpu_torch.ops import rans as R

rng = np.random.default_rng(4)
syms = rng.normal(128, 20, 69857).clip(0, 255).astype(np.uint8)
stream = wn.encode_plane(syms, coder=1)
assert rans._use_kernels(), "WR_RANS_KERNELS=1 must force the kernels"
got = np.asarray(rans._decode_planes_kernels([stream], syms.size))
port = R.decode_planes_device([stream], syms.size, device="cpu").numpy()
assert np.array_equal(got, port), "dchain differs from the port"
assert np.array_equal(port[0], syms)
print("ALL-OK")
"""


def test_pallas_dchain_interpret_matches_port():
    env = dict(os.environ, WR_RANS_KERNELS="1", WR_PALLAS_INTERPRET="1",
               JAX_COMPILATION_CACHE_DIR="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-c", _DCHAIN % {"repo": REPO}],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ALL-OK" in r.stdout


# ----------------------------------------------------------------------------
# (g) Corrupt streams: the host parse raises ValueError before anything is
# uploaded, or hands kernel H a table that stays inside the data.
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def fuzz_case():
    rng = np.random.default_rng(2026)
    syms = np.clip(rng.normal(96, 40, 70000), 0, 255).astype(np.uint8)
    return syms, wn.encode_plane(syms, coder=1)


def parse_or_raise(s: bytes, n: int):
    """The table of `s`, checked to stay inside it; None if the parse
    refused the stream with the format's ValueError."""
    try:
        table = R.parse_planes(s, [len(s)], n)
    except ValueError as e:
        assert "corrupt v2 stream" in str(e)
        return None
    bs = R.plane_bs(1, n)
    raw = np.frombuffer(s, np.uint8)
    for (tag, off, plen), size in zip(table, bs):
        end = {0: off + 516 + plen, 1: off + size, 2: off + 1}[int(tag)]
        assert 0 <= off and end <= len(s)
        if tag == 0:
            f = raw[off:off + 512].view("<u2").astype(np.int64)
            assert f.sum() == R.PROB_SCALE
            assert plen == 0 or plen >= 32
    return table


def test_parse_fuzz_stays_in_bounds():
    syms, good = fuzz_case()
    n = syms.size
    rng = np.random.default_rng(7)
    assert parse_or_raise(good, n) is not None
    cuts = [0, 1, 2, 100, 516, 517, len(good) - 1]
    cuts += [int(rng.integers(0, len(good))) for _ in range(40)]
    for c in cuts:
        assert parse_or_raise(good[:c], n) is None
    for _ in range(300):
        b = bytearray(good)
        # flips in the framing: tags, models and payload lengths
        i = int(rng.integers(0, 520)) if rng.random() < 0.7 else int(
            rng.integers(0, len(b)))
        b[i] = int(rng.integers(0, 256))
        parse_or_raise(bytes(b), n)
    assert parse_or_raise(b"", n) is None
    parse_or_raise(bytes(rng.integers(0, 256, 2000, dtype=np.uint8)), n)


def test_corrupt_payload_decodes_without_crash():
    # bit flips in the payload: structurally valid, the symbols are garbage
    # by contract (no integrity check, as in the reference range coder)
    syms, good = fuzz_case()
    rng = np.random.default_rng(8)
    for _ in range(4):
        b = bytearray(good)
        i = int(rng.integers(600, len(b)))
        b[i] ^= 0xFF
        out = R.decode_planes_device([bytes(b)], syms.size, device="cpu")
        assert out.shape == (1, syms.size) and out.dtype == torch.uint8


@pytest.mark.parametrize("delta", [-1, 1, 40000])
def test_bad_model_sum_raises(delta):
    syms, good = fuzz_case()
    b = bytearray(good)
    assert b[0] == 0  # first block modeled: tag, then u16 freqs at 1
    f = int.from_bytes(b[1 + 2 * 96:3 + 2 * 96], "little")
    b[1 + 2 * 96:3 + 2 * 96] = ((f + delta) & 0xFFFF).to_bytes(2, "little")
    with pytest.raises(ValueError, match="model sums to"):
        R.decode_planes_device([bytes(b)], syms.size, device="cpu")


@pytest.mark.parametrize("n", [70001, 13])
def test_misaligned_row_view_is_copied_before_the_kernels(n, monkeypatch):
    # kernel F stages rows from a 16-byte aligned base, so a row view that
    # starts off one (planes[1:] with n % 16 != 0) is copied first; the
    # streams stay native's
    rng = np.random.default_rng(n)
    planes = torch.from_numpy(rng.integers(0, 5, (3, n), dtype=np.uint8))
    view = planes[1:]
    assert view.data_ptr() % 16
    seen = []
    encode_blocks = R.encode_blocks

    def spy(p, n_, mark=None):
        seen.append(p.data_ptr() % 16)
        return encode_blocks(p, n_, mark)
    monkeypatch.setattr(R, "encode_blocks", spy)
    streams = R.encode_planes_device(view, n)
    assert seen == [0]
    assert streams == [wn.encode_plane(p.numpy(), coder=1) for p in view]
