"""Device-side turbo (format v2) interleaved-rANS entropy coder on torch.

Port of `waverange_tpu.ops.rans` (`encode_planes_device`,
`decode_planes_device`, the ragged `encode_planes` / `decode_planes` and
the probe `decode_compute_seconds`). The format oracle is the C++ turbo
coder of `waverange_tpu_torch.native` (wr_native.cc
`turbo::encode_plane_t`, `turbo::decode_plane_t`): streams made here are
byte-identical to it.

Format v2, one stream per byte plane: the plane is cut into blocks of
TBLOCK = 65536 symbols (the last one shorter when n % 65536 != 0). Every
block is coded on its own, with its own model and 8 interleaved rANS lane
states (symbol i of the block goes to lane i % 8), and is framed as a
1-byte tag, then
  tag 0 (modeled): u16 freqs[256] LE (sum 16384), u32 payload_len LE,
                   payload (the 8 final lane states as LE u32, then the
                   u16 renormalization words in stream order);
  tag 1 (raw):     bs verbatim bytes, chosen iff payload_len + 516 >= bs;
  tag 2 (const):   u8 symbol, chosen iff the block holds one symbol.
The tag rules are part of the format.

Device pipeline (kernels of `csrc/rans.cu`, wrappers in `rans_cuda`):
  E `rans_hist`    per-block histogram, normalized model, freq|cum<<16;
  F `rans_chain`   the 8-lane state chains, words written backwards into a
                   per-block slab of SLAB_WORDS u16;
  -- one small host sync: (nsym, nwords) per block -> tags and offsets --
  G `rans_compact` lane states + kept words of every modeled block into
                   one u16 buffer at host-computed offsets;
  -- the host turns the layout into each block's frame offset --
  I `rans_frame`   every block's frame (tag, model, length, payload; the
                   raw blocks' bytes straight from the planes) at its
                   offset in one u8 buffer: the L streams back to back;
  H `rans_decode`  every block of every plane, from the uploaded
                   compressed bytes, into the (L, n) u8 planes.
The encode copies that one buffer to the host; the decode parses the
containers with numpy (a few hundred bytes per 64 KiB block) and uploads
them. Only compressed bytes cross PCIe.

Dispatch goes by the tensor's device, as in `ops.quant`: a CPU tensor
takes the plain torch version of each kernel, a CUDA tensor the kernel, or
raises. There is no fallback. The plain versions hold u32 arithmetic in
int64 masked to 32 bits, so that `f << 18` wraps to 0 for f = 16384 as in
C++ (const blocks, whose payload is discarded). Kernel outputs hold u32
and u16 values as the bits of int32 and int16 tensors.
"""
from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..core import staging
from ..utils import timed

PROB_BITS = 14
PROB_SCALE = 1 << PROB_BITS
TBLOCK = 1 << 16
RANS_L = 1 << 16
LANES = 8
# Per-block word slab of kernel F. A block is modeled only while
# 2*(nwords + 16) + 516 < bs <= 65536, i.e. nwords < 32494: a block with
# more words is raw and its truncated slab is never read.
SLAB_WORDS = 1 << 15
_M32 = 0xFFFFFFFF
_MODEL_BYTES = 512   # u16 freqs[256]
_HEADER = 516        # model + u32 payload_len
_STATE_BYTES = 32    # 8 LE u32 lane states at the head of a payload


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _i16_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u16 values -> int16 with the same bits."""
    x = x & 0xFFFF
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of u32 values -> int64 values."""
    return x.long() & _M32


def num_blocks(n: int) -> int:
    return -(-n // TBLOCK)


def plane_bs(L: int, n: int) -> np.ndarray:
    """(L*nb,) int64 symbol count of every block, plane-major."""
    nb = num_blocks(n)
    bs = np.full(L * nb, TBLOCK, np.int64)
    if nb:
        bs[nb - 1::nb] = n - (nb - 1) * TBLOCK
    return bs


def _blockify(planes: torch.Tensor, n: int, width: int = TBLOCK):
    """(L*nb, width) uint8: block b's symbols in row b, zero padded
    (rans.py `_blockify`)."""
    L = planes.shape[0]
    nb = num_blocks(n)
    blocks = planes.new_zeros((L, nb * TBLOCK))
    blocks[:, :n] = planes
    return blocks.view(L * nb, TBLOCK)[:, :width]


def block_layout(bs: np.ndarray, nsym: np.ndarray, nwords: np.ndarray):
    """The format's tag per block, 2 iff nsym <= 1, else 1 iff
    2*(nwords + 16) + 516 >= bs, else 0 (wr_native.cc:724, :774), and
    the compacted payload buffer's layout: a modeled block's payload is
    wl = nwords + 16 u16 words from word dest on, back to back in block
    order; other blocks have wl 0 and dest -1. Returns (tags, wl, dest),
    int64 numpy arrays."""
    wl = nwords.astype(np.int64) + 16
    tags = np.where(nsym <= 1, 2, np.where(2 * wl + _HEADER >= bs, 1, 0))
    wl = np.where(tags == 0, wl, 0)
    return tags, wl, np.where(tags == 0, np.cumsum(wl) - wl, -1)


# ----------------------------------------------------------------------------
# The step arithmetic of kernels F and H (csrc/rans.cu), in numpy, so that
# the CPU tests hold it against `//` and the binary search.
# ----------------------------------------------------------------------------
BUCKET_BITS = 10  # H's slot -> symbol table: 1024 buckets of 16 slots


def div_magic(f: np.ndarray):
    """Kernel F's reciprocal of each frequency 1 <= f <= 16384: (m, l)
    with l = ceil(log2 f) and m = ceil(2^(32+l) / f) - 2^32, both
    uint64 arrays; `div_by_magic` divides with them."""
    f = np.asarray(f, np.uint64)
    l = np.zeros_like(f)
    while (big := (np.uint64(1) << l) < f).any():  # ceil(log2 f)
        l += big
    m = ((np.uint64(1) << (l + np.uint64(32))) + f - np.uint64(1)) // f
    return m - np.uint64(1 << 32), l


def div_by_magic(x: np.ndarray, m: np.ndarray, l: np.ndarray) -> np.ndarray:
    """x // f for u32 x, as kernel F computes it: (x + umulhi(x, m)) >> l
    with a 33-bit sum."""
    x = np.asarray(x, np.uint64)
    return (x + ((x * m) >> np.uint64(32))) >> l


def bucket_table(freqs: np.ndarray) -> np.ndarray:
    """Kernel H's (B, 1024) uint8 slot table of (B, 256) model
    frequencies summing to 16384: bucket k holds the symbol that owns slot
    16k (cum <= 16k < cum + f)."""
    freqs = np.asarray(freqs, np.int64)
    ends = np.cumsum(freqs, 1)
    starts = np.arange(1 << BUCKET_BITS) << (PROB_BITS - BUCKET_BITS)
    return np.stack([np.searchsorted(e, starts, side="right")
                     for e in ends]).astype(np.uint8)


def bucket_lookup(freqs: np.ndarray, lut: np.ndarray,
                  slot: np.ndarray) -> np.ndarray:
    """The symbol of each slot (B, k) as kernel H finds it: the bucket's
    symbol, then forward while the symbol's range ends at or below the
    slot."""
    freqs = np.asarray(freqs, np.int64)
    ends = np.cumsum(freqs, 1)
    rows = np.arange(freqs.shape[0])[:, None]
    s = lut[rows, slot >> (PROB_BITS - BUCKET_BITS)].astype(np.int64)
    while (past := ends[rows, s] <= slot).any():
        s += past
    return s


# ----------------------------------------------------------------------------
# The schedule of kernel E (csrc/rans.cu), in numpy, so that the CPU tests
# hold its byte partition and its parallel normalization against the plain
# versions and the C++ order.
# ----------------------------------------------------------------------------
HIST_THREADS = 256  # thread t owns bin t; 8 warps
HIST_UNROLL = 4     # 16-byte pieces in flight per thread


def hist_partition(addr: int, bs: int):
    """Kernel E's cut of a block of bs bytes at address addr: (head,
    pieces, tail) = the bytes up to the first 16-byte boundary, counted
    one by one, then whole 16-byte pieces, then the bytes left."""
    head = min(bs, -addr % 16)
    pieces = (bs - head) // 16
    return head, pieces, bs - head - 16 * pieces


def hist_reads(addr0: int, L: int, n: int) -> np.ndarray:
    """Every read kernel E makes of (L, n) planes whose first byte lies at
    address addr0: (k, 3) int64 rows (block, offset from the first byte,
    width): the head and tail bytes (width 1), then the 16-byte pieces of
    every thread's rounds (width 16)."""
    nb = num_blocks(n)
    bs = plane_bs(L, n)
    t = np.arange(HIST_THREADS)
    rows = []
    for b in range(L * nb):
        start = (b // nb) * n + (b % nb) * TBLOCK
        head, pieces, tail = hist_partition(addr0 + start, int(bs[b]))
        ones = np.concatenate([t[t < head], head + 16 * pieces + t[t < tail]])
        # thread t's pieces: t + HIST_THREADS * (HIST_UNROLL * j + u)
        k = np.arange(0, pieces, HIST_THREADS * HIST_UNROLL)[:, None] \
            + HIST_THREADS * np.arange(HIST_UNROLL)[None, :]
        k = (t[:, None, None] + k[None]).reshape(-1)
        k = k[k < pieces]
        rows += [np.stack([np.full(ones.size, b), start + ones,
                           np.ones_like(ones)], 1),
                 np.stack([np.full(k.size, b), start + head + 16 * k,
                           np.full(k.size, 16)], 1)]
    return np.concatenate(rows).astype(np.int64)


def histogram_reads_plain(planes: np.ndarray, reads: np.ndarray) -> np.ndarray:
    """(B, 256) int64 counts of the bytes that `reads` (of `hist_reads`)
    take from the flat (L, n) uint8 planes."""
    flat = np.ascontiguousarray(planes).reshape(-1)
    B = int(reads[:, 0].max()) + 1 if reads.size else 0
    idx = reads[:, 1:2] + np.arange(16)[None, :]
    keep = np.arange(16)[None, :] < reads[:, 2:3]
    blk = np.broadcast_to(reads[:, :1], idx.shape)[keep]
    sym = flat[idx[keep]].astype(np.int64)
    return np.bincount(blk * 256 + sym, minlength=B * 256).reshape(B, 256)


def normalize_keyed(counts: np.ndarray, bs: np.ndarray):
    """Kernel E's normalization of (B, 256) counts, one thread a bin: each
    of wr_native.cc:563-589's serial scans is a block reduction. The sum
    of f; "the first index among the maxima" of the counts (the deficit)
    and of the frequencies > 1 (each steal) is the maximum of the key
    (value << 8) | (255 - i); cum is a shuffle scan in each warp of 32
    bins plus the warps' exclusive totals. Returns (freqs, cum), int64."""
    c = np.asarray(counts, np.int64)
    B = c.shape[0]
    i = np.arange(256)
    rows = np.arange(B)
    f = np.where(c > 0, np.maximum(c * PROB_SCALE // np.asarray(
        bs, np.int64)[:, None], 1), 0)
    total = f.sum(1)
    key = np.where(c > 0, (c << 8) | (255 - i), 0).max(1)
    short = total < PROB_SCALE
    f[rows[short], 255 - (key[short] & 255)] += PROB_SCALE - total[short]
    while (over := total > PROB_SCALE).any():
        m = np.where(f > 1, (f << 8) | (255 - i), 0).max(1)
        take = np.where(over, np.minimum((m >> 8) - 1, total - PROB_SCALE),
                        0)
        f[rows, 255 - (m & 255)] -= take
        total -= take
    x = f.reshape(B, HIST_THREADS // 32, 32)
    for d in (1, 2, 4, 8, 16):  # lane l adds lane l - d's partial sum
        y = np.zeros_like(x)
        y[..., d:] = x[..., :-d]
        x = x + y
    warp_tot = x[..., 31]
    cum = (x + (np.cumsum(warp_tot, 1) - warp_tot)[..., None]).reshape(
        B, 256) - f
    return f, cum


# ----------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference).
# ----------------------------------------------------------------------------
def histogram_plain(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(L*nb, 256) int64 symbol counts of every block of the (L, n) u8
    planes (rans.py `_histogram`; no padding enters a bin)."""
    blocks = _blockify(planes, n)
    B = blocks.shape[0]
    bs = torch.from_numpy(plane_bs(planes.shape[0], n)).to(planes.device)
    pos = torch.arange(TBLOCK, device=planes.device)[None, :]
    counts = torch.zeros((B, 257), dtype=torch.int64, device=planes.device)
    for c0 in range(0, B, 256):  # bounded int64 index memory
        ids = torch.where(pos < bs[c0:c0 + 256, None],
                          blocks[c0:c0 + 256].long(), 256)
        counts[c0:c0 + 256].scatter_add_(1, ids, torch.ones_like(ids))
    return counts[:, :256]


def normalize_freqs_plain(counts: torch.Tensor,
                          bs: torch.Tensor) -> torch.Tensor:
    """Counts -> frequencies summing to exactly PROB_SCALE per block, bit
    for bit with wr_native.cc:563-589: floor(c*16384/bs) clamped up to 1
    for present symbols; a deficit goes to the first max-count symbol; an
    excess is stolen repeatedly from the first max frequency > 1."""
    counts = counts.long()
    bs = bs.long().to(counts.device)
    B = counts.shape[0]
    rows = torch.arange(B, device=counts.device)
    f = counts * PROB_SCALE // bs.clamp(min=1)[:, None]
    f = torch.where(counts > 0, f.clamp(min=1), 0)
    ssum = f.sum(1)
    maxs = counts.argmax(1)  # the first max, as the C++ strict '>'
    deficit = (PROB_SCALE - ssum).clamp(min=0)
    f[rows, maxs] += deficit
    ssum = ssum + deficit
    while bool((ssum > PROB_SCALE).any()):
        eligible = torch.where(f > 1, f, 0)
        b = eligible.argmax(1)
        take = torch.minimum(f[rows, b] - 1, ssum - PROB_SCALE).clamp(min=0)
        f[rows, b] -= take
        ssum = ssum - take
    return f


def block_models_plain(planes: torch.Tensor, n: int):
    """Plain version of kernel E: per block the model table
    `etab` (L*nb, 256) int32 = freq | cum<<16 (cum exclusive) and the
    number of distinct symbols `nsym` (L*nb,) int32."""
    counts = histogram_plain(planes, n)
    bs = torch.from_numpy(plane_bs(planes.shape[0], n)).to(planes.device)
    f = normalize_freqs_plain(counts, bs)
    cum = f.cumsum(1) - f
    etab = (f | (cum << 16)).to(torch.int32)
    nsym = (counts > 0).sum(1).to(torch.int32)
    return etab, nsym


def chain_plain(planes: torch.Tensor, n: int, etab: torch.Tensor):
    """Plain version of kernel F (rans.py `_encode_scan`): the 8 lane
    chains of every block, from the last group of 8 symbols to the first.

    Returns slab (L*nb, SLAB_WORDS) int16: each block's renormalization
    words in stream order (groups ascending, lanes ascending within a
    group), right-aligned, the rest zero; words that would land before
    the slab's start are dropped (raw blocks only). x_fin (L*nb, 8) int32
    final lane states, nwords (L*nb,) int32 words emitted.
    """
    L = planes.shape[0]
    dev = planes.device
    bs = torch.from_numpy(plane_bs(L, n)).to(dev)
    G = -(-int(bs.max()) // LANES)
    blocks = _blockify(planes, n, G * LANES)
    B = blocks.shape[0]
    lane = torch.arange(LANES, device=dev)
    words = torch.empty((B, G * LANES), dtype=torch.int32, device=dev)
    emits = torch.zeros((B, G * LANES), dtype=torch.bool, device=dev)
    x = torch.full((B, LANES), RANS_L, dtype=torch.int64, device=dev)
    for g in range(G - 1, -1, -1):
        sl = slice(g * LANES, (g + 1) * LANES)
        act = (g * LANES + lane)[None, :] < bs[:, None]
        e = etab.gather(1, blocks[:, sl].long()).long()  # pregather
        f, c = e & 0xFFFF, e >> 16
        emit = act & (x >= ((f << 18) & _M32))
        words[:, sl] = x & 0xFFFF
        emits[:, sl] = emit
        x1 = torch.where(emit, x >> 16, x)
        fs = f.clamp(min=1)
        q = x1 // fs
        xn = ((q << PROB_BITS) + (x1 - q * fs) + c) & _M32
        x = torch.where(act, xn, x)
    # words under emits, in stream order, right-aligned in the slab
    nwords = emits.sum(1, dtype=torch.int32)
    dst = emits.cumsum(1, dtype=torch.int32)
    dst.add_((SLAB_WORDS - 1 - nwords)[:, None])
    keep = emits & (dst >= 0)
    del emits
    slab = torch.zeros((B, SLAB_WORDS), dtype=torch.int16, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand_as(keep)
    slab[rows[keep], dst[keep].long()] = _i16_bits(words[keep])
    return slab, _i32_bits(x), nwords


def compact_plain(x_fin: torch.Tensor, slab: torch.Tensor,
                  nwords: torch.Tensor, dest: torch.Tensor,
                  total: int) -> torch.Tensor:
    """Plain version of kernel G (rans.py `_encode_compact`): every block
    with dest >= 0 writes, from word dest on, its 16 lane-state half-words
    (lane k low then high, k ascending) and then its nwords kept words.
    Returns the (total,) int16 payload buffer; words no block writes are
    zero."""
    dev = slab.device
    out = torch.zeros(total, dtype=torch.int16, device=dev)
    ids = torch.nonzero(dest >= 0).flatten()
    if not ids.numel():
        return out
    xs = _u32(x_fin)
    st = _i16_bits(torch.stack([xs & 0xFFFF, xs >> 16], 2).reshape(-1, 16))
    nw = nwords[ids].long()
    ln = nw + 16
    blk = torch.repeat_interleave(ids, ln)
    k = (torch.arange(int(ln.sum()), device=dev)
         - torch.repeat_interleave(ln.cumsum(0) - ln, ln))
    col = (SLAB_WORDS - torch.repeat_interleave(nw, ln) + k - 16).clamp(
        0, SLAB_WORDS - 1)
    val = torch.where(k < 16, st[blk, k.clamp(max=15)], slab[blk, col])
    out[dest[blk] + k] = val
    return out


def frame_table(L: int, n: int, tags: np.ndarray, wl: np.ndarray,
                dest: np.ndarray):
    """Where kernel I writes each block's frame: (table, lens), with table
    (L*nb, 4) int64 = (tag, byte offset of the frame, payload offset in
    words, payload length in words) and lens (L,) int64 the length of
    each plane's stream. A frame is 2 bytes for tag 2, 1 + bs for tag 1
    and 1 + 516 + 2*wl for tag 0, back to back in block order."""
    bs = plane_bs(L, n)
    size = np.where(tags == 2, 2, np.where(tags == 1, 1 + bs,
                                           1 + _HEADER + 2 * wl))
    table = np.stack([tags, np.cumsum(size) - size, dest, wl], 1)
    return table.astype(np.int64), size.reshape(L, -1).sum(1)


def _copy_spans(out: torch.Tensor, dst: torch.Tensor, data: torch.Tensor,
                src: torch.Tensor, length: torch.Tensor) -> None:
    """out[dst[i]:dst[i] + length[i]] = data[src[i]:src[i] + length[i]]
    for every i, 256 spans at a time (bounded index memory)."""
    for c in range(0, dst.numel(), 256):
        ln = length[c:c + 256]
        k = torch.arange(int(ln.max()), device=out.device)[None, :]
        keep = k < ln[:, None]
        out[(dst[c:c + 256, None] + k)[keep]] = \
            data[(src[c:c + 256, None] + k)[keep]]


def frame_plain(planes: torch.Tensor, etab: torch.Tensor,
                payload: torch.Tensor, table: torch.Tensor,
                total: int) -> torch.Tensor:
    """Plain version of kernel I: the (total,) uint8 frames of every block
    of the (L, n) planes at the offsets of the `frame_table` table: the
    tag; a constant block's symbol (its first); a raw block's bs bytes
    from the planes; a modeled block's u16 LE frequencies (`etab` &
    0xFFFF), u32 LE payload length 2*wl and the 2*wl bytes of `payload`
    (G's int16 words) from word dest."""
    L, n = planes.shape
    dev = planes.device
    nb = num_blocks(n)
    tag, boff, dest, wl = table.to(dev).unbind(1)
    b = torch.arange(tag.numel(), device=dev)
    start = (b // nb) * n + (b % nb) * TBLOCK
    flat = planes.reshape(-1)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    out[boff] = tag.to(torch.uint8)
    one = tag == 2
    out[boff[one] + 1] = flat[start[one]]
    raw = tag == 1
    bs = torch.from_numpy(plane_bs(L, n)).to(dev)
    _copy_spans(out, boff[raw] + 1, flat, start[raw], bs[raw])
    mod = tag == 0
    if bool(mod.any()):
        f = etab[mod].long() & 0xFFFF
        plen = 2 * wl[mod, None]
        head = torch.cat([torch.stack([f & 0xFF, f >> 8], 2).flatten(1),
                          (plen >> torch.arange(0, 32, 8, device=dev))
                          & 0xFF], 1)
        out[boff[mod, None] + 1 + torch.arange(_HEADER, device=dev)] = \
            head.to(torch.uint8)
        _copy_spans(out, boff[mod] + 1 + _HEADER, payload.view(torch.uint8),
                    2 * dest[mod], 2 * wl[mod])
    return out


def _models_from_bytes(data: torch.Tensor, off: torch.Tensor):
    """(freqs, cum) int64 (B, 256) of the models stored at byte offsets
    `off` of the uint8 tensor `data`."""
    idx = off[:, None] + 2 * torch.arange(256, device=data.device)[None, :]
    f = data[idx].long() | (data[idx + 1].long() << 8)
    return f, f.cumsum(1) - f


def decode_blocks_plain(data: torch.Tensor, table: torch.Tensor, L: int,
                        n: int) -> torch.Tensor:
    """Plain version of kernel H (rans.py `_decode_scan` and
    `_compose_planes`): every block of L planes of n symbols from the
    uint8 stream bytes `data`, with `table` (L*nb, 3) int64 = (tag, byte
    offset of the block's body after its tag, payload length) from
    `parse_planes`. Returns the (L, n) uint8 planes."""
    dev = data.device
    nb = num_blocks(n)
    out = torch.empty((L * nb, TBLOCK), dtype=torch.uint8, device=dev)
    bs = plane_bs(L, n)
    tag, off, plen = table.to(dev).unbind(1)
    for b, (t, o, _) in enumerate(table.tolist()):
        if t == 2:  # constant block: the symbol at o
            out[b, :bs[b]] = data[o]
        elif t == 1:  # raw block: bs verbatim bytes at o
            out[b, :bs[b]] = data[o:o + bs[b]]
    mod = torch.nonzero(tag == 0).flatten()
    if mod.numel():
        syms = _decode_chains_plain(data, off[mod], plen[mod],
                                    torch.from_numpy(bs).to(dev)[mod])
        out[mod, :syms.shape[1]] = syms
    return out.view(L, nb * TBLOCK)[:, :n].contiguous()


def _decode_chains_plain(data, off, plen, bs):
    """(B, G*8) uint8 symbols of the modeled blocks whose bodies start at
    byte `off` of `data`; columns past a block's bs are undefined."""
    dev = data.device
    B = off.numel()
    freqs, cum = _models_from_bytes(data, off)
    pay = off + _HEADER
    sidx = pay[:, None] + torch.arange(_STATE_BYTES, device=dev)[None, :]
    sb = data[sidx.clamp(max=data.numel() - 1)].long().view(B, LANES, 4)
    x = sb[..., 0] | (sb[..., 1] << 8) | (sb[..., 2] << 16) | (sb[..., 3] << 24)
    x = torch.where((plen > 0)[:, None], x, RANS_L)
    wlen = torch.where(plen > 0, (plen - _STATE_BYTES) // 2, 0)
    wbase = pay + _STATE_BYTES
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    G = -(-int(bs.max()) // LANES)
    lane = torch.arange(LANES, device=dev)
    syms = torch.empty((B, G * LANES), dtype=torch.uint8, device=dev)
    for g in range(G):
        active = (g * LANES + lane)[None, :] < bs[:, None]
        slot = x & (PROB_SCALE - 1)
        s = torch.searchsorted(cum, slot, right=True) - 1
        f, c = freqs.gather(1, s), cum.gather(1, s)
        syms[:, g * LANES:(g + 1) * LANES] = s
        xn = (f * (x >> PROB_BITS) + slot - c) & _M32
        need = active & (xn < RANS_L)
        ni = need.long()
        widx = cur[:, None] + ni.cumsum(1) - ni
        can = need & (widx < wlen[:, None])
        wi = (wbase[:, None] + 2 * widx).clamp(0, data.numel() - 2)
        w = data[wi].long() | (data[wi + 1].long() << 8)
        xn = torch.where(can, ((xn << 16) | w) & _M32, xn)
        x = torch.where(active, xn, x)
        cur = cur + can.sum(1)
    return syms


# ----------------------------------------------------------------------------
# Dispatch by device: the plain version for CPU tensors, the kernel for CUDA
# tensors.
# ----------------------------------------------------------------------------
def _cuda_or_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def block_models(planes: torch.Tensor, n: int):
    if _cuda_or_cpu(planes):
        from . import rans_cuda
        return rans_cuda.rans_hist(planes, n)
    return block_models_plain(planes, n)


def encode_chain(planes: torch.Tensor, n: int, etab: torch.Tensor):
    if _cuda_or_cpu(planes):
        from . import rans_cuda
        return rans_cuda.rans_chain(planes, n, etab)
    return chain_plain(planes, n, etab)


def compact(x_fin, slab, nwords, dest, total: int) -> torch.Tensor:
    if _cuda_or_cpu(slab):
        from . import rans_cuda
        return rans_cuda.rans_compact(x_fin, slab, nwords, dest, total)
    return compact_plain(x_fin, slab, nwords, dest, total)


def frame_blocks(planes, etab, payload, table, total: int) -> torch.Tensor:
    if _cuda_or_cpu(planes):
        from . import rans_cuda
        return rans_cuda.rans_frame(planes, etab, payload, table, total)
    return frame_plain(planes, etab, payload, table, total)


def decode_blocks(data: torch.Tensor, table: torch.Tensor, L: int,
                  n: int) -> torch.Tensor:
    if _cuda_or_cpu(data):
        from . import rans_cuda
        return rans_cuda.rans_decode(data, table, L, n)
    return decode_blocks_plain(data, table, L, n)


# ----------------------------------------------------------------------------
# Encode: device stages, one host sync, the frames written on the device.
# ----------------------------------------------------------------------------
class CodedBlocks(NamedTuple):
    """The encode's per-block results before framing: the layout on the
    host (numpy, per block), the models and the payloads on the planes'
    device."""
    L: int
    n: int
    tags: np.ndarray        # format tag per block
    wl: np.ndarray          # payload length in words (modeled blocks)
    dest: np.ndarray        # payload offset in words (modeled blocks)
    etab: torch.Tensor      # (L*nb, 256) int32 freq | cum<<16 (E)
    payload: torch.Tensor   # (sum wl,) int16 payloads back to back (G)


class EncodedBlocks(NamedTuple):
    """The per-block results that the host frames (`frame`): the layout
    on the host (numpy, per block) and three tensors, on the device until
    `fetch` copies them to the host."""
    L: int
    n: int
    tags: np.ndarray        # format tag per block
    wl: np.ndarray          # payload length in words (modeled blocks)
    dest: np.ndarray        # payload offset in words (modeled blocks)
    freqs: torch.Tensor     # (L*nb, 256) int16 model frequencies
    payload: torch.Tensor   # (sum wl,) int16 payloads back to back
    raw: torch.Tensor       # uint8 bytes of the raw blocks back to back


def encode_planes_joined(planes: torch.Tensor, n: int):
    """Encode (L, n) uint8 planes to L format-v2 streams, back to back in
    one `bytes`; returns it and the (L,) int64 stream lengths (the layout
    of `EncodedField.data`).

    Each stream is byte-identical to `native.encode_plane(p, coder=1)`. On
    a CUDA tensor the kernels E, F, G and I run there and one copy brings
    the streams to the host: the card writes every frame.
    """
    if planes.dim() != 2 or planes.dtype != torch.uint8 \
            or planes.shape[1] != n:
        raise ValueError(f"expected (L, {n}) uint8 planes, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    L = planes.shape[0]
    if n == 0 or L == 0:
        return b"", np.zeros(L, np.int64)
    planes = planes.contiguous()
    if planes.data_ptr() % 16:  # a row view: F needs a 16-byte aligned base
        planes = planes.clone()
    with timed("encode.entropy"):
        c = code_blocks(planes, n)
    with timed("encode.frame"):
        table, lens = frame_table(L, n, c.tags, c.wl, c.dest)
        buf = frame_blocks(planes, c.etab, c.payload,
                           torch.from_numpy(table).to(planes.device),
                           int(lens.sum()))
        del c
    with timed("encode.d2h"):
        return staging.to_host_bytes(buf), lens


def encode_planes_device(planes: torch.Tensor, n: int) -> list[bytes]:
    """Encode (L, n) uint8 planes to L format-v2 streams: those of
    `encode_planes_joined`, one `bytes` each.

    Byte-identical to `native.encode_plane(p, coder=1)` per plane.
    """
    data, lens = encode_planes_joined(planes, n)
    ends = np.cumsum(lens)
    return [data[e - ln:e] for e, ln in zip(ends.tolist(), lens.tolist())]


def code_blocks(planes: torch.Tensor, n: int, mark=None) -> CodedBlocks:
    """The device stage of the encode of non-empty contiguous (L, n)
    planes: E, F, the one host sync for the data-dependent layout, and G.
    `mark`, if given, is called with each step's name as it ends (a
    timer's hook)."""
    mark = mark or (lambda step: None)
    L = planes.shape[0]
    dev = planes.device
    etab, nsym = block_models(planes, n)
    mark("hist")
    slab, x_fin, nwords = encode_chain(planes, n, etab)
    mark("chain")
    nsym_h, nwords_h = torch.stack([nsym, nwords]).cpu().numpy()
    bs = plane_bs(L, n)
    tags, wl, dest = block_layout(bs, nsym_h, nwords_h)
    mark("layout_sync")
    payload = compact(x_fin, slab, nwords, torch.from_numpy(dest).to(dev),
                      int(wl.sum()))
    mark("compact")
    return CodedBlocks(L, n, tags, wl, dest, etab, payload)


def encode_blocks(planes: torch.Tensor, n: int, mark=None) -> EncodedBlocks:
    """`code_blocks`, then the gather of the raw blocks' bytes, for
    framing on the host (`fetch`, then `frame`)."""
    mark = mark or (lambda step: None)
    c = code_blocks(planes, n, mark)
    nb = num_blocks(n)
    bs = plane_bs(c.L, n)
    raw = torch.cat([planes[b // nb, (b % nb) * TBLOCK:][:bs[b]]
                     for b in np.nonzero(c.tags == 1)[0]]
                    or [planes.new_empty(0)])
    mark("raw_gather")
    freqs = (c.etab & 0xFFFF).to(torch.int16)  # <= 16384: exact
    return EncodedBlocks(c.L, n, c.tags, c.wl, c.dest, freqs, c.payload,
                         raw)


def fetch(enc: EncodedBlocks) -> EncodedBlocks:
    """Copy the models, payloads and raw bytes to the host."""
    return enc._replace(freqs=enc.freqs.cpu(), payload=enc.payload.cpu(),
                        raw=enc.raw.cpu())


def frame(enc: EncodedBlocks) -> list[bytes]:
    """Per-plane containers from fetched per-block results, framed on the
    host (rans.py `_assemble_blocks`): kernel I's function, for a caller
    that frames on a host thread."""
    freqs = enc.freqs.numpy()
    freq_mv = memoryview(freqs.view(np.uint8).ravel())
    pay_mv = memoryview(enc.payload.numpy().view(np.uint8))
    raw_mv = memoryview(enc.raw.numpy())
    only = np.argmax(freqs, axis=1)
    bs, tags, wl, dest = plane_bs(enc.L, enc.n), enc.tags, enc.wl, enc.dest
    nb = num_blocks(enc.n)
    out, r = [], 0
    for ip in range(enc.L):
        parts = []
        for b in range(ip * nb, (ip + 1) * nb):
            if tags[b] == 2:
                parts.append(bytes((2, int(only[b]))))
            elif tags[b] == 1:
                parts += [b"\x01", raw_mv[r:r + int(bs[b])]]
                r += int(bs[b])
            else:
                o = 2 * int(dest[b])
                parts += [b"\x00", freq_mv[b * 512:(b + 1) * 512],
                          int(2 * wl[b]).to_bytes(4, "little"),
                          pay_mv[o:o + 2 * int(wl[b])]]
        out.append(b"".join(parts))
    return out


# ----------------------------------------------------------------------------
# Decode: numpy parse, one upload of the compressed bytes, kernel H.
# ----------------------------------------------------------------------------
def _parse_stream(mv: memoryview, start: int, end: int, n: int, rows: list):
    """Walk one v2 container in mv[start:end]; append (tag, body offset,
    payload length) per block to `rows`. Corrupt framing raises the
    ValueErrors of rans.py `_parse_stream`."""
    total = end
    pos, r = 0, start
    while pos < n:
        bsz = min(TBLOCK, n - pos)
        if r >= total:
            raise ValueError(
                f"corrupt v2 stream: truncated at block tag (offset "
                f"{r - start} of {total - start}, {n - pos} symbols missing)")
        tag = mv[r]
        r += 1
        if tag == 2:
            if r >= total:
                raise ValueError(
                    "corrupt v2 stream: truncated constant block")
            rows.append((2, r, 0))
            r += 1
        elif tag == 1:
            if r + bsz > total:
                raise ValueError(
                    f"corrupt v2 stream: raw block declares {bsz} bytes, "
                    f"{total - r} remain")
            rows.append((1, r, 0))
            r += bsz
        elif tag == 0:
            if r + _HEADER > total:
                raise ValueError(
                    "corrupt v2 stream: truncated model header "
                    f"({total - r} of 516 bytes)")
            plen = int.from_bytes(mv[r + 512:r + 516], "little")
            if plen and (plen < _STATE_BYTES or r + _HEADER + plen > total):
                raise ValueError(
                    f"corrupt v2 stream: block payload length {plen} "
                    f"invalid ({total - r - _HEADER} bytes remain)")
            rows.append((0, r, plen))
            r += _HEADER + plen
        else:
            raise ValueError(f"corrupt v2 stream: unknown block tag {tag}")
        pos += bsz


def parse_planes(data, lens, n: int) -> np.ndarray:
    """The per-block table of L back-to-back v2 streams of n symbols each
    (stream i is `lens[i]` bytes of `data`): (L*nb, 3) int64 = (tag, byte
    offset in `data` of the block's body after its tag, payload length).

    Raises ValueError on corrupt framing, and on a modeled block whose
    frequencies do not sum to 16384 (kernel H would index its tables out
    of range; the C++ decoder stops there, wr_native.cc:825)."""
    mv = memoryview(data).cast("B")
    rows: list = []
    start = 0
    for ln in lens:
        ln = int(ln)
        if start + ln > len(mv):
            raise ValueError("corrupt v2 stream: stream lengths exceed the "
                             "data")
        _parse_stream(mv, start, start + ln, n, rows)
        start += ln
    table = np.asarray(rows, np.int64).reshape(-1, 3)
    mod = table[table[:, 0] == 0, 1]
    if mod.size:
        raw = np.frombuffer(mv, np.uint8)
        idx = mod[:, None] + np.arange(_MODEL_BYTES)[None, :]
        sums = raw[idx].reshape(-1, 256, 2).astype(np.int64)
        sums = (sums[..., 0] | (sums[..., 1] << 8)).sum(1)
        bad = np.nonzero(sums != PROB_SCALE)[0]
        if bad.size:
            raise ValueError(
                f"corrupt v2 stream: block model sums to {sums[bad[0]]}, "
                f"not {PROB_SCALE}")
    return table


def decode_planes_device(streams, n: int, device="cuda",
                         lens=None) -> torch.Tensor:
    """Decode L v2 streams of n symbols each to an (L, n) uint8 tensor on
    `device`.

    `streams` is a list of per-plane streams, or one bytes-like buffer
    holding them back to back with `lens` their lengths (the layout of
    `EncodedField.data`). Only those bytes and the (L*nb, 3) block table
    are copied to the device; on a CUDA device kernel H decodes every
    block into the planes, which stay there.
    """
    if lens is None:
        lens = [len(s) for s in streams]
        streams = b"".join(bytes(s) for s in streams)
    L = len(lens)
    dev = torch.device(device)
    if n == 0 or L == 0:
        return torch.empty((L, n), dtype=torch.uint8, device=dev)
    with timed("decode.parse"):
        table = parse_planes(streams, lens, n)
    with timed("decode.h2d"):
        data = staging.to_device(
            np.frombuffer(memoryview(streams).cast("B"), np.uint8), dev)
        table = torch.from_numpy(table).to(dev)
    with timed("decode.entropy"):
        return decode_blocks(data, table, L, n)


# ----------------------------------------------------------------------------
# The ragged plane API: planes of any lengths, one stream each.
# ----------------------------------------------------------------------------
def _by_length(ns) -> dict:
    """Input positions grouped by length, in first-seen order."""
    groups: dict = {}
    for i, n in enumerate(ns):
        groups.setdefault(int(n), []).append(i)
    return groups


def encode_planes(planes, device="cuda") -> list[bytes]:
    """Encode 1-D uint8 planes of any lengths (0 included) to one format-v2
    stream each, in input order; an empty plane gives b"".

    Byte-identical to `native.encode_plane(p, coder=1)` per plane (the
    ragged `encode_planes` of `waverange_tpu.ops.rans`). The planes of
    one length go to `device` as one fresh contiguous (k, n) upload and
    through `encode_planes_device` (E, F, G, I on a CUDA device): no plane
    is padded to another's length.
    """
    from ..core.codec import _device
    dev = _device(device)
    host = [np.ascontiguousarray(p, np.uint8).ravel() for p in planes]
    out = [b""] * len(host)
    for n, idx in _by_length(p.size for p in host).items():
        if n == 0:
            continue
        group = torch.from_numpy(np.stack([host[i] for i in idx])).to(dev)
        for i, s in zip(idx, encode_planes_device(group, n)):
            out[i] = s
        del group
    return out


def decode_planes(streams, ns, device="cuda") -> list[np.ndarray]:
    """Decode format-v2 streams, stream i to `ns[i]` uint8 symbols, in input
    order (the ragged `decode_planes` of `waverange_tpu.ops.rans`).

    Byte-identical to `native.decode_plane(s, n, coder=1)`. The streams of
    one length are decoded together by `decode_planes_device` (kernel H on
    a CUDA device); corrupt framing raises the ValueErrors of
    `parse_planes`.
    """
    from ..core.codec import _device
    dev = _device(device)
    if len(streams) != len(ns):
        raise ValueError(f"{len(streams)} streams for {len(ns)} lengths")
    out = [np.empty(0, np.uint8)] * len(ns)
    for n, idx in _by_length(ns).items():
        if n == 0:
            continue
        syms = decode_planes_device([streams[i] for i in idx], n,
                                    device=dev).cpu().numpy()
        for i, row in zip(idx, syms):
            out[i] = row
    return out


def decode_compute_seconds(streams, n: int, device="cuda") -> float:
    """The device decode alone, in seconds (the compute-only probe of
    `waverange_tpu.ops.rans`): L streams of n symbols are parsed and
    uploaded once, decoded once to warm up, then `decode_blocks` is timed
    on the resident inputs. On a CUDA device the time is taken between
    two synchronizes, so neither the kernels' build nor the parse is in
    it; on the CPU it times the plain version.
    """
    from ..core.codec import _device
    dev = _device(device)
    lens = [len(s) for s in streams]
    data = b"".join(bytes(s) for s in streams)
    table = parse_planes(data, lens, n)
    data_d = bytes_tensor(data).to(dev)
    table_d = torch.from_numpy(table).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    decode_blocks(data_d, table_d, len(lens), n)
    sync()
    t0 = time.perf_counter()
    decode_blocks(data_d, table_d, len(lens), n)
    sync()
    return time.perf_counter() - t0


def bytes_tensor(data) -> torch.Tensor:
    """A uint8 CPU tensor over the bytes-like `data`, without a copy. The
    tensor is read, or copied to the device, and never written."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only buffer
        return torch.frombuffer(memoryview(data).cast("B"),
                                dtype=torch.uint8)
