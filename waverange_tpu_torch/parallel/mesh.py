"""Multi-device execution on `torch.distributed`: one process per device.

Port of `waverange_tpu.parallel.mesh`. A group of processes takes the
place of the JAX mesh (`make_group`); each process drives one device and
holds its part of the data, and the collectives run on the device's
backend (NCCL for CUDA tensors, gloo for CPU tensors). With no group a
single process is a world of one.

  * **Field data-parallelism** (`encode_fields_sharded` /
    `decode_fields_sharded`): each rank takes a contiguous share of a
    batch of equal-shaped fields, runs the single-device step on each on
    its device, and range-codes the symbol planes on a thread pool with at
    most threads + 2 planes on the host at once; the records are
    exchanged in file order, so every rank returns all of them.
  * **Divided mode** (`encode_field_divided` / `decode_field_divided`):
    one field split into z-slabs, each an independent subdomain stream
    (the reference's PROCID files, mssg_enc.cpp:457-470).
  * **United mode** (`united_encode_step`): each rank holds a z-slab; the
    global min/max is all-reduced, the slabs all-gathered, and the whole
    field encoded on every rank (mssg_enc.cpp:522-543).
  * **The distributed transform** (`distributed_encode_step` /
    `distributed_decode_step`): every level's x and y passes run on the
    local slab, its z pass on an all-to-all transpose to y-slabs, and the
    low-pass corner moves to a compact z-sharding for the next level; the
    quantizer runs on the local slab under the all-reduced min/max of
    each layer. Its symbol planes are the single-device planes, z-major,
    cut into the ranks' slabs.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import native as wn
from ..core.codec import (NLAYMAX, WAV_LVL, EncodedField, _device, _record,
                          coder_id_for_version, decode_planes, record_meta,
                          step_meta, with_payload)
from ..ops.quant import (accumulate_layers, encode_step, field_params,
                         quantize_layers)
from ..ops.wavelet import cdf97_forward, cdf97_inverse, lift_pass
from .distributed import World, exchange_bytes


def make_group(n: Optional[int] = None):
    """The group of the default group's first `n` ranks (all of them when
    None): the counterpart of `make_mesh`. A group of fewer ranks is made
    by `dist.new_group`, which every rank calls. None where no process
    group was initialized: a world of one."""
    if not (dist.is_available() and dist.is_initialized()):
        if n not in (None, 1):
            raise ValueError(f"a group of {n} needs an initialized process "
                             "group (init_distributed)")
        return None
    if n is None or n == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


# ---------------------------------------------------------------------------
# Field data-parallelism over a leading field axis
# ---------------------------------------------------------------------------

def encode_fields_sharded(fields: np.ndarray, tolrel: float, group=None,
                          wtflag: int = 1,
                          backend_threads: Optional[int] = None,
                          device="cuda") -> List[EncodedField]:
    """Encode a batch of equally-shaped fields, shared over the group.

    fields: (B, nz, ny, nx), on every rank; each rank encodes its
    contiguous share of the B fields (`World.share`, no padding) on
    `device`, one field at a time, with the range coder. Every rank
    returns the B records in file order, each byte-identical to the
    single-field codec's. A trivial field's `wlev` follows native (4 with
    `wtflag`), as the port's codec does.
    """
    world = World(group)
    dev = _device(device)
    world.check_device(dev)
    B, nz, ny, nx = fields.shape
    lo, hi = world.share(B)
    metas = {}

    def planes():
        for b in range(lo, hi):
            x = torch.from_numpy(
                np.ascontiguousarray(fields[b], np.float64)).to(dev)
            step = encode_step(x, tolrel, wtflag=bool(wtflag),
                               levels=WAV_LVL)
            del x
            metas[b], nl = step_meta(step, WAV_LVL if wtflag else 0)
            for lay in range(nl):
                yield (b, lay), step[0][lay]

    streams = _stream_code_planes(planes(), backend_threads)
    local = []
    for b in range(lo, hi):
        chunks = [streams[(b, lay)] for lay in range(metas[b]["nlay"])]
        meta = with_payload(metas[b], b"".join(chunks),
                            [len(c) for c in chunks])
        local.append(_record(meta, (nz, ny, nx), 0))
    if world.size == 1:
        return local
    parts = exchange_bytes(world, [_pack(e) for e in local])
    return [_unpack(blob) for part in parts for blob in part]


_INTS = ("nx", "ny", "nz", "wlev", "nlay", "ntot_enc", "coder_version")
_FLOATS = ("tolabs", "midval", "halfspanval")
_HEAD = 8 * (len(_INTS) + len(_FLOATS) + 3 * NLAYMAX)


def _pack(e: EncodedField) -> bytes:
    """A record as bytes, for the exchange between ranks."""
    return b"".join([
        np.array([getattr(e, k) for k in _INTS], np.int64).tobytes(),
        np.array([getattr(e, k) for k in _FLOATS], np.float64).tobytes(),
        np.asarray(e.deps_vec, np.float64).tobytes(),
        np.asarray(e.minval_vec, np.float64).tobytes(),
        np.asarray(e.len_enc_vec, np.uint64).tobytes(), e.data])


def _unpack(blob: bytes) -> EncodedField:
    ints = np.frombuffer(blob, np.int64, len(_INTS))
    vals = np.frombuffer(blob, np.float64, len(_FLOATS) + 2 * NLAYMAX,
                         8 * len(_INTS))
    lens = np.frombuffer(blob, np.uint64, NLAYMAX, _HEAD - 8 * NLAYMAX)
    rec = {k: int(v) for k, v in zip(_INTS, ints)}
    return EncodedField(
        **rec,
        **{k: float(v) for k, v in zip(_FLOATS, vals)},
        deps_vec=vals[3:3 + NLAYMAX].copy(),
        minval_vec=vals[3 + NLAYMAX:].copy(), len_enc_vec=lens.copy(),
        data=blob[_HEAD:_HEAD + rec["ntot_enc"]])


class _Slots:
    """The threads + 2 host slots of symbol planes (the native coder's
    slot pool, wr_native.cc encode loop), with the peak count held."""

    def __init__(self, nthreads: int):
        self._sem = threading.Semaphore(nthreads + 2)
        self._lock = threading.Lock()
        self.resident = 0
        self.peak = 0

    def take(self) -> None:
        self._sem.acquire()
        with self._lock:
            self.resident += 1
            self.peak = max(self.peak, self.resident)

    def give(self) -> None:
        with self._lock:
            self.resident -= 1
        self._sem.release()


#: test hook — peak count of host-resident symbol planes during the last
#: `_stream_code_planes` call (must stay <= threads + 2).
_last_peak_resident = 0


def _stream_code_planes(items, backend_threads: Optional[int] = None):
    """Range-code device planes with bounded host residency.

    `items` yields ((b, l), device plane); a plane is copied to the host
    only when one of threads + 2 slots is free (the native coder's slot
    pool) and coded on a thread pool, so at most threads + 2 planes live
    on the host at any instant whatever the batch. Returns {(b, l):
    stream}."""
    global _last_peak_resident
    nthreads = backend_threads or os.cpu_count() or 1
    slots = _Slots(nthreads)
    streams = {}

    def code_one(key, plane_host):
        try:
            streams[key] = wn.encode_plane(plane_host)
        finally:
            slots.give()

    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        futs = []
        for key, plane in items:
            slots.take()
            futs.append(pool.submit(code_one, key, plane.cpu().numpy()))
        for f in futs:
            f.result()
    _last_peak_resident = slots.peak
    return streams


#: test hook — peak count of host-resident symbol planes during the last
#: `_stream_decode_planes` call (must stay <= threads + 2).
_last_peak_resident_decode = 0


def _stream_decode_planes(encs: Sequence, fields: Sequence[int], n: int,
                          dev: torch.device,
                          backend_threads: Optional[int] = None):
    """Entropy-decode the records `encs[b]`, b in `fields`, with bounded
    host residency, and yield (b, its (nlay, n) planes on `dev`) in order.

    A plane is decoded only when one of threads + 2 slots is free and is
    uploaded into its field's planes as soon as it is ready, so at most
    threads + 2 planes live on the host at any instant. The next field's
    planes decode while the caller works on the one yielded, so at most
    two fields' planes are on the device."""
    global _last_peak_resident_decode
    nthreads = backend_threads or os.cpu_count() or 1
    slots = _Slots(nthreads)

    def one(dst, data, coder):
        try:
            dst.copy_(torch.from_numpy(wn.decode_plane(data, n,
                                                       coder=coder)))
        finally:
            slots.give()

    def ready(b, planes, futs):
        for f in futs:
            f.result()
        return b, planes

    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        pending = None
        for b in fields:
            e = encs[b]
            planes = torch.empty((e.nlay, n), dtype=torch.uint8, device=dev)
            offs = np.concatenate(
                [[0], np.cumsum(e.len_enc_vec[:e.nlay])]).astype(int)
            cid = coder_id_for_version(e.coder_version)
            futs = []
            for lay in range(e.nlay):
                slots.take()
                futs.append(pool.submit(one, planes[lay],
                                        e.data[offs[lay]:offs[lay + 1]],
                                        cid))
            if pending is not None:
                yield ready(*pending)
            pending = (b, planes, futs)
        if pending is not None:
            yield ready(*pending)
    _last_peak_resident_decode = slots.peak


def decode_fields_sharded(encs: Sequence, group=None,
                          backend_threads: Optional[int] = None,
                          device="cuda") -> np.ndarray:
    """Decode equally-shaped records, shared over the group: each rank
    decodes its contiguous share, field by field (streamed host entropy
    decode, then kernel D and the inverse transform on `device`; a
    `wlev == 0` record with no transform, a trivial one to its midval).
    Every rank returns the (B, nz, ny, nx) float64 array in record
    order."""
    world = World(group)
    dev = _device(device)
    world.check_device(dev)
    B = len(encs)
    shape = tuple(encs[0].shape_zyx)
    n = int(np.prod(shape))
    out = np.empty((B,) + shape)
    lo, hi = world.share(B)
    for b in range(lo, hi):
        if encs[b].ntot_enc == 0:
            out[b] = encs[b].midval
    live = [b for b in range(lo, hi) if encs[b].ntot_enc]
    for b, planes in _stream_decode_planes(encs, live, n, dev,
                                           backend_threads):
        torch.from_numpy(out[b]).copy_(
            decode_planes(record_meta(encs[b]), planes, shape))
    if world.size > 1:
        # every rank's block of fields, from it to all (host bytes)
        g = world.host_group()
        ranks = dist.get_process_group_ranks(g)
        flat = torch.from_numpy(out.reshape(B, n))
        for r in range(world.size):
            a, z = world.share(B, r)
            if z > a:
                dist.broadcast(flat[a:z], ranks[r], group=g)
    return out


# ---------------------------------------------------------------------------
# Divided mode: one big field -> z-slab subdomains
# ---------------------------------------------------------------------------

def encode_field_divided(fld: np.ndarray, tolrel: float,
                         n_blocks: Optional[int] = None, group=None,
                         wtflag: int = 1,
                         device="cuda") -> List[EncodedField]:
    """Split (nz, ny, nx) into `n_blocks` z-slabs (one a rank by default)
    and encode each as an independent subdomain (the reference's
    backup-divided semantics, PROCID == slab index)."""
    nz = fld.shape[0]
    if n_blocks is None:
        n_blocks = World(group).size
    if nz % n_blocks:
        raise ValueError(f"nz = {nz} does not divide into {n_blocks} equal "
                         "slabs")
    slabs = np.ascontiguousarray(fld, np.float64).reshape(
        (n_blocks, nz // n_blocks) + tuple(fld.shape[1:]))
    return encode_fields_sharded(slabs, tolrel, group=group, wtflag=wtflag,
                                 device=device)


def decode_field_divided(encs: Sequence, group=None,
                         device="cuda") -> np.ndarray:
    slabs = decode_fields_sharded(encs, group=group, device=device)
    return slabs.reshape((-1,) + slabs.shape[2:])


# ---------------------------------------------------------------------------
# Collectives of the device data
# ---------------------------------------------------------------------------

def _min_max(world: World, mn: torch.Tensor, mx: torch.Tensor):
    """The (min, max) over the group of each rank's 0-d pair: one MIN
    all-reduce of (min, -max), on the device."""
    if world.group is None:
        return mn, mx
    t = torch.stack([mn, -mx])
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=world.group)
    return t[0], -t[1]


def _gather_rows(world: World, part: torch.Tensor) -> torch.Tensor:
    """A new tensor of every rank's `part`, concatenated along dim 0 in
    rank order (all-gather: exact, whatever the sign of a zero)."""
    part = part.contiguous()
    if world.group is None:
        return part.clone()
    out = torch.empty((world.size * part.shape[0],) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(out, part, group=world.group)
    return out


def _all_to_all(world: World, send: torch.Tensor) -> torch.Tensor:
    """Chunk j of the contiguous (D, ...) `send` to rank j; returns (D, ...)
    whose chunk i came from rank i (`send` itself with no group)."""
    if world.group is None:
        return send
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=world.group)
    return recv


def _p2p(world: World, ops) -> None:
    """Run (isend | irecv, tensor, group rank) triples as one batch."""
    if not ops:
        return
    ranks = dist.get_process_group_ranks(world.group)
    reqs = dist.batch_isend_irecv([dist.P2POp(op, t, ranks[r], world.group)
                                   for op, t, r in ops])
    for req in reqs:
        req.wait()


def _check_slab(world: World, slab: torch.Tensor, shape) -> None:
    world.check_device(slab.device)
    nz, ny, nx = shape
    want = (nz // world.size, ny, nx)
    if nz % world.size or tuple(slab.shape) != want:
        raise ValueError(f"expected this rank's z-slab {want} of {shape} "
                         f"over {world.size} ranks, got "
                         f"{tuple(slab.shape)}")


# ---------------------------------------------------------------------------
# United mode: global field from per-rank slabs
# ---------------------------------------------------------------------------

def united_encode_step(group, shape, levels: int = WAV_LVL):
    """A united-mode encode step over `group` for fields of `shape`.

    Returns run(slab, tolrel) -> (planes, deps, minv, nlay, tolabs, midval,
    halfspan, trivial), the whole field's, on every rank. `slab` is this
    rank's (nz/D, ny, nx) z-slab on its device. The global min/max is
    all-reduced, the slabs all-gathered, and the whole field encoded with
    the single-device arithmetic (the reference's gather-then-encode,
    mssg_enc.cpp:522-543).
    """
    world = World(group)

    def run(slab: torch.Tensor, tolrel: float):
        _check_slab(world, slab, shape)
        mn, mx = _min_max(world, *torch.aminmax(slab))
        full = _gather_rows(world, slab)
        tolabs, midval, halfspan, trivial = field_params(mn, mx, tolrel,
                                                         slab.dtype)
        cdf97_forward(full, levels)
        planes, deps, minv, nlay = quantize_layers(full.view(-1),
                                                   tolabs.to(slab.dtype))
        return planes, deps, minv, nlay, tolabs, midval, halfspan, trivial

    return run


# ---------------------------------------------------------------------------
# Distributed united mode: the transform and the quantizer on the slabs
# ---------------------------------------------------------------------------

def _divisible_through(shape, levels: int, D: int) -> bool:
    """Does the distributed step take `shape` over D ranks (else it falls
    back to the united step): nz divisible by 2D, ny by D, and every
    extent even through `levels` halvings."""
    nz, ny, nx = shape
    if nz % (2 * D) or ny % D:
        return False
    a = [nz, ny, nx]
    for _ in range(levels):
        if any(v % 2 for v in a):
            return False
        a = [v // 2 for v in a]
    return True


def distributed_encode_step(group, shape, levels: int = WAV_LVL):
    """United-mode encode with the transform itself distributed.

    Returns run(slab, tolrel) -> (planes, deps, minv, nlay, tolabs, midval,
    halfspan, trivial) where `planes` (8, n/D) are this rank's part of the
    single-device planes (z-major, so the ranks' parts in rank order are
    the whole), and the rest the whole field's, on every rank. `slab` is
    this rank's (nz/D, ny, nx) z-slab on its device.

    Every level runs distributed (`_dist_fwd`), and the 8-layer quantizer
    runs on the local slab under the all-reduced min/max of each layer:
    kernel C unchanged. Shapes outside `_divisible_through` fall back to
    the united step, as the reference does; its planes are then cut to
    this rank's part.
    """
    world = World(group)
    if not _divisible_through(shape, levels, world.size):
        united = united_encode_step(group, shape, levels)

        def run_fallback(slab: torch.Tensor, tolrel: float):
            planes, *rest = united(slab, tolrel)
            m = slab.numel()
            part = planes[:, world.rank * m:(world.rank + 1) * m]
            return (part.contiguous(), *rest)

        return run_fallback

    def run(slab: torch.Tensor, tolrel: float):
        _check_slab(world, slab, shape)
        mn, mx = _min_max(world, *torch.aminmax(slab))
        tolabs, midval, halfspan, trivial = field_params(mn, mx, tolrel,
                                                         slab.dtype)
        w = slab.clone(memory_format=torch.contiguous_format)
        _dist_fwd(world, w, tuple(shape), levels)
        planes, deps, minv, nlay = quantize_layers(
            w.view(-1), tolabs.to(slab.dtype),
            reduce=partial(_min_max, world))
        return planes, deps, minv, nlay, tolabs, midval, halfspan, trivial

    return run


def distributed_decode_step(group, shape, levels: int = WAV_LVL):
    """The decode counterpart of `distributed_encode_step`.

    Returns run(planes, deps, minv) -> this rank's (nz/D, ny, nx) z-slab of
    the decoded field, on the planes' device; `planes` (nlay, n/D) is this
    rank's part. The layer sum (kernel D) runs on the local part, then
    the inverse transform distributed (`_dist_inv`); shapes outside
    `_divisible_through` gather the summed slabs and invert the whole
    field on every rank, as the reference's fallback decodes whole.
    """
    world = World(group)
    nz, ny, nx = shape
    ok = _divisible_through(shape, levels, world.size)

    def run(planes: torch.Tensor, deps: torch.Tensor, minv: torch.Tensor):
        world.check_device(planes.device)
        sl = accumulate_layers(planes, deps, minv).view(nz // world.size,
                                                        ny, nx)
        if ok:
            _dist_inv(world, sl, tuple(shape), levels)
        else:
            _replicated(world, sl, tuple(shape), levels, cdf97_inverse)
        return sl

    return run


# ---------------------------------------------------------------------------
# The distributed multiresolution transform
#
# A level's active box (az, ay, ax) is z-sharded compactly: rank r holds
# its rows r*az/D .. (r+1)*az/D - 1 as the sub-box [:az/D, :ay, :ax] at the
# origin of a buffer. After the level, the box's low-pass z rows
# 0 .. az/2 - 1 lie on ranks 0 .. ceil(D/2) - 1, 2c = az/D rows each; rank
# k takes rows k*c .. (k+1)*c - 1 of them, which are part k % 2 of rank
# k // 2's rows. Only the low-pass corner (c, ay/2, ax/2) of those rows
# moves: the next level transforms nothing else. Rank 0's part 0 is its
# own and stays where it is, so on one rank nothing moves at all.
# ---------------------------------------------------------------------------

def _level_divisible(az: int, ay: int, ax: int, D: int) -> bool:
    """Can level (az, ay, ax) be transformed fully sharded over D ranks?"""
    return (az % (2 * D) == 0 and ay % D == 0 and ay % 2 == 0
            and ax % 2 == 0)


def _replicated(world: World, buf: torch.Tensor, ext, lvls: int,
                transform) -> None:
    """`lvls` levels of the box `ext` whole on every rank (a level that
    stops dividing): the ranks' rows all-gathered, transformed, and this
    rank's rows kept."""
    az, ay, ax = ext
    azl = az // world.size
    local = buf[:azl, :ay, :ax]
    box = _gather_rows(world, local)
    transform(box, lvls)
    local.copy_(box[world.rank * azl:(world.rank + 1) * azl])


def _to_z(world: World, part: torch.Tensor) -> torch.Tensor:
    """(azl, ay, ax) z-rows of the box to its (az, ay/D, ax) y-slab."""
    D = world.size
    azl, ay, ax = part.shape
    send = part.view(azl, D, ay // D, ax).transpose(0, 1).contiguous()
    return _all_to_all(world, send).view(D * azl, ay // D, ax)


def _from_z(world: World, t: torch.Tensor, part: torch.Tensor) -> None:
    """The inverse of `_to_z`, written into `part`."""
    D = world.size
    azl, ay, ax = part.shape
    back = _all_to_all(world, t.view(D, azl, ay // D, ax))
    part.view(azl, D, ay // D, ax).copy_(back.transpose(0, 1))


def _low_to_compact(world: World, buf: torch.Tensor, c: int, hy: int,
                    hx: int) -> torch.Tensor:
    """The low-pass corner of this rank's compact rows of the next level:
    a tensor whose sub-box (c, hy, hx) at the origin holds them."""
    r, D = world.rank, world.size
    ops = [(dist.isend, buf[p * c:(p + 1) * c, :hy, :hx].contiguous(), k)
           for p in (0, 1) for k in (2 * r + p,) if k < D and k != r]
    if r == 0:
        half = buf[:c]
    else:
        half = buf.new_empty((c, hy, hx))
        ops.append((dist.irecv, half, r // 2))
    _p2p(world, ops)
    return half


def _low_from_compact(world: World, half: torch.Tensor, buf: torch.Tensor,
                      c: int, hy: int, hx: int) -> None:
    """The inverse of `_low_to_compact`: the transformed corners back into
    their rows of `buf`."""
    r, D = world.rank, world.size
    ops = [(dist.isend, half, r // 2)] if r else []
    recvs = [(p, buf.new_empty((c, hy, hx))) for p in (0, 1)
             if r < 2 * r + p < D]
    ops += [(dist.irecv, t, 2 * r + p) for p, t in recvs]
    _p2p(world, ops)
    for p, t in recvs:
        buf[p * c:(p + 1) * c, :hy, :hx].copy_(t)


def _dist_fwd(world: World, buf: torch.Tensor, ext, lvls: int) -> None:
    """Forward-transform `lvls` levels of the box `ext`, in place on this
    rank's rows (the sub-box of `buf` at the origin). Per level: x and y
    in one local pass (kernel A), z on the transposed layout (kernel A),
    then the next level on the compact low-pass corner."""
    if lvls == 0:
        return
    az, ay, ax = ext
    if not _level_divisible(az, ay, ax, world.size):
        _replicated(world, buf, ext, lvls, cdf97_forward)
        return
    azl = az // world.size
    local = buf[:azl, :ay, :ax]
    xy = buf.new_empty((azl, ay, ax))
    lift_pass(buf, xy, (azl, ay, ax), (2, 1), False)
    t = _to_z(world, xy)
    tz = torch.empty_like(t)
    lift_pass(t, tz, tuple(t.shape), (0,), False)
    _from_z(world, tz, local)
    del xy, t, tz
    c, hy, hx = az // (2 * world.size), ay // 2, ax // 2
    half = _low_to_compact(world, buf, c, hy, hx)
    _dist_fwd(world, half, (az // 2, hy, hx), lvls - 1)
    _low_from_compact(world, half, buf, c, hy, hx)


def _dist_inv(world: World, buf: torch.Tensor, ext, lvls: int) -> None:
    """The inverse of `_dist_fwd` (coarsest level first; per level z on the
    transposed layout, then y and x in one local pass, kernel B)."""
    if lvls == 0:
        return
    az, ay, ax = ext
    if not _level_divisible(az, ay, ax, world.size):
        _replicated(world, buf, ext, lvls, cdf97_inverse)
        return
    c, hy, hx = az // (2 * world.size), ay // 2, ax // 2
    half = _low_to_compact(world, buf, c, hy, hx)
    _dist_inv(world, half, (az // 2, hy, hx), lvls - 1)
    _low_from_compact(world, half, buf, c, hy, hx)
    azl = az // world.size
    t = _to_z(world, buf[:azl, :ay, :ax])
    tz = torch.empty_like(t)
    lift_pass(t, tz, tuple(t.shape), (0,), True)
    yx = buf.new_empty((azl, ay, ax))
    _from_z(world, tz, yx)
    del t, tz
    lift_pass(yx, buf, (azl, ay, ax), (1, 2), True)
