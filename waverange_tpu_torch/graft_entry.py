"""Entry points of the port: the counterparts of `__graft_entry__.py`.

entry(device="cuda") — the single-device forward step of the main path:
    the port's fused encode step (`ops.quant.encode_step`: stats, the
    4-level forward CDF 9/7 and the 8 byte layers; kernels A and C on a
    card) on a 64^3 f64 field.

dryrun_multichip(n, device="cuda") — the three checks of the JAX dry run
    on its tiny shapes, in a group of n processes of
    `waverange_tpu_torch.parallel`: the sharded encode/decode of one field
    a rank, the united step and the distributed step, each held to the
    single-device encode byte for byte. It runs in the default process
    group where there is one (of size n), else in a world of n processes
    it spawns: gloo on the CPU, NCCL on n cards.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from . import native as wn
from .core import codec
from .core.codec import _device
from .ops.quant import encode_step
from .parallel import distributed as PD
from .parallel import mesh as PM

TOL = 1e-6
# seconds: a spawned world's rendezvous, each of its collectives, and the
# wait for its ranks, so that a hung rank fails the call
WORLD_TIMEOUT = 300.0


def entry(device="cuda"):
    """(fwd, args): fwd(*args) runs the encode step at tolrel 1e-6, 4
    levels, wtflag set, on a 64^3 f64 standard-normal field (seed 0) on
    `device`, and returns (planes, deps, minv, nlay, tolabs, midval,
    halfspanval, trivial) there. The derating 1.75 and the alphabet 255,
    arguments of the JAX step, are the constants of `ops.quant`."""
    dev = _device(device)

    def fwd(fld, tolrel):
        return encode_step(fld, tolrel, wtflag=True, levels=4)

    rng = np.random.default_rng(0)
    fld = torch.from_numpy(rng.standard_normal((64, 64, 64))).to(dev)
    return fwd, (fld, TOL)


class DryRun(NamedTuple):
    err: float   # largest |decode - field| of the sharded check
    nlay: int    # layers of the united step
    nlay2: int   # layers of the distributed step


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _same_as_single(planes: torch.Tensor, nlay: int, fld: np.ndarray,
                    dev: torch.device, what: str) -> None:
    """`planes[:nlay]`, the whole field's, code to the single-device
    encode's stream."""
    single = codec.encode_field(fld, TOL, device=dev)
    _check(nlay == single.nlay, f"{what} nlay {nlay} != {single.nlay}")
    payload, _ = wn.encode_planes_batch(planes[:nlay].cpu().numpy())
    _check(payload == single.data, f"{what} planes != single-device bytes")


def _dryrun(n: int, dev: torch.device) -> DryRun:
    """The checks, on this rank of the default group of n processes."""
    group = PM.make_group(n)
    world = PD.World(group)
    rank = world.rank

    # 1. one field a rank through the sharded encode and decode
    fields = np.stack([
        np.fromfunction(lambda k, j, i: np.sin(i / 3 + b) * np.cos(j / 2)
                        + 0.1 * k, (8, 8, 8))
        for b in range(n)])
    encs = PM.encode_fields_sharded(fields, TOL, group=group, device=dev)
    dec = PM.decode_fields_sharded(encs, group=group, device=dev)
    err = float(np.abs(dec - fields).max())
    limit = 1.3 * TOL * float(np.abs(fields).max()) + 1e-30
    _check(err <= limit, f"sharded error {err:g} above {limit:g}")

    # 2. united: the field z-sharded, min/max all-reduced, slabs gathered
    shape = (2 * n, 8, 8)
    fld = np.fromfunction(
        lambda k, j, i: np.sin(i / 3) * np.cos(j / 2) + 0.05 * k, shape)
    slab = torch.from_numpy(fld[2 * rank:2 * rank + 2].copy()).to(dev)
    out = PM.united_encode_step(group, shape)(slab, TOL)
    nlay = int(out[3])
    _check(nlay >= 1, "united nlay < 1")
    _same_as_single(out[0], nlay, fld, dev, "united")

    # 3. distributed: the transform and the quantizer on the slabs; each
    #    rank holds its z-major part of the planes, gathered here
    shape2 = (4 * n, 2 * n, 16)
    fld2 = np.fromfunction(
        lambda k, j, i: np.cos(i / 4) * np.sin(j / 3) + 0.02 * k, shape2)
    slab2 = torch.from_numpy(fld2[4 * rank:4 * rank + 4].copy()).to(dev)
    out2 = PM.distributed_encode_step(group, shape2)(slab2, TOL)
    nlay2 = int(out2[3])
    _check(nlay2 >= 1, "distributed nlay < 1")
    whole = PM._gather_rows(world, out2[0][:nlay2].T.contiguous()).T
    _same_as_single(whole, nlay2, fld2, dev, "distributed")
    return DryRun(err, nlay, nlay2)


def _rank_main(rank: int, n: int, device: str, store: str, results) -> None:
    """One rank of a spawned world: join it, run the checks, leave it, and
    put (rank, DryRun or None, traceback or None) on `results`."""
    try:
        PD.init_distributed(init_method=f"file://{store}", world_size=n,
                            rank=rank, local_rank=rank, device=device,
                            timeout=WORLD_TIMEOUT)
        try:
            res = _dryrun(n, _device(device))
        finally:
            dist.destroy_process_group()
        results.put((rank, res, None))
    except Exception:
        results.put((rank, None, traceback.format_exc()))


def _spawn_world(n: int, dev: torch.device) -> DryRun:
    """Run the checks in a new world of n processes (spawned, joined by a
    file store in a temporary directory); rank 0's numbers."""
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(
            f"a world of {n} on NCCL needs {n} cards, this host has "
            f"{torch.cuda.device_count()} (NCCL takes one rank a card)")
    wn.get_lib()  # build the host library once, before the ranks load it
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, dev.type, f"{tmp}/store", results))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            got = {}
            deadline = time.monotonic() + WORLD_TIMEOUT
            while len(got) < n:
                try:
                    rank, res, err = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"dryrun_multichip({n}): rank {dead[0][0]} "
                            f"exited with code {dead[0][1]}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"dryrun_multichip({n}): ranks "
                            f"{sorted(set(range(n)) - set(got))} gave no "
                            f"result in {WORLD_TIMEOUT:g} s") from None
                    continue
                if err is not None:
                    raise RuntimeError(
                        f"dryrun_multichip({n}): rank {rank} failed:\n{err}")
                got[rank] = res
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return got[0]


def dryrun_multichip(n_devices: int, device="cuda") -> DryRun:
    """Run the three checks of `__graft_entry__.dryrun_multichip` over
    n_devices processes, each on one device of `device`'s type; print the
    `dryrun_multichip(n): ok — ...` line (rank 0) and return the sharded
    error and the united and distributed layer counts.

    Runs in the default process group where one exists (its size must be
    n_devices), else spawns a world of n_devices processes: gloo for
    "cpu", NCCL for "cuda" (one card a rank). Raises on the first check
    that fails, in any rank."""
    dev = _device(device)
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if size != n_devices:
            raise ValueError(f"the default group has {size} ranks, not "
                             f"{n_devices}")
        res, rank = _dryrun(n_devices, dev), dist.get_rank()
    else:
        res, rank = _spawn_world(n_devices, dev), 0
    if rank == 0:
        print(f"dryrun_multichip({n_devices}): ok — dp encode/decode err "
              f"{res.err:.2e}, united nlay={res.nlay} byte-equal, "
              f"distributed nlay={res.nlay2} byte-equal", flush=True)
    return res
