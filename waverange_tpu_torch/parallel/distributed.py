"""Multi-process execution on `torch.distributed`.

Port of `waverange_tpu.parallel.distributed`. One process runs per card
(or, on the CPU, per worker): `init_distributed` joins the processes into
a group, each encodes the fields or subdomains it holds, and the
variable-length streams are exchanged in file order.

The collectives of the device data (`parallel.mesh`) run on the backend of
the device the caller names: NCCL for CUDA tensors, gloo for CPU tensors.
Host bytes (streams, records, decoded fields) travel on a gloo group: the
default group when it is gloo, else one made beside the NCCL group with
the same ranks. That group is the transport of host data, which NCCL does
not carry; it is not a stand-in for NCCL.

A single process with no group is the world of one: every exchange is
local.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device="cuda",
                     timeout: Optional[float] = None) -> None:
    """Join this process to the default group, from the arguments or from
    torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
    MASTER_PORT). Does nothing when neither gives a world.

    `device` picks the backend: "cuda" runs NCCL, with this process on
    `cuda:LOCAL_RANK`; "cpu" runs gloo. `timeout`, in seconds, bounds the
    rendezvous and every collective of the group (torch's default when
    None)."""
    dev = torch.device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"unsupported device {device!r}")
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return
    world_size = int(world_size if world_size is not None
                     else os.environ["WORLD_SIZE"])
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    local_rank = int(local_rank if local_rank is not None
                     else os.environ.get("LOCAL_RANK", "0"))
    if init_method is None:
        init_method = "env://"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        torch.cuda.set_device(local_rank)
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(_BACKENDS[dev.type], init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


class World:
    """The processes of a group as the parallel functions see them: the
    group (None for a single process with no group), this process's rank
    in it and its size."""

    def __init__(self, group=None):
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            if self.rank < 0:
                raise ValueError("this process is not a member of the group")

    def check_device(self, dev: torch.device) -> None:
        """Refuse a group whose backend does not carry tensors of `dev`."""
        if self.group is None:
            return
        backend = str(dist.get_backend(self.group))
        if _BACKENDS[dev.type] not in backend:
            raise ValueError(f"the group's backend {backend!r} does not "
                             f"carry {dev.type} tensors; use "
                             f"{_BACKENDS[dev.type]!r}")

    def host_group(self):
        """The gloo group of these ranks, for host bytes (module
        docstring)."""
        if "gloo" in str(dist.get_backend(self.group)):
            return self.group
        if self.group not in _HOST_GROUPS:
            _HOST_GROUPS[self.group] = dist.new_group(
                dist.get_process_group_ranks(self.group), backend="gloo",
                use_local_synchronization=True)
        return _HOST_GROUPS[self.group]

    def share(self, count: int, rank: Optional[int] = None):
        """The contiguous share [lo, hi) of `count` items of this rank (or
        of `rank`), blocked as `P("d")` blocks them: ceil(count / size) a
        rank, the last ones shorter or empty."""
        r = self.rank if rank is None else rank
        k = -(-count // self.size)
        return min(r * k, count), min((r + 1) * k, count)


# gloo groups made beside NCCL groups, by group (`World.host_group`)
_HOST_GROUPS: dict = {}


def exchange_bytes(world: World, blobs: Sequence[bytes],
                   dst: Optional[int] = None) -> List[List[bytes]]:
    """Every rank's `blobs`, by rank, on rank `dst` (None: on every rank);
    [] elsewhere. The counts and lengths go first, then each rank's bytes
    back to back at their own length: nothing is padded."""
    if world.size == 1:
        return [list(blobs)]
    g = world.host_group()
    counts = torch.zeros(world.size, dtype=torch.int64)
    counts[world.rank] = len(blobs)
    dist.all_reduce(counts, group=g)
    maxn = int(counts.max())
    lens = torch.zeros(world.size, maxn, dtype=torch.int64)
    lens[world.rank, :len(blobs)] = torch.tensor([len(b) for b in blobs],
                                                 dtype=torch.int64)
    dist.all_reduce(lens, group=g)
    out = []
    ranks = dist.get_process_group_ranks(g)
    for r in range(world.size):
        total = int(lens[r].sum())
        if r == world.rank:
            buf = torch.frombuffer(bytearray(b"".join(blobs)) or
                                   bytearray(1), dtype=torch.uint8)[:total]
        else:
            buf = torch.empty(total, dtype=torch.uint8)
        if total:
            if dst is None:
                dist.broadcast(buf, ranks[r], group=g)
            elif r != dst and world.rank == r:
                dist.send(buf, ranks[dst], group=g)
            elif r != dst and world.rank == dst:
                dist.recv(buf, ranks[r], group=g)
        if dst is None or world.rank == dst:
            data = buf.numpy().tobytes()
            offs = np.concatenate(
                [[0], np.cumsum(lens[r, :int(counts[r])].numpy())])
            out.append([data[a:b] for a, b in zip(offs[:-1], offs[1:])])
    return out


def gather_streams_ordered(local_streams: Sequence[bytes],
                           local_ids: Sequence[int],
                           group=None) -> List[bytes]:
    """All processes contribute (id, stream) pairs; process 0 of the group
    receives the full id-ordered list (the others get []). With one
    process: the local streams in id order."""
    world = World(group)
    ids = np.asarray(local_ids, np.int64)
    got = exchange_bytes(world, [ids.tobytes()] + list(local_streams), 0)
    if not got:
        return []
    items = []
    for part in got:
        for fid, s in zip(np.frombuffer(part[0], np.int64), part[1:]):
            items.append((int(fid), s))
    items.sort(key=lambda t: t[0])
    return [s for _, s in items]
