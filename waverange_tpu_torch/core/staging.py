"""Field- and stream-sized copies between host memory and a CUDA card,
through a bounded ring of pinned host buffers.

The JAX package has no counterpart: it leaves these copies to
`jnp.asarray` / `np.asarray` (waverange_tpu/core/codec.py). On the H100
their translations, `torch.from_numpy(a).to(dev)` and `t.cpu().numpy()`,
are synchronous pageable copies through a CUDA bounce buffer, with
the host faulting in a fresh destination one page at a time on the
calling thread. Here instead:

  * each direction has one ring of `SLOTS` pinned buffers of
    `SLOT_BYTES`, made at first use and kept for the process
    (`SLOTS * SLOT_BYTES` each way, `PINNED_BYTES` in all, shared by the
    cards of the process: page-locked memory is usable from every card
    under unified addressing), and one copy stream per card, which the
    H100 runs on a copy engine;
  * `to_device` copies the array into a slot with `THREADS` host threads
    while the previous slot's DMA runs; the compute stream waits for the
    last DMA;
  * `to_host` starts the DMAs once the compute stream has made the
    tensor, and the host threads copy each finished slot into the
    destination while the next DMAs run: the destination's fresh pages
    fault in from several threads at once, overlapped with the DMA;
  * `to_host_bytes` does the same into a new `bytes` object that is
    never zero-filled first;
  * `host_result` makes the fresh array of a download that comes later
    and starts faulting in its pages on a quarter of the host threads, so
    that the fault-in overlaps the caller's work before the download
    (the decode's parse and upload of the stream).

An event per slot orders its DMA against the host's reuse of it, and a
lock per direction serializes callers. Pinned memory never exceeds
`PINNED_BYTES`, however many results a caller keeps: what is returned is
ordinary (pageable) memory. If the pinned allocation fails, it raises.

On a CPU device `to_device`, `to_numpy` and `to_host_bytes` keep the
plain path (`torch.from_numpy`, `.numpy()`, `.tobytes()`) and never touch
the ring; the device of the tensor chooses, as it chooses a kernel or its
plain version.
"""
from __future__ import annotations

import ctypes
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor, wait
from typing import NamedTuple, Optional

import numpy as np
import torch

SLOTS = 4
SLOT_BYTES = 64 << 20
PINNED_BYTES = 2 * SLOTS * SLOT_BYTES   # 512 MiB: one ring each way
THREADS = min(8, len(os.sched_getaffinity(0)))
PIECE_BYTES = 4 << 20   # what one host thread copies at a time
# host threads that fault in a decode's fresh result ahead of its
# download (`host_result`); chip_smoke.py phase 2b times 0, 1, 2 and 4
PREFAULT_THREADS = max(1, THREADS // 4)
PAGE = 4096

_rings: dict = {}
_lock = threading.Lock()
_pool = None


def chunks(n: int, size: int) -> list:
    """[start, stop) ranges of at most `size` that cover [0, n) in order:
    a slot's share of a copy, or a host thread's share of a slot."""
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def threads() -> ThreadPoolExecutor:
    """The process's `THREADS` host threads, started at first use."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(THREADS,
                                       thread_name_prefix="wr-staging")
        return _pool


def copy_pieces(dst: np.ndarray, src: np.ndarray,
                pool: ThreadPoolExecutor) -> list:
    """Start dst[:] = src for two 1-D uint8 arrays of one length on the
    threads of `pool`, `PIECE_BYTES` a task (numpy releases the
    interpreter lock while it copies); the futures of the tasks."""
    if dst.size != src.size or dst.dtype != np.uint8 \
            or src.dtype != np.uint8:
        raise ValueError("copy_pieces takes two uint8 arrays of one "
                         f"length, got {dst.dtype}[{dst.size}] and "
                         f"{src.dtype}[{src.size}]")
    return [pool.submit(np.copyto, dst[a:b], src[a:b])
            for a, b in chunks(src.size, PIECE_BYTES)]


def finish(jobs: list) -> None:
    """Wait for tasks on the host threads (`copy_pieces`,
    `host_result`); raise the first failure."""
    for j in jobs:
        j.result()


_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t)
_new_bytes.restype = ctypes.py_object
_bytes_data = ctypes.pythonapi.PyBytes_AsString
_bytes_data.argtypes = (ctypes.py_object,)
_bytes_data.restype = ctypes.c_void_p


def bytes_buffer(n: int):
    """A new `bytes` object of n bytes whose contents are not set (no zero
    fill), and a writable uint8 array over them. The caller fills the
    array before the object is seen by anything else, and then drops the
    array: a `bytes` object is immutable once shared."""
    if n == 0:
        return b"", np.empty(0, np.uint8)
    b = _new_bytes(None, n)
    return b, np.ctypeslib.as_array(
        (ctypes.c_uint8 * n).from_address(_bytes_data(b)))


class Ring:
    """`SLOTS` pinned host buffers of `SLOT_BYTES` for one direction, the
    event of each slot's last DMA, a copy stream per card, and the lock
    that serializes the callers.

    A copy walks its slot-sized chunks in order. Up: the host threads
    fill chunk k into slot k % SLOTS (once that slot's DMA of chunk
    k - SLOTS is done) while chunk k - 1 is still being filled or sent;
    each chunk's DMA starts when its fill ends. Down: the DMAs of the
    first SLOTS chunks start at once; the host threads empty chunk k
    once its DMA is done, while chunk k - 1 is still being emptied; a
    slot's next DMA starts when its last chunk is emptied. So the
    threads never wait for a whole chunk to end before they take up the
    next."""

    def __init__(self):
        self.lock = threading.Lock()
        self.slots = [torch.empty(SLOT_BYTES, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(SLOTS)]
        self.host = [s.numpy() for s in self.slots]
        self.done = [None] * SLOTS
        self.streams = {}

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(dev)
        return self.streams[dev]

    def _dma(self, stream, s: int, dst: torch.Tensor,
             src: torch.Tensor) -> None:
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        self.done[s] = ev

    def upload(self, src: np.ndarray, dst: torch.Tensor) -> None:
        """The bytes of `src` (uint8, host) into `dst` (uint8, card)."""
        plan = chunks(src.size, SLOT_BYTES)
        pool, live = threads(), []
        with self.lock:
            compute = torch.cuda.current_stream(dst.device)
            stream = self._stream(dst.device)
            # dst may reuse memory that the compute stream still reads
            stream.wait_stream(compute)
            try:
                fills = {}
                for k in range(len(plan) + 1):
                    if k < len(plan):
                        a, b = plan[k]
                        s = k % SLOTS
                        if self.done[s] is not None:
                            self.done[s].synchronize()
                        fills[k] = copy_pieces(self.host[s][:b - a],
                                               src[a:b], pool)
                        live += fills[k]
                    if k:
                        a, b = plan[k - 1]
                        s = (k - 1) % SLOTS
                        finish(fills.pop(k - 1))
                        self._dma(stream, s, dst[a:b], self.slots[s][:b - a])
            finally:
                wait(live)
            compute.wait_stream(stream)

    def download(self, src: torch.Tensor, dst: np.ndarray) -> None:
        """The bytes of `src` (uint8, card) into `dst` (uint8, host),
        after the work queued on the compute stream."""
        plan = chunks(src.numel(), SLOT_BYTES)
        pool, live = threads(), []

        def start(k):
            a, b = plan[k]
            s = k % SLOTS
            self._dma(stream, s, self.slots[s][:b - a], src[a:b])

        with self.lock:
            stream = self._stream(src.device)
            stream.wait_stream(torch.cuda.current_stream(src.device))
            try:
                for k in range(min(SLOTS, len(plan))):
                    start(k)
                drains = {}
                for k in range(len(plan) + 1):
                    if k < len(plan):
                        a, b = plan[k]
                        s = k % SLOTS
                        self.done[s].synchronize()
                        drains[k] = copy_pieces(dst[a:b],
                                                self.host[s][:b - a], pool)
                        live += drains[k]
                    if k:
                        finish(drains.pop(k - 1))
                        if k - 1 + SLOTS < len(plan):
                            start(k - 1 + SLOTS)
            finally:
                wait(live)


def ring(direction: str) -> Ring:
    """The process's ring for "up" (host to card) or "down"."""
    with _lock:
        if direction not in _rings:
            _rings[direction] = Ring()
        return _rings[direction]


def _host_bytes(a: np.ndarray) -> np.ndarray:
    return a.reshape(-1).view(np.uint8)


def _card_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def to_device(arr: np.ndarray, dev) -> torch.Tensor:
    """A tensor on `dev` with the values of the C-contiguous `arr`. On a
    CPU device it is `torch.from_numpy(arr)`, a view of `arr` that the
    port only reads (`arr` may be read-only, as a record's bytes are)."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # read-only arr
            return torch.from_numpy(arr)
    if not arr.flags.c_contiguous:
        raise ValueError("to_device takes a C-contiguous array")
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    out = torch.empty(arr.shape, dtype=dtype, device=dev)
    if arr.size:
        ring("up").upload(_host_bytes(arr), _card_bytes(out))
    return out


def to_host(t: torch.Tensor, out: np.ndarray) -> None:
    """Copy the contiguous CUDA tensor `t` into the C-contiguous, writable
    host array `out` of the same number of bytes, once the work queued
    on the compute stream has made `t`."""
    if t.device.type != "cuda" or not t.is_contiguous():
        raise ValueError("to_host takes a contiguous CUDA tensor")
    if not (out.flags.c_contiguous and out.flags.writeable) \
            or out.nbytes != t.numel() * t.element_size():
        raise ValueError(f"to_host: {out.nbytes} bytes of writable "
                         "C-contiguous host memory for "
                         f"{t.numel() * t.element_size()} bytes")
    if out.nbytes:
        ring("down").download(_card_bytes(t), _host_bytes(out))


class HostResult(NamedTuple):
    """A fresh host array for a download, and the tasks faulting in its
    pages (`host_result`)."""
    array: np.ndarray
    touching: list


def host_result(shape, dtype, dev) -> Optional[HostResult]:
    """For a download from the CUDA device `dev` that comes later: a new
    host array of `shape` and `dtype` whose pages start faulting in now,
    `PREFAULT_THREADS` host threads writing one byte of each page, so
    that the fault-in of the fresh result overlaps what the caller does
    before the download (`to_numpy(t, out=...)`). None on the CPU, whose
    download is a view."""
    if torch.device(dev).type != "cuda":
        return None
    out = np.empty(shape, dtype)
    flat = out.reshape(-1).view(np.uint8)
    step = max(-(-flat.size // (PREFAULT_THREADS * PAGE)), 1) * PAGE
    pool = threads()
    return HostResult(out, [pool.submit(_touch, flat[a:a + step])
                            for a in range(0, flat.size, step)])


def _touch(pages: np.ndarray) -> None:
    pages[::PAGE] = 0


def to_numpy(t: torch.Tensor, out: Optional[HostResult] = None
             ) -> np.ndarray:
    """`t` as a numpy array in ordinary host memory: `out`'s array where
    given (the faulting in of its pages is waited for first), else a new
    one. On the CPU it is `t.numpy()`, a view of the tensor."""
    if t.device.type != "cuda":
        return t.numpy()
    t = t.contiguous()
    if out is None:
        arr = np.empty(tuple(t.shape),
                       torch.empty(0, dtype=t.dtype).numpy().dtype)
    else:
        finish(out.touching)
        arr = out.array
    to_host(t, arr)
    return arr


def to_host_bytes(t: torch.Tensor) -> bytes:
    """The bytes of `t` as one `bytes` object, written once by the host
    threads (no zero fill, no second copy)."""
    if t.device.type != "cuda":
        return t.numpy().tobytes()
    t = t.contiguous()
    b, view = bytes_buffer(t.numel() * t.element_size())
    to_host(t, view)
    return b
