"""Stage timings and the verbose switch of the codec pipelines.

A copy of `waverange_tpu.utils.diag` (the port imports nothing of that
package):

  * ``timed(name)`` — context manager adding the wall time of a stage to
    a process-wide registry (`get_timings()`); always on, it costs two
    clock reads and a `torch.profiler.record_function` of the same name,
    so a profiler's trace shows the stage as a span on the host;
  * ``verbose()`` — True when WR_VERBOSE=1; then every timed stage also
    prints ``[wr] <name>: <seconds>s`` to stdout. Nothing is printed
    without it.

The port's codec times each backend of `encode_field` / `decode_field`
under the reference's stage names with `jax` read as `torch`
(`encode.torch`, `encode.exact64`, `encode.native`, `encode.native.f32`,
`decode.torch`, `decode.exact64`, `decode.native`). Each stage ends on
host bytes or a host array, so the wall time covers the device work
without a synchronize. The reference's inner `exact64.*` stages time its
software-f64 emulation, which the port does not have
(`core/exact64.py`): they have no counterpart here.

The device-entropy path (`entropy="device"`) also times its stages
inside the backend's, with no synchronize added: `encode.h2d`,
`encode.step`, `encode.entropy`, `encode.frame` (the planes' containers,
written on the device into one buffer), `encode.d2h` (its copy) and
`decode.parse`, `decode.h2d`, `decode.entropy`, `decode.step`,
`decode.d2h`. A stage that only enqueues device work (`decode.entropy`,
`decode.step`) times the enqueue; the next stage that reads device data
(`decode.d2h`) waits for it, so its time holds theirs. ``timed_if(on,
name)`` times a stage only when `on`; the host-entropy path keeps the
reference's one stage per backend.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict

from torch.profiler import record_function

_timings: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        _timings[name] += dt
        _counts[name] += 1
        if verbose():
            print(f"[wr] {name}: {dt:.3f}s", flush=True)


def timed_if(on: bool, name: str):
    """`timed(name)` when `on`, else a context that does nothing."""
    return timed(name) if on else nullcontext()


def get_timings() -> Dict[str, dict]:
    return {k: {"total_s": _timings[k], "count": _counts[k]}
            for k in _timings}


def reset_timings() -> None:
    _timings.clear()
    _counts.clear()


def verbose() -> bool:
    return os.environ.get("WR_VERBOSE") == "1"
