"""Stage timings and the verbose switch of the codec pipelines.

A copy of `waverange_tpu.utils.diag` (the port imports nothing of that
package):

  * ``timed(name)`` — context manager adding the wall time of a stage to
    a process-wide registry (`get_timings()`); always on, it costs two
    clock reads;
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
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

_timings: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _timings[name] += dt
        _counts[name] += 1
        if verbose():
            print(f"[wr] {name}: {dt:.3f}s", flush=True)


def get_timings() -> Dict[str, dict]:
    return {k: {"total_s": _timings[k], "count": _counts[k]}
            for k in _timings}


def reset_timings() -> None:
    _timings.clear()
    _counts.clear()


def verbose() -> bool:
    return os.environ.get("WR_VERBOSE") == "1"
