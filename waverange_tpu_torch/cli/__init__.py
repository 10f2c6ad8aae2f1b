"""Command-line tools compatible with the reference's wrenc/wrdec/
wrmssgenc/wrmssgdec interfaces (argv, inmeta command files, stdin):
copies of `waverange_tpu.cli` that run this package's codec.

Environment: WR_BACKEND selects the codec's backend ("torch", the
default, "exact64" or "native"), WR_DEVICE the torch device of the first
two ("cuda", the default; "cpu" runs the plain torch path), WR_CODER the
entropy format ("range", the default, or "rans"/"turbo"), WR_CONFORMANCE
the conformance mode ("strict", the default, "route" or "degraded").
"""
import os


def backend_and_device():
    """(WR_BACKEND, WR_DEVICE), defaulting to ("torch", "cuda")."""
    return (os.environ.get("WR_BACKEND", "torch"),
            os.environ.get("WR_DEVICE", "cuda"))
