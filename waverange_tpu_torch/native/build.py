"""Build the port's copy of the wr_native host library on demand.

`src/wr_native.cc` is a copy of `waverange_tpu/native/src/wr_native.cc`
with one comment reworded (tests/test_torch_native.py holds the two to the
same code and the same output bytes). It is compiled at first use, never at
import, with plain g++ into
``build/waverange_tpu_torch/host/libwrnative-<hash>.so`` at the
repository root.

The flags are the reference package's, pinned: `-ffp-contract=off` is
the codec's bit-exactness contract (the f64 wavelet must match the
reference binary bit for bit, and gcc's default contraction makes
position-dependent FMA choices). `-march=native` makes the library
specific to the CPU it was built on, so the hash covers the host CPU's
model name and feature flags as well as the source and the flags: a
build directory copied to another machine is not reused there.

The build writes to a name unique to the process and renames it into
place, so concurrent builders (test workers) never load a half-written
library. A missing compiler or a failed build raises with the
compiler's message.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "src" / "wr_native.cc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "waverange_tpu_torch" / "host")

CXX = "g++"
CXXFLAGS = [
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-pthread",
    "-march=native",
    "-ffp-contract=off",
    "-fno-math-errno",
]


def find_cxx() -> str:
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(
            f"{CXX} not found on PATH: the host coder library of "
            "waverange_tpu_torch is compiled from native/src/wr_native.cc "
            "at first use")
    return cxx


def _cpu_identity() -> bytes:
    """The `model name` and `flags` lines of /proc/cpuinfo (what
    -march=native compiles for), or b"" where there is no such file."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return b""
    keep = {ln.split(":", 1)[0].strip(): ln for ln in text.splitlines()
            if ln.startswith(("model name", "flags"))}
    return "\n".join(sorted(keep.values())).encode()


def lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join([CXX, *CXXFLAGS]).encode())
    h.update(_cpu_identity())
    return BUILD_DIR / f"libwrnative-{h.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Compile the library if this hash has none yet; return its path."""
    out = lib_path()
    if out.exists():
        return out
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(_SRC)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed (exit {r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    return out
