"""Build the drop-in `libwaverange` (shared and static) and `waverange.h`.

The counterpart of `waverange_tpu/native/libwaverange.py`, built from the
port's copy of the host library (`native/src/wr_native.cc`): the
reference library's products (reference Makefile:40-41,
src/core/Makefile:7-23), a shared and a static library exporting
`encoding_wrap`, `decoding_wrap`, `setup_wr` and the Fortran `_f` shims,
and a C/C++ header with the reference's prototypes. Programs written
against the reference libwaverange link against these unchanged.

    python -m waverange_tpu_torch build-lib [DEST]

writes DEST/lib/libwaverange.{so,a} and DEST/include/waverange.h and
prints DEST/lib. The default DEST is `build/waverange_tpu_torch` at the
repository root (`DEFAULT_DIR`), beside, not over, the JAX package's
`build/{lib,include}`. Each product is written under a name unique to
the process and renamed into place, so that concurrent builds never
see half a library.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

from .build import _SRC, CXXFLAGS, ensure_built, find_cxx

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "waverange_tpu_torch"

HEADER = """\
/* waverange.h — C/C++ interface of libwaverange (waverange_tpu_torch
   build). Drop-in compatible with the reference wrappers.h (see that file
   for full parameter documentation). */
#ifndef WAVERANGE_TPU_TORCH_WAVERANGE_H
#define WAVERANGE_TPU_TORCH_WAVERANGE_H

#ifdef __cplusplus
extern "C" {
void encoding_wrap(int nx, int ny, int nz, double *fld_1d, int wtflag,
                   int mx, int my, int mz, double *cutoffvec,
                   double &tolabs, double &midval, double &halfspanval,
                   unsigned char &wlev, unsigned char &nlay,
                   unsigned long int &ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void decoding_wrap(int nx, int ny, int nz, double *fld_1d, double &tolabs,
                   double &midval, double &halfspanval,
                   unsigned char &wlev, unsigned char &nlay,
                   unsigned long int &ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void setup_wr(int nx, int ny, int nz, unsigned char &nlaymax,
              unsigned long int &ntot_enc_max);
}
#else
/* C callers: reference parameters are pointers at the ABI level */
void encoding_wrap(int nx, int ny, int nz, double *fld_1d, int wtflag,
                   int mx, int my, int mz, double *cutoffvec,
                   double *tolabs, double *midval, double *halfspanval,
                   unsigned char *wlev, unsigned char *nlay,
                   unsigned long int *ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void decoding_wrap(int nx, int ny, int nz, double *fld_1d, double *tolabs,
                   double *midval, double *halfspanval,
                   unsigned char *wlev, unsigned char *nlay,
                   unsigned long int *ntot_enc, double *deps_vec,
                   double *minval_vec, unsigned long int *len_enc_vec,
                   unsigned char *data_enc);
void setup_wr(int nx, int ny, int nz, unsigned char *nlaymax,
              unsigned long int *ntot_enc_max);
#endif

#endif /* WAVERANGE_TPU_TORCH_WAVERANGE_H */
"""


def _run(cmd) -> None:
    r = subprocess.run([str(c) for c in cmd], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed (exit {r.returncode}): "
                           f"{' '.join(map(str, cmd))}\n{r.stderr}")


def build_libwaverange(dest_dir: str | Path = None) -> Path:
    """Build and install the shared and static library and the header
    under `dest_dir` (default `DEFAULT_DIR`); returns its lib directory."""
    root = Path(dest_dir) if dest_dir else DEFAULT_DIR
    libdir, incdir = root / "lib", root / "include"
    libdir.mkdir(parents=True, exist_ok=True)
    incdir.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.tmp"

    so = libdir / "libwaverange.so"
    shutil.copyfile(ensure_built(), so.with_name(so.name + tag))
    os.replace(so.with_name(so.name + tag), so)

    # the static archive, from an object built with the same flags but
    # -shared
    obj = libdir / f"wr_native{tag}.o"
    ar = libdir / "libwaverange.a"
    ar_tmp = ar.with_name(ar.name + tag)
    try:
        _run([find_cxx(), *[f for f in CXXFLAGS if f != "-shared"], "-c",
              "-o", obj, _SRC])
        _run(["ar", "rcs", ar_tmp, obj])
        os.replace(ar_tmp, ar)
    finally:
        obj.unlink(missing_ok=True)
        ar_tmp.unlink(missing_ok=True)

    h = incdir / "waverange.h"
    h.with_name(h.name + tag).write_text(HEADER)
    os.replace(h.with_name(h.name + tag), h)
    return libdir


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1 or argv[:1] in (["-h"], ["--help"]):
        print("usage: python -m waverange_tpu_torch build-lib [DEST]")
        return 2 if len(argv) > 1 else 0
    print(build_libwaverange(*argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
