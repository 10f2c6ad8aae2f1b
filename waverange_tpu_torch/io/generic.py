"""Generic raw-binary / Fortran-sequential file interface.

Byte-compatible with the reference's wrenc/wrdec generic format:
  * `.wrh` text header — preamble + per-field records
    (contract: gen_enc.cpp:509-519, gen_aux.cpp:505-556),
  * `.wrb` binary — concatenated per-field payloads, compressed fields as
    raw encoded bytes, uncompressed fields as float/double streams
    (gen_aux.cpp:401-468),
  * input/output data files: C/C++ raw (ifiletype=2) or Fortran
    sequential with 4- or 8-byte record markers (ifiletype=0/1), with
    optional endian conversion, f32 widening/narrowing, `idinv` dimension
    inversion and `nh` higher-dimension folding (gen_aux.cpp:49-397).

The reference reads fields element-by-element; here every transformation
is a vectorized numpy view/transpose (identical bytes).

A copy of `waverange_tpu.io.generic` that calls this package's codec:
`backend` is the codec's ("torch", the default, "exact64" or "native")
and `device` the torch device of the first two.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, List, Optional, TextIO

import numpy as np

from ..core.codec import (CODER_VERSION, NLAYMAX, EncodedField,
                          encode_field, decode_field)


def _env_conformance() -> str:
    """WR_CONFORMANCE=strict|route|degraded for the CLI/interface layer:
    'route' encodes a request below the f32 error floor on the f64 path
    (core/codec.py)."""
    import os
    return os.environ.get("WR_CONFORMANCE", "strict")


def g19(x: float) -> str:
    """Format a double like C++ ostream << setprecision(19) (defaultfloat)."""
    return f"{float(x):.19g}"


@dataclass
class FieldSpec:
    """Per-field input description (reference gen_enc.cpp:88-99)."""
    nbytes: int = 8         # 4: float, 8: double
    nx: int = 16
    ny: int = 16
    nz: int = 16
    nh: int = 1
    idinv: int = 0
    icomp: int = 1
    tol_base: float = 1e-16


@dataclass
class FieldRecord:
    """Per-field header record as stored in `.wrh`."""
    idset: int
    nbytes: int
    recl: bytes             # 8 raw marker bytes (hex-echoed in the header)
    nx: int
    ny: int
    nz: int
    nh: int
    idinv: int
    icomp: int
    tol_base: float = 0.0
    enc: Optional[EncodedField] = None


# ---------------------------------------------------------------------------
# Raw data file reading/writing
# ---------------------------------------------------------------------------

def _dtype(nbytes: int, convertendian: bool) -> np.dtype:
    if nbytes not in (4, 8):
        raise ValueError("Generic input nbytes must be equal to 4 or 8")
    ch = ">" if convertendian else "<"
    return np.dtype(f"{ch}f{nbytes}")


def read_field_raw(f: BinaryIO, ifiletype: int, convertendian: bool,
                   spec: FieldSpec) -> tuple[np.ndarray, bytes]:
    """Read one field at the current file position.

    Returns (field as (nz*nh, ny, nx) f64, recl marker bytes). Advances the
    file position past the trailing Fortran marker.
    """
    recl = b"\x00" * 8
    mlen = {0: 4, 1: 8, 2: 0}[ifiletype]
    if mlen:
        raw = f.read(mlen)
        if len(raw) != mlen:
            raise IOError("Cannot read record marker")
        m = raw[::-1] if convertendian else raw
        recl = m + b"\x00" * (8 - mlen)
    ntot = spec.nx * spec.ny * spec.nz * spec.nh
    buf = f.read(ntot * spec.nbytes)
    if len(buf) != ntot * spec.nbytes:
        raise IOError(f"Cannot read field data ({len(buf)} bytes)")
    arr = np.frombuffer(buf, dtype=_dtype(spec.nbytes, convertendian))
    arr = arr.astype(np.float64)
    if spec.idinv:
        # File order loops (ix, iy, iz, ih) outer->inner; target layout has
        # ix fastest: reshape + transpose (gen_aux.cpp:329-373).
        arr = arr.reshape(spec.nx, spec.ny, spec.nz, spec.nh)
        arr = np.ascontiguousarray(arr.transpose(3, 2, 1, 0))
    arr = arr.reshape(spec.nh * spec.nz, spec.ny, spec.nx)
    if mlen:
        f.read(mlen)  # trailing marker, discarded
    return arr, recl


def write_field_raw(f: BinaryIO, ifiletype: int, convertendian: bool,
                    nbytes: int, recl: bytes, nx: int, ny: int, nz: int,
                    nh: int, idinv: int, fld: np.ndarray) -> None:
    """Write one decoded field (gen_aux.cpp:49-226 semantics)."""
    mlen = {0: 4, 1: 8, 2: 0}[ifiletype]
    marker = b""
    if mlen:
        m = recl[:mlen]
        marker = m[::-1] if convertendian else m
        f.write(marker)
    arr = np.asarray(fld, np.float64).reshape(nh, nz, ny, nx)
    if idinv:
        arr = arr.transpose(3, 2, 1, 0)  # file loops ix outer, ih inner
    out = np.ascontiguousarray(arr).astype(
        np.float32 if nbytes == 4 else np.float64)
    if convertendian:
        out = out.byteswap()
    f.write(out.tobytes())
    if mlen:
        f.write(marker)


# ---------------------------------------------------------------------------
# Header writing (byte-compatible with gen_enc.cpp:509-519 + gen_aux.cpp:505)
# ---------------------------------------------------------------------------

def write_header_preamble(fh: TextIO, out_name: str, ifiletype: int,
                          convertendian: bool, nf: int,
                          coder_version: int = CODER_VERSION) -> None:
    fh.write(" ===== Header file for compressed data =====\n")
    fh.write(f" Coder version: {coder_version}\n")
    fh.write(f" Encoded data file name: {out_name}\n")
    fh.write(" File type (0: Fortran sequential w 4-byte recl; 1: Fortran "
             f"sequential w 8-byte recl; 2: C/C++): {ifiletype}\n")
    if convertendian:
        fh.write(" Converted big endian to little endian or vice versa\n")
    else:
        fh.write(" No endian conversion\n")
    fh.write(f" Number of fields in the file, nf: {nf}\n")


def append_field_header(fh: TextIO, rec: FieldRecord,
                        prev_ntot_enc: int) -> int:
    """Append one per-field record; returns the record's ntot_enc value
    (for the reference's persist-across-fields reminder-line quirk:
    gen_aux.cpp:518 tests the *current* ntot_enc variable, which for
    icomp=0 fields still holds the previous field's value)."""
    e = rec.enc
    ntot_enc = e.ntot_enc if (rec.icomp and e is not None) else prev_ntot_enc
    fh.write(" -----\n")
    fh.write(f"{rec.idset}\n")
    line = " nbytes; recl; nx; ny; nz; nh; idinv; icomp;"
    if rec.icomp:
        line += (" tol_base; tolabs; midval; halfspanval; wlev; nlay;"
                 " ntot_enc;")
    if ntot_enc > 0:
        line += " deps_vec(1:nlay); minval_vec(1:nlay); len_enc_vec(1:nlay)"
    fh.write(line + "\n")
    fh.write(f"{rec.nbytes}\n")
    fh.write("".join(f"{b:x} " for b in rec.recl[:8]) + "\n")
    fh.write(f"{rec.nx}\n{rec.ny}\n{rec.nz}\n{rec.nh}\n")
    fh.write(f"{rec.idinv}\n{rec.icomp}\n")
    if rec.icomp > 0:
        fh.write(g19(rec.tol_base) + "\n")
        fh.write(g19(e.tolabs) + "\n")
        fh.write(g19(e.midval) + "\n")
        fh.write(g19(e.halfspanval) + "\n")
        fh.write(f"{e.wlev}\n{e.nlay}\n{e.ntot_enc}\n")
        if e.ntot_enc > 0:
            fh.write("".join(g19(e.deps_vec[j]) + " "
                             for j in range(e.nlay)) + "\n")
            fh.write("".join(g19(e.minval_vec[j]) + " "
                             for j in range(e.nlay)) + "\n")
            fh.write("".join(f"{int(e.len_enc_vec[j])} "
                             for j in range(e.nlay)) + "\n")
    return ntot_enc


class _TokenReader:
    """Whitespace-token reader emulating C++ `operator>>` + `getline`
    interleaving over a text file.

    After `>>` consumes the last token of a line, the C++ stream sits just
    before that line's newline, so a following getline returns "" rather
    than the next line; `_mid_line` tracks that state.
    """

    def __init__(self, fh: TextIO):
        self.fh = fh
        self._buf: List[str] = []
        self._mid_line = False

    def line(self) -> str:
        """Consume the remainder of the current line (getline)."""
        if self._mid_line:
            self._buf = []
            self._mid_line = False
            return ""
        return self.fh.readline()

    def token(self) -> str:
        while not self._buf:
            line = self.fh.readline()
            if not line:
                raise EOFError("header file exhausted")
            self._buf = line.split()
        self._mid_line = True
        return self._buf.pop(0)

    def i(self) -> int:
        return int(self.token())

    def x(self) -> int:
        return int(self.token(), 16)

    def d(self) -> float:
        return float(self.token())


def read_field_header(tr: _TokenReader, idset: int) -> FieldRecord:
    """Parse one per-field record (gen_aux.cpp:559-644 semantics)."""
    tr.line()  # " -----"
    idset1 = tr.i()
    if idset1 != idset:
        raise ValueError(
            f"Encoding header file read error: reading field {idset}, "
            f"found field {idset1}")
    tr.line()  # rest of idset line
    tr.line()  # reminder line
    nbytes = tr.i()
    recl = bytes(tr.x() for _ in range(8))
    tr.line()
    nx, ny, nz, nh = tr.i(), tr.i(), tr.i(), tr.i()
    idinv, icomp = tr.i(), tr.i()
    rec = FieldRecord(idset=idset, nbytes=nbytes, recl=recl, nx=nx, ny=ny,
                      nz=nz, nh=nh, idinv=idinv, icomp=icomp)
    if icomp > 0:
        tol_base = tr.d()
        tolabs = tr.d()
        midval = tr.d()
        halfspanval = tr.d()
        wlev = tr.i()
        nlay = tr.i()
        ntot_enc = tr.i()
        tr.line()
        deps = np.zeros(NLAYMAX)
        minv = np.zeros(NLAYMAX)
        lens = np.zeros(NLAYMAX, np.uint64)
        if ntot_enc > 0:
            for j in range(nlay):
                deps[j] = tr.d()
            tr.line()
            for j in range(nlay):
                minv[j] = tr.d()
            tr.line()
            for j in range(nlay):
                lens[j] = tr.i()
            tr.line()
        rec.tol_base = tol_base
        rec.enc = EncodedField(
            nx=nx, ny=ny, nz=nz * nh, tolabs=tolabs, midval=midval,
            halfspanval=halfspanval, wlev=wlev, nlay=nlay,
            ntot_enc=ntot_enc, deps_vec=deps, minval_vec=minv,
            len_enc_vec=lens)
    else:
        tr.line()
    return rec


# ---------------------------------------------------------------------------
# Whole-file encode / decode (the wrenc/wrdec core logic)
# ---------------------------------------------------------------------------

def encode_generic_file(in_name: str, out_name: str, header_name: str,
                        ifiletype: int, convertendian: bool,
                        specs: List[FieldSpec], backend: str = "torch",
                        verbose: bool = True,
                        global_tol: Optional[float] = None,
                        coder: str = "range", device="cuda") -> None:
    """Compress a generic data file (gen_enc.cpp:527-633 semantics).

    Reference quirk reproduced for bit-compatibility: the encoder's
    cutoff vector is set ONCE from the tol_base variable as left by config
    parsing (gen_enc.cpp:499-503) and never updated in the field loop, so
    every field is actually encoded with the LAST parsed tolerance, while
    the header's tol_base line shows the per-field value. `global_tol`
    carries that effective tolerance (defaults to the last spec's).
    """
    from ..core.codec import _CODER_IDS, _VERSION_BY_ID
    nf = len(specs)
    if global_tol is None:
        global_tol = specs[-1].tol_base if specs else 1e-16
    with open(header_name, "w") as fh:
        write_header_preamble(fh, out_name, ifiletype, convertendian, nf,
                              _VERSION_BY_ID[_CODER_IDS[coder]])
    open(out_name, "wb").close()  # truncate

    prev_ntot_enc = 0
    with open(in_name, "rb") as fin:
        for it, spec in enumerate(specs):
            fld, recl = read_field_raw(fin, ifiletype, convertendian, spec)
            if verbose:
                print(f"Field number {it}")
            rec = FieldRecord(idset=it, nbytes=spec.nbytes, recl=recl,
                              nx=spec.nx, ny=spec.ny, nz=spec.nz,
                              nh=spec.nh, idinv=spec.idinv,
                              icomp=spec.icomp, tol_base=spec.tol_base)
            if spec.icomp:
                rec.enc = encode_field(fld, global_tol, wtflag=1,
                                       backend=backend, coder=coder,
                                       conformance=_env_conformance(),
                                       device=device)
                with open(header_name, "a") as fh:
                    prev_ntot_enc = append_field_header(fh, rec,
                                                        prev_ntot_enc)
                if rec.enc.ntot_enc > 0:
                    with open(out_name, "ab") as fo:
                        fo.write(rec.enc.data)
            else:
                with open(header_name, "a") as fh:
                    prev_ntot_enc = append_field_header(fh, rec,
                                                        prev_ntot_enc)
                out = fld.ravel().astype(
                    np.float32 if spec.nbytes == 4 else np.float64)
                with open(out_name, "ab") as fo:
                    fo.write(out.tobytes())


def decode_generic_file(in_name: str, header_name: str, out_name: str,
                        ifiletype: int, convertendian: bool,
                        backend: str = "torch",
                        verbose: bool = True, device="cuda") -> None:
    """Reconstruct a generic data file (gen_dec.cpp:145-256 semantics)."""
    with open(header_name, "r") as fh:
        fh.readline()
        # line 2 carries the coder version; 31503 = reference range
        # coder, 31600 = turbo rANS (format v2)
        version_line = fh.readline()
        try:
            coder_version = int(version_line.split(":")[-1])
        except ValueError:
            coder_version = CODER_VERSION
        for _ in range(3):
            fh.readline()
        nf_line = fh.readline()
        nf = int(nf_line[34:])
        tr = _TokenReader(fh)
        with open(in_name, "rb") as fin, open(out_name, "wb") as fout:
            for it in range(nf):
                rec = read_field_header(tr, it)
                ntot = rec.nx * rec.ny * rec.nz * rec.nh
                if verbose:
                    print(f"Field number {it}: nx={rec.nx} ny={rec.ny} "
                          f"nz={rec.nz} nh={rec.nh}")
                if rec.icomp:
                    e = rec.enc
                    e.coder_version = coder_version
                    if e.ntot_enc > 0:
                        e.data = fin.read(e.ntot_enc)
                        fld = decode_field(e, backend=backend, device=device)
                    else:
                        fld = np.full((rec.nz * rec.nh, rec.ny, rec.nx),
                                      e.midval)
                else:
                    buf = fin.read(ntot * rec.nbytes)
                    arr = np.frombuffer(
                        buf, dtype=np.dtype(f"<f{rec.nbytes}"))
                    fld = arr.astype(np.float64).reshape(
                        rec.nz * rec.nh, rec.ny, rec.nx)
                write_field_raw(fout, ifiletype, convertendian, rec.nbytes,
                                rec.recl, rec.nx, rec.ny, rec.nz, rec.nh,
                                rec.idinv, fld)
