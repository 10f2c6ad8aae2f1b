"""MSSG (JAMSTEC atmosphere/ocean model) interface.

Byte-compatible with the reference's wrmssgenc/wrmssgdec (src/mssg/):

  * mode 0 "regular output": GrADS `.ctl` control file (DSET/UNDEF/XDEF/
    YDEF/ZDEF/TDEF), flat `.grd` with nt time records; per-record mask
    detection — values below undef+|undef|*1e-4 are masked out, the field
    is padded with the mean of unmasked values and the binary mask is
    compressed as its own record named "mask" with wtflag=0 and relative
    tolerance 0.126 (mssg_enc.cpp:299-407, mssg_dec.cpp:216-323);
  * mode 1 "backup united": Fortran namelist `.nmlst`; Yin-Yang global
    grid arithmetic nlg=3*npg-4, nx=nlg+2*i_over, ny=(npg+2*j_over)*2;
    gathers all nprocx*nprocy subdomain files `prefix.p_NNNN` into one
    global array per dataset; record 0 is the `time` record whose first
    15 doubles are stored as text in the header and re-broadcast to every
    subdomain on decode (mssg_enc.cpp:412-600, mssg_dec.cpp:334-549);
  * mode 2 "backup divided": encodes only this PROCID's local
    nxloc*nyloc*nz file; output names carry the zero-padded 4-digit proc
    id (mssg_enc.cpp:457-470).

A copy of `waverange_tpu.io.mssg` that calls this package's codec
(`backend`, `device` as in `io.generic`) and its native mask separation.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, TextIO, Tuple

import numpy as np

from .. import native as wn
from ..core.codec import CODER_VERSION, NLAYMAX, EncodedField, \
    encode_field, decode_field
from .generic import g19, _TokenReader, _env_conformance


NDSMAX = 50
MSSG_FILE_DIG = 4
MSSG_TIME_REC_LEN = 15
MSSG_MASK_TOLREL = 0.126
MSSG_MASK_THRESHOLD_ACC = 1e-4


# ---------------------------------------------------------------------------
# Control file parsers
# ---------------------------------------------------------------------------

def read_control_file(path: str):
    """Parse the `.nmlst` Fortran-namelist control file
    (ctrl_aux.cpp:49-195). Returns (nx, ny, nz, nprocx, nprocy, dsettab).
    """
    text = Path(path).read_text()
    # Tokenizer: separators newline/&/space/'/, ; '=' switches to value.
    pairs: List[Tuple[str, str]] = []
    keys = {"nx", "ny", "nr", "npg", "i_over", "j_over", "nproc",
            "dim_size", "var", "rec"}
    buf = ""
    state = 0  # 0 idle, 1 name, 2 value
    expect_val = False
    pend_name = ""
    for c in text:
        if c in "\n& ',":
            # separator resets state only after a completed token — while
            # waiting for a value (just after '='), whitespace is skipped
            # with the state preserved (ctrl_aux.cpp:77)
            if buf:
                if state == 1:
                    if buf in keys:
                        pend_name = buf
                        expect_val = True
                elif state == 2:
                    if expect_val:
                        pairs.append((pend_name, buf))
                        expect_val = False
                buf = ""
                state = 0
        elif c == "=":
            state = 2
            buf = ""
        else:
            if state != 2:
                state = 1
            buf += c

    vals: Dict[str, str] = {}
    for k, v in pairs:
        if k not in ("var", "rec"):
            vals.setdefault(k, v)  # first occurrence wins, like reference
    if "npg" in vals:
        npg = int(vals["npg"])
        nlg = 3 * npg - 4
        i_over = int(vals["i_over"])
        j_over = int(vals["j_over"])
        nx = nlg + 2 * i_over
        ny = (npg + 2 * j_over) * 2  # two Yin-Yang grids
    else:
        nx = int(vals["nx"])
        ny = int(vals["ny"])
    nz = int(vals["nr"])
    nproc = int(vals["nproc"])
    nprocx = int(vals["dim_size"])
    nprocy = nproc // nprocx
    # var/rec pairs in file order; dsettab[rec-1] = var
    dsettab = [""] * NDSMAX
    ndset = 0
    seq = [p for p in pairs if p[0] in ("var", "rec")]
    for i in range(0, len(seq) - 1, 2):
        if seq[i][0] == "var" and seq[i + 1][0] == "rec":
            dsettab[int(seq[i + 1][1]) - 1] = seq[i][1]
            ndset += 1
    return nx, ny, nz, nprocx, nprocy, dsettab[:ndset]


def read_control_file_grads(path: str):
    """Parse the GrADS `.ctl` control file (ctrl_aux.cpp:199-297).
    Returns (nx, ny, nz, nt, undef, dsetname)."""
    vals: Dict[str, str] = {}
    buf = ""
    state = 1  # 1 name at line start, 2 value, 0 skip
    pend = ""
    keys = {"DSET", "UNDEF", "XDEF", "YDEF", "ZDEF", "TDEF"}
    for c in Path(path).read_text():
        if c in "\n^ ":
            if buf:
                if state == 1:
                    if buf in keys:
                        pend = buf
                        state = 2
                elif state == 2:
                    vals[pend] = buf
                    state = 0
                buf = ""
            if c == "\n":
                state = 1
        else:
            buf += c
    return (int(vals["XDEF"]), int(vals["YDEF"]), int(vals["ZDEF"]),
            int(vals["TDEF"]), float(vals["UNDEF"]), vals["DSET"])


# ---------------------------------------------------------------------------
# Raw field I/O (.grd / .p_NNNN records)
# ---------------------------------------------------------------------------

def _dt(nbytes: int, convertendian: bool) -> np.dtype:
    if nbytes not in (4, 8):
        raise ValueError("MSSG input nbytes must be equal to 4 or 8")
    return np.dtype(f"{'>' if convertendian else '<'}f{nbytes}")


def read_field_mssg(path: str, convertendian: bool, nbytes: int, idset: int,
                    nxloc: int, nyloc: int, nz: int) -> np.ndarray:
    """Read record `idset` from a flat file as an (nz, nyloc, nxloc) f64
    array (ctrl_aux.cpp:386-456, local-read form)."""
    count = nz * nyloc * nxloc
    offset = idset * count * nbytes
    arr = np.fromfile(path, dtype=_dt(nbytes, convertendian), count=count,
                      offset=offset)
    if arr.size != count:
        raise IOError(f"Cannot read from {path}")
    return arr.astype(np.float64).reshape(nz, nyloc, nxloc)


def write_field_mssg(path: str, convertendian: bool, nbytes: int,
                     idset: int, fld: np.ndarray) -> None:
    """Append record (truncate when idset == 0) — ctrl_aux.cpp:301-382."""
    mode = "wb" if idset == 0 else "ab"
    out = np.ascontiguousarray(fld, np.float64).astype(
        _dt(nbytes, convertendian))
    with open(path, mode) as f:
        f.write(out.tobytes())


def proc_label(iproc: int) -> str:
    return f"{iproc:0{MSSG_FILE_DIG}d}"


# ---------------------------------------------------------------------------
# Header records
# ---------------------------------------------------------------------------

def append_mssg_header(fh: TextIO, idset: int, dsetname: str,
                       e: EncodedField) -> None:
    fh.write(" -----\n")
    fh.write(f"{idset + 1}\n")
    fh.write(f" Data set name = {dsetname}\n")
    line = " tolabs; midval; halfspanval; wlev; nlay; ntot_enc;"
    if e.ntot_enc > 0:
        line += " deps_vec(1:nlay); minval_vec(1:nlay); len_enc_vec(1:nlay)"
    fh.write(line + "\n")
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


def read_mssg_header(tr: _TokenReader, idset: int, nx: int, ny: int,
                     nz: int) -> Tuple[str, EncodedField]:
    """Parse one record (ctrl_aux.cpp:518-565)."""
    tr.line()  # " -----"
    idset1 = tr.i()
    if idset1 != idset + 1:
        raise ValueError(
            "Encoding header file does not match with the control file: "
            f"idset+1 = {idset + 1} idset1 = {idset1}")
    tr.line()
    name_line = tr.line()
    dsetname = name_line.rstrip("\n")[17:]
    tr.line()  # reminder
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
    return dsetname, EncodedField(
        nx=nx, ny=ny, nz=nz, tolabs=tolabs, midval=midval,
        halfspanval=halfspanval, wlev=wlev, nlay=nlay, ntot_enc=ntot_enc,
        deps_vec=deps, minval_vec=minv, len_enc_vec=lens)


def _write_preamble(fh: TextIO, banner: str, prefix: str, ext: str,
                    ifiletype: int, nbytes: int, convertendian: bool,
                    tol_base: float, endian_no_text: str,
                    coder_version: int = CODER_VERSION) -> None:
    fh.write(f" ===== Header file for compressed MSSG {banner} =====\n")
    fh.write(f" Coder version: {coder_version}\n")
    fh.write(f" File name prefix: {prefix}\n")
    fh.write(f" Encoded file extension name: {ext}\n")
    fh.write(" File type (0: regular output; 1: backup merged; 2: backup "
             f"separated): {ifiletype}\n")
    fh.write(f" Input files contained {nbytes}-byte floating point data\n")
    if convertendian:
        fh.write(" Converted big endian to little endian or vice versa\n")
    else:
        fh.write(endian_no_text + "\n")
    # C++ default formatting of the tolerance double (6 sig digits)
    fh.write(f" Base cutoff relative tolerance: {tol_base:g}\n")


# ---------------------------------------------------------------------------
# Encode / decode of whole files
# ---------------------------------------------------------------------------

def encode_mssg(prefix: str, ext: str, ifiletype: int, iintype: int,
                convertendian: bool, tol_base: float, thisproc: int,
                backend: str = "torch", verbose: bool = True,
                coder: str = "range", device="cuda") -> None:
    from ..core.codec import _CODER_IDS, _VERSION_BY_ID
    coder_version = _VERSION_BY_ID[_CODER_IDS[coder]]
    nbytes = 4 if iintype == 1 else 8
    if ifiletype == 0:
        nx, ny, nz, nt, undef, dsetname = read_control_file_grads(
            prefix + ".ctl")
        header_name = prefix + "_h" + ext
        out_name = prefix + "_f" + ext
        with open(header_name, "w") as fh:
            _write_preamble(fh, "regular output data", prefix, ext,
                            ifiletype, nbytes, convertendian, tol_base,
                            " No endian conversion", coder_version)
        open(out_name, "wb").close()
        undef_thresh = undef + abs(undef) * MSSG_MASK_THRESHOLD_ACC
        for it in range(nt):
            fld = read_field_mssg(dsetname, convertendian, nbytes, it,
                                  nx, ny, nz)
            if verbose:
                print(f"Field number it={it}")
            minval = fld.min()
            if minval < undef_thresh:
                # mask separation (mssg_enc.cpp:323-381); sequential-sum
                # padding semantics via the native helper
                fld = np.ascontiguousarray(fld)
                mask, _pad = wn.mask_separate(fld, undef_thresh, minval)
                e_mask = encode_field(
                    mask, MSSG_MASK_TOLREL, wtflag=0,
                    cutoff=np.array([MSSG_MASK_TOLREL]), backend=backend,
                    coder=coder, conformance=_env_conformance(),
                    device=device)
                with open(header_name, "a") as fh:
                    append_mssg_header(fh, it, "mask", e_mask)
                if e_mask.ntot_enc > 0:
                    with open(out_name, "ab") as fo:
                        fo.write(e_mask.data)
            e = encode_field(fld, tol_base, wtflag=1, backend=backend,
                             coder=coder, conformance=_env_conformance(),
                             device=device)
            with open(header_name, "a") as fh:
                append_mssg_header(fh, it, dsetname, e)
            if e.ntot_enc > 0:
                with open(out_name, "ab") as fo:
                    fo.write(e.data)
        return

    if ifiletype in (1, 2):
        nx, ny, nz, nprocx, nprocy, dsettab = read_control_file(
            prefix + ".nmlst")
        ndset = len(dsettab)
        nxloc = nx // nprocx
        nyloc = ny // nprocy
        lbl = proc_label(thisproc)
        if ifiletype == 1:
            header_name = prefix + "_h" + ext
            out_name = prefix + "_f" + ext
        else:
            header_name = prefix + "_h" + lbl + ext
            out_name = prefix + "_f" + lbl + ext
        in_name = prefix + ".p_" + lbl
        time_rec = read_field_mssg(in_name, convertendian, nbytes, 0,
                                   nxloc, nyloc, nz).ravel()
        with open(header_name, "w") as fh:
            _write_preamble(fh, "restart data", prefix, ext, ifiletype,
                            nbytes, convertendian, tol_base,
                            " Did not perform endian conversion",
                            coder_version)
            fh.write(" -----\n1\n")
            fh.write(f" Data set name = {dsettab[0]}\n")
            fh.write(f" first {MSSG_TIME_REC_LEN} elements of time "
                     "record\n")
            fh.write("".join(g19(time_rec[j]) + " "
                             for j in range(MSSG_TIME_REC_LEN)) + "\n")
        open(out_name, "wb").close()
        for idset in range(1, ndset):
            if ifiletype == 1:
                fld = np.empty((nz, ny, nx), np.float64)
                for iprocy in range(nprocy):
                    for iprocx in range(nprocx):
                        iproc = iprocx + nprocx * iprocy
                        sub = read_field_mssg(
                            prefix + ".p_" + proc_label(iproc),
                            convertendian, nbytes, idset, nxloc, nyloc,
                            nz)
                        fld[:, iprocy * nyloc:(iprocy + 1) * nyloc,
                            iprocx * nxloc:(iprocx + 1) * nxloc] = sub
            else:
                fld = read_field_mssg(in_name, convertendian, nbytes,
                                      idset, nxloc, nyloc, nz)
            if verbose:
                print(f" dset={dsettab[idset]}")
            e = encode_field(fld, tol_base, wtflag=1, backend=backend,
                             coder=coder, conformance=_env_conformance(),
                             device=device)
            with open(header_name, "a") as fh:
                append_mssg_header(fh, idset, dsettab[idset], e)
            if e.ntot_enc > 0:
                with open(out_name, "ab") as fo:
                    fo.write(e.data)
        return

    raise ValueError("unknown file type")


def _read_coder_version(header_name: str) -> int:
    """Coder version from preamble line 2 (31503 range / 31600 turbo)."""
    with open(header_name) as fh:
        fh.readline()
        line = fh.readline()
    try:
        return int(line.split(":")[-1])
    except ValueError:
        return CODER_VERSION


def decode_mssg(in_prefix: str, ext: str, out_prefix: str, ifiletype: int,
                iouttype: int, convertendian: bool, thisproc: int,
                backend: str = "torch", verbose: bool = True,
                device="cuda") -> None:
    nbytes = 4 if iouttype == 1 else 8
    if ifiletype == 0:
        nx, ny, nz, nt, undef, dsetname = read_control_file_grads(
            in_prefix + ".ctl")
        if in_prefix != out_prefix:
            import shutil
            shutil.copyfile(in_prefix + ".ctl", out_prefix + ".ctl")
        out_name = out_prefix + ".grd"
        header_name = in_prefix + "_h" + ext
        in_name = in_prefix + "_f" + ext
        coder_version = _read_coder_version(header_name)
        with open(header_name) as fh, open(in_name, "rb") as fin:
            for _ in range(8):
                fh.readline()
            tr = _TokenReader(fh)
            for it in range(nt):
                name, e = read_mssg_header(tr, it, nx, ny, nz)
                mask_rec = None
                mask_midval = 0.0
                if name == "mask":
                    if e.ntot_enc > 0:
                        e.data = fin.read(e.ntot_enc)
                        e.coder_version = coder_version
                        m = decode_field(e, backend=backend, device=device)
                        mask_midval = e.midval
                        mask_rec = np.where(m < e.midval, undef, 0.0)
                        name, e = read_mssg_header(tr, it, nx, ny, nz)
                    else:
                        mask_rec = np.full((nz, ny, nx), e.midval)
                if e.ntot_enc > 0:
                    e.data = fin.read(e.ntot_enc)
                    e.coder_version = coder_version
                    fld = decode_field(e, backend=backend, device=device)
                else:
                    fld = np.full((nz, ny, nx), e.midval)
                if mask_rec is not None:
                    fld = np.where(mask_rec < mask_midval, mask_rec, fld)
                write_field_mssg(out_name, convertendian, nbytes, it, fld)
        return

    if ifiletype in (1, 2):
        nx, ny, nz, nprocx, nprocy, dsettab = read_control_file(
            in_prefix + ".nmlst")
        ndset = len(dsettab)
        nxloc = nx // nprocx
        nyloc = ny // nprocy
        if in_prefix != out_prefix:
            import shutil
            shutil.copyfile(in_prefix + ".nmlst", out_prefix + ".nmlst")
        lbl = proc_label(thisproc)
        if ifiletype == 1:
            header_name = in_prefix + "_h" + ext
            in_name = in_prefix + "_f" + ext
        else:
            header_name = in_prefix + "_h" + lbl + ext
            in_name = in_prefix + "_f" + lbl + ext
        shape = (nz, ny, nx) if ifiletype == 1 else (nz, nyloc, nxloc)
        coder_version = _read_coder_version(header_name)
        with open(header_name) as fh, open(in_name, "rb") as fin:
            tr = _TokenReader(fh)
            for idset in range(ndset):
                fld = np.zeros(shape, np.float64)
                if idset == 0:
                    # time record: 12 header lines then 15 doubles
                    for _ in range(12):
                        tr.line()
                    flat = fld.ravel()
                    for j in range(MSSG_TIME_REC_LEN):
                        flat[j] = tr.d()
                    tr.line()
                    if ifiletype == 1:
                        # broadcast to every subdomain's row origin
                        for iprocy in range(nprocy):
                            for iprocx in range(nprocx):
                                if iprocx + iprocy == 0:
                                    continue
                                for ix in range(MSSG_TIME_REC_LEN):
                                    j = (ix + iprocx * nxloc
                                         + nx * (iprocy * nyloc))
                                    flat[j] = flat[ix]
                else:
                    name, e = read_mssg_header(
                        tr, idset, shape[2], shape[1], shape[0])
                    if e.ntot_enc > 0:
                        e.data = fin.read(e.ntot_enc)
                        e.coder_version = coder_version
                        fld = decode_field(e, backend=backend, device=device)
                    else:
                        fld = np.full(shape, e.midval)
                if ifiletype == 1:
                    for iprocy in range(nprocy):
                        for iprocx in range(nprocx):
                            iproc = iprocx + nprocx * iprocy
                            sub = fld[:,
                                      iprocy * nyloc:(iprocy + 1) * nyloc,
                                      iprocx * nxloc:(iprocx + 1) * nxloc]
                            write_field_mssg(
                                out_prefix + ".p_" + proc_label(iproc),
                                convertendian, nbytes, idset, sub)
                else:
                    write_field_mssg(out_prefix + ".p_" + lbl,
                                     convertendian, nbytes, idset, fld)
        return

    raise ValueError("unknown file type")
