"""wrenc — generic-interface encoder CLI.

Modes (mirroring reference gen_enc.cpp:58-487):
  1. `inmeta` file in the cwd — new `&key=value` / `%field = N` format or
     old positional format;
  2. 11 positional argv:
     INPUT ENCODED HEADER TYPE ENDIANFLIP NF PRECISION NX NY NZ TOLERANCE;
  3. interactive stdin prompts with defaults.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List, Optional

from ..io.generic import FieldSpec, encode_generic_file
from . import backend_and_device


def _parse_inmeta_new(lines: List[str]):
    """New-format parser (gen_enc.cpp:112-276). Returns None if the file
    contains no '&key=value' line (caller falls back to old format)."""
    glb = {"in_name": "data.bin", "out_name": "data.wrb",
           "header_name": "data.wrh"}
    sbuf = [""] * 11
    found = False
    for raw in lines:
        s = raw.strip(" \t\v\r\n")
        if not s or s[0] != "&":
            continue
        parts = s.split("=")
        if len(parts) != 2:
            raise ValueError(f"bad inmeta line: {s}")
        found = True
        k = parts[0].strip().lower()
        v = parts[1].strip()
        if k == "&in_name":
            glb["in_name"] = v
        elif k == "&out_name":
            glb["out_name"] = v
        elif k == "&header_name":
            glb["header_name"] = v
        elif k == "&file_type":
            sbuf[0] = v
        elif k == "&endian_conversion":
            sbuf[1] = v
        elif k == "&number_of_field":
            sbuf[2] = v
    if not found:
        return None
    ifiletype = int(sbuf[0]) if sbuf[0] else 0
    convertendian = int(sbuf[1]) if sbuf[1] else 0
    nf = int(sbuf[2]) if sbuf[2] else 1

    specs: List[Optional[FieldSpec]] = [None] * nf
    # Per-field defaults persist across blocks (the reference's sbuf is
    # never cleared between '%field' blocks — gen_enc.cpp:228-256).
    cur = dict(iintype=2, nx=16, ny=16, nz=16, nh=1, idinv=0, icomp=1,
               tol=1e-16)
    field_id = -1
    nblocks = 0
    for raw in lines:
        s = raw.strip(" \t\v\r\n")
        if not s:
            continue
        if s[0] == "%":
            parts = s.split("=")
            if len(parts) == 2 and parts[0].strip().lower() == "%field":
                v = parts[1].strip()
                if v:
                    field_id = int(v)
                    nblocks += 1
        elif s[0] == "&":
            parts = s.split("=")
            if len(parts) == 2:
                k = parts[0].strip().lower()
                v = parts[1].strip()
                key = {"&input_data_type": "iintype", "&nx": "nx",
                       "&ny": "ny", "&nz": "nz", "&nh": "nh",
                       "&order": "idinv", "&compress": "icomp",
                       "&tolerance": "tol"}.get(k)
                if key and v:
                    cur[key] = float(v) if key == "tol" else int(v)
        elif s[0] == "/":
            specs[field_id] = FieldSpec(
                nbytes=4 if cur["iintype"] == 1 else 8, nx=cur["nx"],
                ny=cur["ny"], nz=cur["nz"], nh=cur["nh"],
                idinv=cur["idinv"], icomp=cur["icomp"],
                tol_base=cur["tol"])
    if nblocks != nf:
        raise ValueError(
            f"Number of fields is {nf} but {nblocks} field blocks found")
    # cur["tol"] is the final state of the running tol_base variable — the
    # value the reference actually encodes every field with (see
    # encode_generic_file's global_tol note).
    return glb["in_name"], glb["out_name"], glb["header_name"], \
        ifiletype, convertendian, specs, cur["tol"]


def _parse_inmeta_old(lines: List[str]):
    """Old positional format (gen_enc.cpp:277-350)."""
    def get(i, default=""):
        return lines[i].rstrip("\r\n") if i < len(lines) else default

    in_name = get(0) or "data.bin"
    out_name = get(1) or "data.wrb"
    header_name = get(2) or "data.wrh"
    ifiletype = int(get(3) or 0)
    convertendian = int(get(4) or 0)
    nf = int(get(5) or 1)
    specs = []
    cur = dict(iintype=2, nx=16, ny=16, nz=16, nh=1, idinv=0, icomp=1,
               tol=1e-16)
    for it in range(nf):
        base = 6 + it * 8
        vals = [get(base + j) for j in range(8)]
        keys = ["iintype", "nx", "ny", "nz", "nh", "idinv", "icomp", "tol"]
        for k, v in zip(keys, vals):
            if v.strip():
                cur[k] = float(v) if k == "tol" else int(v)
        specs.append(FieldSpec(
            nbytes=4 if cur["iintype"] == 1 else 8, nx=cur["nx"],
            ny=cur["ny"], nz=cur["nz"], nh=cur["nh"], idinv=cur["idinv"],
            icomp=cur["icomp"], tol_base=cur["tol"]))
    return (in_name, out_name, header_name, ifiletype, convertendian,
            specs, cur["tol"])


def _interactive():
    def ask(prompt, default):
        print(prompt, end="", flush=True)
        line = sys.stdin.readline().rstrip("\r\n")
        return line if line else default

    in_name = ask("Enter input data file name [data.bin]: ", "data.bin")
    out_name = ask("Enter encoded data file name [data.wrb]: ", "data.wrb")
    header_name = ask("Enter encoding header file name [data.wrh]: ",
                      "data.wrh")
    ifiletype = int(ask("Enter file type (0/1/2) [0]: ", "0"))
    convertendian = int(ask("Enter endian conversion (0/1) [0]: ", "0"))
    nf = int(ask("Enter the number of fields in the file, nf [1]: ", "1"))
    specs = []
    cur = dict(iintype=2, nx=16, ny=16, nz=16, nh=1, idinv=0, icomp=1,
               tol=1e-16)
    for it in range(nf):
        print(f"Field number {it}")
        cur["iintype"] = int(ask("Enter input data type (1/2) [2]: ",
                                 str(cur["iintype"])))
        cur["nx"] = int(ask("Enter nx [16]: ", str(cur["nx"])))
        cur["ny"] = int(ask("Enter ny [16]: ", str(cur["ny"])))
        cur["nz"] = int(ask("Enter nz [16]: ", str(cur["nz"])))
        cur["nh"] = int(ask("Enter nh [1]: ", str(cur["nh"])))
        cur["idinv"] = int(ask("Invert dimensions? (0/1) [0]: ",
                               str(cur["idinv"])))
        cur["icomp"] = int(ask("Enter compression flag (0/1) [1]: ",
                               str(cur["icomp"])))
        tb = cur["tol"]
        if cur["icomp"]:
            cur["tol"] = float(ask("Enter base cutoff relative tolerance "
                                   "[1e-16]: ", str(cur["tol"])))
            tb = cur["tol"]
        else:
            tb = 0.0  # the header shows 0; the running tol keeps its value
        specs.append(FieldSpec(
            nbytes=4 if cur["iintype"] == 1 else 8, nx=cur["nx"],
            ny=cur["ny"], nz=cur["nz"], nh=cur["nh"], idinv=cur["idinv"],
            icomp=cur["icomp"], tol_base=tb))
    return (in_name, out_name, header_name, ifiletype, convertendian,
            specs, cur["tol"])


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    backend, device = backend_and_device()
    # WR_CODER=rans|turbo selects the v2 turbo entropy format
    # (CODER_VERSION 31600); decoders dispatch from the header version.
    coder = os.environ.get("WR_CODER", "range")
    if os.path.exists("inmeta"):
        lines = Path("inmeta").read_text().splitlines(keepends=True)
        parsed = _parse_inmeta_new(lines)
        if parsed is None:
            parsed = _parse_inmeta_old(
                [ln.rstrip("\n") for ln in lines])
        (in_name, out_name, header_name, ifiletype, convertendian, specs,
         global_tol) = parsed
    elif len(argv) == 11:
        in_name, out_name, header_name = argv[0], argv[1], argv[2]
        ifiletype = int(argv[3])
        convertendian = int(argv[4])
        nf = int(argv[5])
        iintype = int(argv[6])
        nx, ny, nz = int(argv[7]), int(argv[8]), int(argv[9])
        tol = float(argv[10])
        specs = [FieldSpec(nbytes=4 if iintype == 1 else 8, nx=nx, ny=ny,
                           nz=nz, nh=1, idinv=0, icomp=1, tol_base=tol)
                 for _ in range(nf)]
        global_tol = tol
    else:
        print("usage: wrenc INPUT_FILE ENCODED_FILE HEADER_FILE TYPE "
              "ENDIANFLIP NF PRECISION NX NY NZ TOLERANCE")
        print("interactive mode if not enough arguments are passed.")
        (in_name, out_name, header_name, ifiletype, convertendian, specs,
         global_tol) = _interactive()

    encode_generic_file(in_name, out_name, header_name, ifiletype,
                        bool(convertendian), specs, backend=backend,
                        global_tol=global_tol, coder=coder, device=device)
    print("=== End of compression ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
