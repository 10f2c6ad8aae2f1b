"""FluSI wrenc CLI (reference src/flusi/main_enc.cpp:56-191).

Modes: `inmeta` file (&in_name/&out_name/&file_type/&tolerance or old
4-line positional), 4 positional argv
(original.h5 compressed.h5 TYPE TOLERANCE), or stdin prompts.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List, Optional

from ..io.flusi import encode_flusi_file
from . import backend_and_device


def _parse_inmeta(path: str):
    lines = Path(path).read_text().splitlines()
    kv = {}
    found = False
    for raw in lines:
        s = raw.strip(" \t\v\r\n")
        if s and s[0] == "&":
            parts = s.split("=")
            if len(parts) != 2:
                raise ValueError(f"bad inmeta line: {s}")
            found = True
            kv[parts[0].strip().lower()] = parts[1].strip()
    if found:
        return (kv.get("&in_name", ""), kv.get("&out_name", ""),
                kv.get("&file_type", "0"), kv.get("&tolerance", "1e-16"))
    return (lines[0] if len(lines) > 0 else "",
            lines[1] if len(lines) > 1 else "",
            lines[2] if len(lines) > 2 else "0",
            lines[3] if len(lines) > 3 else "1e-16")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    backend, device = backend_and_device()
    coder = os.environ.get("WR_CODER", "range")
    if os.path.exists("inmeta"):
        in_name, out_name, bar, bar2 = _parse_inmeta("inmeta")
    elif len(argv) == 4:
        in_name, out_name, bar, bar2 = argv
    else:
        print("usage: flusi_enc original_000.h5 compressed_000.h5 TYPE "
              "TOLERANCE")

        def ask(p, d=""):
            print(p, end="", flush=True)
            line = sys.stdin.readline().rstrip("\r\n")
            return line if line else d

        in_name = ask("Enter input file name []: ")
        out_name = ask("Enter output file name []: ")
        bar = ask("Enter file type (0: regular output; 1: backup) [0]: ",
                  "0")
        bar2 = ask("Enter base cutoff relative tolerance [1e-16]: ",
                   "1e-16")
    ifiletype = int(bar or 0)
    tol = float(bar2 or 1e-16)
    encode_flusi_file(in_name, out_name, ifiletype, tol, backend=backend,
                      coder=coder, device=device)
    print("=== End of compression ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
