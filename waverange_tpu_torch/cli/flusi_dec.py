"""FluSI wrdec CLI (reference src/flusi/main_dec.cpp:54-135).

Modes: 4 positional argv (compressed.h5 decompressed.h5 TYPE PRECISION)
or stdin prompts.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..io.flusi import decode_flusi_file
from . import backend_and_device


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    backend, device = backend_and_device()
    if len(argv) == 4:
        in_name, out_name, bar, bar2 = argv
    else:
        print("usage: flusi_dec compressed_000.h5 decompressed_000.h5 "
              "TYPE PRECISION")

        def ask(p, d=""):
            print(p, end="", flush=True)
            line = sys.stdin.readline().rstrip("\r\n")
            return line if line else d

        in_name = ask("Enter compressed data file name []: ")
        out_name = ask("Enter reconstructed file name []: ")
        bar = ask("Enter file type (0: regular output; 1: backup) [0]: ",
                  "0")
        # effective reference default is FLOAT: the prompt advertises [2]
        # but main_dec.cpp:70 initializes iouttype = 1 and an empty line
        # leaves it unchanged.
        bar2 = ask("Enter output data type (1: float; 2: double) [2]: ",
                   "1")
    decode_flusi_file(in_name, out_name, int(bar or 0),
                      iouttype=int(bar2 or 1), backend=backend,
                      device=device)
    print("=== End of decompression ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
