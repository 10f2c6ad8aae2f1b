"""wrdec — generic-interface decoder CLI (reference gen_dec.cpp:54-268).

Modes: 5 positional argv (ENCODED HEADER EXTRACTED TYPE ENDIANFLIP) or
interactive stdin prompts with defaults (fed by `outmeta` redirects in the
reference examples).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..io.generic import decode_generic_file
from . import backend_and_device


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    backend, device = backend_and_device()
    if len(argv) == 5:
        in_name, header_name, out_name = argv[0], argv[1], argv[2]
        ifiletype = int(argv[3])
        convertendian = int(argv[4])
    else:
        print("usage: wrdec ENCODED_FILE HEADER_FILE EXTRACTED_FILE TYPE "
              "ENDIANFLIP")
        print("interactive mode if not enough arguments are passed.")

        def ask(prompt, default):
            print(prompt, end="", flush=True)
            line = sys.stdin.readline().rstrip("\r\n")
            return line if line else default

        in_name = ask("Enter encoded data file name [data.wrb]: ",
                      "data.wrb")
        header_name = ask("Enter encoding header file name [data.wrh]: ",
                          "data.wrh")
        out_name = ask("Enter extracted (output) data file name "
                       "[datarec.bin]: ", "datarec.bin")
        ifiletype = int(ask("Enter file type (0/1/2) [0]: ", "0"))
        convertendian = int(ask("Enter endian conversion (0/1) [0]: ", "0"))

    decode_generic_file(in_name, header_name, out_name, ifiletype,
                        bool(convertendian), backend=backend,
                        device=device)
    print("=== End of decompression ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
