"""CLI dispatcher: `python -m waverange_tpu_torch <tool> [args...]`.

The tools of `waverange_tpu.__main__` but `bench`: the six that run the
codec, where WR_BACKEND and WR_DEVICE choose where (see `cli`), and
`build-lib [DEST]`, which builds the drop-in libwaverange
(`native.libwaverange`) and prints its lib directory.
"""
import importlib
import sys

TOOLS = {
    "wrenc": ("cli.wrenc", "generic encoder (raw / Fortran-sequential)"),
    "wrdec": ("cli.wrdec", "generic decoder"),
    "flusi-enc": ("cli.flusi_enc", "FluSI HDF5 encoder"),
    "flusi-dec": ("cli.flusi_dec", "FluSI HDF5 decoder"),
    "mssg-enc": ("cli.mssg_enc", "MSSG encoder (regular/united/divided)"),
    "mssg-dec": ("cli.mssg_dec", "MSSG decoder"),
    "build-lib": ("native.libwaverange", "build drop-in libwaverange"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m waverange_tpu_torch <tool> [args...]\n")
        for name, (_, desc) in TOOLS.items():
            print(f"  {name:10s} {desc}")
        return 0
    if argv[0] not in TOOLS:
        print(f"unknown tool: {argv[0]}")
        return 2
    mod = importlib.import_module(f"waverange_tpu_torch.{TOOLS[argv[0]][0]}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
