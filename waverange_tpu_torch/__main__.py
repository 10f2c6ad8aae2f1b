"""CLI dispatcher: `python -m waverange_tpu_torch <tool> [args...]`.

The tools of `waverange_tpu.__main__` that run the codec; WR_BACKEND and
WR_DEVICE choose where (see `cli`).
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
