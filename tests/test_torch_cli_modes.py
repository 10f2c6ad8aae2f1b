"""The port's CLI modes (`waverange_tpu_torch.cli`, on the CPU): the cases
of tests/test_cli_modes.py (the host library's self-test, wrdec fed by
stdin, header and payload errors, MSSG and FluSI inmeta and stdin modes),
each against the JAX package's CLI on its native backend and against the
reference binaries; the `python -m waverange_tpu_torch` dispatcher, and
the CUDA default of WR_DEVICE."""
import ctypes as ct
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waverange_tpu_torch import __main__ as dispatcher
from waverange_tpu_torch.io.generic import decode_generic_file
from waverange_tpu_torch.native.build import ensure_built

from conftest import REPO, smooth_field
from test_cli_modes import (FLUSI_INMETA_NEW, FLUSI_INMETA_OLD, FLUSI_STDIN,
                            MSSG_INMETA_NEW, MSSG_INMETA_OLD, MSSG_STDIN)
from test_generic_cli import make_c_file
from test_mssg import make_regular
from torch_cli_helpers import dirs, port, reference, same_files  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"


def test_magicdiv_selftest():
    lib = ct.CDLL(str(ensure_built()))
    assert lib.wrn_selftest_magicdiv() == 0


def test_stdin_decode(reference, tmp_path):
    """wrdec fed by stdin (the reference examples' `wrdec < outmeta`)."""
    a = smooth_field((12, 10, 8))
    r, p = dirs(tmp_path, lambda d: make_c_file(d / "data.bin", [(a, 8)]))
    args = ["data.bin", "data.wrb", "data.wrh", 2, 0, 1, 2, 8, 10, 12,
            "1e-6"]
    reference("wrenc", args, r)
    port("wrenc", args, p)
    outmeta = "data.wrb\ndata.wrh\ndatarec.bin\n2\n0\n"
    reference("wrdec", [], r, stdin=outmeta)
    port("wrdec", [], p, stdin=outmeta)
    same_files(r, p, ["datarec.bin"])


def test_header_field_mismatch_raises(tmp_path):
    """The decoder stops where the header's field id does not match
    (the reference throws, gen_aux.cpp:567)."""
    lines = (GOLDEN / "data.wrh").read_text().splitlines()
    lines[lines.index(" -----") + 1] = "7"
    (tmp_path / "bad.wrh").write_text("\n".join(lines) + "\n")
    shutil.copy(GOLDEN / "data.wrb", tmp_path / "data.wrb")
    with pytest.raises(ValueError, match="header"):
        decode_generic_file(str(tmp_path / "data.wrb"),
                            str(tmp_path / "bad.wrh"),
                            str(tmp_path / "out.bin"), 2, False,
                            verbose=False, device="cpu")


def test_truncated_payload_raises(tmp_path):
    shutil.copy(GOLDEN / "data.wrh", tmp_path / "data.wrh")
    (tmp_path / "data.wrb").write_bytes(
        (GOLDEN / "data.wrb").read_bytes()[:100])
    with pytest.raises(ValueError, match="truncated"):
        decode_generic_file(str(tmp_path / "data.wrb"),
                            str(tmp_path / "data.wrh"),
                            str(tmp_path / "out.bin"), 2, False,
                            verbose=False, device="cpu")


@pytest.mark.parametrize("mode", ["new", "old", "stdin"])
def test_mssg_enc_config_modes(reference, tmp_path, mode):
    def make(d):
        make_regular(d)
        if mode != "stdin":
            (d / "inmeta").write_text(MSSG_INMETA_NEW if mode == "new"
                                      else MSSG_INMETA_OLD)
    r, p = dirs(tmp_path, make)
    stdin = MSSG_STDIN if mode == "stdin" else None
    reference("mssg_enc", [], r, stdin=stdin)
    port("mssg_enc", [], p, stdin=stdin)
    # stdin mode leaves the extension empty (mssg_enc.cpp:102/218)
    ext = "" if mode == "stdin" else ".enc"
    same_files(r, p, [f"ocean_h{ext}", f"ocean_f{ext}"])
    if mode == "stdin":
        dargs, dec_stdin = ["ocean", "", "oceanrec", 0, 1, 1, 0], None
    else:  # the reference decoder has no inmeta mode: stdin
        dargs, dec_stdin = [], "ocean\n.enc\noceanrec\n0\n\n1\n0\n"
    reference("mssg_dec", dargs, r, stdin=dec_stdin)
    port("mssg_dec", dargs, p, stdin=dec_stdin)
    same_files(r, p, ["oceanrec.grd", "oceanrec.ctl"])


@pytest.mark.parametrize("mode", ["new", "old", "stdin"])
def test_flusi_enc_config_modes(reference, tmp_path, mode):
    from test_flusi import _h5_equal, make_regular_input

    def make(d):
        make_regular_input(d / "in.h5", shape=(12, 16, 8), name="p_00003")
        if mode != "stdin":
            (d / "inmeta").write_text(FLUSI_INMETA_NEW if mode == "new"
                                      else FLUSI_INMETA_OLD)
    r, p = dirs(tmp_path, make)
    stdin = FLUSI_STDIN if mode == "stdin" else None
    reference("flusi_enc", [], r, stdin=stdin)
    port("flusi_enc", [], p, stdin=stdin)
    _h5_equal(r / "enc.h5", p / "enc.h5", ["p_00003"])
    dec_stdin = "enc.h5\ndec.h5\n0\n\n"
    reference("flusi_dec", [], r, stdin=dec_stdin)
    port("flusi_dec", [], p, stdin=dec_stdin)
    _h5_equal(r / "dec.h5", p / "dec.h5", ["p_00003"])


def test_dispatcher_runs_the_tools(tmp_path, monkeypatch):
    a = smooth_field((8, 8, 8))
    make_c_file(tmp_path / "data.bin", [(a, 8)])
    env = dict(os.environ, WR_DEVICE="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "waverange_tpu_torch", "wrenc",
                        "data.bin", "data.wrb", "data.wrh", "2", "0", "1",
                        "2", "8", "8", "8", "1e-9"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WR_DEVICE", "cpu")
    assert dispatcher.main(["wrdec", "data.wrb", "data.wrh", "datarec.bin",
                            "2", "0"]) == 0
    rec = np.fromfile(tmp_path / "datarec.bin").reshape(a.shape)
    assert np.abs(rec - a).max() <= 1.3e-9 * np.abs(a).max()


def test_dispatcher_lists_seven_tools(capsys, tmp_path, monkeypatch):
    assert dispatcher.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert all(t in out for t in ("wrenc", "wrdec", "flusi-enc", "flusi-dec",
                                  "mssg-enc", "mssg-dec", "build-lib"))
    assert "bench" not in out
    assert dispatcher.main(["bench"]) == 2
    # build-lib, with its default directory pointed at tmp_path
    from waverange_tpu_torch.native import libwaverange
    monkeypatch.setattr(libwaverange, "DEFAULT_DIR", tmp_path)
    capsys.readouterr()
    assert dispatcher.main(["build-lib"]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "lib")
    assert {p.name for p in (tmp_path / "lib").iterdir()} == {
        "libwaverange.so", "libwaverange.a"}
    assert (tmp_path / "include" / "waverange.h").is_file()


def test_tools_run_on_cuda_by_default(tmp_path, monkeypatch):
    """Without WR_DEVICE the tools ask for the card, and fail without one
    rather than fall back to the CPU."""
    from waverange_tpu_torch.cli import wrenc
    a = smooth_field((8, 8, 8))
    make_c_file(tmp_path / "data.bin", [(a, 8)])
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WR_DEVICE", raising=False)
    monkeypatch.delenv("WR_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wrenc.main(["data.bin", "data.wrb", "data.wrh", "2", "0", "1", "2",
                    "8", "8", "8", "1e-6"])
