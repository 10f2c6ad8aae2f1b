"""The port's generic wrenc/wrdec (`waverange_tpu_torch.cli`, on the CPU)
against the reference: the cases of tests/test_generic_cli.py, each
against the JAX package's CLI on its native backend and against the
reference binaries, and the golden files of tests/golden/ as
tests/test_golden_fixtures.py holds them. Byte compares of `.wrh`,
`.wrb` and the reconstructed files."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from conftest import smooth_field
from test_generic_cli import make_c_file, make_fortran_file
from torch_cli_helpers import dirs, package, port, same_files
from torch_cli_helpers import reference  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
ENCODED = ["data.wrh", "data.wrb"]


def _encode_decode(reference, r, p, enc_args, dec_args):
    reference("wrenc", enc_args, r)
    port("wrenc", enc_args, p)
    same_files(r, p, ENCODED)
    reference("wrdec", dec_args, r)
    port("wrdec", dec_args, p)
    same_files(r, p, ["datarec.bin"])


@pytest.mark.parametrize("ifiletype", [0, 1, 2])
@pytest.mark.parametrize("nbytes", [4, 8])
def test_argv_roundtrip(reference, tmp_path, ifiletype, nbytes):
    a = smooth_field((16, 16, 16))

    def make(d):
        if ifiletype == 2:
            make_c_file(d / "data.bin", [(a, nbytes)])
        else:
            make_fortran_file(d / "data.bin", [(a, nbytes)],
                              mlen=4 if ifiletype == 0 else 8)
    r, p = dirs(tmp_path, make)
    args = ["data.bin", "data.wrb", "data.wrh", ifiletype, 0, 1,
            1 if nbytes == 4 else 2, 16, 16, 16, "1e-7"]
    dargs = ["data.wrb", "data.wrh", "datarec.bin", ifiletype, 0]
    _encode_decode(reference, r, p, args, dargs)
    # cross: the port's decoder on the reference's files
    port("wrdec", ["data.wrb", "data.wrh", "datarec2.bin", ifiletype, 0], r)
    assert (r / "datarec2.bin").read_bytes() == \
        (r / "datarec.bin").read_bytes()


def test_inmeta_new_heterogeneous(reference, tmp_path):
    """Several fields: mixed dtype, shape and icomp, new inmeta format."""
    rng = np.random.default_rng(4)
    f0 = smooth_field((8, 12, 16))
    f1 = smooth_field((4, 4, 20)) + 0.01 * rng.standard_normal((4, 4, 20))
    f2 = rng.standard_normal((2, 3, 4))  # uncompressed passthrough
    txt = ("&in_name = data.bin\n&out_name = data.wrb\n"
           "&header_name = data.wrh\n&file_type = 2\n"
           "&endian_conversion = 0\n&number_of_field = 3\n"
           "%field = 0\n&input_data_type = 2\n&nx = 16\n&ny = 12\n&nz = 8\n"
           "&nh = 1\n&order = 0\n&compress = 1\n&tolerance = 1e-8\n/\n"
           "%field = 1\n&input_data_type = 1\n&nx = 20\n&ny = 4\n&nz = 4\n"
           "&compress = 1\n&tolerance = 1e-4\n/\n"
           "%field = 2\n&input_data_type = 2\n&nx = 4\n&ny = 3\n&nz = 2\n"
           "&compress = 0\n/\n")

    def make(d):
        make_c_file(d / "data.bin", [(f0, 8), (f1, 4), (f2, 8)])
        (d / "inmeta").write_text(txt)
    r, p = dirs(tmp_path, make)
    reference("wrenc", [], r)
    port("wrenc", [], p)
    same_files(r, p, ENCODED)
    dargs = ["data.wrb", "data.wrh", "datarec.bin", 2, 0]
    reference("wrdec", dargs, r)
    port("wrdec", dargs, p)
    same_files(r, p, ["datarec.bin"])


def test_inmeta_old_format(reference, tmp_path):
    a = smooth_field((8, 8, 8))

    def make(d):
        make_c_file(d / "data.bin", [(a, 8)])
        (d / "inmeta").write_text("data.bin\ndata.wrb\ndata.wrh\n2\n0\n1\n"
                                  "2\n8\n8\n8\n1\n0\n1\n1e-6\n")
    r, p = dirs(tmp_path, make)
    reference("wrenc", [], r)
    port("wrenc", [], p)
    same_files(r, p, ENCODED)


def test_endian_and_idinv(reference, tmp_path):
    """Big-endian Fortran input with dimension inversion and nh > 1."""
    nx, ny, nz, nh = 6, 5, 4, 3
    data = np.random.default_rng(11).standard_normal((nx, ny, nz, nh))
    txt = ("&in_name = data.bin\n&out_name = data.wrb\n"
           "&header_name = data.wrh\n&file_type = 0\n"
           "&endian_conversion = 1\n&number_of_field = 1\n"
           f"%field = 0\n&input_data_type = 2\n&nx = {nx}\n&ny = {ny}\n"
           f"&nz = {nz}\n&nh = {nh}\n&order = 1\n&compress = 1\n"
           "&tolerance = 1e-5\n/\n")

    def make(d):
        make_fortran_file(d / "data.bin", [(data, 8)], mlen=4,
                          bigendian=True)
        (d / "inmeta").write_text(txt)
    r, p = dirs(tmp_path, make)
    reference("wrenc", [], r)
    port("wrenc", [], p)
    same_files(r, p, ENCODED)
    dargs = ["data.wrb", "data.wrh", "datarec.bin", 0, 1]
    reference("wrdec", dargs, r)
    port("wrdec", dargs, p)
    same_files(r, p, ["datarec.bin"])


def test_trivial_and_multifield_argv(reference, tmp_path):
    """A constant field (ntot_enc=0) among normal fields."""
    a = np.full((8, 8, 8), 7.5)
    b = smooth_field((8, 8, 8))
    r, p = dirs(tmp_path, lambda d: make_c_file(d / "data.bin",
                                                [(a, 8), (b, 8)]))
    _encode_decode(reference, r, p,
                   ["data.bin", "data.wrb", "data.wrh", 2, 0, 2, 2, 8, 8, 8,
                    "1e-6"],
                   ["data.wrb", "data.wrh", "datarec.bin", 2, 0])


@pytest.mark.parametrize("backend", ["torch", "exact64", "native"])
@pytest.mark.parametrize("coder", ["range", "rans"])
def test_backends_and_coders(tmp_path, backend, coder):
    """WR_BACKEND and WR_CODER: every backend of the port gives the JAX
    package's native files, in both entropy formats."""
    a = smooth_field((12, 10, 14))
    b = smooth_field((12, 10, 14)) * 3 + 1
    r, p = dirs(tmp_path, lambda d: make_c_file(d / "data.bin",
                                                [(a, 8), (b, 8)]))
    args = ["data.bin", "data.wrb", "data.wrh", 2, 0, 2, 2, 14, 10, 12,
            "1e-10"]
    dargs = ["data.wrb", "data.wrh", "datarec.bin", 2, 0]
    package("wrenc", args, r, coder=coder)
    port("wrenc", args, p, backend=backend, coder=coder)
    same_files(r, p, ENCODED)
    package("wrdec", dargs, r)
    port("wrdec", dargs, p, backend=backend)
    same_files(r, p, ["datarec.bin"])


@pytest.mark.parametrize("backend", ["torch", "exact64", "native"])
def test_encoder_matches_golden(tmp_path, backend):
    shutil.copy(GOLDEN / "data.bin", tmp_path / "data.bin")
    port("wrenc", ["data.bin", "data.wrb", "data.wrh", 2, 0, 1, 2, 16, 16,
                   16, "1e-16"], tmp_path, backend=backend)
    same_files(tmp_path, GOLDEN, ENCODED)


@pytest.mark.parametrize("backend", ["torch", "exact64", "native"])
def test_decoder_matches_golden(tmp_path, backend):
    for f in ENCODED:
        shutil.copy(GOLDEN / f, tmp_path / f)
    port("wrdec", ["data.wrb", "data.wrh", "datarec.bin", 2, 0], tmp_path,
         backend=backend)
    same_files(tmp_path, GOLDEN, ["datarec.bin"])
