"""The port's MSSG wrmssgenc/wrmssgdec (`waverange_tpu_torch.cli`, on the
CPU) against the reference: the cases of tests/test_mssg.py (GrADS
regular output with mask separation, backup united, backup divided), each
against the JAX package's CLI on its native backend and against the
reference binaries; byte compares of headers, encoded payloads and
reconstructed files."""
import numpy as np
import pytest

from waverange_tpu import native as wn
from waverange_tpu_torch import native as tn
from waverange_tpu_torch.io.mssg import read_control_file

from test_mssg import make_backup, make_regular
from torch_cli_helpers import dirs, package, port, same_files
from torch_cli_helpers import reference  # noqa: F401


def test_regular_with_mask(reference, tmp_path):
    r, p = dirs(tmp_path, make_regular)
    args = ["ocean", ".enc", 0, 1, 1, "1e-4", 0]
    reference("mssg_enc", args, r)
    port("mssg_enc", args, p)
    same_files(r, p, ["ocean_h.enc", "ocean_f.enc"])
    dargs = ["ocean", ".enc", "oceanrec", 0, 1, 1, 0]
    reference("mssg_dec", dargs, r)
    port("mssg_dec", dargs, p)
    same_files(r, p, ["oceanrec.grd", "oceanrec.ctl"])


def test_backup_united(reference, tmp_path):
    r, p = dirs(tmp_path, make_backup)
    args = ["rst", ".enc", 1, 2, 1, "1e-7", 0]
    reference("mssg_enc", args, r)
    port("mssg_enc", args, p)
    same_files(r, p, ["rst_h.enc", "rst_f.enc"])
    dargs = ["rst", ".enc", "rstrec", 1, 2, 1, 0]
    reference("mssg_dec", dargs, r)
    port("mssg_dec", dargs, p)
    same_files(r, p, [f"rstrec.p_{i:04d}" for i in range(4)])


def test_backup_divided(reference, tmp_path):
    r, p = dirs(tmp_path, make_backup)
    for procid in range(4):  # every PROCID in turn
        args = ["rst", ".enc", 2, 2, 1, "1e-7", procid]
        reference("mssg_enc", args, r)
        port("mssg_enc", args, p)
        same_files(r, p, [f"rst_h{procid:04d}.enc", f"rst_f{procid:04d}.enc"])
        dargs = ["rst", ".enc", "rstrec", 2, 2, 1, procid]
        reference("mssg_dec", dargs, r)
        port("mssg_dec", dargs, p)
        same_files(r, p, [f"rstrec.p_{procid:04d}"])


@pytest.mark.parametrize("backend", ["exact64", "native"])
@pytest.mark.parametrize("coder", ["range", "rans"])
def test_regular_with_mask_backends(tmp_path, backend, coder):
    """The mask field (wtflag=0 at 0.126) and the data fields on every
    backend and entropy format, against the JAX package's native files."""
    r, p = dirs(tmp_path, make_regular)
    args = ["ocean", ".enc", 0, 1, 1, "1e-9", 0]
    package("mssg_enc", args, r, coder=coder)
    port("mssg_enc", args, p, backend=backend, coder=coder)
    same_files(r, p, ["ocean_h.enc", "ocean_f.enc"])
    dargs = ["ocean", ".enc", "oceanrec", 0, 2, 1, 0]
    package("mssg_dec", dargs, r)
    port("mssg_dec", dargs, p, backend=backend)
    same_files(r, p, ["oceanrec.grd"])


def test_mask_separate_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 7, 9)) + 300.0
    a[rng.random(a.shape) < 0.3] = -9.99e33
    thresh = -9.99e33 + 9.99e33 * 1e-4
    b, c = a.copy(), a.copy()
    mask, pad = tn.mask_separate(b, thresh, a.min())
    want_mask, want_pad = wn.mask_separate(c, thresh, a.min())
    assert pad == want_pad
    assert mask.tobytes() == want_mask.tobytes()
    assert b.tobytes() == c.tobytes()
    with pytest.raises(ValueError, match="float64"):
        tn.mask_separate(a.astype(np.float32), thresh, a.min())


def test_yinyang_grid_arithmetic(tmp_path):
    """npg/i_over/j_over -> nx/ny per the hardcoded MSSG formulas."""
    (tmp_path / "g.nmlst").write_text(
        "&gridparam\n npg = 12, i_over = 2, j_over = 1, nr = 4,\n/\n"
        "&procparam\n nproc = 4, dim_size = 2,\n/\n"
        "&recparam\n var = 'time', rec = 1,\n var = 'u', rec = 2,\n/\n")
    nx, ny, nz, npx, npy, tab = read_control_file(str(tmp_path / "g.nmlst"))
    assert nx == 3 * 12 - 4 + 2 * 2   # nlg + 2*i_over
    assert ny == (12 + 2 * 1) * 2     # (npg + 2*j_over) * ngrids
    assert (nz, npx, npy) == (4, 2, 2)
    assert tab == ["time", "u"]
