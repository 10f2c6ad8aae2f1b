"""The port's FluSI/HDF5 interface (`waverange_tpu_torch.io.flusi` and its
CLIs, on the CPU) against the reference: the cases of tests/test_flusi.py
(structure, round trips, the 50-name backup table, the CLIs against the
JAX package's on its native backend and against the reference binaries)
and the vendored golden files of tests/test_golden_fixtures.py."""
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from waverange_tpu.core import codec as JC
from waverange_tpu.io import flusi as JF
from waverange_tpu_torch.core import codec as TC
from waverange_tpu_torch.io.flusi import (BACKUP_DATASETS, decode_flusi_file,
                                          encode_flusi_file)

from conftest import smooth_field
from test_flusi import _h5_equal, make_backup_input, make_regular_input
from torch_cli_helpers import port, reference  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"


def test_regular_roundtrip_and_structure(tmp_path):
    fld, name = make_regular_input(tmp_path / "in.h5")
    nz, ny, nx = fld.shape
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      0, 1e-7, verbose=False, device="cpu")
    ref = JC.encode_field(fld, 1e-7, backend="native")
    with h5py.File(tmp_path / "enc.h5", "r") as f:
        assert list(f.keys()) == [name]
        d = f[name]
        assert d.dtype == np.uint8 and d.ndim == 1
        for k, dt in [("coder_version", np.int32), ("tolabs", np.float64),
                      ("midval", np.float64), ("halfspanval", np.float64),
                      ("wlev", np.uint8), ("nlay", np.uint8),
                      ("ntot_enc", np.uint64)]:
            assert d.attrs[k].dtype == dt, (k, d.attrs[k].dtype)
        assert d.attrs["deps_vec"].shape == (int(d.attrs["nlay"][0]),)
        for k in ("time", "viscosity", "epsi", "domain_size", "nxyz"):
            assert k in d.attrs
        assert bytes(d[...].tobytes()) == ref.data
        assert float(d.attrs["tolabs"][0]) == ref.tolabs
    decode_flusi_file(str(tmp_path / "enc.h5"), str(tmp_path / "dec.h5"),
                      0, iouttype=2, verbose=False, device="cpu")
    with h5py.File(tmp_path / "dec.h5", "r") as f:
        rec = np.asarray(f[name])
        assert rec.dtype == np.float64 and rec.shape == (nz, ny, nx)
        assert np.array_equal(rec, JC.decode_field(ref, backend="native"))
        assert np.abs(rec - fld).max() <= 1.3e-7 * np.abs(fld).max()


def test_regular_float_output(tmp_path):
    _, name = make_regular_input(tmp_path / "in.h5", shape=(8, 8, 8))
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      0, 1e-5, verbose=False, device="cpu")
    decode_flusi_file(str(tmp_path / "enc.h5"), str(tmp_path / "dec.h5"),
                      0, iouttype=1, verbose=False, device="cpu")
    with h5py.File(tmp_path / "dec.h5", "r") as f:
        assert f[name].dtype == np.float32


@pytest.mark.parametrize("backend", ["torch", "exact64", "native"])
def test_backup_roundtrip(tmp_path, backend):
    fields = make_backup_input(tmp_path / "in.h5")
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      1, 1e-6, backend=backend, verbose=False, device="cpu")
    JF.encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "ref.h5"),
                         1, 1e-6, verbose=False)
    _h5_equal(tmp_path / "ref.h5", tmp_path / "enc.h5", list(fields))
    with h5py.File(tmp_path / "enc.h5", "r") as f:
        assert set(f.keys()) == set(fields)
        assert f["scalar1"].shape == (0,)  # the trivial dataset
        assert int(f["scalar1"].attrs["ntot_enc"][0]) == 0
        assert "deps_vec" not in f["scalar1"].attrs
    decode_flusi_file(str(tmp_path / "enc.h5"), str(tmp_path / "dec.h5"),
                      1, iouttype=2, backend=backend, verbose=False,
                      device="cpu")
    with h5py.File(tmp_path / "dec.h5", "r") as f:
        for n, fld in fields.items():
            rec = np.asarray(f[n])
            assert np.abs(rec - fld).max() <= 1.3e-6 * \
                max(np.abs(fld).max(), 1e-30)


def test_backup_local_cutoff(tmp_path):
    """uniform_cutoff=False: the native backend gives the reference's
    streams; the device backends refuse the local cutoffs."""
    names = ("ux", "uy", "uz")
    make_backup_input(tmp_path / "in.h5", shape=(32, 32, 48), names=names)
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"), 1,
                      1e-6, backend="native", uniform_cutoff=False,
                      verbose=False)
    JF.encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "ref.h5"),
                         1, 1e-6, uniform_cutoff=False, verbose=False)
    _h5_equal(tmp_path / "ref.h5", tmp_path / "enc.h5", list(names))
    with pytest.raises(ValueError, match="backend='native'"):
        encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "t.h5"), 1,
                          1e-6, uniform_cutoff=False, verbose=False,
                          device="cpu")


def test_backup_dataset_table():
    assert len(BACKUP_DATASETS) == 50
    assert BACKUP_DATASETS[0] == "ux"
    assert BACKUP_DATASETS[18] == "scalar1"
    assert BACKUP_DATASETS[-1] == "Z_avg"
    assert "scalar9_nlk1" in BACKUP_DATASETS


def test_regular_interop(reference, tmp_path):
    """Type 0: identical payloads and attributes, and each side decodes
    the other's file to the same field."""
    make_regular_input(tmp_path / "in.h5", shape=(20, 24, 16),
                       name="ux_00077")
    reference("flusi_enc", ["in.h5", "e_ref.h5", 0, "1e-6"], tmp_path)
    port("flusi_enc", ["in.h5", "e_our.h5", 0, "1e-6"], tmp_path)
    _h5_equal(tmp_path / "e_ref.h5", tmp_path / "e_our.h5", ["ux_00077"])
    reference("flusi_dec", ["e_our.h5", "d_ref.h5", 0, 2], tmp_path)
    port("flusi_dec", ["e_ref.h5", "d_our.h5", 0, 2], tmp_path)
    _h5_equal(tmp_path / "d_ref.h5", tmp_path / "d_our.h5", ["ux_00077"])


def test_backup_interop(reference, tmp_path):
    """Type 1: several datasets of the 50-name table with `bckp`, both
    directions, double and float reconstructions."""
    names = ["ux", "uy", "uz", "nlkx0", "Z_avg"]
    shape = (24, 20, 28)
    with h5py.File(tmp_path / "in.h5", "w") as f:
        for i, nm in enumerate(names):
            d = f.create_dataset(nm, data=smooth_field(shape) * (i + 1)
                                 + 0.1 * i)
            d.attrs.create("bckp", np.array(
                [0.5, 1e-3, 2e-3, 1.0, 7.0, shape[2], shape[1], shape[0]]),
                dtype=np.float64)
    reference("flusi_enc", ["in.h5", "e_ref.h5", 1, "3e-5"], tmp_path)
    port("flusi_enc", ["in.h5", "e_our.h5", 1, "3e-5"], tmp_path)
    _h5_equal(tmp_path / "e_ref.h5", tmp_path / "e_our.h5", names)
    reference("flusi_dec", ["e_our.h5", "d_ref.h5", 1, 2], tmp_path)
    port("flusi_dec", ["e_ref.h5", "d_our.h5", 1, 2], tmp_path)
    _h5_equal(tmp_path / "d_ref.h5", tmp_path / "d_our.h5", names)
    reference("flusi_dec", ["e_ref.h5", "df_ref.h5", 1, 1], tmp_path)
    port("flusi_dec", ["e_our.h5", "df_our.h5", 1, 1], tmp_path)
    _h5_equal(tmp_path / "df_ref.h5", tmp_path / "df_our.h5", names)
    with h5py.File(tmp_path / "df_our.h5") as f:
        assert f["ux"].dtype == np.float32


@pytest.mark.parametrize("backend", ["torch", "exact64", "native"])
def test_vendored_golden(tmp_path, backend):
    """The vendored reference-binary FluSI files: the port's decode of the
    encoded file is the vendored decode bit for bit, and its encode of the
    original field is the vendored encoded payload byte for byte."""
    decode_flusi_file(str(GOLDEN / "flusi_ux_golden.enc.h5"),
                      str(tmp_path / "dec.h5"), ifiletype=0, iouttype=2,
                      backend=backend, verbose=False, device="cpu")
    with h5py.File(tmp_path / "dec.h5") as fo, \
            h5py.File(GOLDEN / "flusi_ux_golden.dec.h5") as fr:
        assert np.array_equal(fo["ux_00042"][...].view(np.uint64),
                              fr["ux_00042"][...].view(np.uint64))
    encode_flusi_file(str(GOLDEN / "flusi_ux_golden.h5"),
                      str(tmp_path / "enc.h5"), ifiletype=0, tol_base=1e-5,
                      backend=backend, verbose=False, device="cpu")
    with h5py.File(tmp_path / "enc.h5") as fa, \
            h5py.File(GOLDEN / "flusi_ux_golden.enc.h5") as fb:
        assert np.array_equal(fa["ux_00042"][...], fb["ux_00042"][...])


def test_regular_field_encodes_as_the_codec(tmp_path):
    # the io layer adds nothing to the codec's stream
    fld, name = make_regular_input(tmp_path / "in.h5", shape=(8, 12, 16))
    encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "enc.h5"),
                      0, 1e-9, coder="rans", verbose=False, device="cpu")
    e = TC.encode_field(fld, 1e-9, coder="rans", device="cpu")
    with h5py.File(tmp_path / "enc.h5") as f:
        assert bytes(f[name][...].tobytes()) == e.data
        assert int(f[name].attrs["coder_version"][0]) == e.coder_version


def test_backup_batched_path(tmp_path, monkeypatch):
    """A backup file of equal-shaped datasets on backend="torch" (the
    CLI with WR_DEVICE=cpu) goes through `encode_fields_sharded`, one
    call per group of equal shapes, and every dataset's bytes are those
    of the JAX package's batched jax backend and of the port's
    field-by-field encode."""
    import waverange_tpu_torch.io.flusi as TF
    fields = make_backup_input(tmp_path / "in.h5",
                               names=("ux", "uy", "uz", "scalar1"))
    with h5py.File(tmp_path / "in.h5", "a") as f:  # a lone shape
        d = f.create_dataset("Z_avg", data=smooth_field((6, 10, 12)))
        d.attrs.create("bckp", np.array([1.5, 1e-3, 1e-3, 2.0, 100.0,
                                         12, 10, 6], np.float64))
        fields["Z_avg"] = np.asarray(d)
    calls = []
    real = TF.encode_fields_sharded

    def counted(batch, *a, **kw):
        calls.append(batch.shape)
        return real(batch, *a, **kw)

    monkeypatch.setattr(TF, "encode_fields_sharded", counted)
    port("flusi_enc", ["in.h5", "enc.h5", 1, "1e-6"], tmp_path)
    assert calls == [(4, 8, 10, 12)]
    JF.encode_flusi_file(str(tmp_path / "in.h5"), str(tmp_path / "jax.h5"),
                         1, 1e-6, backend="jax", verbose=False)
    with h5py.File(tmp_path / "enc.h5") as fo, \
            h5py.File(tmp_path / "jax.h5") as fj:
        assert sorted(fo.keys()) == sorted(fields)
        for nm, fld in fields.items():
            got = fo[nm][...].tobytes()
            assert got == fj[nm][...].tobytes(), nm
            assert got == TC.encode_field(fld, 1e-6, device="cpu").data, nm
            # the trivial dataset's record follows native (ROADMAP §3)
            e = JC.encode_field(fld, 1e-6, backend="native")
            assert int(fo[nm].attrs["wlev"][0]) == e.wlev, nm
