"""FluSI/HDF5 interface.

Compatible with the reference's flusi wrenc/wrdec (src/flusi/):
  * type 0 "regular output": single 3-D dataset (name discovered by
    visiting the file), attributes time/viscosity/epsi/domain_size/nxyz
    propagated (main_enc.cpp:237-304);
  * type 1 "backup": fixed table of 50 dataset names, shape from the
    8-double `bckp` attribute, only existing datasets processed
    (main_enc.cpp:313-527);
  * encoded layout: per dataset a 1-D H5T_NATIVE_UCHAR array of the
    payload plus codec attributes coder_version/tolabs/midval/
    halfspanval/wlev/nlay/ntot_enc and, when non-trivial,
    deps_vec/minval_vec/len_enc_vec (hdf5_interfaces.cpp:283-441);
  * decode writes float or double (nz, ny, nx) datasets per the user's
    PRECISION choice (main_dec.cpp:111-115).

A copy of `waverange_tpu.io.flusi` that calls this package's codec
(`backend`, `device` as in `io.generic`). h5py is imported at first use.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List

import numpy as np

from ..core.codec import CODER_VERSION, NLAYMAX, EncodedField, \
    encode_field, decode_field
from ..parallel import encode_fields_sharded
from .generic import _env_conformance

# The 50 dataset names of a FluSI restart file (main_enc.cpp:319-330).
BACKUP_DATASETS: List[str] = (
    ["ux", "uy", "uz", "nlkx0", "nlky0", "nlkz0", "nlkx1", "nlky1",
     "nlkz1", "bx", "by", "bz", "bnlkx0", "bnlky0", "bnlkz0", "bnlkx1",
     "bnlky1", "bnlkz1"]
    + [f"scalar{i}{suf}" for i in range(1, 10)
       for suf in ("", "_nlk0", "_nlk1")]
    + ["uavgx", "uavgy", "uavgz", "ekinavg", "Z_avg"])

DS_BLOCK = 16            # downscaling block for non-uniform cutoff
LOCAL_CUTOFF_FACTOR = 16.0
LOCAL_CUTOFF_THRESH = 1.0 / 128.0


def _h5py():
    import h5py
    return h5py


def find_dataset(h5file) -> str:
    """First dataset name in the file (H5Ovisit order equivalent)."""
    names = []

    def visit(name, obj):
        import h5py
        if isinstance(obj, h5py.Dataset) and not names:
            names.append(name)

    h5file.visititems(visit)
    if not names:
        raise ValueError("no dataset found in HDF5 file")
    return names[0]


def _write_enc_attrs(dset, enc: EncodedField) -> None:
    dset.attrs.create("coder_version",
                      np.array([enc.coder_version], np.int32))
    dset.attrs.create("tolabs", np.array([enc.tolabs], np.float64))
    dset.attrs.create("midval", np.array([enc.midval], np.float64))
    dset.attrs.create("halfspanval",
                      np.array([enc.halfspanval], np.float64))
    dset.attrs.create("wlev", np.array([enc.wlev], np.uint8))
    dset.attrs.create("nlay", np.array([enc.nlay], np.uint8))
    dset.attrs.create("ntot_enc", np.array([enc.ntot_enc], np.uint64))
    if enc.ntot_enc > 0:
        nl = enc.nlay
        dset.attrs.create("deps_vec", enc.deps_vec[:nl].astype(np.float64))
        dset.attrs.create("minval_vec",
                          enc.minval_vec[:nl].astype(np.float64))
        dset.attrs.create("len_enc_vec",
                          enc.len_enc_vec[:nl].astype(np.uint64))


def _read_enc_attrs(dset, nx: int, ny: int, nz: int) -> EncodedField:
    a = dset.attrs
    nlay = int(np.ravel(a["nlay"])[0])
    ntot_enc = int(np.ravel(a["ntot_enc"])[0])
    deps = np.zeros(NLAYMAX)
    minv = np.zeros(NLAYMAX)
    lens = np.zeros(NLAYMAX, np.uint64)
    if ntot_enc > 0:
        deps[:nlay] = np.ravel(a["deps_vec"])[:nlay]
        minv[:nlay] = np.ravel(a["minval_vec"])[:nlay]
        lens[:nlay] = np.ravel(a["len_enc_vec"])[:nlay]
    return EncodedField(
        nx=nx, ny=ny, nz=nz,
        tolabs=float(np.ravel(a["tolabs"])[0]),
        midval=float(np.ravel(a["midval"])[0]),
        halfspanval=float(np.ravel(a["halfspanval"])[0]),
        wlev=int(np.ravel(a["wlev"])[0]), nlay=nlay, ntot_enc=ntot_enc,
        deps_vec=deps, minval_vec=minv, len_enc_vec=lens,
        coder_version=int(np.ravel(a["coder_version"])[0])
        if "coder_version" in a else CODER_VERSION)


def compute_local_cutoff(h5file, tol_base: float):
    """Non-uniform cutoff from block-averaged scaled vorticity
    (main_enc.cpp:344-449; live only when the reference is built with
    UNIFORM_CUTOFF=0). Blocks whose scaled vorticity magnitude is below
    1/128 of the maximum get a 16x coarser tolerance.

    Note: the reference's finite differences contain a C precedence slip
    (`mx*my*(kz+1)%mz` applies % to the whole product); here the periodic
    neighbor indexing is done as intended.
    """
    u = [np.asarray(h5file[name], np.float64)
         for name in ("ux", "uy", "uz")]
    nz, ny, nx = u[0].shape
    mx, my, mz = nx // DS_BLOCK, ny // DS_BLOCK, nz // DS_BLOCK
    um = [a.reshape(mz, DS_BLOCK, my, DS_BLOCK, mx, DS_BLOCK)
          .mean(axis=(1, 3, 5)) for a in u]  # (mz, my, mx)

    def ddx(a):
        return np.roll(a, -1, 2) - np.roll(a, 1, 2)

    def ddy(a):
        return np.roll(a, -1, 1) - np.roll(a, 1, 1)

    def ddz(a):
        return np.roll(a, -1, 0) - np.roll(a, 1, 0)

    wx = ddy(um[2]) - ddz(um[1])
    wy = ddz(um[0]) - ddx(um[2])
    wz = ddx(um[1]) - ddy(um[0])
    wabs = np.sqrt(wx * wx + wy * wy + wz * wz)
    cutoff = np.where(wabs > LOCAL_CUTOFF_THRESH * wabs.max(), tol_base,
                      tol_base * LOCAL_CUTOFF_FACTOR)
    # codec expects cutoffvec[kx + mx*ky + mx*my*kz]
    return mx, my, mz, np.ascontiguousarray(cutoff).ravel()


def encode_flusi_file(in_name: str, out_name: str, ifiletype: int,
                      tol_base: float, backend: str = "torch",
                      coder: str = "range",
                      uniform_cutoff: bool = True,
                      verbose: bool = True, device="cuda") -> None:
    h5py = _h5py()
    with h5py.File(out_name, "w"):
        pass
    if ifiletype == 0:
        with h5py.File(in_name, "r") as fin:
            dsetname = find_dataset(fin)
            d = fin[dsetname]
            attrs = {k: np.array(d.attrs[k]) for k in
                     ("time", "viscosity", "epsi", "domain_size", "nxyz")
                     if k in d.attrs}
            nxyz = np.ravel(attrs["nxyz"])
            nx, ny, nz = int(nxyz[0]), int(nxyz[1]), int(nxyz[2])
            fld = np.ascontiguousarray(d[...], dtype=np.float64)
        if verbose:
            print(f" dset={dsetname} nx={nx} ny={ny} nz={nz}")
        enc = encode_field(fld.reshape(nz, ny, nx), tol_base, wtflag=1,
                           coder=coder, backend=backend,
                           conformance=_env_conformance(), device=device)
        with h5py.File(out_name, "a") as fout:
            payload = np.frombuffer(enc.data, np.uint8)
            dset = fout.create_dataset(dsetname, data=payload,
                                       dtype=np.uint8)
            for k, v in attrs.items():
                dset.attrs.create(k, v)
            _write_enc_attrs(dset, enc)
    elif ifiletype == 1:
        with h5py.File(in_name, "r") as fin:
            present = [n for n in BACKUP_DATASETS if n in fin]
            cut = None
            if not uniform_cutoff:
                cut = compute_local_cutoff(fin, tol_base)
            fields = {}
            for name in present:
                d = fin[name]
                bckp = np.ravel(np.array(d.attrs["bckp"]))
                nx, ny, nz = int(bckp[5]), int(bckp[6]), int(bckp[7])
                fields[name] = (np.ascontiguousarray(
                    d[...], np.float64).reshape(nz, ny, nx), bckp)
        # Block-parallel over fields (BASELINE config[2]): on the torch
        # backend, each group of equal-shaped datasets encodes through the
        # sharded encoder (the device step per field, the host range coder
        # on a bounded thread pool), as the reference's jax backend does
        # (flusi.py:188-205); the bytes are the field-by-field ones.
        encs = {}
        if backend == "torch" and cut is None and len(present) > 1 \
                and coder == "range":
            groups = defaultdict(list)
            for name in present:
                groups[fields[name][0].shape].append(name)
            for names in groups.values():
                if len(names) == 1:
                    continue
                batch = np.stack([fields[nm][0] for nm in names])
                for nm, e in zip(names, encode_fields_sharded(
                        batch, tol_base, device=device)):
                    encs[nm] = e
        with h5py.File(out_name, "a") as fout:
            for name in present:
                fld, bckp = fields[name]
                nz, ny, nx = fld.shape
                if verbose:
                    print(f" dset={name} nx={nx} ny={ny} nz={nz}")
                if name in encs:
                    enc = encs[name]
                elif cut is None:
                    enc = encode_field(fld, tol_base, wtflag=1,
                                       backend=backend, coder=coder,
                                       conformance=_env_conformance(),
                                       device=device)
                else:
                    mx, my, mz, cutoffvec = cut
                    enc = encode_field(fld, tol_base, wtflag=1,
                                       cutoff=cutoffvec, mx=mx, my=my,
                                       mz=mz, backend=backend,
                                       coder=coder,
                                       conformance=_env_conformance(),
                                       device=device)
                if enc.ntot_enc > 0:
                    dset = fout.create_dataset(
                        name, data=np.frombuffer(enc.data, np.uint8),
                        dtype=np.uint8)
                else:
                    dset = fout.create_dataset(name, shape=(0,),
                                               dtype=np.uint8)
                dset.attrs.create("bckp", bckp.astype(np.float64))
                _write_enc_attrs(dset, enc)
    else:
        raise ValueError("unknown file type")


def decode_flusi_file(in_name: str, out_name: str, ifiletype: int,
                      iouttype: int = 2, backend: str = "torch",
                      verbose: bool = True, device="cuda") -> None:
    h5py = _h5py()
    out_dtype = np.float32 if iouttype == 1 else np.float64
    with h5py.File(out_name, "w"):
        pass
    if ifiletype == 0:
        with h5py.File(in_name, "r") as fin:
            dsetname = find_dataset(fin)
            d = fin[dsetname]
            attrs = {k: np.array(d.attrs[k]) for k in
                     ("time", "viscosity", "epsi", "domain_size", "nxyz")
                     if k in d.attrs}
            nxyz = np.ravel(attrs["nxyz"])
            nx, ny, nz = int(nxyz[0]), int(nxyz[1]), int(nxyz[2])
            enc = _read_enc_attrs(d, nx, ny, nz)
            if enc.ntot_enc:
                enc.data = np.asarray(d[...], np.uint8).tobytes()
        fld = decode_field(enc, backend=backend, device=device)
        with h5py.File(out_name, "a") as fout:
            dset = fout.create_dataset(dsetname, data=fld.astype(out_dtype))
            for k, v in attrs.items():
                dset.attrs.create(k, v)
    elif ifiletype == 1:
        with h5py.File(in_name, "r") as fin:
            present = [n for n in BACKUP_DATASETS if n in fin]
            encs = {}
            for name in present:
                d = fin[name]
                bckp = np.ravel(np.array(d.attrs["bckp"]))
                nx, ny, nz = int(bckp[5]), int(bckp[6]), int(bckp[7])
                enc = _read_enc_attrs(d, nx, ny, nz)
                if enc.ntot_enc:
                    enc.data = np.asarray(d[...], np.uint8).tobytes()
                encs[name] = (enc, bckp)
        with h5py.File(out_name, "a") as fout:
            for name in present:
                enc, bckp = encs[name]
                if verbose:
                    print(f" dset={name} nx={enc.nx} ny={enc.ny} "
                          f"nz={enc.nz}")
                fld = decode_field(enc, backend=backend, device=device)
                dset = fout.create_dataset(name,
                                           data=fld.astype(out_dtype))
                dset.attrs.create("bckp", bckp.astype(np.float64))
    else:
        raise ValueError("unknown file type")
