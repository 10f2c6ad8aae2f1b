"""waverange_tpu_torch.parallel in one process (a world of one, `group=None`,
on the CPU) against waverange_tpu.parallel on the 8 virtual CPU devices of
conftest, case for case as tests/test_parallel.py runs the JAX package.

Tolerances: streams byte-equal to native and to the JAX package on these
smooth fields; decodes bitwise equal to the native decoder and to the
port's single-device `decode_step`; against JAX's distributed decode
within 1e-13 relative (tests/test_parallel.py:195). Worlds of 2-8 gloo
processes: tests/test_torch_parallel_multiprocess.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from waverange_tpu import native as wn
from waverange_tpu.core import codec as JC
from waverange_tpu.parallel import mesh as JM
from waverange_tpu_torch.core import codec as TC
from waverange_tpu_torch.ops import quant as TQ
from waverange_tpu_torch.parallel import distributed as PD
from waverange_tpu_torch.parallel import mesh as PM

from conftest import smooth_field
from test_torch_codec import assert_same_stream


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"
    return JM.make_mesh()


def _batch(B, shape, seed=0):
    rng = np.random.default_rng(seed)
    base = smooth_field(shape)
    return np.stack([base * (1 + 0.1 * i)
                     + 0.01 * rng.standard_normal(shape)
                     for i in range(B)])


def _jax_step(make, mesh, fld, tol):
    step = make(mesh, fld.shape)
    slabs = jax.device_put(jnp.asarray(fld), NamedSharding(mesh, P("d")))
    planes, deps, minv, nlay, tolabs, *_ = step(slabs, tol)
    nl = int(nlay)
    return np.asarray(planes[:nl]), deps, minv, nl, float(tolabs)


def _single(fld, tol):
    planes, deps, minv, nlay, tolabs, *_ = TQ.encode_step(
        torch.from_numpy(fld), tol)
    nl = int(nlay)
    return planes[:nl], deps[:nl], minv[:nl], nl, float(tolabs)


def test_sharded_encode_matches_single(mesh):
    fields = _batch(8, (16, 16, 16))
    encs = PM.encode_fields_sharded(fields, 1e-6, device="cpu")
    jencs = JM.encode_fields_sharded(fields, 1e-6, mesh=mesh)
    assert len(encs) == 8
    for i, e in enumerate(encs):
        assert_same_stream(e, JC.encode_field(fields[i], 1e-6,
                                              backend="native"))
        j = jencs[i]
        assert (e.data, e.nlay, e.tolabs) == (j.data, j.nlay, j.tolabs)
    dec = PM.decode_fields_sharded(encs, device="cpu")
    for i in range(8):
        assert dec[i].tobytes() == JC.decode_field(
            encs[i], backend="native").tobytes()
        err = np.abs(dec[i] - fields[i]).max()
        assert err <= 1.3e-6 * np.abs(fields[i]).max()


def test_sharded_encode_bounded_residency():
    """The host never holds more than threads+2 symbol planes at once
    (native slot-pool rule, wr_native.cc encode loop)."""
    fields = _batch(8, (16, 16, 16), seed=7)
    encs = PM.encode_fields_sharded(fields, 1e-6, backend_threads=2,
                                    device="cpu")
    assert 1 <= PM._last_peak_resident <= 2 + 2, PM._last_peak_resident
    single = TC.encode_field(fields[3], 1e-6, device="cpu")
    assert encs[3].data == single.data


def test_sharded_decode_bounded_residency():
    fields = _batch(8, (16, 16, 16), seed=11)
    encs = PM.encode_fields_sharded(fields, 1e-6, device="cpu")
    dec = PM.decode_fields_sharded(encs, backend_threads=2, device="cpu")
    assert 1 <= PM._last_peak_resident_decode <= 2 + 2, \
        PM._last_peak_resident_decode
    for i in range(8):
        assert dec[i].tobytes() == TC.decode_field(
            encs[i], device="cpu").tobytes()
        err = np.abs(dec[i] - fields[i]).max()
        assert err <= 1.3e-6 * np.abs(fields[i]).max()


def test_sharded_uneven_batch(mesh):
    fields = _batch(5, (8, 8, 8), seed=3)
    encs = PM.encode_fields_sharded(fields, 1e-5, device="cpu")
    jencs = JM.encode_fields_sharded(fields, 1e-5, mesh=mesh)
    assert len(encs) == 5
    assert [e.data for e in encs] == [j.data for j in jencs]
    dec = PM.decode_fields_sharded(encs, device="cpu")
    assert dec.shape == (5, 8, 8, 8)
    jdec = JM.decode_fields_sharded(jencs, mesh=mesh)
    for i in range(5):
        assert np.abs(dec[i] - fields[i]).max() <= 1.3e-5 * \
            np.abs(fields[i]).max()
        assert np.abs(dec[i] - jdec[i]).max() <= \
            1e-13 * np.abs(fields[i]).max()


def test_divided_roundtrip(mesh):
    fld = smooth_field((32, 16, 16))
    encs = PM.encode_field_divided(fld, 1e-6, n_blocks=8, device="cpu")
    jencs = JM.encode_field_divided(fld, 1e-6, n_blocks=8, mesh=mesh)
    assert len(encs) == 8
    for k, e in enumerate(encs):
        assert_same_stream(e, JC.encode_field(fld[4 * k:4 * k + 4], 1e-6,
                                              backend="native"))
        assert e.data == jencs[k].data
    rec = PM.decode_field_divided(encs, device="cpu")
    assert rec.shape == fld.shape
    want = np.concatenate([JC.decode_field(e, backend="native")
                           for e in encs])
    assert rec.tobytes() == want.tobytes()
    assert np.abs(rec - fld).max() <= 1.3e-6 * np.abs(fld).max()


def test_united_collectives(mesh):
    shape = (16, 12, 10)
    fld = smooth_field(shape)
    planes, deps, minv, nlay, tolabs, midval, halfspan, trivial = (
        PM.united_encode_step(None, shape)(torch.from_numpy(fld), 1e-6))
    nlay = int(nlay)
    assert not bool(trivial)
    single = JC.encode_field(fld, 1e-6, backend="native")
    assert nlay == single.nlay
    assert float(tolabs) == single.tolabs
    payload, lens = wn.encode_planes_batch(planes[:nlay].numpy())
    assert payload == single.data
    jplanes, *_ = _jax_step(JM.united_encode_step, mesh, fld, 1e-6)
    assert np.array_equal(planes[:nlay].numpy(), jplanes)


def test_gather_streams_ordered_single_process():
    streams = [b"ccc", b"a", b"bb"]
    ids = [2, 0, 1]
    assert PD.gather_streams_ordered(streams, ids) == [b"a", b"bb", b"ccc"]


@pytest.mark.parametrize("shape,tol", [((32, 16, 16), 1e-6),
                                       ((64, 32, 32), 1e-7)])
def test_distributed_united_matches_single(mesh, shape, tol):
    """distributed_encode_step reproduces the single-device encode step's
    symbol planes (and, at a world of one, its every output)."""
    fld = smooth_field(shape) + 0.01 * np.random.default_rng(5) \
        .standard_normal(shape)
    out = PM.distributed_encode_step(None, shape)(torch.from_numpy(fld), tol)
    planes, deps, minv, nl, tolabs = _single(fld, tol)
    assert int(out[3]) == nl
    assert float(out[4]) == tolabs
    assert torch.equal(out[0][:nl], planes)
    assert torch.equal(out[1][:nl], deps) and torch.equal(out[2][:nl], minv)
    jplanes, *_ = _jax_step(JM.distributed_encode_step, mesh, fld, tol)
    assert np.array_equal(out[0][:nl].numpy(), jplanes)
    payload, _ = wn.encode_planes_batch(out[0][:nl].numpy())
    assert payload == JC.encode_field(fld, tol, backend="native").data


def test_distributed_united_fallback(mesh):
    """Non-divisible shapes fall back to the gather-based united step."""
    shape = (16, 10, 14)
    fld = smooth_field(shape)
    out = PM.distributed_encode_step(None, shape)(torch.from_numpy(fld),
                                                  1e-5)
    planes, deps, minv, nl, tolabs = _single(fld, 1e-5)
    assert int(out[3]) == nl >= 1
    assert torch.equal(out[0][:nl], planes)
    jplanes, *_ = _jax_step(JM.distributed_encode_step, mesh, fld, 1e-5)
    assert np.array_equal(out[0][:nl].numpy(), jplanes)
    rec = PM.distributed_decode_step(None, shape)(
        out[0][:nl].contiguous(), out[1][:nl], out[2][:nl])
    assert torch.equal(rec, TQ.decode_step(planes.contiguous(), deps, minv,
                                           shape))


def test_distributed_decode_matches_single(mesh):
    shape = (32, 16, 16)
    fld = smooth_field(shape)
    planes, deps, minv, nl, _ = _single(fld, 1e-6)
    rec = PM.distributed_decode_step(None, shape)(planes.contiguous(), deps,
                                                  minv)
    ref = TQ.decode_step(planes.contiguous(), deps, minv, shape)
    assert torch.equal(rec, ref)
    jstep = JM.distributed_decode_step(mesh, shape)
    jrec = np.asarray(jstep(jnp.asarray(planes.numpy()),
                            jnp.asarray(deps.numpy()),
                            jnp.asarray(minv.numpy())))
    assert np.abs(rec.numpy() - jrec).max() <= \
        1e-13 * max(np.abs(jrec).max(), 1.0)
    assert np.abs(rec.numpy() - fld).max() <= 1.3e-6 * np.abs(fld).max()


def test_distributed_deep_recursion(mesh):
    """(64,32,32): at a world of one every level runs the distributed
    recursion (no replicated fallback), encode and decode."""
    shape = (64, 32, 32)
    fld = smooth_field(shape)
    out = PM.distributed_encode_step(None, shape)(torch.from_numpy(fld),
                                                  1e-7)
    nl = int(out[3])
    single = JC.encode_field(fld, 1e-7, backend="native")
    assert nl == single.nlay
    payload, lens = wn.encode_planes_batch(out[0][:nl].numpy())
    assert payload == single.data
    rec = PM.distributed_decode_step(None, shape)(
        out[0][:nl].contiguous(), out[1][:nl], out[2][:nl])
    assert rec.numpy().tobytes() == JC.decode_field(
        single, backend="native").tobytes()
    assert np.abs(rec.numpy() - fld).max() <= 1.3e-7 * np.abs(fld).max()


def test_sharded_decode_mixed_wlev_mask_fields():
    """wtflag=0 (mask-style) fields mixed with wavelet fields and a trivial
    one through the sharded decode: every field bit-identical to the
    native single-field decoder (kernel D's plain version with levels=0
    for the masks; no host re-accumulate is needed)."""
    rng = np.random.default_rng(2)
    shape = (8, 12, 16)
    mask = (rng.random(shape) < 0.3).astype(np.float64) * -9.99e33
    smooth = [smooth_field(shape) * (1 + k) for k in range(3)]
    encs = [JC.encode_field(mask, 0.126, wtflag=0, backend="native")]
    encs += [JC.encode_field(s, 1e-7, wtflag=1, backend="native")
             for s in smooth]
    encs.append(JC.encode_field(np.full(shape, 2.5), 1e-7, wtflag=1,
                                backend="native"))
    out = PM.decode_fields_sharded(encs, device="cpu")
    for b, e in enumerate(encs):
        ref = JC.decode_field(e, backend="native")
        assert out[b].tobytes() == ref.tobytes(), f"field {b} " \
            f"(wlev={e.wlev})"


def test_jax_distributed_step_wrong_on_one_device():
    """The JAX package's distributed step on a one-device mesh sends the
    low-pass rows over empty ppermutes, so deeper levels transform zeros
    (waverange_tpu/parallel/mesh.py:593-617): its planes differ from the
    single-device codec. The port's step on a world of one keeps them
    local and is byte-equal (ROADMAP §3)."""
    shape = (32, 16, 16)
    fld = smooth_field(shape)
    single = JC.encode_field(fld, 1e-6, backend="jax")
    jplanes, _, _, jnl, _ = _jax_step(JM.distributed_encode_step,
                                      JM.make_mesh(1), fld, 1e-6)
    jpayload = wn.encode_planes_batch(jplanes)[0]
    assert (jnl, jpayload) != (single.nlay, single.data)
    out = PM.distributed_encode_step(None, shape)(torch.from_numpy(fld),
                                                  1e-6)
    nl = int(out[3])
    assert nl == single.nlay
    assert wn.encode_planes_batch(out[0][:nl].numpy())[0] == single.data


def test_trivial_field_wlev_follows_native(mesh):
    """A constant field in the batch: the port's record is native's (wlev
    4); the JAX sharded path writes wlev 0 (mesh.py:112-116, ROADMAP
    §3). The decode is the same."""
    fields = np.stack([smooth_field((8, 8, 8)), np.full((8, 8, 8), 2.5)])
    encs = PM.encode_fields_sharded(fields, 1e-6, device="cpu")
    native = JC.encode_field(fields[1], 1e-6, backend="native")
    assert_same_stream(encs[1], native)
    assert encs[1].wlev == 4
    assert JM.encode_fields_sharded(fields, 1e-6, mesh=mesh)[1].wlev == 0
    assert np.array_equal(PM.decode_fields_sharded(encs, device="cpu")[1],
                          fields[1])


def test_world_of_one_on_gloo(tmp_path):
    """The same steps through real collectives: a gloo world of one made
    in this process, byte-equal to the single-device path."""
    PD.init_distributed(init_method=f"file://{tmp_path}/store",
                        world_size=1, rank=0, device="cpu")
    try:
        group = PM.make_group()
        assert group is not None and PD.World(group).size == 1
        shape = (32, 16, 16)
        fld = smooth_field(shape)
        out = PM.distributed_encode_step(group, shape)(
            torch.from_numpy(fld), 1e-7)
        planes, deps, minv, nl, _ = _single(fld, 1e-7)
        assert int(out[3]) == nl and torch.equal(out[0][:nl], planes)
        rec = PM.distributed_decode_step(group, shape)(
            out[0][:nl].contiguous(), out[1][:nl], out[2][:nl])
        assert torch.equal(rec, TQ.decode_step(planes.contiguous(), deps,
                                               minv, shape))
        u = PM.united_encode_step(group, shape)(torch.from_numpy(fld), 1e-7)
        assert torch.equal(u[0][:nl], planes)
        encs = PM.encode_field_divided(fld, 1e-7, n_blocks=2, group=group,
                                       device="cpu")
        for k, e in enumerate(encs):
            assert_same_stream(e, JC.encode_field(fld[16 * k:16 * k + 16],
                                                  1e-7, backend="native"))
        # the backend carries the caller's device only
        with pytest.raises(ValueError, match="does not carry"):
            PD.World(group).check_device(torch.device("cuda"))
    finally:
        torch.distributed.destroy_process_group()


def test_no_group_is_a_world_of_one():
    assert PM.make_group() is None and PM.make_group(1) is None
    with pytest.raises(ValueError, match="initialized process group"):
        PM.make_group(2)
    assert PD.World().share(5) == (0, 5)
    PD.init_distributed(device="cpu")  # no world given: nothing to do
    assert not torch.distributed.is_initialized()


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.encode_fields_sharded(_batch(2, (8, 8, 8)), 1e-6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.decode_fields_sharded([TC.encode_field(
            smooth_field((8, 8, 8)), 1e-6, device="cpu")])


def test_record_exchange_format():
    """A record survives the bytes that carry it between ranks."""
    fields = np.stack([smooth_field((8, 8, 8)), np.full((8, 8, 8), 2.5)])
    for e in PM.encode_fields_sharded(fields, 1e-7, device="cpu"):
        assert_same_stream(PM._unpack(PM._pack(e)), e)


@pytest.mark.parametrize("size,count,want", [
    (1, 5, [(0, 5)]),
    (2, 5, [(0, 3), (3, 5)]),
    (8, 5, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 5), (5, 5),
            (5, 5)]),
    (3, 8, [(0, 3), (3, 6), (6, 8)])])
def test_share_blocks_as_the_mesh_does(size, count, want):
    w = PD.World()
    w.size = size
    assert [w.share(count, r) for r in range(size)] == want
