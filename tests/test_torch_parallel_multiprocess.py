"""waverange_tpu_torch.parallel across real processes: gloo worlds of 1, 2,
3, 4 and 8 CPU processes (tests/torch_parallel_worker.py), one spawn a
world running every check, against one device and against the JAX
package's steps on meshes of the same size, computed here.

Byte-equal throughout: the ranks' records and decodes to one another, to
the native single-field codec and the port's single-device steps; the
distributed and united planes to the JAX package's, where its
distributed step is right: on an even mesh, or where it falls back to
the united step. On an odd mesh it moves the low-pass rows over
`ppermute` pairs that leave out rank D // 2's (ROADMAP §3), so the worlds
of 1 and 3 are held to the single-device codec alone, and the world of 3
shows the JAX planes differ. The decodes within 1e-13 relative of JAX's
distributed decode (tests/test_parallel.py:195)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from waverange_tpu.core import codec as JC
from waverange_tpu.parallel import mesh as JM
from waverange_tpu_torch import native as tn
from waverange_tpu_torch.ops import quant as TQ
from waverange_tpu_torch.parallel import mesh as PM

from conftest import smooth_field
from test_torch_codec import assert_same_stream

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"
TOL = 1e-6          # the worker's tolerance
SPAWN_TIMEOUT = 240
WORLDS = [1, 2, 3, 4, 8]
DIST = ("dist_a", "dist_deep", "dist_fallback")


def _inputs(size):
    """The worker's inputs. A world of 3 takes z extents divisible by 3,
    and distributed shapes whose every level divides over 3 ranks."""
    rng = np.random.default_rng(0)
    base = smooth_field((8, 12, 16))
    batch = np.stack([base * (1 + 0.1 * i)
                      + 0.01 * rng.standard_normal(base.shape)
                      for i in range(5)] + [np.full(base.shape, 2.5)])
    odd = size % 3 == 0
    shapes = dict(divided=(48 if odd else 32, 16, 16),
                  united=(24 if odd else 16, 12, 10),
                  dist_a=(48, 48, 16) if odd else (32, 16, 16),
                  dist_deep=(96, 48, 32) if odd else (64, 32, 32),
                  dist_fallback=(24 if odd else 16, 10, 14))
    inp = {k: smooth_field(v) for k, v in shapes.items()}
    inp["dist_a"] = inp["dist_a"] + 0.01 * rng.standard_normal(
        shapes["dist_a"])
    return dict(batch=batch, **inp)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"world{d}")
def world(request, tmp_path_factory):
    """Spawn a world of `size` processes once; their outputs by rank."""
    size = request.param
    workdir = tmp_path_factory.mktemp(f"world{size}")
    inp = _inputs(size)
    np.savez(workdir / "inputs.npz", **inp)
    tn.get_lib()  # build the host library once, before the workers load it
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(workdir), str(r), str(size)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(size)]
    try:
        res = [p.communicate(timeout=SPAWN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, res)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, err[-3000:]
    outs = [dict(np.load(workdir / f"out_{r}.npz")) for r in range(size)]
    return size, inp, outs


def _records(blob, n):
    data, recs = blob.tobytes(), []
    for _ in range(n):
        e = PM._unpack(data)
        recs.append(e)
        data = data[PM._HEAD + e.ntot_enc:]
    assert not data
    return recs


def _jax_steps(name, size, fld):
    """The JAX package's encode step of `fld` on a mesh of `size` (united
    for "united", distributed otherwise) and, for the distributed step,
    its decode."""
    mesh = JM.make_mesh(size)
    make = (JM.united_encode_step if name == "united"
            else JM.distributed_encode_step)
    slabs = jax.device_put(jnp.asarray(fld), NamedSharding(mesh, P("d")))
    planes, deps, minv, nlay, *_ = make(mesh, fld.shape)(slabs, TOL)
    nl = int(nlay)
    if name == "united":
        return np.asarray(planes[:nl]), None
    dec = JM.distributed_decode_step(mesh, fld.shape)(
        planes[:nl], deps[:nl], minv[:nl])
    return np.asarray(planes[:nl]), np.asarray(dec)


def test_ordered_gather(world):
    size, _, outs = world
    want = b"".join(bytes([i]) * (3 * i) for i in range(7))
    assert outs[0]["gather"].tobytes() == want
    assert int(outs[0]["gather_n"]) == 7
    for o in outs[1:]:
        assert int(o["gather_n"]) == 0


def test_sharded_streams_match_single(world):
    size, inp, outs = world
    batch = inp["batch"]
    recs = _records(outs[0]["sharded"], int(outs[0]["sharded_n"]))
    assert len(recs) == len(batch)
    for o in outs[1:]:
        assert o["sharded"].tobytes() == outs[0]["sharded"].tobytes()
    for i, e in enumerate(recs):
        assert_same_stream(e, JC.encode_field(batch[i], TOL,
                                              backend="native"))


def test_sharded_decode_matches_single(world):
    size, inp, outs = world
    recs = _records(outs[0]["sharded"], int(outs[0]["sharded_n"]))
    want = np.stack([JC.decode_field(e, backend="native") for e in recs])
    for o in outs:
        assert o["sharded_dec"].tobytes() == want.tobytes()


def test_bounded_residency(world):
    size, inp, outs = world
    B = len(inp["batch"])  # the last field is constant: no planes
    share = -(-B // size)
    for r, o in enumerate(outs):
        coded = r * share < B - 1
        for key in ("enc_peak", "dec_peak"):
            assert int(coded) <= int(o[key]) <= 2 + 2, (r, key)


def test_divided(world):
    size, inp, outs = world
    fld = inp["divided"]
    recs = _records(outs[0]["divided"], size)
    k = fld.shape[0] // size
    for r, e in enumerate(recs):
        assert_same_stream(e, JC.encode_field(fld[r * k:(r + 1) * k], TOL,
                                              backend="native"))
    want = np.concatenate([JC.decode_field(e, backend="native")
                           for e in recs])
    for o in outs:
        assert o["divided"].tobytes() == outs[0]["divided"].tobytes()
        assert o["divided_dec"].tobytes() == want.tobytes()


def test_united(world):
    size, inp, outs = world
    fld = inp["united"]
    planes, _, _, nlay, tolabs, *_ = TQ.encode_step(torch.from_numpy(fld),
                                                    TOL)
    want = planes[:int(nlay)].numpy()
    jplanes, _ = _jax_steps("united", size, fld)
    assert np.array_equal(jplanes, want)
    for o in outs:
        assert np.array_equal(o["united"], want)
        assert float(o["united_tolabs"]) == float(tolabs)


@pytest.mark.parametrize("name", DIST)
def test_distributed_encode(world, name):
    size, inp, outs = world
    fld = inp[name]
    planes, deps, minv, nlay, *_ = TQ.encode_step(torch.from_numpy(fld),
                                                  TOL)
    nl = int(nlay)
    got = np.concatenate([o[name] for o in outs], axis=1)
    assert np.array_equal(got, planes[:nl].numpy())
    for o in outs:
        assert np.array_equal(o[name + "_deps"], deps[:nl].numpy())
        assert np.array_equal(o[name + "_minv"], minv[:nl].numpy())
    if size > 1:
        jplanes, _ = _jax_steps(name, size, fld)
        jax_right = size % 2 == 0 or name == "dist_fallback"
        assert np.array_equal(jplanes, got) == jax_right


@pytest.mark.parametrize("name", DIST)
def test_distributed_decode(world, name):
    size, inp, outs = world
    fld = inp[name]
    planes, deps, minv, nlay, *_ = TQ.encode_step(torch.from_numpy(fld),
                                                  TOL)
    nl = int(nlay)
    want = TQ.decode_step(planes[:nl].contiguous(), deps[:nl], minv[:nl],
                          fld.shape).numpy()
    got = np.concatenate([o[name + "_dec"] for o in outs], axis=0)
    assert got.tobytes() == want.tobytes()
    assert np.abs(got - fld).max() <= 1.3 * TOL * np.abs(fld).max()
    if size % 2 == 0 or (size > 1 and name == "dist_fallback"):
        _, jdec = _jax_steps(name, size, fld)
        assert np.abs(got - jdec).max() <= \
            1e-13 * max(np.abs(jdec).max(), 1.0)
