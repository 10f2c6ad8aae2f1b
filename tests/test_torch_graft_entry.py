"""waverange_tpu_torch.graft_entry on the CPU: `entry()` against the JAX
package's `__graft_entry__.entry()` (x64, as tests/conftest.py sets it) and
the native codec, and `dryrun_multichip(n)` in spawned gloo worlds of 1, 2
and 4 processes against the JAX codec's layer counts."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waverange_tpu.core import codec as JC
from waverange_tpu_torch import graft_entry as GE
from waverange_tpu_torch import native as tn

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import __graft_entry__ as JE  # noqa: E402


def test_entry_matches_jax_entry_and_native():
    jfwd, jargs = JE.entry()
    j = jfwd(*jargs)
    fwd, args = GE.entry(device="cpu")
    assert args[0].shape == (64, 64, 64) and args[0].dtype == torch.float64
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    p = fwd(*args)
    nl = int(j[3])
    assert int(p[3]) == nl >= 1
    assert np.array_equal(p[0][:nl].numpy(), np.asarray(j[0][:nl]))
    # XLA may contract the residual update into an FMA: deps within the
    # rtol of tests/test_torch_quant.py:34-46, minv within the 4 ulp of
    # max|w| of tests/test_torch_quant.py:91-112, in f64
    np.testing.assert_allclose(p[1][:nl].numpy(), np.asarray(j[1][:nl]),
                               rtol=1e-12)
    w = tn.wavelet3d(args[0].numpy().copy(), 4)
    ulp = np.finfo(np.float64).eps * np.abs(w).max()
    np.testing.assert_allclose(p[2][:nl].numpy(), np.asarray(j[2][:nl]),
                               rtol=0, atol=4 * ulp)
    # the planes code to native's stream of the same field
    payload, _ = tn.encode_planes_batch(p[0][:nl].numpy())
    nat = tn.encode_field(args[0].numpy(), wtflag=1, cutoff=np.array([1e-6]))
    assert nat["nlay"] == nl and payload == nat["data"]
    assert float(p[4]) == nat["tolabs"]


def test_entry_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GE.entry()


def _jax_nlays(n):
    """The JAX codec's layer counts of the dry run's united and
    distributed fields (__graft_entry__.py:68-99)."""
    shape = (2 * n, 8, 8)
    fld = np.fromfunction(
        lambda k, j, i: np.sin(i / 3) * np.cos(j / 2) + 0.05 * k, shape)
    shape2 = (4 * n, 2 * n, 16)
    fld2 = np.fromfunction(
        lambda k, j, i: np.cos(i / 4) * np.sin(j / 3) + 0.02 * k, shape2)
    return (JC.encode_field(fld, 1e-6, backend="jax").nlay,
            JC.encode_field(fld2, 1e-6, backend="jax").nlay)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_gloo_world(n, capsys):
    res = GE.dryrun_multichip(n, device="cpu")
    assert (res.nlay, res.nlay2) == _jax_nlays(n)
    fields = np.stack([
        np.fromfunction(lambda k, j, i: np.sin(i / 3 + b) * np.cos(j / 2)
                        + 0.1 * k, (8, 8, 8)) for b in range(n)])
    assert 0 < res.err <= 1.3e-6 * np.abs(fields).max()
    out = capsys.readouterr().out
    assert (f"dryrun_multichip({n}): ok — dp encode/decode err "
            f"{res.err:.2e}, united nlay={res.nlay} byte-equal, distributed "
            f"nlay={res.nlay2} byte-equal") in out


def test_dryrun_multichip_cuda_raises_without_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GE.dryrun_multichip(2, device="cuda")
    # with one card, NCCL cannot take a world of two
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards"):
        GE.dryrun_multichip(2, device="cuda")


def test_dryrun_multichip_runs_in_the_default_group(tmp_path, capsys):
    import torch.distributed as dist
    from waverange_tpu_torch.parallel import distributed as PD
    PD.init_distributed(init_method=f"file://{tmp_path}/store", world_size=1,
                        rank=0, device="cpu", timeout=60)
    try:
        res = GE.dryrun_multichip(1, device="cpu")
        with pytest.raises(ValueError, match="has 1 ranks, not 2"):
            GE.dryrun_multichip(2, device="cpu")
    finally:
        dist.destroy_process_group()
    assert (res.nlay, res.nlay2) == _jax_nlays(1)
    assert "dryrun_multichip(1): ok" in capsys.readouterr().out
