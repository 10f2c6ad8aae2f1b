"""The host half of `waverange_tpu_torch.core.staging` on the CPU: the
chunk plan, the threaded copy, the `bytes` constructor, and the CPU path of
the codec, which never touches the pinned ring. The ring's DMAs run only
on a card (`chip_smoke.py` holds them bitwise there); here the ring's
slot schedule runs with CPU stand-ins for the stream and events."""
import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_codec as codec_tests
from waverange_tpu_torch.core import staging

SLOT = staging.SLOT_BYTES


@pytest.mark.parametrize("n", [0, 1, SLOT - 1, SLOT, SLOT + 1,
                               7 * SLOT // 2])
def test_chunk_plan_covers_exactly_in_order(n):
    plan = staging.chunks(n, SLOT)
    assert [a for a, _ in plan] == list(range(0, n, SLOT))
    pos = 0
    for a, b in plan:
        assert a == pos and a < b <= a + SLOT
        pos = b
    assert pos == n
    assert len(plan) == -(-n // SLOT)


@pytest.mark.parametrize("threads", range(1, 9))
@pytest.mark.parametrize("dtype,n", [(np.float64, 1_048_583),
                                     (np.uint8, 8_388_617), (np.uint8, 3)])
def test_threaded_copy_is_bitwise(threads, dtype, n):
    # 8 MiB and a few bytes: three pieces of PIECE_BYTES, the last ragged
    rng = np.random.default_rng(threads)
    if dtype == np.uint8:
        src = rng.integers(0, 256, n, dtype=np.uint8)
    else:  # every bit pattern, NaNs and infinities among them
        src = rng.integers(0, 2**63, n, dtype=np.uint64).view(np.float64)
    dst = np.empty_like(src)
    with ThreadPoolExecutor(threads) as pool:
        jobs = staging.copy_pieces(dst.view(np.uint8), src.view(np.uint8),
                                   pool)
        assert len(jobs) == -(-src.nbytes // staging.PIECE_BYTES)
        staging.finish(jobs)
    assert dst.tobytes() == src.tobytes()


def test_threaded_copy_refuses_mismatch():
    pool = staging.threads()
    with pytest.raises(ValueError):
        staging.copy_pieces(np.empty(5, np.uint8), np.empty(6, np.uint8),
                            pool)
    with pytest.raises(ValueError):
        staging.copy_pieces(np.empty(5, np.float64),
                            np.empty(5, np.float64), pool)


@pytest.mark.parametrize("n", [0, 1, 4095, staging.PIECE_BYTES + 13,
                               70_001_003])
def test_bytes_buffer_builds_bytes(n):
    src = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    b, view = staging.bytes_buffer(n)
    staging.finish(staging.copy_pieces(view, src, staging.threads()))
    del view
    assert type(b) is bytes
    assert len(b) == n and b == src.tobytes()
    if n == 0:
        assert b == b""


@pytest.mark.parametrize("shape", [(0,), (1,), (3, 5, 7), (64, 64, 65)])
def test_host_result_faults_in_every_page(shape):
    r = staging.host_result(shape, np.float64, "cuda")
    assert len(r.touching) <= staging.PREFAULT_THREADS
    staging.finish(r.touching)
    assert r.array.shape == shape and r.array.dtype == np.float64
    flat = r.array.reshape(-1).view(np.uint8)
    assert not flat[::staging.PAGE].any()  # one byte a page written
    assert staging.host_result(shape, np.float64, "cpu") is None


class _Stream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


class _Event:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def cpu_ring(monkeypatch):
    """The ring's slot schedule with CPU stand-ins for the copy stream,
    the events and the pinned slots (the copies then run at once), at
    slots of 1000 bytes and host pieces of 64: ragged chunks, several
    laps of the ring, several pieces a slot."""
    empty = torch.empty

    def unpinned(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", unpinned)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(staging, "SLOT_BYTES", 1000)
    monkeypatch.setattr(staging, "PIECE_BYTES", 64)
    monkeypatch.setattr(staging, "_rings", {})
    return empty


@pytest.mark.parametrize("n", [1, 999, 1000, 1001, 3500, 4000, 4001, 9999])
def test_ring_schedule_round_trips(cpu_ring, n):
    src = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    card = cpu_ring(n, dtype=torch.uint8)
    staging.ring("up").upload(src, card)
    assert card.numpy().tobytes() == src.tobytes()
    back = np.empty(n, np.uint8)
    staging.ring("down").download(card, back)
    assert back.tobytes() == src.tobytes()
    b, view = staging.bytes_buffer(n)
    staging.ring("down").download(card, view)
    del view
    assert type(b) is bytes and b == src.tobytes()
    assert [len(r.slots) for r in staging._rings.values()] \
        == [staging.SLOTS] * 2


@pytest.fixture
def no_ring(monkeypatch):
    def refuse(direction):
        raise AssertionError(f"the CPU path touched the {direction} ring")
    monkeypatch.setattr(staging, "ring", refuse)


@pytest.mark.parametrize("case", [
    lambda: codec_tests.test_stream_identical_to_native((33, 31, 29), 1e-10),
    lambda: codec_tests.test_rans_coder_matches_native(),
    lambda: codec_tests.test_device_entropy_identical_to_native(
        (32, 24, 20), 1e-16),
    lambda: codec_tests.test_device_entropy_trivial_field(),
], ids=["host-range", "host-rans", "device-rans", "device-trivial"])
def test_cpu_codec_never_touches_the_ring(no_ring, case):
    case()


def test_cpu_sites_keep_the_plain_path(no_ring):
    a = np.arange(12.0).reshape(3, 4)
    t = staging.to_device(a, "cpu")
    assert t.data_ptr() == a.ctypes.data  # torch.from_numpy: a view
    assert np.shares_memory(staging.to_numpy(t), a)
    ro = np.frombuffer(b"\x01\x02\x03", np.uint8)
    assert staging.to_device(ro, torch.device("cpu")).tolist() == [1, 2, 3]
    assert staging.to_host_bytes(torch.arange(4, dtype=torch.uint8)) \
        == bytes(range(4))
    with pytest.raises(ValueError):
        staging.to_host(t, np.empty_like(a))
