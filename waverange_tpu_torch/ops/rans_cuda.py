"""Wrappers of the CUDA rANS kernels E (`rans_hist`), F (`rans_chain`),
G (`rans_compact`) and H (`rans_decode`) in `csrc/rans.cu`.

Each wrapper checks its tensors, allocates outputs with `torch.empty`,
launches on the current CUDA stream of the tensors' device, raises on a
launch error, and adds one to its count in `LAUNCHES`. The plain versions
are `rans.block_models_plain`, `rans.chain_plain`, `rans.compact_plain` and
`rans.decode_blocks_plain`; u32 and u16 values travel as the bits of int32
and int16 tensors, as there.
"""
from __future__ import annotations

import torch

from . import _build
from .quant_cuda import _check, _raise_on
from .rans import SLAB_WORDS, num_blocks

LAUNCHES = {"rans_hist": 0, "rans_chain": 0, "rans_compact": 0,
            "rans_decode": 0}


def _need_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def _planes(name: str, planes: torch.Tensor, n: int) -> int:
    _need_cuda(name, planes)
    if planes.dim() != 2 or planes.shape[0] < 1 or n < 1:
        raise ValueError(f"{name}: expected non-empty (L, n) planes, got "
                         f"{tuple(planes.shape)}")
    _check(name, planes, planes.device, torch.uint8, (planes.shape[0], n))
    return planes.shape[0] * num_blocks(n)


def _aligned(name: str, t: torch.Tensor) -> None:
    # kernels F and H stage rows with 16-byte copies from aligned addresses
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor (a "
                         "fresh or .clone()d one), got address "
                         f"{t.data_ptr():#x}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def rans_hist(planes: torch.Tensor, n: int):
    """Kernel E: (L, n) uint8 planes -> etab (L*nb, 256) int32 =
    freq | cum<<16 of every block's normalized model, nsym (L*nb,)
    int32."""
    B = _planes("rans_hist", planes, n)
    etab = torch.empty((B, 256), dtype=torch.int32, device=planes.device)
    nsym = torch.empty(B, dtype=torch.int32, device=planes.device)
    _raise_on("rans_hist", _build.load().wr_rans_hist(
        planes.data_ptr(), n, B, etab.data_ptr(), nsym.data_ptr(),
        planes.device.index, _stream(planes)))
    LAUNCHES["rans_hist"] += 1
    return etab, nsym


def rans_chain(planes: torch.Tensor, n: int, etab: torch.Tensor):
    """Kernel F: the 8 lane chains of every block. Returns slab
    (L*nb, SLAB_WORDS) int16 (each block's words right-aligned in stream
    order; the words before them are undefined), x_fin (L*nb, 8) int32,
    nwords (L*nb,) int32."""
    B = _planes("rans_chain", planes, n)
    _aligned("rans_chain", planes)
    _check("rans_chain", etab, planes.device, torch.int32, (B, 256))
    slab = torch.empty((B, SLAB_WORDS), dtype=torch.int16,
                       device=planes.device)
    x_fin = torch.empty((B, 8), dtype=torch.int32, device=planes.device)
    nwords = torch.empty(B, dtype=torch.int32, device=planes.device)
    _raise_on("rans_chain", _build.load().wr_rans_chain(
        planes.data_ptr(), n, B, etab.data_ptr(), slab.data_ptr(),
        x_fin.data_ptr(), nwords.data_ptr(), planes.device.index,
        _stream(planes)))
    LAUNCHES["rans_chain"] += 1
    return slab, x_fin, nwords


def rans_compact(x_fin: torch.Tensor, slab: torch.Tensor,
                 nwords: torch.Tensor, dest: torch.Tensor,
                 total: int) -> torch.Tensor:
    """Kernel G: every block with dest >= 0 writes its 16 lane-state
    half-words and its nwords kept words to the (total,) int16 payload
    buffer from word dest on. Words no block writes are undefined."""
    _need_cuda("rans_compact", slab)
    if slab.dim() != 2 or slab.shape[0] < 1:
        raise ValueError(f"rans_compact: expected a (B, {SLAB_WORDS}) "
                         f"slab, got {tuple(slab.shape)}")
    B = slab.shape[0]
    dev = slab.device
    _check("rans_compact", slab, dev, torch.int16, (B, SLAB_WORDS))
    _check("rans_compact", x_fin, dev, torch.int32, (B, 8))
    _check("rans_compact", nwords, dev, torch.int32, (B,))
    _check("rans_compact", dest, dev, torch.int64, (B,))
    out = torch.empty(total, dtype=torch.int16, device=dev)
    _raise_on("rans_compact", _build.load().wr_rans_compact(
        x_fin.data_ptr(), slab.data_ptr(), nwords.data_ptr(),
        dest.data_ptr(), B, out.data_ptr(), dev.index, _stream(slab)))
    LAUNCHES["rans_compact"] += 1
    return out


def rans_decode(data: torch.Tensor, table: torch.Tensor, L: int,
                n: int) -> torch.Tensor:
    """Kernel H: the (L, n) uint8 planes from the stream bytes `data` and
    the (L*nb, 3) int64 block table of `rans.parse_planes`, which must
    have validated it: the kernel trusts its offsets."""
    _need_cuda("rans_decode", data)
    if data.dim() != 1 or L < 1 or n < 1:
        raise ValueError("rans_decode: expected 1-D data and L, n >= 1")
    B = L * num_blocks(n)
    _check("rans_decode", data, data.device, torch.uint8, (data.numel(),))
    _check("rans_decode", table, data.device, torch.int64, (B, 3))
    _aligned("rans_decode", data)
    out = torch.empty((L, n), dtype=torch.uint8, device=data.device)
    _raise_on("rans_decode", _build.load().wr_rans_decode(
        data.data_ptr(), data.numel(), table.data_ptr(), n, B,
        out.data_ptr(), data.device.index, _stream(data)))
    LAUNCHES["rans_decode"] += 1
    return out
