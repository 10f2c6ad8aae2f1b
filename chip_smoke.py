#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`waverange_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases:
  1. environment: the card's name and power limit, the torch, CUDA and
     nvcc versions; builds the CUDA kernels (timed);
  2. every kernel against its plain torch version, bitwise: the wavelet
     and quantizer kernels A-D in f64 and f32 at odd and even shapes (A
     and B per axis, per level with x and y fused, and as whole
     transforms, on shapes that cross tile edges in every direction and
     on a line of 60,001 values), the measured `copy_` rate of a 1 GiB
     tensor as the card's practical ceiling, the
     rANS kernels E-H at sizes 1, 9, 65537 and 200001, on the `steal`,
     `constant` and `uniform` (raw escape) distributions, on multi-plane
     batches, on rows that start off a 16-byte boundary and blocks of 5
     and 13 bytes, and on the 8 real byte planes of the 512^3 field at
     1e-16 (E also on planes at an odd address); kernel and plain device
     times at the main path's shapes (512^3 f64), each kernel's bound
     from the bytes and operations of those inputs, and E's time on the
     planes at 1e-7 and on 8 constant and 8 uniform planes;
  3. the main paths, each with the launch counts set to 0 just before it
     and read just after: `encode_field` / `decode_field` on a 512^3 f64
     field at tol 1e-16 and 1e-7, (a) with the host range coder, through
     kernels A-D, byte-identical to the native C++ codec, and (b) with
     `coder="rans", entropy="device"`, through kernels A-H,
     byte-identical to the native turbo codec; the time split of each,
     with the device-entropy encode split into E, F, the layout sync, G
     and the raw-block gather.
     The native codec is the port's own copy (`waverange_tpu_torch.
     native`), built here from the repository's sources;
  4. the entry points, each row with the launch counts set to 0 just
     before it and read just after, byte for byte against the native copy
     on the phase-3 field: `backend="exact64"` at 1e-16 on both entropy
     stages (against phase 3's native records), `precision="native"` on
     the field cast to f32 at 1e-5 with device rANS (against
     `native.encode_field_f32` with the turbo coder),
     `conformance="route"` at f32 1e-9 (the native f64 stream of the same
     f32 values), the generic `wrenc`/`wrdec` through `main(argv)` on a
     raw file of the field in f64 and in f32 (1.5 GiB), with the defaults
     (torch on cuda) and with WR_BACKEND=native, the MSSG
     `wrmssgenc`/`wrmssgdec` on a 256^3 GrADS file with masked points
     (the mask separation and the wtflag=0 mask field), the same way, and
     the rANS encode of a plane view that starts off a 16-byte boundary
     against the native turbo coder; with the wall times of each. No
     FluSI row: the card's machine has no h5py (the CPU tests hold FluSI);
  5. `waverange_tpu_torch.parallel` in a world of one on NCCL (the machine
     has one card), each row with the launch counts set to 0 just before
     it and read just after: `encode_fields_sharded` /
     `decode_fields_sharded` of 4 fields of 512^3 f64 at 1e-7 (field 0 the
     phase-3 field, fields 1-3 made the same way from seeds 1-3), every
     record byte-identical to `native.encode_field` and every decode to
     `native.decode_field`; `encode_field_divided` /
     `decode_field_divided` of the phase-3 field into 4 z-slabs, the same
     way per slab; `united_encode_step` and `distributed_encode_step` /
     `distributed_decode_step` on the phase-3 field at 1e-16 and 1e-7,
     their planes, parameters and decodes bitwise equal on the card to the
     single-device `encode_step` / `decode_step`, the decode also to
     phase 3's native decode; with the wall times of each;
  6. the remaining entry points, each row with the launch counts set to 0
     just before it and read just after, byte for byte:
     `graft_entry.entry()` on the card against the same call on the CPU
     (the plain versions), its planes coded by the host coder against
     `native.encode_field`; the ragged `ops.rans.encode_planes` /
     `decode_planes` on one list (the phase-3 field's 8 planes at 1e-16
     and 4 at 1e-7, an empty plane, and the planes of 1, 65537 and 70001
     symbols of phase 2's cases) against `native.encode_plane(p,
     coder=1)`, beside `encode_planes_device` on the 8 planes;
     `decode_compute_seconds` on the 8 streams beside phase 2's kernel H;
     `python -m waverange_tpu_torch build-lib` into a temporary
     directory, `examples/library/example.c` (a copy) compiled against it
     and run, and the phase-3 field at 1e-7 through its
     `encoding_wrap` / `decoding_wrap` against phase 3's native record and
     decode; `graft_entry.dryrun_multichip(1)` in a world of one on NCCL
     made in this process; then the codec's stage timings
     (`utils.get_timings`) of phases 3-6;
  7. the last line: {"ok": true, "device": {...}}.

Exits non-zero, printing no result, where no CUDA device is available or
outside the repository. No failure is caught.
"""
import contextlib
import filecmp
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
N_MAIN = 512
TOLS = (1e-16, 1e-7)
CLI_TOL = "1e-7"        # the generic and MSSG CLI rows
F32_TOL = 1e-5          # the f32 row
ROUTE_TOL = 1e-9        # the route row: below the f32 floor
PAR_TOL = 1e-7          # phase 5's sharded and divided rows
PAR_FIELDS = 4          # phase 5's batch of fields, and of z-slabs
LIFT_SHAPES = [(33, 31, 29), (17, 13, 9), (32, 1, 7), (1, 1, 64), (5, 5, 5),
               (64, 64, 64), (70, 150, 300), (130, 67, 259), (2, 2, 2),
               (3, 3, 3), (1, 2, 60001), (70000, 2, 2), (2100001, 1, 2)]
QUANT_SIZES = [1 << 20, 1_000_003]
RANS_SIZES = [1, 9, 65537, 200001]
FLAT_N = 1 << 27  # E is also timed on 8 constant and 8 uniform planes


# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once)
# over the H100 SXM's HBM rate, and its operations over the peak rate for
# their type. The H100 SXM's datasheet gives 3.35 TB/s and 67 TFLOP/s
# of f32 outside the tensor cores (128 f32 lanes a SM, an FMA counting
# 2); an SM has 64 f64 and 64 i32 lanes, hence 33.5 TFLOP/s of f64 and
# 16.75 T i32 operations/s.
HBM_BYTES_S = 3.35e12
F64_OPS_S = 33.5e12
I32_OPS_S = 16.75e12


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by) of work that moves nbytes and does ops
    operations of a type whose peak is rate per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, setup=None, reps=5):
    """Median device time of fn() in ms (CUDA events), after one warm-up;
    `setup` runs before each call, outside the timed region. The card is
    kept busy (about 1 ms) while the host enqueues fn's launches, so that
    their host-side cost is not timed where the card would wait for it."""
    import torch
    times = []
    for r in range(reps + 1):
        if setup is not None:
            setup()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


class Checker:
    """Bitwise comparisons of a kernel with its plain version; records the
    largest absolute difference seen per kernel (0 when all are equal)."""

    def __init__(self):
        self.err = {}
        self.count = {}

    def __call__(self, kernel, what, got, want):
        import torch
        if got.shape != want.shape:
            raise AssertionError(f"{kernel}: {what}: shape "
                                 f"{tuple(got.shape)}, plain "
                                 f"{tuple(want.shape)}")
        if not got.numel():
            diff = 0.0
        elif got.dtype.is_floating_point:
            diff = float((got.double() - want.double()).abs().max())
        else:
            diff = float((got.long() - want.long()).abs().max())
        self.err[kernel] = max(self.err.get(kernel, 0.0), diff)
        self.count[kernel] = self.count.get(kernel, 0) + 1
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel}: {what} differs from the plain "
                                 f"version (max abs diff {diff:g})")


def phase_kernels(card, check):
    import torch
    from waverange_tpu_torch.ops import quant as Q
    from waverange_tpu_torch.ops import quant_cuda as QC
    from waverange_tpu_torch.ops import wavelet as W
    from waverange_tpu_torch.ops import wavelet_cuda as WC

    rng = np.random.default_rng(SEED)
    for dtype in (torch.float64, torch.float32):
        for shape in LIFT_SHAPES:
            x = torch.from_numpy(rng.standard_normal(shape)).to(
                device="cuda", dtype=dtype)
            for lvl in (1, 4):
                ext = tuple(-(-s // (1 << (lvl - 1))) for s in shape)
                for axis in range(3):
                    if ext[axis] < 2:
                        continue
                    for name, kern, plain in (
                            ("lift_fwd_axis", WC.lift_fwd_axis,
                             W.lift_fwd_axis_plain),
                            ("lift_inv_axis", WC.lift_inv_axis,
                             W.lift_inv_axis_plain)):
                        a, b = x.clone(), x.clone()
                        kern(a, ext, axis)
                        plain(b, ext, axis)
                        check(name, f"{shape} {dtype} level {lvl} axis "
                              f"{axis}", a, b)
                # one level, x and y fused, against the plain sweeps
                for name, level, plain in (
                        ("lift_fwd_axis", W.lift_fwd_level,
                         W.lift_fwd_level_plain),
                        ("lift_inv_axis", W.lift_inv_level,
                         W.lift_inv_level_plain)):
                    a, b = x.clone(), x.clone()
                    level(a, ext)
                    plain(b, ext)
                    check(name, f"{shape} {dtype} level {lvl} fused", a, b)
                # whole transforms: kernels on the card vs the plain path
                # on the CPU
                w = W.cdf97_forward(x.clone(), lvl)
                want = W.cdf97_forward(x.cpu(), lvl)
                check("lift_fwd_axis", f"{shape} {dtype} forward {lvl}",
                      w.cpu(), want)
                # out of place: the source stays as it was
                src = x.clone()
                w2 = W.cdf97_forward(src, lvl, out=torch.empty_like(x))
                check("lift_fwd_axis", f"{shape} {dtype} forward {lvl} out "
                      "of place", w2.cpu(), want)
                check("lift_fwd_axis", f"{shape} {dtype} forward {lvl} "
                      "source unchanged", src, x)
                r = W.cdf97_inverse(w.clone(), lvl)
                check("lift_inv_axis", f"{shape} {dtype} inverse {lvl}",
                      r.cpu(), W.cdf97_inverse(w.cpu(), lvl))
        for n in QUANT_SIZES:
            w = torch.from_numpy(rng.standard_normal(n) * 5).to(
                device="cuda", dtype=dtype)
            span = float(w.max() - w.min())
            for want_nlay, tolabs in ((1, span), (8, 0.0)):
                what = f"n={n} {dtype} nlay {want_nlay}"
                pk, dk, mk, nk = Q.quantize_layers(w.clone(), tolabs)
                pp, dp, mp, np_ = Q.quantize_layers(w.cpu(), tolabs)
                nl = int(nk)
                if nl != want_nlay or int(np_) != nl:
                    raise AssertionError(f"quant_layer: {what}: nlay "
                                         f"{nl} / plain {int(np_)}")
                check("quant_layer", what + " planes", pk[:nl].cpu(),
                      pp[:nl])
                check("quant_layer", what + " deps", dk[:nl].cpu(), dp[:nl])
                check("quant_layer", what + " minv", mk[:nl].cpu(), mp[:nl])
                acc_k = QC.accumulate(pk[:nl], dk[:nl], mk[:nl])
                acc_p = Q.accumulate_layers_plain(pk[:nl], dk[:nl], mk[:nl])
                check("accumulate", what, acc_k, acc_p)
            # one layer on the card, kernel vs plain; `done` freezes it
            mn, mx = torch.aminmax(w)
            d = (mx - mn) / torch.tensor(255.0, dtype=dtype, device="cuda")
            a = 1 / d
            for done in (0.0, 1.0):
                params = torch.stack([a, -mn * a + 0.5, d, mn,
                                      torch.tensor(done, dtype=dtype,
                                                   device="cuda")])
                fk, fp = w.clone(), w.clone()
                qk = torch.zeros(n, dtype=torch.uint8, device="cuda")
                qp = torch.zeros(n, dtype=torch.uint8, device="cuda")
                bk = QC.quant_layer(fk, qk, params)
                bp = Q.quant_layer_plain(fp, qp, params)
                what = f"one layer n={n} {dtype} done={done:g}"
                check("quant_layer", what + " residual", fk, fp)
                check("quant_layer", what + " plane", qk, qp)
                if done:
                    check("quant_layer", what + " frozen field", fk, w)
                else:
                    check("quant_layer", what + " min", bk[0], bp[0])
                    check("quant_layer", what + " max", bk[1], bp[1])
    torch.cuda.synchronize()

    # Times at the main path's shapes: the 512^3 f64 field.
    times = {}
    n = N_MAIN
    x0 = torch.from_numpy(rng.standard_normal((n, n, n))).cuda()
    x = torch.empty_like(x0)
    scratch = torch.empty_like(x0)

    def reset():
        x.copy_(x0)

    copy_ms = cuda_ms(reset)
    log(f"copy_ of a {x.numel() * 8 / 2**30:.2f} GiB tensor: {copy_ms:.3f} "
        f"ms, {2 * x.numel() * 8 / copy_ms / 1e9:.3f} TB/s read and write: "
        f"the card's practical ceiling [{card}]")
    exts = [tuple(-(-s // (1 << k)) for s in x.shape) for k in range(4)]

    # the kernels level by level between x and the scratch tensor, as the
    # main path runs them; the plain version as three sweeps a level
    def fwd(level):
        def run():
            for ext in exts:
                level(x, ext)
        return run

    def inv(level):
        def run():
            for ext in reversed(exts):
                level(x, ext)
        return run

    # Time, then compare once from the same start, at the main path's
    # shapes.
    for name, sched, kern, plain in (
            ("lift_fwd_axis", fwd,
             lambda t, ext: W.lift_fwd_level(t, ext, scratch),
             W.lift_fwd_level_plain),
            ("lift_inv_axis", inv,
             lambda t, ext: W.lift_inv_level(t, ext, scratch),
             W.lift_inv_level_plain)):
        times[name] = (cuda_ms(sched(kern), reset),
                       cuda_ms(sched(plain), reset))
        reset()
        sched(kern)()
        got = x.clone()
        reset()
        sched(plain)()
        check(name, f"{n}^3 f64 4-level transform", got, x)
        del got
    del scratch
    flat = x.view(-1)
    mn, mx = torch.aminmax(x0)
    d = (mx - mn) / torch.tensor(255.0, dtype=x.dtype, device="cuda")
    a = 1 / d
    params = torch.stack([a, -mn * a + 0.5, d, mn,
                          torch.zeros((), dtype=x.dtype, device="cuda")])
    plane = torch.empty(flat.numel(), dtype=torch.uint8, device="cuda")
    times["quant_layer"] = (
        cuda_ms(lambda: QC.quant_layer(flat, plane, params), reset),
        cuda_ms(lambda: Q.quant_layer_plain(flat, plane, params), reset))
    reset()
    bk = QC.quant_layer(flat, plane, params)
    got, got_q = flat.clone(), plane.clone()
    reset()
    bp = Q.quant_layer_plain(flat, plane, params)
    what = f"{n}^3 f64 one layer"
    check("quant_layer", what + " residual", got, flat)
    check("quant_layer", what + " plane", got_q, plane)
    check("quant_layer", what + " min", bk[0], bp[0])
    check("quant_layer", what + " max", bk[1], bp[1])
    del got, got_q
    planes = torch.from_numpy(
        rng.integers(0, 256, (8, flat.numel()), dtype=np.uint8)).cuda()
    deps = torch.from_numpy(rng.random(8) * 1e-3).cuda()
    minv = torch.from_numpy(-rng.random(8)).cuda()
    times["accumulate"] = (
        cuda_ms(lambda: QC.accumulate(planes, deps, minv)),
        cuda_ms(lambda: Q.accumulate_layers_plain(planes, deps, minv)))
    check("accumulate", f"{n}^3 f64 8 layers",
          QC.accumulate(planes, deps, minv),
          Q.accumulate_layers_plain(planes, deps, minv))
    # a transform reads the field once and writes it once; a lifting sweep
    # does 7 f64 operations an element (4 stages of 3 on half the elements,
    # 1 scale), three sweeps a level
    vol = sum((-(-n // (1 << k))) ** 3 for k in range(4))
    N = flat.numel()
    # what the chosen passes move, halo included: computed, so it goes on
    # the time lines only
    design = {
        name: sum(WC.pass_bytes(ext, axes, 8, inverse) for ext in exts
                  for axes in W.level_passes(ext, inverse))
        / HBM_BYTES_S * 1e3
        for name, inverse in (("lift_fwd_axis", False),
                              ("lift_inv_axis", True))}
    bounds = {"lift_fwd_axis": bound(2 * 8 * N, 3 * 7 * vol, F64_OPS_S),
              "lift_inv_axis": bound(2 * 8 * N, 3 * 7 * vol, F64_OPS_S),
              # field in, residual and plane out; 8 f64 operations
              "quant_layer": bound(N * (8 + 8 + 1), 8 * N, F64_OPS_S),
              # 8 planes in, the f64 field out; a multiply-add a layer
              "accumulate": bound(N * (8 + 8), 8 * 2 * N, F64_OPS_S)}
    what = {"lift_fwd_axis": "4-level forward transform, 8 passes",
            "lift_inv_axis": "4-level inverse transform, 8 passes",
            "quant_layer": "one byte layer",
            "accumulate": "8-layer accumulate"}
    for k in check.count:
        log(f"check {k}: {check.count[k]} comparisons bitwise equal")
    for k, (ms, plain_ms) in times.items():
        log(f"time {k} ({what[k]}, {n}^3 f64): kernel {ms:.3f} ms, plain "
            f"torch {plain_ms:.3f} ms, bound {bounds[k][0]:.3f} ms "
            f"({bounds[k][1]})"
            + (f", design {design[k]:.3f} ms" if k in design else "")
            + f" [{card}]")
    del x0, x, flat, plane, planes
    torch.cuda.empty_cache()
    return times, bounds


def rans_cases(rng):
    """(name, (L, n) uint8 planes) of the rANS kernel checks."""
    for n in RANS_SIZES:
        yield f"n={n}", np.clip(rng.normal(100, 9, (1, n)), 0, 255).astype(
            np.uint8)
    n = 196608
    steal = np.zeros(n, np.uint8)  # ~220 rare symbols: the steal loop
    steal[:220] = np.arange(1, 221) % 256
    rng.shuffle(steal)
    yield "steal", steal[None]
    yield "constant", np.full((1, n), 42, np.uint8)
    yield "uniform", rng.integers(0, 256, (1, n), dtype=np.uint8)
    batch = np.clip(rng.normal(100, 25, (3, 107520)), 0, 255).astype(
        np.uint8)
    batch[1] = 7
    yield "3-plane batch, constant middle plane", batch
    mixed = np.stack([np.clip(rng.normal(128, 60, 70001), 0, 255),
                      rng.integers(0, 4, 70001), np.full(70001, 9),
                      rng.integers(0, 256, 70001)]).astype(np.uint8)
    yield "4-plane batch", mixed
    # rows that start off a 16-byte boundary, and blocks shorter than 16
    # bytes: kernel E's byte-wise head and tail
    yield "3 planes of n=70001", np.clip(rng.normal(100, 25, (3, 70001)),
                                         0, 255).astype(np.uint8)
    yield "3 planes of n=65541 (5-byte last blocks)", rng.integers(
        0, 3, (3, 65541), dtype=np.uint8)
    yield "2 planes of n=13", rng.integers(0, 256, (2, 13), dtype=np.uint8)


def check_rans(check, planes, n, what):
    """Kernels E-H on the card against their plain versions on the same
    inputs on the card, bitwise, and the streams against the native turbo
    coder. Returns the inputs of each kernel for timing."""
    import torch
    from waverange_tpu_torch import native as wn
    from waverange_tpu_torch.ops import rans as R
    from waverange_tpu_torch.ops import rans_cuda as RC

    L = planes.shape[0]
    etab, nsym = RC.rans_hist(planes, n)
    etab_p, nsym_p = R.block_models_plain(planes, n)
    check("rans_hist", what + " models", etab, etab_p)
    check("rans_hist", what + " nsym", nsym, nsym_p)
    del etab_p
    slab, x_fin, nwords = RC.rans_chain(planes, n, etab)
    slab_p, x_fin_p, nwords_p = R.chain_plain(planes, n, etab)
    check("rans_chain", what + " x_fin", x_fin, x_fin_p)
    check("rans_chain", what + " nwords", nwords, nwords_p)
    # the kernel leaves the slab words before a block's stream undefined
    undef = (torch.arange(R.SLAB_WORDS, device=planes.device)[None, :]
             < R.SLAB_WORDS - nwords_p.long()[:, None])
    check("rans_chain", what + " words", slab.masked_fill(undef, 0), slab_p)
    del slab_p, undef, x_fin_p, nwords_p
    nsym_h, nwords_h = torch.stack([nsym, nwords]).cpu().numpy()
    _, wl, dest = R.block_layout(R.plane_bs(L, n), nsym_h, nwords_h)
    dest = torch.from_numpy(dest).cuda()
    total = int(wl.sum())
    check("rans_compact", what, RC.rans_compact(x_fin, slab, nwords, dest,
                                                total),
          R.compact_plain(x_fin, slab, nwords, dest, total))
    streams = R.encode_planes_device(planes, n)
    host = planes.cpu().numpy()
    for i, (got, p) in enumerate(zip(streams, host)):
        if got != wn.encode_plane(p, coder=1):
            raise AssertionError(f"{what}: plane {i} stream differs from "
                                 "the native turbo coder")
    data = b"".join(streams)
    table = torch.from_numpy(
        R.parse_planes(data, [len(s) for s in streams], n)).cuda()
    data = R.bytes_tensor(data).cuda()
    out = RC.rans_decode(data, table, L, n)
    check("rans_decode", what, out, R.decode_blocks_plain(data, table, L, n))
    check("rans_decode", what + " round trip", out, planes)
    torch.cuda.synchronize()
    return dict(etab=etab, slab=slab, x_fin=x_fin, nwords=nwords, dest=dest,
                total=total, data=data, table=table)


def phase_rans(card, check, fld):
    """Kernels E-H against their plain versions: the synthetic cases, then
    the 8 byte planes of the main field at 1e-16, where they are timed."""
    import torch
    from waverange_tpu_torch.ops import quant as Q
    from waverange_tpu_torch.ops import rans as R
    from waverange_tpu_torch.ops import rans_cuda as RC

    rng = np.random.default_rng(SEED)
    for name, p in rans_cases(rng):
        check_rans(check, torch.from_numpy(p).cuda(), p.shape[1], name)
    # E on planes whose first byte is not 16-byte aligned (F and H refuse
    # them)
    p = rng.integers(0, 5, 3 * 70001 + 16, dtype=np.uint8)
    for off in (1, 7):
        planes = torch.from_numpy(p).cuda()[off:off + 3 * 70001].view(3, -1)
        for got, want, what in zip(RC.rans_hist(planes, 70001),
                                   R.block_models_plain(planes, 70001),
                                   ("models", "nsym")):
            check("rans_hist", f"3 planes of n=70001 at address 16k+{off} "
                  + what, got, want)
    x = torch.from_numpy(fld).cuda()
    by_tol = {}
    for tol in TOLS:
        planes, _, _, nlay, *_ = Q.encode_step(x, tol)
        by_tol[tol] = planes[:int(nlay)]
    del x, planes
    planes = by_tol[TOLS[0]]
    nl, n = planes.shape
    what = f"{N_MAIN}^3 f64 tol {TOLS[0]:g}, {nl} planes"
    a = check_rans(check, planes, n, what)
    L = nl
    times = {
        "rans_hist": (cuda_ms(lambda: RC.rans_hist(planes, n)),
                      cuda_ms(lambda: R.block_models_plain(planes, n),
                              reps=2)),
        "rans_chain": (cuda_ms(lambda: RC.rans_chain(planes, n, a["etab"])),
                       cuda_ms(lambda: R.chain_plain(planes, n, a["etab"]),
                               reps=2)),
        "rans_compact": (
            cuda_ms(lambda: RC.rans_compact(a["x_fin"], a["slab"],
                                            a["nwords"], a["dest"],
                                            a["total"])),
            cuda_ms(lambda: R.compact_plain(a["x_fin"], a["slab"],
                                            a["nwords"], a["dest"],
                                            a["total"]), reps=2)),
        "rans_decode": (
            cuda_ms(lambda: RC.rans_decode(a["data"], a["table"], L, n)),
            cuda_ms(lambda: R.decode_blocks_plain(a["data"], a["table"], L,
                                                  n), reps=2)),
    }
    # bytes and operations of this data: F writes each block's words (a
    # raw block's only up to its slab) and does 8 i32 operations a symbol
    # (lookup, compare, renormalizing shift, multiply-high, add, shift,
    # multiply-add, add); G moves the modeled blocks' payloads; H reads the
    # stream and writes the planes, with 8 operations a modeled symbol.
    B, N = a["nwords"].numel(), L * n
    nw = a["nwords"].long()
    modeled = a["dest"] >= 0
    tags = a["table"][:, 0]
    bounds = {
        "rans_hist": bound(N + B * (1024 + 4), N, I32_OPS_S),
        "rans_chain": bound(N + B * (1024 + 32 + 4)
                            + 2 * int(nw.clamp(max=R.SLAB_WORDS).sum()),
                            8 * N, I32_OPS_S),
        "rans_compact": bound(2 * int(nw[modeled].sum())
                              + 32 * int(modeled.sum()) + 12 * B
                              + 2 * a["total"], 0, I32_OPS_S),
        "rans_decode": bound(a["data"].numel() + 24 * B + N,
                             8 * int(torch.tensor(R.plane_bs(L, n)).cuda()[
                                 tags == 0].sum()), I32_OPS_S),
    }
    for k in times:
        log(f"check {k}: {check.count[k]} comparisons bitwise equal")
    for k, (ms, plain_ms) in times.items():
        log(f"time {k} ({what}): kernel {ms:.3f} ms, plain torch "
            f"{plain_ms:.3f} ms, bound {bounds[k][0]:.3f} ms "
            f"({bounds[k][1]}) [{card}]")
    del planes, a
    # E on the planes at 1e-7 and on planes of one symbol and of uniform
    # bytes: equal symbols must not cost more than scattered ones
    extra = {f"{N_MAIN}^3 f64 tol {TOLS[1]:g}": by_tol[TOLS[1]],
             "8 constant planes": torch.full(
                 (8, FLAT_N), 42, dtype=torch.uint8, device="cuda"),
             "8 uniform planes": torch.randint(
                 0, 256, (8, FLAT_N), dtype=torch.uint8, device="cuda",
                 generator=torch.Generator("cuda").manual_seed(SEED))}
    del by_tol
    hist_ms = {}
    for what, planes in extra.items():
        L, n = planes.shape
        B = L * R.num_blocks(n)
        hist_ms[what] = cuda_ms(lambda: RC.rans_hist(planes, n))
        bd = bound(L * n + B * (1024 + 4), L * n, I32_OPS_S)
        log(f"time rans_hist ({what}): kernel {hist_ms[what]:.3f} ms, "
            f"bound {bd[0]:.3f} ms ({bd[1]}) [{card}]")
    log("time rans_hist: constant / uniform planes of 2^"
        f"{FLAT_N.bit_length() - 1}: "
        f"{hist_ms['8 constant planes'] / hist_ms['8 uniform planes']:.3f}")
    del extra, planes
    torch.cuda.empty_cache()
    return times, bounds


class Launches:
    """The kernels' launch counts on the main paths: each path or row runs
    with the wrappers' counts set to 0 just before it and read just after,
    must launch the kernels it names, and adds its counts to `total`."""

    def __init__(self):
        from waverange_tpu_torch.ops import quant_cuda as QC
        from waverange_tpu_torch.ops import rans_cuda as RC
        from waverange_tpu_torch.ops import wavelet_cuda as WC
        self.counters = (WC.LAUNCHES, QC.LAUNCHES, RC.LAUNCHES)
        self.total = {k: 0 for c in self.counters for k in c}

    @contextlib.contextmanager
    def row(self, name, needed):
        for c in self.counters:
            for k in c:
                c[k] = 0
        yield
        grown = {k: v for c in self.counters for k, v in c.items()}
        missed = [k for k in needed if grown[k] < 1]
        if missed:
            raise AssertionError(f"{name} missed kernels {missed}: "
                                 f"launches {grown}")
        for k, v in grown.items():
            self.total[k] += v
        log(f"{name}: kernel launches: {grown}")



def check_record(what, enc, nat):
    """An `EncodedField` against a native record (dict), field by field."""
    same = {
        "data": enc.data == nat["data"],
        "nlay": enc.nlay == nat["nlay"],
        "wlev": enc.wlev == nat["wlev"],
        "ntot_enc": enc.ntot_enc == nat["ntot_enc"],
        **{k: getattr(enc, k).tobytes() == nat[k].tobytes()
           for k in ("deps_vec", "minval_vec", "len_enc_vec")},
        **{k: getattr(enc, k) == nat[k]
           for k in ("tolabs", "midval", "halfspanval")}}
    if not all(same.values()):
        raise AssertionError(f"{what}: port differs from the native codec: "
                             f"{same}")


def make_field(n, rng):
    """The bench's CFD-like field (bench.py make_field): a smooth
    trigonometric base, coarse noise at 1/8 resolution and fine noise,
    built on the card from numpy-seeded noise; returned as numpy."""
    import torch
    i = torch.arange(n, dtype=torch.float64, device="cuda")
    sx, sy, sz = torch.sin(i / 17.3), torch.sin(i / 11.1) ** 2, torch.cos(
        i / 23.7)
    small = torch.from_numpy(rng.standard_normal((n // 8,) * 3)).cuda()
    small = small.repeat_interleave(8, 0).repeat_interleave(
        8, 1).repeat_interleave(8, 2)
    fine = torch.from_numpy(rng.standard_normal(
        n ** 3, dtype=np.float32)).cuda().view(n, n, n).double()
    fld = (10.0 * sz[:, None, None] * sy[None, :, None] * sx[None, None, :]
           + 0.05 * small + 1e-4 * fine)
    out = fld.cpu().numpy()
    del fld, small, fine
    torch.cuda.empty_cache()
    return out


A_TO_D = ("lift_fwd_axis", "lift_inv_axis", "quant_layer", "accumulate")
E_TO_G = ("rans_hist", "rans_chain", "rans_compact")
A_TO_H = A_TO_D + E_TO_G + ("rans_decode",)

# The two main paths: (name, encode_field and decode_field keywords, native
# coder id, kernels the path must launch).
PATHS = [
    ("host range coder", {}, {}, 0, A_TO_D),
    ("device rANS", dict(coder="rans", entropy="device"),
     dict(entropy="device"), 1, A_TO_H),
]


def split_host(fld, tol):
    """Stage times of the host-entropy path (seconds)."""
    import torch
    from waverange_tpu_torch import native as wn
    from waverange_tpu_torch.ops import quant as Q

    torch.cuda.synchronize()
    s = [time.perf_counter()]
    x = torch.from_numpy(fld).cuda()
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    planes, deps, minv, nlay, *_ = Q.encode_step(x, tol)
    nl = int(nlay)
    s.append(time.perf_counter())
    planes_np = planes[:nl].cpu().numpy()
    s.append(time.perf_counter())
    payload, lens = wn.encode_planes_batch(planes_np, coder=0)
    s.append(time.perf_counter())
    planes_np = wn.decode_planes_batch(payload, lens, fld.size, coder=0)
    s.append(time.perf_counter())
    pd = torch.from_numpy(planes_np).cuda()
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    out = Q.decode_step(pd, deps[:nl].clone(), minv[:nl].clone(), fld.shape)
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    out.cpu()
    s.append(time.perf_counter())
    d = np.diff(s)
    return {"h2d_field_s": d[0], "device_encode_s": d[1],
            "d2h_planes_s": d[2], "host_entropy_encode_s": d[3],
            "host_entropy_decode_s": d[4], "h2d_planes_s": d[5],
            "device_decode_s": d[6], "d2h_field_s": d[7]}


def encode_blocks_split(planes, n):
    """`rans.encode_blocks` with the host clock read after each of its
    steps, after a synchronize: E, F, the sync for the layout, G, the
    raw-block gather. Returns the EncodedBlocks and the step times
    (seconds)."""
    import torch
    from waverange_tpu_torch.ops import rans as R

    last, times = [time.perf_counter()], {}

    def mark(step):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[f"enc_{step}_s"] = now - last[0]
        last[0] = now

    return R.encode_blocks(planes, n, mark), times


def split_device(fld, tol):
    """Stage times of the device-entropy path (seconds)."""
    import torch
    from waverange_tpu_torch.ops import quant as Q
    from waverange_tpu_torch.ops import rans as R

    n = fld.size
    torch.cuda.synchronize()
    s = [time.perf_counter()]
    x = torch.from_numpy(fld).cuda()
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    planes, deps, minv, nlay, *_ = Q.encode_step(x, tol)
    nl = int(nlay)
    s.append(time.perf_counter())
    enc, e = encode_blocks_split(planes[:nl], n)
    s.append(time.perf_counter())
    enc = R.fetch(enc)
    s.append(time.perf_counter())
    streams = R.frame(enc)
    data = b"".join(streams)
    s.append(time.perf_counter())
    del x, planes, enc
    table = R.parse_planes(data, [len(t) for t in streams], n)
    s.append(time.perf_counter())
    data_d = R.bytes_tensor(data).cuda()
    table_d = torch.from_numpy(table).cuda()
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    pd = R.decode_blocks(data_d, table_d, nl, n)
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    del data_d, table_d
    out = Q.decode_step(pd, deps[:nl].clone(), minv[:nl].clone(), fld.shape)
    torch.cuda.synchronize()
    s.append(time.perf_counter())
    out.cpu()
    s.append(time.perf_counter())
    d = np.diff(s)
    del pd, out
    return {"h2d_field_s": d[0], "device_encode_s": d[1],
            "device_entropy_encode_s": d[2], **e, "d2h_compressed_s": d[3],
            "host_framing_s": d[4], "host_parse_s": d[5],
            "h2d_compressed_s": d[6], "device_entropy_decode_s": d[7],
            "device_decode_s": d[8], "d2h_field_s": d[9],
            "compressed_bytes": len(data)}


def phase_main(card, fld, launches):
    """The two main paths at TOLS; returns the time rows and the native
    records, decodes and times by (coder id, tol)."""
    import torch
    from waverange_tpu_torch import native as wn
    from waverange_tpu_torch.core import codec as tc

    gb = fld.nbytes / 1e9
    amax = float(np.abs(fld).max())
    wn.pool_warm(fld.size)
    rows, natives = [], {}
    for name, enc_kw, dec_kw, cid, needed in PATHS:
        port = {}
        with launches.row(f"main ({name})", needed):
            for tol in TOLS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                enc = tc.encode_field(fld, tol, device="cuda", **enc_kw)
                t1 = time.perf_counter()
                dec = tc.decode_field(enc, device="cuda", **dec_kw)
                t2 = time.perf_counter()
                port[tol] = (enc, dec, t1 - t0, t2 - t1)

        for tol in TOLS:
            enc, dec, t_enc, t_dec = port[tol]
            t0 = time.perf_counter()
            nat = wn.encode_field(fld, wtflag=1, cutoff=np.array([tol]),
                                  coder=cid)
            t1 = time.perf_counter()
            ndec = wn.decode_field(nat, fld.shape, coder=cid)
            t2 = time.perf_counter()
            check_record(f"{name}, tol {tol:g}", enc, nat)
            if dec.tobytes() != ndec.tobytes():
                raise AssertionError(f"{name}, tol {tol:g}: decode differs "
                                     "from the native decode")
            natives[(cid, tol)] = (nat, ndec, t1 - t0, t2 - t1)
            # the bench's limit (bench.py:712): the error contract, or
            # twice the native decode's error where round-off dominates
            err = float(np.abs(dec - fld).max())
            bound = max(1.3 * tol * amax,
                        2.0 * float(np.abs(ndec - fld).max()))
            if not (np.isfinite(dec).all() and dec.shape == fld.shape
                    and err <= bound):
                raise AssertionError(f"{name}, tol {tol:g}: decode error "
                                     f"{err:g} above {bound:g}")
            log(f"main ({name}) tol {tol:g}: nlay {enc.nlay}, "
                f"{enc.ntot_enc} bytes (ratio "
                f"{fld.nbytes / enc.ntot_enc:.3f}), stream and metadata "
                f"byte-identical to native, decode bit-identical, max err "
                f"{err:.3e} <= {bound:.3e}")
            split = (split_device if cid else split_host)(fld, tol)
            torch.cuda.empty_cache()
            row = {"path": name, "tol": tol, "nlay": enc.nlay,
                   "ratio": fld.nbytes / enc.ntot_enc,
                   "port_encode_s": t_enc, "port_decode_s": t_dec,
                   "native_encode_s": t1 - t0, "native_decode_s": t2 - t1,
                   "port_encode_gbps": gb / t_enc,
                   "port_decode_gbps": gb / t_dec,
                   "native_encode_gbps": gb / (t1 - t0),
                   "native_decode_gbps": gb / (t2 - t1), **split}
            rows.append(row)
            log(f"main ({name}) tol {tol:g} times [{card}]: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_s")
                or k.endswith("_gbps")))
        del port
    return rows, natives


@contextlib.contextmanager
def environ(**env):
    """Set (a value) or unset (None) environment variables for a block."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(tools, workdir, backend):
    """Run each (cli module, argv) of `tools` through its `main(argv)` in
    `workdir`, with WR_BACKEND=`backend` (None: the default, torch) and no
    WR_DEVICE (the default, cuda); returns the wall time of each."""
    import torch
    times = []
    old = os.getcwd()
    os.chdir(workdir)
    try:
        with environ(WR_BACKEND=backend, WR_DEVICE=None, WR_CODER=None,
                     WR_CONFORMANCE=None):
            for mod, argv in tools:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mod.main(argv) != 0:
                    raise AssertionError(f"{mod.__name__} {argv} failed")
                times.append(time.perf_counter() - t0)
    finally:
        os.chdir(old)
    return times


def cli_row(launches, card, name, setup, tools, outputs):
    """One CLI row: the tools run in two directories made by `setup`, with
    the defaults (torch on cuda, counted) and with WR_BACKEND=native; every
    file in `outputs` must be byte-identical between the two."""
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent / "build") as tmp:
        dirs = {b: Path(tmp) / b for b in ("torch", "native")}
        for d in dirs.values():
            d.mkdir()
            setup(d)
        with launches.row(f"entry ({name}, torch on cuda)", A_TO_D):
            t_port = run_cli(tools, dirs["torch"], None)
        t_nat = run_cli(tools, dirs["native"], "native")
        for f in outputs:
            if not filecmp.cmp(dirs["torch"] / f, dirs["native"] / f,
                               shallow=False):
                raise AssertionError(f"{name}: {f} differs between the "
                                     "torch and the native backend")
        sizes = {f: (dirs["torch"] / f).stat().st_size for f in outputs}
    log(f"entry ({name}): {', '.join(outputs)} byte-identical to "
        f"WR_BACKEND=native ({sizes} bytes); wall s [{card}]: " + ", ".join(
            f"{mod.__name__.rsplit('.', 1)[1]} torch {a:.4f} native {b:.4f}"
            for (mod, _), a, b in zip(tools, t_port, t_nat)))
    return {"row": name, **{f"{mod.__name__.rsplit('.', 1)[1]}_{k}_s": t
                            for k, ts in (("torch", t_port),
                                          ("native", t_nat))
                            for (mod, _), t in zip(tools, ts)}}


def phase_entry(card, fld, natives, launches):
    """Phase 4: the entry points on the phase-3 field, byte for byte
    against the native copy. Returns the rows of times."""
    import torch
    from waverange_tpu_torch import native as wn
    from waverange_tpu_torch.cli import mssg_dec, mssg_enc, wrdec, wrenc
    from waverange_tpu_torch.core import codec as tc
    from waverange_tpu_torch.ops import rans as R

    rows = []
    shape = fld.shape
    # exact64 at TOLS[0], both entropy stages, against phase 3's natives
    for name, kw, dec_kw, cid, needed in PATHS:
        nat, ndec, t_nenc, t_ndec = natives[(cid, TOLS[0])]
        with launches.row(f"entry (exact64, {name})", needed):
            t0 = time.perf_counter()
            enc = tc.encode_field(fld, TOLS[0], backend="exact64",
                                  device="cuda", **kw)
            t1 = time.perf_counter()
            dec = tc.decode_field(enc, backend="exact64", device="cuda",
                                  **dec_kw)
            t2 = time.perf_counter()
        check_record(f"exact64 ({name})", enc, nat)
        if dec.tobytes() != ndec.tobytes():
            raise AssertionError(f"exact64 ({name}): decode differs")
        rows.append({"row": f"exact64 ({name})", "tol": TOLS[0],
                     "port_encode_s": t1 - t0, "port_decode_s": t2 - t1,
                     "native_encode_s": t_nenc, "native_decode_s": t_ndec})
        log(f"entry (exact64, {name}) tol {TOLS[0]:g}: record byte-identical "
            f"to native, decode bit-identical; wall s [{card}]: encode "
            f"{t1 - t0:.4f} decode {t2 - t1:.4f}, native (phase 3) "
            f"{t_nenc:.4f} / {t_ndec:.4f}")
        del enc, dec
    torch.cuda.empty_cache()

    # f32 kept in f32 (kernels A and C in f32, E-H on its planes), against
    # the native f32 pipeline; the decode (f64, as every decoder reads the
    # record) against the native f64 decoder
    f32 = fld.astype(np.float32)
    with launches.row("entry (f32, precision='native')", A_TO_H):
        t0 = time.perf_counter()
        enc = tc.encode_field(f32, F32_TOL, precision="native", coder="rans",
                              entropy="device", device="cuda")
        t1 = time.perf_counter()
        dec = tc.decode_field(enc, device="cuda", entropy="device")
        t2 = time.perf_counter()
    nat = wn.encode_field_f32(f32, F32_TOL, coder=1)
    t3 = time.perf_counter()
    ndec = wn.decode_field(nat, shape, coder=1)
    t4 = time.perf_counter()
    check_record("f32", enc, nat)
    err = float(np.abs(dec - f32).max())
    if dec.tobytes() != ndec.tobytes() or not np.isfinite(dec).all() \
            or err > 1.3 * F32_TOL * float(np.abs(f32).max()):
        raise AssertionError(f"f32: decode differs from native or error "
                             f"{err:g} above the contract")
    rows.append({"row": "f32", "tol": F32_TOL, "nlay": enc.nlay,
                 "port_encode_s": t1 - t0, "port_decode_s": t2 - t1,
                 "native_encode_s": t3 - t2, "native_decode_s": t4 - t3})
    log(f"entry (f32, device rANS) tol {F32_TOL:g}: nlay {enc.nlay}, record "
        f"byte-identical to native.encode_field_f32 (turbo), decode "
        f"bit-identical, max err {err:.3e}; wall s [{card}]: encode "
        f"{t1 - t0:.4f} decode {t2 - t1:.4f}, native f32 encode "
        f"{t3 - t2:.4f}, native decode {t4 - t3:.4f}")
    del enc, dec, nat, ndec

    # route: f32 below the floor goes to the f64 path (device entropy, as
    # the reference routes it to exact64)
    with launches.row("entry (route)", ("lift_fwd_axis", "quant_layer")
                      + E_TO_G):
        t0 = time.perf_counter()
        enc = tc.encode_field(f32, ROUTE_TOL, precision="native",
                              conformance="route", coder="rans",
                              entropy="device", device="cuda")
        t1 = time.perf_counter()
    nat = wn.encode_field(f32, cutoff=np.array([ROUTE_TOL]), coder=1)
    t2 = time.perf_counter()
    check_record("route", enc, nat)
    rows.append({"row": "route", "tol": ROUTE_TOL, "nlay": enc.nlay,
                 "port_encode_s": t1 - t0, "native_encode_s": t2 - t1})
    log(f"entry (route) f32 tol {ROUTE_TOL:g}: nlay {enc.nlay}, record "
        f"byte-identical to native f64 turbo of the same f32 values; wall s "
        f"[{card}]: encode {t1 - t0:.4f}, native {t2 - t1:.4f}")
    del enc, nat

    # the generic CLI on a raw file of the field in f64 and in f32
    nz, ny, nx = shape

    def generic_setup(d):
        with open(d / "data.bin", "wb") as f:
            fld.tofile(f)
            f32.tofile(f)
        blocks = "".join(
            f"%field = {i}\n&input_data_type = {t}\n&nx = {nx}\n"
            f"&ny = {ny}\n&nz = {nz}\n&compress = 1\n"
            f"&tolerance = {CLI_TOL}\n/\n" for i, t in ((0, 2), (1, 1)))
        (d / "inmeta").write_text(
            "&in_name = data.bin\n&out_name = data.wrb\n"
            "&header_name = data.wrh\n&file_type = 2\n"
            "&endian_conversion = 0\n&number_of_field = 2\n" + blocks)

    rows.append(cli_row(
        launches, card, f"generic CLI, {nx}^3 f64 + f32", generic_setup,
        [(wrenc, []), (wrdec, ["data.wrb", "data.wrh", "datarec.bin", "2",
                               "0"])],
        ["data.wrh", "data.wrb", "datarec.bin"]))
    del f32

    # the MSSG CLI: a GrADS file of two big-endian f32 records at half the
    # field's extent, the first with masked points
    undef = -9.99e33
    recs = [fld[::2, ::2, ::2] + 300.0, 1.5 * fld[1::2, 1::2, 1::2] + 300.0]
    recs[0][np.random.default_rng(SEED).random(recs[0].shape) < 0.2] = undef
    mz, my, mx = recs[0].shape

    def mssg_setup(d):
        with open(d / "ocean.grd", "wb") as f:
            for r in recs:
                r.astype(">f4").tofile(f)
        (d / "ocean.ctl").write_text(
            f"DSET ^ocean.grd\nUNDEF {undef:g}\nXDEF {mx} LINEAR 0 1\n"
            f"YDEF {my} LINEAR 0 1\nZDEF {mz} LEVELS 1\n"
            f"TDEF {len(recs)} LINEAR 00Z01JAN2000 1dy\n")

    rows.append(cli_row(
        launches, card, f"MSSG CLI, {mx}^3 masked", mssg_setup,
        [(mssg_enc, ["ocean", ".enc", "0", "1", "1", CLI_TOL, "0"]),
         (mssg_dec, ["ocean", ".enc", "oceanrec", "0", "1", "1", "0"])],
        ["ocean_h.enc", "ocean_f.enc", "oceanrec.grd", "oceanrec.ctl"]))
    del recs

    # rows of a plane tensor that start off a 16-byte boundary
    n = 70001
    planes = torch.from_numpy(np.clip(
        np.random.default_rng(SEED).normal(100, 25, (3, n)), 0, 255).astype(
            np.uint8)).cuda()
    view = planes[1:]
    if view.data_ptr() % 16 == 0:
        raise AssertionError("the view was meant to start off a boundary")
    with launches.row("entry (rANS encode of a misaligned row view)", E_TO_G):
        streams = R.encode_planes_device(view, n)
    for i, (got, p) in enumerate(zip(streams, view.cpu().numpy())):
        if got != wn.encode_plane(p, coder=1):
            raise AssertionError(f"misaligned view: plane {i} differs from "
                                 "the native turbo coder")
    log("entry (rANS encode of planes[1:], n = 70001, address 16k+"
        f"{view.data_ptr() % 16}): streams byte-identical to native turbo")
    return rows


def timed(fn):
    """(fn(), wall seconds), the card synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def parallel_rows(card, fld, natives, launches):
    """The rows of phase 5, in a world of one made by the caller."""
    import torch
    from waverange_tpu_torch import native as wn
    from waverange_tpu_torch.ops import quant as Q
    from waverange_tpu_torch.parallel import mesh as PM

    rows = []
    tol = PAR_TOL
    # field-parallel: a backup's equal-shaped datasets, field 0 the phase-3
    # field (its native record and decode are phase 3's)
    batch = np.stack([fld] + [make_field(N_MAIN, np.random.default_rng(
        SEED + i)) for i in range(1, PAR_FIELDS)])
    with launches.row(f"parallel (sharded, {PAR_FIELDS} fields)", A_TO_D):
        encs, t_enc = timed(lambda: PM.encode_fields_sharded(
            batch, tol, device="cuda"))
        dec, t_dec = timed(lambda: PM.decode_fields_sharded(
            encs, device="cuda"))
    t_nenc = t_ndec = 0.0
    for i, e in enumerate(encs):
        if i == 0:
            nat, ndec, a, b = natives[(0, tol)]
        else:
            t0 = time.perf_counter()
            nat = wn.encode_field(batch[i], wtflag=1, cutoff=np.array([tol]))
            a = time.perf_counter() - t0
            ndec = wn.decode_field(nat, batch[i].shape)
            b = time.perf_counter() - t0 - a
        t_nenc, t_ndec = t_nenc + a, t_ndec + b
        check_record(f"sharded field {i}", e, nat)
        if dec[i].tobytes() != ndec.tobytes():
            raise AssertionError(f"sharded field {i}: decode differs from "
                                 "the native decode")
    del dec, ndec
    rows.append({"row": f"sharded, {PAR_FIELDS} x {N_MAIN}^3 f64",
                 "tol": tol, "port_encode_s": t_enc, "port_decode_s": t_dec,
                 "native_encode_s": t_nenc, "native_decode_s": t_ndec})
    log(f"parallel (sharded, {PAR_FIELDS} x {N_MAIN}^3 f64) tol {tol:g}: "
        f"nlay {[e.nlay for e in encs]}, every record byte-identical to "
        f"native.encode_field, decodes bit-identical; wall s [{card}]: "
        f"encode {t_enc:.4f} decode {t_dec:.4f}, native (sum of "
        f"{PAR_FIELDS}) {t_nenc:.4f} / {t_ndec:.4f}")
    del batch, encs

    # divided: the phase-3 field as PAR_FIELDS z-slab subdomains
    with launches.row(f"parallel (divided into {PAR_FIELDS})", A_TO_D):
        encs, t_enc = timed(lambda: PM.encode_field_divided(
            fld, tol, n_blocks=PAR_FIELDS, device="cuda"))
        rec, t_dec = timed(lambda: PM.decode_field_divided(
            encs, device="cuda"))
    k = fld.shape[0] // PAR_FIELDS
    t0 = time.perf_counter()
    nats = [wn.encode_field(fld[i * k:(i + 1) * k], wtflag=1,
                            cutoff=np.array([tol]))
            for i in range(PAR_FIELDS)]
    t1 = time.perf_counter()
    ndec = np.concatenate([wn.decode_field(n, (k,) + fld.shape[1:])
                           for n in nats])
    t2 = time.perf_counter()
    for i, (e, n) in enumerate(zip(encs, nats)):
        check_record(f"divided slab {i}", e, n)
    if rec.tobytes() != ndec.tobytes():
        raise AssertionError("divided: decode differs from the native "
                             "decodes of the slabs")
    rows.append({"row": f"divided into {PAR_FIELDS} z-slabs", "tol": tol,
                 "port_encode_s": t_enc, "port_decode_s": t_dec,
                 "native_encode_s": t1 - t0, "native_decode_s": t2 - t1})
    log(f"parallel (divided into {PAR_FIELDS} z-slabs) tol {tol:g}: every "
        f"slab record byte-identical to native, decode bit-identical; wall "
        f"s [{card}]: encode {t_enc:.4f} decode {t_dec:.4f}, native "
        f"{t1 - t0:.4f} / {t2 - t1:.4f}")
    del encs, rec, nats, ndec

    # united and distributed steps on the phase-3 field, against the
    # single-device step on the card (phase 3 held its streams to native)
    slab = torch.from_numpy(fld).cuda()
    shape = fld.shape
    for t in TOLS:
        single, t_single = timed(lambda: Q.encode_step(slab, t))
        nl = int(single[3])
        ref = [single[0][:nl], single[1][:nl], single[2][:nl]]
        want = Q.decode_step(ref[0].contiguous(), ref[1], ref[2], shape)
        for name, make, needed in (
                ("united", PM.united_encode_step,
                 ("lift_fwd_axis", "quant_layer")),
                ("distributed", PM.distributed_encode_step, A_TO_D)):
            got = t_dec = None
            with launches.row(f"parallel ({name}, tol {t:g})", needed):
                out, t_enc = timed(lambda: make(None, shape)(slab, t))
                if name == "distributed":
                    got, t_dec = timed(lambda: PM.distributed_decode_step(
                        None, shape)(ref[0].contiguous(), ref[1], ref[2]))
            if not (int(out[3]) == nl and float(out[4]) == float(single[4])
                    and all(torch.equal(a[:nl], b)
                            for a, b in zip(out[:3], ref))):
                raise AssertionError(f"{name} step, tol {t:g}: planes or "
                                     "parameters differ from the "
                                     "single-device step")
            del out
            if got is not None and not (
                    torch.equal(got, want) and got.cpu().numpy().tobytes()
                    == natives[(0, t)][1].tobytes()):
                raise AssertionError(f"distributed decode, tol {t:g}: "
                                     "differs from decode_step or from the "
                                     "native decode")
            del got
            rows.append({"row": name, "tol": t, "nlay": nl,
                         "port_encode_step_s": t_enc,
                         "port_decode_step_s": t_dec,
                         "single_encode_step_s": t_single})
            log(f"parallel ({name}) tol {t:g}: nlay {nl}, planes, deps, "
                f"minv, tolabs bit-identical to the single-device step"
                + (", decode to decode_step and to native" if t_dec else "")
                + f"; wall s [{card}]: step {t_enc:.4f}"
                + (f" decode step {t_dec:.4f}" if t_dec else "")
                + f", single-device step {t_single:.4f}")
        del single, ref, want
        torch.cuda.empty_cache()
    del slab
    torch.cuda.empty_cache()
    return rows


def phase_parallel(card, fld, natives, launches):
    """Phase 5: `waverange_tpu_torch.parallel` in a world of one on NCCL,
    joined through a file store under build/ and left at the end."""
    import torch
    import torch.distributed as dist
    from waverange_tpu_torch.parallel import distributed as PD

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        PD.init_distributed(init_method=f"file://{tmp}/store", world_size=1,
                            rank=0, local_rank=0, device="cuda")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()}")
            # the first collective sets up the NCCL communicator: timed
            # here, so that the rows time the steps alone
            one = torch.ones(1, device="cuda")
            _, t_setup = timed(lambda: dist.all_reduce(one))
            log(f"parallel: NCCL world of one, first collective (the "
                f"communicator's setup) {t_setup:.4f} s [{card}]")
            return [{"row": "NCCL setup", "first_collective_s": t_setup}] \
                + parallel_rows(card, fld, natives, launches)
        finally:
            dist.destroy_process_group()


def run(cmd, **kw):
    """Run a command; raise with its output if it fails."""
    r = subprocess.run([str(c) for c in cmd], capture_output=True, text=True,
                       **kw)
    if r.returncode != 0:
        raise AssertionError(f"{cmd} failed ({r.returncode}):\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def libwaverange_rows(card, fld, natives):
    """`build-lib` in a child process into a temporary directory, then the
    C example compiled against it and the phase-3 field through its ABI."""
    import ctypes as ct
    import shutil

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=repo / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        out = run([sys.executable, "-m", "waverange_tpu_torch", "build-lib",
                   tmp / "build"], cwd=repo, timeout=600)
        t_build = time.perf_counter() - t0
        libdir = Path(out.strip().splitlines()[-1])
        if libdir != tmp / "build" / "lib":
            raise AssertionError(f"build-lib printed {libdir}")
        # a copy of the example, so that its "../../build/include/
        # waverange.h" is the port's header
        ex = tmp / "examples" / "library"
        ex.mkdir(parents=True)
        shutil.copy(repo / "examples" / "library" / "example.c", ex)
        run(["gcc", "-O2", "-o", "example", "example.c", f"-L{libdir}",
             "-lwaverange", f"-Wl,-rpath,{libdir}", "-lm"], cwd=ex)
        said = run([ex / "example"], cwd=ex)
        if "PASS" not in said:
            raise AssertionError(f"example.c: {said[-500:]}")

        # the phase-3 field at PAR_TOL through encoding_wrap/decoding_wrap,
        # against phase 3's native range-coder record and decode
        nat, ndec, t_nenc, t_ndec = natives[(0, PAR_TOL)]
        lib = ct.CDLL(str(libdir / "libwaverange.so"))
        f64 = ct.POINTER(ct.c_double)
        u64 = ct.POINTER(ct.c_ulong)
        u8 = ct.POINTER(ct.c_ubyte)
        i3 = [ct.c_int] * 3
        record = [f64, f64, f64, u8, u8, u64, f64, f64, u64, u8]
        lib.setup_wr.argtypes = i3 + [u8, u64]
        lib.encoding_wrap.argtypes = i3 + [f64, ct.c_int] + i3 + [f64] \
            + record
        lib.decoding_wrap.argtypes = i3 + [f64] + record
        for f in (lib.setup_wr, lib.encoding_wrap, lib.decoding_wrap):
            f.restype = None
        nz, ny, nx = fld.shape
        nlaymax, cap = ct.c_ubyte(), ct.c_ulong()
        lib.setup_wr(nx, ny, nz, ct.byref(nlaymax), ct.byref(cap))
        a = fld.copy()
        cutoff = np.array([PAR_TOL])
        tolabs, midval, halfspan = ct.c_double(), ct.c_double(), \
            ct.c_double()
        wlev, nlay, ntot = ct.c_ubyte(), ct.c_ubyte(), ct.c_ulong()
        deps, minv = np.zeros(8), np.zeros(8)
        lens = np.zeros(8, np.uint64)
        data = np.zeros(cap.value, np.uint8)
        t0 = time.perf_counter()
        lib.encoding_wrap(
            nx, ny, nz, a.ctypes.data_as(f64), 1, 1, 1, 1,
            cutoff.ctypes.data_as(f64), ct.byref(tolabs), ct.byref(midval),
            ct.byref(halfspan), ct.byref(wlev), ct.byref(nlay),
            ct.byref(ntot), deps.ctypes.data_as(f64),
            minv.ctypes.data_as(f64), lens.ctypes.data_as(u64),
            data.ctypes.data_as(u8))
        t1 = time.perf_counter()
        k = nlay.value
        same = {"nlay": k == nat["nlay"], "tolabs": tolabs.value ==
                nat["tolabs"], "midval": midval.value == nat["midval"],
                "halfspanval": halfspan.value == nat["halfspanval"],
                "wlev": wlev.value == nat["wlev"],
                "deps": deps[:k].tobytes() == nat["deps_vec"][:k].tobytes(),
                "minval": minv[:k].tobytes()
                == nat["minval_vec"][:k].tobytes(),
                "len_enc": lens[:k].tobytes()
                == np.asarray(nat["len_enc_vec"], np.uint64)[:k].tobytes(),
                "data": ntot.value == nat["ntot_enc"]
                and data[:ntot.value].tobytes() == nat["data"]}
        if not all(same.values()):
            raise AssertionError(f"libwaverange encoding_wrap differs from "
                                 f"the native record: {same}")
        rec = np.zeros_like(fld)
        t2 = time.perf_counter()
        lib.decoding_wrap(
            nx, ny, nz, rec.ctypes.data_as(f64), ct.byref(tolabs),
            ct.byref(midval), ct.byref(halfspan), ct.byref(wlev),
            ct.byref(nlay), ct.byref(ntot), deps.ctypes.data_as(f64),
            minv.ctypes.data_as(f64), lens.ctypes.data_as(u64),
            data.ctypes.data_as(u8))
        t3 = time.perf_counter()
        if rec.tobytes() != ndec.tobytes():
            raise AssertionError("libwaverange decoding_wrap differs from "
                                 "the native decode")
    log(f"remaining (build-lib): built in {t_build:.1f} s by `python -m "
        f"waverange_tpu_torch build-lib`; examples/library/example.c "
        f"against it: PASS; {nx}^3 f64 tol {PAR_TOL:g} through "
        f"encoding_wrap / decoding_wrap: record byte-identical to phase "
        f"3's native range coder (nlay {k}), decode bit-identical; wall s "
        f"[{card}]: encode {t1 - t0:.4f} decode {t3 - t2:.4f}, native "
        f"(phase 3) {t_nenc:.4f} / {t_ndec:.4f}")
    return [{"row": "build-lib", "build_s": t_build},
            {"row": "libwaverange ABI", "tol": PAR_TOL,
             "abi_encode_s": t1 - t0, "abi_decode_s": t3 - t2,
             "native_encode_s": t_nenc, "native_decode_s": t_ndec}]


def phase_remaining(card, fld, natives, h_ms, launches):
    """Phase 6: `graft_entry.entry()`, the ragged `encode_planes` /
    `decode_planes`, `decode_compute_seconds`, `build-lib` and its ABI,
    and `graft_entry.dryrun_multichip(1)` in a world of one on NCCL; each
    byte for byte. Returns the rows of times."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.distributed as dist
    from waverange_tpu_torch import graft_entry as GE
    from waverange_tpu_torch import native as wn
    from waverange_tpu_torch.ops import quant as Q
    from waverange_tpu_torch.ops import rans as R
    from waverange_tpu_torch.parallel import distributed as PD

    rows = []
    # entry(): on the card, against the same call on the CPU (the plain
    # versions), and its planes coded by the host coder against native
    with launches.row("remaining (entry())", ("lift_fwd_axis",
                                              "quant_layer")):
        fwd, args = GE.entry()
        out, t_card = timed(lambda: fwd(*args))
    fwd, cpu_args = GE.entry(device="cpu")
    t0 = time.perf_counter()
    ref = fwd(*cpu_args)
    t_cpu = time.perf_counter() - t0
    nl = int(out[3])
    if int(ref[3]) != nl or not all(
            torch.equal(a[:nl].cpu(), b[:nl])
            for a, b in zip(out[:3], ref[:3])):
        raise AssertionError("entry(): planes, deps or minv on the card "
                             "differ from the plain versions")
    payload, _ = wn.encode_planes_batch(out[0][:nl].cpu().numpy())
    nat = wn.encode_field(cpu_args[0].numpy(), wtflag=1,
                          cutoff=np.array([cpu_args[1]]))
    if nat["nlay"] != nl or payload != nat["data"]:
        raise AssertionError("entry(): planes code to other bytes than "
                             "native.encode_field")
    del out, ref
    rows.append({"row": "entry()", "step_s": t_card, "plain_step_s": t_cpu})
    log(f"remaining (entry()): 64^3 f64, nlay {nl}, planes, deps, minv "
        f"bitwise equal to device='cpu', coded bytes = native.encode_field; "
        f"wall s [{card}]: step {t_card:.4f}, plain on the CPU {t_cpu:.4f}")

    # the ragged API on one list: the phase-3 field's planes at both
    # tolerances, an empty plane, and rans_cases' planes of 1, 65537 and
    # 70001 symbols
    x = torch.from_numpy(fld).cuda()
    by_tol = {}
    for tol in TOLS:
        p, _, _, nlay, *_ = Q.encode_step(x, tol)
        by_tol[tol] = p[:int(nlay)]
    del x, p
    n = fld.size
    uniform = by_tol[TOLS[0]]
    planes = [row for tol in TOLS for row in by_tol[tol].cpu().numpy()]
    n_big = len(planes)
    del by_tol
    planes.append(np.empty(0, np.uint8))
    planes += [row for _, p in rans_cases(np.random.default_rng(SEED))
               if p.shape[1] in (1, 65537, 70001) for row in p]
    with launches.row("remaining (ragged encode_planes)", E_TO_G):
        streams, t_rag = timed(lambda: R.encode_planes(planes))
    with ThreadPoolExecutor(8) as ex:
        want = list(ex.map(lambda p: wn.encode_plane(p, coder=1), planes))
    bad = [i for i, (a, b) in enumerate(zip(streams, want)) if a != b]
    if bad or streams[n_big] != b"":
        raise AssertionError(f"ragged encode_planes: streams {bad} differ "
                             "from native.encode_plane(p, coder=1)")
    del want
    with launches.row("remaining (encode_planes_device, 8 planes)", E_TO_G):
        dev_streams, t_dev = timed(
            lambda: R.encode_planes_device(uniform, n))
    if dev_streams != streams[:uniform.shape[0]]:
        raise AssertionError("encode_planes_device and encode_planes differ")
    del dev_streams, uniform
    ns = [p.size for p in planes]
    with launches.row("remaining (ragged decode_planes)", ("rans_decode",)):
        back, t_back = timed(lambda: R.decode_planes(streams, ns))
    if not all(np.array_equal(a, b) for a, b in zip(back, planes)):
        raise AssertionError("ragged decode_planes: planes differ")
    del back
    lengths = sorted(set(ns))
    rows.append({"row": "ragged planes", "planes": len(planes),
                 "encode_planes_s": t_rag, "decode_planes_s": t_back,
                 "encode_planes_device_8_s": t_dev})
    log(f"remaining (ragged encode_planes / decode_planes): {len(planes)} "
        f"planes of lengths {lengths}, every stream byte-identical to "
        f"native.encode_plane(p, coder=1) (the empty plane b''), decode "
        f"gives the planes back; wall s [{card}]: encode_planes "
        f"{t_rag:.4f}, decode_planes {t_back:.4f}; encode_planes_device "
        f"on the 8 planes at {TOLS[0]:g} {t_dev:.4f}")
    del planes

    eight = streams[:8]
    with launches.row("remaining (decode_compute_seconds)",
                      ("rans_decode",)):
        probe = R.decode_compute_seconds(eight, n)
    del streams, eight
    rows.append({"row": "decode_compute_seconds", "probe_ms": probe * 1e3,
                 "phase2_rans_decode_ms": h_ms})
    log(f"remaining (decode_compute_seconds): the 8 streams at "
        f"{TOLS[0]:g}, {probe * 1e3:.3f} ms; phase 2's kernel H on the "
        f"same planes {h_ms:.3f} ms (device time) [{card}]")
    torch.cuda.empty_cache()

    rows += libwaverange_rows(card, fld, natives)

    # dryrun_multichip(1) in a world of one on NCCL made here, so that its
    # launches are counted in this process
    build = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        PD.init_distributed(init_method=f"file://{tmp}/store", world_size=1,
                            rank=0, local_rank=0, device="cuda")
        try:
            with launches.row("remaining (dryrun_multichip(1), NCCL)",
                              A_TO_D):
                res, t_dry = timed(lambda: GE.dryrun_multichip(1))
        finally:
            dist.destroy_process_group()
    rows.append({"row": "dryrun_multichip(1)", "wall_s": t_dry,
                 "err": res.err, "nlay": res.nlay, "nlay2": res.nlay2})
    log(f"remaining (dryrun_multichip(1), a world of one on NCCL): err "
        f"{res.err:.3e}, united nlay {res.nlay}, distributed nlay "
        f"{res.nlay2}, both byte-equal to the single-device encode; wall s "
        f"[{card}]: {t_dry:.4f} (NCCL's setup in it)")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from waverange_tpu_torch import utils
        from waverange_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc: {nvcc_ver.splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.ensure_built()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_build.lib_path().name})")

    check = Checker()
    times, bounds = phase_kernels(card, check)
    t0 = time.perf_counter()
    fld = make_field(N_MAIN, np.random.default_rng(SEED))
    log(f"main: {N_MAIN}^3 f64 field ({fld.nbytes / 2**30:.2f} GiB) made "
        f"in {time.perf_counter() - t0:.1f} s")
    rans_times, rans_bounds = phase_rans(card, check, fld)
    times.update(rans_times)
    bounds.update(rans_bounds)
    counts = Launches()
    rows, natives = phase_main(card, fld, counts)
    t0 = time.perf_counter()
    entry_rows = phase_entry(card, fld, natives, counts)
    log(f"entry: phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parallel = phase_parallel(card, fld, natives, counts)
    log(f"parallel: phase 5 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    remaining = phase_remaining(card, fld, natives, times["rans_decode"][0],
                                counts)
    log(f"remaining: phase 6 took {time.perf_counter() - t0:.1f} s")
    del natives
    log("stage timings of the codec (utils.get_timings), phases 3-6: "
        + json.dumps(utils.get_timings()))
    launches = counts.total
    log(f"kernel launches on the main paths, entry, parallel and remaining "
        f"rows: {launches}")

    rk = "waverange_tpu/ops/rans_kernels.py"
    replaces = {
        "lift_fwd_axis": "waverange_tpu/ops/wavelet_pallas.py:129; "
                         "waverange_tpu/ops/wavelet_pallas.py:100",
        "lift_inv_axis": "waverange_tpu/ops/wavelet_pallas.py:204",
        "quant_layer": "waverange_tpu/ops/quant_pallas.py:70",
        "accumulate": "waverange_tpu/ops/quant_pallas.py:118",
        "rans_hist": f"{rk}:112",
        "rans_chain": f"{rk}:163; {rk}:277",
        "rans_compact": f"{rk}:417",
        "rans_decode": f"{rk}:700",
    }
    source = {"lift_fwd_axis": "waverange_tpu_torch/csrc/lift.cu",
              "lift_inv_axis": "waverange_tpu_torch/csrc/lift.cu",
              "quant_layer": "waverange_tpu_torch/csrc/quant.cu",
              "accumulate": "waverange_tpu_torch/csrc/quant.cu",
              "rans_hist": "waverange_tpu_torch/csrc/rans.cu",
              "rans_chain": "waverange_tpu_torch/csrc/rans.cu",
              "rans_compact": "waverange_tpu_torch/csrc/rans.cu",
              "rans_decode": "waverange_tpu_torch/csrc/rans.cu"}
    # no single PyTorch call computes any of these functions (PERF.md)
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": check.err[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": None}
               for k in replaces]
    log(json.dumps({"card": card, "main_path": rows,
                    "entry_points": entry_rows, "parallel": parallel,
                    "remaining": remaining}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
