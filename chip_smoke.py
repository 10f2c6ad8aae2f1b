#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`waverange_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases:
  1. environment: the card's name and power limit, the torch, CUDA and
     nvcc versions; builds the CUDA kernels (timed);
  2. every kernel against its plain torch version, bitwise, in f64 and
     f32, at odd and even shapes; kernel and plain times at the main
     path's shapes (512^3 f64);
  3. the main path: `encode_field` / `decode_field` on a 512^3 f64 field
     at tol 1e-16 and 1e-7, through all four kernels, byte-identical to
     the native C++ codec, with the time split of the pipeline;
  4. the last line: {"ok": true, "device": {...}}.

Exits non-zero, printing no result, where no CUDA device is available or
outside the repository. No failure is caught.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_MAIN = 512
TOLS = (1e-16, 1e-7)
LIFT_SHAPES = [(33, 31, 29), (17, 13, 9), (32, 1, 7), (1, 1, 64), (5, 5, 5),
               (64, 64, 64)]
QUANT_SIZES = [1 << 20, 1_000_003]


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, setup=None, reps=5):
    """Median device time of fn() in ms (CUDA events), after one warm-up;
    `setup` runs before each call, outside the timed region."""
    import torch
    times = []
    for r in range(reps + 1):
        if setup is not None:
            setup()
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
        if got.dtype.is_floating_point:
            diff = float((got.double() - want.double()).abs().max())
        else:
            diff = float((got.int() - want.int()).abs().max())
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
                # whole transforms: kernels on the card vs the plain path
                # on the CPU
                w = W.cdf97_forward(x.clone(), lvl)
                check("lift_fwd_axis", f"{shape} {dtype} forward {lvl}",
                      w.cpu(), W.cdf97_forward(x.cpu(), lvl))
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

    def reset():
        x.copy_(x0)

    def fwd(lift):
        def run():
            az, ay, ax = x.shape
            for _ in range(4):
                for axis in (2, 1, 0):
                    lift(x, (az, ay, ax), axis)
                az, ay, ax = (-(-az // 2), -(-ay // 2), -(-ax // 2))
        return run

    def inv(lift):
        def run():
            for k in range(4, 0, -1):
                ext = tuple(-(-s // (1 << (k - 1))) for s in x.shape)
                for axis in (0, 1, 2):
                    lift(x, ext, axis)
        return run

    # Time, then compare once from the same start, at the main path's
    # shapes.
    for name, sched, kern, plain in (
            ("lift_fwd_axis", fwd, WC.lift_fwd_axis, W.lift_fwd_axis_plain),
            ("lift_inv_axis", inv, WC.lift_inv_axis, W.lift_inv_axis_plain)):
        times[name] = (cuda_ms(sched(kern), reset),
                       cuda_ms(sched(plain), reset))
        reset()
        sched(kern)()
        got = x.clone()
        reset()
        sched(plain)()
        check(name, f"{n}^3 f64 4-level transform", got, x)
        del got
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
    what = {"lift_fwd_axis": "4-level forward transform, 12 sweeps",
            "lift_inv_axis": "4-level inverse transform, 12 sweeps",
            "quant_layer": "one byte layer",
            "accumulate": "8-layer accumulate"}
    for k in check.count:
        log(f"check {k}: {check.count[k]} comparisons bitwise equal")
    for k, (ms, plain_ms) in times.items():
        log(f"time {k} ({what[k]}, {n}^3 f64): kernel {ms:.3f} ms, plain "
            f"torch {plain_ms:.3f} ms [{card}]")
    del x0, x, flat, plane, planes
    torch.cuda.empty_cache()
    return times


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


def phase_main(card):
    import torch
    from waverange_tpu import native as wn
    from waverange_tpu_torch.core import codec as tc
    from waverange_tpu_torch.ops import quant as Q
    from waverange_tpu_torch.ops import quant_cuda as QC
    from waverange_tpu_torch.ops import wavelet_cuda as WC

    n = N_MAIN
    t0 = time.perf_counter()
    fld = make_field(n, np.random.default_rng(SEED))
    log(f"main: {n}^3 f64 field ({fld.nbytes / 2**30:.2f} GiB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    gb = fld.nbytes / 1e9
    amax = float(np.abs(fld).max())
    wn.pool_warm(fld.size)

    counters = (WC.LAUNCHES, QC.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    port = {}
    for tol in TOLS:
        before = {k: v for c in counters for k, v in c.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = tc.encode_field(fld, tol, device="cuda")
        t1 = time.perf_counter()
        dec = tc.decode_field(enc, device="cuda")
        t2 = time.perf_counter()
        grown = {k: v - before[k] for c in counters for k, v in c.items()}
        if min(grown.values()) < 1:
            raise AssertionError(f"main path at tol {tol:g} missed a "
                                 f"kernel: launches {grown}")
        port[tol] = (enc, dec, t1 - t0, t2 - t1, grown)
    launches = {k: v for c in counters for k, v in c.items()}
    log(f"main: kernel launches on the main path: {launches}")

    rows = []
    for tol in TOLS:
        enc, dec, t_enc, t_dec, grown = port[tol]
        t0 = time.perf_counter()
        nat = wn.encode_field(fld, wtflag=1, cutoff=np.array([tol]))
        t1 = time.perf_counter()
        ndec = wn.decode_field(nat, fld.shape)
        t2 = time.perf_counter()
        same = {
            "data": enc.data == nat["data"],
            "nlay": enc.nlay == nat["nlay"],
            "deps_vec": enc.deps_vec.tobytes() == nat["deps_vec"].tobytes(),
            "minval_vec": (enc.minval_vec.tobytes()
                           == nat["minval_vec"].tobytes()),
            "len_enc_vec": (enc.len_enc_vec.tobytes()
                            == nat["len_enc_vec"].tobytes()),
            "tolabs": enc.tolabs == nat["tolabs"],
            "midval": enc.midval == nat["midval"],
            "halfspanval": enc.halfspanval == nat["halfspanval"],
            "decode": dec.tobytes() == ndec.tobytes(),
        }
        if not all(same.values()):
            raise AssertionError(f"tol {tol:g}: port differs from the "
                                 f"native codec: {same}")
        # the bench's limit (bench.py:712): the error contract, or twice
        # the native decode's error where round-off dominates (1e-16)
        err = float(np.abs(dec - fld).max())
        bound = max(1.3 * tol * amax, 2.0 * float(np.abs(ndec - fld).max()))
        if not (np.isfinite(dec).all() and dec.shape == fld.shape
                and err <= bound):
            raise AssertionError(f"tol {tol:g}: decode error {err:g} "
                                 f"above {bound:g}")
        log(f"main tol {tol:g}: nlay {enc.nlay}, {enc.ntot_enc} bytes "
            f"(ratio {fld.nbytes / enc.ntot_enc:.3f}), stream and metadata "
            f"byte-identical to native, decode bit-identical, max err "
            f"{err:.3e} <= {bound:.3e}; launches {grown}")

        # Time split of the port's pipeline, stage by stage.
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
        out = Q.decode_step(pd, deps[:nl].clone(), minv[:nl].clone(),
                            fld.shape)
        torch.cuda.synchronize()
        s.append(time.perf_counter())
        out.cpu()
        s.append(time.perf_counter())
        d = np.diff(s)
        split = {"h2d_field_s": d[0], "device_encode_s": d[1],
                 "d2h_planes_s": d[2], "host_entropy_encode_s": d[3],
                 "host_entropy_decode_s": d[4], "h2d_planes_s": d[5],
                 "device_decode_s": d[6], "d2h_field_s": d[7]}
        del x, planes, deps, minv, pd, out
        torch.cuda.empty_cache()
        row = {"tol": tol, "nlay": enc.nlay,
               "ratio": fld.nbytes / enc.ntot_enc,
               "port_encode_s": t_enc, "port_decode_s": t_dec,
               "native_encode_s": t1 - t0, "native_decode_s": t2 - t1,
               "port_encode_gbps": gb / t_enc, "port_decode_gbps": gb / t_dec,
               "native_encode_gbps": gb / (t1 - t0),
               "native_decode_gbps": gb / (t2 - t1), **split}
        rows.append(row)
        log(f"main tol {tol:g} times [{card}]: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_s")
            or k.endswith("_gbps")))
    return launches, rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
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
    times = phase_kernels(card, check)
    launches, rows = phase_main(card)

    replaces = {
        "lift_fwd_axis": "waverange_tpu/ops/wavelet_pallas.py:129; "
                         "waverange_tpu/ops/wavelet_pallas.py:100",
        "lift_inv_axis": "waverange_tpu/ops/wavelet_pallas.py:204",
        "quant_layer": "waverange_tpu/ops/quant_pallas.py:70",
        "accumulate": "waverange_tpu/ops/quant_pallas.py:118",
    }
    source = {"lift_fwd_axis": "waverange_tpu_torch/csrc/lift.cu",
              "lift_inv_axis": "waverange_tpu_torch/csrc/lift.cu",
              "quant_layer": "waverange_tpu_torch/csrc/quant.cu",
              "accumulate": "waverange_tpu_torch/csrc/quant.cu"}
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": check.err[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in replaces]
    log(json.dumps({"card": card, "main_path": rows}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
