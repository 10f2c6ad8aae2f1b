"""The benchmark (`BENCHMARK.json`, `benchmark/`) on the CPU at 32^3, both
cells: the field generator against the bench's, the correctness gate on the
port's stream and on a stream, a decode, a record and an error that are
wrong, the cell and metric names against BENCHMARK.json, the codec's stage
spans, the per-layer metrics of a trace, and the runner without a card.
The card is asked for only inside tests; on the CPU the runner's functions
run with device="cpu" and report no device metric."""
import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import layers
from benchmark import run as R
from benchmark.field import make_field
from conftest import REPO
from waverange_tpu_torch import bench as TB
from waverange_tpu_torch import utils as U
from waverange_tpu_torch.core import codec as TC
from waverange_tpu_torch.ops import rans

CELLS = ("f64-512-tol1e-16-device-rans", "f64-512-tol1e-10-device-rans")
N = 32
CPU = torch.device("cpu")
STAGES = ("encode.h2d", "encode.step", "encode.entropy", "encode.frame",
          "encode.d2h", "decode.parse", "decode.h2d", "decode.entropy",
          "decode.step", "decode.d2h")
# kernels that benchmark/layers.py does not read yet: I (the device
# framing) came after it; its time shows among the top device operations
NOT_IN_LAYERS = {"rans_frame"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def fld():
    return make_field(N, N, N, seed=0)


@pytest.fixture(scope="module", params=CELLS)
def one_run(request, fld):
    """(traffic, reference, record, decode) of one run of a cell at 32^3."""
    cell, _ = R.load_cell(request.param)
    traffic = cell["traffic"]
    tol = traffic["tolrel"]
    ref = R.reference(fld, tol, traffic)
    enc, dec, _, _ = R.codec_run(fld, tol, traffic, CPU)
    return traffic, ref, enc, dec


@pytest.fixture(scope="module", params=CELLS)
def result(request):
    """A whole cell, run with device="cpu" at 32^3, two timed runs."""
    lines = []
    return request.param, R.run_cell(request.param, device="cpu",
                                     shape=(N, N, N), runs=2,
                                     log=lines.append), lines


# the field ----------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 32, 64])
def test_field_is_the_bench_field(n):
    a, b = make_field(n, n, n, seed=0), TB.make_field(n)
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_field_takes_extents_and_a_seed():
    a = make_field(16, 24, 40, seed=3)
    assert a.shape == (16, 24, 40) and np.isfinite(a).all()
    assert a.tobytes() == make_field(16, 24, 40, seed=3).tobytes()
    assert a.tobytes() != make_field(16, 24, 40, seed=4).tobytes()
    odd = make_field(12, 20, 9, seed=0)
    assert odd.shape == (12, 20, 9) and np.isfinite(odd).all()


# the gate -----------------------------------------------------------------
def test_gate_passes_on_the_ports_stream(one_run, fld):
    traffic, ref, enc, dec = one_run
    g = R.gate(enc, dec, ref, fld)
    assert g["correct"], g["faults"]
    assert g["faults"] == [] and g["max_abs_err"] <= g["limit"]
    assert enc.data == ref["meta"]["data"]
    assert enc.coder_version == R.REF_CODER_VERSION


def _flip_byte(enc, dec, ref):
    data = bytearray(enc.data)
    data[len(data) // 2] ^= 0x01
    return enc.__class__(**{**vars(enc), "data": bytes(data)}), dec, ref


def _flip_value(enc, dec, ref):
    dec = dec.copy()
    i = dec.size // 3
    dec.flat[i] = np.nextafter(dec.flat[i], np.inf)
    return enc, dec, ref


def _change_record(enc, dec, ref):
    deps = enc.deps_vec.copy()
    deps[0] = np.nextafter(deps[0], 0.0)
    return enc.__class__(**{**vars(enc), "deps_vec": deps}), dec, ref


def _other_version(enc, dec, ref):
    return enc.__class__(**{**vars(enc), "coder_version": 31503}), dec, ref


def _tighter_limit(enc, dec, ref):
    return enc, dec, {**ref, "limit": 0.0}


@pytest.mark.parametrize("wrong,fault", [
    (_flip_byte, "stream"), (_flip_value, "decode"),
    (_change_record, "record deps_vec"), (_other_version, "coder_version"),
    (_tighter_limit, "above the limit")],
    ids=["stream-byte", "decoded-value", "record-field", "coder-version",
         "error-limit"])
def test_gate_fails_on_one_wrong_thing(one_run, fld, wrong, fault):
    _, ref, enc, dec = one_run
    g = R.gate(*wrong(enc, dec, ref), fld)
    assert not g["correct"]
    assert len(g["faults"]) == 1 and fault in g["faults"][0], g["faults"]


def test_gate_names_the_first_differing_byte(one_run, fld):
    _, ref, enc, dec = one_run
    data = bytearray(enc.data)
    data[5] ^= 0xFF
    g = R.gate(enc.__class__(**{**vars(enc), "data": bytes(data[:-1])}),
               dec, ref, fld)
    assert "first difference at byte 5" in g["faults"][0]


# BENCHMARK.json -----------------------------------------------------------
def test_cells_and_config_are_the_ones_stated(spec):
    assert [w["name"] for w in spec["workloads"]] == list(CELLS)
    assert [m["name"] for m in spec["metrics"]] == ["encode_GBps",
                                                     "decode_GBps",
                                                     "setup_s"]
    assert [m["better"] for m in spec["metrics"]] == ["higher", "higher",
                                                       "lower"]
    for w, tol in zip(spec["workloads"], (1e-16, 1e-10)):
        assert w["config"] == "cfd-field-512cube-f64" and w["chips"] == 1
        t = w["traffic"]
        assert t["tolrel"] == tol
        assert (t["wtflag"], t["mx"], t["my"], t["mz"]) == (1, 1, 1, 1)
        assert (t["backend"], t["precision"], t["coder"], t["entropy"],
                t["conformance"]) == ("torch", "f64", "rans", "device",
                                      "strict")
        assert t["warmup_runs"] == 1 and t["timed_runs"] >= 10
        assert set(w["bounds"]) == {m["name"] for m in spec["metrics"]}
        for m in spec["metrics"]:
            key = "max_drop" if m["better"] == "higher" else "max_rise"
            assert 0 < w["bounds"][m["name"]][key] < 1
        assert w["command"].endswith(f"--cell {w['name']}")
    assert "benchmark/" in spec["paths"]
    cfg = json.loads((REPO / spec["configs"]["cfd-field-512cube-f64"])
                     .read_text())
    assert cfg["name"] == "cfd-field-512cube-f64"
    assert len(cfg["source"]) <= 200 and "BASELINE.json" in cfg["source"]
    assert cfg["field"]["shape_zyx"] == [512, 512, 512]
    assert cfg["field"]["bytes"] == 512 ** 3 * 8
    assert len(cfg["guarantees"]) == 3 and cfg["reduced"] == []


def test_result_names_match_benchmark_json(result, spec):
    name, r, lines = result
    assert r["cell"] == name and r["config"] == "cfd-field-512cube-f64"
    assert list(r["metrics"]) == [m["name"] for m in spec["metrics"]]
    units = {m["name"]: m["unit"] for m in spec["metrics"]}
    for k, m in r["metrics"].items():
        assert m["unit"] == units[k] and m["value"] > 0
    for k in ("encode_GBps", "decode_GBps"):
        assert r["metrics"][k]["n"] == 2
        c = r["reported"]["per_call"][k]
        assert c["n"] == 2 and c["min"] <= c["median"] <= c["max"]
        assert c["min"] <= r["metrics"][k]["value"] <= c["max"]
    assert r["correct"] and r["faults"] == []
    assert r["layers"]["correct"]
    json.loads(json.dumps(r))
    assert all(line.startswith("[cpu: no card") for line in lines)


def test_cpu_result_reports_no_device_metric(result):
    _, r, lines = result
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                           "nvidia_smi": None}
    assert r["peak_device_bytes"] is None
    lay = r["layers"]
    for k in ("kernels", "copies", "idle_share", "idle_gaps",
              "top_device_ops"):
        assert lay[k] is None
    assert any("device: not measured" in line for line in lines)


def test_profiled_run_records_every_stage_span(result):
    _, r, _ = result
    spans = r["layers"]["spans"]
    assert set(STAGES) | {"encode.torch", "decode.torch"} <= set(spans)
    assert all(spans[s]["count"] == 1 for s in STAGES)
    assert r["reported"]["spans_per_run"] == len(STAGES) + 2


def test_rate_metric_is_the_window_not_a_median():
    """A stall in a few runs moves the window's rate, where the median of
    per-call rates would not see it."""
    secs = [1.0] * 6 + [3.0] * 4
    w = R.window(2.0, secs)
    assert w == {"value": pytest.approx(20 / 18), "unit": "GB/s", "n": 10,
                 "seconds": pytest.approx(18.0)}
    assert R.spread([2.0 / t for t in secs])["median"] == 2.0


def test_setup_leaves_out_the_benchmarks_own_work(result, monkeypatch):
    """setup_s counts from `started`; the reference, the gates and the
    kernels' build are reported apart and not counted."""
    _, r, _ = result
    st = r["reported"]["setup"]
    setup = r["metrics"]["setup_s"]["value"]
    assert setup == pytest.approx(st["field_s"] + st["warmup_s"]
                                  + st["process_s"])
    assert st["field_s"] > 0 and st["warmup_s"] > 0
    assert st["process_s"] >= 0
    nc = st["not_counted"]
    assert nc["reference_s"] > 0 and nc["gate_s"] > 0
    assert nc["kernel_build_s"] == 0  # the CPU builds no kernel
    # a start 5 s earlier adds 5 s; a slower reference adds nothing
    real_ref = R.reference

    def slow_reference(*a):
        time.sleep(0.5)
        return real_ref(*a)

    monkeypatch.setattr(R, "reference", slow_reference)
    t0 = time.perf_counter()
    r2 = R.run_cell(CELLS[1], device="cpu", shape=(16, 16, 16), runs=1,
                    log=lambda m: None, started=t0 - 5.0)
    elapsed = time.perf_counter() - t0
    s2 = r2["metrics"]["setup_s"]["value"]
    assert 5.0 <= s2 <= 5.0 + elapsed - 0.5
    assert r2["reported"]["setup"]["not_counted"]["reference_s"] >= 0.5


def test_process_start_is_before_now():
    age = time.perf_counter() - R.process_start()
    assert 0 < age < 24 * 3600


# the codec's spans --------------------------------------------------------
def test_stage_spans_appear_in_get_timings(fld):
    U.reset_timings()
    enc = TC.encode_field(fld, 1e-10, coder="rans", entropy="device",
                          device="cpu")
    TC.decode_field(enc, entropy="device", device="cpu")
    t = U.get_timings()
    assert set(t) == set(STAGES) | {"encode.torch", "decode.torch"}
    assert all(v["count"] == 1 for v in t.values())
    U.reset_timings()


def test_host_entropy_keeps_one_stage_per_backend(fld):
    U.reset_timings()
    enc = TC.encode_field(fld, 1e-10, coder="rans", device="cpu")
    TC.decode_field(enc, device="cpu")
    assert set(U.get_timings()) == {"encode.torch", "decode.torch"}
    U.reset_timings()


def test_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with U.timed("benchmark.test_span"):
            torch.ones(4).sum()
    assert "benchmark.test_span" in {e.key for e in prof.key_averages()}
    U.reset_timings()


# the per-layer metrics ----------------------------------------------------
def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


TRACE = [
    _x("user_annotation", "encode.torch", 0, 100),
    _x("user_annotation", "encode.h2d", 0, 20),
    _x("user_annotation", "encode.frame", 60, 40),
    _x("user_annotation", "decode.torch", 110, 50),
    _x("gpu_user_annotation", "encode.torch", 0, 100),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2, 15, bytes=1000),
    _x("kernel", "void lift_fwd_pass<double, 1, 2>(double const*)", 20, 5),
    _x("kernel", "void lift_fwd_pass<double, 0, 2>(double const*)", 26, 5),
    _x("kernel", "void at::native::elementwise_kernel<128, 2>()", 32, 4),
    _x("kernel", "rans_decode_kernel(unsigned char const*)", 120, 10),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 140, 15, bytes=500),
]


def test_analyse_a_trace():
    work = {name: 3.35e3 for _, name, _ in layers.KERNELS.values()}
    out = layers.analyse(TRACE, work, {"lift_fwd_axis": 2,
                                       "rans_decode": 1})
    assert out["window_s"] == pytest.approx(160e-6)
    assert out["spans"]["encode.frame"] == {"host_s": pytest.approx(40e-6),
                                            "count": 1}
    a = out["kernels"]["lift_fwd_axis"]
    assert a["launches"] == 2 and a["decode"] is None
    assert a["encode"]["trace_launches"] == 2
    assert a["encode"]["device_ms"] == pytest.approx(0.01)
    # 3.35e3 bytes at 3.35 TB/s: 1e-6 ms
    assert a["encode"]["bandwidth_share"] == pytest.approx(1e-6 / 0.01)
    h = out["kernels"]["rans_decode"]
    assert h["encode"] is None and h["decode"]["trace_launches"] == 1
    assert out["kernels"]["quant_layer"]["encode"] is None
    assert out["copies"]["encode"] == {"HtoD": {
        "device_ms": pytest.approx(0.015), "bytes": 1000, "count": 1}}
    assert out["copies"]["decode"]["DtoH"]["bytes"] == 500
    assert out["kernel_busy_s"] == pytest.approx((5 + 5 + 4 + 10) * 1e-6)
    # busy: 2-17, 20-25, 26-31, 32-36, 120-130, 140-155 of 0-160
    busy = 15 + 5 + 5 + 4 + 10 + 15
    assert out["device_busy_s"] == pytest.approx(busy * 1e-6)
    assert out["idle_share"] == pytest.approx(1 - busy / 160)
    gaps = out["idle_gaps"]
    assert gaps[0] == {"ms": pytest.approx(0.084),
                       "at_ms": pytest.approx(0.036),
                       "span": "encode.frame"}
    assert [g["ms"] for g in gaps] == sorted((g["ms"] for g in gaps),
                                             reverse=True)
    assert gaps[1]["span"] == "decode.torch"
    top = out["top_device_ops"]
    assert top[0]["name"].startswith("Memcpy") and len(top) == 6


def test_gap_between_spans_has_no_span():
    trace = [_x("user_annotation", "encode.torch", 0, 10),
             _x("user_annotation", "decode.torch", 50, 10),
             _x("kernel", "rans_hist_kernel()", 0, 10),
             _x("kernel", "rans_decode_kernel()", 50, 10)]
    out = layers.analyse(trace, {n: 1 for _, n, _ in
                                 layers.KERNELS.values()}, {})
    assert out["idle_gaps"] == [{"ms": pytest.approx(0.04),
                                 "at_ms": pytest.approx(0.01),
                                 "span": "(no span)"}]
    assert out["idle_share"] == pytest.approx(40 / 60)


def test_every_kernel_of_the_port_has_a_trace_name():
    srcs = "".join(p.read_text() for p in
                   (REPO / "waverange_tpu_torch" / "csrc").glob("*.cu"))
    kernels = {ln.split("(")[0].split()[-1] for ln in srcs.splitlines()
               if "(" in ln and ("_pass(" in ln or "_kernel(" in ln)
               and "__global__" not in ln and ln.startswith("    ")}
    assert set(layers.KERNELS) <= kernels
    letters = sorted(row[0] for row in layers.KERNELS.values())
    assert letters == list("ABCDEFGH")
    names = {row[1] for row in layers.KERNELS.values()}
    from waverange_tpu_torch.ops import quant_cuda, rans_cuda, wavelet_cuda
    assert names | NOT_IN_LAYERS == (set(wavelet_cuda.LAUNCHES)
                                     | set(quant_cuda.LAUNCHES)
                                     | set(rans_cuda.LAUNCHES))
    assert not names & NOT_IN_LAYERS


def test_block_stats_agree_with_the_ports_parser(one_run, fld):
    _, _, enc, _ = one_run
    lens = enc.len_enc_vec[:enc.nlay]
    st = layers.block_stats(enc.data, lens, fld.size)
    table = rans.parse_planes(enc.data, lens, fld.size)
    tags = table[:, 0]
    assert st["blocks"] == len(table) == enc.nlay
    assert (st["modeled"], st["raw"], st["const"]) == tuple(
        int((tags == t).sum()) for t in (0, 1, 2))
    assert st["payload"] == int(table[tags == 0, 2].sum())
    with pytest.raises(ValueError, match="tag"):
        layers.block_stats(b"\x07" + enc.data[1:], lens, fld.size)


def test_work_bytes_of_a_512_cube():
    n = 512 ** 3
    blocks = dict(blocks=8 * 2048, payload=10 ** 8)
    w = layers.work_bytes(n, 8, 7 * 10 ** 8, blocks)
    assert w["lift_fwd_axis"] == w["lift_inv_axis"] == 16 * n
    assert w["quant_layer"] == 8 * 17 * n
    assert w["accumulate"] == 16 * n
    assert w["rans_hist"] == 8 * n + 1028 * 16384
    assert w["rans_decode"] == 7 * 10 ** 8 + 24 * 16384 + 8 * n
    # A's bound at 3.35 TB/s: 0.641 ms, PERF.md's
    assert w["lift_fwd_axis"] / layers.HBM_BYTES_S * 1e3 == pytest.approx(
        0.641, abs=1e-3)


# the runner ---------------------------------------------------------------
def test_runner_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--cell",
                        CELLS[0]], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and r.stdout == ""


def test_run_cell_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        R.run_cell(CELLS[0], device="cuda", shape=(16, 16, 16), runs=1)


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit, match="unknown cell"):
        R.main(["--cell", "f64-512-tol1e-3-device-rans"])


def test_main_prints_the_result_last(monkeypatch, capsys, tmp_path):
    """With a card (here the CPU standing in for it), main prints the
    result as its last line, writes it to --out and exits 0."""
    real = R.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(R, "run_cell", lambda name, seed, device, log,
                        started: real(name, seed=seed, device="cpu",
                                      shape=(16, 16, 16), runs=1, log=log,
                                      started=started))
    out = tmp_path / "r.json"
    assert R.main(["--cell", CELLS[1], "--seed", "2", "--out",
                   str(out)]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    r = json.loads(last)
    assert r["cell"] == CELLS[1] and r["seed"] == 2 and r["correct"]
    assert json.loads(out.read_text()) == r


def test_benchmark_imports_only_the_frozen_native_of_the_jax_package():
    for path in sorted((REPO / "benchmark").glob("*.py")):
        mods = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.update(f"{node.module}.{a.name}" for a in node.names)
        bad = {m for m in mods if m.split(".")[0] in ("jax", "jaxlib")
               or (m.startswith("waverange_tpu.") and
                   m != "waverange_tpu.native")}
        assert not bad, f"{path.name} imports {sorted(bad)}"


# the summary of invocations -------------------------------------------------
def test_summary_of_cpu_invocations(result):
    from benchmark import summary
    name, r, _ = result
    slower = json.loads(json.dumps(r))
    slower["metrics"]["encode_GBps"]["value"] *= 0.9
    slower["metrics"]["setup_s"]["value"] *= 1.25
    s = summary.summarize([r, slower])[name]
    assert s["invocations"] == 2 and s["correct"]
    assert s["encode_GBps"]["spread"] == pytest.approx(0.1)
    assert s["decode_GBps"]["spread"] == 0
    assert s["setup_s"]["spread"] == pytest.approx(0.25)
    assert s["device"] == ["cpu"] and "kernels" not in s
    assert set(STAGES) <= set(s["spans_s"])
    assert s["peak_device_bytes"] is None


def test_summary_of_device_invocations(capsys, tmp_path):
    from benchmark import summary
    work = {name: 3.35e3 for _, name, _ in layers.KERNELS.values()}
    lay = layers.analyse(TRACE, work, {})
    results = []
    for enc, dec, setup in [(0.7, 1.4, 20.0), (0.75, 1.3, 24.0),
                            (0.72, 1.5, 21.0)]:
        results.append({
            "cell": CELLS[0], "correct": True, "peak_device_bytes": 3 << 30,
            "device": {"nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
            "metrics": {"encode_GBps": {"value": enc},
                        "decode_GBps": {"value": dec},
                        "setup_s": {"value": setup}},
            "layers": lay})
    s = summary.summarize(results)[CELLS[0]]
    assert s["encode_GBps"]["values"] == [0.7, 0.75, 0.72]
    assert s["encode_GBps"]["spread"] == pytest.approx(0.05 / 0.75)
    assert s["decode_GBps"]["spread"] == pytest.approx(0.2 / 1.5)
    # lower is better: the largest rise, over the smallest value
    assert s["setup_s"]["spread"] == pytest.approx(4 / 20)
    assert s["kernels"]["lift_fwd_axis (encode)"]["launches"] == 2
    assert s["kernels"]["rans_decode (decode)"]["device_ms"] == \
        pytest.approx(0.01)
    assert s["copies_ms"] == {"HtoD (encode)": pytest.approx(0.015),
                              "DtoH (decode)": pytest.approx(0.015)}
    assert s["idle_share"] == pytest.approx(lay["idle_share"])
    assert s["peak_device_bytes"] == 3 << 30
    paths = []
    for i, r in enumerate(results):
        paths.append(tmp_path / f"r{i}.json")
        paths[-1].write_text(json.dumps(r))
    assert summary.main([str(p) for p in paths]) == 0
    assert json.loads(capsys.readouterr().out)[CELLS[0]]["invocations"] == 3
