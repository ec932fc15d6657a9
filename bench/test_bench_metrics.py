"""The per-layer metrics' arithmetic on a synthetic record, their files
against BENCHMARK.json, and the profile reduction's interval helpers."""
import json

import pytest

from bench import harness, metrics, tracing
from bench.cells import HERE

DATA = {
    "stats": {"admit_time_s": 0.5, "admit_rounds": 20, "slot_steps_live": 300,
              "slot_steps_masked": 100},
    "spans": {"decode": {"calls": 10, "device_ms": 1600.0, "host_s": 1.7, "roofline_s": 0.17,
                         "steps": 100, "real_tokens": 0, "traced_int8_bound_s": 0.05},
              "prefill": {"calls": 5, "device_ms": 300.0, "host_s": 0.31, "roofline_s": 0.031,
                          "steps": 0, "real_tokens": 1000, "traced_int8_bound_s": 0.02}},
    "profile": {"busy_s": 2.7, "window_s": 3.0, "int8_decode_s": 0.2, "int8_prefill_s": 0.08},
}
WANT = {"admit_ms": 25.0, "masked_share": 25.0, "decode_step_ms": 16.0,
        "prefill_ms_per_ktok": 300.0, "int8_decode_roofline": 25.0,
        "int8_prefill_roofline": 25.0, "mfu.decode": 10.0, "mfu.prefill": 10.0,
        "idle_share": 10.0}


def test_readers_on_a_synthetic_record():
    got = {name: v for name, _, v in metrics.read_all(DATA)}
    assert got == pytest.approx(WANT)


def test_readers_that_find_nothing_return_nothing():
    empty = {"stats": {}, "spans": None, "profile": {}}
    assert metrics.read_all(empty) == []


def test_metric_files_match_benchmark_json():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    files = {m.NAME: m for m in metrics.load()}
    assert set(declared) == set(files)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for name, mod in files.items():
        d = declared[name]
        assert (d["unit"], d["better"], d["layer"], d["source"], d["moves"]) == (
            mod.UNIT, mod.BETTER, mod.LAYER, mod.SOURCE, mod.MOVES)
        assert mod.MOVES in e2e


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert harness._percentile(vals, 0.9) == 90
    assert harness._percentile([5.0, float("inf")], 0.9) == float("inf")


def test_interval_helpers():
    assert tracing._merged([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    times, labels = tracing._timeline([(0, 100, "bench.run"), (10, 20, "bench.admit"),
                                       (30, 40, "bench.decode")])
    at = dict(zip(times, labels))
    assert at[10] == "bench.admit" and at[20] == "bench.run" and at[40] == "bench.run"
    assert at[100] == "bench.other"


def test_cells_report_what_benchmark_json_declares():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    from bench import cells
    for w in bench["workloads"]:
        want = [m["name"] for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert sorted(cells.load(w["name"]).spec["end_to_end"]) == sorted(want)
    for m in bench["per_layer"]:
        reported = [w["name"] for w in bench["workloads"]
                    if m["moves"] in cells.load(w["name"]).spec["end_to_end"]]
        assert set(m.get("workloads", reported)) == set(reported) and reported


def test_readers_keep_to_the_cells_end_to_end_metrics():
    got = {name for name, _, _ in metrics.read_all(DATA, ["tpot_p90_ms", "setup_s"])}
    assert got == set(WANT) - {"idle_share"}
