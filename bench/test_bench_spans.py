"""The readers of the port's spans (``spans.py``) on a synthetic record with
values worked by hand, and the idle time of a slice by innermost span on
synthetic intervals: the pieces add up to the slice's idle seconds."""
import pytest

from bench import spans

MS = 1_000_000  # ns

# host nesting on one thread (ms): a segment 0–100 holding an admit round
# 0–40 (its prefill call 5–30 inside the harness's wrapper 5–35) and a
# decode call 45–95 (its stop check 80–90); the harness alone after 100
HOST = [(0, 100 * MS, "serve.segment"), (0, 40 * MS, "serve.admit"),
        (5 * MS, 35 * MS, "bench.prefill"), (5 * MS, 30 * MS, "serve.prefill"),
        (45 * MS, 95 * MS, "serve.decode"), (80 * MS, 90 * MS, "serve.stop_check")]
# the card busy 10–32 and 50–82 and 130–150 ms of a slice 0–160 ms
DEVICE = [(10 * MS, 20 * MS), (15 * MS, 32 * MS), (50 * MS, 82 * MS), (130 * MS, 150 * MS)]


def test_idle_split_by_innermost_span():
    got = spans.idle_by_span(DEVICE, 0, 160 * MS, HOST)
    # idle 0–10 (5 in the segment's admit, 5 in the prefill call), 32–50
    # (3 wrapper, 5 admit, 5 segment, 5 decode), 82–130 (8 stop check,
    # 5 decode, 5 segment, 30 outside), 150–160 (outside)
    want = {"serve.admit": 0.010, "serve.prefill": 0.005, "bench.prefill": 0.003,
            "serve.segment": 0.010, "serve.decode": 0.010, "serve.stop_check": 0.008,
            "outside": 0.040}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(0.160 - 0.074)


def test_idle_split_clips_to_the_slice_and_sums_to_its_idle():
    got = spans.idle_by_span(DEVICE, 20 * MS, 140 * MS, HOST)
    busy = 12 + 32 + 10  # ms of the busy intervals inside 20–140
    assert sum(got.values()) == pytest.approx((120 - busy) / 1e3)
    assert spans.idle_by_span([], 0, 10 * MS, []) == {"outside": pytest.approx(0.010)}


DATA = {
    "stats": {},
    "spans": {},
    "profile": {"busy_s": 2.7, "window_s": 3.0,
                "idle_by_span": {"serve.segment": 0.06, "serve.decode": 0.03,
                                 "bench.decode": 0.12, "outside": 0.09}},
    # 4 decode calls of 16, 16, 8 and 16 rounds on 2, 2, 3 and 3 live
    # slots (32 + 32 + 24 + 48 = 136 live slot-steps); gaps 5, 12 and 4 ms
    # with 2, 1 and 3 requests in both calls: 10 + 12 + 12 = 34 ms
    "program": {"decode": {"calls": 4, "rounds": 56, "live_slot_steps": 136,
                           "device_ms": 1400.0, "stall_ms": 34.0}},
}


def test_readers_on_a_synthetic_record():
    assert spans.decode_stall_ms(DATA) == pytest.approx(34.0 / 136)
    assert spans.host_idle_share(DATA) == pytest.approx(100 * 0.09 / 3.0)


def test_readers_without_the_ports_spans_return_nothing():
    bare = {k: v for k, v in DATA.items() if k != "program"}
    assert spans.decode_stall_ms(bare) is None
    assert spans.host_idle_share(bare) is None
    cpu = {**DATA, "program": {"decode": {"live_slot_steps": 136, "stall_ms": None}}}
    assert spans.decode_stall_ms(cpu) is None
