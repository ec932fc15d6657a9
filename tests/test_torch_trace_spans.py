"""The serving loop's spans (``serve/trace.py``), on the CPU and, in the
test marked ``cuda``, with CUDA events and graphs on the card (there:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_trace_spans.py``; it skips without a card).

Reduced tinyllama with an eos token, so while segments read their stop flag
every round, served per request and with chunked prefill, traced and not:
every span lies inside its parent, each request's rid is on its queue
wait, on each of its prefill calls (one per chunk) and on every decode call
it rode, the counters at the spans' boundaries add up to the scheduler's
own, tracing never changes a token, and untraced there is no recorder and
no span.  The spans' clock is the profiler's: an op run inside a span lies
inside it on the profiler's stamps.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.trace import READS, now_ns

LENS = [4, 9, 6, 12, 20]
NEWS = [9, 5, 12, 3, 7]
CHUNK = 8
EOS = 7
SLACK_NS = 200_000  # the profiler's stamps against the spans' clock


@pytest.fixture(scope="module")
def engines():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    arch = get_arch("tinyllama-1.1b", reduced=True)
    params = arch.init_params(torch.Generator().manual_seed(0), "cpu")
    made = {trace: ServeEngine(arch, params, ServeConfig(max_len=64, loop="while",
                                                         eos_token=EOS, trace=trace),
                               device="cpu")
            for trace in (False, True)}
    try:
        yield made
    finally:
        torch.set_num_threads(threads)


def serve(eng, chunked: bool):
    """Every request through a scheduler of two slots and while segments;
    (handles, scheduler, the rids of the active slots at each decode call,
    seen from outside the scheduler)."""
    kw = dict(prefill_chunk=CHUNK, prefill_buckets=2) if chunked else {}
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, segment_mode="while", **kw)
    rng = np.random.RandomState(0)
    handles = [sched.submit(rng.randint(0, 256, n).astype(np.int32), m)
               for n, m in zip(LENS, NEWS)]
    calls = []
    segment = eng.slot_segment

    def watched(st, n_steps, mode, active, *args, **kw):
        calls.append({sched.slots[i].rid for i in np.flatnonzero(active)})
        return segment(st, n_steps, mode, active, *args, **kw)

    eng.slot_segment = watched
    try:
        sched.run()
    finally:
        del eng.slot_segment
    return handles, sched, calls


@pytest.fixture(scope="module")
def runs(engines):
    return {(trace, chunked): serve(engines[trace], chunked)
            for trace in (False, True) for chunked in (False, True)}


@pytest.mark.parametrize("chunked", [False, True], ids=["per_request", "chunked"])
def test_spans_nest_inside_their_parents(runs, chunked):
    _, sched, _ = runs[(True, chunked)]
    spans = sched.trace.spans
    by_id = {s.sid: s for s in spans}
    assert len(by_id) == len(spans)
    names = {s.name for s in spans}
    assert {"serve.segment", "serve.admit", "serve.prefill", "serve.first_tokens",
            "serve.decode", "serve.stop_check", "serve.download", "serve.retire",
            "serve.queue"} <= names
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.name in ("serve.segment", "serve.queue"):
            assert s.parent is None, s
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    want = {"serve.admit": "serve.segment", "serve.prefill": "serve.admit",
            "serve.first_tokens": "serve.admit", "serve.decode": "serve.segment",
            "serve.stop_check": "serve.decode", "serve.download": "serve.segment",
            "serve.retire": "serve.segment"}
    for s in spans:
        if s.name in want:
            assert by_id[s.parent].name == want[s.name], s


@pytest.mark.parametrize("chunked", [False, True], ids=["per_request", "chunked"])
def test_each_rid_on_its_queue_prefill_and_decode_spans(runs, chunked):
    handles, sched, calls = runs[(True, chunked)]
    spans = sched.trace.spans
    decode = [s for s in spans if s.name == "serve.decode"]
    assert [set(s.rids) for s in decode] == calls
    for h, n in zip(handles, LENS):
        queue = [s for s in spans if s.name == "serve.queue" and h.rid in s.rids]
        assert [s.rids for s in queue] == [(h.rid,)]
        prefills = [s for s in spans if s.name == "serve.prefill" and h.rid in s.rids]
        assert len(prefills) == (math.ceil(n / CHUNK) if chunked else 1)
        rode = [s for s in decode if h.rid in s.rids]
        assert len(rode) == sum(h.rid in c for c in calls)
        if len(h.tokens) > 1 and h.tokens[0] != EOS:
            assert rode
    pre = [s for s in spans if s.name == "serve.prefill"]
    assert sum(s.attrs["real_tokens"] for s in pre) == sum(LENS)
    admits = [s for s in spans if s.name == "serve.admit"]
    assert sum(s.attrs["real_tokens"] for s in admits) == sum(LENS)
    assert sum(s.attrs["chunks"] for s in admits) == sum(len(s.rids) for s in pre)


@pytest.mark.parametrize("chunked", [False, True], ids=["per_request", "chunked"])
def test_counters_add_up_to_the_schedulers(runs, chunked):
    handles, sched, _ = runs[(True, chunked)]
    tr, st = sched.trace, sched.stats
    spans = tr.spans
    segments = [s for s in spans if s.name == "serve.segment"]
    for span_name, key in READS.items():
        n = sum(s.name == span_name for s in spans)
        assert tr.counts[key] == n == sum(s.attrs[key] for s in segments)
    assert tr.counts["token_downloads"] == st["segments"]
    assert tr.counts["stop_checks"] >= st["segments"]  # from round 1, with an eos
    assert tr.counts["graph_replays"] == 0  # no graphs on the CPU
    decode = [s for s in spans if s.name == "serve.decode"]
    assert sum(s.attrs["rounds"] for s in decode) == st["steps_total"] + st["steps_predicated"]
    assert sum(s.attrs["live_slot_steps"] for s in decode) == st["slot_steps_live"]
    retire = [s for s in spans if s.name == "serve.retire"]
    assert sum(s.attrs["retired"] for s in retire) + sum(
        len(h.tokens) == 1 for h in handles) == st["retired"] == len(LENS)
    summary = tr.span_summary()
    assert summary["decode"]["live_slot_steps"] == st["slot_steps_live"]
    assert summary["decode"]["device_ms"] is None  # no CUDA events on the CPU
    assert summary["prefill"]["real_tokens"] == sum(LENS)
    assert summary["spans"]["serve.queue"]["count"] == len(LENS)
    for row in summary["spans"].values():
        assert 0 <= row["self_ms"] <= row["total_ms"] + 1e-9


@pytest.mark.parametrize("chunked", [False, True], ids=["per_request", "chunked"])
def test_tracing_keeps_the_tokens(runs, chunked):
    off, on = runs[(False, chunked)], runs[(True, chunked)]
    assert [h.tokens for h in on[0]] == [h.tokens for h in off[0]]
    assert on[2] == off[2]


@pytest.mark.parametrize("chunked", [False, True], ids=["per_request", "chunked"])
def test_untraced_has_no_recorder_and_no_span(runs, chunked):
    _, sched, _ = runs[(False, chunked)]
    assert sched.trace is None and sched.state.trace is None


def test_spans_on_the_profilers_clock(runs):
    _, sched, _ = runs[(True, True)]
    tr = sched.trace
    x = torch.arange(4096, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = tr.open("serve.download")
        x.cumsum(0)
        tr.close(sp)
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::cumsum"]
    assert len(ops) == 1
    assert sp.start_ns - SLACK_NS <= ops[0].start_ns() <= ops[0].end_ns() <= sp.end_ns + SLACK_NS
    assert abs(now_ns() - ops[0].end_ns()) < 10**9


def test_clear_spans_starts_a_window(engines):
    """Spans and counters restart; a request queued before the clear still
    gets its queue wait, from its submission."""
    sched = ContinuousScheduler(engines[True], n_slots=1, segment_len=4, segment_mode="while")
    a = sched.submit(np.arange(5, dtype=np.int32), 3)
    b = sched.submit(np.arange(6, dtype=np.int32), 3)
    sched.run_segment()
    t = now_ns()
    sched.trace.clear_spans()
    assert sched.trace.spans == [] and not any(sched.trace.counts.values())
    sched.run()
    queue = [s for s in sched.trace.spans if s.name == "serve.queue"]
    assert [s.rids for s in queue] == [(b.rid,)] and queue[0].start_ns < t
    assert a.done and b.done


def test_a_request_cancelled_in_the_queue_leaves_no_wait(engines):
    sched = ContinuousScheduler(engines[True], n_slots=1, segment_len=4, segment_mode="while")
    handles = [sched.submit(np.arange(n, dtype=np.int32), 3) for n in (5, 6, 7)]
    handles[2].cancel()
    sched.run()
    queue = [s.rids for s in sched.trace.spans if s.name == "serve.queue"]
    assert queue == [(handles[0].rid,), (handles[1].rid,)]
    assert sched.stats["cancelled"] == 1 and not sched.trace._queued


def test_a_preempted_request_waits_again_from_its_eviction(engines):
    """Paged, a pool too small for both residents' growth: each eviction
    puts its request back in the queue, and its readmission closes a second
    ``serve.queue`` span that starts at the eviction."""
    eng = engines[True]
    paged = ServeEngine(eng.arch, eng.params, dataclasses.replace(
        eng.sc, kv_layout="paged", block_len=8, eos_token=-1), device="cpu")
    sched = ContinuousScheduler(paged, n_slots=2, segment_len=4, segment_mode="while",
                                n_blocks=5, overcommit=2.0)
    rng = np.random.RandomState(1)
    handles = [sched.submit(rng.randint(0, 256, n).astype(np.int32), m)
               for n, m in zip(LENS[:4], [20, 8, 16, 4])]
    sched.run()
    assert sched.stats["preemptions"] >= 1 and all(h.done for h in handles)
    queue = [s for s in sched.trace.spans if s.name == "serve.queue"]
    assert len(queue) == len(handles) + sched.stats["readmits"]
    for h in handles:
        waits = [s for s in queue if s.rids == (h.rid,)]
        assert len(waits) == len(h.slot_history)
        assert all(a.end_ns <= b.start_ns for a, b in zip(waits, waits[1:]))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_events_time_every_call_and_replays_count(cuda):
    """On the card, graphs replayed and int8 weights: tracing keeps the
    tokens, every engine call has its device ms, every decode call after
    the first its gap from the previous one, and the graph replays are one
    per prefill call and one per decode round."""
    arch = get_arch("tinyllama-1.1b", reduced=True)
    arch = dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="bfloat16"))
    params = arch.init_params(torch.Generator(device=cuda).manual_seed(0), cuda)
    got = {}
    for trace in (False, True):
        eng = ServeEngine(arch, params, ServeConfig(max_len=64, loop="while", eos_token=EOS,
                                                    weight_quant="int8",
                                                    weight_quant_sparsity=0.5, trace=trace),
                          device=cuda)
        got[trace] = serve(eng, chunked=True)
    assert [h.tokens for h in got[True][0]] == [h.tokens for h in got[False][0]]
    tr = got[True][1].trace
    summary = tr.span_summary()
    calls = [s for s in tr.spans if s.name in ("serve.prefill", "serve.decode")]
    assert calls and all(s.attrs["device_ms"] > 0 for s in calls)
    decode = [s for s in calls if s.name == "serve.decode"]
    assert all(s.attrs["gap_ms"] >= 0 for s in decode[1:]) and "gap_ms" not in decode[0].attrs
    assert tr.counts["graph_replays"] == (summary["prefill"]["calls"]
                                         + summary["decode"]["rounds"])
    assert summary["decode"]["stall_ms"] is not None and summary["decode"]["device_ms"] > 0
