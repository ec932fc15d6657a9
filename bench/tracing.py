"""Spans and device timing recorded from the benchmark's side of the calls
into the program (the traced run only; the untraced run installs nothing).

``Recorder.install`` wraps, on the live objects, the engine's two timed
programs (``prefill_slots``: one chunked-prefill launch; ``slot_segment``:
one decode segment of graph replays) and the scheduler's admit round.
Each wrapped call is a ``torch.profiler`` range named ``bench.<span>``,
timed by CUDA events on the current stream and by the host clock up to a
synchronize at its end (the scheduler downloads each call's result right
after it, so the synchronize moves no work).  The host loop adds
``bench.submit`` and ``bench.wait`` ranges.  The problem's operations and bytes
behind each call's roofline come from the configuration's family file
(``bench/families/``).

``reduce_profile`` reads the raw device events of the profiled slice: the
union of their intervals (busy time), the int8 kernels' time inside the
decode and prefill ranges, the kernels that took most time, and the idle
gaps labelled by the innermost ``bench.`` range the host was in.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

from bench import families
from bench import roofline as R

INT8_MARK = "Int8Scale"  # the int8 weight policy in both int8 kernels' names
NAME_CHARS = 160  # a device operation's name in the breakdown, cut to this


class Recorder:
    def __init__(self, model: dict, device: torch.device):
        self.model, self.device = model, device
        self.family = families.load(model)
        self.cuda = device.type == "cuda"
        self.profiling = False  # set by the host loop around the profiled slice
        self.calls: list[dict] = []  # one per wrapped program call

    @contextlib.contextmanager
    def span(self, name: str):
        with record_function(f"bench.{name}"):
            yield

    def _timed(self, kind: str, fn, *args, **kw):
        with record_function(f"bench.{kind}"):
            ev = None
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self.cuda:
                ev[1].record()
                torch.cuda.synchronize(self.device)
            host = time.perf_counter() - t0
        call = {"kind": kind, "events": ev, "host_s": host, "traced": self.profiling}
        self.calls.append(call)
        return out, call

    def traced_kinds(self) -> set[str]:
        """The kinds of call the profiled slice holds so far."""
        return {c["kind"] for c in self.calls if c["traced"]}

    def install(self, eng, sched) -> None:
        model, fam, rec = self.model, self.family, self

        prefill_slots, slot_segment, admit = eng.prefill_slots, eng.slot_segment, sched._admit

        def traced_prefill(st, prompts, slots, starts, last_local, bt_rows=None):
            out, call = rec._timed("prefill", prefill_slots, st, prompts, slots, starts,
                                   last_local, bt_rows)
            rows = []
            for slot, start, last in zip(slots, starts, last_local):
                if slot < st.n_slots:
                    real = int(last) + 1
                    final = int(start) + real >= len(sched._prefix[int(slot)])
                    rows.append((int(start), real, final))
            w, cb = prompts.shape
            call.update(real_tokens=sum(r for _, r, _ in rows),
                        roofline_s=R.bound_s(*fam.prefill_chunk(model, rows)),
                        int8_bound_s=fam.int8_step_bound_s(model, w * cb))
            return out

        def traced_segment(st, n_steps, mode, active, limit, stop_on_free=False,
                           block_table=None):
            ctx0 = {i: req.prompt_len + len(req.tokens) for i, req in enumerate(sched.slots)
                    if req is not None and active[i]}
            out, call = rec._timed("decode", slot_segment, st, n_steps, mode, active, limit,
                                   stop_on_free, block_table)
            toks = out.cpu().numpy()
            seen = defaultdict(int)
            roof = 0.0
            for r in range(toks.shape[1]):
                ctxs = []
                for i in ctx0:
                    if toks[i, r] >= 0:
                        ctxs.append(ctx0[i] + seen[i])
                        seen[i] += 1
                if ctxs:
                    roof += R.bound_s(*fam.decode_step(model, ctxs))
            call.update(steps=toks.shape[1], roofline_s=roof,
                        int8_bound_s=toks.shape[1] * fam.int8_step_bound_s(model, st.n_slots))
            return out

        def traced_admit():
            with record_function("bench.admit"):
                return admit()

        eng.prefill_slots, eng.slot_segment, sched._admit = (traced_prefill, traced_segment,
                                                             traced_admit)

    def summary(self) -> dict:
        """Totals by kind over the whole window: device ms (CUDA events),
        host seconds, steps or real prompt tokens, roofline seconds."""
        out = {}
        for kind in ("decode", "prefill"):
            calls = [c for c in self.calls if c["kind"] == kind]
            out[kind] = {
                "calls": len(calls),
                "device_ms": (sum(c["events"][0].elapsed_time(c["events"][1]) for c in calls)
                              if self.cuda else None),
                "host_s": sum(c["host_s"] for c in calls),
                "roofline_s": sum(c["roofline_s"] for c in calls),
                "steps": sum(c.get("steps", 0) for c in calls),
                "real_tokens": sum(c.get("real_tokens", 0) for c in calls),
                "traced_int8_bound_s": sum(c["int8_bound_s"] for c in calls if c["traced"]),
            }
        return out


def _merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _timeline(ranges: list[tuple[int, int, str]]) -> tuple[list[int], list[str]]:
    """Change points of the innermost range over time, from ranges that
    nest (one host thread): (times, label from that time on)."""
    points = sorted([(s, 1, -(e - s), n) for s, e, n in ranges]
                    + [(e, 0, 0, n) for s, e, n in ranges])
    times, labels, stack = [], [], []
    for t, opening, _, name in points:
        if opening:
            stack.append(name)
        elif name in stack:  # the latest open range of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        times.append(t)
        labels.append(stack[-1] if stack else "bench.other")
    return times, labels


def reduce_profile(prof) -> dict:
    """Busy and window seconds, the int8 kernels' seconds by range kind, the
    top device operations and the idle gaps by host range, from the raw
    events of one profiled slice (``key_averages`` is far too slow over a
    slice's hundreds of thousands of kernels)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, ranges = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU and e.name().startswith("bench."):
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
    window = [r for r in ranges if r[2] == "bench.traced"]
    if not window or not device:
        return {}
    w0, w1 = window[0][0], window[0][1]
    ranges = [r for r in ranges if r[2] != "bench.traced"]
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _merged([(s, e) for s, e, _ in device])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, float] = defaultdict(float)
    for s, e, n in device:
        by_name[n[:NAME_CHARS]] += (e - s) / 1e9
    # int8 kernels inside decode and prefill ranges
    spans = sorted((s, e, n) for s, e, n in ranges if n in ("bench.decode", "bench.prefill"))
    starts = [s for s, _, _ in spans]
    int8 = {"bench.decode": 0.0, "bench.prefill": 0.0}
    for s, e, n in device:
        if INT8_MARK not in n:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            int8[spans[i][2]] += (e - s) / 1e9
    gaps: dict[str, float] = defaultdict(float)
    times, labels = _timeline(ranges)
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            i = bisect.bisect_right(times, e0) - 1
            gaps[labels[i] if i >= 0 else "bench.other"] += (s1 - e0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "int8_decode_s": int8["bench.decode"], "int8_prefill_s": int8["bench.prefill"],
            "device_ops": top(by_name), "idle_gaps": top(gaps)}
