"""The port's own spans (``repro_torch.serve.trace``) laid over a traced run:
the readers of two per-layer metrics, and the idle time of a profiled slice
by the span the host was in.

A run traced by the port (``ServeConfig(trace=True)``) gives
``TraceRecorder.span_summary()``, here ``data["program"]``: its decode
calls' device stall and live slot-steps, and every span's (start ns, end
ns, name) on the profiler's clock.  :func:`idle_by_span` splits each idle
gap of the slice over the innermost range the host was in while it lasted;
over the port's spans and the harness's ``bench.`` ranges together, it is
``data["profile"]["idle_by_span"]``.  The harness's wrappers sit between
the scheduler and the engine, so idle during their own work (a
synchronize, the rooflines' arithmetic) falls to a ``bench.`` range and
not to the ``serve.`` span around it.  Each reader returns None where
``data`` has no ``"program"`` (a run the port did not trace).
"""
from __future__ import annotations

import bisect

from bench.tracing import _merged, _timeline

OUTSIDE = "outside"  # no range open: the harness's own loop


def idle_by_span(device: list[tuple[int, int]], w0: int, w1: int,
                 ranges: list[tuple[int, int, str]]) -> dict[str, float]:
    """Seconds of ``[w0, w1]`` in which no ``device`` interval ran, by the
    innermost of the host's nested ``ranges`` (start, end, name) at each
    moment of it; ``OUTSIDE`` where none was open.  The values sum to the
    slice's idle seconds."""
    busy = _merged([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
    times, labels = _timeline(ranges) if ranges else ([], [])
    out: dict[str, float] = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, t), (end, _) in zip(edges, edges[1:]):
        i = bisect.bisect_right(times, t) - 1
        while t < end:
            nxt = times[i + 1] if i + 1 < len(times) else end
            label = labels[i] if i >= 0 and labels[i] != "bench.other" else OUTSIDE
            piece = min(nxt, end) - t
            if piece > 0:
                out[label] = out.get(label, 0.0) + piece / 1e9
            t, i = max(t, min(nxt, end)), i + 1
    return out


def profile_intervals(prof) -> tuple[list[tuple[int, int]], int, int, list[tuple[int, int, str]]]:
    """From a slice ``bench.harness.Window`` profiled: the device
    operations' (start, end) ns, the slice's bounds (its ``bench.traced``
    range) and the harness's other ``bench.`` ranges, as
    ``bench.tracing.reduce_profile`` reads them."""
    from torch.autograd import DeviceType

    device, ranges, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU and e.name().startswith("bench."):
            if e.name() == "bench.traced":
                window = (e.start_ns(), e.end_ns())
            else:
                ranges.append((e.start_ns(), e.end_ns(), e.name()))
    if window is None:
        raise ValueError("the profile holds no bench.traced range")
    return device, window[0], window[1], ranges


def decode_stall_ms(data: dict) -> float | None:
    """Device ms between consecutive decode calls, each gap weighted by the
    requests active in both, per live slot-step of the decode calls: the
    wait each emitted token carried for the admission, prefill and host
    work between segments."""
    d = (data.get("program") or {}).get("decode") or {}
    if d.get("stall_ms") is None or not d.get("live_slot_steps"):
        return None
    return d["stall_ms"] / d["live_slot_steps"]


def host_idle_share(data: dict) -> float | None:
    """Percent of the profiled slice in which no device operation ran while
    the host was inside a ``serve.`` span (its innermost range): the part
    of ``idle_share`` that the port's own host code causes."""
    if "program" not in data:
        return None
    p = data.get("profile") or {}
    if not p.get("window_s") or p.get("idle_by_span") is None:
        return None
    serve = sum(v for k, v in p["idle_by_span"].items() if k.startswith("serve."))
    return 100.0 * serve / p["window_s"]
