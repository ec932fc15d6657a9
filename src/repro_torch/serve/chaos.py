"""Deterministic fault injection for the continuous scheduler.

The port of ``repro.serve.chaos``, whole.

``ChaosConfig`` drives seeded chaos hooks inside
``ContinuousScheduler.run_segment`` — every injection draws from one
``numpy.random.RandomState(seed)`` stream owned by the scheduler, so a
failing stress case replays exactly from its seed:

    exhaust_at / exhaust_prob   hide every currently-free block from the
                                on-demand growth pass for one segment, so
                                active slots that cross a block boundary
                                must preempt a victim to proceed (the hold
                                is dropped if no evictable victim remains —
                                forced exhaustion never deadlocks)
    cancel_prob                 call ``Request.cancel()`` on one random
                                non-terminal request (queued or resident)
    slot_fail_prob              preempt one random occupied slot — the
                                artificial "slot-step failure": the request
                                is retired from its slot and requeued, then
                                readmitted via recompute (or swap)

Probabilities are per-segment.  The hooks only mutate host-side policy
(queue order, block holds, cancel flags), so every chaos schedule keeps the
bit-identical-greedy contract for the requests that survive to completion.

The ``http_*`` knobs extend the same config to the network layer —
they are consumed by the HTTP chaos *client* harness (misbehaving clients
hammering a real ``FrontDoor``), not by the scheduler:

    http_slow_reader_prob       a client that stalls ``http_slow_reader_s``
                                between SSE reads, backing the socket up
    http_disconnect_prob        a client that drops the connection
                                mid-stream (the server must cancel + reclaim)
    http_malformed_prob         a client that sends a garbage frame instead
                                of a well-formed request

``enabled`` reports only the scheduler-side knobs (the scheduler ignores
the HTTP ones); ``http_enabled`` reports the client-side set.
"""
from __future__ import annotations

import dataclasses

_SCHED_PROBS = ("exhaust_prob", "cancel_prob", "slot_fail_prob")
_HTTP_PROBS = ("http_slow_reader_prob", "http_disconnect_prob",
               "http_malformed_prob")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault-injection knobs (all off by default)."""

    seed: int = 0
    exhaust_at: tuple[int, ...] = ()  # segment indices to force-exhaust
    exhaust_prob: float = 0.0
    cancel_prob: float = 0.0
    slot_fail_prob: float = 0.0
    # HTTP-layer client misbehavior (per-request draws in the chaos client)
    http_slow_reader_prob: float = 0.0
    http_slow_reader_s: float = 0.2  # stall between reads for slow readers
    http_disconnect_prob: float = 0.0
    http_malformed_prob: float = 0.0

    def __post_init__(self):
        for name in _SCHED_PROBS + _HTTP_PROBS:
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if any(s < 0 for s in self.exhaust_at):
            raise ValueError(f"exhaust_at indices must be >= 0: {self.exhaust_at}")
        if self.http_slow_reader_s < 0:
            raise ValueError(
                f"http_slow_reader_s must be >= 0, got {self.http_slow_reader_s}")

    @property
    def enabled(self) -> bool:
        return bool(self.exhaust_at) or any(
            getattr(self, n) > 0 for n in _SCHED_PROBS)

    @property
    def http_enabled(self) -> bool:
        return any(getattr(self, n) > 0 for n in _HTTP_PROBS)
