"""Request objects for the continuous-batching scheduler.

The port of ``repro.serve.request``, whole.

``SubmitRequest`` is what a client hands to ``ContinuousScheduler.submit``;
the scheduler wraps it in a live ``Request`` handle whose ``tokens`` list
grows as segments complete (streaming: ``on_token`` fires once per generated
token, in order, including the prefill-sampled first token).

Terminal states: ``finished`` (budget reached or eos), ``cancelled``
(``Request.cancel()`` honored by the scheduler within one segment), and
``expired`` (a TTFT or total deadline passed).  Cancelled/expired requests
keep whatever tokens they had streamed; their slot and KV blocks return to
the pool at the sweep that retires them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
CANCELLED = "cancelled"
EXPIRED = "expired"

TERMINAL_STATES = (FINISHED, CANCELLED, EXPIRED)


@dataclasses.dataclass
class SubmitRequest:
    """Client-side submission: a prompt, a generation budget, and optional
    latency bounds (seconds from submit; ``None`` = unbounded)."""

    prompt: Sequence[int] | np.ndarray
    max_new_tokens: int
    on_token: Callable[["Request", int], None] | None = None
    ttft_deadline_s: float | None = None  # submit → first token
    deadline_s: float | None = None  # submit → last token
    # multi-tenant routing: both default through the scheduler's
    # TenantPolicy when one is installed ("default" tenant / the tenant's
    # default priority class), and are plain labels without one
    tenant: str | None = None
    priority: str | None = None


@dataclasses.dataclass
class Request:
    """Live handle: state, streamed tokens, and host-side timing."""

    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    on_token: Callable[["Request", int], None] | None = None
    state: str = QUEUED
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot_history: list[int] = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float | None = None
    finish_t: float | None = None
    # latency bounds (None = unbounded); checked by the scheduler's
    # terminal sweep at every segment boundary
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None
    cancel_requested: bool = False
    # multi-tenant routing (resolved at submit; see TenantPolicy)
    tenant: str = "default"
    priority: str = "standard"
    # why the request stopped: "stop" (eos), "length" (budget),
    # "cancelled", or "expired"; None until terminal
    finish_reason: str | None = None
    # preemption accounting: times evicted mid-flight, and when the last
    # eviction happened (cleared at the first post-readmit emission — the
    # scheduler uses the gap as the readmit TTFT penalty)
    preempts: int = 0
    preempt_t: float | None = None
    # host-side KV payload for preempt_mode="swap" (paged only): the live
    # cache blocks copied to host tensors (pinned when the cache is on the
    # card) at eviction, copied back at readmission
    _swap: Any = None
    _swap_nb: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    @property
    def terminal(self) -> bool:
        """Finished, cancelled, or expired — no further tokens will arrive."""
        return self.state in TERMINAL_STATES

    @property
    def cancelled(self) -> bool:
        return self.state == CANCELLED

    @property
    def expired(self) -> bool:
        return self.state == EXPIRED

    @property
    def latency(self) -> float | None:
        """Submit → last token (None until finished)."""
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def ttft(self) -> float | None:
        """Submit → first token (None until prefilled)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    def cancel(self) -> None:
        """Request cooperative cancellation.  The scheduler honors it at the
        next segment boundary: the request reaches state ``cancelled``, its
        slot and KV blocks are released, and already-streamed tokens stay on
        the handle.  No-op once the request is terminal."""
        if not self.terminal:
            self.cancel_requested = True

    def _emit(self, token: int) -> None:
        self.tokens.append(token)
        if self.on_token is not None:
            self.on_token(self, token)
