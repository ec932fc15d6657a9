"""Continuous-batching scheduler: a slot-based KV cache over the slot
programs of ``ServeEngine``.

The port of ``repro.serve.scheduler``, whole (``BlockAllocator`` and
``ContinuousScheduler`` with its tenant policy, SLO controller step, trace
hooks and drain predictor).  The device never sees requests: it
sees a fixed-capacity slot state (``engine.SlotState``) that every slot
program updates in place, at fixed addresses, so the programs replay as
CUDA graphs on the card:

    cache  slot cache, one axis-1 row per slot, or the paged pool  [device]
    tok    (n_slots,) last sampled token per slot                  [device]
    pos    (n_slots,) next cache write position (per-slot offsets) [device]
    done   (n_slots,) emitted eos or hit its write limit           [device]
    active (n_slots,) slot holds a live request                    [host]
    limit  (n_slots,) last write position = prompt_len + max_new − 1 [host]

Between segments the host scheduler, as in the reference:

    admit   pop queued requests into free slots.  Default: one
            ``prefill_slot`` per request at its own prompt length.  With
            ``prefill_chunk > 0``: prompts split into ``prefill_chunk``
            chunks carried across admit rounds, the final chunk padded up
            to a geometric bucket set, and each round's same-bucket chunks
            sharing one fixed-width ``prefill_slots`` launch.  Either way
            the first tokens stream after one bundled download per round
    run     one segment = ``segment_len`` masked decode steps for every
            slot ("while": as many as the host's budgets say it can take
            before it stops, ``_while_steps``; an eos stops it sooner on
            the device); the only per-segment download is the (n_slots,
            segment_len) token block
    retire  finished slots (eos or budget, both read from the token block)
            stream their tokens, record latency, and free their row

Paged KV (``ServeConfig.kv_layout="paged"``): a pool of ``block_len``
blocks plus a host ``(n_slots, max_blocks_per_slot)`` block table uploaded
with each program call; ``BlockAllocator`` is the free list, physical ids
0..n_slots−1 are per-slot scratch.  Admission maps the prompt's blocks and
gates on commitment (Σ full budgets of the residents and the head ≤
``overcommit`` × capacity); ``_ensure_segment_capacity`` grows each slot
before a segment and, when the pool runs dry (overcommit > 1, or a chaos
exhaustion hold), preempts victims (least progress first, ties evict the
latest arrival, the most progressed never), which readmit by recompute
(re-prefill of the prompt alone, then the emitted tokens replayed through
ordinary decode segments, the host consuming the duplicates) or by swap
(``preempt_mode="swap"``: the live blocks copied to host memory and back).
``Request.cancel()`` and TTFT / total deadlines retire requests at the
next segment boundary; ``ChaosConfig`` injects seeded pool exhaustion,
cancellations and slot failures.

Speculative decoding (``ServeConfig.spec``): segments become
draft-and-verify rounds (``ServeEngine.spec_segment``) emitting 1..k+1
tokens per live slot per round, an (n_slots, segment_len, k+1) block whose
per-round counts feed ``stats["accepted_hist"]`` and which flattens
row-major into the per-slot stream the host consumes as before (the
device's acceptance already enforces eos and budgets).  Requests need
``spec.k`` positions of max_len headroom (and of mapped blocks, paged) for
the rejected tail the cursor rollback truncates.

Multi-tenant admission (``policy=TenantPolicy(...)``, ``serve/policy.py``):
``submit`` routes tenants and priority classes through it (brownout shed →
``Overloaded``, token bucket → ``RateLimited``), admission takes its DRR
pick instead of the FIFO head, classes cap chunks and token budgets, the
victim order ranks by class first, and ``run_segment`` steps its brownout
controller once per segment.  All of it reads host state only
(``Request.tokens``, ``slots``, ``queue``): no device sync is added.

With ``ServeConfig.trace`` the scheduler owns a ``serve.trace.TraceRecorder``,
fed at every launch site and handed to its slot state, through which the
engine records its calls: spans of each segment, admit round, prefill and
decode call, stop-flag read, download and retirement and of each request's
wait in the queue, on the clock ``torch.profiler`` stamps its events with,
and on the card a CUDA event before and after each engine call.  They add
no device sync and no host read of the device; the events are read after
the run (``TraceRecorder.span_summary``).  Without it ``trace`` is ``None``
and each site is one ``is not None`` check.

Greedy outputs equal ``ServeEngine.generate``'s at B = 1 bit for bit, under
either layout and either admission path, preempted or not, speculating or
not.  Temperature
sampling draws from one ``torch.Generator`` on the engine's device, seeded
with ``seed`` and registered with every graph.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.serve.chaos import ChaosConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.policy import Overloaded, RateLimited, TenantPolicy
from repro_torch.serve.request import (CANCELLED, EXPIRED, FINISHED, QUEUED,
                                       RUNNING, Request, SubmitRequest)
from repro_torch.utils.logging import get_logger

log = get_logger("serve.scheduler")


class BlockAllocator:
    """Host-side free-list over physical KV blocks ``first_block`` ..
    ``first_block + n_blocks − 1`` (ids below ``first_block`` are the
    per-slot scratch blocks and are never allocated).

    Blocks are interchangeable, so there is no fragmentation: ``alloc``
    succeeds iff enough blocks are free.  ``mapped`` tracks slot → blocks so
    the stress suite can assert the no-double-mapping invariant after every
    segment (``ContinuousScheduler.check_block_invariants``).  ``grow``
    appends blocks to an existing mapping — the on-demand growth path: a
    slot acquires blocks as its cursor crosses block boundaries instead of
    its whole budget at admission.  Misuse (alloc beyond the free list,
    double-map, grow/release of an unmapped slot) raises rather than
    corrupting the free list.
    """

    def __init__(self, n_blocks: int, first_block: int = 1):
        assert n_blocks >= 1 and first_block >= 1, (n_blocks, first_block)
        self.capacity = n_blocks
        self.first_block = first_block
        self.free: collections.deque[int] = collections.deque(
            range(first_block, first_block + n_blocks)
        )
        self.mapped: dict[int, list[int]] = {}  # slot -> physical block ids

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_mapped(self) -> int:
        return sum(len(b) for b in self.mapped.values())

    def can_alloc(self, n: int) -> bool:
        return n <= len(self.free)

    def alloc(self, slot: int, n: int) -> list[int]:
        """Map ``n`` blocks to ``slot``; raises ``ValueError`` if it already
        holds blocks or the pool is short (callers gate on ``can_alloc``)."""
        if slot in self.mapped:
            raise ValueError(
                f"slot {slot} already holds {len(self.mapped[slot])} blocks "
                f"(grow() extends an existing mapping)"
            )
        if not self.can_alloc(n):
            raise ValueError(
                f"alloc(slot={slot}, n={n}): only {len(self.free)} of "
                f"{self.capacity} blocks free"
            )
        blocks = [self.free.popleft() for _ in range(n)]
        self.mapped[slot] = blocks
        return list(blocks)  # copy: grow() extends the stored list in place

    def grow(self, slot: int, n: int) -> list[int]:
        """Append ``n`` blocks to ``slot``'s existing mapping (on-demand
        growth); raises ``KeyError`` on an unmapped slot and ``ValueError``
        when the free list is short."""
        if slot not in self.mapped:
            raise KeyError(f"grow on slot {slot} which holds no blocks")
        if not self.can_alloc(n):
            raise ValueError(
                f"grow(slot={slot}, n={n}): only {len(self.free)} of "
                f"{self.capacity} blocks free"
            )
        blocks = [self.free.popleft() for _ in range(n)]
        self.mapped[slot].extend(blocks)
        return blocks

    def release(self, slot: int) -> list[int]:
        """Unmap and return all of ``slot``'s blocks to the free list;
        raises ``KeyError`` on double-release / an unmapped slot."""
        if slot not in self.mapped:
            raise KeyError(
                f"release of slot {slot} which holds no blocks "
                f"(double-release?)"
            )
        blocks = self.mapped.pop(slot)
        self.free.extend(blocks)
        return blocks


class ContinuousScheduler:
    def __init__(
        self,
        engine: ServeEngine,
        n_slots: int = 4,
        segment_len: int = 8,
        segment_mode: str | None = None,
        seed: int = 0,
        n_blocks: int | None = None,
        prefill_chunk: int = 0,
        prefill_buckets: int = 4,
        prefill_token_budget: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        overcommit: float = 1.0,
        preempt_mode: str = "recompute",
        chaos: ChaosConfig | None = None,
        policy: TenantPolicy | None = None,
    ):
        assert n_slots >= 1 and segment_len >= 1, (n_slots, segment_len)
        assert overcommit >= 1.0, f"overcommit must be >= 1.0, got {overcommit}"
        assert preempt_mode in ("recompute", "swap"), preempt_mode
        # speculative decoding: the engine resolved the drafter (or recorded
        # why its family cannot speculate); segments become draft-and-verify
        # rounds and requests need spec_k positions of headroom
        self.spec = engine.spec
        self.spec_k = engine.spec.k if engine.spec is not None else 0
        # batched/chunked admission (prefill_chunk > 0): prompts are split
        # into prefill_chunk-sized chunks carried across admit rounds, the
        # final chunk padded up to a geometric bucket set (powers of two
        # down from prefill_chunk, prefill_buckets entries), and every admit
        # round groups same-bucket chunks into ONE fixed-width
        # (width, bucket) prefill_slots launch.  prefill_chunk == 0 keeps
        # one-request-per-launch admission.
        self.prefill_chunk = int(prefill_chunk)
        self.chunked = self.prefill_chunk > 0
        self.stats_skip_reason = ""
        if self.chunked:
            reason = engine.arch.chunked_prefill_skip_reason()
            if reason:
                log.warning(
                    "batched/chunked prefill disabled — falling back to "
                    "per-request admission: %s", reason,
                )
                self.chunked = False
                self.stats_skip_reason = reason
        if self.chunked:
            assert self.prefill_chunk & (self.prefill_chunk - 1) == 0, (
                f"prefill_chunk must be a power of two, got "
                f"{self.prefill_chunk}"
            )
            assert engine.sc.max_len % self.prefill_chunk == 0, (
                f"prefill_chunk {self.prefill_chunk} must divide max_len "
                f"{engine.sc.max_len} (chunk writes must stay in bounds)"
            )
            assert 1 <= prefill_buckets <= self.prefill_chunk.bit_length(), (
                f"prefill_buckets {prefill_buckets} out of range for chunk "
                f"{self.prefill_chunk}"
            )
            # ascending, e.g. chunk=32, 4 buckets -> (4, 8, 16, 32)
            self.buckets = tuple(
                self.prefill_chunk >> i for i in reversed(range(prefill_buckets))
            )
            engine.check_chunked_prefill_contract()
        # Sarathi-style admit rounds: bound the prefill tokens advanced per
        # admit round (0 = one chunk per prefilling slot per round).  With a
        # budget, a round keeps launching chunk groups until >= budget real
        # tokens prefilled; a round that has advanced nothing yet may
        # overshoot by one chunk, so a budget below the chunk length still
        # makes progress.
        assert prefill_token_budget >= 0, prefill_token_budget
        self.prefill_token_budget = int(prefill_token_budget) if self.chunked else 0
        # multi-tenant admission policy: when installed, submit routes
        # tenants/priorities and rate-limits through it, and
        # _claim_queue_head admits its DRR pick instead of the FIFO head.
        # Per-class chunk caps must be members of the bucket set so capped
        # chunks reuse already-captured prefill shapes.
        self.policy = policy
        if policy is not None and self.chunked:
            for cls in policy.classes.values():
                cap = cls.prefill_chunk_cap
                if cap and cap not in self.buckets:
                    raise ValueError(
                        f"priority class '{cls.name}': prefill_chunk_cap "
                        f"{cap} is not in the scheduler's bucket set "
                        f"{self.buckets}"
                    )
            # brownout handshake: the level-2 clamp shrinks victim-class
            # chunk caps / token budgets to the SMALLEST bucket, so the
            # degraded shapes reuse already-captured prefill programs
            policy.bind_chunk_buckets(self.buckets)
        # slot -> next chunk start offset for requests still prefilling
        # (admitted to a slot, not yet active; chunks advance one per round)
        self._prefill_start: dict[int, int] = {}
        # "scan": fixed segment_len steps per launch.  "while": segment_len
        # becomes a cap; the segment stops at the first retirement boundary
        # (when admission work is pending) so freed slots refill without
        # riding out the segment masked.  Defaults to the engine's loop.
        self.segment_mode = segment_mode or (
            "while" if engine.sc.loop == "while" else "scan"
        )
        assert self.segment_mode in ("scan", "while"), self.segment_mode
        self.engine = engine
        self.n_slots = n_slots
        self.segment_len = segment_len
        self.clock = clock
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.paged = engine.sc.kv_layout == "paged"
        assert preempt_mode == "recompute" or self.paged, (
            "preempt_mode='swap' swaps KV blocks — paged layout only"
        )
        # overcommit admission: admit while Σ committed full budgets stays
        # under overcommit × capacity; blocks map lazily, preemption covers
        # the (overcommit > 1) case where growth finds the pool dry
        self.overcommit = float(overcommit)
        self.preempt_mode = preempt_mode
        self._committed: dict[int, int] = {}  # slot -> full block budget
        # slot -> prefix being prefilled (always the tenant's prompt:
        # recompute readmits re-prefill the prompt ALONE and replay their
        # already-emitted tokens through ordinary decode segments)
        self._prefix: dict[int, np.ndarray] = {}
        # slot -> deque of already-emitted tokens the device must re-derive
        # after a recompute readmit; the host consumes (and verifies) these
        # duplicate emissions instead of re-emitting them
        self._replay: dict[int, collections.deque] = {}
        # seeded fault injection (ChaosConfig): one RandomState stream so a
        # chaos schedule replays exactly from its seed
        self.chaos = chaos
        self._chaos_rng = (np.random.RandomState(chaos.seed)
                           if chaos is not None else None)
        self._chaos_hold = 0  # free blocks hidden from growth this segment
        if self.paged:
            self.block_len = engine.sc.block_len
            self.max_blocks = engine.max_blocks_per_slot
            # default pool = dense-equivalent capacity; callers shrink it to
            # actually reclaim memory (admission then gates on free blocks)
            self.n_blocks = (n_blocks if n_blocks is not None
                             else n_slots * self.max_blocks)
            self.allocator = BlockAllocator(self.n_blocks, first_block=n_slots)
            # host-owned block table, uploaded with each paged program call;
            # slot s's unmapped entries point at its own scratch block s
            self.block_table = np.repeat(
                np.arange(n_slots, dtype=np.int32)[:, None],
                self.max_blocks, axis=1,
            )
        else:
            assert n_blocks is None, "n_blocks only applies to kv_layout=paged"
        # device slot state (cache, tok, pos, done), updated in place by
        # every program; taken over from any earlier scheduler of this
        # geometry on the same engine
        self.state = engine.slot_state(n_slots, self.n_blocks if self.paged else None,
                                       seed)
        self.state.owner = self
        # host-owned policy vectors
        self.active = np.zeros(n_slots, bool)
        self.limit = np.zeros(n_slots, np.int32)
        self._next_rid = 0
        self.stats = {
            "segments": 0,
            "admitted": 0,
            "retired": 0,
            "steps_total": 0,
            "slot_steps_live": 0,
            "slot_steps_masked": 0,
            "admissions_per_slot": [0] * n_slots,
            "admit_deferred": 0,
            "blocks_in_use_peak": 0,
            # batched/chunked admission accounting
            "admit_rounds": 0,
            "admit_time_s": 0.0,
            "prefill_launches": 0,
            "chunks_prefilled": 0,
            "prefill_batch_hist": {},  # real rows per launch -> count
            "chunked_skip_reason": self.stats_skip_reason,
            # real prefill tokens advanced per admit round (appended once
            # per round that prefilled anything)
            "prefill_tokens_per_round": [],
            # speculative decoding (spec_* only grow when spec is active)
            "spec_skip_reason": engine.spec_skip_reason,
            "spec_steps": 0,  # draft-and-verify rounds with >= 1 live slot-step
            "spec_emitted": 0,  # tokens emitted by those slot-steps
            "accepted_hist": {},  # tokens per live slot-step -> count
            # while segments: steps (rounds) the device ran predicated off,
            # after the segment's stop and before the host's next read of it
            "steps_predicated": 0,
            # robustness: on-demand growth, preemption, cancellation
            "blocks_grown": 0,  # blocks mapped by per-segment growth
            "preemptions": 0,  # slots evicted mid-flight (pool or chaos)
            "readmits": 0,  # preempted requests claimed again
            "readmit_penalty_s": 0.0,  # Σ eviction → next-emission gaps
            "readmit_penalty_n": 0,  # gaps summed above
            "replayed_tokens": 0,  # re-derived (suppressed) after readmit
            "swap_outs": 0,
            "swap_ins": 0,
            "cancelled": 0,
            "expired": 0,
            "blocks_reclaimed_cancel": 0,  # blocks freed by cancellations
            "chaos_exhausts": 0,
            "chaos_cancels": 0,
            "chaos_slot_failures": 0,
            # emitted tokens per tenant label ("default" without a policy)
            "tenant_tokens": {},
            # evictions per priority class, and brownout ladder changes
            # (the latter stays 0 without a policy)
            "preemptions_by_class": {},
            "brownout_changes": 0,
        }

        # opt-in per-segment trace recorder (ServeConfig.trace); None keeps
        # every hook site to a single attribute check
        self.trace = None
        if engine.sc.trace:
            from repro_torch.serve.trace import TraceRecorder

            self.trace = TraceRecorder(engine)
        self.state.trace = self.trace  # the engine's calls record into it

    # the device state, as the reference's scheduler names it
    @property
    def cache(self) -> dict:
        return self.state.cache

    @property
    def tok(self) -> torch.Tensor:
        return self.state.tok

    @property
    def pos(self) -> torch.Tensor:
        return self.state.pos

    @property
    def done(self) -> torch.Tensor:
        return self.state.done

    # -------------------------------------------------------------- paged

    def _blocks_for(self, req: Request) -> int:
        """Physical blocks a request needs for its whole lifetime: write
        positions run 0..prompt_len+max_new−1."""
        total = req.prompt_len + req.max_new_tokens + self.spec_k
        return -(-total // self.block_len)

    def _blocks_through(self, pos: int) -> int:
        """Blocks needed to cover write positions 0..``pos`` inclusive."""
        return pos // self.block_len + 1

    def _release_blocks(self, slot: int) -> list[int]:
        """Free a slot's blocks (and its overcommit commitment) and point
        its table row back at its scratch block, so the retired slot's
        masked frozen-pos writes land in scratch instead of a freed block
        the next tenant may be handed."""
        self._committed.pop(slot, None)
        blocks = self.allocator.release(slot)
        self.block_table[slot] = slot
        return blocks

    def check_block_invariants(self) -> None:
        """Allocator/table invariants (stress suite runs this after every
        segment): no block mapped twice, scratch never mapped, free+mapped
        partitions the pool, table rows mirror the allocator exactly."""
        if not self.paged:
            return
        alc = self.allocator
        mapped = [b for blocks in alc.mapped.values() for b in blocks]
        assert len(mapped) == len(set(mapped)), "block mapped to two slots"
        assert all(b >= alc.first_block for b in mapped), "scratch block mapped"
        free = list(alc.free)
        assert len(free) == len(set(free)), "duplicate free block"
        assert not (set(free) & set(mapped)), "block both free and mapped"
        pool = set(range(alc.first_block, alc.first_block + alc.capacity))
        assert set(free) | set(mapped) == pool, "free ∪ mapped ≠ pool"
        live = {s for s in range(self.n_slots) if self.slots[s] is not None}
        assert set(alc.mapped) == live, (
            f"mapped slots {sorted(alc.mapped)} ≠ live slots {sorted(live)}"
        )
        for slot in range(self.n_slots):
            row = self.block_table[slot]
            if slot in alc.mapped:
                nb = len(alc.mapped[slot])
                assert list(row[:nb]) == alc.mapped[slot], (slot, row)
                assert (row[nb:] == slot).all(), (slot, row)
            else:
                assert (row == slot).all(), f"unmapped slot {slot} bad row"
        # overcommit commitments mirror the mapped slots and bound them
        assert set(self._committed) == set(alc.mapped), (
            f"committed slots {sorted(self._committed)} ≠ mapped slots "
            f"{sorted(alc.mapped)}"
        )
        for slot, blocks in alc.mapped.items():
            assert len(blocks) <= self._committed[slot], (
                f"slot {slot} mapped {len(blocks)} > committed "
                f"{self._committed[slot]}"
            )
        assert sum(self._committed.values()) <= (
            self.overcommit * alc.capacity + 1e-9
        ), (self._committed, self.overcommit, alc.capacity)

    # ----------------------------------------------- growth / preemption

    def _vacate_slot(self, slot: int) -> int:
        """Host bookkeeping to empty a slot row — occupancy, policy vectors,
        prefill cursor/prefix, blocks, commitment.  Returns the number of
        blocks returned to the pool.  The device row needs no reset: with
        ``active=0`` the segment masks it (paged: its table row is back at
        scratch), and the next tenant's prefill overwrites tok/pos/done."""
        self.slots[slot] = None
        self.active[slot] = False
        self._prefill_start.pop(slot, None)
        self._prefix.pop(slot, None)
        self._replay.pop(slot, None)
        if self.paged and slot in self.allocator.mapped:
            return len(self._release_blocks(slot))
        return 0

    def _dev_tokens(self, slot: int, req: Request) -> int:
        """Tokens the DEVICE has derived for the slot's tenant: equals
        ``len(req.tokens)`` except mid-replay, where the device is still
        re-deriving tokens the request emitted before its preemption."""
        replay = self._replay.get(slot)
        return len(req.tokens) - (len(replay) if replay else 0)

    def _segment_end_pos(self, slot: int, req: Request) -> int:
        """Worst-case cache write position for ``req`` over the next
        segment, from the cursor invariant pos = prompt_len + derived − 1
        (derived = emitted, except mid-replay): decode advances one write
        per step up to its limit."""
        pos = req.prompt_len + self._dev_tokens(slot, req) - 1
        limit = req.prompt_len + req.max_new_tokens - 1
        per_step = self.spec_k + 1
        return min(pos + self.segment_len * per_step - 1,
                   limit + self.spec_k)

    def _progress_key(self, slot: int) -> tuple:
        """Victim-policy progress order: emitted tokens first, then — among
        still-prefilling slots — the chunk cursor.  Fully prefilled slots
        rank above mid-prefill ones at equal token counts."""
        req = self.slots[slot]
        return (len(req.tokens), self._prefill_start.get(slot, 1 << 30))

    def _preempt_slot(self, slot: int, reason: str = "pool") -> None:
        """Evict a resident mid-flight: host bookkeeping is dropped, the
        request requeues at the FRONT of the queue (it was admitted before
        everything waiting behind it) and readmits later by recompute —
        re-prefill of the prompt plus a replayed re-decode of its emitted
        tokens — or, under ``preempt_mode="swap"``, by copying its saved KV
        blocks back.  Swap-out is skipped mid-prefill and mid-replay (the
        device cursor trails the host token mirror there), falling back to
        recompute."""
        req = self.slots[slot]
        if (self.preempt_mode == "swap" and self.paged and req.tokens
                and slot not in self._prefill_start
                and slot not in self._replay):
            self._swap_out(slot, req)
        if self.trace is not None:
            swapped = 0
            if req._swap is not None:
                swapped = sum(x.nbytes for x in req._swap.values())
            self.trace.record_preempt(self.stats["segments"],
                                      len(req.tokens), swapped)
        self._vacate_slot(slot)
        req.state = QUEUED
        req.preempts += 1
        req.preempt_t = self.clock()
        self.queue.appendleft(req)
        if self.trace is not None:
            self.trace.enqueue(req.rid)
        self.stats["preemptions"] += 1
        by_cls = self.stats["preemptions_by_class"]
        by_cls[req.priority] = by_cls.get(req.priority, 0) + 1
        log.debug("preempted rid=%d from slot %d (%s, emitted=%d)",
                  req.rid, slot, reason, len(req.tokens))

    def _class_level(self, slot: int) -> int:
        """Priority-class level of a resident (0 without a policy — every
        slot ranks equal and the least-progress victim order is
        unchanged)."""
        if self.policy is None:
            return 0
        return self.policy.level_of(self.slots[slot].priority)

    def _preempt_for_blocks(self) -> bool:
        """Pick and evict one victim so growth can retry: lowest priority
        class first (batch before standard before interactive), then least
        progress, ties evict the latest arrival (highest rid).  The MOST
        progressed resident (ties: earliest arrival) is protected
        regardless of class — it is never evicted, always fits the pool on
        its own (``submit`` bounds every request's budget by the capacity),
        and monotonically runs to completion, so preemption always
        terminates and the scheduler always makes progress.  Returns False
        when no evictable resident remains."""
        residents = [s for s in range(self.n_slots)
                     if self.slots[s] is not None]
        if len(residents) < 2:
            return False
        protected = max(
            residents,
            key=lambda s: (self._progress_key(s), -self.slots[s].rid))
        victim = min(
            (s for s in residents if s != protected),
            key=lambda s: (self._class_level(s), self._progress_key(s),
                           -self.slots[s].rid))
        self._preempt_slot(victim)
        return True

    def _ensure_segment_capacity(self) -> None:
        """On-demand block growth: before each segment, grow every active
        slot's mapping to cover its worst-case write position this segment
        (``_segment_end_pos``).  When the pool cannot cover the growth —
        only possible at ``overcommit > 1``, or under a chaos exhaustion
        hold — preempt victims one at a time until it can.  Growth stays
        within each slot's committed budget, so the block table row always
        fits."""
        if not self.paged:
            return
        hold = self._chaos_hold
        while True:
            needs: dict[int, int] = {}
            for slot, req in enumerate(self.slots):
                if req is None or not self.active[slot]:
                    continue  # empty or mid-prefill: no decode writes yet
                need = self._blocks_through(self._segment_end_pos(slot, req))
                have = len(self.allocator.mapped[slot])
                if need > have:
                    needs[slot] = need - have
            if sum(needs.values()) <= max(0, self.allocator.n_free - hold):
                break
            if self._preempt_for_blocks():
                continue
            if hold:
                # chaos exhaustion with no evictable victim left: drop the
                # hold rather than deadlock (the real free list can cover
                # the protected slot — see _preempt_for_blocks)
                hold = 0
                continue
            raise RuntimeError(  # unreachable: submit bounds every budget
                "paged pool cannot cover the protected slot's segment")
        for slot, delta in needs.items():
            have = len(self.allocator.mapped[slot])
            blocks = self.allocator.grow(slot, delta)
            self.block_table[slot, have:have + delta] = blocks
            self.stats["blocks_grown"] += delta
        if needs:
            self.stats["blocks_in_use_peak"] = max(
                self.stats["blocks_in_use_peak"], self.allocator.n_mapped)

    # ---------------------------------------------------------------- swap

    def _swap_out(self, slot: int, req: Request) -> None:
        """Copy the slot's written KV blocks to host memory (pinned when
        the pool is on the card; the copy is queued, not waited for) so
        readmission can skip recompute.  Written positions run 0..pos−1
        (pos is the NEXT write position = prompt_len + emitted − 1); whole
        blocks are saved, and unwritten positions inside the last block are
        dead weight the masked attention never reads."""
        pos = req.prompt_len + len(req.tokens) - 1
        nb = self._blocks_through(pos - 1)
        blocks = self.allocator.mapped[slot][:nb]
        ids = torch.tensor(blocks, dtype=torch.long, device=self.engine.device)
        saved = {}
        for name, leaf in self.cache.items():
            part = leaf.index_select(1, ids)
            if part.is_cuda:
                host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
                saved[name] = host.copy_(part, non_blocking=True)
            else:
                saved[name] = part
        req._swap = saved
        req._swap_nb = nb
        self.stats["swap_outs"] += 1

    def _swap_in(self, slot: int, req: Request) -> None:
        """Restore a swapped-out request into ``slot``: copy its saved
        blocks into the freshly allocated physical blocks
        (``_claim_queue_head`` mapped exactly ``_swap_nb`` of them) and set
        the device cursors, all in place.  The slot goes active
        immediately — no prefill launch and no admission emission."""
        dev = self.engine.device
        ids = torch.tensor(self.allocator.mapped[slot], dtype=torch.long, device=dev)
        for name, leaf in self.cache.items():
            leaf.index_copy_(1, ids, req._swap[name].to(dev, non_blocking=True))
        pos = req.prompt_len + len(req.tokens) - 1
        self.tok[slot] = req.tokens[-1]
        self.pos[slot] = pos
        self.done[slot] = False
        self.active[slot] = True
        self.limit[slot] = req.prompt_len + req.max_new_tokens - 1
        if self.trace is not None:
            self.trace.record_swap_in(self.stats["segments"],
                                      sum(x.nbytes for x in req._swap.values()))
        req._swap = None
        req._swap_nb = 0
        self.stats["swap_ins"] += 1

    # ------------------------------------------- cancellation / deadlines

    def _terminal_state(self, req: Request, now: float) -> str | None:
        """CANCELLED/EXPIRED if the request should retire without finishing,
        else None.  Cancellation wins over a simultaneous expiry."""
        if req.cancel_requested:
            return CANCELLED
        if req.deadline_s is not None and now - req.submit_t > req.deadline_s:
            return EXPIRED
        if (req.ttft_deadline_s is not None and req.first_token_t is None
                and now - req.submit_t > req.ttft_deadline_s):
            return EXPIRED
        return None

    def _retire_terminal(self, req: Request, state: str, now: float) -> None:
        req.state = state
        req.finish_reason = state  # "cancelled" / "expired"
        req.finish_t = now
        req._swap, req._swap_nb = None, 0  # drop any host KV payload
        self.stats["cancelled" if state == CANCELLED else "expired"] += 1
        if self.trace is not None:
            self.trace.left_queue(req.rid)
        if self.policy is not None and state == EXPIRED:
            # an expiry IS an SLO observation: a request that died before
            # its first token feeds its waiting age to the monitor as the
            # TTFT it effectively experienced (the brownout controller must
            # see misses, not just the survivors' successes)
            if req.first_token_t is None:
                self.policy.observe_ttft(req.priority, now - req.submit_t)
            self.policy.observe_latency(req.priority, now - req.submit_t)

    def _sweep_terminal(self) -> None:
        """Honor cancellations and deadlines at the segment boundary: queued
        victims retire in place; resident victims vacate their slot, whose
        blocks return to the pool NOW — within one segment of the cancel
        call, not at what would have been their retirement."""
        now = self.clock()
        if self.queue and any(
                self._terminal_state(r, now) for r in self.queue):
            kept: collections.deque[Request] = collections.deque()
            for req in self.queue:
                state = self._terminal_state(req, now)
                if state is None:
                    kept.append(req)
                else:
                    self._retire_terminal(req, state, now)
            self.queue = kept
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            state = self._terminal_state(req, now)
            if state is None:
                continue
            released = self._vacate_slot(slot)
            if state == CANCELLED:
                self.stats["blocks_reclaimed_cancel"] += released
            self._retire_terminal(req, state, now)

    # --------------------------------------------------------------- chaos

    def _inject_chaos(self) -> None:
        """Seeded fault injection (see serve/chaos.py): runs before the
        terminal sweep so injected cancellations retire within the same
        segment.  Draws come from one RandomState stream, so a chaos
        schedule replays exactly from ``ChaosConfig.seed``."""
        self._chaos_hold = 0
        c = self.chaos
        if c is None:
            return
        rng = self._chaos_rng
        exhaust = self.stats["segments"] in c.exhaust_at
        if c.exhaust_prob > 0:
            exhaust |= bool(rng.random_sample() < c.exhaust_prob)
        if exhaust and self.paged:
            self._chaos_hold = self.allocator.n_free
            self.stats["chaos_exhausts"] += 1
        if c.slot_fail_prob > 0 and rng.random_sample() < c.slot_fail_prob:
            occupied = [s for s in range(self.n_slots)
                        if self.slots[s] is not None]
            if occupied:
                self._preempt_slot(
                    occupied[int(rng.randint(len(occupied)))], "chaos")
                self.stats["chaos_slot_failures"] += 1
        if c.cancel_prob > 0 and rng.random_sample() < c.cancel_prob:
            cands = [r for r in list(self.queue) + self.slots
                     if r is not None and not r.terminal
                     and not r.cancel_requested]
            if cands:
                cands[int(rng.randint(len(cands)))].cancel()
                self.stats["chaos_cancels"] += 1

    def _count_token(self, req: Request) -> None:
        """Per-tenant billing for one emitted token (replays excluded —
        they were billed at first emission)."""
        tt = self.stats["tenant_tokens"]
        tt[req.tenant] = tt.get(req.tenant, 0) + 1
        if self.policy is not None:
            self.policy.note_tokens(req.tenant)
        if self.trace is not None:
            self.trace.note_tenant_tokens(req.tenant)

    def _note_emission_after_readmit(self, req: Request, now: float) -> None:
        """First emission after a readmission closes the preemption gap —
        the readmit TTFT penalty surfaced in ``stats``."""
        if req.preempt_t is not None:
            self.stats["readmit_penalty_s"] += now - req.preempt_t
            self.stats["readmit_penalty_n"] += 1
            req.preempt_t = None

    # -------------------------------------------------------------- submit

    def submit(
        self,
        prompt: Sequence[int] | np.ndarray | SubmitRequest,
        max_new_tokens: int | None = None,
        on_token=None,
        ttft_deadline_s: float | None = None,
        deadline_s: float | None = None,
        tenant: str | None = None,
        priority: str | None = None,
    ) -> Request:
        """Queue one request; returns its live handle (tokens stream into
        ``handle.tokens`` as segments complete).  Invalid submissions raise
        ``ValueError`` here instead of surfacing opaque shape/device errors
        mid-run; with a :class:`TenantPolicy` installed a shed submission
        raises :class:`Overloaded` and an over-rate tenant
        :class:`RateLimited` (after shape validation, so malformed requests
        still surface as ``ValueError``)."""
        if isinstance(prompt, SubmitRequest):
            sub = prompt
        else:
            sub = SubmitRequest(prompt, max_new_tokens, on_token,
                                ttft_deadline_s, deadline_s,
                                tenant=tenant, priority=priority)
        p = np.asarray(sub.prompt, np.int32).reshape(-1)
        max_len = self.engine.sc.max_len
        if p.size < 1:
            raise ValueError("empty prompt")
        if sub.max_new_tokens is None or sub.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {sub.max_new_tokens}"
            )
        if p.size >= max_len:
            raise ValueError(
                f"prompt length {p.size} must be < max_len {max_len} "
                f"(no cache positions left to generate into)"
            )
        # speculative decoding needs spec_k positions of cache headroom: the
        # verify window writes up to spec_k rejected-tail tokens past the
        # cursor before rollback truncates them
        if p.size + sub.max_new_tokens + self.spec_k > max_len:
            raise ValueError(
                f"prompt {p.size} + max_new {sub.max_new_tokens}"
                + (f" + spec draft window {self.spec_k}" if self.spec_k else "")
                + f" exceeds max_len {max_len}"
            )
        for name in ("ttft_deadline_s", "deadline_s"):
            d = getattr(sub, name)
            if d is not None and d <= 0:
                raise ValueError(f"{name} must be positive, got {d}")
        if self.paged:
            total = int(p.size) + sub.max_new_tokens + self.spec_k
            full = -(-total // self.block_len)
            if full > self.allocator.capacity:
                # liveness guard: a head request the pool can never satisfy
                # would defer admission forever once all slots drain — and
                # the preemption loop's termination proof needs every single
                # request's full budget to fit the pool on its own
                raise ValueError(
                    f"request needs {full} blocks but the pool has "
                    f"{self.allocator.capacity}"
                )
        req_tenant = sub.tenant if sub.tenant is not None else "default"
        ttft = sub.ttft_deadline_s
        if self.policy is not None:
            spec = self.policy.spec_for(req_tenant)
            req_priority = (sub.priority if sub.priority is not None
                            else spec.default_priority)
            cls = self.policy.class_for(req_priority)  # unknown -> ValueError
            if ttft is None:
                ttft = cls.ttft_deadline_s  # class default TTFT SLO
            # brownout shed before the rate gate: a shed submission must
            # not consume the tenant's token-bucket credit
            if self.policy.should_shed(req_priority):
                raise Overloaded(req_tenant, self.policy.shed_retry_after(),
                                 req_priority, self.policy.brownout_level)
            # rate gate last: malformed requests fail as ValueError above
            # even when the tenant is also over rate
            retry = self.policy.charge_rate(req_tenant, self.clock())
            if retry is not None:
                raise RateLimited(req_tenant, retry)
            self.policy.note_submitted(req_tenant)
        else:
            req_priority = (sub.priority if sub.priority is not None
                            else "standard")
        req = Request(
            rid=self._next_rid,
            prompt=p,
            max_new_tokens=sub.max_new_tokens,
            on_token=sub.on_token,
            submit_t=self.clock(),
            ttft_deadline_s=ttft,
            deadline_s=sub.deadline_s,
            tenant=req_tenant,
            priority=req_priority,
        )
        self._next_rid += 1
        self.queue.append(req)
        if self.trace is not None:
            self.trace.enqueue(req.rid)
        return req

    # --------------------------------------------------------------- admit

    def _admit(self) -> int:
        """One admit round (timed): batched/chunked admission when
        ``prefill_chunk`` is set, else one request per launch.  Traced: a
        ``serve.admit`` span with the chunks and real tokens its prefill
        calls carried."""
        t0 = self.clock()
        tr = self.trace
        if tr is not None:
            sp, first = tr.open("serve.admit"), len(tr.spans)
        n = (self._admit_chunked() if self.chunked
             else self._admit_per_request())
        if tr is not None:
            calls = [s for s in tr.spans[first:] if s.name == "serve.prefill"]
            tr.close(sp, chunks=sum(len(s.rids) for s in calls),
                     real_tokens=sum(s.attrs.get("real_tokens", 0) for s in calls))
        self.stats["admit_time_s"] += self.clock() - t0
        self.stats["admit_rounds"] += 1
        return n

    def _claim_queue_head(self, slot: int) -> Request | None:
        """Claim the queue head for ``slot``: paged commitment gating
        (deferral preserves FIFO — the caller must stop admitting for the
        round on None with a non-empty queue), lazy allocator/table
        bookkeeping, and admission stats.  Shared by both admission paths
        so their policy cannot drift.  The caller decides slot occupancy
        (a 1-token request on the per-request path never occupies its
        slot).

        Paged gating is two-part: (1) the overcommit gate — resident full
        budgets + the head's must fit ``overcommit × capacity`` (at 1.0
        this makes later growth infallible); (2) the blocks the head maps
        NOW (its prompt prefill's writes, or its saved swap blocks) must
        actually be free.

        A recompute readmit re-prefills the PROMPT alone — bit-identical
        to the original admission — and then REPLAYS its already-emitted
        tokens through ordinary decode segments (the host consumes the
        duplicate emissions): a prefill of prompt + emitted tokens would
        not give the decode steps' bits."""
        if not self.queue:
            return None
        # policy pick: the TenantPolicy's DRR/priority choice replaces the
        # FIFO head; select() is a pure peek, so a deferral below leaves
        # the policy state untouched and the pick re-derives next round
        req = (self.queue[0] if self.policy is None
               else self.policy.select(self.queue))
        prefix = None if req._swap is not None else req.prompt
        if self.paged:
            full = self._blocks_for(req)
            committed = sum(self._committed.values())
            if committed + full > self.overcommit * self.allocator.capacity:
                self.stats["admit_deferred"] += 1
                return None
            nb = (req._swap_nb if prefix is None
                  else self._blocks_through(len(prefix) - 1))
            if not self.allocator.can_alloc(nb):
                self.stats["admit_deferred"] += 1
                return None
            blocks = self.allocator.alloc(slot, nb)
            self._committed[slot] = full
            self.block_table[slot, :nb] = blocks
            self.block_table[slot, nb:] = slot
            self.stats["blocks_in_use_peak"] = max(
                self.stats["blocks_in_use_peak"], self.allocator.n_mapped
            )
        if prefix is not None:
            self._prefix[slot] = prefix
            if req.tokens:
                self._replay[slot] = collections.deque(req.tokens)
        if self.policy is None:
            self.queue.popleft()
        else:
            self.policy.on_admitted(self.queue, req)  # commit the DRR pick
            self.queue.remove(req)
        req.state = RUNNING
        req.slot_history.append(slot)
        self.stats["admitted"] += 1
        if len(req.slot_history) > 1:
            self.stats["readmits"] += 1
        self.stats["admissions_per_slot"][slot] += 1
        if self.trace is not None:
            self.trace.claimed(req.rid)
        return req

    def _claim_free_slots(self) -> None:
        """Move queued requests into free slots, FIFO.  Claimed requests
        enter the prefilling set; they go live only when their final chunk
        lands."""
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            req = self._claim_queue_head(slot)
            if req is None:
                break  # queue empty, or the pool deferred the head
            self.slots[slot] = req
            if req._swap is not None:
                self._swap_in(slot, req)  # active immediately, no prefill
            else:
                self._prefill_start[slot] = 0

    @property
    def n_width_buckets(self) -> int:
        """Distinct launch widths: powers of two up to next_pow2(n_slots)."""
        return (self.n_slots - 1).bit_length() + 1

    @property
    def max_prefill_traces(self) -> int:
        """Workload-independent bound on captured prefill programs: one per
        (chunk-length bucket × launch-width bucket) shape.  Distinct prompt
        lengths never enter the count."""
        return len(self.buckets) * self.n_width_buckets

    def _next_chunk(self, slot: int, start: int) -> tuple[int, int, bool]:
        """(real_len, bucket_len, is_final) for the chunk at ``start`` of
        the slot's prefill prefix: full ``prefill_chunk`` chunks until the
        remainder fits, then the remainder padded up to the smallest
        covering bucket."""
        rem = len(self._prefix[slot]) - start
        cap = self.prefill_chunk
        if self.policy is not None:
            # per-class chunk cap (validated at init to be a bucket member,
            # so capped chunks reuse already-captured prefill shapes)
            cap = self.policy.chunk_cap(self.slots[slot].priority) or cap
        if rem > cap:
            return cap, cap, False
        bucket = next(b for b in self.buckets if b >= rem)
        return rem, bucket, True

    def _admit_chunked(self) -> int:
        """Batched/bucketed admission: claim free slots, then advance the
        prefilling slots by chunks — same-bucket chunks share one
        fixed-width ``prefill_slots`` launch (dummy rows carry out-of-range
        slot/block ids, so their writes drop and the launch shape never
        varies).  One download of first tokens per prefill round; long
        prompts carry their chunk cursor across rounds, so decode segments
        interleave with their prefill instead of stalling behind it.
        Returns the number of requests that went live (or finished) this
        round.

        Interleave policy: with ``prefill_token_budget=N`` (Sarathi-style)
        the round keeps launching chunk rounds until ≥ N real prefill
        tokens have advanced, then yields to the decode segment.  Without a
        budget, one chunk per prefilling slot per round while a BATCH of
        decodes is live; at ≤ 1 live decode there is no batch to protect,
        so chunk rounds drain back-to-back.
        """
        self._claim_free_slots()
        n_live = 0
        budget = self.prefill_token_budget
        if self.policy is not None and self._prefill_start:
            # per-class budget override: honor the most generous budget
            # among the round's prefilling classes, so an interactive
            # prefill is never throttled down to a batch neighbor's budget
            overrides = [
                self.policy.token_budget(self.slots[s].priority)
                for s in self._prefill_start
            ]
            overrides = [b for b in overrides if b is not None]
            if overrides:
                budget = max(overrides)
        spent = 0
        while self._prefill_start:
            went_live, tokens = self._prefill_round(
                budget - spent if budget else 0,
                allow_overshoot=spent == 0,
            )
            n_live += went_live
            spent += tokens
            if budget:
                if tokens == 0 or spent >= budget:
                    break
            elif int(self.active.sum()) > 1:
                break
        if spent:
            self.stats["prefill_tokens_per_round"].append(spent)
        return n_live

    def _prefill_round(self, token_budget: int = 0,
                       allow_overshoot: bool = True) -> tuple[int, int]:
        """Advance prefilling slots by one chunk each: bucket-group the
        chunks, launch one fixed-shape program per group, fetch all first
        tokens once, and activate/finish the rows whose final chunk landed.
        With ``token_budget > 0`` only a prefix of the slots (in claim
        order — FIFO fairness) advances, cut where cumulative real chunk
        tokens would exceed the budget; when ``allow_overshoot`` the first
        chunk is taken even over budget.  Returns (requests gone live, real
        prefill tokens advanced) — (0, 0) when the budget excludes every
        candidate.
        """
        eng = self.engine
        rows_by_bucket: dict[int, list[tuple[int, int, int, bool]]] = {}
        tokens_spent = 0
        for slot, start in self._prefill_start.items():  # insertion = claim order
            real, bucket, final = self._next_chunk(slot, start)
            if token_budget and tokens_spent + real > token_budget:
                if not (allow_overshoot and tokens_spent == 0):
                    break
            tokens_spent += real
            rows_by_bucket.setdefault(bucket, []).append(
                (slot, start, real, final)
            )
        pool_size = (self.n_slots + self.n_blocks) if self.paged else 0
        launched: list[tuple[list, torch.Tensor]] = []
        for bucket in sorted(rows_by_bucket):
            rows = rows_by_bucket[bucket]
            # launch width is bucketed to powers of two as well: a trickle
            # refill of one slot runs the width-1 program instead of paying
            # n_slots× padded compute, while captures stay bounded by
            # n_buckets × n_widths
            width = 1 << (len(rows) - 1).bit_length()
            prompts = np.zeros((width, bucket), np.int32)
            # dummy rows: slot ids past n_slots are distinct and
            # out-of-range — every tok/pos/done/cache write drops
            slots_v = np.arange(self.n_slots, self.n_slots + width,
                                dtype=np.int32)
            starts = np.zeros(width, np.int32)
            last_local = np.zeros(width, np.int32)
            bt = None
            if self.paged:
                # dummy block-table rows: distinct out-of-range physical
                # ids per (row, logical block), so every dummy write drops
                bt = pool_size + np.arange(
                    width * self.max_blocks, dtype=np.int32
                ).reshape(width, self.max_blocks)
            for i, (slot, start, real, _final) in enumerate(rows):
                prompts[i, :real] = self._prefix[slot][start:start + real]
                slots_v[i] = slot
                starts[i] = start
                last_local[i] = real - 1
                if self.paged:
                    bt[i] = self.block_table[slot]
                    # the row's UNMAPPED table tail keeps distinct
                    # out-of-range ids instead of the real row's scratch
                    # entries: a final chunk's bucket padding may spill past
                    # the mapped blocks, and repeating the scratch id there
                    # would give the chunk scatter duplicate (block,
                    # offset) pairs — out-of-range ids drop instead
                    nb_mapped = len(self.allocator.mapped[slot])
                    bt[i, nb_mapped:] = (pool_size + i * self.max_blocks
                                         + np.arange(nb_mapped,
                                                     self.max_blocks))
            firsts = eng.prefill_slots(self.state, prompts, slots_v, starts,
                                       last_local, bt)
            launched.append((rows, firsts))
            self.stats["prefill_launches"] += 1
            self.stats["chunks_prefilled"] += len(rows)
            hist = self.stats["prefill_batch_hist"]
            hist[len(rows)] = hist.get(len(rows), 0) + 1
            if self.trace is not None:
                real_tokens = sum(r[2] for r in rows)
                self.trace.record_prefill(
                    self.stats["segments"], width, bucket,
                    real_tokens, [r[1] for r in rows])
                self.trace.annotate("serve.prefill", [self.slots[r[0]].rid for r in rows],
                                    width=width, bucket=bucket, real_tokens=real_tokens)
        # the ONLY admit-round download: every launch's first tokens at once
        tr = self.trace if launched else None
        sp = tr.open("serve.first_tokens") if tr is not None else None
        firsts_h = (torch.cat([f for _, f in launched]).cpu().numpy()
                    if launched else np.zeros(0, np.int64))
        if sp is not None:
            tr.close(sp)
        now = self.clock()
        n_live = 0
        offset = 0
        for rows, f in launched:
            fh = firsts_h[offset:offset + f.shape[0]]
            offset += f.shape[0]
            for i, (slot, start, real, final) in enumerate(rows):
                req = self.slots[slot]
                if not final:
                    self._prefill_start[slot] = start + real
                    continue
                del self._prefill_start[slot]
                self._prefix.pop(slot, None)
                if req.tokens:
                    # recompute readmit: the prefill re-ran the ORIGINAL
                    # admission program on the prompt alone, so its sample
                    # re-derives the request's first token bit-exactly —
                    # consume it against the replay deque instead of
                    # re-emitting; the remaining emitted tokens replay
                    # through the next decode segments the same way
                    replay = self._replay[slot]
                    want = replay.popleft()
                    assert int(fh[i]) == want, (req.rid, int(fh[i]), want)
                    self.stats["replayed_tokens"] += 1
                    if not replay:
                        del self._replay[slot]
                    self.active[slot] = True
                    self.limit[slot] = req.prompt_len + req.max_new_tokens - 1
                    n_live += 1
                    continue
                if req.first_token_t is None:
                    req.first_token_t = now
                    if self.policy is not None:
                        self.policy.observe_ttft(req.priority,
                                                 now - req.submit_t)
                req._emit(int(fh[i]))
                self._count_token(req)
                self._note_emission_after_readmit(req, now)
                n_live += 1
                if len(req.tokens) >= req.max_new_tokens:
                    # prefill token finished the budget: retired without
                    # ever decoding, so its blocks/row free immediately
                    # (the written KV is never read)
                    req.state = FINISHED
                    req.finish_reason = "length"
                    req.finish_t = now
                    if self.policy is not None:
                        self.policy.observe_latency(req.priority,
                                                    now - req.submit_t)
                    self._vacate_slot(slot)
                    self.stats["retired"] += 1
                else:
                    self.active[slot] = True
                    self.limit[slot] = req.prompt_len + req.max_new_tokens - 1
        return n_live, tokens_spent

    def _admit_per_request(self) -> int:
        """Fill every free slot from the queue (prefill-into-slot).  All
        prefills are queued first; first tokens stream after ONE bundled
        download.

        Paged layout: when the free list can't cover the QUEUE HEAD,
        admission stops for this round (FIFO preserved — skipping the head
        would starve long requests); segments keep running, retirements
        return blocks, and the head admits on a later round.  1-token
        requests release their blocks as soon as their prefill is queued —
        the written KV is never read, so a same-round reuse of those blocks
        is safe (the device runs the prefills in the order queued).
        """
        eng = self.engine
        pending: list[tuple[Request, int, torch.Tensor, bool]] = []
        deferred = False
        for slot in range(self.n_slots):
            if deferred:
                break
            while self.slots[slot] is None and self.queue:
                req = self._claim_queue_head(slot)
                if req is None:  # pool deferred the head — stop the round
                    deferred = True
                    break
                if req._swap is not None:
                    # swapped-out readmit: copy its saved KV blocks back
                    # and go active — no prefill and no admission emission
                    self.slots[slot] = req
                    self._swap_in(slot, req)
                    continue
                prefix = self._prefix.pop(slot)
                first = eng.prefill_slot(
                    self.state, prefix, slot,
                    self.block_table[slot] if self.paged else None)
                if self.trace is not None:
                    self.trace.record_prefill(self.stats["segments"], 1,
                                              len(prefix), len(prefix), [0])
                    self.trace.annotate("serve.prefill", [req.rid], width=1,
                                        bucket=len(prefix), real_tokens=len(prefix))
                resumed = bool(req.tokens)
                pending.append((req, slot, first, resumed))
                if resumed:
                    # recompute readmit: the prefill re-derives the first
                    # token, consumed against the replay deque below; the
                    # rest of the emitted tokens replay through the next
                    # decode segments, suppressed host-side
                    self.slots[slot] = req
                    self.active[slot] = True
                    self.limit[slot] = (req.prompt_len
                                        + req.max_new_tokens - 1)
                    continue
                if req.max_new_tokens <= 1:
                    # the prefill emission below reaches the budget: never
                    # decoded → the written KV is never read, so blocks
                    # free before the prefill has even run
                    if self.paged:
                        self._release_blocks(slot)
                    continue  # finished below; slot stays free — refill it
                self.slots[slot] = req
                self.active[slot] = True
                self.limit[slot] = req.prompt_len + req.max_new_tokens - 1
        if not pending:
            return 0
        tr = self.trace
        sp = tr.open("serve.first_tokens") if tr is not None else None
        firsts = torch.cat([f for _, _, f, _ in pending]).cpu().numpy()
        if sp is not None:
            tr.close(sp)
        now = self.clock()
        for (req, slot, _, resumed), first in zip(pending, firsts):
            if resumed:
                replay = self._replay[slot]
                want = replay.popleft()
                assert int(first) == want, (req.rid, int(first), want)
                self.stats["replayed_tokens"] += 1
                if not replay:
                    del self._replay[slot]
                continue
            # a fresh admission's first token never eos-pins
            if req.first_token_t is None:
                req.first_token_t = now
                if self.policy is not None:
                    self.policy.observe_ttft(req.priority, now - req.submit_t)
            req._emit(int(first))
            self._count_token(req)
            self._note_emission_after_readmit(req, now)
            if len(req.tokens) >= req.max_new_tokens:
                req.state = FINISHED
                req.finish_reason = "length"
                req.finish_t = now
                if self.policy is not None:
                    self.policy.observe_latency(req.priority,
                                                now - req.submit_t)
                self.stats["retired"] += 1
        return len(pending)

    # ------------------------------------------------------- SLO feedback

    def _update_slo(self) -> None:
        """One brownout-controller step per segment: feed the monitor the
        target class's CURRENT waiting ages (queued or claimed, no first
        token yet) so the ladder reacts to a building queue before the
        damage shows up in completed TTFTs, and trace the transition."""
        if self.policy is None or self.policy.slo is None:
            return
        now = self.clock()
        target = self.policy.slo.cfg.target_class
        waiting = [
            now - r.submit_t
            for r in list(self.queue) + [s for s in self.slots
                                         if s is not None]
            if r.priority == target and r.first_token_t is None
        ]
        new_level = self.policy.update_slo(waiting)
        if new_level is not None:
            self.stats["brownout_changes"] += 1
            log.debug("brownout level -> %d (ttft q=%.3fs deadline=%.3fs)",
                      new_level, self.policy.slo.last_quantile or 0.0,
                      self.policy.slo.deadline)
            if self.trace is not None:
                self.trace.record_brownout(self.stats["segments"], new_level)

    def queue_composition(self) -> tuple[list[int], list[int]]:
        """Remaining work as (prompt_lens, new_tokens) pairs for the drain
        predictor: queued requests owe their whole prompt prefill plus
        their remaining generation; residents owe only their remaining
        generation (one token stands in for the already-paid prefill)."""
        plens, news = [], []
        for r in self.queue:
            plens.append(r.prompt_len)
            news.append(max(1, r.max_new_tokens - len(r.tokens)))
        for r in self.slots:
            if r is None:
                continue
            plens.append(1)
            news.append(max(1, r.max_new_tokens - len(r.tokens)))
        return plens, news

    def drain_predictor(self):
        """A :class:`repro_torch.roofline.autotune.DrainPredictor` bound to
        this scheduler's knob configuration (priced on the card,
        ``roofline.hw.H100``) — the front door calibrates it against
        measured per-request walls and predicts ``Retry-After`` from
        ``queue_composition()`` instead of a scalar EWMA."""
        from repro_torch.roofline.autotune import DrainPredictor, KnobConfig

        knobs = KnobConfig(
            segment_len=self.segment_len,
            prefill_chunk=self.prefill_chunk if self.chunked else 0,
            prefill_buckets=len(self.buckets) if self.chunked else 4,
            spec_k=self.spec_k,
            block_len=self.block_len if self.paged else 0,
        )
        return DrainPredictor(
            self.engine.arch.cfg, knobs, n_slots=self.n_slots,
            max_len=self.engine.sc.max_len, paged=self.paged,
        )

    # ------------------------------------------------------------- segment

    def run_segment(self) -> int:
        """chaos → terminal sweep → SLO controller step → admit → grow →
        one segment → stream + retire.  Returns the number of requests still running afterwards.

        With ``ServeConfig.debug_invariants`` the allocator/table/commitment
        invariants are checked at the end of EVERY segment, so a violation
        fails at the segment that caused it, not at retire.  Traced: one
        ``serve.segment`` span around all of it.
        """
        if self.trace is None:
            return self._run_segment()
        with self.trace.segment_span(self.stats["segments"]):
            return self._run_segment()

    def _run_segment(self) -> int:
        if self.state.owner is not self:
            raise RuntimeError("this scheduler's slot state was taken over by "
                               "a later scheduler of the same geometry")
        debug = self.engine.sc.debug_invariants
        self._inject_chaos()
        self._sweep_terminal()
        self._update_slo()
        self._admit()
        self._ensure_segment_capacity()
        if not self.active.any():
            if debug:
                self.check_block_invariants()
            return 0
        eng = self.engine
        # early-exit at retirement boundaries whenever admission work is
        # pending: queued requests, or a claimed prompt still mid-chunked-
        # prefill (its next chunk only advances between segments)
        pending = bool(self.queue) or bool(self._prefill_start)
        n_steps = (self._while_steps(pending) if self.segment_mode == "while"
                   else self.segment_len)
        segment = eng.spec_segment if self.spec is not None else eng.slot_segment
        tr = self.trace
        if tr is not None:
            rids = [r.rid for s, r in enumerate(self.slots) if r is not None and self.active[s]]
        toks = segment(
            self.state, n_steps, self.segment_mode, self.active,
            self.limit, stop_on_free=pending,
            block_table=self.block_table if self.paged else None)
        sp = tr.open("serve.download") if tr is not None else None
        toks = toks.cpu().numpy()  # the only per-segment download
        if sp is not None:
            tr.close(sp)
            sp = tr.open("serve.retire")
            streamed0, retired0 = sum(self.stats["tenant_tokens"].values()), self.stats["retired"]
        ran = toks.shape[1]  # a while segment stops within a check of its stop
        if ran < self.segment_len:  # the steps the segment never took
            pad = [(0, 0), (0, self.segment_len - ran)] + [(0, 0)] * (toks.ndim - 2)
            toks = np.pad(toks, pad, constant_values=-1)
        self.stats["segments"] += 1
        if self.spec is not None:
            # (n_slots, S, k+1): per-step emission counts feed the
            # accepted-length stats, then the block flattens row-major into
            # the chronological per-slot stream the host loop below consumes
            per_step = (toks >= 0).sum(axis=2)  # (n_slots, S)
            live_step = per_step > 0
            self.stats["spec_steps"] += int(live_step.sum())
            self.stats["spec_emitted"] += int(per_step[live_step].sum())
            hist = self.stats["accepted_hist"]
            for n, c in zip(*np.unique(per_step[live_step], return_counts=True)):
                hist[int(n)] = hist.get(int(n), 0) + int(c)
            toks = toks.reshape(toks.shape[0], -1)
        else:
            live_step = toks >= 0
        # every executed step has ≥1 live emission (a while segment's steps
        # after its stop are predicated, emitting nothing)
        n_exec = (int(live_step.any(axis=0).sum())
                  if self.segment_mode == "while" else self.segment_len)
        live_counts = live_step.sum(axis=1)  # live steps per slot
        if self.trace is not None:
            if self.spec is not None:
                self.trace.record_spec(
                    self.stats["segments"], self.n_slots, n_exec,
                    int(live_step.sum()), int(per_step[live_step].sum()))
            else:
                self.trace.record_decode(self.stats["segments"], self.n_slots,
                                         n_exec, int(live_counts.sum()))
            self.trace.annotate("serve.decode", rids, live_slot_steps=int(live_step.sum()))
        if self.segment_mode == "while":
            self.stats["steps_predicated"] += ran - n_exec
        self.stats["steps_total"] += n_exec
        eos = eng.sc.eos_token
        now = self.clock()
        for slot, req in enumerate(self.slots):
            if req is None:
                self.stats["slot_steps_masked"] += n_exec
                continue
            emitted = toks[slot]
            n_live = int(live_counts[slot])
            self.stats["slot_steps_live"] += n_live
            self.stats["slot_steps_masked"] += n_exec - n_live
            replay = self._replay.get(slot)
            saw_eos = emitted_any = False
            for t in emitted:
                if t < 0:
                    continue
                if replay is not None:
                    # replay after a recompute readmit: the device is
                    # re-deriving tokens the request already emitted —
                    # consume and verify instead of re-emitting (a replayed
                    # stream never contains eos and never reaches the
                    # budget, so finish checks don't apply)
                    want = replay.popleft()
                    assert int(t) == want, (req.rid, int(t), want)
                    self.stats["replayed_tokens"] += 1
                    if not replay:
                        del self._replay[slot]
                        replay = None
                    continue
                if len(req.tokens) < req.max_new_tokens:
                    req._emit(int(t))
                    self._count_token(req)
                    emitted_any = True
                    saw_eos = saw_eos or (eos >= 0 and t == eos)
            if emitted_any:
                self._note_emission_after_readmit(req, now)
            if saw_eos or len(req.tokens) >= req.max_new_tokens:
                req.state = FINISHED
                req.finish_reason = "stop" if saw_eos else "length"
                req.finish_t = now
                if self.policy is not None:
                    self.policy.observe_latency(req.priority,
                                                now - req.submit_t)
                self._vacate_slot(slot)
                self.stats["retired"] += 1
        if sp is not None:
            tr.close(sp, tokens=sum(self.stats["tenant_tokens"].values()) - streamed0,
                     retired=self.stats["retired"] - retired0)
        if debug:
            self.check_block_invariants()
        return sum(r is not None for r in self.slots)

    def _while_steps(self, stop_on_free: bool) -> int:
        """The steps a while segment can take, from the host's budgets: an
        active slot finishes after ``max_new − derived`` live steps, and
        the segment stops at the first finish (``stop_on_free``) or the
        last.  Only an eos stops it sooner; that the device predicates.
        A speculative round emits at least one token per live slot, so the
        bound holds for rounds too, loose by up to (k+1)×.  The engine
        reads the device's stop flag from the first round a budget could
        end the segment, one round behind the card after it, and replays
        no more once it is set; the steps (rounds) it ran past the stop
        are predicated and counted in ``stats["steps_predicated"]``.
        So the program runs at most this many steps instead of
        ``segment_len`` (the same token block, −1 past its stop; on the
        card, no device time spent on steps never taken)."""
        left = [req.max_new_tokens - self._dev_tokens(slot, req)
                for slot, req in enumerate(self.slots)
                if req is not None and self.active[slot]]
        return min(self.segment_len, min(left) if stop_on_free else max(left))

    # ----------------------------------------------------------------- run

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def run(self, max_segments: int = 100_000) -> None:
        """Drain the queue: run segments until every request has finished."""
        for _ in range(max_segments):
            if not self.has_work():
                return
            self.run_segment()
        raise RuntimeError(f"scheduler did not drain in {max_segments} segments")
