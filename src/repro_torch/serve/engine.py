"""Batched serving engine: generation with per-sequence stopping over
SONIC int8 block-sparse weights, its decode loop replayed from CUDA graphs.

The port of ``repro.serve.engine`` for ``ServeEngine.generate`` and the
engine surface the continuous scheduler builds on.  Execution paths
(``ServeConfig.loop``), as in the reference:

  "scan"    (default) the reference's two compiled programs become CUDA
            graphs: one prefill + first sample per (B, S_prompt), and one
            decode step per B, captured once and replayed n_new − 1 times
            with no host round trip.  The step runs the forward over a KV
            cache the engine owns (updated in place), the sampler and eos
            pinning, and advances ``pos`` and the output column in place.
  "while"   the same graphs; every ``WHILE_CHECK_STEPS`` replays the host
            reads whether every sequence is done and stops if so (the
            untaken steps come back pinned to ``eos_token``).  Output-equal
            to "scan".
  "python"  the eager loop: the same prefill and step, issued from Python
            each time.
On the CPU (asked for by the caller, as the tests do) all three run eagerly.
A capture needs the card; one that fails raises, and nothing falls back to
the eager loop.

The first call at a shape runs the prefill and the first decode step
eagerly (the warm-up a capture needs), captures, and replays from then on;
later calls replay only.  ``trace_counts`` counts captures, as the
reference counts traces: a second ``generate`` at the same shape captures
nothing.  ``call_counts`` counts prefills and decode steps run, and the
kernel wrappers' ``.launches`` / ``.routes`` stay true per replay
(``kernels.counters``: each replay adds what its capture recorded).

Temperature sampling draws from the caller's ``torch.Generator``,
registered with each graph at capture (a graph is captured anew for another
generator object), so a replayed draw advances the generator as an eager
one does.

Under ``ServeConfig(weight_quant="int8")`` every linear projection (q, k,
v, o, wi, wg, wo and the LM head) is rewritten once, at construction, into
int8 block-sparse form (``core.sonic_layers.quantize_serve_params``), on the
engine's device; tensors already in that form pass through.
``cache_quant_int8`` (the reference's ``MeshPlan.cache_quant_int8``) keeps
the KV cache int8 with one fp32 scale per position and head.

Semantics (as in the reference): the first token is sampled from the
prefill logits and is never eos-pinned; every subsequent token is
eos-checked, and once a sequence has emitted ``eos_token`` all its later
tokens are pinned to ``eos_token``.

Slot programs (continuous batching, ``serve.scheduler``): the twelve
programs of the reference over a ``SlotState`` (the slot cache or paged
pool, ``tok`` / ``pos`` / ``done``, and the host policy uploaded before each
segment: ``active``, ``limit``, ``stop_on_free``, the block table), every
one updated in place at fixed addresses:

  prefill_slot[_paged]              one request (1, P) into one slot; a
                                    graph per prompt length P
  prefill_slots[_paged]             one chunk for up to W slots (W, Cb); a
                                    graph per (W, Cb)
  slot_segment[_while][_paged]      n_steps masked decode steps over every
                                    slot (``slot_step``)
  slot_spec_segment[_while][_paged] n_steps draft-and-verify rounds
                                    (``spec_step``, under ``ServeConfig.spec``)

A segment program is one graph of one step (or round) per geometry,
replayed once per step, which writes its emissions at the column a device
counter in the program's input names and advances it: one capture serves
every segment length.

Every value the reference traces (slot ids, starts, last-token offsets,
block-table rows, ``active`` / ``limit`` / ``stop_on_free``) is a device
buffer the host fills before a replay, from pinned memory, so nothing a
graph bakes in depends on the call.  The while segment has no early exit
on the device: each of its steps is predicated on a stop flag computed
there (every active slot done, or a slot just finished while
``stop_on_free`` is set); once it is set a step emits −1 and holds tok,
pos and done, which is the token block and state of the reference's loop
stopping at that step.  Such a step still rewrites each slot's k/v at its
frozen position, with the values the next real step writes there (a
predicated round writes only positions from the frozen cursor on, which
the next real window rewrites before it reads them).  The scheduler runs
it for only as many steps as the slots' budgets allow
(``ContinuousScheduler._while_steps``), so only an eos (or, speculating,
a round that emits more than one token) leaves predicated steps behind;
and the host reads the flag from the first round a budget could stop the
segment (one round behind the card after it) and replays no more once it
is set.
On the card each program is captured once per shape into one memory pool
shared by all the engine's slot graphs (the first call at a shape warms up
on a scratch copy of the state, then captures, then replays) and replayed
after; with ``loop="python"`` and on the CPU they run eagerly.  A slot
state belongs to the engine, one per (n_slots, n_blocks): a second
scheduler of the same geometry takes it over (with its graphs) and the
first may not run again.

Speculative decoding (``ServeConfig.spec = SpecConfig(k, draft=…)``, the
reference's): each segment step is a round that drafts k tokens with a
drafter derived from the served weights, verifies them in one
``decode_chunk`` window of the served model over ``[tok, d_1 … d_k]`` at
``pos … pos+k``, and emits the longest matching prefix plus the
verifier's token (``sampling.spec_accept``); rollback is cursor
truncation.  The drafters: ``"self"``, the unquantized weights pruned to
``draft_sparsity`` and kept block-sparse in the compute type
(``core.sonic_layers.sparse_draft_params``, on ``block_sparse_matmul``),
and ``"truncate:N"``, the served model's first N layers drafting from the
verifier's own cache (its leaves' first N layers, views: its k/v land in
the verifier's cache at ``pos … pos+k−1``, which the window rewrites
before it reads them).  Greedy only; paged, the window must fit a slot's
scratch block (k < block_len).  The engine pads its decode-style attention
to ``query_rows`` (``layers.decode_query_rows``: on the card the multiple of
16 at or above k + 1, 16 without speculation), so its decode steps and
verify windows run one shape and a decode row keeps its window row's bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.sonic_layers import (quantize_serve_params, sparse_draft_params,
                                           truncated_draft_params)
from repro_torch.kernels import counters
from repro_torch.models import registry
from repro_torch.models.layers import decode_query_rows
from repro_torch.models.registry import Arch
from repro_torch.serve.sampling import sample_token, spec_accept
from repro_torch.utils.logging import get_logger

log = get_logger("serve")

LOOPS = ("scan", "while", "python")
KV_LAYOUTS = ("dense", "paged")
# "while": decode steps replayed between two host reads of ``done``
WHILE_CHECK_STEPS = 8
# the reference's slot programs
SLOT_PROGRAMS = ("prefill_slot", "prefill_slots", "slot_segment",
                 "slot_segment_while", "prefill_slot_paged",
                 "prefill_slots_paged", "slot_segment_paged",
                 "slot_segment_while_paged", "slot_spec_segment",
                 "slot_spec_segment_while", "slot_spec_segment_paged",
                 "slot_spec_segment_while_paged")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding, the reference's: draft ``k`` tokens per step
    with a drafter derived from the served weights, verify them in one
    ``decode_chunk`` forward of the served model, emit the longest matching
    prefix (and the verifier's next token), roll the cursor back over the
    rest.

    ``draft``: ``"self"`` (the unquantized weights block-pruned to
    ``draft_sparsity``, with a ``draft_clusters``-entry codebook when > 0;
    ``draft_sparsity=0.0`` is an exact copy) or ``"truncate:N"`` (the
    served model's first N layers and its final norm and LM head, reading
    the verifier's KV cache).  Greedy only: acceptance is exact match, so
    the emitted stream is plain decoding's."""

    k: int = 4
    draft: str = "self"  # "self" | "truncate:N"
    draft_sparsity: float = 0.75
    draft_clusters: int = 0  # 0 ⇒ no codebook

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if not 0.0 <= self.draft_sparsity < 1.0:
            raise ValueError(f"draft_sparsity must be in [0, 1), got {self.draft_sparsity}")
        if self.draft != "self" and not (
                self.draft.startswith("truncate:")
                and self.draft.split(":", 1)[1].isdigit()
                and int(self.draft.split(":", 1)[1]) >= 1):
            raise ValueError(f"draft must be 'self' or 'truncate:N', got {self.draft!r}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token: int = -1  # -1 ⇒ never stop early
    loop: str = "scan"  # "scan" | "while" | "python"
    # the continuous scheduler's cache layout: "dense" = one max_len row per
    # slot; "paged" = a pool of block_len-sized KV blocks + a block table
    # (``init_paged_cache``; ``generate`` serves the dense cache either way)
    kv_layout: str = "dense"  # "dense" | "paged"
    block_len: int = 16
    # speculative decoding for the continuous scheduler; None = one token
    # per step.  Families without chunk-resume fall back with
    # ``engine.spec_skip_reason``
    spec: SpecConfig | None = None
    # "int8" rewrites every linear projection into int8 block-sparse form;
    # ``weight_quant_sparsity`` > 0 also block-prunes (balanced top-|L1|,
    # the SONIC C1 structure); block=None picks the largest power-of-two
    # block (≤ 128) dividing each dim.
    weight_quant: str = "none"  # "none" | "int8"
    weight_quant_sparsity: float = 0.0
    weight_quant_block: tuple[int, int] | None = None
    # run the scheduler's allocator / table / commitment invariant checks
    # at the end of every segment (host dicts only, never the device)
    debug_invariants: bool = False
    # the continuous scheduler owns a ``serve.trace.TraceRecorder`` (host
    # counters priced through ``roofline.analytic``); False = no recorder
    trace: bool = False


@contextlib.contextmanager
def no_gc():
    """No garbage collection inside the block (the collector's state
    restored after): wrap a CUDA graph capture in it, since a collected
    cycle may hold another graph, and destroying a graph invalidates the
    capture in progress."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _has_kernels(tree) -> bool:
    """Whether a param tree holds unquantized ``"kernel"`` leaves."""
    return isinstance(tree, dict) and ("kernel" in tree or any(
        _has_kernels(v) for v in tree.values()))


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclasses.dataclass
class _State:
    """One batch size's device state, updated in place by the prefill and
    every step: the KV cache, the carried token, its position, the done
    flags, the output columns and the count of tokens emitted."""

    cache: dict
    tok: torch.Tensor  # (B,) int64
    pos: torch.Tensor  # (B,) int64
    done: torch.Tensor  # (B,) bool
    out: torch.Tensor  # (B, max_len) int64
    n_out: torch.Tensor  # (1,) int64: the next output column
    logits: torch.Tensor  # (B, V) fp32: the last logits sampled from


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    generator: torch.Generator | None
    launches: counters.Counts  # what one replay launches


@dataclasses.dataclass
class _Program:
    """One slot program at one shape: its input buffer (what the host fills
    before a run), its output (the graph's, or the last eager run's; a
    round program's is a buffer it keeps, written a column per round) and,
    on the card, its graph."""

    inp: torch.Tensor
    out: torch.Tensor | None = None
    graph: _Graph | None = None


class SlotState:
    """The continuous scheduler's device state, updated in place by every
    slot program: the slot cache (dense: one ``max_len`` row per slot) or
    paged pool (``n_slots`` scratch blocks, then ``n_blocks``), ``tok`` /
    ``pos`` (n_slots,) int64 and ``done`` (n_slots,) bool, and the segment
    policy buffer ``policy`` = [active, limit, stop_on_free, block table],
    int64, uploaded before each segment.  ``generator`` draws temperature
    samples (None when greedy).  ``programs`` holds the captured graphs."""

    def __init__(self, cache: dict, n_slots: int, max_blocks: int, device,
                 generator: torch.Generator | None):
        self.cache, self.n_slots, self.max_blocks = cache, n_slots, max_blocks
        self.tok = torch.zeros((n_slots,), dtype=torch.long, device=device)
        self.pos = torch.zeros((n_slots,), dtype=torch.long, device=device)
        self.done = torch.zeros((n_slots,), dtype=torch.bool, device=device)
        self.policy = torch.zeros((2 * n_slots + 1 + n_slots * max_blocks,),
                                  dtype=torch.long, device=device)
        self.generator = generator
        self.programs: dict[tuple, _Program] = {}
        self.owner: object | None = None

    @property
    def active(self) -> torch.Tensor:
        return self.policy[:self.n_slots].bool()

    @property
    def limit(self) -> torch.Tensor:
        return self.policy[self.n_slots:2 * self.n_slots]

    @property
    def stop_on_free(self) -> torch.Tensor:
        return self.policy[2 * self.n_slots].bool()

    @property
    def block_table(self) -> torch.Tensor:
        return self.policy[2 * self.n_slots + 1:].view(self.n_slots, self.max_blocks)

    def reset(self) -> None:
        """What a new scheduler starts from: tok, pos, done and the policy
        zeroed.  The cache keeps what it holds: a prefill overwrites a
        slot's row or the blocks it maps before anything reads them, and
        positions past a slot's cursor are masked."""
        for t in (self.tok, self.pos, self.done, self.policy):
            t.zero_()

    def scratch(self, generator: torch.Generator | None) -> "SlotState":
        """A copy to warm a program up on before its capture, drawing from
        ``generator`` (so the warm-up leaves this state's untouched)."""
        other = SlotState.__new__(SlotState)
        other.__dict__.update(self.__dict__)
        other.generator = generator
        other.cache = {k: v.clone() for k, v in self.cache.items()}
        for name in ("tok", "pos", "done", "policy"):
            setattr(other, name, getattr(self, name).clone())
        return other


class ServeEngine:
    def __init__(self, arch: Arch, params: dict, sc: ServeConfig, device="cuda", *,
                 cache_quant_int8: bool = False):
        if sc.weight_quant not in ("none", "int8"):
            raise ValueError(f"weight_quant must be 'none' or 'int8', got {sc.weight_quant!r}")
        if sc.loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, got {sc.loop!r}")
        if sc.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {sc.kv_layout!r}")
        if sc.kv_layout == "paged" and sc.max_len % sc.block_len:
            # max_blocks·block_len == max_len keeps the gathered virtual
            # cache the dense row's shape, which the bitwise contract needs
            raise ValueError(f"max_len {sc.max_len} is not a multiple of block_len "
                             f"{sc.block_len}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to serve "
                               "on the CPU")
        if self.device.type == "cuda" and self.device.index is None:
            # the card this thread means by "cuda", named: another thread
            # (the front door's worker) serves on the same one
            self.device = torch.device("cuda", torch.cuda.current_device())
        raw = params = _to_device(params, self.device)  # raw: the "self" drafter's source
        if sc.weight_quant == "int8":
            params = quantize_serve_params(params, sparsity=sc.weight_quant_sparsity,
                                           block=sc.weight_quant_block)
        self.arch, self.params, self.sc, self.cfg = arch, params, sc, arch.cfg
        self.cache_quant_int8 = cache_quant_int8
        self.graphs = sc.loop != "python" and self.device.type == "cuda"
        self._resolve_drafter(raw)
        self.query_rows = decode_query_rows(self.device.type,
                                            self.spec.k if self.spec is not None else 0)
        names = ("prefill", "decode", *SLOT_PROGRAMS)
        self.trace_counts: dict[str, int] = dict.fromkeys(names, 0)  # captures
        self.capture_seconds: dict[str, float] = dict.fromkeys(names, 0.0)
        self.call_counts: dict[str, int] = dict.fromkeys(names, 0)  # runs
        # slot programs run eagerly on the card (none should, but with
        # loop="python"), and the device memory reserved while capturing
        # them into their one shared pool
        self.slot_eager_runs = 0
        self.slot_graph_bytes = 0
        self.slot_graph_bytes_by_program = dict.fromkeys(SLOT_PROGRAMS, 0)
        self._slot_pool = None
        self._states: dict[int, _State] = {}
        self._slot_states: dict[tuple[int, int | None], SlotState] = {}
        self._prefills: dict[tuple[int, int], tuple[_Graph, torch.Tensor]] = {}
        self._decodes: dict[int, _Graph] = {}
        self._checked_contracts: set[str] = set()

    def _resolve_drafter(self, raw: dict) -> None:
        """``spec``, ``spec_skip_reason``, ``draft_params`` and ``draft_cfg``
        from ``sc.spec``, as the reference resolves them: a family that
        cannot chunk-resume falls back to plain decoding with the reason;
        what cannot be served as asked raises ``ValueError``."""
        sc = self.sc
        self.spec, self.spec_skip_reason = sc.spec, ""
        self.draft_params = self.draft_cfg = None
        if sc.spec is None:
            return
        if sc.temperature > 0.0:
            raise ValueError("speculative decoding is greedy-only: acceptance is exact "
                             "match against the greedy verifier (temperature must be 0)")
        reason = self.arch.spec_decode_skip_reason()
        if reason:
            self.spec, self.spec_skip_reason = None, reason
            log.warning("speculative decoding disabled, falling back to plain decode: "
                        "%s", reason)
            return
        k = sc.spec.k
        if sc.kv_layout == "paged" and k >= sc.block_len:
            raise ValueError(f"spec.k {k} must be < block_len {sc.block_len} (the "
                             f"k+1-token verify window of a masked slot must fit its "
                             f"scratch block)")
        if sc.spec.draft == "self":
            if not _has_kernels(raw.get("layers", {})):
                raise ValueError("draft='self' prunes the unquantized weights: pass the "
                                 "raw params (with 'kernel' leaves), not a quantized tree")
            self.draft_cfg = self.cfg
            self.draft_params = sparse_draft_params(
                raw, sc.spec.draft_sparsity, num_clusters=sc.spec.draft_clusters,
                dtype=getattr(torch, self.cfg.compute_dtype))
        else:
            n = int(sc.spec.draft.split(":", 1)[1])
            if not 1 <= n <= self.cfg.n_layers:
                raise ValueError(f"draft {sc.spec.draft!r}: the model has "
                                 f"{self.cfg.n_layers} layers")
            self.draft_cfg = self.cfg.replace(n_layers=n)
            self.draft_params = truncated_draft_params(self.params, n)

    # ------------------------------------------------------------ the step

    def _state(self, b: int) -> _State:
        if b not in self._states:
            dev, n = self.device, self.sc.max_len
            self._states[b] = _State(
                cache=self.arch.init_cache(b, n, dev, cache_quant_int8=self.cache_quant_int8),
                tok=torch.zeros((b,), dtype=torch.long, device=dev),
                pos=torch.zeros((b,), dtype=torch.long, device=dev),
                done=torch.zeros((b,), dtype=torch.bool, device=dev),
                out=torch.zeros((b, n), dtype=torch.long, device=dev),
                n_out=torch.zeros((1,), dtype=torch.long, device=dev),
                logits=torch.zeros((b, self.cfg.vocab_size), dtype=torch.float32, device=dev))
        return self._states[b]

    def _sample(self, logits: torch.Tensor, generator) -> torch.Tensor:
        sc = self.sc
        return sample_token(logits, sc.temperature, generator, sc.top_k, sc.top_p)

    def _prefill(self, st: _State, prompts: torch.Tensor, generator) -> None:
        """Prefill ``prompts`` (B, S) into the zeroed cache and sample the
        first token (never eos-pinned) into column 0."""
        for leaf in st.cache.values():
            leaf.zero_()
        logits, _ = self.arch.forward(self.params, tokens=prompts, cache=st.cache)
        last = logits[:, -1]
        st.logits.copy_(last.float())
        st.tok.copy_(self._sample(last, generator))
        st.pos.fill_(prompts.shape[1])
        st.done.zero_()
        st.out[:, 0].copy_(st.tok)
        st.n_out.fill_(1)

    def _step(self, st: _State, generator) -> None:
        """One decode step, in place: forward the carried token at ``pos``,
        sample, eos-check and pin, write the next output column."""
        logits, _ = self.arch.forward(self.params, tokens=st.tok[:, None], cache=st.cache,
                                      cache_pos=st.pos, query_rows=self.query_rows)
        last = logits[:, 0]
        st.logits.copy_(last.float())
        nxt = self._sample(last, generator)
        if self.sc.eos_token >= 0:
            torch.logical_or(st.done, nxt == self.sc.eos_token, out=st.done)
            nxt = torch.where(st.done, self.sc.eos_token, nxt)
        st.tok.copy_(nxt)
        st.out.index_copy_(1, st.n_out, nxt[:, None])
        st.n_out.add_(1)
        st.pos.add_(1)

    def _capture(self, kind: str, fn: Callable[[], None], generator, pool=None) -> _Graph:
        """``fn`` captured into a CUDA graph (in memory pool ``pool``, else
        its own), with what its launches count; counted in
        ``trace_counts[kind]`` and timed (host clock) in
        ``capture_seconds[kind]``.  Raises if the capture fails."""
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with no_gc(), torch.cuda.graph(graph, pool=pool):
            fn()
        launches = counters.diff(counters.snapshot(), before)
        counters.restore(before)  # a capture runs nothing
        self.capture_seconds[kind] += time.perf_counter() - t0
        self.trace_counts[kind] += 1
        return _Graph(graph, generator, launches)

    def _replay(self, g: _Graph, times: int = 1) -> None:
        for _ in range(times):
            g.graph.replay()
        counters.add(g.launches, times)

    @staticmethod
    def _graph_for(g: _Graph | None, generator) -> bool:
        """Whether captured graph ``g`` serves a call with ``generator``: a
        draw must advance the generator the caller gave."""
        return g is not None and g.generator is generator

    # ------------------------------------------------------------- public

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, n_new: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts (B, S_prompt) int → (B, n_new) generated tokens (int64).

        ``generator`` (on the engine's device) drives temperature sampling;
        greedy decoding ignores it."""
        sc = self.sc
        b, s_prompt = prompts.shape
        if n_new < 1 or s_prompt + n_new > sc.max_len:
            raise ValueError(f"prompt {s_prompt} + {n_new} new tokens must fit "
                             f"max_len {sc.max_len}")
        if sc.temperature <= 0.0:
            generator = None  # greedy draws nothing
        st = self._state(b)
        self._run_prefill(st, prompts, generator)
        steps = n_new - 1
        if self.graphs and steps:
            g = self._decodes.get(b)
            if not self._graph_for(g, generator):
                self._step(st, generator)  # a real step, and the capture's warm-up
                self.call_counts["decode"] += 1
                steps -= 1
                g = self._decodes[b] = self._capture(
                    "decode", lambda: self._step(st, generator), generator)
            step = lambda n: self._replay(g, n)  # noqa: E731
        else:
            def step(n):
                for _ in range(n):
                    self._step(st, generator)
        if sc.loop == "while" and sc.eos_token >= 0:
            while steps:
                n = min(WHILE_CHECK_STEPS, steps)
                step(n)
                self.call_counts["decode"] += n
                steps -= n
                if steps and bool(st.done.all()):
                    st.out[:, n_new - steps:n_new].fill_(sc.eos_token)
                    break
        else:
            step(steps)
            self.call_counts["decode"] += steps
        return st.out[:, :n_new].clone()

    def _run_prefill(self, st: _State, prompts: torch.Tensor, generator) -> None:
        b, s = prompts.shape
        prompts = prompts.to(self.device, torch.long)
        self.call_counts["prefill"] += 1
        key = (b, s)
        if not self.graphs:
            self._prefill(st, prompts, generator)
            return
        entry = self._prefills.get(key)
        if entry is not None and self._graph_for(entry[0], generator):
            g, buf = entry
            buf.copy_(prompts)
            self._replay(g)
            return
        self._prefill(st, prompts, generator)  # a real prefill, and the warm-up
        buf = prompts.clone()
        g = self._capture("prefill", lambda: self._prefill(st, buf, generator), generator)
        self._prefills[key] = (g, buf)

    def graph_launches(self) -> dict[str, dict]:
        """What one replay of each captured graph launches, by kernel
        wrapper (launches, routes): {"prefill": {(B, S): …}, "decode":
        {B: …}}."""
        return {"prefill": {key: g.launches for key, (g, _) in self._prefills.items()},
                "decode": {b: g.launches for b, g in self._decodes.items()}}

    @property
    def last_logits(self) -> dict[int, torch.Tensor]:
        """The logits each batch size's last prefill or step sampled from."""
        return {b: st.logits for b, st in self._states.items()}

    # ------------------------------------- the continuous scheduler's surface

    def init_slot_cache(self, n_slots: int) -> dict:
        """Fresh slot cache (batch = n_slots, length = max_len) for the
        continuous-batching scheduler; checks the per-slot write contract
        once per engine."""
        if "slot" not in self._checked_contracts:
            registry.check_slot_cache_contract(self.arch, cfg=self.cfg,
                                               cache_quant_int8=self.cache_quant_int8)
            self._checked_contracts.add("slot")
        return self.arch.init_cache(n_slots, self.sc.max_len, self.device,
                                    cache_quant_int8=self.cache_quant_int8)

    def check_chunked_prefill_contract(self) -> None:
        """Check the multi-slot scatter + chunk-resume contract once per
        engine; raises NotImplementedError with the family's
        ``chunked_prefill_skip_reason`` where it has none."""
        if "slots" not in self._checked_contracts:
            registry.check_slots_cache_contract(self.arch, cfg=self.cfg,
                                                cache_quant_int8=self.cache_quant_int8)
            self._checked_contracts.add("slots")

    @property
    def max_blocks_per_slot(self) -> int:
        """Logical blocks a slot can address = max_len / block_len (the
        gathered virtual cache is exactly max_len long)."""
        return self.sc.max_len // self.sc.block_len

    def init_paged_cache(self, n_blocks: int, n_slots: int = 1) -> dict:
        """Fresh paged KV pool of ``n_blocks`` allocatable blocks plus
        ``n_slots`` per-slot scratch blocks (physical ids 0..n_slots−1);
        checks the paged contract once per engine."""
        if "paged" not in self._checked_contracts:
            registry.check_paged_cache_contract(self.arch, cfg=self.cfg,
                                                cache_quant_int8=self.cache_quant_int8)
            self._checked_contracts.add("paged")
        return self.arch.init_paged_cache(n_slots + n_blocks, self.sc.block_len, self.device,
                                          cache_quant_int8=self.cache_quant_int8)

    # ------------------------------------------------------- slot programs

    def slot_state(self, n_slots: int, n_blocks: int | None = None,
                   seed: int = 0) -> SlotState:
        """The engine's slot state for ``n_slots`` slots (and, paged,
        ``n_blocks`` allocatable blocks), made on first use and reset
        (tok / pos / done / policy zeroed, the generator seeded with
        ``seed``) on every later one; its graphs are kept."""
        paged = self.sc.kv_layout == "paged"
        if paged != (n_blocks is not None):
            raise ValueError("n_blocks applies to kv_layout='paged' only, and is "
                             "required there")
        key = (n_slots, n_blocks)
        st = self._slot_states.get(key)
        if st is None:
            cache = (self.init_paged_cache(n_blocks, n_slots) if paged
                     else self.init_slot_cache(n_slots))
            gen = (torch.Generator(device=self.device) if self.sc.temperature > 0.0
                   else None)
            st = self._slot_states[key] = SlotState(
                cache, n_slots, self.max_blocks_per_slot if paged else 0, self.device, gen)
        st.reset()
        if st.generator is not None:
            st.generator.manual_seed(seed)
        return st

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """dst ← arr (int64), from pinned memory without a host sync on the
        card (the pinned block is not reused before the copy has run)."""
        src = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64).reshape(-1))
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _run_slot(self, st: SlotState, name: str, shape: tuple, inp: np.ndarray,
                  body: Callable[[SlotState, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """Run slot program ``name`` at ``shape`` with host input ``inp``:
        eagerly on the CPU and under loop="python", else replayed from its
        graph (captured at the first call at this shape, after a warm-up
        on a scratch copy of the state).  Returns the program's output, a
        fresh tensor (a replay overwrites the graph's)."""
        self.call_counts[name] += 1
        prog = st.programs.get((name, shape))
        if prog is None:
            prog = st.programs[(name, shape)] = _Program(
                torch.empty((inp.size,), dtype=torch.long, device=self.device))
        self._upload(prog.inp, inp)
        if not self.graphs:
            if self.device.type == "cuda":
                self.slot_eager_runs += 1
            return body(st, prog.inp)
        if prog.graph is None:
            warm = torch.Generator(device=self.device) if st.generator is not None else None
            body(st.scratch(warm), prog.inp)
            out = []
            prog.graph = self._capture_slot(name, st, lambda: out.append(body(st, prog.inp)))
            prog.out = out[0]
        self._replay(prog.graph)
        return prog.out.clone()

    def _capture_slot(self, name: str, st: SlotState, fn: Callable[[], None]) -> _Graph:
        """``fn`` captured into the slot graphs' shared pool, the device
        memory the capture reserved counted in ``slot_graph_bytes`` (and by
        program)."""
        if self._slot_pool is None:
            self._slot_pool = torch.cuda.graph_pool_handle()
        torch.cuda.empty_cache()  # as the capture does: count only what it adds
        reserved = torch.cuda.memory_reserved(self.device)
        g = self._capture(name, fn, st.generator, pool=self._slot_pool)
        grown = torch.cuda.memory_reserved(self.device) - reserved
        self.slot_graph_bytes += grown
        self.slot_graph_bytes_by_program[name] += grown
        return g

    def _run_rounds(self, st: SlotState, name: str, rounds: int, out_shape: tuple,
                    body: Callable[[SlotState, torch.Tensor, torch.Tensor], None],
                    first_check: int = 0) -> torch.Tensor:
        """Run slot program ``name`` as ``rounds`` runs of one round
        ``body(state, inp, out)``, which writes its column of ``out`` (a
        buffer of ``out_shape`` kept with the program) where ``inp[0]``
        says and advances it: eagerly on the CPU and under loop="python",
        else replayed from one graph per geometry (captured at the first
        call, after a warm-up on a scratch copy of the state).

        ``first_check`` (while segments): the host waits for that many
        rounds and reads whether the segment has stopped (``_running``);
        after it, it reads each round's stop flag while the next round
        runs, so the card is never left waiting on the host, and runs no
        more rounds once the flag is set (one round at most runs past a
        stop found this way).  Returns the columns of the rounds run, a
        fresh tensor."""
        self.call_counts[name] += 1
        prog = st.programs.get((name, ()))
        if prog is None:
            prog = st.programs[(name, ())] = _Program(
                torch.empty((1,), dtype=torch.long, device=self.device),
                torch.full(out_shape, -1, dtype=torch.long, device=self.device))
        start = np.zeros(1, np.int64)  # the first round's column
        self._upload(prog.inp, start)
        if not self.graphs:
            if self.device.type == "cuda":
                self.slot_eager_runs += 1

            def run(n: int) -> None:
                for _ in range(n):
                    body(st, prog.inp, prog.out)
        else:
            if prog.graph is None:
                warm = (torch.Generator(device=self.device) if st.generator is not None
                        else None)
                body(st.scratch(warm), prog.inp, prog.out)
                self._upload(prog.inp, start)  # the warm-up advanced the column
                prog.graph = self._capture_slot(
                    name, st, lambda: body(st, prog.inp, prog.out))

            def run(n: int) -> None:
                self._replay(prog.graph, n)
        ran = min(first_check, rounds) if first_check else rounds
        run(ran)
        if ran < rounds and bool(self._running(st)):
            cuda = self.device.type == "cuda"
            flag = torch.empty((), dtype=torch.bool, pin_memory=cuda)
            read = torch.cuda.Event() if cuda else None
            while ran < rounds:
                flag.copy_(self._running(st), non_blocking=True)
                if read is not None:
                    read.record()
                run(1)
                ran += 1
                if read is not None:
                    read.synchronize()
                if not bool(flag):
                    break
        return prog.out[:, :ran].clone()

    def _slot_step(self, st: SlotState, active: torch.Tensor, limit: torch.Tensor,
                   block_table: torch.Tensor | None, go: torch.Tensor | None) -> torch.Tensor:
        """One masked decode step over every slot, in place (the reference's
        ``slot_step``, shared by every segment).  Inactive and done slots
        still flow through the forward but are masked: pos frozen, token
        held, emitted −1.  ``go`` (while segments): where it is False
        nothing advances, as if the loop had stopped."""
        sc = self.sc
        logits, _ = self.arch.forward(self.params, tokens=st.tok[:, None], cache=st.cache,
                                      cache_pos=st.pos, block_table=block_table,
                                      query_rows=self.query_rows)
        nxt = self._sample(logits[:, 0], st.generator)
        live = active & ~st.done
        if go is not None:
            live = live & go
        done = st.done
        if sc.eos_token >= 0:
            done = done | (live & (nxt == sc.eos_token))
        emitted = torch.where(live, nxt, -1)
        st.tok.copy_(torch.where(live, nxt, st.tok))
        pos = torch.where(live, st.pos + 1, st.pos)
        st.pos.copy_(pos)
        done = done | (active & (pos >= limit))
        st.done.copy_(done if go is None else torch.where(go, done, st.done))
        return emitted

    def slot_segment(self, st: SlotState, n_steps: int, mode: str, active: np.ndarray,
                     limit: np.ndarray, stop_on_free: bool = False,
                     block_table: np.ndarray | None = None) -> torch.Tensor:
        """``n_steps`` masked decode steps over every slot → the emitted
        tokens of the steps run (n_slots, ≤ n_steps), −1 where a slot was
        masked.  ``mode`` "while" stops (predicated, see the module
        docstring) when every active slot is done, or a slot has finished
        and ``stop_on_free``; the host stops replaying soon after
        (``_segment``)."""
        return self._segment(st, "slot_segment", self._slot_step, (), n_steps, mode, active,
                             limit, stop_on_free, block_table)

    def _segment(self, st: SlotState, base: str, step: Callable, width: tuple, n_steps: int,
                 mode: str, active, limit, stop_on_free, block_table) -> torch.Tensor:
        """A segment program: ``n_steps`` runs of one round ``step`` (each
        emitting ``(n_slots, *width)``, up to ``width[0]`` tokens a slot),
        one graph per geometry on the card.  Rounds past ``max_len`` are
        not run: a live round advances a slot's cursor, so every active
        slot is done by then.  A while segment's ``n_steps`` is the host's
        bound on its tokens (``ContinuousScheduler._while_steps``), so no
        budget stops it before round ceil(n_steps / width[0]), and the host
        first reads its stop flag there (an eos may stop it sooner: with
        an eos token, from the first round)."""
        name = self._segment_name(base, mode)
        self._upload_policy(st, active, limit, stop_on_free, block_table)
        paged = self.sc.kv_layout == "paged"

        def round_(s: SlotState, inp: torch.Tensor, out: torch.Tensor) -> None:
            go = self._running(s) if mode == "while" else None
            emitted = step(s, s.active, s.limit, s.block_table if paged else None, go)
            col = inp[:1]
            out.index_copy_(1, col, emitted[:, None])
            col.add_(1)

        first = 0
        if mode == "while":
            first = 1 if self.sc.eos_token >= 0 else -(-n_steps // (width[0] if width else 1))
        return self._run_rounds(st, name, min(n_steps, self.sc.max_len),
                                (st.n_slots, self.sc.max_len, *width), round_, first)

    def _segment_name(self, base: str, mode: str) -> str:
        if mode not in ("scan", "while"):
            raise ValueError(f"mode must be 'scan' or 'while', got {mode!r}")
        return (base + ("_while" if mode == "while" else "")
                + ("_paged" if self.sc.kv_layout == "paged" else ""))

    def _upload_policy(self, st: SlotState, active, limit, stop_on_free, block_table) -> None:
        pol = np.zeros(st.policy.shape[0], np.int64)
        n = st.n_slots
        pol[:n], pol[n:2 * n], pol[2 * n] = active, limit, stop_on_free
        if self.sc.kv_layout == "paged":
            pol[2 * n + 1:] = np.asarray(block_table).reshape(-1)
        self._upload(st.policy, pol)

    @staticmethod
    def _running(s: SlotState) -> torch.Tensor:
        """A while segment's loop condition on the device: some active slot
        is not done, and no slot has finished while ``stop_on_free``."""
        act = s.active
        return (act & ~s.done).any() & ~(s.stop_on_free & (act & s.done).any())

    def _spec_step(self, st: SlotState, active: torch.Tensor, limit: torch.Tensor,
                   block_table: torch.Tensor | None, go: torch.Tensor | None) -> torch.Tensor:
        """One draft-and-verify round over every slot, in place (the
        reference's ``spec_step``) → the emissions (n_slots, k+1), −1 after
        each slot's accepted prefix and wherever it is masked.

        Draft: k decode steps of the drafter from the verifier's cache (the
        full-depth drafters thread the cache itself; ``truncate:N`` its
        first N layers' views), writing at ``pos … pos+k−1``.  Verify: one
        ``decode_chunk`` window of the served model over ``[tok, d_1 … d_k]``
        at ``pos … pos+k``, then ``spec_accept``.  Rollback: ``pos`` advances
        only over the accepted prefix; nothing past a cursor is read before
        the next window rewrites it.  Masked slots (and, with ``go`` False,
        all: a while segment that has stopped) hold tok, pos and done."""
        sc, k = self.sc, self.spec.k
        n_draft = self.draft_cfg.n_layers
        live = active & ~st.done
        if go is not None:
            live = live & go
        d_cache = (st.cache if n_draft == self.cfg.n_layers
                   else {name: leaf[:n_draft] for name, leaf in st.cache.items()})
        cur, window = st.tok, [st.tok]
        for i in range(k):
            dlogits, _ = self.arch.forward(self.draft_params, cfg=self.draft_cfg,
                                           tokens=cur[:, None], cache=d_cache,
                                           cache_pos=st.pos + i, block_table=block_table,
                                           query_rows=self.query_rows)
            cur = torch.argmax(dlogits[:, 0], dim=-1)
            window.append(cur)
        window = torch.stack(window, dim=1)  # (n_slots, k+1)
        logits, _ = self.arch.forward(self.params, tokens=window, cache=st.cache,
                                      cache_pos=st.pos, block_table=block_table,
                                      decode_chunk=True, query_rows=self.query_rows)
        verify = torch.argmax(logits, dim=-1)
        emitted, n_emit, last = spec_accept(window, verify, live, st.pos, limit,
                                            sc.eos_token)
        st.tok.copy_(torch.where(live, last, st.tok))
        pos = st.pos + n_emit  # n_emit is 0 where not live
        stop = pos >= limit
        if sc.eos_token >= 0:
            stop = stop | (last == sc.eos_token)
        st.pos.copy_(pos)
        st.done.copy_(st.done | (live & stop))
        return emitted

    def spec_segment(self, st: SlotState, n_steps: int, mode: str, active: np.ndarray,
                     limit: np.ndarray, stop_on_free: bool = False,
                     block_table: np.ndarray | None = None) -> torch.Tensor:
        """``n_steps`` draft-and-verify rounds over every slot → the emitted
        tokens of the rounds run (n_slots, ≤ n_steps, k+1), −1 after each
        accepted prefix and where a slot was masked; "while" stops
        (predicated) as ``slot_segment`` does."""
        if self.spec is None:
            raise ValueError("spec_segment needs ServeConfig.spec (and a family that "
                             "can speculate)")
        kp1 = self.spec.k + 1
        return self._segment(st, "slot_spec_segment", self._spec_step, (kp1,), n_steps, mode,
                             active, limit, stop_on_free, block_table)

    def prefill_slot(self, st: SlotState, prompt: np.ndarray, slot: int,
                     bt_row: np.ndarray | None = None) -> torch.Tensor:
        """Prefill one request (P,) and install it into ``slot`` → its first
        token (1,).  The prefill runs over a (1, max_len) cache under both
        layouts, as ``generate`` does (its sums run over the same length,
        so its bits are generate's); dense writes the whole row into the
        slot, paged (``bt_row``: the slot's block-table row) the first
        ceil(P / block_len) blocks into the physical blocks the row maps."""
        paged = self.sc.kv_layout == "paged"
        name = "prefill_slot_paged" if paged else "prefill_slot"
        p_len = int(prompt.shape[0])
        mb = st.max_blocks
        inp = np.concatenate([[slot], bt_row if paged else [], prompt]).astype(np.int64)

        def body(s: SlotState, x: torch.Tensor) -> torch.Tensor:
            slot_t = torch.clamp(x[:1], 0, s.n_slots - 1)
            tokens = x[1 + mb:].view(1, p_len)
            small = self.arch.init_cache(1, self.sc.max_len, self.device,
                                         cache_quant_int8=self.cache_quant_int8)
            logits, small = self.arch.forward(self.params, tokens=tokens, cache=small)
            first = self._sample(logits[:, -1], s.generator)
            if paged:
                nb = -(-p_len // self.sc.block_len)
                registry.write_cache_block(
                    s.cache, {k: v[:, :, :nb * self.sc.block_len] for k, v in small.items()},
                    x[1:1 + nb])
            else:
                registry.write_cache_slot(s.cache, small, slot_t)
            s.tok.index_copy_(0, slot_t, first)
            s.pos.index_fill_(0, slot_t, p_len)
            s.done.index_fill_(0, slot_t, False)
            return first

        return self._run_slot(st, name, (p_len,), inp, body)

    def prefill_slots(self, st: SlotState, prompts: np.ndarray, slots: np.ndarray,
                      starts: np.ndarray, last_local: np.ndarray,
                      bt_rows: np.ndarray | None = None) -> torch.Tensor:
        """Prefill one chunk (W, Cb) for up to W slot rows in one launch →
        the first token sampled at each row's last real token (W,).  A slot
        id out of range marks a dummy row: its gather clamps and every one
        of its writes drops (the reference's mode="drop"), with no host
        sync.  Dense: the rows are gathered, resumed at ``starts`` and
        scattered back; paged (``bt_rows`` (W, max_blocks), dummy rows with
        distinct out-of-range block ids): the chunk scatters straight into
        each row's blocks."""
        paged = self.sc.kv_layout == "paged"
        name = "prefill_slots_paged" if paged else "prefill_slots"
        w, cb = prompts.shape
        mb = st.max_blocks
        inp = np.concatenate([slots, starts, last_local, prompts.reshape(-1)]
                             + ([bt_rows.reshape(-1)] if paged else [])).astype(np.int64)

        def body(s: SlotState, x: torch.Tensor) -> torch.Tensor:
            slots_t, starts_t, last_t = x[:w], x[w:2 * w], x[2 * w:3 * w]
            tokens = x[3 * w:3 * w + w * cb].view(w, cb)
            if paged:
                bt = x[3 * w + w * cb:].view(w, mb)
                logits, _ = self.arch.forward(self.params, tokens=tokens, cache=s.cache,
                                              cache_pos=starts_t, block_table=bt)
            else:
                small = registry.gather_cache_slots(s.cache, slots_t)
                logits, small = self.arch.forward(self.params, tokens=tokens, cache=small,
                                                  cache_pos=starts_t)
                registry.write_cache_slots(s.cache, small, slots_t)
            last = torch.gather(logits, 1, last_t[:, None, None].expand(
                w, 1, logits.shape[-1]))[:, 0]
            firsts = self._sample(last, s.generator)
            # tok / pos / done at the rows' slots, dummy rows dropped: the
            # slot-cache scatter over (1, n_slots) views
            registry.write_cache_slots(
                {"tok": s.tok[None], "pos": s.pos[None], "done": s.done[None]},
                {"tok": firsts[None], "pos": (starts_t + last_t + 1)[None],
                 "done": torch.zeros_like(firsts, dtype=torch.bool)[None]}, slots_t)
            return firsts

        return self._run_slot(st, name, (w, cb), inp, body)

    def slot_graph_launches(self) -> dict[tuple, counters.Counts]:
        """What one replay of each captured slot graph launches, by
        (n_slots, n_blocks, program, shape)."""
        return {(*key, *pk): prog.graph.launches
                for key, st in self._slot_states.items()
                for pk, prog in st.programs.items() if prog.graph is not None}
