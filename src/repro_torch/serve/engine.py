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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.sonic_layers import quantize_serve_params
from repro_torch.kernels import counters
from repro_torch.models import registry
from repro_torch.models.registry import Arch
from repro_torch.serve.sampling import sample_token

LOOPS = ("scan", "while", "python")
KV_LAYOUTS = ("dense", "paged")
# "while": decode steps replayed between two host reads of ``done``
WHILE_CHECK_STEPS = 8


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
    # "int8" rewrites every linear projection into int8 block-sparse form;
    # ``weight_quant_sparsity`` > 0 also block-prunes (balanced top-|L1|,
    # the SONIC C1 structure); block=None picks the largest power-of-two
    # block (≤ 128) dividing each dim.
    weight_quant: str = "none"  # "none" | "int8"
    weight_quant_sparsity: float = 0.0
    weight_quant_block: tuple[int, int] | None = None


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
        params = _to_device(params, self.device)
        if sc.weight_quant == "int8":
            params = quantize_serve_params(params, sparsity=sc.weight_quant_sparsity,
                                           block=sc.weight_quant_block)
        self.arch, self.params, self.sc, self.cfg = arch, params, sc, arch.cfg
        self.cache_quant_int8 = cache_quant_int8
        self.graphs = sc.loop != "python" and self.device.type == "cuda"
        self.trace_counts: dict[str, int] = {"prefill": 0, "decode": 0}  # captures
        self.capture_seconds: dict[str, float] = {"prefill": 0.0, "decode": 0.0}
        self.call_counts: dict[str, int] = {"prefill": 0, "decode": 0}  # runs
        self._states: dict[int, _State] = {}
        self._prefills: dict[tuple[int, int], tuple[_Graph, torch.Tensor]] = {}
        self._decodes: dict[int, _Graph] = {}
        self._checked_contracts: set[str] = set()

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
                                      cache_pos=st.pos)
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

    def _capture(self, kind: str, fn: Callable[[], None], generator) -> _Graph:
        """``fn`` captured into a CUDA graph, with what its launches count;
        counted in ``trace_counts[kind]`` and timed (host clock) in
        ``capture_seconds[kind]``.  Raises if the capture fails."""
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
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
