"""The JAX package's serving engine and the port's side by side, for the
``tests/test_torch_scheduler*.py`` files (not collected: no ``test_``
prefix).

Reduced tinyllama (or ``make_sides``'s arch), fp32 compute on both sides,
int8 weights at (16, 16) and sparsity 0.5 (as
``tests/test_torch_serve_loops.py``; or ``make_sides``'s), the port's weights
from ``convert.params_from_jax``; workloads drawn with numpy.  ``parity``
runs both schedulers over one workload with a fake clock and requires
equal per-request greedy tokens, states, ``finish_reason``s and host
counters.  A ``spec=SpecConfig(...)`` engine argument (the port's) gives
the JAX engine the same ``SpecConfig``.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.models.registry import get_arch as jax_get_arch
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpecConfig as JaxSpecConfig
from repro.sharding.mesh import MeshPlan
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler

QUANT = dict(weight_quant="int8", weight_quant_sparsity=0.5, weight_quant_block=(16, 16))
MAX_LEN, BLOCK_LEN = 64, 8
SPEC_COUNTERS = ("spec_steps", "spec_emitted", "accepted_hist", "spec_skip_reason")
COUNTERS = ("admitted", "retired", "segments", "steps_total", "slot_steps_live",
            "slot_steps_masked", "preemptions", "readmits", "replayed_tokens",
            "blocks_grown", "admit_deferred", "cancelled", "expired", "chaos_exhausts",
            "chaos_cancels", "chaos_slot_failures")


def make_sides(arch_id: str = "tinyllama-1.1b", weights: dict = QUANT):
    """engines(layout="dense", quant=False, compute="float32", **ServeConfig
    fields) → the (JAX, port) engine pair of the reduced ``arch_id`` with
    the ServeConfig fields ``weights``, made once per arguments.

    Parity with JAX runs in fp32 compute.  The port's own bitwise contracts
    that involve a chunked prefill run in the served bf16 compute: in fp32
    a whole-prompt prefill attends its fresh fp32 k/v while a chunk-resume
    attends the bf16 cache it wrote, in both packages, so the two differ
    there by design."""
    raw = jax_get_arch(arch_id, reduced=True).init_params(jax.random.PRNGKey(0))
    raw_t = params_from_jax(jax.tree_util.tree_map(np.array, raw), "cpu")
    made = {}

    def engines(layout="dense", quant=False, compute="float32", **kw):
        key = (layout, quant, compute, tuple(sorted(kw.items())))
        if key not in made:
            sc = {"max_len": MAX_LEN, "kv_layout": layout, "block_len": BLOCK_LEN, **weights,
                  **kw}
            spec = sc.get("spec")
            jsc = {**sc, "spec": spec and JaxSpecConfig(**dataclasses.asdict(spec))}
            jarch = jax_get_arch(arch_id, reduced=True)
            arch = get_arch(arch_id, reduced=True)
            made[key] = (
                JaxServeEngine(dataclasses.replace(jarch, cfg=jarch.cfg.replace(
                    compute_dtype=compute)), raw, MeshPlan(cache_quant_int8=quant),
                    JaxServeConfig(**jsc)),
                ServeEngine(dataclasses.replace(arch, cfg=arch.cfg.replace(
                    compute_dtype=compute)), raw_t, ServeConfig(**sc), device="cpu",
                    cache_quant_int8=quant))
        return made[key]

    return engines


def sides_fixture(*args):
    """The body of each file's module-scoped ``sides`` fixture: the engines
    of ``make_sides(*args)``, with torch on one CPU thread meanwhile (at
    these sizes one thread is as fast, and the test run's workers do not
    oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield make_sides(*args)
    finally:
        torch.set_num_threads(threads)


def prompts_of(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).astype(np.int32) for n in lens]


def generate(eng: ServeEngine, prompt: np.ndarray, n: int) -> list[int]:
    """The port's B = 1 oracle."""
    return eng.generate(torch.from_numpy(prompt)[None].long(), n)[0].tolist()


def drain(sched, check=False, each=None, max_segments=10_000):
    for _ in range(max_segments):
        if not sched.has_work():
            return sched
        sched.run_segment()
        if check:
            sched.check_block_invariants()
        if each is not None:
            each(sched)
    raise RuntimeError("scheduler did not drain")


def check_parity(jax_side, port_side, spec_stats=False):
    """((handles, scheduler) of JAX, of the port): equal tokens, states,
    finish reasons and counters (with ``spec_stats``, the speculative ones
    too)."""
    (jh, js), (th, ts) = jax_side, port_side
    for a, b in zip(jh, th, strict=True):
        assert b.tokens == a.tokens, b.rid
        assert (b.state, b.finish_reason) == (a.state, a.finish_reason), b.rid
    names = COUNTERS + (SPEC_COUNTERS if spec_stats else ())
    assert {k: ts.stats[k] for k in names} == {k: js.stats[k] for k in names}
    assert ts.stats["admissions_per_slot"] == js.stats["admissions_per_slot"]
    assert ts.stats["prefill_tokens_per_round"] == js.stats["prefill_tokens_per_round"]


def parity(sides, prompts, news, layout="dense", quant=False, engine_kw=None,
           check=False, each=None, chaos=(None, None), spec_stats=False, **kw):
    """Both schedulers over the same workload, submitted up front, a fake
    clock, ``chaos`` = (the JAX ChaosConfig, the port's); ``each(sched)``
    runs after every segment on both; ``spec_stats`` holds the speculative
    counters too.  Returns the port's (handles, scheduler)."""
    jeng, teng = sides(layout, quant, **(engine_kw or {}))
    out = []
    for cls, eng, ch in ((JaxScheduler, jeng, chaos[0]), (ContinuousScheduler, teng, chaos[1])):
        sched = cls(eng, clock=lambda: 0.0, chaos=ch, **kw)
        handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
        drain(sched, check, each)
        out.append((handles, sched))
    check_parity(*out, spec_stats=spec_stats)
    return out[1]


def spec_parity(sides, spec, prompts, news, layout="dense", quant=False, engine_kw=None,
                **kw):
    """``parity`` with ``spec`` on both engines (and the speculative
    counters held, but for a self-drafter, whose port rounds its drafts
    differently), while segments of 4 over 3 slots and a pool of 24 blocks
    unless ``kw`` says otherwise.  Returns the port's (tokens, scheduler)."""
    kw = {"n_slots": 3, "segment_len": 4, "segment_mode": "while",
          **({"n_blocks": 24} if layout == "paged" else {}), **kw}
    handles, sched = parity(sides, prompts, news, layout, quant,
                            engine_kw={"spec": spec, **(engine_kw or {})},
                            spec_stats=spec.draft != "self", **kw)
    assert all(h.done for h in handles)
    return [h.tokens for h in handles], sched
