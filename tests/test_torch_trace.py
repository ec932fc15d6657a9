"""The port's serving trace, its pricing and the analytic autotuner held
against the JAX package's (``tests/test_serve_trace.py`` and the serving
cost functions of ``tests/test_roofline.py`` are the checklist).

Setup as ``tests/torch_scheduler_pair.py`` says (reduced tinyllama, fp32
compute, int8 weights at (16, 16), the port on its plain versions), with
``ServeConfig(trace=True)`` on both sides: for the same workload the two
``TraceRecorder``s record equal events, event by event (phase, segment,
batch, steps, tokens, FLOPs, bytes), equal totals and per-tenant tokens —
per request, chunked, speculative, preempted by recompute and by swap.
Tracing never changes the tokens.  ``trace_energy`` and ``tenant_report``
agree within 1e-12 relative; ``autotune``'s ranking is equal
on the same target (``TPU_V5E``; the port's default is the H100).  The
cost functions are pure arithmetic, so they are also held equal at
tinyllama-1.1b's full width.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.roofline import analytic as jax_analytic
from repro.roofline.hw import TPU_V5E as JAX_TPU_V5E
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import tenant_report as jax_tenant_report
from repro.serve import trace_energy as jax_trace_energy
from repro_torch.configs.base import get_config
from repro_torch.roofline import analytic
from repro_torch.roofline.hw import H100, TPU_V5E
from repro_torch.serve.engine import ServeConfig, SpecConfig
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.trace import PHASES, tenant_report, trace_energy
from torch_scheduler_pair import drain, prompts_of, sides_fixture

jax_autotune = importlib.import_module("repro.roofline.autotune")
port_autotune = importlib.import_module("repro_torch.roofline.autotune")

LENS = [4, 9, 6, 12]
NEWS = [20, 8, 16, 4]
TENANTS = ["acme", "hobby", "acme", "bulk"]


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


def _events(trace):
    return [dataclasses.astuple(e) for e in trace.events]


def _traced(sides, layout="dense", engine_kw=None, **kw):
    """Both schedulers over LENS / NEWS with tracing on; returns the
    (handles, scheduler) of JAX and of the port, events held equal."""
    jeng, teng = sides(layout, trace=True, **(engine_kw or {}))
    out = []
    for cls, eng in ((JaxScheduler, jeng), (ContinuousScheduler, teng)):
        sched = cls(eng, clock=lambda: 0.0, **{"n_slots": 2, "segment_len": 4,
                                               "segment_mode": "while", **kw})
        handles = [sched.submit(p, n, tenant=t)
                   for p, n, t in zip(prompts_of(LENS), NEWS, TENANTS)]
        drain(sched)
        out.append((handles, sched))
    (jh, js), (th, ts) = out
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert _events(ts.trace) == _events(js.trace)
    assert ts.trace.totals == js.trace.totals
    assert ts.trace.summary() == js.trace.summary()
    assert ts.trace.tenant_tokens == js.trace.tenant_tokens == ts.stats["tenant_tokens"]
    assert {e.phase for e in ts.trace.events} <= set(PHASES)
    return out


def test_trace_per_request_matches_jax_and_stats(sides):
    _, (_, sched) = _traced(sides)
    tr, st = sched.trace.totals, sched.stats
    assert tr["prefill_tokens"] == sum(LENS)
    assert tr["prefill_launches"] == st["admitted"]
    assert tr["decode_tokens"] == st["slot_steps_live"]
    assert tr["decode_segments"] == st["segments"]
    assert tr["decode_steps"] == st["steps_total"]
    assert sched.trace.tokens_total == sum(LENS) + sum(NEWS) - len(NEWS)
    assert tr["flops"] > 0 and tr["hbm_bytes"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_trace_chunked_matches_jax(sides, layout):
    kw = dict(n_blocks=24) if layout == "paged" else {}
    _, (_, sched) = _traced(sides, layout, prefill_chunk=8, prefill_buckets=2, **kw)
    tr, st = sched.trace.totals, sched.stats
    assert tr["prefill_tokens"] == sum(LENS)
    assert tr["prefill_launches"] == st["prefill_launches"]
    assert tr["decode_tokens"] == st["slot_steps_live"]
    prefills = [e for e in sched.trace.events if e.phase == "prefill"]
    assert len(prefills) == st["prefill_launches"] and all(e.steps <= 8 for e in prefills)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_trace_spec_matches_jax(sides, layout):
    kw = dict(n_blocks=24) if layout == "paged" else {}
    _, (_, sched) = _traced(sides, layout, {"spec": SpecConfig(k=2, draft="truncate:1")},
                            **kw)
    tr, st = sched.trace.totals, sched.stats
    assert st["spec_emitted"] > 0
    assert tr["spec_tokens"] == st["spec_emitted"]
    assert tr["spec_live_steps"] == st["spec_steps"]
    assert tr["decode_tokens"] == 0 and tr["decode_segments"] == 0
    assert sched.trace.spec_accept_len() == st["spec_emitted"] / st["spec_steps"]


@pytest.mark.parametrize("preempt_mode", ["recompute", "swap"])
def test_trace_preempt_matches_jax(sides, preempt_mode):
    """A small pool under overcommit forces preemptions: the preempt (and,
    swapping, swap-in) events carry the same payload bytes in both."""
    _, (_, sched) = _traced(sides, "paged", n_blocks=5, overcommit=2.0,
                            preempt_mode=preempt_mode)
    st, tr = sched.stats, sched.trace.totals
    assert st["preemptions"] >= 1 and tr["preemptions"] == st["preemptions"]
    if preempt_mode == "swap":
        assert st["swap_ins"] >= 1 and tr["swap_bytes"] > 0


def test_trace_off_keeps_tokens_and_no_recorder(sides):
    assert ServeConfig().trace is False
    runs = []
    for trace in (False, True):
        eng = sides("dense", trace=trace)[1]
        sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, segment_mode="while")
        handles = [sched.submit(p, n) for p, n in zip(prompts_of(LENS), NEWS)]
        drain(sched)
        runs.append((sched, [h.tokens for h in handles]))
    (off, toks_off), (on, toks_on) = runs
    assert off.trace is None and on.trace is not None
    assert toks_off == toks_on
    assert off.stats["slot_steps_live"] == on.stats["slot_steps_live"]


def test_trace_energy_and_tenant_report_match_jax(sides):
    (_, js), (_, ts) = _traced(sides)
    platforms = ("SONIC", "NullHop", "NP100")
    want = jax_trace_energy(js.trace, js.engine.cfg, weight_sparsity=0.75,
                            act_sparsity=0.5, platforms=platforms)
    got = trace_energy(ts.trace, ts.engine.cfg, weight_sparsity=0.75,
                       act_sparsity=0.5, platforms=platforms)
    assert got["tokens"] == want["tokens"] == ts.trace.tokens_total
    for name in platforms:
        for key, value in want["platforms"][name].items():
            np.testing.assert_allclose(got["platforms"][name][key], value, rtol=1e-12)
    sonic, nullhop = got["platforms"]["SONIC"], got["platforms"]["NullHop"]
    assert 0 < sonic["j_per_token"] < nullhop["j_per_token"]
    assert sonic["tok_per_s_per_w"] > nullhop["tok_per_s_per_w"]
    rep, jrep = (tenant_report(ts.trace, got, wall_s=2.0),
                 jax_tenant_report(js.trace, want, wall_s=2.0))
    assert set(rep) == set(jrep) == {"acme", "hobby", "bulk"}
    for tenant, row in jrep.items():
        for key, value in row.items():
            np.testing.assert_allclose(rep[tenant][key], value, rtol=1e-12)
    assert sum(r["share"] for r in rep.values()) == pytest.approx(1.0)


# --------------------------------------------------- cost functions, full


SHAPES = [(1, 64), (3, 40), (4, 128), (8, 2048)]


@pytest.mark.parametrize("batch,s_ctx", SHAPES)
def test_cost_functions_match_jax_at_full_width(batch, s_ctx):
    """decode / prefill / spec-verify costs and roofline times at
    tinyllama-1.1b's published widths, bf16 and int8 (cache and weights)
    bytes: equal floats."""
    cfg, jcfg = get_config("tinyllama-1.1b"), jax_get_config("tinyllama-1.1b")
    for cb, wb in ((2.0, 2.0), (1.03, 1.01 * 0.5)):
        pairs = [
            (analytic.decode_step_cost(cfg, batch, s_ctx, cb, wb),
             jax_analytic.decode_step_cost(jcfg, batch, s_ctx, cb, wb)),
            (analytic.prefill_chunk_cost(cfg, batch, 16, start=s_ctx,
                                         cache_bytes_per_elem=cb, weight_bytes_per_elem=wb),
             jax_analytic.prefill_chunk_cost(jcfg, batch, 16, start=s_ctx,
                                             cache_bytes_per_elem=cb,
                                             weight_bytes_per_elem=wb)),
            (analytic.prefill_chunk_cost(cfg, batch, 8, ctx_sum=1234.5,
                                         cache_bytes_per_elem=cb, weight_bytes_per_elem=wb),
             jax_analytic.prefill_chunk_cost(jcfg, batch, 8, ctx_sum=1234.5,
                                             cache_bytes_per_elem=cb,
                                             weight_bytes_per_elem=wb)),
        ]
        for k, layers in ((4, 2), (16, None)):
            pairs.append((analytic.spec_verify_cost(cfg, k, batch, s_ctx, layers, cb, wb),
                          jax_analytic.spec_verify_cost(jcfg, k, batch, s_ctx, layers, cb,
                                                        wb)))
        for got, want in pairs:
            assert (got.flops, got.hbm_bytes, got.breakdown) == (
                want.flops, want.hbm_bytes, want.breakdown)
            assert analytic.step_time(got, TPU_V5E) == jax_analytic.step_time(
                want, JAX_TPU_V5E)


def test_decode_and_prefill_costs_match_closed_form():
    cfg = get_config("tinyllama-1.1b")
    n_active, n_total = analytic._param_counts(cfg)
    # tinyllama-1.1b's published 1,100,048,384 parameters, less the
    # 2L + 1 norm scales (the cost models count matmul weights only)
    assert n_total + (2 * cfg.n_layers + 1) * cfg.d_model == 1_100_048_384
    h, kh, dh, d, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.n_layers
    b, s = 3, 40
    c = analytic.decode_step_cost(cfg, b, s)
    np.testing.assert_allclose(c.flops, 2.0 * n_active * b + 4.0 * h * dh * s * b * L,
                               rtol=1e-12)
    np.testing.assert_allclose(c.hbm_bytes, n_active * 2.0 + 2.0 * b * s * kh * dh * 2.0 * L
                               + 4.0 * b * d * 2.0 * L, rtol=1e-12)
    batch, chunk, start = 2, 16, 32
    c = analytic.prefill_chunk_cost(cfg, batch, chunk, start=start)
    tokens = batch * chunk
    ctx_sum = batch * (chunk * start + chunk * (chunk + 1) / 2.0)
    np.testing.assert_allclose(c.flops, 2.0 * n_active * tokens + 4.0 * h * dh * ctx_sum * L,
                               rtol=1e-12)
    np.testing.assert_allclose(c.hbm_bytes, 2.0 * n_total + 8.0 * tokens * d * 2.0 * L
                               + 2.0 * ctx_sum * kh * dh * 2.0 * L, rtol=1e-12)
    assert analytic.step_time(analytic.StepCost(1e15, 1.0, {}), H100) == 1e15 / 989e12
    assert analytic.step_time(analytic.StepCost(1.0, 1e12, {}), H100) == 1e12 / 3.35e12
    # once refused, now priced as the reference prices them: the recurrent
    # families' decode step (state traffic in place of the KV cache's)
    for arch_id in ("zamba2-7b", "rwkv6-3b"):
        got = analytic.decode_step_cost(get_config(arch_id), b, s)
        want = jax_analytic.decode_step_cost(jax_get_config(arch_id), b, s)
        assert (got.flops, got.hbm_bytes, got.breakdown) == (
            want.flops, want.hbm_bytes, want.breakdown)


# -------------------------------------------------------------- autotune


def _workload(m, paged=False):
    return m.WorkloadSpec(tuple(LENS * 3), tuple(NEWS * 3), n_slots=2, max_len=64)


@pytest.mark.parametrize("paged,spec_ks,accept", [(False, (0,), None), (True, (0,), None),
                                                  (False, (0, 4), None), (True, (0, 4), 2.7)])
def test_autotune_ranking_matches_jax(paged, spec_ks, accept):
    """The default grid ranked on the same target: the same order and the
    same predicted numbers (the reduced config and the full one)."""
    for reduced in (True, False):
        cfg = get_config("tinyllama-1.1b")
        jcfg = jax_get_config("tinyllama-1.1b")
        if reduced:
            cfg, jcfg = (cfg.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                     head_dim=16, d_ff=128, vocab_size=256),
                         jcfg.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                      head_dim=16, d_ff=128, vocab_size=256))
        got = port_autotune.autotune(cfg, _workload(port_autotune), hw=TPU_V5E, paged=paged,
                                     spec_ks=spec_ks, spec_accept_len=accept)
        want = jax_autotune.autotune(jcfg, _workload(jax_autotune), hw=JAX_TPU_V5E,
                                     paged=paged, spec_ks=spec_ks, spec_accept_len=accept)
        assert [(p.knobs.label(), p.time_s, p.tok_s, p.n_segments, p.n_prefill_launches)
                for p in got.ranked] == [
            (p.knobs.label(), p.time_s, p.tok_s, p.n_segments, p.n_prefill_launches)
            for p in want.ranked]
        assert got.report() == want.report()


def test_autotune_on_the_card_target():
    """Priced on the H100 (the port's default): per-token round trips still
    rank last, and speculation at the assumed acceptance of 1 never wins."""
    cfg = get_config("tinyllama-1.1b")
    w = port_autotune.WorkloadSpec(tuple(LENS), tuple(NEWS), n_slots=2, max_len=64)
    cands = [port_autotune.KnobConfig(segment_len=1), port_autotune.KnobConfig(segment_len=8),
             port_autotune.KnobConfig(segment_len=16, prefill_chunk=32)]
    res = port_autotune.autotune(cfg, w, candidates=cands)
    assert res.best.segment_len > 1 and res.ranked[-1].knobs.segment_len == 1
    assert "seg1_chunk0" in res.report()
    a = port_autotune.predict(port_autotune.KnobConfig(segment_len=8, prefill_chunk=16), w, cfg)
    assert a == port_autotune.predict(port_autotune.KnobConfig(segment_len=8,
                                                               prefill_chunk=16), w, cfg)
    plain = port_autotune.predict(port_autotune.KnobConfig(segment_len=8), w, cfg)
    spec = port_autotune.predict(port_autotune.KnobConfig(segment_len=8, spec_k=4), w, cfg)
    assert spec.tok_s < plain.tok_s
    slower = port_autotune.predict(port_autotune.KnobConfig(segment_len=8), w, cfg,
                                   hw=TPU_V5E)
    assert slower.time_s > plain.time_s  # the TPU's peak rates are the lower


def test_launch_serve_trace_and_autotune_cpu():
    """``launch/serve.py --trace --autotune`` on the poisson workload: the
    autotuner picks the knobs (keeping speculation on under ``--trace`` to
    measure it), the run retires every request and reports the trace, and
    the re-rank takes the measured acceptance."""
    from repro_torch.launch import serve

    args = serve.parse_args(["--reduced", "--device", "cpu", "--workload", "poisson",
                             "--n-requests", "6", "--rate", "500", "--new-tokens", "12",
                             "--kv-layout", "paged", "--spec-k", "2",
                             "--spec-draft", "truncate:1", "--trace", "--autotune"])
    draws = serve._poisson_draws(args, 256)
    assert serve.autotune_args(args, draws) > 0 and args.spec_k == 2
    eng = serve.build_engine(args)
    assert eng.sc.trace
    useful, total, sched, handles = serve.run_poisson(eng, args, draws, verbose=False)
    out = serve.report_poisson(eng, useful, total, sched, handles)
    assert sched.stats["retired"] == 6 and useful == sum(len(h.tokens) for h in handles)
    assert out["trace"]["tokens_total"] == sched.trace.tokens_total > 0
    res = serve.rerank_with_acceptance(eng, args, draws, sched)
    assert res is not None and res.ranked[0].tok_s > 0
    serve.main(["--reduced", "--device", "cpu", "--workload", "poisson", "--n-requests", "3",
                "--rate", "500", "--new-tokens", "6", "--trace", "--autotune"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--reduced", "--device", "cpu", "--trace"])  # poisson only
