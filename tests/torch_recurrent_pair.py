"""The recurrent families (zamba2-7b's hybrid, rwkv6-3b) in the JAX package
and in the port side by side, for ``tests/test_torch_mamba2.py`` and
``tests/test_torch_rwkv.py`` (not collected: no ``test_`` prefix).

Reduced configs, params made by the reference and carried across with
``params_from_jax``, inputs drawn with numpy.  Each ``check_*`` function
holds one behaviour of an arch against the reference:

* the forward: logits without a cache, a prefill into a cache and two
  decode steps, each within ``LOGIT_TOL`` (fp32 compute: only the order of
  fp32 reductions differs), the cache's leaves too;
* decode continuity as ``tests/test_models.py`` holds it;
* greedy tokens through the engine, equal to the JAX engine's (fp32
  compute), for each loop;
* the scheduler (per-request admission) against the JAX engine's
  ``generate`` per request in fp32 compute, and against the port's own
  ``generate`` at B = 1 in bf16.  The JAX scheduler serves these families
  in bf16 only: under fp32 compute its slot programs' scan carry refuses
  the fp32 conv / shift state its forward returns into the bf16 leaves of
  its ``init_cache`` (``check_jax_scheduler``), and in bf16 the two
  frameworks round at other places, so the reference's scheduler is held
  to the reference's engine and the port's to the reference's engine;
* the fallbacks (chunked admission, speculation, paged KV), the int8
  refusal beside the reference's ``KeyError``, int8 KV as a no-op;
* the cost models and ``lm_workload`` at the published config.
"""
from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.registry import get_arch as jax_get_arch
from repro.photonic import mapper as jmap
from repro.roofline import analytic as jax_analytic
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import SpecConfig as JaxSpecConfig
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.sharding.mesh import MeshPlan
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.models import registry as tR
from repro_torch.models.registry import get_arch
from repro_torch.photonic import mapper as tmap
from repro_torch.roofline import analytic
from repro_torch.serve.engine import ServeConfig, ServeEngine, SpecConfig
from repro_torch.serve.scheduler import ContinuousScheduler

LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4
B, S, NEW, MAX_LEN = 2, 21, 6, 48
LENS, NEWS = [3, 9, 5, 12, 7], [5, 8, 3, 6, 7]


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def leaf_specs(tree, prefix=()) -> dict:
    """{path: (shape, dtype name)} of a JAX (or abstract) or torch tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_specs(v, prefix + (k,)))
        else:
            dtype = v.dtype.name if hasattr(v.dtype, "name") else str(v.dtype).split(".")[-1]
            out[prefix + (k,)] = (tuple(v.shape), dtype)
    return out


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def archs(arch_id: str, compute: str = "float32"):
    """(JAX arch, port arch) of the reduced config at ``compute``."""
    ja, ta = jax_get_arch(arch_id, reduced=True), get_arch(arch_id, reduced=True)
    return (dataclasses.replace(ja, cfg=ja.cfg.replace(compute_dtype=compute)),
            dataclasses.replace(ta, cfg=ta.cfg.replace(compute_dtype=compute)))


class Pair:
    """One arch's reference params and their port copy, with engines made
    once per (side, compute, ServeConfig fields)."""

    def __init__(self, arch_id: str):
        self.arch_id = arch_id
        self.jparams = jax_get_arch(arch_id, reduced=True).init_params(jax.random.PRNGKey(0))
        self.tparams = params_from_jax(np_tree(self.jparams), "cpu")
        self._engines: dict = {}

    def jax_engine(self, compute="float32", plan=None, **kw):
        key = ("jax", compute, plan, tuple(sorted(kw.items())))
        if key not in self._engines:
            ja, _ = archs(self.arch_id, compute)
            self._engines[key] = JaxServeEngine(ja, self.jparams, plan or MeshPlan(),
                                                JaxServeConfig(max_len=MAX_LEN, **kw))
        return self._engines[key]

    def engine(self, compute="float32", cache_quant_int8=False, **kw):
        key = ("port", compute, cache_quant_int8, tuple(sorted(kw.items())))
        if key not in self._engines:
            _, ta = archs(self.arch_id, compute)
            self._engines[key] = ServeEngine(ta, self.tparams, ServeConfig(max_len=MAX_LEN, **kw),
                                             device="cpu", cache_quant_int8=cache_quant_int8)
        return self._engines[key]


def prompts_of(lens, seed=0) -> list[np.ndarray]:
    return [rng(seed + i).integers(0, 256, n).astype(np.int32) for i, n in enumerate(lens)]


def jax_generate(eng, prompt: np.ndarray, n: int) -> list[int]:
    return np.asarray(eng.generate(jnp.asarray(prompt)[None], n))[0].tolist()


def generate(eng: ServeEngine, prompt: np.ndarray, n: int) -> list[int]:
    return eng.generate(torch.from_numpy(prompt).long()[None], n)[0].tolist()


# ------------------------------------------------------------------ forward


def check_forward(arch_id: str) -> None:
    """Logits without a cache; then a prefill into a cache and two decode
    steps, logits and every cache leaf within ``LOGIT_TOL``."""
    ja, ta = archs(arch_id)
    jp = ja.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(np_tree(jp), "cpu")
    toks = rng(0).integers(0, 256, (B, S)).astype(np.int32)
    want, _ = ja.forward(jp, MeshPlan(), tokens=jnp.asarray(toks))
    got, _ = ta.forward(tp, tokens=torch.from_numpy(toks).long())
    assert got.shape == (B, S, ta.cfg.vocab_size)
    close(got, want, LOGIT_TOL)
    # fp32 caches on both sides (the attention leaves are bf16 by default,
    # where the two frameworks may round a k or v one ulp apart)
    jc = ja.module.init_cache(ja.cfg, B, S + 4, MeshPlan(), dtype=jnp.float32)
    tc = ta.module.init_cache(ta.cfg, B, S + 4, "cpu", dtype=torch.float32)
    want, jc = ja.forward(jp, MeshPlan(), tokens=jnp.asarray(toks), cache=jc)
    got, tc = ta.forward(tp, tokens=torch.from_numpy(toks).long(), cache=tc)
    close(got, want, LOGIT_TOL)
    for step in range(2):
        one = rng(10 + step).integers(0, 256, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + step, np.int32)
        want, jc = ja.forward(jp, MeshPlan(), tokens=jnp.asarray(one), cache=jc,
                              cache_pos=jnp.asarray(pos))
        got, tc = ta.forward(tp, tokens=torch.from_numpy(one).long(), cache=tc,
                             cache_pos=torch.from_numpy(pos).long())
        close(got, want, LOGIT_TOL)
    assert set(tc) == set(jc)
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        close(tc[name], jc[name], LOGIT_TOL)


def check_decode_continuity(arch_id: str) -> None:
    """prefill(S) + decode(1) logits ≈ forward(S + 1) last logits (the
    bound of ``tests/test_models.py``), bf16 compute as served."""
    _, ta = archs(arch_id, "bfloat16")
    tp = ta.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(rng(1).integers(0, 256, (B, S + 1))).long()
    full, _ = ta.forward(tp, tokens=toks)
    cache = ta.init_cache(B, S + 4, "cpu")
    _, cache = ta.forward(tp, tokens=toks[:, :S], cache=cache)
    last, _ = ta.forward(tp, tokens=toks[:, S:], cache=cache,
                         cache_pos=torch.full((B,), S, dtype=torch.long))
    err = (last[:, 0].float() - full[:, -1].float()).abs().max().item()
    assert err / (full[:, -1].float().abs().max().item() + 1e-6) < 0.05


# ------------------------------------------------------------------ serving


def check_generate(pair: Pair, loop: str) -> None:
    prompts = rng(1).integers(0, 256, (B, 8)).astype(np.int32)
    want = np.asarray(pair.jax_engine().generate(jnp.asarray(prompts), NEW))
    got = pair.engine(loop=loop).generate(torch.from_numpy(prompts).long(), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def check_jax_scheduler(pair: Pair) -> None:
    """The reference's scheduler on this family: per request equal to its
    own ``generate`` in bf16, and refused in fp32 compute (its scan carry;
    see the module docstring)."""
    prompts = prompts_of(LENS)
    eng = pair.jax_engine("bfloat16")
    sched = JaxScheduler(eng, n_slots=2, segment_len=4)
    handles = [sched.submit(p, n) for p, n in zip(prompts, NEWS)]
    sched.run()
    assert [h.tokens for h in handles] == [jax_generate(eng, p, n)
                                           for p, n in zip(prompts, NEWS)]
    sched = JaxScheduler(pair.jax_engine(), n_slots=2, segment_len=4)
    for p, n in zip(prompts, NEWS):
        sched.submit(p, n)
    with pytest.raises(TypeError, match="carry"):
        sched.run()


def check_scheduler(pair: Pair, mode: str, compute: str) -> None:
    """Per-request admission (chunked admission asked for falls back with
    the reference's reason): each request equals the JAX engine's
    ``generate`` (fp32) or the port's own at B = 1 (bf16)."""
    prompts = prompts_of(LENS)
    eng = pair.engine(compute)
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, segment_mode=mode,
                                prefill_chunk=8)
    handles = [sched.submit(p, n) for p, n in zip(prompts, NEWS)]
    sched.run()
    reason = jax_get_arch(pair.arch_id, reduced=True).chunked_prefill_skip_reason()
    assert not sched.chunked and sched.stats["chunked_skip_reason"] == reason
    assert eng.call_counts["prefill_slots"] == 0
    if compute == "float32":
        want = [jax_generate(pair.jax_engine(), p, n) for p, n in zip(prompts, NEWS)]
    else:
        want = [generate(eng, p, n) for p, n in zip(prompts, NEWS)]
    assert [h.tokens for h in handles] == want


def check_while_holds_the_state(pair: Pair) -> None:
    """A while segment that stops on a freed slot runs rounds past its stop
    (predicated on the device); for a recurrent family those rounds must
    leave the state as it was (``advance``).  With an eos token the host
    reads the stop flag from the first round, one round behind: each
    request still equals its own ``generate`` with the eos token."""
    prompts = prompts_of(LENS)
    free = pair.engine("bfloat16")
    eos = generate(free, prompts[1], NEWS[1])[3]  # a token request 1 emits mid-stream
    eng = pair.engine("bfloat16", eos_token=eos)
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, segment_mode="while")
    handles = [sched.submit(p, n) for p, n in zip(prompts, NEWS)]
    sched.run()
    assert sched.stats["steps_predicated"] > 0
    want = [generate(eng, p, n) for p, n in zip(prompts, NEWS)]
    assert [h.tokens for h in handles] == [w[:len(h.tokens)] for h, w in zip(handles, want)]
    for h, w in zip(handles, want):  # a request ends at its eos, or its budget
        assert len(h.tokens) == (w.index(eos) + 1 if eos in w else len(w))


def check_fallbacks(pair: Pair) -> None:
    """Speculation falls back with the reference's reason, paged KV and the
    chunk-resume contract raise with it; the reasons are the reference's
    strings, at the reduced and the full config, and the decode-carry and
    slot contracts hold on the meta device."""
    for reduced in (True, False):
        arch, jarch = get_arch(pair.arch_id, reduced), jax_get_arch(pair.arch_id, reduced)
        for rule in ("chunked_prefill_skip_reason", "spec_decode_skip_reason",
                     "paged_skip_reason"):
            assert getattr(arch, rule)() == getattr(jarch, rule)() != "", rule
        assert arch.input_kind == jarch.input_kind == "tokens"
        for name, shape in tbase.SHAPES.items():
            assert arch.supports(shape) == jarch.supports(jbase.SHAPES[name]), name
        tR.check_decode_cache_carry(arch)
        tR.check_slot_cache_contract(arch)
        chunked = re.escape(arch.chunked_prefill_skip_reason())
        with pytest.raises(NotImplementedError, match=chunked):
            tR.check_slots_cache_contract(arch)
        with pytest.raises(NotImplementedError, match=re.escape(arch.paged_skip_reason())):
            tR.check_paged_cache_contract(arch)
    arch = get_arch(pair.arch_id, reduced=True)
    spec = ServeEngine(arch, pair.tparams, ServeConfig(
        max_len=MAX_LEN, spec=SpecConfig(k=2, draft="truncate:1")), device="cpu")
    jspec = JaxServeEngine(jax_get_arch(pair.arch_id, reduced=True), pair.jparams, MeshPlan(),
                           JaxServeConfig(max_len=MAX_LEN,
                                          spec=JaxSpecConfig(k=2, draft="truncate:1")))
    assert spec.spec is None and spec.spec_skip_reason == jspec.spec_skip_reason != ""
    sched = ContinuousScheduler(spec, n_slots=2)
    h = sched.submit(prompts_of([6])[0], 4)
    sched.run()
    assert sched.spec is None and sched.stats["spec_skip_reason"] == spec.spec_skip_reason
    assert h.tokens == generate(spec, prompts_of([6])[0], 4)
    with pytest.raises(NotImplementedError, match=re.escape(arch.paged_skip_reason())):
        pair.engine("bfloat16").init_paged_cache(4, 2)
    with pytest.raises(NotImplementedError):
        arch.init_paged_cache(4, 4, "cpu")


def check_int8_refused(pair: Pair, leaf: str) -> None:
    """The reference's int8 rewrite breaks these blocks (``KeyError:
    'kernel'`` on the first forward); the port refuses the tree up front,
    naming the first leaf the block reads so."""
    jeng = pair.jax_engine("bfloat16", weight_quant="int8")
    with pytest.raises(KeyError, match="kernel"):
        jeng.generate(jnp.asarray(prompts_of([6])[0])[None], 3)
    with pytest.raises(ValueError, match=leaf):
        ServeEngine(get_arch(pair.arch_id, reduced=True), pair.tparams,
                    ServeConfig(max_len=MAX_LEN, weight_quant="int8"), device="cpu")


def check_int8_kv_is_a_no_op(pair: Pair) -> None:
    """``cache_quant_int8`` makes no scale leaves and changes no token, in
    both packages."""
    prompts = rng(1).integers(0, 256, (B, 8)).astype(np.int32)
    jplain = np.asarray(pair.jax_engine("bfloat16").generate(jnp.asarray(prompts), NEW))
    jquant = np.asarray(pair.jax_engine("bfloat16", plan=MeshPlan(cache_quant_int8=True))
                        .generate(jnp.asarray(prompts), NEW))
    np.testing.assert_array_equal(jquant, jplain)
    plain = pair.engine("bfloat16").generate(torch.from_numpy(prompts).long(), NEW)
    quant = pair.engine("bfloat16", cache_quant_int8=True).generate(
        torch.from_numpy(prompts).long(), NEW)
    assert torch.equal(quant, plain)
    arch = get_arch(pair.arch_id, reduced=True)
    leaves = arch.init_cache(2, 8, "cpu", cache_quant_int8=True)
    assert {n: t.dtype for n, t in leaves.items()} == {
        n: t.dtype for n, t in arch.init_cache(2, 8, "cpu").items()}
    assert not any(n.endswith("_scale") for n in leaves)


# ------------------------------------------------------------------- costs


def check_costs(arch_id: str) -> None:
    """decode / prefill / spec-verify costs and ``lm_workload`` at the
    published config: equal floats (``lm_workload`` prices these families
    with the transformer's layout, as the reference does)."""
    cfg, jcfg = tbase.get_config(arch_id), jbase.get_config(arch_id)
    assert analytic._param_counts(cfg) == jax_analytic._param_counts(jcfg)
    for cb, wb in ((2.0, 2.0), (1.03, 1.01 * 0.5)):
        pairs = [(analytic.decode_step_cost(cfg, 4, 128, cb, wb),
                  jax_analytic.decode_step_cost(jcfg, 4, 128, cb, wb)),
                 (analytic.prefill_chunk_cost(cfg, 4, 16, start=32, cache_bytes_per_elem=cb,
                                              weight_bytes_per_elem=wb),
                  jax_analytic.prefill_chunk_cost(jcfg, 4, 16, start=32,
                                                  cache_bytes_per_elem=cb,
                                                  weight_bytes_per_elem=wb)),
                 (analytic.spec_verify_cost(cfg, 4, 4, 64, 2, cb, wb),
                  jax_analytic.spec_verify_cost(jcfg, 4, 4, 64, 2, cb, wb))]
        for got, want in pairs:
            assert (got.flops, got.hbm_bytes, got.breakdown) == (
                want.flops, want.hbm_bytes, want.breakdown)
    for args in ((), (0.5, 0.25, 3)):
        got, want = tmap.lm_workload(cfg, *args), jmap.lm_workload(jcfg, *args)
        assert [dataclasses.asdict(w) for w in got] == [dataclasses.asdict(w) for w in want]
