"""The port's ``ServeEngine(plan=...)`` on 8 CPU ranks (``gloo``) against the
plan-less port engine and the JAX engine under the same mesh.

Each case runs greedy ``generate`` on 4 prompts of 8 tokens for 8 new
tokens, and a ``ContinuousScheduler(n_slots=2, segment_len=4)`` run of 4
requests (prompts of 5, 9, 3 and 7 tokens), on the debug mesh:

  (a) reduced internlm2-1.8b on (2, 4), heads mode, fp32 compute, and a
      ``SpecConfig(k=2, draft="truncate:1")`` scheduler run;
  (b) reduced qwen2-vl-2b on (1, 8), seq mode (12 heads over 8), fp32;
  (c) reduced tinyllama-1.1b, ``weight_quant="int8"`` at 0.5 in (16, 16)
      blocks, ``serve_stationary``, on (2, 4), fp32 compute: the hand
      kernels' plain versions on each rank's column blocks;
  (d) reduced moonshot-v1-16b-a3b (MoE) on (2, 4), fp32;
  (e) reduced rwkv6-3b on (2, 4), fp32.

Exact: the meshed engine's tokens equal the plan-less engine's, on every
rank; (a), (c) and (d) also equal the JAX engine's under the same plan on
8 forced host devices (its params carried across with
``convert.params_from_jax``).  The ranks run in
``tests/torch_mesh_workers.py`` (all cases in one group); the JAX side in
a subprocess beside them.  Refusals: the paged layout under a mesh, and a
plan whose ``cache_quant_int8`` disagrees with the engine's; a plan
without a mesh is the plan-less engine, bit for bit.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_arch as jax_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.sharding.mesh import AbstractMesh, MeshPlan
from torch_mesh_workers import run_ranks

QUANT = {"weight_quant": "int8", "weight_quant_sparsity": 0.5, "weight_quant_block": (16, 16)}
# name: (arch, debug mesh, ServeEngine config fields, make_plan overrides, spec, attn mode)
CASES = {
    "a": ("internlm2-1.8b", (2, 4), {}, None, {"k": 2, "draft": "truncate:1"}, "heads"),
    "b": ("qwen2-vl-2b", (1, 8), {}, None, None, "seq"),
    "c": ("tinyllama-1.1b", (2, 4), QUANT, {"serve_stationary": True}, None, "heads"),
    "d": ("moonshot-v1-16b-a3b", (2, 4), {}, None, None, "heads"),
    "e": ("rwkv6-3b", (2, 4), {}, None, None, "heads"),
}
AGAINST_JAX = ("a", "c", "d")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SIDE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false")
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_debug_mesh
    from repro.models.registry import get_arch
    from repro.serve import ContinuousScheduler, ServeConfig, ServeEngine
    from repro.sharding.mesh import make_plan
    from repro.sharding.partition import param_shardings

    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    out = {}
    for name, (arch_id, dims, sc, plan_kw) in job["cases"].items():
        arch = get_arch(arch_id, reduced=True)
        arch = dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="float32"))
        params = arch.init_params(jax.random.PRNGKey(0))
        mesh = make_debug_mesh(*dims)
        plan = make_plan(arch.cfg, mesh, 4, **(plan_kw or {}))
        lay = param_shardings(arch.abstract_params(), plan, serve=plan.serve_stationary)
        with mesh:
            eng = ServeEngine(arch, jax.tree_util.tree_map(jax.device_put, params, lay), plan,
                              ServeConfig(max_len=32, **sc))
            gen = np.asarray(eng.generate(jnp.asarray(job["prompts"]), 8))
            sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, clock=lambda: 0.0)
            handles = [sched.submit(p, n) for p, n in job["requests"]]
            while sched.has_work():
                sched.run_segment()
        out[name] = {"generate": gen, "continuous": [list(h.tokens) for h in handles]}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _workload():
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (4, 8)).astype(np.int32)
    requests = [(rng.integers(0, 256, n).astype(np.int32), m)
                for n, m in ((5, 6), (9, 4), (3, 7), (7, 5))]
    return prompts, requests


def _params_np(arch_id: str) -> dict:
    params = jax_get_arch(arch_id, reduced=True).init_params(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.array, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": rank 0's results by case, "jax": the JAX engine's by case}:
    the 8 ranks and the JAX subprocess run side by side."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    prompts, requests = _workload()
    job = {"prompts": prompts, "requests": requests,
           "cases": {n: (CASES[n][0], CASES[n][1], CASES[n][2], CASES[n][3])
                     for n in AGAINST_JAX}}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    jax_side = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(tmp / "job.pkl"), str(tmp / "jax.pkl")],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
                 OMP_NUM_THREADS="1"))
    try:
        checks = {n: ("check_serve", {
            "arch_id": arch_id, "mesh_dims": dims, "compute": "float32",
            "params_np": _params_np(arch_id), "prompts": prompts, "requests": requests,
            "sc": sc, "plan_kw": plan_kw, "spec": spec})
            for n, (arch_id, dims, sc, plan_kw, spec, _) in CASES.items()}
        rng = np.random.default_rng(1)
        checks["dense_rows"] = ("check_dense_rows", {
            "x_np": rng.standard_normal((8, 1, 64), np.float32),
            "w_np": (rng.standard_normal((64, 96)) / 8).astype(np.float32)})
        port = run_ranks("check_all", 8, tmp / "ranks", checks=checks)
        _, err = jax_side.communicate(timeout=600)
    finally:
        jax_side.kill()
    assert jax_side.returncode == 0, err[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        return {"port": port, "jax": pickle.load(f)}


@pytest.mark.parametrize("case", list(CASES))
def test_meshed_engine_equals_plain(runs, case):
    got = runs["port"][case]
    assert got["attn_shard"] == CASES[case][5]
    assert got["ranks_agree"]
    plain, meshed = got["plain"], got["meshed"]
    np.testing.assert_array_equal(meshed["generate"], plain["generate"])
    assert meshed["continuous"] == plain["continuous"]
    assert all(len(t) == n for t, (_, n) in zip(meshed["continuous"], _workload()[1]))
    if CASES[case][4] is not None:
        assert meshed["spec"] == plain["spec"] == plain["continuous"]


@pytest.mark.parametrize("case", AGAINST_JAX)
def test_meshed_engine_equals_jax_under_the_same_mesh(runs, case):
    want, got = runs["jax"][case], runs["port"][case]["meshed"]
    np.testing.assert_array_equal(got["generate"], want["generate"])
    assert got["continuous"] == want["continuous"]


def test_meshed_projection_rows_do_not_depend_on_m(runs):
    assert runs["port"]["dense_rows"] == {"column": 0, "row": 0, "fsdp": 0}


def _tiny():
    arch = get_arch("tinyllama-1.1b", reduced=True)
    params = params_from_jax(_params_np("tinyllama-1.1b"), "cpu")
    return arch, params


def test_paged_under_a_mesh_is_refused_at_construction():
    arch, params = _tiny()
    plan = MeshPlan(mesh=AbstractMesh((2, 4), ("data", "model")))
    with pytest.raises(ValueError, match="kv_layout='paged' is not wired for meshed serving"):
        ServeEngine(arch, params, ServeConfig(max_len=32, kv_layout="paged", block_len=8),
                    "cpu", plan=plan)


def test_plan_cache_quant_must_agree_and_a_meshless_plan_is_plain():
    arch, params = _tiny()
    with pytest.raises(ValueError, match="cache_quant_int8"):
        ServeEngine(arch, params, ServeConfig(max_len=32), "cpu",
                    plan=MeshPlan(cache_quant_int8=True))
    toks = torch.from_numpy(_workload()[0]).long()
    want = ServeEngine(arch, params, ServeConfig(max_len=32, **QUANT), "cpu",
                       cache_quant_int8=True)
    got = ServeEngine(arch, params, ServeConfig(max_len=32, **QUANT), "cpu",
                      cache_quant_int8=True, plan=MeshPlan(cache_quant_int8=True))
    assert got.plan is None
    assert torch.equal(got.generate(toks, 8), want.generate(toks, 8))
    assert torch.equal(got.last_logits[4], want.last_logits[4])
