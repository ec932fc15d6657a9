"""The sharding slice's pure parts against the JAX package, on the CPU with
no process group: plans, partition specs, the per-device slice of a spec,
the MoE expert split, the analytic cell cost, the ring costs of
collectives and the roofline terms.

Tolerance: exact everywhere (specs and plans equal, costs equal as floats,
the virtual expert split equal to the reference's leaf for leaf), but the
split's reconstruction of the expert FFN, held within the reference's own
rtol 1e-4 / atol 1e-5 (``tests/test_moe.py::test_virtual_split_is_exact``).
The reference runs on ``jax.sharding.AbstractMesh`` (no devices); the slice
test asks JAX's ``devices_indices_map`` in a subprocess with 8 forced host
devices, as the reference's distributed tests do.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.base import ALL_ARCH_IDS, SHAPES, ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.layers import kv_repeat_factor as jax_kv_repeat_factor
from repro.roofline.analysis import parse_collectives
from repro.roofline.analysis import roofline_terms as jax_roofline_terms
from repro.roofline.analytic import analytic_cost as jax_analytic_cost
from repro.roofline.hw import TPU_V5E as JAX_TPU_V5E
from repro.sharding.mesh import make_plan as jax_make_plan
from repro.sharding.partition import spec_for_leaf as jax_spec_for_leaf
from repro.sharding.partition import _drop_fsdp as jax_drop_fsdp
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import kv_repeat_factor
from repro_torch.models.registry import get_arch
from repro_torch.roofline.analysis import ring_wire_bytes, roofline_terms
from repro_torch.roofline.analytic import analytic_cost
from repro_torch.roofline.hw import TPU_V5E
from repro_torch.sharding.mesh import AbstractMesh, make_plan, shard_slice
from repro_torch.sharding.partition import param_specs
from repro_torch.utils.tree import named_leaves

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}
BATCHES = (None, 256, 128, 32, 1)


def _meshes(name):
    sizes, names = MESHES[name]
    return JaxAbstractMesh(sizes, names), AbstractMesh(sizes, names)


def _plan_fields(plan) -> tuple:
    return (plan.dp_axes, plan.tp_axis, plan.attn_shard, plan.kv_repeat, plan.shard_batch,
            plan.dp, plan.tp, plan.dp_size, plan.tp_size, tuple(plan.cache_spec()))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_make_plan_equals_the_reference(arch_id, mesh):
    jm, tm = _meshes(mesh)
    for batch in BATCHES:
        for over in ({}, {"seq_shard_cache": True}):
            want = jax_make_plan(jax_get_config(arch_id), jm, batch, **over)
            got = make_plan(get_config(arch_id), tm, batch, **over)
            assert _plan_fields(got) == _plan_fields(want), (batch, over)
    assert _plan_fields(make_plan(get_config(arch_id), None)) == (
        ("data",), "model", "heads", 1, True, None, None, 1, 1, (None, None, None, None))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_param_specs_equal_the_reference(arch_id, mesh):
    """Every leaf of the full-size tree, training and serving (no FSDP)."""
    jm, tm = _meshes(mesh)
    jplan = jax_make_plan(jax_get_config(arch_id), jm)
    tplan = make_plan(get_config(arch_id), tm)
    abstract = get_arch(arch_id).abstract_params()
    for serve in (False, True):
        specs = param_specs(abstract, tplan, serve=serve)
        for name, leaf in named_leaves(abstract):
            got = functools.reduce(lambda t, k: t[k], name.split("/"), specs)
            want = jax_spec_for_leaf(name, tuple(leaf.shape), jplan)
            if serve:
                want = jax_drop_fsdp(want)
            assert got == tuple(want), (name, serve, got, want)


@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_kv_repeat_and_expert_split_equal_the_reference(arch_id):
    for tp in (1, 2, 4, 8, 16, 32):
        assert kv_repeat_factor(get_config(arch_id), tp) == jax_kv_repeat_factor(
            jax_get_config(arch_id), tp)
        if get_config(arch_id).n_experts:
            assert tmoe.expert_split_factor(get_config(arch_id), tp) == \
                jmoe.expert_split_factor(jax_get_config(arch_id), tp)


MOE_CFG = dict(arch_id="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
               head_dim=8, d_ff=64, vocab_size=128, n_experts=8, experts_per_token=2,
               param_dtype="float32")


def test_virtual_split_equals_the_reference():
    """``tests/test_moe.py::test_virtual_split_is_exact``'s inputs."""
    jcfg = JaxModelConfig(**MOE_CFG)
    p = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.array, p), "cpu")
    want = jmoe._split_weights(p, 2)
    got = tmoe._split_weights(tp, 2)
    for name in ("wi", "wg", "wo"):
        assert torch.equal(got[name], torch.from_numpy(np.array(want[name]))), name
    h = jax.random.normal(jax.random.PRNGKey(3), (8, 5, 32))
    th = torch.from_numpy(np.array(h))
    full = tmoe._expert_ffn(tp, None, th)
    recon = tmoe._expert_ffn(got, None, th.repeat_interleave(2, 0)).reshape(8, 2, 5, 32).sum(1)
    np.testing.assert_allclose(recon.numpy(), full.numpy(), rtol=1e-4, atol=1e-5)
    gates, experts = jnp.ones((2, 3, 2)), jnp.array([[[0, 3]] * 3] * 2)
    jg, je = jmoe._virtualize(gates, experts, 2)
    tg, te = tmoe._virtualize(torch.ones(2, 3, 2), torch.tensor([[[0, 3]] * 3] * 2), 2)
    assert torch.equal(te.long(), torch.from_numpy(np.array(je)).long())
    assert torch.equal(tg, torch.from_numpy(np.array(jg)))
    assert tmoe._virtualize(tg, te, 1)[1] is te


# ------------------------------------------------- per-device slices of a spec

SLICE_CASES = {
    "data_model": ((2, 4), ("data", "model"), [
        ((8, 16), ("data", "model")), ((8, 16), ("model", None)),
        ((4, 8, 12), (None, "data", "model")), ((16, 8), (("data", "model"), None)),
        ((6, 4), (None, None)), ((8,), ("data",))]),
    "pod_data_model": ((2, 2, 2), ("pod", "data", "model"), [
        ((8, 16), (("pod", "data"), "model")), ((16, 4), (("pod", "data", "model"), None)),
        ((4, 8), ("model", ("pod", "data"))), ((8, 6, 4), ("pod", None, "data")),
        ((8, 8), (("data", "model"), "pod"))]),
}


def _jax_slices() -> dict:
    """JAX's devices_indices_map for every case, keyed by mesh coordinate."""
    code = textwrap.dedent("""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        cases = json.loads(os.environ["CASES"])
        out = {}
        for key, (sizes, names, items) in cases.items():
            mesh = jax.make_mesh(tuple(sizes), tuple(names))
            coords = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
            res = []
            for shape, spec in items:
                spec = [tuple(e) if isinstance(e, list) else e for e in spec]
                m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
                res.append({",".join(map(str, coords[d.id])):
                            [[s.start or 0, s.stop if s.stop is not None else n]
                             for s, n in zip(sl, shape)] for d, sl in m.items()})
            out[key] = res
        print(json.dumps(out))
    """)
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "CASES": json.dumps(SLICE_CASES)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_shard_slice_equals_devices_indices_map():
    want = _jax_slices()
    for key, (sizes, names, items) in SLICE_CASES.items():
        axis_sizes = dict(zip(names, sizes))
        for (shape, spec), by_coord in zip(items, want[key]):
            assert len(by_coord) == int(np.prod(sizes))
            for coord, bounds in by_coord.items():
                c = dict(zip(names, map(int, coord.split(","))))
                got = shard_slice(shape, spec, axis_sizes, c)
                assert [[s.start, s.stop] for s in got] == bounds, (key, shape, spec, coord)


# ----------------------------------------------------------------- costs


@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_analytic_cost_equals_the_reference(arch_id):
    for shape in SHAPES.values():
        for cbpe in (2.0, 1.03):
            want = jax_analytic_cost(jax_get_config(arch_id), shape, cache_bytes_per_elem=cbpe)
            got = analytic_cost(get_config(arch_id), shape, cache_bytes_per_elem=cbpe)
            for field in ("model_flops", "hlo_flops_est", "hbm_bytes", "n_active", "n_total",
                          "breakdown"):
                assert getattr(got, field) == getattr(want, field), (shape.name, field)


HLO = """\
ENTRY %main (p: f32[8,16]) -> f32[8,16] {{
  %c = {line}
}}
"""
COLLECTIVE_LINES = [
    ("all-reduce", "f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p), replica_groups=[2,4]<=[8]",
     8 * 16 * 4, 8 * 16 * 4, 4),
    ("all-gather", "bf16[32,16]{1,0} all-gather(bf16[8,16]{1,0} %p), replica_groups=[2,4]<=[8]",
     8 * 16 * 2, 32 * 16 * 2, 4),
    ("reduce-scatter",
     "f32[4,16]{1,0} reduce-scatter(f32[8,16]{1,0} %p), replica_groups={{0,1}}",
     8 * 16 * 4, 4 * 16 * 4, 2),
    ("all-to-all", "s32[8,16]{1,0} all-to-all(s32[8,16]{1,0} %p), replica_groups=[1,8]<=[8]",
     8 * 16 * 4, 8 * 16 * 4, 8),
    ("collective-permute",
     "f32[8,16]{1,0} collective-permute(f32[8,16]{1,0} %p), source_target_pairs={{0,1}}",
     8 * 16 * 4, 8 * 16 * 4, 16),
]


@pytest.mark.parametrize("kind,line,operand,result,g", COLLECTIVE_LINES,
                         ids=[c[0] for c in COLLECTIVE_LINES])
def test_ring_costs_equal_the_reference(kind, line, operand, result, g):
    (op,) = parse_collectives(HLO.format(line=line))
    assert op.kind == kind and op.group_size == g
    assert ring_wire_bytes(kind, operand, result, g) == op.wire_bytes


def test_roofline_terms_equal_the_reference():
    for args in ((1e15, 2e15, 3e12, 4e9, 256), (5e12, 4e12, 9e13, 1e6, 512),
                 (1.0, 1.0, 1.0, 1e12, 8)):
        want = jax_roofline_terms(*args, hw=JAX_TPU_V5E).as_dict()
        assert roofline_terms(*args, hw=TPU_V5E).as_dict() == want
