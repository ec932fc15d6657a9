"""The sharded port on 8 CPU ranks (``gloo``) against the unsharded port and
the JAX package: the forward and the MoE block on the debug mesh, two train
steps, the int8 all-reduce, elastic restore across meshes, and every rank's
DTensor shard against ``sharding.mesh.shard_slice``.  The ranks run in
``tests/torch_mesh_workers.py``; the JAX side runs here (one device, or a
subprocess with 8 forced host devices for ``compressed_psum``).

Tolerances:
  * forward, reduced internlm2-1.8b in fp32 compute on (2, 4): sharded vs
    unsharded port within 1e-5 of max |logit|; sharded vs JAX within the
    unsharded parity test's 1e-4 (``test_torch_families.LOGIT_TOL``);
  * MoE, reduced moonshot-v1-16b-a3b in fp32: within 1e-3 relative (of max
    |logit|), the reference's bound, against both;
  * a cached prefill and two decode steps, fp32 compute and cache (a bf16
    cache makes decode attention's output bf16, whose products then round
    by the sharding), heads mode (reduced
    internlm2-1.8b on (2, 4)) and seq mode (reduced qwen2-vl-2b on (1, 8)):
    within 1e-5 of max |logit| of the unsharded port;
  * train step, reduced tinyllama-1.1b in fp32, two steps with a mask
    refresh each: loss and gradient norm within rtol 1e-5, every param
    within 1e-4 of the plan-less step's, masks equal;
  * compressed_psum: against the exact all-reduce rel < 0.02 (the
    reference's bound); against the JAX one on the same 8 shards ≤ 1e-6 rel;
  * elastic restore and the reference's checkpoint: bit for bit.
"""
from __future__ import annotations

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.models.registry import get_arch as jax_get_arch
from repro.sharding.mesh import MeshPlan as JaxMeshPlan
from repro.utils.tree import named_leaves as jax_named_leaves
from torch_mesh_workers import run_ranks

WORLD = 8


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_pair(arch_id: str, b: int, s: int, seed: int):
    jarch = jax_get_arch(arch_id, reduced=True)
    jcfg = jarch.cfg.replace(compute_dtype="float32")
    params = jarch.module.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    want, _ = jarch.module.forward(params, jcfg, JaxMeshPlan(), tokens=jnp.asarray(tokens))
    return _np(params), {"tokens": tokens}, np.asarray(want, np.float32)


def _scaled_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_compressed_psum(x_path, y_path) -> None:
    code = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, numpy as np
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.train.grad_compression import compressed_psum
        x = np.load(sys.argv[1])
        mesh = jax.make_mesh((8,), ("data",))
        f = shard_map(lambda s: compressed_psum(s[0], "data"), mesh=mesh,
                      in_specs=P("data", None), out_specs=P())
        np.save(sys.argv[2], np.asarray(jax.jit(f)(x)))
    """)
    res = subprocess.run([sys.executable, "-c", code, str(x_path), str(y_path)],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]


SLICE_CASES = [
    ((2, 4), ("data", "model"), [((8, 16), ("data", "model")), ((8, 12), (None, "data")),
                                 ((16, 4), (["data", "model"], None))]),
    ((4, 2), ("data", "model"), [((8, 16), ("model", "data")), ((4, 6, 8), ("data", None, None))]),
    ((2, 2, 2), ("pod", "data", "model"), [((8, 16), (["pod", "data"], "model")),
                                           ((16, 8), (["pod", "data", "model"], None))]),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX side here, then every multi-rank check in one 8-rank group."""
    tmp = tmp_path_factory.mktemp("mesh")
    fwd_params, fwd_in, fwd_want = _jax_pair("internlm2-1.8b", 4, 32, 1)
    moe_params, moe_in, moe_want = _jax_pair("moonshot-v1-16b-a3b", 4, 32, 2)
    qwen_params, _, _ = _jax_pair("qwen2-vl-2b", 4, 8, 4)
    rng4 = np.random.default_rng(4)
    prompt = rng4.integers(0, 256, (4, 8)).astype(np.int32)
    steps = [rng4.integers(0, 256, (4, 1)).astype(np.int32) for _ in range(2)]
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, 256, (8, 16)).astype(np.int32),
                "labels": rng.integers(0, 256, (8, 16)).astype(np.int32)} for _ in range(2)]
    shards = np.random.default_rng(0).standard_normal((WORLD, 64)).astype(np.float32)
    np.save(tmp / "x.npy", shards)
    _jax_compressed_psum(tmp / "x.npy", tmp / "y.npy")
    ref_params = jax_get_arch("tinyllama-1.1b", reduced=True).init_params(jax.random.PRNGKey(5))
    JaxCheckpointer(str(tmp / "reference")).save(ref_params, step=3)
    out = run_ranks("check_all", WORLD, tmp / "ranks", checks={
        "forward": ("check_forward", dict(arch_id="internlm2-1.8b", params_np=fwd_params,
                                          inputs=fwd_in)),
        "moe": ("check_forward", dict(arch_id="moonshot-v1-16b-a3b", params_np=moe_params,
                                      inputs=moe_in)),
        "decode_heads": ("check_decode", dict(arch_id="internlm2-1.8b", mesh_dims=(2, 4),
                                              params_np=fwd_params, tokens=prompt,
                                              steps=steps)),
        "decode_seq": ("check_decode", dict(arch_id="qwen2-vl-2b", mesh_dims=(1, 8),
                                            params_np=qwen_params, tokens=prompt,
                                            steps=steps)),
        "train": ("check_train_step", dict(arch_id="tinyllama-1.1b", batches=batches)),
        "psum": ("check_compressed_psum", dict(shards=shards)),
        "restore": ("check_elastic_restore", dict(reference_dir=str(tmp / "reference"))),
        "slices": ("check_slices", dict(cases=SLICE_CASES)),
    })
    out["forward"]["jax"], out["moe"]["jax"] = fwd_want, moe_want
    out["psum"]["jax"] = np.load(tmp / "y.npy")
    out["restore"]["jax"] = ref_params
    return out


def test_sharded_forward_equals_unsharded_and_jax(ranks):
    out = ranks["forward"]
    assert out["placements"] == "(Shard(dim=0), Shard(dim=2))"  # batch × vocab
    assert _scaled_err(out["sharded"], out["plain"]) <= 1e-5
    np.testing.assert_allclose(out["sharded"], out["jax"], rtol=0, atol=1e-4)


def test_sharded_moe_equals_unsharded_and_jax(ranks):
    out = ranks["moe"]
    assert _scaled_err(out["sharded"], out["plain"]) <= 1e-3
    assert _scaled_err(out["sharded"], out["jax"]) <= 1e-3


@pytest.mark.parametrize("which,mode", [("decode_heads", "heads"), ("decode_seq", "seq")])
def test_sharded_cache_prefill_and_decode_equal_unsharded(ranks, which, mode):
    """A prefill into a cache laid out by ``plan.cache_spec()`` and two
    decode steps; in seq mode (4 heads on an 8-way model axis) the cache is
    sequence-sharded and decode runs flash-decode style."""
    out = ranks[which]
    assert out["attn_shard"] == mode
    for got, want in zip(out["sharded"], out["plain"]):
        assert _scaled_err(got, want) <= 1e-5


def test_sharded_train_step_equals_plan_less_step(ranks):
    out = ranks["train"]
    for key in ("loss", "grad_norm"):
        for got, want in out[key]:
            assert got == pytest.approx(want, rel=1e-5), key
    assert out["param_max_abs"] <= 1e-4
    assert out["masks_equal"] and out["step"] == 2


def test_compressed_psum_matches_exact_and_jax(ranks):
    out = ranks["psum"]
    got, exact, jax_out = out["compressed"], out["exact"], out["jax"]
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02
    assert np.linalg.norm(got - jax_out) / np.linalg.norm(jax_out) <= 1e-6


def test_elastic_restore_across_meshes(ranks):
    out = ranks["restore"]
    assert out["same"] and out["placements"]
    for name, leaf in jax_named_leaves(out["jax"]):
        got, _ = out["reference"][name]
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            want = want.view(np.int16)
        assert np.array_equal(got, want), name


def test_dtensor_shards_equal_shard_slice(ranks):
    assert ranks["slices"]["bad"] == 0


def test_launcher_trains_on_the_debug_mesh(tmp_path):
    """``launch/train.py --mesh debug`` under torchrun, 8 gloo ranks: it trains
    and checkpoints (rank 0 writes) where it used to exit."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(WORLD), "-m", "repro_torch.launch.train", "--mesh", "debug", "--reduced",
         "--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "16",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
             "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "done at step 2" in res.stderr
    assert (tmp_path / "ck" / "LATEST").read_text() == "2"
