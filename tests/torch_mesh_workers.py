"""Multi-rank checks of the port's sharding slice, run on ``gloo`` process
groups of CPU ranks (not collected: no ``test_`` prefix).

``run_ranks(check, world, tmp, **inputs)`` starts ``world`` ranks, each a
fresh interpreter running this file, that meet through a ``FileStore`` in
``tmp`` (no TCP port), each with one intra-op thread; every rank runs
``check(rank, tmp, **inputs)``, and rank 0's return value (a dict of
numbers and numpy arrays) comes back through a file.  The checks import torch and the port only: the tests compute the JAX
package's side in their own process and hand it in as numpy.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 240


def _entry(check: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = globals()[check](rank, tmp, **inputs)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except Exception:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(check: str, world: int, tmp, **inputs) -> dict:
    """``world`` fresh interpreters (this file as a script), one per rank."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), check, str(r),
                               str(world), tmp], env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        logged = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                  if f.startswith("error")]
        raise AssertionError("\n".join(logged) or "\n".join(e[-2000:] for e in errs))
    with open(os.path.join(tmp, "result.pkl"), "rb") as f:
        return pickle.load(f)


def _np(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _params(arch, cfg, params_np):
    from repro_torch.convert import params_from_jax

    return params_from_jax(params_np, "cpu")


# ------------------------------------------------------------------ checks


def check_slices(rank: int, tmp: str, cases) -> dict:
    """Every rank's DTensor shard equals the block ``shard_slice`` names."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.mesh import NamedSharding, shard_slice

    bad = []
    for sizes, names, items in cases:
        mesh = init_device_mesh("cpu", tuple(sizes), mesh_dim_names=tuple(names))
        coord = {n: mesh.get_local_rank(n) for n in names}
        for shape, spec in items:
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
            full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
            local = NamedSharding(mesh, spec).distribute(full).to_local()
            want = full[shard_slice(shape, spec, dict(zip(names, sizes)), coord)]
            if not torch.equal(local, want):
                bad.append((sizes, shape, spec, rank))
    flags = torch.tensor([len(bad)])
    dist.all_reduce(flags)
    return {"bad": int(flags)}


def check_forward(rank: int, tmp: str, arch_id: str, params_np, inputs) -> dict:
    """The arch's fp32 forward on the debug mesh, and unsharded."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.sharding.mesh import make_plan
    from repro_torch.sharding.partition import shard_params

    arch = get_arch(arch_id, reduced=True)
    cfg = arch.cfg.replace(compute_dtype="float32")
    params = _params(arch, cfg, params_np)
    kw = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in inputs.items()}
    plain, _ = arch.forward(params, cfg, **kw)
    plan = make_plan(cfg, make_debug_mesh(2, 4, device_type="cpu"), kw[next(iter(kw))].shape[0])
    sharded, _ = arch.forward(shard_params(params, plan), cfg, plan=plan,
                              **{k: plan.shard(v, plan.dp, *([None] * (v.dim() - 1)))
                                 for k, v in kw.items()})
    return {"plain": _np(plain), "sharded": _np(sharded), "placements": str(sharded.placements)}


def check_decode(rank: int, tmp: str, arch_id: str, mesh_dims, params_np, tokens,
                 steps) -> dict:
    """A prefill into a cache laid out on the mesh and decode steps, sharded
    and unsharded (fp32 compute, an fp32 cache): the logits of each."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.sharding.mesh import make_plan
    from repro_torch.sharding.partition import shard_params

    arch = get_arch(arch_id, reduced=True)
    cfg = arch.cfg.replace(compute_dtype="float32")
    params = _params(arch, cfg, params_np)
    plan = make_plan(cfg, make_debug_mesh(*mesh_dims, device_type="cpu"), tokens.shape[0])
    sp = shard_params(params, plan)
    b, s = tokens.shape
    max_len = s + len(steps)
    plain_cache = arch.init_cache(b, max_len, "cpu", cfg, dtype=torch.float32)
    cache = arch.init_cache(b, max_len, None, cfg, plan=plan, dtype=torch.float32)
    tok = torch.from_numpy(tokens).long()
    want, _ = arch.forward(params, cfg, tokens=tok, cache=plain_cache)
    got, _ = arch.forward(sp, cfg, plan=plan, tokens=plan.shard(tok, plan.dp, None),
                          cache=cache)
    out = {"attn_shard": plan.attn_shard, "plain": [_np(want)], "sharded": [_np(got)]}
    for i, step in enumerate(steps):
        t = torch.from_numpy(step).long()
        pos = torch.full((b,), s + i, dtype=torch.long)
        want, _ = arch.forward(params, cfg, tokens=t, cache=plain_cache, cache_pos=pos)
        got, _ = arch.forward(sp, cfg, plan=plan, tokens=plan.shard(t, plan.dp, None),
                              cache=cache, cache_pos=plan.shard(pos, plan.dp))
        out["plain"].append(_np(want))
        out["sharded"].append(_np(got))
    return out


def check_train_step(rank: int, tmp: str, arch_id: str, batches) -> dict:
    """Two sharded steps (debug mesh) against the plan-less step."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.sharding.mesh import make_plan
    from repro_torch.sharding.partition import shard_params
    from repro_torch.train.loop import TrainConfig, build_train_step
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import TrainState, init_train_state
    from repro_torch.utils.tree import named_leaves

    arch = get_arch(arch_id, reduced=True)
    cfg = arch.cfg.replace(compute_dtype="float32")
    tc = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1),
                     sparsity=SparsityConfig(target_sparsity=0.5, block=(8, 8),
                                             ramp_start_step=0, ramp_end_step=2),
                     mask_update_every=1, l2_coeff=1e-6)
    params = arch.init_params(torch.Generator().manual_seed(0), torch.device("cpu"), cfg)
    s0 = init_train_state(params, tc.opt, tc.sparsity)
    plan = make_plan(cfg, make_debug_mesh(2, 4, device_type="cpu"), batches[0]["tokens"].shape[0])

    def shard(t):
        return shard_params(t, plan)

    ref_step, step = build_train_step(arch, tc, cfg), build_train_step(arch, tc, cfg, plan=plan)
    ref = s0
    st = TrainState(shard(s0.params), {k: shard(v) for k, v in s0.opt_state.items()},
                    shard(s0.masks), s0.step)
    out = {"loss": [], "grad_norm": []}
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        ref, rm = ref_step(ref, tb, i)
        st, m = step(st, {k: plan.shard(v, plan.dp, None) for k, v in tb.items()}, i)
        for k in out:
            out[k].append((float(m[k]), float(rm[k])))
    want = dict(named_leaves(ref.params))
    masks = dict(named_leaves(ref.masks))
    out["param_max_abs"] = max(float((_np(p) - want[n].float().numpy()).__abs__().max())
                               for n, p in named_leaves(st.params))
    out["masks_equal"] = all(np.array_equal(_np(m), masks[n].float().numpy())
                             for n, m in named_leaves(st.masks))
    out["step"] = int(st.step)
    return out


def check_compressed_psum(rank: int, tmp: str, shards) -> dict:
    from repro_torch.train.grad_compression import compressed_psum

    x = torch.from_numpy(shards[rank])
    exact = x.clone()
    dist.all_reduce(exact)
    return {"compressed": compressed_psum(x).numpy(), "exact": exact.numpy()}


def check_elastic_restore(rank: int, tmp: str, reference_dir: str) -> dict:
    """Save a sharded state under (2, 4), restore it under (4, 2); restore a
    checkpoint the reference wrote under (4, 2) too."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.sharding.mesh import make_plan
    from repro_torch.sharding.partition import param_shardings, shard_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import init_train_state
    from repro_torch.utils.tree import named_leaves

    arch = get_arch("tinyllama-1.1b", reduced=True)
    params = arch.init_params(torch.Generator().manual_seed(0), torch.device("cpu"))
    state = init_train_state(params, AdamWConfig())
    plan_a = make_plan(arch.cfg, make_debug_mesh(2, 4, device_type="cpu"), 4)
    sharded = state._replace(params=shard_params(state.params, plan_a),
                             opt_state={k: shard_params(v, plan_a)
                                        for k, v in state.opt_state.items()})
    ck = Checkpointer(os.path.join(tmp, "ck"), keep=2)
    ck.save(sharded, step=5)

    plan_b = make_plan(arch.cfg, make_debug_mesh(4, 2, device_type="cpu"), 4)
    lay = param_shardings(params, plan_b)
    restored = ck.restore(state, step=5, shardings=state._replace(
        params=lay, opt_state={"m": lay, "v": lay}, step=None))
    want = dict(named_leaves(state))
    same = True
    placements_b = True
    for name, leaf in named_leaves(restored):
        full = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
        same &= torch.equal(full, want[name])
        if name.startswith("0/") and hasattr(leaf, "placements"):
            placements_b &= tuple(leaf.placements) == lay_of(lay, name[2:])

    theirs = Checkpointer(reference_dir).restore(params, shardings=lay)
    ref_leaves = {n: (_np_raw(leaf.full_tensor()), str(leaf.dtype))
                  for n, leaf in named_leaves(theirs)}
    return {"same": bool(same), "placements": bool(placements_b), "reference": ref_leaves}


def lay_of(lay, name: str) -> tuple:
    node = lay
    for k in name.split("/"):
        node = node[k]
    return tuple(node.placements)


def _np_raw(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def check_serve(rank: int, tmp: str, arch_id: str, mesh_dims, compute: str, params_np,
                prompts, requests, sc: dict, plan_kw: dict | None = None,
                spec: dict | None = None) -> dict:
    """The plan-less engine (rank 0) and ``ServeEngine(plan=make_plan(cfg,
    mesh, 4, **plan_kw))`` on the debug mesh: greedy ``generate(prompts,
    8)`` and a ``ContinuousScheduler(n_slots=2, segment_len=4)`` run of ``requests``
    ((prompt, max_new) pairs), and with ``spec`` (``SpecConfig`` fields) a
    speculative scheduler run too.  Each rank's meshed tokens are held
    against every other rank's."""
    import dataclasses

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.serve.engine import ServeConfig, ServeEngine, SpecConfig
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.sharding.mesh import make_plan

    base = get_arch(arch_id, reduced=True)
    arch = dataclasses.replace(base, cfg=base.cfg.replace(compute_dtype=compute))
    params = _params(arch, arch.cfg, params_np)
    plan = make_plan(arch.cfg, make_debug_mesh(*mesh_dims, device_type="cpu"), 4,
                     **(plan_kw or {}))
    toks = torch.from_numpy(prompts).long()

    def schedule(eng) -> list:
        sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, clock=lambda: 0.0)
        handles = [sched.submit(p, n) for p, n in requests]
        while sched.has_work():
            sched.run_segment()
        return [h.tokens for h in handles]

    out = {"attn_shard": plan.attn_shard}
    # the plan-less engine on rank 0 only (the ranks compute the same)
    for name, kw in [("plain", {}), ("meshed", {"plan": plan})][rank > 0:]:
        eng = ServeEngine(arch, params, ServeConfig(max_len=32, **sc), "cpu", **kw)
        out[name] = {"generate": eng.generate(toks, 8).numpy(), "continuous": schedule(eng)}
        if spec is not None:
            seng = ServeEngine(arch, params, ServeConfig(max_len=32, spec=SpecConfig(**spec),
                                                         **sc), "cpu", **kw)
            out[name]["spec"] = schedule(seng)
    flat = torch.tensor(np.concatenate([out["meshed"]["generate"].reshape(-1)] + [
        np.asarray(t, np.int64) for k in ("continuous", "spec") for t in out["meshed"].get(k, [])
    ]))
    lo, hi = flat.clone(), flat.clone()
    dist.all_reduce(lo, dist.ReduceOp.MIN)
    dist.all_reduce(hi, dist.ReduceOp.MAX)
    out["ranks_agree"] = bool(torch.equal(lo, hi))
    return out


# the dense projection's layouts under serving: (x's placements, w's) on
# ("data", "model"): column-parallel, row-parallel (a partial sum over
# model) and an FSDP weight (K split over data, gathered)
DENSE_LAYOUTS = {"column": ((("s", 0), ("r",)), (("r",), ("s", 1))),
                 "row": ((("s", 0), ("s", 2)), (("r",), ("s", 0))),
                 "fsdp": ((("s", 0), ("r",)), (("s", 0), ("s", 1)))}


def check_dense_rows(rank: int, tmp: str, x_np, w_np) -> dict:
    """``layers.dense_apply`` under ``torch.inference_mode`` on the (2, 4)
    debug mesh, in every layout of ``DENSE_LAYOUTS``: x (8, 1, K) against
    each pair of its rows alone (each device then holds 4 rows, or 1).
    {layout: number of entries of the pairs' rows that differ from the
    same rows of the 8}."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers

    mesh = make_debug_mesh(2, 4, device_type="cpu")

    def lay(spec):
        return [Shard(q[1]) if q[0] == "s" else Replicate() for q in spec]

    x, w = torch.from_numpy(x_np), torch.from_numpy(w_np)
    out = {}
    for name, (xs, ws) in DENSE_LAYOUTS.items():
        wd = distribute_tensor(w, mesh, lay(ws))
        with torch.inference_mode():
            def y(rows):
                return layers.dense_apply({"kernel": wd}, distribute_tensor(
                    rows, mesh, lay(xs))).full_tensor()

            whole = y(x)
            pairs = torch.cat([y(x[i::4]) for i in range(4)])
            want = torch.cat([whole[i::4] for i in range(4)])
        out[name] = int((pairs != want).sum())
    return out


def check_all(rank: int, tmp: str, checks: dict) -> dict:
    """Several checks in one group, in order: {name: (check, inputs)}."""
    return {name: globals()[check](rank, os.path.join(tmp, name), **inputs)
            for name, (check, inputs) in checks.items()}


def check_pipeline(rank: int, tmp: str, ws, x) -> dict:
    """``pipeline_apply`` over the model axis of the (2, 4) debug mesh, the
    stages whole on every rank and as a DTensor sharded on that axis."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.pipeline import pipeline_apply

    mesh = make_debug_mesh(2, 4, device_type="cpu")
    w, xt = torch.from_numpy(ws), torch.from_numpy(x)

    def stage_fn(wi, xb, stage):
        return torch.tanh(xb @ wi)

    whole = pipeline_apply(stage_fn, w, xt, mesh, "model")
    sharded = pipeline_apply(stage_fn, distribute_tensor(w, mesh["model"], [Shard(0)],
                                                         src_data_rank=None), xt, mesh, "model")
    seq = xt
    for s in range(w.shape[0]):
        seq = torch.tanh(seq @ w[s])
    same = torch.tensor([int(torch.equal(whole, sharded))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return {"pipelined": whole.numpy(), "sequential": seq.numpy(), "same": int(same)}


if __name__ == "__main__":
    _entry(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
