"""GPipe-style pipeline parallelism over an existing mesh axis.

The port of ``repro.sharding.pipeline``.  ``pipeline_apply`` runs a stage
function over S stages laid out on a chosen mesh axis, streaming M
microbatches through the classic GPipe schedule (S + M − 1 ticks, bubble
fraction (S−1)/(S+M−1)).  Stage-to-stage transfer is one ring exchange per
tick on the axis's process group (``dist.batch_isend_irecv``: every stage
sends to the next and receives from the previous; the wrap-around edge is
unused), where the reference issues one ``ppermute``.  The last stage's
collected outputs reach every stage through one all-reduce of the
one-hot-owned buffer, as the reference's ``psum``.

Every rank of the axis runs this function (SPMD): rank r of the axis is
stage r.  ``stage_params`` holds the stages on a leading (S,) axis, either
whole on every rank or as DTensors sharded on that axis; each rank uses its
own stage's slice.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.utils.tree import tree_map


def _own_stage(leaf: torch.Tensor, stage: int) -> torch.Tensor:
    if isinstance(leaf, DTensor):  # sharded on the stage axis: the local block
        return leaf.to_local()[0]
    return leaf[stage]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor, int], torch.Tensor],
    stage_params: Any,  # tree with leading (S,) stage axis
    x: torch.Tensor,  # (M, mb, ...) microbatched input, the same on every rank
    mesh: DeviceMesh,
    axis: str = "model",
) -> torch.Tensor:
    """Run S pipeline stages over M microbatches.

    ``stage_fn(params_for_stage, microbatch, stage_index)`` must be
    shape-preserving (classic homogeneous-trunk pipelining).  Returns the
    (M, mb, ...) outputs after all S stages, on every rank of the axis."""
    group = mesh.get_group(axis)
    s = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (stage + 1) % s)
    prv = dist.get_global_rank(group, (stage - 1) % s)
    m = x.shape[0]
    params = tree_map(lambda leaf: _own_stage(leaf, stage), stage_params)

    buf = torch.zeros_like(x[0])  # the resident microbatch
    outs = torch.zeros_like(x)
    for t in range(s + m - 1):
        # stage 0 injects microbatch t (when in range); the others take what
        # the previous stage passed at the end of the last tick
        cur = x[min(t, m - 1)] if stage == 0 else buf
        live = 0 <= t - stage < m
        y = stage_fn(params, cur, stage) if live else cur
        recv = torch.empty_like(y)
        if s > 1:
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                                               dist.P2POp(dist.irecv, recv, prv, group)]):
                req.wait()
        else:
            recv = y
        # the last stage collects its finished microbatch
        done = t - (s - 1)
        if stage == s - 1 and 0 <= done < m:
            outs[done] = y
        buf = recv
    # every stage gets the last stage's outputs (a sum over one-hot ownership)
    outs = outs * (1.0 if stage == s - 1 else 0.0)
    dist.all_reduce(outs, group=group)
    return outs


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble: (S−1) / (S+M−1)."""
    return (n_stages - 1) / (n_stages + n_microbatches - 1)
