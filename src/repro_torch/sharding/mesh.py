"""MeshPlan — the one object that tells models and launchers how to shard.

The port of ``repro.sharding.mesh`` onto ``torch.distributed``: the mesh is
a ``DeviceMesh`` whose dimensions carry the reference's axis names, and a
sharded tensor is a DTensor.

Axis conventions (the reference's):
  * ``data`` (+ ``pod`` on the multi-pod mesh) — batch / FSDP axis ("dp").
  * ``model``                                  — TP / SP / EP axis ("tp").

A partition spec is a plain tuple of entries, one per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product, the first axis major).  ``spec_placements`` turns a spec
into DTensor placements on a mesh: an entry naming axes ``(a, b)`` for
tensor dim ``i`` becomes ``Shard(i)`` on mesh dims ``a`` and ``b``, every
other mesh dim gets ``Replicate()``.  DTensor splits a dim sharded over
several mesh dims in mesh-dim order, so the axes of an entry must come in
the mesh's order, as ``("pod", "data")`` does.

``MeshPlan.constrain`` is the reference's ``with_sharding_constraint``: a
DTensor is redistributed to the spec's layout; a plain tensor (and every
tensor when the plan has no mesh) passes unchanged.  A ``MeshPlan`` with
``mesh=None`` so degrades every constraint to the identity, and the same
model code runs on one device and sharded without branches.

No function here creates or touches a process group at import time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Literal

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig

Spec = tuple  # entries: None | axis name | tuple of axis names


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def distribute_copy(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """x (the whole logical tensor, the same on every rank) as a DTensor in
    ``placements``: each rank keeps a copy of its own block, not a view
    that would keep all of x alive."""
    t = distribute_tensor(x, mesh, placements, src_data_rank=None)
    return DTensor.from_local(t.to_local().clone(), mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def spec_placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (see the module doc)."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names axes out of the mesh's order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of spec {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)

    def distribute(self, x: torch.Tensor) -> DTensor:
        """x (the whole logical tensor, the same on every rank) as a DTensor
        in this layout: each rank keeps its shard."""
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_copy(x, self.mesh, self.placements)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without devices or a process group
    (JAX's ``AbstractMesh``): enough for ``make_plan`` and the partition
    specs, not for DTensors."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names

    @property
    def ndim(self) -> int:
        return len(self.axis_sizes)

    def size(self, mesh_dim: int | None = None) -> int:
        return math.prod(self.axis_sizes) if mesh_dim is None else self.axis_sizes[mesh_dim]


def shard_slice(shape: tuple[int, ...], spec: Spec, axis_sizes: dict[str, int],
                coord: dict[str, int]) -> tuple[slice, ...]:
    """The block of a ``shape`` tensor laid out by ``spec`` that the device
    at mesh coordinate ``coord`` (axis name → index) holds, as one slice per
    dim.  A dim over axes (a, b) is cut into |a|·|b| equal blocks, numbered
    a-major; dims must divide (``partition.spec_for_leaf`` replicates the
    others), as in JAX's ``NamedSharding.devices_indices_map``."""
    out = []
    for i, size in enumerate(shape):
        axes = _axes(spec[i]) if i < len(spec) else ()
        n, block = 1, 0
        for a in axes:
            n, block = n * axis_sizes[a], block * axis_sizes[a] + coord[a]
        if size % n:
            raise ValueError(f"dim {i} of size {size} does not divide over {axes}")
        step = size // n
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    mesh: DeviceMesh | None = None
    dp_axes: tuple[str, ...] = ("data",)  # ("pod", "data") on multi-pod
    tp_axis: str = "model"
    # per-(arch, shape) switches
    attn_shard: Literal["heads", "head_dim", "seq"] = "heads"
    kv_repeat: int = 1
    shard_batch: bool = True  # False for global_batch < |dp| (e.g. long_500k)
    seq_shard_cache: bool = False  # flash-decode style KV-seq sharding
    cache_quant_int8: bool = False  # SONIC C2 applied to the KV cache
    serve_stationary: bool = False  # TP-only (no-FSDP) serving weights

    # -- spec helpers ------------------------------------------------------
    @property
    def dp(self):  # use inside spec positions
        return self.dp_axes if (self.shard_batch and self.mesh) else None

    @property
    def tp(self):
        return self.tp_axis if self.mesh else None

    def spec(self, *entries) -> Spec:
        return tuple(entries)

    def ns(self, *entries) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, tuple(entries))

    def constrain(self, x: torch.Tensor, *entries) -> torch.Tensor:
        """``x.redistribute`` to the spec's layout when x is a DTensor and
        the plan has a mesh, else x."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        pl = spec_placements(self.mesh, tuple(entries))
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(self.mesh, pl)

    def shard(self, x: torch.Tensor, *entries) -> torch.Tensor:
        """x laid out by the spec: a DTensor redistributed, a plain tensor
        (the same whole value on every rank) distributed; x itself without
        a mesh."""
        if self.mesh is None:
            return x
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return self.constrain(x, *entries)

    def replicating(self):
        """A context in which a plain tensor meeting a DTensor counts as
        replicated (DTensor's ``implicit_replication``): a meshed forward's
        positions, masks and constants are the same on every rank.  A null
        context without a mesh."""
        if self.mesh is None or DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()  # (DTensor's context does not nest)
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()

    def local(self, fn, out_specs, *args, partial: str | None = None):
        """fn over each device's own blocks of ``args`` (DTensors as they are
        laid out; other values as they are), its output laid out by
        ``out_specs``: one spec, or a list of specs for a tuple of outputs
        (the reference's ``shard_map``).  ``partial`` names a mesh axis over
        which the (single) output holds partial sums.

        Gradients: an argument replicated over a mesh axis on which another
        argument is sharded gets a partial gradient there (each device
        differentiates its own share of the work), else one laid out as the
        argument."""
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map

        dts = [a for a in args if isinstance(a, DTensor)]
        split = [any(isinstance(a.placements[i], Shard) for a in dts)
                 for i in range(self.mesh.ndim)]
        grads = [tuple(Partial() if split[i] and isinstance(q, Replicate) else q
                       for i, q in enumerate(a.placements)) if isinstance(a, DTensor) else None
                 for a in args]

        if isinstance(out_specs, list):
            out = tuple(list(spec_placements(self.mesh, s)) for s in out_specs)
        else:
            out = list(spec_placements(self.mesh, out_specs))
            if partial is not None:
                out[self.mesh.mesh_dim_names.index(partial)] = Partial()
        return local_map(fn, out_placements=out, in_grad_placements=tuple(grads),
                         device_mesh=self.mesh)(*args)

    def cache_spec(self) -> tuple:
        """Spec entries for a KV cache (B, S_max, KH_eff, Dh).

        heads mode:    batch over dp, heads over tp.
        head_dim mode: batch over dp, Dh over tp.
        seq mode:      batch over dp, SEQUENCE over tp (flash-decode style:
                       heads don't divide tp; attention's reductions over the
                       sharded seq dim become partial sums).
        With ``seq_shard_cache`` and an unsharded batch (long_500k), the idle
        dp axes shard the cache sequence dim instead.
        """
        if self.attn_shard == "seq":
            return (self.dp, self.tp, None, None)
        head_entries = (
            (self.tp, None) if self.attn_shard == "heads" else (None, self.tp)
        )
        if self.seq_shard_cache and not self.shard_batch:
            return (None, self.dp_axes if self.mesh else None, *head_entries)
        return (self.dp, None, *head_entries)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.axis_size(a) for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.axis_size(self.tp_axis)

    def axis_size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """Axis name → size (the reference's ``mesh.shape``)."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _attention_mode(cfg: ModelConfig, tp: int) -> tuple[str, int]:
    """Pick the attention sharding mode and the KV replication factor.

    heads: n_heads divides tp (KV heads replicated as needed).
    seq:   n_heads doesn't divide tp (qwen2-vl: 12H vs 16) — queries stay
           sequence-sharded, K/V replicate (cheap: few KV heads).
    """
    from repro_torch.models.layers import kv_repeat_factor

    if cfg.n_heads % tp == 0:
        r = kv_repeat_factor(cfg, tp)
        return "heads", r
    return "seq", 1


def make_plan(
    cfg: ModelConfig,
    mesh: DeviceMesh | None,
    global_batch: int | None = None,
    **overrides: Any,
) -> MeshPlan:
    if mesh is None:
        return MeshPlan(mesh=None, **overrides)
    shape = mesh_shape(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in shape)
    tp = shape["model"]
    attn_shard, kv_rep = _attention_mode(cfg, tp)
    dp_total = math.prod(shape[a] for a in dp_axes)
    shard_batch = global_batch is None or (global_batch % dp_total == 0)
    kw = dict(
        mesh=mesh,
        dp_axes=dp_axes,
        tp_axis="model",
        attn_shard=attn_shard,
        kv_repeat=kv_rep,
        shard_batch=shard_batch,
    )
    kw.update(overrides)
    return MeshPlan(**kw)
