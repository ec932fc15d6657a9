"""Parameter partition specs: FSDP (over data/pod axes) × TP (over model).

The port of ``repro.sharding.partition``, its rules word for word.
``param_specs(abstract_params, plan)`` walks the param tree and assigns a
spec per leaf from name-pattern rules.  Dims that don't divide their
assigned axis product fall back to replication (guarded per leaf, so odd
shapes — e.g. hubert's 80-dim heads — never break).  DTensor would accept
an uneven shard where the reference replicates; the guard here keeps the
reference's layout exactly.

Rule language: each pattern maps to a tuple over the *logical* dims of the
leaf (ignoring the stacked (n_layers,) leading dim, which is always
unsharded): entries are "fsdp", "tp", or None.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.sharding.mesh import MeshPlan, NamedSharding, Spec
from repro_torch.utils.tree import tree_map_with_path_names

# (substring-match, spec) — first hit wins; evaluated on the full slash-path
_RULES: tuple[tuple[str, tuple], ...] = (
    # embeddings: shard d_model (gather stays local); lm_head: vocab-TP
    ("embed/embedding", (None, "tp")),
    ("lm_head/kernel", ("fsdp", "tp")),
    # attention
    ("attn/wq/kernel", ("fsdp", "tp")),
    ("attn/wk/kernel", ("fsdp", "tp")),
    ("attn/wv/kernel", ("fsdp", "tp")),
    ("attn/wo/kernel", ("tp", "fsdp")),
    # MoE experts (E, d, f) / (E, f, d): EP over tp when E divides, else the
    # divisibility guard drops to ("fsdp" on d) automatically via fallback
    ("moe/wi", ("tp", "fsdp", None)),
    ("moe/wg", ("tp", "fsdp", None)),
    ("moe/wo", ("tp", None, "fsdp")),
    ("router/kernel", (None, None)),
    # dense FFN
    ("ffn/wi/kernel", ("fsdp", "tp")),
    ("ffn/wg/kernel", ("fsdp", "tp")),
    ("ffn/wo/kernel", ("tp", "fsdp")),
    # mamba2
    ("in_proj/kernel", ("fsdp", "tp")),
    ("out_proj/kernel", ("tp", "fsdp")),
    ("conv_w", (None, "tp")),
    ("conv_b", ("tp",)),
    # rwkv6 time/channel mix
    ("time_mix/wr/kernel", ("fsdp", "tp")),
    ("time_mix/wk/kernel", ("fsdp", "tp")),
    ("time_mix/wv/kernel", ("fsdp", "tp")),
    ("time_mix/wg/kernel", ("fsdp", "tp")),
    ("time_mix/wo/kernel", ("tp", "fsdp")),
    ("channel_mix/wk/kernel", ("fsdp", "tp")),
    ("channel_mix/wv/kernel", ("tp", "fsdp")),
    ("channel_mix/wr/kernel", ("fsdp", "tp")),
    ("decay_lora", (None, None)),
)

_STACKED_PREFIXES = ("layers/", "mamba_layers/")


def _axes_for(entry: str | None, plan: MeshPlan):
    if entry == "fsdp":
        return plan.dp_axes
    if entry == "tp":
        return (plan.tp_axis,)
    return None


def spec_for_leaf(name: str, shape: tuple[int, ...], plan: MeshPlan) -> Spec:
    if plan.mesh is None:
        return ()
    stacked = name.startswith(_STACKED_PREFIXES)
    logical = shape[1:] if stacked and len(shape) > 1 else shape
    rule = None
    for pat, spec in _RULES:
        if pat in name:
            rule = spec
            break
    # MoE experts that don't divide TP (grok-1: 8e vs 16-way) switch from
    # EP-on-experts to TP-on-d_ff (matches moe.expert_split_factor's virtual
    # split) — without this the expert tensors barely shard at all.
    if rule is not None and "moe/" in name and len(logical) == 3:
        e = logical[0]
        if e % plan.tp_size != 0:
            rule = (None, "fsdp", "tp") if "wo" not in name else (None, "tp", "fsdp")
    if rule is None:
        # default: shard the largest dim over fsdp if rank ≥ 2, else replicate
        if len(logical) >= 2:
            big = max(range(len(logical)), key=lambda i: (logical[i], -i))
            rule = tuple("fsdp" if i == big else None for i in range(len(logical)))
        else:
            rule = (None,) * len(logical)
    rule = tuple(rule[: len(logical)]) + (None,) * (len(logical) - len(rule))
    entries = []
    for dim, ent in zip(logical, rule):
        axes = _axes_for(ent, plan)
        if axes is None:
            entries.append(None)
            continue
        size = math.prod(plan.axis_size(a) for a in axes)
        if dim % size == 0:
            entries.append(axes if len(axes) > 1 else axes[0])
        else:
            entries.append(None)  # divisibility fallback
    if stacked and len(shape) > 1:
        entries = [None] + entries
    return tuple(entries)


def _drop_fsdp(spec: Spec) -> Spec:
    """Serving (weight-stationary) variant: replicate over the dp axes.

    FSDP-sharded weights force an all-gather of every weight every step —
    right for training (amortized against optimizer-state memory), wrong for
    inference where there is no optimizer state and the weight working set
    re-streams every token.
    """
    dp_axes = {"data", "pod"}

    def keep(entry):
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a not in dp_axes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    return tuple(keep(e) for e in spec)


def _leaf_spec(name: str, leaf, plan: MeshPlan, serve: bool) -> Spec:
    spec = spec_for_leaf(name, tuple(leaf.shape), plan)
    return _drop_fsdp(spec) if serve else spec


def param_specs(abstract_params: Any, plan: MeshPlan, serve: bool = False) -> Any:
    """Tree of spec tuples matching ``abstract_params``."""
    return tree_map_with_path_names(lambda n, leaf: _leaf_spec(n, leaf, plan, serve),
                                    abstract_params)


def param_shardings(abstract_params: Any, plan: MeshPlan, serve: bool = False) -> Any:
    """Tree of ``NamedSharding`` (mesh, spec; ``.placements`` for DTensor)."""
    return tree_map_with_path_names(
        lambda n, leaf: NamedSharding(plan.mesh, _leaf_spec(n, leaf, plan, serve)),
        abstract_params)


def shard_params(params: Any, plan: MeshPlan, serve: bool = False) -> Any:
    """Every leaf of ``params`` (whole logical tensors, the same on every
    rank) as a DTensor in its layout; unchanged without a mesh."""
    if plan.mesh is None:
        return params
    return tree_map_with_path_names(
        lambda n, leaf: NamedSharding(plan.mesh, _leaf_spec(n, leaf, plan, serve))
        .distribute(leaf), params)


def sharded_abstract_params(
    abstract_params: Any, plan: MeshPlan, serve: bool = False
) -> Any:
    """DTensors of fake (or meta) local shards for an abstract param tree
    (the dry run's inputs): ``abstract_params`` holds tensors that carry
    shapes and dtypes only.  Call under ``FakeTensorMode`` for fake shards."""
    if plan.mesh is None:
        return abstract_params
    from torch.distributed.tensor import empty

    def one(name, leaf):
        pl = NamedSharding(plan.mesh, _leaf_spec(name, leaf, plan, serve)).placements
        return empty(leaf.shape, dtype=leaf.dtype, device_mesh=plan.mesh, placements=pl)

    return tree_map_with_path_names(one, abstract_params)


BLOCK_LEAVES = ("qvalues", "bsvalues")  # column-block serving formats (…, Nb, r, bk, bn)


def block_column_spec(values_shape: tuple[int, ...], plan: MeshPlan) -> Spec:
    """Spec of a column-block serving leaf (int8 ``qvalues`` / ``qscales`` /
    ``qindices``, the self drafter's ``bsvalues`` / ``bsindices``): its
    column blocks Nb (dim −4 of the values) over tp when they divide,
    replicated over dp.  Each device then holds whole output columns with
    every kept block of their K, so its kernels compute them as one device
    does."""
    nb_dim = len(values_shape) - 4
    tp = plan.tp_axis if values_shape[nb_dim] % plan.tp_size == 0 else None
    return (None,) * nb_dim + (tp,)


def shard_serve_params(params: Any, plan: MeshPlan) -> Any:
    """A serving tree laid out on the plan's mesh: column-block projection
    dicts by ``block_column_spec``, every other leaf by ``param_specs``
    (without its FSDP split when ``plan.serve_stationary``).  Unchanged
    without a mesh."""
    if plan.mesh is None:
        return params

    def walk(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            blocks = next((k for k in BLOCK_LEAVES if k in node), None)
            if blocks is not None:
                spec = block_column_spec(tuple(node[blocks].shape), plan)
                return {k: NamedSharding(plan.mesh, spec if k != "bias" else ())
                        .distribute(v) for k, v in node.items()}
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        name = prefix[:-1]
        return NamedSharding(plan.mesh, _leaf_spec(name, node, plan, plan.serve_stationary)
                             ).distribute(node)

    return walk(params, "")
