"""Token-choice top-k MoE.

The port of ``repro.models.moe`` for one device: the router with its
layout-deterministic selection (``_selection_logits``), capacity-bounded
dispatch with the reference's drop semantics, the batched expert FFN and
the combine, and the all-experts oracle ``moe_apply_dense``.

Dispatch, as in the reference: per batch row, token → expert assignments
in expert-major, token-minor order fill an (E, C) slot buffer, C =
ceil(S·k/E · capacity_factor); an assignment past its expert's capacity
is dropped (Switch / GShard), an empty slot computes on zeros and is never
read back.  Every shape here is fixed by (B, S, E, k, C), so a forward can
be captured in a CUDA graph: an assignment's slot is the number of earlier
assignments to its expert (a cumulative sum of one-hot rows, in place of
the reference's stable argsort and bincount), and the buffer is filled by
one scatter whose kept targets are distinct (dropped ones land in an
overflow column that is cut off).  The combine sums each token's k slot
outputs in ascending expert order, one add at a time in x's type, where
the reference scatter-adds the slots (``segment_sum``) in the same
expert-major order: no atomics, so two runs give the same bits.

``moe_load_balance_loss`` is the reference's auxiliary loss on the same
selection.

Under a mesh (``plan`` with a mesh, x a DTensor) ``moe_apply`` takes the
reference's two regimes:
  * EP (n_experts % tp == 0, e.g. moonshot 64e/16): experts sharded over
    the model axis; the dp-major → model-major transpose of the slot buffer
    is the expert all-to-all.
  * TP-experts (otherwise, e.g. grok-1 8e/16): the expert weights keep
    their (E, d, f) layout with d_ff tp-sharded (``partition``'s switch),
    tokens replicate over model, partial outputs sum.
Routing and dispatch run per batch row on each device's own rows, and the
combine on each device's own experts (``plan.local``, the reference's
vmapped per-row sort); the combine's per-expert partial sums meet in one
reduction over the model axis, as the reference's ``segment_sum`` does.
``expert_split_factor``, ``_virtualize`` and ``_split_weights`` are the
reference's exact d_ff split of an expert into virtual experts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, _normal, _row_floor, gelu
from repro_torch.utils.rows import at_least_rows


def _normal_stack(gen, shape, dtype, scale: float, device) -> torch.Tensor:
    """``layers._normal`` of ``shape``, drawn one leading slice at a time
    (an expert stack at full width would need its whole size again in
    fp32 at once)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        for i in range(shape[0]):
            out[i] = _normal(gen, shape[1:], dtype, scale, device)
    return out


def expert_split_factor(cfg: ModelConfig, tp: int) -> int:
    e = cfg.n_experts
    if e % tp == 0:
        return 1
    # smallest split s.t. E·split % tp == 0 and d_ff % split == 0
    for s in range(2, tp + 1):
        if (e * s) % tp == 0 and cfg.d_ff % s == 0:
            return s
    return 1


def moe_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": {"kernel": _normal(gen, (*lead, d, e), torch.float32, d**-0.5, device)},
        "wi": _normal_stack(gen, (*lead, e, d, f), dt, d**-0.5, device),
        "wo": _normal_stack(gen, (*lead, e, f, d), dt, f**-0.5, device),
    }
    if cfg.ffn == "swiglu":
        p["wg"] = _normal_stack(gen, (*lead, e, d, f), dt, d**-0.5, device)
    return p


# Deterministic routing (the reference's): the SELECTION copy of the fp32
# router logits is snapped to a _ROUTER_QUANTUM grid, and exact grid ties
# are broken by a strictly decreasing epsilon·expert_id bias (sub-quantum,
# so it never reorders distinct grid values).  Gates come from the softmax
# of the unquantized logits.
_ROUTER_QUANTUM = 1e-3
_TIEBREAK_EPS = 1e-6


def _selection_logits(logits: torch.Tensor) -> torch.Tensor:
    """fp32 logits (…, E) → the layout-deterministic selection copy.  The
    quantum divides as a tensor on the logits' device (filled there, so a
    CUDA graph can capture it), so the card divides as the reference does
    (a Python scalar would be a multiply by its reciprocal there)."""
    e = logits.shape[-1]
    quantum = torch.full((), _ROUTER_QUANTUM, dtype=torch.float32, device=logits.device)
    snapped = torch.round(logits / quantum) * _ROUTER_QUANTUM
    ids = torch.arange(e, dtype=torch.float32, device=logits.device)
    return snapped - _TIEBREAK_EPS * ids


def _router(p: Params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (gates (B, S, k) fp32, experts (B, S, k) int64).

    Softmax-then-top-k with gate renormalization; the router's product in
    fp32 (its rows padded to the row floor, as ``layers.dense_apply``'s);
    the experts chosen on the selection logits, the gates read from the
    smooth probabilities."""
    w = p["router"]["kernel"].float()
    xf = x.float()
    logits = at_least_rows(lambda xx: xx @ w, xf.reshape(-1, xf.shape[-1]), _row_floor(x))
    logits = logits.reshape(*x.shape[:-1], w.shape[-1])
    experts = torch.topk(_selection_logits(logits), cfg.experts_per_token, dim=-1).indices
    probs = torch.softmax(logits, dim=-1)
    gates = torch.gather(probs, -1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts


def _virtualize(gates: torch.Tensor, experts: torch.Tensor,
                split: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand (…, k) real routing to (…, k·split) virtual routing."""
    if split == 1:
        return gates, experts
    v_experts = experts[..., None] * split + torch.arange(split, device=experts.device)
    v_gates = gates[..., None].expand(v_experts.shape)
    return (v_gates.reshape(*gates.shape[:-1], -1),
            v_experts.reshape(*experts.shape[:-1], -1).to(torch.int32))


def _split_weights(p: Params, split: int) -> Params:
    """(E, d, f) → (E·split, d, f/split); exact SwiGLU/MLP decomposition."""
    if split == 1:
        return p
    out = {"router": p["router"]}
    for name in ("wi", "wg"):
        if name in p:
            e, d, f = p[name].shape
            out[name] = (p[name].reshape(e, d, split, f // split).permute(0, 2, 1, 3)
                         .reshape(e * split, d, f // split))
    e, f, d = p["wo"].shape
    out["wo"] = p["wo"].reshape(e, split, f // split, d).reshape(e * split, f // split, d)
    return out


def _expert_ffn(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h (E, T, d) → (E, T, d), the batched per-expert FFN in h's type."""
    dt = h.dtype
    hi = torch.bmm(h, p["wi"].to(dt))
    if "wg" in p:
        hi = F.silu(hi) * torch.bmm(h, p["wg"].to(dt))
    else:
        hi = gelu(hi)
    return torch.bmm(hi, p["wo"].to(dt))


def capacity(cfg: ModelConfig, s: int, capacity_factor: float | None = None) -> int:
    """Slots per expert and batch row: ceil(S·k/E · cf), at least 1."""
    cf = capacity_factor or cfg.moe_capacity_factor
    return max(int(math.ceil(s * cfg.experts_per_token / cfg.n_experts * cf)), 1)


def _slots(experts: torch.Tensor, e: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """experts (B, T, k) → (slot (B, T, k), kept (B, T, k) bool): each
    assignment's place in its expert's buffer, the number of assignments
    before it (in token-major, choice-minor order) to the same expert, as
    the reference's stable sort orders them; kept iff below capacity."""
    b, t, k = experts.shape
    flat = experts.reshape(b, t * k)
    onehot = F.one_hot(flat, e).to(torch.int32)  # (B, T·k, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(before, 2, flat[..., None])[..., 0].reshape(b, t, k)
    return slot, slot < capacity


def _dispatch_indices(experts: torch.Tensor, gates: torch.Tensor, e: int,
                      capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Token → expert assignments → expert-major buffers, for every batch
    row at once (the reference's, vmapped over rows).

    experts / gates: (B, T, k).  Returns
      idx_buf  (B, E, C) int64   — token id filling each expert slot, -1 empty
      gate_buf (B, E, C) float32 — combine weight of that slot (0 if empty)
    Kept slots are unique per (expert, place); assignments past capacity
    go to an overflow column C, which is cut off."""
    return _buffers(experts, gates, *_slots(experts, e, capacity), e, capacity)


def _buffers(experts, gates, slot, kept, e: int, capacity: int):
    """``_dispatch_indices`` from the assignments' slots (``_slots``)."""
    b, t, k = experts.shape
    col = torch.where(kept, slot, capacity)
    target = (experts * (capacity + 1) + col).reshape(b, t * k)
    token = (torch.arange(t * k, device=experts.device) // k).expand(b, t * k)
    idx_buf = torch.full((b, e * (capacity + 1)), -1, dtype=torch.long, device=experts.device)
    idx_buf.scatter_(1, target, torch.where(kept.reshape(b, t * k), token, -1))
    gate_buf = torch.zeros((b, e * (capacity + 1)), dtype=torch.float32,
                           device=experts.device)
    gate_buf.scatter_(1, target, torch.where(kept, gates.float(), 0.0).reshape(b, t * k))
    return (idx_buf.view(b, e, capacity + 1)[..., :capacity],
            gate_buf.view(b, e, capacity + 1)[..., :capacity])


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float | None = None, plan=None) -> torch.Tensor:
    """Sparse MoE forward, x (B, S, d) → (B, S, d): the reference's, on one
    device or (``plan``) sharded."""
    if plan is not None and plan.mesh is not None and isinstance(x, DTensor):
        return _moe_apply_meshed(p, cfg, x, plan, capacity_factor)
    b, s, d = x.shape
    e = cfg.n_experts
    cap = capacity(cfg, s, capacity_factor)
    gates, experts = _router(p, cfg, x)  # (B, S, k)
    slot, kept = _slots(experts, e, cap)
    idx_buf, gate_buf = _buffers(experts, gates, slot, kept, e, cap)

    idx_safe = torch.clamp(idx_buf, min=0).reshape(b, e * cap)
    buf = torch.gather(x, 1, idx_safe[..., None].expand(b, e * cap, d)).reshape(b, e, cap, d)
    buf = torch.where((idx_buf >= 0)[..., None], buf, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
    buf = buf.transpose(0, 1).reshape(e, b * cap, d)
    out_buf = _expert_ffn(p, cfg, buf)  # (E, B·C, d)
    out_buf = out_buf.reshape(e, b, cap, d).transpose(0, 1)  # (B, E, C, d)
    weighted = (out_buf * gate_buf[..., None].to(out_buf.dtype)).reshape(b, e * cap, d)

    # combine: each token's kept slots, in ascending expert order
    order = torch.argsort(experts, dim=-1)
    experts, slot, kept = (torch.gather(a, -1, order) for a in (experts, slot, kept))
    where = (experts * cap + torch.clamp(slot, max=cap - 1)).reshape(b, -1)
    picked = torch.gather(weighted, 1, where[..., None].expand(-1, -1, d))
    picked = picked.reshape(b, s, cfg.experts_per_token, d)
    out = torch.zeros_like(x)
    for j in range(cfg.experts_per_token):
        out = torch.where(kept[..., j, None], out + picked[:, :, j], out)
    return out


def _route_rows(cfg: ModelConfig, e: int, cap: int, x: torch.Tensor, router: torch.Tensor):
    """Routing and dispatch of some batch rows: the slot buffer (B, E, C, d)
    of their tokens, its gates, and each assignment's expert, slot and
    keep flag (``moe_apply``'s first half)."""
    b, _, d = x.shape
    gates, experts = _router({"router": {"kernel": router}}, cfg, x)
    slot, kept = _slots(experts, e, cap)
    idx_buf, gate_buf = _buffers(experts, gates, slot, kept, e, cap)
    idx_safe = torch.clamp(idx_buf, min=0).reshape(b, e * cap)
    buf = torch.gather(x, 1, idx_safe[..., None].expand(b, e * cap, d)).reshape(b, e, cap, d)
    buf = torch.where((idx_buf >= 0)[..., None], buf, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
    return buf, gate_buf, experts, slot, kept


def _combine_rows(k: int, cap: int, e0: int, out_buf, gate_buf, experts, slot, kept):
    """Each token's kept slot outputs among experts e0 … e0 + E_local − 1
    (the device's own), summed in ascending expert order."""
    b, el, _, d = out_buf.shape
    s = experts.shape[1]
    weighted = (out_buf * gate_buf[..., None].to(out_buf.dtype)).reshape(b, el * cap, d)
    order = torch.argsort(experts, dim=-1)
    experts, slot, kept = (torch.gather(a, -1, order) for a in (experts, slot, kept))
    mine = kept & (experts >= e0) & (experts < e0 + el)
    where = (torch.clamp(experts - e0, 0, el - 1) * cap + torch.clamp(slot, max=cap - 1))
    picked = torch.gather(weighted, 1, where.reshape(b, -1)[..., None].expand(-1, -1, d))
    picked = picked.reshape(b, s, k, d)
    out = torch.zeros((b, s, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        out = torch.where(mine[..., j, None], out + picked[:, :, j], out)
    return out


def _gathered_over_dp(w: torch.Tensor, plan) -> torch.Tensor:
    """w (a DTensor) replicated over the plan's dp axes, its other splits
    kept."""
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] in plan.dp_axes else q
               for i, q in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def _moe_apply_meshed(p: Params, cfg: ModelConfig, x: torch.Tensor, plan,
                      capacity_factor: float | None) -> torch.Tensor:
    """``moe_apply`` on DTensors (see the module doc)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    ep = e % plan.tp_size == 0
    cap = capacity(cfg, s, capacity_factor)
    dp = plan.dp
    row3 = (dp, None, None)
    # tokens replicated over the model axis inside the MoE block (AG from
    # SP) BEFORE the router contraction: every shard routes over the same
    # full d axis
    x = plan.constrain(x, *row3)
    router = plan.shard(p["router"]["kernel"], None, None)
    buf, gate_buf, experts, slot, kept = plan.local(
        lambda xl, wl: _route_rows(cfg, e, cap, xl, wl),
        [(dp, None, None, None), row3, row3, row3, row3], x, router)
    e_spec = plan.tp if ep else None
    buf = plan.constrain(buf, dp, e_spec, None, None)
    # dp-major → model-major on experts: the expert all-to-all (EP only)
    buf = plan.local(lambda t: t.transpose(0, 1).reshape(t.shape[1], -1, d),
                     (e_spec, dp, None), buf)
    # the expert weights gathered over the dp axes first (FSDP): the
    # batched products then meet no split of their contraction or expert
    # dims over dp, and each weight's gradient leaves the backward reduced
    # into its own layout, not into one DTensor picked for the product
    # (which on (pod, data) split the experts over pod, and regathered all
    # of d_model to lay the gradient out again)
    pw = {n: _gathered_over_dp(w, plan) for n, w in p.items() if n in ("wi", "wg", "wo")}
    out_buf = _expert_ffn(pw, cfg, buf)  # (E, B·C, d); TP: partial over model
    out_buf = plan.constrain(out_buf, e_spec, dp, None)
    # back to dp-major token dim, experts KEPT tp-sharded under EP
    out_buf = plan.local(lambda t: t.reshape(t.shape[0], -1, cap, d).transpose(0, 1),
                         (dp, e_spec, None, None), out_buf)
    gate_buf = plan.constrain(gate_buf, dp, e_spec, None)
    e0 = plan.mesh.get_local_rank(plan.tp_axis) * (e // plan.tp_size) if ep else 0
    out = plan.local(lambda *a: _combine_rows(k, cap, e0, *a), row3, out_buf, gate_buf,
                     experts, slot, kept, partial=plan.tp_axis if ep else None)
    return plan.constrain(out, dp, plan.tp if s > 1 else None, None)


def moe_apply_dense(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, gate-combined (O(E/k) work)."""
    b, s, d = x.shape
    gates, experts = _router(p, cfg, x)
    xt = x.reshape(1, b * s, d).expand(cfg.n_experts, b * s, d)
    outs = _expert_ffn(p, cfg, xt).reshape(cfg.n_experts, b, s, d)
    onehot = F.one_hot(experts, cfg.n_experts).to(x.dtype)  # (B, S, k, E)
    w = (onehot * gates[..., None].to(x.dtype)).sum(2)  # (B, S, E)
    return torch.einsum("ebsd,bse->bsd", outs, w)


def moe_load_balance_loss(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss, E · Σ_e (fraction of
    assignments to e) · (mean router probability of e), for x (B, S, d);
    the experts counted are the router's deterministic selection."""
    logits = x.float() @ p["router"]["kernel"]
    probs = torch.softmax(logits, dim=-1)
    experts = torch.topk(_selection_logits(logits), cfg.experts_per_token, dim=-1).indices
    frac = F.one_hot(experts, cfg.n_experts).float().mean((0, 1, 2))
    return cfg.n_experts * (frac * probs.mean((0, 1))).sum()
