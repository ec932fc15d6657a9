"""RWKV6 "Finch" block: data-dependent per-channel decay, attention-free.
[arXiv:2404.05892]

The port of ``repro.models.rwkv6``.  Time-mix (per head, head size n):
    w_t = exp(-exp(w0 + tanh(x_w @ A1) @ A2))        data-dependent decay (LoRA)
    S_t[i,j] = w_t[i]·S_{t-1}[i,j] + k_t[i]·v_t[j]   state (n × n) per head
    y_t[j]   = Σ_i r_t[i]·(S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])
Channel-mix: squared-ReLU 2-layer MLP gated by sigmoid(r).

The WKV recurrence is a loop over time on an fp32 (B, H, n, n) state (the
reference's ``lax.scan``).  Token-shift states make prefill → decode
continuous.  As in the reference, the five token-shift lerps use static
learned μ vectors (the decay keeps its data-dependent LoRA), and there is
no per-block initial state.

Every product whose row count follows the batch keeps a row's bits at any
batch on the card: the projections and the decay LoRA's fp32 ``x_w @ A1 @
A2`` go through ``layers.dense_apply`` (its row floor), the out-norm through
``layers.norm_apply``, and the WKV contraction over i is an fp32 multiply
and a sum over a fixed axis, not a batched product whose kernel may follow
b·h.

Under a mesh (``plan`` with a mesh, x a DTensor) the WKV recurrence runs on
each device's own batch rows (and heads, where they divide the model axis)
as one operator, ``repro_torch::wkv_scan``, whose implementation is
``_wkv_scan`` and whose backward recomputes and differentiates it: a run on
fake tensors (the dry run) steps over the time loop in one call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, _normal, dense_apply, dense_init, norm_apply,
                                       grad_in_layout, recompute_grad, split_heads)


def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


def rwkv6_time_mix_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    d, r = cfg.d_model, cfg.rwkv_lora_decay
    dt = getattr(torch, cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    p = {"mu": _uniform(gen, (*lead, 5, d), device)}  # r, k, v, w, g lerps
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, d, d, dt, device, lead)
    p.update({
        "w0": torch.full((*lead, d), -3.0, **f32),  # ≈ slow decay at init
        "decay_lora_a": _normal(gen, (*lead, d, r), torch.float32, d**-0.5, device),
        "decay_lora_b": _normal(gen, (*lead, r, d), torch.float32, r**-0.5, device),
        "u": _normal(gen, (*lead, d), torch.float32, 0.5, device),
        "ln_x": {"scale": torch.ones((*lead, d), **f32),
                 "norm_bias": torch.zeros((*lead, d), **f32)},
    })
    return p


def rwkv6_channel_mix_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    return {
        "mu": _uniform(gen, (*lead, 2, d), device),  # k, r lerps
        "wk": dense_init(gen, d, f, dt, device, lead),
        "wv": dense_init(gen, f, d, dt, device, lead),
        "wr": dense_init(gen, d, d, dt, device, lead),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x (B, S, d) → x shifted right by one; position 0 gets ``prev`` (B, d)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _wkv_scan(
    r: torch.Tensor,  # (B, S, H, n)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, S, H, n) decays in (0, 1)
    u: torch.Tensor,  # (H, n)
    s0: torch.Tensor,  # (B, H, n, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (y (B, S, H, n) fp32, final state (B, H, n, n) fp32)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, n)
        kv = kt[..., :, None] * vt[..., None, :]  # (B, H, n, n)
        ys.append((rt[..., :, None] * (s + uf * kv)).sum(dim=-2))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


@torch.library.custom_op("repro_torch::wkv_scan", mutates_args=())
def wkv_scan_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _wkv_scan(r, k, v, w, u, s0)


@wkv_scan_op.register_fake
def _(r, k, v, w, u, s0):
    return r.new_empty(r.shape, dtype=torch.float32), s0.new_empty(s0.shape,
                                                                   dtype=torch.float32)


@torch.library.custom_op("repro_torch::wkv_scan_backward", mutates_args=())
def _wkv_scan_backward(gy: torch.Tensor, gs: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                       s0: torch.Tensor) -> list[torch.Tensor]:
    return list(recompute_grad(_wkv_scan, (r, k, v, w, u, s0), (gy, gs)))


@_wkv_scan_backward.register_fake
def _(gy, gs, r, k, v, w, u, s0):
    return [torch.empty_like(t) for t in (r, k, v, w, u, s0)]


def _wkv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _wkv_backward(ctx, gy, gs):
    return tuple(_wkv_scan_backward(gy, gs, *ctx.saved_tensors))


wkv_scan_op.register_autograd(_wkv_backward, setup_context=_wkv_setup)


def _wkv_meshed(plan, r, k, v, w, u, s0):
    """``_wkv_scan`` on each device's own batch rows and heads (the heads
    shard over the model axis where they divide it)."""
    hs = plan.tp if r.shape[2] % plan.tp_size == 0 else None
    seq4 = (plan.dp, None, hs, None)
    r, k, v, w = (plan.constrain(t, *seq4) for t in (r, k, v, w))
    st = (plan.dp, hs, None, None)
    return plan.local(wkv_scan_op, [seq4, st], r, k, v, w, plan.shard(u, hs, None),
                      plan.shard(s0, *st))


def rwkv6_time_mix_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    state: dict | None = None,
    plan=None,
) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    h, n = cfg.rwkv_heads, cfg.rwkv_head_size
    xs = _token_shift(x, state["shift_t"] if state else None)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))

    r = split_heads(dense_apply(p["wr"], xr), h, n)
    k = split_heads(dense_apply(p["wk"], xk), h, n)
    v = split_heads(dense_apply(p["wv"], xv), h, n)
    g = F.silu(dense_apply(p["wg"], xg))

    # data-dependent decay (the Finch contribution), in fp32
    dd = dense_apply({"kernel": p["decay_lora_b"]},
                     torch.tanh(dense_apply({"kernel": p["decay_lora_a"]}, xw.float())))
    w = split_heads(torch.exp(-torch.exp(p["w0"] + dd)), h, n)  # in (0, 1)

    s0 = (state["wkv"] if state else
          torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device))
    if plan is not None and plan.mesh is not None and isinstance(x, DTensor):
        y, s_fin = _wkv_meshed(plan, r, k, v, w, p["u"].reshape(h, n), s0)
    else:
        y, s_fin = _wkv_scan(r, k, v, w, p["u"].reshape(h, n), s0)
    y = norm_apply(p["ln_x"], grad_in_layout(y.reshape(b, s, d))).to(x.dtype) * g
    return dense_apply(p["wo"], y), {"shift_t": x[:, -1, :], "wkv": s_fin}


def rwkv6_channel_mix_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    xs = _token_shift(x, state["shift_c"] if state else None)
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    kk = torch.square(F.relu(dense_apply(p["wk"], xk)))
    out = torch.sigmoid(dense_apply(p["wr"], xr)) * dense_apply(p["wv"], kk)
    return out, {"shift_c": x[:, -1, :]}


def rwkv6_init_state(cfg: ModelConfig, batch: int, device, dtype=torch.float32) -> dict:
    h, n = cfg.rwkv_heads, cfg.rwkv_head_size
    return {
        "shift_t": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
        "shift_c": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }
