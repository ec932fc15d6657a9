"""Mamba2 / SSD block (zamba2 backbone).  [arXiv:2405.21060]

The port of ``repro.models.mamba2``.  Chunked SSD formulation: within a
chunk the recurrence is evaluated as two products; across chunks a loop
carries the (H, N, P) state.  Decode is the exact one-step recurrence.

Per head h with decay a_t = exp(dt_t · A_h) (A_h < 0):
    state_t = a_t · state_{t-1} + dt_t · B_t ⊗ x_t        (N × P outer product)
    y_t     = C_t · state_t + D_h · x_t

``in_proj`` / ``out_proj`` go through ``layers.dense_apply`` (the
reference writes a bare ``@``), so they get its row floor on the card.
The decode step's contraction over N is an fp32 multiply and a sum over a
fixed axis, not a batched product: a batched GEMM's kernel may follow the
batch (b·h), and a row of a decode step of B slots must keep the bits it
has at B = 1.

Under a mesh (``plan`` with a mesh, the input a DTensor) the projections
are DTensor products and everything between them (the conv, the scan, the
gate and norm) runs on each device's own batch rows (``plan.local``), the
in_proj output gathered over the model axis first: its z / x / B / C / dt
columns do not split into whole heads per device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, _normal, dense_apply, norm_apply


def mamba2_dims(cfg: ModelConfig) -> dict[str, int]:
    d_in = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = d_in + 2 * g * n
    proj_dim = 2 * d_in + 2 * g * n + h  # z, x, B, C, dt
    return dict(d_in=d_in, g=g, n=n, h=h, p=cfg.ssm_head_dim,
                conv_dim=conv_dim, proj_dim=proj_dim)


def mamba2_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    dm = mamba2_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, dm["h"], **f32))
    return {
        "in_proj": {"kernel": _normal(gen, (*lead, cfg.d_model, dm["proj_dim"]), dt,
                                      cfg.d_model**-0.5, device)},
        "conv_w": _normal(gen, (*lead, cfg.ssm_conv_width, dm["conv_dim"]), dt, 0.3, device),
        "conv_b": torch.zeros((*lead, dm["conv_dim"]), dtype=dt, device=device),
        "A_log": a_log.expand(*lead, dm["h"]).clone(),
        "D": torch.ones((*lead, dm["h"]), **f32),
        "dt_bias": torch.zeros((*lead, dm["h"]), **f32),
        "out_norm": {"scale": torch.ones((*lead, dm["d_in"]), **f32)},
        "out_proj": {"kernel": _normal(gen, (*lead, dm["d_in"], cfg.d_model), dt,
                                       dm["d_in"]**-0.5, device)},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  x (B, S, C), w (W, C).

    Returns (out (B, S, C), new_state (B, W-1, C)): the state carries the
    last W-1 inputs for decode continuity."""
    bsz, s, c = x.shape
    width = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, width - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+W-1, C)
    out = torch.zeros_like(x)
    for i in range(width):  # width is tiny (4): unrolled taps
        out = out + xp[:, i:i + s, :] * w[i].to(x.dtype)
    out = F.silu(out + b.to(x.dtype))
    new_state = xp[:, s:, :] if width > 1 else state
    return out, new_state


def _pad_time(t: torch.Tensor, pad: int) -> torch.Tensor:
    """t (B, S, …) with ``pad`` zero steps appended on axis 1."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _ssd_chunked(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32, post-softplus
    A: torch.Tensor,   # (H,) fp32, negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    h0: torch.Tensor | None,  # (B, H, N, P) carried state or None
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B, S, H, P), h_final (B, H, N, P))."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:  # dt = 0 padding is state-neutral: decay 1, update 0
        x, dt, Bm, Cm = (_pad_time(t, pad) for t in (x, dt, Bm, Cm))
    s_pad = s + pad
    nc = s_pad // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, g, n).float()
    Cc = Cm.reshape(b, nc, chunk, g, n).float()

    la = dtc * A  # (B, nc, L, H) negative log-decays
    cum = torch.cumsum(la, dim=2)  # inclusive within a chunk

    # intra-chunk: y_i += Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j
    scores = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)
    scores = torch.repeat_interleave(scores, rep, dim=2)  # (B, nc, H, L, L)
    ci = cum.permute(0, 1, 3, 2)  # (B, nc, H, L)
    dmat = ci[..., :, None] - ci[..., None, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # mask the EXPONENT, not exp's output: dmat > 0 above the diagonal
    # would overflow exp
    m = torch.exp(torch.where(mask, dmat, -math.inf)) * scores
    xdt = xc.float() * dtc[..., None]  # (B, nc, L, H, P)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", m, xdt)

    # chunk summaries: S_c = Σ_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    wj = torch.exp(ci[..., -1:] - ci)  # (B, nc, H, L)
    Brep = torch.repeat_interleave(Bc, rep, dim=3)  # (B, nc, L, H, N)
    s_chunk = torch.einsum("bchl,bclhn,bclhp->bchnp", wj, Brep, xdt)
    chunk_decay = torch.exp(ci[..., -1])  # (B, nc, H): each chunk's total decay

    hprev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device) if h0 is None
             else h0.float())
    prevs = []  # the state entering each chunk
    for c in range(nc):
        prevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(prevs, dim=1)  # (B, nc, H, N, P)

    # inter-chunk: y_i += exp(cum_i) C_i · h_prev
    Crep = torch.repeat_interleave(Cc, rep, dim=3)  # (B, nc, L, H, N)
    y_inter = torch.einsum("bclhn,bchnp,bchl->bclhp", Crep, h_prevs, torch.exp(ci))
    y = (y_intra + y_inter).reshape(b, s_pad, h, p)[:, :s]
    return y.to(x.dtype), hprev


def _ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact one-step recurrence.  x (B, H, P), dt (B, H) fp32, Bm / Cm
    (B, G, N), h0 (B, H, N, P) fp32 → (y (B, H, P) fp32, new state).  The
    sum over N runs over a fixed axis of an fp32 product (see the module
    docstring)."""
    rep = x.shape[1] // Bm.shape[1]
    a = torch.exp(dt * A)  # (B, H)
    Brep = torch.repeat_interleave(Bm, rep, dim=1).float()  # (B, H, N)
    upd = dt[..., None, None] * Brep[..., :, None] * x.float()[..., None, :]
    hnew = h0 * a[..., None, None] + upd
    Crep = torch.repeat_interleave(Cm, rep, dim=1).float()
    y = (Crep[..., :, None] * hnew).sum(dim=-2)
    return y, hnew


def mamba2_apply(
    p: Params,
    cfg: ModelConfig,
    xin: torch.Tensor,  # (B, S, d_model)
    state: dict[str, torch.Tensor] | None = None,
    plan=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full Mamba2 block (no outer norm / residual) → (out, new_state).

    state = {"conv": (B, W-1, conv_dim), "ssm": (B, H, N, P)}; None starts
    from zeros.  The new state is returned as new tensors, as the
    reference returns it (the model writes it into its cache)."""
    proj = dense_apply(p["in_proj"], xin)
    core = {k: p[k] for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D")}
    core["out_norm"] = p["out_norm"]["scale"]
    if plan is not None and plan.mesh is not None and isinstance(proj, DTensor):
        dp = plan.dp
        proj = plan.constrain(proj, dp, None, None)
        names = sorted(core)
        tensors = [plan.shard(core[k], *([None] * core[k].dim())) for k in names]
        conv = ssm = None
        if state is not None:
            conv = plan.shard(state["conv"], dp, None, None)
            ssm = plan.shard(state["ssm"], dp, None, None, None)

        def run(pr, cs, ss, *ts):
            st = None if cs is None else {"conv": cs, "ssm": ss}
            y, new = _mamba2_core(dict(zip(names, ts)), cfg, pr, st)
            return y, new["conv"], new["ssm"]

        y, new_conv, new_ssm = plan.local(
            run, [(dp, None, None), (dp, None, None), (dp, None, None, None)],
            proj, conv, ssm, *tensors)
        new = {"conv": new_conv, "ssm": new_ssm}
    else:
        y, new = _mamba2_core(core, cfg, proj, state)
    return dense_apply(p["out_proj"], y), new


def _mamba2_core(p: Params, cfg: ModelConfig, proj: torch.Tensor,
                 state: dict[str, torch.Tensor] | None):
    """The block between its projections: proj (B, S, proj_dim) → (y (B, S,
    d_inner) gated and normed, new state); ``p["out_norm"]`` is the norm's
    scale."""
    dm = mamba2_dims(cfg)
    b, s, _ = proj.shape
    z, xbc, dt_raw = torch.split(proj, [dm["d_in"], dm["conv_dim"], dm["h"]], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"] if state else None)
    x, Bm, Cm = torch.split(xbc, [dm["d_in"], dm["g"] * dm["n"], dm["g"] * dm["n"]], dim=-1)
    x = x.reshape(b, s, dm["h"], dm["p"])
    Bm = Bm.reshape(b, s, dm["g"], dm["n"])
    Cm = Cm.reshape(b, s, dm["g"], dm["n"])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)

    h0 = state["ssm"] if state else None
    if s == 1 and state is not None:  # exact single-step decode
        y, h_final = _ssd_step(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0.float())
        y = y[:, None].to(x.dtype)  # (B, 1, H, P)
    else:
        y, h_final = _ssd_chunked(x, dt, A, Bm, Cm, h0, cfg.ssm_chunk)

    y = y + x * p["D"][:, None].to(x.dtype)
    y = y.reshape(b, s, dm["d_in"])
    y = norm_apply({"scale": p["out_norm"]}, y * F.silu(z))
    return y, {"conv": new_conv, "ssm": h_final}


def mamba2_init_state(cfg: ModelConfig, batch: int, device, dtype=torch.float32) -> dict:
    dm = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, dm["conv_dim"]), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, dm["h"], dm["n"], dm["p"]), dtype=torch.float32,
                           device=device),
    }
