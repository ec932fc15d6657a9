"""Workload extraction: model graph → per-layer vector-op counts.

The port of ``repro.photonic.mapper``.  A ``LayerWork`` is what the
accelerator models price: how many vector dot products of what length a
layer needs after SONIC's compression (§III.C), plus the sparsity
statistics that drive VDU power gating.

* ``cnn_workload``: the paper's four CNNs: conv layers im2col-unrolled
  (dense kernel vectors, residual IF-map sparsity), FC layers
  column-compressed by activation sparsity (dense activations, residual
  weight sparsity).
* ``lm_workload``: beyond the paper: one decode / forward step's linear
  layers of a transformer LM on the same hardware models.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as cnn_lib


@dataclasses.dataclass(frozen=True)
class LayerWork:
    name: str
    kind: str  # "conv" | "fc"
    vec_len: int  # dot-product length AFTER compression (dense operand)
    n_products: int  # number of such dot products per frame
    weight_sparsity: float  # residual sparsity in the vectors fed to VDUs
    act_sparsity: float  # activation sparsity (drives FC compression)
    reuse: int = 1  # passes sharing one MR-bank weight program
    #   conv: the kernel chunk stays resident while every output pixel's patch
    #   streams through the VCSELs (weight-stationary) → reuse = out_pixels.
    #   fc: each pass needs fresh weight rows → reuse = 1.
    weight_bits: int = 6  # post-clustering resolution
    act_bits: int = 16

    @property
    def macs(self) -> int:
        """Post-compression MACs per frame (zeros still in-vector count —
        they are gated at the VDU, which saves power, not passes)."""
        return self.vec_len * self.n_products

    @property
    def dense_macs_equiv(self) -> int:
        """MACs a dense accelerator would execute for this layer."""
        if self.kind == "fc":
            eff = self.vec_len / max(1.0 - self.act_sparsity, 1e-6)
        else:
            eff = self.vec_len / max(1.0 - self.weight_sparsity_pre, 1e-6)
        return int(eff) * self.n_products

    @property
    def weight_sparsity_pre(self) -> float:
        # conv vectors were compressed by weight sparsity; fc by activations
        return self.weight_sparsity if self.kind == "conv" else 0.0

    @property
    def task_bits(self) -> int:
        """Platform-neutral task size: dense-equivalent MACs × 32 operand
        bits — the shared EPB denominator across all accelerator models."""
        return self.dense_macs_equiv * 32


def _act_sparsity(acts: Sequence[torch.Tensor]) -> list[float]:
    return [(a == 0).sum().item() / a.numel() for a in acts]


def cnn_workload(
    cfg: cnn_lib.CNNConfig,
    params,
    weight_sparsity: dict[str, float] | None = None,
    sample: torch.Tensor | None = None,
) -> list[LayerWork]:
    """The per-frame workload of one paper CNN.

    ``weight_sparsity`` maps a layer name (conv0.., fc0..) to its pruned
    fraction.  ``sample`` (B, H, W, C) measures the activation sparsity; by
    default a uniform [0, 1) batch of 4 from a generator seeded with 0 on
    the params' device (ReLU ⇒ ≈ 50%; real data gives more, Fig. 7 shows
    60–90%).  The reference draws its default from a JAX key: other
    numbers, so the two agree on a sample handed to both."""
    weight_sparsity = weight_sparsity or {}
    if sample is None:
        dev = params["conv"][0]["kernel"].device
        gen = torch.Generator(device=dev).manual_seed(0)
        sample = torch.rand((4, *cfg.input_hw), generator=gen, device=dev)
    _, acts = cnn_lib.forward(params, cfg, sample, return_activations=True)
    act_sp = _act_sparsity(acts)

    work: list[LayerWork] = []
    h, w, c_in = cfg.input_hw
    a_idx = 0
    for i, c_out in enumerate(cfg.conv_channels):
        ws = weight_sparsity.get(f"conv{i}", 0.0)
        # §III.C: kernels unrolled; zero kernel rows dropped → dense kernel
        # vectors of length (1-ws)·9·c_in; IF-map sparsity stays in-vector.
        klen = max(int(round((1.0 - ws) * 9 * c_in)), 1)
        in_sp = 0.0 if i == 0 else act_sp[a_idx - 1]
        work.append(
            LayerWork(
                name=f"conv{i}", kind="conv", vec_len=klen,
                n_products=h * w * c_out,
                weight_sparsity=ws, act_sparsity=in_sp,
                reuse=h * w,  # weight-stationary over output pixels
            )
        )
        a_idx += 1
        if i in cfg.pool_after:
            h, w = h // 2, w // 2
        c_in = c_out
    d = h * w * c_in
    fc_dims = (*cfg.fc_dims, cfg.n_classes)
    for j, d_out in enumerate(fc_dims):
        ws = weight_sparsity.get(f"fc{j}", 0.0)
        in_sp = act_sp[a_idx - 1] if a_idx - 1 < len(act_sp) else 0.5
        # §III.C: zero activations drop weight COLUMNS → dense activation
        # vectors of length (1-in_sp)·d; residual weight sparsity ws in-vector.
        vlen = max(int(round((1.0 - in_sp) * d)), 1)
        work.append(
            LayerWork(
                name=f"fc{j}", kind="fc", vec_len=vlen, n_products=d_out,
                weight_sparsity=ws, act_sparsity=in_sp,
            )
        )
        if j < len(fc_dims) - 1:
            a_idx += 1
        d = d_out
    return work


def lm_workload(
    cfg: ModelConfig,
    weight_sparsity: float = 0.0,
    act_sparsity: float = 0.0,
    seq_len: int = 1,
) -> list[LayerWork]:
    """Beyond the paper: price an LM decode / forward step's linear layers
    (an MoE layer at its k active experts, the SwiGLU or gelu MLP).

    Every config is priced as the reference prices it, with the
    transformer's layout: q / k / v / o and the FFN, per layer.  That
    holds for the hybrid (zamba2) and rwkv configs too, whose real layers
    are Mamba2 blocks and time-mix / channel-mix (a deliberate reference
    behaviour the port keeps: the two packages give the same numbers)."""
    d, h, kh, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = [
        ("wq", d, h * dh), ("wk", d, kh * dh), ("wv", d, kh * dh), ("wo", h * dh, d),
    ]
    if cfg.n_experts:
        k = cfg.experts_per_token
        per_layer += [("moe_wi", d, k * f), ("moe_wg", d, k * f), ("moe_wo", k * f, d)]
    elif cfg.ffn == "swiglu":
        per_layer += [("wi", d, f), ("wg", d, f), ("wo_ffn", f, d)]
    else:
        per_layer += [("wi", d, f), ("wo_ffn", f, d)]
    work = []
    for name, d_in, d_out in per_layer:
        vlen = max(int(round((1.0 - act_sparsity) * d_in)), 1)
        work.append(
            LayerWork(
                name=name, kind="fc", vec_len=vlen,
                n_products=d_out * seq_len * cfg.n_layers,
                weight_sparsity=weight_sparsity, act_sparsity=act_sparsity,
            )
        )
    work.append(
        LayerWork(
            name="lm_head", kind="fc",
            vec_len=max(int(round((1.0 - act_sparsity) * d)), 1),
            n_products=cfg.vocab_size * seq_len,
            weight_sparsity=weight_sparsity, act_sparsity=act_sparsity,
        )
    )
    return work
