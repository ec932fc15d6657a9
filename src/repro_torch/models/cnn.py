"""The paper's four custom CNNs (Table 1): MNIST, CIFAR10, STL10, SVHN.

The port of ``repro.models.cnn``.  The paper gives layer counts and total
parameters but not the layer dims; the channel and hidden sizes below are
the reference's, chosen to land close to Table 1's parameter counts.  Every
conv is 3×3 SAME with ReLU, and the stages named in ``pool_after`` end in a
2×2 VALID max-pool (ReLU is what makes the activation sparsity SONIC's
dataflow compression exploits).

The public layouts are the reference's: inputs and activations NHWC, conv
kernels HWIO (3, 3, C_in, C_out), FC kernels (d_in, d_out) over the
NHWC-flattened features.  The convolutions run through
``torch.nn.functional.conv2d`` (the reference leaves them to XLA's conv, no
Pallas kernel) in NCHW inside ``forward``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: tuple[int, int, int]  # (H, W, C)
    conv_channels: Sequence[int]  # one conv layer per entry
    pool_after: Sequence[int]  # conv indices followed by 2×2 maxpool
    fc_dims: Sequence[int]  # hidden FC dims; final = n_classes appended
    n_classes: int = 10
    paper_params: int = 0
    paper_accuracy: float = 0.0


# Table 1 rows (paper_params / paper_accuracy are the paper's numbers)
MNIST_CNN = CNNConfig(
    name="mnist", input_hw=(28, 28, 1),
    conv_channels=(32, 64), pool_after=(0, 1), fc_dims=(456,),
    paper_params=1_498_730, paper_accuracy=0.932,
)
CIFAR10_CNN = CNNConfig(
    name="cifar10", input_hw=(32, 32, 3),
    conv_channels=(32, 48, 64, 96, 128, 192), pool_after=(1, 3, 5), fc_dims=(),
    paper_params=552_874, paper_accuracy=0.8605,
)
STL10_CNN = CNNConfig(
    name="stl10", input_hw=(96, 96, 3),
    conv_channels=(64, 64, 128, 128, 256, 256), pool_after=(1, 3), fc_dims=(512,),
    paper_params=77_787_738, paper_accuracy=0.746,
)
SVHN_CNN = CNNConfig(
    name="svhn", input_hw=(32, 32, 3),
    conv_channels=(32, 48, 64, 96), pool_after=(1, 3), fc_dims=(96, 64),
    paper_params=552_362, paper_accuracy=0.946,
)

PAPER_CNNS = {c.name: c for c in (MNIST_CNN, CIFAR10_CNN, STL10_CNN, SVHN_CNN)}


def init_params(cfg: CNNConfig, gen: torch.Generator) -> Params:
    """He-style normal weights (std fan_in**-0.5) and zero biases, drawn in
    layer order from ``gen``, on its device."""
    device = gen.device
    params: Params = {"conv": [], "fc": []}
    c_in = cfg.input_hw[2]
    for c_out in cfg.conv_channels:
        fan_in = 3 * 3 * c_in
        params["conv"].append({
            "kernel": torch.randn((3, 3, c_in, c_out), generator=gen, device=device)
            * fan_in**-0.5,
            "bias": torch.zeros((c_out,), device=device),
        })
        c_in = c_out
    h, w, _ = cfg.input_hw
    for _ in cfg.pool_after:
        h, w = h // 2, w // 2
    d = h * w * c_in
    for d_out in (*cfg.fc_dims, cfg.n_classes):
        params["fc"].append({
            "kernel": torch.randn((d, d_out), generator=gen, device=device) * d**-0.5,
            "bias": torch.zeros((d_out,), device=device),
        })
        d = d_out
    return params


def forward(
    params: Params, cfg: CNNConfig, x: torch.Tensor, return_activations: bool = False
) -> torch.Tensor | tuple[torch.Tensor, list[torch.Tensor]]:
    """x (B, H, W, C) → logits (B, n_classes).

    ``return_activations`` also yields every post-ReLU tensor (NHWC for the
    convs, (B, d) for the hidden FCs): the photonic model measures
    activation sparsity there (paper Fig. 7)."""
    acts: list[torch.Tensor] = []
    x = x.permute(0, 3, 1, 2)  # NCHW inside
    for i, cp in enumerate(params["conv"]):
        x = F.conv2d(x, cp["kernel"].permute(3, 2, 0, 1), cp["bias"], padding="same")
        x = torch.relu(x)
        acts.append(x.permute(0, 2, 3, 1))
        if i in cfg.pool_after:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as the FC kernels
    for j, fp in enumerate(params["fc"]):
        x = x @ fp["kernel"] + fp["bias"]
        if j < len(params["fc"]) - 1:
            x = torch.relu(x)
            acts.append(x)
    if return_activations:
        return x, acts
    return x


def param_count(params: Params) -> int:
    return sum(p.numel() for layer in params.values() for lp in layer for p in lp.values())
