"""Compressed sparse matvec: Hopper kernel + plain version.

Replaces the TPU kernel ``sparse_matvec_pallas``
(``src/repro/kernels/sparse_matvec/kernel.py:40``).  The CUDA source is
``src/repro_torch/csrc/sparse_matvec.cu``; its note gives the bound on an
H100 (bytes: each gathered weight row read once) and the design: one launch
per projection, the kept rows in chunks of 32 dealt to the blocks of a
cluster per column tile (``build.sparse_matvec_plan``), each row's segment
copied asynchronously into a ring of stages, fp32 sums combined in one
fixed order through distributed shared memory, so a row's result does not
depend on B.  Two routes, chosen by ``build.sparse_matvec_route`` from the
shape and the alignment and counted in ``sparse_matvec_kernel.routes``:
``"async_copy"`` (cp.async, 16 bytes a lane) and ``"cuda_cores"`` (loads
into registers), with the same sums.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils.rows import plain_rows


def sparse_matvec_plain(
    x_nz: torch.Tensor,  # (B, knz) bf16 / fp32
    idx: torch.Tensor,  # (knz,) int32
    wt: torch.Tensor,  # (K, N) bf16 / fp32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the rows idx names and
    contract in fp32.  Returns y (B, N) fp32; a row's bits do not depend on
    B (``utils.rows``)."""
    rows = wt.index_select(0, idx.long()).float()
    return plain_rows(lambda xx: xx.float() @ rows, x_nz)


def sparse_matvec_kernel(x_nz: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """y (B, N) fp32 = x_nz (B, knz) @ wt[idx].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``sparse_matvec_kernel.launches`` and
    ``.routes[route]``) or raises."""
    if x_nz.device.type == "cpu":
        return sparse_matvec_plain(x_nz, idx, wt)
    route = build.sparse_matvec_route(wt)
    y = build.launch_sparse_matvec(x_nz, idx, wt)
    sparse_matvec_kernel.launches += 1
    sparse_matvec_kernel.routes[route] += 1
    return y


sparse_matvec_kernel.launches = 0
sparse_matvec_kernel.routes = dict.fromkeys(build.SMV_ROUTES, 0)
