"""C3: the zero-compression dataflow (paper §III.C).

The port of ``repro.core.compression``.  FC layers: the product W @ x wastes
work on every x_j == 0, so the zero entries of the activation vector are
found and the matching columns of W dropped before the dot product; the
result is exact, because the dropped terms are exactly the zero
contributions.  The compressed activation vector is dense; residual
sparsity inside W's remaining columns is left to the VDU's power gating
(C4).

CONV layers: the kernel and its input-feature-map patch are unrolled
(im2col) into vector dot products, and the same column compression drops
the kernel rows that are zero across every output channel.

Two execution styles:

* ``compress_fc`` / ``compress_conv_patches``: dynamic nnz (the output shape
  depends on the values), faithful to the paper; the photonic model and the
  tests use them.  They return tensors on W's device.
* ``compressed_fc_matvec``: the static-k form (k kept columns fixed by the
  caller), the shape ``kernels/sparse_matvec`` runs on the card.

Layouts are the reference's: feature maps (H, W, C), kernels
(kh, kw, C_in, C_out).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.activation_sparsity import top_k


class CompressedFC(NamedTuple):
    """Result of FC zero-compression: dense activations + gathered columns."""

    w_cols: torch.Tensor  # (d_out, nnz) kept weight columns
    x_nz: torch.Tensor  # (nnz,) kept (nonzero) activations
    idx: torch.Tensor  # (nnz,) int32 original column indices


def compress_fc(w: torch.Tensor, x: torch.Tensor) -> CompressedFC:
    """Dynamic (data-dependent shape) FC compression, Fig. 1(a)→(b)."""
    w = torch.as_tensor(w)
    x = torch.as_tensor(x, device=w.device)
    if w.dim() != 2 or x.dim() != 1 or w.shape[1] != x.shape[0]:
        raise ValueError(f"shape mismatch: W{tuple(w.shape)} @ x{tuple(x.shape)}")
    idx = torch.nonzero(x).flatten()
    return CompressedFC(w_cols=w[:, idx], x_nz=x[idx], idx=idx.to(torch.int32))


def compressed_fc_apply(c: CompressedFC) -> torch.Tensor:
    """Evaluate the compressed product; equals W @ x exactly."""
    return c.w_cols @ c.x_nz


def compressed_fc_matvec(w: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """Static-k compressed matvec.

    Keeps the k largest-|x| entries (exact when x has ≤ k nonzeros, the
    SONIC case, where sparsity is known from the previous layer's
    statistics), gathers the matching columns of W and runs the small dense
    product.  w (d_out, d_in), x (d_in,) → (d_out,)."""
    k = min(k, w.shape[1])
    idx = top_k(x.abs(), k)
    return w[:, idx] @ x[idx]


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int) -> tuple[int, int]:
    return (h - kh) // stride + 1, (w - kw) // stride + 1


def im2col(ifmap: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Unroll conv patches, Fig. 2(b).

    ifmap (H, W, C_in) → patches (out_h·out_w, kh·kw·C_in), rows row-major
    over output pixels, each row ordered (kh, kw, C_in)."""
    if ifmap.dim() != 3:
        raise ValueError(f"expected (H, W, C), got {tuple(ifmap.shape)}")
    if padding:
        ifmap = F.pad(ifmap, (0, 0, padding, padding, padding, padding))
    h, w, c = ifmap.shape
    out_h, out_w = _out_hw(h, w, kh, kw, stride)
    dev = ifmap.device
    rows = (torch.arange(out_h, device=dev) * stride)[:, None, None, None] \
        + torch.arange(kh, device=dev)[None, None, :, None]  # (oh, 1, kh, 1)
    cols = (torch.arange(out_w, device=dev) * stride)[None, :, None, None] \
        + torch.arange(kw, device=dev)[None, None, None, :]  # (1, ow, 1, kw)
    patches = ifmap[rows, cols]  # (oh, ow, kh, kw, c)
    return patches.reshape(out_h * out_w, kh * kw * c)


def conv2d_via_im2col(ifmap: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    """Conv as a matmul over unrolled patches (the paper's CONV dataflow).

    ifmap (H, W, C_in), kernel (kh, kw, C_in, C_out) → (out_h, out_w, C_out)."""
    kh, kw, c_in, c_out = kernel.shape
    cols = im2col(ifmap, kh, kw, stride, padding)
    out = cols @ kernel.reshape(kh * kw * c_in, c_out)
    out_h, out_w = _out_hw(ifmap.shape[0] + 2 * padding, ifmap.shape[1] + 2 * padding,
                           kh, kw, stride)
    return out.reshape(out_h, out_w, c_out)


class CompressedConv(NamedTuple):
    """Conv compression result: dense kernel vectors + compressed patches."""

    patches: torch.Tensor  # (n_patches, nnz)
    kernel_rows: torch.Tensor  # (nnz, C_out)
    idx: torch.Tensor  # (nnz,) int32


def compress_conv_patches(ifmap: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                          padding: int = 0) -> CompressedConv:
    """CONV zero-compression, Fig. 2(b)→(c).

    After unrolling, kernel rows that are zero across every output channel
    (a pruned kernel position) are dropped with the matching patch columns,
    leaving dense kernel vectors; the residual IF-map sparsity is left for
    the VDU to gate.  Dynamic shape."""
    kernel = torch.as_tensor(kernel)
    kh, kw, c_in, c_out = kernel.shape
    cols = im2col(torch.as_tensor(ifmap, device=kernel.device), kh, kw, stride, padding)
    wmat = kernel.reshape(kh * kw * c_in, c_out)
    keep = torch.nonzero((wmat != 0).any(dim=1)).flatten()
    return CompressedConv(patches=cols[:, keep], kernel_rows=wmat[keep],
                          idx=keep.to(torch.int32))


def compressed_conv_apply(c: CompressedConv, out_h: int, out_w: int) -> torch.Tensor:
    """Evaluate the compressed conv; equals ``conv2d_via_im2col`` exactly."""
    return (c.patches @ c.kernel_rows).reshape(out_h, out_w, -1)
