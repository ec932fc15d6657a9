"""C2 — weight clustering (paper §III.B).

The port of ``repro.core.clustering``: post-training weight clustering with
density-based centroid initialization (the centroids start at the
midpoint quantiles of the weights, so each owns an equal mass), then Lloyd
iterations.  A tensor ends up with C unique values, stored as int8 (or
int32) cluster ids plus a (C,) fp32 codebook; the clustered kernels look the
ids up in the codebook as they stream them.

It runs at full model width on the card (tinyllama-1.1b's LM head has 65.5 M
weights), which shapes three choices the reference did not need:

* the quantile sorts the whole tensor once and interpolates linearly, as
  ``jnp.quantile`` does (``torch.quantile`` refuses inputs past 2**24);
* the assignment (argmin of |w − c| over the centroids, first minimum on
  ties, as ``jnp.argmin``) runs in chunks of ``ASSIGN_CHUNK`` weights, so the
  (n, C) distances never exist whole; the result does not depend on the
  chunk size;
* the per-cluster sums are taken in fixed point: each weight is scaled by a
  power of two and rounded to an int64 once per tensor, so the sums are
  exact integer sums, and the same on every run whatever order the card's
  atomics add them in.  The scale keeps the total below 2**62; the rounding
  error is below 2**-62 of n·max|w| per weight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.tree import tree_map_with_path_names

ASSIGN_CHUNK = 1 << 22  # weights per argmin chunk: (chunk, C) fp32 distances
_SUM_ROW = 1 << 10  # weights per row of the fixed-point segment sum


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    """Clustering plan.

    Attributes:
      num_clusters: C.  The paper settles on C = 16..64; 64 ⇒ 6-bit ids.
      iters: Lloyd iterations.
      exclude: layer-name substrings left unclustered (norms, biases).
      preserve_zero: keep an exact 0.0 centroid so sparsity survives
        clustering.
    """

    num_clusters: int = 64
    iters: int = 10
    exclude: tuple[str, ...] = ("norm", "scale", "bias", "embed_norm")
    preserve_zero: bool = True

    @property
    def index_bits(self) -> int:
        return max(math.ceil(math.log2(self.num_clusters)), 1)


def quantile_sorted(a: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation quantiles (``jnp.quantile``'s and numpy's default
    method) of an ascending 1-D tensor, for any length.  Positions and
    weights are taken in fp64; the result has a's type."""
    n = a.numel()
    pos = probs.to(device=a.device, dtype=torch.float64) * (n - 1)
    lo = pos.floor()
    hi_w = pos - lo
    lo_v = a[lo.long()].double()
    hi_v = a[pos.ceil().long()].double()
    return (lo_v * (1.0 - hi_w) + hi_v * hi_w).to(a.dtype)


def density_based_centroids(w: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """CDF / equal-density centroid initialization (§III.B):
    centroid_i = quantile(w, (i + 0.5) / C)."""
    probs = (torch.arange(num_clusters, dtype=torch.float32) + 0.5) / num_clusters
    return quantile_sorted(torch.sort(w.float().reshape(-1)).values, probs)


def assign_clusters(w_flat: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Index (int64) of the nearest centroid for every weight, the first one
    on ties; ``ASSIGN_CHUNK`` weights at a time."""
    out = torch.empty(w_flat.shape, dtype=torch.int64, device=w_flat.device)
    for s in range(0, w_flat.numel(), ASSIGN_CHUNK):
        d = w_flat[s:s + ASSIGN_CHUNK, None] - centroids[None, :]
        out[s:s + ASSIGN_CHUNK] = d.abs_().argmin(dim=1)
    return out


def _fixed_point(w_flat: torch.Tensor) -> tuple[torch.Tensor, float]:
    """(int64 weights, scale) with w ≈ q / scale, scale a power of two that
    keeps n · max|q| ≤ 2**62."""
    top = float(w_flat.abs().max()) * w_flat.numel() if w_flat.numel() else 0.0
    scale = 2.0 ** (62 - math.ceil(math.log2(top))) if top > 0 else 1.0
    return torch.round(w_flat.double() * scale).long(), scale


def _segment_sums(q: torch.Tensor, idx: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """Exact int64 sums of q per cluster: rows of ``_SUM_ROW`` weights are
    scattered into their own row of C sums, then the rows are added."""
    pad = (-q.numel()) % _SUM_ROW
    q2 = torch.nn.functional.pad(q, (0, pad)).view(-1, _SUM_ROW)
    i2 = torch.nn.functional.pad(idx, (0, pad)).view(-1, _SUM_ROW)  # pads add 0 to cluster 0
    rows = torch.zeros((q2.shape[0], num_clusters), dtype=torch.int64, device=q.device)
    return rows.scatter_add_(1, i2, q2).sum(dim=0)


def _kmeans_1d(
    w_flat: torch.Tensor, num_clusters: int, iters: int, preserve_zero: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-D Lloyd's k-means with density-based init.  Returns (codebook (C,)
    fp32 ascending, ids (n,) int64)."""
    centroids = density_based_centroids(w_flat, num_clusters)
    q, scale = _fixed_point(w_flat)
    for _ in range(iters):
        idx = assign_clusters(w_flat, centroids)
        sums = _segment_sums(q, idx, num_clusters).double() / scale
        counts = torch.bincount(idx, minlength=num_clusters)
        means = (sums / counts.clamp(min=1)).float()
        centroids = torch.where(counts > 0, means, centroids)
    if preserve_zero:
        # the centroid nearest zero becomes exactly 0.0, so pruned weights
        # stay exactly zero after clustering
        centroids[centroids.abs().argmin()] = 0.0
    centroids = torch.sort(centroids).values
    return centroids, assign_clusters(w_flat, centroids)


@dataclasses.dataclass
class ClusteredWeight:
    """A weight tensor stored as (int8 / int32 ids, fp32 codebook).

    ``indices`` has the original tensor shape; ``codebook`` has shape (C,).
    ``dense()`` reconstructs the clustered tensor.  This is the storage the
    clustered-matmul kernel reads."""

    indices: torch.Tensor  # int8 / int32, original shape
    codebook: torch.Tensor  # (C,) float32

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        return self.codebook[self.indices.long()].to(dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.indices.shape)


def cluster_weights(
    w: torch.Tensor, config: ClusteringConfig
) -> tuple[torch.Tensor, ClusteredWeight]:
    """Cluster one tensor.  Returns (clustered dense tensor, packed form)."""
    codebook, idx = _kmeans_1d(w.float().reshape(-1), config.num_clusters, config.iters,
                               config.preserve_zero)
    dtype = torch.int8 if config.num_clusters <= 128 else torch.int32
    packed = ClusteredWeight(indices=idx.reshape(w.shape).to(dtype), codebook=codebook)
    return packed.dense(w.dtype), packed


def cluster_params(
    params: Any, config: ClusteringConfig
) -> tuple[Any, dict[str, ClusteredWeight]]:
    """Cluster every eligible (rank ≥ 2, non-excluded) tensor in a tree.

    Returns (params with clustered values substituted, {name: ClusteredWeight})."""
    packed: dict[str, ClusteredWeight] = {}

    def one(name: str, w: torch.Tensor) -> torch.Tensor:
        if w.dim() < 2 or any(pat in name for pat in config.exclude):
            return w
        dense, cw = cluster_weights(w, config)
        packed[name] = cw
        return dense

    return tree_map_with_path_names(one, params), packed


def pack_clustered(w: torch.Tensor, config: ClusteringConfig) -> ClusteredWeight:
    """Cluster and return only the packed form."""
    return cluster_weights(w, config)[1]


def unpack_clustered(cw: ClusteredWeight, dtype=torch.float32) -> torch.Tensor:
    return cw.dense(dtype)


def clustering_error(w: torch.Tensor, config: ClusteringConfig) -> float:
    """Relative Frobenius reconstruction error."""
    dense, _ = cluster_weights(w, config)
    num = torch.linalg.norm((dense - w).float())
    return float(num / (torch.linalg.norm(w.float()) + 1e-12))


def storage_bits(shape: tuple[int, ...], config: ClusteringConfig) -> int:
    """Bits to store a clustered tensor: n·log2(C) + C·32 (codebook)."""
    return math.prod(shape) * config.index_bits + config.num_clusters * 32
