"""repro_torch.core: SONIC's algorithmic contribution (the port of
``repro.core``).

C1  sparsity.py             layer-wise magnitude pruning, gradual (Zhu & Gupta)
                            schedule, block-structured variant.
C2  clustering.py           density-based centroid-init weight clustering,
                            int-index + codebook packing, log2(C)-bit accounting.
C3  compression.py          zero-compression dataflow: FC column-drop + conv im2col.
    activation_sparsity.py  static-k contextual activation sparsity.
C4  vdu.py                  VDU decomposition + quantized photonic fidelity model.
    sonic_layers.py         the execution-mode layer (``sonic_linear_apply``).
"""

from repro_torch.core.sparsity import (
    SparsityConfig,
    magnitude_prune_mask,
    block_prune_mask,
    gradual_sparsity_schedule,
    apply_masks,
    sparsity_of,
)
from repro_torch.core.clustering import (
    ClusteringConfig,
    density_based_centroids,
    cluster_weights,
    ClusteredWeight,
    pack_clustered,
    unpack_clustered,
)
from repro_torch.core.compression import (
    compress_fc,
    compressed_fc_matvec,
    im2col,
    conv2d_via_im2col,
    compress_conv_patches,
)
from repro_torch.core.activation_sparsity import topk_activation_mask, topk_compress
from repro_torch.core.sonic_layers import SonicLinearParams, sonic_linear_apply
