"""Quickstart on the PyTorch port: the SONIC pipeline end to end.

The port of ``examples/quickstart.py`` (which stays, on the JAX package),
with the same steps:

1.  Build a (reduced) tinyllama, generate with dense weights.
2.  Sparsify (C1) + cluster (C2) the weights; show compression stats.
3.  Generate again on the clustered weights.
4.  Price a decode step of the full tinyllama on the photonic accelerator
    simulator (C4/C5) against the dense-photonic and electronic baselines
    (model outputs, not device measurements).

The weights are random from seeded generators (the reference's come from
JAX keys, so the tokens differ between the two; the pricing does not).  On
the card (the default) the engines capture their CUDA graphs; with
``--device cpu`` everything runs eagerly on the CPU.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.clustering import ClusteringConfig, cluster_params, storage_bits
from repro_torch.core.sparsity import SparsityConfig, apply_masks, build_masks, sparsity_of
from repro_torch.models.registry import get_arch
from repro_torch.photonic.baselines import evaluate_all
from repro_torch.photonic.mapper import lm_workload
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.utils.tree import tree_param_count


@torch.inference_mode()
def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the CPU")

    arch = get_arch("tinyllama-1.1b", reduced=True)
    print(f"arch: {arch.arch_id} (reduced) — "
          f"{tree_param_count(arch.abstract_params()):,} params")

    params = arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(arch, params, ServeConfig(max_len=64), dev)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, 256, (2, 8), generator=gen).to(dev)
    dense_out = eng.generate(prompts, 12).cpu().numpy()
    print("dense generation:     ", dense_out[0])

    # C1: sparsify 50% (magnitude, layer-wise, excluding sensitive layers)
    masks = build_masks(params, SparsityConfig(target_sparsity=0.5, block=(8, 8)))
    sparse = apply_masks(params, masks)
    c1 = sparsity_of(sparse["layers"]["ffn"]["wi"]["kernel"])
    print(f"C1 sparsity on ffn/wi: {c1:.2f}")

    # C2: cluster to 64 centroids ⇒ 6-bit weights (the paper's DAC budget)
    ccfg = ClusteringConfig(num_clusters=64)
    clustered, packed = cluster_params(sparse, ccfg)
    name, cw = next(iter(packed.items()))
    shape = tuple(cw.indices.shape)
    ratio = int(np.prod(shape)) * 16 / storage_bits(shape, ccfg)
    print(f"C2 clustering on {name}: {ratio:.1f}x fewer weight bits")

    eng_sonic = ServeEngine(arch, clustered, ServeConfig(max_len=64), dev)
    sonic_out = eng_sonic.generate(prompts, 12).cpu().numpy()
    agree = float(np.mean(sonic_out == dense_out))
    print("sonic generation:     ", sonic_out[0],
          f"(token agreement {agree:.0%} — random weights have no prunable "
          "redundancy; trained-model retention is held in "
          "tests/test_torch_system.py)")

    # C4/C5: price a decode step of the FULL tinyllama on the accelerators
    work = lm_workload(get_arch("tinyllama-1.1b").cfg, weight_sparsity=0.5, act_sparsity=0.5)
    reports = evaluate_all(work)
    print("\nphotonic pricing of one tinyllama-1.1b decode step:")
    print(f"{'platform':12s} {'tok/s':>10s} {'W':>8s} {'tok/s/W':>9s}")
    for n, r in reports.items():
        print(f"{n:12s} {r.fps:10.1f} {r.power_w:8.2f} {r.fps_per_w:9.2f}")
    return {"dense": dense_out, "sonic": sonic_out, "c1_sparsity": c1,
            "c2_ratio": ratio, "reports": reports}


if __name__ == "__main__":
    main()
