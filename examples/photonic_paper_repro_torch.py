"""Reproduce the paper's §V evaluation narrative on one model (CIFAR10 CNN)
on the PyTorch port:

  dataflow compression (§III.C) → VDU decomposition (§IV.C) → device-level
  pricing (Table 2) → comparison against the 7 baseline platforms (Figs 8-10),
  plus the ablation the paper implies: what each SONIC mechanism contributes.

The port of ``examples/photonic_paper_repro.py`` (which stays, on the JAX
package).  FPS, W, FPS/W and EPB are outputs of the photonic model, not
device measurements.  The CNN's weights come from a seeded generator, and
the batch that measures activation sparsity from another (the reference
draws both from JAX keys); ``main(params=..., sample=...)`` takes others,
e.g. the reference's carried across with ``convert.params_from_jax``, and
then prints the reference's figures.  The CNN's forward runs on
``--device`` (default: the card).

Run:  PYTHONPATH=src python examples/photonic_paper_repro_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.models import cnn as cnn_lib
from repro_torch.photonic.accelerator import SonicAccelerator, SonicHWConfig
from repro_torch.photonic.baselines import evaluate_all
from repro_torch.photonic.mapper import cnn_workload

VARIANTS = {
    "full SONIC (5,50,50,10)": SonicHWConfig(),
    "no clustering (16b DACs)": SonicHWConfig(weight_bits=16),
    "no sparsity gating": SonicHWConfig(sparsity_gating=False),
    "no compression": SonicHWConfig(compression=False),
    "none (dense photonic)": SonicHWConfig(
        weight_bits=16, sparsity_gating=False, compression=False
    ),
}


@torch.inference_mode()
def main(argv: list[str] | None = None, params=None, sample=None) -> dict:
    """Prints the tables; returns {"ablation": {variant: report},
    "platforms": {name: report}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the CPU")

    cfg = cnn_lib.CIFAR10_CNN
    if params is None:
        params = cnn_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = {k: [{n: t.to(dev) for n, t in lp.items()} for lp in v] for k, v in params.items()}
    ws = {f"conv{i}": 0.5 for i in range(6)} | {"fc0": 0.8}
    work = cnn_workload(cfg, params, ws, sample=None if sample is None else sample.to(dev))

    print("== workload after §III.C compression ==")
    for w in work:
        print(f"  {w.name:6s} {w.kind:4s} veclen={w.vec_len:5d} "
              f"products={w.n_products:7d} reuse={w.reuse}")

    print("\n== SONIC mechanism ablation (CIFAR10) ==")
    print(f"{'variant':28s} {'FPS':>9s} {'W':>7s} {'FPS/W':>8s}")
    ablation = {}
    for name, hw in VARIANTS.items():
        r = ablation[name] = SonicAccelerator(hw).evaluate(work)
        print(f"{name:28s} {r.fps:9.1f} {r.power_w:7.2f} {r.fps_per_w:8.2f}")

    print("\n== Figs 8–10 for CIFAR10 ==")
    reports = evaluate_all(work)
    print(f"{'platform':12s} {'FPS':>10s} {'W':>8s} {'FPS/W':>8s} {'EPB pJ/b':>9s}")
    for n, r in reports.items():
        print(f"{n:12s} {r.fps:10.1f} {r.power_w:8.2f} {r.fps_per_w:8.2f} "
              f"{r.epb * 1e12:9.3f}")
    s = reports["SONIC"]
    print("\nSONIC advantage (FPS/W):")
    for n, r in reports.items():
        if n != "SONIC":
            print(f"  vs {n:11s}: {s.fps_per_w / r.fps_per_w:5.2f}x")
    return {"ablation": ablation, "platforms": reports}


if __name__ == "__main__":
    main()
