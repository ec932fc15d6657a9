"""Batched serving with SONIC-compressed weights (the paper's deployment
scenario) on the PyTorch port: dense vs clustered serving, with the
hand-written SONIC kernels run directly on the hot matmul.

The port of ``examples/serve_sparse.py`` (which stays, on the JAX
package), at the same reduced internlm2-1.8b and the same steps:

* C1: balanced block masks (8×8 blocks, sparsity 0.5), then C2: 64-entry
  clustering of the masked weights (the serving checkpoint transform);
* three engines on 8 prompts of 16 tokens, 24 new tokens each: the dense
  weights on the eager ("python") and the graphed ("scan") loop, the
  clustered weights on "scan", with tok/s and each one's first tokens;
* layer 0's ``ffn.wi`` in the SONIC format (sparsity 0.5, 16×16 blocks, 64
  clusters) through ``sonic_matmul`` at M = 8 (the tiled kernel, the port
  of ``sonic_matmul_pallas``) and ``sonic_matvec`` at M = 1 (the decode
  kernel, the port of ``sonic_matvec_pallas``), each with its max |Δ|
  against x @ the densified weight;
* the weight bytes, dense bf16 against the SONIC format.

On the card (the default) the two launches are the hand kernels, counted
by their wrappers, and the script fails if either ran any other way.  With
``--device cpu`` every kernel wrapper runs its plain PyTorch version.

Run:  PYTHONPATH=src python examples/serve_sparse_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.clustering import ClusteringConfig, cluster_params
from repro_torch.core.sparsity import SparsityConfig, apply_masks, build_masks
from repro_torch.kernels import build
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel
from repro_torch.kernels.sonic_matmul.ops import make_sonic_weight, sonic_matmul, sonic_matvec
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --device cpu to run on the CPU")
        build.load_library()
    arch = get_arch("internlm2-1.8b", reduced=True)
    params = arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)

    # SONIC-ify: sparsify + cluster (the serving checkpoint transform)
    masks = build_masks(params, SparsityConfig(target_sparsity=0.5, block=(8, 8)))
    sonic_params, _ = cluster_params(apply_masks(params, masks),
                                     ClusteringConfig(num_clusters=64))

    prompts = torch.randint(0, 256, (8, 16), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    result = {"engines": {}}
    for name, p, loop in [
        ("dense / python loop", params, "python"),
        ("dense / graphed scan", params, "scan"),
        ("sonic / graphed scan", sonic_params, "scan"),
    ]:
        eng = ServeEngine(arch, p, ServeConfig(max_len=96, temperature=0.0, loop=loop),
                          device=dev)
        eng.generate(prompts, 24)  # warm-up (and, on the card, the captures)
        _sync(dev)
        t0 = time.perf_counter()
        out = eng.generate(prompts, 24)
        _sync(dev)
        dt = time.perf_counter() - t0
        tok_s = out.shape[0] * out.shape[1] / dt
        result["engines"][name] = {"tok_s": tok_s, "first_tokens": out[0, :6].tolist()}
        print(f"{name:26s}: {tok_s:7.1f} tok/s first tokens {out[0, :6].tolist()}")

    # the hot matmul through the SONIC kernels: prefill-shaped (M = 8) on the
    # tiled matmul kernel, decode-shaped (M = 1 token) on the matvec kernel
    w = params["layers"]["ffn"]["wi"]["kernel"][0].float()
    sw = make_sonic_weight(w, sparsity=0.5, block=(16, 16), num_clusters=64)
    gen = torch.Generator(device=dev).manual_seed(2)
    for m, shape_name, fn, wrapper in [
        (8, "prefill (M=8)", lambda x: sonic_matmul(x, sw, bm=8), sm_kernel.sonic_matmul_kernel),
        (1, "decode (M=1)", lambda x: sonic_matvec(x, sw), sm_kernel.sonic_matvec_kernel),
    ]:
        x = torch.randn((m, w.shape[0]), generator=gen, device=dev)
        before = wrapper.launches
        y_kernel = fn(x)
        launched = wrapper.launches - before
        if dev.type == "cuda" and launched != 1:
            raise AssertionError(f"{shape_name}: {launched} launches of {wrapper.__name__}, "
                                 f"want 1")
        err = (y_kernel - x @ sw.dense(torch.float32)).abs().max().item()
        result[shape_name] = {"kernel": wrapper.__name__, "launches": launched,
                              "max_abs_err": err}
        print(f"\n{wrapper.__name__} {shape_name}: max|Δ| vs densified = {err:.2e} "
              f"({launched} kernel launch{'es' if launched != 1 else ''})")
    dense_bytes = w.numel() * 2
    sonic_bytes = sw.idx_values.numel() + sw.indices.numel() * 4 + sw.codebook.numel() * 4
    result["weight_bytes"] = {"dense_bf16": dense_bytes, "sonic": sonic_bytes}
    print(f"weight bytes {dense_bytes} → {sonic_bytes} "
          f"({dense_bytes / sonic_bytes:.1f}x less HBM traffic)")
    return result


if __name__ == "__main__":
    main()
