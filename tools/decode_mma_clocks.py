#!/usr/bin/env python3
"""Where the decode matvec's time goes, on one CUDA card.

    PYTHONPATH=src python tools/decode_mma_clocks.py

At tinyllama-1.1b's five projection shapes ((128, 128) int8 blocks,
sparsity 0.5, x (4, K) bf16), prints one JSON line per shape:

* ``us_per_launch``: µs per launch (22 distinct weights per shape, one for
  the LM head, so each launch finds its weights cold in L2, replayed from a
  CUDA graph between CUDA events) of the decode kernel
  (``sonic_matvec_int8_mma``) at ``build.decode_split``'s split and at
  splits 1, 2, 4 and 8, of the codebook decode kernel (``sonic_matvec_mma``,
  64 centroids) at the same splits, of the tensor-core matmul at the same M
  (``block_sparse_matmul_int8_mma``) and of the CUDA-core matvec;
* ``cycles``: for one launch at the chosen split, the median over blocks
  of the SM clocks between the stamps of ``csrc/decode_mma.cuh`` (built
  once more with ``-DSONIC_DECODE_CLOCKS`` into ``build/decode_clocks/``):
  setup (loads of indices and scales, barrier init), producer done (from
  setup's end), first chunk's wgmma issued (and the cluster's start
  barrier passed), chunks done, the cluster barrier, the combine, and the
  block's whole time.

Then one line with ptxas's registers and spills of each decode_kernel
instance in the built library.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.sonic_layers import make_block_sparse_int8  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000))
POINTS = ("setup", "producer_done", "first_issue", "chunks_done", "cluster_barrier",
          "combine")


def _graph_us(fn, n_launches: int, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps / n_launches


def _clock_library() -> ctypes.CDLL:
    out = build.BUILD_DIR / "decode_clocks" / "libdecode_clocks.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DSONIC_DECODE_CLOCKS", "-shared",
                    str(build.CSRC / "sonic_matvec_int8.cu"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.sonic_matvec_int8_mma.argtypes = build.SIGNATURES["sonic_matvec_int8_mma"]
    lib.sonic_matvec_int8_mma.restype = ctypes.c_int
    lib.decode_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.decode_clocks.restype = ctypes.c_int
    return lib


@torch.inference_mode()
def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("decode_mma_clocks: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    clocks = _clock_library()
    sms = build.sm_count(0)
    for k, n in SHAPES:
        ws = [make_block_sparse_int8(torch.randn((k, n), generator=gen, device=dev) * k**-0.5,
                                     0.5, (128, 128)) for _ in range(1 if n == 32000 else 22)]
        x = torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
        n_chunks, tiles = build.decode_chunks(ws[0].values)
        split = build.decode_split(n_chunks, tiles, sms,
                                   build.DECODE_BLOCKS_PER_SM["sonic_matvec_int8_mma"])

        def each(name, **kw):
            return lambda: [build.launch_int8(name, x, w.values, w.scales, w.indices, **kw)
                            for w in ws]

        us = {f"decode_split{s}": _graph_us(each("sonic_matvec_int8_mma", split=s), len(ws))
              for s in (1, 2, 4, 8)}
        ids = [torch.randint(0, 64, w.values.shape, generator=gen, device=dev,
                             dtype=torch.int8) for w in ws]
        cb = torch.randn((64,), generator=gen, device=dev) * k**-0.5
        for s in (1, 2, 4, 8):
            us[f"codebook_split{s}"] = _graph_us(
                lambda: [build.launch_codebook("sonic_matvec_mma", x, i, cb, w.indices, split=s)
                         for i, w in zip(ids, ws)], len(ws))
        us["decode"] = us[f"decode_split{split}"]
        us["mma_kernel_m4"] = _graph_us(each("block_sparse_matmul_int8_mma"), len(ws))
        us["cuda_core_matvec"] = _graph_us(each("sonic_matvec_int8"), len(ws))

        w = ws[0]
        y = torch.empty((4, n), device=dev)
        blocks = tiles * split
        err = clocks.sonic_matvec_int8_mma(
            x.data_ptr(), 1, w.values.data_ptr(), w.scales.data_ptr(), w.indices.data_ptr(),
            y.data_ptr(), 4, k, w.values.shape[0], w.values.shape[1], 128, 128, split,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        host = torch.zeros((blocks, len(POINTS) + 1), dtype=torch.int64)
        if err or clocks.decode_clocks(host.data_ptr(), blocks):
            raise RuntimeError(f"instrumented launch failed: {err}")
        torch.testing.assert_close(y, build.launch_int8("sonic_matvec_int8_mma", x, w.values,
                                                        w.scales, w.indices), rtol=0, atol=0)
        rel = host - host[:, :1]
        # each point from the one before it; the producer's from setup's end
        since = {"producer_done": 1, "first_issue": 1}
        cycles = {name: int((rel[:, i] - rel[:, since.get(name, i - 1)]).median())
                  for i, name in enumerate(POINTS, start=1)}
        cycles["block_total"] = int(rel[:, -1].median())
        cycles["block_total_max"] = int(rel[:, -1].max())
        print(json.dumps({"shape": f"{k}x{n}", "chunks_per_tile": n_chunks, "tiles": tiles,
                          "split": split, "us_per_launch": us, "cycles": cycles}), flush=True)
    log = build.library_path().with_suffix(".log").read_text()
    found = re.findall(r"Compiling entry function '(\w*decode_kernel\w*)'.*?(\d+) bytes spill "
                       r"stores.*?Used (\d+) registers", log, re.S)
    print(json.dumps({"decode_kernel_registers_spills": {
        name[-60:]: [int(r), int(sp)] for name, sp, r in found}}), flush=True)


if __name__ == "__main__":
    main()
