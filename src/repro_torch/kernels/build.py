"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Every ``*.cu`` under ``src/repro_torch/csrc/`` is a kernel with a plain C
entry point; the kernels' shared device code is ``block_sparse_kernels.cuh``
(CUDA cores), ``block_mma.cuh`` (tensor cores) and ``decode_mma.cuh`` (the
decode matvecs on the tensor cores, and the launch and cluster-barrier
helpers ``sparse_matvec.cu`` takes) beside them; ``decode_attention.cu``
stands alone.
``build()`` starts one ``nvcc -c`` per source, all at once, links the
objects into one shared library under ``build/`` at the root of the
checkout, and writes the compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel; each source's compile seconds head its
section) beside it.  The library's name carries a hash of the sources,
headers and flags, so an edited source never loads a stale build.
``load_library()`` builds if needed, loads the library and declares each
entry point's C signature (``SIGNATURES``).  The ``launch_*``
functions check the operands, allocate y and launch on the current stream;
each raises on what its kernels do not take and if the launch reports an
error.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Each entry point's C arguments; every one ends with the cudaStream_t and
# returns cudaGetLastError() after its launch.
#   int8:      (x, x_is_bf16, int8 values, fp32 scales, int32 indices, y,
#               M, K, Nb, R, bk, bn, stream)
#   codebook:  (x, x_is_bf16, int8 idx_values, fp32 codebook, C,
#               int32 indices, y, M, K, Nb, R, bk, bn, stream)
#   fp:        (x, x_is_bf16, values, values_is_bf16, int32 indices, y,
#               M, K, Nb, R, bk, bn, stream)
#   clustered: (x, x_is_bf16, ids, ids_is_int32, fp32 codebook, C, y,
#               M, K, N, stream)
#   sparse_matvec: (x_nz, x_is_bf16, int32 idx, wt, wt_is_bf16, y, B, knz,
#               K, N, tile, split, async, stream): ``sparse_matvec_plan``'s
#               tile and split, ``sparse_matvec_route``'s copy (async 1 or 0)
#   decode_attention: (q, q_is_bf16, k, v, kv_is_bf16, pos, pos_is_i64, out,
#               fp32 part, float2 ml, B, C, H, KH, Dh, S, q's three strides,
#               k's, v's (elements), scale, stream): the workspace's sizes
#               from ``decode_attention_plan``
# The ``*_mma`` entry points (the tensor-core route) take bf16 x only; the
# two decode ones (``sonic_matvec_int8_mma``, ``sonic_matvec_mma``) take
# ``split`` (``decode_split``) before the stream.
_INT8 = [_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P]
_CODEBOOK = [_P, _I, _P, _P, _I, _P, _P] + [_I] * 6 + [_P]
_FP = [_P, _I, _P, _I, _P, _P] + [_I] * 6 + [_P]
_CLUSTERED = [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P]
SIGNATURES = {
    "sonic_matvec_int8": _INT8,
    "sonic_matvec_int8_mma": _INT8[:-1] + [_I, _P],
    "block_sparse_matmul_int8": _INT8,
    "block_sparse_matmul_int8_mma": _INT8,
    "sonic_matvec": _CODEBOOK,
    "sonic_matvec_mma": _CODEBOOK[:-1] + [_I, _P],
    "sonic_matmul": _CODEBOOK,
    "sonic_matmul_mma": _CODEBOOK,
    "block_sparse_matmul": _FP,
    "block_sparse_matmul_mma": _FP,
    "clustered_matmul": _CLUSTERED,
    "clustered_matmul_mma": _CLUSTERED,
    "sparse_matvec": [_P, _I, _P, _P, _I, _P] + [_I] * 7 + [_P],
    "decode_attention": [_P, _I, _P, _P, _I, _P, _I, _P, _P, _P] + [_I] * 6 + [_L] * 9
    + [ctypes.c_float, _P],
}
MAX_CODEBOOK = {torch.int8: 128, torch.int32: 1024}  # centroids per id type
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
ROUTES = (TENSOR_CORES, CUDA_CORES)
MMA_CHUNK = 64  # K rows of one fresh tensor-core tile: min(bk, 64)
DECODE_MAX_SPLIT = 8  # blocks per 64-column tile: one cluster (csrc/decode_mma.cuh)
DECODE_MAX_LOCAL = 64  # chunks per decode block
DECODE_MAX_RECV = 160 * 1024  # bytes of received chunk tiles per decode block
DECODE_SLOTS = 64 * 8  # fp32 fragment slots of one tile: 64 columns × 8 tokens
# The decode entry points and the thread blocks per SM each one's registers
# are budgeted for (kDecodeBlocksPerSm in csrc/decode_mma.cuh: the codebook's
# three bf16 parts per weight hold three times the fragment registers)
DECODE_BLOCKS_PER_SM = {"sonic_matvec_int8_mma": 4, "sonic_matvec_mma": 2}
# sparse_matvec (csrc/sparse_matvec.cu): kept rows per chunk, warps per
# block, column tiles from the widest, blocks per cluster; its two routes
# copy rows into shared memory with cp.async or load them into registers
SMV_CHUNK, SMV_WARPS, SMV_TILES, SMV_MAX_SPLIT = 32, 4, (256, 128, 64, 32), 8
ASYNC_COPY = "async_copy"
SMV_ROUTES = (ASYNC_COPY, CUDA_CORES)
# decode_attention (csrc/decode_attention.cu): positions per split (one
# block's tile, a constant), query rows per block at most, head sizes
DA_SPLIT, DA_MAX_ROWS, DA_MAX_HEAD_DIM = 128, 16, 256


def mma_route(bk: int, bn: int, x_dtype: torch.dtype, *, dense: bool = False) -> str:
    """Which kernel of a routed matmul (``sonic_matmul``, ``clustered_matmul``,
    ``block_sparse_matmul``, ``block_sparse_matmul_int8``) takes a launch:
    ``"tensor_cores"`` (``csrc/block_mma.cuh``: wgmma on bf16 tiles of 64
    weight columns, fed by TMA) or ``"cuda_cores"`` (``tiled_kernel``, fp32
    FMAs).  It depends on the block shape and x's type, never on M, so a
    row's result does not depend on how many rows come with it.

    The tensor cores take bf16 x whose tiles fit: for the block-sparse
    kernels (bk, bn) blocks with bk a multiple of 16 and bn of 64 (fp32 x,
    ``serve_quant``'s 16×16 blocks and narrower ones stay on the CUDA
    cores); for ``clustered_matmul`` (``dense``, bk = K, bn = N) N a
    multiple of 64 and K of 8 (TMA reads x by rows whose stride must be a
    multiple of 16 bytes; the K edge of the last 64-row chunk arrives as
    zeros)."""
    if x_dtype != torch.bfloat16:
        return CUDA_CORES
    fits = bn % 64 == 0 and (bk % 8 == 0 if dense else bk % 16 == 0)
    return TENSOR_CORES if fits else CUDA_CORES


def decode_recv(n_chunks: int, split: int) -> int:
    """Bytes of chunk tiles (64 columns × 8 tokens, fp32) one decode block
    receives to combine: 1 / split of every chunk's (none at split 1)."""
    return n_chunks * DECODE_SLOTS * 4 // split if split > 1 else 0


def decode_split(n_chunks: int, tiles: int, sms: int, blocks_per_sm: int) -> int:
    """How many thread blocks (one cluster) share the chunks of one
    64-column tile in the decode kernel (``csrc/decode_mma.cuh``): doubled
    from 1, up to ``DECODE_MAX_SPLIT``, while the doubled grid (``tiles`` ×
    split blocks) stays within three quarters of what the card holds at
    once (``blocks_per_sm`` × ``sms``; the rest is slack for packing whole
    clusters into the GPCs) and each block keeps at least two chunks;
    then as far as needed so that no block takes more than
    ``DECODE_MAX_LOCAL`` chunks or receives more than ``DECODE_MAX_RECV``
    bytes (``decode_recv``); every block keeps at least one chunk.  It
    depends on the weight's shape (``n_chunks`` = R·bk / min(bk, 64) per
    tile, ``tiles`` = Nb·bn / 64) and the card, never on M; and the split
    moves work between blocks without changing any output's bits (the
    chunks are combined in one order)."""
    split = 1
    while (split < DECODE_MAX_SPLIT and 4 * tiles * 2 * split <= 3 * blocks_per_sm * sms
           and n_chunks >= 4 * split):
        split *= 2
    while split < DECODE_MAX_SPLIT and (-(-n_chunks // split) > DECODE_MAX_LOCAL
                                        or decode_recv(n_chunks, split) > DECODE_MAX_RECV):
        split *= 2
    return split


def decode_chunks(values: torch.Tensor) -> tuple[int, int]:
    """(chunks per 64-column tile, tiles) of a block-sparse weight (Nb, R,
    bk, bn) in the decode kernel."""
    nb, r, bk, bn = values.shape
    return r * (bk // min(bk, MMA_CHUNK)), nb * (bn // 64)


def sparse_matvec_plan(knz: int, n: int, sms: int) -> tuple[int, int]:
    """(tile, split) of ``sparse_matvec``: columns per block and blocks per
    column tile (one cluster) sharing the tile's chunks of ``SMV_CHUNK``
    kept rows.  For each tile from the widest, the split is doubled from 1,
    up to ``SMV_MAX_SPLIT``, while the doubled grid stays within two blocks
    per SM and every block keeps two chunks; the first tile whose grid
    reaches half the SMs is taken (the narrowest otherwise).  It reads knz,
    N and the card's SMs, never B: each output's chain of sums depends on
    knz and the split alone (csrc/sparse_matvec.cu)."""
    n_chunks = -(-knz // SMV_CHUNK)
    for tile in SMV_TILES:
        tiles = -(-n // tile)
        split = 1
        while split < SMV_MAX_SPLIT and tiles * 2 * split <= 2 * sms and n_chunks >= 4 * split:
            split *= 2
        if 2 * tiles * split >= sms:
            break
    return tile, split


def sparse_matvec_route(wt: torch.Tensor) -> str:
    """``"async_copy"`` where each kept row's segment starts 16-byte aligned
    (N · element size a multiple of 16, wt 16-byte aligned), so that
    ``sparse_matvec`` copies it with cp.async, 16 bytes a lane; else
    ``"cuda_cores"`` (loads into registers, the same sums).  From the shape
    and the alignment, never from B."""
    aligned = wt.shape[1] * wt.element_size() % 16 == 0 and wt.data_ptr() % 16 == 0
    return ASYNC_COPY if aligned else CUDA_CORES


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (decode_split's card input)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsonic_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "with the CUDA toolkit on the machine with the card")
    return nvcc


def build() -> Path:
    """Compile every source (one nvcc process each, run in parallel) and link
    them into the shared library; a no-op when the library is current."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()

        def compile_one(src: Path):
            obj = Path(tmp) / f"{src.stem}.o"
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return src, obj, proc, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=len(_sources())) as pool:
            jobs = list(pool.map(compile_one, _sources()))
        logs = [f"== {src.name} ({sec:.1f} s)\n{proc.stdout}" for src, _, proc, sec in jobs]
        failed = [src.name for src, _, proc, _ in jobs if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_lib, out)
    return out


@functools.cache
def load_library():
    """The built library as a ``ctypes.CDLL``, its entry points declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _is_pow2_le_128(v: int) -> bool:
    return 1 <= v <= 128 and v & (v - 1) == 0


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x must be on the current CUDA device, got "
                         f"{x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (M ≥ 1, K), got "
                         f"{tuple(x.shape)}")


def _check(name: str, x: torch.Tensor, t: torch.Tensor, dtypes, what: str) -> None:
    if t.dtype not in dtypes or t.device != x.device or not t.is_contiguous():
        raise TypeError(f"{name}: {what} must be contiguous {' or '.join(map(str, dtypes))} "
                        f"on {x.device}, got {t.dtype} on {t.device}")


def _check_blocks(name: str, x: torch.Tensor, values: torch.Tensor, value_dtypes,
                  indices: torch.Tensor, *per_block: torch.Tensor) -> tuple[int, ...]:
    """Check a block-sparse weight (values (Nb, R, bk, bn), indices and any
    per-block array (Nb, R)) against x (M, K); returns (M, K, Nb, R, bk, bn)."""
    _check_x(name, x)
    if values.dim() != 4:
        raise ValueError(f"{name}: values must be (Nb, R, bk, bn), got {tuple(values.shape)}")
    m, k = x.shape
    nb, r, bk, bn = values.shape
    _check(name, x, values, value_dtypes, "values")
    _check(name, x, indices, (torch.int32,), "indices")
    for t in per_block:
        _check(name, x, t, (torch.float32,), "scales")
    if any(tuple(t.shape) != (nb, r) for t in (indices, *per_block)):
        raise ValueError(f"{name}: indices and scales must be {(nb, r)}, got "
                         f"{[tuple(t.shape) for t in (indices, *per_block)]}")
    if not (_is_pow2_le_128(bk) and _is_pow2_le_128(bn)):
        raise ValueError(f"{name}: blocks must be powers of two up to 128, "
                         f"got {(bk, bn)}")
    if k % bk or not 1 <= r <= k // bk:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, values "
                         f"{tuple(values.shape)}")
    if bn % 4 == 0 and values.data_ptr() % 4:  # the matvecs load 4 int8 at a time
        raise ValueError(f"{name}: values must be 4-byte aligned for "
                         f"{bn}-wide blocks")
    if max(m * k, m * nb * bn, values.numel()) >= 2**31:
        raise ValueError(f"{name}: operands past 2**31 elements")
    return m, k, nb, r, bk, bn


def _check_codebook(name: str, x: torch.Tensor, codebook: torch.Tensor,
                    ids: torch.Tensor) -> int:
    _check(name, x, codebook, (torch.float32,), "codebook")
    c = codebook.numel()
    if codebook.dim() != 1 or not 1 <= c <= MAX_CODEBOOK[ids.dtype]:
        raise ValueError(f"{name}: codebook must be (C,) with 1 ≤ C ≤ "
                         f"{MAX_CODEBOOK[ids.dtype]} for {ids.dtype} ids, got "
                         f"{tuple(codebook.shape)}")
    return c


def _check_tma(name: str, *tensors: torch.Tensor) -> None:
    """The tensor-core route reads x and the stored weights (ids or values)
    with TMA, whose global addresses must be 16-byte aligned."""
    if name.endswith("_mma") and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: x and the weights must be 16-byte aligned")


def _check_decode(name: str, x: torch.Tensor, values: torch.Tensor,
                  split: int | None) -> tuple[int, ...]:
    """The decode kernel's extra arguments: () off its route, else (split,)
    (``decode_split`` unless given).  It takes at most 7 rows of bf16 x,
    bk a multiple of 16 and bn of 64 (``mma_route``), and a split of 1, 2,
    4 or 8 blocks, each with at least one and at most ``DECODE_MAX_LOCAL``
    chunks and at most ``DECODE_MAX_RECV`` bytes to combine."""
    if name not in DECODE_BLOCKS_PER_SM:
        return ()
    n_chunks, tiles = decode_chunks(values)
    if split is None:
        split = decode_split(n_chunks, tiles, sm_count(x.device.index),
                             DECODE_BLOCKS_PER_SM[name])
    if (split not in (1, 2, 4, 8) or split > n_chunks
            or -(-n_chunks // split) > DECODE_MAX_LOCAL
            or decode_recv(n_chunks, split) > DECODE_MAX_RECV):
        raise ValueError(f"{name}: {n_chunks} chunks per tile do not fit {split} blocks "
                         f"of {DECODE_MAX_LOCAL} chunks and {DECODE_MAX_RECV} bytes")
    if x.shape[0] > 7 or mma_route(values.shape[2], values.shape[3], x.dtype) != TENSOR_CORES:
        raise ValueError(f"{name}: takes bf16 x of at most 7 rows and blocks the tensor "
                         f"cores take, got x {tuple(x.shape)} {x.dtype}, blocks "
                         f"{tuple(values.shape[2:])}")
    return (split,)


def _call(name: str, *args) -> None:
    err = getattr(load_library(), name)(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_int8(name: str, x: torch.Tensor, values: torch.Tensor,
                scales: torch.Tensor, indices: torch.Tensor, *,
                split: int | None = None) -> torch.Tensor:
    """y (M, Nb·bn) fp32 from the int8 block-sparse entry point ``name``
    (``block_sparse_matmul_int8_mma`` and ``sonic_matvec_int8_mma`` are the
    tensor-core routes; the latter takes ``split``, default
    ``decode_split``)."""
    m, k, nb, r, bk, bn = _check_blocks(name, x, values, (torch.int8,), indices, scales)
    _check_tma(name, x, values)
    extra = _check_decode(name, x, values, split)
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
          scales.data_ptr(), indices.data_ptr(), y.data_ptr(), m, k, nb, r, bk, bn, *extra,
          _stream(x))
    return y


def launch_codebook(name: str, x: torch.Tensor, idx_values: torch.Tensor,
                    codebook: torch.Tensor, indices: torch.Tensor, *,
                    split: int | None = None) -> torch.Tensor:
    """y (M, Nb·bn) fp32 from the codebook block-sparse entry point ``name``
    (int8 cluster ids, C ≤ 128 centroids; ``sonic_matmul_mma`` and
    ``sonic_matvec_mma`` are the tensor-core routes, the latter taking
    ``split`` as in ``launch_int8``).  The ids must lie in [0, C), as the
    converters make them; checking would cost a pass over the weights."""
    m, k, nb, r, bk, bn = _check_blocks(name, x, idx_values, (torch.int8,), indices)
    c = _check_codebook(name, x, codebook, idx_values)
    _check_tma(name, x, idx_values)
    extra = _check_decode(name, x, idx_values, split)
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), idx_values.data_ptr(),
          codebook.data_ptr(), c, indices.data_ptr(), y.data_ptr(), m, k, nb, r, bk, bn,
          *extra, _stream(x))
    return y


def launch_fp(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
              name: str = "block_sparse_matmul") -> torch.Tensor:
    """y (M, Nb·bn) fp32 from ``block_sparse_matmul`` or, on the tensor-core
    route, ``block_sparse_matmul_mma`` (fp32 or bf16 values)."""
    m, k, nb, r, bk, bn = _check_blocks(name, x, values, (torch.float32, torch.bfloat16),
                                        indices)
    _check_tma(name, x, values)
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
          int(values.dtype == torch.bfloat16), indices.data_ptr(), y.data_ptr(),
          m, k, nb, r, bk, bn, _stream(x))
    return y


def launch_clustered(x: torch.Tensor, ids: torch.Tensor, codebook: torch.Tensor,
                     name: str = "clustered_matmul") -> torch.Tensor:
    """y (M, N) fp32 from ``clustered_matmul`` or, on the tensor-core route,
    ``clustered_matmul_mma`` (int8 or int32 ids (K, N) in [0, C), unchecked
    as in ``launch_codebook``)."""
    _check_x(name, x)
    _check(name, x, ids, (torch.int8, torch.int32), "ids")
    m, k = x.shape
    if ids.dim() != 2 or ids.shape[0] != k:
        raise ValueError(f"{name}: ids must be (K={k}, N), got {tuple(ids.shape)}")
    n = ids.shape[1]
    c = _check_codebook(name, x, codebook, ids)
    if max(m * k, m * n, ids.numel()) >= 2**31:
        raise ValueError(f"{name}: operands past 2**31 elements")
    _check_tma(name, x, ids)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), ids.data_ptr(),
          int(ids.dtype == torch.int32), codebook.data_ptr(), c, y.data_ptr(), m, k, n,
          _stream(x))
    return y


def launch_sparse_matvec(x_nz: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor, *,
                         plan: tuple[int, int] | None = None) -> torch.Tensor:
    """y (B, N) fp32 from ``sparse_matvec``: x_nz (B, knz) times the rows of
    wt (K, N) (fp32 or bf16) that idx (knz,) int32 names, in one launch on
    ``sparse_matvec_route``'s route, with ``sparse_matvec_plan``'s (tile,
    split) unless ``plan`` gives them.  The indices must lie in [0, K), as
    ``topk_sparse_matmul`` makes them; the kernel clamps them rather than
    read outside wt, and checking would cost a sync."""
    name = "sparse_matvec"
    _check_x(name, x_nz)
    _check(name, x_nz, idx, (torch.int32,), "idx")
    _check(name, x_nz, wt, (torch.float32, torch.bfloat16), "wt")
    b, knz = x_nz.shape
    if idx.shape != (knz,) or wt.dim() != 2 or min(wt.shape) < 1:
        raise ValueError(f"{name}: want idx ({knz},) and wt (K ≥ 1, N ≥ 1), got "
                         f"{tuple(idx.shape)} and {tuple(wt.shape)}")
    k, n = wt.shape
    if max(b * knz, b * n, wt.numel()) >= 2**31:
        raise ValueError(f"{name}: operands past 2**31 elements")
    tile, split = plan or sparse_matvec_plan(knz, n, sm_count(x_nz.device.index))
    y = torch.empty((b, n), dtype=torch.float32, device=x_nz.device)
    _call(name, x_nz.data_ptr(), int(x_nz.dtype == torch.bfloat16), idx.data_ptr(),
          wt.data_ptr(), int(wt.dtype == torch.bfloat16), y.data_ptr(), b, knz, k, n, tile,
          split, int(sparse_matvec_route(wt) == ASYNC_COPY), _stream(x_nz))
    return y


def decode_attention_plan(b: int, c: int, h: int, kh: int, dh: int, s_max: int) -> dict:
    """The launch of ``decode_attention`` for q (B, C, H, Dh) over a cache
    (B, S_max, KH, Dh): positions per split (``DA_SPLIT``, a constant: a
    row's sums follow the split and its own position alone), query rows
    (c, g) per block (the power of two at or above C·G, at most
    ``DA_MAX_ROWS``; each row's sums are its own), the first kernel's grid
    (KH, splits, B · row groups; blocks past their rows' last position exit
    on the card) and the fp32 workspace (a split's p·v per row, and its max
    and sum).  Only the grid and the workspace follow B, C and S_max."""
    rows = c * (h // kh)
    per_block = min(DA_MAX_ROWS, 1 << (rows - 1).bit_length())
    splits = -(-s_max // DA_SPLIT)
    return {"split": DA_SPLIT, "rows_per_block": per_block,
            "grid": (kh, splits, b * -(-rows // per_block)),
            "part_floats": b * kh * splits * rows * dh, "ml_floats": 2 * b * kh * splits * rows}


def check_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor) -> None:
    """What ``decode_attention`` takes, checked from shapes, types and
    strides alone (so also on meta tensors): q (B, C, H, Dh) bf16 or fp32,
    k and v (B, S_max, KH, Dh) of one type, bf16 or fp32, KH dividing H,
    Dh a multiple of 8 up to ``DA_MAX_HEAD_DIM``, Dh contiguous in all
    three and the cache's other strides whole 16-byte steps, pos (B,)
    contiguous int32 or int64."""
    name = "decode_attention"
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q must be bfloat16 or float32, got {q.dtype}")
    if k_cache.dtype not in (torch.bfloat16, torch.float32) or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{name}: k and v must share a type, bfloat16 or float32, got "
                        f"{k_cache.dtype} and {v_cache.dtype}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: pos must be int32 or int64, got {pos.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{name}: want q (B, C, H, Dh) and k, v (B, S_max, KH, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, c, h, dh = q.shape
    kb, s_max, kh, kdh = k_cache.shape
    if (kb != b or kdh != dh or kh < 1 or h % kh or min(b, c, s_max) < 1
            or pos.shape != (b,) or not pos.is_contiguous()):
        raise ValueError(f"{name}: q {tuple(q.shape)}, cache {tuple(k_cache.shape)} and pos "
                         f"{tuple(pos.shape)} do not fit")
    if dh % 8 or not 8 <= dh <= DA_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 up to "
                         f"{DA_MAX_HEAD_DIM}, got {dh}")
    es = k_cache.element_size()
    if (q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1
            or any(s * es % 16 for t in (k_cache, v_cache) for s in t.stride()[:3])):
        raise ValueError(f"{name}: Dh must be contiguous and the cache's rows 16-byte "
                         f"steps apart, got strides {q.stride()}, {k_cache.stride()}, "
                         f"{v_cache.stride()}")


def launch_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: torch.Tensor) -> torch.Tensor:
    """out (B, C, H, Dh) in the cache's type from ``decode_attention``
    (``check_decode_attention``'s operands, on the current CUDA device, the
    cache 16-byte aligned): query row c of slot b over positions 0 …
    min(pos[b] + c, S_max − 1)."""
    name = "decode_attention"
    check_decode_attention(q, k_cache, v_cache, pos)
    dev = torch.device("cuda", torch.cuda.current_device())
    if any(t.device != dev for t in (q, k_cache, v_cache, pos)):
        raise ValueError(f"{name}: every operand must be on the current CUDA device {dev}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned")
    b, c, h, dh = q.shape
    s_max, kh = k_cache.shape[1:3]
    plan = decode_attention_plan(b, c, h, kh, dh, s_max)
    if plan["grid"][1] > 65535 or plan["grid"][2] > 65535 or c * (h // kh) > 65535:
        raise ValueError(f"{name}: splits, B · row groups and C·G must be at most 65535")
    out = torch.empty(q.shape, dtype=v_cache.dtype, device=dev)
    part = torch.empty(plan["part_floats"], dtype=torch.float32, device=dev)
    ml = torch.empty(plan["ml_floats"], dtype=torch.float32, device=dev)
    _call(name, q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(),
          v_cache.data_ptr(), int(k_cache.dtype == torch.bfloat16), pos.data_ptr(),
          int(pos.dtype == torch.int64), out.data_ptr(), part.data_ptr(), ml.data_ptr(),
          b, c, h, kh, dh, s_max, *q.stride()[:3], *k_cache.stride()[:3],
          *v_cache.stride()[:3], dh**-0.5, _stream(q))
    return out
