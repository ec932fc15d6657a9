"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Every ``*.cu`` under ``src/repro_torch/csrc/`` is a kernel with a plain C
entry point; the kernels' shared device code is ``block_sparse_kernels.cuh``
beside them.  ``build()`` starts one ``nvcc -c`` per source, all at once,
links the objects into one shared library under ``build/`` at the root of
the checkout, and writes the compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) beside it.  The library's name carries a
hash of the sources, headers and flags, so an edited source never loads a
stale build.  ``load_library()`` builds if needed, loads the library and
declares each entry point's C signature (``SIGNATURES``).  The ``launch_*``
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
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
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
_INT8 = [_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P]
_CODEBOOK = [_P, _I, _P, _P, _I, _P, _P] + [_I] * 6 + [_P]
SIGNATURES = {
    "sonic_matvec_int8": _INT8,
    "block_sparse_matmul_int8": _INT8,
    "sonic_matvec": _CODEBOOK,
    "sonic_matmul": _CODEBOOK,
    "block_sparse_matmul": [_P, _I, _P, _I, _P, _P] + [_I] * 6 + [_P],
    "clustered_matmul": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P],
}
MAX_CODEBOOK = {torch.int8: 128, torch.int32: 1024}  # centroids per id type


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
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in jobs)],
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


def _call(name: str, *args) -> None:
    err = getattr(load_library(), name)(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_int8(name: str, x: torch.Tensor, values: torch.Tensor,
                scales: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """y (M, Nb·bn) fp32 from the int8 block-sparse entry point ``name``."""
    m, k, nb, r, bk, bn = _check_blocks(name, x, values, (torch.int8,), indices, scales)
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
          scales.data_ptr(), indices.data_ptr(), y.data_ptr(), m, k, nb, r, bk, bn, _stream(x))
    return y


def launch_codebook(name: str, x: torch.Tensor, idx_values: torch.Tensor,
                    codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """y (M, Nb·bn) fp32 from the codebook block-sparse entry point ``name``
    (int8 cluster ids, C ≤ 128 centroids).  The ids must lie in [0, C), as
    the converters make them; checking would cost a pass over the weights."""
    m, k, nb, r, bk, bn = _check_blocks(name, x, idx_values, (torch.int8,), indices)
    c = _check_codebook(name, x, codebook, idx_values)
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), idx_values.data_ptr(),
          codebook.data_ptr(), c, indices.data_ptr(), y.data_ptr(), m, k, nb, r, bk, bn,
          _stream(x))
    return y


def launch_fp(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """y (M, Nb·bn) fp32 from ``block_sparse_matmul`` (fp32 or bf16 values)."""
    name = "block_sparse_matmul"
    m, k, nb, r, bk, bn = _check_blocks(name, x, values, (torch.float32, torch.bfloat16),
                                        indices)
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
          int(values.dtype == torch.bfloat16), indices.data_ptr(), y.data_ptr(),
          m, k, nb, r, bk, bn, _stream(x))
    return y


def launch_clustered(x: torch.Tensor, ids: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """y (M, N) fp32 from ``clustered_matmul`` (int8 or int32 ids (K, N) in
    [0, C), unchecked as in ``launch_codebook``)."""
    name = "clustered_matmul"
    _check_x(name, x)
    _check(name, x, ids, (torch.int8, torch.int32), "ids")
    m, k = x.shape
    if ids.dim() != 2 or ids.shape[0] != k:
        raise ValueError(f"{name}: ids must be (K={k}, N), got {tuple(ids.shape)}")
    n = ids.shape[1]
    c = _check_codebook(name, x, codebook, ids)
    if max(m * k, m * n, ids.numel()) >= 2**31:
        raise ValueError(f"{name}: operands past 2**31 elements")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _call(name, x.data_ptr(), int(x.dtype == torch.bfloat16), ids.data_ptr(),
          int(ids.dtype == torch.int32), codebook.data_ptr(), c, y.data_ptr(), m, k, n,
          _stream(x))
    return y
