"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Every ``*.cu`` under ``src/repro_torch/csrc/`` is a kernel with a plain C
entry point.  ``build()`` starts one ``nvcc -c`` per source, all at once,
links the objects into one shared library under ``build/`` at the root of
the checkout, and writes the compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) beside it.  The library's name carries a
hash of the sources and flags, so an edited source never loads a stale
build.  ``load_library()`` builds if needed, loads the library and declares
each entry point's C signature.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no CUDA toolkit.
"""
from __future__ import annotations

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

INT8_KERNELS = ("sonic_matvec_int8", "block_sparse_matmul_int8")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
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
    import ctypes

    lib = ctypes.CDLL(str(build()))
    # Every int8 block-sparse entry point has this C signature:
    #   int fn(const void* x, int x_is_bf16, const int8_t* values,
    #          const float* scales, const int* indices, float* y,
    #          int M, int K, int Nb, int R, int bk, int bn, cudaStream_t stream)
    # and returns cudaGetLastError() after its launch.
    argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    for name in INT8_KERNELS:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _is_pow2_le_128(v: int) -> bool:
    return 1 <= v <= 128 and v & (v - 1) == 0


def launch_int8(name: str, x: torch.Tensor, values: torch.Tensor,
                scales: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Check the operands, allocate y (M, Nb·bn) fp32 and launch the int8
    block-sparse entry point ``name`` on the current stream.  Raises on
    anything the kernels do not take, and if the launch reports an error."""
    if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x must be on the current CUDA device, got "
                         f"{x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 2 or values.dim() != 4:
        raise ValueError(f"{name}: want x (M, K) and values (Nb, R, bk, bn), "
                         f"got {tuple(x.shape)} and {tuple(values.shape)}")
    m, k = x.shape
    nb, r, bk, bn = values.shape
    for t, dt, what in ((values, torch.int8, "values"), (scales, torch.float32, "scales"),
                        (indices, torch.int32, "indices")):
        if t.dtype != dt or t.device != x.device:
            raise TypeError(f"{name}: {what} must be {dt} on {x.device}, "
                            f"got {t.dtype} on {t.device}")
    if tuple(scales.shape) != (nb, r) or tuple(indices.shape) != (nb, r):
        raise ValueError(f"{name}: scales and indices must be {(nb, r)}, got "
                         f"{tuple(scales.shape)} and {tuple(indices.shape)}")
    if not all(t.is_contiguous() for t in (x, values, scales, indices)):
        raise ValueError(f"{name}: operands must be contiguous")
    if not (_is_pow2_le_128(bk) and _is_pow2_le_128(bn)):
        raise ValueError(f"{name}: blocks must be powers of two up to 128, "
                         f"got {(bk, bn)}")
    if bn % 4 == 0 and values.data_ptr() % 4:
        raise ValueError(f"{name}: values must be 4-byte aligned for "
                         f"{bn}-wide blocks")
    if m < 1 or k % bk or not 1 <= r <= k // bk:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, values "
                         f"{tuple(values.shape)}")
    if max(m * k, m * nb * bn, values.numel()) >= 2**31:
        raise ValueError(f"{name}: operands past 2**31 elements")
    y = torch.empty((m, nb * bn), dtype=torch.float32, device=x.device)
    fn = getattr(load_library(), name)
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
             scales.data_ptr(), indices.data_ptr(), y.data_ptr(),
             m, k, nb, r, bk, bn, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return y
