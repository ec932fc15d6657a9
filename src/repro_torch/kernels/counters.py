"""The kernel wrappers' launch and route counters, read and written as one.

Each wrapper counts, in Python, the launches it issues (``.launches``) and
the route each took (``.routes``).  A launch recorded into a CUDA graph is
counted once, at capture, and not at all on replay, though each replay runs
it again.  ``serve.engine`` keeps the counters true per replay: it takes a
``snapshot`` before and after a capture, ``restore``s the first (a capture
runs nothing) and ``add``s the difference once per replay.  Callers reset
a counter by assigning a new value, so every function here reads the
attributes afresh.
"""
from __future__ import annotations

from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
from repro_torch.kernels.clustered_matmul import kernel as cm_kernel
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel
from repro_torch.kernels.sparse_matvec import kernel as smv_kernel

WRAPPERS = {
    "sonic_matvec_int8": sm_kernel.sonic_matvec_int8_kernel,
    "block_sparse_matmul_int8": bs_kernel.block_sparse_matmul_int8_kernel,
    "sonic_matvec": sm_kernel.sonic_matvec_kernel,
    "sonic_matmul": sm_kernel.sonic_matmul_kernel,
    "block_sparse_matmul": bs_kernel.block_sparse_matmul_kernel,
    "clustered_matmul": cm_kernel.clustered_matmul_kernel,
    "sparse_matvec": smv_kernel.sparse_matvec_kernel,
    "decode_attention": da_kernel.decode_attention_kernel,
}

Counts = dict[str, tuple[int, dict[str, int]]]


def snapshot() -> Counts:
    """Every wrapper's (launches, routes), copied."""
    return {name: (fn.launches, dict(fn.routes)) for name, fn in WRAPPERS.items()}


def restore(counts: Counts) -> None:
    for name, (launches, routes) in counts.items():
        WRAPPERS[name].launches = launches
        WRAPPERS[name].routes = dict(routes)


def diff(after: Counts, before: Counts) -> Counts:
    """What was counted between two snapshots."""
    return {name: (la - before[name][0],
                   {r: v - before[name][1].get(r, 0) for r, v in ra.items()})
            for name, (la, ra) in after.items()}


def add(delta: Counts, times: int = 1) -> None:
    """Count ``delta`` ``times`` over (the launches of that many replays)."""
    for name, (launches, routes) in delta.items():
        fn = WRAPPERS[name]
        fn.launches += times * launches
        for r, v in routes.items():
            fn.routes[r] = fn.routes.get(r, 0) + times * v
