"""A traced step's per-device statistics → the three roofline terms.

The port of ``repro.roofline.analysis``.  The reference reads XLA's
compiled program: ``cost_analysis()`` (HLO FLOPs and bytes per device),
``memory_analysis()`` (bytes per device) and the HLO text, whose
collectives it parses with their replica-group sizes and the trip counts
of the loops around them.  PyTorch compiles nothing here, so the port runs
the step once, eagerly, on fake tensors (``FakeTensorMode``, no data) over
a fake process group of the production size (``launch.dryrun``), and
counts what each device does:

  * ``DeviceCounter``, a ``TorchDispatchMode`` below DTensor (it lets
    DTensor turn every op into the local ops of one device first, and
    leaves out the ops DTensor's sharding propagation runs on fake tensors
    of the global shapes in a fake mode of its own), records
    every ``_c10d_functional`` collective with its kind, operand and result
    bytes and group size, and counts every local op's FLOPs with
    ``torch.utils.flop_counter``'s formulas (products only, as
    ``FlopCounterMode`` counts; the attention and WKV operators carry
    their own).  Eager execution runs every loop iteration, so no trip
    count has to be recovered: a collective inside a loop is recorded once
    per iteration.
  * ``torch.distributed._tools.mem_tracker.MemTracker`` (``device_mem_tracker``:
    the same view of one device's local ops) follows every live tensor of
    the device and gives the peak.

On a fake group over a CPU mesh DTensor turns an all-to-all into an
all-gather and a chunk (the CPU group has none); on a CUDA mesh it is an
all-to-all.

Collective cost model (per-device wire bytes, bidirectional ring), the
reference's:
  all-reduce       2 · bytes · (g−1)/g
  all-gather       out_bytes · (g−1)/g
  reduce-scatter   in_bytes · (g−1)/g
  all-to-all       bytes · (g−1)/g
  collective-permute  bytes
with g the collective's group size.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline.hw import H100, HWTarget

# functional collective → kind
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def ring_wire_bytes(kind: str, operand_bytes: float, result_bytes: float,
                    group_size: int) -> float:
    """Per-device wire bytes of one collective (the module doc's model)."""
    g = max(int(group_size), 1)
    ring = (g - 1) / g
    if kind == "all-reduce":
        return 2 * operand_bytes * ring
    if kind == "all-gather":
        return result_bytes * ring
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * ring
    return operand_bytes  # collective-permute


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    wire_bytes: float  # per-device ring cost
    group_size: int
    trip_count: int  # 1: every loop iteration is recorded by itself
    computation: str  # the functional op


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(group).size()


class DeviceCounter(TorchDispatchMode):
    """Records one device's collectives and counts its FLOPs (see the
    module doc)."""

    def __init__(self) -> None:
        super().__init__()
        self.collectives: list[CollectiveOp] = []
        self._flops = FlopCounterMode(display=False)
        self._mode = None

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._mode = active_fake_mode()  # the trace's; DTensor propagates in its own
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode

        if any(t is DTensor for t in types):
            return NotImplemented  # let DTensor run; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._mode:  # a sharding propagation's op
            return out
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            kind = _COLLECTIVES[packet.__name__]
            g = _group_size(args)
            operand = _nbytes(args[0])
            self.collectives.append(CollectiveOp(
                kind=kind, wire_bytes=ring_wire_bytes(kind, operand, _nbytes(out), g),
                group_size=g, trip_count=1, computation=packet.__name__))
        elif packet in self._flops.flop_registry:
            self._flops._count_flops(packet, out, args, kwargs)
        return out


def device_mem_tracker():
    """A ``MemTracker`` that, like ``DeviceCounter``, sees only one device's
    local ops: it lets DTensor desugar first and leaves out the ops of
    DTensor's sharding propagation (run in a fake mode other than the
    trace's), which some torch versions' ``MemTracker`` would count."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker

    class DeviceMemTracker(MemTracker):
        def __enter__(self):
            self._trace_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            if active_fake_mode() is not self._trace_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return DeviceMemTracker()


@dataclasses.dataclass
class CompiledStats:
    """Per-device statistics of one traced step.  ``hlo_bytes_per_dev``
    (XLA's bytes accessed) and ``alias_bytes`` (XLA's donated-buffer
    aliasing) have no counterpart in an eager trace: they are None."""

    hlo_flops_per_dev: float  # products' FLOPs of one device's local ops
    hlo_bytes_per_dev: float | None
    collective_bytes_per_dev: float  # ring wire bytes
    collective_counts: dict[str, int]
    collective_bytes_by_kind: dict[str, float]
    argument_bytes: float  # one device's shards of the step's inputs
    output_bytes: float  # … of its outputs
    temp_bytes: float  # peak − arguments
    alias_bytes: float | None
    peak_bytes_est: float  # the device's peak of live tensors (MemTracker)


def local_bytes(tree: Any) -> int:
    """Bytes one device holds of a tree of (D)Tensors."""
    from repro_torch.utils.tree import named_leaves

    total = 0
    for _, leaf in named_leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf._local_tensor
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def collect_stats(counter: DeviceCounter, argument_bytes: float, output_bytes: float,
                  peak_bytes: float) -> CompiledStats:
    counts: dict[str, int] = {}
    by_kind: dict[str, float] = {}
    for c in counter.collectives:
        counts[c.kind] = counts.get(c.kind, 0) + 1
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.wire_bytes
    return CompiledStats(
        hlo_flops_per_dev=float(counter.flops),
        hlo_bytes_per_dev=None,
        collective_bytes_per_dev=sum(c.wire_bytes for c in counter.collectives),
        collective_counts=counts,
        collective_bytes_by_kind=by_kind,
        argument_bytes=float(argument_bytes),
        output_bytes=float(output_bytes),
        temp_bytes=float(peak_bytes - argument_bytes),
        alias_bytes=None,
        peak_bytes_est=float(peak_bytes),
    )


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_fraction: float  # MODEL_FLOPS / executed FLOPs
    step_time_est_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    model_flops: float,
    exec_flops: float,
    hbm_bytes: float,
    collective_bytes_per_dev: float,
    n_chips: int,
    hw: HWTarget = H100,
) -> RooflineTerms:
    compute = exec_flops / (n_chips * hw.peak_flops_bf16)
    memory = hbm_bytes / (n_chips * hw.hbm_bw)
    collective = collective_bytes_per_dev / hw.ici_bw
    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)
    return RooflineTerms(
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        dominant=dominant,
        useful_fraction=model_flops / max(exec_flops, 1.0),
        step_time_est_s=max(terms.values()),
    )
