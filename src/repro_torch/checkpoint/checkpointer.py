"""Atomic, async checkpointing in the reference's on-disk format.

The port of ``repro.checkpoint.checkpointer``.  Layout:

    <dir>/step_<n>/
        manifest.json   leaf shapes / dtypes + fingerprint
        arrays.npz      one entry per leaf, keyed by its path name
    <dir>/LATEST        atomic pointer (text, written last)

The leaf names are the reference's (``utils.tree.named_leaves``; a
``TrainState`` is named ``0/<params path>``, ``1/m/…``, ``1/v/…``,
``2/<masks path>``, ``3``), and so is the format, so a checkpoint crosses
between the two packages in both directions.  A bf16 leaf is stored as the
reference's ``np.savez`` stores one, 2-byte raw values (``|V2``) with
``bfloat16`` in the manifest, and is read back through the manifest's dtype.

Properties the tests verify: atomicity (a temp dir moved into place with
``os.replace``, LATEST written through a temp file after an fsync), keep-k
retention, async save (the leaves copied to the host first, then written by
a background thread; ``wait()`` joins), integrity (the manifest's leaf count
checked, and a leaf the template has but the checkpoint lacks raises
``IOError``).  ``restore`` places every leaf on its template leaf's device
(or on ``device``).

Sharded states (DTensor leaves): ``save`` gathers each leaf's logical value
on every rank (a collective, so every rank calls it), rank 0 alone writes,
and the save ends at a barrier; the files are the unsharded format, so any
mesh, or none, reads them.  ``restore(..., shardings=)`` (a tree of
``sharding.mesh.NamedSharding``), or a template of DTensors, puts every
leaf into that layout, each rank keeping its own block: the elastic
restore onto another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.mesh import distribute_copy
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import named_leaves, tree_map_with_path_names

log = get_logger("ckpt")

_BF16 = "bfloat16"


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf as numpy; bf16 as its raw 2-byte values."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a tensor; a ``bfloat16`` leaf's 2-byte values
    (``|V2``, or ml_dtypes' bf16 where numpy knows it) through int16."""
    if dtype_name == _BF16:
        return torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- save
    def save(self, state: Any, step: int, async_: bool = False) -> None:
        leaves = list(named_leaves(state))
        sharded = any(isinstance(leaf, DTensor) for _, leaf in leaves)
        host = [(name, arr, _BF16 if leaf.dtype == torch.bfloat16 else str(arr.dtype))
                for name, leaf in leaves
                for arr in [_host(leaf.full_tensor() if isinstance(leaf, DTensor) else leaf)]]
        if sharded:
            if dist.get_rank() == 0:
                self._save_sync(host, step)
            dist.barrier()
        elif async_:
            self.wait()
            self._thread = threading.Thread(target=self._save_sync, args=(host, step),
                                            daemon=True)
            self._thread.start()
        else:
            self._save_sync(host, step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, host: list, step: int) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = {name: arr for name, arr, _ in host}
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "treedef": "named leaves (repro_torch.utils.tree.named_leaves)",
            "leaves": {name: {"shape": list(arr.shape), "dtype": dt} for name, arr, dt in host},
            "fingerprint": {
                "n_leaves": len(flat),
                "total_bytes": int(sum(arr.nbytes for arr in flat.values())),
            },
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        log.info("saved checkpoint step=%d (%d leaves)", step, len(flat))

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, template: Any, step: int | None = None, device=None,
                shardings: Any | None = None) -> Any:
        """The checkpoint in the nesting of ``template`` (dicts, lists,
        ``TrainState``), each leaf on its template leaf's device, or on
        ``device`` when given.  ``shardings`` (a tree of ``NamedSharding``
        in the template's nesting) lays every leaf out on its mesh; a
        DTensor template leaf without one takes the template's layout."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            if len(data.files) != manifest["fingerprint"]["n_leaves"]:
                raise IOError(f"checkpoint step_{step} corrupt: leaf count mismatch")
            names = [name for name, _ in named_leaves(template)]
            missing = [n for n in names if n not in data.files]
            if missing:
                raise IOError(f"checkpoint step_{step} missing leaves: {missing[:5]}")
            arrays = {n: data[n] for n in names}

        def one(name: str, leaf: torch.Tensor) -> torch.Tensor:
            t = _tensor(arrays[name], manifest["leaves"][name]["dtype"])
            if tuple(t.shape) != tuple(leaf.shape):
                raise IOError(f"checkpoint step_{step}: {name} has shape {tuple(t.shape)}, "
                              f"the template {tuple(leaf.shape)}")
            t = t.to(device if device is not None else leaf.device)
            if name in layouts:
                return layouts[name].distribute(t)
            if isinstance(leaf, DTensor):
                return distribute_copy(t, leaf.device_mesh, leaf.placements)
            return t

        layouts = dict(named_leaves(shardings)) if shardings is not None else {}
        return tree_map_with_path_names(one, template)
