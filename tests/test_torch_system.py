"""The paper's system on the PyTorch port: sparsity-aware training → weight
clustering with accuracy retention (the Table 3 argument, §V.A), and the
port's two example drivers against the JAX package's.

``test_sparsify_cluster_accuracy_retention`` ports
``tests/test_system.py::test_sparsify_cluster_accuracy_retention`` on the
port's own modules (``models/cnn.py``, ``data/teacher.py``,
``core/sparsity.py``, ``core/clustering.py``), with the reference's recipe
and bounds: the MNIST CNN, 120 steps of plain SGD at lr 3e-3 on the
teacher task (seed 42), dense accuracy > 0.5; pruned to 50% (1×1 blocks)
and clustered to 64 centroids, accuracy > dense − 0.15; the first conv
kernel at least 0.4 zeros with at most 65 distinct values.  The port draws
its teacher and batches from ``torch.Generator``s, so its accuracies are
its own, not the reference's numbers.  The reference file's two other
cases have counterparts already: ``tests/test_torch_vdu.py`` holds the
photonic forward model's fidelity, and ``tests/test_torch_sonic_linear.py``
the serving formats, against JAX.

The examples: ``examples/photonic_paper_repro_torch.py`` on the reference's
CNN params (carried across with ``convert.params_from_jax``) and the
reference's activation sample prints the reference script's tables, every
number within 1e-6 relative (the tables round them; the reports behind
them are held within 1e-6 relative too).  ``examples/quickstart_torch.py``
runs on the CPU (12 greedy tokens from each engine, C1 sparsity 0.5) and
prices the full tinyllama-1.1b exactly as the reference's photonic model
does.
"""
import contextlib
import importlib.util
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core.clustering import ClusteringConfig, cluster_params
from repro_torch.core.sparsity import SparsityConfig, apply_masks, build_masks, sparsity_of
from repro_torch.data.teacher import TeacherTask
from repro_torch.models import cnn as cnn_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_cnn(task, cfg, steps=120, lr=3e-3):
    params = cnn_lib.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_() for layer in params.values() for lp in layer
              for t in lp.values()]
    for i in range(steps):
        x, y = task.batch(i)
        logits = cnn_lib.forward(params, cfg, x)
        loss = -torch.log_softmax(logits, -1).gather(1, y[:, None]).mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w.sub_(lr * g)
    return {k: [{n: t.detach() for n, t in lp.items()} for lp in v]
            for k, v in params.items()}


@pytest.fixture
def two_threads():
    """torch on two CPU threads meanwhile: the test run's workers share
    the cores, and at this size more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_sparsify_cluster_accuracy_retention(two_threads):
    """The paper's central accuracy claim (§V.A): sparsified + clustered
    models stay comparable to the dense baseline."""
    torch.manual_seed(0)
    cfg = cnn_lib.MNIST_CNN
    task = TeacherTask(cfg, seed=42)
    params = _train_cnn(task, cfg)
    with torch.no_grad():
        acc_dense = task.accuracy(params)
        assert acc_dense > 0.5, f"teacher task unlearnable ({acc_dense})"

        # sparsify at 50% + cluster to 64 centroids (Table 3 regime)
        scfg = SparsityConfig(target_sparsity=0.5, block=(1, 1), exclude=("bias",))
        sparse = apply_masks(params, build_masks(params, scfg))
        clustered, _ = cluster_params(sparse, ClusteringConfig(num_clusters=64,
                                                               exclude=("bias",)))
        acc_sc = task.accuracy(clustered)
    assert acc_sc > acc_dense - 0.15, (acc_dense, acc_sc)
    w = clustered["conv"][0]["kernel"]
    assert sparsity_of(w) >= 0.4  # zeros survived clustering (preserve_zero)
    assert len(torch.unique(w)) <= 64 + 1


def _numbers(text: str) -> list[float]:
    return [float(t) for t in re.findall(r"-?\d+(?:\.\d+)?", text)]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def test_photonic_paper_repro_prints_the_references_figures():
    from repro.models import cnn as jcnn
    from repro.photonic.accelerator import SonicAccelerator as JaxAccelerator
    from repro.photonic.baselines import evaluate_all as jax_evaluate_all
    from repro.photonic.mapper import cnn_workload as jax_cnn_workload

    cfg = jcnn.CIFAR10_CNN
    jparams = jcnn.init_params(cfg, jax.random.PRNGKey(0))
    # the reference script's activation sample (its ``cnn_workload`` default)
    jsample = jax.random.uniform(jax.random.PRNGKey(0), (4, *cfg.input_hw))
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        _example("photonic_paper_repro").main()

    port = _example("photonic_paper_repro_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = port.main(["--device", "cpu"],
                        params=params_from_jax(jax.tree_util.tree_map(np.array, jparams), "cpu"),
                        sample=torch.from_numpy(np.array(jsample)))
    want_lines, got_lines = ref_out.getvalue().splitlines(), out.getvalue().splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        assert re.sub(r"[-\d.]+", "#", g) == re.sub(r"[-\d.]+", "#", w), (g, w)
        gn, wn = _numbers(g), _numbers(w)
        assert len(gn) == len(wn) and all(_rel(a, b) <= REL for a, b in zip(gn, wn)), (g, w)

    work = jax_cnn_workload(cfg, jparams, {f"conv{i}": 0.5 for i in range(6)} | {"fc0": 0.8})
    want = {"platforms": jax_evaluate_all(work),
            "ablation": {n: JaxAccelerator(_jax_hw(hw)).evaluate(work)
                         for n, hw in port.VARIANTS.items()}}
    for table in ("platforms", "ablation"):
        assert list(got[table]) == list(want[table])
        for name, r in got[table].items():
            w = want[table][name]
            for field in ("fps", "power_w", "fps_per_w", "epb"):
                assert _rel(getattr(r, field), getattr(w, field)) <= REL, (table, name, field)


def _jax_hw(hw):
    import dataclasses

    from repro.photonic.accelerator import SonicHWConfig as JaxHW

    return JaxHW(**dataclasses.asdict(hw))


@pytest.mark.parametrize("device", ["cpu"])
def test_quickstart_runs_and_prices_as_the_reference(device):
    from repro.models.registry import get_arch as jax_get_arch
    from repro.photonic.baselines import evaluate_all as jax_evaluate_all
    from repro.photonic.mapper import lm_workload as jax_lm_workload

    with contextlib.redirect_stdout(io.StringIO()):
        got = _example("quickstart_torch").main(["--device", device])
    assert got["dense"].shape == got["sonic"].shape == (2, 12)
    assert ((got["dense"] >= 0) & (got["dense"] < 256)).all()
    assert abs(got["c1_sparsity"] - 0.5) < 0.01
    assert got["c2_ratio"] > 1.0
    want = jax_evaluate_all(jax_lm_workload(jax_get_arch("tinyllama-1.1b").cfg,
                                            weight_sparsity=0.5, act_sparsity=0.5))
    assert list(got["reports"]) == list(want)
    for name, r in got["reports"].items():
        for field in ("fps", "power_w", "fps_per_w", "epb"):
            assert getattr(r, field) == getattr(want[name], field), (name, field)
