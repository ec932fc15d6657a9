"""The port's photonic model (C4/C5 pricing) held against the JAX package's.

The device table, the accelerator and the baselines are pure Python; on the
same ``LayerWork`` list both packages' reports must be equal to the last
bit.  ``cnn_workload`` runs each package's own CNN forward on the same
weights and batch: its integer fields must be equal and its activation
sparsities within 1e-4 (a post-ReLU value within rounding of zero may fall
either way).  The reference's behaviour tests
(``tests/test_serve_photonic.py``) are held on the port's own workload.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.models.registry import get_arch as jax_get_arch
from repro.photonic import accelerator as jacc
from repro.photonic import baselines as jbase
from repro.photonic import devices as jdev
from repro.photonic import mapper as jmap
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import cnn
from repro_torch.photonic import accelerator, baselines, devices, mapper
from repro_torch.photonic.accelerator import SonicAccelerator, SonicHWConfig
from repro_torch.photonic.baselines import evaluate_all
from repro_torch.photonic.mapper import LayerWork, cnn_workload, lm_workload

WS = {f"conv{i}": 0.5 for i in range(6)} | {"fc0": 0.8}


@pytest.fixture(scope="module")
def cifar():
    """CIFAR10 CNN: the JAX params, the same carried across, one batch."""
    cfg = jcnn.PAPER_CNNS["cifar10"]
    jp = jcnn.init_params(cfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.array, jp), "cpu")
    x = np.random.default_rng(0).random((4, *cfg.input_hw)).astype(np.float32)
    return jp, params, x


def _port_work(jwork):
    return [LayerWork(**dataclasses.asdict(w)) for w in jwork]


def _tuple(report):
    return (report.name, report.fps, report.power_w, report.epb, report.fps_per_w)


def test_device_table_matches_jax_and_paper():
    assert {k: dataclasses.astuple(v) for k, v in devices.DEVICES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jdev.DEVICES.items()}
    for name in ("AVG_EO_SHIFT_NM", "TED_TO_DUTY", "ELECTRONIC_CTRL_W"):
        assert getattr(devices, name) == getattr(jdev, name)
    assert devices.DEVICES["eo_tuning"].latency_s == 20e-9
    assert devices.DEVICES["dac6"].power_w == 3e-3
    assert devices.DEVICES["adc16"].latency_s == 14e-9


def test_cnn_workload_matches_jax(cifar):
    jp, params, x = cifar
    want = jmap.cnn_workload(jcnn.PAPER_CNNS["cifar10"], jp, WS, sample=jnp.asarray(x))
    got = cnn_workload(cnn.PAPER_CNNS["cifar10"], params, WS, sample=torch.from_numpy(x))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert (g.name, g.kind, g.vec_len, g.n_products, g.weight_sparsity, g.reuse) == \
            (w.name, w.kind, w.vec_len, w.n_products, w.weight_sparsity, w.reuse)
        assert abs(g.act_sparsity - w.act_sparsity) <= 1e-4
        assert (g.macs, g.dense_macs_equiv, g.task_bits) == (w.macs, w.dense_macs_equiv,
                                                            w.task_bits)


def test_reports_equal_jax_on_the_same_work(cifar):
    jp, _, x = cifar
    jwork = jmap.cnn_workload(jcnn.PAPER_CNNS["cifar10"], jp, WS, sample=jnp.asarray(x))
    work = _port_work(jwork)
    want, got = jbase.evaluate_all(jwork), evaluate_all(work)
    assert list(got) == list(want)
    for name in want:
        assert _tuple(got[name]) == _tuple(want[name]), name
    for hw in [dict(), dict(weight_bits=16), dict(sparsity_gating=False),
               dict(compression=False), dict(n=3, m=12, N=40, K=8, adc_interleave=1)]:
        a = accelerator.SonicAccelerator(SonicHWConfig(**hw))
        b = jacc.SonicAccelerator(jacc.SonicHWConfig(**hw))
        assert _tuple(a.evaluate(work)) == _tuple(b.evaluate(jwork))
        assert [a.layer_passes(w) for w in work] == [b.layer_passes(w) for w in jwork]


def test_lm_workload_matches_jax():
    jcfg = jax_get_arch("tinyllama-1.1b").cfg
    cfg = get_config("tinyllama-1.1b")
    for args in [(), (0.5, 0.5), (0.25, 0.75, 4)]:
        got = [dataclasses.astuple(w) for w in lm_workload(cfg, *args)]
        assert got == [dataclasses.astuple(w) for w in jmap.lm_workload(jcfg, *args)]
    work = lm_workload(cfg, 0.5, 0.5)
    assert [_tuple(r) for r in evaluate_all(work).values()] == \
        [_tuple(r) for r in jbase.evaluate_all(jmap.lm_workload(jcfg, 0.5, 0.5)).values()]


def test_lm_workload_refuses_configs_it_does_not_price():
    """Once refused, now priced as the reference prices them: the hybrid
    and rwkv configs with the transformer's q / k / v / o and FFN layout
    (a deliberate reference behaviour), the same work and the same reports
    (``tests/test_torch_families.py`` holds MoE, gelu-MLP and tied
    configs)."""
    for arch_id in ("zamba2-7b", "rwkv6-3b"):
        cfg, jcfg = get_config(arch_id), jax_get_arch(arch_id).cfg
        for args in [(), (0.5, 0.5), (0.25, 0.75, 4)]:
            got = [dataclasses.astuple(w) for w in lm_workload(cfg, *args)]
            assert got == [dataclasses.astuple(w) for w in jmap.lm_workload(jcfg, *args)]
        work = lm_workload(cfg, 0.5, 0.5)
        assert [_tuple(r) for r in evaluate_all(work).values()] == \
            [_tuple(r) for r in jbase.evaluate_all(jmap.lm_workload(jcfg, 0.5, 0.5)).values()]


@pytest.fixture(scope="module")
def work():
    """The port's own CIFAR10 workload: its params from a seeded generator,
    its default sample."""
    cfg = cnn.PAPER_CNNS["cifar10"]
    return cnn_workload(cfg, cnn.init_params(cfg, torch.Generator().manual_seed(0)), WS)


def test_sonic_beats_every_photonic_baseline(work):
    reports = evaluate_all(work)
    s = reports["SONIC"]
    for name in ("CrossLight", "HolyLight", "LightBulb"):
        assert s.fps_per_w > reports[name].fps_per_w, name
        assert s.epb < reports[name].epb, name


def test_sonic_fps_per_w_ratios_in_paper_band(work):
    """Fig. 9 reproduction: ratios within the reference test's band."""
    paper = {"CrossLight": 2.94, "HolyLight": 13.8, "LightBulb": 3.08,
             "NullHop": 5.81, "RSNN": 4.02}
    reports = evaluate_all(work)
    s = reports["SONIC"]
    for name, expected in paper.items():
        ratio = s.fps_per_w / reports[name].fps_per_w
        assert 0.4 * expected <= ratio <= 2.0 * expected, (name, ratio, expected)


def test_each_mechanism_pays(work):
    """Gating saves power and energy, compression saves time, clustering
    cuts the weight-DAC power, and a conv layer amortises its retunes."""
    on = SonicAccelerator(SonicHWConfig()).evaluate(work)
    off = SonicAccelerator(SonicHWConfig(sparsity_gating=False)).evaluate(work)
    assert on.power_w < off.power_w and on.epb < off.epb
    assert on.fps > SonicAccelerator(SonicHWConfig(compression=False)).evaluate(work).fps
    assert on.power_w < SonicAccelerator(SonicHWConfig(weight_bits=16)).evaluate(work).power_w
    acc = SonicAccelerator(SonicHWConfig())
    conv = LayerWork("c", "conv", vec_len=50, n_products=10_000,
                     weight_sparsity=0.0, act_sparsity=0.0, reuse=1000)
    fc = LayerWork("f", "fc", vec_len=50, n_products=10_000,
                   weight_sparsity=0.0, act_sparsity=0.0, reuse=1)
    assert acc.layer_time(conv) < acc.layer_time(fc)


def test_package_exports_match_the_reference():
    import repro.photonic as jphot

    import repro_torch.photonic as phot
    for name in ("DEVICES", "DeviceParams", "SonicAccelerator", "SonicHWConfig", "LayerWork",
                 "cnn_workload", "lm_workload", "BASELINES", "evaluate_all"):
        assert hasattr(jphot, name) and hasattr(phot, name), name
    assert list(phot.BASELINES) == list(jphot.BASELINES) == list(baselines.BASELINES)
    assert mapper.LayerWork is phot.LayerWork
