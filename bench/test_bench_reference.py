"""The plain reference against the port on the tiny configuration: its
pruning and int8 blocks equal the port's, and the port's greedy tokens in
fp32 compute are the reference's best at every position."""
import numpy as np
import torch

from bench import reference
from bench.families import dense
from bench.testing import SEED, run_tiny, tiny


def test_reference_weights_are_the_ports():
    from repro_torch.core.sonic_layers import make_block_sparse_int8

    model = tiny().model
    comp = model["compression"]
    for name, layer in (("attn/wq", 0), ("ffn/wo", 1), ("lm_head", -1)):
        w = dense.projection(model, SEED, name, layer, "cpu")
        port = make_block_sparse_int8(w, comp["sparsity"], tuple(comp["block"])).dense()
        assert torch.equal(reference.served_weight(w, comp["block"], comp["sparsity"]), port)


def test_ports_fp32_greedy_tokens_are_the_references_best():
    from repro_torch.models.registry import Arch
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    model = tiny().model
    arch = dense.build_arch(model)
    arch = Arch(arch.arch_id, arch.cfg.replace(compute_dtype="float32"))
    comp = model["compression"]
    sc = ServeConfig(max_len=64, weight_quant="int8", weight_quant_sparsity=comp["sparsity"],
                     weight_quant_block=tuple(comp["block"]))
    with torch.inference_mode():
        eng = ServeEngine(arch, dense.param_tree(model, SEED, "cpu"), sc, device="cpu")
        prompts = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 12)))
        out = eng.generate(prompts, 8)
    seqs = [(prompts[i].numpy(), out[i].tolist()) for i in range(2)]
    got = reference.logit_gaps(model, SEED, "cpu", seqs)
    assert got["tokens"] == 16
    assert got["gap"] < 1e-4


def test_a_sound_run_is_correct():
    run = run_tiny()
    res = run["result"]
    assert res["correct"], res["checks"]
    assert run["info"]["compared_tokens"] >= 40
    assert res["failed"] == 0 and res["attempted"] == 12
    assert run["info"]["window_captures"] == 0
