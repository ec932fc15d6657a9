"""A configuration brings its model by naming its family and reference
files: a model that no harness file names runs a traced cell through them
alone, a file that lacks a function of the contract fails when it is
loaded, and a configuration that names none gets the dense files."""
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import families
from bench.cells import HERE
from bench.testing import SEED, run_tiny, tiny

PLANTED = ("tiny-planted", "planted.py")


def test_a_model_brought_by_new_files_alone():
    model = tiny("tiny-planted").model
    family, reference = families.load(model), families.reference(model)
    family.CALLS.clear()
    reference.CALLS.clear()
    run = run_tiny("tiny-planted", trace=True)
    res = run["result"]
    assert res["correct"], res["checks"]
    assert set(family.CALLS) == set(families.FAMILY_FUNCTIONS), family.CALLS
    assert reference.CALLS["logit_gaps"] == 1
    # the traced run's model-step readings rest on the family's counts
    assert {"mfu.decode", "mfu.prefill"} <= set(res["metrics"])


def test_no_harness_file_names_the_planted_model():
    for path in HERE.rglob("*"):
        if (path.suffix in (".py", ".json") and "testdata" not in path.parts
                and path.name != Path(__file__).name):
            text = path.read_text()
            assert not any(name in text for name in PLANTED), path


@pytest.mark.parametrize("key,lacking", [("family", "decode_step"),
                                         ("reference", "logit_gaps")])
def test_a_file_lacking_a_function_fails_at_load(tmp_path, key, lacking):
    path = tmp_path / f"lacks_{lacking}.py"
    names = [f for f in families.FAMILY_FUNCTIONS if f != lacking] if key == "family" else []
    path.write_text("".join(f"def {f}(*args):\n    pass\n" for f in names))
    model = {**tiny().model, key: str(path)}
    load = families.load if key == "family" else families.reference
    with pytest.raises(ImportError, match=lacking) as err:
        load(model)
    assert str(path) in str(err.value)


def _readings(model: dict) -> dict:
    family, reference = families.load(model), families.reference(model)
    digest = hashlib.sha256()

    def walk(tree):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                walk(tree[key])
            else:
                digest.update(key.encode())
                digest.update(tree[key].contiguous().view(torch.uint8).numpy().tobytes())
    walk(family.param_tree(model, SEED, "cpu"))
    rng = np.random.default_rng(5)
    seqs = [(rng.integers(0, model["vocab_size"], 10), rng.integers(0, 512, 4).tolist())
            for _ in range(2)]
    return {"params": digest.hexdigest(),
            "decode": family.decode_step(model, [7, 300]),
            "prefill": family.prefill_chunk(model, [(0, 16, False), (32, 5, True)]),
            "int8": [family.int8_step_bound_s(model, m) for m in (1, 4, 32)],
            "gaps": reference.logit_gaps(model, SEED, "cpu", seqs, control=True)}


def test_the_default_family_and_reference_are_the_dense_files():
    model = tiny().model
    assert "family" not in model and "reference" not in model
    explicit = {**model, "family": "bench/families/dense.py", "reference": "bench/reference.py"}
    assert _readings(model) == _readings(explicit)
