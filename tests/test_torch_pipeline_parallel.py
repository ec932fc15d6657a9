"""GPipe pipeline parallelism (``sharding/pipeline.py``) on 8 CPU ranks
(``gloo``, the (2, 4) debug mesh, the stages on its model axis) against the
sequential stack, the reference's test (``tests/test_pipeline.py``): S = 4
stages of tanh(x @ W), M = 6 microbatches of 2 rows, D = 16, the JAX
package's weights and input.  Tolerance: ≤ 1e-5 against the sequential
stack (the reference's bound), in torch and in JAX; the stages whole on
every rank and sharded on the axis give the same bits.  ``bubble_fraction``
equals the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.sharding.pipeline import bubble_fraction as jax_bubble_fraction
from repro_torch.sharding.pipeline import bubble_fraction
from torch_mesh_workers import run_ranks

S, M, MB, D = 4, 6, 2, 16


def test_bubble_fraction_equals_the_reference():
    for s in range(1, 9):
        for m in (1, 4, 6, 32):
            assert bubble_fraction(s, m) == jax_bubble_fraction(s, m)
    assert bubble_fraction(4, 4) == 3 / 7


def test_pipeline_matches_sequential(tmp_path):
    ws = np.array(jax.random.normal(jax.random.PRNGKey(0), (S, D, D)) * 0.3)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (M, MB, D)))
    ref = jnp.asarray(x)
    for i in range(S):
        ref = jnp.tanh(ref @ ws[i])
    out = run_ranks("check_pipeline", 8, tmp_path, ws=ws, x=x)
    assert out["same"] == 1
    assert np.abs(out["pipelined"] - out["sequential"]).max() <= 1e-5
    assert np.abs(out["pipelined"] - np.asarray(ref)).max() <= 1e-5
