"""The yardstick's counts at mistral-nemo-12b's shapes against the kernel
table in PERF.md (PR 22's figures): 5,788,139,520 kept int8 bytes, a
1.742 ms bound at a decode step's 4 rows and 3.038 ms at a prefill's 256."""
import json

import pytest

from bench.families import dense as R
from bench.cells import HERE


def _model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_mistral_kept_bytes_and_bounds():
    m = _model("mistral-nemo-12b-sonic-int8")
    assert R.kept_params(m) == 5_788_139_520
    assert R.int8_step_bound_s(m, 4) * 1e3 == pytest.approx(1.742, abs=5e-4)
    assert R.int8_step_bound_s(m, 256) * 1e3 == pytest.approx(3.038, abs=5e-4)
    # 155 launches a step at tinyllama; mistral has 40 × 7 + 1
    layer, head = R.projections(m)
    assert len(layer) * m["num_hidden_layers"] + 1 == 281
    assert head.int8_bytes == 5120 * 131072 // 2


def test_decode_step_counts_live_rows_and_real_contexts():
    m = _model("internlm2-1.8b-sonic-int8")
    ops1, b1 = R.decode_step(m, [100])
    ops2, b2 = R.decode_step(m, [100, 300])
    assert ops2 - ops1 == pytest.approx(2 * R.kept_params(m) + R.attention_flops(m, 300))
    assert b2 - b1 == R.kv_bytes_per_token(m) * 301 + 2 * m["hidden_size"]
    # one step's weights are read once, whatever the rows
    assert b1 > R.kept_weight_bytes(m)


def test_prefill_chunk_counts_the_head_only_for_final_chunks():
    m = _model("mistral-nemo-12b-sonic-int8")
    ops_mid, bytes_mid = R.prefill_chunk(m, [(0, 256, False)])
    ops_fin, bytes_fin = R.prefill_chunk(m, [(0, 256, True)])
    head = R.kept_params(m) - R.kept_params(m, head=False)
    assert ops_fin - ops_mid == 2 * head
    assert bytes_fin - bytes_mid == R.kept_weight_bytes(m) - R.kept_weight_bytes(m, head=False)
    # attention over a prefix: token t of a chunk at 512 attends 512 + t + 1 positions
    ops_late, _ = R.prefill_chunk(m, [(512, 256, False)])
    assert ops_late - ops_mid == pytest.approx(R.attention_flops(m, 512 * 256))
