"""The speculative drafters of the port held against the JAX package's, and
the configurations a speculative engine refuses (the drafter, fallback and
refusal cases of ``tests/test_serve_spec.py`` are the checklist).

``sparse_draft_params`` keeps the self-drafter block-sparse (the reference
densifies it): its leaves, densified, equal the reference's drafter to
2e-5 (the clustered one within ``tests/test_torch_clustering.py``'s
codebook tolerance, near-tie ids aside), and one drafter forward's logits
equal JAX's dense forward's to 2e-5.  Through the scheduler (the set-up of
``tests/torch_scheduler_pair.py``, fp32 compute) a self-drafter gives JAX's
tokens and host counters; its acceptance histogram is not held to JAX's,
since the port's block-sparse product rounds differently from JAX's dense
einsum, so a near-tie draft may go the other way.  Every refusal raises
``ValueError``, where the reference asserts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sonic_layers as jsl
from repro.models.registry import get_arch as jax_get_arch
from repro.sharding.mesh import MeshPlan
from repro_torch.convert import params_from_jax
from repro_torch.core.sonic_layers import (draft_leaf_dense, quantize_serve_params,
                                           sparse_draft_params, truncated_draft_params)
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine, SpecConfig
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import MAX_LEN, generate, prompts_of, sides_fixture, spec_parity

LENS = [3, 5, 8, 13, 5, 8]
NEWS = [9, 2, 5, 16, 1, 7]
DENSE = dict(weight_quant="none")  # the verifier unquantized: "self" at 0.0 is exact
CB_TOL = 1e-5  # tests/test_torch_clustering.py's codebook tolerance
KERNELS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo"))


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


@pytest.fixture(scope="module")
def raw():
    """The reduced model's params in both packages (JAX, port)."""
    jraw = jax_get_arch("tinyllama-1.1b", reduced=True).init_params(jax.random.PRNGKey(0))
    return jraw, params_from_jax(jax.tree_util.tree_map(np.array, jraw), "cpu")


def _arch32():
    arch = get_arch("tinyllama-1.1b", reduced=True)
    return dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="float32"))


# ------------------------------------------------------------ conversion


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.75])
def test_sparse_draft_leaves_equal_jax_drafter(raw, sparsity):
    jraw, traw = raw
    want = jsl.sparse_draft_params(jraw, sparsity)
    got = sparse_draft_params(traw, sparsity)
    for a, b in KERNELS:
        w = np.asarray(want["layers"][a][b]["kernel"])
        leaf = got["layers"][a][b]
        assert set(leaf) == {"bsvalues", "bsindices"} and leaf["bsvalues"].dim() == 5
        dense = draft_leaf_dense(leaf, w.shape[1]).numpy()
        np.testing.assert_allclose(dense, w, rtol=0, atol=2e-5)
        if sparsity == 0.0:  # every block kept: the served weights exactly
            np.testing.assert_array_equal(dense, np.asarray(jraw["layers"][a][b]["kernel"]))
    for name in ("embed", "final_norm", "lm_head"):
        assert got[name] is traw[name]
    assert got["layers"]["ln1"]["scale"] is traw["layers"]["ln1"]["scale"]


def test_sparse_draft_values_in_the_compute_type(raw):
    got = sparse_draft_params(raw[1], 0.75, dtype=torch.bfloat16)
    leaf = got["layers"]["attn"]["wq"]
    assert leaf["bsvalues"].dtype == torch.bfloat16 and leaf["bsindices"].dtype == torch.int32
    fp32 = sparse_draft_params(raw[1], 0.75)["layers"]["attn"]["wq"]
    assert torch.equal(leaf["bsvalues"], fp32["bsvalues"].to(torch.bfloat16))
    # the head is cast once, as the reference casts it at every use
    head = got["lm_head"]["kernel"]
    assert torch.equal(head, raw[1]["lm_head"]["kernel"].to(torch.bfloat16))
    assert got["embed"] is raw[1]["embed"]


def test_clustered_draft_within_codebook_tolerance(raw):
    """With a codebook each layer matrix takes at most C values besides the
    pruned zeros, and equals the reference's drafter within the codebook
    tolerance but for near-tie weights."""
    jraw, traw = raw
    want = jsl.sparse_draft_params(jraw, 0.5, num_clusters=8)
    got = sparse_draft_params(traw, 0.5, num_clusters=8)
    for a, b in KERNELS:
        w = np.asarray(want["layers"][a][b]["kernel"])
        dense = draft_leaf_dense(got["layers"][a][b], w.shape[1]).numpy()
        assert all(len(np.unique(dense[i])) <= 9 for i in range(dense.shape[0]))
        off = np.abs(dense - w) > 2 * CB_TOL
        assert off.mean() < 1e-3, (a, b, off.mean())


def test_truncated_draft_slices_and_shares(raw):
    traw = raw[1]
    trunc = truncated_draft_params(traw, 1)
    for a, b in KERNELS:
        leaf = trunc["layers"][a][b]["kernel"]
        assert leaf.shape[0] == 1
        assert leaf.data_ptr() == traw["layers"][a][b]["kernel"].data_ptr()  # a view
    assert trunc["embed"]["embedding"] is traw["embed"]["embedding"]
    q = quantize_serve_params(traw, 0.5, (16, 16))
    tq = truncated_draft_params(q, 1)
    assert tq["layers"]["attn"]["wq"]["qvalues"].shape[0] == 1
    assert tq["lm_head"] is q["lm_head"]


@pytest.mark.parametrize("sparsity", [0.0, 0.75])
def test_draft_forward_logits_equal_jax(raw, sparsity):
    """One forward of the self-drafter, on block_sparse_matmul's plain
    version, against JAX's densified drafter: logits within 2e-5."""
    jraw, traw = raw
    jarch = jax_get_arch("tinyllama-1.1b", reduced=True)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.replace(compute_dtype="float32"))
    tokens = prompts_of([12], 5)[0][None]
    want, _ = jarch.forward(jsl.sparse_draft_params(jraw, sparsity), MeshPlan(),
                            tokens=jnp.asarray(tokens))
    got, _ = _arch32().forward(sparse_draft_params(traw, sparsity),
                               tokens=torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


# ------------------------------------------------- through the scheduler


def full_acceptance_hist(news, k: int) -> dict[int, int]:
    """The accepted-length histogram when every draft is accepted: a
    request of n new tokens decodes n − 1 after its prefill's first, in
    (n − 1) // (k + 1) rounds of k + 1 and, where a remainder is left, one
    round of it at its budget's edge (segment and admission boundaries fall
    between rounds, so they split none)."""
    hist: dict[int, int] = {}
    for n in news:
        for size, count in ((k + 1, (n - 1) // (k + 1)), ((n - 1) % (k + 1), 1)):
            if size and count:
                hist[size] = hist.get(size, 0) + count
    return hist


def test_exact_drafter_accepts_everything(sides):
    """At sparsity 0 the self-drafter is the unquantized verifier's own
    weights: every draft is accepted, so every round emits k + 1 but one
    at each budget's edge."""
    spec = SpecConfig(k=2, draft="self", draft_sparsity=0.0)
    got, sched = spec_parity(sides, spec, prompts_of(LENS), NEWS, engine_kw=DENSE)
    oracle = sides(**DENSE)[1]
    assert got == [generate(oracle, p, n) for p, n in zip(prompts_of(LENS), NEWS)]
    assert sched.stats["accepted_hist"] == full_acceptance_hist(NEWS, spec.k)


def test_sparse_self_drafter_gives_jax_tokens(sides):
    """A 75%-sparse self-drafter changes only how many drafts are accepted,
    never the tokens."""
    spec = SpecConfig(k=4, draft="self", draft_sparsity=0.75)
    got, sched = spec_parity(sides, spec, prompts_of(LENS), NEWS)
    oracle = sides()[1]
    assert got == [generate(oracle, p, n) for p, n in zip(prompts_of(LENS), NEWS)]
    assert sched.stats["spec_steps"] > 0


def test_max_new_boundary_within_window(sides):
    """Budgets that run out inside the window (max_new 1, 2, 5 at k = 4)
    stop acceptance on the device as the sequential limit does."""
    spec = SpecConfig(k=4, draft="self", draft_sparsity=0.0)
    got, _ = spec_parity(sides, spec, prompts_of(LENS), NEWS, engine_kw=DENSE, n_slots=2)
    oracle = sides(**DENSE)[1]
    for toks, p, n in zip(got, prompts_of(LENS), NEWS):
        assert len(toks) == n and toks == generate(oracle, p, n)


# --------------------------------------------------- fallback / refusals


def _engine(traw, arch=None, **kw):
    sc = ServeConfig(max_len=MAX_LEN, block_len=8, **kw)
    return ServeEngine(arch or _arch32(), traw, sc, device="cpu")


def test_spec_skip_reason_is_the_chunked_prefill_one():
    arch = get_arch("tinyllama-1.1b", reduced=True)
    assert arch.supports_spec_decode and arch.spec_decode_skip_reason() == ""
    for arch_id in ("rwkv6-3b", "zamba2-7b"):
        other = get_arch(arch_id, reduced=True)
        reason = other.spec_decode_skip_reason()
        assert reason and reason == other.chunked_prefill_skip_reason()


@pytest.mark.parametrize("arch_id", ["rwkv6-3b", "zamba2-7b"])
def test_spec_falls_back_on_a_family_that_cannot_speculate(arch_id):
    """The reason is recorded and the scheduler serves plain decoding (the
    real reduced recurrent archs, their own seeded params)."""
    other = get_arch(arch_id, reduced=True)
    params = other.init_params(torch.Generator().manual_seed(0), "cpu")
    eng = _engine(params, other, spec=SpecConfig(k=2, draft="truncate:1"))
    assert eng.spec is None and eng.spec_skip_reason == other.spec_decode_skip_reason()
    sched = ContinuousScheduler(eng, n_slots=1)
    h = sched.submit(np.arange(1, 5, dtype=np.int32), 4)
    sched.run()
    assert sched.spec is None and sched.spec_k == 0
    assert sched.stats["spec_skip_reason"] == eng.spec_skip_reason
    assert len(h.tokens) == 4 and sched.stats["spec_steps"] == 0


@pytest.mark.parametrize("bad, match", [
    (dict(temperature=0.7, spec=SpecConfig(k=2)), "greedy-only"),
    (dict(kv_layout="paged", block_len=4, spec=SpecConfig(k=4, draft="truncate:1")),
     "scratch block"),
    (dict(kv_layout="paged", spec=SpecConfig(k=8, draft="truncate:1")), "scratch block"),
    (dict(spec=SpecConfig(k=2, draft="truncate:3")), "2 layers"),
])
def test_spec_refusals_raise(raw, bad, match):
    sc = {"max_len": MAX_LEN, "block_len": 8, **bad}
    with pytest.raises(ValueError, match=match):
        ServeEngine(_arch32(), raw[1], ServeConfig(**sc), device="cpu")


def test_self_drafter_refuses_a_quantized_tree(raw):
    """The self-drafter prunes the raw weights: an engine handed a tree that
    is already int8 raises instead of dropping speculation."""
    q = quantize_serve_params(raw[1], 0.5, (16, 16))
    with pytest.raises(ValueError, match="raw params"):
        _engine(q, spec=SpecConfig(k=2, draft="self"))
    eng = _engine(q, spec=SpecConfig(k=2, draft="truncate:1"))  # truncation needs none
    assert eng.draft_cfg.n_layers == 1


@pytest.mark.parametrize("bad", [dict(k=0), dict(draft_sparsity=1.0),
                                 dict(draft_sparsity=-0.1), dict(draft="truncate:0"),
                                 dict(draft="truncate:x"), dict(draft="layers:2")])
def test_spec_config_validates(bad):
    with pytest.raises(ValueError):
        SpecConfig(**bad)


# ------------------------------------------------------------- launcher


def test_launch_serve_spec_cpu():
    """The poisson workload with a truncated drafter retires every request
    and reports the acceptance histogram."""
    from repro_torch.launch import serve

    args = serve.parse_args(["--reduced", "--device", "cpu", "--workload", "poisson",
                             "--n-requests", "6", "--rate", "1000", "--new-tokens", "12",
                             "--spec-k", "2", "--spec-draft", "truncate:1"])
    eng = serve.build_engine(args)
    assert eng.spec.k == 2 and eng.sc.max_len == args.prompt_len + 12 + 1 + 2
    useful, total, sched, handles = serve.run_poisson(eng, args, verbose=False)
    out = serve.report_poisson(eng, useful, total, sched, handles)
    assert sched.stats["admitted"] == sched.stats["retired"] == 6
    hist = sched.stats["accepted_hist"]
    assert out["spec_steps"] == sum(hist.values()) > 0
    assert out["accepted_per_round"] == sum(n * c for n, c in hist.items()) / out["spec_steps"]


@pytest.mark.parametrize("argv", [["--spec-k", "2"],
                                  ["--workload", "poisson", "--spec-k", "2",
                                   "--temperature", "0.5"],
                                  ["--workload", "poisson", "--spec-k", "-1"]])
def test_launch_serve_spec_flags_checked(argv):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.parse_args(["--reduced", "--device", "cpu", *argv])
