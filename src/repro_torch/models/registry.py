"""Arch registry: maps every ``--arch`` id to its config and model module,
with the serving support rules (the reference's skip reasons) and the
cache contracts.

A counterpart of ``repro.models.registry``.  Every family is ported:
``_module_for`` dispatches as the reference's does, to ``models.hybrid``
(zamba2), ``models.rwkv_model`` (rwkv6) or ``models.transformer`` (dense,
MoE, encoder, VLM).  The reference checks its cache contracts with
``jax.eval_shape``; the port runs the same forwards for real on the
``meta`` device (shapes and dtypes, no data, so a full-width config costs
nothing), over raw params made there, fed tokens, embeddings or M-RoPE
positions as the arch's ``input_kind`` says.

Cache layout contract (as in the reference): every cache leaf carries the
batch / slot axis on ``CACHE_SLOT_AXIS`` (the transformer's and the rwkv
states' leading axis is the layer, the hybrid's attention leaves' the
shared block's invocation); a paged pool's leaves are (n_layers, n_blocks,
block_len, …) with the block axis on ``CACHE_BLOCK_AXIS``.  The slot and
block helpers below write in place and return the cache.

Sharding (the reference's ``input_specs`` and ``cache_shardings``): every
model input of an (arch × shape) cell has a ``TensorSpec`` (shape, dtype
and, with a mesh, its ``NamedSharding``), the dry run's abstract inputs;
``Arch.init_cache(..., plan=)`` lays a cache out on the plan's mesh by the
same rules, and ``Arch.forward(..., plan=)`` shards the forward.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models import hybrid, rwkv_model, transformer
from repro_torch.sharding.mesh import MeshPlan, NamedSharding
from repro_torch.utils.tree import tree_map_with_path_names

META = torch.device("meta")

_INPUT_KIND = {
    "hubert-xlarge": "embeds",
    "qwen2-vl-2b": "embeds+mrope",
}


def _module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "hybrid":
        return hybrid
    if cfg.rwkv_head_size:
        return rwkv_model
    return transformer


@dataclasses.dataclass(frozen=True)
class Arch:
    arch_id: str
    cfg: ModelConfig

    @property
    def input_kind(self) -> str:
        """What the arch's forward is fed: "tokens", "embeds" or
        "embeds+mrope" (the reference's stubbed modality frontends)."""
        return _INPUT_KIND.get(self.arch_id, "tokens")

    @property
    def module(self) -> ModuleType:
        """``models.transformer``, ``models.hybrid`` or ``models.rwkv_model``."""
        return _module_for(self.cfg)

    @property
    def recurrent(self) -> bool:
        """Whether the cache carries recurrent state, which a forward
        advances wherever it runs (its ``advance`` mask holds it)."""
        return self.module is not transformer

    def init_params(self, gen: torch.Generator | None, device,
                    cfg: ModelConfig | None = None):
        return self.module.init_params(cfg or self.cfg, gen, device)

    def abstract_params(self, cfg: ModelConfig | None = None):
        """The param tree on the ``meta`` device: the reference's leaf names,
        shapes and dtypes, no data."""
        return self.init_params(None, META, cfg)

    def forward(self, params, cfg: ModelConfig | None = None, plan: MeshPlan | None = None,
                **kw):
        return self.module.forward(params, cfg or self.cfg, plan=plan, **kw)

    def init_cache(self, batch: int, max_len: int, device, cfg: ModelConfig | None = None,
                   cache_quant_int8: bool = False, plan: MeshPlan | None = None,
                   dtype: torch.dtype | None = None):
        """The family's serving cache; ``cache_quant_int8`` is the
        reference's ``MeshPlan.cache_quant_int8`` (int8 k / v and fp32
        scales; the recurrent families ignore it, as the reference's do).
        With a meshed ``plan`` every leaf is a DTensor of zeros laid out by
        ``cache_shardings`` (each rank allocates its shard only).  ``dtype``
        replaces the family's default type of the KV / shift leaves."""
        cfg = cfg or self.cfg
        if plan is None or plan.mesh is None:
            kw = {} if dtype is None else {"dtype": dtype}
            return self.module.init_cache(cfg, batch, max_len, device,
                                          cache_quant_int8=cache_quant_int8, plan=plan, **kw)
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import zeros

        with unset_fake_temporarily():  # shapes only: no device's tensors
            abstract = self.abstract_cache(batch, max_len, plan, cfg, cache_quant_int8, dtype)
        specs = cache_shardings(self, abstract, plan, cfg)
        return tree_map_with_path_names(
            lambda _, t: zeros(t.shape, dtype=t.dtype, device_mesh=plan.mesh,
                               placements=t.sharding.placements), specs)

    def abstract_cache(self, batch: int, max_len: int, plan: MeshPlan | None = None,
                       cfg: ModelConfig | None = None, cache_quant_int8: bool = False,
                       dtype: torch.dtype | None = None):
        """The cache's leaves on the ``meta`` device."""
        kw = {} if dtype is None else {"dtype": dtype}
        return self.module.init_cache(cfg or self.cfg, batch, max_len, META,
                                      cache_quant_int8=cache_quant_int8, plan=plan, **kw)

    # -- chunked prefill, speculative decoding, paged KV (serving) ----------
    @property
    def supports_chunked_prefill(self) -> bool:
        return self.chunked_prefill_skip_reason() == ""

    def chunked_prefill_skip_reason(self) -> str:
        """'' when the family can resume prefill at a nonzero start position
        over an existing cache prefix, else why not (the reference's
        strings)."""
        if self.cfg.encoder_only:
            return "encoder-only arch has no decode step"
        if self.recurrent:
            return self.module.CHUNKED_REASON
        return ""

    @property
    def supports_spec_decode(self) -> bool:
        return self.spec_decode_skip_reason() == ""

    def spec_decode_skip_reason(self) -> str:
        """The verify pass is a chunk-resume forward (``decode_chunk``) plus
        cursor rollback over a growing KV cache, so the support matrix is the
        chunked-prefill one.  The int8 KV cache is not excluded: verify rows
        attend the values sequential decode attends."""
        return self.chunked_prefill_skip_reason()

    @property
    def supports_paged_kv(self) -> bool:
        return self.paged_skip_reason() == ""

    def paged_skip_reason(self) -> str:
        """'' when the family supports the paged-KV serving layout, else why
        not (the reference's strings)."""
        if self.cfg.encoder_only:
            return "encoder-only arch has no decode step"
        if self.recurrent:
            return self.module.PAGED_REASON
        return ""

    def init_paged_cache(self, n_blocks: int, block_len: int, device,
                         cfg: ModelConfig | None = None, cache_quant_int8: bool = False):
        reason = self.paged_skip_reason()
        if reason:
            raise NotImplementedError(f"{self.arch_id}: {reason}")
        return transformer.init_paged_cache(cfg or self.cfg, n_blocks, block_len, device,
                                            cache_quant_int8=cache_quant_int8)

    # -- shape support (the reference's skip matrix) ------------------------
    def supports(self, shape: ShapeSpec) -> tuple[bool, str]:
        if shape.kind == "decode" and self.cfg.encoder_only:
            return False, "encoder-only arch has no decode step"
        if shape.name == "long_500k" and not self.cfg.is_subquadratic:
            return False, (
                "pure full-attention arch: 500k-token decode requires "
                "sub-quadratic attention (skip noted in DESIGN.md §4)"
            )
        return True, ""


def get_arch(arch_id: str, reduced: bool = False) -> Arch:
    cfg = reduced_config(arch_id) if reduced else get_config(arch_id)
    return Arch(arch_id=arch_id, cfg=cfg)


# ------------------------------------------------------------ slot caches

CACHE_SLOT_AXIS = 1  # every cache leaf is (n_layers or n_invocations, B, …)
CACHE_BLOCK_AXIS = 1  # paged pools put the block axis where the slot axis is


def write_cache_slot(cache: dict, sub_cache: dict, slot: int | torch.Tensor) -> dict:
    """Write a batch-1 sub-cache into row ``slot`` of a slot cache, in place;
    no other slot's rows are touched (``check_slot_cache_contract``).
    ``slot`` may be a tensor, as the reference's may be traced; it clamps
    into range as ``dynamic_update_slice_in_dim`` clamps it."""
    for name, full in cache.items():
        one = sub_cache[name]
        s = torch.clamp(torch.as_tensor(slot, device=full.device), 0,
                        full.shape[CACHE_SLOT_AXIS] - 1)
        full.index_copy_(CACHE_SLOT_AXIS, s.reshape(1).long(), one.to(full.dtype))
    return cache


def gather_cache_slots(cache: dict, slots: torch.Tensor) -> dict:
    """Rows ``slots`` (B,) of a slot cache as a batch-B sub-cache (a copy).
    Out-of-range ids (the masked dummy rows of a fixed-width launch) clamp
    to the last slot, as the reference's mode="clip"."""
    return {name: full.index_select(
        CACHE_SLOT_AXIS, torch.clamp(slots.long(), 0, full.shape[CACHE_SLOT_AXIS] - 1))
        for name, full in cache.items()}


def write_cache_slots(cache: dict, sub_cache: dict, slots: torch.Tensor) -> dict:
    """Scatter B sub-cache rows back into slots ``slots`` (B,), in place.
    Real slot ids are distinct (one request per slot); out-of-range ids drop,
    as the reference's mode="drop", with no host sync: each is sent to the
    first real row's slot with that row's values (or, with no real row, to
    rewrite what its clamped slot holds), so no slot gets two values."""
    for name, full in cache.items():
        n = full.shape[CACHE_SLOT_AXIS]
        valid = (slots >= 0) & (slots < n)
        first = torch.argmax(valid.to(torch.int32)).reshape(1)  # 0 when none is real
        target = torch.clamp(slots.long(), 0, n - 1)
        rows = sub_cache[name].to(full.dtype)
        sink = torch.where(valid[first], rows.index_select(CACHE_SLOT_AXIS, first),
                           full.index_select(CACHE_SLOT_AXIS, target[first]))
        shape = [1] * rows.dim()
        shape[CACHE_SLOT_AXIS] = -1
        full.index_copy_(CACHE_SLOT_AXIS, torch.where(valid, target, target[first]),
                         torch.where(valid.view(shape), rows, sink))
    return cache


def write_cache_block(cache: dict, sub_cache: dict, blocks: torch.Tensor) -> dict:
    """Install a batch-1 prefill cache, leaves (L, 1, nb·block_len, …), into
    the physical blocks ``blocks`` (nb,) of a paged pool, in place (ids are
    distinct by the allocator's contract; no other block is touched)."""
    nb = blocks.shape[0]
    for name, full in cache.items():
        one = sub_cache[name]
        bl = full.shape[CACHE_BLOCK_AXIS + 1]
        if one.shape[2] != nb * bl:
            raise ValueError(f"{name}: sub-cache length {one.shape[2]} is not "
                             f"{nb} blocks of {bl}")
        o = one[:, 0].reshape(one.shape[0], nb, bl, *one.shape[3:]).to(full.dtype)
        full.index_copy_(CACHE_BLOCK_AXIS, blocks.long(), o)
    return cache


# -------------------------------------------------------- cache contracts


def _specs(cache: dict) -> dict:
    return {name: (tuple(t.shape), t.dtype) for name, t in cache.items()}


def _assert_same(arch: Arch, a: dict, b: dict, what: str) -> None:
    if list(a) != list(b):
        raise AssertionError(f"{arch.arch_id}: {what} changed the cache leaves "
                             f"{list(a)} → {list(b)}")
    bad = [(n, a[n], b[n]) for n in a if a[n] != b[n]]
    if bad:
        raise AssertionError(f"{arch.arch_id}: {what} changed leaf specs: {bad}")


def _meta_params(arch: Arch, cfg: ModelConfig):
    return arch.init_params(None, META, cfg)


def _inputs(arch: Arch, cfg: ModelConfig, b: int, s: int) -> dict:
    """Meta inputs of a (b, s) forward, as the arch's ``input_kind`` says."""
    if arch.input_kind == "tokens":
        return {"tokens": torch.zeros((b, s), dtype=torch.long, device=META)}
    kw = {"embeds": torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16, device=META)}
    if arch.input_kind == "embeds+mrope":
        kw["positions"] = torch.zeros((b, 3, s), dtype=torch.long, device=META)
    return kw


def check_decode_cache_carry(arch: Arch, batch: int = 2, max_len: int = 8,
                             cfg: ModelConfig | None = None,
                             cache_quant_int8: bool = False) -> None:
    """One decode step must map the cache to the same leaves (names,
    shapes, dtypes): the contract the captured decode step relies on, since
    it updates the engine's cache in place."""
    cfg = cfg or arch.cfg
    cache = arch.init_cache(batch, max_len, META, cfg, cache_quant_int8)
    before = _specs(cache)
    _, out = arch.forward(_meta_params(arch, cfg), cfg, **_inputs(arch, cfg, batch, 1), cache=cache,
                          cache_pos=torch.zeros((batch,), dtype=torch.long, device=META))
    _assert_same(arch, before, _specs(out), "decode")


def check_slot_cache_contract(arch: Arch, max_len: int = 8, cfg: ModelConfig | None = None,
                              cache_quant_int8: bool = False) -> None:
    """The batch dim of every cache leaf, and only it, lives on axis
    ``CACHE_SLOT_AXIS``: checked by comparing caches at two batch sizes."""
    cfg = cfg or arch.cfg
    a, b = 3, 5
    ca = _specs(arch.init_cache(a, max_len, META, cfg, cache_quant_int8))
    cb = _specs(arch.init_cache(b, max_len, META, cfg, cache_quant_int8))
    if list(ca) != list(cb):
        raise AssertionError(f"{arch.arch_id}: cache leaves depend on batch size")
    bad = [(n, ca[n], cb[n]) for n in ca
           if ca[n][1] != cb[n][1] or ca[n][0][CACHE_SLOT_AXIS] != a
           or cb[n][0] != tuple(b if d == CACHE_SLOT_AXIS else s
                                for d, s in enumerate(ca[n][0]))]
    if bad:
        raise AssertionError(f"{arch.arch_id}: cache leaves whose batch dim is not axis "
                             f"{CACHE_SLOT_AXIS}: {bad}")


def check_slots_cache_contract(arch: Arch, n_slots: int = 4, chunk: int = 2,
                               max_len: int = 8, cfg: ModelConfig | None = None,
                               cache_quant_int8: bool = False) -> None:
    """The multi-slot scatter + chunk-resume contract of batched prefill:
    gather → write round-trips the slot cache to the same leaves; a
    chunk-resume forward (B, C) at per-row offsets maps the gathered cache
    to the same leaves and gives (B, C, V) logits; and, with paged KV, the
    paged twin maps the pool to the same leaves.  Raises
    NotImplementedError with ``chunked_prefill_skip_reason`` where the
    family has none."""
    cfg = cfg or arch.cfg
    reason = arch.chunked_prefill_skip_reason()
    if reason:
        raise NotImplementedError(f"{arch.arch_id}: {reason}")
    b = n_slots - 1  # a partial group, like a real admit round
    cache = arch.init_cache(n_slots, max_len, META, cfg, cache_quant_int8)
    before = _specs(cache)
    slots = torch.arange(b, device=META)
    small = gather_cache_slots(cache, slots)
    _assert_same(arch, before, _specs(write_cache_slots(cache, small, slots)),
                 "slot gather/scatter round-trip")
    bad = [n for n, t in small.items() if t.shape[CACHE_SLOT_AXIS] != b]
    if bad:
        raise AssertionError(f"{arch.arch_id}: gathered leaves {bad} lack batch {b}")
    params = _meta_params(arch, cfg)
    starts = torch.zeros((b,), dtype=torch.long, device=META)
    small_before = _specs(small)
    logits, small = arch.forward(params, cfg, **_inputs(arch, cfg, b, chunk), cache=small,
                                 cache_pos=starts)
    _assert_same(arch, small_before, _specs(small), "chunk-resume forward")
    if tuple(logits.shape) != (b, chunk, cfg.vocab_size):
        raise AssertionError(f"{arch.arch_id}: chunk-resume logits {tuple(logits.shape)}")
    if arch.supports_paged_kv:
        block_len = max(max_len // 4, 1)
        pool = arch.init_paged_cache(n_slots + 2, block_len, META, cfg, cache_quant_int8)
        pool_before = _specs(pool)
        table = torch.zeros((b, max_len // block_len), dtype=torch.int32, device=META)
        _, pool = arch.forward(params, cfg, **_inputs(arch, cfg, b, chunk), cache=pool,
                               cache_pos=starts, block_table=table)
        _assert_same(arch, pool_before, _specs(pool), "paged chunk-resume forward")


def check_paged_cache_contract(arch: Arch, n_slots: int = 2, block_len: int = 4,
                               max_blocks: int = 3, cfg: ModelConfig | None = None,
                               cache_quant_int8: bool = False) -> None:
    """Pool leaves carry the block axis on ``CACHE_BLOCK_AXIS`` and the
    in-block position right after it (compared at two pool sizes), and one
    paged decode step maps the pool to the same leaves.  Raises
    NotImplementedError with ``paged_skip_reason`` where unsupported."""
    cfg = cfg or arch.cfg
    reason = arch.paged_skip_reason()
    if reason:
        raise NotImplementedError(f"{arch.arch_id}: {reason}")
    a, b = 5, 7
    la = _specs(arch.init_paged_cache(a, block_len, META, cfg, cache_quant_int8))
    lb = _specs(arch.init_paged_cache(b, block_len, META, cfg, cache_quant_int8))
    if list(la) != list(lb):
        raise AssertionError(f"{arch.arch_id}: pool leaves depend on n_blocks")
    bad = [(n, la[n], lb[n]) for n in la
           if la[n][1] != lb[n][1] or la[n][0][CACHE_BLOCK_AXIS] != a
           or la[n][0][CACHE_BLOCK_AXIS + 1] != block_len
           or lb[n][0] != tuple(b if d == CACHE_BLOCK_AXIS else s
                                for d, s in enumerate(la[n][0]))]
    if bad:
        raise AssertionError(f"{arch.arch_id}: pool leaves whose block axis is not axis "
                             f"{CACHE_BLOCK_AXIS} (or block_len not after it): {bad}")
    pool = arch.init_paged_cache(a, block_len, META, cfg, cache_quant_int8)
    before = _specs(pool)
    _, out = arch.forward(_meta_params(arch, cfg), cfg, **_inputs(arch, cfg, n_slots, 1),
                          cache=pool,
                          cache_pos=torch.zeros((n_slots,), dtype=torch.long, device=META),
                          block_table=torch.zeros((n_slots, max_blocks), dtype=torch.int32,
                                                  device=META))
    _assert_same(arch, before, _specs(out), "paged decode")


# ------------------------------------------------------------ sharded inputs


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An abstract tensor: shape, dtype and, with a mesh, its layout (the
    reference's ``ShapeDtypeStruct`` with a sharding)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None

    def empty(self, device="cpu") -> torch.Tensor:
        """An uninitialised tensor of this spec: a DTensor of each rank's
        shard in its layout, or a plain tensor on ``device`` without one.
        Under ``FakeTensorMode`` it holds no data."""
        if self.sharding is None:
            return torch.empty(self.shape, dtype=self.dtype, device=device)
        from torch.distributed.tensor import empty

        return empty(self.shape, dtype=self.dtype, device_mesh=self.sharding.mesh,
                     placements=self.sharding.placements)


def input_specs(
    arch: Arch,
    shape: ShapeSpec,
    plan: MeshPlan,
    cfg: ModelConfig | None = None,
) -> dict:
    """Abstract model inputs (``TensorSpec``) for one (arch × shape) cell.

    train   → tokens/embeds (+positions) + labels
    prefill → tokens/embeds (+positions)
    decode  → token (B,1) + cache (length = shape.seq_len) + pos (B,)
    """
    cfg = cfg or arch.cfg
    b, s = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16

    def sds(shp, dtype, *spec):
        return TensorSpec(tuple(shp), dtype, plan.ns(*spec))

    def token_inputs(seq: int) -> dict:
        if arch.input_kind == "tokens":
            return {"tokens": sds((b, seq), torch.int32, plan.dp, None)}
        out = {"embeds": sds((b, seq, cfg.d_model), bf16, plan.dp, None, None)}
        if arch.input_kind == "embeds+mrope":
            out["positions"] = sds((b, 3, seq), torch.int32, plan.dp, None, None)
        return out

    if shape.kind == "train":
        specs = token_inputs(s)
        specs["labels"] = sds((b, s), torch.int32, plan.dp, None)
        return specs

    if shape.kind == "prefill":
        return token_inputs(s)

    # decode: one new token, cache of length s
    specs = {}
    if arch.input_kind == "tokens":
        specs["token"] = sds((b, 1), torch.int32, plan.dp, None)
    else:
        specs["token"] = sds((b, 1, cfg.d_model), bf16, plan.dp, None, None)
        if arch.input_kind == "embeds+mrope":
            specs["positions"] = sds((b, 3, 1), torch.int32, plan.dp, None, None)
    specs["pos"] = sds((b,), torch.int32, plan.dp)
    cache_abs = arch.abstract_cache(b, s, plan, cfg, plan.cache_quant_int8)
    specs["cache"] = cache_shardings(arch, cache_abs, plan, cfg)
    return specs


def cache_shardings(arch: Arch, cache_abs, plan: MeshPlan, cfg: ModelConfig):
    """``TensorSpec``s (with shardings) of an abstract cache tree."""
    if plan.mesh is None:
        return tree_map_with_path_names(
            lambda _, leaf: TensorSpec(tuple(leaf.shape), leaf.dtype), cache_abs)
    cspec = plan.cache_spec()

    def shard_leaf(path: str, leaf) -> TensorSpec:
        nd = leaf.dim()
        if "scale" in path:  # int8-cache scales (L, B, S, KH)
            spec = (None, *cspec[:3])
        elif "attn" in path or path in ("k", "v"):
            spec = (None, *cspec)  # (L/n_inv, B, S, KH, Dh)
        elif "ssm" in path:  # (L, B, H, N, P): heads over tp when divisible
            h = leaf.shape[2]
            tp_ok = h % plan.tp_size == 0
            spec = (None, plan.dp, plan.tp if tp_ok else None, None, None)
        elif "conv" in path:  # (L, B, W-1, conv_dim)
            spec = (None, plan.dp, None, plan.tp)
        elif "wkv" in path:  # (L, B, H, n, n)
            spec = (None, plan.dp, None, None, None)
        elif "shift" in path:  # (L, B, d)
            spec = (None, plan.dp, None)
        else:
            spec = tuple([None] * nd)
        spec = tuple(spec[:nd]) + (None,) * (nd - len(spec))
        # divisibility guard: drop axis entries that don't divide
        fixed = []
        for dim, entry in zip(leaf.shape, spec):
            if entry is None:
                fixed.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            size = 1
            for a in axes:
                size *= plan.axis_size(a)
            fixed.append(entry if dim % size == 0 else None)
        return TensorSpec(tuple(leaf.shape), leaf.dtype, plan.ns(*fixed))

    return tree_map_with_path_names(shard_leaf, cache_abs)
