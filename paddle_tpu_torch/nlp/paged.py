"""Paged KV-cache serving: block-table cache + ragged batch admission.

Port of paddle_tpu/nlp/paged.py: the block pool and its allocator, the
pool write (fp, or int8 codes with per-(layer, block) scales), the paged
attention, `forward_paged`, `paged_generate`, the speculative score path
(`_forward_spec`) and the `ContinuousBatcher` with bucketed and chunked
prefill, fused prefill+decode steps, lock-step decode chunks, int8
weights (`weight_dtype`), the int8 KV pool (`kv_dtype`) and
self-speculative decoding (chain and tree drafts, verify-then-commit).
Prefix caching, the tensor-parallel mesh and KV export/import are later
slices.

Design, as in the JAX package:
  * the pool is one [L, N_blocks, block_size, KV, hd] tensor pair shared
    by every request; a request holds ceil(len/block_size) blocks;
  * the block table [B, M] and per-request lengths [B] are device
    tensors; cache writes scatter through the table, reads walk it;
  * per-request positions ride the whole forward, so requests at
    different lengths decode in one batch;
  * block allocation is host-side (BlockAllocator).

Where PyTorch differs:
  * the pool is updated IN PLACE (JAX returns a new pool): forward_paged
    writes each layer's new K/V into `cache.k` / `cache.v` and returns
    the same tensors;
  * the pool holds one extra block past the allocator's `num_blocks`, a
    write sink: padded query slots write there instead of being dropped
    (XLA's `mode="drop"`), so the write needs no data-dependent shape and
    no host sync. No table entry ever names it;
  * the batcher runs eagerly: no AOT executables, so no compile counter.
    Decode still syncs with the host once per chunk, a speculative tick
    once (tokens, counts and acceptance in one read);
  * the int8 write rescales the blocks it touches unconditionally (an
    exact identity where no scale grew) where JAX skips the rescale by a
    `lax.cond` on any growth: the port's test would be a host sync in
    every layer of every step.

Attention backends: on CUDA the batcher and `paged_generate` run the
CUDA kernels (flash forward for cold prefill, ragged paged attention
for everything else: its int8 option over an int8 pool, its suffix-slab
option for the speculative draft and verify), on the CPU their plain
PyTorch versions; the device decides, and nothing swaps the plain
versions in on the card. `forward_paged(attention_impl="ref")` and
`_forward_spec(attention_impl="ref")` alone run the plain versions on
CUDA tensors, as the reference that the kernels' logits are held to.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..quantization import kv as kvq
from ..serving.speculative import SpecConfig, SpecStats
from ..kernels.flash_attention import flash_attention_fwd, \
    flash_attention_fwd_ref
from ..kernels.rms_norm import rms_norm_ref
from ..kernels.rope import apply_rope_half, rope_freqs
from . import llama
from .generation import (_final_head_cached, _mlp_cached, _sample, _wq,
                         quantize_for_serving)
from .ragged_attention import (ragged_paged_attention,
                               ragged_paged_attention_ref,
                               resolve_attention_impl)


class PagedKVCache(NamedTuple):
    """k/v: [L, N_blocks + 1, block_size, KV, hd] (the last block is the
    write sink); table: [B, M] int32 block ids; lengths: [B] int32
    tokens currently cached; k_scale/v_scale: [L, N_blocks + 1] f32
    per-(layer, block) scales of an int8 pool (None for fp)."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        """Allocatable blocks (the sink excluded)."""
        return self.k.shape[1] - 1


class BlockAllocator:
    """Host-side free-list allocator over the pool's block ids.
    `stats()` exposes the reuse evidence (blocks_in_use / high_water /
    reuse_count)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._free_set: set = set(self._free)
        self._ever_used: set = set()
        self.reused_blocks = 0
        self.high_water = 0

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"pool exhausted: need {n} blocks, {len(self._free)} free")
        blocks = self._free[:n]
        del self._free[:n]
        self._free_set.difference_update(blocks)
        self.reused_blocks += sum(1 for b in blocks if b in self._ever_used)
        self._ever_used.update(blocks)
        self.high_water = max(self.high_water,
                              self.num_blocks - self.free_blocks)
        return blocks

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the free list. Raises ValueError on
        out-of-range or already-free ids (a double free would hand one
        block to two requests) before mutating anything."""
        seen: set = set()
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(
                    f"free(): block id {b} out of range "
                    f"[0, {self.num_blocks})")
            if b in self._free_set or b in seen:
                raise ValueError(
                    f"free(): block {b} is already free (double free)")
            seen.add(b)
        self._free.extend(blocks)
        self._free_set.update(blocks)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def stats(self) -> Dict[str, int]:
        return {
            "capacity_blocks": self.num_blocks,
            "blocks_in_use": self.num_blocks - len(self._free),
            "high_water_blocks": self.high_water,
            "reused_blocks": self.reused_blocks,
        }


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


class _Admission(NamedTuple):
    """One prepared-but-not-yet-activated admission: blocks allocated,
    slot reserved; `_rollback` can still undo it if the prefill fails."""
    slot: int
    rid: int
    toks: List[int]
    stop: int
    mn: int
    need: int
    blocks: List[int]
    chunks: List[Tuple[int, int, int]]   # (start, end, bucket) per chunk


def init_pool(cfg: llama.LlamaConfig, num_blocks: int, block_size: int,
              device="cuda", kv_dtype: str = "fp"):
    """Zeroed K/V pools [L, num_blocks + 1, block_size, KV, hd] (block
    `num_blocks` is the write sink) → (k, v, k_scale, v_scale). The fp
    pool stores the compute dtype with no scales (None); kv_dtype="int8"
    stores int8 codes plus zeroed [L, num_blocks + 1] f32 per-(layer,
    block) abs-max scales — scale 0 is the never-written sentinel that
    dequantizes to the same exact zeros a fresh fp pool holds."""
    L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    shape = (L, num_blocks + 1, block_size, KV, hd)
    dev = torch.device(device)
    if kvq.resolve_kv_dtype(kv_dtype) == "int8":
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:2], dtype=torch.float32, device=dev),
                torch.zeros(shape[:2], dtype=torch.float32, device=dev))
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev), None, None)


def build_table(allocator: BlockAllocator, lengths, max_len: int,
                block_size: int, device="cuda"):
    """Allocate each request's blocks for up to max_len tokens → ([B, M]
    int32 table on `device`, per-request block lists for later free())."""
    M = -(-max_len // block_size)
    owned = [allocator.allocate(M) for _ in lengths]
    return torch.tensor(owned, dtype=torch.int32, device=device), owned


def _pool_slots(table, positions, valid, num_blocks: int, block_size: int):
    """Flat pool slot (block * block_size + offset) of each query
    [B, P] through the table; invalid slots go to the sink block."""
    M = table.shape[1]
    pos = positions.long()
    blk = torch.gather(table.long(), 1, (pos // block_size).clamp(0, M - 1))
    flat = blk * block_size + pos % block_size
    return torch.where(valid, flat, num_blocks * block_size)


def _write_pool(pool, slots, new):
    """Scatter new [B, P, KV, hd] rows into a pool of blocks
    [NB, bs, KV, hd] (one layer's, sink included) at `slots` (from
    `_pool_slots`), in place."""
    flat = pool.view(-1, *pool.shape[2:])
    flat.index_copy_(0, slots.reshape(-1),
                     new.reshape(-1, *pool.shape[2:]).to(pool.dtype))


def _write_pool_int8(pool, scale, slots, new):
    """int8 twin of `_write_pool`: quantize new [B, P, KV, hd] rows into
    an int8 pool of blocks [NB, bs, KV, hd] at `slots`, keeping ONE
    abs-max scale a block in `scale` [NB] (quantization.kv holds the
    math), in place. Grow-only: where this call's writes raise a block's
    abs-max, the block's existing codes rescale once under the new scale.
    The blocks this call touches (B * P of them, the sink for invalid
    slots) are rescaled unconditionally: with no growth the rescale is an
    exact identity (ratio 1.0), and skipping it would need a host sync.
    Duplicate targets gather, rescale and store identical contents, so
    the order of a duplicate store does not matter; the same holds for
    the abs-max scatter, a max. Returns the just-written rows dequantized
    at the committed scales (f32), so the cold-prefill flash attends over
    exactly what the pool now stores."""
    bs = pool.shape[1]
    flat_slots = slots.reshape(-1)
    tgt = torch.div(flat_slots, bs, rounding_mode="floor")
    new32 = new.float().reshape(-1, *pool.shape[2:])
    amax = torch.zeros_like(scale).scatter_reduce_(
        0, tgt, new32.abs().amax(dim=(1, 2)), "amax")
    scale2 = torch.maximum(scale, kvq.scale_of(amax))
    grow = (scale[tgt], scale2[tgt])
    pool.index_copy_(0, tgt, kvq.rescale_codes(
        pool[tgt], grow[0][:, None, None, None], grow[1][:, None, None, None]))
    scale.copy_(scale2)
    s_tok = grow[1][:, None, None]
    codes = kvq.quantize(new32, s_tok)
    pool.view(-1, *pool.shape[2:]).index_copy_(0, flat_slots, codes)
    return kvq.dequantize(codes, s_tok).reshape(new.shape)


def _paged_gqa_attention(q, k_pool, v_pool, table, positions, valid,
                         impl: str = "ref", k_scale=None, v_scale=None):
    """q [B, P, H, hd] against the pool through the table, per-query
    causal (query p sees keys j <= positions[b, p]); invalid queries
    give zeros. k_scale/v_scale [N + 1] (this layer's) mark an int8 pool.
    impl "kernel": the ragged CUDA kernel; "ref": its plain version (the
    JAX package's "xla" gather, dequantized after the gather)."""
    fn = ragged_paged_attention if impl == "kernel" \
        else ragged_paged_attention_ref
    return fn(q, k_pool, v_pool, table, positions, valid, k_scale=k_scale,
              v_scale=v_scale)


def _spec_gqa_attention(q, pk, pv, table, base_len, sk, sv, vis,
                        k_scale=None, v_scale=None, impl: str = "ref"):
    """The speculative score path's attention: q [B, P, H, hd] over the
    committed pool history PLUS the draft/verify slab. The pool is
    READ-ONLY here: pool key j is visible iff j < base_len[b] (nothing
    speculative has been written), and slab row s (sk/sv [B, S, KV, hd])
    to query p iff vis[p, s] — the chain's causal triangle or the packed
    tree's ancestor-or-self mask. One softmax runs over both: row 18's
    suffix-slab option ("kernel") or its plain version ("ref"), every
    query valid (inactive slots score values the caller discards). Slab
    rows stay full precision over an int8 pool."""
    B, P = q.shape[:2]
    S = sk.shape[1]
    fn = ragged_paged_attention if impl == "kernel" \
        else ragged_paged_attention_ref
    positions = (base_len.to(torch.int32) - 1)[:, None].expand(B, P)
    return fn(q, pk, pv, table, positions.contiguous(),
              torch.ones((B, P), dtype=torch.bool, device=q.device),
              k_scale=k_scale, v_scale=v_scale, suffix_k=sk, suffix_v=sv,
              suffix_vis=vis[None].expand(B, P, S).contiguous())


def _attention_paged(x, lp, cfg, cos, sin, pk, pv, table, positions, valid,
                     slots, is_prefill, attention_impl: str, pks=None,
                     pvs=None):
    """One layer's attention: write the new K/V into the pool (in place;
    quantized on the write when pks/pvs carry this layer's int8 block
    scales), then attend. Cold prefill attends within the batch (flash)
    over the rows as the pool now stores them; decode, continuing and
    fused rows attend through the table."""
    B, P, D = x.shape
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    cd = cfg.dtype
    q = (x @ _wq(lp, "q_proj", cd)).reshape(B, P, H, hd)
    k = (x @ _wq(lp, "k_proj", cd)).reshape(B, P, KV, hd)
    v = (x @ _wq(lp, "v_proj", cd)).reshape(B, P, KV, hd)
    q, k = apply_rope_half(q, k, cos, sin, positions)
    if pks is None:
        _write_pool(pk, slots, k)
        _write_pool(pv, slots, v)
    else:
        # every consumer sees the quantize → dequantize roundtrip of this
        # call's own writes
        k = _write_pool_int8(pk, pks, slots, k).to(cd)
        v = _write_pool_int8(pv, pvs, slots, v).to(cd)
    if is_prefill:
        # the prompt attends only to itself: causal self-attention over
        # the right-padded batch (rows past a request's length compute
        # values nobody reads; their pool writes went to the sink)
        fa = flash_attention_fwd if attention_impl == "kernel" \
            else flash_attention_fwd_ref
        o = fa(q, k, v, causal=True)
    else:
        o = _paged_gqa_attention(q, pk, pv, table, positions, valid,
                                 impl=attention_impl, k_scale=pks,
                                 v_scale=pvs)
    return o.reshape(B, P, H * hd) @ _wq(lp, "o_proj", cd)


def forward_paged(params, tokens, cache: PagedKVCache, positions, valid,
                  cfg, is_prefill: bool, attention_impl: str = "auto"):
    """tokens [B, P] at per-request absolute `positions` [B, P] →
    (logits [B, P, V] f32, cache'). Writes the new K/V into the pool in
    place; cache'.lengths = max(lengths, last position + 1).
    `attention_impl` "auto" lets the device decide; "ref" runs the plain
    versions even on CUDA tensors (the reference for the kernels)."""
    impl = resolve_attention_impl(attention_impl, cache.k.device)
    cd = cfg.dtype
    bs = cache.block_size
    table = cache.table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    # rope spans the per-request table width (max reachable position)
    T_rope = table.shape[1] * bs
    x = params["embed_tokens"][tokens.long()].to(cd)
    cos, sin = rope_freqs(cfg.head_dim, T_rope, cfg.rope_theta,
                          device=x.device)
    slots = _pool_slots(table, positions, valid, cache.num_blocks, bs)
    layers = params["layers"]
    q8 = cache.k_scale is not None
    for li in range(cfg.num_hidden_layers):
        lp = {name: w[li] for name, w in layers.items()}
        h = rms_norm_ref(x, lp["input_layernorm"], cfg.rms_norm_eps)
        x = x + _attention_paged(h, lp, cfg, cos, sin, cache.k[li],
                                 cache.v[li], table, positions, valid, slots,
                                 is_prefill, impl,
                                 cache.k_scale[li] if q8 else None,
                                 cache.v_scale[li] if q8 else None)
        h = rms_norm_ref(x, lp["post_attention_layernorm"],
                         cfg.rms_norm_eps)
        x = x + _mlp_cached(h, lp, cfg)
    logits = _final_head_cached(params, x, cfg)
    visible_len = (positions[:, -1] + 1).to(cache.lengths.dtype)
    return logits, cache._replace(
        lengths=torch.maximum(cache.lengths, visible_len))


def _forward_spec(params, layers, tokens, cache: PagedKVCache, positions,
                  base_len, slab_k, slab_v, row0: int, cfg, vis=None,
                  attention_impl: str = "auto"):
    """The speculative score-path forward: tokens [B, P] at per-request
    absolute `positions`, attending to the committed pool (READ-ONLY,
    visibility < base_len) plus the spec slab (previously drafted rows
    and this call's own). The new tokens' per-layer K/V land in slab rows
    [row0, row0 + P) of slab_k/slab_v [depth, B, S, KV, hd] (in place) —
    NEVER the pool: verify-then-commit writes only accepted rows
    afterwards, so a rejected draft token cannot reach the pool or an
    int8 block's scale. `layers` may be a truncated stack (the draft's;
    the slab's depth matches it) or the draft-from-w8 tree; embed, norm
    and head come from the full `params`. `vis` [P, S] bool gives each
    query its visible slab rows (None = the chain's causal triangle
    relative to row0). `attention_impl` as in `forward_paged`. Returns
    (logits [B, P, V] f32, slab_k, slab_v)."""
    impl = resolve_attention_impl(attention_impl, cache.k.device)
    cd = cfg.dtype
    table = cache.table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    T_rope = table.shape[1] * cache.block_size
    x = params["embed_tokens"][tokens.long()].to(cd)
    cos, sin = rope_freqs(cfg.head_dim, T_rope, cfg.rope_theta,
                          device=x.device)
    B, P = tokens.shape
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    S = slab_k.shape[2]
    if vis is None:
        ar = torch.arange(S, device=x.device)
        vis = ar[None, :] <= (row0 + torch.arange(P, device=x.device))[:, None]
    q8 = cache.k_scale is not None
    for li in range(slab_k.shape[0]):
        lp = {name: w[li] for name, w in layers.items()}
        h = rms_norm_ref(x, lp["input_layernorm"], cfg.rms_norm_eps)
        q = (h @ _wq(lp, "q_proj", cd)).reshape(B, P, H, hd)
        k = (h @ _wq(lp, "k_proj", cd)).reshape(B, P, KV, hd)
        v = (h @ _wq(lp, "v_proj", cd)).reshape(B, P, KV, hd)
        q, k = apply_rope_half(q, k, cos, sin, positions)
        # slab rows pass through the slab (== pool compute) dtype, the
        # roundtrip a pool write-then-gather gives plain decode
        slab_k[li, :, row0:row0 + P] = k.to(slab_k.dtype)
        slab_v[li, :, row0:row0 + P] = v.to(slab_v.dtype)
        a = _spec_gqa_attention(q, cache.k[li], cache.v[li], table, base_len,
                                slab_k[li], slab_v[li], vis,
                                cache.k_scale[li] if q8 else None,
                                cache.v_scale[li] if q8 else None, impl)
        x = x + a.reshape(B, P, H * hd) @ _wq(lp, "o_proj", cd)
        h = rms_norm_ref(x, lp["post_attention_layernorm"],
                         cfg.rms_norm_eps)
        x = x + _mlp_cached(h, lp, cfg)
    return _final_head_cached(params, x, cfg), slab_k, slab_v


def paged_generate(params, tokens, lengths, cfg: llama.LlamaConfig,
                   max_new_tokens: int = 32, block_size: int = 64,
                   allocator: Optional[BlockAllocator] = None,
                   num_blocks: Optional[int] = None,
                   temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0, greedy: bool = True,
                   generator: Optional[torch.Generator] = None,
                   device="cuda"):
    """Ragged batched generation over one shared block pool.

    tokens [B, P_max] right-padded prompts; lengths [B] real prompt
    lengths (requests may differ). Returns (ids [B, max_new_tokens]
    int32 tensor, allocator, owned) — `owned` is the per-request block
    lists; free them back to the allocator when each request completes."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
    lengths_np = np.asarray(lengths)
    B, P = tokens.shape
    max_total = int(lengths_np.max()) + max_new_tokens
    if allocator is None:
        n = num_blocks or (B * -(-max_total // block_size))
        allocator = BlockAllocator(n)
    table, owned = build_table(allocator, lengths_np, max_total, block_size,
                               dev)
    k, v, _, _ = init_pool(cfg, allocator.num_blocks, block_size, dev)
    cache = PagedKVCache(k, v, table,
                         torch.zeros((B,), dtype=torch.int32, device=dev))
    lengths = torch.as_tensor(lengths_np, dtype=torch.int32, device=dev)

    # prefill at per-request positions; padded rows write to the sink
    positions = torch.arange(P, dtype=torch.int32,
                             device=dev)[None].expand(B, P)
    valid = positions < lengths[:, None]
    logits, cache = forward_paged(params, tokens, cache, positions, valid,
                                  cfg, is_prefill=True)
    last = logits[torch.arange(B, device=dev), (lengths - 1).long()]
    tok = _sample(last, generator, temperature, top_k, top_p, greedy)
    # the prefill wrote only the prompt; fix lengths to the real ones
    cache = cache._replace(lengths=lengths)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        pos = cache.lengths[:, None]
        logits, cache = forward_paged(
            params, tok[:, None], cache, pos, torch.ones_like(pos, dtype=bool),
            cfg, is_prefill=False)
        tok = _sample(logits[:, 0], generator, temperature, top_k, top_p,
                      greedy)
        out.append(tok)
    return torch.stack(out, dim=1), allocator, owned


class ContinuousBatcher:
    """Continuous batching over the shared block pool.

    Host-side scheduler over device steps: a fixed set of B batch slots
    decodes in lock-step chunks; when a request finishes (eos or budget)
    its blocks return to the allocator and queued requests are admitted
    into the free slots by a bucketed prefill.

    Prefill is bucketed, chunked, and batched: the prompt pads to a
    power-of-two bucket ladder (masked through valid/positions), longer
    prompts split into sequential largest-bucket chunks through the
    per-query-causal paged path, and same-bucket admissions in one burst
    prefill in a single call; `prefill_pad_tokens` counts the padding.

    Prefill is FUSED with decode (`fused_prefill=True`): when an
    admission lands while slots are decoding, one call carries
    `max_batch` decode rows PLUS up to `fused_units` bucket-sized units
    of prefill rows — the ragged paged attention mixed batch — so
    in-flight decoding advances by its chunk in the same step that
    prefills the admission. `fused_steps` counts piggybacked calls,
    `decode_stall_steps` counts standalone prefill calls that ran while
    slots were decoding (the unfused cost).

    Quantized serving: `weight_dtype="int8"` serves the tree through
    `generation.quantize_for_serving(bits=8)` (a tree that already holds
    codes and scales passes through); `kv_dtype="int8"` stores the pools
    as int8 codes with per-(layer, block) abs-max scales, quantized on
    every commit write (`quantization.kv`).

    Self-speculative decoding (`speculative=True`): a draft — the same
    model truncated to `draft_layers` (None = full depth), or its int8
    quantization with `spec_draft_w8` — proposes `spec_k` tokens (a chain)
    or a token tree (`spec_tree=[b0, b1, ...]`, spec_k derived) per slot
    off the committed pool; the target scores them in ONE call over the
    read-only pool plus the slab, accepts the longest greedy-matching
    path plus one corrected token, and commits only the accepted rows,
    one row at a time in order (int8 scales grow as sequential decode's).
    `submit(speculative=False)` opts one request out (its verify rows
    ride along with acceptance 0).

    Usage:
        cb = ContinuousBatcher(params, cfg, max_batch=2, block_size=16,
                               max_total_len=256, max_new_tokens=16)
        rid = cb.submit([tok, tok, ...])
        cb.run()              # drain queue + in-flight
        out = cb.outputs[rid] # list of generated ids
    """

    def __init__(self, params, cfg, max_batch: int, block_size: int,
                 max_total_len: int, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 num_blocks: Optional[int] = None, chunk: int = 8,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_prefill_bucket: int = 512,
                 fused_prefill: bool = True, fused_units: int = 1,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 speculative: bool = False, spec_k: int = 4,
                 draft_layers: Optional[int] = None,
                 spec_tree: Optional[Sequence[int]] = None,
                 spec_draft_w8: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        if params["embed_tokens"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed_tokens'].device}, the "
                f"batcher on {self.device}: load them with "
                f"llama.params_from_numpy(..., device=...)")
        self.weight_dtype = "fp" if weight_dtype in (None, "fp") \
            else weight_dtype
        if self.weight_dtype not in ("fp", "int8"):
            raise ValueError(
                f"weight_dtype must be 'fp'/'int8' (or None), "
                f"got {weight_dtype!r}")
        if self.weight_dtype == "int8" and not any(
                k.endswith(":scale") for k in params["layers"]):
            params = quantize_for_serving(params, bits=8)
        self.kv_dtype = kvq.resolve_kv_dtype(kv_dtype)
        self.params, self.cfg = params, cfg
        self.speculative = bool(speculative)
        self._spec_cfg = SpecConfig(spec_k, draft_layers,
                                    num_layers=cfg.num_hidden_layers,
                                    tree=spec_tree, draft_w8=spec_draft_w8)
        self.spec_k = self._spec_cfg.k
        self.spec_tree = self._spec_cfg.tree
        self._draft_depth = self._spec_cfg.depth(cfg.num_hidden_layers)
        # draft-from-w8: the truncated stack quantized ONCE, only when the
        # target serves fp weights (an int8 target's layers already are)
        self._spec_dlayers = None
        if self.speculative and self._spec_cfg.draft_w8 \
                and self.weight_dtype == "fp":
            trunc = {k: w[:self._draft_depth]
                     for k, w in params["layers"].items()}
            self._spec_dlayers = quantize_for_serving(
                {"layers": trunc}, bits=8)["layers"]
        self.spec = SpecStats()
        # per-request spec opt-out, and the [B] device mirror of per-slot
        # participation (rebuilt after admission or retirement)
        self._no_spec: set = set()
        self._spec_ok_dev = None
        self.B, self.bs = max_batch, block_size
        # the device picks the backend: the kernels on CUDA
        self.attention_impl = resolve_attention_impl("auto", self.device)
        self.max_total = max_total_len
        self.M = -(-max_total_len // block_size)
        self.max_new = max_new_tokens
        self.eos = eos_token_id
        self.chunk = chunk
        # prefill bucket ladder: prompts pad to the smallest bucket that
        # fits and longer ones split into largest-bucket chunks. None =
        # power-of-two ladder (8, 16, ... capped by max_prefill_bucket
        # and the table span); an empty sequence disables bucketing
        if prefill_buckets is None:
            cap = max(1, min(int(max_total_len), int(max_prefill_bucket)))
            ladder, b = [], 8
            while b < cap:
                ladder.append(b)
                b *= 2
            ladder.append(cap)
            self._buckets: Tuple[int, ...] = tuple(sorted(set(ladder)))
        else:
            self._buckets = tuple(sorted({int(x) for x in prefill_buckets}))
            if any(x < 1 for x in self._buckets):
                raise ValueError("prefill_buckets must be positive")
        self.prefill_pad_tokens = 0
        self._fused = bool(fused_prefill)
        if int(fused_units) < 1:
            raise ValueError("fused_units must be >= 1")
        self.fused_units = int(fused_units)
        # prepared-but-not-fully-prefilled admissions: [record, chunks
        # done] — the slot and blocks stay reserved for the whole
        # (possibly multi-chunk) prefill
        self._pending: List[List] = []
        self.fused_steps = 0          # piggybacked prefill calls
        self.fused_unit_count = 0     # prefill units those calls carried
        self.decode_stall_steps = 0   # standalone prefills that stalled
        self.prefill_chunk_calls = 0  # prefill rows computed
        nb = num_blocks or (max_batch * self.M)
        self.alloc = BlockAllocator(nb)
        k, v, ks, vs = init_pool(cfg, nb, block_size, self.device,
                                 kv_dtype=self.kv_dtype)
        dev = self.device
        self.cache = PagedKVCache(
            k, v, torch.zeros((max_batch, self.M), dtype=torch.int32,
                              device=dev),
            torch.zeros((max_batch,), dtype=torch.int32, device=dev), ks, vs)
        self.active = [False] * max_batch
        self.slot_req: List[Optional[int]] = [None] * max_batch
        self.slot_blocks: List[Optional[List[int]]] = [None] * max_batch
        self.budget = [0] * max_batch
        self.stop = [-1] * max_batch          # per-slot stop id (-1 = none)
        # device mirrors of (active, budget, stop): decode consumes AND
        # returns them, so steady-state decoding re-uploads nothing;
        # admission/retirement null the mirror and the next step
        # refreshes it from the host lists
        self._dev_state = None
        self.cur_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=dev)
        self.queue: List = []
        self.outputs: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._delivered: Dict[int, int] = {}   # rid -> tokens handed out
        self._just_finished: List[int] = []

    # -- public surface ----------------------------------------------------
    def submit(self, tokens, stop_token_id: Optional[int] = None,
               max_new_tokens: Optional[int] = None,
               speculative: Optional[bool] = None) -> int:
        """Queue a request. `stop_token_id` finishes THIS request early
        when emitted (in addition to the batcher-wide eos).
        `max_new_tokens` caps this request's budget (<= the batcher-wide
        max — the block table width is sized for it).
        `speculative=False` opts THIS request out of the spec pipeline
        (plain greedy decode inside a spec batcher); None inherits the
        batcher default."""
        toks = list(map(int, tokens))
        mn = self.validate(len(toks), max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        stop = -1 if stop_token_id is None else int(stop_token_id)
        if speculative is False:
            self._no_spec.add(rid)
        self.queue.append((rid, toks, stop, mn))
        self.outputs[rid] = []
        self._delivered[rid] = 0
        return rid

    def validate(self, prompt_len: int,
                 max_new_tokens: Optional[int] = None) -> int:
        """Check a request's shape against this batcher's static sizing;
        returns the resolved max_new budget."""
        mn = self.max_new if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= mn <= self.max_new:
            raise ValueError(
                f"max_new_tokens {mn} out of range [1, {self.max_new}]")
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len + mn > self.max_total:
            raise ValueError(
                f"prompt of {prompt_len} + max_new {mn} exceeds "
                f"max_total_len {self.max_total}")
        return mn

    def blocks_needed(self, prompt_len: int,
                      max_new_tokens: Optional[int] = None) -> int:
        """Pool blocks a request of this shape holds while in flight."""
        mn = self.max_new if max_new_tokens is None else int(max_new_tokens)
        return -(-(prompt_len + mn) // self.bs)

    def kv_block_bytes(self) -> int:
        """Device bytes ONE pool block occupies (all layers, K+V pools,
        the int8 scale pool's overhead included): quantization.kv's
        kv_block_bytes under this batcher's geometry and kv_dtype."""
        cfg = self.cfg
        return kvq.kv_block_bytes(
            cfg.num_hidden_layers, self.bs, cfg.num_key_value_heads,
            cfg.head_dim, self.kv_dtype,
            fp_itemsize=torch.empty((), dtype=cfg.dtype).element_size())

    def kv_pool_bytes(self) -> int:
        """KV pool footprint: capacity blocks x kv_block_bytes() (the
        write sink, one block past the capacity, is not counted)."""
        return self.alloc.num_blocks * self.kv_block_bytes()

    def kv_bytes_per_token(self) -> float:
        """Device bytes one cached token costs (and one decode step's
        gather moves per live token): kv_block_bytes / block_size."""
        return self.kv_block_bytes() / self.bs

    def weight_bytes(self) -> int:
        """Device bytes of the parameter tree (codes and scales for an
        int8 tree)."""
        leaves = [w for k, w in self.params.items() if k != "layers"]
        leaves += list(self.params["layers"].values())
        return sum(w.numel() * w.element_size() for w in leaves)

    @property
    def prefill_buckets(self) -> Tuple[int, ...]:
        """The prefill bucket ladder (empty = bucketing disabled)."""
        return self._buckets

    def release(self, rid: int) -> None:
        """Drop a finished/aborted request's retained output list."""
        self.outputs.pop(rid, None)
        self._delivered.pop(rid, None)

    def free_slots(self) -> int:
        """Batch slots available to new admissions: queued and pending
        (prepared, still prefilling) requests count as taken."""
        return max(0, self.active.count(False) - len(self.queue)
                   - len(self._pending))

    def abort(self, rid: int) -> bool:
        """Cancel a request: drop it from the queue or the pending
        pipeline, or retire its slot mid-decode so its blocks return to
        the pool immediately. Returns False when rid is unknown or
        already finished."""
        for i, entry in enumerate(self.queue):
            if entry[0] == rid:
                del self.queue[i]
                self._delivered.pop(rid, None)
                self._no_spec.discard(rid)
                return True
        for i, (rec, _done) in enumerate(self._pending):
            if rec.rid == rid:
                self._rollback([rec])
                del self._pending[i]
                self._delivered.pop(rid, None)
                self._no_spec.discard(rid)
                return True
        for slot in range(self.B):
            if self.active[slot] and self.slot_req[slot] == rid:
                self._retire(slot)
                # an abort is the caller's bookkeeping, not a completion
                self._just_finished.remove(rid)
                self._delivered.pop(rid, None)
                return True
        return False

    # -- bucketed / chunked / batched prefill ------------------------------
    def _bucket_for(self, S: int) -> int:
        """Smallest ladder bucket that fits S tokens; with bucketing
        disabled the bucket IS the exact length."""
        for b in self._buckets:
            if b >= S:
                return b
        return S

    def _suffix_chunks(self, start: int,
                       P: int) -> List[Tuple[int, int, int]]:
        """Split [start, P) into (start, end, bucket) chunks:
        largest-bucket pieces first, then one bucketed remainder."""
        out: List[Tuple[int, int, int]] = []
        cap = self._buckets[-1] if self._buckets else P - start
        while P - start > cap:
            out.append((start, start + cap, cap))
            start += cap
        out.append((start, P, self._bucket_for(P - start)))
        return out

    def _group_pad(self, G: int) -> int:
        """Pad an admission group to the next power of two (capped at the
        batch width)."""
        return min(_pow2_ceil(max(1, G)), self.B)

    def _prepare_admission(self, slot: int, rid: int, toks: List[int],
                           stop: int, mn: int) -> _Admission:
        """Allocate one admission's blocks, no model compute; the slot
        stays inactive until `_commit`."""
        P = len(toks)
        need = -(-(P + mn) // self.bs)
        blocks = self.alloc.allocate(need)
        if self.kv_dtype == "int8":
            # a recycled block keeps its previous tenant's scale: reset it
            # to the never-written sentinel so quantization depends only
            # on what THIS request writes (admission, not the hot path)
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            self.cache.k_scale[:, idx] = 0.0
            self.cache.v_scale[:, idx] = 0.0
        return _Admission(slot, rid, list(toks), stop, mn, need, blocks,
                          self._suffix_chunks(0, P))

    def _rollback(self, recs: Sequence[_Admission]) -> None:
        """Return the blocks of prepared-but-uncommitted admissions."""
        for rec in recs:
            self.alloc.free(rec.blocks)

    def _pack_prefill_rows(self, items, Pb: int, Gp: int):
        """Pack a unit's (record, start, end) chunks into [Gp, Pb] row
        arrays: rows pad to the bucket, the group to its power-of-two
        size; padding masks through `valid` and clamped positions.
        Returns (rows, pos, valid, table, last_idx) numpy arrays."""
        rows = np.zeros((Gp, Pb), np.int32)
        pos = np.zeros((Gp, Pb), np.int32)
        val = np.zeros((Gp, Pb), np.bool_)
        tab = np.zeros((Gp, self.M), np.int32)
        li = np.zeros((Gp,), np.int32)
        real = 0
        maxpos = self.M * self.bs - 1
        for g, (rec, start, end) in enumerate(items):
            S = end - start
            real += S
            rows[g, :S] = rec.toks[start:end]
            pos[g] = np.minimum(np.arange(start, start + Pb), maxpos)
            val[g, :S] = True
            tab[g, :rec.need] = rec.blocks
            li[g] = S - 1
        self.prefill_pad_tokens += Gp * Pb - real
        return rows, pos, val, tab, li

    def _to_dev(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _prefill_call(self, items, Pb: int, cold: bool):
        """Run ONE standalone prefill over a unit's rows. Returns (logits
        [Gp, Pb, V], last real index per row [Gp])."""
        Gp = self._group_pad(len(items))
        rows, pos, val, tab, li = self._pack_prefill_rows(items, Pb, Gp)
        rows, pos, val, tab = self._to_dev(rows, pos, val, tab)
        sub = self.cache._replace(
            table=tab, lengths=torch.zeros((Gp,), dtype=torch.int32,
                                           device=self.device))
        logits, _ = forward_paged(self.params, rows, sub, pos, val,
                                  self.cfg, is_prefill=cold,
                                  attention_impl=self.attention_impl)
        return logits, li

    def _units(self, recs: Sequence[_Admission]) -> List[List[_Admission]]:
        """Partition pending records into execution units: single-chunk
        records with the same (bucket, phase) join the earliest unit of
        that key with room; a chunked record runs alone (its chunks are
        sequential by construction)."""
        units: List[List[_Admission]] = []
        keys: List[Optional[Tuple]] = []
        for rec in recs:
            if len(rec.chunks) > 1:
                units.append([rec])
                keys.append(None)
                continue
            s, _, b = rec.chunks[0]
            k = (b, s == 0)
            target = next((i for i, key in enumerate(keys)
                           if key == k and len(units[i]) < self.B), None)
            if target is not None:
                units[target].append(rec)
            else:
                units.append([rec])
                keys.append(k)
        return units

    def _commit(self, rec: _Admission, first: int) -> None:
        """Activate a successfully prefilled admission in its slot."""
        P = len(rec.toks)
        row = rec.blocks + [0] * (self.M - rec.need)
        self.cache.table[rec.slot] = torch.tensor(row, dtype=torch.int32)
        self.cache.lengths[rec.slot] = P
        self.cur_tok[rec.slot] = first
        self.active[rec.slot] = True
        self.slot_req[rec.slot] = rec.rid
        self.slot_blocks[rec.slot] = list(rec.blocks)
        self.budget[rec.slot] = rec.mn - 1
        self.stop[rec.slot] = rec.stop
        self._dev_state = None        # host slot state diverged from device
        self._spec_ok_dev = None      # slot occupancy changed
        self.outputs[rec.rid].append(first)
        if ((self.eos is not None and first == self.eos)
                or first == rec.stop or self.budget[rec.slot] <= 0):
            self._retire(rec.slot)

    def _unit_view(self, unit, entries):
        """One pending unit as an execution view: ([pipeline entries],
        [(rec, start, end) rows], bucket, cold, final). A chunked record
        runs its CURRENT chunk; `final` False keeps the entry pending
        with its progress bumped."""
        if len(unit[0].chunks) > 1:
            rec, done = entries[0]
            start, end, bucket = rec.chunks[done]
            return (entries[:1], [(rec, start, end)], bucket, start == 0,
                    done == len(rec.chunks) - 1)
        items = [(r, r.chunks[0][0], r.chunks[0][1]) for r in unit]
        _, _, bucket = unit[0].chunks[0]
        return entries, items, bucket, items[0][1] == 0, True

    def _entries_of(self, unit):
        entry_of = {id(e[0]): e for e in self._pending}
        return [entry_of[id(r)] for r in unit]

    def _finish_unit(self, entries, firsts) -> None:
        """Commit a unit whose FINAL chunk just computed: one readback
        of every first token at once, then activate each record."""
        firsts = firsts.tolist()
        for entry, first in zip(entries, firsts):
            self._commit(entry[0], int(first))
            self._pending.remove(entry)

    def _run_standalone_unit(self) -> None:
        """Run ONE standalone prefill call for the head pending unit."""
        unit = self._units([e[0] for e in self._pending])[0]
        entries, items, bucket, cold, final = self._unit_view(
            unit, self._entries_of(unit))
        logits, li = self._prefill_call(items, bucket, cold)
        self.prefill_chunk_calls += len(items)
        if final:
            g = len(items)
            idx = torch.as_tensor(li[:g], dtype=torch.long,
                                  device=self.device)
            last = torch.argmax(
                logits[torch.arange(g, device=self.device), idx], dim=-1)
            self._finish_unit(entries, last)
        else:
            entries[0][1] += 1

    def _fail_pending(self) -> None:
        """A failed prefill/fused call must not leak blocks or drop work:
        every pending record rolls back and requeues at the FRONT of the
        queue in original order."""
        victims = [e[0] for e in self._pending]
        self._rollback(victims)
        self._pending.clear()
        self.queue[:0] = [(v.rid, v.toks, v.stop, v.mn) for v in victims]

    def _prefill_pending(self) -> None:
        """Drain the pending pipeline with standalone prefill calls. With
        fusion ON the drain stops the moment a commit activates a decode
        slot (the fused step takes the rest); with fusion off everything
        drains and each call made while slots decode counts a stall."""
        try:
            while self._pending:
                if any(self.active):
                    if self._fused:
                        break
                    self.decode_stall_steps += 1
                self._run_standalone_unit()
        except Exception:
            self._fail_pending()
            raise

    def _pop_fused_units(self):
        """The units ONE fused call carries: the head unit, plus up to
        `fused_units - 1` following units at the same bucket. Returns
        (groups, bucket), groups = [(entries, items, final)]."""
        groups: List[Tuple[List, List, bool]] = []
        bucket0 = None
        for unit in self._units([e[0] for e in self._pending]):
            if len(groups) >= self.fused_units:
                break
            entries, items, bucket, _cold, final = self._unit_view(
                unit, self._entries_of(unit))
            if bucket0 is None:
                bucket0 = bucket
            elif bucket != bucket0:
                break
            groups.append((entries, items, final))
        return groups, bucket0

    def _upload_slot_state(self):
        """Host slot lists → device tensors (only after admission or
        retirement changed them)."""
        dev = self.device
        return (torch.tensor(self.active, dtype=torch.bool, device=dev),
                torch.tensor(self.budget, dtype=torch.int32, device=dev),
                torch.tensor(self.stop, dtype=torch.int32, device=dev))

    def _emit_one(self, logits_row, tok, act, lengths, budget, stop):
        """Greedy-emit one token per decode row and advance the row's
        state — THE stopping rule, shared by the decode chunk and the
        fused step's first token."""
        eos = -1 if self.eos is None else int(self.eos)
        nxt = torch.argmax(logits_row, dim=-1).to(torch.int32)
        nxt = torch.where(act, nxt, tok)
        lengths = lengths + act.to(torch.int32)
        budget = budget - act.to(torch.int32)
        # deactivate ON DEVICE the moment a slot's budget runs out or it
        # emits eos / its own stop id — a fixed-size chunk must not keep
        # writing past the slot's allocated blocks (the table row's
        # padding points at block 0, i.e. someone else's cache)
        act = act & (budget > 0) & (nxt != eos) & (nxt != stop)
        return nxt, lengths, budget, act

    def _decode_steps(self, n, tok, lengths, budget, active, stop):
        """`n` single-token decode steps of every slot on the device;
        returns the tokens [n] tensors and the advanced state."""
        toks = []
        for _ in range(n):
            pos = lengths[:, None]
            logits, _ = forward_paged(
                self.params, tok[:, None],
                self.cache._replace(lengths=lengths), pos, active[:, None],
                self.cfg, is_prefill=False,
                attention_impl=self.attention_impl)
            tok, lengths, budget, active = self._emit_one(
                logits[:, 0], tok, active, lengths, budget, stop)
            toks.append(tok)
        return toks, tok, lengths, budget, active

    def _step_decode(self) -> np.ndarray:
        """The plain decode chunk: `chunk` tokens per slot, ONE host sync.
        Returns the tokens [B, chunk] (host copy)."""
        if self._dev_state is None:
            self._dev_state = self._upload_slot_state()
        active, budget, stop = self._dev_state
        toks, tok, lengths, budget, active = self._decode_steps(
            self.chunk, self.cur_tok, self.cache.lengths, budget, active,
            stop)
        self.cache = self.cache._replace(lengths=lengths)
        self.cur_tok = tok
        self._dev_state = (active, budget, stop)
        return torch.stack(toks, dim=1).cpu().numpy()

    def _step_fused(self) -> np.ndarray:
        """Piggyback up to `fused_units` pending prefill units on this
        step's decode chunk: the first decode token and the prefill
        chunk compute in ONE forward over a mixed batch — decode rows
        padded to the bucket width with only column 0 valid — then the
        remaining chunk-1 decode tokens follow. Returns the decode
        tokens [B, chunk] (host copy)."""
        try:
            groups, bucket = self._pop_fused_units()
            # every selected unit pads to the SAME group size
            Gp = max(self._group_pad(len(items)) for _, items, _ in groups)
            packs = [self._pack_prefill_rows(items, bucket, Gp)
                     for _, items, _ in groups]
            rows, pos, val, tab, li = (
                np.concatenate([p[i] for p in packs], axis=0)
                for i in range(5))
            prows, ppos, pval, ptab, plast = self._to_dev(rows, pos, val,
                                                          tab, li)
            if self._dev_state is None:
                self._dev_state = self._upload_slot_state()
            active, budget, stop = self._dev_state
            B, dev = self.B, self.device
            Gt, Pb = prows.shape
            maxpos = self.M * self.bs - 1
            tok, lengths = self.cur_tok, self.cache.lengths
            dtok = torch.zeros((B, Pb), dtype=torch.int32, device=dev)
            dtok[:, 0] = tok
            dpos = torch.clamp(lengths[:, None] + torch.arange(
                Pb, dtype=torch.int32, device=dev)[None], max=maxpos)
            dval = torch.zeros((B, Pb), dtype=torch.bool, device=dev)
            dval[:, 0] = active
            sub = self.cache._replace(
                table=torch.cat([self.cache.table, ptab], 0),
                lengths=torch.zeros((B + Gt,), dtype=torch.int32,
                                    device=dev))
            logits, _ = forward_paged(
                self.params, torch.cat([dtok, prows], 0), sub,
                torch.cat([dpos, ppos], 0), torch.cat([dval, pval], 0),
                self.cfg, is_prefill=False,
                attention_impl=self.attention_impl)
            pfirst = torch.argmax(
                logits[B:][torch.arange(Gt, device=dev), plast.long()],
                dim=-1).to(torch.int32)
            nxt, lengths, budget, active = self._emit_one(
                logits[:B, 0], tok, active, lengths, budget, stop)
            del logits
            toks, tok, lengths, budget, active = self._decode_steps(
                self.chunk - 1, nxt, lengths, budget, active, stop)
            # one host sync serves BOTH the decode chunk's tokens and the
            # prefill rows' first tokens
            host = torch.cat([torch.stack([nxt] + toks, dim=1).reshape(-1),
                              pfirst]).cpu().numpy()
        except Exception:
            self._fail_pending()
            raise
        self.cache = self.cache._replace(lengths=lengths)
        self.cur_tok = tok
        self._dev_state = (active, budget, stop)
        self.fused_steps += 1
        self.fused_unit_count += len(groups)
        toks, pfirst = host[:B * self.chunk].reshape(B, self.chunk), \
            host[B * self.chunk:]
        # commit IN ORDER: group g's real rows sit at [g*Gp, g*Gp+|items|)
        for g, (entries, items, final) in enumerate(groups):
            self.prefill_chunk_calls += len(items)
            if final:
                self._finish_unit(entries,
                                  pfirst[g * Gp:g * Gp + len(items)])
            else:
                entries[0][1] += 1
        return toks

    # -- self-speculative decoding (draft, verify in one call, commit only
    #    the accepted rows) -------------------------------------------------
    def spec_stats(self) -> Dict:
        """Speculative-decoding accounting: config + the SpecStats
        counters. `enabled` False (and config only) when the batcher
        decodes plain."""
        d = {"enabled": self.speculative, "backend": self.attention_impl}
        d.update(self._spec_cfg.as_dict(self.cfg.num_hidden_layers))
        d.update(self.spec.as_dict())
        return d

    def _draft_stack(self):
        """The draft's layers: the draft-from-w8 tree, or the target's
        first `depth` layers (views, no copy)."""
        if self._spec_dlayers is not None:
            return self._spec_dlayers
        return {k: w[:self._draft_depth]
                for k, w in self.params["layers"].items()}

    def _slab(self, depth: int, rows: int):
        cfg = self.cfg
        shape = (depth, self.B, rows, cfg.num_key_value_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def _spec_draft(self, active):
        """The chain draft: spec_k autoregressive proposals per slot off
        the draft stack, reading the committed pool READ-ONLY (layers
        0..depth-1 of the target's pool ARE the draft's cache) with its
        own proposals riding the slab. Returns drafts [B, spec_k]."""
        K, c = self.spec_k, self.cache
        maxpos = self.M * self.bs - 1
        layers = self._draft_stack()
        sk, sv = self._slab(self._draft_depth, K)
        tok, out = self.cur_tok, []
        for j in range(K):
            pos = torch.clamp(c.lengths[:, None] + j, max=maxpos)
            logits, sk, sv = _forward_spec(
                self.params, layers, tok[:, None], c, pos, c.lengths, sk, sv,
                j, self.cfg, attention_impl=self.attention_impl)
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            out.append(tok)
        return torch.stack(out, dim=1)

    def _spec_tree_draft(self, active):
        """The tree draft: level by level, one draft-stack forward scores
        ALL of the level's nodes at once (each node's slab visibility is
        its ancestor path) and top-k proposes tree[j] children per node —
        child 0 is the node's argmax, so the tree holds the chain draft's
        path. Level j's nodes land in slab rows [offs[j], offs[j+1]); the
        last level's proposals are never forwarded here (the verify
        computes their K/V). Returns drafts [B, spec_k] in slab-row order."""
        sc, c, B, dev = self._spec_cfg, self.cache, self.B, self.device
        tree = sc.tree
        D = len(tree)
        sizes, offs = sc.level_sizes(), sc.level_offsets()
        Sd = offs[D]                 # draft slab: root + levels 1..D-1
        maxpos = self.M * self.bs - 1
        A = sc.ancestor_mask()
        layers = self._draft_stack()
        sk, sv = self._slab(self._draft_depth, Sd)
        tok = self.cur_tok
        toks, out = tok[:, None], []
        for j in range(D):
            w = sizes[j]
            vis = torch.tensor([row[:Sd] for row in A[offs[j]:offs[j + 1]]],
                               dtype=torch.bool, device=dev)
            pos = torch.clamp(c.lengths + j, max=maxpos)[:, None].expand(B, w)
            logits, sk, sv = _forward_spec(
                self.params, layers, toks, c, pos, c.lengths, sk, sv,
                offs[j], self.cfg, vis=vis,
                attention_impl=self.attention_impl)
            top = torch.topk(logits, tree[j], dim=-1).indices  # [B, w, b]
            nxt = top.reshape(B, w * tree[j]).to(torch.int32)
            toks = torch.where(active[:, None], nxt, tok[:, None])
            out.append(toks)
        return torch.cat(out, dim=1)

    def _commit_rows(self, sk, sv, rows, pos, emit):
        """Verify-then-commit: write the accepted rows' slab K/V into the
        pool, every layer at once, one row at a time in order (the int8
        pool's grow-only scales then evolve as sequential decode's).
        Row r of slot b is slab row rows[b, r] at position pos[b, r],
        written where emit[b, r] (else to the sink): k + 1 masked writes
        a tick, no host read."""
        c, cfg, B = self.cache, self.cfg, self.B
        L, NB = cfg.num_hidden_layers, c.num_blocks + 1
        pools = [c.k.view(L * NB, *c.k.shape[2:]),
                 c.v.view(L * NB, *c.v.shape[2:])]
        scales = None if c.k_scale is None else \
            [c.k_scale.view(-1), c.v_scale.view(-1)]
        # each layer's blocks sit NB past the previous layer's
        off = (torch.arange(L, device=self.device) * (NB * self.bs))[:, None]
        b_idx = torch.arange(B, device=self.device)
        for r in range(rows.shape[1]):
            slots = _pool_slots(c.table, pos[:, r:r + 1], emit[:, r:r + 1],
                                c.num_blocks, self.bs)[:, 0]
            lslots = (slots[None] + off).reshape(L * B, 1)
            for i, slab in enumerate((sk, sv)):
                new = slab[:, b_idx, rows[:, r].long()].reshape(
                    L * B, 1, *slab.shape[3:])
                if scales is None:
                    _write_pool(pools[i], lslots, new)
                else:
                    _write_pool_int8(pools[i], scales[i], lslots, new)

    def _accept(self, g, tok, active, budget, stop, n_acc):
        """Emit g[:, 0..n_acc] per slot, truncated at the budget and at
        the first eos/stop emitted (tokens after an end never emit) — the
        `_emit_one` stopping rule over rows. Returns (emit [B, P] bool,
        n_emit, last token, budget', active')."""
        eos = -1 if self.eos is None else int(self.eos)
        P = g.shape[1]
        idx = torch.arange(P, device=self.device)[None, :]
        is_end = ((g == eos) | (g == stop[:, None])).to(torch.int32)
        ends_before = torch.cumsum(is_end, dim=1) - is_end
        emit = (idx <= n_acc[:, None]) & (idx < budget[:, None]) \
            & (ends_before == 0) & active[:, None]
        n_emit = emit.sum(dim=1, dtype=torch.int32)
        last = torch.gather(g, 1, torch.clamp(n_emit - 1, min=0)[:, None]
                            .long())[:, 0]
        last = torch.where(active & (n_emit > 0), last, tok)
        budget2 = budget - n_emit
        active2 = active & (budget2 > 0) & (last != eos) & (last != stop)
        return emit, n_emit, last, budget2, active2

    def _spec_verify(self, drafts, active, budget, stop, spec_ok):
        """The chain verify: score all spec_k + 1 positions (cur_tok + the
        proposals) in ONE full-depth pass over the read-only pool + slab,
        accept the longest prefix of proposals matching the target's own
        greedy tokens plus one corrected token, then commit only those
        rows. Returns (n_emit, n_acc, out tokens [B, k + 1], last,
        budget', active')."""
        c, K, dev = self.cache, self.spec_k, self.device
        P = K + 1
        maxpos = self.M * self.bs - 1
        tok = self.cur_tok
        toks_in = torch.cat([tok[:, None], drafts], dim=1)
        pos = torch.clamp(c.lengths[:, None]
                          + torch.arange(P, device=dev)[None], max=maxpos)
        sk, sv = self._slab(self.cfg.num_hidden_layers, P)
        logits, sk, sv = _forward_spec(
            self.params, self.params["layers"], toks_in, c, pos, c.lengths,
            sk, sv, 0, self.cfg, attention_impl=self.attention_impl)
        g = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, P]
        match = (drafts == g[:, :K]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        n_acc = torch.where(spec_ok, n_acc, 0)
        emit, n_emit, last, budget2, active2 = self._accept(
            g, tok, active, budget, stop, n_acc)
        rows = torch.arange(P, device=dev)[None].expand(self.B, P)
        self._commit_rows(sk, sv, rows, pos, emit)
        return n_emit, n_acc, torch.where(emit, g, 0), last, budget2, active2

    def _spec_tree_verify(self, drafts, active, budget, stop, spec_ok):
        """The tree verify: score the whole packed tree (root + every
        drafted node, slab visibility = the ancestor mask) in ONE
        full-depth pass, then walk it level by level following the
        target's own greedy tokens: at each accepted node the child whose
        draft token equals the target's continuation extends the path
        (top-k children are distinct, so at most one matches). The
        accepted path's rows — and only those — commit as the chain's.
        Returns the chain verify's tuple, sized to the path (depth + 1)."""
        c, sc, dev, B = self.cache, self._spec_cfg, self.device, self.B
        tree = sc.tree
        D = len(tree)
        offs = sc.level_offsets()
        S = sc.slab_rows()
        maxpos = self.M * self.bs - 1
        A = torch.tensor(sc.ancestor_mask(), dtype=torch.bool, device=dev)
        lv = torch.tensor(sc.row_levels(), dtype=torch.int32, device=dev)
        tok = self.cur_tok
        toks_in = torch.cat([tok[:, None], drafts], dim=1)      # [B, S]
        # siblings share a position; visibility separates them
        pos = torch.clamp(c.lengths[:, None] + lv[None], max=maxpos)
        sk, sv = self._slab(self.cfg.num_hidden_layers, S)
        logits, sk, sv = _forward_spec(
            self.params, self.params["layers"], toks_in, c, pos, c.lengths,
            sk, sv, 0, self.cfg, vis=A, attention_impl=self.attention_impl)
        g = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, S]
        cur = torch.zeros((B,), dtype=torch.long, device=dev)
        ci = torch.zeros_like(cur)
        alive = spec_ok
        n_acc = torch.zeros((B,), dtype=torch.int32, device=dev)
        path = [cur]
        for j in range(1, D + 1):
            b = tree[j - 1]
            crows = offs[j] + ci[:, None] * b \
                + torch.arange(b, device=dev)[None]
            ctoks = torch.gather(toks_in, 1, crows)
            tgt = torch.gather(g, 1, cur[:, None])
            hit = (ctoks == tgt) & alive[:, None]
            has = hit.any(dim=1)
            ci2 = ci * b + torch.argmax(hit.to(torch.int32), dim=1)
            cur = torch.where(has, offs[j] + ci2, cur)
            ci = torch.where(has, ci2, ci)
            n_acc = n_acc + has.to(torch.int32)
            alive = has
            path.append(cur)
        path = torch.stack(path, dim=1)                         # [B, D + 1]
        out_g = torch.gather(g, 1, path)
        emit, n_emit, last, budget2, active2 = self._accept(
            out_g, tok, active, budget, stop, n_acc)
        pos_path = torch.clamp(c.lengths[:, None]
                               + torch.arange(D + 1, device=dev)[None],
                               max=maxpos)
        self._commit_rows(sk, sv, path, pos_path, emit)
        return n_emit, n_acc, torch.where(emit, out_g, 0), last, budget2, \
            active2

    def _step_spec(self):
        """One speculative tick: the draft proposes, the target verifies
        and commits only the accepted rows. Returns (out tokens
        [B, width], n_emit [B]) as host arrays — ONE host read a tick
        (tokens, counts and acceptance together)."""
        if self._dev_state is None:
            self._dev_state = self._upload_slot_state()
        active, budget, stop = self._dev_state
        if self._spec_ok_dev is None:
            self._spec_ok_dev = torch.tensor(
                [self.slot_req[s] is not None
                 and self.slot_req[s] not in self._no_spec
                 for s in range(self.B)], dtype=torch.bool,
                device=self.device)
        tree = self.spec_tree is not None
        drafts = (self._spec_tree_draft if tree else self._spec_draft)(active)
        n_emit, n_acc, out, last, budget, active2 = (
            self._spec_tree_verify if tree else self._spec_verify)(
            drafts, active, budget, stop, self._spec_ok_dev)
        self.cache = self.cache._replace(lengths=self.cache.lengths + n_emit)
        B, W = out.shape
        host = torch.cat([out.reshape(-1), n_emit, n_acc]).cpu().numpy()
        out, n_emit, n_acc = (host[:B * W].reshape(B, W),
                              host[B * W:B * (W + 1)], host[B * (W + 1):])
        self.cur_tok = last
        self._dev_state = (active2, budget, stop)
        spec = [s for s in range(self.B) if self.active[s]
                and self.slot_req[s] not in self._no_spec]
        self.spec.record_step(
            drafted=self.spec_k * len(spec), accepted=int(n_acc.sum()),
            emitted=int(n_emit.sum()), slots=self.active.count(True),
            depths=[int(n_acc[s]) for s in spec])
        return out, n_emit

    def _spec_any(self) -> bool:
        """True when at least one ACTIVE slot takes part in speculation;
        with every active request opted out the plain chunk step is
        strictly better than a draft + verify emitting one token."""
        return any(self.active[s] and self.slot_req[s] not in self._no_spec
                   for s in range(self.B))

    def _emit_spec(self, decoding, out, n_emit) -> None:
        """Deliver one spec tick's emitted tokens (the host mirror of the
        device stopping rule) and retire finished slots."""
        for slot in decoding:
            rid = self.slot_req[slot]
            for j in range(int(n_emit[slot])):
                self.outputs[rid].append(int(out[slot, j]))
                self.budget[slot] -= 1
            o = self.outputs[rid]
            done = (self.budget[slot] <= 0
                    or (self.eos is not None and o and o[-1] == self.eos)
                    or (self.stop[slot] >= 0 and o
                        and o[-1] == self.stop[slot]))
            if done:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        rid = self.slot_req[slot]
        self.alloc.free(self.slot_blocks[slot])
        self._just_finished.append(rid)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.slot_blocks[slot] = None
        self.stop[slot] = -1
        self._dev_state = None        # host slot state diverged from device
        self._spec_ok_dev = None      # slot occupancy changed
        self._no_spec.discard(rid)

    def _drain_queue(self) -> None:
        """Prepare queued requests into the pending pipeline while a batch
        slot AND the KV blocks fit. Slots reserved by pending admissions
        are not handed out again."""
        reserved = {e[0].slot for e in self._pending}
        free = [s for s in range(self.B)
                if not self.active[s] and s not in reserved]
        recs: List[_Admission] = []
        try:
            while free and self.queue:
                _, toks0, _, mn0 = self.queue[0]
                need = self.blocks_needed(len(toks0), mn0)
                if need > self.alloc.free_blocks:
                    if (not any(self.active) and not recs
                            and not self._pending):
                        # nothing in flight will ever free blocks
                        raise RuntimeError(
                            f"request needs {need} blocks but the pool "
                            f"holds only {self.alloc.num_blocks} — size "
                            f"num_blocks for the largest single request")
                    break           # defer until a request retires
                rid, toks, stop, mn = self.queue.pop(0)
                recs.append(self._prepare_admission(
                    free.pop(0), rid, toks, stop, mn))
        except Exception:
            self._rollback(recs)
            raise
        for rec in recs:
            self._pending.append([rec, 0])

    def _fuse_now(self) -> bool:
        """Piggyback the next pending prefill unit on the decode chunk
        exactly when there IS pending prefill work, slots are decoding,
        and fusion is enabled."""
        return bool(self._fused and self._pending and any(self.active))

    def _admit(self) -> None:
        """Pull queued requests into the pending pipeline, then prefill
        standalone unless the next chunk will piggyback them."""
        self._drain_queue()
        if self._pending and not self._fuse_now():
            self._prefill_pending()

    def step(self):
        """Admit what fits, then run ONE device chunk — fused with pending
        prefill units when slots are decoding, plain decode otherwise.

        Returns (emitted, finished): `emitted` maps rid -> tokens newly
        generated since the last step() (the prefill's first token
        included), `finished` lists rids that completed this step (their
        blocks are already back in the pool)."""
        self._admit()
        if any(self.active):
            # slots committed by a fused admission AFTER the device call
            # must not read this chunk's token rows
            decoding = [s for s in range(self.B) if self.active[s]]
            if self.speculative and not self._fuse_now() \
                    and self._spec_any():
                # a speculative tick emits up to spec_k + 1 tokens a slot;
                # admissions still ride the fused path (greedy tokens do
                # not depend on which step kind emits them)
                out, n_emit = self._step_spec()
                self._emit_spec(decoding, out, n_emit)
                self._admit()
                return self._drain_emitted()
            toks = self._step_fused() if self._fuse_now() \
                else self._step_decode()
            for slot in decoding:
                rid = self.slot_req[slot]
                for j in range(self.chunk):
                    if self.budget[slot] <= 0:
                        break
                    t = int(toks[slot, j])
                    self.outputs[rid].append(t)
                    self.budget[slot] -= 1
                    if ((self.eos is not None and t == self.eos)
                            or t == self.stop[slot]):
                        break
                out = self.outputs[rid]
                done = (self.budget[slot] <= 0 or
                        (self.eos is not None and out and
                         out[-1] == self.eos) or
                        (self.stop[slot] >= 0 and out and
                         out[-1] == self.stop[slot]))
                if done:
                    self._retire(slot)
            self._admit()
        return self._drain_emitted()

    def _drain_emitted(self):
        """The step() return contract: (emitted rid -> new tokens,
        finished rids)."""
        emitted: Dict[int, List[int]] = {}
        for rid, n in list(self._delivered.items()):
            out = self.outputs.get(rid)
            if out is not None and len(out) > n:
                emitted[rid] = out[n:]
                self._delivered[rid] = len(out)
        finished, self._just_finished = self._just_finished, []
        for rid in finished:
            self._delivered.pop(rid, None)
        return emitted, finished

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue and all in-flight requests (greedy decode)."""
        while True:
            self.step()
            if not (any(self.active) or self.queue or self._pending):
                break
        return self.outputs
