"""Paged KV-cache serving: block-table cache + ragged batch admission.

Port of paddle_tpu/nlp/paged.py: the block pool and its allocators (the
free list, and the refcounted one prefix caching shares blocks through),
the pool write (fp, or int8 codes with per-(layer, block) scales), the
paged attention, `forward_paged`, `paged_generate`, the speculative
score path (`_forward_spec`) and the `ContinuousBatcher` with bucketed
and chunked prefill, fused prefill+decode steps, lock-step decode
chunks, prefix caching with copy-on-write, int8 weights
(`weight_dtype`), the int8 KV pool (`kv_dtype`), self-speculative
decoding (chain and tree drafts, verify-then-commit), the trace hooks,
the flight recorder and the sampled step profiler. The tensor-parallel
mesh and KV export/import are later slices.

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
  * the batcher's memo of step shapes holds CUDA graphs where the JAX
    package holds AOT executables (`_StepGraph`): one capture per shape
    key, made lazily the first time the shape is met or ahead of time by
    `warmup_prefill`, replayed from then on; `compile_count` counts the
    captures. On the CPU an entry is the eager step bound to its key, so
    the counts are the JAX package's. The graphs return tokens, not
    logits (the LM head runs only on the rows a step reads), and share
    one memory pool. Decode syncs with the host once per chunk, a
    speculative tick once (tokens, counts and acceptance in one read);
  * the batcher's device state (block table, lengths, current tokens,
    the active/budget/stop mirrors) lives in tensors allocated once and
    written in place, since a replay reads fixed storage;
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

import time
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .._device import resolve_device
from ..quantization import kv as kvq
from ..serving.cache import PrefixCacheIndex
from ..serving.profiling import StepProfiler
from ..serving.speculative import SpecConfig, SpecStats
from ..serving.trace import FlightRecorder, TraceSink
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
    """Host-side free-list allocator over the pool's block ids:
    admission takes blocks from the free list, completion returns them —
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
        self._note_allocated(blocks)
        return blocks

    def _note_allocated(self, blocks: List[int]) -> None:
        self.reused_blocks += sum(1 for b in blocks if b in self._ever_used)
        self._ever_used.update(blocks)
        self.high_water = max(self.high_water,
                              self.num_blocks - self.free_blocks)

    def _check_returnable(self, b: int, seen: set, what: str) -> None:
        """A returned block id must be in range and not already free —
        a silent double free splices one block into the free list twice
        and two later requests end up writing the same KV block."""
        if not 0 <= b < self.num_blocks:
            raise ValueError(
                f"{what}: block id {b} out of range "
                f"[0, {self.num_blocks})")
        if b in self._free_set or b in seen:
            raise ValueError(
                f"{what}: block {b} is already free (double free)")

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the free list. Raises ValueError on
        out-of-range or already-free ids (double-free detection) before
        mutating anything."""
        seen: set = set()
        for b in blocks:
            self._check_returnable(b, seen, "free()")
            seen.add(b)
        self._free.extend(blocks)
        self._free_set.update(blocks)

    def release(self, blocks: List[int]) -> None:
        """Alias of free() so callers can be allocator-agnostic — the
        refcounting subclass gives release() decref semantics."""
        self.free(blocks)

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


class RefcountingBlockAllocator(BlockAllocator):
    """Refcounted allocator for prefix-cache block sharing.

    Three block states instead of two:

      * free        — on the free list, contents dead;
      * referenced  — refcount >= 1: held by one or more in-flight
        requests' block tables (several tables may name the same id);
      * cached      — refcount 0 but registered in the prefix index
        (`mark_cached`): contents preserved on an LRU list, reclaimable
        under pool pressure but revivable by `share()` until then.

    `allocate` prefers truly-free blocks and evicts LRU cached blocks
    only when it must (calling `on_evict(block)` so the prefix index
    unlinks them); `release` decrefs with double-free detection and
    parks cacheable blocks instead of freeing them; `share` bumps a
    live block or revives a cached one. `free_blocks` counts free AND
    cached — both are available to admission — which is exactly what
    the batcher's defer-on-no-blocks logic should see."""

    def __init__(self, num_blocks: int,
                 on_evict: Optional[Callable[[int], None]] = None):
        super().__init__(num_blocks)
        self._refs: List[int] = [0] * num_blocks
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU order
        self._cacheable: set = set()
        self._on_evict = on_evict
        self.evicted_blocks = 0

    def refcount(self, block: int) -> int:
        """Current refcount of `block` (0 for free AND cached blocks —
        check `is_cached` to tell them apart)."""
        return self._refs[block]

    def is_cached(self, block: int) -> bool:
        """True when `block` sits on the refcount-0 LRU cached list."""
        return block in self._cached

    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    def allocate(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise RuntimeError(
                f"pool exhausted: need {n} blocks, {len(self._free)} "
                f"free + {len(self._cached)} cached")
        blocks: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop(0)
                self._free_set.discard(b)
            else:
                # reclaim the least-recently-parked cached block; the
                # index must forget it before its contents are reused
                b, _ = self._cached.popitem(last=False)
                self._cacheable.discard(b)
                self.evicted_blocks += 1
                if self._on_evict is not None:
                    self._on_evict(b)
            self._refs[b] = 1
            blocks.append(b)
        self._note_allocated(blocks)
        return blocks

    def share(self, blocks: List[int]) -> None:
        """Add one reference per block: bump a live block's refcount or
        revive a cached one (pulling it off the eviction list). Raises
        ValueError for a block that is neither — sharing a free block
        would hand out dead contents. Validates the WHOLE list before
        mutating anything (no half-applied bumps on error)."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(
                    f"share(): block id {b} out of range "
                    f"[0, {self.num_blocks})")
            if self._refs[b] <= 0 and b not in self._cached:
                raise ValueError(
                    f"share(): block {b} is neither referenced nor "
                    f"cached — its contents are gone")
        for b in blocks:
            if self._refs[b] > 0:
                self._refs[b] += 1
            else:
                del self._cached[b]
                self._refs[b] = 1

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block. At refcount 0 a block parks on
        the LRU cached list when the prefix index still names it
        (`mark_cached`), else returns to the free list. Raises
        ValueError on out-of-range ids and on releasing a block whose
        refcount is already 0 (double free) — validated over the WHOLE
        list (duplicates counted) before any refcount moves, so a
        failed call never half-applies."""
        pending: Dict[int, int] = {}
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(
                    f"release(): block id {b} out of range "
                    f"[0, {self.num_blocks})")
            pending[b] = pending.get(b, 0) + 1
            if pending[b] > self._refs[b]:
                raise ValueError(
                    f"release(): block {b} has refcount "
                    f"{self._refs[b]} (double free)")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                if b in self._cacheable:
                    self._cached[b] = None      # newest end of the LRU
                else:
                    self._free.append(b)
                    self._free_set.add(b)

    def free(self, blocks: List[int]) -> None:
        """Refcount-aware: free() IS release() here, so allocator-
        agnostic callers (the batcher's retire path) behave correctly
        whichever allocator they hold."""
        self.release(blocks)

    def mark_cached(self, blocks: List[int]) -> None:
        """Blocks the prefix index registered: when their refcount hits
        0 they park on the cached LRU instead of the free list."""
        self._cacheable.update(blocks)

    def stats(self) -> Dict[str, int]:
        in_use = self.num_blocks - len(self._free) - len(self._cached)
        return {
            "capacity_blocks": self.num_blocks,
            "blocks_in_use": in_use,            # referenced only
            "cached_blocks": len(self._cached),  # reclaimable, not dead
            "high_water_blocks": self.high_water,
            "reused_blocks": self.reused_blocks,
            "evicted_blocks": self.evicted_blocks,
        }


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


class _Admission(NamedTuple):
    """One prepared-but-not-yet-activated admission: blocks are already
    allocated/shared (the COW clone waits for `_apply_cow`), the prompt's
    full blocks are registered in the prefix index so same-burst siblings
    hit, but the slot is not active until `_commit` — `_rollback` can
    still undo everything if the prefill fails."""
    slot: int
    rid: int
    toks: List[int]
    stop: int
    mn: int
    need: int
    matched: List[int]
    cached_len: int
    cow_src: Optional[int]
    fresh: List[int]
    inserted: List[int]
    chunks: List[Tuple[int, int, int]]   # (start, end, bucket) per chunk

    @property
    def blocks(self) -> List[int]:
        """The request's block chain: shared prefix, then its own."""
        return self.matched + self.fresh


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


def _forward_layers(params, tokens, cache: PagedKVCache, positions, valid,
                    cfg, is_prefill: bool, impl: str):
    """`forward_paged`'s decoder stack without the LM head: the hidden
    states [B, P, D] after the last layer (the pool written in place).
    The batcher's steps run the head on the rows they read only."""
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
    return x


def forward_paged(params, tokens, cache: PagedKVCache, positions, valid,
                  cfg, is_prefill: bool, attention_impl: str = "auto"):
    """tokens [B, P] at per-request absolute `positions` [B, P] →
    (logits [B, P, V] f32, cache'). Writes the new K/V into the pool in
    place; cache'.lengths = max(lengths, last position + 1).
    `attention_impl` "auto" lets the device decide; "ref" runs the plain
    versions even on CUDA tensors (the reference for the kernels)."""
    impl = resolve_attention_impl(attention_impl, cache.k.device)
    x = _forward_layers(params, tokens, cache, positions, valid, cfg,
                        is_prefill, impl)
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


# the Python launch counters of the kernels a batcher step reaches
_COUNTERS = ((flash_attention_fwd, "launches"),
             (ragged_paged_attention, "launches"),
             (ragged_paged_attention, "launches_int8"),
             (ragged_paged_attention, "launches_suffix"))


def _read_counters() -> List[int]:
    return [getattr(o, a) for o, a in _COUNTERS]


class _StepGraph:
    """One entry of the batcher's memo of step shapes: a device step
    bound to its shape key.

    Eager (the CPU, and the card's eager twin that `chip_smoke.py` holds
    the graphs to): calling the entry runs the step on the caller's
    tensors, launching the kernels on the card and their plain versions
    on the CPU.

    Graphed (the card): the step is captured once as a CUDA graph over
    the entry's own static input tensors, clones of `idle` — inputs that
    describe no live work: every row invalid, every slot inactive.
      * THE PASS BEFORE THE CAPTURE EXECUTES FOR REAL (it loads the
        kernels' libraries and settles the allocator and the cuBLAS
        workspace). On the idle inputs every K/V write goes to the
        pool's sink block and no live slot advances, so a lazy capture
        in the middle of serving leaves the pool and the slot state
        exactly as they were. The step must not write its inputs.
      * A call copies its inputs into the static tensors, replays and
        returns the graph's static outputs.
      * MEMORY. Every graph of a batcher shares one memory pool and is
        replayed only from the thread that owns the batcher, one at a
        time, so an output stays valid until the next replay of any of
        them: callers consume it at once (a host read, or a copy into
        the batcher's state). The steps return tokens, not logits, so
        no graph holds a [G, Pb, V] logits buffer.
      * LAUNCH COUNTERS. The kernel wrappers count when they run, and a
        replay runs none. The entry records how far each counter moved
        while the capture recorded the step's launches, takes that back
        (the capture itself launched nothing), and adds it at every
        replay, so the counters stay true.
      * NO FALLBACK. A capture that fails raises; no step runs eagerly
        in place of its graph.
    """

    def __init__(self, fn: Callable, idle: Dict[str, torch.Tensor],
                 graphed: bool, pool=None):
        self.fn = fn
        self.idle = idle
        self.graph = None
        self.static: Dict[str, torch.Tensor] = {}
        self.out = None
        self.deltas: List[int] = []
        if graphed:
            self._capture(idle, pool)

    def _capture(self, idle, pool) -> None:
        self.static = {k: v.clone() for k, v in idle.items()}
        dev = next(iter(self.static.values())).device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(**self.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        # OTHER THREADS run while a lazy capture is under way (request
        # submitters, a caller's own work on the card). "global" would
        # fail their CUDA calls or invalidate the capture; "thread_local"
        # lets them be and still refuses an unsafe call (a synchronize,
        # a copy from pageable host memory) made by the capturing thread
        # itself, which is what would break the graph; "relaxed" would
        # let that through unnoticed.
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = self.fn(**self.static)
        after = _read_counters()
        self.deltas = [a - b for a, b in zip(after, before)]
        for (obj, attr), b in zip(_COUNTERS, before):
            setattr(obj, attr, b)
        self.graph, self.out = graph, out

    @property
    def graphed(self) -> bool:
        return self.graph is not None

    def __call__(self, **inputs):
        if self.graph is None:
            return self.fn(**inputs)
        for name, t in inputs.items():
            self.static[name].copy_(t)
        self.graph.replay()
        for (obj, attr), d in zip(_COUNTERS, self.deltas):
            setattr(obj, attr, getattr(obj, attr) + d)
        return self.out


class ContinuousBatcher:
    """Continuous batching over the shared block pool.

    Host-side scheduler over device steps: a fixed set of B batch slots
    decodes in lock-step chunks; when a request finishes (eos or budget)
    its blocks return to the allocator and queued requests are admitted
    into the free slots by a bucketed prefill.

    Prefill is bucketed, chunked, and batched: the suffix pads to a
    power-of-two bucket ladder (masked through valid/positions), longer
    suffixes split into sequential largest-bucket chunks through the
    per-query-causal paged path, and same-bucket admissions in one burst
    prefill in a single call; `prefill_pad_tokens` counts the padding.

    Step shapes are memoized as in the JAX package, whose memo holds AOT
    executables: `_prefill_exe(G, Pb, cold)`, `_fused_exe(Gp, Pb)`,
    `_chunk_exe()`, `_spec_draft_exe()` and `_spec_verify_exe()`, keyed
    by the shape plus the speculative, quantization and backend parts of
    the key. On the card an entry is a CUDA graph of its step
    (`_StepGraph`), captured the first time its shape is met (as JAX
    compiles on first use) or ahead of time by `warmup_prefill()`, and a
    step is a replay; on the CPU an entry is the eager step bound to its
    key. `compile_count` and `prefill_compile_count` count the entries
    either way, the JAX package's numbers for the same config.

    Prefill is FUSED with decode (`fused_prefill=True`): when an
    admission lands while slots are decoding, one call carries
    `max_batch` decode rows PLUS up to `fused_units` bucket-sized units
    of prefill rows — the ragged paged attention mixed batch — so
    in-flight decoding advances by its chunk in the same step that
    prefills the admission. `fused_steps` counts piggybacked calls,
    `decode_stall_steps` counts standalone prefill calls that ran while
    slots were decoding (the unfused cost).

    Prefix caching (`prefix_cache=True`): a trie over full-block token
    contents (`serving.cache.PrefixCacheIndex`) and a refcounted pool
    (`RefcountingBlockAllocator`), so admissions sharing a prompt prefix
    share its KV blocks and prefill only their suffix. A prompt cached
    whole copies its last block (copy-on-write, the int8 scales with the
    codes) and recomputes only its last token. Retired sequences register
    their prompt and generated blocks, leaf first into the LRU.

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

    Observability: `trace` (a `serving.trace.TraceSink`, or True for a
    default one) collects per-request timelines (prepared /
    prefill_chunk / retired events); the always-on `flight` recorder
    keeps one record per step tick (mode, units, bucket, free slots and
    blocks, memo hit or miss), written BEFORE the device call so a
    failing step is the ring's last record; the `profiler`
    (`serving.profiling.StepProfiler`) fences every
    `profile_sample_every`-th tick. None of them reads a device value
    outside a fenced tick, and no memo key sees them.

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
                 prefix_cache: bool = False,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_prefill_bucket: int = 512,
                 fused_prefill: bool = True, fused_units: int = 1,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 speculative: bool = False, spec_k: int = 4,
                 draft_layers: Optional[int] = None,
                 spec_tree: Optional[Sequence[int]] = None,
                 spec_draft_w8: bool = False,
                 trace=None, flight_recorder_cap: int = 64,
                 profile_sample_every: int = 64,
                 replica_id: str = "r0",
                 device="cuda", _graphed: bool = True):
        self.device = resolve_device(device)
        if params["embed_tokens"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed_tokens'].device}, the "
                f"batcher on {self.device}: load them with "
                f"llama.params_from_numpy(..., device=...)")
        self.replica_id = str(replica_id)
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
        # per-request spec opt-out
        self._no_spec: set = set()
        self.B, self.bs = max_batch, block_size
        # the device picks the backend: the kernels on CUDA
        self.attention_impl = resolve_attention_impl("auto", self.device)
        # the memo keys' parts besides the shape, as in the JAX package:
        # the spec config (() when spec is off), the quantization pair
        self._qkey = (self.weight_dtype, self.kv_dtype)
        self._skey = ((self._spec_cfg.key(cfg.num_hidden_layers)
                       + (self.attention_impl,))
                      if self.speculative else ())
        self.max_total = max_total_len
        self.M = -(-max_total_len // block_size)
        self.max_new = max_new_tokens
        self.eos = eos_token_id
        self.chunk = chunk
        # prefill bucket ladder: suffixes pad to the smallest bucket that
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
        # the memo of step shapes (see the class docstring): on the card
        # CUDA graphs sharing ONE memory pool, replayed one at a time from
        # the thread that owns the batcher
        self._graphed = bool(_graphed) and self.device.type == "cuda"
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self._graphed else None
        self._prefill_cache: Dict[Tuple, _StepGraph] = {}
        self._fused_cache: Dict[Tuple, _StepGraph] = {}
        self._chunk_cache: Dict[Tuple, _StepGraph] = {}
        self._spec_cache: Dict[Tuple, _StepGraph] = {}
        # prepared-but-not-fully-prefilled admissions: [record, chunks
        # done] — the slot and blocks stay reserved for the whole
        # (possibly multi-chunk) prefill
        self._pending: List[List] = []
        self.fused_steps = 0          # piggybacked prefill calls
        self.fused_unit_count = 0     # prefill units those calls carried
        self.decode_stall_steps = 0   # standalone prefills that stalled
        self.prefill_chunk_calls = 0  # prefill rows computed
        # observed real chunk lengths (len -> count)
        self.prefill_suffix_hist: Dict[int, int] = {}
        self.profiler = StepProfiler(sample_every=profile_sample_every)
        if trace is True:
            trace = TraceSink()
        elif trace is False:
            trace = None
        elif trace is not None and not hasattr(trace, "emit"):
            raise TypeError(
                f"trace must be a serving.trace.TraceSink, True/False, "
                f"or None — got {type(trace).__name__}")
        self._trace = trace
        self.flight = FlightRecorder(cap=flight_recorder_cap)
        nb = num_blocks or (max_batch * self.M)
        if prefix_cache:
            self._pcache: Optional[PrefixCacheIndex] = \
                PrefixCacheIndex(block_size)
            self.alloc: BlockAllocator = RefcountingBlockAllocator(
                nb, on_evict=self._pcache.evict)
        else:
            self._pcache = None
            self.alloc = BlockAllocator(nb)
        k, v, ks, vs = init_pool(cfg, nb, block_size, self.device,
                                 kv_dtype=self.kv_dtype)
        dev = self.device
        # LIVE STATE STAYS IN PLACE: a replay reads fixed storage, so the
        # table, lengths, current tokens and the device mirrors of
        # (active, budget, stop) are allocated once here and only ever
        # written in place (`_commit`, `_retire` through the mirrors,
        # `_keep_state` after a step)
        self.cache = PagedKVCache(
            k, v, torch.zeros((max_batch, self.M), dtype=torch.int32,
                              device=dev),
            torch.zeros((max_batch,), dtype=torch.int32, device=dev), ks, vs)
        self.active = [False] * max_batch
        self.slot_req: List[Optional[int]] = [None] * max_batch
        self.slot_blocks: List[Optional[List[int]]] = [None] * max_batch
        self.slot_tokens: List[Optional[List[int]]] = [None] * max_batch
        self.budget = [0] * max_batch
        self.stop = [-1] * max_batch          # per-slot stop id (-1 = none)
        self.cur_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=dev)
        # device mirrors of (active, budget, stop): steps consume AND
        # return them, so steady-state decoding uploads nothing;
        # admission/retirement mark them stale and the next step copies
        # the host lists in
        self._dev_active = torch.zeros((max_batch,), dtype=torch.bool,
                                       device=dev)
        self._dev_budget = torch.zeros((max_batch,), dtype=torch.int32,
                                       device=dev)
        self._dev_stop = torch.full((max_batch,), -1, dtype=torch.int32,
                                    device=dev)
        self._dev_stale = False
        # [B] per-slot spec participation, refreshed the same way
        self._spec_ok = torch.zeros((max_batch,), dtype=torch.bool,
                                    device=dev)
        self._spec_ok_stale = True
        # HOST-TO-DEVICE COPIES INSIDE A TICK: a capturing stream refuses
        # them, so the tree's masks (constants of the SpecConfig) are
        # built here, once
        self._tree_consts = None
        if self.speculative and self.spec_tree is not None:
            sc = self._spec_cfg
            A = sc.ancestor_mask()
            offs = sc.level_offsets()
            Sd = offs[len(self.spec_tree)]
            self._tree_consts = (
                [torch.tensor([row[:Sd] for row in A[offs[j]:offs[j + 1]]],
                              dtype=torch.bool, device=dev)
                 for j in range(len(self.spec_tree))],
                torch.tensor(A, dtype=torch.bool, device=dev),
                torch.tensor(sc.row_levels(), dtype=torch.int32,
                             device=dev))
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
                      max_new_tokens: Optional[int] = None,
                      tokens: Optional[Sequence[int]] = None) -> int:
        """Pool blocks a request of this shape takes FROM the pool while
        in flight. With `tokens` and prefix caching on, blocks the cache
        holds live (refcount >= 1, pinned by another in-flight request)
        don't count — admission shares them instead of allocating. Cached
        refcount-0 matches still count: reviving one consumes a unit of
        `free_blocks` (free + cached) like a fresh allocation."""
        mn = self.max_new if max_new_tokens is None else int(max_new_tokens)
        need = -(-(prompt_len + mn) // self.bs)
        if tokens is not None and self._pcache is not None:
            matched, _, _ = self._match_cached(list(tokens))
            need -= sum(1 for b in matched if self.alloc.refcount(b) > 0)
        return need

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

    def kv_cached_bytes(self) -> int:
        """Bytes held by reclaimable (refcount-0, prefix-cached) blocks."""
        return self.alloc.stats().get("cached_blocks", 0) \
            * self.kv_block_bytes()

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

    def _match_cached(self, toks: List[int]
                      ) -> Tuple[List[int], int, Optional[int]]:
        """Prefix-cache lookup for a prompt: (matched block chain, cached
        token count, copy-on-write source block or None). Full-block
        matches are shared as-is. When the match covers the WHOLE prompt
        the final matched block is demoted to a copy-on-write source:
        admission copies its KV into a private block and recomputes only
        the prompt's last token there (cached length P-1), since sampling
        needs the last position's logits."""
        if self._pcache is None:
            return [], 0, None
        matched = self._pcache.match(toks)
        cached_len = len(matched) * self.bs
        cow_src = None
        if matched and cached_len == len(toks):
            cow_src = matched[-1]
            matched = matched[:-1]
            cached_len = len(toks) - 1
        return matched, cached_len, cow_src

    def prefix_cached_tokens(self, tokens: Sequence[int]) -> int:
        """Prompt tokens the prefix cache can serve right now (0 with the
        cache off): a trie walk, no refcount moves."""
        if self._pcache is None:
            return 0
        _, cached_len, _ = self._match_cached(list(tokens))
        return cached_len

    @property
    def prefill_buckets(self) -> Tuple[int, ...]:
        """The prefill bucket ladder (empty = bucketing disabled)."""
        return self._buckets

    @property
    def prefill_compile_count(self) -> int:
        """Distinct prefill shapes captured so far (memo entries on the
        CPU) — standalone (group, bucket, phase) AND fused (rows,
        bucket). Flat after `warmup_prefill()`."""
        return len(self._prefill_cache) + len(self._fused_cache)

    @property
    def compile_count(self) -> int:
        """EVERY captured step shape: the prefill/fused ladder plus the
        plain decode chunk plus the speculative draft/verify pair."""
        return (self.prefill_compile_count + len(self._chunk_cache)
                + len(self._spec_cache))

    def prefix_stats(self) -> Dict[str, Any]:
        """Prefix-cache counters: hits/misses/hit_tokens/hit_rate from the
        index plus the allocator's cached-block and eviction counts.
        `enabled` False (and nothing else) without the cache."""
        if self._pcache is None:
            return {"enabled": False}
        d: Dict[str, Any] = {"enabled": True}
        d.update(self._pcache.stats())
        astats = self.alloc.stats()
        d["cached_blocks"] = astats.get("cached_blocks", 0)
        d["evictions"] = astats.get("evicted_blocks", 0)
        return d

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
                self._requeue_poisoned(rec)
                return True
        for slot in range(self.B):
            if self.active[slot] and self.slot_req[slot] == rid:
                self._retire(slot)
                # an abort is the caller's bookkeeping, not a completion
                self._just_finished.remove(rid)
                self._delivered.pop(rid, None)
                return True
        return False

    def _requeue_poisoned(self, rec: _Admission) -> None:
        """Aborting the pending `rec` unlinked and freed `rec.inserted`
        before anyone wrote their KV; a co-pending record whose matched
        chain (or COW source) leans on those blocks would skip prefilling
        a prefix no one will compute. Roll back the pending tail from the
        first such record and push the requests back onto the queue
        front in order, so the next drain re-prepares them."""
        poisoned = set(rec.inserted)
        cut = None
        for i, (sib, _done) in enumerate(self._pending):
            refs = set(sib.matched)
            if sib.cow_src is not None:
                refs.add(sib.cow_src)
            if refs & poisoned:
                cut = i
                break
        if cut is None:
            return
        victims = [e[0] for e in self._pending[cut:]]
        self._rollback(victims)
        del self._pending[cut:]
        for v in victims:
            self._trace_emit(v.rid, "requeued", reason="poisoned_sibling")
        self.queue[:0] = [(v.rid, v.toks, v.stop, v.mn) for v in victims]

    def _upload_slot_state(self) -> None:
        """Host slot lists → the persistent device mirrors, by copy (a
        replay reads fixed storage), only after admission or retirement
        changed them: lock-step decode uploads nothing. These are the
        tick's HOST-TO-DEVICE COPIES, made outside every graph (a
        capturing stream refuses them), the spec participation mask
        `_spec_ok` among them."""
        if self._dev_stale:
            self._dev_active.copy_(torch.tensor(self.active))
            self._dev_budget.copy_(torch.tensor(self.budget,
                                                dtype=torch.int32))
            self._dev_stop.copy_(torch.tensor(self.stop, dtype=torch.int32))
            self._dev_stale = False
        if self._spec_ok_stale:
            self._spec_ok.copy_(torch.tensor(
                [self.slot_req[s] is not None
                 and self.slot_req[s] not in self._no_spec
                 for s in range(self.B)]))
            self._spec_ok_stale = False

    def _keep_state(self, tok, lengths, budget, active) -> None:
        """A step's advanced slot state → the live tensors, in place."""
        self.cur_tok.copy_(tok)
        self.cache.lengths.copy_(lengths)
        self._dev_budget.copy_(budget)
        self._dev_active.copy_(active)

    def _slot_inputs(self) -> Dict[str, torch.Tensor]:
        """The live slot state, as a decode-side memo entry takes it."""
        return dict(table=self.cache.table, tok=self.cur_tok,
                    lengths=self.cache.lengths, budget=self._dev_budget,
                    active=self._dev_active, stop=self._dev_stop)

    def _idle_slots(self) -> Dict[str, torch.Tensor]:
        """Slot-state inputs that describe no live work: every slot
        inactive, so a capture's real pass writes only the sink block."""
        B, dev = self.B, self.device

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return dict(table=z(B, self.M), tok=z(B), lengths=z(B),
                    budget=z(B), active=z(B, dtype=torch.bool),
                    stop=torch.full((B,), -1, dtype=torch.int32,
                                    device=dev))

    def _memo_entry(self, fn, idle) -> _StepGraph:
        return _StepGraph(fn, idle, self._graphed, self._graph_pool)

    # -- observability (host-side bookkeeping only: no device values) -----
    def _trace_emit(self, rid: int, kind: str, dur=None, **attrs) -> None:
        """Emit one per-request trace event (no-op without a sink).
        Every attr must already be a plain host value."""
        if self._trace is not None:
            self._trace.emit(rid, kind, dur=dur, **attrs)

    def _trace_chunks(self, items, bucket: int, fused: bool,
                      dur: float, device_dur=None) -> None:
        """One prefill_chunk event per packed row: which suffix span ran,
        at which bucket (and the padding that cost), fused or standalone,
        cold or continuing, and on the first chunk how many prompt tokens
        the prefix cache skipped; `device_dur` (seconds) when the sampled
        profiler fenced this call."""
        self.prefill_chunk_calls += len(items)
        if self._trace is None:
            return
        for rec, start, end in items:
            extra = {} if device_dur is None \
                else {"device_dur": round(device_dur, 6)}
            self._trace.emit(
                rec.rid, "prefill_chunk", dur=dur, slot=rec.slot,
                start=start, end=end, bucket=bucket,
                pad=bucket - (end - start), fused=fused, cold=start == 0,
                cached_tokens=rec.cached_len if start == rec.cached_len
                else 0, **extra)

    def _record_tick(self, mode: str, **fields) -> None:
        """One flight-recorder record for this step tick: the scheduler's
        decision plus pool/queue state, recorded BEFORE the device call
        so the tick that raises is the ring's last record."""
        self.flight.record(
            mode, active_slots=sum(self.active),
            queue_depth=len(self.queue), pending=len(self._pending),
            free_slots=self.free_slots(),
            free_blocks=self.alloc.free_blocks, **fields)

    def _profile_t0(self):
        """The sampled profiler's gate, taken once per device-call tick:
        a start mark when THIS tick is fenced (every
        `profile_sample_every`-th tick, or any tick of an armed capture
        window), None otherwise. The unfenced path reads nothing. On the
        card the mark holds a CUDA event recorded before the replay."""
        if not self.profiler.should_fence():
            return None
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return time.perf_counter(), ev

    def _profile_commit(self, t0, *, mode: str, bucket: int, units: int,
                        rids) -> Optional[float]:
        """Fence an already-issued step (a fenced tick only): host_s is
        the wall until the call returned, device_s the device time
        between CUDA events around the replay (one synchronize, on this
        tick alone; on the CPU the call's own wall). Records into the
        profiler's per-shape histograms and, with a sink, a device-lane
        trace span. Returns device_s, or None for an unfenced tick."""
        if t0 is None:
            return None
        t, ev0 = t0
        host_s = time.perf_counter() - t
        if ev0 is None:
            device_s = host_s
        else:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            ev1.synchronize()
            device_s = ev0.elapsed_time(ev1) / 1e3
        self.profiler.record(
            mode=mode, bucket=int(bucket), units=int(units),
            impl=self.attention_impl, weight_dtype=self.weight_dtype,
            kv_dtype=self.kv_dtype, device_s=device_s, host_s=host_s,
            detail={"rids": [int(r) for r in rids]})
        if self._trace is not None:
            self._trace.span(
                "device." + mode, dur=device_s, lane="device",
                mode=mode, bucket=int(bucket), units=int(units),
                host_s=round(host_s, 6), impl=self.attention_impl,
                replica_id=self.replica_id)
        return device_s

    # -- bucketed / chunked / batched prefill ------------------------------
    def _bucket_for(self, S: int) -> int:
        """Smallest ladder bucket that fits S tokens; with bucketing
        disabled the bucket IS the exact length."""
        for b in self._buckets:
            if b >= S:
                return b
        return S

    def _suffix_chunks(self, cached_len: int,
                       P: int) -> List[Tuple[int, int, int]]:
        """Split the still-to-prefill suffix [cached_len, P) into (start,
        end, bucket) chunks: largest-bucket pieces first, then one
        bucketed remainder."""
        out: List[Tuple[int, int, int]] = []
        start = cached_len
        cap = self._buckets[-1] if self._buckets else P - cached_len
        while P - start > cap:
            out.append((start, start + cap, cap))
            start += cap
        out.append((start, P, self._bucket_for(P - start)))
        return out

    def _group_pad(self, G: int) -> int:
        """Pad an admission group to the next power of two (capped at the
        batch width)."""
        return min(_pow2_ceil(max(1, G)), self.B)

    def _prefill_exe(self, G: int, Pb: int, cold: bool) -> _StepGraph:
        """The memo entry of the standalone prefill of G rows of Pb
        tokens, cold (flash over the rows themselves) or continuing
        (through the table). It returns each row's first token, the
        argmax at its last real position: the LM head runs on those G
        rows only."""
        key = (G, Pb, cold, self.attention_impl) + self._skey + self._qkey
        exe = self._prefill_cache.get(key)
        if exe is None:
            params, cfg, impl = self.params, self.cfg, self.attention_impl

            def prefill(rows, pos, val, tab, last):
                x = _forward_layers(params, rows,
                                    self.cache._replace(table=tab), pos,
                                    val, cfg, cold, impl)
                x = x[torch.arange(G, device=x.device), last]
                return torch.argmax(_final_head_cached(params, x, cfg),
                                    dim=-1).to(torch.int32)

            dev, M = self.device, self.M
            idle = dict(
                rows=torch.zeros((G, Pb), dtype=torch.int32, device=dev),
                pos=torch.zeros((G, Pb), dtype=torch.int32, device=dev),
                val=torch.zeros((G, Pb), dtype=torch.bool, device=dev),
                tab=torch.zeros((G, M), dtype=torch.int32, device=dev),
                last=torch.zeros((G,), dtype=torch.long, device=dev))
            exe = self._prefill_cache[key] = self._memo_entry(prefill, idle)
        return exe

    def warmup_prefill(self, buckets: Optional[Sequence[int]] = None,
                       group_sizes: Optional[Sequence[int]] = None,
                       modes: Sequence[bool] = (True, False),
                       fused: Optional[bool] = None) -> int:
        """Capture every step shape serving can hit ahead of time — each
        ladder bucket x each power-of-two group size x {cold, cached},
        plus (with fusion on) the fused decode+prefill step per reachable
        prefill-row count (units x group pad, units up to `fused_units`),
        plus the decode chunk, plus the speculative draft/verify pair
        when speculation is on: the JAX package's rules for which shapes
        are reachable. Returns the number of new entries. With bucketing
        disabled only the decode chunk warms."""
        ladder = self._buckets if buckets is None else tuple(buckets)
        if group_sizes is None:
            # exactly the shapes _group_pad can ever produce
            group_sizes = {self._group_pad(g) for g in range(1, self.B + 1)}
        n0 = self.compile_count
        for Pb in ladder:
            for G in sorted(set(group_sizes)):
                for cold in modes:
                    self._prefill_exe(int(G), int(Pb), bool(cold))
        if self._fused if fused is None else fused:
            # a fused call carries U same-bucket units padded to one group
            # size G: U*G rows. Every pending record holds a slot and the
            # step needs >= 1 active decode slot besides, so a call whose
            # widest unit pads to G (> G//2 records) riding with u-1 more
            # units (>= 1 record each) exists only when that minimum
            # record count fits in max_batch - 1
            rows = set()
            for G in sorted(set(int(g) for g in group_sizes)):
                need_widest = G // 2 + 1 if G > 1 else 1
                for u in range(1, self.fused_units + 1):
                    if need_widest + (u - 1) <= self.B - 1:
                        rows.add(u * G)
            for Pb in ladder:
                for Gt in sorted(rows):
                    self._fused_exe(Gt, int(Pb))
        self._chunk_exe()
        if self.speculative:
            self._spec_draft_exe()
            self._spec_verify_exe()
        return self.compile_count - n0

    def _prepare_admission(self, slot: int, rid: int, toks: List[int],
                           stop: int, mn: int,
                           quiet: bool = False) -> _Admission:
        """Blocks + prefix-cache bookkeeping for one admission, no model
        compute: share the matched chain, allocate the rest, and register
        the prompt's full blocks so same-burst siblings hit. The slot
        stays inactive until `_commit`."""
        P = len(toks)
        need = -(-(P + mn) // self.bs)
        # share the matched chain (pinning the COW source too, so
        # allocate() can't evict it before the copy), then allocate only
        # what the cache didn't supply
        matched, cached_len, cow_src = self._match_cached(toks)
        if cow_src is not None and self.alloc.refcount(cow_src) == 0:
            # a cached (refcount-0) COW source is revived ALONGSIDE its
            # fresh clone: one pool unit more than blocks_needed()
            # promised. When the pool can't afford it, recompute the final
            # block instead
            draw = (need - len(matched)
                    + sum(1 for b in matched
                          if self.alloc.refcount(b) == 0))
            if self.alloc.free_blocks < draw + 1:
                cow_src = None
                cached_len = len(matched) * self.bs
        pinned = matched + ([cow_src] if cow_src is not None else [])
        if pinned:
            self.alloc.share(pinned)
        try:
            fresh = self.alloc.allocate(need - len(matched))
        except Exception:
            if pinned:
                self.alloc.release(pinned)
            raise
        if self.kv_dtype == "int8" and fresh:
            # a recycled block keeps its previous tenant's scale: reset
            # the FRESH blocks to the never-written sentinel so
            # quantization depends only on what THIS request writes (a
            # COW clone takes its source's scales in `_apply_cow`).
            # Admission, outside every graph
            idx = torch.tensor(fresh, dtype=torch.long, device=self.device)
            self.cache.k_scale[:, idx] = 0.0
            self.cache.v_scale[:, idx] = 0.0
        inserted: List[int] = []
        if self._pcache is not None:
            # register the prompt's FULL blocks now so requests queued
            # behind this one share them while it is in flight;
            # `mark_cached` waits for `_commit`
            n_full = P // self.bs
            if n_full:
                owned = matched + fresh
                inserted = self._pcache.insert(toks[:n_full * self.bs],
                                               owned[:n_full])
        chunks = self._suffix_chunks(cached_len, P)
        if not quiet:
            self._trace_emit(rid, "prepared", slot=slot, prompt_len=P,
                             cached_tokens=cached_len,
                             cow=cow_src is not None, blocks=need,
                             chunks=len(chunks),
                             weight_dtype=self.weight_dtype,
                             kv_dtype=self.kv_dtype,
                             kv_block_bytes=self.kv_block_bytes(),
                             replica_id=self.replica_id,
                             attention_impl=self.attention_impl,
                             spec_backend=(self.attention_impl
                                           if self.speculative else None),
                             mesh_tp=1)
        return _Admission(slot, rid, list(toks), stop, mn, need, matched,
                          cached_len, cow_src, fresh, inserted, chunks)

    def _rollback(self, recs: Sequence[_Admission]) -> None:
        """Undo prepared-but-uncommitted admissions: unlink their index
        registrations (nothing may match KV that was never written), then
        return their blocks."""
        for rec in recs:
            if self._pcache is not None:
                for b in rec.inserted:
                    self._pcache.unlink(b)
            self.alloc.release(rec.fresh)
            pinned = rec.matched + ([rec.cow_src]
                                    if rec.cow_src is not None else [])
            if pinned:
                self.alloc.release(pinned)

    def _pack_prefill_rows(self, items, Pb: int, Gp: int):
        """Pack a unit's (record, start, end) chunks into [Gp, Pb] row
        arrays: rows pad to the bucket, the group to its power-of-two
        size; padding masks through `valid` and clamped positions.
        Returns (rows, pos, valid, table, last_idx) numpy arrays."""
        rows = np.zeros((Gp, Pb), np.int32)
        pos = np.zeros((Gp, Pb), np.int32)
        val = np.zeros((Gp, Pb), np.bool_)
        tab = np.zeros((Gp, self.M), np.int32)
        li = np.zeros((Gp,), np.int64)
        real = 0
        maxpos = self.M * self.bs - 1
        for g, (rec, start, end) in enumerate(items):
            S = end - start
            real += S
            rows[g, :S] = rec.toks[start:end]
            pos[g] = np.minimum(np.arange(start, start + Pb), maxpos)
            val[g, :S] = True
            tab[g, :rec.need] = rec.matched + rec.fresh
            li[g] = S - 1
        self.prefill_pad_tokens += Gp * Pb - real
        return rows, pos, val, tab, li

    def _to_dev(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _prefill_call(self, items, Pb: int, cold: bool):
        """Run ONE standalone prefill over a unit's rows. Returns each
        row's first token [Gp] (a device tensor, consumed at once)."""
        Gp = self._group_pad(len(items))
        rows, pos, val, tab, li = self._to_dev(
            *self._pack_prefill_rows(items, Pb, Gp))
        return self._prefill_exe(Gp, Pb, cold)(rows=rows, pos=pos, val=val,
                                               tab=tab, last=li)

    def _units(self, recs: Sequence[_Admission]) -> List[List[_Admission]]:
        """Partition pending records into execution units: single-chunk
        records with the same (bucket, phase) join the EARLIEST open unit
        of that key with room, provided moving them earlier jumps over no
        unit whose registered blocks they depend on (their matched chain
        plus COW source); a chunked record runs alone. A COW record never
        shares a unit with the record that registered its source: the
        clone reads the pool before the call."""
        units: List[List[_Admission]] = []
        keys: List[Optional[Tuple]] = []
        inserted: List[set] = []
        for rec in recs:
            if len(rec.chunks) > 1:
                units.append([rec])
                keys.append(None)
                inserted.append(set(rec.inserted))
                continue
            s, _, b = rec.chunks[0]
            k = (b, s == 0)
            deps = set(rec.matched)
            if rec.cow_src is not None:
                deps.add(rec.cow_src)
            target = None
            after: set = set()
            for i in range(len(units) - 1, -1, -1):
                if keys[i] == k and len(units[i]) < self.B \
                        and not (deps & after) \
                        and not (rec.cow_src is not None
                                 and rec.cow_src in inserted[i]):
                    target = i
                elif deps & after:
                    break
                after |= inserted[i]
            if target is not None:
                units[target].append(rec)
                inserted[target].update(rec.inserted)
            else:
                units.append([rec])
                keys.append(k)
                inserted.append(set(rec.inserted))
        return units

    def _apply_cow(self, unit: Sequence[_Admission]) -> None:
        """Apply a unit's copy-on-write clones right before its prefill
        (every earlier unit has written the pool by now): the source
        block's K/V into the record's first fresh block, and over an int8
        pool its scales too (codes mean nothing without them). Outside
        every graph, before the replay that reads them."""
        c = self.cache
        for rec in unit:
            if rec.cow_src is not None:
                dst, src = rec.fresh[0], rec.cow_src
                c.k[:, dst] = c.k[:, src]
                c.v[:, dst] = c.v[:, src]
                if c.k_scale is not None:
                    c.k_scale[:, dst] = c.k_scale[:, src]
                    c.v_scale[:, dst] = c.v_scale[:, src]

    def _commit(self, rec: _Admission, first: int) -> None:
        """Activate a successfully prefilled admission in its slot."""
        for start, end, _b in rec.chunks:
            self.prefill_suffix_hist[end - start] = \
                self.prefill_suffix_hist.get(end - start, 0) + 1
        if rec.cow_src is not None:
            self.alloc.release([rec.cow_src])  # pinned only for the copy
        P = len(rec.toks)
        if self._pcache is not None:
            self._pcache.note_admission(P, rec.cached_len)
            if rec.inserted:
                self.alloc.mark_cached(rec.inserted)
        owned = rec.matched + rec.fresh
        row = owned + [0] * (self.M - rec.need)
        self.cache.table[rec.slot] = torch.tensor(row, dtype=torch.int32)
        self.cache.lengths[rec.slot] = P
        self.cur_tok[rec.slot] = first
        self.active[rec.slot] = True
        self.slot_req[rec.slot] = rec.rid
        self.slot_blocks[rec.slot] = owned
        self.slot_tokens[rec.slot] = list(rec.toks)
        self.budget[rec.slot] = rec.mn - 1
        self.stop[rec.slot] = rec.stop
        self._dev_stale = True        # host slot state diverged from device
        self._spec_ok_stale = True    # slot occupancy changed
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
        Gp = self._group_pad(len(items))
        unit_rids = [r.rid for r, _, _ in items]
        self._record_tick(
            "prefill", rids=unit_rids, bucket=bucket, group_pad=Gp,
            cold=cold, final=final, stalls_decode=any(self.active),
            compile_hit=(Gp, bucket, cold, self.attention_impl)
            + self._skey + self._qkey in self._prefill_cache)
        t0 = time.perf_counter()
        self._apply_cow([e[0] for e in entries if e[1] == 0])
        t_prof = self._profile_t0()
        firsts = self._prefill_call(items, bucket, cold)
        dev_s = self._profile_commit(t_prof, mode="prefill", bucket=bucket,
                                     units=Gp, rids=unit_rids)
        if final:
            self._finish_unit(entries, firsts[:len(items)])
        else:
            entries[0][1] += 1
        self._trace_chunks(items, bucket, fused=False,
                           dur=time.perf_counter() - t0, device_dur=dev_s)

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
        """The units ONE fused call carries, in unit order: the head unit,
        plus up to `fused_units - 1` following units that prefill at the
        head unit's bucket and hold no block reference (matched chain or
        COW source) an earlier selected unit registered but will not have
        fully written (a non-final chunk's later blocks; a COW source,
        copied before the call). Returns (groups, bucket), groups =
        [(entries, items, final)]."""
        units = self._units([e[0] for e in self._pending])
        groups: List[Tuple[List, List, bool]] = []
        bucket0 = None
        inserted_sel: set = set()
        unwritten: set = set()
        for unit in units:
            if len(groups) >= self.fused_units:
                break
            entries, items, bucket, _cold, final = self._unit_view(
                unit, self._entries_of(unit))
            if bucket0 is None:
                bucket0 = bucket
            elif bucket != bucket0:
                break
            refs, cow_refs = set(), set()
            for rec in unit:
                refs.update(rec.matched)
                if rec.cow_src is not None:
                    cow_refs.add(rec.cow_src)
            if (refs | cow_refs) & unwritten or cow_refs & inserted_sel:
                break
            groups.append((entries, items, final))
            for rec in unit:
                inserted_sel.update(rec.inserted)
                if not final:
                    unwritten.update(rec.inserted)
        return groups, bucket0

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

    def _decode_steps(self, n, table, tok, lengths, budget, active, stop):
        """`n` single-token decode steps of every slot on the device (the
        LM head on each slot's one row); returns the tokens [n] tensors
        and the advanced state. Writes only the pool."""
        cache = self.cache._replace(table=table)
        toks = []
        for _ in range(n):
            x = _forward_layers(self.params, tok[:, None], cache,
                                lengths[:, None], active[:, None], self.cfg,
                                False, self.attention_impl)
            logits = _final_head_cached(self.params, x[:, 0], self.cfg)
            tok, lengths, budget, active = self._emit_one(
                logits, tok, active, lengths, budget, stop)
            toks.append(tok)
        return toks, tok, lengths, budget, active

    def _chunk_exe(self) -> _StepGraph:
        """The memo entry of the plain decode chunk: `chunk` tokens per
        slot. Returns (tokens [B, chunk], tok, lengths, budget, active)."""
        key = (self.chunk, self.attention_impl) + self._skey + self._qkey
        exe = self._chunk_cache.get(key)
        if exe is None:
            def run_chunk(table, tok, lengths, budget, active, stop):
                toks, tok, lengths, budget, active = self._decode_steps(
                    self.chunk, table, tok, lengths, budget, active, stop)
                return (torch.stack(toks, dim=1), tok, lengths, budget,
                        active)

            exe = self._chunk_cache[key] = self._memo_entry(
                run_chunk, self._idle_slots())
        return exe

    def _step_decode(self, decode_rids) -> np.ndarray:
        """The plain decode chunk: `chunk` tokens per slot, ONE host sync.
        Returns the tokens [B, chunk] (host copy)."""
        self._record_tick(
            "decode", rids=decode_rids,
            compile_hit=(self.chunk, self.attention_impl) + self._skey
            + self._qkey in self._chunk_cache)
        self._upload_slot_state()
        exe = self._chunk_exe()
        t_prof = self._profile_t0()
        toks, tok, lengths, budget, active = exe(**self._slot_inputs())
        self._profile_commit(t_prof, mode="decode", bucket=self.chunk,
                             units=0, rids=decode_rids)
        self._keep_state(tok, lengths, budget, active)
        return toks.cpu().numpy()

    def _fused_exe(self, Gt: int, Pb: int) -> _StepGraph:
        """The memo entry of the fused step with Gt prefill rows of Pb
        tokens: the first decode token and the prefill chunk compute in
        ONE forward over a mixed batch — decode rows padded to the bucket
        width with only column 0 valid — then the remaining chunk-1
        decode tokens follow. The LM head runs on each decode row's
        column 0 and each prefill row's last real position. Returns
        (decode tokens [B, chunk], prefill first tokens [Gt], tok,
        lengths, budget, active)."""
        key = (Gt, Pb, self.attention_impl) + self._skey + self._qkey
        exe = self._fused_cache.get(key)
        if exe is None:
            params, cfg, impl = self.params, self.cfg, self.attention_impl
            B, M, dev = self.B, self.M, self.device
            maxpos = self.M * self.bs - 1

            def run_fused(table, tok, lengths, budget, active, stop, prows,
                          ppos, pval, ptab, plast):
                dtok = torch.zeros((B, Pb), dtype=torch.int32, device=dev)
                dtok[:, 0] = tok
                dpos = torch.clamp(lengths[:, None] + torch.arange(
                    Pb, dtype=torch.int32, device=dev)[None], max=maxpos)
                dval = torch.zeros((B, Pb), dtype=torch.bool, device=dev)
                dval[:, 0] = active
                x = _forward_layers(
                    params, torch.cat([dtok, prows], 0),
                    self.cache._replace(table=torch.cat([table, ptab], 0)),
                    torch.cat([dpos, ppos], 0), torch.cat([dval, pval], 0),
                    cfg, False, impl)
                x = torch.cat([x[:B, 0], x[B:][torch.arange(Gt, device=dev),
                                               plast]], 0)
                logits = _final_head_cached(params, x, cfg)
                pfirst = torch.argmax(logits[B:], dim=-1).to(torch.int32)
                nxt, lengths, budget, active = self._emit_one(
                    logits[:B], tok, active, lengths, budget, stop)
                toks, tok, lengths, budget, active = self._decode_steps(
                    self.chunk - 1, table, nxt, lengths, budget, active,
                    stop)
                return (torch.stack([nxt] + toks, dim=1), pfirst, tok,
                        lengths, budget, active)

            idle = self._idle_slots()
            idle.update(
                prows=torch.zeros((Gt, Pb), dtype=torch.int32, device=dev),
                ppos=torch.zeros((Gt, Pb), dtype=torch.int32, device=dev),
                pval=torch.zeros((Gt, Pb), dtype=torch.bool, device=dev),
                ptab=torch.zeros((Gt, M), dtype=torch.int32, device=dev),
                plast=torch.zeros((Gt,), dtype=torch.long, device=dev))
            exe = self._fused_cache[key] = self._memo_entry(run_fused, idle)
        return exe

    def _step_fused(self) -> np.ndarray:
        """Piggyback up to `fused_units` pending prefill units on this
        step's decode chunk. Returns the decode tokens [B, chunk] (host
        copy)."""
        try:
            groups, bucket = self._pop_fused_units()
            # every selected unit pads to the SAME group size
            Gp = max(self._group_pad(len(items)) for _, items, _ in groups)
            decode_rids = [self.slot_req[s] for s in range(self.B)
                           if self.active[s]]
            unit_rids = [[r.rid for r, _, _ in items]
                         for _, items, _ in groups]
            Gt = len(groups) * Gp
            self._record_tick(
                "fused", units=unit_rids, decode_rids=decode_rids,
                bucket=bucket, group_pad=Gp, rows=Gt,
                compile_hit=(Gt, bucket, self.attention_impl) + self._skey
                + self._qkey in self._fused_cache)
            t0 = time.perf_counter()
            self._apply_cow([e[0] for entries, _, _ in groups
                             for e in entries if e[1] == 0])
            packs = [self._pack_prefill_rows(items, bucket, Gp)
                     for _, items, _ in groups]
            prows, ppos, pval, ptab, plast = self._to_dev(*(
                np.concatenate([p[i] for p in packs], axis=0)
                for i in range(5)))
            self._upload_slot_state()
            exe = self._fused_exe(Gt, bucket)
            t_prof = self._profile_t0()
            toks, pfirst, tok, lengths, budget, active = exe(
                **self._slot_inputs(), prows=prows, ppos=ppos, pval=pval,
                ptab=ptab, plast=plast)
            dev_s = self._profile_commit(
                t_prof, mode="fused", bucket=bucket, units=len(groups),
                rids=decode_rids + [r for u in unit_rids for r in u])
            # one host sync serves BOTH the decode chunk's tokens and the
            # prefill rows' first tokens
            B = self.B
            host = torch.cat([toks.reshape(-1), pfirst]).cpu().numpy()
        except Exception:
            self._fail_pending()
            raise
        self._keep_state(tok, lengths, budget, active)
        self.fused_steps += 1
        self.fused_unit_count += len(groups)
        fused_dur = time.perf_counter() - t0
        toks, pfirst = host[:B * self.chunk].reshape(B, self.chunk), \
            host[B * self.chunk:]
        # commit IN ORDER: group g's real rows sit at [g*Gp, g*Gp+|items|)
        for g, (entries, items, final) in enumerate(groups):
            if final:
                self._finish_unit(entries,
                                  pfirst[g * Gp:g * Gp + len(items)])
            else:
                entries[0][1] += 1
            self._trace_chunks(items, bucket, fused=True, dur=fused_dur,
                               device_dur=dev_s)
        return toks

    # -- self-speculative decoding (draft, verify in one call, commit only
    #    the accepted rows) -------------------------------------------------
    def _spec_key(self, phase: str) -> Tuple:
        """Memo key of the spec `phase` ("draft" | "verify") entry: spec
        geometry + backend + the spec and quantization key parts."""
        return (phase, self.spec_k, self._draft_depth,
                self.attention_impl) + self._skey + self._qkey

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

    def _spec_draft(self, table, lengths, tok, active):
        """The chain draft: spec_k autoregressive proposals per slot off
        the draft stack, reading the committed pool READ-ONLY (layers
        0..depth-1 of the target's pool ARE the draft's cache) with its
        own proposals riding the slab. Returns drafts [B, spec_k]."""
        K = self.spec_k
        c = self.cache._replace(table=table, lengths=lengths)
        maxpos = self.M * self.bs - 1
        layers = self._draft_stack()
        sk, sv = self._slab(self._draft_depth, K)
        out = []
        for j in range(K):
            pos = torch.clamp(lengths[:, None] + j, max=maxpos)
            logits, sk, sv = _forward_spec(
                self.params, layers, tok[:, None], c, pos, lengths, sk, sv,
                j, self.cfg, attention_impl=self.attention_impl)
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            out.append(tok)
        return torch.stack(out, dim=1)

    def _spec_tree_draft(self, table, lengths, tok, active):
        """The tree draft: level by level, one draft-stack forward scores
        ALL of the level's nodes at once (each node's slab visibility is
        its ancestor path, a constant built at construction) and top-k
        proposes tree[j] children per node — child 0 is the node's
        argmax, so the tree holds the chain draft's path. Level j's nodes
        land in slab rows [offs[j], offs[j+1]); the last level's
        proposals are never forwarded here (the verify computes their
        K/V). Returns drafts [B, spec_k] in slab-row order."""
        sc, B = self._spec_cfg, self.B
        tree = sc.tree
        D = len(tree)
        sizes, offs = sc.level_sizes(), sc.level_offsets()
        c = self.cache._replace(table=table, lengths=lengths)
        maxpos = self.M * self.bs - 1
        level_vis = self._tree_consts[0]
        layers = self._draft_stack()
        sk, sv = self._slab(self._draft_depth, offs[D])
        toks, out = tok[:, None], []
        for j in range(D):
            w = sizes[j]
            pos = torch.clamp(lengths + j, max=maxpos)[:, None].expand(B, w)
            logits, sk, sv = _forward_spec(
                self.params, layers, toks, c, pos, lengths, sk, sv,
                offs[j], self.cfg, vis=level_vis[j],
                attention_impl=self.attention_impl)
            top = torch.topk(logits, tree[j], dim=-1).indices  # [B, w, b]
            nxt = top.reshape(B, w * tree[j]).to(torch.int32)
            toks = torch.where(active[:, None], nxt, tok[:, None])
            out.append(toks)
        return torch.cat(out, dim=1)

    def _commit_rows(self, table, sk, sv, rows, pos, emit):
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
            slots = _pool_slots(table, pos[:, r:r + 1], emit[:, r:r + 1],
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

    def _spec_verify(self, table, lengths, tok, drafts, active, budget,
                     stop, spec_ok):
        """The chain verify: score all spec_k + 1 positions (cur_tok + the
        proposals) in ONE full-depth pass over the read-only pool + slab,
        accept the longest prefix of proposals matching the target's own
        greedy tokens plus one corrected token, then commit only those
        rows. Returns (n_emit, n_acc, out tokens [B, k + 1], last,
        budget', active')."""
        K, dev = self.spec_k, self.device
        P = K + 1
        maxpos = self.M * self.bs - 1
        c = self.cache._replace(table=table, lengths=lengths)
        toks_in = torch.cat([tok[:, None], drafts], dim=1)
        pos = torch.clamp(lengths[:, None]
                          + torch.arange(P, device=dev)[None], max=maxpos)
        sk, sv = self._slab(self.cfg.num_hidden_layers, P)
        logits, sk, sv = _forward_spec(
            self.params, self.params["layers"], toks_in, c, pos, lengths,
            sk, sv, 0, self.cfg, attention_impl=self.attention_impl)
        g = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, P]
        match = (drafts == g[:, :K]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        n_acc = torch.where(spec_ok, n_acc, 0)
        emit, n_emit, last, budget2, active2 = self._accept(
            g, tok, active, budget, stop, n_acc)
        rows = torch.arange(P, device=dev)[None].expand(self.B, P)
        self._commit_rows(table, sk, sv, rows, pos, emit)
        return n_emit, n_acc, torch.where(emit, g, 0), last, budget2, active2

    def _spec_tree_verify(self, table, lengths, tok, drafts, active, budget,
                          stop, spec_ok):
        """The tree verify: score the whole packed tree (root + every
        drafted node, slab visibility = the ancestor mask) in ONE
        full-depth pass, then walk it level by level following the
        target's own greedy tokens: at each accepted node the child whose
        draft token equals the target's continuation extends the path
        (top-k children are distinct, so at most one matches). The
        accepted path's rows — and only those — commit as the chain's.
        Returns the chain verify's tuple, sized to the path (depth + 1)."""
        sc, dev, B = self._spec_cfg, self.device, self.B
        tree = sc.tree
        D = len(tree)
        offs = sc.level_offsets()
        S = sc.slab_rows()
        maxpos = self.M * self.bs - 1
        _, A, lv = self._tree_consts
        c = self.cache._replace(table=table, lengths=lengths)
        toks_in = torch.cat([tok[:, None], drafts], dim=1)      # [B, S]
        # siblings share a position; visibility separates them
        pos = torch.clamp(lengths[:, None] + lv[None], max=maxpos)
        sk, sv = self._slab(self.cfg.num_hidden_layers, S)
        logits, sk, sv = _forward_spec(
            self.params, self.params["layers"], toks_in, c, pos, lengths,
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
        pos_path = torch.clamp(lengths[:, None]
                               + torch.arange(D + 1, device=dev)[None],
                               max=maxpos)
        self._commit_rows(table, sk, sv, path, pos_path, emit)
        return n_emit, n_acc, torch.where(emit, out_g, 0), last, budget2, \
            active2

    def _spec_draft_exe(self) -> _StepGraph:
        """The memo entry of the draft (chain or tree per the spec
        config): drafts [B, spec_k]."""
        key = self._spec_key("draft")
        exe = self._spec_cache.get(key)
        if exe is None:
            draft = self._spec_tree_draft if self.spec_tree is not None \
                else self._spec_draft
            idle = {k: v for k, v in self._idle_slots().items()
                    if k in ("table", "lengths", "tok", "active")}
            exe = self._spec_cache[key] = self._memo_entry(draft, idle)
        return exe

    def _spec_verify_exe(self) -> _StepGraph:
        """The memo entry of the verify (chain or tree) with its
        row-by-row commit: (out tokens [B, width], n_emit, n_acc, last,
        budget', active', lengths')."""
        key = self._spec_key("verify")
        exe = self._spec_cache.get(key)
        if exe is None:
            fn = self._spec_tree_verify if self.spec_tree is not None \
                else self._spec_verify

            def verify(table, lengths, tok, drafts, active, budget, stop,
                       spec_ok):
                n_emit, n_acc, out, last, budget2, active2 = fn(
                    table, lengths, tok, drafts, active, budget, stop,
                    spec_ok)
                return (out, n_emit, n_acc, last, budget2, active2,
                        lengths + n_emit)

            idle = self._idle_slots()
            dev = self.device
            idle.update(
                drafts=torch.zeros((self.B, self.spec_k), dtype=torch.int32,
                                   device=dev),
                spec_ok=torch.zeros((self.B,), dtype=torch.bool,
                                    device=dev))
            exe = self._spec_cache[key] = self._memo_entry(verify, idle)
        return exe

    def _step_spec(self):
        """One speculative tick: the draft proposes, the target verifies
        and commits only the accepted rows. Returns (out tokens
        [B, width], n_emit [B]) as host arrays — ONE host read a tick
        (tokens, counts and acceptance together)."""
        decode_rids = [self.slot_req[s] for s in range(self.B)
                       if self.active[s]]
        self._upload_slot_state()
        self._record_tick(
            "spec_draft", rids=decode_rids, k=self.spec_k,
            compile_hit=self._spec_key("draft") in self._spec_cache)
        t0 = time.perf_counter()
        live = self._slot_inputs()
        draft_exe = self._spec_draft_exe()
        t_prof = self._profile_t0()
        drafts = draft_exe(table=live["table"], lengths=live["lengths"],
                           tok=live["tok"], active=live["active"])
        self._profile_commit(t_prof, mode="spec_draft", bucket=self.spec_k,
                             units=0, rids=decode_rids)
        draft_s = time.perf_counter() - t0
        self._record_tick(
            "spec_verify", rids=decode_rids, k=self.spec_k,
            compile_hit=self._spec_key("verify") in self._spec_cache)
        t1 = time.perf_counter()
        verify_exe = self._spec_verify_exe()
        t_prof = self._profile_t0()
        out, n_emit, n_acc, last, budget, active2, lengths = verify_exe(
            **live, drafts=drafts, spec_ok=self._spec_ok)
        dev_s = self._profile_commit(t_prof, mode="spec_verify",
                                     bucket=self.spec_k, units=0,
                                     rids=decode_rids)
        B, W = out.shape
        host = torch.cat([out.reshape(-1), n_emit, n_acc]).cpu().numpy()
        self._keep_state(last, lengths, budget, active2)
        verify_s = time.perf_counter() - t1
        out, n_emit, n_acc = (host[:B * W].reshape(B, W),
                              host[B * W:B * (W + 1)], host[B * (W + 1):])
        spec = [s for s in range(self.B) if self.active[s]
                and self.slot_req[s] not in self._no_spec]
        self.spec.record_step(
            drafted=self.spec_k * len(spec), accepted=int(n_acc.sum()),
            emitted=int(n_emit.sum()), slots=self.active.count(True),
            depths=[int(n_acc[s]) for s in spec])
        if self._trace is not None:
            self._trace.span("spec_draft", dur=draft_s, k=self.spec_k,
                             slots=len(decode_rids),
                             replica_id=self.replica_id)
            for s in range(self.B):
                if self.active[s]:
                    extra = {} if dev_s is None \
                        else {"device_dur": round(dev_s, 6)}
                    self._trace_emit(
                        self.slot_req[s], "spec_verify", dur=verify_s,
                        accepted=int(n_acc[s]), emitted=int(n_emit[s]),
                        k=self.spec_k, **extra)
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
        blocks = self.slot_blocks[slot]
        self._trace_emit(rid, "retired", slot=slot,
                         generated=len(self.outputs.get(rid, [])))
        if self._pcache is not None:
            # register the finished sequence's FULL blocks (prompt +
            # generated) before releasing: at refcount 0 they park on the
            # cached LRU, so the next request with this prefix skips
            # their prefill. The last emitted token's KV was never
            # written, so the written length is P + m - 1
            gen = self.outputs.get(rid, [])
            prompt = self.slot_tokens[slot] or []
            kv_len = len(prompt) + max(0, len(gen) - 1)
            n_full = kv_len // self.bs
            if n_full:
                seq = (prompt + gen)[:n_full * self.bs]
                self.alloc.mark_cached(
                    self._pcache.insert(seq, blocks[:n_full]))
            # leaf-first into the LRU: a chain's deep blocks are evicted
            # before the prefix blocks other chains may still extend
            self.alloc.release(list(reversed(blocks)))
        else:
            self.alloc.free(blocks)
        self._just_finished.append(rid)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.slot_blocks[slot] = None
        self.slot_tokens[slot] = None
        self.stop[slot] = -1
        self._dev_stale = True        # host slot state diverged from device
        self._spec_ok_stale = True    # slot occupancy changed
        self._no_spec.discard(rid)

    def _drain_queue(self) -> None:
        """Prepare queued requests into the pending pipeline while a batch
        slot AND the KV blocks fit (cached-aware: blocks another
        in-flight request already pins for this prompt's prefix are
        shared, not drawn). Slots reserved by pending admissions are not
        handed out again."""
        reserved = {e[0].slot for e in self._pending}
        free = [s for s in range(self.B)
                if not self.active[s] and s not in reserved]
        recs: List[_Admission] = []
        try:
            while free and self.queue:
                _, toks0, _, mn0 = self.queue[0]
                need = self.blocks_needed(len(toks0), mn0, tokens=toks0)
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
                else self._step_decode([self.slot_req[s] for s in decoding])
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
