"""paddle_tpu_torch.serving.cache — automatic prefix cache over shared KV
blocks.

The port's own copy of paddle_tpu/serving/cache.py (host-side only, no
torch): the same trie, the same statistics.

Reference analog: vLLM-style automatic prefix caching (the Ragged Paged
Attention serving stack, PAPERS.md): requests that share a prompt prefix
share the KV *blocks* holding that prefix instead of re-prefilling from
token zero. The paged layout makes this free on the device side —
the block table is already an indirection, so sharing is purely a
host-side bookkeeping change: the same pool block id appears in several
requests' table rows.

Two host-side pieces cooperate:

  * `PrefixCacheIndex` (here) — a trie over FULL-block token contents
    mapping a prompt prefix to the chain of pool block ids that already
    hold its KV. Match granularity is a whole block: a block is
    shareable only once every one of its `block_size` positions is
    written, so the partially-filled tail of a prompt is never shared
    (see the copy-on-write rule in `ContinuousBatcher._admit_one`).
  * `RefcountingBlockAllocator` (`paddle_tpu_torch.nlp.paged`) — per-block
    refcounts plus an LRU list of refcount-0 *cached* blocks whose KV is
    preserved for future hits until pool pressure evicts them; eviction
    calls back into `PrefixCacheIndex.evict` so the index never points
    at a reclaimed block.

Single-writer discipline: like the `ContinuousBatcher` that owns it, the
index is only ever touched from the engine thread — no locks here, by
design.

Keys are exact token tuples, not hashes of them: a trie edge stores the
block's full token content, so a "hash collision" cannot alias two
different prefixes to the same KV (the usual content-hash scheme needs a
verify step; the exact-key trie IS the verify step).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCacheIndex"]


class _TrieNode:
    """One full block of a cached prefix chain: `key` is the block's
    token tuple, `block` the pool block id holding its KV, `children`
    the continuation edges, `parent` the children-dict this node lives
    in (so eviction can unlink without a root walk)."""

    __slots__ = ("key", "block", "children", "parent")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Dict[Tuple[int, ...], "_TrieNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}


class PrefixCacheIndex:
    """Trie over full-block token contents → cached KV block-id chains.

    `match(tokens)` returns the longest chain of pool block ids whose
    recorded contents equal the prompt's leading full blocks;
    `insert(tokens, blocks)` registers a request's full blocks at
    admission (prompt) and retirement (prompt + generated), and
    `evict(block)` unlinks a block the allocator reclaimed. The caller
    (ContinuousBatcher) owns refcounts — the index never frees anything.
    """

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = int(block_size)
        self._children: Dict[Tuple[int, ...], _TrieNode] = {}  # trie root
        self._by_block: Dict[int, _TrieNode] = {}
        # admission-observed stats (the serving metrics surface)
        self.hits = 0                 # admissions with cached_tokens > 0
        self.misses = 0               # admissions served fully cold
        self.hit_tokens = 0           # prefill tokens skipped (saved)
        self.prompt_tokens = 0        # prefill tokens requested in total
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    def __len__(self) -> int:
        return len(self._by_block)

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached chain for this prompt: pool block ids holding
        tokens[0:block_size], tokens[block_size:2*block_size], ... Reads
        only — refcount bumps (`share`) are the caller's move."""
        bs = self.block_size
        out: List[int] = []
        children = self._children
        for i in range(len(tokens) // bs):
            node = children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if node is None:
                break
            out.append(node.block)
            children = node.children
        return out

    def insert(self, tokens: Sequence[int],
               blocks: Sequence[int]) -> List[int]:
        """Register a chain of FULL blocks (len(tokens) must equal
        len(blocks) * block_size, block i holding tokens[i*bs:(i+1)*bs]).
        When a prefix node already exists its incumbent block id is kept
        (the newcomer's block simply stays uncached — first writer wins,
        so concurrent identical prompts converge on one chain). Returns
        the block ids newly added to the index; the caller must
        `mark_cached` them on its allocator."""
        bs = self.block_size
        if len(tokens) != len(blocks) * bs:
            raise ValueError(
                f"insert(): {len(tokens)} tokens is not "
                f"{len(blocks)} full blocks of {bs}")
        new: List[int] = []
        children = self._children
        for i, blk in enumerate(blocks):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                node = _TrieNode(key, int(blk), children)
                children[key] = node
                self._by_block[int(blk)] = node
                new.append(int(blk))
                self.inserted_blocks += 1
            children = node.children
        return new

    def evict(self, block: int) -> None:
        """Unlink the node holding `block` (allocator eviction callback).
        Descendant nodes become unreachable from the root — matches stop
        at the hole — but stay registered in the block map so their own
        eviction (they are older in the allocator's LRU or still live)
        cleans them up; memory stays bounded by the pool size."""
        if self.unlink(block):
            self.evicted_blocks += 1

    def unlink(self, block: int) -> bool:
        """Remove `block` from the index WITHOUT counting an eviction —
        the admission-rollback path undoes registrations whose KV was
        never written, which is not pool pressure and must not show up
        as `evicted_blocks` on the metrics surface. Returns True when
        the block was indexed."""
        node = self._by_block.pop(block, None)
        if node is None:
            return False
        if node.parent.get(node.key) is node:
            del node.parent[node.key]
        return True

    def note_admission(self, prompt_len: int, cached_tokens: int) -> None:
        """Record one admission's hit accounting (called by the batcher
        with the prefix length it actually reused)."""
        self.prompt_tokens += int(prompt_len)
        self.hit_tokens += int(cached_tokens)
        if cached_tokens > 0:
            self.hits += 1
        else:
            self.misses += 1

    @property
    def hit_rate(self) -> float:
        """Fraction of requested prefill tokens served from cache."""
        return self.hit_tokens / self.prompt_tokens \
            if self.prompt_tokens else 0.0

    def stats(self) -> Dict[str, float]:
        """Plain-dict counters for the serving metrics snapshot."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "hit_rate": round(self.hit_rate, 6),
            "indexed_blocks": len(self._by_block),
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
        }
