"""paddle_tpu_torch.serving.speculative — self-speculative decoding:
config validation + acceptance accounting for the draft-and-verify
pipeline.

Port of paddle_tpu/serving/speculative.py (a copy, stdlib only, so the
batcher holds the config and stats without pulling the serving engine).
The device math lives in `nlp.paged` (`ContinuousBatcher(speculative=
True, spec_k=, draft_layers=, spec_tree=, spec_draft_w8=)`).

How self-speculation works (and why it needs no second weight set):
serving decode is memory-bound — every step sweeps the full weight
stack plus the live KV pool to emit ONE token per request. A draft
proposing k tokens lets the target *verify* all k+1 positions in one
sweep instead; greedy verification accepts the longest prefix of draft
tokens that match the target's own greedy choices, plus one corrected
token, so the output is the plain greedy decode's — speculation changes
the schedule, not the tokens (up to the rounding of two differently
ordered evaluations on the card). The draft is the SAME model with a
truncated layer stack (`draft_layers=d`): layer l's KV depends only on
layers < l, so the target's committed pool layers 0..d-1 ARE the
d-layer draft's KV cache.

Tree drafts: `tree=[b0, b1, ...]` drafts b0 candidates for the next
token, b1 children for each of those, and so on — a token tree of
sum(prod(b0..bj)) nodes packed into one suffix slab, scored by ONE
full-depth verify call whose per-query visibility is the node→ancestor
mask. Acceptance walks the tree level by level following the target's
greedy token; the accepted path commits row-sequentially exactly like
the chain. Child 0 of every node is the draft's own argmax, so the
tree's candidate set contains the chain's path.

The verify-then-commit invariant: neither the draft nor the verify's
scoring pass writes the KV pool. Proposed tokens' per-layer K/V ride a
slab; after acceptance is known (on the device) only the accepted rows
are committed — written one row at a time in order, so the int8 pool's
grow-only per-block scales evolve exactly as sequential decode's would.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["SpecConfig", "SpecStats"]


class SpecConfig:
    """Validated self-speculative decoding configuration.

    `k` is the chain draft length (tokens proposed per verify sweep;
    the verify scores k+1 positions and emits between 1 and k+1
    tokens). `draft_layers` is the truncated draft depth — None drafts
    at full depth (the draft IS the target: acceptance ~100%, useful
    for parity tests and for benches on random-init models whose
    truncated drafts never agree with the target).

    `tree` switches to tree drafts: a branching spec like [3, 2, 1]
    proposes 3 candidates for the next token, 2 children under each of
    those, 1 under each of those — `k` is then DERIVED (the total node
    count, the per-sweep draft budget) and the chain `k` argument is
    ignored. `draft_w8` makes the draft sweep read an int8 weight-only
    quantization of the truncated layer stack (built once at batcher
    construction when the target serves fp weights; a no-op when the
    target already serves weight_dtype="int8") — drafting then costs
    int8 weight bytes. Verification always runs the target's own
    weights, so emitted tokens are unchanged either way."""

    def __init__(self, k: int = 4, draft_layers: Optional[int] = None,
                 *, num_layers: Optional[int] = None,
                 tree: Optional[Sequence[int]] = None,
                 draft_w8: bool = False):
        if tree is None:
            self.tree: Optional[Tuple[int, ...]] = None
            self.k = int(k)
            if self.k < 1:
                raise ValueError(f"spec_k must be >= 1, got {k}")
        else:
            self.tree = tuple(int(b) for b in tree)
            if not self.tree or any(b < 1 for b in self.tree):
                raise ValueError(
                    f"spec tree must be a non-empty sequence of "
                    f"positive branching factors, got {tree!r}")
            # the per-sweep draft budget: every node of the packed tree
            # is one proposed token (the equal-k-budget comparison the
            # bench's tree-vs-chain gate uses)
            self.k = sum(self.level_sizes()[1:])
        self.draft_w8 = bool(draft_w8)
        if draft_layers is None:
            self.draft_layers = None
        else:
            self.draft_layers = int(draft_layers)
            if self.draft_layers < 1:
                raise ValueError(
                    f"draft_layers must be >= 1, got {draft_layers}")
            if num_layers is not None and self.draft_layers > num_layers:
                raise ValueError(
                    f"draft_layers {self.draft_layers} exceeds the "
                    f"model's {num_layers} layers")

    # -- tree geometry (all static host math; () / chain answers keep
    #    the chain path byte-identical to before trees existed) --------
    def tree_depth(self) -> int:
        """Levels below the root (0 for a chain config)."""
        return 0 if self.tree is None else len(self.tree)

    def level_sizes(self) -> List[int]:
        """Node count per level, level 0 = the root (current token):
        n_0 = 1, n_j = n_{j-1} * tree[j-1]."""
        sizes = [1]
        for b in (self.tree or ()):
            sizes.append(sizes[-1] * b)
        return sizes

    def level_offsets(self) -> List[int]:
        """Suffix-slab row where each level starts (row 0 = root, then
        levels packed contiguously in order) — one entry per level plus
        the total row count at the end."""
        off = [0]
        for n in self.level_sizes():
            off.append(off[-1] + n)
        return off

    def slab_rows(self) -> int:
        """Packed-tree suffix-slab rows: root + every drafted node."""
        return 1 + self.k if self.tree is not None else self.k + 1

    def row_levels(self) -> List[int]:
        """Level of each slab row (0 for the root row)."""
        out: List[int] = []
        for lv, n in enumerate(self.level_sizes()):
            out.extend([lv] * n)
        return out

    def row_parents(self) -> List[int]:
        """Parent slab row of each slab row (the root points at
        itself): child i of level j (0-indexed within the level) hangs
        under node i // tree[j-1] of level j-1."""
        if self.tree is None:
            return [0] + list(range(self.k))  # chain: row r-1; root self
        sizes, offs = self.level_sizes(), self.level_offsets()
        parents = [0]
        for j in range(1, len(sizes)):
            b = self.tree[j - 1]
            parents.extend(offs[j - 1] + i // b for i in range(sizes[j]))
        return parents

    def ancestor_mask(self) -> List[List[bool]]:
        """A[p][s] = slab row s is an ancestor of row p or p itself —
        the packed tree's per-query visibility (each node attends to
        the committed pool plus exactly its root-to-node path, so its
        verify logits equal the sequential prefix's). Static per
        config; the device side uploads it as a constant."""
        parents = self.row_parents()
        S = len(parents)
        mask = [[False] * S for _ in range(S)]
        for p in range(S):
            s = p
            mask[p][p] = True
            while s > 0:
                s = max(parents[s], 0)
                mask[p][s] = True
        return mask

    def depth(self, num_layers: int) -> int:
        """The draft's resolved layer count (None -> full depth)."""
        return num_layers if self.draft_layers is None \
            else self.draft_layers

    def key(self, num_layers: int) -> tuple:
        """The spec-config element of every compiled-shape memo key:
        a spec batcher's executables must never be confused with a
        plain one's (zero post-warmup recompiles is gated per config).
        Chain configs keep the pre-tree 3-tuple byte-identical; a tree
        spec appends its branching factors and draft_w8 appends a
        marker, so every shape-bearing knob lands in the key."""
        base = ("spec", self.k, self.depth(num_layers))
        if self.tree is not None:
            base = base + ("tree",) + self.tree
        if self.draft_w8:
            base = base + ("w8",)
        return base

    def as_dict(self, num_layers: Optional[int] = None) -> Dict[str, Any]:
        d: Dict[str, Any] = {"k": self.k,
                             "draft_layers": self.draft_layers}
        if self.tree is not None:
            d["tree"] = list(self.tree)
        if self.draft_w8:
            d["draft_w8"] = True
        if num_layers is not None:
            d["draft_depth"] = self.depth(num_layers)
        return d


class SpecStats:
    """Host-side acceptance accounting for the spec pipeline (updated
    once per verify step from already-host values — no device syncs).

    `drafted` counts draft proposals, `accepted` the proposals the
    target's greedy verification kept, `emitted` the tokens actually
    landed per verify sweep (accepted prefix + the corrected token,
    truncated by budget / eos) — `tokens_per_step` > 1 is the whole
    point of speculation, `accept_rate` is the draft-quality signal.
    `depth_hist` distributes per-(sweep, slot) accepted path lengths —
    the data tree-shape tuning reads (a tree whose deep levels never
    accept is wasted verify width); the engine drains fresh depths into
    the `spec_accept_depth` Prometheus histogram."""

    def __init__(self):
        self.steps = 0          # verify sweeps executed
        self.slot_sweeps = 0    # (sweep, active slot) pairs
        self.drafted = 0        # draft tokens proposed
        self.accepted = 0       # draft tokens the target accepted
        self.emitted = 0        # tokens emitted by verify sweeps
        self.depth_hist: Dict[int, int] = {}   # accepted path length -> n
        self._fresh_depths: List[int] = []     # since the last drain

    def record_step(self, drafted: int, accepted: int, emitted: int,
                    slots: int = 1,
                    depths: Optional[Sequence[int]] = None) -> None:
        """Fold one verify sweep's counts in (host ints only);
        `slots` = active slots the sweep decoded, `depths` = each
        participating slot's accepted path length this sweep."""
        self.steps += 1
        self.slot_sweeps += int(slots)
        self.drafted += int(drafted)
        self.accepted += int(accepted)
        self.emitted += int(emitted)
        for d in (depths or ()):
            d = int(d)
            self.depth_hist[d] = self.depth_hist.get(d, 0) + 1
            self._fresh_depths.append(d)

    def drain_depths(self) -> List[int]:
        """Accepted-path depths recorded since the last drain — the
        engine's gauge sync feeds these to the Prometheus histogram
        exactly once each."""
        out, self._fresh_depths = self._fresh_depths, []
        return out

    def accept_rate(self) -> float:
        """Accepted / drafted (0.0 before any draft ran)."""
        return self.accepted / self.drafted if self.drafted else 0.0

    def tokens_per_step(self) -> float:
        """Tokens emitted per (sweep, slot) — directly comparable to
        plain decode's 1.0 per slot per step; the >1 multiplier the
        bench's --speculative gate asserts."""
        return self.emitted / self.slot_sweeps if self.slot_sweeps \
            else 0.0

    def accepted_per_sweep(self) -> float:
        """Accepted draft tokens per (sweep, slot) — the tree-vs-chain
        comparison at equal k-budget (tokens_per_step folds in the
        always-emitted corrected token; this isolates draft quality)."""
        return self.accepted / self.slot_sweeps if self.slot_sweeps \
            else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "steps": self.steps, "slot_sweeps": self.slot_sweeps,
            "drafted": self.drafted,
            "accepted": self.accepted, "emitted": self.emitted,
            "accept_rate": round(self.accept_rate(), 4),
            "tokens_per_step": round(self.tokens_per_step(), 4),
            "accepted_per_sweep": round(self.accepted_per_sweep(), 4),
            "accept_depth_hist": {int(k): v for k, v in
                                  sorted(self.depth_hist.items())},
        }
