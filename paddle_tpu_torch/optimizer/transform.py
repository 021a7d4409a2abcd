"""The gradient transformations of optax that the training step uses.

The JAX package builds its optimizers from optax; optax is JAX, so the
port keeps its own small functional copy of the pieces `nlp/train.py`
needs: a `GradientTransformation` (init, update) pair, `identity`,
`chain`, `clip_by_global_norm`, `scale_by_adam`, `add_decayed_weights`,
`scale_by_learning_rate`, `adamw`, `global_norm`, `apply_updates` and
the schedules `warmup_cosine_decay_schedule` builds on. States are
NamedTuples of tensors shaped as optax's, so a state tree lines up leaf
for leaf with JAX's.

Trees are nested dicts / lists / tuples of tensors. Nothing here calls
`.item()`: counts, learning rates and norms stay tensors on the params'
device, so a step never waits for the card. Each update runs over the
tree's leaves grouped by (device, dtype), in chunks of at most
`CHUNK_NUMEL` values (`grouped_chunks`, which the eager optimizers share),
with `torch._foreach_*` ops, one multi-tensor op per operation of optax's
per-leaf formula and in its order (XLA fuses these in JAX; no Pallas
kernel is involved).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair: `init(params) -> state`,
    `update(updates, state, params=None) -> (updates, state)`."""
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


# ------------------------------------------------------------ tree helpers
def tree_leaves(tree):
    """Leaves in the order `jax.tree.leaves` gives for the same nested
    dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the same-structured `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _device(tree):
    return tree_leaves(tree)[0].device


# values one multi-tensor op covers at most: an update's f32 temporaries
# (about five of a chunk's size) then stay ~2.5 GB, where one op over a
# 2B-parameter group would hold ~40 GB at once
CHUNK_NUMEL = 1 << 27


def grouped_chunks(tensors):
    """[[index, ...]]: the indices of each (device, dtype) group of
    `tensors`, in runs of consecutive tensors of at most `CHUNK_NUMEL`
    values (one tensor at least), in the list's order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = []
    for idx in groups.values():
        run, n = [], 0
        for i in idx:
            if run and n + tensors[i].numel() > CHUNK_NUMEL:
                out.append(run)
                run, n = [], 0
            run.append(i)
            n += tensors[i].numel()
        out.append(run)
    return out


def _map_grouped(fn, tree, *rest):
    """`fn(leaves, *rest_leaves) -> list` over each chunk of a (device,
    dtype) group of `tree`'s leaves (`grouped_chunks`; and the
    same-structured `rest`), put back in `tree`'s structure."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    out = [None] * len(leaves)
    for idx in grouped_chunks(leaves):
        res = fn([leaves[i] for i in idx],
                 *([o[i] for i in idx] for o in others))
        for i, r in zip(idx, res):
            out[i] = r
    return _unflatten(tree, iter(out))


def _unflatten(tree, it):
    """`tree`'s structure with its leaves taken from `it` in the order of
    `tree_leaves` (sorted dict keys)."""
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(t, it) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over every leaf of Σ x²), an f32 tensor on the leaves'
    device; the per-leaf norms by `torch._foreach_norm` per chunk, their
    squares summed in the leaves' order."""
    leaves = tree_leaves(tree)
    norms = [None] * len(leaves)
    for idx in grouped_chunks(leaves):
        for i, n in zip(idx, torch._foreach_norm(
                [leaves[i] for i in idx], 2, dtype=torch.float32)):
            norms[i] = n
    total = torch.zeros((), dtype=torch.float32, device=_device(tree))
    for n in norms:
        total = total + n.square()
    return torch.sqrt(total)


def apply_updates(params, updates):
    """params + updates, IN PLACE: each parameter tensor keeps its
    storage and dtype (optax returns a new tree; the port updates the
    tree it was given and returns it)."""
    def add(ps, us):
        with torch.no_grad():
            if all(u.dtype == p.dtype for p, u in zip(ps, us)):
                torch._foreach_add_(ps, us)
            else:
                for p, u in zip(ps, us):
                    p.copy_((p + u).to(p.dtype))
        return ps
    return _map_grouped(add, params, updates)


# ---------------------------------------------------------- transformations
def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None:
                                  (updates, state))


def chain(*txs) -> GradientTransformation:
    """Apply `txs` in order; the state is the tuple of their states."""
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's form: t unchanged while the global norm is below
    `max_norm`, else (t / norm) · max_norm."""
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm

        def clip(ts):
            c = torch._foreach_div(ts, g_norm.to(ts[0].dtype))
            torch._foreach_mul_(c, max_norm)
            return [torch.where(trigger, t, x) for t, x in zip(ts, c)]
        return _map_grouped(clip, updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam: moments in the params' dtype, bias-corrected
    m̂ / (sqrt(v̂) + eps)."""
    def init(params):
        z = lambda p: torch.zeros_like(p)  # noqa: E731
        return ScaleByAdamState(
            torch.zeros((), dtype=torch.int32, device=_device(params)),
            tree_map(z, params), tree_map(z, params))

    def update(updates, state, params=None):
        count = state.count + 1
        cf = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=cf.device), cf)

        def moments(gs, ms, vs):
            mu = torch._foreach_mul(gs, 1 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(ms, b1))
            nu = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(nu, 1 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(vs, b2))
            return list(zip(mu, nu))

        def scale(ms, vs):
            out = torch._foreach_div(ms, bc1.to(ms[0].dtype))
            den = torch._foreach_div(vs, bc2.to(vs[0].dtype))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(out, den)
            return out

        pairs = _map_grouped(moments, updates, state.mu, state.nu)
        mu = tree_map(lambda _, mv: mv[0], updates, pairs)
        nu = tree_map(lambda _, mv: mv[1], updates, pairs)
        return _map_grouped(scale, mu, nu), ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return _map_grouped(lambda gs, ps: torch._foreach_add(
            gs, torch._foreach_mul(ps, weight_decay)), updates,
            params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """Multiply by −learning_rate; a schedule is called with the
    transformation's own step count (a tensor)."""
    if not callable(learning_rate):
        return GradientTransformation(
            lambda params: EmptyState(),
            lambda updates, state, params=None: (
                _map_grouped(lambda gs: torch._foreach_mul(
                    gs, -learning_rate), updates), state))

    def init(params):
        return ScaleByScheduleState(
            torch.zeros((), dtype=torch.int32, device=_device(params)))

    def update(updates, state, params=None):
        step = -learning_rate(state.count)
        return (_map_grouped(lambda gs: torch._foreach_mul(
                    gs, step.to(gs[0].dtype)), updates),
                ScaleByScheduleState(state.count + 1))

    return GradientTransformation(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax.adamw: −lr · (m̂ / (sqrt(v̂) + eps) + wd · p)."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


# ---------------------------------------------------------------- schedules
def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    def schedule(count):
        c = torch.clamp(count.float(), 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0
                          ) -> Callable:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, "
                         f"got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.float(), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """optax's definition: linear warm-up from `init_value` to
    `peak_value` over `warmup_steps`, then cosine decay to `end_value`
    over the remaining `decay_steps - warmup_steps` (`decay_steps`
    counts the warm-up)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)

    def schedule(count):
        return torch.where(count < warmup_steps, warm(count),
                           decay(count - warmup_steps))
    return schedule
