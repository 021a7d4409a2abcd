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
device, so a step never waits for the card.
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


def _sq_sum(x):
    """Σ x² in f32 without a full-size f32 copy of a bf16 leaf."""
    return torch.linalg.vector_norm(x, dtype=torch.float32).square()


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over every leaf of Σ x²), an f32 tensor on the leaves'
    device."""
    return torch.sqrt(sum(_sq_sum(x) for x in tree_leaves(tree)))


def apply_updates(params, updates):
    """params + updates, IN PLACE: each parameter tensor keeps its
    storage and dtype (optax returns a new tree; the port updates the
    tree it was given and returns it)."""
    def add(p, u):
        with torch.no_grad():
            p.copy_((p + u).to(p.dtype))
        return p
    return tree_map(add, params, updates)


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

        def clip(t):
            return torch.where(trigger, t,
                               (t / g_norm.to(t.dtype)) * max_norm)
        return tree_map(clip, updates), state

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
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates,
                      state.nu)
        count = state.count + 1
        cf = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=cf.device), cf)
        out = tree_map(lambda m, v: (m / bc1.to(m.dtype)) / (
            torch.sqrt(v / bc2.to(v.dtype)) + eps), mu, nu)
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return tree_map(lambda g, p: g + weight_decay * p, updates,
                        params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """Multiply by −learning_rate; a schedule is called with the
    transformation's own step count (a tensor)."""
    if not callable(learning_rate):
        return GradientTransformation(
            lambda params: EmptyState(),
            lambda updates, state, params=None: (
                tree_map(lambda g: -learning_rate * g, updates), state))

    def init(params):
        return ScaleByScheduleState(
            torch.zeros((), dtype=torch.int32, device=_device(params)))

    def update(updates, state, params=None):
        step = -learning_rate(state.count)
        return (tree_map(lambda g: step.to(g.dtype) * g, updates),
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
