"""The training step of the flagship models, on one device.

Port of paddle_tpu/nlp/train.py with `mesh=None`: `TrainState`,
`make_optimizer`, `init_state` and `make_train_step`. The JAX step is one
jitted function; here it runs eagerly: loss and gradients by
`torch.autograd.grad` over the parameter tree, then the optimizer. With
the 8-bit optimizer (`state_quant="8bit"`) the step takes the fused
apply, one kernel launch per leaf; otherwise the (update,
apply_updates) pair of `optimizer.transform`.

Unlike the JAX step, which returns a new state, the step updates the
parameters and optimizer moments IN PLACE (the tensors of the state it
was given) and returns a TrainState holding them. Nothing in the step
reads a value back to the host: loss, grad norm, learning rate and the
step count stay tensors on the device.

`model` is the module of the model trained, as in the JAX step:
`nlp.llama` (default) or `nlp.moe`; each gives `init_params` and
`loss_fn`. The mesh and the pipeline schedules are the multi-GPU slice
and raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .._device import resolve_device
from ..optimizer import transform
from ..optimizer.quant_state import adamw_q_fused
from . import llama


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any


def make_optimizer(learning_rate=3e-4, weight_decay=0.1, b1=0.9, b2=0.95,
                   grad_clip=1.0, warmup_steps=0, total_steps=10000,
                   state_quant: Optional[str] = None):
    """AdamW + cosine schedule + global-norm clip. `state_quant="8bit"`
    (or its alias "int8") stores the moments as blockwise float8 codes
    with the clip streamed into the fused update (`adamw_q_fused`);
    None keeps moments in the params' dtype behind an optax-style
    clip_by_global_norm."""
    if warmup_steps:
        sched = transform.warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps, total_steps)
    else:
        sched = learning_rate
    if state_quant is None:
        adam = transform.adamw(sched, b1=b1, b2=b2, weight_decay=weight_decay)
    elif state_quant in ("8bit", "int8"):
        return adamw_q_fused(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                             clip_norm=grad_clip or None)
    else:
        raise ValueError(f"unknown state_quant {state_quant!r}")
    return transform.chain(
        transform.clip_by_global_norm(grad_clip) if grad_clip
        else transform.identity(), adam)


def _single_device(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh is not ported yet: it comes with the "
            "multi-GPU slice")


def init_state(generator, cfg, tx, mesh=None, device="cuda",
               model=llama) -> TrainState:
    """Parameters of `model` (the training tree, every leaf in
    `cfg.param_dtype`) and optimizer state, made on `device`;
    `generator` seeds them."""
    _single_device(mesh)
    dev = resolve_device(device)
    params = model.init_params(cfg, generator, device=dev, training=True)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                      params, tx.init(params))


def value_and_grad(lfn, params, *args):
    """(loss, grads) of lfn(params, *args) with respect to every leaf,
    through detached aliases of the leaves (the caller's tensors are not
    marked as requiring grad); a leaf the loss does not use gets zeros,
    as `jax.value_and_grad` gives."""
    leaves = transform.tree_leaves(params)
    alias = {id(p): p.detach().requires_grad_(True) for p in leaves}
    live = transform.tree_map(lambda p: alias[id(p)], params)
    with torch.enable_grad():
        loss = lfn(live, *args)
        grads = torch.autograd.grad(loss, [alias[id(p)] for p in leaves],
                                    materialize_grads=True)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    return loss.detach(), transform.tree_map(lambda p: by_id[id(p)], params)


def make_train_step(cfg, tx, mesh=None,
                    num_microbatches: Optional[int] = None,
                    grad_accum_steps: int = 1, device="cuda",
                    model=llama) -> Callable:
    """Build the train step `step(state, tokens) -> (state, metrics)`,
    metrics = {"loss", "grad_norm" (pre-clip), "step"}, all device
    tensors, for `model.loss_fn` (`nlp.llama` or `nlp.moe`). The
    state's params and moments are updated in place.

    grad_accum_steps > 1 splits the batch into that many STRIDED chunks
    (chunk i holds rows i, i + n, i + 2n, ...), as the JAX step does,
    and averages loss and grads over them before one optimizer update.
    `device` is where the state lives; the card by default, and asking
    for it without one raises."""
    _single_device(mesh)
    dev = resolve_device(device)
    if num_microbatches is not None:
        raise NotImplementedError(
            "num_microbatches (pipeline parallelism) is not ported yet: it "
            "comes with the multi-GPU slice")
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {grad_accum_steps}")

    def lfn(p, t):
        return model.loss_fn(p, t, cfg)

    def step_fn(state: TrainState, tokens):
        p0 = transform.tree_leaves(state.params)[0]
        if p0.device.type != dev.type or tokens.device != p0.device:
            raise ValueError(f"the state and tokens must live on {dev}; got "
                             f"params on {p0.device}, tokens on "
                             f"{tokens.device}")
        if grad_accum_steps > 1:
            b = tokens.shape[0]
            if b % grad_accum_steps:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum_steps "
                    f"{grad_accum_steps}")
            # strided (row-interleaved) chunks, as the JAX step cuts them
            chunks = tokens.reshape((b // grad_accum_steps, grad_accum_steps)
                                    + tuple(tokens.shape[1:])).transpose(0, 1)
            gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                           device=tokens.device)
            for mtoks in chunks:
                l, g = value_and_grad(lfn, state.params, mtoks)
                gsum = g if gsum is None else transform.tree_map(
                    torch.add, gsum, g)
                lsum = lsum + l
            grads = transform.tree_map(lambda g: g / grad_accum_steps, gsum)
            loss = lsum / grad_accum_steps
        else:
            loss, grads = value_and_grad(lfn, state.params, tokens)
        grad_norm = transform.global_norm(grads)
        with torch.no_grad():
            if hasattr(tx, "apply_fused"):
                params, opt = tx.apply_fused(grads, state.opt_state,
                                             state.params, grad_norm)
            else:
                updates, opt = tx.update(grads, state.opt_state,
                                         state.params)
                params = transform.apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": grad_norm, "step": state.step}
        return TrainState(state.step + 1, params, opt), metrics

    return step_fn
