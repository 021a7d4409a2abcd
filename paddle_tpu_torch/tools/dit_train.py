"""The DiT-XL/2 train step of BASELINE config 3 over `mix/dit.py`.

    step, state, batch, cfg = build_dit_step(batch=96)
    state, metrics = step(state, batch)

The counterpart of bench.py:184-233 `build_dit_step` / `run_dit` (which
live in the JAX package's bench script, not in its package):
`DiTConfig.dit_xl_2()` (675M params, f32, bf16 compute, per-block
recompute), `dit.diffusion_loss`, its value and gradient over the
functional parameter tree, and `optimizer.quant_state.adamw_q(1e-4)`
(8-bit blockwise moments, the unfused chain); x0 and y come from
`numpy.random.default_rng(0)` as there. bench.py's jitted step closes
over one fixed key, so each of its steps draws the same timesteps, noise
and label drop; this step draws them once from a `torch.Generator`
seeded with 1 and reuses them every step (torch's numbers are not
jax.random's, so the draws differ from bench.py's).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..mix import dit
from ..nlp.train import value_and_grad
from ..optimizer import quant_state, transform


def build_dit_step(batch=96, device="cuda", cfg=None, seed=0):
    """→ (step, state, (x0, y), cfg): `step((params, opt_state), (x0, y))`
    → ((params, opt_state), {"loss": loss}); the params are updated in
    place. `cfg` defaults to `DiTConfig.dit_xl_2()`; the parameters come
    from `dit.init_params` with a generator seeded `seed`."""
    if cfg is None:
        cfg = dit.DiTConfig.dit_xl_2()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = dit.init_params(gen, cfg, device=device)
    tx = quant_state.adamw_q(1e-4)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal(
        (batch, cfg.in_channels, cfg.image_size, cfg.image_size))
        .astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, (batch,))
                         .astype(np.int32)).to(device)
    t, eps, drop = dit.draw(torch.Generator(device=device).manual_seed(1),
                            x0, cfg)

    def loss_fn(p, x0_, y_):
        return dit.diffusion_loss_given(p, x0_, y_, t, eps, drop, cfg)

    def step(state, batch_):
        params, opt = state
        loss, grads = value_and_grad(loss_fn, params, *batch_)
        with torch.profiler.record_function("optimizer"):
            updates, opt = tx.update(grads, opt, params)
            params = transform.apply_updates(params, updates)
        return (params, opt), {"loss": loss}

    return step, (params, tx.init(params)), (x0, y), cfg


def run_dit(batch=96, timed_steps=10, device="cuda", cfg=None):
    """bench.py's `run_dit`: 2 warm-up steps of `build_dit_step(batch,
    device, cfg)`, then `timed_steps` timed (host clock around work that
    ends in a synchronize on a card). Returns img/s, step ms, MFU against
    the H100's 989 TFLOP/s dense bf16 (with `dit.flops_per_image`), the
    parameter count and the losses."""
    step, state, data, cfg = build_dit_step(batch, device=device, cfg=cfg)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    losses = []
    for _ in range(2):
        state, m = step(state, data)
        losses.append(m["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, m = step(state, data)
        losses.append(m["loss"])
    sync()
    dt = time.perf_counter() - t0
    img_s = batch * timed_steps / dt
    return {"img_s": img_s, "step_ms": 1e3 * dt / timed_steps,
            "mfu": img_s * dit.flops_per_image(cfg) / 989e12,
            "params": dit.num_params(cfg),
            "losses": [float(x) for x in losses]}
