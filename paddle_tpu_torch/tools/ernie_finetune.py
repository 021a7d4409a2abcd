"""The ERNIE-3.0 finetune step of BASELINE config 1 over `nlp/ernie.py`.

    step, state, batch, cfg = build_ernie_step(batch=64, seq=512)
    state, metrics = step(state, batch)

The counterpart of bench.py:134-181 `build_ernie_step` (which lives in
the JAX package's bench script, not in its package):
`ernie.finetune_loss`, its value and gradient over the functional
parameter tree, and `optimizer.transform.adamw(2e-5)` (optax's adamw
with optax's defaults), f32 parameters and bf16 compute, the same batch
every step. The batch is padded as a finetune loader pads it: each
row's valid length is drawn uniform in `lengths` from a fixed seed, and
the [B, S] `attention_mask` (True on a row's tokens) goes to the
encoder, whose flash kernels take it as their key-padding mask.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nlp import ernie
from ..nlp.train import value_and_grad
from ..optimizer import transform


def padded_batch(cfg, batch, seq, lengths=(128, 512), seed=0,
                 device="cuda"):
    """(input_ids, labels, attention_mask) from default_rng(seed): ids and
    labels uniform, the valid lengths uniform in [lengths[0],
    lengths[1]], the mask True on each row's first `length` tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq))
    labels = rng.integers(0, cfg.num_labels, (batch,))
    valid = rng.integers(lengths[0], lengths[1] + 1, (batch,))
    mask = np.arange(seq)[None, :] < valid[:, None]
    return tuple(torch.from_numpy(a).to(device) for a in (ids, labels, mask))


def build_ernie_step(batch=64, seq=512, device="cuda", cfg=None,
                     lengths=(128, 512), seed=0):
    """→ (step, state, batch, cfg): `step((params, opt_state), (ids,
    labels, mask))` → ((params, opt_state), {"loss": loss}); the params
    are updated in place. `cfg` defaults to `ErnieConfig.ernie3_base`
    with bench.py's recipe (no remat, the unrolled layer scan)."""
    if cfg is None:
        cfg = ernie.ErnieConfig.ernie3_base(num_labels=2, remat=False,
                                            scan_unroll=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ernie.init_params(cfg, gen, device=device)
    tx = transform.adamw(2e-5)

    def loss_fn(p, ids, labels, mask):
        return ernie.finetune_loss(p, ids, labels, cfg,
                                   attention_mask=mask)

    def step(state, batch_):
        params, opt = state
        loss, grads = value_and_grad(loss_fn, params, *batch_)
        with torch.profiler.record_function("optimizer"):
            updates, opt = tx.update(grads, opt, params)
            params = transform.apply_updates(params, updates)
        return (params, opt), {"loss": loss}

    data = padded_batch(cfg, batch, seq, lengths, seed, device)
    return step, (params, tx.init(params)), data, cfg
