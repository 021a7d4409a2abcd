"""The port's ERNIE slice against the JAX package, on the CPU.

Two parts, each on the same numpy inputs:

- the key-masked flash attention (`flash_attention_masked`, in 'bhsd'
  and 'bshd'): the JAX package's runs its Pallas kernels in interpret
  mode (`FLAGS_pallas_interpret`, restored after), the port its kernels'
  plain versions, which csrc/flash_fwd.cu and csrc/flash_bwd.cu are held
  to on the card: output, LSE and grads at hd 64, an unaligned S (96),
  one batch row whose keys are all masked (0 out, no gradient, as the
  TPU kernel gives) and padded keys (dk = dv = 0);
- `nlp/ernie.py` at a tiny f32 config with a JAX `init_params` tree moved
  by `params_from_numpy`: `forward`, `finetune_loss` and `mlm_loss` with
  a padding mask, every gradient, and two steps of `adamw` against
  optax's.

Tolerances: f32 on both sides, differing in summation order only (and,
for the flash kernel, in the online softmax's block order): 1e-5 of
each tensor's largest element for outputs, the LSE and the losses, 1e-4
for gradients (sums over the sequence); parameters after two AdamW
steps of lr 1e-3 within 1 % of the distance the steps can move one.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from paddle_tpu.core import flags as jflags  # noqa: E402
from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.nlp import ernie as jernie  # noqa: E402

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.nlp import ernie as ternie  # noqa: E402
from paddle_tpu_torch.optimizer import transform  # noqa: E402
from paddle_tpu_torch.nlp.train import value_and_grad  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-2
STEPS, LR = 2, 1e-3


def _close(a, b, tol, what, floor=1e-30):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), floor)
    assert err <= tol, f"{what}: {err} > {tol}"


@contextlib.contextmanager
def _interpret():
    """FLAGS_pallas_interpret on, and back to its previous value after."""
    prev = jflags.get_flags("FLAGS_pallas_interpret")
    jflags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        yield
    finally:
        jflags.set_flags(prev)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_masked_flash_matches_pallas_interpret(layout):
    B, S, H, hd = 3, 96, 2, 64
    rng = np.random.default_rng(1 if layout == "bhsd" else 2)
    shape = (B, H, S, hd) if layout == "bhsd" else (B, S, H, hd)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    lengths = np.array([0, 40, 96])     # row 0: every key masked
    mask = np.arange(S)[None, :] < lengths[:, None]
    qj, kj, vj, gj, mj = map(jnp.asarray, (q, k, v, g, mask))
    with _interpret():
        out_j, vjp = jax.vjp(
            lambda a, b, c: jfa.flash_attention_masked(a, b, c, mj, None,
                                                       layout), qj, kj, vj)
        grads_j = vjp(gj)
        _, lse_j = jfa.flash_attention_padded(
            qj, kj, vj, causal=False, return_lse=True, interpret=True,
            key_mask=mj, layout=layout)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    mt = torch.from_numpy(mask)
    out_t = tfa.flash_attention_masked(qt, kt, vt, mt, None, layout)
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt), torch.from_numpy(g))
    _, lse_t = tfa.flash_attention_fwd(qt.detach(), kt.detach(), vt.detach(),
                                       causal=False, return_lse=True,
                                       key_mask=mt, layout=layout)
    out_t = out_t.detach().numpy()
    _close(out_t, np.array(out_j), TOL, "out")
    _close(lse_t.numpy()[1:], np.array(lse_j)[1:], TOL, "lse")
    assert (lse_t.numpy()[0] <= -1e29).all()
    assert (np.array(lse_j)[0] <= -1e29).all()
    for n, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        _close(a.numpy(), np.array(b), GRAD_TOL, n)
    # the kernel's semantics: an all-masked row gives 0 and no gradient,
    # padded keys get none
    row0 = (lambda x: x[0])
    assert not out_t[0].any() and not np.array(out_j)[0].any()
    assert not grads_t[0].numpy()[0].any()
    seq = (lambda x: x[1, :, 40:]) if layout == "bhsd" else \
        (lambda x: x[1, 40:])
    for a, b in zip(grads_t[1:], grads_j[1:]):
        assert not seq(a.numpy()).any() and not seq(np.array(b)).any()
        assert not row0(a.numpy()).any()


def test_masked_flash_cpu_counts_no_launch():
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    x = torch.randn(2, 2, 16, 64, requires_grad=True)
    m = torch.ones(2, 16, dtype=torch.bool)
    tfa.flash_attention_masked(x, x, x, m, None, "bhsd").sum().backward()
    assert tfa.flash_attention_fwd.launches == 0
    assert tfa.flash_attention_bwd.launches == 0 and x.grad is not None


def test_block_aligned_matches_jax():
    for s in (32, 96, 128, 200, 256, 384, 500, 512, 768, 1000, 1024):
        assert tfa.block_aligned(s) == jfa.block_aligned(s), s


def _cfg(mod, dt):
    return mod.ErnieConfig.tiny(dtype=dt, hidden_size=128,
                                num_attention_heads=2, intermediate_size=256)


@pytest.fixture(scope="module")
def ernie_pair():
    """A numpy tree of the JAX tiny ERNIE's `init_params` structure (its
    recipe: N(0, 0.02) matrices, unit norm scales; the biases drawn too,
    so that their gradients flow through nonzero values), and a padded
    batch: ids, labels, MLM labels, a [B, S] mask."""
    cfg_j = _cfg(jernie, jnp.float32)
    shapes = jax.eval_shape(lambda: jernie.init_params(jax.random.key(0),
                                                       cfg_j))
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("_scale"):
            return np.ones(leaf.shape, np.float32)
        return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    # the port's own init_params makes the same keys and shapes
    mine = ternie.init_params(_cfg(ternie, torch.float32), device="cpu")
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
    rng = np.random.default_rng(3)
    B, S = 3, 32
    ids = rng.integers(0, cfg_j.vocab_size, (B, S))
    labels = rng.integers(0, cfg_j.num_labels, (B,))
    mlm = np.where(rng.random((B, S)) < 0.3, ids, -100)
    mask = np.arange(S)[None, :] < np.array([32, 20, 9])[:, None]
    return tree, ids, labels, mlm, mask


def test_ernie_forward_losses_and_grads_match_jax(ernie_pair):
    tree, ids, labels, mlm, mask = ernie_pair
    cfg_j, cfg_t = _cfg(jernie, jnp.float32), _cfg(ternie, torch.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = ternie.params_from_numpy(tree, cfg_t, device="cpu")
    idj, idt = jnp.asarray(ids), torch.from_numpy(ids)
    mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
    seq_j, pooled_j = jax.jit(
        lambda p: jernie.forward(p, idj, attention_mask=mj, cfg=cfg_j))(pj)
    seq_t, pooled_t = ternie.forward(pt, idt, attention_mask=mt, cfg=cfg_t)
    _close(seq_t.numpy(), np.array(seq_j), TOL, "sequence output")
    _close(pooled_t.numpy(), np.array(pooled_j), TOL, "pooled output")
    # mask None at an unaligned S: both take the all-ones masked route
    _close(ternie.encode(pt, idt, cfg=cfg_t).numpy(),
           np.array(jax.jit(lambda p: jernie.encode(p, idj, cfg=cfg_j))(pj)),
           TOL, "no mask")
    for name, lab in (("finetune_loss", labels), ("mlm_loss", mlm)):
        fj = getattr(jernie, name)
        ft = getattr(ternie, name)
        loss_j, g_j = jax.jit(jax.value_and_grad(
            lambda p: fj(p, idj, jnp.asarray(lab), cfg_j,
                         attention_mask=mj)))(pj)
        loss_t, g_t = value_and_grad(
            lambda p: ft(p, idt, torch.from_numpy(lab), cfg_t,
                         attention_mask=mt), pt)
        _close([float(loss_t)], [float(loss_j)], TOL, name)
        flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(g_j)[0]}
        flat_t = {}
        for k, v in g_t.items():
            if isinstance(v, dict):
                flat_t.update({f"{k}/{kk}": vv for kk, vv in v.items()})
            else:
                flat_t[k] = v
        assert set(flat_t) == set(flat_j)
        # a gradient that cancels to ~0 (the key bias's, under the
        # shift-invariant softmax) is held relative to a thousandth of
        # the model's largest
        floor = 1e-3 * max(np.abs(np.array(x)).max()
                           for x in flat_j.values())
        for k in flat_j:
            a, b = flat_t[k].numpy(), np.array(flat_j[k])
            if not np.abs(b).max():
                assert not np.abs(a).max(), k      # unused head: zeros
                continue
            _close(a, b, GRAD_TOL, f"{name} grad {k}", floor)


def test_ernie_adamw_steps_match_optax(ernie_pair):
    tree, ids, labels, _, mask = ernie_pair
    cfg_j, cfg_t = _cfg(jernie, jnp.float32), _cfg(ternie, torch.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = ternie.params_from_numpy(tree, cfg_t, device="cpu")
    txj, txt = optax.adamw(LR), transform.adamw(LR)
    sj, st = txj.init(pj), txt.init(pt)
    idj, idt = jnp.asarray(ids), torch.from_numpy(ids)
    lj, lt = jnp.asarray(labels), torch.from_numpy(labels)
    mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
    losses = {"jax": [], "torch": []}
    @jax.jit
    def jax_step(p, s):
        loss, g = jax.value_and_grad(
            lambda p_: jernie.finetune_loss(p_, idj, lj, cfg_j,
                                            attention_mask=mj))(p)
        upd, s = txj.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    for _ in range(STEPS):
        pj, sj, loss = jax_step(pj, sj)
        losses["jax"].append(float(loss))
        loss, g = value_and_grad(
            lambda p: ternie.finetune_loss(p, idt, lt, cfg_t,
                                           attention_mask=mt), pt)
        upd, st = txt.update(g, st, pt)
        pt = transform.apply_updates(pt, upd)
        losses["torch"].append(float(loss))
    _close(losses["torch"], losses["jax"], TOL, "step losses")
    for k in ("word_embeddings", "pooler_w", "classifier_w"):
        err = np.abs(pt[k].numpy() - np.array(pj[k])).max()
        assert err <= STEP_TOL * STEPS * LR, (k, err)
    for k, v in pt["layers"].items():
        err = np.abs(v.numpy() - np.array(pj["layers"][k])).max()
        assert err <= STEP_TOL * STEPS * LR, (k, err)
        assert np.abs(np.array(pj["layers"][k]) - tree["layers"][k]).max() \
            > 0.5 * LR or k.endswith("_b")


def test_ernie_specs_wait_for_the_multi_gpu_slice():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ternie.param_specs(ternie.ErnieConfig.tiny())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ternie.batch_spec()
