"""The port's DiT (mix/dit.py) and its 8-bit optimizer chain
(optimizer/quant_state.adamw_q) against the JAX package, on the CPU.

A tiny f32 DiT (`DiTConfig.tiny`: 8×8×4 latents, patch 2, D 64, 2 blocks
of 4 heads) whose JAX tree is carried across with `params_from_numpy`.
Every leaf is redrawn N(0, 0.1) from a seeded numpy generator for the
value and gradient checks: at the recipe's init the adaLN-Zero gates are
0 and the attention and MLP branches get exactly zero gradient, which
would hide a fault there. The flash attention runs its plain version on
the CPU in both packages (JAX: the exact reference off-TPU).

Tolerances: f32 on both sides, differing in summation order only: the
forward and the loss to 1e-5 relative, each gradient leaf to 1e-4 of its
largest element. Two `adamw_q` steps from the same gradients: the 8-bit
codes are the same f32 expressions rounded to float8, but a value within
an ulp of a float8 rounding boundary can round either way (XLA fuses the
chain), and a flipped code moves that element's update by up to one
float8 step (~6 % of lr): params are held to 5e-5 absolute, with at most
0.1 % of a leaf's elements beyond it and none beyond twice the two steps'
lr.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from paddle_tpu.mix import dit as jdit  # noqa: E402
from paddle_tpu.optimizer import quant_state as jqs  # noqa: E402

from paddle_tpu_torch.mix import dit as tdit  # noqa: E402
from paddle_tpu_torch.nlp.train import value_and_grad  # noqa: E402
from paddle_tpu_torch.optimizer import quant_state as tqs  # noqa: E402
from paddle_tpu_torch.optimizer import transform  # noqa: E402

F32_TOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3


def _cfgs():
    return (jdit.DiTConfig.tiny(dtype=jnp.float32),
            tdit.DiTConfig.tiny(dtype=torch.float32))


def _flat(tree):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    return [("", tree)]


def _random_tree(seed=0):
    """The JAX init tree's structure with every leaf N(0, 0.1)."""
    jcfg, _ = _cfgs()
    ref = jdit.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                        .astype(np.float32), ref)


def _batch(B=3, seed=1):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, jcfg.in_channels, jcfg.image_size,
                              jcfg.image_size)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, (B,)).astype(np.int32)
    return x0, y


def _close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), 1e-30)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def test_init_tree_matches_jax():
    """init_params: the same keys and shapes, the adaLN-Zero leaves and
    the biases zero, the matrices and embeddings N(0, 0.02); num_params
    and flops_per_image equal to JAX's, DiT-XL/2 included."""
    jcfg, tcfg = _cfgs()
    jp = jdit.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tdit.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    jf, tf = _flat(jp), _flat(tp)
    assert [p for p, _ in jf] == [p for p, _ in tf]
    for (path, j), (_, t) in zip(jf, tf):
        assert tuple(t.shape) == tuple(j.shape), path
        j = np.asarray(j)
        if not j.any():
            assert not t.any(), path
        else:
            assert 0.01 < float(t.std()) < 0.03, path
    for cfg in ("tiny", "dit_xl_2"):
        jc, tc = getattr(jdit.DiTConfig, cfg)(), getattr(tdit.DiTConfig,
                                                         cfg)()
        assert tdit.num_params(tc) == jdit.num_params(jc)
        assert tdit.flops_per_image(tc) == jdit.flops_per_image(jc)
        assert (tc.head_dim, tc.n_patches, tc.out_channels) == \
            (jc.head_dim, jc.n_patches, jc.out_channels)
    assert tdit.num_params(tdit.DiTConfig.dit_xl_2()) == 675_129_632
    with pytest.raises(NotImplementedError):
        tdit.param_specs(tcfg)
    with pytest.raises(NotImplementedError):
        tdit.batch_spec()


def test_embedding_and_patches_match_jax():
    """timestep_embedding within 1e-4: cos/sin of arguments up to 999,
    whose f32 rounding (2^-24 × 999 ≈ 6e-5) differs when the two
    frameworks' exp of the frequencies differ in the last bit; patchify
    and unpatchify exactly."""
    jcfg, tcfg = _cfgs()
    t = np.array([0, 1, 500, 999], np.int32)
    _close(tdit.timestep_embedding(torch.from_numpy(t)).numpy(),
           jdit.timestep_embedding(jnp.asarray(t)), 1e-4, "temb")
    x0, _ = _batch()
    pj = jdit.patchify(jnp.asarray(x0), jcfg)
    pt = tdit.patchify(torch.from_numpy(x0), tcfg)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    wide = np.random.default_rng(2).standard_normal(
        (3, tcfg.n_patches, 4 * tcfg.out_channels)).astype(np.float32)
    np.testing.assert_array_equal(
        tdit.unpatchify(torch.from_numpy(wide), tcfg).numpy(),
        np.asarray(jdit.unpatchify(jnp.asarray(wide), jcfg)))


@pytest.fixture(scope="module")
def pair():
    """(the tree as numpy, x0, y, key 3, and JAX's draws from that key
    (t, eps, drop) with the first label's drop forced on)."""
    jcfg, tcfg = _cfgs()
    tree = _random_tree()
    x0, y = _batch()
    key = jax.random.PRNGKey(3)
    kb, kt, ke = jax.random.split(key, 3)
    B = x0.shape[0]
    t = jax.random.randint(kt, (B,), 0, 1000)
    eps = jax.random.normal(ke, x0.shape, jnp.float32)
    drop = jax.random.bernoulli(kb, jcfg.class_dropout_prob, (B,))
    drop = drop.at[0].set(True)          # one null label at least
    return tree, x0, y, key, (np.array(t), np.array(eps), np.array(drop))


def test_forward_matches_jax(pair):
    jcfg, tcfg = _cfgs()
    tree, x0, y, _, (t, _, _) = pair
    out_j = jax.jit(lambda p, x, t_, y_: jdit.forward(p, x, t_, y_, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x0), jnp.asarray(t),
        jnp.asarray(y))
    tp = tdit.params_from_numpy(tree, tcfg, device="cpu")
    out_t = tdit.forward(tp, torch.from_numpy(x0), torch.from_numpy(t),
                         torch.from_numpy(y), tcfg)
    assert out_t.shape == (3, tcfg.out_channels, 8, 8)
    _close(out_t.detach().numpy(), out_j, F32_TOL, "forward")


def test_loss_and_every_grad_match_jax(pair):
    """diffusion_loss_given with JAX's own draws against
    jax.value_and_grad(diffusion_loss) with that key; both with remat."""
    jcfg, tcfg = _cfgs()
    tree, x0, y, key, (t, eps, drop) = pair
    jp = jax.tree.map(jnp.asarray, tree)

    def jloss(p):
        # JAX's draws, with the first label forced to drop as in `pair`
        return jdit.diffusion_loss(p, key, jnp.asarray(x0),
                                   jnp.where(jnp.arange(3) == 0,
                                             jcfg.num_classes,
                                             jnp.asarray(y)), jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = tdit.params_from_numpy(tree, tcfg, device="cpu")
    leaves = [x.requires_grad_(True) for _, x in _flat(tp)]
    tl = tdit.diffusion_loss_given(
        tp, torch.from_numpy(x0), torch.from_numpy(y), torch.from_numpy(t),
        torch.from_numpy(eps), torch.from_numpy(drop), tcfg)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=F32_TOL)
    for (path, _), g, (_, j) in zip(_flat(tp), tg, _flat(jg)):
        _close(g.numpy(), j, GRAD_TOL, path)


def test_two_adamw_q_steps_match_jax(monkeypatch):
    """adamw_q(lr, weight_decay, clip_norm) from the same gradients, two
    steps, with chunks of 16 blocks so the streamed update runs in
    several chunks on both sides."""
    monkeypatch.setattr(jqs, "CHUNK_BLOCKS", 16)
    monkeypatch.setattr(tqs, "CHUNK_BLOCKS", 16)
    _, tcfg = _cfgs()
    tree = _random_tree(seed=4)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) *
                                     rng.uniform(1e-3, 1.0))
                          .astype(np.float32), tree) for _ in range(2)]
    kw = dict(weight_decay=0.05, clip_norm=1.0)
    jtx = jqs.adamw_q(LR, **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jtx.init(jp)
    ttx = tqs.adamw_q(LR, **kw)
    tp = tdit.params_from_numpy(tree, tcfg, device="cpu")
    ts = ttx.init(tp)
    @jax.jit
    def jstep(g, s, p):
        upd, s = jtx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    for g in grads:
        jp, js = jstep(jax.tree.map(jnp.asarray, g), js, jp)
        tg = tdit.params_from_numpy(g, tcfg, device="cpu")
        tupd, ts = ttx.update(tg, ts, tp)
        tp = transform.apply_updates(tp, tupd)
    assert int(ts[0].count) == int(js[0].count) == 2
    for (path, t), (_, j) in zip(_flat(tp), _flat(jp)):
        d = np.abs(t.numpy() - np.asarray(j))
        assert np.mean(d > 5e-5) <= 1e-3, (path, np.mean(d > 5e-5))
        assert d.max() <= 2 * 2 * LR, (path, d.max())
    # the first moments dequantize to the same values: within 1/64 of the
    # leaf's largest |m| (an e4m3 step at the top of the range is 1/14 of
    # it), save <= 0.1 % of elements whose code flipped
    for (path, q), (_, jq), (_, p) in zip(
            _flat(tqs._map_q(lambda x: x, ts[0].m)), _flat(js[0].m),
            _flat(tp)):
        a = tqs._dequantize(q, tuple(p.shape), False).numpy()
        b = np.asarray(jqs._dequantize(jq, tuple(p.shape), False))
        tol = 1e-6 + np.abs(b).max() / 64
        assert np.mean(np.abs(a - b) > tol) <= 1e-3, path


def test_diffusion_loss_draws_and_trains_on_cpu():
    """diffusion_loss draws its own t, noise and label drop from the
    generator (the same generator state gives the same loss), and a few
    adamw_q steps at the recipe's init lower it."""
    _, tcfg = _cfgs()
    params = tdit.init_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    x0, y = (torch.from_numpy(a) for a in _batch(B=4))
    a = tdit.diffusion_loss(params, torch.Generator().manual_seed(7), x0, y,
                            tcfg)
    b = tdit.diffusion_loss(params, torch.Generator().manual_seed(7), x0, y,
                            tcfg)
    assert torch.equal(a, b)
    tx = tqs.adamw_q(1e-2)
    st = tx.init(params)
    losses = []
    for _ in range(4):
        loss, g = value_and_grad(
            lambda p: tdit.diffusion_loss(
                p, torch.Generator().manual_seed(7), x0, y, tcfg), params)
        upd, st = tx.update(g, st, params)
        params = transform.apply_updates(params, upd)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_run_dit_on_cpu():
    """`tools/dit_train.run_dit` at `DiTConfig.tiny` on the CPU: 2 warm-up
    and 2 timed steps of `build_dit_step`, whose losses it returns equal
    to those of driving the step by hand (the draws are fixed, so the
    same parameters give the same loss), finite, with the tiny config's
    counts."""
    from paddle_tpu_torch.tools import dit_train
    _, tcfg = _cfgs()
    res = dit_train.run_dit(batch=4, timed_steps=2, device="cpu", cfg=tcfg)
    step, state, data, _ = dit_train.build_dit_step(4, device="cpu",
                                                    cfg=tcfg)
    ref = []
    for _ in range(4):
        state, m = step(state, data)
        ref.append(float(m["loss"]))
    assert res["losses"] == ref and np.isfinite(ref).all()
    assert res["params"] == tdit.num_params(tcfg)
    assert res["step_ms"] > 0 and res["img_s"] > 0
    assert res["mfu"] == pytest.approx(
        res["img_s"] * tdit.flops_per_image(tcfg) / 989e12)
