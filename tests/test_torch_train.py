"""The port's training path against the JAX package, on the CPU.

A tiny f32 Llama (`LlamaConfig.tiny`, 2 layers, GQA 4/2) made by the JAX
`init_params` and carried across with `params_from_numpy(training=True)`;
tokens from a seeded numpy generator. On the CPU the port's kernels run
their plain versions, the JAX package its jnp/XLA paths (and, for the
8-bit optimizer, its Pallas kernel in interpret mode).

Tolerances: f32 on both sides; they differ in summation order (JAX's
scan and fused reductions, torch's eager ops), so the loss agrees to
1e-5 relative and gradient leaves to 1e-4 relative to each leaf's
largest element. After 3 optimizer steps params agree to 1e-5 with f32
moments. With 8-bit moments a code that lies within an ulp of a float8
rounding boundary can round either way (the global norm and bias
corrections differ in their last bit between the two frameworks), and a
flipped code moves that element's update by up to one float8 step (~6 %
of lr = 1e-3), so params are held to 1e-4 absolute and losses to 1e-5.
In both, Adam's direction m/sqrt(v) of an element whose gradient lies
within rounding noise of zero is decided by that noise, so such an
element may move by up to a whole step differently: at most 0.1 % of a
leaf's elements may exceed the tolerance, and none by more than twice
the sum of the learning rates of the steps taken.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags  # noqa: E402
from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import train as jtrain  # noqa: E402

from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import train as ttrain  # noqa: E402
from paddle_tpu_torch.optimizer import transform  # noqa: E402

B, S = 2, 16
LR = 1e-3
# warm-up over 2 steps from 0, then cosine over 10: lr 0, 5e-4, ~1e-3
LR_SUM_3 = 1.5e-3


def _cfgs(**over):
    j = jllama.LlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                **over)
    t = tllama.LlamaConfig.tiny(dtype=torch.float32,
                                param_dtype=torch.float32, **over)
    return j, t


def _tree(seed=0):
    jcfg, tcfg = _cfgs()
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def _tokens(seed=0, b=B):
    return np.random.default_rng(seed).integers(0, 256, (b, S)).astype(
        np.int32)


def _leaf_close(a, b, rtol, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(np.abs(b).max(), 1e-12)
    assert np.abs(a - b).max() <= rtol * scale, (what, np.abs(a - b).max(),
                                                 scale)


def _params_close(t, j, atol, path):
    """Params within `atol`, save the Adam-ill-conditioned elements
    (module docstring): <= 0.1 % of them, each within 2 * LR_SUM_3."""
    d = np.abs(np.asarray(t, np.float32) - np.asarray(j, np.float32))
    assert np.mean(d > atol) <= 1e-3, (path, np.mean(d > atol))
    assert d.max() <= 2 * LR_SUM_3, (path, d.max())


def _flat(tree):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    return [("", tree)]


@pytest.mark.parametrize("fused_ce,remat", [(False, True), (False, False),
                                            (True, True), (True, False)])
def test_loss_and_grads_match_jax(fused_ce, remat):
    """loss_fn and every gradient leaf == jax.value_and_grad(loss_fn)."""
    jcfg, tcfg = _cfgs(fused_ce=fused_ce, remat=remat)
    jp, tree = _tree()
    tok = _tokens()
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: jllama.loss_fn(p, t, jcfg)))(jp, jnp.asarray(tok))
    tp = tllama.params_from_numpy(tree, tcfg, device="cpu", training=True)
    leaves = [x.requires_grad_(True) for _, x in _flat(tp)]
    tl = tllama.loss_fn(tp, torch.from_numpy(tok), tcfg)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for (path, _), g, (_, j) in zip(_flat(tp), tg, _flat(jg)):
        _leaf_close(g.numpy(), j, 1e-4, path)


def _run_steps(state_quant, n_steps=3, grad_accum=1, b=B):
    jcfg, tcfg = _cfgs()
    jp, tree = _tree()
    tok = _tokens(1, b)
    kw = dict(learning_rate=LR, state_quant=state_quant, warmup_steps=2,
              total_steps=10)
    jtx = jtrain.make_optimizer(**kw)
    ttx = ttrain.make_optimizer(**kw)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    jstep = jtrain.make_train_step(jcfg, jtx, donate=False,
                                   grad_accum_steps=grad_accum)
    tp = tllama.params_from_numpy(tree, tcfg, device="cpu", training=True)
    tstate = ttrain.TrainState(torch.zeros((), dtype=torch.int32), tp,
                               ttx.init(tp))
    tstep = ttrain.make_train_step(tcfg, ttx, grad_accum_steps=grad_accum,
                                   device="cpu")
    jm, tm = [], []
    # the 8-bit JAX optimizer takes its fused Pallas apply only when
    # Pallas runs (interpret mode here); the flag is read at trace time
    flags.set_flags({"FLAGS_pallas_interpret": state_quant is not None})
    try:
        for _ in range(n_steps):
            jstate, m = jstep(jstate, jnp.asarray(tok))
            jm.append({k: float(v) for k, v in m.items()})
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})
    for _ in range(n_steps):
        tstate, m = tstep(tstate, torch.from_numpy(tok))
        tm.append({k: float(v) for k, v in m.items()})
    return jstate, tstate, jm, tm


def test_train_steps_match_jax_f32_moments():
    """3 steps with AdamW (f32 moments, clip 1.0, warm-up + cosine):
    losses, grad norms and params == the JAX train step's."""
    jstate, tstate, jm, tm = _run_steps(None)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
        assert a["step"] == b["step"]
    assert int(tstate.step) == int(jstate.step) == 3
    for (path, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
        _params_close(t.numpy(), j, 1e-5, path)
    # the moments line up leaf for leaf with optax's
    tadam, jadam = tstate.opt_state[1][0], jstate.opt_state[1][0]
    for (path, t), (_, j) in zip(_flat(tadam.mu), _flat(jadam.mu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                   err_msg=path)


def test_train_steps_match_jax_8bit_fused():
    """3 steps with the fused 8-bit AdamW (JAX: the Pallas kernel in
    interpret mode; the port: its plain version): losses and params
    agree within the float8-flip tolerance."""
    jstate, tstate, jm, tm = _run_steps("8bit")
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    assert int(tstate.opt_state.count) == int(jstate.opt_state.count) == 3
    for (path, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
        _params_close(t.numpy(), j, 1e-4, path)
    assert tm[-1]["loss"] < tm[0]["loss"]


def test_grad_accum_matches_jax_strided_split():
    """grad_accum_steps=2 over a batch of 4: the JAX step's strided
    chunks (rows 0, 2 and 1, 3), loss and grads averaged."""
    jstate, tstate, jm, tm = _run_steps(None, n_steps=1, grad_accum=2, b=4)
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-5)
    for (path, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
        _params_close(t.numpy(), j, 1e-5, path)


def test_grad_accum_chunks_are_strided():
    """The accumulated step equals the mean of explicit strided-chunk
    gradients, not of contiguous halves."""
    _, tcfg = _cfgs()
    _, tree = _tree()
    tok = torch.from_numpy(_tokens(2, 4))
    tp = tllama.params_from_numpy(tree, tcfg, device="cpu", training=True)
    grads = []
    for rows in ([0, 2], [1, 3]):
        leaves = [x.detach().requires_grad_(True) for _, x in _flat(tp)]
        live = {p: x for (p, _), x in zip(_flat(tp), leaves)}
        t2 = transform.tree_map(lambda x: live[_path_of(tp, x)], tp)
        loss = tllama.loss_fn(t2, tok[rows], tcfg)
        grads.append(torch.autograd.grad(loss, leaves))
    want = [(a + b) / 2 for a, b in zip(*grads)]
    sgd = transform.GradientTransformation(
        lambda p: transform.EmptyState(),
        lambda u, s, p=None: (transform.tree_map(lambda g: -g, u), s))
    state = ttrain.TrainState(torch.zeros((), dtype=torch.int32),
                              transform.tree_map(torch.clone, tp),
                              transform.EmptyState())
    step = ttrain.make_train_step(tcfg, sgd, grad_accum_steps=2,
                                  device="cpu")
    state, _ = step(state, tok)
    for (path, p0), (_, p1), g in zip(_flat(tp), _flat(state.params), want):
        np.testing.assert_allclose((p0 - p1).numpy(), g.numpy(), atol=1e-6,
                                   err_msg=path)


def _path_of(tree, leaf):
    for p, x in _flat(tree):
        if x is leaf:
            return p
    raise KeyError


def test_cuda_default_raises_without_cuda():
    """Entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _cfgs()
    tx = ttrain.make_optimizer(1e-3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.make_train_step(tcfg, tx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.init_state(None, tcfg, tx)


def test_unported_options_raise():
    _, tcfg = _cfgs()
    tx = ttrain.make_optimizer(1e-3)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ttrain.make_train_step(tcfg, tx, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ttrain.make_train_step(tcfg, tx, num_microbatches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        dataclasses.replace(tcfg, attn_impl="ring")
    with pytest.raises(ValueError):
        ttrain.make_optimizer(1e-3, state_quant="4bit")


def test_schedule_matches_optax():
    import optax
    j = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 20)
    t = transform.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 20)
    for c in range(0, 25):
        np.testing.assert_allclose(
            float(t(torch.tensor(c, dtype=torch.int32))), float(j(c)),
            rtol=1e-5, atol=1e-12)


def test_flops_and_params_match_jax():
    jcfg = jllama.LlamaConfig(vocab_size=32000, hidden_size=4096,
                              intermediate_size=9472, num_hidden_layers=11,
                              num_attention_heads=32, num_key_value_heads=8)
    tcfg = tllama.LlamaConfig.flagship_2b()
    assert tllama.num_params(tcfg) == jllama.num_params(jcfg)
    assert tllama.flops_per_token(tcfg, 2048) == jllama.flops_per_token(
        jcfg, 2048)
    assert tcfg.param_dtype == torch.bfloat16
