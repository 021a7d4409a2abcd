"""The port's Transformer layers and `tools/eager_transformer.py` against
the JAX package, on the CPU.

A tiny `nn.Transformer` (d_model 32, 4 heads, 2 + 2 layers, ffn 64) is
built in both packages and the JAX model's weights move into the port's
by `set_state_dict`. With the square subsequent mask, in train mode at
dropout 0 and in eval mode: the output and the gradient of sum(out · c)
for every parameter. The JAX side runs as one jitted program
(`paddle_tpu.jit.functional_call` under `jax.value_and_grad`). The same
for the tool's model (tied embedding, sinusoidal positions, the
label-smoothed criterion), MultiHeadAttention's cache, and the routes:
flash for the encoder's self-attention and the cross-attention, the
exact path for the decoder's masked self-attention.

Tolerances (f32): 1e-5 of the largest element for outputs and losses,
1e-4 for gradients (they pass 2-4 LayerNorm backwards, whose 1/std
multiplies the f32 rounding of a difference of nearly equal terms).

The recorded divergence pinned here: a stacked layer is built fresh by
its constructor (LayerNorm ones and zeros, Linear biases zero, weights
not tied); the JAX package's `_clone_layer` redraws every parameter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jp  # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor  # noqa: E402
from paddle_tpu.jit import functional_call, state_of  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.tools import eager_transformer as et  # noqa: E402

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
D, H, L, FF = 32, 4, 2, 64
B, SS, ST = 2, 7, 5


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _close(t, j, tol, what=""):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    scale = max(np.abs(j).max(), 1e-30)
    err = np.abs(t - j).max() / scale
    assert err <= tol, f"{what}: {err} > {tol}"


def _close_grads(tg, jg):
    """Every gradient within GRAD_TOL of its largest element (or of a
    thousandth of the model's largest gradient, if smaller). The key
    biases' gradients are exactly 0 under the shift-invariant softmax:
    both sides' rounding noise there is below 1e-5 of the largest."""
    top = max(np.abs(g).max() for g in jg.values())
    assert sorted(tg) == sorted(jg)
    for n in jg:
        t, j = np.asarray(tg[n], np.float64), np.asarray(jg[n], np.float64)
        if n.endswith("k_proj.bias"):
            assert max(np.abs(t).max(), np.abs(j).max()) <= 1e-5 * top, n
            continue
        scale = max(np.abs(j).max(), 1e-3 * top)
        err = np.abs(t - j).max() / scale
        assert err <= GRAD_TOL, f"{n}: {err} > {GRAD_TOL}"


def _move(jm, tm):
    jsd = jm.state_dict()
    assert sorted(jsd) == sorted(tm.state_dict())
    tm.set_state_dict({k: np.asarray(v.numpy()) for k, v in jsd.items()})


def _jax_value_and_grads(model, fn, *args):
    """fn(model's output...) and its gradient for every parameter, the
    model run as a pure function of its state under one jax.jit."""
    state = state_of(model)
    names = sorted(n for n, p in model.named_parameters())

    def loss(params, rest):
        full = dict(rest, **params)
        out, _ = functional_call(model, full, *[JTensor(a) for a in args])
        return fn(out._data), out._data

    params = {n: state[n] for n in names}
    rest = {n: v for n, v in state.items() if n not in params}
    (val, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, rest)
    return float(val), np.asarray(out), {n: np.asarray(g[n]) for n in names}


def _torch_value_and_grads(model, fn, *args):
    model.clear_gradients()
    out = model(*[tp.to_tensor(a) for a in args])
    val = fn(out)
    val.backward()
    return float(val), out.numpy(), {n: p.grad.numpy()
                                     for n, p in model.named_parameters()}


def _pair():
    """The tiny Transformer in both packages, the JAX one's vectors
    (LayerNorm's and the biases) moved off their ones and zeros, then
    every parameter moved across."""
    jm, tm = (P.nn.Transformer(D, H, L, L, FF, dropout=0.0)
              for P in (jp, tp))
    rng = np.random.default_rng(0)
    for n, p in jm.named_parameters():
        if len(p.shape) == 1:
            p.set_value((0.1 * rng.standard_normal(p.shape) + (
                1.0 if "norm" in n and n.endswith("weight") else 0.0))
                .astype(np.float32))
    _move(jm, tm)
    return jm, tm


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_tiny_transformer_outputs_and_every_gradient(mode):
    jm, tm = _pair()
    rng = np.random.default_rng(1)
    src = rng.standard_normal((B, SS, D)).astype(np.float32)
    tgt = rng.standard_normal((B, ST, D)).astype(np.float32)
    c = rng.standard_normal((B, ST, D)).astype(np.float32)
    mask = np.triu(np.full((ST, ST), -np.inf, np.float32), 1)
    for m in (jm, tm):
        getattr(m, mode)()
    jv, jo, jg = _jax_value_and_grads(
        _MaskedCall(jm), lambda o: jnp.sum(o * c), src, tgt, mask)
    tv, to, tg = _torch_value_and_grads(
        _MaskedCall(tm), lambda o: (o * tp.to_tensor(c)).sum(),
        src, tgt, mask)
    _close(to, jo, OUT_TOL, "out")
    _close(tv, jv, OUT_TOL, "value")
    _close_grads(tg, jg)


class _MaskedCall:
    """A Transformer called as (src, tgt, mask) → out, with the layer's
    state and parameter API, so both helpers can drive it."""

    def __init__(self, model):
        self.m = model

    def __call__(self, src, tgt, mask):
        return self.m(src, tgt, tgt_mask=mask)

    def __getattr__(self, name):
        return getattr(self.m, name)


def test_routes_flash_for_unmasked_exact_for_masked(monkeypatch):
    """The encoder's self-attention and the cross-attention go to the
    flash entry (no mask, dropout 0); the decoder's self-attention, whose
    tgt_mask is a tensor, to mha_ref, as in the JAX package."""
    from paddle_tpu_torch.nn.functional import attention as A
    calls = {"flash": 0, "exact": 0}
    flash, ref = A._flash, A.mha_ref

    def count_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    def count_ref(*a, **k):
        calls["exact"] += 1
        return ref(*a, **k)

    monkeypatch.setattr(A, "_flash", count_flash)
    monkeypatch.setattr(A, "mha_ref", count_ref)
    _, tm = _pair()
    rng = np.random.default_rng(2)
    tm(tp.to_tensor(rng.standard_normal((B, SS, D)).astype(np.float32)),
       tp.to_tensor(rng.standard_normal((B, ST, D)).astype(np.float32)),
       tgt_mask=tp.nn.Transformer.generate_square_subsequent_mask(ST))
    assert calls == {"flash": 2 * L, "exact": L}


def test_multi_head_attention_cache():
    """Incremental decoding through `gen_cache` and `cache` equals the
    JAX package's, step by step, and returns the grown cache."""
    rng = np.random.default_rng(3)
    mhas = [Pk.nn.MultiHeadAttention(D, H) for Pk in (jp, tp)]
    for p in mhas[0].parameters():
        p.set_value(rng.standard_normal(p.shape).astype(np.float32) * 0.3)
    _move(*mhas)
    x = rng.standard_normal((B, 3, D)).astype(np.float32)
    res = []
    for Pk, m in zip((jp, tp), mhas):
        m.eval()
        cache = m.gen_cache(Pk.to_tensor(x))
        outs = []
        for t in range(3):
            q = Pk.to_tensor(x[:, t:t + 1])
            o, cache = m(q, q, q, cache=cache)
            outs.append(np.asarray(o.numpy()))
        res.append((outs, [list(c.shape) for c in cache]))
    for a, b in zip(res[0][0], res[1][0]):
        _close(b, a, OUT_TOL, "step")
    assert res[0][1] == res[1][1] == [[B, 3, H, D // H]] * 2


def test_pin_stacked_layers_are_built_fresh():
    """Recorded divergence: the stack's later layers are built by their
    own constructor (Paddle's stacking): LayerNorm weights 1 and biases
    0, Linear biases 0, Linear weights drawn anew (not tied to the first
    layer's). The JAX package's `_clone_layer` redraws the norms too."""
    tp.seed(0)
    enc = tp.nn.TransformerEncoder(tp.nn.TransformerEncoderLayer(
        D, H, FF), 3)
    dec = tp.nn.TransformerDecoder(tp.nn.TransformerDecoderLayer(
        D, H, FF), 2)
    for stack, n in ((enc, 3), (dec, 2)):
        assert len(stack.layers) == n
        first = dict(stack.layers[0].named_parameters())
        for layer in list(stack.layers)[1:]:
            assert layer is not stack.layers[0]
            for name, p in layer.named_parameters():
                v = p.numpy()
                if ".norm" in "." + name or name.startswith("norm"):
                    want = 1.0 if name.endswith("weight") else 0.0
                    assert np.all(v == want), name
                elif name.endswith("bias"):
                    assert np.all(v == 0.0), name
                else:
                    assert not np.array_equal(v, first[name].numpy()), name
    jenc = jp.nn.TransformerEncoder(jp.nn.TransformerEncoderLayer(
        D, H, FF), 2)
    assert not np.all(np.asarray(jenc.layers[1].norm1.weight.numpy()) == 1.0)


def _tool_pair():
    cfg = et.TransformerConfig.tiny(dropout=0.0)
    jm, tm = et.build_model(jp, cfg), et.build_model(tp, cfg)
    _move(jm, tm)
    return cfg, jm, tm


def test_eager_transformer_tool_loss_and_every_gradient():
    """The tool's model from both packages (tied embedding, positions,
    the label-smoothed criterion) in f32: loss and every gradient."""
    cfg, jm, tm = _tool_pair()
    rng = np.random.default_rng(4)
    src = rng.integers(0, cfg.vocab_size, (B, SS))
    tgt = rng.integers(0, cfg.vocab_size, (B, ST + 1))
    tin, tout = tgt[:, :-1], tgt[:, 1:]
    labels = jnp.asarray(tout)

    def jfn(logits):
        return et.criterion(jp, JTensor(logits), JTensor(labels),
                            cfg.label_smoothing)._data
    jv, jo, jg = _jax_value_and_grads(jm, jfn, src, tin)
    tv, to, tg = _torch_value_and_grads(
        tm, lambda lg: et.criterion(tp, lg, tp.to_tensor(tout),
                                    cfg.label_smoothing), src, tin)
    assert to.shape == (B, ST, cfg.vocab_size)
    _close(to, jo, OUT_TOL, "logits")
    _close(tv, jv, OUT_TOL, "loss")
    _close_grads(tg, jg)
    # the criterion is CrossEntropyLoss(label_smoothing) on hard labels
    lg = tp.to_tensor(to)
    ce = tp.nn.CrossEntropyLoss(label_smoothing=0.1)(
        lg.reshape([-1, cfg.vocab_size]), tp.to_tensor(tout.reshape(-1)))
    crit = et.criterion(tp, lg, tp.to_tensor(tout), 0.1)
    assert abs(float(ce) - float(crit)) <= 1e-5 * abs(float(crit))


def test_eager_transformer_train_steps():
    """Four steps of the tool's recipe on the port (Adam β 0.9/0.98 under
    NoamDecay(d_model, 4000), f32 on the CPU) on one batch: the
    scheduler advances a step at a time and the loss falls."""
    cfg = et.TransformerConfig.tiny()
    tp.seed(0)
    m = et.build_model(tp, cfg)
    opt = et.make_optimizer(tp, m, cfg)
    rng = np.random.default_rng(6)
    src = tp.to_tensor(rng.integers(0, cfg.vocab_size, (B, SS)))
    tgt = rng.integers(0, cfg.vocab_size, (B, ST + 1))
    tin, tout = tp.to_tensor(tgt[:, :-1]), tp.to_tensor(tgt[:, 1:])
    m.eval()       # no dropout: the fall is the updates' alone
    before = float(et.loss_fn(tp, m, cfg, src, tin, tout, None))
    losses = [float(et.train_step(tp, m, cfg, opt, src, tin, tout,
                                  amp_dtype=None)) for _ in range(4)]
    assert np.isfinite(losses).all()
    assert opt._learning_rate.last_epoch == 4
    assert losses[-1] < losses[0] and losses[0] == pytest.approx(before)
