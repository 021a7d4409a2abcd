"""The port's recurrent layers and beam search against the JAX package,
on the CPU.

Each layer is built in both packages and the JAX layer's `state_dict()`
is carried across as numpy. Cells (SimpleRNN tanh and relu, LSTM, GRU)
and layers (2 layers, forward and bidirectional, batch- and time-major,
with and without initial states, with `sequence_length`, which both
packages accept and do not use) must agree to 1e-5 (absolute and
relative, f32: the same expressions in another summation order), the
outputs, the final states and, for the LSTM, the gradients of the
inputs and weights. The beam search is the twin of
tests/test_nn_zoo_ext.py::TestBeamSearchDecode: the decoded ids must be
equal, the final beam scores within 1e-5, the lengths equal; and beam
size 1 must equal the greedy rollout of the same cell.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

TOL = 1e-5
PKGS = (jp, tp)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _twin(build):
    """The JAX layer and the port's, with the JAX weights carried over."""
    jp.seed(0)
    j = build(jp)
    t = build(tp)
    missing, unexpected = t.set_state_dict(
        {k: v.numpy() for k, v in j.state_dict().items()})
    assert not missing and not unexpected
    return j, t


def _np(x):
    return x.numpy()


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=TOL)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru"])
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_matches_jax(kind, with_state):
    def build(p):
        if kind.startswith("rnn"):
            return p.nn.SimpleRNNCell(6, 5, activation=kind[4:])
        return {"lstm": p.nn.LSTMCell, "gru": p.nn.GRUCell}[kind](6, 5)

    j, t = _twin(build)
    x = _x((3, 6))
    h = _x((3, 5), 1)
    states = None
    if with_state:
        states = (h, _x((3, 5), 2)) if kind == "lstm" else h
    outs = []
    for p, layer in ((jp, j), (tp, t)):
        st = None
        if states is not None:
            st = tuple(p.to_tensor(s) for s in states) if kind == "lstm" \
                else p.to_tensor(states)
        outs.append(layer(p.to_tensor(x), st))
    (jo, js), (to, ts) = outs
    _close(to, jo)
    if kind == "lstm":
        _close(ts[1], js[1])


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_layer_matches_jax(mode, direction, time_major, init):
    def build(p):
        return getattr(p.nn, mode)(4, 6, num_layers=2, direction=direction,
                                   time_major=time_major)

    j, t = _twin(build)
    B, T = 3, 5
    x = _x((T, B, 4) if time_major else (B, T, 4))
    n = 2 * (2 if direction == "bidirect" else 1)
    h0, c0 = _x((n, B, 6), 1), _x((n, B, 6), 2)
    lengths = np.array([5, 3, 4], np.int64)
    res = []
    for p, layer in ((jp, j), (tp, t)):
        st = None
        if init:
            st = (p.to_tensor(h0), p.to_tensor(c0)) if mode == "LSTM" \
                else p.to_tensor(h0)
        res.append(layer(p.to_tensor(x), st,
                         sequence_length=p.to_tensor(lengths)))
    (jo, js), (to, ts) = res
    assert to.shape == jo.shape
    _close(to, jo)
    if mode == "LSTM":
        _close(ts[0], js[0])
        _close(ts[1], js[1])
    else:
        _close(ts, js)


def test_lstm_gradients_match_jax():
    def build(p):
        return p.nn.LSTM(4, 6, num_layers=2, direction="bidirect")

    j, t = _twin(build)
    x = _x((3, 5, 4))
    grads = []
    for p, layer in ((jp, j), (tp, t)):
        xt = p.to_tensor(x, stop_gradient=False)
        out, (h, c) = layer(xt)
        ((out * out).sum() + h.sum() + c.sum()).backward()
        grads.append((xt.grad, {k: v.grad for k, v in
                                layer.named_parameters()}))
    (jx, jw), (tx, tw) = grads
    _close(tx, jx)
    assert set(tw) == set(jw)
    for k in jw:
        _close(tw[k], jw[k])


def test_rnn_and_birnn_wrappers_match_jax():
    def build(p):
        return p.nn.BiRNN(p.nn.GRUCell(4, 5), p.nn.GRUCell(4, 5))

    j, t = _twin(build)
    x = _x((2, 6, 4))
    (jo, (jf, jb)) = j(jp.to_tensor(x))
    (to, (tf, tb)) = t(tp.to_tensor(x))
    _close(to, jo)
    _close(tf, jf)
    _close(tb, jb)


def _beam_parts(p):
    class Cell(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = p.nn.Linear(4, 4)

        def forward(self, x, states):
            h = p.tanh(self.fc(x) + states)
            return h, h

    class Parts(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.cell = Cell()
            self.emb = p.nn.Embedding(10, 4)
            self.proj = p.nn.Linear(4, 10)

    return Parts()


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_matches_jax(beam):
    j, t = _twin(_beam_parts)
    init = np.zeros((2, 4), np.float32)
    res = []
    for p, m in ((jp, j), (tp, t)):
        dec = p.nn.BeamSearchDecoder(m.cell, start_token=0, end_token=9,
                                     beam_size=beam, embedding_fn=m.emb,
                                     output_fn=m.proj)
        out, states, lengths = p.nn.dynamic_decode(
            dec, inits=p.to_tensor(init), max_step_num=5,
            return_length=True)
        res.append((out.numpy(), states[1].numpy(), lengths.numpy()))
    (jo, js, jl), (to, ts, tl) = res
    assert to.shape == (2, 5, beam)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(ts, js, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tl, jl)


def test_beam_of_one_is_greedy():
    """tests/test_nn_zoo_ext.py:364's greedy consistency, on the port."""
    tp.seed(7)
    m = _beam_parts(tp)
    init = tp.zeros([2, 4])
    dec = tp.nn.BeamSearchDecoder(m.cell, 0, 9, 1, embedding_fn=m.emb,
                                  output_fn=m.proj)
    out, _ = tp.nn.dynamic_decode(dec, inits=init, max_step_num=4)
    state = init
    tok = tp.to_tensor(np.zeros(2, np.int64))
    want = []
    for _ in range(4):
        h, state = m.cell(m.emb(tok), state)
        tok = tp.to_tensor(np.argmax(m.proj(h).numpy(), axis=-1))
        want.append(tok.numpy())
    np.testing.assert_array_equal(out.numpy()[:, :, 0],
                                  np.stack(want, axis=1))
