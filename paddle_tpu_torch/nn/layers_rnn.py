"""Recurrent layers — port of paddle_tpu/nn/layers_rnn.py (:21-299).

Each cell computes the formula the JAX package's `raw` does, in torch
ops: one product per weight (x @ W_ih^T + b_ih + h @ W_hh^T + b_hh), the
LSTM gates split i, f, g, o (:74-80) and the GRU's r, z, n with r applied
to the hidden term (:97-104). The layers step through time in a Python
loop, where the JAX package compiles one `lax.scan`; there is no cuDNN
RNN call, whose packed weight layout would need its own parity proof.
Weights carry the JAX package's names (`weight_ih_{layer}[_reverse]`
and the like), so a JAX `state_dict()` loads as numpy.
`sequence_length` is accepted and, as in the JAX package, not used: every
sequence runs to the full length (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import math

import torch

from .layer import Layer
from . import initializer as I
from ..ops._registry import eager


def _simple(x, h, wi, wh, bi, bh, activation):
    z = x @ wi.T + bi + h @ wh.T + bh
    return torch.tanh(z) if activation == "tanh" else torch.relu(z)


def _lstm(x, h, c, wi, wh, bi, bh):
    gates = x @ wi.T + bi + h @ wh.T + bh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def _gru(x, h, wi, wh, bi, bh):
    xr, xz, xn = torch.chunk(x @ wi.T + bi, 3, dim=-1)
    hr, hz, hn = torch.chunk(h @ wh.T + bh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


class _RNNCellBase(Layer):
    def __init__(self, input_size, hidden_size, n_gates, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        g = n_gates
        self.weight_ih = self.create_parameter(
            [g * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=u)
        self.weight_hh = self.create_parameter(
            [g * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=u)
        self.bias_ih = self.create_parameter(
            [g * hidden_size], attr=bias_ih_attr, is_bias=True,
            default_initializer=u)
        self.bias_hh = self.create_parameter(
            [g * hidden_size], attr=bias_hh_attr, is_bias=True,
            default_initializer=u)

    def _zeros(self, inputs):
        from ..ops.creation import zeros
        return zeros([inputs.shape[0], self.hidden_size], dtype=inputs.dtype)

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, 1, **kw)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        out = eager(lambda x, h, *w: _simple(x, h, *w, self.activation),
                    (inputs, states) + self._weights(), {}, name="rnn_cell")
        return out, out


class LSTMCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size, 4, **kw)

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z.detach())
        h, c = states
        h_new, c_new = eager(_lstm, (inputs, h, c) + self._weights(), {},
                             name="lstm_cell")
        return h_new, (h_new, c_new)


class GRUCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size, 3, **kw)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        out = eager(_gru, (inputs, states) + self._weights(), {},
                    name="gru_cell")
        return out, out


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional RNN stepped through time."""

    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirectional else 1
        self.num_directions = num_dir
        n_gates = {"RNN": 1, "LSTM": 4, "GRU": 3}[self.MODE]
        self.activation = activation
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        for layer in range(num_layers):
            for d in range(num_dir):
                in_size = input_size if layer == 0 else hidden_size * num_dir
                sfx = f"_{layer}" + ("_reverse" if d else "")
                self.add_parameter("weight_ih" + sfx, self.create_parameter(
                    [n_gates * hidden_size, in_size], default_initializer=u))
                self.add_parameter("weight_hh" + sfx, self.create_parameter(
                    [n_gates * hidden_size, hidden_size],
                    default_initializer=u))
                self.add_parameter("bias_ih" + sfx, self.create_parameter(
                    [n_gates * hidden_size], is_bias=True,
                    default_initializer=u))
                self.add_parameter("bias_hh" + sfx, self.create_parameter(
                    [n_gates * hidden_size], is_bias=True,
                    default_initializer=u))

    def _cell(self, x, h, c, wi, wh, bi, bh):
        if self.MODE == "LSTM":
            return _lstm(x, h, c, wi, wh, bi, bh)
        if self.MODE == "GRU":
            return _gru(x, h, wi, wh, bi, bh), c
        return _simple(x, h, wi, wh, bi, bh, self.activation), c

    def _run(self, x, params, h0, c0):
        """x [B, T, F] (or [T, B, F] time-major), params flat per (layer,
        direction) → (outputs, final h, final c or None)."""
        is_lstm = self.MODE == "LSTM"
        num_dir, hs = self.num_directions, self.hidden_size
        if not self.time_major:
            x = x.transpose(0, 1)                       # [T, B, F]
        b = x.shape[1]
        n = self.num_layers * num_dir
        if h0 is None:
            h0 = x.new_zeros((n, b, hs))
            c0 = x.new_zeros((n, b, hs)) if is_lstm else None
        hs_out, cs_out = [], []
        out = x
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(num_dir):
                idx = layer * num_dir + d
                wi, wh, bi, bh = params[4 * idx:4 * idx + 4]
                h = h0[idx]
                c = c0[idx] if is_lstm else torch.zeros_like(h)
                steps = range(out.shape[0] - 1, -1, -1) if d else \
                    range(out.shape[0])
                ys = [None] * out.shape[0]
                for t in steps:
                    h, c = self._cell(out[t], h, c, wi, wh, bi, bh)
                    ys[t] = h
                dir_outs.append(torch.stack(ys, dim=0))
                hs_out.append(h)
                if is_lstm:
                    cs_out.append(c)
            out = torch.cat(dir_outs, dim=-1) if num_dir == 2 else \
                dir_outs[0]
        outputs = out if self.time_major else out.transpose(0, 1)
        final_h = torch.stack(hs_out, dim=0)
        if is_lstm:
            return outputs, final_h, torch.stack(cs_out, dim=0)
        return outputs, final_h

    def forward(self, inputs, initial_states=None, sequence_length=None):
        is_lstm = self.MODE == "LSTM"
        params = []
        for layer in range(self.num_layers):
            for d in range(self.num_directions):
                sfx = f"_{layer}" + ("_reverse" if d else "")
                params += [getattr(self, "weight_ih" + sfx),
                           getattr(self, "weight_hh" + sfx),
                           getattr(self, "bias_ih" + sfx),
                           getattr(self, "bias_hh" + sfx)]
        extra = []
        if initial_states is not None:
            extra = list(initial_states) if is_lstm else [initial_states]
        n_p = len(params)

        def raw(x, *arrs):
            ps, rest = arrs[:n_p], arrs[n_p:]
            h0 = rest[0] if rest else None
            c0 = rest[1] if rest and is_lstm else None
            return self._run(x, ps, h0, c0)

        res = eager(raw, tuple([inputs] + params + extra), {},
                    name=self.MODE.lower())
        if is_lstm:
            outputs, h, c = res
            return outputs, (h, c)
        return res


class SimpleRNN(_RNNBase):
    MODE = "RNN"


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class RNN(Layer):
    """Runs any cell over time (paddle.nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops.manipulation import stack
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outs = []
        states = initial_states
        for t in order:
            xt = inputs[:, t] if axis == 1 else inputs[t]
            out, states = self.cell(xt, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return stack(outs, axis=axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.fw = RNN(cell_fw, False, time_major)
        self.bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops.manipulation import concat
        sf = sb = None
        if initial_states is not None:
            sf, sb = initial_states
        of, stf = self.fw(inputs, sf)
        ob, stb = self.bw(inputs, sb)
        return concat([of, ob], axis=-1), (stf, stb)


RNNCellBase = _RNNCellBase  # public name (paddle.nn.RNNCellBase)
