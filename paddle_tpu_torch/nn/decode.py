"""Seq2seq decoding — port of paddle_tpu/nn/decode.py (:27-170):
BeamSearchDecoder and dynamic_decode.

As in the JAX package, the Decoder protocol (initialize / step /
finalize) is driven by a host loop and the beam bookkeeping (the top-k
over beam x vocab, the parent gather, the backtrack) runs in numpy over
batch-major [B, beam] state; the cell and the projections run as eager
ops on the current place. A beam's length counts the step that emits its
end token (:151-154). For the compiled KV-cache path of the LLMs, see
nlp/generation.py.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..core.tensor import Tensor, to_tensor


def _np(x):
    return x.numpy() if isinstance(x, Tensor) else np.asarray(x)


class BeamSearchDecoder:
    """Beam search over an RNN cell (nn.BeamSearchDecoder parity).

    cell: an RNNCell-like layer — cell(inputs [N, ...], states) ->
    (outputs [N, H], new_states). embedding_fn maps token ids -> inputs;
    output_fn maps cell outputs -> vocab logits.
    """

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    # -- Decoder protocol ---------------------------------------------------
    def initialize(self, initial_cell_states):
        """states: pytree of [B, ...] tensors → tiled to [B*beam, ...]."""
        def tile(s):
            a = _np(s)
            return to_tensor(np.repeat(a, self.beam_size, axis=0))

        states = self._map(initial_cell_states, tile)
        b = _np(self._first(initial_cell_states)).shape[0]
        self._batch = b
        tokens = np.full((b * self.beam_size,), self.start_token, np.int64)
        # beam 0 live, others -inf so step 1 expands only beam 0
        log_probs = np.full((b, self.beam_size), -1e9, np.float32)
        log_probs[:, 0] = 0.0
        finished = np.zeros((b, self.beam_size), bool)
        inputs = self._embed(tokens)
        return inputs, (states, to_tensor(log_probs), finished), \
            to_tensor(finished)

    def step(self, time, inputs, states, **kwargs):
        cell_states, log_probs, finished = states
        out, new_states = self.cell(inputs, cell_states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        from . import functional as F
        logp = _np(F.log_softmax(logits, axis=-1))             # [B*k, V]
        B, k = self._batch, self.beam_size
        V = logp.shape[-1]
        logp = logp.reshape(B, k, V)
        # finished beams only extend with end_token at no cost
        fin = finished.reshape(B, k)
        mask = np.full((B, k, V), -1e9, np.float32)
        mask[:, :, self.end_token] = 0.0
        logp = np.where(fin[:, :, None], mask, logp)
        total = _np(log_probs)[:, :, None] + logp               # [B, k, V]
        flat = total.reshape(B, k * V)
        top_idx = np.argsort(-flat, axis=1)[:, :k]              # [B, k]
        top_score = np.take_along_axis(flat, top_idx, axis=1)
        parent = top_idx // V                                   # [B, k]
        token = top_idx % V                                     # [B, k]
        new_fin = np.take_along_axis(fin, parent, axis=1) | \
            (token == self.end_token)

        def gather(s):
            a = _np(s).reshape((B, k) + _np(s).shape[1:])
            g = np.take_along_axis(
                a, parent.reshape((B, k) + (1,) * (a.ndim - 2)), axis=1)
            return to_tensor(g.reshape((B * k,) + a.shape[2:]))

        gathered = self._map(new_states, gather)
        next_inputs = self._embed(token.reshape(-1).astype(np.int64))
        outputs = {"predicted_ids": to_tensor(token),
                   "parent_ids": to_tensor(parent),
                   "scores": to_tensor(top_score)}
        next_states = (gathered, to_tensor(top_score), new_fin)
        return outputs, next_states, next_inputs, to_tensor(new_fin)

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrack parent pointers → [B, T, beam] token paths."""
        pred = _np(outputs["predicted_ids"])                    # [T, B, k]
        par = _np(outputs["parent_ids"])
        T, B, k = pred.shape
        beams = np.zeros((B, T, k), np.int64)
        idx = np.tile(np.arange(k), (B, 1))                     # [B, k]
        for t in range(T - 1, -1, -1):
            beams[:, t] = np.take_along_axis(pred[t], idx, axis=1)
            idx = np.take_along_axis(par[t], idx, axis=1)
        return to_tensor(beams)

    # -- helpers ------------------------------------------------------------
    def _embed(self, tokens):
        t = to_tensor(np.asarray(tokens, np.int64))
        return self.embedding_fn(t) if self.embedding_fn is not None else t

    @staticmethod
    def _map(tree, fn):
        if isinstance(tree, (list, tuple)):
            return type(tree)(BeamSearchDecoder._map(s, fn) for s in tree)
        if isinstance(tree, dict):
            return {n: BeamSearchDecoder._map(s, fn) for n, s in tree.items()}
        return fn(tree)

    @staticmethod
    def _first(tree):
        if isinstance(tree, (list, tuple)):
            return BeamSearchDecoder._first(tree[0])
        if isinstance(tree, dict):
            return BeamSearchDecoder._first(next(iter(tree.values())))
        return tree


def dynamic_decode(decoder, inits=None, max_step_num: int = 100,
                   output_time_major: bool = False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Drive a Decoder's initialize/step until every sequence finishes or
    max_step_num is hit (nn.dynamic_decode parity). Returns
    (outputs, final_states) with outputs stacked over time (plus lengths
    when return_length)."""
    inputs, states, finished = decoder.initialize(inits)
    collected: dict = {}
    lengths = prev_fin = None
    for t in range(max_step_num):
        outputs, states, inputs, finished = decoder.step(
            t, inputs, states, **kwargs)
        for name, v in outputs.items():
            collected.setdefault(name, []).append(_np(v))
        fin = _np(finished)
        if lengths is None:
            lengths = np.zeros(fin.shape, np.int64)
            prev_fin = np.zeros(fin.shape, bool)
        # the step that EMITS a sequence's eos still counts toward its
        # length: freeze only beams that were already finished before it
        lengths = np.where(prev_fin, lengths, t + 1)
        prev_fin = fin
        if bool(np.all(fin)):
            break
    stacked = {n: np.stack(v, axis=0) for n, v in collected.items()}
    if hasattr(decoder, "finalize"):
        final = decoder.finalize(
            {n: to_tensor(v) for n, v in stacked.items()}, states,
            to_tensor(lengths))
    else:
        axis = 0 if output_time_major else 1
        final = {n: to_tensor(np.moveaxis(v, 0, axis))
                 for n, v in stacked.items()}
    if return_length:
        return final, states, to_tensor(lengths)
    return final, states
