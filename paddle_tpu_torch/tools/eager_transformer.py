"""The Transformer of "Attention Is All You Need" composed from
Paddle-shaped layers.

    cfg = TransformerConfig.base()
    model = build_model(paddle, cfg)
    loss = train_step(paddle, model, opt, src, tgt_in, tgt_out)

A model composed to exercise the eager API, not a package feature: the
base model of Vaswani et al. 2017 (d_model 512, 8 heads, 6 + 6 layers,
feed-forward 2048, relu, post-norm, dropout 0.1) built the way
PaddleNLP builds `TransformerModel(weight_sharing=True)`:

- one `nn.Embedding` shared by the source and the target, its output
  scaled by √d_model, plus sinusoidal positions, then dropout;
- `paddle.nn.Transformer` with `attn_dropout=0.0`, so the encoder's
  self-attention and the cross-attention take the flash kernels and the
  decoder's self-attention, under the square subsequent mask, the exact
  path;
- the pre-softmax projection shares the embedding weight:
  `paddle.matmul(h, emb.weight, transpose_y=True)`;
- PaddleNLP's `CrossEntropyCriterion`: `F.label_smooth(F.one_hot(y, V),
  epsilon)` and `F.cross_entropy(..., soft_label=True)`, the mean over
  the target tokens (no padding here).

The embedding is N(0, d_model^-0.5), as PaddleNLP's WordEmbedding draws
it; every other parameter is drawn by its layer's own initializer.
`paddle` is the package module: `paddle_tpu_torch` on the card
(chip_smoke.py's transformer phases), and either package in the parity
tests, which build the same model from both and move the weights across
with `set_state_dict`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 37000
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    attn_dropout: float = 0.0
    max_length: int = 256
    label_smoothing: float = 0.1

    @classmethod
    def base(cls, **kw):
        """The paper's base model with the shared 37,000-token vocabulary
        of its WMT14 en-de setup."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """A CPU-test size: d_model 32, 4 heads, 2 + 2 layers, ffn 64."""
        base = dict(vocab_size=64, d_model=32, nhead=4, num_encoder_layers=2,
                    num_decoder_layers=2, dim_feedforward=64, max_length=16)
        base.update(kw)
        return cls(**base)

    def matmul_macs_per_token(self, seq: int) -> float:
        """Multiply-accumulates a target token (with its source token)
        costs in the forward: the encoder's and decoder's projections and
        feed-forwards, the output projection, and the attention's two
        products (every query against all `seq` keys, the decoder's
        masked scores included, as the exact path computes them)."""
        D, Fd, V = self.d_model, self.dim_feedforward, self.vocab_size
        enc = self.num_encoder_layers * (4 * D * D + 2 * D * Fd)
        dec = self.num_decoder_layers * (8 * D * D + 2 * D * Fd)
        attn = (self.num_encoder_layers + 2 * self.num_decoder_layers) * \
            2 * seq * D
        return float(enc + dec + D * V + attn)


def sinusoid_table(length: int, d_model: int) -> np.ndarray:
    """[length, d_model] f32: sin on the even channels, cos on the odd,
    as in the paper."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    i = np.arange(d_model // 2, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d_model)
    table = np.zeros((length, d_model))
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table.astype(np.float32)


def build_model(paddle, cfg: TransformerConfig):
    """The encoder-decoder with its tied embedding and output projection,
    from `paddle`'s layers; its parameters are f32."""
    nn = paddle.nn
    F = nn.functional
    D = cfg.d_model

    class TransformerModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(
                cfg.vocab_size, D, weight_attr=nn.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, D ** -0.5)))
            self.transformer = nn.Transformer(
                D, cfg.nhead, cfg.num_encoder_layers,
                cfg.num_decoder_layers, cfg.dim_feedforward,
                dropout=cfg.dropout, activation="relu",
                attn_dropout=cfg.attn_dropout, normalize_before=False)
            self._pos = paddle.to_tensor(sinusoid_table(cfg.max_length, D))
            self._masks = {}

        def _embed(self, ids):
            S = ids.shape[1]
            x = self.embedding(ids) * math.sqrt(D) + self._pos[:S]
            return F.dropout(x, cfg.dropout, training=self.training)

        def tgt_mask(self, length):
            # made once a length: later steps copy nothing to the card
            if length not in self._masks:
                self._masks[length] = \
                    nn.Transformer.generate_square_subsequent_mask(length)
            return self._masks[length]

        def forward(self, src, tgt):
            h = self.transformer(self._embed(src), self._embed(tgt),
                                 tgt_mask=self.tgt_mask(tgt.shape[1]))
            return paddle.matmul(h, self.embedding.weight, transpose_y=True)

    return TransformerModel()


def criterion(paddle, logits, labels, epsilon: float = 0.1):
    """PaddleNLP's CrossEntropyCriterion without padding: the smoothed
    one-hot targets as soft labels, the mean over the tokens."""
    F = paddle.nn.functional
    soft = F.label_smooth(F.one_hot(labels, logits.shape[-1]),
                          epsilon=epsilon)
    return F.cross_entropy(logits, soft, soft_label=True)


def loss_fn(paddle, model, cfg, src, tgt_in, tgt_out, amp_dtype="bfloat16"):
    """The criterion's loss of one batch under O1 auto_cast in
    `amp_dtype` (None: f32 throughout)."""
    with paddle.amp.auto_cast(enable=amp_dtype is not None,
                              dtype=amp_dtype or "bfloat16", level="O1"):
        return criterion(paddle, model(src, tgt_in), tgt_out,
                         cfg.label_smoothing)


def train_step(paddle, model, cfg, opt, src, tgt_in, tgt_out,
               amp_dtype="bfloat16", span=None):
    """One step: the loss under O1 auto_cast, backward, the optimizer's
    step (its LRScheduler stepped after it) and clear_grad. Returns the
    loss Tensor. `span(name)`, when given, is a context manager entered
    around the forward, the backward and the optimizer's part."""
    from .eager_llama import _backward_and_step
    span = span or (lambda name: contextlib.nullcontext())
    with span("eager_forward"):
        loss = loss_fn(paddle, model, cfg, src, tgt_in, tgt_out, amp_dtype)
    _backward_and_step(loss, opt, None, span)
    sched = getattr(opt, "_learning_rate", None)
    if hasattr(sched, "step"):
        sched.step()
    return loss


def make_optimizer(paddle, model, cfg):
    """Adam(β 0.9 / 0.98, ε 1e-9) under NoamDecay(d_model, 4000), the
    paper's schedule."""
    sched = paddle.optimizer.lr.NoamDecay(cfg.d_model, 4000)
    return paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9, parameters=model.parameters())
