"""The eager ERNIE-3.0 encoder composed from Paddle-shaped layers.

    model = build_model(paddle, cfg, dropout=0.1)
    loss = train_step(paddle, model, loss_fn, opt, ids, labels)

A model composed to exercise the eager API, not a package feature: the
sequence-classification encoder of BASELINE config 1
(`ErnieConfig.ernie3_base`, the recipe of bench.py's `build_ernie_step`),
built the way PaddleNLP builds its fused ERNIE/BERT encoder, from
`paddle.nn` and `paddle.incubate.nn` layers:

- embeddings: word + position + token-type `nn.Embedding`, then
  `incubate.nn.FusedLayerNorm`;
- each layer: q/k/v `nn.Linear`, reshaped to [B, S, H, hd], then
  `F.scaled_dot_product_attention` (no mask, dropout_p 0, so the flash
  kernels); the output projection `nn.Linear(bias_attr=False)`, then
  `FusedBiasDropoutResidualLayerNorm`, which owns the bias; the FFN
  `nn.Linear(D, F)`, tanh-approximate GELU, `nn.Linear(F, D,
  bias_attr=False)` and a second `FusedBiasDropoutResidualLayerNorm`;
- head: the pooler `nn.Linear` + tanh on token 0, the classifier
  `nn.Linear`, and `nn.CrossEntropyLoss`.

Attention-probability dropout is 0: the eager SDPA leaves flash for the
exact path when dropout_p > 0, in the JAX package too. Weights are
N(0, 0.02), as `ernie.init_params` draws them. `paddle` is the package
module: `paddle_tpu_torch` on the card (chip_smoke.py's eager phases,
tools/profile_train.py --model eager_ernie), and either package in the
parity tests, which build the same composition from both.
"""
from __future__ import annotations

import contextlib


def build_model(paddle, cfg, dropout: float = 0.1):
    """The encoder + classification head of `cfg` (an ErnieConfig of
    either package) from `paddle`'s layers; its parameters are f32."""
    nn = paddle.nn
    F = nn.functional
    inc = paddle.incubate.nn
    D, H, L = cfg.hidden_size, cfg.num_attention_heads, cfg.num_hidden_layers
    hd, eps = D // H, cfg.layer_norm_eps

    def w_attr():
        return nn.ParamAttr(
            initializer=nn.initializer.Normal(0.0, 0.02))

    class Embeddings(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(cfg.vocab_size, D,
                                                weight_attr=w_attr())
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, D, weight_attr=w_attr())
            self.token_type_embeddings = nn.Embedding(
                cfg.type_vocab_size, D, weight_attr=w_attr())
            self.layer_norm = inc.FusedLayerNorm(D, epsilon=eps)

        def forward(self, ids):
            B, S = ids.shape
            x = self.word_embeddings(ids) \
                + self.position_embeddings(paddle.arange(S)) \
                + self.token_type_embeddings(
                    paddle.zeros([B, S], dtype="int64"))
            return self.layer_norm(x)

    class EncoderLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.q_proj = nn.Linear(D, D, weight_attr=w_attr())
            self.k_proj = nn.Linear(D, D, weight_attr=w_attr())
            self.v_proj = nn.Linear(D, D, weight_attr=w_attr())
            self.out_proj = nn.Linear(D, D, weight_attr=w_attr(),
                                      bias_attr=False)
            self.attn_norm = inc.FusedBiasDropoutResidualLayerNorm(
                D, dropout_rate=dropout, epsilon=eps)
            self.ffn_in = nn.Linear(D, cfg.intermediate_size,
                                    weight_attr=w_attr())
            self.ffn_out = nn.Linear(cfg.intermediate_size, D,
                                     weight_attr=w_attr(), bias_attr=False)
            self.ffn_norm = inc.FusedBiasDropoutResidualLayerNorm(
                D, dropout_rate=dropout, epsilon=eps)

        def forward(self, x):
            B, S = x.shape[0], x.shape[1]
            q, k, v = (p(x).reshape([B, S, H, hd])
                       for p in (self.q_proj, self.k_proj, self.v_proj))
            a = F.scaled_dot_product_attention(q, k, v)
            x = self.attn_norm(self.out_proj(a.reshape([B, S, D])), x)
            h = self.ffn_out(F.gelu(self.ffn_in(x), approximate=True))
            return self.ffn_norm(h, x)

    class ErnieForSequenceClassification(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embeddings = Embeddings()
            self.layers = nn.LayerList([EncoderLayer() for _ in range(L)])
            self.pooler = nn.Linear(D, D, weight_attr=w_attr())
            self.classifier = nn.Linear(D, cfg.num_labels,
                                        weight_attr=w_attr())

        def forward(self, ids):
            x = self.embeddings(ids)
            for layer in self.layers:
                x = layer(x)
            return self.classifier(F.tanh(self.pooler(x[:, 0])))

    return ErnieForSequenceClassification()


def train_step(paddle, model, loss_fn, opt, ids, labels,
               amp_dtype="bfloat16", span=None, amp_level="O1", scaler=None):
    """One step of the finetune recipe: forward and loss under auto_cast
    at `amp_level` ("O1", or "O2" for a model and optimizer passed
    through `paddle.amp.decorate`) in `amp_dtype` (None: f32
    throughout), backward, the optimizer's step, clear_grad; with a
    `GradScaler`, the backward and step are `scaler.minimize(opt,
    scaler.scale(loss))`. Returns the loss Tensor. `span(name)`, when
    given, is a context manager entered around each of the three parts
    ("eager_forward", "eager_backward", "eager_optimizer"), as the
    profile tool marks them."""
    from .eager_llama import _backward_and_step
    span = span or (lambda name: contextlib.nullcontext())
    with span("eager_forward"), paddle.amp.auto_cast(
            enable=amp_dtype is not None, dtype=amp_dtype or "bfloat16",
            level=amp_level):
        loss = loss_fn(model(ids), labels)
    _backward_and_step(loss, opt, scaler, span)
    return loss
