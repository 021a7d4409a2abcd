"""The eager Llama composed from Paddle-shaped layers.

    model = build_model(paddle, cfg)
    loss = train_step(paddle, model, loss_fn, opt, tokens)

A model composed to exercise the eager API, not a package feature: a
Llama of `cfg` (a LlamaConfig of either package; on the card the
flagship widths of bench.py:120-131) built the way PaddleNLP builds
`LlamaForCausalLM` with `use_fused_rms_norm`, `use_fused_rope` and
`use_flash_attention`, from `paddle.nn` and `paddle.incubate.nn`:

- `embed_tokens`, an `nn.Embedding`;
- each layer: `incubate.nn.FusedRMSNorm`, the q/k/v
  `nn.Linear(bias_attr=False)` reshaped to [B, S, H|KV, hd],
  `fused_rotary_position_embedding` (neox style, tables of
  `cfg.rope_theta`), `F.flash_attention(causal=True)` with the KV heads
  unexpanded, `o_proj` and the residual; then `FusedRMSNorm`, `gate_proj`
  and `up_proj`, `swiglu`, `down_proj` and the residual;
- the final `FusedRMSNorm`, `lm_head` (`nn.Linear(bias_attr=False)`) and
  `nn.CrossEntropyLoss` over the next tokens (`lm_loss`).

Weights are N(0, 0.02) and the norm gains 1, as `llama.init_params`
draws them; every parameter is f32. `paddle` is the package module:
`paddle_tpu_torch` on the card (chip_smoke.py's eager Llama phases,
tools/profile_train.py --model eager_llama), and either package in the
parity tests, which build the same composition from both.
"""
from __future__ import annotations

import contextlib

import numpy as np


def build_model(paddle, cfg):
    """The decoder + LM head of `cfg` (a LlamaConfig of either package)
    from `paddle`'s layers; its parameters are f32."""
    nn = paddle.nn
    F = nn.functional
    inc = paddle.incubate.nn
    D, L = cfg.hidden_size, cfg.num_hidden_layers
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps

    def normal():
        return nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))

    def linear(n_in, n_out):
        return nn.Linear(n_in, n_out, bias_attr=False, weight_attr=normal())

    class DecoderLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_layernorm = inc.FusedRMSNorm(D, epsilon=eps)
            self.q_proj = linear(D, H * hd)
            self.k_proj = linear(D, KV * hd)
            self.v_proj = linear(D, KV * hd)
            self.o_proj = linear(H * hd, D)
            self.post_attention_layernorm = inc.FusedRMSNorm(D, epsilon=eps)
            self.gate_proj = linear(D, cfg.intermediate_size)
            self.up_proj = linear(D, cfg.intermediate_size)
            self.down_proj = linear(cfg.intermediate_size, D)

        def forward(self, x, sin, cos):
            B, S = x.shape[0], x.shape[1]
            h = self.input_layernorm(x)
            q = self.q_proj(h).reshape([B, S, H, hd])
            k = self.k_proj(h).reshape([B, S, KV, hd])
            v = self.v_proj(h).reshape([B, S, KV, hd])
            q, k, _ = inc.functional.fused_rotary_position_embedding(
                q, k, None, sin=sin, cos=cos, use_neox_rotary_style=True)
            a, _ = F.flash_attention(q, k, v, causal=True)
            x = x + self.o_proj(a.reshape([B, S, H * hd]))
            h = self.post_attention_layernorm(x)
            return x + self.down_proj(inc.functional.swiglu(
                self.gate_proj(h), self.up_proj(h)))

    class LlamaForCausalLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed_tokens = nn.Embedding(cfg.vocab_size, D,
                                             weight_attr=normal())
            self.layers = nn.LayerList([DecoderLayer() for _ in range(L)])
            self.norm = inc.FusedRMSNorm(D, epsilon=eps)
            self.lm_head = linear(D, cfg.vocab_size)
            # rotary tables [max_pos, hd / 2], as rope_freqs makes them
            inv = 1.0 / (cfg.rope_theta
                         ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
            freqs = np.outer(np.arange(cfg.max_position_embeddings,
                                       dtype=np.float32), inv)
            self._cos = paddle.to_tensor(np.cos(freqs).astype("float32"))
            self._sin = paddle.to_tensor(np.sin(freqs).astype("float32"))

        def forward(self, tokens):
            x = self.embed_tokens(tokens)
            for layer in self.layers:
                x = layer(x, self._sin, self._cos)
            return self.lm_head(self.norm(x))

    return LlamaForCausalLM()


def lm_loss(loss_fn, logits, tokens):
    """Mean next-token cross entropy: position t predicts token t + 1."""
    V = logits.shape[-1]
    return loss_fn(logits[:, :-1].reshape([-1, V]),
                   tokens[:, 1:].reshape([-1]))


def train_step(paddle, model, loss_fn, opt, tokens, amp_dtype="bfloat16",
               span=None, amp_level="O1", scaler=None):
    """One step of the recipe: forward and loss under auto_cast at
    `amp_level` ("O1", or "O2" for a model and optimizer passed through
    `paddle.amp.decorate`) in `amp_dtype` (None: f32 throughout),
    backward, the optimizer's step, clear_grad; with a `GradScaler`, the
    backward and step are `scaler.minimize(opt, scaler.scale(loss))`.
    Returns the loss Tensor. `span(name)`, when given, is a context
    manager entered around each of the three parts ("eager_forward",
    "eager_backward", "eager_optimizer")."""
    span = span or (lambda name: contextlib.nullcontext())
    with span("eager_forward"), paddle.amp.auto_cast(
            enable=amp_dtype is not None, dtype=amp_dtype or "bfloat16",
            level=amp_level):
        loss = lm_loss(loss_fn, model(tokens), tokens)
    _backward_and_step(loss, opt, scaler, span)
    return loss


def _backward_and_step(loss, opt, scaler, span):
    """loss.backward() and opt.step(), or with a scaler
    `scaler.minimize(opt, scaler.scale(loss))` (its backward and its
    unscale, check and step, all in the "eager_backward" span), then
    opt.clear_grad()."""
    if scaler is None:
        with span("eager_backward"):
            loss.backward()
        with span("eager_optimizer"):
            opt.step()
            opt.clear_grad()
        return
    with span("eager_backward"):
        scaler.minimize(opt, scaler.scale(loss))
    with span("eager_optimizer"):
        opt.clear_grad()
