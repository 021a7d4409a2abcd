"""KV-cache autoregressive generation for the Llama family.

Port of paddle_tpu/nlp/generation.py on one device: `KVCache`,
`init_cache`, `QUANT_KEYS`, `quantize_for_serving` (weight-only int8 and
int4 trees), `_wq`, `_mlp_cached`, `_final_head_cached`,
`_gqa_cached_attention`, `_attention_cached`, `forward_cached`, `_sample`
and `generate`; the paged serving path (`nlp/paged.py`) shares the
serving pieces. `cache_spec`, `quantized_specs` and every `mesh=` belong
to the multi-GPU slice: a mesh raises `NotImplementedError`.

As in the JAX package, the cache is a static [L, B, T_max, KV, hd] pair,
and prefill and decode share one cached-attention path (prefill is the
P > 1 case): a prompt at the int position 0 runs the flash forward
kernel over its own keys (row 1, `csrc/flash_fwd.cu`), everything else
exact grouped attention over the whole cache with f32 scores. The norms,
RoPE, the sampler and the GEMMs are plain torch, as they are jnp/XLA in
the JAX package.

Where PyTorch differs:
  * the cache is written IN PLACE at `pos` (`index_copy_`, so a device
    `pos` needs no host read) and `forward_cached` returns the same
    tensors; JAX returns a new cache.
  * `pos` is a Python int or a 0-d int64 device tensor, the counterpart
    of a traced `pos`. As in JAX, only an int 0 takes the flash prefill.
  * the decode loop, JAX's `lax.scan` under jit, is one decode step over
    static device tensors (the token [B], `pos`, `done` [B], the output
    buffer [B, max_new_tokens] and the step index). On a card it runs
    once on a side stream to warm up, is captured once in a CUDA graph,
    and the graph is replayed once per new token, with one synchronize
    at the end: no host round-trip per token. On the CPU the same step
    runs in a Python loop. `make_generate` keeps its capture across
    calls, as `jax.jit` keeps its executable; `generate` makes one and
    calls it once.
  * `key` is a `torch.Generator` (jax.random streams cannot be
    reproduced; greedy decoding agrees exactly), registered with the
    graph when sampling.
  * int4 codes are held in int8 tensors with values in [-7, 7]: torch
    has no usable int4 storage, so they take twice the memory of JAX's
    `int4`. `_wq` dequantizes into a compute-dtype weight before each
    GEMM; XLA fuses the same product into the dot's operand read.
  * a prompt of 2 <= P < 128 also runs the flash kernel, which takes any
    length, where the JAX package's `_pallas_ok` sends it to `mha_ref`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels.flash_attention import flash_attention_fwd
from ..kernels.rms_norm import rms_norm_ref
from ..kernels.rope import apply_rope_half, rope_freqs
from . import llama

_TOPP_CANDIDATES = 4096


def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{what} with a mesh is not ported yet: tensor-parallel "
            f"generation comes with the multi-GPU slice")


class KVCache(NamedTuple):
    """k/v: [L, B, T_max, KV_heads, head_dim] in the compute dtype."""
    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: llama.LlamaConfig, batch: int, max_len: int,
               mesh=None, device="cuda") -> KVCache:
    """A zeroed cache on `device` (the card unless the caller asks for
    the CPU)."""
    _no_mesh(mesh, "init_cache")
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


# the decode GEMM weights that weight-only quantization stores as codes
# (the JAX package's list: every per-layer projection; the embedding and
# the norms stay in full precision)
QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")


def quantize_for_serving(params: Dict[str, Any], bits: int = 8,
                         quantize_head: bool = True) -> Dict[str, Any]:
    """Weight-only quantization of the decode GEMM weights. Each
    projection [L, Din, Dout] becomes int8 codes round(w / scale) clipped
    to +-127 (bits=8) or +-7 (bits=4, still int8 storage), computed in
    f32, and a per-(layer, output channel) f32 scale [L, 1, Dout] (the
    abs-max over the contracted dim over the bound) under
    '<name>:scale'. `quantize_head` also quantizes lm_head, which a tied
    checkpoint does not have."""
    if bits == 8:
        bound = 127.0
    elif bits == 4:
        bound = 7.0
    else:
        raise ValueError(f"weight-only bits must be 8 or 4, got {bits}")

    def quant(w):
        w32 = w.float()
        scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True),
                            min=1e-9) / bound
        codes = torch.clamp(torch.round(w32 / scale), -bound, bound)
        return codes.to(torch.int8), scale

    out = dict(params)
    layers = dict(params["layers"])
    for name in QUANT_KEYS:
        layers[name], layers[name + ":scale"] = quant(layers[name])
    out["layers"] = layers
    if quantize_head and "lm_head" in params:
        out["lm_head"], out["lm_head:scale"] = quant(params["lm_head"])
    return out


def _wq(tree, name, cd):
    """A possibly weight-only-quantized weight in the compute dtype `cd`:
    codes and scale each cast to `cd`, then multiplied (the JAX
    package's dequantize-on-read; here a weight made before the GEMM)."""
    scale = tree.get(name + ":scale")
    w = tree[name]
    if scale is not None:
        return w.to(cd) * scale.to(cd)
    return w.to(cd)


def _mlp_cached(x, lp, cfg):
    """SwiGLU MLP over `_wq` reads."""
    g = x @ _wq(lp, "gate_proj", cfg.dtype)
    u = x @ _wq(lp, "up_proj", cfg.dtype)
    return (F.silu(g) * u) @ _wq(lp, "down_proj", cfg.dtype)


def _final_head_cached(params, x, cfg):
    """Final RMSNorm + LM head → f32 logits, over a quantized lm_head
    where the tree has one (else llama's head, tied or not)."""
    if "lm_head:scale" not in params:
        return llama._final_head(params, x, cfg)
    cd = cfg.dtype
    x = rms_norm_ref(x, params["norm"], cfg.rms_norm_eps)
    return (x.to(cd) @ _wq(params, "lm_head", cd)).float()


def _gqa_cached_attention(q, ck, cv, pos):
    """q [B, P, H, hd] against this layer's cache ck/cv [B, T, KV, hd],
    key t visible to query i (at absolute position pos + i) iff
    t <= pos + i. Query heads grouped per KV head (no repeat of K/V);
    q and the cache enter the products in f32, the counterpart of JAX's
    bf16 dots with `preferred_element_type=f32`, so scores, softmax and
    output stay f32."""
    B, P, H, hd = q.shape
    T, KV = ck.shape[1], ck.shape[2]
    qg = q.float().reshape(B, P, KV, H // KV, hd)
    s = torch.einsum("bpkrd,btkd->bkrpt", qg, ck.float()) / math.sqrt(hd)
    keys = torch.arange(T, device=q.device)
    if P == 1:
        vis = (keys <= pos)[None, None, None, None, :]
    else:
        vis = ((pos + torch.arange(P, device=q.device)[:, None])
               >= keys[None, :])[None, None, None]
    p = torch.softmax(torch.where(vis, s, -1e30), dim=-1)
    o = torch.einsum("bkrpt,btkd->bpkrd", p, cv.float())
    return o.reshape(B, P, H, hd)


def _attention_cached(x, lp, cfg, cos, sin, ck, cv, pos):
    """x [B, P, D]: new tokens at absolute positions pos..pos+P-1; ck/cv:
    this layer's cache [B, T, KV, hd], written in place. Returns (out,
    ck, cv)."""
    B, P, _ = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cd = cfg.dtype
    q = (x @ _wq(lp, "q_proj", cd)).reshape(B, P, H, hd)
    k = (x @ _wq(lp, "k_proj", cd)).reshape(B, P, KV, hd)
    v = (x @ _wq(lp, "v_proj", cd)).reshape(B, P, KV, hd)
    at = pos + torch.arange(P, device=x.device)
    q, k = apply_rope_half(q, k, cos, sin, at[None, :].expand(B, P))
    ck.index_copy_(1, at, k.to(ck.dtype))
    cv.index_copy_(1, at, v.to(cv.dtype))
    if P > 1 and isinstance(pos, int) and pos == 0 and cfg.use_flash:
        # prefill: the prompt attends only to itself (the cache beyond P
        # is unwritten), so this is causal self-attention over the new
        # k/v: the flash forward, not the [P, T] masked cache
        o = flash_attention_fwd(q, k, v, True)
    else:
        o = _gqa_cached_attention(q, ck, cv, pos)
    return o.to(cd).reshape(B, P, H * hd) @ _wq(lp, "o_proj", cd), ck, cv


def forward_cached(params: Dict[str, Any], tokens: torch.Tensor,
                   cache: KVCache, pos, cfg: llama.LlamaConfig, mesh=None):
    """tokens [B, P] at absolute positions pos..pos+P-1 → (logits
    [B, P, V] f32, cache). P > 1 is a prefill, P = 1 a decode step;
    `pos` is an int or a 0-d int64 device tensor. Each layer writes its
    new K/V into `cache` in place; the same cache is returned."""
    _no_mesh(mesh, "forward_cached")
    cd = cfg.dtype
    T = cache.k.shape[2]
    x = params["embed_tokens"][tokens.long()].to(cd)
    cos, sin = rope_freqs(cfg.head_dim, T, cfg.rope_theta, torch.float32,
                          device=x.device)
    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        lp = {k: w[li] for k, w in layers.items()}
        h = rms_norm_ref(x, lp["input_layernorm"], cfg.rms_norm_eps)
        a, _, _ = _attention_cached(h, lp, cfg, cos, sin, cache.k[li],
                                    cache.v[li], pos)
        x = x + a
        h = rms_norm_ref(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _mlp_cached(h, lp, cfg)
    return _final_head_cached(params, x, cfg), cache


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float, top_k: int, top_p: float, greedy: bool):
    """logits [B, V] → token ids [B] (int32). Greedy is argmax, exactly
    the JAX function's; top-k then top-p filter sequentially (top-p
    renormalizes over the top-k survivors) and draw from `generator`,
    whose random bits differ from jax.random's, so sampling agrees with
    the JAX function in distribution only. Nothing is read back to the
    host, so the step runs inside a CUDA graph."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    V = logits.shape[-1]
    sorted_l = None
    if top_k:
        k = min(int(top_k), V)
        sorted_l = torch.topk(logits, k, dim=-1).values     # descending
        logits = torch.where(logits < sorted_l[:, -1:], -1e30, logits)
    if top_p < 1.0:
        if sorted_l is None:
            cand = torch.topk(logits, min(_TOPP_CANDIDATES, V), dim=-1).values
            # exact head of the full-vocab cumulative distribution: the
            # denominator is logsumexp over ALL logits, not the candidates
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            probs = torch.exp(cand - lse)
        else:
            cand = sorted_l
            probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set whose cumulative prob >= top_p; the clamp keeps at
        # least the top token even at top_p == 0
        cutoff_idx = torch.clamp(
            torch.sum((cum - probs) < top_p, dim=-1) - 1, min=0)
        cutoff = torch.gather(cand, -1, cutoff_idx[:, None])
        if sorted_l is None and cand.shape[-1] < V:
            cutoff = torch.where(cum[:, -1:] >= top_p, cutoff,
                                 torch.full_like(cutoff, -float("inf")))
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits.float(), dim=-1)
    # one draw a row by the exponential race, argmax p / E with E ~ Exp(1),
    # the draw torch.multinomial makes for one sample, without its host
    # check of the probabilities
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


class _Generate:
    """`generate` for one (batch, prompt length, budget): the cache and
    the decode step's state are static tensors on `device`, so the step
    can be captured once and replayed. `graphed` captures it (the card);
    without it the step runs eagerly (the CPU, and the card's eager twin
    that `chip_smoke.py` holds the graph's tokens to)."""

    def __init__(self, params, cfg, batch, prompt_len, max_new_tokens,
                 temperature, top_k, top_p, greedy, eos_token_id,
                 pad_token_id, key, device, graphed):
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        dev = resolve_device(device)
        self.params, self.cfg, self.dev = params, cfg, dev
        self.shape = (batch, prompt_len)
        self.max_new_tokens = max_new_tokens
        self.sampling = (temperature, top_k, top_p, greedy)
        self.eos, self.pad = eos_token_id, pad_token_id
        self.key = key if key is not None or greedy else \
            torch.Generator(device=dev).manual_seed(0)
        self.cache = init_cache(cfg, batch, prompt_len + max_new_tokens,
                                device=dev)
        self.tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.done = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.out = torch.zeros(batch, max_new_tokens, dtype=torch.int32,
                               device=dev)
        self.idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graphed = graphed
        self.graph = None

    def _sample(self, logits):
        return _sample(logits, self.key, *self.sampling)

    def prefill(self, input_ids):
        """The prompt through `forward_cached` at the int position 0, its
        first token sampled; resets the step state."""
        if tuple(input_ids.shape) != self.shape:
            raise ValueError(f"input_ids must be {list(self.shape)}, got "
                             f"{list(input_ids.shape)}")
        logits, _ = forward_cached(self.params, input_ids.to(self.dev),
                                   self.cache, 0, self.cfg)
        first = self._sample(logits[:, -1])
        self.tok.copy_(first)
        self.pos.fill_(self.shape[1])
        self.idx.fill_(1)
        self.out[:, 0] = first
        if self.eos is None:
            self.done.zero_()
        else:
            self.done.copy_(first == self.eos)

    def _step(self):
        logits, _ = forward_cached(self.params, self.tok[:, None],
                                   self.cache, self.pos, self.cfg)
        nxt = torch.where(self.done, self.pad, self._sample(logits[:, 0]))
        if self.eos is not None:
            self.done |= nxt == self.eos
        self.out.index_copy_(1, self.idx, nxt[:, None])
        self.tok.copy_(nxt)
        self.pos += 1
        self.idx += 1

    def _capture(self):
        state = (self.tok, self.pos, self.done, self.idx)
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            self._step()            # warm-up: allocator, cuBLAS workspace
        torch.cuda.current_stream(self.dev).wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        if not self.sampling[3]:
            graph.register_generator_state(self.key)
        with torch.cuda.graph(graph):
            self._step()
        self.graph = graph

    def decode(self):
        """The max_new_tokens - 1 decode steps after `prefill`."""
        n = self.max_new_tokens - 1
        if not self.graphed:
            for _ in range(n):
                self._step()
            return
        if n and self.graph is None:
            self._capture()
        for _ in range(n):
            self.graph.replay()
        torch.cuda.synchronize(self.dev)

    def __call__(self, input_ids):
        self.prefill(input_ids)
        self.decode()
        return self.out.clone()


def make_generate(params: Dict[str, Any], cfg: llama.LlamaConfig,
                  batch: int, prompt_len: int, max_new_tokens: int = 32,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, greedy: bool = True,
                  eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                  key: Optional[torch.Generator] = None, mesh=None,
                  device="cuda"):
    """`generate` compiled for one shape, the port's `jax.jit(generate)`:
    returns `gen(input_ids [batch, prompt_len]) -> [batch,
    max_new_tokens]` int32. On the card its first call captures the
    decode step in a CUDA graph; later calls replay it."""
    _no_mesh(mesh, "generate")
    dev = resolve_device(device)
    return _Generate(params, cfg, batch, prompt_len, max_new_tokens,
                     temperature, top_k, top_p, greedy, eos_token_id,
                     pad_token_id, key, dev, graphed=dev.type == "cuda")


def generate(params: Dict[str, Any], input_ids, cfg: llama.LlamaConfig,
             max_new_tokens: int = 32, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0, greedy: bool = True,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             key: Optional[torch.Generator] = None, mesh=None,
             device="cuda") -> torch.Tensor:
    """Autoregressive generation: prefill + the decode loop.

    input_ids [B, P] → [B, max_new_tokens] int32 (positions after an eos
    are `pad_token_id`; the loop runs to the end, as JAX's scan does).
    `key`: a `torch.Generator` on `device` for sampling (None: seeded 0).
    Runs on `device`, the card unless the caller asks for the CPU."""
    if not isinstance(input_ids, torch.Tensor):
        input_ids = torch.from_numpy(np.asarray(input_ids))
    B, P = input_ids.shape
    return make_generate(params, cfg, B, P, max_new_tokens, temperature,
                         top_k, top_p, greedy, eos_token_id, pad_token_id,
                         key, mesh, device)(input_ids)
