"""bench.py's headline runs on one NVIDIA GPU.

    python -m paddle_tpu_torch.tools.bench

The port's twin of the JAX package's bench.py (:354-393), which stays
as it is: the same configurations, batches, step counts and timing
protocol (`_timed_steps`: warm-up steps, a host sync through the loss,
the timed loop, a host sync), through the port's entry points. It prints
one JSON line with bench.py's keys (`metric` ... `decode_tok_s_w8_b32`)
plus the card's name and its `nvidia-smi` name and power limit; each
run's own result goes to standard error as it ends. MFU is over the H100
SXM's dense bf16 peak, 989 TFLOP/s. Without a card it exits non-zero.

Every run takes `cfg` and `device`, so a CPU test drives it at a tiny
config (its MFU then reads None: no device rate is taken on the CPU).
MoE trains through `train.make_train_step(model=moe)`, ERNIE through
`tools/ernie_finetune.build_ernie_step` (every row at full length, so
its key mask is all true), DiT through `tools/dit_train.run_dit`.
Decode times `generation.make_generate`, whose first call captures the
decode step in a CUDA graph, as bench.py's first call compiles.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .._device import resolve_device
from ..nlp import generation, llama, moe, train
from ..kernels.rope import rope_freqs

PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense bf16, at 700 W


def _mfu(flops_per_s, dev):
    """flops_per_s over the card's peak; None off the card."""
    return flops_per_s / PEAK_BF16_FLOPS if dev.type == "cuda" else None


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _tokens(cfg, shape, dev):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, shape)).to(dev)


def _timed_steps(step, state, tokens, warmup, timed):
    """bench.py's protocol: warm-up, a host sync through the loss, the
    timed loop, a host sync. Returns (seconds, last loss)."""
    for _ in range(max(warmup, 1)):
        state, m = step(state, tokens)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, tokens)
    loss_val = float(m["loss"])
    return time.perf_counter() - t0, loss_val


def cfg_05b():
    """bench.py:372-376's round-1 ~0.5B config (f32 params)."""
    return llama.LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=8, num_attention_heads=16,
        num_key_value_heads=8, max_position_embeddings=2048)


def run_config(cfg, batch, seq, timed_steps, state_quant=None,
               warmup_steps=2, grad_clip=1.0, device="cuda"):
    """bench.py's `run_config`: `train.make_train_step` on seeded tokens;
    `state_quant="8bit"` is the fused 8-bit AdamW, None the tree adamw
    behind a global-norm clip."""
    dev = resolve_device(device)
    tx = train.make_optimizer(1e-4, state_quant=state_quant,
                              grad_clip=grad_clip)
    state = train.init_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, tx, device=dev)
    step = train.make_train_step(cfg, tx, device=dev)
    tokens = _tokens(cfg, (batch, seq), dev)
    dt, loss_val = _timed_steps(step, state, tokens, warmup_steps,
                                timed_steps)
    tok_s = batch * seq * timed_steps / dt
    del state, step, tx, tokens
    _free()
    return {"tok_s": tok_s, "step_ms": 1e3 * dt / timed_steps,
            "mfu": _mfu(tok_s * llama.flops_per_token(cfg, seq), dev),
            "loss": loss_val, "params": llama.num_params(cfg)}


def run_moe(batch=20, seq=2048, timed_steps=10, cfg=None, device="cuda"):
    """bench.py's `run_moe` (BASELINE config 4): the 1.57B MoE, bf16
    params, 8-bit AdamW, clip 1.0; MFU counts active FLOPs."""
    dev = resolve_device(device)
    cfg = cfg or moe.MoeConfig.flagship_moe()
    tx = train.make_optimizer(1e-4, state_quant="8bit", grad_clip=1.0)
    state = train.init_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, tx, device=dev, model=moe)
    step = train.make_train_step(cfg, tx, device=dev, model=moe)
    tokens = _tokens(cfg, (batch, seq), dev)
    dt_total, _ = _timed_steps(step, state, tokens, 2, timed_steps)
    dt = dt_total / timed_steps
    del state, step, tx, tokens
    _free()
    return {"tok_s": batch * seq / dt, "step_ms": 1e3 * dt,
            "mfu": _mfu(moe.flops_per_token(cfg, seq) * batch * seq / dt,
                        dev),
            "params": moe.num_params(cfg)}


def run_ernie(batch=64, seq=512, timed_steps=10, cfg=None, device="cuda"):
    """bench.py's `run_ernie` (BASELINE config 1) through
    `tools/ernie_finetune.build_ernie_step`, every row at full length."""
    from ..nlp import ernie
    from .ernie_finetune import build_ernie_step
    dev = resolve_device(device)
    step, state, data, cfg = build_ernie_step(batch, seq, device=dev,
                                              cfg=cfg, lengths=(seq, seq))
    dt, _ = _timed_steps(step, state, data, 2, timed_steps)
    tok_s = batch * seq * timed_steps / dt
    del state, data, step
    _free()
    return {"tok_s": tok_s, "step_ms": 1e3 * dt / timed_steps,
            "mfu": _mfu(tok_s * ernie.flops_per_token(cfg, seq), dev),
            "params": ernie.num_params(cfg)}


def run_dit(batch=96, timed_steps=10, cfg=None, device="cuda"):
    """bench.py's `run_dit` (BASELINE config 3): `tools/dit_train`."""
    from .dit_train import run_dit as _run_dit
    dev = resolve_device(device)
    res = _run_dit(batch, timed_steps, device=dev, cfg=cfg)
    _free()
    return {**res, "mfu": res["mfu"] if dev.type == "cuda" else None}


def run_prefill(prompt_len=8192, timed=4, cfg=None, params=None,
                device="cuda"):
    """bench.py's `run_prefill`: one prompt of `prompt_len` tokens through
    `generation.forward_cached` at position 0 (the flash prefill) into a
    fresh cache of prompt_len + 64, on the 2B flagship stack."""
    dev = resolve_device(device)
    cfg = cfg or llama.LlamaConfig.flagship_2b(
        max_position_embeddings=prompt_len + 256)
    if params is None:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    T = prompt_len + 64
    prompt = _tokens(cfg, (1, prompt_len), dev)

    def prefill():
        cache = generation.init_cache(cfg, 1, T, device=dev)
        logits, _ = generation.forward_cached(params, prompt, cache, 0, cfg)
        return logits[:, -1]

    lg = prefill()
    float(lg[0, 0])
    t0 = time.perf_counter()
    for _ in range(timed):
        lg = prefill()
    float(lg[0, 0])
    dt = (time.perf_counter() - t0) / timed
    del prompt, lg
    _free()
    return {"prefill_tok_s": prompt_len / dt, "prefill_ms": 1e3 * dt}


def run_decode(batch=8, prompt_len=512, new_tokens=128, timed=3,
               weight_only=None, cfg=None, params=None, device="cuda"):
    """bench.py's `run_decode`: greedy `generate` (prefill + the decode
    loop) of `new_tokens` tokens at `batch` on the 2B flagship stack;
    `weight_only=8` or 4 decodes from `quantize_for_serving`'s tree.
    Generated tokens/s across the batch."""
    dev = resolve_device(device)
    cfg = cfg or llama.LlamaConfig.flagship_2b(
        max_position_embeddings=prompt_len + new_tokens)
    if params is None:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if weight_only:
        params = generation.quantize_for_serving(params, bits=weight_only)
    prompt = _tokens(cfg, (batch, prompt_len), dev)
    gen = generation.make_generate(params, cfg, batch, prompt_len,
                                   new_tokens, greedy=True, device=dev)
    out = gen(prompt)
    int(out[0, -1])
    t0 = time.perf_counter()
    for _ in range(timed):
        out = gen(prompt)
    int(out[0, -1])
    dt = (time.perf_counter() - t0) / timed
    del params, prompt, gen, out
    _free()
    return {"decode_tok_s": batch * new_tokens / dt,
            "generate_ms": 1e3 * dt}


def run_8b_layer(seq, batch=1, timed_steps=8, cfg=None, device="cuda"):
    """bench.py's `run_8b_layer`: one Llama-3-8B layer (bf16 params, no
    recompute), the gradient of sum(y.float()**2) with respect to its
    weights through `llama._decoder_layer`; MFU by bench.py's count."""
    dev = resolve_device(device)
    cfg = cfg or llama.LlamaConfig.llama3_8b(
        num_hidden_layers=1, param_dtype=torch.bfloat16, remat=False)
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(0)
    lp = {k: v[0] for k, v in llama.init_params(
        cfg, gen, device=dev, training=True)["layers"].items()}
    cos, sin = rope_freqs(hd, seq, cfg.rope_theta, torch.float32, device=dev)
    x = (torch.randn(batch, seq, D, generator=gen, device=dev) * 0.1
         ).to(cfg.dtype)

    def loss(p, x_):
        y = llama._decoder_layer(x_, p, cfg, cos, sin)
        return torch.sum(y.float() ** 2)

    def step():
        return train.value_and_grad(loss, lp, x)[1]

    g = step()
    float(g["q_proj"].reshape(-1)[0])
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        g = step()
    float(g["q_proj"].reshape(-1)[0])
    dt = (time.perf_counter() - t0) / timed_steps
    matmul = D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F_
    attn = H * hd * seq    # causal: QK^T + PV at ~seq/2 visible keys each
    flops = 6.0 * (matmul + attn) * batch * seq
    del lp, x, g
    _free()
    return {"mfu": _mfu(flops / dt, dev), "step_ms": 1e3 * dt,
            "flops": flops}


# bench.py main()'s runs, with its arguments
RUNS = {
    "big": lambda: run_config(llama.LlamaConfig.flagship_2b(), batch=8,
                              seq=2048, timed_steps=8, state_quant="8bit",
                              grad_clip=1.0),
    "05b": lambda: run_config(cfg_05b(), batch=16, seq=2048,
                              timed_steps=10),
    "layer8b_4k": lambda: run_8b_layer(seq=4096),
    "layer8b_8k": lambda: run_8b_layer(seq=8192),
    "long8k": lambda: run_config(
        llama.LlamaConfig.flagship_2b(max_position_embeddings=8192),
        batch=2, seq=8192, timed_steps=4, state_quant="8bit", grad_clip=1.0),
    "moe": run_moe,
    "ernie": run_ernie,
    "dit": run_dit,
    "prefill": run_prefill,
    "decode": run_decode,
    "decode_w8": lambda: run_decode(weight_only=8),
    "decode_w8_b32": lambda: run_decode(batch=32, weight_only=8),
}


def headline(res, device_name=None, nvidia_smi=None, batch=8, seq=2048):
    """bench.py's JSON object from the runs' results `res` (keyed as
    RUNS; a run that is missing reads null), with the card's name and
    `nvidia-smi` line."""
    def get(run, key):
        r = res.get(run)
        return None if r is None else r[key]

    big_mfu = get("big", "mfu")
    return {
        "metric": "llama_train_tokens_per_sec_per_chip",
        "value": get("big", "tok_s"),
        "unit": "tokens/s",
        "vs_baseline": None if big_mfu is None else big_mfu / 0.40,
        "mfu": big_mfu,
        "device": device_name,
        "model_params": get("big", "params"),
        "batch": batch, "seq": seq,
        "loss": get("big", "loss"),
        "mfu_05b": get("05b", "mfu"),
        "tok_s_05b": get("05b", "tok_s"),
        "mfu_8b_layer": get("layer8b_4k", "mfu"),
        "mfu_8b_layer_s8k": get("layer8b_8k", "mfu"),
        "mfu_2b_seq8k": get("long8k", "mfu"),
        "tok_s_2b_seq8k": get("long8k", "tok_s"),
        "mfu_moe": get("moe", "mfu"),
        "tok_s_moe": get("moe", "tok_s"),
        "moe_params": get("moe", "params"),
        "mfu_ernie": get("ernie", "mfu"),
        "tok_s_ernie": get("ernie", "tok_s"),
        "mfu_dit": get("dit", "mfu"),
        "img_s_dit": get("dit", "img_s"),
        "prefill_tok_s": get("prefill", "prefill_tok_s"),
        "decode_tok_s": get("decode", "decode_tok_s"),
        "decode_tok_s_w8": get("decode_w8", "decode_tok_s"),
        "decode_tok_s_w8_b32": get("decode_w8_b32", "decode_tok_s"),
        "nvidia_smi": nvidia_smi,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: CUDA is not available; the runs are "
                         "measured on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {}
    for name, run in RUNS.items():
        res[name] = run()
        print(json.dumps({"run": name, **res[name]}), file=sys.stderr,
              flush=True)
    print(json.dumps(headline(res, torch.cuda.get_device_name(0), smi)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
