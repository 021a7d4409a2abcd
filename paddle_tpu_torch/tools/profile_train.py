"""Where a training step's time goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.tools.profile_train
        [--model llama|moe|long8k|train05b|eager_ernie|eager_llama|ernie|dit]
        [--layers N]

`--model llama` (default) builds the flagship dense config (bench.py:120:
D 4096, F 9472, 11 layers, GQA 32/8, V 32000; batch 8 x 2048);
`--model moe` the single-chip MoE config (bench.py:98: D 2048, 12
layers, GQA 16/8, 16 experts top-2 of width 1024 plus a shared expert,
V 32000; batch 20 x 2048); `--model long8k` the flagship at 2 x 8192
(bench.py:381). All three: bf16 params, 8-bit AdamW with the clip at
1.0, lr 1e-4. `--model train05b` is bench.py:372-376's ~0.5B config
(D 2048, F 5632, 8 layers, GQA 16/8; batch 16 x 2048) with f32 params
and the tree adamw behind the clip. Each: random weights from a seed,
full depth unless `--layers` cuts it; they drive
`train.make_train_step`. The eager models
drive their `train_step` under O1 bf16 with f32 params and AdamW with
the global clip: `--model eager_ernie` the ERNIE-3.0-base encoder
composed from layers (tools/eager_ernie.py; batch 64 x 512, lr 2e-5),
`--model eager_llama` the flagship-width Llama composed from layers
(tools/eager_llama.py; batch 2 x 2048, lr 1e-4). `--model ernie` drives
the functional ERNIE finetune step over nlp/ernie.py
(tools/ernie_finetune.py: batch 64 x 512 padded to lengths 128-512,
adamw 2e-5); `--model dit` the DiT-XL/2 train step of BASELINE config 3
(tools/dit_train.py: batch 96 of 32x32x4 latents, 256 patch tokens,
adamw_q 1e-4, per-block recompute; `--layers` cuts the depth). Each
takes one untraced warm-up step, one untraced step for
its wall time without the profiler's per-operation cost, then one step
traced by torch.profiler.

It prints one JSON line for the traced step: the host wall time (the
step ends in a synchronize), the device time summed by kernel class
(GEMM, flash forward, flash backward, RMSNorm, AdamW, MoE dispatch,
other; for the MoE model also "routing", the device time of the torch
ops inside `moe.top_k_routing`'s "moe_routing" range, taken out of
"other"; the LayerNorm kernels as "layer_norm", the row-6 RMSNorm as
"rms_fused"; for the eager models the device and host time of each
range: the backward's device time is the busy time less the other two
ranges', since autograd launches it from its own thread; for the ERNIE
and DiT steps those of their "optimizer" range), the device
busy time (the sum over kernels; one stream, so they do not overlap),
the idle share 1 - busy / wall, the kernel launch count, the port's own
kernel launches by wrapper and (eager and ERNIE steps) the peak device
memory. The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

# the training batch and length of each model (bench.py:369-370,
# bench.py:87 and bench.py:134)
_BATCH = {"llama": 8, "moe": 20, "eager_ernie": 64, "eager_llama": 2,
          "ernie": 64, "dit": 96, "long8k": 2, "train05b": 16}
_SEQ = {"llama": 2048, "moe": 2048, "eager_ernie": 512, "eager_llama": 2048,
        "ernie": 512, "dit": 256, "long8k": 8192, "train05b": 2048}
_GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "nvjet", "cublas")
# kernel symbol names of csrc/*.cu, by class
_PORT_KERNELS = (("flash_fwd_kernel", "flash_fwd"),
                 ("dkdv_kernel", "flash_bwd"), ("dq_kernel", "flash_bwd"),
                 ("dcap_kernel", "flash_bwd"),
                 ("rms_fused_kernel", "rms_fused"), ("rms_fwd_kernel", "rms"),
                 ("rms_bwd_kernel", "rms"), ("rms_dw_kernel", "rms"),
                 ("adamw_q_kernel", "adamw"),
                 ("gather_wsum_kernel", "moe_dispatch"),
                 ("gather_scale_dot_kernel", "moe_dispatch"),
                 ("ln_fwd_kernel", "layer_norm"),
                 ("ln_bwd_kernel", "layer_norm"),
                 ("ln_dwdb_kernel", "layer_norm"),
                 ("adaln_", "adaln"), ("gather_rows_kernel", "moe_dispatch"),
                 ("gather_mlp_kernel", "moe_dispatch"))
_EAGER_RANGES = ("eager_forward", "eager_backward", "eager_optimizer")


def _kernel_class(name: str) -> str:
    for mark, cls in _PORT_KERNELS:
        if mark in name:
            return cls
    if any(m in name for m in _GEMM_MARKS):
        return "gemm"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(_BATCH), default="llama")
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder depth (default: the config's own)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.model in ("eager_ernie", "eager_llama"):
        return _main_eager(args)
    if args.model in ("ernie", "dit"):
        return _main_step(args)
    from ..kernels import flash_attention as fa
    from ..kernels import moe_dispatch as md
    from ..kernels import rms_norm as rn
    from ..nlp import llama, moe, train
    from ..optimizer import quant_state as qs

    over = ({} if args.layers is None
            else {"num_hidden_layers": args.layers})
    if args.model == "moe":
        model, cfg = moe, moe.MoeConfig.flagship_moe(**over)
    elif args.model == "train05b":
        from .bench import cfg_05b
        model, cfg = llama, dataclasses.replace(cfg_05b(), **over)
    else:
        model, cfg = llama, llama.LlamaConfig.flagship_2b(
            max_position_embeddings=_SEQ[args.model], **over)
    batch = _BATCH[args.model]
    tx = train.make_optimizer(
        1e-4, state_quant=None if args.model == "train05b" else "8bit",
        grad_clip=1.0)
    state = train.init_state(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg, tx,
        model=model)
    step = train.make_train_step(cfg, tx, model=model)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (batch, _SEQ[args.model]))).cuda()
    state, _ = step(state, tokens)                    # warm-up, untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, tokens)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0

    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "rms_norm_fwd": rn.rms_norm_fwd,
                "rms_norm_bwd": rn.rms_norm_bwd,
                "adamw_q": qs.fused_leaf_update}
    if model is moe:
        counters.update({"gather_wsum": md.gather_wsum,
                         "gather_scale_dot": md.gather_scale_dot})
    for c in counters.values():
        c.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, launches, ranges = _device_times(prof, ("moe_routing",))
    routing_ms = ranges["moe_routing"]["device_ms"]
    if routing_ms:
        by_class["routing"] = routing_ms
        by_class["other"] = by_class.get("other", 0.0) - routing_ms
    busy = sum(by_class.values())
    tok = batch * _SEQ[args.model]
    print(json.dumps({
        "step": "train", "traced": True, "wall_ms": wall * 1e3,
        "untraced_wall_ms": untraced * 1e3, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3),
        "device_ms_by_class": by_class, "kernel_launches": launches,
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, "untraced_tokens_per_s": tok / untraced,
        "loss": float(m["loss"])}), flush=True)
    _print_device(args, cfg.num_hidden_layers, batch)
    return 0


def _device_times(prof, range_names):
    """(device ms by kernel class, kernel launches, {range: {device_ms,
    host_ms}}) of a traced step. A range's device time is the sum of the
    kernels that start inside its span on the device (the profiler's
    user annotation of the range there: from its first kernel's start to
    its last kernel's end; one stream, so no other range's kernels run
    inside it)."""
    by_class: dict = {}
    launches = 0
    ranges = {n: {"device_ms": 0.0, "host_ms": 0.0} for n in range_names}
    spans = {n: [] for n in range_names}
    kernels = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            if ev.name in ranges:
                ranges[ev.name]["host_ms"] += ev.cpu_time_total / 1e3
            continue
        if getattr(ev, "is_user_annotation", False):
            if ev.name in spans:
                spans[ev.name].append((ev.time_range.start,
                                       ev.time_range.end))
            continue
        start, us = ev.time_range.start, ev.time_range.end - \
            ev.time_range.start
        kernels.append((start, us))
        c = _kernel_class(ev.name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        launches += c != "memcpy"
    if not by_class:
        raise RuntimeError("torch.profiler recorded no device activity")
    for name, sp in spans.items():
        ranges[name]["device_ms"] = sum(
            us for start, us in kernels
            if any(a <= start < b for a, b in sp)) / 1e3
    return by_class, launches, ranges


def _print_device(args, layers, batch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"model": args.model, "layers": layers, "batch": batch,
                      "seq": _SEQ[args.model],
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)


def _main_eager(args) -> int:
    """The eager steps (`--model eager_ernie` or `eager_llama`)."""
    import paddle_tpu_torch as paddle
    from ..kernels import flash_attention as fa
    from ..kernels import layer_norm as ln
    from ..kernels import rms_norm as rn
    from ..nlp import ernie, llama
    from . import eager_ernie, eager_llama

    over = ({} if args.layers is None
            else {"num_hidden_layers": args.layers})
    batch, seq = _BATCH[args.model], _SEQ[args.model]
    paddle.set_device("gpu")
    paddle.seed(args.seed)
    rng = np.random.default_rng(args.seed)
    loss_fn = paddle.nn.CrossEntropyLoss()
    if args.model == "eager_ernie":
        cfg = ernie.ErnieConfig.ernie3_base(**over)
        model, lr = eager_ernie.build_model(paddle, cfg, dropout=0.1), 2e-5
        ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
        labels = paddle.to_tensor(rng.integers(0, cfg.num_labels, (batch,)))

        def run(opt, span):
            return eager_ernie.train_step(paddle, model, loss_fn, opt, ids,
                                          labels, span=span)
    else:
        cfg = llama.LlamaConfig.flagship_2b(**over)
        model, lr = eager_llama.build_model(paddle, cfg), 1e-4
        tokens = paddle.to_tensor(rng.integers(0, cfg.vocab_size,
                                               (batch, seq)))

        def run(opt, span):
            return eager_llama.train_step(paddle, model, loss_fn, opt,
                                          tokens, span=span)
    opt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def step(span=None):
        return run(opt, span)

    step()                                            # warm-up, untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    counters = {"layer_norm_fwd": ln.layer_norm_fwd,
                "layer_norm_bwd": ln.layer_norm_bwd,
                "rms_norm_fused": rn.rms_norm_fused,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd}
    for c in counters.values():
        c.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = step(span=torch.profiler.record_function)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, launches, ranges = _device_times(prof, _EAGER_RANGES)
    busy = sum(by_class.values())
    # autograd launches the backward from its own thread
    ranges["eager_backward"]["device_ms"] = busy - sum(
        ranges[n]["device_ms"] for n in ("eager_forward", "eager_optimizer"))
    tok = batch * seq
    print(json.dumps({
        "step": "eager_train", "traced": True, "wall_ms": wall * 1e3,
        "untraced_wall_ms": untraced * 1e3, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3),
        "device_ms_by_class": by_class, "ranges": ranges,
        "kernel_launches": launches,
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, "untraced_tokens_per_s": tok / untraced,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "loss": float(loss)}), flush=True)
    _print_device(args, cfg.num_hidden_layers, batch)
    return 0


def _main_step(args) -> int:
    """The functional ERNIE finetune step over nlp/ernie.py (`--model
    ernie`) and the DiT-XL/2 step over mix/dit.py (`--model dit`)."""
    from ..kernels import flash_attention as fa

    batch, seq = _BATCH[args.model], _SEQ[args.model]
    if args.model == "ernie":
        from ..kernels import layer_norm as ln
        from ..nlp import ernie
        from .ernie_finetune import build_ernie_step
        cfg = ernie.ErnieConfig.ernie3_base(
            num_labels=2, remat=False, scan_unroll=True,
            **({} if args.layers is None
               else {"num_hidden_layers": args.layers}))
        step, state, data, cfg = build_ernie_step(batch, seq, cfg=cfg,
                                                  seed=args.seed)
        layers, extra = cfg.num_hidden_layers, {
            "valid_tokens": int(data[2].sum())}
        counters = {"layer_norm_fwd": ln.layer_norm_fwd,
                    "layer_norm_bwd": ln.layer_norm_bwd}
    else:
        from ..kernels import adaln
        from ..kernels import moe_dispatch as md
        from ..mix import dit
        from .dit_train import build_dit_step
        cfg = dit.DiTConfig.dit_xl_2(
            **({} if args.layers is None else {"depth": args.layers}))
        step, state, data, cfg = build_dit_step(batch, cfg=cfg,
                                                seed=args.seed)
        layers, extra = cfg.depth, {"flops_per_image":
                                    dit.flops_per_image(cfg)}
        counters = {"adaln_fwd": adaln.adaln_fwd,
                    "adaln_bwd": adaln.adaln_bwd,
                    "gather_rows": md.gather_rows_kernel,
                    "gather_mlp": md.gather_mlp_kernel}
    counters.update({"flash_attention_fwd": fa.flash_attention_fwd,
                     "flash_attention_bwd": fa.flash_attention_bwd})
    state, _ = step(state, data)                      # warm-up, untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, data)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    if args.model == "dit":
        extra["untraced_img_per_s"] = batch / untraced
        extra["mfu_untraced"] = (batch / untraced * extra["flops_per_image"]
                                 / 989e12)
    for c in counters.values():
        c.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, launches, ranges = _device_times(prof, ("optimizer",))
    busy = sum(by_class.values())
    tok = batch * seq
    print(json.dumps({
        "step": "ernie_finetune" if args.model == "ernie" else "dit_train",
        "ranges": ranges,
        "traced": True, "wall_ms": wall * 1e3,
        "untraced_wall_ms": untraced * 1e3, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3),
        "device_ms_by_class": by_class, "kernel_launches": launches,
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, **extra, "untraced_tokens_per_s": tok / untraced,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "loss": float(m["loss"])}), flush=True)
    _print_device(args, layers, batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
