"""Where a training step's time goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.tools.profile_train
        [--model llama|moe|long8k|train05b|eager_ernie|eager_llama
                 |eager_transformer|ernie|dit|resnet50]
        [--layers N] [--dtype bf16|f32]

`--model llama` (default) builds the flagship dense config (bench.py:120:
D 4096, F 9472, 11 layers, GQA 32/8, V 32000; batch 8 x 2048);
`--model moe` the single-chip MoE config (bench.py:98: D 2048, 12
layers, GQA 16/8, 16 experts top-2 of width 1024 plus a shared expert,
V 32000; batch 20 x 2048); `--model long8k` the flagship at 2 x 8192
(bench.py:381). All three: bf16 params, 8-bit AdamW with the clip at
1.0, lr 1e-4. `--model train05b` is bench.py:372-376's ~0.5B config
(D 2048, F 5632, 8 layers, GQA 16/8; batch 16 x 2048) with f32 params
and the tree adamw behind the clip. `--dtype f32` runs `llama` and `moe`
as chip_smoke.py's train_f32 and train_moe_f32 do: dtype = param_dtype =
f32 (the flash kernels' f32 option, GEMMs in full f32); llama at batch
16 x 2048 with the tree adamw (f32 moments) behind the clip, moe at its
batch with the 8-bit AdamW. Each: random weights from a seed,
full depth unless `--layers` cuts it; they drive
`train.make_train_step`. The eager models
drive their `train_step` under O1 bf16 with f32 params and AdamW with
the global clip: `--model eager_ernie` the ERNIE-3.0-base encoder
composed from layers (tools/eager_ernie.py; batch 64 x 512, lr 2e-5),
`--model eager_llama` the flagship-width Llama composed from layers
(tools/eager_llama.py; batch 2 x 2048, lr 1e-4); `--model
eager_transformer` the Transformer base model (tools/eager_transformer.py;
96 x 256 source and target tokens, Adam under NoamDecay(512, 4000), no
clip; `--layers` cuts both stacks), which also prints the 12 kernels
that take the most device time. `--model ernie` drives
the functional ERNIE finetune step over nlp/ernie.py
(tools/ernie_finetune.py: batch 64 x 512 padded to lengths 128-512,
adamw 2e-5); `--model dit` the DiT-XL/2 train step of BASELINE config 3
(tools/dit_train.py: batch 96 of 32x32x4 latents, 256 patch tokens,
adamw_q 1e-4, per-block recompute; `--layers` cuts the depth).
`--model resnet50` trains BASELINE config 0 on the eager API
(tools/resnet_train.py: resnet50 at 224x224, batch 256 of one seeded
batch on the card, Momentum 0.9 with weight decay 1e-4 under
PiecewiseDecay), once in f32 with TF32 convolutions and once under O1
bf16; its classes are the convolutions (cuDNN's fprop / dgrad / wgrad
kernels, the layout transforms around them and the cuBLAS GEMMs it runs
1x1 convolutions on; the classifier's GEMM, ~1.5 GFLOP a step, falls in
the same class), BatchNorm, the optimizer (the kernels inside its
"resnet_optimizer" range) and the elementwise rest (ReLU, the residual
adds, gradient accumulation, O1's casts), with the 12 kernels that take
the most device time; the backward's device time is the busy time less
the forward's and the optimizer's, since autograd launches it from its
own thread. Each
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
          "ernie": 64, "dit": 96, "long8k": 2, "train05b": 16,
          "resnet50": 256, "eager_transformer": 96}
_SEQ = {"llama": 2048, "moe": 2048, "eager_ernie": 512, "eager_llama": 2048,
        "ernie": 512, "dit": 256, "long8k": 8192, "train05b": 2048,
        "resnet50": 224, "eager_transformer": 256}
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
                 ("gather_mlp_kernel", "moe_dispatch"),
                 # flash_f32.cu's forward (demangled, mangled)
                 ("::fwd_kernel", "flash_fwd"), ("10fwd_kernel", "flash_fwd"))
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
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                    help="llama and moe: the compute and parameter dtype")
    args = ap.parse_args(argv)
    if args.dtype != "bf16" and args.model not in ("llama", "moe"):
        ap.error("--dtype f32 runs llama or moe")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.model in ("eager_ernie", "eager_llama", "eager_transformer"):
        return _main_eager(args)
    if args.model in ("ernie", "dit"):
        return _main_step(args)
    if args.model == "resnet50":
        return _main_resnet(args)
    from ..kernels import flash_attention as fa
    from ..kernels import moe_dispatch as md
    from ..kernels import rms_norm as rn
    from ..nlp import llama, moe, train
    from ..optimizer import quant_state as qs

    over = ({} if args.layers is None
            else {"num_hidden_layers": args.layers})
    f32 = args.dtype == "f32"
    if f32:
        over.update(dtype=torch.float32, param_dtype=torch.float32)
    if args.model == "moe":
        model, cfg = moe, moe.MoeConfig.flagship_moe(**over)
    elif args.model == "train05b":
        from .bench import cfg_05b
        model, cfg = llama, dataclasses.replace(cfg_05b(), **over)
    else:
        model, cfg = llama, llama.LlamaConfig.flagship_2b(
            max_position_embeddings=_SEQ[args.model], **over)
    batch = 16 if f32 and model is llama else _BATCH[args.model]
    tree = args.model == "train05b" or (f32 and model is llama)
    tx = train.make_optimizer(1e-4, state_quant=None if tree else "8bit",
                              grad_clip=1.0)
    state = train.init_state(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg, tx,
        model=model)
    step = train.make_train_step(cfg, tx, model=model)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (batch, _SEQ[args.model]))).cuda()

    def run(span):
        nonlocal state
        state, m = step(state, tokens)
        return m

    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "rms_norm_fwd": rn.rms_norm_fwd,
                "rms_norm_bwd": rn.rms_norm_bwd,
                "adamw_q": qs.fused_leaf_update}
    if model is moe:
        counters.update({"gather_wsum": md.gather_wsum,
                         "gather_scale_dot": md.gather_scale_dot})
    m, untraced, wall, prof = _profile_step(run, counters.values())
    by_class, launches, ranges = _device_times(prof, ("moe_routing",))
    routing_ms = ranges["moe_routing"]["device_ms"]
    if routing_ms:
        by_class["routing"] = routing_ms
        by_class["other"] = by_class.get("other", 0.0) - routing_ms
    tok = batch * _SEQ[args.model]
    print(json.dumps({
        "step": "train", "dtype": args.dtype, "batch": batch,
        **_summary(by_class, launches, wall, untraced),
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, "untraced_tokens_per_s": tok / untraced,
        "loss": float(m["loss"])}), flush=True)
    _print_device(args, cfg.num_hidden_layers, batch)
    return 0


def _profile_step(step, counters=()):
    """`step(span)` called untraced twice with span None (a warm-up,
    then once for its wall time without the profiler's per-operation
    cost), then once traced by torch.profiler with
    `span=torch.profiler.record_function`, after `counters`' launches
    and the peak memory were reset → (the traced call's result, the
    untraced and the traced call's seconds, the profile). Each call ends
    in a synchronize."""
    step(None)                                        # warm-up, untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(None)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step(torch.profiler.record_function)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, untraced, wall, prof


def _summary(by_class, launches, wall, untraced) -> dict:
    """The fields every traced step prints: wall times, the device busy
    time (the sum over kernels; one stream, so they do not overlap), the
    idle share 1 - busy / wall, the device ms by class, the launches."""
    busy = sum(by_class.values())
    return {"traced": True, "wall_ms": wall * 1e3,
            "untraced_wall_ms": untraced * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_ms_by_class": by_class, "kernel_launches": launches}


def _backward_rest(by_class, ranges, backward, others):
    """Autograd launches the backward from its own thread, outside the
    backward range's span on the device: its device time is the busy
    time less the other ranges'."""
    ranges[backward]["device_ms"] = sum(by_class.values()) - sum(
        ranges[n]["device_ms"] for n in others)


def _device_times(prof, range_names, classify=_kernel_class, relabel=None,
                  by_name=None):
    """(device ms by kernel class, kernel launches, {range: {device_ms,
    host_ms}}) of a traced step. `classify` names a kernel's class from
    its symbol. A range's device time is the sum of the kernels that
    start inside its span on the device (the profiler's user annotation
    of the range there: from its first kernel's start to its last
    kernel's end; one stream, so no other range's kernels run inside
    it). `relabel`, a (range, class, new class) triple, moves the
    kernels of that class that start inside the range into the new
    class. `by_name`, when given, gathers the device ms by kernel."""
    ranges = {n: {"device_ms": 0.0, "host_ms": 0.0} for n in range_names}
    spans = {n: [] for n in range_names + ((relabel[0],) if relabel
                                           else ())}
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
        start = ev.time_range.start
        kernels.append((start, (ev.time_range.end - start) / 1e3,
                        classify(ev.name), ev.name))
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")

    def inside(start, name):
        return any(a <= start < b for a, b in spans[name])

    by_class: dict = {}
    launches = 0
    for start, ms, c, name in kernels:
        if relabel and c == relabel[1] and inside(start, relabel[0]):
            c = relabel[2]
        by_class[c] = by_class.get(c, 0.0) + ms
        launches += c != "memcpy"
        if by_name is not None:
            by_name[name] = by_name.get(name, 0.0) + ms
    for name in range_names:
        ranges[name]["device_ms"] = sum(
            ms for start, ms, _, _ in kernels if inside(start, name))
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
    """The eager steps (`--model eager_ernie`, `eager_llama` or
    `eager_transformer`)."""
    import paddle_tpu_torch as paddle
    from ..kernels import flash_attention as fa
    from ..kernels import layer_norm as ln
    from ..kernels import rms_norm as rn
    from ..nlp import ernie, llama
    from . import eager_ernie, eager_llama, eager_transformer as et

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
    elif args.model == "eager_llama":
        cfg = llama.LlamaConfig.flagship_2b(**over)
        model, lr = eager_llama.build_model(paddle, cfg), 1e-4
        tokens = paddle.to_tensor(rng.integers(0, cfg.vocab_size,
                                               (batch, seq)))

        def run(opt, span):
            return eager_llama.train_step(paddle, model, loss_fn, opt,
                                          tokens, span=span)
    else:
        cfg = et.TransformerConfig.base(**(
            {} if args.layers is None else
            {"num_encoder_layers": args.layers,
             "num_decoder_layers": args.layers}))
        model = et.build_model(paddle, cfg)
        src = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
        tgt = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        tin, tout = paddle.to_tensor(tgt[:, :-1]), paddle.to_tensor(
            tgt[:, 1:])

        def run(opt, span):
            return et.train_step(paddle, model, cfg, opt, src, tin, tout,
                                 span=span)
    if args.model == "eager_transformer":
        opt = et.make_optimizer(paddle, model, cfg)
    else:
        opt = paddle.optimizer.AdamW(
            learning_rate=lr, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    counters = {"layer_norm_fwd": ln.layer_norm_fwd,
                "layer_norm_bwd": ln.layer_norm_bwd,
                "rms_norm_fused": rn.rms_norm_fused,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd}
    loss, untraced, wall, prof = _profile_step(
        lambda span: run(opt, span), counters.values())
    by_name: dict = {}
    by_class, launches, ranges = _device_times(prof, _EAGER_RANGES,
                                               by_name=by_name)
    _backward_rest(by_class, ranges, "eager_backward",
                   ("eager_forward", "eager_optimizer"))
    tok = batch * seq
    top = {}
    if args.model == "eager_transformer":
        top = {"top_kernels_ms": dict(sorted(
            by_name.items(), key=lambda kv: -kv[1])[:12])}
    print(json.dumps({
        "step": "eager_train", **_summary(by_class, launches, wall, untraced),
        "ranges": ranges, **top,
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, "untraced_tokens_per_s": tok / untraced,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "loss": float(loss)}), flush=True)
    _print_device(args, getattr(cfg, "num_hidden_layers", None)
                  or cfg.num_encoder_layers, batch)
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

    def run(span):
        nonlocal state
        state, m = step(state, data)
        return m

    m, untraced, wall, prof = _profile_step(run, counters.values())
    if args.model == "dit":
        extra["untraced_img_per_s"] = batch / untraced
        extra["mfu_untraced"] = (batch / untraced * extra["flops_per_image"]
                                 / 989e12)
    by_class, launches, ranges = _device_times(prof, ("optimizer",))
    tok = batch * seq
    print(json.dumps({
        "step": "ernie_finetune" if args.model == "ernie" else "dit_train",
        "ranges": ranges, **_summary(by_class, launches, wall, untraced),
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, **extra, "untraced_tokens_per_s": tok / untraced,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "loss": float(m["loss"])}), flush=True)
    _print_device(args, layers, batch)
    return 0


# cuDNN's convolution kernels (implicit-GEMM fprop, dgrad and wgrad, and
# the layout transforms around them) and the BatchNorm kernels, by name
_CONV_MARKS = ("fprop", "dgrad", "wgrad", "conv", "Conv", "implicit",
               "nchwToNhwc", "nhwcToNchw")
_BN_MARKS = ("bn_fw", "bn_bw", "batch_norm", "BatchNorm", "batchnorm")
_RESNET_RANGES = ("resnet_forward", "resnet_backward", "resnet_optimizer")


def _resnet_class(name: str) -> str:
    if any(m in name for m in _BN_MARKS):
        return "bn"
    if any(m in name for m in _CONV_MARKS + _GEMM_MARKS):
        return "conv"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    return "elementwise"


def _main_resnet(args) -> int:
    """BASELINE config 0's step on the eager API, f32 (TF32) and O1."""
    import paddle_tpu_torch as paddle
    from . import resnet_train as rt

    batch, size = _BATCH["resnet50"], _SEQ["resnet50"]
    paddle.set_device("gpu")
    for name, amp in (("f32_tf32", None), ("o1_bf16", "bfloat16")):
        torch.backends.cuda.matmul.allow_tf32 = amp is None
        torch.backends.cudnn.allow_tf32 = amp is None
        paddle.seed(args.seed)
        model, opt, sched = rt.build(paddle, 50, batch=batch)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        x = paddle.to_tensor(torch.randn(batch, 3, size, size,
                                         device="cuda", generator=gen))
        y = paddle.to_tensor(torch.randint(0, 1000, (batch,),
                                           device="cuda", generator=gen))
        loss, untraced, wall, prof = _profile_step(
            lambda span: rt.train_step(paddle, model, opt, sched, x, y, amp,
                                       span=span))
        top: dict = {}
        by_class, launches, ranges = _device_times(
            prof, _RESNET_RANGES, classify=_resnet_class,
            relabel=("resnet_optimizer", "elementwise", "optimizer"),
            by_name=top)
        _backward_rest(by_class, ranges, "resnet_backward",
                       ("resnet_forward", "resnet_optimizer"))
        print(json.dumps({
            "step": f"resnet50_{name}",
            **_summary(by_class, launches, wall, untraced),
            "ranges": ranges,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                   [:12]),
            "images": batch, "untraced_images_per_s": batch / untraced,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "loss": float(loss)}), flush=True)
        del model, opt, sched, x, y
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _print_device(args, 50, batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
