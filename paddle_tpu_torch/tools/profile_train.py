"""Where a training step's time goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.tools.profile_train [--layers 11]

Builds the flagship training config (bench.py:120: D 4096, F 9472,
GQA 32/8, V 32000, bf16 params, 8-bit AdamW with the clip at 1.0, lr
1e-4; random weights from a seed; batch 8 x 2048) and drives
`train.make_train_step`:
one untraced warm-up step, one untraced step for its wall time without
the profiler's per-operation cost, then one step traced by
torch.profiler.

It prints one JSON line for the traced step: the host wall time (the
step ends in a synchronize), the device time summed by kernel class
(GEMM, flash forward, flash backward, RMSNorm, AdamW, other), the device
busy time (the sum over kernels; one stream, so they do not overlap),
the idle share 1 - busy / wall, the kernel launch count and the port's
own kernel launches by wrapper. The last line names the card and its
power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

# the flagship training batch (bench.py:369-370)
_BATCH, _SEQ = 8, 2048
_GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "nvjet", "cublas")
# kernel symbol names of csrc/*.cu, by class
_PORT_KERNELS = (("flash_fwd_kernel", "flash_fwd"),
                 ("dkdv_kernel", "flash_bwd"), ("dq_kernel", "flash_bwd"),
                 ("dcap_kernel", "flash_bwd"), ("rms_fwd_kernel", "rms"),
                 ("rms_bwd_kernel", "rms"), ("rms_dw_kernel", "rms"),
                 ("adamw_q_kernel", "adamw"))


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
    ap.add_argument("--layers", type=int, default=11)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..kernels import flash_attention as fa
    from ..kernels import rms_norm as rn
    from ..nlp import llama, train
    from ..optimizer import quant_state as qs

    cfg = llama.LlamaConfig.flagship_2b(num_hidden_layers=args.layers)
    tx = train.make_optimizer(1e-4, state_quant="8bit", grad_clip=1.0)
    state = train.init_state(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg, tx)
    step = train.make_train_step(cfg, tx)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (_BATCH, _SEQ))).cuda()
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
    for c in counters.values():
        c.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.end - ev.time_range.start
        c = _kernel_class(ev.name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        launches += c != "memcpy"
    if not by_class:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy = sum(by_class.values())
    tok = _BATCH * _SEQ
    print(json.dumps({
        "step": "train", "traced": True, "wall_ms": wall * 1e3,
        "untraced_wall_ms": untraced * 1e3, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall * 1e3),
        "device_ms_by_class": by_class, "kernel_launches": launches,
        "port_launches": {n: c.launches for n, c in counters.items()},
        "tokens": tok, "untraced_tokens_per_s": tok / untraced,
        "loss": float(m["loss"])}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"layers": args.layers, "batch": _BATCH, "seq": _SEQ,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
