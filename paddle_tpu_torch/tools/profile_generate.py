"""Where a dense-cache decode step's time goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.tools.profile_generate [--batch 8] [--w8]

bench.py's `run_decode` shape (:270): the flagship 2B (bench.py:120,
random bf16 weights from a seed), a prompt of 512 tokens, 128 new
tokens, greedy, through `generation.make_generate`; `--w8` decodes from
`quantize_for_serving(bits=8)`'s tree. After one untraced call (whose
decode captures the step in a CUDA graph) it times a call's pieces: the
prefill (host clock around a synchronize), the decode loop as
`generate` runs it (127 replays and one synchronize, host clock), and
the same replays between two CUDA events (device time a step). Then one
decode step runs eagerly under torch.profiler: the kernels the graph
replays, summed by ATen op (self device time, the largest first) and by
kernel class (GEMM, the port's kernels, other), with the kernel count
and the busy time of a step; `replay_gap_share` is the share of a
replayed step's device time that no kernel of the eager step covers.
One JSON line, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .profile_train import _device_times

PROMPT, NEW = 512, 128
TOP_OPS = 12


def _self_device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--w8", action="store_true",
                    help="decode from quantize_for_serving(bits=8)'s tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..nlp import generation, llama

    cfg = llama.LlamaConfig.flagship_2b(max_position_embeddings=PROMPT + NEW)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    if args.w8:
        params = generation.quantize_for_serving(params, bits=8)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, PROMPT))).cuda()
    gen = generation.make_generate(params, cfg, args.batch, PROMPT, NEW)
    gen(prompt)                          # warm-up: the capture, untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen.prefill(prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gen.decode()                         # the replays and one synchronize
    decode_ms = (time.perf_counter() - t0) * 1e3
    gen.prefill(prompt)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(NEW - 1):
        gen.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / (NEW - 1)

    gen.prefill(prompt)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gen._step()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
    by_class, launches, _ = _device_times(prof, ())
    ops = sorted(((e.key, _self_device_ms(e), e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::") and _self_device_ms(e) > 0),
                 key=lambda t: -t[1])
    busy = sum(by_class.values())
    print(json.dumps({
        "step": "decode", "batch": args.batch, "w8": args.w8,
        "prompt": PROMPT, "new_tokens": NEW,
        "layers": cfg.num_hidden_layers, "prefill_ms": prefill_ms,
        "decode_wall_ms": decode_ms,
        "decode_wall_ms_per_step": decode_ms / (NEW - 1),
        "graph_replay_device_ms_per_step": replay_ms,
        "eager_step_wall_ms": eager_ms, "eager_step_busy_ms": busy,
        "replay_gap_share": 1.0 - busy / replay_ms,
        "kernels_per_step": launches, "device_ms_by_class": by_class,
        "top_ops_self_device_ms": [
            {"op": k, "ms": ms, "calls": n} for k, ms, n in ops[:TOP_OPS]],
        "tokens_per_s_decode": args.batch * (NEW - 1) / decode_ms * 1e3,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
