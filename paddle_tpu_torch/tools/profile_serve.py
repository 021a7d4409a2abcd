"""Where a serving step's time goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.tools.profile_serve [--layers 32]
        [--kw '{"kv_dtype": "int8", "speculative": true, "spec_k": 4}']
        [--modes graphed,eager]

Builds a ContinuousBatcher at Llama-3-8B widths (random bf16 weights
from a seed) for each of `--modes`: "graphed", the default batcher,
whose steps replay CUDA graphs (captured by `warmup_prefill()` before
the first traced step, so no capture is timed), and "eager", its eager
twin (`_graphed=False`: the same steps launched one operation at a
time). Each is driven through its public `submit`/`step` in four steps,
each traced by torch.profiler:

  prefill+decode  7 prompts of 200-256 tokens arrive at an idle batcher:
                  one standalone cold prefill ([8, 256] rows, flash),
                  then a decode chunk of the 7 rows;
  decode7         a plain decode chunk (`chunk` single-token steps) of 7
                  rows;
  fused           a 300-token prompt arrives while 7 rows decode: one
                  forward over 8 decode rows padded to the 512 bucket
                  plus the prefill row, then chunk-1 decode steps;
  decode8         a plain decode chunk of 8 rows.

`--kw` passes batcher keyword arguments (JSON): with `weight_dtype` /
`kv_dtype` the steps run the quantized path, and with `speculative` each
decode step is a speculative tick (draft, verify, commit; ragged
attention's suffix option), the fused step staying a plain chunk.

For each traced step it prints one JSON line: the mode, the host wall
time (the step ends in its own device->host copy), the device time
summed by kernel class (GEMM, the port's two attention kernels,
everything else), the device busy time (the sum over kernels; one
stream, so they do not overlap), the idle share 1 - busy / wall, the
kernels that ran on the device and the host's launch calls (kernel
launches, graph launches and copies; a replayed step is one graph launch
plus the copies of its inputs). Each decode chunk is also run once
untraced just before, for its wall time without the profiler's
per-operation cost. The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

_GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "nvjet", "cublas")


# host-side runtime calls that put work on the device
_HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                  "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                  "cudaMemsetAsync")


def _kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "ragged_" in name:            # the split and the merge kernel
        return "ragged_paged_attention"
    if any(m in name for m in _GEMM_MARKS):
        return "gemm"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    return "other"


def _timed_step(cb, label: str, mode: str) -> dict:
    """One step untraced: its host wall time without the profiler's
    per-operation cost."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emitted, _ = cb.step()
    wall = time.perf_counter() - t0
    return {"mode": mode, "step": label, "traced": False,
            "wall_ms": wall * 1e3,
            "tokens": sum(len(t) for t in emitted.values())}


def _profile_step(cb, label: str, mode: str) -> dict:
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        emitted, _ = cb.step()
        wall = time.perf_counter() - t0
    by_class: dict = {}
    launches = host_calls = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            host_calls += ev.name in _HOST_LAUNCHES
            continue
        us = ev.time_range.end - ev.time_range.start
        c = _kernel_class(ev.name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        launches += c != "memcpy"
    if not by_class:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy = sum(by_class.values())
    return {"mode": mode, "step": label, "traced": True,
            "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_ms_by_class": by_class, "kernel_launches": launches,
            "host_launch_calls": host_calls,
            "tokens": sum(len(t) for t in emitted.values()),
            "active_rows": sum(cb.active)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kw", type=json.loads, default={},
                    help="ContinuousBatcher keyword arguments, as JSON")
    ap.add_argument("--modes", default="graphed,eager",
                    help="comma-separated: graphed (the default batcher, "
                    "warmed) and/or eager (its eager twin)")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if not set(modes) <= {"graphed", "eager"}:
        raise SystemExit(f"profile_serve: unknown mode in {args.modes!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..nlp import llama
    from ..nlp.paged import ContinuousBatcher

    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = llama.init_params(cfg, gen, device="cuda")
    for mode in modes:
        cb = ContinuousBatcher(params, cfg, max_batch=8, block_size=16,
                               max_total_len=1024, max_new_tokens=128,
                               max_prefill_bucket=512,
                               _graphed=mode == "graphed", **args.kw)
        t0 = time.perf_counter()
        graphs = cb.warmup_prefill() if mode == "graphed" else 0
        torch.cuda.synchronize()
        print(json.dumps({"mode": mode, "warmup_graphs": graphs,
                          "warmup_s": time.perf_counter() - t0}),
              flush=True)
        rng = np.random.RandomState(args.seed)

        def prompt(n):
            return rng.randint(1, cfg.vocab_size, n).tolist()

        cb.submit(prompt(64), max_new_tokens=2)    # warm-up, untraced
        cb.run()
        for n in rng.randint(200, 257, 7):
            cb.submit(prompt(int(n)))
        rows = [_profile_step(cb, "prefill+decode", mode),
                _timed_step(cb, "decode7", mode),
                _profile_step(cb, "decode7", mode)]
        cb.submit(prompt(300))
        rows.append(_profile_step(cb, "fused", mode))
        rows += [_timed_step(cb, "decode8", mode),
                 _profile_step(cb, "decode8", mode),
                 {"mode": mode, "captured_while_traced":
                  cb.compile_count - graphs}]
        for r in rows:
            print(json.dumps(r), flush=True)
        del cb
        gc.collect()              # the batcher's graphs close over it
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"layers": args.layers,
                      "chunk": args.kw.get("chunk", 8),
                      "kw": args.kw, "modes": modes,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
