"""Run the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. device  — requires CUDA; prints the card, its compute capability and
               `nvidia-smi`'s name and power limit; turns TF32 off.
  2. build   — compiles every kernel under paddle_tpu_torch/csrc with nvcc
               (one process per source, in parallel) and times it; counts
               the HGMMA (wgmma) and UTMALDG (TMA load) instructions
               `cuobjdump -sass` finds in the flash and gather-MLP
               libraries (the latter's LDGSTS and UTMASTG too) and the
               LDGSTS (cp.async) ones in the ragged and the three norm
               libraries, and fails where one is missing.
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card, in bf16, at its main paths' shapes, against a stated
               tolerance, with times (CUDA events) of the kernel, the
               plain version and, where one exists, a single PyTorch call
               computing the same function, and the bound (the larger of
               bytes over the card's memory rate and operations over its
               peak rate): the flash forward (serving shapes, and the
               training steps' B=8 x S=2048 and B=20 x S=2048 (the MoE
               model's GQA 16/8) with its LSE), ragged paged attention,
               the flash backward at both training shapes and at
               B=1 x S=4096, both flash kernels at S=8192 (B=1, H=8,
               KV=2: the length at which the JAX package streams its
               backward), each flash case with its time over the library
               call's and its bound's share of its time, ragged paged
               attention also at full 1024-key chains of 8 and 32 decode
               rows, each of its shapes twice (bit-identical) and also
               timed in one CUDA graph (device time), the RMSNorm
               forward (its graph time too, and F.rms_norm's) and
               backward (its graph time too, the one ATen backward's
               beside it, and the kernels one call launches: the walk
               and the fold, no cast of the bf16 weight) at the steps'
               [16384, 4096] and [40960, 2048], the fused 8-bit
               AdamW on a leaf of every size of both trained trees, and
               the MoE dispatch kernels (gather_wsum, gather_scale_dot)
               at the MoE step's shapes, with the index maps of one real
               routing of random gate logits at B=20 x S=2048.
  4. serve   — a ServingEngine at Llama-3-8B widths (all 32 layers,
               random bf16 weights from a seeded generator) with the JAX
               engine's defaults (prefix cache, trace, SLOs) captures
               every step shape as a CUDA graph in `warmup()` (85 at
               this sizing; its seconds and the graph pool's memory are
               reported), then answers 12 streamed requests with prompts
               of 16-700 tokens, admissions landing mid-decode, every
               step a graph replay. Kernel launch counters (which the
               replays keep true) are zeroed just before and read just
               after; both kernels must have run, `compile_count` must
               not move, a fused prefill+decode step must have happened
               and the KV pool must drain. The graph check: the warmed
               batcher and its eager twin serve the same prompts and
               must give identical tokens (decode-only chunk walls side
               by side), and the decode graph replayed on stale slot
               state (the planted control) must not. Then one fixed
               batch (cold prefill, continuing chunk, decode) runs
               through the kernels, their plain versions, the plain
               versions with a planted off-by-one fault, and an f32
               evaluation: the kernels' logits may be no further from
               f32 than the plain bf16 path's (within a stated ratio),
               and the fault must fail that same bound.
  4a. serve_prefix — 8 requests sharing a 384-token prefix (own suffixes
               of 16-128 tokens) through a warmed engine with the prefix
               cache on and then off: hit tokens > 0, TTFTs warm and
               cold, the token match rate warm against cold, the pool
               drained; then a whole-prompt copy-on-write hit over the
               int8 pool (383 tokens served from the cache).
  4b. serve_quant_spec — int8 weights and KV, speculation over int8 KV
               and a tree from an int8 draft, each beside its plain
               twin, step shapes captured lazily.
  5. train   — the JAX package's flagship single-chip training config
               (bench.py:120: ~2.1B params, D 4096, F 9472, 11 layers,
               GQA 32/8, V 32000, bf16 params, 8-bit AdamW with the
               streamed clip at 1.0, lr 1e-4) takes 2 warm-up and 4 timed
               steps of batch 8 x 2048 through `train.make_train_step`.
               Launch counters are zeroed before and read after; every
               training kernel must have run, every loss and grad norm be
               finite and the last loss below the first. Then one loss +
               backward at full width and 2 layers runs through the
               kernels, their plain versions, the plain versions with a
               planted fault (the backward's dcap dropped) and an f32
               evaluation: per gradient group, the kernels may be no
               further from f32 than the plain bf16 path (within a
               stated ratio), and the fault must fail that bound.
  6. train_moe — the JAX package's single-chip MoE config (bench.py:98:
               ~1.57B params, D 2048, 12 layers, GQA 16/8, 16 experts
               top-2 of width 1024 plus a shared expert, capacity factor
               1.25, V 32000, bf16 params, the same optimizer) takes 2
               warm-up and 4 timed steps of batch 20 x 2048 through
               `train.make_train_step(model=moe)`. Every kernel must have
               launched exactly as often as the step implies, losses be
               finite and fall. Then the gradient check of phase 5 at 2
               layers, with the dispatch backward dropping each token's
               second choice as the planted fault, and the routing of each
               bf16 path counted against the f32 evaluation's.

  7. eager   — the Paddle-shaped eager API's training path: an
               ERNIE-3.0-base encoder (BASELINE config 1: V 40000, D 768,
               12 layers, 12 heads of 64, F 3072) composed from paddle.nn
               and paddle.incubate.nn layers (tools/eager_ernie.py), f32
               params under O1 bf16 auto_cast, AdamW lr 2e-5 with the
               global-norm clip, 2 warm-up and 4 timed steps of batch
               64 x 512 (bench.py:134-181). LayerNorm forward and backward
               must launch exactly 25 times a step, the non-causal flash
               forward and backward 12; losses finite and falling. Then
               the gradient check at 2 layers, batch 4 x 512, dropout 0,
               with the LayerNorm backward dropping x̂·mean(dyw·x̂) as the
               planted fault.

  8. eager_llama — a Llama at the flagship widths and depth (bench.py:120:
               V 32000, D 4096, F 9472, 11 layers, GQA 32/8) composed from
               the eager API's layers (tools/eager_llama.py: FusedRMSNorm,
               the fused RoPE, F.flash_attention, swiglu), f32 params
               under O1 bf16, AdamW lr 1e-4 with the global clip, 2
               warm-up and 4 timed steps of batch 2 x 2048. The row-6
               RMSNorm must launch exactly 23 times a step, the causal
               flash forward and backward 11; losses falling, peak memory
               under 80 GB. Then the gradient check at 2 layers, batch
               1 x 2048, with the row-6 norm reading its weight one column
               off as the planted fault.
  9. ernie   — ERNIE-3.0-base through nlp/ernie.py with bench.py:134-181's
               finetune step (tools/ernie_finetune.py: adamw 2e-5 over the
               functional tree, bf16 compute), batch 64 x 512 padded to
               lengths 128-512 under a [B, S] attention mask: 2 warm-up
               and 4 timed steps; the key-masked head-major flash forward
               and backward exactly 12 a step, no LayerNorm kernel. Then
               the gradient check at 2 layers, batch 4 x 512, with the
               flash backward's plain version dropping the key mask as
               the planted fault.

  10. generate — bench.py's serving runs through nlp/generation.py at the
               flagship 2B widths (random bf16 weights), by
               tools/bench.py's protocol: the prefill of an 8192-token
               prompt (bench.py:236, exactly 11 flash launches a
               prefill), greedy decode of 128 tokens after 512 at batch
               8 from the bf16 tree and from quantize_for_serving(bits=8)'s
               and at batch 32 from the w8 tree (bench.py:270, :389-393),
               the decode step replayed from one CUDA graph. Checks: the
               graph-replayed tokens equal the eager step's (batch 8, 16
               tokens; 11 flash launches in the prefill, none decoding);
               a sampled decode through the graph repeats from one seed;
               the w8 logits within 5e-2 of the bf16 tree's (max |diff|
               over max |logit|) at the JAX test's tiny config, and at
               the flagship widths no further from them than a twin of
               the int8 rounding (noise of the same size) is, a planted
               scale fault outside that bound; the
               flash prefill's logits at 2 layers no further from an f32
               evaluation than the use_flash=False bf16 path's (within
               the serve phase's ratio), a planted off-by-one outside it.
  11. long8k — bench.py:381: the flagship 2B at 2 x 8192, 8-bit AdamW,
               clip 1.0, 2 warm-up and 4 timed steps; launches exactly as
               the step implies (the flash backward above S 2048, where
               the JAX package streams, rows 2-4); losses falling.
  12. layer8b — bench.py:308: one Llama-3-8B layer, batch 1, S 4096 and
               8192, 1 warm-up and 8 timed gradients of sum(y.float()**2)
               through tools/bench.run_8b_layer; MFU by bench.py:344-346.
  13. train05b — bench.py:372-376: the ~0.5B config with f32 params and
               the tree adamw (f32 moments) behind the clip, 16 x 2048,
               2 warm-up and 4 timed steps; no 8-bit AdamW launch.

The kernels phase also holds the fused LayerNorm forward and backward at
the eager step's f32 [32768, 768] and in bf16, the flash forward and
backward non-causal at B=64 S=512 H=12 hd=64 and causal at the eager
Llama's B=2 x 2048, the row-6 RMSNorm at f32 [4096, 4096], bf16
[16384, 4096], D 776 and affine-free, and the key-masked flash in
'bhsd' at the ERNIE step's lengths, in 'bshd', unmasked, with a batch
row that sees no key and at an unaligned length (500); the flash
forward and backward at DiT-XL/2's B=96 S=256 H=16 hd=72 non-causal
'bhsd'; and the four kernels no path launches, at the shapes of the
workloads they were written for: the fused adaLN forward and backward
(rows 11-12) at DiT-XL/2's [96, 256, 1152] bf16 and at f32 [4, 100,
776], the masked row gather (row 13) at the MoE step's combine maps, and
the gather fused into the expert gate/up products (row 16) at its
T 40960, E 16, M 6400, D 2048, F 1024; and the shapes of phases 10-13:
the flash forward at B=1 S=8192 H=32 KV=8 (the prefill), the forward
and backward at B=2 S=8192 (long8k), B=1 S=4096 and 8192 (the 8B
layer) and B=16 S=2048 H=16 KV=8 (the 0.5B; plain versions at S=8192
one KV head's group at a time), the RMSNorm pair at [8192, 4096],
[4096, 4096] and [32768, 2048] with an f32 weight. The kernels line
lists all 18 pallas_call rows of the JAX package, each kernel's times
and launches by path; the flash backward's launches also by the JAX
package's rows (2-4 above S 2048, 5 at or below).

The last lines are the kernels JSON object, the `nvidia-smi` name/power
line and {"ok": true, "device": {...}}. Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
# NVIDIA's H100 SXM data sheet, at the full 700 W power limit: dense bf16
# tensor-core FLOP/s, HBM bytes/s, and f32 FLOP/s outside the tensor cores
_H100_SXM_PEAKS = (989e12, 3.35e12, 67e12)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _peaks(name: str):
    """The peak rates of the card variant `name` names. Only the H100
    SXM's are held here; the PCIe and NVL parts differ, so another card
    stops the run rather than be held to the wrong bound."""
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        raise SystemExit(f"chip_smoke: no peak rates for {name!r} "
                         f"(the bounds are held for the H100 SXM only)")
    return "H100 SXM", _H100_SXM_PEAKS


# ------------------------------------------------------------- 1. device
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs the port on an NVIDIA GPU")
    # outside a checkout of the repo this fails before anything prints
    import paddle_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = _smi_line()
    variant, (flops, bw, f32_flops) = _peaks(name)
    info = {"phase": "device", "kind": name,
            "capability": list(torch.cuda.get_device_capability(0)),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "peak_variant": variant, "peak_bf16_flops": flops,
            "peak_bytes_per_s": bw, "peak_f32_flops": f32_flops, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    _emit(info)
    return info


# -------------------------------------------------------------- 2. build
def phase_build():
    from paddle_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    sass = _sass_counts(_build)
    _emit({"phase": "build", "seconds": round(secs, 3),
           "sources": _build.sources(), "ptxas": ptxas, "sass": sass})


# the flash libraries and gather_mlp must hold Hopper's warpgroup
# products (HGMMA) and TMA loads (UTMALDG); gather_mlp also its gathered
# rows' cp.async copies (LDGSTS) and xin's TMA stores (UTMASTG); the
# ragged library and the three norm libraries (the backward walks' rings)
# their cp.async copies (LDGSTS)
_SASS_MARKS = {"flash_fwd": ("HGMMA", "UTMALDG"),
               "flash_bwd": ("HGMMA", "UTMALDG"),
               "gather_mlp": ("HGMMA", "UTMALDG", "LDGSTS", "UTMASTG"),
               "ragged_paged_attention": ("LDGSTS",),
               "rms_norm": ("LDGSTS",), "layer_norm": ("LDGSTS",),
               "adaln": ("LDGSTS",)}


def _sass_counts(_build):
    """How many of each instruction in _SASS_MARKS `cuobjdump -sass` finds
    in each library named there; raises where one is missing."""
    counts = {}
    for name, marks in _SASS_MARKS.items():
        sass = subprocess.run(
            [_build.cuobjdump(), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {m: sass.count(m) for m in marks}
        if not all(counts[name].values()):
            raise AssertionError(f"{name}: no {counts[name]} in its SASS")
    return counts


# ------------------------------------------------------------ 3. kernels
def _time_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of fn() over `iters` runs (CUDA events), after
    one warm-up run. With `flush`, it runs before every timed call,
    outside the timed span, so each call finds the L2 cache cold."""
    fn()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _rel_err(out, ref, valid=None, floor: float = 0.0) -> float:
    """The largest error of one query head's output vector relative to
    that vector's own scale: max over (query, head) of
    max_d |out - ref| / max_d |ref|, over the valid queries. With
    `floor`, a vector whose scale is below `floor` times the largest
    vector's is held relative to that: gradients have rows that cancel
    to ~0 (dq of query 0, whose softmax has one key), where any two
    summation orders differ by 100 % of nothing."""
    d = (out.float() - ref.float()).abs().amax(-1)
    r = ref.float().abs().amax(-1)
    if valid is not None:
        d, r = d[valid], r[valid]
    if floor:
        r = torch.clamp(r, min=floor * r.max().item())
    return (d / r).max().item()


def _bound(flops, nbytes, peaks, flops_peak=None):
    t_ops = flops / (flops_peak or peaks[0]) * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _shares(res):
    """A flash case with its time over the library call's and its
    bound's share of its time."""
    res["ms_over_library"] = res["ms"] / res["library_ms"]
    res["bound_over_ms"] = res["bound_ms"] / res["ms"]
    return res


def _qkv(B, S, hd, gen, layout="bshd", heads=()):
    """Random bf16 [B, S, n, hd] for each n of `heads`, contiguous in
    `layout` ('bhsd': [B, n, S, hd])."""
    t = [torch.randn(B, S, n, hd, device="cuda", generator=gen).bfloat16()
         for n in heads]
    if layout == "bhsd":
        t = [x.transpose(1, 2).contiguous() for x in t]
    return t


def _fwd_ref_by_kv_head(q, k, v, **kw):
    """The flash forward's plain version ('bshd') over one KV head and its
    query heads at a time, concatenated over the heads: the same
    function, with f32 scores of one group at a time (at B=2 S=8192
    H=32 all heads' scores take 17 GB a tensor)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    KV = k.shape[2]
    rep = q.shape[2] // KV
    outs = [fa.flash_attention_fwd_ref(q[:, :, g * rep:(g + 1) * rep],
                                       k[:, :, g:g + 1], v[:, :, g:g + 1],
                                       **kw) for g in range(KV)]
    if kw.get("return_lse"):
        return (torch.cat([o for o, _ in outs], 2),
                torch.cat([lse for _, lse in outs], 1))
    return torch.cat(outs, 2)


def _bwd_ref_by_kv_head(q, k, v, out, lse, dout, **kw):
    """The flash backward's plain version ('bshd') one KV head's group at
    a time, as `_fwd_ref_by_kv_head`: dk and dv of a KV head depend on
    its own query heads only."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    KV = k.shape[2]
    rep = q.shape[2] // KV
    grads = []
    for g in range(KV):
        h = slice(g * rep, (g + 1) * rep)
        grads.append(fa.flash_attention_bwd_ref(
            q[:, :, h], k[:, :, g:g + 1], v[:, :, g:g + 1], out[:, :, h],
            lse[:, h], dout[:, :, h], **kw))
    return tuple(torch.cat(x, 2) for x in zip(*grads))


def _flash_case(B, S, H, KV, hd, peaks, tol, gen, lse: bool = False,
                causal: bool = True, layout: str = "bshd",
                by_kv_head: bool = False):
    """The flash forward against its plain version at one shape; with
    `lse`, as the training forward calls it, its LSE held too; with
    `by_kv_head`, the plain version one KV head's group at a time."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v = _qkv(B, S, hd, gen, layout, (H, KV, KV))
    kw = dict(causal=causal, return_lse=lse, layout=layout)
    plain_fn = _fwd_ref_by_kv_head if by_kv_head \
        else fa.flash_attention_fwd_ref
    out = fa.flash_attention_fwd(q, k, v, **kw)
    ref = plain_fn(q, k, v, **kw)
    res = {"shape": f"B={B} S={S} H={H} KV={KV} hd={hd}"
                    + (" (LSE)" if lse else "")
                    + ("" if causal else " non-causal")
                    + ("" if layout == "bshd" else f" {layout}")}
    if lse:
        (out, lse_k), (ref, lse_r) = out, ref
        res["lse_abs_err"] = (lse_k - lse_r).abs().max().item()
        if not res["lse_abs_err"] <= LSE_TOL:
            raise AssertionError(f"flash B={B} S={S}: lse err "
                                 f"{res['lse_abs_err']} > {LSE_TOL}")
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref)
    if not rel <= tol:
        raise AssertionError(f"flash B={B} S={S}: relative err {rel} > {tol}")
    qt, kt, vt = (x if layout == "bhsd" else x.transpose(1, 2)
                  for x in (q, k, v))
    del ref
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), 50)
    plain = _time_ms(lambda: plain_fn(q, k, v, **kw), 2 if by_kv_head else 5)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 50)
    pairs = S * (S + 1) // 2 if causal else S * S       # Sq == Sk
    flops = 4.0 * B * H * hd * pairs
    # q, k, v in; out (and the f32 LSE) written
    nbytes = 2.0 * B * S * hd * (2 * H + 2 * KV) + (4.0 * B * H * S * lse)
    res.update({"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": plain, "library_ms": lib,
                **_bound(flops, nbytes, peaks)})
    return _shares(res)


def _ragged_case(kind, H, KV, hd, gen, flush):
    """Row 18 at one of bench_kernels' held batches (decode, fused,
    continue, full8, full32) against its plain version, twice: within
    KERNEL_TOL (bench_kernels.TOL, the same 2e-2), invalid queries zero
    and the two outputs bit-identical; timed with the host in the loop
    and in one CUDA graph (`graph_ms`, device time, over pool copies
    that exceed the L2), beside the plain version's time."""
    from paddle_tpu_torch.nlp import ragged_attention as ra
    from paddle_tpu_torch.tools import bench_kernels as bk
    bs, M = 16, 64
    args, (pos, val) = bk.ragged_batch(kind, H, KV, hd, bs, M, gen, SEED)
    R, P = pos.shape
    live = np.where(val, pos + 1, 0).max(axis=1)
    res = bk.ragged_case(args, pos, val,
                         f"{kind} R={R} P={P} H={H} KV={KV} hd={hd} "
                         f"bs={bs} M={M} live={live.tolist()}", flush=flush)
    if not res["ok"]:
        raise AssertionError(f"ragged {kind}: {res}")
    res["plain_ms"] = _time_ms(
        lambda: ra.ragged_paged_attention_ref(*args), 5, flush)
    res["library_ms"] = None
    return res


def _ragged_option_case(kind, H, KV, hd, gen, flush):
    """Row 18's int8 option ("int8 <batch>", a `_ragged_case` batch over
    int8 twins of its pools) or its suffix option (a `bench_kernels`
    SPEC_KINDS shape: chain verify, tree verify, draft step) against the
    plain version as `_ragged_case` holds it (KERNEL_TOL, invalid queries
    zero, bit-identical twice, host and CUDA-graph times, the bound from
    this data's live bytes), plus a planted control that must read above
    KERNEL_TOL: the kernel run with each block's scales taken from the
    block before (int8; the bf16 pools are drawn with per-block
    magnitudes 1/4 to 4, as real K/V vary) or with the slab visibility
    shifted by one row (suffix), held to the sound plain version."""
    from paddle_tpu_torch.nlp import ragged_attention as ra
    from paddle_tpu_torch.tools import bench_kernels as bk
    bs, M = 16, 64
    if kind.startswith("int8 "):
        args, (pos, val) = bk.ragged_batch(kind[5:], H, KV, hd, bs, M, gen,
                                           SEED)
        N = args[1].shape[0]
        f = torch.exp2(torch.rand(N, device="cuda", generator=gen) * 4 - 2)
        kc, vc, opts = bk.quantize_pools(
            (args[1].float() * f[:, None, None, None]).bfloat16(),
            (args[2].float() * f[:, None, None, None]).bfloat16())
        args = (args[0], kc, vc, *args[3:])
        bad = {"k_scale": opts["k_scale"].roll(1),
               "v_scale": opts["v_scale"].roll(1)}
        control = "each block's scales from the block before"
    else:
        args, (pos, val), opts = bk.ragged_spec_batch(kind, H, KV, hd, bs, M,
                                                      gen, SEED)
        bad = dict(opts, suffix_vis=opts["suffix_vis"].roll(1, dims=-1)
                   .contiguous())
        control = "the slab visibility shifted by one row"
    R, P = pos.shape
    live = np.where(val, pos + 1, 0).max(axis=1)
    slab = "" if "suffix_k" not in opts else \
        f" S={opts['suffix_k'].shape[1]}"
    res = bk.ragged_case(args, pos, val,
                         f"{kind} R={R} P={P}{slab} H={H} KV={KV} hd={hd} "
                         f"bs={bs} M={M} live={live.tolist()}", flush=flush,
                         opts=opts)
    if not res["ok"]:
        raise AssertionError(f"ragged {kind}: {res}")
    ref = ra.ragged_paged_attention_ref(*args, **opts)
    res["control"] = control
    res["control_rel_err"] = _rel_err(
        ra.ragged_paged_attention(*args, **{**opts, **bad}), ref,
        args[5][:, :, None] & (ref.float().abs().amax(-1) > 0))
    if not res["control_rel_err"] > KERNEL_TOL:
        raise AssertionError(f"ragged {kind}: the planted control ({control})"
                             f" reads {res['control_rel_err']}, within "
                             f"{KERNEL_TOL}: the check cannot see it")
    res["plain_ms"] = _time_ms(
        lambda: ra.ragged_paged_attention_ref(*args, **opts), 5, flush)
    res["library_ms"] = None
    del ref, args, opts, bad
    torch.cuda.empty_cache()
    return res


# bf16 tolerance of a kernel against its plain version, relative to the
# scale of each query head's output vector (`_rel_err`). Both versions
# compute in f32 and round the output to bf16; two roundings of nearly
# equal values can land one bf16 ulp apart, at most 2^-7 = 0.0078 of the
# vector's largest element. The kernel also rounds the probabilities to
# bf16 before P.V (2^-9 relative per weight, averaging out over the keys)
# and rescales online in f32. 2e-2 is 2.5 such ulps. A fault is far
# larger: dropping one 16-key block of a 1024-key chain moves a head's
# output by about 0.13 of its scale, a one-key mask shift in a 64-key
# row by about 0.1. The same bound holds the flash backward's dq, dk and
# dv per (position, head) (the kernel rounds P and dS to bf16 as operands
# of its second products, as the forward rounds P) and the RMSNorm
# outputs per row.
KERNEL_TOL = 2e-2
# The LSE is f32 in both versions: a sum of ~S exp terms in another order
# (and exp2 of log2-scaled scores in the kernel) moves a value near
# log(2048) + 1 ~ 8.6 by ~1e-5; 5e-4 leaves a margin of 50x.
LSE_TOL = 5e-4
# Gradient rows below a thousandth of the largest row's scale are held
# relative to that thousandth (`_rel_err`'s floor).
GRAD_ROW_FLOOR = 1e-3
# rstd is one f32 rsqrt of a 4096-term f32 sum per row: ~1e-6 relative.
RSTD_TOL = 1e-5
# The f32 LayerNorm: kernel and plain version compute the same f32
# expressions and differ in summation order over a 768-value row (on an
# H100 SXM at 700 W out and dx read <= 1e-6 of their rows' scale, mu and
# rstd <= 3e-7); 1e-5 leaves 10x. dw and db: sums over 32,768 rows in
# another order (1024 chunks, then in order; read <= 1.1e-6), 1e-4 of the
# largest |value|.
LN_F32_TOL = 1e-5
LN_STAT_TOL = 1e-5
LN_SUM_TOL = 1e-4
# The f32 row-6 RMSNorm: the kernel and the plain version compute the same
# f32 expressions, differing in the order of a row's sum of squares (and
# rsqrtf against torch's rsqrt, ~2 ulps): ~1e-7 of the row's scale; 1e-5
# leaves a wide margin while a wrong element or weight column reads ~1e-1.
RMS_F32_TOL = 1e-5
# 8-bit AdamW: params within one bf16 ulp (of the larger of the value
# before and after the step) of the plain version, float8
# codes within one e4m3 step of their value, scales to 1e-6 relative, and
# at most 0.1 % of codes different: both versions compute the same f32
# expressions, but the kernel contracts multiply-adds into FMAs, so a
# value within an ulp of a float8 rounding boundary may round either way.
ADAMW_CODE_FRAC = 1e-3


def _sdpa_grad_ms(q, k, v, dout, iters, causal=True, layout="bshd"):
    """SDPA's backward alone: forward + backward minus forward,
    enable_gqa (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    def heads(x):
        return x if layout == "bhsd" else x.transpose(1, 2)

    qt, kt, vt = (heads(x).detach().requires_grad_(True) for x in (q, k, v))
    dot = heads(dout)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.enable_grad():
        return _time_ms(both, iters) - _time_ms(fwd, iters)


def _flash_bwd_case(B, S, H, KV, hd, peaks, gen, causal=True,
                    layout="bshd", by_kv_head: bool = False):
    """dq, dk, dv from the kernel forward's (out, lse), against the plain
    backward on the same inputs (with `by_kv_head`, one KV head's group
    at a time); the kernel must also repeat bit for bit (no atomics)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, dout = _qkv(B, S, hd, gen, layout, (H, KV, KV, H))
    kw = dict(causal=causal, layout=layout)
    plain_fn = _bwd_ref_by_kv_head if by_kv_head \
        else fa.flash_attention_bwd_ref
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    ref = plain_fn(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    rel = {n: _rel_err(a, b, floor=GRAD_ROW_FLOOR)
           for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
    if not all(r <= KERNEL_TOL for r in rel.values()):
        raise AssertionError(f"flash bwd B={B} S={S}: relative errors {rel}"
                             f" > {KERNEL_TOL}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash bwd B={B} S={S}: two runs differ")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, ref))
    del again, ref, got
    ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                 **kw), 10)
    plain = _time_ms(lambda: plain_fn(q, k, v, out, lse, dout, **kw),
                     1 if by_kv_head else 2)
    lib = _sdpa_grad_ms(q, k, v, dout, 5, causal, layout)
    pairs = S * (S + 1) // 2 if causal else S * S
    # five products over the visible pairs: QK^T again, dO V^T, P^T dO,
    # dS K, dS^T Q; bytes: q, k, v, out, dout, lse in; dq, dk, dv out
    flops = 10.0 * B * H * hd * pairs
    nbytes = 2.0 * B * S * hd * (4 * H + 4 * KV) + 4.0 * B * H * S
    return _shares({"shape": f"B={B} S={S} H={H} KV={KV} hd={hd}"
                             + ("" if causal else " non-causal")
                             + ("" if layout == "bshd" else f" {layout}"),
                    "max_abs_err": err, "max_rel_err": max(rel.values()),
                    "rel_err": rel, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, **_bound(flops, nbytes, peaks)})


def _launched(fn, marks, calls: int = 3):
    """The kernels `calls` calls of fn() launch (torch.profiler, after one
    warm-up call): raises unless every one matches one of `marks` and
    each mark is seen, i.e. the wrapper launches its own kernels and
    nothing else (no cast of the weight or of dw). The profiler has been
    seen to drop a kernel of a programmatic dependent pair, never to add
    one: a missing mark is looked for once more before it fails, a
    launch of anything else fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        other = [n for n in names if not any(m in n for m in marks)]
        if other:
            raise AssertionError(f"expected launches of {marks} only, "
                                 f"{calls} calls launched {names}")
        if all(any(m in n for n in names) for m in marks):
            return list(marks)
    raise AssertionError(f"expected launches of {marks}, {calls} calls "
                         f"launched {names}, twice")


def _rms_library_ms(fn, same_dtype):
    """The ATen RMSNorm call's times; none where x and the weight differ
    in dtype, which ATen's fused RMSNorm does not take (F.rms_norm then
    runs its unfused composite, in another output dtype)."""
    if not same_dtype:
        return {"library_ms": None, "library_graph_ms": None,
                "library": "none: ATen's fused RMSNorm takes x and the "
                           "weight in one dtype"}
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    return {"library_ms": _time_ms(fn, 20), "library_graph_ms":
            _graph_ms(fn, 20)}


def _rms_cases(rows, D, peaks, gen, eps=1e-5, w_dtype=torch.bfloat16):
    """The training norm at [rows, D] (bf16 x, the path's weight: bf16,
    or f32 for the f32-param trees):
    forward (out per row, rstd) and backward (dx per row, dw over D, in
    the weight's dtype) against the plain twins; the backward must
    repeat bit for bit and launch its walk and fold only."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.tools import bench_kernels as bk
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    x = torch.randn(rows, D, device="cuda", generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(w_dtype)
    dy = torch.randn(rows, D, device="cuda", generator=gen).bfloat16()
    out, rstd = rn.rms_norm_fwd(x, w, eps)
    rout, rrstd = rn._rms_fwd_twin(x, w, eps)
    dx, dw = rn.rms_norm_bwd(x, w, rstd, dy, eps)
    dx2, dw2 = rn.rms_norm_bwd(x, w, rstd, dy, eps)
    rdx, rdw = rn._rms_train_ref_bwd(x, w, dy, eps)
    torch.cuda.synchronize()
    f_rel = _rel_err(out, rout)
    r_rel = ((rstd - rrstd).abs() / rrstd.abs()).max().item()
    b_rel = _rel_err(dx, rdx)
    w_rel = ((dw.float() - rdw.float()).abs().max()
             / rdw.float().abs().max()).item()
    if not (f_rel <= KERNEL_TOL and r_rel <= RSTD_TOL
            and b_rel <= KERNEL_TOL and w_rel <= KERNEL_TOL):
        raise AssertionError(f"rms [{rows}, {D}]: out {f_rel}, rstd {r_rel}"
                             f", dx {b_rel}, dw {w_rel}")
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError("rms bwd: two runs differ")
    wname = str(w_dtype).replace("torch.", "")
    fwd = {"shape": f"rows={rows} D={D}"
                    + ("" if w_dtype == torch.bfloat16 else f" w {wname}"),
           "max_abs_err": (out.float() - rout.float()).abs().max().item(),
           "max_rel_err": f_rel, "rstd_rel_err": r_rel,
           "ms": _time_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20),
           "graph_ms": _graph_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20),
           "plain_ms": _time_ms(lambda: rn._rms_fwd_twin(x, w, eps), 5),
           **_rms_library_ms(lambda: F.rms_norm(x, (D,), w, eps),
                             w.dtype == x.dtype),
           **_bound(4.0 * rows * D,
                    2.0 * rows * D * 2 + 2.0 * D + 4.0 * rows, peaks,
                    peaks[2])}
    # the one ATen call for the backward: the fused RMSNorm backward on
    # its forward's rstd
    lib = bk.rms_library(x, w, dy, eps) if w.dtype == x.dtype else None

    def call():
        return rn.rms_norm_bwd(x, w, rstd, dy, eps)

    if dw.dtype != w.dtype:
        raise AssertionError(f"rms bwd: dw {dw.dtype}, weight {w.dtype}")
    bwd = {"shape": fwd["shape"],
           "max_abs_err": max((dx.float() - rdx.float()).abs().max().item(),
                              (dw.float() - rdw.float()).abs().max().item()),
           "max_rel_err": max(b_rel, w_rel), "dw_rel_err": w_rel,
           "weight": str(w.dtype).replace("torch.", ""),
           "launched": _launched(call, ("rms_bwd_kernel", "rms_dw_kernel")),
           "ms": _time_ms(call, 20), "graph_ms": _graph_ms(call, 20),
           "plain_ms": _time_ms(
               lambda: rn._rms_train_ref_bwd(x, w, dy, eps), 5),
           **_rms_library_ms(lib, lib is not None),
           **_bound(9.0 * rows * D,
                    3.0 * rows * D * 2 + 4.0 * rows + 2.0 * D * 2, peaks,
                    peaks[2])}
    return fwd, bwd


def _rms_fused_cases(rows, D, dtype, w_dtype, peaks, gen, flush,
                     on_path=False):
    """Row 6 at [rows, D] (x in `dtype`; a weight in `w_dtype`, or
    affine-free with None) against its plain version `rms_norm_ref`: per
    row, f32 within RMS_F32_TOL, bf16 within KERNEL_TOL; bit-identical
    twice. Times with the L2 cache flushed before each call, beside
    F.rms_norm. `on_path`: the eager Llama step's form, launched 23 times
    a step."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    eps = 1e-5
    x = (torch.randn(rows, D, device="cuda", generator=gen) + 0.3).to(dtype)
    w = None if w_dtype is None else \
        (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(w_dtype)
    out = rn.rms_norm_fused(x, w, eps)
    again = rn.rms_norm_fused(x, w, eps)
    ref = rn.rms_norm_ref(x, w, eps)
    torch.cuda.synchronize()
    rel = _rel_err(out, ref)
    tol = RMS_F32_TOL if dtype == torch.float32 else KERNEL_TOL
    name = (f"rows={rows} D={D} {str(dtype).replace('torch.', '')}"
            + (" affine-free" if w is None else
               f" w {str(w_dtype).replace('torch.', '')}"))
    if not rel <= tol:
        raise AssertionError(f"rms_norm_fused [{name}]: {rel} > {tol}")
    if not torch.equal(out, again):
        raise AssertionError(f"rms_norm_fused [{name}]: two runs differ")
    wl = None if w is None else w.to(dtype)
    es = x.element_size()
    path = ({"path": "eager_llama", "step_launches": 23} if on_path
            else {"path": None})
    return {"shape": name, **path,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "max_rel_err": rel,
            "ms": _time_ms(lambda: rn.rms_norm_fused(x, w, eps), 20, flush),
            "plain_ms": _time_ms(lambda: rn.rms_norm_ref(x, w, eps), 5,
                                 flush),
            "library_ms": _time_ms(lambda: F.rms_norm(x, (D,), wl, eps), 20,
                                   flush),
            # x read, out written, the weight read; ~4 f32 operations a
            # value (square-add, scale, weight)
            **_bound(4.0 * rows * D, 2.0 * es * rows * D
                     + (0 if w is None else w.element_size() * D), peaks,
                     peaks[2])}


def _sdpa_masked_ms(q, k, v, dout, mask4, layout, iters):
    """SDPA given the same boolean key mask ([B, 1, 1, Sk]), non-causal,
    in its [B, H, S, D] layout: (forward ms, backward ms as forward +
    backward minus forward). The library yardstick; the port never calls
    it."""
    import torch.nn.functional as F
    t = (lambda x: x) if layout == "bhsd" else (lambda x: x.transpose(1, 2))
    qt, kt, vt = (t(x).detach().requires_grad_(True) for x in (q, k, v))
    dot = t(dout)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        f = _time_ms(fwd, iters)
    with torch.enable_grad():
        return f, _time_ms(both, iters) - _time_ms(fwd, iters)


def _masked_flash_cases(B, S, H, hd, layout, lengths, peaks, gen, label=""):
    """The non-causal flash forward (+ LSE) and backward with the [B, S]
    key mask of `lengths` (keys j < lengths[b] visible; None: unmasked) in
    `layout`, against the plain versions: output per (position, head)
    within KERNEL_TOL and the LSE within LSE_TOL on the rows that see a
    key, dq, dk, dv within KERNEL_TOL (GRAD_ROW_FLOOR), the backward bit
    for bit twice. A batch row that sees no key must give exactly 0 out,
    an LSE of -1e30 and no gradient, and a masked key dk = dv = 0 exactly
    (the TPU kernel's semantics). Timed beside SDPA given the same
    boolean mask."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    shape = (B, H, S, hd) if layout == "bhsd" else (B, S, H, hd)
    q, k, v, dout = (torch.randn(shape, device="cuda", generator=gen)
                     .bfloat16() for _ in range(4))
    km = None if lengths is None else \
        torch.arange(S, device="cuda")[None] < lengths[:, None]
    kw = {"causal": False, "key_mask": km, "layout": layout}
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    ref, lse_r = fa.flash_attention_fwd_ref(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    rgot = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    bshd = (lambda x: x.transpose(1, 2)) if layout == "bhsd" else \
        (lambda x: x)
    seen = (torch.ones(B, dtype=torch.bool, device="cuda") if km is None
            else km.any(1))
    rows = seen[:, None, None].expand(B, S, H)
    name = (f"B={B} S={S} H={H} hd={hd} {layout} "
            + ("unmasked" if km is None else "masked") + label)
    rel = _rel_err(bshd(out), bshd(ref), rows)
    lse_err = (lse - lse_r)[seen].abs().max().item()
    brel = {n: _rel_err(bshd(a), bshd(b), rows if n == "dq" else None,
                        floor=GRAD_ROW_FLOOR)
            for n, a, b in zip(("dq", "dk", "dv"), got, rgot)}
    if not (rel <= KERNEL_TOL and lse_err <= LSE_TOL
            and all(r <= KERNEL_TOL for r in brel.values())):
        raise AssertionError(f"masked flash [{name}]: out {rel}, lse "
                             f"{lse_err}, grads {brel}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"masked flash bwd [{name}]: two runs differ")
    del again
    if km is not None:
        hidden = ~km                                # [B, S] masked keys
        unseen = ~seen
        if unseen.any() and not (
                bshd(out)[unseen].eq(0).all()
                and bool((lse[unseen] <= -1e29).all())
                and bshd(got[0])[unseen].eq(0).all()):
            raise AssertionError(f"masked flash [{name}]: a row that sees "
                                 f"no key gave output or gradient")
        if not all(bshd(g)[hidden].eq(0).all() for g in got[1:]):
            raise AssertionError(f"masked flash [{name}]: a masked key got "
                                 f"dk or dv")
    visible = B * S if km is None else int(km.sum())
    pairs = float(S) * visible                  # every query, visible keys
    mask4 = None if km is None else km[:, None, None, :]
    lib_f, lib_b = _sdpa_masked_ms(q, k, v, dout, mask4, layout, 10)
    mbytes = 0.0 if km is None else B * S
    err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa
    fwd = {"shape": name, "max_abs_err": err(out, ref),
           "max_rel_err": rel, "lse_abs_err": lse_err,
           "ms": _time_ms(lambda: fa.flash_attention_fwd(
               q, k, v, return_lse=True, **kw), 20),
           "plain_ms": _time_ms(lambda: fa.flash_attention_fwd_ref(
               q, k, v, return_lse=True, **kw), 3),
           "library_ms": lib_f,
           # q, k, v, the mask in; out and the f32 LSE written
           **_bound(4.0 * H * hd * pairs, 2.0 * B * S * H * hd * 4
                    + 4.0 * B * H * S + mbytes, peaks)}
    bwd = {"shape": name,
           "max_abs_err": max(err(a, b) for a, b in zip(got, rgot)),
           "max_rel_err": max(brel.values()), "rel_err": brel,
           "ms": _time_ms(lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, dout, **kw), 10),
           "plain_ms": _time_ms(lambda: fa.flash_attention_bwd_ref(
               q, k, v, out, lse, dout, **kw), 2),
           "library_ms": lib_b,
           # five products over the visible pairs; q, k, v, out, dout,
           # lse, the mask in, dq, dk, dv out
           **_bound(10.0 * H * hd * pairs, 2.0 * B * S * H * hd * 8
                    + 4.0 * B * H * S + mbytes, peaks)}
    return _shares(fwd), _shares(bwd)


def _ln_cases(rows, D, dtype, affine, peaks, gen, flush, on_path=False):
    """The fused LayerNorm at [rows, D] (x in `dtype`; f32 weight and
    bias, or affine-free): forward (out per row, mu, rstd) and backward
    (dx per row, dw and db) against the plain twins, at ERNIE's eps
    1e-12; the backward must repeat bit for bit and launch its walk and
    fold only. Times with the L2 cache flushed before each call, and the
    backward's also in one CUDA graph, beside the one ATen backward's.
    `on_path`: the eager step's form, launched 25 times a step."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    eps = 1e-12
    x = (torch.randn(rows, D, device="cuda", generator=gen) + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
    b = 0.1 * torch.randn(D, device="cuda", generator=gen)
    if not affine:
        w = b = None
    dy = torch.randn(rows, D, device="cuda", generator=gen).to(dtype)
    out, mu, rstd = ln.layer_norm_fwd(x, w, b, eps)
    rout, rmu, rrstd = ln._ln_fwd_twin(x, w, b, eps, affine)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)
    again = ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)
    rdx, rdw, rdb = ln._ln_ref_bwd(x, w, dy, eps, affine)
    torch.cuda.synchronize()
    tol = LN_F32_TOL if dtype == torch.float32 else KERNEL_TOL
    f_rel = _rel_err(out, rout)
    # a mean near 0 has no relative precision of its own: mu is held
    # relative to the larger of |mu| and the row's standard deviation
    mu_rel = ((mu - rmu).abs() / torch.maximum(rmu.abs(), 1 / rrstd)
              ).max().item()
    r_rel = ((rstd - rrstd).abs() / rrstd).max().item()
    b_rel = _rel_err(dx, rdx)
    w_rel = max(((a - r).abs().max() / r.abs().max()).item()
                for a, r in ((dw, rdw), (db, rdb)))
    name = (f"rows={rows} D={D} {str(dtype).replace('torch.', '')}"
            + ("" if affine else " affine-free"))
    if not (f_rel <= tol and mu_rel <= LN_STAT_TOL and r_rel <= LN_STAT_TOL
            and b_rel <= tol and w_rel <= LN_SUM_TOL):
        raise AssertionError(f"layer_norm [{name}]: out {f_rel}, mu "
                             f"{mu_rel}, rstd {r_rel}, dx {b_rel}, dw/db "
                             f"{w_rel}")
    if not all(torch.equal(a, c) for a, c in zip((dx, dw, db), again)):
        raise AssertionError(f"layer_norm bwd [{name}]: two runs differ")
    del again
    xg = x.detach().requires_grad_(True)
    wl, bl = ((t.to(dtype).requires_grad_(True) for t in (w, b)) if affine
              else (None, None))

    def lib_fwd():
        return F.layer_norm(xg, (D,), wl, bl, eps)

    es = x.element_size()
    path = ({"path": "eager", "step_launches": 25} if on_path
            else {"path": None})
    fwd = {"shape": name, **path,
           "max_abs_err": (out.float() - rout.float()).abs().max().item(),
           "max_rel_err": f_rel, "mu_rel_err": mu_rel, "rstd_rel_err": r_rel,
           "ms": _time_ms(lambda: ln.layer_norm_fwd(x, w, b, eps), 20,
                          flush),
           "plain_ms": _time_ms(lambda: ln._ln_fwd_twin(x, w, b, eps,
                                                        affine), 5, flush),
           "library_ms": _time_ms(lib_fwd, 20, flush),
           # x read, out written; w, b read; mu, rstd written. ~8 f32
           # operations a value (sum, centre, square-add, scale, affine)
           **_bound(8.0 * rows * D, 2.0 * es * rows * D + 8.0 * D
                    + 8.0 * rows, peaks, peaks[2])}
    # the one ATen call for the backward, on ATen's own forward's mean
    # and rstd (the weight and bias in x's dtype, as ATen takes them)
    wn, bn = (None, None) if wl is None else (wl.detach(), bl.detach())
    _, lmu, lrstd = torch.ops.aten.native_layer_norm(x, [D], wn, bn, eps)

    def lib_bwd():
        return torch.ops.aten.native_layer_norm_backward(
            dy, x, [D], lmu, lrstd, wn, bn, [True, affine, affine])

    def call():
        return ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)

    bwd = {"shape": name, **path,
           "max_abs_err": max((dx.float() - rdx.float()).abs().max().item(),
                              (dw - rdw).abs().max().item(),
                              (db - rdb).abs().max().item()),
           "max_rel_err": max(b_rel, w_rel), "dwdb_rel_err": w_rel,
           "launched": _launched(call, ("ln_bwd_kernel", "ln_dwdb_kernel")),
           "ms": _time_ms(call, 20, flush), "graph_ms": _graph_ms(call, 20),
           "plain_ms": _time_ms(lambda: ln._ln_ref_bwd(x, w, dy, eps,
                                                       affine), 5, flush),
           "library_ms": _time_ms(lib_bwd, 20, flush),
           "library_graph_ms": _graph_ms(lib_bwd, 20),
           # x, dy read, dx written; mu, rstd, w read; dw, db written.
           # ~13 f32 operations a value
           **_bound(13.0 * rows * D, 3.0 * es * rows * D + 8.0 * rows
                    + 12.0 * D, peaks, peaks[2])}
    return fwd, bwd


def _f8_step(c):
    """The spacing of float8 e4m3 values at |c| (codes as f32): 2^(e-3)
    for a normal value of exponent e, 2^-9 below 2^-6."""
    a = c.abs().clamp(min=2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(a)) - 3)


def _adamw_leaves(shapes):
    """The leaves of a trained tree (`llama._shapes` or `moe._shapes` of
    a train phase's config), grouped by size: [(shape, names)], largest
    first. The step launches the kernel once per leaf, on the leaf
    flattened, so leaves of one size are the same work."""
    flat = {k: s for k, s in shapes.items() if k != "layers"}
    flat.update(shapes["layers"])
    by_size: dict = {}
    for name, shape in sorted(flat.items()):
        by_size.setdefault(int(np.prod(shape)), []).append((name, shape))
    return [(group[0][1], [n for n, _ in group])
            for _, group in sorted(by_size.items(), reverse=True)]


def _adamw_case(shape, names, peaks, gen):
    """One leaf of the fused 8-bit AdamW from a mid-training state, the
    kernel and the plain version each on its own copy; `names` are the
    leaves of the trained tree that have this size (the step launches the
    kernel once for each)."""
    from paddle_tpu_torch.optimizer import quant_state as qs
    dev = "cuda"
    p = (0.02 * torch.randn(shape, device=dev, generator=gen)).bfloat16()
    g = (1e-3 * torch.randn(shape, device=dev, generator=gen)).bfloat16()
    m0 = 1e-3 * torch.randn(shape, device=dev, generator=gen)
    v0 = 1e-6 * torch.rand(shape, device=dev, generator=gen)
    mq, vq = qs._quantize(m0, False), qs._quantize(v0, True)
    del m0, v0
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    sc = torch.tensor([0.5, 1e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3],
                      dtype=torch.float32, device=dev)

    def copy():
        return (p.clone(), qs._QTensor(mq.codes.clone(), mq.scale.clone()),
                qs._QTensor(vq.codes.clone(), vq.scale.clone()))

    pk, mk, vk = copy()
    pr, mr, vr = copy()
    qs.fused_leaf_update(sc, g, pk, mk, vk, **hp)
    qs.fused_leaf_update_ref(sc, g, pr, mr, vr, **hp)
    torch.cuda.synchronize()
    # one bf16 ulp of the parameter's magnitude before or after the step:
    # where p and lr * update cancel, the result inherits the f32
    # rounding of the terms that cancelled, not of the tiny result
    mag = torch.maximum(p.float().abs(), pr.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126)))
                     - 7)
    p_ulps = ((pk.float() - pr.float()).abs() / ulp).max().item()
    res = {"shape": f"{list(shape)} ({p.numel()} values: "
                    f"{', '.join(names)})", "step_launches": len(names),
           "max_abs_err": (pk.float() - pr.float()).abs().max().item(),
           "param_ulps": p_ulps}
    ok = p_ulps <= 1.0
    for name, a, b in (("m", mk, mr), ("v", vk, vr)):
        ca, cb = a.codes.float(), b.codes.float()
        steps = ((ca - cb).abs() / _f8_step(torch.maximum(ca.abs(),
                                                          cb.abs()))).max()
        frac = (ca != cb).float().mean().item()
        srel = ((a.scale - b.scale).abs() / b.scale).max().item()
        res.update({f"{name}_code_steps": steps.item(),
                    f"{name}_codes_differ": frac, f"{name}_scale_rel": srel})
        ok = ok and steps.item() <= 1.0 and frac <= ADAMW_CODE_FRAC \
            and srel <= 1e-6
    if not ok:
        raise AssertionError(f"adamw_q {list(shape)}: {res}")
    res["max_rel_err"] = max(res["m_scale_rel"], res["v_scale_rel"])
    n, nb = p.numel(), mq.codes.shape[0]
    res["ms"] = _time_ms(lambda: qs.fused_leaf_update(sc, g, pk, mk, vk,
                                                      **hp), 20)
    res["plain_ms"] = _time_ms(lambda: qs.fused_leaf_update_ref(
        sc, g, pr, mr, vr, **hp), 3)
    res["library_ms"] = None
    # g, p read and p written (bf16); both moments' codes read and
    # written; their scales read and written; ~25 f32 operations a value
    res.update(_bound(25.0 * n, 6.0 * n + 4.0 * n + 16.0 * nb + 16, peaks,
                      peaks[2]))
    return res


def _bf16_ulps(a, b):
    """The largest |a - b| over the elements, in bf16 ulps of the larger
    of the two magnitudes (2^(e-7) for a value of exponent e)."""
    af, bf = a.float(), b.float()
    mag = torch.maximum(af.abs(), bf.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((af - bf).abs() / ulp).max().item()


def _moe_maps(gen, B=20, S=2048):
    """The index maps of one real routing at the MoE step's shape: the
    MoE config's `top_k_routing` (16 experts, top-2, capacity 320 of
    2048 tokens) of random gate logits [B, S, 16], then the block's
    expert-leading maps (`moe._routing_maps`), so empty slots and
    capacity drops are those routing makes. The logits are N(0, 1) plus
    an N(0, 0.5) preference per expert: balanced logits overflow no
    expert's capacity, while the trained model's routing is skewed and
    drops 16-37 % of its pairs (train_moe phase, PERF.md)."""
    from paddle_tpu_torch.nlp import moe
    cfg = moe.MoeConfig.flagship_moe()
    E, k, C = cfg.num_experts, cfg.num_experts_per_tok, cfg.capacity(S)
    logits = (torch.randn(B, S, E, device="cuda", generator=gen)
              + 0.5 * torch.randn(E, device="cuda", generator=gen))
    eidx, slot, probs, valid, _, _ = moe.top_k_routing(logits, k, C)
    flat_g, inv_pos, inv_tok, idx_tk, w_tk = moe._routing_maps(
        eidx, slot, probs, valid, C, E)
    # per-group form [B, S·k] (slot e·C + c of the group's E·C), the maps
    # of the JAX `combine_gather` over eout [B, E·C, D]
    flat_b = torch.where(valid, eidx * C + slot, -1).reshape(B, S * k)
    return {"B": B, "S": S, "E": E, "k": k, "C": C, "flat": flat_g,
            "flat_b": flat_b.to(torch.int32),
            "inv_pos": inv_pos, "inv_tok": inv_tok, "idx_tk": idx_tk,
            "w_tk": w_tk,
            # rows the data needs: tokens with a routed choice, routed
            # (token, choice) pairs
            "tokens_routed": int(valid.any(-1).sum().item()),
            "pairs_routed": int(valid.sum().item())}


def _wsum_case(label, src, idx, w, rows_read, step_launches, peaks, flush):
    """gather_wsum at one of the MoE path's shapes against its plain
    version: bit for bit at k=1, within one bf16 ulp per element at k=2
    (both compute the same f32 products and sums in the same order; the
    kernel never contracts them into FMAs, so they should agree bit for
    bit there too, and a one-ulp allowance covers a rounding of the f32
    sum landing on a bf16 tie). `rows_read` is the number of source rows
    the data needs; the library yardstick is one embedding_bag call (sum
    mode, per-sample weights in the table's dtype)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import moe_dispatch as md
    B, M, k = idx.shape
    D = src.shape[-1]
    out = md.gather_wsum(src, idx, w)
    ref = md._gather_wsum_ref(src, idx, w)
    torch.cuda.synchronize()
    ulps = _bf16_ulps(out, ref)
    exact = torch.equal(out, ref)
    if (k == 1 and not exact) or not ulps <= 1.0:
        raise AssertionError(f"gather_wsum {label}: {ulps} bf16 ulps from "
                             f"the plain version (bit-identical: {exact})")
    err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref, ref.abs().amax(-1) > 0)     # non-empty rows
    del out, ref
    bag = idx.reshape(B * M, k)
    wb = w.reshape(B * M, k).to(src.dtype)
    res = {"shape": f"{label}: src {list(src.shape)} -> [{B}, {M}, {D}], "
                    f"k={k}, {rows_read} rows read",
           "step_launches": step_launches, "path": "train_moe",
           "max_abs_err": err, "max_rel_err": rel, "bf16_ulps": ulps,
           "bit_identical": exact,
           "ms": _time_ms(lambda: md.gather_wsum(src, idx, w), 20, flush),
           "plain_ms": _time_ms(lambda: md._gather_wsum_ref(src, idx, w), 3,
                                flush),
           "library_ms": _time_ms(lambda: F.embedding_bag(
               bag, src[0], mode="sum", per_sample_weights=wb), 20, flush)}
    # rows read once, every output row written once, idx and w read; a
    # multiply and an add per term, on the f32 units
    nbytes = 2.0 * D * (rows_read + B * M) + 8.0 * B * M * k
    res.update(_bound(2.0 * k * B * M * D, nbytes, peaks, peaks[2]))
    return res


def _scale_dot_case(label, src, idx, scale, other, rows_read, peaks,
                    flush):
    """gather_scale_dot at the combine backward's shape against its
    plain version: out within one bf16 ulp per element (one f32 product
    rounded once, in both), dot within 1e-5 x |row| |other| per slot (an
    f32 sum of D products in another order: the rounding error of a
    length-2048 sum is below 2048 x 2^-24 ~ 1.2e-4 of sum |x y| at worst
    and ~sqrt(2048) x 2^-24 ~ 3e-6 of it in practice)."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    B, M = idx.shape
    D = src.shape[-1]
    out, dot = md.gather_scale_dot(src, idx, scale, other)
    rout, rdot = md._gather_scale_dot_ref(src, idx, scale, other)
    torch.cuda.synchronize()
    ulps = _bf16_ulps(out, rout)
    norms = (md._take_rows(src, idx).float().norm(dim=-1)
             * other.float().norm(dim=-1))
    dot_rel = ((dot - rdot).abs() / norms.clamp(min=1e-30)).max().item()
    if not (ulps <= 1.0 and dot_rel <= 1e-5):
        raise AssertionError(f"gather_scale_dot {label}: out {ulps} bf16 "
                             f"ulps, dot {dot_rel} x |row||other|")
    err = max((out.float() - rout.float()).abs().max().item(),
              (dot - rdot).abs().max().item())
    del out, rout, norms
    res = {"shape": f"{label}: src {list(src.shape)}, other "
                    f"{list(other.shape)}, {rows_read} src rows read",
           "step_launches": 12, "path": "train_moe",
           "max_abs_err": err, "max_rel_err": dot_rel, "bf16_ulps": ulps,
           "dot_rel_err": dot_rel,
           "ms": _time_ms(lambda: md.gather_scale_dot(src, idx, scale,
                                                      other), 20, flush),
           "plain_ms": _time_ms(lambda: md._gather_scale_dot_ref(
               src, idx, scale, other), 3, flush),
           "library_ms": None}
    # src rows read once, every other row read, out and dot written, idx
    # and scale read; a multiply, and a multiply-add for the dot, per value
    nbytes = (2.0 * D * (rows_read + 2 * B * M) + 4.0 * B * M
              + 8.0 * B * M)
    res.update(_bound(3.0 * B * M * D, nbytes, peaks, peaks[2]))
    return res


def _moe_dispatch_cases(peaks, gen, flush):
    """The two MoE kernels at the MoE step's four launch shapes: the
    dispatch forward (k=1, token rows into 102,400 slots), the combine
    forward and the dispatch backward (k=2, slots back into 40,960 token
    rows: gate-prob and 0/1 weights) and the combine backward."""
    mp = _moe_maps(gen)
    B, S, k = mp["B"], mp["S"], mp["k"]
    T, M = B * S, mp["E"] * B * mp["C"]
    D = 2048
    x = torch.randn(1, T, D, device="cuda", generator=gen).bfloat16()
    slots = torch.randn(1, M, D, device="cuda", generator=gen).bfloat16()
    inv_tok, flat = mp["inv_tok"], mp["flat"]
    wsum = [
        _wsum_case("dispatch forward", x, inv_tok.clamp(min=0)[..., None],
                   (inv_tok >= 0).float()[..., None], mp["tokens_routed"],
                   24, peaks, flush),
        _wsum_case("combine forward", slots, mp["idx_tk"], mp["w_tk"],
                   mp["pairs_routed"], 24, peaks, flush),
        _wsum_case("dispatch backward", slots,
                   flat.clamp(min=0).reshape(1, T, k),
                   (flat >= 0).float().reshape(1, T, k),
                   mp["pairs_routed"], 12, peaks, flush)]
    # the combine backward's operands, built as _CombineWsum.backward
    # builds them: dy is the token-row gradient, other the expert output
    inv_pos = mp["inv_pos"]
    live = inv_pos >= 0
    w_slot = torch.where(live, torch.gather(
        mp["w_tk"].reshape(1, T * k), 1, inv_pos.clamp(min=0).long()), 0.0)
    tok = torch.where(live, torch.div(inv_pos, k, rounding_mode="floor"), 0)
    sdot = [_scale_dot_case("combine backward", x, tok, w_slot, slots,
                            mp["tokens_routed"], peaks, flush)]
    # a row width the 16-byte loads cannot take is refused, not run plain
    from paddle_tpu_torch.kernels import moe_dispatch as md
    odd = torch.zeros(1, 4, 12, dtype=torch.bfloat16, device="cuda")
    i1 = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    for call in (lambda: md.gather_wsum(odd, i1[..., None],
                                        torch.ones(1, 2, 1, device="cuda")),
                 lambda: md.gather_scale_dot(odd, i1, torch.ones(
                     1, 2, device="cuda"), odd[:, :2].contiguous())):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a MoE gather took D = 12 on the card")
    info = {"slots": M, "pairs": T * k, "pairs_routed": mp["pairs_routed"],
            "tokens_routed": mp["tokens_routed"],
            "dropped_share": 1 - mp["pairs_routed"] / (T * k),
            "empty_slot_share": 1 - mp["pairs_routed"] / M}
    return wsum, sdot, info


# The adaLN kernels (rows 11-12) against their plain versions: in bf16 the
# output and dx per row within KERNEL_TOL (one bf16 rounding of the same
# f32 values); in f32 the same f32 expressions summed in another order
# (the row's mean and variance, a warp's shuffles against torch's
# reduction), ~1e-7 of a row's scale: 1e-5. mu and rstd are f32 in both:
# 1e-5 (mu absolute, rstd relative). dshift and dscale sum 256 tokens'
# f32 terms in another order: 1e-4 of the largest |value|.
ADALN_F32_TOL = 1e-5
ADALN_STAT_TOL = 1e-5
ADALN_SUM_TOL = 1e-4


def _adaln_cases(B, N, D, dtype, peaks, gen, flush):
    """The fused adaLN forward and backward at x [B, N, D] with per-sample
    shift and scale [B, D] (in x's dtype, as DiT's modulation is) against
    their plain versions; the backward must repeat bit for bit. Times
    beside DiT's own plain chain `_modulate(_ln(x))` (and its autograd
    backward) and `F.layer_norm` (the norm only, no modulation); no one
    PyTorch call computes the fused function (library_ms null)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import adaln as ad
    from paddle_tpu_torch.mix import dit
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    x = (torch.randn(B, N, D, device="cuda", generator=gen) + 0.3).to(dtype)
    sh, sc = ((0.1 * torch.randn(B, D, device="cuda", generator=gen))
              .to(dtype) for _ in range(2))
    dy = torch.randn(B, N, D, device="cuda", generator=gen).to(dtype)
    bf16 = dtype == torch.bfloat16
    tol = KERNEL_TOL if bf16 else ADALN_F32_TOL
    out, mu, rstd = ad.adaln_fwd(x, sh, sc)
    rout, rmu, rrstd = ad._adaln_fwd_twin(x, sh, sc)
    dx, dsh, dsc = ad.adaln_bwd(x, sc, mu, rstd, dy)
    again = ad.adaln_bwd(x, sc, mu, rstd, dy)
    rdx, rdsh, rdsc = ad._adaln_bwd_plain(x, sc, rmu, rrstd, dy)
    torch.cuda.synchronize()
    err = {"out": _rel_err(out, rout), "dx": _rel_err(dx, rdx,
                                                       floor=GRAD_ROW_FLOOR),
           "mu": (mu - rmu).abs().max().item(),
           "rstd": ((rstd - rrstd).abs() / rrstd).max().item(),
           "dshift": ((dsh - rdsh).abs().max() / rdsh.abs().max()).item(),
           "dscale": ((dsc - rdsc).abs().max() / rdsc.abs().max()).item()}
    bounds = {"out": tol, "dx": tol, "mu": ADALN_STAT_TOL,
              "rstd": ADALN_STAT_TOL, "dshift": ADALN_SUM_TOL,
              "dscale": ADALN_SUM_TOL}
    label = f"[{B}, {N}, {D}] {str(dtype).split('.')[-1]}"
    if not all(err[n] <= b for n, b in bounds.items()):
        raise AssertionError(f"adaln {label}: errors {err} over {bounds}")
    if not all(torch.equal(a, b) for a, b in zip((dx, dsh, dsc), again)):
        raise AssertionError(f"adaln {label}: two backward runs differ")
    abs_f = max((out.float() - rout.float()).abs().max().item(),
                (mu - rmu).abs().max().item())
    abs_b = max((a.float() - b.float()).abs().max().item()
                for a, b in ((dx, rdx), (dsh, rdsh), (dsc, rdsc)))
    del again, rout, rdx
    xr = x.detach().requires_grad_(True)
    shr, scr = (t.detach().requires_grad_(True) for t in (sh, sc))

    def chain():
        return dit._modulate(dit._ln(xr), shr, scr)

    def chain_bwd():
        torch.autograd.grad(chain(), (xr, shr, scr), dy)

    def ln():
        return F.layer_norm(xr, (D,), eps=1e-6)

    def ln_bwd():
        torch.autograd.grad(ln(), (xr,), dy)

    with torch.enable_grad():
        chain_ms, ln_ms = _time_ms(chain, 20, flush), _time_ms(ln, 20, flush)
        chain_b = _time_ms(chain_bwd, 10, flush) - chain_ms
        ln_b = _time_ms(ln_bwd, 10, flush) - ln_ms
    esz = x.element_size()
    rows, n = B * N, B * N * D
    fwd = {"shape": label, "max_abs_err": abs_f,
           "max_rel_err": max(err["out"], err["rstd"]), "errors": err,
           "ms": _time_ms(lambda: ad.adaln_fwd(x, sh, sc), 20, flush),
           "graph_ms": _graph_ms(lambda: ad.adaln_fwd(x, sh, sc), 20),
           "plain_ms": _time_ms(lambda: ad._adaln_fwd_twin(x, sh, sc), 5,
                                flush),
           "library_ms": None, "dit_chain_ms": chain_ms,
           "layer_norm_ms_norm_only": ln_ms}
    # x read, out written; shift/scale read; mu/rstd written (f32);
    # ~10 f32 operations a value
    fwd.update(_bound(10.0 * n, 2.0 * esz * n + 2.0 * esz * B * D
                      + 8.0 * rows, peaks, peaks[2]))
    bwd = {"shape": label, "max_abs_err": abs_b,
           "max_rel_err": max(err["dx"], err["dshift"], err["dscale"]),
           "errors": err, "bit_identical": True,
           "ms": _time_ms(lambda: ad.adaln_bwd(x, sc, mu, rstd, dy), 20,
                          flush),
           "graph_ms": _graph_ms(lambda: ad.adaln_bwd(x, sc, mu, rstd, dy),
                                 20),
           "plain_ms": _time_ms(lambda: ad._adaln_bwd_plain(
               x, sc, mu, rstd, dy), 5, flush),
           "library_ms": None, "dit_chain_ms": chain_b,
           "layer_norm_ms_norm_only": ln_b}
    # x, dy read, dx written; scale read, mu/rstd read (f32), dshift and
    # dscale written (f32); ~14 f32 operations a value
    bwd.update(_bound(14.0 * n, 3.0 * esz * n + esz * B * D + 8.0 * rows
                      + 8.0 * B * D, peaks, peaks[2]))
    return fwd, bwd


def _gather_rows_case(mp, peaks, gen, flush, D=2048):
    """Row 13, the masked row gather, at the MoE step's combine: eout
    [B, E·C, D] read through the per-group maps [B, S·k] of a real
    routing (dropped choices -1). Bit for bit the plain version, and the
    -1 rows exactly +0. Timed beside `src[b, idx.clamp(0)]`, one
    unmasked indexing call (it reads row 0 for a dropped choice instead
    of writing zeros: not the same function, so library_ms is null)."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    B, E, C = mp["B"], mp["E"], mp["C"]
    idx = mp["flat_b"]
    M = idx.shape[1]
    src = torch.randn(B, E * C, D, device="cuda", generator=gen).bfloat16()
    out = md.gather_rows_kernel(src, idx)
    ref = md._gather_rows_ref(src, idx)
    torch.cuda.synchronize()
    exact = torch.equal(out, ref)
    zero = bool((out[idx < 0].view(torch.int16) == 0).all().item())
    if not (exact and zero):
        raise AssertionError(f"gather_rows: bit-identical {exact}, -1 rows "
                             f"+0 {zero}")
    del out, ref
    bidx = torch.arange(B, device="cuda")[:, None]
    read = int((idx >= 0).sum().item())
    res = {"shape": f"combine: src [{B}, {E * C}, {D}] -> [{B}, {M}, {D}], "
                    f"{read} rows read", "path": "held",
           "max_abs_err": 0.0, "max_rel_err": 0.0, "bit_identical": True,
           "ms": _time_ms(lambda: md.gather_rows_kernel(src, idx), 20, flush),
           "plain_ms": _time_ms(lambda: md._gather_rows_ref(src, idx), 3,
                                flush),
           "library_ms": None,
           "unmasked_index_ms": _time_ms(
               lambda: src[bidx, idx.clamp(min=0)], 20, flush)}
    # the routed rows read once, every output row written, idx read
    res.update(_bound(0.0, 2.0 * D * (read + B * M) + 4.0 * B * M, peaks))
    return res


def _gather_mlp_case(mp, peaks, gen, flush, D=2048, F_=1024):
    """Row 16, the dispatch gather fused into the expert gate and up
    products, at the MoE step's shape: tokens [T = 40960, D], the slots
    of a real routing [E = 16, M = 6400] (-1 empty), wg and wu
    [16, D, F] N(0, 0.02) bf16. g and u within KERNEL_TOL per row of the
    plain version (f32 products, one rounding; the kernel accumulates
    the same bf16 products in f32 in another order), empty slots exactly
    0, xin bit for bit, two calls bit-identical. Timed with the host in
    the loop and in one CUDA graph, beside three PyTorch calls (an
    unmasked index gather and two torch.bmm; library_ms null: no one
    call) and beside what the MoE step runs for the same products: the
    dispatch gather (row 14) and two torch.matmul."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    B, S, E = mp["B"], mp["S"], mp["E"]
    T = B * S
    idx = mp["inv_tok"].reshape(E, -1)
    M = idx.shape[1]
    x = torch.randn(T, D, device="cuda", generator=gen).bfloat16()
    wg, wu = ((0.02 * torch.randn(E, D, F_, device="cuda", generator=gen))
              .bfloat16() for _ in range(2))
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    from paddle_tpu_torch.tools.bench_kernels import slot_blocks
    g, u, xin = md.gather_mlp_kernel(x, idx, wg, wu)
    again = md.gather_mlp_kernel(x, idx, wg, wu)
    rg, ru, rxin = md._gather_mlp_ref(x, idx, wg, wu)
    torch.cuda.synchronize()
    valid = idx >= 0
    rel = {"g": _rel_err(g, rg, valid), "u": _rel_err(u, ru, valid)}
    empty0 = not (g[~valid].any().item() or u[~valid].any().item())
    exact = torch.equal(xin, rxin)
    repeat = all(torch.equal(a, b) for a, b in zip((g, u, xin), again))
    if not (max(rel.values()) <= KERNEL_TOL and empty0 and exact
            and repeat):
        raise AssertionError(f"gather_mlp: relative errors {rel} (tol "
                             f"{KERNEL_TOL}), empty slots 0 {empty0}, xin "
                             f"bit-identical {exact}, two calls "
                             f"bit-identical {repeat}")
    err = max((g.float() - rg.float()).abs().max().item(),
              (u.float() - ru.float()).abs().max().item())
    del g, u, xin, again, rg, ru, rxin
    # 64-slot blocks: the wholly empty ones get no products
    blocks = slot_blocks(idx, T)

    def three():
        xi = x[idx.clamp(min=0)]
        return torch.bmm(xi, wg), torch.bmm(xi, wu)

    def step_path():
        # what the MoE step runs instead (nlp/moe.py::moe_block): the
        # dispatch gather (row 14, k = 1), then the two expert products
        xi = md.dispatch_gather(x[None], mp["inv_tok"], mp["flat"],
                                mp["k"]).reshape(E, M, D)
        return torch.matmul(xi, wg), torch.matmul(xi, wu)

    read = int(valid.sum().item())
    res = {"shape": f"src [{T}, {D}], idx [{E}, {M}], wg/wu [{E}, {D}, "
                    f"{F_}], {read} slots filled", "path": "held",
           "max_abs_err": err, "max_rel_err": max(rel.values()),
           "rel_err": rel, "xin_bit_identical": True, "bit_identical": True,
           "slot_blocks_64": blocks,
           "ms": _time_ms(lambda: md.gather_mlp_kernel(x, idx, wg, wu), 10,
                          flush),
           "graph_ms": _graph_ms(
               lambda: md.gather_mlp_kernel(x, idx, wg, wu), 10),
           "plain_ms": _time_ms(lambda: md._gather_mlp_ref(x, idx, wg, wu),
                                2, flush),
           "library_ms": None,
           "three_calls_ms": _time_ms(three, 10, flush),
           "three_calls_graph_ms": _graph_ms(three, 10),
           "moe_step_path_ms": _time_ms(step_path, 10, flush),
           "moe_step_path_graph_ms": _graph_ms(step_path, 10)}
    # both products over the filled slots only (an empty slot's g and u
    # are zero rows, no product); bytes: the filled slots' rows, the
    # weights, g and u, xin written, idx read
    res.update(_bound(4.0 * read * D * F_,
                      2.0 * D * read + 4.0 * E * D * F_ + 4.0 * E * M * F_
                      + 2.0 * E * M * D + 4.0 * E * M, peaks))
    return res


def phase_kernels(peaks):
    from paddle_tpu_torch.nlp import llama, moe
    H, KV, hd = 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():                  # 256 MB > the 50 MB L2
        scratch.zero_()

    flash = [_flash_case(2, S, H, KV, hd, peaks, KERNEL_TOL, gen)
             for S in (128, 512, 700)]
    flash.append(_flash_case(8, 2048, H, KV, hd, peaks, KERNEL_TOL, gen,
                             lse=True))
    flash.append(_flash_case(20, 2048, 16, 8, hd, peaks, KERNEL_TOL, gen,
                             lse=True))
    # the eager ERNIE step's attention: non-causal, B=64 S=512 H=KV=12
    flash.append(_flash_case(64, 512, 12, 12, 64, peaks, KERNEL_TOL, gen,
                             lse=True, causal=False))
    # the eager Llama step's: causal GQA, B=2 S=2048 + LSE
    flash.append(_flash_case(2, 2048, H, KV, hd, peaks, KERNEL_TOL, gen,
                             lse=True))
    # the serve path's decode, fused and continuing batches, then full
    # chains of 1024 keys: the serve phase's 8 rows at max_total_len,
    # bench.py's batch-32 decode
    ragged = [_ragged_case(kind, H, KV, hd, gen, flush)
              for kind in ("decode", "fused", "continue", "full8",
                           "full32")]
    # row 18's two options at serve_quant_spec's shapes: the int8 pool
    # at the decode, fused and full-chain batches; the suffix slab at the
    # chain verify (spec_k 4), the tree verify ([2, 2, 1]) and a draft step
    ragged_int8 = [_ragged_option_case(f"int8 {kind}", H, KV, hd, gen, flush)
                   for kind in ("decode", "fused", "full32")]
    ragged_suffix = [_ragged_option_case(kind, H, KV, hd, gen, flush)
                     for kind in ("verify_chain", "verify_tree", "draft")]
    wsum, sdot, moe_info = _moe_dispatch_cases(peaks, gen, flush)
    # the eager ERNIE step's norms (f32) and the bf16 form; then the
    # kernels' other forms: a row of one block (D > 1024, up to the
    # largest D), affine-free, a width whose vectors do not fill the
    # last round of a warp or a block, a row count that is not a
    # multiple of 8 rows a block
    f32, bf16 = torch.float32, torch.bfloat16
    lns = [_ln_cases(64 * 512, 768, f32, True, peaks, gen, flush,
                     on_path=True),
           _ln_cases(64 * 512, 768, bf16, True, peaks, gen, flush)]
    lns += [_ln_cases(rows, D, dt, affine, peaks, gen, flush)
            for rows, D, dt, affine in (
                (8192, 4096, bf16, True), (8192, 4096, f32, True),
                (4096, 8192, bf16, False), (4096, 8192, f32, True),
                (32768, 768, f32, False), (4099, 776, bf16, True),
                (4099, 1032, f32, False))]
    # row 6: the eager Llama's f32 [4096, 4096] (23 a step), bf16 with a
    # bf16 weight, a width off the warp's round at 4099 rows, affine-free
    rms_fused = [_rms_fused_cases(2 * 2048, 4096, f32, f32, peaks, gen,
                                  flush, on_path=True)]
    rms_fused += [_rms_fused_cases(rows, D, dt, wdt, peaks, gen, flush)
                  for rows, D, dt, wdt in (
                      (16384, 4096, bf16, bf16), (4099, 776, f32, f32),
                      (4099, 776, bf16, None), (4096, 4096, f32, None))]
    del scratch
    torch.cuda.empty_cache()
    bwd = [_flash_bwd_case(B, S, h, kv, hd, peaks, gen)
           for B, S, h, kv in ((8, 2048, H, KV), (1, 4096, H, KV),
                               (20, 2048, 16, 8))]
    bwd.append(_flash_bwd_case(64, 512, 12, 12, 64, peaks, gen,
                               causal=False))
    bwd.append(_flash_bwd_case(2, 2048, H, KV, hd, peaks, gen))
    # the ERNIE step's key-masked head-major attention at the path's
    # lengths; then masked 'bshd', unmasked 'bhsd', a batch row that sees
    # no key, and an unaligned length
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.ernie_finetune import padded_batch
    lengths = padded_batch(ernie.ErnieConfig.ernie3_base(), 64, 512)[2] \
        .sum(1)
    small = torch.randint(128, 513, (16,), device="cuda", generator=gen)
    few = torch.tensor([0, 512, 200, 77], device="cuda")
    masked = [_masked_flash_cases(64, 512, 12, 64, "bhsd", lengths, peaks,
                                  gen),
              _masked_flash_cases(16, 512, 12, 64, "bshd", small, peaks,
                                  gen),
              _masked_flash_cases(64, 512, 12, 64, "bhsd", None, peaks, gen),
              _masked_flash_cases(4, 512, 12, 64, "bhsd", few, peaks, gen,
                                  " (row 0 sees no key)"),
              _masked_flash_cases(16, 500, 12, 64, "bhsd",
                                  small.clamp(max=500), peaks, gen)]
    flash += [f for f, _ in masked]
    bwd += [b for _, b in masked]
    # DiT-XL/2's attention: B 96 x 256 patch tokens, 16 heads of 72,
    # non-causal, head-major
    flash.append(_flash_case(96, 256, 16, 16, 72, peaks, KERNEL_TOL, gen,
                             lse=True, causal=False, layout="bhsd"))
    bwd.append(_flash_bwd_case(96, 256, 16, 16, 72, peaks, gen,
                               causal=False, layout="bhsd"))
    torch.cuda.empty_cache()
    # the long-sequence length at which the JAX package switches to its
    # streamed backward schedules (rows 2-4): S=8192, B=1, H=8, KV=2,
    # causal + LSE (the plain comparison's f32 scores: 2 GB a tensor)
    flash.append(_flash_case(1, 8192, 8, 2, hd, peaks, KERNEL_TOL, gen,
                             lse=True))
    bwd.append(_flash_bwd_case(1, 8192, 8, 2, hd, peaks, gen))
    torch.cuda.empty_cache()
    # bench.py's headline runs (the generate, long8k, layer8b and train05b
    # phases), at their attention shapes: the prefill of an 8192-token
    # prompt (no LSE); long8k's B=2 x 8192, the 8B layer's B=1 x 4096
    # and x 8192 (above S 2048, where the JAX package streams its
    # backward, rows 2-4); the 0.5B's B=16 x 2048, GQA 16/8. The plain
    # versions at S=8192 run one KV head's group at a time.
    flash.append(_flash_case(1, 8192, H, KV, hd, peaks, KERNEL_TOL, gen,
                             by_kv_head=True))
    for B_, S_, by in ((2, 8192, True), (1, 4096, False), (1, 8192, True)):
        flash.append(_flash_case(B_, S_, H, KV, hd, peaks, KERNEL_TOL, gen,
                                 lse=True, by_kv_head=by))
        torch.cuda.empty_cache()
    flash.append(_flash_case(16, 2048, 16, 8, hd, peaks, KERNEL_TOL, gen,
                             lse=True))
    for B_, S_ in ((2, 8192), (1, 8192)):
        bwd.append(_flash_bwd_case(B_, S_, H, KV, hd, peaks, gen,
                                   by_kv_head=True))
        torch.cuda.empty_cache()
    bwd.append(_flash_bwd_case(16, 2048, 16, 8, hd, peaks, gen))
    torch.cuda.empty_cache()
    # the dense and MoE steps' rows (long8k's 2 x 8192 rows are the dense
    # step's 16384), the 8B layer's 8192 and 4096 rows, and the 0.5B's
    # 16 x 2048 rows with its f32 weight
    rms = [_rms_cases(8 * 2048, 4096, peaks, gen),
           _rms_cases(20 * 2048, 2048, peaks, gen, eps=1e-6),
           _rms_cases(8192, 4096, peaks, gen),
           _rms_cases(4096, 4096, peaks, gen),
           _rms_cases(16 * 2048, 2048, peaks, gen, w_dtype=torch.float32)]
    # rows 11-12 at DiT-XL/2's [96, 256, 1152] bf16, and in f32 at a width
    # off the warp's round (776: 194 vectors) and a token count off the
    # backward's 32-token chunks; rows 13 and 16 at the MoE step's maps
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    adaln = [_adaln_cases(96, 256, 1152, torch.bfloat16, peaks, gen, flush),
             _adaln_cases(4, 100, 776, torch.float32, peaks, gen, flush)]
    mp = _moe_maps(gen)
    rows13 = [_gather_rows_case(mp, peaks, gen, flush)]
    rows16 = [_gather_mlp_case(mp, peaks, gen, flush)]
    del scratch, mp
    torch.cuda.empty_cache()
    adamw = []
    for path, shapes in (
            ("train", llama._shapes(llama.LlamaConfig.flagship_2b())),
            ("train_moe", moe._shapes(moe.MoeConfig.flagship_moe()))):
        for shape, names in _adamw_leaves(shapes):
            adamw.append({"path": path,
                          **_adamw_case(shape, names, peaks, gen)})
            torch.cuda.empty_cache()
    cases = {"flash_attention_fwd": flash, "ragged_paged_attention": ragged,
             "ragged_paged_attention_int8": ragged_int8,
             "ragged_paged_attention_suffix": ragged_suffix,
             "flash_attention_bwd": bwd,
             "rms_norm_fwd": [f for f, _ in rms],
             "rms_norm_bwd": [b for _, b in rms], "adamw_q": adamw,
             "gather_wsum": wsum, "gather_scale_dot": sdot,
             "layer_norm_fwd": [f for f, _ in lns],
             "layer_norm_bwd": [b for _, b in lns],
             "rms_norm_fused": rms_fused,
             "adaln_fwd": [f for f, _ in adaln],
             "adaln_bwd": [b for _, b in adaln],
             "gather_rows": rows13, "gather_mlp": rows16}
    _emit({"phase": "kernels", "tol": KERNEL_TOL, "lse_tol": LSE_TOL,
           "rstd_tol": RSTD_TOL, "adamw_code_frac": ADAMW_CODE_FRAC,
           "ln_f32_tol": LN_F32_TOL, "ln_stat_tol": LN_STAT_TOL,
           "ln_sum_tol": LN_SUM_TOL, "rms_f32_tol": RMS_F32_TOL,
           "adaln_f32_tol": ADALN_F32_TOL, "adaln_stat_tol": ADALN_STAT_TOL,
           "adaln_sum_tol": ADALN_SUM_TOL,
           "moe_routing": moe_info, **cases})
    torch.cuda.empty_cache()
    return cases


# -------------------------------------------------------------- 4. serve
@contextlib.contextmanager
def _off_by_one(paged):
    """Plant an off-by-one fault in forward_paged's plain attention, the
    control that shows the logits check can see a fault: the ragged path
    hides each query's own key (positions - 1), and the cold-prefill path
    shifts the keys and values by one position (query i loses key i and
    sees key 0 twice)."""
    flash, ragged = paged.flash_attention_fwd_ref, \
        paged.ragged_paged_attention_ref

    def shift(t):
        return torch.cat([t[:, :1], t[:, :-1]], dim=1)

    def flash_fault(q, k, v, causal=True, scale=None):
        return flash(q, shift(k), shift(v), causal=causal, scale=scale)

    def ragged_fault(q, k_pool, v_pool, table, positions, valid=None,
                     **opts):
        return ragged(q, k_pool, v_pool, table, (positions - 1).clamp(min=0),
                      valid, **opts)

    paged.flash_attention_fwd_ref = flash_fault
    paged.ragged_paged_attention_ref = ragged_fault
    try:
        yield
    finally:
        paged.flash_attention_fwd_ref = flash
        paged.ragged_paged_attention_ref = ragged


def _logits_check(params, cfg):
    """One fixed batch through forward_paged: a cold prefill of 4 ragged
    prompts (the flash kernel), a continuing 64-token chunk of each (the
    ragged kernel, as a chunked prefill runs it), then one decode step;
    the chunk and decode tokens are fixed, not sampled. It runs four
    ways, each on its own pool: bf16 with the kernels ("kernel"), bf16
    with their plain versions ("ref"), bf16 with the plain versions and
    a planted off-by-one fault ("fault", `_off_by_one`), and an f32
    evaluation of the plain versions ("f32": the same bf16 weights, cast
    to f32 where they are used). Returns, for each step, each bf16
    path's relative RMS distance from the f32 logits, and the kernel and
    fault paths' distances as ratios to the plain bf16 path's."""
    import dataclasses
    from paddle_tpu_torch.nlp import paged
    dev = "cuda"
    bs, P, C = 16, 300, 64
    lengths = torch.tensor([300, 150, 257, 64], dtype=torch.int32,
                           device=dev)
    B = len(lengths)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(1, cfg.vocab_size, (B, P + C + 1), device=dev,
                         generator=gen)
    M = -(-(P + C + 1) // bs)
    table = torch.arange(B * M, dtype=torch.int32, device=dev).view(B, M)
    steps = []                  # (tokens, positions, valid, is_prefill)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
    steps.append((toks[:, :P], pos, pos < lengths[:, None], True))
    pos = lengths[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=dev)[None]
    steps.append((toks[:, P:P + C], pos, torch.ones_like(pos, dtype=bool),
                  False))
    pos = lengths[:, None] + C
    steps.append((toks[:, P + C:], pos, torch.ones_like(pos, dtype=bool),
                  False))
    runs = {"kernel": (cfg, "kernel"), "ref": (cfg, "ref"),
            "fault": (cfg, "ref"),
            "f32": (dataclasses.replace(cfg, dtype=torch.float32), "ref")}
    res = {}
    for name, (c, impl) in runs.items():
        k, v, _, _ = paged.init_pool(c, B * M, bs, device=dev)
        cache = paged.PagedKVCache(k, v, table,
                                   torch.zeros(B, dtype=torch.int32,
                                               device=dev))
        res[name] = []
        with (_off_by_one(paged) if name == "fault"
              else contextlib.nullcontext()):
            for tk, ps, vl, cold in steps:
                lg, cache = paged.forward_paged(params, tk, cache, ps, vl,
                                                c, is_prefill=cold,
                                                attention_impl=impl)
                res[name].append(lg[vl])
        del k, v, cache, lg

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out = {}
    for i, step in enumerate(("prefill", "chunk", "decode")):
        f32 = res["f32"][i]
        c = {f"{n}_vs_f32": rel(res[n][i], f32)
             for n in ("kernel", "ref", "fault")}
        c["kernel_vs_ref"] = rel(res["kernel"][i], res["ref"][i])
        c["kernel_ratio"] = c["kernel_vs_f32"] / c["ref_vs_f32"]
        c["fault_ratio"] = c["fault_vs_f32"] / c["ref_vs_f32"]
        for n in ("kernel", "ref"):
            c[f"greedy_agree_{n}_f32"] = (
                res[n][i].argmax(-1) == f32.argmax(-1)).float().mean().item()
        out[step] = c
    return out


# Logits tolerance of the kernels over 32 bf16 layers. The kernel path
# and the plain path both evaluate the model in bf16 and differ only in
# where the attention rounds (the kernels round the probabilities to
# bf16 before P.V and rescale online). Over 32 random layers any such
# one-ulp difference is amplified until it is as large as the error of
# bf16 evaluation itself, so no fixed bound derived from one layer holds.
# The bound that does hold is relative to that error: the kernels may
# not carry the logits further from an f32 evaluation than the plain
# bf16 path is, with 1.5x for the spread between two equally good bf16
# evaluations of a 4-prompt batch. The planted off-by-one fault must
# land above the bound on every step, or the check is blind. On an H100
# SXM at 700 W the kernels read 1.007-1.017 and the fault 7.7-14.2
# (prefill 14.2, chunk 9.5, decode 7.7): 1.5 sits between the two,
# nearer the sound reading, which is deterministic for this seed, so
# that a fault smaller than an off-by-one still shows.
LOGITS_VS_F32_RATIO = 1.5


# The serve sizing's step shapes: the bucket ladder 8 ... 512 (7 buckets)
# x group sizes {1, 2, 4, 8} x {cold, cached} (56 standalone prefills),
# the 7 buckets x 4 fused row counts (28), and the decode chunk.
SERVE_GRAPHS = 7 * 4 * 2 + 7 * 4 + 1


def _warmup_prompt(cfg):
    """A 16-token prompt of its own for an engine's warm-up request: a
    burst prompt's leading block would stay in the prefix cache (on by
    default) and turn that request's cold prefill into a continuation."""
    return np.random.RandomState(SEED + 7).randint(
        1, cfg.vocab_size, 16).tolist()


def _counter_objs():
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.nlp.ragged_attention import ragged_paged_attention
    return {"flash_attention_fwd": (flash_attention_fwd, "launches"),
            "ragged_paged_attention": (ragged_paged_attention, "launches"),
            "ragged_paged_attention_int8": (ragged_paged_attention,
                                            "launches_int8"),
            "ragged_paged_attention_suffix": (ragged_paged_attention,
                                              "launches_suffix")}


def _zero_serve_counters() -> None:
    for obj, attr in _counter_objs().values():
        setattr(obj, attr, 0)


def _read_serve_counters() -> dict:
    return {n: getattr(obj, attr) for n, (obj, attr) in
            _counter_objs().items()}


def _release() -> None:
    """Free what a dropped batcher held on the card: its step graphs
    close over the batcher (a reference cycle), so its params, pool and
    graph memory pool go only when the cycle collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def _memory() -> dict:
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "peak_allocated": torch.cuda.max_memory_allocated()}


def _drive_batch(cb, prompts, budget, chunk_walls=None):
    """Submit `prompts` to a batcher at once and step it to the end;
    with `chunk_walls`, append the wall time (ms, each step ending in its
    own host read) of every step that was a plain decode chunk: nothing
    queued or pending, every slot decoding. Returns the tokens."""
    rids = [cb.submit(p, max_new_tokens=budget) for p in prompts]
    while any(cb.active) or cb.queue or cb._pending:
        plain = (chunk_walls is not None and not cb.queue
                 and not cb._pending and all(cb.active))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb.step()
        if plain:
            chunk_walls.append((time.perf_counter() - t0) * 1e3)
    return [list(cb.outputs[r]) for r in rids]


class _StaleDecode:
    """The graph check's planted control: the decode chunk's graph
    replayed with only its block table refreshed — tokens, lengths and
    the active/budget/stop mirrors stay whatever the last replay left in
    its static inputs. A graph that reads stale inputs must show."""

    def __init__(self, entry):
        self.entry = entry

    def __call__(self, **inputs):
        e = self.entry
        e.static["table"].copy_(inputs["table"])
        e.graph.replay()
        return e.out


def _graph_check(params, cfg, graphed, n_requests: int = 8,
                 budget: int = 24):
    """The graphed batcher (the serve engine's, warmed: every step a
    replay) against its eager twin (`_graphed=False`: the same steps run
    eagerly, the kernels launched, nothing captured) on the same
    prompts: the tokens must be identical, and the decode-only chunks'
    walls are reported side by side. Then the planted control: the
    graphed batcher again with its decode graph replayed on stale slot
    state (`_StaleDecode`) must read different tokens."""
    from paddle_tpu_torch.nlp import paged
    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.randint(150, 257, n_requests)]
    eager = paged.ContinuousBatcher(
        params, cfg, max_batch=8, block_size=16, max_total_len=1024,
        max_new_tokens=32, max_prefill_bucket=512, prefix_cache=True,
        _graphed=False)
    walls = {"graphed": [], "eager": []}
    c0 = graphed.compile_count
    want = _drive_batch(eager, prompts, budget, walls["eager"])
    del eager
    _release()
    got = _drive_batch(graphed, prompts, budget, walls["graphed"])
    if graphed.compile_count != c0:
        raise AssertionError(f"graph check: {graphed.compile_count - c0} "
                             f"shapes captured after warmup")
    key = next(iter(graphed._chunk_cache))
    live = graphed._chunk_cache[key]
    if not live.graphed:
        raise AssertionError("graph check: the decode entry is not a graph")
    graphed._chunk_cache[key] = _StaleDecode(live)
    try:
        stale = _drive_batch(graphed, prompts, budget)
    finally:
        graphed._chunk_cache[key] = live
    same = sum(a == b for x, y in zip(want, got) for a, b in zip(x, y))
    stale_same = sum(a == b for x, y in zip(want, stale)
                     for a, b in zip(x, y))
    n = sum(len(x) for x in want)
    res = {"phase": "graph_check", "requests": n_requests,
           "budget": budget, "tokens": n, "identical": got == want,
           "tokens_equal": same, "control_tokens_equal": stale_same,
           "control_detected": stale != want,
           "decode_chunk_wall_ms": walls,
           "decode_chunk_wall_ms_median": {
               k: float(np.median(v)) if v else None
               for k, v in walls.items()},
           "nvidia_smi": _smi_line()}
    _emit(res)
    if got != want:
        raise AssertionError(f"graph check: the graphed batcher's tokens "
                             f"differ from its eager twin's ({same} of {n} "
                             f"equal)")
    if stale == want:
        raise AssertionError("graph check: the decode graph replayed on "
                             "stale slot state read the same tokens: the "
                             "check cannot see stale inputs")
    if not walls["graphed"] or not walls["eager"]:
        raise AssertionError(f"graph check: no decode-only chunk: {walls}")
    return res


def phase_serve(layers: int = 32, n_requests: int = 12):
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.serving import RequestState, ServingEngine

    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the JAX engine's defaults (prefix cache, trace, SLOs on); every
    # step shape captured before the loop starts
    eng = ServingEngine(params, cfg, max_batch=8, block_size=16,
                        max_total_len=1024, max_new_tokens=32,
                        max_prefill_bucket=512, start=False)
    torch.cuda.reset_peak_memory_stats()
    mem_before = _memory()
    t0 = time.perf_counter()
    graphs = eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    mem_after = _memory()
    if graphs != SERVE_GRAPHS or eng.batcher.compile_count != SERVE_GRAPHS:
        raise AssertionError(f"warmup captured {graphs} step shapes "
                             f"({eng.batcher.compile_count} in the memo), "
                             f"not {SERVE_GRAPHS}")
    if eng.health()["ready"] is not False:
        raise AssertionError("health() ready before start()")
    eng.start()
    rng = np.random.RandomState(SEED)
    lengths = rng.randint(16, 513, n_requests)
    lengths[[3, 7]] = rng.randint(513, 701, 2)        # chunked prefill
    budgets = [(32, 24, 16)[i % 3] for i in range(n_requests)]
    prompts = [rng.randint(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    try:
        # warm-up: cuBLAS handles and the allocator, outside the counts;
        # its own prompt, so the prefix cache holds no block of the burst
        eng.generate(_warmup_prompt(cfg), max_new_tokens=2, timeout=600)
        if not eng.health()["ready"]:
            raise AssertionError(f"health() not ready: {eng.health()}")
        cc_before = eng.batcher.compile_count
        _zero_serve_counters()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.monotonic()
        # 3 at once (a cold prefill with nothing decoding), then each
        # later request as soon as the one before it streams a token
        reqs = [eng.submit(prompts[i], max_new_tokens=budgets[i])
                for i in range(3)]
        streamed: list = []
        consumer = threading.Thread(
            target=lambda: streamed.extend(reqs[0].stream()))
        consumer.start()
        for i in range(3, n_requests):
            while not reqs[-1].tokens and not reqs[-1].done:
                time.sleep(0.002)
            reqs.append(eng.submit(prompts[i], max_new_tokens=budgets[i]))
        for r in reqs:
            r.wait(timeout=900)
        t_end = time.monotonic()
        consumer.join(timeout=60)
        if not eng.drain(timeout=120):
            raise AssertionError("engine did not drain")
        launches = _read_serve_counters()
        cc_after = eng.batcher.compile_count
        peak = torch.cuda.max_memory_allocated()
        snap = eng.snapshot()
        health = eng.health()
        prom = eng.metrics.to_prometheus()
    finally:
        clean = eng.shutdown(timeout=120)
    if not clean:
        raise AssertionError("engine shutdown was not clean")
    for i, r in enumerate(reqs):
        if r.state is not RequestState.FINISHED:
            raise AssertionError(f"request {i} ended {r.state.name}: "
                                 f"{r.error!r}")
        if len(r.tokens) != budgets[i] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {i}: bad output {r.tokens}")
    if streamed != reqs[0].tokens:
        raise AssertionError("stream() disagrees with the result")
    g = snap["gauges"]
    if g["fused_steps"] < 1:
        raise AssertionError("no fused prefill+decode step ran")
    if g["kv_blocks_in_use"] != 0:
        raise AssertionError(f"{g['kv_blocks_in_use']} KV blocks leaked")
    if cc_after != cc_before:
        raise AssertionError(f"compile_count moved through the burst: "
                             f"{cc_before} -> {cc_after}")
    for name in ("flash_attention_fwd", "ragged_paged_attention"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched while serving")
    if "slo_burn_rate_ttft_s_p99" not in prom or health["status"] != \
            "HEALTHY":
        raise AssertionError(f"observability: {health}")
    # the batcher-level graph check, on the serve engine's warmed batcher
    graph = _graph_check(params, cfg, eng.batcher)
    del eng
    _release()
    check = _logits_check(params, cfg)
    _emit({"phase": "logits_check", "ratio_tol": LOGITS_VS_F32_RATIO,
           **check})
    for name, c in check.items():
        if not c["kernel_ratio"] <= LOGITS_VS_F32_RATIO:
            raise AssertionError(
                f"{name} logits: the kernels are {c['kernel_vs_f32']} from "
                f"f32, more than {LOGITS_VS_F32_RATIO} x the plain bf16 "
                f"path's {c['ref_vs_f32']}: {c}")
        if not c["fault_ratio"] > LOGITS_VS_F32_RATIO:
            raise AssertionError(
                f"{name} logits: the planted off-by-one fault reads "
                f"{c['fault_ratio']} x the plain bf16 path's distance, "
                f"within the {LOGITS_VS_F32_RATIO} bound: the check "
                f"cannot see it: {c}")
    ttft = np.array([r.first_token_time - r.submit_time for r in reqs])
    ntok = sum(len(r.tokens) for r in reqs)
    res = {"phase": "serve", "layers": layers,
           "widths": {"D": cfg.hidden_size, "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "hd": cfg.head_dim,
                      "F": cfg.intermediate_size, "V": cfg.vocab_size},
           "requests": n_requests, "prompt_lengths": lengths.tolist(),
           "tokens": ntok, "wall_s": t_end - t_start,
           "tokens_per_s": ntok / (t_end - t_start),
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "warmup_graphs": graphs, "warmup_s": warmup_s,
           "memory_before_warmup": mem_before,
           "memory_after_warmup": mem_after,
           "graph_pool_reserved_bytes": mem_after["reserved"]
           - mem_before["reserved"],
           "compile_count_before_burst": cc_before,
           "compile_count_after_burst": cc_after,
           "peak_memory_bytes": peak, "param_init_s": init_s,
           "launches": launches, "launches_by": "graph replay",
           "fused_steps": g["fused_steps"],
           "decode_stall_steps": g["decode_stall_steps"],
           "prefill_pad_tokens": g["prefill_pad_tokens"],
           "health": {k: health[k] for k in ("status", "ready")},
           "slo_verdict": health["slo"]["verdict"],
           "decode_chunk_wall_ms": graph["decode_chunk_wall_ms_median"],
           "graph_check": {k: graph[k] for k in
                           ("identical", "control_detected", "tokens")},
           "logits_check": check,
           "logits_vs_f32_ratio_tol": LOGITS_VS_F32_RATIO,
           "nvidia_smi": _smi_line()}
    _emit(res)
    return res


# ------------------------------------------------------- 4a. serve_prefix
PREFIX_TOKENS = 384             # 24 blocks of 16


def _prefix_burst(params, cfg, prompts, budget, kw):
    """One ServingEngine at the serve sizing with `kw`, every step shape
    captured first; `prompts` submitted at once with the launch counters
    zeroed just before and read just after. Returns the tokens, TTFTs,
    launches and the prefix statistics; the pool must drain."""
    from paddle_tpu_torch.serving import RequestState, ServingEngine
    eng = ServingEngine(params, cfg, max_batch=8, block_size=16,
                        max_total_len=1024, max_new_tokens=budget,
                        max_prefill_bucket=512, start=False, **kw)
    try:
        eng.warmup()
        eng.start()
        _zero_serve_counters()
        t0 = time.monotonic()
        reqs = [eng.submit(p) for p in prompts]
        for r in reqs:
            r.wait(timeout=900)
        wall = time.monotonic() - t0
        if not eng.drain(timeout=120):
            raise AssertionError(f"{kw}: the engine did not drain")
        launches = _read_serve_counters()
        snap = eng.snapshot()
    finally:
        clean = eng.shutdown(timeout=120)
        del eng
        _release()
    if not clean:
        raise AssertionError(f"{kw}: engine shutdown was not clean")
    for i, r in enumerate(reqs):
        if r.state is not RequestState.FINISHED or len(r.tokens) != budget:
            raise AssertionError(f"{kw}: request {i} ended {r.state.name} "
                                 f"with {len(r.tokens)} tokens: {r.error!r}")
    if snap["allocator"]["blocks_in_use"] != 0:
        raise AssertionError(f"{kw}: {snap['allocator']['blocks_in_use']} "
                             f"KV blocks leaked")
    ttft = np.array([r.first_token_time - r.submit_time for r in reqs])
    return {"tokens": [list(r.tokens) for r in reqs], "wall_s": wall,
            "ttft_s": ttft.tolist(),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "launches": launches, "prefix_cache": snap["prefix_cache"],
            "allocator": snap["allocator"],
            "compile_count": snap["gauges"]["compile_count"]}


def _match_rate(a, b) -> float:
    pairs = [(x, y) for p, q in zip(a, b) for x, y in zip(p, q)]
    return sum(x == y for x, y in pairs) / len(pairs)


def phase_serve_prefix(layers: int = 32, n_requests: int = 8,
                       budget: int = 16):
    """Prefix caching at Llama-3-8B widths (random bf16 weights from the
    seed): 8 requests sharing a 384-token prefix, each with its own
    16-128 token suffix, submitted at once to a warmed engine with the
    prefix cache on, then to one with it off. The warm run must hit
    (hit tokens > 0) and both must drain; the TTFTs and the token match
    rate of warm against cold are reported (a rate: warm requests
    continue through row 18 where cold ones prefill through row 1).
    Then one full-prefix copy-on-write hit over the int8 pool: the same
    384-token prompt twice, the second a whole-prompt hit that copies
    its last block (codes and scales) and recomputes one token."""
    from paddle_tpu_torch.nlp import llama
    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(SEED + 5)
    prefix = rng.randint(1, cfg.vocab_size, PREFIX_TOKENS).tolist()
    suffixes = rng.randint(16, 129, n_requests)
    prompts = [prefix + rng.randint(1, cfg.vocab_size, int(n)).tolist()
               for n in suffixes]
    t0 = time.perf_counter()
    warm = _prefix_burst(params, cfg, prompts, budget, {})
    cold = _prefix_burst(params, cfg, prompts, budget,
                         {"prefix_cache": False})
    pc = warm["prefix_cache"]
    if not pc["hit_tokens"] > 0:
        raise AssertionError(f"the shared prefix never hit: {pc}")
    for name, r in (("warm", warm), ("cold", cold)):
        for k in ("flash_attention_fwd", "ragged_paged_attention"):
            if r["launches"][k] < 1:
                raise AssertionError(f"serve_prefix {name}: {k} never "
                                     f"launched: {r['launches']}")
    # the copy-on-write full hit over the int8 pool (lazily captured)
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(params, cfg, max_batch=8, block_size=16,
                        max_total_len=1024, max_new_tokens=budget,
                        max_prefill_bucket=512, kv_dtype="int8")
    try:
        _zero_serve_counters()
        out1 = eng.generate(prefix, timeout=600)
        hit0 = eng.snapshot()["prefix_cache"]["hit_tokens"]
        out2 = eng.generate(prefix, timeout=600)
        if not eng.drain(timeout=120):
            raise AssertionError("int8 COW: the engine did not drain")
        cow_launches = _read_serve_counters()
        snap = eng.snapshot()
        pcs, blocks = snap["prefix_cache"], \
            snap["allocator"]["blocks_in_use"]
    finally:
        clean = eng.shutdown(timeout=120)
        del eng
        _release()
    cow_hit = pcs["hit_tokens"] - hit0
    if not clean or blocks != 0:
        raise AssertionError(f"int8 COW: clean {clean}, {blocks} blocks "
                             f"leaked")
    if cow_hit != PREFIX_TOKENS - 1:
        raise AssertionError(f"int8 COW: the full hit served {cow_hit} "
                             f"tokens, not {PREFIX_TOKENS - 1}")
    if cow_launches["ragged_paged_attention_int8"] < 1:
        raise AssertionError(f"int8 COW: launches {cow_launches}")
    launches = {k: warm["launches"][k] + cold["launches"][k]
                + cow_launches[k] for k in warm["launches"]}
    res = {"phase": "serve_prefix", "layers": layers,
           "requests": n_requests, "budget": budget,
           "prefix_tokens": PREFIX_TOKENS,
           "suffix_lengths": suffixes.tolist(),
           "hit_tokens": pc["hit_tokens"], "hit_rate": pc["hit_rate"],
           "prefix_cache": pc,
           "ttft_p50_s": {"warm": warm["ttft_p50_s"],
                          "cold": cold["ttft_p50_s"]},
           "ttft_p99_s": {"warm": warm["ttft_p99_s"],
                          "cold": cold["ttft_p99_s"]},
           "wall_s": {"warm": warm["wall_s"], "cold": cold["wall_s"]},
           "tokens_per_s": {k: n_requests * budget / r["wall_s"]
                            for k, r in (("warm", warm), ("cold", cold))},
           "match_rate_warm_vs_cold": _match_rate(warm["tokens"],
                                                  cold["tokens"]),
           "first_token_match_warm_vs_cold": _match_rate(
               [t[:1] for t in warm["tokens"]],
               [t[:1] for t in cold["tokens"]]),
           "graphs": {"warm": warm["compile_count"],
                      "cold": cold["compile_count"]},
           "launches_by_run": {"warm": warm["launches"],
                               "cold": cold["launches"],
                               "int8_cow": cow_launches},
           "launches": launches,
           "int8_cow": {"hit_tokens": cow_hit,
                        "match_rate_vs_first": _match_rate([out1],
                                                           [out2])},
           "serve_s": time.perf_counter() - t0,
           "nvidia_smi": _smi_line()}
    _emit(res)
    del params
    _release()
    return res


# ---------------------------------------------------- 4b. serve_quant_spec
# (name, engine kwargs, the plain twin its tokens are matched against):
# (a) int8 weights and KV, plain decode; (b) int8 KV with a full-depth
# chain draft of 4 (the draft is the target: nearly everything accepts,
# driving multi-row commits and int8 scale growth); (c) a [2, 2, 1] tree
# drafted from the first 8 layers' int8 quantization over the fp pool (a
# truncated draft of random weights accepts little: the reject path)
_QUANT_SPEC_CASES = (
    ("a", dict(weight_dtype="int8", kv_dtype="int8"), None),
    ("b", dict(kv_dtype="int8", speculative=True, spec_k=4), "b_twin"),
    ("c", dict(speculative=True, spec_tree=[2, 2, 1], draft_layers=8,
               spec_draft_w8=True), "c_twin"),
)
_QUANT_SPEC_TWINS = {"b_twin": dict(kv_dtype="int8"), "c_twin": {}}


def _serve_burst(params, cfg, prompts, budget, kw):
    """One ServingEngine at the phase's sizing with `kw`, warmed by one
    short request, then `prompts` submitted at once with the launch
    counters zeroed just before and read just after. Checks that every
    request finishes with `budget` in-vocabulary tokens and the pool
    drains; returns the tokens, rates, TTFTs, peak memory (from before
    the engine's construction: the int8 trees are made there), launches
    by option and the burst's own speculative counters."""
    from paddle_tpu_torch.kernels.flash_attention import \
        flash_attention_fwd as flash
    from paddle_tpu_torch.nlp.ragged_attention import \
        ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import RequestState, ServingEngine
    _release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, max_batch=8, block_size=16,
                        max_total_len=1024, max_new_tokens=budget,
                        max_prefill_bucket=512, start=True, **kw)
    build_s = time.perf_counter() - t0
    try:
        eng.generate(_warmup_prompt(cfg), max_new_tokens=2, timeout=600)
        s0 = eng.batcher.spec.as_dict()
        flash.launches = rpa.launches = 0
        rpa.launches_int8 = rpa.launches_suffix = 0
        t_start = time.monotonic()
        reqs = [eng.submit(p) for p in prompts]
        for r in reqs:
            r.wait(timeout=900)
        t_end = time.monotonic()
        if not eng.drain(timeout=120):
            raise AssertionError(f"{kw}: the engine did not drain")
        launches = {"flash_attention_fwd": flash.launches,
                    "ragged_paged_attention": rpa.launches,
                    "ragged_paged_attention_int8": rpa.launches_int8,
                    "ragged_paged_attention_suffix": rpa.launches_suffix}
        peak = torch.cuda.max_memory_allocated()
        snap = eng.snapshot()
        s1 = eng.batcher.spec.as_dict()
    finally:
        clean = eng.shutdown(timeout=120)
        del eng
        _release()
    if not clean:
        raise AssertionError(f"{kw}: engine shutdown was not clean")
    for i, r in enumerate(reqs):
        if r.state is not RequestState.FINISHED:
            raise AssertionError(f"{kw}: request {i} ended {r.state.name}: "
                                 f"{r.error!r}")
        if len(r.tokens) != budget or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"{kw}: request {i}: bad output {r.tokens}")
    if snap["gauges"]["kv_blocks_in_use"] != 0:
        raise AssertionError(f"{kw}: {snap['gauges']['kv_blocks_in_use']} "
                             f"KV blocks leaked")
    ttft = np.array([r.first_token_time - r.submit_time for r in reqs])
    ntok = sum(len(r.tokens) for r in reqs)
    burst = {k: s1[k] - s0[k] for k in ("steps", "slot_sweeps", "drafted",
                                        "accepted", "emitted")}
    sweeps = max(burst["slot_sweeps"], 1)
    return {"kw": kw, "tokens": [list(r.tokens) for r in reqs],
            "tokens_generated": ntok, "wall_s": t_end - t_start,
            "tokens_per_s": ntok / (t_end - t_start),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "peak_memory_bytes": peak, "engine_build_s": build_s,
            "graphs_captured_lazily": snap["gauges"]["compile_count"],
            "launches": launches, "fused_steps": snap["gauges"]["fused_steps"],
            "quantization": snap["quantization"], "spec_burst": burst,
            "accepted_per_sweep": burst["accepted"] / sweeps,
            "tokens_per_sweep": burst["emitted"] / sweeps}


def _verify_logits_check(params, cfg):
    """The verify's logits through the kernels against an f32 evaluation:
    a cold prefill of 4 ragged prompts writes int8 pools (flash, the int8
    write), then a chain verify of 5 tokens (spec_k 4) and a tree verify
    of [2, 2, 1] (11 nodes) score the read-only pool plus the slab
    (`_forward_spec`: row 18's int8 and suffix options at once). Four
    ways, each on its own pools: bf16 with the kernels, bf16 with the
    plain versions, the plain versions with the slab visibility shifted
    by one row (the planted fault), and f32 with the plain versions.
    Returns each verify's relative RMS distances from f32 and the
    kernel's and fault's ratios to the plain bf16 path's."""
    import dataclasses
    from paddle_tpu_torch.nlp import paged
    from paddle_tpu_torch.serving.speculative import SpecConfig
    dev = "cuda"
    bs, P = 16, 300
    lengths = torch.tensor([300, 150, 257, 64], dtype=torch.int32,
                           device=dev)
    B = len(lengths)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    toks = torch.randint(1, cfg.vocab_size, (B, P + 11), device=dev,
                         generator=gen)
    M = -(-(P + 11) // bs)
    table = torch.arange(B * M, dtype=torch.int32, device=dev).view(B, M)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
    sc = SpecConfig(tree=[2, 2, 1])
    verifies = {
        "chain": (5, torch.arange(5, device=dev),
                  torch.tril(torch.ones(5, 5, dtype=torch.bool,
                                        device=dev))),
        "tree": (sc.slab_rows(), torch.tensor(sc.row_levels(), device=dev),
                 torch.tensor(sc.ancestor_mask(), device=dev))}
    runs = {"kernel": (cfg, "kernel"), "ref": (cfg, "ref"),
            "fault": (cfg, "ref"),
            "f32": (dataclasses.replace(cfg, dtype=torch.float32), "ref")}
    res = {}
    for name, (c, impl) in runs.items():
        k, v, ks, vs = paged.init_pool(c, B * M, bs, device=dev,
                                       kv_dtype="int8")
        cache = paged.PagedKVCache(k, v, table,
                                   torch.zeros(B, dtype=torch.int32,
                                               device=dev), ks, vs)
        _, cache = paged.forward_paged(params, toks[:, :P], cache, pos,
                                       pos < lengths[:, None], c,
                                       is_prefill=True, attention_impl=impl)
        res[name] = {}
        for vname, (S, lv, vis) in verifies.items():
            if name == "fault":
                vis = vis.roll(1, dims=-1)
            shape = (c.num_hidden_layers, B, S, c.num_key_value_heads,
                     c.head_dim)
            sk = torch.zeros(shape, dtype=c.dtype, device=dev)
            sv = torch.zeros_like(sk)
            lg, _, _ = paged._forward_spec(
                params, params["layers"], toks[:, P:P + S], cache,
                lengths[:, None] + lv[None], lengths, sk, sv, 0, c, vis=vis,
                attention_impl=impl)
            res[name][vname] = lg
        del k, v, ks, vs, cache, sk, sv

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out = {}
    for vname in verifies:
        f32 = res["f32"][vname]
        c = {f"{n}_vs_f32": rel(res[n][vname], f32)
             for n in ("kernel", "ref", "fault")}
        c["kernel_ratio"] = c["kernel_vs_f32"] / c["ref_vs_f32"]
        c["fault_ratio"] = c["fault_vs_f32"] / c["ref_vs_f32"]
        c["greedy_agree_kernel_f32"] = (
            res["kernel"][vname].argmax(-1) == f32.argmax(-1)
        ).float().mean().item()
        out[vname] = c
    return out


def phase_serve_quant_spec(layers: int = 32, n_requests: int = 8,
                           budget: int = 32):
    """Quantized and speculative serving at Llama-3-8B widths (random bf16
    weights from the seed, `layers` layers): 8 requests of 16-700 prompt
    tokens through ServingEngine as (a), (b) and (c) of
    `_QUANT_SPEC_CASES`, and (b)'s and (c)'s plain twins (the same kv and
    weight dtypes, no speculation). Each must finish every request and
    drain the pool; row 18's int8 option must launch in (a) and (b) and
    its suffix option in (b) and (c) (and not where the case cannot reach
    them); the full-depth chain must accept more than one token a sweep
    on average. The spec tokens' match rate against the plain twin is
    reported (greedy near-ties round differently on the two paths).
    Then `_verify_logits_check`."""
    from paddle_tpu_torch.nlp import llama
    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(SEED + 3)
    lengths = rng.randint(16, 513, n_requests)
    lengths[[2, 5]] = rng.randint(513, 701, 2)        # chunked prefill
    prompts = [rng.randint(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    t0 = time.perf_counter()
    runs = {}
    for name, kw, twin in _QUANT_SPEC_CASES:
        if twin is not None:
            runs[twin] = _serve_burst(params, cfg, prompts, budget,
                                      _QUANT_SPEC_TWINS[twin])
        runs[name] = _serve_burst(params, cfg, prompts, budget, kw)
    for name, _, twin in _QUANT_SPEC_CASES:
        r = runs[name]
        if twin is not None:
            ref = runs[twin]["tokens"]
            pairs = [(x, y) for a, b in zip(ref, r["tokens"])
                     for x, y in zip(a, b)]
            r["match_rate_vs_plain_twin"] = sum(x == y for x, y in pairs) \
                / len(pairs)
        n = r["launches"]
        want_int8 = "kv_dtype" in r["kw"]
        want_suffix = bool(r["kw"].get("speculative"))
        if (n["ragged_paged_attention_int8"] >= 1) != want_int8 or \
                (n["ragged_paged_attention_suffix"] >= 1) != want_suffix or \
                n["flash_attention_fwd"] < 1:
            raise AssertionError(f"({name}) {r['kw']}: launches {n}")
    if not runs["b"]["accepted_per_sweep"] > 1.0:
        raise AssertionError(f"(b): the full-depth chain accepted "
                             f"{runs['b']['accepted_per_sweep']} a sweep")
    serve_s = time.perf_counter() - t0
    check = _verify_logits_check(params, cfg)
    del params
    torch.cuda.empty_cache()
    _emit({"phase": "verify_logits_check",
           "ratio_tol": LOGITS_VS_F32_RATIO, **check})
    for name, c in check.items():
        if not c["kernel_ratio"] <= LOGITS_VS_F32_RATIO:
            raise AssertionError(
                f"{name} verify logits: the kernels are {c['kernel_vs_f32']}"
                f" from f32, more than {LOGITS_VS_F32_RATIO} x the plain "
                f"bf16 path's {c['ref_vs_f32']}: {c}")
        if not c["fault_ratio"] > LOGITS_VS_F32_RATIO:
            raise AssertionError(
                f"{name} verify logits: the shifted slab visibility reads "
                f"{c['fault_ratio']} x the plain bf16 path's distance, "
                f"within the {LOGITS_VS_F32_RATIO} bound: {c}")
    cases = {name: {k: v for k, v in r.items() if k != "tokens"}
             for name, r in runs.items()}
    launches = {k: sum(runs[n]["launches"][k] for n, _, _ in
                       _QUANT_SPEC_CASES)
                for k in runs["a"]["launches"]}
    res = {"phase": "serve_quant_spec", "layers": layers,
           "requests": n_requests, "budget": budget,
           "prompt_lengths": lengths.tolist(), "cases": cases,
           "launches": launches, "serve_s": serve_s,
           "verify_logits_check": check, "nvidia_smi": _smi_line()}
    _emit(res)
    return res


# -------------------------------------------------------------- 5. train
def _train_counters(moe: bool = False):
    """The launch counters of a training step's kernels; with `moe`, the
    MoE dispatch kernels too."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.optimizer import quant_state as qs
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "rms_norm_fwd": rn.rms_norm_fwd,
                "rms_norm_bwd": rn.rms_norm_bwd,
                "adamw_q": qs.fused_leaf_update}
    if moe:
        counters.update({"gather_wsum": md.gather_wsum,
                         "gather_scale_dot": md.gather_scale_dot})
    return counters


def _drive_train(peaks, model, cfg, batch, counters, warmup, timed, seq,
                 state_quant="8bit"):
    """`model`'s config through the public training entry points: counters
    zeroed, `warmup` then `timed` steps of one seeded batch, one
    synchronize around the timed ones; `state_quant` "8bit" (the fused
    8-bit AdamW) or None (the tree adamw behind a global-norm clip).
    Returns (result, state, tokens)."""
    from paddle_tpu_torch.nlp import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tx = train.make_optimizer(1e-4, state_quant=state_quant, grad_clip=1.0)
    state = train.init_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, tx,
        model=model)
    step = train.make_train_step(cfg, tx, model=model)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    metrics = []
    for _ in range(warmup):
        state, m = step(state, tokens)
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, tokens)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    steps = warmup + timed
    tok_s = batch * seq * timed / dt
    fpt = model.flops_per_token(cfg, seq)
    res = {"params": model.num_params(cfg), "state_quant": state_quant,
           "batch": batch, "seq": seq, "steps": steps, "timed_steps": timed,
           "step_ms": dt / timed * 1e3, "tokens_per_s": tok_s,
           "flops_per_token": fpt, "mfu": tok_s * fpt / peaks[0],
           "losses": losses, "grad_norms": norms,
           "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()}}
    return res, state, tokens


def _check_losses(res):
    losses, norms = res["losses"], res["grad_norms"]
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")


def phase_train(peaks, warmup: int = 2, timed: int = 4, batch: int = 8,
                seq: int = 2048):
    """The flagship config through the public training entry points."""
    from paddle_tpu_torch.nlp import llama

    cfg = llama.LlamaConfig.flagship_2b()
    res, state, _ = _drive_train(peaks, llama, cfg, batch,
                                 _train_counters(), warmup, timed, seq)
    res = {"phase": "train", "config": "flagship_2b (bench.py:120)",
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size},
           **res, "nvidia_smi": _smi_line()}
    _emit(res)
    del state
    torch.cuda.empty_cache()
    _check_losses(res)
    for name, n in res["launches"].items():
        if n < 1:
            raise AssertionError(f"{name} never launched while training")
    return res


@contextlib.contextmanager
def _moe_routing_probe(replay=None):
    """Record the routing maps (eidx, slot, valid, inv) of every
    `top_k_routing` call of the MoE model inside, per layer: layers are
    told apart by their gate weight's view, the same tensor in a
    forward, its recompute and a later forward over the same leaves.
    Yields (maps {layer: maps}, repeats {"calls", "differ"}), where a
    repeat is a later call for a layer already seen (the recompute) and
    "differ" counts those whose maps were not the same bits. With
    `replay` ({layer: maps} of another evaluation), each layer routes by
    those maps instead, its gate probs and aux losses taken from its own
    logits: dispatch and combine held at the block level."""
    from paddle_tpu_torch.nlp import moe
    block, route = moe.moe_block, moe.top_k_routing
    layer_of, cur, maps = {}, [None], {}
    repeats = {"calls": 0, "differ": 0}

    def block_probe(x, lp, cfg, mesh=None):
        cur[0] = layer_of.setdefault(lp["gate"].data_ptr(), len(layer_of))
        return block(x, lp, cfg, mesh)

    def replayed(logits, m, renormalize):
        eidx, slot, valid, inv = m
        E = logits.shape[-1]
        probs_full = torch.softmax(logits.float(), dim=-1)
        probs = torch.gather(probs_full, -1, eidx.long())
        if renormalize:
            probs = probs / torch.clamp(probs.sum(-1, keepdim=True),
                                        min=1e-9)
        first = (eidx[..., 0:1] == torch.arange(E, device=eidx.device))
        aux = {"load_balance_loss": E * torch.sum(
                   first.float().mean(-2) * probs_full.mean(-2), dim=-1),
               "router_z_loss": torch.mean(
                   torch.logsumexp(logits, dim=-1) ** 2, dim=-1)}
        return eidx, slot, probs, valid, inv, aux

    def route_probe(logits, k, capacity, renormalize=True):
        layer = cur[0]
        out = (route(logits, k, capacity, renormalize) if replay is None
               else replayed(logits, replay[layer], renormalize))
        m = (out[0], out[1], out[3], out[4])
        if layer in maps:
            repeats["calls"] += 1
            repeats["differ"] += not all(torch.equal(a, b)
                                         for a, b in zip(m, maps[layer]))
        else:
            maps[layer] = m
        return out

    moe.moe_block, moe.top_k_routing = block_probe, route_probe
    try:
        yield maps, repeats
    finally:
        moe.moe_block, moe.top_k_routing = block, route


# every kernel's launches in one MoE training step (12 layers, each
# recomputed once in the backward): dispatch and combine forwards 2 a
# layer twice plus the dispatch backward; the combine backward; flash
# forward twice and backward once; two norms forward twice and backward
# once; one AdamW launch per leaf of the 16-leaf tree
_MOE_LAUNCHES_PER_STEP = {"gather_wsum": 60, "gather_scale_dot": 12,
                          "flash_attention_fwd": 24,
                          "flash_attention_bwd": 12, "rms_norm_fwd": 48,
                          "rms_norm_bwd": 24, "adamw_q": 16}


def phase_train_moe(peaks, warmup: int = 2, timed: int = 4,
                    batch: int = 20, seq: int = 2048):
    """The JAX package's single-chip MoE config (bench.py:98) through
    `train.make_train_step(model=moe)`. After the timed steps one
    forward of the final params over the step's batch reads the aux
    losses and each layer's share of dropped (token, choice) pairs."""
    from paddle_tpu_torch.nlp import moe

    cfg = moe.MoeConfig.flagship_moe()
    res, state, tokens = _drive_train(peaks, moe, cfg, batch,
                                      _train_counters(moe=True), warmup,
                                      timed, seq)
    with torch.no_grad(), _moe_routing_probe() as (maps, _):
        _, aux = moe._backbone(state.params, tokens, cfg)
    dropped = [1.0 - m[2].float().mean().item()
               for _, m in sorted(maps.items())]
    res = {"phase": "train_moe", "config": "flagship_moe (bench.py:98)",
           "active_params": moe.active_params(cfg),
           "widths": {"D": cfg.hidden_size, "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size,
                      "E": cfg.num_experts, "k": cfg.num_experts_per_tok,
                      "F_expert": cfg.moe_intermediate_size,
                      "shared": cfg.num_shared_experts,
                      "capacity": cfg.capacity(seq)},
           **res,
           "final_aux": {n: float(v) for n, v in aux.items()},
           "dropped_share_by_layer": dropped,
           "dropped_share": float(np.mean(dropped)),
           "nvidia_smi": _smi_line()}
    _emit(res)
    del state, tokens
    torch.cuda.empty_cache()
    _check_losses(res)
    steps = res["steps"]
    for name, per in _MOE_LAUNCHES_PER_STEP.items():
        if res["launches"][name] != per * steps:
            raise AssertionError(
                f"{name}: {res['launches'][name]} launches in {steps} MoE "
                f"steps, expected {per} a step")
    return res


@contextlib.contextmanager
def _plain_kernels(fault=None):
    """Route the training Functions to the kernels' plain versions on
    CUDA tensors (the reference paths of the gradient checks). The
    planted controls: fault="dcap", the flash backward also drops
    dcap = rowsum(dO * O); fault="dispatch", the MoE dispatch backward
    drops each token's second choice (its weight set to 0);
    fault="ln_dx", the LayerNorm backward drops the x̂·mean(dyw·x̂) term
    of dx; fault="rms_w", the row-6 RMSNorm reads its weight one column
    off (column j scaled by w[j - 1]); fault="mask", the flash backward
    drops the key mask."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import rms_norm as rn
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             rn.rms_norm_fwd, rn.rms_norm_bwd, md.gather_wsum,
             md.gather_scale_dot, md._dispatch_bwd, ln.layer_norm_fwd,
             ln.layer_norm_bwd, rn.rms_norm_fused)
    rms_ref = rn.rms_norm_ref

    def bwd(q, k, v, out, lse, dout, causal=True, scale=None, key_mask=None,
            layout="bshd"):
        if fault == "dcap":
            out = torch.zeros_like(out)
        if fault == "mask":
            key_mask = None
        return fa.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                          causal=causal, scale=scale,
                                          key_mask=key_mask, layout=layout)

    def rms_fused(x, w=None, eps=1e-6):
        if fault == "rms_w" and w is not None:
            w = torch.roll(w, 1)
        return rms_ref(x, w, eps)

    def dispatch_bwd(g, flat, k):
        B, Mk = flat.shape
        idx = flat.clamp(min=0).reshape(B, Mk // k, k)
        w = (flat >= 0).float().reshape(B, Mk // k, k)
        w[..., 1] = 0.0
        return md._gather_wsum_ref(g, idx, w)

    fa.flash_attention_fwd = fa.flash_attention_fwd_ref
    fa.flash_attention_bwd = bwd
    rn.rms_norm_fwd = lambda x, w, eps=1e-6: rn._rms_fwd_twin(x, w, eps)
    rn.rms_norm_bwd = lambda x, w, rstd, dy, eps=1e-6: \
        rn._rms_train_ref_bwd(x, w, dy, eps)
    md.gather_wsum = md._gather_wsum_ref
    md.gather_scale_dot = md._gather_scale_dot_ref
    if fault == "dispatch":
        md._dispatch_bwd = dispatch_bwd
    ln.layer_norm_fwd = lambda x, w, b, eps=1e-5: ln._ln_fwd_twin(
        x, w, b, eps, w is not None)
    ln.layer_norm_bwd = (
        _ln_bwd_dropped_term if fault == "ln_dx" else
        lambda x, w, mu, rstd, dy, eps=1e-5: ln._ln_ref_bwd(
            x, w, dy, eps, w is not None))
    rn.rms_norm_fused = rms_fused
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, rn.rms_norm_fwd,
         rn.rms_norm_bwd, md.gather_wsum, md.gather_scale_dot,
         md._dispatch_bwd, ln.layer_norm_fwd, ln.layer_norm_bwd,
         rn.rms_norm_fused) = saved


def _ln_bwd_dropped_term(x, weight, mu, rstd, dy, eps=1e-5):
    """The plain LayerNorm backward with a planted fault: dx lacks the
    x̂·mean(dyw·x̂) term (dw and db are right)."""
    xf, dyf = x.float(), dy.float()
    d = x.shape[-1]
    m = torch.mean(xf, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.mean((xf - m) ** 2, dim=-1, keepdim=True) + eps)
    xhat = (xf - m) * r
    dyw = dyf * weight.float() if weight is not None else dyf
    dx = (r * (dyw - torch.mean(dyw, dim=-1, keepdim=True))).to(x.dtype)
    return (dx, torch.sum((dyf * xhat).reshape(-1, d), dim=0),
            torch.sum(dyf.reshape(-1, d), dim=0))


_GRAD_GROUPS = {
    "embed": ("embed_tokens",),
    "attention": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "up_proj", "down_proj"),
    "norms": ("input_layernorm", "post_attention_layernorm", "norm"),
    "head": ("lm_head",),
}
# groups upstream of the first layer's attention backward: the dcap fault
# must show there (the head's and the loss's values come before it)
_FAULT_GROUPS = ("embed", "attention", "mlp", "norms")
_MOE_GRAD_GROUPS = {
    "embed": ("embed_tokens",),
    "attention": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "router": ("gate",),
    "experts": ("expert_gate_proj", "expert_up_proj", "expert_down_proj"),
    "shared": ("shared_gate_proj", "shared_up_proj", "shared_down_proj"),
    "norms": ("input_layernorm", "post_attention_layernorm", "norm"),
    "head": ("lm_head",),
}
# groups upstream of the first dispatch backward the backward runs (the
# last layer's): its wrong token-row gradient reaches that layer's
# attention and norms and every weight of the layers below, so every
# group but the head and the loss, whose values come before it
_MOE_FAULT_GROUPS = ("embed", "attention", "router", "experts", "shared",
                     "norms")
# Gradient tolerance of the kernels: the same argument as the logits
# check's. Both bf16 paths run the same bf16 GEMMs and differ only where
# attention and the norms round (the MoE gathers agree bit for bit), so
# each group's distance from an f32 evaluation is that of bf16
# evaluation itself; the kernels may be at most 1.5x the plain path's.
GRAD_VS_F32_RATIO = 1.5


def _grad_run(loss_fn, logits_fn, c, p, tokens):
    """One loss + backward of loss_fn(tree, tokens, c) over every leaf
    of `p`, then a no-grad logits_fn(tree, tokens, c): (loss, per-token
    NLL, gradients by leaf name in f32)."""
    names, leaves = [], []

    def collect(path, t):
        if isinstance(t, dict):
            for k in sorted(t):
                collect(k, t[k])
        else:
            names.append(path)
            leaves.append(t.detach().requires_grad_(True))
    collect("", p)
    live = dict(zip(names, leaves))
    tree = {k: (live[k] if not isinstance(v, dict)
                else {kk: live[kk] for kk in v}) for k, v in p.items()}
    with torch.enable_grad():
        loss = loss_fn(tree, tokens, c)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        logits = logits_fn(tree, tokens, c)
        tgt = tokens[:, 1:].long()
        nll = (torch.logsumexp(logits[:, :-1], -1)
               - torch.gather(logits[:, :-1], -1, tgt[..., None])[..., 0])
    del logits
    g = {n: x.float() for n, x in zip(names, grads)}
    return float(loss.detach()), nll.float().reshape(-1), g


def _grad_ratios(res, groups, first="loss"):
    """Relative RMS distance of each bf16 path's per-token losses (or
    another output, named `first`) and gradient groups from the f32
    evaluation's, and the kernel and fault paths' distances as ratios to
    the plain path's."""
    def dist(a, b):
        return (torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
                / torch.sqrt(sum((y ** 2).sum() for y in b))).item()

    out = {}
    _, nll32, g32 = res["f32"]
    for group, keys in {first: None, **groups}.items():
        c = {}
        for n in ("kernel", "ref", "fault"):
            _, nll, g = res[n]
            if keys is None:
                c[f"{n}_vs_f32"] = dist([nll], [nll32])
            else:
                c[f"{n}_vs_f32"] = dist([g[k] for k in keys],
                                        [g32[k] for k in keys])
        c["kernel_ratio"] = c["kernel_vs_f32"] / c["ref_vs_f32"]
        c["fault_ratio"] = c["fault_vs_f32"] / c["ref_vs_f32"]
        out[group] = c
    out["loss_values"] = {n: r[0] for n, r in res.items()}
    return out


def _check_grad_ratios(out, groups, fault_groups, fault, first="loss"):
    for group in (first, *groups):
        c = out[group]
        if not c["kernel_ratio"] <= GRAD_VS_F32_RATIO:
            raise AssertionError(
                f"{group} gradients: the kernels are {c['kernel_vs_f32']} "
                f"from f32, more than {GRAD_VS_F32_RATIO} x the plain bf16 "
                f"path's {c['ref_vs_f32']}")
        if group in fault_groups and \
                not c["fault_ratio"] > GRAD_VS_F32_RATIO:
            raise AssertionError(
                f"{group} gradients: the planted {fault} fault reads "
                f"{c['fault_ratio']} x the plain path's distance, within "
                f"the {GRAD_VS_F32_RATIO} bound: the check cannot see it")


def phase_grad_check(layers: int = 2, seq: int = 2048):
    """One loss + backward of `loss_fn` at full width through the kernels,
    their plain versions, the plain versions with the dcap fault, and an
    f32 evaluation of the same bf16 weights; relative RMS distance of
    each gradient group (and of the per-token losses) from f32."""
    import dataclasses
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.optimizer.transform import tree_map

    cfg = llama.LlamaConfig.flagship_2b(num_hidden_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    params = llama.init_params(cfg, gen, device="cuda", training=True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, seq))).cuda()

    def run(c, p):
        return _grad_run(llama.loss_fn, llama.forward, c, p, tokens)

    res = {"kernel": run(cfg, params)}
    with _plain_kernels():
        res["ref"] = run(cfg, params)
    with _plain_kernels(fault="dcap"):
        res["fault"] = run(cfg, params)
    p32 = tree_map(lambda t: t.float(), params)
    with _plain_kernels():
        res["f32"] = run(cfg32, p32)
    del params, p32
    out = _grad_ratios(res, _GRAD_GROUPS)
    _emit({"phase": "grad_check", "layers": layers, "seq": seq,
           "ratio_tol": GRAD_VS_F32_RATIO, "fault_groups": _FAULT_GROUPS,
           **out})
    del res
    torch.cuda.empty_cache()
    _check_grad_ratios(out, _GRAD_GROUPS, _FAULT_GROUPS, "dcap")
    return out


def phase_grad_check_moe(layers: int = 2, seq: int = 2048):
    """The gradient check of the MoE model at full width (bench.py:98's
    widths, 2 layers, 1 x 2048 tokens): kernels, plain versions, plain
    versions with the dispatch fault, f32. Each evaluation routes by its
    own logits ("free"), and the routing of each bf16 path is counted
    against the f32 evaluation's per layer: a near-tie that bf16 rounding
    flips sends a token to another expert and shifts the capacity slots
    of the tokens after it, a difference of routing, not of kernels. So
    the bf16 paths run again with the f32 evaluation's maps ("fixed":
    `_moe_routing_probe(replay=...)`), and the bound is held there."""
    import dataclasses
    from paddle_tpu_torch.nlp import moe
    from paddle_tpu_torch.optimizer.transform import tree_map

    cfg = moe.MoeConfig.flagship_moe(num_hidden_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    params = moe.init_params(cfg, gen, device="cuda")
    p32 = tree_map(lambda t: t.float(), params)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, seq))).cuda()

    def run(name, replay=None):
        c, p = (cfg32, p32) if name == "f32" else (cfg, params)
        ctx = (contextlib.nullcontext() if name == "kernel"
               else _plain_kernels(fault="dispatch" if name == "fault"
                                   else None))
        with ctx, _moe_routing_probe(replay) as (maps, repeats):
            r = _grad_run(moe.loss_fn, lambda t, tok, cc: moe.forward(
                t, tok, cc)[0], c, p, tokens)
        return r, maps, repeats

    free, maps, repeats = {}, {}, {}
    for name in ("f32", "kernel", "ref", "fault"):
        free[name], maps[name], repeats[name] = run(name)
    fixed = {"f32": free["f32"]}
    for name in ("kernel", "ref", "fault"):
        fixed[name], _, _ = run(name, replay=maps["f32"])
    del params, p32
    m32 = maps["f32"]
    flips = {n: [int(((maps[n][l][0] != m32[l][0])
                      | (maps[n][l][2] != m32[l][2])).sum().item())
                 for l in sorted(m32)] for n in ("kernel", "ref", "fault")}
    out = {"free": _grad_ratios(free, _MOE_GRAD_GROUPS),
           "fixed": _grad_ratios(fixed, _MOE_GRAD_GROUPS)}
    _emit({"phase": "grad_check_moe", "layers": layers, "seq": seq,
           "ratio_tol": GRAD_VS_F32_RATIO, "held": "fixed",
           "fault_groups": _MOE_FAULT_GROUPS,
           "routing_diff_vs_f32_by_layer": flips,
           "pairs_per_layer": seq * cfg.num_experts_per_tok,
           "recompute_maps": repeats, **out})
    del free, fixed
    torch.cuda.empty_cache()
    for name, r in repeats.items():
        if r["differ"]:
            raise AssertionError(f"{name}: {r['differ']} of {r['calls']} "
                                 f"recomputed routings differ from the "
                                 f"forward's")
    _check_grad_ratios(out["fixed"], _MOE_GRAD_GROUPS, _MOE_FAULT_GROUPS,
                       "dispatch")
    return out


# ------------------------------------------------------------- 7. eager
# every kernel's launches in one eager ERNIE step: the embedding norm and
# the two post-LN norms of each of the 12 layers, forward and backward;
# one flash forward and backward a layer
_EAGER_LAUNCHES_PER_STEP = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
                            "flash_attention_fwd": 12,
                            "flash_attention_bwd": 12}


def _eager_counters():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    return {"layer_norm_fwd": ln.layer_norm_fwd,
            "layer_norm_bwd": ln.layer_norm_bwd,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd}


def _quick_start(steps: int = 5):
    """README.md's Quick start as written, with `import paddle_tpu_torch
    as paddle`, on the card: a Linear-ReLU-Linear classifier of seeded
    random data under AdamW; returns its losses, which must fall."""
    import paddle_tpu_torch as paddle
    paddle.seed(SEED)
    rng = np.random.default_rng(SEED)
    x = paddle.to_tensor(rng.standard_normal((64, 784)).astype("float32"))
    y = paddle.to_tensor(rng.integers(0, 10, (64,)))
    model = paddle.nn.Sequential(paddle.nn.Linear(784, 256),
                                 paddle.nn.ReLU(), paddle.nn.Linear(256, 10))
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss = paddle.nn.CrossEntropyLoss()(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    if not loss._data.is_cuda or not losses[-1] < losses[0]:
        raise AssertionError(f"the Quick start did not train on the card: "
                             f"{losses}")
    return losses


def phase_eager(peaks):
    """The eager API's training path at ERNIE-3.0-base width
    (BASELINE config 1, bench.py:134-181's recipe): the encoder composed
    from paddle.nn and paddle.incubate.nn layers
    (`tools/eager_ernie.build_model`, dropout 0.1, attention-probability
    dropout 0), f32 parameters under O1 bf16 auto_cast, AdamW at lr 2e-5
    with the global-norm clip at 1.0, the same batch of 64 x 512 from
    default_rng(0) every step: 2 warm-up then 4 timed steps of
    loss.backward(); opt.step(); opt.clear_grad(), one synchronize after
    the timed ones. Launch counters are zeroed before the timed steps and
    must read exactly the step's counts. First the README's Quick start
    trains a few steps on the card (`_quick_start`)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model, train_step

    cfg = ernie.ErnieConfig.ernie3_base()
    warmup, timed, batch, seq = 2, 4, 64, 512
    paddle.set_device("gpu")
    quick_start = _quick_start()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paddle.seed(SEED)
    model = build_model(paddle, cfg, dropout=0.1)
    opt = paddle.optimizer.AdamW(
        learning_rate=2e-5, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    loss_fn = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = paddle.to_tensor(rng.integers(0, cfg.num_labels, (batch,)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses = [train_step(paddle, model, loss_fn, opt, ids, labels)
              for _ in range(warmup)]
    torch.cuda.synchronize()
    counters = _eager_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(train_step(paddle, model, loss_fn, opt, ids, labels))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(l) for l in losses]
    tok_s = batch * seq * timed / dt
    fpt = ernie.flops_per_token(cfg, seq)
    res = {"phase": "eager",
           "config": "ErnieConfig.ernie3_base (BASELINE config 1, "
                     "bench.py:134-181), composed from layers",
           "widths": {"V": cfg.vocab_size, "D": cfg.hidden_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads, "hd": cfg.head_dim,
                      "F": cfg.intermediate_size},
           "params": sum(p.size for p in model.parameters()),
           "batch": batch, "seq": seq, "steps": warmup + timed,
           "timed_steps": timed, "step_ms": dt / timed * 1e3,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": tok_s * fpt / peaks[0], "losses": losses,
           "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_per_step": {n: c / timed for n, c in launches.items()},
           "quick_start_losses": quick_start, "nvidia_smi": _smi_line()}
    _emit(res)
    del model, opt, ids, labels
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite eager loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the eager loss did not fall: {losses}")
    for name, per in _EAGER_LAUNCHES_PER_STEP.items():
        if launches[name] != per * timed:
            raise AssertionError(
                f"{name}: {launches[name]} launches in {timed} eager steps, "
                f"expected {per} a step")
    return res


def _eager_group(name: str) -> str:
    """The gradient group of an eager ERNIE parameter."""
    if name.endswith("_embeddings.weight"):
        return "embed"
    if "norm" in name:          # the norms' scales, biases, linear biases
        return "norms"
    if "_proj." in name:
        return "attention"
    if "ffn_" in name:
        return "ffn"
    return "head"               # pooler, classifier


# groups upstream of the last LayerNorm, whose dx the ln_dx fault breaks
# first: every group but the head, whose gradients (and the last layer's
# output) come before it
_EAGER_FAULT_GROUPS = ("embed", "attention", "ffn", "norms")


def phase_grad_check_eager():
    """One loss + backward of the eager ERNIE (ERNIE-3.0-base widths,
    2 layers, dropout 0, batch 4 x 512) under O1 through the kernels, their plain
    versions, the plain versions with the ln_dx fault, and an f32
    evaluation (no auto_cast, plain versions) of the same f32 weights;
    relative RMS distance of the last layer's output and of each
    gradient group from f32."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model

    layers, batch, seq = 2, 4, 512
    cfg = ernie.ErnieConfig.ernie3_base(num_hidden_layers=layers)
    paddle.set_device("gpu")
    paddle.seed(SEED + 4)
    model = build_model(paddle, cfg, dropout=0.0)
    loss_fn = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(3)
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = paddle.to_tensor(rng.integers(0, cfg.num_labels, (batch,)))
    last = {}
    hook = model.layers[len(model.layers) - 1].register_forward_post_hook(
        lambda layer, inputs, out: last.__setitem__("out", out))

    def run(amp):
        with paddle.amp.auto_cast(enable=amp, dtype="bfloat16"):
            loss = loss_fn(model(ids), labels)
        loss.backward()
        g = {n: p.grad._data.float() for n, p in model.named_parameters()}
        model.clear_gradients()
        return (float(loss), last.pop("out")._data.detach().float()
                .reshape(-1), g)

    res = {"kernel": run(True)}
    with _plain_kernels():
        res["ref"] = run(True)
    with _plain_kernels(fault="ln_dx"):
        res["fault"] = run(True)
    with _plain_kernels():
        res["f32"] = run(False)
    hook.remove()
    groups: dict = {}
    for n, _ in model.named_parameters():
        groups.setdefault(_eager_group(n), []).append(n)
    del model
    out = _grad_ratios(res, groups, first="last_layer_out")
    _emit({"phase": "grad_check_eager", "layers": layers, "batch": batch,
           "seq": seq, "ratio_tol": GRAD_VS_F32_RATIO,
           "fault_groups": _EAGER_FAULT_GROUPS, **out})
    del res
    torch.cuda.empty_cache()
    _check_grad_ratios(out, groups, _EAGER_FAULT_GROUPS, "ln_dx",
                       first="last_layer_out")
    return out


# --------------------------------------------------------- 8. eager Llama
# every kernel's launches in one eager Llama step: the two norms of each
# of the 11 layers and the final norm, forward only (the backward is the
# plain version's vjp); one causal flash forward and backward a layer
_EAGER_LLAMA_LAUNCHES_PER_STEP = {"rms_norm_fused": 23,
                                  "flash_attention_fwd": 11,
                                  "flash_attention_bwd": 11}
# one key-masked flash forward and backward a layer of the ERNIE step; its
# norms are plain torch, as in the JAX package: no LayerNorm kernel
_ERNIE_LAUNCHES_PER_STEP = {"flash_attention_fwd": 12,
                            "flash_attention_bwd": 12,
                            "layer_norm_fwd": 0, "layer_norm_bwd": 0}


def _path_counters(names):
    from paddle_tpu_torch.kernels import adaln as ad
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import rms_norm as rn
    every = {"rms_norm_fused": rn.rms_norm_fused,
             "flash_attention_fwd": fa.flash_attention_fwd,
             "flash_attention_bwd": fa.flash_attention_bwd,
             "layer_norm_fwd": ln.layer_norm_fwd,
             "layer_norm_bwd": ln.layer_norm_bwd,
             "adaln_fwd": ad.adaln_fwd, "adaln_bwd": ad.adaln_bwd,
             "gather_rows": md.gather_rows_kernel,
             "gather_mlp": md.gather_mlp_kernel}
    return {n: every[n] for n in names}


def _run_steps(step, counters, warmup, timed):
    """`warmup` then `timed` calls of step() → loss (a scalar tensor or
    Tensor), the counters zeroed between them and read after the timed
    ones, one synchronize around those: (losses, seconds, launches, peak
    device memory)."""
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    losses += [step() for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    return ([float(x) for x in losses], dt, launches,
            torch.cuda.max_memory_allocated())


def _check_path(name, res, per_step, timed):
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if not res["peak_memory_bytes"] < 80e9:
        raise AssertionError(f"{name}: peak memory "
                             f"{res['peak_memory_bytes']} over 80 GB")
    for kernel, per in per_step.items():
        if res["launches"][kernel] != per * timed:
            raise AssertionError(
                f"{name}: {kernel} launched {res['launches'][kernel]} times "
                f"in {timed} steps, expected {per} a step")


def phase_eager_llama(peaks):
    """A Llama at the flagship widths and depth (bench.py:120-131: V 32000,
    D 4096, F 9472, 11 layers, GQA 32/8 of 128) composed from the eager
    API's layers (`tools/eager_llama.build_model`: FusedRMSNorm, the fused
    RoPE, F.flash_attention, swiglu), f32 parameters under O1 bf16
    auto_cast, AdamW at lr 1e-4 with the global-norm clip at 1.0, the
    same batch of 2 x 2048 from default_rng(0) every step: 2 warm-up then
    4 timed steps. Row 6 must launch exactly 23 times a step (in f32:
    fused_rms_norm is on neither AMP list), the causal flash forward and
    backward 11 each; losses finite and falling, peak memory under
    80 GB."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.tools.eager_llama import build_model, train_step

    cfg = llama.LlamaConfig.flagship_2b()
    warmup, timed, batch, seq = 2, 4, 2, 2048
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paddle.seed(SEED)
    model = build_model(paddle, cfg)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    loss_fn = paddle.nn.CrossEntropyLoss()
    tokens = paddle.to_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, dt, launches, peak = _run_steps(
        lambda: train_step(paddle, model, loss_fn, opt, tokens),
        _path_counters(_EAGER_LLAMA_LAUNCHES_PER_STEP), warmup, timed)
    tok_s = batch * seq * timed / dt
    fpt = llama.flops_per_token(cfg, seq)
    res = {"phase": "eager_llama",
           "config": "LlamaConfig.flagship_2b (bench.py:120-131), "
                     "composed from layers",
           "widths": {"V": cfg.vocab_size, "D": cfg.hidden_size,
                      "F": cfg.intermediate_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "hd": cfg.head_dim},
           "params": sum(p.size for p in model.parameters()),
           "batch": batch, "seq": seq, "steps": warmup + timed,
           "timed_steps": timed, "step_ms": dt / timed * 1e3,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": tok_s * fpt / peaks[0], "losses": losses,
           "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_per_step": {n: c / timed for n, c in launches.items()},
           "nvidia_smi": _smi_line()}
    _emit(res)
    del model, opt, tokens
    torch.cuda.empty_cache()
    _check_path("eager_llama", res, _EAGER_LLAMA_LAUNCHES_PER_STEP, timed)
    return res


def phase_ernie(peaks):
    """ERNIE-3.0-base (BASELINE config 1) through nlp/ernie.py with the
    recipe of bench.py:134-181 (`tools/ernie_finetune.build_ernie_step`:
    finetune_loss, its gradient over the functional tree, adamw 2e-5,
    f32 params and bf16 compute), batch 64 x 512 padded to lengths drawn
    uniform in 128-512 from a fixed seed and passed as the [B, S]
    attention_mask: 2 warm-up then 4 timed steps. The key-masked
    head-major flash forward and backward must launch exactly 12 times a
    step each and the LayerNorm kernels never; losses finite and
    falling."""
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.ernie_finetune import build_ernie_step

    warmup, timed, batch, seq = 2, 4, 64, 512
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, state, data, cfg = build_ernie_step(batch, seq)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    box = [state]

    def one():
        box[0], m = step(box[0], data)
        return m["loss"]

    losses, dt, launches, peak = _run_steps(
        one, _path_counters(_ERNIE_LAUNCHES_PER_STEP), warmup, timed)
    tok_s = batch * seq * timed / dt
    fpt = ernie.flops_per_token(cfg, seq)
    lengths = data[2].sum(1)
    res = {"phase": "ernie",
           "config": "ErnieConfig.ernie3_base (BASELINE config 1, "
                     "bench.py:134-181) through nlp/ernie.py",
           "widths": {"V": cfg.vocab_size, "D": cfg.hidden_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads, "hd": cfg.head_dim,
                      "F": cfg.intermediate_size},
           "params": ernie.num_params(cfg), "batch": batch, "seq": seq,
           "valid_tokens": int(lengths.sum()),
           "lengths": [int(lengths.min()), int(lengths.max())],
           "steps": warmup + timed, "timed_steps": timed,
           "step_ms": dt / timed * 1e3, "tokens_per_s": tok_s,
           "flops_per_token": fpt, "mfu": tok_s * fpt / peaks[0],
           "losses": losses, "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_per_step": {n: c / timed for n, c in launches.items()},
           "nvidia_smi": _smi_line()}
    _emit(res)
    del box, state, step, data
    torch.cuda.empty_cache()
    _check_path("ernie", res, _ERNIE_LAUNCHES_PER_STEP, timed)
    return res


def _eager_llama_group(name: str) -> str:
    """The gradient group of an eager Llama parameter."""
    if name.startswith("embed_tokens"):
        return "embed"
    if "norm" in name:
        return "norms"
    if any(p in name for p in ("q_proj", "k_proj", "v_proj", "o_proj")):
        return "attention"
    if any(p in name for p in ("gate_proj", "up_proj", "down_proj")):
        return "mlp"
    return "head"


def phase_grad_check_eager_llama():
    """One loss + backward of the eager Llama (flagship widths, 2 layers,
    batch 1 x 2048) under O1 through the kernels, their plain versions,
    the plain versions with the rms_w fault, and an f32 evaluation (no
    auto_cast, plain versions) of the same f32 weights; relative RMS
    distance of the last layer's output and of each gradient group from
    f32. The norm gains are drawn as 1 + 0.1 N(0, 1): at their initial
    1 a gain read one column off is the same gain, and the planted fault
    could not show. The fault is in the forward of every norm, so every
    group and the last layer's output must read it."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.tools.eager_llama import build_model, lm_loss

    layers, batch, seq = 2, 1, 2048
    cfg = llama.LlamaConfig.flagship_2b(num_hidden_layers=layers)
    paddle.set_device("gpu")
    paddle.seed(SEED + 5)
    model = build_model(paddle, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "norm" in n:
                p._data.copy_(1 + 0.1 * torch.randn(
                    p._data.shape, device=p._data.device, generator=gen))
    loss_fn = paddle.nn.CrossEntropyLoss()
    tokens = paddle.to_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (batch, seq)))
    last = {}
    hook = model.layers[len(model.layers) - 1].register_forward_post_hook(
        lambda layer, inputs, out: last.__setitem__("out", out))

    def run(amp):
        with paddle.amp.auto_cast(enable=amp, dtype="bfloat16"):
            loss = lm_loss(loss_fn, model(tokens), tokens)
        loss.backward()
        g = {n: p.grad._data.float() for n, p in model.named_parameters()}
        model.clear_gradients()
        return (float(loss), last.pop("out")._data.detach().float()
                .reshape(-1), g)

    res = {"kernel": run(True)}
    with _plain_kernels():
        res["ref"] = run(True)
    with _plain_kernels(fault="rms_w"):
        res["fault"] = run(True)
    with _plain_kernels():
        res["f32"] = run(False)
    hook.remove()
    groups: dict = {}
    for n, _ in model.named_parameters():
        groups.setdefault(_eager_llama_group(n), []).append(n)
    del model
    fault_groups = ("last_layer_out", *groups)
    out = _grad_ratios(res, groups, first="last_layer_out")
    _emit({"phase": "grad_check_eager_llama", "layers": layers,
           "batch": batch, "seq": seq, "ratio_tol": GRAD_VS_F32_RATIO,
           "fault_groups": fault_groups, **out})
    del res
    torch.cuda.empty_cache()
    _check_grad_ratios(out, groups, fault_groups, "rms_w",
                       first="last_layer_out")
    return out


def _ernie_group(name: str):
    """The gradient group of an nlp/ernie.py leaf (None: the MLM head,
    which the finetune loss does not use)."""
    if name.startswith("mlm"):
        return None
    if "embeddings" in name:
        return "embed"
    if "norm" in name:
        return "norms"
    if name.startswith("layers/") and name[7] in "qkvo":
        return "attention"
    if "ffn" in name:
        return "ffn"
    return "head"           # pooler, classifier


# groups upstream of the last layer's attention backward, where the mask
# fault first acts: every attention weight, the lower layer's FFN and
# norms, and the embeddings; the head's gradients come before it
_ERNIE_FAULT_GROUPS = ("embed", "attention", "ffn", "norms")


def phase_grad_check_ernie():
    """One finetune loss + backward of nlp/ernie.py (ERNIE-3.0-base
    widths, 2 layers, batch 4 x 512 padded to lengths in 128-512) in bf16
    compute through the kernels, their plain versions, the plain versions
    with the mask fault (the flash backward's plain version drops the key
    mask), and an f32 evaluation (f32 compute, plain versions) of the same
    f32 parameters; relative RMS distance of the encoder output and of
    each gradient group from f32."""
    import dataclasses
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.nlp.train import value_and_grad
    from paddle_tpu_torch.tools.ernie_finetune import padded_batch

    layers, batch, seq = 2, 4, 512
    cfg = ernie.ErnieConfig.ernie3_base(num_hidden_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = ernie.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 7))
    ids, labels, mask = padded_batch(cfg, batch, seq, seed=SEED + 3)

    def run(c):
        loss, g = value_and_grad(
            lambda p: ernie.finetune_loss(p, ids, labels, c,
                                          attention_mask=mask), params)
        with torch.no_grad():
            seq_out = ernie.encode(params, ids, attention_mask=mask, cfg=c)
        flat = {}
        for k, v in g.items():
            if isinstance(v, dict):
                flat.update({f"{k}/{kk}": vv.float() for kk, vv in v.items()})
            else:
                flat[k] = v.float()
        return float(loss), seq_out.float().reshape(-1), flat

    res = {"kernel": run(cfg)}
    with _plain_kernels():
        res["ref"] = run(cfg)
    with _plain_kernels(fault="mask"):
        res["fault"] = run(cfg)
    with _plain_kernels():
        res["f32"] = run(cfg32)
    groups: dict = {}
    for n in res["f32"][2]:
        gname = _ernie_group(n)
        if gname is not None:
            groups.setdefault(gname, []).append(n)
    out = _grad_ratios(res, groups, first="encoder_out")
    _emit({"phase": "grad_check_ernie", "layers": layers, "batch": batch,
           "seq": seq, "lengths": mask.sum(1).tolist(),
           "ratio_tol": GRAD_VS_F32_RATIO,
           "fault_groups": _ERNIE_FAULT_GROUPS, **out})
    del res, params
    torch.cuda.empty_cache()
    _check_grad_ratios(out, groups, _ERNIE_FAULT_GROUPS, "mask",
                       first="encoder_out")
    return out


# ----------------------------------------------------------------- 10. DiT
# one DiT-XL/2 step (28 blocks, per-block recompute): each block's flash
# forward runs in the forward and again in its recompute, the backward
# once; DiT's norm and modulation are plain torch (as in the JAX
# package), and no MoE gather runs
_DIT_LAUNCHES_PER_STEP = {"flash_attention_fwd": 2 * 28,
                          "flash_attention_bwd": 28,
                          "adaln_fwd": 0, "adaln_bwd": 0,
                          "gather_rows": 0, "gather_mlp": 0}


def phase_dit(peaks):
    """DiT-XL/2 (BASELINE config 3: 32x32x4 latents, patch 2, D 1152, 28
    blocks, 16 heads of 72, 675M params) with bench.py:184-233's recipe
    through `tools/dit_train.build_dit_step`: f32 params, bf16 compute,
    per-block recompute, adamw_q(1e-4) (8-bit moments), batch 96 from
    default_rng(0), the step's draws fixed: 2 warm-up then 4 timed steps.
    The flash forward must launch exactly 56 times a step and the
    backward 28 (head_dim 72, non-causal, 'bhsd'), rows 11-13 and 16
    never; losses finite and falling, peak memory under 80 GB."""
    from paddle_tpu_torch.mix import dit
    from paddle_tpu_torch.tools.dit_train import build_dit_step

    warmup, timed, batch = 2, 4, 96
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, state, data, cfg = build_dit_step(batch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    box = [state]

    def one():
        box[0], m = step(box[0], data)
        return m["loss"]

    losses, dt, launches, peak = _run_steps(
        one, _path_counters(_DIT_LAUNCHES_PER_STEP), warmup, timed)
    img_s = batch * timed / dt
    fpi = dit.flops_per_image(cfg)
    res = {"phase": "dit",
           "config": "DiTConfig.dit_xl_2 (BASELINE config 3, "
                     "bench.py:184-233) through mix/dit.py",
           "widths": {"image": cfg.image_size, "patch": cfg.patch_size,
                      "D": cfg.hidden_size, "L": cfg.depth,
                      "H": cfg.num_heads, "hd": cfg.head_dim,
                      "tokens": cfg.n_patches},
           "params": dit.num_params(cfg), "batch": batch,
           "steps": warmup + timed, "timed_steps": timed,
           "step_ms": dt / timed * 1e3, "img_per_s": img_s,
           "flops_per_image": fpi, "mfu": img_s * fpi / peaks[0],
           "losses": losses, "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_per_step": {n: c / timed for n, c in launches.items()},
           "nvidia_smi": _smi_line()}
    _emit(res)
    del box, state, step, data
    torch.cuda.empty_cache()
    _check_path("dit", res, _DIT_LAUNCHES_PER_STEP, timed)
    return res


def _dit_group(name: str) -> str:
    """The gradient group of a mix/dit.py leaf."""
    if name.startswith("final"):
        return "final"
    if name.startswith("blocks/"):
        leaf = name[len("blocks/"):]
        if leaf.startswith("ada"):
            return "ada"
        if leaf.startswith(("qkv", "proj")):
            return "attention"
        return "mlp"
    return "embed"      # patch, position, timestep and label embeddings


# the groups the dcap fault must show in: every qkv and proj weight (the
# last block's qkv take the faulty dq/dk/dv, the first block's all its
# weights the faulty input gradient). The others are reported: the
# attention branch reaches them scaled by its gate.
_DIT_FAULT_GROUPS = ("attention",)


def phase_grad_check_dit():
    """One diffusion loss + backward of DiT-XL/2's widths at 2 blocks,
    batch 16 of 32x32x4 latents with fixed draws, in bf16 compute through
    the kernels, their plain versions, the plain versions with the dcap
    fault (the flash backward's plain version drops rowsum(dO·O), at
    head_dim 72), and an f32 evaluation (f32 compute, plain versions) of
    the same f32 parameters; relative RMS distance of the model output
    and of each gradient group from f32.

    At the DiT recipe's init `ada_w`, `final_ada_w` and `final_w` are
    zero: every gate is 0, the attention branch gets exactly zero
    gradient and a broken flash backward would pass. So this check draws
    those three from a seeded N(0, 0.02) first."""
    import dataclasses
    from paddle_tpu_torch.mix import dit
    from paddle_tpu_torch.nlp.train import value_and_grad

    layers, batch = 2, 16
    cfg = dit.DiTConfig.dit_xl_2(depth=layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    params = dit.init_params(gen, cfg)
    with torch.no_grad():
        for t in (params["blocks"]["ada_w"], params["final_ada_w"],
                  params["final_w"]):
            t.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.standard_normal(
        (batch, cfg.in_channels, cfg.image_size, cfg.image_size))
        .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, (batch,))
                         .astype(np.int32)).cuda()
    t, eps, drop = dit.draw(torch.Generator(device="cuda").manual_seed(
        SEED + 9), x0, cfg)
    ab = dit._alphas_bar(1000, x0.device)[t][:, None, None, None]
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    yd = torch.where(drop, torch.full_like(y, cfg.num_classes), y)

    def run(c):
        loss, g = value_and_grad(lambda p: dit.diffusion_loss_given(
            p, x0, y, t, eps, drop, c), params)
        with torch.no_grad():
            out = dit.forward(params, xt, t, yd, c)
        flat = {}
        for k, v in g.items():
            if isinstance(v, dict):
                flat.update({f"{k}/{kk}": vv.float() for kk, vv in v.items()})
            else:
                flat[k] = v.float()
        return float(loss), out.float().reshape(-1), flat

    res = {"kernel": run(cfg)}
    with _plain_kernels():
        res["ref"] = run(cfg)
    with _plain_kernels(fault="dcap"):
        res["fault"] = run(cfg)
    with _plain_kernels():
        res["f32"] = run(cfg32)
    groups: dict = {}
    for n in res["f32"][2]:
        groups.setdefault(_dit_group(n), []).append(n)
    out = _grad_ratios(res, groups, first="model_out")
    _emit({"phase": "grad_check_dit", "layers": layers, "batch": batch,
           "head_dim": cfg.head_dim, "ratio_tol": GRAD_VS_F32_RATIO,
           "fault_groups": _DIT_FAULT_GROUPS, **out})
    del res, params
    torch.cuda.empty_cache()
    _check_grad_ratios(out, groups, _DIT_FAULT_GROUPS, "dcap",
                       first="model_out")
    return out


# ------------------------------------- 10. generate (bench.py's serving)
GEN_PROMPT = 8192               # bench.py:236 run_prefill
DEC_PROMPT, DEC_NEW = 512, 128  # bench.py:270 run_decode
# The w8 logits against the bf16 tree's: max |difference| over max
# |logit| within the JAX package's own bound
# (tests/test_generation.py:337-338), held at that test's config (the
# tiny Llama, 2 layers, a batch of 2 x 8 tokens). The bound does not
# carry over to the flagship widths: there every weight's int8 rounding
# (~0.9 % of its column's scale) moves the logits of 11 random layers by
# more (max |diff| / max |logit| read 0.115 on an H100 SXM at 700 W),
# for JAX's quantizer as for the port's (the CPU tests hold the two
# equal). There the w8 logits are
# held to a twin of that rounding: the bf16 tree with every quantized
# weight moved by noise uniform in +-scale / 2, the rounding's own
# distribution. A faithful w8 path is as far from the bf16 logits as the
# twin (relative RMS distance; 1.5x for the spread between two such
# draws, as LOGITS_VS_F32_RATIO); a planted fault, each layer's scales
# read from the next layer's, must land outside.
W8_LOGITS_TOL = 5e-2
W8_NOISE_RATIO = 1.5
# the prefill logits check: 2 layers, a prompt of this many tokens
CHECK_LAYERS, CHECK_PROMPT = 2, 4096


def _prefill_logits_check(params, cfg):
    """One prompt through `generation.forward_cached` at 2 layers, four
    ways: bf16 through the flash prefill ("kernel"), bf16 with
    use_flash=False (the grouped f32-score path, "ref"), the kernel with
    a planted off-by-one (its keys and values shifted one position on,
    "fault") and an f32 evaluation of the same weights ("f32",
    use_flash=False). Returns each bf16 path's relative RMS distance from
    the f32 logits and the kernel's and the fault's as ratios to the
    plain path's, as `_logits_check`."""
    import dataclasses
    from paddle_tpu_torch.nlp import generation
    c2 = dataclasses.replace(cfg, num_hidden_layers=CHECK_LAYERS)
    p2 = dict(params)
    p2["layers"] = {k: v[:CHECK_LAYERS] for k, v in params["layers"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size, (1, CHECK_PROMPT),
                           device="cuda", generator=gen)
    flash = generation.flash_attention_fwd

    def shifted(q, k, v, causal=True, **kw):
        def shift(t):
            return torch.cat([t[:, :1], t[:, :-1]], dim=1)
        return flash(q, shift(k), shift(v), causal, **kw)

    runs = {"kernel": c2, "ref": dataclasses.replace(c2, use_flash=False),
            "fault": c2, "f32": dataclasses.replace(
                c2, dtype=torch.float32, use_flash=False)}
    out = {}
    for name, c in runs.items():
        cache = generation.init_cache(c, 1, CHECK_PROMPT + 64)
        generation.flash_attention_fwd = shifted if name == "fault" \
            else flash
        try:
            out[name], _ = generation.forward_cached(p2, prompt, cache, 0, c)
        finally:
            generation.flash_attention_fwd = flash
        del cache
    f32 = out.pop("f32")

    def rel(a):
        return ((a - f32).norm() / f32.norm()).item()

    res = {f"{n}_vs_f32": rel(a) for n, a in out.items()}
    res["kernel_ratio"] = res["kernel_vs_f32"] / res["ref_vs_f32"]
    res["fault_ratio"] = res["fault_vs_f32"] / res["ref_vs_f32"]
    res.update({"layers": CHECK_LAYERS, "prompt": CHECK_PROMPT})
    return res


def _decode_graph_check(params, cfg, batch=8, new_tokens=16):
    """`generate`'s decode step eagerly and replayed from its CUDA graph,
    each after its own prefill of one prompt (batch x DEC_PROMPT): the
    tokens must be identical, the prefill must launch the flash forward
    once a layer and the decode steps (capture and replays) never; a
    second call of the graphed one (a new prefill, the same graph) must
    give the same tokens again."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.nlp import generation
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab_size, (batch, DEC_PROMPT),
                           device="cuda", generator=gen)
    res, toks = {}, {}
    for graphed in (False, True):
        g = generation._Generate(params, cfg, batch, DEC_PROMPT, new_tokens,
                                 1.0, 0, 1.0, True, None, 0, None, "cuda",
                                 graphed)
        flash_attention_fwd.launches = 0
        g.prefill(prompt)
        pre = flash_attention_fwd.launches
        flash_attention_fwd.launches = 0
        g.decode()
        torch.cuda.synchronize()
        name = "graph" if graphed else "eager"
        res[name] = {"prefill_flash_launches": pre,
                     "decode_flash_launches": flash_attention_fwd.launches}
        toks[name] = g.out.clone()
        if graphed:
            toks["graph_again"] = g(prompt)
        del g
    res["tokens_equal"] = bool(torch.equal(toks["eager"], toks["graph"]))
    res["again_equal"] = bool(torch.equal(toks["graph"],
                                          toks["graph_again"]))
    res["tokens_row0"] = toks["graph"][0].tolist()
    return res


def _int8_noise_twin(params, q, gen):
    """The bf16 tree with each weight that `q` quantizes moved by noise
    uniform in +-scale / 2 (its column's int8 step)."""
    def twin(w, scale):
        u = torch.rand(w.shape, device=w.device, generator=gen) - 0.5
        return (w.float() + u * scale).to(w.dtype)

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for tree, qt in ((out["layers"], q["layers"]), (out, q)):
        for name in [k[:-len(":scale")] for k in qt if k.endswith(":scale")]:
            tree[name] = twin(tree[name], qt[name + ":scale"])
    return out


def _w8_logits_check(params, cfg, batch=8):
    """The prefill logits of `quantize_for_serving(bits=8)`'s tree against
    the bf16 tree's: at the JAX test's config (max |diff| / max |logit|,
    held to W8_LOGITS_TOL), then at the flagship widths and full depth
    (batch x DEC_PROMPT): the w8 tree, its int8-noise twin and the
    planted fault, each as relative RMS and max distance from the bf16
    logits, with the share of positions whose greedy token agrees."""
    from paddle_tpu_torch.nlp import generation, llama
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def logits(tree, c, prompt):
        cache = generation.init_cache(c, prompt.shape[0],
                                      prompt.shape[1] + 1)
        return generation.forward_cached(tree, prompt, cache, 0, c)[0]

    def max_rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    tcfg = llama.LlamaConfig.tiny(use_flash=False, num_hidden_layers=2)
    tiny = llama.init_params(tcfg, gen)
    tprompt = torch.randint(0, tcfg.vocab_size, (2, 8), device="cuda",
                            generator=gen)
    res = {"jax_test_config": {"max_rel_err": max_rel(
        logits(generation.quantize_for_serving(tiny, 8), tcfg, tprompt),
        logits(tiny, tcfg, tprompt))}}
    prompt = torch.randint(0, cfg.vocab_size, (batch, DEC_PROMPT),
                           device="cuda", generator=gen)
    ref = logits(params, cfg, prompt)
    q = generation.quantize_for_serving(params, 8)
    fault = dict(q)
    fault["layers"] = {k: v.roll(1, 0) if k.endswith(":scale") else v
                       for k, v in q["layers"].items()}
    for name, tree in (("w8", q), ("noise_twin", None), ("fault", fault)):
        if tree is None:
            tree = _int8_noise_twin(params, q, gen)
        lg = logits(tree, cfg, prompt)
        res[name] = {"rms_rel": ((lg - ref).norm() / ref.norm()).item(),
                     "max_rel_err": max_rel(lg, ref),
                     "greedy_agree": (lg.argmax(-1) == ref.argmax(-1))
                     .float().mean().item()}
        del lg, tree
    res["w8_ratio"] = res["w8"]["rms_rel"] / res["noise_twin"]["rms_rel"]
    res["fault_ratio"] = res["fault"]["rms_rel"] / \
        res["noise_twin"]["rms_rel"]
    return res


def _sampled_check(params, cfg, batch=8, new_tokens=8):
    """Sampling through the CUDA graph (the generator's state registered
    with it): two runs from one seed give the same tokens, in range."""
    from paddle_tpu_torch.nlp import generation
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    prompt = torch.randint(0, cfg.vocab_size, (batch, 64), device="cuda",
                           generator=gen)
    outs = [generation.generate(
        params, prompt, cfg, max_new_tokens=new_tokens, greedy=False,
        temperature=0.8, top_k=50, top_p=0.9,
        key=torch.Generator(device="cuda").manual_seed(7))
        for _ in range(2)]
    return {"equal": bool(torch.equal(*outs)),
            "in_range": bool(((outs[0] >= 0)
                              & (outs[0] < cfg.vocab_size)).all()),
            "distinct_tokens": int(outs[0].unique().numel())}


def phase_generate(peaks):
    """bench.py's serving runs through `nlp/generation.py` at the flagship
    2B widths (random bf16 weights): the prefill of an 8192-token prompt
    (bench.py:236), greedy decode of 128 tokens after 512 at batch 8 from
    the bf16 tree and from `quantize_for_serving(bits=8)`'s, and at batch
    32 from the w8 tree (bench.py:270, :389-393), each by
    `tools/bench.py`'s protocol; then the checks."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.tools import bench
    cfg = llama.LlamaConfig.flagship_2b(
        max_position_embeddings=GEN_PROMPT + 256)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    prefill = bench.run_prefill(GEN_PROMPT, timed=4, cfg=cfg, params=params)
    prefill.update({"prompt": GEN_PROMPT, "prefills": 5,
                    "flash_launches": flash_attention_fwd.launches,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    dcfg = llama.LlamaConfig.flagship_2b(
        max_position_embeddings=DEC_PROMPT + DEC_NEW)
    decode = {}
    for name, batch, bits in (("bf16_b8", 8, None), ("w8_b8", 8, 8),
                              ("w8_b32", 32, 8)):
        torch.cuda.reset_peak_memory_stats()
        flash_attention_fwd.launches = 0
        r = bench.run_decode(batch, DEC_PROMPT, DEC_NEW, timed=3,
                             weight_only=bits, cfg=dcfg, params=params)
        r.update({"batch": batch, "weight_only": bits, "calls": 4,
                  "step_ms": r["generate_ms"] / DEC_NEW,
                  "flash_launches": flash_attention_fwd.launches,
                  "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        decode[name] = r
    graph = _decode_graph_check(params, dcfg)
    sampled = _sampled_check(params, dcfg)
    w8 = _w8_logits_check(params, dcfg)
    torch.cuda.empty_cache()
    logits = _prefill_logits_check(params, cfg)
    del params
    torch.cuda.empty_cache()
    res = {"phase": "generate",
           "config": "flagship_2b (bench.py:120) via bench.py:236, :270",
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": L, "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size},
           "param_init_s": init_s, "prefill": prefill, "decode": decode,
           "graph_check": graph, "sampled_check": sampled,
           "w8_logits": w8, "w8_logits_tol": W8_LOGITS_TOL,
           "w8_noise_ratio_tol": W8_NOISE_RATIO,
           "prefill_logits_check": logits,
           "logits_vs_f32_ratio_tol": LOGITS_VS_F32_RATIO,
           "launches": {"flash_attention_fwd": prefill["flash_launches"]},
           "seq": GEN_PROMPT, "nvidia_smi": _smi_line()}
    _emit(res)
    if prefill["flash_launches"] != L * prefill["prefills"]:
        raise AssertionError(f"{prefill['flash_launches']} flash launches "
                             f"in {prefill['prefills']} prefills, expected "
                             f"{L} each")
    for name, r in decode.items():
        if r["flash_launches"] != L * r["calls"]:
            raise AssertionError(f"decode {name}: {r['flash_launches']} "
                                 f"flash launches in {r['calls']} calls, "
                                 f"expected {L} each (the prefill)")
    for name in ("eager", "graph"):
        if graph[name] != {"prefill_flash_launches": L,
                           "decode_flash_launches": 0}:
            raise AssertionError(f"{name} decode: launches {graph[name]}, "
                                 f"expected {L} a prefill and 0 decoding")
    if not (graph["tokens_equal"] and graph["again_equal"]):
        raise AssertionError(f"the graph-replayed tokens differ from the "
                             f"eager step's: {graph}")
    if not (sampled["equal"] and sampled["in_range"]):
        raise AssertionError(f"sampled decode: {sampled}")
    if not w8["jax_test_config"]["max_rel_err"] <= W8_LOGITS_TOL:
        raise AssertionError(f"w8 logits at the JAX test's config: "
                             f"{w8['jax_test_config']} from the bf16 "
                             f"tree's, more than {W8_LOGITS_TOL}")
    if not w8["w8_ratio"] <= W8_NOISE_RATIO:
        raise AssertionError(f"w8 logits: {w8['w8_ratio']} x their int8 "
                             f"noise twin's distance: {w8}")
    if not w8["fault_ratio"] > W8_NOISE_RATIO:
        raise AssertionError(f"w8 logits: the planted scale fault reads "
                             f"{w8['fault_ratio']} x, within the bound: "
                             f"{w8}")
    if not logits["kernel_ratio"] <= LOGITS_VS_F32_RATIO:
        raise AssertionError(f"prefill logits: the flash prefill is "
                             f"{logits['kernel_ratio']} x the plain bf16 "
                             f"path's distance from f32: {logits}")
    if not logits["fault_ratio"] > LOGITS_VS_F32_RATIO:
        raise AssertionError(f"prefill logits: the planted off-by-one reads "
                             f"{logits['fault_ratio']} x, within the bound: "
                             f"{logits}")
    return res


# ------------------------------ 11-13. long8k, layer8b, train05b (bench.py)
# launches a dense step makes: with per-layer recompute the forward
# kernels run twice a layer (the forward and the backward's recompute),
# two RMSNorms a layer; the 8-bit AdamW once a leaf
def _dense_launches_per_step(cfg, adamw_q: bool):
    from paddle_tpu_torch.nlp import llama
    L, fwd = cfg.num_hidden_layers, 2 if cfg.remat else 1
    shapes = llama._shapes(cfg)
    leaves = len(shapes) - 1 + len(shapes["layers"])
    return {"flash_attention_fwd": fwd * L, "flash_attention_bwd": L,
            "rms_norm_fwd": 2 * fwd * L, "rms_norm_bwd": 2 * L,
            "adamw_q": leaves if adamw_q else 0}


def _check_launches(name, res, per_step, steps):
    for k, n in per_step.items():
        if res["launches"][k] != n * steps:
            raise AssertionError(f"{name}: {k} launched {res['launches'][k]}"
                                 f" times in {steps} steps, expected {n} a "
                                 f"step")


def _dense_phase(peaks, name, config, cfg, batch, seq, state_quant,
                 warmup=2, timed=4):
    from paddle_tpu_torch.nlp import llama
    res, state, _ = _drive_train(peaks, llama, cfg, batch, _train_counters(),
                                 warmup, timed, seq, state_quant=state_quant)
    res = {"phase": name, "config": config,
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size,
                      "param_dtype": str(cfg.param_dtype)},
           **res, "nvidia_smi": _smi_line()}
    _emit(res)
    del state
    torch.cuda.empty_cache()
    _check_losses(res)
    _check_launches(name, res, _dense_launches_per_step(
        cfg, state_quant is not None), res["steps"])
    return res


def phase_long8k(peaks):
    """bench.py:381: the flagship 2B at 2 x 8192, 8-bit AdamW, clip 1.0."""
    from paddle_tpu_torch.nlp import llama
    cfg = llama.LlamaConfig.flagship_2b(max_position_embeddings=8192)
    return _dense_phase(peaks, "long8k", "flagship_2b at 2 x 8192 "
                        "(bench.py:381)", cfg, 2, 8192, "8bit")


def phase_train05b(peaks):
    """bench.py:372-376: the round-1 ~0.5B config, f32 params, the tree
    adamw (f32 moments) behind a clip of 1.0, at 16 x 2048."""
    from paddle_tpu_torch.tools import bench
    return _dense_phase(peaks, "train05b", "cfg05 (bench.py:372-376), "
                        "f32 Adam", bench.cfg_05b(), 16, 2048, None)


def phase_layer8b(peaks, timed=8):
    """bench.py:308: one Llama-3-8B layer, batch 1, S 4096 and 8192,
    through `tools/bench.run_8b_layer` (1 warm-up and `timed` steps of
    the weights' gradient); MFU by bench.py:344-346's count."""
    from paddle_tpu_torch.tools import bench
    counters = {n: c for n, c in _train_counters().items()
                if n != "adamw_q"}
    runs = {}
    for seq in (4096, 8192):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        r = bench.run_8b_layer(seq, timed_steps=timed)
        res = {"phase": "layer8b", "config": "llama3_8b, 1 layer "
               "(bench.py:308)", "batch": 1, "seq": seq, "steps": 1 + timed,
               **r, "tokens_per_s": seq / r["step_ms"] * 1e3,
               "launches": {n: c.launches for n, c in counters.items()},
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "nvidia_smi": _smi_line()}
        _emit(res)
        if not (np.isfinite(res["mfu"]) and res["mfu"] > 0):
            raise AssertionError(f"layer8b S={seq}: MFU {res['mfu']}")
        _check_launches(f"layer8b S={seq}", res, {
            "flash_attention_fwd": 1, "flash_attention_bwd": 1,
            "rms_norm_fwd": 2, "rms_norm_bwd": 2}, res["steps"])
        runs[f"layer8b_{seq // 1024}k"] = res
    return runs


# "main": for each path that launches the kernel, the case at that
# path's shape whose times the kernels line reports (its index among the
# kernel's cases, or among those of the path where cases name their
# "path"); the first path's also stand at the entry's top level. A case
# with "step_launches" is launched that often a step of its path: the
# line adds up those cases' times per step.
_KERNELS = {
    "flash_attention_fwd": {
        "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:51",
        # serve: S=512, the top prefill bucket; train: B=8 S=2048 + LSE;
        # train_moe: B=20 S=2048 H=16 + LSE; eager: B=64 S=512 H=12
        # hd=64 non-causal + LSE; eager_llama: B=2 S=2048 + LSE; ernie:
        # B=64 S=512 H=12 hd=64 bhsd key-masked + LSE
        # dit: B=96 S=256 H=16 hd=72 bhsd non-causal + LSE; generate: the
        # prefill, B=1 S=8192; long8k: B=2 S=8192 + LSE; layer8b: B=1
        # S=4096 and 8192 + LSE; train05b: B=16 S=2048 H=16 + LSE
        "rows": [1],
        "main": {"serve": 1, "serve_prefix": 1, "serve_quant_spec": 1,
                 "train": 3,
                 "train_moe": 4, "eager": 5,
                 "eager_llama": 6, "ernie": 7, "dit": 12, "generate": 14,
                 "long8k": 15, "layer8b_4k": 16, "layer8b_8k": 17,
                 "train05b": 18}},
    "ragged_paged_attention": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "rows": [18],
        # the decode case; its count takes every launch, of any option
        "main": {"serve": 0, "serve_prefix": 0, "serve_quant_spec": 0}},
    # row 18's two options, counted apart: `quantized=True` (int8 pools)
    # held at the int8 decode batch, `suffix=True` (the speculative slab)
    # at the chain verify
    "ragged_paged_attention_int8": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "option": "quantized=True", "rows": [18],
        "main": {"serve_quant_spec": 0, "serve_prefix": 0}},
    "ragged_paged_attention_suffix": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "option": "suffix=True", "rows": [18],
        "main": {"serve_quant_spec": 0}},
    "flash_attention_bwd": {
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:277",
        "also_replaces": ["paddle_tpu/kernels/flash_attention.py:360",
                          "paddle_tpu/kernels/flash_attention.py:446",
                          "paddle_tpu/kernels/flash_attention.py:503"],
        "rows": [2, 3, 4, 5],
        "main": {"train": 0, "train_moe": 2, "eager": 3, "eager_llama": 4,
                 "ernie": 5, "dit": 10, "long8k": 12, "layer8b_4k": 1,
                 "layer8b_8k": 13, "train05b": 14}},
    "rms_norm_fwd": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:107",
        "rows": [7],
        # long8k's 2 x 8192 rows are the dense step's [16384, 4096]
        "main": {"train": 0, "train_moe": 1, "long8k": 0, "layer8b_4k": 3,
                 "layer8b_8k": 2, "train05b": 4}},
    "rms_norm_bwd": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:115",
        "rows": [8],
        "main": {"train": 0, "train_moe": 1, "long8k": 0, "layer8b_4k": 3,
                 "layer8b_8k": 2, "train05b": 4}},
    "adamw_q": {
        "source": "paddle_tpu_torch/csrc/adamw_q.cu",
        "replaces": "paddle_tpu/optimizer/quant_state.py:227",
        "rows": [17],
        # the largest leaves: [11, 4096, 9472]; [12, 16, 2048, 1024];
        # long8k trains the dense step's tree
        "main": {"train": 0, "train_moe": 0, "long8k": ("train", 0)}},
    "gather_wsum": {
        "source": "paddle_tpu_torch/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:244",
        "rows": [14],
        "main": {"train_moe": 1}},        # the combine forward, k=2
    "gather_scale_dot": {
        "source": "paddle_tpu_torch/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:348",
        "rows": [15],
        "main": {"train_moe": 0}},        # the combine backward
    "layer_norm_fwd": {
        "source": "paddle_tpu_torch/csrc/layer_norm.cu",
        "replaces": "paddle_tpu/kernels/layer_norm.py:38",
        "rows": [9],
        "main": {"eager": 0}},            # f32 [32768, 768]
    "layer_norm_bwd": {
        "source": "paddle_tpu_torch/csrc/layer_norm.cu",
        "replaces": "paddle_tpu/kernels/layer_norm.py:53",
        "rows": [10],
        "main": {"eager": 0}},
    "rms_norm_fused": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:28",
        "rows": [6],
        "main": {"eager_llama": 0}},      # f32 [4096, 4096]
    # no path of the JAX package launches rows 11-13 and 16, nor does the
    # port's: "held" names the case (at DiT-XL/2's or the MoE step's
    # shapes) whose times the line reports, and dit's run counts their
    # launches (0)
    "adaln_fwd": {
        "source": "paddle_tpu_torch/csrc/adaln.cu",
        "replaces": "paddle_tpu/kernels/adaln.py:42",
        "rows": [11], "main": {}, "held": 0, "counted_in": "dit"},
    "adaln_bwd": {
        "source": "paddle_tpu_torch/csrc/adaln.cu",
        "replaces": "paddle_tpu/kernels/adaln.py:54",
        "rows": [12], "main": {}, "held": 0, "counted_in": "dit"},
    "gather_rows": {
        "source": "paddle_tpu_torch/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:80",
        "rows": [13], "main": {}, "held": 0, "counted_in": "dit"},
    "gather_mlp": {
        "source": "paddle_tpu_torch/csrc/gather_mlp.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:553",
        "rows": [16], "main": {}, "held": 0, "counted_in": "dit"},
}
_TIMES = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# the JAX package's flash backward streams (rows 2-4) above this length
# (`_RESIDENT_MAX_SEQ`, flash_attention.py:274) and runs row 5 below it
_RESIDENT_MAX_SEQ = 2048


def _kernels_line(cases, runs):
    kernels = []
    for name, meta in _KERNELS.items():
        by_path = {}
        for path, i in meta["main"].items():
            # a path whose case is another path's names it: (path, index)
            of, i = i if isinstance(i, tuple) else (path, i)
            pool = [c for c in cases[name] if c.get("path", of) == of]
            by_path[path] = {"launches": runs[path]["launches"][name],
                             **{k: pool[i][k] for k in _TIMES
                                + ("graph_ms",) if k in pool[i]}}
            steps = [c for c in pool if "step_launches" in c]
            if steps:
                # the times of one step's launches at their shapes
                by_path[path]["per_step"] = {
                    k: sum(c[k] * c["step_launches"] for c in steps)
                    for k in ("ms", "plain_ms", "bound_ms")}
        if by_path:
            top = next(iter(by_path.values()))
            launches = sum(r["launches"] for r in by_path.values())
        else:
            top = cases[name][meta["held"]]
            launches = runs[meta["counted_in"]]["launches"][name]
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "rows": meta["rows"],
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "max_rel_err": max(c["max_rel_err"] for c in cases[name]),
            **{k: top[k] for k in _TIMES}, "kernel_ms": top["ms"],
            "by_path": by_path}
        if "graph_ms" in top:
            entry["graph_ms"] = top["graph_ms"]
        if "option" in meta:
            entry["option"] = meta["option"]
        if "also_replaces" in meta:
            entry["also_replaces"] = meta["also_replaces"]
            # the JAX package's rows by length: streamed 2-4, resident 5
            streamed = sum(r["launches"] for p, r in by_path.items()
                           if runs[p].get("seq", 0) > _RESIDENT_MAX_SEQ)
            entry["launches_by_row"] = {"2-4": streamed,
                                        "5": launches - streamed}
        if not by_path:
            entry["held_at"] = top["shape"]
        kernels.append(entry)
    rows = sorted({r for k in kernels for r in k["rows"]})
    if rows != list(range(1, 19)):
        raise AssertionError(f"the kernels line covers rows {rows}, not "
                             f"the 18 pallas_call sites")
    return kernels


def main() -> int:
    info = phase_device()
    _, peaks = _peaks(info["kind"])
    phase_build()
    cases = phase_kernels(peaks)
    serve = phase_serve()
    _release()
    serve_prefix = phase_serve_prefix()
    quant_spec = phase_serve_quant_spec()
    _release()
    train = phase_train(peaks)
    phase_grad_check()
    train_moe = phase_train_moe(peaks)
    phase_grad_check_moe()
    torch.cuda.empty_cache()
    eager = phase_eager(peaks)
    phase_grad_check_eager()
    eager_llama = phase_eager_llama(peaks)
    phase_grad_check_eager_llama()
    ernie = phase_ernie(peaks)
    phase_grad_check_ernie()
    dit = phase_dit(peaks)
    phase_grad_check_dit()
    generate = phase_generate(peaks)
    long8k = phase_long8k(peaks)
    layer8b = phase_layer8b(peaks)
    train05b = phase_train05b(peaks)
    runs = {"serve": serve, "serve_prefix": serve_prefix,
            "serve_quant_spec": quant_spec, "train": train,
            "train_moe": train_moe,
            "eager": eager, "eager_llama": eager_llama, "ernie": ernie,
            "dit": dit, "generate": generate, "long8k": long8k, **layer8b,
            "train05b": train05b}
    _emit({"kernels": _kernels_line(cases, runs)})
    print(_smi_line(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
