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
  4c. serve_robust — at the serve sizing, one weight tree shared by
               every engine: (a) quarantine on a warmed engine (a
               rid-scoped poison fails only its request, a step-scoped
               transient convicts nobody and its riders retry; a failed
               speculative verify over int8 KV turns speculation off for
               its riders, so row 18's suffix option stops), with the
               probes capturing nothing; KV snapshots exported, imported
               in place and exported again byte-identical (fp and int8
               pools), a wrong fingerprint refused; (b) a disaggregated
               prefill/decode Router (every request migrates, zero
               prefill on the decode replica); (c) a 2-replica Router
               with the watchdog and auto_restart: a finite hang wedges
               r0, its requests fail over to r1 with strict-prefix
               streams, the supervisor rebuilds r0 while r1 serves and
               r0 rejoins; (d) an HttpFrontend on 127.0.0.1:0 over it.
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
  8a. eager_llama_o2 — the same Llama under O2: `amp.decorate(model,
               opt, level="O2")` casts every parameter, AdamW (lr 1e-4,
               the global clip, weight_decay=L2Decay(0.01)) keeps f32
               masters; run (a) in bf16, run (b) in f16 with
               GradScaler(2**15) driven as scaler.minimize(opt,
               scaler.scale(loss)); 2 warm-up and 4 timed steps each.
               Row 6 exactly 23 a step and the flash pair 11 + 11, all in
               the run's dtype (counted by dtype) and none in the other;
               step ms, tokens/s, MFU, peak memory against phase 8's,
               losses, the scale's trajectory. Then
               grad_check_eager_llama_f16: phase 8's check at 2 layers
               under O2 f16 (loss times 2**15), the same planted fault.
  8b. eager_o2 — phase 7's recipe under O2 f16 with GradScaler(2**15):
               the LayerNorm pair 25 + 25 and the flash pair 12 + 12 a
               timed step, all in f16; between the timed steps one
               step's loss is multiplied by inf, and the scaler must
               skip it (every parameter and master bit-identical),
               halve the scale, and the later losses be finite.
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

  14. predict — `inference.create_predictor` serving the flagship 2B
               (generate's tree of random bf16 weights, written by
               `inference.llm.save_llm` into a temporary directory): the dense greedy run (8
               prompts of 512, 128 new; the flash prefill, then the
               decode step from one CUDA graph), the paged run (8
               right-padded prompts of 128-512, block 64; row 18 each
               decode step) and the int8 weight-only run, twice each;
               tokens equal to `generate` / `paged_generate` called
               directly; exactly 11 flash launches a run, row 18 only in
               the paged runs; write and load seconds, tokens/s.
  15. resnet50 — BASELINE config 0 on the eager API
               (`tools/resnet_train.py`): resnet50 at 224x224, batch 256,
               Momentum 0.9, weight decay 1e-4, PiecewiseDecay from 0.1,
               in f32 with TF32 and under O1 bf16; device-fed (2 warm-up
               and 4 timed steps) and loader-fed (one epoch of 8192
               seeded uint8 256x320 images, 4 batches a worker, through
               RandomResizedCrop, RandomHorizontalFlip, Normalize and
               Transpose in 8 DataLoader workers over the shared-memory
               ring): images/s, MFU (6 x the forward's conv and fc MACs
               an image), peak memory, the loader's start-up and its
               steady images/s and wait share; the losses must fall and
               the BatchNorm statistics move. Then grad_check_resnet:
               resnet18 (2 x 3 x 64 x 64, f32, TF32 off) forward and one
               Momentum step on the card against the port's CPU run, a
               BatchNorm given torch's momentum convention and the
               Nesterov update as the planted faults.
  16. beam   — BeamSearchDecoder over an LSTMCell (hidden 512, vocab
               8000, batch 32, beam 4, 32 steps): the best beam's score
               against the teacher-forced sum of its log-probabilities.
  17. eager_optim — phase 7's ERNIE recipe under each of the nine
               per-step optimizers of the eager API's second half
               (Adagrad, RMSProp, Adamax, Lamb, Adadelta, Rprop, ASGD,
               NAdam, RAdam), 1 warm-up and 2 timed steps each from the
               same weights, every step under CUDA's sync debug mode at
               "error": the LayerNorm and flash pairs at exactly the
               eager counts, losses finite, every parameter moved, step
               ms and the device ms of the eager_optimizer span (one
               traced step); an LBFGS linear probe on the pooled
               features ([64, 768] -> 2, max_iter 20), its loss falling;
               Lamb under O2 f16 with GradScaler(2**15), every launch
               in f16, f16 parameters with f32 masters, losses falling.
               Then grad_check_optim: one step of each of the ten on the
               card against the port's CPU run over the real gradients
               of the ERNIE cut to 2 layers (TF32 off), parameters and
               states within OPTIM_STEP_TOL of their largest move, three
               planted faults at least 10 x above it. Then
               autograd_check: paddle.grad of the 2-layer ERNIE's loss
               for the embedding output bit for bit equal to a hook's
               record in backward (the kernels' backward launched in
               both, every .grad untouched), an R1 gradient penalty
               through create_graph on resnet18 against the CPU, and a
               user PyLayer over row 6 at [4096, 4096] bf16 against the
               built-in path.
  18. transformer — the Transformer base model of Vaswani et al. 2017
               (tools/eager_transformer.py: paddle.nn.Transformer at
               d_model 512, 8 heads, 6 + 6 layers, ffn 2048, dropout 0.1,
               attention dropout 0, a shared 37,000-token embedding tied
               to the output projection, the label-smoothed criterion),
               f32 parameters under O1 bf16, Adam under NoamDecay(512,
               4000), 2 warm-up and 4 timed steps of 96 x 256 source and
               target tokens: the non-causal flash pair exactly 12 + 12
               a step in bf16 (the encoder's self-attention and the
               cross-attention; the decoder's masked self-attention
               takes the exact path, as in the JAX package), no
               LayerNorm kernel; step ms, target tokens/s, MFU, peak
               memory; finite losses and the batch's dropout-free f32
               loss falling; CrossEntropyLoss(label_smoothing=0.1)
               against the criterion. Then grad_check_transformer (2 + 2
               layers, batch 8 x 256, the dcap fault as the control) and
               nn_check: every functional and loss of the slice on the
               card against the CPU (f32, TF32 off, eval mode for the
               random ones) and one step of the model under sync debug
               mode "error".

The f32 and f16 paths (run after phases 5 and 7):
  5a. train_f32 — phase 5's flagship at `LlamaConfig(dtype=float32,
               param_dtype=float32)`, full widths and depth, batch
               F32_TRAIN_BATCH (16, the largest multiple of 8 that fits)
               x 2048, the tree AdamW (f32 moments) behind the clip at
               1.0, lr 1e-4, 1 warm-up and 2 timed steps: the f32 flash
               pair (csrc/flash_f32.cu, TF32 tensor cores) and rows 7-8
               in f32 at exactly the dense step's counts, none in another
               dtype; losses finite and falling. The GEMMs stay
               torch.matmul at PyTorch's default (full f32).
  5b. train_f16 — the same entry points at dtype=float16 (f32
               parameters), full widths, 2 layers, 2 + 2 steps: rows 7-8
               and the flash pair in f16 at their exact counts; losses
               finite.
  5c. grad_check_f32 — one loss + backward at 2 layers, S 2048, f32,
               through the kernels, their plain f32 versions and the
               plain versions with the dcap fault: each gradient group
               (and the per-token losses) within F32_GRAD_TOL of the plain
               path, the fault at least 10 times that.
  7a. eager_f32 — phase 7's ERNIE recipe in f32 with no auto_cast: the
               flash pair 12 + 12 and LayerNorm 25 + 25 a step, all in
               f32; losses falling; MFU against the GEMMs' f32 rate.

The f16 and f32 options of rows 14, 15, 17 and 18:
  4d. serve_f16, serve_f32 (after serve_robust) — phase 4 with weights
               in f16 / f32 (its graph check left to bf16), then an
               int8-KV engine with a speculative chain of 4; every
               request finishes, the pool drains, row 18 runs only in
               the run's dtype (fp by graph replay, int8, suffix, each
               >= 1). The logits check: f16 within 1.5 x the plain f16
               path's distance from an f32 evaluation; f32 within 1.5 x
               the distance of a twin whose plain flash takes
               TF32-rounded operands (the f32 flash kernel multiplies on
               TF32), the off-by-one above both; and row 18 alone (the
               flash prefill on its plain version) no farther from the
               plain f32 path in the chunk and decode steps than a plain
               ragged attention RAGGED_F32_TOL off, which the plain
               ragged attention on TF32 operands must exceed.
  5d. train_p32 (after grad_check) — phase 5's recipe at
               `flagship_2b(param_dtype=float32)`, the JAX default: bf16
               compute, f32 parameters, 8-bit moments; row 17 exactly 12
               launches a step, all f32; the flash pair and rows 7-8 at
               the dense counts in bf16; losses falling.
  6a. train_moe_f32, train_moe_f16, grad_check_moe_f32 (after
               grad_check_moe) — the MoE config at dtype = param_dtype =
               float32 (12 layers, batch MOE_BATCH, 1 + 2 steps)
               and float16 (2 layers, 2 + 2 steps), 8-bit AdamW: rows
               14, 15 and 17 and the flash and norm kernels at exactly
               the step's counts, all in the run's dtype; f32 losses
               falling, f16 finite. Then the f32 MoE's gradients at 2
               layers against the plain f32 path, routing by the plain
               path's maps: <= F32_GRAD_TOL a group, the dispatch
               backward's second choice dropped at least 10 x that.
The kernels phase holds those options at the paths' shapes
(`_dtype_option_cases`): rows 14-15 at the MoE maps in f32 and f16, bit
for bit, each with a planted control 10 ulps or more off; row 17 over
every leaf size of the three trees, p within 2 f32 ulps / 1 f16 ulp,
codes within one e4m3 step, the decay-without-lr control 10 x above;
row 18 in f16 (F16_TOL) and f32 (RAGGED_F32_TOL, three TF32 parts) at
the decode, fused and full32 batches, over int8 pools and with the chain
and tree verify's slabs, each with a planted control 10 x above; the
f16 flash backward also at [1, 300, 4/1, 72] causal (held); the build
phase counts rows 14, 15, 17 and 18's functions by element type and
requires LDGSTS and HMMA in every ragged split kernel (f32's products
on TF32 mma.sync, three parts).

The kernels phase holds the f32 option of rows 1-5 (within F32_TOL,
the LSE within F32_LSE_TOL) at the eager ERNIE's [64, 512, 12, 64]
non-causal (also key-masked in 'bhsd' at the f32 finetune's padded
lengths, one batch row seeing no key), the flagship's [16, 2048, 32/8,
128] causal and DiT's [96, 256, 16, 72] 'bhsd', the f16 flash pair at the f16 trainer's
[16, 2048, 32/8, 128], and rows 7-8 in f32 (within RMS_F32_TOL) and f16
(within one f16 ulp of each row's scale) at [32768, 4096] with an f32
weight: each bit-identical on a second call, with a planted control
(keys shifted one position, dcap dropped, the weight one column off) at
least 10 times above its bound, its bound from the TF32 rate (495
TFLOP/s) or the bytes, and the library call's time (SDPA in f32,
F.rms_norm and ATen's fused RMSNorm backward where x and the weight
share a dtype). The kernels phase also holds the f16 options (the O2
runs' forms) of
the flash forward and backward at the eager Llama's B=2 x 2048 GQA 32/8
causal and the eager ERNIE's B=64 x 512 H=12 hd=64, of row 6 at
[4096, 4096] and of the LayerNorm pair at [32768, 768], within
F16_TOL, bit-identical twice, each with a planted control above the
bound, and row 6 in bf16 at [4096, 4096] (run (a)'s form); the build
phase counts the flash libraries' HGMMA and UTMALDG by element type.
It holds the fused LayerNorm forward and backward at
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
[4096, 4096] and [32768, 2048] with an f32 weight; and the predict
phase's flash prefill at B=8 S=512 and its paged decode (8 rows of 640
keys in blocks of 64). The kernels line
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
import re
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
# the same sheet's dense TF32 tensor-core rate
_TF32_PEAK = 495e12


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
# products (HGMMA) and TMA loads (UTMALDG; the f32 library's forward
# every product and its backward its score products on HGMMA, each of
# those kernels itself, and the backward's second products on mma.sync:
# HMMA); gather_mlp also its gathered
# rows' cp.async copies (LDGSTS) and xin's TMA stores (UTMASTG); the
# ragged library and the three norm libraries (the backward walks' rings)
# their cp.async copies (LDGSTS)
_SASS_MARKS = {"flash_fwd": ("HGMMA", "UTMALDG"),
               "flash_bwd": ("HGMMA", "UTMALDG"),
               "flash_f32": ("HMMA", "UTMALDG", "HGMMA"),
               "gather_mlp": ("HGMMA", "UTMALDG", "LDGSTS", "UTMASTG"),
               "ragged_paged_attention": ("LDGSTS",),
               "rms_norm": ("LDGSTS",), "layer_norm": ("LDGSTS",),
               "adaln": ("LDGSTS",)}


# the template argument of a kernel's mangled name: its element type
_SASS_TYPE = re.compile(r"kernelI(13__nv_bfloat16|6__half|f)")
_SASS_TAGS = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def _sass_by_function(sass, marks):
    """{function: (element type or None, {mark: count}, instructions)}
    of one library's `cuobjdump -sass` listing."""
    out = {}
    for fn in sass.split("Function : ")[1:]:
        head, body = fn.split("\n", 1)
        m = _SASS_TYPE.search(head)
        out[head.strip()] = (_SASS_TAGS[m.group(1)] if m else None,
                             {k: body.count(k) for k in marks},
                             body.count(";"))
    return out


def _typed_sass(_build):
    """Rows 14, 15, 17 and 18 by element type: each library's functions
    whose template argument is bf16, f16 or f32, with their instruction
    count and LDGSTS / HMMA / FFMA counts. Raises unless every ragged
    split kernel holds LDGSTS (its cp.async ring) and HMMA (its mma.sync
    products: bf16 and f16 at k16, f32 in TF32 parts at k8), and every
    library has functions of all three types."""
    out = {}
    marks = ("LDGSTS", "HMMA", "FFMA")
    for name in ("moe_dispatch", "adamw_q", "ragged_paged_attention"):
        sass = subprocess.run(
            [_build.cuobjdump(), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        fns = _sass_by_function(sass, marks)
        by = {}
        for head, (tag, counts, n) in fns.items():
            if tag is None:
                continue
            d = by.setdefault(tag, {"functions": 0, "instructions": 0,
                                    **{k: 0 for k in marks}})
            d["functions"] += 1
            d["instructions"] += n
            for k, v in counts.items():
                d[k] += v
            if "ragged_split_kernel" in head and (
                    not counts["LDGSTS"] or not counts["HMMA"]):
                raise AssertionError(f"{name}: {head} has {counts}")
        if sorted(by) != ["bf16", "f16", "f32"]:
            raise AssertionError(f"{name}: element types {sorted(by)} in "
                                 f"its SASS")
        out[name] = by
    return out


def _sass_counts(_build):
    """How many of each instruction in _SASS_MARKS `cuobjdump -sass` finds
    in each library named there; raises where one is missing. The flash
    libraries' counts also by the kernels' element type ("by_dtype":
    the functions whose mangled names hold __nv_bfloat16 or __half), each
    of which must hold them too; rows 14, 15, 17 and 18 by element type
    (`_typed_sass`)."""
    counts = {"typed": _typed_sass(_build)}
    for name, marks in _SASS_MARKS.items():
        sass = subprocess.run(
            [_build.cuobjdump(), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {m: sass.count(m) for m in marks}
        if not all(counts[name].values()):
            raise AssertionError(f"{name}: no {counts[name]} in its SASS")
        if name in ("flash_fwd", "flash_bwd"):
            by = {"bf16": {m: 0 for m in marks}, "f16": {m: 0 for m in marks}}
            for fn in sass.split("Function : ")[1:]:
                head = fn.split("\n", 1)[0]
                tag = "f16" if "__half" in head else \
                    "bf16" if "bfloat16" in head else None
                for m in marks:
                    if tag is not None:
                        by[tag][m] += fn.count(m)
            counts[name]["by_dtype"] = by
            if not all(v for d in by.values() for v in d.values()):
                raise AssertionError(f"{name}: {by} by dtype in its SASS")
        if name == "flash_f32":
            # each backward pass's kernels (dkdv, dq; hd 64, 72, 128) and
            # each forward kernel (hd 64, 72, 128), by function
            fns = _sass_by_function(sass, ("HGMMA",))
            bwd = {head.split("(")[0]: c["HGMMA"]
                   for head, (_, c, _) in fns.items()
                   if "dkdv_kernel" in head or "dq_kernel" in head}
            fwd = {head.split("(")[0]: c["HGMMA"]
                   for head, (_, c, _) in fns.items() if "fwd_kernel" in head}
            counts[name]["bwd_hgmma"] = bwd
            counts[name]["fwd_hgmma"] = fwd
            if len(bwd) != 6 or not all(bwd.values()):
                raise AssertionError(f"{name}: backward HGMMA {bwd}")
            if len(fwd) != 3 or not all(fwd.values()):
                raise AssertionError(f"{name}: forward HGMMA {fwd}")
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


def _dt_label(dtype) -> str:
    """A case's dtype in its shape label: nothing for bf16."""
    return {torch.bfloat16: "", torch.float16: " f16",
            torch.float32: " f32"}[dtype]


def _flops_peak(dtype):
    """The tensor-core rate a flash case's bound takes: TF32 for the f32
    kernels, else the bf16/fp16 rate (None: peaks[0])."""
    return _TF32_PEAK if dtype == torch.float32 else None


def _qkv(B, S, hd, gen, layout="bshd", heads=(), dtype=torch.bfloat16):
    """Random [B, S, n, hd] in `dtype` for each n of `heads`, contiguous
    in `layout` ('bhsd': [B, n, S, hd])."""
    t = [torch.randn(B, S, n, hd, device="cuda", generator=gen).to(dtype)
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
                by_kv_head: bool = False, dtype=torch.bfloat16):
    """The flash forward against its plain version at one shape; with
    `lse`, as the training forward calls it, its LSE held too; with
    `by_kv_head`, the plain version one KV head's group at a time; the
    inputs in `dtype` (bf16; f16 or f32: the kernel's f16 or f32 option,
    whose bound takes the element's bytes and, in f32, the TF32 rate)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v = _qkv(B, S, hd, gen, layout, (H, KV, KV), dtype)
    kw = dict(causal=causal, return_lse=lse, layout=layout)
    plain_fn = _fwd_ref_by_kv_head if by_kv_head \
        else fa.flash_attention_fwd_ref
    out = fa.flash_attention_fwd(q, k, v, **kw)
    ref = plain_fn(q, k, v, **kw)
    res = {"shape": f"B={B} S={S} H={H} KV={KV} hd={hd}"
                    + (" (LSE)" if lse else "")
                    + ("" if causal else " non-causal")
                    + ("" if layout == "bshd" else f" {layout}")
                    + _dt_label(dtype)}
    if lse:
        (out, lse_k), (ref, lse_r) = out, ref
        res["lse_abs_err"] = (lse_k - lse_r).abs().max().item()
        lse_tol = F32_LSE_TOL if dtype == torch.float32 else LSE_TOL
        if not res["lse_abs_err"] <= lse_tol:
            raise AssertionError(f"flash B={B} S={S}: lse err "
                                 f"{res['lse_abs_err']} > {lse_tol}")
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
    nbytes = (q.element_size() * B * S * hd * (2 * H + 2 * KV)
              + (4.0 * B * H * S * lse))
    res.update({"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": plain, "library_ms": lib,
                **_bound(flops, nbytes, peaks, _flops_peak(dtype))})
    return _shares(res)


def _ragged_case(kind, H, KV, hd, gen, flush, bs=16, M=64):
    """Row 18 at one of bench_kernels' held batches (decode, fused,
    continue, full8, full32; blocks of `bs` keys, chains of up to `M`
    blocks) against its plain version, twice: within
    KERNEL_TOL (bench_kernels.TOL, the same 2e-2), invalid queries zero
    and the two outputs bit-identical; timed with the host in the loop
    and in one CUDA graph (`graph_ms`, device time, over pool copies
    that exceed the L2), beside the plain version's time."""
    from paddle_tpu_torch.nlp import ragged_attention as ra
    from paddle_tpu_torch.tools import bench_kernels as bk
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


def _ragged_option_case(kind, H, KV, hd, gen, flush, dtype=torch.bfloat16,
                        path=None):
    """Row 18's int8 option ("int8 <batch>", a `_ragged_case` batch over
    int8 twins of its pools), its suffix option (a `bench_kernels`
    SPEC_KINDS shape: chain verify, tree verify, draft step) or, for the
    f16 and f32 options, its fp pools at a `_ragged_case` batch, against
    the plain version as `_ragged_case` holds it (_RAGGED_TOLS[dtype],
    invalid queries zero, bit-identical twice, host and CUDA-graph times,
    the bound from this data's live bytes), plus a planted control that
    must read above the bound (10 times it for f16 and f32): the kernel
    run with each block's scales taken from the block before (int8; the
    fp pools are drawn with per-block magnitudes 1/4 to 4, as real K/V
    vary), with the slab visibility shifted by one row (suffix) or with
    every position one short (fp: each query loses its own key), held to
    the sound plain version. q, the fp pools and the slab in `dtype`."""
    from paddle_tpu_torch.nlp import ragged_attention as ra
    from paddle_tpu_torch.tools import bench_kernels as bk
    bs, M = 16, 64
    tol = _RAGGED_TOLS[dtype]
    bad_args = None
    if kind in bk.SPEC_KINDS:
        args, (pos, val), opts = bk.ragged_spec_batch(kind, H, KV, hd, bs, M,
                                                      gen, SEED, dtype)
        bad = dict(opts, suffix_vis=opts["suffix_vis"].roll(1, dims=-1)
                   .contiguous())
        control = "the slab visibility shifted by one row"
    elif kind.startswith("int8 "):
        args, (pos, val) = bk.ragged_batch(kind[5:], H, KV, hd, bs, M, gen,
                                           SEED, dtype)
        N = args[1].shape[0]
        f = torch.exp2(torch.rand(N, device="cuda", generator=gen) * 4 - 2)
        kc, vc, opts = bk.quantize_pools(
            (args[1].float() * f[:, None, None, None]).to(dtype),
            (args[2].float() * f[:, None, None, None]).to(dtype))
        args = (args[0], kc, vc, *args[3:])
        bad = {"k_scale": opts["k_scale"].roll(1),
               "v_scale": opts["v_scale"].roll(1)}
        control = "each block's scales from the block before"
    else:
        args, (pos, val) = bk.ragged_batch(kind, H, KV, hd, bs, M, gen, SEED,
                                           dtype)
        opts, bad = {}, {}
        bad_args = (*args[:4], (args[4] - 1).clamp(min=0), *args[5:])
        control = "every position one short"
    R, P = pos.shape
    live = np.where(val, pos + 1, 0).max(axis=1)
    slab = "" if "suffix_k" not in opts else \
        f" S={opts['suffix_k'].shape[1]}"
    res = bk.ragged_case(args, pos, val,
                         f"{kind} R={R} P={P}{slab} H={H} KV={KV} hd={hd} "
                         f"bs={bs} M={M} live={live.tolist()}"
                         + _dt_label(dtype), flush=flush, opts=opts,
                         tol=tol)
    if not res["ok"]:
        raise AssertionError(f"ragged {kind}{_dt_label(dtype)}: {res}")
    ref = ra.ragged_paged_attention_ref(*args, **opts)
    res["control"] = control
    res["control_rel_err"] = _rel_err(
        ra.ragged_paged_attention(*(bad_args or args), **{**opts, **bad}),
        ref, args[5][:, :, None] & (ref.float().abs().amax(-1) > 0))
    floor = tol if dtype == torch.bfloat16 else 10 * tol
    if not res["control_rel_err"] > floor:
        raise AssertionError(f"ragged {kind}{_dt_label(dtype)}: the planted "
                             f"control ({control}) reads "
                             f"{res['control_rel_err']}, within {floor}: "
                             f"the check cannot see it")
    if dtype != torch.bfloat16:
        res.update(dtype=_dt_label(dtype).strip(), bound=tol, path=path,
                   planted={control: res["control_rel_err"]})
    res["plain_ms"] = _time_ms(
        lambda: ra.ragged_paged_attention_ref(*args, **opts), 5, flush)
    res["library_ms"] = None
    del ref, args, opts, bad, bad_args
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
# The f16 options (rows 1-6, 9-10 under O2 f16): 2.5 * 2^-11 of the
# vector's largest |value|, 2.5 f16 ulps of a largest element at the top
# of its binade. Stricter than the bf16 bound taken bit for bit (2e-2 is
# 2.5 * 2^-7 at bf16's 7 mantissa bits, which at f16's 10 would be
# 2.4e-3): the kernel's and the plain version's outputs, each rounded
# to f16 once, may already be one ulp (2^-10 of the value) apart.
F16_TOL = 1.25e-3
_TOLS = {torch.bfloat16: KERNEL_TOL, torch.float16: F16_TOL}
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
# The f32 flash option (rows 1-5) multiplies on TF32 tensor cores (10
# mantissa bits, each operand rounded to nearest: 2^-11 relative); its
# plain version computes in full f32. The scores' products and dQ's take
# three TF32 parts (~2^-21), the others one, so out, dk and dv carry the
# rounding of P (or dS) and of V, dO or Q in each term: ~1e-3 of a
# vector's largest value at most. 2.5e-3 is 5 such roundings of the
# largest term; a key shifted one position reads ~1, a dropped dcap ~1.
F32_TOL = 2.5e-3
# Its LSE: the scores carry ~2^-21 of their scale (three TF32 parts), so
# the LSE, f32 in both versions, keeps LSE_TOL's argument: ~1e-5 apart.
F32_LSE_TOL = 1e-4
# The f16 training norms (rows 7-8, the f16 trainer's): kernel and plain
# version compute the same f32 expressions and round out and dx to f16
# once, so an element may land one f16 ulp apart: held per row to one
# ulp of the row's largest value (`_f16_ulps` <= 1).
F16_ULPS = 1.0
# The f32 trainer's gradient check (grad_check_f32): the kernel path and
# the plain f32 path differ only by the flash kernels' TF32 roundings
# (~2^-11 a term, averaged over a step's tokens), so each gradient
# group's relative RMS distance is ~1e-4; 2e-3 bounds it, and the
# planted fault (dcap dropped) must read 10 times above.
F32_GRAD_TOL = 2e-3
# 8-bit AdamW: params within one bf16 ulp (of the larger of the value
# before and after the step) of the plain version, float8
# codes within one e4m3 step of their value, scales to 1e-6 relative, and
# at most 0.1 % of codes different: both versions compute the same f32
# expressions, but the kernel contracts multiply-adds into FMAs, so a
# value within an ulp of a float8 rounding boundary may round either way.
# The f16 option rounds p once, as bf16 does: one f16 ulp. The f32 option
# does not round p to a narrower type, so it evaluates the plain
# version's expressions in their order with no contraction (adamw_q.cu):
# two f32 ulps of p.
ADAMW_CODE_FRAC = 1e-3
ADAMW_PARAM_ULPS = {torch.bfloat16: 1.0, torch.float16: 1.0,
                    torch.float32: 2.0}
# Row 18's f32 option multiplies in three TF32 parts (hi hi + hi lo + lo
# hi, ~2^-21 of a term), each k8 step's parts summed apart in f32; its
# plain version in f32 (cuBLAS f32 einsums, TF32 off). The two differ by
# ~1e-6 of a vector's scale (the CPU emulation, 1.5e-6 at a 1024-key
# chain); one TF32 part would read ~5e-4. 2e-5 leaves a wide margin while
# one key lost reads ~1e-1.
RAGGED_F32_TOL = 2e-5
_RAGGED_TOLS = {torch.bfloat16: KERNEL_TOL, torch.float16: F16_TOL,
                torch.float32: RAGGED_F32_TOL}


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
                    layout="bshd", by_kv_head: bool = False,
                    dtype=torch.bfloat16, tol=KERNEL_TOL):
    """dq, dk, dv from the kernel forward's (out, lse), against the plain
    backward on the same inputs (with `by_kv_head`, one KV head's group
    at a time) within `tol`; the kernel must also repeat bit for bit (no
    atomics). The inputs in `dtype` (bf16, or the f16 or f32 option)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, dout = _qkv(B, S, hd, gen, layout, (H, KV, KV, H), dtype)
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
    if not all(r <= tol for r in rel.values()):
        raise AssertionError(f"flash bwd B={B} S={S}: relative errors {rel}"
                             f" > {tol}")
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
    nbytes = (q.element_size() * B * S * hd * (4 * H + 4 * KV)
              + 4.0 * B * H * S)
    return _shares({"shape": f"B={B} S={S} H={H} KV={KV} hd={hd}"
                             + ("" if causal else " non-causal")
                             + ("" if layout == "bshd" else f" {layout}")
                             + _dt_label(dtype),
                    "max_abs_err": err, "max_rel_err": max(rel.values()),
                    "rel_err": rel, "ms": ms, "plain_ms": plain,
                    "library_ms": lib,
                    **_bound(flops, nbytes, peaks, _flops_peak(dtype))})


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


def _f16_ulps(out, ref) -> float:
    """The largest error of a row (the last dimension) in f16 ulps of
    that row's largest |ref|: max over rows of max |out - ref| /
    ulp(max |ref|)."""
    d = (out.float() - ref.float()).abs().amax(-1)
    m = ref.float().abs().amax(-1).clamp(min=2.0 ** -14)
    return (d / torch.exp2(torch.floor(torch.log2(m)) - 10)).max().item()


def _norm_err(out, ref, dtype):
    """(error, bound) of a training norm's output against its plain
    version in x's `dtype`: f16 in ulps of each row's largest value
    (F16_ULPS); f32 relative to it (RMS_F32_TOL); bf16 the same
    (KERNEL_TOL)."""
    if dtype == torch.float16:
        return _f16_ulps(out, ref), F16_ULPS
    return _rel_err(out, ref), (RMS_F32_TOL if dtype == torch.float32
                                else KERNEL_TOL)


def _rms_cases(rows, D, peaks, gen, eps=1e-5, w_dtype=torch.bfloat16,
               dtype=torch.bfloat16):
    """The training norm at [rows, D] (x in `dtype`: bf16, or the f16
    and f32 options; the path's weight: bf16, or f32 for the f32-param
    trees): forward (out per row, rstd) and backward (dx per row, dw over
    D, in the weight's dtype) against the plain twins within
    `_norm_err`'s bound (dw relative to its largest value: KERNEL_TOL in
    bf16, an f16 ulp in f16, RMS_F32_TOL in f32); the backward must
    repeat bit for bit and launch its walk and fold only."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.tools import bench_kernels as bk
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    x = torch.randn(rows, D, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(w_dtype)
    dy = torch.randn(rows, D, device="cuda", generator=gen).to(dtype)
    out, rstd = rn.rms_norm_fwd(x, w, eps)
    out2, rstd2 = rn.rms_norm_fwd(x, w, eps)
    rout, rrstd = rn._rms_fwd_twin(x, w, eps)
    dx, dw = rn.rms_norm_bwd(x, w, rstd, dy, eps)
    dx2, dw2 = rn.rms_norm_bwd(x, w, rstd, dy, eps)
    rdx, rdw = rn._rms_train_ref_bwd(x, w, dy, eps)
    torch.cuda.synchronize()
    f_rel, tol = _norm_err(out, rout, dtype)
    r_rel = ((rstd - rrstd).abs() / rrstd.abs()).max().item()
    b_rel, _ = _norm_err(dx, rdx, dtype)
    w_rel, w_tol = _norm_err(dw[None], rdw[None], w.dtype)
    if dtype == torch.bfloat16:
        w_tol = KERNEL_TOL
    if not (f_rel <= tol and r_rel <= RSTD_TOL
            and b_rel <= tol and w_rel <= w_tol):
        raise AssertionError(f"rms [{rows}, {D}] {dtype}: out {f_rel}, "
                             f"rstd {r_rel}, dx {b_rel}, dw {w_rel}")
    if not (torch.equal(out, out2) and torch.equal(rstd, rstd2)
            and torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"rms [{rows}, {D}] {dtype}: two runs differ")
    del out2, rstd2
    if not (out.dtype == dx.dtype == dtype and dw.dtype == w.dtype):
        raise AssertionError(f"rms [{rows}, {D}]: out {out.dtype}, dx "
                             f"{dx.dtype}, dw {dw.dtype} for x {dtype}, "
                             f"weight {w.dtype}")
    wname = str(w_dtype).replace("torch.", "")
    es = x.element_size()
    fwd = {"shape": f"rows={rows} D={D}"
                    + ("" if w_dtype == dtype == torch.bfloat16
                       else f" w {wname}") + _dt_label(dtype),
           "max_abs_err": (out.float() - rout.float()).abs().max().item(),
           "max_rel_err": _rel_err(out, rout), "rstd_rel_err": r_rel,
           "bound": tol, **({"f16_ulps": f_rel}
                            if dtype == torch.float16 else {}),
           "ms": _time_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20),
           "graph_ms": _graph_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20),
           "plain_ms": _time_ms(lambda: rn._rms_fwd_twin(x, w, eps), 5),
           **_rms_library_ms(lambda: F.rms_norm(x, (D,), w, eps),
                             w.dtype == x.dtype),
           **_bound(4.0 * rows * D,
                    2.0 * es * rows * D + w.element_size() * D
                    + 4.0 * rows, peaks, peaks[2])}
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
           "max_rel_err": max(_rel_err(dx, rdx), _rel_err(dw, rdw)),
           "dw_rel_err": _rel_err(dw, rdw), "bound": tol,
           **({"f16_ulps": max(b_rel, w_rel)}
              if dtype == torch.float16 else {}),
           "weight": str(w.dtype).replace("torch.", ""),
           "launched": _launched(call, ("rms_bwd_kernel", "rms_dw_kernel")),
           "ms": _time_ms(call, 20), "graph_ms": _graph_ms(call, 20),
           "plain_ms": _time_ms(
               lambda: rn._rms_train_ref_bwd(x, w, dy, eps), 5),
           **_rms_library_ms(lib, lib is not None),
           **_bound(9.0 * rows * D,
                    3.0 * es * rows * D + 4.0 * rows
                    + 2.0 * w.element_size() * D, peaks, peaks[2])}
    return fwd, bwd


def _rms_fused_cases(rows, D, dtype, w_dtype, peaks, gen, flush,
                     on_path=False):
    """Row 6 at [rows, D] (x in `dtype`; a weight in `w_dtype`, or
    affine-free with None) against its plain version `rms_norm_ref`: per
    row, f32 within RMS_F32_TOL, bf16 within KERNEL_TOL; bit-identical
    twice. Host-in-loop times with the L2 cache flushed before each call
    and one CUDA graph's device time, each beside F.rms_norm's (the
    weight cast to x's dtype outside the timed span). `on_path`: the
    eager Llama step's form, launched 23 times a step (a path name: that
    path's; True: eager_llama's)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    eps = 1e-5
    x = (torch.randn(rows, D, device="cuda", generator=gen) + 0.3).to(dtype)
    w = None if w_dtype is None else \
        (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(w_dtype)
    out = rn.rms_norm_fused(x, w, eps)
    again = rn.rms_norm_fused(x, w, eps)
    ref = rn.rms_norm_ref(x, w, eps)
    torch.cuda.synchronize()
    rel = _rel_err(out, ref)
    tol = _TOLS.get(dtype, RMS_F32_TOL)
    name = (f"rows={rows} D={D} {str(dtype).replace('torch.', '')}"
            + (" affine-free" if w is None else
               f" w {str(w_dtype).replace('torch.', '')}"))
    if not rel <= tol:
        raise AssertionError(f"rms_norm_fused [{name}]: {rel} > {tol}")
    if not torch.equal(out, again):
        raise AssertionError(f"rms_norm_fused [{name}]: two runs differ")
    wl = None if w is None else w.to(dtype)
    es = x.element_size()
    path = ({"path": on_path if isinstance(on_path, str) else
             "eager_llama", "step_launches": 23} if on_path
            else {"path": None})

    def call():
        return rn.rms_norm_fused(x, w, eps)

    def lib():
        return F.rms_norm(x, (D,), wl, eps)

    res = {"shape": name, **path,
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "max_rel_err": rel,
           "ms": _time_ms(call, 20, flush), "graph_ms": _graph_ms(call, 20),
           "plain_ms": _time_ms(lambda: rn.rms_norm_ref(x, w, eps), 5,
                                flush),
           "library_ms": _time_ms(lib, 20, flush),
           "library_graph_ms": _graph_ms(lib, 20),
           # x read, out written, the weight read; ~4 f32 operations a
           # value (square-add, scale, weight)
           **_bound(4.0 * rows * D, 2.0 * es * rows * D
                    + (0 if w is None else w.element_size() * D), peaks,
                    peaks[2])}
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    return res


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


def _masked_flash_cases(B, S, H, hd, layout, lengths, peaks, gen, label="",
                        dtype=torch.bfloat16):
    """The non-causal flash forward (+ LSE) and backward with the [B, S]
    key mask of `lengths` (keys j < lengths[b] visible; None: unmasked) in
    `layout`, against the plain versions: output per (position, head)
    within KERNEL_TOL and the LSE within LSE_TOL on the rows that see a
    key, dq, dk, dv within KERNEL_TOL (GRAD_ROW_FLOOR), the backward bit
    for bit twice. A batch row that sees no key must give exactly 0 out,
    an LSE of -1e30 and no gradient, and a masked key dk = dv = 0 exactly
    (the TPU kernel's semantics). Timed beside SDPA given the same
    boolean mask. `dtype` f32: the f32 option, held within F32_TOL and
    F32_LSE_TOL, its bound at the TF32 rate and 4-byte elements, its
    forward (out and LSE) also bit for bit twice, each with a planted
    control at least 10 times F32_TOL (the keys shifted one position;
    the backward without dcap)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    f32 = dtype == torch.float32
    tol, lse_tol = (F32_TOL, F32_LSE_TOL) if f32 else (KERNEL_TOL, LSE_TOL)
    shape = (B, H, S, hd) if layout == "bhsd" else (B, S, H, hd)
    q, k, v, dout = (torch.randn(shape, device="cuda", generator=gen)
                     .to(dtype) for _ in range(4))
    esize = q.element_size()
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
            + ("unmasked" if km is None else "masked") + label
            + _dt_label(dtype))
    rel = _rel_err(bshd(out), bshd(ref), rows)
    lse_err = (lse - lse_r)[seen].abs().max().item()
    brel = {n: _rel_err(bshd(a), bshd(b), rows if n == "dq" else None,
                        floor=GRAD_ROW_FLOOR)
            for n, a, b in zip(("dq", "dk", "dv"), got, rgot)}
    if not (rel <= tol and lse_err <= lse_tol
            and all(r <= tol for r in brel.values())):
        raise AssertionError(f"masked flash [{name}]: out {rel}, lse "
                             f"{lse_err}, grads {brel}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"masked flash bwd [{name}]: two runs differ")
    del again
    planted = None
    if f32:
        again = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"masked flash fwd [{name}]: two runs "
                                 f"differ")
        del again
        seq = 2 if layout == "bhsd" else 1
        shifted = fa.flash_attention_fwd_ref(q, torch.roll(k, 1, seq), v,
                                             **kw)
        nodcap = fa.flash_attention_bwd_ref(q, k, v, torch.zeros_like(out),
                                            lse, dout, **kw)
        planted = (
            _planted(name, [("keys_shifted_one",
                             _rel_err(bshd(out), bshd(shifted), rows))],
                     tol),
            _planted(name, [("dcap_dropped", max(
                _rel_err(bshd(a), bshd(r), rows if i == 0 else None,
                         floor=GRAD_ROW_FLOOR)
                for i, (a, r) in enumerate(zip(got[:2], nodcap[:2]))))],
                tol))
        del shifted, nodcap
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
           **_bound(4.0 * H * hd * pairs, esize * B * S * H * hd * 4
                    + 4.0 * B * H * S + mbytes, peaks, _flops_peak(dtype))}
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
           **_bound(10.0 * H * hd * pairs, esize * B * S * H * hd * 8
                    + 4.0 * B * H * S + mbytes, peaks, _flops_peak(dtype))}
    if planted is not None:
        fwd["planted"], bwd["planted"] = planted
    return _shares(fwd), _shares(bwd)


def _ln_cases(rows, D, dtype, affine, peaks, gen, flush, on_path=False,
              w_dtype=torch.float32):
    """The fused LayerNorm at [rows, D] (x in `dtype`; weight and bias in
    `w_dtype`, or affine-free): forward (out per row, mu, rstd) and backward
    (dx per row, dw and db) against the plain twins, at ERNIE's eps
    1e-12; the backward must repeat bit for bit and launch its walk and
    fold only. Times with the L2 cache flushed before each call, and the
    backward's also in one CUDA graph, beside the one ATen backward's.
    `on_path`: the eager step's form, launched 25 times a step (a path
    name: that path's; True: eager's)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    eps = 1e-12
    x = (torch.randn(rows, D, device="cuda", generator=gen) + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(w_dtype)
    b = (0.1 * torch.randn(D, device="cuda", generator=gen)).to(w_dtype)
    if not affine:
        w = b = None
    dy = torch.randn(rows, D, device="cuda", generator=gen).to(dtype)
    out, mu, rstd = ln.layer_norm_fwd(x, w, b, eps)
    rout, rmu, rrstd = ln._ln_fwd_twin(x, w, b, eps, affine)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)
    again = ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)
    rdx, rdw, rdb = ln._ln_ref_bwd(x, w, dy, eps, affine)
    torch.cuda.synchronize()
    tol = _TOLS.get(dtype, LN_F32_TOL)
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
            + ("" if affine else " affine-free")
            + ("" if w_dtype == torch.float32 or not affine else
               f" w {str(w_dtype).replace('torch.', '')}"))
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
    path = ({"path": on_path if isinstance(on_path, str) else "eager",
             "step_launches": 25} if on_path else {"path": None})
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


def _adamw_case(shape, names, peaks, gen, dtype=torch.bfloat16):
    """One leaf of the fused 8-bit AdamW from a mid-training state, the
    kernel and the plain version each on its own copy; `names` are the
    leaves of the trained tree that have this size (the step launches the
    kernel once for each). g and p in `dtype`: bf16, or the f16 and f32
    options (p within ADAMW_PARAM_ULPS of the plain version, each with a
    planted control: the plain version decaying p by wd instead of
    lr * wd, which must read 10 times the bound)."""
    from paddle_tpu_torch.optimizer import quant_state as qs
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    dev = "cuda"
    p = (0.02 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
    g = (1e-3 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
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
    again = copy()
    qs.fused_leaf_update(sc, g, *again, **hp)
    qs.fused_leaf_update_ref(sc, g, pr, mr, vr, **hp)
    torch.cuda.synchronize()
    repeat = (torch.equal(again[0], pk)
              and all(torch.equal(a.codes, b.codes)
                      and torch.equal(a.scale, b.scale)
                      for a, b in ((again[1], mk), (again[2], vk))))
    del again
    # ulps of the parameter's magnitude before or after the step: where p
    # and lr * update cancel, the result inherits the f32 rounding of the
    # terms that cancelled, not of the tiny result
    p_ulps = _ulps(pk, pr, dtype, p)
    bound = ADAMW_PARAM_ULPS[dtype]
    res = {"shape": f"{list(shape)} ({p.numel()} values: "
                    f"{', '.join(names)})" + _dt_label(dtype),
           "step_launches": len(names),
           "max_abs_err": (pk.float() - pr.float()).abs().max().item(),
           "param_ulps": p_ulps, "repeat": repeat}
    ok = p_ulps <= bound and repeat
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
    if dtype != torch.bfloat16:
        pc, mc, vc = copy()
        qs.fused_leaf_update_ref(sc, g, pc, mc, vc,
                                 **dict(hp, wd=hp["wd"] / 1e-4))
        res["dtype"] = _dt_label(dtype).strip()
        res["bound"] = f"{bound} {res['dtype']} ulp"
        res["planted"] = _planted(res["shape"], [(
            "decay_without_lr", _ulps(pk, pc, dtype, p))], bound)
        del pc, mc, vc
    n, nb = p.numel(), mq.codes.shape[0]
    res["ms"] = _time_ms(lambda: qs.fused_leaf_update(sc, g, pk, mk, vk,
                                                      **hp), 20)
    res["graph_ms"] = _graph_ms(lambda: qs.fused_leaf_update(
        sc, g, pk, mk, vk, **hp), 10)
    res["plain_ms"] = _time_ms(lambda: qs.fused_leaf_update_ref(
        sc, g, pr, mr, vr, **hp), 3)
    res["library_ms"] = None
    # g, p read and p written (in the leaf's dtype); both moments' codes
    # read and written; their scales read and written; ~25 f32 operations
    # a value
    es = p.element_size()
    res.update(_bound(25.0 * n, 3.0 * es * n + 4.0 * n + 16.0 * nb + 16,
                      peaks, peaks[2]))
    return res


# mantissa bits and the smallest ulp (subnormal spacing) of each type
_MANT = {torch.bfloat16: (7, 2.0 ** -133), torch.float16: (10, 2.0 ** -24),
         torch.float32: (23, 2.0 ** -149)}


def _ulps(a, b, dtype, before=None):
    """The largest |a - b| over the elements, in ulps of `dtype` at the
    largest magnitude of a, b (and `before`, the value before a step):
    2^(e - mantissa bits) for a value of exponent e, never below the
    type's subnormal spacing."""
    bits, tiny = _MANT[dtype]
    af, bf = a.float(), b.float()
    mag = torch.maximum(af.abs(), bf.abs())
    if before is not None:
        mag = torch.maximum(mag, before.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126)))
                     - bits).clamp(min=tiny)
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


def _wsum_case(label, src, idx, w, rows_read, step_launches, peaks, flush,
               path="train_moe"):
    """gather_wsum at one of the MoE path's shapes against its plain
    version: bit for bit at k=1, within one bf16 ulp per element at k=2
    (both compute the same f32 products and sums in the same order; the
    kernel never contracts them into FMAs, so they should agree bit for
    bit there too, and a one-ulp allowance covers a rounding of the f32
    sum landing on a bf16 tie); the f16 and f32 options bit for bit at
    every k, with a planted control (the plain version reading each
    choice's next row) at least 10 ulps off. `rows_read` is the number of
    source rows the data needs; the library yardstick is one embedding_bag
    call (sum mode, per-sample weights in the table's dtype)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    B, M, k = idx.shape
    D = src.shape[-1]
    dt = src.dtype
    out = md.gather_wsum(src, idx, w)
    again = md.gather_wsum(src, idx, w)
    ref = md._gather_wsum_ref(src, idx, w)
    torch.cuda.synchronize()
    ulps = _ulps(out, ref, dt)
    exact = torch.equal(out, ref)
    if (k == 1 or dt != torch.bfloat16) and not exact or not ulps <= 1.0 \
            or not torch.equal(out, again):
        raise AssertionError(f"gather_wsum {label}{_dt_label(dt)}: {ulps} "
                             f"ulps from the plain version (bit-identical: "
                             f"{exact})")
    err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref, ref.abs().amax(-1) > 0)     # non-empty rows
    planted = None
    if dt != torch.bfloat16:
        shifted = md._gather_wsum_ref(src, (idx + 1) % src.shape[1], w)
        planted = _planted(label, [("next_row", _ulps(out, shifted, dt))],
                           1.0)
        del shifted
    del out, ref, again
    bag = idx.reshape(B * M, k)
    wb = w.reshape(B * M, k).to(dt)
    res = {"shape": f"{label}: src {list(src.shape)} -> [{B}, {M}, {D}], "
                    f"k={k}, {rows_read} rows read" + _dt_label(dt),
           "step_launches": step_launches, "path": path,
           "max_abs_err": err, "max_rel_err": rel, "ulps": ulps,
           "bit_identical": exact,
           "ms": _time_ms(lambda: md.gather_wsum(src, idx, w), 20, flush),
           "graph_ms": _graph_ms(lambda: md.gather_wsum(src, idx, w), 20),
           "plain_ms": _time_ms(lambda: md._gather_wsum_ref(src, idx, w), 3,
                                flush),
           "library_ms": _time_ms(lambda: F.embedding_bag(
               bag, src[0], mode="sum", per_sample_weights=wb), 20, flush)}
    if planted is not None:
        res.update(dtype=_dt_label(dt).strip(), bound="bit for bit",
                   planted=planted)
    # rows read once, every output row written once, idx and w read; a
    # multiply and an add per term, on the f32 units
    nbytes = src.element_size() * D * (rows_read + B * M) + 8.0 * B * M * k
    res.update(_bound(2.0 * k * B * M * D, nbytes, peaks, peaks[2]))
    return res


def _scale_dot_case(label, src, idx, scale, other, rows_read, peaks,
                    flush, path="train_moe", step_launches=12):
    """gather_scale_dot at the combine backward's shape against its
    plain version: out within one bf16 ulp per element (one f32 product
    rounded once, in both; the f16 and f32 options bit for bit), dot
    within 1e-5 x |row| |other| per slot (an f32 sum of D products in
    another order: the rounding error of a length-2048 sum is below
    2048 x 2^-24 ~ 1.2e-4 of sum |x y| at worst and ~sqrt(2048) x 2^-24
    ~ 3e-6 of it in practice). The f16 and f32 options also have planted
    controls: the plain version without the scale (out) and with `other`
    one row down (dot), each at least 10 times its bound."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.tools.bench_flash import _graph_ms
    B, M = idx.shape
    D = src.shape[-1]
    dt = src.dtype
    out, dot = md.gather_scale_dot(src, idx, scale, other)
    out2, dot2 = md.gather_scale_dot(src, idx, scale, other)
    rout, rdot = md._gather_scale_dot_ref(src, idx, scale, other)
    torch.cuda.synchronize()
    ulps = _ulps(out, rout, dt)
    norms = (md._take_rows(src, idx).float().norm(dim=-1)
             * other.float().norm(dim=-1)).clamp(min=1e-30)
    dot_rel = ((dot - rdot).abs() / norms).max().item()
    exact = torch.equal(out, rout)
    if not (ulps <= 1.0 and dot_rel <= 1e-5) or (
            dt != torch.bfloat16 and not exact) or not (
            torch.equal(out, out2) and torch.equal(dot, dot2)):
        raise AssertionError(f"gather_scale_dot {label}{_dt_label(dt)}: out "
                             f"{ulps} ulps (bit-identical: {exact}), dot "
                             f"{dot_rel} x |row||other|")
    err = max((out.float() - rout.float()).abs().max().item(),
              (dot - rdot).abs().max().item())
    planted = None
    if dt != torch.bfloat16:
        pout, _ = md._gather_scale_dot_ref(src, idx, torch.ones_like(scale),
                                           other)
        _, pdot = md._gather_scale_dot_ref(src, idx, scale,
                                           other.roll(1, dims=1))
        live = scale != 0
        planted = _planted(label, [
            ("scale_dropped", _ulps(out[live], pout[live], dt))], 1.0)
        planted.update(_planted(label, [
            ("other_one_row_down",
             ((dot - pdot).abs() / norms).max().item())], 1e-5))
        del pout, pdot
    del out, rout, norms, out2, dot2
    res = {"shape": f"{label}: src {list(src.shape)}, other "
                    f"{list(other.shape)}, {rows_read} src rows read"
                    + _dt_label(dt),
           "step_launches": step_launches, "path": path,
           "max_abs_err": err, "max_rel_err": dot_rel, "ulps": ulps,
           "dot_rel_err": dot_rel,
           "ms": _time_ms(lambda: md.gather_scale_dot(src, idx, scale,
                                                      other), 20, flush),
           "graph_ms": _graph_ms(lambda: md.gather_scale_dot(
               src, idx, scale, other), 20),
           "plain_ms": _time_ms(lambda: md._gather_scale_dot_ref(
               src, idx, scale, other), 3, flush),
           "library_ms": None}
    if planted is not None:
        res.update(dtype=_dt_label(dt).strip(),
                   bound="out bit for bit; dot 1e-5 x |row||other|",
                   planted=planted)
    # src rows read once, every other row read, out and dot written, idx
    # and scale read; a multiply, and a multiply-add for the dot, per value
    nbytes = (src.element_size() * D * (rows_read + 2 * B * M)
              + 4.0 * B * M + 8.0 * B * M)
    res.update(_bound(3.0 * B * M * D, nbytes, peaks, peaks[2]))
    return res


def _moe_dispatch_cases(peaks, gen, flush, dtype=torch.bfloat16,
                        path="train_moe", layers=12):
    """The two MoE kernels at the MoE step's four launch shapes: the
    dispatch forward (k=1, token rows into 102,400 slots), the combine
    forward and the dispatch backward (k=2, slots back into 40,960 token
    rows: gate-prob and 0/1 weights) and the combine backward; rows in
    `dtype`, each shape's launches a step counted for `layers` layers
    (each recomputed once: dispatch and combine forwards 2 a layer, the
    two backwards 1)."""
    mp = _moe_maps(gen)
    B, S, k = mp["B"], mp["S"], mp["k"]
    T, M = B * S, mp["E"] * B * mp["C"]
    D = 2048
    L = layers
    x = torch.randn(1, T, D, device="cuda", generator=gen).to(dtype)
    slots = torch.randn(1, M, D, device="cuda", generator=gen).to(dtype)
    inv_tok, flat = mp["inv_tok"], mp["flat"]
    wsum = [
        _wsum_case("dispatch forward", x, inv_tok.clamp(min=0)[..., None],
                   (inv_tok >= 0).float()[..., None], mp["tokens_routed"],
                   2 * L, peaks, flush, path),
        _wsum_case("combine forward", slots, mp["idx_tk"], mp["w_tk"],
                   mp["pairs_routed"], 2 * L, peaks, flush, path),
        _wsum_case("dispatch backward", slots,
                   flat.clamp(min=0).reshape(1, T, k),
                   (flat >= 0).float().reshape(1, T, k),
                   mp["pairs_routed"], L, peaks, flush, path)]
    # the combine backward's operands, built as _CombineWsum.backward
    # builds them: dy is the token-row gradient, other the expert output
    inv_pos = mp["inv_pos"]
    live = inv_pos >= 0
    w_slot = torch.where(live, torch.gather(
        mp["w_tk"].reshape(1, T * k), 1, inv_pos.clamp(min=0).long()), 0.0)
    tok = torch.where(live, torch.div(inv_pos, k, rounding_mode="floor"), 0)
    sdot = [_scale_dot_case("combine backward", x, tok, w_slot, slots,
                            mp["tokens_routed"], peaks, flush, path, L)]
    # a row width the 16-byte loads cannot take is refused, not run plain
    from paddle_tpu_torch.kernels import moe_dispatch as md
    odd_d = 12 if torch.tensor([], dtype=dtype).element_size() == 2 else 6
    odd = torch.zeros(1, 4, odd_d, dtype=dtype, device="cuda")
    i1 = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    for call in (lambda: md.gather_wsum(odd, i1[..., None],
                                        torch.ones(1, 2, 1, device="cuda")),
                 lambda: md.gather_scale_dot(odd, i1, torch.ones(
                     1, 2, device="cuda"), odd[:, :2].contiguous())):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"a MoE gather took D = {odd_d} of {dtype} on "
                             f"the card")
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


def _planted(name, checks, bound):
    """The planted controls of a case: each (label, error) must read at
    least 10 times `bound`, or the check could not see that fault."""
    out = {label: err for label, err in checks}
    low = {k: v for k, v in out.items() if not v >= 10 * bound}
    if low:
        raise AssertionError(f"{name}: planted controls {low} read under "
                             f"10 x the bound {bound}")
    return out


def _f16_kernel_cases(peaks, gen, flush):
    """The f16 options at the O2 paths' shapes, within F16_TOL of their
    plain versions, bit-identical twice, each with a planted control that
    must read at least 10 times the bound: the flash forward (+ LSE) and
    backward at the eager Llama's [2, 2048, 32/8, 128] causal and the
    eager ERNIE's
    [64, 512, 12, 64] (controls: the plain forward with the keys shifted
    one position, the plain backward without dcap); row 6 at [4096,
    4096] with an f16 weight (control: the weight read one column off);
    rows 9-10 at [32768, 768] with f16 weight and bias (controls: the
    forward's weight one column off, the backward without the
    x̂·mean(dyw·x̂) term); the flash pair also at [1, 300, 4/1, 72]
    causal, where dQ += dS·K once read over F16_TOL with dS one f16
    operand (held, on no path). Returns (flash fwd, flash bwd, rms_fused,
    layer_norm fwd, layer_norm bwd) case lists, each case tagged with its
    O2 path."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import rms_norm as rn
    f16 = torch.float16
    fwd, bwd = [], []
    # the odd shape whose dq read over F16_TOL while dS entered dQ += dS K
    # as one f16 operand (hd 72, S 300 off the tiles, GQA 4:1, causal):
    # held on no path
    for path, (B, S, H, KV, hd, causal) in (
            ("eager_llama_o2_f16", (2, 2048, 32, 8, 128, True)),
            ("eager_o2", (64, 512, 12, 12, 64, False)),
            ("held", (1, 300, 4, 1, 72, True))):
        f = _flash_case(B, S, H, KV, hd, peaks, F16_TOL, gen, lse=True,
                        causal=causal, dtype=f16)
        b = _flash_bwd_case(B, S, H, KV, hd, peaks, gen, causal=causal,
                            dtype=f16, tol=F16_TOL)
        q, k, v, dout = _qkv(B, S, hd, gen, "bshd", (H, KV, KV, H), f16)
        kw = dict(causal=causal)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        again = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"flash fwd f16 [{f['shape']}]: two runs "
                                 f"differ")
        del again
        shifted = fa.flash_attention_fwd_ref(q, torch.roll(k, 1, 1), v,
                                             **kw)
        f["dtype"] = b["dtype"] = "f16"
        f["path"] = b["path"] = path
        f["planted"] = _planted(f["shape"], [(
            "keys_shifted_one", _rel_err(out, shifted))], F16_TOL)
        del shifted
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        nodcap = fa.flash_attention_bwd_ref(q, k, v, torch.zeros_like(out),
                                            lse, dout, **kw)
        b["planted"] = _planted(b["shape"], [(
            "dcap_dropped", max(_rel_err(a, r, floor=GRAD_ROW_FLOOR)
                                for a, r in zip(got[:2], nodcap[:2])))],
            F16_TOL)
        del q, k, v, dout, out, lse, got, nodcap
        torch.cuda.empty_cache()
        fwd.append(f)
        bwd.append(b)
    rms = _rms_fused_cases(2 * 2048, 4096, f16, f16, peaks, gen, flush,
                           on_path="eager_llama_o2_f16")
    x = (torch.randn(2 * 2048, 4096, device="cuda", generator=gen)
         + 0.3).to(f16)
    w = (1 + 0.1 * torch.randn(4096, device="cuda", generator=gen)).to(f16)
    rms["dtype"] = "f16"
    rms["planted"] = _planted(rms["shape"], [(
        "weight_one_column_off", _rel_err(
            rn.rms_norm_fused(x, w, 1e-5),
            rn.rms_norm_ref(x, torch.roll(w, 1), 1e-5)))], F16_TOL)
    lf, lb = _ln_cases(64 * 512, 768, f16, True, peaks, gen, flush,
                       on_path="eager_o2", w_dtype=f16)
    x = (torch.randn(64 * 512, 768, device="cuda", generator=gen)
         + 0.5).to(f16)
    w = (1 + 0.1 * torch.randn(768, device="cuda", generator=gen)).to(f16)
    bias = (0.1 * torch.randn(768, device="cuda", generator=gen)).to(f16)
    dy = torch.randn(64 * 512, 768, device="cuda", generator=gen).to(f16)
    out, mu, rstd = ln.layer_norm_fwd(x, w, bias, 1e-12)
    lf["dtype"] = lb["dtype"] = "f16"
    lf["planted"] = _planted(lf["shape"], [(
        "weight_one_column_off", _rel_err(out, ln._ln_fwd_twin(
            x, torch.roll(w, 1), bias, 1e-12, True)[0]))], F16_TOL)
    lb["planted"] = _planted(lb["shape"], [(
        "dx_term_dropped", _rel_err(
            ln.layer_norm_bwd(x, w, mu, rstd, dy, 1e-12)[0],
            _ln_bwd_dropped_term(x, w, mu, rstd, dy, 1e-12)[0]))], F16_TOL)
    del x, w, bias, dy, out, mu, rstd
    torch.cuda.empty_cache()
    return fwd, bwd, [rms], [lf], [lb]


# The f32 trainer's batch (train_f32, train_f16 and the f32 kernel cases
# at its shapes): the largest multiple of 8 at 2048 tokens whose step
# fits in the card's 80 GB inside this script. f32 parameters,
# gradients and moments take 33.6 GB and the tree AdamW's temporaries
# lift the peak to 73.2 GB at batch 8, 16 and 24 alike in a fresh
# process; after the earlier phases batch 24's backward found 14.5 GB
# of the pool fragmented and ran out, and at 32 the [B, 2048, 32000]
# f32 logits do not fit at all (H100 80GB HBM3).
F32_TRAIN_BATCH = 16


def _f32_kernel_cases(peaks, gen, flush):
    """The f32 options of rows 1-5 and the f16 and f32 options of rows 7-8
    at the f32 and f16 paths' shapes, each within its bound of its plain
    version, bit-identical on a second call, with a planted control at
    least 10 times above the bound: the flash forward (+ LSE; control the
    keys shifted one position) and backward (control dcap dropped) in f32
    at the eager ERNIE's [64, 512, 12, 64] non-causal (eager_f32), the
    flagship's [F32_TRAIN_BATCH, 2048, 32/8, 128] causal (train_f32) and
    DiT-XL/2's [96, 256, 16, 72] 'bhsd' (no f32 path: held) and [1,
    300, 4/1, 72] causal (held: hd 72, a length off every tile, GQA 4:1,
    whose first rows see one key, where dS = P (dP - dcap) cancels), and
    key-masked at the f32 ERNIE finetune's padded lengths in 'bhsd', a
    batch row seeing no key (eager_f32: `_masked_flash_cases`); the f16
    flash pair at the f16 trainer's shape (train_f16); rows 7-8 at
    [F32_TRAIN_BATCH * 2048, 4096] in f32 (train_f32) and in f16
    (train_f16), each with an f32 weight (control: the weight one column
    off). The MoE trainers' (MOE_BATCH x 2048, GQA 16/8): the flash
    pair in f32 (train_moe_f32) and f16 (train_moe_f16), rows 7-8 at
    [MOE_BATCH * 2048, 2048] in f32 (f32 weight) and f16 (f16
    weight); train_p32's rows 7-8, bf16 x with an f32 weight at [8 *
    2048, 4096]. Returns (flash fwd, flash bwd, rms fwd, rms bwd) case
    lists."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm as rn
    f32, f16 = torch.float32, torch.float16
    fwd, bwd = [], []
    # at the trainers' batch the plain versions run one KV head's group at
    # a time (all heads' f32 scores: 8.6 GB a tensor at batch 16)
    for path, dt, (B, S, H, KV, hd, causal, layout) in (
            ("eager_f32", f32, (64, 512, 12, 12, 64, False, "bshd")),
            ("train_f32", f32, (F32_TRAIN_BATCH, 2048, 32, 8, 128, True,
                                "bshd")),
            ("held", f32, (96, 256, 16, 16, 72, False, "bhsd")),
            ("held", f32, (1, 300, 4, 1, 72, True, "bshd")),
            ("train_f16", f16, (F32_TRAIN_BATCH, 2048, 32, 8, 128, True,
                                "bshd")),
            ("train_moe_f32", f32, (MOE_BATCH, 2048, 16, 8, 128, True,
                                    "bshd")),
            ("train_moe_f16", f16, (MOE_BATCH, 2048, 16, 8, 128, True,
                                    "bshd"))):
        tol = F32_TOL if dt == f32 else F16_TOL
        by = path.startswith("train")
        f = _flash_case(B, S, H, KV, hd, peaks, tol, gen, lse=True,
                        causal=causal, layout=layout, dtype=dt,
                        by_kv_head=by)
        b = _flash_bwd_case(B, S, H, KV, hd, peaks, gen, causal=causal,
                            layout=layout, dtype=dt, tol=tol, by_kv_head=by)
        fwd_ref = _fwd_ref_by_kv_head if by else fa.flash_attention_fwd_ref
        bwd_ref = _bwd_ref_by_kv_head if by else fa.flash_attention_bwd_ref
        q, k, v, dout = _qkv(B, S, hd, gen, layout, (H, KV, KV, H), dt)
        kw = dict(causal=causal, layout=layout)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        again = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"flash fwd [{f['shape']}]: two runs "
                                 f"differ")
        del again
        seq = 2 if layout == "bhsd" else 1
        shifted = fwd_ref(q, torch.roll(k, 1, seq), v, **kw)
        f["dtype"] = b["dtype"] = _dt_label(dt).strip()
        f["path"] = b["path"] = path
        f["bound"] = b["bound"] = tol
        f["planted"] = _planted(f["shape"], [(
            "keys_shifted_one", _rel_err(fa._bshd(out, layout),
                                         fa._bshd(shifted, layout)))], tol)
        del shifted
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        nodcap = bwd_ref(q, k, v, torch.zeros_like(out), lse, dout, **kw)
        b["planted"] = _planted(b["shape"], [(
            "dcap_dropped", max(_rel_err(fa._bshd(a, layout),
                                         fa._bshd(r, layout),
                                         floor=GRAD_ROW_FLOOR)
                                for a, r in zip(got[:2], nodcap[:2])))], tol)
        del q, k, v, dout, out, lse, got, nodcap
        torch.cuda.empty_cache()
        fwd.append(f)
        bwd.append(b)
    # the f32 ERNIE finetune's key-masked head-major attention at its
    # padded lengths, batch row 0 seeing no key: the tile-state scan and
    # the skipped tiles (eager_f32's step itself runs unmasked)
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.ernie_finetune import padded_batch
    lengths = padded_batch(ernie.ErnieConfig.ernie3_base(), 64, 512)[2] \
        .sum(1)
    lengths[0] = 0
    f, b = _masked_flash_cases(64, 512, 12, 64, "bhsd", lengths, peaks, gen,
                               " (row 0 sees no key)", dtype=f32)
    for c in (f, b):
        c.update(dtype="f32", path="eager_f32", bound=F32_TOL)
    fwd.append(f)
    bwd.append(b)
    torch.cuda.empty_cache()
    rf, rb = [], []
    bf16 = torch.bfloat16
    for path, dt, wdt, rows, D, eps in (
            ("train_f32", f32, f32, F32_TRAIN_BATCH * 2048, 4096, 1e-5),
            ("train_f16", f16, f32, F32_TRAIN_BATCH * 2048, 4096, 1e-5),
            ("train_p32", bf16, f32, 8 * 2048, 4096, 1e-5),
            ("train_moe_f32", f32, f32, MOE_BATCH * 2048, 2048, 1e-6),
            ("train_moe_f16", f16, f16, MOE_BATCH * 2048, 2048, 1e-6)):
        cf, cb = _rms_cases(rows, D, peaks, gen, eps=eps, w_dtype=wdt,
                            dtype=dt)
        x = torch.randn(rows, D, device="cuda", generator=gen).to(dt)
        w = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(wdt)
        dy = torch.randn(rows, D, device="cuda", generator=gen).to(dt)
        off = torch.roll(w, 1)
        out, rstd = rn.rms_norm_fwd(x, w, eps)
        dx, _ = rn.rms_norm_bwd(x, w, rstd, dy, eps)
        cf["planted"] = _planted(cf["shape"], [(
            "weight_one_column_off",
            _norm_err(out, rn._rms_fwd_twin(x, off, eps)[0], dt)[0])],
            cf["bound"])
        cb["planted"] = _planted(cb["shape"], [(
            "weight_one_column_off",
            _norm_err(dx, rn._rms_train_ref_bwd(x, off, dy, eps)[0],
                      dt)[0])], cb["bound"])
        for c in (cf, cb):
            if dt != bf16:
                c["dtype"] = _dt_label(dt).strip()
            c["path"] = path
        rf.append(cf)
        rb.append(cb)
        del x, w, dy, off, out, rstd, dx
        torch.cuda.empty_cache()
    return fwd, bwd, rf, rb


# The MoE trainers' batch (train_moe, bench.py's; train_moe_f32 and
# train_moe_f16, and the f16 and f32 cases at their shapes, the largest
# of 20, 16, 12, 8 and 4 that fits: 20 too, as f32 parameters, gradients
# and activations take about twice the bf16 step's 15.2 GB).
MOE_BATCH = 20


def _dtype_option_cases(peaks, gen, flush):
    """The f16 and f32 options of rows 14, 15, 17 and 18 at their paths'
    shapes, each within its bound of the plain version, bit-identical
    twice, with a planted control at least 10 times the bound: the MoE
    dispatch kernels at the MoE step's maps (B = MOE_BATCH) in f32
    (train_moe_f32, 12 layers) and f16 (train_moe_f16, 2 layers); the
    fused 8-bit AdamW over every leaf size of the f32 flagship tree
    (train_p32), the f32 MoE tree (train_moe_f32) and the 2-layer f16 MoE
    tree (train_moe_f16); ragged paged attention in f16 (serve_f16) and
    f32 (serve_f32) at the decode, fused and full32 batches, over int8
    pools at the decode and full32 batches, and with the chain and tree
    verify's slabs. Returns {kernel name: cases}, each case tagged with
    its dtype and path."""
    from paddle_tpu_torch.nlp import llama, moe
    f16, f32 = torch.float16, torch.float32
    out = {k: [] for k in ("gather_wsum", "gather_scale_dot", "adamw_q",
                           "ragged_paged_attention",
                           "ragged_paged_attention_int8",
                           "ragged_paged_attention_suffix")}
    for path, dt, layers in (("train_moe_f32", f32, 12),
                             ("train_moe_f16", f16, 2)):
        wsum, sdot, _ = _moe_dispatch_cases(peaks, gen, flush, dt, path,
                                            layers)
        out["gather_wsum"] += wsum
        out["gather_scale_dot"] += sdot
        torch.cuda.empty_cache()
    for path, dt, shapes in (
            ("train_p32", f32, llama._shapes(llama.LlamaConfig.flagship_2b())),
            ("train_moe_f32", f32,
             moe._shapes(moe.MoeConfig.flagship_moe())),
            ("train_moe_f16", f16, moe._shapes(
                moe.MoeConfig.flagship_moe(num_hidden_layers=2)))):
        for shape, names in _adamw_leaves(shapes):
            out["adamw_q"].append({"path": path, **_adamw_case(
                shape, names, peaks, gen, dt)})
            torch.cuda.empty_cache()
    H, KV, hd = 32, 8, 128
    for path, dt in (("serve_f16", f16), ("serve_f32", f32)):
        for name, kinds in (
                ("ragged_paged_attention", ("decode", "fused", "full32")),
                ("ragged_paged_attention_int8", ("int8 decode",
                                                 "int8 full32")),
                ("ragged_paged_attention_suffix", ("verify_chain",
                                                   "verify_tree"))):
            out[name] += [_ragged_option_case(kind, H, KV, hd, gen, flush,
                                              dt, path) for kind in kinds]
    return out


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
    # the predictor's paged decode (phase predict) at its last step: 8
    # rows of 640 live keys in blocks of 64
    ragged.append(_ragged_case("full8", H, KV, hd, gen, flush, bs=64, M=10))
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
    # the inference predictor's prefill (phase predict): 8 prompts of 512
    flash.append(_flash_case(8, 512, H, KV, hd, peaks, KERNEL_TOL, gen))
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
    # the f16 options at the O2 paths' shapes (rows 1-6, 9-10); then row
    # 6 in bf16 with a bf16 weight at the eager Llama's [4096, 4096], the
    # O2 bf16 run's form
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    f16_fwd, f16_bwd, f16_rms, f16_lnf, f16_lnb = _f16_kernel_cases(
        peaks, gen, flush)
    flash += f16_fwd
    bwd += f16_bwd
    rms_fused += f16_rms
    rms_fused.append(_rms_fused_cases(2 * 2048, 4096, torch.bfloat16,
                                      torch.bfloat16, peaks, gen, flush,
                                      on_path="eager_llama_o2_bf16"))
    lns += [(f16_lnf[0], f16_lnb[0])]
    # the f32 options of rows 1-5 and the f16 / f32 options of rows 7-8
    # at the f32 and f16 paths' shapes
    f32_fwd, f32_bwd, f32_rf, f32_rb = _f32_kernel_cases(peaks, gen, flush)
    flash += [c for c in f32_fwd if c["dtype"] == "f16"]
    bwd += [c for c in f32_bwd if c["dtype"] == "f16"]
    rms += list(zip(f32_rf, f32_rb))
    # the f16 and f32 options of rows 14, 15, 17 and 18, and the
    # serving paths' flash prefill at the top bucket in f16 and f32
    opts = _dtype_option_cases(peaks, gen, flush)
    wsum += opts["gather_wsum"]
    sdot += opts["gather_scale_dot"]
    adamw += opts["adamw_q"]
    ragged += opts["ragged_paged_attention"]
    ragged_int8 += opts["ragged_paged_attention_int8"]
    ragged_suffix += opts["ragged_paged_attention_suffix"]
    serve_f32 = []
    for path, dt in (("serve_f16", torch.float16),
                     ("serve_f32", torch.float32)):
        c = _flash_case(2, 512, H, KV, hd, peaks, _TOLS.get(dt, F32_TOL),
                        gen, dtype=dt)
        c.update(dtype=_dt_label(dt).strip(), path=path)
        (flash if dt == torch.float16 else serve_f32).append(c)
    # the Transformer's encoder self-attention and cross-attention (phase
    # transformer): B 96 x 256, 8 heads of 64, non-causal, + LSE
    flash.append({"path": "transformer", **_flash_case(
        TRANSFORMER_BATCH, TRANSFORMER_SEQ, 8, 8, 64, peaks, KERNEL_TOL, gen,
        lse=True, causal=False)})
    bwd.append({"path": "transformer", **_flash_bwd_case(
        TRANSFORMER_BATCH, TRANSFORMER_SEQ, 8, 8, 64, peaks, gen,
        causal=False)})
    del scratch
    torch.cuda.empty_cache()
    cases = {"flash_attention_fwd": flash, "ragged_paged_attention": ragged,
             "ragged_paged_attention_int8": ragged_int8,
             "ragged_paged_attention_suffix": ragged_suffix,
             "flash_attention_bwd": bwd,
             "flash_attention_fwd_f32": [c for c in f32_fwd
                                         if c["dtype"] == "f32"] + serve_f32,
             "flash_attention_bwd_f32": [c for c in f32_bwd
                                         if c["dtype"] == "f32"],
             "rms_norm_fwd": [f for f, _ in rms],
             "rms_norm_bwd": [b for _, b in rms], "adamw_q": adamw,
             "gather_wsum": wsum, "gather_scale_dot": sdot,
             "layer_norm_fwd": [f for f, _ in lns],
             "layer_norm_bwd": [b for _, b in lns],
             "rms_norm_fused": rms_fused,
             "adaln_fwd": [f for f, _ in adaln],
             "adaln_bwd": [b for _, b in adaln],
             "gather_rows": rows13, "gather_mlp": rows16}
    _emit({"phase": "kernels", "tol": KERNEL_TOL, "f16_tol": F16_TOL,
           "lse_tol": LSE_TOL, "f32_tol": F32_TOL,
           "f32_lse_tol": F32_LSE_TOL, "f16_ulps": F16_ULPS,
           "rstd_tol": RSTD_TOL, "adamw_code_frac": ADAMW_CODE_FRAC,
           "ln_f32_tol": LN_F32_TOL, "ln_stat_tol": LN_STAT_TOL,
           "ln_sum_tol": LN_SUM_TOL, "rms_f32_tol": RMS_F32_TOL,
           "adaln_f32_tol": ADALN_F32_TOL, "adaln_stat_tol": ADALN_STAT_TOL,
           "adaln_sum_tol": ADALN_SUM_TOL,
           "ragged_f32_tol": RAGGED_F32_TOL,
           "adamw_param_ulps": {str(k): v for k, v in
                                ADAMW_PARAM_ULPS.items()},
           "moe_routing": moe_info, **cases})
    torch.cuda.empty_cache()
    return cases


# -------------------------------------------------------------- 4. serve
@contextlib.contextmanager
def _patched(mod, **fns):
    """`mod`'s attributes replaced by `fns` inside, restored after."""
    old = {k: getattr(mod, k) for k in fns}
    for k, f in fns.items():
        setattr(mod, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(mod, k, f)


def _off_by_one(paged):
    """An off-by-one fault in forward_paged's plain attention (for
    `_patched`), the control that shows the logits check can see a
    fault: the ragged path hides each query's own key (positions - 1),
    and the cold-prefill path shifts the keys and values by one position
    (query i loses key i and sees key 0 twice)."""
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

    return {"flash_attention_fwd_ref": flash_fault,
            "ragged_paged_attention_ref": ragged_fault}


def _tf32_operands(paged):
    """forward_paged's plain flash and ragged attention fed q, k and v
    (or the pools) rounded to TF32 (`_tf32`), for `_patched`: an f32
    path carrying the operand rounding of a kernel that multiplies on
    TF32 tensor cores, as the f32 flash kernel does."""
    flash, ragged = paged.flash_attention_fwd_ref, \
        paged.ragged_paged_attention_ref

    def flash_tf32(q, k, v, causal=True, scale=None):
        return flash(_tf32(q), _tf32(k), _tf32(v), causal=causal,
                     scale=scale)

    def ragged_tf32(q, k_pool, v_pool, *args, **opts):
        return ragged(_tf32(q), _tf32(k_pool), _tf32(v_pool), *args, **opts)

    return {"flash_attention_fwd_ref": flash_tf32,
            "ragged_paged_attention_ref": ragged_tf32}


def _tf32(x):
    """f32 x rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as the tensor cores take f32 operands."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _ragged_at_bound(paged, tol, seed):
    """forward_paged's plain ragged attention with each output vector
    (query, head) moved by uniform noise of up to `tol` of its largest
    element, for `_patched`: an attention exactly as far off as the
    kernels phase lets row 18 be (`_rel_err` <= tol), seeded."""
    ragged = paged.ragged_paged_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(*args, **opts):
        o = ragged(*args, **opts)
        u = torch.rand(o.shape, generator=gen, device=o.device,
                       dtype=o.dtype)
        return o + tol * o.abs().amax(-1, keepdim=True) * (2 * u - 1)

    return {"ragged_paged_attention_ref": noisy}


def _logits_check(params, cfg):
    """One fixed batch through forward_paged: a cold prefill of 4 ragged
    prompts (the flash kernel), a continuing 64-token chunk of each (the
    ragged kernel, as a chunked prefill runs it), then one decode step;
    the chunk and decode tokens are fixed, not sampled. It runs four
    ways, each on its own pool: in cfg.dtype (bf16 or f16) with the
    kernels ("kernel"), with their plain versions ("ref"), with the plain
    versions and a planted off-by-one fault ("fault", `_off_by_one`), and
    an f32 evaluation of the plain versions ("f32": the same weights,
    cast to f32 where they are used). Returns, for each step, each
    path's relative RMS distance from the f32 logits, and the kernel and
    fault paths' distances as ratios to the plain path's.

    In f32 the plain path is itself the f32 evaluation, and the f32
    flash kernel multiplies on TF32, whose rounding 32 random layers
    amplify as they amplify bf16's: the yardstick is then a twin
    ("twin": the plain path with the flash operands rounded to TF32),
    and the kernel and fault paths' distances from the plain f32 path
    are returned as ratios to the twin's. Row 18, in three TF32 parts in
    f32, is then held on its own, in the chunk and decode steps: the
    kernel path with the flash prefill on its plain version ("ragged")
    against the plain path whose ragged attention sits at RAGGED_F32_TOL
    ("ragged_at_bound", `_ragged_at_bound`), its distance as
    "ragged_ratio"; the control, the plain ragged attention on TF32
    operands ("ragged_tf32"), as "ragged_control_ratio"."""
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
    f32 = cfg.dtype == torch.float32
    # name: (config, attention_impl, forward_paged's functions replaced)
    runs = {"kernel": (cfg, "kernel", {}), "ref": (cfg, "ref", {}),
            "fault": (cfg, "ref", _off_by_one(paged))}
    if f32:
        tf32 = _tf32_operands(paged)
        runs.update({
            "twin": (cfg, "ref", {"flash_attention_fwd_ref":
                                  tf32["flash_attention_fwd_ref"]}),
            "ragged": (cfg, "kernel", {"flash_attention_fwd":
                                       paged.flash_attention_fwd_ref}),
            "ragged_at_bound": (cfg, "ref", _ragged_at_bound(
                paged, RAGGED_F32_TOL, SEED + 6)),
            "ragged_tf32": (cfg, "ref", {"ragged_paged_attention_ref":
                                         tf32["ragged_paged_attention_ref"]})})
    else:
        runs["f32"] = (dataclasses.replace(cfg, dtype=torch.float32), "ref",
                       {})
    res = {}
    for name, (c, impl, fns) in runs.items():
        k, v, _, _ = paged.init_pool(c, B * M, bs, device=dev)
        cache = paged.PagedKVCache(k, v, table,
                                   torch.zeros(B, dtype=torch.int32,
                                               device=dev))
        res[name] = []
        with _patched(paged, **fns):
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
        if f32:
            ref = res["ref"][i]
            c = {f"{n}_vs_ref": rel(res[n][i], ref)
                 for n in ("kernel", "fault", "twin")}
            c["kernel_ratio"] = c["kernel_vs_ref"] / c["twin_vs_ref"]
            c["fault_ratio"] = c["fault_vs_ref"] / c["twin_vs_ref"]
            c["greedy_agree_kernel_ref"] = (
                res["kernel"][i].argmax(-1) == ref.argmax(-1)
            ).float().mean().item()
            if step != "prefill":
                c.update({f"{n}_vs_ref": rel(res[n][i], ref) for n in
                          ("ragged", "ragged_at_bound", "ragged_tf32")})
                c["ragged_ratio"] = c["ragged_vs_ref"] \
                    / c["ragged_at_bound_vs_ref"]
                c["ragged_control_ratio"] = c["ragged_tf32_vs_ref"] \
                    / c["ragged_at_bound_vs_ref"]
            out[step] = c
            continue
        f32l = res["f32"][i]
        c = {f"{n}_vs_f32": rel(res[n][i], f32l)
             for n in ("kernel", "ref", "fault")}
        c["kernel_vs_ref"] = rel(res["kernel"][i], res["ref"][i])
        c["kernel_ratio"] = c["kernel_vs_f32"] / c["ref_vs_f32"]
        c["fault_ratio"] = c["fault_vs_f32"] / c["ref_vs_f32"]
        for n in ("kernel", "ref"):
            c[f"greedy_agree_{n}_f32"] = (
                res[n][i].argmax(-1) == f32l.argmax(-1)).float().mean().item()
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


def _serve_requests(cfg, n_requests):
    """The serve burst's requests: prompt lengths 16-512 and two of
    513-700 (chunked prefill), budgets 32, 24, 16 in turn, tokens from
    the seed. Returns (lengths, budgets, prompts)."""
    rng = np.random.RandomState(SEED)
    lengths = rng.randint(16, 513, n_requests)
    lengths[[3, 7]] = rng.randint(513, 701, 2)        # chunked prefill
    budgets = [(32, 24, 16)[i % 3] for i in range(n_requests)]
    prompts = [rng.randint(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    return lengths, budgets, prompts


def _serve_stream(eng, prompts, budgets):
    """The serve burst on a started engine: 3 requests at once (a cold
    prefill with nothing decoding), then each later one as soon as the
    one before it streams a token, the first one's stream() consumed on
    a thread. Returns (requests, streamed tokens, start, end)."""
    t_start = time.monotonic()
    reqs = [eng.submit(prompts[i], max_new_tokens=budgets[i])
            for i in range(3)]
    streamed: list = []
    consumer = threading.Thread(
        target=lambda: streamed.extend(reqs[0].stream()))
    consumer.start()
    for i in range(3, len(prompts)):
        while not reqs[-1].tokens and not reqs[-1].done:
            time.sleep(0.002)
        reqs.append(eng.submit(prompts[i], max_new_tokens=budgets[i]))
    for r in reqs:
        r.wait(timeout=900)
    t_end = time.monotonic()
    consumer.join(timeout=60)
    return reqs, streamed, t_start, t_end


def phase_serve(layers: int = 32, n_requests: int = 12,
                dtype=torch.bfloat16, spec_requests: int = 8,
                spec_budget: int = 16):
    """Serving at Llama-3-8B widths (random weights in `dtype` from the
    seed, `layers` layers; serve_f16 and serve_f32 run it in f16 and
    f32): the default engine (prefix cache, trace, SLOs, the watchdog),
    every step shape captured by `warmup()` (SERVE_GRAPHS graphs), then
    a burst of `n_requests` with admissions mid-decode
    (`_serve_requests`, `_serve_stream`): every request finishes, the
    pool drains, `compile_count` stays flat, rows 1 and 18 launch by
    graph replay and only in `dtype`. bf16 then runs the graph check
    (`_graph_check`); f16 and f32 run an int8-KV engine with a
    speculative chain of 4 (`_serve_burst`: `spec_requests` prompts of
    16-700 tokens, `spec_budget` tokens each; bf16's is
    phase_serve_quant_spec's (b)), where row 18's int8 and suffix
    options launch, only in `dtype`. Then the logits check
    (`_logits_check`), each yardstick with its planted control above."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.kernels.flash_attention import \
        flash_attention_fwd as flash
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.nlp.ragged_attention import \
        ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import RequestState, ServingEngine

    tag = _build.DTYPE_TAGS[str(dtype)]
    name = "serve" if dtype == torch.bfloat16 else f"serve_{tag}"
    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=layers, dtype=dtype)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the JAX engine's defaults (prefix cache, trace, SLOs on); every
    # step shape captured before the loop starts; the watchdog on (no
    # rule armed: what it costs a burst)
    eng = ServingEngine(params, cfg, max_batch=8, block_size=16,
                        max_total_len=1024, max_new_tokens=32,
                        max_prefill_bucket=512,
                        watchdog_s=ROBUST_WATCHDOG_S, start=False)
    torch.cuda.reset_peak_memory_stats()
    mem_before = _memory()
    t0 = time.perf_counter()
    graphs = eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    mem_after = _memory()
    if graphs != SERVE_GRAPHS or eng.batcher.compile_count != SERVE_GRAPHS:
        raise AssertionError(f"{name}: warmup captured {graphs} step shapes "
                             f"({eng.batcher.compile_count} in the memo), "
                             f"not {SERVE_GRAPHS}")
    if eng.health()["ready"] is not False:
        raise AssertionError(f"{name}: health() ready before start()")
    eng.start()
    lengths, budgets, prompts = _serve_requests(cfg, n_requests)
    try:
        # warm-up: cuBLAS handles and the allocator, outside the counts;
        # its own prompt, so the prefix cache holds no block of the burst
        eng.generate(_warmup_prompt(cfg), max_new_tokens=2, timeout=600)
        if not eng.health()["ready"]:
            raise AssertionError(f"{name}: health() not ready: "
                                 f"{eng.health()}")
        cc_before = eng.batcher.compile_count
        for obj in (flash, rpa):
            _build.reset_counts(obj)
        torch.cuda.reset_peak_memory_stats()
        reqs, streamed, t_start, t_end = _serve_stream(eng, prompts,
                                                       budgets)
        if not eng.drain(timeout=120):
            raise AssertionError(f"{name}: the engine did not drain")
        launches = _read_serve_counters()
        by_dtype = {"flash_attention_fwd": _build.launches_by_dtype(flash),
                    "ragged_paged_attention": _build.launches_by_dtype(rpa)}
        cc_after = eng.batcher.compile_count
        peak = torch.cuda.max_memory_allocated()
        snap = eng.snapshot()
        health = eng.health()
        prom = eng.metrics.to_prometheus()
    finally:
        clean = eng.shutdown(timeout=120)
    if not clean:
        raise AssertionError(f"{name}: engine shutdown was not clean")
    for i, r in enumerate(reqs):
        if r.state is not RequestState.FINISHED:
            raise AssertionError(f"{name}: request {i} ended "
                                 f"{r.state.name}: {r.error!r}")
        if len(r.tokens) != budgets[i] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"{name}: request {i}: bad output "
                                 f"{r.tokens}")
    if streamed != reqs[0].tokens:
        raise AssertionError(f"{name}: stream() disagrees with the result")
    g = snap["gauges"]
    if g["fused_steps"] < 1:
        raise AssertionError(f"{name}: no fused prefill+decode step ran")
    if g["kv_blocks_in_use"] != 0:
        raise AssertionError(f"{name}: {g['kv_blocks_in_use']} KV blocks "
                             f"leaked")
    if cc_after != cc_before:
        raise AssertionError(f"{name}: compile_count moved through the "
                             f"burst: {cc_before} -> {cc_after}")
    _require_launched(launches, ("flash_attention_fwd",
                                 "ragged_paged_attention"), name)
    if "slo_burn_rate_ttft_s_p99" not in prom or health["status"] != \
            "HEALTHY" or health["watchdog_trips"] != 0:
        raise AssertionError(f"{name}: observability: {health}")
    graph = spec = None
    if dtype == torch.bfloat16:
        # the batcher-level graph check, on the serve engine's warmed
        # batcher (the step graphs are captured alike in every dtype)
        graph = _graph_check(params, cfg, eng.batcher)
    del eng
    _release()
    if dtype != torch.bfloat16:
        rng = np.random.RandomState(SEED + 5)
        spec_lengths = rng.randint(16, 513, spec_requests)
        spec_lengths[[2, 5]] = rng.randint(513, 701, 2)  # chunked prefill
        spec = _serve_burst(params, cfg, [
            rng.randint(1, cfg.vocab_size, int(n)).tolist()
            for n in spec_lengths], spec_budget,
            dict(kv_dtype="int8", speculative=True, spec_k=4))
        spec.pop("tokens")
        spec.update(requests=spec_requests, budget=spec_budget,
                    prompt_lengths=spec_lengths.tolist())
        _require_launched(spec["launches"], (
            "flash_attention_fwd", "ragged_paged_attention_int8",
            "ragged_paged_attention_suffix"), f"{name} int8 spec")
    for label, bd in (("burst", by_dtype),
                      ("int8 spec", spec and spec["launches_by_dtype"])):
        for kernel, d in (bd or {}).items():
            if any(n for t, n in d.items() if t != tag):
                raise AssertionError(f"{name} {label}: {kernel} launched "
                                     f"{d} by dtype, outside {tag}")
    check = _logits_check(params, cfg)
    del params
    _release()
    _emit({"phase": f"{name}.logits_check",
           "ratio_tol": LOGITS_VS_F32_RATIO, **check})
    for step, c in check.items():
        if not c["kernel_ratio"] <= LOGITS_VS_F32_RATIO:
            raise AssertionError(f"{name} {step} logits: the kernels read "
                                 f"{c['kernel_ratio']} x the yardstick's "
                                 f"distance, above {LOGITS_VS_F32_RATIO}: "
                                 f"{c}")
        if not c["fault_ratio"] > LOGITS_VS_F32_RATIO:
            raise AssertionError(f"{name} {step} logits: the planted "
                                 f"off-by-one reads {c['fault_ratio']} x the "
                                 f"yardstick's distance, within "
                                 f"{LOGITS_VS_F32_RATIO}: the check cannot "
                                 f"see it: {c}")
        if "ragged_ratio" in c and not c["ragged_ratio"] <= 1.0:
            raise AssertionError(f"{name} {step} logits: row 18 alone reads "
                                 f"{c['ragged_ratio']} x the distance of an "
                                 f"attention {RAGGED_F32_TOL} off: {c}")
        if "ragged_ratio" in c and not c["ragged_control_ratio"] > 1.0:
            raise AssertionError(f"{name} {step} logits: row 18 on TF32 "
                                 f"operands reads {c['ragged_control_ratio']}"
                                 f" x, within the bound: {c}")
    total = dict(launches)
    if spec is not None:
        total = {k: n + spec["launches"][k] for k, n in launches.items()}
    if tag == "f32":
        # the kernels line's names: the f32 flash option counts apart
        total["flash_attention_fwd_f32"] = total.pop("flash_attention_fwd")
    ttft = np.array([r.first_token_time - r.submit_time for r in reqs])
    ntok = sum(len(r.tokens) for r in reqs)
    res = {"phase": name, "layers": layers, "dtype": tag,
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
           "launches": total, "launches_burst": launches,
           "launches_burst_by_dtype": by_dtype,
           "launches_by": "graph replay",
           "fused_steps": g["fused_steps"],
           "decode_stall_steps": g["decode_stall_steps"],
           "prefill_pad_tokens": g["prefill_pad_tokens"],
           "health": {k: health[k] for k in ("status", "ready",
                                             "watchdog_trips")},
           "watchdog_s": ROBUST_WATCHDOG_S,
           "slo_verdict": health["slo"]["verdict"],
           "int8_spec": spec, "logits_check": check,
           "logits_ratio_tol": LOGITS_VS_F32_RATIO,
           "nvidia_smi": _smi_line()}
    if graph is not None:
        res["decode_chunk_wall_ms"] = graph["decode_chunk_wall_ms_median"]
        res["graph_check"] = {k: graph[k] for k in
                              ("identical", "control_detected", "tokens")}
    _emit(res)
    return res


def phase_serve_f16(layers: int = 32):
    """`phase_serve` in f16."""
    return phase_serve(layers, dtype=torch.float16)


def phase_serve_f32(layers: int = 32):
    """`phase_serve` in f32."""
    return phase_serve(layers, dtype=torch.float32)


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
    from paddle_tpu_torch import _build
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
        _build.reset_counts(flash)
        _build.reset_counts(rpa)
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
        by_dtype = {"flash_attention_fwd": _build.launches_by_dtype(flash),
                    "ragged_paged_attention": _build.launches_by_dtype(rpa)}
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
            "launches": launches, "launches_by_dtype": by_dtype,
            "fused_steps": snap["gauges"]["fused_steps"],
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


# ------------------------------------------------------- 4c. serve_robust
# the prefill ladder cut to the buckets the phase's prompts use (16-700
# tokens: one chunk of <= 128 or <= 512, or 512 + a remainder)
ROBUST_KW = dict(max_batch=8, block_size=16, max_total_len=1024,
                 prefill_buckets=(128, 512))
ROBUST_WATCHDOG_S = 3.0
ROBUST_HANG_S = 10.0            # finite: the wedged thread returns


def _robust_prompts(cfg, seed, n=8):
    """`n` prompts of 16-700 tokens (two above 512: chunked prefill)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(16, 513, n)
    lengths[[2 % n, 5 % n]] = rng.randint(513, 701, 2)
    return [rng.randint(1, cfg.vocab_size, int(x)).tolist() for x in lengths]


def _robust_burst(submit, prompts, budget, total, on_token=None,
                  prebuilt=None):
    """Submit `prompts` at once through `submit`, wait for every request;
    the kernels' launch counters are zeroed just before and added to
    `total` just after. `prebuilt` maps an index to a ready
    GenerationRequest. Returns (requests, wall seconds, launches)."""
    _zero_serve_counters()
    t0 = time.monotonic()
    reqs = []
    for i, p in enumerate(prompts):
        if prebuilt and i in prebuilt:
            reqs.append(submit(prebuilt[i]))
        else:
            kw = {} if on_token is None else {"on_token": on_token(i)}
            reqs.append(submit(p, max_new_tokens=budget, **kw))
    for r in reqs:
        if not r.wait(timeout=600):
            raise AssertionError(f"request {r.request_id} never ended")
    wall = time.monotonic() - t0
    launches = _read_serve_counters()
    for k, v in launches.items():
        total[k] += v
    return reqs, wall, launches


def _robust_rates(reqs, wall):
    ttft = np.array([r.first_token_time - r.submit_time for r in reqs
                     if r.first_token_time is not None])
    ntok = sum(len(r.tokens) for r in reqs)
    return {"tokens": ntok, "wall_s": wall, "tokens_per_s": ntok / wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99))}


def _first_divergence(want, reqs):
    """Where each request's tokens first leave `want`'s (None: never)."""
    return [next((j for j, (x, y) in enumerate(zip(a, r.tokens)) if x != y),
                 None) for a, r in zip(want, reqs)]


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _require_finished(reqs, budget, vocab, label, skip=()):
    from paddle_tpu_torch.serving import RequestState
    for i, r in enumerate(reqs):
        if i in skip:
            continue
        _require(r.state is RequestState.FINISHED,
                 f"{label}: request {i} ended {r.state.name} "
                 f"({r.finish_reason}): {r.error!r}")
        _require(len(r.tokens) == budget and all(
            0 <= t < vocab for t in r.tokens),
            f"{label}: request {i}: bad output {r.tokens}")


def _require_launched(launches, names, label):
    for n in names:
        _require(launches[n] >= 1, f"{label}: {n} never launched: "
                 f"{launches}")


def _snapshot_roundtrip(b, prompt, label):
    """On a stopped engine's batcher: serve `prompt` (alone, speculation
    off) to its second token, export its KV (timed, host copy included),
    and let the request decode on to its budget uninterrupted. Import the
    snapshot back into the same pool (timed; every pool tensor keeps its
    storage), export again and require the two snapshots byte-identical
    (codes, and an int8 pool's scales); a snapshot whose fingerprint
    names another block size must be refused. Then the imported request
    decodes to its budget through the same plain-chunk graph, one slot
    active, and its tokens must equal the uninterrupted run's bit for
    bit: an import that put a block or a scale where decode does not
    read it would change them."""
    import dataclasses
    rid = b.submit(prompt, max_new_tokens=32, speculative=False)
    while len(b.outputs.get(rid, [])) < 2:
        b.step()
    c = b.cache
    ptrs = [t.data_ptr() for t in (c.k, c.v, c.k_scale, c.v_scale)
            if t is not None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = b.export_kv(rid)
    export_ms = (time.perf_counter() - t0) * 1e3
    at_export = len(b.outputs[rid])
    b.run()
    uninterrupted = list(b.outputs[rid])
    b.release(rid)
    _require(len(uninterrupted) == 32, f"{label}: the uninterrupted run "
             f"gave {len(uninterrupted)} tokens")
    t0 = time.perf_counter()
    rid2 = b.import_kv(snap)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    c = b.cache
    _require([t.data_ptr() for t in (c.k, c.v, c.k_scale, c.v_scale)
              if t is not None] == ptrs,
             f"{label}: the import rebound a pool tensor")
    again = b.export_kv(rid2)
    for name in ("k", "v", "k_scale", "v_scale"):
        x, y = getattr(snap, name), getattr(again, name)
        _require((x is None) == (y is None) and (x is None or (
            x.dtype == y.dtype and x.tobytes() == y.tobytes())),
            f"{label}: snapshot {name} changed through export, import, "
            f"export")
    bad = dataclasses.replace(
        snap, fingerprint=dict(snap.fingerprint, block_size=2 * b.bs))
    try:
        b.import_kv(bad)
    except ValueError:
        refused = True
    else:
        refused = False
    _require(refused, f"{label}: a wrong fingerprint was imported")
    b.run()
    resumed = list(b.outputs[rid2])
    b.release(rid2)
    _require(resumed == uninterrupted,
             f"{label}: the imported request decoded {resumed}, the "
             f"uninterrupted one {uninterrupted}")
    return {"prompt_tokens": len(prompt), "blocks": snap.n_blocks,
            "mib": snap.nbytes / 2 ** 20, "export_ms": export_ms,
            "import_ms": import_ms, "pool_dtype":
            snap.fingerprint["pool_dtype"], "byte_identical": True,
            "wrong_fingerprint_refused": True,
            "tokens_at_export": at_export,
            "resumed_equals_uninterrupted": True}


def _robust_quarantine(params, cfg, total):
    """(a) One warmed engine (the watchdog on): a clean burst, then a
    rid-scoped poison over the same prompts (only its request fails; each
    survivor's tokens are set beside its clean run's), then a step-scoped
    transient (nobody convicted; its riders retry and finish); then an
    int8-KV speculative engine (chain of 4) whose first verify fails:
    every rider re-admits with speculation off, so row 18's suffix option
    launches before the fault and never after. The pool drains after
    each case; the probes capture nothing."""
    from paddle_tpu_torch.nlp.ragged_attention import \
        ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import (FaultInjector, GenerationRequest,
                                          InjectedFault, ServingEngine)
    V = cfg.vocab_size
    out = {}
    inj = FaultInjector(seed=SEED)
    # the prefix cache off: the poison burst serves the clean burst's
    # prompts and must prefill them as the clean burst did, so that its
    # survivors can be held to their clean runs
    eng = ServingEngine(params, cfg, max_new_tokens=32,
                        watchdog_s=ROBUST_WATCHDOG_S, fault_injector=inj,
                        prefix_cache=False, start=False, **ROBUST_KW)
    try:
        t0 = time.perf_counter()
        graphs = eng.warmup()
        torch.cuda.synchronize()
        out["warmup_graphs"], out["warmup_s"] = graphs, \
            time.perf_counter() - t0
        out["ladder"] = list(eng.batcher.prefill_buckets)
        eng.start()
        cc = eng.batcher.compile_count

        def quarantines():
            return eng.health()["quarantines"]

        # clean
        clean_prompts = _robust_prompts(cfg, SEED + 20)
        reqs, wall, n = _robust_burst(eng.submit, clean_prompts, 32, total)
        _require_finished(reqs, 32, V, "(a) clean")
        _require_launched(n, ("flash_attention_fwd",
                              "ragged_paged_attention"), "(a) clean")
        out["clean"] = {**_robust_rates(reqs, wall), "launches": n}
        out["clean_tokens"] = [list(r.tokens) for r in reqs]
        # rid-scoped poison, armed at the culprit's first streamed token
        q0 = quarantines()
        armed = []

        def arm(tok):
            if not armed:
                armed.append(culprit.request_id)
                inj.fail_on_rid(culprit.request_id)
        culprit = GenerationRequest(clean_prompts[3], max_new_tokens=32,
                                    on_token=arm)
        reqs, wall, n = _robust_burst(eng.submit, clean_prompts, 32, total,
                                      prebuilt={3: culprit})
        _require(culprit.finish_reason == "quarantine_culprit" and
                 0 < len(culprit.tokens) < 32,
                 f"(a) poison: the culprit ended {culprit.state.name} "
                 f"({culprit.finish_reason}) after {len(culprit.tokens)}")
        _require_finished(reqs, 32, V, "(a) poison", skip=(3,))
        _require_launched(n, ("flash_attention_fwd",
                              "ragged_paged_attention"), "(a) poison")
        h = eng.health()
        # the survivors against the clean burst (the same prompts): where
        # each first leaves its clean run, for those restored in place,
        # those requeued and those the quarantine did not touch
        agree = {}
        for i, r in enumerate(reqs):
            if i == 3:
                continue
            events = eng.trace.timeline(r.trace_id)["events"]
            how = ("restored" if any(e["kind"] == "restored"
                                     for e in events) else
                   "requeued" if any(e["kind"] == "requeued"
                                     for e in events) else "untouched")
            agree.setdefault(how, []).append(
                _first_divergence([out["clean_tokens"][i]], [r])[0])
        out["poison"] = {**_robust_rates(reqs, wall), "launches": n,
                         "convicted": [armed[0]],
                         "quarantines": h["quarantines"] - q0,
                         "requests_restored": h["requests_restored"],
                         "requests_requeued": h["requests_requeued"],
                         "culprit_tokens_streamed": len(culprit.tokens),
                         "survivor_first_divergence_vs_clean": agree}
        # step-scoped transient: allocator pressure on the 4th call of
        # the burst; no probe reproduces it, its riders retry
        inj.heal()
        q1 = quarantines()
        inj.exhaust_on_step(inj.stats()["calls"] + 4)
        prompts = _robust_prompts(cfg, SEED + 22)
        reqs, wall, n = _robust_burst(eng.submit, prompts, 32, total)
        _require_finished(reqs, 32, V, "(a) transient")
        retried = [i for i, r in enumerate(reqs) if r.retries]
        _require(retried and max(r.retries for r in reqs) == 1,
                 f"(a) transient: retries {[r.retries for r in reqs]}")
        _require(quarantines() - q1 == 1, "(a) transient: no quarantine")
        _require_launched(n, ("flash_attention_fwd",
                              "ragged_paged_attention"), "(a) transient")
        out["transient"] = {**_robust_rates(reqs, wall), "launches": n,
                            "retried_requests": retried,
                            "convicted": []}
        _require(eng.batcher.compile_count == cc,
                 f"(a) the quarantine captured: {cc} -> "
                 f"{eng.batcher.compile_count}")
        out["compile_count"] = [cc, eng.batcher.compile_count]
        _require(eng.drain(timeout=60) and
                 eng.snapshot()["gauges"]["kv_blocks_in_use"] == 0,
                 "(a) the pool did not drain")
        out["health"] = {k: eng.health()[k] for k in (
            "status", "step_faults", "quarantines", "requests_restored",
            "requests_requeued", "requests_retried", "requests_failed",
            "watchdog_trips")}
    finally:
        _require(eng.shutdown(timeout=120), "(a) shutdown was not clean")
    # the engine thread is gone: the batcher serves this thread now
    snap_prompt = np.random.RandomState(SEED + 27).randint(
        1, cfg.vocab_size, 700).tolist()
    out["snapshot_fp"] = _snapshot_roundtrip(eng.batcher, snap_prompt,
                                             "(a) fp snapshot")
    del eng
    _release()

    class SpecFault(FaultInjector):
        """Fails the first speculative verify (transient), after the
        draft has run; notes row 18's suffix launches at that moment."""
        at_fault = None
        rids = None

        def check(self, mode, rids, probe=False):
            if mode == "spec_verify" and self.at_fault is None:
                self.at_fault = rpa.launches_suffix
                self.rids = list(rids)
                raise InjectedFault("injected verify fault", transient=True)
            super().check(mode, rids, probe=probe)

    sinj = SpecFault()
    eng = ServingEngine(params, cfg, max_new_tokens=96, kv_dtype="int8",
                        speculative=True, spec_k=4, fault_injector=sinj,
                        start=False, **ROBUST_KW)
    try:
        t0 = time.perf_counter()
        graphs = eng.warmup()
        out["spec_warmup_graphs"], out["spec_warmup_s"] = graphs, \
            time.perf_counter() - t0
        cc = eng.batcher.compile_count
        prompts = _robust_prompts(cfg, SEED + 23)
        _zero_serve_counters()
        t0 = time.monotonic()
        reqs = [eng.submit(p, max_new_tokens=96) for p in prompts]
        eng.start()
        for r in reqs:
            r.wait(timeout=600)
        wall = time.monotonic() - t0
        n = _read_serve_counters()
        for k, v in n.items():
            total[k] += v
        _require_finished(reqs, 96, V, "(a) spec")
        _require(sinj.at_fault is not None and sinj.at_fault >= 1,
                 f"(a) spec: the suffix option did not launch before the "
                 f"fault ({sinj.at_fault})")
        # every request still decoding rides a spec tick (none runs while
        # a prefill is pending): each rider re-admits with speculation
        # off, so no spec tick can follow
        _require(sinj.rids and sum(r.spec_opt_out for r in reqs) ==
                 len(sinj.rids),
                 f"(a) spec: {len(sinj.rids)} rode the failed tick, opt-outs "
                 f"{[r.spec_opt_out for r in reqs]}")
        _require(n["ragged_paged_attention_suffix"] == sinj.at_fault,
                 f"(a) spec: the suffix option launched after the fault: "
                 f"{sinj.at_fault} -> {n['ragged_paged_attention_suffix']}")
        _require_launched(n, ("flash_attention_fwd",
                              "ragged_paged_attention_int8"), "(a) spec")
        _require(eng.batcher.compile_count == cc,
                 "(a) spec: the quarantine captured")
        _require(eng.drain(timeout=60) and
                 eng.snapshot()["gauges"]["kv_blocks_in_use"] == 0,
                 "(a) spec: the pool did not drain")
        out["spec"] = {**_robust_rates(reqs, wall), "launches": n,
                       "suffix_launches_at_fault": sinj.at_fault,
                       "riders_of_failed_tick": len(sinj.rids),
                       "retries": [r.retries for r in reqs]}
    finally:
        _require(eng.shutdown(timeout=120), "(a) spec shutdown not clean")
    out["snapshot_int8"] = _snapshot_roundtrip(eng.batcher, snap_prompt,
                                               "(a) int8 snapshot")
    del eng
    _release()
    return out


def _robust_disaggregated(params, cfg, clean_prompts, clean_tokens, total):
    """(b) Router(disaggregated=True): a prefill-role and a decode-role
    replica serve the clean burst's prompts; every request migrates once
    and the decode replica runs no prefill. Tokens are compared with the
    monolithic engine's (the clean burst): the match rate is reported."""
    from paddle_tpu_torch.serving import Router
    r = Router(params, cfg, replicas=2, disaggregated=True,
               per_replica=[{"role": "prefill"}, {"role": "decode"}],
               max_new_tokens=32, start=False, **ROBUST_KW)
    try:
        t0 = time.perf_counter()
        graphs = r.warmup()
        warm_s = time.perf_counter() - t0
        r.start()
        streamed = [[] for _ in clean_prompts]
        reqs, wall, n = _robust_burst(
            r.submit, clean_prompts, 32, total,
            on_token=lambda i: streamed[i].append)
        _require_finished(reqs, 32, cfg.vocab_size, "(b)")
        pre, dec = r.engines
        h = r.health()
        _require(h["migrations"] == len(reqs),
                 f"(b): {h['migrations']} migrations for {len(reqs)}")
        _require(dec.batcher.prefill_chunk_calls == 0 and
                 dec.batcher.imported_kv == len(reqs) and
                 pre.batcher.exported_kv == len(reqs),
                 f"(b): decode prefill chunks "
                 f"{dec.batcher.prefill_chunk_calls}, imported "
                 f"{dec.batcher.imported_kv}, exported "
                 f"{pre.batcher.exported_kv}")
        _require(streamed == [list(q.tokens) for q in reqs],
                 "(b): a client stream re-emitted or lost a token")
        _require_launched(n, ("flash_attention_fwd",
                              "ragged_paged_attention"), "(b)")
        pairs = [(x, y) for a, b in zip(clean_tokens, reqs)
                 for x, y in zip(a, b.tokens)]

        handoffs = [e["handoff_s"] for e in r.snapshot()["migration_log"]]
        res = {**_robust_rates(reqs, wall), "launches": n,
               "warmup_graphs": graphs, "warmup_s": warm_s,
               "migrations": h["migrations"],
               "migration_mib": h["migration_bytes"] / 2 ** 20,
               "handoff_s_p50": float(np.percentile(handoffs, 50)),
               "decode_prefill_chunks": dec.batcher.prefill_chunk_calls,
               "match_rate_vs_monolithic":
                   sum(x == y for x, y in pairs) / len(pairs),
               "first_divergence_vs_monolithic":
                   _first_divergence(clean_tokens, reqs),
               "bit_identical_to_monolithic":
                   [list(q.tokens) for q in reqs] == clean_tokens}
    finally:
        _require(r.shutdown(timeout=120), "(b) shutdown was not clean")
    del r
    _release()
    return res


def _sse(host, port, prompt, budget):
    """POST /v1/stream; returns (routed replica, tokens, final event)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=600)
    conn.request("POST", "/v1/stream",
                 json.dumps({"prompt": prompt, "max_new_tokens": budget}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    _require(resp.status == 200, f"(d) /v1/stream answered {resp.status}")
    events, cur = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.decode().rstrip("\n")
        if line.startswith("event: "):
            cur = line[7:]
        elif line.startswith("data: "):
            events.append((cur or "data", json.loads(line[6:])))
            cur = None
    conn.close()
    _require(events and events[0][0] == "routed" and events[-1][0] ==
             "done", f"(d) SSE events {events[:1]} ... {events[-1:]}")
    return (events[0][1]["replica"],
            [d["token"] for k, d in events if k == "data"], events[-1][1])


def _http(host, port, method, path, payload=None):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        conn.request(method, path,
                     None if payload is None else json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _robust_failover(params, cfg, clean_tokens, total):
    """(c) Router(replicas=2, auto_restart=True), both replicas warmed,
    the watchdog on: a finite hang wedges r0 mid-burst, the watchdog
    trips, r0's requests continue on r1 (each client stream before the
    failover a strict prefix of its final one), a second wave lands on r1
    while the supervisor rebuilds r0 — its warmup capturing graphs while
    r1 replays its own — and r0 passes the readiness probe and rejoins.
    (d) Then an HttpFrontend on 127.0.0.1:0 over the same router."""
    from paddle_tpu_torch.serving import FaultInjector, HttpFrontend, Router

    class Stamped(FaultInjector):
        """Notes when each real device call reaches the gate."""

        def __init__(self, seed):
            super().__init__(seed)
            self.stamps = []

        def check(self, mode, rids, probe=False):
            if not probe:
                self.stamps.append(time.monotonic())
            super().check(mode, rids, probe=probe)

    injs = [Stamped(SEED), Stamped(SEED + 1)]
    r = Router(params, cfg, replicas=2, auto_restart=True,
               watchdog_s=ROBUST_WATCHDOG_S, max_new_tokens=32,
               per_replica=[{"fault_injector": injs[0]},
                            {"fault_injector": injs[1]}],
               restart_opts={"poll_s": 0.05, "probe_timeout_s": 300.0},
               start=False, **ROBUST_KW)
    out = {}
    fe = None
    # the respawn's stages, from the supervisor's own calls: the replica
    # built (the trip to here is detection and teardown), its warmup
    build, stamps = r._build_replica, {}

    def timed_build(i):
        stamps["build_start"] = time.monotonic()
        eng = build(i)
        warm = eng.warmup

        def timed_warmup():
            t = time.monotonic()
            n = warm()
            stamps["warmup"] = (t, time.monotonic())
            return n
        eng.warmup = timed_warmup
        return eng
    r._build_replica = timed_build
    try:
        t0 = time.perf_counter()
        out["warmup_graphs"] = r.warmup()
        out["warmup_s"] = time.perf_counter() - t0
        r.start()
        torch.cuda.reset_peak_memory_stats()
        mem0 = _memory()
        prompts = _robust_prompts(cfg, SEED + 20)
        ready = threading.Event()
        armed = []
        streamed = [[] for _ in prompts]
        handles = []

        def on_token(i):
            def cb(tok):
                streamed[i].append(tok)
                if not armed and ready.wait(30) and \
                        handles[i].replica_id == "r0":
                    armed.append(injs[0].stats()["calls"] + 1)
                    injs[0].hang_on_step(armed[0], ROBUST_HANG_S)
            return cb

        def submit(p, **kw):
            q = r.submit(p, **kw)
            handles.append(q)
            return q

        _zero_serve_counters()
        t_burst = time.monotonic()
        for i, p in enumerate(prompts):
            submit(p, max_new_tokens=32, on_token=on_token(i))
        ready.set()
        old_r0 = r.engines[0]
        deadline = time.monotonic() + 300
        while old_r0.health()["status"] != "UNHEALTHY":
            _require(time.monotonic() < deadline, "(c) r0 never tripped")
            time.sleep(0.005)
        t_trip = time.monotonic()
        detect_s = t_trip - injs[0].stamps[armed[0] - 1]
        tok_r1 = r.engines[1].metrics.counter("tokens_generated").value
        # a second wave while r0 is rebuilt: only r1 can take it
        wave = [submit(p, max_new_tokens=32) for p in
                _robust_prompts(cfg, SEED + 24, n=4)]
        while not (r.health()["replica_restarts"] >= 1 and
                   r.health()["serving_replicas"] == 2):
            _require(time.monotonic() < deadline, "(c) r0 never rejoined")
            time.sleep(0.01)
        t_rejoin = time.monotonic()
        served_meanwhile = r.engines[1].metrics.counter(
            "tokens_generated").value - tok_r1
        for q in handles:
            _require(q.wait(timeout=600), "(c) a request never ended")
        wall = time.monotonic() - t_burst
        n = _read_serve_counters()
        for k, v in n.items():
            total[k] += v
        peak = torch.cuda.max_memory_allocated()
        _require_finished(handles, 32, cfg.vocab_size, "(c)")
        h = r.health()
        snap = r.snapshot()
        fo = snap["failover_log"]
        _require(h["failovers"] >= 1 and fo, f"(c) no failover: {h}")
        moved = {e["router_rid"]: e for e in fo}
        for q in handles:
            if q.request_id in moved:
                kept = moved[q.request_id]["tokens_kept"]
                _require(0 <= kept < len(q.tokens),
                         f"(c) kept {kept} of {len(q.tokens)}")
        _require(streamed == [list(q.tokens) for q in handles[:8]],
                 "(c) a client stream re-emitted or lost a token")
        _require(r.engines[0] is not old_r0, "(c) r0 was not respawned")
        sup = h["supervisor"]["r0"]
        _require(sup["state"] == "SERVING" and sup["restarts"] == 1,
                 f"(c) supervisor: {sup}")
        new_r0 = r.engines[0]
        _require(new_r0.batcher.compile_count == sup["warm_compile_count"],
                 "(c) the respawned replica captured after readiness")
        _require_launched(n, ("flash_attention_fwd",
                              "ragged_paged_attention"), "(c)")
        pairs = [(x, y) for a, b in zip(clean_tokens, handles[:8])
                 for x, y in zip(a, b.tokens)]
        post = [r.submit(p[:64], max_new_tokens=8)
                for p in _robust_prompts(cfg, SEED + 25, n=4)]
        for q in post:
            _require(q.result(timeout=300), "(c) post-rejoin request")
        _require("r0" in {q.replica_id for q in post},
                 f"(c) the respawned r0 took no traffic: "
                 f"{[q.replica_id for q in post]}")
        out.update(_robust_rates(handles, wall))
        out.update({
            "launches": n, "watchdog_s": ROBUST_WATCHDOG_S,
            "hang_s": ROBUST_HANG_S, "detect_s": detect_s,
            "respawn_s": t_rejoin - t_trip,
            "respawn_stages_s": {
                "trip_to_build": stamps["build_start"] - t_trip,
                "build": stamps["warmup"][0] - stamps["build_start"],
                "warmup": stamps["warmup"][1] - stamps["warmup"][0],
                "probe_and_rejoin": t_rejoin - stamps["warmup"][1]},
            "restart_failures": sup["restart_failures"],
            "r1_tokens_during_respawn": served_meanwhile,
            "failovers": h["failovers"],
            "failover_via": sorted({e.get("via", "") for e in fo}),
            "tokens_kept": [e["tokens_kept"] for e in fo],
            "peak_memory_bytes": peak, "memory_before_burst": mem0,
            "respawn_warm_compile_count": sup["warm_compile_count"],
            "match_rate_vs_monolithic":
                sum(x == y for x, y in pairs) / len(pairs),
            "first_divergence_vs_monolithic":
                _first_divergence(clean_tokens, handles[:8])})
        # (d) the HTTP frontend over the same fleet
        fe = HttpFrontend(r, host="127.0.0.1", port=0,
                          shutdown_router=False)
        host, port = fe.start()
        rng = np.random.RandomState(SEED + 26)
        short = [rng.randint(1, cfg.vocab_size, 12).tolist()
                 for _ in range(2)]
        gens = []
        for p in short:
            st, body = _http(host, port, "POST", "/v1/generate",
                             {"prompt": p, "max_new_tokens": 16})
            _require(st == 200, f"(d) /v1/generate answered {st}: {body}")
            gens.append(json.loads(body))
            _require(len(gens[-1]["tokens"]) == 16,
                     f"(d) generate: {gens[-1]}")
        for attempt in range(4):
            rep, toks, final = _sse(host, port, short[0], 16)
            if rep == gens[0]["replica"]:
                break
        _require(rep == gens[0]["replica"] and toks == gens[0]["tokens"],
                 f"(d) SSE on {rep}: {toks}; generate on "
                 f"{gens[0]['replica']}: {gens[0]['tokens']}")
        st, body = _http(host, port, "GET", "/health")
        _require(st == 200, f"(d) /health answered {st}")
        st, metrics = _http(host, port, "GET", "/metrics")
        text = metrics.decode()
        _require(st == 200 and 'replica="r0"' in text and
                 'replica="r1"' in text, "(d) /metrics lacks the labels")
        out["frontend"] = {"generate_replicas": [g["replica"] for g in gens],
                           "sse_replica": rep, "sse_attempts": attempt + 1,
                           "sse_equals_generate": True,
                           "health_status": json.loads(body)["status"],
                           "metrics_bytes": len(metrics)}
    finally:
        if fe is not None:
            fe.shutdown()
        clean = r.shutdown(timeout=120)
    _require(clean, "(c) shutdown was not clean")
    del r
    _release()
    return out


def phase_serve_robust(layers: int = 32):
    """Serving robustness on one card at Llama-3-8B widths (random bf16
    weights from the seed, `layers` layers, one weight tree shared by
    every engine and replica): (a) quarantine — a rid-scoped poison fails
    only its request, a step-scoped transient convicts nobody and its
    riders retry, a failed speculative verify (int8 KV, chain of 4) turns
    speculation off for its riders; (b) disaggregated prefill and decode
    replicas with KV snapshot migration, and the snapshot round trip over
    the fp and the int8 pool; (c) failover and respawn after a watchdog
    trip; (d) the HTTP frontend. Every hard check raises."""
    from paddle_tpu_torch.nlp import llama
    t_phase = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    _release()
    total = {k: 0 for k in _counter_objs()}
    res = {"phase": "serve_robust", "layers": layers,
           "ladder": list(ROBUST_KW["prefill_buckets"])}
    t0 = time.perf_counter()
    res["quarantine"] = _robust_quarantine(params, cfg, total)
    res["quarantine_s"] = time.perf_counter() - t0
    clean_tokens = res["quarantine"].pop("clean_tokens")
    _emit({"phase": "serve_robust.quarantine", **res["quarantine"]})
    t0 = time.perf_counter()
    res["disaggregated"] = _robust_disaggregated(
        params, cfg, _robust_prompts(cfg, SEED + 20), clean_tokens, total)
    res["disaggregated_s"] = time.perf_counter() - t0
    _emit({"phase": "serve_robust.disaggregated", **res["disaggregated"]})
    t0 = time.perf_counter()
    res["failover"] = _robust_failover(params, cfg, clean_tokens, total)
    res["failover_s"] = time.perf_counter() - t0
    del params
    _release()
    res["launches"] = total
    _require_launched(total, tuple(total), "serve_robust")
    res["seconds"] = time.perf_counter() - t_phase
    res["nvidia_smi"] = _smi_line()
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
    _zero_counts(counters)
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
    launches, by_dtype = _read_counts(counters)
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
           "launches_by_dtype": {n: d for n, d in by_dtype.items() if d},
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


def _f32_option_launches(by_dtype):
    """The flash pair's f32 launches under the kernels line's names of
    the f32 option (its own source, flash_f32.cu)."""
    return {f"{k}_f32": by_dtype.get(k, {}).get("f32", 0)
            for k in ("flash_attention_fwd", "flash_attention_bwd")}


def _train_dtype_phase(peaks, name, cfg, batch, warmup, timed, tag,
                       seq=2048):
    """`cfg` (the flagship's widths at a compute dtype other than bf16,
    f32 parameters) through `_drive_train` with the tree AdamW behind the
    global clip (`make_optimizer(1e-4, state_quant=None, grad_clip=1.0)`):
    losses finite; the flash pair and rows 7-8 exactly as the dense step
    implies, all in dtype `tag` and none in another."""
    from paddle_tpu_torch.nlp import llama
    res, state, _ = _drive_train(peaks, llama, cfg, batch,
                                 _train_counters(), warmup, timed, seq,
                                 state_quant=None)
    res["launches"].update(_f32_option_launches(res["launches_by_dtype"]))
    tok_s, fpt = res["tokens_per_s"], res["flops_per_token"]
    res = {"phase": name,
           "config": f"flagship_2b (bench.py:120) at dtype {cfg.dtype}, "
                     f"param_dtype {cfg.param_dtype}",
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size},
           "optimizer": "adamw lr 1e-4 (f32 moments), global clip 1.0",
           **res,
           # the GEMMs run torch.matmul at PyTorch's default: full f32
           # (FFMA, 67 TFLOP/s) in f32, the fp16 tensor cores in f16
           "mfu_f32": tok_s * fpt / peaks[2], "mfu_tf32": tok_s * fpt
           / _TF32_PEAK, "gemm_precision": str(cfg.dtype),
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "nvidia_smi": _smi_line()}
    _emit(res)
    del state
    torch.cuda.empty_cache()
    if not all(np.isfinite(res["losses"])) \
            or not all(np.isfinite(res["grad_norms"])):
        raise AssertionError(f"{name}: non-finite loss or grad norm: "
                             f"{res['losses']} {res['grad_norms']}")
    per_step = {k: n for k, n in _dense_launches_per_step(cfg, False).items()
                if k != "adamw_q"}
    _check_launches(name, res, per_step, res["steps"])
    _check_dtype_launches(name, res["launches_by_dtype"], per_step,
                          res["steps"], tag)
    return res


def phase_train_f32(peaks, warmup: int = 1, timed: int = 2):
    """The flagship config (bench.py:120: D 4096, F 9472, 11 layers, GQA
    32/8, V 32000) at `LlamaConfig(dtype=float32, param_dtype=float32)`,
    batch F32_TRAIN_BATCH x 2048 (~10 s a step in full f32, so 1 warm-up
    and 2 timed steps), through the public training entry points: rows
    1, 5, 7 and 8 in f32 at their exact per-step counts, losses finite
    and falling."""
    from paddle_tpu_torch.nlp import llama
    cfg = llama.LlamaConfig.flagship_2b(dtype=torch.float32,
                                        param_dtype=torch.float32)
    res = _train_dtype_phase(peaks, "train_f32", cfg, F32_TRAIN_BATCH,
                             warmup, timed, "f32")
    _check_losses(res)
    return res


def phase_train_f16(peaks, layers: int = 2, warmup: int = 2,
                    timed: int = 2):
    """The flagship widths at 2 layers and `LlamaConfig(dtype=float16)`
    (f32 parameters, as the JAX package's default param_dtype), batch
    F32_TRAIN_BATCH x 2048, 2 + 2 steps: rows 7-8 and the flash pair in
    f16 at their exact per-step counts, losses finite."""
    from paddle_tpu_torch.nlp import llama
    cfg = llama.LlamaConfig.flagship_2b(num_hidden_layers=layers,
                                        dtype=torch.float16,
                                        param_dtype=torch.float32)
    return _train_dtype_phase(peaks, "train_f16", cfg, F32_TRAIN_BATCH,
                              warmup, timed, "f16")


def phase_train_p32(peaks, warmup: int = 2, timed: int = 4, batch: int = 8,
                    seq: int = 2048):
    """phase_train's recipe (bf16 compute, 8-bit AdamW with the streamed
    clip at 1.0, lr 1e-4, batch 8 x 2048) at `LlamaConfig.flagship_2b(
    param_dtype=float32)`, the JAX package's default parameter dtype: f32
    parameters, 8-bit moments. Row 17 exactly once a leaf a step, all in
    f32; the flash pair and rows 7-8 at the dense step's counts, all in
    bf16 (rows 7-8 with the f32 weight); losses fall."""
    from paddle_tpu_torch.nlp import llama
    cfg = llama.LlamaConfig.flagship_2b(param_dtype=torch.float32)
    res, state, _ = _drive_train(peaks, llama, cfg, batch,
                                 _train_counters(), warmup, timed, seq)
    res = {"phase": "train_p32",
           "config": "flagship_2b (bench.py:120) at param_dtype float32",
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size},
           "optimizer": "8-bit AdamW (fused), lr 1e-4, streamed clip 1.0",
           **res, "nvidia_smi": _smi_line()}
    _emit(res)
    del state
    torch.cuda.empty_cache()
    _check_losses(res)
    per_step = _dense_launches_per_step(cfg, True)
    _check_launches("train_p32", res, per_step, res["steps"])
    _check_dtype_launches("train_p32", res["launches_by_dtype"],
                          {"adamw_q": per_step["adamw_q"]}, res["steps"],
                          "f32")
    _check_dtype_launches("train_p32", res["launches_by_dtype"],
                          {k: n for k, n in per_step.items()
                           if k != "adamw_q"}, res["steps"], "bf16")
    return res


def _moe_launches_per_step(cfg):
    """Every kernel's launches in one MoE training step of cfg's depth L
    (each layer recomputed once in the backward with cfg.remat): the
    dispatch and combine forwards (row 14) twice a layer plus the
    dispatch backward, the combine backward (row 15) once; the flash and
    norm kernels as the dense step; row 17 once a leaf."""
    from paddle_tpu_torch.nlp import moe
    L, fwd = cfg.num_hidden_layers, 2 if cfg.remat else 1
    shapes = moe._shapes(cfg)
    return {"gather_wsum": (2 * fwd + 1) * L, "gather_scale_dot": L,
            "flash_attention_fwd": fwd * L, "flash_attention_bwd": L,
            "rms_norm_fwd": 2 * fwd * L, "rms_norm_bwd": 2 * L,
            "adamw_q": len(shapes) - 1 + len(shapes["layers"])}


def phase_train_moe_f32(peaks, warmup: int = 1, timed: int = 2):
    """`phase_train_moe` in f32 at full depth, 1 + 2 steps."""
    return phase_train_moe(peaks, warmup, timed, dtype=torch.float32)


def phase_train_moe_f16(peaks, warmup: int = 2, timed: int = 2):
    """`phase_train_moe` in f16 at 2 layers, 2 + 2 steps."""
    return phase_train_moe(peaks, warmup, timed, dtype=torch.float16,
                           layers=2)


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


def phase_train_moe(peaks, warmup: int = 2, timed: int = 4,
                    batch: int = MOE_BATCH, seq: int = 2048,
                    dtype=torch.bfloat16, layers: int = 12):
    """The JAX package's single-chip MoE config (bench.py:98) at dtype =
    param_dtype = `dtype` (train_moe_f32 and train_moe_f16 run it in f32
    and f16) and `layers` layers, through `train.make_train_step(
    model=moe)` with the 8-bit AdamW (lr 1e-4, streamed clip 1.0), batch
    x 2048: every kernel launched exactly as the step implies
    (`_moe_launches_per_step`: rows 14, 15 and 17, the flash pair and
    rows 7-8), all in `dtype`; losses finite, and falling but in f16 (2
    layers, 2 + 2 steps). After the timed steps one forward of the final
    params over the step's batch reads the aux losses and each layer's
    share of dropped (token, choice) pairs."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.nlp import moe

    tag = _build.DTYPE_TAGS[str(dtype)]
    name = "train_moe" if dtype == torch.bfloat16 else f"train_moe_{tag}"
    cfg = moe.MoeConfig.flagship_moe(num_hidden_layers=layers, dtype=dtype,
                                     param_dtype=dtype)
    res, state, tokens = _drive_train(peaks, moe, cfg, batch,
                                      _train_counters(moe=True), warmup,
                                      timed, seq)
    res["launches"].update(_f32_option_launches(res["launches_by_dtype"]))
    with torch.no_grad(), _moe_routing_probe() as (maps, _):
        _, aux = moe._backbone(state.params, tokens, cfg)
    dropped = [1.0 - m[2].float().mean().item()
               for _, m in sorted(maps.items())]
    tok_s, fpt = res["tokens_per_s"], res["flops_per_token"]
    res = {"phase": name,
           "config": f"flagship_moe (bench.py:98) at dtype {dtype}, "
                     f"param_dtype {dtype}, {layers} layers",
           "active_params": moe.active_params(cfg),
           "widths": {"D": cfg.hidden_size, "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size,
                      "E": cfg.num_experts, "k": cfg.num_experts_per_tok,
                      "F_expert": cfg.moe_intermediate_size,
                      "shared": cfg.num_shared_experts,
                      "capacity": cfg.capacity(seq)},
           "optimizer": "8-bit AdamW (fused), lr 1e-4, streamed clip 1.0",
           **res,
           "final_aux": {n: float(v) for n, v in aux.items()},
           "dropped_share_by_layer": dropped,
           "dropped_share": float(np.mean(dropped)),
           "nvidia_smi": _smi_line()}
    if dtype == torch.float32:
        # the GEMMs run torch.matmul at PyTorch's default: full f32
        # (FFMA, 67 TFLOP/s)
        res.update(mfu_f32=tok_s * fpt / peaks[2],
                   allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    _emit(res)
    del state, tokens
    torch.cuda.empty_cache()
    if dtype == torch.float16:
        if not all(np.isfinite(res["losses"])) \
                or not all(np.isfinite(res["grad_norms"])):
            raise AssertionError(f"{name}: non-finite loss or grad norm: "
                                 f"{res['losses']} {res['grad_norms']}")
    else:
        _check_losses(res)
    per_step = _moe_launches_per_step(cfg)
    _check_launches(name, res, per_step, res["steps"])
    _check_dtype_launches(name, res["launches_by_dtype"], per_step,
                          res["steps"], tag)
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


def phase_grad_check_f32(layers: int = 2, seq: int = 2048):
    """The f32 trainer's gradient check: one loss + backward of `loss_fn`
    at the flagship widths, 2 layers, `LlamaConfig(dtype=float32)` with
    f32 parameters, through the kernels, their plain f32 versions and the
    plain versions with the dcap fault. The relative RMS distance of the
    per-token losses and of each gradient group between the kernels and
    the plain path must be at most F32_GRAD_TOL, and the fault's at least
    10 times that in the groups it reaches."""
    from paddle_tpu_torch.nlp import llama

    cfg = llama.LlamaConfig.flagship_2b(num_hidden_layers=layers,
                                        dtype=torch.float32,
                                        param_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    params = llama.init_params(cfg, gen, device="cuda", training=True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, seq))).cuda()

    def run():
        return _grad_run(llama.loss_fn, llama.forward, cfg, params, tokens)

    def dist(a, b):
        return (torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
                / torch.sqrt(sum((y ** 2).sum() for y in b))).item()

    counters = _train_counters()
    _zero_counts(counters)
    kernel = run()
    _, by_dtype = _read_counts(counters)
    with _plain_kernels():
        ref = run()
    with _plain_kernels(fault="dcap"):
        fault = run()
    del params
    out = {}
    for group, keys in {"loss": None, **_GRAD_GROUPS}.items():
        def pick(r):
            return [r[1]] if keys is None else [r[2][k] for k in keys]
        out[group] = {"kernel_vs_plain": dist(pick(kernel), pick(ref)),
                      "fault_vs_plain": dist(pick(fault), pick(ref))}
    out["loss_values"] = {"kernel": kernel[0], "plain": ref[0],
                          "fault": fault[0]}
    _emit({"phase": "grad_check_f32", "layers": layers, "seq": seq,
           "tol": F32_GRAD_TOL, "fault": "dcap",
           "fault_groups": _FAULT_GROUPS, "launches_by_dtype": by_dtype,
           **out})
    del kernel, ref, fault
    torch.cuda.empty_cache()
    for group in ("loss", *_GRAD_GROUPS):
        c = out[group]
        if not c["kernel_vs_plain"] <= F32_GRAD_TOL:
            raise AssertionError(f"grad_check_f32 {group}: the kernels are "
                                 f"{c['kernel_vs_plain']} from the plain f32"
                                 f" path, over {F32_GRAD_TOL}")
        if group in _FAULT_GROUPS and \
                not c["fault_vs_plain"] >= 10 * F32_GRAD_TOL:
            raise AssertionError(f"grad_check_f32 {group}: the dcap fault "
                                 f"reads {c['fault_vs_plain']}, under 10 x "
                                 f"{F32_GRAD_TOL}")
    for kernel_name in ("flash_attention_fwd", "flash_attention_bwd",
                        "rms_norm_fwd", "rms_norm_bwd"):
        if not by_dtype[kernel_name].get("f32"):
            raise AssertionError(f"grad_check_f32: {kernel_name} launched "
                                 f"{by_dtype[kernel_name]} by dtype")
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


def phase_grad_check_moe_f32(layers: int = 2, seq: int = 2048):
    """The MoE model's gradient check in f32: one loss + backward at the
    MoE widths, 2 layers, 1 x 2048 tokens, `MoeConfig(dtype=float32,
    param_dtype=float32)`, through the kernels, their plain f32 versions
    and the plain versions with the dispatch fault (row 14's backward
    dropping each token's second choice), all routing by the plain
    path's maps (`_moe_routing_probe(replay=...)`: a near-tie flipped by
    the flash kernel's TF32 would move tokens between experts, a
    difference of routing, not of kernels). The relative RMS distance of
    the per-token losses and of each gradient group between the kernels
    and the plain path must be at most F32_GRAD_TOL, and the fault's at
    least 10 times that in the groups it reaches; rows 14 and 15 must
    have run in f32."""
    from paddle_tpu_torch.nlp import moe
    cfg = moe.MoeConfig.flagship_moe(num_hidden_layers=layers,
                                     dtype=torch.float32,
                                     param_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    params = moe.init_params(cfg, gen, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, seq))).cuda()

    def run(replay=None):
        with _moe_routing_probe(replay) as (maps, _):
            r = _grad_run(moe.loss_fn, lambda t, tok, cc: moe.forward(
                t, tok, cc)[0], cfg, params, tokens)
        return r, maps

    def dist(a, b):
        return (torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
                / torch.sqrt(sum((y ** 2).sum() for y in b))).item()

    with _plain_kernels():
        ref, maps = run()
    counters = _train_counters(moe=True)
    _zero_counts(counters)
    kernel, _ = run(maps)
    _, by_dtype = _read_counts(counters)
    with _plain_kernels(fault="dispatch"):
        fault, _ = run(maps)
    del params
    out = {}
    for group, keys in {"loss": None, **_MOE_GRAD_GROUPS}.items():
        def pick(r):
            return [r[1]] if keys is None else [r[2][k] for k in keys]
        out[group] = {"kernel_vs_plain": dist(pick(kernel), pick(ref)),
                      "fault_vs_plain": dist(pick(fault), pick(ref))}
    out["loss_values"] = {"kernel": kernel[0], "plain": ref[0],
                          "fault": fault[0]}
    _emit({"phase": "grad_check_moe_f32", "layers": layers, "seq": seq,
           "tol": F32_GRAD_TOL, "fault": "dispatch",
           "fault_groups": _MOE_FAULT_GROUPS, "launches_by_dtype": by_dtype,
           **out})
    del kernel, ref, fault
    torch.cuda.empty_cache()
    for group in ("loss", *_MOE_GRAD_GROUPS):
        c = out[group]
        if not c["kernel_vs_plain"] <= F32_GRAD_TOL:
            raise AssertionError(f"grad_check_moe_f32 {group}: the kernels "
                                 f"are {c['kernel_vs_plain']} from the plain"
                                 f" f32 path, over {F32_GRAD_TOL}")
        if group in _MOE_FAULT_GROUPS and \
                not c["fault_vs_plain"] >= 10 * F32_GRAD_TOL:
            raise AssertionError(f"grad_check_moe_f32 {group}: the dispatch "
                                 f"fault reads {c['fault_vs_plain']}, under "
                                 f"10 x {F32_GRAD_TOL}")
    for kernel_name in ("gather_wsum", "gather_scale_dot",
                        "flash_attention_fwd", "flash_attention_bwd",
                        "rms_norm_fwd", "rms_norm_bwd"):
        if not by_dtype[kernel_name].get("f32") or any(
                n for t, n in by_dtype[kernel_name].items() if t != "f32"):
            raise AssertionError(f"grad_check_moe_f32: {kernel_name} "
                                 f"launched {by_dtype[kernel_name]} by dtype")
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


def _eager_ernie_steps(paddle, amp_dtype, warmup=2, timed=4, batch=64,
                       seq=512):
    """bench.py:134-181's finetune recipe on the eager ERNIE-3.0-base
    (BASELINE config 1; `tools/eager_ernie.build_model`, dropout 0.1,
    attention-probability dropout 0; AdamW at lr 2e-5 with the global-norm
    clip at 1.0; the same batch of `batch` x `seq` from default_rng(0)
    every step): `warmup` then `timed` steps of loss.backward();
    opt.step(); opt.clear_grad() under auto_cast in `amp_dtype` (None: f32
    throughout), the eager counters zeroed before the timed steps (one
    synchronize after them). Returns the run's fields of a phase line."""
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model, train_step

    cfg = ernie.ErnieConfig.ernie3_base()
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
    counters = _eager_counters()
    losses, dt, launches, peak = _run_steps(
        lambda: train_step(paddle, model, loss_fn, opt, ids, labels,
                           amp_dtype=amp_dtype), counters, warmup, timed)
    res = {"widths": {"V": cfg.vocab_size, "D": cfg.hidden_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads, "hd": cfg.head_dim,
                      "F": cfg.intermediate_size},
           "params": sum(p.size for p in model.parameters()),
           "param_dtypes": sorted({str(p.dtype).replace("torch.", "")
                                   for p in model.parameters()}),
           "batch": batch, "seq": seq, "steps": warmup + timed,
           "timed_steps": timed, "step_ms": dt / timed * 1e3,
           "tokens_per_s": batch * seq * timed / dt,
           "flops_per_token": ernie.flops_per_token(cfg, seq),
           "losses": losses, "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_by_dtype": _read_counts(counters)[1]}
    del model, opt, ids, labels
    torch.cuda.empty_cache()
    return res


def phase_eager(peaks):
    """The eager API's training path at ERNIE-3.0-base width
    (`_eager_ernie_steps`: the encoder composed from paddle.nn and
    paddle.incubate.nn layers), f32 parameters under O1 bf16 auto_cast,
    2 warm-up then 4 timed steps of 64 x 512. Launch counters are zeroed
    before the timed steps and must read exactly the step's counts.
    First the README's Quick start trains a few steps on the card
    (`_quick_start`)."""
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    quick_start = _quick_start()
    run = _eager_ernie_steps(paddle, "bfloat16")
    tok_s, fpt, timed = (run["tokens_per_s"], run["flops_per_token"],
                         run["timed_steps"])
    res = {"phase": "eager",
           "config": "ErnieConfig.ernie3_base (BASELINE config 1, "
                     "bench.py:134-181), composed from layers",
           **run, "mfu": tok_s * fpt / peaks[0],
           "launches_per_step": {n: c / timed
                                 for n, c in run["launches"].items()},
           "quick_start_losses": quick_start, "nvidia_smi": _smi_line()}
    _emit(res)
    losses, launches = res["losses"], res["launches"]
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


def phase_eager_f32(peaks):
    """Phase eager's recipe (`_eager_ernie_steps`: ERNIE-3.0-base composed
    from layers, 2 warm-up and 4 timed steps of 64 x 512) in f32 with no
    auto_cast, the precision of PaddleNLP's finetune scripts without
    --fp16: the flash pair exactly 12 + 12 a step and the LayerNorm pair
    25 + 25, all in f32 and none in another dtype; losses finite and
    falling. MFU against the f32 rate of the GEMMs (torch.matmul at
    PyTorch's default, full f32: 67 TFLOP/s; the flash kernels run on
    TF32 tensor cores)."""
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    run = _eager_ernie_steps(paddle, None)
    run["launches"].update(_f32_option_launches(run["launches_by_dtype"]))
    tok_s, fpt, timed = (run["tokens_per_s"], run["flops_per_token"],
                         run["timed_steps"])
    res = {"phase": "eager_f32",
           "config": "ErnieConfig.ernie3_base (BASELINE config 1, "
                     "bench.py:134-181), composed from layers, f32, no "
                     "auto_cast",
           **run, "mfu_f32": tok_s * fpt / peaks[2],
           "mfu_tf32": tok_s * fpt / _TF32_PEAK,
           "gemm_precision": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "nvidia_smi": _smi_line()}
    _emit(res)
    if res["param_dtypes"] != ["float32"]:
        raise AssertionError(f"eager_f32: parameters {res['param_dtypes']}")
    _check_path("eager_f32", res, _EAGER_LAUNCHES_PER_STEP, timed)
    _check_dtype_launches("eager_f32", res["launches_by_dtype"],
                          _EAGER_LAUNCHES_PER_STEP, timed, "f32")
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
    Tensor), the counters (and their counts by dtype) zeroed between them
    and read after the timed ones, one synchronize around those: (losses,
    seconds, launches, peak device memory)."""
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    _zero_counts(counters)
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


# ------------------------------------------------------- 8a. O2 mixed precision
# the O2 runs launch what the O1 runs do, in the run's dtype: row 6 and
# the causal flash pair in the eager Llama's step, the LayerNorm pair and
# the non-causal flash pair in the eager ERNIE's
_DT_TAGS = {"bfloat16": "bf16", "float16": "f16"}


def _zero_counts(counters):
    from paddle_tpu_torch import _build
    for c in counters.values():
        _build.reset_counts(c)


def _read_counts(counters):
    """(launches, launches by dtype) of each counter."""
    from paddle_tpu_torch import _build
    return ({n: c.launches for n, c in counters.items()},
            {n: _build.launches_by_dtype(c) for n, c in counters.items()})


def _check_dtype_launches(name, by_dtype, per_step, steps, tag):
    """Every kernel of `per_step` launched exactly per_step * steps times
    in dtype `tag` and never in another."""
    for kernel, per in per_step.items():
        got = by_dtype[kernel]
        want = {t: (per * steps if t == tag else 0) for t in got}
        if got != want:
            raise AssertionError(f"{name}: {kernel} launched {got} by dtype "
                                 f"in {steps} steps, expected {want}")


def _masters(opt):
    return [st["master"] for st in opt._state.values() if "master" in st]


def _eager_llama_o2_run(paddle, cfg, dtype, peaks, batch, seq, warmup,
                        timed):
    """One O2 run of the eager Llama (see phase_eager_llama_o2)."""
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.tools.eager_llama import build_model, train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paddle.seed(SEED)
    model = build_model(paddle, cfg)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        weight_decay=paddle.regularizer.L2Decay(0.01),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model, opt = paddle.amp.decorate(model, opt, level="O2", dtype=dtype)
    scaler = (paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
              if dtype == "float16" else None)
    loss_fn = paddle.nn.CrossEntropyLoss()
    tokens = paddle.to_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scales = []

    def step():
        loss = train_step(paddle, model, loss_fn, opt, tokens,
                          amp_dtype=dtype, amp_level="O2", scaler=scaler)
        if scaler is not None:
            scales.append(scaler._scale)
        return loss

    counters = _path_counters(_EAGER_LLAMA_LAUNCHES_PER_STEP)
    losses = [float(step()) for _ in range(warmup)]
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    out = [step() for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, by_dtype = _read_counts(counters)
    losses += [float(x) for x in out]
    tok_s = batch * seq * timed / dt
    fpt = llama.flops_per_token(cfg, seq)
    res = {"dtype": dtype, "param_dtypes": sorted({
               str(p.dtype).replace("torch.", "")
               for p in model.parameters()}),
           "masters": len(_masters(opt)), "init_s": init_s,
           "step_ms": dt / timed * 1e3, "tokens_per_s": tok_s,
           "mfu": tok_s * fpt / peaks[0], "losses": losses,
           "loss_scale": scales or None,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_by_dtype": by_dtype}
    del model, opt, tokens, scaler
    torch.cuda.empty_cache()
    return res


def phase_eager_llama_o2(peaks, o1):
    """The eager Llama of phase eager_llama (flagship widths and depth,
    bench.py:120-131; batch 2 x 2048 from default_rng(0); 2 warm-up and 4
    timed steps) under O2: `paddle.amp.decorate(model, opt, level="O2")`
    casts every parameter, AdamW (lr 1e-4, the global-norm clip at 1.0,
    weight_decay=paddle.regularizer.L2Decay(0.01), decoupled) keeps f32
    master weights. Run (a) in bf16, PaddleNLP's default pretraining
    precision; run (b) in f16 with GradScaler(init_loss_scaling=2**15),
    driven as scaler.minimize(opt, scaler.scale(loss)). In each run the
    flash pair must launch exactly 11 + 11 times a step and row 6 23
    times, all in the run's dtype and none in the other; losses finite
    and falling; peak memory under 80 GB, reported against the O1
    phase's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import llama

    cfg = llama.LlamaConfig.flagship_2b()
    warmup, timed, batch, seq = 2, 4, 2, 2048
    paddle.set_device("gpu")
    runs = {}
    for dtype in ("bfloat16", "float16"):
        r = _eager_llama_o2_run(paddle, cfg, dtype, peaks, batch, seq,
                                warmup, timed)
        r["peak_memory_over_o1"] = \
            r["peak_memory_bytes"] / o1["peak_memory_bytes"]
        runs[_DT_TAGS[dtype]] = r
    res = {"phase": "eager_llama_o2",
           "config": "LlamaConfig.flagship_2b (bench.py:120-131), "
                     "composed from layers, amp.decorate O2",
           "optimizer": "AdamW lr 1e-4, ClipGradByGlobalNorm(1.0), "
                        "weight_decay=L2Decay(0.01), multi_precision",
           "batch": batch, "seq": seq, "steps": warmup + timed,
           "timed_steps": timed, "flops_per_token":
               llama.flops_per_token(cfg, seq),
           "o1_step_ms": o1["step_ms"], "runs": runs,
           "nvidia_smi": _smi_line()}
    _emit(res)
    for tag, r in runs.items():
        _check_path(f"eager_llama_o2 ({tag})", r,
                    _EAGER_LLAMA_LAUNCHES_PER_STEP, timed)
        _check_dtype_launches(f"eager_llama_o2 ({tag})",
                              r["launches_by_dtype"],
                              _EAGER_LLAMA_LAUNCHES_PER_STEP, timed, tag)
        if r["param_dtypes"] != [r["dtype"]] or not r["masters"]:
            raise AssertionError(f"eager_llama_o2 ({tag}): parameters "
                                 f"{r['param_dtypes']}, {r['masters']} "
                                 f"masters after decorate")
    return {f"eager_llama_o2_{t}": {"launches": r["launches"], "seq": seq}
            for t, r in runs.items()}


def _bits(opt, model):
    """Every parameter's and master's tensor, copied."""
    return ([p._data.detach().clone() for p in model.parameters()]
            + [m.clone() for m in _masters(opt)])


def phase_eager_o2(peaks):
    """Phase eager's recipe (ERNIE-3.0-base composed from layers, BASELINE
    config 1; dropout 0.1; AdamW lr 2e-5 with the global-norm clip at
    1.0; the same 64 x 512 batch every step) under O2 f16:
    `amp.decorate(level="O2", dtype="float16")` and
    GradScaler(init_loss_scaling=2**15), driven as
    scaler.minimize(opt, scaler.scale(loss)). 2 warm-up steps, 2 timed
    steps, the planted overflow step, 2 more timed steps. The LayerNorm
    pair must launch 25 + 25 times a timed step and the non-causal flash
    pair 12 + 12, all in f16. The control: one step's loss is multiplied
    by inf inside the step; the scaler must skip its update (every
    parameter and master bit-identical before and after it), halve the
    scale, and the steps after it must have finite losses."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model, train_step

    cfg = ernie.ErnieConfig.ernie3_base()
    warmup, batch, seq = 2, 64, 512
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paddle.seed(SEED)
    model = build_model(paddle, cfg, dropout=0.1)
    opt = paddle.optimizer.AdamW(
        learning_rate=2e-5, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="float16")
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ce = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = paddle.to_tensor(rng.integers(0, cfg.num_labels, (batch,)))
    scales = []

    def step(loss_fn=ce):
        loss = train_step(paddle, model, loss_fn, opt, ids, labels,
                          amp_dtype="float16", amp_level="O2",
                          scaler=scaler)
        scales.append(scaler._scale)
        return loss

    counters = _eager_counters()
    losses = [float(step()) for _ in range(warmup)]
    secs, timed = 0.0, 0
    launches = {n: 0 for n in counters}
    by_dtype = {n: {} for n in counters}
    planted = {}
    for part in range(2):
        torch.cuda.synchronize()
        _zero_counts(counters)
        t0 = time.perf_counter()
        out = [step() for _ in range(2)]
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        timed += 2
        losses += [float(x) for x in out]
        got, got_dt = _read_counts(counters)
        for n in counters:
            launches[n] += got[n]
            for t, c in got_dt[n].items():
                by_dtype[n][t] = by_dtype[n].get(t, 0) + c
        if part == 0:
            # the planted overflow step, between the timed ones
            before = _bits(opt, model)
            scale = scaler._scale
            bad = float(step(lambda logits, y: ce(logits, y)
                             * float("inf")))
            after = _bits(opt, model)
            planted = {"loss": bad, "scale_before": scale,
                       "scale_after": scaler._scale,
                       "skipped_bit_identical": all(
                           torch.equal(a, b) for a, b in zip(before, after)),
                       "tensors_compared": len(before)}
            del before, after
    peak = torch.cuda.max_memory_allocated()
    tok_s = batch * seq * timed / secs
    fpt = ernie.flops_per_token(cfg, seq)
    res = {"phase": "eager_o2",
           "config": "ErnieConfig.ernie3_base (BASELINE config 1, "
                     "bench.py:134-181), composed from layers, amp.decorate "
                     "O2 f16, GradScaler(2**15)",
           "batch": batch, "seq": seq, "timed_steps": timed,
           "step_ms": secs / timed * 1e3, "tokens_per_s": tok_s,
           "mfu": tok_s * fpt / peaks[0], "losses": losses,
           "loss_scale": scales, "planted_overflow": planted,
           "peak_memory_bytes": peak, "launches": launches,
           "launches_by_dtype": by_dtype, "nvidia_smi": _smi_line()}
    _emit(res)
    del model, opt, ids, labels, scaler
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"eager_o2: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"eager_o2: the loss did not fall: {losses}")
    if np.isfinite(planted["loss"]) or not planted["skipped_bit_identical"]:
        raise AssertionError(f"eager_o2: the overflow step was not skipped "
                             f"bit for bit: {planted}")
    if planted["scale_after"] != planted["scale_before"] / 2:
        raise AssertionError(f"eager_o2: the scale went "
                             f"{planted['scale_before']} -> "
                             f"{planted['scale_after']} on the overflow step,"
                             f" not halved")
    for name, per in _EAGER_LAUNCHES_PER_STEP.items():
        if launches[name] != per * timed:
            raise AssertionError(
                f"eager_o2: {name}: {launches[name]} launches in {timed} "
                f"steps, expected {per} a step")
    _check_dtype_launches("eager_o2", by_dtype, _EAGER_LAUNCHES_PER_STEP,
                          timed, "f16")
    return {"launches": launches, "seq": seq}


# the loss scale of the f16 gradient check: GradScaler's initial 2**15,
# so the f16 backward sees the gradients at the size O2 training gives it
GRAD_F16_LOSS_SCALE = 2.0 ** 15


def phase_grad_check_eager_llama_f16():
    """phase_grad_check_eager_llama under O2 f16: the eager Llama at the
    flagship widths, 2 layers, batch 1 x 2048, its parameters cast to f16
    by amp.decorate (the norm gains drawn 1 + 0.1 N(0, 1) first). One
    loss (times 2**15, as GradScaler scales it) + backward under
    auto_cast O2 f16 through the kernels, their plain versions and the
    plain versions with the rms_w fault; the f32 evaluation runs the same
    f16-rounded weights cast to f32 (no auto_cast, plain versions). Each
    gradient group's distance from f32 (gradients divided by the scale in
    f32): the kernels must be within 1.5x the plain f16 path's, the fault
    above it."""
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
    model = paddle.amp.decorate(model, level="O2", dtype="float16")
    loss_fn = paddle.nn.CrossEntropyLoss()
    tokens = paddle.to_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (batch, seq)))
    last = {}
    hook = model.layers[len(model.layers) - 1].register_forward_post_hook(
        lambda layer, inputs, out: last.__setitem__("out", out))
    s = GRAD_F16_LOSS_SCALE

    def run(amp):
        with paddle.amp.auto_cast(enable=amp, level="O2", dtype="float16"):
            loss = lm_loss(loss_fn, model(tokens), tokens)
        (loss * (s if amp else 1.0)).backward()
        g = {n: p.grad._data.float() / (s if amp else 1.0)
             for n, p in model.named_parameters()}
        model.clear_gradients()
        return (float(loss), last.pop("out")._data.detach().float()
                .reshape(-1), g)

    res = {"kernel": run(True)}
    with _plain_kernels():
        res["ref"] = run(True)
    with _plain_kernels(fault="rms_w"):
        res["fault"] = run(True)
    model.float()
    with _plain_kernels():
        res["f32"] = run(False)
    hook.remove()
    groups: dict = {}
    for n, _ in model.named_parameters():
        groups.setdefault(_eager_llama_group(n), []).append(n)
    del model
    finite = all(bool(torch.isfinite(x).all()) for r in res.values()
                 for x in r[2].values())
    fault_groups = ("last_layer_out", *groups)
    out = _grad_ratios(res, groups, first="last_layer_out")
    _emit({"phase": "grad_check_eager_llama_f16", "layers": layers,
           "batch": batch, "seq": seq, "loss_scale": s,
           "ratio_tol": GRAD_VS_F32_RATIO, "fault_groups": fault_groups,
           "finite": finite, **out})
    del res
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("grad_check_eager_llama_f16: a gradient is "
                             "not finite")
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
    `tools/bench.py`'s protocol; then the checks. Returns the result
    and the tree, as {"params": ...}, for phase_predict."""
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
    # phase_predict serves the same tree
    tree = {"params": params}
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
    return res, tree


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


# ------------------------------- 14. predict (inference.create_predictor)
PRED_BATCH, PRED_PROMPT, PRED_NEW = 8, 512, 128
PRED_BLOCK = 64


def _predict_prompts(vocab):
    """The dense run's 8 prompts of 512 tokens, and the paged run's 8
    right-padded prompts of 128-512 tokens (pad 0; the longest 512)."""
    rng = np.random.default_rng(SEED)
    dense = rng.integers(1, vocab, (PRED_BATCH, PRED_PROMPT)).astype(np.int32)
    lengths = rng.integers(128, PRED_PROMPT + 1, PRED_BATCH)
    lengths[0] = PRED_PROMPT
    padded = rng.integers(1, vocab, (PRED_BATCH, PRED_PROMPT)).astype(
        np.int32)
    padded[np.arange(PRED_PROMPT)[None] >= lengths[:, None]] = 0
    return dense, padded, lengths


def phase_predict(peaks, tree):
    """`inference.create_predictor` serving an LLM at the flagship 2B
    widths (bench.py:120): phase_generate's tree of random bf16 weights
    (taken out of `tree`, so that it is freed once written) is written
    with `save_llm` into a temporary directory and each predictor loads
    it. Three configs, each run twice (the second run timed): the
    dense greedy run (8 prompts of 512, 128 new tokens: the flash prefill,
    row 1, then the decode step replayed from one CUDA graph), the paged
    run (8 right-padded prompts of 128-512, block 64: row 1's prefill and
    row 18's ragged paged attention each decode step) and
    `enable_weight_only("int8")`'s dense run. Every run's tokens must
    equal those of `generation.generate` / `paged_generate` called
    directly on the tree in memory (and on its int8 quantization); counts
    are zeroed before each predictor run and read after it: row 1 exactly
    L a prefill, row 18 at least once in a paged run and never in a dense
    one."""
    import os
    import tempfile
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference import llm
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.nlp import generation, llama, paged
    from paddle_tpu_torch.nlp.ragged_attention import ragged_paged_attention
    cfg = llama.LlamaConfig.flagship_2b(
        max_position_embeddings=PRED_PROMPT + PRED_NEW)
    L = cfg.num_hidden_layers
    params = tree.pop("params")
    dense, padded, lengths = _predict_prompts(cfg.vocab_size)
    # the references: the same tree through the generation entry points
    want = {"dense": generation.generate(params, dense, cfg,
                                         max_new_tokens=PRED_NEW),
            "paged": paged.paged_generate(params, padded, lengths, cfg,
                                          max_new_tokens=PRED_NEW,
                                          block_size=PRED_BLOCK)[0]}
    w8 = generation.quantize_for_serving(params, bits=8)
    want["int8"] = generation.generate(w8, dense, cfg,
                                       max_new_tokens=PRED_NEW)
    del w8
    want = {k: v.cpu().numpy() for k, v in want.items()}
    counters = {"flash_attention_fwd": flash_attention_fwd,
                "ragged_paged_attention": ragged_paged_attention}
    totals = {n: 0 for n in counters}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "flagship_2b")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.save_llm(prefix, params, cfg)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(prefix + llm.LLM_SUFFIX)
        del params
        torch.cuda.empty_cache()
        for name, ids in (("dense", dense), ("paged", padded),
                          ("int8", dense)):
            c = inference.Config(prefix)
            c.enable_llm_generation(max_new_tokens=PRED_NEW)
            if name == "int8":
                c.enable_weight_only("int8")
            if name == "paged":
                c.enable_paged_kv(block_size=PRED_BLOCK)
            t0 = time.perf_counter()
            pred = inference.create_predictor(c)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            outs, walls, launches = [], [], []
            for _ in range(2):
                for ctr in counters.values():
                    ctr.launches = 0
                pred.get_input_handle("input_ids").copy_from_cpu(ids)
                t0 = time.perf_counter()
                pred.run()
                walls.append(time.perf_counter() - t0)
                launches.append({n: ctr.launches
                                 for n, ctr in counters.items()})
                outs.append(pred.get_output_handle(
                    "generated_ids").copy_to_cpu())
            for la in launches:
                for n, v in la.items():
                    totals[n] += v
            runs[name] = {
                "load_s": load_s, "first_run_s": walls[0],
                "run_s": walls[1],
                "tokens_per_s": PRED_BATCH * PRED_NEW / walls[1],
                "launches_per_run": launches,
                "tokens_equal_direct": all(
                    np.array_equal(o, want[name]) for o in outs),
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if name == "paged":
                runs[name]["allocator"] = pred._paged_stats
                runs[name]["prompt_lengths"] = lengths.tolist()
            del pred
            torch.cuda.empty_cache()
    res = {"phase": "predict",
           "config": "flagship_2b (bench.py:120) through "
                     "inference.create_predictor",
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": L, "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size},
           "batch": PRED_BATCH, "prompt": PRED_PROMPT, "new": PRED_NEW,
           "block_size": PRED_BLOCK, "write_s": write_s,
           "file_bytes": file_bytes, "runs": runs, "launches": totals,
           "nvidia_smi": _smi_line()}
    _emit(res)
    for name, r in runs.items():
        if not r["tokens_equal_direct"]:
            raise AssertionError(f"predict {name}: the predictor's tokens "
                                 f"differ from the direct call's")
        for la in r["launches_per_run"]:
            if la["flash_attention_fwd"] != L:
                raise AssertionError(f"predict {name}: {la} launches, "
                                     f"expected {L} flash a prefill")
            ragged = la["ragged_paged_attention"]
            if (name == "paged") != (ragged >= 1):
                raise AssertionError(f"predict {name}: {ragged} ragged "
                                     f"launches")
    return res


# ------------------------------------ 15. resnet50 (BASELINE config 0)
RESNET_BATCH, RESNET_SIZE = 256, 224
# the loader-fed epoch: 4 batches for each worker, so that each builds
# batches after its first and the steady state shows past start-up
RESNET_LOADER_WORKERS = 8
RESNET_LOADER_IMAGES = 4 * RESNET_LOADER_WORKERS * RESNET_BATCH
# the ResNet gradient check: the card's resnet18 forward and one Momentum
# step against the port's CPU run, relative to the logits' and the
# step's largest magnitudes (tests/test_torch_vision.py's tolerances)
RESNET_LOGITS_TOL = 1e-4
RESNET_STEP_TOL = 1e-4


def _bn_state(model):
    return [b._data.clone() for _, b in model.named_buffers()]


def _resnet_device_fed(paddle, rt, amp, warmup=2, timed=4):
    """A fresh resnet50 (seeded) trained on one batch already on the
    card: `warmup` then `timed` steps, one synchronize after the timed
    ones."""
    paddle.seed(SEED)
    model, opt, sched = rt.build(paddle, 50, batch=RESNET_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = paddle.to_tensor(torch.randn(RESNET_BATCH, 3, RESNET_SIZE,
                                     RESNET_SIZE, device="cuda",
                                     generator=gen))
    y = paddle.to_tensor(torch.randint(0, 1000, (RESNET_BATCH,),
                                       device="cuda", generator=gen))
    bn0 = _bn_state(model)
    torch.cuda.reset_peak_memory_stats()
    losses = [rt.train_step(paddle, model, opt, sched, x, y, amp)
              for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(rt.train_step(paddle, model, opt, sched, x, y, amp))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = max(float((a - b).abs().max()) for a, b in
                zip(_bn_state(model), bn0))
    return model, opt, sched, {
        "steps": warmup + timed, "timed_steps": timed,
        "step_ms": dt / timed * 1e3, "images_per_s": RESNET_BATCH * timed / dt,
        "losses": [float(v) for v in losses],
        "bn_stats_max_move": moved,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _resnet_loader_fed(paddle, rt, model, opt, sched, amp, loader):
    """The same model fed by `loader` (`rt.image_pipeline`) for one
    epoch. Start-up is the time from `iter()` (which forks the workers)
    to the first batch. The steady window runs from the arrival of the
    last batch of the first round (one batch a worker) to the arrival of
    the epoch's last batch: its images/s and the share of it the host
    spent blocked in the loader's __next__ (the wait share) are the
    loader's steady state; the epoch's wall time covers both."""
    from paddle_tpu_torch.io import dataloader as dl_mod
    workers = loader.num_workers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = iter(loader)
    ring = isinstance(it, dl_mod._MultiProcessIter) and it.ring is not None
    waits, arrivals, losses = [], [], []
    while True:
        w0 = time.perf_counter()
        try:
            x, y = next(it)
        except StopIteration:
            break
        arrivals.append(time.perf_counter())
        waits.append(arrivals[-1] - w0)
        losses.append(rt.train_step(paddle, model, opt, sched, x, y, amp))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k0 = workers - 1
    steady_s = arrivals[-1] - arrivals[k0]
    steady_batches = len(arrivals) - 1 - k0
    return {"steps": len(losses), "workers": workers,
            "images": len(loader.dataset), "wall_s": wall,
            "images_per_s": len(loader.dataset) / wall,
            "startup_s": arrivals[0] - t0,
            "steady_batches": steady_batches, "steady_s": steady_s,
            "steady_images_per_s": steady_batches * loader.batch_size
            / steady_s,
            "steady_step_ms": steady_s / steady_batches * 1e3,
            "steady_loader_wait_share": sum(waits[k0 + 1:]) / steady_s,
            "loader_wait_s": sum(waits), "loader_wait_share":
            sum(waits) / wall, "shm_ring": ring,
            "losses": [float(v) for v in losses]}


def phase_resnet50(peaks):
    """BASELINE config 0: the eager `resnet50(num_classes=1000)` at
    224x224, batch 256, by He et al. 2016 §3.4's recipe
    (`tools/resnet_train.py`: Momentum 0.9, weight decay 1e-4,
    PiecewiseDecay from 0.1), in f32 (TF32 convolutions and products, as
    cuDNN runs them by default; off again after this phase) and under
    `amp.auto_cast(level="O1", dtype="bfloat16")`. Device-fed: one seeded
    batch already on the card, 2 warm-up and 4 timed steps. Loader-fed:
    one epoch of `image_pipeline`'s RESNET_LOADER_IMAGES images, 4
    batches for each of its 8 workers, made once for both runs. MFU counts 3 x 2 x the
    forward's convolution and classifier MACs an image (`forward_macs`)
    against the card's TF32 or bf16 peak. Fails unless every loss is
    finite, the device-fed losses fall and the BatchNorm running
    statistics moved."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import shm_ring
    from paddle_tpu_torch.tools import resnet_train as rt
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    macs = rt.forward_macs(paddle, rt.build(paddle, 50)[0], RESNET_SIZE)
    flops_per_image = 3 * 2 * macs
    t0 = time.perf_counter()
    loader = rt.image_pipeline(paddle, n=RESNET_LOADER_IMAGES,
                               hw=(256, 320), batch=RESNET_BATCH,
                               workers=RESNET_LOADER_WORKERS,
                               size=RESNET_SIZE, seed=SEED)
    res = {"phase": "resnet50",
           "config": "resnet50 (BASELINE config 0), 224x224, batch 256, "
                     "He et al. 2016 §3.4",
           "forward_macs": macs, "flops_per_image": flops_per_image,
           "loader_images": RESNET_LOADER_IMAGES,
           "loader_setup_s": time.perf_counter() - t0,
           "shm_ring_native": shm_ring.native_available(), "runs": {}}
    for name, amp, peak in (("f32_tf32", None, _TF32_PEAK),
                            ("o1_bf16", "bfloat16", peaks[0])):
        tf32 = amp is None
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            model, opt, sched, dev = _resnet_device_fed(paddle, rt, amp)
            dev["mfu"] = dev["images_per_s"] * flops_per_image / peak
            fed = _resnet_loader_fed(paddle, rt, model, opt, sched, amp,
                                     loader)
            fed["mfu"] = fed["images_per_s"] * flops_per_image / peak
            fed["steady_mfu"] = fed["steady_images_per_s"] * \
                flops_per_image / peak
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        res["runs"][name] = {"device_fed": dev, "loader_fed": fed,
                             "peak_flops": peak}
        del model, opt, sched
        torch.cuda.empty_cache()
    res["nvidia_smi"] = _smi_line()
    _emit(res)
    if not res["shm_ring_native"]:
        raise AssertionError("the DataLoader's native shm ring did not build")
    for name, r in res["runs"].items():
        dev = r["device_fed"]
        losses = dev["losses"] + r["loader_fed"]["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"resnet50 {name}: non-finite loss {losses}")
        if not dev["losses"][-1] < dev["losses"][0]:
            raise AssertionError(f"resnet50 {name}: the loss did not fall: "
                                 f"{dev['losses']}")
        if not dev["bn_stats_max_move"] > 0:
            raise AssertionError(f"resnet50 {name}: the BatchNorm running "
                                 f"statistics did not move")
        if not r["loader_fed"]["shm_ring"]:
            raise AssertionError(f"resnet50 {name}: the loader did not use "
                                 f"the shared-memory ring")
    return res


def _resnet18_run(paddle, state, x, y, device, bn_momentum=0.9,
                  nesterov=False):
    """resnet18 from `state` (numpy) on `device`: one training forward,
    the loss, its backward and one Momentum step → (logits, loss, the
    parameters and running statistics after the step), as numpy."""
    paddle.set_device(device)
    model = paddle.vision.models.resnet18(num_classes=1000)
    model.set_state_dict(state)
    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.BatchNorm2D):
            layer._momentum = bn_momentum
    opt = paddle.optimizer.Momentum(0.1, momentum=0.9, weight_decay=1e-4,
                                    use_nesterov=nesterov,
                                    parameters=model.parameters())
    logits = model(paddle.to_tensor(x))
    loss = paddle.nn.functional.cross_entropy(logits, paddle.to_tensor(y))
    loss.backward()
    opt.step()
    out = (logits.numpy(), float(loss),
           {k: v.numpy().copy() for k, v in model.state_dict().items()})
    paddle.set_device("gpu")
    return out


def phase_grad_check_resnet():
    """resnet18's training forward and one Momentum step (lr 0.1,
    momentum 0.9, weight decay 1e-4) on the card against the port's CPU
    run from the same weights, 2 x 3 x 64 x 64 f32, with TF32 off for
    the check (set here, restored after it): the logits within
    RESNET_LOGITS_TOL of their largest magnitude; after the step, every
    parameter within RESNET_STEP_TOL of the parameters' largest move and
    every BatchNorm running statistic within it of the statistics'
    largest move. Two planted faults must each read above the bound on
    the part it moves: the card's BatchNorm given torch's momentum
    convention (0.1 where Paddle's 0.9 means it) on the statistics, and
    the Nesterov update in place of the plain one on the parameters."""
    import paddle_tpu_torch as paddle
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        paddle.set_device("cpu")
        paddle.seed(SEED)
        model = paddle.vision.models.resnet18(num_classes=1000)
        state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        stats = {k for k, _ in model.named_buffers()}
        rng = np.random.default_rng(SEED)
        x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
        y = rng.integers(0, 1000, (2,))
        cpu = _resnet18_run(paddle, state, x, y, "cpu")
        card = _resnet18_run(paddle, state, x, y, "gpu")
        bn_fault = _resnet18_run(paddle, state, x, y, "gpu",
                                 bn_momentum=0.1)
        step_fault = _resnet18_run(paddle, state, x, y, "gpu",
                                   nesterov=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags

    def step_err(run, keys):
        moves = max(float(np.abs(cpu[2][k] - state[k]).max()) for k in keys)
        return max(float(np.abs(run[2][k] - cpu[2][k]).max())
                   for k in keys) / moves

    params = [k for k in state if k not in stats]
    logits_err = float(np.abs(card[0] - cpu[0]).max()) / \
        float(np.abs(cpu[0]).max())
    res = {"phase": "grad_check_resnet", "model": "resnet18",
           "input": [2, 3, 64, 64], "logits_rel_err": logits_err,
           "loss_cpu": cpu[1], "loss_card": card[1],
           "param_step_rel_err": step_err(card, params),
           "stats_step_rel_err": step_err(card, stats),
           "bn_fault_stats_step_rel_err": step_err(bn_fault, stats),
           "nesterov_fault_param_step_rel_err": step_err(step_fault, params),
           "logits_tol": RESNET_LOGITS_TOL, "step_tol": RESNET_STEP_TOL,
           "nvidia_smi": _smi_line()}
    _emit(res)
    if not logits_err <= RESNET_LOGITS_TOL:
        raise AssertionError(f"resnet18 logits: {res}")
    if not (res["param_step_rel_err"] <= RESNET_STEP_TOL
            and res["stats_step_rel_err"] <= RESNET_STEP_TOL):
        raise AssertionError(f"resnet18 Momentum step: {res}")
    if not (res["bn_fault_stats_step_rel_err"] > RESNET_STEP_TOL
            and res["nesterov_fault_param_step_rel_err"] > RESNET_STEP_TOL):
        raise AssertionError(f"resnet18: a planted fault reads within "
                             f"the bound: {res}")
    return res


# ------------------------------------------------------------- 16. beam
BEAM_SCORE_TOL = 1e-4


def phase_beam():
    """`nn.BeamSearchDecoder` over an `nn.LSTMCell` (hidden 512, an
    Embedding and an output Linear over a vocabulary of 8000; seeded
    weights and initial states), batch 32, beam 4, 32 steps through
    `nn.dynamic_decode` on the card. The best beam's score must equal the
    teacher-forced sum of the cell's log-probabilities along that beam
    (to its first end token), within BEAM_SCORE_TOL relative."""
    import paddle_tpu_torch as paddle
    B, K, V, Hd, T, end = 32, 4, 8000, 512, 32, 1
    paddle.set_device("gpu")
    paddle.seed(SEED)
    cell = paddle.nn.LSTMCell(Hd, Hd)
    emb = paddle.nn.Embedding(V, Hd)
    proj = paddle.nn.Linear(Hd, V)
    rng = np.random.default_rng(SEED)
    h0 = rng.standard_normal((B, Hd)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((B, Hd)).astype(np.float32) * 0.5
    dec = paddle.nn.BeamSearchDecoder(cell, start_token=0, end_token=end,
                                      beam_size=K, embedding_fn=emb,
                                      output_fn=proj)
    t0 = time.perf_counter()
    with paddle.no_grad():
        out, states, lengths = paddle.nn.dynamic_decode(
            dec, inits=(paddle.to_tensor(h0), paddle.to_tensor(c0)),
            max_step_num=T, return_length=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    beams = out.numpy()                          # [B, steps, K]
    best = beams[:, :, 0]
    scores = states[1].numpy()[:, 0]
    # teacher forcing along the best beam, stopping after its first end
    with paddle.no_grad():
        st = (paddle.to_tensor(h0), paddle.to_tensor(c0))
        tok = np.zeros(B, np.int64)
        total = np.zeros(B, np.float64)
        done = np.zeros(B, bool)
        for t in range(best.shape[1]):
            h, st = cell(emb(paddle.to_tensor(tok)), st)
            logp = paddle.nn.functional.log_softmax(proj(h), axis=-1).numpy()
            total += np.where(done, 0.0, logp[np.arange(B), best[:, t]])
            done |= best[:, t] == end
            tok = best[:, t].astype(np.int64)
    err = float(np.max(np.abs(total - scores) / np.abs(total)))
    res = {"phase": "beam", "cell": "LSTMCell", "hidden": Hd, "vocab": V,
           "batch": B, "beam": K, "max_steps": T, "steps": best.shape[1],
           "decode_s": decode_s, "score_rel_err": err,
           "score_tol": BEAM_SCORE_TOL,
           "mean_best_score": float(scores.mean()),
           "finished": int((lengths.numpy()[:, 0] < best.shape[1]).sum()),
           "nvidia_smi": _smi_line()}
    _emit(res)
    if beams.shape[0] != B or beams.shape[2] != K or beams.shape[1] > T:
        raise AssertionError(f"beam output shape {beams.shape}")
    if not err <= BEAM_SCORE_TOL:
        raise AssertionError(f"beam scores: {res}")
    return res


# ------------------------------------------------- 17. eager optimizers
# the nine per-step optimizers of the eager optimizer phase, at learning
# rates of their use on a finetune (Adadelta at its customary 1.0; RAdam
# at its paper's 1e-3: its first steps are the unnormalized lr · m̂,
# which at 2e-5 moves no bit of a LayerNorm weight near 1), each behind
# the recipe's global-norm clip
_EAGER_OPTIMIZERS = {
    "Adagrad": lambda o, ps, clip: o.Adagrad(1e-3, parameters=ps,
                                             grad_clip=clip),
    "RMSProp": lambda o, ps, clip: o.RMSProp(
        1e-4, momentum=0.9, centered=True, parameters=ps, grad_clip=clip),
    "Adamax": lambda o, ps, clip: o.Adamax(2e-5, parameters=ps,
                                           grad_clip=clip),
    "Lamb": lambda o, ps, clip: o.Lamb(2e-5, lamb_weight_decay=0.01,
                                       parameters=ps, grad_clip=clip),
    "Adadelta": lambda o, ps, clip: o.Adadelta(1.0, parameters=ps,
                                               grad_clip=clip),
    "Rprop": lambda o, ps, clip: o.Rprop(1e-5, parameters=ps,
                                         grad_clip=clip),
    "ASGD": lambda o, ps, clip: o.ASGD(1e-3, batch_num=2, parameters=ps,
                                       grad_clip=clip),
    "NAdam": lambda o, ps, clip: o.NAdam(2e-5, parameters=ps,
                                         grad_clip=clip),
    "RAdam": lambda o, ps, clip: o.RAdam(1e-3, parameters=ps,
                                         grad_clip=clip),
}
# the O2 f16 Lamb run (BERT's LAMB pretraining recipe: f16 with a dynamic
# loss scale) on the repeated batch: at 1e-3 every tensor moves by 0.1 %
# of its norm a step and the loss rose (PERF.md §6); at 1e-4 it falls
LAMB_O2_LR = 1e-4


def _no_sync_step(opt):
    """opt.step under torch.cuda.set_sync_debug_mode("error"): any device
    read on the host (an item(), a D2H copy, a synchronize) inside the
    step raises."""
    step = opt.step

    def checked(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    opt.step = checked
    return opt


def _restore(params, init):
    with torch.no_grad():
        for p, v in zip(params, init):
            p._data.copy_(v)


def _optimizer_device_ms(step):
    """One step traced by torch.profiler, with the eager spans: the
    device ms of the kernels that start inside its eager_optimizer span
    (the optimizer's step and clear_grad)."""
    from paddle_tpu_torch.tools.profile_train import _device_times
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss = step(torch.profiler.record_function)
        torch.cuda.synchronize()
    _, _, ranges = _device_times(prof, ("eager_optimizer",))
    return float(loss), ranges["eager_optimizer"]["device_ms"]


def _lbfgs_probe(paddle, model, ids, labels):
    """An LBFGS linear probe, [64, 768] -> 2 classes, on the encoder's
    pooled features (tanh of the pooler on token 0, under O1 bf16, in
    eval mode), full batch, max_iter 20 in one step(closure): the losses
    the closure saw."""
    F = paddle.nn.functional
    model.eval()
    with paddle.no_grad(), paddle.amp.auto_cast(dtype="bfloat16"):
        x = model.embeddings(ids)
        for layer in model.layers:
            x = layer(x)
        feats = F.tanh(model.pooler(x[:, 0])).astype("float32")
    model.train()
    paddle.seed(SEED + 9)
    probe = paddle.nn.Linear(feats.shape[1], 2)
    opt = paddle.optimizer.LBFGS(learning_rate=1.0, max_iter=20,
                                 parameters=probe.parameters())
    ce = paddle.nn.CrossEntropyLoss()
    losses = []

    def closure():
        opt.clear_grad()
        loss = ce(probe(feats), labels)
        loss.backward()
        losses.append(float(loss))
        return loss

    opt.step(closure)
    return list(feats.shape), losses


def phase_eager_optim(peaks):
    """Phase eager's recipe (ERNIE-3.0-base composed from layers, BASELINE
    config 1, 64 x 512, O1 bf16 over f32 parameters, dropout 0.1, the
    global-norm clip at 1.0, the same batch every step) under each of the
    nine per-step optimizers of the eager API's second half, from the
    same initial weights: 1 warm-up and 2 timed steps, each optimizer
    step under CUDA's sync debug mode at "error" (no device value read
    on the host), then one step traced for the device ms of its
    eager_optimizer span. The LayerNorm pair must launch exactly 25 + 25
    times a timed step and the flash pair 12 + 12; losses finite; every
    parameter moved by the first step. Then an LBFGS linear probe on the pooled features
    (its loss must fall), then Lamb under amp.decorate(level="O2",
    dtype="float16") with GradScaler(2**15), as BERT's LAMB pretraining
    runs: 1 warm-up and 4 timed steps, every launch in f16, the
    parameters f16 with f32 masters, the losses falling."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model, train_step

    cfg = ernie.ErnieConfig.ernie3_base()
    batch, seq, timed = 64, 512, 2
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paddle.seed(SEED)
    model = build_model(paddle, cfg, dropout=0.1)
    params = model.parameters()
    init = [p._data.detach().clone() for p in params]
    ce = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = paddle.to_tensor(rng.integers(0, cfg.num_labels, (batch,)))
    counters = _eager_counters()
    runs, failures = {}, []
    for name, make in _EAGER_OPTIMIZERS.items():
        _restore(params, init)
        opt = _no_sync_step(make(paddle.optimizer, params,
                                 paddle.nn.ClipGradByGlobalNorm(1.0)))

        def step(span=None, opt=opt):
            return train_step(paddle, model, ce, opt, ids, labels,
                              amp_dtype="bfloat16", span=span)

        losses = [float(step())]                # the warm-up step
        # after one step every parameter has taken an update (later steps
        # may take an element back: Rprop's sign flips)
        moved = torch.stack([(p._data != v).any()
                             for p, v in zip(params, init)])
        timed_losses, dt, launches, _ = _run_steps(step, counters, 0, timed)
        losses += timed_losses
        loss, opt_ms = _optimizer_device_ms(step)
        runs[name] = {"step_ms": dt / timed * 1e3,
                      "optimizer_device_ms": opt_ms,
                      "losses": losses + [loss], "launches": launches,
                      "params_not_moved": int((~moved).sum()),
                      "state_keys": sorted(next(iter(
                          opt._state.values())))}
        del opt
        torch.cuda.empty_cache()
        r = runs[name]
        if not all(np.isfinite(r["losses"])):
            failures.append(f"{name}: non-finite loss {r['losses']}")
        if r["params_not_moved"]:
            failures.append(f"{name}: {r['params_not_moved']} parameters "
                            f"did not move")
        for kernel, per in _EAGER_LAUNCHES_PER_STEP.items():
            if launches[kernel] != per * timed:
                failures.append(f"{name}: {kernel} launched "
                                f"{launches[kernel]} times in {timed} "
                                f"steps, expected {per} a step")
    _restore(params, init)
    probe_shape, probe_losses = _lbfgs_probe(paddle, model, ids, labels)
    if not (np.isfinite(probe_losses).all()
            and probe_losses[-1] < probe_losses[0]):
        failures.append(f"LBFGS probe: the loss did not fall: "
                        f"{probe_losses}")
    # Lamb under O2 f16 with a dynamic loss scale
    opt = paddle.optimizer.Lamb(LAMB_O2_LR, lamb_weight_decay=0.01,
                                parameters=params,
                                grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="float16")
    _no_sync_step(opt)
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    losses, dt, launches, peak = _run_steps(
        lambda: train_step(paddle, model, ce, opt, ids, labels,
                           amp_dtype="float16", amp_level="O2",
                           scaler=scaler), counters, 1, 4)
    by_dtype = _read_counts(counters)[1]
    masters = _masters(opt)
    lamb_o2 = {"lr": LAMB_O2_LR, "step_ms": dt / 4 * 1e3, "losses": losses,
               "loss_scale": scaler._scale, "launches_by_dtype": by_dtype,
               "param_dtypes": sorted({str(p.dtype).replace("torch.", "")
                                       for p in model.parameters()}),
               "masters": len(masters),
               "master_dtypes": sorted({str(m.dtype).replace("torch.", "")
                                        for m in masters}),
               "peak_memory_bytes": peak}
    res = {"phase": "eager_optim",
           "config": "ErnieConfig.ernie3_base (BASELINE config 1, "
                     "bench.py:134-181), composed from layers, O1 bf16",
           "batch": batch, "seq": seq, "timed_steps": timed,
           "optimizers": runs,
           "lbfgs_probe": {"features": probe_shape, "max_iter": 20,
                           "losses": probe_losses},
           "lamb_o2_f16": lamb_o2, "nvidia_smi": _smi_line()}
    _emit(res)
    del model, opt, scaler, init, ids, labels
    torch.cuda.empty_cache()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        failures.append(f"Lamb O2 f16: the loss did not fall: {losses}")
    if lamb_o2["param_dtypes"] != ["float16"] or \
            lamb_o2["master_dtypes"] != ["float32"] or \
            lamb_o2["masters"] != len(params):
        failures.append(f"Lamb O2 f16: parameters {lamb_o2['param_dtypes']}"
                        f", {lamb_o2['masters']} masters "
                        f"{lamb_o2['master_dtypes']}")
    try:
        _check_dtype_launches("eager_optim Lamb O2", by_dtype,
                              _EAGER_LAUNCHES_PER_STEP, 4, "f16")
    except AssertionError as e:
        failures.append(str(e))
    if failures:
        raise AssertionError("eager_optim: " + "; ".join(failures))
    return res


# one optimizer step of each of the ten on the card against the port's
# CPU run from the same parameters and gradients, relative to the largest
# move of what is compared. Both run the same f32 operations in the same
# order element by element; they part where the card's square root or
# its foreach division by a Python scalar (a product with the
# reciprocal) rounds an ulp off the CPU's, where a reduction sums in
# another order (Lamb's norms, in f64 on both; LBFGS's dot products) or
# pow rounds differently (NAdam's and RAdam's schedules): a few ulps of
# a step, and one ulp of a step can flip the rounding of value - step by
# one ulp of the value: ~1e-7 of values near 1 against moves of 1e-2 or
# more
OPTIM_STEP_TOL = 1e-5
# learning rates that move the parameters far beyond their own ulps
_CHECK_OPTIMIZERS = {
    "Adagrad": lambda o, ps: o.Adagrad(0.1, parameters=ps,
                                       weight_decay=0.01),
    "RMSProp": lambda o, ps: o.RMSProp(0.01, momentum=0.9, centered=True,
                                       parameters=ps, weight_decay=0.01),
    "Adamax": lambda o, ps: o.Adamax(0.1, parameters=ps, weight_decay=0.01),
    "Lamb": lambda o, ps: o.Lamb(0.1, lamb_weight_decay=0.01,
                                 parameters=ps),
    "Adadelta": lambda o, ps: o.Adadelta(1.0, parameters=ps,
                                         weight_decay=0.01),
    "Rprop": lambda o, ps: o.Rprop(0.01, parameters=ps),
    "ASGD": lambda o, ps: o.ASGD(0.1, batch_num=2, parameters=ps,
                                 weight_decay=0.01),
    "NAdam": lambda o, ps: o.NAdam(0.1, parameters=ps, weight_decay=0.01),
    "RAdam": lambda o, ps: o.RAdam(0.1, parameters=ps, weight_decay=0.01),
    "LBFGS": lambda o, ps: o.LBFGS(1.0, max_iter=3, parameters=ps),
}


def _planted_optimizers(paddle):
    """The planted faults: Lamb with its trust ratio forced to 1, RMSProp
    centered without the mean-gradient term, RAdam rectified at every t
    (at t = 1 it takes the plain momentum step)."""
    o = paddle.optimizer

    class LambTrustOne(o.Lamb):
        @staticmethod
        def _trust(w_norms, r_norms):
            return torch.ones(len(w_norms), device=w_norms[0].device)

    class RMSPropUncentered(o.RMSProp):
        def _steps(self, *args):
            self._centered = False
            try:
                return super()._steps(*args)
            finally:
                self._centered = True

    class RAdamAlwaysRectified(o.RAdam):
        @staticmethod
        def _rectified(rho_t):
            return torch.ones_like(rho_t, dtype=torch.bool)

    return {"Lamb": lambda ps: LambTrustOne(
                0.1, lamb_weight_decay=0.01, parameters=ps),
            "RMSProp": lambda ps: RMSPropUncentered(
                0.01, momentum=0.9, centered=True, parameters=ps,
                weight_decay=0.01),
            "RAdam": lambda ps: RAdamAlwaysRectified(
                0.1, parameters=ps, weight_decay=0.01)}


def _optim_run(paddle, device, values, grads, make):
    """Parameters made from `values` on `device`, their `.grad` from
    `grads` (LBFGS: a closure whose loss Σ p·g + 0.005 Σ p² has the
    gradients g + 0.01 p), one step of make(parameters) → (the
    parameters after it, {state key: [each parameter's state after it]},
    {state key: [each parameter's initial state]}), as numpy."""
    paddle.set_device(device)
    params = [paddle.Parameter(v, name=f"p{i}")
              for i, v in enumerate(values)]
    opt = make(params)
    start = {}
    if isinstance(opt, paddle.optimizer.LBFGS):
        gs = [paddle.to_tensor(g) for g in grads]

        def closure():
            opt.clear_grad()
            loss = None
            for p, g in zip(params, gs):
                term = (p * g).sum() + (p * p).sum() * 0.005
                loss = term if loss is None else loss + term
            loss.backward()
            return loss

        opt.step(closure)
    else:
        for p, g in zip(params, grads):
            p.grad = paddle.to_tensor(g)
            for k, v in opt._init_state(p).items():
                start.setdefault(k, []).append(v.cpu().numpy())
        opt.step()
    states = {}
    for p in params:
        for k, v in opt._state.get(id(p), {}).items():
            states.setdefault(k, []).append(v.cpu().numpy())
    out = ([p.numpy() for p in params], states, start)
    paddle.set_device("gpu")
    return out


def _rel_to_move(got, want, start):
    """max |got - want| over the max |want - start|, both over every
    tensor of the lists."""
    move = max(float(np.abs(w.astype(np.float64) - s).max())
               for w, s in zip(want, start))
    err = max(float(np.abs(g.astype(np.float64) - w).max())
              for g, w in zip(got, want))
    return err / move if move else (0.0 if err == 0 else float("inf"))


def phase_grad_check_optim():
    """One batch's real gradients of the eager ERNIE cut to 2 layers at
    full width (dropout 0, O1 bf16, batch 4 x 512), then one step of each
    of the ten optimizers of the eager API's second half on the card
    against the port's CPU run from the same f32 parameters and
    gradients (LBFGS: 3 iterations of a closure whose gradients are
    those plus 0.01 p), with TF32 off: every parameter within
    OPTIM_STEP_TOL of the parameters' largest move, every state (by key)
    within it of that state's largest move from its initial value
    (integer states equal). The planted faults (Lamb's trust ratio 1,
    RMSProp centered without the mean gradient, RAdam rectified at
    t = 1) must read at least 10 x the bound on the parameters."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        layers, batch, seq = 2, 4, 512
        cfg = ernie.ErnieConfig.ernie3_base(num_hidden_layers=layers)
        paddle.set_device("gpu")
        paddle.seed(SEED + 5)
        model = build_model(paddle, cfg, dropout=0.0)
        rng = np.random.default_rng(5)
        ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size,
                                            (batch, seq)))
        labels = paddle.to_tensor(rng.integers(0, cfg.num_labels,
                                               (batch,)))
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = paddle.nn.CrossEntropyLoss()(model(ids), labels)
        loss.backward()
        values = [p.numpy().copy() for p in model.parameters()]
        grads = [p.grad.numpy().copy() for p in model.parameters()]
        del model, loss
        torch.cuda.empty_cache()
        o = paddle.optimizer
        results, faults = {}, {}
        planted = _planted_optimizers(paddle)
        for name, make in _CHECK_OPTIMIZERS.items():
            cpu = _optim_run(paddle, "cpu", values, grads,
                             lambda ps: make(o, ps))
            card = _optim_run(paddle, "gpu", values, grads,
                              lambda ps: make(o, ps))
            states = {}
            for k, want in cpu[1].items():
                got = card[1][k]
                if np.issubdtype(want[0].dtype, np.integer):
                    same = all(np.array_equal(a, b)
                               for a, b in zip(got, want))
                    states[k] = 0.0 if same else float("inf")
                else:
                    states[k] = _rel_to_move(got, want, cpu[2][k])
            results[name] = {"param_rel_err": _rel_to_move(
                card[0], cpu[0], values), "state_rel_err": states}
            if name in planted:
                bad = _optim_run(paddle, "gpu", values, grads, planted[name])
                faults[name] = _rel_to_move(bad[0], cpu[0], values)
            del cpu, card
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        paddle.set_device("gpu")
    res = {"phase": "grad_check_optim", "layers": layers, "batch": batch,
           "seq": seq, "params": int(sum(v.size for v in values)),
           "tol": OPTIM_STEP_TOL, "optimizers": results,
           "planted_faults": faults,
           "faults": {"Lamb": "trust ratio forced to 1",
                      "RMSProp": "centered without the mean gradient",
                      "RAdam": "rectified at every t"},
           "nvidia_smi": _smi_line()}
    _emit(res)
    bad = [f"{n}: {r}" for n, r in results.items()
           if not (r["param_rel_err"] <= OPTIM_STEP_TOL and all(
               e <= OPTIM_STEP_TOL for e in r["state_rel_err"].values()))]
    low = [f"{n}: {e}" for n, e in faults.items()
           if not e >= 10 * OPTIM_STEP_TOL]
    if bad or low:
        raise AssertionError(f"grad_check_optim: outside the bound: {bad}; "
                             f"planted faults within 10 x it: {low}")
    return res


# the user PyLayer of autograd_check (c) against the built-in path: the
# input and weight gradients within this share of their largest
# magnitude (bf16 x, the backward's f32 arithmetic in another order)
PYLAYER_GRAD_TOL = 2e-2


def _user_rms_norm(paddle):
    """A user PyLayer over the fused RMSNorm (row 6's kernel in its
    forward) whose backward is written from its saved tensors with the
    eager API's ops, in f32."""
    F = paddle.incubate.nn.functional

    class UserRMSNorm(paddle.PyLayer):
        @staticmethod
        def forward(ctx, x, w, eps):
            ctx.save_for_backward(x, w)
            ctx.eps = eps
            return F.fused_rms_norm(x, w, epsilon=eps)

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensor()
            xf, dyf = x.astype("float32"), dy.astype("float32")
            r = ((xf * xf).mean(axis=-1, keepdim=True) + ctx.eps) ** -0.5
            xhat = xf * r
            g = dyf * w.astype("float32")
            dx = r * (g - xhat * (g * xhat).mean(axis=-1, keepdim=True))
            dw = (dyf * xhat).sum(axis=0)
            return dx.astype(x.dtype), dw.astype(w.dtype)

    return UserRMSNorm


def _r1_penalty(paddle, state, x, device):
    """The R1 penalty ‖∂D/∂x‖² of resnet18 as D (the sum of its logits)
    at x, through paddle.grad(create_graph=True), then its backward →
    (the penalty, every parameter's gradient), as numpy."""
    paddle.set_device(device)
    model = paddle.vision.models.resnet18(num_classes=1000)
    model.set_state_dict(state)
    xt = paddle.to_tensor(x, stop_gradient=False)
    (gx,) = paddle.grad(model(xt).sum(), [xt], create_graph=True)
    pen = (gx * gx).sum()
    pen.backward()
    # a parameter the penalty does not reach (the last bias) has no grad
    out = (float(pen), {n: np.zeros(p.shape, np.float32) if p.grad is None
                        else p.grad.numpy()
                        for n, p in model.named_parameters()})
    paddle.set_device("gpu")
    return out


def phase_autograd_check():
    """The autograd surface on the card.
    (a) The eager ERNIE at full width cut to 2 layers (dropout 0, O1
        bf16, batch 4 x 512): paddle.grad(loss, [h]) for the embedding
        output h equals, bit for bit, what a register_hook on h records
        during loss.backward(); the flash and LayerNorm backward kernels
        launch in both; paddle.grad leaves every parameter's .grad as
        backward left it (bit for bit).
    (b) An R1 gradient penalty ‖∂D/∂x‖² through
        paddle.grad(create_graph=True), then backward, on resnet18 at
        2 x 3 x 64 x 64 f32 with TF32 off, against the port's CPU run:
        the penalty and every parameter's gradient within
        RESNET_STEP_TOL of the gradients' largest magnitude.
    (c) A user PyLayer over F.fused_rms_norm at the eager Llama's
        [4096, 4096] bf16 (f32 weight), its backward written from saved
        tensors: the input and weight gradients within PYLAYER_GRAD_TOL
        of their largest magnitude of the built-in path's, row 6
        launched once by the PyLayer's forward."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.eager_ernie import build_model

    res = {"phase": "autograd_check"}
    failures = []
    # (a) paddle.grad against a hook, on the kernels' backward
    cfg = ernie.ErnieConfig.ernie3_base(num_hidden_layers=2)
    paddle.set_device("gpu")
    paddle.seed(SEED + 6)
    model = build_model(paddle, cfg, dropout=0.0)
    rng = np.random.default_rng(6)
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (4, 512)))
    labels = paddle.to_tensor(rng.integers(0, cfg.num_labels, (4,)))
    seen, hooked = {}, []

    def grab(layer, inputs, out):
        seen["h"] = out
        out.register_hook(lambda g: hooked.append(g._data.clone()))

    handle = model.embeddings.register_forward_post_hook(grab)
    with paddle.amp.auto_cast(dtype="bfloat16"):
        loss = paddle.nn.CrossEntropyLoss()(model(ids), labels)
    handle.remove()
    counters = {"flash_attention_bwd": fa.flash_attention_bwd,
                "layer_norm_bwd": ln.layer_norm_bwd}
    _zero_counts(counters)
    loss.backward(retain_graph=True)
    torch.cuda.synchronize()
    bwd_launches = _read_counts(counters)[0]
    grads = {n: p.grad._data.clone() for n, p in model.named_parameters()}
    _zero_counts(counters)
    (gh,) = paddle.grad(loss, [seen["h"]])
    torch.cuda.synchronize()
    grad_launches = _read_counts(counters)[0]
    untouched = all(torch.equal(p.grad._data, grads[n])
                    for n, p in model.named_parameters())
    res["a"] = {"layers": 2, "batch": 4, "seq": 512,
                "h_shape": seen["h"].shape,
                "bit_identical": bool(torch.equal(gh._data, hooked[0])),
                "max_abs_diff": float((gh._data.float()
                                       - hooked[0].float()).abs().max()),
                "backward_launches": bwd_launches,
                "grad_launches": grad_launches,
                "param_grads_untouched": untouched}
    if not res["a"]["bit_identical"]:
        failures.append("(a) paddle.grad differs from the hook's gradient")
    if not untouched:
        failures.append("(a) paddle.grad changed a parameter's .grad")
    for n in counters:
        if not (bwd_launches[n] >= 1 and grad_launches[n] >= 1):
            failures.append(f"(a) {n} did not launch in both: "
                            f"{bwd_launches} {grad_launches}")
    del model, loss, seen, hooked, grads, gh
    torch.cuda.empty_cache()
    # (b) an R1 gradient penalty against the CPU
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        paddle.set_device("cpu")
        paddle.seed(SEED + 7)
        state = {k: v.numpy().copy() for k, v in
                 paddle.vision.models.resnet18(num_classes=1000)
                 .state_dict().items()}
        x = np.random.default_rng(SEED + 7).standard_normal(
            (2, 3, 64, 64)).astype(np.float32)
        cpu = _r1_penalty(paddle, state, x, "cpu")
        card = _r1_penalty(paddle, state, x, "gpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        paddle.set_device("gpu")
    scale = max(float(np.abs(g).max()) for g in cpu[1].values())
    grad_err = max(float(np.abs(card[1][n] - g).max())
                   for n, g in cpu[1].items()) / scale
    res["b"] = {"model": "resnet18", "input": [2, 3, 64, 64],
                "penalty_cpu": cpu[0], "penalty_card": card[0],
                "penalty_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
                "grad_rel_err": grad_err, "tol": RESNET_STEP_TOL}
    if not (res["b"]["penalty_rel_err"] <= RESNET_STEP_TOL
            and grad_err <= RESNET_STEP_TOL):
        failures.append(f"(b) the R1 penalty's gradients: {res['b']}")
    # (c) a user PyLayer over row 6 against the built-in path
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x0 = torch.randn(4096, 4096, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    w0 = 1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")
    dy = paddle.Tensor(torch.randn(4096, 4096, generator=gen, device="cuda",
                                   dtype=torch.bfloat16))
    out = {}
    for how in ("built_in", "pylayer"):
        x = paddle.Tensor(x0.clone(), stop_gradient=False)
        w = paddle.Tensor(w0.clone(), stop_gradient=False)
        _zero_counts({"rms_norm_fused": rn.rms_norm_fused})
        if how == "pylayer":
            y = _user_rms_norm(paddle).apply(x, w, 1e-6)
        else:
            y = paddle.incubate.nn.functional.fused_rms_norm(x, w,
                                                             epsilon=1e-6)
        launched = rn.rms_norm_fused.launches
        (y * dy).astype("float32").sum().backward()
        out[how] = (y._data, x.grad._data.float(), w.grad._data.float(),
                    launched)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    res["c"] = {"shape": [4096, 4096], "dtype": "bfloat16",
                "weight_dtype": "float32",
                "out_equal": bool(torch.equal(out["pylayer"][0],
                                              out["built_in"][0])),
                "dx_rel_err": rel(out["pylayer"][1], out["built_in"][1]),
                "dw_rel_err": rel(out["pylayer"][2], out["built_in"][2]),
                "rms_norm_fused_launches": out["pylayer"][3],
                "tol": PYLAYER_GRAD_TOL}
    del out, x0, w0, dy
    torch.cuda.empty_cache()
    if not (res["c"]["out_equal"] and res["c"]["rms_norm_fused_launches"]
            == 1 and res["c"]["dx_rel_err"] <= PYLAYER_GRAD_TOL
            and res["c"]["dw_rel_err"] <= PYLAYER_GRAD_TOL):
        failures.append(f"(c) the PyLayer over row 6: {res['c']}")
    res["nvidia_smi"] = _smi_line()
    _emit(res)
    if failures:
        raise AssertionError("autograd_check: " + "; ".join(failures))
    return res


# ------------------------------------------------- 18. the Transformer
# one non-causal flash forward and backward for each encoder layer's
# self-attention and each decoder layer's cross-attention; the decoder's
# masked self-attention takes the exact path, and the norms are plain
_TRANSFORMER_LAUNCHES_PER_STEP = {"flash_attention_fwd": 12,
                                  "flash_attention_bwd": 12,
                                  "layer_norm_fwd": 0, "layer_norm_bwd": 0}
TRANSFORMER_BATCH = 96
TRANSFORMER_SEQ = 256
# nn.CrossEntropyLoss(label_smoothing) on hard labels against the
# criterion's one-hot soft labels: the same sum in another order (f32)
CE_SMOOTH_TOL = 1e-5


def _transformer_data(cfg, batch, seq, seed):
    """Source ids [batch, seq] and target ids [batch, seq + 1] (shifted
    into the decoder's input and its labels), uniform over the shared
    vocabulary, from default_rng(seed)."""
    import paddle_tpu_torch as paddle
    rng = np.random.default_rng(seed)
    src = rng.integers(0, cfg.vocab_size, (batch, seq))
    tgt = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    return (paddle.to_tensor(src), paddle.to_tensor(tgt[:, :-1]),
            paddle.to_tensor(tgt[:, 1:]))


def phase_transformer(peaks, warmup: int = 2, timed: int = 4):
    """The Transformer base model of Vaswani et al. 2017 composed from the
    eager API's layers (tools/eager_transformer.py: d_model 512, 8 heads
    of 64, 6 + 6 layers, ffn 2048, relu, post-norm, dropout 0.1,
    attention dropout 0, the shared 37,000-token embedding tied to the
    output projection, label smoothing 0.1), f32 parameters under O1
    bf16 auto_cast, Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000),
    `warmup` + `timed` steps of 96 x 256 source and target tokens (the
    same seeded batch each step). Launch counters are zeroed before the
    timed steps: the flash pair exactly 12 + 12 a step, all bf16, no
    LayerNorm kernel. The step losses must be finite; the batch's
    dropout-free f32 loss must fall from before the steps to after them
    (the steps' own losses carry dropout's noise, larger than what six
    warm-up steps of the schedule move). MFU counts 6 x the matmul MACs
    a target token (`TransformerConfig.matmul_macs_per_token`) over 989
    TFLOP/s. Then nn.CrossEntropyLoss(label_smoothing=0.1) on the hard
    labels against the criterion, within CE_SMOOTH_TOL."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import eager_transformer as et
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = et.TransformerConfig.base()
    B, S = TRANSFORMER_BATCH, TRANSFORMER_SEQ
    t0 = time.perf_counter()
    paddle.seed(SEED)
    model = et.build_model(paddle, cfg)
    opt = et.make_optimizer(paddle, model, cfg)
    src, tin, tout = _transformer_data(cfg, B, S, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def f32_loss():
        model.eval()
        with paddle.no_grad():
            v = float(et.loss_fn(paddle, model, cfg, src, tin, tout, None))
        model.train()
        return v

    before = f32_loss()
    counters = _path_counters(_TRANSFORMER_LAUNCHES_PER_STEP)
    losses, dt, launches, peak = _run_steps(
        lambda: et.train_step(paddle, model, cfg, opt, src, tin, tout),
        counters, warmup, timed)
    by_dtype = _read_counts(counters)[1]
    after = f32_loss()
    # the criterion against CrossEntropyLoss(label_smoothing) on 8 rows
    model.eval()
    with paddle.no_grad():
        logits = model(src[:8], tin[:8])
        crit = float(et.criterion(paddle, logits, tout[:8], 0.1))
        ce = float(paddle.nn.CrossEntropyLoss(label_smoothing=0.1)(
            logits.reshape([-1, cfg.vocab_size]), tout[:8].reshape([-1])))
    del logits
    macs = cfg.matmul_macs_per_token(S)
    tok_s = B * S * timed / dt
    res = {"phase": "transformer",
           "config": "Transformer base (Vaswani et al. 2017; the "
                     "paddle.nn.Transformer defaults), shared vocabulary "
                     "37000, composed from layers",
           "widths": {"V": cfg.vocab_size, "D": cfg.d_model,
                      "H": cfg.nhead, "L_enc": cfg.num_encoder_layers,
                      "L_dec": cfg.num_decoder_layers,
                      "F": cfg.dim_feedforward},
           "params": sum(p.size for p in model.parameters()),
           "batch": B, "seq": S, "steps": warmup + timed,
           "timed_steps": timed, "step_ms": dt / timed * 1e3,
           "target_tokens_per_s": tok_s,
           "matmul_macs_per_token": macs, "flops_per_token": 6 * macs,
           "mfu": tok_s * 6 * macs / peaks[0],
           "losses": losses, "f32_loss_before": before,
           "f32_loss_after": after, "peak_memory_bytes": peak,
           "init_s": init_s, "launches": launches,
           "launches_per_step": {n: c / timed for n, c in launches.items()},
           "launches_by_dtype": by_dtype, "criterion": crit,
           "ce_label_smoothing": ce,
           "ce_rel_diff": abs(ce - crit) / abs(crit),
           "lr_last": opt.get_lr(), "nvidia_smi": _smi_line()}
    del model, opt, src, tin, tout
    torch.cuda.empty_cache()
    _emit(res)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"transformer: non-finite loss: {losses}")
    if not after < before:
        raise AssertionError(f"transformer: the f32 loss of the batch did "
                             f"not fall: {before} -> {after}")
    if not res["peak_memory_bytes"] < 80e9:
        raise AssertionError(f"transformer: peak memory {peak} over 80 GB")
    for kernel, per in _TRANSFORMER_LAUNCHES_PER_STEP.items():
        if launches[kernel] != per * timed:
            raise AssertionError(
                f"transformer: {kernel} launched {launches[kernel]} times "
                f"in {timed} steps, expected {per} a step")
    _check_dtype_launches("transformer",
                          {n: by_dtype[n] for n in ("flash_attention_fwd",
                                                    "flash_attention_bwd")},
                          {"flash_attention_fwd": 12,
                           "flash_attention_bwd": 12}, timed, "bf16")
    if not res["ce_rel_diff"] <= CE_SMOOTH_TOL:
        raise AssertionError(f"transformer: CrossEntropyLoss(label_smoothing"
                             f"=0.1) {ce} against the criterion {crit}")
    return res


def _transformer_group(name: str) -> str:
    """The gradient group of a parameter of the tool's Transformer."""
    if name.startswith("embedding."):
        return "embed"
    if ".norm" in name:
        return "norms"
    if ".cross_attn." in name:
        return "cross_attention"
    if name.startswith("transformer.encoder.") and ".self_attn." in name:
        return "encoder_self_attention"
    if ".self_attn." in name:
        return "decoder_self_attention"
    return "ffn"


# the groups the flash backward's dcap fault reaches first: the two
# attentions that take the kernels
_TRANSFORMER_FAULT_GROUPS = ("encoder_self_attention", "cross_attention")


def phase_grad_check_transformer(layers: int = 2, batch: int = 8):
    """One loss + backward of the tool's Transformer at base widths, 2 + 2
    layers, dropout 0, batch 8 x 256, under O1 bf16 through the kernels,
    their plain versions, the plain versions with the dcap fault, and an
    f32 evaluation (no auto_cast, plain versions) of the same f32
    weights: the relative RMS distance of the decoder's output and of
    each gradient group from f32. The kernels within GRAD_VS_F32_RATIO x
    the plain path's distance in every group; the fault above it in the
    encoder's self-attention and the cross-attention."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import eager_transformer as et
    paddle.set_device("gpu")
    cfg = et.TransformerConfig.base(num_encoder_layers=layers,
                                    num_decoder_layers=layers, dropout=0.0)
    paddle.seed(SEED + 5)
    model = et.build_model(paddle, cfg)
    src, tin, tout = _transformer_data(cfg, batch, TRANSFORMER_SEQ, 5)
    last = {}
    hook = model.transformer.register_forward_post_hook(
        lambda layer, inputs, out: last.__setitem__("out", out))

    def run(amp):
        loss = et.loss_fn(paddle, model, cfg, src, tin, tout,
                          "bfloat16" if amp else None)
        loss.backward()
        g = {n: p.grad._data.float() for n, p in model.named_parameters()}
        model.clear_gradients()
        return (float(loss), last.pop("out")._data.detach().float()
                .reshape(-1), g)

    res = {"kernel": run(True)}
    with _plain_kernels():
        res["ref"] = run(True)
    with _plain_kernels(fault="dcap"):
        res["fault"] = run(True)
    with _plain_kernels():
        res["f32"] = run(False)
    hook.remove()
    groups: dict = {}
    for n, _ in model.named_parameters():
        groups.setdefault(_transformer_group(n), []).append(n)
    del model
    out = _grad_ratios(res, groups, first="decoder_out")
    _emit({"phase": "grad_check_transformer", "layers": layers,
           "batch": batch, "seq": TRANSFORMER_SEQ,
           "ratio_tol": GRAD_VS_F32_RATIO,
           "fault_groups": _TRANSFORMER_FAULT_GROUPS, **out})
    del res
    torch.cuda.empty_cache()
    _check_grad_ratios(out, groups, _TRANSFORMER_FAULT_GROUPS, "dcap",
                       first="decoder_out")
    return out


# ------------------------------------------------------- 18b. nn_check
# the card against the CPU, f32 with TF32 off: the same expressions on
# other hardware, within this fraction of each output's largest element
NN_CHECK_TOL = 1e-5
# ctc_loss and rnnt_loss chain T (and T x U) steps of log-sum-exp whose
# exp and log differ from the CPU's in the last bits at each step, and
# grid_sample's input gradient is summed by atomicAdd in an order that
# varies: 1e-4 for these three
NN_CHECK_LOOSE_TOL = 1e-4
_NN_LOOSE = ("ctc_loss", "rnnt_loss", "grid_sample", "layer:CTCLoss",
             "layer:RNNTLoss")


def _nn_cases():
    """(name, fn(F, T, *tensors), arrays, differentiable flags): every
    functional of this slice and every loss layer, at small shapes (T
    makes a label tensor on the current place); the random ones in eval
    mode (gumbel_softmax, which has none, is left out)."""
    rng = np.random.default_rng(SEED + 7)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x, x4, e = r(6, 8, scale=2.0), r(2, 4, 6, 6), [r(6, 8) for _ in range(3)]
    p = rng.uniform(0.05, 0.95, (6, 5)).astype(np.float32)
    b = (rng.uniform(size=(6, 5)) > 0.5).astype(np.float32)
    y, lab = r(6, 5), rng.integers(0, 5, (6,))
    pm = np.where(rng.uniform(size=6) > 0.5, 1.0, -1.0).astype(np.float32)
    w5 = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    ctc = (rng.integers(1, 6, (3, 4)), np.array([12, 10, 7]),
           np.array([4, 2, 3]))
    rnnt = (rng.integers(1, 6, (2, 3)), np.array([5, 4]), np.array([3, 2]))

    acts = ["relu", "relu6", "gelu", "silu", "swish", "elu", "selu",
            "celu", "leaky_relu", "hardshrink", "softshrink", "tanhshrink",
            "hardtanh", "hardsigmoid", "hardswish", "mish", "softplus",
            "softsign", "log_sigmoid", "tanh", "sigmoid", "softmax",
            "log_softmax", "thresholded_relu"]
    cases = [(n, (lambda n: lambda F, T, a: getattr(F, n)(a))(n), [x], [1])
             for n in acts]
    cases += [
        ("prelu", lambda F, T, a, w: F.prelu(a, w), [x4, r(4)], [1, 1]),
        ("rrelu", lambda F, T, a: F.rrelu(a, training=False), [x], [1]),
        ("glu", lambda F, T, a: F.glu(a), [x], [1]),
        ("maxout", lambda F, T, a: F.maxout(a, 2), [x4], [1]),
        ("cross_entropy", lambda F, T, a, wt: F.cross_entropy(
            a, T(lab), weight=wt, label_smoothing=0.1), [y, w5], [1, 0]),
        ("cross_entropy_soft", lambda F, T, a: F.cross_entropy(
            a, T(p), soft_label=True), [y], [1]),
        ("softmax_with_cross_entropy", lambda F, T, a: F.
         softmax_with_cross_entropy(a, T(lab)), [y], [1]),
        ("mse_loss", lambda F, T, a, c: F.mse_loss(a, c), [y, p], [1, 1]),
        ("l1_loss", lambda F, T, a, c: F.l1_loss(a, c), [y, p], [1, 1]),
        ("smooth_l1_loss", lambda F, T, a, c: F.smooth_l1_loss(a, c),
         [y, p], [1, 1]),
        ("nll_loss", lambda F, T, a: F.nll_loss(F.log_softmax(a), T(lab)),
         [y], [1]),
        ("binary_cross_entropy", lambda F, T, a, c: F.binary_cross_entropy(
            a, c), [p, b], [1, 0]),
        ("binary_cross_entropy_with_logits", lambda F, T, a, c:
         F.binary_cross_entropy_with_logits(a, c), [y, b], [1, 0]),
        ("kl_div", lambda F, T, a, c: F.kl_div(a, c), [y, p], [1, 1]),
        ("margin_ranking_loss", lambda F, T, a, c, l: F.margin_ranking_loss(
            a, c, l, 0.1), [e[0][:, 0], e[1][:, 0], pm], [1, 1, 0]),
        ("hinge_embedding_loss", lambda F, T, a, l: F.hinge_embedding_loss(
            a, l), [y, np.sign(p - 0.5)], [1, 0]),
        ("cosine_embedding_loss", lambda F, T, a, c, l:
         F.cosine_embedding_loss(a, c, l), [e[0], e[1], pm], [1, 1, 0]),
        ("triplet_margin_loss", lambda F, T, a, c, d: F.triplet_margin_loss(
            a, c, d), e, [1, 1, 1]),
        ("sigmoid_focal_loss", lambda F, T, a, c: F.sigmoid_focal_loss(a, c),
         [y, b], [1, 0]),
        ("square_error_cost", lambda F, T, a, c: F.square_error_cost(a, c),
         [y, p], [1, 1]),
        ("poisson_nll_loss", lambda F, T, a, c: F.poisson_nll_loss(a, c),
         [y, np.round(3 * p)], [1, 0]),
        ("gaussian_nll_loss", lambda F, T, a, c, v: F.gaussian_nll_loss(
            a, c, v), [y, r(6, 5), p], [1, 1, 1]),
        ("dice_loss", lambda F, T, a: F.dice_loss(F.softmax(a), T(
            lab[:, None])), [y], [1]),
        ("log_loss", lambda F, T, a, c: F.log_loss(a, c), [p, b], [1, 0]),
        ("npair_loss", lambda F, T, a, c: F.npair_loss(a, c, T(lab)),
         [e[0], e[1]], [1, 1]),
        ("soft_margin_loss", lambda F, T, a, c: F.soft_margin_loss(a, c),
         [y, np.sign(p - 0.5)], [1, 0]),
        ("multi_label_soft_margin_loss", lambda F, T, a, c:
         F.multi_label_soft_margin_loss(a, c), [y, b], [1, 0]),
        ("multi_margin_loss", lambda F, T, a: F.multi_margin_loss(a, T(lab)),
         [y], [1]),
        ("huber_loss", lambda F, T, a, c: F.huber_loss(a, c), [y, p], [1, 1]),
        ("hsigmoid_loss", lambda F, T, a, wt, bb: F.hsigmoid_loss(
            a, T(lab[:, None]), 5, wt, bb), [x, r(4, 8), r(4)], [1, 1, 1]),
        ("triplet_margin_with_distance_loss", lambda F, T, a, c, d:
         F.triplet_margin_with_distance_loss(a, c, d), e, [1, 1, 1]),
        ("margin_cross_entropy", lambda F, T, a: F.margin_cross_entropy(
            a, T(lab)), [np.tanh(y)], [1]),
        ("adaptive_log_softmax_with_loss", lambda F, T, a, h, a1, b1:
         F.adaptive_log_softmax_with_loss(a, T(np.array([0, 1, 4, 2, 3,
                                                         4])), h,
                                          [[a1, b1]], [2]),
         [x, r(8, 3), r(8, 4), r(4, 3)], [1, 1, 1, 1]),
        ("ctc_loss", lambda F, T, a: F.ctc_loss(
            F.log_softmax(a), T(ctc[0]), T(ctc[1]), T(ctc[2])),
         [r(12, 3, 6)], [1]),
        ("ctc_greedy_decoder", lambda F, T, a: F.ctc_greedy_decoder(a),
         [r(3, 9, 4)], [0]),
        ("rnnt_loss", lambda F, T, a: F.rnnt_loss(
            a, T(rnnt[0]), T(rnnt[1]), T(rnnt[2])),
         [r(2, 5, 4, 6)], [1]),
        ("dropout2d", lambda F, T, a: F.dropout2d(a, training=False), [x4],
         [1]),
        ("dropout3d", lambda F, T, a: F.dropout3d(a[..., None],
                                               training=False), [x4], [1]),
        ("alpha_dropout", lambda F, T, a: F.alpha_dropout(a, training=False),
         [x4], [1]),
        ("normalize", lambda F, T, a: F.normalize(a), [x4], [1]),
        ("cosine_similarity", lambda F, T, a, c: F.cosine_similarity(a, c),
         [e[0], e[1]], [1, 1]),
        ("interpolate", lambda F, T, a: F.interpolate(
            a, scale_factor=2, mode="bilinear", align_corners=True), [x4],
         [1]),
        ("interpolate_nearest", lambda F, T, a: F.interpolate(a, size=[9, 5]),
         [x4], [1]),
        ("interpolate_bicubic", lambda F, T, a: F.interpolate(
            a, scale_factor=2, mode="bicubic"), [x4], [1]),
        ("interpolate_area", lambda F, T, a: F.interpolate(
            a, size=[3, 2], mode="area"), [x4], [1]),
        ("pixel_shuffle", lambda F, T, a: F.pixel_shuffle(a, 2), [x4], [1]),
        ("pixel_unshuffle", lambda F, T, a: F.pixel_unshuffle(a, 2), [x4],
         [1]),
        ("channel_shuffle", lambda F, T, a: F.channel_shuffle(a, 2), [x4],
         [1]),
        ("unfold", lambda F, T, a: F.unfold(a, 3, 2, 1), [x4], [1]),
        ("fold", lambda F, T, a: F.fold(a, [5, 6], 2), [r(2, 12, 20)], [1]),
        ("label_smooth", lambda F, T, a: F.label_smooth(a), [p], [1]),
        ("pairwise_distance", lambda F, T, a, c: F.pairwise_distance(a, c),
         [e[0], e[1]], [1, 1]),
        ("zeropad2d", lambda F, T, a: F.zeropad2d(a, [1, 2, 0, 1]), [x4], [1]),
        ("pad_reflect", lambda F, T, a: F.pad(a, [1, 2, 2, 1],
                                           mode="reflect"), [x4], [1]),
        ("pad_circular", lambda F, T, a: F.pad(a, [1, 2, 2, 1],
                                            mode="circular"), [x4], [1]),
        ("one_hot", lambda F, T, a: F.one_hot(a, 6), [lab], [0]),
        ("bilinear", lambda F, T, a, c, wt: F.bilinear(a, c, wt),
         [e[0][:, :3], e[1][:, :4], r(2, 3, 4)], [1, 1, 1]),
        ("sequence_mask", lambda F, T, a: F.sequence_mask(a, 7), [lab], [0]),
        ("temporal_shift", lambda F, T, a: F.temporal_shift(a, 2), [x4],
         [1]),
        ("affine_grid", lambda F, T, t: F.affine_grid(t, [2, 4, 5, 6]),
         [r(2, 2, 3)], [1]),
        ("grid_sample", lambda F, T, a, g: F.grid_sample(a, g),
         [x4, np.clip(r(2, 5, 5, 2), -1.2, 1.2)], [1, 1]),
        ("gather_tree", lambda F, T, i, q: F.gather_tree(i, q),
         [rng.integers(0, 9, (5, 2, 3)), rng.integers(0, 3, (5, 2, 3))],
         [0, 0]),
        ("local_response_norm", lambda F, T, a: F.local_response_norm(a, 3),
         [x4], [1]),
        ("spectral_norm", lambda F, T, wt: F.spectral_norm(wt, power_iters=3),
         [r(5, 7)], [1]),
    ]
    # the loss layers, each over its own input and labels
    e01 = [e[0], e[1]]
    for name, kw, arrays, diff, labels in (
            ("CrossEntropyLoss", {"label_smoothing": 0.1}, [y], [1], [lab]),
            ("MSELoss", {}, [y, p], [1, 1], []),
            ("L1Loss", {}, [y, p], [1, 1], []),
            ("NLLLoss", {}, [y], [1], [lab]),
            ("BCELoss", {}, [p, b], [1, 0], []),
            ("BCEWithLogitsLoss", {}, [y, b], [1, 0], []),
            ("SmoothL1Loss", {}, [y, p], [1, 1], []),
            ("KLDivLoss", {}, [y, p], [1, 1], []),
            ("MarginRankingLoss", {}, [e[0][:, 0], e[1][:, 0], pm],
             [1, 1, 0], []),
            ("TripletMarginLoss", {}, e, [1, 1, 1], []),
            ("TripletMarginWithDistanceLoss", {}, e, [1, 1, 1], []),
            ("CosineEmbeddingLoss", {}, e01 + [pm], [1, 1, 0], []),
            ("HingeEmbeddingLoss", {}, [y, np.sign(p - 0.5)], [1, 0], []),
            ("HuberLoss", {}, [y, p], [1, 1], []),
            ("SoftMarginLoss", {}, [y, np.sign(p - 0.5)], [1, 0], []),
            ("MultiLabelSoftMarginLoss", {}, [y, b], [1, 0], []),
            ("MultiMarginLoss", {}, [y], [1], [lab]),
            ("PoissonNLLLoss", {}, [y, np.round(3 * p)], [1, 0], []),
            ("GaussianNLLLoss", {}, [y, r(6, 5), p], [1, 1, 1], []),
            ("CTCLoss", {}, [r(12, 3, 6)], [1], list(ctc)),
            ("RNNTLoss", {}, [r(2, 5, 4, 6)], [1], list(rnnt)),
            ("HSigmoidLoss", {"feature_size": 8, "num_classes": 5}, [x], [1],
             [lab[:, None]]),
            ("AdaptiveLogSoftmaxWithLoss",
             {"in_features": 8, "n_classes": 5, "cutoffs": [2],
              "div_value": 2.0}, [x], [1], [np.array([0, 1, 4, 2, 3, 4])])):
        cases.append((f"layer:{name}", _loss_layer_fn(name, kw, labels),
                      arrays, diff))
    return cases


def _loss_layer_fn(name, kw, labels):
    """fn(F, T, *tensors) calling the loss layer `name` (its parameters,
    if any, set from a fixed draw, so both places hold the same) on the
    tensors and `labels` (CTCLoss and NLLLoss take log-probabilities)."""
    def fn(F, T, *ts):
        import paddle_tpu_torch as paddle
        layer = getattr(paddle.nn, name)(**kw)
        prng = np.random.default_rng(SEED + 8)
        for prm in layer.parameters():
            prm.set_value((0.3 * prng.standard_normal(prm.shape)).astype(
                np.float32))
        if name in ("CTCLoss", "NLLLoss"):
            ts = (F.log_softmax(ts[0]),) + ts[1:]
        return layer(*ts, *[T(lb) for lb in labels])
    return fn


def _nn_case_run(paddle, fn, arrays, diff):
    """fn on Tensors of the current place; (outputs, input grads of
    Σ out·c over the float outputs), as f64 numpy."""
    ts = [paddle.to_tensor(a, stop_gradient=not d)
          for a, d in zip(arrays, diff)]
    out = fn(paddle.nn.functional, paddle.to_tensor, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    crng = np.random.default_rng(99)
    total = None
    for o in outs:
        c = crng.standard_normal(o.shape).astype(np.float32) \
            if o.shape else np.float32(1.0)
        if o.dtype == torch.float32 and not o.stop_gradient:
            term = (o * paddle.to_tensor(c)).sum()
            total = term if total is None else total + term
    if total is not None:
        total.backward()
    return ([np.asarray(o.numpy(), np.float64) for o in outs],
            [np.asarray(t.grad.numpy(), np.float64)
             if d and t.grad is not None else None
             for t, d in zip(ts, diff)])


def _no_host_read_step():
    """One training step of the transformer phase's model (base widths,
    dropout 0.1, O1 bf16, Adam under NoamDecay) on 8 x 256 tokens, its
    forward, loss, backward and optimizer step under CUDA's sync debug
    mode "error": any device value read on the host raises. Returns the
    loss (read after)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import eager_transformer as et
    cfg = et.TransformerConfig.base()
    paddle.seed(SEED + 6)
    model = et.build_model(paddle, cfg)
    opt = et.make_optimizer(paddle, model, cfg)
    src, tin, tout = _transformer_data(cfg, 8, TRANSFORMER_SEQ, 6)
    model.tgt_mask(TRANSFORMER_SEQ)       # the cached mask made up front
    et.train_step(paddle, model, cfg, opt, src, tin, tout)    # warm
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = et.train_step(paddle, model, cfg, opt, src, tin, tout)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    v = float(loss)
    del model, opt
    torch.cuda.empty_cache()
    return v


def phase_nn_check():
    """Every functional of this slice and every loss layer (`_nn_cases`)
    once on CUDA tensors and once on the CPU, f32 with TF32 off: each
    output and each input gradient within NN_CHECK_TOL of its largest
    element (NN_CHECK_LOOSE_TOL for the CTC and RNN-T losses and
    grid_sample); the random functions in eval mode. Then one step of the transformer
    phase's model under sync debug mode "error" (`_no_host_read_step`)."""
    import paddle_tpu_torch as paddle
    cases = _nn_cases()
    worst, failures = {}, []
    for name, fn, arrays, diff in cases:
        got = {}
        for place in ("gpu", "cpu"):
            paddle.set_device(place)
            got[place] = _nn_case_run(paddle, fn, arrays, diff)
        paddle.set_device("gpu")
        (go, gg), (co, cg) = got["gpu"], got["cpu"]
        errs = []
        for a, b in zip(go + gg, co + cg):
            if a is None or b is None:
                continue
            scale = max(np.abs(b).max(initial=0.0), 1e-30)
            errs.append(float(np.abs(a - b).max(initial=0.0) / scale))
        worst[name] = max(errs)
        tol = NN_CHECK_LOOSE_TOL if name in _NN_LOOSE else NN_CHECK_TOL
        if not worst[name] <= tol:
            failures.append(f"{name}: {worst[name]} > {tol}")
    paddle.set_device("gpu")
    loss = _no_host_read_step()
    res = {"phase": "nn_check", "cases": len(cases), "tol": NN_CHECK_TOL,
           "loose_tol": NN_CHECK_LOOSE_TOL, "loose": _NN_LOOSE,
           "max_rel_err": worst,
           "worst": max(worst.items(), key=lambda kv: kv[1]),
           "no_host_read_step_loss": loss, "nvidia_smi": _smi_line()}
    _emit(res)
    if failures:
        raise AssertionError("nn_check: " + "; ".join(failures))
    if not np.isfinite(loss):
        raise AssertionError(f"nn_check: the checked step's loss is {loss}")
    return res


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
        # S=4096 and 8192 + LSE; train05b: B=16 S=2048 H=16 + LSE;
        # predict: the predictor's prefill, B=8 S=512
        "rows": [1],
        # the O2 runs: bf16 at eager_llama's shape; the f16 option at the
        # eager Llama's and the eager ERNIE's (each the 21st case of its
        # path's pool: the 20 untagged ones come first)
        "main": {"serve": 1, "serve_prefix": 1, "serve_quant_spec": 1,
                 "serve_robust": 1, "train": 3,
                 "train_moe": 4, "eager": 5,
                 "eager_llama": 6, "ernie": 7, "dit": 12, "generate": 14,
                 "long8k": 15, "layer8b_4k": 16, "layer8b_8k": 17,
                 "train05b": 18, "predict": 19, "eager_llama_o2_bf16": 6,
                 "eager_llama_o2_f16": 20, "eager_o2": 20,
                 # the f16 trainer's B=F32_TRAIN_BATCH S=2048 + LSE
                 "train_f16": 20,
                 # train_p32: train's bf16 B=8 S=2048 + LSE; the f16 MoE
                 # trainer's B=MOE_BATCH S=2048 H=16 + LSE; serve_f16:
                 # B=2 S=512, the top prefill bucket
                 "train_p32": ("train", 3), "train_moe_f16": 20,
                 "serve_f16": 20,
                 # the Transformer's B=96 S=256 H=8 hd=64 non-causal + LSE,
                 # the last case of its path's pool
                 "transformer": -1}},
    # the f32 option of rows 1-5 (TF32 tensor cores, its own source),
    # counted apart: launches_f32 of the wrappers; eager_f32 at B=64
    # S=512 H=12 hd=64 non-causal, train_f32 at B=F32_TRAIN_BATCH S=2048
    # H=32 KV=8 causal, each + LSE (DiT's hd 72 'bhsd' held, no f32 path)
    "flash_attention_fwd_f32": {
        "source": "paddle_tpu_torch/csrc/flash_f32.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:51",
        "option": "f32", "rows": [1],
        # train_moe_f32: B=MOE_BATCH S=2048 H=16 KV=8 + LSE;
        # serve_f32: B=2 S=512
        "main": {"eager_f32": 0, "train_f32": 0, "train_moe_f32": 0,
                 "serve_f32": 0}},
    "flash_attention_bwd_f32": {
        "source": "paddle_tpu_torch/csrc/flash_f32.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:277",
        "also_replaces": ["paddle_tpu/kernels/flash_attention.py:360",
                          "paddle_tpu/kernels/flash_attention.py:446",
                          "paddle_tpu/kernels/flash_attention.py:503"],
        "option": "f32", "rows": [2, 3, 4, 5],
        "main": {"eager_f32": 0, "train_f32": 0, "train_moe_f32": 0}},
    "ragged_paged_attention": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "rows": [18],
        # the decode case; its count takes every launch, of any option;
        # predict: 8 rows of 640 keys in blocks of 64; serve_f16 /
        # serve_f32: the f16 and f32 options' decode (the first case of
        # the path after the 6 bf16 ones)
        "main": {"serve": 0, "serve_prefix": 0, "serve_quant_spec": 0,
                 "serve_robust": 0, "predict": 5, "serve_f16": 6,
                 "serve_f32": 6}},
    # row 18's two options, counted apart: `quantized=True` (int8 pools)
    # held at the int8 decode batch, `suffix=True` (the speculative slab)
    # at the chain verify
    "ragged_paged_attention_int8": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "option": "quantized=True", "rows": [18],
        "main": {"serve_quant_spec": 0, "serve_prefix": 0,
                 "serve_robust": 0, "serve_f16": 3, "serve_f32": 3}},
    "ragged_paged_attention_suffix": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "option": "suffix=True", "rows": [18],
        "main": {"serve_quant_spec": 0, "serve_robust": 0, "serve_f16": 3,
                 "serve_f32": 3}},
    "flash_attention_bwd": {
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:277",
        "also_replaces": ["paddle_tpu/kernels/flash_attention.py:360",
                          "paddle_tpu/kernels/flash_attention.py:446",
                          "paddle_tpu/kernels/flash_attention.py:503"],
        "rows": [2, 3, 4, 5],
        "main": {"train": 0, "train_moe": 2, "eager": 3, "eager_llama": 4,
                 "ernie": 5, "dit": 10, "long8k": 12, "layer8b_4k": 1,
                 "layer8b_8k": 13, "train05b": 14, "eager_llama_o2_bf16": 4,
                 "eager_llama_o2_f16": 15, "eager_o2": 15, "train_f16": 15,
                 "train_p32": ("train", 0), "train_moe_f16": 15,
                 "transformer": -1}},
    "rms_norm_fwd": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:107",
        "rows": [7],
        # long8k's 2 x 8192 rows are the dense step's [16384, 4096]; the
        # f32 and f16 options at [F32_TRAIN_BATCH * 2048, 4096], f32 weight
        "main": {"train": 0, "train_moe": 1, "long8k": 0, "layer8b_4k": 3,
                 "layer8b_8k": 2, "train05b": 4, "train_f32": 5,
                 "train_f16": 5, "train_p32": 5, "train_moe_f32": 5,
                 "train_moe_f16": 5}},
    "rms_norm_bwd": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:115",
        "rows": [8],
        "main": {"train": 0, "train_moe": 1, "long8k": 0, "layer8b_4k": 3,
                 "layer8b_8k": 2, "train05b": 4, "train_f32": 5,
                 "train_f16": 5, "train_p32": 5, "train_moe_f32": 5,
                 "train_moe_f16": 5}},
    "adamw_q": {
        "source": "paddle_tpu_torch/csrc/adamw_q.cu",
        "replaces": "paddle_tpu/optimizer/quant_state.py:227",
        "rows": [17],
        # the largest leaves: [11, 4096, 9472]; [12, 16, 2048, 1024];
        # long8k trains the dense step's tree; the f32 option over
        # train_p32's and train_moe_f32's trees, the f16 over
        # train_moe_f16's [2, 16, 2048, 1024]
        "main": {"train": 0, "train_moe": 0, "long8k": ("train", 0),
                 "train_p32": 0, "train_moe_f32": 0, "train_moe_f16": 0}},
    "gather_wsum": {
        "source": "paddle_tpu_torch/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:244",
        "rows": [14],
        # the combine forward, k=2; its f32 and f16 options
        "main": {"train_moe": 1, "train_moe_f32": 1, "train_moe_f16": 1}},
    "gather_scale_dot": {
        "source": "paddle_tpu_torch/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:348",
        "rows": [15],
        # the combine backward; its f32 and f16 options
        "main": {"train_moe": 0, "train_moe_f32": 0, "train_moe_f16": 0}},
    "layer_norm_fwd": {
        "source": "paddle_tpu_torch/csrc/layer_norm.cu",
        "replaces": "paddle_tpu/kernels/layer_norm.py:38",
        "rows": [9],
        # f32 [32768, 768] (eager_f32 runs the eager step's f32 form);
        # eager_o2: f16 [32768, 768]
        "main": {"eager": 0, "eager_o2": 0, "eager_f32": ("eager", 0)}},
    "layer_norm_bwd": {
        "source": "paddle_tpu_torch/csrc/layer_norm.cu",
        "replaces": "paddle_tpu/kernels/layer_norm.py:53",
        "rows": [10],
        "main": {"eager": 0, "eager_o2": 0, "eager_f32": ("eager", 0)}},
    "rms_norm_fused": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:28",
        "rows": [6],
        # f32 [4096, 4096]; the O2 runs: bf16 and f16 [4096, 4096]
        "main": {"eager_llama": 0, "eager_llama_o2_bf16": 0,
                 "eager_llama_o2_f16": 0}},
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
        for tag in ("f16", "f32"):
            opt = [c for c in cases[name] if c.get("dtype") == tag]
            keys = _TIMES + ("graph_ms", "max_rel_err", "planted", "path",
                             "bound", "lse_abs_err", "f16_ulps", "ulps",
                             "param_ulps",
                             "step_launches")
            if opt:
                # the option at its first path's shape, then every case
                entry[tag] = {k: opt[0][k] for k in keys if k in opt[0]}
                entry[f"{tag}_cases"] = [{k: c[k] for k in keys if k in c}
                                         for c in opt]
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


_PHASE_SECONDS: dict = {}


def _timed(fn, *args):
    """fn(*args), its wall seconds added to _PHASE_SECONDS[fn's name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        name = fn.__name__.removeprefix("phase_")
        _PHASE_SECONDS[name] = _PHASE_SECONDS.get(name, 0.0) + \
            time.perf_counter() - t0


def main() -> int:
    t0 = time.perf_counter()
    info = _timed(phase_device)
    _, peaks = _peaks(info["kind"])
    _timed(phase_build)
    cases = _timed(phase_kernels, peaks)
    serve = _timed(phase_serve)
    _release()
    serve_prefix = _timed(phase_serve_prefix)
    quant_spec = _timed(phase_serve_quant_spec)
    _release()
    robust = _timed(phase_serve_robust)
    _release()
    serve_f16 = _timed(phase_serve_f16)
    serve_f32 = _timed(phase_serve_f32)
    _release()
    train = _timed(phase_train, peaks)
    _timed(phase_grad_check)
    torch.cuda.empty_cache()
    train_p32 = _timed(phase_train_p32, peaks)
    torch.cuda.empty_cache()
    train_f32 = _timed(phase_train_f32, peaks)
    train_f16 = _timed(phase_train_f16, peaks)
    _timed(phase_grad_check_f32)
    torch.cuda.empty_cache()
    train_moe = _timed(phase_train_moe, peaks)
    _timed(phase_grad_check_moe)
    torch.cuda.empty_cache()
    train_moe_f32 = _timed(phase_train_moe_f32, peaks)
    train_moe_f16 = _timed(phase_train_moe_f16, peaks)
    _timed(phase_grad_check_moe_f32)
    torch.cuda.empty_cache()
    eager = _timed(phase_eager, peaks)
    _timed(phase_grad_check_eager)
    eager_f32 = _timed(phase_eager_f32, peaks)
    eager_llama = _timed(phase_eager_llama, peaks)
    _timed(phase_grad_check_eager_llama)
    llama_o2 = _timed(phase_eager_llama_o2, peaks, eager_llama)
    _timed(phase_grad_check_eager_llama_f16)
    eager_o2 = _timed(phase_eager_o2, peaks)
    ernie = _timed(phase_ernie, peaks)
    _timed(phase_grad_check_ernie)
    dit = _timed(phase_dit, peaks)
    _timed(phase_grad_check_dit)
    generate, tree = _timed(phase_generate, peaks)
    predict = _timed(phase_predict, peaks, tree)
    long8k = _timed(phase_long8k, peaks)
    layer8b = _timed(phase_layer8b, peaks)
    train05b = _timed(phase_train05b, peaks)
    torch.cuda.empty_cache()
    _timed(phase_resnet50, peaks)
    _timed(phase_grad_check_resnet)
    _timed(phase_beam)
    _timed(phase_eager_optim, peaks)
    _timed(phase_grad_check_optim)
    _timed(phase_autograd_check)
    torch.cuda.empty_cache()
    transformer = _timed(phase_transformer, peaks)
    _timed(phase_grad_check_transformer)
    _timed(phase_nn_check)
    runs = {"serve": serve, "serve_prefix": serve_prefix,
            "serve_quant_spec": quant_spec, "serve_robust": robust,
            "train": train,
            "train_moe": train_moe,
            "eager": eager, "eager_llama": eager_llama, "ernie": ernie,
            "dit": dit, "generate": generate, "predict": predict,
            "long8k": long8k, **layer8b, "train05b": train05b,
            **llama_o2, "eager_o2": eager_o2, "eager_f32": eager_f32,
            "train_f32": train_f32, "train_f16": train_f16,
            "train_p32": train_p32, "train_moe_f32": train_moe_f32,
            "train_moe_f16": train_moe_f16, "serve_f16": serve_f16,
            "serve_f32": serve_f32, "transformer": transformer}
    _emit({"phase_seconds": _PHASE_SECONDS,
           "main_s": time.perf_counter() - t0})
    _emit({"kernels": _kernels_line(cases, runs)})
    print(_smi_line(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
