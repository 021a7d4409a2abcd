"""Run the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. device  — requires CUDA; prints the card, its compute capability and
               `nvidia-smi`'s name and power limit; turns TF32 off.
  2. build   — compiles every kernel under paddle_tpu_torch/csrc with nvcc
               (one process per source, in parallel) and times it.
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card, in bf16, at its main path's shapes, against a stated
               tolerance, with times (CUDA events) of the kernel, the
               plain version and, where one exists, a single PyTorch call
               computing the same function, and the bound (the larger of
               bytes over the card's memory rate and operations over its
               peak rate): the flash forward (serving shapes, and the
               training step's B=8 x S=2048 with its LSE), ragged paged
               attention, the flash backward at the training step's
               B=8 x S=2048 and at B=1 x S=4096, the RMSNorm forward and
               backward at the step's [16384, 4096], and the fused 8-bit
               AdamW on a leaf of every size of the trained tree (the
               stacked [11, 4096, 9472] MLP weights down to the final
               [4096] norm).
  4. serve   — a ServingEngine at Llama-3-8B widths (all 32 layers,
               random bf16 weights from a seeded generator) answers 12
               streamed requests with prompts of 16-700 tokens, admissions
               landing mid-decode. Kernel launch counters are zeroed just
               before and read just after; both kernels must have run,
               a fused prefill+decode step must have happened and the KV
               pool must drain. Then one fixed batch (cold prefill,
               continuing chunk, decode) runs through the kernels, their
               plain versions, the plain versions with a planted
               off-by-one fault, and an f32 evaluation: the kernels'
               logits may be no further from f32 than the plain bf16
               path's (within a stated ratio), and the fault must fail
               that same bound.
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

The last lines are the kernels JSON object, the `nvidia-smi` name/power
line and {"ok": true, "device": {...}}. Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import contextlib
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
    _emit({"phase": "build", "seconds": round(secs, 3),
           "sources": _build.sources(), "ptxas": ptxas})


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


def _flash_case(B, S, H, KV, hd, peaks, tol, gen, lse: bool = False):
    """The flash forward against its plain version at one shape; with
    `lse`, as the training forward calls it, its LSE held too."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = "cuda"
    q = torch.randn(B, S, H, hd, device=dev, generator=gen).bfloat16()
    k = torch.randn(B, S, KV, hd, device=dev, generator=gen).bfloat16()
    v = torch.randn(B, S, KV, hd, device=dev, generator=gen).bfloat16()
    out = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=lse)
    ref = fa.flash_attention_fwd_ref(q, k, v, causal=True, return_lse=lse)
    res = {"shape": f"B={B} S={S} H={H} KV={KV} hd={hd}"
                    + (" (LSE)" if lse else "")}
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
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                                 return_lse=lse), 50)
    plain = _time_ms(lambda: fa.flash_attention_fwd_ref(
        q, k, v, causal=True, return_lse=lse), 5)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    pairs = S * (S + 1) // 2                    # causal, Sq == Sk
    flops = 4.0 * B * H * hd * pairs
    # q, k, v in; out (and the f32 LSE) written
    nbytes = 2.0 * B * S * hd * (2 * H + 2 * KV) + (4.0 * B * H * S * lse)
    res.update({"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": plain, "library_ms": lib,
                **_bound(flops, nbytes, peaks)})
    return res


def _ragged_batch(kind, H, KV, hd, bs, M, gen):
    """The ragged kernel's inputs at a main-path shape:
      decode   — 8 rows of 1 query, live lengths 1..1024 with block-size
                 boundaries, one all-invalid row;
      fused    — those 8 decode rows padded to a 256-wide prefill row,
                 only column 0 valid, positions clamped as the fused step
                 clamps them, plus the prefill row;
      continue — one row continuing a chunked prefill: 64 queries at
                 positions 512..575 over a 36-block chain, the diagonal
                 crossing its last 4 blocks."""
    dev = "cuda"
    maxpos = M * bs - 1
    if kind == "continue":
        pos = 512 + np.arange(64, dtype=np.int32)[None]
        val = np.ones(pos.shape, np.bool_)
    else:
        P = 1 if kind == "decode" else 256
        lengths = [1, bs, bs + 1, 2 * bs, 300, 511, M * bs, 0]
        # decode row: the query at position L - 1 sees the row's L keys
        pos = np.stack([np.minimum(max(L - 1, 0) + np.arange(P), maxpos)
                        for L in lengths]).astype(np.int32)
        val = np.zeros(pos.shape, np.bool_)
        val[:, 0] = np.array(lengths) > 0
        if kind == "fused":
            pos = np.concatenate([pos, np.arange(P, dtype=np.int32)[None]])
            val = np.concatenate([val, np.ones((1, P), np.bool_)])
    R, P = pos.shape
    need = -(-np.where(val, pos + 1, 0).max(axis=1) // bs)
    rng = np.random.RandomState(SEED)
    N = int(need.sum()) + 8
    perm = list(rng.permutation(N))
    table = np.zeros((R, M), np.int32)
    for r, n in enumerate(need):
        table[r, :n] = [perm.pop() for _ in range(n)]
    kp = torch.randn(N, bs, KV, hd, device=dev, generator=gen).bfloat16()
    vp = torch.randn(N, bs, KV, hd, device=dev, generator=gen).bfloat16()
    q = torch.randn(R, P, H, hd, device=dev, generator=gen).bfloat16()
    t = [torch.from_numpy(a).to(dev) for a in (table, pos, val)]
    return (q, kp, vp, *t), (pos, val)


def _ragged_case(kind, H, KV, hd, peaks, tol, gen, flush):
    from paddle_tpu_torch.nlp import ragged_attention as ra
    bs, M = 16, 64
    args, (pos, val) = _ragged_batch(kind, H, KV, hd, bs, M, gen)
    out = ra.ragged_paged_attention(*args)
    ref = ra.ragged_paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref, args[5])
    if not rel <= tol:
        raise AssertionError(f"ragged {kind}: relative err {rel} > {tol}")
    if (out[~args[5]] != 0).any().item():
        raise AssertionError(f"ragged {kind}: invalid queries not zero")
    ms = _time_ms(lambda: ra.ragged_paged_attention(*args), 50, flush)
    plain = _time_ms(lambda: ra.ragged_paged_attention_ref(*args), 5, flush)
    R, P = pos.shape
    # what this data needs: each row's live K and V once (keys up to its
    # largest valid position), q of valid queries, every output row, and
    # the table entries, positions and validity the walk reads
    live = np.where(val, pos + 1, 0).max(axis=1)
    kv_bytes = 2 * 2 * KV * hd * int(live.sum())
    nbytes = (kv_bytes + 2 * H * hd * (int(val.sum()) + R * P)
              + 4 * int(np.ceil(live / bs).sum()) + 5 * R * P)
    flops = 4.0 * H * hd * float(np.where(val, pos + 1, 0).sum())
    return {"shape": f"{kind} R={R} P={P} H={H} KV={KV} hd={hd} bs={bs} "
                     f"M={M} live={live.tolist()}",
            "max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain, "library_ms": None,
            **_bound(flops, nbytes, peaks)}


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
# 8-bit AdamW: params within one bf16 ulp (of the larger of the value
# before and after the step) of the plain version, float8
# codes within one e4m3 step of their value, scales to 1e-6 relative, and
# at most 0.1 % of codes different: both versions compute the same f32
# expressions, but the kernel contracts multiply-adds into FMAs, so a
# value within an ulp of a float8 rounding boundary may round either way.
ADAMW_CODE_FRAC = 1e-3


def _sdpa_grad_ms(q, k, v, dout, iters):
    """SDPA's backward alone: forward + backward minus forward, causal,
    enable_gqa (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = dout.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.enable_grad():
        return _time_ms(both, iters) - _time_ms(fwd, iters)


def _flash_bwd_case(B, S, H, KV, hd, peaks, gen):
    """dq, dk, dv from the kernel forward's (out, lse), against the plain
    backward on the same inputs; the kernel must also repeat bit for bit
    (no atomics)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v = (torch.randn(B, S, n, hd, device="cuda", generator=gen)
               .bfloat16() for n in (H, KV, KV))
    dout = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
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
    del again
    ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout),
                  10)
    plain = _time_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, out, lse, dout), 2)
    lib = _sdpa_grad_ms(q, k, v, dout, 5)
    pairs = S * (S + 1) // 2
    # five products over the visible pairs: QK^T again, dO V^T, P^T dO,
    # dS K, dS^T Q; bytes: q, k, v, out, dout, lse in; dq, dk, dv out
    flops = 10.0 * B * H * hd * pairs
    nbytes = 2.0 * B * S * hd * (4 * H + 4 * KV) + 4.0 * B * H * S
    return {"shape": f"B={B} S={S} H={H} KV={KV} hd={hd}",
            "max_abs_err": err, "max_rel_err": max(rel.values()),
            "rel_err": rel, "ms": ms, "plain_ms": plain, "library_ms": lib,
            **_bound(flops, nbytes, peaks)}


def _rms_cases(rows, D, peaks, gen, eps=1e-5):
    """The training norm at [rows, D] (bf16 x, bf16 weight): forward
    (out per row, rstd) and backward (dx per row, dw over D) against the
    plain twins; the backward must repeat bit for bit."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    x = torch.randn(rows, D, device="cuda", generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).bfloat16()
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
    xg = x.detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)

    def lib_fwd():
        return F.rms_norm(xg, (D,), wg, eps)

    def lib_both():
        torch.autograd.grad(lib_fwd(), (xg, wg), dy)

    fwd = {"shape": f"rows={rows} D={D}",
           "max_abs_err": (out.float() - rout.float()).abs().max().item(),
           "max_rel_err": f_rel, "rstd_rel_err": r_rel,
           "ms": _time_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20),
           "plain_ms": _time_ms(lambda: rn._rms_fwd_twin(x, w, eps), 5),
           "library_ms": _time_ms(lambda: F.rms_norm(x, (D,), w, eps), 20),
           **_bound(4.0 * rows * D,
                    2.0 * rows * D * 2 + 2.0 * D + 4.0 * rows, peaks,
                    peaks[2])}
    with torch.enable_grad():
        lib_bwd = _time_ms(lib_both, 10) - _time_ms(lib_fwd, 10)
    bwd = {"shape": f"rows={rows} D={D}",
           "max_abs_err": max((dx.float() - rdx.float()).abs().max().item(),
                              (dw.float() - rdw.float()).abs().max().item()),
           "max_rel_err": max(b_rel, w_rel), "dw_rel_err": w_rel,
           "ms": _time_ms(lambda: rn.rms_norm_bwd(x, w, rstd, dy, eps), 20),
           "plain_ms": _time_ms(
               lambda: rn._rms_train_ref_bwd(x, w, dy, eps), 5),
           "library_ms": lib_bwd,
           **_bound(9.0 * rows * D,
                    3.0 * rows * D * 2 + 4.0 * rows + 2.0 * D * 2, peaks,
                    peaks[2])}
    return fwd, bwd


def _f8_step(c):
    """The spacing of float8 e4m3 values at |c| (codes as f32): 2^(e-3)
    for a normal value of exponent e, 2^-9 below 2^-6."""
    a = c.abs().clamp(min=2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(a)) - 3)


def _adamw_leaves():
    """The leaves of the trained flagship tree (the train phase's
    config), grouped by size: [(shape, names)], largest first. The step
    launches the kernel once per leaf, on the leaf flattened, so leaves
    of one size are the same work."""
    from paddle_tpu_torch.nlp import llama
    shapes = llama._shapes(llama.LlamaConfig.flagship_2b())
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
    leaves of the trained tree that have this size."""
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
                    f"{', '.join(names)})", "leaves": len(names),
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


def phase_kernels(peaks):
    H, KV, hd = 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():                  # 256 MB > the 50 MB L2
        scratch.zero_()

    flash = [_flash_case(2, S, H, KV, hd, peaks, KERNEL_TOL, gen)
             for S in (128, 512, 700)]
    flash.append(_flash_case(8, 2048, H, KV, hd, peaks, KERNEL_TOL, gen,
                             lse=True))
    ragged = [_ragged_case(kind, H, KV, hd, peaks, KERNEL_TOL, gen, flush)
              for kind in ("decode", "fused", "continue")]
    del scratch
    bwd = [_flash_bwd_case(B, S, H, KV, hd, peaks, gen)
           for B, S in ((8, 2048), (1, 4096))]
    rms_f, rms_b = _rms_cases(8 * 2048, 4096, peaks, gen)
    adamw = [_adamw_case(shape, names, peaks, gen)
             for shape, names in _adamw_leaves()]
    cases = {"flash_attention_fwd": flash, "ragged_paged_attention": ragged,
             "flash_attention_bwd": bwd, "rms_norm_fwd": [rms_f],
             "rms_norm_bwd": [rms_b], "adamw_q": adamw}
    _emit({"phase": "kernels", "tol": KERNEL_TOL, "lse_tol": LSE_TOL,
           "rstd_tol": RSTD_TOL, "adamw_code_frac": ADAMW_CODE_FRAC,
           **cases})
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

    def ragged_fault(q, k_pool, v_pool, table, positions, valid=None):
        return ragged(q, k_pool, v_pool, table, (positions - 1).clamp(min=0),
                      valid)

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
        k, v = paged.init_pool(c, B * M, bs, device=dev)
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


def phase_serve(layers: int = 32, n_requests: int = 12):
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.nlp.ragged_attention import ragged_paged_attention
    from paddle_tpu_torch.serving import RequestState, ServingEngine

    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(params, cfg, max_batch=8, block_size=16,
                        max_total_len=1024, max_new_tokens=32,
                        max_prefill_bucket=512, prefix_cache=False,
                        start=True)
    rng = np.random.RandomState(SEED)
    lengths = rng.randint(16, 513, n_requests)
    lengths[[3, 7]] = rng.randint(513, 701, 2)        # chunked prefill
    budgets = [(32, 24, 16)[i % 3] for i in range(n_requests)]
    prompts = [rng.randint(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    try:
        # warm-up: cuBLAS handles and the allocator, outside the counts
        eng.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        flash_attention_fwd.launches = 0
        ragged_paged_attention.launches = 0
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
        launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                    "ragged_paged_attention":
                        ragged_paged_attention.launches}
        peak = torch.cuda.max_memory_allocated()
        snap = eng.snapshot()
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
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} never launched while serving")
    del eng
    torch.cuda.empty_cache()
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
           "peak_memory_bytes": peak, "param_init_s": init_s,
           "launches": launches, "fused_steps": g["fused_steps"],
           "decode_stall_steps": g["decode_stall_steps"],
           "prefill_pad_tokens": g["prefill_pad_tokens"],
           "logits_check": check,
           "logits_vs_f32_ratio_tol": LOGITS_VS_F32_RATIO,
           "nvidia_smi": _smi_line()}
    _emit(res)
    return res


# -------------------------------------------------------------- 5. train
def _train_counters():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.optimizer import quant_state as qs
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rms_norm_fwd": rn.rms_norm_fwd,
            "rms_norm_bwd": rn.rms_norm_bwd,
            "adamw_q": qs.fused_leaf_update}


def phase_train(peaks, warmup: int = 2, timed: int = 4, batch: int = 8,
                seq: int = 2048):
    """The flagship config through the public training entry points."""
    from paddle_tpu_torch.nlp import llama, train

    cfg = llama.LlamaConfig.flagship_2b()
    counters = _train_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tx = train.make_optimizer(1e-4, state_quant="8bit", grad_clip=1.0)
    state = train.init_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, tx)
    step = train.make_train_step(cfg, tx)
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
    fpt = llama.flops_per_token(cfg, seq)
    res = {"phase": "train", "config": "flagship_2b (bench.py:120)",
           "params": llama.num_params(cfg),
           "widths": {"D": cfg.hidden_size, "F": cfg.intermediate_size,
                      "L": cfg.num_hidden_layers,
                      "H": cfg.num_attention_heads,
                      "KV": cfg.num_key_value_heads, "V": cfg.vocab_size},
           "batch": batch, "seq": seq, "steps": steps, "timed_steps": timed,
           "step_ms": dt / timed * 1e3, "tokens_per_s": tok_s,
           "flops_per_token": fpt, "mfu": tok_s * fpt / peaks[0],
           "losses": losses, "grad_norms": norms,
           "peak_memory_bytes": peak, "init_s": init_s,
           "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()},
           "nvidia_smi": _smi_line()}
    _emit(res)
    del state, step, tx, metrics
    torch.cuda.empty_cache()
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} never launched while training")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return res


@contextlib.contextmanager
def _plain_kernels(fault: bool = False):
    """Route the training Functions to the kernels' plain versions on
    CUDA tensors (the reference paths of the gradient check). With
    `fault`, the flash backward also drops dcap = rowsum(dO * O), the
    planted control."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm as rn
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             rn.rms_norm_fwd, rn.rms_norm_bwd)

    def bwd(q, k, v, out, lse, dout, causal=True, scale=None):
        if fault:
            out = torch.zeros_like(out)
        return fa.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                          causal=causal, scale=scale)

    fa.flash_attention_fwd = fa.flash_attention_fwd_ref
    fa.flash_attention_bwd = bwd
    rn.rms_norm_fwd = lambda x, w, eps=1e-6: rn._rms_fwd_twin(x, w, eps)
    rn.rms_norm_bwd = lambda x, w, rstd, dy, eps=1e-6: \
        rn._rms_train_ref_bwd(x, w, dy, eps)
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, rn.rms_norm_fwd,
         rn.rms_norm_bwd) = saved


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
# Gradient tolerance of the kernels: the same argument as the logits
# check's. Both bf16 paths run the same bf16 GEMMs and differ only where
# attention and the norms round, so each group's distance from an f32
# evaluation is that of bf16 evaluation itself; the kernels may be at
# most 1.5x the plain path's.
GRAD_VS_F32_RATIO = 1.5


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
            loss = llama.loss_fn(tree, tokens, c)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            logits = llama.forward(tree, tokens, c)
            tgt = tokens[:, 1:].long()
            nll = (torch.logsumexp(logits[:, :-1], -1)
                   - torch.gather(logits[:, :-1], -1, tgt[..., None])[..., 0])
        del logits
        g = {n: x.float() for n, x in zip(names, grads)}
        return float(loss.detach()), nll.float().reshape(-1), g

    res = {"kernel": run(cfg, params)}
    with _plain_kernels():
        res["ref"] = run(cfg, params)
    with _plain_kernels(fault=True):
        res["fault"] = run(cfg, params)
    p32 = tree_map(lambda t: t.float(), params)
    with _plain_kernels():
        res["f32"] = run(cfg32, p32)
    del params, p32

    def dist(a, b):
        return (torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
                / torch.sqrt(sum((y ** 2).sum() for y in b))).item()

    out = {}
    _, nll32, g32 = res["f32"]
    groups = {"loss": None, **_GRAD_GROUPS}
    for group, keys in groups.items():
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
    _emit({"phase": "grad_check", "layers": layers, "seq": seq,
           "ratio_tol": GRAD_VS_F32_RATIO, "fault_groups": _FAULT_GROUPS,
           **out})
    del res
    torch.cuda.empty_cache()
    for group in groups:
        c = out[group]
        if not c["kernel_ratio"] <= GRAD_VS_F32_RATIO:
            raise AssertionError(
                f"{group} gradients: the kernels are {c['kernel_vs_f32']} "
                f"from f32, more than {GRAD_VS_F32_RATIO} x the plain bf16 "
                f"path's {c['ref_vs_f32']}")
        if group in _FAULT_GROUPS and \
                not c["fault_ratio"] > GRAD_VS_F32_RATIO:
            raise AssertionError(
                f"{group} gradients: the planted dcap fault reads "
                f"{c['fault_ratio']} x the plain path's distance, within "
                f"the {GRAD_VS_F32_RATIO} bound: the check cannot see it")
    return out


# "main": for each path that launches the kernel, the case at that
# path's shape whose times the kernels line reports; the first path's
# also stand at the entry's top level
_KERNELS = {
    "flash_attention_fwd": {
        "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:51",
        # serve: S=512, the top prefill bucket; train: B=8 S=2048 + LSE
        "main": {"serve": 1, "train": 3}},
    "ragged_paged_attention": {
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/nlp/ragged_attention.py:89",
        "main": {"serve": 0}},            # the decode case
    "flash_attention_bwd": {
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:277",
        "also_replaces": ["paddle_tpu/kernels/flash_attention.py:360",
                          "paddle_tpu/kernels/flash_attention.py:446",
                          "paddle_tpu/kernels/flash_attention.py:503"],
        "main": {"train": 0}},            # B=8 S=2048: the step's shape
    "rms_norm_fwd": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:107",
        "main": {"train": 0}},
    "rms_norm_bwd": {
        "source": "paddle_tpu_torch/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/kernels/rms_norm.py:115",
        "main": {"train": 0}},
    "adamw_q": {
        "source": "paddle_tpu_torch/csrc/adamw_q.cu",
        "replaces": "paddle_tpu/optimizer/quant_state.py:227",
        "main": {"train": 0}},            # the [11, 4096, 9472] leaves
}
_TIMES = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    info = phase_device()
    _, peaks = _peaks(info["kind"])
    phase_build()
    cases = phase_kernels(peaks)
    serve = phase_serve()
    torch.cuda.empty_cache()
    train = phase_train(peaks)
    phase_grad_check()
    runs = {"serve": serve, "train": train}
    kernels = []
    for name, meta in _KERNELS.items():
        by_path = {}
        for path, i in meta["main"].items():
            by_path[path] = {"launches": runs[path]["launches"][name],
                             **{k: cases[name][i][k] for k in _TIMES}}
        if all("leaves" in c for c in cases[name]):
            # one launch per leaf: the times of a whole step's leaves
            by_path["train"]["per_step"] = {
                k: sum(c[k] * c["leaves"] for c in cases[name])
                for k in ("ms", "plain_ms", "bound_ms")}
        top = next(iter(by_path.values()))
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": sum(r["launches"] for r in by_path.values()),
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "max_rel_err": max(c["max_rel_err"] for c in cases[name]),
            **{k: top[k] for k in _TIMES}, "kernel_ms": top["ms"],
            "by_path": by_path}
        if "also_replaces" in meta:
            entry["also_replaces"] = meta["also_replaces"]
        kernels.append(entry)
    _emit({"kernels": kernels})
    print(_smi_line(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
