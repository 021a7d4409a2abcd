"""Rows 6, 7, 8, 10, 11, 12, 16 and 18 of PERF.md's kernel table (the
eager fused RMSNorm, the RMSNorm training forward and backward, the
LayerNorm backward, the adaLN forward and backward, the gather fused
into the MoE expert products and ragged paged attention) at every shape
`chip_smoke.py` holds them, on one GPU.

    python -m paddle_tpu_torch.tools.bench_kernels [--check]
        [--rows 6,7,8,10,11,12,16,18] [--label L] [--dtype bf16|f16|f32]

For each held shape one JSON line: the kernel's error against its plain
version, whether two calls give identical bits, and its times two ways.
`ms` has the host in the loop: CUDA events around calls made one after
another (for rows 18, 10, 11, 12 and 16 with the L2 cache flushed before
each call, outside the timed span), as `chip_smoke.py` times kernels.
`graph_ms` is device time: the calls captured in one CUDA graph and
replayed; row 18's calls rotate over copies of the pools that together
exceed twice the 50 MB L2, so each call finds its K and V cold, as a
decode step's layers do. Beside them: the bound (bytes over 3.35 TB/s or
operations over the peak rate, the larger) and its share of each time;
for rows 6 and 7 also `F.rms_norm`'s times (row 6: the weight cast to x's
dtype outside the timed span, as ATen's fused RMSNorm takes one dtype).
Row 6's shapes: the eager Llama's [4096, 4096] in f32 (its weight f32),
bf16 and f16 (weights in x's dtype, the O2 runs' form) and bf16 with an
f32 weight; bf16 [16384, 4096]; 4099 rows of D 776 in f32 and
affine-free bf16; affine-free f32 [4096, 4096]; its host-in-loop times
with the L2 flushed before each call. Row 18's shapes (Llama-3-8B widths:
H 32, KV 8, hd 128, bs 16, a 64-block table): decode (8 rows, live
1..1024 keys, one all-invalid), fused (those rows padded to 256 plus a
prefill row), continue (64 queries at 512..575), full8 and full32 (8 and
32 decode rows of 1024 live keys each); decode, fused and full32 again
over int8 twins of the pools (one scale a block); and the suffix slab at
the speculative shapes (8 rows of committed lengths 0..1000): a chain
verify (P = S = 5), a tree verify of [2, 2, 1] (P = S = 11) and a draft
step (P 1, S 4); `--dtype` gives q's, the fp pools' and the slab's
element type (bf16 by default; f16 and f32 held to 1.25e-3 and 2e-5, the
int8 twins' codes under f16 or f32 q). Row 7's and row 8's: the dense
step's [16384, 4096] and the MoE step's [40960, 2048], bf16 x and
weight. Row 10's: the eager ERNIE step's f32 [32768, 768] and the other
forms `chip_smoke.py` holds (bf16, D 4096 and 8192, affine-free, 4099
rows at D 776 and 1032). Rows 11 and 12: DiT-XL/2's [96, 256, 1152]
bf16 and f32 [4, 100, 776], shift and scale in x's dtype. Row 16: T
40960, E 16, M 6400, D 2048, F 1024 at this tool's own draw of the MoE
step's routing (`moe_maps`; its fill and its census of wholly empty,
partly filled and full 64-slot blocks are printed) and with every slot
filled (random tokens), beside the three PyTorch calls `chip_smoke.py`
times (an index gather, two `torch.bmm`).

Rows 8, 10 and 12 also report the one ATen call that computes the same
backward (row 12: the norm alone), timed the same two ways
(`library_ms`, `library_graph_ms`; row 12 `library_norm_only_*`): row 10
`aten.native_layer_norm_backward` on the statistics of ATen's own
forward (the weight cast to x's dtype outside the timed span), row 12
the same without weight at [B·N, D], row 8
`aten._fused_rms_norm_backward` on `aten._fused_rms_norm`'s rstd. And
the profiler's device time of each kernel of one wrapper call, over calls
replayed from one CUDA graph: `walk_ms` (the row walk), `fold_ms` (the
launch that folds the column-sum partial rows), `other_ms` (any other
launch of the call, such as a cast) and `fold_tail_ms`, the time from
the walk's end to the fold's end, which is what the fold adds to the
call when the two overlap. Row 11 stands beside `F.layer_norm` (the norm
alone).

`--check` runs small and odd shapes instead (no timing): row 18 in bf16,
f16 and f32 (q, the fp pool and the slab in that dtype; held to 2e-2,
1.25e-3 and 2e-5) at hd 64 and 128, GQA groups 1 to 32, P 1, 3 and 40,
block sizes 16 and 48, random live lengths with invalid rows, each over
the fp pool, the int8 pool (a never-written block of scale 0 among them)
and with slabs of 1, 7 and 64 rows of random visibility, and wide
batches again with only each row's first query valid; row 6 at the
widths of row 7's checks in f32, bf16 and f16 x, with weights in x's
dtype, f32 or bf16 and affine-free; rows 7 and 8 at widths off the
warp's round and up to 8192, bf16, f32 and f16 weights, 1 to 4099 rows;
row 10 at D 8 to 8192, f32 and bf16, affine and affine-free, 1 to 4099
rows; row 12 at B 1 to 5, N 1, 7 and 257, bf16 D 772 (8-byte vectors),
1152 and 1536 and f32 D 776; row 16 at M off the 128-slot tile (1, 64,
131, 200, 320, 700), D 8 to 2048 (520 off the 64-column step), F 8 to
1024 (776 off the 128-column tile), an expert with every slot empty and
one with every slot filled, token T - 1 among the slots. It exits 1 if
any case is out of tolerance (2e-2 of each output vector's scale; f32
LayerNorm and adaLN dx 1e-5; an f32 dw, db, dscale or dshift 1e-4 of
its largest value, a dw rounded to bf16 or f16 2e-2; row 16's empty
slots exactly 0 and xin bit for bit) or not bit-identical twice.

The file uses only the wrappers' public functions and their plain
versions, so the same file times an older checkout of the package (run
it from that checkout's root) in turns with this one on one card. The
last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

from .bench_flash import _graph_ms, _rel

TOL = 2e-2
PEAK_FLOPS, PEAK_BYTES, PEAK_F32 = 989e12, 3.35e12, 67e12
L2_BYTES = 50e6
H, KV, HD, BS, M = 32, 8, 128, 16, 64
RAGGED_KINDS = ("decode", "fused", "continue", "full8", "full32")
RMS_SHAPES = ((16384, 4096, 1e-5), (40960, 2048, 1e-6))
_F32, _BF16 = torch.float32, torch.bfloat16
# row 10 as chip_smoke.py holds it: (rows, D, dtype, affine), the eager
# ERNIE step's form first
LN_SHAPES = ((32768, 768, _F32, True), (32768, 768, _BF16, True),
             (8192, 4096, _BF16, True), (8192, 4096, _F32, True),
             (4096, 8192, _BF16, False), (4096, 8192, _F32, True),
             (32768, 768, _F32, False), (4099, 776, _BF16, True),
             (4099, 1032, _F32, False))
LN_F32_TOL, LN_SUM_TOL = 1e-5, 1e-4
ROWS = (6, 7, 8, 10, 11, 12, 16, 18)
# row 6 as chip_smoke.py holds it: (rows, D, x dtype, weight dtype or
# None for affine-free)
_F16 = torch.float16
ROW6_SHAPES = ((4096, 4096, _F32, _F32), (4096, 4096, _BF16, _BF16),
               (4096, 4096, _F16, _F16), (4096, 4096, _BF16, _F32),
               (16384, 4096, _BF16, _BF16), (4099, 776, _F32, _F32),
               (4099, 776, _BF16, None), (4096, 4096, _F32, None))
ROW6_TOLS = {_F32: 1e-5, _BF16: TOL, _F16: 1.25e-3}
# rows 11 and 12 as chip_smoke.py holds them: DiT-XL/2's [96, 256, 1152]
# bf16 and an f32 width off the warp's round
ADALN_SHAPES = ((96, 256, 1152, _BF16), (4, 100, 776, _F32))
ADALN_F32_TOL = 1e-5
GRAD_ROW_FLOOR = 1e-3


def time_ms(fn, iters, flush=None):
    """Mean time of fn() with the host in the loop (CUDA events), after
    one warm-up call; with `flush`, run before each call outside its
    timed span."""
    fn()
    torch.cuda.synchronize()
    if flush is None:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters
    pairs = []
    for _ in range(iters):
        flush()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(flops, nbytes, flops_peak=PEAK_FLOPS):
    """The least time for the work, ms, and what bounds it."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# --------------------------------------------------------------- row 18
def ragged_batch(kind, h, kv, hd, bs, m, gen, seed=0, dtype=_BF16):
    """Row 18's inputs at a held shape:
      decode   — 8 rows of 1 query, live lengths 1..1024 with block-size
                 boundaries, one all-invalid row;
      fused    — those 8 decode rows padded to a 256-wide prefill row,
                 only column 0 valid, positions clamped as the fused step
                 clamps them, plus the prefill row;
      continue — one row continuing a chunked prefill: 64 queries at
                 positions 512..575 over a 36-block chain, the diagonal
                 crossing its last 4 blocks;
      full8, full32 — 8 or 32 decode rows, every one with m * bs live
                 keys.
    Returns (q, k_pool, v_pool, table, positions, valid) on the card, q
    and the pools in `dtype`, and the numpy positions and validity."""
    dev = "cuda"
    maxpos = m * bs - 1
    if kind == "continue":
        pos = 512 + np.arange(64, dtype=np.int32)[None]
        val = np.ones(pos.shape, np.bool_)
    elif kind.startswith("full"):
        pos = np.full((int(kind[4:]), 1), maxpos, np.int32)
        val = np.ones(pos.shape, np.bool_)
    else:
        P = 1 if kind == "decode" else 256
        lengths = [1, bs, bs + 1, 2 * bs, 300, 511, m * bs, 0]
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
    rng = np.random.RandomState(seed)
    N = int(need.sum()) + 8
    perm = list(rng.permutation(N))
    table = np.zeros((R, m), np.int32)
    for r, n in enumerate(need):
        table[r, :n] = [perm.pop() for _ in range(n)]
    kp = torch.randn(N, bs, kv, hd, device=dev, generator=gen).to(dtype)
    vp = torch.randn(N, bs, kv, hd, device=dev, generator=gen).to(dtype)
    q = torch.randn(R, P, h, hd, device=dev, generator=gen).to(dtype)
    t = [torch.from_numpy(a).to(dev) for a in (table, pos, val)]
    return (q, kp, vp, *t), (pos, val)


def ragged_work(pos, val, h, kv, hd, bs, opts=None, esize=2):
    """(flops, bytes) this data needs: each row's live K and V once (keys
    up to its largest valid position; an int8 pool's codes and each live
    block's two scales), q of valid queries, every output row, the table
    entries, positions and validity the walk reads; with a slab, its K
    and V rows, the visibility bytes and the products with the slab rows
    each valid query sees. `esize`: the bytes of q's (and an fp pool's
    and the slab's) element."""
    opts = opts or {}
    R, P = pos.shape
    live = np.where(val, pos + 1, 0).max(axis=1)
    blocks = int(np.ceil(live / bs).sum())
    q8 = opts.get("k_scale") is not None
    nbytes = ((2 if q8 else 2 * esize) * kv * hd * int(live.sum())
              + esize * h * hd * (int(val.sum()) + R * P)
              + (12 if q8 else 4) * blocks + 5 * R * P)
    keys = float(np.where(val, pos + 1, 0).sum())
    if opts.get("suffix_k") is not None:
        S = opts["suffix_k"].shape[1]
        nbytes += 2 * esize * R * S * kv * hd + R * P * S
        vis = opts["suffix_vis"].cpu().numpy() & val[:, :, None]
        keys += float(vis.sum())
    return 4.0 * h * hd * keys, nbytes


def quantize_pools(kp, vp, zero_blocks=0):
    """int8 twins of bf16 pools as the commit write stores them: one
    scale a block (its abs-max / 127) and the codes under it. The first
    `zero_blocks` blocks are never-written ones (codes 0, scale 0).
    Returns (k codes, v codes, {"k_scale": .., "v_scale": ..})."""
    from paddle_tpu_torch.quantization import kv as kvq
    out = []
    for p in (kp, vp):
        sc = kvq.scale_of(p.float().abs().amax(dim=(1, 2, 3)))
        sc[:zero_blocks] = 0.0
        codes = kvq.quantize(p.float(), sc[:, None, None, None])
        out.append((codes, sc))
    return out[0][0], out[1][0], {"k_scale": out[0][1],
                                  "v_scale": out[1][1]}


def tree_vis(tree):
    """The ancestor-or-self mask of a packed draft tree (branching
    `tree`, serving.speculative's layout), [S, S] bool numpy."""
    from paddle_tpu_torch.serving.speculative import SpecConfig
    return np.array(SpecConfig(tree=tree).ancestor_mask(), np.bool_)


# the speculative paths' slab shapes at serve_quant_spec's sizes: the
# chain verify of spec_k 4 (P = S = 5, the causal triangle), the tree
# verify of [2, 2, 1] (P = S = 11, the ancestor mask) and a chain draft
# step (P 1 of a 4-row slab, at its second row)
SPEC_KINDS = ("verify_chain", "verify_tree", "draft")


def ragged_spec_batch(kind, h, kv, hd, bs, m, gen, seed=0, dtype=_BF16):
    """Row 18's suffix-slab inputs at a speculative shape: 8 rows whose
    committed lengths are 1..1000 keys and 0 (an inactive slot, which
    sees only the slab), every query valid at position base_len - 1 (the
    pool is read-only; the slab holds the call's own rows). Returns the
    batch as `ragged_batch` does (q, the pools and the slab in `dtype`),
    and the options (slab and visibility)."""
    dev = "cuda"
    base = np.array([1, bs, bs + 1, 2 * bs, 300, 511, 1000, 0], np.int32)
    R = len(base)
    if kind == "verify_chain":
        P = S = 5
        vis = np.tril(np.ones((S, S), np.bool_))
    elif kind == "verify_tree":
        vis = tree_vis([2, 2, 1])
        P = S = vis.shape[0]
    else:
        # draft step 1 of 4: its own row and the root's
        P, S = 1, 4
        vis = np.arange(S)[None] <= 1
    pos = np.repeat(base[:, None] - 1, P, axis=1)
    val = np.ones((R, P), np.bool_)
    need = -(-np.maximum(base, 1) // bs)
    rng = np.random.RandomState(seed)
    N = int(need.sum()) + 8
    perm = list(rng.permutation(N))
    table = np.zeros((R, m), np.int32)
    for r, n in enumerate(need):
        table[r, :n] = [perm.pop() for _ in range(n)]
    kp = torch.randn(N, bs, kv, hd, device=dev, generator=gen).to(dtype)
    vp = torch.randn(N, bs, kv, hd, device=dev, generator=gen).to(dtype)
    q = torch.randn(R, P, h, hd, device=dev, generator=gen).to(dtype)
    t = [torch.from_numpy(a).to(dev) for a in (table, pos, val)]
    opts = {"suffix_k": torch.randn(R, S, kv, hd, device=dev,
                                    generator=gen).to(dtype),
            "suffix_v": torch.randn(R, S, kv, hd, device=dev,
                                    generator=gen).to(dtype),
            "suffix_vis": torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(vis, (R, P, S)))
            ).to(dev)}
    return (q, kp, vp, *t), (pos, val), opts


def ragged_case(args, pos, val, label, timed=True, flush=None, opts=None,
                tol=TOL):
    """Row 18 against its plain version at one batch, twice, within `tol`
    (TOL in bf16); then times. `opts`: the int8 pool's scales and / or
    the slab, passed to both."""
    from paddle_tpu_torch.nlp import ragged_attention as ra
    opts = opts or {}
    q, kp = args[0], args[1]
    out = ra.ragged_paged_attention(*args, **opts)
    again = ra.ragged_paged_attention(*args, **opts)
    ref = ra.ragged_paged_attention_ref(*args, **opts)
    valid = args[5]
    # a query head whose reference is exactly zero (its keys all in
    # never-written int8 blocks of scale 0) has no scale to be relative
    # to: it must be exactly zero
    scale = ref.float().abs().amax(-1)
    held = valid[:, :, None] & (scale > 0)
    res = {"kernel": "ragged_paged_attention", "shape": label,
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "max_rel_err": _rel(out, ref, held),
           "invalid_zero": not (out[~valid] != 0).any().item(),
           "zero_exact": not (out.float().abs().amax(-1)[
               valid[:, :, None] & (scale == 0)] != 0).any().item(),
           "repeat": torch.equal(out, again)}
    res["ok"] = (res["max_rel_err"] <= tol and res["invalid_zero"]
                 and res["zero_exact"] and res["repeat"])
    del out, again, ref
    if not timed:
        return res
    flops, nbytes = ragged_work(pos, val, q.shape[2], kp.shape[2],
                                q.shape[3], kp.shape[1], opts,
                                q.element_size())
    # f32: the f32 function's operations at the card's f32 rate (67
    # TFLOP/s; the kernel computes them in three TF32 parts); 16-bit: the
    # tensor cores
    res.update(bound(flops, nbytes, PEAK_F32 if q.dtype == _F32
                     else PEAK_FLOPS))
    res["ms"] = time_ms(lambda: ra.ragged_paged_attention(*args, **opts), 50,
                        flush)
    pool = 2 * kp.numel() * kp.element_size()
    n = max(1, min(64, math.ceil(2 * L2_BYTES / pool)))
    copies = [args] + [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                       for _ in range(n - 1)]
    turn = itertools.cycle(copies)
    res["graph_ms"] = _graph_ms(
        lambda: ra.ragged_paged_attention(*next(turn), **opts), 60)
    res["pool_copies"] = n
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    del copies
    torch.cuda.empty_cache()
    return res


def ragged_random(R, P, h, kv, hd, bs, m, gen, rng, dtype=_BF16):
    """A random batch: live lengths in [0, m * bs], P queries a row ending
    at its last key (rows shorter than P left-pad as invalid), row 0 all
    invalid, distinct random chains; q and the pools in `dtype`."""
    lengths = rng.randint(1, m * bs + 1, size=R)
    lengths[0] = 0
    pos = np.zeros((R, P), np.int32)
    val = np.zeros((R, P), np.bool_)
    for r, L in enumerate(lengths):
        j = L - P + np.arange(P)
        pos[r] = np.clip(j, 0, m * bs - 1)
        val[r] = (j >= 0) & (L > 0)
    N = R * m + 5
    table = rng.permutation(N)[:R * m].reshape(R, m).astype(np.int32)
    kp = torch.randn(N, bs, kv, hd, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(N, bs, kv, hd, device="cuda", generator=gen).to(dtype)
    q = torch.randn(R, P, h, hd, device="cuda", generator=gen).to(dtype)
    t = [torch.from_numpy(a).to("cuda") for a in (table, pos, val)]
    return (q, kp, vp, *t), (pos, val)


def ragged_front(args, pos, val):
    """The batch with only each row's first query valid, at its row's
    last live key, as a fused step's decode rows padded to the prefill's
    width: wide tiles whose valid queries all lie in their first 16
    rows (the f32 option walks them lean)."""
    live = np.where(val, pos + 1, 0).max(axis=1)
    pos2, val2 = pos.copy(), np.zeros_like(val)
    pos2[:, 0] = np.maximum(live - 1, 0)
    val2[:, 0] = live > 0
    t = [torch.from_numpy(x).to("cuda") for x in (pos2, val2)]
    return (*args[:4], *t), (pos2, val2)


def ragged_options(args, S, q8, gen, rng):
    """The options of one check: int8 twins of the pools (the first block
    never written) and / or a slab of S rows with random visibility
    (about half the rows a query, one query row seeing none) in q's
    dtype."""
    q, kp, vp = args[:3]
    R, P, _, hd = q.shape
    kv = kp.shape[2]
    opts = {}
    if q8:
        kc, vc, opts = quantize_pools(kp, vp, zero_blocks=1)
        args = (q, kc, vc, *args[3:])
    if S:
        vis = rng.rand(R, P, S) < 0.5
        vis[0, 0] = False
        opts.update(
            suffix_k=torch.randn(R, S, kv, hd, device="cuda",
                                 generator=gen).to(q.dtype),
            suffix_v=torch.randn(R, S, kv, hd, device="cuda",
                                 generator=gen).to(q.dtype),
            suffix_vis=torch.from_numpy(vis).to("cuda"))
    return args, opts


# row 18's options by q's dtype and their tolerances (each output
# vector's largest error over its scale): bf16 2.5 ulps of the largest
# element; f16 the same 2.5 ulps (2.5 x 2^-11); f32 in three TF32 parts
# against the plain version's f32 (~1e-6 of the scale; one part ~5e-4)
RAGGED_TOLS = {_BF16: TOL, torch.float16: 1.25e-3, _F32: 2e-5}


def ragged_checks(gen):
    rng = np.random.RandomState(1)
    out = []
    for dtype, tol in RAGGED_TOLS.items():
        for hd in (64, 128):
            for h, kv in ((8, 8), (32, 8), (16, 1), (32, 1)):
                for R, P, bs, m in ((3, 1, 16, 8), (40, 1, 48, 6),
                                    (5, 3, 16, 20), (2, 40, 48, 12)):
                    args, (pos, val) = ragged_random(R, P, h, kv, hd, bs, m,
                                                     gen, rng, dtype)
                    label = (f"R={R} P={P} H={h} KV={kv} hd={hd} bs={bs} "
                             f"M={m} {str(dtype)[6:]}")
                    # the fp pool alone, then the int8 pool, a slab of 1,
                    # 7 or 64 rows over either pool
                    for q8, S in ((False, 0), (True, 0),
                                  (False, 1 + 6 * (R % 2)), (True, 64)):
                        a, opts = ragged_options(args, S, q8, gen, rng)
                        out.append(ragged_case(
                            a, pos, val, f"{label} int8={q8} S={S}",
                            timed=False, opts=opts, tol=tol))
                    if P * h // kv > 16:
                        # wide tiles with only their first rows valid
                        fa, (fpos, fval) = ragged_front(args, pos, val)
                        for q8, S in ((False, 0), (True, 7)):
                            a, opts = ragged_options(fa, S, q8, gen, rng)
                            out.append(ragged_case(
                                a, fpos, fval, f"{label} first query "
                                f"int8={q8} S={S}", timed=False, opts=opts,
                                tol=tol))
    return out


# ---------------------------------------------------------------- row 7
def rms_case(rows, d, eps, gen, w_dtype=torch.bfloat16, timed=True):
    """Row 7 against its plain twin at [rows, d] (bf16 x), twice; then
    times beside F.rms_norm's."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    x = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(w_dtype)
    out, rstd = rn.rms_norm_fwd(x, w, eps)
    out2, rstd2 = rn.rms_norm_fwd(x, w, eps)
    rout, rrstd = rn._rms_fwd_twin(x, w, eps)
    res = {"kernel": "rms_norm_fwd",
           "shape": f"rows={rows} D={d} w={str(w_dtype)[6:]}",
           "max_abs_err": (out.float() - rout.float()).abs().max().item(),
           "max_rel_err": _rel(out, rout),
           "rstd_rel_err": ((rstd - rrstd).abs() / rrstd).max().item(),
           "repeat": torch.equal(out, out2) and torch.equal(rstd, rstd2)}
    res["ok"] = (res["max_rel_err"] <= TOL and res["rstd_rel_err"] <= 1e-5
                 and res["repeat"])
    if not timed:
        return res
    res.update(bound(4.0 * rows * d, 4.0 * rows * d + 2.0 * d + 4.0 * rows,
                     PEAK_F32))
    res["ms"] = time_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20)
    res["graph_ms"] = _graph_ms(lambda: rn.rms_norm_fwd(x, w, eps), 20)
    res["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), w, eps), 20)
    res["library_graph_ms"] = _graph_ms(
        lambda: F.rms_norm(x, (d,), w, eps), 20)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    return res


def row6_case(rows, d, dtype, w_dtype, gen, flush=None, timed=True):
    """Row 6 against its plain version `rms_norm_ref` at [rows, d] (x in
    `dtype`, a weight in `w_dtype` or None), per row within ROW6_TOLS,
    twice; then times beside F.rms_norm's."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as rn
    eps = 1e-5
    x = (torch.randn(rows, d, device="cuda", generator=gen) + 0.3).to(dtype)
    w = None if w_dtype is None else \
        (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(w_dtype)
    out = rn.rms_norm_fused(x, w, eps)
    again = rn.rms_norm_fused(x, w, eps)
    ref = rn.rms_norm_ref(x, w, eps)
    res = {"kernel": "rms_norm_fused",
           "shape": f"rows={rows} D={d} {str(dtype)[6:]} "
                    + ("affine-free" if w is None else f"w={str(w_dtype)[6:]}"),
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "max_rel_err": _rel(out, ref), "repeat": torch.equal(out, again)}
    res["ok"] = res["max_rel_err"] <= ROW6_TOLS[dtype] and res["repeat"]
    if not timed:
        return res
    es = x.element_size()
    res.update(bound(4.0 * rows * d, 2.0 * es * rows * d
                     + (0 if w is None else w.element_size() * d),
                     PEAK_F32))
    wl = None if w is None else w.to(dtype)

    def call():
        return rn.rms_norm_fused(x, w, eps)

    def lib():
        return F.rms_norm(x, (d,), wl, eps)

    res["ms"] = time_ms(call, 20, flush)
    res["graph_ms"] = _graph_ms(call, 20)
    res["library_ms"] = time_ms(lib, 20, flush)
    res["library_graph_ms"] = _graph_ms(lib, 20)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    return res


def row6_checks(gen):
    out = []
    for rows, d in ((1, 8), (7, 776), (4099, 1024), (4099, 2056),
                    (333, 4096), (65, 6144), (4099, 8192)):
        for dt, wdt in ((_F32, _F32), (_F32, _BF16), (_BF16, _BF16),
                        (_BF16, _F32), (_F16, _F16), (_F16, _F32),
                        (_BF16, None), (_F32, None)):
            out.append(row6_case(rows, d, dt, wdt, gen, timed=False))
    return out


def rms_checks(gen):
    out = []
    for rows, d in ((1, 8), (7, 776), (4099, 1024), (4099, 2056),
                    (333, 4096), (65, 6144), (4099, 8192)):
        for wdt in (torch.bfloat16, torch.float32, torch.float16):
            out.append(rms_case(rows, d, 1e-6, gen, wdt, timed=False))
    return out


# ------------------------------------------------------- rows 8 and 10
def kernel_split(fn, iters, walk_mark, fold_mark):
    """Device time of each kernel of one fn() (torch.profiler over one
    replay of `iters` calls captured in a CUDA graph, so no host gap
    separates them): the row walk's, the fold's, the rest's, and the
    mean time from a walk's end to the next fold's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()                              # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    del graph
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    us, tails, walk_end = defaultdict(float), [], None
    for e in evs:
        dur = e.time_range.end - e.time_range.start
        if fold_mark in e.name:
            us["fold"] += dur
            if walk_end is not None:
                tails.append(e.time_range.end - walk_end)
        elif walk_mark in e.name:
            us["walk"] += dur
            walk_end = e.time_range.end
        else:
            us["other"] += dur
    out = {f"{k}_ms": us[k] / iters / 1e3 for k in ("walk", "fold", "other")}
    out["fold_tail_ms"] = (sum(tails) / len(tails) / 1e3 if tails
                           else None)
    return out


def rms_library(x, w, dy, eps):
    """The one ATen call for the RMSNorm backward: the fused backward on
    the fused forward's rstd."""
    d = x.shape[-1]
    rstd = torch.ops.aten._fused_rms_norm(x, [d], w, eps)[1]
    return lambda: torch.ops.aten._fused_rms_norm_backward(
        dy, x, [d], rstd, w, [True, True])


def rms_bwd_case(rows, d, eps, gen, w_dtype=torch.bfloat16, timed=True):
    """Row 8 against its plain twin at [rows, d] (bf16 x and dy), twice;
    then times beside the ATen backward's."""
    from paddle_tpu_torch.kernels import rms_norm as rn
    x = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(w_dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    _, rstd = rn.rms_norm_fwd(x, w, eps)
    dx, dw = rn.rms_norm_bwd(x, w, rstd, dy, eps)
    dx2, dw2 = rn.rms_norm_bwd(x, w, rstd, dy, eps)
    rdx, rdw = rn._rms_train_ref_bwd(x, w, dy, eps)
    res = {"kernel": "rms_norm_bwd",
           "shape": f"rows={rows} D={d} w={str(w_dtype)[6:]}",
           "max_abs_err": max((dx.float() - rdx.float()).abs().max().item(),
                              (dw.float() - rdw.float()).abs().max().item()),
           "max_rel_err": _rel(dx, rdx),
           "dw_rel_err": ((dw.float() - rdw.float()).abs().max()
                          / rdw.float().abs().max()).item(),
           "dw_dtype": str(dw.dtype)[6:],
           "repeat": torch.equal(dx, dx2) and torch.equal(dw, dw2)}
    # an f32 dw differs from the twin's by the summation order alone
    dw_tol = LN_SUM_TOL if w_dtype == torch.float32 else TOL
    res["ok"] = (res["max_rel_err"] <= TOL and res["dw_rel_err"] <= dw_tol
                 and res["repeat"] and dw.dtype == w.dtype)
    if not timed:
        return res
    # x, dy read, dx written; rstd, w read; dw written
    res.update(bound(9.0 * rows * d, 6.0 * rows * d + 4.0 * rows
                     + 2.0 * w.element_size() * d, PEAK_F32))

    def call():
        return rn.rms_norm_bwd(x, w, rstd, dy, eps)

    res["ms"] = time_ms(call, 20)
    res["graph_ms"] = _graph_ms(call, 20)
    res.update(kernel_split(call, 10, "rms_bwd_kernel", "rms_dw_kernel"))
    lib = rms_library(x, w, dy, eps)
    res["library_ms"] = time_ms(lib, 20)
    res["library_graph_ms"] = _graph_ms(lib, 20)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    return res


def ln_bwd_case(rows, d, dtype, affine, gen, flush=None, timed=True):
    """Row 10 against its plain twin at [rows, d] (x and dy in `dtype`,
    f32 weight or affine-free), at ERNIE's eps 1e-12, twice; then times
    beside `aten.native_layer_norm_backward`'s."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    eps = 1e-12
    x = (torch.randn(rows, d, device="cuda", generator=gen) + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    b = 0.1 * torch.randn(d, device="cuda", generator=gen)
    if not affine:
        w = b = None
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    _, mu, rstd = ln.layer_norm_fwd(x, w, b, eps)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)
    again = ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)
    rdx, rdw, rdb = ln._ln_ref_bwd(x, w, dy, eps, affine)
    sums = max(((a - r).abs().max() / r.abs().max()).item()
               for a, r in ((dw, rdw), (db, rdb)))
    res = {"kernel": "layer_norm_bwd",
           "shape": f"rows={rows} D={d} {str(dtype)[6:]}"
                    + ("" if affine else " affine-free"),
           "max_abs_err": max((dx.float() - rdx.float()).abs().max().item(),
                              (dw - rdw).abs().max().item(),
                              (db - rdb).abs().max().item()),
           "max_rel_err": _rel(dx, rdx), "dwdb_rel_err": sums,
           "repeat": all(torch.equal(a, c)
                         for a, c in zip((dx, dw, db), again))}
    tol = LN_F32_TOL if dtype == torch.float32 else TOL
    res["ok"] = (res["max_rel_err"] <= tol and sums <= LN_SUM_TOL
                 and res["repeat"])
    if not timed:
        return res
    es = x.element_size()
    # x, dy read, dx written; mu, rstd, w read; dw, db written
    res.update(bound(13.0 * rows * d, 3.0 * es * rows * d + 8.0 * rows
                     + 12.0 * d, PEAK_F32))

    def call():
        return ln.layer_norm_bwd(x, w, mu, rstd, dy, eps)

    res["ms"] = time_ms(call, 20, flush)
    res["graph_ms"] = _graph_ms(call, 20)
    res.update(kernel_split(call, 10, "ln_bwd_kernel", "ln_dwdb_kernel"))
    wl = None if w is None else w.to(dtype)
    bl = None if b is None else b.to(dtype)
    _, lmu, lrstd = torch.ops.aten.native_layer_norm(x, [d], wl, bl, eps)

    def lib():
        return torch.ops.aten.native_layer_norm_backward(
            dy, x, [d], lmu, lrstd, wl, bl, [True, affine, affine])

    res["library_ms"] = time_ms(lib, 20, flush)
    res["library_graph_ms"] = _graph_ms(lib, 20)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    return res


def norm_bwd_checks(gen):
    out = []
    for rows, d in ((1, 8), (7, 776), (4099, 136), (4099, 1024),
                    (4099, 2056), (333, 4096), (65, 6144), (4099, 8192)):
        for wdt in (torch.bfloat16, torch.float32, torch.float16):
            out.append(rms_bwd_case(rows, d, 1e-6, gen, wdt, timed=False))
    for rows, d in ((1, 8), (3, 24), (4099, 136), (4099, 776), (7, 1032),
                    (4099, 2056), (333, 4096), (65, 6144), (4099, 8192)):
        for dt in (_F32, _BF16):
            for affine in (True, False):
                out.append(ln_bwd_case(rows, d, dt, affine, gen,
                                       timed=False))
    return out


# ------------------------------------------------------- rows 11 and 12
def adaln_case(B, N, D, dtype, gen, flush=None, timed=True, rows=(11, 12)):
    """Rows 11 and 12 against their plain versions at x [B, N, D] with
    per-sample shift and scale [B, D] in x's dtype (as DiT's modulation
    is), the backward on the forward kernel's mu and rstd and twice; then
    times: row 11 beside `F.layer_norm` (the norm alone), row 12 beside
    `aten.native_layer_norm_backward` at [B·N, D] with no weight (the
    norm alone: no per-sample scale, no dshift or dscale) and with the
    profiler's split of one call (walk, fold or sum, the rest)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import adaln as ad
    x = (torch.randn(B, N, D, device="cuda", generator=gen) + 0.3).to(dtype)
    sh, sc = ((0.1 * torch.randn(B, D, device="cuda", generator=gen))
              .to(dtype) for _ in range(2))
    dy = torch.randn(B, N, D, device="cuda", generator=gen).to(dtype)
    tol = TOL if dtype == _BF16 else ADALN_F32_TOL
    label = f"[{B}, {N}, {D}] {str(dtype)[6:]}"
    out, mu, rstd = ad.adaln_fwd(x, sh, sc)
    out2, mu2, rstd2 = ad.adaln_fwd(x, sh, sc)
    rout, rmu, rrstd = ad._adaln_fwd_twin(x, sh, sc)
    res = []
    if 11 in rows:
        f = {"kernel": "adaln_fwd", "shape": label,
             "max_abs_err": (out.float() - rout.float()).abs().max().item(),
             "max_rel_err": _rel(out, rout),
             "mu_abs_err": (mu - rmu).abs().max().item(),
             "rstd_rel_err": ((rstd - rrstd).abs() / rrstd).max().item(),
             "repeat": all(torch.equal(a, c) for a, c in
                           zip((out, mu, rstd), (out2, mu2, rstd2)))}
        f["ok"] = (f["max_rel_err"] <= tol and f["mu_abs_err"] <= 1e-5
                   and f["rstd_rel_err"] <= 1e-5 and f["repeat"])
        res.append(f)
    if 12 in rows:
        dx, dsh, dsc = ad.adaln_bwd(x, sc, mu, rstd, dy)
        again = ad.adaln_bwd(x, sc, mu, rstd, dy)
        rdx, rdsh, rdsc = ad._adaln_bwd_plain(x, sc, rmu, rrstd, dy)
        sums = max(((a - r).abs().max() / r.abs().max()).item()
                   for a, r in ((dsh, rdsh), (dsc, rdsc)))
        b = {"kernel": "adaln_bwd", "shape": label,
             "max_abs_err": max((a.float() - r.float()).abs().max().item()
                                for a, r in ((dx, rdx), (dsh, rdsh),
                                             (dsc, rdsc))),
             "max_rel_err": _rel(dx, rdx, floor=GRAD_ROW_FLOOR),
             "sums_rel_err": sums,
             "repeat": all(torch.equal(a, c)
                           for a, c in zip((dx, dsh, dsc), again))}
        b["ok"] = (b["max_rel_err"] <= tol and sums <= LN_SUM_TOL
                   and b["repeat"])
        res.append(b)
        del again, rdx
    del out2, rout
    if not timed:
        return res
    es, n = x.element_size(), B * N * D
    for r in res:
        if r["kernel"] == "adaln_fwd":
            # x read, out written; shift/scale read; mu/rstd written
            r.update(bound(10.0 * n, 2.0 * es * n + 2.0 * es * B * D
                           + 8.0 * B * N, PEAK_F32))

            def call():
                return ad.adaln_fwd(x, sh, sc)

            def lib():
                return F.layer_norm(x, (D,), eps=1e-6)
        else:
            # x, dy read, dx written; scale, mu/rstd read; dshift and
            # dscale written (f32)
            r.update(bound(14.0 * n, 3.0 * es * n + es * B * D + 8.0 * B * N
                           + 8.0 * B * D, PEAK_F32))

            def call():
                return ad.adaln_bwd(x, sc, mu, rstd, dy)

            x2, dy2 = x.reshape(B * N, D), dy.reshape(B * N, D)
            _, lmu, lrstd = torch.ops.aten.native_layer_norm(
                x2, [D], None, None, 1e-6)

            def lib():
                return torch.ops.aten.native_layer_norm_backward(
                    dy2, x2, [D], lmu, lrstd, None, None,
                    [True, False, False])

            r.update(kernel_split(call, 10, "adaln_bwd_kernel",
                                  "adaln_bwd_sum_kernel"))
        r["ms"] = time_ms(call, 20, flush)
        r["graph_ms"] = _graph_ms(call, 20)
        r["library_norm_only_ms"] = time_ms(lib, 20, flush)
        r["library_norm_only_graph_ms"] = _graph_ms(lib, 20)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["graph_bound_share"] = r["bound_ms"] / r["graph_ms"]
    return res


def adaln_checks(gen):
    out = []
    for D, dt in ((772, _BF16), (1152, _BF16), (1536, _BF16), (776, _F32)):
        for B, N in ((1, 1), (1, 7), (1, 257), (5, 7), (3, 257)):
            out += adaln_case(B, N, D, dt, gen, timed=False, rows=(12,))
    return out


# --------------------------------------------------------------- row 16
def moe_maps(gen, B=20, S=2048):
    """The slot map of one real routing at the MoE step's shape, as
    chip_smoke.py's `_moe_maps` draws it (its own draws, so its own
    fill): the MoE config's `top_k_routing` of N(0, 1) gate logits plus
    an N(0, 0.5) preference per expert, then `moe._routing_maps`'s
    expert-leading map → idx [E, B·C] int32, the token of each slot (-1
    empty), slot (e, b, c) at e·B·C + b·C + c."""
    from paddle_tpu_torch.nlp import moe
    cfg = moe.MoeConfig.flagship_moe()
    E, k, C = cfg.num_experts, cfg.num_experts_per_tok, cfg.capacity(S)
    logits = (torch.randn(B, S, E, device="cuda", generator=gen)
              + 0.5 * torch.randn(E, device="cuda", generator=gen))
    eidx, slot, probs, valid, _, _ = moe.top_k_routing(logits, k, C)
    inv_tok = moe._routing_maps(eidx, slot, probs, valid, C, E)[2]
    return B * S, inv_tok.reshape(E, -1).contiguous()


def slot_blocks(idx, T, rows=64):
    """How many `rows`-slot blocks of idx [E, M] are wholly empty, partly
    filled and full (a slot past M counts as empty)."""
    E, M = idx.shape
    nb = -(-M // rows)
    v = torch.zeros(E, nb * rows, dtype=torch.bool, device=idx.device)
    v[:, :M] = (idx >= 0) & (idx < T)
    n = v.reshape(E, nb, rows).sum(-1)
    return {"blocks": E * nb, "empty": int((n == 0).sum()),
            "partly": int(((n > 0) & (n < rows)).sum()),
            "full": int((n == rows).sum())}


def random_slots(T, E, M, gen, rng):
    """idx [E, M] with groups of 64 slots filled from the front to random
    depths, expert 0 wholly empty and expert 1 wholly filled (E >= 2),
    random distinct tokens, token T - 1 among them."""
    fill = np.zeros((E, M), bool)
    for e in range(E):
        for g0 in range(0, M, 64):
            n = min(64, M - g0)
            fill[e, g0:g0 + rng.randint(0, n + 1)] = True
    fill[0] = False
    if E > 1:
        fill[1] = True
    tok = rng.randint(0, T, size=(E, M))
    filled = np.argwhere(fill)
    if len(filled):
        tok[tuple(filled[0])] = T - 1
    idx = np.where(fill, tok, -1).astype(np.int32)
    return torch.from_numpy(idx).to("cuda")


def gather_mlp_case(T, idx, D, F, gen, flush=None, timed=True, label=""):
    """Row 16 against its plain version: src [T, D], idx [E, M], wg and
    wu [E, D, F] N(0, 0.02) bf16; g and u within 2e-2 a row over the
    filled slots, empty slots exactly 0, xin bit for bit, twice the same
    bits. Then times beside the three PyTorch calls chip_smoke.py times:
    `x[idx.clamp(min=0)]` and two `torch.bmm` (not the same function:
    they read row 0 for an empty slot)."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    E, M = idx.shape
    x = torch.randn(T, D, device="cuda", generator=gen).bfloat16()
    wg, wu = ((0.02 * torch.randn(E, D, F, device="cuda", generator=gen))
              .bfloat16() for _ in range(2))
    g, u, xin = md.gather_mlp_kernel(x, idx, wg, wu)
    again = md.gather_mlp_kernel(x, idx, wg, wu)
    rg, ru, rxin = md._gather_mlp_ref(x, idx, wg, wu)
    valid = (idx >= 0) & (idx < T)
    read = int(valid.sum())
    res = {"kernel": "gather_mlp",
           "shape": label or f"T={T} E={E} M={M} D={D} F={F}",
           "filled": read, **{f"blocks64_{k}": v for k, v in
                              slot_blocks(idx, T).items()},
           "max_abs_err": max((g.float() - rg.float()).abs().max().item(),
                              (u.float() - ru.float()).abs().max().item()),
           "max_rel_err": max(_rel(g, rg, valid) if read else 0.0,
                              _rel(u, ru, valid) if read else 0.0),
           "empty_zero": not (g[~valid].any().item()
                              or u[~valid].any().item()),
           "xin_exact": torch.equal(xin, rxin),
           "repeat": all(torch.equal(a, c)
                         for a, c in zip((g, u, xin), again))}
    res["ok"] = (res["max_rel_err"] <= TOL and res["empty_zero"]
                 and res["xin_exact"] and res["repeat"])
    del g, u, xin, again, rg, ru, rxin
    if not timed:
        return res
    # both products over the filled slots; the filled slots' rows, the
    # weights, g and u, xin written, idx read
    res.update(bound(4.0 * read * D * F,
                     2.0 * D * read + 4.0 * E * D * F + 4.0 * E * M * F
                     + 2.0 * E * M * D + 4.0 * E * M))

    def call():
        return md.gather_mlp_kernel(x, idx, wg, wu)

    def three():
        xi = x[idx.clamp(min=0)]
        return torch.bmm(xi, wg), torch.bmm(xi, wu)

    res["ms"] = time_ms(call, 10, flush)
    res["graph_ms"] = _graph_ms(call, 10)
    res["three_calls_ms"] = time_ms(three, 10, flush)
    res["three_calls_graph_ms"] = _graph_ms(three, 10)
    res["under_load"] = under_load(call)
    res["three_calls_under_load"] = under_load(three)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    torch.cuda.empty_cache()
    return res


def under_load(fn, seconds=2.0):
    """fn() called back to back for `seconds`: its mean time with the host
    in the loop, and `nvidia-smi`'s SM clock and power draw sampled
    meanwhile (median of the samples), to tell a kernel held back by the
    card's power limit."""
    import threading
    import time
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
            time.sleep(0.1)

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=sample)
    th.start()
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        n += 10
    ms = (time.perf_counter() - t0) / n * 1e3
    stop.set()
    th.join()
    def median(k):
        vals = sorted(x[k] for x in samples)
        return vals[len(vals) // 2] if vals else None

    return {"loop_ms": ms, "sm_mhz": median(0), "power_w": median(1),
            "samples": len(samples)}


def gather_mlp_checks(gen):
    rng = np.random.RandomState(2)
    out = []
    for T, E, M, D, F in ((1000, 3, 200, 520, 776), (4099, 4, 320, 2048,
                                                     1024),
                          (77, 2, 131, 64, 136), (5, 3, 1, 8, 8),
                          (3000, 2, 700, 1032, 200), (64, 5, 64, 128, 128)):
        out.append(gather_mlp_case(T, random_slots(T, E, M, gen, rng), D, F,
                                   gen, timed=False))
    return out


def held(gen, rows=ROWS, dtype=_BF16):
    """Every held shape of the table rows `rows`, timed: rows 18 (q, its
    fp pools and slabs in `dtype`), 10, 11 and 12, 16, 6, 7, then 8."""
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():                          # 256 MB > the 50 MB L2
        scratch.zero_()

    res = []
    tol = RAGGED_TOLS[dtype]
    dt = "" if dtype == _BF16 else f" {str(dtype)[6:]}"
    for kind in RAGGED_KINDS if 18 in rows else ():
        args, (pos, val) = ragged_batch(kind, H, KV, HD, BS, M, gen,
                                        dtype=dtype)
        R, P = pos.shape
        res.append(ragged_case(
            args, pos, val, f"{kind} R={R} P={P} H={H} KV={KV} hd={HD} "
            f"bs={BS} M={M}{dt}", flush=flush, tol=tol))
        if kind in ("decode", "fused", "full32"):
            kc, vc, opts = quantize_pools(args[1], args[2])
            res.append(ragged_case(
                (args[0], kc, vc, *args[3:]), pos, val, f"int8 {kind} R={R} "
                f"P={P} H={H} KV={KV} hd={HD} bs={BS} M={M}{dt}",
                flush=flush, opts=opts, tol=tol))
            del kc, vc, opts
        del args
    for kind in SPEC_KINDS if 18 in rows else ():
        args, (pos, val), opts = ragged_spec_batch(kind, H, KV, HD, BS, M,
                                                   gen, dtype=dtype)
        R, P = pos.shape
        res.append(ragged_case(
            args, pos, val, f"{kind} R={R} P={P} S="
            f"{opts['suffix_k'].shape[1]} H={H} KV={KV} hd={HD} bs={BS} "
            f"M={M}{dt}", flush=flush, opts=opts, tol=tol))
        del args, opts
    for n, d, dt, affine in LN_SHAPES if 10 in rows else ():
        res.append(ln_bwd_case(n, d, dt, affine, gen, flush))
        torch.cuda.empty_cache()
    for B, N, D, dt in ADALN_SHAPES if {11, 12} & set(rows) else ():
        res += adaln_case(B, N, D, dt, gen, flush, rows=rows)
    if 16 in rows:
        T, idx = moe_maps(gen)
        res.append(gather_mlp_case(T, idx, 2048, 1024, gen, flush,
                                   label="the MoE step's routing"))
        # every slot filled: no half-tile to skip, every tile whole
        full = torch.randint(0, T, idx.shape, device="cuda", generator=gen,
                             dtype=torch.int32)
        res.append(gather_mlp_case(T, full, 2048, 1024, gen, flush,
                                   label="every slot filled"))
    for n, d, dt, wdt in ROW6_SHAPES if 6 in rows else ():
        res.append(row6_case(n, d, dt, wdt, gen, flush))
    del scratch
    torch.cuda.empty_cache()
    if 7 in rows:
        res += [rms_case(n, d, eps, gen) for n, d, eps in RMS_SHAPES]
    if 8 in rows:
        res += [rms_bwd_case(n, d, eps, gen) for n, d, eps in RMS_SHAPES]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="table rows to run, of " + ", ".join(map(str, ROWS)))
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f16", "f32"),
                    help="row 18's held shapes: q's, the fp pools' and the "
                         "slab's type")
    args = ap.parse_args(argv)
    dtype = {"bf16": _BF16, "f16": torch.float16, "f32": _F32}[args.dtype]
    rows = tuple(int(r) for r in args.rows.split(","))
    if not set(rows) <= set(ROWS):
        ap.error(f"--rows takes rows of {ROWS}")
    if not torch.cuda.is_available():
        print("bench_kernels: CUDA is not available", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.check:
        cases = ((ragged_checks(gen) if 18 in rows else [])
                 + (row6_checks(gen) if 6 in rows else [])
                 + (rms_checks(gen) if 7 in rows else [])
                 + (norm_bwd_checks(gen) if {8, 10} & set(rows) else [])
                 + (adaln_checks(gen) if 12 in rows else [])
                 + (gather_mlp_checks(gen) if 16 in rows else []))
    else:
        cases = held(gen, rows, dtype)
    ok = True
    for r in cases:
        ok = ok and r["ok"]
        print(json.dumps({"label": args.label, **r}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
