"""A numpy emulation of the f32 flash backward's arithmetic on TF32
tensor cores (csrc/flash_f32.cu), held against an f64 evaluation.

The kernel cannot run here, so this file checks the precision argument
of its header at two shapes: causal [1, 300, 4/1, 72] (GQA 4:1, hd 72,
a length off every tile) and bidirectional [2, 128, 2/1, 128]. It
emulates what the kernel does to each value:

  - the score products S = Q K^T and dP = dO V^T take three TF32 parts
    (hi hi + hi lo + lo hi): the resident side split in registers, the
    streamed side from shared-memory planes, both as hi = rna(x) (to
    nearest with ties away, cvt.rna's rounding) and lo = x - hi; the
    tensor core reads every f32 operand as TF32 by dropping its low 13
    bits, which leaves hi as it is and truncates lo;
  - a tensor-core instruction adds its k8 products exactly and rounds
    its sum toward zero into the f32 accumulator; S chains all of its
    instructions in one accumulator, dP sums each two k8 steps' six parts
    into a fresh tile (DP_GROUP) and adds that to its sum in f32 (rounded
    to nearest, the CUDA cores' add). This model of the accumulation is
    kinder to long groups than the card is (there dq at the causal shape
    read twice as much with groups of four k8 steps as with two, where
    the model sees no change), so the card's own check at that shape
    decides the grouping and this file holds the arithmetic around it;
  - P = exp2(S log2(e) scale - lse log2(e)) and dS = P (dP - dcap)
    scale in f32; the second products (dV += P^T dO, dK += dS^T Q, dQ +=
    dS K) on mma.sync with P and dS rounded to TF32 and the other operand
    its hi plane, one chain of k8 steps over the keys (dQ) or over the
    group's query heads and queries (dK, dV).

Each emulated dq, dk and dv vector is held within F32_TOL of the f64
evaluation, relative to its own scale floored at GRAD_ROW_FLOOR of the
largest vector's, as chip_smoke.py holds the kernel; dP with its lo
parts dropped must read at least ten times the bound at the causal
shape, as the planted controls on the card must.
"""
import numpy as np
import pytest

F32_TOL = 2.5e-3          # chip_smoke.py's bound for the f32 option
GRAD_ROW_FLOOR = 1e-3     # chip_smoke.py's floor of a gradient row
LOG2E = 1.4426950408889634
DP_GROUP = 2              # csrc/flash_f32.cu's kG: k8 steps a fresh dP tile


def rna(x):
    """f32 to TF32, to nearest with ties away from zero (cvt.rna)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc(x):
    """f32 as the tensor core reads it from shared memory: the low 13
    mantissa bits dropped."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = rna(x)
    return hi, x - hi


def rz(x):
    """f64 to f32, rounded toward zero: the accumulator's rounding."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_step(acc, a, b):
    """One tensor-core k8 instruction: acc + a @ b, the products and
    their sum exact, rounded toward zero into f32 (acc None: a fresh
    tile)."""
    prod = np.matmul(a.astype(np.float64), b.astype(np.float64))
    return rz(prod if acc is None else acc.astype(np.float64) + prod)


def score_products(x, y, fresh, lo_parts=True):
    """X Y^T over the last axis, as the kernel's score products: x [...,
    M, hd] split in registers, y [..., N, hd] from hi and lo planes, each
    operand read by the tensor core through its truncation; `fresh`: in
    fresh tiles of DP_GROUP k8 steps (dP), else one chain (S)."""
    xh, xl = (trunc(t) for t in split(x))
    yh, yl = (trunc(t) for t in split(y))
    steps = x.shape[-1] // 8
    acc = tile = None
    for ks in range(steps):
        sl = slice(8 * ks, 8 * ks + 8)
        bh = np.swapaxes(yh[..., sl], -1, -2)
        bl = np.swapaxes(yl[..., sl], -1, -2)
        parts = [(xh[..., sl], bh)]
        if lo_parts:
            parts += [(xh[..., sl], bl), (xl[..., sl], bh)]
        if not fresh:
            for a, b in parts:
                acc = mma_step(acc, a, b)
            continue
        if ks % DP_GROUP == 0:
            tile = None
        for a, b in parts:
            tile = mma_step(tile, a, b)
        if ks % DP_GROUP == DP_GROUP - 1 or ks == steps - 1:
            acc = tile if acc is None else (acc + tile).astype(np.float32)
    return acc


def chain(a, b):
    """a @ b over the middle axis on mma.sync: a rounded to TF32, b a hi
    plane, one chain of k8 steps in order."""
    a, b = rna(a), rna(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for j in range(0, a.shape[-1], 8):
        acc = mma_step(acc, a[..., j:j + 8], b[..., j:j + 8, :])
    return acc


def visible(sq, sk, causal):
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= np.arange(sk)[None] <= np.arange(sq)[:, None] + sk - sq
    return vis


def reference(q, k, v, do, causal):
    """The f64 backward: (dq, dk, dv) with GQA summed over each KV head's
    query heads; also the f64 forward's out and lse. Head-major [H, S,
    hd] arrays."""
    q, k, v, do = (t.astype(np.float64) for t in (q, k, v, do))
    rep = q.shape[0] // k.shape[0]
    ke, ve = np.repeat(k, rep, 0), np.repeat(v, rep, 0)
    scale = q.shape[-1] ** -0.5
    s = np.where(visible(q.shape[1], k.shape[1], causal),
                 q @ np.swapaxes(ke, 1, 2) * scale, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    p = np.exp(s - lse[..., None])
    o = p @ ve
    dp = do @ np.swapaxes(ve, 1, 2)
    ds = p * (dp - (do * o).sum(-1, keepdims=True)) * scale
    dq = ds @ ke
    dk = (np.swapaxes(ds, 1, 2) @ q).reshape(k.shape[0], rep, *k.shape[1:])
    dv = (np.swapaxes(p, 1, 2) @ do).reshape(k.shape[0], rep, *k.shape[1:])
    return (dq, dk.sum(1), dv.sum(1)), o, lse


def emulate(q, k, v, do, o, lse, causal, dp_lo=True):
    """The kernel's backward on f32 inputs ([H, S, hd], the forward's o
    and lse rounded to f32), as the module docstring says."""
    f32 = np.float32
    rep = q.shape[0] // k.shape[0]
    ke, ve = np.repeat(k, rep, 0), np.repeat(v, rep, 0)
    hd = q.shape[-1]
    scale = f32(hd ** -0.5)
    vis = visible(q.shape[1], k.shape[1], causal)
    dcap = (do * o).sum(-1, dtype=f32)[..., None]
    lse2 = (lse * f32(LOG2E)).astype(f32)[..., None]
    s = score_products(q, ke, fresh=False)
    dp = score_products(do, ve, fresh=True, lo_parts=dp_lo)
    p = np.exp2((s * (scale * f32(LOG2E)) - lse2).astype(f32)).astype(f32)
    p = np.where(vis, p, f32(0))
    ds = (p * (dp - dcap) * scale).astype(f32)
    pad = (-k.shape[1]) % 8          # keys past Sk: P = 0, k and v 0
    kp = np.pad(ke, ((0, 0), (0, pad), (0, 0)))
    dq = chain(np.pad(ds, ((0, 0), (0, 0), (0, pad))), kp)
    qpad = (-q.shape[1]) % 8         # queries past Sq: P = dS = 0
    pt = np.pad(np.swapaxes(p, 1, 2), ((0, 0), (0, 0), (0, qpad)))
    dst = np.pad(np.swapaxes(ds, 1, 2), ((0, 0), (0, 0), (0, qpad)))
    dop = np.pad(do, ((0, 0), (0, qpad), (0, 0)))
    qp = np.pad(q, ((0, 0), (0, qpad), (0, 0)))

    def group(a, b):
        # a KV head's query heads one after another in one chain
        h, n, m = a.shape
        a = a.reshape(h // rep, rep, n, m).transpose(0, 2, 1, 3) \
            .reshape(h // rep, n, rep * m)
        b = b.reshape(h // rep, rep * m, b.shape[-1])
        return chain(a, b)

    return dq, group(dst, qp), group(pt, dop)


def rel_err(out, ref):
    d = np.abs(out - ref).max(-1)
    r = np.abs(ref).max(-1)
    r = np.maximum(r, GRAD_ROW_FLOOR * r.max())
    return float((d / r).max())


SHAPES = {"causal_300_gqa4_hd72": (300, 4, 1, 72, True),
          "bidir_128_gqa2_hd128": (128, 2, 1, 128, False)}


def _case(name, batch):
    S, H, KV, hd, causal = SHAPES[name]
    rng = np.random.default_rng(19)
    out = []
    for _ in range(batch):
        q = rng.standard_normal((H, S, hd)).astype(np.float32)
        k, v = (rng.standard_normal((KV, S, hd)).astype(np.float32)
                for _ in range(2))
        do = rng.standard_normal((H, S, hd)).astype(np.float32)
        ref, o, lse = reference(q, k, v, do, causal)
        out.append((q, k, v, do, o.astype(np.float32),
                    lse.astype(np.float32), causal, ref))
    return out


@pytest.mark.parametrize("name,batch", [("causal_300_gqa4_hd72", 1),
                                        ("bidir_128_gqa2_hd128", 2)])
def test_emulated_backward_within_f32_tol(name, batch):
    """dq, dk and dv of the emulated kernel within F32_TOL of f64 per
    (position, head) vector, every batch row."""
    for q, k, v, do, o, lse, causal, ref in _case(name, batch):
        got = emulate(q, k, v, do, o, lse, causal)
        for what, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = rel_err(a, r)
            assert err <= F32_TOL, (name, what, err)


def test_dp_lo_parts_dropped_reads_ten_times_the_bound():
    """The planted control: dP on one TF32 part (its lo parts dropped)
    moves dq at the causal shape's first rows, where dP - dcap cancels,
    by at least ten times F32_TOL."""
    (q, k, v, do, o, lse, causal, ref), = _case("causal_300_gqa4_hd72", 1)
    dq, _, _ = emulate(q, k, v, do, o, lse, causal, dp_lo=False)
    assert rel_err(dq, ref[0]) >= 10 * F32_TOL
