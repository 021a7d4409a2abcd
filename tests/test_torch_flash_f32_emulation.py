"""A numpy emulation of the f32 flash kernels' arithmetic on TF32 tensor
cores (csrc/flash_f32.cu), backward and forward, and of ragged paged
attention's f32 option (csrc/ragged_paged_attention.cu), each held
against an f64 evaluation.

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

The forward (`emulate_forward`), at the same two shapes: S = Q K^T in
three parts chained in one accumulator (Q split in registers and K's
raw tile read as its hi part, both hi = trunc(x), and K's lo plane
k - trunc(k)), the
online softmax over 64-key tiles in f32,
P rounded to TF32 and O += P V on one chain of k8 instructions against
V rounded (the kernel's V^T); each output vector within F32_TOL of its
scale and the LSE within F32_LSE_TOL of the f64 one (~2e-6), and K's
lo plane dropped reading above F32_LSE_TOL at the causal shape (8.3e-4)
and ten times the built design's LSE error.

Row 18's f32 option (`emulate_ragged`): both products in three TF32
parts on mma.sync m16n8k8 (hi the value truncated to TF32, as the tensor
core reads it; lo the rest), each k8 step's parts summed into a fresh
tile (rounded toward zero at each instruction) and added to the f32 sum,
the online softmax over 32-key stages (RAGGED_STAGE, a wide tile's f32
ring stage); on a decode batch (one query a
row, chains of 1024, 300 and 17 keys) and a wide one (16 positions of
GQA 4 over a 1024-key chain), each output vector within RAGGED_F32_TOL
of its scale. A control with single TF32 operands (q, K, P and V each
rounded once) must read above RAGGED_F32_TOL, as the card's
`ragged_tf32` twin does.
"""
import numpy as np
import pytest

F32_TOL = 2.5e-3          # chip_smoke.py's bound for the f32 option
F32_LSE_TOL = 1e-4        # chip_smoke.py's bound of the f32 LSE
RAGGED_F32_TOL = 2e-5     # chip_smoke.py's bound for row 18 in f32
FWD_TILE = 64             # csrc/flash_f32.cu's kFwdBN: keys a forward tile
RAGGED_STAGE = 32         # csrc/ragged_paged_attention.cu's f32 Ring::kKeys
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


def score_products(x, y, fresh, lo_parts=True, y_lo=True, y_trunc=False,
                   x_trunc=False):
    """X Y^T over the last axis, as the kernel's score products: x [...,
    M, hd] split in registers, y [..., N, hd] from hi and lo planes, each
    operand read by the tensor core through its truncation; `fresh`: in
    fresh tiles of DP_GROUP k8 steps (dP), else one chain (S).
    `lo_parts` False drops both lo parts, `y_lo` False y's alone;
    `y_trunc`: y's hi is its truncation (the forward's raw K tile), not
    rna; `x_trunc` x's (the forward's Q)."""
    xh = trunc(x) if x_trunc else rna(x)
    xl = trunc(x - xh)
    yh = trunc(y) if y_trunc else rna(y)
    yl = trunc(y - yh)
    steps = x.shape[-1] // 8
    acc = tile = None
    for ks in range(steps):
        sl = slice(8 * ks, 8 * ks + 8)
        bh = np.swapaxes(yh[..., sl], -1, -2)
        bl = np.swapaxes(yl[..., sl], -1, -2)
        parts = [(xh[..., sl], bh)]
        if lo_parts:
            parts += [(xh[..., sl], bl)] if y_lo else []
            parts += [(xl[..., sl], bh)]
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


def rel_err(out, ref, floor=GRAD_ROW_FLOOR):
    d = np.abs(out - ref).max(-1)
    r = np.abs(ref).max(-1)
    r = np.maximum(r, floor * r.max())
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


# ---------------------------------------------------------------- forward
def emulate_forward(q, k, v, causal, k_lo=True):
    """The f32 forward on [H, S, hd] inputs: (out, lse), as the module
    docstring says; `k_lo` False drops K's lo plane (S = Qhi Khi + Qlo
    Khi)."""
    f32 = np.float32
    rep = q.shape[0] // k.shape[0]
    ke, ve = np.repeat(k, rep, 0), np.repeat(v, rep, 0)
    hd, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    scale_log2 = f32(hd ** -0.5) * f32(LOG2E)
    vis = visible(sq, sk, causal)
    s = score_products(q, ke, fresh=False, y_lo=k_lo, y_trunc=True,
                       x_trunc=True)
    m = np.full(q.shape[:2], -1e30, f32)
    l = np.zeros(q.shape[:2], f32)
    o = np.zeros(q.shape, f32)
    for k0 in range(0, sk, FWD_TILE):
        cols = slice(k0, min(k0 + FWD_TILE, sk))
        sc = np.where(vis[:, cols], (s[..., cols] * scale_log2).astype(f32),
                      f32(-1e30))
        m_new = np.maximum(m, sc.max(-1))
        alpha = np.exp2(m - m_new).astype(f32)
        p = np.where(sc > -5e29, np.exp2((sc - m_new[..., None]).astype(f32)),
                     f32(0)).astype(f32)
        l = (l * alpha + p.sum(-1, dtype=f32)).astype(f32)
        o = (o * alpha[..., None]).astype(f32)
        pr, vr = rna(p), rna(ve[:, cols])
        for j in range(0, pr.shape[-1], 8):
            o = mma_step(o, pr[..., j:j + 8], vr[:, j:j + 8])
        m = m_new
    out = (o * (f32(1) / l)[..., None]).astype(f32)
    lse = (m * f32(np.log(2.0)) + np.log(l)).astype(f32)
    return out, lse


def _fwd_case(name):
    S, H, KV, hd, causal = SHAPES[name]
    rng = np.random.default_rng(20)
    q = rng.standard_normal((H, S, hd)).astype(np.float32)
    k, v = (rng.standard_normal((KV, S, hd)).astype(np.float32)
            for _ in range(2))
    _, o, lse = reference(q, k, v, np.zeros_like(q), causal)
    return q, k, v, causal, o, lse


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulated_forward_within_f32_tol(name):
    """The forward's out within F32_TOL of each (query, head) vector's
    scale and its LSE within F32_LSE_TOL of the f64 evaluation's."""
    q, k, v, causal, o, lse = _fwd_case(name)
    out, got_lse = emulate_forward(q, k, v, causal)
    err = rel_err(out, o, floor=0.0)
    lse_err = float(np.abs(got_lse - lse).max())
    assert err <= F32_TOL, (name, err)
    assert lse_err <= F32_LSE_TOL, (name, lse_err)


def test_forward_k_lo_dropped_reads_above_the_lse_bound():
    """The planted control at the causal shape: S without K's lo plane
    moves the LSE above F32_LSE_TOL and by at least ten times the built
    design's own LSE error. (Ten times F32_LSE_TOL is out of reach: one
    lost TF32 part errs by at most 2^-10 a term, 8.3e-4 of the LSE
    here.)"""
    q, k, v, causal, _, lse = _fwd_case("causal_300_gqa4_hd72")
    _, built = emulate_forward(q, k, v, causal)
    _, dropped = emulate_forward(q, k, v, causal, k_lo=False)
    err = float(np.abs(dropped - lse).max())
    assert err >= F32_LSE_TOL, err
    assert err >= 10 * float(np.abs(built - lse).max()), err


# --------------------------------------------------------------- row 18
def _fresh3(a, b, parts3=True):
    """A @ B over one k8 step as the kernel's fresh tile: three TF32
    parts (hi hi, hi lo, lo hi; hi = trunc(x), lo = x - hi read
    truncated), each instruction rounding toward zero; parts3 False: one
    part of operands rounded once."""
    if not parts3:
        return mma_step(None, rna(a), rna(b))
    ah, bh = trunc(a), trunc(b)
    al, bl = a - ah, b - bh
    t = mma_step(None, ah, bh)
    t = mma_step(t, ah, trunc(bl))
    return mma_step(t, trunc(al), bh)


def emulate_ragged(q, k, v, lengths, parts3=True):
    """Row 18's f32 fold of one split: q [R, P, H, hd], k and v [R, L,
    KV, hd] (each row's chain), `lengths` [R, P] the keys each query
    sees (its position + 1). Returns out [R, P, H, hd]."""
    f32 = np.float32
    R, P, H, hd = q.shape
    rep = H // k.shape[2]
    scale_log2 = f32(hd ** -0.5) * f32(LOG2E)
    out = np.zeros(q.shape, f32)
    for r in range(R):
        for h in range(H):
            qs = q[r, :, h]                             # [P, hd]
            kh, vh = k[r, :, h // rep], v[r, :, h // rep]
            s = np.zeros((P, kh.shape[0]), f32)
            for kk in range(0, hd, 8):
                s = (s + _fresh3(qs[:, kk:kk + 8], kh[:, kk:kk + 8].T,
                                 parts3)).astype(f32)
            vis = np.arange(kh.shape[0])[None] < lengths[r][:, None]
            m = np.full(P, -1e30, f32)
            l = np.zeros(P, f32)
            o = np.zeros((P, hd), f32)
            for k0 in range(0, kh.shape[0], RAGGED_STAGE):
                cols = slice(k0, k0 + RAGGED_STAGE)
                sc = np.where(vis[:, cols], (s[:, cols] * scale_log2)
                              .astype(f32), f32(-1e30))
                m_new = np.maximum(m, sc.max(-1))
                alpha = np.exp2(m - m_new).astype(f32)
                p = np.where(sc > -5e29, np.exp2((sc - m_new[:, None])
                                                 .astype(f32)), f32(0))
                p = p.astype(f32)
                l = (l * alpha + p.sum(-1, dtype=f32)).astype(f32)
                o = (o * alpha[:, None]).astype(f32)
                for j in range(0, p.shape[-1], 8):
                    o = (o + _fresh3(p[:, j:j + 8], vh[k0 + j:k0 + j + 8],
                                     parts3)).astype(f32)
                m = m_new
            out[r, :, h] = o * (f32(1) / l)[:, None]
    return out


def _ragged_case(kind):
    """A decode batch (3 rows of one query: 1024, 300 and 17 keys) or a
    wide one (one row, 16 positions 1008..1023 of a 1024-key chain), GQA
    4:1, hd 128; with the f64 evaluation's outputs."""
    rng = np.random.default_rng(18)
    hd, H, KV, L = 128, 4, 1, 1024
    if kind == "decode":
        lengths = np.array([[1024], [300], [17]])
    else:
        lengths = (L - 16 + np.arange(16) + 1)[None]
    R, P = lengths.shape
    q = rng.standard_normal((R, P, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((R, L, KV, hd)).astype(np.float32)
            for _ in range(2))
    ref = np.zeros(q.shape)
    for r in range(R):
        for h in range(H):
            s = q[r, :, h].astype(np.float64) @ \
                k[r, :, h // (H // KV)].astype(np.float64).T * hd ** -0.5
            s = np.where(np.arange(L)[None] < lengths[r][:, None], s,
                         -np.inf)
            p = np.exp(s - s.max(-1, keepdims=True))
            ref[r, :, h] = (p / p.sum(-1, keepdims=True)) @ \
                v[r, :, h // (H // KV)].astype(np.float64)
    return q, k, v, lengths, ref


@pytest.mark.parametrize("kind", ["decode", "wide"])
def test_emulated_ragged_f32_within_bound(kind):
    """Row 18's f32 option within RAGGED_F32_TOL of each output vector's
    scale, at a 1024-key chain."""
    q, k, v, lengths, ref = _ragged_case(kind)
    err = rel_err(emulate_ragged(q, k, v, lengths), ref, floor=0.0)
    assert err <= RAGGED_F32_TOL, (kind, err)


def test_ragged_single_tf32_parts_read_above_the_bound():
    """The control: q, K, P and V each rounded to TF32 once, one part a
    product, reads above RAGGED_F32_TOL (the card's `ragged_tf32`)."""
    q, k, v, lengths, ref = _ragged_case("decode")
    err = rel_err(emulate_ragged(q, k, v, lengths, parts3=False), ref,
                  floor=0.0)
    assert err > RAGGED_F32_TOL, err
