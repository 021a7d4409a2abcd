"""Flash attention: plain PyTorch versions + CUDA kernels.

Port of paddle_tpu/kernels/flash_attention.py: `mha_ref` (the exact
reference), the Pallas forward `_flash_fwd_kernel` (Hopper counterpart
`csrc/flash_fwd.cu`), the Pallas backward kernels (the resident,
streamed and split schedules of `flash_attention_pallas_bwd`, one
Hopper design in `csrc/flash_bwd.cu`; the f32 option of both, on TF32
tensor cores, in `csrc/flash_f32.cu`) and the differentiable entries,
the `custom_vjp`s `flash_attention_fwd` and `flash_attention_masked`
there, here the autograd Function behind `flash_attention` and
`flash_attention_masked`. Layout is [batch, seq, heads, head_dim]
('bshd') or head-major [batch, heads, seq, head_dim] ('bhsd'); k/v may
have fewer heads than q (GQA). The kernels read every tensor through its
strides, so neither layout is copied into the other, and take any
sequence length: the JAX package's pad-to-block wrappers
(`flash_attention_padded`) have no counterpart.

`key_mask` [B, Sk] (nonzero = visible to every query of that batch row)
is the bidirectional encoder's padding mask. As in the TPU kernel, a
row whose keys are all masked gives 0 and an LSE of -1e30 (mha_ref's
softmax would give uniform attention there), so the plain versions
follow the kernels, not `mha_ref`.

The LSE is taken in the scaled-score domain, as the TPU kernel keeps
it: lse[b, h, i] = log Σ_j exp(scale · q_i·k_j) over the visible keys.

`flash_attention_fwd` and `flash_attention_bwd` run the kernel on a CUDA
tensor and the plain version on a CPU tensor; there is no fallback
between the two. The kernels take bf16, f16 or f32 (one dtype for
every tensor of a call), as the TPU kernels compute in their input's
dtype; each wrapper counts its launches by dtype too (`launches_bf16`,
`launches_f16`, `launches_f32`). The f32 kernels multiply on TF32
tensor cores: the scores' products in three TF32 parts (hi·hi + hi·lo +
lo·hi, ~f32 accuracy), the second products (P·V, Pᵀ·dO, dSᵀ·Q, dS·K)
in one, each operand rounded to nearest (2⁻¹¹ relative).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
LAYOUTS = ("bshd", "bhsd")
# flash_fwd_<dt>(q, k, v, out, lse, key_mask, B, Sq, Sk, H, KV, hd,
#                maps[21], out_strides[3], scale, causal, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
# flash_bwd_<dt>(q, k, v, out, dout, lse, scratch, dq, dk, dv, key_mask,
#                B, Sq, Sk, H, KV, hd, maps[28], strides[24], scale,
#                causal, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
# The kernels' tiles (csrc/flash_fwd.cu, csrc/flash_bwd.cu), as (rows a
# block, keys a tile): the forward and the dq pass own 128 query rows a
# block and walk key tiles of 128 (forward) or 64 (dq) keys; dkdv owns
# 128 keys and walks query tiles of 64; TMA moves boxes of 64 columns x
# 64 rows; the backward's prep rows pad Sq to a multiple of 128.
FWD_TILES = (128, 128)
DQ_TILES = (128, 64)
DKDV_TILES = (128, 64)
TMA_BOX = (64, 64, 1, 1)
BWD_PAD = 128
# The f32 kernels' (csrc/flash_f32.cu): twice the bytes a value, so
# 64-key forward tiles; the backward streams 32-key dq and 32-query dkdv
# tiles (the N of its wgmma score products, beside their lo planes); a
# box of 32 columns (one 128-byte swizzle row of f32) x 16 rows (the
# forward's: x 64 rows); the same padding of Sq.
FWD_TILES_F32 = (128, 64)
DQ_TILES_F32 = (128, 32)
DKDV_TILES_F32 = (128, 32)
TMA_BOX_F32 = (32, 16, 1, 1)
# the dtypes the kernels take, by their entry points' suffix
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16",
                 torch.float32: "f32"}
# the libraries (csrc/<name>.cu) of the forward and backward entry points
_LIBRARIES = {"bf16": ("flash_fwd", "flash_bwd"),
              "f16": ("flash_fwd", "flash_bwd"),
              "f32": ("flash_f32", "flash_f32")}


def block_aligned(s: int) -> bool:
    """The JAX package's test (flash_attention.py:879) for a sequence
    length its kernels take without padding: a multiple of 256, or one
    lane-aligned block (s <= 256, s % 128 == 0). The port's kernels take
    any length; `nlp/ernie.py` asks it to choose the route JAX takes."""
    return s % 128 == 0 and (s <= 256 or s % 256 == 0)


def _check_layout(layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def _bshd(x, layout):
    """A 'bhsd' tensor as its [B, S, H, D] view (no copy)."""
    return x.transpose(1, 2) if layout == "bhsd" else x


def _expand_kv(q, k, v):
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def _causal_mask(sq, sk, device):
    """[sq, sk] visibility of the bottom-right causal alignment: query i
    sees keys j <= i + sk - sq."""
    return torch.ones((sq, sk), dtype=torch.bool,
                      device=device).tril(diagonal=sk - sq)


def mha_ref(q, k, v, *, causal=False, bias=None, scale=None, mask=None):
    """Exact attention reference. q,k,v: [B, S, H, D] → [B, S, H, D].
    Supports GQA: k/v may have fewer heads (H % Hkv == 0). `bias` is
    added to the scaled scores [B, H, Sq, Sk] (broadcastable), `mask`
    (bool, broadcastable) hides scores. Causal is the bottom-right
    alignment (query i sees keys j <= i + Sk - Sq)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _expand_kv(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if causal:
        cm = _causal_mask(q.shape[1], k.shape[1], q.device)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _visible(sq, sk, causal, key_mask, device):
    """The [B|1, 1, Sq|1, Sk] visibility of the scores, or None."""
    vis = _causal_mask(sq, sk, device)[None, None] if causal else None
    if key_mask is not None:
        km = (key_mask != 0)[:, None, None, :]
        vis = km if vis is None else vis & km
    return vis


def flash_attention_fwd_ref(q, k, v, causal=True, scale=None,
                            return_lse=False, key_mask=None, layout="bshd"):
    """The forward kernel's plain version: GQA attention, causal (Sq <=
    Sk) or bidirectional with an optional key mask, scores and
    accumulation in f32, output in q's dtype and layout; with
    `return_lse`, also the f32 LSE [B, H, Sq] of the scaled scores. A row
    with no visible key gives 0 and an LSE of -1e30, as the kernel."""
    _check_layout(layout)
    q, k, v = (_bshd(t, layout) for t in (q, k, v))
    if not return_lse and key_mask is None:
        return _bshd(mha_ref(q, k, v, causal=causal, scale=scale), layout)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ke, ve = _expand_kv(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke.float()) * scale
    vis = _visible(q.shape[1], k.shape[1], causal, key_mask, q.device)
    if vis is not None:
        logits = torch.where(vis, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    if key_mask is not None:
        probs = torch.where(vis, probs, 0.0)    # an all-masked row: 0
    out = _bshd(torch.einsum("bhqk,bkhd->bqhd", probs, ve.float())
                .to(q.dtype), layout)
    return (out, lse) if return_lse else out


def _strides(t, layout):
    """(batch, seq, head) element strides of a [B, S, H, D] or
    [B, H, S, D] tensor."""
    s = t.stride()
    return (s[0], s[1], s[2]) if layout == "bshd" else (s[0], s[2], s[1])


def _kernel_input(name, t, device, dtype=None):
    """t as the kernels read it (TMA's rules): `dtype` (bf16, f16 or f32,
    the call's one dtype; None: t's own) on `device`, head_dim contiguous,
    the other strides whole 16-byte rows and not 0 over an extent above 1,
    the base 16-byte aligned. A tensor that is not (a sliced or broadcast
    view) is made contiguous."""
    dtype = t.dtype if dtype is None else dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the flash kernels take bf16, f16 or f32, got "
                        f"{dtype}")
    if t.dtype != dtype or t.device != device:
        raise TypeError(f"{name} must be a {dtype} tensor on {device} (q's "
                        f"dtype), got {t.dtype} on {t.device}")
    row = 16 // t.element_size()          # elements in 16 bytes
    if t.stride(-1) != 1 or any(s % row for s in t.stride()[:3]) \
            or any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)) \
            or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _check(q, k, v, causal, layout, key_mask):
    """The shapes the kernels take; returns (B, Sq, H, hd, Sk, KV)."""
    _check_layout(layout)
    B, Sq, H, hd = _bshd(q, layout).shape
    Bk, Sk, KV, hdk = _bshd(k, layout).shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"query heads {H} not a multiple of KV heads {KV}")
    if causal and Sq > Sk:
        raise ValueError(f"causal flash needs Sq <= Sk, got {Sq} > {Sk}")
    if hd not in (64, 72, 128):
        raise ValueError(f"head_dim {hd} not supported (64, 72 or 128)")
    if key_mask is not None and (tuple(key_mask.shape) != (B, Sk)
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be [{B}, {Sk}] on {q.device}, got "
                         f"{tuple(key_mask.shape)} on {key_mask.device}")
    return B, Sq, H, hd, Sk, KV


def _mask_arg(key_mask):
    """The key mask as the kernels read it: bool (one byte, 0 or 1)
    [B, Sk], contiguous; None stays None."""
    if key_mask is None:
        return None
    km = key_mask if key_mask.dtype == torch.bool else key_mask != 0
    return km.contiguous()


def _stride_array(tensors, layout):
    vals = [s for t in tensors for s in _strides(t, layout)]
    return (ctypes.c_longlong * len(vals))(*vals)


def tma_dims(t, layout):
    """The seven values the kernels build a TMA tensor map of `t` from
    (csrc/hopper_core.cuh::encode_map): its extents innermost first
    (head_dim, seq, heads, batch) and the byte strides of seq, heads and
    batch. Element (b, s, h, d) lies at byte d * e + s * st_s + h * st_h
    + b * st_b from the base in either layout (e the element size); the
    head_dim stride is 1 and `_kernel_input` makes the others whole
    16-byte rows, as TMA requires. The box (TMA_BOX; TMA_BOX_F32) is one
    128-byte swizzle row of columns (64 of 16 bits, 32 f32): ceil(hd /
    columns) boxes a row, the columns past hd zero-filled."""
    e = t.element_size()
    if layout == "bshd":
        (B, S, H, hd), (st_b, st_s, st_h) = t.shape, t.stride()[:3]
    else:
        (B, H, S, hd), (st_b, st_h, st_s) = t.shape, t.stride()[:3]
    return (hd, S, H, B, st_s * e, st_h * e, st_b * e)


def _map_array(tensors, layout):
    vals = [v for t in tensors for v in tma_dims(t, layout)]
    return (ctypes.c_longlong * len(vals))(*vals)


def key_tiles(m0, sq, sk, causal, tiles=FWD_TILES):
    """The key tiles rows m0.. of a block (tiles = (rows, keys) of the
    block and of a key tile) walk before the key mask: 0 .. n - 1, where
    n covers every key of Sk or, causal, the keys up to the diagonal of
    the block's last row (query i sees keys j <= i + sk - sq). The
    kernels' rule (csrc/hopper_core.cuh::key_tiles), written out for the
    tests."""
    bm, bn = tiles
    last = sk - 1
    if causal:
        last = min(last, m0 + bm - 1 + sk - sq)
    return 0 if last < 0 else last // bn + 1


def key_tile_states(mask_row, n_tiles, bn):
    """Each of a batch row's first n_tiles key tiles of bn keys, as the
    kernels mark them before walking (scan_key_tiles): 0 when no key is
    visible (the tile is not walked), 1 when some key is masked or past
    Sk (a per-element test), 2 when every key is present and visible.
    mask_row: the row's [Sk] key mask (nonzero = visible)."""
    vis = (torch.as_tensor(mask_row) != 0).tolist()
    out = []
    for t in range(n_tiles):
        seg = [vis[j] if j < len(vis) else False
               for j in range(t * bn, (t + 1) * bn)]
        out.append(2 if all(seg) else 1 if any(seg) else 0)
    return out


def query_tiles(k0, sq, sk, causal, mask_row=None, tiles=DKDV_TILES):
    """The query tiles the backward's dkdv block of keys k0.. walks for
    each query head of its group: none when every one of its keys is
    masked (mask_row: the batch row's [Sk] key mask; the block writes
    zeros), else from the first tile holding a query that sees key k0
    (causal: i >= k0 - (sk - sq)) to the last of Sq."""
    bk, bq = tiles
    if mask_row is not None and not bool(
            (torch.as_tensor(mask_row)[k0:k0 + bk] != 0).any()):
        return range(0)
    first = max(0, k0 - (sk - sq)) // bq if causal else 0
    return range(first, -(-sq // bq))


def bwd_scratch_numel(B, H, sq):
    """f32 values of the backward's prep rows (lse * log2(e) and dcap)
    [2, B * H, Sq_pad], Sq_pad = sq rounded up to BWD_PAD."""
    return 2 * B * H * (-(-sq // BWD_PAD) * BWD_PAD)


def flash_attention_fwd(q, k, v, causal=True, scale=None, return_lse=False,
                        key_mask=None, layout="bshd"):
    """Flash attention forward, q [B, Sq, H, hd], k/v [B, Sk, KV, hd] (or
    their 'bhsd' forms); with `return_lse`, returns (out, lse [B, H, Sq]
    f32). `key_mask` [B, Sk]: nonzero keys are visible.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (q, k and v all bf16, all f16 or all f32, hd 64, 72 or 128, Sq <= Sk
    when causal; `out` contiguous in the layout, in q's dtype); anything
    it does not take raises. Each kernel launch adds one to
    `flash_attention_fwd.launches` and to its dtype's `launches_bf16`,
    `launches_f16` or `launches_f32`."""
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale,
                                       return_lse=return_lse,
                                       key_mask=key_mask, layout=layout)
    B, Sq, H, hd, Sk, KV = _check(q, k, v, causal, layout, key_mask)
    dt = q.dtype
    q, k, v = (_kernel_input(n, t, q.device, dt)
               for n, t in (("q", q), ("k", k), ("v", v)))
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    km = _mask_arg(key_mask)
    maps = _map_array((q, k, v), layout)
    strides = _stride_array((out,), layout)
    tag = KERNEL_DTYPES[dt]
    sym = f"flash_fwd_{tag}"
    fn = _build.function(_LIBRARIES[tag][0], sym, _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 None if km is None else km.data_ptr(), B, Sq, Sk, H, KV,
                 hd, maps, strides, float(scale), int(causal), stream)
    _build.check(err, sym)
    _build.count_dtype(flash_attention_fwd, dt)
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_bf16 = 0
flash_attention_fwd.launches_f16 = 0
flash_attention_fwd.launches_f32 = 0


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True,
                            scale=None, key_mask=None, layout="bshd"):
    """The backward kernel's plain version: (dq, dk, dv) in the inputs'
    dtypes and layout, from the forward's output and LSE (not through
    autograd). f32 einsums; P = exp(scale·QKᵀ − lse) where visible, else
    0 (the mask zeroes P, not the scores, so masked keys get dk = dv = 0
    and an all-masked row contributes nothing), dcap = rowsum(dO·O),
    dS = P∘(dP − dcap)·scale; dk/dv summed over each KV head's group of
    query heads."""
    _check_layout(layout)
    q, k, v, out, dout = (_bshd(t, layout) for t in (q, k, v, out, dout))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    ke, ve = _expand_kv(q, k, v)
    qf, kf, vf = q.float(), ke.float(), ve.float()
    dof = dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    vis = _visible(Sq, Sk, causal, key_mask, q.device)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dcap = (dof * out.float()).sum(-1).transpose(1, 2)       # [B, H, Sq]
    ds = p * (dp - dcap[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if KV != H:
        dk = dk.reshape(B, Sk, KV, H // KV, hd).sum(3)
        dv = dv.reshape(B, Sk, KV, H // KV, hd).sum(3)
    return tuple(_bshd(g.to(t.dtype), layout)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, scale=None,
                        key_mask=None, layout="bshd"):
    """Flash attention backward: (dq, dk, dv), contiguous in the layout,
    from the forward's `out` and `lse` [B, H, Sq] and the output
    cotangent `dout`; `key_mask` must be the forward's.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel
    (q/k/v/out/dout all bf16, all f16 or all f32, f32 lse; the shapes
    the forward kernel takes); anything else raises. GQA is accumulated over each KV head's query
    group inside the kernel. Each call adds one to
    `flash_attention_bwd.launches` (and its dtype's count), whatever the
    number of CUDA launches inside (three: dcap, dkdv, dq)."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, scale=scale,
                                       key_mask=key_mask, layout=layout)
    B, Sq, H, hd, Sk, KV = _check(q, k, v, causal, layout, key_mask)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must have q's shape")
    dt = q.dtype
    q, k, v, out, dout = (_kernel_input(n, t, q.device, dt) for n, t in (
        ("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)))
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 [{B}, {H}, {Sq}]")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = torch.empty(bwd_scratch_numel(B, H, Sq), dtype=torch.float32,
                          device=q.device)
    km = _mask_arg(key_mask)
    maps = _map_array((q, k, v, dout), layout)
    strides = _stride_array((q, k, v, out, dout, dq, dk, dv), layout)
    tag = KERNEL_DTYPES[dt]
    sym = f"flash_bwd_{tag}"
    fn = _build.function(_LIBRARIES[tag][1], sym, _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if km is None else km.data_ptr(), B, Sq, Sk, H, KV,
                 hd, maps, strides, float(scale), int(causal), stream)
    _build.check(err, sym)
    _build.count_dtype(flash_attention_bwd, dt)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_bf16 = 0
flash_attention_bwd.launches_f16 = 0
flash_attention_bwd.launches_f32 = 0


class _FlashAttention(torch.autograd.Function):
    """The port of the `custom_vjp`s around the JAX package's flash
    attention (causal or not, with or without a key mask): the forward
    keeps (q, k, v, out, lse), the backward runs the flash backward from
    them (O(S) memory, no score matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale, layout):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       return_lse=True, key_mask=key_mask,
                                       layout=layout)
        ctx.save_for_backward(q, k, v, out, lse, key_mask)
        ctx.causal, ctx.scale, ctx.layout = causal, scale, layout
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, key_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale,
                                         key_mask=key_mask,
                                         layout=ctx.layout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, layout="bshd"):
    """Differentiable flash attention, q [B, Sq, H, hd], k/v
    [B, Sk, KV, hd] → [B, Sq, H, hd] (or the 'bhsd' forms): the kernels on
    the card, their plain versions on the CPU."""
    return _FlashAttention.apply(q, k, v, None, causal, scale, layout)


def flash_attention_masked(q, k, v, key_mask, scale=None, layout="bshd"):
    """Differentiable bidirectional flash attention with a key-padding
    mask (the JAX package's `flash_attention_masked`): key_mask [B, Sk],
    nonzero = key visible to every query of that batch row; a row whose
    keys are all masked gives 0. The kernels on the card, their plain
    versions on the CPU."""
    return _FlashAttention.apply(q, k, v, key_mask, False, scale, layout)
