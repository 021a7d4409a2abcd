"""MoE dispatch and combine: plain PyTorch versions + CUDA kernels.

Port of the single-device half of paddle_tpu/kernels/moe_dispatch.py.
Because GShard slot assignment is injective (each expert slot holds at
most one (token, choice), each (token, choice) fills at most one slot),
both directions of the MoE dispatch and both of their gradients are row
gathers over a pair of inverse index maps, never scatters:

    gather_wsum       out[b, m] = Σ_j w[b, m, j] · src[b, idx[b, m, j]]
                      (the Pallas `_gather_wsum_kernel`; here
                      `csrc/moe_dispatch.cu`)
    gather_scale_dot  out[b, m] = scale[b, m] · src[b, idx[b, m]] and
                      dot[b, m] = src[b, idx[b, m]] · other[b, m]
                      (the Pallas `_gather_scale_dot_kernel`; here
                      `csrc/moe_dispatch.cu`)
    dispatch_gather   token rows → expert slots, as a k = 1 gather_wsum;
                      its backward a k-row gather_wsum over the forward map
    combine_wsum      expert slots → token rows, the probability-weighted
                      k-sum; its backward one gather_scale_dot over the
                      inverse map
    gather_rows       out[b, m] = src[b, idx[b, m]], a zero row where
                      idx < 0 (the Pallas `_gather_rows_kernel`; here
                      `csrc/moe_dispatch.cu`); its backward the
                      scatter-add of the JAX `_gather_rows_p_bwd`, plain
                      torch as it is jnp there
    combine_gather    expert slots → one row per (token, choice), a
                      gather_rows; its backward a gather_rows over the
                      inverse map
    gather_mlp        the dispatch gather fused into the expert gate and
                      up products: (g, u) = (xin·wg[e], xin·wu[e]) with
                      xin[e, m] = src[idx[e, m]] (the Pallas
                      `_gather_mlp_kernel`; here `csrc/gather_mlp.cu`);
                      its backward the JAX `_gather_mlp_bwd`: the weight
                      and input products by torch.matmul (XLA in JAX) and
                      the scatter back to the tokens by gather_wsum

`gather_wsum` and `gather_scale_dot` launch their kernel on a CUDA tensor
and run their plain version (`_gather_wsum_ref`, `_gather_scale_dot_ref`)
on a CPU tensor; there is no fallback between the two. The plain versions
compute as the Pallas kernels do: f32 weights and products, the k-sum in
the order j = 0..k-1, one rounding to the source's dtype. Indices are
int32 throughout, pre-clipped by the caller to valid rows; a weight of 0
marks an empty slot or a dropped choice.

No path of the JAX package launches the masked row gather or the fused
gather-MLP kernel: its single-device MoE block takes the wsum and
scale-dot pair, its mesh branch passes `use_pallas=False` to
`combine_gather`, and `gather_mlp` is a measured negative result there
(nlp/moe.py:343-349). The port holds both kernels at the MoE step's
shapes in `chip_smoke.py`; no path of the port calls them either.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from .. import _build
from .norm_bwd import sm_count

# gather_wsum_{bf16,f16,f32}(src, idx, w, out, B, N, M, k, D, stream)
_WSUM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
# gather_scale_dot_{bf16,f16,f32}(src, idx, scale, other, out, dot, B, N,
#                                 M, D, stream)
_SDOT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
# gather_rows_bf16(src, idx, out, B, N, M, D, stream)
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
# gather_mlp_bf16(src, idx, wg, wu, g, u, xin, T, E, M, D, F, maps, plan,
#                 grid, stream)
_MLP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_MAX_K = 8
# csrc/gather_mlp.cu: a tile is two halves of MLP_HALF slots (one a
# consumer warpgroup) x MLP_COLS columns of F
MLP_HALF, MLP_COLS = 64, 128


def _take_rows(src, idx):
    """src [B, N, D], idx [B, R] → src[b, idx[b, r]] as [B, R, D]."""
    B, N, D = src.shape
    off = (torch.arange(B, device=src.device) * N)[:, None]
    flat = (idx.long() + off).reshape(-1)
    return src.reshape(B * N, D).index_select(0, flat).reshape(
        B, idx.shape[1], D)


def _gather_wsum_ref(src, idx, w):
    """Plain version of the gather_wsum kernel: src [B, N, D]; idx
    [B, M, k] int32 pre-clipped; w [B, M, k] f32 → [B, M, D] in src's
    dtype."""
    B, M, k = idx.shape
    rows = _take_rows(src, idx.reshape(B, M * k)).reshape(B, M, k, -1)
    wf = w.float()
    acc = rows[:, :, 0].float() * wf[..., 0:1]
    for j in range(1, k):
        acc = acc + rows[:, :, j].float() * wf[..., j:j + 1]
    return acc.to(src.dtype)


def _gather_scale_dot_ref(src, idx, scale, other):
    """Plain version of the gather_scale_dot kernel: src [B, N, D]; idx
    [B, M] int32 pre-clipped; scale [B, M] f32; other [B, M, D] →
    (out [B, M, D] in src's dtype, dot [B, M] f32)."""
    rows = _take_rows(src, idx).float()
    out = (rows * scale.float()[..., None]).to(src.dtype)
    dot = torch.sum(rows * other.float(), dim=-1)
    return out, dot


def _gather_rows_ref(src, idx):
    """Plain version of the gather_rows kernel: src [B, N, D]; idx
    [B, M] int32 → [B, M, D], +0 rows where idx is outside [0, N)."""
    N = src.shape[1]
    ok = (idx >= 0) & (idx < N)
    rows = _take_rows(src, torch.where(ok, idx, 0))
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=src.dtype,
                                                        device=src.device))


def _gather_mlp_ref(src, idx, wg, wu):
    """Plain version of the gather_mlp kernel: src [T, D]; idx [E, M]
    int32 (-1 = empty slot); wg/wu [E, D, F] → (g, u [E, M, F], xin
    [E, M, D]) in src's dtype; the products in f32, rounded once."""
    E, M = idx.shape
    xin = _gather_rows_ref(src[None], idx.reshape(1, E * M))[0].reshape(
        E, M, src.shape[-1])
    g = torch.matmul(xin.float(), wg.float()).to(src.dtype)
    u = torch.matmul(xin.float(), wu.float()).to(src.dtype)
    return g, u, xin


# the element types of the wsum and scale-dot kernels (the TPU kernels
# compute in the rows' dtype), as the entry points' suffixes
_ROW_TAGS = ("bf16", "f16", "f32")


def _tag(t):
    """The entry-point suffix of t's dtype (None for another dtype)."""
    return _build.DTYPE_TAGS.get(str(t.dtype))


def _check_src(src, what, tags=("bf16",)):
    if src.dim() != 3 or _tag(src) not in tags \
            or not src.is_contiguous() or src.data_ptr() % 16:
        raise TypeError(f"{what}: src must be a contiguous, 16-byte aligned "
                        f"{' or '.join(tags)} CUDA tensor [B, N, D]; got "
                        f"{src.dtype}")
    if src.shape[2] * src.element_size() % 16:
        raise ValueError(f"{what}: the row width D = {src.shape[2]} must "
                         f"make whole 16-byte vectors of {src.dtype}")
    if src.shape[1] < 1:
        raise ValueError(f"{what}: src has no rows to gather from")


def _check_like(t, shape, dtype, device, what, name):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise TypeError(f"{what}: {name} must be a contiguous {dtype} "
                        f"tensor {list(shape)} on {device}; got "
                        f"{t.dtype} {list(t.shape)} on {t.device}")


def gather_wsum(src, idx, w):
    """Weighted k-row gather-sum: out[b, m] = Σ_j w[b, m, j] ·
    src[b, idx[b, m, j]], accumulated in f32 in the order j = 0..k-1.

    src [B, N, D]; idx [B, M, k] int32, PRE-CLIPPED to [0, N); w
    [B, M, k] f32, 0 at empty slots and dropped choices → [B, M, D] in
    src's dtype. On a CPU tensor: the plain version. On a CUDA tensor: the
    kernel (bf16, f16 or f32 src whose rows are whole 16-byte vectors,
    int32 idx, f32 w, k <= 8); anything else raises. Each launch adds one
    to `gather_wsum.launches` and to its dtype's `launches_bf16`,
    `launches_f16` or `launches_f32`."""
    if not src.is_cuda:
        return _gather_wsum_ref(src, idx, w)
    _check_src(src, "gather_wsum", _ROW_TAGS)
    B, N, D = src.shape
    if idx.dim() != 3 or idx.shape[0] != B:
        raise ValueError(f"gather_wsum: idx must be [B={B}, M, k]; got "
                         f"{list(idx.shape)}")
    M, k = idx.shape[1], idx.shape[2]
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"gather_wsum: k = {k} rows per output; the kernel "
                         f"takes 1 to {_MAX_K}")
    _check_like(idx, (B, M, k), torch.int32, src.device, "gather_wsum", "idx")
    _check_like(w, (B, M, k), torch.float32, src.device, "gather_wsum", "w")
    out = torch.empty(B, M, D, dtype=src.dtype, device=src.device)
    if B * M == 0:
        return out
    sym = f"gather_wsum_{_tag(src)}"
    fn = _build.function("moe_dispatch", sym, _WSUM_ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), idx.data_ptr(), w.data_ptr(),
                 out.data_ptr(), B, N, M, k, D, stream)
    _build.check(err, sym)
    _build.count_dtype(gather_wsum, src.dtype)
    return out


gather_wsum.launches = 0
gather_wsum.launches_bf16 = 0
gather_wsum.launches_f16 = 0
gather_wsum.launches_f32 = 0


def gather_scale_dot(src, idx, scale, other):
    """One row gather serving the combine backward: (out, dot) with
    out[b, m] = scale[b, m] · src[b, idx[b, m]] in src's dtype and
    dot[b, m] = src[b, idx[b, m]] · other[b, m] in f32.

    src [B, N, D]; idx [B, M] int32, PRE-CLIPPED to [0, N); scale [B, M]
    f32; other [B, M, D]. On a CPU tensor: the plain version. On a CUDA
    tensor: the kernel (src and other of one dtype, bf16, f16 or f32,
    rows of whole 16-byte vectors, int32 idx, f32 scale); anything else
    raises. Each launch adds one to `gather_scale_dot.launches` and to
    its dtype's `launches_bf16`, `launches_f16` or `launches_f32`."""
    if not src.is_cuda:
        return _gather_scale_dot_ref(src, idx, scale, other)
    _check_src(src, "gather_scale_dot", _ROW_TAGS)
    B, N, D = src.shape
    if idx.dim() != 2 or idx.shape[0] != B:
        raise ValueError(f"gather_scale_dot: idx must be [B={B}, M]; got "
                         f"{list(idx.shape)}")
    M = idx.shape[1]
    _check_like(idx, (B, M), torch.int32, src.device, "gather_scale_dot",
                "idx")
    _check_like(scale, (B, M), torch.float32, src.device,
                "gather_scale_dot", "scale")
    _check_like(other, (B, M, D), src.dtype, src.device,
                "gather_scale_dot", "other")
    if other.data_ptr() % 16:
        raise TypeError("gather_scale_dot: other must be 16-byte aligned")
    out = torch.empty(B, M, D, dtype=src.dtype, device=src.device)
    dot = torch.empty(B, M, dtype=torch.float32, device=src.device)
    if B * M == 0:
        return out, dot
    sym = f"gather_scale_dot_{_tag(src)}"
    fn = _build.function("moe_dispatch", sym, _SDOT_ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), idx.data_ptr(), scale.data_ptr(),
                 other.data_ptr(), out.data_ptr(), dot.data_ptr(), B, N, M,
                 D, stream)
    _build.check(err, sym)
    _build.count_dtype(gather_scale_dot, src.dtype)
    return out, dot


gather_scale_dot.launches = 0
gather_scale_dot.launches_bf16 = 0
gather_scale_dot.launches_f16 = 0
gather_scale_dot.launches_f32 = 0


def gather_rows_kernel(src, idx):
    """Masked row gather: out[b, m] = src[b, idx[b, m]], a row of zeros
    where idx[b, m] is -1 (or outside [0, N)), not read.

    src [B, N, D]; idx [B, M] int32 → [B, M, D] in src's dtype. On a CPU
    tensor: the plain version. On a CUDA tensor: the kernel (contiguous
    bf16 src with D a multiple of 8, int32 idx); anything else raises.
    Bit for bit the plain version. Each launch adds one to
    `gather_rows_kernel.launches`."""
    if not src.is_cuda:
        return _gather_rows_ref(src, idx)
    _check_src(src, "gather_rows")
    B, N, D = src.shape
    if idx.dim() != 2 or idx.shape[0] != B:
        raise ValueError(f"gather_rows: idx must be [B={B}, M]; got "
                         f"{list(idx.shape)}")
    M = idx.shape[1]
    _check_like(idx, (B, M), torch.int32, src.device, "gather_rows", "idx")
    out = torch.empty(B, M, D, dtype=src.dtype, device=src.device)
    if B * M == 0:
        return out
    fn = _build.function("moe_dispatch", "gather_rows_bf16", _ROWS_ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, M, D,
                 stream)
    _build.check(err, "gather_rows_bf16")
    _build.count(gather_rows_kernel)
    return out


gather_rows_kernel.launches = 0


class _GatherRows(torch.autograd.Function):
    """The JAX `_gather_rows_p` custom_vjp: the kernel forward; the
    backward is the transpose of the gather, an f32 scatter-add of the
    cotangent rows (indices may repeat), -1 rows dropped."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = src.shape[1], src.dtype
        return gather_rows_kernel(src.contiguous(), idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, M, D = g.shape
        N = ctx.n
        safe = torch.where((idx >= 0) & (idx < N), idx, N).long()
        off = (torch.arange(B, device=g.device) * (N + 1))[:, None]
        dsrc = torch.zeros(B * (N + 1), D, dtype=torch.float32,
                           device=g.device)
        dsrc.index_add_(0, (safe + off).reshape(-1),
                        g.float().reshape(B * M, D))
        return dsrc.reshape(B, N + 1, D)[:, :N].to(ctx.dtype), None


def gather_rows(src, idx):
    """Differentiable masked row gather (JAX `gather_rows` with
    use_pallas): src [B, N, D]; idx [B, M] int32, -1 = zero row →
    [B, M, D]. The kernel on the card, its plain version on the CPU."""
    return _GatherRows.apply(src, idx)


class _CombineGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eout, flat, inv_pos):
        ctx.save_for_backward(inv_pos)
        return gather_rows_kernel(eout.contiguous(), flat)

    @staticmethod
    def backward(ctx, g):
        (inv_pos,) = ctx.saved_tensors
        return gather_rows_kernel(g.contiguous(), inv_pos), None, None


def combine_gather(eout, flat, inv_pos):
    """MoE combine as a row gather (JAX `combine_gather`): eout
    [B, E·C, D]; flat [B, S·k] int32 (the slot of each (token, choice),
    -1 = dropped) → [B, S·k, D]. inv_pos [B, E·C] int32 (the (token,
    choice) position filling each slot, -1 = empty) is the inverse map of
    the gradient: d_eout[m] = d_got[inv_pos[m]], exact because at most
    one (token, choice) reads each slot."""
    return _CombineGather.apply(eout, flat, inv_pos)


class MlpPlan(NamedTuple):
    halves: int        # H: MLP_HALF-slot halves an expert
    f_tiles: int       # tiles of MLP_COLS columns of F
    grid: int          # the persistent grid: one block an SM


def mlp_plan(E: int, M: int, F: int, n_sm: int) -> MlpPlan:
    """The shape-given part of csrc/gather_mlp.cu's walk: the halves, the
    F tiles and the grid (no more blocks than tiles could be)."""
    H = -(-M // MLP_HALF)
    nf = -(-F // MLP_COLS)
    return MlpPlan(H, nf, max(1, min(n_sm, E * -(-H // 2) * nf)))


def mlp_tiles(plan: MlpPlan,
              halves: List[Tuple[List[int], List[int]]]
              ) -> List[Tuple[int, int, int, int]]:
    """The walk's tiles in order, (expert, first half, second half or -1,
    first column of F): each expert's live halves (`mlp_halves`) two at a
    time, the experts one after another, F innermost, so the F tiles of
    one pair run side by side (and re-gather its rows from L2), then the
    pairs of one expert (whose weights stay in L2). Block b of the grid
    takes tiles b, b + grid, ...; dead halves get no tile."""
    out = []
    for e, (live, _) in enumerate(halves):
        for j in range(0, len(live), 2):
            second = live[j + 1] if j + 1 < len(live) else -1
            out += [(e, live[j], second, f * MLP_COLS)
                    for f in range(plan.f_tiles)]
    return out


def mlp_live_halves(idx, T: int):
    """[E, H] bool: which MLP_HALF-slot half of each expert holds a filled
    slot (idx in [0, T)); slots past M count as empty."""
    E, M = idx.shape
    H = -(-M // MLP_HALF)
    filled = torch.zeros(E, H * MLP_HALF, dtype=torch.bool,
                         device=idx.device)
    filled[:, :M] = (idx >= 0) & (idx < T)
    return filled.reshape(E, H, MLP_HALF).any(-1)


def mlp_halves(idx, T: int) -> List[Tuple[List[int], List[int]]]:
    """Each expert's (live halves, dead halves), each in slot order: what
    the plan kernel of csrc/gather_mlp.cu writes. The products run over
    the live halves two at a time; a dead half gets zero rows of g, u and
    xin and no products."""
    live = mlp_live_halves(idx, T).cpu()
    return [([h for h in range(live.shape[1]) if live[e, h]],
             [h for h in range(live.shape[1]) if not live[e, h]])
            for e in range(live.shape[0])]


def mlp_scratch_ints(E: int, M: int) -> int:
    """int32s of the plan's scratch: live and dead half lists [E, H] each
    and their counts [E, 2]."""
    return 2 * E * -(-M // MLP_HALF) + 2 * E


def mlp_tma_dims(E: int, M: int, D: int, F: int) -> List[int]:
    """The 35 values csrc/gather_mlp.cu builds its five TMA tensor maps
    from (csrc/hopper_core.cuh::encode_map: extents innermost first, then
    the byte strides of dimensions 1-3; box 64 x 64, 128-byte swizzle,
    zero fill): wg and wu [E, D, F] as (F, D, E, 1), read in boxes of 64
    columns of F by 64 rows of D; xin [E, M, D] as (D, M, E, 1), g and u
    [E, M, F] as (F, M, E, 1), written in boxes of 64 columns by 64 slots.
    Rows are D or F bf16 values, whole 16-byte multiples since both are
    multiples of 8."""
    w = [F, D, E, 1, 2 * F, 2 * D * F, 2 * E * D * F]
    x = [D, M, E, 1, 2 * D, 2 * M * D, 2 * E * M * D]
    o = [F, M, E, 1, 2 * F, 2 * M * F, 2 * E * M * F]
    return w + w + x + o + o


def gather_mlp_kernel(src, idx, wg, wu):
    """(g, u, xin): g/u [E, M, F] = xin · wg[e] / wu[e] with xin[e, m] =
    src[idx[e, m]] (a zero row for -1) [E, M, D], all in src's dtype.

    src [T, D]; idx [E, M] int32; wg, wu [E, D, F]. On a CPU tensor: the
    plain version. On a CUDA tensor: the kernel (contiguous bf16 src, wg
    and wu, D and F multiples of 8, int32 idx); anything else raises.
    Each launch adds one to `gather_mlp_kernel.launches`."""
    if not src.is_cuda:
        return _gather_mlp_ref(src, idx, wg, wu)
    what = "gather_mlp"
    if src.dim() != 2:
        raise ValueError(f"{what}: src must be [T, D]; got "
                         f"{list(src.shape)}")
    _check_src(src[None], what)
    T, D = src.shape
    if idx.dim() != 2:
        raise ValueError(f"{what}: idx must be [E, M]; got "
                         f"{list(idx.shape)}")
    E, M = idx.shape
    _check_like(idx, (E, M), torch.int32, src.device, what, "idx")
    if wg.dim() != 3 or tuple(wg.shape[:2]) != (E, D):
        raise ValueError(f"{what}: wg must be [E={E}, D={D}, F]; got "
                         f"{list(wg.shape)}")
    F = wg.shape[2]
    if F % 8:
        raise ValueError(f"{what}: F = {F} must be a multiple of 8")
    for name, w in (("wg", wg), ("wu", wu)):
        _check_like(w, (E, D, F), torch.bfloat16, src.device, what, name)
        if w.data_ptr() % 16:
            raise TypeError(f"{what}: {name} must be 16-byte aligned")
    g = torch.empty(E, M, F, dtype=src.dtype, device=src.device)
    u = torch.empty_like(g)
    xin = torch.empty(E, M, D, dtype=src.dtype, device=src.device)
    if E * M == 0:
        return g, u, xin
    index = src.device.index if src.device.index is not None \
        else torch.cuda.current_device()
    plan = mlp_plan(E, M, F, sm_count(index))
    vals = mlp_tma_dims(E, M, D, F)
    maps = (ctypes.c_longlong * len(vals))(*vals)
    scratch = torch.empty(mlp_scratch_ints(E, M), dtype=torch.int32,
                          device=src.device)
    fn = _build.function("gather_mlp", "gather_mlp_bf16", _MLP_ARGTYPES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), idx.data_ptr(), wg.data_ptr(),
                 wu.data_ptr(), g.data_ptr(), u.data_ptr(), xin.data_ptr(),
                 T, E, M, D, F, maps, scratch.data_ptr(), plan.grid,
                 stream)
    _build.check(err, "gather_mlp_bf16")
    _build.count(gather_mlp_kernel)
    return g, u, xin


gather_mlp_kernel.launches = 0


class _GatherMlp(torch.autograd.Function):
    """The JAX `gather_mlp` custom_vjp: the fused kernel forward, keeping
    xin as the residual; the backward of `_gather_mlp_bwd`."""

    @staticmethod
    def forward(ctx, src, idx, inv_flat, w_flat, wg, wu):
        g, u, xin = gather_mlp_kernel(src.contiguous(), idx,
                                      wg.contiguous(), wu.contiguous())
        ctx.save_for_backward(xin, inv_flat, w_flat, wg, wu)
        return g, u

    @staticmethod
    def backward(ctx, dg, du):
        xin, inv_flat, w_flat, wg, wu = ctx.saved_tensors
        # f32 accumulation, one rounding (JAX: preferred_element_type f32)
        xt = xin.transpose(1, 2)
        dwg = torch.matmul(xt, dg).to(wg.dtype)
        dwu = torch.matmul(xt, du).to(wu.dtype)
        dxin = (torch.matmul(dg, wg.transpose(1, 2)) +
                torch.matmul(du, wu.transpose(1, 2)))
        E, M, D = dxin.shape
        # back to the tokens through the forward map: the weighted gather
        # (w zeroes dropped choices), the k-sum fused
        dsrc = gather_wsum(dxin.reshape(1, E * M, D).contiguous(),
                           inv_flat[None].contiguous(),
                           w_flat[None].float().contiguous())[0]
        return dsrc.to(xin.dtype), None, None, None, dwg, dwu


def gather_mlp(src, idx, inv_flat, w_flat, wg, wu):
    """Fused dispatch + gate/up projection (JAX `gather_mlp` with
    use_pallas): (g, u) [E, M, F].

    src [T, D] tokens; idx [E, M] int32, the source token of each slot
    (-1 empty); inv_flat [T, k] int32 the forward map (the slot of each
    (token, choice), CLIPPED to valid rows) and w_flat [T, k] its
    validity weights (1 routed, 0 dropped), used by the backward's
    gather of d_xin back to the tokens; wg, wu [E, D, F]. The gathered
    rows never surface: they are the backward's residual."""
    return _GatherMlp.apply(src, idx, inv_flat, w_flat, wg, wu)


# ----------------------------------------------------------- dispatch
def _dispatch_bwd(g, flat, k):
    """dx[b, t] = Σ_j g[b, flat[b, t·k + j]] over the routed choices: a
    k-row gather_wsum over the forward map (clipped, weight 0 where the
    choice was dropped)."""
    B, Mk = flat.shape
    idx = flat.clamp(min=0).reshape(B, Mk // k, k)
    w = (flat >= 0).float().reshape(B, Mk // k, k)
    return gather_wsum(g.contiguous(), idx, w)


class _DispatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inv_tok, flat, k):
        ctx.save_for_backward(flat)
        ctx.k = k
        idx1 = inv_tok.clamp(min=0)[..., None]
        w1 = (inv_tok >= 0).float()[..., None]
        return gather_wsum(x.contiguous(), idx1, w1)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        return _dispatch_bwd(g, flat, ctx.k), None, None, None


def dispatch_gather(x, inv_tok, flat, k: int):
    """MoE dispatch: x [B, S, D]; inv_tok [B, E·C] int32 (the token
    filling each slot, -1 = empty) → expert_in [B, E·C, D], zero rows at
    empty slots. flat [B, S·k] int32 (the slot of each (token, choice),
    -1 = dropped) is the inverse map, used only by the gradient
    (`_dispatch_bwd`)."""
    return _DispatchGather.apply(x, inv_tok, flat, k)


# ------------------------------------------------------------ combine
class _CombineWsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eout, idx_tk, w, inv_pos):
        ctx.save_for_backward(eout, w, inv_pos)
        return gather_wsum(eout.contiguous(), idx_tk, w)

    @staticmethod
    def backward(ctx, dy):
        eout, w, inv_pos = ctx.saved_tensors
        B, T, k = w.shape
        live = inv_pos >= 0
        # per-slot scale: the gate prob of the (token, choice) filling it
        w_slot = torch.where(
            live, torch.gather(w.reshape(B, T * k), 1,
                               inv_pos.clamp(min=0).long()), 0.0)
        tok = torch.where(live, torch.div(inv_pos, k, rounding_mode="floor"),
                          0)
        d_eout, dot = gather_scale_dot(dy.contiguous(), tok, w_slot,
                                       eout.contiguous())
        # d_w[t, j] = dy[t] · eout[slot(t, j)]: each slot's dot goes back
        # to its (token, choice); the slot map is injective, so the
        # scatter writes each position at most once, and empty slots
        # write to a sink past the end that is dropped
        pos = torch.where(live, inv_pos, T * k).long()
        d_w = torch.zeros(B, T * k + 1, dtype=torch.float32,
                          device=dy.device).scatter_(1, pos, dot)
        return d_eout, None, d_w[:, :T * k].reshape(B, T, k).to(w.dtype), \
            None


def combine_wsum(eout, idx_tk, w, inv_pos):
    """Fused MoE combine: y[b, t] = Σ_j w[b, t, j] · eout[b, idx_tk[b, t, j]].

    CONTRACT (the backward depends on it): idx_tk [B, T, k] int32 is
    CLIPPED to valid rows and w [B, T, k] f32 is PRE-ZEROED at dropped
    choices, w = where(flat >= 0, probs, 0). The backward returns d_w = 0
    for dropped choices, which is the gradient only under that
    pre-zeroing: with raw gate probs and clipped indices the forward
    would have d_w = dy · eout[0] there. inv_pos [B, M] int32 is the
    inverse map (the flat position t·k + j filling each slot, -1 = empty),
    used only by the backward: d_eout[m] = w_slot[m] · dy[inv_pos[m] // k]
    and its per-slot dot, one gather_scale_dot."""
    return _CombineWsum.apply(eout, idx_tk, w, inv_pos)
