"""The flash kernels at every shape `chip_smoke.py` holds them, on one GPU.

    python -m paddle_tpu_torch.tools.bench_flash [--check] [--label L]
        [--dtype bf16|f16|f32] [--cases I,J] [--fwd-only] [--plain]

Builds `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu` (`--dtype f32`:
`csrc/flash_f32.cu`), prints each one's
ptxas lines and the `HGMMA` / `UTMALDG` instruction counts that
`cuobjdump -sass` finds in its library, then, for each held shape
(`--cases`: only those of the given indices into `held`), one
JSON line: the kernel's and SDPA's times (CUDA events, means after one
warm-up call; `--fwd-only`: the forward alone, no backward checked or
timed; `*_graph_ms`: the same calls captured in one CUDA
graph, the device time with no host cost) and the bound (bytes over
3.35 TB/s or operations over 989 TFLOP/s, the larger; `--plain`: also
the plain versions' times, `fwd_plain_ms` and `bwd_plain_ms`), beside the
forward's largest error relative to each (query, head) output vector's
scale (and the LSE's absolute error) or the backward's (dq, dk, dv; rows below 1e-3 of the largest held
relative to that) against the plain versions. `--check` stops after the
errors of small and odd shapes (no timing) and exits 1 if any exceeds
2e-2 (LSE 5e-4) or a backward is not bit-identical twice. `--dtype f16`
runs every case in f16 (the kernels' f16 option), held to 1.25e-3: the
same 2.5 ulps of the vector's largest element that 2e-2 is in bf16.
In f16 each backward also reports `dq_vs_rounded_ds`: its dq against
the plain dq with dS rounded to f16 before dS·K (as the kernel takes it,
one f16 A operand), and `dq_f64`: the kernel's and the plain version's
dq against the same function computed in f64, and the vector where the
two part most.
`--dtype f32` runs the f32 option (csrc/flash_f32.cu, TF32 tensor
cores) held to chip_smoke.py's F32_TOL 2.5e-3 and LSE 1e-4, its bound
at the TF32 rate (495 TFLOP/s). It uses only
the wrappers' public functions, so the same file times an older checkout
of the package (run it from that checkout's root) in turns with this one
on one card. The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

TOL, LSE_TOL, FLOOR = 2e-2, 5e-4, 1e-3
# the inputs' dtype, its tolerance (2.5 ulps of the largest element;
# f32: five TF32 roundings of the largest term), the LSE's and the
# tensor-core rate of the bound
DTYPES = {"bf16": (torch.bfloat16, 2e-2, 5e-4, 989e12),
          "f16": (torch.float16, 1.25e-3, 5e-4, 989e12),
          "f32": (torch.float32, 2.5e-3, 1e-4, 495e12)}
_DT = torch.bfloat16
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PLAIN = False                 # --plain: time the plain versions too
H, KV, HD = 32, 8, 128


def _time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def _graph_ms(fn, iters):
    """Device time of one fn() with no host cost: `iters` calls captured
    in one CUDA graph, replayed, timed with events."""
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _rel(out, ref, valid=None, floor=0.0):
    d = (out.float() - ref.float()).abs().amax(-1)
    r = ref.float().abs().amax(-1)
    if valid is not None:
        d, r = d[valid], r[valid]
    if floor:
        r = torch.clamp(r, min=floor * r.max().item())
    return (d / r).max().item()


def _dq_plain(q, k, v, out, lse, dout, causal=True, key_mask=None,
              layout="bshd", ds_dtype=None, acc=torch.float32):
    """The plain backward's dq ('bshd'), computed in `acc` (f32, as the
    plain version; f64: nearly exact for these inputs) and rounded to
    q's dtype, or left in `acc` with `ds_dtype` None and acc f64. With
    `ds_dtype`, dS is rounded to it before dS·K: what a kernel taking dS
    as one operand of that type computes. Beside the plain dq (an f32 dS,
    as the JAX kernel multiplies), these show which one the kernel
    follows, and how far each is from exact."""
    import math
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, out, dout = (fa._bshd(t, layout) for t in (q, k, v, out, dout))
    Sq, Sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    ke, ve = fa._expand_kv(q, k, v)
    kf, dof = ke.to(acc), dout.to(acc)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kf) * scale
                  - lse.to(acc)[..., None])
    vis = fa._visible(Sq, Sk, causal, key_mask, q.device)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, ve.to(acc))
    dcap = (dof * out.to(acc)).sum(-1).transpose(1, 2)
    ds = p * (dp - dcap[..., None]) * scale
    if ds_dtype is not None:
        ds = ds.to(ds_dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq if acc == torch.float64 else dq.to(q.dtype)


def _bound(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def _inputs(B, S, h, kv, hd, layout, lengths, gen):
    def make(n):
        x = torch.randn(B, S, n, hd, device="cuda", generator=gen).to(_DT)
        return x.transpose(1, 2).contiguous() if layout == "bhsd" else x
    q, k, v, do = make(h), make(kv), make(kv), make(h)
    km = None if lengths is None else \
        torch.arange(S, device="cuda")[None] < lengths[:, None]
    return q, k, v, do, km


def case(B, S, h, kv, hd, causal, layout="bshd", lengths=None, gen=None,
         which=("fwd", "bwd"), timed=True, name=""):
    """One shape: errors against the plain versions, then times."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, km = _inputs(B, S, h, kv, hd, layout, lengths, gen)
    kw = dict(causal=causal, layout=layout)
    if km is not None:
        kw["key_mask"] = km
    bshd = (lambda x: x.transpose(1, 2)) if layout == "bhsd" else \
        (lambda x: x)
    seen = (torch.ones(B, dtype=torch.bool, device="cuda") if km is None
            else km.any(1))
    rows = seen[:, None, None].expand(B, S, h)
    res = {"shape": name or f"B={B} S={S} H={h} KV={kv} hd={hd}"
           + ("" if causal else " non-causal") + f" {layout}"
           + ("" if km is None else " masked")}
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    ref, lse_r = fa.flash_attention_fwd_ref(q, k, v, return_lse=True, **kw)
    res["fwd_rel"] = _rel(bshd(out), bshd(ref), rows)
    res["lse_err"] = (lse - lse_r)[seen].abs().max().item()
    ok = res["fwd_rel"] <= TOL and res["lse_err"] <= LSE_TOL
    del ref, lse_r
    if "bwd" in which:
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        rgot = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        res["bwd_rel"] = {
            n: _rel(bshd(a), bshd(b), rows if n == "dq" else None, FLOOR)
            for n, a, b in zip(("dq", "dk", "dv"), got, rgot)}
        res["repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = ok and res["repeat"] and max(res["bwd_rel"].values()) <= TOL
        if _DT == torch.float16:
            # the kernel's dq against dS rounded to f16 before dS·K, the
            # one f16 operand the kernel takes, where the plain version
            # multiplies an f32 dS
            res["dq_vs_rounded_ds"] = _rel(
                bshd(got[0]), _dq_plain(q, k, v, out, lse, do,
                                        ds_dtype=_DT, **kw), rows, FLOOR)
            # the kernel's and the plain version's dq against the same
            # function in f64, and where the kernel and the plain version
            # part most: (batch, query, head), the keys that query sees
            # and its vector's scale over the largest vector's
            exact = _dq_plain(q, k, v, out, lse, do, acc=torch.float64,
                              **kw)
            kq, pq = bshd(got[0]).double(), bshd(rgot[0]).double()
            scale_v = exact.abs().amax(-1)
            floor = torch.clamp(scale_v, min=FLOOR * scale_v.max().item())
            apart = (kq - pq).abs().amax(-1) / floor
            apart[~rows] = 0
            b_, i_, h_ = (int(x) for x in torch.unravel_index(
                apart.argmax(), apart.shape))
            sk = k.shape[2 if layout == "bhsd" else 1]
            res["dq_f64"] = {
                "kernel": ((kq - exact).abs().amax(-1) / floor)[rows]
                .max().item(),
                "plain": ((pq - exact).abs().amax(-1) / floor)[rows]
                .max().item(),
                "worst": {"at": [b_, i_, h_],
                          "keys": min(i_ + 1 + sk - S, sk) if causal
                          else sk,
                          "scale_over_max": (scale_v[b_, i_, h_]
                                             / scale_v.max()).item(),
                          "kernel_vs_plain": apart[b_, i_, h_].item(),
                          "kernel_vs_f64": ((kq - exact)[b_, i_, h_].abs()
                                            .max() / floor[b_, i_, h_])
                          .item(),
                          "plain_vs_f64": ((pq - exact)[b_, i_, h_].abs()
                                           .max() / floor[b_, i_, h_])
                          .item()}}
        del got, again, rgot
    res["ok"] = ok
    torch.cuda.empty_cache()
    if not timed:
        return res
    pairs = (S * (S + 1) // 2 if causal else S * S) * B
    if km is not None:
        pairs = float(S) * int(km.sum())
    heads = (lambda x: x) if layout == "bhsd" else \
        (lambda x: x.transpose(1, 2))
    qt, kt, vt, dot = (heads(x) for x in (q, k, v, do))
    mask4 = None if km is None else km[:, None, None, :]

    def sdpa():
        if mask4 is None:
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4,
                                              enable_gqa=True)
    if "fwd" in which:
        res["fwd_ms"] = _time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, return_lse=True, **kw), 20)
        res["fwd_graph_ms"] = _graph_ms(lambda: fa.flash_attention_fwd(
            q, k, v, return_lse=True, **kw), 20)
        if PLAIN:
            res["fwd_plain_ms"] = _time_ms(lambda: fa.flash_attention_fwd_ref(
                q, k, v, return_lse=True, **kw), 3)
        res["fwd_sdpa_ms"] = _time_ms(sdpa, 20)
        res["fwd_sdpa_graph_ms"] = _graph_ms(sdpa, 20)
        res["fwd_bound_ms"] = _bound(
            4.0 * h * hd * pairs,
            _DT.itemsize * B * S * hd * (2 * h + 2 * kv) + 4.0 * B * h * S)
    if "bwd" in which:
        res["bwd_ms"] = _time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, **kw), 10)
        res["bwd_graph_ms"] = _graph_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, **kw), 10)
        if PLAIN:
            res["bwd_plain_ms"] = _time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, out, lse, do, **kw), 3)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))

        def fwd():
            if mask4 is None:
                return F.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=causal, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask4, enable_gqa=True)
        with torch.enable_grad():
            both = _time_ms(lambda: torch.autograd.grad(
                fwd(), (qg, kg, vg), dot), 5)
            res["bwd_sdpa_ms"] = both - _time_ms(fwd, 5)
        res["bwd_bound_ms"] = _bound(
            10.0 * h * hd * pairs,
            _DT.itemsize * B * S * hd * (4 * h + 4 * kv) + 4.0 * B * h * S)
    torch.cuda.empty_cache()
    return res


def held(gen):
    """The shapes chip_smoke.py holds the flash kernels at, S=8192, the
    f32 trainer's B=16 (index 15) and the held causal [1, 300, 4/1, 72]
    (index 16: hd 72, a length off every tile, GQA 4:1)."""
    from paddle_tpu_torch.nlp import ernie
    from paddle_tpu_torch.tools.ernie_finetune import padded_batch
    lengths = padded_batch(ernie.ErnieConfig.ernie3_base(), 64, 512)[2] \
        .sum(1).to("cuda")
    small = torch.randint(128, 513, (16,), device="cuda", generator=gen)
    few = torch.tensor([0, 512, 200, 77], device="cuda")
    fwd_only = ("fwd",)
    return [
        dict(B=2, S=128, h=H, kv=KV, hd=HD, causal=True, which=fwd_only),
        dict(B=2, S=512, h=H, kv=KV, hd=HD, causal=True, which=fwd_only),
        dict(B=2, S=700, h=H, kv=KV, hd=HD, causal=True, which=fwd_only),
        dict(B=8, S=2048, h=H, kv=KV, hd=HD, causal=True),
        dict(B=20, S=2048, h=16, kv=8, hd=HD, causal=True),
        dict(B=1, S=4096, h=H, kv=KV, hd=HD, causal=True),
        dict(B=64, S=512, h=12, kv=12, hd=64, causal=False),
        dict(B=2, S=2048, h=H, kv=KV, hd=HD, causal=True),
        dict(B=64, S=512, h=12, kv=12, hd=64, causal=False, layout="bhsd",
             lengths=lengths, name="ERNIE masked bhsd"),
        dict(B=16, S=512, h=12, kv=12, hd=64, causal=False, lengths=small),
        dict(B=64, S=512, h=12, kv=12, hd=64, causal=False, layout="bhsd"),
        dict(B=4, S=512, h=12, kv=12, hd=64, causal=False, layout="bhsd",
             lengths=few, name="row 0 sees no key"),
        dict(B=16, S=500, h=12, kv=12, hd=64, causal=False, layout="bhsd",
             lengths=small.clamp(max=500)),
        dict(B=96, S=256, h=16, kv=16, hd=72, causal=False, layout="bhsd"),
        dict(B=1, S=8192, h=8, kv=2, hd=HD, causal=True),
        dict(B=16, S=2048, h=H, kv=KV, hd=HD, causal=True),
        dict(B=1, S=300, h=4, kv=1, hd=72, causal=True),
    ]


def small_cases(gen):
    """Small and odd shapes for --check: one tile, ragged Sq and Sk,
    Sq < Sk (serving's bottom-right diagonal), every head_dim, GQA,
    both layouts, a mask with an empty row (over 200 and 512 keys)."""
    m = torch.tensor([0, 37, 130, 200], device="cuda")
    out = []
    for hd in (64, 72, 128):
        for layout in ("bshd", "bhsd"):
            out += [dict(B=2, S=128, h=4, kv=2, hd=hd, causal=True,
                         layout=layout),
                    dict(B=1, S=300, h=4, kv=1, hd=hd, causal=True,
                         layout=layout),
                    dict(B=2, S=200, h=2, kv=2, hd=hd, causal=False,
                         layout=layout),
                    dict(B=4, S=200, h=2, kv=2, hd=hd, causal=False,
                         layout=layout, lengths=m)]
    # 512 keys: eight key tiles of 64, each with a state byte of its own
    m512 = torch.tensor([0, 512, 300, 77], device="cuda")
    out += [dict(B=4, S=512, h=2, kv=2, hd=hd, causal=False, layout="bhsd",
                 lengths=m512) for hd in (64, 128)]
    return out


def sq_lt_sk(gen):
    """Causal Sq < Sk (chunked prefill's shape): the forward and backward
    against the plain versions."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    res = []
    for sq, sk, hd in ((64, 300, 128), (130, 514, 64), (1, 129, 72)):
        q = torch.randn(2, sq, 4, hd, device="cuda", generator=gen).to(_DT)
        k, v = (torch.randn(2, sk, 2, hd, device="cuda", generator=gen)
                .to(_DT) for _ in range(2))
        do = torch.randn_like(q)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
        ref, lse_r = fa.flash_attention_fwd_ref(q, k, v, return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do)
        rgot = fa.flash_attention_bwd_ref(q, k, v, out, lse, do)
        r = {"shape": f"Sq={sq} Sk={sk} hd={hd} causal",
             "fwd_rel": _rel(out, ref),
             "lse_err": (lse - lse_r).abs().max().item(),
             "bwd_rel": {n: _rel(a, b, floor=FLOOR) for n, a, b in
                         zip(("dq", "dk", "dv"), got, rgot)}}
        r["ok"] = (r["fwd_rel"] <= TOL and r["lse_err"] <= LSE_TOL
                   and max(r["bwd_rel"].values()) <= TOL)
        res.append(r)
    return res


def build_report():
    from paddle_tpu_torch import _build
    libs = ["flash_f32"] if _DT == torch.float32 else ["flash_fwd",
                                                       "flash_bwd"]
    logs = _build.build_all(libs)
    rep = {}
    for n in libs:
        sass = subprocess.run(
            [_build.cuobjdump(), "-sass", str(_build.library_path(n))],
            capture_output=True, text=True, check=True).stdout
        rep[n] = {"HGMMA": sass.count("HGMMA"),
                  "UTMALDG": sass.count("UTMALDG"),
                  "ptxas": [ln.strip() for ln in logs.get(n, "").splitlines()
                            if "registers" in ln or "spill" in ln
                            or "arning" in ln or "wgmma" in ln]}
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain versions too")
    ap.add_argument("--cases", default="",
                    help="comma-separated indices into the held shapes "
                         "(default: all)")
    args = ap.parse_args(argv)
    global _DT, TOL, LSE_TOL, PEAK_FLOPS, PLAIN
    _DT, TOL, LSE_TOL, PEAK_FLOPS = DTYPES[args.dtype]
    PLAIN = args.plain
    if not torch.cuda.is_available():
        print("bench_flash: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    if args.check:
        print(json.dumps({"build": build_report()}), flush=True)
        for c in small_cases(gen):
            r = case(gen=gen, timed=False, **c)
            ok = ok and r["ok"]
            print(json.dumps(r), flush=True)
        for r in sq_lt_sk(gen):
            ok = ok and r["ok"]
            print(json.dumps(r), flush=True)
    else:
        shapes = held(gen)
        if args.cases:
            shapes = [shapes[int(i)] for i in args.cases.split(",")]
        for c in shapes:
            if args.fwd_only:
                c = {**c, "which": ("fwd",)}
            r = case(gen=gen, **c)
            ok = ok and r["ok"]
            print(json.dumps({"label": args.label, **r}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
