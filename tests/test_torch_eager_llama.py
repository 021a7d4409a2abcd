"""The eager Llama slice of the port against the JAX package, on the CPU.

Each check runs the same numpy inputs through `paddle_tpu` (JAX) and
`paddle_tpu_torch`: the row-6 RMSNorm (`rms_norm_pallas`, run by the
Pallas interpreter, against the port's plain version, which the CUDA
kernel `rms_fused_*` of csrc/rms_norm.cu is held to on the card), the
eager ops `fused_rms_norm`, `fused_rotary_position_embedding` and
`swiglu` (values and grads), and a tiny Llama composed from layers
(`tools/eager_llama.py`, written once over the package module) whose
weights move across by `set_state_dict`: loss, every gradient and three
AdamW steps.

Tolerances: in f32 the two sides run the same expressions and differ in
summation order only: 1e-6 relative for the norm's rows and the eager
ops' values, 1e-5 for their grads (sums over a row) and the tiny
Llama's loss and grads (relative to each tensor's largest element);
parameters after 3 AdamW steps of lr 1e-3 within 1 % of the distance
those steps can move one (Adam divides each gradient by its own running
magnitude, so summation noise in a near-zero gradient is a visible part
of its step). bf16 norm outputs are the same f32 values rounded once:
within one bf16 ulp of each row's largest element (2^-7 relative to it,
held at 8e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.kernels import rms_norm as jrn  # noqa: E402
from paddle_tpu.nlp import llama as jllama  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trn  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.tools.eager_llama import (  # noqa: E402
    build_model, lm_loss, train_step)

F32_TOL = 1e-6
GRAD_TOL = 1e-5
BF16_TOL = 8e-3
STEP_TOL = 1e-2         # of the distance `STEPS` AdamW steps can move
STEPS, LR = 3, 1e-3
PKGS = {"jax": jp, "torch": tp}
LLAMA = {"jax": jllama, "torch": tllama}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max() / scale
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 256])
def test_row6_plain_matches_pallas_interpret(dtype, d):
    """rms_norm_pallas (TPU interpreter; 300 rows: the 256-row block pads)
    against rms_norm_fused's plain version, per row."""
    rng = np.random.default_rng(d)
    x = 2.0 * rng.standard_normal((3, 100, d)) + 0.3
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    with pltpu.force_tpu_interpret_mode():
        out_j = jrn.rms_norm_pallas(xj, jnp.asarray(w), 1e-6)
    out_t = trn.rms_norm_fused(xt, torch.from_numpy(w), 1e-6)
    assert out_t.dtype == xt.dtype and out_t.shape == xt.shape
    oj = np.array(out_j.astype(jnp.float32))
    ot = out_t.float().numpy()
    err = (np.abs(ot - oj).max(-1) / np.abs(oj).max(-1)).max()
    assert err <= (BF16_TOL if dtype == "bf16" else F32_TOL), err
    # the dispatch and the affine-free form are the plain version too
    assert torch.equal(trn.rms_norm(xt, torch.from_numpy(w), 1e-6), out_t)
    np.testing.assert_allclose(
        trn.rms_norm_fused(xt, None, 1e-6).float().numpy(),
        np.array(jrn.rms_norm_ref(xj, None, 1e-6).astype(jnp.float32)),
        rtol=BF16_TOL if dtype == "bf16" else F32_TOL, atol=1e-6)


def test_row6_cpu_counts_no_launch():
    trn.rms_norm_fused.launches = 0
    x = torch.randn(4, 64)
    trn.rms_norm_fused_train(x.requires_grad_(True), torch.ones(64)).sum() \
        .backward()
    assert trn.rms_norm_fused.launches == 0 and x.grad is not None


def _eager_op(pkg, name, arrays, kwargs):
    """One eager op of `pkg` on Tensors made from `arrays` (None passes
    through); returns (outputs as numpy, grads of sum(out_i * c_i) as
    numpy) with fixed cotangent weights c_i."""
    inc = pkg.incubate.nn.functional
    ts = [None if a is None else pkg.to_tensor(a, stop_gradient=False)
          for a in arrays]
    if name == "fused_rms_norm":
        outs = [inc.fused_rms_norm(ts[0], ts[1], ts[2], **kwargs)]
    elif name == "swiglu":
        outs = [inc.swiglu(*[t for t in ts if t is not None])]
    else:
        q, k, _ = inc.fused_rotary_position_embedding(
            ts[0], ts[1], None, sin=kwargs.get("sin"), cos=kwargs.get("cos"),
            position_ids=kwargs.get("position_ids"),
            use_neox_rotary_style=kwargs["neox"])
        outs = [q, k]
    rng = np.random.default_rng(7)
    loss = None
    for o in outs:
        c = pkg.to_tensor(rng.standard_normal(o.shape).astype(np.float32))
        term = (o * c).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return ([o.numpy() for o in outs],
            [None if t is None else t.grad.numpy() for t in ts])


@pytest.mark.parametrize("mask", ["flash_gqa", "bool", "additive"])
def test_attention_functionals_match_jax(mask):
    """F.flash_attention (GQA K/V unexpanded, causal) and SDPA with a bool
    or an additive float mask: values and grads against JAX's eager ops
    on the same f32 inputs."""
    rng = np.random.default_rng(13)
    B, S, H, hd = 2, 8, 4, 16
    kv = 2 if mask == "flash_gqa" else H
    arrays = [rng.standard_normal((B, S, n, hd)).astype(np.float32)
              for n in (H, kv, kv)]
    m = None
    if mask == "bool":
        m = rng.random((B, 1, S, S)) < 0.8
        m[..., 0] = True
    elif mask == "additive":
        m = (-3.0 * rng.random((B, 1, S, S))).astype(np.float32)
    res = {}
    for n, p in PKGS.items():
        F = p.nn.functional
        ts = [p.to_tensor(a, stop_gradient=False) for a in arrays]
        if m is None:
            out = F.flash_attention(*ts, causal=True)[0]
        else:
            out = F.scaled_dot_product_attention(*ts,
                                                 attn_mask=p.to_tensor(m))
        c = p.to_tensor(np.random.default_rng(7).standard_normal(
            out.shape).astype(np.float32))
        (out * c).sum().backward()
        res[n] = [out.numpy()] + [t.grad.numpy() for t in ts]
    for i, (a, b) in enumerate(zip(res["torch"], res["jax"])):
        _close(a, b, F32_TOL if i == 0 else GRAD_TOL, f"{mask} {i}")


def _rope_case(neox, with_pos, with_tables, heads=True):
    """q, k ([B, S, H|KV, hd], or [B, S, hd] without `heads`) and the
    op's keyword arguments."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 8, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd) if heads else (B, S, hd))
    k = rng.standard_normal((B, S, KV, hd) if heads else (B, S, hd))
    q, k = q.astype(np.float32), k.astype(np.float32)
    kw = {"neox": neox}
    if with_pos:
        kw["position_ids"] = rng.integers(0, 20, (B, S))
    if with_tables:
        inv = 1.0 / (500000.0 ** (np.arange(0, hd, 2) / hd))
        f = np.outer(np.arange(32), inv).astype(np.float32)
        kw["cos"], kw["sin"] = np.cos(f), np.sin(f)
    return [q, k], kw


@pytest.mark.parametrize("case", [
    "rms_affine", "rms_bias", "swiglu_two", "swiglu_one",
    "rope_neox", "rope_neox_tables_pos", "rope_interleaved_tables"])
def test_eager_ops_match_jax(case):
    """fused_rms_norm, swiglu and fused_rotary_position_embedding: values
    and the grads of a weighted sum of the outputs, against JAX's eager
    ops on the same f32 inputs."""
    rng = np.random.default_rng(11)
    if case.startswith("rms"):
        name = "fused_rms_norm"
        arrays = [rng.standard_normal((3, 5, 64)).astype(np.float32),
                  (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
                  (0.1 * rng.standard_normal(64)).astype(np.float32)
                  if case == "rms_bias" else None]
        kwargs = {"epsilon": 1e-5}
    elif case.startswith("swiglu"):
        name = "swiglu"
        x = rng.standard_normal((3, 5, 32)).astype(np.float32)
        arrays = [x, rng.standard_normal((3, 5, 32)).astype(np.float32)] \
            if case == "swiglu_two" else [x]
        kwargs = {}
    else:
        name = "fused_rope"
        # the JAX package's interleaved form takes [B, S, D] only
        arrays, kwargs = _rope_case("neox" in case, "pos" in case,
                                    "tables" in case, "neox" in case)
    res = {}
    for n, p in PKGS.items():
        kw = dict(kwargs)
        for key in ("sin", "cos", "position_ids"):
            if key in kw:
                kw[key] = p.to_tensor(kw[key])
        res[n] = _eager_op(p, name, arrays, kw)
    (oj, gj), (ot, gt) = res["jax"], res["torch"]
    for a, b in zip(ot, oj):
        _close(a, b, F32_TOL, f"{case} out")
    for a, b in zip(gt, gj):
        assert (a is None) == (b is None)
        if b is not None:
            _close(a, b, GRAD_TOL, f"{case} grad")


def _cfg(mod):
    # few distinct shapes: the JAX eager API compiles each op per shape
    return mod.LlamaConfig.tiny(vocab_size=96, hidden_size=64,
                                intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=2,
                                max_position_embeddings=32)


@pytest.fixture(scope="module")
def llama_runs():
    """The same composition from both packages with the JAX model's
    initial weights: the models, the weights, and per package the loss
    and every grad of one f32 forward + backward, then the step losses
    and parameters after STEPS AdamW steps with the global clip."""
    prev = tdevice._current_place
    tp.set_device("cpu")
    try:
        models = {n: build_model(p, _cfg(LLAMA[n])) for n, p in PKGS.items()}
        sd = {k: np.array(v.numpy()) for k, v in
              models["jax"].state_dict().items()}
        # norm gains off 1, so their gradients and the weight are tested
        rng = np.random.default_rng(4)
        for k in sd:
            if "norm" in k:
                sd[k] = (1 + 0.1 * rng.standard_normal(sd[k].shape)) \
                    .astype(np.float32)
        tokens = np.random.default_rng(5).integers(0, 96, (2, 24))
        out = {}
        for n, p in PKGS.items():
            m = models[n]
            m.set_state_dict(sd)
            loss_fn = p.nn.CrossEntropyLoss()
            x = p.to_tensor(tokens)
            loss = lm_loss(loss_fn, m(x), x)
            loss.backward()
            grads = {k: q.grad.numpy().copy()
                     for k, q in m.named_parameters()}
            m.clear_gradients()
            opt = p.optimizer.AdamW(
                learning_rate=LR, parameters=m.parameters(),
                grad_clip=p.nn.ClipGradByGlobalNorm(1.0))
            losses = [train_step(p, m, loss_fn, opt, x, None).item()
                      for _ in range(STEPS)]
            out[n] = (loss.item(), grads, losses,
                      {k: q.numpy().copy() for k, q in
                       m.named_parameters()})
        return models, sd, out
    finally:
        tdevice._current_place = prev


def test_eager_llama_names_and_counts(llama_runs):
    names = {n: [k for k, _ in m.named_parameters()]
             for n, m in llama_runs[0].items()}
    assert names["jax"] == names["torch"]
    assert len(names["torch"]) == 1 + 2 * 9 + 2
    cfg = _cfg(tllama)
    assert tllama.flops_per_token(cfg, 24) == \
        jllama.flops_per_token(_cfg(jllama), 24)


def test_eager_llama_f32_loss_grads_and_steps(llama_runs):
    _, sd, out = llama_runs
    (loss_j, gj, sj, pj), (loss_t, gt, st, pt) = out["jax"], out["torch"]
    _close([loss_t], [loss_j], GRAD_TOL, "loss")
    _close(st, sj, GRAD_TOL, "step losses")
    assert set(gt) == set(gj) and len(gt) == 21
    for k in gj:
        _close(gt[k], gj[k], GRAD_TOL, f"grad {k}")
    moved = 0.0
    for k in pj:
        err = np.abs(pt[k] - pj[k]).max()
        assert err <= STEP_TOL * STEPS * LR, f"param {k}: {err}"
        moved = max(moved, np.abs(pj[k] - sd[k]).max())
    assert moved > LR                               # the steps did move
    assert sj[-1] < sj[0]


def test_interleaved_rope_position_ids():
    """Interleaved RoPE over [B, S, H, D] (the JAX package's `apply_rope`
    broadcasts its table rows against [B, S, D] only and raises here), so
    held against numpy: position_ids 0..S-1 give the no-position result,
    and shifted positions rotate by the table rows they name."""
    inc = tp.incubate.nn.functional
    (q, k), kw = _rope_case(False, False, True)
    qt, kt = tp.to_tensor(q), tp.to_tensor(k)
    cos, sin = tp.to_tensor(kw["cos"]), tp.to_tensor(kw["sin"])
    base = inc.fused_rotary_position_embedding(
        qt, kt, None, sin=sin, cos=cos, use_neox_rotary_style=False)
    pos = np.broadcast_to(np.arange(q.shape[1]), q.shape[:2])
    got = inc.fused_rotary_position_embedding(
        qt, kt, None, sin=sin, cos=cos, position_ids=tp.to_tensor(pos),
        use_neox_rotary_style=False)
    for a, b in zip(got[:2], base[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    shifted = inc.fused_rotary_position_embedding(
        qt, None, None, sin=sin, cos=cos,
        position_ids=tp.to_tensor(pos + 3), use_neox_rotary_style=False)[0]
    c, s_ = kw["cos"][3:3 + q.shape[1]], kw["sin"][3:3 + q.shape[1]]
    x1, x2 = q[..., 0::2], q[..., 1::2]
    want = np.stack([x1 * c[None, :, None] - x2 * s_[None, :, None],
                     x2 * c[None, :, None] + x1 * s_[None, :, None]],
                    -1).reshape(q.shape)
    np.testing.assert_allclose(shifted.numpy(), want, rtol=1e-6, atol=1e-6)
