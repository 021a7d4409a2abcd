"""Mixed precision in the port against the JAX package, on the CPU.

The same numpy values go through `paddle_tpu` (JAX) and
`paddle_tpu_torch`:

- `amp.decorate` (O2) with `AdamW(multi_precision)` over a 2-layer MLP in
  bf16 and f16, 5 steps fed the same gradients: the parameters within
  one ulp of their dtype of JAX's, the f32 masters within 1e-6; and 3
  steps of O2 training end to end (bf16; f16 with GradScaler);
- `GradScaler`'s schedule over fixed sequences of found-inf flags, and
  the JAX package's own `TestAMP` cases (tests/test_optimizer_amp.py);
- the Layer methods that come with O2 (`to`, `astype`, `float`, `half`,
  `bfloat16`, `apply`, `children`, `named_children`, `set_dict`,
  `load_dict`, `set_state_dict` of a JAX model's bf16 numpy state);
- F10: BatchNorm, GroupNorm and InstanceNorm over {train, eval} x
  {weight f32, bf16, none} x {input f32, bf16}: JAX's output dtypes;
- the f16 plain versions of rows 1-6 and 9-10 (the CUDA kernels' f16
  options are held to them on the card) against the JAX kernels run as
  the JAX package's tests run them (Pallas interpret mode), one tiny
  shape each.

Tolerances: the JAX package computes the norms and O2's products in the
16-bit type where the port computes in f32 and rounds once, so 16-bit
results agree within a few ulps: bf16 3e-2, f16 4e-3 of the largest
value (8 ulps of a largest element in [1, 2)). The kernels' f16 plain
versions and the Pallas interpreter both accumulate in f32 and round
once: within 2 f16 ulps (2e-3), the LSE within 1e-5. f32 results 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.kernels import layer_norm as jln  # noqa: E402
from paddle_tpu.kernels import rms_norm as jrn  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as tln  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trn  # noqa: E402

PKGS = (jp, tp)
TOL16 = {"bfloat16": 3e-2, "float16": 4e-3, "float32": 1e-5}
KERNEL_F16_TOL = 2e-3
LSE_TOL = 1e-5
ULP_BITS = {"bfloat16": 7, "float16": 10}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    tp.set_device("cpu")
    yield
    tdevice._current_place = prev


def _name(dt):
    return str(dt).replace("torch.", "")


def _np(t):
    return np.asarray(t.astype("float32").numpy(), np.float64)


def _close(a, b, tol, what):
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


def _mlp(P, seed=0):
    """Linear(8, 16) - ReLU - Linear(16, 4), the same weights in both."""
    m = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(), P.nn.Linear(16, 4))
    rng = np.random.default_rng(seed)
    m.set_state_dict({k: (0.3 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in m.state_dict().items()})
    return m


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_adamw_master_weights_match_jax(dtype):
    """decorate + AdamW(multi_precision) with the global-norm clip and
    L2Decay, 5 steps of the same gradients: parameters within one ulp of
    `dtype`, masters within 1e-6, each Parameter the same object."""
    out = {}
    for P in PKGS:
        m = _mlp(P)
        before = [id(p) for p in m.parameters()]
        opt = P.optimizer.AdamW(1e-2, parameters=m.parameters(),
                                weight_decay=P.regularizer.L2Decay(0.01),
                                grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
        m2, opt2 = P.amp.decorate(m, opt, level="O2", dtype=dtype)
        assert m2 is m and opt2 is opt and opt._multi_precision
        assert [id(p) for p in m.parameters()] == before
        assert {_name(p.dtype) for p in m.parameters()} == {dtype}
        rng = np.random.default_rng(1)
        for _ in range(5):
            for p in m.parameters():
                p.grad = P.to_tensor(rng.standard_normal(p.shape).astype(
                    np.float32)).astype(dtype)
            opt.step()
            opt.clear_grad()
        sd = opt.state_dict()
        out[P] = ([_np(p) for p in m.parameters()],
                  [_np(sd[f"{p.name}.master"]) if P is tp else
                   np.asarray(sd[f"{p.name}.master"].numpy(), np.float64)
                   for p in m.parameters()])
    for a, b in zip(out[tp][1], out[jp][1]):
        _close(a, b, 1e-6, "masters")
    for a, b in zip(out[tp][0], out[jp][0]):
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30)))
                      - ULP_BITS[dtype])
        assert (np.abs(a - b) <= ulp).all(), dtype


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o2_training_matches_jax(dtype):
    """Three O2 steps of the MLP under auto_cast (f16 with GradScaler,
    driven by minimize): losses and parameters within the 16-bit
    tolerance of JAX's, the parameters of `dtype`."""
    x0 = np.random.default_rng(2).standard_normal((6, 8)).astype(np.float32)
    y0 = np.array([0, 1, 2, 3, 1, 0])
    out = {}
    for P in PKGS:
        m = _mlp(P)
        opt = P.optimizer.AdamW(1e-2, parameters=m.parameters())
        m, opt = P.amp.decorate(m, opt, level="O2", dtype=dtype)
        scaler = P.amp.GradScaler(init_loss_scaling=2.0 ** 10) \
            if dtype == "float16" else None
        x, y = P.to_tensor(x0), P.to_tensor(y0)
        losses = []
        for _ in range(3):
            with P.amp.auto_cast(level="O2", dtype=dtype):
                loss = P.nn.CrossEntropyLoss()(m(x), y)
            if scaler is None:
                loss.backward()
                opt.step()
            else:
                scaler.minimize(opt, scaler.scale(loss))
            opt.clear_grad()
            losses.append(float(loss))
        out[P] = (losses, [_np(p) for p in m.parameters()],
                  {_name(p.dtype) for p in m.parameters()})
    assert out[tp][2] == out[jp][2] == {dtype}
    _close(np.array(out[tp][0]), np.array(out[jp][0]), TOL16[dtype], "loss")
    for a, b in zip(out[tp][1], out[jp][1]):
        _close(a, b, TOL16[dtype], "params")


# ------------------------------------------------------------ GradScaler
@pytest.mark.parametrize("flags,incr,decr,init", [
    ([0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1], 3, 2, 8.0),
    ([1, 1, 1, 1, 1, 0, 0, 1], 2, 1, 4.0),          # down to the 1.0 floor
    ([0] * 7, 2, 1, 2.0 ** 15),
])
def test_grad_scaler_schedule_matches_jax(flags, incr, decr, init):
    """The scale and the good/bad counters after each update, for a
    fixed sequence of found-inf flags, are the JAX scaler's."""
    traj = {}
    for P in PKGS:
        s = P.amp.GradScaler(init_loss_scaling=init, incr_every_n_steps=incr,
                             decr_every_n_nan_or_inf=decr)
        t = []
        for f in flags:
            s._found_inf = bool(f)
            s.update()
            t.append((s._scale, s._good_steps, s._bad_steps))
        traj[P] = (t, s.state_dict())
    assert traj[tp] == traj[jp]


@pytest.mark.parametrize("case", ["skips_on_inf", "scales", "decorate_o2",
                                  "unscale_once"])
def test_jax_amp_cases(case):
    """tests/test_optimizer_amp.py's TestAMP cases (:155-180) through
    both packages, plus unscale_ then step dividing once."""
    res = {}
    for P in PKGS:
        if case == "skips_on_inf":
            p = P.Parameter(np.ones(2, np.float32))
            opt = P.optimizer.SGD(learning_rate=1.0, parameters=[p])
            scaler = P.amp.GradScaler(init_loss_scaling=4.0)
            p.grad = P.to_tensor(np.array([np.inf, 1.0], np.float32))
            scaler.step(opt)
            res[P] = (p.numpy().tolist(), scaler._scale)
        elif case in ("scales", "unscale_once"):
            p = P.Parameter(np.ones(2, np.float32))
            opt = P.optimizer.SGD(learning_rate=0.5, parameters=[p])
            scaler = P.amp.GradScaler(init_loss_scaling=8.0)
            loss = (P.to_tensor(np.array([2.0, 2.0], np.float32)) * p).sum()
            scaler.scale(loss).backward()
            g = p.grad.numpy().tolist()
            if case == "unscale_once":
                scaler.unscale_(opt)
            scaler.step(opt)
            res[P] = (g, p.numpy().tolist(), scaler._scale)
        else:
            model = _mlp(P)
            opt = P.optimizer.AdamW(learning_rate=0.01,
                                    parameters=model.parameters())
            model, opt = P.amp.decorate(model, opt, dtype="bfloat16")
            out = model(P.to_tensor(np.ones((2, 8), np.float32))
                        .astype("bfloat16"))
            out.sum().backward()
            opt.step()
            w = model.parameters()[0]
            res[P] = (_name(w.dtype), _name(opt._state[id(w)]["master"]
                                            .dtype), _name(out.dtype))
    assert res[tp] == res[jp], case


def test_grad_scaler_state_dict_round_trip():
    for P in PKGS:
        s = P.amp.GradScaler(init_loss_scaling=16.0, incr_every_n_steps=2)
        s._found_inf = False
        s.update()
        t = P.amp.GradScaler()
        t.load_state_dict(s.state_dict())
        assert (t._scale, t._good_steps, t._bad_steps) == (16.0, 1, 0)
        assert P.amp.is_bfloat16_supported() and P.amp.is_float16_supported()


# ---------------------------------------------------------- Layer methods
def test_layer_dtype_methods_match_jax():
    """to / astype / float / half / bfloat16 cast the floating parameters
    and buffers (BatchNorm's statistics), keep each Parameter, and leave
    the same dtypes as JAX's."""
    out = {}
    for P in PKGS:
        m = P.nn.Sequential(P.nn.Linear(4, 3), P.nn.BatchNorm1D(3))
        ids = [id(p) for p in m.parameters()]
        seen = []
        for fn in (lambda: m.half(), lambda: m.bfloat16(),
                   lambda: m.astype("float16"), lambda: m.float(),
                   lambda: m.to(dtype="bfloat16")):
            assert fn() is m
            seen.append(sorted({_name(t.dtype) for t in
                                m.parameters() + m.buffers()}))
        assert [id(p) for p in m.parameters()] == ids
        assert all(not p.stop_gradient for p in m.parameters())
        out[P] = seen
    assert out[tp] == out[jp]


def test_layer_apply_and_children_match_jax():
    out = {}
    for P in PKGS:
        inner = P.nn.Sequential(P.nn.Linear(2, 2), P.nn.ReLU())
        m = P.nn.Sequential(inner, P.nn.Linear(2, 1))
        order = []
        m.apply(lambda layer: order.append(type(layer).__name__))
        out[P] = (order, [type(c).__name__ for c in m.children()],
                  [n for n, _ in m.named_children()])
    assert out[tp] == out[jp]


def test_set_state_dict_takes_jax_bf16_numpy():
    """A JAX model's state_dict as numpy arrays (bf16 ones included, as
    ml_dtypes arrays) loads into the port's model through set_dict and
    load_dict, values and dtypes kept."""
    jm = _mlp(jp).bfloat16()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert str(next(iter(state.values())).dtype) == "bfloat16"
    for method in ("set_state_dict", "set_dict", "load_dict"):
        tm = _mlp(tp, seed=9).bfloat16()
        missing, unexpected = getattr(tm, method)(state)
        assert missing == [] and unexpected == []
        for (k, a), b in zip(tm.state_dict().items(), state.values()):
            assert a.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                a.astype("float32").numpy(), b.astype(np.float32))


# ------------------------------------------------------------------ F10
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16", None])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_norm_dtypes_match_jax(mode, wdt, xdt):
    """BatchNorm (its running statistics f32), GroupNorm and InstanceNorm
    over the dtype matrix: JAX's output dtype and shape, values within
    the tolerance of the output's dtype."""
    x0 = np.random.default_rng(3).standard_normal((2, 4, 3, 3)) \
        .astype(np.float32)
    for name in ("batch_norm", "group_norm", "instance_norm"):
        res = {}
        for P in PKGS:
            F = P.nn.functional
            x = P.to_tensor(x0).astype(xdt)
            w = None if wdt is None else \
                P.to_tensor(np.full(4, 1.5, np.float32)).astype(wdt)
            b = None if wdt is None else \
                P.to_tensor(np.full(4, 0.5, np.float32)).astype(wdt)
            if name == "batch_norm":
                rm = P.to_tensor(np.full(4, 0.1, np.float32))
                rv = P.to_tensor(np.full(4, 2.0, np.float32))
                o = F.batch_norm(x, rm, rv, w, b, training=mode == "train")
            elif name == "group_norm":
                o = F.group_norm(x, 2, weight=w, bias=b)
            else:
                o = F.instance_norm(x, weight=w, bias=b)
            res[P] = (_name(o.dtype), o.shape, _np(o))
        what = f"{name} {mode} w={wdt} x={xdt}"
        assert res[tp][:2] == res[jp][:2], (what, res[tp][:2], res[jp][:2])
        # JAX normalizes in the input's dtype when it is bf16
        tol = TOL16["bfloat16" if "bfloat16" in (xdt, res[jp][0])
                    else "float32"]
        _close(res[tp][2], res[jp][2], tol, what)


def test_batch_norm_under_o1_stays_f32():
    """Under O1 batch_norm is black-listed: a bf16 input computes and
    returns f32 in both packages (the O1 ResNet path is unchanged)."""
    for P in PKGS:
        bn = P.nn.BatchNorm2D(4)
        x = P.to_tensor(np.ones((2, 4, 3, 3), np.float32)).astype("bfloat16")
        with P.amp.auto_cast(dtype="bfloat16"):
            assert _name(bn(x).dtype) == "float32"


# ------------------------------------------- the kernels' f16 plain versions
def _f16_pair(a):
    aj = jnp.asarray(a, jnp.float16)
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).half()


def test_flash_f16_plain_matches_pallas_interpret():
    """Rows 1-5: the causal GQA forward (+ LSE) and backward in f16, the
    port's plain versions against the padded Pallas kernels in interpret
    mode at B=1 S=128 H=2 KV=1 hd=64."""
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _f16_pair(rng.standard_normal(s)) for s in
        ((1, 128, 2, 64), (1, 128, 1, 64), (1, 128, 1, 64),
         (1, 128, 2, 64)))
    out_j, lse_j = jfa.flash_attention_padded(qj, kj, vj, causal=True,
                                              return_lse=True,
                                              interpret=True)
    out_t, lse_t = tfa.flash_attention_fwd(qt, kt, vt, causal=True,
                                           return_lse=True)
    assert out_t.dtype == torch.float16 and out_t.shape == qt.shape
    assert out_j.dtype == jnp.float16
    _close(out_t.double().numpy(), np.array(out_j, np.float64),
           KERNEL_F16_TOL, "out")
    _close(lse_t.numpy(), np.array(lse_j), LSE_TOL, "lse")
    grads_j = jfa.flash_attention_padded_bwd(
        qj, kj, vj, jnp.asarray(out_t.float().numpy(), jnp.float16),
        jnp.asarray(lse_t.numpy()), gj, causal=True, interpret=True)
    grads_t = tfa.flash_attention_bwd(qt, kt, vt, out_t, lse_t, gt,
                                      causal=True)
    for n, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert a.dtype == torch.float16 and tuple(a.shape) == b.shape
        _close(a.double().numpy(), np.array(b, np.float64),
               KERNEL_F16_TOL, n)


def test_row6_f16_plain_matches_pallas_interpret():
    """Row 6: rms_norm_pallas in f16 with an f16 weight (the O2 form)
    against rms_norm_fused's plain version, per row, at 300 rows."""
    rng = np.random.default_rng(6)
    xj, xt = _f16_pair(2.0 * rng.standard_normal((300, 128)) + 0.3)
    wj, wt = _f16_pair(1.0 + 0.1 * rng.standard_normal(128))
    with pltpu.force_tpu_interpret_mode():
        out_j = jrn.rms_norm_pallas(xj, wj, 1e-6)
    out_t = trn.rms_norm_fused(xt, wt, 1e-6)
    assert out_t.dtype == torch.float16 and out_j.dtype == jnp.float16
    oj = np.array(out_j, np.float64)
    err = (np.abs(out_t.double().numpy() - oj).max(-1)
           / np.abs(oj).max(-1)).max()
    assert err <= KERNEL_F16_TOL, err


def test_layer_norm_f16_plain_matches_pallas_interpret():
    """Rows 9-10: the LayerNorm forward and backward in f16 (f32 weight
    and bias, dw and db f32) against _ln_fwd_pallas / _ln_bwd_pallas in
    interpret mode at 300 rows of 128."""
    rng = np.random.default_rng(7)
    xj, xt = _f16_pair(2.0 * rng.standard_normal((300, 128)) + 0.5)
    dyj, dyt = _f16_pair(rng.standard_normal((300, 128)))
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    out_j, mu_j, r_j = jln._ln_fwd_pallas(xj, jnp.asarray(w), jnp.asarray(b),
                                          1e-12, True, interpret=True)
    out_t, mu_t, r_t = tln.layer_norm_fwd(xt, torch.from_numpy(w),
                                          torch.from_numpy(b), 1e-12)
    assert out_t.dtype == torch.float16 and out_j.dtype == jnp.float16
    _close(out_t.double().numpy(), np.array(out_j, np.float64),
           KERNEL_F16_TOL, "out")
    _close(r_t.numpy().ravel(), np.array(r_j).ravel(), 1e-5, "rstd")
    dx_j, dw_j, db_j = jln._ln_bwd_pallas(xj, jnp.asarray(w), mu_j, r_j, dyj,
                                          True, interpret=True)
    dx_t, dw_t, db_t = tln.layer_norm_bwd(xt, torch.from_numpy(w), mu_t, r_t,
                                          dyt, 1e-12)
    assert dx_t.dtype == torch.float16 and dx_j.dtype == jnp.float16
    assert dw_t.dtype == torch.float32
    _close(dx_t.double().numpy(), np.array(dx_j, np.float64),
           KERNEL_F16_TOL, "dx")
    for n, a, c in (("dw", dw_t, dw_j), ("db", db_t, db_j)):
        _close(a.double().numpy(), np.array(c, np.float64).reshape(-1),
               1e-4, n)
