"""The port's MoE model and its training against the JAX package, on the CPU.

Routing: `top_k_routing` fed the same f32 logits as the JAX function must
give the same index maps exactly (argmax takes the first maximum in both,
the capacity slots are f32 counts); probs and the aux losses agree to
1e-6. The MoE block, the forward and the loss run a tiny f32 MoE
(`MoeConfig.tiny`, 2 layers, 4 experts top-2, a shared expert) made by the
JAX `init_params` and carried across with `params_from_numpy`: at D=64,
where the JAX package takes its jnp gathers, and at D=128 with
`FLAGS_pallas_interpret`, where it runs its Pallas dispatch kernels in
interpret mode. f32 on both sides, differing in summation order only:
the loss agrees to 1e-5 relative and every gradient leaf to 1e-4 relative
to its largest element. Three 8-bit train steps are held as
tests/test_torch_train.py holds the dense model's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core import flags  # noqa: E402
from paddle_tpu.nlp import moe as jmoe  # noqa: E402
from paddle_tpu.nlp import train as jtrain  # noqa: E402

from paddle_tpu_torch.nlp import moe as tmoe  # noqa: E402
from paddle_tpu_torch.nlp import train as ttrain  # noqa: E402

B, S = 2, 16
LR = 1e-3
LR_SUM_3 = 1.5e-3      # warm-up over 2 steps, then cosine: 0, 5e-4, ~1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**over):
    j = jmoe.MoeConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                            **over)
    t = tmoe.MoeConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                            **over)
    return j, t


def _tree(jcfg, seed=0):
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def _tokens(seed=0, b=B):
    return np.random.default_rng(seed).integers(0, 256, (b, S)).astype(
        np.int32)


def _flat(tree):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    return [("", tree)]


def _leaf_close(a, b, rtol, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(np.abs(b).max(), 1e-12)
    assert np.abs(a - b).max() <= rtol * scale, (what, np.abs(a - b).max(),
                                                 scale)


@pytest.fixture(params=[64, 128], ids=["D64-jnp", "D128-pallas"])
def width(request):
    """The JAX package's two routes: jnp gathers at D=64, its Pallas
    dispatch kernels (interpret mode) at D=128."""
    flags.set_flags({"FLAGS_pallas_interpret": request.param == 128})
    try:
        yield request.param
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})


# --------------------------------------------------------------- routing
def _logits(seed, shape, ties=False):
    g = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if ties:             # exact ties: argmax must take the first maximum
        g[..., 3] = g[..., 1]
        g[::3, 2] = g[::3, 0]
    return g


def _assert_routing_equal(t, j):
    names = ("eidx", "slot", "probs", "valid", "inv")
    for name, a, b in zip(names, t[:5], j[:5]):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if name == "probs":
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(t[5][name].numpy(), np.asarray(j[5][name]),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("T,E,k,cap,ties", [
    (64, 8, 2, None, False),       # capacity factor 1.25
    (64, 8, 2, 6, False),          # heavy capacity drops
    (48, 4, 3, None, True),        # exact ties, k=3
    (40, 16, 1, 3, True),          # top-1 with drops and ties
])
def test_top_k_routing_matches_jax(T, E, k, cap, ties):
    """eidx, slot, valid and inv equal JAX's; probs and aux to 1e-6."""
    C = cap or jmoe.gshard_capacity(T, k, E, 1.25)
    assert tmoe.gshard_capacity(T, k, E, 1.25) == jmoe.gshard_capacity(
        T, k, E, 1.25)
    g = _logits(T + E + k, (T, E), ties)
    j = jmoe.top_k_routing(jnp.asarray(g), k, C)
    t = tmoe.top_k_routing(_t(g), k, C)
    _assert_routing_equal(t, j)
    if cap is not None:
        assert not t[3].all()                 # the case drops choices
    for a in t[:2] + (t[4],):
        assert a.dtype == torch.int32


def test_top_k_routing_batched_matches_jax_vmap():
    """Leading dims are independent groups, as jax.vmap maps them."""
    g = _logits(5, (3, 32, 8))
    j = jax.vmap(lambda lg: jmoe.top_k_routing(lg, 2, 7))(jnp.asarray(g))
    t = tmoe.top_k_routing(_t(g), 2, 7)
    _assert_routing_equal(t, j)


def test_top_k_gating_matches_jax():
    g = _logits(9, (24, 4), ties=True)
    jd, jc, _ = jmoe.top_k_gating(jnp.asarray(g), 2, 10)
    td, tc, _ = tmoe.top_k_gating(_t(g), 2, 10)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


# ------------------------------------------------------------ the model
def test_moe_block_matches_jax(width):
    """moe_block's output, aux and gradients in x and in every weight of
    the block (router, experts, shared expert) == the JAX block's
    (jax.grad of the same scalar)."""
    jcfg, tcfg = _cfgs(hidden_size=width)
    jp, tree = _tree(jcfg)
    rng = np.random.RandomState(width)
    x = rng.randn(B, S, width).astype(np.float32)
    ct = rng.randn(B, S, width).astype(np.float32)
    keys = [n for n in jp["layers"]
            if n == "gate" or n.startswith(("expert_", "shared_"))]
    assert len(keys) == 7
    jlp = {n: jp["layers"][n][0] for n in keys}

    def jf(a, lp):
        y, aux = jmoe.moe_block(a, lp, jcfg)
        return (jnp.sum(y * ct) + 0.3 * aux["load_balance_loss"]
                + 0.7 * aux["router_z_loss"]), (y, aux)

    (jl, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jlp)
    tp = tmoe.params_from_numpy(tree, tcfg, device="cpu")
    tlp = {n: tp["layers"][n][0].clone().requires_grad_(True)
           for n in keys}
    tx = _t(x).requires_grad_(True)
    y, aux = tmoe.moe_block(tx, tlp, tcfg)
    loss = (torch.sum(y * _t(ct)) + 0.3 * aux["load_balance_loss"]
            + 0.7 * aux["router_z_loss"])
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    for name in aux:
        np.testing.assert_allclose(float(aux[name].detach()),
                                   float(jaux[name]), rtol=1e-5)
    _leaf_close(tx.grad.numpy(), jg[0], 1e-4, "x")
    for name, v in tlp.items():
        _leaf_close(v.grad.numpy(), jg[1][name], 1e-4, name)


def test_forward_matches_jax(width):
    """forward's logits and aux losses == the JAX forward's."""
    jcfg, tcfg = _cfgs(hidden_size=width)
    jp, tree = _tree(jcfg, seed=1)
    tok = _tokens(1)
    jlg, jaux = jmoe.forward(jp, jnp.asarray(tok), jcfg)
    tp = tmoe.params_from_numpy(tree, tcfg, device="cpu")
    with torch.no_grad():
        lg, aux = tmoe.forward(tp, _t(tok), tcfg)
    assert lg.dtype == torch.float32
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5,
                               rtol=1e-5)
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(width, remat):
    """loss_fn (CE through the fused head + router losses) and every
    gradient leaf == jax.value_and_grad(loss_fn)."""
    jcfg, tcfg = _cfgs(hidden_size=width, remat=remat)
    jp, tree = _tree(jcfg, seed=2)
    tok = _tokens(2)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: jmoe.loss_fn(p, t, jcfg)))(jp, jnp.asarray(tok))
    tp = tmoe.params_from_numpy(tree, tcfg, device="cpu")
    leaves = [x.requires_grad_(True) for _, x in _flat(tp)]
    tl = tmoe.loss_fn(tp, _t(tok), tcfg)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = _flat(jg)
    assert [p for p, _ in _flat(tp)] == [p for p, _ in jflat]
    for (path, _), g, (_, j) in zip(_flat(tp), tg, jflat):
        _leaf_close(g.numpy(), j, 1e-4, path)


# -------------------------------------------------------------- training
def _params_close(t, j, atol, path):
    """Params within `atol`, save Adam's ill-conditioned elements (a
    gradient within rounding noise of zero decides m/sqrt(v)): at most
    0.1 % of them, each within 2 * LR_SUM_3."""
    d = np.abs(np.asarray(t, np.float32) - np.asarray(j, np.float32))
    assert np.mean(d > atol) <= 1e-3, (path, np.mean(d > atol))
    assert d.max() <= 2 * LR_SUM_3, (path, d.max())


def test_train_steps_match_jax_8bit():
    """3 steps of make_train_step(model=moe) with the fused 8-bit AdamW
    (JAX: its Pallas kernel in interpret mode; the port: its plain
    version): losses, grad norms and params agree within the float8-flip
    tolerance of tests/test_torch_train.py, and the loss falls."""
    jcfg, tcfg = _cfgs()
    jp, tree = _tree(jcfg, seed=3)
    tok = _tokens(3)
    kw = dict(learning_rate=LR, state_quant="8bit", warmup_steps=2,
              total_steps=10)
    jtx, ttx = jtrain.make_optimizer(**kw), ttrain.make_optimizer(**kw)
    jstate = jtrain.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    jstep = jtrain.make_train_step(jcfg, jtx, donate=False, model=jmoe)
    tp = tmoe.params_from_numpy(tree, tcfg, device="cpu")
    tstate = ttrain.TrainState(torch.zeros((), dtype=torch.int32), tp,
                               ttx.init(tp))
    tstep = ttrain.make_train_step(tcfg, ttx, device="cpu", model=tmoe)
    jm, tm = [], []
    flags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        for _ in range(3):
            jstate, m = jstep(jstate, jnp.asarray(tok))
            jm.append({k: float(v) for k, v in m.items()})
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})
    for _ in range(3):
        tstate, m = tstep(tstate, _t(tok))
        tm.append({k: float(v) for k, v in m.items()})
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    assert int(tstate.opt_state.count) == int(jstate.opt_state.count) == 3
    for (path, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
        _params_close(t.numpy(), j, 1e-4, path)
    assert tm[-1]["loss"] < tm[0]["loss"]


def test_init_state_moe_tree():
    """init_state(model=moe) makes the JAX tree's keys and shapes in
    param_dtype; 16 leaves with the shared expert."""
    jcfg, tcfg = _cfgs()
    _, tree = _tree(jcfg)
    tx = ttrain.make_optimizer(1e-3, state_quant="8bit")
    st = ttrain.init_state(torch.Generator().manual_seed(0), tcfg, tx,
                           device="cpu", model=tmoe)
    got = {p: tuple(x.shape) for p, x in _flat(st.params)}
    assert got == {p: np.shape(x) for p, x in _flat(tree)}
    assert len(got) == 16
    assert all(x.dtype == torch.float32 for _, x in _flat(st.params))
    assert torch.equal(st.params["norm"], torch.ones(64))


# ----------------------------------------------------------------- counts
@pytest.mark.parametrize("name", ["tiny", "flagship", "qwen2_moe_a14b",
                                  "deepseek_moe_16b"])
def test_counts_match_jax(name):
    """num_params, active_params and flops_per_token == JAX's; the
    flagship config is bench.py's run_moe config."""
    if name == "flagship":
        jcfg = jmoe.MoeConfig(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            moe_intermediate_size=1024, num_experts=16,
            num_experts_per_tok=2, num_shared_experts=1,
            num_hidden_layers=12, num_attention_heads=16,
            num_key_value_heads=8, max_position_embeddings=2048,
            param_dtype=jnp.bfloat16)
        tcfg = tmoe.MoeConfig.flagship_moe()
        assert tcfg.param_dtype == torch.bfloat16
        assert tmoe.num_params(tcfg) == 1_565_968_384
        assert tmoe.active_params(tcfg) == 509_003_776
    else:
        jcfg = getattr(jmoe.MoeConfig, name)()
        tcfg = getattr(tmoe.MoeConfig, name)()
    assert tmoe.num_params(tcfg) == jmoe.num_params(jcfg)
    assert tmoe.active_params(tcfg) == jmoe.active_params(jcfg)
    for seq in (128, 2048):
        assert tmoe.flops_per_token(tcfg, seq) == jmoe.flops_per_token(
            jcfg, seq)
    assert tcfg.capacity(2048) == jcfg.capacity(2048)


# --------------------------------------------------------------- refusals
def test_mesh_and_pipeline_refused():
    _, tcfg = _cfgs()
    tp = tmoe.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tok = _t(_tokens())
    for call in (lambda: tmoe.forward(tp, tok, tcfg, mesh=object()),
                 lambda: tmoe.loss_fn(tp, tok, tcfg, mesh=object()),
                 lambda: tmoe.loss_fn(tp, tok, tcfg, pp_microbatches=2),
                 lambda: tmoe.param_specs(tcfg),
                 lambda: tmoe.forward_pp(tp, tok, tcfg, object(), 2),
                 lambda: tmoe.loss_and_grad_pp(tp, tok, tcfg, object(), 2)):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            call()
    tx = ttrain.make_optimizer(1e-3)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ttrain.make_train_step(tcfg, tx, mesh=object(), device="cpu",
                               model=tmoe)
    with pytest.raises(ValueError, match="one parameter tree"):
        tmoe.init_params(tcfg, device="cpu", training=False)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tmoe.forward(tp, tok, dataclasses.replace(tcfg, attn_impl="ring"))
