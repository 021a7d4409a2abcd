"""The PyTorch port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper of the port (`flash_attention_fwd`,
`ragged_paged_attention`) runs its plain PyTorch version, so these tests
pin the arithmetic the CUDA kernels are held to on the card
(`chip_smoke.py`): the same numpy inputs go through the JAX Pallas
kernels (interpret mode off-TPU) and the port's plain versions.

Tolerances: everything runs in float32, and the two sides differ only
in summation order (Pallas interpret mode reduces block by block with an
online softmax, the plain versions in one pass), so outputs of O(1)
agree to 2e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402
from paddle_tpu.nlp.ragged_attention import \
    ragged_paged_attention as j_rpa  # noqa: E402

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels.rms_norm import rms_norm_ref  # noqa: E402
from paddle_tpu_torch.kernels.rope import apply_rope_half, \
    rope_freqs  # noqa: E402
from paddle_tpu_torch.nlp import ragged_attention as tra  # noqa: E402

TOL = 2e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- flash
class TestFlash:
    B, H, KV, hd = 2, 4, 2, 16

    def _qkv(self, seed, Sq, Sk):
        rng = np.random.RandomState(seed)
        q = rng.randn(self.B, Sq, self.H, self.hd).astype(np.float32)
        k = rng.randn(self.B, Sk, self.KV, self.hd).astype(np.float32)
        v = rng.randn(self.B, Sk, self.KV, self.hd).astype(np.float32)
        return q, k, v

    @pytest.mark.parametrize("S", [128, 200])
    def test_plain_matches_pallas_interpret(self, S):
        """Causal GQA: the port's plain flash == JAX's padded Pallas
        forward (interpret mode) at an aligned and a ragged length."""
        q, k, v = self._qkv(S, S, S)
        ref = np.asarray(jfa.flash_attention_padded(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            interpret=True))
        out = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("Sq,Sk", [(128, 128), (200, 200), (5, 37)])
    def test_plain_matches_mha_ref(self, Sq, Sk):
        """Bottom-right causal alignment (Sq < Sk included) == JAX
        mha_ref."""
        q, k, v = self._qkv(Sq + Sk, Sq, Sk)
        ref = np.asarray(jfa.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True))
        out = tfa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal=True)
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
        full = tfa.mha_ref(_t(q), _t(k), _t(v), causal=False)
        jfull = np.asarray(jfa.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=False))
        np.testing.assert_allclose(full.numpy(), jfull, atol=TOL, rtol=TOL)

    def test_cpu_tensor_runs_plain_version(self):
        """A CPU tensor never reaches the kernel: no launch is counted."""
        q, k, v = self._qkv(1, 64, 64)
        n0 = tfa.flash_attention_fwd.launches
        out = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
        assert tfa.flash_attention_fwd.launches == n0
        ref = tfa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal=True)
        assert torch.equal(out, ref)


# --------------------------------------------------------------- ragged
N, BS, KVH, HD, HQ, M = 32, 4, 2, 8, 4, 5


def _pools(rng):
    kp = rng.randn(N, BS, KVH, HD).astype(np.float32)
    vp = rng.randn(N, BS, KVH, HD).astype(np.float32)
    return kp, vp


def _chains(rng, lengths):
    """Distinct live block chains per row; padded table entries are
    block 0, as the batcher pads them."""
    table = np.zeros((len(lengths), M), np.int32)
    free = list(rng.permutation(np.arange(1, N)))
    for r, L in enumerate(lengths):
        for j in range(-(-L // BS) if L else 0):
            table[r, j] = free.pop()
    return table


def _decode_batch(rng, lengths):
    """P=1 rows at position len-1; a length of 0 is an invalid row."""
    pos = np.array([[max(L - 1, 0)] for L in lengths], np.int32)
    val = np.array([[L > 0] for L in lengths], np.bool_)
    q = rng.randn(len(lengths), 1, HQ, HD).astype(np.float32)
    return q, pos, val


def _suffix_batch(rng, lengths, P):
    """Continuing-prefill rows: row r's P queries end at position
    lengths[r] - 1; rows shorter than P left-pad as invalid."""
    R = len(lengths)
    pos = np.zeros((R, P), np.int32)
    val = np.zeros((R, P), np.bool_)
    for r, L in enumerate(lengths):
        for p in range(P):
            j = L - P + p
            pos[r, p] = min(max(j, 0), M * BS - 1)
            val[r, p] = j >= 0
    q = rng.randn(R, P, HQ, HD).astype(np.float32)
    return q, pos, val


def _fused_batch(rng, dec_lengths, pre_len, Pb):
    """The fused step's mixed batch: decode rows padded to the prefill
    bucket width Pb (only column 0 valid, positions clamped to
    M * bs - 1) plus one cold prefill row of `pre_len` tokens."""
    R = len(dec_lengths) + 1
    maxpos = M * BS - 1
    pos = np.zeros((R, Pb), np.int32)
    val = np.zeros((R, Pb), np.bool_)
    for r, L in enumerate(dec_lengths):
        pos[r] = np.minimum(L + np.arange(Pb), maxpos)
        val[r, 0] = True
    pos[-1] = np.minimum(np.arange(Pb), maxpos)
    val[-1, :pre_len] = True
    q = rng.randn(R, Pb, HQ, HD).astype(np.float32)
    lengths = [L + 1 for L in dec_lengths] + [pre_len]
    return q, pos, val, lengths


def _batch(kind, rng):
    if kind == "decode":
        lengths = [1, BS, BS + 1, 2 * BS, 0, M * BS, 7]
        q, pos, val = _decode_batch(rng, lengths)
    elif kind == "suffix":
        lengths = [9, 13, 3, 20]
        q, pos, val = _suffix_batch(rng, lengths, P=6)
    else:
        q, pos, val, lengths = _fused_batch(rng, [3, 8, 15], pre_len=5,
                                            Pb=8)
        val[1, 0] = False                  # an inactive decode slot
    return q, pos, val, _chains(rng, lengths)


@pytest.mark.parametrize("kind", ["decode", "suffix", "fused"])
def test_ragged_plain_matches_pallas_interpret(kind):
    """The port's plain ragged attention == JAX's Pallas ragged kernel
    (interpret mode) on every row, invalid rows (zeros) included."""
    rng = np.random.RandomState(len(kind))
    kp, vp = _pools(rng)
    q, pos, val, table = _batch(kind, rng)
    ref = np.asarray(j_rpa(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(val)))
    out = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(pos), _t(val)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    assert not out[~val].any()


@pytest.mark.parametrize("kind", ["decode", "suffix", "fused"])
def test_ragged_plain_matches_xla_gather(kind):
    """== JAX's `_paged_gqa_attention` (the xla full-table gather) on
    valid rows; that reference leaves never-read values in invalid
    rows, so only valid rows compare."""
    rng = np.random.RandomState(10 + len(kind))
    kp, vp = _pools(rng)
    q, pos, val, table = _batch(kind, rng)
    ref = np.asarray(jpaged._paged_gqa_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), impl="xla"))
    out = tra.ragged_paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(pos), _t(val)).numpy()
    np.testing.assert_allclose(out[val], ref[val], atol=TOL, rtol=TOL)


def test_ragged_int64_indices_and_cpu_route():
    """int64 table/positions (numpy's default integer) are accepted on
    the CPU, and a CPU tensor never counts a kernel launch."""
    rng = np.random.RandomState(3)
    kp, vp = _pools(rng)
    q, pos, val, table = _batch("decode", rng)
    n0 = tra.ragged_paged_attention.launches
    a = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp),
                                   _t(table.astype(np.int64)),
                                   _t(pos.astype(np.int64)), _t(val))
    b = tra.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                   _t(pos), _t(val))
    assert tra.ragged_paged_attention.launches == n0
    assert torch.equal(a, b)


def test_resolve_attention_impl():
    assert tra.resolve_attention_impl("auto", "cpu") == "ref"
    assert tra.resolve_attention_impl("ref", "cpu") == "ref"
    assert tra.resolve_attention_impl("auto", "cuda") == "kernel"
    with pytest.raises(ValueError):
        tra.resolve_attention_impl("kernel", "cpu")
    with pytest.raises(ValueError):
        tra.resolve_attention_impl("pallas", "cpu")


# ------------------------------------------------- plain elementwise ops
def test_rope_and_rms_norm_match_jax():
    from paddle_tpu.kernels import rms_norm as jrms
    from paddle_tpu.kernels import rope as jrope
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 4, 16).astype(np.float32)
    k = rng.randn(2, 5, 2, 16).astype(np.float32)
    pos = rng.randint(0, 40, (2, 5)).astype(np.int32)
    jc, js = jrope.rope_freqs(16, 40, 500000.0, jnp.float32)
    tc, ts = rope_freqs(16, 40, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    jq, jk = jrope.apply_rope_half(jnp.asarray(q), jnp.asarray(k), jc, js,
                                   jnp.asarray(pos))
    tq, tk = apply_rope_half(_t(q), _t(k), tc, ts, _t(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
    x = rng.randn(3, 7, 64).astype(np.float32)
    w = rng.rand(64).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm_ref(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jrms.rms_norm_ref(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=TOL, rtol=TOL)
    xb = _t(x).to(torch.bfloat16)
    assert rms_norm_ref(xb, _t(w)).dtype == torch.bfloat16


# ------------------------------------------------------------ isolation
def test_port_imports_no_jax():
    """Every module of paddle_tpu_torch, and chip_smoke.py (imported as a
    module, not run), imports with jax, optax and paddle_tpu made
    unimportable."""
    code = (
        "import sys, importlib, importlib.util, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import paddle_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',\n"
        "                                              'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "for n in ('paddle_tpu_torch.serving.engine',\n"
        "          'paddle_tpu_torch.nlp.train',\n"
        "          'paddle_tpu_torch.optimizer.quant_state',\n"
        "          'paddle_tpu_torch.nlp.moe',\n"
        "          'paddle_tpu_torch.kernels.moe_dispatch',\n"
        "          'paddle_tpu_torch.core.tensor',\n"
        "          'paddle_tpu_torch.ops._registry',\n"
        "          'paddle_tpu_torch.nn.layer',\n"
        "          'paddle_tpu_torch.optimizer.optimizers',\n"
        "          'paddle_tpu_torch.incubate.nn',\n"
        "          'paddle_tpu_torch.kernels.layer_norm',\n"
        "          'paddle_tpu_torch.kernels.rope',\n"
        "          'paddle_tpu_torch.nlp.ernie',\n"
        "          'paddle_tpu_torch.tools.eager_llama',\n"
        "          'paddle_tpu_torch.tools.ernie_finetune',\n"
        "          'paddle_tpu_torch.incubate.nn.functional',\n"
        "          'paddle_tpu_torch.nn.functional.attention',\n"
        "          'paddle_tpu_torch.tools.profile_train',\n"
        "          'paddle_tpu_torch.mix.dit',\n"
        "          'paddle_tpu_torch.kernels.adaln',\n"
        "          'paddle_tpu_torch.tools.dit_train'):\n"
        "    assert n in names, n\n"
        "assert not any(m in ('jax', 'optax')\n"
        "               or m.startswith(('jax.', 'optax.', 'paddle_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 45
