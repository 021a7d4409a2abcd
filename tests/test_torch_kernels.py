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
torch.set_num_threads(1)       # the test workers share the cores

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


# ------------------------------------------- the flash kernels' host rules
def _view(layout, hd, kind, dtype=torch.bfloat16):
    """A [2, 5, 3, hd] tensor of `dtype` in `layout` ('bhsd': [2, 3, 5,
    hd]): contiguous, or sliced out of a fused [.., 3 * heads, ..]
    projection (a view whose strides skip the other two thirds)."""
    B, S, H = 2, 5, 3
    if kind == "contiguous":
        shape = (B, S, H, hd) if layout == "bshd" else (B, H, S, hd)
        return torch.randn(shape).to(dtype)
    if layout == "bshd":
        return torch.randn(B, S, 3 * H, hd).to(dtype)[:, :, H:2 * H]
    return torch.randn(B, 3 * H, S, hd).to(dtype)[:, H:2 * H]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["2-byte", "4-byte"])
@pytest.mark.parametrize("kind", ["contiguous", "sliced"])
@pytest.mark.parametrize("hd", [64, 72, 128])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_tma_dims_address_every_element(layout, hd, kind, dtype):
    """The tensor map the kernels build (extents head_dim, seq, heads,
    batch; byte strides of seq, heads, batch) puts element (b, s, h, d)
    at the byte torch keeps it at, in either layout, for a strided view
    and for 2- and 4-byte elements; the strides are whole 16-byte rows
    (TMA's rule), and ceil(hd / columns) boxes cover a row (64 columns of
    16 bits, 32 of f32: one 128-byte swizzle row), the columns past hd
    outside the map's extent (zero-filled)."""
    t = _view(layout, hd, kind, dtype)
    e = t.element_size()
    dims = tfa.tma_dims(t, layout)
    B, S, H, D = tfa._bshd(t, layout).shape
    assert dims[:4] == (D, S, H, B) == (hd, 5, 3, 2)
    st_s, st_h, st_b = dims[4:]
    assert all(x % 16 == 0 and x > 0 for x in dims[4:])
    view = tfa._bshd(t, layout)            # [B, S, H, hd] view, no copy
    for b in range(B):
        for si in range(S):
            for h in range(H):
                for d in (0, 1, hd - 1):
                    el = (view[b, si, h, d:].storage_offset()
                          - t.storage_offset())
                    assert d * e + si * st_s + h * st_h + b * st_b == e * el
    box = tfa.TMA_BOX_F32 if e == 4 else tfa.TMA_BOX
    boxes = -(-hd // box[0])
    assert boxes * box[0] >= hd > (boxes - 1) * box[0]
    assert box[0] * e == 128                            # one swizzle row
    if e == 4:     # the f32 kernels' tiles are whole boxes of rows
        assert all(n % box[1] == 0 for n in tfa.FWD_TILES_F32
                   + tfa.DQ_TILES_F32 + tfa.DKDV_TILES_F32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["2-byte", "4-byte"])
@pytest.mark.parametrize("kind", ["broadcast", "odd_stride"])
def test_kernel_input_meets_tma_rules(kind, dtype):
    """A view TMA cannot read (a head broadcast with stride 0, a seq
    stride that is no whole 16-byte row: 8 bytes past one) is made
    contiguous; a view it can read is passed as it is, for 2- and 4-byte
    elements."""
    base = torch.randn(2, 5, 1, 64).to(dtype)
    if kind == "broadcast":
        t = base.expand(2, 5, 4, 64)
    else:
        pad = 8 // base.element_size()
        t = torch.randn(2, 5, 4, 64 + pad).to(dtype)[..., :64]
    assert tfa._kernel_input("k", t, t.device).is_contiguous()
    ok = torch.randn(2, 5, 12, 64).to(dtype)[:, :, 4:8]
    assert tfa._kernel_input("k", ok, ok.device) is ok


def _visible(sq, sk, causal, mask_row):
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= np.arange(sk)[None] <= np.arange(sq)[:, None] + sk - sq
    if mask_row is not None:
        vis &= np.asarray(mask_row)[None] != 0
    return vis


_WALKS = [  # (sq, sk, causal, mask_row)
    (1, 1, True, None), (128, 128, True, None), (300, 300, True, None),
    (64, 300, True, None), (130, 514, True, None), (1, 129, True, None),
    (513, 700, True, None), (200, 200, False, None),
    (200, 200, False, [0] * 200), (200, 200, False, [1] * 37 + [0] * 163),
    (500, 500, False, ([1] * 60 + [0] * 70) * 3 + [1] * 110),
    (512, 512, False, [0] * 130 + [1] * 200 + [0] * 182)]


@pytest.mark.parametrize("tiles", [tfa.FWD_TILES, tfa.DQ_TILES,
                                   tfa.DQ_TILES_F32],
                         ids=["fwd", "dq", "dq_f32"])
@pytest.mark.parametrize("sq,sk,causal,mask_row", _WALKS)
def test_key_tile_walk_covers_visible_pairs_once(sq, sk, causal, mask_row,
                                                 tiles):
    """The forward's and the dq pass's walk: a block of rows visits the
    key tiles below its causal bound whose state is not 0. Every visible
    (query, key) pair lies in exactly one walked (block, tile); the first
    tile past the bound holds no key any row of the block sees, the last
    within it one; a state-2
    tile (no per-element test) holds only present, visible keys; a row
    that sees no key walks no tile."""
    bm, bn = tiles
    vis = _visible(sq, sk, causal, mask_row)
    covered = np.zeros((sq, sk), int)
    for m0 in range(0, sq, bm):
        n = tfa.key_tiles(m0, sq, sk, causal, tiles)
        assert n <= -(-sk // bn)
        assert not vis[m0:m0 + bm, n * bn:].any()
        if n and mask_row is None:          # the bound is tight
            assert vis[m0:m0 + bm, (n - 1) * bn:n * bn].any()
        states = (tfa.key_tile_states(mask_row, n, bn)
                  if mask_row is not None else
                  [2 if (t + 1) * bn <= sk else 1 for t in range(n)])
        for t, st in enumerate(states):
            keys = slice(t * bn, (t + 1) * bn)
            if st == 0:
                assert not vis[:, keys].any()
                continue
            if st == 2:
                assert (t + 1) * bn <= sk
                assert mask_row is None or all(mask_row[keys])
            covered[m0:m0 + bm, keys] += 1
        if mask_row is not None and not any(mask_row):
            assert all(st == 0 for st in states)
    assert (covered[vis] == 1).all()


@pytest.mark.parametrize("tiles", [tfa.DKDV_TILES, tfa.DKDV_TILES_F32],
                         ids=["dkdv", "dkdv_f32"])
@pytest.mark.parametrize("sq,sk,causal,mask_row", _WALKS)
def test_query_tile_walk_covers_visible_pairs_once(sq, sk, causal, mask_row,
                                                   tiles):
    """The backward's dkdv walk: a block of keys visits, for each query
    head of its group, the query tiles from its causal bound to Sq, and
    none when all its keys are masked. Every visible pair lies in exactly
    one walked (key block, query tile); every query before the first
    walked tile sees none of the block's keys; the prep rows (padded to
    BWD_PAD) hold every walked tile and every dq block's rows."""
    bk, bq = tiles
    vis = _visible(sq, sk, causal, mask_row)
    covered = np.zeros((sq, sk), int)
    pad = tfa.bwd_scratch_numel(1, 1, sq) // 2
    assert pad % tfa.BWD_PAD == 0 and pad >= sq
    for k0 in range(0, sk, bk):
        walked = tfa.query_tiles(k0, sq, sk, causal, mask_row, tiles)
        if len(walked):
            assert not vis[:walked[0] * bq, k0:k0 + bk].any()
            assert (walked[-1] + 1) * bq <= pad
        else:
            assert not vis[:, k0:k0 + bk].any()
        for qt in walked:
            covered[qt * bq:(qt + 1) * bq, k0:k0 + bk] += 1
    assert (covered[vis] == 1).all()
    assert -(-sq // tfa.DQ_TILES[0]) * tfa.DQ_TILES[0] <= pad


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
        "          'paddle_tpu_torch.tools.dit_train',\n"
        "          'paddle_tpu_torch.nlp.generation',\n"
        "          'paddle_tpu_torch.ops.comparison',\n"
        "          'paddle_tpu_torch.tools.bench',\n"
        "          'paddle_tpu_torch.quantization.kv',\n"
        "          'paddle_tpu_torch.serving.speculative',\n"
        "          'paddle_tpu_torch.serving.cache',\n"
        "          'paddle_tpu_torch.serving.trace',\n"
        "          'paddle_tpu_torch.serving.slo',\n"
        "          'paddle_tpu_torch.serving.faults',\n"
        "          'paddle_tpu_torch.serving.kvtransfer',\n"
        "          'paddle_tpu_torch.serving.router',\n"
        "          'paddle_tpu_torch.serving.supervisor',\n"
        "          'paddle_tpu_torch.serving.frontend',\n"
        "          'paddle_tpu_torch.serving.profiling',\n"
        "          'paddle_tpu_torch.nn.layers_transformer',\n"
        "          'paddle_tpu_torch.nn.layers_act_loss',\n"
        "          'paddle_tpu_torch.nn.layers_common',\n"
        "          'paddle_tpu_torch.nn.functional.loss',\n"
        "          'paddle_tpu_torch.nn.functional.common',\n"
        "          'paddle_tpu_torch.nn.functional.activation',\n"
        "          'paddle_tpu_torch.nn.functional.norm',\n"
        "          'paddle_tpu_torch.tools.eager_transformer'):\n"
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
