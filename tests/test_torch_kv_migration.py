"""The port's portable KV snapshots and live migration on the CPU, twins
of tests/test_kv_migration.py, held to the JAX package.

Batcher level: a request exported mid-decode and imported into a fresh
batcher resumes with zero prefill chunks and finishes with the JAX
batcher's greedy tokens (fp and int8 KV, the int8 scales transferred
verbatim and the unwritten tail at the 0.0 sentinel); an import writes
the live pool in place (every pool and slot-state tensor keeps its
storage, as the card's captured graphs need); export → import → export
is byte-identical; a wrong fingerprint is refused; a bf16 pool travels
as uint16 bits under the JAX dtype name. Across the packages: a JAX
snapshot imported into the port, and a port snapshot imported into the
JAX batcher, continue to the JAX tokens. Engine and fleet level: a
speculative destination, the disaggregated Router (prefill role →
snapshot → decode role, zero decode-side prefill), warm failover from an
attached snapshot, and the supervisor's drain-export-respawn-resume.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nlp import llama as jllama  # noqa: E402
from paddle_tpu.nlp import paged as jpaged  # noqa: E402

from paddle_tpu_torch import serving  # noqa: E402
from paddle_tpu_torch.nlp import llama as tllama  # noqa: E402
from paddle_tpu_torch.nlp import paged as tpaged  # noqa: E402
from paddle_tpu_torch.serving import RequestState  # noqa: E402
from paddle_tpu_torch.serving.kvtransfer import (  # noqa: E402
    KVSnapshot, check_compatible)
from paddle_tpu_torch.serving.router import (  # noqa: E402
    Router, _AffinityIndex, _DECODE_ROLES)

_RNG = np.random.RandomState(23)
PROMPTS = [list(map(int, _RNG.randint(1, 200, n))) for n in (6, 9, 5)]
MAX_NEW = 8
BKW = dict(max_batch=2, block_size=4, max_total_len=48,
           max_new_tokens=MAX_NEW, chunk=2)


@pytest.fixture(scope="module", autouse=True)
def _engine_threads_finish():
    """An engine thread a hang left inside its device call runs on after
    its test; let it (and the reaper waiting on it) finish before the
    module ends, so none is still inside torch at interpreter exit."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("paddle-tpu-torch-") and t.is_alive():
            t.join(timeout=30)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _port(models, **kw):
    _, _, tcfg, tparams = models
    return tpaged.ContinuousBatcher(tparams, tcfg, device="cpu",
                                    **{**BKW, **kw})


def _jax(models, **kw):
    jcfg, jparams, _, _ = models
    return jpaged.ContinuousBatcher(jparams, jcfg, attention_impl="xla",
                                    **{**BKW, **kw})


@pytest.fixture(scope="module")
def jax_refs(models):
    """The JAX batcher's greedy tokens for every prompt, fp and int8."""
    out = {}
    for name, kw in (("fp", {}), ("int8", {"kv_dtype": "int8"})):
        cb = _jax(models, **kw)
        rids = [cb.submit(p) for p in PROMPTS]
        res = cb.run()
        out[name] = [res[r] for r in rids]
    return out


def _export_mid_decode(cb, rid, min_tokens=2):
    """Step until `rid` holds at least `min_tokens` generated tokens but
    is still decoding, then export + surrender its slot (the engine's
    `_surrender` sequence: export, abort, release)."""
    for _ in range(64):
        if len(cb.outputs.get(rid, [])) >= min_tokens:
            break
        cb.step()
    active = {cb.slot_req[s] for s in range(cb.B) if cb.active[s]}
    assert rid in active, "request finished before the export point"
    snap = cb.export_kv(rid)
    cb.abort(rid)
    cb.release(rid)
    return snap


def _live_tensors(cb):
    c = cb.cache
    ts = {"k": c.k, "v": c.v, "table": c.table, "lengths": c.lengths,
          "cur_tok": cb.cur_tok}
    if c.k_scale is not None:
        ts.update(k_scale=c.k_scale, v_scale=c.v_scale)
    return ts


class TestSnapshotRoundTrip:
    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_resume_matches_jax(self, models, jax_refs, kv):
        """Export mid-decode, import into a fresh batcher IN PLACE, run
        on: the JAX batcher's tokens, no prefill on the destination, the
        transferred scales verbatim and the tail at the sentinel."""
        kw = {"kv_dtype": "int8"} if kv == "int8" else {}
        src = _port(models, **kw)
        rid = src.submit(PROMPTS[0])
        snap = _export_mid_decode(src, rid)
        ref = jax_refs[kv][0]
        assert snap.prompt_len == len(PROMPTS[0])
        assert snap.tokens[snap.prompt_len:] == \
            ref[:len(snap.tokens) - snap.prompt_len]
        assert (snap.k_scale is not None) == (kv == "int8")
        dst = _port(models, **kw)
        ptrs = {n: t.data_ptr() for n, t in _live_tensors(dst).items()}
        rid2 = dst.import_kv(snap)
        assert {n: t.data_ptr() for n, t in _live_tensors(dst).items()} \
            == ptrs
        if kv == "int8":
            slot = dst.slot_req.index(rid2)
            chain = dst.slot_blocks[slot]
            ks = dst.cache.k_scale.numpy()
            np.testing.assert_array_equal(ks[:, chain[:snap.n_blocks]],
                                          snap.k_scale)
            assert np.all(ks[:, chain[snap.n_blocks:]] == 0.0)
        out = dst.run()
        assert out[rid2] == ref
        assert dst.prefill_chunk_calls == 0 and dst.imported_kv == 1
        assert dst.alloc.stats()["blocks_in_use"] == 0
        assert {n: t.data_ptr() for n, t in _live_tensors(dst).items()} \
            == ptrs

    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_export_import_export_byte_identical(self, models, kv):
        kw = {"kv_dtype": "int8"} if kv == "int8" else {}
        src = _port(models, **kw)
        rid = src.submit(PROMPTS[1])
        for _ in range(3):
            src.step()
        a = src.export_kv(rid)
        dst = _port(models, **kw)
        b = dst.export_kv(dst.import_kv(a))
        for name in ("k", "v", "k_scale", "v_scale"):
            x, y = getattr(a, name), getattr(b, name)
            if x is None:
                assert y is None
                continue
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        assert (a.tokens, a.budget, a.stop_token_id, a.tail_valid,
                a.fingerprint) == (b.tokens, b.budget, b.stop_token_id,
                                   b.tail_valid, b.fingerprint)

    def test_fingerprint_mismatch_rejected(self, models):
        src = _port(models)
        rid = src.submit(PROMPTS[0])
        snap = _export_mid_decode(src, rid)
        with pytest.raises(ValueError, match="incompatible"):
            _port(models, block_size=8).import_kv(snap)
        with pytest.raises(ValueError, match="incompatible"):
            _port(models, kv_dtype="int8").import_kv(snap)
        eng = serving.ServingEngine(models[3], models[2], device="cpu",
                                    start=False, kv_dtype="int8", **BKW)
        with pytest.raises(ValueError, match="incompatible"):
            eng.submit_import(snap)
        eng.shutdown()

    def test_bf16_pool_travels_as_uint16_bits(self, models):
        """numpy has no bfloat16: the blocks travel as their bit patterns
        under the JAX dtype name, and come back bit for bit."""
        _, jparams, _, _ = models
        cfg = tllama.LlamaConfig.tiny(dtype=torch.bfloat16)
        params = tllama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        src = tpaged.ContinuousBatcher(params, cfg, device="cpu", **BKW)
        rid = src.submit(PROMPTS[0])
        for _ in range(2):
            src.step()
        snap = src.export_kv(rid)
        assert snap.fingerprint["pool_dtype"] == "bfloat16"
        assert snap.k.dtype == np.uint16
        slot = src.slot_req.index(rid)
        blocks = src.slot_blocks[slot][:snap.n_blocks]
        want = src.cache.k[:, blocks].view(torch.int16).numpy()
        assert snap.k.view(np.int16).tobytes() == want.tobytes()
        dst = tpaged.ContinuousBatcher(params, cfg, device="cpu", **BKW)
        back = dst.export_kv(dst.import_kv(snap))
        assert back.k.tobytes() == snap.k.tobytes()
        assert back.v.tobytes() == snap.v.tobytes()

    def test_import_registers_prefix_for_siblings(self, models):
        src = _port(models, prefix_cache=True)
        rid = src.submit(PROMPTS[1])
        snap = _export_mid_decode(src, rid)
        dst = _port(models, prefix_cache=True)
        dst.import_kv(snap)
        written = len(snap.tokens) - 1
        n_full = written // dst.bs
        assert n_full >= 1
        assert len(dst._pcache.match(snap.tokens)) == n_full
        dst.run()
        sib = PROMPTS[1][:dst.bs] + [7, 8, 9]
        r3 = dst.submit(sib)
        out = dst.run()
        assert len(out[r3]) == MAX_NEW
        assert dst._pcache.hits >= 1 and dst._pcache.hit_tokens >= dst.bs

    def test_mid_decode_export_under_fused_steps(self, models, jax_refs):
        src = _port(models, fused_units=2)
        r0 = src.submit(PROMPTS[0])
        src.step()
        r1 = src.submit(PROMPTS[2])
        for _ in range(64):
            if src.outputs.get(r1):
                break
            src.step()
        assert src.fused_steps >= 1
        assert len(src.outputs.get(r0, [])) >= 2
        snap = src.export_kv(r0)
        src.abort(r0)
        src.release(r0)
        assert src.run()[r1] == jax_refs["fp"][2]
        dst = _port(models, fused_units=2)
        rid2 = dst.import_kv(snap)
        assert dst.run()[rid2] == jax_refs["fp"][0]
        assert dst.prefill_chunk_calls == 0


class TestCrossPackage:
    """Snapshots cross between the packages in both directions."""

    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_jax_snapshot_continues_in_port(self, models, jax_refs, kv):
        kw = {"kv_dtype": "int8"} if kv == "int8" else {}
        src = _jax(models, **kw)
        rid = src.submit(PROMPTS[1])
        snap = _export_mid_decode(src, rid)
        dst = _port(models, **kw)
        assert not check_compatible(snap.fingerprint, dst.kv_fingerprint())
        rid2 = dst.import_kv(snap)
        assert dst.run()[rid2] == jax_refs[kv][1]
        assert dst.prefill_chunk_calls == 0

    @pytest.mark.parametrize("kv", ["fp", "int8"])
    def test_port_snapshot_continues_in_jax(self, models, jax_refs, kv):
        kw = {"kv_dtype": "int8"} if kv == "int8" else {}
        src = _port(models, **kw)
        rid = src.submit(PROMPTS[1])
        snap = _export_mid_decode(src, rid)
        dst = _jax(models, **kw)
        assert snap.fingerprint == dst.kv_fingerprint()
        rid2 = dst.import_kv(snap)
        assert dst.run()[rid2] == jax_refs[kv][1]


class TestEngineHop:
    def test_speculative_destination_parity(self, models, jax_refs):
        _, _, tcfg, tparams = models
        src = _port(models)
        rid = src.submit(PROMPTS[0])
        snap = _export_mid_decode(src, rid)
        eng = serving.ServingEngine(
            tparams, tcfg, device="cpu", prefill_buckets=(8,),
            speculative=True, spec_k=2, start=False, **BKW)
        eng.warmup()
        eng.start()
        req = eng.submit_import(snap)
        out = req.result(timeout=120)
        eng.shutdown()
        assert out == jax_refs["fp"][0]
        assert eng.batcher.prefill_chunk_calls == 0
        assert eng.batcher.imported_kv == 1

    def test_misaligned_handle_refused(self, models):
        _, _, tcfg, tparams = models
        src = _port(models)
        rid = src.submit(PROMPTS[0])
        snap = _export_mid_decode(src, rid)
        eng = serving.ServingEngine(tparams, tcfg, device="cpu",
                                    start=False, **BKW)
        with pytest.raises(ValueError, match="misalign"):
            eng.submit_import(snap, serving.GenerationRequest(PROMPTS[0]))
        eng.shutdown()


class TestAffinity:
    def test_observe_repoints_migrated_chain(self):
        idx = _AffinityIndex(4)
        toks = list(range(100, 112))
        idx.observe(toks, 0)
        assert idx.match(toks) == {0: 12}
        idx.observe(toks, 1)
        assert idx.match(toks) == {1: 12}


RKW = dict(max_batch=2, block_size=4, max_total_len=48,
           max_new_tokens=MAX_NEW, chunk=2, prefill_buckets=(8,),
           max_queue_depth=16, device="cpu")


class TestDisaggRouter:
    def test_end_to_end_parity_and_zero_prefill(self, models, jax_refs):
        """Prefill role → snapshot → decode role: the JAX tokens, every
        request migrated once, zero prefill on the decode replica, the
        client stream append-only across the hop."""
        _, _, tcfg, tparams = models
        r = Router(tparams, tcfg, replicas=2, disaggregated=True,
                   per_replica=[{"role": "prefill"}, {"role": "decode"}],
                   start=False, **RKW)
        r.warmup()
        r.start()
        streamed = [[] for _ in PROMPTS]
        reqs = [r.submit(p, on_token=streamed[i].append)
                for i, p in enumerate(PROMPTS)]
        out = [q.result(timeout=120) for q in reqs]
        pre, dec = r.engines
        health = r.health()
        snap = r.snapshot()
        assert out == jax_refs["fp"]
        assert streamed == out
        assert health["migrations"] == len(PROMPTS)
        assert health["migration_bytes"] > 0
        assert dec.batcher.imported_kv == len(PROMPTS)
        assert dec.batcher.prefill_chunk_calls == 0
        assert pre.batcher.exported_kv == len(PROMPTS)
        assert all(e["via"] == "kv_import" and e["handoff_s"] >= 0
                   for e in snap["migration_log"])
        assert pre.health()["role"] == "prefill"
        assert dec.health()["role"] == "decode"
        assert pre.speculative is False
        eff = PROMPTS[0] + out[0]
        views = r._views(eff, exclude=(), roles=_DECODE_ROLES)
        assert views and views[0][1] == 1
        prom = r.to_prometheus()
        assert "migrations" in prom and "migration_bytes" in prom
        r.shutdown()


def _hold_first_token(r, prompt):
    got, go = threading.Event(), threading.Event()

    def on_token(_):
        got.set()
        go.wait(timeout=10.0)

    req = r.submit(prompt, on_token=on_token)
    assert got.wait(timeout=60.0)
    return req, go


class TestWarmFailover:
    def test_failover_imports_exported_kv(self, models):
        _, _, tcfg, tparams = models
        kw = {**RKW, "max_new_tokens": 24}
        ref = _jax(models, max_new_tokens=24)
        rr = ref.submit(PROMPTS[0])
        want = ref.run()[rr]
        r = Router(tparams, tcfg, replicas=2, start=False, **kw)
        r.warmup()
        r.start()
        req, go = _hold_first_token(r, PROMPTS[0])
        victim = next(i for i, e in enumerate(r.engines)
                      if e.replica_id == req.replica_id)
        survivor = r.engines[1 - victim]
        chunks0 = survivor.batcher.prefill_chunk_calls
        go.set()
        pairs = r.engines[victim].drain_export(timeout=10.0)
        assert len(pairs) == 1
        for s, inner in pairs:
            inner.kv_snapshot = s
            inner._finish(RequestState.FAILED, "respawn_failed")
        out = req.result(timeout=120)
        health = r.health()
        snap = r.snapshot()
        r.shutdown()
        assert out == want
        assert health["failovers"] == 1 and health["migrations"] == 1
        fo = snap["failover_log"][-1]
        assert fo["via"] == "kv_import" and fo["tokens_kept"] >= 1
        assert survivor.batcher.imported_kv == 1
        assert survivor.batcher.prefill_chunk_calls == chunks0


class TestSupervisorResume:
    def test_restart_slot_drains_exports_and_resumes(self, models):
        _, _, tcfg, tparams = models
        kw = {**RKW, "max_total_len": 64, "max_new_tokens": 32}
        ref = _jax(models, max_total_len=64, max_new_tokens=32)
        rr = ref.submit(PROMPTS[0])
        want = ref.run()[rr]
        r = Router(tparams, tcfg, replicas=2, auto_restart=True,
                   start=False, **kw)
        r.warmup()
        r.start()
        req, go = _hold_first_token(r, PROMPTS[0])
        victim = next(i for i, e in enumerate(r.engines)
                      if e.replica_id == req.replica_id)
        old = r.engines[victim]
        go.set()
        assert r._supervisor.restart_slot(victim)
        out = req.result(timeout=120)
        deadline = 60.0
        while r._supervisor.states()[victim] != "SERVING" and deadline:
            threading.Event().wait(0.05)
            deadline -= 0.05
        fresh = r.engines[victim]
        health = r.health()
        r.shutdown()
        assert out == want
        assert fresh is not old
        assert health["replica_restarts"] == 1
        assert fresh.batcher.imported_kv >= 1
        assert fresh.batcher.prefill_chunk_calls == 1
        # the torn-down engine's batcher gave back its pool and graphs
        assert old.batcher.compile_count == 0
        assert old.batcher.cache.k.numel() == 0


def test_snapshot_container_is_host_only():
    """KVSnapshot and check_compatible are numpy-only, like the JAX
    package's: nbytes counts codes and scales."""
    k = np.zeros((2, 3, 4, 2, 16), np.int8)
    s = np.zeros((2, 3), np.float32)
    fp = {"num_layers": 2, "num_key_value_heads": 2, "head_dim": 16,
          "block_size": 4, "kv_dtype": "int8", "pool_dtype": "int8"}
    snap = KVSnapshot(k=k, v=k, k_scale=s, v_scale=s, tokens=[1] * 10,
                      prompt_len=9, budget=3, stop_token_id=-1,
                      tail_valid=1, fingerprint=fp)
    assert snap.n_blocks == 3
    assert snap.nbytes == 2 * k.nbytes + 2 * s.nbytes
    assert check_compatible(fp, dict(fp, block_size=8)) == [
        "block_size: snapshot=4 local=8"]
