"""LLM serving behind the inference Config/Predictor API — port of
paddle_tpu/inference/llm.py, the single-device branch of each part.

`save_llm`/`load_llm` (:47-69) write and read `{prefix}.pdllm`: a pickle
of {"config", "params"}, the JAX package's format, with the config's
dtypes named by string ("bfloat16", "float32"). A file of f32, f16 or
int8 leaves loads in both packages. numpy has no bfloat16: the JAX
package pickles a bf16 leaf as an `ml_dtypes` array, which the port reads
through `.view(np.uint16)`; the port writes a bf16 leaf as its uint16 bit
patterns and lists its path under the payload's "bf16_bits" key, which
the JAX package does not read (ROADMAP.md Queue 3). NEVER load a .pdllm
from an untrusted source: unpickling runs code.

`LLMPredictor` keeps the paddle_infer handle API. The dense run goes
through `generation.make_generate` (the flash prefill, row 1, then the
decode step captured once as a CUDA graph and replayed), one per input
shape, kept across `run()` calls as `jax.jit` keeps its executables. The
paged run goes through `nlp.paged.paged_generate` (row 1's flash prefill
and row 18's ragged paged attention), with one block allocator that
persists across runs and grows for a larger batch (:163-193).
`enable_weight_only` quantizes the projections at load with
`generation.quantize_for_serving`. Sampling draws from one
`torch.Generator` seeded by `seed`, whose state moves on with every run,
so each `run()` draws afresh and the sequence repeats from the seed
(`jax.random.split`'s keys cannot be reproduced in torch; greedy
decoding agrees exactly). `set_llm_parallel(mp * dp > 1)` raises: the
mesh belongs to the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["save_llm", "load_llm", "LLMPredictor"]

LLM_SUFFIX = ".pdllm"
_BF16_KEY = "bf16_bits"


def _cfg_to_dict(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    for k in ("dtype", "param_dtype"):
        d[k] = str(d[k]).replace("torch.", "")
    return d


def _cfg_from_dict(d: Dict[str, Any]):
    from ..nlp import llama
    d = dict(d)
    for k in ("dtype", "param_dtype"):
        d[k] = getattr(torch, d[k])
    return llama.LlamaConfig(**d)


def _to_host(tree, path: str, bf16: List[str]):
    """A tree of tensors (or arrays) → numpy, bf16 leaves as uint16 bits
    with their paths appended to `bf16`."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out[k] = _to_host(v, p, bf16)
            continue
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                bf16.append(p)
                out[k] = t.view(torch.int16).numpy().view(np.uint16)
            else:
                out[k] = t.numpy()
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            bf16.append(p)
            a = a.view(np.uint16)
        out[k] = a
    return out


def _from_host(tree, path: str, bf16: set):
    """numpy → CPU torch tensors; a listed path, or a JAX-written
    `ml_dtypes` bf16 leaf, is read as bf16 bit patterns."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out[k] = _from_host(v, p, bf16)
            continue
        a = np.ascontiguousarray(v)
        if not a.flags.writeable:
            a = a.copy()
        if p in bf16 or a.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a)
    return out


def save_llm(path_prefix: str, params: Dict[str, Any], cfg) -> None:
    """Write `{prefix}.pdllm`: the config and the parameter tree (numpy,
    bf16 as uint16 bits)."""
    bf16: List[str] = []
    payload = {"config": _cfg_to_dict(cfg),
               "params": _to_host(params, "", bf16), _BF16_KEY: bf16}
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + LLM_SUFFIX, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_llm(path_prefix: str) -> Tuple[Dict[str, Any], Any]:
    """→ (the parameter tree as CPU torch tensors of the stored dtypes,
    the LlamaConfig)."""
    with open(path_prefix + LLM_SUFFIX, "rb") as f:
        payload = pickle.load(f)
    params = _from_host(payload["params"], "",
                        set(payload.get(_BF16_KEY, ())))
    return params, _cfg_from_dict(payload["config"])


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class LLMPredictor:
    """Generation predictor with the paddle_infer handle API.

    Input handle "input_ids" [B, P] int32; output handle "generated_ids"
    [B, max_new_tokens] int32. The decode knobs come from the Config."""

    def __init__(self, config):
        if config._prefix is None:
            raise ValueError("Config has no model path")
        mp, dp = int(config._llm_mp), int(config._llm_dp)
        if mp * dp > 1:
            raise NotImplementedError(
                f"set_llm_parallel(mp={mp}, dp={dp}): serving over more "
                f"than one GPU comes with the multi-GPU slice (ROADMAP.md "
                f"Queue 1 item 8)")
        from ..nlp import generation
        self._dev = resolve_device(config._device)
        params, cfg = load_llm(config._prefix)
        params = _tree_to(params, self._dev)
        wo = config._llm_weight_only
        if wo:
            params = generation.quantize_for_serving(
                params, bits=4 if wo == "int4" else 8)
        self._params, self._cfg, self._config = params, cfg, config
        self._gen = dict(config._llm_gen or {})
        self._generator = torch.Generator(device=self._dev).manual_seed(
            int(self._gen.get("seed", 0)))
        self._compiled: Dict[Tuple[int, int], Any] = {}
        self._paged_alloc = None
        self._paged_stats = None
        self._feed: Dict[str, np.ndarray] = {}
        self._fetch: Dict[str, np.ndarray] = {}

    # -- handle API (paddle_infer::Predictor parity) -----------------------
    def get_input_names(self) -> List[str]:
        return ["input_ids"]

    def get_output_names(self) -> List[str]:
        return ["generated_ids"]

    def get_input_handle(self, name: str):
        from . import Tensor
        return Tensor(name, self, True)

    def get_output_handle(self, name: str):
        from . import Tensor
        return Tensor(name, self, False)

    # -- the runs ----------------------------------------------------------
    def _knobs(self) -> Dict[str, Any]:
        g = self._gen
        return dict(
            max_new_tokens=int(g.get("max_new_tokens", 32)),
            temperature=float(g.get("temperature", 1.0)),
            top_k=int(g.get("top_k", 0)), top_p=float(g.get("top_p", 1.0)),
            greedy=g.get("decode_strategy", "greedy_search")
            == "greedy_search")

    def _run_dense(self, ids: torch.Tensor) -> torch.Tensor:
        from ..nlp import generation
        B, P = ids.shape
        gen = self._compiled.get((B, P))
        if gen is None:
            gen = self._compiled[(B, P)] = generation.make_generate(
                self._params, self._cfg, B, P,
                eos_token_id=self._gen.get("eos_token_id"),
                pad_token_id=int(self._gen.get("pad_token_id", 0)),
                key=self._generator, device=self._dev, **self._knobs())
        return gen(ids)

    def _run_paged(self, ids: torch.Tensor) -> torch.Tensor:
        from ..nlp import paged as paged_mod
        kw = self._knobs()
        paged = self._config._llm_paged
        pad = int(self._gen.get("pad_token_id", 0))
        ids_np = ids.numpy()
        lengths = np.maximum((ids_np != pad).cumsum(1).max(1), 1)
        # ONE allocator persists across run() calls: later admissions
        # reuse the blocks earlier batches freed (stats()["reused_blocks"]);
        # a batch larger than everything seen so far grows the pool
        B, bs = ids.shape[0], paged["block_size"]
        need = B * -(-(int(lengths.max()) + kw["max_new_tokens"]) // bs)
        alloc = self._paged_alloc
        if alloc is None or alloc.num_blocks < need:
            cap = paged["num_blocks"] or need
            if cap < need:
                raise ValueError(
                    f"enable_paged_kv(num_blocks={cap}) too small for this "
                    f"batch (needs {need} blocks)")
            alloc = self._paged_alloc = paged_mod.BlockAllocator(cap)
        out, alloc, owned = paged_mod.paged_generate(
            self._params, ids_np, lengths, self._cfg, block_size=bs,
            allocator=alloc, pad_token_id=pad, generator=self._generator,
            device=self._dev, **kw)
        self._paged_stats = alloc.stats()
        for blocks in owned:   # request complete → blocks reusable
            alloc.free(blocks)
        return out

    def run(self, inputs: Optional[List[np.ndarray]] = None
            ) -> List[np.ndarray]:
        if inputs is not None:
            self._feed["input_ids"] = np.asarray(inputs[0])
        ids = torch.from_numpy(
            np.asarray(self._feed["input_ids"], dtype=np.int32))
        if self._config._llm_paged:
            out = self._run_paged(ids)
        else:
            out = self._run_dense(ids)
        out = out.cpu().numpy()
        self._fetch = {"generated_ids": out}
        return [out]
