"""paddle.inference — Config and create_predictor.

Port of paddle_tpu/inference/__init__.py: `Config` with every knob, the
`Tensor` input/output handle (:115-133) and `create_predictor`
(:169-178). A config that serves an LLM (`enable_llm_generation`, or a
`.pdllm` checkpoint at its path) gets `inference.llm.LLMPredictor`, on
the card unless `disable_gpu()` asks for the CPU. The static `Predictor`
(:135-167) runs a program exported by `static.save_inference_model`,
which belongs to the static-graph slice (ROADMAP.md Queue 1 item 7): it
raises `NotImplementedError` until then.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["Config", "Tensor", "Predictor", "create_predictor",
           "ContinuousBatcher", "PagedKVCache", "ServingEngine",
           "GenerationRequest"]


def __getattr__(name: str):
    # the serving surface without private module paths, resolved lazily so
    # importing paddle_tpu_torch.inference does not pull the model stack
    if name in ("ServingEngine", "GenerationRequest"):
        from .. import serving
        return getattr(serving, name)
    if name in ("ContinuousBatcher", "PagedKVCache"):
        from ..nlp import paged
        return getattr(paged, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Config:
    """paddle.inference.Config: a model path and the serving knobs."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        # params_path is kept for API parity: a .pdllm holds its params
        if model_path is not None and model_path.endswith(".pdmodel"):
            model_path = model_path[:-len(".pdmodel")]
        self._prefix = model_path
        self._device = "cuda"
        self._llm_gen = None
        self._llm_mp = 1
        self._llm_dp = 1
        self._llm_weight_only = None
        self._llm_paged = None

    def enable_llm_generation(self, max_new_tokens: int = 32,
                              decode_strategy: str = "greedy_search",
                              temperature: float = 1.0, top_k: int = 0,
                              top_p: float = 1.0, eos_token_id=None,
                              pad_token_id: int = 0, seed: int = 0):
        """Serve a .pdllm generation checkpoint (prefill and the decode
        loop), with PaddleNLP's llm/ predict decode knobs."""
        if decode_strategy not in ("greedy_search", "sampling"):
            raise ValueError(
                f"decode_strategy {decode_strategy!r} not supported: use "
                f"'greedy_search' or 'sampling' (beam_search is not "
                f"implemented in inference.llm)")
        self._llm_gen = dict(
            max_new_tokens=max_new_tokens, decode_strategy=decode_strategy,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed)

    def enable_weight_only(self, weight_dtype: str = "int8"):
        """Weight-only-quantized decode: the checkpoint's projection
        weights become int8 (or int4-range) codes and per-channel scales
        at load (`generation.quantize_for_serving`)."""
        if weight_dtype not in ("int8", "int4"):
            raise ValueError(f"weight_dtype must be int8 or int4, got "
                             f"{weight_dtype!r}")
        self._llm_weight_only = weight_dtype

    def enable_paged_kv(self, block_size: int = 64,
                        num_blocks: Optional[int] = None):
        """A block-table KV cache: requests of mixed lengths share one
        block pool (`nlp.paged.paged_generate`); each request's length is
        its non-pad prefix (pad_token_id from enable_llm_generation)."""
        self._llm_paged = dict(block_size=int(block_size),
                               num_blocks=num_blocks)

    def set_llm_parallel(self, mp: int = 1, dp: int = 1):
        """Tensor- and data-parallel serving degrees; more than one GPU
        raises in LLMPredictor until the multi-GPU slice."""
        self._llm_mp, self._llm_dp = int(mp), int(dp)

    def set_prog_file(self, path: str):
        self._prefix = path[:-len(".pdmodel")] \
            if path.endswith(".pdmodel") else path

    def enable_use_gpu(self, memory_pool_mb=0, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self, *a, **k):
        pass  # PyTorch's caching allocator reuses buffers

    def switch_ir_optim(self, *a, **k):
        pass  # no pass pipeline: the predictor runs eager PyTorch

    def set_cpu_math_library_num_threads(self, n):
        pass


class Tensor:
    """Input/output handle (paddle_infer::Tensor parity)."""

    def __init__(self, name: str, predictor, is_input: bool):
        self.name = name
        self._p = predictor
        self._is_input = is_input

    def copy_from_cpu(self, data: np.ndarray):
        self._p._feed[self.name] = np.asarray(data)

    def copy_to_cpu(self) -> np.ndarray:
        return self._p._fetch[self.name]

    def shape(self):
        v = self._p._feed.get(self.name) if self._is_input else \
            self._p._fetch.get(self.name)
        return list(v.shape) if v is not None else None


class Predictor:
    """The static-program predictor: not ported yet."""

    def __init__(self, config: Config):
        raise NotImplementedError(
            "the static Predictor runs a program saved by "
            "static.save_inference_model, which comes with the static-graph "
            "slice (ROADMAP.md Queue 1 item 7); serve an LLM checkpoint "
            "with Config.enable_llm_generation or a .pdllm path")


def create_predictor(config: Config):
    """A Config that serves an LLM (enable_llm_generation, or a .pdllm
    checkpoint at its path) gets the LLM predictor; any other raises."""
    from .llm import LLM_SUFFIX, LLMPredictor
    if config._llm_gen is not None or (
            config._prefix and os.path.exists(config._prefix + LLM_SUFFIX)):
        return LLMPredictor(config)
    return Predictor(config)
