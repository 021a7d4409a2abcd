"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside `paddle_tpu` (the JAX reference) that mirrors its paths
and names. It imports torch and numpy, never jax and nothing of
`paddle_tpu`. Every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (sm_90a) under `csrc/`, built with nvcc on first
use (`_build.py`); each kernel's wrapper runs its plain PyTorch version
on a CPU tensor and the kernel on a CUDA tensor, never one for the other.

Ported so far (the serving slice):

    nlp.llama             LlamaConfig, init_params, params_from_numpy
    nlp.paged             PagedKVCache, forward_paged, paged_generate,
                          ContinuousBatcher
    nlp.ragged_attention  ragged paged attention (csrc/ragged_paged_attention.cu)
    kernels.flash_attention  causal GQA flash forward (csrc/flash_fwd.cu)
    serving               ServingEngine over the batcher

    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.serving import ServingEngine
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(params, cfg, max_batch=8, max_total_len=1024)
    out = eng.generate(prompt_ids)

Entry points run on the card (`device="cuda"`) and raise without one
unless the caller passes `device="cpu"`.
"""
