"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside `paddle_tpu` (the JAX reference) that mirrors its paths
and names. It imports torch and numpy, never jax and nothing of
`paddle_tpu`. Every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (sm_90a) under `csrc/`, built with nvcc on first
use (`_build.py`); each kernel's wrapper runs its plain PyTorch version
on a CPU tensor and the kernel on a CUDA tensor, never one for the other.

Ported so far (the serving, single-device training and MoE training
slices):

    nlp.llama             LlamaConfig, init_params, params_from_numpy,
                          forward, loss_fn, fused_head_ce, flops_per_token
    nlp.moe               MoeConfig, top_k_routing, moe_block, init_params,
                          params_from_numpy, forward, loss_fn, the counts
    nlp.train             make_optimizer, init_state, make_train_step
                          (model=llama or moe)
    nlp.paged             PagedKVCache, forward_paged, paged_generate,
                          ContinuousBatcher
    nlp.ragged_attention  ragged paged attention (csrc/ragged_paged_attention.cu)
    kernels.flash_attention  causal GQA flash forward with its LSE
                          (csrc/flash_fwd.cu) and backward (csrc/flash_bwd.cu)
    kernels.rms_norm      the training norm's forward and backward
                          (csrc/rms_norm.cu)
    kernels.moe_dispatch  the MoE dispatch and combine gathers
                          (csrc/moe_dispatch.cu)
    optimizer.quant_state 8-bit blockwise AdamW, fused update
                          (csrc/adamw_q.cu)
    optimizer.transform   the optax transformations the train step uses
    serving               ServingEngine over the batcher

    from paddle_tpu_torch.nlp import llama
    from paddle_tpu_torch.serving import ServingEngine
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(params, cfg, max_batch=8, max_total_len=1024)
    out = eng.generate(prompt_ids)

    from paddle_tpu_torch.nlp import train
    cfg = llama.LlamaConfig.flagship_2b()
    tx = train.make_optimizer(1e-4, state_quant="8bit")
    state = train.init_state(torch.Generator("cuda").manual_seed(0), cfg, tx)
    step = train.make_train_step(cfg, tx)
    state, metrics = step(state, tokens)       # tokens [B, S] on the card

Entry points run on the card (`device="cuda"`) and raise without one
unless the caller passes `device="cpu"`.
"""
