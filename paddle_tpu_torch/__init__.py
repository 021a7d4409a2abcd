"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside `paddle_tpu` (the JAX reference) that mirrors its paths
and names. It imports torch and numpy, never jax and nothing of
`paddle_tpu`. Every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (sm_90a) under `csrc/`, built with nvcc on first
use (`_build.py`); each kernel's wrapper runs its plain PyTorch version
on a CPU tensor and the kernel on a CUDA tensor, never one for the other.

Ported so far (the serving, single-device training, MoE training and
eager-API slices):

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
                          (csrc/moe_dispatch.cu) and the gather fused
                          into the expert products (csrc/gather_mlp.cu)
    optimizer.quant_state 8-bit blockwise AdamW, fused update
                          (csrc/adamw_q.cu)
    optimizer.transform   the optax transformations the train step uses
    serving               ServingEngine over the batcher
    core, ops, autograd,  the Paddle-shaped eager API: Tensor and its
    amp, nn, optimizer,   operators and in-place ops, Parameter,
    incubate,             to_tensor, the eager dispatch with AMP casts,
    regularizer           torch autograd as the tape (backward, grad,
                          hooks, PyLayer, the functional transforms),
                          Layer and its layers, the fourteen optimizers
                          with master weights, the clips and decays,
                          amp.decorate (O2) and GradScaler, the incubate
                          fused layers
    kernels.layer_norm    the fused LayerNorm's forward and backward
                          (csrc/layer_norm.cu)
    inference             Config, create_predictor, the LLM predictor
                          (inference.llm: save_llm, load_llm, LLMPredictor)
    vision                ResNet models, transforms, FakeData
    io                    Dataset, samplers, DataLoader with the
                          shared-memory worker ring (io/native/shm_ring.cc)
    nn (conv, rnn)        convolutions, pools, BatchNorm, GroupNorm,
                          the RNN cells and layers, BeamSearchDecoder
    optimizer.lr          the learning-rate schedulers; SGD and Momentum

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

    import paddle_tpu_torch as paddle        # the eager API
    model = paddle.nn.Sequential(paddle.nn.Linear(784, 256),
                                 paddle.nn.ReLU(), paddle.nn.Linear(256, 10))
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    loss = paddle.nn.CrossEntropyLoss()(model(x), y)
    loss.backward(); opt.step(); opt.clear_grad()

Entry points run on the card (`device="cuda"`) and raise without one
unless the caller passes `device="cpu"`; the eager API places tensors on
`gpu:0` unless `set_device("cpu")` was called. Importing the package
builds nothing: each kernel is built on its first launch.
"""
from .core.dtype import (bool_, uint8, int8, int16, int32,  # noqa: F401
                         int64, float16, bfloat16, float32, float64,
                         set_default_dtype, get_default_dtype)
from .core.device import (set_device, get_device, Place,  # noqa: F401
                          CPUPlace, CUDAPlace)
from .core.flags import set_flags, get_flags  # noqa: F401
from .core.random import seed  # noqa: F401
from .core.tensor import Tensor, Parameter, to_tensor  # noqa: F401
from . import autograd  # noqa: F401
from .autograd import (no_grad, enable_grad, set_grad_enabled,  # noqa: F401
                       is_grad_enabled, grad, PyLayer)
from .ops import (zeros, ones, full, arange, add, subtract,  # noqa: F401
                  multiply, divide, matmul, tanh, exp, reshape, transpose,
                  flatten, split, squeeze, unsqueeze, concat, stack, cast,
                  sum, mean, equal, not_equal, where)
from . import ops  # noqa: F401
# the in-place ops (add_, exp_, reshape_, where_, ...), as the JAX
# package exports them at the top level
globals().update({_n: getattr(ops, _n) for _n in ops.INPLACE_OPS})
from . import nn  # noqa: F401
from .nn.layer import ParamAttr  # noqa: F401
from . import optimizer  # noqa: F401
from . import amp  # noqa: F401
from . import incubate  # noqa: F401
from . import io  # noqa: F401
from . import vision  # noqa: F401
from . import inference  # noqa: F401

# paddle.regularizer (the JAX package's namespace of the same name)
from .optimizer.optimizers import L1Decay as _L1, L2Decay as _L2
import types as _t
regularizer = _t.SimpleNamespace(L1Decay=_L1, L2Decay=_L2)
del _t, _L1, _L2
