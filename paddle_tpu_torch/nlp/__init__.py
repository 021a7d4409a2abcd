"""paddle_tpu_torch.nlp — the Llama model: config, parameters, forward
and loss (`llama`), the MoE model with its GShard routing (`moe`), the
single-device training step of both (`train`), the serving model pieces
(`generation`), ragged paged attention (`ragged_attention`) and the paged
KV cache with its continuous batcher (`paged`)."""
from . import ernie, llama, moe, train  # noqa: F401
