"""paddle_tpu_torch.nlp — the Llama model: config, parameters, forward
and loss (`llama`), the single-device training step (`train`), the
serving model pieces (`generation`), ragged paged attention
(`ragged_attention`) and the paged KV cache with its continuous batcher
(`paged`)."""
from . import llama, train  # noqa: F401
