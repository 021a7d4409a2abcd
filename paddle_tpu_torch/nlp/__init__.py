"""paddle_tpu_torch.nlp — the Llama serving path: config and parameters
(`llama`), the serving model pieces (`generation`), ragged paged
attention (`ragged_attention`) and the paged KV cache with its
continuous batcher (`paged`)."""
