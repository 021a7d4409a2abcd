"""paddle_tpu_torch.optimizer — the optimizers of the training step:
optax-style transformations kept by the port (`transform`) and the 8-bit
blockwise AdamW with its fused CUDA update (`quant_state`)."""
