"""paddle_tpu_torch.kernels — kernels of the port and their plain
PyTorch versions (`flash_attention`), and the plain elementwise pieces
the JAX package left to XLA (`rope`, `rms_norm`)."""
