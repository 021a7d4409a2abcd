"""paddle_tpu_torch.kernels — kernels of the port and their plain
PyTorch versions (`flash_attention`: forward with its LSE, backward and
the differentiable entry; `rms_norm`: the training norm's forward and
backward), and the plain elementwise pieces the JAX package left to XLA
(`rope`, `rms_norm_ref`)."""
