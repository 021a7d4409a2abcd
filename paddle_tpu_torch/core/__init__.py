"""paddle_tpu_torch.core — dtypes, places, the random generators, flags
and the eager Tensor of the Paddle-shaped API."""
