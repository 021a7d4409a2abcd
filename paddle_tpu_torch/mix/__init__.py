"""paddle_tpu_torch.mix — diffusion model families: port of
paddle_tpu/mix (DiT, BASELINE config 3)."""
from . import dit  # noqa: F401
