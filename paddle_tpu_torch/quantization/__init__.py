"""paddle_tpu_torch.quantization — the int8 paged-KV math of quantized
serving (`kv`). Weight-only quantization of the decode GEMM weights is
`nlp.generation.quantize_for_serving`."""
from . import kv  # noqa: F401
