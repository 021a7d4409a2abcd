"""paddle_tpu_torch.serving — thread-backed request serving over the
paged-KV continuous batcher: `engine` (ServingEngine), `request`
(lifecycle and channels), `scheduler` (admission queue) and `metrics`.

    from paddle_tpu_torch import serving
    eng = serving.ServingEngine(params, cfg, max_batch=4, block_size=16,
                                max_total_len=512, max_new_tokens=64)
    out = eng.generate(prompt_ids)
    for tok in eng.stream(prompt_ids):
        ...
    eng.shutdown()
"""
from .engine import EngineStopped, ServingEngine  # noqa: F401
from .metrics import MetricsRegistry  # noqa: F401
from .request import GenerationRequest, RequestState  # noqa: F401
from .scheduler import AdmissionQueue, QueueFullError  # noqa: F401
