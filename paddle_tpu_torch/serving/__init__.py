"""paddle_tpu_torch.serving — thread-backed request serving over the
paged-KV continuous batcher: `engine` (ServingEngine), `request`
(lifecycle and channels), `scheduler` (admission queue), `metrics`
(counters, gauges, histograms, Prometheus export), `cache` (the prefix
cache's trie), `trace` (per-request timelines and the step flight
recorder), `slo` (the SLO tracker), `profiling` (the sampled step
profiler) and `speculative` (spec config and stats).

    from paddle_tpu_torch import serving
    eng = serving.ServingEngine(params, cfg, max_batch=4, block_size=16,
                                max_total_len=512, max_new_tokens=64,
                                start=False)
    eng.warmup()                     # capture every step shape
    eng.start()
    out = eng.generate(prompt_ids)
    for tok in eng.stream(prompt_ids):
        ...
    eng.shutdown()
"""
from .cache import PrefixCacheIndex  # noqa: F401
from .engine import EngineStopped, ServingEngine  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry)
from .profiling import StepProfiler  # noqa: F401
from .request import GenerationRequest, RequestState  # noqa: F401
from .scheduler import AdmissionQueue, QueueFullError  # noqa: F401
from .slo import DEFAULT_OBJECTIVES, SloTracker  # noqa: F401
from .speculative import SpecConfig, SpecStats  # noqa: F401
from .trace import FlightRecorder, TraceSink  # noqa: F401
