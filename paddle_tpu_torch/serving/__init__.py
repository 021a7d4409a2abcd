"""paddle_tpu_torch.serving — thread-backed request serving over the
paged-KV continuous batcher: `engine` (ServingEngine, with the
quarantine, retries, the watchdog and prefill/decode roles), `request`
(lifecycle and channels), `scheduler` (admission queue), `metrics`
(counters, gauges, histograms, Prometheus export), `cache` (the prefix
cache's trie), `trace` (per-request timelines and the step flight
recorder), `slo` (the SLO tracker), `profiling` (the sampled step
profiler), `speculative` (spec config and stats), `faults`
(deterministic fault injection), `kvtransfer` (portable per-request KV
snapshots), `router` (N replicas: health, occupancy and prefix-affinity
routing, failover, disaggregated migration), `supervisor` (self-healing
replica lifecycle) and `frontend` (stdlib asyncio HTTP).

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

    router = serving.Router(params, cfg, replicas=2, auto_restart=True,
                            watchdog_s=5.0, max_batch=4, ...)
    fe = serving.HttpFrontend(router, host="127.0.0.1", port=0).start()
"""
from .cache import PrefixCacheIndex  # noqa: F401
from .engine import EngineStopped, HungStepError, ServingEngine  # noqa: F401
from .faults import FaultInjector, InjectedFault  # noqa: F401
from .frontend import HttpFrontend  # noqa: F401
from .kvtransfer import KVSnapshot  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry)
from .profiling import StepProfiler  # noqa: F401
from .request import (GenerationRequest, RequestCancelled,  # noqa: F401
                      RequestError, RequestFailed, RequestState,
                      RequestTimedOut, TERMINAL_STATES)
from .router import NoReplicaAvailable, Router, default_policy  # noqa: F401
from .scheduler import AdmissionQueue, QueueFullError  # noqa: F401
from .slo import DEFAULT_OBJECTIVES, SloTracker  # noqa: F401
from .speculative import SpecConfig, SpecStats  # noqa: F401
from .supervisor import ReplicaSupervisor  # noqa: F401
from .trace import FlightRecorder, TraceSink  # noqa: F401

__all__ = [
    "ServingEngine", "EngineStopped", "HungStepError",
    "GenerationRequest", "RequestState", "TERMINAL_STATES",
    "RequestError", "RequestCancelled", "RequestFailed", "RequestTimedOut",
    "AdmissionQueue", "QueueFullError",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TraceSink", "FlightRecorder",
    "SloTracker", "DEFAULT_OBJECTIVES", "StepProfiler",
    "SpecConfig", "SpecStats",
    "KVSnapshot",
    "FaultInjector", "InjectedFault",
    "PrefixCacheIndex",
    "Router", "NoReplicaAvailable", "default_policy", "HttpFrontend",
    "ReplicaSupervisor",
]
