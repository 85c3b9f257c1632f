"""serve of the PyTorch port."""
from repro_torch.core.state import DecodeState, PartialPrefill, bucket_chunks
from repro_torch.serve.chaos import (FAULT_KINDS, ChaosInjector, ChaosSpec,
                                     ReplicaKilled, parse_chaos)
from repro_torch.serve.engine import (GenerationResult, RecoveredRequest,
                                      Request, RequestOutput, ServeEngine,
                                      generate, make_serve_fns)
from repro_torch.serve.plan import PARAM_RULES, SERVING_RULES, ServePlan
from repro_torch.serve.prefix_cache import (PrefixCache, params_fingerprint,
                                            snapshot_nbytes)
from repro_torch.serve.replicas import Overloaded, ReplicaSet, replica_plans
from repro_torch.serve.sampling import (SamplingParams, SlotSampling,
                                        advance_key, request_key,
                                        sample_first, sample_step,
                                        sample_token)
from repro_torch.serve.scheduler import PrefillJob, PrefillScheduler
from repro_torch.serve.telemetry import (Counter, Gauge, Histogram,
                                         MemorySampler, MetricsRegistry,
                                         RetraceWatchdog, Telemetry, Tracer,
                                         format_event, validate_trace)

__all__ = ["FAULT_KINDS", "PARAM_RULES", "SERVING_RULES", "ChaosInjector",
           "ChaosSpec", "Counter", "DecodeState", "Gauge",
           "GenerationResult", "Histogram", "MemorySampler",
           "MetricsRegistry", "Overloaded", "PartialPrefill", "PrefillJob",
           "PrefillScheduler", "PrefixCache", "RecoveredRequest",
           "ReplicaKilled", "ReplicaSet", "Request", "RequestOutput",
           "RetraceWatchdog", "SamplingParams", "ServeEngine", "ServePlan",
           "SlotSampling", "Telemetry", "Tracer", "advance_key",
           "bucket_chunks", "format_event", "generate", "make_serve_fns",
           "params_fingerprint", "parse_chaos", "replica_plans",
           "request_key", "sample_first", "sample_step", "sample_token",
           "snapshot_nbytes", "validate_trace"]
