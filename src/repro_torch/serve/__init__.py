"""serve of the PyTorch port."""
from repro_torch.core.state import DecodeState, PartialPrefill, bucket_chunks
from repro_torch.serve.engine import (GenerationResult, Request,
                                      RequestOutput, ServeEngine, generate,
                                      make_serve_fns)
from repro_torch.serve.prefix_cache import (PrefixCache, params_fingerprint,
                                            snapshot_nbytes)
from repro_torch.serve.sampling import (SamplingParams, SlotSampling,
                                        advance_key, request_key,
                                        sample_first, sample_step,
                                        sample_token)
from repro_torch.serve.scheduler import PrefillJob, PrefillScheduler
from repro_torch.serve.telemetry import (Counter, Gauge, Histogram,
                                         MemorySampler, MetricsRegistry,
                                         RetraceWatchdog, Telemetry, Tracer,
                                         format_event, validate_trace)

__all__ = ["Counter", "DecodeState", "Gauge", "GenerationResult",
           "Histogram", "MemorySampler", "MetricsRegistry", "PartialPrefill",
           "PrefillJob", "PrefillScheduler", "PrefixCache", "Request",
           "RequestOutput", "RetraceWatchdog", "SamplingParams",
           "ServeEngine", "SlotSampling", "Telemetry", "Tracer",
           "advance_key", "bucket_chunks",
           "format_event", "generate", "make_serve_fns",
           "params_fingerprint", "request_key", "sample_first",
           "sample_step", "sample_token", "snapshot_nbytes",
           "validate_trace"]
