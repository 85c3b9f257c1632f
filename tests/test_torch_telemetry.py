"""The port's serving telemetry: tracer spans, instants, the bounded ring and
the Chrome trace export (valid under the JAX package's own validate_trace
too), schema drift rejected, the retrace watchdog counting only growth
after mark_steady (call signatures of the engine's entry points, kernel
libraries), the memory sampler's host watermark, tokens bit-identical with
and without tracing, the engine's metric names covering the JAX engine's
(mesh and replica names aside), retried I/O, and the serving CLI with the
prefix cache, tracing, metrics and the retrace gate."""
import json

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import Telemetry as JaxTelemetry  # noqa: E402
from repro.serve import validate_trace as jax_validate_trace  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.fault import with_retries  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import (MemorySampler, MetricsRegistry,  # noqa: E402
                               PrefixCache, RetraceWatchdog, SamplingParams,
                               ServeEngine, Telemetry, Tracer, format_event,
                               validate_trace)
from repro_torch.serve.telemetry import CallSignatures  # noqa: E402

ARCH = "gpt2s-polysketch"


@pytest.fixture(scope="module")
def smoke_model():
    return build_model(get_config(ARCH, smoke=True), device="cpu", seed=2)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n) for n in lens]


# ---------------------------------------------------------------------------
# the tracer and its export
# ---------------------------------------------------------------------------

def test_tracer_spans_instants_and_export(tmp_path):
    tr = Tracer()
    tr.begin("tick", "tick", n=1)
    tr.begin("tick", "plan")
    tr.end("tick")
    tr.instant("queue", "submit", rid=0)
    tr.begin("slot0", "prefill", rid=0)
    tr.end("slot0", chunks=2)
    tr.end("tick", retired=0)
    tr.counter("mem", "memory", rss_mb=1.0)
    path = tmp_path / "trace.json"
    trace = tr.export(str(path))
    on_disk = json.loads(path.read_text())
    for t in (trace, on_disk):
        assert validate_trace(t) == [] and jax_validate_trace(t) == []
    names = {(e["ph"], e["name"]) for e in on_disk["traceEvents"]}
    assert {("X", "tick"), ("X", "plan"), ("X", "prefill"),
            ("i", "submit"), ("C", "memory")} <= names
    tracks = {e["args"]["name"] for e in on_disk["traceEvents"]
              if e.get("name") == "thread_name"}
    assert tracks == {"tick", "queue", "slot0", "mem"}
    pf = next(e for e in on_disk["traceEvents"] if e["name"] == "prefill")
    assert pf["args"] == {"rid": 0, "chunks": 2}   # begin and end args merge
    tr.end("never-opened")                         # dropped, not raised
    tr.begin("slot0", "decode", rid=1)
    flushed = tr.export()
    dec = next(e for e in flushed["traceEvents"] if e["name"] == "decode")
    assert dec["args"]["unterminated"] is True
    line = format_event(("X", "tick", 0, 1500.0, 250.0, {"n": 3}))
    assert line == "[     1.500ms] t0 tick 0.250ms n=3"


def test_tracer_disabled_is_inert_and_the_ring_is_bounded():
    tr = Tracer(enabled=False)
    assert not tr
    tr.instant("queue", "submit")
    tr.begin("tick", "tick")
    tr.end("tick")
    assert len(tr) == 0
    seen = []
    ring = Tracer(max_events=4, on_event=seen.append)
    for i in range(10):
        ring.instant("queue", "submit", rid=i)
    assert len(ring) == 4 and len(seen) == 10
    rids = [e["args"]["rid"] for e in ring.export()["traceEvents"]
            if e["ph"] == "i"]
    assert rids == [6, 7, 8, 9]                    # the oldest dropped


THREAD = {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
          "args": {"name": "tick"}}


@pytest.mark.parametrize("events,needle", [
    ([THREAD, {"ph": "X", "pid": 1, "tid": 0, "name": "nonsense", "ts": 0.0,
               "dur": 1.0}], "schema"),
    ([{"ph": "i", "pid": 1, "tid": 9, "name": "submit", "ts": 1.0,
       "s": "t"}], "thread_name"),
    ([THREAD, {"ph": "X", "pid": 1, "tid": 0, "name": "tick", "ts": 0.0,
               "dur": 100.0},
      {"ph": "X", "pid": 1, "tid": 0, "name": "plan", "ts": 50.0,
       "dur": 100.0}], "nest"),
    ([THREAD, {"ph": "i", "pid": 1, "tid": 0, "name": "submit", "ts": -1.0,
               "s": "t"}], "bad ts"),
    ([THREAD, {"ph": "i", "pid": 1, "tid": 0, "name": "submit", "ts": 1.0}],
     "scope"),
])
def test_validate_trace_rejects_schema_drift(events, needle):
    trace = {"traceEvents": events}
    errs = validate_trace(trace)
    assert any(needle in e for e in errs)
    assert errs == jax_validate_trace(trace)
    assert validate_trace({"nope": 1}) == [
        "trace must be a dict with a traceEvents list"]


# ---------------------------------------------------------------------------
# the watchdog and the memory sampler
# ---------------------------------------------------------------------------

def test_watchdog_counts_only_steady_growth():
    reg, tr = MetricsRegistry(), Tracer()
    wd = RetraceWatchdog(reg, tr)
    f = CallSignatures(lambda x, n: x * n)
    assert wd.register("f", f) is True
    assert wd.register("libs", build.LOADED) is True
    assert wd.register("plain", lambda x: x) is False
    f(torch.zeros(2), 3)                 # warm-up signature
    wd.check()
    assert wd.retraces == 0
    wd.mark_steady()
    f(torch.ones(2), 5)                  # the same signature: an int is a value
    wd.check()
    assert wd.retraces == 0
    f(torch.zeros(3), 3)                 # a new shape mid-serve
    f(torch.zeros(3, dtype=torch.float64), 3)   # and a new dtype
    wd.check()
    assert wd.retraces == 2
    assert [e[1] for e in tr._events] == ["recompile"]
    assert wd.cache_sizes()["f"] == 3
    wd.check()
    assert wd.retraces == 2
    assert reg.get("serve_jit_cache_size").labels(entry="f").value == 3


def test_memory_sampler_keeps_the_host_watermark():
    reg, tr = MetricsRegistry(), Tracer()
    ms = MemorySampler(reg)
    ms.sample(tr)
    rss = reg.get("serve_host_rss_bytes").value
    assert rss > 0
    reg.get("serve_host_rss_bytes").set(1.0)
    ms.sample(tr)
    assert reg.get("serve_host_rss_peak_bytes").value >= rss
    assert sum(e[0] == "C" and e[1] == "memory" for e in tr._events) == 2
    if not torch.cuda.is_available():
        assert reg.get("serve_device_bytes_in_use").value == 0
        assert reg.get("serve_device_peak_bytes").value == 0


def test_with_retries_counts_then_raises(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    calls, retried = {"n": 0}, []

    def flaky(fail):
        calls["n"] += 1
        if calls["n"] <= fail:
            raise OSError("flake")
        return calls["n"]
    f = with_retries(flaky, retries=2, backoff=0.01,
                     on_retry=lambda a, e: retried.append(a))
    assert f(2) == 3 and retried == [1, 2]
    calls["n"] = 0
    with pytest.raises(OSError):
        f(3)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_tokens_bit_identical_with_and_without_tracing(smoke_model):
    sp = SamplingParams(temperature=0.9, top_k=12, seed=5)
    runs = []
    for tel in (None, Telemetry(trace=True, memory=True, memory_every=1)):
        eng = ServeEngine(smoke_model, slots=2, max_len=64, telemetry=tel,
                          logprobs=True, overlap=True, prefill_budget=16)
        for p in _prompts([7, 29, 13], seed=4):
            eng.submit(p, 8, sampling=sp)
        runs.append({o.rid: o for o in eng.run()})
    for rid, o in runs[0].items():
        assert np.array_equal(o.tokens, runs[1][rid].tokens)
        assert np.array_equal(o.logprobs, runs[1][rid].logprobs)


def test_engine_trace_is_valid_under_both_validators(smoke_model):
    tel = Telemetry(trace=True, memory=True)
    eng = ServeEngine(smoke_model, slots=2, max_len=96, telemetry=tel,
                      prefix_cache=PrefixCache(1 << 22), overlap=True,
                      prefill_budget=16)
    shared = _prompts([48], seed=3)[0]
    for sfx in _prompts([9, 5, 20, 3], seed=8):
        eng.submit(np.concatenate([shared, sfx]), 4)
    eng.submit(_prompts([12], seed=9)[0], 4)
    eng.cancel(4)                                  # a queued request
    eng.run()
    trace = tel.export_trace()
    assert validate_trace(trace) == [] and jax_validate_trace(trace) == []
    names = {(e["ph"], e["name"]) for e in trace["traceEvents"]
             if e["ph"] in ("X", "i", "C")}
    assert {("X", "tick"), ("X", "plan"), ("X", "chunk_dispatch"),
            ("X", "decode_dispatch"), ("X", "host_sync"), ("X", "retire"),
            ("X", "prefill"), ("X", "decode"), ("i", "submit"),
            ("i", "chunk"), ("i", "cache_miss"), ("i", "cache_hit"),
            ("i", "snapshot"), ("i", "first_token"), ("i", "token"),
            ("i", "retire"), ("i", "drop"), ("C", "memory")} <= names
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("name") == "thread_name"}
    assert {"tick", "queue", "slot0", "slot1", "mem"} <= tracks
    assert json.dumps(trace)


def test_watchdog_counts_a_new_shape_after_warm_up(smoke_model):
    tel = Telemetry(trace=True)
    eng = ServeEngine(smoke_model, slots=2, max_len=64, telemetry=tel)
    for p in _prompts([5, 20]):
        eng.submit(p, 3)
    eng.run()
    assert eng.stats()["retraces"] == 0
    eng.reset_stats()
    assert tel.watchdog.steady
    for p in _prompts([5, 20], seed=1):            # the warmed shapes
        eng.submit(p, 3)
    eng.run()
    assert eng.stats()["retraces"] == 0
    eng.submit(_prompts([9])[0], 3)                # a new tail length
    eng.run()
    st = eng.stats()
    assert st["retraces"] == 1
    assert tel.registry.get("serve_retraces_total").labels(
        entry="prefill_resume").value == 1
    assert any(e[1] == "recompile" for e in tel.tracer._events)
    assert set(tel.watchdog.cache_sizes()) == {
        "prefill", "prefill_resume", "fresh_slot", "restore",
        "install_slot", "decode", "replay", "install_restored",
        "kernel_libraries"}


def test_metric_names_cover_the_jax_engines(smoke_model):
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(0))
    jtel = JaxTelemetry(memory=True)
    JaxServeEngine(jm, jm.cfg, params, slots=2, max_len=32, telemetry=jtel,
                   prefix_cache=JaxPrefixCache(1 << 20))
    jtel.watchdog.check()          # the watchdog's labelled series
    tel = Telemetry(memory=True)
    ServeEngine(smoke_model, slots=2, max_len=32, telemetry=tel,
                prefix_cache=PrefixCache(1 << 20))
    tel.watchdog.check()
    outside = ("serve_mesh_", "serve_collective_", "serve_recovered_")
    want = {n for n in jtel.registry.names() if not n.startswith(outside)}
    assert want <= set(tel.registry.names())
    text = tel.render_prometheus()
    assert 'serve_jit_cache_size{entry="decode"} 0' in text
    assert "serve_prefix_cache_hits_total 0" in text


def test_stats_view_and_reset_marks_steady(smoke_model):
    pc = PrefixCache(1 << 22)
    eng = ServeEngine(smoke_model, slots=2, max_len=64, prefix_cache=pc)
    shared = _prompts([32], seed=5)[0]
    for sfx in _prompts([3, 4, 5], seed=6):
        eng.submit(np.concatenate([shared, sfx]), 4)
    eng.run()
    st = eng.stats()
    reg = eng.telemetry.registry
    assert st["retraces"] == 0 and st["prefix_cache"]["hits"] >= 1
    assert reg.get("serve_prefix_cache_hits_total").value == pc.hits
    assert reg.get("serve_prefix_cache_hit_tokens_total").value == \
        st["prefix_cache"]["hit_tokens"]
    assert reg.get("serve_scheduler_promote_splits_total").value == \
        st["scheduler"]["promote_splits"]
    assert reg.get("serve_scheduler_parked").value == 0
    eng.reset_stats()
    st = eng.stats()
    assert st["prefix_cache"]["hits"] == 0 and st["requests"] == 0
    assert st["prefix_cache"]["entries"] == len(pc) > 0   # entries stay
    assert eng.telemetry.watchdog.steady


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--requests", "8", "--prompt-len", "96",
       "--shared-prefix", "64", "--prefix-cache-mb", "8", "--warm",
       "--expect-no-retraces"]


def test_serve_cli_prefix_cache_trace_metrics_and_restart(tmp_path, capsys):
    from repro_torch.launch.serve import main
    cache = str(tmp_path / "cache")
    trace, prom = tmp_path / "trace.json", tmp_path / "serve.prom"
    toks = [tmp_path / "a.json", tmp_path / "b.json"]
    main(CLI + ["--prefix-cache-dir", cache, "--trace-out", str(trace),
                "--metrics-out", str(prom), "--tokens-out", str(toks[0])])
    out = capsys.readouterr().out
    assert "6/8 hits" in out and "2 coalesced, 1 promote splits" in out
    assert "retraces: 0 mid-serve" in out and "schema valid" in out
    t = json.loads(trace.read_text())
    assert validate_trace(t) == [] and jax_validate_trace(t) == []
    assert "serve_prefix_cache_hits_total 6" in prom.read_text()
    main(CLI + ["--prefix-cache-dir", cache, "--expect-disk-hits",
                "--tokens-out", str(toks[1])])
    out = capsys.readouterr().out
    assert "8/8 hits" in out and "1 disk loads" in out
    assert json.loads(toks[0].read_text()) == json.loads(toks[1].read_text())


def test_serve_cli_gates(tmp_path):
    from repro_torch.launch.serve import main
    base = ["--smoke", "--device", "cpu", "--requests", "2", "--gen", "2"]
    with pytest.raises(SystemExit, match="requires --warm"):
        main(base + ["--expect-no-retraces"])
    with pytest.raises(SystemExit, match="prefix-cache-dir"):
        main(base + ["--prefix-cache-mb", "1", "--expect-disk-hits"])
    with pytest.raises(SystemExit, match="expected disk loads"):
        main(base + ["--prefix-cache-mb", "1", "--expect-disk-hits",
                     "--prefix-cache-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="shared-prefix"):
        main(base + ["--shared-prefix", "64"])
