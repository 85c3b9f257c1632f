"""The port's ServeEngine held to the JAX package's on SMOKE models bridged
from one JAX init, for polysketch, poly4 and softmax: greedy and sampled
requests of mixed prompt lengths, a queue longer than the slots, one
request retired early by EOS while the others continue; the same tokens
(and log-probabilities within 1e-4) at other slot counts, with overlap and
a prefill budget on and off. Then the engine against itself (cancel
mid-prefill, stats) and the serving CLI."""
import json

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine, generate  # noqa: E402
from repro_torch.serve.plan import ServePlan  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402

ARCH = "gpt2s-polysketch"
MAX_LEN = 64
LP_TOL = 1e-4
# (prompt length, max new tokens, sampling): mixed lengths around SMOKE's
# block of 16, greedy and sampled; request 0 gets an EOS its greedy run hits
WORKLOAD = [
    (5, 10, {}),
    (17, 8, dict(temperature=0.8, top_k=12, top_p=0.9, seed=7)),
    (33, 6, {}),
    (16, 9, dict(temperature=1.1, seed=11)),
    (40, 7, dict(temperature=0.7, top_p=0.8, seed=3)),
]


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=n) for n, _, _ in WORKLOAD]


def _port_engine_outputs(tm, eos, *, slots, overlap, budget, order=None):
    eng = ServeEngine(tm, slots=slots, max_len=MAX_LEN, logprobs=True,
                      overlap=overlap, prefill_budget=budget)
    order = order or range(len(WORKLOAD))
    prompts = _prompts()
    rid_of = {}
    for i in order:
        n, gen, sp = WORKLOAD[i]
        rid_of[eng.submit(prompts[i], gen, eos if i == 0 else None,
                          sampling=SamplingParams(**sp))] = i
    outs = eng.run()
    assert not eng.busy and eng.n_active == 0
    return {rid_of[o.rid]: o for o in outs}, eng


@pytest.fixture(scope="module", params=["polysketch", "polynomial", "softmax"])
def served(request):
    """(port model, eos id, the JAX engine's outputs by request index)."""
    over = dict(attention=request.param)
    jm = jax_build_model(jax_get_config(ARCH, smoke=True, **over))
    params, _ = jm.init(jax.random.PRNGKey(1))
    cfg = get_config(ARCH, smoke=True, **over)
    tm = build_model(cfg, device="cpu", params=params_from_jax(_flat(params), cfg))
    prompts = _prompts()
    greedy0 = generate(tm, prompts[0][None], 10, max_len=MAX_LEN).tokens[0]
    eos = int(greedy0[3])
    jeng = JaxServeEngine(jm, jm.cfg, params, slots=2, max_len=MAX_LEN,
                          logprobs=True)
    for i, (n, gen, sp) in enumerate(WORKLOAD):
        jeng.submit(jnp.asarray(prompts[i], jnp.int32), gen,
                    eos if i == 0 else None, sampling=JaxSamplingParams(**sp))
    want = {o.rid: o for o in jeng.run()}
    return tm, eos, want, (jm, params)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i, w in want.items():
        g = got[i]
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
        assert g.prompt_len == w.prompt_len == WORKLOAD[i][0]
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LP_TOL,
                                   rtol=LP_TOL)


@pytest.mark.parametrize("slots,overlap,budget", [
    (2, False, None), (2, True, None), (2, False, 16), (2, True, 16),
    (3, True, 32), (1, False, 16)])
def test_engine_matches_jax_engine(served, slots, overlap, budget):
    tm, eos, want, _ = served
    got, eng = _port_engine_outputs(tm, eos, slots=slots, overlap=overlap,
                                    budget=budget)
    _assert_same(got, want)
    assert got[0].finish_reason == "eos" and got[0].tokens[-1] == eos
    assert len(got[0].tokens) <= 4
    st = eng.stats()
    assert st["requests"] == len(WORKLOAD) and st["prefills"] == len(WORKLOAD)
    assert st["sampled_requests"] == 3
    assert st["generated_tokens"] == sum(len(o.tokens) for o in got.values())


def test_generate_matches_jax_generate_greedy_and_sampled(served):
    tm, _, _, (jm, params) = served
    prompt = _prompts()[3][None]
    for sp in ({}, dict(temperature=0.8, top_k=12, top_p=0.9, seed=7)):
        want = jax_generate(jm, jm.cfg, params, jnp.asarray(prompt, jnp.int32),
                            9, max_len=MAX_LEN, sampling=JaxSamplingParams(**sp))
        got = generate(tm, prompt, 9, max_len=MAX_LEN,
                       sampling=SamplingParams(**sp))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.logits_last.numpy(),
                                   np.asarray(want.logits_last), atol=1e-4,
                                   rtol=1e-4)


def test_engine_tokens_do_not_depend_on_submission_order(served):
    tm, eos, want, _ = served
    got, _ = _port_engine_outputs(tm, eos, slots=2, overlap=True, budget=16,
                                  order=[4, 3, 2, 1, 0])
    for i, w in want.items():
        np.testing.assert_array_equal(got[i].tokens, w.tokens)


# ---------------------------------------------------------------------------
# the engine against itself
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    return build_model(get_config(ARCH, smoke=True), device="cpu", seed=4)


def test_cancel_mid_prefill_then_resubmit_gives_the_same_tokens(smoke_model):
    prompt = np.random.default_rng(9).integers(0, 128, size=60)
    ref = generate(smoke_model, prompt[None], 6, max_len=MAX_LEN + 16)
    eng = ServeEngine(smoke_model, slots=1, max_len=MAX_LEN + 16,
                      prefill_budget=16)
    rid = eng.submit(prompt, 6)
    queued = eng.submit(prompt[:9], 3)
    eng.step()                                  # one 16-token chunk landed
    job = eng.scheduler.jobs[0]
    assert job.req.rid == rid and job.part.n_tokens == 16 and job.cuts
    assert eng.cancel(queued).rid == queued     # still queued
    req = eng.cancel(rid)
    assert req.rid == rid and not eng.scheduler.jobs and not eng.busy
    assert eng.cancel(rid) is None and eng.cancel(12345) is None
    rid2 = eng.submit(prompt, 6)
    outs = eng.run()
    assert [o.rid for o in outs] == [rid2]
    np.testing.assert_array_equal(outs[0].tokens, ref.tokens[0].numpy())
    assert eng.stats()["scheduler"]["chunks"] == 1 + 4


def test_make_serve_fns_match_generate(smoke_model):
    """The single-shot prefill (across two blocks) and a decode step at
    per-row positions give generate's first two tokens."""
    from repro_torch.serve.engine import make_serve_fns
    prefill, decode = make_serve_fns(smoke_model)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (2, 21)))
    ref = generate(smoke_model, prompt, 2).tokens
    last, cache = prefill(prompt)
    tok = last.argmax(-1)[:, None]
    logits, _ = decode(tok, [c._replace(pos=torch.tensor([21, 21]))
                             for c in cache], torch.tensor([21, 21]))
    assert torch.equal(torch.cat([tok, logits.argmax(-1)[:, None]], 1), ref)


def test_submit_rejects_invalid_requests_and_unported_options(smoke_model):
    eng = ServeEngine(smoke_model, slots=1, max_len=16)
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit(np.zeros(0, np.int64), 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.zeros(3, np.int64), 0)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(10, np.int64), 7)
    # a plan over more than one device needs a mesh of running ranks
    with pytest.raises(ValueError, match="needs a DeviceMesh over its running ranks"):
        ServeEngine(smoke_model, plan=ServePlan(
            {"data": 2, "model": 1}, torch.device("cpu")))
    with pytest.raises(ValueError, match="slot"):
        ServeEngine(smoke_model, slots=0)
    with pytest.raises(ValueError, match="min_snapshot_blocks"):
        ServeEngine(smoke_model, min_snapshot_blocks=0)


def test_stats_and_metrics_registry_agree(smoke_model):
    eng = ServeEngine(smoke_model, slots=2, max_len=MAX_LEN, overlap=True)
    for n in (5, 20, 9):
        eng.submit(np.arange(n) % 128, 4)
    outs = eng.run()
    st = eng.stats()
    reg = eng.telemetry.registry
    assert st["requests"] == 3 == len(outs)
    assert st["generated_tokens"] == 12 == reg.get("serve_tokens_total").value
    assert st["decode_steps"] == reg.get("serve_decode_ticks_total").value
    assert reg.get("serve_requests_finished_total").total == 3
    assert reg.get("serve_ttft_ms").count == 3
    assert "serve_tokens_total 12" in eng.telemetry.render_prometheus()
    eng.reset_stats()
    assert eng.stats()["requests"] == 0 and eng.stats()["generated_tokens"] == 0


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--requests", "6", "--slots", "2",
       "--prompt-len", "40", "--gen", "12", "--rate", "10", "--eos-id", "8"]


def test_serve_cli_retires_on_eos_and_overlap_keeps_the_tokens(tmp_path,
                                                               capsys):
    """Token 8 is emitted by request 0's greedy run of the seed-0 SMOKE
    model, so one slot retires early; the same flags with --overlap and a
    prefill budget write the same tokens."""
    from repro_torch.launch.serve import main
    a, b = tmp_path / "lockstep.json", tmp_path / "overlap.json"
    outs = main(CLI + ["--tokens-out", str(a)])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip().startswith("req")]
    assert len(lines) == 6
    assert all("ttft=" in ln and "latency=" in ln for ln in lines)
    assert any("(eos)" in ln for ln in lines)
    assert any(o.finish_reason == "eos" and len(o.tokens) < 12 for o in outs)
    assert "ttft    p50=" in out and "latency p50=" in out
    main(CLI + ["--overlap", "--prefill-budget", "16", "--tokens-out", str(b)])
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_serve_cli_sampled_run_and_logprobs(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
          "--prompt-len", "20", "--gen", "4", "--temperature", "0.8",
          "--top-k", "40", "--top-p", "0.95", "--seed-per-request",
          "--logprobs"])
    out = capsys.readouterr().out
    assert "(3/3 requests sampled)" in out and "logprobs: mean=" in out
    with pytest.raises(SystemExit, match="temperature"):
        main(["--smoke", "--device", "cpu", "--top-k", "5"])


@pytest.mark.parametrize("flag,says", [
    (["--mesh", "2x1"], "wants 2 devices but only 1 ranks are running"),
    (["--share-card"], "--share-card goes with --mesh"),
    (["--chaos=kill@3"], "--chaos needs --replicas"),
    (["--replicas", "2", "--shard-model"], "drop --mesh/--shard-model")])
def test_serve_cli_rejects_unported_flags(flag, says):
    """A mesh beyond one device needs its ranks running (torchrun), and
    --share-card a mesh; chaos without replicas and replicas with a mesh
    are the reference's own refusals."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--smoke", "--device", "cpu"] + flag)
    assert e.value.code not in (0, None) and says in str(e.value.code)


def test_serve_cli_replicas_chaos_gate(tmp_path, capsys):
    """The reference's CI chaos gate: two replicas under kill@6 write the
    fault-free run's --tokens-out file exactly (tokens and log-probabilities
    bit for bit), and every request is served once."""
    from repro_torch.launch.serve import main
    files = []
    for chaos in ("none", "kill@6"):
        files.append(tmp_path / f"{chaos}.json")
        main(CLI + ["--replicas", "2", "--mesh", "1x1", "--chaos", chaos,
                    "--logprobs", "--tokens-out", str(files[-1])])
        out = capsys.readouterr().out
        assert ("deaths={}" if chaos == "none"
                else "deaths={'kill': 1}") in out
    assert files[0].read_text() == files[1].read_text()


def test_serve_cli_replicas_fail_on_a_death_the_schedule_did_not_cause(
        monkeypatch):
    """A replica whose tick raises fails over, every request is served, and
    the run still exits non-zero: the fault was real, not injected."""
    from repro_torch.launch.serve import main
    from repro_torch.serve.engine import ServeEngine
    step, n = ServeEngine.step, [0]

    def failing(self):
        n[0] += 1
        if n[0] == 9:
            raise RuntimeError("device fault")
        return step(self)
    monkeypatch.setattr(ServeEngine, "step", failing)
    with pytest.raises(SystemExit) as e:
        main(CLI + ["--replicas", "2", "--logprobs"])
    assert "did not cause" in str(e.value.code)
    assert "device fault" in str(e.value.code)
