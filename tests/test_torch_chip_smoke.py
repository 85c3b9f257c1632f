"""The bounds `chip_smoke.py` reports beside each kernel's time, computed on
the CPU from the shapes alone (no card, no JAX): the least time an H100
could take, on the tensor-core route (3xTF32) and on the f32 FMA pipes;
and the reckonings its phases make from shapes (long-context memory, the
prefix phase's snapshot bytes and launches)."""
import importlib.util
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (kernel, bound function's arguments, tensor-core ms, its limit, FMA ms, its limit)
CASES = [
    ("b3_bound", (4, 16384, 32, 64, 256), 0.01502, "bytes", 0.03215, "operations"),
    ("b3_bound", (4, 2048, 32, 64, 256), 0.001878, "bytes", 0.004019, "operations"),
    ("b1_bound", (48, 2048, 32, 64, 1024, 4), 0.2491, "operations", 0.5954, "operations"),
    ("b2_bound", (48, 2040, 64, 4), 0.1611, "operations", 0.3879, "operations"),
    # bf16 operands: only the TF32 passes whose lo half is not zero, and a
    # product of two bf16 operands at the bf16 rate, half a TF32 pass (B1 at
    # starcoder2-3b's training shape; B2 at the serving shape)
    ("b1_bound", (24, 4096, 32, 128, 256, 4, 2), 0.2985, "operations", 0.8916, "operations"),
    ("b2_bound", (48, 2040, 64, 4, 2), 0.07067, "operations", 0.3879, "operations"),
    ("b1_bwd_bound", (24, 4096, 32, 64, 1024, 4), 0.4938, "operations", 1.1852,
     "operations"),
    # B2's backward at the training shape: 201.4 M causal pairs, 5 x 2h
    # flops of products each (128.9 GFLOP) and 1.6 GFLOP of the rest
    ("b2_bwd_bound", (24, 4096, 64, 4), 0.8054, "operations", 1.9479, "operations"),
    # phase 12's bf16 shapes: llava's 4 x 32 heads of 128 over 2048 tokens
    # and one 256-token prefill block; Whisper's decoder in training (4 x
    # 20 heads of 64, 448 tokens padded to 512), forward and backward
    ("b1_bound", (128, 2048, 32, 128, 256, 4, 2), 0.7960, "operations", 2.3776,
     "operations"),
    ("b1_bound", (128, 256, 32, 128, 256, 4, 2), 0.09950, "operations", 0.2972, "operations"),
    ("b1_bound", (80, 512, 32, 64, 256, 4, 2), 0.06279, "operations", 0.1872, "operations"),
    # (bf16: the passes by operand width, as the forwards count them)
    ("b1_bwd_bound", (80, 512, 32, 64, 256, 4, 2), 0.1016, "operations", 0.3002,
     "operations"),
    # B1's backward at starcoder2-3b's h-128 training shape, bf16 and f32
    ("b1_bwd_bound", (24, 4096, 32, 128, 256, 4, 2), 0.5912, "operations", 1.7630,
     "operations"),
    ("b1_bwd_bound", (24, 4096, 32, 128, 256, 4), 0.7289, "operations", 1.7630,
     "operations"),
    # B2's backward at the training shape in bf16 (h 64, 128) and f32 at h 128
    ("b2_bwd_bound", (24, 4096, 64, 4, 2), 0.5191, "operations", 1.9479, "operations"),
    ("b2_bwd_bound", (24, 4096, 128, 4, 2), 1.0141, "operations", 3.8737, "operations"),
    ("b2_bwd_bound", (24, 4096, 128, 4), 1.5868, "operations", 3.8737, "operations"),
]


@pytest.mark.parametrize("fn,args,tc_ms,tc_by,fma_ms,fma_by", CASES)
def test_kernel_bounds(chip_smoke, fn, args, tc_ms, tc_by, fma_ms, fma_by):
    bd = getattr(chip_smoke, fn)(*args)
    assert bd.tc_ms == pytest.approx(tc_ms, rel=0.01)
    assert bd.fma_ms == pytest.approx(fma_ms, rel=0.01)
    assert (bd.tc_by, bd.fma_by) == (tc_by, fma_by)
    assert bd.tc_ms < bd.fma_ms


def test_backward_kernel_names_are_its_own(chip_smoke):
    """The training step's split counts a kernel under the first group whose
    substrings its name holds: every backward kernel is a __global__ of
    polysketch_causal_bwd.cu, lands in the backward's group and pass, and
    holds no forward kernel's name."""
    from repro_torch.kernels import polysketch_causal as pc
    src = (ROOT / "src/repro_torch/kernels/csrc/polysketch_causal_bwd.cu").read_text()
    groups = chip_smoke.STEP_GROUPS
    passes = dict((key, name) for name, key in chip_smoke.B1_BWD_PASSES)
    for kernel in pc.BWD_KERNELS:
        assert f"\n{kernel}(" in src, kernel
        assert not any(f in kernel for f in ("output_kernel", "prefix_kernel", "fold_kernel"))
        first = next(g for g, keys in groups if any(k in kernel for k in keys))
        assert first.startswith("B1 backward"), (kernel, first)
        assert kernel in passes
    assert set(chip_smoke.B1_BWD_HEAVY) <= set(pc.BWD_KERNELS)


def test_forward_kernel_names_are_their_own(chip_smoke):
    """Every forward kernel (FWD_KERNELS of B1 and B2) is a __global__ of
    its forward's sources, holds no backward kernel's name, lands in its
    forward's group of the training step's split, and B1's in exactly one
    of the per-pass split's passes."""
    from repro_torch.kernels import poly_flash as pf
    from repro_torch.kernels import polysketch_causal as pc
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    sources = {"B1": "".join((csrc / f).read_text() for f in (
                   "polysketch_causal.cu", "polysketch_state.cuh")),
               "B2": (csrc / "poly_flash.cu").read_text()}
    passes = [key for _, key in chip_smoke.B1_FWD_PASSES]
    backward = pc.BWD_KERNELS + pf.BWD_KERNELS
    for label, kernels in (("B1", pc.FWD_KERNELS), ("B2", pf.FWD_KERNELS)):
        for kernel in kernels:
            assert f"\n{kernel}(" in sources[label], kernel
            assert not any(b in kernel or kernel in b for b in backward), kernel
            first = next(g for g, keys in chip_smoke.STEP_GROUPS
                         if any(k in kernel for k in keys))
            assert first.startswith(f"{label} forward"), (kernel, first)
            if label == "B1":
                assert sum(key in kernel for key in passes) == 1, kernel
    assert set(chip_smoke.FWD_HEAVY) <= set(pc.FWD_KERNELS + pf.FWD_KERNELS)


def test_b2_backward_kernel_names_are_its_own(chip_smoke):
    """B2's backward kernels are __global__s of poly_flash_bwd.cu, land in
    the step split's B2-backward group and pass, and hold neither B2's
    forward kernel's name nor any of B1's."""
    from repro_torch.kernels import poly_flash as pf
    from repro_torch.kernels import polysketch_causal as pc
    src = (ROOT / "src/repro_torch/kernels/csrc/poly_flash_bwd.cu").read_text()
    passes = [key for _, key in chip_smoke.B2_BWD_PASSES]
    for kernel in pf.BWD_KERNELS:
        assert f"\n{kernel}(" in src, kernel
        assert "poly_flash_kernel" not in kernel
        assert not any(b1 in kernel for b1 in pc.BWD_KERNELS) and "grad_" not in kernel
        first = next(g for g, keys in chip_smoke.STEP_GROUPS if any(k in kernel for k in keys))
        assert first.startswith("B2 backward"), (kernel, first)
        assert sum(key in kernel for key in passes) == 1
    bd = chip_smoke.b2_bwd_bound(24, 4096, 64, 4)
    assert bd.nbytes == 24 * 4096 * (8 * 64 * 4 + 4)        # eight f32 tensors and D
    assert round(bd.flops / 1e9, 1) == 130.5                 # 128.9 products + 1.6 rest


@pytest.mark.parametrize("seq,gib", [(32768, 48.0), (16384, 12.0)])
def test_softmax_scores_reckoning(chip_smoke, seq, gib):
    """The plain softmax path's (1, 12, seq, seq) f32 scores, in GiB."""
    assert chip_smoke.s2_gib(1, 12, seq) == gib


@pytest.mark.parametrize("name,seq,fits", [
    ("gpt2s-polysketch", 32768, True), ("gpt2s-poly4", 32768, True),
    ("gpt2s-softmax", 16384, True), ("gpt2s-softmax", 32768, False)])
def test_long_context_reckoning_on_an_80_gb_card(chip_smoke, name, seq, fits):
    """Phase 6 decides from the shapes which (model, context) pairs it
    runs: at remat "full", one row a microbatch, against 90 % of an H100's
    79.2 GiB."""
    from repro_torch.configs import get_config
    from repro_torch.configs.gpt2_paper import GPT2_SMALL_POLY4, GPT2_SMALL_SOFTMAX
    cfg = {"gpt2s-polysketch": get_config("gpt2s-polysketch"),
           "gpt2s-poly4": GPT2_SMALL_POLY4, "gpt2s-softmax": GPT2_SMALL_SOFTMAX}[name]
    need = chip_smoke.reckon_full_remat_gib(cfg, seq)
    assert (need <= chip_smoke.LONG_FIT_SHARE * 79.2) == fits, need
    if name == "gpt2s-softmax":
        assert need > 3 * chip_smoke.s2_gib(1, 12, seq)


def test_prefix_phase_reckoning(chip_smoke):
    """Phase 9's CPU-checkable parts: one snapshot of gpt2s-polysketch at
    full width is 13 layers x 12 kv heads x 32^2 x 65 x 4 B, the same as a
    real snapshot's bytes; every request's prompt is the 3072-token system
    prompt plus a 256-1023-token suffix, so each hit restores 3 blocks and
    prefills one (B1 once a layer), and no measured request inserts (its
    truncation is the system prompt), so the memory-tier run writes no
    disk file."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.prefix_cache import snapshot_nbytes
    cfg = get_config("gpt2s-polysketch")
    assert chip_smoke.reckon_snapshot_bytes(cfg) == 41_533_440
    meta = build_model(cfg, device="meta")
    snap = meta.state.snapshot(meta.state.init_slot(4096))
    assert snapshot_nbytes(snap) == 41_533_440
    prompts, warm, samp = chip_smoke.prefix_workload(cfg.vocab_size)
    blk, shared = cfg.lt_block_size, chip_smoke.PREFIX_SHARED
    assert len(prompts) == len(warm) == 8 and shared == 3 * blk
    for p, w in zip(prompts, warm):
        assert np.array_equal(p[:shared], prompts[0][:shared])
        assert np.array_equal(w[:shared], p[:shared]) and len(w) == len(p)
        assert not np.array_equal(w, p)
        assert 256 <= len(p) - shared < 1024 and len(p) // blk * blk == shared
        assert len(p) + chip_smoke.ENGINE_GEN <= max(chip_smoke.ENGINE_LENS) + \
            chip_smoke.ENGINE_GEN
    assert sum(not s.is_greedy for s in samp) == 4
    cold = sum(-(-len(p) // blk) for p in prompts)
    assert cold == 32 and sum(-(-(len(p) - shared) // blk) for p in prompts) == 8


@pytest.mark.parametrize("arch,nbytes", [("mamba2-780m", 76_455_936),
                                         ("recurrentgemma-9b", 26_230_784)])
def test_recurrent_snapshot_reckoning(chip_smoke, arch, nbytes):
    """Phase 10's snapshot bytes at the published width, bf16: mamba2's 48
    x ((48, 128, 64) f32 h + (3, 3328) conv), recurrentgemma's 26 RG-LRU
    layers of h (f32) and conv plus 12 rings of (1, 2048, 256) k and v; a
    real snapshot of a fresh slot (meta device) has those bytes, and a
    window of max_len < 2048 shrinks only the rings."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.prefix_cache import snapshot_nbytes
    cfg = get_config(arch)
    max_len = chip_smoke.REC_SHARED + chip_smoke.REC_SUFFIX[1] + chip_smoke.REC_GEN
    assert chip_smoke.reckon_recurrent_snapshot_bytes(cfg, max_len) == nbytes
    meta = build_model(cfg, device="meta")
    assert snapshot_nbytes(meta.state.snapshot(meta.state.init_slot(max_len))) == nbytes
    small = chip_smoke.reckon_recurrent_snapshot_bytes(cfg, 1024)
    assert (small == nbytes) == (arch == "mamba2-780m")


@pytest.mark.parametrize("arch,gib,groups", [
    ("mamba2-780m", 79.19, 48), ("recurrentgemma-9b", 79.19, 3),
    ("recurrentgemma-9b", 93.0, 4), ("recurrentgemma-9b", 30.0, 1)])
def test_recurrent_train_depth(chip_smoke, monkeypatch, arch, gib, groups):
    """Phase 10 trains the most whole pattern groups that fit at 16 B a
    parameter: mamba2 at full depth on an 80 GB H100 (79.19 GiB), and
    recurrentgemma at 3 groups of (rglru, rglru, local_attn); at least one
    group on any card. One group of recurrentgemma holds 656.5M
    parameters beside its 1048.6M embedding."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(chip_smoke, "card_gib", lambda: gib)
    assert chip_smoke.rec_train_groups(get_config(arch)) == groups
    if arch == "recurrentgemma-9b":
        assert chip_smoke.group_split(get_config(arch)) == (656_498_688, 1_048_580_096)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_recurrent_served_rows(chip_smoke, arch):
    """Phase 10's whole-row check on a SMOKE model in f32 (block 16; a
    70-token prompt wraps recurrentgemma's 32-slot ring, then 6 decode
    steps): every served row, the prefill's and the decode steps', lies
    within phase 10's f32 limits of the train-mode forward's at its own
    position, and the control's float8_e5m2 states part from it by far
    more."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    model = build_model(get_config(arch, smoke=True, lt_block_size=16), device="cpu", seed=0)
    seq = torch.from_numpy(np.random.default_rng(4).integers(0, 128, 77))
    want = chip_smoke.train_rows(model, seq)
    assert want.shape == (76, model.cfg.vocab_size)
    rel, lp = chip_smoke.rec_rows(model, seq, 70, want)
    assert rel <= chip_smoke.F32_TOL and lp <= chip_smoke.REC_LP_TOL
    c_rel, c_lp = chip_smoke.rec_rows(model, seq, 70, want, torch.float8_e5m2)
    assert c_rel > 100 * rel and c_lp > 100 * lp


@pytest.mark.parametrize("arch,per,reserve,gib,layers", [
    ("dbrx-132b", 4, "MOE_SERVE_RESERVE_GIB", 79.19, 5),
    ("dbrx-132b", 16, "MOE_TRAIN_RESERVE_GIB", 79.19, 1),
    ("llama4-maverick-400b-a17b", 4, "MOE_SERVE_RESERVE_GIB", 79.19, 2),
    ("llama4-maverick-400b-a17b", 4, "MOE_SERVE_RESERVE_GIB", 300.0, 8)])
def test_moe_depth(chip_smoke, monkeypatch, arch, per, reserve, gib, layers):
    """Phase 11 reckons depth in whole cycles of the effective pattern and
    never below the first MoE layer: on an 80 GB H100 (79.19 GiB) dbrx
    serves 5 of its 40 layers (3.259B parameters a layer) and trains 1,
    and maverick serves its first (GLU, MoE) cycle (16.36B parameters),
    which the reckoning alone would not place beside its reserve."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(chip_smoke, "card_gib", lambda: gib)
    cfg = get_config(arch)
    assert chip_smoke.moe_depth(cfg, per, getattr(chip_smoke, reserve)) == layers
    cycle, g, rest = chip_smoke.cycle_split(cfg)
    assert (cycle, g, rest) == {"dbrx-132b": (3_259_201_792, 1, 616_568_832),
                                "llama4-maverick-400b-a17b": (16_358_695_424, 2,
                                                              1_034_490_880)}[arch]


@pytest.mark.parametrize("arch,gib,layers", [
    ("deepseek-7b", 79.19, 8), ("yi-34b", 79.19, 8), ("yi-34b", 30.0, 6),
    ("starcoder2-3b", 79.19, 8), ("llava-next-mistral-7b", 79.19, 8)])
def test_dense_serve_depth(chip_smoke, monkeypatch, arch, gib, layers):
    """Phase 7 serves each dense model at the most layers whose f32 weights
    fit beside its reserve, at most DENSE_SERVE_LAYERS (8)."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(chip_smoke, "card_gib", lambda: gib)
    assert chip_smoke.serve_depth(get_config(arch)) == layers


def test_vlm_train_depth(chip_smoke, monkeypatch):
    """Phase 12 trains llava at the most layers that fit at 16 B a
    parameter on an 80 GB H100: 14 of 32 (218.2M parameters a layer beside
    a 131.1M embedding)."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(chip_smoke, "card_gib", lambda: 79.19)
    cfg = get_config("llava-next-mistral-7b")
    assert chip_smoke.param_split(cfg) == (218_228_992, 131_076_096)
    assert chip_smoke.train_depth(cfg) == 14


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-large-v3"])
def test_xm_served_logprobs_match_train_mode(chip_smoke, monkeypatch, arch):
    """Phase 12's serving check on a SMOKE model in f32 on the CPU: the
    greedy tokens served through make_serve_fns (image rows or frames in
    the prefill, then decode steps past a 16-token block) have the
    log-probabilities of a train-mode forward over the prompt and those
    tokens, within phase 12's f32 gate; fed those tokens again (the
    teacher-forced path phase 12 serves through the plain B1), it gives
    the same log-probabilities bit for bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    rng = np.random.default_rng(5)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dtype)
    monkeypatch.setattr(chip_smoke, "seeded", lambda seed: rnd)
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu", seed=0)
    batch = chip_smoke.xm_inputs(cfg, 2, 20, seed=3)
    assert ("image_embeds" in batch) == (cfg.family == "vlm")
    toks, lps, _, _ = chip_smoke.xm_serve(model, batch, 8)
    assert toks.shape == lps.shape == (2, 8)
    want, _ = chip_smoke.xm_train_logprobs(model, batch, toks)
    err = float(np.abs(lps - want).max())
    assert err <= 1e-4 < chip_smoke.ENGINE_LP_TOL
    forced, forced_lps, _, _ = chip_smoke.xm_serve(model, batch, 8, force=toks)
    assert np.array_equal(forced, toks) and np.array_equal(forced_lps, lps)


def test_replica_workload_crosses_block_boundaries(chip_smoke):
    """Phase 14's traffic: four of its six prompts reach a 1024-token
    block boundary within their first 8 decode ticks, so replicas write
    checkpoints early; the warm-up prompts have the same lengths and other
    tokens; requests 0-2 are greedy and 3-5 sampled."""
    prompts, warm, samp = chip_smoke.replica_workload(50304)
    assert [len(p) for p in prompts] == [len(p) for p in warm] == list(
        chip_smoke.REPLICA_LENS)
    assert sum(-len(p) % 1024 <= 8 for p in prompts) == 4
    assert not any(np.array_equal(p, w) for p, w in zip(prompts, warm))
    assert [s.is_greedy for s in samp] == [True] * 3 + [False] * 3
