"""The ``mamba1`` family (the published Mamba1 block, Falcon-Mamba-7B's) on
the port's int8 compile path, on the CPU at the smoke widths (d_model 64,
d_inner 128, state 4, dt_rank 8, vocab 512, 16 positions), against the
benchmark's plain reference (``bench/reference/mamba1.py``) on the same
seeded weights.

The tolerance.  The reference computes the float interludes in float32 in
the program's order, so a sound program gives the reference's int8 codes
exactly: every code of the last block's output equal.  The logits are then
the same float32 normed state times the unembedding, in float32 in the
program and in float64 in the reference: they differ by at most the
rounding of a d-term float32 dot product, ``gamma_d * sum_i |hn_i| *
|U_iv|`` with ``gamma_d = d u / (1 - d u)``, ``u = 2^-24``.  One int8 step
anywhere moves codes and logits far past that: so do the planted faults
below, each a part of the block left out or changed, and the interludes
in bfloat16.
"""
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench import lm_work  # noqa: E402
from bench.models import mamba1 as M  # noqa: E402
from bench.reference import mamba1 as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.compile import (  # noqa: E402
    Conv1dTask, Mamba1ScanTask, MatmulTask, NormTask, QMamba1Config,
    compile_model, lm_config, lm_params, lower_features, lower_forward,
    optimized_graph, plan_lm)
from repro_torch.compile import backends as BK  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.serve import ImageRequest, ResNetEngine  # noqa: E402

SEQ = 16
SEEDS = (3, 2 ** 31 + 77)
BENCH_CFG = os.path.join(REPO, "bench", "configs", "falcon-mamba-7b.json")


def bench_cfg(layers=3):
    """The benchmark's configuration file at the port's smoke widths."""
    smoke = get_smoke_config("falcon-mamba-7b")
    cfg = json.load(open(BENCH_CFG))
    cfg.update(num_hidden_layers=layers, hidden_size=smoke.d_model,
               intermediate_size=smoke.d_inner, state_size=smoke.ssm_state,
               time_step_rank=smoke.dt_rank, vocab_size=smoke.vocab_size)
    return cfg


def port_cfg(cfg):
    return M.port_config(lm_params, cfg, dict(seq_len=SEQ))


@pytest.fixture(scope="module", params=SEEDS)
def seeded(request):
    seed = request.param
    cfg = bench_cfg()
    params = M.quantized_params(lm_params, cfg, seed, "cpu")
    toks = M.prompt_pool(cfg, dict(pool_images=4, seq_len=SEQ), seed, "cpu")
    net = ref.prepare(dict(seed=seed, device="cpu"), cfg)
    h = ref.features(net, toks)
    return seed, cfg, params, toks, net, h, ref.head(net, h)


def head_tolerance(net, h):
    """Per logit: the float32 rounding of the head's d-term product."""
    cfg = net.cfg
    d = cfg["hidden_size"]
    u = 2.0 ** -24
    gamma = d * u / (1 - d * u)
    x = (h[:, -1] * 2.0 ** cfg["assumed"]["grids"]["h"]).to(torch.float32)
    hn = ref.rms(x, cfg["layer_norm_epsilon"]) * ref.draw(
        cfg, net.seed, -1, "final_norm", net.device)
    U = ref.draw(cfg, net.seed, -1, "unembed", net.device)
    return gamma * (hn.abs().double() @ U.abs().double())


def agrees(cfg, params, toks, net, h, logits, backend="torch-int"):
    """The comparison: every code of the last block equal, every logit
    within the head's rounding."""
    pc = port_cfg(cfg)
    codes = lower_features(pc, params, backend, device="cpu")(toks)
    out = lower_forward(pc, params, backend, device="cpu")(toks).double()
    return (torch.equal(codes.double(), h) and
            bool(((out - logits).abs() <= head_tolerance(net, h)).all()))


# -- configs, params ---------------------------------------------------------


def test_lm_config_reaches_mamba1_only_when_asked():
    full = get_config("falcon-mamba-7b")
    assert lm_config(full, 512).family == "ssm"
    assert type(lm_config(full, 512)) is lm_params.QLMConfig
    cfg = lm_config(full, 512, family="mamba1")
    assert isinstance(cfg, QMamba1Config) and cfg.family == "mamba1"
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
            cfg.dt_rank, cfg.conv_kernel, cfg.vocab_size) == \
        (64, 4096, 8192, 16, 256, 4, 65_024)
    assert (cfg.norm_eps, cfg.mixer_rms_eps) == (1e-5, 1e-6)
    with pytest.raises(ValueError, match="mamba1"):
        lm_config(get_config("gemma-2b"), 512, family="mamba1")
    with pytest.raises(ValueError, match="no family"):
        lm_config(full, 512, family="dense")


def test_bench_config_is_the_port_config():
    """The benchmark's file holds the port's published widths."""
    cfg = json.load(open(BENCH_CFG))
    assert port_cfg(cfg) == lm_config(get_config("falcon-mamba-7b"), SEQ,
                                      family="mamba1")


def test_int8_weights_equal_the_reference(seeded):
    seed, cfg, params, _, net, _, _ = seeded
    for i, lp in enumerate(params.layers):
        w = ref.layer_weights(net, i)
        for role, name in (("win", "w_in"), ("wx", "w_x"), ("wdt", "w_dt"),
                           ("wo", "w_out")):
            mp = getattr(lp, role)
            assert mp.wq.dtype == torch.int8
            assert torch.equal(mp.wq.double(), w[name][0])
            assert mp.w_spec.exp == w[name][1]
            assert mp.product_exp == w[name + ".product_exp"]
        assert torch.equal(lp.wdt.bq.double(), w["dt_bias"])
        assert not lp.win.bq.any() and not lp.wo.bq.any()
        assert torch.equal(lp.conv.wq.double(), w["conv_w"][0])
        assert torch.equal(lp.conv.bq.double(), w["conv_b"])
        for name in ("norm", "A_log", "D"):
            assert torch.equal(getattr(lp, name), w[name])
        # int8 weights reach +-127 or close; biases fit int16 on their grid
        assert 64 <= int(lp.win.wq.to(torch.int32).abs().max()) <= 128
        for bq, pe in ((lp.wdt.bq, lp.wdt.product_exp),
                       (lp.conv.bq, lp.conv.product_exp)):
            e = lm_params.weight_exp(bq.double() * 2.0 ** pe, bits=16)
            assert int((bq >> max(e - pe, 0)).abs().max()) <= 32767
    assert params.emb_spec.exp == cfg["assumed"]["grids"]["h"]
    assert torch.equal(params.final_norm,
                       ref.draw(cfg, seed, -1, "final_norm", "cpu"))


def test_draws_are_per_matrix_and_seeded():
    cfg = bench_cfg()
    a = ref.draw(cfg, 2 ** 40 + 1, 1, "w_in", "cpu")
    assert torch.equal(a, ref.draw(cfg, 2 ** 40 + 1, 1, "w_in", "cpu"))
    assert not torch.equal(a, ref.draw(cfg, 2 ** 40 + 2, 1, "w_in", "cpu"))
    assert not torch.equal(a, ref.draw(cfg, 2 ** 40 + 1, 2, "w_in", "cpu"))
    A = ref.draw(cfg, 1, 0, "A_log", "cpu")
    assert torch.equal(-torch.exp(A[0]), -torch.arange(1.0, 5.0))
    delta = torch.nn.functional.softplus(ref.draw(cfg, 1, 0, "dt_bias",
                                                  "cpu"))
    assert float(delta.min()) >= 1e-3 * 0.999
    assert float(delta.max()) <= 0.1 * 1.001


# -- graph and plan ----------------------------------------------------------


def test_plan_of_a_block_and_the_head_norm():
    cfg = port_cfg(bench_cfg(layers=2))
    params = M.quantized_params(lm_params, bench_cfg(layers=2), 1, "cpu")
    plan = plan_lm(optimized_graph(cfg), params)
    assert plan.family == "mamba1" and plan.head_norm_eps == 1e-5
    assert plan.logits_in == "h2"
    l0 = [t for t in plan.tasks if t.layer == 0]
    assert [type(t) for t in l0] == [NormTask, MatmulTask, Conv1dTask,
                                     MatmulTask, NormTask, MatmulTask,
                                     Mamba1ScanTask, MatmulTask]
    assert [t.kind for t in l0] == ["norm", "matmul", "conv1d", "matmul",
                                    "norm", "matmul", "scan", "matmul"]
    assert [t.role for t in l0 if t.kind == "matmul"] == \
        ["win", "wx", "wdt", "wo"]
    assert l0[4].splits == (8, 4, 4) and l0[4].eps == 1e-6
    assert l0[0].splits is None and l0[0].eps == 1e-5
    # the residual add folded into wo's accumulator, no add node left
    assert l0[-1].skip == "h0" and l0[1].skip is None
    assert not [n for n in optimized_graph(cfg).nodes if n.op == "add"]


def test_family_kinds_stay_out_of_the_shared_registries():
    """The ssm/dense plans see the shared handlers and impls only."""
    from repro_torch.compile import lowering
    assert not {"norm", "conv1d", "rms_split", "mamba1_scan"} & \
        set(lowering.TASK_HANDLERS)
    assert sorted(k for b, k in BK._TASK_IMPLS if b == "cuda") == \
        ["attention", "matmul", "scan"]
    assert BK.get_task_impl("cuda", "scan", "mamba1") is \
        BK._cuda_mamba1_scan
    assert BK.get_task_impl("cuda", "scan") is BK._cuda_scan
    assert BK.get_task_impl("cuda", "matmul", "mamba1") is BK._cuda_matmul
    assert BK.get_task_impl("cuda", "conv1d", "mamba1") is BK._cuda_conv1d
    assert BK._cuda_conv1d.kernel == "causal_conv1d"
    assert BK.get_task_impl("torch-int", "conv1d", "mamba1") is \
        BK._lm_conv1d


# -- the port against the reference ------------------------------------------


@pytest.mark.parametrize("backend", ["torch-int", "cuda"])
def test_port_gives_the_reference_codes_and_logits(seeded, backend):
    _, cfg, params, toks, net, h, logits = seeded
    assert agrees(cfg, params, toks, net, h, logits, backend)
    # the codes stay inside the residual grid and use its range
    assert 0 < float(h.abs().max()) < 127


def test_every_code_of_every_block_equals_the_reference(seeded):
    """Task by task: each int8 tensor the port's program hands on (the
    normed input, [u | z], u', [dt | B | C], rms(dt), dt, the gated scan
    output, the block's output) equals the reference's."""
    seed, cfg, params, toks, net, _, _ = seeded
    pc = port_cfg(cfg)
    plan = plan_lm(optimized_graph(pc), params)
    ctx = BK.lm_context(plan, params, pc)
    BK.embed_tokens(ctx, plan, toks)
    for t in plan.tasks:
        BK.get_task_impl("torch-int", t.kind, "mamba1")(t, ctx)
    emb = ref.draw(cfg, seed, -1, "embed", "cpu")
    h = ref.quant(emb[toks.long()], cfg["assumed"]["grids"]["h"])
    assert torch.equal(ctx.env["h0"].double(), h)
    for layer in range(cfg["num_hidden_layers"]):
        rec = {}
        h = ref._layer(net, ref.layer_weights(net, layer), h, cfg, rec)
        for name in ("x", "xz", "u", "dbc", "dn", "dt", "y"):
            assert torch.equal(ctx.env[f"l{layer}.{name}"].double(),
                               rec[name]), (layer, name)
        assert torch.equal(ctx.env[f"h{layer + 1}"].double(), h)


def test_cuda_on_cpu_is_bitwise_torch_int(seeded):
    _, cfg, params, toks, _, _, _ = seeded
    pc = port_cfg(cfg)
    assert torch.equal(lower_forward(pc, params, "cuda", device="cpu")(toks),
                       lower_forward(pc, params, "torch-int",
                                     device="cpu")(toks))


def _no_d(params):
    return dataclasses.replace(params, layers=tuple(
        dataclasses.replace(lp, D=torch.zeros_like(lp.D))
        for lp in params.layers))


def _full_rank_dt(monkeypatch, cfg, seed):
    """dt from a full-rank d -> d_inner product of the normed block input
    (the reduced block's), not dt_proj of the rms of x_proj's slice."""
    base = BK.get_task_impl("torch-int", "matmul")
    d, di = cfg["hidden_size"], cfg["intermediate_size"]
    gen = torch.Generator().manual_seed(seed)
    w = torch.randint(-127, 128, (d, di), generator=gen, dtype=torch.int8)

    def impl(t, ctx):
        if t.role != "wdt":
            return base(t, ctx)
        x = ctx.env[f"l{t.layer}.x"]
        acc = (x.double() @ w.double()).round().to(torch.int32)
        mp = ctx.params.matmul(t.layer, t.role)
        ctx.put(t.output, Q.requantize_shift(acc, ctx.specs[f"l{t.layer}.x"]
                                             .exp - 7, mp.y_spec), mp.y_spec)

    monkeypatch.setitem(BK._FAMILY_IMPLS, ("mamba1", "torch-int", "matmul"),
                        impl)


@pytest.mark.parametrize("fault", ["no_d", "no_conv", "no_dt_b_c_rms",
                                   "full_rank_dt", "bf16_interludes"])
def test_planted_fault_fails_the_comparison(seeded, fault, monkeypatch):
    seed, cfg, params, toks, net, h, logits = seeded
    if fault == "no_d":
        params = _no_d(params)
    elif fault == "no_conv":
        # a conv of width 1: the current position's tap alone
        monkeypatch.setattr(BK, "causal_conv_i32",
                            lambda x, w, b: x.to(torch.int32) * w[-1] + b)
    elif fault == "no_dt_b_c_rms":
        plain = BK.rms
        monkeypatch.setattr(
            BK, "rms", lambda x, eps: plain(x, eps)
            if x.shape[-1] == cfg["hidden_size"] else x)
    elif fault == "full_rank_dt":
        _full_rank_dt(monkeypatch, cfg, seed)
    if fault == "bf16_interludes":
        low = ref.prepare(dict(seed=seed, device="cpu"), cfg,
                          dtype=torch.bfloat16)
        out = ref.logits(low, toks)
    else:
        assert not agrees(cfg, params, toks, net, h, logits)
        out = lower_forward(port_cfg(cfg), params, "torch-int",
                            device="cpu")(toks).double()
    # and by far: past the benchmark's limit, not only the head's rounding
    assert float((out - logits).abs().max()) > cfg["limits"]["logit_gap"]


def test_w4_control_and_one_code_fail_the_limit(seeded):
    """The control of the benchmark's check (4-bit weights) and one step of
    one code of the last position's state each read a gap above the
    configuration's limit; the sound port reads under a hundredth of it."""
    seed, cfg, params, toks, net, h, logits = seeded
    limit = cfg["limits"]["logit_gap"]
    w4 = ref.prepare(dict(seed=seed, device="cpu"), cfg, cfg["control"])
    assert float((ref.logits(w4, toks) - logits).abs().max()) > limit
    bad = h.clone()
    bad[0, -1, 0] += 1 if bad[0, -1, 0] < 127 else -1
    assert float((ref.head(net, bad) - logits).abs().max()) > limit
    out = lower_forward(port_cfg(cfg), params, "cuda", device="cpu")(toks)
    assert float((out.double() - logits).abs().max()) < limit / 100


def test_add_fold_stays_exact(seeded):
    """wo's accumulator starts from the block input shifted onto its
    product grid: the same int32 as the product plus the shifted stream
    added after, and the shift is a left shift (nothing rounds)."""
    _, cfg, params, toks, _, _, _ = seeded
    pc = port_cfg(cfg)
    plan = plan_lm(optimized_graph(pc), params)
    ctx = BK.lm_context(plan, params, pc)
    BK.embed_tokens(ctx, plan, toks)
    wo = next(t for t in plan.tasks if t.kind == "matmul" and t.role == "wo")
    for t in plan.tasks:
        if t is wo:
            break
        BK.get_task_impl("torch-int", t.kind, "mamba1")(t, ctx)
    mp = params.matmul(0, "wo")
    shift = params.skip_exp(0, "wo") - mp.product_exp
    assert shift >= 0
    _, x2d, acc0, _ = BK._lm_matmul_prologue(wo, ctx)
    folded = x2d.to(torch.int64) @ mp.wq.to(torch.int64) + acc0
    skip = ctx.env[wo.skip].reshape(-1, pc.d_model).to(torch.int64)
    unfolded = x2d.to(torch.int64) @ mp.wq.to(torch.int64) + \
        skip * 2 ** shift
    assert torch.equal(folded, unfolded)
    assert int(folded.abs().max()) < 2 ** 31


def test_published_widths_plan_wgmma_matmuls_and_one_scan_a_layer():
    """At Falcon-Mamba-7B's widths and the cell's 4 x 512 tokens a layer
    plans four matmuls, every one on ``matmul_int8``'s wgmma path, two
    norms, one conv and one scan."""
    from repro_torch.kernels.matmul_int8.ops import matmul_path
    cfg = lm_config(get_config("falcon-mamba-7b"), 512, family="mamba1")
    plan = plan_lm(optimized_graph(cfg))
    L, M = cfg.num_layers, 4 * 512
    kinds = [t.kind for t in plan.tasks]
    assert (kinds.count("matmul"), kinds.count("scan"), kinds.count("norm"),
            kinds.count("conv1d")) == (4 * L, L, 2 * L, L)
    shapes = {(t.din, t.dout) for t in plan.tasks if t.kind == "matmul"}
    assert shapes == {(4096, 16384), (8192, 288), (256, 8192), (8192, 4096)}
    for din, dout in shapes:
        assert matmul_path(M, dout, din) == "wgmma", (din, dout)


@pytest.mark.cuda
def test_cuda_kernels_on_the_card_give_the_reference_codes():
    """On the card, the ``cuda`` lowering (``matmul_int8``,
    ``selective_scan`` and the interludes on the device) gives the
    reference's codes of the last block, and logits within the head's
    rounding, the reference computed on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from bench import weights
    dev = torch.device("cuda")
    seed, cfg, pc = SEEDS[1], bench_cfg(), port_cfg(bench_cfg())
    params = M.quantized_params(lm_params, cfg, seed, dev)
    toks = M.prompt_pool(cfg, dict(pool_images=4, seq_len=SEQ), seed, dev)
    net = ref.prepare(dict(seed=seed, device=str(dev)), cfg)
    with weights.exact_float():
        h = ref.features(net, toks)
        logits = ref.head(net, h)
        codes = lower_features(pc, params, "cuda", device=dev)(toks)
        out = lower_forward(pc, params, "cuda", device=dev)(toks).double()
        tol = head_tolerance(net, h)
    assert torch.equal(codes.double(), h)
    assert bool(((out - logits).abs() <= tol).all())


# -- serving, counters, spans ------------------------------------------------


def test_compile_model_counts_tasks_and_spans_the_lowering(seeded):
    _, cfg, params, toks, _, _, logits = seeded
    pc = port_cfg(cfg)
    with obs.instrumented() as ob:
        cm = compile_model(pc, params, backend="cuda", batch_sizes=(2, 4),
                           device="cpu")
        out = cm(toks)
        cm(toks[:1])
    plan = plan_lm(optimized_graph(pc), params)
    want = {}
    for t in plan.tasks:
        kernel = {"matmul": "matmul_int8", "scan": "selective_scan",
                  "conv1d": "causal_conv1d"}.get(t.kind, "torch")
        want[(t.kind, kernel)] = want.get((t.kind, kernel), 0) + 1
    L = pc.num_layers
    assert want == {("norm", "torch"): 2 * L, ("matmul", "matmul_int8"): 4 * L,
                    ("conv1d", "causal_conv1d"): L,
                    ("scan", "selective_scan"): L}
    assert cm.task_counts == want
    c = ob.metrics.get("model_task_launches_total")
    for (kind, kernel), n in want.items():
        assert c.value(kind=kind, kernel=kernel, bucket="4",
                       backend="cuda") == n
        assert c.value(kind=kind, kernel=kernel, bucket="2",
                       backend="cuda") == n
    spans = {e.name: e for e in ob.trace.events
             if e.track == "compile" and e.ph == "X"}
    low = spans["lower_lm"]
    assert low.args["family"] == "mamba1" and low.args["backend"] == "cuda"
    assert low.args["packed_bytes"] == sum(
        lp.win.wq.numel() + lp.wx.wq.numel() + lp.wdt.wq.numel() +
        lp.wo.wq.numel() for lp in params.layers)
    for child in ("plan", "pack"):
        e = spans[child]
        assert low.ts <= e.ts and e.ts + e.dur <= low.ts + low.dur
    assert float((out.double() - logits).abs().max()) < \
        cfg["limits"]["logit_gap"]


def test_engine_serves_mamba1_tokens(seeded):
    _, cfg, params, toks, _, _, logits = seeded
    eng = ResNetEngine(port_cfg(cfg), params, batch=4, batch_sizes=(1, 4),
                       ab_backends=("torch-int",), device="cpu")
    reqs = [ImageRequest(rid=i, image=t.numpy()) for i, t in enumerate(toks)]
    for r in reqs:
        eng.submit(r)
    assert eng.run() == 1 and eng.served == 4
    assert eng.ab_stats["torch-int"] == [0.0]
    np.testing.assert_array_equal(
        np.stack([r.logits for r in reqs]),
        lower_forward(port_cfg(cfg), params, "torch-int",
                      device="cpu")(toks).numpy())


# -- the benchmark's work counts ---------------------------------------------


def test_work_counts_of_the_published_widths():
    cfg = json.load(open(BENCH_CFG))
    d, di, R, N, L = 4096, 8192, 256, 16, 64
    per_layer = d * 2 * di + di * (R + 2 * N) + R * di + di * d
    assert lm_work.matmul_macs_per_token(cfg) == L * per_layer
    assert lm_work.conv_macs_per_token(cfg) == L * di * 4
    peak = dict(int8_ops_per_s=1.979e15, hbm_bytes_per_s=3.35e12)
    # at 2,048 tokens W_in and W_out are bound by operations, W_x and W_dt
    # by bytes
    t = 2048
    bound = lm_work.matmul_bound_s(cfg, t, peak)
    by_ops = 2 * t * L * (d * 2 * di + di * d) / peak["int8_ops_per_s"]
    by_bytes = L * (di * (R + 2 * N) + t * (di + R + 2 * N) +
                    R * di + 2 * di + t * (R + di)) / peak["hbm_bytes_per_s"]
    assert math.isclose(bound, by_ops + by_bytes, rel_tol=1e-12)
    assert lm_work.scan_bytes(cfg, 4, 512) == L * 4 * (
        3 * 4 * 512 * di + 2 * 4 * 512 * N + di * N + 2 * 4 * di * N)


@pytest.mark.parametrize("metric", ["lm_matmul_roofline", "lm_scan_roofline",
                                    "lm_step_mfu", "lm_glue_share"])
def test_metric_readers(metric):
    """Each reader returns None on a record without its trace or kernel
    (as a program without the cell's kernels leaves it) and a share on a
    traced one."""
    from bench import cells
    cfg = json.load(open(BENCH_CFG))
    mix = json.load(open(os.path.join(REPO, "bench", "traffic",
                                      "p4x512.json")))
    peak = dict(int8_ops_per_s=1.979e15, hbm_bytes_per_s=3.35e12)
    read = cells.reader(metric)
    assert read(dict(cfg=cfg, mix=mix, peak=peak, trace=None)) is None
    empty = dict(calls=16, images=64, busy_s=0.0, window_s=1.0,
                 device_s=dict(port=0.0, conv=0.0, harness=0.0, glue=0.0),
                 kernel_s={})
    assert read(dict(cfg=cfg, mix=mix, peak=peak, trace=empty)) is None
    tr = dict(empty, busy_s=2.0, device_s=dict(port=1.5, conv=0.0,
                                               harness=0.1, glue=0.4),
              kernel_s=dict(matmul_int8=1.2, selective_scan=0.3))
    v = read(dict(cfg=cfg, mix=mix, peak=peak, trace=tr))
    assert 0.0 < v < 100.0


def test_harness_check_and_controls_on_a_small_cell():
    """The benchmark's loop and check (``bench/run.py``) over the compiled
    port read a gap under the limit, and the controls of
    ``bench/control_lm.py`` (4-bit weights; bfloat16 interludes) above
    it, with every sampled slice checked."""
    from bench import cells, control_lm, run
    cell = cells.cell(cells.load_benchmark(), "falcon-mamba-7b.p4x512")
    cell = dataclasses.replace(
        cell, cfg=bench_cfg(), mix=dict(cell.mix, seq_len=SEQ,
                                        pool_images=16, warmup_calls=1))
    seed = 2 ** 33 + 9
    built = M.build(cell.cfg, cell.mix, seed, torch.device("cpu"),
                    lambda name: None)
    loop = run.Loop(built.model, built.pool, cell.mix, seed,
                    built.out_width)
    loop.run(calls=8)
    limit = cell.cfg["limits"]["logit_gap"]
    sound = run.check(loop, built.params, built.pool, cell.cfg)
    assert sound["slots_unchecked"] == 0 and sound["failed"] == 0
    assert sound["logit_gap"] < limit / 100
    for kw in (dict(), dict(interludes="bfloat16")):
        chk = control_lm.control_gap(cell, seed, torch.device("cpu"), **kw)
        assert chk["slots_unchecked"] == 0 and chk["checked"] == 4
        assert chk["logit_gap"] > limit and chk["failed"] > 0
