"""The port's LM compile path against the JAX package's, on the CPU, at the
smoke widths of gemma-2b (transformer) and falcon-mamba-7b (Mamba1).

The same parameters (drawn by the JAX package, carried across as numpy
arrays by ``lm_params_from_numpy``) go through both.  Held:

  * the optimized graphs and ``plan_lm``'s task programs, task for task,
    and the lowering's error texts;
  * every task of the port's ``torch-int`` on the inputs the JAX
    ``lax-int`` program gave that task: matmuls bitwise (int8 output),
    attention and scan outputs within one int8 grid step;
  * logits of the whole forward within the tolerance derived in
    ``lm_params.logit_tolerance`` (the final hidden states' difference
    carried through the unembed, plus float32 rounding), with equal argmax;
  * ``cuda`` on ``device="cpu"`` bitwise equal to ``torch-int``;
  * serving token requests through ``ResNetEngine``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import backends as JB
from repro.compile import lm_params as JLP
from repro.compile import lowering as JL
from repro.configs.base import get_smoke_config as j_smoke
from repro_torch.compile import (LoweringError, QLMParams, compile_model,
                                 get_task_impl, hidden_out_spec,
                                 init_lm_params, lm_config, lm_features,
                                 lm_params_from_numpy, lower_features,
                                 lower_forward, lower_lm, plan_lm)
from repro_torch.compile import backends as BK
from repro_torch.compile import lowering
from repro_torch.compile.lm_params import logit_tolerance
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import graph as G
from repro_torch.serve import ImageRequest, ResNetEngine

SEQ = 16
FAMILIES = ["gemma-2b", "falcon-mamba-7b"]


def jax_lm_to_numpy(jp) -> dict:
    """A JAX ``QLMParams`` in the port's ``to_dict`` layout, numpy arrays."""
    def mm(m):
        return dict(wq=np.asarray(m.wq), bq=np.asarray(m.bq),
                    w_spec=m.w_spec, x_spec=m.x_spec, y_spec=m.y_spec)

    layers = []
    for lp in jp.layers:
        d = {f.name: mm(getattr(lp, f.name)) for f in dataclasses.fields(lp)
             if f.name != "A"}
        if isinstance(lp, JLP.QSSMLayerParams):
            d["A"] = np.asarray(lp.A)
        layers.append(d)
    return dict(embed=np.asarray(jp.embed), unembed=np.asarray(jp.unembed),
                emb_spec=jp.emb_spec, layers=layers)


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    name = request.param
    jcfg = JLP.lm_config(j_smoke(name), seq_len=SEQ)
    jp = JLP.init_lm_params(jcfg, seed=3)
    cfg = lm_config(get_smoke_config(name), seq_len=SEQ)
    return name, jcfg, jp, cfg, lm_params_from_numpy(jax_lm_to_numpy(jp))


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, cfg.seq_len)).astype(np.int32)


# -- configs, params, bridge ------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_configs_and_lm_config_match_jax(name):
    from repro.configs.base import get_config as j_get
    for mine, theirs in ((get_config(name), j_get(name)),
                         (get_smoke_config(name), j_smoke(name))):
        assert dataclasses.asdict(lm_config(mine, 512)) == \
            dataclasses.asdict(JLP.lm_config(theirs, 512))


def test_lm_config_rejects_other_families():
    cfg = get_smoke_config("gemma-2b").with_(family="moe")
    with pytest.raises(ValueError, match="no LM lowering"):
        lm_config(cfg, 8)


def _numpy(d):
    """The port's ``to_dict`` layout with every tensor as a numpy array."""
    if isinstance(d, dict):
        return {k: _numpy(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_numpy(v) for v in d]
    return d.numpy() if torch.is_tensor(d) else d


def test_lm_params_bridge_round_trips(setup):
    _, _, jp, _, params = setup
    d = jax_lm_to_numpy(jp)
    again = lm_params_from_numpy(_numpy(params.to_dict()))
    for mine in (params, again):
        np.testing.assert_array_equal(mine.embed.numpy(), d["embed"])
        np.testing.assert_array_equal(mine.unembed.numpy(), d["unembed"])
        assert mine.emb_spec.exp == jp.emb_spec.exp
        for lp, jl in zip(mine.layers, d["layers"]):
            for role, m in jl.items():
                if role == "A":
                    np.testing.assert_array_equal(lp.A.numpy(), m)
                    continue
                got = getattr(lp, role)
                assert got.wq.dtype == torch.int8
                np.testing.assert_array_equal(got.wq.numpy(), m["wq"])
                np.testing.assert_array_equal(got.bq.numpy(), m["bq"])
                assert (got.w_spec.exp, got.x_spec.exp, got.y_spec.exp) == \
                    (m["w_spec"].exp, m["x_spec"].exp, m["y_spec"].exp)


@pytest.mark.parametrize("name", FAMILIES)
def test_init_lm_params_follows_the_recipe(name):
    """Seeded, deterministic, every weight grid ``ceil(log2(amax/127))``
    of its own matrix (so the largest weight lands on +-127 or close), the
    skip alignment and output grids as the JAX package's."""
    cfg = lm_config(get_smoke_config(name), seq_len=SEQ)
    p = init_lm_params(cfg, seed=7)
    q = init_lm_params(cfg, seed=7)
    assert len(p.layers) == cfg.num_layers
    assert torch.equal(p.embed, q.embed) and p.embed.dtype == torch.float32
    assert p.unembed.shape == (cfg.d_model, cfg.vocab_size)
    for lp, lq in zip(p.layers, q.layers):
        for role in lp.ROLES:
            m = getattr(lp, role)
            assert torch.equal(m.wq, getattr(lq, role).wq)
            assert m.wq.dtype == torch.int8 and m.bq.dtype == torch.int32
            assert 64 <= int(m.wq.to(torch.int32).abs().max()) <= 128
            assert m.x_spec == m.y_spec == p.emb_spec
        if hasattr(lp, "A"):
            assert lp.A.shape == (cfg.d_inner, cfg.ssm_state)
            assert float(lp.A.max()) <= -0.5 and float(lp.A.min()) >= -1.5
    assert not torch.equal(init_lm_params(cfg, seed=8).embed, p.embed)


# -- graphs and plans -------------------------------------------------------


def test_optimized_lm_graph_matches_jax(setup):
    _, jcfg, _, cfg, _ = setup
    mine, theirs = lowering.optimized_graph(cfg), JL.optimized_graph(jcfg)
    assert [(n.name, n.op, n.inputs, n.outputs, n.attrs, n.fused, n.skip_in)
            for n in mine.nodes] == \
        [(n.name, n.op, n.inputs, n.outputs, n.attrs, n.fused, n.skip_in)
         for n in theirs.nodes]


def _fields(t):
    return {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}


def test_plan_lm_matches_jax_task_for_task(setup):
    _, jcfg, jp, cfg, params = setup
    mine = plan_lm(lowering.optimized_graph(cfg), params)
    theirs = JL.plan_lm(JL.optimized_graph(jcfg), jp)
    assert [t.kind for t in mine.tasks] == [t.kind for t in theirs.tasks]
    assert [_fields(t) for t in mine.tasks] == \
        [_fields(t) for t in theirs.tasks]
    assert (mine.embed, mine.logits_in, mine.vocab, mine.seq_len) == \
        (theirs.embed, theirs.logits_in, theirs.vocab, theirs.seq_len)


def test_plan_lm_task_order_kinds_and_folds():
    """As tests/test_lowering_generic.py pins it: per transformer layer
    q/k/v -> attention -> wo -> up -> down, per SSM layer the five
    projections -> scan -> wo; residual folds on wo/down, ReLU on up."""
    cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=SEQ)
    plan = plan_lm(lowering.optimized_graph(cfg), init_lm_params(cfg, 3))
    l0 = [t for t in plan.tasks if t.layer == 0]
    assert [t.kind for t in l0] == ["matmul"] * 3 + ["attention"] + \
        ["matmul"] * 3
    by_role = {getattr(t, "role", "attn"): t for t in l0}
    assert by_role["wo"].skip is not None
    assert by_role["down"].skip is not None
    assert by_role["up"].fused_relu
    cfg = lm_config(get_smoke_config("falcon-mamba-7b"), seq_len=SEQ)
    plan = plan_lm(lowering.optimized_graph(cfg), init_lm_params(cfg, 3))
    l0 = [t for t in plan.tasks if t.layer == 0]
    assert [t.kind for t in l0] == ["matmul"] * 5 + ["scan", "matmul"]
    assert l0[-1].skip is not None and l0[5].gated


def _error(fn):
    # each package raises its own LoweringError, a ValueError
    with pytest.raises((ValueError, KeyError)) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("breakage", ["unoptimized", "no_role", "attn_arity",
                                      "mystery_kind", "no_embed"])
def test_plan_lm_errors_match_jax(breakage):
    """The strict walk's messages name the node, its kind and the check,
    word for word as the JAX package's."""
    def graphs():
        jcfg = JLP.lm_config(j_smoke("gemma-2b"), seq_len=SEQ)
        cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=SEQ)
        if breakage == "unoptimized":
            return JL.model_graph(jcfg), lowering.model_graph(cfg)
        return JL.optimized_graph(jcfg), lowering.optimized_graph(cfg)

    msgs = []
    for g, plan in zip(graphs(), (JL.plan_lm, plan_lm)):
        if breakage == "no_role":
            next(n for n in g.nodes if n.op == "matmul").attrs.pop("role")
        elif breakage == "attn_arity":
            att = next(n for n in g.nodes if n.op == "attention")
            att.inputs = att.inputs[:2]
        elif breakage == "mystery_kind":
            n = g.nodes[3]
            n.op = "mystery-op"
        elif breakage == "no_embed":
            g.nodes = [n for n in g.nodes if n.op != "embed"]
        msgs.append(_error(lambda: plan(g)))
    assert msgs[0] == msgs[1]
    assert msgs[1]


def test_plan_lm_cross_checks_params():
    tf = lm_config(get_smoke_config("gemma-2b"), seq_len=SEQ)
    ssm = lm_config(get_smoke_config("falcon-mamba-7b"), seq_len=SEQ)
    with pytest.raises((LoweringError, KeyError)):
        plan_lm(lowering.optimized_graph(tf), init_lm_params(ssm, 3))
    short = init_lm_params(dataclasses.replace(tf, num_layers=1), 3)
    with pytest.raises(LoweringError, match="layers"):
        plan_lm(lowering.optimized_graph(tf), short)


def test_task_impl_registry_unknown_kind():
    msgs = []
    for get in (JB.get_task_impl, get_task_impl):
        with pytest.raises(ValueError, match="no impl") as exc:
            get("cuda" if get is get_task_impl else "pallas", "mystery-kind")
        msgs.append(str(exc.value))
    assert "'mystery-kind'" in msgs[1] and "matmul" in msgs[1]
    assert sorted(k for b, k in BK._TASK_IMPLS if b == "cuda") == \
        ["attention", "matmul", "scan"]
    assert sorted(k for b, k in BK._TASK_IMPLS if b == "torch-int") == \
        ["attention", "matmul", "scan"]


def test_lm_graph_shuffled_lowers_to_identical_logits(setup):
    _, _, _, cfg, params = setup
    g = lowering.optimized_graph(cfg)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(_tokens(cfg, 2))
    ref = lower_lm("torch-int", g, cfg, params)(toks)
    perm = list(g.nodes)
    rng.shuffle(perm)
    out = lower_lm("torch-int", G.Graph(perm), cfg, params)(toks)
    assert torch.equal(out, ref)


# -- the task program against lax-int ---------------------------------------


def _jax_program(jcfg, jp, toks):
    """Run JAX lax-int task by task; yield (task, its JAX context) after
    each task, so the port can replay the task on the same inputs."""
    plan = JL.plan_lm(JL.optimized_graph(jcfg), jp)
    consumer = {t.inputs[0]: jp.matmul(t.layer, t.role).x_spec
                for t in plan.tasks if isinstance(t, JL.MatmulTask)}
    ctx = JB._LMContext(jp, jcfg, consumer)
    from repro.core import quant as JQ
    emb = jnp.take(jp.embed, jnp.asarray(toks), axis=0)
    ctx.put(plan.embed, JQ.quantize(emb, jp.emb_spec), jp.emb_spec)
    for t in plan.tasks:
        before = dict(ctx.env), dict(ctx.specs)
        JB.get_task_impl("lax-int", t.kind)(t, ctx)
        yield t, before, ctx


def test_every_task_matches_lax_int_on_the_same_inputs(setup):
    """Each task of the port's torch-int, given the inputs the JAX lax-int
    program gave it: matmuls bitwise, float interludes within one int8
    step (the float32 sums may run in another order)."""
    _, jcfg, jp, cfg, params = setup
    plan = plan_lm(lowering.optimized_graph(cfg), params)
    by_node = {t.node: t for t in plan.tasks}
    kinds = set()
    for jt, (env, specs), jctx in _jax_program(jcfg, jp, _tokens(cfg, 2)):
        t = by_node[jt.node]
        ctx = BK.lm_context(plan, params, cfg)
        ctx.env = {k: torch.from_numpy(np.array(v)) for k, v in env.items()}
        ctx.specs = dict(specs)
        get_task_impl("torch-int", t.kind)(t, ctx)
        got = ctx.env[t.output].numpy()
        want = np.asarray(jctx.env[t.output])
        assert got.dtype == want.dtype == np.int8, t.node
        if t.kind == "matmul":
            np.testing.assert_array_equal(got, want, err_msg=t.node)
        else:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert ctx.specs[t.output].exp == jctx.specs[t.output].exp
        kinds.add(t.kind)
    assert kinds in ({"matmul", "attention"}, {"matmul", "scan"})


def test_logits_match_lax_int_within_the_derived_tolerance(setup):
    _, jcfg, jp, cfg, params = setup
    toks = _tokens(cfg, 3, seed=4)
    want = np.asarray(JB.lower_lm("lax-int", JL.optimized_graph(jcfg), jcfg,
                                  jp)(jnp.asarray(toks)))
    g = lowering.optimized_graph(cfg)
    got = lower_lm("torch-int", g, cfg, params)(torch.from_numpy(toks))
    assert got.shape == (3, cfg.vocab_size) and got.dtype == torch.float32
    # the JAX final hidden state, from its program
    *_, (_, _, jctx) = _jax_program(jcfg, jp, toks)
    jh = torch.from_numpy(np.array(jctx.env[
        JL.plan_lm(JL.optimized_graph(jcfg), jp).logits_in]))
    h = lm_features("torch-int", g, cfg, params)(torch.from_numpy(toks))
    tol = logit_tolerance(h, jh, hidden_out_spec(params), params.unembed)
    diff = (got.double() - torch.from_numpy(np.array(want)).double()).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_logit_tolerance_is_the_hidden_difference_through_the_unembed():
    """Equal hidden states leave only float32 rounding (gamma_{d+1} of the
    absolute product); one differing element adds its step count times
    2^exp times |U| of its row."""
    cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=4)
    p = init_lm_params(cfg, seed=1)
    spec = hidden_out_spec(p)
    h = torch.randint(-128, 128, (2, 4, cfg.d_model), dtype=torch.int8)
    base = logit_tolerance(h, h, spec, p.unembed)
    u = 2.0 ** -24
    n = cfg.d_model + 1
    gamma = n * u / (1 - n * u)
    absprod = (h[:, -1].double().abs() * spec.scale) @ \
        p.unembed.double().abs()
    torch.testing.assert_close(base, 2 * gamma * absprod)
    h2 = h.clone()
    old = int(h[1, -1, 5])
    new = old + (3 if old < 100 else -3)
    h2[1, -1, 5] = new
    extra = logit_tolerance(h, h2, spec, p.unembed) - base
    assert torch.all(extra[0] == 0)
    torch.testing.assert_close(
        extra[1], (3 + gamma * (abs(new) - abs(old))) * spec.scale *
        p.unembed[5].double().abs(), rtol=1e-9, atol=1e-15)


# -- backends on the CPU ----------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_kernel_backends_on_cpu_equal_torch_int(setup, backend):
    """On CPU tensors the kernel backends run the plain versions: bitwise
    the same hidden state and logits as torch-int."""
    _, _, _, cfg, params = setup
    toks = _tokens(cfg, 2, seed=2)
    h = lower_features(cfg, params, backend, device="cpu")(toks)
    ref = lower_features(cfg, params, "torch-int", device="cpu")(toks)
    assert h.dtype == torch.int8 and h.shape == (2, SEQ, cfg.d_model)
    assert torch.equal(h, ref)
    assert torch.equal(lower_forward(cfg, params, backend, device="cpu")(toks),
                       lower_forward(cfg, params, "torch-int",
                                     device="cpu")(toks))


def test_compile_model_serves_token_buckets(setup):
    _, _, _, cfg, params = setup
    cm = compile_model(cfg, params, backend="cuda", batch_sizes=(1, 4),
                       device="cpu").warmup()
    # warmup builds every bucket once and runs none
    assert cm.run_counts == {1: 0, 4: 0}
    assert cm.trace_counts == {1: 1, 4: 1} and cm.compile_count == 2
    toks = _tokens(cfg, 6, seed=5)
    out = cm(toks)                      # 4, then 2 padded to 4
    assert out.shape == (6, cfg.vocab_size)
    assert cm.run_counts == {1: 0, 4: 2}
    assert cm.trace_counts == {1: 1, 4: 1} and cm.compile_count == 2
    padded = torch.cat([torch.from_numpy(toks[4:]),
                        torch.zeros((2, SEQ), dtype=torch.int32)])
    fwd = lower_forward(cfg, params, "cuda", device="cpu")
    assert torch.equal(out[4:], fwd(padded)[:2])
    assert torch.equal(out[:4], fwd(toks[:4]))
    # the search modes cover conv configs only (an explicit dict is taken)
    with pytest.raises(ValueError, match="tune"):
        compile_model(cfg, params, tune="auto", device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        cm(np.full((1, SEQ), cfg.vocab_size, np.int32))
    with pytest.raises(ValueError, match="token ids"):
        cm(np.zeros((1, SEQ), np.float32))


@pytest.mark.parametrize("name,key", [("gemma-2b", "layer0/wq"),
                                      ("gemma-2b", "layer0/attn"),
                                      ("falcon-mamba-7b", "layer0/scan")])
def test_cuda_lm_impls_hand_their_task_config_to_the_kernel(name, key,
                                                            monkeypatch):
    """A tuned LM task's config reaches its kernel wrapper: the ``cuda``
    impls pass ``config=t.config``, so a config the kernel cannot apply is
    refused by name on the first forward instead of served with the
    default tiles, and a legal one is served.  ``torch-int`` reads the
    same config: it refuses the illegal one, and its attention walks the
    config's tiles (``attn_tiles``, as the reference's lax-int)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.tune.config import KernelConfig

    cfg = lm_config(get_smoke_config(name), seq_len=8)
    params = init_lm_params(cfg, seed=0, device="cpu")
    toks = np.zeros((1, 8), np.int32)
    illegal = {key: KernelConfig(bm=64, bn=64, bk=64)}
    refused = {"layer0/wq": "bm=64", "layer0/attn": "bn=64",
               "layer0/scan": "bm=64"}[key]
    for backend in ("cuda", "torch-int"):
        cm = compile_model(cfg, params, backend=backend, batch_sizes=(1,),
                           device="cpu", tune=illegal)
        assert cm.tuning == illegal
        with pytest.raises(ValueError, match=refused):
            cm(toks)
    legal = {"layer0/wq": KernelConfig(bn=16, split=1),
             "layer0/attn": KernelConfig(bm=2),
             "layer0/scan": KernelConfig(cout_block=16, lanes=2)}[key]
    walked = []
    plain = fref.flash_attention_plain
    def spy(*a, **kw):
        walked.append(kw["bq"])
        return plain(*a, **kw)

    monkeypatch.setattr(fref, "flash_attention_plain", spy)
    monkeypatch.setattr(fops, "flash_attention_plain", spy)
    out = {b: compile_model(cfg, params, backend=b, batch_sizes=(1,),
                            device="cpu", tune={key: legal})(toks)
           for b in ("cuda", "torch-int")}
    assert out["cuda"].shape == (1, cfg.vocab_size)
    assert torch.equal(out["cuda"], out["torch-int"])
    if key == "layer0/attn":
        # both backends walk bq = bm = 2 on layer 0, and the rule's
        # positions for the smoke config's kv group on layer 1
        rule = fops.attn_tiles(8, 8, cfg.num_heads // cfg.num_kv_heads)[0]
        assert rule != 2 and walked == [2, rule] * 2


def test_params_move_between_devices_as_one():
    cfg = lm_config(get_smoke_config("falcon-mamba-7b"), seq_len=SEQ)
    p = init_lm_params(cfg, seed=2)
    q = p.to("cpu")
    assert isinstance(q, QLMParams) and q.emb_spec == p.emb_spec
    assert torch.equal(q.layers[1].A, p.layers[1].A)
    assert torch.equal(q.layers[0].wb.wq, p.layers[0].wb.wq)


def test_engine_serves_tokens_against_torch_int_shadow(setup):
    _, _, _, cfg, params = setup
    eng = ResNetEngine(cfg, params, batch=4, batch_sizes=(1, 4),
                       ab_backends=("torch-int",), device="cpu")
    toks = _tokens(cfg, 6, seed=6)
    reqs = [ImageRequest(rid=i, image=t) for i, t in enumerate(toks)]
    for r in reqs:
        eng.submit(r)
    assert eng.run() == 2 and eng.served == 6
    assert eng.ab_stats["torch-int"] == [0.0, 0.0]
    assert eng.model.run_counts == {1: 0, 4: 2}
    ref = lower_forward(cfg, params, "torch-int", device="cpu")(toks).numpy()
    for r in reqs:
        assert r.done and r.logits.shape == (cfg.vocab_size,)
        assert r.label == int(np.argmax(r.logits))
    # the padded tick's rows are the requests' own, the pad rows dropped
    np.testing.assert_allclose(np.stack([r.logits for r in reqs]), ref,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="payload shape"):
        eng.submit(ImageRequest(rid=9, image=np.zeros(SEQ + 1, np.int32)))


def test_engine_lm_results_match_the_jax_engine(setup):
    from repro.serve.engine import ImageRequest as JReq
    from repro.serve.engine import ResNetEngine as JEngine

    _, jcfg, jp, cfg, params = setup
    toks = _tokens(cfg, 5, seed=8)
    eng = ResNetEngine(cfg, params, batch=4, batch_sizes=(1, 4),
                       device="cpu")
    jeng = JEngine(jcfg, jp, batch=4, batch_sizes=(1, 4), backend="lax-int")
    mine = [ImageRequest(rid=i, image=t) for i, t in enumerate(toks)]
    theirs = [JReq(rid=i, image=t) for i, t in enumerate(toks)]
    for r in mine:
        eng.submit(r)
    for r in theirs:
        jeng.submit(r)
    eng.run()
    jeng.run()
    # the logits themselves are held in
    # test_logits_match_lax_int_within_the_derived_tolerance
    assert [r.label for r in mine] == [r.label for r in theirs]
    assert all(r.logits.shape == (cfg.vocab_size,) for r in mine)
