"""The LM kernels' knobs and tuning spaces in the port, on the CPU, against
the JAX package where it has a counterpart.

  * each LM wrapper's one legality check (``matmul_knobs``, ``attn_knobs``,
    ``scan_knobs``): legal configs accepted, illegal ones and knobs a
    kernel does not have refused by name, the same check on a CPU tensor
    before the plain version, the rule untouched by an all-zero config;
  * ``tune.space.lm_model_space``: the key set of the reference's
    ``repro.tune.space.lm_model_space`` on the smoke and published
    configs, every config legal by the wrapper's own check;
  * under the port's ``lm_tuned_variant``, ``cuda`` on the CPU bitwise
    ``torch-int`` (the reference's ``test_lm_pallas_bit_exact_with_lax_int
    [tuned]``), every matmul task bitwise and the logits within
    ``logit_tolerance`` of the JAX ``lax-int`` under the same tuning;
  * the plain versions at the tuned tiles against ``flash_attention_mirror``
    and ``selective_scan_ref`` of the JAX package (the JAX Pallas LM kernels
    do not run on this jax, which has no ``pallas.load``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _jax_program, jax_lm_to_numpy

from repro.compile import backends as JB
from repro.compile import lm_params as JLP
from repro.compile import lowering as JL
from repro.configs.base import get_config as j_get
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels.flash_attention.ref import \
    flash_attention_mirror as j_mirror
from repro.kernels.selective_scan.ref import selective_scan_ref as j_scan_ref
from repro.tune import space as JS
from repro_torch.compile import (compile_model, hidden_out_spec,
                                 lm_config, lm_features,
                                 lm_params_from_numpy, lower_lm, lowering,
                                 plan_lm)
from repro_torch.compile import backends as BK
from repro_torch.compile.lm_params import logit_tolerance
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.matmul_int8 import ops as mops
from repro_torch.kernels.selective_scan import ops as sops
from repro_torch.tune import space as S
from repro_torch.tune.config import DEFAULT, KernelConfig

SEQ = 16
FAMILIES = ["gemma-2b", "falcon-mamba-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# knob legality
# ---------------------------------------------------------------------------

# gemma-2b's projections at bucket 4 x 512 (M = 2048) and falcon-mamba-7b's
# B/C projection, as (M, K, N)
WQ, WKV, WBC = (2048, 2048, 2048), (2048, 2048, 256), (2048, 4096, 16)


@pytest.mark.parametrize("shape,config,want", [
    (WQ, None, (256, 1)),
    (WQ, DEFAULT, (256, 1)),
    (WKV, KernelConfig(), (32, 1)),
    (WBC, None, (16, 4)),
    (WQ, KernelConfig(bn=64), (64, 1)),
    (WQ, KernelConfig(bn=16), (16, 1)),
    ((512, 2048, 256), KernelConfig(bn=256), (256, 8)),  # rule's split at bn
    (WQ, KernelConfig(split=8), (256, 8)),
    (WQ, KernelConfig(bm=128, bn=128, bk=128, split=2), (128, 2)),
    (WBC, KernelConfig(split=16), (16, 16)),
    (WKV, KernelConfig(bn=256, split=4), (256, 4)),
])
def test_matmul_knobs_resolve_legal_configs(shape, config, want):
    M, K, N = shape
    assert mops.matmul_knobs(M, N, K, config) == want
    if config is None or not config.to_dict():
        assert want == mops.matmul_tiles(M, N, K)[1::2]


@pytest.mark.parametrize("shape,config,match", [
    (WQ, KernelConfig(bm=64), "bm=64"),
    (WQ, KernelConfig(bk=64), "bk=64"),
    (WQ, KernelConfig(bn=48), "bn=48"),
    (WQ, KernelConfig(bn=512), "bn=512"),
    (WBC, KernelConfig(bn=32), "bn=32"),         # wider than N needs
    (WQ, KernelConfig(split=3), "split=3"),
    (WQ, KernelConfig(split=16), "split=16"),    # one K tile a split
    (WBC, KernelConfig(split=32), "split=32"),
    (WQ, KernelConfig(cout_block=16), "cout_block=16"),
    (WQ, KernelConfig(lanes=2), "lanes=2"),
    (WQ, KernelConfig(band_rows=4), "band_rows=4"),
    (WQ, KernelConfig(batch_tile=2), "batch_tile=2"),
    ((77, 30, 18), KernelConfig(bn=16), "mma_sync"),
])
def test_matmul_knobs_refuse_by_name(shape, config, match):
    M, K, N = shape
    with pytest.raises(ValueError, match=match):
        mops.matmul_knobs(M, N, K, config)
    # the wrapper runs the same check on a CPU tensor, before the plain
    # version, and counts nothing
    a = torch.zeros((M, K), dtype=torch.int8)
    b = torch.zeros((K, N), dtype=torch.int8)
    n = mops.matmul_int8_op.launches
    with pytest.raises(ValueError, match=match):
        mops.matmul_int8_op(a, b, config=config)
    assert mops.matmul_int8_op.launches == n


def test_matmul_legal_widths_and_splits():
    assert mops.tile_widths(2048) == (16, 32, 64, 128, 256)
    assert mops.tile_widths(200) == (16, 32, 64, 128, 256)
    assert mops.tile_widths(100) == (16, 32, 64, 128)
    assert mops.tile_widths(16) == (16,)
    assert mops.k_splits(2048) == (1, 2, 4, 8)
    assert mops.k_splits(16384) == (1, 2, 4, 8, 16, 32, 64)
    assert mops.k_splits(128) == (1,)
    assert mops.k_splits(384) == (1,)          # 3 K tiles: no power splits
    # the rule never leaves its own legal set
    for M, K, N in (WQ, WKV, WBC, (512, 16384, 2048), (2048, 8192, 4096)):
        _, bn, _, split = mops.matmul_tiles(M, N, K)
        assert bn in mops.tile_widths(N) and split in mops.k_splits(K)


@pytest.mark.parametrize("group,config,want", [
    (8, None, (8, 8)),
    (8, KernelConfig(bm=64), (1, 64)),
    (8, KernelConfig(bm=16, bk=64), (4, 16)),
    (8, KernelConfig(bm=2), (8, 2)),             # 16 of the 64 rows used
    (1, None, (1, 64)),
    (1, KernelConfig(bm=8), (1, 8)),
    (4, KernelConfig(bm=21), (3, 21)),
])
def test_attn_knobs_resolve_legal_configs(group, config, want):
    assert fops.attn_knobs(group, config) == want
    gh, pos = want
    assert gh * pos <= fops.BQ and gh <= group
    assert fops.attn_tiles(512, 512, group, config) == (pos, fops.BK)
    assert fops.attn_tiles(5, 40, group, config) == (min(pos, 5), 40)


@pytest.mark.parametrize("config,match", [
    (KernelConfig(bm=0, bk=32), "bk=32"),
    (KernelConfig(bm=65), "bm=65"),
    (KernelConfig(bn=64), "bn=64"),
    (KernelConfig(split=2), "split=2"),
    (KernelConfig(cout_block=16), "cout_block=16"),
    (KernelConfig(lanes=4), "lanes=4"),
])
def test_attn_knobs_refuse_by_name(config, match):
    with pytest.raises(ValueError, match=match):
        fops.attn_knobs(8, config)
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 4, 1, 16))
    n = fops.flash_attention_op.launches
    with pytest.raises(ValueError, match=match):
        fops.flash_attention_op(q, k, k, config=config)
    assert fops.flash_attention_op.launches == n


@pytest.mark.parametrize("config,want", [
    (None, (32, 4)), (DEFAULT, (32, 4)),
    (KernelConfig(cout_block=16), (16, 4)),
    (KernelConfig(lanes=8), (32, 8)),
    (KernelConfig(cout_block=64, lanes=2), (64, 2)),
    (KernelConfig(cout_block=64, lanes=4), (64, 4)),
])
def test_scan_knobs_resolve_legal_configs(config, want):
    assert sops.scan_knobs(config) == want
    assert sops.scan_smem_bytes(*want) <= sops.STATIC_SMEM


@pytest.mark.parametrize("config,match", [
    (KernelConfig(cout_block=128), "cout_block=128"),
    (KernelConfig(cout_block=24), "cout_block=24"),
    (KernelConfig(lanes=16), "lanes=16"),
    (KernelConfig(lanes=3), "lanes=3"),
    (KernelConfig(cout_block=64, lanes=8), "lanes=8"),   # over 48 KB
    (KernelConfig(bm=8), "bm=8"),
    (KernelConfig(bn=16), "bn=16"),
    (KernelConfig(split=2), "split=2"),
])
def test_scan_knobs_refuse_by_name(config, match):
    with pytest.raises(ValueError, match=match):
        sops.scan_knobs(config)
    z = torch.zeros
    n = sops.selective_scan_op.launches
    with pytest.raises(ValueError, match=match):
        sops.selective_scan_op(z(1, 4, 8), z(1, 4, 8), z(8, 4), z(1, 4, 4),
                               z(1, 4, 4), z(1, 8, 4), config=config)
    assert sops.selective_scan_op.launches == n


def test_scan_instances_and_their_shared_memory():
    """channels {16, 32, 64} x lanes {2, 4, 8}, but (64, 8): 57,472 bytes
    of static shared memory over the 48 KB limit; the rule's instance
    takes 22,592."""
    assert sops.SHAPES == ((16, 2), (16, 4), (16, 8), (32, 2), (32, 4),
                           (32, 8), (64, 2), (64, 4))
    assert sops.scan_smem_bytes(64, 8) == 57472
    assert sops.scan_smem_bytes(32, 4) == 22592
    assert sops.scan_threads(4, 8192) == 131072
    assert sops.scan_threads(4, 8192, 16, 2) == 65536


# ---------------------------------------------------------------------------
# the spaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("smoke", [True, False])
def test_lm_model_space_keys_equal_the_reference_and_every_config_is_legal(
        name, smoke):
    seq = SEQ if smoke else 512
    cfg = lm_config((get_smoke_config if smoke else get_config)(name),
                    seq_len=seq)
    jcfg = JLP.lm_config((j_smoke if smoke else j_get)(name), seq_len=seq)
    spaces = S.lm_model_space(cfg, 4)
    jspaces = JS.lm_model_space(jcfg, 4) if smoke else None
    keys = [lowering.tuning_key(n) for n in lowering.optimized_graph(
        cfg).nodes]
    assert sorted(spaces) == sorted(k for k in keys if k)
    if jspaces is not None:
        assert list(spaces) == list(jspaces)
    else:
        assert sorted(spaces) == sorted(
            k for k in (JL.tuning_key(n) for n in
                        JL.optimized_graph(jcfg).nodes) if k)
    for key, space in spaces.items():
        for c in space:
            S.lm_task_knobs(cfg, 4, key, c)          # raises if illegal
        assert len(set(space)) == len(space), key
    assert S.space_size(spaces) > 1


def test_space_of_each_kind_on_published_shapes():
    cfg = lm_config(get_config("gemma-2b"), seq_len=512)
    sp = S.lm_model_space(cfg, 4)
    assert sp["layer0/wq"][:2] == [KernelConfig(bn=256, split=1),
                                   KernelConfig(bn=256, split=2)]
    assert len(sp["layer0/wq"]) == 5 * 4 and len(sp["layer0/down"]) == 5 * 7
    assert [c.bm for c in sp["layer0/attn"]] == [64, 32, 16, 8, 4, 2, 1]
    falcon = lm_config(get_config("falcon-mamba-7b"), seq_len=512)
    sp = S.lm_model_space(falcon, 4)
    assert sp["layer3/wb"] == [KernelConfig(bn=16, split=s)
                               for s in (1, 2, 4, 8, 16)]
    assert [(c.cout_block, c.lanes) for c in sp["layer3/scan"]] == \
        list(sops.SHAPES)
    # no knobs where the kernel has none
    assert S.matmul_space(77, 30, 18) == []
    assert S.attention_space(64, 64, 72) == []
    assert S.scan_space(64, 64, 32) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_tuned_variant_is_legal_and_off_the_rule(name):
    for cfg in (lm_config(get_smoke_config(name), seq_len=SEQ),
                lm_config(get_config(name), seq_len=512)):
        tv = S.lm_tuned_variant(cfg, 4)
        spaces = S.lm_model_space(cfg, 4)
        assert tv and set(tv) <= set(spaces)
        for key, c in tv.items():
            assert c in spaces[key]
            assert S.lm_task_knobs(cfg, 4, key, c) != \
                S.lm_task_knobs(cfg, 4, key, None), key
            first = next(x for x in spaces[key] if S.lm_task_knobs(
                cfg, 4, key, x) != S.lm_task_knobs(cfg, 4, key, None))
            assert c == first
        # a task is left out only where its space holds the rule alone
        for key in set(spaces) - set(tv):
            assert all(S.lm_task_knobs(cfg, 4, key, x) ==
                       S.lm_task_knobs(cfg, 4, key, None)
                       for x in spaces[key]), key


# ---------------------------------------------------------------------------
# tuned serving on the CPU against torch-int and the JAX lax-int
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    name = request.param
    jcfg = JLP.lm_config(j_smoke(name), seq_len=SEQ)
    jp = JLP.init_lm_params(jcfg, seed=3)
    cfg = lm_config(get_smoke_config(name), seq_len=SEQ)
    params = lm_params_from_numpy(jax_lm_to_numpy(jp))
    return jcfg, jp, cfg, params, S.lm_tuned_variant(cfg, 4)


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, cfg.seq_len)).astype(np.int32)


def test_tuned_cuda_on_cpu_is_bitwise_torch_int(setup):
    _, _, cfg, params, tune = setup
    toks = _tokens(cfg, 5, seed=2)
    out = {b: compile_model(cfg, params, backend=b, batch_sizes=(1, 4),
                            device="cpu", tune=tune)(toks)
           for b in ("cuda", "torch-int")}
    assert out["cuda"].shape == (5, cfg.vocab_size)
    assert torch.equal(out["cuda"], out["torch-int"])
    untuned = compile_model(cfg, params, backend="cuda", batch_sizes=(1, 4),
                            device="cpu")(toks)
    assert torch.equal(out["cuda"], untuned)


def test_tuned_plan_carries_the_variant(setup):
    _, _, cfg, params, tune = setup
    g = lowering.annotate_tuning(lowering.optimized_graph(cfg), tune)
    plan = plan_lm(g, params)
    role = {"attention": "attn", "scan": "scan"}
    seen = {}
    for t in plan.tasks:
        key = f"layer{t.layer}/{getattr(t, 'role', role.get(t.kind))}"
        assert t.config == tune.get(key), key
        if t.config is not None:
            seen[key] = t.config
    assert seen == tune


def test_tuned_tasks_match_lax_int_on_the_same_inputs(setup):
    """Each task of the port's ``cuda`` impls on the CPU under the tuned
    variant, fed what the JAX ``lax-int`` program (under the same tuning)
    fed it: matmuls bitwise, the float interludes within one int8 step."""
    jcfg, jp, cfg, params, tune = setup
    jg = JL.annotate_tuning(JL.optimized_graph(jcfg), {
        k: c.to_dict() for k, c in tune.items()})
    plan = plan_lm(lowering.annotate_tuning(lowering.optimized_graph(cfg),
                                            tune), params)
    by_node = {t.node: t for t in plan.tasks}
    packed = BK.pack_lm_weights(plan, params)
    toks = _tokens(cfg, 2)
    jplan = JL.plan_lm(jg, jp)
    consumer = {t.inputs[0]: jp.matmul(t.layer, t.role).x_spec
                for t in jplan.tasks if isinstance(t, JL.MatmulTask)}
    jctx = JB._LMContext(jp, jcfg, consumer)
    from repro.core import quant as JQ
    emb = jnp.take(jp.embed, jnp.asarray(toks), axis=0)
    jctx.put(jplan.embed, JQ.quantize(emb, jp.emb_spec), jp.emb_spec)
    tuned_tasks = 0
    for jt in jplan.tasks:
        env, specs = dict(jctx.env), dict(jctx.specs)
        JB.get_task_impl("lax-int", jt.kind)(jt, jctx)
        t = by_node[jt.node]
        ctx = BK.lm_context(plan, params, cfg, packed)
        ctx.env = {k: torch.from_numpy(np.array(v)) for k, v in env.items()}
        ctx.specs = specs
        BK.get_task_impl("cuda", t.kind)(t, ctx)
        got = ctx.env[t.output].numpy()
        want = np.asarray(jctx.env[t.output])
        if t.kind == "matmul":
            np.testing.assert_array_equal(got, want, err_msg=t.node)
        else:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        tuned_tasks += t.config is not None
    assert tuned_tasks == len(tune)


def test_tuned_logits_within_tolerance_of_lax_int(setup):
    jcfg, jp, cfg, params, tune = setup
    toks = _tokens(cfg, 3, seed=4)
    jg = JL.annotate_tuning(JL.optimized_graph(jcfg), {
        k: c.to_dict() for k, c in tune.items()})
    want = np.asarray(JB.lower_lm("lax-int", jg, jcfg, jp)(jnp.asarray(toks)))
    g = lowering.annotate_tuning(lowering.optimized_graph(cfg), tune)
    got = lower_lm("cuda", g, cfg, params)(torch.from_numpy(toks))
    *_, (_, _, jctx) = _jax_program(jcfg, jp, toks)
    jh = torch.from_numpy(np.array(jctx.env[JL.plan_lm(
        JL.optimized_graph(jcfg), jp).logits_in]))
    h = lm_features("cuda", g, cfg, params)(torch.from_numpy(toks))
    tol = logit_tolerance(h, jh, hidden_out_spec(params), params.unembed)
    diff = (got.double() - _t(want).double()).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))


# ---------------------------------------------------------------------------
# the plain versions at the tuned tiles against the JAX references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", [None] + S.attention_space(64, 64, 16, 4))
def test_attention_plain_at_each_bm_matches_the_jax_mirror(config):
    """``flash_attention_op`` on a CPU tensor walks ``attn_tiles`` under
    the config: within 2e-5 of the JAX mirror on the same tiles and of
    the rule's output (another q tile height may sum a product in another
    order)."""
    rng = np.random.default_rng(11)
    B, S_, H, KV, hd = 2, 64, 8, 2, 16       # tiles divide S (the mirror)
    q = rng.standard_normal((B, S_, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S_, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S_, KV, hd)).astype(np.float32)
    got = fops.flash_attention_op(_t(q), _t(k), _t(v), config=config)
    bq, bk = fops.attn_tiles(S_, S_, H // KV, config)

    def flat(x):
        return jnp.asarray(np.repeat(x, H // x.shape[2], axis=2).transpose(
            0, 2, 1, 3).reshape(B * H, S_, hd))

    want = np.asarray(j_mirror(flat(q), flat(k), flat(v), causal=True,
                               bq=bq, bk=bk)).reshape(B, H, S_, hd) \
        .transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    rule = fops.flash_attention_op(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), rule.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("config", S.scan_space(24, 40, 8))
def test_scan_plain_at_each_instance_matches_the_jax_ref(config):
    rng = np.random.default_rng(12)
    B, S_, di, N = 2, 24, 40, 8
    u = rng.standard_normal((B, S_, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, di)))).astype(
        np.float32)
    A = -(0.5 + rng.random((di, N))).astype(np.float32)
    Bc = rng.standard_normal((B, S_, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S_, N)).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    y, h = sops.selective_scan_op(*(_t(x) for x in (u, dt, A, Bc, Cc, h0)),
                                  config=config)
    jy, jh = j_scan_ref(*(jnp.asarray(x) for x in (u, dt, A, Bc, Cc, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
