"""Layer-level numerics of the port's float LM blocks
(``repro_torch.models.layers``): each case of ``tests/test_layers.py`` on
the port, and in each the port's function also held against the
reference's on the same numpy inputs (float32, within ``TOL`` unless a
case says otherwise).  Further cases cover what the reference's tests
reach only through whole models: the norms, rope and activations in bf16,
the add-fold, QAT fake quant, the clamped cache write, MLA decode, the
MoE's capacity drops and the int8 KV grid."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import quant as JQ
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant as Q
from repro_torch.models import layers as L
from repro_torch.models import model as M

jax.config.update("jax_enable_x64", False)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol,
                               err_msg=what)


def pair(**kw):
    """The same config in both packages."""
    return ModelConfig(**kw), JModelConfig(**kw)


def params(tree_np):
    """A numpy tree as (port tensors, JAX arrays)."""
    to = lambda f: (lambda d: {k: to(f)(v) for k, v in d.items()}  # noqa
                    if isinstance(d, dict) else f(d))
    return to(_t)(tree_np), to(jnp.asarray)(tree_np)


def _np_params(p):
    return M.params_to_numpy(p)


# ---------------------------------------------------------------------------
# chunked attention == full attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,window", [(64, 0), (64, 16), (128, 32)])
def test_chunked_attention_matches_full(Sq, window):
    rng = np.random.default_rng(0)
    Bn, H, KV, hd = 2, 4, 2, 16
    q, k, v = (rand(rng, Bn, Sq, n, hd) for n in (H, KV, KV))
    full = L.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                       chunk=0)
    chunked = L.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                          chunk=16)
    close(full, chunked, 2e-5)
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=window, chunk=16)
    close(chunked, ref)


def _gqa_decode_case(window):
    cfg, jcfg = pair(name="t", family="dense", num_layers=1, d_model=32,
                     num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
                     vocab_size=64, dtype="float32", param_dtype="float32",
                     attn_chunk=0, sliding_window=window)
    p = L.gqa_init(L.Draw(torch.Generator().manual_seed(1), "cpu"), cfg,
                   cfg.d_model, torch.float32)
    p, jp = params(_np_params(p))
    Bn, S = 2, 12 if not window else 10
    x = rand(np.random.default_rng(2), Bn, S, cfg.d_model)
    full, _ = L.gqa_apply(p, _t(x), cfg, causal=True)
    close(full, JL.gqa_apply(jp, jnp.asarray(x), jcfg, causal=True)[0],
          what="prefill")
    S_c = window or S
    shape = (Bn, S_c, cfg.num_kv_heads, cfg.head_dim)
    cache = dict(k=torch.zeros(shape), v=torch.zeros(shape))
    jcache = dict(k=jnp.zeros(shape), v=jnp.zeros(shape))
    outs = []
    for t in range(S):
        o, cache = L.gqa_apply(p, _t(x[:, t:t + 1]), cfg, cache=cache,
                               pos=torch.full((Bn,), t))
        jo, jcache = JL.gqa_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  cache=jcache, pos=jnp.full((Bn,), t))
        close(o, jo, what=f"decode step {t}")
        close(cache["k"], jcache["k"], what=f"k cache step {t}")
        outs.append(o)
    close(full, torch.cat(outs, dim=1), 2e-4)


def test_gqa_decode_matches_prefill():
    """Decoding token-by-token through the cache equals the prefill
    attention at every position."""
    _gqa_decode_case(0)


def test_swa_ring_cache_decode_matches_masked_prefill():
    _gqa_decode_case(4)


# ---------------------------------------------------------------------------
# selective scan (mamba1): chunked == naive recurrence; decode == scan
# ---------------------------------------------------------------------------


def _naive_selective_scan(u, dt, A, Bc, Cc, D):
    Bn, S, di = u.shape
    N = A.shape[1]
    h = np.zeros((Bn, di, N))
    ys = []
    for t in range(S):
        a = np.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * u[:, t])[..., None] * Bc[:, t][:, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = np.stack(ys, 1) + D * u
    return y, h


def _softplus(x):
    return np.logaddexp(x, 0).astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(32, 8), (40, 16), (16, 16)])
def test_selective_scan_chunked_matches_naive(S, chunk):
    rng = np.random.default_rng(3)
    Bn, di, N = 2, 8, 4
    u = rand(rng, Bn, S, di)
    dt = _softplus(rand(rng, Bn, S, di))
    A = -np.exp(rand(rng, di, N) * 0.5)
    Bc, Cc = rand(rng, Bn, S, N), rand(rng, Bn, S, N)
    D = np.ones((di,), np.float32)
    h0 = rand(rng, Bn, di, N)
    ops = (u, dt, A, Bc, Cc, D)
    y, h = L.selective_scan_chunked(*map(_t, ops), chunk=chunk)
    y_ref, h_ref = _naive_selective_scan(*ops)
    close(y, y_ref, 1e-4)
    close(h, h_ref, 1e-4)
    y2, h2 = L.selective_scan_chunked(*map(_t, ops), h0=_t(h0), chunk=chunk)
    jy, jh = JL.selective_scan_chunked(*map(jnp.asarray, ops),
                                       h0=jnp.asarray(h0), chunk=chunk)
    close(y2, jy, 1e-4)
    close(h2, jh, 1e-4)


# ---------------------------------------------------------------------------
# SSD (mamba2): chunked == naive recurrence
# ---------------------------------------------------------------------------


def _naive_ssd(xh, dt, A, Bc, Cc):
    Bn, S, H, P = xh.shape
    N = Bc.shape[-1]
    h = np.zeros((Bn, H, P, N))
    ys = []
    for t in range(S):
        a = np.exp(dt[:, t] * A)  # (B,H)
        xw = dt[:, t][..., None] * xh[:, t]
        h = a[:, :, None, None] * h + np.einsum("bn,bhp->bhpn", Bc[:, t], xw)
        ys.append(np.einsum("bhpn,bn->bhp", h, Cc[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16)])
def test_ssd_chunked_matches_naive(S, chunk):
    rng = np.random.default_rng(4)
    Bn, H, P, N = 2, 3, 8, 4
    xh = rand(rng, Bn, S, H, P)
    dt = _softplus(rand(rng, Bn, S, H))
    A = -np.exp(rand(rng, H) * 0.3)
    Bc, Cc = rand(rng, Bn, S, N), rand(rng, Bn, S, N)
    ops = (xh, dt, A, Bc, Cc)
    y, h = L.ssd_chunked(*map(_t, ops), chunk=chunk)
    y_ref, h_ref = _naive_ssd(*ops)
    close(y, y_ref, 1e-4)
    close(h, h_ref, 1e-4)
    jy, jh = JL.ssd_chunked(*map(jnp.asarray, ops), chunk=chunk)
    close(y, jy, 1e-4)
    close(h, jh, 1e-4)
    with pytest.raises(AssertionError):
        L.ssd_chunked(*map(_t, ops), chunk=S // 2 + 1)


# ---------------------------------------------------------------------------
# MoE: grouped (sort+scan) == dense dispatch reference
# ---------------------------------------------------------------------------


def _moe_cfg(**kw):
    base = dict(name="t", family="moe", num_layers=1, d_model=16,
                num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32,
                vocab_size=64, num_experts=4, top_k=2, moe_d_ff=32,
                dtype="float32", param_dtype="float32",
                moe_capacity_factor=4.0)  # high capacity => no drops
    base.update(kw)
    return pair(**base)


def _moe_case(seed, **kw):
    cfg, jcfg = _moe_cfg(**kw)
    p = L.moe_init(L.Draw(torch.Generator().manual_seed(seed), "cpu"), cfg,
                   cfg.d_model, torch.float32)
    p, jp = params(_np_params(p))
    x = rand(np.random.default_rng(seed + 1), 2, 8, cfg.d_model)
    return cfg, jcfg, p, jp, x


def test_moe_grouped_matches_dense():
    cfg, jcfg, p, jp, x = _moe_case(5)
    y_grouped = L.moe_apply(p, _t(x), cfg)
    y_dense = L.moe_apply(p, _t(x), cfg.with_(moe_impl="dense"))
    close(y_grouped, y_dense, 1e-4)
    close(y_grouped, JL.moe_apply(jp, jnp.asarray(x), jcfg))
    close(y_dense, JL.moe_apply(jp, jnp.asarray(x),
                                jcfg.with_(moe_impl="dense")))


def test_moe_shared_expert():
    cfg, jcfg, p, jp, x = _moe_case(7, num_shared_experts=1)
    y = L.moe_apply(p, _t(x), cfg)
    assert np.isfinite(f32(y)).all()
    close(y, JL.moe_apply(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("factor", [0.5, 1.0])
def test_moe_capacity_drops_match_reference(factor):
    """Below capacity the experts' spills overwrite later experts' rows and
    the rows past capacity are zeroed: the same tokens dropped as the
    reference drops (32 tokens, 8 experts top 2: cap 8 rows an expert)."""
    cfg, jcfg, p, jp, x = _moe_case(11, num_experts=8,
                                    moe_capacity_factor=factor)
    x = rand(np.random.default_rng(12), 2, 16, cfg.d_model)
    y = L.moe_apply(p, _t(x), cfg, acc_init=_t(x))
    close(y, JL.moe_apply(jp, jnp.asarray(x), jcfg, acc_init=jnp.asarray(x)))
    dense = L.moe_apply(p, _t(x), cfg.with_(moe_impl="dense"))
    assert not np.allclose(f32(y) - x, f32(dense), atol=1e-4)


# ---------------------------------------------------------------------------
# chunked xent == full logits xent
# ---------------------------------------------------------------------------


def test_chunked_xent_matches_full():
    rng = np.random.default_rng(9)
    Bn, S, d, V = 2, 32, 16, 64
    h, emb = rand(rng, Bn, S, d), rand(rng, V, d)
    labels = rng.integers(0, V, (Bn, S)).astype(np.int32)
    labels[0, :4] = -100
    s, cnt = L.chunked_xent(_t(h), _t(emb), _t(labels), chunk=8)
    logits = h @ emb.T
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + \
        logits.max(-1)
    gold = np.take_along_axis(logits, np.clip(labels, 0, None)[..., None],
                              -1)[..., 0]
    ref = np.sum(np.where(labels >= 0, lse - gold, 0.0))
    np.testing.assert_allclose(float(s), float(ref), rtol=1e-5)
    assert int(cnt) == int(np.sum(labels >= 0))
    js, jcnt = JL.chunked_xent(jnp.asarray(h), jnp.asarray(emb),
                               jnp.asarray(labels), chunk=8)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
    assert int(cnt) == int(jcnt)


# ---------------------------------------------------------------------------
# residual fusion (add-fold) == explicit add
# ---------------------------------------------------------------------------


def test_residual_fusion_equivalence():
    """``acc_init`` only changes where the add happens, never the value."""
    rng = np.random.default_rng(10)
    x, w, skip = rand(rng, 3, 8), rand(rng, 8, 5), rand(rng, 3, 5)
    got = L.dense(_t(x), _t(w), acc_init=_t(skip))
    close(got, L.dense(_t(x), _t(w)) + _t(skip))
    close(got, JL.dense(jnp.asarray(x), jnp.asarray(w),
                        acc_init=jnp.asarray(skip)))


# ---------------------------------------------------------------------------
# the pieces the whole-model tests reach only together
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_and_activations_match_reference(dtype):
    """rmsnorm (scaled by 1 + scale), layernorm, rope, and the three
    activations (GeGLU's gelu is the tanh form) in float32 and bf16: bf16
    results bitwise, as the casts sit where the reference's do."""
    rng = np.random.default_rng(13)
    x = rand(rng, 2, 6, 4, 16)
    scale, bias = rand(rng, 16), rand(rng, 16)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, xj = _t(x).to(tdt), jnp.asarray(x, jdt)
    tol = TOL if dtype == "float32" else 0.0
    close(L.rmsnorm(xt, _t(scale)), JL.rmsnorm(xj, jnp.asarray(scale)), tol)
    close(L.layernorm(xt, _t(scale), _t(bias)),
          JL.layernorm(xj, jnp.asarray(scale), jnp.asarray(bias)), tol)
    r = L.rope(xt, _t(pos), 10_000.0)
    assert r.dtype == tdt
    close(r, JL.rope(xj, jnp.asarray(pos), 10_000.0),
          TOL if dtype == "float32" else 2 ** -7)
    for kind in ("silu", "geglu", "relu2"):
        close(L.act_fn(kind)(_t(x)), JL.act_fn(kind)(jnp.asarray(x)), TOL,
              kind)


def test_qat_dense_matches_reference():
    """``cfg.quant == "qat"``: both operands fake-quantized onto their
    dynamic pow2 int8 grids before the product."""
    cfg, jcfg = pair(name="t", family="dense", num_layers=1, d_model=8,
                     quant="qat", dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(14)
    x, w = rand(rng, 4, 8) * 3, rand(rng, 8, 6)
    close(L.dense(_t(x), _t(w), cfg=cfg),
          JL.dense(jnp.asarray(x), jnp.asarray(w), cfg=jcfg))
    close(L._fq8(_t(x)), JL._fq8(jnp.asarray(x)), 0.0)


@pytest.mark.parametrize("start", [[0, 3], [5, 7], [9, 40]])
def test_cache_write_clamps_as_dynamic_update_slice(start):
    """A write at ``pos`` past the cache lands in the last slots, as
    ``jax.lax.dynamic_update_slice_in_dim`` clamps it."""
    rng = np.random.default_rng(15)
    c, u = rand(rng, 2, 8, 3), rand(rng, 2, 2, 3)
    got = L.update_at(_t(c), _t(u), _t(np.asarray(start)))
    want = jax.vmap(lambda cc, uu, i: jax.lax.dynamic_update_slice_in_dim(
        cc, uu, i, 0))(jnp.asarray(c), jnp.asarray(u), jnp.asarray(start))
    close(got, want, 0.0)


def test_mla_decode_matches_prefill_and_reference():
    """deepseek's MLA: the absorbed decode over the latent cache equals the
    expanded prefill attention, and each step the reference's."""
    cfg, jcfg = pair(name="t", family="moe", num_layers=1, d_model=32,
                     num_heads=4, num_kv_heads=4, head_dim=8, attn_type="mla",
                     q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=8,
                     qk_rope_dim=4, v_head_dim=8, dtype="float32",
                     param_dtype="float32", attn_chunk=0)
    p = L.mla_init(L.Draw(torch.Generator().manual_seed(16), "cpu"), cfg,
                   cfg.d_model, torch.float32)
    p, jp = params(_np_params(p))
    Bn, S = 2, 6
    x = rand(np.random.default_rng(17), Bn, S, cfg.d_model)
    full, _ = L.mla_apply(p, _t(x), cfg)
    close(full, JL.mla_apply(jp, jnp.asarray(x), jcfg)[0])
    cache = dict(ckv=torch.zeros(Bn, S, 8), krope=torch.zeros(Bn, S, 4))
    jcache = {k: jnp.asarray(f32(v)) for k, v in cache.items()}
    outs = []
    for t in range(S):
        o, cache = L.mla_apply(p, _t(x[:, t:t + 1]), cfg, cache=cache,
                               pos=torch.full((Bn,), t))
        jo, jcache = JL.mla_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  cache=jcache, pos=jnp.full((Bn,), t))
        close(o, jo, what=f"step {t}")
        outs.append(o)
    close(full, torch.cat(outs, dim=1), 2e-4)


def test_int8_kv_grid_matches_reference():
    """The int8 KV cache's pow2 grid (exponent -3, half away from zero)."""
    cfg, jcfg = pair(name="t", family="dense", num_layers=1, d_model=8,
                     kv_cache_dtype="int8", dtype="float32",
                     param_dtype="float32")
    x = rand(np.random.default_rng(18), 2, 3, 4) * 8
    q = L._maybe_quant_kv(_t(x), cfg)
    jq = JL._maybe_quant_kv(jnp.asarray(x), jcfg)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(L._maybe_dequant_kv(q, cfg), JL._maybe_dequant_kv(jq, jcfg), 0.0)


def test_int8w_weights_dequantize_as_reference():
    """``getw`` / ``slice_expert`` over ``BlockQuantized``: an expert slice
    of a stacked int8w leaf is the slice of the whole leaf's blocks."""
    w = rand(np.random.default_rng(19), 3, 16, 200)
    bq, jbq = Q.block_quantize(_t(w)), JQ.block_quantize(jnp.asarray(w))
    np.testing.assert_array_equal(bq.q.numpy(), np.asarray(jbq.q))
    np.testing.assert_array_equal(bq.exp.numpy(), np.asarray(jbq.exp))
    close(L.getw(L.slice_expert(bq, 1)), JL.getw(JL.slice_expert(jbq, 1)),
          0.0)
    close(L.getw(L.slice_expert(bq, 1)), L.getw(Q.block_quantize(_t(w[1]))),
          0.0)
