"""The port's float LMs (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU, at smoke size.

  * every config, published and smoke, equal to the reference's field by
    field; ``param_count`` / ``param_bytes`` / ``active_param_count`` /
    ``model_flops`` of the ten published configs equal to the reference's
    (the port counts on the meta device, the reference by ``eval_shape``);
    ``input_specs`` of every cell the same shapes and dtypes;
  * the parameter layout (paths, shapes, dtypes) equal to the reference's,
    and the weight bridge (``params_from_numpy`` / ``params_to_numpy``):
    the weights of every test are drawn by the port, carried into the
    reference as JAX arrays and back, so both packages compute on the same
    parameters;
  * all ten architectures in float32 on the same parameters and inputs:
    ``prefill`` logits, two ``decode_step`` calls (logits and every cache
    leaf) and ``loss_fn`` within ``F32_TOL`` of the reference;
  * decode reproduces prefill (the reference's property,
    ``tests/test_archs.py``) for all ten;
  * gemma-2b, falcon-mamba-7b and zamba2-7b in bf16 within ``BF16_ULPS``
    of the reference with the same argmax (a misplaced cast shows there,
    not in float32);
  * ``quant="int8w"`` and ``kv_cache_dtype="int8"`` on one config each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import quant as JQ
from repro.models import model as JM
from repro_torch.configs import base as cb
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.models import model as M
from repro_torch.models import transformer as TT

# float32: the same arithmetic in another order (einsum contractions, the
# Mamba1 scan's doubling form, XLA's fusions) at smoke width
F32_TOL = 1e-4
# bf16: a rounding that lands on the other side moves a logit by an ulp
# or two; held to BF16_ULPS ulps of bf16 at the largest logit's magnitude
BF16_ULPS = 4
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_to_numpy(tree):
    """A JAX parameter tree as nested dicts of numpy arrays, each
    ``BlockQuantized`` as its ``(q, exp)`` pair."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQ.BlockQuantized):
        return (np.asarray(tree.q), np.asarray(tree.exp))
    return np.asarray(tree)


def f32(a):
    """Any array or tensor (bf16 too) as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def inputs(cfg, seed=0, batch=B, seq=S):
    """Tokens and the stub frontends' embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab_size, (batch, seq))
               .astype(np.int32))
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


# the reference's forwards, compiled once per config (the config static):
# faster than op-by-op at these sizes, and the same arithmetic
J_PREFILL = jax.jit(JM.prefill, static_argnums=1)
J_LOSS = jax.jit(JM.loss_fn, static_argnums=1)
J_DECODE = jax.jit(JM.decode_step, static_argnums=1)


def jax_shapes(jcfg):
    """The reference's parameter layout (``eval_shape``: no allocation)."""
    return jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                          jax.random.PRNGKey(0))


def both(arch, seed=0, **over):
    """(JAX cfg, port cfg, JAX params, port params on the CPU) of ``arch``'s
    smoke config with ``over`` applied: weights drawn by the port, carried
    to numpy by ``params_to_numpy``, into the reference's layout and dtypes
    as JAX arrays, and back into the port by ``params_from_numpy``."""
    jcfg = jcb.get_smoke_config(arch).with_(**over)
    cfg = cb.get_smoke_config(arch).with_(**over)
    tree = M.params_to_numpy(M.init_params(cfg, seed, "cpu"))
    jp = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), tree,
                                jax_shapes(jcfg))
    return jcfg, cfg, jp, M.params_from_numpy(jax_to_numpy(jp), cfg, "cpu")


def next_token_labels(tokens):
    """Each position's label is the next token, -1 at the end (as
    ``SyntheticTokens`` makes them): with ``labels = tokens`` a model with
    tied embeddings can score a loss of exactly 0, and the check would
    hold nothing."""
    return np.concatenate([tokens[:, 1:], -np.ones((tokens.shape[0], 1),
                                                   np.int32)], axis=1)


def extras(x, to):
    return {k: to(v) for k, v in x.items() if k in ("frames", "patches")}


def bf16_close(got, want, what):
    """|got - want| within ``BF16_ULPS`` bf16 ulps of max |want|, and the
    same argmax."""
    got, want = f32(got), f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULPS * ulp,
                               err_msg=what)
    assert np.array_equal(got.argmax(-1), want.argmax(-1)), what


def close(got, want, tol, what):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_configs_equal_reference(arch):
    for mine, theirs in ((cb.get_config(arch), jcb.get_config(arch)),
                         (cb.get_smoke_config(arch),
                          jcb.get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert str(mine.compute_dtype).split(".")[-1] == \
            str(theirs.compute_dtype)
        assert str(mine.pdtype).split(".")[-1] == str(theirs.pdtype)
        assert mine.qk_head_dim == theirs.qk_head_dim
        for shape in cb.SHAPES:
            assert mine.supports_shape(shape) == theirs.supports_shape(shape)


def test_arch_ids_and_shapes_equal_reference():
    assert cb.ARCH_IDS == jcb.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in cb.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcb.SHAPES.items()}


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_param_counts_and_input_specs_equal_reference(arch):
    mine, theirs = cb.get_config(arch), jcb.get_config(arch)
    assert M.param_count(mine) == JM.param_count(theirs)
    assert M.param_bytes(mine) == JM.param_bytes(theirs)
    assert M.active_param_count(mine) == JM.active_param_count(theirs)
    for name, shape in cb.SHAPES.items():
        assert M.model_flops(mine, shape) == \
            JM.model_flops(theirs, jcb.SHAPES[name])
        assert _spec_tree(cb.input_specs(mine, shape)) == \
            _spec_tree(jcb.input_specs(theirs, jcb.SHAPES[name]))


def test_param_shapes_allocate_nothing():
    shapes = M.param_shapes(cb.get_config("deepseek-v3-671b"))
    assert {t.device.type for t in T.leaves(shapes)} == {"meta"}


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------


def _layout(tree):
    """{path: (shape, dtype name)} of a parameter tree of either package."""
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in T.flatten_with_path(tree)}


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_param_layout_and_bridge(arch):
    """The port's parameter tree has the reference's paths, shapes and
    dtypes (smoke and published), and the bridge carries every leaf both
    ways unchanged."""
    for get, jget in ((cb.get_smoke_config, jcb.get_smoke_config),
                      (cb.get_config, jcb.get_config)):
        jflat = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
            jax_shapes(jget(arch)))[0]}
        want = {"/".join(str(getattr(q, "key", q)) for q in path):
                (tuple(v.shape), str(v.dtype)) for path, v in jflat.items()}
        assert _layout(M.param_shapes(get(arch))) == want
    jcfg, cfg, jp, p = both(arch)
    want = dict(T.flatten_with_path(jax_to_numpy(jp)))
    got = dict(T.flatten_with_path(p))
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_array_equal(f32(t), want[k], err_msg=k)
    back = dict(T.flatten_with_path(M.params_to_numpy(p)))
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_bridge_refuses_a_wrong_shape():
    jcfg, cfg, jp, _ = both("llama3.2-3b")
    tree = jax_to_numpy(jp)
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        M.params_from_numpy(tree, cfg, "cpu")
    del tree["embed"]
    with pytest.raises(ValueError, match="keys"):
        M.params_from_numpy(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# the forwards against the reference
# ---------------------------------------------------------------------------


def _decode_pair(jcfg, cfg, jp, p, x, cache_np, positions, tol):
    """Two decode steps from the same cache in both packages: logits and
    every cache leaf compared after each."""
    jc = {k: jnp.asarray(v) for k, v in cache_np.items()}
    c = {k: _t(v) for k, v in cache_np.items()}
    for step, at in enumerate(positions):
        tok = x["tokens"][:, step:step + 1]
        jl, jc = J_DECODE(jp, jcfg, jnp.asarray(tok),
                                jnp.asarray(at, jnp.int32), jc)
        with torch.inference_mode():
            lg, c = M.decode_step(p, cfg, _t(tok), _t(np.asarray(at)), c)
        close(lg, jl, tol, f"decode logits, step {step}")
        assert c.keys() == jc.keys()
        for k in c:
            assert c[k].dtype == getattr(torch, str(jc[k].dtype)), k
            close(c[k], jc[k], tol, f"cache {k}, step {step}")
    return c


def _cache_np(cfg, rng, S_cache=32):
    """A zeroed cache, whisper's cross-attention entries random (the
    reference's decode reads them; nothing of its own fills them)."""
    out = {k: np.zeros(s.shape, str(s.dtype).split(".")[-1])
           for k, s in cb.cache_specs(cfg, B, S_cache,
                                      cb.tensor_spec).items()}
    for k in ("xk", "xv"):
        if k in out:
            out[k] = rng.standard_normal(out[k].shape).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_float32_forwards_match_reference(arch):
    """prefill logits, loss_fn, and two decode steps (positions 3 and 9,
    then 4 and 10: a ring wrap for mixtral's 16-slot window at 20) with
    logits and every cache leaf, float32, within ``F32_TOL``."""
    jcfg, cfg, jp, p = both(arch)
    x = inputs(cfg)
    labels = next_token_labels(x["tokens"])
    with torch.inference_mode():
        got = M.prefill(p, cfg, _t(x["tokens"]), extras(x, _t))
        loss, aux = M.loss_fn(p, cfg, dict(tokens=_t(x["tokens"]),
                                           labels=_t(labels),
                                           **extras(x, _t)))
    want = J_PREFILL(jp, jcfg, jnp.asarray(x["tokens"]),
                     extras(x, jnp.asarray))
    jloss, jaux = J_LOSS(jp, jcfg, dict(tokens=jnp.asarray(x["tokens"]),
                                           labels=jnp.asarray(labels),
                                           **extras(x, jnp.asarray)))
    assert got.shape == (B, 1, cfg.vocab_size) and got.dtype == torch.float32
    close(got, want, F32_TOL, "prefill logits")
    close(loss, jloss, F32_TOL, "loss")
    assert int(aux["tokens"]) == int(jaux["tokens"])
    rng = np.random.default_rng(1)
    _decode_pair(jcfg, cfg, jp, p, x, _cache_np(cfg, rng),
                 [[3, 9], [20, 4]], F32_TOL)


def _prefill_and_decode(cfg, p, tokens, extra):
    """(prefill logits, the last of a token-by-token decode of the same
    prompt) in the port.  Whisper's cross-attention cache comes from the
    encoder over the same frames (``transformer.encoder_cache``)."""
    with torch.inference_mode():
        ref = M.prefill(p, cfg, tokens, extra)
        cache = M.init_cache(cfg, tokens.shape[0], 32, "cpu")
        if cfg.family == "audio":
            cache.update(TT.encoder_cache(p, cfg, extra["frames"]))
        for t in range(tokens.shape[1]):
            logits, cache = M.decode_step(
                p, cfg, tokens[:, t:t + 1],
                torch.full((tokens.shape[0],), t, dtype=torch.int32), cache)
    return ref, logits


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_decode_reproduces_prefill(arch):
    """Decoding a prompt token-by-token reproduces the prefill logits at
    the last position (``tests/test_archs.py``'s property, on all ten).
    MoE at capacity factor 8 (prefill routes more tokens than decode, so
    drops would differ); internvl2 with no patches, which decode cannot
    take."""
    cfg = cb.get_smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.with_(moe_capacity_factor=8.0)
    if cfg.family == "vlm":
        cfg = cfg.with_(num_patches=0)
    p = M.init_params(cfg, 2, "cpu")
    x = inputs(cfg, seed=2, seq=8)
    ref, logits = _prefill_and_decode(cfg, p, _t(x["tokens"]),
                                      extras(x, _t))
    close(logits, ref, 2e-3, "decode vs prefill")


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_bf16_forwards_match_reference(arch):
    """The same in bf16 (params and compute): prefill and one decode step
    within ``BF16_ULPS`` ulps of the reference, the same argmax."""
    jcfg, cfg, jp, p = both(arch, dtype="bfloat16", param_dtype="bfloat16")
    x = inputs(cfg)
    with torch.inference_mode():
        got = M.prefill(p, cfg, _t(x["tokens"]))
    want = J_PREFILL(jp, jcfg, jnp.asarray(x["tokens"]))
    assert got.dtype == torch.bfloat16
    bf16_close(got, want, "bf16 prefill logits")
    jc = JM.init_cache(jcfg, B, 32)
    c = M.init_cache(cfg, B, 32, "cpu")
    tok, at = x["tokens"][:, :1], np.asarray([3, 9], np.int32)
    jl, _ = J_DECODE(jp, jcfg, jnp.asarray(tok), jnp.asarray(at), jc)
    with torch.inference_mode():
        lg, _ = M.decode_step(p, cfg, _t(tok), _t(at), c)
    bf16_close(lg, jl, "bf16 decode logits")


def test_int8w_params_and_forward_match_reference():
    """``quantize_int8w`` (at a ``min_size`` the smoke weights reach) gives
    the reference's int8 payload and exponents bitwise, and the int8w
    forward its logits."""
    jcfg, cfg, jp, p = both("llama3.2-3b")
    jq = JM.quantize_int8w(jp, min_size=4096)
    q = M.quantize_int8w(p, min_size=4096)
    want = dict(T.flatten_with_path(jax_to_numpy(jq)))
    got = dict(T.flatten_with_path(M.params_to_numpy(q)))
    assert got.keys() == want.keys()
    assert isinstance(q["blocks"]["mlp"]["w_up"], Q.BlockQuantized)
    assert not isinstance(q["embed"], Q.BlockQuantized)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the bridge takes the (q, exp) pairs where the config keeps raw leaves
    q2 = M.params_from_numpy(jax_to_numpy(jq), cfg, "cpu")
    assert isinstance(q2["blocks"]["mlp"]["w_up"], Q.BlockQuantized)
    x = inputs(cfg)
    with torch.inference_mode():
        got = M.prefill(q2, cfg, _t(x["tokens"]))
    close(got, JM.prefill(jq, jcfg, jnp.asarray(x["tokens"])), F32_TOL,
          "int8w prefill logits")


def test_int8_kv_cache_matches_reference():
    """``kv_cache_dtype="int8"``: the cache leaves are int8 on the
    reference's pow2 grid (exponent -3), the decode logits and caches
    agree."""
    jcfg, cfg, jp, p = both("llama3.2-3b", kv_cache_dtype="int8")
    x = inputs(cfg)
    c = _decode_pair(jcfg, cfg, jp, p, x,
                     _cache_np(cfg, np.random.default_rng(0)),
                     [[3, 9], [4, 10]], F32_TOL)
    assert c["k"].dtype == torch.int8 and int(c["k"].abs().max()) > 0


def test_residual_fusion_changes_no_value():
    """``residual_fusion`` only moves the add into the accumulator
    (``tests/test_layers.py::test_residual_fusion_equivalence``)."""
    cfg = cb.get_smoke_config("llama3.2-3b")
    p = M.init_params(cfg, 0, "cpu")
    tokens = inputs(cfg)["tokens"]
    batch = dict(tokens=_t(tokens), labels=_t(next_token_labels(tokens)))
    with torch.inference_mode():
        l1, _ = M.loss_fn(p, cfg, batch)
        l2, _ = M.loss_fn(p, cfg.with_(residual_fusion=False), batch)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    cfg = cb.get_smoke_config("gemma-2b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(cfg, 1, 8)
    assert M.init_params(cfg, 0, "cpu")["embed"].device.type == "cpu"


def test_weights_are_freed_when_dropped():
    """A model's weights go when the caller drops them, with the cyclic
    collector off: no parameter-tree walk (``core.tree``) or forward keeps
    a reference cycle that would hold them (on the card, the next model's
    weights would not fit)."""
    import gc
    import weakref

    cfg = cb.get_smoke_config("mixtral-8x22b")
    was = gc.isenabled()
    gc.disable()
    try:
        p = M.init_params(cfg, 0, "cpu")
        alive = weakref.ref(p["moe_blocks"]["moe"]["w_up"])
        tokens = _t(inputs(cfg)["tokens"])
        with torch.no_grad():
            M.prefill(p, cfg, tokens)
            M.decode_step(p, cfg, tokens[:, :1], torch.tensor([0, 1]),
                          M.init_cache(cfg, B, 8, "cpu"))
        T.unflatten(p, T.leaves(T.tree_map(lambda t: t, p)))
        M.params_from_numpy(M.params_to_numpy(p), cfg, "cpu")
        del p
        assert alive() is None
    finally:
        if was:
            gc.enable()
