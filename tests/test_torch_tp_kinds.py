"""The layer kinds that split over 'model' beside GQA's prefill heads and
the MLP (``parallel.ctx``'s ``all_rows(x, parts)`` / ``sum_own_rows`` /
``model_gather``; ``models.layers``' ``moe_apply``, ``mla_apply``,
``mamba_apply``, ``mamba2_apply``, decode ``gqa_apply`` and ``logits``),
in spawned gloo worlds on a (2, 2) and a (1, 2) ``("data", "model")``
mesh (``_torch_worlds.tp_kinds_world``):

  * two ``make_train_step`` steps (``grad_accum=2``) of the mixtral-8x22b
    (MoE), deepseek-v3-671b (MLA, a shared expert, MTP), falcon-mamba-7b
    (Mamba1) and zamba2-7b (Mamba2 and the shared attention block) smoke
    configs within ``TOL`` of the unsharded step's parameters, the losses
    within ``TOL`` of the unsharded ones and of the JAX package's
    single-device step, with every kind split; mixtral's and deepseek's
    also on a mesh of 'model' extent 1 that splits the rows (the MoE's
    segments then split over the rows' ranks alone);
  * mixtral's gradients with a capacity factor that drops tokens (cap 9:
    odd, so that the segments are padded over two ranks) within ``TOL``,
    its loss within ``TOL`` of the JAX package's too;
  * sharded prefill and two decode steps (the cache placed as the
    dry-run places it: the SSM states and the hybrid's K/V at this rank's
    'model' shard) of those four, granite-8b (the vocabulary split),
    whisper-large-v3 (cross-attention at this rank's heads of ``xk`` /
    ``xv``),
    internvl2-1b with a 509-token vocabulary (tied: the table's d split)
    and untied (the vocabulary whole, gathered in chunks) within ``TOL``
    of the unsharded logits and cache, with equal argmax, and the first
    four's logits within ``TOL`` of the JAX package's prefill and
    decode_step on the same weights, with equal argmax;
  * each rank's ``FlopCounterMode`` flops of one MoE and one Mamba1 block
    (forward and backward) within 5% of the whole block's over the ranks;
  * the ``ctx`` helpers' values and gradients;
  * on a mesh of 'model' extent 1 each kind bitwise its output without a
    mesh (and the MoE without a mesh bitwise ``_moe_rows``).
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_float import J_DECODE, J_LOSS, J_PREFILL, both
from test_torch_parallel_train import HP, _jax_losses

from _torch_dist import run_world, value
from _torch_worlds import _lm_batch, kind_steps, serve_tokens, tp_kinds_world
from repro.models import model as JM
from repro_torch.configs import base as cb
from repro_torch.core import tree as T

TOL = 1e-4
ARCHS = ["mixtral-8x22b", "deepseek-v3-671b", "falcon-mamba-7b", "zamba2-7b"]
KINDS = {"mixtral-8x22b": {"moe", "attention", "logits"},
         "deepseek-v3-671b": {"mla", "moe", "mlp", "logits"},
         "falcon-mamba-7b": {"mamba1", "logits"},
         "zamba2-7b": {"mamba2", "attention", "mlp", "logits"}}
SERVE = {a: {} for a in ARCHS}
SERVE.update({"granite-8b": {}, "whisper-large-v3": {},
              "internvl2-1b": dict(vocab_size=509),
              "internvl2-1b/untied": dict(vocab_size=509,
                                          tie_embeddings=False)})
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    return {a: both(a) for a in ARCHS}


@pytest.fixture(scope="module")
def unsharded(pairs):
    """Each arch's two steps without a mesh, once for both meshes."""
    out = {}
    for a, p in pairs.items():
        ps, losses = kind_steps(cb.get_smoke_config(a), p[3], HP)
        out[a] = ([t.detach().numpy() for t in T.leaves(ps)], losses)
    return out


def _jax_serve(arch, pairs):
    """The JAX package's prefill logits of ``serve_tokens``' prompt, and
    its decode_step logits at positions 3 and 4 (after 0-2, from an empty
    16-deep cache), as the world serves them."""
    jcfg, cfg, jp, _ = pairs[arch]
    tok, _ = serve_tokens(cfg, 4, 8)
    out = dict(prefill=np.asarray(J_PREFILL(jp, jcfg, jnp.asarray(tok))))
    cache = JM.init_cache(jcfg, 4, 16)
    for t in range(5):
        lg, cache = J_DECODE(jp, jcfg, jnp.asarray(tok[:, t:t + 1]),
                             jnp.full((4,), t, jnp.int32), cache)
        if t >= 3:
            out[f"decode{t}"] = np.asarray(lg)
    return out


def _jax_capacity_loss():
    """The JAX package's loss of the world's capacity-dropping mixtral."""
    jcfg, cfg, jp, _ = both("mixtral-8x22b", moe_capacity_factor=0.28)
    batch = {k: jnp.asarray(v.numpy())
             for k, v in _lm_batch(cfg, 1, 4, 16).items()}
    return float(J_LOSS(jp, jcfg, batch)[0])


@pytest.fixture(scope="module")
def jax_ref(pairs):
    """The JAX package's single-device losses and serve logits and the
    capacity case's loss, once for both meshes, computed in a thread
    beside the spawned worlds."""
    pool = ThreadPoolExecutor(1)
    futures = {f"steps/{a}": pool.submit(_jax_losses, a, pairs, False)
               for a in ARCHS}
    futures.update({f"serve/{a}": pool.submit(_jax_serve, a, pairs)
                    for a in ARCHS})
    futures["capacity"] = pool.submit(_jax_capacity_loss)
    yield lambda key: futures[key].result()
    pool.shutdown()


@pytest.fixture(scope="module", params=list(MESHES))
def world(request, pairs, jax_ref, tmp_path_factory):
    D, M = MESHES[request.param]
    inp = dict(mesh=(D, M), params={a: p[3] for a, p in pairs.items()},
               hp=HP, serve=SERVE)
    return run_world(tp_kinds_world, D * M,
                     tmp_path_factory.mktemp("tpk"), inp)


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale <= tol


def _steps_close(v, unsharded, jax_losses):
    uparams, ulosses = unsharded
    for a, b in zip(uparams, v["params"]):
        off = np.abs(b - a) > TOL * np.abs(a).max()
        assert not off.any(), np.abs(b - a).max()
    for got, own in zip(v["losses"], ulosses):
        assert abs(got - own) <= TOL * max(1.0, abs(own))
    for got, want in zip(v["losses"], jax_losses):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_kind_steps_match_unsharded_and_reference(world, unsharded,
                                                  jax_ref, arch):
    v = value(world, f"steps/{arch}")
    assert KINDS[arch] <= set(v["kinds"]["split"]), v["kinds"]
    assert not v["kinds"]["repeat"], v["kinds"]
    _steps_close(v, unsharded[arch], jax_ref(f"steps/{arch}"))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_rows_split_at_model_extent_one(world, unsharded, jax_ref,
                                            arch):
    _steps_close(value(world, f"rows_only/{arch}"), unsharded[arch],
                 jax_ref(f"steps/{arch}"))


def test_moe_capacity_drop_gradients(world, jax_ref):
    v = value(world, "capacity")
    assert "moe" in v["kinds"]["split"] and "moe" not in v["kinds"]["repeat"]
    l0, l1 = v["loss"]
    assert abs(l1 - l0) <= TOL * max(1.0, abs(l0))
    want = jax_ref("capacity")
    assert abs(l1 - want) <= TOL * max(1.0, abs(want)), (l1, want)
    for a, b in zip(v["grads"], v["sharded"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert _close(b, a), np.abs(b - a).max()


def _logits_close(got, want):
    assert got.shape == want.shape
    assert _close(got, want), np.abs(got - want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", list(SERVE))
def test_sharded_prefill_and_decode_match_unsharded(world, jax_ref, arch):
    v = value(world, f"serve/{arch}")
    assert "logits" in v["kinds"]["split"] or "/untied" in arch, v["kinds"]
    assert not set(v["kinds"]["repeat"]) - {"logits"}, v["kinds"]
    ref = jax_ref(f"serve/{arch}") if arch in ARCHS else {}
    _logits_close(*reversed(v["prefill"]))
    if ref:
        _logits_close(v["prefill"][1], ref["prefill"])
    for t in ("decode3", "decode4"):
        want, got = v[t]["logits"]
        _logits_close(got, want)
        if ref:
            _logits_close(got, ref[t])
        for k, (a, b) in v[t]["cache"].items():
            assert _close(b, a), (k, np.abs(b - a).max())
    # the SSM states and the hybrid's K/V reach the layers as this rank's
    # 'model' shard (the batch rows split over 'data' aside)
    for k, (local, whole) in v["decode3"]["shapes"].items():
        sharded = local[2:] != whole[2:]
        want = k in {"falcon-mamba-7b": ("ssm_state", "conv_state"),
                     "zamba2-7b": ("ssm_state", "k", "v"),
                     "whisper-large-v3": ("xk", "xv")}.get(arch, ())
        assert sharded == want, (k, local, whole)


@pytest.mark.parametrize("kind", ["moe", "mamba1"])
def test_block_flops_split_over_the_mesh(world, kind):
    v = value(world, f"flops/{kind}")
    want = v["whole"] / v["ranks"]
    assert abs(v["rank"] - want) <= 0.05 * want, v


def test_ctx_helpers(world):
    v = value(world, "helpers")
    assert v["share"][1] == v["n"]
    np.testing.assert_array_equal(v["y"], v["x"] * v["total"])
    np.testing.assert_array_equal(v["grad"], np.full_like(v["x"],
                                                          v["total"]))
    np.testing.assert_array_equal(
        v["gathered"], np.tile(np.arange(v["tp"], dtype=np.float32), (2, 1)))
    # the dim 'model' splits (none where it holds the tensor whole)
    assert v["placed"] == (1, None)


@pytest.mark.parametrize("name", ["mixtral-8x22b/moe", "deepseek-v3-671b/attn",
                                  "falcon-mamba-7b/mamba", "zamba2-7b/mamba",
                                  "moe_rows", "logits/tied",
                                  "logits/untied"])
def test_model_extent_one_is_bitwise_no_mesh(world, name):
    got = value(world, "bitwise")[name]
    for other in got[1:]:
        np.testing.assert_array_equal(got[0], other)


@pytest.mark.parametrize("tp", [1, 16])
def test_per_rank_cache_follows_the_heads_placement(tp):
    """The cache entries held at a rank's 'model' shard on the published
    configs: the SSM states and the hybrid's K/V (32 heads), not Mamba2's
    packed conv state, nor whisper's 20 cross-attention heads (which 16
    does not divide), nor any GQA or MLA cache (no 'heads' placement)."""
    want = {"falcon-mamba-7b": ("ssm_state", "conv_state"),
            "zamba2-7b": ("ssm_state", "k", "v")}
    for arch in cb.ARCH_IDS:
        got = cb.per_rank_cache(cb.get_config(arch), tp)
        assert got == (want.get(arch, ()) if tp > 1 else ()), (arch, got)
