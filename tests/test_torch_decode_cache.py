"""The decode step writes each layer's cache once (``models.layers.
update_at`` into a given buffer; ``transformer`` / ``ssm`` / ``hybrid``
``decode_step`` with one stacked buffer a cache entry, or the caller's
own with ``donate``):

  * ``update_at`` into a buffer and in place clamps as
    ``jax.lax.dynamic_update_slice_in_dim`` does (a start at or past
    ``S_c - S`` goes to the last slots), the functional form unchanged;
  * for every smoke config (and int8 KV caches) two decode steps give the
    same logits and caches bitwise with and without ``donate``; without
    it the input cache is left as it was, with it the new cache is the
    input's own tensors;
  * the peak of live storage a step makes above its inputs (the
    dry-run's ``StepCounter`` over real CPU tensors) is the donated
    step's (less than one cache) plus one new cache, not the two caches
    of per-layer copies stacked at the end;
  * GQA's decode attention upcasts the cache a few batch rows at a time
    (``layers.DECODE_UPCAST_BYTES``) with the same logits and caches as
    when it upcasts a whole layer (bitwise where a K/V head serves more
    than one query head; within 1e-6 where each serves one, as a row's
    single-query product may round its last bit apart from the batched
    one on the CPU), and a lower peak.
The logits and caches against the JAX package: tests/test_torch_lm_float.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.core import tree as T
from repro_torch.launch.dryrun import StepCounter
from repro_torch.models import layers as L
from repro_torch.models import model as M

CACHE_KEYS = ("k", "v", "ckv", "krope", "ssm_state", "conv_state")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dus(c, u, start):
    return np.asarray(jax.vmap(
        lambda cc, uu, i: jax.lax.dynamic_update_slice_in_dim(
            cc, uu, i, 0))(jnp.asarray(c), jnp.asarray(u),
                           jnp.asarray(start)))


@pytest.mark.parametrize("start", [[0, 3], [5, 6], [6, 7], [9, 40]],
                         ids=["inside", "at-S_c-S", "past", "far-past"])
def test_update_at_writes_a_buffer_and_in_place(start):
    rng = np.random.default_rng(15)
    c = rng.standard_normal((2, 8, 3)).astype(np.float32)
    u = rng.standard_normal((2, 2, 3)).astype(np.float32)
    want = _dus(c, u, np.asarray(start))
    st = torch.tensor(start)
    ct = torch.from_numpy(c.copy())
    buf = torch.full_like(ct, float("nan"))
    got = L.update_at(ct, torch.from_numpy(u), st, buf)
    assert got is buf
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ct.numpy(), c)          # source intact
    got = L.update_at(ct, torch.from_numpy(u), st, ct)   # donated
    assert got is ct
    np.testing.assert_array_equal(ct.numpy(), want)
    np.testing.assert_array_equal(
        L.update_at(torch.from_numpy(c), torch.from_numpy(u), st).numpy(),
        want)


def _cache(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    c = M.init_cache(cfg, B, S, "cpu")
    return {k: (torch.randn(v.shape, generator=g).to(v.dtype)
                if v.is_floating_point()
                else torch.randint(-100, 100, v.shape, generator=g)
                .to(v.dtype)) for k, v in c.items()}


CASES = [(a, False) for a in cb.ARCH_IDS] + [
    (a, True) for a in ("llama3.2-3b", "deepseek-v3-671b", "zamba2-7b")]


@pytest.mark.parametrize("arch,int8", CASES,
                         ids=[f"{a}{'-int8kv' if q else ''}"
                              for a, q in CASES])
def test_donated_decode_equals_the_buffered_one(arch, int8):
    cfg = cb.get_smoke_config(arch)
    if int8:
        cfg = cfg.with_(kv_cache_dtype="int8")
    p = M.init_params(cfg, 0, "cpu")
    c0 = _cache(cfg, 2, 16, 1)
    a, b = T.tree_map(torch.clone, c0), T.tree_map(torch.clone, c0)
    # the second step writes past the cache (clamped to its last slot)
    for step, pos in enumerate(([3, 15], [4, 20])):
        tok = torch.tensor([[5 + step], [7]], dtype=torch.int32)
        pos = torch.tensor(pos, dtype=torch.int32)
        kept = T.tree_map(torch.clone, a)
        with torch.no_grad():
            la, na = M.decode_step(p, cfg, tok, pos, a)
            lb, nb = M.decode_step(p, cfg, tok, pos, b, donate=True)
        assert torch.equal(la, lb)
        for k in na:
            assert torch.equal(na[k], nb[k]), k
            assert torch.equal(a[k], kept[k]), k      # input left as it was
            if k in CACHE_KEYS:
                assert nb[k] is b[k] and na[k] is not a[k], k
        a, b = na, nb


@pytest.mark.parametrize("arch", ["granite-8b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_decode_holds_one_new_cache(arch):
    over = dict(num_layers=8) if arch != "zamba2-7b" else {}
    cfg = cb.get_smoke_config(arch).with_(**over)
    p = M.init_params(cfg, 0, "cpu")
    c = _cache(cfg, 4, 256, 2)
    cache_b = sum(v.numel() * v.element_size() for k, v in c.items()
                  if k in CACHE_KEYS)
    tok = torch.tensor([[5], [7], [1], [2]], dtype=torch.int32)
    pos = torch.tensor([3, 100, 200, 255], dtype=torch.int32)
    temps = {}
    for donate in (False, True):
        counter = StepCounter()
        with torch.no_grad(), counter:
            out = M.decode_step(p, cfg, tok, pos, c, donate=donate)
        temps[donate] = counter.peak
        del out
    # donated: the step's own temporaries, less than the cache; buffered:
    # those and one new cache (per-layer copies stacked at the end held
    # two: 4,196,352 bytes for granite-8b here against 2,271,264)
    assert temps[True] < cache_b, (temps, cache_b)
    assert temps[False] <= temps[True] + cache_b, (temps, cache_b)


@pytest.mark.parametrize("arch,int8", [("llama3.2-3b", False),
                                       ("llama3.2-3b", True),
                                       ("gemma-2b", False),
                                       ("whisper-large-v3", False),
                                       ("zamba2-7b", False)],
                         ids=["llama3.2-3b", "llama3.2-3b-int8kv",
                              "gemma-2b", "whisper-large-v3", "zamba2-7b"])
def test_decode_upcasts_a_row_at_a_time(arch, int8, monkeypatch):
    cfg = cb.get_smoke_config(arch)
    if int8:
        cfg = cfg.with_(kv_cache_dtype="int8")
    p = M.init_params(cfg, 0, "cpu")
    c = _cache(cfg, 3, 64, 3)
    tok = torch.tensor([[5], [7], [1]], dtype=torch.int32)
    pos = torch.tensor([3, 40, 63], dtype=torch.int32)
    outs, peaks = [], []
    for budget in (L.DECODE_UPCAST_BYTES, 1):      # the whole layer; a row
        monkeypatch.setattr(L, "DECODE_UPCAST_BYTES", budget)
        counter = StepCounter()
        with torch.no_grad(), counter:
            outs.append(M.decode_step(p, cfg, tok, pos, c))
        peaks.append(counter.peak)
    (la, na), (lb, nb) = outs
    tol = 0 if cfg.num_heads > cfg.num_kv_heads else 1e-6
    torch.testing.assert_close(lb, la, rtol=tol, atol=tol)
    for k in na:
        torch.testing.assert_close(nb[k], na[k], rtol=tol, atol=tol,
                                   msg=k)
    assert peaks[1] < peaks[0], peaks
