"""The streaming backend ``cuda-stream`` on the CPU (the ``block_chain``
kernel's plain version): against the JAX package's ``pallas-stream`` at a
tiny config and its ``lax-int`` at full width, the chain-cut property over
every partition, the lowered forward's prepared launches, and serving
through ``ResNetEngine``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import (JTINY, LOGIT_ATOL, TINY, images, jax_params,
                              jax_u8_map, np_qparams)

from repro.compile import lower_forward as jax_lower_forward
from repro.models import resnet as JR
from repro_torch.compile import (compile_model, lower_features,
                                 lower_forward, lowering, params_from_numpy)
from repro_torch.compile.backends import CudaStreamBackend, get_backend
from repro_torch.models import resnet as R
from repro_torch.serve import ImageRequest, ResNetEngine

ARCHS = ["resnet8", "resnet20"]


def _cfgs(arch):
    return getattr(R, arch.upper()), getattr(JR, arch.upper())


@functools.lru_cache(maxsize=None)
def _qparams(arch, varied=False):
    return np_qparams(_cfgs(arch)[1], seed=len(arch) + 3, varied=varied)


@pytest.mark.parametrize("grids", ["fixed", "varied"])
def test_cuda_stream_on_cpu_matches_jax_pallas_stream_tiny(grids):
    d = np_qparams(JTINY, seed=4, varied=grids == "varied")
    jqp, qp = jax_params(d), params_from_numpy(d)
    imgs = images(2, seed=1, img=8)
    feats = lower_features(TINY, qp, "cuda-stream", device="cpu")(imgs)
    np.testing.assert_array_equal(feats.numpy(),
                                  jax_u8_map(JTINY, jqp, imgs))
    assert torch.equal(feats, lower_features(TINY, qp, "torch-int",
                                             device="cpu")(imgs))
    assert feats.any()
    logits = lower_forward(TINY, qp, "cuda-stream", device="cpu")(imgs)
    jlogits = np.asarray(jax_lower_forward(JTINY, jqp, "pallas-stream")(
        jnp.asarray(imgs)))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(logits.numpy().argmax(-1),
                                  jlogits.argmax(-1))


@pytest.mark.parametrize("grids", ["fixed", "varied"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_stream_on_cpu_matches_jax_lax_int_full_width(arch, grids):
    cfg, jcfg = _cfgs(arch)
    d = _qparams(arch, varied=grids == "varied")
    qp = params_from_numpy(d)
    imgs = images(3, seed=7)
    feats = lower_features(cfg, qp, "cuda-stream", device="cpu")(imgs)
    ref = lower_features(cfg, qp, "torch-int", device="cpu")(imgs)
    assert feats.shape == (3, 8, 8, 64) and torch.equal(feats, ref)
    assert len(torch.unique(feats)) > 16, "a flat feature map proves nothing"
    logits = lower_forward(cfg, qp, "cuda-stream", device="cpu")(imgs)
    jlogits = np.asarray(jax_lower_forward(jcfg, jax_params(d), "lax-int")(
        jnp.asarray(imgs)))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(logits.numpy().argmax(-1),
                                  jlogits.argmax(-1))


def _partitions(cfg):
    n, bps = 3 * cfg.blocks_per_stage, cfg.blocks_per_stage
    return {
        "singletons": [[i] for i in range(n)],
        "whole": [list(range(n))],
        "per-stage": [list(range(i * bps, (i + 1) * bps)) for i in range(3)],
        "lopsided": [[0], list(range(1, n))],
        "lopsided-tail": [list(range(n - 1)), [n - 1]],
    }


@functools.lru_cache(maxsize=None)
def _torch_int_map(arch):
    cfg = _cfgs(arch)[0]
    return lower_features(cfg, params_from_numpy(_qparams(arch, True)),
                          "torch-int", device="cpu")(images(3, seed=8))


@pytest.mark.parametrize("fuse_stem", [True, False])
@pytest.mark.parametrize("partition", ["singletons", "whole", "per-stage",
                                       "lopsided", "lopsided-tail"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chain_cut_property(arch, partition, fuse_stem):
    """ANY partition of the blocks into runs of consecutive blocks, with or
    without the stem fused, gives the u8 map of the un-chained reference
    bitwise — through ``compile_model`` with an explicit backend instance,
    on varied per-tensor grids (shifts of every sign)."""
    cfg = _cfgs(arch)[0]
    cuts = _partitions(cfg)[partition]
    backend = CudaStreamBackend(cuts=cuts, fuse_stem=fuse_stem)
    cm = compile_model(cfg, params_from_numpy(_qparams(arch, True)),
                       backend=backend, batch_sizes=(1, 4), device="cpu")
    chains = lowering.plan_chains(lowering.plan_model(cm.graph), cfg,
                                  cuts=cuts, fuse_stem=fuse_stem)
    assert [[t.index for t in c.blocks] for c in chains] == cuts
    assert (chains[0].stem is not None) == fuse_stem
    got = backend.features(cm.graph, cfg, cm.params)(
        torch.from_numpy(images(3, seed=8)))
    assert torch.equal(got, _torch_int_map(arch))
    ref_logits = lower_forward(cfg, params_from_numpy(_qparams(arch, True)),
                               "torch-int", device="cpu")(images(3, seed=8))
    assert torch.equal(cm(images(3, seed=8)), ref_logits)


def test_cuda_stream_is_registered_and_plans_one_chain():
    backend = get_backend("cuda-stream")
    assert isinstance(backend, CudaStreamBackend)
    assert (backend.cuts, backend.fuse_stem, backend.smem_budget) == \
        (None, True, None)
    for cfg in (R.RESNET8, R.RESNET20):
        chains = lowering.plan_chains(
            lowering.plan_model(lowering.optimized_graph(cfg)), cfg)
        assert [c.describe() for c in chains] == \
            ["+".join(["stem"] + [f"b{i}" for i in
                                  range(3 * cfg.blocks_per_stage)])]


def test_engine_serves_cuda_stream_on_cpu_with_torch_int_shadow():
    d = _qparams("resnet8")
    eng = ResNetEngine(R.RESNET8, params_from_numpy(d), batch=4,
                       backend="cuda-stream", batch_sizes=(1, 4),
                       ab_backends=("torch-int",), device="cpu")
    assert eng.backend == "cuda-stream" and eng.device.type == "cpu"
    imgs = images(6, seed=9)
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    for r in reqs:
        eng.submit(r)
    assert eng.run() == 2 and eng.served == 6 and not eng.queue
    assert all(r.done for r in reqs)
    assert eng.ab_stats["torch-int"] == [0.0, 0.0]
    assert eng.model.run_counts == {1: 0, 4: 2}
    shadow = eng.shadows["torch-int"](imgs).numpy()
    assert [r.label for r in reqs] == list(shadow.argmax(-1))


@pytest.mark.parametrize("arch,cuts", [
    ("resnet8", None), ("resnet8", [[0], [1], [2]]),
    ("resnet20", [[0, 1, 2], [3], [4, 5, 6, 7, 8]])])
def test_lowered_forward_runs_prepared_launches_matching_jax(arch, cuts,
                                                             monkeypatch):
    """The lowered cuda-stream forward is a fixed sequence of prepared
    launches (``ChainLaunch`` per chain, ``ResblockLaunch`` per singleton
    block), built once: with the wrappers' per-call validation and link
    packing made to raise after lowering, the forward still runs, and it
    matches torch-int and the JAX package's lax-int (and pallas-stream on
    the tiny config) bitwise."""
    from repro_torch.kernels.megakernel import ops as chain_ops
    from repro_torch.kernels.resblock_fused import ops as block_ops

    cfg, jcfg = _cfgs(arch)
    d = _qparams(arch)
    qp = params_from_numpy(d)
    backend = CudaStreamBackend(cuts=cuts)
    feats = backend.features(lowering.optimized_graph(cfg), cfg, qp)
    kinds = [type(s).__name__ for s in feats.steps]
    n_chains = 1 if cuts is None else len(cuts)
    # a singleton run runs resblock_fused, unless the stem joins it
    singles = 0 if cuts is None else sum(c != [0] and len(c) == 1
                                         for c in cuts)
    assert kinds.count("ChainLaunch") == n_chains - singles
    assert kinds.count("ResblockLaunch") == singles

    def refuse(*a, **k):
        raise AssertionError("per-call validation on the lowered path")

    for mod, name in ((chain_ops, "_check_chain"), (chain_ops, "_link_ints"),
                      (chain_ops, "pack_block"), (block_ops, "_check_block"),
                      (block_ops, "pack_block")):
        monkeypatch.setattr(mod, name, refuse)
    imgs = images(3, seed=11)
    got = feats(torch.from_numpy(imgs))
    monkeypatch.undo()
    assert torch.equal(got, lower_features(cfg, qp, "torch-int",
                                           device="cpu")(imgs))
    jqp = jax_params(d)
    np.testing.assert_array_equal(got.numpy(), jax_u8_map(jcfg, jqp, imgs))
    logits = backend.lower(lowering.optimized_graph(cfg), cfg, qp)(
        torch.from_numpy(imgs))
    jlogits = np.asarray(jax_lower_forward(jcfg, jqp, "lax-int")(
        jnp.asarray(imgs)))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(logits.numpy().argmax(-1),
                                  jlogits.argmax(-1))


def test_lowered_tiny_forward_runs_prepared_launches_matching_pallas_stream():
    d = np_qparams(JTINY, seed=5)
    jqp, qp = jax_params(d), params_from_numpy(d)
    feats = CudaStreamBackend().features(lowering.optimized_graph(TINY),
                                         TINY, qp)
    assert [type(s).__name__ for s in feats.steps] == ["ChainLaunch"]
    imgs = images(2, seed=3, img=8)
    np.testing.assert_array_equal(feats(torch.from_numpy(imgs)).numpy(),
                                  jax_u8_map(JTINY, jqp, imgs))
