"""``repro_torch.tune``: the tuner on the H100's own knobs, on the CPU — the
cases of tests/test_tune.py (config round-trips, the config cache, every
enumerated config bitwise, cost-model ranking, the search and the tuned
compile), every enumerated stem, block and chain config at ResNet8 shapes
held through the banded mirrors against the plain versions and the JAX
package's ``*_ref``, the wrappers' handling of tuned knobs, and the
``tuned`` half of tests/test_conformance.py for ``cuda`` and
``cuda-stream``."""
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import live_chain
from test_torch_slice import images, np_qparams

from repro.kernels.conv_stem.ref import conv_stem_ref as jax_conv_stem_ref
from repro.kernels.megakernel.megakernel import \
    ChainBlockSpec as JChainBlockSpec
from repro.kernels.megakernel.ref import \
    block_chain_ref as jax_block_chain_ref
from repro.kernels.resblock_fused.ref import \
    resblock_ref as jax_resblock_ref
from repro.models import resnet as JR
from repro_torch import tune as T
from repro_torch.compile import (compile_model, lowering, init_lm_params,
                                 lm_config, params_from_numpy)
from repro_torch.configs import get_smoke_config
from repro_torch.core import dataflow as df
from repro_torch.core import ilp
from repro_torch.kernels.conv_stem.ops import conv_stem_op
from repro_torch.kernels.conv_stem.ref import (conv_stem_banded,
                                               conv_stem_ref)
from repro_torch.kernels.megakernel.ops import ChainLaunch, block_chain_op
from repro_torch.kernels.megakernel.ref import (block_chain_banded,
                                                block_chain_ref)
from repro_torch.kernels.resblock_fused.ops import (ResblockLaunch,
                                                    resblock_fused_op)
from repro_torch.kernels.resblock_fused.ref import (resblock_banded,
                                                    resblock_ref)
from repro_torch.models import resnet as R
from repro_torch.tune import cost as tcost
from repro_torch.tune import space as tspace
from repro_torch.tune.config import KernelConfig, largest_divisor_leq

CPU = torch.device("cpu")
# the module (``repro_torch.tune.search`` is also the name of its function)
tsearch = importlib.import_module("repro_torch.tune.search")


@pytest.fixture(scope="module")
def qp8():
    return params_from_numpy(np_qparams(JR.RESNET8, seed=0))


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
    return path


# ---------------------------------------------------------------------------
# KernelConfig
# ---------------------------------------------------------------------------


def test_kernel_config_dict_roundtrip_and_hashability():
    c = KernelConfig(batch_tile=4, cout_block=8)
    assert KernelConfig.from_dict(c.to_dict()) == c
    assert KernelConfig.from_dict({}) == KernelConfig()
    assert c.to_dict() == dict(batch_tile=4, cout_block=8)  # defaults dropped
    hash(c)
    assert KernelConfig().describe() == "default"
    h = KernelConfig(band_rows=4, split=8, batch_tile=2)
    assert h.to_dict() == dict(band_rows=4, split=8, batch_tile=2)
    assert KernelConfig.from_dict(json.loads(json.dumps(h.to_dict()))) == h
    assert h.describe() == "band_rows=4,batch_tile=2,split=8"


def test_kernel_config_normalize_snaps_to_legal_values():
    assert largest_divisor_leq(12, 8) == 6
    c = KernelConfig(batch_tile=8, cout_block=24).normalize(n=6, cout=16)
    assert c.batch_tile == 6 and c.cout_block == 16
    # 0 means maximal
    c = KernelConfig(batch_tile=0, cout_block=0).normalize(n=5, cout=32)
    assert c.batch_tile == 5 and c.cout_block == 32
    # band_rows into [1, oh], only where the shape is given; 0 stays 0
    assert KernelConfig(band_rows=11).normalize(1, 16, oh=8).band_rows == 8
    assert KernelConfig(band_rows=11).normalize(1, 16).band_rows == 11
    assert KernelConfig().normalize(1, 16, oh=8).band_rows == 0
    # split to the largest legal split at most the requested one
    assert KernelConfig(split=8).normalize(
        4, 16, splits=[1, 2, 4]).split == 4
    assert KernelConfig(split=3).normalize(4, 16, splits=[1, 2]).split == 2
    assert KernelConfig(split=1).normalize(4, 16, splits=[2, 4]).split == 2
    assert KernelConfig().normalize(4, 16, splits=[1, 2]).split == 0


# ---------------------------------------------------------------------------
# config cache (REPRO_TUNE_CACHE; corrupt -> empty)
# ---------------------------------------------------------------------------


def test_cache_roundtrip(cache_file):
    assert T.cache_path() == str(cache_file)
    c = T.TuneCache()
    key = T.cache_key("model:resnet8", ((4, 32, 32, 3),), "float32",
                      "cuda", "cpu")
    assert c.get(key) is None and c.misses == 1
    tuning = {"stem": KernelConfig(band_rows=4),
              "block0": KernelConfig(band_rows=2)}
    c.put(key, tuning)
    c.save()
    c2 = T.TuneCache()
    got = c2.get(key)
    assert got == tuning and c2.hits == 1
    raw = json.loads(cache_file.read_text())
    assert raw[key]["stem"] == {"band_rows": 4}


def test_cache_corrupt_file_treated_as_empty(cache_file):
    cache_file.write_text("{ this is not json")
    c = T.TuneCache()
    assert len(c) == 0
    assert c.get("anything") is None
    c.put("k", {"stem": KernelConfig()})
    c.save()                                   # save over the corrupt file
    assert T.TuneCache().get("k") == {"stem": KernelConfig()}
    cache_file.write_text("[1, 2, 3]")         # non-dict JSON: also empty
    assert len(T.TuneCache()) == 0
    cache_file.write_text('{"k": {"stem": 7}}')  # malformed entry: a miss
    c = T.TuneCache()
    assert c.get("k") is None and c.misses == 1


def test_cache_default_path_used_without_env(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    assert T.cache_path() == os.path.expanduser(
        "~/.cache/repro_torch/tune.json")


def test_cache_path_honors_xdg_cache_home(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert T.cache_path() == str(tmp_path / "xdg" / "repro_torch" /
                                 "tune.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "explicit.json"))
    assert T.cache_path() == str(tmp_path / "explicit.json")
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    c = T.TuneCache()
    c.put("k", {"stem": KernelConfig()})
    c.save()
    assert os.path.isfile(tmp_path / "xdg" / "repro_torch" / "tune.json")


# ---------------------------------------------------------------------------
# space: legality of every enumerated config
# ---------------------------------------------------------------------------


def test_model_space_structure_and_balance_pruning():
    spaces = tspace.model_space(R.RESNET8, batch=4)
    assert set(spaces) == {"stem", "block0", "block1", "block2"}
    layers = df.resnet8_layers()
    # the eq. 12-14 floor exists, but no Hopper knob blocks channels
    floor = dict(zip((l.name for l in layers),
                     ilp.balanced_och_par(layers, pow2=True)))["stem"]
    assert floor > 1
    by = {l.name: l for l in layers}
    for key, name in (("stem", "stem"), ("block0", "c0_0"),
                      ("block1", "c1_0"), ("block2", "c2_0")):
        oh = by[name].oh
        bands = [c.band_rows for c in spaces[key]]
        assert bands == tspace.band_choices(oh) and bands[-1] == 1
        assert all(c.to_dict() == dict(band_rows=c.band_rows)
                   for c in spaces[key])
    assert tspace.space_size(spaces) == \
        np.prod([len(v) for v in spaces.values()])
    assert tspace.band_choices(32) == [32, 16, 11, 8, 7, 6, 5, 4, 3, 2, 1]

    stream = tspace.model_space(R.RESNET20, batch=32, backend="cuda-stream")
    assert list(stream) == ["stem"]        # one chain, the stem fused
    pairs = {(c.batch_tile, c.split) for c in stream["stem"]}
    shapes = df.resnet_block_shapes(3)
    for bt, s in pairs:
        assert 32 % bt == 0 and s in tspace.chain_splits(shapes)
        assert df.chain_task_smem_bytes(shapes, bt, 16, s) <= \
            tspace.SMEM_BUDGET
    assert (1, 1) in pairs and (8, 8) in pairs and (4, 1) not in pairs
    # the card's occupancy query removes splits it cannot co-schedule
    tight = tspace.model_space(R.RESNET20, 32, "cuda-stream",
                               capacity=lambda s, smem: int(s < 8))
    assert {c.split for c in tight["stem"]} == {1, 2, 4}
    with pytest.raises(ValueError, match="kernel backends"):
        tspace.model_space(R.RESNET8, 4, "torch-int")


def test_spaces_respect_the_shared_memory_budget():
    layers = df.resnet20_layers()
    by = {l.name: l for l in layers}
    big = tspace.block_space(by["c0_0"], 8, smem_budget=30_000)
    assert big and max(c.band_rows for c in big) < 32
    for c in big:
        assert df.resblock_task_smem_bytes(32, 32, 16, 16, 1, False,
                                           c.band_rows) <= 30_000
    assert tspace.stem_space(by["stem"], 8, smem_budget=1_000) == []
    assert tspace.model_chains(R.RESNET20, smem_budget=0) == \
        tuple((f"block{i}", (i,), 0) for i in range(9))
    # chains cut to singletons run resblock_fused: their keys get bands


def test_chain_keys_reach_the_launches_of_a_cut_plan():
    """At a budget that cuts ResNet20's chain (the stem and blocks 0-5, then
    blocks 6-8 alone), a tuning under ``model_space``'s keys reaches each
    launch of the lowered ``cuda-stream`` forward: the chain reads the
    stem's config, each lone block its own band."""
    from repro_torch.compile.backends import CudaStreamBackend

    budget = 60_000
    chains = tspace.model_chains(R.RESNET20, budget)
    assert [k for k, *_ in chains] == ["stem", "block6", "block7", "block8"]
    shapes = df.resnet_block_shapes(3)
    layers = {l.name: l for l in df.resnet20_layers()}
    tuning = {"stem": tspace.chain_tilings(
        [shapes[i] for i in chains[0][1]], 8, 16)[-1]}
    for i in (6, 7, 8):
        tuning[f"block{i}"] = tspace.block_space(
            layers[f"c{i}_0"], 8, f"ds{i}" in layers)[-1]
    assert tuning["stem"].split and tuning["block6"].band_rows
    qp = params_from_numpy(np_qparams(JR.RESNET20, seed=4))
    cm = compile_model(R.RESNET20, qp,
                       backend=CudaStreamBackend(smem_budget=budget),
                       batch_sizes=(8,), tune=tuning, device="cpu")
    steps = cm.backend.features(cm.graph, R.RESNET20, cm.params).steps
    assert [type(s).__name__ for s in steps] == \
        ["ChainLaunch"] + ["ResblockLaunch"] * 3
    assert [s.config for s in steps] == \
        [tuning[k] for k in ("stem", "block6", "block7", "block8")]
    xs = images(3, seed=2)
    assert torch.equal(cm(xs), compile_model(
        R.RESNET20, qp, backend="torch-int", batch_sizes=(8,),
        device="cpu")(xs))


def _stem_case(rng, n, cin=3, cout=16, h=32):
    return (torch.from_numpy(rng.integers(0, 256, (n, h, h, cin),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(-128, 128, (3, 3, cin, cout),
                                          dtype=np.int8)),
            torch.from_numpy(rng.integers(-500, 500, cout).astype(np.int32)))


def test_every_enumerated_stem_config_bitexact_vs_ref():
    """Legality contract: any config the space emits changes only the
    decomposition, never a bit (ResNet8 stem shapes): the banded mirror at
    its band against the plain version and the JAX oracle, and the wrapper
    taking it."""
    x, w, b = _stem_case(np.random.default_rng(0), 2)
    ref = conv_stem_ref(x, w, b, shift=7)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jax_conv_stem_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), shift=7)))
    assert 0 < ref.float().mean() < 255
    spaces = tspace.model_space(R.RESNET8, batch=2)
    assert len(spaces["stem"]) == 11
    for c in spaces["stem"]:
        got = conv_stem_banded(x, w, b, shift=7, band=c.band_rows)
        assert torch.equal(got, ref), c.describe()
        assert torch.equal(conv_stem_op(x, w, b, shift=7, config=c), ref)


def _block_ops(rng, n, l0, ds):
    ops = [rng.integers(0, 256, (n, l0.ih, l0.iw, l0.ich)).astype(np.uint8),
           rng.integers(-128, 128, (3, 3, l0.ich, l0.och)).astype(np.int8),
           rng.integers(-500, 500, l0.och).astype(np.int32),
           rng.integers(-128, 128, (3, 3, l0.och, l0.och)).astype(np.int8),
           rng.integers(-500, 500, l0.och).astype(np.int32)]
    if ds:
        ops += [rng.integers(-128, 128, (1, 1, l0.ich, l0.och)).astype(
                    np.int8),
                rng.integers(-500, 500, l0.och).astype(np.int32)]
    else:
        ops += [None, None]
    return ops


def test_every_enumerated_block_config_bitexact_vs_ref():
    """Same contract for the fused residual block, at the identity (block0)
    and both downsample (block1, block2) shapes of ResNet8."""
    batch = 2
    spaces = tspace.model_space(R.RESNET8, batch=batch)
    layers = {l.name: l for l in df.resnet8_layers()}
    for i in (0, 1, 2):
        l0, ds = layers[f"c{i}_0"], f"ds{i}" in layers
        ops = _block_ops(np.random.default_rng(10 + i), batch, l0, ds)
        kw = dict(stride=l0.stride, shift0=11, shift1=11,
                  skip_shift=-2 if ds else 3)
        t = [None if a is None else torch.from_numpy(a) for a in ops]
        ref = resblock_ref(*t, **kw)
        jref = jax_resblock_ref(*[None if a is None else jnp.asarray(a)
                                  for a in ops], **kw)
        np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
        assert 0 < ref.float().mean() < 255
        assert spaces[f"block{i}"]
        for c in spaces[f"block{i}"]:
            got = resblock_banded(*t, band=c.band_rows, **kw)
            assert torch.equal(got, ref), (i, c.describe())
            launch = ResblockLaunch(*t[1:], config=c, **kw)
            assert launch.band_rows(batch, l0.oh) == c.band_rows
            assert torch.equal(launch(t[0]), ref)
            assert torch.equal(resblock_fused_op(*t, config=c, **kw), ref)


def test_every_enumerated_chain_config_bitexact_vs_ref():
    """Same contract for the chain kernel: every (batch_tile, split) of
    ResNet8's one stem-fused chain, through the banded mirror at its split
    against the plain version and the JAX oracle; the prepared launch takes
    the config's tiling."""
    batch = 8
    (key, run, stem_och), = tspace.model_chains(R.RESNET8)
    shapes = df.resnet_block_shapes(1)
    x, blocks, specs, stem, stem_shift = live_chain(
        np.random.default_rng(5), CPU, shapes, batch, stem_och)
    kw = dict(specs=specs, stem=stem, stem_shift=stem_shift)
    ref = block_chain_ref(x, blocks, **kw)
    jspecs = tuple(JChainBlockSpec(stride=s.stride, has_ds=s.has_ds,
                                   shift0=s.shift0, shift1=s.shift1,
                                   skip_shift=s.skip_shift) for s in specs)
    jref = jax_block_chain_ref(
        jnp.asarray(x.numpy()),
        tuple(tuple(jnp.asarray(w.numpy()) for w in ws) for ws in blocks),
        specs=jspecs, stem=tuple(jnp.asarray(t.numpy()) for t in stem),
        stem_shift=stem_shift)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
    assert 0 < ref.float().mean() < 255
    configs = tspace.model_space(R.RESNET8, batch, "cuda-stream")[key]
    assert {c.split for c in configs} == {1, 2, 4, 8}
    for split in {c.split for c in configs}:
        got = block_chain_banded(x, blocks, split=split, **kw)
        assert torch.equal(got, ref), split
    for c in configs:
        launch = ChainLaunch(blocks, in_shape=x.shape[1:], config=c, **kw)
        assert launch.tiling(batch) == (c.batch_tile, c.split)
        assert launch.thread_blocks(batch) == batch // c.batch_tile * c.split
        assert torch.equal(launch(x), ref)


def test_wrappers_refuse_tunings_over_the_shared_memory_budget():
    """A tuned knob whose thread block does not fit is refused by the
    wrapper, on the CPU as on the card: never clamped quietly."""
    rng = np.random.default_rng(1)
    l0 = df.ConvLayer("big", 64, 64, 64, 64, 64, 64)
    t = [None if a is None else torch.from_numpy(a)
         for a in _block_ops(rng, 1, l0, False)]
    kw = dict(stride=1, shift0=11, shift1=11, skip_shift=0)
    assert df.resblock_task_smem_bytes(64, 64, 64, 64, 1, False, 64) > \
        tspace.SMEM_BUDGET
    with pytest.raises(ValueError, match="over the budget"):
        resblock_fused_op(*t, config=KernelConfig(band_rows=64), **kw)
    assert torch.equal(
        resblock_fused_op(*t, config=KernelConfig(band_rows=4), **kw),
        resblock_ref(*t, **kw))
    fits = [b for b in tspace.band_choices(64) if df.resblock_task_smem_bytes(
        64, 64, 64, 64, 1, False, b) <= tspace.SMEM_BUDGET]
    assert 1 < len(fits) < len(tspace.band_choices(64))
    assert [c.band_rows for c in tspace.block_space(l0, 1)] == fits

    x, w, b = _stem_case(rng, 1, h=400)
    with pytest.raises(ValueError, match="over the budget"):
        conv_stem_op(x, w, b, shift=9, config=KernelConfig(band_rows=300))
    x8, w8, b8 = _stem_case(rng, 1, cin=8)
    with pytest.raises(ValueError, match="banded path"):
        conv_stem_op(x8, w8, b8, shift=9, config=KernelConfig(band_rows=4))

    shapes = df.resnet_block_shapes(3)
    xc, blocks, specs, stem, stem_shift = live_chain(
        np.random.default_rng(2), CPU, shapes, 4, 16)
    with pytest.raises(ValueError, match="over the budget"):
        block_chain_op(xc, blocks, specs=specs, stem=stem,
                       stem_shift=stem_shift,
                       config=KernelConfig(batch_tile=4, split=1))


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def test_cost_model_ranks_fused_block_cheaper_than_unfused():
    """The sanity pin of the analytic stage: in modeled bytes and modeled
    time the fused residual kernel beats the unfused dataflow at every
    ResNet8/20 block shape, at the rule's band and at every enumerated
    one."""
    for layers in (df.resnet8_layers(), df.resnet20_layers()):
        by = {l.name: l for l in layers}
        i = 0
        while f"c{i}_0" in by:
            l0, ds = by[f"c{i}_0"], f"ds{i}" in by
            for c in [KernelConfig()] + tspace.block_space(l0, 8, ds):
                fused = tcost.block_cost(l0, 8, c, downsample=ds)
                unfused = tcost.block_cost(l0, 8, c, downsample=ds,
                                           fused=False)
                assert fused.hbm_bytes < unfused.hbm_bytes, l0.name
                assert fused.modeled_s < unfused.modeled_s, l0.name
                assert fused.arithmetic_intensity > \
                    unfused.arithmetic_intensity
            i += 1


def test_cost_model_rewards_tiling():
    """The weights restaged per thread block shrink as a band or a batch
    tile grows, with the thread blocks; the activation term does not
    move."""
    from repro_torch.kernels.conv_stem.ops import BLOCKS_PER_SM
    assert tcost.STEM_BLOCKS_PER_SM == BLOCKS_PER_SM
    layer = df.resnet8_layers()[0]
    costs = [tcost.stem_cost(layer, 8, KernelConfig(band_rows=b))
             for b in (1, 2, 4, 8)]
    hbm = [c.hbm_bytes for c in costs]
    assert hbm == sorted(hbm, reverse=True) and hbm[0] > hbm[-1]
    assert costs[0].thread_blocks > costs[-1].thread_blocks
    shapes = df.resnet_block_shapes(3)
    chains = [tcost.chain_cost(shapes, 32, KernelConfig(batch_tile=bt,
                                                        split=4), 16)
              for bt in (1, 2, 4, 8)]
    assert [c.hbm_bytes for c in chains] == \
        sorted((c.hbm_bytes for c in chains), reverse=True)
    assert [c.thread_blocks for c in chains] == [128, 64, 32, 16]
    assert len({c.macs for c in chains}) == 1
    # a launch that fills fewer slots runs on fewer tensor cores
    assert chains[-1].active < chains[0].active == 128 / 132
    assert tcost.model_cost(R.RESNET20, 32, {}, "cuda-stream")["stem"] \
        .launches == 1


def test_joint_candidates_dedup_and_always_include_default():
    for backend in ("cuda", "cuda-stream"):
        spaces = tspace.model_space(R.RESNET8, batch=4, backend=backend)
        ranked = T.rank_spaces(R.RESNET8, 4, spaces, backend)
        cands = T.joint_candidates(ranked, top_k=3)
        default = {t: KernelConfig() for t in ranked}
        assert default in cands and cands[-1] == default
        assert len({json.dumps({t: c.to_dict()
                                for t, c in sorted(x.items())})
                    for x in cands}) == len(cands)
        best = cands[0]
        for task, lst in ranked.items():
            assert best[task] == lst[0]
            modeled = [tcost.task_cost(R.RESNET8, 4, backend, task,
                                       c).modeled_s for c in lst]
            assert modeled == sorted(modeled)


# ---------------------------------------------------------------------------
# search + compile integration
# ---------------------------------------------------------------------------


def test_annotate_tuning_flows_into_the_plan_and_the_launches(qp8):
    g = lowering.optimized_graph(R.RESNET8)
    tuning = {"stem": KernelConfig(band_rows=4),
              "block1": {"band_rows": 2}}          # dict form (cache load)
    lowering.annotate_tuning(g, tuning)
    plan = lowering.plan_model(g)
    assert plan.stem.config == KernelConfig(band_rows=4)
    assert plan.blocks[0].config is None            # untouched task
    assert plan.blocks[1].config == KernelConfig(band_rows=2)
    cm = compile_model(R.RESNET8, qp8, tune=tuning, device="cpu")
    steps = cm.backend.features(cm.graph, R.RESNET8, cm.params).steps
    assert [s.config for s in steps[1:]] == \
        [KernelConfig(), KernelConfig(band_rows=2), KernelConfig()]
    stream = compile_model(R.RESNET8, qp8, backend="cuda-stream",
                           tune={"stem": dict(split=2, batch_tile=2)},
                           device="cpu")
    chain, = stream.backend.features(stream.graph, R.RESNET8,
                                     stream.params).steps
    assert chain.tiling(8) == (2, 2) and chain.tiling(1) == (1, 2)


def test_compile_model_normalizes_cache_style_dict_tuning(qp8):
    cm = compile_model(R.RESNET8, qp8, backend="torch-int",
                       batch_sizes=(2,), device="cpu",
                       tune={"stem": {"band_rows": 2},
                             "block0": KernelConfig(band_rows=2)})
    assert cm.tuning["stem"] == KernelConfig(band_rows=2)
    assert cm.stats()["tuning"]["stem"] == {"band_rows": 2}
    assert compile_model(R.RESNET8, qp8, device="cpu").stats()["tuning"] \
        is None


def test_search_analytic_only_skips_device_timing(qp8, cache_file):
    res = T.search(R.RESNET8, qp8, batch=4, device=False, validate=False,
                   target="cpu")
    assert res.source == "analytic" and res.timings_us == {}
    assert set(res.tuning) == {"stem", "block0", "block1", "block2"}
    assert res.space_size > 1 and res.candidates >= 2
    assert set(res.modeled) == set(res.tuning)
    res2 = T.search(R.RESNET8, qp8, batch=4, device=False, validate=False,
                    target="cpu")
    assert res2.source == "cache" and res2.tuning == res.tuning
    assert T.model_key(R.RESNET8, 4, "cuda", "cpu") != \
        T.model_key(R.RESNET8, 8, "cuda", "cpu")
    assert T.model_key(R.RESNET8, 4, "cuda", "cpu") != \
        T.model_key(R.RESNET8, 4, "cuda-stream", "cpu")
    assert T.device_kind("cpu") == "cpu"


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_search_times_candidates_and_validates(qp8, cache_file, backend):
    """The device stage on the CPU's plain versions: every candidate raced
    against the incumbent, the winner validated bitwise against torch-int
    and cached; a second search is answered from the cache."""
    res = T.search(R.RESNET8, qp8, backend=backend, batch=2, top_k=2,
                   reps=1, calls=1, target="cpu")
    assert res.source == "device"
    assert "default" in res.timings_us and len(res.timings_us) >= 2
    assert all(us > 0 for us in res.timings_us.values())
    again = T.search(R.RESNET8, qp8, backend=backend, batch=2,
                     target="cpu")
    assert again.source == "cache" and again.tuning == res.tuning
    assert again.cache_stats["hits"] == 1


def test_search_falls_back_to_the_default_when_validation_fails(
        qp8, cache_file, monkeypatch):
    monkeypatch.setattr(tsearch, "_same_logits", lambda a, b: False)
    res = T.search(R.RESNET8, qp8, batch=2, top_k=2, reps=1, calls=1,
                   target="cpu", use_cache=False)
    assert res.source == "device-fallback"
    assert all(c == KernelConfig() for c in res.tuning.values())
    res = T.search(R.RESNET8, qp8, batch=2, device=False, target="cpu",
                   use_cache=False)
    assert res.source == "analytic-fallback"


def test_tuned_compile_bitexact_on_all_backends(qp8, cache_file):
    """The searched config is bitwise with the default path on every
    integer backend (cuda tuned == cuda default == torch-int)."""
    cfg = R.RESNET8
    xs = images(4, seed=9)
    res = T.search(cfg, qp8, batch=4, device=False, validate=False,
                   target="cpu")
    assert any(c.to_dict() for c in res.tuning.values())
    cm_t = compile_model(cfg, qp8, batch_sizes=(4,), tune=res,
                         device="cpu")                   # TuneResult form
    cm_d = compile_model(cfg, qp8, batch_sizes=(4,), device="cpu")
    cm_i = compile_model(cfg, qp8, backend="torch-int", batch_sizes=(4,),
                         tune=res.tuning, device="cpu")  # no-op knobs
    out_t = cm_t(xs)
    assert torch.equal(out_t, cm_d(xs)) and torch.equal(out_t, cm_i(xs))
    assert cm_t.stats()["tuning"] is not None
    assert cm_d.stats()["tuning"] is None
    auto = compile_model(cfg, qp8, batch_sizes=(1, 4), tune="auto",
                         device="cpu")                   # a cache hit
    assert auto.tuning == res.tuning


def test_search_modes_need_a_gpu_unless_asked_for_the_cpu(qp8, cache_file,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tune in ("device", "auto", "analytic"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_model(R.RESNET8, qp8, tune=tune)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.search(R.RESNET8, qp8, device=False)
    cm = compile_model(R.RESNET8, qp8, batch_sizes=(2,), tune="analytic",
                       device="cpu")
    assert cm.tuning and cm.device.type == "cpu"


def test_search_modes_cover_conv_configs_only():
    cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=8)
    params = init_lm_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="conv configs only"):
        compile_model(cfg, params, batch_sizes=(1,), tune="auto",
                      device="cpu")
    key = next(lowering.tuning_key(n) for n in lowering.optimized_graph(
        cfg).nodes if lowering.tuning_key(n))
    cm = compile_model(cfg, params, batch_sizes=(1,), device="cpu",
                       tune={key: {"bm": 64}})
    assert cm.stats()["tuning"] == {key: {"bm": 64}}


def test_tune_cli_analytic_only(cache_file, capsys):
    from repro_torch.tune.__main__ import main
    main(["--arch", "resnet8", "--batch", "4", "--analytic-only",
          "--no-validate", "--device", "cpu", "--json",
          str(cache_file.parent / "res.json")])
    out = capsys.readouterr().out
    assert "joint space 4235" in out and "source=analytic" in out
    res = json.loads((cache_file.parent / "res.json").read_text())
    assert res["source"] == "analytic" and set(res["tuning"]) == \
        {"stem", "block0", "block1", "block2"}
    main(["--arch", "resnet20", "--backend", "cuda-stream", "--batch", "32",
          "--analytic-only", "--no-validate", "--no-cache", "--device",
          "cpu"])
    assert "cuda-stream: 13 legal per-task configs" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# the tuned half of tests/test_conformance.py, on the kernel backends
# ---------------------------------------------------------------------------

BUCKETS = (1, 3)
BATCHES = (1, 3, 5)
CFGS = {"resnet8": (R.RESNET8, JR.RESNET8), "resnet20": (R.RESNET20,
                                                         JR.RESNET20)}


def tuned_variant(cfg):
    """A deliberately non-default (but always legal) tuning: short bands
    for the stem and every block, and a split of 2 for a chain headed by
    the stem.  ``normalize`` snaps the knobs at every bucket."""
    tuning = {"stem": dict(band_rows=3, split=2)}
    for i in range(3 * cfg.blocks_per_stage):
        tuning[f"block{i}"] = dict(band_rows=1 + i % 3)
    return tuning


@pytest.fixture(scope="module")
def conformance():
    cache = {}

    def cell(arch, backend, variant):
        k = (arch, backend, variant)
        if k not in cache:
            cfg, jcfg = CFGS[arch]
            qp = params_from_numpy(np_qparams(jcfg, seed=11))
            cm = compile_model(cfg, qp, backend=backend, batch_sizes=BUCKETS,
                               tune=tuned_variant(cfg) if variant else None,
                               device="cpu")
            xs = images(max(BATCHES), seed=3)
            cache[k] = (cm, {n: cm(xs[:n]) for n in BATCHES})
        return cache[k]

    return cell


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
@pytest.mark.parametrize("arch", list(CFGS))
def test_tuned_kernel_backend_bit_exact_with_torch_int(conformance, arch,
                                                       backend, n):
    _, tuned = conformance(arch, backend, True)
    _, ref = conformance(arch, "torch-int", False)
    assert torch.equal(tuned[n], ref[n])


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
@pytest.mark.parametrize("arch", list(CFGS))
def test_tuned_config_actually_differs_from_default(conformance, arch,
                                                    backend):
    """Guard against the tuned variant normalizing back to the default (the
    tuned half of the matrix would be vacuous): the tuning reaches the
    launches, and every bucket ran once per capture."""
    cm, _ = conformance(arch, backend, True)
    assert cm.tuning and any(c.to_dict() for c in cm.tuning.values())
    steps = cm.backend.features(cm.graph, cm.cfg, cm.params).steps
    if backend == "cuda":
        assert [s.config.band_rows for s in steps[1:]] == \
            [1 + i % 3 for i in range(3 * cm.cfg.blocks_per_stage)]
    else:
        chain, = steps
        assert [chain.tiling(b) for b in BUCKETS] == [(1, 2), (1, 2)]
    assert sorted(cm._execs) == sorted(BUCKETS)
    assert all(v == 1 for v in cm.trace_counts.values())
