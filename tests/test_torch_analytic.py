"""The paper's analytic models in the port, held exactly against the JAX
package: every ``core.dataflow`` formula over the ResNet8/20 layers and the
shapes of tests/test_dataflow.py and tests/test_graph.py, ``core.ilp``
(``balance``, ``solve``, ``balanced_och_par``, ``predict_fps`` for both
networks on both boards), ``core.graph.skip_buffer_report`` and
``compile.lowering``'s ``tuning_key`` / ``annotate_tuning`` over the
gemma-2b and falcon-mamba-7b smoke graphs.  Results must be equal, not
close: the formulas are integer or the same float expression."""
import dataclasses
import itertools

import pytest

from repro.compile import lm_params as JLP
from repro.compile import lowering as JL
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import dataflow as jdf
from repro.core import graph as JG
from repro.core import ilp as jilp
from repro.tune.config import KernelConfig as JKernelConfig
from repro_torch.compile import lm_config, lowering
from repro_torch.configs import get_smoke_config
from repro_torch.core import dataflow as df
from repro_torch.core import graph as G
from repro_torch.core import ilp
from repro_torch.tune.config import KernelConfig

# (iw, ich, fh, fw): tests/test_dataflow.py's sweep corners and the paper's
# block dimensions (tests/test_graph.py)
WINDOWS = [(4, 1, 1, 1), (4, 64, 5, 5), (64, 1, 3, 5), (32, 16, 3, 3),
           (16, 32, 3, 3), (8, 64, 3, 3), (32, 3, 3, 3), (17, 7, 5, 1)]
# (h, w, ich, och, downsample, stride): ResNet20's block shapes and the
# block of tests/test_dataflow.py's fusion check
BLOCKS = [(32, 32, 16, 16, False, 1), (32, 32, 16, 32, True, 2),
          (16, 16, 32, 32, False, 1), (16, 16, 32, 64, True, 2),
          (8, 8, 64, 64, False, 1), (32, 32, 16, 32, False, 1)]
BATCHES = [(1, 1), (4, 1), (4, 4), (8, 2), (32, 1), (32, 8)]
NETS = {"resnet8": 1, "resnet20": 3}


def _conv_layers():
    return [layer for bps in NETS.values()
            for layer in df.resnet_layers(bps)]


def _jax_layer(layer):
    return jdf.ConvLayer(**dataclasses.asdict(layer))


@pytest.mark.parametrize("iw,ich,fh,fw", WINDOWS)
def test_buffer_formulas_equal_jax(iw, ich, fh, fw):
    for ow_par in (1, 2):
        assert df.window_buffer_size(iw, ich, fh, fw, ow_par) == \
            jdf.window_buffer_size(iw, ich, fh, fw, ow_par)
    assert df.fifo_partition(iw, ich, fh, fw) == \
        jdf.fifo_partition(iw, ich, fh, fw)
    assert df.receptive_field(fh, fw, 3, 3) == \
        jdf.receptive_field(fh, fw, 3, 3)
    assert df.skip_buffer_receptive_field(iw, ich, fh, fw, 3, 3) == \
        jdf.skip_buffer_receptive_field(iw, ich, fh, fw, 3, 3)
    assert df.skip_buffer_optimized(iw, ich, fh, fw) == \
        jdf.skip_buffer_optimized(iw, ich, fh, fw)
    for iw1, ich1 in ((iw, ich), (max(1, iw // 2), ich * 2)):
        assert df.skip_buffer_ratio(iw, ich, fh, fw, iw1, ich1, 3, 3) == \
            jdf.skip_buffer_ratio(iw, ich, fh, fw, iw1, ich1, 3, 3)


@pytest.mark.parametrize("bps", sorted(NETS.values()))
def test_resnet_layer_tables_equal_jax(bps):
    for base, img in ((16, 32), (8, 16)):
        port = df.resnet_layers(bps, base, img)
        ref = jdf.resnet_layers(bps, base, img)
        assert [dataclasses.asdict(a) for a in port] == \
            [dataclasses.asdict(b) for b in ref]
        assert df.total_gops(port) == jdf.total_gops(ref)
        assert [dataclasses.asdict(b) for b in
                df.resnet_block_shapes(bps, base, img)] == \
            [dataclasses.asdict(b) for b in
             jdf.resnet_block_shapes(bps, base, img)]
    fixed = df.resnet8_layers() if bps == 1 else df.resnet20_layers()
    jfixed = jdf.resnet8_layers() if bps == 1 else jdf.resnet20_layers()
    assert [dataclasses.asdict(a) for a in fixed] == \
        [dataclasses.asdict(b) for b in jfixed]


@pytest.mark.parametrize("index", range(len(_conv_layers())))
def test_conv_layer_model_and_task_bytes_equal_jax(index):
    layer = _conv_layers()[index]
    ref = _jax_layer(layer)
    assert (layer.c, layer.k, layer.macs, layer.weights) == \
        (ref.c, ref.k, ref.macs, ref.weights)
    for och_par, ow_par in itertools.product((1, 2, 4, 16), (1, 2)):
        assert layer.cp(och_par, ow_par) == ref.cp(och_par, ow_par)
        assert layer.latency_cycles(och_par, ow_par) == \
            ref.latency_cycles(och_par, ow_par)
        for freq in (214e6, 274e6):
            assert df.throughput_fps(layer, och_par, freq, ow_par) == \
                jdf.throughput_fps(ref, och_par, freq, ow_par)
    for batch, bt in BATCHES:
        assert df.conv_task_hbm_bytes(layer, batch, bt) == \
            jdf.conv_task_hbm_bytes(ref, batch, bt)
        for cb in (0, 8, layer.och):
            assert df.conv_task_vmem_bytes(layer, bt, cb) == \
                jdf.conv_task_vmem_bytes(ref, bt, cb)


@pytest.mark.parametrize("h,w,ich,och,ds,stride", BLOCKS)
def test_block_and_chain_bytes_equal_jax(h, w, ich, och, ds, stride):
    for fused in (True, False):
        assert df.residual_block_hbm_bytes(
            h, w, ich, och, fused=fused, downsample=ds, stride=stride) == \
            jdf.residual_block_hbm_bytes(h, w, ich, och, fused=fused,
                                         downsample=ds, stride=stride)
    for batch, bt in BATCHES:
        assert df.resblock_task_hbm_bytes(
            h, w, ich, och, batch, bt, downsample=ds, stride=stride) == \
            jdf.resblock_task_hbm_bytes(h, w, ich, och, batch, bt,
                                        downsample=ds, stride=stride)
        assert df.resblock_task_vmem_bytes(
            h, w, ich, och, bt, downsample=ds, stride=stride) == \
            jdf.resblock_task_vmem_bytes(h, w, ich, och, bt, downsample=ds,
                                         stride=stride)


@pytest.mark.parametrize("bps", sorted(NETS.values()))
@pytest.mark.parametrize("batch,batch_tile", BATCHES)
def test_chain_bytes_of_every_resnet_chain_equal_jax(bps, batch, batch_tile):
    port = df.resnet_block_shapes(bps)
    ref = jdf.resnet_block_shapes(bps)
    for lo, hi in itertools.combinations(range(len(port) + 1), 2):
        for stem_och in ((0, 16) if lo == 0 else (0,)):
            p, r = port[lo:hi], ref[lo:hi]
            assert df.chain_task_hbm_bytes(p, batch, batch_tile,
                                           stem_och=stem_och) == \
                jdf.chain_task_hbm_bytes(r, batch, batch_tile,
                                         stem_och=stem_och)
            assert df.chain_task_vmem_bytes(p, batch_tile,
                                            stem_och=stem_och) == \
                jdf.chain_task_vmem_bytes(r, batch_tile, stem_och=stem_och)
            assert df.chain_saved_hbm_bytes(p, batch) == \
                jdf.chain_saved_hbm_bytes(r, batch)


# (M, K, N) of the smoke and published LM projections, tiles
MATMULS = [(32, 64, 256), (2048, 2048, 2048), (2048, 2048, 256),
           (2048, 16384, 2048), (2048, 4096, 16384), (129, 30, 200)]


@pytest.mark.parametrize("M,K,N", MATMULS)
def test_lm_task_bytes_equal_jax(M, K, N):
    for bm, bn, bk in ((128, 128, 128), (64, 256, 32), (0, 0, 0),
                       (M, N, K)):
        for acc in (False, True):
            assert df.matmul_task_hbm_bytes(M, K, N, bm, bn, bk,
                                            acc_init=acc) == \
                jdf.matmul_task_hbm_bytes(M, K, N, bm, bn, bk, acc_init=acc)
        assert df.matmul_task_vmem_bytes(bm, bn, bk) == \
            jdf.matmul_task_vmem_bytes(bm, bn, bk)
    S, hd = min(M, 512), min(K, 256)
    for bq, bk in ((64, 64), (128, 32), (0, 0)):
        assert df.attention_task_hbm_bytes(M // S or 1, S, S, hd, bq, bk) \
            == jdf.attention_task_hbm_bytes(M // S or 1, S, S, hd, bq, bk)
        assert df.attention_task_vmem_bytes(S, hd, bq, bk) == \
            jdf.attention_task_vmem_bytes(S, hd, bq, bk)
    for bd in (1, 128, N):
        assert df.scan_task_hbm_bytes(4, S, N, 16, bd) == \
            jdf.scan_task_hbm_bytes(4, S, N, 16, bd)
        assert df.scan_task_vmem_bytes(S, 16, bd) == \
            jdf.scan_task_vmem_bytes(S, 16, bd)


def _alloc_rows(sol):
    return [(dataclasses.asdict(a.layer), a.och_par, a.ow_par, a.cp, a.dsp,
             a.cycles_per_frame) for a in sol.allocations]


def _solution(sol):
    return (_alloc_rows(sol), sol.n_par, sol.freq_hz, sol.dsp_used,
            sol.bottleneck_cycles, sol.fps, sol.gops, sol.latency_s)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("platform", sorted(jilp.PLATFORMS))
def test_predict_fps_equals_jax(net, platform):
    """The paper's FPGA model of each board (``PLATFORMS``), not a chip
    measurement: the same allocation and frames per second."""
    assert ilp.PLATFORMS == jilp.PLATFORMS
    layers = df.resnet_layers(NETS[net])
    port = ilp.predict_fps(layers, platform)
    ref = jilp.predict_fps([_jax_layer(x) for x in layers], platform)
    assert _solution(port) == _solution(ref)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("pow2", [False, True])
def test_balance_solve_and_balanced_och_par_equal_jax(net, pow2):
    layers = df.resnet_layers(NETS[net])
    jlayers = [_jax_layer(x) for x in layers]
    for ow_par in (1, 2):
        assert ilp.balanced_och_par(layers, pow2, ow_par) == \
            jilp.balanced_och_par(jlayers, pow2, ow_par)
        for p in (1, 2, 3, 8, 64):
            assert ilp.balance(layers, p, ow_par, pow2) == \
                jilp.balance(jlayers, p, ow_par, pow2)
    for n_par, freq, bw in ((360, 214e6, float("inf")), (1248, 274e6, 640),
                            (64, 100e6, float("inf")), (1, 1e8, 1)):
        assert _solution(ilp.solve(layers, n_par, freq, pow2=pow2,
                                   weight_bw=bw)) == \
            _solution(jilp.solve(jlayers, n_par, freq, pow2=pow2,
                                 weight_bw=bw))


@pytest.mark.parametrize("bps", sorted(NETS.values()))
def test_skip_buffer_report_equals_jax(bps):
    port = G.skip_buffer_report(G.build_resnet_graph(bps),
                                G.optimize(G.build_resnet_graph(bps)))
    ref = JG.skip_buffer_report(JG.build_resnet_graph(bps),
                                JG.optimize(JG.build_resnet_graph(bps)))
    assert port == ref and len(port) == 3 * bps
    assert all(0.4 < r["ratio"] < 0.6 for r in port)   # eq. 23


def _lm_graphs(name):
    cfg = lm_config(get_smoke_config(name), seq_len=16)
    jcfg = JLP.lm_config(jax_smoke_config(name), seq_len=16)
    return lowering.optimized_graph(cfg), JL.optimized_graph(jcfg)


@pytest.mark.parametrize("name", ["gemma-2b", "falcon-mamba-7b",
                                  "resnet20"])
def test_tuning_key_and_annotate_tuning_equal_jax(name):
    if name == "resnet20":
        g, jg = G.optimize(G.resnet20_graph()), JG.optimize(
            JG.resnet20_graph())
    else:
        g, jg = _lm_graphs(name)
    keys = [lowering.tuning_key(n) for n in g.nodes]
    assert keys == [JL.tuning_key(n) for n in jg.nodes]
    tunable = sorted(k for k in keys if k is not None)
    assert tunable and len(set(tunable)) == len(tunable)
    tuning = {k: dict(batch_tile=2, cout_block=8, bm=64)
              for k in tunable[::2]}
    tuning.update({k: KernelConfig(bn=128) for k in tunable[1::2]})
    jtuning = {k: (JKernelConfig(**c.to_dict())
                   if isinstance(c, KernelConfig) else c)
               for k, c in tuning.items()}
    lowering.annotate_tuning(g, tuning)
    JL.annotate_tuning(jg, jtuning)
    stamped = [n.attrs.get("kcfg") for n in g.nodes]
    assert [c.to_dict() if c else None for c in stamped] == \
        [n.attrs["kcfg"].to_dict() if "kcfg" in n.attrs else None
         for n in jg.nodes]
    assert all(isinstance(c, KernelConfig) for c in stamped if c)
    assert lowering.annotate_tuning(g, None) is g


@pytest.mark.parametrize("name", ["gemma-2b", "falcon-mamba-7b"])
def test_annotated_configs_reach_the_lm_plan(name):
    g, _ = _lm_graphs(name)
    keys = {lowering.tuning_key(n) for n in g.nodes} - {None}
    cfgs = {k: KernelConfig(bm=64 + i) for i, k in enumerate(sorted(keys))}
    plan = lowering.plan_lm(lowering.annotate_tuning(g, cfgs))
    role = {"attention": "attn", "scan": "scan"}
    for t in plan.tasks:
        key = f"layer{t.layer}/{getattr(t, 'role', role.get(t.kind))}"
        assert t.config == cfgs[key], key


def test_annotated_configs_reach_the_conv_plan():
    g = G.optimize(G.resnet20_graph())
    cfgs = {"stem": KernelConfig(batch_tile=4),
            **{f"block{i}": KernelConfig(batch_tile=i + 1)
               for i in range(9)}}
    plan = lowering.plan_model(lowering.annotate_tuning(g, cfgs))
    assert plan.stem.config == cfgs["stem"]
    assert [t.config for t in plan.blocks] == \
        [cfgs[f"block{i}"] for i in range(9)]
    untuned = lowering.plan_model(G.optimize(G.resnet20_graph()))
    assert untuned.stem.config is None and \
        all(t.config is None for t in untuned.blocks)
