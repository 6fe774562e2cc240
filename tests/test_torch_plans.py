"""Graph IR and lowering plans: the port's optimized graphs and
``plan_model`` equal the JAX package's node for node and task for task, and
graph/params mismatches raise the same ``LoweringError``."""
import dataclasses
import random

import pytest
from test_torch_slice import jax_params, np_qparams

from repro.compile import lowering as JL
from repro.core import graph as JG
from repro.models import resnet as JR
from repro_torch.compile import lowering as L
from repro_torch.compile import params_from_numpy
from repro_torch.core import graph as G
from repro_torch.models import resnet as R

CFGS = [("resnet8", 1), ("resnet20", 3)]


def _node_view(n):
    return (n.name, n.op, list(n.inputs), list(n.outputs), dict(n.attrs),
            list(n.fused), n.skip_out, n.skip_in)


@pytest.mark.parametrize("name,bps", CFGS)
@pytest.mark.parametrize("optimized", [False, True])
def test_graph_matches_jax_node_for_node(name, bps, optimized):
    g, jg = G.build_resnet_graph(bps), JG.build_resnet_graph(bps)
    if optimized:
        g, jg = G.optimize(g), JG.optimize(jg)
    assert [_node_view(n) for n in g.nodes] == \
        [_node_view(n) for n in jg.nodes]
    assert [n.name for n in G.topological_sort(g)] == \
        [n.name for n in JG.topological_sort(jg)]


def _task_view(t):
    return (t.index, t.conv0, t.conv1, t.stride, t.has_ds, t.och)


@pytest.fixture(scope="module")
def jax_qparams():
    return {name: jax_params(np_qparams(getattr(JR, name.upper()), seed=1))
            for name, _ in CFGS}


@pytest.mark.parametrize("name,bps", CFGS)
def test_plan_model_matches_jax_task_for_task(name, bps, jax_qparams):
    jqp = jax_qparams[name]
    plan = L.plan_model(L.optimized_graph(getattr(R, name.upper())),
                        params_from_numpy(jqp.to_dict()))
    jplan = JL.plan_model(JL.optimized_graph(getattr(JR, name.upper())), jqp)
    assert [_task_view(t) for t in plan.blocks] == \
        [_task_view(t) for t in jplan.blocks]
    assert (plan.stem.node, plan.stem.och) == (jplan.stem.node,
                                               jplan.stem.och)
    assert plan.stem.config is None and \
        all(t.config is None for t in plan.blocks)
    assert dataclasses.astuple(plan.head) == dataclasses.astuple(jplan.head)
    assert len(plan.blocks) == 3 * bps


def test_shuffled_node_list_lowers_to_the_same_plan():
    g = G.optimize(G.resnet20_graph())
    ref = [_task_view(t) for t in L.plan_model(g).blocks]
    random.Random(0).shuffle(g.nodes)
    assert [_task_view(t) for t in L.plan_model(g).blocks] == ref


def _raises_same(port_call, jax_call):
    with pytest.raises(L.LoweringError) as port_err:
        port_call()
    with pytest.raises(JL.LoweringError) as jax_err:
        jax_call()
    assert str(port_err.value) == str(jax_err.value)


def test_block_count_mismatch_raises_same_error(jax_qparams):
    jqp = jax_qparams["resnet8"]
    _raises_same(
        lambda: L.plan_model(L.optimized_graph(R.RESNET20),
                             params_from_numpy(jqp.to_dict())),
        lambda: JL.plan_model(JL.optimized_graph(JR.RESNET20), jqp))


def test_downsample_mismatch_raises_same_error(jax_qparams):
    jqp = jax_qparams["resnet8"]
    blocks = list(jqp.blocks)
    blocks[1] = dataclasses.replace(blocks[1], ds=None)
    jbad = dataclasses.replace(jqp, blocks=tuple(blocks))
    _raises_same(
        lambda: L.plan_model(L.optimized_graph(R.RESNET8),
                             params_from_numpy(jbad.to_dict())),
        lambda: JL.plan_model(JL.optimized_graph(JR.RESNET8), jbad))


@pytest.mark.parametrize("stage", ["unoptimized", "no_add_fold",
                                   "no_loop_merge"])
def test_unoptimized_graphs_raise_same_error(stage):
    def build(gm):
        g = gm.build_resnet_graph(1)
        if stage == "unoptimized":
            return g
        g = gm.merge_relu(gm.fold_bn(g))
        if stage == "no_add_fold":
            return gm.temporal_reuse(gm.loop_merge(g))
        # residual adds folded by hand, the downsample left standalone
        g = gm.temporal_reuse(g)
        return gm.add_fold(g)

    _raises_same(lambda: L.plan_model(build(G)),
                 lambda: JL.plan_model(build(JG)))
