"""Tensor parallelism over 'model' in the port (``parallel.ctx``'s
``model_part`` / ``to_model`` / ``model_sum``; ``models.layers``'
``gqa_split``, ``mlp_apply``, ``row_parallel``, ``vocab_part`` and the
vocabulary-parallel ``chunked_xent``), in spawned gloo worlds on a
(2, 2) and a (1, 2) ``("data", "model")`` mesh (``_torch_worlds.tp_world``):

  * two ``make_train_step`` steps (``grad_accum=2``, float and int8
    moments) of the gemma-2b (MQA: each rank's two query heads read the
    one K/V head), granite-8b (GQA: K/V heads split) and whisper-large-v3
    (encoder, decoder and cross-attention) smoke configs within ``TOL``
    of the unsharded step's parameters, the losses within ``TOL`` of the
    unsharded ones and of the JAX package's single-device step, with
    attention, the MLP and the logits split;
  * QAT gradients (``quant="qat"``: each split weight's fake-quantization
    range is the whole leaf's, a max over 'model') within ``TOL``;
  * the add-fold's ``acc_init`` added once after the reduce over 'model'
    (with the block's output weight zero the output is the skip stream);
  * the vocabulary-parallel cross entropy (tied and untied tables, a
    softcap, ignored labels) equal to the whole-vocabulary one, value and
    gradients;
  * each rank's ``FlopCounterMode`` flops of an MLP block (forward and
    backward) within 1% of the whole block's over the 'model' extent;
  * on a (1, 4) mesh, heads that share a factor with 'model' without
    dividing it (2 heads reading one K/V head; 6 heads over 2 K/V heads)
    split ``gcd(heads, 4) = 2`` ways, each group's first rank alone
    entering the reduce: gradients within ``TOL`` of the unsharded ones.
"""
import numpy as np
import pytest
import torch
from test_torch_lm_float import both
from test_torch_parallel_train import HP, _jax_losses

from _torch_dist import run_world, value
from _torch_worlds import tp_world

TOL = 1e-4
TP_ARCHS = ["gemma-2b", "granite-8b", "whisper-large-v3"]
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    return {a: both(a) for a in TP_ARCHS}


@pytest.fixture(scope="module", params=list(MESHES))
def world(request, pairs, tmp_path_factory):
    D, M = MESHES[request.param]
    inp = dict(mesh=(D, M), params={a: p[3] for a, p in pairs.items()},
               hp=HP, qat=["gemma-2b", "granite-8b"])
    return run_world(tp_world, D * M, tmp_path_factory.mktemp("tp"), inp)


PARTIAL = {"gemma-2b": dict(num_heads=2, num_kv_heads=1),
           "granite-8b": dict(num_heads=6, num_kv_heads=2)}


@pytest.fixture(scope="module")
def partial_world(tmp_path_factory):
    return run_world(tp_world, 4, tmp_path_factory.mktemp("tp14"),
                     dict(mesh=(1, 4), partial=PARTIAL))


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale <= tol


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_steps_match_unsharded(world, pairs, arch, int8):
    v = value(world, f"steps/{arch}/{'int8' if int8 else 'float'}")
    assert {"attention", "mlp", "logits"} <= set(v["kinds"]["split"]), \
        v["kinds"]
    assert "attention" not in v["kinds"]["repeat"]
    for a, b in zip(v["uparams"], v["params"]):
        off = np.abs(b - a) > TOL * np.abs(a).max()
        if int8:
            # where an int8 moment landed a quantum apart, that entry's step
            # differs, as tests/test_torch_parallel_train.py allows
            assert off.mean() <= 1e-3
            assert np.all(np.abs(b - a)[off] <= HP["lr"] * 2)
        else:
            assert not off.any(), np.abs(b - a).max()
    for got, own in zip(v["losses"], v["ulosses"]):
        assert abs(got - own) <= TOL * max(1.0, abs(own))
    if not int8:
        for got, want in zip(v["losses"], _jax_losses(arch, pairs, False)):
            assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


def _grads_close(v):
    l0, l1 = v["loss"]
    assert abs(l1 - l0) <= TOL * max(1.0, abs(l0))
    for a, b in zip(v["grads"], v["sharded"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert _close(b, a), np.abs(b - a).max()


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-8b"])
def test_tp_qat_gradients_match_unsharded(world, arch):
    v = value(world, f"qat/{arch}")
    assert {"attention", "mlp", "logits"} <= set(v["kinds"]["split"])
    _grads_close(v)


@pytest.mark.parametrize("arch", list(PARTIAL))
def test_tp_heads_split_over_a_common_factor(partial_world, arch):
    v = value(partial_world, f"partial/{arch}")
    assert v["kinds"]["split"]["attention"] == 2, v["kinds"]
    assert v["kinds"]["split"]["mlp"] == 4
    assert "attention" not in v["kinds"]["repeat"]
    _grads_close(v)


@pytest.mark.parametrize("case", ["zero", "whole"])
def test_add_fold_enters_once(world, case):
    v = value(world, "add_fold")[case]
    assert {"attention", "mlp"} <= set(v["kinds"]["split"])
    for kind in ("mlp", "attn"):
        want, got = v[kind]
        if case == "zero":
            # the output weight is zero: what comes out is the skip once
            np.testing.assert_array_equal(got, v["skip"])
            np.testing.assert_array_equal(want, v["skip"])
        else:
            assert _close(got, want, 1e-5), np.abs(got - want).max()


@pytest.mark.parametrize("table", ["tied", "untied"])
def test_vocab_parallel_xent_equals_whole_vocab(world, table):
    v = value(world, "vocab_xent")[table]
    (s0, s1), (c0, c1) = v["loss"], v["count"]
    assert c0 == c1
    assert abs(s1 - s0) <= 1e-5 * abs(s0)
    g0, g1 = v["grad"]
    assert _close(g1, g0, 1e-5)
    gh0, gh1 = v["grad_h"]
    assert _close(gh1, gh0, 1e-5)
    assert v["v0"] is not None


def test_mlp_block_flops_split_over_model(world):
    v = value(world, "mlp_flops")
    want = v["whole"] / v["tp"]
    assert abs(v["rank"] - want) <= 0.01 * want, v
