"""``CompiledModel``'s bucket discipline and compile accounting on the CPU,
the port's counterparts of tests/test_compile.py's cases: bucket
selection, pad and chunk; one executable and one trace a bucket across
repeated calls; ``compile_model(eager=True)`` builds every bucket; bad
buckets refused; ``run_placed`` bitwise the default path; ``stats()``
with the reference's keys.  The served logits are held against the JAX
package's ``lax-int`` ``CompiledModel`` on the same numpy inputs and
bridged params (within 1e-5, equal argmax), and the u8 maps of the bucket
runs against the JAX integer datapath bitwise.  On the CPU a bucket's
executable is the eager lowered forward; the CUDA graphs are held in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import images, jax_params, jax_u8_map, np_qparams

from repro.compile import compile_model as jax_compile_model
from repro.models import resnet as JR
from repro_torch.compile import (compile_model, lower_features,
                                 params_from_numpy)
from repro_torch.compile.compiler import EagerExecutable, resolve_device
from repro_torch.kernels import common
from repro_torch.models import resnet as R

LOGIT_ATOL = 1e-5
BACKENDS = ["cuda", "cuda-stream", "torch-int"]


@pytest.fixture(scope="module")
def qp8():
    return np_qparams(JR.RESNET8, seed=31, varied=True)


@pytest.fixture(scope="module")
def jcm8(qp8):
    return jax_compile_model(JR.RESNET8, jax_params(qp8), backend="lax-int",
                             batch_sizes=(2, 4))


def _close_to_jax(got, ref):
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bucket_selection_padding_and_chunking(qp8, jcm8, backend):
    cm = compile_model(R.RESNET8, params_from_numpy(qp8), backend=backend,
                       batch_sizes=(2, 4), device="cpu")
    assert cm.bucket_for(1) == 2 and cm.bucket_for(2) == 2
    assert cm.bucket_for(3) == 4 and cm.bucket_for(9) == 4
    imgs = images(5, seed=1)
    # short batch: padded to bucket 2, padding rows discarded
    _close_to_jax(cm(imgs[:1]), np.asarray(jcm8(imgs[:1])))
    assert sorted(cm._execs) == [2]
    # 3 rows select bucket 4
    _close_to_jax(cm(imgs[:3]), np.asarray(jcm8(imgs[:3])))
    assert sorted(cm._execs) == [2, 4]
    # an oversized batch is chunked through the largest bucket: 4, then 1
    out = cm(imgs)
    assert out.shape == (5, 10)
    _close_to_jax(out, np.asarray(jcm8(imgs)))
    assert cm.run_counts == {2: 2, 4: 2}
    assert cm.trace_counts == {2: 1, 4: 1} and cm.compile_count == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_u8_maps_of_the_bucket_runs_equal_jax(qp8, backend):
    """The batch a bucket run computes on (the caller's rows, zero rows up
    to the bucket) gives the JAX integer datapath's u8 map bitwise, pad
    rows included."""
    cm = compile_model(R.RESNET8, params_from_numpy(qp8), backend=backend,
                       batch_sizes=(2, 4), device="cpu")
    feats = lower_features(R.RESNET8, params_from_numpy(qp8), backend,
                           device="cpu")
    jqp = jax_params(qp8)
    for n in (1, 3, 4):
        batch = cm.pad(torch.from_numpy(images(n, seed=n)))
        assert batch.shape[0] == cm.bucket_for(n)
        got = feats(batch).numpy()
        ref = jax_u8_map(JR.RESNET8, jqp, batch.numpy())
        assert got.dtype == np.uint8 and got.any()
        np.testing.assert_array_equal(got, ref)


def test_no_retracing_across_repeated_calls(qp8):
    cm = compile_model(R.RESNET8, params_from_numpy(qp8), backend="cuda",
                       batch_sizes=(4,), device="cpu")
    imgs = images(4, seed=2)
    first = cm(imgs)
    for n in (4, 3, 4, 1):
        assert torch.equal(cm(imgs[:n]), first[:n])
    assert cm.trace_counts == {4: 1}
    assert cm.compile_count == 1 and cm.run_counts == {4: 5}
    assert cm.executable(4) is cm.executable(4)   # one executable, reused
    assert isinstance(cm.executable(4), EagerExecutable)


def test_eager_compile_builds_every_bucket(qp8):
    cm = compile_model(R.RESNET8, params_from_numpy(qp8), backend="cuda",
                       batch_sizes=(1, 2), eager=True, device="cpu")
    assert cm.compile_count == 2 and sorted(cm._execs) == [1, 2]
    assert cm.trace_counts == {1: 1, 2: 1}
    assert cm.run_counts == {1: 0, 2: 0}         # built, not run
    assert cm.warmup() is cm and cm.compile_count == 2


def test_compile_model_rejects_bad_buckets(qp8):
    qp = params_from_numpy(qp8)
    with pytest.raises(ValueError):
        compile_model(R.RESNET8, qp, batch_sizes=(), device="cpu")
    with pytest.raises(ValueError):
        compile_model(R.RESNET8, qp, batch_sizes=(0,), device="cpu")
    cm = compile_model(R.RESNET8, qp, batch_sizes=(2,), device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        cm.executable(3)
    with pytest.raises(ValueError, match="bucket"):
        cm.device_executable(3, "cpu")
    with pytest.raises(ValueError, match="empty"):
        cm(np.zeros((0, 32, 32, 3), np.float32))
    assert cm.compile_count == 0


@pytest.mark.parametrize("backend", ["cuda", "torch-int"])
def test_run_placed_is_bitwise_the_default_path(qp8, backend):
    cm = compile_model(R.RESNET8, params_from_numpy(qp8), backend=backend,
                       batch_sizes=(2, 4), device="cpu")
    imgs = images(7, seed=3)                     # 4, then 3 padded to 4
    ref = cm(imgs)
    got = cm.run_placed(imgs, "cpu")
    assert torch.equal(got, ref) and got.device == ref.device
    assert cm.run_placed(imgs[:1], torch.device("cpu")).equal(ref[:1])
    assert cm.stats()["placed"] == [(2, "cpu"), (4, "cpu")]
    # the placed executables are their own builds: a trace each
    assert cm.compile_count == 3 and cm.trace_counts == {4: 2, 2: 1}
    assert cm.device_executable(4, "cpu") is \
        cm.device_executable(4, torch.device("cpu"))


def test_stats_has_the_reference_keys(qp8, jcm8):
    """After the same calls the port's and the JAX package's ``stats()``
    agree on the buckets built and the traces; the port adds its device
    and the run counts."""
    imgs = images(3, seed=4)
    jcm = jax_compile_model(JR.RESNET8, jax_params(qp8), backend="lax-int",
                            batch_sizes=(2, 4))
    cm = compile_model(R.RESNET8, params_from_numpy(qp8), backend="cuda",
                       batch_sizes=(2, 4), device="cpu")
    for n in (3, 1, 3):
        cm(imgs[:n])
        jcm(jnp.asarray(imgs[:n]))
    s, js = cm.stats(), jcm.stats()
    assert set(s) == set(js) | {"device", "run_counts"}
    for key in ("batch_sizes", "compiled", "placed", "compile_count",
                "trace_counts", "tuning"):
        assert s[key] == js[key], key
    assert s["backend"] == "cuda" and s["device"] == "cpu"
    assert s["run_counts"] == {2: 1, 4: 2} and s["tuning"] is None


def test_resolve_device_names_one_card_one_way(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == resolve_device("cuda:0")
    assert resolve_device(torch.device("cuda", 1)) == \
        torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")


def test_launch_counter_helpers_replay_a_capture():
    """What ``CompiledModel`` does around a capture: read the counters,
    count a pass, take the delta, put the counters back, then add the
    delta once a replay."""
    ops = common.counted_ops()
    assert len(ops) == 7 and all(hasattr(op, "launches") for op in ops)
    saved = common.read_launches()
    try:
        stem, chain = ops[0], ops[2]
        before = common.read_launches()
        stem.launches += 1
        stem.launches_by_path["banded"] += 1
        chain.launches += 2
        delta = common.launch_delta(before, common.read_launches())
        assert delta[stem] == (1, {"banded": 1, "general": 0})
        assert delta[chain] == (2, {})
        common.write_launches(before)
        assert common.read_launches() == before
        for _ in range(3):
            common.add_launches(delta)
        after = common.read_launches()
        assert after[stem][0] == before[stem][0] + 3
        assert after[stem][1]["banded"] == before[stem][1]["banded"] + 3
        assert after[chain][0] == before[chain][0] + 6
        assert all(after[op] == before[op] for op in ops[3:] + ops[1:2])
    finally:
        common.write_launches(saved)
