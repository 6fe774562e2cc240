"""Scale-out serving through the port: ``ShardedResNetEngine`` (replica pool
+ deadline-based coalescing) on the CPU (the kernels' plain versions),
held against the port's ``ResNetEngine`` bitwise and against the JAX
package's ``ShardedResNetEngine`` on ``lax-int``; the cases of
tests/test_serve_sharded.py that need no SPMD, a two-replica pool on
``devices=["cpu", "cpu"]``, and the ``launch.serve`` CLI."""
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import images, jax_params, jax_u8_map, np_qparams

import repro_torch.serve.engine as E
from repro.models import resnet as JR
from repro.serve import ImageRequest as JImageRequest
from repro.serve import ShardedResNetEngine as JShardedResNetEngine
from repro_torch.compile import lower_forward, params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import resnet as R
from repro_torch.serve import (Backpressure, FakeClock, ImageRequest,
                               ResNetEngine, ShardedResNetEngine)
from repro_torch.tune.config import KernelConfig

CPU = ["cpu"]


@pytest.fixture(scope="module")
def np_qp8():
    return np_qparams(JR.RESNET8, seed=7)


@pytest.fixture(scope="module")
def qp8(np_qp8):
    return params_from_numpy(np_qp8)


@pytest.fixture(scope="module")
def imgs():
    return images(6, seed=1)


def _submit(eng, xs, **kw):
    reqs = [ImageRequest(rid=i, image=x) for i, x in enumerate(xs)]
    for r in reqs:
        eng.submit(r, **kw)
    return reqs


def _logits(reqs):
    return np.stack([r.logits for r in reqs])


def test_sharded_engine_bit_exact_with_single_device_cuda(qp8, imgs):
    """The sharded engine on a one-device pool gives exactly the logits of
    the cuda backend's forward: scheduling and placement never touch the
    arithmetic."""
    cfg = R.RESNET8
    ref = lower_forward(cfg, qp8, "cuda", device="cpu")(imgs).numpy()
    eng = ShardedResNetEngine(cfg, qp8, batch=4, backend="cuda",
                              devices=CPU, batch_sizes=(2, 4), slack_ms=1.0)
    reqs = _submit(eng, imgs, deadline_ms=500.0)
    eng.run()
    assert all(r.done for r in reqs)
    np.testing.assert_array_equal(_logits(reqs), ref)


def test_sharded_engine_matches_plain_engine(qp8, imgs):
    """Same requests through ResNetEngine and ShardedResNetEngine: identical
    logits and identical served counts, on both integer backends."""
    cfg = R.RESNET8
    for backend in ("torch-int", "cuda-stream"):
        plain = ResNetEngine(cfg, qp8, batch=3, backend=backend,
                             device="cpu")
        preqs = _submit(plain, imgs)
        plain.run()
        shard = ShardedResNetEngine(cfg, qp8, batch=3, backend=backend,
                                    devices=CPU, slack_ms=0.5)
        sreqs = _submit(shard, imgs)
        shard.run()
        assert shard.served == plain.served == len(imgs)
        np.testing.assert_array_equal(_logits(sreqs), _logits(preqs))


def test_sharded_engine_no_per_tick_retracing(qp8, imgs):
    """Per-device executables are built once and reused: serving many waves
    never grows the trace/compile counts; the default path's executables
    are never built."""
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="torch-int",
                              devices=CPU, batch_sizes=(1, 2), slack_ms=0.2)
    eng.pool.warmup()
    after_warmup = (dict(eng.model.trace_counts), eng.model.compile_count)
    assert after_warmup == ({1: 1, 2: 1}, 2)
    for _ in range(3):
        _submit(eng, imgs[:3])
        eng.run()
    assert eng.served == 9
    assert (dict(eng.model.trace_counts),
            eng.model.compile_count) == after_warmup
    st = eng.model.stats()
    assert st["compiled"] == [] and st["placed"] == [(1, "cpu"), (2, "cpu")]


def test_sharded_engine_validates_shape_and_buckets(qp8, monkeypatch):
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="torch-int",
                              devices=CPU)
    with pytest.raises(ValueError, match="shape"):
        eng.submit(ImageRequest(rid=0, image=np.zeros((16, 16, 3),
                                                      np.float32)))
    with pytest.raises(ValueError, match="batch_sizes"):
        ShardedResNetEngine(R.RESNET8, qp8, batch=8, backend="torch-int",
                            devices=CPU, batch_sizes=(2, 4))
    with pytest.raises(ValueError, match="devices"):
        ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="torch-int",
                            devices=CPU, replicas=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedResNetEngine(R.RESNET8, qp8, batch=2)


def test_fake_clock_engine_is_deterministic(qp8, imgs):
    """With an injected FakeClock, the engine's scheduling timeline is fully
    simulated: queue waits come out as exact simulated values."""
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=4, backend="torch-int",
                              devices=CPU, slack_ms=2.0, clock=FakeClock())
    _submit(eng, imgs[:3])                 # partial batch: held for slack
    eng.run()
    assert eng.served == 3
    st = eng.latency_stats()
    # dispatched exactly when the 2ms window closed, never before
    assert st["queue_wait_ms"]["max"] == pytest.approx(2.0, abs=0.2)
    assert st["compute_ms"]["max"] == 0.0     # no simulated compute time


def test_latency_stats_split_queue_wait_vs_compute(qp8, imgs):
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=3, backend="torch-int",
                              devices=CPU, slack_ms=0.5)
    eng.pool.warmup()
    _submit(eng, imgs)
    eng.run()
    st = eng.latency_stats()
    assert st["count"] == 6
    assert st["compute_ms"]["p50"] > 0
    assert st["queue_wait_ms"]["p50"] >= 0
    assert [r["served"] for r in st["replicas"]] == [6]
    full = eng.stats()                    # regression: key collision crash
    assert full["served"] == 6 and full["pool_size"] == 1
    assert full["model"]["backend"] == "torch-int"


def test_failed_dispatch_releases_accounting(qp8, imgs, monkeypatch):
    """A dispatch whose wait or copy errors is evicted — in-flight
    accounting releases, its requests stay done=False, and the engine can
    keep serving afterwards (no head-of-line jam)."""
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="torch-int",
                              devices=CPU, slack_ms=0.2)
    bad = _submit(eng, imgs[:2])
    with monkeypatch.context() as m:
        m.setattr(E, "_to_host", lambda out, event: (_ for _ in ()).throw(
            RuntimeError("device died")))
        with pytest.raises(RuntimeError, match="device died"):
            eng.run()
    assert not eng._in_flight
    assert eng.sched.in_flight == 0
    assert all(not r.done for r in bad)
    st = eng.latency_stats()
    # failed requests are counted as failures, never as successes
    assert st["failed"] == 2 and st["count"] == 0
    assert st["replicas"][0]["served"] == 0
    assert st["replicas"][0]["failed"] == 2
    good = _submit(eng, imgs[:2])         # the engine is not poisoned
    eng.run()
    assert all(r.done for r in good)
    ref = lower_forward(R.RESNET8, qp8, "torch-int", device="cpu")(imgs[:2])
    np.testing.assert_array_equal(_logits(good), ref.numpy())


def test_failed_launch_releases_accounting(qp8, imgs, monkeypatch):
    """A dispatch whose launch raises is never in flight: its replica's
    slots are released and the error surfaces."""
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="torch-int",
                              devices=CPU, slack_ms=0.2)
    bad = _submit(eng, imgs[:2])
    with monkeypatch.context() as m:
        m.setattr(eng.pool, "run", lambda i, x: (_ for _ in ()).throw(
            RuntimeError("launch failed")))
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.run()
    assert not eng._in_flight and eng.sched.in_flight == 0
    assert eng.latency_stats()["failed"] == 2
    assert all(not r.done for r in bad)


def test_run_async_with_backpressure_serves_everything(qp8, imgs):
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="torch-int",
                              devices=CPU, slack_ms=0.5, max_pending=3)
    reqs = [ImageRequest(rid=i, image=imgs[i % 6]) for i in range(10)]

    async def produce():
        for r in reqs:
            await eng.submit_async(r)     # awaits instead of raising
        eng.shutdown()

    async def main():
        await asyncio.gather(eng.run_async(), produce())

    asyncio.run(main())
    assert eng.served == 10
    assert all(r.done for r in reqs)
    ref = lower_forward(R.RESNET8, qp8, "torch-int", device="cpu")(imgs[:2])
    np.testing.assert_array_equal(_logits(reqs[:2]), ref.numpy())


def test_submit_raises_backpressure_when_pending_full(qp8, imgs):
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=4, backend="torch-int",
                              devices=CPU, slack_ms=1000.0, max_pending=2,
                              clock=FakeClock())
    eng.submit(ImageRequest(rid=0, image=imgs[0]))
    eng.submit(ImageRequest(rid=1, image=imgs[1]))
    with pytest.raises(Backpressure):
        eng.submit(ImageRequest(rid=2, image=imgs[2]))
    eng.shutdown()                        # graceful drain flushes the two
    eng.run()
    assert eng.served == 2


def test_two_replica_pool_spreads_load_and_stays_bitwise(qp8):
    """Two replicas on one device (the CPU counterpart of the reference's
    forced host devices): both serve, the logits are the single-device
    path's, and each bucket is built once per distinct device."""
    xs = images(8, seed=2)
    ref = lower_forward(R.RESNET8, qp8, "cuda", device="cpu")(xs).numpy()
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="cuda",
                              devices=["cpu", "cpu"], slack_ms=0.5)
    eng.pool.warmup()
    reqs = [ImageRequest(rid=i, image=x) for i, x in enumerate(xs)]
    sreqs = [eng.submit(r) for r in reqs]
    eng.run()
    np.testing.assert_array_equal(_logits(reqs), ref)
    served = [r.served for r in eng.sched.replicas]
    assert sum(served) == 8 and all(s > 0 for s in served)
    assert {r.replica for r in sreqs} == {0, 1}
    assert eng.model.trace_counts == {2: 1}


def test_dispatch_listeners_see_each_micro_batch_once(qp8):
    """Every listener is told of every dispatch: each request lies in
    exactly one, its logits are its row of that dispatch's output, and the
    output is the model's on the dispatch's images."""
    xs = images(7, seed=3)
    eng = ShardedResNetEngine(R.RESNET8, qp8, batch=3, backend="cuda",
                              devices=["cpu", "cpu"], batch_sizes=(1, 3),
                              slack_ms=0.5)
    seen, counted = [], []
    eng.dispatch_listeners += [lambda d, out: seen.append((d, out)),
                               lambda d, out: counted.append(len(d))]
    reqs = [ImageRequest(rid=i, image=x) for i, x in enumerate(xs)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    rids = [r.payload.rid for d, _ in seen for r in d.requests]
    assert sorted(rids) == list(range(7))
    assert counted == [len(d) for d, _ in seen]
    for d, out in seen:
        x = np.stack([r.payload.image for r in d.requests])
        np.testing.assert_array_equal(out.numpy(), eng.model(x).numpy())
        for j, r in enumerate(d.requests):
            np.testing.assert_array_equal(r.payload.logits, out[j].numpy())


def test_sharded_engine_matches_jax_sharded_engine_lax_int(np_qp8, qp8):
    """The port's sharded engine against the JAX package's on lax-int with
    the same bridged weights, ResNet8 at buckets (1, 2), after the same
    scheduling: the integer u8 map under the served logits bitwise, the
    logits within 1e-5 (the float head may sum in another order) with
    equal argmax."""
    xs = images(5, seed=3)
    ours = ShardedResNetEngine(R.RESNET8, qp8, batch=2, backend="cuda",
                               devices=CPU, batch_sizes=(1, 2),
                               slack_ms=0.5)
    oreqs = _submit(ours, xs)
    ours.run()
    ref = JShardedResNetEngine(JR.RESNET8, jax_params(np_qp8), batch=2,
                               backend="lax-int", replicas=1,
                               batch_sizes=(1, 2), slack_ms=0.5)
    jreqs = [JImageRequest(rid=i, image=jnp.asarray(x))
             for i, x in enumerate(xs)]
    for r in jreqs:
        ref.submit(r)
    ref.run()
    assert ours.served == ref.served == 5
    got, want = _logits(oreqs), np.stack([np.asarray(r.logits)
                                          for r in jreqs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert [r.label for r in oreqs] == [r.label for r in jreqs]
    feats = ours.model.backend.features(ours.model.graph, R.RESNET8,
                                        ours.model.params)(
        torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(
        feats, jax_u8_map(JR.RESNET8, jax_params(np_qp8), xs))


def test_tuned_sharded_engine_carries_the_tuning_and_stays_bitwise(qp8,
                                                                   imgs):
    cfg = R.RESNET8
    tuning = {"stem": KernelConfig(band_rows=4),
              "block0": {"band_rows": 8}, "block2": KernelConfig(band_rows=1)}
    eng = ShardedResNetEngine(cfg, qp8, batch=3, backend="cuda",
                              devices=CPU, slack_ms=0.5, tune=tuning)
    assert eng.tuning["block0"] == KernelConfig(band_rows=8)
    assert eng.stats()["model"]["tuning"]["stem"] == {"band_rows": 4}
    reqs = _submit(eng, imgs)
    eng.run()
    ref = lower_forward(cfg, qp8, "torch-int", device="cpu")(imgs).numpy()
    np.testing.assert_array_equal(_logits(reqs), ref)


def test_resnet_engine_tunes_the_primary_and_not_the_shadows(qp8, imgs):
    tuning = {"block1": KernelConfig(band_rows=2)}
    eng = ResNetEngine(R.RESNET8, qp8, batch=3, backend="cuda",
                       ab_backends=("cuda-stream",), device="cpu",
                       tune=tuning)
    assert eng.tuning == tuning
    assert eng.shadows["cuda-stream"].tuning is None
    steps = eng.model.backend.features(eng.model.graph, R.RESNET8,
                                       eng.model.params).steps
    assert [getattr(s, "config", None) for s in steps[1:]] == \
        [KernelConfig(), KernelConfig(band_rows=2), KernelConfig()]
    _submit(eng, imgs)
    eng.run()
    assert eng.ab_stats["cuda-stream"] == [0.0, 0.0]


def test_launch_serve_cli_on_the_cpu(capsys):
    eng = launch_serve.main(["--arch", "resnet8", "--requests", "5",
                             "--batch", "2", "--buckets", "1,2",
                             "--device", "cpu", "--ab", "torch-int"])
    assert eng.served == 5 and max(eng.ab_stats["torch-int"]) == 0.0
    assert "served 5 images" in capsys.readouterr().out
    eng = launch_serve.main(["--arch", "resnet8", "--requests", "5",
                             "--batch", "2", "--device", "cpu",
                             "--replicas", "2", "--deadline-ms", "500",
                             "--backend", "cuda-stream"])
    out = capsys.readouterr().out
    assert eng.served == 5 and len(eng.pool) == 2
    assert "x2 replicas" in out and "deadlines: " in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "resnet8", "--replicas", "1",
                           "--device", "cpu", "--ab", "torch-int"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "resnet8", "--degrade-arch", "resnet9"])
    with pytest.raises(FileNotFoundError):
        launch_serve.main(["--arch", "resnet8", "--trace", "missing.json",
                           "--device", "cpu"])
