"""Serving through the port: ``ResNetEngine`` and ``CompiledModel`` on the
CPU (the kernels' plain versions), held against the JAX engine; entry points
refuse to run without a GPU unless asked for the CPU; and the weight bridge
round-trips."""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_slice import images, jax_params, np_qparams

from repro.models import resnet as JR
from repro.serve.engine import ImageRequest as JImageRequest
from repro.serve.engine import ResNetEngine as JResNetEngine
from repro_torch.compile import (compile_model, lower_features,
                                 lower_forward, params_from_numpy)
from repro_torch.models import resnet as R
from repro_torch.serve import ImageRequest, ResNetEngine


@pytest.fixture(scope="module")
def qparams8():
    return np_qparams(JR.RESNET8, seed=6)


def _submit(eng, imgs, req=ImageRequest):
    reqs = [req(rid=i, image=im) for i, im in enumerate(imgs)]
    for r in reqs:
        eng.submit(r)
    return reqs


def test_engine_drains_queue_in_fixed_batches(qparams8):
    eng = ResNetEngine(R.RESNET8, params_from_numpy(qparams8), batch=4,
                       device="cpu")
    assert eng.backend == "cuda" and eng.device.type == "cpu"
    reqs = _submit(eng, images(6))     # 6 requests -> 2 ticks (4 + 2)
    assert eng.run() == 2 and eng.served == 6 and not eng.queue
    assert all(r.done and r.logits.shape == (10,) for r in reqs)


def test_torch_int_shadow_agrees_and_labels_match_jax_engine(qparams8):
    imgs = images(5, seed=3)
    eng = ResNetEngine(R.RESNET8, params_from_numpy(qparams8), batch=4,
                       batch_sizes=(1, 4), ab_backends=("torch-int",),
                       device="cpu")
    reqs = _submit(eng, imgs)
    eng.run()
    assert eng.ab_stats["torch-int"] == [0.0, 0.0]
    jeng = JResNetEngine(JR.RESNET8, jax_params(qparams8), batch=4,
                         batch_sizes=(1, 4), backend="lax-int")
    jreqs = _submit(jeng, imgs, JImageRequest)
    jeng.run()
    assert [r.label for r in reqs] == [r.label for r in jreqs]
    np.testing.assert_allclose(np.stack([r.logits for r in reqs]),
                               np.stack([r.logits for r in jreqs]),
                               rtol=0, atol=1e-5)


def test_bucket_pad_chunk_path_equals_unbucketed_forward(qparams8):
    """5 images over buckets (1, 4): one full bucket of 4, then 1 on the
    1-bucket; a 3-image batch pads up to 4.  Row for row equal to the
    unbucketed forward."""
    qp = params_from_numpy(qparams8)
    imgs = images(5, seed=4)
    cm = compile_model(R.RESNET8, qp, batch_sizes=(1, 4), device="cpu")
    ref = lower_forward(R.RESNET8, qp, "cuda", device="cpu")(imgs)
    got = cm(imgs)
    assert cm.run_counts == {1: 1, 4: 1}
    assert torch.equal(got, ref)
    assert torch.equal(cm(imgs[:3]), ref[:3])
    assert cm.run_counts == {1: 1, 4: 2}
    assert cm.stats()["device"] == "cpu"
    with pytest.raises(ValueError, match="empty"):
        cm(imgs[:0])


def test_served_u8_map_on_padded_bucket_equals_torch_int(qparams8):
    """The check chip_smoke.py makes on the card: the served model's u8 map
    on the zero-padded batch of a bucket run equals the torch-int shadow's
    bitwise, pad rows included."""
    eng = ResNetEngine(R.RESNET8, params_from_numpy(qparams8), batch=4,
                       batch_sizes=(1, 4), ab_backends=("torch-int",),
                       device="cpu")
    m, shadow = eng.model, eng.shadows["torch-int"]
    batch = m.pad(torch.from_numpy(images(3, seed=5)))
    assert batch.shape[0] == 4 and not batch[3].any()
    got = m.backend.features(m.graph, R.RESNET8, m.params)(batch)
    ref = shadow.backend.features(shadow.graph, R.RESNET8,
                                  shadow.params)(batch)
    assert got.dtype == torch.uint8 and got.any()
    assert torch.equal(got, ref)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(qparams8,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qp = params_from_numpy(qparams8)
    for call in (lambda: compile_model(R.RESNET8, qp),
                 lambda: ResNetEngine(R.RESNET8, qp),
                 lambda: lower_forward(R.RESNET8, qp, "cuda"),
                 lambda: R.int_forward(qp, R.RESNET8, images(1)),
                 lambda: compile_model(R.RESNET8, qp, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_compile_model_rejects_tuning_and_unknown_backends(qparams8):
    """A tune argument of no accepted form (the counterpart of
    tests/test_tune.py::test_compile_model_rejects_bad_tune_argument), an
    unknown backend and a max batch outside the buckets are refused."""
    qp = params_from_numpy(qparams8)
    with pytest.raises(ValueError, match="tune"):
        compile_model(R.RESNET8, qp, tune="magic", device="cpu")
    with pytest.raises(TypeError):
        compile_model(R.RESNET8, qp, tune=42, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        compile_model(R.RESNET8, qp, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="batch_sizes"):
        ResNetEngine(R.RESNET8, qp, batch=8, batch_sizes=(1, 4),
                     device="cpu")


def test_engine_rejects_mismatched_payload(qparams8):
    eng = ResNetEngine(R.RESNET8, params_from_numpy(qparams8), batch=2,
                       device="cpu")
    with pytest.raises(ValueError, match="payload shape"):
        eng.submit(ImageRequest(rid=0, image=np.zeros((16, 16, 3))))


@pytest.mark.parametrize("varied", [False, True])
def test_params_from_numpy_round_trips(varied):
    d = np_qparams(JR.RESNET20, seed=2, varied=varied)
    back = params_from_numpy(d).to_dict()

    def check(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                check(a[k], b[k])
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                check(x, y)
        elif isinstance(b, np.ndarray):
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert (a.bits, a.signed, a.exp) == (b.bits, b.signed, b.exp)

    check(back, d)


def test_port_models_serve_from_the_ports_own_init():
    """init_params (torch.Generator) -> fold -> quantize -> serve, with the
    torch-int and cuda backends (plain versions) agreeing bitwise on the u8
    map."""
    cfg = dataclasses.replace(R.RESNET8, base_width=8)
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(0))), cfg)
    imgs = images(2, seed=5)
    a = lower_features(cfg, qp, "cuda", device="cpu")(imgs)
    b = lower_features(cfg, qp, "torch-int", device="cpu")(imgs)
    assert torch.equal(a, b) and a.shape == (2, 8, 8, 32)
    logits = R.int_forward(qp, cfg, imgs, device="cpu")
    assert torch.equal(logits, R.cuda_forward(qp, cfg, imgs, device="cpu"))
    assert torch.isfinite(logits).all()
