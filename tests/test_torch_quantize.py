"""``repro_torch.quantize`` against the JAX package on the CPU, case by case
after tests/test_quantize.py: observers equal on the same arrays;
calibration exponents equal (activation ranges within 1e-5) on the same
parameters; ``CalibrationResult`` JSON read by either package; the export
bitwise equal to JAX's given the same folded parameters and calibration;
``validate_export`` over ``cuda`` / ``cuda-stream`` / ``torch-int`` (the
kernels' plain versions on the CPU); the QAT forward; the PTQ-within-2% and
QAT-recovers-half acceptance on ResNet8 through ``torch-int``; the eval
harness and the CLI with ``--device cpu``."""
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet_float import SteTeacher

from repro.models import resnet as JR
from repro.quantize import CalibrationResult as JCalibrationResult
from repro.quantize import calibrate as jcalibrate
from repro.quantize import calibration_batches as jcalibration_batches
from repro.quantize import evaluate_float as jevaluate_float
from repro.quantize import export_qparams as jexport_qparams
from repro.quantize import fake_quant_weight as jfake_quant_weight
from repro.quantize import make_observer as jmake_observer
from repro.quantize import pow2_exponent as jpow2_exponent
from repro.quantize import qat_forward as jqat_forward
from repro.quantize import QuantRecipe as JQuantRecipe
from repro.quantize import synthetic_eval_set as jsynthetic_eval_set
from repro_torch.compile import QResNetParams, compile_model
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.models import resnet as R
from repro_torch.quantize import (
    EXP_CLAMP, CalibrationResult, MinMaxObserver, MovingAverageObserver,
    PercentileObserver, QuantRecipe, calibrate, calibration_batches,
    evaluate_compiled, evaluate_float, evaluate_variants, export_qparams,
    fake_quant_weight, fine_tune, load_eval_set, make_observer,
    pow2_exponent, ptq_quantize, qat_forward, synthetic_eval_set,
    validate_export)
from repro_torch.serve import ImageRequest, ResNetEngine
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import make_train_step

CFG8 = dataclasses.replace(R.RESNET8, quant="none")
CFG20 = dataclasses.replace(R.RESNET20, quant="none")
JCFG8 = dataclasses.replace(JR.RESNET8, quant="none")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(jcfg, seed):
    jp = JR.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, R.float_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), CPU)


def _calib_batches(n=2, batch=32, seed=0):
    return calibration_batches(n, batch, seed)


def _ptq(cfg, params, batches=None, **kw):
    return ptq_quantize(cfg, params, batches or _calib_batches(), **kw)


def _port_params(cfg, seed):
    return R.init_params(cfg, torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# observers
# ---------------------------------------------------------------------------


def test_pow2_exponent_rule_matches_jax():
    assert pow2_exponent(1.0, 8, signed=False) == -7
    assert pow2_exponent(1.0, 8, signed=True) == -6
    assert pow2_exponent(127.0, 8, signed=True) == 0
    assert pow2_exponent(0.0, 8, signed=False) < -30
    for amax in np.geomspace(1e-6, 1e4, 97):
        for bits, signed in ((8, True), (8, False), (16, True)):
            assert pow2_exponent(amax, bits, signed) == \
                jpow2_exponent(amax, bits, signed)


@pytest.mark.parametrize("kind,kw", [("minmax", {}), ("ema", {}),
                                     ("ema", dict(momentum=0.5)),
                                     ("percentile", {}),
                                     ("percentile", dict(percentile=99.0))])
def test_observers_equal_jax_on_the_same_arrays(kind, kw):
    """The port's observer fed tensors, the reference fed the same arrays:
    the same float64 ranges, exactly."""
    rng = np.random.default_rng(len(kind))
    ours, ref = make_observer(kind, **kw), jmake_observer(kind, **kw)
    for i in range(5):
        x = (rng.normal(size=(4, 8, 8, 3)) * (1 + 3 * i)).astype(np.float32)
        ours.observe(torch.from_numpy(x))
        ref.observe(x)
    assert ours.amax() == ref.amax() and ours.batches == ref.batches == 5
    assert ours.exponent(8, False) == ref.exponent(8, False)
    assert ours.qspec(8, True).exp == ref.qspec(8, True).exp


def test_observer_behaviour():
    o = MinMaxObserver()
    for v in (np.array([0.1, -0.5]), torch.tensor([3.0]), [0.2]):
        o.observe(v)
    assert o.amax() == 3.0 and o.batches == 3
    ema = MovingAverageObserver(momentum=0.9)
    for _ in range(4):
        ema.observe(torch.full((4,), 1.0))
    ema.observe(torch.full((4,), 100.0))
    assert 1.0 < ema.amax() < 20.0
    x = np.concatenate([np.full(999, 1.0), np.full(1, 1000.0)])
    p = PercentileObserver(percentile=99.0)
    p.observe(x)
    assert p.amax() < 2.0 and p.exponent(8, False) < \
        pow2_exponent(1000.0, 8, False)
    with pytest.raises(ValueError):
        make_observer("nope")
    with pytest.raises(ValueError):
        MovingAverageObserver(momentum=1.0)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _site_amax(cfg, params, batches, jax_side, kind):
    """Per activation site, the observer's range over ``batches``."""
    taps = {}

    def tap(site, h):
        taps.setdefault(site, (jmake_observer if jax_side else
                               make_observer)(kind)).observe(h)

    fold, fwd = (JR.fold_params, JR.folded_float_forward) if jax_side \
        else (R.fold_params, R.folded_float_forward)
    folded = fold(params)
    for b in batches:
        x = b["images"]
        fwd(folded, cfg, jnp.asarray(x) if jax_side else
            torch.from_numpy(x), tap=tap)
    return {s: o.amax() for s, o in taps.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("observer", ["minmax", "ema", "percentile"])
def test_calibrate_exponents_equal_jax(seed, observer):
    jp, p = _bridged(JCFG8, seed)
    batches = _calib_batches(2, 16, seed)
    ref = jcalibrate(JCFG8, jp, batches, observer=observer)
    got = calibrate(CFG8, p, batches, observer=observer)
    assert got.to_dict() == ref.to_dict()
    # the ranges behind them, on the BN-calibrated params of both
    imgs = np.concatenate([b["images"] for b in batches])
    jpb = JR.calibrate_bn(jp, JCFG8, jnp.asarray(imgs))
    pb = R.calibrate_bn(p, CFG8, torch.from_numpy(imgs))
    a = _site_amax(CFG8, pb, batches, False, observer)
    b = _site_amax(JCFG8, jpb, batches, True, observer)
    assert a.keys() == b.keys()
    for s in a:
        assert abs(a[s] - b[s]) <= 1e-5 * b[s], (s, a[s], b[s])


def test_calibration_json_interchangeable_both_ways():
    jp, p = _bridged(JCFG8, 4)
    ours = calibrate(CFG8, p, _calib_batches())
    ref = jcalibrate(JCFG8, jp, _calib_batches())
    assert json.dumps(ours.to_dict()) == json.dumps(ref.to_dict())
    assert CalibrationResult.from_dict(json.loads(json.dumps(
        ref.to_dict()))) == ours
    assert JCalibrationResult.from_dict(json.loads(json.dumps(
        ours.to_dict()))) == ref
    assert CalibrationResult.from_dict(ours.to_dict()) == ours
    n = 3 * CFG8.blocks_per_stage
    assert set(ours.acts) == {"stem.out"} | {
        f"block{i}.{k}" for i in range(n) for k in ("mid", "out")}
    assert ours.summary() == ref.summary()


def test_calibration_deterministic_and_clamped():
    def one():
        return calibrate(CFG8, _port_params(CFG8, 3), _calib_batches(),
                         observer="percentile", percentile=99.0)

    c1, c2 = one(), one()
    assert c1.to_dict() == c2.to_dict()
    lo, hi = EXP_CLAMP
    assert all(lo <= s.exp <= hi for s in c1.acts.values())


def test_calibrate_rejects_empty_and_wrong_model():
    params = _port_params(CFG8, 0)
    with pytest.raises(ValueError):
        calibrate(CFG8, params, [])
    c = calibrate(CFG8, params, _calib_batches(1))
    with pytest.raises(ValueError):
        export_qparams(CFG20, _port_params(CFG20, 0), c)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _leaves(qp):
    """Every array of a typed export, in the ``to_dict`` layout."""
    return [(k, v) for k, v in T.flatten_with_path(qp.to_dict())
            if not isinstance(v, Q.QSpec) and not hasattr(v, "bits")]


@pytest.mark.parametrize("seed", [5, 6])
def test_export_bitwise_equal_to_jax(seed):
    """The same BN-calibrated float params and the same calibration (JAX's
    own, read through the JSON) give the same int8 / int16 / float32
    arrays and the same specs."""
    jp, _ = _bridged(JCFG8, seed)
    batches = _calib_batches(2, 16, seed)
    imgs = np.concatenate([b["images"] for b in batches])
    jp = JR.calibrate_bn(jp, JCFG8, jnp.asarray(imgs))
    jcal = jcalibrate(JCFG8, jp, batches, calibrate_bn=False,
                      observer="percentile")
    ref = jexport_qparams(JCFG8, jp, jcal)
    p = R.float_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  CPU)
    got = export_qparams(CFG8, p, CalibrationResult.from_dict(
        jcal.to_dict()))
    ref_d, got_d = ref.to_dict(), got.to_dict()
    ref_leaves = dict(T.flatten_with_path(ref_d))
    n = 0
    for k, v in T.flatten_with_path(got_d):
        r = ref_leaves[k]
        if isinstance(v, torch.Tensor):
            r = np.asarray(r)
            assert v.numpy().dtype == r.dtype, k
            np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
            n += 1
        else:
            assert (v.bits, v.signed, v.exp) == (r.bits, r.signed, r.exp)
    assert n == 2 * (1 + 2 * 3 + 2) + 2
    assert got.stem.wq.dtype == torch.int8 and \
        got.stem.bq.dtype == torch.int16 and got.fc.b.dtype == torch.float32


@pytest.mark.parametrize("cfg", [CFG8, CFG20], ids=["resnet8", "resnet20"])
def test_validate_export_across_the_three_backends(cfg):
    _, calib, qp = _ptq(cfg, _port_params(cfg, 6), _calib_batches(2, 8))
    imgs = _calib_batches(1, 8)[0]["images"][:2]
    check = validate_export(cfg, qp, imgs, device=CPU)
    assert check["bit_exact"] and check["max_abs_dev"] == 0.0
    assert check["backends"] == ("cuda", "cuda-stream", "torch-int")


def test_varied_per_tensor_grids_stay_bitexact():
    params = _port_params(CFG8, 9)
    batches = _calib_batches()
    params = R.calibrate_bn(params, CFG8, torch.from_numpy(
        np.concatenate([b["images"] for b in batches])))
    calib = calibrate(CFG8, params, batches, calibrate_bn=False)
    spread = {site: Q.QSpec(8, False, s.exp + (i % 3) - 1)
              for i, (site, s) in enumerate(sorted(calib.acts.items()))}
    qp = export_qparams(CFG8, params, dataclasses.replace(calib, acts=spread))
    assert validate_export(CFG8, qp, batches[0]["images"][:2],
                           device=CPU)["bit_exact"]


def test_export_roundtrip_and_specs_follow_calibration():
    _, calib, qp = _ptq(CFG8, _port_params(CFG8, 8))
    rt = QResNetParams.from_dict(qp.to_dict())
    for (_, a), (_, b) in zip(_leaves(qp), _leaves(rt)):
        assert torch.equal(a, b)
    assert qp.stem.x_spec == calib.x_spec
    for i, blk in enumerate(qp.blocks):
        assert blk.conv0.x_spec == calib.block_in(i)
        assert blk.conv1.x_spec == calib.block_mid(i)
        for c in (blk.conv0, blk.conv1) + ((blk.ds,) if blk.ds else ()):
            assert c.b_spec.exp == c.x_spec.exp + c.w_spec.exp
            assert c.b_spec.bits == 16
    assert qp.fc.x_spec == calib.head_in(len(qp.blocks))


def test_exported_params_serve_with_zero_retracing():
    _, _, qp = _ptq(CFG8, _port_params(CFG8, 10))
    eng = ResNetEngine(CFG8, qp, batch=4, backend="torch-int", device=CPU)
    imgs = np.random.default_rng(0).random((12, 32, 32, 3)).astype(
        np.float32)
    reqs = [ImageRequest(rid=i, image=imgs[i]) for i in range(12)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert max(eng.model.trace_counts.values()) == 1
    np.testing.assert_array_equal([r.label for r in reqs],
                                  eng.model(imgs).argmax(-1).numpy())


def test_no_fallback_hides_the_device():
    """Without a GPU the entry points raise unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is real")
    _, _, qp = _ptq(CFG8, _port_params(CFG8, 1), _calib_batches(1, 4))
    imgs, labels = synthetic_eval_set(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_export(CFG8, qp, imgs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_compiled(CFG8, qp, imgs, labels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_float(CFG8, _port_params(CFG8, 1), imgs, labels)


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------


def test_dynamic_weight_fake_quant_matches_jax():
    w = np.random.default_rng(1).normal(0, 0.3, 500).astype(np.float32)
    w[:4] = [0.5, -0.25, 0.1, -0.9]
    g = np.random.default_rng(2).normal(size=500).astype(np.float32)
    ref, vjp = jax.vjp(jfake_quant_weight, jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fake_quant_weight(wt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(wt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    e = pow2_exponent(float(np.abs(w).max()), 8, signed=True)
    spec = Q.QSpec(8, True, e)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        Q.dequantize(Q.quantize(torch.from_numpy(w), spec), spec).numpy())


@pytest.mark.parametrize("train", [True, False])
def test_qat_forward_matches_jax(train):
    """The calibrated-recipe QAT forward on the same params and images
    (under ``SteTeacher``: each round-and-clip held against the
    reference's), logits within 1e-5 of the largest."""
    jp, p = _bridged(JCFG8, 5)
    batches = _calib_batches(1, 8)
    jcal = jcalibrate(JCFG8, jp, batches)
    imgs = np.concatenate([b["images"] for b in batches])
    jp = JR.calibrate_bn(jp, JCFG8, jnp.asarray(imgs))
    p = R.float_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  CPU)
    recipe = QuantRecipe.from_calibration(
        CalibrationResult.from_dict(jcal.to_dict()), CFG8)
    jrecipe = JQuantRecipe.from_calibration(jcal, JCFG8)

    def exps(r):
        return [s.exp for s in (r.x_spec, r.stem_out, *r.mids, *r.outs)]
    assert exps(recipe) == exps(jrecipe) and recipe.bits_w == jrecipe.bits_w
    x = imgs[:4]
    teacher = SteTeacher()
    with teacher.record():
        ref = np.asarray(jqat_forward(jp, JCFG8, jrecipe, jnp.asarray(x),
                                      train=train))
    with teacher.replay():
        got = qat_forward(p, CFG8, recipe, torch.from_numpy(x),
                          train=train).detach().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    lf = R.forward(p, CFG8, torch.from_numpy(x), train=train)
    assert not np.allclose(got, lf.detach().numpy())


# ---------------------------------------------------------------------------
# accuracy acceptance: PTQ within 2% of float, QAT recovers half the gap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained8():
    """ResNet8 float-trained by the port on the synthetic task (the
    reference's recipe: 40 steps of 64, SGD-momentum, warm-up 4)."""
    steps, batch = 40, 64
    params = _port_params(CFG8, 0)
    opt = opt_lib.sgdm(lr=0.1, total_steps=steps, warmup=4)
    step = make_train_step(lambda p, b: R.loss_fn(p, CFG8, b), opt, CPU)
    state = opt.init(params)
    pipe = SyntheticCifar(batch, seed=0)
    for i in range(steps):
        params, state, _ = step(params, state, i, pipe.next())
    return params, pipe


def test_ptq_within_2pct_and_qat_recovers_half(trained8):
    params, pipe = trained8
    images, labels = synthetic_eval_set(256, seed=0)
    params_bn, calib, qp = _ptq(CFG8, params, _calib_batches(2, 64, 0))
    fl = evaluate_float(CFG8, params_bn, images, labels, device=CPU)
    ptq = evaluate_compiled(CFG8, qp, images, labels, backend="torch-int",
                            batch=64, device=CPU)
    assert fl["top1"] > 0.5, "float model failed to learn the synthetic task"
    gap = fl["top1"] - ptq["top1"]
    assert gap <= 0.02, (fl["top1"], ptq["top1"])
    assert ptq["retraces"] == 1
    recipe = QuantRecipe.from_calibration(calib, CFG8)
    params_q, metrics = fine_tune(CFG8, params_bn, recipe, pipe, steps=12,
                                  lr=0.005, log=lambda *_: None)
    assert metrics and np.isfinite(float(metrics["loss"]))
    _, _, qp_q = _ptq(CFG8, params_q, _calib_batches(2, 64, 0))
    qat = evaluate_compiled(CFG8, qp_q, images, labels, backend="torch-int",
                            batch=64, device=CPU)
    assert qat["top1"] >= fl["top1"] - max(gap, 0.0) / 2 - 1e-9, \
        (fl["top1"], ptq["top1"], qat["top1"])


# ---------------------------------------------------------------------------
# eval harness
# ---------------------------------------------------------------------------


def test_eval_and_calibration_sets_equal_jax_and_held_out():
    a_imgs, a_lbls = synthetic_eval_set(64, seed=0)
    b_imgs, b_lbls = jsynthetic_eval_set(64, seed=0)
    np.testing.assert_array_equal(a_imgs, b_imgs)
    np.testing.assert_array_equal(a_lbls, b_lbls)
    assert a_imgs.dtype == np.float32 and a_lbls.dtype == np.int32
    assert 0.0 <= a_imgs.min() and a_imgs.max() < 1.0
    train_imgs = SyntheticCifar(64, seed=0).next()["images"]
    assert not np.array_equal(a_imgs, train_imgs)
    for a, b in zip(calibration_batches(2, 8, 1),
                    jcalibration_batches(2, 8, 1)):
        np.testing.assert_array_equal(a["images"], b["images"])


def test_load_eval_set_synthetic_fallback(monkeypatch):
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)
    imgs, labels, source = load_eval_set(32)
    assert source == "synthetic" and len(imgs) == len(labels) == 32


def test_load_eval_set_real_cifar(tmp_path, monkeypatch):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    raw = np.random.default_rng(0).integers(0, 256, (8, 3072)).astype(
        np.uint8)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({b"data": raw, b"labels": list(range(8))}, f)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    imgs, labels, source = load_eval_set(4)
    assert source == "cifar10" and imgs.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(labels, [0, 1, 2, 3])
    np.testing.assert_allclose(imgs[0, 0, 0, 2], raw[0, 2048] / 256.0)


def test_evaluate_float_equals_jax():
    jp, p = _bridged(JCFG8, 12)
    images, labels = synthetic_eval_set(40, seed=0)
    jp = JR.calibrate_bn(jp, JCFG8, jnp.asarray(images))
    p = R.calibrate_bn(p, CFG8, torch.from_numpy(images))
    ours = evaluate_float(CFG8, p, images, labels, batch=16, device=CPU)
    ref = jevaluate_float(JCFG8, jp, images, labels, batch=16)
    assert ours == ref


def test_evaluate_compiled_sharded_matches_single_and_variants():
    _, _, qp = _ptq(CFG8, _port_params(CFG8, 11))
    images, labels = synthetic_eval_set(24, seed=0)
    single = evaluate_compiled(CFG8, qp, images, labels, backend="cuda",
                               batch=8, device=CPU)
    sharded = evaluate_compiled(CFG8, qp, images, labels, backend="cuda",
                                batch=8, replicas=2, device=CPU)
    assert single["top1"] == sharded["top1"]
    assert (sharded["replicas"], single["replicas"]) == (2, 0)
    assert single["retraces"] == sharded["retraces"] == 1
    assert evaluate_variants({"resnet8": (CFG8, qp)}, images, labels,
                             backend="torch-int", batch=8,
                             device=CPU) == {"resnet8": single["top1"]}
    cm = compile_model(CFG8, qp, backend="cuda", batch_sizes=(8,),
                       device=CPU)
    assert (cm(images).argmax(-1).numpy() == labels).mean() == \
        single["top1"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_smoke_on_the_cpu(tmp_path, capsys):
    from repro_torch.quantize.__main__ import main

    out = main(["calibrate", "--arch", "resnet8", "--float-steps", "0",
                "--batch", "16", "--calib-batches", "1", "--device", "cpu",
                "--json", str(tmp_path / "q.json")])
    assert out["export"]["bit_exact"]
    assert (tmp_path / "q.json").is_file()
    assert "calibration[resnet8]" in capsys.readouterr().out
    out = main(["eval", "--arch", "resnet8", "--float-steps", "2",
                "--qat-steps", "1", "--batch", "8", "--calib-batches", "1",
                "--eval-n", "16", "--eval-batch", "8", "--device", "cpu",
                "--backend", "cuda-stream"])
    assert out["backend"] == "cuda-stream" and out["retraces"] == 1
    assert {"ptq_int8_top1", "int8_top1", "float_top1"} <= set(out)
