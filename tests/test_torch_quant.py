"""``repro_torch.core.quant`` and ``models.resnet`` quantization against the
JAX package, bitwise, on inputs made by numpy from a seed (mirrors the cases
of tests/test_quant.py and tests/test_quant_props.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.compile import params as JC
from repro.core import quant as JQ
from repro.models import resnet as JR
from repro_torch.compile import params_from_numpy
from repro_torch.core import quant as Q
from repro_torch.core.quant import QSpec
from repro_torch.models import resnet as R


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same(port, ref):
    """Bitwise equality, dtype included."""
    port, ref = port.numpy(), np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


def test_clipping_bounds_eq2_eq3():
    s, u, b = QSpec(8, True, -7), QSpec(8, False, -7), QSpec(16, True, -14)
    assert (s.qmin, s.qmax, u.qmin, u.qmax) == (-128, 127, 0, 255)
    assert (b.qmin, b.qmax) == (-(2 ** 15), 2 ** 15 - 1)
    assert (s.int_dtype, u.int_dtype, b.int_dtype) == \
        (torch.int8, torch.uint8, torch.int16)


def test_bias_scale_is_sum_of_exponents():
    bs = Q.bias_spec(QSpec(8, False, -4), QSpec(8, True, -7))
    assert bs == QSpec(16, True, -11)


@pytest.mark.parametrize("bits,signed,exp", [
    (8, True, -7), (8, False, -7), (8, False, -4), (8, True, 0),
    (16, True, -11)])
def test_quantize_matches_jax_on_exact_ties(bits, signed, exp):
    """Exact +-k.5 ties round half away from zero (torch.round would go to
    even); random values and out-of-range clipping too."""
    halves = (np.arange(-300, 300) + 0.5) * 2.0 ** exp
    rng = np.random.default_rng(bits + exp)
    x = np.concatenate([halves, rng.normal(0, 2.0 ** (exp + 6), 500),
                        [0.0, -0.0, 1e9, -1e9]]).astype(np.float32)
    spec = QSpec(bits, signed, exp)
    _same(Q.quantize(_t(x), spec),
          JQ.quantize(jnp.asarray(x), JQ.QSpec(bits, signed, exp)))


def test_dequantize_matches_jax():
    q = np.arange(-128, 128, dtype=np.int8)
    _same(Q.dequantize(_t(q), QSpec(8, True, -5)),
          JQ.dequantize(jnp.asarray(q), JQ.QSpec(8, True, -5)))


@pytest.mark.parametrize("shift", [-16, -9, -3, -1, 0, 1, 4, 10])
def test_shift_align_matches_jax(shift):
    rng = np.random.default_rng(shift + 100)
    acc = rng.integers(-(2 ** 20), 2 ** 20, 2000).astype(np.int32)
    if shift < 0:   # exact negative and positive halves
        half = 1 << (-shift - 1)
        m = np.arange(-50, 50, dtype=np.int64)
        acc = np.concatenate([acc, ((2 * m + 1) * half).astype(np.int32)])
    _same(Q.shift_align(_t(acc), shift),
          JQ.shift_align(jnp.asarray(acc), shift))


def test_rounding_negative_tie_examples_are_pinned():
    got = Q.shift_align(torch.tensor([-1, -3, -5, 1, 3, 5],
                                     dtype=torch.int32), -1)
    assert got.tolist() == [0, -1, -2, 1, 2, 3]


@given(st.integers(-(2 ** 24), 2 ** 24), st.integers(1, 16))
@settings(max_examples=150, deadline=None)
def test_rounding_shift_equals_floor_half_up_float_reference(acc, s):
    got = int(Q.shift_align(torch.tensor([acc], dtype=torch.int32), -s)[0])
    assert got == int(np.floor(acc * 2.0 ** (-s) + 0.5))


@given(st.integers(-(2 ** 20), 2 ** 20), st.integers(0, 10))
@settings(max_examples=100, deadline=None)
def test_shift_align_left_then_right_is_identity(v, s):
    up = Q.shift_align(torch.tensor([v], dtype=torch.int32), s)
    assert int(Q.shift_align(up, -s)[0]) == v


@pytest.mark.parametrize("from_exp,out_exp,signed", [
    (-14, -4, False), (-14, -4, True), (-11, -4, False), (-4, -4, False),
    (-3, -4, True), (-2, -6, False)])
def test_requantize_shift_matches_jax(from_exp, out_exp, signed):
    rng = np.random.default_rng(abs(from_exp * 7 + out_exp))
    acc = np.concatenate([rng.integers(-(2 ** 20), 2 ** 20, 2000),
                          np.arange(-(2 ** 12), 2 ** 12, 3)]).astype(np.int32)
    _same(Q.requantize_shift(_t(acc), from_exp, QSpec(8, signed, out_exp)),
          JQ.requantize_shift(jnp.asarray(acc), from_exp,
                              JQ.QSpec(8, signed, out_exp)))


@given(st.integers(-128, 127), st.integers(-10, 0), st.integers(0, 12))
@settings(max_examples=80, deadline=None)
def test_requantize_roundtrip_through_finer_domain(v, to_exp, k):
    spec = QSpec(8, True, to_exp)
    acc = torch.tensor([v], dtype=torch.int32) << k
    assert int(Q.requantize_shift(acc, spec.exp - k, spec)[0]) == v


@pytest.mark.parametrize("percentile", [100.0, 99.0])
def test_calibrate_exp_matches_jax(percentile):
    rng = np.random.default_rng(3)
    for scale in (0.01, 0.3, 3.7, 100.0):
        x = (rng.normal(size=(3, 3, 16, 32)) * scale).astype(np.float32)
        for signed in (True, False):
            assert Q.calibrate_exp(_t(x), QSpec(8, signed, 0), percentile) \
                == JQ.calibrate_exp(jnp.asarray(x), JQ.QSpec(8, signed, 0),
                                    percentile)


def test_fold_batchnorm_within_one_ulp_of_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    b, beta, mean = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    gamma = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    var = rng.uniform(0.1, 2.0, 8).astype(np.float32)
    args = (w, b, gamma, beta, mean, var)
    got = Q.fold_batchnorm(*map(_t, args))
    ref = JQ.fold_batchnorm(*map(jnp.asarray, args))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32
        assert np.all(np.abs(g.numpy() - r) <= np.spacing(np.abs(r)))


def _assert_qparams_equal(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_qparams_equal(port[k], ref[k])
    elif isinstance(ref, list):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_qparams_equal(p, r)
    elif isinstance(ref, JQ.QSpec):
        assert (port.bits, port.signed, port.exp) == \
            (ref.bits, ref.signed, ref.exp)
    else:
        _same(port, ref)


def _np_folded(cfg, seed):
    """BN-folded float params in the ``fold_params`` layout, made by numpy
    (weights spread over several pow2 grids, nonzero biases)."""
    rng = np.random.default_rng(seed)

    def conv(fh, ic, oc):
        w = rng.normal(size=(fh, fh, ic, oc)) * rng.uniform(0.05, 3.0)
        return dict(w=w.astype(np.float32),
                    b=rng.normal(size=oc).astype(np.float32))

    d = dict(stem=conv(3, 3, cfg.base_width), blocks=[])
    ich = cfg.base_width
    for i, stride in enumerate(JR.block_strides(cfg)):
        och = cfg.base_width * 2 ** (i // cfg.blocks_per_stage)
        blk = dict(conv0=conv(3, ich, och), conv1=conv(3, och, och))
        if stride != 1 or ich != och:
            blk["ds"] = conv(1, ich, och)
        d["blocks"].append(blk)
        ich = och
    d["fc"] = dict(w=rng.normal(size=(ich, 10)).astype(np.float32),
                   b=rng.normal(size=10).astype(np.float32))
    return d


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("cfg", [JR.RESNET8, JR.RESNET20],
                         ids=lambda c: c.name)
def test_quantize_params_on_bridged_folded_floats_bitwise(cfg):
    folded = _np_folded(cfg, seed=cfg.blocks_per_stage)
    port = R.quantize_params(_tree(_t, folded), getattr(R, cfg.name.upper()))
    _assert_qparams_equal(port, JR.quantize_params(_tree(jnp.asarray, folded),
                                                   cfg))


def test_port_init_fold_quantize_pipeline_shapes():
    """The port's own init (torch.Generator) -> fold -> quantize chain gives
    the JAX layout: HWIO int8 weights, int16 biases, an int8 classifier."""
    qp = R.quantize_params(
        R.fold_params(R.init_params(R.RESNET20,
                                    torch.Generator().manual_seed(0))),
        R.RESNET20)
    assert qp["stem"]["wq"].shape == (3, 3, 3, 16)
    assert qp["stem"]["wq"].dtype == torch.int8
    assert qp["stem"]["bq"].dtype == torch.int16
    assert len(qp["blocks"]) == 9
    assert [("ds" in b) for b in qp["blocks"]] == \
        [False] * 3 + [True, False, False] * 2
    assert qp["blocks"][-1]["conv1"]["wq"].shape == (3, 3, 64, 64)
    assert qp["fc"]["wq"].shape == (64, 10) and \
        qp["fc"]["b"].dtype == torch.float32


def test_calibrate_exp_past_torch_quantile_limit_matches_jax():
    """2^24 + 1 samples, one past ``torch.quantile``'s input limit: the
    percentile-clipped exponent equals the JAX package's, and the clipped
    amax lies within one float32 ulp of ``jnp.percentile``'s."""
    rng = np.random.default_rng(16)
    x = rng.normal(size=(1 << 24) + 1).astype(np.float32)
    spec, jspec = QSpec(8, True, 0), JQ.QSpec(8, True, 0)
    want = float(jnp.percentile(jnp.abs(jnp.asarray(x)), 99.9))
    got = Q.percentile_linear(torch.abs(_t(x)), 99.9)
    assert abs(got - want) <= np.spacing(np.float32(want))
    assert Q.calibrate_exp(_t(x), spec, 99.9) == \
        JQ.calibrate_exp(jnp.asarray(x), jspec, 99.9)


# ---------------------------------------------------------------------------
# the fixed-grid shift helpers
# ---------------------------------------------------------------------------


def _np_tree(d):
    if isinstance(d, dict):
        return {k: _np_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_np_tree(v) for v in d]
    return np.asarray(d) if hasattr(d, "shape") else d


@pytest.mark.parametrize("arch", ["resnet8", "resnet20"])
def test_block_shifts_equal_the_reference(arch):
    """``QBlockParams.shifts(A_SPEC.exp)`` and ``block_shifts`` equal the
    reference's on the same quantized params (tests/test_compile.py's
    ``test_block_shifts_match_models_resnet``, test_pallas_forward.py's
    exponent arithmetic)."""
    jcfg = {"resnet8": JR.RESNET8, "resnet20": JR.RESNET20}[arch]
    jqp = JR.quantize_params(JR.fold_params(JR.init_params(
        jcfg, jax.random.PRNGKey(5))), jcfg)
    tp = params_from_numpy(_np_tree(jqp))
    jtp = JC.QResNetParams.from_dict(jqp)
    assert R.A_SPEC.exp == JR.A_SPEC.exp
    for qb, blk, jblk in zip(jqp["blocks"], tp.blocks, jtp.blocks):
        want = JR.block_shifts(qb)
        assert jblk.shifts(JR.A_SPEC.exp) == want
        assert blk.shifts(R.A_SPEC.exp) == want
        assert R.block_shifts(qb) == want
        e1 = qb["conv1"]["x_spec"].exp + qb["conv1"]["w_spec"].exp
        assert want["shift1"] == R.A_SPEC.exp - e1


def test_shifts_refuse_per_tensor_params():
    import dataclasses
    jcfg = JR.RESNET8
    jqp = JR.quantize_params(JR.fold_params(JR.init_params(
        jcfg, jax.random.PRNGKey(6))), jcfg)
    tp = params_from_numpy(_np_tree(jqp))
    blk = tp.blocks[0]
    moved = dataclasses.replace(blk, conv1=dataclasses.replace(
        blk.conv1, x_spec=dataclasses.replace(blk.conv1.x_spec,
                                              exp=R.A_SPEC.exp - 1)))
    jblk = JC.QResNetParams.from_dict(jqp).blocks[0]
    jmoved = dataclasses.replace(jblk, conv1=dataclasses.replace(
        jblk.conv1, x_spec=dataclasses.replace(jblk.conv1.x_spec,
                                               exp=JR.A_SPEC.exp - 1)))
    msgs = []
    for b, exp in ((jmoved, JR.A_SPEC.exp), (moved, R.A_SPEC.exp)):
        with pytest.raises(ValueError, match="per-tensor") as exc:
            b.shifts(exp)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    # shifts_for takes them
    assert moved.shifts_for(R.A_SPEC.exp)["shift0"] == \
        moved.conv1.x_spec.exp - moved.conv0.product_exp
