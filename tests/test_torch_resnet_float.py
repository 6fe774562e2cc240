"""The port's float half of ResNet (``models.resnet`` forward, loss,
``calibrate_bn``, ``folded_float_forward``), the QAT arithmetic of
``core.quant`` (``fake_quant`` / ``ste_round_clip``, ``block_quantize``,
``acc_bits`` / ``n_acc``) and the ``float`` backend, against the JAX
package on the CPU at ResNet8 width: the same parameters (JAX's
``init_params``, bridged with ``float_params_from_numpy``) and the same
seeded numpy inputs through both.

Tolerances: fake-quant values and STE gradients, ``block_quantize`` and
``acc_bits`` / ``n_acc`` exactly; logits, ``calibrate_bn`` statistics and
the folded forward's taps within 1e-5 of the largest reference magnitude
(float32 convolutions summed in another order); per-leaf gradients within
a relative L2 error of 1e-4 (``quant="none"``) or 1e-3 (fake-quant); the
``float`` backend's logits within 1e-4 with equal argmax.

With fake-quant on, a value that float32 noise puts on the other side of a
rounding tie rounds one grid step apart in the two packages, and the step
then travels to the logits.  So those cases run under :class:`SteTeacher`:
every round-and-clip of the port is held against the JAX package's on the
same call (its input within 1e-5, its output equal except at ties within
that noise) and then hands the reference's output on, its gradient still
the port's STE; the next layer thus starts from the reference's values."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import np_qparams

from repro.compile import lower_forward as jax_lower_forward
from repro.compile.params import QResNetParams as JQResNetParams
from repro.core import quant as JQ
from repro.models import resnet as JR
from repro_torch.compile import (LoweringError, compile_model, get_backend,
                                 init_lm_params, lm_config, lower_forward,
                                 params_from_numpy)
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.models import resnet as R
from repro_torch.serve import ImageRequest, ResNetEngine

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(quant):
    return (dataclasses.replace(JR.RESNET8, quant=quant),
            dataclasses.replace(R.RESNET8, quant=quant))


def _params(jcfg, seed=0):
    jp = JR.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, R.float_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 32, 32, 3), dtype=np.float32) * 0.999).astype(
        np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


class SteTeacher:
    """Record every ``ste_round_clip`` of a JAX forward (``record``), then
    hold the port's calls against them in order (``replay``)."""

    def __init__(self):
        self.calls = []
        self.ties = 0

    @contextlib.contextmanager
    def record(self):
        orig = JQ._ste_round_clip

        def rec(x, qmin, qmax):
            y = orig(x, qmin, qmax)
            self.calls.append((np.asarray(x), np.asarray(y)))
            return y

        JQ._ste_round_clip = JQ.ste_round_clip = rec
        try:
            yield self
        finally:
            JQ._ste_round_clip = JQ.ste_round_clip = orig

    @contextlib.contextmanager
    def replay(self):
        orig = Q.ste_round_clip
        calls = iter(self.calls)

        def rep(x, qmin, qmax):
            own = orig(x, qmin, qmax)
            x_ref, y_ref = next(calls)
            tol = REL * max(float(np.abs(x_ref).max()), 1e-30)
            assert float(np.abs(x.detach().numpy() - x_ref).max()) <= tol
            flip = own.detach().numpy() != y_ref
            dist = np.abs(np.abs(x_ref) - np.floor(np.abs(x_ref)) - 0.5)
            assert (dist[flip] <= tol).all(), "a flip away from a tie"
            self.ties += int(flip.sum())
            return own + (torch.from_numpy(y_ref.copy()) - own).detach()

        Q.ste_round_clip = rep
        try:
            yield self
        finally:
            Q.ste_round_clip = orig
        assert next(calls, None) is None, "the port made fewer calls"


def _close(port, ref, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# core.quant: the QAT arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,signed,exp", [
    (8, True, -4), (8, False, -4), (8, True, -7), (16, True, -11)])
def test_fake_quant_values_and_ste_grads_bitwise(bits, signed, exp):
    """Inside, outside and exactly at the clip edges (and half a step
    either side of them), values and gradients equal the JAX custom_vjp."""
    spec, jspec = Q.QSpec(bits, signed, exp), JQ.QSpec(bits, signed, exp)
    lo, hi = spec.qmin * spec.scale, spec.qmax * spec.scale
    edges = [lo, hi, lo - spec.scale / 2, hi + spec.scale / 2,
             lo + spec.scale / 2, hi - spec.scale / 2, 2 * lo - 1, 2 * hi]
    rng = np.random.default_rng(bits - exp)
    x = np.concatenate([edges, (np.arange(-40, 40) + 0.5) * spec.scale,
                        rng.normal(0, hi / 2, 300)]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: JQ.fake_quant(v, jspec), jnp.asarray(x))
    ref_g, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = Q.fake_quant(xt, spec)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_g))
    # the edges themselves pass the gradient, beyond them it is zero
    assert (xt.grad.numpy()[:2] == g[:2]).all()
    assert (xt.grad.numpy()[6:8] == 0).all()


def test_ste_round_clip_bitwise():
    rng = np.random.default_rng(3)
    x = np.concatenate([np.arange(-10, 10) + 0.5, [-8.0, 7.0, -8.5, 7.5],
                        rng.normal(0, 6, 200)]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: JQ.ste_round_clip(v, -8.0, 7.0),
                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = Q.ste_round_clip(xt, -8.0, 7.0)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("shape,block", [((4, 256), 128), ((3, 200), 128),
                                         ((2, 3, 7), 4), ((130,), 128)])
def test_block_quantize_bitwise(shape, block):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3, shape)
         ).astype(np.float32)
    ref = JQ.block_quantize(jnp.asarray(x), block=block)
    got = Q.block_quantize(torch.from_numpy(x), block=block)
    for a, b in ((got.q, ref.q), (got.exp, ref.exp)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        Q.block_dequantize(got, block=block).numpy(),
        np.asarray(JQ.block_dequantize(ref, block=block)))
    assert got.nbytes == ref.nbytes


def test_acc_bits_and_n_acc_exact():
    for och, ich, fh in [(16, 3, 3), (64, 64, 3), (32, 16, 1), (1, 1, 1)]:
        n = Q.n_acc(och, ich, fh, fh)
        assert n == JQ.n_acc(och, ich, fh, fh)
        for bw in (4, 8, 16):
            assert Q.acc_bits(n, bw) == JQ.acc_bits(n, bw)


# ---------------------------------------------------------------------------
# models.resnet: the float path
# ---------------------------------------------------------------------------


def test_float_params_bridge_roundtrip():
    jp, p = _params(JR.RESNET8, seed=2)
    back = R.float_params_to_numpy(p)
    ref = jax.tree_util.tree_map(np.asarray, jp)
    assert [k for k, _ in T.flatten_with_path(back)] == \
        [k for k, _ in T.flatten_with_path(ref)]
    for a, b in zip(T.leaves(back), jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", ["none", "qat"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(quant, train):
    jcfg, cfg = _cfgs(quant)
    jp, p = _params(jcfg, seed=1)
    # eval mode reads the running stats: write real ones first
    x, _ = _batch(4, seed=5)
    jp = JR.calibrate_bn(jp, jcfg, jnp.asarray(x))
    p = R.float_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    x, _ = _batch(4, seed=6)
    teacher = SteTeacher()
    with teacher.record():
        ref = JR.forward(jp, jcfg, jnp.asarray(x), train=train)
    with teacher.replay():
        got = R.forward(p, cfg, torch.from_numpy(x), train=train)
    # input, stem weight and output; weights and outputs of conv0 and
    # conv1 in 3 blocks, of the 2 downsamples; the classifier weight
    assert len(teacher.calls) == (0 if quant == "none" else
                                  3 + 4 * 3 + 2 * 2 + 1)
    _close(got, ref)


def _grads_close(grads, ref_grads, rel):
    """Per-leaf relative L2 error at most ``rel``.  A leaf whose gradient
    is zero in exact arithmetic (a conv bias ahead of a training-mode BN,
    which subtracts the batch mean: the reference's value there is float
    rounding, at most 1e-5 of the largest leaf's norm) is held to the same
    floor: the port's must be below it too."""
    ref_grads = [np.asarray(g) for g in ref_grads]
    floor = 1e-5 * max(np.linalg.norm(g) for g in ref_grads)
    for (path, g), ref in zip(grads, ref_grads):
        g = np.zeros_like(ref) if g is None else g.numpy()
        n = np.linalg.norm(ref)
        if n <= floor:
            assert np.linalg.norm(g) <= floor, (path, np.linalg.norm(g))
            continue
        assert np.linalg.norm(g - ref) / n <= rel, \
            (path, np.linalg.norm(g - ref) / n)


@pytest.mark.parametrize("quant,rel", [("none", 1e-4), ("qat", 1e-3)])
def test_loss_and_grads_match_jax(quant, rel):
    from repro_torch.train.loop import value_and_grad

    jcfg, cfg = _cfgs(quant)
    jp, p = _params(jcfg, seed=3)
    x, y = _batch(4, seed=7)
    batch = dict(images=jnp.asarray(x), labels=jnp.asarray(y))
    (jl, jm), jg = jax.value_and_grad(
        lambda pp: JR.loss_fn(pp, jcfg, batch), has_aux=True)(jp)
    teacher = SteTeacher()
    with teacher.record():
        JR.loss_fn(jp, jcfg, batch)
    with teacher.replay():
        (loss, m), g = value_and_grad(
            lambda pp: R.loss_fn(pp, cfg, dict(images=torch.from_numpy(x),
                                               labels=torch.from_numpy(y))),
            p)
    _close(loss, jl)
    assert float(m["acc"]) == float(jm["acc"])
    # bn.mean / bn.var are not read in training mode: no gradient
    assert g["stem"]["bn"]["mean"] is None
    g = T.tree_map(lambda leaf, d: torch.zeros_like(leaf) if d is None
                   else d, p, g)
    _grads_close(T.flatten_with_path(g), jax.tree_util.tree_leaves(jg), rel)


@pytest.mark.parametrize("quant", ["none", "qat"])
def test_calibrate_bn_matches_jax(quant):
    jcfg, cfg = _cfgs(quant)
    jp, p = _params(jcfg, seed=4)
    x, _ = _batch(8, seed=8)
    teacher = SteTeacher()
    with teacher.record():
        ref = JR.calibrate_bn(jp, jcfg, jnp.asarray(x))
    with teacher.replay():
        got = R.calibrate_bn(p, cfg, torch.from_numpy(x))
    # the input tree is left as it was
    assert float(p["stem"]["bn"]["var"][0]) == 1.0
    n = 0
    for (path, a), b in zip(T.flatten_with_path(got),
                            jax.tree_util.tree_leaves(ref)):
        if path.endswith(("bn/mean", "bn/var")):
            _close(a, b)
            n += 1
    assert n == 2 * (1 + 2 * 3 + 2)     # stem, two convs a block, two ds


def test_folded_float_forward_taps_match_jax():
    jcfg, cfg = _cfgs("none")
    jp, _ = _params(jcfg, seed=5)
    x, _ = _batch(4, seed=9)
    jp = JR.calibrate_bn(jp, jcfg, jnp.asarray(x))
    jf = JR.fold_params(jp)
    folded = R.float_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jf), "cpu")
    ref_taps, taps = [], []
    ref = JR.folded_float_forward(
        jf, jcfg, jnp.asarray(x), tap=lambda s, h: ref_taps.append((s, h)))
    got = R.folded_float_forward(folded, cfg, torch.from_numpy(x),
                                 tap=lambda s, h: taps.append((s, h)))
    assert [s for s, _ in taps] == [s for s, _ in ref_taps]
    assert taps[0][0] == "input" and taps[-1][0] == "block2.out"
    for (_, a), (_, b) in zip(taps, ref_taps):
        _close(a, b)
    _close(got, ref)
    # BN folding itself, on the bridged BN-written params
    p = R.float_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    for a, b in zip(T.leaves(R.fold_params(p)),
                    jax.tree_util.tree_leaves(jf)):
        _close(a, b)


# ---------------------------------------------------------------------------
# compile.backends: the float backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("varied", [False, True])
def test_float_backend_matches_jax(varied):
    d = np_qparams(JR.RESNET8, seed=11, varied=varied)
    x, _ = _batch(6, seed=10)
    ref = np.asarray(jax_lower_forward(
        JR.RESNET8, JQResNetParams.from_dict(d), backend="float")(
            jnp.asarray(x)))
    got = lower_forward(R.RESNET8, params_from_numpy(d), "float",
                        "cpu")(x).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_float_backend_refuses_lm_configs():
    cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=8)
    params = init_lm_params(cfg, seed=0, device="cpu")
    with pytest.raises(LoweringError, match="no LM lowering"):
        get_backend("float").lower(None, cfg, params)


def test_float_backend_is_an_ab_shadow():
    qp = params_from_numpy(np_qparams(JR.RESNET8, seed=12))
    eng = ResNetEngine(R.RESNET8, qp, batch=4, backend="torch-int",
                       ab_backends=("float",), device="cpu")
    x, _ = _batch(6, seed=11)
    for i in range(6):
        eng.submit(ImageRequest(rid=i, image=x[i]))
    eng.run()
    devs = eng.ab_stats["float"]
    assert len(devs) == 2 and 0.0 <= max(devs) < 0.5
    assert "float" not in eng._bitwise
    # the shadow is a CompiledModel of its own, one executable a bucket
    assert eng.shadows["float"].trace_counts == {4: 1}
    assert compile_model(R.RESNET8, qp, backend="float",
                         device="cpu").backend.name == "float"
