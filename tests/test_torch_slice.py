"""The slice end to end: the port's ``torch-int`` backend against the JAX
package's ``lax-int`` at full width on ResNet8 and ResNet20 — the u8 feature
map bitwise against ``block_chain_ref`` (the unfused kernel oracle), the
logits within 1e-5 with equal argmax — on the fixed A_SPEC grid and on
varied per-tensor grids; and the port's ``cuda`` backend (plain versions on
the CPU) against the JAX ``pallas`` backend (interpret mode) at a tiny
config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.compile import lower_forward as jax_lower_forward
from repro.compile.params import QResNetParams as JQResNetParams
from repro.compile.params import activation_out_specs as jax_out_specs
from repro.core import quant as JQ
from repro.kernels.conv_stem.ops import conv_stem_op as jax_conv_stem_op
from repro.kernels.megakernel.megakernel import ChainBlockSpec
from repro.kernels.megakernel.ref import block_chain_ref
from repro.kernels.resblock_fused.ops import \
    resblock_fused_op as jax_resblock_fused_op
from repro.models import resnet as JR
from repro_torch.compile import lower_features, lower_forward
from repro_torch.compile import params_from_numpy
from repro_torch.models import resnet as R

LOGIT_ATOL = 1e-5   # float32 classifier, summed in another order


def _q_np(w, exp):
    """Round half away from zero onto a pow2 grid, int8 — the arithmetic of
    ``quantize_params`` in numpy, so the test builds weights without JAX."""
    q = np.sign(w) * np.floor(np.abs(w) * 2.0 ** -exp + 0.5)
    return np.clip(q, -128, 127).astype(np.int8)


def np_qparams(cfg, seed, varied=False):
    """Quantized ResNet params in the ``to_dict`` layout, made by numpy from
    ``seed``: He-normal weights on per-conv pow2 grids, random int16 biases,
    and JAX ``QSpec`` domains.  ``varied`` spreads the activation grids
    site by site (exponents -5, -4, -3), so requant and skip shifts of every
    sign occur, as the ``repro.quantize`` export produces them."""
    rng = np.random.default_rng(seed)
    n_sites = [0]

    def act():
        e = -4 + (n_sites[0] % 3) - 1 if varied else -4
        n_sites[0] += 1
        return JQ.QSpec(8, False, e)

    def conv(fh, ic, oc, x_spec):
        w = rng.normal(size=(fh, fh, ic, oc)) * np.sqrt(2.0 / (fh * fh * ic))
        w_exp = int(np.ceil(np.log2(np.abs(w).max() / 127)))
        w_spec = JQ.QSpec(8, True, w_exp)
        return dict(wq=_q_np(w, w_exp),
                    bq=rng.integers(-2000, 2000, oc).astype(np.int16),
                    w_spec=w_spec, x_spec=x_spec,
                    b_spec=JQ.bias_spec(x_spec, w_spec))

    h = act()
    d = dict(stem=conv(3, 3, cfg.base_width, JR.X_SPEC), blocks=[])
    ich = cfg.base_width
    for i, stride in enumerate(JR.block_strides(cfg)):
        och = cfg.base_width * 2 ** (i // cfg.blocks_per_stage)
        blk = dict(conv0=conv(3, ich, och, h))
        blk["conv1"] = conv(3, och, och, act())
        if stride != 1 or ich != och:
            blk["ds"] = conv(1, ich, och, h)
        d["blocks"].append(blk)
        h, ich = act(), och
    w_fc = rng.normal(size=(ich, cfg.num_classes)) / np.sqrt(ich)
    fc_exp = int(np.ceil(np.log2(np.abs(w_fc).max() / 127)))
    d["fc"] = dict(wq=_q_np(w_fc, fc_exp),
                   b=(rng.normal(size=cfg.num_classes) * 0.1).astype(
                       np.float32),
                   w_spec=JQ.QSpec(8, True, fc_exp))
    if varied:
        d["fc"]["x_spec"] = h
    return d


def jax_params(d):
    return jax.tree_util.tree_map(jnp.asarray, JQResNetParams.from_dict(d))


def images(n, seed=0, img=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.999, (n, img, img, 3)).astype(np.float32)


def jax_u8_map(cfg, jqp, imgs):
    """The u8 map of the JAX unfused kernel oracle on the params' specs."""
    stem_out, block_outs = jax_out_specs(jqp, JR.A_SPEC)
    st = jqp.stem
    ops, specs = [], []
    for i, (blk, stride) in enumerate(zip(jqp.blocks,
                                          JR.block_strides(cfg))):
        ws = (blk.conv0.wq, blk.conv0.bq.astype(jnp.int32), blk.conv1.wq,
              blk.conv1.bq.astype(jnp.int32))
        if blk.has_ds:
            ws += (blk.ds.wq, blk.ds.bq.astype(jnp.int32))
        ops.append(ws)
        specs.append(ChainBlockSpec(stride=stride, has_ds=blk.has_ds,
                                    **blk.shifts_for(block_outs[i].exp)))
    return np.asarray(block_chain_ref(
        JQ.quantize(jnp.asarray(imgs), st.x_spec), ops, specs=specs,
        stem=(st.wq, st.bq.astype(jnp.int32)),
        stem_shift=stem_out.exp - st.product_exp))


@pytest.mark.parametrize("grids", ["fixed", "varied"])
@pytest.mark.parametrize("arch", ["resnet8", "resnet20"])
def test_torch_int_matches_jax_lax_int_full_width(arch, grids):
    cfg, jcfg = getattr(R, arch.upper()), getattr(JR, arch.upper())
    d = np_qparams(jcfg, seed=len(arch), varied=grids == "varied")
    jqp, qp = jax_params(d), params_from_numpy(d)
    imgs = images(3)

    feats = lower_features(cfg, qp, "torch-int", device="cpu")(imgs).numpy()
    ref = jax_u8_map(jcfg, jqp, imgs)
    assert feats.shape == (3, 8, 8, 64) and feats.dtype == np.uint8
    np.testing.assert_array_equal(feats, ref)
    assert len(np.unique(feats)) > 16, "a flat feature map proves nothing"

    logits = lower_forward(cfg, qp, "torch-int", device="cpu")(imgs).numpy()
    jlogits = np.asarray(jax_lower_forward(jcfg, jqp, "lax-int")(
        jnp.asarray(imgs)))
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


TINY = R.ResNetConfig("tiny", 1, base_width=4, img=8)
JTINY = JR.ResNetConfig("tiny", 1, base_width=4, img=8)


def jax_pallas_u8_map(cfg, jqp, imgs):
    """The JAX ``pallas`` backend's kernel sequence up to the head."""
    stem_out, block_outs = jax_out_specs(jqp, JR.A_SPEC)
    st = jqp.stem
    h = jax_conv_stem_op(JQ.quantize(jnp.asarray(imgs), st.x_spec), st.wq,
                         st.bq, shift=stem_out.exp - st.product_exp)
    for i, (blk, stride) in enumerate(zip(jqp.blocks,
                                          JR.block_strides(cfg))):
        ds = (blk.ds.wq, blk.ds.bq.astype(jnp.int32)) if blk.has_ds \
            else (None, None)
        h = jax_resblock_fused_op(
            h, blk.conv0.wq, blk.conv0.bq.astype(jnp.int32), blk.conv1.wq,
            blk.conv1.bq.astype(jnp.int32), *ds, stride=stride,
            **blk.shifts_for(block_outs[i].exp))
    return np.asarray(h)


@pytest.mark.parametrize("grids", ["fixed", "varied"])
def test_cuda_backend_on_cpu_matches_jax_pallas_tiny(grids):
    d = np_qparams(JTINY, seed=4, varied=grids == "varied")
    jqp, qp = jax_params(d), params_from_numpy(d)
    imgs = images(2, seed=1, img=8)
    feats = lower_features(TINY, qp, "cuda", device="cpu")(imgs).numpy()
    np.testing.assert_array_equal(feats, jax_pallas_u8_map(JTINY, jqp, imgs))
    assert feats.any()
    logits = lower_forward(TINY, qp, "cuda", device="cpu")(imgs).numpy()
    jlogits = np.asarray(jax_lower_forward(JTINY, jqp, "pallas")(
        jnp.asarray(imgs)))
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=LOGIT_ATOL)


def test_cuda_and_torch_int_backends_agree_bitwise_on_cpu():
    """The two port backends share the plan and the shift derivation; on
    the CPU the cuda backend runs the kernels' plain versions."""
    cfg = dataclasses.replace(R.RESNET8, base_width=8)
    d = np_qparams(dataclasses.replace(JR.RESNET8, base_width=8), seed=9,
                   varied=True)
    qp = params_from_numpy(d)
    imgs = images(2, seed=2)
    a = lower_forward(cfg, qp, "cuda", device="cpu")(imgs)
    b = lower_forward(cfg, qp, "torch-int", device="cpu")(imgs)
    assert np.array_equal(a.numpy(), b.numpy())
