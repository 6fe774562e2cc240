"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU), bitwise, at the shapes and shifts of
tests/test_kernels.py, and the wrappers' argument checks.  The CUDA
kernels themselves are held in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_stem.ops import conv_stem_op as jax_conv_stem_op
from repro.kernels.resblock_fused.ops import \
    resblock_fused_op as jax_resblock_fused_op
from repro_torch.kernels.conv_stem.ops import conv_stem_op
from repro_torch.kernels.resblock_fused.ops import resblock_fused_op


def _u8(rng, *shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _i32(rng, n, lim=500):
    return rng.integers(-lim, lim, n).astype(np.int32)


def _block_operands(rng, n, h, cin, cout, ds):
    ops = [_u8(rng, n, h, h, cin), _i8(rng, 3, 3, cin, cout),
           _i32(rng, cout), _i8(rng, 3, 3, cout, cout), _i32(rng, cout)]
    if ds:
        ops += [_i8(rng, 1, 1, cin, cout), _i32(rng, cout)]
    return ops


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("shift", [9, 0, -1])
def test_conv_stem_plain_matches_jax_kernel(shift):
    rng = np.random.default_rng(5)
    x, w, b = _u8(rng, 2, 16, 16, 3), _i8(rng, 3, 3, 3, 16), _i32(rng, 16)
    before = conv_stem_op.launches
    got = conv_stem_op(_t(x), _t(w), _t(b), shift=shift)
    ref = jax_conv_stem_op(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           shift=shift)
    assert got.dtype == torch.uint8 and got.shape == (2, 16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert conv_stem_op.launches == before   # CPU: plain version, no launch


@pytest.mark.parametrize("n,h,c,skip_shift", [
    (1, 8, 4, 3), (2, 16, 16, 3), (1, 32, 16, 3), (2, 8, 8, 0),
    (1, 8, 8, -2)])
def test_resblock_identity_plain_matches_jax_kernel(n, h, c, skip_shift):
    rng = np.random.default_rng(h * c + skip_shift)
    ops = _block_operands(rng, n, h, c, c, ds=False)
    kw = dict(shift0=8, shift1=8, skip_shift=skip_shift)
    before = resblock_fused_op.launches
    got = resblock_fused_op(*map(_t, ops), **kw)
    ref = jax_resblock_fused_op(*map(jnp.asarray, ops), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert resblock_fused_op.launches == before


@pytest.mark.parametrize("n,h,cin,cout,skip_shift", [
    (1, 8, 4, 8, 3), (2, 16, 16, 32, 0), (1, 32, 16, 32, -2)])
def test_resblock_strided_downsample_plain_matches_jax_kernel(
        n, h, cin, cout, skip_shift):
    """Stride-2 conv0 with SAME padding (0, 1) and the fused 1x1 downsample,
    signed skip alignment shift."""
    rng = np.random.default_rng(h * cin + cout)
    ops = _block_operands(rng, n, h, cin, cout, ds=True)
    kw = dict(stride=2, shift0=8, shift1=8, skip_shift=skip_shift)
    got = resblock_fused_op(*map(_t, ops), **kw)
    ref = jax_resblock_fused_op(*map(jnp.asarray, ops), **kw)
    assert got.shape == (n, h // 2, h // 2, cout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_resblock_requant_shift_branches_match_jax_kernel():
    """requant_u8's three branches (shift > 0, = 0, < 0) on both convs."""
    rng = np.random.default_rng(11)
    ops = _block_operands(rng, 1, 8, 8, 8, ds=False)
    for s0, s1 in ((9, 0), (0, -1), (-1, 9)):
        kw = dict(shift0=s0, shift1=s1, skip_shift=1)
        np.testing.assert_array_equal(
            resblock_fused_op(*map(_t, ops), **kw).numpy(),
            np.asarray(jax_resblock_fused_op(*map(jnp.asarray, ops), **kw)))


def test_conv_stem_wrapper_rejects_bad_operands():
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    w = torch.zeros((3, 3, 3, 16), dtype=torch.int8)
    b = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        conv_stem_op(x.float(), w, b, shift=1)
    with pytest.raises(ValueError, match="w must be"):
        conv_stem_op(x, w[:, :, :2], b, shift=1)
    with pytest.raises(ValueError, match="b must be"):
        conv_stem_op(x, w, b[:8], shift=1)
    with pytest.raises(ValueError, match="shift"):
        conv_stem_op(x, w, b, shift=40)


def test_resblock_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(0)
    x, w0, b0, w1, b1, wd, bd = map(_t, _block_operands(rng, 1, 6, 4, 8,
                                                        ds=True))
    with pytest.raises(ValueError, match="together"):
        resblock_fused_op(x, w0, b0, w1, b1, wd, None, stride=2, shift0=1,
                          shift1=1)
    with pytest.raises(ValueError, match="identity skip"):
        resblock_fused_op(x, w0, b0, w1, b1, stride=1, shift0=1, shift1=1)
    with pytest.raises(ValueError, match="even"):
        resblock_fused_op(x[:, :5, :5], w0, b0, w1, b1, wd, bd, stride=2,
                          shift0=1, shift1=1)
    with pytest.raises(ValueError, match="skip_shift"):
        resblock_fused_op(x, w0, b0, w1, b1, wd, bd, stride=2, shift0=1,
                          shift1=1, skip_shift=-32)
    with pytest.raises(ValueError, match="w1 must be"):
        resblock_fused_op(x, w0, b0, w0, b1, wd, bd, stride=2, shift0=1,
                          shift1=1)
