"""The port's general int8 conv against the JAX package, on the CPU: the
port's ``conv2d_int8_op`` (its plain version here) bitwise equal to the JAX
``conv2d_int8_op`` (Pallas, interpret mode) and to the JAX oracle
``conv2d_int8_ref`` on the wrapper's padding, on the sweep of
``tests/test_kernels.py`` and on the traps of the JAX wrapper: its pad at
stride 2 is (1, 1), not ``lax`` SAME's (0, 1); a negative ``out_shift``
only clips; adds wrap as int32.  Inputs come from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_int8.ops import conv2d_int8_op as j_conv_op
from repro.kernels.conv2d_int8.ref import conv2d_int8_ref as j_conv_ref
from repro.tune.config import KernelConfig
from repro_torch.kernels.common import conv_i32
from repro_torch.kernels.conv2d_int8.ops import conv2d_int8_op, out_hw
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_plain,
                                                 conv2d_int8_ref, conv_pad)

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _case(seed, N, H, W, C, O, fh=3, fw=3, stride=1, xdtype=np.int8,
          skip=None, bias=100):
    """(x, w, b, skip) as numpy arrays; ``skip`` is None, "small" or
    "rails" (int32 values within 2^16 of the int32 limits)."""
    rng = np.random.default_rng(seed)
    lo, hi = (0, 256) if xdtype == np.uint8 else (-128, 128)
    x = rng.integers(lo, hi, (N, H, W, C)).astype(xdtype)
    w = rng.integers(-128, 128, (fh, fw, C, O)).astype(np.int8)
    b = rng.integers(-bias, bias, O).astype(np.int32)
    s = None
    if skip is not None:
        shape = (N, *out_hw(H, W, stride), O)
        if skip == "small":
            s = rng.integers(-1000, 1000, shape).astype(np.int32)
        else:
            s = np.where(rng.random(shape) < 0.5,
                         rng.integers(I32_MAX - 2 ** 16, I32_MAX, shape,
                                      endpoint=True),
                         rng.integers(I32_MIN, I32_MIN + 2 ** 16, shape,
                                      endpoint=True)).astype(np.int32)
    return x, w, b, s


def _jax(x, w, b, s, **kw):
    """The JAX op (interpret mode) and the JAX oracle on the JAX wrapper's
    padding, as int64 numpy arrays."""
    js = None if s is None else jnp.asarray(s)
    out = j_conv_op(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), js, **kw)
    (pt, pb), (pl, pr) = conv_pad(w.shape[0]), conv_pad(w.shape[1])
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    ref = j_conv_ref(xp, jnp.asarray(w), jnp.asarray(b), js, **kw)
    return np.asarray(out), np.asarray(ref)


def _port(x, w, b, s, **kw):
    t = (None if a is None else torch.from_numpy(np.array(a, copy=True))
         for a in (x, w, b, s))
    return conv2d_int8_op(*t, **kw)


CASES = [
    # the sweep of tests/test_kernels.py: (N, H, C, O, stride, relu, shift)
    dict(args=(0, 2, 8, 8, 4, 8), kw=dict(stride=1)),
    dict(args=(1, 2, 8, 8, 4, 8), kw=dict(stride=2)),
    dict(args=(2, 1, 16, 16, 8, 16), kw=dict(stride=1, relu=True,
                                             out_shift=7)),
    dict(args=(3, 2, 8, 8, 3, 16), kw=dict(stride=2, relu=True,
                                           out_shift=6)),
    # the skip stream as the accumulator init (test_conv2d_int8_skip_acc_init)
    dict(args=(4, 2, 8, 8, 4, 4), skip="small", kw=dict()),
    # a negative shift only clips (no left shift); a zero shift clips too
    dict(args=(5, 2, 8, 8, 4, 8), kw=dict(out_shift=-2)),
    dict(args=(6, 2, 8, 8, 4, 8), kw=dict(out_shift=0)),
    dict(args=(7, 2, 8, 8, 4, 8), kw=dict(relu=True, out_shift=-2)),
    dict(args=(8, 1, 8, 8, 4, 8), kw=dict(stride=2, out_shift=8)),
    # uint8 input, widened unsigned
    dict(args=(9, 2, 8, 8, 4, 8), xdtype=np.uint8,
         kw=dict(relu=True, out_shift=9)),
    dict(args=(10, 1, 9, 7, 3, 5), xdtype=np.uint8, kw=dict(stride=2)),
    # 1x1 (the ResNet downsample), 5x5 and an even, non-square filter
    dict(args=(11, 2, 8, 8, 8, 8), f=(1, 1), kw=dict(stride=2)),
    dict(args=(12, 1, 10, 10, 4, 8), f=(5, 5), kw=dict(relu=True,
                                                       out_shift=10)),
    dict(args=(13, 1, 9, 8, 4, 6), f=(2, 4), kw=dict(stride=2)),
    # odd sizes, channel counts not multiples of 4
    dict(args=(14, 2, 7, 5, 5, 7), kw=dict(stride=3, out_shift=5)),
    # int32 skip within 2^16 of the rails: bias + skip + products wrap
    dict(args=(15, 2, 8, 8, 4, 8), skip="rails", bias=2 ** 20, kw=dict()),
    dict(args=(16, 2, 8, 8, 4, 8), skip="rails", bias=2 ** 20,
         kw=dict(out_shift=3)),
    dict(args=(17, 2, 8, 8, 4, 8), skip="rails", bias=2 ** 20,
         kw=dict(relu=True, out_shift=31)),
]


def _ids(c):
    seed, N, H, W, C, O = c["args"]
    f = c.get("f", (3, 3))
    return (f"N{N}-{H}x{W}x{C}to{O}-f{f[0]}x{f[1]}-"
            f"{np.dtype(c.get('xdtype', np.int8)).name}-"
            f"skip{c.get('skip')}-" +
            "-".join(f"{k}{v}" for k, v in sorted(c["kw"].items())))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_conv2d_int8_plain_matches_jax_bitwise(case):
    seed, N, H, W, C, O = case["args"]
    fh, fw = case.get("f", (3, 3))
    kw = case["kw"]
    x, w, b, s = _case(seed, N, H, W, C, O, fh, fw, kw.get("stride", 1),
                       case.get("xdtype", np.int8), case.get("skip"),
                       case.get("bias", 100))
    out = _port(x, w, b, s, **kw)
    j_out, j_ref = _jax(x, w, b, s, **kw)
    assert str(out.dtype).split(".")[-1] == str(j_out.dtype), \
        (out.dtype, j_out.dtype)
    assert tuple(out.shape) == j_out.shape == \
        (N, *out_hw(H, W, kw.get("stride", 1)), O)
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(out.numpy(), j_ref)
    # the port's own oracle on the same pre-padded input
    (pt, pb), (pl, pr) = conv_pad(fh), conv_pad(fw)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    mine = conv2d_int8_ref(*(None if a is None else torch.from_numpy(a)
                             for a in (xp, w, b, s)), **kw)
    np.testing.assert_array_equal(mine.numpy(), j_ref)


def test_stride_2_pads_one_on_each_side_not_lax_same():
    """At stride 2 on an even size the JAX wrapper pads (1, 1), so the
    first output reads row and column -1; ``lax`` SAME (``conv_i32``, the
    block kernels' padding) pads (0, 1) and differs."""
    x, w, b, _ = _case(20, 2, 8, 8, 4, 8, stride=2)
    out = _port(x, w, b, None, stride=2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    same = conv_i32(tx, tw, 2) + torch.from_numpy(b)
    assert out.shape == same.shape == (2, 4, 4, 8)
    assert not torch.equal(out, same)
    xp = torch.nn.functional.pad(tx.permute(0, 3, 1, 2), (1, 1, 1, 1))
    manual = torch.nn.functional.conv2d(
        xp.double(), tw.double().permute(3, 2, 0, 1), stride=2)
    manual = manual.round().to(torch.int32).permute(0, 2, 3, 1) + \
        torch.from_numpy(b)
    assert torch.equal(out, manual)


def test_negative_shift_equals_zero_shift():
    """The JAX kernel shifts only when ``out_shift > 0``: -2 gives the same
    clipped map as 0 (the port's ``requant_u8`` would shift left)."""
    x, w, b, _ = _case(21, 1, 8, 8, 4, 8, bias=10)
    for relu in (False, True):
        neg = _port(x, w, b, None, relu=relu, out_shift=-2)
        assert torch.equal(neg, _port(x, w, b, None, relu=relu,
                                      out_shift=0))


def test_conv2d_int8_ignores_the_jax_tiling_knobs():
    """The JAX op's output does not depend on its tiling, so one port
    result stands for every JAX config."""
    x, w, b, _ = _case(22, 2, 8, 8, 4, 8)
    ref = _port(x, w, b, None, relu=True, out_shift=6).numpy()
    for cfg in (KernelConfig(batch_tile=2), KernelConfig(cout_block=4)):
        out = j_conv_op(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        relu=True, out_shift=6, config=cfg)
        np.testing.assert_array_equal(np.asarray(out), ref)


def _ops():
    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8)
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int8)
    b = torch.zeros(8, dtype=torch.int32)
    return x, w, b


@pytest.mark.parametrize("mutate,match", [
    (lambda x, w, b: (x.to(torch.int16), w, b, {}), "x must be"),
    (lambda x, w, b: (x[0], w, b, {}), "x must be"),
    (lambda x, w, b: (x.float(), w, b, {}), "x must be"),
    (lambda x, w, b: (x, w.to(torch.uint8), b, {}), "w must be"),
    (lambda x, w, b: (x, w[:, :, :3], b, {}), "w must be"),
    (lambda x, w, b: (x, w[0], b, {}), "w must be"),
    (lambda x, w, b: (x, w, b[:4], {}), "b must be"),
    (lambda x, w, b: (x, w, b.to(torch.int64), {}), "b must be"),
    (lambda x, w, b: (x, w, b, dict(skip=torch.zeros((1, 4, 4, 8)))),
     "skip must be"),
    (lambda x, w, b: (x, w, b, dict(skip=torch.zeros(
        (1, 2, 2, 8), dtype=torch.int32))), "skip must be"),
    (lambda x, w, b: (x, w, b, dict(stride=0)), "stride"),
    (lambda x, w, b: (x, w, b, dict(out_shift=32)), "out_shift"),
    (lambda x, w, b: (x, w, b, dict(out_shift=2.0)), "out_shift"),
    (lambda x, w, b: (x, w, b, dict(config=KernelConfig())), "config"),
    (lambda x, w, b: (x, w.to("meta"), b, {}), "different devices"),
    (lambda x, w, b: (x.to("meta"), w.to("meta"), b.to("meta"), {}),
     "unsupported device"),
])
def test_conv2d_int8_op_rejects_bad_operands(mutate, match):
    x, w, b, kw = mutate(*_ops())
    skip = kw.pop("skip", None)
    with pytest.raises(ValueError, match=match):
        conv2d_int8_op(x, w, b, skip, **kw)


def test_conv2d_int8_op_takes_int16_bias_and_counts_no_cpu_launch():
    x, w, b, _ = _case(23, 1, 6, 6, 4, 4)
    before = conv2d_int8_op.launches
    out16 = _port(x, w, b.astype(np.int16), None, out_shift=4)
    assert torch.equal(out16, _port(x, w, b, None, out_shift=4))
    assert conv2d_int8_op.launches == before
    assert torch.equal(out16, conv2d_int8_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        out_shift=4))
