"""The decomposition of the two conv kernels on the H100, on the CPU:
``conv_stem``'s banded path (``ops.stem_band_rows``, ``ops.stem_path``, the
filter as dp4a words) and ``conv2d_int8``'s tensor-core path
(``ops.conv_tiles``, ``ops.conv_path``, the filter in mma fragment order),
with the mirrors of each kernel's walk in its ``ref.py``
(``conv_stem_banded``, ``conv2d_int8_tiled``) held bitwise against the
plain versions and the JAX kernels (interpret mode).  The CUDA kernels
themselves are held in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_int8.ops import conv2d_int8_op as jax_conv2d_op
from repro.kernels.conv_stem.ops import conv_stem_op as jax_conv_stem_op
from repro_torch.kernels.conv2d_int8.ops import (FILTER_SLICE, conv_path,
                                                 conv_tiles, mma_smem_bytes,
                                                 out_hw)
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_plain,
                                                 conv2d_int8_tiled,
                                                 filter_from_fragments,
                                                 fragment_filter)
from repro_torch.kernels.conv_stem.ops import (band_smem_bytes,
                                               stem_band_rows, stem_path)
from repro_torch.kernels.conv_stem.ref import (conv_stem_banded,
                                               conv_stem_ref, stem_words)
from repro_torch.kernels.resblock_fused.ops import pack_conv
from repro_torch.tune.space import SMEM_BUDGET

H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---- (a) conv_stem's banded path -------------------------------------------

def test_stem_band_rows_at_the_engine_buckets():
    """Two thread blocks an SM at batch 32 (8 bands of 4 rows, 256 thread
    blocks); one band a row at batches 1 and 8; one an image at 256."""
    assert [stem_band_rows(32, n, H100_SMS) for n in (1, 8, 32, 256)] == \
        [1, 1, 4, 32]
    for n in (1, 8, 32):
        assert n * -(-32 // stem_band_rows(32, n, H100_SMS)) >= \
            min(32 * n, 2 * H100_SMS - 2 * H100_SMS % n)


@pytest.mark.parametrize("shape,cout,path", [
    ((32, 32, 32, 3), 16, "banded"), ((1, 32, 32, 3), 16, "banded"),
    ((256, 32, 32, 3), 16, "banded"), ((3, 17, 13, 1), 32, "banded"),
    ((2, 9, 9, 4), 48, "banded"), ((1, 32, 32, 3), 8, "general"),
    ((3, 32, 32, 3), 24, "general"), ((2, 8, 8, 5), 16, "general"),
    ((2, 8, 8, 16), 16, "general"),
    # a band of a 20,000-pixel row does not fit in shared memory
    ((1, 4, 20_000, 3), 16, "general")])
def test_stem_path_rule(shape, cout, path):
    """The banded path takes the RGB stem (Cin at most 4, Cout a multiple of
    16) where its band fits in shared memory; every other shape the
    general path."""
    assert stem_path(shape, cout, H100_SMS) == path
    n, h, w, cin = shape
    if cin <= 4 and cout % 16 == 0:
        band = stem_band_rows(h, n, H100_SMS)
        assert (band_smem_bytes(band, w, cin, cout) <= SMEM_BUDGET) == \
            (path == "banded")


@pytest.mark.parametrize("cin,cout", [(3, 16), (1, 8), (4, 24)])
def test_stem_words_are_dp4a_words_a_tap(cin, cout):
    """Word (tap, c) holds input channels 0..3 of output channel c at tap
    (kh, kw) = divmod(tap, 3); bytes past Cin are zero."""
    rng = np.random.default_rng(cin + cout)
    w = rng.integers(-128, 128, (3, 3, cin, cout)).astype(np.int8)
    words = stem_words(_t(w)).numpy()
    assert words.shape == (9, cout, 4)
    for tap in range(9):
        kh, kw = divmod(tap, 3)
        np.testing.assert_array_equal(words[tap, :, :cin], w[kh, kw].T)
    assert not words[:, :, cin:].any()


@pytest.mark.parametrize("n,h,w,cout", [(1, 32, 32, 8), (1, 32, 32, 16),
                                        (3, 17, 13, 24), (3, 17, 13, 16),
                                        (32, 32, 32, 16), (32, 32, 32, 24)])
def test_conv_stem_banded_matches_plain_and_jax(n, h, w, cout):
    """Bands of 1 row, the rule's band at 132 SMs, ragged bands and the
    whole image, for shifts > 0, = 0 and < 0."""
    rng = np.random.default_rng(n * h + cout)
    x = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    wt = rng.integers(-128, 128, (3, 3, 3, cout)).astype(np.int8)
    b = rng.integers(-500, 500, cout).astype(np.int32)
    bands = sorted({1, 3, 5, stem_band_rows(h, n, H100_SMS), h})
    for shift in (9, 0, -1):
        ref = conv_stem_ref(_t(x), _t(wt), _t(b), shift=shift)
        np.testing.assert_array_equal(ref.numpy(), np.asarray(
            jax_conv_stem_op(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                             shift=shift)))
        if shift > 0:
            assert 0 < ref.float().mean() < 255
        for band in bands:
            got = conv_stem_banded(_t(x), _t(wt), _t(b), shift=shift,
                                   band=band)
            assert torch.equal(got, ref), (shift, band)


# ---- (b) conv2d_int8's tensor-core path ------------------------------------

# ResNet20's conv layers at batch 32: (H, Cin, Cout, f, stride)
RESNET20_CONVS = [(32, 16, 16, 3, 1), (32, 16, 32, 3, 2), (16, 32, 32, 3, 1),
                  (16, 32, 64, 3, 2), (8, 64, 64, 3, 1), (32, 16, 32, 1, 2),
                  (16, 32, 64, 1, 2)]


def test_conv_tiles_at_resnet20_shapes():
    """At batch 32 on an H100: at least one thread block an SM for every
    ResNet20 layer, at most one warp item (16 pixels x 16 channels) a warp,
    the filter slice within FILTER_SLICE (at least 16 channels); the
    64-channel 3x3 conv in four channel groups, the 1x1 convs in one."""
    tiles = []
    for h, cin, cout, f, stride in RESNET20_CONVS:
        oh, ow = out_hw(h, h, stride)
        band, ng = conv_tiles(oh, ow, 32, cin, cout, f, f, H100_SMS)
        groups = -(-cout // 16) * 16 // ng
        assert ng % 16 == 0 and (ng == 16 or f * f * cin * ng <= FILTER_SLICE)
        assert 32 * groups * -(-oh // band) >= H100_SMS - H100_SMS % 32
        assert -(-band * ow // 16) * (ng // 16) <= 8
        tiles.append((band, ng))
    assert tiles == [(4, 16), (4, 32), (8, 16), (8, 16), (8, 16), (4, 32),
                     (2, 64)]
    # benchmarks/run.py's kernels_micro shape: one row a thread block
    assert conv_tiles(16, 16, 2, 16, 16, 3, 3, H100_SMS) == (1, 16)


@pytest.mark.parametrize("x_shape,w_shape,stride,aligned,path", [
    # ResNet20's 20 layers (their 7 shapes) and benchmarks' kernels_micro
    *[((32, h, h, cin), (f, f, cin, cout), s, True, "mma")
      for h, cin, cout, f, s in RESNET20_CONVS],
    ((2, 16, 16, 16), (3, 3, 16, 16), 1, True, "mma"),
    # C a multiple of 16 up to 128, O a multiple of 8, any stride
    ((2, 8, 8, 48), (3, 3, 48, 24), 3, True, "mma"),
    ((1, 9, 7, 128), (1, 1, 128, 8), 2, True, "mma"),
    # the shapes of the JAX sweep and its traps take the general path
    ((2, 8, 8, 4), (3, 3, 4, 8), 1, True, "general"),
    ((2, 8, 8, 3), (3, 3, 3, 16), 2, True, "general"),
    ((2, 8, 8, 8), (1, 1, 8, 8), 2, True, "general"),
    ((1, 10, 10, 16), (5, 5, 16, 16), 1, True, "general"),
    ((1, 9, 8, 16), (2, 4, 16, 16), 2, True, "general"),
    ((2, 7, 5, 16), (3, 3, 16, 5), 3, True, "general"),
    ((2, 8, 8, 16), (3, 3, 16, 12), 1, True, "general"),
    ((2, 8, 8, 144), (3, 3, 144, 16), 1, True, "general"),
    # operands the tensor-core loads cannot take, and a band too big
    ((32, 32, 32, 16), (3, 3, 16, 16), 1, False, "general"),
    ((1, 8, 4000, 128), (3, 3, 128, 16), 1, True, "general")])
def test_conv_path_rule(x_shape, w_shape, stride, aligned, path):
    assert conv_path(x_shape, w_shape, stride, H100_SMS, aligned) == path


def test_conv_path_rule_follows_shared_memory():
    """The mma path exactly where a thread block's band fits."""
    for x_shape, w_shape, stride in [((1, 64, 64, 128), (3, 3, 128, 256), 1),
                                     ((32, 8, 8, 64), (3, 3, 64, 64), 1),
                                     ((1, 8, 4000, 128), (3, 3, 128, 16), 1),
                                     ((1, 8, 1200, 64), (3, 3, 64, 64), 1)]:
        n, h, w, c = x_shape
        oh, ow = out_hw(h, w, stride)
        band, ng = conv_tiles(oh, ow, n, c, w_shape[3], w_shape[0],
                              w_shape[1], H100_SMS)
        fits = mma_smem_bytes(w, c, ng, w_shape[0], w_shape[1], stride,
                              band) <= SMEM_BUDGET
        assert (conv_path(x_shape, w_shape, stride, H100_SMS) == "mma") == \
            fits


@pytest.mark.parametrize("c,o,f", [(16, 16, 3), (32, 64, 3), (64, 64, 3),
                                   (16, 32, 1), (32, 64, 1), (48, 24, 3),
                                   (4, 8, 3)])
def test_fragment_filter_is_the_block_kernels_packing(c, o, f):
    """The order the tensor-core path stages its filter in equals
    ``pack_conv``'s (read back lane by lane in tests/test_torch_bands.py),
    and reads back to the zero-padded K x N matrices of each tap."""
    rng = np.random.default_rng(c * o + f)
    w = _t(rng.integers(-128, 128, (f, f, c, o)).astype(np.int8))
    frag = fragment_filter(w)
    assert torch.equal(frag, pack_conv(w).view(torch.int8).reshape(-1))
    mats = filter_from_fragments(frag, f, f, c, o)
    kp, np_ = -(-c // 16) * 16, -(-o // 16) * 16
    assert mats.shape == (f * f, kp, np_)
    assert torch.equal(mats[:, :c, :o], w.reshape(f * f, c, o))
    assert not mats[:, c:].any() and not mats[:, :, o:].any()


I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _conv_case(seed, n, h, w, c, o, fh, fw, stride, xdtype, skip):
    rng = np.random.default_rng(seed)
    lo, hi = (0, 256) if xdtype == np.uint8 else (-128, 128)
    x = rng.integers(lo, hi, (n, h, w, c)).astype(xdtype)
    wt = rng.integers(-128, 128, (fh, fw, c, o)).astype(np.int8)
    if skip == "rails":
        b = np.full(o, 2 ** 20, np.int32)
        s = rng.integers(I32_MAX - 2 ** 16, I32_MAX, (n, *out_hw(h, w, stride),
                                                      o), endpoint=True)
    else:
        b = rng.integers(-2000, 2000, o).astype(np.int32)
        s = rng.integers(-2 ** 16, 2 ** 16, (n, *out_hw(h, w, stride), o)) \
            if skip else None
    return x, wt, b, None if s is None else s.astype(np.int32)


@pytest.mark.parametrize("n,h,w,c,o,f,stride,xdtype,skip,kw", [
    # ResNet20's shapes (2 images), s8 input, requant, skip init
    (2, 32, 32, 16, 16, 3, 1, np.int8, True, dict(relu=True, out_shift=10)),
    (2, 32, 32, 16, 32, 3, 2, np.int8, False, dict(out_shift=10)),
    (2, 16, 16, 32, 32, 3, 1, np.uint8, True, dict(relu=True, out_shift=12)),
    (2, 16, 16, 32, 64, 3, 2, np.int8, False, dict()),
    (2, 8, 8, 64, 64, 3, 1, np.int8, True, dict(relu=True, out_shift=11)),
    (2, 32, 32, 16, 32, 1, 2, np.int8, False, dict(out_shift=-2)),
    (2, 16, 16, 32, 64, 1, 2, np.uint8, True, dict(relu=True, out_shift=0)),
    # ragged sizes, O not a multiple of 16, stride 3, the int32 rails
    (1, 9, 7, 48, 24, 3, 3, np.int8, True, dict(out_shift=9)),
    (2, 8, 8, 16, 16, 3, 1, np.int8, "rails", dict()),
    (2, 8, 8, 16, 16, 3, 1, np.uint8, "rails", dict(relu=True,
                                                    out_shift=31)),
    # general-path shapes: the walk is the same arithmetic
    (1, 10, 10, 4, 8, 5, 1, np.int8, False, dict(relu=True, out_shift=10)),
    (2, 7, 5, 5, 7, 3, 3, np.int8, False, dict(out_shift=5))])
def test_conv2d_int8_tiled_matches_plain_and_jax(n, h, w, c, o, f, stride,
                                                 xdtype, skip, kw):
    """Every band height from one row to the whole map and the channel
    groups of 16 and of all channels (the rule's tile at 132 SMs
    included), bitwise equal to the plain version and the JAX op."""
    x, wt, b, s = _conv_case(h * c + o + f + stride, n, h, w, c, o, f, f,
                             stride, xdtype, skip)
    kw = dict(stride=stride, **kw)
    ts = None if s is None else _t(s)
    ref = conv2d_int8_plain(_t(x), _t(wt), _t(b), ts, **kw)
    j = jax_conv2d_op(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                      None if s is None else jnp.asarray(s), **kw)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(j))
    oh, ow = out_hw(h, w, stride)
    rule = conv_tiles(oh, ow, n, c, o, f, f, H100_SMS)
    tiles = {rule} | {(band, ng) for band in (1, 2, 3, oh)
                      for ng in (16, None)}
    for band, ng in sorted(tiles, key=str):
        if band > oh:
            continue
        got = conv2d_int8_tiled(_t(x), _t(wt), _t(b), ts, band=band, ng=ng,
                                **kw)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (band, ng)
