"""The decomposition of the two block kernels on the H100, on the CPU:
``resblock_fused``'s row bands (``tune.space.block_band_rows``) and
``block_chain``'s thread blocks an image (``tune.space.chain_split``), the
packed weight layout both kernels read, and the banded mirrors in each
kernel's ``ref.py`` held bitwise against the plain versions and the JAX
kernels (interpret mode).  The CUDA kernels themselves are held in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_cuda import live_chain

from repro.kernels.megakernel.megakernel import \
    ChainBlockSpec as JChainBlockSpec
from repro.kernels.megakernel.ops import block_chain_op as jax_block_chain_op
from repro.kernels.resblock_fused.ops import \
    resblock_fused_op as jax_resblock_fused_op
from repro_torch.core import dataflow as df
from repro_torch.kernels.megakernel.ref import (block_chain_banded,
                                                block_chain_ref)
from repro_torch.kernels.resblock_fused.ops import pack_block, pack_conv
from repro_torch.kernels.resblock_fused.ref import (resblock_banded,
                                                    resblock_ref)
from repro_torch.tune import space

CPU = torch.device("cpu")


# ---- (a) resblock_fused's row bands ----------------------------------------

def _bands_of(h, stride, band):
    """Check one band height on an h-row input: every output row in exactly
    one band, and every input row a band's convs read inside both the rows
    it stages and the SAME-padded input."""
    pad_lo = 1 if stride == 1 else 0
    hp = h + pad_lo + 1                  # rows of the padded input
    oh = (hp - 3) // stride + 1
    bands = space.block_bands(oh, band)
    assert [r for r0, nb in bands for r in range(r0, r0 + nb)] == \
        list(range(oh))
    for r0, nb in bands:
        lo, hi = space.block_band_input_rows(r0, band, stride)
        assert hi - lo == (band + 1) * stride + 3
        # conv0 for y0 rows r0 - 1 .. r0 + nb (inside the map)
        for y in range(max(r0 - 1, 0), min(r0 + nb + 1, oh)):
            for row in range(y * stride, y * stride + 3):
                assert lo <= row < hi and 0 <= row < hp
        # the skip at padded row pad_lo + o * stride
        for o in range(r0, r0 + nb):
            assert lo <= pad_lo + o * stride < min(hi, hp)
    return oh


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 32), st.sampled_from([1, 2]), st.integers(1, 8))
def test_block_bands_cover_each_row_once_with_halos_in_the_padded_input(
        h, stride, parts):
    h += h % 2 if stride == 2 else 0     # the wrappers take even sizes
    oh = h // stride
    _bands_of(h, stride, -(-oh // min(parts, oh)))


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 32), st.sampled_from([1, 8, 32, 256]),
       st.sampled_from([1, 2]), st.sampled_from([114, 132]))
def test_block_band_rows_fills_the_card(h, n, stride, sms):
    """The rule's band: 1 .. oh rows, and at least sms // n bands an image
    (one wave of one thread block an SM), or one band a row."""
    h = max(2, h + h % 2) if stride == 2 else h
    oh = h // stride
    band = space.block_band_rows(oh, n, sms)
    assert 1 <= band <= oh
    parts = len(space.block_bands(oh, band))
    assert parts >= min(oh, max(1, sms // n))
    _bands_of(h, stride, band)


def test_block_band_rows_at_resnet20_shapes():
    """At bucket 32 more than one thread block an image on every block of
    an H100 (132 SMs)."""
    for h, _cin, _cout, stride in [(32, 16, 16, 1), (32, 16, 32, 2),
                                   (16, 32, 32, 1), (16, 32, 64, 2),
                                   (8, 64, 64, 1)]:
        oh = h // stride
        for n in (1, 8, 32):
            assert len(space.block_bands(
                oh, space.block_band_rows(oh, n, 132))) > 1
    assert [space.block_band_rows(oh, 32, 132) for oh in (32, 16, 8)] == \
        [8, 4, 2]
    assert [space.block_band_rows(oh, 8, 132) for oh in (32, 16, 8)] == \
        [2, 1, 1]


# ---- (b) block_chain's split -----------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(1, 16), st.sampled_from([1, 2]), st.integers(0, 3))
def test_chain_bands_line_up_across_links(half, stride, k):
    """Equal bands of a map and of the conv's output: a stride-1 conv's
    band r reads rows [r0 - 1, r1]; a stride-2 conv's output band r reads
    input rows [2 r0, 2 r1] — its own input band and the first row of the
    next (the zero ring after the last) — and its skip its own band."""
    h = 2 * half
    split = 2 ** k
    shape = df.BlockShape(h, h, 8, 8, stride == 2, stride)
    if split not in space.chain_splits([shape]):
        assert h % split or (h // stride) % split
        return
    bands_in = space.chain_bands(h, split)
    bands_out = space.chain_bands(h // stride, split)
    for (ri, nbi), (ro, nbo) in zip(bands_in, bands_out):
        assert nbi == nbo * stride
        for oy in range(ro, ro + nbo):
            pad_lo = 1 if stride == 1 else 0
            rows = [oy * stride + kh - pad_lo for kh in range(3)]
            assert ri - 1 <= min(rows) and max(rows) <= ri + nbi
            assert ri <= oy * stride < ri + nbi


# What cudaOccupancyMaxActiveClusters reported for block_chain on an H100
# SXM (chip_smoke.py's cluster_capacity): clusters of each split at two
# thread blocks an SM (60,000 B each) and at one (120,000 B).
H100_CLUSTERS = {(1, 2): 264, (1, 1): 132, (2, 2): 132, (2, 1): 66,
                 (4, 2): 62, (4, 1): 30, (8, 2): 30, (8, 1): 15}


def h100_capacity(split, smem):
    """The clusters an H100 runs at once, from :data:`H100_CLUSTERS`: two
    thread blocks share an SM while both fit its 228 KB with the 1 KB
    each reserves."""
    return H100_CLUSTERS[split, 2 if 2 * (smem + 1_024) <= 233_472 else 1]


@pytest.mark.parametrize("bps", [1, 3])
@pytest.mark.parametrize("n,bt", [(1, 1), (8, 1), (8, 2), (32, 1),
                                  (32, 2), (256, 1)])
def test_chain_split_is_legal_fits_and_fills_one_wave(bps, n, bt):
    shapes = df.resnet_block_shapes(bps)
    split = space.chain_split(shapes, n // bt, bt, stem_och=16,
                              capacity=h100_capacity)
    assert split in space.chain_splits(shapes)
    smem = df.chain_task_smem_bytes(shapes, bt, stem_och=16, split=split)
    assert smem <= space.SMEM_BUDGET
    if n // bt <= h100_capacity(split, smem):
        # no larger legal split also runs in one wave
        for s in space.chain_splits(shapes):
            if s > split:
                sm = df.chain_task_smem_bytes(shapes, bt, 16, split=s)
                assert n // bt > h100_capacity(s, sm)
    expect = {1: 8, 8: 8, 32: 4 if bt == 1 else 8, 256: 1}[n]
    assert split == expect


@pytest.mark.parametrize("budget,capacity,expect", [
    (space.SMEM_BUDGET, None, 8),       # the planner: the largest split
    (95_808, None, 8),
    (95_807, None, 8),                  # only split 8 fits
    (89_855, None, 8),                  # none fits: the smallest planes
    (space.SMEM_BUDGET, lambda s, m: 0, 1),   # no wave: the smallest
    (95_807, lambda s, m: 0, 8),        # ... of the splits that fit
    (space.SMEM_BUDGET, lambda s, m: 64 // s, 2)])
def test_chain_split_without_a_wave_or_a_capacity(budget, capacity, expect):
    """Without the card's capacity (the planner at batch 1) the rule takes
    the largest split whose thread block fits the budget; with one under
    which no split runs in one wave, the smallest that fits."""
    shapes = df.resnet_block_shapes(3)
    assert space.chain_split(shapes, 32, 1, stem_och=16, smem_budget=budget,
                             capacity=capacity) == expect


# ---- (c) the packed block ------------------------------------------------

@pytest.mark.parametrize("cin,cout,taps", [(16, 16, 9), (32, 64, 9),
                                           (64, 64, 9), (4, 8, 9),
                                           (8, 16, 1), (32, 64, 1)])
def test_pack_conv_is_the_mma_b_fragment_order(cin, cout, taps):
    """Read the packed filter back as the kernel's lanes do: lane 4g + t of
    step (tap, kt) and n-pair np holds, for n8 tile nt and k half j, the 4
    bytes k = kt * ks + 16 j + 4 t .. + 3 of output channel 16 np + 8 nt +
    g; channels past cin / cout are zero."""
    rng = np.random.default_rng(cin * cout + taps)
    fh = 3 if taps == 9 else 1
    w = torch.from_numpy(rng.integers(-128, 128, (fh, fh, cin, cout))
                         .astype(np.int8))
    packed = pack_conv(w).view(torch.int8).numpy()
    kp, np_ = -(-cin // 16) * 16, -(-cout // 16) * 16
    ks = 16 if kp % 32 else 32
    assert packed.size == taps * kp * np_
    frag = packed.reshape(taps, kp // ks, np_ // 16, 32, 2, ks // 16, 4)
    want = np.zeros((taps, kp, np_), np.int8)
    want[:, :cin, :cout] = w.numpy().reshape(taps, cin, cout)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for nt in range(2):
            for j in range(ks // 16):
                for b in range(4):
                    k = np.arange(kp // ks)[:, None] * ks + 16 * j + 4 * t + b
                    co = 16 * np.arange(np_ // 16)[None, :] + 8 * nt + g
                    np.testing.assert_array_equal(
                        frag[:, :, :, lane, nt, j, b], want[:, k, co])


@pytest.mark.parametrize("cin,cout,ds", [(16, 16, False), (16, 32, True),
                                         (64, 64, False), (4, 8, True)])
def test_pack_block_is_two_parts_of_the_formula_size(cin, cout, ds):
    rng = np.random.default_rng(cin + cout)
    ops = [rng.integers(-128, 128, (3, 3, cin, cout)).astype(np.int8),
           rng.integers(-500, 500, cout).astype(np.int32),
           rng.integers(-128, 128, (3, 3, cout, cout)).astype(np.int8),
           rng.integers(-500, 500, cout).astype(np.int32)]
    if ds:
        ops += [rng.integers(-128, 128, (1, 1, cin, cout)).astype(np.int8),
                rng.integers(-500, 500, cout).astype(np.int32)]
    t = [torch.from_numpy(a) for a in ops]
    packed = pack_block(*t).numpy()
    assert packed.size == df.packed_block_bytes(cin, cout, ds)
    a = df.packed_part_bytes(cin, cout, ds, 0)
    np_ = -(-cout // 16) * 16
    b0 = packed[:4 * np_].view(np.int32)
    b1, bd = packed[a:a + 4 * np_].view(np.int32), \
        packed[a + 4 * np_:a + 8 * np_].view(np.int32)
    np.testing.assert_array_equal(b0[:cout], ops[1])
    np.testing.assert_array_equal(b1[:cout], ops[3])
    np.testing.assert_array_equal(bd[:cout], ops[5] if ds else 0)
    assert not b0[cout:].any() and not b1[cout:].any()
    np.testing.assert_array_equal(packed[4 * np_:a],
                                  pack_conv(t[0]).numpy())


# ---- (d) the banded mirrors against the plain versions and JAX ------------

def _block_ops(rng, n, h, cin, cout, stride):
    ops = [rng.integers(0, 256, (n, h, h, cin)).astype(np.uint8),
           rng.integers(-128, 128, (3, 3, cin, cout)).astype(np.int8),
           rng.integers(-500, 500, cout).astype(np.int32),
           rng.integers(-128, 128, (3, 3, cout, cout)).astype(np.int8),
           rng.integers(-500, 500, cout).astype(np.int32)]
    if stride == 2 or cin != cout:
        ops += [rng.integers(-128, 128, (1, 1, cin, cout)).astype(np.int8),
                rng.integers(-500, 500, cout).astype(np.int32)]
    return ops


@pytest.mark.parametrize("n,h,cin,cout,stride,skip_shift", [
    (2, 8, 8, 8, 1, 2), (1, 8, 8, 16, 2, -1), (2, 16, 16, 32, 2, 0),
    (1, 6, 4, 4, 1, -2), (1, 12, 16, 16, 1, 1)])
def test_resblock_banded_matches_plain_and_jax(n, h, cin, cout, stride,
                                               skip_shift):
    """Every band height from 1 row (three y0 rows recomputed per output
    row) to the whole map, stride-2 heads included."""
    rng = np.random.default_rng(h * cin + stride)
    ops = _block_ops(rng, n, h, cin, cout, stride)
    kw = dict(stride=stride, shift0=10, shift1=10, skip_shift=skip_shift)
    t = [torch.from_numpy(a) for a in ops]
    ref = resblock_ref(*t, **kw)
    jax_out = np.asarray(jax_resblock_fused_op(
        *map(jnp.asarray, ops), **kw))
    np.testing.assert_array_equal(ref.numpy(), jax_out)
    assert 0 < ref.float().mean() < 255
    for band in range(1, h // stride + 1):
        got = resblock_banded(*t, band=band, **kw)
        assert torch.equal(got, ref), band


def _jax_chain(x, blocks, specs, stem, stem_shift):
    jb = tuple(tuple(jnp.asarray(w.numpy()) for w in ws) for ws in blocks)
    js = tuple(JChainBlockSpec(stride=s.stride, has_ds=s.has_ds,
                               shift0=s.shift0, shift1=s.shift1,
                               skip_shift=s.skip_shift) for s in specs)
    kw = {} if stem is None else dict(
        stem=tuple(jnp.asarray(t.numpy()) for t in stem),
        stem_shift=stem_shift)
    return np.asarray(jax_block_chain_op(jnp.asarray(x.numpy()), jb,
                                         specs=js, **kw))


# the narrow chains of tests/test_kernels.py as (cin, cout, stride) links on
# a 16x16 input, and a ResNet8-shaped chain at width 8 with the stem fused
CHAINS = {
    "singleton": ([(8, 8, 1)], 0),
    "stride-2 mid-chain": ([(8, 8, 1), (8, 16, 2), (16, 16, 1)], 0),
    "stride-2 head": ([(4, 8, 2), (8, 16, 2)], 0),
    "resnet8/2 + stem": ([(8, 8, 1), (8, 16, 2), (16, 32, 2)], 8),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_block_chain_banded_matches_plain_and_jax(name):
    """Every split the kernel can take (1-row bands at the deepest map
    included): bitwise equal to the plain version and the JAX kernel."""
    links, stem_och = CHAINS[name]
    h, shapes = 16, []
    for cin, cout, stride in links:
        shapes.append(df.BlockShape(h, h, cin, cout,
                                    stride != 1 or cin != cout, stride))
        h //= stride
    rng = np.random.default_rng(len(links) + stem_och)
    x, blocks, specs, stem, stem_shift = live_chain(rng, CPU, shapes, 2,
                                                    stem_och)
    ref = block_chain_ref(x, blocks, specs=specs, stem=stem,
                          stem_shift=stem_shift)
    np.testing.assert_array_equal(
        ref.numpy(), _jax_chain(x, blocks, specs, stem, stem_shift))
    assert 0 < ref.float().mean() < 255
    splits = space.chain_splits(shapes)
    assert len(splits) >= 3
    for split in splits:
        got = block_chain_banded(x, blocks, specs=specs, stem=stem,
                                 stem_shift=stem_shift, split=split)
        assert torch.equal(got, ref), split
