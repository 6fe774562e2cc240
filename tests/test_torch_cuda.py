"""GPU-only checks of the port's CUDA kernels and of the float LM server
(marked ``cuda``; each skips without a GPU).  This file imports no JAX, so
it also runs on a GPU machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.compile import (compile_model, get_task_impl,
                                 hidden_out_spec, init_lm_params, lm_config,
                                 lower_features, lower_forward, lowering,
                                 plan_lm)
from repro_torch.compile.compiler import GraphExecutable
from repro_torch.compile import backends as BK
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import dataflow as df
from repro_torch.core.quant import shift_align
from repro_torch.kernels.common import conv_i32, requant_u8
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.conv_stem import ops as stem_ops
from repro_torch.kernels.conv_stem.ops import conv_stem_op, stem_path
from repro_torch.kernels.conv_stem.ref import conv_stem_ref
from repro_torch.kernels.conv2d_int8 import ops as conv_ops
from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8_op, conv_path,
                                                 out_hw)
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_plain
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import (attn_tiles,
                                                     flash_attention_op)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_plain)
from repro_torch.kernels.matmul_int8 import ops as matmul_ops
from repro_torch.kernels.matmul_int8.ops import (matmul_int8_op,
                                                 matmul_path, pack_weight)
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
from repro_torch.kernels.megakernel import ops as chain_ops
from repro_torch.kernels.megakernel.ops import ChainBlockSpec, block_chain_op
from repro_torch.kernels.megakernel.ref import block_chain_ref
from repro_torch.kernels.resblock_fused import ops as block_ops
from repro_torch.kernels.resblock_fused.ops import resblock_fused_op
from repro_torch.kernels.resblock_fused.ref import resblock_ref
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ops import selective_scan_op
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.models import resnet as R
from repro_torch.obs import runtime as obsrt
from repro_torch.tune.config import KernelConfig
from repro_torch.tune import space
from repro_torch.tune.space import SMEM_BUDGET

pytestmark = pytest.mark.cuda

# ResNet20's five block shapes: (H, Cin, Cout, stride)
RESNET20_BLOCKS = [(32, 16, 16, 1), (32, 16, 32, 2), (16, 32, 32, 1),
                   (16, 32, 64, 2), (8, 64, 64, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _t(rng, dev, lo, hi, shape, dtype):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)


def test_cuda_kernels_match_plain_versions(dev):
    """Each CUDA kernel equals its plain version bitwise at the shapes the
    ResNet20 main path gives it, over positive, zero and negative shifts,
    and each launch is counted."""
    rng = np.random.default_rng(0)
    ops = (_t(rng, dev, 0, 256, (32, 32, 32, 3), np.uint8),
           _t(rng, dev, -128, 128, (3, 3, 3, 16), np.int8),
           _t(rng, dev, -500, 500, (16,), np.int32))
    before = conv_stem_op.launches
    for shift in (9, 0, -1):
        got = conv_stem_op(*ops, shift=shift)
        torch.cuda.synchronize()
        assert torch.equal(got, conv_stem_ref(*ops, shift=shift))
    assert conv_stem_op.launches == before + 3
    for h, cin, cout, stride in RESNET20_BLOCKS:
        ops = [_t(rng, dev, 0, 256, (32, h, h, cin), np.uint8),
               _t(rng, dev, -128, 128, (3, 3, cin, cout), np.int8),
               _t(rng, dev, -500, 500, (cout,), np.int32),
               _t(rng, dev, -128, 128, (3, 3, cout, cout), np.int8),
               _t(rng, dev, -500, 500, (cout,), np.int32)]
        if stride == 2:
            ops += [_t(rng, dev, -128, 128, (1, 1, cin, cout), np.int8),
                    _t(rng, dev, -500, 500, (cout,), np.int32)]
        for skip_shift in (3, 0, -2):
            kw = dict(stride=stride, shift0=11, shift1=12,
                      skip_shift=skip_shift)
            got = resblock_fused_op(*ops, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, resblock_ref(*ops, **kw)), \
                (h, cin, cout, stride, skip_shift)


# (N, H, W, Cin, Cout, path): the RGB stem at the engine's buckets and at
# 256, sizes that are not multiples of the band, and the general path
STEM_CASES = [(1, 32, 32, 3, 16, "banded"), (8, 32, 32, 3, 16, "banded"),
              (32, 32, 32, 3, 16, "banded"), (256, 32, 32, 3, 16, "banded"),
              (32, 30, 30, 3, 16, "banded"), (3, 17, 13, 3, 32, "banded"),
              (5, 9, 7, 1, 16, "banded"), (2, 11, 6, 4, 48, "banded"),
              (3, 16, 16, 3, 8, "general"), (2, 9, 9, 3, 24, "general"),
              (2, 8, 8, 8, 16, "general")]


@pytest.mark.parametrize("N,H,W,cin,cout,path", STEM_CASES)
def test_conv_stem_paths_at_every_bucket(dev, N, H, W, cin, cout, path):
    """Bitwise with the plain version for shifts > 0, = 0 and < 0 (a left
    shift), each launch counted on the path its shape picks."""
    rng = np.random.default_rng(N * H + W + cin + cout)
    big = (_t(rng, dev, 0, 256, (N, H, W, cin), np.uint8),
           _t(rng, dev, -128, 128, (3, 3, cin, cout), np.int8),
           _t(rng, dev, -500, 500, (cout,), np.int32))
    # small, skewed positive: accumulators inside [0, 255] at shifts 0, -1
    small = (_t(rng, dev, 0, 4, (N, H, W, cin), np.uint8),
             _t(rng, dev, -1, 4, (3, 3, cin, cout), np.int8),
             _t(rng, dev, 0, 20, (cout,), np.int32))
    assert stem_path((N, H, W, cin), cout, sm_count(dev.index)) == path
    for shift, ops in ((9, big), (0, small), (-1, small), (-3, big)):
        before = dict(conv_stem_op.launches_by_path)
        got = conv_stem_op(*ops, shift=shift)
        torch.cuda.synchronize()
        assert torch.equal(got, conv_stem_ref(*ops, shift=shift)), shift
        assert conv_stem_op.launches_by_path[path] == before[path] + 1
        if shift > 0:
            assert 0.2 < float(((got > 0) & (got < 255)).float().mean())


def test_kernel_smem_formulas_match_python(dev):
    """The banded stem's and the mma conv's shared memory as the CUDA
    sources compute it equals the wrappers' Python formulas."""
    lib = stem_ops._lib()
    for band, w, cin, cout in [(8, 32, 3, 16), (32, 32, 3, 16), (1, 7, 1, 48),
                               (5, 13, 4, 32)]:
        assert lib.conv_stem_band_smem_bytes(band, w, cin, cout) == \
            stem_ops.band_smem_bytes(band, w, cin, cout)
    lib = conv_ops._lib()
    for args in [(32, 16, 16, 3, 3, 1, 8), (32, 16, 32, 3, 3, 2, 4),
                 (8, 64, 64, 3, 3, 1, 2), (32, 16, 32, 1, 1, 2, 8),
                 (16, 48, 16, 3, 3, 3, 3)]:
        assert lib.conv2d_int8_mma_smem_bytes(*args) == \
            conv_ops.mma_smem_bytes(*args)


def test_wrappers_refuse_operands_split_across_devices(dev):
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=dev)
    w = torch.zeros((3, 3, 3, 16), dtype=torch.int8)
    b = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        conv_stem_op(x, w, b, shift=1)


def test_cuda_backend_matches_torch_int_on_gpu(dev):
    """The whole integer datapath of ResNet8 at full width: the kernel
    pipeline's u8 map equals the torch-int backend's bitwise."""
    cfg = R.RESNET8
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(1))), cfg)
    imgs = np.random.default_rng(1).uniform(0.0, 0.999, (5, 32, 32, 3))
    got = lower_features(cfg, qp, "cuda", device=dev)(imgs)
    ref = lower_features(cfg, qp, "torch-int", device=dev)(imgs)
    assert got.is_cuda and torch.equal(got, ref) and bool(got.any())


def _fit_shift(acc):
    """The requant shift that puts the 90th percentile of the positive
    accumulators near 192: most outputs then lie strictly inside (0, 255)."""
    pos = acc[acc > 0].double()
    q = float(torch.quantile(pos[:1 << 24], 0.9)) if pos.numel() else 1.0
    return int(math.ceil(math.log2(max(q, 1.0) / 192)))


def live_chain(rng, dev, shapes, n, stem_och=0, skips=(3, 0, -2)):
    """Random operands for a chain of ``df.BlockShape`` links and a random
    input (the RGB image when ``stem_och``), with every requant shift
    chosen link by link from the plain arithmetic so that the chain's maps
    stay alive; skip shifts cycle through ``skips``.  Returns
    ``(x, blocks, specs, stem, stem_shift)``."""
    def i8(*shape):
        return _t(rng, dev, -128, 128, shape, np.int8)

    def i32(c):
        return _t(rng, dev, -500, 500, (c,), np.int32)

    first = shapes[0]
    x = _t(rng, dev, 0, 256,
           (n, first.h, first.w, 3 if stem_och else first.ich), np.uint8)
    h, stem, stem_shift = x, None, None
    if stem_och:
        stem = (i8(3, 3, 3, stem_och), i32(stem_och))
        acc = conv_i32(x, stem[0]) + stem[1]
        stem_shift = _fit_shift(acc)
        h = requant_u8(acc, stem_shift)
    blocks, specs = [], []
    for i, b in enumerate(shapes):
        ws = (i8(3, 3, b.ich, b.och), i32(b.och), i8(3, 3, b.och, b.och),
              i32(b.och))
        if b.downsample:
            ws += (i8(1, 1, b.ich, b.och), i32(b.och))
        acc0 = conv_i32(h, ws[0], b.stride) + ws[1]
        shift0 = _fit_shift(acc0)
        skip_shift = skips[i % len(skips)]
        skip = shift_align(conv_i32(h, ws[4], b.stride) + ws[5]
                           if b.downsample else h, skip_shift)
        acc1 = conv_i32(requant_u8(acc0, shift0), ws[2]) + ws[3] + skip
        shift1 = _fit_shift(acc1)
        h = requant_u8(acc1, shift1)
        blocks.append(ws)
        specs.append(ChainBlockSpec(stride=b.stride, has_ds=b.downsample,
                                    shift0=shift0, shift1=shift1,
                                    skip_shift=skip_shift))
    return x, tuple(blocks), tuple(specs), stem, stem_shift


def _unsaturated(out):
    return float(((out > 0) & (out < 255)).float().mean())


def test_block_chain_matches_plain_version(dev):
    """The ResNet20 chain with the stem fused, at batch 32, and a narrow
    chain with a stride-2 head at batch_tile 1 and 2: bitwise equal to the
    plain version, one counted launch each, and the kernel's shared memory
    equal to the planner's formula."""
    rng = np.random.default_rng(3)
    shapes = df.resnet_block_shapes(3)
    x, blocks, specs, stem, stem_shift = live_chain(rng, dev, shapes, 32, 16)
    before = block_chain_op.launches
    got = block_chain_op(x, blocks, specs=specs, stem=stem,
                         stem_shift=stem_shift)
    torch.cuda.synchronize()
    ref = block_chain_ref(x, blocks, specs=specs, stem=stem,
                          stem_shift=stem_shift)
    assert got.shape == (32, 8, 8, 64) and torch.equal(got, ref)
    assert _unsaturated(got) >= 0.2
    assert block_chain_op.launches == before + 1
    assert chain_ops.smem_bytes(shapes, 1, 16) == \
        df.chain_task_smem_bytes(shapes, 1, stem_och=16)

    narrow = [df.BlockShape(16, 16, 4, 8, True, 2),
              df.BlockShape(8, 8, 8, 16, True, 2),
              df.BlockShape(4, 4, 16, 16, False, 1)]
    x, blocks, specs, _, _ = live_chain(rng, dev, narrow, 4)
    ref = block_chain_ref(x, blocks, specs=specs)
    assert _unsaturated(ref) >= 0.2
    for bt in (1, 2):
        got = block_chain_op(x, blocks, specs=specs,
                             config=KernelConfig(batch_tile=bt))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), bt
        assert chain_ops.smem_bytes(narrow, bt) == \
            df.chain_task_smem_bytes(narrow, bt)


@pytest.mark.parametrize("n", [1, 8, 32])
def test_resblock_fused_at_every_bucket_and_band(dev, n):
    """Every ResNet20 block shape at buckets 1, 8 and 32, each at the band
    height tune.space.block_band_rows picks for the card's SMs (more than
    one thread block an image at every bucket), skip shifts > 0, = 0, < 0:
    bitwise equal to the plain version; the kernel's packed block and
    shared memory match the Python formulas; a prepared launch records an
    SM of the card for every thread block, and more than one SM."""
    rng = np.random.default_rng(n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for h, cin, cout, stride in RESNET20_BLOCKS:
        band = space.block_band_rows(h // stride, n, sms)
        assert -(-(h // stride) // band) > 1
        assert block_ops.packed_bytes(cin, cout, stride == 2) == \
            df.packed_block_bytes(cin, cout, stride == 2)
        assert block_ops.smem_bytes(h, h, cin, cout, stride, stride == 2,
                                    band) <= SMEM_BUDGET
        ops = [_t(rng, dev, 0, 256, (n, h, h, cin), np.uint8),
               _t(rng, dev, -128, 128, (3, 3, cin, cout), np.int8),
               _t(rng, dev, -500, 500, (cout,), np.int32),
               _t(rng, dev, -128, 128, (3, 3, cout, cout), np.int8),
               _t(rng, dev, -500, 500, (cout,), np.int32)]
        if stride == 2:
            ops += [_t(rng, dev, -128, 128, (1, 1, cin, cout), np.int8),
                    _t(rng, dev, -500, 500, (cout,), np.int32)]
        for skip_shift in (3, 0, -2):
            kw = dict(stride=stride, shift0=11, shift1=12,
                      skip_shift=skip_shift)
            got = resblock_fused_op(*ops, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, resblock_ref(*ops, **kw)), \
                (n, band, h, cin, cout, stride, skip_shift)
        launch = block_ops.ResblockLaunch(*ops[1:], **kw)
        assert launch.band_rows(n, h // stride) == band
        ids = torch.full((launch.thread_blocks(n, h // stride),), -1,
                         dtype=torch.int32, device=dev)
        assert torch.equal(launch(ops[0], sm_ids=ids),
                           resblock_ref(*ops, **kw))
        assert 0 <= int(ids.min()) and int(ids.max()) < sms
        assert ids.unique().numel() > 1


@pytest.mark.parametrize("bps", [1, 3])
@pytest.mark.parametrize("n,bt", [(1, 1), (8, 1), (8, 2), (32, 1), (32, 2)])
def test_block_chain_at_every_bucket_and_split(dev, bps, n, bt):
    """The ResNet8 and ResNet20 chains with the stem fused at buckets 1, 8
    and 32, batch tiles 1 and 2, each at the split tune.space.chain_split
    picks from the clusters the card runs at once (on an H100, 8 thread
    blocks an image at buckets 1 and 8 and at 32 with tile 2, 4 at 32 with
    tile 1): bitwise equal to the plain version, the kernel's shared
    memory at that split equal to the planner's formula, and a prepared
    launch at that split recording an SM for each of its thread blocks."""
    rng = np.random.default_rng(10 * n + bt)
    shapes = df.resnet_block_shapes(bps)
    split = space.chain_split(shapes, n // bt, bt, stem_och=16,
                              capacity=chain_ops.max_clusters)
    assert split > 1
    smem = chain_ops.smem_bytes(shapes, bt, 16, split)
    assert smem == df.chain_task_smem_bytes(shapes, bt, stem_och=16,
                                            split=split)
    assert n // bt <= chain_ops.max_clusters(split, smem)
    x, blocks, specs, stem, stem_shift = live_chain(rng, dev, shapes, n, 16)
    got = block_chain_op(x, blocks, specs=specs, stem=stem,
                         stem_shift=stem_shift,
                         config=KernelConfig(batch_tile=bt))
    torch.cuda.synchronize()
    ref = block_chain_ref(x, blocks, specs=specs, stem=stem,
                          stem_shift=stem_shift)
    assert torch.equal(got, ref), (bps, n, bt, split)
    launch = chain_ops.ChainLaunch(blocks, specs=specs, in_shape=x.shape[1:],
                                   stem=stem, stem_shift=stem_shift,
                                   config=KernelConfig(batch_tile=bt))
    assert launch.tiling(n) == (bt, split)
    ids = torch.full((launch.thread_blocks(n),), -1, dtype=torch.int32,
                     device=dev)
    assert torch.equal(launch(x, sm_ids=ids), ref)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 0 <= int(ids.min()) and int(ids.max()) < sms


# Block shapes (H, Cin, Cout, stride) of the forced-tile cases: ResNet20's
# five (ResNet8's three among them: identity at stride 1, the fused 1x1
# downsample at stride 2), a stride-1 block with the downsample, and a
# ragged 48-channel map (three channel pairs, 6 output rows).
TILE_BLOCKS = RESNET20_BLOCKS + [(16, 16, 32, 1), (12, 8, 48, 2)]


def _tile_cases():
    """(shape, tile of phase A, tile of phase B, band) for every tile the
    shape's channel pairs take: both phases at each tile with one band an
    image (the b256 layout) and with 3-row bands (ragged pixel tiles and a
    short band at the map's last rows), and phase A at each tile beside
    phase B at (1, 1)."""
    out = []
    for h, cin, cout, stride in TILE_BLOCKS:
        oh, nps = h // stride, -(-cout // 16)
        for tile in space.TILES:
            if nps % tile[1]:
                continue
            shape = (h, cin, cout, stride)
            out += [(shape, tile, tile, oh), (shape, tile, tile, 3)]
            if tile != (1, 1):
                out.append((shape, tile, (1, 1), 3))
    return out


def _replayed(fn, op):
    """``fn()`` captured into a CUDA graph, replayed once with the capture's
    launch counts added as CompiledModel adds them; returns the replay's
    output and what the op's ``launches_by_path`` gained."""
    from repro_torch.kernels import common

    graph, out, delta = common.capture_graph(fn)
    before = dict(op.launches_by_path)
    graph.replay()
    common.add_launches(delta)
    torch.cuda.synchronize()
    return out, {p: k - before[p] for p, k in op.launches_by_path.items()}


@pytest.mark.parametrize("shape,tile_a,tile_b,band", _tile_cases())
def test_resblock_fused_every_tile_bitwise(dev, monkeypatch, shape, tile_a,
                                           tile_b, band):
    """Every tile of block_body.cuh's set forced through the launch's tile
    arguments (``block_tiles`` patched), at every block shape: the u8 map
    bitwise the plain version's, eagerly and from a captured graph's
    replay, and the replay counted on the path its tiles take."""
    h, cin, cout, stride = shape
    monkeypatch.setattr(block_ops, "block_tiles",
                        lambda *a: (tile_a, tile_b))
    rng = np.random.default_rng(sum(shape) + 7 * band)
    ops = [_t(rng, dev, 0, 256, (2, h, h, cin), np.uint8),
           _t(rng, dev, -128, 128, (3, 3, cin, cout), np.int8),
           _t(rng, dev, -500, 500, (cout,), np.int32),
           _t(rng, dev, -128, 128, (3, 3, cout, cout), np.int8),
           _t(rng, dev, -500, 500, (cout,), np.int32)]
    if stride == 2 or cin != cout:
        ops += [_t(rng, dev, -128, 128, (1, 1, cin, cout), np.int8),
                _t(rng, dev, -500, 500, (cout,), np.int32)]
    kw = dict(stride=stride, shift0=11, shift1=12,
              skip_shift=(3, 0, -2)[band % 3])
    ref = resblock_ref(*ops, **kw)
    assert _unsaturated(ref) >= 0.2
    launch = block_ops.ResblockLaunch(*ops[1:], **kw,
                                      config=KernelConfig(band_rows=band))
    oh = h // stride
    assert launch.band_rows(2, oh) == band
    assert launch.tiles(2, oh, oh) == (tile_a, tile_b)
    assert torch.equal(launch(ops[0]), ref)
    out, gained = _replayed(lambda: launch(ops[0]), resblock_fused_op)
    assert torch.equal(out, ref)
    path = "single" if tile_a == tile_b == (1, 1) else "tiled"
    assert gained == {p: int(p == path) for p in block_ops.PATHS}


@pytest.mark.parametrize("tile", space.CHAIN_TILES)
@pytest.mark.parametrize("bps", [1, 3])
@pytest.mark.parametrize("split", [1, 4, 8])
def test_block_chain_every_tile_bitwise(dev, monkeypatch, tile, bps, split):
    """The ResNet8 and ResNet20 chains with the stem fused, each link
    forced to ``tile`` of the chain's set where its channel pairs take it
    (else (1, 1)), at splits 1 (one band an image, the b256 layout), 4 and
    8 (a band of 1-2 rows of 8, ragged pixel tiles): bitwise the plain
    version, eagerly and from a captured graph's replay, counted on the
    path of its tiles."""
    shapes = df.resnet_block_shapes(bps)
    forced = tuple(tile if -(-b.och // 16) % tile[1] == 0 else (1, 1)
                   for b in shapes)
    monkeypatch.setattr(chain_ops, "chain_tiles", lambda *a: forced)
    rng = np.random.default_rng(100 * bps + split)
    x, blocks, specs, stem, stem_shift = live_chain(rng, dev, shapes, 2, 16)
    ref = block_chain_ref(x, blocks, specs=specs, stem=stem,
                          stem_shift=stem_shift)
    launch = chain_ops.ChainLaunch(blocks, specs=specs, in_shape=x.shape[1:],
                                   stem=stem, stem_shift=stem_shift,
                                   config=KernelConfig(split=split))
    assert launch.tiling(2) == (1, split)
    assert launch.link_tiles(2) == forced
    assert torch.equal(launch(x), ref)
    out, gained = _replayed(lambda: launch(x), block_chain_op)
    assert torch.equal(out, ref)
    path = "single" if tile == (1, 1) else "tiled"
    assert gained == {p: int(p == path) for p in chain_ops.PATHS}


@pytest.mark.parametrize("tile", sorted(set(space.TILES) -
                                         set(space.CHAIN_TILES)))
def test_block_chain_refuses_a_tile_outside_its_set(dev, monkeypatch, tile):
    """A tile 4 long, which block_chain does not instantiate, is refused at
    launch (cudaErrorInvalidValue), never run, and not counted."""
    shapes = df.resnet_block_shapes(1)
    monkeypatch.setattr(chain_ops, "chain_tiles",
                        lambda *a: (tile,) + ((1, 1),) * (len(shapes) - 1))
    x, blocks, specs, stem, stem_shift = live_chain(
        np.random.default_rng(6), dev, shapes, 2, 16)
    before = block_chain_op.launches
    with pytest.raises(RuntimeError):
        block_chain_op(x, blocks, specs=specs, stem=stem,
                       stem_shift=stem_shift)
    assert block_chain_op.launches == before


@pytest.mark.parametrize("backend,op", [("cuda", "resblock_fused"),
                                        ("cuda-stream", "block_chain")])
def test_bucket_256_runs_every_block_launch_tiled(dev, backend, op):
    """Served at bucket 256 (one band an image, split 1), every launch of
    the block kernels takes a register tile: ``launches_by_path`` counts
    each replay's launches as ``tiled``, and the logits are bitwise the
    eager lowered forward's."""
    cfg, qp = _resnet8_qparams()
    cm = compile_model(cfg, qp, backend=backend, batch_sizes=(256,))
    counted = dict(resblock_fused=resblock_fused_op,
                   block_chain=block_chain_op)[op]
    x = _images(dev, 256, seed=9)
    cm.warmup()
    before = dict(counted.launches_by_path)
    got = cm(x)
    gained = {p: k - before[p] for p, k in counted.launches_by_path.items()}
    assert gained == dict(single=0,
                          tiled=dict(resblock_fused=3, block_chain=1)[op])
    ref = lower_forward(cfg, qp, backend)(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_block_chain_over_budget_is_refused(dev):
    """A chain whose thread block needs more shared memory than the H100
    gives one, at every split, is refused at launch, never run: two
    buffers of a 128->128 link's packed block alone exceed it."""
    shapes = [df.BlockShape(32, 32, 128, 128)] * 2
    assert all(df.chain_task_smem_bytes(shapes, 1, split=s) > SMEM_BUDGET
               for s in space.chain_splits(shapes))
    x, blocks, specs, _, _ = live_chain(np.random.default_rng(4), dev,
                                        shapes, 2)
    before = block_chain_op.launches
    with pytest.raises((RuntimeError, ValueError)):
        block_chain_op(x, blocks, specs=specs)
    assert block_chain_op.launches == before


def test_lowered_cuda_stream_forward_launches_without_revalidating(
        dev, monkeypatch):
    """The lowered cuda-stream forward of ResNet8 is one prepared
    ChainLaunch: with the wrappers' validation, link table and weight
    packing made to raise after lowering, it still launches once per call
    and its u8 map equals torch-int's."""
    from repro_torch.compile.params import ensure_typed

    cfg = R.RESNET8
    qp = ensure_typed(R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(2))), cfg)).to(dev)
    feats = BK.CudaStreamBackend().features(lowering.optimized_graph(cfg),
                                            cfg, qp)
    imgs = torch.from_numpy(np.random.default_rng(2).uniform(
        0.0, 0.999, (8, 32, 32, 3)).astype(np.float32)).to(dev)
    ref = lower_features(cfg, qp, "torch-int", device=dev)(imgs)

    def refuse(*a, **k):
        raise AssertionError("per-call validation on the lowered path")

    for name in ("_check_chain", "_link_ints", "pack_block"):
        monkeypatch.setattr(chain_ops, name, refuse)
    before = block_chain_op.launches
    got = feats(imgs)
    torch.cuda.synchronize()
    assert block_chain_op.launches == before + 1
    assert torch.equal(got, ref) and bool(got.any())


def test_cuda_stream_backend_matches_torch_int_on_gpu(dev):
    """ResNet20 at full width through one block_chain launch: the u8 map
    equals the torch-int backend's bitwise."""
    cfg = R.RESNET20
    qp = R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(2))), cfg)
    imgs = np.random.default_rng(2).uniform(0.0, 0.999, (5, 32, 32, 3))
    before = block_chain_op.launches
    got = lower_features(cfg, qp, "cuda-stream", device=dev)(imgs)
    assert block_chain_op.launches == before + 1
    ref = lower_features(cfg, qp, "torch-int", device=dev)(imgs)
    assert got.is_cuda and torch.equal(got, ref) and bool(got.any())


# -- the LM kernels ---------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [
    (512, 256, 16),      # the thin B/C projections' N, a full row tile
    (130, 96, 200),      # ragged M and N
    (64, 30, 12),        # K not a multiple of 4: byte-wise staging
    (33, 64, 18),        # N not a multiple of 4
])
def test_matmul_int8_matches_plain_version(dev, M, K, N):
    """Bitwise with the float64 plain version, with and without an
    accumulator init, also when the init is a stride-0 broadcast."""
    rng = np.random.default_rng(M + K + N)
    a = _t(rng, dev, -128, 128, (M, K), np.int8)
    b = _t(rng, dev, -128, 128, (K, N), np.int8)
    init = _t(rng, dev, -2 ** 20, 2 ** 20, (M, N), np.int32)
    bias = _t(rng, dev, -2 ** 20, 2 ** 20, (1, N), np.int32).expand(M, N)
    before = matmul_int8_op.launches
    for acc in (None, init, bias):
        got = matmul_int8_op(a, b, acc)
        torch.cuda.synchronize()
        assert torch.equal(got, matmul_int8_ref(a, b, acc))
    assert matmul_int8_op.launches == before + 3


def _lm_projections():
    """(model, role, K, N) of every projection of gemma-2b and
    falcon-mamba-7b at published width."""
    g, f = get_config("gemma-2b"), get_config("falcon-mamba-7b")
    qkv, kv = g.num_heads * g.head_dim, g.num_kv_heads * g.head_dim
    return [("gemma-2b", "wq", g.d_model, qkv),
            ("gemma-2b", "wk/wv", g.d_model, kv),
            ("gemma-2b", "wo", qkv, g.d_model),
            ("gemma-2b", "up", g.d_model, g.d_ff),
            ("gemma-2b", "down", g.d_ff, g.d_model),
            ("falcon-mamba-7b", "wu/wz/wdt", f.d_model, f.d_inner),
            ("falcon-mamba-7b", "wb/wc", f.d_model, f.ssm_state),
            ("falcon-mamba-7b", "wo", f.d_inner, f.d_model)]


def _path_of(fn):
    """Run ``fn`` and return the one matmul_int8 path it launched."""
    before = dict(matmul_int8_op.launches_by_path)
    out = fn()
    torch.cuda.synchronize()
    rose = {p: n - before[p] for p, n in
            matmul_int8_op.launches_by_path.items() if n != before[p]}
    assert len(rose) == 1 and list(rose.values()) == [1], rose
    return out, next(iter(rose))


@pytest.mark.parametrize("M", [512, 2048])
@pytest.mark.parametrize("name,role,K,N", _lm_projections())
def test_matmul_int8_lm_shapes_take_wgmma_bitwise(dev, name, role, K, N, M):
    """Every LM projection shape at bucket 1 and 4 (M = 512, 2048): B as
    (K, N) and packed, acc_init full, broadcast over the rows (row stride
    0, the main path's bias) and none; bitwise with the plain version, and
    every launch on the wgmma path."""
    rng = np.random.default_rng(K + N + M)
    a = _t(rng, dev, -128, 128, (M, K), np.int8)
    b = _t(rng, dev, -128, 128, (K, N), np.int8)
    w = pack_weight(b)
    full = _t(rng, dev, -2 ** 20, 2 ** 20, (M, N), np.int32)
    bias = _t(rng, dev, -2 ** 20, 2 ** 20, (1, N), np.int32).expand(M, N)
    assert matmul_path(M, N, K) == "wgmma"
    for acc in (full, bias, None):
        ref = matmul_int8_ref(a, b, acc)
        for bb in (b, w):
            got, path = _path_of(lambda: matmul_int8_op(a, bb, acc))
            assert path == "wgmma"
            assert torch.equal(got, ref)


def test_matmul_int8_init_wraps_as_int32_on_the_wgmma_path(dev):
    """acc_init within 2^16 of +-2^31: the add wraps modulo 2^32 as the
    plain version's int32 add does, with split-K (N = 16) and without."""
    rng = np.random.default_rng(7)
    for M, K, N in ((512, 2048, 2048), (2048, 4096, 16)):
        a = _t(rng, dev, -128, 128, (M, K), np.int8)
        w = pack_weight(_t(rng, dev, -128, 128, (K, N), np.int8))
        near = _t(rng, dev, 0, 2 ** 16, (M, N), np.int32)
        wrap = torch.where(near % 2 == 0, (2 ** 31 - 1) - near,
                           -2 ** 31 + near)
        plain = matmul_int8_ref(a, w.unpacked())
        assert bool(((plain.to(torch.int64) + wrap.to(torch.int64)) !=
                     (plain + wrap).to(torch.int64)).any())
        for acc in (wrap, wrap[:1].expand(M, N)):
            got, path = _path_of(lambda: matmul_int8_op(a, w, acc))
            assert path == "wgmma"
            assert torch.equal(got, matmul_int8_ref(a, w.unpacked(), acc))


@pytest.mark.parametrize("M,K,N", [(1000, 2048, 200), (77, 30, 18),
                                   (129, 4096, 16)])
def test_matmul_int8_ragged_shapes_take_the_path_of_their_shape(dev, M, K,
                                                                N):
    """K or N not a multiple of 16 runs the mma_sync path, a ragged M with
    aligned K and N the wgmma path; both bitwise, packed or not."""
    rng = np.random.default_rng(M + K)
    a = _t(rng, dev, -128, 128, (M, K), np.int8)
    b = _t(rng, dev, -128, 128, (K, N), np.int8)
    bias = _t(rng, dev, -2 ** 20, 2 ** 20, (1, N), np.int32).expand(M, N)
    want = "wgmma" if K % 16 == 0 and N % 16 == 0 else "mma_sync"
    for bb in (b, pack_weight(b)):
        for acc in (bias, None):
            got, path = _path_of(lambda: matmul_int8_op(a, bb, acc))
            assert path == want
            assert torch.equal(got, matmul_int8_ref(a, b, acc))
    # a misaligned A (a view one byte in) takes the mma_sync path
    a1 = _t(rng, dev, -128, 128, (M * K + 1,), np.int8)[1:].view(M, K)
    got, path = _path_of(lambda: matmul_int8_op(a1, b, bias))
    assert path == "mma_sync"
    assert torch.equal(got, matmul_int8_ref(a1, b, bias))


def test_matmul_int8_copies_an_init_view_it_cannot_read_in_place(dev):
    """A full acc_init the TMA cannot read (4-byte aligned, a view one
    element into its storage) or a transposed view is copied first; the
    result is the same."""
    rng = np.random.default_rng(3)
    M, K, N = 256, 512, 64
    a = _t(rng, dev, -128, 128, (M, K), np.int8)
    w = pack_weight(_t(rng, dev, -128, 128, (K, N), np.int8))
    flat = _t(rng, dev, -2 ** 20, 2 ** 20, (M * N + 1,), np.int32)
    for init in (flat[1:].view(M, N), flat[:M * N].view(N, M).t()):
        got, path = _path_of(lambda: matmul_int8_op(a, w, init))
        assert path == "wgmma"
        assert torch.equal(got, matmul_int8_ref(a, w.unpacked(), init))


def _normal(rng, dev, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)


def _attention_ref(q, k, v, causal):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def flat(t, s):
        return t.repeat_interleave(H // t.shape[2], dim=2).permute(
            0, 2, 1, 3).reshape(B * H, s, hd)

    o = attention_ref(flat(q, Sq), flat(k, Sk), flat(v, Sk), causal=causal)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,dtype", [
    (1, 64, 64, 2, 2, 16, True, torch.float32),
    (2, 128, 128, 4, 2, 32, True, torch.float32),
    (1, 64, 64, 2, 1, 16, False, torch.float32),
    (1, 32, 128, 4, 1, 64, True, torch.float32),     # decode: Sq < Sk
    (2, 100, 100, 2, 1, 256, True, torch.float32),   # ragged tiles, hd 256
    (1, 64, 64, 2, 2, 16, True, torch.bfloat16),
])
def test_flash_attention_matches_reference(dev, B, Sq, Sk, H, KV, hd, causal,
                                           dtype):
    """Within the JAX tests' tolerance of the naive softmax (2e-5; 2e-2 in
    bf16), output in the input's type, one counted launch."""
    rng = np.random.default_rng(Sq + H)
    q = _normal(rng, dev, (B, Sq, H, hd), dtype)
    k = _normal(rng, dev, (B, Sk, KV, hd), dtype)
    v = _normal(rng, dev, (B, Sk, KV, hd), dtype)
    before = flash_attention_op.launches
    out = flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and flash_attention_op.launches == before + 1
    ref = _attention_ref(q, k, v, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,dtype", [
    (2, 128, 128, 4, 4, 64, True, torch.float32),    # no grouping
    (1, 128, 128, 8, 2, 64, True, torch.float32),    # 4 heads a kv head
    (2, 96, 96, 8, 1, 128, True, torch.float32),     # MQA, hd 128
    (1, 64, 200, 8, 1, 256, True, torch.float32),    # decode, ragged Sk
    (1, 100, 130, 4, 2, 128, False, torch.float32),  # ragged Sq and Sk
    (2, 64, 64, 3, 1, 48, True, torch.float32),      # a group of 3
    (1, 80, 80, 8, 1, 256, True, torch.bfloat16),
])
def test_flash_attention_matches_plain_version(dev, B, Sq, Sk, H, KV, hd,
                                               causal, dtype):
    """Within the JAX tests' tolerance (2e-5; 2e-2 in bf16) of the plain
    version on the kernel's own tiles, for every head grouping the thread
    block packs, head dims 48 to 256 and ragged lengths."""
    rng = np.random.default_rng(Sq + Sk + H)
    q = _normal(rng, dev, (B, Sq, H, hd), dtype)
    k = _normal(rng, dev, (B, Sk, KV, hd), dtype)
    v = _normal(rng, dev, (B, Sk, KV, hd), dtype)
    before = flash_attention_op.launches
    out = flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and flash_attention_op.launches == before + 1
    bq, bk = attn_tiles(Sq, Sk, H // KV)
    ref = flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_flash_attention_takes_an_unaligned_view(dev):
    """An operand that starts off a 16-byte boundary is copied, not
    refused."""
    rng = np.random.default_rng(9)
    q = _normal(rng, dev, (1 * 64 * 2 * 16 + 1,))[1:].view(1, 64, 2, 16)
    k = _normal(rng, dev, (1, 64, 1, 16))
    v = _normal(rng, dev, (1, 64, 1, 16))
    out = flash_attention_op(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, bq=32, bk=64)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


# the sweep of tests/test_kernels.py, the skip case, and the JAX wrapper's
# traps: (N, H, W, C, O, fh, fw, stride, relu, out_shift, x dtype, skip)
CONV_CASES = [
    (2, 8, 8, 4, 8, 3, 3, 1, False, None, torch.int8, False),
    (2, 8, 8, 4, 8, 3, 3, 2, False, None, torch.int8, False),
    (1, 16, 16, 8, 16, 3, 3, 1, True, 7, torch.int8, False),
    (2, 8, 8, 3, 16, 3, 3, 2, True, 6, torch.int8, False),
    (2, 8, 8, 4, 4, 3, 3, 1, False, None, torch.int8, True),
    (2, 8, 8, 4, 8, 3, 3, 1, False, -2, torch.int8, False),
    (2, 8, 8, 4, 8, 3, 3, 1, True, 0, torch.int8, True),
    (2, 8, 8, 4, 8, 3, 3, 1, True, 9, torch.uint8, False),
    (1, 9, 7, 3, 5, 3, 3, 2, False, None, torch.uint8, True),
    (1, 10, 10, 4, 8, 5, 5, 1, True, 10, torch.int8, False),
    (1, 9, 8, 4, 6, 2, 4, 2, False, 3, torch.int8, False),
    (2, 7, 5, 5, 7, 3, 3, 3, False, 5, torch.int8, False),
    # ResNet20's shapes at batch 32, s8 input, and the 1x1 downsamples
    (32, 32, 32, 16, 16, 3, 3, 1, True, 10, torch.int8, False),
    (32, 32, 32, 16, 32, 3, 3, 2, False, 10, torch.int8, True),
    (32, 16, 16, 32, 32, 3, 3, 1, True, 11, torch.int8, True),
    (32, 16, 16, 32, 64, 3, 3, 2, False, None, torch.int8, False),
    (32, 8, 8, 64, 64, 3, 3, 1, True, 12, torch.uint8, False),
    (32, 32, 32, 16, 32, 1, 1, 2, False, 8, torch.int8, False),
    (32, 16, 16, 32, 64, 1, 1, 2, True, 8, torch.int8, False),
]


@pytest.mark.parametrize("N,H,W,C,O,fh,fw,stride,relu,shift,xdt,skip",
                         CONV_CASES)
def test_conv2d_int8_matches_plain_version(dev, N, H, W, C, O, fh, fw,
                                           stride, relu, shift, xdt, skip):
    """Bitwise with the float64 plain version, one counted launch."""
    rng = np.random.default_rng(N + H + C + O + fh + stride)
    lo, hi = (0, 256) if xdt == torch.uint8 else (-128, 128)
    x = _t(rng, dev, lo, hi, (N, H, W, C),
           np.uint8 if xdt == torch.uint8 else np.int8)
    w = _t(rng, dev, -128, 128, (fh, fw, C, O), np.int8)
    b = _t(rng, dev, -2 ** 12, 2 ** 12, (O,), np.int32)
    s = _t(rng, dev, -2 ** 16, 2 ** 16, (N, *out_hw(H, W, stride), O),
           np.int32) if skip else None
    kw = dict(stride=stride, relu=relu, out_shift=shift)
    path = conv_path(x.shape, w.shape, stride, sm_count(dev.index))
    if N == 32:   # ResNet20's layers take the tensor-core path
        assert path == "mma"
    before = conv2d_int8_op.launches
    by_path = dict(conv2d_int8_op.launches_by_path)
    got = conv2d_int8_op(x, w, b, s, **kw)
    torch.cuda.synchronize()
    assert conv2d_int8_op.launches == before + 1
    assert conv2d_int8_op.launches_by_path[path] == by_path[path] + 1
    assert torch.equal(got, conv2d_int8_plain(x, w, b, s, **kw))


def test_conv2d_int8_wraps_as_int32(dev):
    """bias + skip near the int32 rails wraps as the reference's adds do."""
    rng = np.random.default_rng(10)
    x = _t(rng, dev, -128, 128, (2, 8, 8, 4), np.int8)
    w = _t(rng, dev, -128, 128, (3, 3, 4, 8), np.int8)
    b = torch.full((8,), 2 ** 20, dtype=torch.int32, device=dev)
    s = torch.full((2, 8, 8, 8), 2 ** 31 - 2 ** 16, dtype=torch.int32,
                   device=dev)
    for shift in (None, 3):
        got = conv2d_int8_op(x, w, b, s, out_shift=shift)
        torch.cuda.synchronize()
        ref = conv2d_int8_plain(x, w, b, s, out_shift=shift)
        assert torch.equal(got, ref)
    assert bool((conv2d_int8_op(x, w, b, s) < 0).any())


@pytest.mark.parametrize("xdt", [np.int8, np.uint8])
def test_conv2d_int8_wraps_as_int32_on_the_mma_path(dev, xdt):
    """The same wrap at a tensor-core shape (C = 16, O = 16): bias + skip
    start the accumulator fragments, and the mma sums wrap (no
    .satfinite)."""
    rng = np.random.default_rng(11)
    lo, hi = (0, 256) if xdt == np.uint8 else (-128, 128)
    x = _t(rng, dev, lo, hi, (2, 8, 8, 16), xdt)
    w = _t(rng, dev, -128, 128, (3, 3, 16, 16), np.int8)
    b = torch.full((16,), 2 ** 20, dtype=torch.int32, device=dev)
    s = torch.full((2, 8, 8, 16), 2 ** 31 - 2 ** 16, dtype=torch.int32,
                   device=dev)
    assert conv_path(x.shape, w.shape, 1, sm_count(dev.index)) == "mma"
    before = conv2d_int8_op.launches_by_path["mma"]
    for shift in (None, 3):
        got = conv2d_int8_op(x, w, b, s, out_shift=shift)
        torch.cuda.synchronize()
        ref = conv2d_int8_plain(x, w, b, s, out_shift=shift)
        assert torch.equal(got, ref)
    assert conv2d_int8_op.launches_by_path["mma"] == before + 2
    assert bool((conv2d_int8_op(x, w, b, s) < 0).any())


@pytest.mark.parametrize("B,S,di,N", [(1, 16, 8, 4), (2, 32, 16, 8),
                                      (2, 64, 32, 16), (2, 100, 200, 16),
                                      (1, 40, 50, 7), (4, 512, 8192, 16)])
def test_selective_scan_matches_plain_version(dev, B, S, di, N):
    """Within the JAX tests' tolerance (1e-5) of the sequential plain
    version, from a nonzero initial state."""
    rng = np.random.default_rng(S + di)
    u = _normal(rng, dev, (B, S, di))
    dt = BK.softplus(_normal(rng, dev, (B, S, di)))
    A = -torch.exp(_normal(rng, dev, (di, N)) * 0.5)
    Bc, Cc = _normal(rng, dev, (B, S, N)), _normal(rng, dev, (B, S, N))
    h0 = _normal(rng, dev, (B, di, N))
    before = selective_scan_op.launches
    y, h = selective_scan_op(u, dt, A, Bc, Cc, h0)
    torch.cuda.synchronize()
    assert selective_scan_op.launches == before + 1
    y_ref, h_ref = selective_scan_ref(u, dt, A, Bc, Cc, h0)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["gemma-2b", "falcon-mamba-7b"])
def test_lm_tasks_on_cuda_match_torch_int(dev, name):
    """One LM forward of each family at smoke width on the card: the
    torch-int program runs, and every task is replayed through the cuda
    impl on the same inputs.  Every matmul output is bitwise equal; the
    float interludes' int8 outputs differ by at most one grid step."""
    cfg = lm_config(get_smoke_config(name), seq_len=64)
    params = init_lm_params(cfg, seed=5, device=dev)
    plan = plan_lm(lowering.optimized_graph(cfg), params)
    packed = BK.pack_lm_weights(plan, params)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(dev)
    ctx = BK.lm_context(plan, params, cfg)
    BK.embed_tokens(ctx, plan, tokens)
    for t in plan.tasks:
        get_task_impl("torch-int", t.kind)(t, ctx)
        shadow = BK.lm_context(plan, params, cfg, packed)
        shadow.env, shadow.specs = dict(ctx.env), dict(ctx.specs)
        get_task_impl("cuda", t.kind)(t, shadow)
        got, ref = shadow.env[t.output], ctx.env[t.output]
        if t.kind == "matmul":
            assert torch.equal(got, ref), t.node
        else:
            step = (got.to(torch.int32) - ref.to(torch.int32)).abs().max()
            assert int(step) <= 1, t.node


def test_lm_tuning_dict_reaches_the_kernels_on_the_card(dev):
    """A tuned LM task's config is handed to its kernel: a legal,
    non-default tuning (``tune.space.lm_tuned_variant``) serves, within
    ``logit_tolerance`` of ``torch-int`` under the same tuning, and the
    wrappers' ``launches_by_config`` show every tuned task's knobs, once a
    bucket run; an illegal one is refused by name on the first forward."""
    from repro_torch.compile.lm_params import logit_tolerance

    for name in ("gemma-2b", "falcon-mamba-7b"):
        cfg = lm_config(get_smoke_config(name), seq_len=64)
        params = init_lm_params(cfg, seed=5, device=dev)
        tune = space.lm_tuned_variant(cfg, 1)
        cm = compile_model(cfg, params, backend="cuda", batch_sizes=(1,),
                           device=dev, tune=tune)
        assert cm.tuning == tune
        toks = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, 64)).astype(np.int32)
        ops = (matmul_int8_op, flash_attention_op, selective_scan_op)
        before = [dict(op.launches_by_config) for op in ops]
        out = cm(toks)
        assert torch.isfinite(out).all()
        ran = {}
        for op, b in zip(ops, before):
            for key, n in op.launches_by_config.items():
                if n != b.get(key, 0):
                    ran[key] = ran.get(key, 0) + n - b.get(key, 0)
        plan = plan_lm(lowering.annotate_tuning(
            lowering.optimized_graph(cfg), tune), params)
        role = {"attention": "attn", "scan": "scan"}
        want = {}
        for t in plan.tasks:
            key = f"layer{t.layer}/{getattr(t, 'role', role.get(t.kind))}"
            k = space.lm_task_knobs(cfg, 1, key, t.config)
            label = ("cout_block={},lanes={}" if t.kind == "scan" else
                     "bk=64,bm={1}" if t.kind == "attention" else
                     "bn={},split={}").format(*k)
            if t.kind == "matmul" and matmul_path(64, t.dout, t.din) != \
                    "wgmma":
                label = "mma_sync"
            want[label] = want.get(label, 0) + 1
        assert ran == want
        ref = compile_model(cfg, params, backend="torch-int",
                            batch_sizes=(1,), device=dev, tune=tune)
        feats = [m.backend.features(m.graph, cfg, m.params)(
            torch.as_tensor(toks, device=dev)) for m in (cm, ref)]
        tol = logit_tolerance(*feats, hidden_out_spec(params),
                              params.unembed)
        assert bool(((out.double() - ref(toks).double()).abs() <=
                     tol).all())
        bad = {next(iter(tune)): KernelConfig(bm=64, bn=64, bk=64)}
        with pytest.raises(ValueError, match="64"):
            compile_model(cfg, params, backend="cuda", batch_sizes=(1,),
                          device=dev, tune=bad)(toks)


@pytest.mark.parametrize("M,K,N", [(512, 2048, 256), (512, 4096, 16),
                                   (300, 1024, 96)])
def test_matmul_int8_every_config_of_its_space_bitwise(dev, M, K, N):
    """Every (bn, split) of ``tune.space.matmul_space`` bitwise with the
    plain version, counted under its knobs; an illegal one is refused by
    name before anything launches."""
    rng = np.random.default_rng(M + K + N)
    a = _t(rng, dev, -128, 128, (M, K), np.int8)
    b = _t(rng, dev, -128, 128, (K, N), np.int8)
    w = pack_weight(b)
    bias = _t(rng, dev, -2 ** 20, 2 ** 20, (1, N), np.int32).expand(M, N)
    ref = matmul_int8_ref(a, b, bias)
    configs = space.matmul_space(M, K, N)
    assert len(configs) > 1
    for c in configs:
        key = "bn={},split={}".format(*matmul_ops.matmul_knobs(M, N, K, c))
        n = matmul_int8_op.launches_by_config.get(key, 0)
        got = matmul_int8_op(a, w, bias, config=c)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c
        assert matmul_int8_op.launches_by_config[key] == n + 1
    total = matmul_int8_op.launches
    with pytest.raises(ValueError, match="bn=48"):
        matmul_int8_op(a, w, bias, config=KernelConfig(bn=48))
    assert matmul_int8_op.launches == total


def test_flash_attention_every_config_of_its_space(dev):
    """Every ``bm`` of ``tune.space.attention_space`` within 2e-5 of the
    plain version on the tiles ``attn_tiles`` gives under it (gemma-2b's
    MQA group of 8 and a group of 2), counted under its knobs; the kernel
    reports the shared memory ``block_smem_bytes`` computes."""
    rng = np.random.default_rng(21)
    for H, KV, hd in ((8, 1, 64), (4, 2, 128)):
        q = _normal(rng, dev, (2, 100, H, hd))
        k = _normal(rng, dev, (2, 130, KV, hd))
        v = _normal(rng, dev, (2, 130, KV, hd))
        for c in space.attention_space(100, 130, hd, H // KV):
            got = flash_attention_op(q, k, v, config=c)
            torch.cuda.synchronize()
            bq, bk = attn_tiles(100, 130, H // KV, config=c)
            ref = flash_attention_plain(q, k, v, bq=bq, bk=bk)
            torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    for hd in (48, 64, 128, 256):
        assert flash_ops.smem_bytes(hd) == flash_ops.block_smem_bytes(hd)
    with pytest.raises(ValueError, match="bk=32"):
        flash_attention_op(q, k, v, config=KernelConfig(bk=32))


@pytest.mark.parametrize("B,S,di,N", [(2, 100, 200, 16), (1, 40, 50, 7)])
def test_selective_scan_every_instance_of_its_space(dev, B, S, di, N):
    """Every (cout_block, lanes) instance within 1e-5 of the plain
    version, counted under its knobs; the compiler's static shared memory
    of each instance equals ``scan_smem_bytes``."""
    rng = np.random.default_rng(S + di + 1)
    u = _normal(rng, dev, (B, S, di))
    dt = BK.softplus(_normal(rng, dev, (B, S, di)))
    A = -torch.exp(_normal(rng, dev, (di, N)) * 0.5)
    Bc, Cc = _normal(rng, dev, (B, S, N)), _normal(rng, dev, (B, S, N))
    h0 = _normal(rng, dev, (B, di, N))
    y_ref, h_ref = selective_scan_ref(u, dt, A, Bc, Cc, h0)
    for c in space.scan_space(S, di, N):
        key = f"cout_block={c.cout_block},lanes={c.lanes}"
        n = selective_scan_op.launches_by_config.get(key, 0)
        y, h = selective_scan_op(u, dt, A, Bc, Cc, h0, config=c)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)
        assert selective_scan_op.launches_by_config[key] == n + 1
        assert scan_ops.kernel_smem_bytes(c.cout_block, c.lanes) == \
            scan_ops.scan_smem_bytes(c.cout_block, c.lanes)
    with pytest.raises(ValueError, match="lanes=8"):
        selective_scan_op(u, dt, A, Bc, Cc, h0,
                          config=KernelConfig(cout_block=64, lanes=8))


# ---------------------------------------------------------------------------
# CompiledModel: one CUDA graph per bucket
# ---------------------------------------------------------------------------


def _resnet8_qparams(seed=0):
    cfg = R.RESNET8
    return cfg, R.quantize_params(R.fold_params(R.init_params(
        cfg, torch.Generator().manual_seed(seed))), cfg)


def _images(dev, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 0.999, (n, 32, 32, 3)).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_graph_replay_is_bitwise_the_eager_lowered_forward(dev, backend):
    """Buckets 1 and 8 of ResNet8 served by replaying their graphs give the
    eager lowered forward's logits bitwise, full and padded batches, and
    one capture a bucket."""
    cfg, qp = _resnet8_qparams()
    cm = compile_model(cfg, qp, backend=backend, batch_sizes=(1, 8))
    fwd = lower_forward(cfg, qp, backend)
    x = _images(dev, 8, seed=1)
    for n in (1, 8, 5, 1, 8):
        got = cm(x[:n])
        ref = fwd(cm.pad(x[:n]))[:n]
        torch.cuda.synchronize()
        assert torch.equal(got, ref), n
    assert cm.trace_counts == {1: 1, 8: 1} and cm.compile_count == 2
    assert cm.run_counts == {1: 2, 8: 3}
    assert all(isinstance(cm.executable(b), GraphExecutable) for b in (1, 8))


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_graph_results_are_not_aliased_across_replays(dev, backend):
    cfg, qp = _resnet8_qparams()
    cm = compile_model(cfg, qp, backend=backend, batch_sizes=(8,))
    x1, x2 = _images(dev, 8, seed=2), _images(dev, 8, seed=3)
    a = cm(x1)
    kept = a.clone()
    b = cm(x2)
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)
    assert torch.equal(cm(x1), kept)


@pytest.mark.parametrize("backend,plan", [
    ("cuda", dict(conv_stem=1, resblock_fused=3, block_chain=0)),
    ("cuda-stream", dict(conv_stem=0, resblock_fused=0, block_chain=1))])
def test_graph_replays_count_launches_and_the_capture_does_not(dev, backend,
                                                               plan):
    cfg, qp = _resnet8_qparams()
    ops = dict(conv_stem=conv_stem_op, resblock_fused=resblock_fused_op,
               block_chain=block_chain_op)
    cm = compile_model(cfg, qp, backend=backend, batch_sizes=(1, 8))
    before = {k: op.launches for k, op in ops.items()}
    banded = conv_stem_op.launches_by_path["banded"]
    cm.warmup()
    assert {k: op.launches for k, op in ops.items()} == before
    x = _images(dev, 8, seed=4)
    for n in (8, 3, 1):
        cm(x[:n])
    torch.cuda.synchronize()
    assert {k: op.launches - before[k] for k, op in ops.items()} == \
        {k: 3 * v for k, v in plan.items()}
    assert conv_stem_op.launches_by_path["banded"] - banded == \
        3 * plan["conv_stem"]


@pytest.mark.parametrize("backend,plan", [
    ("cuda", dict(conv_stem_banded=1, resblock_fused_kernel=3)),
    ("cuda-stream", dict(block_chain_kernel=1))])
def test_profiler_sees_each_replay_run_the_plan(dev, backend, plan):
    """What the card ran, read from a profiler trace (CUPTI reports the
    kernels of a graph replay): every served call of a built bucket runs
    the plan once, and the counters' bookkeeping agrees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, qp = _resnet8_qparams()
    cm = compile_model(cfg, qp, backend=backend, batch_sizes=(1, 8),
                       eager=True)
    x = _images(dev, 8, seed=7)
    before = {k: op.launches for k, op in (("conv_stem", conv_stem_op),
              ("resblock_fused", resblock_fused_op),
              ("block_chain", block_chain_op))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for n in (8, 3, 1, 8):
            cm(x[:n])
        torch.cuda.synchronize()
    ran = dict.fromkeys(("conv_stem_banded", "conv_stem_general",
                         "resblock_fused_kernel", "block_chain_kernel"), 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in ran:
                if re.search(rf"::{name}\s*[<(]", e.key):
                    ran[name] += e.count
    assert ran == {k: 4 * plan.get(k, 0) for k in ran}
    counted = dict(conv_stem=conv_stem_op.launches,
                   resblock_fused=resblock_fused_op.launches,
                   block_chain=block_chain_op.launches)
    assert {k: n - before[k] for k, n in counted.items()} == dict(
        conv_stem=ran["conv_stem_banded"],
        resblock_fused=ran["resblock_fused_kernel"],
        block_chain=ran["block_chain_kernel"])


def test_capture_graph_leaves_the_counters_and_times_the_replay(dev):
    """``kernels.common.capture_graph`` returns what the capture counted and
    leaves every counter as found; ``graph_ms`` times a captured call."""
    from repro_torch.kernels import common

    cfg, qp = _resnet8_qparams()
    fwd = lower_forward(cfg, qp, "cuda")
    x = _images(dev, 8, seed=8)
    before = common.read_launches()
    graph, out, delta = common.capture_graph(lambda: fwd(x), calls=2)
    assert common.read_launches() == before
    assert delta[resblock_fused_op][0] == 2 * 3
    assert delta[conv_stem_op] == (2, {"banded": 2, "general": 0}, {})
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fwd(x))
    assert common.graph_ms(lambda: fwd(x), calls=2) > 0


def test_forced_second_capture_bumps_compile_retraces_total(dev):
    cfg, qp = _resnet8_qparams()
    with obsrt.instrumented() as ob:
        cm = compile_model(cfg, qp, backend="cuda", batch_sizes=(8,))
        x = _images(dev, 8, seed=5)
        ref = cm(x)
        assert ob.metrics.total("compile_traces_total") == 1
        assert ob.metrics.total("compile_retraces_total") == 0
        assert ob.metrics.get("compile_executables_total").value(
            kind="default", bucket="8", backend="cuda") == 1
        exe = cm._capture(8, cm.device)          # a rebuilt executable
        assert cm.trace_counts == {8: 2}
        assert ob.metrics.total("compile_retraces_total") == 1
        assert any(e.name == "retrace" for e in ob.trace.events)
        assert torch.equal(exe(x), ref)


def test_run_placed_is_bitwise_the_default_path(dev):
    cfg, qp = _resnet8_qparams()
    cm = compile_model(cfg, qp, backend="cuda-stream", batch_sizes=(1, 8))
    x = _images(dev, 11, seed=6)                  # 8, then 3 padded to 8
    ref = cm(x)
    got = cm.run_placed(x, torch.device("cuda", 0))
    assert torch.equal(got, ref) and got.device == ref.device
    assert cm.stats()["placed"] == [(8, "cuda:0")]
    assert cm.compile_count == 2 and cm.trace_counts == {8: 2}


# ---------------------------------------------------------------------------
# serving at scale and the tuner's knobs on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_sharded_engine_bitwise_with_resnet_engine_on_gpu(dev, backend):
    """ShardedResNetEngine over every card (devices=None) against
    ResNetEngine on the same images: bitwise logits, all served, each
    bucket captured once per card and never again."""
    from repro_torch.serve import (ImageRequest, ResNetEngine,
                                   ShardedResNetEngine)

    cfg, qp = _resnet8_qparams(seed=4)
    xs = _images(dev, 21, seed=8).cpu().numpy()
    plain = ResNetEngine(cfg, qp, batch=8, backend=backend,
                         batch_sizes=(1, 8))
    preqs = [ImageRequest(rid=i, image=x) for i, x in enumerate(xs)]
    for r in preqs:
        plain.submit(r)
    plain.run()
    eng = ShardedResNetEngine(cfg, qp, batch=8, backend=backend,
                              batch_sizes=(1, 8), slack_ms=1.0)
    n_dev = torch.cuda.device_count()
    assert len(eng.pool) == n_dev
    eng.pool.warmup()
    reqs = [ImageRequest(rid=i, image=x) for i, x in enumerate(xs)]
    for r in reqs:
        eng.submit(r, deadline_ms=50.0)
    eng.run()
    assert eng.served == 21 and all(r.done for r in reqs)
    assert np.array_equal(np.stack([r.logits for r in reqs]),
                          np.stack([r.logits for r in preqs]))
    assert eng.model.trace_counts == {1: n_dev, 8: n_dev}
    assert eng.model.compile_count == 2 * n_dev
    assert eng.model.stats()["compiled"] == []


def test_wrappers_at_every_enumerated_knob_match_plain_versions(dev):
    """Every band of tune.space at ResNet20's stem and block shapes and
    every (batch_tile, split) of its chain that the card runs, at bucket
    8: bitwise with the plain versions; the kernels' shared memory at each
    enumerated knob equals the Python formulas."""
    from repro_torch.kernels.conv_stem.ops import band_smem_bytes
    from repro_torch.kernels.megakernel.ops import ChainLaunch
    from repro_torch.kernels.resblock_fused.ops import ResblockLaunch

    rng = np.random.default_rng(3)
    n = 8
    layers = {l.name: l for l in df.resnet20_layers()}
    x = _t(rng, dev, 0, 256, (n, 32, 32, 3), np.uint8)
    w = _t(rng, dev, -128, 128, (3, 3, 3, 16), np.int8)
    b = _t(rng, dev, -500, 500, (16,), np.int32)
    ref = conv_stem_ref(x, w, b, shift=9)
    lib = stem_ops._lib()
    for c in space.stem_space(layers["stem"], n):
        assert lib.conv_stem_band_smem_bytes(c.band_rows, 32, 3, 16) == \
            band_smem_bytes(c.band_rows, 32, 3, 16)
        assert torch.equal(conv_stem_op(x, w, b, shift=9, config=c), ref), c
    for i in (0, 3, 4, 6, 7):
        l0, ds = layers[f"c{i}_0"], f"ds{i}" in layers
        ops = [_t(rng, dev, 0, 256, (n, l0.ih, l0.iw, l0.ich), np.uint8),
               _t(rng, dev, -128, 128, (3, 3, l0.ich, l0.och), np.int8),
               _t(rng, dev, -500, 500, (l0.och,), np.int32),
               _t(rng, dev, -128, 128, (3, 3, l0.och, l0.och), np.int8),
               _t(rng, dev, -500, 500, (l0.och,), np.int32)]
        ops += [_t(rng, dev, -128, 128, (1, 1, l0.ich, l0.och), np.int8),
                _t(rng, dev, -500, 500, (l0.och,), np.int32)] if ds \
            else [None, None]
        kw = dict(stride=l0.stride, shift0=11, shift1=12,
                  skip_shift=-2 if ds else 3)
        want = resblock_ref(*ops, **kw)
        for c in space.block_space(l0, n, ds):
            assert block_ops.smem_bytes(l0.ih, l0.iw, l0.ich, l0.och,
                                        l0.stride, ds, c.band_rows) == \
                df.resblock_task_smem_bytes(l0.ih, l0.iw, l0.ich, l0.och,
                                            l0.stride, ds, c.band_rows)
            launch = ResblockLaunch(*ops[1:], config=c, **kw)
            assert launch.band_rows(n, l0.oh) == c.band_rows
            assert torch.equal(launch(ops[0]), want), (i, c)
    shapes = df.resnet_block_shapes(3)
    xc, blocks, specs, stem, stem_shift = live_chain(rng, dev, shapes, n, 16)
    ckw = dict(specs=specs, stem=stem, stem_shift=stem_shift)
    want = block_chain_ref(xc, blocks, **ckw)
    tilings = space.chain_tilings(shapes, n, 16,
                                  capacity=chain_ops.max_clusters)
    assert {c.split for c in tilings} == {1, 2, 4, 8}
    for c in tilings:
        launch = ChainLaunch(blocks, in_shape=xc.shape[1:], config=c, **ckw)
        assert launch.tiling(n) == (c.batch_tile, c.split)
        assert chain_ops.smem_bytes(shapes, c.batch_tile, 16, c.split) == \
            df.chain_task_smem_bytes(shapes, c.batch_tile, 16, c.split)
        assert torch.equal(launch(xc), want), c


def test_wrappers_raise_on_an_over_budget_knob(dev):
    rng = np.random.default_rng(4)
    ops = [_t(rng, dev, 0, 256, (1, 64, 64, 64), np.uint8),
           _t(rng, dev, -128, 128, (3, 3, 64, 64), np.int8),
           _t(rng, dev, -500, 500, (64,), np.int32),
           _t(rng, dev, -128, 128, (3, 3, 64, 64), np.int8),
           _t(rng, dev, -500, 500, (64,), np.int32)]
    kw = dict(stride=1, shift0=11, shift1=12, skip_shift=0)
    with pytest.raises(ValueError, match="over the budget"):
        resblock_fused_op(*ops, config=KernelConfig(band_rows=64), **kw)
    assert torch.equal(
        resblock_fused_op(*ops, config=KernelConfig(band_rows=4), **kw),
        resblock_ref(*ops, **kw))
    shapes = df.resnet_block_shapes(3)
    xc, blocks, specs, stem, stem_shift = live_chain(rng, dev, shapes, 4, 16)
    with pytest.raises(ValueError, match="over the budget"):
        block_chain_op(xc, blocks, specs=specs, stem=stem,
                       stem_shift=stem_shift,
                       config=KernelConfig(batch_tile=4, split=1))


@pytest.mark.parametrize("backend", ["cuda", "cuda-stream"])
def test_device_search_on_the_card(dev, backend, tmp_path, monkeypatch):
    """tune.search with device timing on the card: the winner validated
    bitwise against torch-int (never a fallback), cached, and the tuned
    model bitwise with torch-int at every bucket."""
    from repro_torch import tune as T

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    cfg, qp = _resnet8_qparams(seed=5)
    res = T.search(cfg, qp, backend=backend, batch=8, top_k=2, reps=3)
    assert res.source == "device" and len(res.timings_us) >= 2
    assert T.search(cfg, qp, backend=backend, batch=8).source == "cache"
    tuned = compile_model(cfg, qp, backend=backend, batch_sizes=(1, 8),
                          tune="auto")
    assert tuned.tuning == res.tuning
    ref = compile_model(cfg, qp, backend="torch-int", batch_sizes=(1, 8))
    x = _images(dev, 11, seed=9)
    assert torch.equal(tuned(x), ref(x))


def test_float_train_step_and_export_validation_on_the_card(dev):
    """One float train step of ResNet8 on the card (finite loss, every
    leaf still on the card, every weight moved, the bn variances decayed
    though they have no gradient), then PTQ of the
    result and the export held bitwise across cuda, cuda-stream and
    torch-int on the card."""
    import dataclasses

    from repro_torch.quantize import (calibration_batches, ptq_quantize,
                                      validate_export)
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import make_train_step
    from repro_torch.core import tree as T

    cfg = dataclasses.replace(R.RESNET8, quant="none")
    params = R.params_to(R.init_params(
        cfg, torch.Generator().manual_seed(0)), dev)
    opt = opt_lib.sgdm(lr=0.1, total_steps=10)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, dev)
    batches = calibration_batches(2, 16)
    new, state, metrics = step(params, opt.init(params), 0, batches[0])
    assert math.isfinite(float(metrics["loss"]))
    for (path, a), b in zip(T.flatten_with_path(new), T.leaves(params)):
        assert a.device.type == "cuda"
        if path.endswith(("/w", "bn/var")):
            assert not torch.equal(a, b), path
    _, _, qp = ptq_quantize(cfg, new, batches, observer="percentile")
    check = validate_export(cfg, qp, batches[1]["images"][:8], device=dev)
    assert check["bit_exact"] and check["max_abs_dev"] == 0.0


def test_bf16_lm_engine_on_the_card(dev):
    """The float LM server on the card: the bf16 smoke gemma-2b through
    ``serve.Engine`` (more requests than slots, an empty prompt among
    them) finishes every request with its cache on the card, and
    ``Engine(slots=1)`` gives the tokens of a manual greedy
    ``decode_step`` loop there."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, Request

    cfg = get_smoke_config("gemma-2b").with_(dtype="bfloat16",
                                             param_dtype="bfloat16")
    params = M.init_params(cfg, 0, dev)
    eng = Engine(cfg, params, slots=2, max_len=32, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(
        [([1, 2, 3], 5), ([7], 4), ([], 3), ([9, 4, 4, 2], 6)])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert eng.cache["k"].is_cuda and eng.cache["k"].dtype == torch.bfloat16
    one = Engine(cfg, params, slots=1, max_len=32, device=dev)
    req = Request(rid=0, prompt=[4, 8], max_new=3)
    one.submit(req)
    one.run()
    cache = M.init_cache(cfg, 1, 32, dev)
    outs = []
    with torch.no_grad():
        for t, tok in enumerate([4, 8, None, None]):
            logits, cache = M.decode_step(
                params, cfg,
                torch.tensor([[tok if tok is not None else outs[-1]]],
                             device=dev),
                torch.tensor([t], device=dev), cache)
            if t:
                outs.append(int(torch.argmax(logits[0, 0])))
    assert req.out == outs


def test_lm_train_step_on_the_card_matches_the_cpu(dev):
    """One smoke AdamW train step (llama3.2-3b, float32, ``grad_accum=2``,
    donated, remat ``"dots"``) on the card against the same step on the
    CPU from the same weights: loss, params and moments within 1e-4 of
    each leaf's largest magnitude (``chip_smoke.py``'s ``lm_train``
    tolerance; TF32 off)."""
    from repro_torch.core import tree as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib

    cfg = get_smoke_config("llama3.2-3b")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        batch = dict(tokens=tokens, labels=np.concatenate(
            [tokens[:, 1:], -np.ones((4, 1), np.int32)], axis=1))
        opt = opt_lib.adamw(lr=1e-2, warmup=1, eps=1e-3)
        step = make_train_step(cfg, opt, grad_accum=2)
        runs = []
        for d in (torch.device("cpu"), dev):
            p = M.params_from_numpy(M.params_to_numpy(
                M.init_params(cfg, 0, "cpu")), cfg, d)
            s = opt.init(p)
            _, _, m = step(p, s, 0, {k: torch.from_numpy(v).to(d)
                                     for k, v in batch.items()})
            runs.append((float(m["loss"]), [t.cpu() for t in
                                            T.leaves((p, s))]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_loss, cpu), (card_loss, card) = runs
    assert abs(cpu_loss - card_loss) <= 1e-4 * abs(cpu_loss)
    assert all(a.is_floating_point() for a in cpu)
    for a, b in zip(cpu, card):
        assert torch.allclose(a, b, rtol=0,
                              atol=1e-4 * float(a.abs().max()))
