"""GPU-only checks of the port's CUDA kernels (marked ``cuda``; each skips
without a GPU).  This file imports no JAX, so it also runs on a GPU machine
that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.compile import (compile_model, get_task_impl,
                                 init_lm_params, lm_config, lower_features,
                                 lower_forward, lowering, plan_lm)
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
from repro_torch.kernels.flash_attention.ops import (attn_tiles,
                                                     flash_attention_op)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_plain)
from repro_torch.kernels.matmul_int8.ops import (matmul_int8_op,
                                                 matmul_path, pack_weight)
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
from repro_torch.kernels.megakernel import ops as chain_ops
from repro_torch.kernels.megakernel.ops import ChainBlockSpec, block_chain_op
from repro_torch.kernels.megakernel.ref import block_chain_ref
from repro_torch.kernels.resblock_fused import ops as block_ops
from repro_torch.kernels.resblock_fused.ops import resblock_fused_op
from repro_torch.kernels.resblock_fused.ref import resblock_ref
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
                if f"::{name}(" in e.key:
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
    assert delta[conv_stem_op] == (2, {"banded": 2, "general": 0})
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
