"""GPU-only checks of the port's CUDA kernels (marked ``cuda``; each skips
without a GPU).  This file imports no JAX, so it also runs on a GPU machine
that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.compile import lower_features
from repro_torch.kernels.conv_stem.ops import conv_stem_op
from repro_torch.kernels.conv_stem.ref import conv_stem_ref
from repro_torch.kernels.resblock_fused.ops import resblock_fused_op
from repro_torch.kernels.resblock_fused.ref import resblock_ref
from repro_torch.models import resnet as R

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
