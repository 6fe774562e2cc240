"""Plain PyTorch version of the fused residual block: the unfused dataflow
conv0 -> relu/requant -> [1x1 ds conv ->] skip align -> conv1 + skip ->
relu/requant, every tensor materialized.  Takes the *unpadded* input with
``jax.lax`` SAME padding, so stride-2 blocks pad (0, 1)."""
import torch

from repro_torch.core.quant import shift_align
from repro_torch.kernels.common import conv_i32, requant_u8


def resblock_ref(x, w0, b0, w1, b1, wd=None, bd=None, *, stride=1,
                 shift0, shift1, skip_shift=0):
    """x: (N,H,W,Cin) uint8 unpadded; w0: (3,3,Cin,Cout), w1:
    (3,3,Cout,Cout), wd: (1,1,Cin,Cout) int8; b0/b1/bd: (Cout,) integer.
    Returns (N,oh,ow,Cout) uint8."""
    y0 = requant_u8(conv_i32(x, w0, stride) + b0.to(torch.int32), shift0)
    if wd is not None:
        skip = shift_align(conv_i32(x, wd, stride) + bd.to(torch.int32),
                           skip_shift)
    else:
        skip = shift_align(x, skip_shift)
    acc1 = conv_i32(y0, w1) + b1.to(torch.int32) + skip
    return requant_u8(acc1, shift1)
