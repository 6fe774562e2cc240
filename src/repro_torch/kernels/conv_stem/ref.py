"""Plain PyTorch version of the stem conv kernel (SAME conv + requant)."""
import torch

from repro_torch.kernels.common import conv_i32, requant_u8


def conv_stem_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  shift: int) -> torch.Tensor:
    """x: (N,H,W,Cin) uint8 unpadded; w: (3,3,Cin,Cout) int8; b: (Cout,)
    integer.  Returns (N,H,W,Cout) uint8."""
    return requant_u8(conv_i32(x, w) + b.to(torch.int32), shift)
