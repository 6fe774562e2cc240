"""Plain PyTorch version of the int8 matmul kernel: (M,K) s8 @ (K,N) s8 ->
int32, plus an optional int32 accumulator init.

The product is computed as a float64 ``torch.matmul`` and rounded back:
every product and partial sum is an integer of magnitude at most
K * 128 * 128 (2.7e8 at K = 16,384), far below 2^53, so no order of
summation rounds.  Only this call's operands are widened, one matrix at a
time.  The ``acc_init`` add is int32 and wraps like the kernel's."""
import torch


def matmul_int8_ref(a: torch.Tensor, b: torch.Tensor,
                    acc_init: torch.Tensor = None) -> torch.Tensor:
    y = torch.round(torch.matmul(a.to(torch.float64), b.to(torch.float64)))
    y = y.to(torch.int32)
    if acc_init is not None:
        y = y + acc_init.to(torch.int32)
    return y
