"""Hardware constants of one NVIDIA H100 SXM (80 GB HBM3), for the
roofline terms of ``launch.analytic``: the port's counterpart of the
reference's per-chip TPU constants, under the same names.

Source: NVIDIA's H100 Tensor Core GPU data sheet, SXM part, dense rates
(no sparsity), at its 700 W limit; NVLink 4 is 900 GB/s a GPU in both
directions together.  The mesh constructors wait for parallelism
(ROADMAP A10).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12          # FLOP/s, bf16 tensor cores
PEAK_INT8_OPS = 1979e12           # int8 Op/s
HBM_BW = 3.35e12                  # bytes/s
ICI_BW = 450e9                    # bytes/s, NVLink, one direction
HBM_BYTES = 80 * 10 ** 9          # 80 GB
