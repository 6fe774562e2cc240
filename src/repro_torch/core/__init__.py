"""Core: pow2-int8 quantization and the residual-graph optimization passes."""
from repro_torch.core import graph, quant  # noqa: F401
