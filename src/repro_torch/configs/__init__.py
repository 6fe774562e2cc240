"""Model configurations: the port's own copies of ``repro.configs``, the
ten architectures at their published shapes and their smoke sizes:
``get_config(name)`` / ``get_smoke_config(name)``, ``ARCH_IDS``,
``SHAPES``, ``input_specs``."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, TensorSpec, cache_specs,
    get_config, get_smoke_config, input_specs)
