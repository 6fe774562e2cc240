"""Model configurations the port can lower (own copies of
``repro.configs``, gemma-2b and falcon-mamba-7b):
``get_config(name)`` / ``get_smoke_config(name)``."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, get_smoke_config)
