"""Architecture configuration: the port's copy of the part of
``repro.configs.base`` that the LM compile path reads.

``ModelConfig`` keeps the fields that ``compile.lm_params.lm_config``
projects onto a ``QLMConfig``; the attention/MLP variants, numerics,
training and sharding fields of the JAX package wait for the float LMs.
``get_config(name)`` resolves ``repro_torch.configs.<id>``.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm (the families ported)
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- SSM ---
    ssm_state: int = 0
    d_inner: int = 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
