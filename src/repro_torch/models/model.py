"""Unified float-LM API — dispatch per architecture family (the port of
``repro.models.model``).

    init_params(cfg, gen, device)  -> params (nested dicts of tensors)
    loss_fn(params, cfg, batch)    -> (loss, metrics)
    prefill(params, cfg, tokens)   -> last-position logits (B, 1, V)
    decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
    init_cache(cfg, B, S, device)  -> zeroed decode cache
    param_count(cfg)               -> #params (on the meta device: no
                                      allocation, so the 671B config counts
                                      in milliseconds)

Parameters keep the JAX package's names and its stacked ``(L, ...)``
layout, so ``params_from_numpy`` / ``params_to_numpy`` carry a parameter
tree across as a plain rename.  ``init_params`` and ``init_cache`` run on
the card unless the caller passes ``device="cpu"``, and raise without a
GPU.  Callers run the forwards under ``torch.inference_mode()`` to serve.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.configs import base as cbase
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models import layers as L


def _mod(cfg):
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return hybrid
    return transformer


def _device(device) -> torch.device:
    """``meta`` as is; otherwise the port's rule: ``None`` means ``cuda``,
    which raises without a GPU."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    from repro_torch.compile.compiler import resolve_device
    return resolve_device(device)


def quantize_int8w(params, min_size=2 ** 20):
    """Convert big matmul weights to pow2-block int8 storage (paper eq. 1
    applied per 128-block along the last axis, so a layer slice of a
    stacked leaf quantizes as the whole leaf does).  Leaves whose path
    names ``embed`` (``unembed`` too), ``norm`` or ``router`` stay raw, as
    do vectors and leaves under ``min_size`` elements."""
    def conv(path, x):
        if ("embed" in path or "norm" in path or "router" in path or
                x.dim() < 2 or x.numel() < min_size):
            return x
        return Q.block_quantize(x.to(torch.float32))
    pairs = T.flatten_with_path(params)
    return T.unflatten(params, [conv(p, x) for p, x in pairs])


def init_params(cfg, gen: Union[torch.Generator, int, None] = None,
                device=None) -> dict:
    """Random parameters of ``cfg`` on ``device`` (default ``cuda``),
    drawn from ``gen``: a ``torch.Generator`` on that device, or a seed
    (``None`` = 0).  ``device="meta"`` allocates nothing (shapes only)."""
    dev = _device(device)
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen or 0))
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    p = _mod(cfg).init_params(cfg, L.Draw(gen, dev))
    if cfg.quant == "int8w":
        p = quantize_int8w(p)
    return p


def loss_fn(params, cfg, batch):
    return _mod(cfg).loss_fn(params, cfg, batch)


def prefill(params, cfg, tokens, extra=None):
    return _mod(cfg).prefill(params, cfg, tokens, extra)


def decode_step(params, cfg, tokens, pos, cache, *, donate=False):
    """One decode step; ``donate``: write the new cache into ``cache``'s
    own tensors (the caller never reads the old one again)."""
    return _mod(cfg).decode_step(params, cfg, tokens, pos, cache,
                                 donate=donate)


def init_cache(cfg, B, S, device=None) -> dict:
    dev = _device(device)

    def zeros(shape, dtype, axes):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return cbase.cache_specs(cfg, B, S, zeros)


def param_shapes(cfg) -> dict:
    """The parameter tree on the meta device (shapes and dtypes only)."""
    return init_params(cfg, device="meta")


def param_count(cfg) -> int:
    return sum(int(x.numel()) for x in T.leaves(param_shapes(cfg)))


def param_bytes(cfg) -> int:
    return sum(int(x.numel()) * x.element_size()
               for x in T.leaves(param_shapes(cfg)))


def active_param_count(cfg) -> int:
    """Per-token active parameters (MoE: top_k of routed experts + shared)."""
    total = param_count(cfg)
    if cfg.family != "moe" or not cfg.num_experts:
        return total
    n_moe_layers = cfg.num_layers - cfg.first_dense_layers
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_total = n_moe_layers * cfg.num_experts * per_expert
    routed_active = n_moe_layers * cfg.top_k * per_expert
    return total - routed_total + routed_active


def model_flops(cfg, shape: cbase.ShapeSpec) -> float:
    """MODEL_FLOPS per step: 6·N_active·D for training, 2·N_active·D for a
    forward/decode step (D = tokens processed in the step)."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch  # one token per sequence
    return 2.0 * n * d


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------


def params_from_numpy(tree, cfg, device=None) -> dict:
    """The JAX package's parameter tree, as nested dicts of numpy arrays
    (``BlockQuantized`` leaves as ``(q, exp)`` pairs), as the port's params
    on ``device`` (default ``cuda``).  Each leaf is checked against the
    port's own layout (``param_shapes(cfg)``: the same keys, the same
    shape) and cast to its dtype, so arrays may come as float32 where the
    parameter is bf16 (numpy has no bf16; the cast is exact for values
    that were bf16).  A leaf may also come int8w-quantized where the
    config's own init keeps it raw (a smaller ``quantize_int8w``
    ``min_size``)."""
    return _from_numpy(tree, param_shapes(cfg), "", cfg, _device(device))


def _from_numpy(node, ref, path, cfg, dev):
    if isinstance(ref, dict):
        if not isinstance(node, dict) or set(node) != set(ref):
            got = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{cfg.name}: keys at {path or '/'}: {got} "
                             f"!= {sorted(ref)}")
        return {k: _from_numpy(node[k], ref[k], f"{path}/{k}", cfg, dev)
                for k in ref}
    want = ref.q.shape if isinstance(ref, Q.BlockQuantized) else ref.shape
    if isinstance(node, (tuple, list, Q.BlockQuantized)):
        q, e = (node.q, node.exp) if isinstance(node, Q.BlockQuantized) \
            else node
        bq = Q.BlockQuantized(_tensor(q, torch.int8, dev),
                              _tensor(e, torch.int8, dev))
        _check_shape(bq.q, want, path)
        return bq
    if isinstance(ref, Q.BlockQuantized):
        raise ValueError(f"{path}: raw leaf where {cfg.name} keeps an "
                         f"int8w (q, exp) pair")
    t = _tensor(node, ref.dtype, dev)
    _check_shape(t, want, path)
    return t


def _tensor(a, dtype, dev):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=dev,
                                                       dtype=dtype)


def _check_shape(t, want, path):
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{path}: shape {tuple(t.shape)} != {tuple(want)}")


def params_to_numpy(params) -> dict:
    """The inverse of ``params_from_numpy``: nested dicts of numpy arrays,
    ``BlockQuantized`` leaves as ``(q, exp)`` pairs, bf16 as float32."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, Q.BlockQuantized):
        return (params_to_numpy(params.q), params_to_numpy(params.exp))
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
