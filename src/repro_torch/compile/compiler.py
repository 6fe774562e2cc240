"""``compile_model``: optimized graph -> a bucketed, device-placed model.

    qp = models.resnet.quantize_params(folded, cfg)        # dict or typed
    cm = compile_model(cfg, qp, backend="cuda", batch_sizes=(1, 8, 32))
    out = cm(images)          # bucket select + zero-pad + run + slice

``backend`` is a registered name (``cuda``, ``cuda-stream``, ``torch-int``)
or an instance, e.g. ``CudaStreamBackend(cuts=[[0, 1, 2], [3, 4, 5, 6, 7,
8]])`` for an explicit chain partition.

LM configs serve token batches the same way:

    cfg = lm_config(get_config("gemma-2b"), seq_len=512)
    cm = compile_model(cfg, init_lm_params(cfg, seed=0, device="cuda"),
                       backend="cuda", batch_sizes=(1, 4))
    logits = cm(tokens)       # (n, seq_len) int32 -> (n, vocab) float32

A bucket is then ``(batch, seq_len)`` int32 tokens, padded with zero rows.

The graph is lowered once through the backend with the weights placed on
the model's device; serving then only selects the smallest bucket that
holds a batch, zero-pads up to it, chunks batches beyond the largest
bucket, and slices the pad rows off the logits.  PyTorch runs eagerly, so a
bucket is a fixed launch shape rather than a compiled executable.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
when no CUDA device exists; pass ``device="cpu"`` to run the kernels'
plain versions on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import torch

from repro_torch.compile import lowering
from repro_torch.compile.backends import Backend, get_backend
from repro_torch.compile.params import ensure_typed


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises when a CUDA device is asked for (or
    implied) and none exists; never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev


def input_shape(cfg, batch: int):
    """THE input contract of a bucket: ``(batch, img, img, 3)`` float32
    images for conv configs, ``(batch, seq_len)`` int32 tokens for LM
    configs.  Returns ``(shape, dtype)``."""
    if lowering._is_lm_cfg(cfg):
        return (batch, cfg.seq_len), torch.int32
    return (batch, cfg.img, cfg.img, 3), torch.float32


def _as_input(cfg, x, device) -> torch.Tensor:
    """A caller's batch as the model's input tensor on ``device``; token
    ids are checked against the vocabulary first (an out-of-range id
    would read past the embedding table)."""
    dtype = input_shape(cfg, 0)[1]
    if dtype == torch.float32:
        return torch.as_tensor(x, dtype=dtype, device=device)
    t = torch.as_tensor(x)
    if t.is_floating_point() or t.dtype == torch.bool:
        raise ValueError(f"token ids must be integers, got {t.dtype}")
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size}), got "
                         f"[{int(t.min())}, {int(t.max())}]")
    return t.to(device=device, dtype=dtype)


class CompiledModel:
    """A quantized network lowered through one backend, served in fixed
    batch buckets.  Callable: ``logits = cm(images)`` (or ``cm(tokens)``
    for an LM)."""

    def __init__(self, cfg, params, backend: Backend,
                 batch_sizes: Sequence[int], device: torch.device):
        if not batch_sizes:
            raise ValueError("need at least one batch bucket")
        if any(b <= 0 for b in batch_sizes):
            raise ValueError(f"batch buckets must be positive: {batch_sizes}")
        self.cfg = cfg
        self.device = device
        self.params = params.to(device)
        self.backend = backend
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.graph = lowering.optimized_graph(cfg)
        self._forward = backend.lower(self.graph, cfg, self.params)
        self.run_counts: Dict[int, int] = {b: 0 for b in self.batch_sizes}

    def warmup(self) -> "CompiledModel":
        """Run every bucket once on zeros (builds the kernels, sizes the
        allocator)."""
        for b in self.batch_sizes:
            shape, dtype = input_shape(self.cfg, b)
            self(torch.zeros(shape, dtype=dtype, device=self.device))
        return self

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest if n exceeds every bucket — the
        caller chunks in that case)."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def pad(self, images: torch.Tensor) -> torch.Tensor:
        """Zero-pad a batch (images, or token rows) of at most the largest
        bucket up to its bucket: the batch a bucket run computes on."""
        n = images.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            images = torch.cat([images, images.new_zeros(
                (bucket - n,) + tuple(images.shape[1:]))], dim=0)
        return images

    def _run_batched(self, images: torch.Tensor) -> torch.Tensor:
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        cap = self.batch_sizes[-1]
        if n > cap:
            return torch.cat([self._run_batched(images[i:i + cap])
                              for i in range(0, n, cap)], dim=0)
        padded = self.pad(images)
        self.run_counts[padded.shape[0]] += 1
        return self._forward(padded)[:n]

    def __call__(self, images) -> torch.Tensor:
        return self._run_batched(_as_input(self.cfg, images, self.device))

    def stats(self) -> dict:
        return dict(backend=self.backend.name, device=str(self.device),
                    batch_sizes=self.batch_sizes,
                    run_counts=dict(self.run_counts))


def _backend(backend: Union[str, Backend]) -> Backend:
    return get_backend(backend) if isinstance(backend, str) else backend


def compile_model(cfg, qparams, backend: Union[str, Backend] = "cuda",
                  batch_sizes: Sequence[int] = (1, 8, 32), tune=None,
                  device=None) -> CompiledModel:
    """Lower the optimized graph of ``cfg`` through ``backend`` into a
    :class:`CompiledModel` on ``device`` (default ``cuda``); call
    ``.warmup()`` on it to run every bucket once before serving.

    ``qparams`` may be the ``quantize_params`` dict, a typed
    :class:`QResNetParams` or, for an LM config, a :class:`QLMParams`, on
    any device; ``backend`` a registered name or an instance.  Kernel tuning is not ported yet: ``tune`` must be None."""
    if tune is not None:
        raise ValueError(
            f"tune={tune!r}: kernel tuning is not available in repro_torch "
            f"yet; pass tune=None")
    return CompiledModel(cfg, ensure_typed(qparams), _backend(backend),
                         batch_sizes, resolve_device(device))


def lower_forward(cfg, qparams, backend: Union[str, Backend],
                  device=None) -> Callable:
    """Un-bucketed lowering: the backend's ``images -> logits`` (or
    ``tokens -> logits``) on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params = ensure_typed(qparams).to(dev)
    fwd = _backend(backend).lower(lowering.optimized_graph(cfg), cfg, params)
    return lambda images: fwd(_as_input(cfg, images, dev))


def lower_features(cfg, qparams, backend: Union[str, Backend],
                   device=None) -> Callable:
    """Un-bucketed ``images -> u8 feature map`` (the integer datapath up to
    the classifier head) of ``backend`` on ``device`` (default ``cuda``);
    for an LM, ``tokens -> int8 hidden state`` entering the unembed."""
    dev = resolve_device(device)
    params = ensure_typed(qparams).to(dev)
    feats = _backend(backend).features(lowering.optimized_graph(cfg), cfg,
                                       params)
    return lambda images: feats(_as_input(cfg, images, dev))
