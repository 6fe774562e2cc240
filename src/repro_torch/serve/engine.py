"""Image-classification serving over the integer ResNet pipeline.

``ResNetEngine`` serves the paper's workload — integer ResNet8/20 image
classification — through :class:`repro_torch.compile.CompiledModel`: the
optimized graph is lowered once, weights live on the engine's device, and a
tick only selects a bucket, zero-pads and runs.  The default backend is
``cuda``, the hand-written per-block kernel pipeline; ``cuda-stream`` runs
each ResNet forward as one streamed ``block_chain`` launch.  The same
engine serves the int8 LMs (``compile.lm_params.lm_config``): a request
then carries a ``(seq_len,)`` token vector and gets back the ``(vocab,)``
logits of its last position.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.obs import runtime as _obs

# backends whose logits come from the same integer datapath: on a conv
# config a shadow on one of them must agree with a primary on another
# bitwise.  An LM's attention and scan are float, so there these backends
# agree only within the per-task tolerances (tests/test_torch_lm.py,
# chip_smoke.py): its deviation is recorded, never counted as a mismatch.
_INT_BACKENDS = frozenset({"cuda", "cuda-stream", "torch-int"})


@dataclasses.dataclass
class ImageRequest:
    rid: int
    image: np.ndarray                     # (H, W, 3) float image, or an LM
                                          # (seq_len,) int token vector
    logits: Optional[np.ndarray] = None   # (num_classes | vocab,) once served
    label: Optional[int] = None
    done: bool = False


def _input_contract(cfg):
    """Per-request payload (shape, numpy dtype) of one config: the model's
    input batch minus the batch dim — float images for conv configs, int32
    token vectors for LM configs."""
    if hasattr(cfg, "seq_len"):
        return (cfg.seq_len,), np.int32
    return (cfg.img, cfg.img, 3), np.float32


def _validate_image(cfg, req: ImageRequest) -> None:
    """Every bucket has a fixed shape, so a mismatched payload can never be
    batched; rejecting at submit keeps the tick loop total."""
    expect, _ = _input_contract(cfg)
    shape = tuple(np.shape(req.image))
    if shape != expect:
        raise ValueError(
            f"request {req.rid}: payload shape {shape} does not match the "
            f"compiled input shape {expect} for {cfg.name}")


class ResNetEngine:
    """Image-classification engine serving through ``CompiledModel``.

    Backends come from the ``repro_torch.compile`` registry: ``cuda``
    (default; ``conv_stem`` + one ``resblock_fused`` launch per block),
    ``cuda-stream`` (the blocks as chains, one ``block_chain`` launch each,
    the stem fused) and ``torch-int`` (the reference integer graph); all
    three give bit-identical u8 maps.  ``device=None`` means ``cuda`` and
    raises without a GPU; pass ``device="cpu"`` to run the kernels' plain
    versions.

    ``ab_backends`` compiles shadow models on further backends; every tick
    replays the primary batch through each shadow and records the max
    absolute logit deviation in ``ab_stats`` (and, with an obs session
    installed, in ``ab_checks_total``, the ``ab_max_abs_dev`` gauge and,
    between two integer backends on a conv config, ``ab_mismatch_total``)
    — a live parity
    probe for a new backend against the serving one, e.g.
    ``ResNetEngine(cfg, qp, backend="cuda-stream",
    ab_backends=("torch-int",))``."""

    def __init__(self, cfg, qparams, batch: int = 8, backend: str = "cuda",
                 batch_sizes=None, ab_backends=(), device=None):
        from repro_torch.compile import compile_model

        self.cfg, self.batch = cfg, batch
        self.backend = backend
        if batch_sizes is None:
            batch_sizes = (batch,)
        if batch not in batch_sizes:
            raise ValueError(
                f"max batch {batch} must be one of batch_sizes {batch_sizes}")
        self.model = compile_model(cfg, qparams, backend=backend,
                                   batch_sizes=batch_sizes, device=device)
        self.device = self.model.device
        self.shadows = {name: compile_model(cfg, qparams, backend=name,
                                            batch_sizes=batch_sizes,
                                            device=self.device)
                        for name in ab_backends}
        self.ab_stats = {name: [] for name in self.shadows}
        # shadows whose logits must equal the primary's bitwise
        self._bitwise = {
            name for name in self.shadows
            if not hasattr(cfg, "seq_len") and backend in _INT_BACKENDS
            and name in _INT_BACKENDS}
        self.queue: List[ImageRequest] = []
        self.served = 0

    def submit(self, req: ImageRequest):
        """Enqueue one request (shape-validated at admission)."""
        _validate_image(self.cfg, req)
        self.queue.append(req)

    def tick(self) -> bool:
        """Serve one batch; returns False when the queue is empty."""
        if not self.queue:
            return False
        reqs = self.queue[:self.batch]
        del self.queue[:len(reqs)]
        dtype = _input_contract(self.cfg)[1]
        imgs = np.stack([np.asarray(r.image, dtype) for r in reqs])
        out = self.model(imgs)
        for name, shadow in self.shadows.items():
            dev = float((shadow(imgs) - out).abs().max())
            self.ab_stats[name].append(dev)
            ob = _obs.active()
            if ob is not None:
                ob.metrics.counter(
                    "ab_checks_total", "A/B shadow replays").inc(shadow=name)
                ob.metrics.gauge(
                    "ab_max_abs_dev",
                    "last max |shadow - primary| logit deviation").set(
                        dev, shadow=name)
                if dev > 0 and name in self._bitwise:
                    ob.metrics.counter(
                        "ab_mismatch_total",
                        "integer shadow disagreed bitwise with primary").inc(
                            shadow=name)
        logits = out.cpu().numpy()
        for i, r in enumerate(reqs):
            r.logits = logits[i]
            r.label = int(np.argmax(logits[i]))
            r.done = True
        self.served += len(reqs)
        return True

    def run(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while self.queue and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks

