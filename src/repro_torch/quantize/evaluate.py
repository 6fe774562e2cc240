"""CIFAR-10 accuracy harness — top-1 through the *serving* path.

The paper's headline numbers are accuracies (ResNet8 88.7%, ResNet20 91.3%
top-1 on CIFAR-10) measured on the quantized network.  This harness measures
the same quantity through the exact production stack: the eval set streams as
``ImageRequest``\\ s through ``serve.ResNetEngine`` (or the replica-pool
``ShardedResNetEngine``), so accuracy, throughput and the serving machinery
are exercised as one system — an eval run is also a zero-retrace check.

Data: the real CIFAR-10 test split when ``REPRO_DATA_DIR`` points at a
directory containing ``cifar-10-batches-py/test_batch`` (the canonical
python-version extraction); otherwise a deterministic labeled synthetic set
from ``data.synthetic.SyntheticCifar`` (same generator as training, disjoint
seed), so a run measures a stable, meaningful top-1 without shipping the
dataset.  Nothing is downloaded.

The engines and the float reference run on ``device`` (default ``cuda``,
raising without a GPU); ``device="cpu"`` runs the kernels' plain versions.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticCifar

DATA_ENV = "REPRO_DATA_DIR"
#: synthetic eval batches are drawn at pipeline steps >= this offset, far
#: past any realistic training run, so the eval noise/label draws are
#: disjoint from training batches while the class templates (the *task*,
#: fixed by the seed) stay the same
SYNTH_EVAL_STEP = 1_000_000
#: calibration batches draw at this offset — held out from training AND
#: disjoint from the eval set above
CALIB_STEP = 500_000


def calibration_batches(n: int = 2, batch: int = 64, seed: int = 0,
                        step_offset: int = CALIB_STEP):
    """Held-out calibration batches of the synthetic training task: same
    seed = same class templates (the task), ``step_offset`` = draws no
    training run reaches and the eval set never uses.  THE one home for the
    offset constant — the CLI and ``chip_smoke.py`` calibrate on
    these."""
    pipe = SyntheticCifar(batch, seed=seed)
    pipe.state.step = step_offset
    return [pipe.next() for _ in range(n)]


def _cifar_test_file(data_dir: Optional[str]) -> Optional[str]:
    data_dir = data_dir or os.environ.get(DATA_ENV)
    if not data_dir:
        return None
    for rel in ("cifar-10-batches-py/test_batch", "test_batch"):
        path = os.path.join(data_dir, rel)
        if os.path.isfile(path):
            return path
    return None


def load_cifar10_test(path: str, n: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The real CIFAR-10 test split: (N,32,32,3) float32 in [0,1), int32
    labels."""
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    imgs = imgs.astype(np.float32) / 256.0     # u8/256 keeps the range < 1
    labels = np.asarray(d[b"labels"], np.int32)
    if n is not None:
        imgs, labels = imgs[:n], labels[:n]
    return imgs, labels


def synthetic_eval_set(n: int, seed: int = 0,
                       step_offset: int = SYNTH_EVAL_STEP
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic labeled synthetic eval set.

    ``seed`` must be the TRAINING pipeline's seed: ``SyntheticCifar``'s class
    templates — the task itself — are a function of the seed, so a model
    trained on seed ``s`` is only evaluable on seed-``s`` images.  Held-out
    separation comes from ``step_offset`` instead: eval batches are drawn at
    pipeline steps no training run ever reaches, so the noise and label draws
    are fresh while the task matches.  ``(n, seed, step_offset)`` fully
    determine the set (pinned in tests)."""
    pipe = SyntheticCifar(batch_size=min(n, 512), seed=seed)
    pipe.state.step = step_offset
    imgs, labels = [], []
    got = 0
    while got < n:
        b = pipe.next()
        imgs.append(b["images"])
        labels.append(b["labels"])
        got += len(b["labels"])
    return (np.concatenate(imgs)[:n].astype(np.float32),
            np.concatenate(labels)[:n].astype(np.int32))


def load_eval_set(n: int = 1024, data_dir: Optional[str] = None,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray, str]:
    """(images, labels, source): real CIFAR-10 test data when available
    under ``data_dir`` / ``$REPRO_DATA_DIR``, else the synthetic fallback
    (``seed`` = the training pipeline's seed; ignored for real data).
    ``source`` is ``"cifar10"`` or ``"synthetic"``."""
    path = _cifar_test_file(data_dir)
    if path is not None:
        imgs, labels = load_cifar10_test(path, n)
        return imgs, labels, "cifar10"
    imgs, labels = synthetic_eval_set(n, seed=seed)
    return imgs, labels, "synthetic"


# ---------------------------------------------------------------------------
# Top-1 through the serving engines
# ---------------------------------------------------------------------------


def evaluate_engine(engine, images, labels) -> dict:
    """Stream ``images`` through a serving engine (``ResNetEngine`` or
    ``ShardedResNetEngine``) and score top-1 against ``labels``.

    Returns ``{"top1", "served", "fps", "ticks", "retraces"}`` — ``retraces``
    is the max *per-executable* trace count of the engine's compiled model:
    a replica pool legitimately traces once per device (``trace_counts`` is
    shared across placements), so the count is normalized by the pool size.
    A healthy serving path keeps it at 1 (the zero-per-tick-retrace
    property)."""
    from repro_torch.serve.engine import ImageRequest

    images = np.asarray(images, np.float32)
    labels = np.asarray(labels)
    reqs = [ImageRequest(rid=i, image=images[i]) for i in range(len(images))]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    ticks = engine.run()
    dt = time.perf_counter() - t0
    if not all(r.done for r in reqs):
        raise RuntimeError(
            f"engine left {sum(not r.done for r in reqs)} requests unserved")
    pred = np.array([r.label for r in reqs])
    n_exec = len(getattr(engine, "pool", ())) or 1
    return dict(top1=float(np.mean(pred == labels)),
                served=len(reqs), ticks=int(ticks),
                fps=float(len(reqs) / max(dt, 1e-9)),
                retraces=int(np.ceil(
                    max(engine.model.trace_counts.values()) / n_exec)))


def evaluate_compiled(cfg, qparams, images, labels, backend: str = "cuda",
                      batch: int = 64, replicas: Optional[int] = None,
                      tune=None, device=None) -> dict:
    """Build the serving engine for ``qparams`` on ``device`` and run the
    harness.

    ``replicas=None`` serves through the single-device ``ResNetEngine``;
    an int serves through the replica-pool ``ShardedResNetEngine`` (the
    scale-out path: one replica a card, or ``replicas`` replicas on
    ``device`` when it is the CPU), still scoring the same top-1."""
    from repro_torch.compile.compiler import resolve_device
    from repro_torch.serve.engine import ResNetEngine, ShardedResNetEngine

    dev = resolve_device(device)
    batch = min(batch, len(images))
    if replicas is None:
        eng = ResNetEngine(cfg, qparams, batch=batch, backend=backend,
                           tune=tune, device=dev)
    else:
        eng = ShardedResNetEngine(
            cfg, qparams, batch=batch, backend=backend, replicas=replicas,
            tune=tune, devices=[dev] * replicas if dev.type == "cpu"
            else None)
        eng.pool.warmup()
    out = evaluate_engine(eng, images, labels)
    out.update(backend=backend, batch=batch,
               replicas=0 if replicas is None else replicas)
    return out


def evaluate_variants(variants, images, labels, backend: str = "cuda",
                      batch: int = 64, replicas=None, device=None) -> dict:
    """Top-1 of several model variants on one shared eval set — the accuracy
    references the traffic layer's graceful-degradation accounting prices
    requests with.  ``variants`` maps a variant name (e.g. ``"resnet20"``)
    to ``(cfg, qparams)``; every variant is scored through the real serving
    engine via :func:`evaluate_compiled`, so the numbers are serving-path
    numbers, not offline ones.  Returns ``{name: top1}``."""
    return {name: float(evaluate_compiled(
        cfg, qp, images, labels, backend=backend, batch=batch,
        replicas=replicas, device=device)["top1"])
        for name, (cfg, qp) in variants.items()}


@torch.no_grad()
def evaluate_float(cfg, params, images, labels, batch: int = 64,
                   forward=None, device=None) -> dict:
    """The float reference top-1 (``models.resnet.forward`` in eval mode, BN
    running stats) on ``device`` (default ``cuda``; the params are placed
    there) — the number PTQ/QAT accuracies are compared against.
    ``forward(params, images)`` can override the model fn (e.g. the QAT
    fake-quant path via ``qat.qat_forward``)."""
    from repro_torch.compile.compiler import resolve_device
    from repro_torch.models import resnet as R

    if forward is None:
        forward = lambda p, x: R.forward(p, cfg, x, train=False)  # noqa
    dev = resolve_device(device)
    params = R.params_to(params, dev)
    images = np.asarray(images, np.float32)
    batch = min(batch, len(images))
    preds = []
    for i in range(0, len(images), batch):
        chunk = images[i:i + batch]
        pad = batch - len(chunk)
        if pad:        # one fixed shape, as serving runs
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        logits = forward(params, torch.as_tensor(chunk, device=dev))
        preds.append(logits.argmax(-1).cpu().numpy()[
            :len(images[i:i + batch])])
    pred = np.concatenate(preds)
    return dict(top1=float(np.mean(pred == np.asarray(labels))),
                served=len(images), batch=batch)
