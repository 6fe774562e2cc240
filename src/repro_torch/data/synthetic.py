"""Deterministic synthetic data pipelines with checkpointable state.

CIFAR-10 is not shipped with the repository, so training uses a synthetic
dataset that is (a) deterministic given (seed, step), so restarts are
bitwise reproducible, and (b) learnable: labels are a function of the
input, so loss decreases and accuracy rises above chance.

The port's own copy of ``repro.data.synthetic``: the same numpy draws, so
the same ``(seed, step)`` yields the same arrays in both packages.  Batches
are numpy arrays; the caller makes tensors of them on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self):
        return dict(seed=self.seed, step=self.step)

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticCifar:
    """32x32x3 images whose label is derivable from class-dependent color
    statistics + frozen random templates — a task a small CNN can learn."""

    def __init__(self, batch_size: int, seed: int = 0, num_classes: int = 10):
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.state = PipelineState(seed, 0)
        rng = np.random.RandomState(seed ^ 0x5EED)
        self.templates = rng.uniform(0, 1, (num_classes, 32, 32, 3)).astype(
            np.float32)

    def next(self):
        rng = np.random.RandomState(
            (self.state.seed * 1_000_003 + self.state.step) % (2 ** 31))
        labels = rng.randint(0, self.num_classes, self.batch_size)
        noise = rng.uniform(0, 1, (self.batch_size, 32, 32, 3)).astype(
            np.float32)
        images = 0.6 * self.templates[labels] + 0.4 * noise
        self.state.step += 1
        return dict(images=np.clip(images, 0, 0.999),
                    labels=labels.astype(np.int32))


class SyntheticTokens:
    """LM token stream: next token = (5*t + 7) % vocab with noise, so the
    model can reduce loss well below uniform."""

    def __init__(self, batch_size: int, seq_len: int, vocab: int,
                 seed: int = 0):
        self.batch_size, self.seq_len, self.vocab = batch_size, seq_len, vocab
        self.state = PipelineState(seed, 0)

    def next(self):
        rng = np.random.RandomState(
            (self.state.seed * 1_000_003 + self.state.step) % (2 ** 31))
        start = rng.randint(0, self.vocab, (self.batch_size, 1))
        ar = np.arange(self.seq_len)[None, :]
        tokens = (start + 5 * ar + 7) % self.vocab
        flip = rng.uniform(size=tokens.shape) < 0.05
        tokens = np.where(flip, rng.randint(0, self.vocab, tokens.shape),
                          tokens)
        labels = np.concatenate(
            [tokens[:, 1:], -np.ones((self.batch_size, 1), np.int64)], axis=1)
        self.state.step += 1
        return dict(tokens=tokens.astype(np.int32),
                    labels=labels.astype(np.int32))
