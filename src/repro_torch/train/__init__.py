"""``repro_torch.train`` — optimizers, checkpoints in the JAX package's
on-disk format, and the fault-tolerant training loop."""
