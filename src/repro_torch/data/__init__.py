"""``repro_torch.data`` — deterministic synthetic pipelines (numpy only)."""
