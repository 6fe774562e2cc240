"""``repro_torch.serve`` — the image-classification serving engine."""
from repro_torch.serve.engine import ImageRequest, ResNetEngine  # noqa: F401
