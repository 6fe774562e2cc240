from repro_torch.models import resnet  # noqa: F401
