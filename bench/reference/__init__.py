"""Plain references of the configurations, in plain PyTorch."""
