"""Fused residual block: conv0 -> requant -> [1x1 ds] add-fold -> conv1."""
