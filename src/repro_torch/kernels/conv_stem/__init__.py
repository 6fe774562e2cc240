"""Stem conv: 3x3 stride-1 conv + ReLU + pow2 requant of the u8 image."""
