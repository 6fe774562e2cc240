"""The int8 causal depthwise conv of the Mamba1 block, with its requantize
and SiLU (``ops.causal_conv1d_op``; plain version
``ops.causal_conv1d_ref``; CUDA source ``csrc/causal_conv1d.cu``)."""
