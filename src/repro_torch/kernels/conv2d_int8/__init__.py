"""General int8 conv: fh x fw, strided, optional skip accumulator init,
ReLU and pow2 requant (``ops.conv2d_int8_op``; plain version
``ref.conv2d_int8_plain``; CUDA source ``csrc/conv2d_int8.cu``)."""
