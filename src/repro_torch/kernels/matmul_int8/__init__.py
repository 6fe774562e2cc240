"""The int8 matmul kernel of the LM projections (``ops.matmul_int8_op``;
plain version ``ref.matmul_int8_ref``; CUDA source
``csrc/matmul_int8.cu``)."""
