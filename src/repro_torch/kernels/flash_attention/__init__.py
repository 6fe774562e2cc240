"""The flash-attention kernel of the transformer LMs
(``ops.flash_attention_op``; plain versions ``ref.attention_ref`` and
``ref.flash_attention_mirror``; CUDA source ``csrc/flash_attention.cu``)."""
