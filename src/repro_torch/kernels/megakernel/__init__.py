"""The block-chain kernel: a run of residual blocks, optionally headed by
the stem, in one launch (``ops.block_chain_op``; plain version
``ref.block_chain_ref``; CUDA source ``csrc/block_chain.cu``)."""
