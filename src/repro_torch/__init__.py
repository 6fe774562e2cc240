"""``repro_torch`` — the integer ResNet datapath in PyTorch and CUDA.

A port of ``repro`` (JAX and Pallas for the TPU) to PyTorch on an NVIDIA
Hopper GPU.  The layout mirrors ``src/repro/`` module for module:

    core/quant.py        pow2 int8 quantization arithmetic
    core/graph.py        graph IR + the paper's residual optimization passes
    models/resnet.py     ResNet8/20 configs, init, BN folding, quantization
    compile/             typed params, graph lowering, backends, buckets
    kernels/             hand-written CUDA kernels, each with a plain version
    serve/engine.py      ``ResNetEngine``

Public layouts are the JAX package's: activations NHWC, conv weights HWIO,
biases int16 in the containers (widened to int32 where used).  Entry points
(``compile_model``, ``ResNetEngine``) run on the GPU unless the caller passes
``device="cpu"``.  This package imports neither ``jax`` nor ``repro``.
"""
