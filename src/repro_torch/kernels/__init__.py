# Hand-written CUDA kernels for the integer ResNet hot path.  Each
# subpackage has ref.py (the plain PyTorch version) and ops.py (the wrapper:
# plain version for CPU tensors, the kernel in csrc/<name>.cu for CUDA
# tensors); _build.py compiles csrc/ with nvcc at first use.
