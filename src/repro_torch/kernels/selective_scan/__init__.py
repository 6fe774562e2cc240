"""The selective-scan kernel of the Mamba1 LMs (``ops.selective_scan_op``;
plain version ``ref.selective_scan_ref``; CUDA source
``csrc/selective_scan.cu``)."""
