"""The JAX package's four examples (``examples/*.py``) on the port, each
run as ``python -m repro_torch.examples.<name>`` on the GPU by default
(raising without one) and on the CPU with ``--device cpu``:

* ``quickstart``: the graph's residual optimizations, QAT, the integer
  graph, the kernels bit-exact with it, the FPGA throughput model;
* ``train_resnet_cifar``: float train, PTQ, QAT, export gate, top-1;
* ``serve_lm``: a smoke LM through the continuous-batching ``Engine``;
* ``multipod_dryrun``: one production cell traced under the ``fake``
  process group.

Each has a ``main(argv)`` that prints the reference's lines and returns
what it printed as a dict."""
