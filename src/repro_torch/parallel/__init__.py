"""``repro_torch.parallel`` — FSDP x TP placements on DTensor
(``sharding``), the ambient mesh (``ctx``), the compressed gradient
all-reduce and the collective matmul (``collectives``) and pipeline
stages (``pp``): the port of ``repro.parallel``.  The reference's
``_compat.py`` is a shim across JAX versions of ``shard_map`` and has no
counterpart here."""
