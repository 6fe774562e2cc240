"""``repro_torch.tune`` — the tiling knobs (``config``) and the chain
planner's legality space (``space``).  The search, cost model and cache of
``repro.tune`` are not ported yet."""
