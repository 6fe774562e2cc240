"""``repro_torch.tune`` — design-space exploration and autotuning of the
kernel pipeline on the H100's own knobs (the port of ``repro.tune``):

    space (legal per-task KernelConfigs: band heights, chain splits and
           batch tiles under the shared-memory budget)
      -> cost (analytic roofline ranking at the H100's ratios)
      -> search (time the top-K served models on the card, validate
                 bitwise against torch-int)
      -> cache (persistent JSON, keyed on model/shapes/dtype/backend/card)

Entry points:

    res = tune.search(cfg, qp, backend="cuda", batch=32)      # TuneResult
    cm  = compile_model(cfg, qp, tune=res.tuning)             # or tune="auto"
    python -m repro_torch.tune --arch resnet20 --backend cuda --batch 32

``space`` also holds the chain planner and the kernels' decomposition
rules (``block_band_rows``, ``chain_split``).
"""
from repro_torch.tune.config import DEFAULT, KernelConfig  # noqa: F401
from repro_torch.tune.cache import (  # noqa: F401
    TuneCache, cache_key, cache_path)
from repro_torch.tune import cost, space  # noqa: F401
from repro_torch.tune.search import (  # noqa: F401
    TuneResult, device_kind, interleaved_time, joint_candidates, model_key,
    rank_spaces, search)
