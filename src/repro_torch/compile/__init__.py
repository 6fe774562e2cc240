"""``repro_torch.compile`` — typed quantized-model API + graph-driven
backend compiler for the serving path.

    parse (core.graph builders) -> optimize (core.graph.optimize) ->
    lower (compile.lowering + a registered Backend) ->
    execute (compile.CompiledModel: fixed batch buckets on one device)
"""
from repro_torch.compile.params import (                 # noqa: F401
    QConvParams, QLinearParams, QBlockParams, QResNetParams,
    activation_out_specs, ensure_typed, params_from_numpy)
from repro_torch.compile.lowering import (               # noqa: F401
    ChainTask, LoweringError, LoweringPlan, StemTask, BlockTask, HeadTask,
    model_graph, optimized_graph, plan_chains, plan_model, register_task)
from repro_torch.compile.backends import (               # noqa: F401
    Backend, register_backend, get_backend, list_backends)
from repro_torch.compile.compiler import (               # noqa: F401
    CompiledModel, compile_model, lower_features, lower_forward)
