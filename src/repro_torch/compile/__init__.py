"""``repro_torch.compile`` — typed quantized-model API + graph-driven
backend compiler for the serving path.

    parse (core.graph builders) -> optimize (core.graph.optimize) ->
    lower (compile.lowering + a registered Backend) ->
    execute (compile.CompiledModel: fixed batch buckets on one device)
"""
from repro_torch.compile.params import (                 # noqa: F401
    QConvParams, QLinearParams, QBlockParams, QResNetParams,
    activation_out_specs, ensure_typed, params_from_numpy)
from repro_torch.compile.lm_params import (             # noqa: F401
    LM_A_SPEC, QLMConfig, QLMParams, QMatmulParams, QSSMLayerParams,
    QTransformerLayerParams, hidden_out_spec, init_lm_params, lm_config,
    lm_params_from_numpy)
from repro_torch.compile.lowering import (               # noqa: F401
    AttentionTask, ChainTask, LMPlan, LoweringError, LoweringPlan,
    MatmulTask, ScanTask, StemTask, BlockTask, HeadTask, model_graph,
    optimized_graph, plan_chains, plan_lm, plan_model, register_task)
from repro_torch.compile.backends import (               # noqa: F401
    Backend, register_backend, get_backend, list_backends, get_task_impl,
    lm_features, lower_lm, register_task_impl)
from repro_torch.compile.compiler import (               # noqa: F401
    CompiledModel, compile_model, lower_features, lower_forward)
