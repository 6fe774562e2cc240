"""repro_torch.quantize — PTQ calibration + fake-quant QAT + accuracy eval.

The subsystem that turns a *float* ResNet8/20 into the paper's integer
network and measures what the quantization costs:

    observers  (minmax / ema / percentile range estimators)
      -> calibrate  (per-tensor pow2 grids via the folded float reference)
      -> [fine_tune — optional fake-quant QAT through repro_torch.train]
      -> export_qparams  (typed QResNetParams, int8 w/a + int16 bias)
      -> validate_export (cuda / cuda-stream / torch-int bitwise gate)
      -> evaluate_compiled  (CIFAR-10 top-1 through the serving engines)

The port of ``repro.quantize``, with the same names, JSON and dict layouts.
CLI: ``python -m repro_torch.quantize {calibrate,train,eval}``.
"""
from repro_torch.quantize.observers import (            # noqa: F401
    MinMaxObserver, MovingAverageObserver, Observer, PercentileObserver,
    make_observer, pow2_exponent)
from repro_torch.quantize.calibrate import (            # noqa: F401
    EXP_CLAMP, CalibrationResult, calibrate)
from repro_torch.quantize.qat import (                  # noqa: F401
    QuantRecipe, fake_quant_weight, fine_tune, qat_forward, qat_loss)
from repro_torch.quantize.export import (               # noqa: F401
    export_qparams, ptq_quantize, validate_export)
from repro_torch.quantize.evaluate import (             # noqa: F401
    calibration_batches, evaluate_compiled, evaluate_engine, evaluate_float,
    evaluate_variants, load_eval_set, synthetic_eval_set)
