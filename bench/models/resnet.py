"""A ResNet cell's program: ResNet8/20 served through the port's
``CompiledModel``.

``build`` makes the float weights and the image pool on the device from
the seed (``bench.weights``), folds and quantizes them through the port
(``models.resnet.fold_params``, ``quantize_params``), compiles the model
with the configuration's backend and buckets (``compile.compile_model``)
and captures the one bucket the mix uses.
"""
from __future__ import annotations

from types import SimpleNamespace

from bench import weights


def port_config(resnet, cfg):
    """The port's ``ResNetConfig`` of the configuration file ``cfg``."""
    if cfg["stages"] != 3 or cfg["in_channels"] != 3:
        raise ValueError("the port's ResNet has 3 stages and 3 input "
                         "channels")
    return resnet.ResNetConfig(
        cfg["name"], blocks_per_stage=cfg["blocks_per_stage"],
        base_width=cfg["base_width"], num_classes=cfg["num_classes"],
        img=cfg["img"], bw_w=cfg["bw_w"], bw_x=cfg["bw_x"], bw_b=cfg["bw_b"])


def build(cfg, mix, seed, device, stage):
    """``model`` (images -> logits, the entry the window drives),
    ``pool`` (the inputs, on ``device``), ``params`` (the float weights
    the reference takes) and ``out_width`` (logits a row).  ``stage(name)``
    marks the end of each step of the set-up."""
    from repro_torch.compile import compile_model
    from repro_torch.models import resnet

    params, pool = weights.make(cfg, mix, seed, device)
    stage("weights")
    pcfg = port_config(resnet, cfg)
    qparams = resnet.quantize_params(resnet.fold_params(params), pcfg)
    model = compile_model(pcfg, qparams, backend=cfg["backend"],
                          batch_sizes=cfg["batch_sizes"], device=device)
    stage("quantize")
    model.executable(mix["batch"])
    stage("capture")
    return SimpleNamespace(model=model, pool=pool, params=params,
                           out_width=cfg["num_classes"])
