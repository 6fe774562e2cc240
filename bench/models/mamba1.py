"""A mamba1 cell's program: the published Mamba1 stack (Falcon-Mamba-7B's
block) served through the port's ``CompiledModel``.

``build`` draws each float weight on the device from the seed, one matrix
at a time (``reference.mamba1.draw``: a function of the seed, the layer and
the matrix), quantizes it through the port (``compile.lm_params.
quantize_mamba1_layer``) and drops it, compiles the stack with the
configuration's backend and buckets (``compile.compile_model``) and
captures the one bucket the mix uses.  The pool is ``pool_images``
prompts (the harness's name for the pool's items: a prompt is what an
image is to the ResNet cells) of ``seq_len`` token ids, uniform over the
vocabulary, on the device.  ``params`` is the recipe (the seed and the device), which the
reference draws again layer by layer: no float model stays beside the
program.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from bench.reference import mamba1 as ref

SEED_MASK = 2 ** 63 - 1


def port_config(lm_params, cfg, mix):
    """The port's ``QMamba1Config`` of the configuration file ``cfg``."""
    m = ref.dims(cfg)
    return lm_params.QMamba1Config(
        name=cfg["name"], family="mamba1", seq_len=mix["seq_len"],
        num_layers=m.layers, d_model=m.d, vocab_size=m.vocab, d_inner=m.di,
        ssm_state=m.n, dt_rank=m.r, conv_kernel=m.k,
        norm_eps=cfg["layer_norm_epsilon"],
        mixer_rms_eps=cfg["mixer_rms_eps"])


def prompt_pool(cfg, mix, seed, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    return torch.randint(0, cfg["vocab_size"],
                         (mix["pool_images"], mix["seq_len"]),
                         generator=gen, device=device, dtype=torch.int32)


def quantized_params(lm_params, cfg, seed, device):
    """The seeded stack quantized through the port, drawn matrix by
    matrix."""
    grids = cfg["assumed"]["grids"]

    def drawer(layer):
        return lambda name: ref.draw(cfg, seed, layer, name, device)

    layers = [lm_params.quantize_mamba1_layer(drawer(i), grids)
              for i in range(cfg["num_hidden_layers"])]
    head = drawer(-1)
    return lm_params.quantize_mamba1(head("embed"), layers,
                                     head("final_norm"), head("unembed"),
                                     grids)


def build(cfg, mix, seed, device, stage):
    """``model`` (token ids -> last-position logits), ``pool`` (the
    prompts, on ``device``), ``params`` (the recipe the reference takes)
    and ``out_width`` (logits a row).  ``stage(name)`` marks the end of
    each step of the set-up."""
    from repro_torch.compile import compile_model, lm_params

    pcfg = port_config(lm_params, cfg, mix)
    pool = prompt_pool(cfg, mix, seed, device)
    params = quantized_params(lm_params, cfg, seed, device)
    stage("weights")
    model = compile_model(pcfg, params, backend=cfg["backend"],
                          batch_sizes=cfg["batch_sizes"], device=device)
    del params
    stage("compile")
    model.executable(mix["batch"])
    stage("capture")
    return SimpleNamespace(model=model, pool=pool,
                           params=dict(seed=int(seed), device=str(device)),
                           out_width=cfg["vocab_size"])
