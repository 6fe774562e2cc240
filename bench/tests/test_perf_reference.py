"""The plain reference against the port's ``torch-int`` backend, and the
controls (the reference at 4-bit weights, or with a float16 head) and one
u8 step of the last map failing the comparison."""
import pytest
import torch

from bench import weights
from bench.reference import resnet as ref
from bench.tests.small import small_cell

from repro_torch.compile import compile_model, lower_features
from repro_torch.models import resnet as R

CELLS = ("resnet20.b32", "resnet8.b32")
SEEDS = (3, 2 ** 31 + 77, 901)


def port(cell, params):
    """The port's config and quantized parameters of ``params``."""
    cfg = cell.cfg
    pcfg = R.ResNetConfig(cfg["name"], blocks_per_stage=cfg["blocks_per_stage"])
    qp = R.quantize_params(R.fold_params(params), pcfg)
    return pcfg, qp


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_port(workload):
    cell = small_cell(workload, pool_images=16, calib_images=16)
    params, pool = weights.make(cell.cfg, cell.mix, 11, "cpu")
    pcfg, qp = port(cell, params)
    net = ref.prepare(params, cell.cfg)
    feats = lower_features(pcfg, qp, "torch-int", device="cpu")(pool)
    assert torch.equal(ref.features(net, pool),
                       feats.to(torch.float64))
    cm = compile_model(pcfg, qp, backend="torch-int", batch_sizes=(16,),
                       device="cpu")
    gap = float((cm(pool).to(torch.float64) - ref.logits(net, pool))
                .abs().max())
    assert gap < 1e-6
    assert gap <= cell.cfg["limits"]["logit_gap"]


@pytest.mark.parametrize("control", ("w4", "head_f16"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, seed, control):
    cell = small_cell(workload, pool_images=16, calib_images=16)
    params, pool = weights.make(cell.cfg, cell.mix, seed, "cpu")
    net = ref.prepare(params, cell.cfg)
    good = ref.logits(net, pool)
    if control == "w4":
        low = ref.logits(ref.prepare(params, cell.cfg, cell.cfg["control"]),
                         pool)
    else:
        low = ref.logits(net, pool, torch.float16)
    assert float((low.to(torch.float64) - good).abs().max()) > \
        cell.cfg["limits"]["logit_gap"]


@pytest.mark.parametrize("workload", CELLS)
def test_one_step_of_the_last_map_fails(workload):
    """One u8 step at one position of the last map, in one image, moves a
    logit past the limit."""
    cell = small_cell(workload, pool_images=4, calib_images=16)
    params, pool = weights.make(cell.cfg, cell.mix, 13, "cpu")
    net = ref.prepare(params, cell.cfg)
    h = ref.features(net, pool)
    bad = h.clone()
    bad[0, 0, 0, 0] += 1 if bad[0, 0, 0, 0] < 255 else -1
    gap = float((ref.head(net, bad) - ref.head(net, h)).abs().max())
    assert gap > cell.cfg["limits"]["logit_gap"]


@pytest.mark.parametrize("workload", CELLS)
def test_maps_keep_their_range(workload):
    """The calibrated weights keep the u8 maps inside the grid: some
    positions above zero, none saturated at the largest code."""
    cell = small_cell(workload, pool_images=16, calib_images=16)
    params, pool = weights.make(cell.cfg, cell.mix, 5, "cpu")
    f = ref.features(ref.prepare(params, cell.cfg), pool)
    assert 0.3 < float((f > 0).to(torch.float64).mean()) < 1.0
    assert float((f == 255).to(torch.float64).mean()) < 0.01


def test_seed_makes_the_inputs():
    cell = small_cell("resnet8.b32", pool_images=8, calib_images=8)
    a = weights.make(cell.cfg, cell.mix, 2 ** 31 + 5, "cpu")
    b = weights.make(cell.cfg, cell.mix, 2 ** 31 + 5, "cpu")
    c = weights.make(cell.cfg, cell.mix, 2 ** 31 + 6, "cpu")
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert torch.equal(a[0]["stem"]["w"], b[0]["stem"]["w"])
