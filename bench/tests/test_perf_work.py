"""Work counts from the configuration's widths alone."""
import json

import pytest

from bench import cells, work
from bench.reference import resnet as ref

MACS = {"resnet20": 40_812_544, "resnet8": 12_500_992}
WEIGHT_BYTES = {"resnet20": 271_824, "resnet8": 77_392}


def cfg_of(name):
    return json.loads((cells.BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(MACS))
def test_macs_per_image(name):
    assert work.conv_macs_per_image(cfg_of(name)) == MACS[name]


def _macs_by_hand(cfg):
    """The same count written out stage by stage."""
    res, ich, base = cfg["img"], cfg["in_channels"], cfg["base_width"]
    macs = res * res * 9 * ich * base
    ich = base
    for stage in range(cfg["stages"]):
        och = base * 2 ** stage
        for bi in range(cfg["blocks_per_stage"]):
            if stage > 0 and bi == 0:
                res //= 2
                macs += res * res * ich * och          # 1x1 downsample
            macs += res * res * 9 * (ich + och) * och  # conv0, conv1
            ich = och
    return macs


@pytest.mark.parametrize("name", sorted(MACS))
def test_macs_by_hand(name):
    assert work.conv_macs_per_image(cfg_of(name)) == _macs_by_hand(
        cfg_of(name))


@pytest.mark.parametrize("name", sorted(MACS))
def test_bytes(name):
    cfg = cfg_of(name)
    filters = sum(c.fh * c.fw * c.ich * c.och for c in work.convs(cfg))
    biases = sum(c.och for c in work.convs(cfg))
    assert work.weight_bytes(cfg) == filters + 2 * biases == \
        WEIGHT_BYTES[name]
    assert work.last_map(cfg) == (8, 64)
    for batch in (32, 256):
        assert work.conv_bytes(cfg, batch) == \
            batch * (32 * 32 * 3 + 8 * 8 * 64) + WEIGHT_BYTES[name]
        assert work.conv_ops(cfg, batch) == 2 * MACS[name] * batch


def test_bound_and_peaks():
    cfg = cfg_of("resnet20")
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert peak == dict(int8_ops_per_s=1.979e15, hbm_bytes_per_s=3.35e12)
    assert work.peaks("NVIDIA A100-SXM4-80GB") is None
    # operations bound both batches: 2 x MACs x batch / 1,979 TOP/s
    assert work.bound_s(cfg, 32, peak) == pytest.approx(
        2 * MACS["resnet20"] * 32 / 1.979e15)
    assert work.bound_s(cfg, 256, peak) == pytest.approx(
        2 * MACS["resnet20"] * 256 / 1.979e15)


@pytest.mark.parametrize("name", sorted(MACS))
def test_layout_agrees_with_reference(name):
    """``work.convs`` walks the same network as the reference's strides."""
    cfg = cfg_of(name)
    strides = ref.block_strides(cfg)
    assert len(strides) == 3 * cfg["blocks_per_stage"]
    ds = sum(c.name == "ds" for c in work.convs(cfg))
    assert ds == sum(s == 2 for s in strides) == 2
