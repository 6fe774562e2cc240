"""The reduction of a profiler trace and the per-layer readers, on a
trace written by hand."""
import pytest

from bench import cells, devtrace, work

TABLE = devtrace.kernel_table(cells.BENCH / "port_kernels")


def X(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


EVENTS = [
    X("user_annotation", devtrace.WINDOW, 100.0, 100.0),
    # host: two calls' operators, a wait on the device
    X("cpu_op", "aten::copy_", 100.0, 10.0),
    X("cuda_runtime", "cudaGraphLaunch", 110.0, 20.0),
    X("cuda_runtime", "cudaEventSynchronize", 150.0, 50.0),
    # device, before the window (clipped away) and inside it
    X("kernel", "void at::native::reduce_kernel<256>(...)", 90.0, 15.0),
    X("kernel", "(anonymous namespace)::resblock_fused_kernel(unsigned "
      "char const*)", 120.0, 30.0),
    X("kernel", "(anonymous namespace)::conv_stem_banded(unsigned char)",
      140.0, 20.0),
    X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 160.0, 10.0),
    X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 180.0, 5.0),
    X("gpu_user_annotation", devtrace.WINDOW, 100.0, 100.0),
]


def test_reduce():
    r = devtrace.reduce(EVENTS, TABLE)
    assert r["window_s"] == pytest.approx(100e-6)
    # union: [100, 105) [120, 170) [180, 185)
    assert r["busy_s"] == pytest.approx(60e-6)
    d = r["device_s"]
    assert d["port"] == pytest.approx(50e-6)
    assert d["conv"] == pytest.approx(50e-6)
    assert d["harness"] == pytest.approx(5e-6)
    assert d["glue"] == pytest.approx(15e-6)
    assert r["kernel_s"] == pytest.approx(dict(resblock_fused=30e-6,
                                               conv_stem=20e-6))
    gaps = dict(r["breakdown"]["idle_gaps"])
    # [105, 120) under cudaGraphLaunch (mid 112.5), [170, 180) and
    # [185, 200) under the event wait
    assert gaps == pytest.approx({"cudaGraphLaunch": 15e-6,
                                  "cudaEventSynchronize": 25e-6})
    ops = r["breakdown"]["device_ops"]
    assert ops[0][1] == pytest.approx(30e-6)
    assert all(len(name) <= devtrace.NAME_CHARS for name, _ in ops)


def test_no_window_refused():
    with pytest.raises(ValueError):
        devtrace.reduce(EVENTS[1:], TABLE)


def test_table_names_every_kernel():
    kernels = {k for _, k, _ in TABLE}
    assert {"conv_stem", "resblock_fused", "block_chain"} <= kernels
    assert {k for _, k, conv in TABLE if conv} == {
        "conv_stem", "resblock_fused", "block_chain", "conv2d_int8"}


def _rec(trace):
    cfg = cells.cell(cells.load_benchmark(), "resnet20.b32").cfg
    return dict(cfg=cfg, mix=dict(batch=32), trace=trace,
                peak=work.peaks("NVIDIA H100 80GB HBM3"),
                window=dict(enqueue_s=[40e-6, 50e-6, 60e-6],
                            latency_s=[i * 1e-4 for i in range(1, 101)],
                            calls_per_s=8000.0, images_per_s=256000.0))


def test_readers():
    tr = devtrace.reduce(EVENTS, TABLE)
    tr.update(calls=2, images=64)
    rec = _rec(tr)

    def read(name):
        return cells.reader(name)(rec)

    assert read("call_host_us") == pytest.approx(50.0)
    assert read("call_latency_p95_ms") == pytest.approx(9.595, rel=1e-3)
    assert read("glue_share") == pytest.approx(100 * 15 / 60)
    bound = work.bound_s(rec["cfg"], 32, rec["peak"])
    assert read("conv_roofline") == pytest.approx(100 * bound * 2 / 50e-6)
    assert read("device_idle") == pytest.approx(100 * (1 - 60 / 100))
    assert read("step_mfu") == pytest.approx(
        100 * 2 * 40_812_544 * 64 / 60e-6 / 1.979e15)
    # the whole step's share never passes the conv kernels'
    assert read("step_mfu") <= read("conv_roofline")


def test_readers_without_a_trace():
    rec = _rec(None)
    for name in ("glue_share", "conv_roofline", "device_idle", "step_mfu"):
        assert cells.reader(name)(rec) is None
    tr = devtrace.reduce(EVENTS, TABLE)
    tr.update(calls=2, images=64)
    rec = dict(_rec(tr), peak=None)
    for name in ("conv_roofline", "step_mfu"):
        assert cells.reader(name)(rec) is None
