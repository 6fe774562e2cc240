"""Cells shrunk to sizes the CPU holds, for the tests."""
import dataclasses

from bench import cells


def small_cell(workload, **mix):
    """The cell ``workload`` of ``BENCHMARK.json`` with a pool of four
    slices, a short calibration batch and one warm-up call."""
    c = cells.cell(cells.load_benchmark(), workload)
    small = dict(c.mix, pool_images=4 * c.mix["batch"], calib_images=32,
                 warmup_calls=1, trace_calls=2)
    small.update(mix)
    return dataclasses.replace(c, mix=small)
