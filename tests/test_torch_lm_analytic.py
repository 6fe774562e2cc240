"""The port's analytic roofline terms (``launch.analytic``) and H100
constants (``launch.mesh``) against the JAX package on the CPU: for every
arch and every shape of ``SHAPES``, on a one-card cell and on the
reference's 256-chip FSDP x TP cell, the flop, byte and collective terms
equal to the reference's exactly, and each seconds term that term over
the port's constant; the two analytic cases of ``tests/test_dataflow.py``
on the port."""
import dataclasses

import numpy as np
import pytest

from repro.configs import base as jcb
from repro.launch import analytic as JA
from repro_torch.configs import base as cb
from repro_torch.launch import analytic as A
from repro_torch.launch import mesh as mesh_lib

CELLS = [dict(chips=1, tp=1, fsdp=1, grad_accum=2),
         dict(chips=256, tp=16, fsdp=16, grad_accum=8),
         dict(chips=8, tp=2, fsdp=4, grad_accum=1, causal_skip=True,
              opt_state_bytes_per_param=2.0)]
EXACT = ("an_flops_per_device", "an_bytes_per_device",
         "an_collective_bytes_per_device")


def test_h100_constants():
    """The H100 SXM data sheet's dense peaks, not the TPU's."""
    assert mesh_lib.PEAK_BF16_FLOPS == 989e12
    assert mesh_lib.PEAK_INT8_OPS == 1979e12
    assert mesh_lib.HBM_BW == 3.35e12
    assert mesh_lib.ICI_BW == 450e9
    assert mesh_lib.HBM_BYTES == 80e9


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_terms_equal_reference(arch):
    for shape in cb.SHAPES:
        for kw in CELLS:
            got = A.analytic_terms(A.Cell(cfg=cb.get_config(arch),
                                          shape=cb.SHAPES[shape], **kw))
            want = JA.analytic_terms(JA.Cell(cfg=jcb.get_config(arch),
                                             shape=jcb.SHAPES[shape], **kw))
            assert got.keys() == want.keys()
            for k in EXACT:
                assert got[k] == want[k], (shape, kw, k)
            compute = got["an_flops_per_device"] / mesh_lib.PEAK_BF16_FLOPS
            memory = got["an_bytes_per_device"] / mesh_lib.HBM_BW
            coll = got["an_collective_bytes_per_device"] / mesh_lib.ICI_BW
            assert (got["an_compute_s"], got["an_memory_s"],
                    got["an_collective_s"]) == (compute, memory, coll)
            step = max(compute, memory, coll)
            assert got["an_step_s"] == step
            assert got["an_bottleneck"] == max(
                (("compute", compute), ("memory", memory),
                 ("collective", coll)), key=lambda t: t[1])[0]
            # the model flops (checked equal in test_torch_lm_float.py)
            # over the port's peak
            mf = want["an_useful_ratio"] * got["an_flops_per_device"]
            np.testing.assert_allclose(
                got["an_mfu"], mf / mesh_lib.PEAK_BF16_FLOPS / step,
                rtol=1e-12)
            assert got["an_useful_ratio"] == want["an_useful_ratio"]


def test_cell_fields_equal_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(A.Cell)] == \
        [(f.name, f.default) for f in dataclasses.fields(JA.Cell)]


@pytest.mark.parametrize("arch,shape", [
    ("gemma-2b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
    ("falcon-mamba-7b", "long_500k"), ("deepseek-v3-671b", "prefill_32k"),
    ("zamba2-7b", "train_4k"), ("whisper-large-v3", "prefill_32k"),
])
def test_analytic_terms_positive_and_sane(arch, shape):
    """``tests/test_dataflow.py``'s case on the port."""
    cfg = cb.get_config(arch)
    cell = A.Cell(cfg=cfg, shape=cb.SHAPES[shape], chips=256, tp=16,
                  fsdp=16, grad_accum=8)
    t = A.analytic_terms(cell)
    assert t["an_compute_s"] > 0 and t["an_bytes_per_device"] > 0
    assert 0 < (t["an_mfu"] or 1) <= 1.0
    assert 0.05 < t["an_useful_ratio"] < 1.2


def test_train_flops_scale_with_tokens():
    """``tests/test_dataflow.py``'s case on the port."""
    cfg = cb.get_config("llama3.2-3b")
    t1 = A.analytic_terms(A.Cell(cfg=cfg, shape=cb.SHAPES["train_4k"],
                                 chips=256, tp=16, fsdp=16))
    big = cb.ShapeSpec("x", 4096, 512, "train")
    t2 = A.analytic_terms(A.Cell(cfg=cfg, shape=big, chips=256, tp=16,
                                 fsdp=16))
    np.testing.assert_allclose(t2["an_flops_per_device"],
                               2 * t1["an_flops_per_device"], rtol=1e-6)
