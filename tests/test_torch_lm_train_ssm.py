"""LM training in the port against the JAX package on the CPU, at smoke
size: the MoE (mixtral-8x22b, deepseek-v3-671b), SSM (falcon-mamba-7b)
and hybrid (zamba2-7b) archs, split from ``test_torch_lm_train.py`` so
that each file stays short on one test worker.

  * the gradients of ``loss_fn`` against ``jax.value_and_grad`` on
    next-token labels (loss within ``LOSS_TOL``, every leaf within
    ``GRAD_TOL`` of its largest magnitude, the same key paths); the MoE
    archs at the published capacity factor 1.25, so the recomputed
    forward under remat drops the tokens the reference drops;
  * ``make_train_step`` against the reference's, two AdamW steps at
    ``grad_accum`` 1 and 2 (and with int8 moments for mixtral-8x22b).
"""
import pytest
import torch

from repro_torch.configs import base as cb
from test_torch_lm_train import STEP_CASES, check_grads, run_steps

ARCHS = [a for a in cb.ARCH_IDS
         if cb.get_smoke_config(a).family in ("moe", "ssm", "hybrid")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_moe_configs_run_at_the_published_capacity():
    for arch in ARCHS:
        cfg = cb.get_smoke_config(arch)
        assert cfg.family != "moe" or cfg.moe_capacity_factor == 1.25


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch,grad_accum,int8_state", [
    ("mixtral-8x22b", g, i8) for g, i8 in STEP_CASES] + [
    (a, g, False) for a in ("falcon-mamba-7b", "zamba2-7b") for g in (1, 2)])
def test_train_step_matches_reference(arch, grad_accum, int8_state):
    """int8 moments on the MoE only (their compile is the slow part of
    the reference's step; llama3.2-3b has them too)."""
    run_steps(arch, grad_accum, int8_state)
