"""Sharded training in the port (FSDP x TP on DTensor: ``parallel.ctx``'s
gathers in the models, ``launch.steps.make_train_step`` under a mesh,
``adamw`` on DTensors, resharding checkpoints, ``launch.train`` under
``torchrun``) against the port's unsharded step and the JAX package.

  * one spawned world of 4 gloo ranks on a (2, 2) ``("data", "model")``
    mesh (``_torch_worlds.train_world``): the gradients of all ten smoke
    configs (and one with QAT on) within ``TOL`` of each leaf's largest of
    the unsharded ones, each on its parameter's placements; two steps of ``make_train_step``
    (``grad_accum=2``, float and int8 moments) for gemma-2b,
    falcon-mamba-7b and mixtral-8x22b, params and moments within ``TOL``
    of the unsharded step's, the losses within ``LOSS_TOL`` of the JAX
    package's single-device step; int8 moments refused on a placement
    whose local extent is not whole blocks; a checkpoint written on
    (2, 2) restored bitwise onto (4, 1), onto its own placements, onto
    one device and through the JAX package's ``restore``;
  * ``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
    gemma-2b --smoke --mesh-data 2 --mesh-model 2 --device cpu`` against
    the reference's single-device ``train_lm`` from the same weights.
"""
import argparse
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_float import both, jax_to_numpy, jax_shapes

from _torch_dist import run_world, value
from _torch_worlds import _lm_batch, train_world
from repro.configs import base as jcb
from repro.launch import steps as JS
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.configs import base as cb
from repro_torch.core import tree as T
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt_lib

ROOT = os.path.join(os.path.dirname(__file__), "..")
# sharded against unsharded: the same arithmetic but the partial sums of
# each weight's gradient (over the ranks' rows) in another order
TOL = 1e-5
LOSS_TOL = 1e-4
# the steps' AdamW as in test_torch_lm_train.py (eps 1e-3: see there), with
# int8 blocks of 32 so that every sharded last dim is whole blocks locally
HP = dict(lr=1e-2, total_steps=10, warmup=1, eps=1e-3, state_block=32)
STEP_ARCHS = ["gemma-2b", "falcon-mamba-7b", "mixtral-8x22b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pairs = {a: both(a) for a in STEP_ARCHS}
    d = tmp_path_factory.mktemp("ck")
    inp = dict(params={a: p[3] for a, p in pairs.items()}, hp=HP,
               ckpt_dir=str(d / "ck"))
    res = run_world(train_world, 4, tmp_path_factory.mktemp("w"), inp)
    return res, pairs, str(d / "ck")


@pytest.mark.parametrize("arch", cb.ARCH_IDS + ["qat", "layer-sharded"])
def test_sharded_gradients_match_unsharded(world, arch):
    """Each of the ten; llama3.2-3b with ``quant="qat"`` (whose dynamic
    exponent is the whole batch's, ``ctx.batch_max``); falcon-mamba-7b
    with ``d_inner`` 8,192, whose (L, d_inner) leaves are FSDP-sharded on
    their layer dim (gathered along it before the layers unbind)."""
    v = value(world[0], f"grads/{arch}")
    if arch == "layer-sharded":
        assert v["n_layer_sharded"] > 0
    l0, l1 = v["loss"]
    assert abs(l1 - l0) <= LOSS_TOL * max(1.0, abs(l0))
    assert v["rel"] <= TOL, v["rel"]
    assert v["axes"] == ("data",)            # 4 rows over 2 data ranks
    assert v["n_sharded"] > 0 and v["same_pl"]


def _int8_close(got, want, tol, block=HP["state_block"]):
    """An int8 moment ``(q, exp)`` against another: the dequantized values
    within one quantum of their block plus ``tol`` of the largest, the
    exponents equal and the payloads at most one step apart on every
    block that reaches ``tol`` of the largest (as ``_quantized_close`` of
    tests/test_torch_lm_train.py)."""
    (q, e), (wq, we) = got, want

    def per_entry(x):
        return np.repeat(x, block, axis=-1)[..., :q.shape[-1]]

    dq = q.astype(np.float64) * per_entry(2.0 ** e.astype(np.float64))
    wdq = wq.astype(np.float64) * per_entry(2.0 ** we.astype(np.float64))
    floor = tol * np.abs(wdq).max()
    big = 2.0 ** (we.astype(np.float64) + 7) >= floor
    assert np.array_equal(e[big], we[big])
    assert np.abs(q.astype(int) - wq)[per_entry(big)].max(initial=0) <= 1
    quantum = per_entry(2.0 ** np.maximum(e, we).astype(np.float64))
    assert np.all(np.abs(dq - wdq) <= quantum + floor)


def _jax_losses(arch, pairs, int8):
    jcfg, cfg, jp, _ = pairs[arch]
    jo = jopt.adamw(**dict(HP, int8_state=int8))
    jstep = jax.jit(JS.make_train_step(jcfg, jo, grad_accum=2))
    js, out = jo.init(jp), []
    for i in range(2):
        x = {k: jnp.asarray(v.numpy())
             for k, v in _lm_batch(cfg, 10 + i, 8, 16).items()}
        jp, js, m = jstep(jp, js, i, x)
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_steps_match_unsharded_and_reference(world, arch, int8):
    v = value(world[0], f"steps/{arch}/{'int8' if int8 else 'float'}")
    for a, b in zip(v["uparams"], v["params"]):
        off = np.abs(b - a) > TOL * np.abs(a).max()
        if int8:
            # where a moment landed a quantum apart, that entry's step
            # differs: at most 0.1% of a leaf, and by no more than a step
            # of lr a step (as tests/test_torch_lm_train.py allows against
            # the reference)
            assert off.mean() <= 1e-3
            assert np.all(np.abs(b - a)[off] <= HP["lr"] * 2)
        else:
            assert not off.any(), np.abs(b - a).max()
    for a, b in zip(v["umoments"], v["moments"]):
        assert a[0] == b[0]
        if a[0] == "f":
            np.testing.assert_allclose(b[1], a[1], rtol=0,
                                       atol=TOL * np.abs(a[1]).max())
        else:
            _int8_close(b[1:], a[1:], TOL)
    for got, own in zip(v["losses"], v["ulosses"]):
        assert abs(got - own) <= LOSS_TOL * max(1.0, abs(own))
    for got, want in zip(v["losses"], _jax_losses(arch, world[1], int8)):
        assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want)), \
            (got, want)


def test_int8_moments_refuse_a_split_block(world):
    msg = value(world[0], "refuses_int8")
    assert msg is not None and "multiple of the block 32" in msg
    assert re.match(r"\S+: int8 moments", msg), msg     # names the leaf


def test_checkpoint_reshards_onto_another_mesh(world):
    v = value(world[0], "checkpoint")
    assert v["written"] == [7, 8] and v["step"] == 7
    assert v["extra"] == dict(mesh="2x2")
    assert v["same"] and v["placed"] and v["same2"]
    assert v["n41"] > 0


def test_checkpoint_restores_onto_one_device_and_in_jax(world):
    """The (2, 2) checkpoint read back whole by the port onto the CPU and
    by the JAX package's ``restore``, bitwise."""
    v = value(world[0], "checkpoint")
    want = T.leaves(v["full"])
    cfg = cb.get_smoke_config("gemma-2b")
    opt = opt_lib.adamw(**dict(HP, int8_state=True))
    fresh = M.init_params(cfg, 5, "cpu")
    (p, s), step, _ = ck.restore(world[2], (fresh, opt.init(fresh)), step=7,
                                 device="cpu")
    assert step == 7
    got = T.leaves((p, s))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    jcfg = jcb.get_smoke_config("gemma-2b")
    jp = jax.tree_util.tree_map(
        lambda s_: jnp.zeros(s_.shape, s_.dtype), jax_shapes(jcfg))
    jo = jopt.adamw(**dict(HP, int8_state=True))
    (rp, rs), jstep, _ = jck.restore(world[2], (jp, jo.init(jp)), step=7)
    assert jstep == 7
    jl = jax.tree_util.tree_leaves((rp, rs))
    assert len(jl) == len(want)
    for a, b in zip(jl, want):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_lm_on_a_mesh_under_torchrun(monkeypatch, capsys, tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train ...
    --mesh-data 2 --mesh-model 2 --device cpu`` ends within 1e-4 of the
    reference's single-device ``train_lm`` started from the same weights
    (the port's draw from ``--seed``, carried into the reference)."""
    cfg = cb.get_smoke_config("gemma-2b")
    jcfg = jcb.get_smoke_config("gemma-2b")
    tree = M.params_to_numpy(M.init_params(cfg, 0, "cpu"))
    jp = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), tree,
                                jax_shapes(jcfg))
    monkeypatch.setattr(jtrain.M, "init_params", lambda c, k: jp)
    jtrain.train_lm(argparse.Namespace(
        arch="gemma-2b", steps=3, batch=8, seq=16, lr=1e-3, seed=0,
        smoke=True, grad_accum=2, int8_opt=False, ckpt_dir=None,
        ckpt_every=50, watchdog_s=0.0, mesh_data=1, mesh_model=1))
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final:")][-1]
    jloss = float(jline.split("'loss': ")[1].split(",")[0])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "gemma-2b", "--smoke", "--mesh-data", "2",
         "--mesh-model", "2", "--device", "cpu", "--steps", "3",
         "--batch", "8", "--seq", "16", "--grad-accum", "2",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    finals = [ln for ln in r.stdout.splitlines() if ln.startswith("final:")]
    assert len(finals) == 1                     # rank 0 alone reports
    loss = float(finals[0].split("'loss': ")[1].split(",")[0])
    assert abs(loss - jloss) <= 1e-4 * jloss, (loss, jloss)
    assert ck.latest_steps(str(tmp_path / "ck")) == [1, 2]


def test_train_lm_refuses_a_world_of_another_size():
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        launch_train.main(["--arch", "gemma-2b", "--smoke", "--mesh-data",
                           "2", "--mesh-model", "2", "--device", "cpu"])
