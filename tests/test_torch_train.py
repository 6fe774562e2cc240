"""The port's training substrate against the JAX package on the CPU:
``data.synthetic`` (the same arrays for the same seed and step),
``train.optimizer`` (``cosine_lr`` equal in float32; ``sgdm`` / ``adamw``,
int8 moments too, within 1e-5 over three steps on the same parameters and
gradients, ``bn.mean`` / ``bn.var`` decayed as the reference decays them),
``train.checkpoint`` (the same files: a checkpoint of either package
restores in the other bitwise; corruption, retention, async save) and
``train.loop`` (resume bitwise, the watchdog), and ``launch.train``."""
import functools
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.data.synthetic import SyntheticCifar as JSyntheticCifar
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import resnet as JR
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.data.synthetic import SyntheticCifar, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import resnet as R
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import (LoopConfig, Watchdog, make_train_step,
                                    run)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on few cores, and torch's thread pool spinning in
    each of them slows every test on the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_pipelines_equal_jax(seed):
    ours, ref = SyntheticCifar(8, seed=seed), JSyntheticCifar(8, seed=seed)
    toks, jtoks = SyntheticTokens(4, 16, 100, seed=seed), \
        JSyntheticTokens(4, 16, 100, seed=seed)
    np.testing.assert_array_equal(ours.templates, ref.templates)
    for pipe in (ours, ref, toks, jtoks):
        pipe.state.step = 5          # resume mid-stream
    for _ in range(3):
        for a, b in ((ours.next(), ref.next()), (toks.next(), jtoks.next())):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert ours.state.to_dict() == ref.state.to_dict() == \
        dict(seed=seed, step=8)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def test_cosine_lr_equal_in_float32():
    for base, total, warm in [(0.1, 60, 6), (0.05, 100, 0), (3e-4, 37, 11),
                              (1.0, 1, 0)]:
        ours, ref = opt_lib.cosine_lr(base, total, warm), \
            jopt.cosine_lr(base, total, warm)
        for step in range(total + 3):
            a, b = ours(step), np.asarray(ref(step))
            assert a.dtype == b.dtype == np.float32
            assert a == b, (base, total, warm, step, a, b)


@functools.cache
def _resnet8_grads(seed):
    """JAX ResNet8 params and one loss gradient (zero for bn.mean /
    bn.var), as numpy trees."""
    cfg = JR.RESNET8
    jp = JR.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    batch = dict(images=jnp.asarray(rng.random((4, 32, 32, 3),
                                               dtype=np.float32)),
                 labels=jnp.asarray(rng.integers(0, 10, 4).astype(np.int32)))
    g = jax.jit(jax.grad(lambda p: JR.loss_fn(p, cfg, batch)[0]))(jp)
    return _np(jp), _np(g)


def _none_stats(tree):
    """A gradient tree as the port's autograd gives it: ``None`` at
    bn.mean / bn.var, which the loss does not read in training mode."""
    if isinstance(tree, dict):
        return {k: None if k in ("mean", "var") and not isinstance(
            v, dict) else _none_stats(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_none_stats(v) for v in tree]
    return tree


@pytest.mark.parametrize("name,hp", [
    ("sgdm", dict(lr=0.1, weight_decay=1e-2, total_steps=10, warmup=2)),
    ("adamw", dict(lr=1e-2, weight_decay=0.1, total_steps=10, warmup=1)),
    ("adamw", dict(lr=1e-2, weight_decay=0.1, total_steps=10, warmup=1,
                   int8_state=True, state_block=32)),
])
def test_optimizer_steps_match_jax(name, hp):
    p_np, g_np = _resnet8_grads(seed=1)
    # non-trivial running stats, so their decay is visible
    rng = np.random.default_rng(2)
    p_np = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32), p_np)
    jo, po = jopt.make(name, **hp), opt_lib.make(name, **hp)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    js = jo.init(jp)
    pp = R.float_params_from_numpy(p_np, "cpu")
    ps = po.init(pp)
    jg = jax.tree_util.tree_map(jnp.asarray, g_np)
    pg = _none_stats(T.tree_map(lambda a: torch.from_numpy(a.copy()), g_np))
    assert pg["stem"]["bn"]["mean"] is None
    jupdate = jax.jit(jo.update)
    for step in range(3):
        jp, js = jupdate(jg, js, jp, step)
        pp, ps = po.update(pg, ps, pp, step)
    ref = jax.tree_util.tree_leaves(jp)
    for (path, a), b in zip(T.flatten_with_path(pp), ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=path)
    # decayed like the reference, though they have no gradient
    m = pp["stem"]["bn"]["var"].numpy()
    assert not np.array_equal(m, p_np["stem"]["bn"]["var"])
    is_q = lambda t: isinstance(t, JQ.BlockQuantized)  # noqa: E731
    ref_state = jax.tree_util.tree_leaves(js, is_leaf=is_q)
    assert len(T.leaves(ps)) == len(jax.tree_util.tree_leaves(js))
    if hp.get("int8_state"):
        moments = []          # all of m, then all of v, as JAX orders them
        for k in ("m", "v"):
            T.tree_map(lambda _, x: moments.append(x), pp, ps[k])
        got_q = [x for x in moments if isinstance(x, Q.BlockQuantized)]
        assert sum(is_q(x) for x in ref_state) == len(got_q) > 0
        for a, b in zip(got_q, [x for x in ref_state if is_q(x)]):
            assert a.q.dtype == torch.int8 and a.q.shape == b.q.shape


def test_optimizer_state_paths_are_jax_paths():
    """The flattened (params, opt_state) of both packages: the same key
    paths in the same order, BlockQuantized moments as ``.../0`` (q) and
    ``.../1`` (exp)."""
    p_np, _ = _resnet8_grads(seed=0)
    for opt, jo in ((opt_lib.sgdm(), jopt.sgdm()),
                    (opt_lib.adamw(int8_state=True, state_block=16),
                     jopt.adamw(int8_state=True, state_block=16))):
        pp = R.float_params_from_numpy(p_np, "cpu")
        jp = jax.tree_util.tree_map(jnp.asarray, p_np)
        ours = [k for k, _ in T.flatten_with_path((pp, opt.init(pp)))]
        ref = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(
                   (jp, jo.init(jp)))[0]]
        assert ours == ref
    assert "1/m/blocks/1/conv1/w/0" in ours and "0/fc/b" in ours


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tree():
    p_np, _ = _resnet8_grads(seed=3)
    return p_np, jopt.adamw(int8_state=True, state_block=16)


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def test_jax_checkpoint_restores_bitwise_and_files_match(tmp_path):
    p_np, jo = _ckpt_tree()
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    js = jo.init(jp)
    jpath = jck.save(str(tmp_path / "jax"), 7, (jp, js),
                     extra=dict(pipeline=dict(seed=1, step=8)))
    po = opt_lib.adamw(int8_state=True, state_block=16)
    pp = R.float_params_from_numpy(p_np, "cpu")
    target = (T.tree_map(torch.zeros_like, pp), po.init(pp))
    (rp, rs), step, extra = ck.restore(str(tmp_path / "jax"), target)
    assert step == 7 and extra == dict(pipeline=dict(seed=1, step=8))
    for a, b in zip(T.leaves((rp, rs)), jax.tree_util.tree_leaves((jp, js))):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port writes the same files, byte for byte
    ppath = ck.save(str(tmp_path / "port"), 7, (rp, rs),
                    extra=dict(pipeline=dict(seed=1, step=8)))
    assert _files(ppath) == _files(jpath)


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    p_np, _ = _ckpt_tree()
    pp = R.float_params_from_numpy(p_np, "cpu")
    po = opt_lib.sgdm()
    ps = po.update(_none_stats(T.tree_map(torch.ones_like, pp)),
                   po.init(pp), pp, 0)[1]
    ck.save(str(tmp_path), 3, (pp, ps), extra=dict(x=1))
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    target = (jax.tree_util.tree_map(jnp.zeros_like, jp),
              jopt.sgdm().init(jp))
    (rp, rs), step, extra = jck.restore(str(tmp_path), target)
    assert step == 3 and extra == dict(x=1)
    for a, b in zip(T.leaves((pp, ps)), jax.tree_util.tree_leaves((rp, rs))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_detects_corruption(tmp_path):
    tree = dict(a=torch.ones(8))
    path = ck.save(str(tmp_path), 1, tree)
    fname = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(path, fname))
    arr[0] = 999.0
    np.save(os.path.join(path, fname), arr)
    with pytest.raises(IOError):
        ck.restore(str(tmp_path), tree)


def test_checkpoint_retention_and_latest(tmp_path):
    tree = dict(a=torch.arange(6.0).reshape(2, 3),
                b=[torch.ones(4), torch.zeros((2, 2))])
    for step in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), step, tree, extra=dict(x=step), keep=2)
    assert ck.latest_steps(str(tmp_path)) == [4, 5]
    restored, step, extra = ck.restore(str(tmp_path), tree)
    assert step == 5 and extra["x"] == 5
    restored4, _, _ = ck.restore(str(tmp_path), tree, step=4)
    for x, y in zip(T.leaves(restored) + T.leaves(restored4),
                    T.leaves(tree) * 2):
        assert torch.equal(x, y)
    with open(os.path.join(str(tmp_path), "step_0000000005",
                           "manifest.json")) as f:
        assert sorted(json.load(f)["leaves"]) == ["a", "b/0", "b/1"]


def test_checkpoint_async_snapshots_before_writing(tmp_path):
    tree = dict(a=torch.full((16,), 7.0))
    ck.save_async(str(tmp_path), 3, tree)
    tree["a"].fill_(0.0)             # later writes do not reach the file
    ck.wait_pending()
    restored, step, _ = ck.restore(str(tmp_path), tree, device="cpu")
    assert step == 3 and torch.equal(restored["a"], torch.full((16,), 7.0))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_loop_resume_bitexact(tmp_path):
    """10 steps straight equal 5 steps + checkpoint + a resume to step 10,
    bitwise, the momenta and the pipeline position included."""
    cfg = R.RESNET8
    opt = opt_lib.sgdm(lr=0.05, total_steps=20)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, "cpu")

    def fresh():
        p = R.init_params(cfg, torch.Generator().manual_seed(0))
        return p, opt.init(p)

    logs = []
    quiet = dict(log_every=100)
    p, s = fresh()
    pA, sA, _ = run(LoopConfig(total_steps=10, **quiet), params=p,
                    opt_state=s, train_step=step,
                    pipeline=SyntheticCifar(4, seed=1), log=logs.append)
    d = str(tmp_path)
    p, s = fresh()
    run(LoopConfig(total_steps=5, ckpt_dir=d, **quiet), params=p,
        opt_state=s, train_step=step, pipeline=SyntheticCifar(4, seed=1),
        log=logs.append)
    p, s = fresh()
    pipe = SyntheticCifar(4, seed=1)
    pB, sB, _ = run(LoopConfig(total_steps=10, ckpt_dir=d, **quiet),
                    params=p, opt_state=s, train_step=step, pipeline=pipe,
                    log=logs.append)
    assert "[resume] restored step 4" in logs and pipe.state.step == 10
    for a, b in zip(T.leaves((pA, sA)), T.leaves((pB, sB))):
        assert torch.equal(a, b)


def test_loop_final_save_waits_for_the_async_save_of_its_step(tmp_path):
    """With ``total_steps`` a multiple of ``ckpt_every`` the last step is
    saved on the async thread and again at the end, into the same
    ``tmp.<step>``; the final save waits for the first."""
    cfg = R.RESNET8
    opt = opt_lib.sgdm(lr=0.05, total_steps=4)
    step = make_train_step(lambda p, b: R.loss_fn(p, cfg, b), opt, "cpu")
    p = R.init_params(cfg, torch.Generator().manual_seed(0))
    for _ in range(3):
        run(LoopConfig(total_steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                       keep=5, log_every=100), params=p,
            opt_state=opt.init(p), train_step=step,
            pipeline=SyntheticCifar(2, seed=0), log=lambda *_: None)
        assert ck.latest_steps(str(tmp_path)) == [1, 3]
        assert sorted(os.listdir(tmp_path)) == ["step_0000000001",
                                                "step_0000000003"]
        for name in os.listdir(tmp_path):
            shutil.rmtree(tmp_path / name)


def test_watchdog_fires():
    fired = []
    wd = Watchdog(0.05, abort=False, log=fired.append)
    wd.arm()
    time.sleep(0.15)
    assert wd.fired == 1 and "straggler" in fired[0]
    wd.disarm()


def test_launch_train_cpu_three_steps(tmp_path, capsys):
    params, opt_state, metrics = launch_train.main(
        ["--arch", "resnet8", "--steps", "3", "--batch", "4", "--device",
         "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert np.isfinite(float(metrics["loss"]))
    assert ck.latest_steps(str(tmp_path)) == [1, 2]
    assert "final:" in capsys.readouterr().out
    # the LMs train since ROADMAP A9.2, on a mesh under torchrun since
    # A10: one process refuses a mesh of two ranks, naming the command
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        launch_train.main(["--arch", "gemma-2b", "--device", "cpu",
                           "--mesh-data", "2"])
