"""LM training in the port (``launch.steps.make_train_step``,
``launch.train.train_lm``, ``train.optimizer.adamw``'s in-place update,
remat and the unbound layer stacks of ``models``) against the JAX package
on the CPU, at smoke size, on weights carried across by the bridge.

  * the gradients of ``loss_fn`` against ``jax.value_and_grad`` for the
    six dense, audio and vision archs (the MoE, SSM and hybrid ones in
    ``test_torch_lm_train_ssm.py``), on next-token labels: loss within
    ``LOSS_TOL``, every leaf within ``GRAD_TOL`` of its largest magnitude,
    the same key paths; one ``quant="qat"`` config (the STE path) and one
    bf16 config;
  * ``make_train_step`` against the reference's, two AdamW steps at
    ``grad_accum`` 1 and 2 and with int8 moments (llama3.2-3b here);
  * remat is real (autograd keeps strictly fewer bytes under ``"dots"``
    and fewer again under ``"nothing"``, the gradients bitwise equal), and
    no stacked leaf is read by ``select`` in the training graph;
  * ``adamw``'s in-place ``update_`` bitwise its functional ``update``;
  * an LM checkpoint read across packages both ways, bitwise;
  * ``launch.train`` on an LM against the reference's ``train_lm``, and its
    refusals.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import quant as JQ
from repro.launch import steps as JS
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.configs import base as cb
from repro_torch.core import quant as Q
from repro_torch.core import tree as T
from repro_torch.launch import steps as S
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import value_and_grad
from test_torch_lm_float import _t, both, f32, inputs, jax_to_numpy

# float32 gradients: the same calculus in another order (measured: 2.2e-6
# of a leaf's largest magnitude, 9.1e-6 for zamba2-7b)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# a bf16 model: gradients rounded to bf16 in both packages, from logits
# that differ by a bf16 ulp or two: 2 ulps of bf16 at the leaf's largest
BF16_GRAD_ULPS = 2.0 ** -7 * 2
# the train step's AdamW runs at eps = 1e-3 in these comparisons: with the
# default 1e-8 an entry whose gradient is below the float32 noise of the
# two packages (|g| < 1e-6) takes a step of +-lr whose sign is that noise;
# at 1e-3 the step is Lipschitz in the gradient (1/eps) and the comparison
# holds the accumulation, the division and the update, not Adam's
# conditioning
STEP_HP = dict(lr=1e-2, total_steps=10, warmup=1, eps=1e-3)
TRANSFORMER_ARCHS = [a for a in cb.ARCH_IDS
                     if cb.get_smoke_config(a).family not in ("ssm",
                                                              "hybrid",
                                                              "moe")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lm_batch(cfg, seed=0, batch=2, seq=16):
    """``inputs`` with next-token labels (tokens shifted left, -1 at the
    end), as ``SyntheticTokens`` makes them."""
    x = inputs(cfg, seed, batch, seq)
    x["labels"] = np.concatenate(
        [x["tokens"][:, 1:], -np.ones((batch, 1), np.int32)], axis=1)
    return x


def jax_grads(jcfg, jp, x):
    """The reference's ``((loss, metrics), grads)``, compiled."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))
    return fn(jp, {k: jnp.asarray(v) for k, v in x.items()})


def check_grads(arch, tol=GRAD_TOL, **over):
    """The port's loss and gradients against the reference's on the same
    weights and batch; returns the largest relative leaf error."""
    jcfg, cfg, jp, p = both(arch, **over)
    x = lm_batch(cfg)
    (jloss, jaux), jg = jax_grads(jcfg, jp, x)
    (loss, aux), g = value_and_grad(
        lambda q: M.loss_fn(q, cfg, {k: _t(v) for k, v in x.items()}), p)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * max(
        1.0, abs(float(jloss))), (float(loss), float(jloss))
    assert int(aux["tokens"]) == int(jaux["tokens"])
    want = dict(T.flatten_with_path(jax_to_numpy(jg)))
    got = dict(T.flatten_with_path(g))
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        assert got[k] is not None, f"{k}: no gradient"
        w = f32(w)
        scale = float(np.abs(w).max())
        assert scale > 0, k
        err = float(np.abs(f32(got[k]) - w).max()) / scale
        assert err <= tol, (k, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


def test_qat_gradients_match_reference():
    """``quant="qat"``: the fake-quantized matmuls' straight-through
    gradients."""
    check_grads("llama3.2-3b", quant="qat")


def test_bf16_gradients_match_reference():
    """gemma-2b with bf16 params and compute: the loss within 1e-2 (bf16
    logits) and each leaf within ``BF16_GRAD_ULPS`` of its largest."""
    jcfg, cfg, jp, p = both("gemma-2b", dtype="bfloat16",
                            param_dtype="bfloat16")
    x = lm_batch(cfg)
    (jloss, _), jg = jax_grads(jcfg, jp, x)
    (loss, _), g = value_and_grad(
        lambda q: M.loss_fn(q, cfg, {k: _t(v) for k, v in x.items()}), p)
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss))
    want = dict(T.flatten_with_path(jax_to_numpy(jg)))
    dtypes = {k: t.dtype for k, t in T.flatten_with_path(p)}
    assert torch.bfloat16 in dtypes.values()
    for k, t in T.flatten_with_path(g):
        assert t.dtype == dtypes[k], k
        w = f32(want[k])
        np.testing.assert_allclose(
            f32(t), w, rtol=0, atol=BF16_GRAD_ULPS * np.abs(w).max(),
            err_msg=k)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _moment_leaves(params, state):
    """The optimizer state's leaves in the reference's order (m, then v,
    each in sorted-path order), each ``BlockQuantized`` whole."""
    out = []
    for k in ("m", "v"):
        for path, _ in T.flatten_with_path(params):
            node = state[k]
            for key in path.split("/"):
                node = node[key]
            out.append(node)
    return out


def _quantized_close(got, want, tol, block=128):
    """int8 moments.  On every block whose values reach ``tol`` of the
    leaf's largest: the exponent equal, and the payload never more than
    one step off (a float32 moment within rounding of a quantization
    boundary lands on the other side; that happens to about one entry in
    a thousand, more in blocks of small values).  Everywhere: the dequantized values within one quantum of their block
    plus ``tol`` of the largest (a block of values far below that, from
    gradients at the float32 noise, may take another exponent)."""
    q, e = got.q.numpy(), got.exp.numpy()
    wq, we = np.asarray(want.q), np.asarray(want.exp)
    assert q.shape == wq.shape and e.shape == we.shape

    def per_entry(b):
        return np.repeat(b, block, axis=-1)[..., :q.shape[-1]]

    dq = Q.block_dequantize(got).numpy()
    wdq = np.asarray(JQ.block_dequantize(want))
    floor = tol * np.abs(wdq).max()
    big = 2.0 ** (we.astype(np.float64) + 7) >= floor   # block amax scale
    assert np.array_equal(e[big], we[big])
    entries = per_entry(big)
    assert np.abs(q.astype(int) - wq)[entries].max(initial=0) <= 1
    quantum = per_entry(2.0 ** np.maximum(e, we).astype(np.float64))
    assert np.all(np.abs(dq - wdq) <= quantum + floor)


def run_steps(arch, grad_accum, int8_state=False, steps=2, batch=4):
    """``steps`` AdamW steps of the port's and the reference's
    ``make_train_step`` from the same weights on the same batches; the
    port's params and moments against the reference's."""
    jcfg, cfg, jp, p = both(arch)
    hp = dict(STEP_HP, int8_state=int8_state)
    jo, po = jopt.adamw(**hp), opt_lib.adamw(**hp)
    jstep = jax.jit(JS.make_train_step(jcfg, jo, grad_accum=grad_accum))
    step = S.make_train_step(cfg, po, grad_accum=grad_accum)
    js, ps = jo.init(jp), po.init(p)
    for i in range(steps):
        x = lm_batch(cfg, seed=i, batch=batch)
        jp, js, jm = jstep(jp, js, i, {k: jnp.asarray(v)
                                       for k, v in x.items()})
        p, ps, m = step(p, ps, i, {k: _t(v) for k, v in x.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * max(
            1.0, abs(float(jm["loss"])))
    want = dict(T.flatten_with_path(jax_to_numpy(jp)))
    for k, t in T.flatten_with_path(p):
        w = f32(want[k])
        off = np.abs(f32(t) - w) > GRAD_TOL * np.abs(w).max()
        if int8_state:
            # where a moment landed a quantum apart (see _quantized_close),
            # that entry's step differs: at most 0.1% of a leaf, and there
            # by no more than a step of lr
            assert off.mean() <= 1e-3, k
            assert np.all(np.abs(f32(t) - w)[off] <= STEP_HP["lr"] * steps)
        else:
            assert not off.any(), (k, np.abs(f32(t) - w).max())
    is_q = lambda t: isinstance(t, JQ.BlockQuantized)  # noqa: E731
    ref = jax.tree_util.tree_leaves(js, is_leaf=is_q)
    got = _moment_leaves(p, ps)
    assert len(got) == len(ref)
    n_q = 0
    for a, b in zip(got, ref):
        assert is_q(b) == isinstance(a, Q.BlockQuantized)
        if is_q(b):
            _quantized_close(a, b, GRAD_TOL)
            n_q += 1
        else:
            w = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=GRAD_TOL * np.abs(w).max())
    assert (n_q > 0) == int8_state


STEP_CASES = [(1, False), (2, False), (2, True)]


@pytest.mark.parametrize("grad_accum,int8_state", STEP_CASES)
def test_train_step_matches_reference(grad_accum, int8_state):
    """llama3.2-3b (the MoE, SSM and hybrid in
    ``test_torch_lm_train_ssm.py``)."""
    run_steps("llama3.2-3b", grad_accum, int8_state)


def test_train_step_refuses_an_uneven_batch():
    cfg = cb.get_smoke_config("llama3.2-3b")
    p = M.init_params(cfg, 0, "cpu")
    opt = opt_lib.adamw()
    step = S.make_train_step(cfg, opt, grad_accum=3)
    x = {k: _t(v) for k, v in lm_batch(cfg, batch=4).items()}
    with pytest.raises(ValueError, match="grad_accum=3"):
        step(p, opt.init(p), 0, x)
    with pytest.raises(ValueError, match="update_"):
        S.make_train_step(cfg, opt_lib.sgdm())


def _grads_out(opt_cls=opt_lib.Optimizer):
    """An optimizer whose update returns the gradients it was handed as
    the new params: a train step built on it returns the step's
    accumulated gradient."""
    def update(g, s, p, i):
        return g, s
    if opt_cls is opt_lib.Optimizer:
        return opt_cls(init=lambda p: {}, update=update, update_=update)
    return opt_cls(init=lambda p: {}, update=update)


def test_bf16_accumulates_in_bf16_like_the_reference():
    """gemma-2b in bf16, ``grad_accum=2``: the microbatch gradients summed
    and halved in each parameter's dtype in both packages, within
    ``BF16_GRAD_ULPS`` of the leaf's largest; then AdamW on the same bf16
    params and gradients, the new params within one bf16 ulp of each
    value."""
    jcfg, cfg, jp, p = both("gemma-2b", dtype="bfloat16",
                            param_dtype="bfloat16")
    x = lm_batch(cfg, batch=4)
    jg, _, jm = jax.jit(JS.make_train_step(
        jcfg, _grads_out(jopt.Optimizer), grad_accum=2))(
        jp, {}, 0, {k: jnp.asarray(v) for k, v in x.items()})
    g, _, m = S.make_train_step(cfg, _grads_out(), grad_accum=2)(
        p, {}, 0, {k: _t(v) for k, v in x.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-2 * abs(
        float(jm["loss"]))
    want = dict(T.flatten_with_path(jax_to_numpy(jg)))
    dtypes = {k: t.dtype for k, t in T.flatten_with_path(p)}
    assert torch.bfloat16 in dtypes.values()
    for k, t in T.flatten_with_path(g):
        assert t.dtype == dtypes[k], k
        w = f32(want[k])
        np.testing.assert_allclose(f32(t), w, rtol=0,
                                   atol=BF16_GRAD_ULPS * np.abs(w).max(),
                                   err_msg=k)
    jo, po = jopt.adamw(**STEP_HP), opt_lib.adamw(**STEP_HP)
    g = M.params_from_numpy(jax_to_numpy(jg), cfg, "cpu")
    jp2, _ = jax.jit(jo.update)(jg, jo.init(jp), jp, 0)
    p2, _ = po.update(g, po.init(p), p, 0)
    want = dict(T.flatten_with_path(jax_to_numpy(jp2)))
    for k, t in T.flatten_with_path(p2):
        assert t.dtype == dtypes[k], k
        w = f32(want[k])
        ulp = np.where(w == 0, 0, 2.0 ** (np.floor(np.log2(
            np.abs(np.where(w == 0, 1, w)))) - 7))
        assert np.all(np.abs(f32(t) - w) <= ulp), k


def test_accumulated_gradient_is_the_mean_in_the_param_dtype():
    """Two microbatches' gradients, summed from a zero in the parameter's
    dtype and divided there, are what the step hands the optimizer."""
    cfg = cb.get_smoke_config("llama3.2-3b").with_(
        dtype="bfloat16", param_dtype="bfloat16")
    p = M.init_params(cfg, 0, "cpu")
    x = {k: _t(v) for k, v in lm_batch(cfg, batch=4).items()}
    seen = {}

    def update(grads, state, params, step):
        seen["g"] = grads
        return params, state

    opt = opt_lib.Optimizer(init=lambda p: {}, update=update,
                            update_=update)
    S.make_train_step(cfg, opt, grad_accum=2)(p, {}, 0, x)
    halves = [value_and_grad(lambda q: M.loss_fn(
        q, cfg, {k: v[i:i + 2] for k, v in x.items()}), p)[1]
        for i in (0, 2)]
    for k, g in T.flatten_with_path(seen["g"]):
        a, b = (dict(T.flatten_with_path(h))[k] for h in halves)
        want = ((torch.zeros_like(a) + a) + b) / 2
        assert g.dtype == a.dtype and torch.equal(g, want), k


# ---------------------------------------------------------------------------
# remat and the unbound stacks
# ---------------------------------------------------------------------------


def held_bytes(cfg, params, batch):
    """(bytes the forward leaves allocated for the backward, bytes that
    pass autograd's saved-tensor hooks, gradients).  The first counts the
    allocator's net bytes over the forward (every saved tensor, and the
    matmul outputs that selective checkpointing caches, which the hooks
    do not see); the second the tensors autograd packs outside a
    checkpointed region."""
    leaves = [x.detach().requires_grad_(True) for x in T.leaves(params)]
    packed = [0]

    def pack(t):
        packed[0] += t.numel() * t.element_size()
        return t

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = M.loss_fn(T.unflatten(params, leaves), cfg, batch)
    held = sum(e.self_cpu_memory_usage for e in prof.key_averages())
    return held, packed[0], torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_remat_keeps_fewer_bytes_and_changes_no_gradient(arch):
    """Autograd keeps strictly fewer bytes under ``remat_policy="dots"``
    than without remat, and fewer again under ``"nothing"``; the saved
    tensor hooks see fewer under either; the gradients are bitwise equal
    across the three."""
    cfg = cb.get_smoke_config(arch)
    p = M.init_params(cfg, 0, "cpu")
    x = {k: _t(v) for k, v in lm_batch(cfg).items()}
    runs = [held_bytes(cfg.with_(remat=r, remat_policy=pol), p, x)
            for r, pol in ((False, "dots"), (True, "dots"),
                           (True, "nothing"))]
    (none, none_hooks, g0), (dots, dots_hooks, g1), (nothing, _, g2) = runs
    assert none > dots > nothing > 0, (none, dots, nothing)
    assert none_hooks > dots_hooks
    for a, b, c in zip(g0, g1, g2):
        assert torch.equal(a, b) and torch.equal(a, c)


def _graph_ops(loss):
    """Every autograd node reachable from ``loss`` (name, node)."""
    seen, todo, out = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        out.append(node)
        todo += [n for n, _ in node.next_functions]
    return out


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_no_stacked_leaf_is_read_by_select(arch):
    """Without remat (the graph is then whole), no ``SelectBackward0`` node
    has a stacked parameter leaf as its input: the layers and the experts
    are unbound, once per leaf and forward."""
    cfg = cb.get_smoke_config(arch).with_(remat=False)
    p = M.init_params(cfg, 0, "cpu")
    leaves = [x.detach().requires_grad_(True) for x in T.leaves(p)]
    x = {k: _t(v) for k, v in lm_batch(cfg).items()}
    loss, _ = M.loss_fn(T.unflatten(p, leaves), cfg, x)
    leaf_ids = {id(t) for t in leaves}
    nodes = _graph_ops(loss)
    for node in nodes:
        if type(node).__name__ != "SelectBackward0":
            continue
        for nxt, _ in node.next_functions:
            assert not (type(nxt).__name__ == "AccumulateGrad"
                        and id(nxt.variable) in leaf_ids), arch
    unbinds = [n for n in nodes if type(n).__name__ == "UnbindBackward0"]
    assert unbinds


# ---------------------------------------------------------------------------
# the donated update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8_state", [False, True])
def test_inplace_update_is_the_functional_update_bitwise(int8_state,
                                                         monkeypatch):
    """``update_`` writes what ``update`` returns into the params' and
    moments' own storage, bitwise, also when a leaf is cut into several
    chunks of rows (``CHUNK_ELEMENTS`` lowered to a few rows) and for
    leaves without a gradient."""
    monkeypatch.setattr(opt_lib, "CHUNK_ELEMENTS", 200)
    cfg = cb.get_smoke_config("mixtral-8x22b")
    p = M.init_params(cfg, 0, "cpu")
    x = {k: _t(v) for k, v in lm_batch(cfg).items()}
    _, g = value_and_grad(lambda q: M.loss_fn(q, cfg, x), p)
    g["final_norm"] = T.tree_map(lambda t: None, g["final_norm"])
    opt = opt_lib.adamw(lr=1e-2, warmup=1, int8_state=int8_state,
                        state_block=32)

    def zero_moment(leaf, m):
        """The init, a row repeated, equals quantizing float32 zeros."""
        z = torch.zeros(leaf.shape)
        if int8_state and leaf.numel() >= 32:
            want = Q.block_quantize(z, block=32)
            assert torch.equal(m.q, want.q) and torch.equal(m.exp, want.exp)
        else:
            assert torch.equal(m, z)

    T.tree_map(zero_moment, p, opt.init(p)["m"])
    fp, fs = T.tree_map(torch.clone, p), opt.init(p)
    ip, is_ = T.tree_map(torch.clone, p), opt.init(p)
    storage = [t.data_ptr() for t in T.leaves((ip, is_))]
    for step in range(2):
        fp, fs = opt.update(g, fs, fp, step)
        ip2, is2 = opt.update_(g, is_, ip, step)
        assert ip2 is ip and is2 is is_
    assert [t.data_ptr() for t in T.leaves((ip, is_))] == storage
    for a, b in zip(T.leaves((fp, fs)), T.leaves((ip, is_))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_step_is_donated():
    """The step leaves the new values in the storage of the trees it was
    given, equal bitwise to the functional ``update`` on the step's
    accumulated gradient."""
    cfg = cb.get_smoke_config("llama3.2-3b")
    p = M.init_params(cfg, 0, "cpu")
    opt = opt_lib.adamw(lr=1e-2, warmup=1)
    x = {k: _t(v) for k, v in lm_batch(cfg, batch=4).items()}
    g, _, _ = S.make_train_step(cfg, _grads_out(), grad_accum=2)(p, {}, 0,
                                                                 x)
    fp, fs = opt.update(g, opt.init(p), p, 0)
    dp, ds = T.tree_map(torch.clone, p), opt.init(p)
    storage = [t.data_ptr() for t in T.leaves((dp, ds))]
    rp, rs, _ = S.make_train_step(cfg, opt, grad_accum=2)(dp, ds, 0, x)
    assert rp is dp and rs is ds
    assert [t.data_ptr() for t in T.leaves((dp, ds))] == storage
    for a, b in zip(T.leaves((fp, fs)), T.leaves((dp, ds))):
        assert torch.equal(a, b)


def test_default_optimizer_matches_reference():
    """int8 moments past 5e10 parameters, as the reference decides."""
    from repro.configs import base as jcb
    for arch in cb.ARCH_IDS:
        big = M.param_count(cb.get_config(arch)) > 5e10
        opt = S.default_optimizer(cb.get_config(arch))
        jo = JS.default_optimizer(jcb.get_config(arch))
        z = opt.init({"w": torch.zeros(4, 256)})["m"]["w"]
        jz = jo.init({"w": jnp.zeros((4, 256))})["m"]["w"]
        assert isinstance(z, Q.BlockQuantized) == big == isinstance(
            jz, JQ.BlockQuantized), arch
    assert S.default_optimizer(cb.get_config("deepseek-v3-671b")).init(
        {"w": torch.zeros(4, 256)})["m"]["w"].q.dtype == torch.int8


# ---------------------------------------------------------------------------
# checkpoints, the loop and the CLI
# ---------------------------------------------------------------------------


def _lm_state(int8_state=True):
    cfg = cb.get_smoke_config("llama3.2-3b")
    p = M.init_params(cfg, 0, "cpu")
    opt = opt_lib.adamw(lr=1e-2, warmup=1, int8_state=int8_state)
    x = {k: _t(v) for k, v in lm_batch(cfg, batch=4).items()}
    p, s, _ = S.make_train_step(cfg, opt, grad_accum=2)(p, opt.init(p), 0,
                                                       x)
    return cfg, p, s


def test_lm_checkpoint_cross_reads_bitwise(tmp_path):
    """An LM's (params, AdamW int8 state) written by the port restores in
    ``repro.train.checkpoint`` bitwise, and the reference's in the port."""
    cfg, p, s = _lm_state()
    ck.save(str(tmp_path / "port"), 4, (p, s), extra=dict(pipeline=dict(
        seed=0, step=5)))
    jp = jax.tree_util.tree_map(jnp.asarray, T.tree_map(
        lambda t: t.numpy(), p))
    jo = jopt.adamw(int8_state=True)
    target = (jax.tree_util.tree_map(jnp.zeros_like, jp), jo.init(jp))
    (rp, rs), step, extra = jck.restore(str(tmp_path / "port"), target)
    assert step == 4 and extra == dict(pipeline=dict(seed=0, step=5))
    is_q = lambda t: isinstance(t, JQ.BlockQuantized)  # noqa: E731
    assert any(is_q(t) for t in jax.tree_util.tree_leaves(rs, is_leaf=is_q))
    ours = T.leaves((p, s))
    theirs = jax.tree_util.tree_leaves((rp, rs))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jck.save(str(tmp_path / "jax"), 9, (rp, rs))
    opt = opt_lib.adamw(int8_state=True)
    fresh = M.init_params(cfg, 1, "cpu")
    (bp, bs), step, _ = ck.restore(str(tmp_path / "jax"),
                                   (fresh, opt.init(fresh)))
    assert step == 9
    for a, b in zip(T.leaves((bp, bs)), ours):
        assert torch.equal(a, b)


def _args(**kw):
    base = dict(arch="llama3.2-3b", steps=3, batch=4, seq=16, lr=1e-3,
                seed=0, smoke=True, grad_accum=2, int8_opt=False,
                ckpt_dir=None, ckpt_every=50, watchdog_s=0.0, mesh_data=1,
                mesh_model=1, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_train_lm_matches_the_reference_train_lm(monkeypatch, capsys):
    """``main([... "--arch", "llama3.2-3b", "--smoke", ...])`` against the
    reference's ``train_lm`` with the same arguments, both starting from
    the reference's weights (each package draws its own from a seed, so
    the port's ``init_params`` is handed the reference's through the
    bridge): the final loss within 1e-4."""
    jcfg, cfg, jp, p = both("llama3.2-3b")
    monkeypatch.setattr(jtrain.M, "init_params", lambda c, k: jp)
    jtrain.train_lm(_args())
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final:")][-1]
    calls = []

    def port_init(c, seed, device):
        calls.append((c.name, seed, str(device)))
        return p

    monkeypatch.setattr(launch_train.M, "init_params", port_init)
    params, opt_state, metrics = launch_train.main(
        ["--arch", "llama3.2-3b", "--smoke", "--steps", "3", "--batch", "4",
         "--seq", "16", "--grad-accum", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert calls == [(cfg.name, 0, "cpu")] and "final:" in out
    jloss = float(jline.split("'loss': ")[1].split(",")[0])
    assert abs(float(metrics["loss"]) - jloss) <= 1e-4 * jloss
    assert params is p      # updated in place (the donated step)


def test_train_lm_resumes_bitwise(tmp_path):
    """The LM analogue of ``tests/test_substrate.py``'s resume case: 4
    steps straight against 2 steps, a checkpoint and a resume to 4, with
    int8 moments and ``grad_accum=2``: params and moments bitwise."""
    quiet = dict(log=lambda *a: None)
    a = launch_train.train_lm(_args(steps=4, int8_opt=True),
                              **quiet)
    d = str(tmp_path)
    launch_train.train_lm(_args(steps=2, int8_opt=True, ckpt_dir=d), **quiet)
    logs = []
    b = launch_train.train_lm(_args(steps=4, int8_opt=True, ckpt_dir=d), log=logs.append)
    assert "[resume] restored step 1" in logs
    for x, y in zip(T.leaves(a[:2]), T.leaves(b[:2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch,missing", [("whisper-large-v3", "frames"),
                                          ("internvl2-1b", "patches")])
def test_train_lm_refuses_what_synthetic_tokens_cannot_feed(arch, missing):
    with pytest.raises(SystemExit, match=missing):
        launch_train.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_train_lm_refuses_a_mesh_and_needs_a_gpu(monkeypatch):
    """A mesh needs a world of its size (one process a rank, under
    ``torchrun``): a single process refuses it, naming the command."""
    for flag in ("--mesh-data", "--mesh-model"):
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
            launch_train.main(["--arch", "gemma-2b", "--smoke", flag, "2",
                               "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])


def test_lr_defaults_per_arch(monkeypatch):
    """0.05 for the ResNets, 1e-3 for the LMs, as the reference's main."""
    seen = {}
    monkeypatch.setattr(launch_train, "train_resnet",
                        lambda a: seen.setdefault("resnet", a.lr))
    monkeypatch.setattr(launch_train, "train_lm",
                        lambda a: seen.setdefault("lm", a.lr))
    launch_train.main(["--arch", "resnet8"])
    launch_train.main(["--arch", "gemma-2b"])
    assert seen == {"resnet": 0.05, "lm": 1e-3}
