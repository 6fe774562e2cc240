"""The port's parallel layer (``repro_torch.parallel``, ``launch.mesh``,
``CompiledModel.run_sharded``) against the JAX package on the CPU.

  * the placement rules leaf by leaf: ``param_spec`` of every parameter
    of the ten published configs and of their AdamW state (float moments,
    int8 ones where ``default_optimizer`` picks them), and
    ``input_sharding_factory`` of every input of the ten configs over the
    four shapes, equal to the reference's on JAX ``AbstractMesh``es of
    shapes (16, 16), (2, 16, 16), (2, 4), (4,) and (4, 1);
  * the reference's own cases of ``tests/test_parallel.py`` (divisibility,
    reduced mesh, the (4, 1) fallback to ``P(None, "data")``, the input
    rules);
  * ``partition_stages`` / ``bubble_fraction`` equal to the reference's;
  * one spawned world of 4 gloo ranks (``_torch_worlds.parallel_world``):
    stacked placements data-major, the mesh constructor's refusal,
    ``ctx.constrain`` and ``ctx.sharded_take`` (values and gradient),
    ``collective_matmul`` and ``pipeline_step`` against the reference's on
    4 forced host devices (a subprocess) and the plain product/loop,
    ``compressed_psum_grads`` bitwise against the reference's arithmetic
    composed from the JAX package's ``block_quantize`` per rank, and
    ``run_sharded`` (ResNet8, ``torch-int``) bitwise against the
    single-device logits and the JAX package's ``lax-int``, its refusals
    and its compile counts.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from test_torch_slice import images, jax_params, np_qparams

from _torch_dist import run_world, value
from _torch_worlds import parallel_world
from repro.compile import compile_model as jax_compile_model
from repro.configs import base as jcb
from repro.core import dataflow as jdataflow
from repro.core import quant as JQ
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models import resnet as JR
from repro.parallel import pp as jpp
from repro.parallel import sharding as jshd
from repro_torch.compile import params_from_numpy
from repro_torch.configs import base as cb
from repro_torch.core import dataflow
from repro_torch.core import tree as T
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.parallel import pp
from repro_torch.parallel import sharding as shd

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4": ((4,), ("data",)),
          "4x1": ((4, 1), ("data", "model"))}


def meshes(name):
    """(the JAX AbstractMesh, the port's axis-size mapping) of a shape."""
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), dict(zip(names, sizes))


# ---------------------------------------------------------------------------
# placement rules, leaf by leaf, at production size
# ---------------------------------------------------------------------------


def _jax_state_shapes(jcfg, p_shapes):
    opt = JS.default_optimizer(jcfg)
    return jax.eval_shape(opt.init, p_shapes)


_SHAPES = {}


def trees(arch):
    """(JAX params + state shapes, the port's) of the published config."""
    if arch not in _SHAPES:
        jcfg, cfg = jcb.get_config(arch), cb.get_config(arch)
        jp = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
        p = M.param_shapes(cfg)
        _SHAPES[arch] = ((jp, _jax_state_shapes(jcfg, jp)),
                         (p, S.default_optimizer(cfg).init(p)))
    return _SHAPES[arch]


def _jax_specs(tree, mesh):
    is_q = lambda t: isinstance(t, JQ.BlockQuantized)  # noqa: E731
    sh = jshd.params_shardings(tree, mesh)
    leaves = jax.tree_util.tree_flatten_with_path(sh)[0]
    return {jshd._path_str(p): tuple(s.spec) for p, s in leaves}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    (jp, js), (p, st) = trees(arch)
    jmesh, pmesh = meshes(mesh)
    for jtree, tree in ((jp, p), (js, st)):
        want = _jax_specs(jtree, jmesh)
        got = {k: tuple(s.spec) for k, s in
               T.flatten_with_path(shd.params_shardings(tree, pmesh))}
        assert got.keys() == want.keys()
        for k in want:
            # JAX's spec drops trailing Nones nowhere here: both name every
            # dim of the leaf
            assert got[k] == want[k], (k, got[k], want[k])


def test_int8_state_is_in_the_cases():
    """``default_optimizer`` picks int8 moments for the three huge archs,
    so the state leaves above include their ``q`` / ``exp`` pairs."""
    big = [a for a in cb.ARCH_IDS if M.param_count(cb.get_config(a)) > 5e10]
    assert sorted(big) == ["deepseek-v3-671b", "mixtral-8x22b",
                           "nemotron-4-340b"]
    for arch in big:
        paths = [k for k, _ in T.flatten_with_path(trees(arch)[1][1])]
        assert any(k.endswith("/0") for k in paths) and \
            any(k.endswith("/1") for k in paths)


class _Box:
    """A spec as one leaf of the inputs' tree."""

    def __init__(self, spec):
        self.spec = spec


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    jcfg, cfg = jcb.get_config(arch), cb.get_config(arch)
    for mesh in MESHES:
        jmesh, pmesh = meshes(mesh)
        jf, pf = jshd.input_sharding_factory(jmesh), \
            shd.input_sharding_factory(pmesh)
        for shape in cb.SHAPES:
            want = jcb.input_specs(jcfg, jcb.SHAPES[shape],
                                   lambda s, a: jf(s, a))
            got = cb.input_specs(cfg, cb.SHAPES[shape],
                                 lambda s, dt, a: _Box(pf(s, a)))
            wl = {jshd._path_str(k): tuple(v.sharding.spec) for k, v in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
            gl = {k: tuple(v.spec) for k, v in T.flatten_with_path(got)}
            assert gl == wl, (mesh, shape)


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_parallel.py), on the port
# ---------------------------------------------------------------------------

TREE = dict(embed=torch.empty((4096, 512), device="meta"),
            blocks=dict(w=torch.empty((8, 1024, 512), device="meta")),
            norm=dict(scale=torch.empty((64,), device="meta")))


def test_params_shardings_divisibility():
    sh = shd.params_shardings(TREE, {"data": 2, "model": 4})
    assert "model" in sh["embed"].spec
    assert "data" in sh["blocks"]["w"].spec and \
        "model" in sh["blocks"]["w"].spec
    assert sh["norm"]["scale"].spec == shd.P(None)     # replicated


def test_params_shardings_degrade_gracefully_on_reduced_mesh():
    mesh = {"data": 4}
    specs = [s.spec for s in T.leaves(shd.params_shardings(TREE, mesh))]
    assert not any("model" in str(s) for s in specs), specs
    rep = shd.replicated_shardings(TREE, mesh)
    assert all(s.spec == shd.P() for s in T.leaves(rep))
    assert shd.input_sharding_factory(mesh)((8, 128), ("batch", "heads")) \
        == shd.P("data", None)
    spec2 = shd.param_spec("blocks/w", (1023, 512), {"data": 4, "model": 1})
    assert spec2 == shd.P(None, "data"), spec2


def test_input_sharding_factory_rules():
    f = shd.input_sharding_factory({"pod": 2, "data": 2, "model": 2})
    assert f((8, 128), ("batch", "seq")) == shd.P(("pod", "data"), None)
    assert f((1, 128), ("batch", "seq")) == shd.P(None, ("pod", "data"))
    assert f((8, 6, 4), ("batch", "heads", "embed")) == \
        shd.P(("pod", "data"), "model", "model")


class _Names:
    def __init__(self, names):
        self.mesh_dim_names = names


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = _Names(("pod", "data", "model"))
    assert shd.spec_to_placements(shd.P(None, ("data", "model")), m) == \
        (Replicate(), Shard(1), Shard(1))
    assert shd.spec_to_placements(shd.P(("pod", "data"), "model"), m) == \
        (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        shd.spec_to_placements(shd.P(("model", "data")), m)


# ---------------------------------------------------------------------------
# stage partitioner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_partition_stages_equal_reference(seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.1, 5.0, int(rng.integers(4, 20))).tolist()
    for n_stages in range(1, min(6, len(costs)) + 1):
        assert pp.partition_stages(costs, n_stages) == \
            jpp.partition_stages(costs, n_stages)
    for n_micro in (1, 4, 8):
        assert pp.bubble_fraction(n_micro, 4) == \
            jpp.bubble_fraction(n_micro, 4)


def test_partition_stages_on_resnet20_layers():
    costs = [layer.c for layer in dataflow.resnet20_layers()]
    jcosts = [layer.c for layer in jdataflow.resnet20_layers()]
    assert costs == jcosts
    for n in (2, 3, 4, 5):
        assert pp.partition_stages(costs, n) == \
            jpp.partition_stages(jcosts, n)


# ---------------------------------------------------------------------------
# one spawned world of 4 gloo ranks
# ---------------------------------------------------------------------------


def run_sub(code: str, devices: int) -> str:
    """The JAX package on ``devices`` forced host devices, in a fresh
    process (as tests/test_parallel.py runs it)."""
    prog = ("import os\n"
            f"os.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n"
            + textwrap.dedent(code))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _inputs():
    rng = np.random.default_rng(0)
    qp = np_qparams(JR.RESNET8, seed=7)
    inp = dict(
        emb=rng.standard_normal((16, 8)).astype(np.float32),
        tok=rng.integers(0, 16, (4, 5)).astype(np.int64),
        cm_x=rng.standard_normal((8, 16)).astype(np.float32),
        cm_w=rng.standard_normal((16, 12)).astype(np.float32),
        even_g=rng.standard_normal((4, 8, 256)).astype(np.float32),
        even_e=np.zeros((4, 8, 256), np.float32), even_block=128,
        ragged_g=(rng.standard_normal((4, 3, 300)) *
                  np.array([1e-3, 1.0, 40.0])[None, :, None]
                  ).astype(np.float32),
        ragged_e=(1e-3 * rng.standard_normal((4, 3, 300))
                  ).astype(np.float32), ragged_block=256,
        qp8=params_from_numpy(qp), imgs=images(8, seed=1))
    return inp, qp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp, qp = _inputs()
    res = run_world(parallel_world, 4, tmp_path_factory.mktemp("w"), inp)
    return res, inp, qp


@pytest.fixture(scope="module")
def jax_multi():
    """The reference's collective_matmul and pipeline_step on 4 forced
    host devices."""
    inp, _ = _inputs()
    code = f"""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.parallel.collectives import collective_matmul
        from repro.parallel import pp
        x = jnp.asarray(np.array({inp['cm_x'].tolist()}, np.float32))
        w = jnp.asarray(np.array({inp['cm_w'].tolist()}, np.float32))
        y = collective_matmul(x, w, jax.make_mesh((4,), ("model",)), "model")
        ws = [0.5, 1.5, -2.0, 3.0]
        f = pp.pipeline_step(lambda i, v: v * jnp.asarray(ws)[i] + 1.0,
                             jax.make_mesh((4,), ("stage",)), "stage",
                             n_micro=6)
        z = f(jnp.arange(18, dtype=jnp.float32).reshape(6, 3))
        print(json.dumps(dict(cm=np.asarray(y).tolist(),
                              pp=np.asarray(z).tolist())))
    """
    return json.loads(run_sub(code, 4).strip().splitlines()[-1])


def test_stacked_axes_shard_data_major(world):
    v = value(world[0], "stacked_placements")
    assert v["placements"] == (("Shard", 0), ("Shard", 0))
    assert v["whole"]
    full = np.arange(96, dtype=np.float32).reshape(8, 12)
    for r, b in enumerate(v["blocks"]):          # rank = 2 data + model
        np.testing.assert_array_equal(np.array(b), full[2 * r:2 * r + 2])


def test_make_local_mesh_refuses_another_world_size(world):
    msg = value(world[0], "local_mesh_refuses")
    assert msg is not None and "world size 2" in msg and "world size 4" in msg


def test_constrain(world):
    v = value(world[0], "constrain")
    assert v["a"] == (("Shard", 0), ("Shard", 1)) and v["a_whole"]
    assert v["b"] == (("Replicate",), ("Replicate",))   # 3 rows: dropped
    assert v["plain_is_identity"] and v["no_mesh_is_identity"]


def test_sharded_take_values_and_gradient(world):
    v = value(world[0], "sharded_take")
    inp = world[1]
    emb, tok = inp["emb"], inp["tok"]
    assert v["axes"] == ("data",)
    # ranks (d, m): rows of data shard d, gathered over 'model'
    want = emb[tok]
    got = v["rows"].reshape(2, 2, 2, 5, 8)
    for d in range(2):
        for m in range(2):
            np.testing.assert_array_equal(got[d, m], want[2 * d:2 * d + 2])
    w = np.arange(1, 9, dtype=np.float32)
    assert abs(v["loss"] - float((want * w).sum())) <= 1e-4 * abs(v["loss"])
    g = np.zeros_like(emb)
    np.add.at(g, tok, np.broadcast_to(w, tok.shape + (8,)))
    np.testing.assert_allclose(v["grad"], g, rtol=0, atol=1e-6)
    assert v["grad_placements"] == (("Replicate",), ("Shard", 1))


def test_collective_matmul_against_reference_and_dense(world, jax_multi):
    v = value(world[0], "collective_matmul")
    inp = world[1]
    dense = inp["cm_x"] @ inp["cm_w"]
    np.testing.assert_allclose(v["y"], np.array(jax_multi["cm"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v["y"], dense, rtol=1e-5, atol=1e-5)
    assert v["placements"] == (("Shard", 0),)


def test_pipeline_step_against_reference_and_serial(world, jax_multi):
    y = value(world[0], "pipeline_step")
    ref = np.arange(18, dtype=np.float32).reshape(6, 3)
    for w in (0.5, 1.5, -2.0, 3.0):
        ref = ref * w + 1.0
    np.testing.assert_allclose(y, np.array(jax_multi["pp"]), rtol=1e-6)
    np.testing.assert_allclose(y, ref, rtol=1e-6)


def _compressed_reference(G, E, block):
    """The reference's compressed_psum_grads composed in numpy from the JAX
    package's block codec, rank by rank: (reduced, new errors)."""
    gcs = [g.astype(np.float32) + e for g, e in zip(G, E)]
    bqs = [JQ.block_quantize(jnp.asarray(gc), block=block) for gc in gcs]
    errs = [gc - np.asarray(JQ.block_dequantize(bq, block=block))
            for gc, bq in zip(gcs, bqs)]
    exps = [np.asarray(bq.exp).astype(np.int32) for bq in bqs]
    emax = np.max(exps, axis=0)
    last = G.shape[-1]
    per = int(np.ceil(last / emax.shape[-1]))

    def rep(a):
        return np.repeat(a, per, axis=-1)[..., :last]

    s = sum(np.asarray(bq.q).astype(np.int32) >> rep(emax - e)
            for bq, e in zip(bqs, exps))
    out = s.astype(np.float32) * np.exp2(rep(emax.astype(np.float32)))
    return out, errs


@pytest.mark.parametrize("case", ["even", "ragged"])
def test_compressed_psum_grads_bitwise(world, case):
    """Bitwise the reference's arithmetic in the reduced gradient and each
    rank's new error; within the reference test's 5% of the exact sum."""
    v = value(world[0], f"compressed_{case}")
    inp = world[1]
    G, E = inp[f"{case}_g"], inp[f"{case}_e"]
    out, errs = _compressed_reference(G, E, inp[f"{case}_block"])
    for r in range(4):
        np.testing.assert_array_equal(v["out"][r], out)
        np.testing.assert_array_equal(v["err"][r], errs[r])
    if case == "even":
        # the reference test's bound; with a last dim that is not a whole
        # number of blocks, the reference's shift map (``_rep``: ceil(last
        # / n_blocks) entries an exponent) does not follow the blocks, and
        # the port keeps that arithmetic
        exact = (G + E).sum(0)
        rel = np.abs(v["out"][0] - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel
    assert max(np.abs(e).max() for e in v["err"]) > 0   # error feedback
    assert v["zero"] == 0.0


def test_run_sharded_bitwise(world):
    v = value(world[0], "run_sharded")
    _, inp, qp = world
    np.testing.assert_array_equal(v["full"], v["ref"])
    np.testing.assert_array_equal(v["five"], v["ref"][:5])
    np.testing.assert_array_equal(v["m22"], v["ref"])
    assert v["five_shape"] == (5, 10)
    assert v["placements"] == (("Shard", 0),) and v["local_rows"] == 2
    # and so the JAX package's lax-int logits
    jcm = jax_compile_model(JR.RESNET8, jax_params(qp), backend="lax-int",
                            batch_sizes=(8,))
    np.testing.assert_array_equal(v["full"], np.asarray(jcm(inp["imgs"])))


def test_run_sharded_traced(world):
    """A sharded bucket run under an obs session records its ``call``
    span (bucket, backend) and returns the same logits."""
    v = value(world[0], "run_sharded_traced")
    np.testing.assert_array_equal(v["five"],
                                  value(world[0], "run_sharded")["ref"][:5])
    assert v["spans"] == [("call", dict(call=1, bucket=8,
                                        backend="torch-int"))]


def test_run_sharded_compile_counts(world):
    """The reference's cache keys: one lowering per (axis, devices), one
    executable per (bucket, axis, mesh shape, devices), each counted."""
    v = value(world[0], "run_sharded")
    assert v["first"] == dict(execs=1, lowered=1, compile_count=2)
    assert v["after"] == dict(execs=2, lowered=1, compile_count=3)
    assert v["keys"] == [(8, "data", (("data", 2), ("model", 2))),
                         (8, "data", (("data", 4),))]


def test_run_sharded_refusals(world):
    bucket, divide, none = value(world[0], "run_sharded_errors")
    assert "not a compiled bucket" in bucket
    assert "must be divisible by mesh axis 'data' (size 4)" in divide
    assert "no compiled bucket in (6,) divides over mesh axis 'data'" in none
