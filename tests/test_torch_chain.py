"""The block chain in the port: ``block_chain_op``'s plain version against
the JAX package's ``block_chain_op`` (interpret mode on the CPU) and its
pure-jnp oracle, bitwise; the wrapper's argument checks; ``KernelConfig``,
the chain byte model and the chain planner against the reference; and the
port's own shared-memory budget.  The CUDA kernel itself is held in
tests/test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import live_chain

from repro.compile import lowering as JL
from repro.core import dataflow as jdf
from repro.kernels.megakernel.megakernel import \
    ChainBlockSpec as JChainBlockSpec
from repro.kernels.megakernel.ops import block_chain_op as jax_block_chain_op
from repro.kernels.megakernel.ref import block_chain_ref as jax_chain_ref
from repro.kernels.resblock_fused.ops import \
    resblock_fused_op as jax_resblock_fused_op
from repro.models import resnet as JR
from repro.tune.config import KernelConfig as JKernelConfig
from repro_torch.compile import lowering as L
from repro_torch.core import dataflow as df
from repro_torch.kernels.megakernel.ops import ChainBlockSpec, block_chain_op
from repro_torch.models import resnet as R
from repro_torch.tune import space
from repro_torch.tune.config import KernelConfig, largest_divisor_leq

# the chains of tests/test_kernels.py: links of (cin, cout, stride)
CHAINS = [
    [(8, 8, 1)],                                   # singleton
    [(8, 8, 1), (8, 8, 1)],                        # identity pair
    [(8, 8, 1), (8, 16, 2), (16, 16, 1)],          # stride-2 mid-chain
    [(4, 8, 2), (8, 16, 2)],                       # stride-2 chain head
]


def _chain_np(rng, links, skip_shifts=None):
    """numpy operands and (shift0, shift1, skip_shift, stride, has_ds) per
    link; skip shifts cycle 1, 0, -1 as in the reference's tests."""
    blocks, sched = [], []
    for i, (cin, cout, stride) in enumerate(links):
        has_ds = stride != 1 or cin != cout
        ws = [rng.integers(-128, 128, (3, 3, cin, cout)).astype(np.int8),
              rng.integers(-500, 500, cout).astype(np.int32),
              rng.integers(-128, 128, (3, 3, cout, cout)).astype(np.int8),
              rng.integers(-500, 500, cout).astype(np.int32)]
        if has_ds:
            ws += [rng.integers(-128, 128, (1, 1, cin, cout)).astype(np.int8),
                   rng.integers(-500, 500, cout).astype(np.int32)]
        blocks.append(ws)
        skip = skip_shifts[i] if skip_shifts else 1 - i % 3
        sched.append(dict(stride=stride, has_ds=has_ds, shift0=8, shift1=8,
                          skip_shift=skip))
    return blocks, sched


def _port(blocks, sched):
    return (tuple(tuple(torch.from_numpy(w) for w in ws) for ws in blocks),
            tuple(ChainBlockSpec(**s) for s in sched))


def _jax(blocks, sched):
    return (tuple(tuple(jnp.asarray(w) for w in ws) for ws in blocks),
            tuple(JChainBlockSpec(**s) for s in sched))


def _u8(rng, *shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


# ---- (a) the plain version against the JAX kernel, bitwise --------------

@pytest.mark.parametrize("links", CHAINS, ids=lambda l: f"{len(l)}links")
@pytest.mark.parametrize("n,bt", [(1, 1), (4, 2)])
def test_block_chain_plain_matches_jax_kernel(links, n, bt):
    rng = np.random.default_rng(len(links) * 7 + n)
    x = _u8(rng, n, 16, 16, links[0][0])
    blocks, sched = _chain_np(rng, links)
    pb, ps = _port(blocks, sched)
    before = block_chain_op.launches
    got = block_chain_op(torch.from_numpy(x), pb, specs=ps,
                         config=KernelConfig(batch_tile=bt))
    jb, js = _jax(blocks, sched)
    ref = jax_block_chain_op(jnp.asarray(x), jb, specs=js,
                             config=JKernelConfig(batch_tile=bt))
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert block_chain_op.launches == before   # CPU: plain version
    assert 0 < got.numpy().mean() < 255


def test_block_chain_fused_stem_matches_jax_kernel():
    rng = np.random.default_rng(17)
    x = _u8(rng, 2, 16, 16, 3)
    sw = rng.integers(-128, 128, (3, 3, 3, 8)).astype(np.int8)
    sb = rng.integers(-500, 500, 8).astype(np.int32)
    blocks, sched = _chain_np(rng, [(8, 8, 1), (8, 16, 2)])
    pb, ps = _port(blocks, sched)
    got = block_chain_op(torch.from_numpy(x), pb, specs=ps,
                         stem=(torch.from_numpy(sw), torch.from_numpy(sb)),
                         stem_shift=7, config=KernelConfig(batch_tile=2))
    jb, js = _jax(blocks, sched)
    ref = jax_block_chain_op(jnp.asarray(x), jb, specs=js,
                             stem=(jnp.asarray(sw), jnp.asarray(sb)),
                             stem_shift=7, config=JKernelConfig(batch_tile=2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_block_chain_equals_jax_per_block_kernels():
    """The chain equals running the same links through the JAX
    ``resblock_fused`` kernel one by one."""
    rng = np.random.default_rng(23)
    x = _u8(rng, 3, 8, 8, 8)
    blocks, sched = _chain_np(rng, [(8, 8, 1), (8, 16, 2), (16, 16, 1)])
    pb, ps = _port(blocks, sched)
    got = block_chain_op(torch.from_numpy(x), pb, specs=ps)
    h = jnp.asarray(x)
    for ws, s in zip(blocks, sched):
        wd, bd = (ws[4], ws[5]) if s["has_ds"] else (None, None)
        h = jax_resblock_fused_op(
            h, *map(jnp.asarray, ws[:4]),
            None if wd is None else jnp.asarray(wd),
            None if bd is None else jnp.asarray(bd), stride=s["stride"],
            shift0=s["shift0"], shift1=s["shift1"],
            skip_shift=s["skip_shift"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(h))


@pytest.mark.parametrize("bps", [1, 3], ids=["resnet8", "resnet20"])
def test_block_chain_plain_matches_jax_oracle_at_resnet_widths(bps):
    """The whole network's chain with the stem fused, at full width, with
    int16 biases and skip shifts of every sign, against the reference's
    pure-jnp oracle."""
    x, blocks, specs, stem, stem_shift = live_chain(
        np.random.default_rng(bps), "cpu", df.resnet_block_shapes(bps), 2,
        stem_och=16)
    blocks = tuple(tuple(w.to(torch.int16) if w.dtype == torch.int32 else w
                         for w in ws) for ws in blocks)
    stem = (stem[0], stem[1].to(torch.int16))
    got = block_chain_op(x, blocks, specs=specs, stem=stem,
                         stem_shift=stem_shift).numpy()
    ref = jax_chain_ref(
        jnp.asarray(x.numpy()),
        tuple(tuple(jnp.asarray(w.numpy()) for w in ws) for ws in blocks),
        specs=tuple(JChainBlockSpec(**dataclasses.asdict(s)) for s in specs),
        stem=tuple(jnp.asarray(t.numpy()) for t in stem),
        stem_shift=stem_shift)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.shape == (2, 8, 8, 64)
    assert ((got > 0) & (got < 255)).mean() > 0.2
    assert {s.skip_shift for s in specs} == {3, 0, -2}


# ---- (b) the wrapper's argument checks ------------------------------------

def _small_chain():
    rng = np.random.default_rng(0)
    blocks, sched = _chain_np(rng, [(4, 8, 2), (8, 8, 1)])
    x = torch.from_numpy(_u8(rng, 1, 8, 8, 4))
    return (x, *_port(blocks, sched))


def test_wrapper_rejects_blocks_specs_mismatch():
    x, blocks, specs = _small_chain()
    with pytest.raises(ValueError, match="mismatch"):
        block_chain_op(x, blocks[:1], specs=specs)
    with pytest.raises(ValueError, match="mismatch"):
        block_chain_op(x, (), specs=())


def test_wrapper_rejects_wrong_operand_count_for_has_ds():
    x, blocks, specs = _small_chain()
    with pytest.raises(ValueError, match="has_ds=True takes 6"):
        block_chain_op(x, (blocks[0][:4], blocks[1]), specs=specs)
    with pytest.raises(ValueError, match="has_ds=False takes 4"):
        block_chain_op(x, (blocks[0], blocks[1] + blocks[0][4:]),
                       specs=specs)


def test_wrapper_rejects_odd_size_at_a_stride_2_head():
    x, blocks, specs = _small_chain()
    with pytest.raises(ValueError, match="even"):
        block_chain_op(x[:, :7, :7], blocks, specs=specs)


@pytest.mark.parametrize("field,value", [("shift0", 32), ("shift1", -32),
                                         ("skip_shift", 40),
                                         ("skip_shift", 1.5)])
def test_wrapper_rejects_shift_out_of_range(field, value):
    x, blocks, specs = _small_chain()
    bad = (specs[0], dataclasses.replace(specs[1], **{field: value}))
    with pytest.raises(ValueError, match=field):
        block_chain_op(x, blocks, specs=bad)


def test_wrapper_rejects_stem_shift_without_stem_and_bad_stem():
    x, blocks, specs = _small_chain()
    with pytest.raises(ValueError, match="stem and stem_shift together"):
        block_chain_op(x, blocks, specs=specs, stem_shift=3)
    stem = (torch.zeros((3, 3, 3, 4), dtype=torch.int8),
            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="stem and stem_shift together"):
        block_chain_op(x, blocks, specs=specs, stem=stem)
    with pytest.raises(ValueError, match="stem w must be"):
        block_chain_op(x, blocks, specs=specs, stem=stem, stem_shift=3)
    with pytest.raises(ValueError, match="stem_shift"):
        block_chain_op(x[..., :3].contiguous(), blocks, specs=specs,
                       stem=stem, stem_shift=99)


def test_wrapper_rejects_mismatched_weights_and_identity_misuse():
    x, blocks, specs = _small_chain()
    with pytest.raises(ValueError, match="link 1 w0 must be"):
        block_chain_op(x, (blocks[0], (blocks[0][0],) + blocks[1][1:]),
                       specs=specs)
    with pytest.raises(ValueError, match="uint8"):
        block_chain_op(x.to(torch.int32), blocks, specs=specs)
    no_ds = (dataclasses.replace(specs[0], has_ds=False), specs[1])
    with pytest.raises(ValueError, match="identity skip"):
        block_chain_op(x, (blocks[0][:4], blocks[1]), specs=no_ds)


# ---- (c) KernelConfig and the byte model against the reference ----------

@pytest.mark.parametrize("cfg", [dict(), dict(batch_tile=0),
                                 dict(batch_tile=5, cout_block=12),
                                 dict(batch_tile=3, bm=128, bk=64)])
def test_kernel_config_matches_reference(cfg):
    ours, ref = KernelConfig(**cfg), JKernelConfig(**cfg)
    assert ours.to_dict() == ref.to_dict()
    assert ours.describe() == ref.describe()
    for n, cout in ((1, 16), (32, 64), (8, 10), (7, 3)):
        assert ours.normalize(n, cout).to_dict() == \
            ref.normalize(n, cout).to_dict()
    assert KernelConfig.from_dict({**ref.to_dict(), "junk": 1}) == ours
    assert largest_divisor_leq(32, 5) == 4


def _shapes_pair(bps):
    return df.resnet_block_shapes(bps), jdf.resnet_block_shapes(bps)


@pytest.mark.parametrize("bps", [1, 3])
def test_byte_model_matches_reference(bps):
    ours, ref = _shapes_pair(bps)
    assert [(b.h, b.w, b.ich, b.och, b.downsample, b.stride) for b in ours] \
        == [(b.h, b.w, b.ich, b.och, b.downsample, b.stride) for b in ref]
    for batch, bt in ((1, 1), (4, 1), (4, 4), (8, 2), (32, 2)):
        for k in range(1, len(ours) + 1):
            for och in (0, 16):
                assert df.chain_task_hbm_bytes(ours[:k], batch, bt, och) == \
                    jdf.chain_task_hbm_bytes(ref[:k], batch, bt, och)
                assert df.chain_task_vmem_bytes(ours[:k], bt, och) == \
                    jdf.chain_task_vmem_bytes(ref[:k], bt, och)
            assert df.chain_saved_hbm_bytes(ours[:k], batch) == \
                jdf.chain_saved_hbm_bytes(ref[:k], batch)
        for b, jb in zip(ours, ref):
            assert df.resblock_task_hbm_bytes(
                b.h, b.w, b.ich, b.och, batch, bt, b.downsample,
                b.stride) == jdf.resblock_task_hbm_bytes(
                jb.h, jb.w, jb.ich, jb.och, batch, bt, jb.downsample,
                jb.stride)
    assert df.residual_block_hbm_bytes(16, 16, 16, 32, fused=False,
                                       downsample=True, stride=2) == \
        jdf.residual_block_hbm_bytes(16, 16, 16, 32, fused=False,
                                     downsample=True, stride=2)


@pytest.mark.parametrize("bps", [1, 3])
@pytest.mark.parametrize("batch,batch_tile", [(1, 1), (4, 1), (4, 4), (8, 2)])
def test_chain_hbm_identity_holds_in_the_port(bps, batch, batch_tile):
    """Chain HBM traffic == the per-block traffic minus the saved interior
    round trips (the identity of tests/test_dataflow.py)."""
    shapes = df.resnet_block_shapes(bps)
    per_block = sum(df.resblock_task_hbm_bytes(
        s.h, s.w, s.ich, s.och, batch, batch_tile,
        downsample=s.downsample, stride=s.stride) for s in shapes)
    saved = df.chain_saved_hbm_bytes(shapes, batch)
    assert df.chain_task_hbm_bytes(shapes, batch, batch_tile) == \
        per_block - saved
    assert 0 < saved


def test_chain_smem_bytes_of_the_resnet_chains():
    """The kernel's layout at ResNet widths: two weight slots of the
    largest packed part (the 32->64 link's conv1 and downsample, 39,424 B
    each), the stem's filter and bias (640 B), and three band planes per
    image: at split 1 the whole 34x34x16 map (18,496 B), at split 4 its
    10-row band (5,440 B), at split 8 the 16x16x32 map's 4-row band at 48 B
    a pixel (3,456 B); monotone in links and tile."""
    r20 = df.resnet_block_shapes(3)
    assert df.chain_task_smem_bytes(r20, 1, stem_och=16) == \
        640 + 2 * 39_424 + 3 * 18_496
    assert df.chain_task_smem_bytes(r20, 2, stem_och=16) == \
        640 + 2 * 39_424 + 2 * 3 * 18_496
    assert df.chain_task_smem_bytes(r20, 3, stem_och=16) > space.SMEM_BUDGET
    assert df.chain_task_smem_bytes(r20, 1) == 2 * 39_424 + 3 * 18_496
    assert df.chain_task_smem_bytes(r20, 1, stem_och=16, split=4) == \
        640 + 2 * 39_424 + 3 * 5_440
    assert df.chain_task_smem_bytes(r20, 1, stem_och=16, split=8) == \
        640 + 2 * 39_424 + 3 * 3_456
    for k in range(1, len(r20)):
        assert df.chain_task_smem_bytes(r20[:k + 1], 1) >= \
            df.chain_task_smem_bytes(r20[:k], 1)
    # pinning every chain weight, as the TPU kernel does, could not fit
    assert sum(b.weight_bytes() for b in r20) > space.SMEM_BUDGET


# ---- (d) plan_chains against the reference -------------------------------

def _partitions(n, bps):
    return [[[i] for i in range(n)], [list(range(n))],
            [list(range(i * bps, (i + 1) * bps)) for i in range(3)],
            [[0], list(range(1, n))], [list(range(n - 1)), [n - 1]]]


def _chain_view(chains):
    return [(tuple(t.index for t in c.blocks),
             None if c.stem is None else c.stem.node, c.describe())
            for c in chains]


@pytest.mark.parametrize("arch", ["resnet8", "resnet20"])
@pytest.mark.parametrize("fuse_stem", [True, False])
def test_plan_chains_with_explicit_cuts_matches_reference(arch, fuse_stem):
    cfg, jcfg = getattr(R, arch.upper()), getattr(JR, arch.upper())
    plan = L.plan_model(L.optimized_graph(cfg))
    jplan = JL.plan_model(JL.optimized_graph(jcfg))
    n = len(plan.blocks)
    for cuts in _partitions(n, cfg.blocks_per_stage) + [None]:
        ours = L.plan_chains(plan, cfg, cuts=cuts, fuse_stem=fuse_stem)
        ref = JL.plan_chains(jplan, jcfg, cuts=cuts, fuse_stem=fuse_stem)
        assert _chain_view(ours) == _chain_view(ref), cuts
        assert all(c.config is None for c in ours)


@pytest.mark.parametrize("cuts", [[[0, 1], [3]], [[1, 0], [2]],
                                  [[0], [0, 1, 2]], [[0, 1, 2, 3]]])
def test_plan_chains_rejects_a_non_partition_like_reference(cuts):
    plan = L.plan_model(L.optimized_graph(R.RESNET8))
    jplan = JL.plan_model(JL.optimized_graph(JR.RESNET8))
    with pytest.raises(L.LoweringError) as ours:
        L.plan_chains(plan, R.RESNET8, cuts=cuts)
    with pytest.raises(JL.LoweringError) as ref:
        JL.plan_chains(jplan, JR.RESNET8, cuts=cuts)
    assert str(ours.value) == str(ref.value)


# ---- (e) the greedy planner at the H100's budget --------------------------

def _check_greedy(shapes, cuts, stem_och, budget):
    assert [i for run in cuts for i in run] == list(range(len(shapes)))
    for k, run in enumerate(cuts):
        och = stem_och if k == 0 else 0
        legal = space.chain_space([shapes[i] for i in run], 1, och, budget)
        assert legal or len(run) == 1, run
        if k + 1 < len(cuts) and legal:
            # greedy-maximal: the next block would not have fitted
            longer = [shapes[i] for i in run + [cuts[k + 1][0]]]
            assert not space.chain_space(longer, 1, och, budget)


@pytest.mark.parametrize("bps", [1, 3])
def test_chain_cut_points_fuse_each_whole_model_at_smem_budget(bps):
    shapes = df.resnet_block_shapes(bps)
    cuts = space.chain_cut_points(shapes, 1, stem_och=16)
    assert cuts == [list(range(3 * bps))]
    _check_greedy(shapes, cuts, 16, space.SMEM_BUDGET)
    # at bucket 32 the rule splits an image 4 ways at tile 1 and 8 ways
    # from tile 2, so the band planes of up to 8 images fit one thread block
    assert space.chain_space(shapes, 32, stem_och=16) == \
        [KernelConfig(batch_tile=bt) for bt in (1, 2, 4, 8)]
    cfg = R.RESNET8 if bps == 1 else R.RESNET20
    chains = L.plan_chains(L.plan_model(L.optimized_graph(cfg)), cfg)
    assert len(chains) == 1 and chains[0].stem is not None
    assert len(chains[0].blocks) == 3 * bps


@pytest.mark.parametrize("delta", [1, 20_000, 60_000])
def test_chain_cut_points_cut_under_a_small_budget(delta):
    shapes = df.resnet_block_shapes(3)
    # legality is judged at batch 1, where the rule splits an image 8 ways
    split = space.chain_split(shapes, 1, 1, stem_och=16)
    assert split == 8
    budget = df.chain_task_smem_bytes(shapes, 1, stem_och=16,
                                      split=split) - delta
    cuts = space.chain_cut_points(shapes, 1, stem_och=16, smem_budget=budget)
    assert len(cuts) > 1
    _check_greedy(shapes, cuts, 16, budget)
    assert space.chain_cut_points(shapes, 1, smem_budget=1) == \
        [[i] for i in range(len(shapes))]
    chains = L.plan_chains(L.plan_model(L.optimized_graph(R.RESNET20)),
                           R.RESNET20, smem_budget=1)
    assert [c.stem for c in chains] == [None] * 9
