"""``matmul_int8``'s shape dispatch, packed weights and split-K on the CPU.

The tile choice (``matmul_tiles``) and the path choice (``matmul_path``)
are pure functions of the shape, held here for every projection of the
two LMs at the main path's M (512 and 2048) and for the ragged shapes of
the chip check.  The packed weight is the same function as the ``(K, N)``
form and as the JAX ``matmul_int8``; the ``cuda`` LM lowering packs each
weight once, at lower time; and split-K's int32 sum is bitwise the plain
product whatever order the partials arrive in."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_int8.ops import matmul_int8_op as j_matmul_op
from repro_torch.compile import (compile_model, init_lm_params, lm_config,
                                 lowering, plan_lm)
from repro_torch.compile import backends as BK
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.matmul_int8 import ops as mm_ops
from repro_torch.kernels.matmul_int8.ops import (PackedWeight, matmul_int8_op,
                                                 matmul_path, matmul_tiles,
                                                 pack_weight)
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

# wgmma m64nNk32 .s8: the widths the instruction takes
WGMMA_N = {8, 16, 24} | set(range(32, 257, 16))
RAGGED = [(1000, 2048, 200), (77, 30, 18), (129, 4096, 16)]


def _lm_shapes():
    """(model, role, M, K, N) of every projection of both LMs at bucket 1
    and 4 (M = 512, 2048), from the port's own plan."""
    out = []
    for name in ("gemma-2b", "falcon-mamba-7b"):
        cfg = lm_config(get_config(name), seq_len=512)
        plan = plan_lm(lowering.optimized_graph(cfg))
        roles = sorted({(t.role, t.din, t.dout) for t in plan.tasks
                        if isinstance(t, lowering.MatmulTask)})
        out += [(name, r, M, K, N) for r, K, N in roles for M in (512, 2048)]
    return out


LM_SHAPES = _lm_shapes()


def _check_legal(M, N, K):
    bm, bn, bk, split = matmul_tiles(M, N, K)
    assert bm % 64 == 0
    assert bn in WGMMA_N and bn in mm_ops.TILE_N
    assert bk % 32 == 0
    ktiles = -(-K // bk)
    assert split >= 1 and ktiles % split == 0
    return bm, bn, bk, split


@pytest.mark.parametrize("name,role,M,K,N", LM_SHAPES)
def test_lm_projection_shapes_take_wgmma_with_legal_tiles(name, role, M, K,
                                                          N):
    assert matmul_path(M, N, K) == "wgmma"
    bm, bn, _, split = _check_legal(M, N, K)
    # at least half the card's SMs get work
    assert -(-M // bm) * -(-N // bn) * split >= mm_ops.BUSY // 2


def test_every_lm_role_is_covered():
    roles = {(name, role) for name, role, *_ in LM_SHAPES}
    assert roles == {("gemma-2b", r) for r in
                     ("wq", "wk", "wv", "wo", "up", "down")} | \
        {("falcon-mamba-7b", r) for r in
         ("wu", "wz", "wdt", "wb", "wc", "wo")}


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_ragged_shapes_dispatch_by_shape(M, K, N):
    _check_legal(M, N, K)
    want = "wgmma" if K % 16 == 0 and N % 16 == 0 else "mma_sync"
    assert matmul_path(M, N, K) == want
    assert matmul_path(M, N, K, aligned=False) == "mma_sync"


@pytest.mark.parametrize("M,K,N,init", [
    (64, 256, 16, "full"), (100, 96, 48, "bias"), (40, 30, 24, None),
    (24, 16, 18, "full")])
def test_packed_weight_matches_the_kn_form_and_jax_bitwise(M, K, N, init):
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    acc = None
    if init == "full":
        acc = rng.integers(-2 ** 24, 2 ** 24, (M, N)).astype(np.int32)
    elif init == "bias":
        acc = np.broadcast_to(rng.integers(-2 ** 24, 2 ** 24, (1, N)).astype(
            np.int32), (M, N))
    want = np.asarray(j_matmul_op(jnp.asarray(a), jnp.asarray(b),
                                  None if acc is None else jnp.asarray(acc)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tacc = None if acc is None else torch.from_numpy(np.array(acc))
    if init == "bias":
        tacc = tacc[:1].expand(M, N)
    w = pack_weight(tb)
    assert isinstance(w, PackedWeight) and w.t.shape == (N, K)
    assert w.t.is_contiguous() and torch.equal(w.unpacked(), tb)
    got = matmul_int8_op(ta, w, tacc)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, matmul_int8_op(ta, tb, tacc))


def test_packed_weight_shape_errors_name_the_layout():
    w = pack_weight(torch.zeros(8, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match=r"packed \(N,K\) K-major"):
        matmul_int8_op(torch.zeros(4, 7, dtype=torch.int8), w)
    with pytest.raises(ValueError, match=r"\(K,N\) = \(din, dout\)"):
        matmul_int8_op(torch.zeros(4, 7, dtype=torch.int8),
                       torch.zeros(8, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\(din, dout\) layout"):
        pack_weight(torch.zeros(8, dtype=torch.int8))


def test_init_rows_reads_a_broadcast_bias_in_place():
    bias = torch.arange(32, dtype=torch.int32)[None, :]
    full = torch.zeros((6, 32), dtype=torch.int32)
    view, ld = mm_ops._init_rows(bias.expand(6, 32), 32)
    assert ld == 0 and view.data_ptr() == bias.data_ptr()
    view, ld = mm_ops._init_rows(full, 32)
    assert ld == 32 and view.data_ptr() == full.data_ptr()
    view, ld = mm_ops._init_rows(full.t().contiguous().t(), 32)
    assert ld == 32 and view.is_contiguous()
    assert mm_ops._init_rows(None, 32) == (None, 0)


@pytest.mark.parametrize("M,K,N", [(96, 2048, 16), (64, 1024, 48)])
def test_split_k_partials_sum_to_the_plain_product_in_any_order(M, K, N):
    """The kernel's split-K, as plain int32 arithmetic: each split's
    partial product over its K range, added into a zeroed output in a
    shuffled order, with acc_init (near +-2^31, so the sum wraps) added by
    split 0.  Wrap-around addition is associative and commutative, so
    every order gives the plain product bitwise."""
    _, _, bk, split = matmul_tiles(M, N, K)
    assert split > 1
    rng = np.random.default_rng(K + N)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (K, N), dtype=np.int8))
    init = torch.from_numpy(np.where(
        rng.random((M, N)) < 0.5,
        2 ** 31 - 1 - rng.integers(0, 2 ** 16, (M, N)),
        -2 ** 31 + rng.integers(0, 2 ** 16, (M, N))).astype(np.int32))
    ref = matmul_int8_ref(a, b, init)
    kper = -(-K // bk) // split * bk
    partials = [matmul_int8_ref(a[:, s * kper:(s + 1) * kper],
                                b[s * kper:(s + 1) * kper])
                for s in range(split)]
    partials[0] = partials[0] + init
    wrapped = False
    for order in (range(split), reversed(range(split)),
                  rng.permutation(split)):
        out = torch.zeros((M, N), dtype=torch.int32)
        for s in order:
            before = out.to(torch.int64) + partials[int(s)].to(torch.int64)
            out = out + partials[int(s)]
            wrapped |= bool((before != out.to(torch.int64)).any())
        assert torch.equal(out, ref)
    assert wrapped


def test_cuda_lowering_packs_each_weight_once_at_lower_time():
    """``compile_model(backend="cuda")`` packs every matmul weight while it
    lowers; serving runs pack nothing, and every forward reads the same
    packed tensors."""
    cfg = lm_config(get_smoke_config("falcon-mamba-7b"), seq_len=16)
    params = init_lm_params(cfg, seed=4, device="cpu")
    plan = plan_lm(lowering.optimized_graph(cfg), params)
    n_matmul = sum(isinstance(t, lowering.MatmulTask) for t in plan.tasks)
    before = pack_weight.calls
    cm = compile_model(cfg, params, backend="cuda", batch_sizes=(2,),
                       device="cpu")
    packed = pack_weight.calls - before
    assert packed == n_matmul
    seen = []
    real = BK.lm_context

    def spy(*args, **kw):
        ctx = real(*args, **kw)
        seen.append(ctx.packed)
        return ctx

    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    BK.lm_context = spy
    try:
        after_lower = pack_weight.calls
        cm(toks.astype(np.int32))
        cm(toks.astype(np.int32))
    finally:
        BK.lm_context = real
    assert pack_weight.calls == after_lower
    assert len(seen) == 2 and seen[0] is seen[1]
    assert len(seen[0]) == n_matmul
    for t in plan.tasks:
        if isinstance(t, lowering.MatmulTask):
            w = seen[0][t.node]
            assert torch.equal(w.unpacked(),
                               params.matmul(t.layer, t.role).wq)


def test_cuda_matmul_impl_refuses_an_unpacked_context():
    cfg = lm_config(get_smoke_config("gemma-2b"), seq_len=16)
    params = init_lm_params(cfg, seed=4, device="cpu")
    plan = plan_lm(lowering.optimized_graph(cfg), params)
    ctx = BK.lm_context(plan, params, cfg)
    BK.embed_tokens(ctx, plan, torch.zeros((1, 16), dtype=torch.int32))
    first = next(t for t in plan.tasks if isinstance(t, lowering.MatmulTask))
    with pytest.raises(lowering.LoweringError, match="packed at lower time"):
        BK.get_task_impl("cuda", "matmul")(first, ctx)
