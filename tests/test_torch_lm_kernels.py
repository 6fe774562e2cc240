"""The LM kernels' plain versions in the port against the JAX package, on
the CPU: ``matmul_int8`` bitwise against the JAX kernel (interpret mode)
and its oracle, flash attention and the selective scan within the JAX
tests' own tolerances (2e-5 and 1e-5), at the sweep shapes of
``tests/test_kernels.py``.  The wrappers take a CPU tensor to the plain
version and check their operands."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.flash_attention.ref import \
    flash_attention_mirror as j_mirror
from repro.kernels.matmul_int8.ops import matmul_int8_op as j_matmul_op
from repro.kernels.matmul_int8.ref import matmul_int8_ref as j_matmul_ref
from repro.kernels.selective_scan.ref import selective_scan_ref as j_scan_ref
from repro_torch.compile import backends as BK
from repro_torch.kernels.flash_attention.ops import (attn_tiles,
                                                     block_rows,
                                                     flash_attention_op)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_mirror)
from repro_torch.kernels.matmul_int8.ops import matmul_int8_op
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref
from repro_torch.kernels.selective_scan.ops import selective_scan_op
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.tune.config import KernelConfig


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- matmul_int8 ------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,init", [
    (128, 256, 128, True),
    (128, 256, 128, False),
    (64, 64, 16, True),        # N = 16, the SSM's B/C projections
    (100, 96, 48, True),       # M not a tile multiple
    (40, 30, 24, True),        # K not a multiple of 4
    (24, 16, 18, False),       # N not a multiple of 4
])
def test_matmul_int8_plain_matches_jax_bitwise(M, K, N, init):
    rng = np.random.default_rng(M * 7 + K + N)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    acc = rng.integers(-2 ** 24, 2 ** 24, (M, N)).astype(np.int32) \
        if init else None
    j_acc = None if acc is None else jnp.asarray(acc)
    ref = np.asarray(j_matmul_ref(jnp.asarray(a), jnp.asarray(b), j_acc))
    kern = np.asarray(j_matmul_op(jnp.asarray(a), jnp.asarray(b), j_acc))
    np.testing.assert_array_equal(kern, ref)
    t_acc = None if acc is None else _t(acc)
    got = matmul_int8_op(_t(a), _t(b), t_acc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        matmul_int8_ref(_t(a), _t(b), t_acc).numpy(), ref)


def test_matmul_int8_extremes_are_exact_and_init_wraps_as_int32():
    """K = 16,384 of (-128) x (-128): 2^28, exact through float64; an init
    near the int32 limit wraps as the reference's int32 add does."""
    a = torch.full((2, 16384), -128, dtype=torch.int8)
    b = torch.full((16384, 3), -128, dtype=torch.int8)
    assert int(matmul_int8_op(a, b)[0, 0]) == 16384 * 128 * 128
    init = torch.full((2, 3), 2 ** 31 - 1, dtype=torch.int32)
    got = matmul_int8_op(a[:, :4], b[:4], init)
    want = np.asarray(j_matmul_ref(jnp.asarray(a[:, :4].numpy()),
                                   jnp.asarray(b[:4].numpy()),
                                   jnp.asarray(init.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


def test_matmul_int8_takes_a_broadcast_init():
    """The LM prologue's bias is a stride-0 ``expand`` of one row."""
    rng = np.random.default_rng(1)
    a = _t(rng.integers(-128, 128, (6, 8), dtype=np.int8))
    b = _t(rng.integers(-128, 128, (8, 5), dtype=np.int8))
    bias = _t(rng.integers(-99, 99, (1, 5)).astype(np.int32))
    got = matmul_int8_op(a, b, bias.expand(6, 5))
    assert torch.equal(got, matmul_int8_op(a, b, bias.repeat(6, 1)))


@pytest.mark.parametrize("args,match", [
    (dict(a=torch.zeros(4, 8, dtype=torch.uint8)), "a must be"),
    (dict(b=torch.zeros(7, 3, dtype=torch.int8)), "b must be"),
    (dict(acc_init=torch.zeros(4, 3, dtype=torch.int64)), "acc_init"),
    (dict(config=KernelConfig(bm=64)), "config"),
])
def test_matmul_int8_op_rejects_bad_operands(args, match):
    kw = dict(a=torch.zeros(4, 8, dtype=torch.int8),
              b=torch.zeros(8, 3, dtype=torch.int8), acc_init=None)
    kw.update(args)
    with pytest.raises(ValueError, match=match):
        matmul_int8_op(**kw)


# -- flash attention --------------------------------------------------------


def _flat(t, H):
    """(B, S, KV, hd) -> (B*H, S, hd) with the JAX wrapper's GQA repeat."""
    B, S, KV, hd = t.shape
    return np.asarray(jnp.repeat(jnp.asarray(t), H // KV, axis=2)
                      .transpose(0, 2, 1, 3).reshape(B * H, S, hd))


FLASH_CASES = [
    # the sweep of tests/test_kernels.py: (B, Sq, Sk, H, KV, hd, causal)
    (1, 64, 64, 2, 2, 16, True),
    (2, 128, 128, 4, 2, 32, True),
    (1, 64, 64, 2, 1, 16, False),
    (1, 32, 128, 4, 1, 16, True),     # decode convention: Sq < Sk
    (2, 96, 96, 4, 1, 16, True),      # MQA, a ragged last tile of 32
    # the thread block packs the query heads of a kv group: no grouping,
    # 4 heads a group, gemma-2b's 8 heads on one kv head, wider heads and
    # an Sk that is not a tile multiple
    (1, 64, 64, 4, 4, 16, True),
    (1, 64, 64, 8, 2, 16, True),
    (2, 64, 64, 8, 1, 32, True),
    (1, 64, 64, 2, 1, 64, True),
    (1, 64, 128, 2, 2, 128, False),
    (1, 40, 100, 8, 1, 32, True),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", FLASH_CASES)
def test_flash_attention_plain_matches_jax(B, Sq, Sk, H, KV, hd, causal):
    rng = np.random.default_rng(Sq + H + KV)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    out = flash_attention_op(_t(q), _t(k), _t(v), causal=causal).numpy()
    assert out.shape == (B, Sq, H, hd)
    qf, kf, vf = _flat(q, H), _flat(k, H), _flat(v, H)
    ref = np.asarray(j_attention_ref(qf, kf, vf, causal=causal))
    ref = ref.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    # the tiled walk on the kernel's tiles (a thread block's positions for
    # this head grouping, and one head's positions without grouping)
    # against the naive oracle, and against the JAX mirror on the same
    # tiles where the JAX mirror can take them (tiles dividing the lengths)
    for bq, bk in {attn_tiles(Sq, Sk, H // KV), attn_tiles(Sq, Sk)}:
        mine = flash_attention_mirror(_t(qf), _t(kf), _t(vf), causal=causal,
                                      bq=bq, bk=bk).numpy()
        np.testing.assert_allclose(
            mine.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3), ref,
            rtol=2e-5, atol=2e-5)
        if Sq % bq == 0 and Sk % bk == 0:
            theirs = np.asarray(j_mirror(jnp.asarray(qf), jnp.asarray(kf),
                                         jnp.asarray(vf), causal=causal,
                                         bq=bq, bk=bk))
            np.testing.assert_allclose(mine, theirs, rtol=2e-5, atol=2e-5)
    # the port's own naive oracle
    mine = attention_ref(_t(qf), _t(kf), _t(vf), causal=causal).numpy()
    np.testing.assert_allclose(mine, np.asarray(ref).transpose(
        0, 2, 1, 3).reshape(B * H, Sq, hd), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("group,rows", [(1, (1, 64)), (2, (2, 32)),
                                        (8, (8, 8)), (3, (3, 21)),
                                        (100, (64, 1))])
def test_a_thread_block_packs_the_heads_of_a_kv_group(group, rows):
    """``block_rows``: the heads of one kv group times positions, at most
    the kernel's 64 q rows; ``attn_tiles`` walks one head's share."""
    assert block_rows(group) == rows
    assert rows[0] * rows[1] <= 64
    assert attn_tiles(512, 512, group) == (rows[1], 64)
    assert attn_tiles(4, 40, group) == (min(rows[1], 4), 40)


def test_flash_attention_bf16_keeps_the_dtype():
    """bf16 in, float32 arithmetic, bf16 out (2e-2, the JAX test's bf16
    tolerance)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    out = flash_attention_op(q, k, v)
    assert out.dtype == torch.bfloat16
    flat = [np.asarray(t.float().numpy()).transpose(0, 2, 1, 3).reshape(
        2, 64, 16) for t in (q, k, v)]
    ref = np.asarray(j_attention_ref(*(jnp.asarray(f, jnp.bfloat16)
                                       for f in flat)), np.float32)
    np.testing.assert_allclose(
        out.float().numpy().transpose(0, 2, 1, 3).reshape(2, 64, 16), ref,
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 2, 16), (1, 4, 2, 16)), "Sq <= Sk"),
    (((1, 8, 3, 16), (1, 8, 2, 16)), "KV dividing"),
])
def test_flash_attention_op_rejects_bad_operands(shapes, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        flash_attention_op(q, k, k.clone(), causal=True)


# -- selective scan ---------------------------------------------------------


def _scan_inputs(B, S, di, N, seed):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 6)
    u = jax.random.normal(ks[0], (B, S, di))
    dt = jax.nn.softplus(jax.random.normal(ks[1], (B, S, di)))
    A = -jnp.exp(jax.random.normal(ks[2], (di, N)) * 0.5)
    Bc = jax.random.normal(ks[3], (B, S, N))
    Cc = jax.random.normal(ks[4], (B, S, N))
    h0 = jax.random.normal(ks[5], (B, di, N))
    return [np.asarray(x) for x in (u, dt, A, Bc, Cc, h0)]


@pytest.mark.parametrize("B,S,di,N", [
    (1, 16, 8, 4), (2, 32, 16, 8), (2, 64, 32, 16),   # tests/test_kernels.py
])
def test_selective_scan_plain_matches_jax(B, S, di, N):
    ops = _scan_inputs(B, S, di, N, S + di)
    y_ref, h_ref = j_scan_ref(*(jnp.asarray(x) for x in ops))
    y, h = selective_scan_op(*(_t(x) for x in ops))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5,
                               atol=1e-5)
    y2, h2 = selective_scan_ref(*(_t(x) for x in ops))
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_selective_scan_op_rejects_bad_operands():
    u = torch.zeros(1, 4, 8)
    A = torch.zeros(8, 4)
    bc = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="h0 must be"):
        selective_scan_op(u, u, A, bc, bc, torch.zeros(1, 8, 5))
    with pytest.raises(ValueError, match="float32"):
        selective_scan_op(u.double(), u, A, bc, bc, torch.zeros(1, 8, 4))


# -- the float helpers of the scan task -------------------------------------


def test_softplus_and_silu_follow_jax():
    """``softplus`` is ``logaddexp(x, 0)`` with no threshold, ``silu`` is
    ``x * sigmoid(x)``: both as ``jax.nn`` computes them."""
    x = np.linspace(-40, 40, 2001).astype(np.float32)
    np.testing.assert_allclose(BK.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(BK.silu(_t(x)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
