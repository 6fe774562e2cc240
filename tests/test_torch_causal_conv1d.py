"""The ``mamba1`` conv task's kernel, ``causal_conv1d``: its SiLU table,
its plain version against the plain PyTorch chain of ``torch-int``
(``compile.backends._lm_conv1d``), the wrapper's checks, and (marked
``cuda``, skipped without a GPU) the kernel against the chain on the card.

Everything is integer or a table of the chain's own float32 results, so
every comparison is bitwise."""
import types

import numpy as np
import pytest
import torch

from repro_torch.compile import backends as BK
from repro_torch.compile import lm_params as LP
from repro_torch.compile import lowering
from repro_torch.core import quant as Q
from repro_torch.kernels.causal_conv1d.ops import (causal_conv1d_op,
                                                   causal_conv1d_ref)
from repro_torch.kernels.common import read_launches


def s8(bits=8, exp=-5):
    return Q.QSpec(bits=bits, signed=True, exp=exp)


def chain_codes(codes, y_spec, out_spec):
    """The plain chain's map of int8 codes on ``y_spec``: dequantize, SiLU,
    quantize onto ``out_spec`` (as ``_lm_conv1d`` computes it)."""
    return Q.quantize(BK.silu(Q.dequantize(codes, y_spec)), out_spec)


def conv_params(rng, C, K, shift, dev="cpu", bias=2 ** 12, x_exp=-5,
                w_exp=-7):
    """Random int8 taps and an int32 bias on the product domain, with
    ``y_spec`` placed ``shift`` above it."""
    wq = torch.from_numpy(rng.integers(-128, 128, (K, C)).astype(np.int8))
    bq = torch.from_numpy(rng.integers(-bias, bias + 1, C).astype(np.int32))
    return LP.QConv1dParams(
        wq=wq.to(dev), bq=bq.to(dev), w_spec=s8(exp=w_exp),
        x_spec=s8(exp=x_exp), y_spec=s8(exp=x_exp + w_exp + shift))


def run_task(impl, xz, cp, out_spec, packed=None):
    """One conv task of a one-layer plan through ``impl`` on ``xz``'s first
    ``C`` columns: the output code and its grid."""
    K, C = cp.wq.shape
    t = lowering.Conv1dTask(node="l0.conv", layer=0, channels=C, kernel=K,
                            inputs=("l0.xz",), output="l0.u")
    params = types.SimpleNamespace(layers=[types.SimpleNamespace(conv=cp)])
    ctx = BK._LMContext(params, None, {"l0.u": out_spec}, packed)
    ctx.put("l0.xz", xz, cp.x_spec)
    impl(t, ctx)
    return ctx.env["l0.u"], ctx.specs["l0.u"]


def random_xz(rng, B, S, width, dev="cpu"):
    return torch.from_numpy(
        rng.integers(-128, 128, (B, S, width)).astype(np.int8)).to(dev)


def conv_loops(x, wq, bq):
    """``causal_conv_i32`` written out position by position (int64)."""
    x, w, b = (t.to(torch.int64) for t in (x, wq, bq))
    K, (B, S, C) = w.shape[0], x.shape
    acc = b.expand(B, S, C).clone()
    for t in range(S):
        for k in range(K):
            src = t - K + 1 + k
            if src >= 0:
                acc[:, t] += w[k] * x[:, src]
    return acc


# -- the table ---------------------------------------------------------------

SPEC_PAIRS = [
    (s8(exp=-5), s8(exp=-5)),     # the cell's grids
    (s8(exp=-2), s8(exp=-5)),     # large SiLU: saturates at 127
    (s8(exp=-3), s8(exp=-10)),    # fine output grid: saturates at -128 too
    (s8(exp=-7), s8(exp=-4)),     # coarse output grid: many codes share one
    (s8(exp=-4), s8(exp=-9)),     # both ends of the output grid
]


@pytest.mark.parametrize("y_spec,out_spec", SPEC_PAIRS)
def test_table_is_the_float_chain_for_every_code(y_spec, out_spec):
    """Each entry equals the chain on that code alone, and gathering the
    table equals the chain over a large tensor of codes (PyTorch's
    vectorised loops and its scalar tail agree on each code)."""
    cp = LP.QConv1dParams(wq=torch.zeros(4, 8, dtype=torch.int8),
                          bq=torch.zeros(8, dtype=torch.int32),
                          w_spec=s8(), x_spec=s8(), y_spec=y_spec)
    table = BK.conv_silu_table(cp, out_spec)
    assert table.dtype == torch.int8 and table.shape == (256,)
    for i, code in enumerate(range(-128, 128)):
        c = torch.tensor([code], dtype=torch.int8)
        assert int(table[i]) == int(chain_codes(c, y_spec, out_spec)[0]), \
            code
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(rng.integers(
        -128, 128, (3, 257, 129)).astype(np.int8))
    assert torch.equal(table[codes.to(torch.int64) + 128],
                       chain_codes(codes, y_spec, out_spec))
    if out_spec.exp <= -5 and y_spec.exp >= -2:
        assert int(table.max()) == 127
    if out_spec.exp <= -9:
        assert int(table.min()) == -128 and int(table.max()) == 127


@pytest.mark.parametrize("y_spec,out_spec", [
    (Q.QSpec(bits=16, signed=True, exp=-8), s8()),
    (s8(bits=4, exp=-3), s8()),
    (s8(), Q.QSpec(bits=8, signed=False, exp=-5)),
])
def test_table_refuses_grids_other_than_int8(y_spec, out_spec):
    """The kernel clamps to int8 and writes int8: a conv grid or an output
    grid of another width is refused at lower time."""
    cp = LP.QConv1dParams(wq=torch.zeros(4, 8, dtype=torch.int8),
                          bq=torch.zeros(8, dtype=torch.int32),
                          w_spec=s8(), x_spec=s8(), y_spec=y_spec)
    with pytest.raises(lowering.LoweringError, match="int8 codes"):
        BK.conv_silu_table(cp, out_spec)


# -- the plain version against the chain -------------------------------------

CASES = [
    # (B, S, C, K, shift, bias)
    (2, 16, 64, 4, 3, 2 ** 12),      # shift > 0, the usual
    (3, 5, 37, 4, 0, 2 ** 10),       # odd channels, shift 0
    (2, 9, 129, 4, -2, 2 ** 6),      # shift < 0: a left shift
    (1, 3, 16, 4, 1, 2 ** 15),       # shorter than the window
    (2, 11, 33, 2, 4, 2 ** 14),      # fewer taps
    (4, 7, 24, 1, 2, 2 ** 13),       # one tap: the current position only
]


@pytest.mark.parametrize("B,S,C,K,shift,bias", CASES)
def test_plain_version_is_the_chain_bitwise(B, S, C, K, shift, bias):
    """The op's CPU path and the ``cuda`` impl on the CPU equal
    ``_lm_conv1d``'s chain on x read out of a wider ``[u | z]``, and the
    int32 accumulator is the position-by-position sum, which reads
    nothing before each sequence's first position."""
    rng = np.random.default_rng(B * 1000 + S * 10 + C)
    cp = conv_params(rng, C, K, shift, bias=bias)
    out_spec = s8(exp=-6)
    xz = random_xz(rng, B, S, 2 * C + 3)
    x = xz[..., :C]
    assert not x.is_contiguous()
    ref, spec = run_task(BK._lm_conv1d, xz, cp, out_spec)
    assert spec == out_spec
    table = BK.conv_silu_table(cp, out_spec)
    got = causal_conv1d_op(x, cp.wq, cp.bq, shift, table)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert torch.equal(got, ref)
    via_impl, _ = run_task(BK._cuda_conv1d, xz, cp, out_spec,
                           packed={"l0.conv": table})
    assert torch.equal(via_impl, ref)
    # the accumulator, and the first K - 1 positions of every sequence
    acc = BK.causal_conv_i32(x, cp.wq, cp.bq)
    assert torch.equal(acc.to(torch.int64), conv_loops(x, cp.wq, cp.bq))
    for b in range(B):
        alone = causal_conv1d_op(x[b:b + 1], cp.wq, cp.bq, shift, table)
        assert torch.equal(alone[0], got[b])
    # the requantize clamps somewhere at these biases and shifts
    codes = Q.requantize_shift(acc, 0, s8(exp=shift))
    assert int(codes.min()) == -128 or int(codes.max()) == 127


def test_plain_version_requantizes_as_requantize_shift():
    """Codes through the identity table are ``Q.requantize_shift`` of the
    accumulator, at every shift sign."""
    rng = np.random.default_rng(11)
    ident = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    x = random_xz(rng, 2, 6, 20)
    for shift in (-3, 0, 1, 5, 12):
        cp = conv_params(rng, 20, 4, shift, bias=2 ** 9)
        acc = BK.causal_conv_i32(x, cp.wq, cp.bq)
        assert torch.equal(
            causal_conv1d_op(x, cp.wq, cp.bq, shift, ident),
            Q.requantize_shift(acc, cp.product_exp, cp.y_spec))


def test_cuda_impl_needs_the_table_built_at_lower_time():
    rng = np.random.default_rng(1)
    cp = conv_params(rng, 8, 4, 3)
    with pytest.raises(lowering.LoweringError, match="SiLU table"):
        run_task(BK._cuda_conv1d, random_xz(rng, 1, 4, 16), cp, s8())


def test_pack_lm_weights_builds_one_table_a_conv():
    """At lower time: one table a conv task, on the conv's grids and its
    consumer's, beside the packed matmul weights."""
    from repro_torch.compile import (lm_config, optimized_graph, plan_lm)
    from repro_torch.configs import get_smoke_config

    cfg = lm_config(get_smoke_config("falcon-mamba-7b"), 16,
                    family="mamba1")
    d, di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    gen = torch.Generator().manual_seed(2)
    shapes = dict(norm=(d,), w_in=(d, 2 * di), conv_w=(cfg.conv_kernel, di),
                  conv_b=(di,), w_x=(di, R + 2 * N), w_dt=(R, di),
                  dt_bias=(di,), A_log=(di, N), D=(di,), w_out=(di, d))
    layers = [LP.quantize_mamba1_layer(
        lambda name: torch.randn(shapes[name], generator=gen) * 0.1)
        for _ in range(cfg.num_layers)]
    params = LP.quantize_mamba1(torch.randn(cfg.vocab_size, d), layers,
                                torch.ones(d), torch.randn(d, cfg.vocab_size))
    plan = plan_lm(optimized_graph(cfg), params)
    packed = BK.pack_lm_weights(plan, params)
    convs = [t for t in plan.tasks if t.kind == "conv1d"]
    assert len(convs) == cfg.num_layers
    xspecs = BK.consumer_xspecs(plan, params)
    for t in convs:
        cp = params.layers[t.layer].conv
        assert torch.equal(packed[t.node],
                           BK.conv_silu_table(cp, xspecs[t.output]))


# -- the wrapper's checks ----------------------------------------------------


def _ops(C=16, K=4):
    return (torch.zeros(2, 5, C, dtype=torch.int8),
            torch.zeros(K, C, dtype=torch.int8),
            torch.zeros(C, dtype=torch.int32), 3,
            torch.zeros(256, dtype=torch.int8))


@pytest.mark.parametrize("arg,value,match", [
    (0, torch.zeros(2, 5, 16, dtype=torch.int16), "x must be torch.int8"),
    (0, torch.zeros(5, 16, dtype=torch.int8), "x must be"),
    (1, torch.zeros(4, 16, dtype=torch.int32), "wq must be torch.int8"),
    (1, torch.zeros(5, 16, dtype=torch.int8), "1 <= K <= 4"),
    (1, torch.zeros(4, 15, dtype=torch.int8), "wq must be"),
    (2, torch.zeros(16, dtype=torch.int16), "bq must be torch.int32"),
    (2, torch.zeros(17, dtype=torch.int32), "bq must be"),
    (3, 40, "shift=40"),
    (3, 2.0, "shift=2.0"),
    (4, torch.zeros(255, dtype=torch.int8), "table must be"),
    (4, torch.zeros(256, dtype=torch.uint8), "table must be torch.int8"),
])
def test_wrapper_refuses_wrong_operands(arg, value, match):
    ops = list(_ops())
    ops[arg] = value
    with pytest.raises(ValueError, match=match):
        causal_conv1d_op(*ops)


def test_wrapper_refuses_other_devices():
    ops = [t.to("meta") if isinstance(t, torch.Tensor) else t
           for t in _ops()]
    with pytest.raises(ValueError, match="unsupported device"):
        causal_conv1d_op(*ops)


def test_op_is_a_counted_wrapper():
    assert causal_conv1d_op in read_launches()
    assert set(causal_conv1d_op.launches_by_path) == {"vector", "bytewise"}


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [4, -1])
def test_kernel_is_the_chain_at_the_cell_shape(dev, shift):
    """falcon-mamba-7b.p4x512's conv: x the first 8,192 columns of a
    (4, 512, 16384) ``[u | z]``, the 16-byte path, bitwise the plain chain
    on the card (``_lm_conv1d``) and the op's plain version."""
    rng = np.random.default_rng(2 ** 31 + 5 + shift)
    B, S, C = 4, 512, 8192
    cp = conv_params(rng, C, 4, shift, dev=dev)
    out_spec = s8(exp=-5)
    xz = random_xz(rng, B, S, 2 * C, dev)
    table = BK.conv_silu_table(cp, out_spec)
    before = causal_conv1d_op.launches_by_path["vector"]
    got = causal_conv1d_op(xz[..., :C], cp.wq, cp.bq, shift, table)
    torch.cuda.synchronize()
    assert causal_conv1d_op.launches_by_path["vector"] == before + 1
    ref, _ = run_task(BK._lm_conv1d, xz, cp, out_spec)
    assert torch.equal(got, ref)
    assert torch.equal(got, causal_conv1d_ref(xz[..., :C], cp.wq, cp.bq,
                                              shift, table))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,K,shift,bias", CASES)
def test_kernel_is_the_chain_at_ragged_shapes(dev, B, S, C, K, shift, bias):
    """Odd channel counts and strides (the byte-wise path) and short
    sequences, bitwise the chain; one launch a call."""
    rng = np.random.default_rng(B * 1000 + S * 10 + C)
    cp = conv_params(rng, C, K, shift, dev=dev, bias=bias)
    out_spec = s8(exp=-6)
    xz = random_xz(rng, B, S, 2 * C + 3, dev)
    table = BK.conv_silu_table(cp, out_spec)
    before = causal_conv1d_op.launches
    bytewise = causal_conv1d_op.launches_by_path["bytewise"]
    got = causal_conv1d_op(xz[..., :C], cp.wq, cp.bq, shift, table)
    torch.cuda.synchronize()
    assert causal_conv1d_op.launches == before + 1
    assert causal_conv1d_op.launches_by_path["bytewise"] == bytewise + 1
    ref, _ = run_task(BK._lm_conv1d, xz, cp, out_spec)
    assert torch.equal(got, ref)


VECTOR_CASES = [
    # (B, S, C, K, shift): channels and row strides multiples of 16
    (2, 5, 16, 2, 3),       # S % 4 != 0: the last run ends inside the batch
    (3, 7, 64, 1, 2),       # one tap: three zero taps in front
    (1, 3, 32, 4, -1),      # shorter than a run and than the window
    (2, 6, 48, 3, 0),       # three taps, a ragged last run
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,K,shift", VECTOR_CASES)
def test_kernel_vector_path_at_short_sequences(dev, B, S, C, K, shift):
    """The 16-byte path's sequence tail and short windows: x out of a
    [u | z] of width 2C, bitwise the chain, one launch on that path."""
    rng = np.random.default_rng(B * 1000 + S * 10 + C + K)
    cp = conv_params(rng, C, K, shift, dev=dev)
    out_spec = s8(exp=-6)
    xz = random_xz(rng, B, S, 2 * C, dev)
    table = BK.conv_silu_table(cp, out_spec)
    before = dict(causal_conv1d_op.launches_by_path)
    got = causal_conv1d_op(xz[..., :C], cp.wq, cp.bq, shift, table)
    torch.cuda.synchronize()
    assert causal_conv1d_op.launches_by_path == dict(
        before, vector=before["vector"] + 1)
    ref, _ = run_task(BK._lm_conv1d, xz, cp, out_spec)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_kernel_launch_count_rises_by_one_a_call(dev):
    rng = np.random.default_rng(3)
    cp = conv_params(rng, 64, 4, 3, dev=dev)
    table = BK.conv_silu_table(cp, s8())
    xz = random_xz(rng, 2, 32, 128, dev)
    before = causal_conv1d_op.launches
    for i in range(3):
        causal_conv1d_op(xz[..., :64], cp.wq, cp.bq, 3, table)
        assert causal_conv1d_op.launches == before + i + 1
    torch.cuda.synchronize()
