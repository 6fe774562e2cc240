"""Plain reference of the ``mamba1`` cells: Falcon-Mamba-7B's published
Mamba1 stack on the paper's int8 pow2 scheme, written from the model's
description (TII's ``config.json`` and arXiv:2410.05355) and the scheme's,
in plain PyTorch.  It imports nothing of the port.

For residual input h, per layer (RMSNorm eps ``layer_norm_epsilon``, the
rms of dt, B and C weightless with eps ``mixer_rms_eps``):

    x       = RMSNorm(h) * g
    [u | z] = x W_in                             (no bias)
    u'      = SiLU(causal_depthwise_conv_k(u) + b_conv)
    [d|B|C] = u' W_x                             (no bias)
    d, B, C = rms(d), rms(B), rms(C)
    Delta   = softplus(d W_dt + b_dt)
    A       = -exp(A_log)
    s_t     = exp(Delta_t A) s_{t-1} + (Delta_t u'_t) B_t
    y_t     = s_t C_t + D u'_t
    h'      = h + (y * SiLU(z)) W_out            (no bias)

and the logits ``RMSNorm(h_L) * g_f U`` of the last position.

The int8 scheme (the configuration's ``assumed.grids``): every weight on
its own pow2 int8 grid, ``ceil(log2(amax / 127))``, rounded half away from
zero (``quant``, in float32 arithmetic); every bias int16 on the finest
pow2 grid that holds it and no finer than its product domain, shifted
onto that domain; the matmul and conv
inputs and outputs int8 on the fixed grids; each product an exact integer
sum (here in float64, exact below 2^53) plus the bias, requantized by
``floor(acc / 2^s + 1/2)``, clipped; the residual add folded into
``W_out``'s accumulator (h shifted onto the product domain); the norms,
SiLU, softplus, the scan, the D term and the gate computed in ``dtype``
between the int8 grids: each quantizes back onto the grid of the product
that reads it.

The interludes are float32 in the published order, each product and sum
rounded on its own (``s_t C_t`` summed over N in order from 0), not
float64: a one-step difference of one int8 code, which float rounding
decides near a grid point, changes the codes of the next product, and
over 64 blocks such steps reach most codes of the residual stream, so a
float64 reference would stand as far from a sound float32 program as a
bfloat16 one.  In float32 and in this order the reference gives the
program's codes.  The head's norm is float32 too, its product float64.

Departures from the published model: the int8 grids above (the model is
bfloat16); float32 interludes; only the last position's logits; random
weights from the seed (``draw``: each matrix a function of the seed, the
layer and its name, so any layer can be drawn again); the SiLU'd conv
output is requantized (once onto the conv's grid, once onto ``W_x``'s
input grid).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

SEED_MASK = 2 ** 63 - 1
LAYER_MATRICES = ("norm", "w_in", "conv_w", "conv_b", "w_x", "w_dt",
                  "dt_bias", "A_log", "D", "w_out")
HEAD_MATRICES = ("embed", "final_norm", "unembed")
SCAN_CHUNK = 16         # steps whose decays are computed at once
PROMPT_BLOCK = 8        # prompts a block of the check


class Dims(NamedTuple):
    layers: int
    d: int
    di: int
    n: int
    r: int
    k: int
    vocab: int


def dims(cfg) -> Dims:
    return Dims(cfg["num_hidden_layers"], cfg["hidden_size"],
                cfg["intermediate_size"], cfg["state_size"],
                cfg["time_step_rank"], cfg["conv_kernel"], cfg["vocab_size"])


def _mix(*words) -> int:
    """splitmix64 over the words: the seed of one matrix's generator."""
    x = 0x9E3779B97F4A7C15
    for w in words:
        x = (x ^ (int(w) & (2 ** 64 - 1))) * 0xBF58476D1CE4E5B9 % 2 ** 64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB % 2 ** 64
        x ^= x >> 31
    return x & SEED_MASK


def generator(seed: int, layer: int, name: str, device) -> torch.Generator:
    """The generator of matrix ``name`` of ``layer`` (-1: the head's)."""
    index = (LAYER_MATRICES + HEAD_MATRICES).index(name)
    return torch.Generator(device=device).manual_seed(
        _mix(seed, layer + 1, index))


def draw(cfg, seed: int, layer: int, name: str, device) -> torch.Tensor:
    """One float32 weight of the seeded model (``assumed.init`` of the
    configuration): Mamba's S4D-real ``A_log``, ``D`` = 1, the dt bias
    the inverse softplus of a log-uniform Delta in [time_step_min,
    time_step_max] (floored at time_step_floor), ``W_dt`` uniform in
    +-dt_rank^-1/2, the conv's taps and bias uniform in +-K^-1/2 (PyTorch's
    default), the projections N(0, 1/fan_in) with ``W_out`` further over
    sqrt(layers) (Mamba's prenorm-residual rescale), the norm gains
    uniform in [0.9, 1.1), the embedding N(0, 1), the unembedding N(0,
    1/d)."""
    m = dims(cfg)
    gen = generator(seed, layer, name, device)
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=f32)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=f32)

    if name in ("norm", "final_norm"):
        return 0.9 + 0.2 * rand(m.d)
    if name == "embed":
        return randn(m.vocab, m.d)
    if name == "unembed":
        return randn(m.d, m.vocab) / math.sqrt(m.d)
    if name == "w_in":
        return randn(m.d, 2 * m.di) / math.sqrt(m.d)
    if name == "conv_w":
        return (2 * rand(m.k, m.di) - 1) / math.sqrt(m.k)
    if name == "conv_b":
        return (2 * rand(m.di) - 1) / math.sqrt(m.k)
    if name == "w_x":
        return randn(m.di, m.r + 2 * m.n) / math.sqrt(m.di)
    if name == "w_dt":
        return (2 * rand(m.r, m.di) - 1) / math.sqrt(m.r)
    if name == "dt_bias":
        lo = math.log(cfg["time_step_min"])
        hi = math.log(cfg["time_step_max"])
        dt = torch.exp(rand(m.di) * (hi - lo) + lo).clamp(
            min=cfg["time_step_floor"])
        return dt + torch.log(-torch.expm1(-dt))
    if name == "A_log":
        a = torch.arange(1, m.n + 1, dtype=f32, device=device)
        return torch.log(a).repeat(m.di, 1)
    if name == "D":
        return torch.ones(m.di, dtype=f32, device=device)
    if name == "w_out":
        return randn(m.di, m.d) / math.sqrt(m.di * m.layers)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# The int8 scheme, in float64 tensors that hold integers
# ---------------------------------------------------------------------------


def _round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def grid_exp(w, bits: int) -> int:
    """``ceil(log2(amax / (2^(bits-1) - 1)))``."""
    amax = max(float(w.abs().max()), 1e-12)
    return int(math.ceil(math.log2(amax / (2 ** (bits - 1) - 1))))


def quant(x, exp: int, bits: int = 8):
    """Integer codes of ``x`` on the grid ``2^exp``, clipped, as float64:
    rounded half away from zero in float32 arithmetic, ``floor(|x| 2^-exp
    + 1/2)``, which takes the largest float32 below 1/2 to 1."""
    q = _round_half_away(x.to(torch.float32) * 2.0 ** -exp)
    return q.to(torch.float64).clamp(-2 ** (bits - 1), 2 ** (bits - 1) - 1)


def weight(w, bits: int = 8):
    """``(codes, exp)`` of a weight on its own grid."""
    e = grid_exp(w, bits)
    return quant(w, e, bits), e


def bias(b, product_exp: int):
    """An int16 bias shifted onto the product domain (integer codes)."""
    e = max(product_exp, grid_exp(b, 16))
    return quant(b, e, 16) * 2.0 ** (e - product_exp)


def requant(acc, from_exp: int, to_exp: int):
    """Integer accumulator at ``2^from_exp`` onto the int8 grid ``2^to_exp``:
    ``floor(acc / 2^s + 1/2)`` for a right shift s, exact otherwise."""
    s = to_exp - from_exp
    q = acc * 2.0 ** -s if s <= 0 else torch.floor((acc + 2.0 ** (s - 1))
                                                   * 2.0 ** -s)
    return q.clamp(-128, 127)


def rms(x, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class Net(NamedTuple):
    cfg: dict
    seed: int
    device: torch.device
    w_bits: int
    dtype: torch.dtype


def prepare(params, cfg, bits=None, dtype=torch.float32) -> Net:
    """The reference of the seeded model ``params`` (``{"seed", "device"}``:
    the recipe; no float model is kept), at the weight width of ``bits``
    (``{"bw_w": 4}``: W4A8) and with its interludes in ``dtype``."""
    w_bits = (bits or {}).get("bw_w", 8)
    return Net(cfg, int(params["seed"]), torch.device(params["device"]),
               w_bits, dtype)


def layer_weights(net: Net, layer: int) -> dict:
    """One layer's weights drawn again and quantized: integer codes with
    their exponents, the float gains, ``A_log`` and ``D``."""
    g = net.cfg["assumed"]["grids"]
    out = {}

    def get(name):
        return draw(net.cfg, net.seed, layer, name, net.device)

    for name, x_exp in (("w_in", g["x"]), ("w_x", g["u"]),
                        ("w_dt", g["dn"]), ("w_out", g["y"]),
                        ("conv_w", g["xz"])):
        q, e = weight(get(name), net.w_bits)
        out[name] = (q, e)
        out[name + ".product_exp"] = x_exp + e
    out["dt_bias"] = bias(get("dt_bias"), out["w_dt.product_exp"])
    out["conv_b"] = bias(get("conv_b"), out["conv_w.product_exp"])
    for name in ("norm", "A_log", "D"):
        out[name] = get(name)
    return out


def _conv(u, taps, b):
    """Causal depthwise conv over dim 1, exact on integer codes."""
    K, S = taps.shape[0], u.shape[1]
    up = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    acc = b.expand_as(u).clone()
    for k in range(K):
        acc += up[:, k:k + S] * taps[k]
    return acc


def _scan(u, delta, A, B, C, D):
    """``s_t = exp(Delta_t A) s_{t-1} + (Delta_t u_t) B_t``, ``y_t = s_t
    C_t + D u_t``, from s = 0, in the dtype of the operands, each product
    and sum rounded on its own, the N terms of ``s_t C_t`` summed in order
    from 0."""
    n, S, di = u.shape
    N = A.shape[1]
    s = torch.zeros((n, di, N), dtype=u.dtype, device=u.device)
    du = delta * u
    ys = []
    for t0 in range(0, S, SCAN_CHUNK):
        t1 = min(S, t0 + SCAN_CHUNK)
        dA = torch.exp(delta[:, t0:t1, :, None] * A)
        dBu = du[:, t0:t1, :, None] * B[:, t0:t1, None, :]
        states = []
        for j in range(t1 - t0):
            s = dA[:, j] * s + dBu[:, j]
            states.append(s)
        p = torch.stack(states, dim=1) * C[:, t0:t1, None, :]
        y = torch.zeros_like(p[..., 0])
        for k in range(N):
            y = y + p[..., k]
        ys.append(y)
    return torch.cat(ys, dim=1) + u * D


def _layer(net: Net, w: dict, h, cfg, record=None):
    """One block on a block of prompts: residual codes in, codes out;
    ``record`` (a dict), where given, gets the block's int8 codes by the
    name of the port's tensor."""
    g, dt = cfg["assumed"]["grids"], net.dtype
    m = dims(cfg)
    eps, reps = cfg["layer_norm_epsilon"], cfg["mixer_rms_eps"]

    def deq(q, exp):
        return (q * 2.0 ** exp).to(dt)

    x = quant(rms(deq(h, g["h"]), eps) * w["norm"].to(dt), g["x"])
    xz = requant(x @ w["w_in"][0], w["w_in.product_exp"], g["xz"])
    c = requant(_conv(xz[..., :m.di], w["conv_w"][0], w["conv_b"]),
                w["conv_w.product_exp"], g["conv"])
    u = quant(silu(deq(c, g["conv"])), g["u"])
    dbc = requant(u @ w["w_x"][0], w["w_x.product_exp"], g["dbc"])
    d, B, C = torch.split(deq(dbc, g["dbc"]), (m.r, m.n, m.n), dim=-1)
    dn = quant(rms(d, reps), g["dn"])
    dtq = requant(dn @ w["w_dt"][0] + w["dt_bias"], w["w_dt.product_exp"],
                  g["dt"])
    A = -torch.exp(w["A_log"].to(dt))
    y = _scan(deq(u, g["u"]), softplus(deq(dtq, g["dt"])), A, rms(B, reps),
              rms(C, reps), w["D"].to(dt))
    y = quant(y * silu(deq(xz[..., m.di:], g["xz"])), g["y"])
    pe = w["w_out.product_exp"]
    skip = h * 2.0 ** (g["h"] - pe) if g["h"] >= pe else \
        torch.floor((h + 2.0 ** (pe - g["h"] - 1)) * 2.0 ** (g["h"] - pe))
    if record is not None:
        record.update(x=x, xz=xz, u=u, dbc=dbc, dn=dn, dt=dtq, y=y)
    return requant(y @ w["w_out"][0] + skip, pe, g["h"])


def features(net: Net, tokens) -> torch.Tensor:
    """The last block's output codes (n, S, d), float64, of token ids
    ``tokens`` (n, S): layer by layer (each drawn once), the prompts in
    blocks of ``PROMPT_BLOCK``."""
    cfg, dev = net.cfg, net.device
    tokens = tokens.to(dev).long()
    emb = draw(cfg, net.seed, -1, "embed", dev)
    h = quant(emb[tokens], cfg["assumed"]["grids"]["h"])
    del emb
    for layer in range(dims(cfg).layers):
        w = layer_weights(net, layer)
        h = torch.cat([_layer(net, w, h[i:i + PROMPT_BLOCK], cfg)
                       for i in range(0, h.shape[0], PROMPT_BLOCK)])
        del w
    return h


def head(net: Net, h) -> torch.Tensor:
    """Logits (n, vocab) of the last position of codes ``h``: the final
    norm in ``dtype``, its product with the unembedding in float64."""
    cfg, dt = net.cfg, net.dtype
    g_f = draw(cfg, net.seed, -1, "final_norm", net.device).to(dt)
    U = draw(cfg, net.seed, -1, "unembed", net.device)
    x = (h[:, -1] * 2.0 ** cfg["assumed"]["grids"]["h"]).to(dt)
    x = rms(x, cfg["layer_norm_epsilon"]) * g_f
    return x.to(torch.float64) @ U.to(torch.float64)


def logits(net: Net, tokens) -> torch.Tensor:
    """The logits (n, vocab) of the last position, float64."""
    return head(net, features(net, tokens))
