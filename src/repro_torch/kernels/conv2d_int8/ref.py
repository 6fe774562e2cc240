"""Plain PyTorch versions of the general int8 conv.

  * :func:`conv2d_int8_ref` — the oracle on *pre-padded* input, a copy of
    the JAX package's: VALID conv, then bias and skip added to the int32
    accumulator, optional ReLU, then, when ``out_shift`` is given, the
    rounding shift ``(acc + half) >> s`` (only for ``s > 0``) and a clip
    to u8 (``relu``) or s8.
  * :func:`conv2d_int8_plain` — the plain version of the kernel: the JAX
    wrapper's pad ``((f-1)//2, f-1-(f-1)//2)`` on each spatial dim at every
    stride (not ``lax`` SAME, which pads (0, 1) for a 3x3 conv at stride 2
    on an even size), then :func:`conv2d_int8_ref`.
  * :func:`conv2d_int8_tiled` — the walk of the kernel's tensor-core path
    (tests only): row bands, the staged input rows with their halo, the
    filter in mma fragment order (:func:`fragment_filter`), K in tap
    order, the accumulator started at bias + skip.

The conv is a float64 ``F.conv2d``: every product and partial sum is an
integer far below 2^53, so no order of summation rounds.  The sum is
brought to int32 through int64, so it wraps as an int32 sum would; the
bias, skip and rounding adds are int32 and wrap too.
"""
import torch
import torch.nn.functional as F


def conv2d_int8_ref(x, w, b, skip=None, *, stride=1, relu=False,
                    out_shift=None):
    """x: (N,Hp,Wp,C) int8/uint8 already padded; w: (fh,fw,C,O) int8; b:
    (O,) integer; skip: optional (N,OH,OW,O) int32.  Returns the int32 map,
    or u8 (``relu``) / s8 when ``out_shift`` is given."""
    acc = F.conv2d(x.to(torch.float64).permute(0, 3, 1, 2),
                   w.to(torch.float64).permute(3, 2, 0, 1), stride=stride)
    acc = torch.round(acc).to(torch.int64).to(torch.int32)
    acc = acc.permute(0, 2, 3, 1) + b.to(torch.int32)
    if skip is not None:
        acc = acc + skip.to(torch.int32)
    return epilogue(acc, relu=relu, out_shift=out_shift)


def epilogue(acc, *, relu, out_shift):
    """int32 accumulator -> output: optional ReLU, then the int32 map
    (``out_shift`` None) or the rounding shift (only for ``out_shift >
    0``) and the clip to u8 (``relu``) or s8."""
    if relu:
        acc = torch.clamp_min(acc, 0)
    if out_shift is None:
        return acc.contiguous()
    if out_shift > 0:
        acc = (acc + (1 << (out_shift - 1))) >> out_shift
    if relu:
        return torch.clamp(acc, 0, 255).to(torch.uint8).contiguous()
    return torch.clamp(acc, -128, 127).to(torch.int8).contiguous()


def conv_pad(f: int):
    """``(lo, hi)`` zero pad of one spatial dim for a filter of size ``f``,
    as the JAX wrapper ``conv2d_int8_op`` applies it at every stride."""
    return (f - 1) // 2, f - 1 - (f - 1) // 2


def conv2d_int8_plain(x, w, b, skip=None, *, stride=1, relu=False,
                      out_shift=None):
    """x: (N,H,W,C) int8/uint8 unpadded; the rest as
    :func:`conv2d_int8_ref`.  Output (N, (H-1)//stride+1, (W-1)//stride+1,
    O)."""
    (pt, pb), (pl, pr) = conv_pad(w.shape[0]), conv_pad(w.shape[1])
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).permute(0, 2, 3, 1)
    return conv2d_int8_ref(xp, w, b, skip, stride=stride, relu=relu,
                           out_shift=out_shift)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def fragment_filter(w: torch.Tensor) -> torch.Tensor:
    """The (fh, fw, C, O) int8 filter as the tensor-core path stages it in
    shared memory: zero padded to kp = C and np = O rounded up to 16, then
    [tap][k / ks][n / 16][lane 4 g + t][nt][j][4 bytes], where the bytes
    are k = (k / ks) ks + 16 j + 4 t .. + 3 of output channel 16 (n / 16) +
    8 nt + g and ks = 32 when kp is a multiple of 32, else 16: the mma B
    fragment of each lane, the packed layout of the block kernels
    (``resblock_fused/ops.py:pack_conv``).  Flat int8."""
    fh, fw, c, o = w.shape
    taps, kp, np_ = fh * fw, _round16(c), _round16(o)
    ks = 16 if kp % 32 else 32
    full = torch.zeros((taps, kp, np_), dtype=torch.int8)
    full[:, :c, :o] = w.reshape(taps, c, o).cpu()
    # k = kt ks + 16 j + 4 t + byte;  n = 16 np + 8 nt + g
    v = full.reshape(taps, kp // ks, ks // 16, 4, 4, np_ // 16, 2, 8)
    return v.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(-1)


def filter_from_fragments(frag: torch.Tensor, fh, fw, c, o) -> torch.Tensor:
    """The (taps, kp, np) K x N matrices of each tap read back from
    :func:`fragment_filter`'s order, as the mma steps consume them."""
    taps, kp, np_ = fh * fw, _round16(c), _round16(o)
    ks = 16 if kp % 32 else 32
    v = frag.reshape(taps, kp // ks, np_ // 16, 8, 4, 2, ks // 16, 4)
    return v.permute(0, 1, 6, 4, 7, 2, 5, 3).reshape(taps, kp, np_)


def conv2d_int8_tiled(x, w, b, skip=None, *, stride=1, relu=False,
                      out_shift=None, band, ng=None):
    """The conv computed as the kernel's tensor-core path decomposes it
    (tests only; the wrapper's plain version is :func:`conv2d_int8_plain`):
    each thread block's ``band`` output rows (the last band ragged) and
    ``ng`` output channels (default: all, rounded up to 16) from the input
    rows it stages — padded rows ``r0 * stride`` to ``(r0 + nb - 1) *
    stride + fh - 1``, zero outside the image (the wrapper's pad, at every
    stride) — with channels zero padded to 16; its filter slice read back
    from :func:`fragment_filter` (zero past O); the accumulator started at
    bias + skip, then one K = ks product a step, taps in order; the int32
    sum wrapping as the tensor cores' does; then :func:`epilogue`."""
    n, h, wd, c = x.shape
    fh, fw, _, o = w.shape
    (pt, _), (pl, pr) = conv_pad(fh), conv_pad(fw)
    oh, ow = (h - 1) // stride + 1, (wd - 1) // stride + 1
    kp, np_ = _round16(c), _round16(o)
    ng = ng or np_
    ks = 16 if kp % 32 else 32
    wpad = F.pad(w, (0, np_ - o))
    xk = F.pad(x.to(torch.int64), (0, kp - c, pl, pr))  # padded columns
    bias = F.pad(b.to(torch.int64), (0, np_ - o))
    sk = None if skip is None else \
        F.pad(skip.to(torch.int64), (0, np_ - o))
    outs = []
    for r0 in range(0, oh, band):
        nb = min(band, oh - r0)
        lo = r0 * stride - pt                      # image row of stored row 0
        hi = lo + (nb - 1) * stride + fh
        body = xk[:, max(lo, 0):min(hi, h)]
        plane = F.pad(body, (0, 0, 0, 0, max(-lo, 0), max(hi - h, 0)))
        groups = []
        for n0 in range(0, np_, ng):              # one thread block each
            wk = filter_from_fragments(fragment_filter(
                wpad[..., n0:n0 + ng]), fh, fw, c, ng).to(torch.int64)
            acc = bias[n0:n0 + ng].expand(n, nb, ow, ng).clone()
            if sk is not None:
                acc += sk[:, r0:r0 + nb, :, n0:n0 + ng]
            for tap in range(fh * fw):
                kh, kw = divmod(tap, fw)
                a = plane[:, kh:kh + (nb - 1) * stride + 1:stride,
                          kw:kw + (ow - 1) * stride + 1:stride]
                for k0 in range(0, kp, ks):
                    acc += a[..., k0:k0 + ks] @ wk[tap, k0:k0 + ks]
            groups.append(acc)
        acc = torch.cat(groups, dim=-1)[..., :o].to(torch.int32)
        outs.append(epilogue(acc, relu=relu, out_shift=out_shift))
    return torch.cat(outs, dim=1)
