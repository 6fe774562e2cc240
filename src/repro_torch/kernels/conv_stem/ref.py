"""Plain PyTorch version of the stem conv kernel (SAME conv + requant).

:func:`conv_stem_banded` mirrors the banded path of ``csrc/conv_stem.cu``
for the tests."""
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import conv_i32, requant_u8


def conv_stem_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  shift: int) -> torch.Tensor:
    """x: (N,H,W,Cin) uint8 unpadded; w: (3,3,Cin,Cout) int8; b: (Cout,)
    integer.  Returns (N,H,W,Cout) uint8."""
    return requant_u8(conv_i32(x, w) + b.to(torch.int32), shift)


def stem_words(w: torch.Tensor) -> torch.Tensor:
    """The filter as the banded path stages it: (9, Cout, 4) int8, the 4
    bytes of tap t and output channel c being input channels 0..3 (zero
    past Cin): one dp4a word, [tap][cout] in shared memory."""
    cin, cout = w.shape[2], w.shape[3]
    taps = w.reshape(9, cin, cout).permute(0, 2, 1)
    return F.pad(taps, (0, 4 - cin))


def conv_stem_banded(x, w, b, *, shift: int, band: int) -> torch.Tensor:
    """The stem computed as the banded path decomposes it (tests only; the
    wrapper's plain version is :func:`conv_stem_ref`): each thread block's
    ``band`` output rows (the last band ragged) from a plane of its input
    rows ``r0 - 1 .. r0 + nb`` and the image's columns, each pixel widened
    to one 4-byte word, with an explicit zero ring; the filter as
    :func:`stem_words`; the accumulator started at the bias, then the 9
    taps in order, each one 4-byte dot product of a plane word with a
    filter word; then ``requant_u8``."""
    n, h, wd, cin = x.shape
    words = stem_words(w).to(torch.int64)             # (9, cout, 4)
    xw = F.pad(x, (0, 4 - cin)).to(torch.int64)       # one word a pixel
    outs = []
    for r0 in range(0, h, band):
        nb = min(band, h - r0)
        lo, hi = r0 - 1, r0 + nb + 1                  # stored rows
        body = xw[:, max(lo, 0):min(hi, h)]
        plane = F.pad(body, (0, 0, 1, 1, max(-lo, 0), max(hi - h, 0)))
        acc = b.to(torch.int64).expand(n, nb, wd, -1).clone()
        for tap in range(9):
            kh, kw = divmod(tap, 3)
            v = plane[:, kh:kh + nb, kw:kw + wd]        # (n, nb, w, 4)
            acc += torch.einsum("nhwk,ck->nhwc", v, words[tap])
        outs.append(requant_u8(acc.to(torch.int32), shift))
    return torch.cat(outs, dim=1)
