"""Plain PyTorch version of the block-chain kernel: the same chain run as
the *unfused* per-block dataflow — the stem conv (SAME), then one
``resblock_ref`` per link, every boundary activation materialized.

:func:`block_chain_banded` mirrors the CUDA kernel's split of every map
into row bands for the tests."""
import torch
import torch.nn.functional as F

from repro_torch.core.quant import shift_align
from repro_torch.kernels.common import requant_u8
from repro_torch.kernels.conv_stem.ref import conv_stem_ref
from repro_torch.kernels.resblock_fused.ref import (conv_valid_i32,
                                                    resblock_ref, rows_of)


def block_chain_ref(x, blocks, *, specs, stem=None, stem_shift=None):
    """Mirrors :func:`..ops.block_chain_op` (unpadded input, same
    blocks/specs layout)."""
    h = x
    if stem is not None:
        h = conv_stem_ref(h, stem[0], stem[1], shift=stem_shift)
    for s, ws in zip(specs, blocks):
        wd, bd = (ws[4], ws[5]) if s.has_ds else (None, None)
        h = resblock_ref(h, ws[0], ws[1], ws[2], ws[3], wd, bd,
                         stride=s.stride, shift0=s.shift0, shift1=s.shift1,
                         skip_shift=s.skip_shift)
    return h


def _band_conv3x3(slab, w, b, stride, shift):
    """requant_u8(conv3x3(band) + b) of one band from its slab: the band's
    own rows with one halo row either side (zero at the map's edges), its
    columns padded as SAME pads them ((1, 1), or (0, 1) at stride 2, whose
    rows start at the band's first own row)."""
    if stride == 1:
        xs = F.pad(slab, (0, 0, 1, 1))
    else:
        xs = F.pad(slab[:, 1:], (0, 0, 0, 1))
    return requant_u8(conv_valid_i32(xs, w, stride) + b.to(torch.int32),
                      shift)


def block_chain_banded(x, blocks, *, specs, stem=None, stem_shift=None,
                       split):
    """The chain computed as ``csrc/block_chain.cu`` splits it (tests
    only; the wrapper's plain version is :func:`block_chain_ref`): every
    map in ``split`` equal row bands, each band of every conv computed
    alone from its own rows plus the one halo row either side that the
    kernel copies from the neighbouring bands (zero at the map's edges);
    a stride-2 link's output band r reads exactly input band r and the
    first row of band r + 1.  ``split`` must divide every map height."""
    from repro_torch.tune.space import chain_bands

    def banded(src, fn, n_out):
        """fn(slab, r) for each band r of src, the bands stacked."""
        assert src.shape[1] % split == 0 and n_out % split == 0
        outs = [fn(rows_of(src, r0 - 1, r0 + nb + 1), r)
                for r, (r0, nb) in enumerate(chain_bands(src.shape[1],
                                                         split))]
        assert all(o.shape[1] == n_out // split for o in outs)
        return torch.cat(outs, dim=1)

    h = x
    if stem is not None:
        h = banded(h, lambda slab, r: _band_conv3x3(
            slab, stem[0], stem[1], 1, stem_shift), h.shape[1])
    for s, ws in zip(specs, blocks):
        nbi = h.shape[1] // split
        oh = h.shape[1] // s.stride
        y0 = banded(h, lambda slab, r: _band_conv3x3(
            slab, ws[0], ws[1], s.stride, s.shift0), oh)

        def conv1(slab, r, h=h, nbi=nbi):
            own = h[:, r * nbi:(r + 1) * nbi:s.stride, ::s.stride]
            if s.has_ds:
                skip = shift_align(conv_valid_i32(own, ws[4]) +
                                   ws[5].to(torch.int32), s.skip_shift)
            else:
                skip = shift_align(own, s.skip_shift)
            acc = conv_valid_i32(F.pad(slab, (0, 0, 1, 1)), ws[2]) + \
                ws[3].to(torch.int32) + skip
            return requant_u8(acc, s.shift1)

        h = banded(y0, conv1, oh)
    return h
