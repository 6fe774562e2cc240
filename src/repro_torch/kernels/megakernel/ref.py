"""Plain PyTorch version of the block-chain kernel: the same chain run as
the *unfused* per-block dataflow — the stem conv (SAME), then one
``resblock_ref`` per link, every boundary activation materialized."""
from repro_torch.kernels.conv_stem.ref import conv_stem_ref
from repro_torch.kernels.resblock_fused.ref import resblock_ref


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
