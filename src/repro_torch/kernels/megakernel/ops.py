"""Public wrapper of the block-chain kernel (``csrc/block_chain.cu``).

A CPU tensor goes to the plain version (``ref.block_chain_ref``); a CUDA
tensor launches the kernel, or the call raises.  The operand layout is the
JAX wrapper's: an unpadded input, one ``(w0, b0, w1, b1[, wd, bd])`` tuple
per chain link and a matching :class:`ChainBlockSpec` schedule.  The SAME
pad of the chain's first op is the kernel's, as is every later re-pad,
which happens on chip.  The shifts, static arguments of the JAX kernel,
are runtime arguments here and are range-checked.
``block_chain_op.launches`` counts kernel launches,
``block_chain_op.launches_by_path`` the same split by the links'
warp-item tiles (:data:`PATHS`): ``single`` where every link ran in m16 x
n16 items, ``tiled`` where any ran in a larger register tile
(``tune.space.chain_tiles``).

The kernel reads each link's filters and biases as one packed block
(``kernels.resblock_fused.ops.pack_block``).  :class:`ChainLaunch`
validates the chain, packs the links and builds the link table once, so
that a lowered forward (``compile/backends.py``) only allocates the output
and launches; :func:`block_chain_op` does both for a direct call.  The
thread blocks an image (the cluster size) come from the config's
``split`` when set, else from ``tune.space.chain_split``; a tuned tiling
whose thread block exceeds the shared-memory budget, or whose clusters
the card cannot run, raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List

import torch

from repro_torch.core.dataflow import (STEM_CIN, BlockShape,
                                       chain_task_smem_bytes)
from repro_torch.kernels import _build
from repro_torch.kernels.common import (check_bias, check_shift,
                                        check_weight, sm_ids_ptr)
from repro_torch.kernels.megakernel.ref import block_chain_ref
from repro_torch.kernels.resblock_fused.ops import (MAX_CH, PATHS,
                                                    pack_block, tile_path)
from repro_torch.tune.config import DEFAULT, KernelConfig
from repro_torch.tune.space import (SMEM_BUDGET, chain_split, chain_splits,
                                    chain_tiles)

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_LINKS = 32          # kMaxLinks in csrc/block_chain.cu


@dataclasses.dataclass(frozen=True)
class ChainBlockSpec:
    """Static per-link schedule of one chain link (hashable).  Shapes come
    from the weight operands; only the dataflow decisions live here."""
    stride: int
    has_ds: bool
    shift0: int
    shift1: int
    skip_shift: int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("block_chain")
    ints, ptrs = ctypes.POINTER(_I), ctypes.POINTER(_P)
    lib.block_chain_launch.argtypes = [_P] * 4 + [_I] * 3 + [ints, ptrs] + \
        [_I] * 4 + [_P] * 2
    lib.block_chain_launch.restype = _I
    lib.block_chain_smem_bytes.argtypes = [ints, _I, _I, _I, _I, _I]
    lib.block_chain_smem_bytes.restype = _I
    lib.block_chain_max_clusters.argtypes = [_I, _I]
    lib.block_chain_max_clusters.restype = _I
    return lib


def _link_ints(shapes: List[BlockShape], specs=None, tiles=None):
    """The kernel's link table: one row of kLinkInts ints a link, the
    warp-item tile (MT, NT) last ((1, 1) where ``tiles`` is None)."""
    rows = []
    for j, b in enumerate(shapes):
        s = specs[j] if specs is not None else None
        rows += [b.h, b.w, b.ich, b.och, b.stride, int(b.downsample),
                 s.shift0 if s else 0, s.shift1 if s else 0,
                 s.skip_shift if s else 0, *(tiles[j] if tiles else (1, 1))]
    return (_I * len(rows))(*rows)


def smem_bytes(shapes: List[BlockShape], batch_tile: int,
               stem_och: int = 0, split: int = 1) -> int:
    """Dynamic shared memory one thread block of the kernel uses for a
    chain of ``shapes`` with ``split`` thread blocks an image (the kernel's
    own ``block_chain_smem_bytes``; the planner's
    ``core.dataflow.chain_task_smem_bytes`` is the same formula)."""
    return _lib().block_chain_smem_bytes(
        _link_ints(shapes), len(shapes), STEM_CIN if stem_och else 0,
        stem_och, batch_tile, split)


def max_clusters(split: int, smem: int) -> int:
    """Clusters of ``split`` thread blocks of ``smem`` bytes that the
    current GPU runs at once (``cudaOccupancyMaxActiveClusters`` on the
    kernel): the ``capacity`` of ``tune.space.chain_split``."""
    n = _lib().block_chain_max_clusters(split, smem)
    if n < 0:
        _build.check(_lib(), -n, "block_chain occupancy")
    return n


def _check_chain(in_shape, blocks, specs, stem, stem_shift
                 ) -> List[BlockShape]:
    """Validate the operands of a chain on an (h, w, c) input; returns the
    chain's link shapes."""
    if not specs or len(blocks) != len(specs):
        raise ValueError(f"blocks/specs mismatch: {len(blocks)} operand "
                         f"tuples for {len(specs)} specs (need one per "
                         f"link, at least one link)")
    if (stem is None) != (stem_shift is None):
        raise ValueError("pass stem and stem_shift together (fused stem) "
                         "or neither")
    h, w, c = in_shape
    if stem is not None:
        sw, sb = stem
        if sw.dim() != 4:
            raise ValueError(f"stem w must be (3,3,{c},Cout), got "
                             f"{tuple(sw.shape)}")
        check_weight("stem w", sw, (3, 3, c, sw.shape[3]))
        check_bias("stem b", sb, sw.shape[3])
        check_shift("stem_shift", stem_shift)
        c = sw.shape[3]
    shapes = []
    for j, (s, ws) in enumerate(zip(specs, blocks)):
        want = 6 if s.has_ds else 4
        if len(ws) != want:
            raise ValueError(
                f"link {j}: has_ds={s.has_ds} takes {want} operands "
                f"(w0, b0, w1, b1{', wd, bd' if s.has_ds else ''}), got "
                f"{len(ws)}")
        if s.stride not in (1, 2):
            raise ValueError(f"link {j}: stride must be 1 or 2, got "
                             f"{s.stride}")
        if ws[0].dim() != 4:
            raise ValueError(f"link {j}: w0 must be (3,3,{c},Cout), got "
                             f"{tuple(ws[0].shape)}")
        cout = ws[0].shape[3]
        check_weight(f"link {j} w0", ws[0], (3, 3, c, cout))
        check_bias(f"link {j} b0", ws[1], cout)
        check_weight(f"link {j} w1", ws[2], (3, 3, cout, cout))
        check_bias(f"link {j} b1", ws[3], cout)
        if s.has_ds:
            check_weight(f"link {j} wd", ws[4], (1, 1, c, cout))
            check_bias(f"link {j} bd", ws[5], cout)
        elif s.stride != 1 or c != cout:
            raise ValueError(f"link {j}: identity skip needs stride 1 and "
                             f"Cin == Cout, got stride {s.stride}, "
                             f"{c} -> {cout}")
        if s.stride == 2 and (h % 2 or w % 2):
            # the (0, 1) pad at stride 2 matches SAME only for even sizes
            raise ValueError(f"link {j}: a stride-2 link needs even H/W "
                             f"to match SAME padding (0, 1), got {h}x{w}")
        for name in ("shift0", "shift1", "skip_shift"):
            check_shift(f"link {j} {name}", getattr(s, name))
        shapes.append(BlockShape(h=h, w=w, ich=c, och=cout,
                                 downsample=s.has_ds, stride=s.stride))
        h, w, c = h // s.stride, w // s.stride, cout
    operands = ([*stem] if stem is not None else []) + \
        [t for ws in blocks for t in ws]
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devices))}")
    return shapes


class ChainLaunch:
    """One block chain prepared for repeated launches on an ``in_shape`` =
    (h, w, c) input: the operands validated, the biases widened, and (on a
    GPU) every link packed, the link tables (:meth:`link_table`: one a
    split the chain can take, each link's warp-item tile in its row) and
    the packed blocks' pointer array built once.  A call takes x (N,h,w,c)
    uint8 and returns the last link's (N,oh,ow,Cout) uint8: on a CPU
    tensor the plain version, on a CUDA tensor one kernel launch.  The
    per-call path checks x's dtype, shape and layout, allocates the output
    and launches; the batch tile (``config``, snapped to a divisor of N)
    and the split (``config.split`` snapped to a legal split, else
    ``tune.space.chain_split`` with the card's :func:`max_clusters`) are
    looked up once per N."""

    def __init__(self, blocks, *, specs, in_shape, stem=None,
                 stem_shift=None, config: KernelConfig = None):
        specs, blocks = tuple(specs), tuple(tuple(ws) for ws in blocks)
        self.in_shape = tuple(int(v) for v in in_shape)
        self.shapes = _check_chain(self.in_shape, blocks, specs, stem,
                                   stem_shift)
        self.specs, self.stem_shift = specs, stem_shift
        self.blocks = tuple(tuple(t if t.dtype == torch.int8
                                  else t.to(torch.int32) for t in ws)
                            for ws in blocks)
        self.stem = None if stem is None else \
            (stem[0], stem[1].to(torch.int32))
        self.config = config or DEFAULT
        self.device = self.blocks[0][0].device
        self.stem_och = self.stem[0].shape[3] if stem is not None else 0
        self._tiles = {}
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"block_chain_op: unsupported device "
                             f"{self.device}")
        if len(specs) > MAX_LINKS:
            raise ValueError(f"block_chain kernel takes at most {MAX_LINKS} "
                             f"links, got {len(specs)}")
        if self.stem_och % 4 or any(b.ich % 4 or b.och % 4 or
                                    max(b.ich, b.och) > MAX_CH
                                    for b in self.shapes):
            raise ValueError(f"block_chain kernel needs block channel counts "
                             f"that are multiples of 4 and at most {MAX_CH}")
        if stem is not None and self.in_shape[2] > 4:
            raise ValueError(f"block_chain kernel takes a fused stem on at "
                             f"most 4 input channels, got "
                             f"{self.in_shape[2]}")
        if stem is not None and any(not t.is_contiguous() or
                                    t.data_ptr() % 4 for t in self.stem):
            raise ValueError("block_chain_op: stem operands must be "
                             "contiguous and 4-byte aligned")
        self.packed = [pack_block(*ws[:4], *(ws[4:] if s.has_ds
                                             else (None, None)))
                       for s, ws in zip(specs, self.blocks)]
        self.ptrs = (_P * len(self.packed))(*[p.data_ptr()
                                              for p in self.packed])
        last = self.shapes[-1]
        self.out_hwc = (last.oh, last.ow, last.och)
        # the link table at every split the kernel can take
        self.tables = {s: self.link_table(s)
                       for s in chain_splits(self.shapes)}
        # the launch's stem arguments, fixed here
        st = self.stem
        self.stem_args = (st[0].data_ptr() if st else None,
                          st[1].data_ptr() if st else None,
                          self.in_shape[2] if st else 0, self.stem_och,
                          stem_shift if st else 0)

    def tiling(self, n: int):
        """(batch_tile, split) of a launch on n images."""
        if n not in self._tiles:
            cfg = self.config.normalize(n, self.shapes[-1].och,
                                        splits=chain_splits(self.shapes))
            bt = cfg.batch_tile
            if cfg.split:
                self._check_tiling(bt, cfg.split)
                split = cfg.split
            else:
                split = chain_split(self.shapes, n // bt, bt, self.stem_och,
                                    capacity=max_clusters)
            self._tiles[n] = (bt, split)
        return self._tiles[n]

    def link_tiles(self, n: int):
        """The warp-item tile (MT, NT) of each link of a launch on n
        images: ``tune.space.chain_tiles`` at the split :meth:`tiling`
        gives."""
        return chain_tiles(self.shapes, self.tiling(n)[1])

    def link_table(self, split: int):
        """(the kernel's link table, the launch's path) at ``split``: each
        link's row ends with its tile from ``tune.space.chain_tiles``."""
        tiles = chain_tiles(self.shapes, split)
        return _link_ints(self.shapes, self.specs, tiles), tile_path(tiles)

    def _check_tiling(self, bt: int, split: int) -> None:
        """Raise when a tuned (batch_tile, split) does not fit the
        shared-memory budget or, on a GPU, runs no cluster at once."""
        smem = chain_task_smem_bytes(self.shapes, bt, stem_och=self.stem_och,
                                     split=split)
        if smem > SMEM_BUDGET:
            raise ValueError(f"block_chain_op: batch_tile={bt} split={split} "
                             f"takes {smem} bytes of shared memory, over "
                             f"the budget of {SMEM_BUDGET}")
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                if max_clusters(split, smem) < 1:
                    raise ValueError(
                        f"block_chain_op: the card runs no cluster of "
                        f"{split} thread blocks of {smem} bytes")

    def thread_blocks(self, n: int) -> int:
        """Thread blocks of a launch on n images."""
        bt, split = self.tiling(n)
        return n // bt * split

    def __call__(self, x, sm_ids=None):
        """``sm_ids``: optional int32 tensor of :meth:`thread_blocks`
        elements that the launch fills with the SM each thread block ran
        on."""
        if x.device.type == "cpu" and self.device.type == "cpu":
            if self.config.split and x.dim() == 4:
                self.tiling(x.shape[0])       # a tuned tiling is checked
            return block_chain_ref(x, self.blocks, specs=self.specs,
                                   stem=self.stem,
                                   stem_shift=self.stem_shift)
        if x.device != self.device:
            raise ValueError(f"operands on different devices: x on "
                             f"{x.device}, weights on {self.device}")
        if x.dtype != torch.uint8 or tuple(x.shape[1:]) != self.in_shape \
                or not x.is_contiguous() or x.data_ptr() % 4:
            raise ValueError(f"block_chain_op: x must be contiguous "
                             f"(N,{','.join(map(str, self.in_shape))}) "
                             f"uint8, got {tuple(x.shape)} {x.dtype}")
        if x.device.index != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return self(x, sm_ids)
        n = x.shape[0]
        out = torch.empty((n, *self.out_hwc), dtype=torch.uint8,
                          device=x.device)
        if out.numel() == 0:
            return out
        bt, split = self._tiles.get(n) or self.tiling(n)
        ints, path = self.tables[split]
        ids = sm_ids_ptr(sm_ids, n // bt * split, x.device)
        lib = _lib()
        err = lib.block_chain_launch(
            x.data_ptr(), out.data_ptr(), *self.stem_args, ints, self.ptrs,
            len(self.specs), n, bt, split, ids,
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "block_chain launch")
        block_chain_op.launches += 1
        block_chain_op.launches_by_path[path] += 1
        return out


def block_chain_op(x, blocks, *, specs, stem=None, stem_shift=None,
                   config: KernelConfig = None):
    """x: (N,H,W,C) uint8, unpadded — the quantized image batch when
    ``stem`` is fused, else the previous kernel's activation.  ``blocks``:
    one (w0, b0, w1, b1[, wd, bd]) tuple per chain link (HWIO int8 filters,
    (Cout,) int16/int32 biases), ``specs`` the matching
    :class:`ChainBlockSpec` schedule; ``stem``: optional (w, b) fused at
    the chain head with ``stem_shift``.  ``config`` carries ``batch_tile``,
    the images one thread block cluster takes (snapped to a divisor of N;
    default 1), and ``split``, the thread blocks an image (0: the
    occupancy rule).  Returns the last link's (N,oh,ow,Cout) uint8 output."""
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return ChainLaunch(blocks, specs=specs, in_shape=x.shape[1:], stem=stem,
                       stem_shift=stem_shift, config=config)(x)


block_chain_op.launches = 0
block_chain_op.launches_by_path = dict.fromkeys(PATHS, 0)
