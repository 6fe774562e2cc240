"""``KernelConfig`` — the decomposition knobs of the kernel pipeline.

The port's copy of ``repro.tune.config``: one frozen, hashable record per
kernel invocation describing how the work is cut.  The fields of the
reference stay (same names, same defaults, same JSON form, so a cache
entry round-trips), and the H100's own knobs join them.  ``tune.space``
enumerates the legal values, ``tune.cache`` persists them,
``compile.lowering`` carries them into the tasks and the kernel wrappers
read them.

Knobs (0 always means "the kernel's own rule"):

  * ``band_rows``   — output rows one thread block takes in ``conv_stem``'s
                      banded path and in ``resblock_fused``.  0: the rules
                      ``stem_band_rows`` / ``tune.space.block_band_rows``
                      (bands sized to fill the card's SMs at the call's
                      batch).
  * ``split``       — ``block_chain``'s thread blocks per image (the
                      cluster size, 1, 2, 4 or 8).  0: ``tune.space.
                      chain_split``'s occupancy rule.
  * ``batch_tile``  — images per unit of work.  One thread block (one
                      cluster) of ``block_chain`` takes ``batch_tile``
                      images; default 1.
  * ``cout_block``  — output channels per unit of work: the channels one
                      thread block of ``selective_scan`` takes (16, 32 or
                      64; the reference's ``bd``, so ``{"cout_block":
                      16}`` means the same in both packages).  0: 32.  No
                      port kernel on the ResNet path reads it.
  * ``lanes``       — threads one channel of ``selective_scan`` runs on
                      (2, 4 or 8; its 16 states split among them).  0: 4.
                      ``(cout_block, lanes)`` must be an instantiated pair
                      (``kernels.selective_scan.ops.scan_knobs``).
  * ``bm/bn/bk``    — tile sizes.  ``matmul_int8`` (``wgmma`` path):
                      ``bn`` the tile width, one of 16 .. 256 up to the
                      narrowest that covers N; ``bm`` and ``bk`` only 0 or
                      128 (the fixed 128 x 128 block tile).
                      ``flash_attention``: ``bm`` the query positions one
                      thread block takes (1 .. 64; it takes ``min(group,
                      64 // bm)`` heads of a kv group with them), ``bk``
                      only 0 or 64 (the K/V tile).  0: the kernels' rules
                      (``matmul_tiles``, ``block_rows``).
  * ``split``       — also ``matmul_int8``'s split-K: a power of two
                      dividing ``ceil(K / 128)`` that leaves at least two
                      K tiles a split.  0: the rule (``matmul_tiles``).

Each LM kernel wrapper has one legality function (``matmul_knobs``,
``attn_knobs``, ``scan_knobs``), which the wrapper, ``tune.space`` and the
tests all call: a knob the kernel does not have, or an illegal value, is
refused with a ``ValueError`` naming it, never clamped.

``normalize`` snaps the conv knobs to a legal value at the call's shape,
so a config tuned at one bucket stays legal at every other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (>= 1)."""
    target = max(1, min(n, target))
    for d in range(target, 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Decomposition knobs for one kernel invocation.  Hashable and JSON
    round-trippable."""

    batch_tile: int = 1          # images per unit of work (0 = whole batch)
    cout_block: int = 0          # output channels per unit of work (0 = all)
    bm: int = 0                  # matmul tiles (0 = kernel default)
    bn: int = 0
    bk: int = 0
    band_rows: int = 0           # output rows a thread block (0 = rule)
    split: int = 0               # block_chain thread blocks an image, or
                                 # matmul_int8's split-K (0 = rule)
    lanes: int = 0               # selective_scan lanes a channel (0 = rule)

    def normalize(self, n: int, cout: int, oh: Optional[int] = None,
                  splits: Optional[Sequence[int]] = None) -> "KernelConfig":
        """Snap the knobs to legal values at the actual call shapes: batch
        ``n`` and output channels ``cout`` (``batch_tile`` and
        ``cout_block`` to divisors), ``oh`` output rows (``band_rows`` into
        [1, oh]) and the chain's legal ``splits`` (``split`` to the largest
        legal one at most the requested, else the smallest).  A knob left
        at 0 stays 0, and one whose shape is not given stays as it is."""
        bt = n if self.batch_tile == 0 else \
            largest_divisor_leq(n, self.batch_tile)
        cb = cout if self.cout_block == 0 else \
            largest_divisor_leq(cout, self.cout_block)
        band, split = self.band_rows, self.split
        if band and oh is not None:
            band = max(1, min(band, oh))
        if split and splits:
            below = [s for s in splits if s <= split]
            split = max(below) if below else min(splits)
        return dataclasses.replace(self, batch_tile=bt, cout_block=cb,
                                   band_rows=band, split=split)

    def resolve(self, knob: str, default: int) -> int:
        """The value of ``knob`` with unset (``None`` or the 0 sentinel)
        resolved to ``default`` — explicitly, never by truthiness."""
        v = getattr(self, knob)
        return default if v is None or v == 0 else int(v)

    def to_dict(self) -> dict:
        """Compact dict: only non-default fields (stable cache format)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in known})

    def describe(self) -> str:
        d = self.to_dict()
        return "default" if not d else \
            ",".join(f"{k}={v}" for k, v in sorted(d.items()))


DEFAULT = KernelConfig()
