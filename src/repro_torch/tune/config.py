"""``KernelConfig`` — the tiling knobs of the kernel pipeline.

The port's copy of ``repro.tune.config`` (same fields, same ``normalize``,
same JSON form): one frozen, hashable record per kernel invocation
describing how the work is cut.  Today only ``block_chain`` reads it, for
``batch_tile``; the rest of the tuner is not ported yet.

Knobs (0 always means "kernel default / maximal"):

  * ``batch_tile``  — images per unit of work.  On the H100 one thread
                      block of ``block_chain`` takes ``batch_tile`` images,
                      so a larger tile means fewer thread blocks.
  * ``cout_block``  — output channels per unit of work (the stem and the
                      general conv).  Illegal for the fused residual block:
                      conv1 consumes *all* of conv0's channels.
  * ``bm/bn/bk``    — matmul tile sizes.

``normalize`` snaps requested tiles to legal divisors of the actual shapes
so a cached config can never make a kernel call illegal.
"""
from __future__ import annotations

import dataclasses


def largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (>= 1)."""
    target = max(1, min(n, target))
    for d in range(target, 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Tiling knobs for one kernel invocation.  Hashable and JSON
    round-trippable."""

    batch_tile: int = 1          # images per unit of work (0 = whole batch)
    cout_block: int = 0          # output channels per unit of work (0 = all)
    bm: int = 0                  # matmul tiles (0 = kernel default)
    bn: int = 0
    bk: int = 0

    def normalize(self, n: int, cout: int) -> "KernelConfig":
        """Snap the conv knobs to legal divisors of the actual call shapes
        (batch ``n``, output channels ``cout``).  A config tuned at one
        bucket stays legal at every other bucket."""
        bt = n if self.batch_tile == 0 else \
            largest_divisor_leq(n, self.batch_tile)
        cb = cout if self.cout_block == 0 else \
            largest_divisor_leq(cout, self.cout_block)
        return dataclasses.replace(self, batch_tile=bt, cout_block=cb)

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
