"""The ambient mesh, so that model code can express sharding without
threading the mesh through every call: the port of ``repro.parallel.ctx``.

The reference is single-controller: XLA partitions one program over the
mesh, steered by ``constrain`` / ``sharded_take``.  The port is SPMD (one
process a rank) and its models compute on the **local batch** with plain
tensors; DTensor carries the parameters and every collective:

* ``gather(w)`` is the FSDP x TP all-gather of one weight at its use (a
  layer's weights inside its rematerialized body, so the backward gathers
  them again): the DTensor redistributed to ``Replicate`` on every mesh
  dim, then its local tensor, whose gradient is declared ``Partial`` over
  the mesh dims that split the batch rows, so the backward reduce-scatters
  it onto the weight's own placements.  The ranks of 'model' then compute
  the same thing.
* Tensor parallelism (Megatron's split) where a layer's width divides
  the 'model' axis (``splits``) or its heads share a factor with it:
  ``model_part(w, dim)`` gathers a
  weight over the batch axes only and keeps this rank's 1/tp of ``dim`` on
  'model' (column-parallel by the output dim, row-parallel by the input
  dim; a stored placement on another dim is moved by an all-to-all);
  ``to_model(x)`` is the identity whose backward all-reduces ``x``'s
  gradient over 'model' (the input of a column-parallel block) and
  ``model_sum(y)`` the all-reduce over 'model' after a row-parallel
  matmul, whose backward hands each rank the gradient as it is.  Each
  layer kind notes how many ways it split (``note`` / ``split_kinds``),
  which the dry-run reports.
* ``local_rows(batch)`` / ``rows_split_over(axes)``: the rows this rank
  computes and the mesh dims that split them (every batch axis when the
  rows divide over them, else none: each rank then computes all rows).
* ``batch_sum(x)``: a sum over the split rows (the loss's numerator and
  token count), an all-reduce whose backward hands each rank its own
  gradient; ``batch_max(x)`` the largest value over them (QAT's dynamic
  exponent).
* ``all_rows`` / ``sum_own_rows``: the rows of every rank, read by what
  mixes rows (the MoE's segments under its global capacity, split over
  the ranks), and the way back for a result every rank holds a part of:
  one reduce-scatter.
* ``model_gather(x, dim)``: the parts of ``x`` the 'model' ranks
  computed (heads, vocabulary), whole on every rank.
* ``constrain(x, *spec)`` redistributes a DTensor to the reference's spec
  (the identity on a plain tensor, which is what the models carry between
  layers: the local rows are the reference's ``(batch, None, None)``).
* ``sharded_take(emb, tokens)``: the embedding gather on a table sharded
  ``(None, 'model')``, local on each model shard, then one all-gather of
  the gathered rows' columns.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import tree as T

_MESH = None
# the mesh dims whose ranks hold different rows of the batch being computed
_SPLIT: tuple = ()


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def mesh_context(mesh):
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def batch_axes():
    if _MESH is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in _names(_MESH))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# the rows of the batch
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def rows_split_over(axes):
    """Within the block, the batch rows differ across the mesh dims
    ``axes`` (and are the same on every other dim)."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, tuple(axes)
    try:
        yield
    finally:
        _SPLIT = prev


def split_axes() -> tuple:
    return _SPLIT


def _rows_index(mesh, axes) -> tuple:
    """(this rank's index among the ranks of ``axes``, their count), the
    axes taken major to minor in mesh order."""
    coord = mesh.get_coordinate()
    names = _names(mesh)
    idx, n = 0, 1
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return idx, n


def local_rows(batch: dict):
    """``(rows, axes)``: this rank's contiguous share of the leading axis
    of every tensor of ``batch`` (the same whole batch on every rank) and
    the batch axes that split it; ``(batch, ())`` without a mesh or when
    the rows do not divide over the batch axes."""
    axes = batch_axes()
    if not axes:
        return batch, ()
    idx, n = _rows_index(_MESH, axes)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        return batch, ()
    per = B // n
    return {k: v[idx * per:(idx + 1) * per] for k, v in batch.items()}, axes


def full_batch(batch: dict) -> dict:
    """DTensors of a batch gathered whole (the same on every rank)."""
    return {k: v.full_tensor() if _is_dtensor(v) else v
            for k, v in batch.items()}


def _grad_placements(mesh):
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if a in _SPLIT else Replicate() for a in _names(mesh)]


def _rows_placements(mesh):
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if a in _SPLIT else Replicate() for a in _names(mesh)]


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that hold other rows (identity when no
    mesh dim splits the rows)."""
    if _MESH is None or not _SPLIT:
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, _MESH, _grad_placements(_MESH),
                              run_check=False).full_tensor()


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (no gradient) maxed over the ranks that hold other rows: a
    statistic of the whole batch, e.g. QAT's dynamic exponent."""
    if _MESH is None or not _SPLIT:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial("max") if a in _SPLIT else Replicate()
          for a in _names(_MESH)]
    return DTensor.from_local(x, _MESH, pl, run_check=False).full_tensor()


def row_share() -> tuple:
    """(this rank's index among the ranks that split the rows, their
    count): ``(0, 1)`` where no mesh dim splits them."""
    if _MESH is None or not _SPLIT:
        return 0, 1
    return _rows_index(_MESH, _SPLIT)


def all_rows(x: torch.Tensor, parts=()) -> torch.Tensor:
    """The rows of every rank, concatenated in rank order (the global
    batch's order); its gradient goes back to the rows' own rank.
    ``parts``: the mesh dims (the row axes, 'model') whose ranks each
    compute a different part of what reads these rows, so that each
    rank's gradient is a part of the whole: it is summed over them first
    (a reduce-scatter over the row axes, an all-reduce over 'model').
    Without ``parts`` every rank computed alike and its gradient is
    taken as it is."""
    if _MESH is None or not (_SPLIT or parts):
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    rep = [Replicate()] * _MESH.ndim
    grad_pl = [Partial() if a in parts else Replicate()
               for a in _names(_MESH)]
    d = DTensor.from_local(x, _MESH, _rows_placements(_MESH),
                           run_check=False)
    return d.redistribute(_MESH, rep).to_local(grad_placements=grad_pl)


def sum_own_rows(y: torch.Tensor, parts) -> torch.Tensor:
    """The inverse of ``all_rows(x, parts)`` for a result that is a sum of
    the ranks' parts: ``y`` (the rows of every rank, this rank's part of
    each) summed over the mesh dims ``parts``, and this rank's own rows of
    the sum.  One redistribute of a ``Partial``: a reduce-scatter over the
    row axes (an all-reduce over 'model' where it is in ``parts``); the
    backward hands every rank the gradient of every row (an all-gather)."""
    if _MESH is None or not (_SPLIT or parts):
        return y
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial() if a in parts else Replicate() for a in _names(_MESH)]
    return DTensor.from_local(y, _MESH, pl, run_check=False).redistribute(
        _MESH, _rows_placements(_MESH)).to_local()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def gather(w):
    """A weight as a whole local tensor: a DTensor all-gathered (its
    gradient reduce-scattered back, summed over the ranks that split the
    rows); a plain tensor as it is."""
    if not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    if not all(p.is_replicate() for p in w.placements):
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    return w.to_local(grad_placements=_grad_placements(mesh))


def whole_along(w, dim: int):
    """A DTensor with ``dim`` gathered on every mesh dim that splits it
    (a stacked leaf FSDP-sharded on its layer dim, before ``unbind``); a
    plain tensor as it is."""
    if not _is_dtensor(w) or not any(p.is_shard(dim) for p in w.placements):
        return w
    from torch.distributed.tensor import Replicate
    return w.redistribute(w.device_mesh, [Replicate() if p.is_shard(dim)
                                          else p for p in w.placements])


def gather_tree(tree):
    """``gather`` at every leaf (a layer's weights at its use)."""
    return T.tree_map(gather, tree)


# ---------------------------------------------------------------------------
# tensor parallelism over 'model'
# ---------------------------------------------------------------------------

# the layer kinds that ran since ``split_kinds(reset=True)``: kind -> the
# set of ways each call split it over 'model' (1: computed whole on every
# 'model' rank)
_KINDS: dict = {}


def model_size() -> int:
    """The ambient mesh's 'model' extent (1 without a mesh or the axis)."""
    if _MESH is None or "model" not in _names(_MESH):
        return 1
    return _MESH.size(_model_index(_MESH))


def model_rank() -> int:
    """This rank's coordinate on 'model' (0 without the axis)."""
    if model_size() == 1:
        return 0
    return _MESH.get_coordinate()[_model_index(_MESH)]


def splits(w, n=None) -> bool:
    """Whether a layer whose weight ``w`` has ``n`` heads (or vocabulary
    rows; by default ``w``'s last dim, its columns) splits them over
    'model': ``w`` a DTensor (a weight gathered already, e.g. inside the
    MoE's every-row region, does not) and a 'model' axis of more than one
    rank that divides ``n``."""
    if not on_model(w):
        return False
    return (w.shape[-1] if n is None else n) % model_size() == 0


def on_model(w) -> bool:
    """``w`` a DTensor under a 'model' axis of more than one rank."""
    return model_size() > 1 and _is_dtensor(w)


def model_dim(w):
    """The dim of DTensor ``w`` that its placement splits over 'model'
    (``None`` where 'model' holds it whole)."""
    p = w.placements[_model_index(w.device_mesh)]
    return p.dim if p.is_shard() else None


def note(kind: str, ways: int) -> None:
    """Record that a layer of ``kind`` split its compute ``ways`` ways over
    'model' (1: whole on every rank; only under a 'model' axis of more
    than one rank)."""
    if model_size() > 1:
        _KINDS.setdefault(kind, set()).add(int(ways))


def split_kinds(reset: bool = False) -> dict:
    """``{"split": {kind: ways}, "repeat": [kinds]}`` of the layers noted
    since the last reset (a kind that did both is in both; ``ways`` the
    fewest it split)."""
    out = dict(split={k: min(w for w in v if w > 1)
                      for k, v in sorted(_KINDS.items()) if max(v) > 1},
               repeat=sorted(k for k, v in _KINDS.items() if 1 in v))
    if reset:
        _KINDS.clear()
    return out


def _model_index(mesh) -> int:
    return _names(mesh).index("model")


def model_part(w, dim: int) -> torch.Tensor:
    """This rank's 1/tp of weight ``w`` along ``dim`` on 'model', whole
    over the other mesh dims: the DTensor redistributed to ``Shard(dim)``
    on 'model' and ``Replicate`` elsewhere (from the stored placements: a
    gather over the batch axes and, where 'model' holds another dim, an
    all-to-all), then its local tensor, whose gradient is ``Partial`` over
    the mesh dims that split the rows and ``Shard(dim)`` on 'model', so
    that the backward sends it back to the stored placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    dim = dim % w.ndim
    mi = _model_index(mesh)
    want = [Shard(dim) if i == mi else Replicate() for i in range(mesh.ndim)]
    if tuple(w.placements) != tuple(want):
        w = w.redistribute(mesh, want)
    grad_pl = _grad_placements(mesh)
    grad_pl[mi] = Shard(dim)
    return w.to_local(grad_placements=grad_pl)


def gather_for_parts(w) -> torch.Tensor:
    """``w`` whole on this rank, for a layer whose 'model' ranks each read
    a different part of it (the K/V heads of their own query heads): its
    gradient is ``Partial`` over 'model' as over the split rows."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = w.device_mesh
    if not all(p.is_replicate() for p in w.placements):
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad_pl = _grad_placements(mesh)
    grad_pl[_model_index(mesh)] = Partial()
    return w.to_local(grad_placements=grad_pl)


def _on_model(p) -> list:
    """Placements: ``p`` on 'model', ``Replicate`` on every other mesh dim
    (which these collectives leave as they are)."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate()] * _MESH.ndim
    pl[_model_index(_MESH)] = p
    return pl


def to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, the input of a column-parallel block: the backward
    sums its gradient over 'model' (each rank's columns add their part)."""
    if model_size() == 1:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    return DTensor.from_local(x, _MESH, _on_model(Replicate()),
                              run_check=False).to_local(
        grad_placements=_on_model(Partial()))


def model_sum(y: torch.Tensor) -> torch.Tensor:
    """``y`` summed over 'model' (the partial products of a row-parallel
    matmul), the same on every 'model' rank; the backward hands each rank
    the gradient of the sum as it is."""
    if model_size() == 1:
        return y
    from torch.distributed.tensor import DTensor, Partial, Replicate
    return DTensor.from_local(y, _MESH, _on_model(Partial()),
                              run_check=False).redistribute(
        _MESH, _on_model(Replicate())).to_local()


def model_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (no gradient) maxed over 'model'."""
    if model_size() == 1:
        return x.detach()
    from torch.distributed.tensor import DTensor, Partial, Replicate
    return DTensor.from_local(x.detach(), _MESH, _on_model(Partial("max")),
                              run_check=False).redistribute(
        _MESH, _on_model(Replicate())).to_local()


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` and every other 'model'
    rank's, concatenated in rank order (an all-gather over 'model': the
    heads or vocabulary a split layer computed, whole on every rank)."""
    if model_size() == 1:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = dim % x.dim()
    return DTensor.from_local(x, _MESH, _on_model(Shard(dim)),
                              run_check=False).redistribute(
        _MESH, _on_model(Replicate())).to_local()


# ---------------------------------------------------------------------------
# the reference's constraint sites
# ---------------------------------------------------------------------------


def sharded_take(emb, tokens):
    """Embedding lookup with the table sharded P(None, 'model') (d-sharded).

    Each model shard gathers its columns of the rows it needs; one
    all-gather over 'model' then assembles the rows (the reference's
    shard_map gather).  The table's gradient (the scatter-add) stays local
    to each column shard, summed over the ranks that split the rows."""
    idx = tokens.to(torch.long)
    if _MESH is None or not _is_dtensor(emb):
        return gather(emb)[idx]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = emb.device_mesh
    names = _names(mesh)
    if "model" not in names or \
            emb.shape[1] % mesh.size(names.index("model")):
        return gather(emb)[idx]
    mi = names.index("model")
    want = [Shard(1) if i == mi else Replicate() for i in range(mesh.ndim)]
    if tuple(emb.placements) != tuple(want):
        emb = emb.redistribute(mesh, want)
    grad_pl = _grad_placements(mesh)
    grad_pl[mi] = Shard(1)
    cols = emb.to_local(grad_placements=grad_pl)[idx]
    rows = _rows_placements(mesh)
    pl = list(rows)
    pl[mi] = Shard(cols.dim() - 1)
    return DTensor.from_local(cols, mesh, pl, run_check=False).redistribute(
        mesh, rows).to_local()


def _fixed_spec(shape, spec, mesh):
    """The reference's rule: each axis entry kept only where it is on the
    mesh and the axes' product divides the dim."""
    names = _names(mesh)
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in names)
        n = int(np.prod([mesh.size(names.index(a)) for a in axes])) \
            if axes else 1
        fixed.append((axes if len(axes) > 1 else axes[0])
                     if axes and dim % n == 0 else None)
    return tuple(fixed) + (None,) * (len(shape) - len(fixed))


def constrain(x, *spec):
    """A DTensor redistributed to ``spec`` on the ambient mesh (axis
    entries that don't divide the corresponding dim are dropped); the
    identity on a plain tensor or without a mesh."""
    if _MESH is None or not _is_dtensor(x):
        return x
    from repro_torch.parallel.sharding import P, spec_to_placements
    pl = spec_to_placements(P(*_fixed_spec(x.shape, spec, _MESH)), _MESH)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(_MESH, pl)
