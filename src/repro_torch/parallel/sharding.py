"""Sharding rules: FSDP('data') x TP('model') (+ 'pod' data parallelism),
the port of ``repro.parallel.sharding``.

The policy is the reference's line for line: every parameter gets a
partition spec by shape heuristics with divisibility checks (a dim is
only sharded if divisible by the axis size); optimizer state inherits the
parameter's placements (ZeRO-3); activations are sharded
batch-over-('pod', 'data') through the input specs.

A spec is a :class:`PartitionSpec`, a tuple of per-dim entries (``None``,
an axis name, or a tuple of axis names), equal as a tuple to the
reference's ``jax.sharding.PartitionSpec``.  :func:`spec_to_placements`
turns one into DTensor placements over a ``DeviceMesh``: a dim sharded
over ``("data", "model")`` becomes ``Shard(d)`` on both mesh dims,
data-major as in JAX.  A mesh here is a ``DeviceMesh`` with the
reference's axis names, or, for the rule checks alone (``param_spec``,
``input_sharding_factory`` specs), a mapping of axis name to size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import tree as T


class PartitionSpec(tuple):
    """Per-dim mesh axes of one tensor: ``P(None, "data")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


def axis_size(mesh, name) -> int:
    """Product of the named axes' sizes; an axis absent from the mesh counts
    as 1, so the sharding rules degrade gracefully on reduced meshes (e.g. a
    data-only serving mesh has no 'model' axis — TP just becomes a no-op)."""
    shape = mesh_shape(mesh)
    if isinstance(name, (tuple, list)):
        return int(np.prod([shape.get(n, 1) for n in name]))
    return shape.get(name, 1)


def param_spec(path: str, shape, mesh, *, fsdp_axis="data", tp_axis="model",
               min_size_fsdp: int = 2 ** 18) -> PartitionSpec:
    """Choose a spec for one parameter.

    Policy (matmul weights are ~2D (in, out), possibly with leading stack/
    expert dims):
      * last dim  -> TP axis   (column parallel) when divisible
      * second-to-last dim -> FSDP axis when divisible and tensor is large
      * leading stack/expert dims stay unsharded
    Embeddings shard d over TP.  Norms/bias/small tensors replicate.  An
    axis absent from the mesh (or of size 1) is never named."""
    ndim = len(shape)
    tp = axis_size(mesh, tp_axis)
    fsdp = axis_size(mesh, fsdp_axis)
    size = int(np.prod(shape))
    spec = [None] * ndim
    if ndim == 0 or size < 2 ** 14:
        return P(*spec)
    if "embed" in path and ndim == 2:
        # (V, d): shard d over TP so the token gather (and its scatter-add
        # gradient) stays device-local (ctx.sharded_take)
        if tp > 1 and shape[1] % tp == 0:
            spec[1] = tp_axis
        return P(*spec)
    if ndim >= 2:
        if tp > 1 and shape[-1] % tp == 0:
            spec[-1] = tp_axis
        if fsdp > 1 and size >= min_size_fsdp:
            if shape[-2] % fsdp == 0:
                spec[-2] = fsdp_axis
            elif shape[-1] % (tp * fsdp) == 0:
                # last-dim fallback: stack FSDP onto the TP dim, or take the
                # last dim alone when TP is degenerate
                spec[-1] = (fsdp_axis, tp_axis) if spec[-1] is not None \
                    else fsdp_axis
        return P(*spec)
    # 1D big vectors (e.g. stacked biases): replicate
    return P(*spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a ``DeviceMesh``: the port's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)


def params_shardings(param_tree, mesh, **kw):
    """A tree of :class:`NamedSharding`, one a leaf of ``param_tree``
    (tensors, DTensors or anything with a ``shape``), by ``param_spec`` of
    the leaf's path (``core.tree``, the reference's ``_path_str``)."""
    pairs = T.flatten_with_path(param_tree)
    return T.unflatten(param_tree, [
        NamedSharding(mesh, param_spec(path, tuple(leaf.shape), mesh, **kw))
        for path, leaf in pairs])


def replicated_shardings(param_tree, mesh):
    """Every leaf fully replicated on ``mesh``: each device holds a whole
    copy (the serving replicas' weights).  Contrast ``params_shardings``,
    which FSDP/TP-shards large tensors for training."""
    return T.tree_map(lambda _: NamedSharding(mesh, P()), param_tree)


def input_sharding_factory(mesh):
    """Returns ``sharding(shape, axes) -> PartitionSpec`` for
    ``configs.base.input_specs``.

    'batch' -> ('pod','data') when batch divisible, else unsharded (the seq
    dim takes 'data' for batch-1 long-context cells); 'heads'/'embed' ->
    'model' when divisible."""
    names = axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)

    def sharding(shape, axes):
        spec = []
        used_data = False
        model_n = axis_size(mesh, "model")
        for dim, ax in zip(shape, axes):
            if ax == "batch":
                n = axis_size(mesh, batch_axes)
                if batch_axes and dim % n == 0:
                    spec.append(batch_axes if len(batch_axes) > 1
                                else batch_axes[0])
                    used_data = True
                else:
                    spec.append(None)
            elif ax == "seq":
                if batch_axes and not used_data and \
                        dim % axis_size(mesh, batch_axes) == 0:
                    # sequence sharding fallback (batch-1 long-context cells)
                    spec.append(batch_axes if len(batch_axes) > 1
                                else batch_axes[0])
                    used_data = True
                else:
                    spec.append(None)
            elif ax in ("heads", "embed"):
                spec.append("model" if model_n > 1 and dim % model_n == 0
                            else None)
            else:
                spec.append(None)
        return P(*spec)

    return sharding


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------


def spec_to_placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh`` (one a mesh dim):
    ``Shard(d)`` on each mesh dim that the spec names at tensor dim ``d``,
    ``Replicate()`` elsewhere.  A dim split over several axes must name
    them in mesh order (DTensor splits data-major, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of this rank's shard of a tensor of ``shape``."""
    shape = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over mesh dim {i} of size {n}")
            shape[p.dim] //= n
    return tuple(shape)


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` (a view, no
    communication): split along each sharded dim in mesh-dim order."""
    coord = mesh.get_coordinate()
    t = full
    for i, p in enumerate(placements):
        if p.is_shard():
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """``full`` (the same whole tensor on every rank) as a DTensor on
    ``sharding``: each rank keeps a copy of its own slice (never storage
    shared with ``full``, which the caller may free), nothing is sent."""
    from torch.distributed.tensor import DTensor

    pl = sharding.placements
    loc = local_shard(full, sharding.mesh, pl).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(loc, sharding.mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def distribute_tree(tree, shardings):
    """:func:`distribute` at every leaf; ``shardings`` has ``tree``'s
    structure (a ``BlockQuantized`` leaf takes one sharding for both
    children, see ``state_shardings``)."""
    return T.tree_map(lambda x, s: distribute(x, s), tree, shardings)


def state_shardings(opt_state, param_shardings):
    """The shardings of an optimizer state whose moments inherit their
    parameter's placements (the ZeRO-3 rule): each moment tree under a
    key of ``opt_state`` (``m``, ``v``, ``mu``) takes
    ``param_shardings``, an int8 moment's ``q`` and ``exp`` both."""
    return {k: _expand(v, param_shardings) for k, v in opt_state.items()}


def _expand(state_sub, shardings):
    """``shardings`` (the params' structure) laid over ``state_sub``,
    where a ``BlockQuantized`` node takes its parameter's sharding for
    both ``q`` and ``exp``."""
    from repro_torch.core.quant import BlockQuantized
    if isinstance(state_sub, dict):
        return {k: _expand(state_sub[k], shardings[k]) for k in state_sub}
    if isinstance(state_sub, (list, tuple)):
        return type(state_sub)(_expand(s, sh)
                               for s, sh in zip(state_sub, shardings))
    if isinstance(state_sub, BlockQuantized):
        return BlockQuantized(q=shardings, exp=shardings)
    return shardings
