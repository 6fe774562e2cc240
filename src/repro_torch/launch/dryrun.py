"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on the
production mesh without allocating, and report its per-device flops,
collective bytes and memory beside the analytic roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k [--multi-pod] [--out results.json] [--device cpu]
    # a cell of the caller's own, e.g. to hold it against a real step:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh-data 1 --mesh-model 1 --batch 2 --seq 1024

The port of ``repro.launch.dryrun``.  The reference lowers one program for
all devices and reads XLA's analyses; the port runs rank 0's program of
the SPMD step in one process under the ``fake`` process group at the
production mesh (256 or 512 ranks), with parameters, optimizer state and
batch as DTensors over fake tensors (``FakeTensorMode``: shapes, dtypes
and devices, no storage), built by ``DTensor.from_local`` from the local
shard shapes.  It measures the traced step:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the local ops;
* ``collective_bytes_per_device`` / ``collective_detail`` /
  ``collective_counts``: the result bytes of every ``_c10d_functional``
  collective and of DTensor's shard-to-shard all-to-all, under the
  reference's five keys (its definition: result bytes of the per-device
  program);
* ``bytes_per_device``: operand plus result bytes of every local op (the
  reference's "bytes accessed");
* ``argument_bytes_per_device``: the local bytes of params, optimizer
  state and batch (``cache_bytes_per_device`` those of a decode cell's
  cache); ``temp_bytes_per_device``: the peak of live storage above them
  (a tracker of the port's own: a weak reference on every storage an op
  makes);
* ``model_split``: the layer kinds that split their compute over 'model'
  (tensor parallelism: GQA and MLA heads, the MLP's and the experts'
  width, the Mamba mixers' channels or heads, the vocabulary) and those
  every 'model' rank computes whole (``parallel.ctx.split_kinds``).  A
  decode cell's cache entries that a layer reads per rank keep their
  'model' shard (``local_inputs``, ``configs.base.per_rank_cache``).

The rest (``hbm_required_bytes``, ``fits_hbm``, ``bottleneck``,
``model_flops``, ``useful_flops_ratio``, the ``analytic_terms`` fields)
keep the reference's names and definitions, over the H100's constants
(``launch.mesh``).  ``--device`` names the fake tensors' device (default
``cuda``, which needs a GPU present; ``cpu`` runs anywhere).  A process
holds one fake group: run one cell a process (``launch.dryrun_all``).
Beyond the reference's flags, ``--mesh-data D --mesh-model M`` trace on a
``(D, M)`` mesh instead of the production one, and ``--batch`` /
``--seq`` replace the shape's global batch and sequence length.
"""
from __future__ import annotations

import argparse
import json
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import base as cbase
from repro_torch.core import tree as T
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (default_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import model as M
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as shd

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# the functional collectives DTensor issues, under the reference's names
_C10D = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# DTensor's own op for a move from one sharded dim to another on a mesh dim
# (e.g. a stored column shard to the row shard a row-parallel matmul
# reads): one all-to-all, issued outside ``_c10d_functional`` on the GPU
# (a CPU mesh falls back to an all-gather and a chunk)
_SHARD_TO_SHARD = ("_dtensor", "shard_dim_alltoall")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class StepCounter(TorchDispatchMode):
    """Counts, over the local ops it sees: the result bytes of each
    functional collective (by the reference's key), every op's operand
    plus result bytes, and the live bytes of the storages ops make (each
    storage counted once, from the op that makes it until it is freed;
    the results of views and in-place ops, which alias an operand, are
    not new storage), with their peak."""

    def __init__(self):
        super().__init__()
        self.coll = {c: 0 for c in _COLLECTIVES}
        self.counts = {c: 0 for c in _COLLECTIVES}
        self.other = {}
        self.accessed = 0
        self.live = self.peak = 0
        self._seen = {}

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live (once) until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional" or \
                (func.namespace, func._opname) == _SHARD_TO_SHARD:
            name = func._opname
            if name in _C10D:
                self.coll[_C10D[name]] += _nbytes(out)
                self.counts[_C10D[name]] += 1
            elif name != "wait_tensor":
                self.other[name] = self.other.get(name, 0) + 1
        else:
            ins = [a for a in T.leaves(list(args) + list(kwargs.values()))
                   if isinstance(a, torch.Tensor)]
            self.accessed += sum(_nbytes(a) for a in ins) + _nbytes(out)
        if not any(r.alias_info is not None for r in func._schema.returns):
            # a view (or an in-place op) returns its input's storage
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.hold(t)
        return out


def _fake_group(world: int):
    """Rank 0 of a ``fake`` process group of ``world`` ranks (started once
    a process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"this process's group has {dist.get_world_size()} ranks; "
                f"a dry-run of {world} chips needs a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _dtensor(shape, dtype, sharding, device):
    """A fake DTensor of global ``shape`` on ``sharding``: only this
    rank's shard shape exists."""
    from torch.distributed.tensor import DTensor

    pl = sharding.placements
    loc = torch.empty(shd.local_shape(shape, sharding.mesh, pl),
                      dtype=dtype, device=device)
    return DTensor.from_local(loc, sharding.mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def local_placements(batch, mesh, cfg) -> dict:
    """Path -> the placements of a serve cell's input leaf as this rank
    computes it: the batch dim kept split over the batch axes, every other
    split dim gathered, but the cache entries that ``cfg``'s layers read
    at this rank's heads or channels only (``cbase.per_rank_cache``) keep
    their 'model' shard too."""
    from torch.distributed.tensor import Replicate

    names = tuple(mesh.mesh_dim_names)
    keep = cbase.per_rank_cache(cfg, shd.axis_size(mesh, "model"))
    out = {}
    for path, x in T.flatten_with_path(batch):
        bdim = 1 if path.startswith("cache/") else 0
        own = path.startswith("cache/") and path.split("/")[-1] in keep
        out[path] = [p if p.is_shard(bdim) or (own and a == "model") else
                     Replicate() for a, p in zip(names, x.placements)]
    return out


def local_inputs(batch, mesh, cfg):
    """A serve cell's inputs (DTensors) as this rank's local tensors, on
    ``local_placements``.  Returns (rows, the axes that split them)."""
    pls = local_placements(batch, mesh, cfg)
    pairs = T.flatten_with_path(batch)
    rows = T.unflatten(batch, [x.redistribute(mesh, pls[p]).to_local()
                               for p, x in pairs])
    split = tuple(a for a, p in zip(mesh.mesh_dim_names, pls["tokens"])
                  if p.is_shard())
    return rows, split if set(split) <= set(ctx.batch_axes()) else ()


def _shape(shape_name, batch=None, seq=None):
    s = cbase.SHAPES[shape_name]
    return cbase.ShapeSpec(s.name, seq or s.seq_len, batch or s.global_batch,
                           s.kind)


def _make_mesh(multi_pod, device, local_mesh=None):
    dt = torch.device(device).type
    if local_mesh is not None:
        return mesh_lib.make_local_mesh(*local_mesh, device=dt)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod, device=dt)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_overrides=None, device="cuda", mesh=None, batch=None,
               seq=None):
    """``(mesh, cfg, shape, run, args, meta)`` for one cell: ``run()``
    executes the cell's step on ``args`` (params, [optimizer state], batch:
    fake DTensors on the production mesh, which must exist already when
    called inside ``FakeTensorMode``).  Needs the fake group started."""
    if mesh is None:
        mesh = _make_mesh(multi_pod, device)
    cfg = cbase.get_config(arch)
    cfg_overrides = dict(cfg_overrides or {})
    grad_accum_override = cfg_overrides.pop("grad_accum", None)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    shape = _shape(shape_name, batch, seq)
    if not cfg.supports_shape(shape_name):
        raise SystemExit(f"SKIP: {arch} does not support {shape_name} "
                         f"(full attention)")
    inp = shd.input_sharding_factory(mesh)
    batch = cbase.input_specs(cfg, shape, lambda s, dt, axes: _dtensor(
        s, dt, shd.NamedSharding(mesh, inp(s, axes)), device))
    p_shapes = _param_shapes(cfg)
    p_shard = shd.params_shardings(p_shapes, mesh)
    params = T.tree_map(lambda s, sh: _dtensor(s.shape, s.dtype, sh, device),
                        p_shapes, p_shard)
    meta = dict(grad_accum=1)
    if shape.kind == "train":
        opt = default_optimizer(cfg)
        opt_state = opt.init(params)
        # default microbatching: ~2 sequences per data shard per microstep
        names = mesh.mesh_dim_names
        data_ways = int(np.prod([mesh.size(i) for i, a in enumerate(names)
                                 if a in ("pod", "data")]))
        grad_accum = max(1, shape.global_batch // (2 * data_ways))
        if grad_accum_override is not None:
            grad_accum = grad_accum_override
        meta["grad_accum"] = grad_accum
        step = make_train_step(cfg, opt, grad_accum=grad_accum)
        args = (params, opt_state, batch)

        def run():
            return step(params, opt_state, 0, batch)
    else:
        step = (make_prefill_step(cfg) if shape.kind == "prefill"
                else make_serve_step(cfg))
        args = (params, batch)
        if "cache" in batch:
            meta["cache_bytes"] = _local_bytes(batch["cache"])

        def run():
            rows, axes = local_inputs(batch, mesh, cfg)
            with ctx.rows_split_over(axes):
                return step(params, rows)
    return mesh, cfg, shape, run, args, meta


def _param_shapes(cfg):
    """The parameter tree's shapes and dtypes, drawn on the meta device
    outside any fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return M.param_shapes(cfg)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in T.leaves(tree))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_overrides=None, device="cuda", local_mesh=None,
             batch=None, seq=None) -> dict:
    """One cell's measured and analytic terms (the reference's fields);
    ``local_mesh=(D, M)`` traces on that mesh instead of the production
    one, ``batch`` / ``seq`` replace the shape's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    t0 = time.perf_counter()
    n_chips = (local_mesh[0] * local_mesh[1] if local_mesh
               else 512 if multi_pod else 256)
    _fake_group(n_chips)
    counter = StepCounter()
    mesh = _make_mesh(multi_pod, device, local_mesh)
    with FakeTensorMode(allow_non_fake_inputs=False):
        mesh, cfg, shape, run, args, meta = build_cell(
            arch, shape_name, multi_pod, cfg_overrides, device, mesh,
            batch, seq)
        for x in T.leaves(args):
            counter.hold(x.to_local() if isinstance(x, DTensor) else x)
        arg_b = counter.live
        counter.peak = arg_b
        flops = FlopCounterMode(display=False)
        ctx.split_kinds(reset=True)
        with ctx.mesh_context(mesh), counter, flops:
            out = run()
        split = ctx.split_kinds(reset=True)
        out_b = 0 if shape.kind == "train" else _local_bytes(out)
        del out
    flops_dev = float(flops.get_total_flops())
    bytes_dev = float(counter.accessed)
    coll_dev = float(sum(counter.coll.values()))
    compute_s = flops_dev / mesh_lib.PEAK_BF16_FLOPS
    memory_s = bytes_dev / mesh_lib.HBM_BW
    collective_s = coll_dev / mesh_lib.ICI_BW
    model_fl = M.model_flops(cfg, shape)
    tmp_b = counter.peak - arg_b
    memory = dict(argument_size_in_bytes=arg_b, output_size_in_bytes=out_b,
                  temp_size_in_bytes=tmp_b,
                  alias_size_in_bytes=0 if shape.kind != "train" else None,
                  generated_code_size_in_bytes=None)
    result = dict(
        arch=arch, shape=shape_name, multi_pod=multi_pod, chips=n_chips,
        params=M.param_count(cfg),
        active_params=M.active_param_count(cfg),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev,
        collective_detail=dict(counter.coll, total=coll_dev),
        collective_counts=dict(counter.counts),
        collective_other=dict(counter.other),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(
            (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)), key=lambda t: t[1])[0],
        model_flops=model_fl,
        model_flops_per_device=model_fl / n_chips,
        useful_flops_ratio=(model_fl / n_chips / flops_dev
                            if flops_dev else None),
        model_split=split,
        memory_analysis=memory,
        temp_bytes_per_device=tmp_b,
        argument_bytes_per_device=arg_b,
        cache_bytes_per_device=meta.get("cache_bytes"),
    )
    # the peak above the arguments holds the outputs still live at the end
    result["hbm_required_bytes"] = arg_b + tmp_b
    result["fits_hbm"] = result["hbm_required_bytes"] <= mesh_lib.HBM_BYTES
    result["grad_accum"] = meta["grad_accum"]
    from repro_torch.launch.analytic import Cell, analytic_terms
    names = mesh.mesh_dim_names
    fsdp = int(np.prod([mesh.size(i) for i, a in enumerate(names)
                        if a in ("pod", "data")]))
    opt_b = 2.1 if M.param_count(cfg) > 5e10 else 8.0
    result.update(analytic_terms(Cell(
        cfg=cfg, shape=shape, chips=n_chips,
        tp=mesh.size(names.index("model")), fsdp=fsdp,
        grad_accum=meta["grad_accum"], opt_state_bytes_per_param=opt_b)))
    result["host_seconds"] = time.perf_counter() - t0
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(cbase.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf experiments)")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default: the GPU)")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="with --mesh-model: a (data, model) mesh instead "
                         "of the production one")
    ap.add_argument("--mesh-model", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch instead of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="the sequence length instead of the shape's")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None
    local = None
    if args.mesh_data is not None or args.mesh_model is not None:
        local = (args.mesh_data or 1, args.mesh_model or 1)
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   cfg_overrides=overrides, device=args.device,
                   local_mesh=local, batch=args.batch, seq=args.seq)
    print(json.dumps(res, indent=2, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2, default=str)
    return res


if __name__ == "__main__":
    main()
