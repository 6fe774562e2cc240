"""``compile_model``: optimized graph -> one captured CUDA graph per bucket.

    qp = models.resnet.quantize_params(folded, cfg)        # dict or typed
    cm = compile_model(cfg, qp, backend="cuda", batch_sizes=(1, 8, 32))
    out = cm(images)          # bucket select + copy in + replay + slice

``backend`` is a registered name (``cuda``, ``cuda-stream``, ``torch-int``)
or an instance, e.g. ``CudaStreamBackend(cuts=[[0, 1, 2], [3, 4, 5, 6, 7,
8]])`` for an explicit chain partition.

LM configs serve token batches the same way:

    cfg = lm_config(get_config("gemma-2b"), seq_len=512)
    cm = compile_model(cfg, init_lm_params(cfg, seed=0, device="cuda"),
                       backend="cuda", batch_sizes=(1, 4))
    logits = cm(tokens)       # (n, seq_len) int32 -> (n, vocab) float32

A bucket is then ``(batch, seq_len)`` int32 tokens, padded with zero rows.

The port's counterpart of the JAX package's ahead-of-time executables:

  * **Lowered once.**  The graph is lowered through the backend once per
    device, with the weights placed on that device.
  * **One CUDA graph per bucket.**  On a ``cuda`` device the first call of
    a bucket (or :meth:`CompiledModel.warmup`) allocates a static input,
    runs the lowered forward a few times on a side stream (so the lazy
    state of the kernels, the allocator's blocks and the prepared launches
    exist before the capture) and captures one forward into a
    ``torch.cuda.CUDAGraph``.  A call then copies the caller's rows into
    the static input, zeroes the pad rows, replays the graph and returns a
    clone of the output's first rows, so that a later replay never
    overwrites a result already returned.  A model's graphs share one
    memory pool, so their memory is about that of the largest bucket;
    replays of one model must not run concurrently.  A capture that fails
    raises: nothing falls back to eager.  On ``device="cpu"`` a bucket's
    executable is the eager lowered forward, built and counted the same
    way.
  * **Compile accounting.**  ``trace_counts[b]`` counts the captures of
    bucket ``b``, ``compile_count`` the executables built; a serving loop
    keeps both at one per bucket.  ``run_counts[b]`` counts bucket runs.
  * **Launch counters count replays.**  The kernel wrappers count their
    launches in Python, which a replay does not run: the capture records
    what one forward launched (``kernels.common.launch_delta``) and every
    replay adds it; warm-up and capture leave the counters as they were.
  * **Task counters.**  With an obs session installed, each bucket run
    of an LM adds its plan's tasks to ``model_task_launches_total`` by
    task ``kind`` and ``kernel`` (``torch`` for PyTorch ops alone).
  * **Call spans.**  With an obs session installed, each bucket run
    records a host span ``call`` with children ``copy_in``, ``replay`` and
    ``clone`` on a graph, and on a CUDA device a span of the call's device
    interval from CUDA events, on the session's clock
    (``compile/calltrace.py``).  With none, a run reads the switch once
    and records nothing.
  * **Tuning.**  ``compile_model(tune=...)`` stamps a per-task
    ``KernelConfig`` table onto the graph (``lowering.annotate_tuning``),
    so the kernels' launches take the tuned decomposition
    (``tune.search`` finds one; ``CompiledModel.tuning`` and
    ``stats()["tuning"]`` show it).
  * **Placement.**  :meth:`CompiledModel.device_executable` and
    :meth:`CompiledModel.run_placed` serve on another device with the same
    batching discipline: the weights are copied and lowered again there
    (``PackedWeight`` keeps its TMA maps on one device's pointers), and
    that device gets graphs of its own.
  * **SPMD serving.**  :meth:`CompiledModel.run_sharded` serves a batch
    split over one dim of a ``DeviceMesh``, every rank calling it with
    the same batch: the weights replicated (each rank's own copy, lowered
    once per mesh axis and devices), each rank running its rows through
    its own executable (a CUDA graph of ``bucket / n`` rows), the logits a
    DTensor ``Shard(0)`` over that dim.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
when no CUDA device exists; pass ``device="cpu"`` to run the kernels'
plain versions on the CPU.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.compile import calltrace, lowering
from repro_torch.compile.backends import Backend, get_backend
from repro_torch.compile.params import ensure_typed
from repro_torch.kernels.common import add_launches, capture_graph
from repro_torch.launch.mesh import rank_device
from repro_torch.obs import runtime as _obs

# forwards run on a side stream before a capture
WARMUP_RUNS = 3


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, and ``cuda`` -> the current CUDA device by its
    index, so that one card has one name.  Raises when a CUDA device is
    asked for (or implied) and none exists; never falls back to the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "unless the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def input_shape(cfg, batch: int):
    """THE input contract of a bucket: ``(batch, img, img, 3)`` float32
    images for conv configs, ``(batch, seq_len)`` int32 tokens for LM
    configs.  Returns ``(shape, dtype)``."""
    if lowering._is_lm_cfg(cfg):
        return (batch, cfg.seq_len), torch.int32
    return (batch, cfg.img, cfg.img, 3), torch.float32


class InputSpec(NamedTuple):
    """A bucket's input: its global shape and dtype, and the DTensor
    placements it takes over a mesh (None: one device)."""
    shape: tuple
    dtype: torch.dtype
    placements: Optional[tuple] = None


def _as_input(cfg, x, device) -> torch.Tensor:
    """A caller's batch as the model's input tensor on ``device``; token
    ids are checked against the vocabulary first (an out-of-range id
    would read past the embedding table)."""
    dtype = input_shape(cfg, 0)[1]
    if dtype == torch.float32:
        return torch.as_tensor(x, dtype=dtype, device=device)
    t = torch.as_tensor(x)
    if t.is_floating_point() or t.dtype == torch.bool:
        raise ValueError(f"token ids must be integers, got {t.dtype}")
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size}), got "
                         f"[{int(t.min())}, {int(t.max())}]")
    return t.to(device=device, dtype=dtype)


def _pad_rows(x: torch.Tensor, batch: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``batch`` rows."""
    n = x.shape[0]
    if n >= batch:
        return x
    return torch.cat([x, x.new_zeros((batch - n,) + tuple(x.shape[1:]))])


class GraphExecutable:
    """One bucket's forward captured as a CUDA graph: ``exe(x)`` for a
    batch ``x`` of at most ``batch`` rows on the graph's device copies it
    into the static input, zeroes the pad rows, replays, adds the
    capture's launch counts and returns a clone of the first rows."""

    def __init__(self, graph, static_in, static_out, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches          # kernels.common.launch_delta
        self.batch = static_in.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        self.static_in[:n].copy_(x)
        if n < self.batch:
            self.static_in[n:].zero_()
        self.graph.replay()
        add_launches(self.launches)
        return self.static_out[:n].clone()

    def traced(self, x: torch.Tensor, call) -> torch.Tensor:
        """``self(x)`` with its phases as children of ``call`` (a
        ``calltrace.Call``): ``copy_in``, ``replay``, ``clone``."""
        n = x.shape[0]
        with call.phase("copy_in"):
            self.static_in[:n].copy_(x)
            if n < self.batch:
                self.static_in[n:].zero_()
        with call.phase("replay"):
            self.graph.replay()
        add_launches(self.launches)
        with call.phase("clone"):
            return self.static_out[:n].clone()


class EagerExecutable:
    """One bucket on the CPU: zero-pad ``x`` up to ``batch`` rows, run the
    lowered forward, slice the pad rows off."""

    def __init__(self, forward, batch: int):
        self.forward = forward
        self.batch = batch

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(_pad_rows(x, self.batch))[:x.shape[0]]

    def traced(self, x: torch.Tensor, call) -> torch.Tensor:
        """``self(x)``: an eager forward records no phase under ``call``."""
        return self(x)


class ShardExecutable:
    """One bucket split over one mesh dim: ``exe(x)`` for a batch ``x``
    of at most ``batch`` rows (the same on every rank) zero-pads it to the
    bucket, runs this rank's ``batch / n`` rows through its local
    executable and returns the ``x.shape[0]`` rows' logits as a DTensor
    ``Shard(0)`` over the dim."""

    def __init__(self, local, mesh, axis, batch: int):
        from repro_torch.parallel.sharding import spec_to_placements
        self.local, self.mesh, self.batch = local, mesh, batch
        self.placements = spec_to_placements((axis,), mesh)
        d = tuple(mesh.mesh_dim_names).index(axis)
        self.index = mesh.get_local_rank(d)
        self.rows = batch // mesh.size(d)

    def __call__(self, x: torch.Tensor):
        return self._run(x, self.local)

    def traced(self, x: torch.Tensor, call):
        """``self(x)``, the local executable's phases under ``call``."""
        return self._run(x, lambda rows: self.local.traced(rows, call))

    def _run(self, x: torch.Tensor, local):
        from torch.distributed.tensor import DTensor, Replicate
        n = x.shape[0]
        r0 = self.index * self.rows
        loc = local(_pad_rows(x, self.batch)[r0:r0 + self.rows])
        shape = (self.batch,) + tuple(loc.shape[1:])
        out = DTensor.from_local(loc, self.mesh, self.placements,
                                 run_check=False, shape=torch.Size(shape),
                                 stride=torch.empty(shape, device="meta")
                                 .stride())
        if n < self.batch:
            # the pad rows sliced off: the first n rows, split anew
            rep = [Replicate()] * self.mesh.ndim
            out = out.redistribute(self.mesh, rep)[:n].redistribute(
                self.mesh, self.placements)
        return out


class CompiledModel:
    """A quantized network lowered through one backend, served in fixed
    batch buckets, one executable per bucket (a CUDA graph on the GPU).
    Callable: ``logits = cm(images)`` (or ``cm(tokens)`` for an LM).

    ``tuning`` (task key -> ``KernelConfig``, or None) goes onto the graph
    through ``lowering.annotate_tuning`` as in the JAX package."""

    def __init__(self, cfg, params, backend: Backend,
                 batch_sizes: Sequence[int], device: torch.device,
                 tuning=None):
        if not batch_sizes:
            raise ValueError("need at least one batch bucket")
        if any(b <= 0 for b in batch_sizes):
            raise ValueError(f"batch buckets must be positive: {batch_sizes}")
        self.cfg = cfg
        self.device = device
        self.params = params.to(device)
        self.backend = backend
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.tuning = tuning
        self.graph = lowering.annotate_tuning(
            lowering.optimized_graph(cfg), tuning)
        self._forward = backend.lower(self.graph, cfg, self.params)
        # an LM's task program, by (kind, kernel): what a bucket run runs
        self.task_counts = dict(getattr(self._forward, "task_counts", {}))
        self._lowered: Dict[torch.device, Callable] = {device: self._forward}
        self._pools: Dict[torch.device, tuple] = {}
        self._execs: Dict[int, Callable] = {}
        self._dev_execs: Dict[tuple, Callable] = {}
        self._shard_execs: Dict[tuple, Callable] = {}
        self._shard_lowered: Dict[tuple, Callable] = {}
        self.trace_counts: Dict[int, int] = {}
        self.compile_count = 0
        self.run_counts: Dict[int, int] = {b: 0 for b in self.batch_sizes}

    # -- compilation --------------------------------------------------------

    def _note_trace(self, bucket: int) -> None:
        # one count a capture; the count is the retrace detector
        n = self.trace_counts[bucket] = self.trace_counts.get(bucket, 0) + 1
        ob = _obs.active()
        if ob is not None:
            ob.metrics.counter(
                "compile_traces_total", "per-bucket trace events").inc(
                    bucket=str(bucket), backend=self.backend.name)
            if n > 1:
                # a bucket captured twice means an executable was rebuilt —
                # the regression the bucket discipline exists to prevent
                ob.metrics.counter(
                    "compile_retraces_total",
                    "per-bucket retraces (should stay 0 in serving)").inc(
                        bucket=str(bucket), backend=self.backend.name)
                ob.trace.instant("retrace", cat="compile", track="compile",
                                 bucket=bucket, backend=self.backend.name)

    def _staged(self, images: torch.Tensor, device=None) -> torch.Tensor:
        """One traced forward of a full bucket: counts the trace, then runs
        the lowered forward of ``device`` (default: the model's).  A
        capture runs it inside ``torch.cuda.graph``; calling it again
        counts a second trace of the bucket, as a rebuilt executable
        would."""
        self._note_trace(images.shape[0])
        return self._lowering(device or self.device)(images)

    def _note_compile(self, kind: str, bucket: int, wall_s: float) -> None:
        """Record one executable build in the active obs session.  The
        event timestamp is in the session's clock domain; the measured
        build time travels as the volatile ``wall_us`` arg."""
        self.compile_count += 1
        ob = _obs.active()
        if ob is None:
            return
        ob.trace.instant("compile", cat="compile", track="compile",
                         kind=kind, bucket=bucket, backend=self.backend.name,
                         wall_us=round(wall_s * 1e6, 1))
        ob.metrics.counter(
            "compile_executables_total", "bucket executables built").inc(
                kind=kind, bucket=str(bucket), backend=self.backend.name)

    def _lowering(self, device: torch.device) -> Callable:
        """The backend's forward on ``device``: the weights copied there
        and lowered once, on first use."""
        if device not in self._lowered:
            self._lowered[device] = self.backend.lower(
                self.graph, self.cfg, self.params.to(device))
        return self._lowered[device]

    def _build(self, batch: int, device: torch.device, kind: str):
        if batch not in self.batch_sizes:
            raise ValueError(
                f"batch {batch} is not a compiled bucket {self.batch_sizes}")
        t0 = time.perf_counter()
        if device.type == "cuda":
            exe = self._capture(batch, device)
        else:
            self._note_trace(batch)
            exe = EagerExecutable(self._lowering(device), batch)
        self._note_compile(kind, batch, time.perf_counter() - t0)
        return exe

    def input_spec(self, batch: int, placements=None) -> InputSpec:
        """THE input-shape contract of every executable this model builds
        (default, per-device and SPMD): ``input_shape`` of the bucket, with
        its placements over a mesh when given."""
        shape, dtype = input_shape(self.cfg, batch)
        return InputSpec(tuple(shape), dtype,
                         None if placements is None else tuple(placements))

    def _capture(self, batch: int, device: torch.device, forward=None,
                 rows: Optional[int] = None) -> GraphExecutable:
        """The CUDA graph of ``rows`` rows (default: the bucket's) of
        ``forward`` (default: the model's lowering on ``device``); the
        capture counts a trace of bucket ``batch``."""
        forward = forward or self._lowering(device)
        shape = list(self.input_spec(batch).shape)
        shape[0] = batch if rows is None else rows
        static_in = torch.zeros(shape, dtype=self.input_spec(batch).dtype,
                                device=device)
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        # the warm-up runs the lowered forward; the capture runs it through
        # staged, which counts the trace
        def staged():
            self._note_trace(batch)
            return forward(static_in)

        graph, static_out, per_replay = capture_graph(
            staged,
            warmup=WARMUP_RUNS, warm=lambda: forward(static_in),
            pool=self._pools[device], device=device)
        return GraphExecutable(graph, static_in, static_out, per_replay)

    def executable(self, batch: int) -> Callable:
        """The executable of one bucket on the model's device (built on
        first use, then reused for the model's lifetime)."""
        if batch not in self._execs:
            self._execs[batch] = self._build(batch, self.device, "default")
        return self._execs[batch]

    def warmup(self) -> "CompiledModel":
        """Build every bucket, the largest first (its graph sizes the
        shared memory pool that the smaller ones reuse)."""
        for b in reversed(self.batch_sizes):
            self.executable(b)
        return self

    # -- placement ----------------------------------------------------------

    def device_executable(self, batch: int, device) -> Callable:
        """The executable of one bucket on ``device``: a replica's own
        weights, lowering and graph, counted in ``compile_count``."""
        device = resolve_device(device)
        key = (int(batch), device)
        if key not in self._dev_execs:
            self._dev_execs[key] = self._build(batch, device, "device")
        return self._dev_execs[key]

    def run_placed(self, images, device) -> torch.Tensor:
        """``__call__`` pinned to ``device``: the same batching discipline,
        the batch and the result on that device.  Bitwise the same as the
        default path: placement never changes the arithmetic."""
        device = resolve_device(device)
        return self._run_batched(
            _as_input(self.cfg, images, device),
            lambda bucket: self.device_executable(bucket, device))

    def shard_executable(self, mesh, batch: int, axis: str = "data"):
        """The SPMD executable of bucket ``batch`` over ``mesh``: the
        batch dim split over mesh dim ``axis``, the weights replicated
        (this rank's whole copy).  ``batch`` must divide over the dim.
        The weights' lowering depends only on the dim and the mesh's
        devices, not the bucket: lowered once per ``(axis, devices)``,
        shared across buckets; one executable per ``(batch, axis, mesh
        shape, devices)``, counted in ``compile_count``."""
        from repro_torch.parallel.sharding import axis_size, mesh_shape

        n_dev = axis_size(mesh, axis)
        if batch not in self.batch_sizes:
            raise ValueError(
                f"batch {batch} is not a compiled bucket {self.batch_sizes}")
        if batch % n_dev != 0:
            raise ValueError(
                f"bucket {batch} must be divisible by mesh axis "
                f"{axis!r} (size {n_dev})")
        devs = (mesh.device_type, tuple(mesh.mesh.flatten().tolist()))
        # the mesh's axis structure is part of the key: two meshes over the
        # same ranks (4x1 'data','model' vs 2x2) split the batch apart
        key = (int(batch), axis, tuple(mesh_shape(mesh).items()), devs)
        if key not in self._shard_execs:
            device = rank_device(mesh)
            lkey = (axis, devs)
            if lkey not in self._shard_lowered:
                self._shard_lowered[lkey] = self.backend.lower(
                    self.graph, self.cfg, self.params.to(device))
            forward = self._shard_lowered[lkey]
            rows = batch // n_dev
            t0 = time.perf_counter()
            if device.type == "cuda":
                local = self._capture(batch, device, forward, rows)
            else:
                def local(x, forward=forward, bucket=batch):
                    self._note_trace(bucket)
                    return forward(x)
                local = EagerExecutable(local, rows)
            self._shard_execs[key] = ShardExecutable(local, mesh, axis,
                                                     batch)
            self._note_compile("shard", batch, time.perf_counter() - t0)
        return self._shard_execs[key]

    def run_sharded(self, images, mesh, axis: str = "data"):
        """Serve ``images`` (the same batch on every rank of ``mesh``)
        split over mesh dim ``axis``, with the shared bucket discipline
        restricted to the buckets that divide over the dim; returns the
        logits as a DTensor ``Shard(0)`` over the dim.  Bitwise the same
        as ``__call__``: sharding never changes the arithmetic."""
        from repro_torch.parallel.sharding import axis_size

        n_dev = axis_size(mesh, axis)
        fits = tuple(b for b in self.batch_sizes if b % n_dev == 0)
        if not fits:
            raise ValueError(
                f"no compiled bucket in {self.batch_sizes} divides over "
                f"mesh axis {axis!r} (size {n_dev})")
        return self._run_batched(
            _as_input(self.cfg, images, rank_device(mesh)),
            lambda bucket: self.shard_executable(mesh, bucket, axis), fits)

    # -- dispatch -----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest if n exceeds every bucket — the
        caller chunks in that case)."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def pad(self, images: torch.Tensor) -> torch.Tensor:
        """Zero-pad a batch (images, or token rows) of at most the largest
        bucket up to its bucket: the batch a bucket run computes on."""
        return _pad_rows(images, self.bucket_for(images.shape[0]))

    def _run_batched(self, images: torch.Tensor, exe_for,
                     buckets=None) -> torch.Tensor:
        """THE one home of the serving batching discipline, shared by
        ``__call__``, ``run_placed`` and ``run_sharded``: the smallest
        bucket >= n of ``buckets`` (default: every bucket), batches beyond
        the largest bucket chunked; ``exe_for(bucket)`` is the executable
        that pads, runs and slices one bucket."""
        buckets = self.batch_sizes if buckets is None else buckets
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        cap = buckets[-1]
        if n > cap:
            return torch.cat([self._run_batched(images[i:i + cap], exe_for,
                                                buckets)
                              for i in range(0, n, cap)], dim=0)
        bucket = next(b for b in buckets if b >= n)
        ob = _obs.active()
        if ob is None:
            self.run_counts[bucket] += 1
            return exe_for(bucket)(images)
        # the host spans time the enqueue (a replay returns before the
        # device is done); the device span, from CUDA events around the
        # call, times the work (compile/calltrace.py)
        with calltrace.tracer(ob).call(images.device, bucket=bucket,
                                       backend=self.backend.name) as call:
            self.run_counts[bucket] += 1
            ob.metrics.counter(
                "model_runs_total", "bucket executions dispatched").inc(
                    bucket=str(bucket), backend=self.backend.name)
            for (kind, kernel), k in self.task_counts.items():
                ob.metrics.counter(
                    "model_task_launches_total",
                    "LM task launches by task kind and kernel").inc(
                        k, kind=kind, kernel=kernel, bucket=str(bucket),
                        backend=self.backend.name)
            if n < bucket:
                ob.metrics.counter(
                    "model_pad_rows_total",
                    "zero-pad rows added by bucket rounding").inc(
                        bucket - n, bucket=str(bucket),
                        backend=self.backend.name)
            return exe_for(bucket).traced(images, call)

    def __call__(self, images) -> torch.Tensor:
        return self._run_batched(_as_input(self.cfg, images, self.device),
                                 self.executable)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        return dict(backend=self.backend.name, device=str(self.device),
                    batch_sizes=self.batch_sizes,
                    compiled=sorted(self._execs),
                    placed=sorted((b, str(d)) for b, d in self._dev_execs),
                    compile_count=self.compile_count,
                    trace_counts=dict(self.trace_counts),
                    tuning={t: c.to_dict()
                            for t, c in sorted(self.tuning.items())}
                    if self.tuning else None,
                    run_counts=dict(self.run_counts))

    def __repr__(self):
        return (f"CompiledModel({self.cfg.name}, "
                f"backend={self.backend.name!r}, device={self.device}, "
                f"buckets={self.batch_sizes}, "
                f"compiled={sorted(self._execs)})")


def _backend(backend: Union[str, Backend]) -> Backend:
    return get_backend(backend) if isinstance(backend, str) else backend


def _resolve_tuning(cfg, params, backend_name, batch_sizes, tune, device):
    """Normalize the ``tune`` argument of :func:`compile_model` into a
    task->KernelConfig dict (or None).  Accepted forms:

      * ``None`` / ``False``   — untuned (each kernel's own rule).
      * a dict                 — an explicit per-task assignment (the format
                                 ``tune.search`` returns / the cache stores).
      * a ``TuneResult``       — its ``.tuning``.
      * ``"auto"``             — cache hit or run the full two-stage search
                                 on ``device``.
      * ``"analytic"``         — cost-model stage only (no timing).
      * ``"device"``           — force a fresh two-stage search (still
                                 written back to the cache).
    """
    from repro_torch.tune.config import KernelConfig

    if tune is None or tune is False:
        return None
    if hasattr(tune, "tuning"):          # TuneResult without importing it
        return tune.tuning
    if isinstance(tune, dict):
        # normalize cache-style {"task": {"knob": v}} entries to KernelConfig
        # so stats()/engine introspection sees one type
        return {task: c if isinstance(c, KernelConfig)
                else KernelConfig.from_dict(c)
                for task, c in tune.items()}
    if isinstance(tune, str):
        if tune not in ("auto", "analytic", "device"):
            raise ValueError(
                f"tune={tune!r}: expected a task->KernelConfig dict, a "
                f"TuneResult, or one of 'auto'/'analytic'/'device'")
        if lowering._is_lm_cfg(cfg):
            raise ValueError(
                f"tune={tune!r}: the search modes cover conv configs only; "
                f"pass an explicit task->KernelConfig dict for LM config "
                f"{cfg.name!r} (spaces: tune.space.lm_model_space)")
        from repro_torch import tune as T   # lazy: repro_torch.tune uses us
        return T.search(cfg, params, backend=backend_name,
                        batch=max(batch_sizes),
                        device=tune != "analytic",
                        use_cache=tune != "device", target=device).tuning
    raise TypeError(f"unsupported tune argument: {type(tune).__name__}")


def compile_model(cfg, qparams, backend: Union[str, Backend] = "cuda",
                  batch_sizes: Sequence[int] = (1, 8, 32),
                  eager: bool = False, tune=None,
                  device=None) -> CompiledModel:
    """Lower the optimized graph of ``cfg`` through ``backend`` into a
    :class:`CompiledModel` on ``device`` (default ``cuda``) with one
    executable per batch bucket, built on first use or, with
    ``eager=True``, here.

    ``qparams`` may be the ``quantize_params`` dict, a typed
    :class:`QResNetParams` or, for an LM config, a :class:`QLMParams`, on
    any device; ``backend`` a registered name or an instance.  ``tune``
    selects the kernels' decomposition: a per-task dict / ``TuneResult``
    from ``repro_torch.tune``, or ``"auto"``/``"analytic"``/``"device"``
    to run the search here, on ``device`` (see :func:`_resolve_tuning`)."""
    dev = resolve_device(device)
    params = ensure_typed(qparams)
    be = _backend(backend)
    tuning = _resolve_tuning(cfg, params, be.name, batch_sizes, tune, dev)
    cm = CompiledModel(cfg, params, be, batch_sizes, dev, tuning=tuning)
    if eager:
        cm.warmup()
    return cm


def lower_forward(cfg, qparams, backend: Union[str, Backend],
                  device=None) -> Callable:
    """Un-bucketed lowering: the backend's ``images -> logits`` (or
    ``tokens -> logits``) on ``device`` (default ``cuda``), run eagerly."""
    dev = resolve_device(device)
    params = ensure_typed(qparams).to(dev)
    fwd = _backend(backend).lower(lowering.optimized_graph(cfg), cfg, params)
    return lambda images: fwd(_as_input(cfg, images, dev))


def lower_features(cfg, qparams, backend: Union[str, Backend],
                   device=None) -> Callable:
    """Un-bucketed ``images -> u8 feature map`` (the integer datapath up to
    the classifier head) of ``backend`` on ``device`` (default ``cuda``);
    for an LM, ``tokens -> int8 hidden state`` entering the unembed."""
    dev = resolve_device(device)
    params = ensure_typed(qparams).to(dev)
    feats = _backend(backend).features(lowering.optimized_graph(cfg), cfg,
                                       params)
    return lambda images: feats(_as_input(cfg, images, dev))
