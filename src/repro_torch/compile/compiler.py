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
  * **Placement.**  :meth:`CompiledModel.device_executable` and
    :meth:`CompiledModel.run_placed` serve on another device with the same
    batching discipline: the weights are copied and lowered again there
    (``PackedWeight`` keeps its TMA maps on one device's pointers), and
    that device gets graphs of its own.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
when no CUDA device exists; pass ``device="cpu"`` to run the kernels'
plain versions on the CPU.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Union

import torch

from repro_torch.compile import lowering
from repro_torch.compile.backends import Backend, get_backend
from repro_torch.compile.params import ensure_typed
from repro_torch.kernels.common import add_launches, capture_graph
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


class EagerExecutable:
    """One bucket on the CPU: zero-pad ``x`` up to ``batch`` rows, run the
    lowered forward, slice the pad rows off."""

    def __init__(self, forward, batch: int):
        self.forward = forward
        self.batch = batch

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(_pad_rows(x, self.batch))[:x.shape[0]]


class CompiledModel:
    """A quantized network lowered through one backend, served in fixed
    batch buckets, one executable per bucket (a CUDA graph on the GPU).
    Callable: ``logits = cm(images)`` (or ``cm(tokens)`` for an LM).

    The graph goes through ``lowering.annotate_tuning`` as in the JAX
    package, with no table: the port has no tuner yet (ROADMAP item A5),
    so ``stats()["tuning"]`` is ``None``."""

    def __init__(self, cfg, params, backend: Backend,
                 batch_sizes: Sequence[int], device: torch.device):
        if not batch_sizes:
            raise ValueError("need at least one batch bucket")
        if any(b <= 0 for b in batch_sizes):
            raise ValueError(f"batch buckets must be positive: {batch_sizes}")
        self.cfg = cfg
        self.device = device
        self.params = params.to(device)
        self.backend = backend
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.graph = lowering.annotate_tuning(
            lowering.optimized_graph(cfg), None)
        self._forward = backend.lower(self.graph, cfg, self.params)
        self._lowered: Dict[torch.device, Callable] = {device: self._forward}
        self._pools: Dict[torch.device, tuple] = {}
        self._execs: Dict[int, Callable] = {}
        self._dev_execs: Dict[tuple, Callable] = {}
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

    def _capture(self, batch: int, device: torch.device) -> GraphExecutable:
        forward = self._lowering(device)
        shape, dtype = input_shape(self.cfg, batch)
        static_in = torch.zeros(shape, dtype=dtype, device=device)
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        # the warm-up runs the lowered forward; the capture runs it through
        # _staged, which counts the trace
        graph, static_out, per_replay = capture_graph(
            lambda: self._staged(static_in, device),
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

    def _run_batched(self, images: torch.Tensor, exe_for) -> torch.Tensor:
        """THE one home of the serving batching discipline, shared by
        ``__call__`` and ``run_placed``: the smallest bucket >= n, batches
        beyond the largest bucket chunked; ``exe_for(bucket)`` is the
        executable that pads, runs and slices one bucket."""
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        cap = self.batch_sizes[-1]
        if n > cap:
            return torch.cat([self._run_batched(images[i:i + cap], exe_for)
                              for i in range(0, n, cap)], dim=0)
        bucket = self.bucket_for(n)
        self.run_counts[bucket] += 1
        ob = _obs.active()
        if ob is not None:
            # counters only: a replay returns before the device is done,
            # so a span here would time the enqueue, not the work
            ob.metrics.counter(
                "model_runs_total", "bucket executions dispatched").inc(
                    bucket=str(bucket), backend=self.backend.name)
            if n < bucket:
                ob.metrics.counter(
                    "model_pad_rows_total",
                    "zero-pad rows added by bucket rounding").inc(
                        bucket - n, bucket=str(bucket),
                        backend=self.backend.name)
        return exe_for(bucket)(images)

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
                    tuning=None,
                    run_counts=dict(self.run_counts))

    def __repr__(self):
        return (f"CompiledModel({self.cfg.name}, "
                f"backend={self.backend.name!r}, device={self.device}, "
                f"buckets={self.batch_sizes}, "
                f"compiled={sorted(self._execs)})")


def _backend(backend: Union[str, Backend]) -> Backend:
    return get_backend(backend) if isinstance(backend, str) else backend


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
    any device; ``backend`` a registered name or an instance.  Kernel
    tuning is not ported yet: ``tune`` must be None."""
    if tune is not None:
        raise ValueError(
            f"tune={tune!r}: kernel tuning is not available in repro_torch "
            f"yet; pass tune=None")
    cm = CompiledModel(cfg, ensure_typed(qparams), _backend(backend),
                       batch_sizes, resolve_device(device))
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
