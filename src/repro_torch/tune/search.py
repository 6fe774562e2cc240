"""Two-stage design-space search: analytic ranking, then timing on the card.

The port's copy of ``repro.tune.search`` (the software Algorithm 1 of the
paper's §III-E):

  stage 1  — enumerate the legal per-task space (``tune.space``, on the
             card with its occupancy query), rank every candidate with the
             roofline cost model (``tune.cost``), and assemble K joint
             model tunings: the analytic best per task, the runner-ups,
             and always the untuned default (so the device stage can never
             regress below the shipping config).
  stage 2  — compile each survivor through ``repro_torch.compile`` and
             race its served calls (on the GPU, CUDA graph replays)
             against the incumbent's (the untuned default first) on a
             probe batch, *interleaved* and synchronized before every clock
             read, the median over ``reps``; a challenger must measure
             faster head-to-head to take the crown, so the winner is
             measured no worse than the shipping config.

The winner is validated bitwise against the untuned ``torch-int``
reference (a tuning may only ever change the schedule, never a single
logit bit; a mismatch falls back to the default with
``source="device-fallback"``) and persisted in the JSON config cache keyed
on (model, shapes, dtype, backend, device kind) — the next
``compile_model(..., tune="auto")`` is a cache hit.

``repro_torch.compile`` is imported lazily: ``compile.lowering`` imports
``tune.config`` at module load, so a top-level back-import would cycle.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.tune import cache as tcache
from repro_torch.tune import cost as tcost
from repro_torch.tune import space as tspace
from repro_torch.tune.config import KernelConfig


def _device(target=None) -> torch.device:
    from repro_torch.compile.compiler import resolve_device
    return resolve_device(target)


def device_kind(target=None) -> str:
    """Cache-key identity of the card (``target``, default ``cuda``): its
    name and compute capability, or ``cpu``.  Their optima differ."""
    dev = _device(target)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    name = torch.cuda.get_device_name(dev).replace(" ", "-")
    return f"{name}:sm_{major}{minor}"


def model_key(cfg, batch: int, backend: str, target=None) -> str:
    return tcache.cache_key(f"model:{cfg.name}",
                            ((batch, cfg.img, cfg.img, 3),),
                            "float32", backend, device_kind(target))


@dataclasses.dataclass
class TuneResult:
    """What the search decided and why."""
    model: str
    backend: str
    batch: int
    tuning: Dict[str, KernelConfig]
    source: str                        # "cache" | "analytic" | "device"
    space_size: int                    # joint-space cardinality
    candidates: int                    # joint candidates actually considered
    modeled: Dict[str, dict]           # task -> Cost.to_dict() of the winner
    timings_us: Dict[str, float]       # stage-2 measurements per candidate
    cache_stats: dict

    def config_dict(self) -> Dict[str, dict]:
        return {task: c.to_dict() for task, c in self.tuning.items()}

    def describe(self) -> str:
        return _label(self.tuning)

    def to_dict(self) -> dict:
        return dict(model=self.model, backend=self.backend, batch=self.batch,
                    source=self.source, space_size=self.space_size,
                    candidates=self.candidates, tuning=self.config_dict(),
                    modeled=self.modeled, timings_us=self.timings_us,
                    cache=self.cache_stats)


def rank_spaces(cfg, batch: int, spaces: Dict[str, List[KernelConfig]],
                backend: str = "cuda") -> Dict[str, List[KernelConfig]]:
    """Stage 1: each task's candidates ordered by modeled time (stable, so
    ties keep the space's order)."""
    return {task: sorted(cands, key=lambda c, task=task: tcost.task_cost(
                cfg, batch, backend, task, c).modeled_s)
            for task, cands in spaces.items()}


def joint_candidates(ranked: Dict[str, List[KernelConfig]], top_k: int
                     ) -> List[Dict[str, KernelConfig]]:
    """K joint tunings from the per-task rankings (rank j across every task,
    clamped to each task's space), plus the untuned default — deduplicated,
    analytic-best first."""
    out = []
    for j in range(max(1, top_k)):
        cand = {task: lst[min(j, len(lst) - 1)]
                for task, lst in ranked.items() if lst}
        if cand not in out:
            out.append(cand)
    default = {task: KernelConfig() for task in ranked}
    if default not in out:
        out.append(default)
    return out


def _probe_images(cfg, batch: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.random((batch, cfg.img, cfg.img, 3)).astype(np.float32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def interleaved_time(cm_a, cm_b, probe: torch.Tensor, reps: int = 3,
                     calls: int = 1):
    """Median wall time (us) of one served call of each of two compiled
    models on ``probe`` (a batch on their device), measured *interleaved*
    (a, b, a, b, ...) so that drift of the host hits both sides equally.
    Each sample is ``calls`` back-to-back calls between two clock reads,
    the device synchronized before each read.  Returns (us_a, us_b)."""
    dev = probe.device
    cm_a(probe)                                    # build + warm
    cm_b(probe)
    ta, tb = [], []
    for _ in range(max(1, reps)):
        for cm, ts in ((cm_a, ta), (cm_b, tb)):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(max(1, calls)):
                cm(probe)
            _sync(dev)
            ts.append((time.perf_counter() - t0) / max(1, calls) * 1e6)
    return float(statistics.median(ta)), float(statistics.median(tb))


def _label(tuning: Dict[str, KernelConfig]) -> str:
    return ";".join(f"{t}:{c.describe()}" for t, c in sorted(tuning.items())
                    if c.to_dict()) or "default"


def _same_logits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The bitwise check a tuning must pass against ``torch-int``."""
    return torch.equal(a, b)


def _capacity(dev: torch.device):
    """The card's cluster occupancy query (``capacity`` of
    ``tspace.chain_tilings``), or None off the GPU."""
    if dev.type != "cuda":
        return None
    from repro_torch.kernels.megakernel.ops import max_clusters

    def capacity(split, smem):
        with torch.cuda.device(dev):
            return max_clusters(split, smem)
    return capacity


def search(cfg, qparams, backend: str = "cuda", batch: int = 8,
           top_k: int = 3, device: bool = True, validate: bool = True,
           cache: Optional[tcache.TuneCache] = None,
           use_cache: bool = True, reps: int = 3, calls: int = 10,
           target=None) -> TuneResult:
    """Find the per-task ``KernelConfig`` assignment for ``cfg`` at one batch
    bucket on a kernel backend (``cuda`` or ``cuda-stream``), compiled and
    timed on ``target`` (default ``cuda``; raises without a GPU unless
    ``target="cpu"``, where the plain versions are timed).

    ``device=False`` stops after the analytic stage — no timing; the
    bitwise probe still compiles one small tuned/reference pair unless
    ``validate=False`` too.  The result is served from / written to the
    JSON config cache unless ``use_cache=False``."""
    from repro_torch.compile import lowering

    if lowering._is_lm_cfg(cfg):
        raise ValueError(f"tune.search covers conv configs only, not "
                         f"{cfg.name!r}")
    dev = _device(target)
    cache = cache if cache is not None else tcache.TuneCache()
    key = model_key(cfg, batch, backend, dev)
    if use_cache:
        hit = cache.get(key)
        if hit is not None:
            return TuneResult(
                model=cfg.name, backend=backend, batch=batch, tuning=hit,
                source="cache", space_size=0, candidates=0,
                modeled={t: c.to_dict() for t, c in tcost.model_cost(
                    cfg, batch, hit, backend).items()},
                timings_us={}, cache_stats=cache.stats())

    spaces = tspace.model_space(cfg, batch, backend,
                                capacity=_capacity(dev))
    ranked = rank_spaces(cfg, batch, spaces, backend)
    cands = joint_candidates(ranked, top_k)
    default = {task: KernelConfig() for task in ranked}

    def build(tuning, n, name=backend):
        from repro_torch.compile import compile_model
        return compile_model(cfg, qparams, backend=name, batch_sizes=(n,),
                             tune=tuning, device=dev)

    timings: Dict[str, float] = {}
    if device:
        probe = torch.as_tensor(_probe_images(cfg, batch), device=dev)
        # king-of-the-hill with the DEFAULT as the first incumbent: every
        # challenger must beat the incumbent in an interleaved head-to-head,
        # so the winner is measured no worse than the shipping config
        incumbent, inc_cm = default, build(default, batch)
        for tuning in cands:
            if tuning == incumbent:
                continue
            cm = build(tuning, batch)
            us_c, us_inc = interleaved_time(cm, inc_cm, probe, reps=reps,
                                            calls=calls)
            timings[_label(tuning)] = round(us_c, 3)
            timings[_label(incumbent)] = round(us_inc, 3)
            if us_c < us_inc:
                incumbent, inc_cm = tuning, cm
        tuning, best_cm, source = incumbent, inc_cm, "device"
        if validate:
            ref = build(None, batch, "torch-int")(probe)
            if not _same_logits(best_cm(probe), ref):
                # a tuning must never change a logit bit; fall back to the
                # shipping default rather than serve wrong numbers
                tuning, source = default, "device-fallback"
    else:
        tuning, source = cands[0], "analytic"
        if validate:
            n = min(batch, 2)
            probe = torch.as_tensor(_probe_images(cfg, n), device=dev)
            if not _same_logits(build(tuning, n)(probe),
                                build(None, n, "torch-int")(probe)):
                tuning, source = default, "analytic-fallback"

    if use_cache:
        cache.put(key, tuning)
        cache.save()
    return TuneResult(
        model=cfg.name, backend=backend, batch=batch, tuning=tuning,
        source=source, space_size=tspace.space_size(spaces),
        candidates=len(cands),
        modeled={t: c.to_dict() for t, c in tcost.model_cost(
            cfg, batch, tuning, backend).items()},
        timings_us=timings, cache_stats=cache.stats())
