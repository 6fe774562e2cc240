"""Spans of ``CompiledModel``'s bucket runs, recorded in an obs session.

With a session installed (``obs.instrument()``), every bucket run of
``CompiledModel._run_batched`` records:

* **host spans** on track ``calls`` (``cat`` ``compile``): ``call``, one
  bucket run from its chosen bucket to the returned tensor, and on a
  ``GraphExecutable`` its three children ``copy_in`` (the copy into the
  static input and the pad rows' zeroing), ``replay`` (``graph.replay()``)
  and ``clone`` (the output rows' clone).  Each carries ``call=<n>``, one
  number a bucket run of the session; a child also ``parent="call"``.
  On a CUDA device a fourth child, ``timer``, just before the first,
  holds the tracer's own work there: the start event's record below (and
  on the session's first call the anchor and the ring).  ``call``'s self
  time, its duration less its children's, is the Python of dispatch,
  ``add_launches`` and the counters; the end event is recorded after the
  span ends, so no part of the device timing lies in it.
* **device spans** on a CUDA device: ``call`` on track ``device
  <device>`` (``cat`` ``kernel``, a wall measurement that
  ``strip_volatile`` zeroes), with the same ``call=<n>``.  It runs from an
  event recorded on the current stream just before the first child
  (``copy_in``) to one recorded after the host span ends, after
  ``clone``, so it covers the call's device work and whatever idle lies
  between.  A call whose executable has no children (eager, on the CPU)
  has none.

The call path keeps clock reads and takes no span object: a span costs
some 2.3 us of host time on an H100's host, five a call.  The spans enter
the session's trace at ``Observability.flush()`` (``obs.export`` calls
it), in call order, the device spans as their events are read.

Times are on the session's clock.  With no clock injected that is
``time.monotonic``, and the spans carry the measured times.  Under an
injected clock (a ``FakeClock`` simulation) a host span sits at the
clock's ``now()`` as the call began, with no duration, and its measured
duration travels as the volatile ``wall_us`` arg, as
``CompiledModel._note_compile`` does, so a seeded run exports the same
bytes after ``strip_volatile``.

Device times reach the host clock through an **anchor**: on a session's
first traced run on a device, an event is recorded on an idle side stream
and synchronized between two host clock reads, ``ANCHOR_TRIES`` times;
the tightest try is kept, its event's host time taken as the midpoint of
its reads, and the anchor instant on the device track carries their
distance (``wall_us``), the mapping's uncertainty.  Every later event is
placed at the anchor's host time plus its ``elapsed_time`` from the
anchor.  The device's clock runs apart from the host's by some us a
second (8.5 on an H100 against ``time.monotonic``), so ``flush()``, which
waits anyway, takes a new anchor and moves the device spans placed since
the last one onto the line between the two.

Nothing on the call path waits or reads an event.  A call's two events
come from a ring of ``RING`` pairs, made and created on the device with
the anchor, and recorded on the device's current stream, which is looked
up in full (``torch.cuda.current_stream``, 2-5 us of host) only when
its id has changed.  The pairs are read (two ``elapsed_time`` calls, 7 us
each on an H100's host) at ``flush()``, which waits for each and frees
the ring; a call that finds every pair of the ring recorded since the
last flush goes untimed on the device (``DeviceTimer.dropped``), so a
session that wants every call timed flushes at least every ``RING``
calls.

While ``torch.profiler`` records, each host span also runs inside
``torch.profiler.record_function(<name>)``, so the profiler's trace shows
the call's phases as annotations beside the kernels they launch.
"""
from __future__ import annotations

import time

import torch

TRACK = "calls"
RING = 4096        # event pairs a device: timed calls between flushes
ANCHOR_TRIES = 5   # record-and-synchronize rounds an anchor, the tightest kept


def anchor_event(device: torch.device, host_now):
    """``(event, host, uncertainty)``: an event that completed on an idle
    side stream of ``device`` at host time ``host`` (``host_now``'s clock)
    give or take half of ``uncertainty`` (seconds), the tightest of
    ``ANCHOR_TRIES`` rounds."""
    side = torch.cuda.Stream(device)
    best = None
    for _ in range(ANCHOR_TRIES):
        event = torch.cuda.Event(enable_timing=True)
        w0 = time.monotonic()
        h0 = host_now()
        event.record(side)
        event.synchronize()
        h1 = host_now()
        w1 = time.monotonic()
        if best is None or w1 - w0 < best[2]:
            best = (event, (h0 + h1) / 2, w1 - w0)
    return best


def stream_id(index: int) -> int:
    """The id of device ``index``'s current stream (0.35 us of an H100's
    host, against 2-5 us for ``torch.cuda.current_stream``)."""
    return torch._C._cuda_getCurrentStream(index)[0]


class DeviceTimer:
    """CUDA event pairs around the bucket runs on one device, placed on
    the host clock through ``anchor``, an event that completed at host time
    ``anchor_host`` give or take half of ``uncertainty`` (seconds)."""

    def __init__(self, pairs, anchor, anchor_host: float,
                 uncertainty: float, index: int = 0):
        self.pairs = pairs                  # [(start, end)], the ring
        self.anchor = anchor
        self.anchor_host = anchor_host
        self.uncertainty = uncertainty
        self.index = index                  # the device's CUDA index
        self.stream = self.stream_id = None
        self.used = 0           # pairs begun since the last read
        self.pending = []       # (slot, call) with both events recorded
        self.placed = []        # device spans placed through this anchor
        self.dropped = 0

    @classmethod
    def on(cls, device: torch.device, host_now) -> "DeviceTimer":
        """A timer for ``device`` with its ring of events and its anchor,
        taken now; ``host_now`` reads the session's clock."""
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(RING)]
        side = torch.cuda.Stream(device)
        for pair in pairs:          # a torch event is created on the device
            for event in pair:      # at its first record: do that here
                event.record(side)
        side.synchronize()
        return cls(pairs, *anchor_event(device, host_now),
                   index=device.index)

    def reanchor(self, anchor, anchor_host: float,
                 uncertainty: float) -> None:
        """Move to a new anchor, and the spans placed through the old one
        onto the line between the two: ``t0`` the old anchor's host time,
        ``t1`` the new one's as the old placed it, a time ``t`` moves by
        ``(anchor_host - t1) * (t - t0) / (t1 - t0)``."""
        t0 = self.anchor_host
        t1 = t0 + self.anchor.elapsed_time(anchor) * 1e-3
        if t1 > t0:
            for e in self.placed:
                e.ts += (anchor_host - t1) * (e.ts - t0) / (t1 - t0)
        self.placed = []
        self.anchor, self.anchor_host, self.uncertainty = \
            anchor, anchor_host, uncertainty

    def current_stream(self):
        """The device's current stream, looked up again only when its id
        differs from the last one's."""
        sid = stream_id(self.index)
        if sid != self.stream_id:
            self.stream = torch.cuda.current_stream(self.index)
            self.stream_id = sid
        return self.stream

    def begin(self):
        """Record a call's start event on the current stream; its ring
        slot, or None when every pair was begun since the last read (the
        call goes untimed)."""
        slot = self.used
        if slot == len(self.pairs):
            self.dropped += 1
            return None
        self.used += 1
        self.pairs[slot][0].record(self.current_stream())
        return slot

    def end(self, slot: int, call: int) -> None:
        """Record the end event of the call begun in ``slot``, on the
        stream of its start."""
        self.pairs[slot][1].record(self.stream)
        self.pending.append((slot, call))

    def read(self) -> list:
        """``[(call, start, end)]`` on the host clock for each call timed
        since the last read, oldest first, waiting for its end event; the
        ring is free again after."""
        out = []
        for slot, call in self.pending:
            start, end = self.pairs[slot]
            end.synchronize()
            t0 = self.anchor_host + self.anchor.elapsed_time(start) * 1e-3
            out.append((call, t0, t0 + start.elapsed_time(end) * 1e-3))
        self.pending, self.used = [], 0
        return out


class Phase:
    """One child span of a call: ``with call.phase("replay"): ...``; on a
    CUDA device the call's first records its device start, in a child
    ``timer`` of its own."""

    __slots__ = ("call", "name", "t0", "annotation")

    def __init__(self, call: "Call", name: str):
        self.call, self.name, self.annotation = call, name, None

    def __enter__(self):
        call = self.call
        if call.device_start:
            call.device_start = False
            t0 = time.monotonic()
            call.timed = call.tracer.begin_device(call.device)
            call.phases.append(("timer", t0, time.monotonic()))
        if call.profiling:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.call.phases.append((self.name, self.t0, t1))
        return False


class Call:
    """One bucket run: ``with tracer.call(device, **args) as call:`` spans
    it (and times it on a CUDA device); its executable opens the children
    with ``call.phase(name)``."""

    def __init__(self, tracer: "CallTracer", n: int, device, args: dict):
        self.tracer, self.n, self.device, self.args = tracer, n, device, args
        self.phases = []                     # (name, t0, t1)
        self.profiling = torch.autograd._profiler_enabled()
        self.annotation = self.timed = None
        self.device_start = False            # the first phase times it
        self.at = None                       # an injected clock's time

    def phase(self, name: str) -> Phase:
        return Phase(self, name)

    def __enter__(self):
        if self.profiling:
            self.annotation = torch.profiler.record_function("call")
            self.annotation.__enter__()
        clock = self.tracer.ob.clock
        if clock is not None:
            self.at = clock.now()
        self.t0 = time.monotonic()
        self.device_start = self.device.type == "cuda"
        return self

    def __exit__(self, *exc):
        self.t1 = time.monotonic()
        if self.timed is not None:
            timer, slot = self.timed
            timer.end(slot, self.n)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.tracer.done.append(self)
        return False


class CallTracer:
    """The call spans of one obs session; ``tracer(ob)`` makes it on the
    session's first traced bucket run."""

    def __init__(self, ob):
        self.ob = ob
        self.count = 0
        self.timers = {}                     # torch.device -> DeviceTimer
        self.done = []          # finished calls whose spans are not recorded

    def call(self, device, **args) -> Call:
        self.count += 1
        return Call(self, self.count, device, args)

    def begin_device(self, device):
        """Begin timing a call on ``device``, anchoring the device on first
        use: ``(timer, slot)``, or None if it goes untimed."""
        timer = self.timers.get(device)
        if timer is None:
            timer = self.timers[device] = DeviceTimer.on(device, self.ob.now)
            self._note_anchor(device, timer)
        slot = timer.begin()
        return None if slot is None else (timer, slot)

    def _note_anchor(self, device, timer) -> None:
        self.ob.trace.instant("anchor", cat="kernel",
                              track=f"device {device}", t=timer.anchor_host,
                              wall_us=round(timer.uncertainty * 1e6, 3))

    def _record(self, call: Call) -> None:
        """The host spans of a finished call."""
        def span(name, a, b, **args):
            if call.at is None:
                self.ob.trace.span(name, cat="compile", track=TRACK, t0=a,
                                   t1=b, call=call.n, **args)
            else:
                self.ob.trace.span(name, cat="compile", track=TRACK,
                                   t0=call.at, t1=call.at, call=call.n,
                                   **args, wall_us=round((b - a) * 1e6, 1))

        span("call", call.t0, call.t1, **call.args)
        for name, a, b in call.phases:
            span(name, a, b, parent="call")

    def flush(self) -> None:
        """Record the host spans of the calls finished since the last
        flush; place every pending device span, waiting for its events,
        which frees the ring; then re-anchor each device and move the
        spans placed since its last anchor by the skew the new one
        shows."""
        done, self.done = self.done, []
        for call in done:
            self._record(call)
        for device, timer in self.timers.items():
            for n, t0, t1 in timer.read():
                timer.placed.append(self.ob.trace.span(
                    "call", cat="kernel", track=f"device {device}", t0=t0,
                    t1=t1, call=n))
            timer.reanchor(*anchor_event(device, self.ob.now))
            self._note_anchor(device, timer)


def tracer(ob) -> CallTracer:
    """The session's ``CallTracer``, made on first use."""
    if ob.call_tracer is None:
        ob.call_tracer = CallTracer(ob)
    return ob.call_tracer
