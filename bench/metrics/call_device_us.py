"""Device microseconds of one bucket run, median over the obs phase's
calls: the program's device span ``call``, from a CUDA event before its
copy-in to one after its clone, with no profiler running.  Less the
call's busy time, it is the idle inside a call."""
from bench import obsphase


def read(rec):
    obs = obsphase.record(rec)
    return obsphase.median(obs["device_us"]) if obs else None
