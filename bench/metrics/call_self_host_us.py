"""Self time in host microseconds of one bucket run, median over the obs
phase's calls: the program's host span ``call`` less its children
``copy_in``, ``replay`` and ``clone`` (``compile/calltrace.py``), so the
Python of dispatch, the counters and the tracing's own device timing."""
from bench import obsphase


def read(rec):
    obs = obsphase.record(rec)
    return obsphase.median(obs["call_self_us"]) if obs else None
