"""Host microseconds of ``graph.replay()``, median over the obs phase's
calls: the program's host span ``replay`` (``cudaGraphLaunch`` and the
Python around it)."""
from bench import obsphase


def read(rec):
    obs = obsphase.record(rec)
    return obsphase.median(obs["replay_us"]) if obs else None
