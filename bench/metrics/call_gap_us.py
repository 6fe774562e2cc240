"""Device microseconds from one call's device span's end to the next
call's start, median over the obs phase's calls: the caller's copy of the
logits to the host, and any idle while the host is late."""
from bench import obsphase


def read(rec):
    obs = obsphase.record(rec)
    return obsphase.median(obs["gap_us"]) if obs else None
