"""95th percentile over the window's calls of the milliseconds from a
call's issue to its logits on the host (its event seen complete), by the
host clock.  In a closed loop it is about the depth times a call's
service time."""
import statistics


def read(rec):
    lat = rec["window"]["latency_s"]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18] * 1e3
