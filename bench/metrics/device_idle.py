"""Share of the traced window in which the device ran nothing: one minus
the union of its kernel and copy intervals over the window.  The profiler
slows the host's launches, so in a cell the host paces this reads above
the idle share of an untraced window."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
