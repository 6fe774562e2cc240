"""Host microseconds of one ``CompiledModel.__call__`` (copy in, graph
replay, clone: the enqueue, not the work), median over the window's calls,
by the host clock around each call."""
import statistics


def read(rec):
    spans = rec["window"]["enqueue_s"]
    return statistics.median(spans) * 1e6 if spans else None
