"""``matmul_int8``'s share of its roofline: the least time a forward's four
projections could take on the card (``lm_work.matmul_bound_s``, from the
configuration's widths: each projection's int8 operations against the
int8 peak or its least bytes against HBM bandwidth, whichever is longer)
times the traced calls, over the device time of ``matmul_int8`` in the
traced window."""
from bench import lm_work


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peak")
    t = (tr or {}).get("kernel_s", {}).get("matmul_int8", 0.0)
    if not tr or peak is None or t <= 0:
        return None
    tokens = rec["mix"]["batch"] * rec["mix"]["seq_len"]
    return 100.0 * lm_work.matmul_bound_s(rec["cfg"], tokens, peak) \
        * tr["calls"] / t
