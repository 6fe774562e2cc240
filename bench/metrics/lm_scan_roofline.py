"""``selective_scan``'s share of its roofline: a forward's least scan bytes
(``lm_work.scan_bytes``: the float32 operands read once, y and the last
state written once) over HBM bandwidth, times the traced calls, over the
device time of ``selective_scan`` in the traced window."""
from bench import lm_work


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peak")
    t = (tr or {}).get("kernel_s", {}).get("selective_scan", 0.0)
    if not tr or peak is None or t <= 0:
        return None
    mix = rec["mix"]
    nbytes = lm_work.scan_bytes(rec["cfg"], mix["batch"], mix["seq_len"])
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] * tr["calls"] / t
