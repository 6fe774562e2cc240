"""The whole forward's share of the card's int8 peak while the device
works: two operations per multiply-add of the projections and the conv
(``lm_work``) for every token of the traced calls, over the device's busy
seconds in the traced window, against the peak."""
from bench import lm_work


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peak")
    if not tr or peak is None or tr["busy_s"] <= 0:
        return None
    cfg = rec["cfg"]
    macs = lm_work.matmul_macs_per_token(cfg) + \
        lm_work.conv_macs_per_token(cfg)
    tokens = tr["images"] * rec["mix"]["seq_len"]
    return 100.0 * 2 * macs * tokens / tr["busy_s"] / peak["int8_ops_per_s"]
