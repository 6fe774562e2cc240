"""The conv kernels' share of their roofline: the least time one forward's
convolutions could take on the card (``work.bound_s``, from the
configuration's widths: int8 operations against the int8 peak, the image,
weights and last map against HBM bandwidth) times the traced calls, over
the device time of the port's conv kernels in the traced window."""
from bench import work


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peak")
    if not tr or peak is None or tr["device_s"]["conv"] <= 0:
        return None
    bound = work.bound_s(rec["cfg"], rec["mix"]["batch"], peak)
    return 100.0 * bound * tr["calls"] / tr["device_s"]["conv"]
