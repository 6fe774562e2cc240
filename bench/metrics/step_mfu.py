"""The whole forward's share of the card's int8 peak while the device
works: two operations per conv multiply-add (``work.conv_macs_per_image``)
of every image of the traced calls, over the device's busy seconds in the
traced window (the union of its kernels and copies), against the peak.
The device-time rate of the cell, in images a busy second, is this share
times the peak over the operations an image."""
from bench import work


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peak")
    if not tr or peak is None or tr["busy_s"] <= 0:
        return None
    ops = 2 * work.conv_macs_per_image(rec["cfg"]) * tr["images"]
    return 100.0 * ops / tr["busy_s"] / peak["int8_ops_per_s"]
