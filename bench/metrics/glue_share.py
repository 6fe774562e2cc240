"""Share of the traced window's busy device time spent outside the port's
kernels and the benchmark's own copy of the logits to the host: the
PyTorch operations around the kernels (quantizing the images onto their
grid, the float pool and classifier head) and the CUDA graph's copies."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * tr["device_s"]["glue"] / tr["busy_s"]
