"""mfu: the model's FLOPs in the window (`roofline.model_flops`: every
product forward and backward over the batch's real rows) over the window's
wall time, as a share of the card's dense bf16 peak (989 TFLOP/s), %."""

from benchmark.roofline import PEAK_BF16


def read(rec):
    if rec["window_s"] <= 0 or rec["flops"] <= 0:
        return None
    return rec["flops"] / rec["window_s"] / PEAK_BF16 * 100.0
