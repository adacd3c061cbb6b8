"""mfu_pct: the model flops of the window's rounds (forward and backward
of the CNN over every scheduled device's real samples, L·Q steps a round,
and the test set's forward; ``arith.round_flops``) over the window's
length times the H100's float32 peak outside the tensor cores (the
configuration runs float32 with TF32 off)."""
from hflbench import arith


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.driver.window_flops() / (
        run.window_s * arith.PEAK_F32_FLOPS)
