"""step_mfu_pct: the model flops of the window's rounds (as ``mfu_pct``
counts them, ``arith.round_flops``) over the device time of the window
(the union of its operations' intervals in the trace) times the H100's
float32 peak outside the tensor cores: the whole round's share of the
peak while the device works, the bound under ``device_ms_per_round``."""
from hflbench import arith


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.driver.window_flops() / (
        run.trace["busy_s"] * arith.PEAK_F32_FLOPS)
