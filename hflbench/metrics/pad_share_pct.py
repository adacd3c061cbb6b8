"""pad_share_pct: the share of Algorithm 1's sample-steps spent on
padding: every device's data is padded to the largest D_n, and the
vmapped local training computes every padded row. 100 x (1 - real /
all), from the program's counters in ``cohort_local_sgd`` over the
window: ``train.sample_steps`` (rows x D_max x L, from the shapes) and
``train.real_sample_steps`` (the mask's sum x L, on the device)."""
from hflbench import spans


def read(run):
    traces = spans.window_traces(run)
    if traces is None:
        return None
    every = spans.counter(traces, "train.sample_steps")
    real = spans.counter(traces, "train.real_sample_steps")
    if not every or real is None:
        return None
    return 100.0 * (1.0 - real / every)
