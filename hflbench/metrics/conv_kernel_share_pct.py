"""conv_kernel_share_pct: the share of the CNN's conv -> ReLU -> max-pool
blocks that ran on the fused kernel K6, 100 x kernel / (kernel + plain),
from the program's counters ``conv.kernel_blocks`` and
``conv.plain_blocks`` (one a block call of ``models.cnn.cnn_apply``, in
training and evaluation) over the window. None where neither counter was
recorded (a program without K6)."""
from hflbench import spans


def read(run):
    traces = spans.window_traces(run)
    if traces is None:
        return None
    counts = [sum(t["counters"].get(f"conv.{kind}_blocks", 0)
                  for t in traces) for kind in ("kernel", "plain")]
    if not sum(counts):
        return None
    return 100.0 * counts[0] / sum(counts)
