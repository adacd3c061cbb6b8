from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, sgd, adam, adafactor, clip_by_global_norm)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine  # noqa: F401
