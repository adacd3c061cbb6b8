from repro_torch.drl.d3qn import d3qn_init, q_values_all_t  # noqa: F401
from repro_torch.drl.replay import EpisodeReplay  # noqa: F401
from repro_torch.drl.train import D3QNTrainer, make_training_population  # noqa: F401
