"""The paper's own HFL task model (Section VI): 2-conv CNN.

Port of ``repro.configs.hfl_cnn``. Not a transformer: the HFL framework
trains it (``get_hfl_spec("hfl-cnn")``); the registry lists it so that
``get_config("hfl-cnn")`` resolves as it does in the reference.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class HFLCNNConfig:
    name: str = "hfl-cnn"
    family: str = "cnn"
    conv_channels: tuple = (15, 28)
    kernel: int = 5
    datasets: tuple = ("fmnist_syn", "cifar_syn")
    citation: str = "paper §VI (two 5x5 convs + two linear layers)"


CONFIG = HFLCNNConfig()


def smoke_config():
    return CONFIG
