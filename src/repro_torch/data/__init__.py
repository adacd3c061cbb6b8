from repro_torch.data.synthetic import SyntheticSpec, make_dataset, DATASETS  # noqa: F401
from repro_torch.data.partition import FederatedData, partition_noniid  # noqa: F401
