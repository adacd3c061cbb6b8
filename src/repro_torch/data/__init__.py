from repro_torch.data.synthetic import (  # noqa: F401
    DATASETS, SEQ_DATASETS, SeqSpec, SyntheticSpec, class_token_dists,
    make_dataset, make_seq_dataset)
from repro_torch.data.partition import FederatedData, partition_noniid  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    batch_iterator, sample_batch, token_batch_iterator)
