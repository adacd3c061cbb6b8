from repro_torch.core.scheduling.schedulers import (  # noqa: F401
    FedAvgScheduler, VKCScheduler, IKCScheduler, Scheduler, TracedFedAvg,
    SerialFedAvgScheduler, SerialVKCScheduler, SerialIKCScheduler)
from repro_torch.core.scheduling.device_clustering import (  # noqa: F401
    run_device_clustering, auxiliary_weight_vectors, clustering_cost)
