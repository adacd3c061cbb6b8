"""Multi-device layer (port of ``repro.parallel``): the sharding rules
(``sharding``) and the activation hooks the models call (``sharder``)."""
from repro_torch.parallel.sharder import (  # noqa: F401
    MeshSharder, NOOP, NoopSharder, Sharder)
