"""Coordinator: cluster control plane (port of dingo_tpu/coordinator).

Mirrors reference src/coordinator/ — CoordinatorControl (region CRUD, store
registry, jobs), TsoControl (timestamp oracle), KvControl (etcd-like KV +
lease + watch), AutoIncrementControl, balance schedulers, the capacity
plane, MetaControl and the raft-replicated coordinator. In process only:
the coordinator's gRPC services are not ported yet.
"""

from dingo_tpu_torch.coordinator.control import CoordinatorControl  # noqa: F401
from dingo_tpu_torch.coordinator.tso import TsoControl  # noqa: F401
from dingo_tpu_torch.coordinator.kv_control import KvControl  # noqa: F401
from dingo_tpu_torch.coordinator.auto_increment import AutoIncrementControl  # noqa: F401
