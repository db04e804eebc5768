"""Store-metrics plane (port of dingo_tpu/metrics): per-region snapshots
collected on the store (collector.py) and shipped to the coordinator in
every heartbeat (snapshot.py). The device-allocator module and the HTTP
exposition are not ported yet."""

from dingo_tpu_torch.metrics.snapshot import (  # noqa: F401
    RegionMetricsSnapshot,
    StoreMetricsSnapshot,
)
