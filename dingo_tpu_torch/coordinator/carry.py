"""Carry coordinator state across from the JAX package.

The coordinator's controls keep their whole state in the meta column
family (CoordinatorControl's stores, regions, id counters and command
queues; the TSO watermark; KvControl's revisions, version log and
leases; the auto-increment counters; MetaControl's schemas and tables),
as typed persist blobs whose bytes are the same in both packages. So a
``MemEngine.snapshot_state()`` of the JAX package's coordinator engine is
the interchange format: ``controls_from_reference`` loads its meta pairs
into a port MemEngine and recovers every control from it, and the port's
own ``snapshot_state()`` goes the other way.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from dingo_tpu_torch.coordinator.auto_increment import AutoIncrementControl
from dingo_tpu_torch.coordinator.control import CoordinatorControl
from dingo_tpu_torch.coordinator.kv_control import KvControl
from dingo_tpu_torch.coordinator.meta import MetaControl
from dingo_tpu_torch.coordinator.tso import TsoControl
from dingo_tpu_torch.engine.raw_engine import CF_META, MemEngine


@dataclasses.dataclass
class Controls:
    """One coordinator's controls over one engine (MetaStateMachine's
    attributes, without the raft group)."""

    engine: MemEngine
    control: CoordinatorControl
    tso: TsoControl
    kv: KvControl
    auto_incr: AutoIncrementControl
    meta: MetaControl


def controls_from_reference(engine_state: Mapping, replication: int = 3,
                            engine: Optional[MemEngine] = None) -> Controls:
    """Recover the port's coordinator controls from a JAX package
    coordinator's ``MemEngine.snapshot_state()`` dict (column family ->
    list of (key, value) bytes). Only the meta column family is read; the
    pairs go into `engine` (a fresh MemEngine by default)."""
    engine = engine if engine is not None else MemEngine()
    engine.load_state({CF_META: [(bytes(k), bytes(v)) for k, v in
                                 engine_state.get(CF_META, [])]})
    control = CoordinatorControl(engine, replication)
    return Controls(engine=engine, control=control, tso=TsoControl(engine),
                    kv=KvControl(engine),
                    auto_incr=AutoIncrementControl(engine),
                    meta=MetaControl(engine, control))
