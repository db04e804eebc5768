"""Raft consensus layer (port of dingo_tpu/raft): leader election, log
replication, commit and snapshot install over a pluggable transport. The
in-process LocalTransport is ported; the gRPC transport is not."""

from dingo_tpu_torch.raft.core import RaftNode, NotLeader  # noqa: F401
from dingo_tpu_torch.raft.log import RaftLog  # noqa: F401
from dingo_tpu_torch.raft.transport import LocalTransport  # noqa: F401
