"""The diskann role's core (port of dingo_tpu/diskann): the disk-resident
index and its item manager. The role's gRPC service comes with the gRPC
front end."""

from dingo_tpu_torch.diskann.core import CoreState, DiskAnnCore
from dingo_tpu_torch.diskann.item import DiskAnnItemManager

__all__ = ["CoreState", "DiskAnnCore", "DiskAnnItemManager"]
