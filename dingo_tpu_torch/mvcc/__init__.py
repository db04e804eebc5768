"""MVCC layer (port of dingo_tpu/mvcc): memcomparable key codec,
versioned reads, TSO timestamps."""

from dingo_tpu_torch.mvcc.codec import Codec, ValueFlag  # noqa: F401
from dingo_tpu_torch.mvcc.ts_provider import TsProvider  # noqa: F401
