"""Coprocessor (port of dingo_tpu/coprocessor): pushdown scalar filtering
and aggregation."""

from dingo_tpu_torch.coprocessor.scalar_filter import (  # noqa: F401
    CmpOp,
    ScalarPredicate,
    ScalarFilter,
)
from dingo_tpu_torch.coprocessor.aggregation import Aggregator  # noqa: F401
