"""Coprocessor (port of dingo_tpu/coprocessor): the scalar filter only."""

from dingo_tpu_torch.coprocessor.scalar_filter import (  # noqa: F401
    CmpOp,
    ScalarPredicate,
    ScalarFilter,
)
