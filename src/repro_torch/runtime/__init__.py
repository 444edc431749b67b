"""Straggler models: who fails to report by the aggregation deadline
(``make_straggler_model`` resolves the names)."""

from .straggler import (  # noqa: F401
    AdversarialStragglers,
    BimodalStragglers,
    ClusteredStragglers,
    CorrelatedStragglers,
    DeadlineStragglers,
    FixedFractionStragglers,
    IIDStragglers,
    NoStragglers,
    StragglerModel,
    make_straggler_model,
)
