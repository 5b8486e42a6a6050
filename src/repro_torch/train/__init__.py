"""Training (counterpart of ``repro.train``): the baseline step and the
overlapped data-parallel step over a certified, rank-reordered all-reduce."""

from .overlap_grads import (  # noqa: F401
    OVERLAP_MODES,
    GradBucket,
    OverlapGradReducer,
    certified_allreduce,
    make_overlap_train_step,
    partition_tree,
    stacked_grads,
)
from .train_step import TrainState, init_state, make_train_step  # noqa: F401
