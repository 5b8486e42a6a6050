"""Training (counterpart of ``repro.train``): the baseline step and the
overlapped data-parallel step over a certified, rank-reordered all-reduce,
built by hand or from a compiled plan (:func:`reducer_from_plan`), the
tensor-parallel ZeRO-1 step on a ``(data, model)`` mesh
(:mod:`.sharded_step`), and the fault-tolerant :class:`Trainer` that runs
a step with checkpoints, elastic restarts and re-ranking."""

from .overlap_grads import (  # noqa: F401
    OVERLAP_MODES,
    GradBucket,
    TRANSPORTS,
    OverlapGradReducer,
    certified_allreduce,
    certified_allreduce_pair,
    make_overlap_train_step,
    partition_tree,
    reducer_from_plan,
    stacked_grads,
)
from .train_step import TrainState, init_state, make_train_step  # noqa: F401
from .trainer import ClusterView, NodeFailure, Trainer, TrainerConfig  # noqa: F401
