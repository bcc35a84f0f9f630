"""Step bodies of the port's cells, ``build_step`` with its placements,
the sharded train step on a process mesh, and the fault-tolerant trainer."""
from .steps import (
    TOP_K,
    TrainLayout,
    assert_topk_agrees,
    build_step,
    sasrec_retrieval_step,
    sasrec_serve_step,
    sharded_train_step,
    train_layout,
    train_step,
    value_and_grad,
)
from .train import TrainConfig, Trainer
