"""Step bodies of the port's cells (no mesh, no sharding) and the
fault-tolerant trainer."""
from .steps import (
    TOP_K,
    assert_topk_agrees,
    sasrec_retrieval_step,
    sasrec_serve_step,
    train_step,
    value_and_grad,
)
from .train import TrainConfig, Trainer
