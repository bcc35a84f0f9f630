"""Step bodies of the port's cells, ``build_step`` with its placements,
the sharded train step (rows or, for a GNN, edge lists split over the
ranks; the LM computing on its blocks) and the sharded serving steps on a
process mesh (``TrainLayout``, ``ServeLayout``), and the fault-tolerant
trainer."""
from .steps import (
    TOP_K,
    ServeLayout,
    TrainLayout,
    assert_topk_agrees,
    build_step,
    edge_parallel_value_and_grad,
    sasrec_retrieval_step,
    sasrec_serve_step,
    serve_layout,
    sharded_decode_step,
    sharded_lm_value_and_grad,
    sharded_prefill_step,
    sharded_retrieval_step,
    sharded_serve_step,
    sharded_train_step,
    train_layout,
    train_step,
    value_and_grad,
)
from .train import TrainConfig, Trainer
