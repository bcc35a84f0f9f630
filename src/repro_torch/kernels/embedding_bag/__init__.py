from .embedding_bag import (
    embedding_bag_backward,
    embedding_bag_plan,
    embedding_bag_sums,
)
from .ops import embedding_bag, take_rows
from .ref import (
    BACKWARD_CHUNK,
    backward_plan,
    backward_sums_ref,
    bag_case,
    bag_grad_case,
    bag_of_one_case,
    bf16_ulps,
    embedding_bag_backward_ref,
    embedding_bag_ref,
    same_bits,
)
