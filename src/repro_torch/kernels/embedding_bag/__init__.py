from .embedding_bag import embedding_bag_sums
from .ops import embedding_bag, take_rows
from .ref import bag_case, bag_of_one_case, bf16_ulps, embedding_bag_ref, same_bits
