"""Semi-eager bucketing (Appendix B) — Julienne's bucket structure in O(n).

Each vertex sits in at most one bucket; ``bucket_of[v]`` is its current
bucket id (NULL_BUCKET when retired).  ``next_bucket`` extracts the minimum
non-empty bucket with one O(n) min-reduce.
"""
from __future__ import annotations

import dataclasses

import torch

NULL_BUCKET = 2**30


@dataclasses.dataclass(frozen=True)
class Buckets:
    bucket_of: torch.Tensor  # int32[n]
    n: int

    def next_bucket(self):
        """Returns (bucket_id, member_mask, any_left) as tensors."""
        bid = self.bucket_of.min()
        return bid, self.bucket_of == bid, bid < NULL_BUCKET


def make_buckets(initial: torch.Tensor) -> Buckets:
    """initial: int32[n] bucket ids (NULL_BUCKET to start retired)."""
    return Buckets(bucket_of=initial.to(torch.int32), n=initial.shape[0])
