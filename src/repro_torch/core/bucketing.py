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

    def update(self, ids_mask: torch.Tensor, new_buckets: torch.Tensor) -> "Buckets":
        """updateBuckets: vertices in ``ids_mask`` move to ``new_buckets[v]``."""
        nb = torch.where(ids_mask, new_buckets.to(torch.int32), self.bucket_of)
        return Buckets(bucket_of=nb, n=self.n)

    def retire(self, ids_mask: torch.Tensor) -> "Buckets":
        """Vertices in ``ids_mask`` leave every bucket (NULL_BUCKET)."""
        return self.update(ids_mask, torch.full_like(self.bucket_of, NULL_BUCKET))


def make_buckets(initial: torch.Tensor) -> Buckets:
    """initial: int32[n] bucket ids (NULL_BUCKET to start retired)."""
    return Buckets(bucket_of=initial.to(torch.int32), n=initial.shape[0])
