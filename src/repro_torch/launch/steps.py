"""The step bodies of SASRec's serving cells, as the JAX package's
``launch/steps.py`` builds them, without its mesh and shardings:

  sasrec_serve_step      — full-catalog scores, then the top ``TOP_K`` (100)
  sasrec_retrieval_step  — the scores of an explicit candidate list

``assert_topk_agrees`` holds one route's top-k to another's.
"""
from __future__ import annotations

import torch

from ..models import sasrec

TOP_K = 100  # the serve cells emit the top 100 items


def sasrec_serve_step(params: dict, batch: dict, cfg: sasrec.SASRecConfig) -> dict:
    """``{"values": (B, 100) float32, "indices": (B, 100) int32}``: the 100
    best items of the full catalog per user, best first (``lax.top_k``)."""
    scores = sasrec.serve_scores(params, batch, cfg)
    values, indices = torch.topk(scores, TOP_K, dim=-1, largest=True, sorted=True)
    return {"values": values, "indices": indices.to(torch.int32)}


def sasrec_retrieval_step(params: dict, batch: dict, cfg: sasrec.SASRecConfig) -> torch.Tensor:
    """(B, NC) scores of ``batch["candidates"]`` for ``batch["seq"]``."""
    return sasrec.retrieval_scores(params, batch, cfg)


def assert_topk_agrees(got: dict, want: dict, ref_scores: torch.Tensor, tol: float,
                       what: str = "top-k") -> int:
    """Holds ``got`` (a serve step's output) to ``want`` (another route's,
    on the same device): the values within ``tol``; the indices equal,
    except at a near-tie, where ``ref_scores`` (the other route's full
    scores) put ``got``'s pick within ``2 tol`` of ``want``'s value at that
    rank; no item twice in a row.  Raises AssertionError, else returns the
    count of near-tie swaps."""
    torch.testing.assert_close(got["values"], want["values"], rtol=tol, atol=tol, msg=what)
    gi = got["indices"].long()
    differ = gi != want["indices"].long()
    picked = ref_scores.gather(1, gi)
    if not bool(((picked - want["values"]).abs()[differ] <= 2 * tol).all()):
        raise AssertionError(f"{what}: an index differs away from a near-tie at "
                             f"{differ.nonzero().tolist()}")
    if any(len(set(row)) != len(row) for row in gi.tolist()):
        raise AssertionError(f"{what}: an item appears twice in a row")
    return int(differ.sum())
