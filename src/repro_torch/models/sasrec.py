"""SASRec — Self-Attentive Sequential Recommendation [arXiv:1808.09781]:
its serving and training paths.

Config: embed_dim=50, 2 blocks, 1 head, seq_len=50.  The item-embedding
table is the large memory of serving: scored, never written; per-request
state is O(seq·d).  Parameters are a dict of tensors with the JAX
package's tree leaf by leaf (``blocks`` a list of dicts).

  init(cfg, generator=, device=)        → params
  params_to(params, device)             → the same tree on ``device``
  encode(params, seq, cfg)              → user states (B, L, d)
  param_shapes(cfg) / param_specs(cfg)  → each leaf's (shape, init) / logical axes
  loss_fn(params, batch, cfg)           → the paper's BCE over sampled negatives
  loss_terms(params, batch, cfg)        → its (masked sum, count)
  loss_mask(batch)                      → the positions that count
  serve_scores(params, batch, cfg)      → full-catalog scores (B, vocab)
  retrieval_scores(params, batch, cfg)  → candidate scores (B, NC)

Every item lookup (the history in ``encode``, the positives and negatives
in ``loss_fn``, the candidates in ``retrieval_scores``) is
``jnp.take(mode="fill")`` in the JAX package and ``kernels.take_rows``
here: bags of one of the EmbeddingBag kernel, whose backward kernel carries
the gradient to ``item_emb``.  The catalog product and the candidate dot
are plain products.  No remat, as in the JAX package.

The serving functions take their lookups as arguments (``ids → rows``), so
that a ``ProcessMesh`` serving step can hold ``item_emb`` as the rank's
block of rows: ``encode``'s history through ``lookup``
(``distributed.serving.sharded_rows`` there), ``retrieval_scores``'
candidates through ``candidate_rows`` (``local_rows``: the rank's own rows,
zero elsewhere), and ``serve_scores`` scores whatever rows
``params["item_emb"]`` holds.  The defaults are ``take_rows`` on the whole
table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.embedding_bag import take_rows
from ..nn.attention import gqa_attention
from ..nn.mlp import draw_normal
from ..nn.norms import layer_norm

ITEM_STD = 0.02  # std of the item and position embeddings at init


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    """The JAX package's ``SASRecConfig``, field for field."""

    name: str = "sasrec"
    vocab: int = 500_000          # item catalog
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0          # inference-style determinism
    kv_block: int = 64


def param_shapes(cfg: SASRecConfig) -> dict:
    """The parameter tree of ``init`` as ``{leaf: (shape, init)}``, where
    ``init`` is a normal draw's scale, ``"zeros"`` or ``"ones"``; every leaf
    is float32.  The JAX package's shapes and scales, leaf by leaf."""
    d = cfg.embed_dim
    w = ((d, d), 1.0 / math.sqrt(d))
    block = {
        "ln1_s": ((d,), "ones"), "ln1_b": ((d,), "zeros"),
        "wq": w, "wk": w, "wv": w, "wo": w,
        "ln2_s": ((d,), "ones"), "ln2_b": ((d,), "zeros"),
        "w1": w, "b1": ((d,), "zeros"),
        "w2": w, "b2": ((d,), "zeros"),
    }
    return {
        "item_emb": ((cfg.vocab, d), ITEM_STD),  # row 0 is the padding item
        "pos_emb": ((cfg.seq_len, d), ITEM_STD),
        "final_ln_s": ((d,), "ones"), "final_ln_b": ((d,), "zeros"),
        "blocks": [dict(block) for _ in range(cfg.n_blocks)],
    }


def param_specs(cfg: SASRecConfig) -> dict:
    """The logical axes of every parameter (the JAX package's
    ``param_specs``): the item table's rows over ``vocab_rows``."""
    def block_spec():
        return {
            "ln1_s": (None,), "ln1_b": (None,),
            "wq": (None, None), "wk": (None, None), "wv": (None, None), "wo": (None, None),
            "ln2_s": (None,), "ln2_b": (None,),
            "w1": (None, None), "b1": (None,),
            "w2": (None, None), "b2": (None,),
        }

    return {
        "item_emb": ("vocab_rows", "embed"),
        "pos_emb": (None, None),
        "final_ln_s": (None,), "final_ln_b": (None,),
        "blocks": [block_spec() for _ in range(cfg.n_blocks)],
    }


def init(cfg: SASRecConfig, *, generator: torch.Generator, device=None) -> dict:
    """Random float32 parameters drawn from ``generator`` (which must live
    on ``device``, default ``cuda``).  A torch generator does not give a JAX
    key's numbers: the parity tests carry the JAX package's weights over
    with ``core.convert.sasrec_params_from_reference``."""
    dev = resolve_device(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [make(v) for v in spec]
        shape, how = spec
        if how == "zeros":
            return torch.zeros(shape, device=dev)
        if how == "ones":
            return torch.ones(shape, device=dev)
        return draw_normal(shape, how, generator=generator, dtype=torch.float32, device=dev)

    return make(param_shapes(cfg))


def params_to(params, device):
    """A copy of the parameter tree (dicts, ``blocks`` a list) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def _table_rows(params: dict):
    return lambda ids: take_rows(params["item_emb"], ids)


def encode(params: dict, seq: torch.Tensor, cfg: SASRecConfig, *,
           lookup: Callable | None = None) -> torch.Tensor:
    """seq: (B, L) item ids (0 = padding) → user states (B, L, d).  The
    history's rows come from ``lookup(ids)`` (default ``take_rows`` on
    ``item_emb``)."""
    B, L = seq.shape
    d = cfg.embed_dim
    H = cfg.n_heads
    keep = (seq > 0)[..., None]
    x = (lookup or _table_rows(params))(seq)
    x = x * math.sqrt(d) + params["pos_emb"][None, :L]
    x = x * keep
    for bp in params["blocks"]:
        h = layer_norm(x, bp["ln1_s"], bp["ln1_b"])
        q = (h @ bp["wq"]).reshape(B, L, H, d // H)
        k = (h @ bp["wk"]).reshape(B, L, H, d // H)
        v = (h @ bp["wv"]).reshape(B, L, H, d // H)
        a = gqa_attention(q, k, v, causal=True, kv_block=cfg.kv_block)
        x = x + a.reshape(B, L, d) @ bp["wo"]
        h = layer_norm(x, bp["ln2_s"], bp["ln2_b"])
        ff = torch.relu(h @ bp["w1"] + bp["b1"]) @ bp["w2"] + bp["b2"]
        x = (x + ff) * keep
    return layer_norm(x, params["final_ln_s"], params["final_ln_b"])


def loss_terms(params: dict, batch: dict, cfg: SASRecConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum, count)`` of the paper's binary cross-entropy over the
    positions with a positive.  batch: ``seq`` (B, L), ``pos`` (B, L)
    next-item targets, ``neg`` (B, L) sampled negatives; 0 = padding.  A
    sharded step adds both terms over the ranks before it divides."""
    h = encode(params, batch["seq"], cfg)  # (B, L, d)
    pe = take_rows(params["item_emb"], batch["pos"])
    ne = take_rows(params["item_emb"], batch["neg"])
    ps = torch.sum(h * pe, dim=-1).float()
    ns = torch.sum(h * ne, dim=-1).float()
    mask = loss_mask(batch)
    loss = -(F.logsigmoid(ps) + F.logsigmoid(-ns)) * mask
    return torch.sum(loss), torch.sum(mask)


def loss_mask(batch: dict) -> torch.Tensor:
    """(B, L) float32: 1 at the positions with a positive (``pos > 0``).
    It reads the batch alone, so a sharded step counts before the forward."""
    return (batch["pos"] > 0).float()


def loss_fn(params: dict, batch: dict, cfg: SASRecConfig) -> torch.Tensor:
    """The paper's binary cross-entropy, averaged over the positions with a
    positive (at least 1): ``loss_terms``' sum over its count."""
    total, count = loss_terms(params, batch, cfg)
    return total / torch.clamp(count, min=1.0)


def serve_scores(params: dict, batch: dict, cfg: SASRecConfig, *,
                 lookup: Callable | None = None) -> torch.Tensor:
    """Full-catalog scoring: seq (B, L) → scores (B, rows), one column a row
    of ``params["item_emb"]``: the whole catalog, or a rank's block [lo,
    hi) of it (then ``lookup`` reads the history from every rank's block)."""
    h = encode(params, batch["seq"], cfg, lookup=lookup)[:, -1]  # (B, d)
    return h @ params["item_emb"].T


def retrieval_scores(params: dict, batch: dict, cfg: SASRecConfig, *,
                     lookup: Callable | None = None,
                     candidate_rows: Callable | None = None) -> torch.Tensor:
    """One (or few) queries × explicit candidate list: seq (B, L),
    candidates (B, NC) → (B, NC).  A batched dot, never a loop.  The
    candidates' rows come from ``candidate_rows(ids)`` (default
    ``take_rows``): a rank's own rows, zero elsewhere, score only the
    candidates it owns (0 for the rest)."""
    h = encode(params, batch["seq"], cfg, lookup=lookup)[:, -1]  # (B, d)
    ce = (candidate_rows or _table_rows(params))(batch["candidates"])  # (B, NC, d)
    return torch.einsum("bd,bcd->bc", h, ce)
