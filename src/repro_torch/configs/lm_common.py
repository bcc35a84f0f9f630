"""Shared LM cell factory: every LM arch × the 4 assigned LM shapes (the
JAX package's ``configs/lm_common.py`` on the port's ``Cell``)."""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..distributed.shardings import (
    LM_DECODE_LONG_RULES,
    LM_DECODE_RULES,
    LM_PREFILL_RULES,
    LM_RULES,
)
from ..models import transformer_lm as lm
from .common import LM_SHAPES, Cell, i32, lm_model_flops


def lm_cells(cfg: lm.LMConfig) -> dict[str, Cell]:
    cells = {}
    for shape, info in LM_SHAPES.items():
        seq, gb, kind = info["seq_len"], info["global_batch"], info["kind"]
        notes = ""
        if kind == "train":
            ccfg = cfg
            batch_specs = {"tokens": i32(gb, seq), "targets": i32(gb, seq)}
            batch_logical = {
                "tokens": ("batch", "seq"),
                "targets": ("batch", "seq"),
            }
            rules = LM_RULES
        elif kind == "prefill":
            ccfg = cfg
            batch_specs = {"tokens": i32(gb, seq)}
            batch_logical = {"tokens": ("batch", "seq")}
            rules = LM_PREFILL_RULES
        else:  # decode
            # single-block attention for one-token queries (no kv scan)
            ccfg = dataclasses.replace(cfg, kv_block=seq)
            batch_specs = {"tokens": i32(gb, 1), "pos": i32()}
            batch_logical = {"tokens": ("batch", None), "pos": ()}
            rules = LM_DECODE_LONG_RULES if shape == "long_500k" else LM_DECODE_RULES
            if shape == "long_500k":
                notes = (
                    "decode-mode attention is linear in cache length (one query "
                    "token), i.e. sub-quadratic; lowered for all LM archs per "
                    "DESIGN.md §Arch-applicability"
                )
        cells[shape] = Cell(
            arch=cfg.name,
            shape=shape,
            kind=kind,
            family="lm",
            model_cfg=ccfg,
            batch_specs=batch_specs,
            batch_logical=batch_logical,
            rules=rules,
            notes=notes,
            model_flops=lm_model_flops(
                cfg, seq, gb, train=(kind == "train"), decode=(kind == "decode")
            ),
        )
    return cells


def lm_smoke_batch(cfg: lm.LMConfig, generator: torch.Generator, batch=2, seq=16,
                   device=None) -> dict:
    """Random int32 tokens in [0, vocab) from ``generator`` and the targets
    (the tokens rolled by -1), on ``device`` (default ``cuda``).  A torch
    generator does not give a JAX key's numbers."""
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                         device=generator.device, dtype=torch.int32).to(resolve_device(device))
    return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
