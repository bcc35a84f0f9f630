"""The rank side of ``tests/test_torch_sharded_serve.py``: what one process
of a 4-rank gloo group runs on the CPU.

Imports the port only (no JAX): a spawned rank starts from a fresh
interpreter.  The parent writes the JAX package's parameters and the
inputs as numpy to a pickle once the ranks are starting
(``torch_parity.load_payload``).  All four ranks make a (2, 2) and a (4, 1) ``("data",
"model")`` mesh; ranks 0-1 and 2-3 each make a (1, 2) mesh of their pair.

* the attention merge: ``decode_attention_ref(return_lse=True)`` on each
  rank's row range of one cache (4 ranges over (4, 1)'s ``data``, 2 over
  (2, 2)'s ``model``), merged by ``merge_attention``;
* the tiny LM on (2, 2): ``build_step``'s prefill (``LM_PREFILL_RULES``,
  a cache of the prompt's length) and decode (``LM_DECODE_RULES``) steps,
  from blocks, the decode over the caches of a ``sharded_prefill_step``
  into 16 positions; on (4, 1) under ``LM_DECODE_LONG_RULES`` the
  lower-level steps on parameters gathered once;
* deepseek's MLA smoke config on each (1, 2) pair, the lower-level steps;
* SASRec on (2, 2): ``build_step``'s serve (``RECSYS_RULES``) and
  retrieval (``RECSYS_RETRIEVAL_RULES``) steps, and ``sharded_rows``.

Results go to ``rank<r>.pt`` as numpy; an exception to ``rank<r>.err`` and
exit code 1.
"""
import dataclasses
import datetime
import os
import pathlib
import traceback

import torch
import torch.distributed as dist

from torch_parity import load_payload

COLLECTIVE_TIMEOUT_S = 60   # a collective that waits longer fails the rank
CPU = torch.device("cpu")


def rank_main(rank, world, init_file, payload_file, out_dir):
    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        torch.save(_run(rank, load_payload(payload_file)), out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()  # a snapshot: decode writes the caches in place


def _t(a):
    return torch.from_numpy(a)


def _merges(payload, meshes):
    """Each mesh's merged attention over its ranges of the cache."""
    from repro_torch.distributed import merge_attention, seq_block
    from repro_torch.kernels import decode_attention_ref

    q, k, v, pos = (_t(payload["attn"][n]) for n in ("q", "k", "v", "pos"))
    out = {}
    for name, (mesh, axes) in meshes.items():
        lo, hi = seq_block(mesh, axes, k.shape[1])
        lengths = (pos - lo).clamp(0, hi - lo).to(torch.int32)
        part, lse = decode_attention_ref(q, k[:, lo:hi], v[:, lo:hi], lengths, return_lse=True)
        out[name] = {"merged": merge_attention(part, lse, mesh, axes).numpy(),
                     "lse": lse.numpy(), "range": (lo, hi)}
    return out


def _lm_build_step(payload, mesh):
    """The tiny LM through ``build_step``'s prefill and decode fns on (2, 2)."""
    from repro_torch.configs import all_cells
    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.distributed import shard_tree
    from repro_torch.launch import build_step, serve_layout, sharded_prefill_step
    from repro_torch.models import transformer_lm as lm

    case = payload["lm"]
    cfg = lm.LMConfig(**case["cfg"])
    params = lm_params_from_reference(case["params"], cfg, CPU)
    cells = all_cells()
    prefill_cell = dataclasses.replace(cells[("qwen2-1.5b", "prefill_32k")], model_cfg=cfg)
    decode_cell = dataclasses.replace(cells[("qwen2-1.5b", "decode_32k")], model_cfg=cfg)
    fn, _, (p_spec, _), _ = build_step(prefill_cell, mesh)
    blocks = shard_tree(params, p_spec, mesh)
    prompts = _t(case["prompts"])
    logits, caches = fn(blocks, {"tokens": prompts})
    res = {"prefill": {"logits": logits.numpy(), "caches": _np(caches)}}
    # the decode's caches: a prefill into max_seq positions
    layout = serve_layout(lm, cfg, mesh, prefill_cell.rules)
    lo, hi = layout.rows(prompts.shape[0])
    _, caches = sharded_prefill_step(layout.load(blocks), prompts[lo:hi], cfg, layout,
                                     case["max_seq"])
    res["prefill16"] = _np(caches)
    fn, _, _, _ = build_step(decode_cell, mesh)
    steps = []
    for i, tok in enumerate(case["steps"]):
        pos = prompts.shape[1] + i
        logits, caches = fn(blocks, caches, {"tokens": _t(tok), "pos": torch.tensor(pos)})
        steps.append(logits.numpy())
    res["decode"] = {"logits": steps, "caches": _np(caches)}
    return res


def _lm_steps(case, cfg, mesh, rules):
    """Prefill into ``max_seq`` positions, then the decode steps, through the
    lower-level steps on parameters gathered once."""
    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.distributed import shard_tree
    from repro_torch.launch import serve_layout, sharded_decode_step, sharded_prefill_step
    from repro_torch.models import transformer_lm as lm

    params = lm_params_from_reference(case["params"], cfg, CPU)
    layout = serve_layout(lm, cfg, mesh, rules)
    served = layout.load(shard_tree(params, layout.params, mesh))
    prompts = _t(case["prompts"])
    lo, hi = layout.rows(prompts.shape[0])
    logits, caches = sharded_prefill_step(served, prompts[lo:hi], cfg, layout, case["max_seq"])
    res = {"prefill": {"logits": logits.numpy(), "caches": _np(caches)}, "logits": []}
    for i, tok in enumerate(case["steps"]):
        logits, caches = sharded_decode_step(served, caches, _t(tok)[lo:hi],
                                             prompts.shape[1] + i, cfg, layout)
        res["logits"].append(logits.numpy())
    res["caches"] = _np(caches)
    res["rows"] = (lo, hi)
    res["seq"] = layout.block(layout.seq_axes, case["max_seq"])
    res["vocab"] = layout.block(layout.vocab_axes, cfg.vocab)
    return res


def _sasrec(payload, mesh):
    """SASRec's serve and retrieval through ``build_step`` on (2, 2), and
    ``sharded_rows`` over its ``model`` axis."""
    from repro_torch.configs import all_cells
    from repro_torch.configs import sasrec as sasrec_config
    from repro_torch.core.convert import sasrec_params_from_reference
    from repro_torch.distributed import seq_block, shard_tree, sharded_rows
    from repro_torch.launch import build_step

    case = payload["sasrec"]
    cfg = sasrec_config.smoke_config()
    params = sasrec_params_from_reference(case["params"], cfg, CPU)
    cells = all_cells()
    res = {}
    for kind, shape, batch in (("serve", "serve_p99", {"seq": case["serve_seq"]}),
                               ("retrieval", "retrieval_cand",
                                {"seq": case["ret_seq"], "candidates": case["candidates"]})):
        cell = dataclasses.replace(cells[("sasrec", shape)], model_cfg=cfg)
        fn, _, (p_spec, _), _ = build_step(cell, mesh)
        blocks = shard_tree(params, p_spec, mesh)
        out = fn(blocks, {k: _t(v) for k, v in batch.items()})
        res[kind] = _np(out) if isinstance(out, dict) else out.numpy()
        if kind == "serve":
            res["block_rows"] = tuple(blocks["item_emb"].shape)
    lo, hi = seq_block(mesh, ("model",), cfg.vocab)
    block = params["item_emb"][lo:hi]
    ids = _t(case["ids"])
    res["rows"] = sharded_rows(block, ids, lo, mesh, ("model",)).numpy()
    return res


def _run(rank, payload):
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.core import make_process_mesh
    from repro_torch.distributed import LM_DECODE_LONG_RULES, LM_DECODE_RULES
    from repro_torch.models import transformer_lm as lm

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    m22 = make_process_mesh((2, 2), ("data", "model"), device=CPU)
    m41 = make_process_mesh((4, 1), ("data", "model"), device=CPU)
    m12 = make_process_mesh((1, 2), ("data", "model"), group=pairs[rank // 2], device=CPU)
    res = {"rank": rank, "coords": {"(2, 2)": m22.coords, "(4, 1)": m41.coords}}
    res["merge"] = _merges(payload, {"(4, 1)": (m41, ("data",)), "(2, 2)": (m22, ("model",))})
    res["lm (2, 2)"] = _lm_build_step(payload, m22)
    res["lm (4, 1)"] = _lm_steps(payload["lm"], lm.LMConfig(**payload["lm"]["cfg"]), m41,
                                 LM_DECODE_LONG_RULES)
    res["mla (1, 2)"] = _lm_steps(payload["mla"], deepseek_v2_lite_16b.smoke_config(), m12,
                                  LM_DECODE_RULES)
    res["sasrec (2, 2)"] = _sasrec(payload, m22)
    return res
