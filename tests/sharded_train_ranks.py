"""The rank side of ``tests/test_torch_sharded_train.py``: what one process
of a 4-rank gloo group runs on the CPU.

Imports the port only (no JAX): a spawned rank starts from a fresh
interpreter.  The parent writes the JAX package's initial parameters and
batches as numpy to a pickle once the ranks are starting
(``torch_parity.load_payload``); the ranks split into two 2-rank groups that run at once:

* ranks 0 and 1, a (1, 2) ``("data", "model")`` mesh: SASRec's smoke config
  under ``RECSYS_RULES`` (item rows over ``model``), 3 steps, beside the
  port's one-device ``Trainer`` on the same state and batches; the tiny LM
  under ``LM_RULES`` (its 101 vocabulary rows do not split in two); a GNN
  train cell (its step built, edges split over both ranks), and serving
  cells, through ``build_step``;
* ranks 2 and 3, a (2, 1) mesh: the tiny LM and SASRec, 2 steps at each
  accumulation, batches whose ranks hold different counts of unmasked
  positions; SASRec failing at step 3 with a checkpoint every 2, resumed,
  beside the clean run.

Before and after those, all four: ``compressed_psum`` over a ``("pod",)``
mesh of 4, and ``elastic_restore`` of the (2, 1) checkpoint onto (1, 2)
(ranks 0 and 1) and onto each rank alone (a (1, 1) mesh).  Results go to
``rank<r>.pt`` as numpy; an exception to ``rank<r>.err`` and exit code 1.
"""
import datetime
import os
import pathlib
import traceback

import torch
import torch.distributed as dist

from torch_parity import load_payload

COLLECTIVE_TIMEOUT_S = 60   # a collective that waits longer fails the rank
CPU = torch.device("cpu")


def np_tree(tree):
    """A port tree (dicts, lists, tensors) as numpy; bfloat16 as float32."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return tree.detach().float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()


def _raises(fn, kinds) -> str:
    """The message of the exception of ``kinds`` that ``fn`` raises, or ""."""
    try:
        fn()
    except kinds as e:
        return f"{type(e).__name__}: {e}"
    return ""


def rank_main(rank, world, init_file, payload_file, out_dir):
    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        torch.save(_run(rank, load_payload(payload_file), out), out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _models(payload):
    """``{name: (module, cfg, params, opt, rules)}``: the port's state from
    the JAX package's numpy trees."""
    from repro_torch.configs import sasrec as sasrec_config
    from repro_torch.core.convert import (
        adamw_state_from_reference,
        lm_params_from_reference,
        sasrec_params_from_reference,
    )
    from repro_torch.distributed import LM_RULES, RECSYS_RULES
    from repro_torch.models import sasrec
    from repro_torch.models import transformer_lm as lm

    out = {}
    cfg = sasrec_config.smoke_config()
    p = sasrec_params_from_reference(payload["sasrec"]["params"], cfg, CPU)
    out["sasrec"] = (sasrec, cfg, p, adamw_state_from_reference(payload["sasrec"]["opt"], p,
                                                                CPU), RECSYS_RULES)
    cfg = lm.LMConfig(**payload["lm"]["cfg"])
    p = lm_params_from_reference(payload["lm"]["params"], cfg, CPU)
    out["lm"] = (lm, cfg, p, adamw_state_from_reference(payload["lm"]["opt"], p, CPU), LM_RULES)
    return out


def _batches(arrays):
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in arrays]
    return lambda step: batches[step]


def _fit(model, cfg, params, opt, batches, mesh=None, rules=None, **tc):
    from repro_torch.launch import TrainConfig, Trainer

    trainer = Trainer(model, cfg, train_cfg=TrainConfig(log_every=1, **tc), device=CPU,
                      mesh=mesh, rules=rules)
    p, o, hist = trainer.fit(_batches(batches), params=params, opt_state=opt)
    return {"params": np_tree(p), "opt": np_tree(o),
            "losses": [h["loss"] for h in hist], "norms": [h["grad_norm"] for h in hist]}


def _run(rank, payload, out):
    from repro_torch.configs import all_cells
    from repro_torch.core import make_process_mesh
    from repro_torch.launch import TrainConfig, Trainer, build_step
    from repro_torch.models.gnn import gin
    from repro_torch.optim import compressed_psum

    res = {"rank": rank}
    # compressed_psum over a ("pod",) mesh of all four ranks
    pod = make_process_mesh((4,), ("pod",), device=CPU)
    x = torch.from_numpy(payload["psum_x"][rank])
    res["psum"] = compressed_psum(x, "pod", pod).numpy()
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    models = _models(payload)
    steps = payload["steps"]
    if rank < 2:
        mesh = make_process_mesh((1, 2), ("data", "model"), group=groups[0], device=CPU)
        model, cfg, params, opt, rules = models["sasrec"]
        batches = payload["sasrec"]["batches"]
        tr = Trainer(model, cfg, device=CPU, mesh=mesh, rules=rules)
        blocks, _ = tr.init_state(torch.Generator().manual_seed(7))
        whole = model.init(cfg, generator=torch.Generator().manual_seed(7), device=CPU)
        res["init"] = {"blocks": np_tree(blocks), "whole": np_tree(whole)}
        tc = dict(steps=steps["one_two"], warmup=1)
        res["one_two"] = {
            "sharded": _fit(model, cfg, params, opt, batches, mesh, rules, **tc),
            "one_device": _fit(model, cfg, params, opt, batches, **tc),
        }
        lm_model, lm_cfg, _, _, lm_rules = models["lm"]
        cells = all_cells()
        res["errors"] = {
            "lm uneven": _raises(lambda: Trainer(lm_model, lm_cfg, device=CPU, mesh=mesh,
                                                 rules=lm_rules).init_state(
                torch.Generator().manual_seed(0)), ValueError),
            "gnn train": _raises(lambda: build_step(cells[("gin-tu", "molecule")], mesh),
                                 (NotImplementedError, TypeError, ValueError)),
        }
        gin_cell = cells[("gin-tu", "molecule")]
        res["gnn specs"] = build_step(gin_cell, mesh)[2:]
        res["gnn edge axes"] = Trainer(gin, gin_cell.model_cfg, device=CPU, mesh=mesh,
                                       rules=gin_cell.rules).layout.edge_axes
        res["serving specs"] = {cell: build_step(cells[cell], mesh)[2:]
                                for cell in payload["serving_cells"]}
    else:
        mesh = make_process_mesh((2, 1), ("data", "model"), group=groups[1], device=CPU)
        runs = {}
        for name, accum, key in payload["two_one"]:
            model, cfg, params, opt, rules = models[name]
            batches = payload[name][key]
            tc = dict(steps=steps["two_one"], warmup=1, accum=accum)
            runs[(name, accum)] = {
                "sharded": _fit(model, cfg, params, opt, batches, mesh, rules, **tc),
                "one_device": _fit(model, cfg, params, opt, batches, **tc),
            }
        res["two_one"] = runs
        model, cfg, params, opt, rules = models["sasrec"]
        make = _batches(payload["sasrec"]["batches"])
        ckpt = pathlib.Path(payload["ckpt_dir"])
        tc = dict(steps=steps["restart"], ckpt_every=2, warmup=1, log_every=1)
        clean = Trainer(model, cfg, train_cfg=TrainConfig(**tc), device=CPU, mesh=mesh,
                        rules=rules)
        p_clean, o_clean, h_clean = clean.fit(make, generator=torch.Generator().manual_seed(3),
                                              ckpt_dir=str(ckpt / "clean"))
        failing = Trainer(model, cfg, train_cfg=TrainConfig(**tc, fail_at_step=3), device=CPU,
                          mesh=mesh, rules=rules)
        crash = _raises(lambda: failing.fit(make, generator=torch.Generator().manual_seed(3),
                                            ckpt_dir=str(ckpt / "crash")), RuntimeError)
        p, o, h = Trainer(model, cfg, train_cfg=TrainConfig(**tc), device=CPU, mesh=mesh,
                          rules=rules).fit(make, generator=torch.Generator().manual_seed(3),
                                           ckpt_dir=str(ckpt / "crash"))
        res["restart"] = {"crash": crash, "clean": np_tree({"params": p_clean, "opt": o_clean}),
                          "resumed": np_tree({"params": p, "opt": o}),
                          "clean_losses": [x["loss"] for x in h_clean],
                          "resumed_losses": [x["loss"] for x in h],
                          "resumed_steps": [x["step"] for x in h]}
    dist.barrier()
    res["elastic"] = _elastic(rank, models["sasrec"], pathlib.Path(payload["ckpt_dir"]) / "clean",
                              groups[0])
    return res


def _elastic(rank, model_case, ckpt, pair):
    """The (2, 1) run's newest checkpoint (step 4) restored as blocks on a
    (1, 2) mesh (ranks 0 and 1) and on a (1, 1) mesh of this rank alone."""
    from repro_torch.core import make_process_mesh
    from repro_torch.distributed import carve_mesh, elastic_restore
    from repro_torch.launch import train_layout
    from repro_torch.optim import state_logical_specs

    model, cfg, _, _, rules = model_case
    alone = carve_mesh(group=dist.new_group([rank], use_local_synchronization=True),
                       device=CPU)
    out = {"alone_shape": alone.shape}
    meshes = {"alone": alone}
    if rank < 2:
        meshes["one_two"] = make_process_mesh((1, 2), ("data", "model"), group=pair, device=CPU)
    logical = {"params": model.param_specs(cfg),
               "opt": state_logical_specs(model.param_specs(cfg))}
    for name, mesh in meshes.items():
        example = train_layout(model, cfg, mesh, rules).meta_state()
        tree, step = elastic_restore(str(ckpt), example, logical, rules, mesh)
        out[name] = {"step": step, "tree": np_tree(tree), "coords": mesh.coords}
    return out
