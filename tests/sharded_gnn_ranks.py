"""The rank side of ``tests/test_torch_sharded_gnn.py``: what one process of
a 4-rank gloo group runs on the CPU.

Imports the port only (no JAX): a spawned rank starts from a fresh
interpreter.  The parent writes the JAX package's initial parameters, the
batches and the combine's inputs as numpy to a pickle once the ranks are
starting (``torch_parity.load_payload``).  The ranks split into two 2-rank
groups that run at once, then all four run together:

* ranks 0 and 1, a (2, 1) ``("data", "model")`` mesh under ``GNN_RULES``:
  the four models' loss and gradients; the combine alone; ``Trainer`` for
  3 steps of each model beside the port's one-device ``Trainer``; GIN
  failing at step 2 with a checkpoint every 2, resumed; ``build_step`` of
  every GNN cell, and one of its steps run at the smoke config;
* ranks 2 and 3, a (1, 2) mesh: the losses, gradients, the combine and
  ``build_step``'s specs;
* all four, a (2, 2) mesh: the losses, gradients and the combine.

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
MODELS = ("gin", "pna", "dimenet", "equiformer")
STEPS = 3                   # Trainer steps a model
COMBINES = ("scatter_max", "scatter_min", "scatter_sum", "scatter_mean", "scatter_std",
            "degrees", "segment_softmax")


def np_tree(tree):
    """A port tree (dicts, lists, tensors) as numpy."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return tree.detach().numpy().copy()


def model_case(name):
    """``(module, cfg)`` of a model at its smoke config: GIN and PNA
    classify nodes (8 classes), DimeNet and Equiformer regress graphs."""
    from repro_torch.configs import dimenet, equiformer_v2, gin_tu, pna

    conf = {"gin": gin_tu, "pna": pna, "dimenet": dimenet, "equiformer": equiformer_v2}[name]
    cfg = conf.smoke_config()
    if name == "gin":
        cfg = dataclasses.replace(cfg, task="node", n_classes=8)
    return conf.MODULE, cfg


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


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _grads(mesh, payload):
    """Each model's sharded ``(loss, grads)`` on ``mesh`` and the port's
    one-device values, from JAX's initial parameters."""
    from repro_torch.core.convert import gnn_params_from_reference
    from repro_torch.distributed import GNN_RULES
    from repro_torch.launch import edge_parallel_value_and_grad, train_layout, value_and_grad

    out = {}
    for name in MODELS:
        mod, cfg = model_case(name)
        case = payload["models"][name]
        params = gnn_params_from_reference(case["params"], cfg, device=CPU)
        batch = _tensors(case["batch"])
        layout = train_layout(mod, cfg, mesh, GNN_RULES)
        loss, grads = edge_parallel_value_and_grad(mod, params, batch, cfg, layout)
        one, g1 = value_and_grad(lambda p: mod.loss_fn(p, batch, cfg), params)
        out[name] = {"loss": float(loss), "grads": np_tree(grads), "one_loss": float(one),
                     "one_grads": np_tree(g1), "parts": layout.edge_parallel,
                     "edge_axes": layout.edge_axes}
    return out


def _combine(mesh, payload):
    """Every aggregation primitive over this rank's range of the combine's
    edges, combined, and over all of them in this process: values and the
    gradient of a cotangent; the rank's range of every per-edge result
    (the softmax's value and every gradient)."""
    from repro_torch.distributed import GNN_RULES, edge_slice, logical_to_spec
    from repro_torch.distributed.shardings import axis_rules, spec_axes
    from repro_torch.models.gnn import aggregate as agg

    c = payload["combine"]
    n = int(c["n"])
    with axis_rules(GNN_RULES, mesh):
        axes = spec_axes(logical_to_spec("edges")[0])
    vals, dst = torch.from_numpy(c["vals"]), torch.from_numpy(c["dst"])
    part = edge_slice(mesh, axes, vals.shape[0])
    out = {"lo": part.lo, "hi": part.hi, "parts": part.parts}
    for name in COMBINES:
        if name == "degrees":
            got = agg.degrees(part.take(dst), n, part)
            out[name] = {"value": got.numpy().copy(), "one": agg.degrees(dst, n).numpy()}
            continue
        if name == "segment_softmax":
            x, d, cot = c["scores"], torch.from_numpy(c["sdst"]), c["scot"]
            fn = lambda v, i, p=None: agg.segment_softmax(v, i, n, p)  # noqa: E731
        else:
            x, d, cot = c["vals"], dst, c["cot"]
            fn = lambda v, i, p=None, f=getattr(agg, name): f(v, i, n, part=p)  # noqa: E731
        x = torch.from_numpy(x)
        whole = x.clone().requires_grad_(True)
        want = fn(whole, d)
        (g_one,) = torch.autograd.grad(want, whole, torch.from_numpy(cot))
        mine = part.take(x).clone().requires_grad_(True)
        got = fn(mine, part.take(d), part)
        # a node result is whole on every rank (its cotangent / R, as a step's
        # loss / R); the softmax's is per edge, the rank's own range
        cot = torch.from_numpy(cot)
        cot = part.take(cot) if name == "segment_softmax" else cot / part.parts
        (g,) = torch.autograd.grad(got, mine, cot)
        out[name] = {"value": got.detach().numpy().copy(), "one": want.detach().numpy(),
                     "grad": g.numpy().copy(), "one_grad": g_one.numpy()}
    return out


def _fit(mod, cfg, params, opt, batches, mesh=None, **tc):
    from repro_torch.distributed import GNN_RULES
    from repro_torch.launch import TrainConfig, Trainer

    trainer = Trainer(mod, cfg, train_cfg=TrainConfig(log_every=1, **tc), device=CPU,
                      mesh=mesh, rules=GNN_RULES if mesh is not None else None)
    p, o, hist = trainer.fit(lambda s: batches[s], params=params, opt_state=opt)
    return {"params": np_tree(p), "opt": np_tree(o), "losses": [h["loss"] for h in hist],
            "norms": [h["grad_norm"] for h in hist]}


def _train(mesh, payload):
    """``Trainer`` on ``mesh`` for ``STEPS`` steps of every model, beside the
    one-device ``Trainer`` from the same state and batches."""
    from repro_torch.core.convert import adamw_state_from_reference, gnn_params_from_reference

    out = {}
    for name in MODELS:
        mod, cfg = model_case(name)
        case = payload["models"][name]
        params = gnn_params_from_reference(case["params"], cfg, device=CPU)
        opt = adamw_state_from_reference(case["opt"], params, CPU)
        batches = [_tensors(b) for b in case["batches"]]
        tc = dict(steps=STEPS, warmup=1)
        out[name] = {"sharded": _fit(mod, cfg, params, opt, batches, mesh, **tc),
                     "one_device": _fit(mod, cfg, params, opt, batches, **tc)}
    return out


def _restart(mesh, payload, ckpt):
    """GIN on ``mesh``: a clean run of ``STEPS`` steps with a checkpoint
    every 2, a run failing at step 2, and its resumption."""
    from repro_torch.distributed import GNN_RULES
    from repro_torch.launch import TrainConfig, Trainer

    mod, cfg = model_case("gin")
    batches = [_tensors(b) for b in payload["models"]["gin"]["batches"]]
    tc = dict(steps=STEPS, ckpt_every=2, warmup=1, log_every=1)
    make = lambda s: batches[s]  # noqa: E731
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731

    def trainer(**kw):
        return Trainer(mod, cfg, train_cfg=TrainConfig(**tc, **kw), device=CPU, mesh=mesh,
                       rules=GNN_RULES)

    p_clean, o_clean, h_clean = trainer().fit(make, generator=gen(), ckpt_dir=str(ckpt / "clean"))
    try:
        trainer(fail_at_step=2).fit(make, generator=gen(), ckpt_dir=str(ckpt / "crash"))
        crash = ""
    except RuntimeError as e:
        crash = f"RuntimeError: {e}"
    p, o, h = trainer().fit(make, generator=gen(), ckpt_dir=str(ckpt / "crash"))
    return {"crash": crash, "clean": np_tree({"params": p_clean, "opt": o_clean}),
            "resumed": np_tree({"params": p, "opt": o}),
            "clean_losses": [x["loss"] for x in h_clean], "resumed_losses": [x["loss"] for x in h],
            "resumed_steps": [x["step"] for x in h]}


def _cells(mesh):
    """``build_step``'s ``in_specs`` / ``out_specs`` of every GNN train cell
    on ``mesh``, as tuples."""
    from repro_torch.configs import all_cells
    from repro_torch.launch import build_step

    out = {}
    for key, cell in all_cells().items():
        if cell.family == "gnn":
            _, _, ins, outs = build_step(cell, mesh)
            out[key] = (ins, outs)
    return out


def _cell_step(mesh, payload):
    """gin-tu/molecule's ``build_step`` fn on ``mesh`` with the cell's config
    cut to the smoke config: one step from JAX's state, beside the port's
    one-device ``train_step``."""
    from repro_torch.configs import all_cells
    from repro_torch.core.convert import adamw_state_from_reference, gnn_params_from_reference
    from repro_torch.launch import build_step, train_step

    mod, cfg = model_case("gin")
    cell = dataclasses.replace(all_cells()[("gin-tu", "molecule")], model_cfg=cfg)
    fn = build_step(cell, mesh)[0]
    case = payload["models"]["gin"]
    params = gnn_params_from_reference(case["params"], cfg, device=CPU)
    opt = adamw_state_from_reference(case["opt"], params, CPU)
    batch = _tensors(case["batches"][0])
    p, o, m = fn(params, opt, batch)
    p1, o1, m1 = train_step(mod, params, opt, batch, cfg)
    return {"params": np_tree(p), "loss": float(m["loss"]), "one_params": np_tree(p1),
            "one_loss": float(m1["loss"])}


def _run(rank, payload, out):
    from repro_torch.core import make_process_mesh

    res = {"rank": rank}
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    shape = (2, 1) if rank < 2 else (1, 2)
    mesh = make_process_mesh(shape, ("data", "model"), group=groups[rank // 2], device=CPU)
    res[shape] = {"grads": _grads(mesh, payload), "combine": _combine(mesh, payload)}
    res["cells", shape] = _cells(mesh)
    if rank < 2:
        res["train"] = _train(mesh, payload)
        res["restart"] = _restart(mesh, payload, pathlib.Path(payload["ckpt_dir"]))
        res["cell step"] = _cell_step(mesh, payload)
    dist.barrier()
    square = make_process_mesh((2, 2), ("data", "model"), device=CPU)
    res[(2, 2)] = {"grads": _grads(square, payload), "combine": _combine(square, payload)}
    return res
