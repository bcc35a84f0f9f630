"""The rank side of ``tests/test_torch_sharded_compute.py``: what one process
of a 4-rank gloo group runs on the CPU.

Imports the port only (no JAX): a spawned rank starts from a fresh
interpreter.  The parent writes the JAX package's initial parameters, AdamW
states and batches as numpy to a pickle once the ranks are starting
(``torch_parity.load_payload``).  First ranks 0 and 1 train on a (1, 2)
``("data", "model")`` mesh while ranks 2 and 3 train on (2, 1); then all
four train on (2, 2), and on the ``("pod", "data", "model")`` meshes of
the payload's three-axis cases (``pod`` a batch axis that splits no
leaf).  Every run is the LM under ``LM_RULES`` through
``Trainer(mesh=, rules=)``, beside the port's one-device ``Trainer`` on the
same state and batches, with spies counting the collectives of the sharded
run by kind and every call of ``launch.steps.gather_tree``, and recording
the rows of each piece the rank ran.  Results go to ``rank<r>.pt`` as
numpy; an exception to ``rank<r>.err`` and exit code 1.
"""
import datetime
import os
import pathlib
import traceback

import torch
import torch.distributed as dist

from sharded_train_ranks import np_tree
from torch_parity import load_payload

COLLECTIVE_TIMEOUT_S = 60   # a collective that waits longer fails the rank
CPU = torch.device("cpu")
# (module, name) of each spied function: every call issues collectives
SPIED = {
    "gathers": ("repro_torch.distributed.fsdp", "gather_over"),
    "reduce_scatters": ("repro_torch.distributed.fsdp", "reduce_scatter_blocks"),
    "tp_all_reduces": ("repro_torch.distributed.tensor_parallel", "all_reduce"),
    "row_gathers": ("repro_torch.distributed.fsdp", "gather_parts"),
    "fsdp_all_reduces": ("repro_torch.distributed.fsdp", "all_reduce"),
    "norm_all_reduces": ("repro_torch.optim.clipping", "_sum_over"),
    "replicated_all_reduces": ("repro_torch.launch.steps", "reduce_gradients"),
    "gather_tree": ("repro_torch.launch.steps", "gather_tree"),
}


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


def _spy(counts: dict):
    """Wrap every ``SPIED`` function so that its calls count into
    ``counts``."""
    import importlib

    for kind, (mod_name, name) in SPIED.items():
        mod = importlib.import_module(mod_name)
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _kind=kind, **kw):
            counts[_kind] = counts.get(_kind, 0) + 1
            return _real(*a, **kw)

        setattr(mod, name, wrapped)
    from repro_torch.models import transformer_lm as lm

    real_terms = lm.loss_terms

    def terms(params, batch, cfg, shard=None):
        if shard is not None:
            counts.setdefault("pieces", []).append(int(batch["tokens"].shape[0]))
        return real_terms(params, batch, cfg, shard=shard)

    lm.loss_terms = terms


def _state(payload, name):
    from repro_torch.core.convert import adamw_state_from_reference, lm_params_from_reference
    from repro_torch.models import transformer_lm as lm

    m = payload["models"][name]
    cfg = lm.LMConfig(**m["cfg"])
    params = lm_params_from_reference(m["params"], cfg, CPU)
    return cfg, params, adamw_state_from_reference(m["opt"], params, CPU)


def _fit(cfg, params, opt, batches, accum, steps, mesh=None):
    from repro_torch.distributed import LM_RULES
    from repro_torch.launch import TrainConfig, Trainer
    from repro_torch.models import transformer_lm as lm

    tensors = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    trainer = Trainer(lm, cfg, train_cfg=TrainConfig(steps=steps, warmup=1, log_every=1,
                                                     accum=accum),
                      device=CPU, mesh=mesh, rules=LM_RULES if mesh is not None else None)
    p, o, hist = trainer.fit(lambda s: tensors[s], params=params, opt_state=opt)
    return {"params": np_tree(p), "opt": np_tree(o), "losses": [h["loss"] for h in hist],
            "norms": [h["grad_norm"] for h in hist]}


def _runs(payload, cases, mesh, counts):
    out = {}
    for name, accum, key in cases:
        cfg, params, opt = _state(payload, name)
        batches = payload["models"][name][key]
        counts.clear()
        sharded = _fit(cfg, params, opt, batches, accum, payload["steps"], mesh)
        sharded["counts"] = dict(counts)
        out[(name, accum)] = {"sharded": sharded,
                              "one_device": _fit(cfg, params, opt, batches, accum,
                                                 payload["steps"])}
    return out


def _run(rank, payload):
    from repro_torch.core import make_process_mesh

    counts = {}
    _spy(counts)
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    shape = (1, 2) if rank < 2 else (2, 1)
    mesh = make_process_mesh(shape, ("data", "model"), group=groups[rank // 2], device=CPU)
    res = {"rank": rank, shape: _runs(payload, payload["cases"][shape], mesh, counts)}
    dist.barrier()
    for shape, cases in payload["cases"].items():
        if len(shape) == 2 and shape != (2, 2):
            continue
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        res[shape] = _runs(payload, cases, make_process_mesh(shape, names, device=CPU), counts)
    return res
