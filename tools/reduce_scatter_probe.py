#!/usr/bin/env python3
"""gloo's reduce-scatter against an all-reduce and a slice, for the LM's
FSDP gradients, on one NVIDIA card.

    python3 tools/reduce_scatter_probe.py

Two gloo ranks on the one card, as ``chip_smoke.py``'s phase 20 runs them:
a (2, 1) ``("data", "model")`` mesh under ``LM_RULES``, qwen2-1.5B cut to
2 layers, bf16, a global batch of 4 x 1,024 tokens (phase 20(d)).  Each
rank times, each side synchronised:

* every float32 gradient shape that the step sums over ``data`` (the tied
  embedding, a layer's leaves), summed into the rank's half by one
  reduce-scatter (``reduce_scatter``) and by one all-reduce of the whole
  gradient and the rank's slice (``all_reduce``), alternating, the median
  of ``REPS`` calls after a warm one;
* the training step with ``distributed.fsdp``'s gradient sums as the port
  makes them, and with ``reduce_scatter_blocks`` replaced by the
  all-reduce and slice, in the order port, all-reduce, all-reduce, port:
  the median of the steps after the first of each run, and the ms a step
  its gradient sums take.

The all-reduce variant is a measurement alone; the port never calls it.
Prints the card's name and power limit first and one JSON object last.
Needs a CUDA device; builds no kernel.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
WORK = ROOT / "build" / "reduce_scatter_probe"
LAYERS, BATCH, SEQ, STEPS = 2, 4, 1024, 3
REPS = 5            # timed calls of each collective, after a warm one
LIMIT_S = 600       # the ranks' limit: a rank still running is killed
SEED = 20


def all_reduce_narrow(t, spec, mesh, axes, *, keep=()):
    """What ``shardings.reduce_scatter_blocks`` computes, by an all-reduce
    of the whole ``t`` over each of ``axes`` and the rank's slice."""
    from repro_torch.distributed.shardings import spec_axes

    for d in reversed(range(len(spec))):
        for a in spec_axes(spec[d]):
            k = mesh.axis_size(a)
            if k == 1 or (a not in axes and a not in keep):
                continue
            if a not in keep:
                t = t.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(t, group=mesh.axis_groups[a])
            idx = mesh.coords[mesh.axis_names.index(a)]
            t = t.narrow(d, idx * (t.shape[d] // k), t.shape[d] // k)
    return t


def _collectives(mesh, cfg, dev) -> list:
    """Each float32 gradient shape summed over ``data`` on the mesh:
    ``(name, bytes, reduce-scatter ms, all-reduce and slice ms)``."""
    from repro_torch.core.mesh import collective

    grp = mesh.axis_groups["data"]
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.d_head
    shapes = {"embed": (cfg.vocab, d), "wq": (d, d), "wk": (d, kv), "w_gate": (d, f),
              "w_down": (f, d), "norm": (d,)}
    out = []
    for name, shape in shapes.items():
        g = torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(SEED))
        part = g.new_empty((shape[0] // 2,) + shape[1:])
        times = {"rs": [], "ar": []}
        for _ in range(REPS + 1):
            for kind in times:
                torch.cuda.synchronize()
                t = time.perf_counter()
                if kind == "rs":
                    collective("reduce_scatter")(part, g, group=grp)
                else:
                    whole = g.clone()
                    dist.all_reduce(whole, group=grp)
                    part.copy_(whole[:shape[0] // 2])
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t) * 1e3)
        out.append((name, g.nbytes, statistics.median(times["rs"][1:]),
                    statistics.median(times["ar"][1:])))
        del g, part
    return out


def _rank(rank: int, world: int) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.core import make_process_mesh
    from repro_torch.data.tokens import make_lm_batch_fn
    from repro_torch.distributed import LM_RULES, fsdp
    from repro_torch.launch import TrainConfig, Trainer
    from repro_torch.models import transformer_lm as lm

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{WORK / 'init'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = make_process_mesh((2, 1), ("data", "model"), device=dev)
    cfg = dataclasses.replace(get_arch("qwen2-1.5b").cells()["train_4k"].model_cfg,
                              n_layers=LAYERS)
    res = {"rank": rank, "collectives": _collectives(mesh, cfg, dev), "steps": []}
    real = fsdp.reduce_scatter_blocks
    for route in ("port", "all_reduce", "all_reduce", "port"):
        fn = real if route == "port" else all_reduce_narrow
        spent = []

        def timed(*a, _fn=fn, _spent=spent, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            _spent.append(time.perf_counter() - t)
            return out

        fsdp.reduce_scatter_blocks = timed
        marks = []

        def make(step, _base=make_lm_batch_fn(cfg.vocab, BATCH, SEQ, device=dev)):
            marks.append(len(spent))
            return _base(step)

        tr = Trainer(lm, cfg, train_cfg=TrainConfig(steps=STEPS, warmup=1, log_every=1),
                     mesh=mesh, rules=LM_RULES)
        _, _, hist = tr.fit(make, generator=torch.Generator(dev).manual_seed(SEED))
        cuts = marks + [len(spent)]
        sums = [sum(spent[cuts[i]:cuts[i + 1]]) * 1e3 for i in range(len(marks))]
        res["steps"].append({"route": route,
                             "ms": statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3,
                             "sum_ms": statistics.median(sums[1:]),
                             "losses": [h["loss"] for h in hist],
                             "norms": [h["grad_norm"] for h in hist]})
        del tr
        torch.cuda.empty_cache()
    fsdp.reduce_scatter_blocks = real
    dist.destroy_process_group()
    return res


def rank_main(rank: int, world: int) -> None:
    try:
        (WORK / f"rank{rank}.json").write_text(json.dumps(_rank(rank, world)))
    except BaseException:
        (WORK / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def main() -> int:
    import multiprocessing

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 2)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + LIMIT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = sorted(WORK.glob("rank*.err"))
    if errs or any(p.exitcode for p in procs):
        print(errs[0].read_text() if errs else "a rank failed", file=sys.stderr)
        return 1
    ranks = [json.loads((WORK / f"rank{r}.json").read_text()) for r in range(2)]
    for res in ranks:
        for name, nbytes, rs, ar in res["collectives"]:
            print(f"rank {res['rank']}: {name} {nbytes} B float32 over 2 ranks: reduce-scatter "
                  f"{rs:.3f} ms, all-reduce and slice {ar:.3f} ms")
        for s in res["steps"]:
            print(f"rank {res['rank']}: step with route {s['route']}: {s['ms']:.3f} ms, its "
                  f"gradient sums {s['sum_ms']:.3f} ms; losses {s['losses']}, norms {s['norms']}")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"card": smi, "ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
