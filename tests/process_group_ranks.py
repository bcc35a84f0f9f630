"""The rank side of ``tests/test_torch_process_group.py``: what one process
of a ``torch.distributed`` group runs on a process mesh.

Imports the port only (no JAX): a spawned rank starts from a fresh
interpreter.  Each rank initialises gloo from a ``file://`` path, builds the
port's graphs from the numpy arrays the test carried over from the JAX
package, runs the algorithms on a process-mesh plan, and saves its results
to ``rank<r>.pt``; an exception is saved as ``rank<r>.err`` and the process
exits non-zero.
"""
import dataclasses
import datetime
import os
import pathlib
import traceback

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 60   # a collective that waits longer fails the rank


def _arrays(obj) -> dict:
    """Every tensor field of a graph or filter as numpy, by name."""
    return {f.name: getattr(obj, f.name).numpy() for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def _np(result) -> list:
    """An algorithm's result (a tensor or a tuple of them) as a list of
    numpy arrays."""
    parts = result if isinstance(result, tuple) else (result,)
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in parts]


def _raises(fn) -> str:
    """The message of the exception ``fn`` raises, or "" when it returns."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _filtered_min_loop(g, plan, words):
    """``tests/test_torch_sharding.py``'s filtered min loop (labels move to
    the least id over the filter's edges, sparse rounds)."""
    from repro_torch.core import round_loop

    x0 = torch.arange(g.n, dtype=torch.int32)
    return round_loop(
        g, (0, x0, torch.ones(g.n, dtype=torch.bool)),
        sweep_inputs=lambda s: (s, s[2], s[1]),
        epilogue=lambda s, out, t: (s[0] + 1, torch.minimum(s[1], out), t & (out < s[1])),
        cond_fn=lambda s: s[0] < 50 and bool(s[2].any()),
        monoid="min", plan=plan, edge_active=words, mode="sparse")


def rank_main(rank, world, init_file, shape, names, reduce_mode, graphs, out_dir, checks):
    """One rank: ``graphs`` maps a name to ``(kind, arrays, meta, filter_bits)``
    (the JAX graph's arrays and its GraphFilter's packed words); ``checks``
    names the error cases this spawn also runs."""
    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        torch.save(_run(rank, shape, names, reduce_mode, graphs, checks), out / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _run(rank, shape, names, reduce_mode, graphs, checks):
    import repro_torch.algorithms as T
    from repro_torch.core import from_reference_arrays, make_mesh, make_plan, make_process_mesh
    from repro_torch.distributed import (
        distributed_frontier_min,
        distributed_pagerank_step,
        distributed_vertex_reduce,
        prepare_sharded,
    )

    cpu = torch.device("cpu")
    mesh = make_process_mesh(shape, names, device=cpu)
    res = {"coords": mesh.coords, "graphs": {}}
    for name, (kind, arrays, meta, bits) in graphs.items():
        g = from_reference_arrays(kind, arrays, meta, "cpu")
        seq = make_plan(g, mesh=mesh, reduce_mode=reduce_mode, tuning=None)
        gs = seq.prepare(g)
        words = torch.from_numpy(bits)
        one = {"shard_index": gs.shard_index, "num_shards": gs.num_shards,
               "local_shards": len(gs.shards), "shard": _arrays(gs.shards[0]),
               "describe": seq.describe()}
        for pipelined in (False, True):
            plan = dataclasses.replace(seq, pipeline_rounds=pipelined)
            r = {
                "bfs": _np(T.bfs(gs, 3, plan=plan)),
                "wbfs": _np(T.wbfs(gs, 3, plan=plan)),
                "wbfs_batched": _np(T.wbfs_batched(gs, [0, 5, 9], plan=plan)),
                "pagerank": _np(T.pagerank(gs, max_iters=12, plan=plan)[0]),
                "kcore": _np(T.kcore(gs, plan=plan)),
            }
            state = _filtered_min_loop(gs, plan, words)
            r["filtered_min"] = [np.asarray(state[0]), state[1].numpy()]
            one["pipelined" if pipelined else "sequential"] = r
        _, sea = seq.prepare(g, edge_active=words)
        one["active_rows"] = (sea.shard_index, tuple(sea.words.shape))
        res["graphs"][name] = one
    if "distributed" in checks:
        kind, arrays, meta, _ = graphs["rmat csr"]
        g = from_reference_arrays(kind, arrays, meta, "cpu")
        x, xi, fr, inv = (torch.from_numpy(a) for a in checks["distributed"])
        gs = prepare_sharded(mesh, g)
        res["distributed"] = {
            "reduce": distributed_vertex_reduce(mesh, n=g.n, mode=reduce_mode)(gs, x).numpy(),
            "pagerank": distributed_pagerank_step(mesh, n=g.n, mode=reduce_mode)(
                gs, x, inv).numpy(),
            "bf16": distributed_vertex_reduce(mesh, n=g.n, state_dtype=torch.bfloat16)(
                gs, x).numpy(),
            "min": distributed_frontier_min(mesh, n=g.n)(gs, xi, fr).numpy(),
        }
    if "errors" in checks:
        kind, arrays, meta, _ = graphs["rmat csr"]
        g = from_reference_arrays(kind, arrays, meta, "cpu")
        plan = make_plan(g, mesh=mesh, tuning=None)
        k = plan.num_shards
        other = make_plan(g, mesh=make_mesh((k + 1,), ("data",), devices=[cpu] * (k + 1)),
                          tuning=None).prepare(g)
        in_process = make_plan(g, mesh=make_mesh((k,), ("data",), devices=[cpu] * k),
                               tuning=None).prepare(g)
        res["errors"] = {
            "world size": _raises(lambda: make_process_mesh((k + 1,), ("data",), device=cpu)),
            "other shard count": _raises(lambda: plan.prepare(other)),
            "in-process graph": _raises(lambda: plan.prepare(in_process)),
            "duplicate device": _nccl_on_one_device(shape, names, cpu),
        }
    return res


def _nccl_on_one_device(shape, names, device) -> str:
    """``make_process_mesh`` under a group that reports NCCL, every rank on
    the same device: the store check must refuse it before any collective.
    (gloo carries the group here; only the backend's name is NCCL's.)"""
    import repro_torch.core.mesh as mesh_mod

    real = dist.get_backend
    dist.get_backend = lambda group=None: "nccl"
    try:
        return _raises(lambda: mesh_mod.make_process_mesh(shape, names, device=device))
    finally:
        dist.get_backend = real
