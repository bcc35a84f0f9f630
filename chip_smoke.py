#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from this checkout, holds it against its
plain PyTorch version on the card, and drives the port's main path once:
R-MAT -> compressed CSR -> edgeMap -> BFS / wBFS / PageRank -> QueryEngine.

1. Device: the card (``nvidia-smi``), the torch and CUDA versions, and the
   kernel's build time.
2. Kernel against its plain version on the card, on graph B and on a small
   graph with a few exceptions: both emits, one query and B=8, weighted and
   unweighted, with and without masks, and chunks padded with ids >= NB.
   Decode must match exactly, sums within rtol 1e-5 (the kernel adds a
   block's slots in a warp-tree order).  Then the device time of the kernel,
   of its plain version and of a one-call yardstick at the main-path shape.
3. Graph A, the full ``sage-graph`` configuration (n=2^20, m=2^24, weighted,
   F_B=128, seed 0): dense PageRank and direction-optimised BFS, checked on
   the card.  The graph is exception-dense, so ``sparse_streamed`` runs the
   plain ``sparse`` path and launches no kernel, as the JAX package does.
4. Graph B (n=2^16, m=2^23, weighted, F_B=128, seed 0), which has no
   exceptions: BFS and wBFS on a ``sparse_streamed`` plan launch the kernel
   and equal the CPU route exactly; PageRank with ``eps=0`` and a fixed
   iteration count agrees with the CPU route within atol 1e-6.
5. Serving: a ``QueryEngine`` on graph B answers 12 BFS and 4 wBFS queries,
   each equal to its single-query run.
6. The graph tensors of A and B are unchanged (SHA-256 before and after).

Phases 4 and 5 are the main path: the launch count is set to 0 before
them and read after them.  Any failed check raises and the run exits
non-zero.  Without a CUDA device, or outside a checkout of the repository,
the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
BLOCK = 128
GRAPH_A = (1 << 20, 1 << 24)   # the JAX package's configs/sage_graph.py full_config
GRAPH_B = (1 << 16, 1 << 23)   # gaps between sorted targets fit 16 bits: no exceptions
GRAPH_E = (1 << 17, 1 << 18)   # a few thousand exceptions, under the 4,096 limit
CHUNK = 256                    # DEFAULT_CHUNK_BLOCKS: ids per launch on the main path
BATCH = 8
SUM_RTOL = 1e-5    # float sums: warp-tree order against a sequential sum
SUM_ATOL = 1e-6    # the same, for blocks whose sum is near 0
PR_SUM_TOL = 1e-4  # PageRank mass, float32 over 2^20 scores
PR_ATOL = 1e-6     # PageRank on B against the CPU route: scores ~1.5e-5, other sum order
PR_ITERS = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
KERNEL_SOURCE = "src/repro_torch/kernels/compressed_spmv/csrc/compressed_chunked_spmv.cu"
KERNEL_REPLACES = "src/repro/kernels/compressed_spmv/compressed_spmv.py:290"


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def device_ms(fn, *, runs=15, per_run=25):
    """Median device time of one ``fn()`` in ms.  Each run queues ``per_run``
    calls behind a sleeping kernel, so that the host's launch cost stays
    hidden, and times them with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def graph_digest(g) -> dict:
    """SHA-256 of every tensor field of a graph, read back to the host."""
    import torch

    out = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
    return out


def build_graph(n, m, device):
    """(host copy, device copy, seconds) of the weighted R-MAT graph, built
    and compressed on the host, then moved to the card."""
    from repro_torch.core import compress, from_reference_arrays, to_reference_arrays
    from repro_torch.data import rmat_graph

    t0 = time.perf_counter()
    host = compress(rmat_graph(n, m, weighted=True, seed=SEED, block_size=BLOCK,
                               device="cpu"))
    dev = from_reference_arrays(*to_reference_arrays(host), device)
    return host, dev, time.perf_counter() - t0


def sources(g, k, seed):
    """``k`` distinct vertices of positive degree, drawn from ``seed``."""
    import numpy as np

    deg = g.degrees.cpu().numpy()
    return [int(v) for v in np.random.default_rng(seed).choice(np.flatnonzero(deg), k,
                                                               replace=False)]


# ----------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ----------------------------------------------------------------------
def chunk_ids(g, rng, live, pad):
    """A sorted chunk of ``live`` distinct block ids, then ``pad`` ids >= NB."""
    import numpy as np
    import torch

    NB = g.num_blocks
    ids = np.sort(rng.choice(NB, live, replace=False))
    ids = np.concatenate([ids, NB + np.arange(pad)]).astype(np.int32)
    return torch.from_numpy(ids).to(g.device)


def compare_kernel(g, rng, stats):
    """Every case of ``compressed_chunked_spmv`` against the plain version on
    the same device tensors.  Returns the largest absolute difference."""
    import torch

    from repro_torch.core import make_filter
    from repro_torch.kernels import compressed_chunked_spmv, compressed_chunked_spmv_ref

    n, NB, FB = g.n, g.num_blocks, g.block_size
    dev = g.device
    ids = chunk_ids(g, rng, CHUNK - 16, 16)
    gen = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 31)))
    active = torch.randint(-2**31, 2**31, (NB, FB // 32), dtype=torch.int32,
                           generator=gen).to(dev)
    masks = {"none": (None, None), "active": (None, active),
             "bits+active": (make_filter(g).bits, active)}
    xs = {
        "x f32 (n,)": torch.rand(n, generator=gen).to(dev),
        f"x f32 ({BATCH}, n)": torch.rand(BATCH, n, generator=gen).to(dev),
        f"x i32 ({BATCH}, n)": torch.randint(-9, 10, (BATCH, n), dtype=torch.int32,
                                            generator=gen).to(dev),
    }
    err = 0.0
    for weights in (g.block_weights, None):
        for mname, (bits, act) in masks.items():
            args = (ids, g.block_first, g.deltas, g.valid_count, bits, act, weights)
            got = compressed_chunked_spmv(None, *args, n=n, emit="decode")
            want = compressed_chunked_spmv_ref(None, *args, n=n, emit="decode")
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"decode differs (weighted={weights is not None}, masks={mname})")
            stats["cases"] += 1
            for xname, x in xs.items():
                got = compressed_chunked_spmv(x, *args, n=n, emit="sums")
                want = compressed_chunked_spmv_ref(x, *args, n=n, emit="sums")
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
                err = max(err, float((got.double() - want.double()).abs().max()))
                stats["cases"] += 1
    return err


def compare_patched_paths(g_host, g_dev, rng):
    """The exception-patching wrappers on the card against the CPU route."""
    import torch

    from repro_torch.kernels import compressed_chunked_stream_tile, compressed_spmv_vertex_chunked

    ids = chunk_ids(g_host, rng, CHUNK - 16, 16)
    got = compressed_chunked_stream_tile(g_dev, ids.to(g_dev.device))
    want = compressed_chunked_stream_tile(g_host, ids)
    check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
          "compressed_chunked_stream_tile differs from the CPU route")
    frontier = torch.from_numpy(rng.random(g_host.n) < 0.02)
    x = torch.rand(g_host.n, generator=torch.Generator().manual_seed(1))
    got = compressed_spmv_vertex_chunked(g_dev, x.to(g_dev.device), frontier.to(g_dev.device))
    want = compressed_spmv_vertex_chunked(g_host, x, frontier)
    torch.testing.assert_close(got.cpu(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
    return float((got.cpu().double() - want.double()).abs().max())


def time_kernel(g, rng):
    """Device ms of the kernel, its plain version and a one-call yardstick at
    the main-path shape (one chunk of CHUNK live ids, F_B=128, weighted,
    decode), and the bytes-bound ms for the same inputs."""
    import torch

    from repro_torch.kernels import compressed_chunked_spmv, compressed_chunked_spmv_ref

    ids = chunk_ids(g, rng, CHUNK, 0)
    args = (ids, g.block_first, g.deltas, g.valid_count, None, None, g.block_weights)
    ms = device_ms(lambda: compressed_chunked_spmv(None, *args, n=g.n, emit="decode"))
    plain_ms = device_ms(lambda: compressed_chunked_spmv_ref(None, *args, n=g.n,
                                                             emit="decode"))
    # no single PyTorch call computes this function; as a yardstick only, the
    # gather and the prefix sum of the decode, one library call each
    deltas = g.deltas
    yardstick_ms = device_ms(
        lambda: torch.cumsum(deltas.index_select(0, ids), dim=1, dtype=torch.int32))
    FB, C = g.block_size, ids.numel()
    live = int((ids < g.num_blocks).sum())
    read = 4 * C + live * (4 + 2 * FB + 2 + 4 * FB)   # ids; first, deltas, count, weights
    write = C * FB * (4 + 4)                          # dst, w
    bound_ms = (read + write) / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, yardstick_ms=yardstick_ms, bound_ms=bound_ms,
                bytes=read + write)


# ----------------------------------------------------------------------
# phase 3: invariants of a BFS tree, checked on the card
# ----------------------------------------------------------------------
def check_bfs_tree(g, src, parents, levels):
    """Each parent is a neighbour one level up, no edge spans more than one
    level, and reached vertices are closed under edges."""
    import torch

    from repro_torch.core import dense_block_view

    n, dev = g.n, g.device
    check(int(parents[src]) == src and int(levels[src]) == 0, "source row")
    reached = levels >= 0
    check(bool(((parents >= 0) == reached).all()), "parents and levels disagree")
    lev = torch.cat([levels, levels.new_full((1,), -1)]).long()
    par = torch.cat([parents, parents.new_full((1,), -1)]).long()
    parent_edge = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    R = 1 << 16
    for lo in range(0, g.num_blocks, R):
        hi = min(g.num_blocks, lo + R)
        dst, _ = dense_block_view(g, lo, hi)
        valid = dst < n
        s = torch.where(valid, g.block_src[lo:hi, None].long(), n)
        d = torch.where(valid, dst, n).long()
        ls, ld = lev[s], lev[d]
        check(bool(((ls >= 0) == (ld >= 0))[valid].all()), "edge leaves the reached set")
        check(bool(((ls - ld).abs() <= 1)[valid & (ls >= 0)].all()),
              "edge spans more than one level")
        parent_edge[s[valid & (par[s] == d)]] = True
    child = reached.clone()
    child[src] = False
    check(bool(parent_edge[:n][child].all()), "a parent is not a neighbour")
    plev = lev[par[:n].clamp(min=0)]
    check(bool((plev[child] == levels[child].long() - 1).all()), "a parent is not one level up")
    return int(reached.sum()), int(levels.max())


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke.py: no src/repro_torch beside {__file__}: run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.compressed_spmv.compressed_spmv import SOURCE

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_all([SOURCE])
    log(f"[1] kernel build (nvcc, sm_90a): {time.perf_counter() - t0:.1f} s")

    kernels = drive(dev)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


def drive(dev, graph_a=GRAPH_A, graph_b=GRAPH_B, graph_e=GRAPH_E) -> list[dict]:
    """Phases 2 to 6 on ``dev``; returns the kernels' records."""
    import numpy as np
    import torch

    from repro_torch.algorithms import bfs, pagerank, wbfs
    from repro_torch.core import exception_dense, make_plan
    from repro_torch.kernels import compressed_chunked_spmv
    from repro_torch.serving import QueryEngine

    wall = {}
    # graphs: built on the host, moved to the card ---------------------
    t0 = time.perf_counter()
    hB, gB, sB = build_graph(*graph_b, dev)
    log(f"graph B: n={gB.n} m={gB.m} NB={gB.num_blocks} exceptions={gB.n_exceptions} "
        f"exception_dense={exception_dense(gB)} built in {sB:.1f} s")
    check(not exception_dense(gB), "graph B must stream through the kernel")
    hE, gE, sE = build_graph(*graph_e, dev)
    log(f"graph E: n={gE.n} m={gE.m} NB={gE.num_blocks} exceptions={gE.n_exceptions} "
        f"exception_dense={exception_dense(gE)} built in {sE:.1f} s")
    check(0 < gE.n_exceptions and not exception_dense(gE), "graph E: a few exceptions")
    _, gA, sA = build_graph(*graph_a, dev)
    log(f"graph A: n={gA.n} m={gA.m} NB={gA.num_blocks} exceptions={gA.n_exceptions} "
        f"exception_dense={exception_dense(gA)} built in {sA:.1f} s")
    digests = {"A": graph_digest(gA), "B": graph_digest(gB)}
    wall["graphs"] = time.perf_counter() - t0

    # 2. the kernel against its plain version --------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    stats = {"cases": 0}
    err = max(compare_kernel(gB, rng, stats), compare_kernel(gE, rng, stats))
    err = max(err, compare_patched_paths(hE, gE, rng))
    timing = time_kernel(gB, rng)
    log(f"[2] kernel == plain on the card in {stats['cases']} cases (decode exact, sums "
        f"rtol {SUM_RTOL}); max abs err {err!r}; {compressed_chunked_spmv.launches} launches")
    log(f"[2] main-path shape C={CHUNK} F_B={BLOCK} weighted decode, device time: kernel "
        f"{timing['ms']!r} ms, plain {timing['plain_ms']!r} ms, yardstick (index_select + "
        f"cumsum) {timing['yardstick_ms']!r} ms, bound {timing['bound_ms']!r} ms "
        f"({timing['bytes']} B at {HBM_BYTES_PER_S / 1e12} TB/s)")
    wall["kernel"] = time.perf_counter() - t0

    # 3. graph A: the full configuration -------------------------------
    t0 = time.perf_counter()
    before = compressed_chunked_spmv.launches
    plan_a = make_plan(gA, strategy="auto")
    pr, iters = pagerank(gA, plan=plan_a)
    torch.cuda.synchronize()
    mass = float(pr.double().sum())
    check(abs(mass - 1.0) < PR_SUM_TOL and iters < 100 and bool(torch.isfinite(pr).all()),
          f"graph A PageRank: mass {mass}, {iters} iterations")
    log(f"[3] graph A PageRank: {iters} iterations, mass {mass:.7f}")
    srcs_a = sources(gA, 4, SEED)
    first = None
    for s in srcs_a:
        parents, levels = bfs(gA, s, plan=plan_a)
        first = (parents, levels) if first is None else first
        reached, depth = check_bfs_tree(gA, s, parents, levels)
        log(f"[3] graph A BFS from {s}: {reached} reached, depth {depth}, tree checked")
    streamed = bfs(gA, srcs_a[0], plan=make_plan(gA, strategy="sparse_streamed"))
    check(torch.equal(streamed[0], first[0]) and torch.equal(streamed[1], first[1]),
          "graph A: the sparse_streamed BFS differs from the auto BFS")
    launches_a = compressed_chunked_spmv.launches - before
    log(f"[3] graph A is exception-dense ({gA.n_exceptions} exceptions over the "
        f"limit): sparse_streamed runs plain sparse; kernel launches {launches_a}")
    check(exception_dense(gA) and launches_a == 0, "graph A must not launch the kernel")
    wall["graph A"] = time.perf_counter() - t0

    # 4. graph B: the kernel path (main path starts) --------------------
    t0 = time.perf_counter()
    compressed_chunked_spmv.launches = 0
    plan_b = make_plan(gB, strategy="sparse_streamed")
    plan_cpu = make_plan(hB, strategy="sparse_streamed")
    srcs_b = sources(gB, 2 + 16, SEED + 1)
    for s in srcs_b[:2]:
        before = compressed_chunked_spmv.launches
        parents, levels = bfs(gB, s, plan=plan_b)
        bfs_launches = compressed_chunked_spmv.launches - before
        cp, cl = bfs(hB, s, plan=plan_cpu)
        check(bfs_launches > 0, "graph B BFS did not launch the kernel")
        check(torch.equal(parents.cpu(), cp) and torch.equal(levels.cpu(), cl),
              f"graph B BFS from {s} differs from the CPU route")
        before = compressed_chunked_spmv.launches
        dist = wbfs(gB, s, plan=plan_b)
        wbfs_launches = compressed_chunked_spmv.launches - before
        check(wbfs_launches > 0, "graph B wBFS did not launch the kernel")
        check(torch.equal(dist.cpu(), wbfs(hB, s, plan=plan_cpu)),
              f"graph B wBFS from {s} differs from the CPU route")
        log(f"[4] graph B from {s}: BFS depth {int(levels.max())} ({bfs_launches} launches), "
            f"wBFS max dist {int(dist[dist < 2**31 - 1].max())} ({wbfs_launches} launches), "
            "both equal to the CPU route")
    pr, iters = pagerank(gB, eps=0.0, max_iters=PR_ITERS, plan=plan_b)
    pr_cpu, iters_cpu = pagerank(hB, eps=0.0, max_iters=PR_ITERS, plan=plan_cpu)
    pr_err = float((pr.cpu() - pr_cpu).abs().max())
    check(iters == iters_cpu == PR_ITERS and pr_err <= PR_ATOL,
          f"graph B PageRank differs from the CPU route by {pr_err}")
    log(f"[4] graph B PageRank, {iters} iterations: max abs diff to the CPU route {pr_err:.3g}")
    wall["graph B"] = time.perf_counter() - t0

    # 5. serving -------------------------------------------------------
    t0 = time.perf_counter()
    engine = QueryEngine(gB, plan=plan_b, max_batch=8)
    reqs = [("bfs", {"src": s}) for s in srcs_b[2:14]] + [("wbfs", {"src": s})
                                                        for s in srcs_b[14:18]]
    before = compressed_chunked_spmv.launches
    ts = time.perf_counter()
    results = engine.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - ts
    serve_launches = compressed_chunked_spmv.launches - before
    check(serve_launches > 0, "the engine did not launch the kernel")
    for (op, params), res in zip(reqs, results):
        if op == "bfs":
            want = bfs(gB, params["src"], plan=plan_b)
            check(torch.equal(res[0], want[0]) and torch.equal(res[1], want[1]),
                  f"engine BFS from {params['src']} differs from its single run")
        else:
            check(torch.equal(res, wbfs(gB, params["src"], plan=plan_b)),
                  f"engine wBFS from {params['src']} differs from its single run")
    main_launches = compressed_chunked_spmv.launches
    log(f"[5] engine: {len(reqs)} queries in {serve_s:.3f} s = {len(reqs) / serve_s:.2f} "
        f"queries/s, occupancy {engine.occupancy:.3f}, stats {engine.stats}, "
        f"kernel launches {serve_launches}; every result equals its single run")
    wall["serving"] = time.perf_counter() - t0

    # 6. large memory is never written ---------------------------------
    check(graph_digest(gA) == digests["A"] and graph_digest(gB) == digests["B"],
          "a graph tensor changed")
    log("[6] graph A and B tensors unchanged (SHA-256)")
    log("wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    check(main_launches > 0, "the main path did not launch the kernel")

    return [{
        "name": "compressed_chunked_spmv",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_launches,
        "max_abs_err": err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no one PyTorch call computes this decode
    }]


if __name__ == "__main__":
    sys.exit(main())
