"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

decode, filter words, int32 sums and the fused round's min and touched
masks must match exactly; float sums within rtol 1e-5,
because the kernels add the slots of a block in a warp-tree order.  Decode
attention within ``ATTN_REL_TOL``, the relative L2 difference of each
(sequence, head) row: 1e-5 in float32 (the kernel sums the rows in split
ranges and lane groups) and 2^-7 in bfloat16 (one ulp an element, from a
float32 value rounded once).  EmbeddingBag sums within rtol 1e-5 in
float32 and one ulp in bfloat16 (a float32 sum rounded once); bags of one,
and so ``take_rows``, exactly.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.algorithms import (
    bellman_ford,
    betweenness,
    bfs,
    bfs_batched,
    maximal_matching,
    wbfs,
    wbfs_batched,
    widest_path,
)
from repro_torch.algorithms.traversal import _relax
from repro_torch.core import (
    build_csr,
    compress,
    edgemap_chunked,
    edgemap_chunked_batched_streamed,
    edgemap_sum_compressed,
    exception_dense,
    make_filter,
    make_plan,
    pack_vertices,
)
from repro_torch.core.edgemap import _identity_map
from repro_torch.core.graph_filter import edge_active_words
from repro_torch.core.primitives import INF_I32
from repro_torch.configs import dbrx_132b, qwen2_1_5b
from repro_torch.configs import sasrec as sasrec_config
from repro_torch.core.convert import from_reference_arrays, to_reference_arrays
from repro_torch.data import rmat_graph
from repro_torch.kernels import (
    compressed_block_spmv,
    compressed_block_spmv_ref,
    compressed_chunked_spmv,
    compressed_chunked_spmv_ref,
    compressed_spmv_vertex,
    compressed_spmv_vertex_batched,
    compressed_stream_round,
    compressed_stream_round_graph,
    ATTN_REL_TOL,
    decode_attention,
    decode_attention_ref,
    decode_attention_rel_err,
    edge_block_spmv,
    edge_block_spmv_ref,
    bag_case,
    bag_of_one_case,
    bf16_ulps,
    embedding_bag,
    embedding_bag_ref,
    embedding_bag_sums,
    filter_pack_ref,
    filter_pack_words,
    real_slot_counts,
    same_bits,
    spmv_vertex,
    take_rows,
    BACKWARD_CHUNK,
    backward_plan,
    bag_grad_case,
    embedding_bag_backward,
    embedding_bag_backward_ref,
    embedding_bag_plan,
)
from repro_torch.kernels.decode_attention.decode_attention import split_rows
from repro_torch.kernels.embedding_bag.embedding_bag import _backward_sums
from repro_torch.data import make_candidates
from repro_torch.launch import assert_topk_agrees, sasrec_retrieval_step, sasrec_serve_step
from repro_torch.models import sasrec
from repro_torch.models import transformer_lm as lm
from repro_torch.tuning import DEFAULT_TILE_BLOCKS

SUM_RTOL = 1e-5  # float sums: warp-tree order against a sequential sum

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(fb, weighted, n=512, m=4096, seed=3):
    return compress(rmat_graph(n, m, weighted=weighted, seed=seed, block_size=fb,
                               device="cpu"))


def _to(c, dev):
    kind, arrays, meta = to_reference_arrays(c)
    return from_reference_arrays(kind, arrays, meta, dev)


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masks", [False, True])
def test_kernel_matches_plain(cuda, fb, weighted, masks):
    c = _graph(fb, weighted)
    gc = _to(c, cuda)
    rng = np.random.default_rng(fb)
    NB = c.num_blocks
    ids = torch.from_numpy(np.concatenate([rng.permutation(NB)[: NB // 2], [NB, NB + 9]])
                           .astype(np.int32))
    active = torch.from_numpy(rng.integers(-2**31, 2**31, (NB, fb // 32)).astype(np.int32))
    bits = make_filter(c).bits
    ops = dict(bits=bits if masks else None, edge_active=active if masks else None)
    dev_ops = {k: None if v is None else v.to(cuda) for k, v in ops.items()}
    common = (c.block_first, c.deltas, c.valid_count)
    dev_common = (gc.block_first, gc.deltas, gc.valid_count)

    want = compressed_chunked_spmv_ref(None, ids, *common, ops["bits"], ops["edge_active"],
                                       c.block_weights, n=c.n, emit="decode")
    got = compressed_chunked_spmv(None, ids.to(cuda), *dev_common, dev_ops["bits"],
                                  dev_ops["edge_active"], gc.block_weights, n=c.n,
                                  emit="decode")
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])

    for x in (torch.rand(c.n), torch.rand(3, c.n),
              torch.randint(-9, 9, (2, c.n), dtype=torch.int32)):
        want = compressed_chunked_spmv_ref(x, ids, *common, ops["bits"],
                                           ops["edge_active"], c.block_weights, n=c.n)
        got = compressed_chunked_spmv(x.to(cuda), ids.to(cuda), *dev_common,
                                      dev_ops["bits"], dev_ops["edge_active"],
                                      gc.block_weights, n=c.n)
        torch.cuda.synchronize()
        if x.dtype == torch.int32 and not weighted:
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu().float(), want.float(), rtol=SUM_RTOL,
                                       atol=1e-5)


def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    gc = _to(_graph(32, False), cuda)
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    before = compressed_chunked_spmv.launches
    compressed_chunked_spmv(None, ids, gc.block_first, gc.deltas, gc.valid_count,
                            n=gc.n, emit="decode")
    assert compressed_chunked_spmv.launches == before + 1
    with pytest.raises(TypeError):
        compressed_chunked_spmv(None, ids.long(), gc.block_first, gc.deltas,
                                gc.valid_count, n=gc.n, emit="decode")
    with pytest.raises(ValueError):
        compressed_chunked_spmv(None, ids, gc.block_first, gc.deltas[:, :16].contiguous(),
                                gc.valid_count, n=gc.n, emit="decode")
    assert compressed_chunked_spmv.launches == before + 1


def test_streamed_traversals_match_cpu_route(cuda):
    """BFS and wBFS on a sparse_streamed plan: one fused round a launch on
    the card, equal to the CPU route's chunk loop."""
    c = _graph(64, True, n=1024, m=8192, seed=5)
    gc = _to(c, cuda)
    before = compressed_stream_round.launches
    pc, lc = bfs(c, 3, plan=make_plan(c, strategy="sparse_streamed"))
    pg, lg = bfs(gc, 3, plan=make_plan(gc, strategy="sparse_streamed"))
    rounds = int(lc.max()) + 1
    assert compressed_stream_round.launches == before + rounds
    assert torch.equal(pg.cpu(), pc) and torch.equal(lg.cpu(), lc)
    dc = wbfs(c, 3, plan=make_plan(c, strategy="sparse_streamed"))
    dg = wbfs(gc, 3, plan=make_plan(gc, strategy="sparse_streamed"))
    assert torch.equal(dg.cpu(), dc)
    srcs = [3, 5, 9, 11]
    pc, lc = bfs_batched(c, srcs, plan=make_plan(c, strategy="sparse_streamed"))
    pg, lg = bfs_batched(gc, srcs, plan=make_plan(gc, strategy="sparse_streamed"))
    assert torch.equal(pg.cpu(), pc) and torch.equal(lg.cpu(), lc)
    dc = wbfs_batched(c, srcs, plan=make_plan(c, strategy="sparse_streamed"))
    dg = wbfs_batched(gc, srcs, plan=make_plan(gc, strategy="sparse_streamed"))
    assert torch.equal(dg.cpu(), dc)


def _exception_graph(fb, weighted):
    """n > 2^16 and few edges: a few blocks hold ESCAPE deltas, under the
    exception limit; weights are not whole."""
    rng = np.random.default_rng(fb + weighted)
    n = (1 << 17) + 3
    src = np.concatenate([np.repeat(rng.choice(n, 12, replace=False), 6),
                          rng.integers(0, n, 600)])
    dst = rng.integers(0, n, src.shape[0])
    w = rng.uniform(0.5, 9.5, src.shape[0]).astype(np.float32) if weighted else None
    c = compress(build_csr(n, torch.from_numpy(src), torch.from_numpy(dst),
                           None if w is None else torch.from_numpy(w), block_size=fb,
                           symmetrize=True, device="cpu"))
    assert c.n_exceptions > 0 and not exception_dense(c)
    return c


def _round_inputs(c, tiles, B, rng):
    """Frontier and int32 state of one round: every tile's blocks dead, all
    live, or one live block a tile (and its owner's other blocks)."""
    n, NB = c.n, c.num_blocks
    src = c.block_src.numpy()
    live = np.zeros(n, bool)
    if tiles == "all live":
        live[:] = True
    elif tiles == "one live":
        t = np.arange(0, NB, 32)
        live[src[np.minimum(t + (t // 32 * 7) % 32, NB - 1)]] = True
    rows = 1 if B is None else B
    frontier = live[None] & ((rng.random((rows, n)) < 0.7) | (tiles == "all live"))
    frontier[0] = live
    x = rng.integers(0, 5000, (rows, n)).astype(np.int32)
    x[rng.random((rows, n)) < 0.05] = INF_I32
    x[rng.random((rows, n)) < 0.05] = INF_I32 - (1 << 24) - rng.integers(-3, 4)
    lanes = rng.random(rows) < 0.5
    if B is None:
        return torch.from_numpy(frontier[0]), torch.from_numpy(x[0]), None
    return torch.from_numpy(frontier), torch.from_numpy(x), torch.from_numpy(lanes)


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tiles", ["all dead", "all live", "one live"])
def test_stream_round_tiles_match_plain(cuda, fb, weighted, tiles):
    """The fused round against its plain version, bit for bit: tiles all
    dead, all live and one live, one query and batches of 1, 8 and 33,
    both maps, with and without edge_active, on an R-MAT graph and on one
    whose exception blocks take their exact rows."""
    rng = np.random.default_rng(fb + weighted)
    for c in (_graph(fb, weighted, n=700, m=5000, seed=fb), _exception_graph(fb, weighted)):
        gc = _to(c, cuda)
        active = torch.from_numpy(rng.random(c.num_blocks * fb) < 0.7)
        for B in (None, 1, 8, 33):
            frontier, x, lanes = _round_inputs(c, tiles, B, rng)
            for words in (None, edge_active_words(active, fb)):
                for map_kind in ("identity", "sat_add_i32"):
                    want = compressed_stream_round_graph(c, frontier, x, words,
                                                         map_kind=map_kind, map_lanes=lanes)
                    before = compressed_stream_round.launches
                    got = compressed_stream_round_graph(
                        gc, frontier.to(cuda), x.to(cuda),
                        None if words is None else words.to(cuda), map_kind=map_kind,
                        map_lanes=None if lanes is None else lanes.to(cuda))
                    torch.cuda.synchronize()
                    assert compressed_stream_round.launches == before + 1
                    assert torch.equal(got[0].cpu(), want[0])
                    assert torch.equal(got[1].cpu(), want[1])
                    assert bool(want[1].any()) == (tiles != "all dead")


def test_fused_round_equals_the_chunk_loop_on_the_card(cuda):
    """edgemap_chunked and its batched form on the card: a tagged map makes
    one fused launch, the same map untagged runs the chunk loop through
    kernel 1's decode, and the two agree exactly."""
    c = _exception_graph(64, True)
    gc = _to(c, cuda)
    rng = np.random.default_rng(0)
    frontier, x, lanes = (t.to(cuda) for t in _round_inputs(c, "one live", 8, rng))
    for tagged in (_identity_map, _relax):
        def untagged(xs, w, fn=tagged):
            return fn(xs, w)

        for batched in (False, True):
            f, xx = (frontier, x) if batched else (frontier[0], x[0])
            run = (lambda fn: edgemap_chunked_batched_streamed(
                gc, f, xx, monoid="min", map_fn=fn, map_lanes=lanes)) if batched else (
                lambda fn: edgemap_chunked(gc, f, xx, monoid="min", map_fn=fn, streamed=True))
            before = (compressed_stream_round.launches, compressed_chunked_spmv.launches)
            fused = run(tagged)
            assert (compressed_stream_round.launches, compressed_chunked_spmv.launches) == (
                before[0] + 1, before[1])
            chunks = run(untagged)
            assert compressed_chunked_spmv.launches > before[1]
            assert compressed_stream_round.launches == before[0] + 1
            torch.cuda.synchronize()
            assert torch.equal(fused[0], chunks[0]) and torch.equal(fused[1], chunks[1])


def test_stream_round_rejects_bad_operands(cuda):
    gc = _to(_graph(32, False), cuda)
    f = torch.zeros(gc.n, dtype=torch.bool, device=cuda)
    x = torch.zeros(gc.n, dtype=torch.int32, device=cuda)
    args = (gc.block_src, gc.block_first, gc.deltas, gc.valid_count)
    before = compressed_stream_round.launches
    with pytest.raises(ValueError, match="no fused round"):
        compressed_stream_round(x, f, *args, n=gc.n, map_kind="sum")
    with pytest.raises(TypeError):
        compressed_stream_round(x.long(), f, *args, n=gc.n, map_kind="identity")
    with pytest.raises(TypeError):
        compressed_stream_round(x, f.to(torch.uint8), *args, n=gc.n, map_kind="identity")
    with pytest.raises(ValueError):
        compressed_stream_round(x[:-1], f, *args, n=gc.n, map_kind="identity")
    with pytest.raises(ValueError, match="together"):
        compressed_stream_round(x, f, *args, exc_row=torch.full_like(gc.block_src, -1),
                                n=gc.n, map_kind="identity")
    assert compressed_stream_round.launches == before


def _padded_shards(fb, weighted):
    """The exception graph's shards at k = 2, 3 and 4: lists padded with
    block id ``per`` and, where k does not divide NB, pad blocks owned by
    the sentinel ``n`` with valid count 0."""
    c = _exception_graph(fb, weighted)
    out = [(k, c, c.shard(k)) for k in (2, 3, 4)]
    assert any(bool((s.exc_block == s.num_blocks).any()) for _, _, shards in out
               for s in shards)
    assert any(c.num_blocks % k for k, _, _ in out)
    return out


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_stream_round_on_padded_shards_matches_plain(cuda, fb, weighted):
    """The fused round on each shard (padded exception lists, pad blocks of
    owner n) against its plain version bit for bit, one launch a shard, and
    the shards' min-combined rounds equal the whole graph's."""
    rng = np.random.default_rng(fb * 3 + weighted)
    for k, c, shards in _padded_shards(fb, weighted):
        for B in (None, 8):
            frontier, x, lanes = _round_inputs(c, "all live", B, rng)
            frontier = frontier & torch.from_numpy(rng.random(frontier.shape) < 0.5)
            for map_kind in ("identity", "sat_add_i32"):
                whole = compressed_stream_round_graph(c, frontier, x, None, map_kind=map_kind,
                                                      map_lanes=lanes)
                outs, hits = [], []
                for s in shards:
                    want = compressed_stream_round_graph(s, frontier, x, None,
                                                         map_kind=map_kind, map_lanes=lanes)
                    before = compressed_stream_round.launches
                    got = compressed_stream_round_graph(
                        _to(s, cuda), frontier.to(cuda), x.to(cuda), None,
                        map_kind=map_kind, map_lanes=None if lanes is None else lanes.to(cuda))
                    torch.cuda.synchronize()
                    assert compressed_stream_round.launches == before + 1
                    assert torch.equal(got[0].cpu(), want[0]), (k, B, map_kind)
                    assert torch.equal(got[1].cpu(), want[1]), (k, B, map_kind)
                    outs.append(got[0].cpu())
                    hits.append(got[1].cpu())
                assert torch.equal(torch.stack(outs).min(dim=0).values, whole[0])
                assert torch.equal(torch.stack(hits).any(dim=0), whole[1])


@pytest.mark.parametrize("fb", [32, 64, 128])
def test_chunk_decode_on_padded_shards_matches_plain(cuda, fb):
    """Kernel 1's decode entry on each shard's chunks (real ids, pad blocks
    and the fill id), exception rows patched, against its plain version;
    and an untagged min round (the chunk loop) on a (2,) and a (4,) mesh of
    the card, equal to the whole graph's CPU route."""
    from repro_torch.core import edgemap_reduce, make_mesh
    from repro_torch.kernels.compressed_spmv.ops import compressed_chunked_stream_tile

    rng = np.random.default_rng(fb)
    for k, c, shards in _padded_shards(fb, True):
        for s in shards:
            ids = torch.from_numpy(rng.permutation(s.num_blocks)[:64].astype(np.int64))
            ids = torch.cat([ids, torch.tensor([s.num_blocks, s.num_blocks])])
            active = torch.from_numpy(rng.random(s.num_blocks * fb) < 0.7)
            for words in (None, edge_active_words(active, fb)):
                want = compressed_chunked_stream_tile(s, ids, words)
                before = compressed_chunked_spmv.launches
                got = compressed_chunked_stream_tile(
                    _to(s, cuda), ids.to(cuda), None if words is None else words.to(cuda))
                torch.cuda.synchronize()
                assert compressed_chunked_spmv.launches == before + 1
                assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    c = _exception_graph(fb, True)
    gc = _to(c, cuda)
    frontier, x, _ = _round_inputs(c, "all live", None, rng)

    def untagged(xs, w):
        return _relax(xs, w)

    want = edgemap_reduce(c, frontier, x, monoid="min", map_fn=untagged, mode="sparse")
    for shape in ((2,), (4,)):
        plan = make_plan(gc, mesh=make_mesh(shape, ("data",)), strategy="sparse_streamed")
        before = (compressed_stream_round.launches, compressed_chunked_spmv.launches)
        got = edgemap_reduce(plan.prepare(gc), frontier.to(cuda), x.to(cuda), monoid="min",
                             map_fn=untagged, plan=plan)
        assert compressed_stream_round.launches == before[0]
        assert compressed_chunked_spmv.launches >= before[1] + shape[0]
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_sharded_traversals_match_single_device(cuda):
    """BFS and wBFS (single and batched) on (2,) and (4,) meshes of the card,
    sparse_streamed: k fused launches a round, results equal to the
    single-device card run bit for bit."""
    from repro_torch.core import make_mesh

    c = _exception_graph(64, True)
    gc = _to(c, cuda)
    single = make_plan(gc, strategy="sparse_streamed")
    p1, l1 = bfs(gc, 3, plan=single)
    d1 = wbfs(gc, 3, plan=single)
    db = wbfs_batched(gc, [3, 5, 9], plan=single)
    rounds = int(l1.max()) + 1
    for k in (2, 4):
        plan = make_plan(gc, mesh=make_mesh((k,), ("data",)), strategy="sparse_streamed")
        gs = plan.prepare(gc)
        before = compressed_stream_round.launches
        p, l = bfs(gs, 3, plan=plan)
        assert compressed_stream_round.launches == before + k * rounds
        assert torch.equal(p, p1) and torch.equal(l, l1)
        assert torch.equal(wbfs(gs, 3, plan=plan), d1)
        assert torch.equal(wbfs_batched(gs, [3, 5, 9], plan=plan), db)


@pytest.mark.parametrize("fb", [32, 64, 128])
def test_filter_pack_on_a_shards_filter_rows(cuda, fb):
    """Kernel 4 on each shard of a filter (zero pad rows at the tail) equals
    its plain version, and set cover on a (2,) mesh of the card equals the
    single-device card run, kernel 4 launched once a round and once up
    front."""
    from repro_torch.algorithms import set_cover
    from repro_torch.core import make_mesh

    c = _graph(fb, False, n=1000, m=6000, seed=fb)
    rng = np.random.default_rng(fb)
    f = make_filter(c)
    for k in (2, 3, 4):
        for s in f.shard(k):
            keep = torch.from_numpy(rng.random((s.num_blocks, fb)) < 0.6)
            sub = torch.from_numpy(rng.random(s.num_blocks) < 0.7)
            want = filter_pack_ref(s.bits, keep, sub)
            got = filter_pack_words(s.bits.to(cuda), keep.to(cuda), sub.to(cuda))
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    gc = _to(c, cuda)
    sets = torch.arange(c.n, device=cuda) % 2 == 0
    pri = torch.randperm(c.n, generator=torch.Generator().manual_seed(fb)).to(torch.int32)
    want = set_cover(gc, sets, priorities=pri.to(cuda))
    plan = make_plan(gc, mesh=make_mesh((2,), ("data",)))
    before = filter_pack_words.launches
    got = set_cover(gc, sets, priorities=pri.to(cuda), plan=plan)
    assert filter_pack_words.launches > before
    assert torch.equal(got, want)


def _assert_sums(got, want, exact):
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=SUM_RTOL, atol=1e-5)


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile_blocks", [1, 4, 8, 16, 32])
def test_whole_graph_kernels_match_plain(cuda, fb, weighted, tile_blocks):
    """Kernels 2 and 3 over every block, NB not a multiple of the tile."""
    c = _graph(fb, weighted, n=700, m=5000, seed=fb + tile_blocks)
    csr = rmat_graph(700, 5000, weighted=weighted, seed=fb + tile_blocks, block_size=fb,
                     device="cpu")
    gc, gcsr = _to(c, cuda), _to(csr, cuda)
    rng = np.random.default_rng(tile_blocks)
    NB = c.num_blocks
    active = torch.from_numpy(rng.integers(-2**31, 2**31, (NB, fb // 32)).astype(np.int32))
    bits = make_filter(c).bits
    for x in (torch.rand(c.n), torch.rand(3, c.n),
              torch.randint(-9, 9, (c.n,), dtype=torch.int32),
              torch.randint(-9, 9, (2, c.n), dtype=torch.int32)):
        for act in (None, active):
            want = compressed_block_spmv_ref(x, c.block_first, c.deltas, c.valid_count, bits,
                                             act, c.block_weights, n=c.n)
            got = compressed_block_spmv(
                x.to(cuda), gc.block_first, gc.deltas, gc.valid_count, bits.to(cuda),
                None if act is None else act.to(cuda), gc.block_weights, n=c.n,
                tile_blocks=tile_blocks)
            _assert_sums(got, want, x.dtype == torch.int32)
            want = edge_block_spmv_ref(x, csr.block_dst, csr.block_w, bits, act, n=c.n)
            got = edge_block_spmv(x.to(cuda), gcsr.block_dst, gcsr.block_w, bits.to(cuda),
                                  None if act is None else act.to(cuda), n=c.n,
                                  tile_blocks=tile_blocks)
            _assert_sums(got, want, x.dtype == torch.int32)


def _block_case(fb, weighted, nb, seed):
    """Compressed block arrays drawn from ``seed``: valid counts at 0, 1, 31,
    32, 33, FB - 1 and FB among random ones, 0xFFFF deltas and NaN weights
    past each count, random filter and traversal words."""
    rng = np.random.default_rng(seed)
    n = 5000
    vc = rng.integers(0, fb + 1, nb)
    edges = [c for c in (0, 1, 31, 32, 33, fb - 1, fb) if c <= fb]
    vc[:len(edges)] = edges
    past = np.arange(fb)[None, :] >= vc[:, None]
    deltas = np.where(past, 0xFFFF, rng.integers(0, 8, (nb, fb))).astype(np.uint16)
    first = rng.integers(0, n - 1000, nb).astype(np.int32)
    first[-1] = n - 200      # a block whose targets run past n
    w = np.where(past, np.nan, rng.random((nb, fb)) + 0.5).astype(np.float32)
    words = lambda: rng.integers(-2**31, 2**31, (nb, fb // 32)).astype(np.int32)  # noqa: E731
    arrays = dict(block_first=first, deltas=deltas.view(np.int16),
                  valid_count=vc.astype(np.uint16).view(np.int16), bits=words(),
                  edge_active=words(), block_weights=w if weighted else None)
    return n, {k: None if a is None else torch.from_numpy(a) for k, a in arrays.items()}


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile_blocks", [1, 8, 32])
def test_block_spmv_tiles_match_plain(cuda, fb, weighted, tile_blocks):
    """Kernel 2's tiles of 32 blocks against its plain version: NB not a
    multiple of 32, every edge of a valid count, garbage past each count,
    B of 1, 3, 5 and 8; int32 sums exactly, a wrapping one included."""
    nb = 32 * 7 + 13
    n, arrays = _block_case(fb, weighted, nb, fb + tile_blocks + weighted)
    dev = {k: None if t is None else t.to(cuda) for k, t in arrays.items()}
    order = ("block_first", "deltas", "valid_count", "bits", "edge_active", "block_weights")
    rng = np.random.default_rng(tile_blocks)
    for B in (1, 3, 5, 8):
        shape = (n,) if B == 1 else (B, n)
        xs = [torch.from_numpy(rng.random(shape).astype(np.float32)),
              torch.from_numpy(rng.integers(-9, 9, shape).astype(np.int32))]
        if not weighted:   # sums of 2^30-ish values wrap in int32
            xs.append(torch.from_numpy(rng.integers(2**30, 2**31 - 1, shape).astype(np.int32)))
        for x in xs:
            for act in (None, dev["edge_active"]):
                args = [dev[k] for k in order]
                args[4] = act
                want = compressed_block_spmv_ref(x.to(cuda), *args, n=n)
                got = compressed_block_spmv(x.to(cuda), *args, n=n, tile_blocks=tile_blocks)
                exact = x.dtype == torch.int32
                assert bool(torch.isfinite(want.float()).all())
                _assert_sums(got, want.cpu(), exact)


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile_blocks", [1, 4, 8, 16, 32])
def test_edge_block_spmv_reads_only_the_real_slots(cuda, fb, weighted, tile_blocks):
    """Kernel 3 given the owner arrays against its plain version and against
    its whole-row path, at every case of test_whole_graph_kernels_match_plain,
    on a graph whose padding weights are NaN (never read into a sum)."""
    csr = rmat_graph(700, 5000, weighted=weighted, seed=fb + tile_blocks, block_size=fb,
                     device="cpu")
    pad = csr.edge_dst == csr.n
    assert bool(pad.any())
    csr = dataclasses.replace(csr, edge_w=torch.where(pad, float("nan"), csr.edge_w))
    g = _to(csr, cuda)
    own = (g.block_src, g.block_offsets, g.degrees)
    rng = np.random.default_rng(tile_blocks)
    NB = csr.num_blocks
    active = torch.from_numpy(rng.integers(-2**31, 2**31, (NB, fb // 32)).astype(np.int32))
    bits = make_filter(csr).bits
    for x in (torch.rand(csr.n), torch.rand(3, csr.n),
              torch.randint(-9, 9, (csr.n,), dtype=torch.int32),
              torch.randint(-9, 9, (2, csr.n), dtype=torch.int32)):
        exact = x.dtype == torch.int32
        for b, act in ((None, None), (bits, None), (bits, active), (None, active)):
            dev_b, dev_a = (None if t is None else t.to(cuda) for t in (b, act))
            want = edge_block_spmv_ref(x, csr.block_dst, csr.block_w, b, act, n=csr.n)
            assert bool(torch.isfinite(want.float()).all())
            got = edge_block_spmv(x.to(cuda), g.block_dst, g.block_w, dev_b, dev_a, n=csr.n,
                                  tile_blocks=tile_blocks, owners=own)
            _assert_sums(got, want, exact)
            rows = edge_block_spmv(x.to(cuda), g.block_dst, g.block_w, dev_b, dev_a, n=csr.n,
                                   tile_blocks=tile_blocks)
            _assert_sums(got, rows.cpu(), exact)


def test_edge_block_spmv_owners_on_an_edgeless_graph(cuda):
    """The dummy block of an edgeless graph is owned by the sentinel: no
    slot of it is read, and its sum is 0."""
    e = np.zeros(0, np.int64)
    g = build_csr(5, e, e, block_size=32, device=cuda)
    assert g.num_blocks == 1 and int(g.block_src[0]) == g.n
    assert int(real_slot_counts(g.block_src, g.block_offsets, g.degrees, n=g.n,
                                block_size=32)[0]) == 0
    for x in (torch.rand(5, device=cuda), torch.ones(2, 5, dtype=torch.int32, device=cuda)):
        got = edge_block_spmv(x, g.block_dst, g.block_w, None, n=g.n,
                              owners=(g.block_src, g.block_offsets, g.degrees))
        torch.cuda.synchronize()
        assert not bool(got.any())


def test_whole_graph_ops_and_launch_counts(cuda):
    c = _graph(64, True, n=1024, m=8192, seed=2)
    csr = rmat_graph(1024, 8192, weighted=True, seed=2, block_size=64, device="cpu")
    gc, gcsr = _to(c, cuda), _to(csr, cuda)
    x = torch.randint(-9, 9, (4, c.n), dtype=torch.int32)
    before = (compressed_block_spmv.launches, edge_block_spmv.launches)
    got_c = compressed_spmv_vertex_batched(gc, x.to(cuda))
    got_e = spmv_vertex(gcsr, x[1].to(cuda))
    assert (compressed_block_spmv.launches, edge_block_spmv.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got_c.cpu(), compressed_spmv_vertex_batched(c, x))
    assert torch.equal(got_e.cpu(), got_c[1].cpu())  # the same edges in the same blocks
    assert torch.equal(compressed_spmv_vertex(gc, x[1].to(cuda)).cpu(), got_c[1].cpu())
    before = (compressed_block_spmv.launches, edge_block_spmv.launches)
    with pytest.raises(ValueError, match="tile_blocks"):
        compressed_block_spmv(x.to(cuda), gc.block_first, gc.deltas, gc.valid_count, None,
                              n=c.n, tile_blocks=64)
    with pytest.raises(TypeError):
        edge_block_spmv(x.double().to(cuda), gcsr.block_dst, gcsr.block_w, None, n=c.n)
    with pytest.raises(ValueError, match="block_offsets"):
        edge_block_spmv(x.to(cuda), gcsr.block_dst, gcsr.block_w, None, n=c.n,
                        owners=(gcsr.block_src, gcsr.block_offsets[:-1], gcsr.degrees))
    with pytest.raises(TypeError):
        edge_block_spmv(x.to(cuda), gcsr.block_dst, gcsr.block_w, None, n=c.n,
                        owners=(gcsr.block_src.long(), gcsr.block_offsets, gcsr.degrees))
    assert (compressed_block_spmv.launches, edge_block_spmv.launches) == before


@pytest.mark.parametrize("fb", [32, 64, 128])
def test_unweighted_sums_on_a_weighted_graph(cuda, fb):
    """Kernel 2 without weights on a weighted graph (``edgemap_sum_compressed``'s
    call), with and without ``edge_active`` words: equal to its plain version
    without weights; the op, exception rows patched, equal to its CPU route
    in one kernel 2 launch."""
    c = _exception_graph(fb, True)
    gc = _to(c, cuda)
    rng = np.random.default_rng(fb)
    active = torch.from_numpy(rng.integers(-2**31, 2**31, (c.num_blocks, fb // 32))
                              .astype(np.int32))
    bits = make_filter(c).bits
    for x in (torch.rand(c.n), torch.randint(-9, 9, (c.n,), dtype=torch.int32)):
        exact = x.dtype == torch.int32
        for act in (None, active):
            dact = None if act is None else act.to(cuda)
            want = compressed_block_spmv_ref(x, c.block_first, c.deltas, c.valid_count, bits,
                                             act, None, n=c.n)
            got = compressed_block_spmv(x.to(cuda), gc.block_first, gc.deltas,
                                        gc.valid_count, bits.to(cuda), dact, None, n=c.n)
            _assert_sums(got, want, exact)
            before = compressed_block_spmv.launches
            got = edgemap_sum_compressed(gc, x.to(cuda), edge_active=dact)
            assert compressed_block_spmv.launches == before + 1
            _assert_sums(got, edgemap_sum_compressed(c, x, edge_active=act), exact)


@pytest.mark.parametrize("graph", ["rmat", "exceptions"])
def test_float_monoid_traversals_match_cpu_route(cuda, graph):
    """Bellman-Ford (min over float32 x + w), widest path (max) and
    betweenness (sums) on a sparse_streamed plan run the chunk loop over
    kernel 1's decode, never the fused round: the first two equal the CPU
    route bit for bit, betweenness within 1e-4 of its largest score;
    Bellman-Ford equals wBFS on integer weights."""
    if graph == "rmat":
        c = _graph(64, True, n=1024, m=8192, seed=5)
    else:
        c = _exception_graph(64, True)
    gc = _to(c, cuda)
    plan_c, plan_g = (make_plan(g, strategy="sparse_streamed") for g in (c, gc))
    src = int(torch.argmax(c.degrees))
    for fn in (bellman_ford, widest_path, betweenness):
        before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
        got = fn(gc, src, plan=plan_g)
        torch.cuda.synchronize()
        assert compressed_chunked_spmv.launches > before[0]
        assert compressed_stream_round.launches == before[1]
        want = fn(c, src, plan=plan_c)
        if fn is bellman_ford:
            assert got[1] is want[1] is False
            got, want = got[0], want[0]
        if fn is betweenness:
            err = float((got.cpu() - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max())
        else:
            assert torch.equal(got.cpu(), want)
    if graph == "rmat":  # integer weights: Bellman-Ford's distances are wBFS's
        d = wbfs(gc, src, plan=plan_g)
        want = torch.where(d == INF_I32, float("inf"), d.float())
        assert torch.equal(bellman_ford(gc, src, plan=plan_g)[0], want)


def _pack_case(nb, fb, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(-2**31, 2**31, (nb, fb // 32)).astype(np.int32)
    bits[:, 0] |= np.int32(-2**31)   # bit 31 set
    keep = rng.random((nb, fb)) < 0.5
    sub = rng.random(nb) < 0.6
    return (torch.from_numpy(bits), torch.from_numpy(keep), torch.from_numpy(sub))


@pytest.mark.parametrize("fb", [32, 64, 128])
@pytest.mark.parametrize("nb", [1, 1001, 4099])
def test_filter_pack_matches_plain(cuda, fb, nb):
    """Kernel 4, NB not a multiple of the warps per CTA, every subset case."""
    assert nb % DEFAULT_TILE_BLOCKS != 0
    bits, keep, sub = _pack_case(nb, fb, fb + nb)
    for s in (sub, torch.zeros_like(sub), torch.ones_like(sub)):
        for k in (keep, torch.zeros_like(keep)):
            want = filter_pack_ref(bits, k, s)
            got = filter_pack_words(bits.to(cuda), k.to(cuda), s.to(cuda))
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("fb", [32, 64, 128])
def test_filter_pack_row_groups_match_plain(cuda, fb):
    """Kernel 4 at NB around the rows a warp takes (4 groups of 512 / F_B)
    and a CTA's (DEFAULT_TILE_BLOCKS warps), every subset case."""
    rows = 4 * 512 // fb
    cta = rows * DEFAULT_TILE_BLOCKS
    for nb in (rows - 1, rows + 1, cta - 1, cta + 3, 3 * cta - 5):
        bits, keep, sub = _pack_case(nb, fb, fb * nb)
        for s in (sub, torch.zeros_like(sub), torch.ones_like(sub)):
            for k in (keep, torch.ones_like(keep)):
                want = filter_pack_ref(bits, k, s)
                got = filter_pack_words(bits.to(cuda), k.to(cuda), s.to(cuda))
                torch.cuda.synchronize()
                assert torch.equal(got[0].cpu(), want[0])
                assert torch.equal(got[1].cpu(), want[1])


def test_filter_pack_takes_a_keep_view_off_16_bytes(cuda):
    """The kernel loads keep 16 bytes at a time: the raw wrapper refuses a
    view that does not start on 16 bytes, and the op copies one."""
    c = _graph(64, False, n=1024, m=8192, seed=6)
    gc = _to(c, cuda)
    rng = np.random.default_rng(1)
    NB, FB = c.num_blocks, c.block_size
    keep = torch.from_numpy(rng.random(NB * FB + 1) < 0.7)
    subset = torch.from_numpy(rng.random(c.n) < 0.5)
    view = keep.to(cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        filter_pack_words(make_filter(gc).bits, view.reshape(NB, FB),
                          torch.ones(NB, dtype=torch.bool, device=cuda))
    want = pack_vertices(c, make_filter(c), subset, keep[1:])
    got = pack_vertices(gc, make_filter(gc), subset.to(cuda), view)
    for name in ("bits", "active_deg", "dirty"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


def test_pack_vertices_launches_filter_pack_once(cuda):
    c = _graph(64, False, n=1024, m=8192, seed=6)
    gc = _to(c, cuda)
    rng = np.random.default_rng(0)
    keep = torch.from_numpy(rng.random(c.num_blocks * c.block_size) < 0.7)
    subset = torch.from_numpy(rng.random(c.n) < 0.5)
    want = pack_vertices(c, make_filter(c), subset, keep)
    before = filter_pack_words.launches
    got = pack_vertices(gc, make_filter(gc), subset.to(cuda), keep.to(cuda))
    assert filter_pack_words.launches == before + 1
    for name in ("bits", "active_deg", "dirty"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    before = filter_pack_words.launches
    partner = maximal_matching(gc)
    assert torch.equal(partner.cpu(), maximal_matching(c))
    assert filter_pack_words.launches > before


def test_filter_pack_rejects_bad_operands(cuda):
    bits, keep, sub = (t.to(cuda) for t in _pack_case(50, 64, 1))
    before = filter_pack_words.launches
    with pytest.raises(ValueError, match="contiguous"):
        filter_pack_words(bits, keep.T.contiguous().T, sub)
    with pytest.raises(TypeError):
        filter_pack_words(bits, keep.to(torch.uint8), sub)
    with pytest.raises(TypeError):
        filter_pack_words(bits.to(torch.int64), keep, sub)
    with pytest.raises(ValueError):
        filter_pack_words(bits, keep, sub.cpu())
    with pytest.raises(ValueError, match="block size"):
        filter_pack_words(torch.zeros(50, 3, dtype=torch.int32, device=cuda),
                          torch.zeros(50, 96, dtype=torch.bool, device=cuda), sub)
    assert filter_pack_words.launches == before


# qwen2-1.5b's smoke logits, kernel route against the plain route, element by
# element: float32 sums in another order; in bfloat16 the attention output
# moves by an ulp, which two layers carry into the logits
LOGITS_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
ATTN_SHAPES = [  # (B, S, Hq, Hkv, D): the JAX sweep, qwen2-1.5b, an MHA, a group over 8 heads
    (2, 64, 4, 4, 8), (6, 300, 8, 2, 16), (3, 128, 6, 1, 32), (8, 1000, 12, 2, 128),
    (4, 777, 20, 20, 128), (3, 500, 24, 2, 64),
    # groups of 2 and 8, and 12 (two head chunks) at D = 16; S not a multiple of 32
    (5, 97, 4, 2, 64), (4, 201, 16, 2, 32), (2, 130, 12, 1, 16), (3, 95, 16, 2, 8),
    # dbrx-132b's 48 over 8 and mistral-large-123b's 96 over 8 (two head chunks) at D = 128
    (4, 600, 48, 8, 128), (2, 333, 96, 8, 128),
]
# the edges of the tensor-core kernel's ring: 1, one short of a 32-row stage,
# one stage, one past it, two stages and around them, and S
STAGE_EDGES = (1, 31, 32, 33, 63, 64, 65)


def _attn_case(B, S, Hq, Hkv, D, dtype, dev, seed, lengths="mixed"):
    g = torch.Generator().manual_seed(seed)
    if lengths == "stage edges":
        B = len(STAGE_EDGES) + 1
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev)
               for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    if lengths == "stage edges":
        pos = torch.tensor([min(p, S) for p in STAGE_EDGES] + [S], dtype=torch.int32)
        return q, k, v, pos.to(dev)
    _, rows = split_rows(q, k)
    pos = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32)
    # 1, S, a tile boundary, and a split boundary with the row after it
    fixed = [1, S, min(128, S), min(rows, S), min(rows + 1, S)]
    pos[:len(fixed)] = torch.tensor(fixed[:B], dtype=torch.int32)
    return q, k, v, pos.to(dev)


def _plant_nan_past(t, pos):
    """``t`` (B, S, H, D) with NaN in every row at and past each ``pos``."""
    rows = torch.arange(t.shape[1], device=t.device)[None, :] >= pos[:, None].long()
    return t.masked_fill(rows[:, :, None, None], float("nan"))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", ["mixed", "stage edges"])
@pytest.mark.parametrize("nan_past_pos", [False, True])
def test_decode_attention_matches_plain(cuda, shape, dtype, lengths, nan_past_pos):
    """Kernel 6 against its plain version within ``ATTN_REL_TOL``.  With NaN
    planted in the K and V rows at and past pos, the kernel (which never
    reads them) must stay finite and equal the plain version on the clean
    cache."""
    q, k, v, pos = _attn_case(*shape, dtype, cuda, sum(shape), lengths)
    want = decode_attention_ref(q, k, v, pos)
    if nan_past_pos:
        k, v = _plant_nan_past(k, pos), _plant_nan_past(v, pos)
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos)
    assert decode_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    assert decode_attention_rel_err(got, want) <= ATTN_REL_TOL[dtype]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lse_matches_plain(cuda, shape, dtype):
    """Kernel 6 with ``return_lse=True`` (the first sequence at pos 0): the
    float32 output within ``ATTN_REL_TOL`` of the plain version's, the lse
    within 1e-5, the empty sequence exactly 0 and -inf, and the output
    rounded bit for bit the call without lse."""
    q, k, v, pos = _attn_case(*shape, dtype, cuda, sum(shape))
    pos[0] = 0
    out, lse = decode_attention(q, k, v, pos, return_lse=True)
    want, want_lse = decode_attention_ref(q, k, v, pos, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32
    assert torch.equal(out[0], torch.zeros_like(out[0])) and bool((lse[0] == -math.inf).all())
    assert decode_attention_rel_err(out[1:], want[1:]) <= ATTN_REL_TOL[dtype]
    assert float((lse[1:] - want_lse[1:]).abs().max()) <= 1e-5
    assert torch.equal(out[1:].to(dtype), decode_attention(q, k, v, pos)[1:])


def test_decode_attention_rejects_bad_operands(cuda):
    q, k, v, pos = _attn_case(2, 64, 6, 2, 32, torch.float32, cuda, 0)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                         v[..., :24].contiguous(), pos)
    with pytest.raises(ValueError, match="group"):
        decode_attention(q[:, :5].contiguous(), k, v, pos)
    with pytest.raises(TypeError):
        decode_attention(q, k.bfloat16(), v, pos)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k.half(), v.half(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos)
    with pytest.raises(TypeError):
        decode_attention(q, k, v, pos.long())
    assert decode_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_kernel_route_matches_plain(cuda, dtype):
    """qwen2-1.5b's smoke config on the card: one kernel launch a layer a
    step, and the logits of the plain route on the same caches."""
    cfg = dataclasses.replace(qwen2_1_5b.smoke_config(), dtype=dtype)
    params = lm.init(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (3, 20), generator=torch.Generator().manual_seed(1))
    toks = toks.to(cuda)
    _, cache = lm.prefill(params, toks[:, :12], cfg, max_seq=20)
    tol = LOGITS_TOL[cfg.activation_dtype]
    for p in range(12, 20):
        plain_cache = {"main": {k: t.clone() for k, t in cache["main"].items()}}
        before = decode_attention.launches
        logits, _ = lm.decode_step(params, cache, toks[:, p:p + 1], p, cfg)
        assert decode_attention.launches == before + cfg.n_layers
        want, _ = lm.decode_step(params, plain_cache, toks[:, p:p + 1], p, cfg,
                                 attention=decode_attention_ref)
        torch.cuda.synchronize()
        torch.testing.assert_close(logits.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_step_kernel_route_matches_plain(cuda, dtype):
    """dbrx-132b's smoke config (MoE blocks, GQA) on the card: one kernel
    launch a layer a step, and the logits of the plain route on the same
    caches."""
    cfg = dataclasses.replace(dbrx_132b.smoke_config(), dtype=dtype)
    params = lm.init(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (3, 20), generator=torch.Generator().manual_seed(1))
    toks = toks.to(cuda)
    _, cache = lm.prefill(params, toks[:, :12], cfg, max_seq=20)
    tol = LOGITS_TOL[cfg.activation_dtype]
    for p in range(12, 20):
        plain_cache = {"moe": {k: t.clone() for k, t in cache["moe"].items()}}
        before = decode_attention.launches
        logits, _ = lm.decode_step(params, cache, toks[:, p:p + 1], p, cfg)
        assert decode_attention.launches == before + cfg.n_layers
        want, _ = lm.decode_step(params, plain_cache, toks[:, p:p + 1], p, cfg,
                                 attention=decode_attention_ref)
        torch.cuda.synchronize()
        torch.testing.assert_close(logits.float(), want.float(), rtol=tol, atol=tol)


# (V, D, B, L): the JAX sweep, kernels_micro's, SASRec's width, an odd width
BAG_SHAPES = [(50, 8, 16, 4), (100, 16, 37, 5), (200, 32, 64, 9), (4096, 64, 512, 16),
              (3000, 50, 1000, 50), (500, 33, 77, 3)]


def _assert_bags(got, want):
    torch.cuda.synchronize()
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.bfloat16:
        assert int(bf16_ulps(got, want).max()) <= 1
    else:
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=1e-6)


@pytest.mark.parametrize("shape", BAG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_plain(cuda, shape, dtype, mode):
    """Kernel 5, B not a multiple of the warps per CTA for most shapes."""
    table, idx, w = bag_case(*shape, dtype, sum(shape))
    before = embedding_bag_sums.launches
    got = embedding_bag(table.to(cuda), idx.to(cuda), w.to(cuda), mode=mode)
    assert embedding_bag_sums.launches == before + 1
    _assert_bags(got, embedding_bag(table, idx, w, mode=mode))
    _assert_bags(embedding_bag_sums(table.to(cuda), idx.to(cuda)), embedding_bag_ref(table, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bags_of_one_and_take_rows_are_exact(cuda, dtype):
    V = 1000
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.standard_normal((V, 50)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, V, (4099, 1)).astype(np.int32))
    want = table[ids[:, 0].long()]
    for w in (None, torch.ones(4099, 1, dtype=dtype)):
        got = embedding_bag_sums(table.to(cuda), ids.to(cuda), None if w is None else w.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    mixed = torch.from_numpy(rng.integers(-V - 5, V + 5, (7, 301)).astype(np.int32))
    before = embedding_bag_sums.launches
    got = take_rows(table.to(cuda), mixed.to(cuda))
    assert embedding_bag_sums.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), take_rows(table, mixed))
    buf = torch.empty(table.numel() + 1, dtype=dtype, device=cuda)
    buf[1:] = table.flatten().to(cuda)
    odd = buf[1:].view(table.shape)  # the rows one element off: narrower loads
    assert torch.equal(take_rows(odd, mixed.to(cuda)).cpu(), take_rows(table, mixed))


@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("dtype,D,vb", [(torch.float32, 64, 16), (torch.float32, 50, 8),
                                        (torch.float32, 33, 4), (torch.bfloat16, 64, 16),
                                        (torch.bfloat16, 50, 4), (torch.bfloat16, 33, 2)])
def test_bags_of_one_path_is_the_plain_version_bit_for_bit(cuda, B, dtype, D, vb):
    """Kernel 5 at L = 1 (its bags-of-one path): a warp's 32 bags, one short,
    one over and many; every row load width; -0.0 planted (the plain
    version's 0 + 0 * w turns it into +0.0, a copy of the row would not);
    ids -1, -7, V, V+3 and a NaN weight on one of them; with and without
    weights."""
    from repro_torch.kernels.embedding_bag.embedding_bag import vector_bytes

    table, idx, w = bag_of_one_case(997, D, B, dtype, seed=B + D)
    gt = table.to(cuda)
    out = torch.empty((B, D), dtype=dtype, device=cuda)
    assert vector_bytes(D * table.element_size(), table.element_size(), gt.data_ptr(),
                        out.data_ptr()) == vb
    for weights in (w, None):
        want = embedding_bag_ref(table, idx, weights)
        before = embedding_bag_sums.launches
        got = embedding_bag_sums(gt, idx.to(cuda), None if weights is None else weights.to(cuda))
        assert embedding_bag_sums.launches == before + 1
        torch.cuda.synchronize()
        assert same_bits(got.cpu(), want)
    assert not bool(torch.signbit(want[0, ::3]).any())  # +0.0 where the row held -0.0


def test_embedding_bag_rejects_bad_operands(cuda):
    table, idx, w = bag_case(50, 8, 16, 4, torch.float32, 0, cuda)
    before = embedding_bag_sums.launches
    with pytest.raises(TypeError):
        embedding_bag_sums(table, idx.long(), w)
    with pytest.raises(TypeError):
        embedding_bag_sums(table.half(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_sums(table.T.contiguous().T, idx, w)
    with pytest.raises(ValueError):
        embedding_bag_sums(table, idx.cpu(), w)
    with pytest.raises(ValueError):
        embedding_bag_sums(table, idx, w[:, :3].contiguous())
    with pytest.raises(ValueError):
        embedding_bag_sums(table[0], idx, w)
    assert embedding_bag_sums.launches == before


# (V, D, B, L, hot share, weighted): bags of one, weighted bags, a row over
# BACKWARD_CHUNK slots, two column tiles (D = 200), one column, a row of exactly
# one chunk and one of a chunk and one slot; odd widths on each side of
# SASRec's 50 and a width of 16-byte rows; a row of 768 chunks (train_batch's
# hot row)
GRAD_CASES = [(1000, 50, 4099, 1, 0.0, False), (500, 33, 300, 9, 0.0, True),
              (2000, 50, 20000, 1, 0.5, False), (3000, 50, 1000, 50, 0.5, True),
              (97, 200, 700, 3, 0.2, True), (64, 1, 333, 2, 0.0, False),
              (50, 16, BACKWARD_CHUNK, 1, 1.0, False), (50, 16, BACKWARD_CHUNK + 1, 1, 1.0, True),
              (700, 49, 900, 4, 0.3, True), (700, 51, 900, 4, 0.3, False),
              (4096, 64, 5000, 2, 0.0, True), (1000, 50, 768 * BACKWARD_CHUNK, 1, 1.0, False)]


def _plan_case(kind, V):
    """int32 ids (B, L) for the preparation's card tests, drawn from ``V``."""
    rng = np.random.default_rng(V)
    if kind == "padding":
        return torch.from_numpy(rng.choice(np.array([-1, -7, V, V + 3], np.int32), (999, 2)))
    if kind == "one id":
        return torch.full((768 * BACKWARD_CHUNK + 1, 1), min(5, V - 1), dtype=torch.int32)
    if kind == "sparse":  # 80 ids: long gaps between them at V = 2^20, short ones at 2^10
        return torch.from_numpy(rng.integers(0, V, (40, 2)).astype(np.int32))
    ids = rng.integers(0, V, (3001, 1 if kind == "bags of one" else 7)).astype(np.int32)
    ids.flat[rng.choice(ids.size, 4, replace=False)] = [-1, -7, V, V + 3]
    return torch.from_numpy(ids)


@pytest.mark.parametrize("kind", ["bags of one", "L > 1", "padding", "one id", "sparse"])
@pytest.mark.parametrize("V", [1, 1023, 1024, 1025, 2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1])
def test_embedding_bag_plan_matches_backward_plan(cuda, kind, V):
    """The preparation on the card (the port's radix sort) against
    ``backward_plan``: ``row_start``, ``chunk_base`` and
    ``order[:row_start[V]]`` bit for bit, one launch a call; the radix sort's
    bit count changes with V - 1 at V = 2^k + 1."""
    ids = _plan_case(kind, V)
    want = backward_plan(ids, V)
    before = embedding_bag_plan.launches
    order, row_start, chunk_base = embedding_bag_plan(ids.to(cuda), V)
    assert embedding_bag_plan.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(row_start.cpu(), want[1])
    assert torch.equal(chunk_base.cpu(), want[2])
    n = int(want[1][V])
    assert order.shape == want[0].shape and torch.equal(order[:n].cpu(), want[0][:n])


def test_backward_sums_refuses_a_plan_off_the_card(cuda):
    """The sums alone raise on a plan that lies on the CPU while the gradient
    lies on the card, and on a plan of another lookup; nothing launches."""
    V, D, B, L = 300, 50, 64, 3
    g, ids, w = bag_grad_case(V, D, B, L, seed=5, hot=0.2, weighted=True)
    plan = backward_plan(ids, V)
    before = embedding_bag_backward.launches
    with pytest.raises(ValueError):
        _backward_sums(g.to(cuda), *plan, L, w.to(cuda))
    card_plan = embedding_bag_plan(ids.to(cuda), V)
    with pytest.raises(ValueError):
        _backward_sums(g.to(cuda), *card_plan, L + 1, None)
    assert embedding_bag_backward.launches == before
    got = _backward_sums(g.to(cuda), *card_plan, L, w.to(cuda))
    assert embedding_bag_backward.launches == before + 1
    assert same_bits(got.cpu(), embedding_bag_backward_ref(g, ids, V, w))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_embedding_bag_backward_matches_plain_bit_for_bit(cuda, case):
    """Kernel 5' against its plain version (on the CPU and on the card), bit
    for bit, one launch a call, the same bits on a second call."""
    V, D, B, L, hot, weighted = case
    g, ids, w = bag_grad_case(V, D, B, L, seed=V + D, hot=hot, weighted=weighted)
    want = embedding_bag_backward_ref(g, ids, V, w)
    before = embedding_bag_backward.launches
    got = embedding_bag_backward(g.to(cuda), ids.to(cuda), V, None if w is None else w.to(cuda))
    assert embedding_bag_backward.launches == before + 1
    torch.cuda.synchronize()
    assert same_bits(got.cpu(), want)
    again = embedding_bag_backward(g.to(cuda), ids.to(cuda), V,
                                   None if w is None else w.to(cuda))
    assert same_bits(again, got)
    plain_on_card = embedding_bag_backward_ref(g.to(cuda), ids.to(cuda), V,
                                               None if w is None else w.to(cuda))
    assert same_bits(plain_on_card.cpu(), want)


def test_take_rows_backward_reaches_the_table_on_the_card(cuda):
    """``take_rows(...).sum().backward()`` on the card fills ``table.grad``
    through kernel 5' (wrapped negatives, out-of-range ids, duplicates), bit
    for bit the CPU route's."""
    V, D = 777, 50
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-V - 3, V + 3, (64, 50)).astype(np.int32))
    weights_out = torch.from_numpy(rng.standard_normal((64, 50, D)).astype(np.float32))
    t_card = table.to(cuda).requires_grad_(True)
    t_cpu = table.clone().requires_grad_(True)
    fwd, bwd = embedding_bag_sums.launches, embedding_bag_backward.launches
    (take_rows(t_card, ids.to(cuda)) * weights_out.to(cuda)).sum().backward()
    assert (embedding_bag_sums.launches, embedding_bag_backward.launches) == (fwd + 1, bwd + 1)
    (take_rows(t_cpu, ids) * weights_out).sum().backward()
    torch.cuda.synchronize()
    assert t_card.grad is not None and same_bits(t_card.grad.cpu(), t_cpu.grad)
    t2 = table.to(cuda).requires_grad_(True)
    take_rows(t2, ids.to(cuda)).sum().backward()
    assert bool((t2.grad != 0).any())


def test_embedding_bag_backward_refusals_on_the_card(cuda):
    table, idx, w = bag_case(50, 8, 16, 4, torch.float32, 0, cuda)
    with pytest.raises(NotImplementedError):
        embedding_bag_sums(table, idx, w.clone().requires_grad_(True)).sum().backward()
    with pytest.raises(TypeError, match="float32"):
        take_rows(table.to(torch.bfloat16).requires_grad_(True), idx).sum().backward()
    g = torch.ones(16, 8, device=cuda)
    before = embedding_bag_backward.launches
    with pytest.raises(TypeError):
        embedding_bag_backward(g, idx.long(), 50)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_backward(torch.ones(8, 16, device=cuda).T, idx, 50)
    with pytest.raises(ValueError):
        embedding_bag_backward(g, idx.cpu(), 50)
    assert embedding_bag_backward.launches == before


def test_sasrec_loss_gradients_on_the_card_match_the_cpu_route(cuda):
    """SASRec's smoke config: ``loss_fn``'s gradients on the card (three
    lookups, three kernel 5' launches) within 1e-5 of the CPU route's."""
    from repro_torch.launch import value_and_grad

    cfg = sasrec_config.smoke_config()
    params = sasrec.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {k: v for k, v in sasrec_config.smoke_batch(0, device="cpu").items()
             if k != "candidates"}
    before = embedding_bag_backward.launches
    l_card, g_card = value_and_grad(
        lambda p: sasrec.loss_fn(p, {k: v.to(cuda) for k, v in batch.items()}, cfg),
        sasrec.params_to(params, cuda))
    assert embedding_bag_backward.launches == before + 3
    l_cpu, g_cpu = value_and_grad(lambda p: sasrec.loss_fn(p, batch, cfg), params)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_card["item_emb"].cpu(), g_cpu["item_emb"], rtol=1e-5,
                               atol=1e-6)
    assert bool((g_card["item_emb"] != 0).any())


def test_sasrec_serving_on_the_card_matches_the_cpu_route(cuda):
    """SASRec's smoke config: one kernel launch a serve step, two a
    retrieval step, and the CPU route's scores and top-100."""
    cfg = sasrec_config.smoke_config()
    params = sasrec.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = sasrec_config.smoke_batch(0, device="cpu")
    on_card = sasrec.params_to(params, cuda)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    before = embedding_bag_sums.launches
    got = sasrec_serve_step(on_card, card_batch, cfg)
    assert embedding_bag_sums.launches == before + 1
    want = sasrec_serve_step(params, batch, cfg)
    torch.cuda.synchronize()
    assert_topk_agrees({k: v.cpu() for k, v in got.items()}, want,
                       sasrec.serve_scores(params, batch, cfg), 1e-5)
    before = embedding_bag_sums.launches
    got = sasrec_retrieval_step(on_card, card_batch, cfg)
    assert embedding_bag_sums.launches == before + 2
    torch.testing.assert_close(got.cpu(), sasrec_retrieval_step(params, batch, cfg),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        make_candidates(torch.Generator(), 1, 8, cfg.vocab, device=cuda)
    cand = make_candidates(torch.Generator(cuda).manual_seed(0), 1, 8, cfg.vocab)
    assert cand.device.type == "cuda"
