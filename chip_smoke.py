#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --lm-only      # phase 10 alone (kernel 6, the LM serving path)
    python3 chip_smoke.py --moe-only     # phase 10(a)-(b) and 16 (MoE, MLA, the other LMs)
    python3 chip_smoke.py --recsys-only  # phase 11 alone (kernel 5, SASRec serving)
    python3 chip_smoke.py --train-only   # phase 17 alone (kernel 5', training)
    python3 chip_smoke.py --dist-only    # phase 14(g) alone (two ranks on the card, gloo)
    python3 chip_smoke.py --gnn-only     # phase 18 alone (the GNN family trained)
    python3 chip_smoke.py --shard-train-only  # phase 20 alone (sharded training, two ranks)
    python3 chip_smoke.py --shard-serve-only  # phase 21 alone (serving on a process mesh)
    python3 chip_smoke.py --shard-gnn-only    # phase 22 alone (GNN training, two ranks)

Builds the hand-written CUDA kernels from this checkout (one ``nvcc`` per
source, all at once), holds each against its plain PyTorch version on the
card, and drives the port's paths: R-MAT -> compressed CSR -> edgeMap ->
BFS / wBFS / PageRank -> QueryEngine; the pull SpMV over graph A at full
width; calibration on the card, and the plan it measures; the graphFilter
packing under maximal matching and set cover at full width, and the
filter algorithms of Table 1 against the CPU route; qwen2-1.5B's serving
path (prefill, then decode through the single-token attention kernel);
SASRec's serving path (full-catalog top-100 and candidate retrieval, every
item lookup through the EmbeddingBag kernel); connectivity, personalized
PageRank and the ServingService tier; the rest of Table 1 (Bellman-Ford,
widest path, betweenness, spanning forest, spanner, biconnectivity) and
the unweighted compressed sum over kernel 2; sharded execution (the shard
split, the sharded executor, the round loop) on meshes of the one card;
mutable graphs (the delta overlay, compaction, checkpoints, the service's
edit path) and the observability layer (trace sessions, the round-loop
observer, the metric dump); mixture-of-experts and latent-attention serving
(deepseek-v2-lite-16b at full width and depth, dbrx-132b at full width) and
the other LM configurations through the single-token attention kernel;
training (AdamW, the fault-tolerant trainer with checkpoint and restart, the
LM and SASRec losses, the EmbeddingBag backward kernel); the GNN family
(GIN, PNA, DimeNet, Equiformer-v2) trained on its cells, with its
aggregation layer and neighbour sampler; batched edgeMap over feature-dim
vertex state; the graph engine across processes (two ranks on the one card,
one shard each, the combine on ``torch.distributed`` under gloo); the cell
registry (every cell's batch made on the card).

1. Device: the card (``nvidia-smi``), the torch and CUDA versions, and the
   kernels' build time.
2. Kernel 1 (``compressed_chunked_spmv``) against its plain version on the
   card, on graph B and on a small graph E with a few exceptions: both
   emits, one query and B=8, weighted and unweighted, with and without
   masks, chunks padded with ids >= NB.  Decode must match exactly, sums
   within rtol 1e-5 (the kernel adds a block's slots in a warp-tree order).
   Kernel 1's fused round (``compressed_stream_round``, one launch a
   ``sparse_streamed`` round of min over int32) against its plain version,
   the chunk loop over kernel 1's decode (the same map untagged), on graphs B
   and E: one query and B=8, BFS's identity and wBFS's saturating add, with
   and without ``edge_active``, and a full frontier; out and touched bit for
   bit.  Then one BFS round timed through each: the live set of today's
   kernel 1 shape (a frontier owning exactly 256 blocks) and a full
   frontier, the fused round's device ms and its bytes bound beside the
   chunk loop's device ms (its kernels' sum under ``torch.profiler``), host
   wall ms and kernel 1 launches, with the live blocks per tile of 8.
   Then kernels 2 (``compressed_block_spmv``) and 3 (``edge_block_spmv``)
   against theirs on graphs B and E: one query and B=8, weighted and
   unweighted, with and without ``edge_active``, tile_blocks 4/8/16, kernel
   3 with the owner arrays (real slots only) and without (whole rows); int32
   sums exactly, float32 within rtol 1e-5; each batched lane equal to its
   single run; the patched ops on graph E equal to the CPU route; the
   compressed and the uncompressed op equal on graph B for int32 x.  Then
   the device time of each kernel (kernel 3 both ways), of its plain
   version and of a one-call yardstick (cuSPARSE for the SpMVs) at graph
   B's shape, beside the bytes bound (kernel 3's counts the real slots).
3. Graph A, the full ``sage-graph`` configuration (n=2^20, m=2^24, weighted,
   F_B=128, seed 0): dense PageRank and direction-optimised BFS, checked on
   the card.  The graph is exception-dense, so ``sparse_streamed`` runs the
   plain ``sparse`` path and launches no kernel, as the JAX package does.
   Then ``spmv_vertex`` over graph A's CSR (kernel 3 at full width, real
   slots, no filter words), equal to ``compressed_spmv_vertex`` for int32 x,
   its host wall beside that of a call that builds the all-true filter
   first, and kernel 3's device time there, both ways.
4. Graph B (n=2^16, m=2^23, weighted, F_B=128, seed 0), which has no
   exceptions: BFS and wBFS on a ``sparse_streamed`` plan launch the fused
   round once a round (and kernel 1's decode never) and equal the CPU route
   exactly; PageRank with ``eps=0`` and a fixed iteration count agrees with
   the CPU route within atol 1e-6.  Then k-core on graph E under a
   ``sparse_streamed`` plan, whose int32 sums the fused round does not
   take: the chunk loop over kernel 1's decode (and the exception patch),
   equal to the CPU route.
4(b). Batched edgeMap over feature-dim vertex state: ``edgemap_reduce_batched``
   on (8, n, 16) state over graphs B and E, float32 under ``sum`` (a
   weighted map) and int32 under ``min`` (a weight added), in every mode,
   ``map_lanes`` on the even lanes, ``auto``'s sparse lanes streamed; lane
   0's frontier ~8 % of the vertices (``auto`` dense there), the others ~1 %.  Each lane
   equals its own single-query run on the card and the CPU route (graph E
   in every mode but ``dense``, whose body ``auto``'s lane 0 runs there;
   graph B's sparse lanes under ``sparse_streamed``): min and touched
   bit for bit, sums within twice float32's any-order bound (atomic adds on
   the card).  The
   streamed lanes decode through kernel 1 (the fused round takes no feature
   dims): decode launches > 0 under ``sparse_streamed`` and ``auto``, 0
   under ``dense`` and ``sparse``, no fused launch.
5. Serving: a ``QueryEngine`` on graph B answers 12 BFS and 4 wBFS queries,
   each equal to its single-query run, with at most one fused launch a
   round of each drained batch; one more drain runs under ``torch.profiler``
   for the device's busy share.
6. Calibration on the card: ``calibrate`` in full mode on the unweighted
   graph B workload; its tile sweep launches kernel 2.  The table is saved
   under ``build/``, reloaded and compared, and its tile decision printed
   beside the shipped ``default_table.json``'s.
7. The measured plan on graph B: BFS and wBFS equal the constants plan's;
   a ``QueryEngine`` sized by the table answers phase 5's requests, each
   equal to its single run; batched auto rounds with a flavor crossover on
   each side of the batch's density run both branches (one fused launch,
   then none), each lane equal to its single run.
9. The graphFilter path (kernel 4, ``filter_pack``): (a) the kernel against
   its plain version on the card, bits and counts exactly: F_B 32/64/128,
   NB=4099 (not a multiple of the warps per CTA), subsets all false, all
   true and random, keep masks all false and random, words with bit 31
   set, and the real filters of graphs A, B and E; (b) its device time, its
   plain version's and the bytes bound at graph A's and graph B's shapes,
   on inputs where the two were first held equal;
   (c) ``maximal_matching`` and ``set_cover`` (sets: ids < n/3) over graph
   A's CSR at full width, their invariants checked on the card, kernel 4
   launched once per round (and once more up front for set cover), and
   one more matching under ``torch.profiler`` for its device time by kernel;
   (d) the eight filter algorithms, ``pack_vertices`` with a partial
   subset and ``filter_edges`` on graph E, compressed and CSR, on the card
   equal to the CPU route exactly (the CPU route runs in a child process
   started before the graphs are built, so it overlaps phases 2-8);
   ``triangle_count`` on graph B.
10. The LM serving path (kernel 6, ``decode_attention``): (a) the kernel
   against its plain version on the card at the JAX sweep's shapes,
   qwen2-1.5B's (B, S, Hq, Hkv, D) = (8, 1000, 12, 2, 128), qwen1.5-4B's
   MHA (4, 777, 20, 20, 128), dbrx-132b's (4, 600, 48, 8, 128) and
   mistral-large-123b's (2, 333, 96, 8, 128), float32 and bfloat16, every sequence at
   length 1, 128 and S, and a mixed batch with a length on a split boundary
   and one past it: the relative L2 difference of each (sequence, head) row
   within ``ATTN_REL_TOL`` (1e-5 and 2^-7); (b) its device time, its plain
   version's and ``scaled_dot_product_attention``'s (a yardstick the port
   never calls) at B=32, S=pos=32,768, 12 q heads over 2 KV heads, D=128,
   bfloat16, first held to the plain version within the same limit, which
   three planted faults there exceed (one row short, a split's rows dropped,
   the wrong KV head), beside the bytes bound, with the kernel's
   configuration (body, copy mechanism, ring stages, warps and CTAs an SM,
   splits) and its row error beside the limit; (c) qwen2-1.5B's full
   configuration in bfloat16, random weights from seed 0 drawn on the card:
   8 prompts of 512 tokens, prefill into a 1,024-row cache, 64 greedy
   decode steps (kernel 6 launched 28 x 64 times), held teacher-forced to
   the plain route's logits, beside the logits of the three faults on the
   same tokens; (d) a batch of 32 over a 32,768-row cache
   filled in place from a seeded generator up to row 32,752 (a real prefill
   of 32 x 32k tokens would take minutes), 16 decode steps (28 x 16
   launches), the first held to the plain route (and the faults' read), and
   one more step under ``torch.profiler``.
11. SASRec serving (kernel 5, ``embedding_bag_sums``; (c) and (d) at the
   registry's ``sasrec`` cells, uncut): (a) the kernel
   against its plain version on the card at the JAX sweep's (V, D, B, L),
   kernels_micro's (4096, 64, 512, 16), D=50 and D=33, float32 and
   bfloat16, sum and mean, weighted and not, with ids -1, -7, V and V+3
   and a NaN weight on a padding slot: every bag sum bit for bit the plain
   version's (float32 within rtol 1e-5 and bfloat16 within one ulp
   checked first); bags of one exactly the rows, ``take_rows`` on the card
   exactly the CPU route's; the bags-of-one path (L = 1) at B = 1, 31, 33
   and 1000, float32 and bfloat16 rows of every load width, -0.0 and
   out-of-range ids planted, weighted and not, bit for bit; (b) its device
   time, its plain version's and a
   yardstick's (``F.embedding``, ``F.embedding_bag``) over the 2^20 x 50
   float32 catalog at retrieval's 1,000,448 bags of one and 65,536 bags of
   50 (train_batch's histories), beside the bytes bound; (c) ``serve_p99``:
   SASRec's full configuration, float32 (no TF32), random weights from
   seed 0 drawn on the card, 512 users of ``make_sasrec_batch_fn``: full
   catalog scores and the top 100, 5 timed calls (kernel 5 once each), the
   first 8 users' scores and top 100 held to the CPU route; (d)
   ``retrieval_cand``: user 0 against 1,000,448 candidates, 5 timed calls
   (kernel 5 twice each), held to the CPU route and to (c)'s full-catalog
   scores at the same items; one call of (c) and of (d) under
   ``torch.profiler``; (e) the item table unchanged (SHA-256).
12. Connectivity, PPR and the serving tier: (a) on graph B under a
   ``sparse_streamed`` plan, ``ldd`` (beta 0.2, the shift drawn on the card
   from a seeded generator) equal to the CPU route on the same shift bit for
   bit, one fused kernel 1 launch a round; ``connectivity`` equal to the CPU
   route and to scipy's weak components (min vertex id a component); (b)
   ``connectivity`` on graph A (exception-dense: no kernel launch) equal to
   scipy, and one dense label-propagation round under ``torch.profiler``;
   (c) 8 PPR queries (eps 1e-6, max_rounds 50) through a ``QueryEngine`` on
   graph B: their float sums take kernel 1's decode (the chunk loop); each
   result held to the CPU route and each lane to its single run: equal rounds
   and p, r within atol 1e-6, or both converged within the ACL bound of a
   scipy power iteration; (d) a ``ServingService`` on graph B: a virtual-time
   stream of 48 BFS, wBFS and PPR requests from two tenants, one under a
   budget (admission "defer"), and 16 more on a "reject" service, firing the
   deadline, depth and forced flushes, a defer, a reject, repacks and mixed
   cohorts; on the first 16 requests of the stream (a service of their own,
   on the card and on the CPU route), every ticket (status, finish time,
   rounds, words), ``stats``, ledgers and ``trace_counts`` equal to the CPU
   route's; every traversal result of the whole stream equal to its single
   run, the tickets' words summing to the read
   delta, at most one fused launch a cohort round, ``map_lanes`` bool (B,)
   on the card after every repack; then one flush under ``torch.profiler``.
13. The rest of Table 1 and of the core: (a) on graph B under the
   constants' ``sparse_streamed`` plan, Bellman-Ford, widest path and
   betweenness from 2 sources each (4 until phase 22 was added): their
   float maps and sums run the chunk loop over kernel 1's decode (launches
   > 0) and never the fused round (0); the first two equal the CPU route
   bit for bit, betweenness within
   1e-4 of the largest score; Bellman-Ford equals wBFS (integer weights, no
   negative cycle); (b) graph A (exception-dense, no kernel launch) from
   one source: Bellman-Ford equals wBFS, widest path passes a certificate
   checked on the card (every width the best bottleneck over the in-edges,
   -inf exactly where no path runs), betweenness within 1e-4 of the CPU
   route; (c) on graph B the spanning forest, biconnectivity and the
   spanner (k=4, its shift drawn on the card) equal the CPU route bit for
   bit, and ``multi_source_bfs`` from the forest's roots on the streamed
   plan launches one fused round a level; on graph A the forest's labels
   equal scipy's components and every parent is a neighbour, and
   biconnectivity labels exactly the real slots; (d)
   ``edgemap_sum_compressed`` (unweighted, on weighted graphs) on graph B
   with and without a GraphFilter and on graph E (exception rows patched),
   one kernel 2 launch a call, equal to its plain version (int32 exactly,
   float32 within rtol 1e-5); kernel 2 without weights timed beside its
   plain version, cuSPARSE with unit values and its bytes bound; (e)
   ``examples/graph_analytics_torch.py`` on the card.
14. Sharded execution on one card, every mesh ``cuda:0`` repeated: (a)
   ``CompressedCSR``, ``CSRGraph`` and ``GraphFilter`` ``.shard(k)`` of
   graphs B and E, k = 2, 3 (which does not divide NB) and 4, on the card
   equal the CPU route's bit for bit; graph E's k=4 shards carry padded
   exception lists; (b) on graphs B and E, meshes (2,) and (4,), a
   ``sparse_streamed`` BFS and wBFS equal the single-device card run bit
   for bit with k fused launches a round and no decode launch, and graph
   E's k-core (the chunk loop over kernel 1's decode on the padded shard
   exception lists) equals its single-device run; (c) graph A at full
   width on (4,): BFS bit for bit, PageRank (10 iterations, ``eps=0``)
   flat, hierarchical on (2, 2) and combined in bfloat16, each within its
   stated limit of the single-device card run, and one
   ``distributed_pagerank_step``; (d) a ``QueryEngine`` on a (4,) plan over
   graph B answers phase 5's requests, each equal to its single-device run,
   with exactly 4 fused launches a round and no decode launch; (e)
   ``set_cover`` on graph E under a (2,) plan equals one device, kernel 4
   launched once a round and once up front; (f) a ``pipeline_rounds=True``
   plan (the JAX package's skewed schedule, which the eager loop runs
   sequentially) gives BFS and wBFS on graph B (4,) bit for bit, 4 fused
   launches a round; graph A's shards join the SHA-256 check; the phase's
   peak device memory; (g) the engine across processes: the parent saves
   graphs B and E (``save_compacted`` under ``build/phase14g``) and spawns
   two ranks (``torch.multiprocessing``, gloo from a ``file://`` path there,
   both on the card); each loads them on the host and prepares a (2,)
   ``make_process_mesh`` plan, so only its own shard reaches the card (its
   bytes printed beside the graph's), then runs BFS and wBFS on graph B
   from phase 14(b)'s source and the next (exactly one fused launch a
   round a rank, no decode launch), k-core on graph E (decode launches, no
   fused one), PageRank on B (10 iterations, ``eps=0``, flat) and one
   ``distributed_pagerank_step``; a 2-rank NCCL group on the one card must
   raise the duplicate-device error (the store check, before any
   collective).  Every rank's results identical; BFS, wBFS and k-core bit
   for bit the parent's single-device card run, PageRank and the step within
   1e-5.  Printed: the wall per BFS round per rank and the combine's share
   (gloo stages CUDA tensors through the host: not an NCCL number), the
   bytes a rank sends a round, the in-process (2,) plan's round.  Then the
   serving tier on the process plan, in the same spawn: each rank's
   ``QueryEngine`` over the host graph B (phase 5's 12 BFS and 4 wBFS, then
   4 PPR), ``ServingService`` (phase 12(d)'s 48-request stream) and a
   mutable service over ``DeltaOverlay(graph E)`` (8 requests, 64 edits,
   one compaction persisted by rank 0 alone to one shared ``ckpt_dir``,
   reloaded by every rank equal to its own fold), against the same legs run
   meanwhile in the parent on one device (BFS and wBFS bit for bit, PPR by
   (c)'s rule, the checkpoint leaf for leaf) and on the in-process (2,)
   plan (tickets, ``stats``, ledgers, cache misses, PSAM account, read
   quantum); every rank against rank 0; only the rank's shard and its
   results on the card; at most one fused launch a cohort round, none of
   kernel 1's decode for BFS/wBFS.  Printed: each leg's rate a rank beside
   one device's and the in-process plan's, the combines' share and bytes,
   the flush digests' ms.  A rank that fails, or runs past 150 s, fails
   the run.
15. Mutable graphs and observability: (a) graph A (the full configuration)
   under a ``DeltaOverlay``: a 4,096-edit script from the seed (inserts of
   absent edges, deletes of present ones, re-inserts at the old and at a new
   weight, self-loops, deletes of absent edges), ``live_edges()`` equal to an
   independent numpy reference, 2 BFS and 2 wBFS (cut from 4 and 4 to make
   room for phases 4(b), 14(g) and 19) through the engine over the
   ``DeltaGraph`` and over ``compact(overlay)`` bit for bit equal (no kernel
   launch), PageRank (10 iterations) within atol 1e-6, the compaction's words
   the only large-memory write, the base unchanged (SHA-256); (b) a mutable
   ``ServingService`` over ``DeltaOverlay(compress(B))`` under a
   ``sparse_streamed`` plan: phase 12(d)'s 48 requests with 512 edits from
   two tenants, an ``OverlayTrigger`` that fires, a final ``force_compact``,
   checkpoints under ``build/phase15``: ``load_compacted`` equals the served
   base, BFS and wBFS equal a graph built from scratch from ``live_edges()``,
   kernel 1 launched 0 times over a ``DeltaGraph``; (c) the same kind of
   stream on graph E on the card and on the CPU route: tickets, ``stats``,
   ledgers, compactions and checkpoint arrays equal; (d) late in this
   process, ``trace_session`` over a ``sparse_streamed`` BFS and a service
   flush on graph B: one ``sage.round`` span a round, every fused launch a
   ``stream_round_kernel`` event or a launch the session counts as lost,
   ``sage_round_loop_rounds`` holding the BFS's rounds, the BFS under
   ``noop_registry()`` bit for bit equal, 8 more traced sessions' losses,
   the BFS's wall with a live registry and under ``noop_registry()`` in
   turns; the same traced session as a fresh process's first, with as many
   ``stream_round_kernel`` events as fused launches and none lost; ``python
   -m repro_torch.obs.dump`` in a subprocess on the card.
16. Mixture-of-experts and latent-attention serving, each model's weights
   drawn in bfloat16 from a fresh seeded generator on the card and freed
   before the next, with its peak device memory: (a) one MoE layer of
   deepseek-v2-lite (64 experts, top 6, d 2048, f 1408, 2 shared) and of
   dbrx (16 experts, top 4, d 6144, f 10752) at T = 8 and 4,096 tokens:
   ``moe_route``'s assignments equal to an independent loop's (each
   expert's first C assignments in t·K + k order), ``moe_ffn`` within
   relative L2 2e-2 a token of the loop's float32 result, the dropped
   assignments and the device ms beside the bound of the occupied experts;
   (b) deepseek-v2-lite-16b at full width and depth (27 layers, MLA, 26 MoE
   layers): 8 prompts of 512 tokens, prefill into 1,024 rows, 32 greedy
   steps through the MLA route (``gqa_attention`` over K and V
   materialised from the latent cache; kernel 6 launched 0 times), one
   step under ``torch.profiler``; at no-drop capacity (``capacity_factor =
   E / K``) a 2 x 64 prefill and 4 teacher-forced steps against ``forward``
   over the 68 tokens, and ``forward(collect_cache=True)``'s rows against
   the caches, within relative L2 0.1; (c) dbrx-132b at full width, 4 of
   its 40 layers: the same serving, kernel 6 launched 4 x 32 times, held
   teacher-forced to the plain route within 0.1; (d) qwen1.5-4b at full
   depth and mistral-large-123b at full width, 2 of its 88 layers: 16
   greedy steps each through kernel 6, held to the plain route the same way.
8. After phase 16, the graph tensors of A, B and E, compressed and CSR, and
   graph A's shards are unchanged (SHA-256 before and after every phase);
   then the graphs are freed.
17. Training on the card, float32 products full (TF32 off, stated), every
   time printed beside the card's name and power limit: (a) the EmbeddingBag
   backward (kernel 5', ``embedding_bag_backward``) against its plain
   version bit for bit (its record's ``max_abs_err`` the largest difference
   of (a) and (b), measured): bags of one, L > 1 with weights, ids -1, -7, V and
   V+3, duplicates, a hot row holding half the ids, D from 1 to 200 (49, 51
   and 64 among them), rows of exactly a chunk and one slot more, a row of
   768 chunks, each called twice; its preparation (``embedding_bag_plan``,
   the port's radix sort) against ``backward_plan`` bit for bit (``row_start``,
   ``chunk_base``, ``order[:row_start[V]]``) at V = 1 and on each side of
   2^10 and 2^20, all slots padding, every slot one id, planted ids, L > 1;
   ``take_rows`` under ``backward()`` on the card against the CPU route bit
   for bit; (b) at train_batch's lookup (3,276,800 ids into a 2^20 x 50
   float32 table) with the hot padding row and with uniform ids, the
   preparation held to ``backward_plan`` bit for bit and the kernel to its
   plain version, then device ms of the preparation, of the sums alone
   (``backward_sums``), of the whole call, of the plain versions
   (``backward_plan``, the whole plain backward) and of two yardsticks the
   port never calls (``aten.embedding_dense_backward``, sort-based;
   ``zeros.index_add_``, atomic), which the whole call must beat, beside the
   bytes bound and the share of it; (c) SASRec's train_batch at
   its registry cell's full size (65,536 users x 50, the 2^20-item catalog, d 50, float32,
   ``make_sasrec_batch_fn``): the first step's gradient non-zero on every
   ``item_emb`` row the batch touches and exactly 0 on every other, the loss
   and gradients at 1,024 users within 1e-5 of the CPU route; ``Trainer``, 6
   steps with a checkpoint every 3, against a run that fails at step 4 and
   resumes: parameters and AdamW state bit for bit, kernel 5, 5' and its
   preparation launched 3 times a step; ms a step (median of the steps after the first that write
   no checkpoint), users/s, peak memory; (d) qwen2-1.5B whole (28
   layers, bf16, remat full): the registry's train_4k cell's 4,096-token
   sequences, its global batch cut from 256 to 8 (printed against the
   cell's), accumulated over 8 microbatches, 2 steps (cut from 4 to make
   room for phases 21 and 22); the
   first loss within 0.05 of ln V + sigma^2 / 2 (``first_loss_reckoned``),
   every loss finite; ms a step, tokens/s, model flops over the dense bf16
   peak, peak memory beside the reckoning; cut to 2 layers at full width,
   one ``train_step`` against the CPU route (loss, grad norm, parameters
   after the update, stated tolerances) and a bf16 restart bit for bit; (e)
   deepseek-v2-lite-16b cut to its dense layer and one MoE layer at full
   width, 4 steps of 2 x 4,096 tokens: finite losses, the router and every
   expert tensor moved, ms a step (median of steps 2-4), peak memory.
18. The GNN family trained on the card, float32 (TF32 off), no hand kernel on
   the path: (a) the aggregation primitives (``scatter_sum/mean/max/min/std``,
   ``segment_softmax``, ``gather_src``) on 440,000 edges into 50,000 nodes x
   64 with empty segments, the sentinel, ids out of range and duplicate
   edges, value and gradient against the CPU route: max and min bit for
   bit, the rest within 1e-5 of the largest value; (b) GIN, PNA, DimeNet
   and Equiformer-v2 at their full configs on the molecule cell (128
   molecules of 30 atoms and 64 bonds, 262,144 DimeNet triplet slots): each
   cut to 2 layers on 16 molecules, one loss and gradient against the CPU
   route (every leaf within relative L2 1e-4 beside 1e-6 of the whole
   norm), then 4 ``Trainer`` steps at full depth: ms a step (median of
   steps 2-4), graphs/s, model flops a second, peak memory, every loss and
   grad norm finite; (c) the same four at full_graph_sm (2,720 x 1,433, 10,752
   edges, 7 classes); (d) GIN at ogb_products, full batch (2,449,056 x 100,
   61,859,328 edges made on the card), 4 steps and one under
   ``torch.profiler`` (the scatter's and the gathers' share of the device
   time); (e) PNA at minibatch_lg: a 232,965-vertex, 114,615,892-edge CSR
   built on the host, 1,024 seeds a step through ``sample_fanout`` (15, 10),
   the sampler's host seconds beside the step's ms.  Every cell comes from
   the registry (``configs.get_arch(arch).cells()[shape]``).
19. The cell registry: ``configs.all_cells()``, the 40 (arch, shape) cells,
   each cell's ``batch_specs`` made on the card from a seeded generator, one
   cell at a time and freed: shapes and dtypes checked, ids in range
   (tokens and items below the vocabulary, positions below the sequence,
   node ids below the nodes, edge ids below the edges, labels below the
   classes); each cell's kind, family, batch bytes and model flops printed.
20. Sharded training on a process mesh: two gloo ranks on the card train
   SASRec's train_batch on (1, 2) and (2, 1) meshes (restart, elastic
   restore), qwen2-1.5B cut to 2 layers on (2, 1) (d) and on (1, 2) (f)
   computing on its blocks (FSDP one layer at a time over ``data``;
   heads, ff and vocab over ``model``), and run ``compressed_psum``, held
   to this process's one-device runs.  The LM legs print ms a step, each
   kind of collective's calls, bytes and ms a step (each side
   synchronised) and the peak a rank beside the one-device run's; they
   fail on a ``gather_tree`` call, a count of collectives off its
   reckoning from layers x microbatches, ranks whose gathered trees differ
   by a bit, a loss or gradient norm off the one-device run's, or a peak
   not below one device's.
21. Serving on a process mesh: (a) in this process, every case of phase
   10(a)'s kernel-6 sweep with its cache cut into 2 and 4 row ranges (some
   empty at short lengths), kernel 6 with ``return_lse=True`` on each range
   and the partials merged, within ``ATTN_REL_TOL`` of the whole-cache
   kernel and of the plain version, each lse within 1e-5 of the plain
   version's, empty ranges exactly 0 and -inf, the output rounded bit for
   bit the call without lse; one rank's half of qwen2-1.5B's 32 x 32,768
   cache timed both ways beside the bytes bound.  Then the one-device
   references, freed, and one spawn of two gloo ranks on the card: (b)
   qwen2-1.5B at full width and depth on (1, 2): 8 x 1,024 prompts prefilled
   under ``LM_PREFILL_RULES`` into 32,768 positions (a rank keeps 16,384),
   16 decode steps under ``LM_DECODE_RULES`` on the one-device run's tokens,
   the parameters gathered once at load; (c) its long_500k cell uncut on
   (2, 1) under ``LM_DECODE_LONG_RULES``: batch 1, 524,288 positions filled
   from the seed by blocks of rows (a rank fills its slice alone), 8 steps
   at the end; (d) deepseek-v2-lite-16b (MLA) cut to 2 layers on (1, 2), 8 x
   1,024 prompts into 2,048 positions, 8 steps; (e) SASRec's serve_p99 and
   retrieval_cand uncut on (1, 2) and (2, 1).  Held: logits within
   ``LOGITS_REL_TOL`` of one device, (b)'s prefill slices bit for bit the
   one-device rows, kernel 6's rows (lse, merged across the ranks) within
   ``ATTN_REL_TOL`` of the plain version over the gathered layer, the
   sharded lookups bit for bit ``take_rows``, scores within 1e-5, the top
   100 through ``assert_topk_agrees``, the item table unwritten.  Printed:
   ms a step a rank beside one device's, the collectives' ms and share
   (each side synchronised), bytes a rank sends a step, peak memory,
   launches of kernels 5 and 6 a rank.
22. GNN training on a process mesh, no hand kernel on the path: the
   one-device references first (phase 18's parameters and batches, saved,
   freed), then one spawn of two gloo ranks on the card, the edge lists
   (DimeNet's triplets) split over both under ``GNN_RULES`` and the node
   state whole on each: (a) phase 18(a)'s aggregation with its +10 %
   duplicates copied from the first half to the end (ties that straddle the
   ranks): max, min and degrees bit for bit one device's, the max / min
   gradients within 1e-6 (ties split by the global count), the rest within
   1e-5 of the largest; (b) GIN, PNA, DimeNet and Equiformer-v2 at full
   width and depth on the molecule cell and (c) on full_graph_sm, uncut, on
   (2, 1); (d) PNA at minibatch_lg on the sampler's batches; (e) GIN and
   DimeNet at molecule on (1, 2); each run step 1's loss within 1e-5 and
   every gradient leaf within relative L2 1e-4 of one device's (or 4x one
   device's own spread where wider), 3 ``Trainer`` steps (phase 18's 4 cut)
   after which the parameters hold phase 20(b)'s rule and the two ranks'
   are bit for bit; (f) GIN molecule on (2, 1)
   checkpointed at step 2, restored bit for bit and resumed, its losses
   within 1e-5 of one device's.  Printed: ms a step a rank beside one
   device's, the combines' and the gradient all-reduces' ms and share (each
   side synchronised), bytes a rank sends a step, peak memory, real edges or
   triplets a rank.

No timed call, kernel or library yardstick of the same function, may read
under its bound by more than 5 % (a bound it beats is a wrong bound).
Each path resets the launch counts just before it and reads them just after:
phases 4-5 (4(b) among them), 12, 13, 14 and 15 for kernel 1's two entries (14(g)'s
ranks count their own launches and report them), graph A's ``spmv_vertex`` for kernel 3,
phases 6 and 13(d) for kernel 2, phases 9(c) and 14(e) for kernel 4, phases 10(c), (d) and
16(b)-(d) for kernel 6, phase 11(c) and (d) and 17(c) for kernel 5, phase 17(c) for kernel 5'
and its preparation; phases 20 and 21's ranks count their own and report them.
Any failed check raises and the run exits non-zero.  Without a CUDA device,
or outside a checkout of the repository, the script exits with code 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import json
import math
import os
import pathlib
import shutil
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
CHUNK = 256                    # DEFAULT_CHUNK_BLOCKS: ids per launch of the chunk loop
ROUND_TILE = 8                 # kRoundTile of compressed_spmv.cu: blocks a warp of the fused round
BATCH = 8
TILES = (4, 8, 16)             # calibration's tile grid: blocks (warps) per CTA
TILE = 8                       # DEFAULT_TILE_BLOCKS: the timed launch shape
SUM_RTOL = 1e-5    # float sums: warp-tree order against a sequential sum
SUM_ATOL = 1e-6    # the same, for blocks whose sum is near 0
BOUND_SLACK = 0.05  # no timed call may read under its bound by more than this share
PR_SUM_TOL = 1e-4  # PageRank mass, float32 over 2^20 scores
PR_ATOL = 1e-6     # PageRank on B against the CPU route: scores ~1.5e-5, other sum order
PR_ITERS = 10
LDD_BETA = 0.2     # phase 12: connectivity's ldd
PPR_SOURCES = 8    # phase 12(c): PPR queries batched through the engine
PPR_EPS = 1e-6
PPR_ROUNDS = 50
# phase 12(d): the service's PPR lanes stop at their cap, 3 rounds short of
# converging at this eps, so no float-order flip changes the words they cost
SERVICE_PPR = {"eps": 1e-7, "max_rounds": 3}
SERVICE_REQUESTS = 48
SERVICE_HELD = 16  # phase 12(d): requests of a stream the CPU route serves again
T1_SOURCES = 2     # phase 13(a): sources of each float-monoid traversal on graph B (4 until
#                    phase 22 was added: the run's wall)
BC_REL_TOL = 1e-4  # betweenness: max|Δ| / max|ref|, float sums in another order
SPANNER_K = 4
TABLE_PATH = ROOT / "build" / "chip_smoke_table.json"
KERNEL_SOURCES = {
    "compressed": "src/repro_torch/kernels/compressed_spmv/csrc/compressed_spmv.cu",
    "edge": "src/repro_torch/kernels/edge_block_spmv/csrc/edge_block_spmv.cu",
    "filter": "src/repro_torch/kernels/filter_pack/csrc/filter_pack.cu",
    "attention": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "embedding_bag": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
    "bag_plan": "src/repro_torch/kernels/embedding_bag/csrc/bag_plan.cu",
}
F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12    # H100 SXM bf16 tensor cores, dense: kernel 6's products at bf16
ATTN_SHAPES = [        # (B, S, Hq, Hkv, D): the JAX sweep, qwen2-1.5B, qwen1.5-4B's MHA,
    (2, 64, 4, 4, 8), (6, 300, 8, 2, 16), (3, 128, 6, 1, 32), (8, 1000, 12, 2, 128),
    (4, 777, 20, 20, 128),
    (4, 600, 48, 8, 128), (2, 333, 96, 8, 128),   # dbrx-132b's and mistral-large-123b's
]
ATTN_TIMED = (32, 32768, 12, 2, 128)   # qwen2-1.5B heads at the long-context shape
LM_SERVE = (8, 512, 1024, 64)   # batch, prompt tokens, max_seq, greedy decode steps
LM_LONG = (32, 32768, 16)       # batch (128 in decode_32k, over 80 GB), max_seq, steps
BAG_SHAPES = [         # (V, D, B, L): the JAX sweep, kernels_micro's, SASRec's width, D=33
    (50, 8, 16, 4), (100, 16, 37, 5), (200, 32, 64, 9), (4096, 64, 512, 16),
    (3000, 50, 1000, 50), (500, 33, 77, 3),
]
BAG_ONE_B = (1, 31, 33, 1000)    # bags of one: a warp's 32, one short, one over, many
BAG_ONE_ROWS = [                 # (dtype, D): row loads of 16, 8, 4 and 2 B
    ("float32", 64), ("float32", 50), ("float32", 33),
    ("bfloat16", 64), ("bfloat16", 50), ("bfloat16", 33),
]
BAG_TIMED = {          # SASRec's catalog: retrieval's candidates, train_batch's histories
    "retrieval": (1 << 20, 50, 1_000_448, 1),
    "history": (1 << 20, 50, 65_536, 50),
}
RECSYS_CALLS = 5       # timed calls of each SASRec serving step
CHECK_USERS = 8        # serve_p99 users held to the CPU route
# SASRec scores, the card against the CPU route: float32 through two blocks
# and a K=50 product, summed in other orders (full float32: no TF32)
SCORE_TOL = 1e-5
# qwen2-1.5B logits, kernel route against the plain route, teacher-forced: the
# norm of the difference over the norm of the plain logits, per sequence and
# step (the max abs difference is printed beside it).  Phase 10 reads the
# planted faults of `attention_faults` beside it.  On an H100 at 28 layers the
# kernel route reads 0.031 (c) and 0.037 (d); the faults 0.26-1.19 (c), and
# 0.42-1.15 (d) but for one row short of 32,752 (0.047), which the row limit
# of (a) and (b) rejects instead.  0.1 lies between them.
LOGITS_REL_TOL = 0.1


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


def graph_digest(*graphs) -> dict:
    """SHA-256 of every tensor field of the graphs, read back to the host."""
    import torch

    out = {}
    for i, g in enumerate(graphs):
        for f in dataclasses.fields(g):
            v = getattr(g, f.name)
            if isinstance(v, torch.Tensor):
                out[(i, f.name)] = hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
    return out


@dataclasses.dataclass
class Graph:
    """One R-MAT graph: compressed on the host and on the card, and its
    blocked CSR on the card and on the host."""

    host: object
    dev: object
    csr: object
    host_csr: object
    seconds: float


def build_graph(n, m, device) -> Graph:
    """The weighted R-MAT graph, built and compressed on the host, then moved
    to the card with its CSR."""
    from repro_torch.core import compress, from_reference_arrays, to_reference_arrays
    from repro_torch.data import rmat_graph

    t0 = time.perf_counter()
    csr = rmat_graph(n, m, weighted=True, seed=SEED, block_size=BLOCK, device="cpu")
    host = compress(csr)
    dev = from_reference_arrays(*to_reference_arrays(host), device)
    csr_dev = from_reference_arrays(*to_reference_arrays(csr), device)
    return Graph(host, dev, csr_dev, csr, time.perf_counter() - t0)


def sources(g, k, seed):
    """``k`` distinct vertices of positive degree, drawn from ``seed``."""
    import numpy as np

    deg = g.degrees.cpu().numpy()
    return [int(v) for v in np.random.default_rng(seed).choice(np.flatnonzero(deg), k,
                                                               replace=False)]


def sums_err(got, want, exact, what):
    """Check kernel sums against the plain version's; returns max abs error."""
    import torch

    torch.cuda.synchronize()
    if exact:
        check(torch.equal(got, want), f"{what}: int32 sums differ")
        return 0.0
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL, msg=what)
    return float((got.double() - want.double()).abs().max())


def check_bound(what, t):
    """No timed call reads under its bound by more than ``BOUND_SLACK``: not
    the kernel, and not a library call that computes the same function
    (``library_ms``).  A reading under the bound means the bound is wrong."""
    for key in ("ms", "library_ms"):
        ms = t.get(key)
        check(ms is None or ms >= (1 - BOUND_SLACK) * t["bound_ms"],
              f"{what}: {key} {ms!r} reads under the bound {t['bound_ms']!r} ms")
    return t


# ----------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ----------------------------------------------------------------------
def chunk_ids(g, rng, live, pad):
    """A sorted chunk of ``live`` distinct block ids, then ``pad`` ids >= NB."""
    import numpy as np
    import torch

    NB = g.num_blocks
    ids = np.sort(rng.choice(NB, live, replace=False))
    ids = np.concatenate([ids, NB + np.arange(pad)]).astype(np.int32)
    return torch.from_numpy(ids).to(g.device)


def test_inputs(g, rng):
    """Packed random ``edge_active`` words and the x cases, on the card."""
    import torch

    n, NB, FB = g.n, g.num_blocks, g.block_size
    gen = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 31)))
    active = torch.randint(-2**31, 2**31, (NB, FB // 32), dtype=torch.int32,
                           generator=gen).to(g.device)
    xs = {
        "x f32 (n,)": torch.rand(n, generator=gen).to(g.device),
        f"x f32 ({BATCH}, n)": torch.rand(BATCH, n, generator=gen).to(g.device),
        "x i32 (n,)": torch.randint(-9, 10, (n,), dtype=torch.int32,
                                    generator=gen).to(g.device),
        f"x i32 ({BATCH}, n)": torch.randint(-9, 10, (BATCH, n), dtype=torch.int32,
                                            generator=gen).to(g.device),
    }
    return active, xs


def compare_chunked_kernel(g, rng, stats):
    """Every case of ``compressed_chunked_spmv`` against the plain version on
    the same device tensors.  Returns the largest absolute difference."""
    import torch

    from repro_torch.core import make_filter
    from repro_torch.kernels import compressed_chunked_spmv, compressed_chunked_spmv_ref

    n = g.n
    ids = chunk_ids(g, rng, CHUNK - 16, 16)
    active, xs = test_inputs(g, rng)
    masks = {"none": (None, None), "active": (None, active),
             "bits+active": (make_filter(g).bits, active)}
    err = 0.0
    for weights in (g.block_weights, None):
        for mname, (bits, act) in masks.items():
            args = (ids, g.block_first, g.deltas, g.valid_count, bits, act, weights)
            got = compressed_chunked_spmv(None, *args, n=n, emit="decode")
            want = compressed_chunked_spmv_ref(None, *args, n=n, emit="decode")
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"decode differs (weighted={weights is not None}, masks={mname})")
            stats["chunked"] += 1
            for xname, x in xs.items():
                got = compressed_chunked_spmv(x, *args, n=n, emit="sums")
                want = compressed_chunked_spmv_ref(x, *args, n=n, emit="sums")
                exact = x.dtype == torch.int32 and weights is None
                err = max(err, sums_err(got, want, exact, f"chunked sums {xname} {mname}"))
                stats["chunked"] += 1
    return err


def compare_whole_graph_kernels(G, rng, stats):
    """Kernels 2 and 3 against their plain versions over every block of one
    graph, for every tile in TILES; kernel 3 with the owner arrays (real
    slots only) and without (whole rows); each batched lane against its
    single run.  Returns the largest absolute differences (kernel 2,
    kernel 3)."""
    import functools

    import torch

    from repro_torch.core import make_filter
    from repro_torch.kernels import (
        compressed_block_spmv,
        compressed_block_spmv_ref,
        edge_block_spmv,
        edge_block_spmv_ref,
    )

    c, csr = G.dev, G.csr
    n = c.n
    active, xs = test_inputs(c, rng)
    bits = make_filter(c).bits
    err = {2: 0.0, 3: 0.0}

    def against_plain(k, kernel, plain, x, args, what):
        exact = x.dtype == torch.int32
        want = plain(x, *args, n=n)
        for tb in TILES:
            got = kernel(x, *args, n=n, tile_blocks=tb)
            err[k] = max(err[k], sums_err(got, want, exact, f"{what} TB={tb}"))
            stats[f"kernel {k}"] += 1
        for q in range(x.shape[0] if x.dim() == 2 else 0):
            single = kernel(x[q].contiguous(), *args, n=n)
            err[k] = max(err[k], sums_err(got[:, q].contiguous(), single, exact,
                                          f"{what} lane {q} against its single run"))

    for act in (None, active):
        for xname, x in xs.items():
            for weights in (c.block_weights, None):
                against_plain(2, compressed_block_spmv, compressed_block_spmv_ref, x,
                              (c.block_first, c.deltas, c.valid_count, bits, act, weights),
                              f"kernel 2 {xname} weighted={weights is not None} "
                              f"active={act is not None}")
            for owners in (None, (csr.block_src, csr.block_offsets, csr.degrees)):
                against_plain(3, functools.partial(edge_block_spmv, owners=owners),
                              edge_block_spmv_ref, x, (csr.block_dst, csr.block_w, bits, act),
                              f"kernel 3 {xname} active={act is not None} "
                              f"owners={owners is not None}")
    return err[2], err[3]


def compare_patched_paths(G, rng):
    """The exception-patching wrappers on the card against the CPU route."""
    import torch

    from repro_torch.kernels import (
        compressed_chunked_stream_tile,
        compressed_spmv_vertex,
        compressed_spmv_vertex_batched,
        compressed_spmv_vertex_chunked,
    )

    h, g = G.host, G.dev
    ids = chunk_ids(h, rng, CHUNK - 16, 16)
    got = compressed_chunked_stream_tile(g, ids.to(g.device))
    want = compressed_chunked_stream_tile(h, ids)
    check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
          "compressed_chunked_stream_tile differs from the CPU route")
    frontier = torch.from_numpy(rng.random(h.n) < 0.02)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(h.n, generator=gen)
    got = compressed_spmv_vertex_chunked(g, x.to(g.device), frontier.to(g.device))
    want = compressed_spmv_vertex_chunked(h, x, frontier)
    err = sums_err(got.cpu(), want, False, "compressed_spmv_vertex_chunked")
    for x in (torch.rand(h.n, generator=gen), torch.rand(BATCH, h.n, generator=gen),
              torch.randint(-9, 10, (h.n,), dtype=torch.int32, generator=gen),
              torch.randint(-9, 10, (BATCH, h.n), dtype=torch.int32, generator=gen)):
        fn = compressed_spmv_vertex_batched if x.dim() == 2 else compressed_spmv_vertex
        got = fn(g, x.to(g.device))
        err = max(err, sums_err(got.cpu(), fn(h, x), x.dtype == torch.int32,
                                f"{fn.__name__} on graph E"))
    return err


def cross_check_backends(G, rng):
    """``compressed_spmv_vertex`` and ``spmv_vertex`` over the same edges in
    the same blocks: equal for int32 x."""
    import torch

    from repro_torch.kernels import compressed_spmv_vertex, spmv_vertex

    gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
    x = torch.randint(-9, 10, (G.dev.n,), dtype=torch.int32, generator=gen).to(G.dev.device)
    a, b = compressed_spmv_vertex(G.dev, x), spmv_vertex(G.csr, x)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "compressed_spmv_vertex != spmv_vertex for int32 x")


def time_chunked_kernel(g, rng):
    """Device ms of kernel 1, its plain version and a one-call yardstick at
    the main-path shape (one chunk of CHUNK live ids, F_B=128, weighted,
    decode), and the bytes-bound ms for the same inputs."""
    import torch

    from repro_torch.kernels import compressed_chunked_spmv, compressed_chunked_spmv_ref
    from repro_torch.tuning import HBM_BYTES_PER_S

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
    vc = (g.valid_count[ids.long()].to(torch.int64) & 0xFFFF)
    read = 4 * C + int(C * (4 + 2 + 4 * FB) + 2 * vc.sum())  # ids; first, count, w; deltas
    write = C * FB * (4 + 4)                                 # dst, w
    bound_ms = (read + write) / HBM_BYTES_PER_S * 1e3
    return check_bound("kernel 1", dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                        yardstick_ms=yardstick_ms, bound_ms=bound_ms,
                                        bytes=read + write))


def untagged(map_fn):
    """``map_fn`` without its ``kernel_map`` tag: edgeMap then runs the chunk
    loop, the fused round's plain version, on the card."""
    def plain(xs, w):
        return map_fn(xs, w)

    return plain


def round_maps():
    from repro_torch.algorithms.traversal import _relax
    from repro_torch.core.edgemap import _identity_map

    return {"identity": _identity_map, "sat_add_i32": _relax}


def run_round(g, frontier, x, map_fn, edge_active=None):
    """One sparse_streamed edgeMap round of min, one query or a batch."""
    from repro_torch.core import edgemap_chunked, edgemap_chunked_batched_streamed

    if frontier.dim() == 1:
        return edgemap_chunked(g, frontier, x, monoid="min", map_fn=map_fn,
                               edge_active=edge_active, streamed=True)
    return edgemap_chunked_batched_streamed(g, frontier, x, monoid="min", map_fn=map_fn,
                                            edge_active=edge_active)


def round_state(g, rng, B):
    """A frontier (2 % of the vertices and the 8 highest-degree ones) and
    int32 state with values at and near wBFS's saturation point, (n,) or
    (B, n), on the card."""
    import numpy as np
    import torch

    n, rows = g.n, 1 if B is None else B
    frontier = rng.random((rows, n)) < 0.02
    frontier[:, np.argsort(g.degrees.cpu().numpy())[-8:]] = True
    x = rng.integers(0, 1 << 20, (rows, n)).astype(np.int32)
    x[rng.random((rows, n)) < 0.05] = 2**31 - 1
    x[rng.random((rows, n)) < 0.05] = 2**31 - 1 - (1 << 24)
    f, xx = (torch.from_numpy(a).to(g.device) for a in (frontier, x))
    return (f[0], xx[0]) if B is None else (f, xx)


def compare_stream_round(g, rng, stats):
    """The fused round (one ``compressed_stream_round`` launch) against its
    plain version, the chunk loop over kernel 1's decode, on the same card
    tensors: one query and B=BATCH, both maps, with and without
    ``edge_active``, and a full frontier; out and touched bit for bit."""
    import torch

    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round

    active = torch.from_numpy(rng.random(g.num_blocks * g.block_size) < 0.7).to(g.device)
    cases = [(B, round_state(g, rng, B)) for B in (None, BATCH)]
    full = torch.ones(g.n, dtype=torch.bool, device=g.device)
    cases.append(("full", (full, torch.arange(g.n, dtype=torch.int32, device=g.device))))
    for B, (frontier, x) in cases:
        for name, map_fn in round_maps().items():
            for act in (None, active):
                before = (compressed_stream_round.launches, compressed_chunked_spmv.launches)
                got = run_round(g, frontier, x, map_fn, act)
                check(compressed_stream_round.launches == before[0] + 1
                      and compressed_chunked_spmv.launches == before[1],
                      f"fused round {name} B={B}: not one fused launch")
                want = run_round(g, frontier, x, untagged(map_fn), act)
                check(compressed_chunked_spmv.launches > before[1],
                      f"fused round {name} B={B}: the plain route launched no kernel 1")
                torch.cuda.synchronize()
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"fused round n={g.n} map={name} B={B} active={act is not None} "
                      "differs from the chunk loop")
                stats["fused round"] += 1
    return 0.0  # every case is held to exact equality


def frontier_of_blocks(g, rng, blocks):
    """A frontier whose owned blocks number exactly ``blocks``: random
    vertices, each taken while its blocks still fit."""
    import numpy as np
    import torch

    per_vertex = np.bincount(g.block_src.cpu().numpy(), minlength=g.n + 1)[: g.n]
    frontier = np.zeros(g.n, bool)
    total = 0
    for v in rng.permutation(np.flatnonzero(per_vertex)):
        if total + per_vertex[v] <= blocks:
            frontier[v] = True
            total += per_vertex[v]
        if total == blocks:
            break
    check(total == blocks, f"no frontier owns exactly {blocks} blocks")
    return torch.from_numpy(frontier).to(g.device)


def round_bytes(g, frontier, map_kind, edge_active=False):
    """Bytes a fused round must move: each block's owner and the frontier
    once (liveness), the live blocks' header, the deltas, weights (the
    saturating add only) and traversal words of their valid slots, the
    owners' x once a query, and out and touched written once."""
    import torch

    fr = frontier if frontier.dim() == 2 else frontier[None]
    B, n, NB = fr.shape[0], g.n, g.num_blocks
    src = g.block_src.long()
    live = fr[:, src].any(dim=0)
    vc = (g.valid_count.to(torch.int64) & 0xFFFF)[live]
    slots = int(vc.sum())
    words = int(((vc + 31) // 32).sum()) if edge_active else 0
    weights = 4 * slots if map_kind == "sat_add_i32" and g.weighted else 0
    owners = torch.zeros(n, dtype=torch.bool, device=g.device)
    owners[src] = True
    x_read = 4 * int((fr & owners[None]).sum())
    live_bytes = int(live.sum()) * (4 + 2) + 2 * slots + weights + 4 * words
    return NB * 4 + B * n + live_bytes + x_read + B * n * (4 + 1)


def tile_occupancy(g, frontier):
    """Live blocks per tile of the fused round (ROUND_TILE blocks), over the
    tiles with any: (tiles with one, median, max, tiles with any)."""
    import torch

    live = frontier[g.block_src.long()]
    NB = g.num_blocks
    pad = torch.zeros(-NB % ROUND_TILE, dtype=torch.bool, device=g.device)
    per_tile = torch.cat([live, pad]).reshape(-1, ROUND_TILE).sum(dim=1)
    busy = per_tile[per_tile > 0]
    if busy.numel() == 0:
        return 0, 0, 0, 0
    return (int((busy == 1).sum()), int(busy.median()), int(busy.max()), int(busy.numel()))


def time_stream_round(g, frontier, what):
    """Device ms of one BFS round (identity map, x = ids, one query) through
    the fused kernel, beside the chunk loop's device ms (the sum of its
    kernels under torch.profiler), host wall ms and kernel 1 launches, and
    the fused round's bytes bound; the two first held equal."""
    import torch

    from repro_torch.core.edgemap import _identity_map
    from repro_torch.kernels import compressed_chunked_spmv
    from repro_torch.tuning import HBM_BYTES_PER_S

    x = torch.arange(g.n, dtype=torch.int32, device=g.device)
    plain = untagged(_identity_map)
    got, want = run_round(g, frontier, x, _identity_map), run_round(g, frontier, x, plain)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what}: the fused round differs from the chunk loop")

    def wall_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - ts) * 1e3)
        return statistics.median(times)

    before = compressed_chunked_spmv.launches
    run_round(g, frontier, x, plain)
    chunks = compressed_chunked_spmv.launches - before
    _, plain_busy, plain_kernels, _ = profile_run(lambda: run_round(g, frontier, x, plain))
    _, fused_busy, fused_kernels, _ = profile_run(lambda: run_round(g, frontier, x,
                                                                    _identity_map))
    nbytes = round_bytes(g, frontier, "identity")
    return check_bound(what, dict(
        ms=device_ms(lambda: run_round(g, frontier, x, _identity_map)),
        plain_ms=plain_busy,
        library_ms=None,   # no one PyTorch call runs an edgeMap round
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bytes=nbytes,
        wall_ms=wall_ms(lambda: run_round(g, frontier, x, _identity_map)),
        plain_wall_ms=wall_ms(lambda: run_round(g, frontier, x, plain)),
        fused_profiled_ms=fused_busy,
        fused_kernels=fused_kernels,
        plain_kernels=plain_kernels,
        chunk_launches=chunks,
        live_blocks=int(frontier[g.block_src.long()].sum()),
        tiles=tile_occupancy(g, frontier),
    ))


def log_round_time(tag, what, t):
    one, med, mx, busy = t["tiles"]
    log(f"[{tag}] fused round, {what} ({t['live_blocks']} live blocks; of {busy} tiles with "
        f"any, {one} hold one, median {med}, max {mx}): device {t['ms']!r} ms "
        f"({t['fused_kernels']} kernels, profiled {t['fused_profiled_ms']!r} ms), host wall "
        f"{t['wall_ms']!r} ms; the chunk loop: {t['chunk_launches']} kernel 1 launches, "
        f"{t['plain_kernels']} kernels, device {t['plain_ms']!r} ms, host wall "
        f"{t['plain_wall_ms']!r} ms; bound {t['bound_ms']!r} ms ({t['bytes']} B at "
        f"3.35 TB/s)")


def cusparse_matrix(csr):
    """graph's adjacency as a torch sparse CSR matrix: the yardstick of the
    pull SpMVs (cuSPARSE), never used by the port."""
    import torch

    valid = csr.edge_dst < csr.n
    crow = torch.zeros(csr.n + 1, dtype=torch.int64, device=csr.device)
    crow[1:] = torch.cumsum(csr.degrees.to(torch.int64), 0)
    return torch.sparse_csr_tensor(crow, csr.edge_dst[valid].to(torch.int64),
                                   csr.edge_w[valid], size=(csr.n, csr.n))


def spmv_bytes(g, B, kind, weighted=None):
    """Bytes the whole-graph kernel must move on graph ``g`` for a (B, n)
    float32 x: each input read once, each output written once; ``weighted``
    (default ``g.weighted``) says whether kernel 2 reads the weights.

    kernel 2 reads, per block, its first target and valid count, the deltas
    and weights of its valid slots (a lane loads no slot past the valid
    count) and the filter words covering them; kernel 3, per block, its
    owner, the target and weight of each real slot (the count its owner's
    degree leaves it) and the filter words covering them."""
    import torch

    from repro_torch.kernels import real_slot_counts

    NB, FB = g.num_blocks, g.block_size
    vec = (g.n * 4 + NB * 4) * B                             # x once; out once
    if kind == "compressed":
        vc = g.valid_count.to(torch.int64) & 0xFFFF
        slots = int(vc.sum())
        words = int(((vc + 31) // 32).sum())
        w = 4 * slots if (g.weighted if weighted is None else weighted) else 0
        return NB * (4 + 2) + 2 * slots + w + 4 * words + vec
    cnt = real_slot_counts(g.block_src, g.block_offsets, g.degrees, n=g.n,
                           block_size=FB).to(torch.int64)
    slots = int(cnt.sum())
    words = int(((cnt + 31) // 32).sum())
    return NB * 4 + slots * (4 + 4) + 4 * words + vec


def time_whole_graph_kernels(G):
    """Device ms of kernels 2 and 3 on graph ``G`` (F_B=128, weighted, the
    filter bits, tile TILE), one query and B=8, beside their plain versions,
    cuSPARSE (``A @ x``, ``A @ X``) and the bytes bound; kernel 3 with the
    owner arrays (``"edge"``, real slots only, as ``spmv_vertex`` calls it)
    and without (``"edge rows"``, whole rows), first held to each other."""
    import torch

    from repro_torch.core import make_filter
    from repro_torch.kernels import (
        compressed_block_spmv,
        compressed_block_spmv_ref,
        edge_block_spmv,
        edge_block_spmv_ref,
    )
    from repro_torch.tuning import HBM_BYTES_PER_S

    c, csr = G.dev, G.csr
    bits = make_filter(c).bits
    A = cusparse_matrix(csr)
    gen = torch.Generator().manual_seed(3)
    out = {}
    for B in (1, BATCH):
        x = (torch.rand(c.n, generator=gen) if B == 1
             else torch.rand(B, c.n, generator=gen)).to(c.device)
        xt = x[:, None] if B == 1 else x.T.contiguous()      # (n, B) for A @ X
        lib = device_ms(lambda: A @ xt)
        a2 = (c.block_first, c.deltas, c.valid_count, bits, None, c.block_weights)
        a3 = (csr.block_dst, csr.block_w, bits, None)
        owners = (csr.block_src, csr.block_offsets, csr.degrees)
        sums_err(edge_block_spmv(x, *a3, n=c.n, tile_blocks=TILE, owners=owners),
                 edge_block_spmv(x, *a3, n=c.n, tile_blocks=TILE), False,
                 f"kernel 3 B={B}: real slots against whole rows")
        bound3 = spmv_bytes(csr, B, "edge") / HBM_BYTES_PER_S * 1e3
        plain3 = device_ms(lambda: edge_block_spmv_ref(x, *a3, n=c.n), runs=5, per_run=3)
        out[("compressed", B)] = dict(
            ms=device_ms(lambda: compressed_block_spmv(x, *a2, n=c.n, tile_blocks=TILE)),
            plain_ms=device_ms(lambda: compressed_block_spmv_ref(x, *a2, n=c.n), runs=5,
                               per_run=3),
            library_ms=lib,
            bound_ms=spmv_bytes(c, B, "compressed") / HBM_BYTES_PER_S * 1e3,
        )
        for kind, own in (("edge", owners), ("edge rows", None)):
            out[(kind, B)] = dict(
                ms=device_ms(lambda: edge_block_spmv(x, *a3, n=c.n, tile_blocks=TILE,
                                                     owners=own)),
                plain_ms=plain3,
                library_ms=lib,
                bound_ms=bound3,
            )
    for (kind, B), t in out.items():
        check_bound(f"{kind} B={B}", t)
    return out


def log_times(tag, times):
    names = {"compressed": "kernel 2 compressed_block_spmv",
             "edge": "kernel 3 edge_block_spmv (real slots)",
             "edge rows": "kernel 3 edge_block_spmv (whole rows)"}
    for (kind, B), t in sorted(times.items()):
        name = names[kind]
        log(f"[{tag}] {name} B={B} TB={TILE}: kernel {t['ms']!r} ms, plain "
            f"{t['plain_ms']!r} ms, cuSPARSE {t['library_ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms")


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


def drain_rounds(reqs, results, max_batch):
    """Rounds the engine's drained batches ran: its buckets are the requests
    of one op in order, max_batch at a time; a BFS batch runs its deepest
    level + 1 rounds, a wBFS batch one round per distinct finite distance of
    its longest-running query."""
    import torch

    per_op = {}
    for (op, _), res in zip(reqs, results):
        if op == "bfs":
            per_op.setdefault(op, []).append(int(res[1].max()) + 1)
        else:
            per_op.setdefault(op, []).append(int(torch.unique(res[res < 2**31 - 1]).numel()))
    return sum(max(r[i:i + max_batch]) for r in per_op.values()
               for i in range(0, len(r), max_batch))


def serve(engine, reqs, plan):
    """Serve ``reqs``; check each result against its single run on ``plan``;
    returns (seconds, launches of kernel 1's two entries, rounds of the
    drained batches)."""
    import torch

    from repro_torch.algorithms import bfs, wbfs
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round

    g = engine.graph
    before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
    ts = time.perf_counter()
    results = engine.serve(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - ts
    launches = {"decode": compressed_chunked_spmv.launches - before[0],
                "fused": compressed_stream_round.launches - before[1]}
    for (op, params), res in zip(reqs, results):
        if op == "bfs":
            want = bfs(g, params["src"], plan=plan)
            check(torch.equal(res[0], want[0]) and torch.equal(res[1], want[1]),
                  f"engine BFS from {params['src']} differs from its single run")
        else:
            check(torch.equal(res, wbfs(g, params["src"], plan=plan)),
                  f"engine wBFS from {params['src']} differs from its single run")
    return secs, launches, drain_rounds(reqs, results, engine.max_batch)


# ----------------------------------------------------------------------
# phase 9: the graphFilter path (kernel 4)
# ----------------------------------------------------------------------
def pack_case(nb, fb, rng, dev):
    """Random filter words (bit 31 set in every first word), keep mask and
    subset of ``nb`` blocks of ``fb`` slots, on ``dev``."""
    import numpy as np
    import torch

    bits = rng.integers(-2**31, 2**31, (nb, fb // 32)).astype(np.int32)
    bits[:, 0] |= np.int32(-2**31)
    keep = rng.random((nb, fb)) < 0.5
    sub = rng.random(nb) < 0.6
    return tuple(torch.from_numpy(a).to(dev) for a in (bits, keep, sub))


def same_pack(bits, keep, sub, what):
    """Kernel 4 and its plain version agree exactly, bits and counts."""
    import torch

    from repro_torch.kernels import filter_pack_ref, filter_pack_words

    want = filter_pack_ref(bits, keep, sub)
    got = filter_pack_words(bits, keep, sub)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"kernel 4 differs from plain: {what}")


def compare_filter_pack(graphs, rng, stats):
    """Kernel 4 against its plain version on the card: F_B 32/64/128, NB not
    a multiple of the warps per CTA, subsets all false / all true / random,
    keep masks all false / random, and the real filters of ``graphs`` under
    a real predicate.  Bits and counts must be equal."""
    import torch

    from repro_torch.core import make_filter
    from repro_torch.core.primitives import take_fill

    def against_plain(bits, keep, sub, what):
        same_pack(bits, keep, sub, what)
        stats["kernel 4"] += 1

    dev = graphs[0].device
    for fb in (32, 64, 128):
        bits, keep, sub = pack_case(4099, fb, rng, dev)
        for sname, s in (("random", sub), ("none", torch.zeros_like(sub)),
                         ("all", torch.ones_like(sub))):
            for kname, k in (("random", keep), ("none", torch.zeros_like(keep))):
                against_plain(bits, k, s, f"F_B={fb} NB=4099 subset {sname} keep {kname}")
    for g in graphs:
        f = make_filter(g)
        keep = ((g.edge_src + g.edge_dst) % 3 != 0).reshape(g.num_blocks, g.block_size)
        part = take_fill(torch.arange(g.n, device=dev) % 2 == 0, g.block_src, False)
        for sname, s in (("owners even", part), ("all", torch.ones_like(part))):
            against_plain(f.bits, keep, s, f"real filter n={g.n} subset {sname}")
    return 0.0  # every case above is held to exact equality


def pack_bytes(NB, FB):
    """Bytes kernel 4 must move over NB blocks of FB slots: the keep bytes,
    the words read and written, the subset byte and the count."""
    return NB * (FB + 2 * (FB // 32) * 4 + 1 + 4)


def time_filter_pack(g):
    """Device ms of kernel 4 and its plain version over the real filter of
    ``g`` with every block in the subset (the shape of a maximal matching or
    set cover round), and the bytes bound.  The two are first held equal on
    these inputs."""
    import torch

    from repro_torch.core import make_filter
    from repro_torch.kernels import filter_pack_ref, filter_pack_words
    from repro_torch.tuning import HBM_BYTES_PER_S

    bits = make_filter(g).bits
    keep = (g.edge_dst % 2 == 0).reshape(g.num_blocks, g.block_size)
    sub = torch.ones(g.num_blocks, dtype=torch.bool, device=g.device)
    same_pack(bits, keep, sub, f"timed inputs, n={g.n} NB={g.num_blocks}")
    return check_bound(f"kernel 4, n={g.n}", dict(
        ms=device_ms(lambda: filter_pack_words(bits, keep, sub)),
        plain_ms=device_ms(lambda: filter_pack_ref(bits, keep, sub), runs=5, per_run=3),
        library_ms=None,   # no one PyTorch call packs, ANDs and counts
        bound_ms=pack_bytes(g.num_blocks, g.block_size) / HBM_BYTES_PER_S * 1e3,
        bytes=pack_bytes(g.num_blocks, g.block_size),
    ))


def check_matching(g, partner):
    """Partners are mutual and adjacent; every valid edge has a matched end."""
    import torch

    n = g.n
    src, dst = g.edge_src.long(), g.edge_dst.long()
    valid = dst < n
    p = torch.cat([partner, partner.new_full((1,), -1)]).long()
    matched = p >= 0
    check(bool((p[p[:n].clamp(min=0)] == torch.arange(n, device=g.device))[matched[:n]]
               .all()), "matching: partners are not mutual")
    on_edge = torch.zeros(n + 1, dtype=torch.int64, device=g.device)
    on_edge.index_add_(0, torch.where(valid, src, n), (valid & (p[src] == dst)).long())
    check(torch.equal(on_edge[:n], matched[:n].long()), "matching: a partner is not adjacent")
    check(bool((matched[src] | matched[dst])[valid].all()), "matching: not maximal")
    return int(matched[:n].sum())


def check_set_cover(g, sets, in_cover):
    """The cover lies within the sets; every element with a set neighbour has
    a neighbour in the cover."""
    import torch

    n = g.n
    src, dst = g.edge_src.long(), g.edge_dst.long()
    valid = dst < n
    check(not bool((in_cover & ~sets).any()), "set cover: a non-set in the cover")
    s = torch.cat([sets, sets.new_zeros(1)])
    c = torch.cat([in_cover, in_cover.new_zeros(1)])
    elem_edge = valid & s[src] & ~s[dst]
    coverable = torch.zeros(n + 1, dtype=torch.bool, device=g.device)
    coverable[dst[elem_edge]] = True
    covered = torch.zeros(n + 1, dtype=torch.bool, device=g.device)
    covered[dst[elem_edge & c[src]]] = True
    check(bool((covered | ~coverable).all()), "set cover: an element is not covered")
    return int(coverable.sum())


def rounds_of(algorithm):
    from repro_torch.obs import get_registry

    c = get_registry().get("sage_algorithm_rounds_total")
    return 0 if c is None else int(c.value(algorithm=algorithm))


def profile_run(fn, top=8):
    """One ``fn()`` under ``torch.profiler``: its wall seconds, the device
    time summed over its kernels (ms), the number of kernel launches, and the
    ``top`` kernels by device time as (name, ms, calls).  Only the kernel
    events count: an operator's own event repeats its kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall, busy_ms, sum(e.count for e in kernels), [
        (e.key, e.self_device_time_total / 1e3, e.count) for e in kernels[:top]]


def filter_results(g, pri, sets, rng_seed):
    """Every filter-path result on ``g``: the eight algorithms, and
    ``pack_vertices`` with a partial subset and ``filter_edges`` from a
    filter with dirty vertices."""
    import numpy as np
    import torch

    from repro_torch import algorithms as A
    from repro_torch.core import filter_edges, make_filter, pack_vertices

    dev = g.device
    rng = np.random.default_rng(rng_seed)
    keep = torch.from_numpy(rng.random(g.num_blocks * g.block_size) < 0.7).to(dev)
    subset = torch.from_numpy(rng.random(g.n) < 0.5).to(dev)
    f1 = pack_vertices(g, make_filter(g), subset, keep)
    f2, remaining = filter_edges(g, f1, torch.roll(keep, 7))
    orient, orient_keep = A.orientation_filter(g)
    best, rho = A.densest_subgraph(g)
    return {
        "pack_vertices": (f1.bits, f1.active_deg, f1.dirty),
        "filter_edges": (f2.bits, f2.active_deg, f2.dirty, remaining),
        "mis": A.mis(g, priorities=pri),
        "maximal_matching": A.maximal_matching(g),
        "coloring": A.coloring(g),
        "set_cover": A.set_cover(g, sets, priorities=pri),
        "kcore": A.kcore(g),
        "densest_subgraph": (best, rho),
        "triangle_count": A.triangle_count(g),
        "orientation_filter": (orient.bits, orient.active_deg, orient.dirty, orient_keep),
    }


def filter_inputs(n):
    """Phase 9(d)'s priorities (a permutation from the seed) and sets (ids
    below n/3) on the host."""
    import torch

    return (torch.randperm(n, generator=torch.Generator().manual_seed(SEED)),
            torch.arange(n) < n // 3)


FILTER_CPU_ROUTE = ROOT / "build" / "phase9d_cpu.pt"
CPU_ROUTE_THREADS = 2   # the CPU route's torch threads beside the main process


def filter_cpu_route(out_path, n, m):
    """Phase 9(d)'s CPU route, in a process of its own: graph E (``n``,
    ``m``) built on the host as ``drive`` builds it, ``filter_results`` over
    its compressed form and its CSR, saved with each one's seconds to
    ``out_path``."""
    import torch

    sys.path.insert(0, str(SRC))
    torch.set_num_threads(CPU_ROUTE_THREADS)
    E_ = build_graph(n, m, torch.device("cpu"))
    pri, sets = filter_inputs(E_.host.n)
    out = {}
    for kind, g in (("compressed", E_.host), ("CSR", E_.host_csr)):
        ts = time.perf_counter()
        res = filter_results(g, pri, sets, SEED)
        out[kind] = (res, time.perf_counter() - ts)
    torch.save(out, out_path)


def start_filter_cpu_route(graph_e):
    """Start phase 9(d)'s CPU route (``filter_cpu_route``) in a child
    process that sees no card, so it runs while the card works through
    phases 2-8; the child is killed if this process exits first."""
    import atexit

    FILTER_CPU_ROUTE.parent.mkdir(parents=True, exist_ok=True)
    FILTER_CPU_ROUTE.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.filter_cpu_route({str(FILTER_CPU_ROUTE)!r}, {graph_e[0]}, "
            f"{graph_e[1]})")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env)
    atexit.register(proc.kill)
    return proc


def finish_filter_cpu_route(proc) -> dict:
    """Wait for the CPU route's child (the host seconds it kept this
    process waiting are returned under ``"waited"``) and load its
    results."""
    import torch

    ts = time.perf_counter()
    rc = proc.wait(timeout=900)
    check(rc == 0, f"phase 9(d)'s CPU route exited {rc}")
    out = torch.load(FILTER_CPU_ROUTE)
    out["waited"] = time.perf_counter() - ts
    return out


def same_result(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return all(same_result(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        a, b = a.cpu(), b.cpu()
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# ----------------------------------------------------------------------
# phase 10: the LM serving path (kernel 6)
# ----------------------------------------------------------------------
def attn_case(B, S, Hq, Hkv, D, dtype, dev, seed):
    """Random q (B, Hq, D) and cache k, v (B, S, Hkv, D) of ``dtype`` on
    ``dev``, drawn from ``seed``."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def attn_lengths(B, S, rows, rng):
    """The cache lengths of phase 10(a): every sequence at 1, at a tile
    boundary (128), at S, and a mix in one batch with a split boundary
    (``rows``) and the row after it, the rest random in [1, S]."""
    import numpy as np

    mix = rng.integers(1, S + 1, B)
    fixed = [min(rows, S), min(rows + 1, S), 1, S, min(128, S)]
    mix[:min(B, len(fixed))] = fixed[:B]
    return {"1": np.full(B, 1), "tile": np.full(B, min(128, S)), "S": np.full(B, S),
            "mix": mix}


def compare_decode_attention(dev, rng, stats):
    """Kernel 6 against its plain version on the card at every shape of
    ``ATTN_SHAPES``, float32 and bfloat16, every length set of
    ``attn_lengths``, each case within ``ATTN_REL_TOL``.  Returns the max abs
    error and the max relative error per dtype."""
    import torch

    from repro_torch.kernels import (
        ATTN_REL_TOL,
        decode_attention,
        decode_attention_ref,
        decode_attention_rel_err,
    )
    from repro_torch.kernels.decode_attention.decode_attention import split_rows

    err, rel = {}, {}
    for i, (B, S, Hq, Hkv, D) in enumerate(ATTN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            q, k, v = attn_case(B, S, Hq, Hkv, D, dtype, dev, SEED + i)
            rows = split_rows(q, k)[1]
            for name, lengths in attn_lengths(B, S, rows, rng).items():
                pos = torch.from_numpy(lengths.astype("int32")).to(dev)
                got = decode_attention(q, k, v, pos)
                want = decode_attention_ref(q, k, v, pos)
                r = decode_attention_rel_err(got, want)
                check(got.dtype == dtype and r <= ATTN_REL_TOL[dtype],
                      f"kernel 6 (B,S,Hq,Hkv,D)={(B, S, Hq, Hkv, D)} {dtype} pos {name}: "
                      f"relative error {r} (> {ATTN_REL_TOL[dtype]})")
                err[dname] = max(err.get(dname, 0.0),
                                 float((got.float() - want.float()).abs().max()))
                rel[dname] = max(rel.get(dname, 0.0), r)
                stats["kernel 6"] += 1
    return err, rel


def without_rows(k, pos, lo, hi):
    """The cache ``k`` with rows [lo, hi) taken out, and the lengths that
    leave the other rows below ``pos`` valid."""
    import torch

    return torch.cat([k[:, :lo], k[:, hi:]], 1), pos - (pos - lo).clamp(0, hi - lo)


def attention_faults(rows):
    """Decode attentions with a planted fault, each the plain version on
    altered inputs: every sequence one row short; the second split's rows
    [rows, 2 rows) dropped; q heads read the wrong KV head (the groups
    interleaved).  Phase 10 shows that its limits reject them."""
    from repro_torch.kernels import decode_attention_ref

    def one_row_short(q, k, v, pos):
        return decode_attention_ref(q, k, v, pos - 1)

    def split_dropped(q, k, v, pos):
        k2, p2 = without_rows(k, pos, rows, 2 * rows)
        return decode_attention_ref(q, k2, without_rows(v, pos, rows, 2 * rows)[0], p2)

    def wrong_kv_head(q, k, v, pos):
        b, hq, d = q.shape
        q = q.reshape(b, hq // k.shape[2], k.shape[2], d).transpose(1, 2).reshape(b, hq, d)
        return decode_attention_ref(q, k, v, pos)

    return {"one row short": one_row_short, "split dropped": split_dropped,
            "wrong KV head": wrong_kv_head}


def attn_bytes(q, k, pos):
    """Bytes kernel 6 must move: the K and V rows below each length, q, the
    lengths and the output."""
    B, S, Hkv, D = k.shape
    rows = int(pos.clamp(0, S).sum())
    return 2 * rows * Hkv * D * k.element_size() + 2 * q.numel() * q.element_size() + 4 * B


def attn_flops(q, k, pos):
    """Multiply-adds of kernel 6, two operations each: q.k and p.v for every
    q head over the rows below each length."""
    B, Hq, D = q.shape
    return 4 * int(pos.clamp(0, k.shape[1]).sum()) * Hq * D


def time_decode_attention(dev):
    """Device ms of kernel 6, of its plain version and of
    ``scaled_dot_product_attention`` (a yardstick the port never calls) at
    ``ATTN_TIMED``, bfloat16, every sequence at its full length; the kernel
    and the yardstick are first held to the plain version within
    ``ATTN_REL_TOL``, and the planted faults of ``attention_faults`` shown to
    lie outside it.  And the bytes bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (
        ATTN_REL_TOL,
        decode_attention,
        decode_attention_ref,
        decode_attention_rel_err,
    )
    from repro_torch.kernels.decode_attention.decode_attention import kernel_config, split_rows
    from repro_torch.tuning import HBM_BYTES_PER_S

    B, S, Hq, Hkv, D = ATTN_TIMED
    q, k, v = attn_case(B, S, Hq, Hkv, D, torch.bfloat16, dev, SEED)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev)[None, :] < pos[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True)[:, :, 0]

    tol = ATTN_REL_TOL[torch.bfloat16]
    want = decode_attention_ref(q, k, v, pos)
    rel = {"kernel": decode_attention_rel_err(decode_attention(q, k, v, pos), want),
           "sdpa": decode_attention_rel_err(sdpa(), want)}
    for name, r in rel.items():
        check(r <= tol, f"{name} at the timed shape differs from plain by {r} relative")
    for name, fault in attention_faults(split_rows(q, k)[1]).items():
        rel[name] = decode_attention_rel_err(fault(q, k, v, pos), want)
        check(rel[name] > tol, f"the limit {tol} does not reject '{name}' ({rel[name]})")
    del want
    nbytes, flops = attn_bytes(q, k, pos), attn_flops(q, k, pos)
    out = dict(
        ms=device_ms(lambda: decode_attention(q, k, v, pos)),
        plain_ms=device_ms(lambda: decode_attention_ref(q, k, v, pos), runs=5, per_run=3),
        library_ms=device_ms(sdpa, runs=5, per_run=3),
        bytes=nbytes,
        flops=flops,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        rel=rel,
        config=kernel_config(q, k),
    )
    del q, k, v, mask
    return check_bound("kernel 6", out)


def greedy_decode(params, caches, logits, pos0, steps, cfg):
    """``steps`` greedy ``decode_step``s from the prefill's ``logits`` on
    ``cfg``'s route; returns the tokens fed in and the logits of every step."""
    from repro_torch.models.transformer_lm import decode_step

    tokens, out = [], []
    for i in range(steps):
        tok = logits.argmax(dim=-1, keepdim=True)
        logits, caches = decode_step(params, caches, tok, pos0 + i, cfg)
        tokens.append(tok)
        out.append(logits)
    return tokens, out


def clone_caches(caches):
    """A copy of a cache tree ``{stack: {name: tensor}}``."""
    return {key: {name: t.clone() for name, t in entry.items()} for key, entry in caches.items()}


def first_k(caches):
    """A GQA cache tree's first layer of K, (B, Smax, Hkv, D)."""
    return next(iter(caches.values()))["k"][0]


def serve_greedy(params, cfg, prompts, max_seq, steps):
    """Prefill ``prompts`` into caches of ``max_seq`` rows, then ``steps``
    greedy decode steps on ``cfg``'s route, kernel 6's count set to 0 just
    before the decode.  Returns the prefill's seconds, a copy of its caches,
    the decode's seconds, kernel 6's launches in it, the tokens fed in,
    every step's logits and the caches after the last step."""
    import torch

    from repro_torch.kernels import decode_attention
    from repro_torch.models import transformer_lm as lm

    torch.cuda.synchronize()
    ts = time.perf_counter()
    logits0, caches = lm.prefill(params, prompts, cfg, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - ts
    cache0 = clone_caches(caches)
    decode_attention.launches = 0
    ts = time.perf_counter()
    tokens, logits = greedy_decode(params, caches, logits0, prompts.shape[1], steps, cfg)
    torch.cuda.synchronize()
    return dict(prefill_s=prefill_s, cache0=cache0, decode_s=time.perf_counter() - ts,
                launches=decode_attention.launches, tokens=tokens, logits=logits,
                caches=caches)


def teacher_forced(params, cfg, cache0, tokens, pos0, attention):
    """The logits of decoding ``tokens`` from a copy of ``cache0`` at
    ``pos0`` with the single-token ``attention``."""
    from repro_torch.models import transformer_lm as lm

    cache, out = clone_caches(cache0), []
    for i, tok in enumerate(tokens):
        logits, cache = lm.decode_step(params, cache, tok, pos0 + i, cfg, attention=attention)
        out.append(logits)
    return out


def compare_logits(got, want, what, held=None):
    """Each step's logits finite; the (step, sequence) rows that ``held``
    marks (default all) within ``LOGITS_REL_TOL`` of ``want``'s.  Returns
    the max relative difference over the held rows and over all rows, the
    max abs difference and the greedy tokens that agree."""
    import torch

    worst, rel, rel_all, agree = 0.0, 0.0, 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(g).all()), f"{what} step {i}: logits not finite")
        worst = max(worst, float((g.float() - w.float()).abs().max()))
        r = (g.float() - w.float()).norm(dim=-1) / w.float().norm(dim=-1)
        rel_all = max(rel_all, float(r.max()))
        r = r if held is None else r[held[i]]
        rel = max([rel] + r.tolist())
        agree += int((w.argmax(-1) == g.argmax(-1)).sum())
    check(rel <= LOGITS_REL_TOL, f"{what}: kernel route logits differ from the plain route by "
                                 f"{rel} relative (> {LOGITS_REL_TOL})")
    return rel, rel_all, worst, agree


def logits_rel_err(got, want) -> float:
    """Max over sequences of |got - want| / |want| (L2 norms over the vocab)."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def weight_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def fault_line(readings) -> str:
    return ", ".join(f"{name} {r!r}" for name, r in readings.items())


def check_kernel6(dev, rng, stats):
    """Phase 10(a) and (b): kernel 6 against its plain version at every
    shape of ``ATTN_SHAPES`` and timed at ``ATTN_TIMED``.  Returns the max
    abs error of (a) per dtype and (b)'s timing."""
    import torch

    from repro_torch.kernels import ATTN_REL_TOL
    from repro_torch.tuning import HBM_BYTES_PER_S

    stats["kernel 6"] = 0
    err, rel_a = compare_decode_attention(dev, rng, stats)
    timing = time_decode_attention(dev)
    log(f"[10] kernel 6 == plain on the card in {stats['kernel 6']} cases (relative L2 per "
        f"(sequence, head): float32 within {ATTN_REL_TOL[torch.float32]}, bfloat16 within "
        f"{ATTN_REL_TOL[torch.bfloat16]}); max relative err float32 {rel_a['float32']!r}, "
        f"bfloat16 {rel_a['bfloat16']!r}; max abs err float32 {err['float32']!r}, bfloat16 "
        f"{err['bfloat16']!r}")
    cfg6 = timing["config"]
    log(f"[10] kernel 6 at (B,S,Hq,Hkv,D)={ATTN_TIMED} bfloat16: "
        + ", ".join(f"{k} {v}" for k, v in cfg6.items()))
    log(f"[10] kernel 6 at (B,S,Hq,Hkv,D)={ATTN_TIMED} bfloat16, pos=S: kernel "
        f"{timing['ms']!r} ms, plain {timing['plain_ms']!r} ms, scaled_dot_product_attention "
        f"(yardstick) {timing['library_ms']!r} ms, bound {timing['bound_ms']!r} ms "
        f"({timing['bytes']} B at {HBM_BYTES_PER_S / 1e12} TB/s; {timing['flops']} flops at "
        f"{BF16_FLOPS / 1e12} TFLOP/s); row error (relative L2) against plain: kernel "
        f"{timing['rel']['kernel']!r} beside the limit ATTN_REL_TOL "
        f"{ATTN_REL_TOL[torch.bfloat16]!r} (2^-8 = {2.0 ** -8!r}); "
        f"{fault_line(timing['rel'])} (the last three are planted faults, rejected)")
    return err, timing


def kernel6_record(err, timing, launches):
    """Kernel 6's line of the final ``kernels`` record."""
    from repro_torch.tuning import HBM_BYTES_PER_S

    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": KERNEL_SOURCES["attention"],
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:65",
        "launches": launches,
        "max_abs_err": max(err.values()),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes" if timing["bytes"] / HBM_BYTES_PER_S >= timing["flops"] / BF16_FLOPS
        else "operations",
        "library_ms": timing["library_ms"],
    }


def drive_lm(dev, rng, stats, cfg, serve=LM_SERVE, long=LM_LONG):
    """Phase 10: kernel 6 against its plain version and timed; then
    qwen2-1.5B serving on the card: ``serve`` = (batch, prompt tokens,
    max_seq, greedy steps) through prefill and ``decode_step``, held to the
    plain route teacher-forced; ``long`` = (batch, max_seq, steps) decode
    over a cache filled to max_seq - steps.  The logits of the planted
    faults of ``attention_faults`` are read beside the kernel route's, on
    the same tokens.  Returns kernel 6's record."""
    import torch

    from repro_torch.kernels import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention.decode_attention import split_rows
    from repro_torch.models import transformer_lm as lm
    from repro_torch.tuning import HBM_BYTES_PER_S

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    err, timing = check_kernel6(dev, rng, stats)

    # (c) requests end to end: prefill, then greedy decode
    B, P, max_seq, steps = serve
    params = lm.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    wbytes = weight_bytes(params)
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    run = serve_greedy(params, cfg, prompts, max_seq, steps)
    prefill_s, decode_s, launches_c = run["prefill_s"], run["decode_s"], run["launches"]
    check(launches_c == cfg.n_layers * steps,
          f"serving: {launches_c} kernel 6 launches, not {cfg.n_layers} x {steps}")
    plain = teacher_forced(params, cfg, run["cache0"], run["tokens"], P, decode_attention_ref)
    rel, _, worst, agree = compare_logits(run["logits"], plain, "serving")
    k0 = first_k(run["cache0"])
    rows_c = split_rows(k0.new_empty((B, cfg.n_heads, cfg.d_head)), k0)[1]
    faults_c = {name: max(logits_rel_err(got, want) for got, want in
                          zip(teacher_forced(params, cfg, run["cache0"], run["tokens"], P, fn),
                              plain))
                for name, fn in attention_faults(rows_c).items()}
    check(min(faults_c.values()) > LOGITS_REL_TOL,
          f"serving: the logits limit does not reject every fault: {fault_line(faults_c)}")
    ms_c = decode_s / steps * 1e3
    bound_c = (wbytes + 2 * cfg.n_layers * B * (P + steps / 2) * cfg.n_kv_heads * cfg.d_head
               * 2) / HBM_BYTES_PER_S * 1e3
    log(f"[10] {cfg.name} serving, {B} prompts x {P} tokens, max_seq {max_seq}: prefill "
        f"{prefill_s:.3f} s; {steps} greedy decode steps in {decode_s:.3f} s = {ms_c:.3f} "
        f"ms/step = {B * steps / decode_s:.1f} tokens/s (bytes bound {bound_c:.3f} ms/step: "
        f"{wbytes} B of weights and the cache); kernel 6 launches {launches_c} = "
        f"{cfg.n_layers} x {steps}; teacher-forced plain route: logits relative diff "
        f"{rel!r} (tolerance {LOGITS_REL_TOL}), max abs diff {worst!r}, greedy tokens agree "
        f"{agree}/{B * steps}; planted faults (split of {rows_c} rows): {fault_line(faults_c)}")
    del run, plain, prompts
    torch.cuda.empty_cache()

    # (d) long context at full width: a cache filled in place, then decode
    B, max_seq, steps = long
    fill = max_seq - steps
    caches = lm.make_cache(cfg, B, max_seq, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    for entry in caches.values():
        for t in entry.values():
            for layer in t:
                layer[:, :fill].normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=torch.Generator().manual_seed(SEED))
    tok = tok.to(dev)
    # the plain route's first step and the faults' on the same cache: each
    # writes row `fill` itself before it attends, and reads the fill below it
    want, caches = lm.decode_step(params, caches, tok, fill, cfg, attention=decode_attention_ref)
    k0 = first_k(caches)
    rows_d = split_rows(k0.new_empty((B, cfg.n_heads, cfg.d_head)), k0)[1]
    faults_d = {name: logits_rel_err(lm.decode_step(params, caches, tok, fill, cfg,
                                                    attention=fn)[0], want)
                for name, fn in attention_faults(rows_d).items()}
    torch.cuda.synchronize()
    decode_attention.launches = 0
    ts = time.perf_counter()
    first = None
    for i in range(steps):
        logits, caches = lm.decode_step(params, caches, tok, fill + i, cfg)
        first = logits if first is None else first
        tok = logits.argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - ts
    launches_d = decode_attention.launches
    check(launches_d == cfg.n_layers * steps,
          f"long context: {launches_d} kernel 6 launches, not {cfg.n_layers} x {steps}")
    check(bool(torch.isfinite(logits).all()), "long context: logits not finite")
    diff_d = float((first.float() - want.float()).abs().max())
    rel_d = logits_rel_err(first, want)
    check(rel_d <= LOGITS_REL_TOL, f"long context: first step differs from the plain route by "
                                   f"{rel_d} relative")
    # one row of 32k moves the logits about as little as the rounding does
    check(min(r for name, r in faults_d.items() if name != "one row short") > LOGITS_REL_TOL,
          f"long context: the logits limit does not reject a fault: {fault_line(faults_d)}")
    cache_bytes = 2 * cfg.n_layers * B * (fill + steps / 2) * cfg.n_kv_heads * cfg.d_head * 2
    bound_d = (wbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    prof_s, busy_ms, n_kernels, top = profile_run(
        lambda: lm.decode_step(params, caches, tok, max_seq - 1, cfg))
    peak = torch.cuda.max_memory_allocated(dev)
    ms_d = long_s / steps * 1e3
    log(f"[10] {cfg.name} long context, batch {B}, cache {max_seq} (filled to {fill} from a "
        f"seeded generator, {2 * cfg.n_layers * B * max_seq * cfg.n_kv_heads * cfg.d_head * 2}"
        f" B): {steps} decode steps in {long_s:.3f} s = {ms_d:.3f} ms/step = "
        f"{B * steps / long_s:.1f} tokens/s; bytes bound {bound_d:.3f} ms/step = "
        f"{B / bound_d * 1e3:.1f} tokens/s; kernel 6 launches {launches_d} = "
        f"{cfg.n_layers} x {steps}; first step against the plain route: logits relative diff "
        f"{rel_d!r}, max abs diff {diff_d!r}; planted faults (split of {rows_d} rows): "
        f"{fault_line(faults_d)}; peak device memory {peak} B")
    log(f"[10] one long-context step under torch.profiler: wall {prof_s:.4f} s, {n_kernels} "
        f"kernels, {busy_ms:.3f} ms of device time: busy {busy_ms / 1e3 / prof_s:.3f} of the "
        f"profiled step, {busy_ms / ms_d:.3f} of the unprofiled {ms_d:.3f} ms step (the "
        f"profiler slows the host, not the card)")
    for name, ms, calls in top:
        log(f"[10]   {ms:10.3f} ms  {calls:5d} calls  {name[:110]}")
    del caches, params, logits, first, want
    torch.cuda.empty_cache()
    return kernel6_record(err, timing, launches_c + launches_d)


# ----------------------------------------------------------------------
# phase 11: SASRec serving (kernel 5)
# ----------------------------------------------------------------------
def tensor_digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def plain_bag(table, idx, w, mode):
    """``ops.embedding_bag`` with the plain version in place of the kernel."""
    import torch

    from repro_torch.kernels import embedding_bag_ref

    out = embedding_bag_ref(table, idx, w)
    if mode == "mean":
        out = out / torch.clamp_min((idx >= 0).to(table.dtype).sum(dim=1, keepdim=True), 1)
    return out


def bag_err(got, want, what):
    """Kernel 5's output against the plain version's: float32 within rtol
    ``SUM_RTOL`` (atol ``SUM_ATOL``), bfloat16 within one ulp.  Returns the
    max abs error and whether the two are bit for bit equal (-0.0 is not
    +0.0)."""
    import torch

    from repro_torch.kernels import bf16_ulps, same_bits

    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype or shape")
    if want.dtype == torch.bfloat16:
        ulps = int(bf16_ulps(got, want).max()) if want.numel() else 0
        check(ulps <= 1, f"{what}: {ulps} bfloat16 ulps from the plain version")
    else:
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL, msg=what)
    diff = (got.float() - want.float()).abs()
    return (float(diff.max()) if diff.numel() else 0.0), same_bits(got, want)


def compare_embedding_bag(dev, stats):
    """Kernel 5 against its plain version on the card at ``BAG_SHAPES``,
    float32 and bfloat16, sum and mean, with padding and out-of-range ids;
    bags of one (weights 1 and None) and ``take_rows`` exactly the rows;
    then its bags-of-one path at every B of ``BAG_ONE_B`` and row of
    ``BAG_ONE_ROWS``, weighted and not, with -0.0 and out-of-range ids
    planted.  Every bag-sum case must equal the plain version bit for bit.
    Returns the max abs error and the count of bag-sum cases."""
    import torch

    from repro_torch.kernels import (
        bag_case,
        bag_of_one_case,
        embedding_bag,
        embedding_bag_ref,
        embedding_bag_sums,
        take_rows,
    )

    err, exact = 0.0, 0
    for i, (V, D, B, L) in enumerate(BAG_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            table, idx, w = bag_case(V, D, B, L, dtype, SEED + i, dev)
            for mode in ("sum", "mean"):
                for weights in (w, None):
                    e, same = bag_err(embedding_bag(table, idx, weights, mode=mode),
                                      plain_bag(table, idx, weights, mode),
                                      f"kernel 5 (V,D,B,L)={(V, D, B, L)} {dtype} {mode} "
                                      f"weights={weights is not None}")
                    check(same, f"kernel 5 (V,D,B,L)={(V, D, B, L)} {dtype} {mode}: not bit "
                                "for bit the plain version's")
                    err, exact = max(err, e), exact + same
                    stats["kernel 5"] += 1
            ones = idx[:, :1].clamp(0, V - 1).contiguous()
            rows = table[ones[:, 0].long()]
            for weights in (None, torch.ones((B, 1), dtype=dtype, device=dev)):
                got = embedding_bag_sums(table, ones, weights)
                torch.cuda.synchronize()
                check(torch.equal(got, rows), f"kernel 5 bags of one {(V, D)} {dtype}: not the "
                                              "rows exactly")
                stats["kernel 5"] += 1
            mixed = torch.randint(-V - 5, V + 5, (7, 301), generator=torch.Generator(dev)
                                  .manual_seed(SEED + i), device=dev, dtype=torch.int32)
            got = take_rows(table, mixed)
            torch.cuda.synchronize()
            check(torch.equal(got.cpu(), take_rows(table.cpu(), mixed.cpu())),
                  f"take_rows {(V, D)} {dtype}: differs from the CPU route")
            stats["kernel 5"] += 1
    for B in BAG_ONE_B:
        for dname, D in BAG_ONE_ROWS:
            dtype = getattr(torch, dname)
            table, idx, w = bag_of_one_case(997, D, B, dtype, SEED + B + D, dev)
            for weights in (w, None):
                e, same = bag_err(embedding_bag_sums(table, idx, weights),
                                  embedding_bag_ref(table, idx, weights),
                                  f"kernel 5 bags of one B={B} D={D} {dname} "
                                  f"weights={weights is not None}")
                check(same, f"kernel 5 bags of one B={B} D={D} {dname}: not bit for bit")
                err, exact = max(err, e), exact + same
                stats["kernel 5"] += 1
    return err, exact


def bag_bytes(table, idx, w):
    """Bytes kernel 5 must move: the ids and weights once, one row for every
    valid slot, the output once."""
    V, D = table.shape
    valid = int(((idx >= 0) & (idx < V)).sum())
    row = D * table.element_size()
    wbytes = 0 if w is None else w.numel() * table.element_size()
    return idx.numel() * 4 + wbytes + valid * row + idx.shape[0] * row, valid


def time_embedding_bag(dev, name, V, D, B, L):
    """Device ms of kernel 5, its plain version and a yardstick the port
    never calls (``F.embedding`` for bags of one, else ``F.embedding_bag``
    with ``per_sample_weights`` over clamped ids and zeroed padding weights),
    on a float32 (V, D) table drawn on the card, each first held to the
    plain version (the kernel bit for bit); and the bytes bound.
    ``retrieval``: SASRec's candidates, every id valid, no weights (the call
    ``take_rows`` makes), -0.0 planted in the first candidate's row.  ``history``:
    the histories of a ``make_sasrec_batch_fn`` batch, padding item 0 as
    padding, normal weights."""
    import torch
    import torch.nn.functional as F

    from repro_torch.data import make_candidates, make_sasrec_batch_fn
    from repro_torch.kernels import embedding_bag_ref, embedding_bag_sums
    from repro_torch.tuning import HBM_BYTES_PER_S

    gen = torch.Generator(dev).manual_seed(SEED)
    table = torch.randn((V, D), generator=gen, device=dev)
    if L == 1:
        idx = make_candidates(gen, B, 1, V, device=dev).reshape(B, 1)
        w = None
        table[idx[0, 0], ::3] = -0.0  # the kernel must give +0.0 there, as plain does

        def library():
            return F.embedding(idx[:, 0], table)
    else:
        seq = make_sasrec_batch_fn(V, B, L, device=dev)(SEED)["seq"]
        idx = torch.where(seq > 0, seq, -1)
        w = torch.randn((B, L), generator=gen, device=dev)
        valid = (idx >= 0) & (idx < V)
        safe, w0 = torch.where(valid, idx, 0), torch.where(valid, w, 0.0)

        def library():
            return F.embedding_bag(safe, table, per_sample_weights=w0, mode="sum")

    want = embedding_bag_ref(table, idx, w)
    err, same = bag_err(embedding_bag_sums(table, idx, w), want, f"kernel 5 timed {name}")
    check(same, f"kernel 5 timed {name}: not bit for bit the plain version's")
    lib = library()
    lib_err = float((lib - want).abs().max())
    check(lib_err <= 1e-4, f"yardstick at {name} differs from plain by {lib_err}")
    del want, lib
    nbytes, valid_slots = bag_bytes(table, idx, w)
    return check_bound(f"kernel 5 at {name}", dict(
        shape=(V, D, B, L),
        ms=device_ms(lambda: embedding_bag_sums(table, idx, w)),
        plain_ms=device_ms(lambda: embedding_bag_ref(table, idx, w), runs=5, per_run=3),
        library_ms=device_ms(library),
        bytes=nbytes,
        valid=valid_slots,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, 2 * valid_slots * D / F32_FLOPS) * 1e3,
        err=err,
        exact=same,
        lib_err=lib_err,
    ))


def timed_calls(fn):
    """Host seconds of each of ``RECSYS_CALLS`` calls of ``fn``, each ending
    in ``torch.cuda.synchronize()``, and the last call's result."""
    import torch

    times, out = [], None
    for _ in range(RECSYS_CALLS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    return times, out


def drive_recsys(dev, stats):
    """Phase 11: kernel 5 against its plain version and timed; then SASRec's
    full configuration served on the card: ``serve_p99`` (512 users, the
    full catalog, top 100) and ``retrieval_cand`` (one query, 1,000,448
    candidates), each ``RECSYS_CALLS`` times, held to the CPU route of the same
    parameters; the item table is never written.  Returns kernel 5's record."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_candidates, make_sasrec_batch_fn
    from repro_torch.kernels import embedding_bag_sums
    from repro_torch.launch import (
        TOP_K,
        assert_topk_agrees,
        sasrec_retrieval_step,
        sasrec_serve_step,
    )
    from repro_torch.models import sasrec
    from repro_torch.tuning import HBM_BYTES_PER_S

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    check(torch.get_float32_matmul_precision() == "highest", "float32 products must be full")
    stats["kernel 5"] = 0
    err, exact = compare_embedding_bag(dev, stats)
    log(f"[11] kernel 5 == plain on the card in {stats['kernel 5']} cases: all {exact} "
        f"bag-sum cases bit for bit ({len(BAG_SHAPES) * 8} at BAG_SHAPES, "
        f"{len(BAG_ONE_B) * len(BAG_ONE_ROWS) * 2} bags-of-one cases with -0.0 planted), "
        f"bags of one and take_rows exactly the rows; max abs err {err!r}")
    timing = {name: time_embedding_bag(dev, name, *shape) for name, shape in BAG_TIMED.items()}
    for name, t in timing.items():
        log(f"[11] kernel 5 at {name} (V,D,B,L)={t['shape']} float32: kernel {t['ms']!r} ms, "
            f"plain {t['plain_ms']!r} ms, yardstick {t['library_ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms ({t['bytes']} B at {HBM_BYTES_PER_S / 1e12} TB/s, "
            f"{t['valid']} valid slots); against plain max abs err {t['err']!r} (bit for bit "
            f"{t['exact']}), yardstick {t['lib_err']!r}")

    # (c) serve_p99 at full width, the registry's cell
    cells = get_arch("sasrec").cells()
    cfg = cells["serve_p99"].model_cfg
    users = cells["serve_p99"].batch_specs["seq"].shape[0]
    log(f"[11] from the registry: serve_p99 {users} users (the cell's "
        f"{cells['serve_p99'].batch_specs['seq'].shape}, no cut), retrieval_cand "
        f"{cells['retrieval_cand'].batch_specs['candidates'].shape} candidates (no cut)")
    params = sasrec.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    digest = tensor_digest(params["item_emb"])
    batch = make_sasrec_batch_fn(cfg.vocab, users, cfg.seq_len, device=dev)(SEED)
    sasrec_serve_step(params, batch, cfg)  # warm-up: cuBLAS and top-k workspaces
    embedding_bag_sums.launches = 0
    serve_s, top = timed_calls(lambda: sasrec_serve_step(params, batch, cfg))
    launches_c = embedding_bag_sums.launches
    check(launches_c == RECSYS_CALLS,
          f"serve_p99: {launches_c} kernel 5 launches in {RECSYS_CALLS} calls")
    check(top["values"].shape == (users, TOP_K) and bool(torch.isfinite(top["values"]).all()),
          "serve_p99: top-k values not finite or of the wrong shape")
    full = sasrec.serve_scores(params, batch, cfg)[:CHECK_USERS].clone()
    host = sasrec.params_to(params, "cpu")
    few = {"seq": batch["seq"][:CHECK_USERS].cpu()}
    want_scores = sasrec.serve_scores(host, few, cfg)
    score_err = float((full.cpu() - want_scores).abs().max())
    torch.testing.assert_close(full.cpu(), want_scores, rtol=SCORE_TOL, atol=SCORE_TOL,
                               msg="serve_p99 scores against the CPU route")
    want_top = sasrec_serve_step(host, few, cfg)
    ties = assert_topk_agrees({k: v[:CHECK_USERS].cpu() for k, v in top.items()}, want_top,
                              want_scores, SCORE_TOL, "serve_p99 top-100")
    ms_c = statistics.median(serve_s) * 1e3
    flops = 2 * users * cfg.vocab * cfg.embed_dim
    nbytes = (cfg.vocab + users) * cfg.embed_dim * 4 + users * cfg.vocab * 4
    bound_c = max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    prof_c = profile_run(lambda: sasrec_serve_step(params, batch, cfg))
    log(f"[11] {cfg.name} serve_p99: {users} users x {cfg.vocab} items, {RECSYS_CALLS} calls: "
        f"{ms_c:.3f} ms a batch (median; each: "
        f"{', '.join(f'{s * 1e3:.3f}' for s in serve_s)}) = {users / (ms_c / 1e3):.1f} users/s; "
        f"catalog product bound {bound_c:.3f} ms ({flops} flops at {F32_FLOPS / 1e12} TFLOP/s, "
        f"{nbytes} B); kernel 5 launches {launches_c} = 1 x {RECSYS_CALLS}; first {CHECK_USERS} "
        f"users "
        f"against the CPU route: scores max abs diff {score_err!r} (tolerance {SCORE_TOL}), "
        f"top-{TOP_K} near-tie swaps {ties}")
    log_profile("11 serve_p99", prof_c, ms_c)
    del top

    # (d) retrieval_cand at full width: user 0 of (c) against 1,000,448 candidates
    n_cand = cells["retrieval_cand"].batch_specs["candidates"].shape[1]
    query = {"seq": batch["seq"][:1],
             "candidates": make_candidates(torch.Generator(dev).manual_seed(SEED + 1), 1, n_cand,
                                           cfg.vocab, device=dev)}
    sasrec_retrieval_step(params, query, cfg)  # warm-up
    embedding_bag_sums.launches = 0
    ret_s, scores = timed_calls(lambda: sasrec_retrieval_step(params, query, cfg))
    launches_d = embedding_bag_sums.launches
    check(launches_d == 2 * RECSYS_CALLS, f"retrieval_cand: {launches_d} kernel 5 launches in "
                                   f"{RECSYS_CALLS} calls, not 2 x {RECSYS_CALLS}")
    check(scores.shape == (1, n_cand) and bool(torch.isfinite(scores).all()),
          "retrieval_cand: scores not finite or of the wrong shape")
    want_ret = sasrec_retrieval_step(host, {k: v.cpu() for k, v in query.items()}, cfg)
    ret_err = float((scores.cpu() - want_ret).abs().max())
    torch.testing.assert_close(scores.cpu(), want_ret, rtol=SCORE_TOL, atol=SCORE_TOL,
                               msg="retrieval_cand against the CPU route")
    at_items = full[:1].gather(1, query["candidates"].long())
    cross_err = float((scores - at_items).abs().max())
    torch.testing.assert_close(scores, at_items, rtol=SCORE_TOL, atol=SCORE_TOL,
                               msg="retrieval_cand against serve_p99's scores at the same items")
    ms_d = statistics.median(ret_s) * 1e3
    ret_bytes = n_cand * (4 + cfg.embed_dim * 4 + 4)
    prof_d = profile_run(lambda: sasrec_retrieval_step(params, query, cfg))
    log(f"[11] {cfg.name} retrieval_cand: 1 query x {n_cand} candidates, {RECSYS_CALLS} calls: "
        f"{ms_d:.3f} ms a query (median; each: {', '.join(f'{s * 1e3:.3f}' for s in ret_s)}); "
        f"bytes bound {ret_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({ret_bytes} B: ids, rows, "
        f"scores); kernel 5 launches {launches_d} = 2 x {RECSYS_CALLS}; against the CPU route "
        f"max abs "
        f"diff {ret_err!r}, against serve_p99's full-catalog scores at the same items "
        f"{cross_err!r} (tolerance {SCORE_TOL})")
    log_profile("11 retrieval_cand", prof_d, ms_d)

    # (e) the item table, SASRec's large memory, is never written
    check(tensor_digest(params["item_emb"]) == digest, "SASRec's item table changed")
    log(f"[11] item_emb unchanged (SHA-256 before and after the phase); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    del params, host, batch, full, scores, query
    torch.cuda.empty_cache()
    t = timing["retrieval"]
    return {
        "name": "embedding_bag",
        "route": "cuda",
        "source": KERNEL_SOURCES["embedding_bag"],
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:38",
        "launches": launches_c + launches_d,
        "max_abs_err": max(err, *(x["err"] for x in timing.values())),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
    }


# ----------------------------------------------------------------------
# phase 12: connectivity, personalized PageRank and the serving tier
# ----------------------------------------------------------------------
def components_scipy(csr):
    """Weak components of a host CSR by scipy, each labelled by its min vertex id."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = csr.n
    src, dst = csr.edge_src.numpy(), csr.edge_dst.numpy()
    ok = dst < n
    a = sp.csr_matrix((np.ones(int(ok.sum()), np.int8), (src[ok], dst[ok])), shape=(n, n))
    _, lab = connected_components(a, directed=True, connection="weak")
    rep = np.full(int(lab.max()) + 1, n, np.int64)
    np.minimum.at(rep, lab, np.arange(n))
    return rep[lab]


def ppr_power_iteration(csr, srcs, alpha=0.15, tol=1e-12, iters=2000):
    """``ppr_matrix_oracle``'s equation π = α·e_s + (1−α)·Wᵀ(π/deg), solved by
    scipy power iteration in float64 for every source at once: (n, len(srcs))."""
    import numpy as np
    import scipy.sparse as sp

    n = csr.n
    src, dst = csr.edge_src.numpy(), csr.edge_dst.numpy()
    ok = dst < n
    at = sp.csr_matrix((np.ones(int(ok.sum())), (dst[ok], src[ok])), shape=(n, n))
    deg = np.maximum(np.bincount(src[ok], minlength=n), 1).astype(np.float64)
    e = np.zeros((n, len(srcs)))
    e[srcs, np.arange(len(srcs))] = 1.0
    pi = e.copy()
    for _ in range(iters):
        new = alpha * e + (1 - alpha) * (at @ (pi / deg[:, None]))
        if np.abs(new - pi).sum(axis=0).max() < tol:
            return new
        pi = new
    return pi


def same_ppr(a, b, deg, oracle, eps, max_rounds, what):
    """Phase 12(c)'s rule for two PPR results (p, r, rounds) of one source:
    equal rounds, then p and r within ``PR_ATOL``; else both converged and
    both within the ACL bound |p − π| ≤ eps·deg of π = ``oracle()`` (only
    then computed).  Returns the max abs difference of p."""
    import numpy as np

    (pa, ra, na), (pb, rb, nb) = [(t[0].cpu(), t[1].cpu(), int(t[2])) for t in (a, b)]
    err = float((pa - pb).abs().max())
    if na == nb:
        check(err <= PR_ATOL and float((ra - rb).abs().max()) <= PR_ATOL,
              f"{what}: p differs by {err} in {na} rounds")
        return err
    bound = eps * deg.numpy() + 1e-7   # float32 p against a float64 oracle
    pi = oracle()
    log(f"{what}: {na} against {nb} rounds; both runs are held to the ACL bound")
    for p, r, k in ((pa, ra, na), (pb, rb, nb)):
        check(k < max_rounds and not bool((r >= eps * deg).any()),
              f"{what}: {na} against {nb} rounds, and a run did not converge")
        check(bool((np.abs(p.double().numpy() - pi) <= bound).all()),
              f"{what}: {na} against {nb} rounds, and a run misses the ACL bound")
    return err


def service_stream(svc, srcs, *, ppr=SERVICE_PPR):
    """Phase 12(d)'s virtual-time stream over ``svc``, ``len(srcs)`` >= 16
    requests: a burst of 8 at time 0 with a tick after each (the depth
    trigger), a trickle 0.01 apart with a tick after each arrival (deadline
    flushes), the last 8 at once and a drain (a forced flush), then drains
    far later, whose refills readmit what the capped tenant had deferred.
    Ops cycle BFS, wBFS, BFS, PPR; every third BFS comes from the capped
    tenant.  Returns the tickets."""
    ops = ("bfs", "wbfs", "bfs", "ppr")
    tickets, k = [], len(srcs)
    for i, s in enumerate(srcs):
        op = ops[i % 4]
        tenant = "capped" if op == "bfs" and i % 3 == 0 else "open"
        now = 0.0 if i < 8 else 0.01 * (min(i, k - 8) - 7)
        params = dict(ppr) if op == "ppr" else {}
        tickets.append(svc.submit(op, src=s, tenant=tenant, now=now, **params))
        if i < k - 8:
            svc.tick(now)
    svc.drain(0.01 * (k - 15))
    for now in (100.0, 200.0, 300.0):
        svc.drain(now)
    return tickets


def same_tickets(card, cpu, deg, pi_of, what):
    """Card tickets against the CPU route's: status, times, rounds, words and
    estimates equal; BFS and wBFS results bit for bit; PPR by (c)'s rule."""
    import torch

    check(len(card) == len(cpu), f"{what}: ticket counts differ")
    for t, c in zip(card, cpu):
        for f in ("id", "op", "tenant", "status", "arrival", "deadline", "finished_at", "rounds",
                  "words", "est_words"):
            check(getattr(t, f) == getattr(c, f),
                  f"{what}: ticket {t.id} {f} {getattr(t, f)!r} != {getattr(c, f)!r}")
        if t.result is None or c.result is None:
            check(t.result is None and c.result is None and t.status == "rejected",
                  f"{what}: ticket {t.id} has no result")
        elif t.op == "bfs":
            check(torch.equal(t.result[0].cpu(), c.result[0])
                  and torch.equal(t.result[1].cpu(), c.result[1]),
                  f"{what}: BFS ticket {t.id} differs from the CPU route")
        elif t.op == "wbfs":
            check(torch.equal(t.result.cpu(), c.result),
                  f"{what}: wBFS ticket {t.id} differs from the CPU route")
        else:
            same_ppr(t.result, c.result, deg, lambda: pi_of(t.params["src"]), t.params["eps"],
                     t.params["max_rounds"], f"{what}: PPR ticket {t.id}")


def same_service(svc, cpu, what):
    """``stats``, ledgers, cache miss counts and the PSAM account equal."""
    check(svc.stats == cpu.stats, f"{what}: stats {svc.stats} != {cpu.stats}")
    check(svc.engine.stats == cpu.engine.stats, f"{what}: engine stats differ")
    led = {k: vars(v) for k, v in svc.ledgers.items()}
    check(led == {k: vars(v) for k, v in cpu.ledgers.items()}, f"{what}: ledgers differ")
    check(svc.trace_counts == cpu.trace_counts, f"{what}: trace_counts differ")
    check((svc.cost.large_reads, svc.cost.small_ops) == (cpu.cost.large_reads,
                                                         cpu.cost.small_ops),
          f"{what}: PSAM accounts differ")


def drive_serving_tier(dev, A_, B_):
    """Phase 12: connectivity on graphs B and A, PPR through the engine and
    the ServingService on graph B, each held to the CPU route (and scipy).
    Returns kernel 1's launches on these paths, (decode, fused)."""
    import numpy as np
    import torch

    import repro_torch.kernels.compressed_spmv.ops as ops
    from repro_torch.algorithms import (
        bfs,
        connectivity,
        ldd,
        personalized_pagerank,
        wbfs,
    )
    from repro_torch.algorithms.decomposition import ldd_shift
    from repro_torch.core import edgemap_reduce, make_plan
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round
    from repro_torch.obs import noop_registry
    from repro_torch.serving import QueryEngine, ServiceConfig, ServingService

    gB, hB, gA = B_.dev, B_.host, A_.dev
    plan_b = make_plan(gB, strategy="sparse_streamed")
    plan_cpu = make_plan(hB, strategy="sparse_streamed")
    on_card = dev.type == "cuda"
    total = [0, 0]

    def reset():
        compressed_chunked_spmv.launches = 0
        compressed_stream_round.launches = 0

    def read():
        got = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
        total[0] += got[0]
        total[1] += got[1]
        return got

    # (a) connectivity on graph B under a sparse_streamed plan
    shift = ldd_shift(gB.n, LDD_BETA, torch.Generator(device=dev).manual_seed(SEED))
    r0 = rounds_of("ldd")
    reset()
    ts = time.perf_counter()
    clusters = ldd(gB, LDD_BETA, shift=shift, plan=plan_b)
    torch.cuda.synchronize()
    ldd_s = time.perf_counter() - ts
    ldd_launches = read()
    ldd_rounds = rounds_of("ldd") - r0
    check(torch.equal(clusters.cpu(), ldd(hB, LDD_BETA, shift=shift.cpu(), plan=plan_cpu)),
          "graph B ldd: the card's clusters differ from the CPU route's on the same shift")
    if on_card:
        check(ldd_launches == (0, ldd_rounds),
              f"graph B ldd: kernel 1 launches (decode, fused) {ldd_launches} in {ldd_rounds} "
              "rounds, not one fused launch a round")
    want_b = components_scipy(B_.host_csr)
    r0, p0 = rounds_of("ldd"), rounds_of("min_label_prop")
    reset()
    ts = time.perf_counter()
    labels = connectivity(gB, torch.Generator(device=dev).manual_seed(SEED + 1), plan=plan_b)
    torch.cuda.synchronize()
    conn_s = time.perf_counter() - ts
    conn_launches = read()
    conn_ldd, conn_prop = rounds_of("ldd") - r0, rounds_of("min_label_prop") - p0
    labels_cpu = connectivity(hB, torch.Generator().manual_seed(SEED + 2), plan=plan_cpu)
    check(torch.equal(labels.cpu(), labels_cpu), "graph B connectivity differs from the CPU route")
    check(np.array_equal(labels_cpu.numpy(), want_b), "graph B connectivity differs from scipy")
    if on_card:
        check(conn_launches == (0, conn_ldd),
              f"graph B connectivity: kernel 1 launches {conn_launches}, ldd rounds {conn_ldd}")
    log(f"[12] graph B ldd (beta {LDD_BETA}, shift drawn on the card): {ldd_rounds} rounds, "
        f"{int(torch.unique(clusters).numel())} clusters, kernel 1 launches: decode "
        f"{ldd_launches[0]}, fused {ldd_launches[1]}; wall {ldd_s:.3f} s; equal to the CPU "
        "route on the same shift, bit for bit")
    log(f"[12] graph B connectivity: {len(np.unique(want_b))} components, ldd {conn_ldd} rounds "
        f"+ {conn_prop} label-propagation rounds (dense), kernel 1 launches: decode "
        f"{conn_launches[0]}, fused {conn_launches[1]}; wall {conn_s:.3f} s; equal to the CPU "
        "route and to scipy")

    # (b) connectivity on graph A, the full configuration (exception-dense)
    plan_a = make_plan(gA, strategy="auto")
    r0, p0 = rounds_of("ldd"), rounds_of("min_label_prop")
    reset()
    ts = time.perf_counter()
    labels_a = connectivity(gA, torch.Generator(device=dev).manual_seed(SEED), plan=plan_a)
    torch.cuda.synchronize()
    conn_a_s = time.perf_counter() - ts
    a_launches = read()
    a_ldd, a_prop = rounds_of("ldd") - r0, rounds_of("min_label_prop") - p0
    want_a = components_scipy(A_.host_csr)
    check(np.array_equal(labels_a.cpu().numpy(), want_a), "graph A connectivity differs from scipy")
    check(a_launches == (0, 0), f"graph A is exception-dense: kernel 1 launches {a_launches}")
    log(f"[12] graph A connectivity: {len(np.unique(want_a))} components, ldd {a_ldd} rounds + "
        f"{a_prop} label-propagation rounds (dense), kernel 1 launches 0 (exception-dense); "
        f"wall {conn_a_s:.3f} s; equal to scipy")
    full = torch.ones(gA.n, dtype=torch.bool, device=dev)

    def prop_round():
        nbr, _ = edgemap_reduce(gA, full, labels_a, monoid="min", mode="dense", plan=plan_a)
        new = torch.minimum(labels_a, nbr)
        new = new[new.long()]
        return new[new.long()]

    prop_round()   # an untimed warm call
    torch.cuda.synchronize()
    ts = time.perf_counter()
    prop_round()
    torch.cuda.synchronize()
    log_profile("12 graph A label-propagation round", profile_run(prop_round),
                (time.perf_counter() - ts) * 1e3)

    # (c) PPR through the QueryEngine on graph B
    srcs = sources(gB, PPR_SOURCES, SEED + 3)
    reqs = [("ppr", {"src": s, "max_rounds": PPR_ROUNDS, "eps": PPR_EPS}) for s in srcs]
    engine = QueryEngine(gB, plan=plan_b, max_batch=PPR_SOURCES)
    reset()
    ts = time.perf_counter()
    got = engine.serve(reqs)
    torch.cuda.synchronize()
    ppr_s = time.perf_counter() - ts
    ppr_launches = read()
    cpu = QueryEngine(hB, plan=plan_cpu, max_batch=PPR_SOURCES).serve(reqs)
    deg = hB.degrees.clamp(min=1).to(torch.float32)
    pis_d = {}

    def pi_of(s):
        if s not in pis_d:
            pis_d[s] = ppr_power_iteration(B_.host_csr, [s])[:, 0]
        return pis_d[s]

    err_cpu = err_single = 0.0
    for i, s in enumerate(srcs):
        err_cpu = max(err_cpu, same_ppr(got[i], cpu[i], deg, lambda: pi_of(s), PPR_EPS,
                                        PPR_ROUNDS, f"graph B PPR from {s} against the CPU "
                                        "route"))
        single = personalized_pagerank(gB, s, eps=PPR_EPS, max_rounds=PPR_ROUNDS, plan=plan_b)
        err_single = max(err_single, same_ppr(got[i], single, deg, lambda: pi_of(s), PPR_EPS,
                                              PPR_ROUNDS, f"graph B PPR lane {s}"))
    rounds = [int(r[2]) for r in got]
    if on_card:
        check(ppr_launches[0] > 0 and ppr_launches[1] == 0,
              f"graph B PPR (float sums): kernel 1 launches (decode, fused) {ppr_launches}")
    log(f"[12] graph B PPR, {PPR_SOURCES} sources batched through the engine (eps {PPR_EPS}, "
        f"max_rounds {PPR_ROUNDS}): rounds {rounds} (CPU route {[int(r[2]) for r in cpu]}), "
        f"{len(reqs) / ppr_s:.2f} queries/s ({ppr_s:.3f} s), kernel 1 launches: decode "
        f"{ppr_launches[0]}, fused {ppr_launches[1]}; max abs diff of p to the CPU route "
        f"{err_cpu!r}, to the single runs {err_single!r} (atol {PR_ATOL} at equal rounds, else "
        "both converged within the ACL bound)")

    # (d) the ServingService on graph B
    round_words = plan_b.edge_read_words_per_round(gB)
    budgets = {"capped": (1.5 * round_words, 1.5 * round_words)}  # words, words a time unit
    stream_srcs = sources(gB, SERVICE_REQUESTS, SEED + 4)
    seen = []
    plain_round = ops.compressed_stream_round

    def watched(*args, **kwargs):
        ml = kwargs.get("map_lanes")
        if ml is not None:
            seen.append((ml.dtype == torch.bool and ml.device == dev and ml.is_contiguous()
                         and tuple(ml.shape) == (args[0].shape[0],)))
        return plain_round(*args, **kwargs)

    served = {}
    for admission, k in (("defer", SERVICE_REQUESTS), ("reject", SERVICE_HELD)):
        cfg = ServiceConfig(slo=0.05, max_batch=8, depth_trigger=6, round_quantum=2,
                            admission=admission, budgets=budgets)
        svc = ServingService(gB, plan=plan_b, config=cfg, registry=noop_registry())
        reads0 = svc.cost.large_reads
        ops.compressed_stream_round = watched
        reset()
        try:
            ts = time.perf_counter()
            tickets = service_stream(svc, stream_srcs[:k])
            torch.cuda.synchronize()
            secs = time.perf_counter() - ts
        finally:
            ops.compressed_stream_round = plain_round
        launches = read()
        what = f"graph B service ({admission})"
        # the CPU route serves the first SERVICE_HELD requests only (its
        # graph B sweeps take ~2 s each); a stream's tickets depend on the
        # whole stream, so a card service serves the same shorter stream
        held_svc, held_tickets = svc, tickets
        if k > SERVICE_HELD:
            held_svc = ServingService(gB, plan=plan_b, config=cfg, registry=noop_registry())
            reset()
            held_tickets = service_stream(held_svc, stream_srcs[:SERVICE_HELD])
            read()
        svc_cpu = ServingService(hB, plan=plan_cpu, config=cfg, registry=noop_registry())
        tickets_cpu = service_stream(svc_cpu, stream_srcs[:SERVICE_HELD])
        same_tickets(held_tickets, tickets_cpu, deg, pi_of,
                     f"{what}, first {SERVICE_HELD} requests")
        same_service(held_svc, svc_cpu, f"{what}, first {SERVICE_HELD} requests")
        for t in tickets:
            if t.result is None:
                continue
            if t.op == "bfs":
                want = bfs(gB, t.params["src"], plan=plan_b)
                check(torch.equal(t.result[0], want[0]) and torch.equal(t.result[1], want[1]),
                      f"{what}: BFS ticket {t.id} differs from its single run")
            elif t.op == "wbfs":
                check(torch.equal(t.result, wbfs(gB, t.params["src"], plan=plan_b)),
                      f"{what}: wBFS ticket {t.id} differs from its single run")
        words = sum(t.words for t in tickets)
        delta = svc.cost.large_reads - reads0
        check(abs(words - delta) <= 1e-9 * delta,
              f"{what}: tickets' words {words} != the cost's read delta {delta}")
        st = svc.stats
        if on_card:
            check(0 < launches[1] <= st["cohort_rounds"] and launches[0] > 0,
                  f"{what}: kernel 1 launches (decode, fused) {launches} in "
                  f"{st['cohort_rounds']} cohort rounds")
        served[admission] = (svc, tickets, secs, launches)
        log(f"[12] {what}: {k} requests in {secs:.3f} s = {st['served'] / secs:.2f} served/s "
            f"of the drain loop; stats {st}; occupancy {svc.occupancy:.3f}; kernel 1 launches: "
            f"fused {launches[1]} in {st['cohort_rounds']} cohort rounds, decode {launches[0]} "
            f"(PPR); every traversal result equals its single run; ticket words sum to the "
            f"read delta ({delta} words); the first {SERVICE_HELD} requests' stream equals the "
            f"CPU route's (tickets, stats, ledgers, trace_counts, PSAM account)")
    st_d, st_r = served["defer"][0].stats, served["reject"][0].stats
    layouts = {key[3] for key in served["defer"][0].trace_counts}
    check(st_d["deadline_flushes"] and st_d["depth_flushes"] and st_d["forced_flushes"]
          and st_d["deferred"] and st_r["rejected"] and st_d["repacks"],
          f"the service stream did not fire every trigger: {st_d}, {st_r}")
    check(any(any(w) and not all(w) for w in layouts), "no mixed cohort ran")
    if on_card:
        check(seen and all(seen), f"map_lanes reached the fused round as {seen[:4]}...")
    log(f"[12] service: mixed cohorts {sum(1 for w in layouts if any(w) and not all(w))} lane "
        f"layouts, {len(seen)} fused launches with map_lanes (bool (B,) on the card, "
        f"contiguous, after every repack)")
    # one more flush, profiled: 8 mixed lanes
    svc = served["defer"][0]
    extra = sources(gB, 16, SEED + 5)
    for j, s in enumerate(extra[:8]):
        svc.submit(("bfs", "wbfs")[j % 2], src=s, now=1000.0)
    ts = time.perf_counter()
    svc.drain(1000.0)
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - ts) * 1e3

    def flush():
        for j, s in enumerate(extra[8:]):
            svc.submit(("bfs", "wbfs")[j % 2], src=s, now=2000.0)
        svc.drain(2000.0)

    log_profile("12 service flush", profile_run(flush), flush_ms)
    return tuple(total)


# ----------------------------------------------------------------------
# phase 13: the rest of Table 1 and the rest of the core
# ----------------------------------------------------------------------
def as_distances(d):
    """wBFS's int32 distances as Bellman-Ford's float32 (INF_I32 -> +inf)."""
    import torch

    return torch.where(d == 2**31 - 1, float("inf"), d.to(torch.float32))


def rel_err(got, want):
    """max|got − want| / max|want| (0 when both are 0)."""
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    return err / scale if scale else err


def widest_certificate(csr, src, width, dist):
    """Phase 13(b)'s check of a widest-path result, on the card: the source
    is +inf, every other vertex holds the best bottleneck over its in-edges,
    max over (u, v) of min(width[u], w), which is -inf exactly where
    Bellman-Ford found no path (``dist`` is +inf)."""
    import torch

    from repro_torch.core.primitives import segment_reduce, take_fill

    n = csr.n
    valid = csr.edge_dst < n
    cand = torch.minimum(take_fill(width, csr.edge_src, float("-inf")), csr.edge_w)
    cand = torch.where(valid, cand, float("-inf"))
    best = segment_reduce(cand, torch.where(valid, csr.edge_dst, n), n + 1, "max")[:n]
    best[src] = float("inf")
    check(torch.equal(best, width), "graph A widest path: a width is not the best bottleneck "
          "over its in-edges")
    check(torch.equal(width > float("-inf"), dist < float("inf")),
          "graph A widest path: the reached set differs from Bellman-Ford's")


def parents_are_neighbours(csr, parents):
    """Every non-root's parent edge (v, parents[v]) is an edge of ``csr``."""
    import torch

    from repro_torch.core.primitives import take_fill

    n = csr.n
    valid = csr.edge_dst < n
    hit = valid & (take_fill(parents, csr.edge_src, -1) == csr.edge_dst)
    has = torch.zeros(n + 1, dtype=torch.bool, device=csr.device)
    has[torch.where(hit, csr.edge_src, n).long()] = True
    ids = torch.arange(n, dtype=torch.int32, device=csr.device)
    return bool((has[:n] | (parents == ids)).all())


def run_example(name, argv):
    """``examples/<name>.py``'s ``main(argv)``; returns its printed lines."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    return out.getvalue().splitlines()


def drive_table1(dev, A_, B_, E_, kernel2_weighted_ms):
    """Phase 13: Bellman-Ford, widest path and betweenness on graphs B (kernel
    1's decode) and A (no kernel), the decomposition algorithms on graphs B
    and A, ``edgemap_sum_compressed`` on graphs B and E (kernel 2), and the
    graph-analytics example, each held to the CPU route, to wBFS, to scipy or
    to a certificate.  Returns kernel launches on these paths: (kernel 1's
    decode, its fused round, kernel 2)."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (
        bellman_ford,
        betweenness,
        biconnectivity,
        multi_source_bfs,
        spanner,
        spanning_forest,
        wbfs,
        widest_path,
    )
    from repro_torch.algorithms.decomposition import ldd_shift
    from repro_torch.core import edgemap_sum_compressed, filter_edges, make_filter, make_plan
    from repro_torch.kernels import (
        compressed_block_spmv,
        compressed_block_spmv_ref,
        compressed_chunked_spmv,
        compressed_stream_round,
    )
    from repro_torch.tuning import HBM_BYTES_PER_S

    gB, hB, gA = B_.dev, B_.host, A_.dev
    plan_b = make_plan(gB, strategy="sparse_streamed")
    plan_cpu = make_plan(hB, strategy="sparse_streamed")
    on_card = dev.type == "cuda"
    counters = (compressed_chunked_spmv, compressed_stream_round, compressed_block_spmv)
    total = [0, 0, 0]
    torch.cuda.reset_peak_memory_stats()

    def reset():
        for k in counters:
            k.launches = 0

    def read():
        got = tuple(k.launches for k in counters)
        for i, v in enumerate(got):
            total[i] += v
        return got

    def timed(fn):
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    # (a) graph B under the constants' sparse_streamed plan: kernel 1's decode
    srcs = sources(gB, T1_SOURCES, SEED + 6)
    bf_b = None
    for name, fn in (("bellman_ford", bellman_ford), ("widest_path", widest_path),
                     ("betweenness", betweenness)):
        r0 = rounds_of(name)
        reset()
        got, secs = timed(lambda: [fn(gB, s, plan=plan_b) for s in srcs])
        launches = read()
        rounds = rounds_of(name) - r0
        want, cpu_s = timed(lambda: [fn(hB, s, plan=plan_cpu) for s in srcs])
        if on_card:
            check(launches[0] > 0 and launches[1] == 0,
                  f"graph B {name}: kernel 1 launches (decode, fused) {launches[:2]}")
        err = 0.0
        for s, a, b in zip(srcs, got, want):
            if name == "bellman_ford":
                check(a[1] is b[1] is False, f"graph B Bellman-Ford from {s}: a negative cycle")
                a, b = a[0], b[0]
            if name == "betweenness":
                err = max(err, rel_err(a.cpu(), b))
                check(err <= BC_REL_TOL, f"graph B betweenness from {s}: relative error {err}")
            else:
                check(torch.equal(a.cpu(), b), f"graph B {name} from {s} differs from the CPU "
                      "route")
        if name == "bellman_ford":
            bf_b = got
        log(f"[13] graph B {name} from {len(srcs)} sources (sparse_streamed): {rounds} rounds, "
            f"wall {secs:.3f} s ({len(srcs) / secs:.2f} queries/s); kernel 1 launches: decode "
            f"{launches[0]}, fused {launches[1]}; "
            + ("max relative error to the CPU route " + repr(err) + f" (limit {BC_REL_TOL})"
               if name == "betweenness" else "equal to the CPU route bit for bit")
            + f"; CPU route {cpu_s:.1f} s")
    for s, (dist, _) in zip(srcs, bf_b):
        check(torch.equal(dist, as_distances(wbfs(gB, s, plan=plan_b))),
              f"graph B Bellman-Ford from {s} differs from wBFS")
    log(f"[13] graph B Bellman-Ford's distances equal wBFS's on the card from all "
        f"{len(srcs)} sources (integer weights), no negative cycle")

    # (b) graph A, the full configuration: exception-dense, no kernel
    plan_a = make_plan(gA, strategy="auto")
    s = sources(gA, 1, SEED + 7)[0]
    res = {}
    for name, fn in (("bellman_ford", bellman_ford), ("widest_path", widest_path),
                     ("betweenness", betweenness)):
        r0 = rounds_of(name)
        reset()
        res[name], secs = timed(lambda: fn(gA, s, plan=plan_a))
        launches = read()
        check(launches == (0, 0, 0), f"graph A {name}: kernel launches {launches}")
        log(f"[13] graph A {name} from {s} (auto plan): {rounds_of(name) - r0} rounds, wall "
            f"{secs:.3f} s, no kernel launch (exception-dense)")
    dist, neg = res["bellman_ford"]
    check(not neg and torch.equal(dist, as_distances(wbfs(gA, s, plan=plan_a))),
          "graph A Bellman-Ford differs from wBFS")
    widest_certificate(A_.csr, s, res["widest_path"], dist)
    want, cpu_s = timed(lambda: betweenness(A_.host, s, plan=make_plan(A_.host,
                                                                        strategy="auto")))
    err_a = rel_err(res["betweenness"].cpu(), want)
    check(err_a <= BC_REL_TOL, f"graph A betweenness: relative error {err_a}")
    log(f"[13] graph A from {s}: Bellman-Ford equals wBFS ({int((dist < float('inf')).sum())} "
        f"reached, no negative cycle); widest path passes its certificate on the card; "
        f"betweenness within {err_a!r} of the CPU route relatively (limit {BC_REL_TOL}; CPU "
        f"route {cpu_s:.1f} s)")

    # (c) the decomposition algorithms
    ids_b = torch.arange(gB.n, dtype=torch.int32, device=dev)
    (parents, labels), secs = timed(lambda: spanning_forest(gB))
    want = spanning_forest(hB)
    check(torch.equal(parents.cpu(), want[0]) and torch.equal(labels.cpu(), want[1]),
          "graph B spanning forest differs from the CPU route")
    reset()
    (mp, ml), ms_secs = timed(lambda: multi_source_bfs(gB, labels == ids_b, plan=plan_b))
    ms_launches = read()
    check(torch.equal(mp, parents), "graph B multi_source_bfs (plan) differs from the forest")
    wp, wl = multi_source_bfs(hB, (labels == ids_b).cpu(), plan=plan_cpu)
    check(torch.equal(mp.cpu(), wp) and torch.equal(ml.cpu(), wl),
          "graph B multi_source_bfs differs from the CPU route")
    if on_card:
        check(ms_launches[1] == int(ml.max()) + 1 and ms_launches[0] == 0,
              f"graph B multi_source_bfs: kernel 1 launches (decode, fused) {ms_launches[:2]}, "
              f"depth {int(ml.max())}")
    log(f"[13] graph B spanning forest: {int((parents == ids_b).sum())} trees, wall {secs:.3f} s; "
        f"multi_source_bfs from the roots (sparse_streamed): depth {int(ml.max())}, kernel 1 "
        f"launches: fused {ms_launches[1]}, decode {ms_launches[0]}, wall {ms_secs:.3f} s; both "
        "equal to the CPU route")
    p0 = rounds_of("min_label_prop")
    bic, secs = timed(lambda: biconnectivity(gB))
    prop = rounds_of("min_label_prop") - p0
    check(torch.equal(bic.cpu(), biconnectivity(hB)), "graph B biconnectivity differs from the "
          "CPU route")
    log(f"[13] graph B biconnectivity: {int(torch.unique(bic[bic >= 0]).numel())} labels, "
        f"{prop} label-propagation rounds (connectivity and the auxiliary graph), wall "
        f"{secs:.3f} s; equal to the CPU route bit for bit")
    beta = float(torch.tensor(float(gB.n + 1), dtype=torch.float32).log()) / (2.0 * SPANNER_K)
    shift = ldd_shift(gB.n, beta, torch.Generator(device=dev).manual_seed(SEED))
    (mask, ok), secs = timed(lambda: spanner(gB, SPANNER_K, shift=shift))
    want = spanner(hB, SPANNER_K, shift=shift.cpu())
    check(torch.equal(mask.cpu(), want[0]) and ok == want[1],
          "graph B spanner differs from the CPU route on the same shift")
    log(f"[13] graph B spanner (k={SPANNER_K}, shift drawn on the card): ok {ok}, "
        f"{int(mask.sum()) // 2} of {gB.m // 2} edges kept, wall {secs:.3f} s; equal to the CPU "
        "route on the same shift")
    want_a = components_scipy(A_.host_csr)
    (parents, labels), secs = timed(lambda: spanning_forest(gA))
    ids_a = torch.arange(gA.n, dtype=torch.int32, device=dev)
    check(np.array_equal(labels.cpu().numpy(), want_a), "graph A spanning forest: labels differ "
          "from scipy's components")
    check(int((parents == ids_a).sum()) == len(np.unique(want_a))
          and parents_are_neighbours(A_.csr, parents),
          "graph A spanning forest: a root count or a parent edge is wrong")
    log(f"[13] graph A spanning forest: {len(np.unique(want_a))} trees, labels equal scipy's, "
        f"every parent a neighbour; wall {secs:.3f} s")
    p0 = rounds_of("min_label_prop")
    reset()
    bic, secs = timed(lambda: biconnectivity(gA))
    launches = read()
    prop = rounds_of("min_label_prop") - p0
    valid = gA.edge_valid
    check(torch.equal(bic >= 0, valid) and bool((bic < gA.n).all()) and launches == (0, 0, 0),
          "graph A biconnectivity: labels off the valid slots, or a kernel launch")
    log(f"[13] graph A biconnectivity: {int(torch.unique(bic[valid]).numel())} labels, {prop} "
        f"label-propagation rounds, wall {secs:.3f} s, no kernel launch")
    del bic, valid, mask, shift
    peak = torch.cuda.max_memory_allocated() / 2**30

    # (d) edgemap_sum_compressed: kernel 2 without weights
    keep = gB.edge_valid & (gB.edge_dst % 3 != 0)
    f_b, _ = filter_edges(gB, make_filter(gB), keep)
    f_cpu, _ = filter_edges(hB, make_filter(hB), keep.cpu())
    gen = torch.Generator().manual_seed(SEED + 8)
    err_sum, calls = 0.0, 0
    for G, tag in ((B_, "B"), (E_, "E")):
        for x in (torch.rand(G.dev.n, generator=gen),
                  torch.randint(-9, 10, (G.dev.n,), dtype=torch.int32, generator=gen)):
            for ea, ea_cpu in ((None, None), (f_b, f_cpu)) if tag == "B" else ((None, None),):
                reset()
                got = edgemap_sum_compressed(G.dev, x.to(dev), edge_active=ea)
                launches = read()
                if on_card:
                    check(launches == (0, 0, 1), f"graph {tag} edgemap_sum_compressed: "
                          f"kernel launches {launches}, not one kernel 2 launch")
                want = edgemap_sum_compressed(G.host, x, edge_active=ea_cpu)
                err_sum = max(err_sum, sums_err(got.cpu(), want, x.dtype == torch.int32,
                                                f"graph {tag} edgemap_sum_compressed"))
                calls += 1
    x = torch.rand(gB.n, generator=gen).to(dev)
    bits = make_filter(gB).bits
    a2 = (gB.block_first, gB.deltas, gB.valid_count, bits, None, None)
    A = cusparse_matrix(B_.csr)
    ones = torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(),
                                   torch.ones_like(A.values()), size=A.shape)
    xt = x[:, None]
    t2 = check_bound("kernel 2 unweighted", dict(
        ms=device_ms(lambda: compressed_block_spmv(x, *a2, n=gB.n, tile_blocks=TILE)),
        plain_ms=device_ms(lambda: compressed_block_spmv_ref(x, *a2, n=gB.n), runs=5,
                           per_run=3),
        library_ms=device_ms(lambda: ones @ xt),
        bound_ms=spmv_bytes(gB, 1, "compressed", weighted=False) / HBM_BYTES_PER_S * 1e3,
    ))
    call_ms = device_ms(lambda: edgemap_sum_compressed(gB, x))
    log(f"[13] edgemap_sum_compressed == its plain version in {calls} cases (graph B with and "
        f"without a GraphFilter, graph E's exception rows; float32 rtol {SUM_RTOL}, int32 "
        f"exact), one kernel 2 launch a call; max abs err {err_sum!r}")
    log(f"[13] kernel 2 unweighted on graph B (B=1, TB={TILE}): kernel {t2['ms']!r} ms, plain "
        f"{t2['plain_ms']!r} ms, cuSPARSE (unit values) {t2['library_ms']!r} ms, bound "
        f"{t2['bound_ms']!r} ms; weighted (phase 2) {kernel2_weighted_ms!r} ms; the whole "
        f"edgemap_sum_compressed call {call_ms!r} ms of device time")

    # (e) the graph-analytics example on the card
    argv = [] if on_card else ["--device", "cpu"]
    lines, secs = timed(lambda: run_example("graph_analytics_torch", argv))
    check(len(lines) == 7 and ("route=cuda" in lines[0]) == on_card,
          f"the example printed {lines}")
    for line in lines:
        log(f"[13] example: {line}")
    log(f"[13] examples/graph_analytics_torch.py on the card: wall {secs:.1f} s; peak device "
        f"memory of the phase {peak:.2f} GiB")
    return tuple(total)


# ----------------------------------------------------------------------
# phase 14: sharded execution on one card
# ----------------------------------------------------------------------
PR_SHARD_REL_TOL = 1e-5   # float32 PageRank, shard sums combined in another order
PR_BF16_REL_TOL = 2**-5   # PageRank combined in bfloat16: 8-bit shard sums, 10 iterations


def same_tensors(a, b, what):
    """Every tensor field of two graphs or filters equal, bit for bit."""
    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"{what}: {f.name}")
        else:
            check(x == y, f"{what}: {f.name} {x!r} != {y!r}")


def rel_max(got, want):
    """max |got - want| / max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def drive_sharding(dev, A_, B_, E_, srcs, reqs, phase5_qps):
    """Phase 14: sharded execution, every mesh on ``dev`` repeated.  Returns
    (kernel 1 decode launches, fused launches, kernel 4 launches) of its
    paths, each read around the path that makes it."""
    import torch

    from repro_torch.algorithms import bfs, kcore, pagerank, set_cover, wbfs
    from repro_torch.core import edgemap_reduce, make_filter, make_mesh, make_plan
    from repro_torch.distributed import distributed_pagerank_step
    from repro_torch.kernels import (
        compressed_chunked_spmv,
        compressed_stream_round,
        filter_pack_words,
    )
    from repro_torch.serving import QueryEngine

    def mesh(*shape):
        return make_mesh(shape, ("pod", "data")[-len(shape):], devices=[dev] * math.prod(shape))

    def k1():
        return compressed_chunked_spmv.launches, compressed_stream_round.launches

    def since(before):
        now = k1()
        return now[0] - before[0], now[1] - before[1]

    def timed(fn):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    on_card = dev.type == "cuda"   # the CPU route (a rehearsal) launches nothing
    torch.cuda.reset_peak_memory_stats()
    decode = fused = packs = 0
    # (a) the shard split on the card equals the CPU route's, bit for bit
    cases = 0
    for G, tag in ((B_, "B"), (E_, "E")):
        fd, fh = make_filter(G.dev), make_filter(G.host)
        for k in (2, 3, 4):
            for a, b in ((G.dev, G.host), (G.csr, G.host_csr), (fd, fh)):
                for i, (x, y) in enumerate(zip(a.shard(k), b.shard(k))):
                    same_tensors(x, y, f"graph {tag} {type(a).__name__}.shard({k})[{i}]")
                    cases += 1
        per = -(-G.dev.num_blocks // 4)
        padded = [int((s.exc_block == per).sum()) for s in G.dev.shard(4)]
        log(f"[14] graph {tag}: NB={G.dev.num_blocks} (mod 3 = {G.dev.num_blocks % 3}); "
            f"k=4 shards hold {[s.n_exceptions for s in G.dev.shard(4)]} exception rows each, "
            f"of which {padded} are padding")
        if tag == "E":
            check(any(padded), "graph E's k=4 shards carry no padded exception row")
    log(f"[14] CompressedCSR, CSRGraph and GraphFilter .shard(k), k = 2, 3, 4, on the card "
        f"equal the CPU route's in {cases} shards, bit for bit")

    # (b) kernel 1 on shards: BFS and wBFS (fused), k-core (decode)
    for G, tag in ((B_, "B"), (E_, "E")):
        g = G.dev
        single = make_plan(g, strategy="sparse_streamed")
        s = srcs[0] if tag == "B" else sources(g, 1, SEED + 5)[0]
        b0 = k1()
        (p1, l1), t_bfs = timed(lambda: bfs(g, s, plan=single))
        n_bfs = since(b0)
        b0 = k1()
        d1, t_wbfs = timed(lambda: wbfs(g, s, plan=single))
        n_wbfs = since(b0)
        rounds = int(l1.max()) + 1
        check(n_bfs == (0, rounds) or not on_card, f"graph {tag} single BFS launches {n_bfs}")
        for k in (2, 4):
            plan = make_plan(g, mesh=mesh(k), strategy="sparse_streamed")
            gs, t_prep = timed(lambda: plan.prepare(g))
            b0 = k1()
            (p, lv), t_sb = timed(lambda: bfs(gs, s, plan=plan))
            sb = since(b0)
            b0 = k1()
            d, t_sw = timed(lambda: wbfs(gs, s, plan=plan))
            sw = since(b0)
            decode += sb[0] + sw[0]
            fused += sb[1] + sw[1]
            check(torch.equal(p, p1) and torch.equal(lv, l1) and torch.equal(d, d1),
                  f"graph {tag} BFS/wBFS on a ({k},) mesh differ from one device")
            check(not on_card or (sb == (0, k * rounds) and sw == (0, k * n_wbfs[1])),
                  f"graph {tag} ({k},): kernel 1 launches (decode, fused) BFS {sb}, wBFS {sw}")
            log(f"[14] graph {tag} from {s}, mesh ({k},) sparse_streamed (prepare "
                f"{t_prep:.3f} s): BFS {rounds} rounds, {sb[1]} fused launches ({k} a round), "
                f"wall {t_sb:.3f} s (one device {t_bfs:.3f} s, {n_bfs[1]} launches); wBFS "
                f"{sw[1]} fused launches, wall {t_sw:.3f} s (one device {t_wbfs:.3f} s, "
                f"{n_wbfs[1]}); no decode launch; equal to one device bit for bit")
    gE = E_.dev
    single = make_plan(gE, strategy="sparse_streamed")
    b0 = k1()
    core1, t_core1 = timed(lambda: kcore(gE, plan=single))
    n_core1 = since(b0)
    for k in (2, 4):
        plan = make_plan(gE, mesh=mesh(k), strategy="sparse_streamed")
        b0 = k1()
        core, t_core = timed(lambda: kcore(gE, plan=plan))
        n_core = since(b0)
        decode += n_core[0]
        check(torch.equal(core, core1) and (not on_card or (n_core[0] > 0 and n_core[1] == 0)),
              f"graph E k-core on a ({k},) mesh: launches {n_core}, or differs")
        log(f"[14] graph E k-core, mesh ({k},) sparse_streamed (int32 sums: the chunk loop "
            f"over padded shard exception lists): {n_core[0]} decode launches, wall "
            f"{t_core:.3f} s (one device {n_core1[0]}, {t_core1:.3f} s); equal to one device")

    # (c) graph A at full width, 4 shards
    gA = A_.dev
    plan1 = make_plan(gA, strategy="auto")
    plan4 = make_plan(gA, mesh=mesh(4), strategy="auto")
    gsA, t_prep = timed(lambda: plan4.prepare(gA))
    digests = graph_digest(*gsA.shards)
    sA = sources(gA, 1, SEED)[0]
    (p1, l1), t1 = timed(lambda: bfs(gA, sA, plan=plan1))
    b0 = k1()
    (p4, l4), t4 = timed(lambda: bfs(gsA, sA, plan=plan4))
    check(since(b0) == (0, 0), "graph A (exception-dense) sharded BFS launched kernel 1")
    check(torch.equal(p4, p1) and torch.equal(l4, l1), "graph A BFS on (4,) differs")
    log(f"[14] graph A, mesh (4,): prepare {t_prep:.3f} s; BFS from {sA} ({int(l1.max())} "
        f"levels) equal to one device, wall {t4:.3f} s (one device {t1:.3f} s)")
    pr1, t_pr1 = timed(lambda: pagerank(gA, eps=0.0, max_iters=PR_ITERS, plan=plan1)[0])
    errs = {}
    for name, plan in (
        ("flat (4,)", plan4),
        ("hierarchical (2, 2)", make_plan(gA, mesh=mesh(2, 2), reduce_mode="hierarchical")),
        ("bfloat16 combine (4,)", make_plan(gA, mesh=mesh(4), state_dtype=torch.bfloat16)),
    ):
        g_in = gsA if plan.mesh.shape == (4,) else gA
        pr, t_pr = timed(lambda: pagerank(g_in, eps=0.0, max_iters=PR_ITERS, plan=plan)[0])
        err = rel_max(pr, pr1)
        tol = PR_BF16_REL_TOL if "bfloat16" in name else PR_SHARD_REL_TOL
        check(bool(torch.isfinite(pr).all()) and err <= tol,
              f"graph A PageRank {name}: max rel diff {err} over {tol}")
        errs[name] = err
        log(f"[14] graph A PageRank {PR_ITERS} iterations, {name}: max|diff| / max|pr| "
            f"{err!r} (limit {tol!r}), wall {t_pr:.3f} s (one device {t_pr1:.3f} s)")
    inv = 1.0 / gA.degrees.clamp(min=1).to(torch.float32)
    step = distributed_pagerank_step(plan4.mesh, n=gA.n)
    got, t_step = timed(lambda: step(gsA, pr1, inv))
    s1, _ = edgemap_reduce(gA, torch.ones(gA.n, dtype=torch.bool, device=dev), pr1 * inv,
                           monoid="sum", map_fn=lambda xs, w: xs * w, mode="dense")
    want = (1.0 - 0.85) / gA.n + 0.85 * s1
    err = rel_max(got, want)
    check(err <= PR_SHARD_REL_TOL, f"distributed_pagerank_step: max rel diff {err}")
    log(f"[14] graph A distributed_pagerank_step on (4,): max|diff| / max to one device's "
        f"weighted step {err!r}, wall {t_step:.3f} s")

    # (d) QueryEngine on a (4,) plan over graph B
    gB = B_.dev
    plan_b = make_plan(gB, strategy="sparse_streamed")
    plan_b4 = make_plan(gB, mesh=mesh(4), strategy="sparse_streamed")
    # in turns (one device, 4 shards, 4 shards, one device), each engine warm
    engines = {"one device": QueryEngine(gB, plan=plan_b, max_batch=8),
               "(4,)": QueryEngine(gB, plan=plan_b4, max_batch=8)}
    for e in engines.values():
        e.serve(reqs)
    qps = {name: [] for name in engines}
    for name in ("one device", "(4,)", "(4,)", "one device"):
        serve_s, launches, rounds = serve(engines[name], reqs, plan_b)
        qps[name].append(len(reqs) / serve_s)
        if name == "(4,)":
            sharded = launches
            fused += launches["fused"]
            # every round of every drained batch: one fused launch a shard
            check(not on_card or (launches["decode"] == 0
                                  and launches["fused"] == 4 * rounds),
                  f"engine on (4,): kernel 1 launches {launches} in {rounds} rounds")
    log(f"[14] engine on a (4,) plan, {len(reqs)} queries, warm, in turns: "
        f"{', '.join(f'{q:.2f}' for q in qps['(4,)'])} queries/s against one device's "
        f"{', '.join(f'{q:.2f}' for q in qps['one device'])} (phase 5, cold: {phase5_qps:.2f}); "
        f"fused launches {sharded['fused']} in {rounds} rounds a drain (4 a round), decode "
        f"{sharded['decode']}; "
        "every result equals its single-device run")

    # (e) set cover on graph E under a (2,) plan (kernel 4 on the global words)
    pri = torch.randperm(gE.n, generator=torch.Generator().manual_seed(SEED)).to(dev)
    sets = torch.arange(gE.n, device=dev) < gE.n // 3
    r0 = rounds_of("set_cover")
    want, t_sc1 = timed(lambda: set_cover(gE, sets, priorities=pri))
    rounds = rounds_of("set_cover") - r0
    b4 = filter_pack_words.launches
    got, t_sc = timed(lambda: set_cover(gE, sets, priorities=pri,
                                        plan=make_plan(gE, mesh=mesh(2))))
    n4 = filter_pack_words.launches - b4
    packs += n4
    check(torch.equal(got, want) and (not on_card or n4 == 1 + rounds),
          f"graph E set_cover on (2,): {n4} kernel 4 launches in {rounds} rounds, or differs")
    log(f"[14] graph E set_cover on a (2,) plan: equal to one device, {rounds} rounds, kernel 4 "
        f"launches {n4} (1 + rounds), wall {t_sc:.3f} s (one device {t_sc1:.3f} s)")

    # (f) a pipeline_rounds plan runs the sequential loop: same results, k launches a round
    seq = make_plan(gB, mesh=mesh(4), strategy="sparse_streamed")
    pipe = make_plan(gB, mesh=mesh(4), strategy="sparse_streamed", pipeline_rounds=True)
    gsB = seq.prepare(gB)
    (want_p, want_l), want_d = bfs(gsB, srcs[1], plan=seq), wbfs(gsB, srcs[1], plan=seq)
    b0 = k1()
    (p, lv), t_pb = timed(lambda: bfs(gsB, srcs[1], plan=pipe))
    n_pb = since(b0)
    b0 = k1()
    d, t_pw = timed(lambda: wbfs(gsB, srcs[1], plan=pipe))
    n_pw = since(b0)
    fused += n_pb[1] + n_pw[1]
    rounds = int(want_l.max()) + 1
    check(torch.equal(p, want_p) and torch.equal(lv, want_l) and torch.equal(d, want_d),
          "graph B: a pipeline_rounds plan differs from the sequential one")
    check(not on_card or (n_pb == (0, 4 * rounds) and n_pw[0] == 0 and n_pw[1] % 4 == 0),
          f"graph B pipeline_rounds plan: kernel 1 launches BFS {n_pb}, wBFS {n_pw}")
    log(f"[14] graph B on (4,), pipeline_rounds=True (runs the sequential loop): BFS and wBFS "
        f"equal bit for bit, fused launches {n_pb[1]} in {rounds} BFS rounds and {n_pw[1]} "
        f"for wBFS, wall {t_pb:.4f} s and {t_pw:.4f} s")
    check(graph_digest(*gsA.shards) == digests, "a graph A shard tensor changed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[14] graph A's shards unchanged (SHA-256); peak device memory of the phase "
        f"{peak:.2f} GiB")
    return decode, fused, packs, gsA


# ----------------------------------------------------------------------
# phase 15: mutable graphs and the observability layer
# ----------------------------------------------------------------------
EDITS_A = 4096            # phase 15(a): the edit script over graph A
MUT_EDITS = 512           # phase 15(b): edits in graph B's mutable service stream
MUT_E = (24, 128)         # phase 15(c): requests and edits of graph E's stream
MUT_SOURCES = 2           # BFS / wBFS sources over a DeltaGraph and its compaction (cut
                          # from 4 to make room for phases 4(b), 14(g) and 19)
MUT_CHUNK = 16384         # a mutable plan's chunk: a DeltaGraph streams no block, so a
                          # sparse_streamed round is the plain chunk loop, lane by lane
MUT_SWEEPS = 30           # the service trigger's hysteresis: compact after ~30 sweeps


def base_edges(csr):
    """(keys ``src * n + dst``, float32 weights) of a host CSR's real slots,
    in slot order (= key order): the independent reference's base set."""
    import numpy as np

    src, dst = csr.edge_src.numpy(), csr.edge_dst.numpy()
    ok = dst < csr.n
    return src[ok].astype(np.int64) * csr.n + dst[ok], csr.edge_w.numpy()[ok]


def edit_script(keys, w, n, count, seed):
    """``count`` edits cycling through: an insert of an absent edge, a delete
    of a present one, its re-insert at the old weight, another delete, its
    re-insert at a new weight, a self-loop, a delete of an absent edge, an
    insert of an absent edge.  Integer weights in [1, 20)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out, deleted = [], []
    for i in range(count):
        kind = i % 8
        if kind in (0, 7):
            u, v = (int(x) for x in rng.integers(0, n, 2))
            out.append(("insert", u, v, float(rng.integers(1, 20))))
        elif kind in (1, 3):
            j = int(rng.integers(0, keys.size))
            deleted.append((int(keys[j]), float(w[j])))
            out.append(("delete", int(keys[j]) // n, int(keys[j]) % n))
        elif kind in (2, 4):
            k, w0 = deleted.pop()
            out.append(("insert", k // n, k % n, w0 if kind == 2 else float(int(w0) % 19 + 1)))
        elif kind == 5:
            u = int(rng.integers(0, n))
            out.append(("insert", u, u, 1.0))
        else:
            u, v = (int(x) for x in rng.integers(0, n, 2))
            out.append(("delete", u, v))
    return out


def reference_live(keys, w, n, script):
    """The live edge set after ``script``, computed without the overlay: the
    script's last word on each edge it names (a float32 weight, or deleted)
    over the base set.  Returns (sorted keys, their float32 weights)."""
    import numpy as np

    last = {}
    for e in script:
        u, v = int(e[1]), int(e[2])
        if e[0] == "delete":
            last[u * n + v] = None
        elif u != v:
            last[u * n + v] = float(np.float32(e[3]))
    named = np.array(sorted(last), np.int64)
    keep = ~np.isin(keys, named)
    add = [(k, x) for k, x in last.items() if x is not None]
    k = np.concatenate([keys[keep], np.array([a for a, _ in add], np.int64)])
    x = np.concatenate([w[keep], np.array([b for _, b in add], np.float32)])
    order = np.argsort(k, kind="stable")
    return k[order], x[order].astype(np.float32)


def live_keyed(ov):
    """An overlay's ``live_edges()`` as (sorted keys, float32 weights)."""
    import numpy as np

    src, dst, w = ov.live_edges()
    k = src.astype(np.int64) * ov.n + dst
    order = np.argsort(k, kind="stable")
    return k[order], w[order].astype(np.float32)


def mutable_stream(svc, srcs, script, *, ppr=SERVICE_PPR):
    """Phase 15(b)/(c)'s virtual-time stream: request i (BFS, wBFS, BFS, PPR
    in turn, as phase 12(d)) arrives with its share of ``script``'s edits,
    from tenants ``ed_a`` and ``ed_b`` in turn; the first 8 at time 0, then
    0.01 apart, a tick after each; a drain at the end.  Returns (tickets,
    admitted edits)."""
    import numpy as np

    ops = ("bfs", "wbfs", "bfs", "ppr")
    tickets, admitted = [], 0
    for i, (s, idx) in enumerate(zip(srcs, np.array_split(np.arange(len(script)), len(srcs)))):
        now = 0.0 if i < 8 else 0.01 * (i - 7)
        for j in idx:
            e = script[j]
            admitted += svc.submit_edit(e[0], e[1], e[2], *e[3:], tenant=("ed_a", "ed_b")[j % 2],
                                        now=now)
        op = ops[i % 4]
        params = dict(ppr) if op == "ppr" else {}
        tickets.append(svc.submit(op, src=s, tenant="open", now=now, **params))
        svc.tick(now)
    svc.drain(0.01 * max(len(srcs) - 7, 1))
    return tickets, admitted


def same_checkpoints(a, b, what):
    """Two checkpoint directories hold the same steps, leaf for leaf."""
    import numpy as np

    check(sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir()),
          f"{what}: the checkpoint steps differ")
    for step in sorted(p.name for p in a.iterdir()):
        with np.load(a / step / "arrays.npz") as x, np.load(b / step / "arrays.npz") as y:
            check(sorted(x.files) == sorted(y.files), f"{what}: {step} leaves differ")
            for f in x.files:
                check(x[f].dtype == y[f].dtype and np.array_equal(x[f], y[f]),
                      f"{what}: {step} {f} differs")


def same_compressed(a, b, what):
    """Two compressed graphs equal field for field (tensors read back)."""
    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            check(x is not None and y is not None and x.dtype == y.dtype
                  and torch.equal(x.cpu(), y.cpu()), f"{what}: {f.name} differs")
        elif f.name != "exception_dense_hint":
            check(x == y, f"{what}: {f.name} {x!r} != {y!r}")


def trigger_for(dg, sweeps):
    """An OverlayTrigger whose hysteresis makes ``dg``'s overlay words pay for
    its compaction after ``sweeps`` sweeps (constants' cost scale)."""
    from repro_torch.tuning import OverlayTrigger

    hyst = dg.overlay_small_words * sweeps / (4.0 * dg.compact_write_words)
    return OverlayTrigger(hysteresis=hyst)


def drive_mutable(dev, A_, B_, E_, graph_b=GRAPH_B):
    """Phase 15: mutable graphs (the delta overlay, compaction, checkpoints,
    the service's edit path) and the observability layer, on the card.
    Returns kernel 1's fused launches on its paths ((d)'s BFS and flush)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.algorithms import bfs, pagerank, wbfs
    from repro_torch.core import build_csr, compress, make_plan
    from repro_torch.delta import DeltaOverlay, compact, compact_write_words, load_compacted
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round
    from repro_torch.obs import noop_registry
    from repro_torch.serving import QueryEngine, ServiceConfig, ServingService

    on_card = dev.type == "cuda"   # the CPU route (a rehearsal) launches nothing
    work = ROOT / "build" / "phase15"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.reset_peak_memory_stats()

    def k1():
        return compressed_chunked_spmv.launches, compressed_stream_round.launches

    def timed(fn):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    # (a) graph A: the overlay, an edit script, queries, compaction
    gA = A_.dev
    digest_a = graph_digest(gA)
    keys_a, w_a = base_edges(A_.host_csr)
    ov, t_ov = timed(lambda: DeltaOverlay(gA))
    script = edit_script(keys_a, w_a, gA.n, EDITS_A, SEED + 15)
    changed, t_apply = timed(lambda: ov.apply(script))
    dg, t_snap = timed(ov.snapshot)
    got_k, got_w = live_keyed(ov)
    want_k, want_w = reference_live(keys_a, w_a, gA.n, script)
    check(np.array_equal(got_k, want_k) and np.array_equal(got_w, want_w),
          "graph A: live_edges() differs from the numpy reference edge set")
    check(dg.m == want_k.size and dg.device == gA.device, "graph A snapshot: m or device")
    log(f"[15] graph A DeltaOverlay: {t_ov:.3f} s host wall over {keys_a.size} edges; "
        f"{EDITS_A} edits ({changed} changed the edge set) in {t_apply:.3f} s = "
        f"{EDITS_A / t_apply:.0f} edits/s; {ov.num_patch_edges} patch edges, "
        f"{ov.num_tombstones} tombstones; snapshot {t_snap * 1e3:.1f} ms ({dg.num_patch_blocks} "
        f"patch blocks); live_edges() equals the numpy reference ({want_k.size} edges)")
    srcs = sources(gA, MUT_SOURCES, SEED + 16)
    reqs = [("bfs", {"src": s}) for s in srcs] + [("wbfs", {"src": s}) for s in srcs]
    eng = QueryEngine(dg, max_batch=MUT_SOURCES, registry=noop_registry())
    b0 = k1()
    got, t_q_dg = timed(lambda: eng.serve(reqs))
    check(k1() == b0, f"graph A DeltaGraph queries launched kernel 1: {k1()} vs {b0}")
    pr_dg, t_pr_dg = timed(lambda: pagerank(dg, eps=0.0, max_iters=PR_ITERS)[0])
    check(eng.cost.large_writes == 0, "graph A: a query over the overlay wrote large memory")
    c, t_compact = timed(lambda: compact(ov, cost=eng.cost, registry=noop_registry()))
    words = compact_write_words(c)
    check(eng.cost.large_writes == words,
          f"graph A: large_writes {eng.cost.large_writes} != the compaction's {words}")
    eng_c = QueryEngine(c, max_batch=MUT_SOURCES, registry=noop_registry())
    want, t_q_c = timed(lambda: eng_c.serve(reqs))
    check(eng_c.cost.large_writes == 0, "graph A: a query over the compacted base wrote")
    for (op, p), a, b in zip(reqs, got, want):
        same = (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])) if op == "bfs" \
            else torch.equal(a, b)
        check(same, f"graph A {op} from {p['src']}: the DeltaGraph and its compaction differ")
    pr_c, t_pr_c = timed(lambda: pagerank(c, eps=0.0, max_iters=PR_ITERS)[0])
    pr_err = float((pr_dg - pr_c).abs().max())
    check(pr_err <= PR_ATOL, f"graph A PageRank: the DeltaGraph and its compaction differ "
          f"by {pr_err}")
    check(c.m == dg.m and graph_digest(gA) == digest_a, "graph A's base tensors changed")
    log(f"[15] graph A {MUT_SOURCES} BFS + {MUT_SOURCES} wBFS through the engine: DeltaGraph "
        f"{t_q_dg:.3f} s, compacted {t_q_c:.3f} s, equal bit for bit, no kernel launch; "
        f"PageRank {PR_ITERS} iterations {t_pr_dg:.3f} s / {t_pr_c:.3f} s, max|diff| "
        f"{pr_err!r} (atol {PR_ATOL}); compaction {t_compact:.3f} s writing "
        f"{words} words = large_writes, queries wrote 0; the base unchanged (SHA-256)")
    del eng, eng_c, dg, ov, c, got, want
    torch.cuda.empty_cache()

    # (b) graph B: a mutable ServingService over DeltaOverlay(compress(B))
    keys_b, w_b = base_edges(B_.host_csr)
    script_b = edit_script(keys_b, w_b, B_.dev.n, MUT_EDITS, SEED + 17)
    ov_b = DeltaOverlay(B_.dev)
    dg0 = ov_b.snapshot()
    plan_m = make_plan(dg0, strategy="sparse_streamed", chunk_blocks=MUT_CHUNK)
    check(plan_m.backend == "delta", f"the mutable plan's backend is {plan_m.backend}")
    trig = trigger_for(dg0, MUT_SWEEPS)
    cfg = ServiceConfig(slo=0.05, max_batch=8, depth_trigger=6, round_quantum=2,
                        compact_trigger=trig, ckpt_dir=str(work / "b"), compact_keep=2)
    svc = ServingService(ov_b, plan=plan_m, config=cfg, registry=noop_registry())
    del dg0
    compact_s = []
    real_compact = svc._compact

    def timed_compact(now):
        out, secs = timed(lambda: real_compact(now))
        compact_s.append(secs)
        return out

    svc._compact = timed_compact
    srcs_b = sources(B_.dev, SERVICE_REQUESTS, SEED + 18)
    b0 = k1()
    (tickets, admitted), t_stream = timed(lambda: mutable_stream(svc, srcs_b, script_b))
    launched = k1()
    check(launched == b0, f"graph B mutable service launched kernel 1 {launched} vs {b0} "
          "(a DeltaGraph takes the plain path)")
    st = svc.stats
    check(st["served"] == SERVICE_REQUESTS and st["edits_applied"] == admitted == MUT_EDITS
          and all(t.status == "done" for t in tickets), f"graph B mutable stream: {st}")
    check(st["compactions"] >= 1, f"the trigger (hysteresis {trig.hysteresis!r}) never fired")
    ref_k, ref_w = reference_live(keys_b, w_b, B_.dev.n, script_b)
    got_k, got_w = live_keyed(svc.overlay)
    check(np.array_equal(got_k, ref_k) and np.array_equal(got_w, ref_w),
          "graph B service: live_edges() differs from the numpy reference")
    src, dst, w = svc.overlay.live_edges()
    rb = compress(build_csr(B_.dev.n, src, dst, w, block_size=BLOCK, device=dev))
    served = svc.engine.graph
    for s in srcs_b[:MUT_SOURCES]:
        p, lv = bfs(served, s, plan=plan_m)
        p2, lv2 = bfs(rb, s)
        check(torch.equal(p, p2) and torch.equal(lv, lv2)
              and torch.equal(wbfs(served, s, plan=plan_m), wbfs(rb, s)),
              f"graph B service: BFS/wBFS from {s} differ from a graph built from scratch")
    triggered = st["compactions"]
    c_last, t_force = timed(lambda: svc.force_compact(1.0))
    loaded, step = load_compacted(cfg.ckpt_dir, device=dev)
    same_compressed(loaded, c_last, "graph B: load_compacted against the service's base")
    same_compressed(c_last, rb, "graph B: the last compaction against a from-scratch build")
    steps = sorted(p.name for p in (work / "b").iterdir())
    check(len(steps) <= cfg.compact_keep and step == svc._compact_step - 1,
          f"graph B checkpoints: {steps}, step {step}")
    log(f"[15] graph B mutable service (sparse_streamed plan, chunk {MUT_CHUNK}; trigger "
        f"hysteresis {trig.hysteresis!r}, ~{MUT_SWEEPS} sweeps): {SERVICE_REQUESTS} requests "
        f"and {MUT_EDITS} edits in {t_stream:.3f} s = {st['served'] / t_stream:.2f} served/s, "
        f"{admitted / t_stream:.1f} edits/s; {triggered} triggered compactions "
        f"({', '.join(f'{s:.3f}' for s in compact_s[:triggered])} s) + force_compact "
        f"{t_force:.3f} s; "
        f"checkpoint steps on disk {steps}; load_compacted equals the last base; BFS/wBFS "
        f"from {MUT_SOURCES} sources equal a from-scratch build; kernel 1 launches 0")
    del svc, ov_b, rb, served, loaded, c_last
    torch.cuda.empty_cache()

    # (c) graph E: the same kind of stream on the card and on the CPU route
    keys_e, w_e = base_edges(E_.host_csr)
    script_e = edit_script(keys_e, w_e, E_.dev.n, MUT_E[1], SEED + 19)
    srcs_e = sources(E_.dev, MUT_E[0], SEED + 20)
    runs = {}
    for tag, base in (("card", E_.dev), ("cpu", E_.host)):
        ov_e = DeltaOverlay(base)
        dg_e = ov_e.snapshot()
        if tag == "card":
            trig_e = trigger_for(dg_e, MUT_SWEEPS // 2)
        cfg_e = ServiceConfig(slo=0.05, max_batch=8, depth_trigger=6, round_quantum=2,
                              compact_trigger=trig_e, ckpt_dir=str(work / f"e_{tag}"))
        svc_e = ServingService(ov_e, config=cfg_e, registry=noop_registry(),
                               plan=make_plan(dg_e, strategy="sparse_streamed",
                                              chunk_blocks=MUT_CHUNK))
        ts = time.perf_counter()
        out = mutable_stream(svc_e, srcs_e, script_e)
        torch.cuda.synchronize()
        runs[tag] = (svc_e, out[0], time.perf_counter() - ts)
    (svc_e, t_card, s_card), (svc_c, t_cpu, s_cpu) = runs["card"], runs["cpu"]
    deg_e = E_.host.degrees.clamp(min=1).to(torch.float32)
    same_tickets(t_card, t_cpu, deg_e, lambda s: ppr_power_iteration(E_.host_csr, [s])[:, 0],
                 "graph E mutable service")
    same_service(svc_e, svc_c, "graph E mutable service")
    check(svc_e.stats["compactions"] >= 1 and svc_e.cost.large_writes == svc_c.cost.large_writes,
          f"graph E: compactions {svc_e.stats['compactions']}, writes differ")
    same_checkpoints(work / "e_card", work / "e_cpu", "graph E")
    same_compressed(svc_e.overlay.base, svc_c.overlay.base, "graph E compacted base")
    log(f"[15] graph E mutable service, {MUT_E[0]} requests and {MUT_E[1]} edits: card "
        f"{s_card:.3f} s, CPU route {s_cpu:.3f} s; {svc_e.stats['compactions']} compactions "
        f"(trigger hysteresis {trig_e.hysteresis!r}); every ticket, the stats, the ledgers, "
        f"the compactions and the checkpoint arrays equal the CPU route's")
    del runs, svc_e, svc_c
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[15] peak device memory of (a)-(c) {peak:.2f} GiB")

    # (d) observability: a traced BFS and service flush on graph B late in
    # this process, then as the first profiler session of a fresh process
    fused = trace_graph_b(work / "trace", B_.dev)
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]; import chip_smoke; "
            f"chip_smoke.fresh_trace({str(work / 'trace_fresh')!r}, {str(dev)!r}, {graph_b!r})")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    for line in r.stdout.splitlines():
        log(line)
    check(r.returncode == 0, f"phase 15(d)'s fresh process exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.dump"]
                       + ([] if on_card else ["--device", "cpu"]),
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    check(r.returncode == 0, f"python -m repro_torch.obs.dump exited {r.returncode}: "
          f"{r.stderr[-2000:]}")
    for name in ("sage_service_latency_seconds", "sage_psam_large_read_words_total"):
        check(f"# TYPE {name}" in r.stdout, f"the dump prints no {name}")
    log(f"[15] python -m repro_torch.obs.dump on the card: exit 0, "
        f"{sum(1 for x in r.stdout.splitlines() if x.startswith('# TYPE'))} metric families "
        f"(sage_service_latency_seconds and sage_psam_large_read_words_total among them; "
        f"sage_round_loop_seconds is in (d)'s registry)")
    return fused


REPEAT_TRACES = 8   # phase 15(d)'s traced BFS sessions after the first


def trace_graph_b(trace_dir, gB, fresh=False):
    """Phase 15(d): ``trace_session`` over a ``sparse_streamed`` BFS and a
    service flush on graph B: one ``sage.round`` span a BFS round,
    ``sage_round_loop_rounds`` holding the BFS's rounds, and on the card
    every fused launch a ``stream_round_kernel`` event or a launch the
    session counts in ``lost_kernels`` (the profiler drops a session's first
    kernel records at times late in a process: ``repro_torch.obs.trace``),
    with as many events as launches when it lost none.  As the first
    session of a ``fresh`` process it must lose none.  Late in this process
    the same BFS under ``noop_registry()`` is bit for bit equal,
    ``REPEAT_TRACES`` more traced sessions report their losses, and the BFS
    runs untraced with a live registry and under ``noop_registry()`` in
    turns.  Returns the first session's fused launches."""
    import torch

    from repro_torch.algorithms import bfs
    from repro_torch.core import make_plan
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round
    from repro_torch.obs import Registry, noop_registry, trace_session, use_registry
    from repro_torch.serving import ServiceConfig, ServingService

    on_card = gB.device.type == "cuda"
    where = "as a fresh process's first session" if fresh else "late in the process"

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    plan_b = make_plan(gB, strategy="sparse_streamed")
    s0 = sources(gB, 1, SEED + 21)[0]
    flush_srcs = sources(gB, 8, SEED + 22)
    bfs(gB, s0, plan=plan_b)   # warm
    svc = ServingService(gB, plan=plan_b, config=ServiceConfig(max_batch=8),
                         registry=noop_registry())
    reg = Registry()
    b0 = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
    with use_registry(reg), trace_session(str(trace_dir), label="phase15") as sess:
        (p_on, l_on), t_on = timed(lambda: bfs(gB, s0, plan=plan_b))
        for j, s in enumerate(flush_srcs):
            svc.submit(("bfs", "wbfs")[j % 2], src=s, now=0.0)
        svc.drain(0.0)
    fused = compressed_stream_round.launches - b0[1]
    check(compressed_chunked_spmv.launches == b0[0], "phase 15(d) launched kernel 1's decode")
    with open(sess.path) as fh:
        events = json.load(fh)["traceEvents"]
    rounds = int(l_on.max()) + 1
    spans = sum(1 for e in events if e.get("name") == "sage.round"
                and e.get("cat") == "user_annotation" and e.get("ph") == "X")
    kernels = sum(1 for e in events if e.get("cat") == "kernel"
                  and "stream_round_kernel" in e.get("name", ""))
    lost = sess.lost_kernels
    check(spans == rounds, f"the trace holds {spans} sage.round spans for {rounds} rounds")
    check(not on_card or (fused >= rounds and kernels <= fused <= kernels + lost
                          and (lost > 0 or kernels == fused) and (lost == 0 or not fresh)),
          f"{where}, the trace holds {kernels} stream_round_kernel events and {lost} launches "
          f"without a kernel record, the counter {fused} ({rounds} BFS rounds, "
          f"{svc.stats['cohort_rounds']} cohort rounds)")
    rec = reg.get("sage_round_loop_rounds")
    check(rec is not None and rec.sum() == float(rounds) and rec.count() == 1,
          "sage_round_loop_rounds does not hold the BFS's rounds")
    check(reg.get("sage_round_loop_seconds").count(path="sequential") == 1,
          "sage_round_loop_seconds recorded no call")
    line = (f"[15] trace_session {where} over a sparse_streamed BFS ({rounds} rounds) and a "
            f"flush of 8 requests ({svc.stats['cohort_rounds']} cohort rounds): {len(events)} "
            f"events in {os.path.basename(sess.path)}, {spans} sage.round spans, {kernels} "
            f"stream_round_kernel events for {fused} fused launches, {lost} launches without a "
            f"kernel record; sage_round_loop_rounds {rec.sum():.0f}; the BFS "
            f"{t_on * 1e3:.3f} ms traced with a live registry")
    if fresh:
        print(line, flush=True)
        return fused
    with use_registry(noop_registry()):
        (p_off, l_off), t_off = timed(lambda: bfs(gB, s0, plan=plan_b))
    check(torch.equal(p_on, p_off) and torch.equal(l_on, l_off),
          "the BFS under noop_registry() differs")
    losses = []
    for _ in range(REPEAT_TRACES):
        with trace_session(str(trace_dir), label="repeat") as rs:
            bfs(gB, s0, plan=plan_b)
        losses.append(rs.lost_kernels)
    log(f"{line}, {t_off * 1e3:.3f} ms under noop_registry(), bit for bit equal; "
        f"{REPEAT_TRACES} more traced BFS sessions lost {losses} kernel records")
    # the round-loop observer's cost: the same BFS untraced, live registry and
    # noop_registry() in turns
    walls = {"live": [], "noop": []}
    for _ in range(10):
        for tag, r in (("live", Registry()), ("noop", noop_registry())):
            with use_registry(r):
                walls[tag].append(timed(lambda: bfs(gB, s0, plan=plan_b))[1] * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    log(f"[15] the same BFS untraced, 10 in turns: live registry median {med['live']:.3f} ms "
        f"(min {min(walls['live']):.3f}), noop_registry() median {med['noop']:.3f} ms "
        f"(min {min(walls['noop']):.3f})")
    return fused


def fresh_trace(trace_dir, device, graph_b):
    """Phase 15(d) in a fresh process: graph B built at ``graph_b`` on
    ``device``, then :func:`trace_graph_b` as the process's first profiler
    session, which must keep every kernel record."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    trace_graph_b(trace_dir, build_graph(*graph_b, dev).dev, fresh=True)


# ----------------------------------------------------------------------
# phase 16: mixture-of-experts and latent-attention serving
# ----------------------------------------------------------------------
MOE_T = (8, 4096)            # (a): a decode step's tokens (batch 8), a prefill's (8 x 512)
# (a): moe_ffn in bfloat16 against the float32 loop, relative L2 of each token's row.  The
# layer rounds g, u, SiLU, h, y, the gates and the sum to bf16 (2^-9 each, about 1 % in
# all); a routing fault moves a row by a whole expert's share (>= 10 %)
MOE_REL_TOL = 2e-2
MOE_SERVE = (8, 512, 1024, 32)   # (b), (c): batch, prompt tokens, max_seq, greedy steps
MOE_CHECK = (2, 64, 4)           # (b): no-drop consistency: batch, prompt tokens, steps
DENSE_SERVE = (8, 512, 1024, 16)  # (d)
DBRX_LAYERS = 4        # of 40: the full depth is ~261 GB of bfloat16 weights
MISTRAL_LAYERS = 2     # of 88: ~246 GB at full depth
# (b): prefill + teacher-forced decode against one forward at no-drop capacity, in float32
# (the served bf16 weights' draws unrounded), relative L2 of the logits and of each cache
# row: the JAX package's tolerance for the same identity (tests/test_archs.py, 2e-3).  The
# two paths' products have other shapes and round otherwise, which can flip a routing
# near-tie among 64 experts: the routing of every MoE call is compared, at most 1 pick in
# 1,000 may differ (a wrong cache row or position moves thousands), and the tolerance holds
# the tokens whose routing agrees at every layer (at least one decoded position of every
# sequence).  In bfloat16 ties are common; that reading is printed, not held.
CONSIST_REL_TOL = 2e-3
# (c): the MoE kernel route against the plain route in bfloat16.  The two attentions differ
# by an ulp, which flips routing near-ties (bf16 logits often tie among 16 experts), and a
# flipped pick moves a step's logits past LOGITS_REL_TOL.  The routing of both is compared:
# at most this share of picks may differ (an attention fault reroutes most of them: 3 of 4
# at random for dbrx), and LOGITS_REL_TOL holds every (step, sequence) whose routing agrees
# at every layer, at least one step of each sequence.
ROUTE_FLIP_SHARE = 0.05


def moe_loop_reference(params, x, cfg):
    """An independent loop over the experts: each token's top K by router
    logit (the lower expert id first on ties: a stable sort on the host),
    each expert's first C assignments in t·K + k order, the SwiGLU and the
    gated sum in float32.  The logits are the router product as
    ``moe_ffn`` forms it (activation dtype, then float32).  Returns the
    output (T, d) float32, the kept mask (T, K), the top ids (T, K) and the
    slots (T, K), E·C where dropped."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.nn.moe import capacity

    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    logits = (x @ params["router"]).float().cpu().numpy()
    topi = np.argsort(-logits, axis=1, kind="stable")[:, :K]
    topv = np.take_along_axis(logits, topi, 1).astype(np.float64)
    gates = np.exp(topv - topv.max(1, keepdims=True))
    gates /= gates.sum(1, keepdims=True)
    slot = np.full((T, K), E * C)
    taken = np.zeros(E, dtype=np.int64)
    for t in range(T):
        for k in range(K):
            e = topi[t, k]
            if taken[e] < C:
                slot[t, k] = e * C + taken[e]
                taken[e] += 1
    kept = slot < E * C
    xf = x.float()
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        t_idx, k_idx = np.nonzero(kept & (topi == e))
        if len(t_idx) == 0:
            continue
        ti = torch.from_numpy(t_idx).to(x.device)
        xe = xf[ti]
        h = F.silu(xe @ params["w_gate"][e].float()) * (xe @ params["w_up"][e].float())
        g = torch.from_numpy(gates[t_idx, k_idx]).float().to(x.device)
        out.index_add_(0, ti, g[:, None] * (h @ params["w_down"][e].float()))
    if "shared" in params:
        sh = params["shared"]
        out += (F.silu(xf @ sh["w_gate"].float()) * (xf @ sh["w_up"].float())) @ sh["w_down"].float()
    return out, kept, topi, slot


def moe_bound(params, route, cfg, T):
    """The least time of one ``moe_ffn`` call on this data: the weights of
    the experts that hold an assignment, the router, the shared experts, x
    and the output read or written once, against the products of the kept
    assignments at the bf16 peak.  Returns (bound ms, needed bytes, bytes
    the batched products read)."""
    from repro_torch.tuning import HBM_BYTES_PER_S

    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    esize = params["router"].element_size()
    experts = int(route.topi[route.keep].unique().numel())
    expert_bytes = 3 * d * f * esize
    shared = weight_bytes(params.get("shared", {}))
    io = 2 * T * d * esize + params["router"].numel() * esize + shared
    kept = int(route.keep.sum())
    flops = 2 * 3 * d * f * kept + 2 * T * d * E + 2 * 3 * T * d * cfg.n_shared * f
    nbytes = experts * expert_bytes + io
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    return bound, nbytes, E * expert_bytes + io


def check_moe_layer(dev, name, lm_cfg):
    """Phase 16(a): one MoE layer of ``lm_cfg`` at full width in bfloat16,
    weights and tokens from a fresh seeded generator on the card, at each T
    of ``MOE_T``: ``moe_route`` and ``moe_ffn`` against
    ``moe_loop_reference``, and ``moe_ffn``'s device ms."""
    import torch

    from repro_torch.nn.moe import capacity, init_moe, moe_ffn, moe_route

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated: the loop is float32
    cfg = lm_cfg.moe_cfg()
    gen = torch.Generator(dev).manual_seed(SEED)
    params = init_moe(cfg, generator=gen, dtype=torch.bfloat16, device=dev)
    for T in MOE_T:
        x = torch.randn((T, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        out = moe_ffn(params, x, cfg)
        route = moe_route(params, x, cfg)
        want, kept, topi, slot = moe_loop_reference(params, x, cfg)
        check(torch.equal(route.keep.cpu(), torch.from_numpy(kept))
              and torch.equal(route.topi.cpu(), torch.from_numpy(topi))
              and torch.equal(route.slot.cpu(), torch.from_numpy(slot)),
              f"16(a) {name} T={T}: moe_route's assignments differ from the loop's")
        err = ((out.float() - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)).max()
        check(out.dtype == torch.bfloat16 and float(err) <= MOE_REL_TOL,
              f"16(a) {name} T={T}: moe_ffn differs from the loop by {float(err)} relative")
        bound, nbytes, read = moe_bound(params, route, cfg, T)
        runs = (5, 3) if T > 64 else (15, 10)
        t = check_bound(f"16(a) {name} moe_ffn T={T}",
                        {"ms": device_ms(lambda: moe_ffn(params, x, cfg), runs=runs[0],
                                         per_run=runs[1]), "bound_ms": bound})
        dropped = int((~route.keep).sum())
        log(f"[16] (a) {name} MoE layer (E={cfg.num_experts}, K={cfg.top_k}, d={cfg.d_model}, "
            f"f={cfg.d_ff_expert}, shared {cfg.n_shared}) bfloat16, T={T}, C={capacity(cfg, T)}: "
            f"moe_route == the loop's assignments ({kept.sum()} kept, {dropped} dropped of "
            f"{T * cfg.top_k}); moe_ffn against the float32 loop: max relative L2 a token "
            f"{float(err)!r} (tolerance {MOE_REL_TOL}); moe_ffn {t['ms']!r} ms device, bound "
            f"{bound!r} ms ({nbytes} B of the occupied experts and I/O; the batched products "
            f"read {read} B of every expert)")
        del x, out, route, want
    del params
    torch.cuda.empty_cache()


def drive_model(dev, cfg, serve, tag):
    """Phase 16(b)-(d): ``cfg`` on the card, random bf16 weights from a fresh
    seeded generator: ``serve`` = (batch, prompt tokens, max_seq, greedy
    steps) through ``prefill`` and ``decode_step``, one more step under
    ``torch.profiler``.  A GQA config launches kernel 6 once a layer a step
    and is held teacher-forced to the plain route (a MoE config on the rows
    whose routing agrees, ``ROUTE_FLIP_SHARE``); an MLA config launches it
    never.  Returns the parameters, kernel 6's launches and the peak device
    memory."""
    import torch

    from repro_torch.kernels import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention.decode_attention import split_rows
    from repro_torch.models import transformer_lm as lm
    from repro_torch.tuning import HBM_BYTES_PER_S

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    B, P, max_seq, steps = serve
    params = lm.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    wbytes = weight_bytes(params)
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    run = serve_greedy(params, cfg, prompts, max_seq, steps)
    launches = run["launches"]
    mla = cfg.attn == "mla"
    want = 0 if mla else cfg.n_layers * steps
    check(run["launches"] == want, f"16 {cfg.name}: {run['launches']} kernel 6 launches, not "
                                   f"{want} ({cfg.n_layers} layers x {steps} steps, {cfg.attn})")
    if not mla:
        def forced(attention):
            return teacher_forced(params, cfg, run["cache0"], run["tokens"], P, attention)

        rows, routed = None, ""
        if cfg.moe:
            kern, k_routes = routing_log(lambda: forced(decode_attention))
            ref, p_routes = routing_log(lambda: forced(decode_attention_ref))
            rows, differ, picks, _, _ = routed_diff(kern, k_routes, ref, p_routes)
            check(flip_rule(rows, differ, picks),
                  f"16 {cfg.name}: {differ} of {picks} routing picks differ between the kernel "
                  f"and the plain route, or a sequence has no step whose routing agrees")
            same = all(torch.equal(a, b) for a, b in zip(kern, run["logits"]))
            k0 = first_k(run["cache0"])
            faults = {}
            for name, fn in attention_faults(
                    split_rows(k0.new_empty((B, cfg.n_heads, cfg.d_head)), k0)[1]).items():
                f_rows, f_differ, _, f_held, f_all = routed_diff(*routing_log(lambda: forced(fn)),
                                                                 ref, p_routes)
                rejected = not flip_rule(f_rows, f_differ, picks) or f_held > LOGITS_REL_TOL
                faults[name] = (f"{f_held!r} on agreeing rows, {f_all!r} on all, {f_differ} "
                                f"picks differ, rejected {rejected}")
            routed = (f"; routing picks that differ between the routes {differ} of {picks}, "
                      f"(step, sequence) rows held {int(rows.sum())} of {rows.numel()}; the "
                      f"routed re-run of the kernel route equals the served logits bit for "
                      f"bit: {same}; planted faults against the plain route (a reading): "
                      + "; ".join(f"{k} {v}" for k, v in faults.items()))
            del kern
        else:
            ref = forced(decode_attention_ref)
        rel, rel_all, worst, agree = compare_logits(run["logits"], ref, f"16 {cfg.name}", rows)
        held = (f"teacher-forced plain route: logits relative diff {rel!r} (tolerance "
                f"{LOGITS_REL_TOL}; over all rows {rel_all!r}), max abs diff {worst!r}, greedy "
                f"tokens agree {agree}/{B * steps}{routed}")
        del ref
    else:
        for i, g in enumerate(run["logits"]):
            check(bool(torch.isfinite(g).all()), f"16 {cfg.name} step {i}: logits not finite")
        held = "logits finite"
    ms = run["decode_s"] / steps * 1e3
    cache_rows = B * (P + steps / 2)
    if mla:
        row = 2 * (cfg.kv_lora_rank + cfg.rope_head_dim)
        kv = 2 * 2 * cfg.n_layers * B * max_seq * cfg.n_heads * (
            cfg.nope_head_dim + cfg.rope_head_dim + cfg.v_head_dim)
        extra = (f"; K and V materialised from the whole latent cache every step: {kv} B "
                 "written, then read")
    else:
        row = 2 * 2 * cfg.n_kv_heads * cfg.d_head
        extra = ""
    cache_bytes = cfg.n_layers * cache_rows * row
    bound = (wbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    prof = profile_run(lambda: lm.decode_step(params, run["caches"],
                                              run["tokens"][-1], P + steps, cfg))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[16] {tag} {cfg.name}, {cfg.n_layers} layers, {wbytes} B of weights: {B} prompts x "
        f"{P} tokens, max_seq {max_seq}: prefill {run['prefill_s']:.3f} s; {steps} greedy "
        f"decode steps in {run['decode_s']:.3f} s = {ms:.3f} ms/step = "
        f"{B * steps / run['decode_s']:.1f} tokens/s (bytes bound {bound:.3f} ms/step: the "
        f"weights and {cache_bytes:.0f} B of cache{extra}); kernel 6 launches "
        f"{run['launches']} = {want}; {held}; peak device memory {peak} B")
    log_profile(f"16 {tag} {cfg.name} decode step", prof, ms)
    del run, prompts
    torch.cuda.empty_cache()
    return params, launches, peak


def token_rows_err(got, want):
    """The relative L2 difference of each cache row, the max over the layers
    and entries of each token: (B, S)."""
    err = None
    for key, entry in want.items():
        for name, w in entry.items():
            w = w.float()
            d = (got[key][name].float() - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
            d = d.amax(dim=0)
            err = d if err is None else err.maximum(d)
    return err


def routing_log(fn):
    """``fn()`` with every ``moe_ffn`` call of the transformer's blocks
    recording its top-k expert ids (``moe_route``, computed again beside the
    call).  Returns ``fn()``'s result and the ids of each call in order."""
    from repro_torch.models import transformer_lm as lm
    from repro_torch.nn.moe import moe_route

    calls, inner = [], lm.moe_ffn

    def recording(params, x, cfg):
        calls.append(moe_route(params, x, cfg).topi)
        return inner(params, x, cfg)

    lm.moe_ffn = recording
    try:
        return fn(), calls
    finally:
        lm.moe_ffn = inner


def picks_differ(want, got):
    """For each row, the top-k picks in ``got`` (rows, K) that ``want``'s same
    row lacks."""
    return (~(got[:, :, None] == want[:, None, :]).any(-1)).sum(-1)


def routed_diff(got, got_routes, want, want_routes):
    """Two teacher-forced decodes of one token sequence with their routing
    logs: the (step, sequence) rows whose routing agrees at every layer,
    the picks that differ and all picks, and the max logits relative L2
    over the agreeing rows and over all rows."""
    import torch

    steps = len(got)
    n = len(got_routes) // steps
    flips = torch.stack([sum(picks_differ(want_routes[i * n + j], got_routes[i * n + j])
                             for j in range(n)) for i in range(steps)])
    rows = flips == 0
    rel = torch.stack([(g.float() - w.float()).norm(dim=-1) / w.float().norm(dim=-1)
                       for g, w in zip(got, want)])
    held = float(rel[rows].max()) if bool(rows.any()) else float("inf")
    return rows, int(flips.sum()), sum(r.numel() for r in got_routes), held, float(rel.max())


def flip_rule(rows, differ, picks) -> bool:
    """At most ``ROUTE_FLIP_SHARE`` of the picks differ, and every sequence
    has a step whose routing agrees at every layer."""
    return differ <= ROUTE_FLIP_SHARE * picks and bool(rows.any(dim=0).all())


def consistency(dev, params, cfg):
    """Phase 16(b)'s identity at no-drop capacity (``capacity_factor = E /
    K``, as ``tests/test_archs.py`` runs it): ``forward`` over the whole
    ``MOE_CHECK`` sequence of S tokens against a prefill of its P prompt
    tokens and teacher-forced decode steps, every MoE call's routing
    logged.  Returns ``logits`` (B, S - P + 1), the relative L2 of the
    prefill's last logits and of each step's; ``rows`` (B, S), each token's
    worst cache row (relative L2, over layers and entries) against
    ``forward(collect_cache=True)``'s; ``flipped`` (B, S), the tokens with a
    routing pick that differs from the forward's in some layer; the picks
    that differ and the picks compared; and ``exact``: the prompt alone
    through ``forward(collect_cache=True)`` gives the prefill's caches bit
    for bit."""
    import torch

    from repro_torch.models import transformer_lm as lm

    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    B, P, steps = MOE_CHECK
    S = P + steps
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    (h, full), fwd = routing_log(lambda: lm.forward(params, toks, cfg, collect_cache=True))
    ref = lm.logits_from_hidden(params, h, cfg)
    (logits, cache), routes = routing_log(lambda: lm.prefill(params, toks[:, :P], cfg,
                                                             max_seq=S))
    flips = torch.zeros((B, S), dtype=torch.long, device=dev)
    rows = (torch.arange(B, device=dev)[:, None] * S + torch.arange(P, device=dev)).reshape(-1)
    for f, g in zip(fwd, routes):
        flips[:, :P] += picks_differ(f[rows], g).reshape(B, P)
    picks = sum(g.numel() for g in routes)
    rel = [(logits.float() - ref[:, P - 1].float()).norm(dim=-1)
           / ref[:, P - 1].float().norm(dim=-1)]
    for p in range(P, S):
        (logits, cache), routes = routing_log(
            lambda: lm.decode_step(params, cache, toks[:, p:p + 1], p, cfg))
        rows = torch.arange(B, device=dev) * S + p
        for f, g in zip(fwd, routes):
            flips[:, p] += picks_differ(f[rows], g)
        picks += sum(g.numel() for g in routes)
        rel.append((logits.float() - ref[:, p].float()).norm(dim=-1)
                   / ref[:, p].float().norm(dim=-1))
    _, alone = lm.forward(params, toks[:, :P], cfg, collect_cache=True)
    _, prefilled = lm.prefill(params, toks[:, :P], cfg)
    exact = all(torch.equal(alone[k][n], prefilled[k][n]) for k in alone for n in alone[k])
    return dict(logits=torch.stack(rel, dim=1), rows=token_rows_err(cache, full),
                flipped=flips > 0, differ=int(flips.sum()), picks=picks, exact=exact)


def consistency_line(c) -> str:
    ok = ~c["flipped"]
    P = MOE_CHECK[1]
    logits_ok = c["logits"][ok[:, P - 1:]]
    return (f"routing picks that differ from the forward's {c['differ']} of {c['picks']}, "
            f"tokens with one {int(c['flipped'].sum())} of {c['flipped'].numel()}; logits "
            f"relative L2 (prefill's last, then each step; a row a sequence) "
            f"{c['logits'].tolist()!r}, max over the tokens whose routing agrees "
            f"{float(logits_ok.max()) if logits_ok.numel() else None!r}; cache rows against "
            f"forward(collect_cache=True)'s, max relative L2 a token "
            f"{float(c['rows'].max())!r}, over the tokens whose routing agrees "
            f"{float(c['rows'][ok].max()) if bool(ok.any()) else None!r}; the prompt alone "
            f"through forward(collect_cache=True) equals the prefill's caches bit for bit: "
            f"{c['exact']}")


def drive_moe(dev) -> int:
    """Phase 16: the MoE layer at full width (a); deepseek-v2-lite-16b at
    full width and depth through the MLA route, with its no-drop
    consistency check (b); dbrx-132b at full width, ``DBRX_LAYERS`` of its
    40 layers (c); qwen1.5-4b at full depth and mistral-large-123b at full
    width, ``MISTRAL_LAYERS`` of its 88 layers (d), through kernel 6.  Each
    model is freed before the next.  Returns kernel 6's launches."""
    import torch

    from repro_torch.configs import dbrx_132b, deepseek_v2_lite_16b, mistral_large_123b
    from repro_torch.configs import qwen1_5_4b
    from repro_torch.models import transformer_lm as lm

    deepseek = deepseek_v2_lite_16b.full_config()
    dbrx = dataclasses.replace(dbrx_132b.full_config(), n_layers=DBRX_LAYERS)
    for name, cfg in (("deepseek-v2-lite-16b", deepseek), ("dbrx-132b", dbrx)):
        check_moe_layer(dev, name, cfg)
    params, launches, _ = drive_model(dev, deepseek, MOE_SERVE, "(b)")
    B, P, steps = MOE_CHECK
    head = (f"[16] (b) {deepseek.name} at no-drop capacity, {B} x {P} prompt tokens + {steps} "
            f"teacher-forced steps against forward over {P + steps}")
    log(f"{head}, the served bfloat16 weights (a reading): "
        + consistency_line(consistency(dev, params, deepseek)))
    del params
    torch.cuda.empty_cache()
    # the check: float32 weights, the same seeded draws unrounded
    f32 = dataclasses.replace(deepseek, dtype="float32")
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(f32, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    c = consistency(dev, params, f32)
    ok = ~c["flipped"]
    check(c["exact"] and c["differ"] * 1000 <= c["picks"]
          and bool(ok[:, P - 1:].any(dim=1).all())
          and float(c["logits"][ok[:, P - 1:]].max()) <= CONSIST_REL_TOL
          and float(c["rows"][ok].max()) <= CONSIST_REL_TOL,
          f"16(b) no-drop consistency in float32: {consistency_line(c)} "
          f"(tolerance {CONSIST_REL_TOL})")
    log(f"{head}, float32 weights (the same draws, {weight_bytes(params)} B): "
        f"{consistency_line(c)} (tolerance {CONSIST_REL_TOL}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    del params
    for cfg, serve, tag in (
            (dbrx, MOE_SERVE, "(c)"),
            (qwen1_5_4b.full_config(), DENSE_SERVE, "(d)"),
            (dataclasses.replace(mistral_large_123b.full_config(), n_layers=MISTRAL_LAYERS),
             DENSE_SERVE, "(d)")):
        params, n, _ = drive_model(dev, cfg, serve, tag)
        launches += n
        del params
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 17: training on the card (kernel 5', the trainer, the LM losses)
# ----------------------------------------------------------------------
CARD = "card not read"   # nvidia-smi's name and power limit, set by main()
GRAD_CASES = [         # (V, D, B, L, hot share, weighted): kernel 5' against its plain version
    (1000, 50, 4099, 1, 0.0, False),     # bags of one, planted ids, duplicates
    (500, 33, 300, 9, 0.0, True),        # L > 1 with weights
    (2000, 50, 20000, 1, 0.5, False),    # a hot row holding half the ids (~10 chunks)
    (3000, 50, 1000, 50, 0.5, True),     # the same in bags of 50, weighted
    (97, 200, 700, 3, 0.2, True),        # two column tiles
    (50, 16, 1024, 1, 1.0, False),       # a row of exactly one chunk (BACKWARD_CHUNK)
    (50, 16, 1025, 1, 1.0, True),        # one slot over
    (700, 49, 900, 4, 0.3, True),        # odd widths on each side of SASRec's 50
    (700, 51, 900, 4, 0.3, False),
    (4096, 64, 5000, 2, 0.0, True),      # rows of 16-byte vectors
    (1000, 50, 786_432, 1, 1.0, False),  # a row of 768 chunks, as train_batch's hot row
]
PLAN_V = (1, 1023, 1024, 1025, (1 << 20) - 1, 1 << 20, (1 << 20) + 1)  # the sort's bits change
GRAD_TIMED = (1 << 20, 50, 65_536 * 50)  # train_batch's lookup: catalog, width, ids
SAS_TRAIN = (6, 3, 4)          # train_batch (users from its cell): steps, ckpt_every, fail_at
SAS_CHECK_USERS = 1_024        # the first step held to the CPU route
GRAD_REL_TOL = 1e-5            # float32 gradients, card against CPU: other sum orders
LM_TRAIN = (8, 8, 2)           # train_4k cut: global batch (the cell's 256), accum, steps (4
#                                until phase 21, 3 until phase 22 was added: the run's wall)
LM_CHECK = (2, 2, 128)         # qwen2 cut to 2 layers: layers; the CPU-held step's batch, seq
LM_RESTART = (2, 512, 3, 2)    # the 2-layer bf16 restart: batch, seq; steps, fail_at = ckpt_every
MOE_TRAIN = (2, 2, 4)          # deepseek train_4k cut: layers; global batch (accum 2), steps
# A random LM's first loss: the tied embedding (std INIT_STD) against a
# hidden state of unit RMS gives logits of spread sigma = INIT_STD sqrt(d),
# so logsumexp ~ ln(vocab) + sigma^2 / 2 and the target's logit ~ 0 (qwen2:
# ln 151,936 = 11.931 + 0.307 = 12.238; one layer of it on the CPU, 128
# tokens: logsumexp 12.2373).  The first loss must lie within this of it.
FIRST_LOSS_TOL = 0.05


def first_loss_reckoned(cfg) -> float:
    from repro_torch.models.transformer_lm import INIT_STD

    return math.log(cfg.vocab) + 0.5 * INIT_STD ** 2 * cfg.d_model
# qwen2's one step, bf16, card against the CPU route: the two round bf16
# products at other places (the logits ~1e-3 of 11.93 apart), and AdamW's
# first step moves each element by ~lr times the sign of its gradient, so an
# element whose gradient is near 0 moves opposite ways on the two routes
BF16_LOSS_RTOL = 1e-2
BF16_NORM_RTOL = 5e-2
BF16_FLIP_SHARE = 0.05         # elements more than one bf16 ulp apart after the update


def same_tree_bits(a, b) -> bool:
    """Two parameter / optimizer trees equal leaf for leaf, bit for bit
    (-0.0 is not +0.0)."""
    import torch

    from repro_torch.kernels import same_bits
    from repro_torch.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        same_bits(x, y) if x.is_floating_point() else x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def tree_rel_l2(got, want) -> list:
    """Relative L2 distance of each leaf of ``got`` from ``want``, in
    ``tree_leaves`` order."""
    from repro_torch.optim import tree_leaves

    la, lb = tree_leaves(got), tree_leaves(want)
    check(len(la) == len(lb), f"trees of {len(la)} and {len(lb)} leaves")
    return [float((g.detach().double().cpu() - w.detach().double().cpu()).norm()
                  / max(float(w.detach().double().norm()), 1e-30)) for g, w in zip(la, lb)]


def plan_ids(kind, V, dev):
    """int32 ids (B, L) on ``dev`` for the preparation's cases, from ``V``:
    bags of one or L > 1 with -1, -7, V and V+3 planted, every slot padding,
    every slot one id (768 chunks and one slot), or 80 sparse ids (long gaps
    between them at V = 2^20, which the bounds pass leaves to its fill)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + V)
    if kind == "padding":
        ids = rng.choice(np.array([-1, -7, V, V + 3], np.int32), (999, 2))
    elif kind == "one id":
        ids = np.full((768 * 1024 + 1, 1), min(5, V - 1), np.int32)
    elif kind == "sparse":
        ids = rng.integers(0, V, (40, 2)).astype(np.int32)
    else:
        ids = rng.integers(0, V, (3001, 1 if kind == "bags of one" else 7)).astype(np.int32)
        ids.flat[rng.choice(ids.size, 4, replace=False)] = [-1, -7, V, V + 3]
    return torch.from_numpy(ids).to(dev)


def check_plan(ids, V, what) -> int:
    """The preparation on ``ids`` against ``backward_plan`` on the same
    tensor: ``row_start``, ``chunk_base`` and ``order[:row_start[V]]`` equal,
    one launch.  Returns the largest absolute difference (0 when equal)."""
    import torch

    from repro_torch.kernels import backward_plan, embedding_bag_plan

    want = backward_plan(ids, V)
    before = embedding_bag_plan.launches
    got = embedding_bag_plan(ids, V)
    torch.cuda.synchronize()
    check(embedding_bag_plan.launches == before + 1, f"{what}: not one preparation launch")
    n = int(want[1][V])
    pairs = [(got[1], want[1]), (got[2], want[2]), (got[0][:n], want[0][:n])]
    check(all(torch.equal(a, b) for a, b in pairs),
          f"{what}: the preparation differs from backward_plan")
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs)


def compare_bag_backward(dev):
    """Phase 17(a): kernel 5' against its plain version on the card, bit for
    bit, at ``GRAD_CASES``; its preparation against ``backward_plan`` at
    ``PLAN_V`` x four kinds of ids; ``take_rows`` under ``backward()`` on the
    card (wrapped negatives, out-of-range ids, duplicates) against the CPU
    route on the same tensors.  Returns the count of cases, the largest
    absolute difference of any of them (0.0 when all are bit for bit), and
    the preparation's device ms at V = 2^20 on one id in every slot and on
    the sparse ids (its rows' starts left to the fill pass)."""
    import numpy as np
    import torch

    from repro_torch.kernels import (
        bag_grad_case,
        embedding_bag_backward,
        embedding_bag_backward_ref,
        embedding_bag_plan,
        same_bits,
        take_rows,
    )

    cases, err = 0, 0.0
    for V in PLAN_V:
        for kind in ("bags of one", "L > 1", "padding", "one id", "sparse"):
            err = max(err, check_plan(plan_ids(kind, V, dev), V, f"preparation, {kind}, V={V}"))
            cases += 1
    sparse_ms = {}
    for kind in ("one id", "sparse"):
        ids = plan_ids(kind, 1 << 20, dev)
        sparse_ms[kind] = device_ms(lambda: embedding_bag_plan(ids, 1 << 20), runs=5, per_run=3)
    for i, (V, D, B, L, hot, weighted) in enumerate(GRAD_CASES):
        g, ids, w = bag_grad_case(V, D, B, L, SEED + i, hot=hot, weighted=weighted, device=dev)
        got = embedding_bag_backward(g, ids, V, w)
        want = embedding_bag_backward_ref(g, ids, V, w)
        again = embedding_bag_backward(g, ids, V, w)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()), float((again - got).abs().max()))
        check(same_bits(got, want), f"kernel 5' {(V, D, B, L, hot, weighted)}: not bit for bit "
                                    "the plain version's")
        check(same_bits(again, got), f"kernel 5' {(V, D, B, L, hot, weighted)}: a second call "
                                     "differs")
        cases += 2
    rng = np.random.default_rng(SEED)
    for V in (777, 4099):
        table = torch.from_numpy(rng.standard_normal((V, 50)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(-V - 3, V + 3, (256, 50)).astype(np.int32))
        ids[:128, :25] = 5                                   # a hot row
        up = torch.from_numpy(rng.standard_normal((256, 50, 50)).astype(np.float32))
        t_card = table.to(dev).detach().clone().requires_grad_(True)
        (take_rows(t_card, ids.to(dev)) * up.to(dev)).sum().backward()
        t_cpu = table.detach().clone().requires_grad_(True)
        (take_rows(t_cpu, ids) * up).sum().backward()
        torch.cuda.synchronize()
        check(t_card.grad is not None, f"take_rows backward on the card (V={V}): no gradient")
        err = max(err, float((t_card.grad.cpu() - t_cpu.grad).abs().max()))
        check(same_bits(t_card.grad.cpu(), t_cpu.grad),
              f"take_rows backward on the card (V={V}) differs from the CPU route")
        cases += 1
    return cases, err, sparse_ms


def bag_backward_bytes(g, ids, V):
    """Bytes kernel 5' must move: the gradient rows and the ids read once,
    the (V, D) table gradient written once."""
    return g.numel() * 4 + ids.numel() * 4 + V * g.shape[1] * 4


def sum_error_share(flat, g, V, results) -> float:
    """Holds each (V, D) float32 result to the float64 sum of row ``v`` over
    the rows ``g[i]`` with ``flat[i] == v``, element by element, within the
    a-priori error bound of a k-term float32 sum in any order or tree,
    ``gamma(k - 1) * sum |x|`` with ``gamma(m) = m u / (1 - m u)``, ``u = 2^-24``
    (Higham, Accuracy and Stability of Numerical Algorithms, 2nd ed., §4.2):
    a row of one term exact, an untouched row 0.  Returns the largest share of
    the bound a result used."""
    import torch

    exact = torch.zeros((V, g.shape[1]), dtype=torch.float64, device=g.device)
    exact.index_add_(0, flat, g.double())
    bound = torch.zeros_like(exact).index_add_(0, flat, g.double().abs())
    m = (torch.bincount(flat, minlength=V).double() - 1).clamp(min=0)[:, None]
    u = 2.0 ** -24
    check(float(m.max()) * u < 1, "a row sums too many terms for the float32 bound")
    bound *= m * u / (1 - m * u)
    share = 0.0
    for name, got in results.items():
        err = (got.double() - exact).abs()
        check(bool((err <= bound).all()),
              f"{name} at train_batch: an element outside the float32 sum's error bound "
              f"({int((err > bound).sum())} of {err.numel()})")
        share = max(share, float((err / bound.clamp(min=1e-300)).max()))
    return share


def plan_bytes(ids, V, n_valid):
    """Bytes the preparation must move: the ids read once, ``order``'s valid
    slots and ``row_start`` and ``chunk_base`` written once."""
    return ids.numel() * 4 + n_valid * 4 + 2 * (V + 1) * 4


def time_bag_backward(dev, hot: bool):
    """Phase 17(b): at train_batch's lookup, 3,276,800 ids into a 2^20 x 50
    float32 table: the preparation held to ``backward_plan`` and kernel 5'
    to its plain version, bit for bit; then device ms of the preparation
    (``embedding_bag_plan``), of the sums alone (``backward_sums`` on its
    plan), of the whole call, of the plain versions (``backward_plan``,
    ``embedding_bag_backward_ref``) and of two yardsticks the port never
    calls (``aten.embedding_dense_backward``, sort-based;
    ``zeros.index_add_``, atomic), which the whole call must beat.
    ``hot``: the ids of a
    ``make_sasrec_batch_fn`` history, padding item 0 (~24 % of the slots) a
    hot row; else uniform ids.  ``prof``: one whole call under
    ``torch.profiler``, the device time by kernel."""
    import torch

    from repro_torch.data import make_sasrec_batch_fn
    from repro_torch.kernels import (
        backward_plan,
        embedding_bag_backward,
        embedding_bag_backward_ref,
        embedding_bag_plan,
        same_bits,
    )
    from repro_torch.kernels.embedding_bag.embedding_bag import _backward_sums
    from repro_torch.tuning import HBM_BYTES_PER_S

    V, D, N = GRAD_TIMED
    gen = torch.Generator(dev).manual_seed(SEED + 17)
    if hot:
        ids = make_sasrec_batch_fn(V, N // 50, 50, device=dev)(SEED)["seq"].reshape(N, 1)
    else:
        ids = torch.randint(0, V, (N, 1), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((N, D), generator=gen, device=dev)
    flat = ids.reshape(-1).long()
    plan_err = check_plan(ids, V, f"the preparation at train_batch (hot={hot})")
    want = embedding_bag_backward_ref(g, ids, V)
    got = embedding_bag_backward(g, ids, V)
    err = float((got - want).abs().max())
    check(same_bits(got, want),
          f"kernel 5' at train_batch (hot={hot}): not bit for bit the plain version's")
    del got

    def dense():
        return torch.ops.aten.embedding_dense_backward(g, flat, V, -1, False)

    def atomic():
        return torch.zeros((V, D), device=dev).index_add_(0, flat, g)

    lib_err = max(float((f() - want).abs().max()) for f in (dense, atomic))
    rel = max(float((f() - want).norm() / want.norm()) for f in (dense, atomic))
    # the hot row sums ~786,000 terms in an order the atomics pick anew each
    # call: each result is held to the exact sum, not to another order's
    sum_share = sum_error_share(flat, g, V, {"plain": want, "embedding_dense_backward": dense(),
                                             "index_add_": atomic()})
    hot_share = float((ids == int(torch.mode(flat).values)).float().mean())
    del want
    plan = embedding_bag_plan(ids, V)
    n_valid = int(plan[1][V])
    nbytes = bag_backward_bytes(g, ids, V)
    pbytes = plan_bytes(ids, V, n_valid)
    t = dict(
        ms=device_ms(lambda: embedding_bag_backward(g, ids, V), runs=9, per_run=5),
        plan_ms=device_ms(lambda: embedding_bag_plan(ids, V), runs=9, per_run=5),
        sums_ms=device_ms(lambda: _backward_sums(g, *plan, 1), runs=9, per_run=5),
        plain_plan_ms=device_ms(lambda: backward_plan(ids, V), runs=9, per_run=5),
        plain_ms=device_ms(lambda: embedding_bag_backward_ref(g, ids, V), runs=3, per_run=1),
        library_ms=device_ms(dense, runs=9, per_run=5),
        atomic_ms=device_ms(atomic, runs=9, per_run=5),
        bytes=nbytes,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, N * D / F32_FLOPS) * 1e3,
        plan_bytes=pbytes,
        plan_bound_ms=pbytes / HBM_BYTES_PER_S * 1e3,
        err=err, plan_err=plan_err, lib_err=lib_err, lib_rel=rel, sum_share=sum_share,
        hot_share=hot_share,
        prof=profile_run(lambda: embedding_bag_backward(g, ids, V), top=12),
    )
    check_bound(f"kernel 5' at train_batch (hot={hot})", t)
    check_bound(f"index_add_ at train_batch (hot={hot})", dict(ms=t["atomic_ms"],
                                                                bound_ms=t["bound_ms"]))
    check_bound(f"the preparation at train_batch (hot={hot})", dict(ms=t["plan_ms"],
                                                                     bound_ms=t["plan_bound_ms"]))
    for name in ("library_ms", "atomic_ms"):
        check(t["ms"] < t[name], f"kernel 5' at train_batch (hot={hot}): {t['ms']!r} ms, not "
                                 f"under the yardstick's {t[name]!r} ms ({name})")
    return t


def sasrec_train(dev):
    """Phase 17(c): SASRec's train_batch at full size through ``Trainer``.
    Returns (kernel 5' launches, its preparation's, kernel 5 launches) of the
    trainer's runs."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_sasrec_batch_fn
    from repro_torch.kernels import embedding_bag_backward, embedding_bag_plan, embedding_bag_sums
    from repro_torch.launch import TrainConfig, Trainer, value_and_grad
    from repro_torch.models import sasrec

    steps, every, fail_at = SAS_TRAIN
    cell = get_arch("sasrec").cells()["train_batch"]
    cfg, users = cell.model_cfg, cell.batch_specs["seq"].shape[0]
    log(f"[17] (c) from the registry: sasrec/train_batch, {users} users x {cfg.seq_len} "
        f"(the cell's {cell.batch_specs['seq'].shape}, no cut)")
    make = make_sasrec_batch_fn(cfg.vocab, users, cfg.seq_len, device=dev)
    tc = dict(steps=steps, ckpt_every=every, log_every=1)
    trainer = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tc), device=dev)
    params, _ = trainer.init_state(torch.Generator(dev).manual_seed(SEED))
    batch = make(0)
    # the gradient reaches the table: every row the batch touches, none other
    bwd0, plan0 = embedding_bag_backward.launches, embedding_bag_plan.launches
    loss0, grads = value_and_grad(lambda p: sasrec.loss_fn(p, batch, cfg), params)
    check(embedding_bag_backward.launches - bwd0 == 3 and embedding_bag_plan.launches - plan0 == 3,
          "a SASRec gradient did not launch kernel 5' and its preparation once a lookup "
          "(seq, pos, neg)")
    ge = grads["item_emb"]
    touched = torch.zeros(cfg.vocab, dtype=torch.bool, device=dev)
    for k in ("seq", "pos", "neg"):
        touched[batch[k].reshape(-1).long()] = True
    touched[0] = False  # the padding item: its lookups are masked, its gradient 0
    nonzero = (ge != 0).any(dim=1)
    check(bool(torch.isfinite(loss0)) and bool(nonzero[touched].all())
          and not bool(nonzero[~touched].any()),
          f"item_emb's gradient: {int(nonzero[touched].sum())} of {int(touched.sum())} touched "
          f"rows non-zero, {int(nonzero[~touched].sum())} others non-zero")
    n_touched = int(touched.sum())
    del grads, ge, touched, nonzero
    # the first step's loss and gradients at SAS_CHECK_USERS users, card and CPU
    few = {k: v[:SAS_CHECK_USERS] for k, v in batch.items()}
    l_card, g_card = value_and_grad(lambda p: sasrec.loss_fn(p, few, cfg), params)
    host = sasrec.params_to(params, "cpu")
    l_cpu, g_cpu = value_and_grad(lambda p: sasrec.loss_fn(p, {k: v.cpu() for k, v in
                                                                few.items()}, cfg), host)
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    rels = tree_rel_l2(g_card, g_cpu)
    check(loss_rel <= GRAD_REL_TOL and max(rels) <= GRAD_REL_TOL,
          f"SASRec's first step at {SAS_CHECK_USERS} users: loss {loss_rel}, gradients "
          f"{max(rels)} relative from the CPU route")
    del g_card, g_cpu, host, params, batch
    torch.cuda.empty_cache()
    # the trainer: a clean run, a run that fails, its resumption
    ckpt = ROOT / "build" / "phase17"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    embedding_bag_backward.launches = 0
    embedding_bag_plan.launches = 0
    embedding_bag_sums.launches = 0
    gen = lambda: torch.Generator(dev).manual_seed(SEED)  # noqa: E731
    p_clean, o_clean, hist = trainer.fit(make, generator=gen(), ckpt_dir=str(ckpt / "clean"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    failing = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tc, fail_at_step=fail_at), device=dev)
    try:
        failing.fit(make, generator=gen(), ckpt_dir=str(ckpt / "crash"))
        check(False, "the injected failure did not raise")
    except RuntimeError as exc:
        check(str(exc) == f"injected failure at step {fail_at}", f"another failure: {exc}")
    p, o, hist_r = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tc), device=dev).fit(
        make, generator=gen(), ckpt_dir=str(ckpt / "crash"))
    bwd, prep = embedding_bag_backward.launches, embedding_bag_plan.launches
    fwd = embedding_bag_sums.launches
    runs = steps + fail_at + (steps - every)
    check(bwd == prep == fwd == 3 * runs,
          f"the trainer's {runs} steps launched kernel 5' {bwd}, its preparation {prep} and "
          f"kernel 5 {fwd} times, not 3 a step")
    check(same_tree_bits(p, p_clean) and same_tree_bits(o, o_clean),
          "SASRec's resumed run differs from the clean run")
    check([h["loss"] for h in hist_r] == [h["loss"] for h in hist[every:]],
          "the resumed losses differ from the clean run's")
    batch = make(steps)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    trainer.train_step(p, o, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - ts) * 1e3
    prof = profile_run(lambda: trainer.train_step(p, o, batch), top=10)
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses) and losses[0] == float(loss0),
          f"SASRec's losses {losses} (the first step's loss was {float(loss0)})")
    # a step that writes a checkpoint times the write too (as in the JAX trainer)
    timed_steps = [h for h in hist[1:] if h["step"] % every]
    ms = statistics.median(h["sec_per_step"] for h in timed_steps) * 1e3
    each = ", ".join(f"{h['sec_per_step'] * 1e3:.3f}" for h in hist)
    log(f"[17] (c) SASRec train_batch ({users} users x {cfg.seq_len}, {cfg.vocab} items, d "
        f"{cfg.embed_dim}, float32, TF32 off) on {CARD}: the first step's gradient non-zero on "
        f"all {n_touched} item rows the batch touches and exactly 0 on every other; at "
        f"{SAS_CHECK_USERS} users the loss {loss_rel:.3g} and the gradients at most "
        f"{max(rels):.3g} (relative L2) from the CPU route (tolerance {GRAD_REL_TOL})")
    log(f"[17] (c) Trainer, {steps} steps, a checkpoint every {every}: losses "
        f"{[round(x, 6) for x in losses]}; {ms:.3f} ms a step (median of steps "
        f"{', '.join(str(h['step']) for h in timed_steps)}, which write no checkpoint; each "
        f"{each}) = "
        f"{users / (ms / 1e3):.1f} users/s; peak device memory {peak} B; a run failing at "
        f"step {fail_at} resumed from step {every}: parameters and AdamW state bit for bit the "
        f"clean run's; kernel 5' launches {bwd}, its preparation {prep}, kernel 5 {fwd} (3 a "
        f"step, {runs} steps)")
    log_profile("17 (c) one train_batch step", prof, step_ms)
    shutil.rmtree(ckpt, ignore_errors=True)
    del p, o, p_clean, o_clean
    torch.cuda.empty_cache()
    return bwd, prep, fwd


def lm_step_flops(cfg, batch, seq) -> float:
    """Model flops of one training step as the port computes it: the
    layers' products three times (forward, the remat forward, and twice
    that in the backward: 8 x params x tokens), the tied logits' 6 x V x d
    x tokens, and attention over all S keys (no causal skip) 16 x tokens
    x S x d_attn a layer.  Active parameters for a MoE layer."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    if cfg.attn == "mla":
        dqk = cfg.nope_head_dim + cfg.rope_head_dim
        attn_p = (d * (cfg.n_heads * dqk + cfg.kv_lora_rank + cfg.rope_head_dim)
                  + cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
                  + cfg.n_heads * cfg.v_head_dim * d)
        dh = cfg.n_heads * dqk
    else:
        attn_p = d * cfg.d_head * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        dh = cfg.n_heads * cfg.d_head
    if cfg.moe:
        dense = cfg.first_dense_layers
        ffn = (3 * d * cfg.d_ff * dense
               + 3 * d * cfg.d_ff_expert * (cfg.top_k + cfg.n_shared) * (L - dense))
    else:
        ffn = 3 * d * cfg.d_ff * L
    tokens = batch * seq
    return float(8 * (L * attn_p + ffn) * tokens + 6 * V * d * tokens
                 + 16 * tokens * seq * dh * L)


def lm_memory_line(cfg, params, accum_mb):
    """Phase 17(d)'s reckoning of the peak before the run, in GB."""
    from repro_torch.optim import tree_leaves

    n = sum(p.numel() for p in tree_leaves(params))
    w = n * params["embed"].element_size()
    logits = 10 * cfg.vocab * accum_mb
    parts = {"weights": w, "gradients": w, "float32 accumulators": 4 * n,
             "moments, old and new": 2 * 8 * n, "new weights": w, "logits": logits}
    return n, sum(parts.values()), ", ".join(f"{k} {v / 1e9:.2f}" for k, v in parts.items())


def qwen2_train(dev):
    """Phase 17(d): qwen2-1.5B whole (train_4k's sequences, batch cut to 8),
    and cut to 2 layers: one step held to the CPU route, a bf16 restart."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_batch_fn
    from repro_torch.launch import TrainConfig, Trainer, train_step, value_and_grad
    from repro_torch.models import transformer_lm as lm
    from repro_torch.optim import adamw_init, tree_leaves, tree_map

    gb, accum, steps = LM_TRAIN
    cell = get_arch("qwen2-1.5b").cells()["train_4k"]
    cfg, (cell_gb, seq) = cell.model_cfg, cell.batch_specs["tokens"].shape
    log(f"[17] (d) from the registry: qwen2-1.5b/train_4k, {cell_gb} x {seq} tokens a step; cut "
        f"to a global batch of {gb} (of {cell_gb}), sequences at the cell's {seq}; {steps} steps "
        f"(cut from 4 to make room for phases 21 and 22)")
    check(cfg.remat_policy == "full", "qwen2 trains with remat_policy full")
    trainer = Trainer(lm, cfg, train_cfg=TrainConfig(steps=steps, accum=accum, warmup=1,
                                                     log_every=1), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt = trainer.init_state(torch.Generator(dev).manual_seed(SEED))
    n, reckoned, parts = lm_memory_line(cfg, params, seq * gb // accum)
    log(f"[17] (d) {cfg.name}: {n} parameters, {cfg.n_layers} layers, {cfg.dtype}; peak reckoned "
        f"before the run {reckoned / 1e9:.2f} GB ({parts})")
    make = make_lm_batch_fn(cfg.vocab, gb, seq, device=dev)
    fit_retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    params, opt, hist = trainer.fit(make, params=params, opt_state=opt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    fit_retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - fit_retries
    losses = [h["loss"] for h in hist]
    reckoned_loss = first_loss_reckoned(cfg)
    first = abs(losses[0] - reckoned_loss)
    check(all(math.isfinite(x) for x in losses) and first <= FIRST_LOSS_TOL,
          f"{cfg.name} losses {losses}: the first {first} from {reckoned_loss}")
    ms = statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3
    each = ", ".join(f"{h['sec_per_step'] * 1e3:.1f}" for h in hist)
    flops = lm_step_flops(cfg, gb, seq)
    log(f"[17] (d) {cfg.name} whole, train_4k cut to a global batch of {gb} x {seq} tokens "
        f"(accum {accum}, microbatch {gb // accum}), remat full, {steps} steps on {CARD}: losses "
        f"{[round(x, 5) for x in losses]} (the first {first:.4f} from ln V + sigma^2 / 2 = "
        f"{reckoned_loss:.4f}, {losses[0] - math.log(cfg.vocab):+.4f} from ln {cfg.vocab}); "
        f"{ms:.1f} ms a step (median of steps 2-{steps}; each {each}) = "
        f"{gb * seq / (ms / 1e3):.1f} tokens/s; model flops {flops:.4g} a step = "
        f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, {flops / (ms / 1e3) / BF16_FLOPS:.4f} of the "
        f"dense bf16 peak ({BF16_FLOPS / 1e12:.0f} TFLOP/s, H100 SXM data sheet); peak device "
        f"memory {peak} B (reckoned {reckoned / 1e9:.2f} GB); allocator retries {fit_retries}")
    mb = {k: v[:gb // accum] for k, v in make(steps).items()}

    def microbatch():
        return value_and_grad(lambda p: lm.loss_fn(p, mb, cfg), params)

    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        microbatch()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - ts) * 1e3)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - retries
    log(f"[17] (d) one microbatch's loss and gradient after the run, 3 calls: "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms; the caching allocator's retries (a cudaFree "
        f"of its cache and a new cudaMalloc) {retries}")
    log_profile("17 (d) one microbatch's loss and gradient", profile_run(microbatch, top=10),
                statistics.median(walls))
    del params, opt
    torch.cuda.empty_cache()

    # qwen2 cut to 2 layers at full width: one step against the CPU route
    layers, b, s = LM_CHECK
    cfg2 = dc.replace(cfg, n_layers=layers)
    params = lm.init(cfg2, generator=torch.Generator(dev).manual_seed(SEED + 1), device=dev)
    batch = make_lm_batch_fn(cfg2.vocab, b, s, device=dev)(0)
    host = {k: v.cpu() for k, v in batch.items()}
    p_cpu = tree_map(lambda t: t.cpu(), params)
    new, _, m = train_step(lm, params, adamw_init(params), batch, cfg2)
    ts = time.perf_counter()
    new_cpu, _, m_cpu = train_step(lm, p_cpu, adamw_init(p_cpu), host, cfg2)
    cpu_s = time.perf_counter() - ts
    loss_rel = abs(float(m["loss"]) - float(m_cpu["loss"])) / float(m_cpu["loss"])
    norm_rel = abs(float(m["grad_norm"]) - float(m_cpu["grad_norm"])) / float(m_cpu["grad_norm"])
    lr = 3e-4
    far = total = 0
    worst = 0.0
    for a, c, p0 in zip(tree_leaves(new), tree_leaves(new_cpu), tree_leaves(p_cpu)):
        a, c, p0 = a.float().cpu(), c.float(), p0.float()
        d = (a - c).abs()
        ulp = torch.clamp(c.abs(), min=1e-30) * 2.0 ** -7
        worst = max(worst, float((d / (2 * lr * (1 + 0.1 * p0.abs()) + 2 * ulp)).max()))
        far += int((d > ulp).sum())
        total += d.numel()
    check(loss_rel <= BF16_LOSS_RTOL and norm_rel <= BF16_NORM_RTOL and worst <= 1.0
          and far <= BF16_FLIP_SHARE * total,
          f"qwen2 2 layers, one step against the CPU route: loss {loss_rel}, grad norm "
          f"{norm_rel}, parameters {worst} of their bound, {far} of {total} past one ulp")
    log(f"[17] (d) {cfg2.name} cut to {layers} of 28 layers at full width, one train_step "
        f"(loss, grad, clip, AdamW at lr 3e-4) on {b} x {s} tokens against the CPU route "
        f"({cpu_s:.1f} s there): loss {float(m['loss']):.6f} vs {float(m_cpu['loss']):.6f} "
        f"({loss_rel:.3g}, tolerance {BF16_LOSS_RTOL}), grad norm {norm_rel:.3g} "
        f"({BF16_NORM_RTOL}); "
        f"parameters after the update: {far} of {total} elements more than one bf16 ulp apart "
        f"({far / total:.4f}, at most {BF16_FLIP_SHARE}), every element within "
        f"{worst:.3f} of 2 lr (1 + wd |p|) + 2 ulp")
    del new, new_cpu, p_cpu, params
    torch.cuda.empty_cache()

    # the bf16 restart of the 2-layer model
    b, s, steps2, at = LM_RESTART
    make2 = make_lm_batch_fn(cfg2.vocab, b, s, device=dev)
    tc = dict(steps=steps2, ckpt_every=at, warmup=1, log_every=1)
    ckpt = ROOT / "build" / "phase17"
    shutil.rmtree(ckpt, ignore_errors=True)
    gen = lambda: torch.Generator(dev).manual_seed(SEED + 2)  # noqa: E731
    ts = time.perf_counter()
    p_clean, o_clean, _ = Trainer(lm, cfg2, train_cfg=TrainConfig(**tc), device=dev).fit(
        make2, generator=gen(), ckpt_dir=str(ckpt / "clean"))
    try:
        Trainer(lm, cfg2, train_cfg=TrainConfig(**tc, fail_at_step=at), device=dev).fit(
            make2, generator=gen(), ckpt_dir=str(ckpt / "crash"))
        check(False, "the injected failure did not raise")
    except RuntimeError as exc:
        check(str(exc) == f"injected failure at step {at}", f"another failure: {exc}")
    p, o, _ = Trainer(lm, cfg2, train_cfg=TrainConfig(**tc), device=dev).fit(
        make2, generator=gen(), ckpt_dir=str(ckpt / "crash"))
    check(tree_leaves(p)[0].dtype == torch.bfloat16, "the 2-layer model is not bf16")
    check(same_tree_bits(p, p_clean) and same_tree_bits(o, o_clean),
          "qwen2's bf16 resumed run differs from the clean run")
    log(f"[17] (d) {cfg2.name} {layers} layers, bf16, {steps2} steps of {b} x {s}, a checkpoint at "
        f"step {at}, a run failing there resumed: parameters (bf16 through the checkpoint) "
        f"and AdamW state bit for bit the clean run's ({time.perf_counter() - ts:.1f} s)")
    shutil.rmtree(ckpt, ignore_errors=True)
    del p, o, p_clean, o_clean
    torch.cuda.empty_cache()


def deepseek_train(dev):
    """Phase 17(e): deepseek-v2-lite-16b cut to its leading dense layer and
    one MoE layer at full width, 4 steps through the MoE dispatch's backward."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_batch_fn
    from repro_torch.launch import TrainConfig, Trainer
    from repro_torch.models import transformer_lm as lm
    from repro_torch.optim import tree_leaves

    layers, gb, steps = MOE_TRAIN
    cell = get_arch("deepseek-v2-lite-16b").cells()["train_4k"]
    (cell_gb, seq), full = cell.batch_specs["tokens"].shape, cell.model_cfg
    cfg = dc.replace(full, n_layers=layers)
    log(f"[17] (e) from the registry: deepseek-v2-lite-16b/train_4k, {cell_gb} x {seq} tokens a "
        f"step, {full.n_layers} layers; cut to {layers} layers and a global batch of {gb}")
    trainer = Trainer(lm, cfg, train_cfg=TrainConfig(steps=steps, accum=gb, warmup=1,
                                                     log_every=1), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt = trainer.init_state(torch.Generator(dev).manual_seed(SEED))
    n = sum(p.numel() for p in tree_leaves(params))
    moe0 = {k: v.clone() for k, v in params["layers"]["moe"].items() if k != "shared"}
    params, opt, hist = trainer.fit(make_lm_batch_fn(cfg.vocab, gb, seq, device=dev),
                                    params=params, opt_state=opt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"deepseek's losses {losses}")
    moved = {k: bool((params["layers"]["moe"][k] != v).any()) for k, v in moe0.items()}
    check(all(moved.values()), f"the MoE layer's weights did not all move: {moved}")
    ms = statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3
    each = ", ".join(f"{h['sec_per_step'] * 1e3:.1f}" for h in hist)
    log(f"[17] (e) {cfg.name} cut to {layers} layers ({cfg.first_dense_layers} dense, "
        f"{layers - cfg.first_dense_layers} MoE: {cfg.num_experts} experts top {cfg.top_k} + "
        f"{cfg.n_shared} shared, {cfg.attn}) at full width, {n} parameters, {cfg.dtype}, "
        f"{steps} steps of {gb} x {seq} "
        f"tokens (accum {gb}) on {CARD}: losses {[round(x, 5) for x in losses]} (ln V + "
        f"sigma^2 / 2 = {first_loss_reckoned(cfg):.4f}); router and experts moved ({moved}); "
        f"{ms:.1f} ms a step (median of steps 2-{steps}; each {each}); peak device memory {peak} B; the dispatch's gathers "
        f"accumulate by atomics in the backward, so no bit identity is claimed")
    del params, opt, moe0
    torch.cuda.empty_cache()


def drive_train(dev) -> dict:
    """Phase 17: kernel 5' checked and timed, SASRec's train_batch through
    the trainer with a restart, qwen2-1.5B whole and cut, deepseek-v2-lite
    cut.  Returns kernel 5's forward launches on the path and kernel 5''s
    and its preparation's records."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest", "float32 products must be full")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cases, err, sparse_ms = compare_bag_backward(dev)
    log(f"[17] (a) kernel 5' == plain on the card bit for bit and its preparation == "
        f"backward_plan in {cases} cases (bags of one, L > 1 with weights, ids -1, -7, V, "
        f"V+3, duplicates, a hot row of half the ids, D 1 to 200 with 49, 51 and 64, rows of a "
        f"chunk, a chunk and one, 768 chunks; each called twice, the same bits; the "
        f"preparation at V {', '.join(map(str, PLAN_V))} on bags of one, L > 1, all padding, "
        f"one id in every slot and 80 sparse ids); take_rows under backward() on the card bit "
        f"for bit the CPU route's (wrapped negatives, out of range, a hot row); max abs "
        f"difference {err!r}; the preparation at V {1 << 20} on {CARD}: one id in "
        f"{768 * 1024 + 1} slots {sparse_ms['one id']!r} ms, 80 sparse ids "
        f"{sparse_ms['sparse']!r} ms")
    timing = {hot: time_bag_backward(dev, hot) for hot in (True, False)}
    for hot, t in timing.items():
        ids = ("history ids: the padding row holds" if hot else
               "uniform ids: the most frequent row holds")
        log(f"[17] (b) kernel 5' at train_batch ({GRAD_TIMED[2]} ids into a {GRAD_TIMED[0]} x "
            f"{GRAD_TIMED[1]} float32 table, {ids} "
            f"{t['hot_share']:.4f} of them) on {CARD}: whole call {t['ms']!r} ms = "
            f"{t['bound_ms'] / t['ms']!r} of its bound {t['bound_ms']!r} ms ({t['bytes']} B at "
            f"{3.35} TB/s); the preparation {t['plan_ms']!r} ms (bound {t['plan_bound_ms']!r} "
            f"ms, {t['plan_bytes']} B; backward_plan in torch ops {t['plain_plan_ms']!r} ms), "
            f"the sums alone {t['sums_ms']!r} ms; "
            f"plain {t['plain_ms']!r} ms, embedding_dense_backward {t['library_ms']!r} ms, "
            f"zeros.index_add_ {t['atomic_ms']!r} ms; the preparation == backward_plan, the "
            f"kernel against plain: max abs {t['err']!r}; yardsticks against plain: "
            f"max abs {t['lib_err']!r}, relative L2 {t['lib_rel']!r}; plain and yardsticks "
            f"against the float64 sum: at most {t['sum_share']!r} of float32's summation "
            f"error bound")
        log_profile(f"17 (b) kernel 5' on {'history' if hot else 'uniform'} ids", t["prof"],
                    t["ms"])
    wall = {"kernel 5'": time.perf_counter() - t0}
    t0 = time.perf_counter()
    bwd, prep, fwd = sasrec_train(dev)
    wall["SASRec train_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qwen2_train(dev)
    wall["qwen2-1.5B"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deepseek_train(dev)
    wall["deepseek-v2-lite cut"] = time.perf_counter() - t0
    log("[17] wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    check(bwd > 0 and prep > 0, "the training path did not launch kernel 5' and its preparation")
    t = timing[True]
    return fwd, [{
        "name": "embedding_bag_backward",
        "route": "cuda",
        "source": KERNEL_SOURCES["embedding_bag"],
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:38",
        "launches": bwd,
        "max_abs_err": max(err, *(x["err"] for x in timing.values())),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
    }, {
        "name": "embedding_bag_plan",   # kernel 5''s preparation: the radix sort
        "route": "cuda",
        "source": KERNEL_SOURCES["bag_plan"],
        # JAX differentiates jnp.take: no TPU kernel sorts the slots by id
        "replaces": "none: the preparation of kernel 5' (the gradient of row 5's function)",
        "launches": prep,
        "max_abs_err": float(max(err, *(x["plan_err"] for x in timing.values()))),
        "ms": t["plan_ms"],
        "plain_ms": t["plain_plan_ms"],
        "bound_ms": t["plan_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no one PyTorch call sorts, bounds and numbers the chunks
    }]


# ----------------------------------------------------------------------
# phase 18: the GNN family trained on the card
# ----------------------------------------------------------------------
GNN_CHECK = (16, 2)         # (b): molecules and layers of the step held to the CPU route
GNN_STEPS = 4               # Trainer steps a model and cell; ms a step: median of steps 2-4
GNN_REL_TOL = 1e-4          # float32 gradient leaves, card against CPU: relative L2
GNN_FLOOR = 1e-6            # ... plus this share of the whole gradient's norm (a leaf whose
#                             gradient vanishes analytically, as the attention bias under the
#                             edge softmax's shift invariance, holds rounding noise only)
AGG_REL_TOL = 1e-5          # (a): sums, means, std and softmax, atomic adds in another order
AGG_SHAPE = (50_000, 400_000, 64)   # (a): nodes, edges, features
SAMPLER = (1024, (15, 10))  # (e): seeds a step and the fanouts of minibatch_lg


def agg_inputs(rng, dup_pool) -> dict:
    """Phase 18(a)'s (and 22(a)'s) aggregation inputs drawn from ``rng``:
    ``AGG_SHAPE``'s edges into ``n`` nodes, the last 1,000 receiving
    nothing, the sentinel ``n`` and ids past it, and 10 % more edges
    copying edges drawn from the list's first ``dup_pool`` (exact ties:
    values are multiples of 1/8); a cotangent a node; the edge softmax's
    destinations (node n - 1 receives a real edge, so the sentinel edges
    read a finite max), scores over 8 heads and their cotangent."""
    import numpy as np

    n, E, d = AGG_SHAPE
    dst = rng.integers(0, n - 1000, E)
    dst[::97] = n                                   # the sentinel: dropped
    dst[1::997] = n + 7                             # outside [0, n]: dropped
    dup = rng.choice(dup_pool, E // 10)             # duplicate edges: exact ties
    dst = np.concatenate([dst, dst[dup]]).astype(np.int32)
    vals = (rng.integers(-64, 64, (E, d)) / 8).astype(np.float32)
    vals = np.concatenate([vals, vals[dup]])
    cot = rng.normal(size=(n, d)).astype(np.float32)
    sdst = np.minimum(dst, n)
    sdst[5] = n - 1
    scores = rng.normal(size=(len(sdst), 8)).astype(np.float32)
    scores[sdst >= n] = -1e30
    return {"dst": dst, "vals": vals, "cot": cot, "sdst": sdst, "scores": scores,
            "scot": rng.normal(size=scores.shape).astype(np.float32), "dup": len(dup)}


def compare_aggregation(dev) -> int:
    """Phase 18(a): the aggregation primitives on the card against the CPU
    route, value and the gradient of a random cotangent: max and min bit for
    bit, sums, means, std and the edge softmax within ``AGG_REL_TOL`` of the
    largest value; the gathers exactly.  Empty segments (the last 1,000
    nodes receive nothing), the sentinel ``n``, duplicate edges (exact ties)
    and ids outside [0, n].  Returns the number of cases."""
    import numpy as np
    import torch

    from repro_torch.models.gnn import aggregate as agg

    n, E, d = AGG_SHAPE
    rng = np.random.default_rng(SEED)
    c = agg_inputs(rng, E)
    dst, vals, cot = c["dst"], c["vals"], c["cot"]
    cases = 0

    def run(fn, v, idx, c, where):
        x = torch.from_numpy(v).to(where).requires_grad_(True)
        out = fn(x, torch.from_numpy(idx).to(where))
        (g,) = torch.autograd.grad(out, x, torch.from_numpy(c).to(where))
        return out.detach().cpu(), g.cpu()

    def held(got, want, exact, what):
        if exact:
            check(torch.equal(got, want), f"18(a) {what} on the card differs from the CPU route")
            return
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        check(err <= AGG_REL_TOL, f"18(a) {what}: {err} of the largest value from the CPU route")

    for name in ("scatter_sum", "scatter_mean", "scatter_max", "scatter_min", "scatter_std"):
        fn = lambda x, i, f=getattr(agg, name): f(x, i, n)  # noqa: E731
        card, host = run(fn, vals, dst, cot, dev), run(fn, vals, dst, cot, "cpu")
        exact = name in ("scatter_max", "scatter_min")
        held(card[0], host[0], exact, f"{name} value")
        held(card[1], host[1], exact, f"{name} gradient")
        cases += 2
    # the edge softmax over 8 heads
    fn = lambda x, i: agg.segment_softmax(x, i, n)  # noqa: E731
    card, host = run(fn, c["scores"], c["sdst"], c["scot"], dev), run(
        fn, c["scores"], c["sdst"], c["scot"], "cpu")
    held(card[0], host[0], False, "segment_softmax value")
    held(card[1], host[1], False, "segment_softmax gradient")
    # the gather: the sentinel, ids past it and wrapped negatives
    ids = rng.integers(-n, n + 5, E).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    gx = run(lambda t, i: agg.gather_src(t, i), x, ids, rng.normal(size=(E, d)).astype(
        np.float32), dev)
    hx = run(lambda t, i: agg.gather_src(t, i), x, ids, rng.normal(size=(E, d)).astype(
        np.float32), "cpu")
    held(gx[0], hx[0], True, "gather_src value")
    return cases + 3


def triplet_lists(src, dst, n, cap, length):
    """DimeNet's triplets: for each edge j -> i (its index in ``t_ji``), up
    to ``cap`` edges k -> j with k != i (in ``t_kj``), padded with E to
    ``length``."""
    import numpy as np

    E = len(src)
    order = np.argsort(dst, kind="stable")
    starts = np.searchsorted(dst[order], np.arange(n + 1))
    kj, ji = [], []
    for e in range(E):
        into = order[starts[src[e]]:starts[src[e] + 1]]
        into = into[src[into] != dst[e]][:cap]
        kj.append(into)
        ji.append(np.full(len(into), e))
    kj, ji = np.concatenate(kj), np.concatenate(ji)
    check(len(kj) <= length, f"{len(kj)} triplets over the cell's {length}")
    t_kj = np.full(length, E, np.int32)
    t_ji = np.full(length, E, np.int32)
    t_kj[:len(kj)], t_ji[:len(ji)] = kj, ji
    return t_kj, t_ji, len(kj)


def gnn_batch(cell, dev, seed, *, n_mol=None) -> tuple[dict, dict]:
    """A batch of ``cell``'s ``batch_specs`` from ``seed`` (``n_mol``
    molecules for a cut of the molecule cell), and what it holds.

    molecule: molecules of 30 atoms and 64 distinct bonds, both directions
    (no self-loop), positions ~N(0, 1.5^2) a coordinate, triplets k -> j ->
    i with k != i, a float32 energy a molecule.  full_graph_sm: 10,556
    uniform edges (no self-loop) over the 2,708 real nodes, the padding
    edges self-loops on the padded tail nodes (labels -1), classes 0-6,
    triplets capped at 8 an edge.  Every tensor is checked against its
    spec's shape and dtype."""
    import numpy as np
    import torch

    from repro_torch.configs.common import GNN_SHAPES, TRIPLET_CAP
    from repro_torch.configs.gnn_common import SHAPE_TASK

    specs = cell.batch_specs
    info = GNN_SHAPES[cell.shape]
    rng = np.random.default_rng(seed)
    n, e = specs["node_feat"].shape[0], specs["edge_src"].shape[0]
    note = {}
    if cell.shape == "molecule":
        atoms, bonds = info["n_nodes"], info["n_edges"]
        mols = n_mol or cell.model_cfg.n_graphs
        n, e = atoms * mols, 2 * bonds * mols
        pairs = np.stack(np.triu_indices(atoms, 1), 1)
        b = np.concatenate([pairs[rng.choice(len(pairs), bonds, replace=False)] + atoms * g
                            for g in range(mols)])
        src = np.concatenate([b[:, 0], b[:, 1]])
        dst = np.concatenate([b[:, 1], b[:, 0]])
        batch = {"node_graph": np.repeat(np.arange(mols), atoms).astype(np.int32),
                 "graph_labels": rng.normal(size=mols).astype(np.float32)}
        pos_scale = 1.5
    elif cell.shape == "full_graph_sm":
        n_real, e_real = info["n_nodes"], info["n_edges"]
        src = rng.integers(0, n_real, e_real)
        dst = (src + rng.integers(1, n_real, e_real)) % n_real      # no self-loop
        tail = n_real + np.arange(e - e_real) % (n - n_real)
        src, dst = np.concatenate([src, tail]), np.concatenate([dst, tail])
        labels = rng.integers(0, SHAPE_TASK[cell.shape][1], n).astype(np.int32)
        labels[n_real:] = -1
        batch = {"labels": labels}
        pos_scale = 1.0
    else:
        raise ValueError(f"gnn_batch builds molecule and full_graph_sm, not {cell.shape}")
    batch["node_feat"] = rng.normal(size=(n, info["d_feat"])).astype(np.float32)
    batch["edge_src"], batch["edge_dst"] = src.astype(np.int32), dst.astype(np.int32)
    if "pos" in specs:
        batch["pos"] = (rng.normal(size=(n, 3)) * pos_scale).astype(np.float32)
    if "t_kj" in specs:
        t_len = e * TRIPLET_CAP[cell.shape]
        batch["t_kj"], batch["t_ji"], note["triplets"] = triplet_lists(
            src, dst, n, TRIPLET_CAP[cell.shape], t_len)
    out = {k: torch.from_numpy(batch[k]).to(dev) for k in specs}
    if n_mol is None:
        for k, s in specs.items():
            check(tuple(out[k].shape) == s.shape and out[k].dtype == s.dtype,
                  f"{cell.arch} {cell.shape} {k}: {tuple(out[k].shape)} {out[k].dtype}, the "
                  f"cell's {s.shape} {s.dtype}")
    note.update(nodes=n, edges=e)
    return out, note


def depth_field(cfg) -> str:
    return "n_blocks" if hasattr(cfg, "n_blocks") else "n_layers"


def gnn_grads_vs_cpu(dev, m, cell):
    """Phase 18(b), first part: ``cell``'s model at full width cut to
    ``GNN_CHECK`` layers on that many molecules, one loss and gradient on
    the card and on the CPU route from the same parameters."""
    import dataclasses as dc

    import torch

    from repro_torch.launch import value_and_grad
    from repro_torch.optim import tree_leaves, tree_map

    mols, layers = GNN_CHECK
    cfg = dc.replace(cell.model_cfg, n_graphs=mols, **{depth_field(cell.model_cfg): layers})
    batch, _ = gnn_batch(cell, dev, SEED + 1, n_mol=mols)
    params = m.MODULE.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    l_card, g_card = value_and_grad(lambda p: m.MODULE.loss_fn(p, batch, cfg), params)
    host = tree_map(lambda t: t.cpu(), params)
    hb = {k: v.cpu() for k, v in batch.items()}
    l_cpu, g_cpu = value_and_grad(lambda p: m.MODULE.loss_fn(p, hb, cfg), host)
    gc = tree_leaves(g_card)
    check(all(bool(torch.isfinite(a).all()) for a in gc),
          f"18(b) {cell.arch}: a gradient leaf not finite")
    worst = grads_rel(g_card, g_cpu)
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    check(math.isfinite(float(l_card)) and loss_rel <= GNN_REL_TOL and worst <= GNN_REL_TOL,
          f"18(b) {cell.arch} cut to {layers} layers: loss {loss_rel}, gradients {worst} from "
          "the CPU route")
    return loss_rel, worst, len(gc)


def train_gnn(dev, mod, cfg, make_batch, *, profile=False):
    """``GNN_STEPS`` Trainer steps of ``mod`` at ``cfg`` on the card: ms a
    step (median of steps 2-4), losses and grad norms (all finite), peak
    device memory, and with ``profile`` one more step under
    ``torch.profiler``."""
    import torch

    from repro_torch.launch import TrainConfig, Trainer

    trainer = Trainer(mod, cfg, train_cfg=TrainConfig(steps=GNN_STEPS, warmup=1, log_every=1),
                      device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt, hist = trainer.fit(make_batch, generator=torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(len(hist) == GNN_STEPS and all(math.isfinite(x) for x in losses + norms),
          f"{cfg.name}: losses {losses}, grad norms {norms}")
    out = {"ms": statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3,
           "each": [h["sec_per_step"] * 1e3 for h in hist], "losses": losses, "norms": norms,
           "peak": peak}
    if profile:
        batch = make_batch(GNN_STEPS)
        out["prof"] = profile_run(lambda: trainer.train_step(params, opt, batch), top=12)
    del params, opt
    torch.cuda.empty_cache()
    return out


def log_gnn_step(tag, cell, cfg, t, items, unit):
    """One line for a cell's training steps."""
    log(f"[18] ({tag}) {cell.arch} {cell.shape} ({depth_field(cfg)} "
        f"{getattr(cfg, depth_field(cfg))}, d {cfg.d_hidden}, d_in {cfg.d_in}) on {CARD}: "
        f"{t['ms']:.3f} ms a step (median of steps 2-{GNN_STEPS}; each "
        f"{', '.join(f'{x:.3f}' for x in t['each'])}) = {items / (t['ms'] / 1e3):.1f} {unit}/s, "
        f"model flops {cell.model_flops / (t['ms'] / 1e3) / 1e12:.3f} TFLOP/s; peak device "
        f"memory {t['peak']} B; losses {[round(x, 5) for x in t['losses']]}, grad norms "
        f"{[round(x, 4) for x in t['norms']]}")


def products_batch(cell, dev):
    """ogb_products, full batch, made on the card from a seeded generator:
    2,449,029 real nodes x 100 features and 61,859,140 uniform edges, the
    padding edges self-loops on the padded tail nodes (labels -1), 47
    classes."""
    import torch

    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.configs.gnn_common import SHAPE_TASK

    info = GNN_SHAPES[cell.shape]
    n_real, e_real = info["n_nodes"], info["n_edges"]
    n, e = cell.batch_specs["node_feat"].shape[0], cell.batch_specs["edge_src"].shape[0]
    g = torch.Generator(dev).manual_seed(SEED + 2)
    tail = n_real + torch.arange(e - e_real, device=dev, dtype=torch.int32) % (n - n_real)
    labels = torch.randint(0, SHAPE_TASK[cell.shape][1], (n,), generator=g, device=dev,
                           dtype=torch.int32)
    labels[n_real:] = -1
    return {
        "node_feat": torch.randn(n, info["d_feat"], generator=g, device=dev),
        "edge_src": torch.cat([torch.randint(0, n_real, (e_real,), generator=g, device=dev,
                                             dtype=torch.int32), tail]),
        "edge_dst": torch.cat([torch.randint(0, n_real, (e_real,), generator=g, device=dev,
                                             dtype=torch.int32), tail]),
        "labels": labels,
    }


def reddit_csr(seed):
    """minibatch_lg's graph on the host, built directly as a CSR: 232,965
    vertices, 114,615,892 edges, degrees a multinomial draw over log-normal
    weights (skewed, as a social graph's), targets uniform."""
    import numpy as np

    from repro_torch.configs.common import GNN_SHAPES

    info = GNN_SHAPES["minibatch_lg"]
    n, m = info["n_nodes"], info["n_edges"]
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 1.0, n)
    deg = rng.multinomial(m, w / w.sum())
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    return offsets, rng.integers(0, n, m, dtype=np.int32)


def sampled_batch(cell, dev, offsets, targets, feat, labels, seed):
    """One minibatch_lg batch through the port's sampler: 1,024 seeds, fanout
    (15, 10), the features of the sampled nodes gathered on the card (the
    padded nodes, -1, filled with zeros, not wrapped), the seeds' labels
    (every other node -1).  Returns the batch and the sampler's host s."""
    import numpy as np
    import torch

    from repro_torch.data import sample_fanout
    from repro_torch.models.gnn.aggregate import gather_src

    n_seeds, fanouts = SAMPLER
    n_graph = len(offsets) - 1
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n_graph, n_seeds, replace=False)
    ts = time.perf_counter()
    nodes, es, ed, n_real, _ = sample_fanout(offsets, targets, seeds, fanouts, rng=rng)
    secs = time.perf_counter() - ts
    # the cell pads nodes to x32 and edges to x512 past the sampler's sizes
    # (at minibatch_lg's real sizes it adds nothing); its sentinel is its n
    n, e = cell.batch_specs["node_feat"].shape[0], cell.batch_specs["edge_src"].shape[0]
    nodes = np.concatenate([nodes, np.full(n - len(nodes), -1, nodes.dtype)])
    es, ed = (np.concatenate([np.where(a < n_real, a, n), np.full(e - len(a), n)]).astype(
        np.int32) for a in (es, ed))
    nodes_t = torch.from_numpy(nodes).to(dev)
    ids = torch.where(nodes_t >= 0, nodes_t, n_graph)      # padding: the fill row
    lab = torch.full((n,), -1, dtype=torch.int32, device=dev)
    at = torch.from_numpy(np.searchsorted(nodes[:n_real], seeds)).to(dev)
    lab[at] = labels[torch.from_numpy(seeds).to(dev)]
    batch = {"node_feat": gather_src(feat, ids), "edge_src": torch.from_numpy(es).to(dev),
             "edge_dst": torch.from_numpy(ed).to(dev), "labels": lab}
    for k, s in cell.batch_specs.items():
        check(tuple(batch[k].shape) == s.shape and batch[k].dtype == s.dtype,
              f"minibatch_lg {k}: {tuple(batch[k].shape)} {batch[k].dtype}, the cell's {s}")
    return batch, secs


def drive_gnn(dev):
    """Phase 18: the GNN family trained on the card, float32 products full
    (TF32 off): (a) the aggregation primitives against the CPU route; (b)
    all four models at full width on the molecule cell (2 layers on 16
    molecules against the CPU route, then ``GNN_STEPS`` Trainer steps at full
    depth); (c) the same four at full_graph_sm; (d) GIN at ogb_products,
    full batch, one step profiled; (e) PNA at minibatch_lg through the
    sampler.  No hand kernel lies on this path."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import SHAPE_TASK

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest", "float32 products must be full")
    wall = {}
    t0 = time.perf_counter()
    cases = compare_aggregation(dev)
    log(f"[18] (a) aggregation on the card against the CPU route, {AGG_SHAPE[1]} edges (+10 % "
        f"duplicates) into {AGG_SHAPE[0]} nodes x {AGG_SHAPE[2]}, the last 1,000 receiving "
        f"nothing, sentinel and out-of-range ids: {cases} cases; scatter_max / scatter_min "
        f"value and gradient bit for bit, sums, means, std and segment_softmax within "
        f"{AGG_REL_TOL} of the largest value, gather_src exact")
    wall["(a)"] = time.perf_counter() - t0
    order = ("gin-tu", "pna", "dimenet", "equiformer-v2")
    for shape, tag in (("molecule", "b"), ("full_graph_sm", "c")):
        t0 = time.perf_counter()
        for arch in order:
            m = get_arch(arch)
            cell = m.cells()[shape]
            if shape == "molecule":
                loss_rel, worst, leaves = gnn_grads_vs_cpu(dev, m, cell)
                log(f"[18] (b) {arch} at full width cut to {GNN_CHECK[1]} layers on "
                    f"{GNN_CHECK[0]} molecules, card against the CPU route: loss {loss_rel:.3g} "
                    f"relative, {leaves} gradient leaves at most {worst:.3g} (relative L2 "
                    f"beside {GNN_FLOOR} of the whole norm; limit {GNN_REL_TOL})")
            batch, note = gnn_batch(cell, dev, SEED)
            t = train_gnn(dev, m.MODULE, cell.model_cfg, lambda s, b=batch: b)
            items = cell.model_cfg.n_graphs if shape == "molecule" else note["nodes"]
            log_gnn_step(tag, cell, cell.model_cfg, t, items,
                         "graphs" if shape == "molecule" else "nodes")
            if "triplets" in note:
                log(f"[18] ({tag}) {arch} {shape}: {note['triplets']} real triplets of "
                    f"{cell.batch_specs['t_kj'].shape[0]}")
            del batch
        wall[f"({tag})"] = time.perf_counter() - t0
    # (d) GIN at ogb_products, full batch
    t0 = time.perf_counter()
    m = get_arch("gin-tu")
    cell = m.cells()["ogb_products"]
    batch = products_batch(cell, dev)
    t = train_gnn(dev, m.MODULE, cell.model_cfg, lambda s: batch, profile=True)
    log_gnn_step("d", cell, cell.model_cfg, t, batch["node_feat"].shape[0], "nodes")
    wall_s, busy_ms, n_kernels, top = t["prof"]
    # index_add's kernel (indexFuncLargeIndex: the scatter, forward and the
    # gather's backward) and index_select's (vectorized_gather_kernel)
    scatter_ms = sum(ms for name, ms, _ in top if "indexFunc" in name)
    gather_ms = sum(ms for name, ms, _ in top if "gather" in name)
    log(f"[18] (d) one step under torch.profiler: wall {wall_s * 1e3:.3f} ms, {n_kernels} "
        f"kernels, {busy_ms:.3f} ms of device time (busy {busy_ms / t['ms']:.3f} of the "
        f"unprofiled step); over the ({cell.batch_specs['edge_src'].shape[0]}, "
        f"{cell.model_cfg.d_hidden}) messages the scatter (index_add, atomic) {scatter_ms:.3f} "
        f"ms = {scatter_ms / busy_ms:.3f} and the gathers (index_select) {gather_ms:.3f} ms = "
        f"{gather_ms / busy_ms:.3f} of the device time")
    for name, kms, count in top:
        log(f"[18] (d)   {kms:10.3f} ms  {count:5d} calls  {name[:110]}")
    del batch
    torch.cuda.empty_cache()
    wall["(d)"] = time.perf_counter() - t0
    # (e) PNA at minibatch_lg through the sampler
    t0 = time.perf_counter()
    m = get_arch("pna")
    cell = m.cells()["minibatch_lg"]
    offsets, targets = reddit_csr(SEED + 3)
    csr_s = time.perf_counter() - t0
    g = torch.Generator(dev).manual_seed(SEED + 4)
    n_graph = len(offsets) - 1
    feat = torch.randn(n_graph, cell.model_cfg.d_in, generator=g, device=dev)
    labels = torch.randint(0, SHAPE_TASK[cell.shape][1], (n_graph,), generator=g, device=dev,
                           dtype=torch.int32)
    sampled = [sampled_batch(cell, dev, offsets, targets, feat, labels, SEED + 10 + s)
               for s in range(GNN_STEPS)]
    t = train_gnn(dev, m.MODULE, cell.model_cfg, lambda s: sampled[s][0])
    sampler_s = [s for _, s in sampled]
    real_e = [int((b["edge_dst"] < b["node_feat"].shape[0]).sum()) for b, _ in sampled]
    log(f"[18] (e) the graph on the host: {n_graph} vertices, {len(targets)} edges as a CSR in "
        f"{csr_s:.1f} s; the sampler ({SAMPLER[0]} seeds, fanout {SAMPLER[1]}) "
        f"{', '.join(f'{s:.3f}' for s in sampler_s)} s a batch on the host, "
        f"{real_e} real edges of {cell.batch_specs['edge_src'].shape[0]}")
    log_gnn_step("e", cell, cell.model_cfg, t, SAMPLER[0], "seeds")
    del sampled, feat, labels, offsets, targets
    torch.cuda.empty_cache()
    wall["(e)"] = time.perf_counter() - t0
    log("[18] wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))


def log_profile(tag, prof, ms):
    """One line for a ``profile_run`` reading beside the unprofiled call's ms."""
    wall, busy_ms, n_kernels, top = prof
    log(f"[{tag}] one call under torch.profiler: wall {wall * 1e3:.3f} ms, {n_kernels} kernels, "
        f"{busy_ms:.3f} ms of device time: busy {busy_ms / ms:.3f} of the unprofiled "
        f"{ms:.3f} ms call")
    for name, kms, count in top:
        log(f"[{tag}]   {kms:10.3f} ms  {count:5d} calls  {name[:110]}")


# ----------------------------------------------------------------------
# phase 4(b): batched edgeMap over feature-dim vertex state
# ----------------------------------------------------------------------
FEAT = (8, 16)   # (B, d): lanes and features of the (B, n, d) vertex state


def _weighted(xs, w):
    return xs * w


def _relax_i32(xs, w):
    return xs + w.to(xs.dtype)


def _passthrough(xs, w):
    return xs


def drive_features(dev, B_, E_):
    """Phase 4(b): ``edgemap_reduce_batched`` on (8, n, 16) state over graphs
    B and E, float32 under ``sum`` and int32 under ``min``, every mode,
    ``map_lanes`` on the even lanes (``auto_sparse="sparse_streamed"``, so
    ``auto``'s sparse lanes decode through kernel 1 too).  Lane 0's frontier
    holds ~8 % of the vertices (``auto`` takes the dense branch there), the
    rest ~1 %.  Each lane against its own single-query run on the card
    and against the CPU route: min and touched bit for bit; sums, which the
    card's scatter adds atomically in an order of its own, within twice
    float32's any-order bound, 2 (k-1)u / (1 - (k-1)u) · Σ|term| an element
    (k the graph's largest degree, Σ|term| the same edgeMap over |x|).  The
    CPU route covers graph E in ``sparse``, ``sparse_streamed`` and ``auto``
    (whose lane 0 runs the dense body; a dense batch of all 8 lanes on the
    host reads every slot of graph E's blocks 8 times, the bulk of the CPU
    route's time) and
    graph B's sparse lanes under ``sparse_streamed``.  Returns kernel 1's
    decode launches, the comparisons, the largest sum error's share of its
    bound and the seconds of each part."""
    import torch

    from repro_torch.core import edgemap_reduce, edgemap_reduce_batched
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round

    nb, d = FEAT
    lanes = torch.arange(nb) % 2 == 0
    spent = {"card, batched": 0.0, "card, single lanes": 0.0, "CPU route": 0.0}

    def timed(part, fn):
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        spent[part] += time.perf_counter() - t
        return out

    modes = ("dense", "sparse", "sparse_streamed", "auto")
    knobs = dict(auto_sparse="sparse_streamed")
    on_card = dev.type == "cuda"
    decode = cases = 0
    worst = 0.0

    def same(got, want, monoid, what, bound=None):
        nonlocal worst, cases
        check(torch.equal(got[1].cpu(), want[1].cpu()), f"{what}: touched differs")
        if monoid == "min":
            check(torch.equal(got[0].cpu(), want[0].cpu()), f"{what}: min differs")
        else:
            err = (got[0].cpu().double() - want[0].cpu().double()).abs()
            share = float((err / bound.clamp(min=1e-30)).max())
            worst = max(worst, share)
            check(share <= 1.0, f"{what}: a sum differs by {share} of its any-order bound")
        cases += 1

    for G, tag in ((B_, "B"), (E_, "E")):
        g = G.dev
        gen = torch.Generator().manual_seed(SEED + 40)
        # lane 0 over auto's dense threshold (m / 20 of the edges), the rest under it
        fr = torch.rand(nb, g.n, generator=gen) < torch.tensor([0.08] + [0.01] * (nb - 1))[:, None]
        states = {"sum": (torch.randn(nb, g.n, d, generator=gen), _weighted),
                  "min": (torch.randint(0, 1 << 20, (nb, g.n, d), generator=gen,
                                        dtype=torch.int32), _relax_i32)}
        k = int(g.degrees.max())
        gamma = 2 * k * 2.0**-24 / (1 - k * 2.0**-24)
        for monoid, (x, fn) in states.items():
            fr_d, x_d, lanes_d = fr.to(dev), x.to(dev), lanes.to(dev)
            bound = None
            if monoid == "sum":   # every lane's Σ|term| (weights are positive)
                bound = gamma * edgemap_reduce_batched(
                    g, fr_d, x_d.abs(), monoid="sum", map_fn=fn, mode="dense",
                    map_lanes=lanes_d)[0].double().cpu()
            for mode in modes:
                b0 = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
                got = timed("card, batched", lambda: edgemap_reduce_batched(
                    g, fr_d, x_d, monoid=monoid, map_fn=fn, mode=mode, map_lanes=lanes_d,
                    **knobs))
                n_dec = compressed_chunked_spmv.launches - b0[0]
                n_fused = compressed_stream_round.launches - b0[1]
                check(got[0].shape == x.shape and got[1].shape == fr.shape,
                      f"graph {tag} {monoid} {mode}: shapes {got[0].shape}, {got[1].shape}")
                streams = mode in ("sparse_streamed", "auto")  # auto: lanes 1-7 sparse
                check(not on_card or (n_fused == 0 and (n_dec > 0) == streams),
                      f"graph {tag} {monoid} {mode}: kernel 1 launches (decode, fused) "
                      f"({n_dec}, {n_fused})")
                decode += n_dec
                for q in range(nb):
                    one = timed("card, single lanes", lambda: edgemap_reduce(
                        g, fr_d[q], x_d[q], monoid=monoid, mode=mode,
                        map_fn=fn if bool(lanes[q]) else _passthrough, **knobs))
                    same((got[0][q], got[1][q]), one, monoid,
                         f"graph {tag} {monoid} {mode} lane {q} against its single run",
                         None if bound is None else bound[q])
                if tag == "E" and mode != "dense":
                    want = timed("CPU route", lambda: edgemap_reduce_batched(
                        G.host, fr, x, monoid=monoid, map_fn=fn, mode=mode, map_lanes=lanes,
                        **knobs))
                    same(got, want, monoid, f"graph E {monoid} {mode} against the CPU route",
                         bound)
                elif mode == "sparse_streamed":
                    want = timed("CPU route", lambda: edgemap_reduce_batched(
                        G.host, fr[1:], x[1:], monoid=monoid, map_fn=fn, mode=mode,
                        map_lanes=lanes[1:]))
                    same((got[0][1:], got[1][1:]), want, monoid,
                         f"graph B {monoid} sparse lanes against the CPU route",
                         None if bound is None else bound[1:])
    return decode, cases, worst, spent


# ----------------------------------------------------------------------
# phase 14(g): two ranks on the one card, one shard each, gloo
# ----------------------------------------------------------------------
DIST_DIR = ROOT / "build" / "phase14g"
DIST_LIMIT_S = 150   # the ranks' limit, start included: a rank still running is killed
DIST_SOURCES = 2     # phase 14(b)'s sources of graph B, and the next
DIST_PPR = 4         # PPR queries (SERVICE_PPR) beside phase 5's 16 in the ranks' engine
DIST_MUTABLE = (8, 64)   # graph E's mutable stream on the ranks: requests, edits


def _tensors_of(g) -> list:
    """Every tensor field of a graph."""
    import torch

    return [getattr(g, f.name) for f in dataclasses.fields(g)
            if isinstance(getattr(g, f.name), torch.Tensor)]


def dist_rank(rank, world, device, srcs, job):
    """One rank of phase 14(g): gloo from a ``file://`` path under ``build/``,
    the graphs from the parent's ``save_compacted`` files, a (2,) process
    mesh on ``device``; results to ``rank<r>.pt``, an exception to
    ``rank<r>.err`` (and exit code 1).  ``job`` holds the serving legs'
    streams (``dist_job``)."""
    import traceback

    try:
        import torch

        torch.save(_dist_rank(rank, world, device, srcs, job), DIST_DIR / f"rank{rank}.pt")
    except BaseException:
        (DIST_DIR / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _dist_rank(rank, world, device, srcs, job):
    import datetime

    import torch
    import torch.distributed as dist

    import repro_torch.core.plan as plan_mod
    from repro_torch.algorithms import bfs, kcore, pagerank, wbfs
    from repro_torch.core import make_plan, make_process_mesh
    from repro_torch.delta import load_compacted
    from repro_torch.distributed import distributed_pagerank_step
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{DIST_DIR / 'init'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    mesh = make_process_mesh((world,), ("data",), device=dev)
    out = {"rank": rank}
    gB, _ = load_compacted(str(DIST_DIR / "B"), device="cpu")
    gE, _ = load_compacted(str(DIST_DIR / "E"), device="cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    before = torch.cuda.memory_allocated(dev) if on_card else 0
    plan_b = make_plan(gB, mesh=mesh, strategy="sparse_streamed")
    gsB = plan_b.prepare(gB)
    local = gsB.shards[0]
    out["shard"] = {
        "index": gsB.shard_index, "held": len(gsB.shards),
        "bytes": sum(t.numel() * t.element_size() for t in _tensors_of(local)),
        "graph_bytes": sum(t.numel() * t.element_size() for t in _tensors_of(gB)),
        "allocated": (torch.cuda.memory_allocated(dev) - before) if on_card else 0,
        "devices": sorted({str(t.device) for t in _tensors_of(local)}),
        "blocks": local.num_blocks, "graph_blocks": gB.num_blocks,
    }

    def k1():
        return compressed_chunked_spmv.launches, compressed_stream_round.launches

    bfs_out, launches = [], []
    for s in srcs:
        b0 = k1()
        p, lv = bfs(gsB, s, plan=plan_b)
        sync()
        b1 = k1()
        dd = wbfs(gsB, s, plan=plan_b)
        sync()
        b2 = k1()
        bfs_out.append((p.cpu(), lv.cpu(), dd.cpu()))
        launches.append(((b1[0] - b0[0], b1[1] - b0[1]), (b2[0] - b1[0], b2[1] - b1[1]),
                         int(lv.max()) + 1))
    out["bfs"], out["launches"] = bfs_out, launches
    # the round's wall, and the combine's share of it (each side synchronised)
    real, spent = plan_mod._combine_process, []

    def timed_combine(*a, **kw):
        sync()
        t = time.perf_counter()
        res = real(*a, **kw)
        sync()
        spent.append(time.perf_counter() - t)
        return res

    walls = []
    plan_mod._combine_process = timed_combine
    try:
        for s in srcs:
            sync()
            t = time.perf_counter()
            lv = bfs(gsB, s, plan=plan_b)[1]
            sync()
            walls.append((time.perf_counter() - t, int(lv.max()) + 1))
    finally:
        plan_mod._combine_process = real
    out["timing"] = {"walls": walls, "combine": spent}
    # k-core on graph E: int32 sums, the chunk loop over kernel 1's decode
    plan_e = make_plan(gE, mesh=mesh, strategy="sparse_streamed")
    b0 = k1()
    core = kcore(plan_e.prepare(gE), plan=plan_e)
    sync()
    out["kcore"], out["kcore_launches"] = core.cpu(), (k1()[0] - b0[0], k1()[1] - b0[1])
    pr, iters = pagerank(gsB, eps=0.0, max_iters=PR_ITERS, plan=plan_b)
    out["pagerank"], out["pagerank_iters"] = pr.cpu(), iters
    inv = 1.0 / gsB.degrees.clamp(min=1).to(torch.float32)
    step = distributed_pagerank_step(mesh, n=gB.n)(gsB, pr, inv)
    out["step"] = step.cpu()
    out["serving"] = dist_serving(mesh, dev, gB, gE, plan_b, job)
    if on_card:
        nccl = dist.new_group(backend="nccl")
        try:
            make_process_mesh((world,), ("data",), group=nccl, device=dev)
            out["nccl"] = ""
        except ValueError as e:
            out["nccl"] = str(e)
    dist.destroy_process_group()
    return out


def dist_job(B_, E_, srcs) -> dict:
    """The serving legs' inputs, the same for the ranks and the parent:
    phase 5's 12 BFS and 4 wBFS requests and ``DIST_PPR`` PPR ones, phase
    12(d)'s 48-request stream and the capped tenant's budget (the (2,)
    plan's read quantum), graph E's mutable stream (sources and edits)."""
    from repro_torch.core import edgemap_round_read_words

    words = edgemap_round_read_words(B_.host, num_shards=2)
    keys, w = base_edges(E_.host_csr)
    return {
        "engine": [("bfs", {"src": s}) for s in srcs[2:14]]
        + [("wbfs", {"src": s}) for s in srcs[14:18]],
        "ppr": [("ppr", {"src": s, **SERVICE_PPR}) for s in srcs[:DIST_PPR]],
        "stream": sources(B_.host, SERVICE_REQUESTS, SEED + 4),
        "budgets": {"capped": (1.5 * words, 1.5 * words)},
        "mutable_srcs": sources(E_.host, DIST_MUTABLE[0], SEED + 20),
        "script": edit_script(keys, w, E_.host.n, DIST_MUTABLE[1], SEED + 19),
    }


def dist_service_config(job, *, mutable=False, ckpt_dir=None):
    """Phase 12(d)'s service knobs and budget; ``mutable``: graph E's, whose
    one compaction is the ``force_compact`` at the stream's end."""
    from repro_torch.serving import ServiceConfig
    from repro_torch.tuning import OverlayTrigger

    knobs = {"slo": 0.05, "max_batch": 8, "depth_trigger": 6, "round_quantum": 2}
    if mutable:
        return ServiceConfig(**knobs, compact_trigger=OverlayTrigger(hysteresis=math.inf),
                             ckpt_dir=ckpt_dir)
    return ServiceConfig(**knobs, admission="defer", budgets=job["budgets"])


def _to_cpu(res):
    return tuple(_to_cpu(r) for r in res) if isinstance(res, tuple) else (
        res.cpu() if hasattr(res, "cpu") else res)


def _devices_of(results) -> set:
    out = set()
    for res in results:
        for t in (res if isinstance(res, tuple) else (res,)):
            if hasattr(t, "device"):
                out.add(str(t.device))
    return out


def _unmarked(counts) -> dict:
    """A process plan's cache keys, each checked to name the process mesh
    (``("process", mesh)``) and keyed as the in-process plan's."""
    for key in counts:
        check(isinstance(key[1], tuple) and key[1][0] == "process",
              f"a process plan's cache key does not name the process mesh: {key}")
    return {key[:1] + (key[1][1],) + key[2:]: v for key, v in counts.items()}


def _service_record(svc, tickets):
    """A process-plan service as ``same_service`` reads it (cache keys
    unmarked), and its tickets with results on the host."""
    import types

    rec = types.SimpleNamespace(
        stats=dict(svc.stats), engine=types.SimpleNamespace(stats=dict(svc.engine.stats)),
        ledgers=dict(svc.ledgers.items()), trace_counts=_unmarked(svc.trace_counts),
        cost=types.SimpleNamespace(large_reads=svc.cost.large_reads,
                                   small_ops=svc.cost.small_ops,
                                   large_writes=svc.cost.large_writes),
        round_words=svc._round_words, held=_held(svc.engine.prepared))
    return rec, [dataclasses.replace(t, result=_to_cpu(t.result)) for t in tickets]


def _held(gs):
    """Which shard a prepared graph holds and where: (index, shards held,
    shards in all, devices)."""
    return (gs.shard_index, len(gs.shards), gs.num_shards,
            sorted({str(t.device) for t in _tensors_of(gs.shards[0])}))


def dist_serving(mesh, dev, gB, gE, plan_b, job):
    """Phase 14(g)'s serving legs on one rank: the engine (phase 5's 16
    requests, then ``DIST_PPR`` PPR), phase 12(d)'s service stream, and graph
    E's mutable service persisting one compaction to ``build/phase14g/ckpt_e``
    (rank 0 writes it; every rank reloads it and holds it to its own fold).
    Each leg's wall, its combines (seconds and bytes, each side
    synchronised) and its flush digests (seconds) are recorded."""
    import torch

    import repro_torch.core.plan as plan_mod
    import repro_torch.serving.engine as engine_mod
    import repro_torch.serving.service as service_mod
    from repro_torch.core import make_plan
    from repro_torch.delta import DeltaOverlay, load_compacted
    from repro_torch.kernels import compressed_chunked_spmv, compressed_stream_round
    from repro_torch.obs import noop_registry
    from repro_torch.serving import QueryEngine, ServingService

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    real = (plan_mod._combine_process, engine_mod.check_same_digest,
            service_mod.check_same_digest, service_mod.save_compacted)
    saves = []

    def watched(fn):
        """``fn()`` timed, with its combines and digests, and kernel 1's
        launches (decode, fused)."""
        rec = {"combine": [], "digest": []}

        def combine(plan, out, touched, *a, **kw):
            sync()
            t = time.perf_counter()
            res = real[0](plan, out, touched, *a, **kw)
            sync()
            rec["combine"].append((time.perf_counter() - t,
                                   out.numel() * out.element_size() + touched.numel() * 4))
            return res

        def digest(check_fn):
            def timed_check(*a, **kw):
                t = time.perf_counter()
                check_fn(*a, **kw)
                rec["digest"].append(time.perf_counter() - t)
            return timed_check

        def save(*a, **kw):
            saves.append(a[1])
            return real[3](*a, **kw)

        plan_mod._combine_process = combine
        engine_mod.check_same_digest = digest(real[1])
        service_mod.check_same_digest = digest(real[2])
        service_mod.save_compacted = save
        b0 = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
        try:
            sync()
            t = time.perf_counter()
            res = fn()
            sync()
            rec["wall"] = time.perf_counter() - t
        finally:
            (plan_mod._combine_process, engine_mod.check_same_digest,
             service_mod.check_same_digest, service_mod.save_compacted) = real
        rec["launches"] = (compressed_chunked_spmv.launches - b0[0],
                           compressed_stream_round.launches - b0[1])
        return res, rec

    out = {}
    eng = QueryEngine(gB, plan=plan_b, max_batch=8, registry=noop_registry())
    got, rec = watched(lambda: eng.serve(job["engine"]))
    got_p, rec_p = watched(lambda: eng.serve(job["ppr"]))
    out["engine"] = {
        "results": [_to_cpu(r) for r in got + got_p],
        "devices": _devices_of(got + got_p), "held": _held(eng.prepared),
        "legs": (rec, rec_p), "rounds": drain_rounds(job["engine"], got, 8),
        "stats": dict(eng.stats), "trace_counts": _unmarked(eng.trace_counts),
        "cost": (eng.cost.large_reads, eng.cost.small_ops),
    }
    del eng, got, got_p
    svc = ServingService(gB, plan=plan_b, config=dist_service_config(job),
                         registry=noop_registry())
    tickets, rec = watched(lambda: service_stream(svc, job["stream"]))
    out["service"] = (*_service_record(svc, tickets), rec,
                      _devices_of([t.result for t in tickets if t.result is not None]))
    del svc, tickets
    ov = DeltaOverlay(gE)
    plan_m = make_plan(ov.snapshot(), mesh=mesh, strategy="sparse_streamed",
                       chunk_blocks=MUT_CHUNK)
    ckpt = DIST_DIR / "ckpt_e"
    svc = ServingService(ov, plan=plan_m, config=dist_service_config(
        job, mutable=True, ckpt_dir=str(ckpt)), registry=noop_registry())

    def stream():
        res = mutable_stream(svc, job["mutable_srcs"], job["script"])
        return res, svc.force_compact(1.0)

    ((tickets, admitted), base), rec = watched(stream)
    loaded, step = load_compacted(str(ckpt), device="cpu")
    check(step == 0, f"rank {mesh.rank}: the persisted step is {step}")
    same_compressed(loaded, base, f"rank {mesh.rank}: the persisted compaction against its own "
                    "fold")
    out["mutable"] = (*_service_record(svc, tickets), rec,
                      _devices_of([t.result for t in tickets if t.result is not None]),
                      admitted, saves)
    return out


def drive_process_mesh(dev, B_, E_, srcs):
    """Phase 14(g): two ranks on the one card (``torch.multiprocessing``,
    gloo, both on ``dev``), each holding one shard of graphs B and E on a
    (2,) process mesh: BFS and wBFS on B, k-core on E, PageRank on B (10
    iterations, ``eps=0``, flat) and one ``distributed_pagerank_step``,
    against this process's single-device runs on the card; a 2-rank NCCL
    group on the one card must raise the duplicate-device error.  Then the
    serving tier on the process plan (``dist_serving``), against the same
    legs on one device and on the in-process (2,) plan run here meanwhile
    (``srcs``: phase 5's 18 sources of graph B).  Returns the ranks'
    (kernel 1 decode, fused) launches."""
    import multiprocessing

    import torch

    from repro_torch.algorithms import bfs, kcore, pagerank, wbfs
    from repro_torch.core import edgemap_reduce, make_mesh, make_plan
    from repro_torch.delta import save_compacted

    on_card = dev.type == "cuda"
    t_all = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    save_compacted(str(DIST_DIR / "B"), 0, B_.host)
    save_compacted(str(DIST_DIR / "E"), 0, E_.host)
    job = dist_job(B_, E_, srcs)
    srcs = list(srcs[:DIST_SOURCES])
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(r, 2, str(dev), srcs, job)) for r in range(2)]
    for p in procs:
        p.start()
    # meanwhile, one device on the card, and the in-process (2,) plan
    gB, gE = B_.dev, E_.dev
    single = make_plan(gB, strategy="sparse_streamed")
    want = [(*bfs(gB, s, plan=single), wbfs(gB, s, plan=single)) for s in srcs]
    core1 = kcore(gE, plan=make_plan(gE, strategy="sparse_streamed"))
    pr1 = pagerank(gB, eps=0.0, max_iters=PR_ITERS, plan=single)[0]
    inv = 1.0 / gB.degrees.clamp(min=1).to(torch.float32)
    s1, _ = edgemap_reduce(gB, torch.ones(gB.n, dtype=torch.bool, device=dev), pr1 * inv,
                           monoid="sum", map_fn=_weighted, mode="dense")
    in_proc = make_plan(gB, mesh=make_mesh((2,), ("data",), devices=[dev] * 2),
                        strategy="sparse_streamed")
    gs2 = in_proc.prepare(gB)
    walls2 = []
    for s in srcs:
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        lv = bfs(gs2, s, plan=in_proc)[1]
        if on_card:
            torch.cuda.synchronize()
        walls2.append((time.perf_counter() - t) / (int(lv.max()) + 1))
    served = {tag: serve_legs(dev, gB, gE, plan, job)
              for tag, plan in (("one device", single), ("(2,) in-process", in_proc))}
    deadline = time.monotonic() + DIST_LIMIT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for r in range(2):
        err = DIST_DIR / f"rank{r}.err"
        check(not err.exists(), f"phase 14(g) rank {r} failed:\n"
              + (err.read_text() if err.exists() else ""))
    check(not hung, f"phase 14(g): ranks {hung} still running after {DIST_LIMIT_S} s, killed")
    check(all(p.exitcode == 0 for p in procs), f"phase 14(g) exit codes "
          f"{[p.exitcode for p in procs]}")
    res = [torch.load(DIST_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    decode = fused = 0
    for r, rr in enumerate(res):
        for (p, lv, dd), (wp, wl, wd), (nb, nw, rounds) in zip(rr["bfs"], want, rr["launches"]):
            check(torch.equal(p, wp.cpu()) and torch.equal(lv, wl.cpu())
                  and torch.equal(dd, wd.cpu()),
                  f"phase 14(g) rank {r}: BFS/wBFS differ from one device")
            check(not on_card or (nb == (0, rounds) and nw[0] == 0 and nw[1] > 0),
                  f"phase 14(g) rank {r}: kernel 1 launches (decode, fused) BFS {nb} in "
                  f"{rounds} rounds, wBFS {nw}")
            fused += nb[1] + nw[1]
        check(torch.equal(rr["kcore"], core1.cpu()), f"phase 14(g) rank {r}: k-core differs")
        kd = rr["kcore_launches"]
        check(not on_card or (kd[0] > 0 and kd[1] == 0),
              f"phase 14(g) rank {r}: k-core kernel 1 launches (decode, fused) {kd}")
        decode += kd[0]
        err_pr = rel_max(rr["pagerank"], pr1.cpu())
        check(rr["pagerank_iters"] == PR_ITERS and err_pr <= PR_SHARD_REL_TOL,
              f"phase 14(g) rank {r}: PageRank max rel diff {err_pr} over {PR_SHARD_REL_TOL}")
        err_step = rel_max(rr["step"], ((1.0 - 0.85) / gB.n + 0.85 * s1).cpu())
        check(err_step <= PR_SHARD_REL_TOL,
              f"phase 14(g) rank {r}: distributed_pagerank_step max rel diff {err_step}")
        sh = rr["shard"]
        check(sh["index"] == r and sh["held"] == 1 and sh["devices"] == [str(dev)]
              and sh["blocks"] == -(-sh["graph_blocks"] // 2)
              and sh["bytes"] < 0.6 * sh["graph_bytes"],
              f"phase 14(g) rank {r}: holds {sh}, not its own shard alone")
        check(not on_card or "share the device" in rr.get("nccl", ""),
              f"phase 14(g) rank {r}: a 2-rank NCCL group on one card was not refused: "
              f"{rr.get('nccl')!r}")
        for key in ("kcore", "pagerank", "step"):
            check(torch.equal(rr[key], res[0][key]), f"phase 14(g): rank {r}'s {key} differs "
                  "from rank 0's")
        w = rr["timing"]["walls"]
        rounds = sum(k for _, k in w)
        wall_round = sum(t for t, _ in w) / rounds
        comb = sum(rr["timing"]["combine"]) / rounds
        log(f"[14] (g) rank {r}: graph B shard {sh['index']} of 2 on {sh['devices'][0]}, "
            f"{sh['blocks']} of {sh['graph_blocks']} blocks, {sh['bytes']} B of the graph's "
            f"{sh['graph_bytes']} B (device allocation grew {sh['allocated']} B); BFS from "
            f"{srcs}: {rounds} rounds, wall {wall_round * 1e3:.3f} ms a round, of which the "
            f"combine (gloo, CUDA tensors staged through the host: not an NCCL number) "
            f"{comb * 1e3:.3f} ms = {comb / wall_round:.3f}")
    n = gB.n
    log(f"[14] (g) two ranks on {CARD}, gloo: BFS and wBFS on graph B from {srcs}, k-core on "
        f"graph E and PageRank ({PR_ITERS} iterations, eps=0, flat) equal one device (BFS, "
        f"wBFS, k-core bit for bit; PageRank and distributed_pagerank_step within "
        f"{PR_SHARD_REL_TOL}); every rank identical; one fused launch a rank a BFS round, no "
        f"decode launch; k-core {decode} decode launches; the NCCL group on one card refused "
        f"({res[0].get('nccl', 'not run: no card')[:90]!r}); each rank sends a round's out and "
        f"touched as int32[{n}] each: {8 * n} B in all-reduce inputs, ring traffic "
        f"2(k-1)/k = 1x that, {8 * n} B a rank a round; in-process (2,) plan "
        f"{statistics.median(walls2) * 1e3:.3f} ms a BFS round")
    d, f = check_serving_legs(dev, B_, E_, job, res, served)
    log(f"[14] (g) phase wall {time.perf_counter() - t_all:.1f} s (spawn included)")
    return decode + d, fused + f


def serve_legs(dev, gB, gE, plan, job):
    """``dist_serving``'s legs in this process on ``plan`` (one device, or
    the in-process (2,) plan: graph E's plan then on a (2,) ``make_mesh``
    of the card): the engine, the service and the mutable service, each
    timed; one device's compaction persisted to ``ckpt_e_one``."""
    import torch

    from repro_torch.core import make_mesh, make_plan
    from repro_torch.delta import DeltaOverlay
    from repro_torch.obs import noop_registry
    from repro_torch.serving import QueryEngine, ServingService

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    out = {}
    eng = QueryEngine(gB, plan=plan, max_batch=8, registry=noop_registry())
    got, t_e = timed(lambda: eng.serve(job["engine"]))
    got_p, t_p = timed(lambda: eng.serve(job["ppr"]))
    out["engine"] = ([_to_cpu(r) for r in got + got_p], t_e + t_p, eng)
    svc = ServingService(gB, plan=plan, config=dist_service_config(job),
                         registry=noop_registry())
    tickets, t_s = timed(lambda: service_stream(svc, job["stream"]))
    out["service"] = (svc, cpu_tickets(tickets), t_s)
    ov = DeltaOverlay(gE)
    mesh = None if plan.mesh is None else make_mesh((2,), ("data",), devices=[dev] * 2)
    plan_m = make_plan(ov.snapshot(), mesh=mesh, strategy="sparse_streamed",
                       chunk_blocks=MUT_CHUNK)
    ckpt = str(DIST_DIR / "ckpt_e_one") if mesh is None else None
    msvc = ServingService(ov, plan=plan_m, config=dist_service_config(
        job, mutable=True, ckpt_dir=ckpt), registry=noop_registry())
    (tickets, admitted), t_m = timed(lambda: mutable_stream(msvc, job["mutable_srcs"],
                                                            job["script"]))
    msvc.force_compact(1.0)
    out["mutable"] = (msvc, cpu_tickets(tickets), t_m, admitted)
    return out


def cpu_tickets(tickets):
    """Tickets with their results on the host."""
    return [dataclasses.replace(t, result=_to_cpu(t.result)) for t in tickets]


def check_serving_legs(dev, B_, E_, job, res, served):
    """Phase 14(g)'s serving legs: each rank's engine, service and mutable
    service against one device's results (BFS and wBFS bit for bit, PPR by
    phase 12(c)'s rule) and the in-process (2,) plan's accounting (tickets,
    ``stats``, ledgers, cache misses, PSAM account, read quantum), every rank
    against rank 0, each rank's shard alone on the card, at most one fused
    launch a cohort round; the compaction persisted once (rank 0) and equal
    to one device's checkpoint.  Logs each leg's rate a rank beside one
    device's and the in-process plan's, the combines' share and bytes, and
    the flush digests' ms.  Returns the ranks' (decode, fused) launches."""
    import torch

    on_card = dev.type == "cuda"
    card = [str(dev)]
    deg_b = B_.host.degrees.clamp(min=1).to(torch.float32)
    deg_e = E_.host.degrees.clamp(min=1).to(torch.float32)
    pis = {}

    def pi_of(csr, s):
        if (id(csr), s) not in pis:
            pis[id(csr), s] = ppr_power_iteration(csr, [s])[:, 0]
        return pis[id(csr), s]

    def like_one(op, got, want, deg, csr, params, what):
        if op == "bfs":
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"{what}: BFS differs from one device")
        elif op == "wbfs":
            check(torch.equal(got, want), f"{what}: wBFS differs from one device")
        else:
            same_ppr(got, want, deg, lambda: pi_of(csr, params["src"]), params["eps"],
                     params["max_rounds"], f"{what}: PPR")

    def tickets_like_one(tickets, one, deg, csr, what):
        check([t.id for t in tickets] == [t.id for t in one], f"{what}: ticket ids differ")
        for t, u in zip(tickets, one):
            check(t.status == u.status == "done", f"{what}: ticket {t.id} is {t.status}")
            like_one(t.op, t.result, u.result, deg, csr, t.params, f"{what}, ticket {t.id}")

    def share(rec):
        comb = sum(t for t, _ in rec["combine"])
        sent = statistics.mean(b for _, b in rec["combine"]) if rec["combine"] else 0
        dig = statistics.mean(rec["digest"]) * 1e3 if rec["digest"] else float("nan")
        return (f"combine {comb:.3f} s = {comb / rec['wall']:.3f} of it over "
                f"{len(rec['combine'])} combines, {sent:.0f} B a combine in all-reduce inputs; "
                f"{len(rec['digest'])} flush digests, {dig:.3f} ms each")

    one, inp = served["one device"], served["(2,) in-process"]
    reqs = job["engine"] + job["ppr"]
    decode = fused = 0
    rate = {}
    for r, rr in enumerate(res):
        e = rr["serving"]["engine"]
        what = f"phase 14(g) rank {r} engine"
        for (op, p), got, want in zip(reqs, e["results"], one["engine"][0]):
            like_one(op, got, want, deg_b, B_.host_csr, p, f"{what}, {op} from {p['src']}")
        eng_in = inp["engine"][2]
        check(e["stats"] == eng_in.stats and e["trace_counts"] == eng_in.trace_counts
              and e["cost"] == (eng_in.cost.large_reads, eng_in.cost.small_ops),
              f"{what}: stats, cache misses or PSAM account differ from the in-process plan's")
        check(e["held"] == (r, 1, 2, card) and e["devices"] == set(card),
              f"{what}: holds {e['held']}, results on {e['devices']}")
        (rec, rec_p), rounds = e["legs"], e["rounds"]
        check(not on_card or (rec["launches"][0] == 0 and 0 < rec["launches"][1] <= rounds
                              and rec_p["launches"][0] > 0 and rec_p["launches"][1] == 0),
              f"{what}: kernel 1 launches (decode, fused) BFS/wBFS {rec['launches']} in "
              f"{rounds} rounds, PPR {rec_p['launches']}")
        decode += rec_p["launches"][0]
        fused += rec["launches"][1]
        rec_s, tickets, srec, devs = (rr["serving"]["service"][i] for i in (0, 1, 2, 3))
        what = f"phase 14(g) rank {r} service"
        svc_in, tickets_in, _ = inp["service"]
        same_tickets(tickets, tickets_in, deg_b, lambda s: pi_of(B_.host_csr, s),
                     f"{what} against the in-process (2,) plan")
        same_service(rec_s, svc_in, f"{what} against the in-process (2,) plan")
        tickets_like_one(tickets, one["service"][1], deg_b, B_.host_csr, what)
        check(rec_s.round_words == svc_in._round_words and rec_s.held == (r, 1, 2, card)
              and devs == set(card), f"{what}: read quantum {rec_s.round_words} (in-process "
              f"{svc_in._round_words}), holds {rec_s.held}, results on {devs}")
        st = rec_s.stats
        check(not on_card or 0 < srec["launches"][1] <= st["cohort_rounds"],
              f"{what}: fused launches {srec['launches'][1]} in {st['cohort_rounds']} cohort "
              "rounds")
        decode += srec["launches"][0]
        fused += srec["launches"][1]
        rec_m, tickets_m, mrec, devs_m, admitted, saves = rr["serving"]["mutable"]
        what = f"phase 14(g) rank {r} mutable service"
        msvc_in, mtickets_in, _, admitted_in = inp["mutable"]
        same_tickets(tickets_m, mtickets_in, deg_e, lambda s: pi_of(E_.host_csr, s),
                     f"{what} against the in-process (2,) plan")
        same_service(rec_m, msvc_in, f"{what} against the in-process (2,) plan")
        tickets_like_one(tickets_m, one["mutable"][1], deg_e, E_.host_csr, what)
        check(rec_m.stats["compactions"] == 1 and rec_m.cost.large_writes
              == msvc_in.cost.large_writes and admitted == admitted_in == one["mutable"][3],
              f"{what}: compactions {rec_m.stats['compactions']}, admitted {admitted}")
        check(saves == ([0] if r == 0 else []), f"{what}: save_compacted calls {saves}")
        check(rec_m.held == (r, 1, 2, card) and devs_m == set(card),
              f"{what}: holds {rec_m.held}, results on {devs_m}")
        if r:
            base = res[0]["serving"]
            same_tickets(tickets, base["service"][1], deg_b, lambda s: pi_of(B_.host_csr, s),
                         f"{what}: rank {r} against rank 0")
            same_service(rec_s, base["service"][0], f"phase 14(g) service: rank {r} against 0")
            same_tickets(tickets_m, base["mutable"][1], deg_e,
                         lambda s: pi_of(E_.host_csr, s), f"{what}: rank {r} against rank 0")
            for a, b in zip(e["results"], base["engine"]["results"]):
                check(all(torch.equal(x, y) for x, y in zip(
                    a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,))),
                    f"phase 14(g) engine: rank {r}'s results differ from rank 0's")
        wall_e = rec["wall"] + rec_p["wall"]
        rate[r] = (len(reqs) / wall_e, st["served"] / srec["wall"],
                   rec_m.stats["served"] / mrec["wall"])
        log(f"[14] (g) rank {r} serving on the (2,) process plan: engine {len(reqs)} queries "
            f"({len(job['engine'])} BFS/wBFS, {len(job['ppr'])} PPR) in {wall_e:.3f} s = "
            f"{rate[r][0]:.2f} queries/s, kernel 1 fused {rec['launches'][1]} in {rounds} "
            f"rounds, decode {rec['launches'][0]} (PPR {rec_p['launches'][0]}); BFS/wBFS "
            f"{share(rec)}. Service {len(job['stream'])} requests in {srec['wall']:.3f} s = "
            f"{rate[r][1]:.2f} requests/s, stats {st}, fused {srec['launches'][1]} in "
            f"{st['cohort_rounds']} cohort rounds, decode {srec['launches'][0]}; "
            f"{share(srec)}. Mutable service (graph E, {len(job['mutable_srcs'])} requests, "
            f"{len(job['script'])} edits, one compaction) in {mrec['wall']:.3f} s = "
            f"{rate[r][2]:.2f} served/s; {share(mrec)}; save_compacted calls {saves}")
    steps = sorted(p.name for p in (DIST_DIR / "ckpt_e").iterdir())
    check(steps == ["step_0000000000"], f"phase 14(g): the shared ckpt_dir holds {steps}")
    same_checkpoints(DIST_DIR / "ckpt_e", DIST_DIR / "ckpt_e_one",
                     "phase 14(g): the ranks' persisted compaction against one device's")
    rates = {tag: (len(reqs) / leg["engine"][1], leg["service"][0].stats["served"]
                   / leg["service"][2], leg["mutable"][0].stats["served"] / leg["mutable"][2])
             for tag, leg in served.items()}
    log(f"[14] (g) serving on {CARD}, while the ranks ran (all on the one card): queries/s of "
        f"the engine, requests/s of the service, served/s of the mutable service: ranks "
        + ", ".join(f"{r} {a:.2f} / {b:.2f} / {c:.2f}" for r, (a, b, c) in rate.items())
        + "; " + ", ".join(f"{tag} {a:.2f} / {b:.2f} / {c:.2f}"
                           for tag, (a, b, c) in rates.items())
        + "; every rank's tickets, stats, ledgers, cache misses and PSAM account equal the "
        "in-process (2,) plan's, its BFS/wBFS one device's bit for bit, PPR by phase 12(c)'s "
        "rule; rank 0 persisted graph E's one compaction, rank 1 wrote none, both reloaded it "
        "equal to their own fold and to one device's checkpoint")
    return decode, fused


# ----------------------------------------------------------------------
# phase 19: the cell registry
# ----------------------------------------------------------------------
def cell_batch(cell, gen, dev) -> dict:
    """One cell's batch on ``dev``, every ``batch_specs`` entry drawn from
    ``gen``: floats normal, ids in range (tokens and items below the vocab,
    positions below the sequence, nodes below the node count, edge ids below
    the edge count, labels below the classes, graph ids below the graphs)."""
    import torch

    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.gnn_common import SHAPE_TASK

    specs, cfg = cell.batch_specs, cell.model_cfg
    if cell.family == "gnn":
        _, n_classes, n_graphs = SHAPE_TASK[cell.shape]
        n, e = specs["node_feat"].shape[0], specs["edge_src"].shape[0]
        highs = {"edge_src": n, "edge_dst": n, "t_kj": e, "t_ji": e, "labels": n_classes,
                 "node_graph": n_graphs, "graph_labels": n_classes}
    elif cell.family == "lm":
        highs = {"tokens": cfg.vocab, "targets": cfg.vocab,
                 "pos": LM_SHAPES[cell.shape]["seq_len"]}
    else:
        highs = dict.fromkeys(specs, cfg.vocab)
    out = {}
    for k, spec in specs.items():
        if spec.dtype.is_floating_point:
            out[k] = torch.randn(spec.shape, generator=gen, device=dev, dtype=spec.dtype)
        else:
            out[k] = torch.randint(0, highs[k], spec.shape, generator=gen, device=dev,
                                   dtype=spec.dtype)
        check(tuple(out[k].shape) == tuple(spec.shape) and out[k].dtype == spec.dtype,
              f"{cell.arch}/{cell.shape} {k}: {tuple(out[k].shape)} {out[k].dtype}")
        if not spec.dtype.is_floating_point and out[k].numel():
            check(0 <= int(out[k].min()) and int(out[k].max()) < highs[k],
                  f"{cell.arch}/{cell.shape} {k}: ids out of [0, {highs[k]})")
    return out


def drive_registry(dev):
    """Phase 19: every cell of ``all_cells()`` (40), its batch made on the
    card from a seeded generator, one cell at a time and freed; shapes,
    dtypes and id ranges checked; each cell's kind, family, batch bytes and
    model flops printed."""
    import torch

    from repro_torch.configs import all_cells

    cells = all_cells()
    check(len(cells) == 40, f"the registry has {len(cells)} cells, not 40")
    gen = torch.Generator(dev).manual_seed(SEED + 19)
    peak = 0
    for (arch, shape), cell in cells.items():
        batch = cell_batch(cell, gen, dev)
        nbytes = sum(t.numel() * t.element_size() for t in batch.values())
        peak = max(peak, nbytes)
        log(f"[19] {arch}/{shape}: {cell.kind}, {cell.family}, batch "
            f"{ {k: tuple(t.shape) for k, t in batch.items()} } = {nbytes} B, model flops "
            f"{cell.model_flops!r}")
        del batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[19] all {len(cells)} cells' batches made on {dev} from a seeded generator, one at a "
        f"time; shapes, dtypes and id ranges checked; the largest batch {peak} B")


# ----------------------------------------------------------------------
# phase 20: sharded training on a process mesh (two gloo ranks on the card)
# ----------------------------------------------------------------------
SHARD_DIR = ROOT / "build" / "phase20"
SHARD_LIMIT_S = 300       # the ranks' limit, start included: a rank still running is killed
SHARD_SAS = (4, 2, 3)     # SASRec train_batch: steps, ckpt_every and fail_at of (c)
SHARD_LM = (2, 4, 1024, 3)   # qwen2-1.5B: layers, global batch, seq, steps of (d)
SHARD_TP_STEPS = 2        # (f): the same model and batches on (1, 2), pure tensor parallelism
# (b): float32 parameters after 4 steps, (2, 1) against one device, held as
# tests/test_torch_trainer.py holds the port to JAX: the gradients are summed in
# another order, and AdamW's step m / (sqrt(v) + eps) is ~ +-1 wherever |g| >> eps,
# so an element whose gradient is near 0 may move by up to lr x lr_scale a step in
# opposite ways on the two runs.  Every element within 2 lr sum(lr_scale) + rtol
# SHARD_RTOL, all but SHARD_FLIP_SHARE of them within SHARD_RTOL (+ 1e-7).
SHARD_RTOL = 1e-5
SHARD_FLIP_SHARE = 0.01
SHARD_LOSS_RTOL = 1e-5    # (b): SASRec's losses: the sums in another order
SHARD_LM_RTOL = 1e-4      # (d), (f): qwen2's bf16 losses against one device: bf16
#                           products at other row counts, float32 gradient sums for bf16 ones
SHARD_LM_NORM_RTOL = 1e-3  # (d), (f): each step's gradient norm against one device's
SHARD_PSUM = 1 << 20      # (e): float32 elements a rank of compressed_psum


def shard_rank(rank, world, device, ref_losses):
    """One rank of phase 20; results to ``rank<r>.pt``, an exception to
    ``rank<r>.err`` (and exit code 1)."""
    import traceback

    try:
        import torch

        torch.save(_shard_rank(rank, world, device, ref_losses), SHARD_DIR / f"rank{rank}.pt")
    except BaseException:
        (SHARD_DIR / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _timed(fn, spent, sync):
    """``fn`` whose every call's seconds (synchronised on both sides) are
    appended to ``spent``."""
    def wrapped(*a, **kw):
        sync()
        t = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        spent.append(time.perf_counter() - t)
        return out

    return wrapped


# the collectives of the LM's sharded compute, by kind: (module, function)
# spied in each rank; every call of one issues its collectives
LM_COLLECTIVES = {
    "gathers": ("repro_torch.distributed.fsdp", "gather_over"),
    "reduce_scatters": ("repro_torch.distributed.fsdp", "reduce_scatter_blocks"),
    "tp_all_reduces": ("repro_torch.distributed.tensor_parallel", "all_reduce"),
    "norm_all_reduces": ("repro_torch.optim.clipping", "_sum_over"),
    "replicated_all_reduces": ("repro_torch.launch.steps", "reduce_gradients"),
}


def collective_bytes(kind, args) -> int:
    """The bytes a rank sends in one call of a spied collective, reckoned
    as a ring over the K ranks of its axes: an all-gather (K - 1) blocks, a
    reduce-scatter (K - 1) / K of its input, an all-reduce 2 (K - 1) / K of
    its tensor (``reduce_gradients``: of its tree's leaves)."""
    from repro_torch.optim import tree_leaves

    if kind in ("gathers", "reduce_scatters"):
        t, _, mesh, axes = args[:4]
    elif kind == "replicated_all_reduces":
        t, axes, mesh = args[:3]
    else:
        t, mesh, axes = args[:3]
    nbytes = sum(x.nbytes for x in tree_leaves(t))
    K = math.prod(mesh.axis_size(a) for a in axes)
    if kind == "gathers":
        return (K - 1) * nbytes
    if kind == "reduce_scatters":
        return (K - 1) * nbytes // K
    return 2 * (K - 1) * nbytes // K


def _spied(fn, kind, out, sync):
    """``fn`` whose every call appends ``(seconds, bytes sent)`` to ``out``,
    both sides synchronised."""
    def wrapped(*a, **kw):
        sync()
        t = time.perf_counter()
        res = fn(*a, **kw)
        sync()
        out.append((time.perf_counter() - t, collective_bytes(kind, a)))
        return res

    return wrapped


def lm_collectives_reckoned(cfg, shape, accum) -> dict:
    """The calls a step of each kind of ``LM_COLLECTIVES`` on a (data,
    model) mesh of ``shape`` under ``LM_RULES``, from the layers, the
    leaves' logical axes and the microbatches: a leaf splits over ``data``
    where it has ``embed`` and over ``model`` where it has ``heads``,
    ``ff``, ``vocab`` or ``experts``.  A dense layer's leaves on ``data``
    are gathered in the forward and again in the recompute and
    reduce-scattered once a microbatch, the embedding and final norm once a
    step each way; over ``model`` a microbatch all-reduces the lookup, the
    cross-entropy's MAX and SUM and the logits' entry, and a GQA dense
    layer's two exits and two entries; the norm one all-reduce a set of
    axes; the leaves replicated over ``data`` one all-reduce."""
    from repro_torch.models import transformer_lm as lm

    if cfg.moe or cfg.attn == "mla":
        raise NotImplementedError("phase 20 reckons the dense GQA LM's collectives")

    def leaves(tree):
        return [x for v in tree.values() for x in leaves(v)] if isinstance(tree, dict) \
            else [tree]

    D, M = shape
    split = lambda logical: ("embed" in logical and D > 1,  # noqa: E731
                             any(n in logical for n in ("heads", "ff", "vocab")) and M > 1)
    specs = lm.param_specs(cfg)
    sets = {split(specs[k]) for k in ("embed", "final_norm")}
    on_data, replicated = 0, False
    for _, _, n, _ in lm._stacks(cfg):
        for logical in leaves(lm._block_axes(cfg, False)):
            sets.add(split(logical))
            on_data += n * split(logical)[0]
            replicated |= "embed" not in logical
    layers = cfg.n_layers
    out = {"gathers": 2 * (D > 1) + 2 * accum * on_data,
           "reduce_scatters": 2 * (D > 1) + accum * on_data,
           "tp_all_reduces": accum * (M > 1) * (4 + 4 * layers),
           "norm_all_reduces": len(sets - {(False, False)}),
           "replicated_all_reduces": int(replicated and D > 1)}
    return {k: v for k, v in out.items() if v}


def step_bytes(layout) -> dict:
    """The bytes a rank sends a sharded step, reckoned from the shapes: the
    gather of a leaf split in K parts sends (K - 1) blocks (a ring over each
    axis); the gradient all-reduce over D ranks 2 (D - 1) / D of the float32
    gradient (a ring)."""
    import math as m

    from repro_torch.distributed.shardings import block_shape, spec_leaves

    gather = reduce = 0
    D = layout.data_parallel
    for _, shape, spec in spec_leaves(layout.shapes, layout.params):
        size = shape.dtype.itemsize
        full = m.prod(shape.shape)
        block = m.prod(block_shape(shape.shape, spec, layout.mesh))
        gather += (full // block - 1) * block * size
        reduce += 2 * (D - 1) * full * 4 // D
    return {"gather": gather, "reduce": reduce}


def _shard_rank(rank, world, device, ref_losses):
    import datetime

    import torch
    import torch.distributed as dist

    import repro_torch.launch.steps as steps_mod
    from repro_torch.configs import get_arch
    from repro_torch.core import make_process_mesh
    from repro_torch.data import make_lm_batch_fn, make_sasrec_batch_fn
    from repro_torch.distributed import LM_RULES, RECSYS_RULES, elastic_restore, shard_tree
    from repro_torch.kernels import (
        embedding_bag_backward,
        embedding_bag_plan,
        embedding_bag_sums,
        same_bits,
    )
    from repro_torch.launch import TrainConfig, Trainer
    from repro_torch.models import sasrec
    from repro_torch.models import transformer_lm as lm
    from repro_torch.optim import (
        compressed_psum,
        state_logical_specs,
        tree_leaves,
        tree_map,
        warmup_cosine,
    )

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{SHARD_DIR / 'init'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    meshes = {"(1, 2)": make_process_mesh((1, 2), ("data", "model"), device=dev),
              "(2, 1)": make_process_mesh((2, 1), ("data", "model"), device=dev)}
    sync = torch.cuda.synchronize
    gathers = []
    spent = {kind: [] for kind in LM_COLLECTIVES}   # (seconds, bytes) a call
    real_gather = steps_mod.gather_tree
    steps_mod.gather_tree = _timed(real_gather, gathers, sync)
    real = {}
    for kind, (mod_name, name) in LM_COLLECTIVES.items():
        mod = importlib.import_module(mod_name)
        real[kind] = (mod, name, getattr(mod, name))
        setattr(mod, name, _spied(getattr(mod, name), kind, spent[kind], sync))
    reduces = spent["replicated_all_reduces"]
    kernels = (embedding_bag_sums, embedding_bag_backward, embedding_bag_plan)
    out = {"rank": rank, "runs": {}}
    ref = torch.load(SHARD_DIR / "sasrec_ref.pt", mmap=True, weights_only=False)
    ref_dev = tree_map(lambda t: t.to(dev), {"params": ref["params"], "opt": ref["opt"]})

    def same_tree(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(same_bits(x, y) if x.is_floating_point()
                                          else torch.equal(x, y) for x, y in zip(la, lb))

    def run(tag, trainer, make, **kw):
        """A fit with its timings, launches, collectives by kind a step and
        peak memory."""
        gathers.clear()
        for xs in spent.values():
            xs.clear()
        marks = []

        def marked(step):
            marks.append({kind: len(xs) for kind, xs in spent.items()})
            return make(step)

        for k in kernels:
            k.launches = 0
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        p, o, hist = trainer.fit(marked, **kw)
        sync()
        every = trainer.cfg.ckpt_every if kw.get("ckpt_dir") else None
        timed = [i for i, h in enumerate(hist)
                 if i > 0 and (every is None or h["step"] % every)]
        n = len(hist)

        def med(xs):  # one call a step: the median over the timed steps, in ms
            return statistics.median(xs[i] for i in timed) * 1e3 if xs and timed else 0.0

        out["runs"][tag] = {
            "losses": [h["loss"] for h in hist], "steps": [h["step"] for h in hist],
            "norms": [h["grad_norm"] for h in hist],
            "ms": med([h["sec_per_step"] for h in hist]) if timed else None,
            "each_ms": [h["sec_per_step"] * 1e3 for h in hist],
            "gather_ms": med(gathers), "reduce_ms": med([t for t, _ in reduces]),
            "calls": (len(gathers), len(reduces)),
            "peak": torch.cuda.max_memory_allocated(dev), "base": base,
            "launches": [k.launches for k in kernels], "n_steps": n,
            "bytes": step_bytes(trainer.layout),
            "kinds": {},
        }
        for kind, xs in spent.items():   # each step's calls, bytes and seconds
            cuts = [m[kind] for m in marks] + [len(xs)]
            each = [xs[cuts[i]:cuts[i + 1]] for i in range(len(marks))]
            out["runs"][tag]["kinds"][kind] = {
                "calls": [len(e) for e in each], "bytes": [sum(b for _, b in e) for e in each],
                "ms": [sum(t for t, _ in e) * 1e3 for e in each]}
        return p, o

    # (a) and (b): SASRec's train_batch on (1, 2) and on (2, 1)
    steps, every, fail_at = SHARD_SAS
    cell = get_arch("sasrec").cells()["train_batch"]
    cfg, users = cell.model_cfg, cell.batch_specs["seq"].shape[0]
    make = make_sasrec_batch_fn(cfg.vocab, users, cfg.seq_len, device=dev)
    gen = lambda: torch.Generator(dev).manual_seed(SEED)  # noqa: E731
    tc = dict(steps=steps, log_every=1)
    tcfg = TrainConfig(**tc)
    lr_sum = sum(float(warmup_cosine(torch.tensor(i), warmup=tcfg.warmup, total=steps))
                 for i in range(steps))
    for tag in ("(1, 2)", "(2, 1)"):
        tr = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tc), mesh=meshes[tag],
                     rules=RECSYS_RULES)
        p, o = run(f"sasrec {tag}", tr, make, generator=gen())
        r = out["runs"][f"sasrec {tag}"]
        r["bits"] = same_tree(p, ref_dev["params"]) and same_tree(o, ref_dev["opt"])
        r["held"] = params_held(p, ref_dev["params"], lr_sum)
        r["block_rows"] = tuple(tr.init_state(gen())[0]["item_emb"].shape)
        if tag == "(2, 1)":
            clean = (p, o)
        del p, o
    # (c): a failure at step 3 with a checkpoint every 2 on (2, 1), resumed
    ckpt = SHARD_DIR / "ckpt"
    tcc = dict(tc, ckpt_every=every)
    failing = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tcc, fail_at_step=fail_at),
                      mesh=meshes["(2, 1)"], rules=RECSYS_RULES)
    try:
        failing.fit(make, generator=gen(), ckpt_dir=str(ckpt))
        out["crash"] = "did not raise"
    except RuntimeError as exc:
        out["crash"] = str(exc)
    resumer = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tcc), mesh=meshes["(2, 1)"],
                      rules=RECSYS_RULES)
    p, o = run("sasrec (2, 1) resumed", resumer, make, generator=gen(), ckpt_dir=str(ckpt))
    out["resumed_bits"] = same_tree(p, clean[0]) and same_tree(o, clean[1])
    out["resumed_losses"] = (out["runs"]["sasrec (2, 1) resumed"]["losses"]
                             == out["runs"]["sasrec (2, 1)"]["losses"][every:])
    # elastic: that checkpoint (step 4) as blocks on (1, 2), then one more step
    lay = Trainer(sasrec, cfg, mesh=meshes["(1, 2)"], rules=RECSYS_RULES).layout
    example = lay.meta_state()
    logical = {"params": sasrec.param_specs(cfg),
               "opt": state_logical_specs(sasrec.param_specs(cfg))}
    t = time.perf_counter()
    blocks, step = elastic_restore(str(ckpt), example, logical, RECSYS_RULES, meshes["(1, 2)"])
    out["elastic_s"] = time.perf_counter() - t
    want = shard_tree({"params": p, "opt": o}, {"params": lay.params, "opt": lay.opt},
                      meshes["(1, 2)"])
    out["elastic"] = {"step": step, "bits": same_tree(blocks, want),
                      "rows": tuple(blocks["params"]["item_emb"].shape)}
    del p, o, clean, want, ref_dev
    tr12 = Trainer(sasrec, cfg, train_cfg=TrainConfig(**tc), mesh=meshes["(1, 2)"],
                   rules=RECSYS_RULES)
    _, _, m = tr12.train_step(blocks["params"], blocks["opt"], make(steps))
    out["elastic"]["loss"] = float(m["loss"])
    del blocks
    torch.cuda.empty_cache()
    # (d): qwen2-1.5B at full width, 2 layers, bf16, on (2, 1) under LM_RULES
    layers, gb, seq, lm_steps = SHARD_LM
    full = get_arch("qwen2-1.5b").cells()["train_4k"].model_cfg
    lcfg = dataclasses.replace(full, n_layers=layers)
    tr = Trainer(lm, lcfg, train_cfg=TrainConfig(steps=lm_steps, warmup=1, log_every=1),
                 mesh=meshes["(2, 1)"], rules=LM_RULES)
    p, o = run("qwen2 (2, 1)", tr, make_lm_batch_fn(lcfg.vocab, gb, seq, device=dev),
               generator=torch.Generator(dev).manual_seed(SEED + 20))
    out["runs"]["qwen2 (2, 1)"]["ref_losses"] = ref_losses
    out["runs"]["qwen2 (2, 1)"]["dtype"] = str(tree_leaves(p)[0].dtype)
    out["runs"]["qwen2 (2, 1)"]["digest"] = tree_digest({"p": p, "o": o})
    del p, o
    torch.cuda.empty_cache()
    # (f): the same model and batches on (1, 2) under LM_RULES: pure tensor parallelism
    tr = Trainer(lm, lcfg, train_cfg=TrainConfig(steps=SHARD_TP_STEPS, warmup=1, log_every=1),
                 mesh=meshes["(1, 2)"], rules=LM_RULES)
    p, o = run("qwen2 (1, 2)", tr, make_lm_batch_fn(lcfg.vocab, gb, seq, device=dev),
               generator=torch.Generator(dev).manual_seed(SEED + 20))
    out["runs"]["qwen2 (1, 2)"]["dtype"] = str(tree_leaves(p)[0].dtype)
    out["runs"]["qwen2 (1, 2)"]["digest"] = tree_digest({"p": p, "o": o})
    del p, o
    torch.cuda.empty_cache()
    # (e): compressed_psum of CUDA tensors over the two ranks
    xs = torch.randn(world, SHARD_PSUM, generator=torch.Generator().manual_seed(SEED + 21))
    flat = make_process_mesh((world,), ("pod",), device=dev)
    got = compressed_psum(xs[rank].to(dev), "pod", flat)
    out["psum"] = got.cpu()
    steps_mod.gather_tree = real_gather
    for mod, name, fn in real.values():
        setattr(mod, name, fn)
    dist.destroy_process_group()
    return out


def psum_formula(xs):
    """``compressed_psum``'s arithmetic over the rows of ``xs`` in one
    process on the CPU: the scale's max, int8 rounding half to even, an
    int32 sum, the mean."""
    import torch

    scale = max(torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0 for x in xs)
    total = sum(torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8).to(torch.int32)
                for x in xs)
    return total.float() * scale / torch.tensor(float(len(xs)))


def log_shard_run(tag, r, one_ms, rank):
    b = r["bytes"]
    ms = r["ms"]
    log(f"[20] {tag} rank {rank}: {ms:.3f} ms a step (median of the steps after the first "
        f"that write no checkpoint; each {', '.join(f'{x:.1f}' for x in r['each_ms'])}), the "
        f"one-device step {one_ms:.3f} ms; the gather {r['gather_ms']:.3f} ms a step = "
        f"{r['gather_ms'] / ms:.3f}, the gradient all-reduce {r['reduce_ms']:.3f} ms = "
        f"{r['reduce_ms'] / ms:.3f} (each side synchronised; gloo on CUDA tensors, not an "
        f"NCCL number); sent a step {b['gather'] + b['reduce']} B (gather {b['gather']}, "
        f"all-reduce {b['reduce']}); peak device memory {r['peak']} B; kernel 5 / 5' / its "
        f"preparation launches {r['launches']} in {r['n_steps']} steps")


def check_lm_leg(leg, tag, r, res, cfg, lm_hist, lm_peak, reckon):
    """Phase 20(d) / (f)'s checks of rank ``r``'s LM run ``tag``: its bf16
    losses and each step's gradient norm against the one-device run's
    (``lm_hist``: its losses and norms), the first loss against ln V +
    sigma^2 / 2; no ``gather_tree`` call; each step's collectives by kind equal to
    their reckoning; every rank's gathered parameters and AdamW state the
    same bits (the leaves replicated over an axis stayed so); the rank's
    peak below the one-device run's, both above their starting memory."""
    q = res[r]["runs"][tag]
    lm_losses, lm_norms = lm_hist
    n = len(q["losses"])
    rel = max(abs(x - y) / abs(y) for x, y in zip(q["losses"], lm_losses[:n]))
    norm_rel = max(abs(x - y) / abs(y) for x, y in zip(q["norms"], lm_norms[:n]))
    q["rel"], q["norm_rel"] = rel, norm_rel
    check(abs(q["losses"][0] - reckon) <= FIRST_LOSS_TOL and rel <= SHARD_LM_RTOL
          and q["dtype"] == "torch.bfloat16",
          f"phase 20({leg}) rank {r}: losses {q['losses']} against one device {lm_losses[:n]} "
          f"(at most {SHARD_LM_RTOL} relative; the first {reckon} +- {FIRST_LOSS_TOL})")
    check(norm_rel <= SHARD_LM_NORM_RTOL,
          f"phase 20({leg}) rank {r}: gradient norms {q['norms']} against one device "
          f"{lm_norms[:n]} (at most {SHARD_LM_NORM_RTOL} relative)")
    check(q["calls"][0] == 0, f"phase 20({leg}) rank {r}: {q['calls'][0]} gather_tree calls on "
          "the LM path")
    shape = (2, 1) if "(2, 1)" in tag else (1, 2)
    want = lm_collectives_reckoned(cfg, shape, 1)
    got = {k: v["calls"] for k, v in q["kinds"].items() if any(v["calls"])}
    check(got == {k: [c] * n for k, c in want.items()},
          f"phase 20({leg}) rank {r}: collectives a step {got}, reckoned {want}")
    check(all(rr["runs"][tag]["digest"] == q["digest"] for rr in res),
          f"phase 20({leg}): the ranks' gathered parameters and AdamW state differ")
    check(q["peak"] - q["base"] < lm_peak,
          f"phase 20({leg}) rank {r}: peak {q['peak'] - q['base']} B is not below the "
          f"one-device run's {lm_peak} B")


def log_lm_leg(tag, q, one_ms, one_peak, rank):
    """Phase 20(d) / (f)'s line for rank ``rank``: ms a step, each kind of
    collective's calls, bytes and ms a step (medians of the steps after the
    first), the peak against the one-device run's, and the largest relative
    differences of its losses and gradient norms from one device's."""
    kinds = []
    for kind, v in q["kinds"].items():
        if any(v["calls"]):
            kinds.append(f"{kind} {v['calls'][-1]} calls, {v['bytes'][-1]} B, "
                         f"{statistics.median(v['ms'][1:]):.3f} ms (step 1 {v['ms'][0]:.1f})")
    log(f"[20] {tag} rank {rank}: {q['ms']:.3f} ms a step (median of steps 2..; each "
        f"{', '.join(f'{x:.1f}' for x in q['each_ms'])}), the one-device step {one_ms:.3f} ms; "
        f"a step's collectives (each side synchronised, bytes a ring's reckoning; gloo on "
        f"CUDA tensors, not an NCCL number): {'; '.join(kinds)}; sent a step "
        f"{sum(v['bytes'][-1] for v in q['kinds'].values())} B; peak device memory "
        f"{q['peak'] - q['base']} B above the run's start ({q['peak']} B in all), the "
        f"one-device run's {one_peak} B; losses at most {q['rel']!r} relative from one device's "
        f"({SHARD_LM_RTOL}), gradient norms {q['norms']} at most {q['norm_rel']!r} "
        f"({SHARD_LM_NORM_RTOL})")


def drive_sharded_train(dev) -> list:
    """Phase 20: two gloo ranks on the one card train SASRec's train_batch
    on (1, 2) and (2, 1) ``("data", "model")`` meshes under ``RECSYS_RULES``,
    restart and elastically restore it, train qwen2-1.5B cut to 2 layers on
    (2, 1) and on (1, 2) under ``LM_RULES``, computing on its blocks (FSDP
    one layer at a time over ``data``, heads, ff and vocab over ``model``),
    and run ``compressed_psum`` on CUDA tensors; held to this process's
    one-device runs.  Returns the ranks' launches of kernel 5, 5' and its
    preparation on the path."""
    import multiprocessing

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_batch_fn, make_sasrec_batch_fn
    from repro_torch.launch import TrainConfig, Trainer
    from repro_torch.models import sasrec
    from repro_torch.models import transformer_lm as lm

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    # the one-device references, first, so that the ranks run alone on the card
    steps, every, fail_at = SHARD_SAS
    cell = get_arch("sasrec").cells()["train_batch"]
    cfg, users = cell.model_cfg, cell.batch_specs["seq"].shape[0]
    make = make_sasrec_batch_fn(cfg.vocab, users, cfg.seq_len, device=dev)
    p, o, hist = Trainer(sasrec, cfg, train_cfg=TrainConfig(steps=steps, log_every=1),
                         device=dev).fit(make, generator=torch.Generator(dev).manual_seed(SEED))
    sas_ms = statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3
    sas_losses = [h["loss"] for h in hist]
    torch.save({"params": sasrec.params_to(p, "cpu"),
                "opt": {k: (v.cpu() if k == "step" else sasrec.params_to(v, "cpu"))
                        for k, v in o.items()}}, SHARD_DIR / "sasrec_ref.pt")
    del p, o
    layers, gb, seq, lm_steps = SHARD_LM
    full = get_arch("qwen2-1.5b").cells()["train_4k"].model_cfg
    lcfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    lm_base = torch.cuda.memory_allocated(dev)
    _, _, lhist = Trainer(lm, lcfg, train_cfg=TrainConfig(steps=lm_steps, warmup=1, log_every=1),
                          device=dev).fit(make_lm_batch_fn(lcfg.vocab, gb, seq, device=dev),
                                          generator=torch.Generator(dev).manual_seed(SEED + 20))
    lm_peak = torch.cuda.max_memory_allocated(dev) - lm_base
    lm_ms = statistics.median(h["sec_per_step"] for h in lhist[1:]) * 1e3
    lm_losses = [h["loss"] for h in lhist]
    lm_norms = [h["grad_norm"] for h in lhist]
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_all
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(r, 2, str(dev), lm_losses)) for r in range(2)]
    for p_ in procs:
        p_.start()
    deadline = time.monotonic() + SHARD_LIMIT_S
    try:
        for p_ in procs:
            p_.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p_ in enumerate(procs) if p_.is_alive()]
    finally:
        for p_ in procs:
            if p_.is_alive():
                p_.kill()
                p_.join(10)
    for r in range(2):
        err = SHARD_DIR / f"rank{r}.err"
        check(not err.exists(), f"phase 20 rank {r} failed:\n"
              + (err.read_text() if err.exists() else ""))
    check(not hung, f"phase 20: ranks {hung} still running after {SHARD_LIMIT_S} s, killed")
    check(all(p_.exitcode == 0 for p_ in procs),
          f"phase 20 exit codes {[p_.exitcode for p_ in procs]}")
    res = [torch.load(SHARD_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    xs = torch.randn(2, SHARD_PSUM, generator=torch.Generator().manual_seed(SEED + 21))
    want_psum = psum_formula(list(xs))
    log(f"[20] from the registry: sasrec/train_batch, {users} users x {cfg.seq_len}, "
        f"{cfg.vocab} items (no cut), {steps} steps; qwen2-1.5b/train_4k cut to {layers} of "
        f"{full.n_layers} layers and a global batch of {gb} x {seq} (the cell's 256 x 4096), "
        f"{lm_steps} steps, {lcfg.dtype}; two gloo ranks on {CARD}; one-device references "
        f"{t_ref:.1f} s")
    launches = [0, 0, 0]
    reckon = first_loss_reckoned(lcfg)
    for r, rr in enumerate(res):
        runs = rr["runs"]
        a, b = runs["sasrec (1, 2)"], runs["sasrec (2, 1)"]
        check(a["bits"] and a["losses"] == sas_losses,
              f"phase 20(a) rank {r}: (1, 2) differs from the one-device Trainer")
        check(a["block_rows"] == (cfg.vocab // 2, cfg.embed_dim) and b["block_rows"] == (
            cfg.vocab, cfg.embed_dim), f"phase 20 rank {r}: item_emb blocks {a['block_rows']}, "
              f"{b['block_rows']}")
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], sas_losses))
        worst, far, total, big = b["held"]
        check(worst <= 1.0 and far <= SHARD_FLIP_SHARE * total and loss_rel <= SHARD_LOSS_RTOL,
              f"phase 20(b) rank {r}: parameters at {worst} of their bound from one device, "
              f"{far} of {total} past rtol {SHARD_RTOL}; losses {loss_rel} (at most "
              f"{SHARD_LOSS_RTOL})")
        check(b["launches"][:2] == [3 * steps, 3 * steps] and a["launches"][:2] == [
            3 * steps, 3 * steps], f"phase 20 rank {r}: kernel 5 / 5' launches (1, 2) "
              f"{a['launches']}, (2, 1) {b['launches']}, not 3 a step")
        check(rr["crash"] == f"injected failure at step {fail_at}" and rr["resumed_bits"]
              and rr["resumed_losses"], f"phase 20(c) rank {r}: the resumed run differs from "
              f"the clean (2, 1) run ({rr['crash']!r})")
        el = rr["elastic"]
        check(el["step"] == steps and el["bits"] and el["rows"] == (cfg.vocab // 2, cfg.embed_dim)
              and math.isfinite(el["loss"]), f"phase 20(c) rank {r}: elastic restore {el}")
        q = runs["qwen2 (2, 1)"]
        q_rel = max(abs(x - y) / abs(y) for x, y in zip(q["losses"], lm_losses))
        for leg, tag in (("d", "qwen2 (2, 1)"), ("f", "qwen2 (1, 2)")):
            check_lm_leg(leg, tag, r, res, lcfg, (lm_losses, lm_norms), lm_peak, reckon)
        psum_bits = torch.equal(rr["psum"].view(torch.int32), want_psum.view(torch.int32))
        check(psum_bits, f"phase 20(e) rank {r}: compressed_psum differs from the formula, max "
              f"{float((rr['psum'] - want_psum).abs().max())}")
        for tag in ("sasrec (1, 2)", "sasrec (2, 1)", "sasrec (2, 1) resumed"):
            n, dp = runs[tag]["n_steps"], "(2, 1)" in tag
            check(runs[tag]["calls"] == (n, n if dp else 0),
                  f"phase 20 rank {r} {tag}: (gathers, gradient all-reduces) "
                  f"{runs[tag]['calls']} in {n} steps")
            if runs[tag]["ms"] is not None:
                log_shard_run(tag, runs[tag], sas_ms, r)
        for tag in ("qwen2 (2, 1)", "qwen2 (1, 2)"):
            log_lm_leg(tag, runs[tag], lm_ms, lm_peak, r)
        log(f"[20] rank {r}: (b) parameters against one device: max abs difference {big!r}, "
            f"{worst:.4f} of the bound 2 lr sum(lr_scale) + rtol {SHARD_RTOL}, {far} of {total} "
            f"elements past rtol {SHARD_RTOL} (at most {SHARD_FLIP_SHARE} of them); losses "
            f"{loss_rel!r} relative ({SHARD_LOSS_RTOL}); "
            f"(c) elastic restore of step {el['step']} onto (1, 2) {rr['elastic_s']:.2f} s, "
            f"one more step's loss {el['loss']:.6f}; (d) losses {q['losses']} against one "
            f"device {lm_losses}: at most {q_rel!r} relative (tolerance {SHARD_LM_RTOL}), the "
            f"first {q['losses'][0] - reckon:+.4f} from ln V + sigma^2 / 2 = {reckon:.4f}")
        for tag in ("sasrec (1, 2)", "sasrec (2, 1)", "sasrec (2, 1) resumed"):
            for i in range(3):
                launches[i] += runs[tag]["launches"][i]
    log(f"[20] two ranks on {CARD}, gloo: (a) SASRec on (1, 2) bit for bit the one-device "
        f"Trainer ({sas_losses}); (b) on (2, 1) within tolerance; (c) a failure at step "
        f"{fail_at} resumed from step {every} bit for bit the clean (2, 1) run, its step-{steps} "
        f"checkpoint restored onto (1, 2) bit for bit; (d) qwen2 {layers} layers on (2, 1) and "
        f"(f) on (1, 2), computing on their blocks; (e) "
        f"compressed_psum of {SHARD_PSUM} float32 a rank on the card bit for bit the formula on "
        f"the CPU; kernel 5 / 5' / preparation launches on the ranks {launches}; one-device "
        f"steps: SASRec {sas_ms:.3f} ms, qwen2 {lm_ms:.3f} ms; phase wall "
        f"{time.perf_counter() - t_all:.1f} s (spawn included)")
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return launches


# ----------------------------------------------------------------------
# phase 21: serving on a process mesh (two gloo ranks on the card)
# ----------------------------------------------------------------------
SERVE_DIR = ROOT / "build" / "phase21"
SERVE_LIMIT_S = 300       # the ranks' limit, start included: a rank still running is killed
SERVE_LM = (8, 1024, 32768, 16)   # (b): prompts, prompt tokens, cache positions, decode steps
SERVE_LONG_STEPS = 8      # (c): decode steps at the end of long_500k's uncut cache
FILL_ROWS = 4096          # (c): cache rows a seeded draw fills at a time
SERVE_MLA = (2, 8, 1024, 2048, 8)  # (d): layers, prompts, prompt tokens, cache positions, steps
LSE_TOL = 1e-5            # (a): kernel 6's lse against the plain version's, float32, absolute:
#                           the same scores summed in another order, at lse ~ ln(rows) + O(1)
LSE_TIMED = (32, 16384, 12, 2, 128)  # (a): one rank's half of qwen2-1.5B's 32 x 32k cache


def lse_ranges(S, parts):
    """``parts`` contiguous row ranges of a cache of ``S`` rows (uneven
    where ``parts`` does not divide ``S``)."""
    cuts = [S * r // parts for r in range(parts + 1)]
    return list(zip(cuts, cuts[1:]))


def check_kernel6_lse(dev):
    """Phase 21(a): every case of phase 10(a)'s kernel-6 sweep with its cache
    cut into 2 and 4 row ranges (at short lengths some ranges hold no row):
    kernel 6 with ``return_lse=True`` on each range, merged, held to the
    whole-cache kernel and to the plain version within ``ATTN_REL_TOL``;
    each range's lse within ``LSE_TOL`` of the plain version's; ranges with
    no row exactly 0 and -inf; the lse variant's output, rounded, bit for
    bit the call without it.  Then one rank's half of qwen2-1.5B's cache
    timed both ways beside the bytes bound.  Returns the timing."""
    import numpy as np
    import torch

    from repro_torch.distributed.serving import merge_partials
    from repro_torch.kernels import (
        ATTN_REL_TOL,
        decode_attention,
        decode_attention_ref,
        decode_attention_rel_err,
    )
    from repro_torch.kernels.decode_attention.decode_attention import split_rows
    from repro_torch.tuning import HBM_BYTES_PER_S

    rng = np.random.default_rng(SEED + 21)
    cases, rel, lse_err, empties = 0, {}, 0.0, 0
    for i, (B, S, Hq, Hkv, D) in enumerate(ATTN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_case(B, S, Hq, Hkv, D, dtype, dev, SEED + i)
            for name, lengths in attn_lengths(B, S, split_rows(q, k)[1], rng).items():
                pos = torch.from_numpy(lengths.astype("int32")).to(dev)
                whole = decode_attention(q, k, v, pos)
                plain = decode_attention_ref(q, k, v, pos)
                full, full_lse = decode_attention(q, k, v, pos, return_lse=True)
                check(full.dtype == torch.float32 and torch.equal(full.to(dtype), whole),
                      f"kernel 6 lse {(B, S, Hq, Hkv, D)} {dtype} pos {name}: the output "
                      "rounded is not the lse-less call's bit for bit")
                lse_err = max(lse_err, float((full_lse - decode_attention_ref(
                    q, k, v, pos, return_lse=True)[1]).abs().max()))
                for parts in (2, 4):
                    outs, lses = [], []
                    for lo, hi in lse_ranges(S, parts):
                        kr, vr = k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous()
                        n = (pos - lo).clamp(0, hi - lo).to(torch.int32)
                        o, lse = decode_attention(q, kr, vr, n, return_lse=True)
                        want_lse = decode_attention_ref(q, kr, vr, n, return_lse=True)[1]
                        empty = n == 0
                        check(torch.equal(o[empty], torch.zeros_like(o[empty]))
                              and bool((lse[empty] == -math.inf).all()),
                              f"kernel 6 lse: a range with no row is not 0 and -inf "
                              f"({(B, S, Hq, Hkv, D)} {dtype} pos {name}, rows [{lo}, {hi}))")
                        empties += int(empty.sum())
                        if not bool(empty.all()):
                            lse_err = max(lse_err, float(
                                (lse[~empty] - want_lse[~empty]).abs().max()))
                        outs.append(o)
                        lses.append(lse)
                    merged = merge_partials(torch.stack(outs), torch.stack(lses)).to(dtype)
                    r = max(decode_attention_rel_err(merged, whole),
                            decode_attention_rel_err(merged, plain))
                    check(r <= ATTN_REL_TOL[dtype],
                          f"kernel 6 lse {(B, S, Hq, Hkv, D)} {dtype} pos {name} in {parts} "
                          f"ranges: merged relative error {r} (> {ATTN_REL_TOL[dtype]})")
                    dname = str(dtype).removeprefix("torch.")
                    rel[dname] = max(rel.get(dname, 0.0), r)
                    cases += 1
    check(lse_err <= LSE_TOL, f"kernel 6 lse: {lse_err} from the plain version's (> {LSE_TOL})")
    B, S, Hq, Hkv, D = LSE_TIMED
    q, k, v = attn_case(B, S, Hq, Hkv, D, torch.bfloat16, dev, SEED)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    nbytes = attn_bytes(q, k, pos) + B * Hq * (D * 2 + 4)  # out in float32, and the lse
    t = dict(ms=device_ms(lambda: decode_attention(q, k, v, pos, return_lse=True)),
             plain_call_ms=device_ms(lambda: decode_attention(q, k, v, pos)),
             bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    check_bound("kernel 6 with its lse", t)
    log(f"[21] (a) kernel 6 with return_lse=True, each cache of phase 10(a)'s sweep cut into 2 "
        f"and 4 row ranges and merged: {cases} cases within ATTN_REL_TOL of the whole-cache "
        f"kernel and of the plain version (max relative error float32 {rel['float32']!r}, "
        f"bfloat16 {rel['bfloat16']!r}; limits {ATTN_REL_TOL[torch.float32]}, "
        f"{ATTN_REL_TOL[torch.bfloat16]}); lse within {lse_err!r} of the plain version's "
        f"(limit {LSE_TOL}, float32 absolute); {empties} rows of ranges with no row exactly 0 "
        f"and -inf; the output rounded bit for bit the call without lse")
    log(f"[21] (a) kernel 6 at (B,S,Hq,Hkv,D)={LSE_TIMED} bfloat16 (one rank's half of the "
        f"32 x 32,768 cache), pos=S, on {CARD}: with its lse {t['ms']!r} ms, without "
        f"{t['plain_call_ms']!r} ms, bytes bound {t['bound_ms']!r} ms ({nbytes} B at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s)")
    del q, k, v
    return t


def fill_cache(caches, lo, gen_dev):
    """Fill every leaf (L, 1, rows, ...) of ``caches``, global positions
    from ``lo``, block by block of ``FILL_ROWS``: block j of layer l of leaf
    ``name`` drawn from its own seed, so a rank fills its slice alone."""
    import torch

    for key, entry in caches.items():
        for w, (name, t) in enumerate(entry.items()):
            for layer in range(t.shape[0]):
                for a in range(0, t.shape[2], FILL_ROWS):
                    j = (lo + a) // FILL_ROWS
                    seed = SEED + 7919 * (layer + 1) + 104729 * w + 31 * j + len(key)
                    g = torch.Generator(gen_dev).manual_seed(seed)
                    t[layer, :, a:a + FILL_ROWS].normal_(generator=g)


def rows_digest(caches, a, b) -> dict:
    """SHA-256 of rows [a, b) of every cache leaf (bfloat16, read as int16),
    by path."""
    import torch

    return {f"{key}/{name}": hashlib.sha256(
        t[:, :, a:b].contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        for key, entry in caches.items() for name, t in entry.items()}


def serve_ref_lm(dev, cfg, B, P, max_seq, steps, seed, splits):
    """One device: ``cfg``'s prefill of B x P prompts into ``max_seq`` rows
    and ``steps`` greedy decode steps (kernel 6 for GQA).  Returns the
    tokens fed, the prefill's and every step's logits (on the host), ms a
    step (median of the steps after the first) and the digests of the
    prompt rows within each of ``splits`` equal slices."""
    import torch

    from repro_torch.models import transformer_lm as lm

    params = lm.init(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(seed)).to(dev)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    logits, caches = lm.prefill(params, prompts, cfg, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - ts
    size = max_seq // splits
    digests = [rows_digest(caches, r * size, min((r + 1) * size, P)) if r * size < P else {}
               for r in range(splits)]
    out = {"prompts": prompts.cpu(), "logits0": logits.cpu(), "tokens": [], "logits": [],
           "digests": digests, "prefill_s": prefill_s}
    times = []
    for i in range(steps):
        tok = logits.argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        logits, caches = lm.decode_step(params, caches, tok, P + i, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        out["tokens"].append(tok.cpu())
        out["logits"].append(logits.cpu())
    out["ms"] = statistics.median(times[1:]) * 1e3
    del params, caches
    return out


def serve_ref_long(dev, cfg, seed, steps):
    """One device: qwen2-1.5B at long_500k, uncut (batch 1, the cell's
    positions), the cache filled by ``fill_cache``, ``steps`` greedy decode
    steps at its end."""
    import torch

    from repro_torch.models import transformer_lm as lm

    params = lm.init(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    S = cfg.kv_block
    caches = lm.make_cache(cfg, 1, S, device=dev)
    fill_cache(caches, 0, dev)
    tok = torch.randint(0, cfg.vocab, (1, 1), generator=torch.Generator().manual_seed(seed))
    tok = tok.to(dev)
    out, times = {"tokens": [], "logits": []}, []
    for i in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        logits, caches = lm.decode_step(params, caches, tok, S - steps + i, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        out["tokens"].append(tok.cpu())
        out["logits"].append(logits.cpu())
        tok = logits.argmax(dim=-1, keepdim=True)
    out["ms"] = statistics.median(times[1:]) * 1e3
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    del params, caches
    return out


def serve_ref_sasrec(dev):
    """One device: serve_p99's and retrieval_cand's ms a call at full width
    (phase 11's seeds)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_candidates, make_sasrec_batch_fn
    from repro_torch.launch import sasrec_retrieval_step, sasrec_serve_step
    from repro_torch.models import sasrec

    cells = get_arch("sasrec").cells()
    cfg = cells["serve_p99"].model_cfg
    users = cells["serve_p99"].batch_specs["seq"].shape[0]
    n_cand = cells["retrieval_cand"].batch_specs["candidates"].shape[1]
    params = sasrec.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    batch = make_sasrec_batch_fn(cfg.vocab, users, cfg.seq_len, device=dev)(SEED)
    query = {"seq": batch["seq"][:1],
             "candidates": make_candidates(torch.Generator(dev).manual_seed(SEED + 1), 1, n_cand,
                                           cfg.vocab, device=dev)}
    sasrec_serve_step(params, batch, cfg)
    sasrec_retrieval_step(params, query, cfg)
    serve_s, _ = timed_calls(lambda: sasrec_serve_step(params, batch, cfg))
    ret_s, _ = timed_calls(lambda: sasrec_retrieval_step(params, query, cfg))
    return {"serve_ms": statistics.median(serve_s) * 1e3,
            "retrieval_ms": statistics.median(ret_s) * 1e3}


def serve_cells():
    """(qwen2 prefill cfg, qwen2 long_500k cfg, deepseek cut cfg) and the
    cells they come from."""
    from repro_torch.configs import get_arch

    qwen = get_arch("qwen2-1.5b").cells()
    deep = get_arch("deepseek-v2-lite-16b").cells()
    layers = SERVE_MLA[0]
    return (qwen["prefill_32k"].model_cfg, qwen["long_500k"].model_cfg,
            dataclasses.replace(deep["prefill_32k"].model_cfg, n_layers=layers), qwen, deep)


def serve_rank(rank, world, device):
    """One rank of phase 21; results to ``rank<r>.pt``, an exception to
    ``rank<r>.err`` (and exit code 1)."""
    import traceback

    try:
        import torch

        torch.save(_serve_rank(rank, world, device), SERVE_DIR / f"rank{rank}.pt")
    except BaseException:
        (SERVE_DIR / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def serve_bytes(kind, **s) -> int:
    """The bytes a rank sends a step, reckoned from the shapes as ring
    collectives over R ranks: an all-gather sends (R - 1) parts, an
    all-reduce 2 (R - 1) / R of the tensor."""
    R = s["R"]
    if R == 1:
        return 0
    if kind == "decode":   # a (B_r, Hq, D + 1) float32 all-gather a layer
        return (R - 1) * s["B"] * s["Hq"] * (s["D"] + 1) * 4 * s["layers"]
    history = 2 * (R - 1) * s["B"] * s["L"] * s["d"] * 4 // R   # sharded_rows' all-reduce
    if kind == "serve":    # + merge_topk's (2, B_r, 100) all-gather
        return history + (R - 1) * 2 * s["B"] * s["k"] * 4
    # retrieval: the ids' all-gather, then the scores' all-reduce over R blocks
    return history + (R - 1) * s["B"] * s["nc"] * 4 + 2 * (R - 1) * s["B"] * s["nc"] * 4


def _serve_rank(rank, world, device):
    import datetime

    import torch
    import torch.distributed as dist

    import repro_torch.distributed.serving as serving_mod
    import repro_torch.launch.steps as steps_mod
    from repro_torch.configs import get_arch
    from repro_torch.core import make_process_mesh
    from repro_torch.data import make_candidates, make_sasrec_batch_fn
    from repro_torch.distributed import (
        LM_DECODE_LONG_RULES,
        LM_DECODE_RULES,
        LM_PREFILL_RULES,
        RECSYS_RETRIEVAL_RULES,
        RECSYS_RULES,
        merge_attention,
        shard_tree,
        sharded_rows,
    )
    from repro_torch.kernels import (
        decode_attention,
        decode_attention_ref,
        decode_attention_rel_err,
        embedding_bag_sums,
        take_rows,
    )
    from repro_torch.launch import (
        TOP_K,
        assert_topk_agrees,
        sasrec_retrieval_step,
        sasrec_serve_step,
        serve_layout,
        sharded_decode_step,
        sharded_prefill_step,
        sharded_retrieval_step,
        sharded_serve_step,
    )
    from repro_torch.models import sasrec
    from repro_torch.models import transformer_lm as lm
    from repro_torch.optim import tree_map

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{SERVE_DIR / 'init'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    m12 = make_process_mesh((1, 2), ("data", "model"), device=dev)
    m21 = make_process_mesh((2, 1), ("data", "model"), device=dev)
    sync = torch.cuda.synchronize
    gather_parts = serving_mod.gather_parts   # the logits' vocab gather: outside the timing
    spent = []
    real = {(mod, name): getattr(mod, name) for mod in (serving_mod, steps_mod)
            for name in ("gather_parts", "all_reduce_sum")}
    for (mod, name), fn in real.items():
        setattr(mod, name, _timed(fn, spent, sync))
    qcfg, long_cfg, mla_cfg, _, _ = serve_cells()
    out = {"rank": rank}

    def counts_zero():
        decode_attention.launches = 0
        embedding_bag_sums.launches = 0
        spent.clear()

    def counts():
        return {"k5": embedding_bag_sums.launches, "k6": decode_attention.launches}

    def timed_steps(step, n):
        """``n`` calls of ``step(i)``, each synchronised; ms a step (median of
        the calls after the first), the collectives' ms a step (median) and
        the results."""
        times, coll, res = [], [], []
        for i in range(n):
            before = len(spent)
            sync()
            ts = time.perf_counter()
            res.append(step(i))
            sync()
            times.append(time.perf_counter() - ts)
            coll.append(sum(spent[before:]))
        later = slice(1, None) if n > 1 else slice(None)
        return (statistics.median(times[later]) * 1e3, statistics.median(coll[later]) * 1e3,
                res)

    def full_logits(logits, layout):
        """The rank's vocab columns gathered over the vocab axes: (B_r, V)."""
        parts = gather_parts(logits, layout.mesh, layout.vocab_axes)
        return parts.permute(1, 0, 2).reshape(logits.shape[0], -1)

    def attention_rows(layout, caches, rows, lengths, B):
        """Kernel 6 with its lse over layer 0's slice of every rank, merged,
        against the plain version over the whole layer (gathered): the
        largest row error (relative L2)."""
        entry = next(iter(caches.values()))
        k, v = entry["k"][0], entry["v"][0]
        H = qcfg.n_heads
        q = torch.randn((B, H, k.shape[-1]), generator=torch.Generator(dev).manual_seed(SEED),
                        device=dev).to(k.dtype)
        n = torch.full((B,), lengths, dtype=torch.int32, device=dev)
        got = merge_attention(*decode_attention(q, k, v, n, return_lse=True), layout.mesh,
                              layout.seq_axes).to(k.dtype)
        whole = [gather_parts(t, layout.mesh, layout.seq_axes) for t in (k, v)]
        kw, vw = (w.permute(1, 0, 2, 3, 4).reshape(B, -1, *k.shape[2:]) for w in whole)
        want = decode_attention_ref(q, kw, vw, torch.full((B,), rows, dtype=torch.int32,
                                                           device=dev))
        return decode_attention_rel_err(got, want)

    def serve_lm(tag, cfg, mesh, ref, max_seq, seed):
        """(b) and (d): load, prefill, then the reference's tokens decoded."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        lay_p = serve_layout(lm, cfg, mesh, LM_PREFILL_RULES)
        lay_d = serve_layout(lm, cfg, mesh, LM_DECODE_RULES)
        params = lm.init(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
        blocks = tree_map(lambda t: t.clone(), shard_tree(params, lay_p.params, mesh))
        del params
        sync()
        ts = time.perf_counter()
        served = lay_p.load(blocks)
        sync()
        load_s = time.perf_counter() - ts
        del blocks
        prompts = ref["prompts"].to(dev)
        B, P = prompts.shape
        lo, hi = lay_p.rows(B)
        s_lo, s_hi = lay_p.block(lay_p.seq_axes, max_seq)
        sync()
        ts = time.perf_counter()
        logits0, caches = sharded_prefill_step(served, prompts[lo:hi], cfg, lay_p, max_seq)
        sync()
        r = {"prefill_s": time.perf_counter() - ts, "load_s": load_s, "rows": (lo, hi),
             "seq": (s_lo, s_hi), "logits0": full_logits(logits0, lay_p).cpu()}
        a, b = s_lo, min(s_hi, P)
        r["digest"] = rows_digest(caches, 0, b - a) if a < b else {}
        r["zero_past_prompt"] = not any(bool(t[:, :, max(b - a, 0):].any())
                                        for e in caches.values() for t in e.values())
        counts_zero()
        toks = [t.to(dev)[lo:hi] for t in ref["tokens"]]
        ms, coll, res = timed_steps(lambda i: sharded_decode_step(
            served, caches, toks[i], P + i, cfg, lay_d)[0], len(toks))
        r.update(counts(), ms=ms, coll_ms=coll, logits=[full_logits(x, lay_d).cpu() for x in res],
                 peak=torch.cuda.max_memory_allocated(dev))
        if cfg.attn != "mla":
            valid = P + len(toks)
            r["attn_rel"] = attention_rows(lay_d, caches, valid,
                                           min(max(valid - s_lo, 0), s_hi - s_lo), hi - lo)
        R = math.prod(mesh.axis_size(x) for x in lay_d.seq_axes)
        dv = cfg.v_head_dim if cfg.attn == "mla" else cfg.d_head
        r["bytes"] = serve_bytes("decode", R=R, B=hi - lo, Hq=cfg.n_heads, D=dv,
                                 layers=cfg.n_layers)
        del served, caches, res
        out[tag] = r
        return r

    # (b) qwen2-1.5B as a server on (1, 2), full width and depth
    B, P, max_seq, steps = SERVE_LM
    serve_lm("b", qcfg, m12, torch.load(SERVE_DIR / "qwen2.pt", weights_only=False), max_seq,
             SEED + 210)
    # (c) long_500k on (2, 1), uncut: a cache filled by blocks of rows
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ref = torch.load(SERVE_DIR / "long.pt", weights_only=False)
    lay = serve_layout(lm, long_cfg, m21, LM_DECODE_LONG_RULES)
    params = lm.init(long_cfg, generator=torch.Generator(dev).manual_seed(SEED + 210),
                     device=dev)
    blocks = tree_map(lambda t: t.clone(), shard_tree(params, lay.params, m21))
    del params
    sync()
    ts = time.perf_counter()
    served = lay.load(blocks)
    sync()
    load_s = time.perf_counter() - ts
    del blocks
    S = long_cfg.kv_block
    s_lo, s_hi = lay.block(lay.seq_axes, S)
    caches = lm.make_cache(long_cfg, 1, s_hi - s_lo, device=dev)
    fill_cache(caches, s_lo, dev)
    counts_zero()
    toks = [t.to(dev) for t in ref["tokens"]]
    ms, coll, res = timed_steps(lambda i: sharded_decode_step(
        served, caches, toks[i], S - len(toks) + i, long_cfg, lay)[0], len(toks))
    out["c"] = dict(counts(), ms=ms, coll_ms=coll, load_s=load_s, seq=(s_lo, s_hi),
                    logits=[full_logits(x, lay).cpu() for x in res],
                    cache_bytes=sum(t.numel() * t.element_size() for e in caches.values()
                                    for t in e.values()),
                    peak=torch.cuda.max_memory_allocated(dev),
                    attn_rel=attention_rows(lay, caches, S, s_hi - s_lo, 1),
                    bytes=serve_bytes("decode", R=2, B=1, Hq=long_cfg.n_heads,
                                      D=long_cfg.d_head, layers=long_cfg.n_layers))
    del served, caches, res
    # (d) deepseek-v2-lite-16b cut to 2 layers (MLA, no kernel) on (1, 2)
    serve_lm("d", mla_cfg, m12, torch.load(SERVE_DIR / "mla.pt", weights_only=False),
             SERVE_MLA[3], SEED + 212)
    # (e) SASRec uncut: serve_p99 and retrieval_cand on (1, 2) and (2, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cells = get_arch("sasrec").cells()
    cfg = cells["serve_p99"].model_cfg
    users = cells["serve_p99"].batch_specs["seq"].shape[0]
    n_cand = cells["retrieval_cand"].batch_specs["candidates"].shape[1]
    params = sasrec.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    batch = make_sasrec_batch_fn(cfg.vocab, users, cfg.seq_len, device=dev)(SEED)
    query = {"seq": batch["seq"][:1],
             "candidates": make_candidates(torch.Generator(dev).manual_seed(SEED + 1), 1, n_cand,
                                           cfg.vocab, device=dev)}
    want_scores = sasrec.serve_scores(params, batch, cfg)
    want_top = sasrec_serve_step(params, batch, cfg)
    want_ret = sasrec_retrieval_step(params, query, cfg)
    e = {}
    for tag, mesh in (("(1, 2)", m12), ("(2, 1)", m21)):
        lay = serve_layout(sasrec, cfg, mesh, RECSYS_RULES)
        served = lay.load(shard_tree(params, lay.params, mesh))
        block = served["item_emb"]
        digest = tensor_digest(block)
        R = math.prod(mesh.axis_size(x) for x in lay.rows_axes)
        r_lo = lay.block(lay.rows_axes, cfg.vocab)[0]
        lo, hi = lay.rows(users)
        seq = batch["seq"][lo:hi]
        got_rows = sharded_rows(block, seq, r_lo, mesh, lay.rows_axes)
        lookups_bits = torch.equal(got_rows.view(torch.int32),
                                   take_rows(params["item_emb"], seq).view(torch.int32))
        scores = sasrec.serve_scores(served, {"seq": seq}, cfg, lookup=lambda ids: sharded_rows(
            block, ids, r_lo, mesh, lay.rows_axes))
        score_err = float((scores - want_scores[lo:hi, r_lo:r_lo + block.shape[0]]).abs().max())
        del got_rows, scores
        sharded_serve_step(served, {"seq": seq}, cfg, lay)   # warm-up
        counts_zero()
        ms, coll, res = timed_steps(lambda i: sharded_serve_step(served, {"seq": seq}, cfg, lay),
                                    RECSYS_CALLS)
        top = res[-1]
        ties = assert_topk_agrees(top, {k: v[lo:hi] for k, v in want_top.items()},
                                  want_scores[lo:hi], SCORE_TOL, f"phase 21(e) serve {tag}")
        e[f"serve {tag}"] = dict(counts(), ms=ms, coll_ms=coll, bits=lookups_bits,
                                 score_err=score_err, ties=ties, rows=(lo, hi),
                                 block=tuple(block.shape), unwritten=tensor_digest(block) == digest,
                                 bytes=serve_bytes("serve", R=R, B=hi - lo, L=cfg.seq_len,
                                                   d=cfg.embed_dim, k=TOP_K))
        lay = serve_layout(sasrec, cfg, mesh, RECSYS_RETRIEVAL_RULES)
        served = lay.load(shard_tree(params, lay.params, mesh))
        c_lo, c_hi = lay.block(lay.cand_axes, n_cand)
        part = {"seq": query["seq"], "candidates": query["candidates"][:, c_lo:c_hi]}
        sharded_retrieval_step(served, part, cfg, lay)   # warm-up
        counts_zero()
        ms, coll, res = timed_steps(lambda i: sharded_retrieval_step(served, part, cfg, lay),
                                    RECSYS_CALLS)
        ret_err = float((res[-1] - want_ret[:, c_lo:c_hi]).abs().max())
        e[f"retrieval {tag}"] = dict(counts(), ms=ms, coll_ms=coll, err=ret_err,
                                     cands=(c_lo, c_hi),
                                     unwritten=tensor_digest(served["item_emb"]) == digest,
                                     bytes=serve_bytes("retrieval", R=R, B=1, L=cfg.seq_len,
                                                       d=cfg.embed_dim, nc=c_hi - c_lo))
        del served, res
    e["peak"] = torch.cuda.max_memory_allocated(dev)
    out["e"] = e
    for (mod, name), fn in real.items():
        setattr(mod, name, fn)
    dist.destroy_process_group()
    return out


def log_serve(tag, r, one_ms, rank, what):
    ms = r["ms"]
    log(f"[21] ({tag}) rank {rank}, {what}: {ms:.3f} ms a step (median after the first), "
        f"one device {one_ms:.3f} ms; collectives {r['coll_ms']:.3f} ms a step = "
        f"{r['coll_ms'] / ms:.3f} (each side synchronised; gloo on CUDA tensors, not an NCCL "
        f"number); sent a step {r['bytes']} B (reckoned as ring collectives); kernel 5 / 6 "
        f"launches {r['k5']} / {r['k6']}" + (f"; peak device memory {r['peak']} B"
                                            if "peak" in r else ""))


def drive_sharded_serve(dev) -> tuple:
    """Phase 21: (a) kernel 6's lse in this process; then two gloo ranks on
    the one card serve (b) qwen2-1.5B on (1, 2) under ``LM_PREFILL_RULES`` /
    ``LM_DECODE_RULES``, (c) its long_500k cell uncut on (2, 1) under
    ``LM_DECODE_LONG_RULES``, (d) deepseek-v2-lite-16b (MLA) cut to 2
    layers on (1, 2), (e) SASRec's serve_p99 and retrieval_cand uncut on
    (1, 2) and (2, 1), held to this process's one-device runs (made first,
    freed before the spawn).  Returns the ranks' launches of kernels 5 and
    6 on the path, and (a)'s timing."""
    import multiprocessing

    import torch

    from repro_torch.kernels import ATTN_REL_TOL
    from repro_torch.launch import TOP_K

    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    lse_timing = check_kernel6_lse(dev)
    wall_a = time.perf_counter() - t_all
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    qcfg, long_cfg, mla_cfg, qwen, deep = serve_cells()
    B, P, max_seq, steps = SERVE_LM
    ref_b = serve_ref_lm(dev, qcfg, B, P, max_seq, steps, SEED + 210, 2)
    torch.save(ref_b, SERVE_DIR / "qwen2.pt")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ref_c = serve_ref_long(dev, long_cfg, SEED + 210, SERVE_LONG_STEPS)
    torch.save(ref_c, SERVE_DIR / "long.pt")
    torch.cuda.empty_cache()
    layers, Bd, Pd, max_d, steps_d = SERVE_MLA
    ref_d = serve_ref_lm(dev, mla_cfg, Bd, Pd, max_d, steps_d, SEED + 212, 2)
    torch.save(ref_d, SERVE_DIR / "mla.pt")
    torch.cuda.empty_cache()
    ref_e = serve_ref_sasrec(dev)
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_all - wall_a
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=serve_rank, args=(r, 2, str(dev))) for r in range(2)]
    t_spawn = time.perf_counter()
    for p_ in procs:
        p_.start()
    deadline = time.monotonic() + SERVE_LIMIT_S
    try:
        for p_ in procs:
            p_.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p_ in enumerate(procs) if p_.is_alive()]
    finally:
        for p_ in procs:
            if p_.is_alive():
                p_.kill()
                p_.join(10)
    spawn_s = time.perf_counter() - t_spawn
    for r in range(2):
        err = SERVE_DIR / f"rank{r}.err"
        check(not err.exists(), f"phase 21 rank {r} failed:\n"
              + (err.read_text() if err.exists() else ""))
    check(not hung, f"phase 21: ranks {hung} still running after {SERVE_LIMIT_S} s, killed")
    check(all(p_.exitcode == 0 for p_ in procs),
          f"phase 21 exit codes {[p_.exitcode for p_ in procs]}")
    res = [torch.load(SERVE_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    dcell = qwen["decode_32k"].batch_specs["tokens"].shape[0]
    log(f"[21] from the registry: qwen2-1.5b prefill_32k / decode_32k cut to {B} prompts of {P} "
        f"tokens (the cells' batches {qwen['prefill_32k'].batch_specs['tokens'].shape[0]} and "
        f"{dcell}, prompts {qwen['prefill_32k'].batch_specs['tokens'].shape[1]}) into {max_seq} "
        f"positions (the cells'), {steps} decode steps; long_500k uncut (batch 1, "
        f"{long_cfg.kv_block} positions), {SERVE_LONG_STEPS} steps at its end; "
        f"deepseek-v2-lite-16b cut to {layers} of {deep['decode_32k'].model_cfg.n_layers} layers, "
        f"{Bd} x {Pd} prompts into {max_d} positions, {steps_d} steps; sasrec serve_p99 and "
        f"retrieval_cand uncut; two gloo ranks on {CARD}; one-device references "
        f"{t_ref:.1f} s")
    k5 = k6 = 0
    for r, rr in enumerate(res):
        for tag, ref, cfg, n_layers in (("b", ref_b, qcfg, qcfg.n_layers),
                                        ("d", ref_d, mla_cfg, mla_cfg.n_layers)):
            x = rr[tag]
            lo, hi = x["rows"]
            rel0 = logits_rel_err(x["logits0"], ref["logits0"][lo:hi])
            check(rel0 <= LOGITS_REL_TOL, f"phase 21({tag}) rank {r}: prefill logits {rel0}")
            rel, _, worst, agree = compare_logits(
                x["logits"], [w[lo:hi] for w in ref["logits"]], f"phase 21({tag}) rank {r}")
            check(x["zero_past_prompt"], f"phase 21({tag}) rank {r}: a cache row past the "
                                         "prompt was written by the prefill")
            gqa = cfg.attn != "mla"
            check(x["k6"] == (n_layers * len(ref["tokens"]) if gqa else 0),
                  f"phase 21({tag}) rank {r}: kernel 6 launches {x['k6']}")
            if tag == "b":
                check(x["digest"] == ref["digests"][r],
                      f"phase 21(b) rank {r}: the prefill's cache slice differs from the "
                      "one-device prefill's rows")
            if gqa:
                check(x["attn_rel"] <= ATTN_REL_TOL[torch.bfloat16],
                      f"phase 21({tag}) rank {r}: kernel 6 rows {x['attn_rel']} from plain")
            k6 += x["k6"]
            log(f"[21] ({tag}) rank {r}: {cfg.name} on (1, 2), batch rows {x['rows']}, cache "
                f"positions {x['seq']}: load (parameter gather) {x['load_s']:.3f} s, prefill "
                f"{x['prefill_s']:.3f} s (one device {ref['prefill_s']:.3f} s), logits against "
                f"one device: prefill {rel0!r}, decode {rel!r} relative (limit "
                f"{LOGITS_REL_TOL}), max abs {worst!r}, greedy tokens agree {agree}; "
                + ("the prefill's slice bit for bit the one-device rows (SHA-256); kernel 6 "
                   f"rows (lse, merged) against plain {x['attn_rel']!r} (ATTN_REL_TOL "
                   f"{ATTN_REL_TOL[torch.bfloat16]!r})" if gqa else "MLA: kernel 6 launched 0 times"))
            log_serve(tag, x, ref["ms"], r, "decode")
        c = rr["c"]
        relc, _, worstc, agreec = compare_logits(c["logits"], ref_c["logits"], f"phase 21(c) {r}")
        check(c["k6"] == long_cfg.n_layers * SERVE_LONG_STEPS and c["attn_rel"] <=
              ATTN_REL_TOL[torch.bfloat16], f"phase 21(c) rank {r}: kernel 6 launches {c['k6']}, rows "
              f"{c['attn_rel']}")
        k6 += c["k6"]
        log(f"[21] (c) rank {r}: long_500k on (2, 1), positions {c['seq']} ({c['cache_bytes']} "
            f"B of cache a rank), {SERVE_LONG_STEPS} steps at the end: logits against one device "
            f"{relc!r} relative, max abs {worstc!r}, tokens agree {agreec}; kernel 6 rows "
            f"against plain {c['attn_rel']!r}; one device's peak {ref_c['peak']} B")
        log_serve("c", c, ref_c["ms"], r, "decode")
        e = rr["e"]
        for tag, x in e.items():
            if tag == "peak":
                continue
            kind, mesh = tag.split(" ", 1)
            if kind == "serve":
                check(x["bits"] and x["score_err"] <= SCORE_TOL and x["unwritten"]
                      and x["k5"] == RECSYS_CALLS,
                      f"phase 21(e) rank {r} {tag}: lookups bit for bit {x['bits']}, scores "
                      f"{x['score_err']}, item table unwritten {x['unwritten']}, kernel 5 "
                      f"launches {x['k5']}")
                what = (f"serve_p99 {mesh}, users {x['rows']}, item rows {x['block']}: lookups "
                        f"bit for bit take_rows, scores within {x['score_err']!r} of one device, "
                        f"top-{TOP_K} near-tie swaps {x['ties']}")
                one = ref_e["serve_ms"]
            else:
                check(x["err"] <= SCORE_TOL and x["unwritten"] and x["k5"] == 2 * RECSYS_CALLS,
                      f"phase 21(e) rank {r} {tag}: scores {x['err']}, kernel 5 launches "
                      f"{x['k5']}")
                what = (f"retrieval_cand {mesh}, candidates {x['cands']}: scores within "
                        f"{x['err']!r} of one device")
                one = ref_e["retrieval_ms"]
            k5 += x["k5"]
            log_serve("e", x, one, r, what)
        log(f"[21] (e) rank {r}: item table unwritten (SHA-256); peak device memory {e['peak']} B")
    log(f"[21] two ranks on {CARD}, gloo: (a) {wall_a:.1f} s, one-device references "
        f"{t_ref:.1f} s, the spawn {spawn_s:.1f} s; kernel 5 / 6 launches on the ranks "
        f"{k5} / {k6}; phase wall {time.perf_counter() - t_all:.1f} s")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return k5, k6, lse_timing


# ----------------------------------------------------------------------
# phase 22: GNN training on a process mesh (two gloo ranks on the card)
# ----------------------------------------------------------------------
GNN_SHARD_DIR = ROOT / "build" / "phase22"
GNN_SHARD_LIMIT_S = 420   # the ranks' limit, start included: a rank still running is killed
GNN_SHARD_STEPS = 2       # Trainer steps a run, cut from phase 18's 4: the whole script read
#                           1,038 s of its 1,200 with 4 on a slow host, 1,202 s with 3 on another
GNN_TIE_RTOL = 1e-6       # (a): max / min gradients against one device, of the largest
GNN_LOSS_RTOL = 1e-5      # step 1's loss, and (f)'s resumed losses, against one device
GNN_SPREAD = 4            # ... or within 4x one device's own spread where that is wider: the
#                           gradient of an ill-conditioned cell moves past GNN_REL_TOL when one
#                           device sums in another order (GIN full_graph_sm 2.1e-4 on the CPU
#                           route, PNA 2.5e-4 between two card runs), and AdamW then flips
#                           elements near a zero gradient
GNN_ORDERS = 6            # other edge orders whose step-1 gradients measure that spread
GNN_ORDER = ("gin-tu", "pna", "dimenet", "equiformer-v2")
GNN_SHARD_RUNS = ([("b", a, "molecule", (2, 1)) for a in GNN_ORDER]
                  + [("c", a, "full_graph_sm", (2, 1)) for a in GNN_ORDER]
                  + [("d", "pna", "minibatch_lg", (2, 1))]
                  + [("e", a, "molecule", (1, 2)) for a in ("gin-tu", "dimenet")])


def shard_combine(dev, mesh, axes) -> dict:
    """Phase 22(a) on one rank: every aggregation primitive over the rank's
    half of phase 18(a)'s edges (``agg_inputs`` of seed ``SEED`` + 220,
    the duplicates copying edges of the first half to the list's end, so
    their ties straddle the ranks), combined over ``axes``, against
    the whole list in this process; value and the gradient of the
    cotangent (a node result's cotangent / R on each rank, as a step
    back-props loss / R; the softmax's per edge, the rank's own).  Returns
    ``{name: (value error, gradient error)}``: max and min values exact
    (True when bit for bit) and their gradients' largest difference over
    the largest; degrees exact; the rest over the largest value."""
    import torch

    from repro_torch.distributed import edge_slice
    from repro_torch.models.gnn import aggregate as agg

    import numpy as np

    c = agg_inputs(np.random.default_rng(SEED + 220), AGG_SHAPE[1] // 2)
    n = AGG_SHAPE[0]
    part = edge_slice(mesh, axes, len(c["dst"]))
    dst = torch.from_numpy(c["dst"]).to(dev)

    def rel(got, want):
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    out = {"range": (part.lo, part.hi), "dup": c["dup"]}
    d_one = agg.degrees(dst, n)
    out["degrees"] = (torch.equal(agg.degrees(part.take(dst), n, part), d_one), None)
    for name in ("scatter_max", "scatter_min", "scatter_sum", "scatter_mean", "scatter_std",
                 "segment_softmax"):
        if name == "segment_softmax":
            x, idx, cot = c["scores"], torch.from_numpy(c["sdst"]).to(dev), c["scot"]
            fn = lambda v, i, p=None: agg.segment_softmax(v, i, n, p)  # noqa: E731
        else:
            x, idx, cot = c["vals"], dst, c["cot"]
            fn = lambda v, i, p=None, f=getattr(agg, name): f(v, i, n, part=p)  # noqa: E731
        x, cot = torch.from_numpy(x).to(dev), torch.from_numpy(cot).to(dev)
        whole = x.clone().requires_grad_(True)
        want = fn(whole, idx)
        (g_one,) = torch.autograd.grad(want, whole, cot)
        mine = part.take(x).clone().requires_grad_(True)
        got = fn(mine, part.take(idx), part)
        (g,) = torch.autograd.grad(
            got, mine, part.take(cot) if name == "segment_softmax" else cot / part.parts)
        if name == "segment_softmax":
            want = part.take(want)
        g_one = part.take(g_one)
        exact = name in ("scatter_max", "scatter_min")
        out[name] = (torch.equal(got, want) if exact else rel(got.detach(), want.detach()),
                     rel(g, g_one))
        del whole, want, g_one, mine, got, g
    return out


def shard_batches(dev, arch, shape) -> list:
    """The batches of a phase 22 run, one a step: phase 18's (the molecule
    and full_graph_sm batches of seed 0; minibatch_lg's sampled batches,
    saved by the parent)."""
    import torch

    from repro_torch.configs import get_arch

    if shape == "minibatch_lg":
        saved = torch.load(GNN_SHARD_DIR / "minibatch_lg.pt", weights_only=False)
        return [{k: v.to(dev) for k, v in b.items()} for b in saved]
    batch, _ = gnn_batch(get_arch(arch).cells()[shape], dev, SEED)
    return [batch] * (GNN_SHARD_STEPS + 1)


def shard_ref_path(arch, shape):
    return GNN_SHARD_DIR / f"ref_{arch}_{shape}.pt"


def grads_rel(got, want) -> float:
    """The worst leaf of ``got`` against ``want``: its L2 distance over the
    leaf's norm plus ``GNN_FLOOR`` / ``GNN_REL_TOL`` of the whole norm (phase
    18(b)'s measure)."""
    from repro_torch.optim import tree_leaves

    gl, rl = tree_leaves(got), tree_leaves(want)
    total = math.sqrt(sum(float(x.double().norm()) ** 2 for x in rl))
    return max(float((a.cpu().double() - b.cpu().double()).norm())
               / (float(b.double().norm()) + GNN_FLOOR / GNN_REL_TOL * total)
               for a, b in zip(gl, rl))


def one_device_run(mod, cfg, batches, params, dev) -> dict:
    """Step 1's loss and gradient of ``params`` on ``batches[0]``, then
    ``GNN_SHARD_STEPS`` one-device ``Trainer`` steps from them on ``dev``,
    and the loss of the parameters they reach on the next batch (the loss
    that a run resumed from a checkpoint at that step reports first)."""
    import torch

    from repro_torch.launch import TrainConfig, Trainer, value_and_grad
    from repro_torch.optim import adamw_init, tree_map

    loss, grads = value_and_grad(lambda p: mod.loss_fn(p, batches[0], cfg), params)
    tr = Trainer(mod, cfg, train_cfg=TrainConfig(steps=GNN_SHARD_STEPS, warmup=1, log_every=1),
                 device=dev)
    start = tree_map(torch.clone, params)
    p, _, hist = tr.fit(lambda s: batches[s], params=start, opt_state=adamw_init(start))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with torch.no_grad():
        after = float(mod.loss_fn(p, batches[GNN_SHARD_STEPS], cfg))
    host = lambda t: t.cpu()  # noqa: E731
    return {"loss": float(loss), "grads": tree_map(host, grads), "params": tree_map(host, p),
            "losses": [h["loss"] for h in hist], "loss_after": after,
            "ms": statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3}


def gnn_shard_refs(dev):
    """The one-device references of phase 22, in this process before the
    spawn: each (arch, shape) of ``GNN_SHARD_RUNS`` from phase 18's
    parameters (seed ``SEED`` on the card): step 1's loss and gradient,
    then ``GNN_SHARD_STEPS`` ``Trainer`` steps (losses, final parameters, ms a
    step), saved under ``GNN_SHARD_DIR``.  Beside each, the spread of one
    device against itself: the largest gradient distance between any two of
    its routes (the reference, step 1 with the edge list (DimeNet's
    triplets) in ``GNN_ORDERS`` other orders on the card, and for GIN and
    PNA at molecule and full_graph_sm the CPU route), and against the
    reference the share of parameters past rtol and the loss after the run
    of the first reordered run and the CPU route.  Float32 sums in another
    order move an ill-conditioned gradient past ``GNN_REL_TOL``, and PNA's
    std can jump: ``maximum(mu2 - mu * mu, 0)`` meets its kink wherever the
    variance rounds to about 0, on one side or the other by the order.
    minibatch_lg's batches are drawn here by the sampler (phase 18(e)'s)
    and saved for the ranks."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import SHAPE_TASK
    from repro_torch.launch import value_and_grad
    from repro_torch.optim import tree_map

    if any(shape == "minibatch_lg" for _, _, shape, _ in GNN_SHARD_RUNS):
        cell = get_arch("pna").cells()["minibatch_lg"]
        offsets, targets = reddit_csr(SEED + 3)
        g = torch.Generator(dev).manual_seed(SEED + 4)
        n_graph = len(offsets) - 1
        feat = torch.randn(n_graph, cell.model_cfg.d_in, generator=g, device=dev)
        labels = torch.randint(0, SHAPE_TASK[cell.shape][1], (n_graph,), generator=g,
                               device=dev, dtype=torch.int32)
        sampled = [sampled_batch(cell, dev, offsets, targets, feat, labels, SEED + 10 + s)[0]
                   for s in range(GNN_SHARD_STEPS + 1)]
        torch.save([{k: v.cpu() for k, v in b.items()} for b in sampled],
                   GNN_SHARD_DIR / "minibatch_lg.pt")
        del offsets, targets, feat, labels, sampled
    lr_sum = sum(float(warmup_lr(i)) for i in range(GNN_SHARD_STEPS))
    for arch, shape in dict.fromkeys((a, s) for _, a, s, _ in GNN_SHARD_RUNS):
        m = get_arch(arch)
        mod, cfg = m.MODULE, m.cells()[shape].model_cfg
        batches = shard_batches(dev, arch, shape)
        params = mod.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
        ref = one_device_run(mod, cfg, batches, params, dev)
        keys = ("t_kj", "t_ji") if mod.SPLIT == "t_kj" else ("edge_src", "edge_dst")
        orders = [[dict(b, **{k: b[k][perm] for k in keys}) for b in batches] for perm in (
            torch.randperm(batches[0][keys[0]].shape[0], generator=torch.Generator().manual_seed(
                SEED + 22 + i)).to(dev) for i in range(GNN_ORDERS))]
        others = [one_device_run(mod, cfg, orders[0], params, dev)]
        if arch in ("gin-tu", "pna") and shape in ("molecule", "full_graph_sm"):
            host = lambda t: t.cpu()  # noqa: E731
            others.append(one_device_run(mod, cfg, [tree_map(host, b) for b in batches],
                                         tree_map(host, params), torch.device("cpu")))
        grads = [ref["grads"]] + [o["grads"] for o in others] + [
            tree_map(lambda t: t.cpu(), value_and_grad(
                lambda p, b=o[0]: mod.loss_fn(p, b, cfg), params)[1]) for o in orders[1:]]
        held = [params_held(o["params"], ref["params"], lr_sum) for o in others]
        ref["spread"] = {
            "grad": max(grads_rel(grads[j], grads[i]) for i in range(len(grads))
                        for j in range(i + 1, len(grads))),
            "far": max(far / total for _, far, total, _ in held),
            "loss_after": max(abs(o["loss_after"] - ref["loss_after"]) / abs(ref["loss_after"])
                              for o in others),
            "routes": len(grads) - 1}
        torch.save(ref, shard_ref_path(arch, shape))
        del params, batches, ref, others
        torch.cuda.empty_cache()


def warmup_lr(step) -> float:
    """The ``Trainer``'s LR scale of ``step`` in a run of ``GNN_SHARD_STEPS``
    steps with a warmup of 1."""
    import torch

    from repro_torch.optim import warmup_cosine

    return float(warmup_cosine(torch.tensor(step), warmup=1, total=max(GNN_SHARD_STEPS, 2)))


def params_held(got, want, lr_sum) -> tuple:
    """Phase 20(b)'s rule: (worst share of the bound 2 lr lr_sum +
    rtol ``SHARD_RTOL``, elements past rtol, elements, max abs difference)
    of ``got`` against ``want``."""
    from repro_torch.launch import TrainConfig
    from repro_torch.optim import tree_leaves

    lr = TrainConfig().adamw.lr
    worst, far, total, big = 0.0, 0, 0, 0.0
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        d, w = (x.float().cpu() - y.float().cpu()).abs(), y.float().cpu().abs()
        worst = max(worst, float((d / (2 * lr * lr_sum + SHARD_RTOL * w)).max()))
        far += int((d > SHARD_RTOL * w + 1e-7).sum())
        total += d.numel()
        big = max(big, float(d.max()))
    return worst, far, total, big


def tree_digest(tree) -> str:
    """SHA-256 of every leaf's bytes in walk order."""
    import torch

    from repro_torch.optim import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def gnn_shard_rank(rank, world, device):
    """One rank of phase 22; results to ``rank<r>.pt``, an exception to
    ``rank<r>.err`` (and exit code 1)."""
    import traceback

    try:
        import torch

        torch.save(_gnn_shard_rank(rank, world, device), GNN_SHARD_DIR / f"rank{rank}.pt")
    except BaseException:
        (GNN_SHARD_DIR / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _gnn_shard_rank(rank, world, device):
    import datetime

    import torch
    import torch.distributed as dist

    import repro_torch.distributed.gnn as gnn_mod
    import repro_torch.launch.steps as steps_mod
    from repro_torch.checkpoint import restore_latest
    from repro_torch.configs import get_arch
    from repro_torch.core import make_process_mesh
    from repro_torch.distributed import GNN_RULES, axis_rules, edge_slice, logical_to_spec
    from repro_torch.distributed.shardings import spec_axes
    from repro_torch.launch import TrainConfig, Trainer, train_layout
    from repro_torch.optim import tree_leaves, tree_map

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{GNN_SHARD_DIR / 'init'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    meshes = {shape: make_process_mesh(shape, ("data", "model"), device=dev)
              for shape in ((2, 1), (1, 2))}
    ready = time.monotonic() + GNN_SHARD_LIMIT_S
    while not (GNN_SHARD_DIR / "refs.ready").exists():   # the parent's references
        if time.monotonic() > ready:
            raise TimeoutError("phase 22: no one-device references")
        time.sleep(0.1)
    dist.barrier()
    sync = torch.cuda.synchronize
    steps = []          # a step's {"combine": s, "reduce": s, "combine_b": B, "reduce_b": B}

    def timed(fn, kind):
        def wrapped(t, mesh, axes, *a):
            sync()
            t0 = time.perf_counter()
            out = fn(t, mesh, axes, *a)
            sync()
            if steps:
                sent = sum(2 * (mesh.axis_size(x) - 1) * t.numel() * t.element_size()
                           // mesh.axis_size(x) for x in axes)
                steps[-1][kind] += time.perf_counter() - t0
                steps[-1][kind + "_b"] += sent
            return out

        return wrapped

    first = []          # a fit's first gradient, summed over the ranks
    real = gnn_mod.all_reduce, steps_mod.all_reduce_sum, steps_mod.reduce_gradients

    def reduce_first(grads, axes, mesh):
        out = real[2](grads, axes, mesh)
        if not first:
            first.append(tree_map(lambda t: t.detach().clone(), out))
        return out

    gnn_mod.all_reduce = timed(real[0], "combine")
    steps_mod.all_reduce_sum = timed(real[1], "reduce")
    steps_mod.reduce_gradients = reduce_first
    out = {"rank": rank, "runs": {}}
    lr_sum = sum(warmup_lr(i) for i in range(GNN_SHARD_STEPS))
    gen = lambda: torch.Generator(dev).manual_seed(SEED)  # noqa: E731

    # (a): the combine alone, on (2, 1)
    with axis_rules(GNN_RULES, meshes[(2, 1)]):
        axes = spec_axes(logical_to_spec("edges")[0])
    t = time.perf_counter()
    out["combine"] = shard_combine(dev, meshes[(2, 1)], axes)
    out["combine_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    def make_fn(batches):
        def make(step):
            steps.append({"combine": 0.0, "reduce": 0.0, "combine_b": 0, "reduce_b": 0})
            return batches[step]

        return make

    for tag, arch, shape, mesh_shape in GNN_SHARD_RUNS:
        m = get_arch(arch)
        mod, cfg = m.MODULE, m.cells()[shape].model_cfg
        mesh = meshes[mesh_shape]
        ref = torch.load(shard_ref_path(arch, shape), mmap=True, weights_only=False)
        batches = shard_batches(dev, arch, shape)
        layout = train_layout(mod, cfg, mesh, GNN_RULES)
        b0 = batches[0]
        part = edge_slice(mesh, layout.edge_axes, b0[mod.SPLIT].shape[0])
        if mod.SPLIT == "t_kj":
            E = b0["edge_src"].shape[0]
            real_items = int(((part.take(b0["t_kj"]) < E) & (part.take(b0["t_ji"]) < E)).sum())
        else:
            n = b0["node_feat"].shape[0]
            real_items = int(((part.take(b0["edge_src"]) < n)
                              & (part.take(b0["edge_dst"]) < n)).sum())
        # GNN_SHARD_STEPS Trainer steps from phase 18's parameters; step 1's
        # gradient is the one its all-reduce hands on
        tr = Trainer(mod, cfg, train_cfg=TrainConfig(steps=GNN_SHARD_STEPS, warmup=1,
                                                     log_every=1), mesh=mesh, rules=GNN_RULES)
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        steps.clear()
        first.clear()
        p, _, hist = tr.fit(make_fn(batches), generator=gen())
        sync()
        peak = torch.cuda.max_memory_allocated(dev)
        grads = first[0]
        worst = grads_rel(grads, ref["grads"])
        finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(grads))
        leaves = len(tree_leaves(grads))
        del grads
        first.clear()
        timed_steps = steps[1:len(hist)]
        med = lambda k: statistics.median(s[k] for s in timed_steps) * 1e3  # noqa: E731
        out["runs"][tag, arch, shape, mesh_shape] = {
            "loss": hist[0]["loss"], "loss_ref": ref["loss"], "grad_worst": worst, "finite": finite,
            "losses": [h["loss"] for h in hist], "losses_ref": ref["losses"],
            "ms": statistics.median(h["sec_per_step"] for h in hist[1:]) * 1e3,
            "each_ms": [h["sec_per_step"] * 1e3 for h in hist], "one_ms": ref["ms"],
            "combine_ms": med("combine"), "reduce_ms": med("reduce"),
            "combine_b": timed_steps[0]["combine_b"], "reduce_b": timed_steps[0]["reduce_b"],
            "peak": peak, "real": real_items, "items": part.hi - part.lo, "split": mod.SPLIT,
            "held": params_held(p, ref["params"], lr_sum), "digest": tree_digest(p),
            "leaves": leaves, "parts": part.parts, "spread": ref["spread"]}
        del p, batches, ref, b0
        torch.cuda.empty_cache()

    # (f): GIN molecule on (2, 1), a checkpoint at step GNN_SHARD_STEPS, restored and
    # resumed for one more step, whose loss (taken before its update) is the loss of
    # the restored state on the next batch
    m = get_arch("gin-tu")
    mod, cfg = m.MODULE, m.cells()["molecule"].model_cfg
    batches = shard_batches(dev, "gin-tu", "molecule")
    ref = torch.load(shard_ref_path("gin-tu", "molecule"), weights_only=False)
    ckpt = GNN_SHARD_DIR / "ckpt"
    tc = dict(warmup=1, log_every=1, ckpt_every=GNN_SHARD_STEPS)
    first = Trainer(mod, cfg, train_cfg=TrainConfig(steps=GNN_SHARD_STEPS, **tc),
                    mesh=meshes[(2, 1)], rules=GNN_RULES)
    p2, o2, _ = first.fit(make_fn(batches), generator=gen(), ckpt_dir=str(ckpt))
    restored, step = restore_latest(str(ckpt), first.layout.meta_state(), device="cpu")
    resumed = Trainer(mod, cfg, train_cfg=TrainConfig(steps=GNN_SHARD_STEPS + 1, **tc),
                      mesh=meshes[(2, 1)], rules=GNN_RULES)
    _, _, hist = resumed.fit(make_fn(batches), generator=gen(), ckpt_dir=str(ckpt))
    host = lambda t: t.cpu()  # noqa: E731
    out["restart"] = {
        "step": step,
        "bits": same_tree_bits(restored["params"], tree_map(host, p2))
        and same_tree_bits(restored["opt"], tree_map(host, o2)),
        "steps": [h["step"] for h in hist], "losses": [h["loss"] for h in hist],
        "loss_ref": ref["loss_after"], "spread": ref["spread"]["loss_after"]}
    gnn_mod.all_reduce, steps_mod.all_reduce_sum, steps_mod.reduce_gradients = real
    dist.destroy_process_group()
    return out


def log_gnn_shard_run(key, x, rank):
    tag, arch, shape, mesh = key
    ms, b = x["ms"], x["combine_b"] + x["reduce_b"]
    log(f"[22] ({tag}) {arch} {shape} on {mesh}, rank {rank}: {ms:.3f} ms a step (median of "
        f"steps 2-{GNN_SHARD_STEPS}; each {', '.join(f'{v:.1f}' for v in x['each_ms'])}), one "
        f"device {x['one_ms']:.3f} ms; the combines {x['combine_ms']:.3f} ms a step = "
        f"{x['combine_ms'] / ms:.3f}, the gradient and loss all-reduces {x['reduce_ms']:.3f} ms = "
        f"{x['reduce_ms'] / ms:.3f} (each side synchronised; gloo on CUDA tensors, not an NCCL "
        f"number); sent a step {b} B (combines {x['combine_b']}, gradients and loss "
        f"{x['reduce_b']}); peak device memory {x['peak']} B; {x['real']} real "
        f"{'triplets' if x['split'] == 't_kj' else 'edges'} of the rank's {x['items']}")


def drive_sharded_gnn(dev):
    """Phase 22: two gloo ranks on the one card train the GNN family with
    the edge lists split over the ranks under ``GNN_RULES``: (a) the
    aggregation's combine alone; (b) all four models at the molecule cell
    and (c) at full_graph_sm, full width and depth, uncut, on (2, 1); (d)
    PNA at minibatch_lg through the sampler on (2, 1); (e) GIN and DimeNet
    at molecule on (1, 2); (f) a checkpoint at step 2 of GIN molecule on
    (2, 1), restored and resumed.  Held to this process's one-device runs
    (made first, saved, freed before the spawn).  No hand kernel lies on
    the path."""
    import multiprocessing

    import torch

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(GNN_SHARD_DIR, ignore_errors=True)
    GNN_SHARD_DIR.mkdir(parents=True)
    # the ranks start (import, process group) while this process makes the
    # references; they begin their runs once the references are written
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gnn_shard_rank, args=(r, 2, str(dev))) for r in range(2)]
    for p_ in procs:
        p_.start()
    deadline = time.monotonic() + GNN_SHARD_LIMIT_S
    try:
        gnn_shard_refs(dev)
        torch.cuda.empty_cache()
        (GNN_SHARD_DIR / "refs.ready").touch()
        t_ref = time.perf_counter() - t_all
        t_spawn = time.perf_counter()
        for p_ in procs:
            p_.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p_ in enumerate(procs) if p_.is_alive()]
    finally:
        for p_ in procs:
            if p_.is_alive():
                p_.kill()
                p_.join(10)
    spawn_s = time.perf_counter() - t_spawn
    for r in range(2):
        err = GNN_SHARD_DIR / f"rank{r}.err"
        check(not err.exists(), f"phase 22 rank {r} failed:\n"
              + (err.read_text() if err.exists() else ""))
    check(not hung, f"phase 22: ranks {hung} still running after {GNN_SHARD_LIMIT_S} s, killed")
    check(all(p_.exitcode == 0 for p_ in procs),
          f"phase 22 exit codes {[p_.exitcode for p_ in procs]}")
    res = [torch.load(GNN_SHARD_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    log(f"[22] from the registry: {len(GNN_SHARD_RUNS)} runs of {GNN_SHARD_STEPS} Trainer steps "
        f"(cut from phase 18's {GNN_STEPS} to keep the whole run near 1,000 s) at full width and "
        f"depth, uncut, from phase 18's parameters and batches; two gloo ranks "
        f"on {CARD}, the edge lists (DimeNet's triplets) split over both, nodes whole on each; "
        f"one-device references {t_ref:.1f} s")
    for r, rr in enumerate(res):
        a = rr["combine"]
        check(a["degrees"][0] and a["scatter_max"][0] is True and a["scatter_min"][0] is True,
              f"phase 22(a) rank {r}: degrees, max or min differ from one device")
        tie = max(a["scatter_max"][1], a["scatter_min"][1])
        sums = max(max(a[k]) for k in ("scatter_sum", "scatter_mean", "scatter_std",
                                       "segment_softmax"))
        check(tie <= GNN_TIE_RTOL and sums <= AGG_REL_TOL,
              f"phase 22(a) rank {r}: max / min gradients {tie} (at most {GNN_TIE_RTOL}), sums "
              f"{sums} (at most {AGG_REL_TOL}) of the largest from one device")
        log(f"[22] (a) rank {r}, edges {a['range']} of {AGG_SHAPE[1]} + {a['dup']} duplicates "
            f"(each copy in the other rank's half): degrees, scatter_max and scatter_min bit for "
            f"bit one device's; their gradients (ties split by the global count) {tie!r} of the "
            f"largest; sums, means, std and segment_softmax (value, gradient) at most {sums!r} "
            f"(limit {AGG_REL_TOL}); {rr['combine_s']:.1f} s")
        for key, x in rr["runs"].items():
            loss_rel = abs(x["loss"] - x["loss_ref"]) / abs(x["loss_ref"])
            worst, far, total, big = x["held"]
            sp = x["spread"]
            grad_tol = max(GNN_REL_TOL, GNN_SPREAD * sp["grad"])
            far_tol = max(SHARD_FLIP_SHARE, GNN_SPREAD * sp["far"])
            ok = (x["finite"] and loss_rel <= GNN_LOSS_RTOL and x["grad_worst"] <= grad_tol
                  and worst <= 1.0 and far <= far_tol * total
                  and all(math.isfinite(v) for v in x["losses"]))
            check(ok, f"phase 22{key} rank {r}: step 1's loss {loss_rel} (at most "
                  f"{GNN_LOSS_RTOL}), gradients {x['grad_worst']} (at most {grad_tol}), "
                  f"parameters at {worst} of the bound with {far} of {total} past rtol "
                  f"{SHARD_RTOL} (at most {far_tol} of them), losses {x['losses']}")
            check(x["digest"] == res[1 - r]["runs"][key]["digest"],
                  f"phase 22{key}: the two ranks' parameters differ")
            log_gnn_shard_run(key, x, r)
            log(f"[22] ({key[0]}) rank {r}: step 1's loss {loss_rel!r} relative from one device, "
                f"{x['leaves']} gradient leaves at most {x['grad_worst']:.3g} (relative L2 beside "
                f"{GNN_FLOOR} of the whole norm; limit {grad_tol:.3g}: one device's own spread "
                f"over {sp['routes']} other routes {sp['grad']:.3g}); after {GNN_SHARD_STEPS} "
                f"steps the parameters at {worst:.4f} of the bound 2 lr sum(lr_scale) + rtol "
                f"{SHARD_RTOL}, {far} of {total} past rtol (at most {far_tol:.4g} of them; one "
                f"device's own spread {sp['far']:.4g}), max abs {big!r}; the ranks bit for bit; "
                f"losses {x['losses']}, one device {x['losses_ref']}")
        rs = rr["restart"]
        res_tol = max(GNN_LOSS_RTOL, GNN_SPREAD * rs["spread"])
        res_rel = abs(rs["losses"][0] - rs["loss_ref"]) / abs(rs["loss_ref"]) if rs[
            "losses"] else math.inf
        check(rs["step"] == GNN_SHARD_STEPS and rs["bits"]
              and rs["steps"] == [GNN_SHARD_STEPS + 1] and res_rel <= res_tol,
              f"phase 22(f) rank {r}: checkpoint step {rs['step']}, restored bit for bit "
              f"{rs['bits']}, resumed steps {rs['steps']}, losses {rs['losses']} against one "
              f"device's {rs['loss_ref']} (at most {res_tol} relative)")
        log(f"[22] (f) rank {r}: GIN molecule on (2, 1), the step-{rs['step']} checkpoint "
            f"restored bit for bit, step {rs['steps']} resumed with loss {rs['losses']} against "
            f"one device's {rs['loss_ref']!r}: {res_rel!r} relative (limit {res_tol:.3g}: "
            f"{GNN_LOSS_RTOL}, or {GNN_SPREAD}x one device's own spread {rs['spread']!r})")
    log(f"[22] two ranks on {CARD}, gloo: one-device references {t_ref:.1f} s (the ranks "
        f"starting meanwhile), the ranks' runs {spawn_s:.1f} s; phase wall "
        f"{time.perf_counter() - t_all:.1f} s")
    shutil.rmtree(GNN_SHARD_DIR, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one card.")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--lm-only", action="store_true",
                      help="build the kernels and run phase 10 alone (kernel 6 and the LM "
                           "serving path): a quick check after editing kernel 6")
    only.add_argument("--moe-only", action="store_true",
                      help="build the kernels and run phase 10(a)-(b) (kernel 6 against its "
                           "plain version, timed) and phase 16 alone (MoE and MLA serving, "
                           "the other LM configurations through kernel 6)")
    only.add_argument("--recsys-only", action="store_true",
                      help="build the kernels and run phase 11 alone (kernel 5 and SASRec "
                           "serving): a quick check after editing kernel 5")
    only.add_argument("--train-only", action="store_true",
                      help="build the kernels and run phase 17 alone (kernel 5', the trainer, "
                           "SASRec, qwen2-1.5B and deepseek-v2-lite training)")
    only.add_argument("--dist-only", action="store_true",
                      help="build the kernels and graphs B and E and run phase 14(g) alone (two "
                           "ranks on the card, one shard each, the combine on gloo)")
    only.add_argument("--shard-train-only", action="store_true",
                      help="build the kernels and run phase 20 alone (two ranks on the card "
                           "train SASRec and qwen2-1.5B on process meshes, gloo)")
    only.add_argument("--shard-serve-only", action="store_true",
                      help="build the kernels and run phase 21 alone (kernel 6's log-sum-exp; "
                           "two ranks on the card serve qwen2-1.5B, its long_500k cell, "
                           "deepseek's MLA and SASRec on process meshes, gloo)")
    only.add_argument("--shard-gnn-only", action="store_true",
                      help="build the kernels and run phase 22 alone (two ranks on the card "
                           "train the GNN family with its edge lists split, gloo)")
    only.add_argument("--gnn-only", action="store_true",
                      help="build the kernels and run phase 18 alone (the GNN family trained "
                           "on the card; no hand kernel lies on its path)")
    args = ap.parse_args(argv)
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
    from repro_torch.kernels.build import build_all, resource_usage

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_all([ROOT / s for s in KERNEL_SOURCES.values()])
    log(f"[1] kernel build (nvcc, sm_90a, {len(KERNEL_SOURCES)} sources at once): "
        f"{time.perf_counter() - t0:.1f} s")
    for name, source in KERNEL_SOURCES.items():
        for entry, (regs, spill) in resource_usage(ROOT / source).items():
            log(f"[1] ptxas {name} {entry}: {regs} registers a thread, {spill} B spill stores")

    if args.lm_only:
        import numpy as np

        from repro_torch.configs import qwen2_1_5b

        t0 = time.perf_counter()
        kernels = [drive_lm(dev, np.random.default_rng(SEED), {}, qwen2_1_5b.full_config())]
        log(f"wall seconds: LM serving {time.perf_counter() - t0:.1f}")
    elif args.moe_only:
        import numpy as np

        t0 = time.perf_counter()
        err, timing = check_kernel6(dev, np.random.default_rng(SEED), {})
        kernels = [kernel6_record(err, timing, drive_moe(dev))]
        log(f"wall seconds: MoE and MLA serving {time.perf_counter() - t0:.1f}")
    elif args.recsys_only:
        t0 = time.perf_counter()
        kernels = [drive_recsys(dev, {})]
        log(f"wall seconds: SASRec serving {time.perf_counter() - t0:.1f}")
    elif args.train_only:
        t0 = time.perf_counter()
        _, kernels = drive_train(dev)
        log(f"wall seconds: training {time.perf_counter() - t0:.1f}")
    elif args.dist_only:
        t0 = time.perf_counter()
        B_, E_ = build_graph(*GRAPH_B, dev), build_graph(*GRAPH_E, dev)
        drive_process_mesh(dev, B_, E_, sources(B_.dev, 18, SEED + 1))
        kernels = []  # its launch counts are the ranks'; the full run lists every kernel
        log(f"wall seconds: process mesh {time.perf_counter() - t0:.1f}")
    elif args.shard_train_only:
        t0 = time.perf_counter()
        drive_sharded_train(dev)
        kernels = []  # its launch counts are the ranks'; the full run lists every kernel
        log(f"wall seconds: sharded training {time.perf_counter() - t0:.1f}")
    elif args.shard_serve_only:
        t0 = time.perf_counter()
        drive_sharded_serve(dev)
        kernels = []  # its launch counts are the ranks'; the full run lists every kernel
        log(f"wall seconds: sharded serving {time.perf_counter() - t0:.1f}")
    elif args.shard_gnn_only:
        t0 = time.perf_counter()
        drive_sharded_gnn(dev)
        kernels = []  # no hand kernel lies on the GNN path
        log(f"wall seconds: sharded GNN training {time.perf_counter() - t0:.1f}")
    elif args.gnn_only:
        t0 = time.perf_counter()
        drive_gnn(dev)
        kernels = []  # no hand kernel lies on the GNN path
        log(f"wall seconds: GNN training {time.perf_counter() - t0:.1f}")
    else:
        kernels = drive(dev)  # phases 2-16 and 8; their device memory is freed on return
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fwd, records = drive_train(dev)  # 17. training on the card (kernel 5')
        log(f"wall seconds: training {time.perf_counter() - t0:.1f}")
        next(k for k in kernels if k["name"] == "embedding_bag")["launches"] += fwd
        kernels.extend(records)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        drive_gnn(dev)                   # 18. the GNN family trained on the card
        log(f"wall seconds: GNN training {time.perf_counter() - t0:.1f}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        drive_registry(dev)              # 19. the cell registry
        log(f"wall seconds: registry {time.perf_counter() - t0:.1f}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shard = drive_sharded_train(dev)  # 20. sharded training, two ranks on the card
        log(f"wall seconds: sharded training {time.perf_counter() - t0:.1f}")
        for name, n in zip(("embedding_bag", "embedding_bag_backward", "embedding_bag_plan"),
                           shard):
            next(k for k in kernels if k["name"] == name)["launches"] += n
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        k5, k6, _ = drive_sharded_serve(dev)  # 21. serving on a process mesh, two ranks
        log(f"wall seconds: sharded serving {time.perf_counter() - t0:.1f}")
        next(k for k in kernels if k["name"] == "embedding_bag")["launches"] += k5
        next(k for k in kernels if k["name"] == "decode_attention")["launches"] += k6
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        drive_sharded_gnn(dev)           # 22. GNN training on a process mesh, two ranks
        log(f"wall seconds: sharded GNN training {time.perf_counter() - t0:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


def drive(dev, graph_a=GRAPH_A, graph_b=GRAPH_B, graph_e=GRAPH_E) -> list[dict]:
    """Phases 2 to 16 on ``dev`` (8, the SHA-256 check, last); returns the
    kernels' records."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (
        bfs,
        kcore,
        maximal_matching,
        orientation_filter,
        pagerank,
        set_cover,
        triangle_count,
        wbfs,
    )
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.core import edgemap_reduce, edgemap_reduce_batched, exception_dense
    from repro_torch.core import make_filter, make_plan
    from repro_torch.kernels import (
        compressed_block_spmv,
        compressed_chunked_spmv,
        compressed_spmv_vertex,
        compressed_stream_round,
        edge_block_spmv,
        filter_pack_words,
        spmv_vertex,
    )
    from repro_torch.serving import QueryEngine
    from repro_torch.tuning import HBM_BYTES_PER_S, TuningTable, calibrate, default_table

    wall = {}
    cpu_route = start_filter_cpu_route(graph_e)  # phase 9(d)'s CPU route, beside the card
    # graphs: built on the host, moved to the card ---------------------
    t0 = time.perf_counter()
    B_ = build_graph(*graph_b, dev)
    gB, hB = B_.dev, B_.host
    log(f"graph B: n={gB.n} m={gB.m} NB={gB.num_blocks} exceptions={gB.n_exceptions} "
        f"exception_dense={exception_dense(gB)} built in {B_.seconds:.1f} s")
    check(not exception_dense(gB), "graph B must stream through the kernel")
    E_ = build_graph(*graph_e, dev)
    gE = E_.dev
    log(f"graph E: n={gE.n} m={gE.m} NB={gE.num_blocks} exceptions={gE.n_exceptions} "
        f"exception_dense={exception_dense(gE)} built in {E_.seconds:.1f} s")
    check(0 < gE.n_exceptions and not exception_dense(gE), "graph E: a few exceptions")
    A_ = build_graph(*graph_a, dev)
    gA = A_.dev
    log(f"graph A: n={gA.n} m={gA.m} NB={gA.num_blocks} exceptions={gA.n_exceptions} "
        f"exception_dense={exception_dense(gA)} built in {A_.seconds:.1f} s")
    digests = graph_digest(gA, A_.csr, gB, B_.csr, E_.dev, E_.csr)
    wall["graphs"] = time.perf_counter() - t0

    # 2. the kernels against their plain versions ----------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    stats = {"chunked": 0, "fused round": 0, "kernel 2": 0, "kernel 3": 0}
    err1 = max(compare_chunked_kernel(gB, rng, stats), compare_chunked_kernel(gE, rng, stats))
    err1f = max(compare_stream_round(gB, rng, stats), compare_stream_round(gE, rng, stats))
    err2 = err3 = 0.0
    for G in (B_, E_):
        e2, e3 = compare_whole_graph_kernels(G, rng, stats)
        err2, err3 = max(err2, e2), max(err3, e3)
    err_patched = compare_patched_paths(E_, rng)
    cross_check_backends(B_, rng)
    timing1 = time_chunked_kernel(gB, rng)
    round_chunk = time_stream_round(gB, frontier_of_blocks(gB, rng, CHUNK),
                                    f"graph B, {CHUNK} live blocks")
    round_full = time_stream_round(gB, torch.ones(gB.n, dtype=torch.bool, device=dev),
                                   "graph B, full frontier")
    check(round_full["ms"] < round_full["plain_ms"],
          "the full-frontier round: the fused launch is not faster than the chunk loop")
    times_b = time_whole_graph_kernels(B_)
    log(f"[2] kernel 1 == plain on the card in {stats['chunked']} cases (decode exact, sums "
        f"rtol {SUM_RTOL}); max abs err {err1!r}")
    log(f"[2] kernel 1's fused round == the chunk loop on the card in {stats['fused round']} "
        f"cases (graphs B and E, one query and B={BATCH}, identity and saturating add, with "
        f"and without edge_active, full frontier; out and touched bit for bit)")
    log(f"[2] kernel 2 == plain in {stats['kernel 2']} cases, kernel 3 == plain in "
        f"{stats['kernel 3']} cases (int32 exact, float32 rtol {SUM_RTOL}); max abs err "
        f"{err2!r} / {err3!r}; batched lanes equal single runs; patched ops on graph E "
        f"equal the CPU route (max abs err {err_patched!r}); compressed_spmv_vertex == "
        "spmv_vertex on graph B for int32 x")
    log(f"[2] kernel 1 at C={CHUNK} F_B={BLOCK} weighted decode, device time: kernel "
        f"{timing1['ms']!r} ms, plain {timing1['plain_ms']!r} ms, yardstick (index_select + "
        f"cumsum) {timing1['yardstick_ms']!r} ms, bound {timing1['bound_ms']!r} ms "
        f"({timing1['bytes']} B at {HBM_BYTES_PER_S / 1e12} TB/s)")
    log_round_time("2", f"graph B, {CHUNK} live blocks", round_chunk)
    log_round_time("2", "graph B, full frontier", round_full)
    log_times("2 graph B", times_b)
    wall["kernels"] = time.perf_counter() - t0

    # 3. graph A: the full configuration -------------------------------
    t0 = time.perf_counter()
    before = compressed_chunked_spmv.launches + compressed_stream_round.launches
    plan_a = make_plan(gA, strategy="auto")
    pr, iters = pagerank(gA, plan=plan_a)
    torch.cuda.synchronize()
    mass = float(pr.double().sum())
    check(abs(mass - 1.0) < PR_SUM_TOL and iters < 100 and bool(torch.isfinite(pr).all()),
          f"graph A PageRank: mass {mass}, {iters} iterations")
    log(f"[3] graph A PageRank: {iters} iterations, mass {mass:.7f}")
    srcs_a = sources(gA, 2, SEED)
    first = None
    for s in srcs_a:
        parents, levels = bfs(gA, s, plan=plan_a)
        first = (parents, levels) if first is None else first
        reached, depth = check_bfs_tree(gA, s, parents, levels)
        log(f"[3] graph A BFS from {s}: {reached} reached, depth {depth}, tree checked")
    streamed = bfs(gA, srcs_a[0], plan=make_plan(gA, strategy="sparse_streamed"))
    check(torch.equal(streamed[0], first[0]) and torch.equal(streamed[1], first[1]),
          "graph A: the sparse_streamed BFS differs from the auto BFS")
    launches_a = compressed_chunked_spmv.launches + compressed_stream_round.launches - before
    log(f"[3] graph A is exception-dense ({gA.n_exceptions} exceptions over the "
        f"limit): sparse_streamed runs plain sparse; kernel 1 launches {launches_a}")
    check(exception_dense(gA) and launches_a == 0, "graph A must not launch kernel 1")
    # the pull SpMV at full width (kernel 3's path)
    x = torch.randint(-9, 10, (gA.n,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(4)).to(dev)
    edge_block_spmv.launches = 0
    ts = time.perf_counter()
    got = spmv_vertex(A_.csr, x)
    torch.cuda.synchronize()
    spmv_a_s = time.perf_counter() - ts
    launches3 = edge_block_spmv.launches
    want = compressed_spmv_vertex(gA, x)   # exception-dense: the exact plain decode
    check(torch.equal(got, want), "graph A: spmv_vertex != compressed_spmv_vertex (int32 x)")
    check(launches3 > 0, "spmv_vertex on graph A did not launch kernel 3")
    # the earlier default: the filter built on every call, its words read
    ts = time.perf_counter()
    again = spmv_vertex(A_.csr, x, make_filter(A_.csr))
    torch.cuda.synchronize()
    filtered_s = time.perf_counter() - ts
    check(torch.equal(again, got), "graph A: spmv_vertex with the all-true filter differs")
    times_a = time_whole_graph_kernels(A_)
    log(f"[3] graph A spmv_vertex (kernel 3 over {A_.csr.num_blocks} blocks, "
        f"{A_.csr.m} edges): equals compressed_spmv_vertex for int32 x; {launches3} "
        f"launches; host wall {spmv_a_s:.4f} s (no filter words); with make_filter(g) "
        f"built first, as the call did when given no filter before: {filtered_s:.4f} s")
    log_times("3 graph A", times_a)
    wall["graph A"] = time.perf_counter() - t0

    # 4. graph B: the kernel path (main path starts) --------------------
    t0 = time.perf_counter()
    compressed_chunked_spmv.launches = 0
    compressed_stream_round.launches = 0
    plan_b = make_plan(gB, strategy="sparse_streamed")
    plan_cpu = make_plan(hB, strategy="sparse_streamed")
    srcs_b = sources(gB, 2 + 16, SEED + 1)

    def entries(before):
        return (compressed_chunked_spmv.launches - before[0],
                compressed_stream_round.launches - before[1])

    for s in srcs_b[:2]:
        before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
        parents, levels = bfs(gB, s, plan=plan_b)
        bfs_launches = entries(before)
        cp, cl = bfs(hB, s, plan=plan_cpu)
        check(bfs_launches == (0, int(levels.max()) + 1),
              f"graph B BFS: kernel 1 launches (decode, fused) {bfs_launches}, not one fused "
              "launch a round")
        check(torch.equal(parents.cpu(), cp) and torch.equal(levels.cpu(), cl),
              f"graph B BFS from {s} differs from the CPU route")
        before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
        dist = wbfs(gB, s, plan=plan_b)
        wbfs_launches = entries(before)
        check(wbfs_launches[0] == 0 and wbfs_launches[1] > 0,
              f"graph B wBFS: kernel 1 launches (decode, fused) {wbfs_launches}")
        check(torch.equal(dist.cpu(), wbfs(hB, s, plan=plan_cpu)),
              f"graph B wBFS from {s} differs from the CPU route")
        log(f"[4] graph B from {s}: BFS depth {int(levels.max())} (kernel 1 launches: decode "
            f"{bfs_launches[0]}, fused {bfs_launches[1]}), wBFS max dist "
            f"{int(dist[dist < 2**31 - 1].max())} (decode {wbfs_launches[0]}, fused "
            f"{wbfs_launches[1]}), both equal to the CPU route")
    pr, iters = pagerank(gB, eps=0.0, max_iters=PR_ITERS, plan=plan_b)
    pr_cpu, iters_cpu = pagerank(hB, eps=0.0, max_iters=PR_ITERS, plan=plan_cpu)
    pr_err = float((pr.cpu() - pr_cpu).abs().max())
    check(iters == iters_cpu == PR_ITERS and pr_err <= PR_ATOL,
          f"graph B PageRank differs from the CPU route by {pr_err}")
    log(f"[4] graph B PageRank, {iters} iterations: max abs diff to the CPU route {pr_err:.3g}")
    # a streamed round the fused kernel does not take (sums over int32):
    # k-core's histogram edgeMaps run the chunk loop over kernel 1's decode
    before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
    core = kcore(gE, plan=make_plan(gE, strategy="sparse_streamed"))
    kcore_launches = entries(before)
    check(torch.equal(core.cpu(), kcore(E_.host, plan=make_plan(E_.host,
                                                                strategy="sparse_streamed"))),
          "graph E k-core on a sparse_streamed plan differs from the CPU route")
    check(kcore_launches[0] > 0 and kcore_launches[1] == 0,
          f"graph E k-core (int32 sums): kernel 1 launches (decode, fused) {kcore_launches}")
    log(f"[4] graph E k-core on a sparse_streamed plan (int32 sums: the chunk loop), max core "
        f"{int(core.max())}: kernel 1 launches: decode {kcore_launches[0]}, fused "
        f"{kcore_launches[1]}; equal to the CPU route")
    wall["graph B"] = time.perf_counter() - t0

    # 4(b). batched edgeMap over feature-dim vertex state ----------------
    t0 = time.perf_counter()
    decode4b, cases4b, err4b, spent4b = drive_features(dev, B_, E_)
    log(f"[4] (b) edgemap_reduce_batched on (B, n, d) = ({FEAT[0]}, n, {FEAT[1]}) state, graphs "
        f"B and E, float32 sums and int32 min, modes dense / sparse / sparse_streamed / auto, "
        f"map_lanes on half the lanes: {cases4b} comparisons, each lane equal to its own "
        f"single-query run on the card and to the CPU route (min and touched bit for bit, sums "
        f"within float32's any-order bound: the largest error {err4b!r} of it); kernel 1 decode "
        f"launches {decode4b}, "
        f"fused 0; wall {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in spent4b.items()) + ")")
    wall["features"] = time.perf_counter() - t0

    # 5. serving -------------------------------------------------------
    t0 = time.perf_counter()
    engine = QueryEngine(gB, plan=plan_b, max_batch=8)
    reqs = [("bfs", {"src": s}) for s in srcs_b[2:14]] + [("wbfs", {"src": s})
                                                        for s in srcs_b[14:18]]
    serve_s, serve_launches, serve_rounds = serve(engine, reqs, plan_b)
    check(0 < serve_launches["fused"] <= serve_rounds and serve_launches["decode"] == 0,
          f"the engine's kernel 1 launches {serve_launches} in {serve_rounds} rounds: not at "
          "most one fused launch a round")
    main_launches = compressed_chunked_spmv.launches
    main_round_launches = compressed_stream_round.launches
    log(f"[5] engine: {len(reqs)} queries in {serve_s:.3f} s = {len(reqs) / serve_s:.2f} "
        f"queries/s, occupancy {engine.occupancy:.3f}, stats {engine.stats}, kernel 1 "
        f"launches: fused {serve_launches['fused']} in {serve_rounds} rounds of the drained "
        f"batches, decode {serve_launches['decode']}; every result equals its single run")
    check(main_launches > 0 and main_round_launches > 0,
          "the main path did not launch both of kernel 1's entries")
    log_profile("5 engine", profile_run(lambda: engine.serve(reqs)), serve_s * 1e3)
    wall["serving"] = time.perf_counter() - t0

    # 6. calibration on the card (kernel 2's path) ----------------------
    t0 = time.perf_counter()
    compressed_block_spmv.launches = 0
    chunked_before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
    table = calibrate(n=graph_b[0], m=graph_b[1], block_size=BLOCK, seed=SEED, quick=False,
                      device=dev)
    calib_s = time.perf_counter() - t0
    launches2 = compressed_block_spmv.launches
    check(launches2 > 0, "calibration did not launch kernel 2")
    TABLE_PATH.parent.mkdir(parents=True, exist_ok=True)
    table.save(str(TABLE_PATH))
    again = TuningTable.load(str(TABLE_PATH))
    check(again.to_dict() == json.loads(table.dumps()), "the table does not round-trip")
    log(f"[6] calibrate(n={graph_b[0]}, m={graph_b[1]}, full) on {table.host_key} "
        f"({table.hardware}) in {calib_s:.1f} s: kernel 2 launches {launches2}, kernel 1 "
        f"launches: decode {compressed_chunked_spmv.launches - chunked_before[0]}, fused "
        f"{compressed_stream_round.launches - chunked_before[1]}; saved to "
        f"{TABLE_PATH.relative_to(ROOT)} and reloaded equal")
    for backend in table.backends():
        d = table.decide(backend)
        log(f"[6]   {backend}: crossover_density {d.crossover_density!r}, dense_frac "
            f"{d.dense_frac!r}, dense_frac_batched {d.dense_frac_batched!r}, chunk_blocks "
            f"{d.chunk_blocks}, auto_sparse {d.auto_sparse}, auto_sparse_batched "
            f"{d.auto_sparse_batched}, batched_flavor_crossover "
            f"{d.batched_flavor_crossover!r}, max_batch {d.max_batch}, tile_blocks "
            f"{d.tile_blocks}")
    log(f"[6]   tile sweep: {table.to_dict()['backends']['compressed']['tile_sweep']}")
    shipped, measured = default_table().tile_blocks("compressed"), table.tile_blocks("compressed")
    log(f"[6]   kernel 2 tile decision: {measured} warps a CTA "
        f"({'changed from' if measured != shipped else 'unchanged from'} the shipped "
        f"default_table.json's {shipped})")
    wall["calibration"] = calib_s

    # 7. the measured plan on the main path ----------------------------
    t0 = time.perf_counter()
    plan_m = make_plan(gB, tuning=table)
    plan_c = make_plan(gB, tuning=None)
    check(plan_m.decisions.source == "measured", "the measured plan is not measured")
    for s in srcs_b[:2]:
        pm, lm = bfs(gB, s, plan=plan_m)
        pc, lc = bfs(gB, s, plan=plan_c)
        check(torch.equal(pm, pc) and torch.equal(lm, lc),
              f"BFS from {s}: measured plan differs from the constants plan")
        check(torch.equal(wbfs(gB, s, plan=plan_m), wbfs(gB, s, plan=plan_c)),
              f"wBFS from {s}: measured plan differs from the constants plan")
    engine_m = QueryEngine(gB, plan=plan_m)
    check(engine_m.max_batch == table.max_batch("compressed"), "max_batch not from the table")
    serve_m_s, serve_m_launches, serve_m_rounds = serve(engine_m, reqs, plan_m)
    log(f"[7] measured plan {plan_m.tuning_key}: BFS and wBFS from {srcs_b[:2]} equal the "
        f"constants plan's; engine (max_batch {engine_m.max_batch} from the table) "
        f"{len(reqs)} queries in {serve_m_s:.3f} s = {len(reqs) / serve_m_s:.2f} queries/s "
        f"(phase 5, constants sparse_streamed plan: {len(reqs) / serve_s:.2f}), "
        f"stats {engine_m.stats}, kernel 1 launches: fused {serve_m_launches['fused']} in "
        f"{serve_m_rounds} rounds, decode {serve_m_launches['decode']}; every result "
        "equals its single run")
    # both flavors of batched auto's sparse branch, around the batch's density
    deg = gB.degrees.cpu().numpy()
    masks = np.stack([np.random.default_rng(SEED + q).random(gB.n) < 0.002
                      for q in range(BATCH)])
    masks[:, srcs_b[0]] = True
    mean = float(np.sum(np.where(masks, deg, 0))) / (BATCH * gB.m)
    fm = torch.from_numpy(masks).to(dev)
    xb = torch.arange(gB.n, dtype=torch.int32, device=dev).expand(BATCH, gB.n).contiguous()
    singles = [edgemap_reduce(gB, fm[q], xb[q], monoid="min", plan=plan_m)
               for q in range(BATCH)]
    branch = {}
    for side, crossover in (("streamed", 2 * mean), ("per-lane", mean / 2)):
        before = (compressed_chunked_spmv.launches, compressed_stream_round.launches)
        # dense_frac=1 keeps the round on the sparse branch whatever the
        # measured threshold, so the flavor switch is what runs
        out, touched = edgemap_reduce_batched(gB, fm, xb, monoid="min", plan=plan_m,
                                              dense_frac=1.0, auto_sparse="sparse_streamed",
                                              flavor_crossover=crossover)
        branch[side] = (compressed_chunked_spmv.launches - before[0],
                        compressed_stream_round.launches - before[1])
        for q in range(BATCH):
            check(torch.equal(out[q], singles[q][0]) and torch.equal(touched[q],
                                                                     singles[q][1]),
                  f"batched auto ({side}) lane {q} differs from its single run")
    check(branch["streamed"] == (0, 1) and branch["per-lane"] == (0, 0),
          f"the flavor crossover did not pick both branches: (decode, fused) {branch}")
    log(f"[7] batched auto, B={BATCH}, mean lane density {mean!r}: crossover 2x the "
        f"density streams (one fused kernel 1 launch), 0.5x runs the per-lane loops (0 "
        "launches); every lane equals its single run")
    wall["measured plan"] = time.perf_counter() - t0

    # 9. the graphFilter path (kernel 4) --------------------------------
    t0 = time.perf_counter()
    stats["kernel 4"] = 0
    err4 = compare_filter_pack([A_.csr, gB, E_.dev, E_.csr], rng, stats)
    times4 = {"A": time_filter_pack(A_.csr), "B": time_filter_pack(gB)}
    log(f"[9] kernel 4 == plain on the card in {stats['kernel 4']} cases (bits and counts "
        f"exact; F_B 32/64/128, NB=4099, TB={TILE}, real filters of graphs A, B and E)")
    for gname, t in times4.items():
        log(f"[9] kernel 4 filter_pack at graph {gname}'s shape, every block in the subset, "
            f"TB={TILE}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms ({t['bytes']} B at {HBM_BYTES_PER_S / 1e12} TB/s)")
    # (c) the filter users at full width, on graph A's CSR (kernel 4's path)
    gcsr = A_.csr
    filter_pack_words.launches = 0
    r0 = rounds_of("maximal_matching")
    ts = time.perf_counter()
    partner = maximal_matching(gcsr)
    torch.cuda.synchronize()
    mm_s = time.perf_counter() - ts
    mm_rounds = rounds_of("maximal_matching") - r0
    mm_launches = filter_pack_words.launches
    matched = check_matching(gcsr, partner)
    check(mm_launches == mm_rounds > 0,
          f"maximal_matching: {mm_launches} kernel 4 launches in {mm_rounds} rounds")
    sets_a = torch.arange(gcsr.n, device=dev) < gcsr.n // 3
    r0 = rounds_of("set_cover")
    ts = time.perf_counter()
    cover = set_cover(gcsr, sets_a, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    sc_s = time.perf_counter() - ts
    sc_rounds = rounds_of("set_cover") - r0
    launches4 = filter_pack_words.launches
    sc_launches = launches4 - mm_launches
    coverable = check_set_cover(gcsr, sets_a, cover)
    check(sc_launches == 1 + sc_rounds,
          f"set_cover: {sc_launches} kernel 4 launches in {sc_rounds} rounds")
    check(launches4 > 0, "the filter path did not launch kernel 4")
    log(f"[9] graph A CSR maximal_matching: {mm_rounds} rounds, {matched} vertices matched, "
        f"invariants held, kernel 4 launches {mm_launches}, wall {mm_s:.3f} s")
    log(f"[9] graph A CSR set_cover (sets: ids < n/3): {sc_rounds} rounds, cover "
        f"{int(cover.sum())} sets for {coverable} coverable elements, invariants held, "
        f"kernel 4 launches {sc_launches} (1 + rounds), wall {sc_s:.3f} s")
    prof_s, busy_ms, _, top = profile_run(lambda: maximal_matching(gcsr))
    log(f"[9] graph A CSR maximal_matching under torch.profiler: wall {prof_s:.3f} s, kernels "
        f"{busy_ms:.1f} ms of device time (busy share {busy_ms / 1e3 / prof_s:.3f})")
    for name, ms, calls in top:
        log(f"[9]   {ms:10.3f} ms  {calls:5d} calls  {name[:110]}")
    # (d) the card against the CPU route (run by the child started above), exactly, on graph E
    pri, sets_e = filter_inputs(gE.n)
    cpu_route = finish_filter_cpu_route(cpu_route)
    for kind, gd in (("compressed", E_.dev), ("CSR", E_.csr)):
        before = filter_pack_words.launches
        ts = time.perf_counter()
        on_card = filter_results(gd, pri.to(dev), sets_e.to(dev), SEED)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - ts
        card_launches = filter_pack_words.launches - before
        on_cpu, cpu_s = cpu_route[kind]
        check(card_launches > 0 and filter_pack_words.launches - before == card_launches,
              f"graph E {kind}: kernel 4 launches {card_launches} on the card")
        check(on_cpu.keys() == on_card.keys(), f"graph E {kind}: the CPU route's results")
        for name in on_card:
            check(same_result(on_card[name], on_cpu[name]),
                  f"graph E {kind}: {name} on the card differs from the CPU route")
        log(f"[9] graph E {kind}: {', '.join(on_card)} equal the CPU route exactly "
            f"(triangles {on_card['triangle_count']}); card {card_s:.1f} s with "
            f"{card_launches} kernel 4 launches, CPU {cpu_s:.1f} s in a child process "
            f"({CPU_ROUTE_THREADS} threads, started before the graphs were built; this "
            f"process waited {cpu_route['waited']:.1f} s for it)")
    ts = time.perf_counter()
    tri = triangle_count(gB)
    tri_s = time.perf_counter() - ts
    dmax = int(orientation_filter(gB)[0].active_deg.max())
    check(tri > 0, "graph B has no triangle")
    log(f"[9] graph B triangle_count on the card: {tri} triangles, oriented dmax {dmax}, "
        f"wall {tri_s:.3f} s")
    wall["filter path"] = time.perf_counter() - t0

    # 10. the LM serving path (kernel 6) ---------------------------------
    t0 = time.perf_counter()
    record6 = drive_lm(dev, rng, stats, qwen2_1_5b.full_config())
    wall["LM serving"] = time.perf_counter() - t0

    # 11. SASRec serving (kernel 5) --------------------------------------
    t0 = time.perf_counter()
    record5 = drive_recsys(dev, stats)
    wall["SASRec serving"] = time.perf_counter() - t0

    # 12. connectivity, PPR and the serving tier ------------------------
    t0 = time.perf_counter()
    decode12, fused12 = drive_serving_tier(dev, A_, B_)
    main_launches += decode12
    main_round_launches += fused12
    wall["serving tier"] = time.perf_counter() - t0

    # 13. the rest of Table 1 and the rest of the core ------------------
    t0 = time.perf_counter()
    decode13, fused13, block13 = drive_table1(dev, A_, B_, E_,
                                              times_b[("compressed", 1)]["ms"])
    main_launches += decode13
    main_round_launches += fused13
    launches2 += block13
    wall["Table 1"] = time.perf_counter() - t0

    # 14. sharded execution on one card --------------------------------
    t0 = time.perf_counter()
    decode14, fused14, packs14, gsA = drive_sharding(dev, A_, B_, E_, srcs_b, reqs,
                                                     len(reqs) / serve_s)
    main_launches += decode14
    main_round_launches += fused14
    launches4 += packs14
    digests.update({("A shards", k): v for k, v in graph_digest(*gsA.shards).items()})
    wall["sharding"] = time.perf_counter() - t0

    # 14(g). the graph engine across processes: two ranks on the card ----
    t0 = time.perf_counter()
    decode14g, fused14g = drive_process_mesh(dev, B_, E_, srcs_b)
    main_launches += decode14g
    main_round_launches += fused14g
    wall["process mesh"] = time.perf_counter() - t0

    # 15. mutable graphs and the observability layer ---------------------
    t0 = time.perf_counter()
    main_round_launches += drive_mutable(dev, A_, B_, E_, graph_b)
    wall["mutable + observability"] = time.perf_counter() - t0

    # 16. mixture-of-experts and latent-attention serving (kernel 6) -------
    t0 = time.perf_counter()
    record6["launches"] += drive_moe(dev)
    wall["MoE + MLA serving"] = time.perf_counter() - t0

    # 8. large memory is never written (after every phase) ---------------
    now = graph_digest(gA, A_.csr, gB, B_.csr, E_.dev, E_.csr)
    now.update({("A shards", k): v for k, v in graph_digest(*gsA.shards).items()})
    check(now == digests, "a graph tensor changed")
    log("[8] graph A, B and E tensors, compressed and CSR, and graph A's shards, unchanged "
        "(SHA-256)")
    log("wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))

    tb_a, tb_b = times_a[("edge", 1)], times_b[("compressed", 1)]
    return [
        {
            "name": "compressed_chunked_spmv",
            "route": "cuda",
            "source": KERNEL_SOURCES["compressed"],
            "replaces": "src/repro/kernels/compressed_spmv/compressed_spmv.py:290",
            "launches": main_launches,
            "max_abs_err": err1,
            "ms": timing1["ms"],
            "plain_ms": timing1["plain_ms"],
            "bound_ms": timing1["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no one PyTorch call computes this decode
        },
        {
            "name": "compressed_stream_round",
            "route": "cuda",
            "source": KERNEL_SOURCES["compressed"],
            "replaces": "src/repro/kernels/compressed_spmv/compressed_spmv.py:290",
            "launches": main_round_launches,
            "max_abs_err": err1f,
            "ms": round_full["ms"],
            "plain_ms": round_full["plain_ms"],
            "bound_ms": round_full["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no one PyTorch call runs an edgeMap round
        },
        {
            "name": "compressed_block_spmv",
            "route": "cuda",
            "source": KERNEL_SOURCES["compressed"],
            "replaces": "src/repro/kernels/compressed_spmv/compressed_spmv.py:122",
            "launches": launches2,
            "max_abs_err": err2,
            "ms": tb_b["ms"],
            "plain_ms": tb_b["plain_ms"],
            "bound_ms": tb_b["bound_ms"],
            "bound_by": "bytes",
            "library_ms": tb_b["library_ms"],
        },
        {
            "name": "edge_block_spmv",
            "route": "cuda",
            "source": KERNEL_SOURCES["edge"],
            "replaces": "src/repro/kernels/edge_block_spmv/edge_block_spmv.py:72",
            "launches": launches3,
            "max_abs_err": err3,
            "ms": tb_a["ms"],
            "plain_ms": tb_a["plain_ms"],
            "bound_ms": tb_a["bound_ms"],
            "bound_by": "bytes",
            "library_ms": tb_a["library_ms"],
        },
        {
            "name": "filter_pack",
            "route": "cuda",
            "source": KERNEL_SOURCES["filter"],
            "replaces": "src/repro/kernels/filter_pack/filter_pack.py:52",
            "launches": launches4,
            "max_abs_err": err4,
            "ms": times4["A"]["ms"],
            "plain_ms": times4["A"]["plain_ms"],
            "bound_ms": times4["A"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": times4["A"]["library_ms"],
        },
        record5,
        record6,
    ]


if __name__ == "__main__":
    sys.exit(main())
