#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py [--profile]

Phases (each prints one JSON line with its seconds):

1. card and build: ``nvidia-smi``'s name and power limit; the ``nvcc``
   build of ``src/repro_torch/kernels/csrc/*.cu`` into ``build/``.
2. PageRank scale, ``backend="pallas"`` (kernel K2): ``rmat_edges(22, 16)``,
   the stand-in for LiveJournal (Ringo Table 3).  ``pagerank(n_iter=10)``,
   ``pagerank(tol=1e-6)`` and ``hits(n_iter=20)`` on "pallas" and "xla"
   must agree within 1e-5 of the largest value, PageRank must sum to 1, and
   K2 must launch once per PageRank round and twice per HITS round.
3. BSR path, ``backend="bsr"`` (kernels K1, K3): ``rmat_edges(14, 16)``,
   the reference's ceiling for the BSR layout.  PageRank and HITS on "bsr"
   against "xla" as in phase 2, PageRank against a float64 numpy power
   iteration, ``triangle_count(u, backend="bsr")`` equal to the oriented
   intersection exactly, with its one K3 launch through ``"sm90_wgmma"``,
   and ``connected_components`` against scipy.  K1 must launch 69 times
   (``K1_PATH_LAUNCHES``).  With ``--profile``, one more 10-round "bsr"
   PageRank runs under ``torch.profiler``: its device-busy share and K1's
   part of it.
3b. traversals and the rest of the analytics, in a launch window of its
   own.  Scale 22: ``bfs`` from the vertex of largest out-degree must
   auto-route to "frontier", equal "xla" bit for bit and equal a numpy
   level-synchronous BFS over the host CSR; ``frontier_fixpoint`` alone
   must read the host once a round (``torch.cuda.set_sync_debug_mode``);
   weighted ``sssp`` (uniform in [0.5, 4), numpy seed 7),
   ``connected_components`` and ``label_propagation(n_iter=20)`` on
   "frontier" must equal "xla"; a batched ``bfs`` of 4 sources with caps
   (1, 3, 8, none) must equal its rows' standalone runs;
   ``eigenvector_centrality(n_iter=50)`` and a 4-source 10-round
   ``personalized_pagerank`` on "pallas" must agree with "xla" and launch
   K2 exactly 50 and 40 times.  Scale 14: the same two on "bsr" and
   "pallas", ``k_core(k=8)`` and ``core_numbers`` equal to "xla" and to a
   numpy peel; each checked eigenvector and PPR call must launch its
   kernel 50 and 40 times, and the window K1 and K2 each (1 + WARM_REPS) x
   (50 + 40) + the peels' rounds;
   ``strongly_connected_components`` on "xla" and "bsr" equal to scipy's;
   ``per_node_triangles`` summing to 3x the triangle count; 16-source
   ``closeness_centrality`` on "frontier" equal to "xla".  Each comparison
   of two backends times both on their first call and then ``WARM_REPS``
   times more, the order alternating.  Its two lines print each analytic's
   seconds (under ``"frontier"`` and ``"analytics"``), the frontier's
   rounds and dense rounds, and the launches.
3c. the table front end and provenance, in a launch window of its own.
   (a) Phase 2's ``rmat_edges(22, 16)`` as a 67,108,864-row edge table
   (capacity 2^26; ``weight`` uniform in [1, 10), numpy seed 7):
   ``select`` weight >= 5, ``to_graph`` (self loops dropped), a 10-round
   "pallas" PageRank (K2 exactly 10 launches) within 1e-5 of "xla",
   ``table_from_map``, ``group_by`` src (count, int sum, mean; the same
   bits twice), ``join`` of the top 1,000 nodes with the selected edges,
   ``graph_to_edge_table`` + ``order``; every step against numpy.  (b)
   the paper's §4.1 StackOverflow pipeline on 4,000,000 synthetic posts
   (12,000 users; numpy seed 0): three selects, the AnswerId = PostId
   join, ``to_graph`` on the users, a 10-round "bsr" PageRank (K1 exactly
   10 launches), "bsr" triangles of the undirected user graph (one K3
   launch) equal to "xla"'s, ``table_from_map``.  In both, the result's
   provenance chain is exported (the script must compile) and replayed
   against the root table: bit-identical, K2 or K1 10 more launches; a
   tracked "xla" PageRank must make as many host syncs as an untracked
   one.  Window: K1 20, K2 20, K3 1.
3d. incremental maintenance and plan memory accounting, in a launch window
   of its own.  (a) Scale 22: the reference's ``bench_engine.py`` delta, a
   0.1% insert-only ``EdgeDelta`` (65,242 pairs of known ids, numpy seed
   7).  ``apply_delta`` and the child's patched plan (with ``in_edges`` /
   ``out_edges`` made to fail) must equal ``from_dense_edges`` of the
   child's edges and its cold plan, array for array, the plan's ``_parent``
   be ``g22.plan()``; their seconds and host syncs print beside the cold
   build's.  A warm ``pagerank(tol=1e-6)`` from the parent's vector on
   "xla" within 1e-5 of the cold one (rounds and seconds of each), then
   one warm "pallas" refresh (K2 once a round; its cold chunk layout timed
   apart).  ``incremental_bfs`` / ``_sssp`` from phase 3b's source and
   ``incremental_connected_components`` must engage and equal the cold
   runs bit for bit (frontier rounds of each printed).  The same inserts
   plus 1,000 deletes of existing pairs: every helper returns None and the
   cold BFS and CC equal a lineage-free rebuild's.  ``g22.plan()``'s
   ``nbytes_by_family()`` as left by the phases, ``evict_all()`` (the bytes
   it reports against the drop of ``torch.cuda.memory_allocated()``,
   within 5%), then with the undirected, csr, perm and chunks families
   warmed, evicted (within 5% again) and re-derived bit for bit.  (b)
   Scale 14: a 0.1% insert delta into tiles the graph holds; the child's
   ``bsr()`` / ``bsr_t()`` share the parent's ``rows`` / ``cols`` and equal
   a cold ``edges_to_bsr``; warm "bsr" PageRank (K1) within 1e-5 of the
   cold "xla" one; "bsr" triangles (K3, once) on the child's patched
   undirected view, with the parent's triples, equal to "xla"'s; one
   insert into a block pair the parent lacks rebuilds the tiles.  Window:
   K1 the two "bsr" PageRanks' rounds, K2 the "pallas" refresh's, K3 1.
3e. the interactive service, in a launch window of its own: four sessions
   on ``GraphService(workers=2)`` (fused BFS at scale 22, fused "bsr" PPR,
   "pallas" PageRank, "bsr" triangles: K1, K2, K3), a cache hit, a delta
   and its warm re-runs, a memory budget; four TCP clients on a
   ``GraphServer``; a spawned server running the paper's §4.1 workload.
3f. the "sharded" backend and ``core/distributed.py``, in a launch window
   of its own in which K1-K4 must launch 0 times.  (a) One process, one
   shard, phase 2's graph: ``pagerank(n_iter=10)``, ``pagerank(tol=1e-6)``,
   ``bfs`` and weighted ``sssp`` from phase 3b's source (its weights),
   ``connected_components`` and ``label_propagation(n_iter=20)`` on
   "sharded" must equal "xla" bit for bit; ``triangle_count(u14,
   backend="sharded")`` must equal "xla"'s; ``pagerank_distributed`` of
   ``shard_graph(g22)`` within 1e-6 of the "xla" PageRank (5e-5 with
   ``compress_bf16``), fed by ``distributed_to_graph`` within 1e-6,
   ``degrees_distributed`` equal to the in-degrees; a
   ``GraphService(engine_backend="sharded")`` PageRank equal to "xla"'s;
   the ``ShardPlan`` build seconds, edge slots and halo bytes a round at
   d = 2, 4 and 8.  (b) Two spawned ranks on the card in a gloo world
   (``build/phase3f/``: the parent's edges, a ``FileStore``, rank 0's
   results): the d = 2 "sharded" ``pagerank(n_iter=10)`` and
   ``connected_components`` must equal (a)'s "xla" results bit for bit;
   each rank prints its ms a round and its halo bytes.
3g. a 2-rank "sharded" service, in a launch window of its own in which
   K1-K4 must launch 0 times.  Two gloo ranks on the card, spawned as in
   3f (b) (``build/phase3g/``: the parent's edges and node ids, the
   delta, a ``FileStore``, rank 0's results): rank 0 serves phase 2's
   graph through ``GraphService(engine_backend="sharded", workers=2)``
   to two sessions (PageRank to 10 rounds and to ``tol``, CC, BFS from
   the largest out- and in-degree vertices, which must fuse), a cache hit,
   phase 3d's insert delta and a warm ``tol`` PageRank; rank 1 runs
   ``serve_follower`` until rank 0's ``close``.  Every result must equal
   3f (a)'s "xla" bits (the BFS from the second vertex and the warm
   PageRank from ``init`` = 3f's ``tol`` vector are computed on "xla" in
   this process), and the follower must have made as many calls as rank
   0 broadcast, with no error.
4. serving, kernel K4: ``qwen2.5-3b`` at full width and depth (36
   layers, d_model 2048) with random weights from a seeded generator,
   behind ``Engine`` with ``ServeConfig(batch=4, max_seq=2080)``: 4 prompts
   of 2048, 1536, 1024 and 512 token ids (numpy seed 0), 32 new tokens
   each.  K4 must launch once per layer in the prefill (36 times in the
   ``generate``), every output must hold its prompt plus 32 ids in
   ``[0, vocab)`` with finite logits, all 36 K4 launches must take the
   ``"sm90_wgmma"`` variant, a second ``generate`` must give the
   same tokens, and ``decode_step`` after ``prefill`` must agree with
   ``forward``'s last position (batch 2, S = 256) within 5e-2 of the
   largest logit.  With ``--profile``, one more prefill and one decode
   step run under ``torch.profiler``: their device-busy share and K4's
   part of it.
4c. MoE serving, kernel K4 in every layer's prefill: ``qwen3-moe-235b-a22b``
   (6 layers) and then ``grok-1-314b`` (2 layers), at full width
   (d_model 4096 / 6144; 128 experts top 8 / 8 experts top 2) with bf16
   parameters from a seeded generator, each behind ``Engine`` with phase
   4's ``ServeConfig`` and prompts (the ids drawn in its own vocab), 32 new
   tokens, freed before the next.  K4 must launch once per layer in the
   ``generate``, all ``"sm90_wgmma"``, at (4, 2048, 64, 128) and (4, 2048,
   48, 128) bf16; outputs, finite logits and a second ``generate`` as in
   phase 4; ``decode_step`` after ``prefill`` within phase 4's tolerance of
   ``forward`` at capacity factor E/k (16 and 4: no assignment drops at
   any T).  Layer 0's MoE on the prefill's own normed activations (T =
   8192) against ``moe_oracle_check``'s per-token oracle: routing equal to
   a float64 recomputation but for near ties (gap < 1e-5, counted), kept
   slots equal to a count in flat order, 256 sampled tokens (64 with a
   dropped slot) within 2e-2 x max|oracle| in bf16 and 1e-4 x in float32.
   Its line prints each model's parameters and bytes, memory before and
   at peak, capacity at prefill and decode, assignments dropped at prefill
   and in the decode steps, prefill seconds, decode seconds per token and
   tokens/s; with ``--profile``, one MoE prefill and one decode step under
   ``torch.profiler`` (busy share, top kernels).  Drops are counted by a
   spy on ``models.moe.route``.  K4 must launch 5 x 8 + 2 + 6 times in
   the phase (6 x 8 + 2 + 6 with ``--profile``; the last 6 are phase
   4f's yardstick, which phase 4f hands in as a baseline run on the
   model) and K1-K3 never.  After the
   window, K4 runs on the q, k, v that each model's layer 0 gave it in
   the first ``generate`` (after RoPE and the GQA repeat) and must pass
   ``attention_error_ratios`` there, as in phase 5; its times there
   print in the phase line and in K4's row (``moe_path_inputs``).  The
   models are built over a one-rank ``model_grid(1, 1)`` (the same
   weights and results as without it).
4f. the dense and MoE families sharded over ranks (after 4c): two gloo
   ranks spawned on the card (``build/phase4f/``, removed after), a (1, 2)
   ``model_grid``, one model at a time, freed before the next:
   ``qwen2.5-3b`` at full width and depth, then ``qwen3-moe-235b-a22b`` at
   phase 4c's 6 layers with ``moe_impl="expert_tp"`` at its own capacity
   factor (1.25).  Each rank draws the full weights from seed 0 and keeps
   its blocks (half the heads, FFN columns, experts and vocabulary),
   serves phase 4's prompts behind ``Engine(ServeConfig(batch=4,
   max_seq=2080))``, 32 new tokens, then runs the yardstick: the last
   prompt position's prefill logits and 4 decode steps fed the d = 1
   model's first 4 generated tokens.  The d = 1 yardstick is written by
   phase 4 (its engine's bf16 weights) and phase 4c (qwen3-moe with
   ``expert_tp`` over the one-rank grid, so the capacity rule is the
   same; a spy on ``models.moe.route`` records each routing's experts
   there and in the ranks' yardsticks).  Checks: every rank's yardstick
   logits within ``DECODE_TOL`` x the largest d = 1 logit, row by row,
   except a qwen3-moe decode step whose token chose other experts than
   at d = 1 in some layer, within ``ROUTED_STEP_TOL`` (a rounding flips
   tokens among near-equal router probabilities); both ranks route
   alike, and at most ``ROUTE_FLIP_LIMIT`` of the (token, layer)
   routings choose other experts than d = 1 (counts by position and
   layer, and the d = 1 router margins of the flipped tokens, print in
   the line); both ranks generate the same tokens; on each rank K4
   launches once a layer in the ``generate`` and once a layer in the
   yardstick's prefill, all ``"sm90_wgmma"``, at the local shapes
   (4, 2048, 8, 128) and (4, 2048, 32, 128), and K1-K3 never; rank 0's
   layer-0 q, k, v held to K4's plain version (``k4_on_path_inputs``,
   timed beside SDPA and the bound, in K4's row as
   ``sharded_lm_path_inputs``).  Each rank prints its prefill seconds,
   ms a decoded token, the collectives (count, bytes sent, host seconds)
   a prefill and a token, and ``max_memory_allocated``.  The ranks count
   their own launches: K4's row prints both ranks' sum as
   ``launches_phase_sharded_lm``.
4d. the xLSTM, whisper and VLM families, in a launch window of its own
   (after 4c, before 4b), each model freed before the next, weights from
   a seeded generator, f32 parameters and bf16 compute.  (a)
   ``xlstm-350m`` at full width and depth (24 mLSTM/sLSTM blocks) behind
   ``Engine`` with phase 4's ``ServeConfig`` and prompts, 32 new tokens,
   twice (the same tokens); layer 0's chunked ``mlstm_train`` and
   ``slstm_train`` against a token-by-token replay of ``*_decode`` over
   256 tokens, outputs and terminal states, in bf16 (2e-2 of the largest
   value) and float32 (1e-4); decode against ``forward``: one step after
   127 tokens in bf16 (phase 4's tolerance), 128 teacher-forced steps
   after 128 in float32 (2e-3 of the largest logit), the same 128 steps in
   bf16 measured only.  (b) ``whisper-small`` at full width and
   depth (12 + 12 layers, D = 64): stub frames (4, 1536, 768), decoder
   prompts of 416/320/224/128 ids, ``encode`` and 32 greedy tokens
   through ``prefill`` / ``decode_step``, twice.  (c) ``internvl2-26b`` at
   full width, 24 of its 48 layers (f32: its parameters and bytes print):
   patches (4, 256, 6144) before phase 4's prompts (2304 positions), 32
   greedy tokens from ``pos = P + S``, twice.  For (b) and (c) decode
   against ``forward`` (batch 2, 256 tokens); every check within phase
   4's tolerance.  Then, on the same models, phase 4j's d = 1 yardstick
   (``heads_yardstick``: a prefill and an ``encode``, 4 teacher-forced
   steps).  K4 must launch 0 times for xLSTM, 12 per ``encode`` and
   36 per whisper prefill or forward, once a layer per internvl2 prefill
   or forward (348 in the phase, 420 with ``--profile``), all through
   ``"sm90_wgmma"``, and K1-K3 never.  After the window, K4 runs on the
   q, k, v of whisper's encoder (non-causal, (4, 1536, 12, 64)), decoder
   self-attention (causal, (4, 416, 12, 64)) and cross-attention
   (non-causal, Sq = 416, Sk = 1536) and internvl2's decoder ((4, 2304,
   48, 128)) at layer 0, each held by ``attention_error_ratios`` and timed
   beside its plain version, SDPA (``is_causal`` as the call) and its
   bound (4·D flops a scored pair), in the phase line and in K4's row
   (``families_path_inputs``).  The line prints prefill seconds and
   decode seconds per token; with ``--profile``, the busy share of one
   prefill and one decode step of each model.
4e. the hybrid family, in a launch window of its own (after 4d, before
   4b): ``jamba-1.5-large-398b`` at full width (d 8192, 64 heads, GQA 8,
   D 128, d_ff 24576, 16 experts top-2, Mamba inner 16384, state 16,
   conv 4, vocab 65536), **one period cut to ``attn_every = 4``** (the
   reference's ``reduced`` rule for hybrids: 3 Mamba mixers, then
   attention; MoE on sub-layers 1 and 3, MLP on 0 and 2), bf16 weights
   from a seeded generator, behind ``Engine`` with phase 4's
   ``ServeConfig`` and prompts, 32 new tokens, twice (the same tokens).
   Layer 0's first Mamba in float32 on its own path input, (2, 256)
   tokens: the chunked ``mamba_train`` (4 chunks of 64) against
   ``mamba_decode`` stepped over them, outputs and terminal states, and
   the chunked terminal state against the plain recurrence over the
   unchunked sequence, each within atol 1e-4 + rtol 1e-3 (the reference's
   ``test_mamba_decode_matches_train_tail``).  Decode against ``forward``
   at capacity factor E/k (no drops) within phase 4's tolerance.  No
   per-token MoE oracle (a float32 copy of one jamba MoE layer is 38.7
   GB; the layer is phase 4c's code): the spy on ``models.moe.route``
   counts drops, and another the near ties (float64 gap < 1e-5) at
   prefill and at decode.  The line prints parameters counted on the
   meta device, bytes, memory before and at peak, prefill seconds and
   decode seconds per token; with ``--profile``, the busy share of one
   prefill and one decode step.  K4 must launch 4 times (one attention
   layer: two ``generate`` prefills, the check's forward and prefill; 5
   with ``--profile``), all ``"sm90_wgmma"``, and K1-K3 never.  After the
   window, K4 runs on the attention layer's own q, k, v ((4, 2048, 64,
   128) bf16 causal), held by ``attention_error_ratios`` and timed, in
   the phase line and in K4's row (``hybrid_path_inputs``).
4m. the two largest dense configs, in a launch window of its own (after
   4e, before 4g): ``mistral-nemo-12b`` (d 5120, 32 heads of 128, GQA 8:
   a query width of 4096, SwiGLU, RMSNorm, vocab 131072) and then
   ``starcoder2-15b`` (d 6144, 48 heads, GQA 4, biased q, k, v, tanh GeLU,
   LayerNorm, vocab 49152), each at its published 40 layers and width,
   **bf16 weights** (``DENSE_CONFIGS_OVER``: the float32 weights, 49.0
   and 63.8 GB, do not fit beside ``Engine``'s bf16 copy) from seed 0
   through ``Transformer.init_params``, one on the card at a time (the
   first deleted and collected before the second), behind ``Engine`` with
   phase 4's batch and prompts, 32 new tokens, twice; phase 4's checks:
   the engine serves the model itself, K4 40 times a ``generate``, all
   ``"sm90_wgmma"``, each output its prompt plus the new tokens, ids
   below the vocabulary, finite logits, the same tokens twice, decode
   against ``forward`` within ``DECODE_TOL``.  The line prints the
   parameters (counted on the meta device), bytes, peak memory, prefill
   seconds and decode seconds per token.  After the window, K4 runs on
   each model's layer-0 q, k, v ((4, 2048, 32, 128) and (4, 2048, 48,
   128) bf16 causal), held by ``attention_error_ratios`` and timed beside
   SDPA and its bound (``dense_configs_path_inputs`` in K4's row).
4g. the dry run (``launch/dryrun.py``, after 4e, before 4b), in a launch
   window of its own.  (a) ``--list``, then every cell of the single-pod
   and two-pod sweeps counted on the meta device over counting groups (no
   card; one process a core): the counts of cells ``ok``,
   ``skipped`` and ``error`` must be
   ``DRYRUN_STATUS``'s; qwen2.5-3b x prefill_32k x single's flops, bytes,
   collective and wire bytes and argument bytes, and each ringo cell's
   shard sizes and gather bytes, print.  (b) Rank 0 of that cell for real
   at full width and depth: 256 ranks (16 x 16 counting groups), a local
   batch of 2 x 32,768 tokens (numpy seed 0), 1 of 16 query heads with
   its KV head, 688 of 11,008 MLP columns, 9,496 of 151,936 vocabulary
   rows, all 36 layers, weights from ``init_params`` (seed 0) on the
   card.  Its counted flops must equal the meta count exactly and its
   argument bytes the real tensors'; K4 must launch 36 times, all
   ``"sm90_wgmma"``, at (2, 32768, 1, 128) causal bf16; the prefill's
   seconds, TFLOP/s and ``max_memory_allocated`` (beside the dry run's
   peak estimate) print.  Then K4 on layer 0's own q, k, v, held to its
   plain version by ``attention_error_ratios`` and timed beside SDPA and
   its bound.  (c) Rank 0 of ``pagerank_twitter`` (d = 256: ns 162,891,
   es 5,742,188) and of ``pagerank_twitter_2d`` (side 16: nb 2,606,250),
   one step each on the card over random edges of the shard's shape
   (seed 0), within 1e-6 of the largest value of the same step on the
   CPU; ms a step and counted bytes / ms print.
4b. training, kernel K4 under autograd: ``qwen2.5-3b`` at full width cut
   to ``TRAIN_LAYERS`` = 12 of 36 layers (f32 parameters, bf16 compute,
   ``remat="full"``, AdamW), seeded
   random weights, on batches of 2 x 1024 random walks
   (``RandomWalkCorpus``, seed 0) over an R-MAT scale-17 graph (edge
   factor 16, seed 0, self loops dropped) built by the engine: five
   steps.  Step 0's ``ce`` must equal the serving ``forward``'s cross
   entropy on the same batch within 1e-2 relative, every loss and
   gradient norm must be finite, step 4's loss below step 0's; a
   checkpoint after steps 0-2 (``build/phase4b/``, removed after), loaded
   in place after step 4, must give step 3's loss again within 1e-3.  K4
   must launch 24 times a step (12 in the forward, 12 in ``remat``'s
   recompute) plus 12 for the serving forward.  Its line prints the step
   seconds, tokens/s and ``max_memory_allocated``; with ``--profile`` one
   more step runs under ``torch.profiler``: its device-busy share and
   K4's part of it.  (K1-K3's rows of phase 5 are measured before 4b, and
   the plans of phases 2-3's graphs evicted, so that 4b and 4h have the
   card.)
4h. the sharded train step (``train/zero.py``), gloo ranks sharing the
   card (``launch/mesh.model_grid``), on phase 4b's first batches, weights
   from seed 0 as there.  Before each run the parent prints the
   reckoning of a rank's bytes (parameter blocks, gradients, float32
   reduced gradients, ZeRO state, logits), which must stay under 72 GB
   over the ranks.  (a) phase 4b's qwen2.5-3b (12 layers) over (1, 2),
   3 steps: each step's loss within 1e-2 and gradient norm within 5% of
   phase 4b's, step 2's loss below step 0's, and on each rank K4 24
   times a step (12 forward, 12 recompute), all ``"sm90_wgmma"``, at
   (2, 1024, 8, 128).  (b) The same cut to 6 layers over (2, 2), ZeRO-1
   over two data ranks, 3 steps, within 1e-2 of a one-rank run of the cut
   model in the parent first: each rank's optimizer state holds half of
   each block it splits (only the qkv biases, split over "model" on their
   one dim, stay whole), and the gradients' reduction over "data"
   receives exactly the bytes its layout predicts, (d - 1)/d of each
   split float32 gradient.  (c) qwen3-moe at full width cut to 2 layers,
   ``moe_impl="expert_tp"``, capacity factor 1.25, Adafactor, bf16
   parameters, over (1, 2), 2 steps, within 2e-2 of a one-rank run first.
   Every value finite; the ranks that hold the same block report the same
   bits for it (checksums: the norms, the routers, a shared KV head's
   columns, every block across data replicas).  Its line prints, for each
   run, step seconds, tokens/s, each rank's peak memory beside the
   reckoning, and each step's collectives by phase (forward, backward,
   recompute, gradients, optimizer: calls, bytes sent and received, host
   seconds).
4i. weights split over "data" (``two_d_weights``): qwen3-moe and grok-1
   at full width, each weight's d_model dim on "data" as ``rules_for``
   decides for both models at their published depth, over four gloo
   ranks sharing the card as the (2, 2) grid (experts on "model",
   ``expert_tp``, capacity factor 1.25); every weight is gathered over
   the two data ranks where it is used (``launch/mesh.ModelGrid.weight``).
   Before each run the parent prints the reckoning of a rank's bytes
   (2-D blocks, one layer's gathered weights, float32 reduced gradients,
   Adafactor state, logits), which must stay under 72 GB over the ranks.
   (a) qwen3-moe: cut to 1 layer, ``Engine.generate`` of phase 4's
   prompts (left-padded to 2048, two a data rank) with 2 new tokens, then
   the yardstick (the prefill and 2 teacher-forced decode steps), held to
   a d = 1 run of the same cut model in the parent first, per data
   shard's half (``expert_tp`` routes each shard alone): every (row,
   position) within ``DECODE_TOL`` of the largest logit,
   ``ROUTED_STEP_TOL`` where the row's token chose other experts, at
   most ``ROUTE_FLIP_LIMIT`` of the routings flipped; then, cut to 2
   layers, 2 Adafactor steps of the sharded train step on phase 4b's
   batches, one row a data rank: step 0's loss within 2e-2 of phase 4h
   (c)'s one-rank run, step 0's gradient norm within
   ``TWO_D_NORM_TOL`` of its and step 1's loss within
   ``TWO_D_STEP1_TOL``, every value finite, each leaf split over both
   axes a quarter, the norms the same bits on every rank; and each rank's
   step-0 gradient of each 2-D block (reduced, before clipping, kept in
   bf16) within ``TWO_D_NORM_TOL`` relative L2 of the average of one
   rank's gradients on the two data halves from seed 0, in the parent
   after the ranks (``two_d_halves_grad``), each half routed alone to the
   experts its data rank's ranks chose (``moe_choices``: without that, a
   bf16 near tie rounded apart moves an expert's block by ~20%), every
   leaf's gap printed.  (b) grok-1 cut to
   1 layer: the yardstick with 1 teacher step, the same limits.  Every
   call gathers the rank's blocks through the host, ~3 GB, so the
   serving is cut to one layer and to 2 and 1 decode steps.  K4 runs on
   each rank's heads, ``"sm90_wgmma"``: at (2, 2048, 32, 128) serving and
   (1, 1024, 32, 128) training for (a), (2, 2048, 24, 128) for (b); rank
   0's layer-0 q, k, v at each of these shapes go to K4's row
   (``two_d_path_inputs``: held to the plain version by
   ``attention_error_ratios`` and timed beside SDPA).  Its line prints
   the prefill seconds, seconds a token and step seconds, each rank's
   peak memory beside the reckoning, and the collectives by axis and
   phase (the "data" axis carries the weight gathers).
4j. attention's heads as whole heads where they do not split evenly over
   the model ranks (``models/attention.head_range``: the first H % m ranks
   one head more), and the audio and vlm families sharded: eight gloo
   ranks sharing the card.  (a) qwen1.5-4b at full width cut to
   ``HEADS_DENSE_LAYERS`` of 40 layers over (1, 8), the smallest m at
   which its 20 heads do not split while its vocabulary and d_ff do: 3
   heads on ranks 0-3, 2 on 4-7; (b) whisper-small at full width and
   depth over (1, 8): 12 heads, 2 on ranks 0-3, 1 on 4-7, encoder and
   decoder; (c) internvl2-26b at full width cut to ``VLM_LAYERS`` as
   phase 4d cuts it, over (1, 2) on ranks 0 and 1 (24 query and 4 KV
   heads a rank).  Each runs ``heads_yardstick`` (a prefill of
   ``HEADS_BATCH`` prompts of ``HEADS_PROMPT`` ids behind whisper's frames
   or the VLM's patches, then ``YARD_STEPS`` teacher-forced decode steps;
   whisper's against ``encode``'s output) from seed-0 weights, every
   rank's logits the same bits and within ``DECODE_TOL`` of the largest
   logit of the d = 1 run on the same weights and inputs: (a)'s in the
   parent, (b)'s and (c)'s by phase 4d on its models.  On each rank K4
   runs ``"sm90_wgmma"`` on its own heads, bf16, causal and (whisper's
   encoder and cross-attention) non-causal at D = 64, the launches per
   shape counted a rank against ``heads_want_k4`` (a rank with no head
   would launch none and count its headless calls); ranks 0 and m - 1
   (the most and the fewest heads) hold K4 to its plain version on each
   of their layer-0 shapes (``heads_path_inputs`` in K4's row).  Its line
   prints each rank's heads, seconds and collectives per prefill, encode
   and token (``ModelGroup.stats``: at m = 8 a psum receives 7 parts).
4k. the ssm and hybrid families over model ranks, eight gloo ranks
   sharing the card.  (a) xlstm-350m at full width and depth, float32
   compute (``RECURRENT_OVER``), over (1, 8):
   its 4 mLSTM heads one a rank on ranks 0-3 and none on 4-7 (the
   headless branch, ``models/xlstm.NO_HEAD``), the sLSTM's 2048 channels
   as 256 a rank, its ``h`` gathered at each step; (b) jamba-1.5-large at
   full width in phase 4e's period (``HYBRID_PERIOD``) over (1, 2) on
   ranks 0 and 1, ``expert_tp``, capacity factor 1.25, bf16: 32 query and
   4 KV heads, 8192 Mamba channels and 8 experts a rank.  Each runs
   ``heads_yardstick`` (a prefill of ``RECURRENT_BATCH`` prompts of
   ``RECURRENT_PROMPT`` ids, then ``YARD_STEPS`` teacher-forced decode
   steps) from seed-0 weights, every rank's logits the same bits and
   within ``DECODE_TOL`` of the largest logit of the d = 1 run on the same
   weights and inputs, run first in the parent over the one-rank grid and
   freed before the ranks spawn (jamba's 45.94 GB and both ranks' do not
   fit together; the ranks draw their blocks one after another).  The
   model group's calls a prefill and a token must be
   ``recurrent_collectives``' (an sLSTM gather a step a block).  K4
   launches once a jamba rank, ``"sm90_wgmma"`` at (2, 1024, 32, 128),
   none for xLSTM; ranks 0 and 1 hold it to its plain version on their
   layer-0 inputs (``recurrent_path_inputs`` in K4's row).  Its line
   prints the prefill seconds and ms a token, seconds a decode token,
   collectives by count and bytes sent and received, each rank's peak
   memory and the largest gap against d = 1 over the largest logit.
4l. the xLSTM, whisper, VLM and hybrid families, and the two largest dense
   configs, trained over model ranks: one world of 16 gloo ranks sharing
   the card, each run of ``FAMILY_TRAIN_RUNS`` on ranks 0..m-1 over (1, m),
   two sharded train steps (``remat="full"``): (a) xlstm-350m cut to 12
   of 24 blocks in float32 compute over (1, 8), 2 x 16 tokens, AdamW (mLSTM heads on ranks
   0-3, none on 4-7); (b) whisper-small at full width cut to 2 + 2 of its
   12 + 12 layers over (1, 16), 2 x 64 tokens behind (2, 1536, 768) stub
   frames (12 heads on ranks 0-11, none on
   12-15); (c) internvl2-26b at full width cut to 4 of 48 layers over (1,
   2), 2 x 128 tokens behind 256 patches; (d) jamba-1.5-large at full width
   in one period of ``attn_every = 2`` (a Mamba with its MLP, then
   attention with the MoE) with 4 of 16 experts, ``expert_tp``, capacity
   factor 1.25, Adafactor, bf16, over (1, 2), 2 x 512 tokens; (e)
   starcoder2-15b and (f) mistral-nemo-12b at full width cut to 2 of 40
   layers over (1, 16), 2 x 128 tokens, AdamW: 3 and 2 query heads a rank,
   each KV head read by 4 and 2 ranks, so its gradient is a model-axis sum
   over them; weights from seed 0, batches from numpy seeds 0 and 1.  The d
   = 1 run of each goes first in this process and is freed; each run's
   reckoning (parameters, gradients, state, logits, and the larger of the
   backward's activations and the update's temporaries,
   ``family_train_reckoning``) over its ranks, the 16 CUDA contexts and
   what this process holds must stay under 72 GB.  Then on every rank: each
   step's loss within ``FAMILY_TRAIN_LOSS_TOL`` and step 0's gradient norm
   within ``FAMILY_TRAIN_NORM_TOL`` of d = 1's, every value finite; the
   same bits of what ranks share after each step (a KV head's block and its
   AdamW m and v on its holders too); each step's collectives by phase
   (forward, recompute, backward, gradients (a sum a shared KV leaf),
   optimizer) equal to ``family_train_collectives``; the headless calls of
   attention and of the mLSTM in every call of the forward and the
   recompute on the ranks with no head, none elsewhere; K4's calls by shape
   (``family_train_want_k4``: 12 a step on whisper's ranks 0-11, 8 on
   internvl2's, 2 on jamba's, 4 on starcoder2's and mistral-nemo's, none on
   xLSTM's), each a ``"sm90_wgmma"`` launch; the peak memory under the
   reckoning; in (e) and (f), step 0's gradient of every KV leaf and of
   layer 0's wq (the control no rank shares), after the model-axis sums and
   before clipping, within ``FAMILY_TRAIN_GRAD_TOL`` relative L2 of d = 1's
   cut to the rank's block on every rank (``leaf_grad_gaps``).  Rank 0 and
   the last rank with a head hold K4 to its plain version on step 0's
   layer-0 inputs (``family_train_path_inputs`` in K4's row).  Its line
   prints each run's step seconds, collectives by phase, peaks and gaps.
5. every kernel against its plain PyTorch version at the shapes phases 2-4
   gave it, with its time, the plain version's, a library call's where one
   computes the same function, and the card's lower bound.  Printed as one
   ``{"kernels": [...]}`` line.  K4's wgmma variant at the prefill shape
   must pass ``attention_error_ratios`` (max and mean error against the
   float32 plain version within twice those of the plain version that
   rounds p to bf16) and give the same bits twice; under autograd at
   phase 4b's shape (2, 1024, 16, 128), K4's forward and the PyTorch
   backward must give dq, dk, dv within the same rule against autograd
   through the plain version (its row's ``backward``, timed beside SDPA's
   backward as a yardstick only), and the same at a rank's heads of phase
   4h (a), (2, 1024, 8, 128) (``backward_rank_heads``), and at a whisper
   rank's three shapes of phase 4l (``backward_whisper``: the encoder's
   (2, 1536, 1, 64) and cross-attention's 64 x 1536 non-causal, the
   decoder's (2, 64, 1, 64) causal); the CUDA-core
   variant at
   the same shape (the "before" time) must match its plain version within
   one bf16 ulp per element (``|got - want| <= 2^-7·|want| + 1e-6``), and
   in float32 within 2e-5.  K2 must give the same bits twice; its row
   also times other piece sizes.  K1 must give the same bits twice, beat
   ``torch.sparse_bsr_tensor @ x`` and equal its device-built tables'
   plain versions; its row times piece sizes 2-32 and its C entry point
   alone.
   K3 must equal its plain version exactly on the sorted and on a shuffled
   triple order, build the plain ``run_table`` on the device, and be at
   least 8x faster than its ``"wmma"`` variant timed at the same shape;
   its row also times, as a yardstick only, ``torch.mm`` of the dense
   fp16 adjacency.  The
   ptxas report of K1's and K3's sources must show no spill.

The launch counts of phases 2-3 and of phase 4's ``generate`` are the main
path's, and phases 3b's to 3g's, 4c's, 4f's, 4d's, 4e's, 4m's, 4g's, 4b's,
4h's, 4i's, 4j's, 4k's and 4l's are their own (3d's to 3g's, 4c's, 4f's,
4d's, 4e's, 4m's, 4g's, 4b's, 4h's, 4i's, 4j's, 4k's and 4l's print in
each kernel row as
``launches_phase_3d`` ... ``_3g``, ``launches_phase_moe``,
``launches_phase_sharded_lm``, ``launches_phase_families``,
``launches_phase_hybrid``, ``launches_phase_dense_configs``,
``launches_phase_dryrun``,
``launches_phase_train``, ``launches_phase_sharded_train``,
``launches_phase_two_d``, ``launches_phase_heads``,
``launches_phase_recurrent`` and ``launches_phase_family_train``; the
ranks of 4f, 4h, 4i, 4j, 4k and 4l count their own): each window's
counts are zeroed just before it and read just after it.  Any failed
check raises, and the script exits non-zero without its last line, which
on success is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it fails before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # CUDA cores
              torch.bfloat16: 989e12,   # tensor cores
              torch.float16: 989e12}

TOL = 1e-5   # relative to the largest value, as the reference's parity tests

# file:line of each Pallas TPU kernel the port replaces
REPLACES = {
    "bsr_spmv": "src/repro/kernels/bsr_spmv.py:53",
    "segment_sum_chunked": "src/repro/kernels/segment_sum.py:97",
    "bsr_tricount": "src/repro/kernels/bsr_tricount.py:46",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:84",
}
SOURCES = {
    "bsr_spmv": "src/repro_torch/kernels/csrc/bsr_spmv.cu",
    "segment_sum_chunked": "src/repro_torch/kernels/csrc/segment_sum.cu",
    "bsr_tricount": "src/repro_torch/kernels/csrc/bsr_tricount.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
}
# K1 on phase 3's path: PageRank 10 rounds, 9 rounds to tol, HITS 20
# rounds (a pull and a push each), the float64 check's 10 rounds
K1_PATH_LAUNCHES = 69
WARM_REPS = 3   # phase 3b: timed calls of each backend after the checked one
SERVE_PROMPTS = (2048, 1536, 1024, 512)   # prompt lengths of phase 4
SERVE_NEW = 32
DECODE_TOL = 5e-2   # decode vs forward, relative to the largest logit
DECODE_CHECK = (2, 256)   # decode vs forward: batch and tokens
BF16_ULP = 2.0 ** -7   # one bf16 ulp relative to the value (8 significant bits)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def expandable_segments() -> None:
    """The card's allocator with expandable segments in this process and
    the ranks it spawns (before its first allocation), so that what a
    phase frees leaves the card at ``torch.cuda.empty_cache``: a library's
    workspace carved from a large cached block kept the whole block
    reserved, 1.23 GB a rank of phase 4l after a run and 7.2 GB in this
    process before it on an H100 (PERF.md section 6)."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def sync() -> None:
    if torch.cuda.is_initialized():   # a CPU rehearsal has nothing to wait for
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of one call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: int, flops: int, dtype) -> tuple:
    """Least time the card could take: max of bytes/bandwidth, ops/peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare_runs(g, backend, counter, runs):
    """Run each (name, fn, min launches) on ``backend`` and "xla"; check
    agreement and the kernel's launches; return one record per run."""
    out = {}
    for name, fn, want_launches in runs:
        ref, t_ref = timed(lambda: fn("xla"))
        before = counter.launches
        got, t_got = timed(lambda: fn(backend))
        launches = counter.launches - before
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        err = max(max_abs(a, b) for a, b in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        check(all(torch.isfinite(x).all() for x in got) and
              all(x.shape == (g.n_nodes,) for x in got),
              f"{name}: finite ({g.n_nodes},) output")
        check(err <= TOL * scale, f"{name} {backend} vs xla: max|d| {err} > "
              f"{TOL} * {scale}")
        check(launches >= want_launches,
              f"{name}: {launches} launches < {want_launches}")
        rec = {"seconds_xla": t_ref, f"seconds_{backend}": t_got,
               "max_abs_diff": err, "max_abs_xla": scale,
               "launches": launches}
        if name.startswith("pagerank"):
            total = float(got[0].double().sum())
            check(abs(total - 1.0) <= 1e-4, f"{name}: sum {total} != 1")
            rec["sum"] = total
        out[name] = rec
    return out


def np_pagerank(src, dst, n, n_iter=10, damping=0.85):
    """Float64 power iteration over an edge list (the oracle of the
    reference's tests, vectorized)."""
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    for _ in range(n_iter):
        new = np.full(n, (1.0 - damping) / n)
        new += damping * pr[outdeg == 0].sum() / n
        np.add.at(new, dst, damping * pr[src] / outdeg[src])
        pr = new
    return pr


def phase_pagerank_scale(dev, scale):
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    t0 = time.perf_counter()
    (src, dst), t_gen = timed(lambda: rmat_edges(scale, 16, seed=0))
    g, t_build = timed(lambda: Graph.from_edges(src, dst, device=dev))
    runs = [("pagerank_n10", lambda be: A.pagerank(g, n_iter=10, backend=be), 10),
            ("pagerank_tol", lambda be: A.pagerank(g, tol=1e-6, backend=be), 1),
            ("hits_n20", lambda be: A.hits(g, n_iter=20, backend=be), 40)]
    res = compare_runs(g, "pallas", segment_sum_chunked, runs)
    emit({"phase": "pagerank_scale", "backend": "pallas", "scale": scale,
          "edges_generated": int(src.shape[0]), "nodes": g.n_nodes,
          "edges": g.n_edges, "seconds_rmat": t_gen,
          "seconds_graph": t_build, "runs": res,
          "seconds": time.perf_counter() - t0})
    return g, (src, dst)


def phase_bsr(dev, scale):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_cc
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, 16, seed=0)
    g = Graph.from_edges(src, dst, device=dev)
    # HITS pulls and pushes once a round: 40 launches in 20 rounds show K1
    # ran on both the pull (M) and the push (M^T) tile streams
    runs = [("pagerank_n10", lambda be: A.pagerank(g, n_iter=10, backend=be), 10),
            ("pagerank_tol", lambda be: A.pagerank(g, tol=1e-6, backend=be), 1),
            ("hits_n20", lambda be: A.hits(g, n_iter=20, backend=be), 40)]
    res = compare_runs(g, "bsr", bsr_spmv, runs)

    # PageRank against an independent float64 power iteration
    s, d = (t.cpu().numpy() for t in g.out_edges())
    want = np_pagerank(s, d, g.n_nodes)
    got = A.pagerank(g, n_iter=10, backend="bsr").cpu().numpy()
    err_np = float(np.abs(got - want).max())
    check(err_np <= 2e-5, f"pagerank bsr vs float64 oracle: {err_np}")

    u = g.to_undirected()
    tri_xla, t_xla = timed(lambda: A.triangle_count(u))
    before = bsr_tricount.launches
    by_variant = bsr_tricount.launches_by_variant
    variants_before = dict(by_variant)
    tri_bsr, t_bsr = timed(lambda: A.triangle_count(u, backend="bsr"))
    k3 = bsr_tricount.launches - before
    k3_variants = {k: by_variant[k] - variants_before[k] for k in by_variant}
    check(tri_bsr == tri_xla, f"triangles bsr {tri_bsr} != xla {tri_xla}")
    check(k3 == 1, f"K3 launched {k3} times for one triangle count")
    check(k3_variants["sm90_wgmma"] == 1,
          f"K3's launch on the path took {k3_variants}, not sm90_wgmma")

    labels, t_cc = timed(lambda: A.connected_components(g))
    n = g.n_nodes
    adj = sp.coo_matrix((np.ones(len(s)), (s, d)), shape=(n, n))
    _, comp = sp_cc(adj, directed=True, connection="weak")
    min_id = np.full(comp.max() + 1, n)
    np.minimum.at(min_id, comp, np.arange(n))
    check(np.array_equal(labels.cpu().numpy(), min_id[comp]),
          "connected components vs scipy")

    tiles, rows, _, nb = u.plan().bsr()
    t_ij, _, _ = u.plan().tri_triples()
    emit({"phase": "bsr", "backend": "bsr", "scale": scale,
          "nodes": g.n_nodes, "edges": g.n_edges, "row_blocks": nb,
          "tiles_undirected": int(tiles.shape[0]),
          "triples": int(t_ij.shape[0]), "runs": res,
          "pagerank_vs_float64_max_abs": err_np,
          "triangles": tri_xla, "seconds_triangles_xla": t_xla,
          "seconds_triangles_bsr": t_bsr, "k3_launches": k3,
          "k3_launches_by_variant": k3_variants,
          "components": int(len(np.unique(comp))), "seconds_cc": t_cc,
          "seconds": time.perf_counter() - t0})
    return g, u, k3_variants


def device_busy(fn, parts, top: int = 0) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its synchronised wall
    seconds, the summed device time of the kernels it ran, for each
    ``parts`` key the device seconds of the kernels whose names contain
    one of its strings, and the ``top`` kernel names by device seconds."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in ev) / 1e6
    out = {"wall_seconds": wall, "kernels": len(ev), "device_seconds": busy,
           "busy_share": busy / wall}
    for key, names in parts.items():
        part = sum(e.device_time for e in ev
                   if any(n in e.name for n in names)) / 1e6
        out[f"{key}_device_seconds"] = part
        out[f"{key}_share_of_busy"] = part / busy if busy else 0.0
    if top:
        by_name = {}
        for e in ev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e6
        out["top_kernels"] = sorted(by_name.items(), key=lambda kv: -kv[1])[
            :top]
    return out


def profile_bsr(g14):
    """Where the time of one 10-round "bsr" PageRank goes: device-busy
    share and K1's part of the busy time (its kernels and its tables')."""
    from repro_torch.core import algorithms as A
    emit({"phase": "profile_bsr", "pagerank_n10": device_busy(
        lambda: A.pagerank(g14, n_iter=10, backend="bsr"),
        {"k1": ("bsr_spmv", "piece_")})})


def np_bfs_levels(ptr, idx, n, source):
    """Level-synchronous BFS over a host CSR (numpy): int32 levels, -1
    where unreachable.  Independent of the port's code."""
    level = np.full(n, -1, np.int32)
    level[source] = 0
    front, depth = np.asarray([source]), 0
    while front.size:
        starts, lens = ptr[front], ptr[front + 1] - ptr[front]
        lane = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                      lens)
        nbr = idx[np.repeat(starts, lens) + lane]
        depth += 1
        level[nbr[level[nbr] < 0]] = depth
        front = np.flatnonzero(level == depth)
    return level


def np_peel(row, col, n, k):
    """k-core peel over an undirected edge list (numpy): the alive mask and
    the number of rounds an until-unchanged fixpoint runs (the last one sees
    no change)."""
    alive, rounds = np.ones(n, bool), 0
    while True:
        rounds += 1
        deg = np.bincount(row, weights=alive[col], minlength=n)
        new = alive & (deg >= k)
        if np.array_equal(new, alive):
            return alive, rounds
        alive = new


def np_core_numbers(row, col, n, k_max):
    """``core_numbers``'s sweep in numpy: core numbers and total rounds."""
    core, total = np.zeros(n, np.int32), 0
    for k in range(1, k_max + 1):
        alive, rounds = np_peel(row, col, n, k)
        total += rounds
        if not alive.any():
            break
        core[alive] = k
    return core, total


def frontier_rounds():
    """(rounds, dense rounds) the frontier loop has run in this process:
    the engine's ``engine.frontier.rounds`` / ``.dense_rounds`` counters."""
    from repro_torch import obs
    return (obs.counter("engine.frontier.rounds").value,
            obs.counter("engine.frontier.dense_rounds").value)


def count_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing CUDA calls it made, counted by the
    ``file:line`` of the Python call that made them."""
    import collections
    import warnings
    sync()
    # switching the monitor on syncs once itself: not part of ``fn``
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    return out, dict(collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def phase_traversal(dev, g22, g14, u14, scales=(22, 14)):
    """Phase 3b: the frontier backend and the rest of the analytics, on the
    graphs of phases 2 (``g22``) and 3 (``g14`` and its undirected ``u14``),
    whose R-MAT ``scales`` the lines print."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_cc
    from repro_torch.core import algorithms as A
    from repro_torch.core import engine
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    ff = engine.frontier_fixpoint
    t0 = time.perf_counter()

    def warm(fns, reps=WARM_REPS):
        """Seconds of ``reps`` further calls of each ``fns[backend]``, the
        backends' order alternating from call to call."""
        order, out = list(fns), {be: [] for be in fns}
        for i in range(reps):
            for be in (order if i % 2 == 0 else order[::-1]):
                out[be].append(timed(fns[be])[1])
        return out

    def frontier_vs_xla(name, fn, rec):
        """``fn(backend)`` on "frontier" and "xla": equal bits, the first
        call's rounds, each backend's first and warm seconds."""
        r0, d0 = frontier_rounds()
        got, t_f = timed(lambda: fn("frontier"))
        r1, d1 = frontier_rounds()
        rounds, dense = r1 - r0, d1 - d0
        want, t_x = timed(lambda: fn("xla"))
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"{name}: frontier != xla")
        check(rounds > 0, f"{name}: no frontier round ran")
        w = warm({be: (lambda b=be: fn(b)) for be in ("frontier", "xla")})
        rec[name] = {"seconds_first_frontier": t_f, "seconds_first_xla": t_x,
                     "seconds_frontier": w["frontier"],
                     "seconds_xla": w["xla"], "rounds": rounds,
                     "dense_rounds": dense}
        return got

    def float_vs_xla(name, fn, backend, rec):
        """``fn(backend)`` within ``TOL`` of ``fn("xla")``; returns the K1/K2
        launches of that one checked call, then times both warm."""
        want, t_x = timed(lambda: fn("xla"))
        before = [k.launches for k in kernels]
        got, t_b = timed(lambda: fn(backend))
        used = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
        err, scale = max_abs(got, want), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"{name} {backend}: finite, shaped as xla")
        check(err <= TOL * scale, f"{name} {backend} vs xla: max|d| {err} > "
              f"{TOL} * {scale}")
        w = warm({be: (lambda b=be: fn(b)) for be in (backend, "xla")})
        rec.setdefault(name, {})[backend] = {
            "seconds_first": t_b, "seconds_first_xla": t_x,
            "seconds": w[backend], "seconds_xla": w["xla"],
            "max_abs_diff": err, "launches": used}
        return used

    kernels = (bsr_spmv, segment_sum_chunked)
    for k in kernels:
        k.launches = 0

    # -- scale 22: the frontier against "xla"; K2 under two more analytics
    plan = g22.plan()
    n = g22.n_nodes
    src = int(torch.argmax(plan.out_deg))
    check(engine.select_backend(plan, None, op="bfs") == "frontier",
          "bfs at scale 22 does not auto-route to frontier")
    _, t_exec = timed(lambda: engine.get_exec(plan, "frontier"))
    r22 = {}
    lv = frontier_vs_xla("bfs", lambda be: A.bfs(
        g22, src, backend=None if be == "frontier" else be), r22)
    ptr = g22.out_ptr[: n + 1].cpu().numpy().astype(np.int64)
    idx = g22.out_idx[: g22.n_edges].cpu().numpy()
    want_lv, t_np = timed(lambda: np_bfs_levels(ptr, idx, n, src))
    check(np.array_equal(lv.cpu().numpy(), want_lv),
          "bfs at scale 22 vs the numpy level-synchronous BFS")
    r22["bfs"].update(seconds_numpy=t_np, reached=int((want_lv >= 0).sum()),
                      depth=int(want_lv.max()))
    # one host read per round: the fixpoint alone under the sync monitor
    init = torch.full((n,), float("inf"), device=dev)
    init[src] = 0.0
    seed = torch.zeros((n,), dtype=torch.bool, device=dev)
    seed[src] = True
    hop = torch.ones((), device=dev)
    r0 = frontier_rounds()[0]
    _, syncs = count_syncs(lambda: ff(plan, init, seed, weights=hop))
    rounds = frontier_rounds()[0] - r0
    check(sum(syncs.values()) == rounds + 1, f"frontier_fixpoint: host "
          f"syncs {syncs} in {rounds} rounds, not one a round plus the read "
          f"that ends it")
    _, entry_syncs = count_syncs(lambda: A.bfs(g22, src))
    r22["bfs"].update(fixpoint_syncs=syncs, fixpoint_rounds=rounds,
                      entry_syncs=entry_syncs)
    w = torch.from_numpy(np.random.default_rng(7).uniform(
        0.5, 4.0, g22.n_edges).astype(np.float32)).to(dev)
    frontier_vs_xla("sssp_weighted",
                    lambda be: A.sssp(g22, src, w, backend=be), r22)
    def undirected_execs():
        uplan = g22.plan().undirected().plan()
        for be in ("frontier", "xla"):
            engine.get_exec(uplan, be)
        return uplan
    u22, t_u22 = timed(undirected_execs)
    frontier_vs_xla("connected_components",
                    lambda be: A.connected_components(g22, backend=be), r22)
    frontier_vs_xla("label_propagation_n20", lambda be: A.label_propagation(
        g22, n_iter=20, backend=be), r22)
    srcs = torch.tensor([src, 0, n // 2, n - 1], device=dev)
    caps = np.asarray([1, 3, 8, 1 << 30])      # the last row runs uncapped
    batched = A.bfs(g22, srcs, n_iter=caps, backend="frontier")
    for i, c in enumerate(caps):
        one = A.bfs(g22, int(srcs[i]), n_iter=None if i == 3 else int(c),
                    backend="frontier")
        check(torch.equal(batched[i], one), f"batched bfs row {i} != its "
              f"standalone run")

    srcs4 = torch.tensor([src, 1, n // 3, n - 2], device=dev)
    f22 = {}
    k2_eig = float_vs_xla("eigenvector_n50", lambda be: A.eigenvector_centrality(
        g22, n_iter=50, backend=be), "pallas", f22)["segment_sum_chunked"]
    k2_ppr = float_vs_xla("ppr_4x10", lambda be: A.personalized_pagerank(
        g22, srcs4, n_iter=10, backend=be), "pallas", f22)["segment_sum_chunked"]
    check((k2_eig, k2_ppr) == (50, 4 * 10), f"K2 launched {k2_eig} times "
          f"for 50 eigenvector rounds and {k2_ppr} for 4 x 10 PPR rounds")
    emit({"phase": "traversal_scale", "scale": scales[0], "nodes": n,
          "edges": g22.n_edges, "undirected_edges": u22.n_edges,
          "source": src, "seconds_frontier_exec": t_exec,
          "seconds_undirected": t_u22, "frontier": r22, "analytics": f22,
          "k2_launches": {"eigenvector_n50": k2_eig, "ppr_4x10": k2_ppr},
          "seconds": time.perf_counter() - t0})

    # -- scale 14: K1 and K2 under eigenvector, PPR, k-core, core numbers
    n14 = g14.n_nodes
    srcs14 = torch.tensor([0, 1, n14 // 2, n14 - 1], device=dev)
    us, ud = (t.cpu().numpy() for t in u14.out_edges())
    un = u14.n_nodes
    core_np, core_rounds = np_core_numbers(
        us, ud, un, int(u14.plan().out_deg.max()))
    alive8, kcore_rounds = np_peel(us, ud, un, 8)
    f14 = {}
    for k in kernels:
        k.launches = 0
    for be, kname in (("bsr", "bsr_spmv"), ("pallas", "segment_sum_chunked")):
        used = (float_vs_xla("eigenvector_n50", lambda b: A.eigenvector_centrality(
            g14, n_iter=50, backend=b), be, f14)[kname],
            float_vs_xla("ppr_4x10", lambda b: A.personalized_pagerank(
                g14, srcs14, n_iter=10, backend=b), be, f14)[kname])
        check(used == (50, 4 * 10), f"{kname} launched {used} times for 50 "
              f"eigenvector and 4 x 10 PPR rounds at scale 14")
        for name, fn in (("k_core_8", lambda b: A.k_core(g14, 8, backend=b)),
                         ("core_numbers",
                          lambda b: A.core_numbers(g14, backend=b))):
            want, t_x = timed(lambda: fn("xla"))
            got, t_b = timed(lambda: fn(be))
            check(torch.equal(got, want), f"{name} {be} != xla")
            f14.setdefault(name, {"seconds_xla": t_x})[f"seconds_{be}"] = t_b
    launches = {k.__name__: k.launches for k in kernels}
    # each float_vs_xla call: one checked call and WARM_REPS timed ones
    want_launches = (1 + WARM_REPS) * (50 + 4 * 10) + kcore_rounds + core_rounds
    check(launches == {"bsr_spmv": want_launches,
                       "segment_sum_chunked": want_launches},
          f"K1/K2 launches {launches} at scale 14, not {1 + WARM_REPS} x "
          f"(50 + 40) + "
          f"{kcore_rounds} k-core + {core_rounds} core-number rounds")
    # the port's mask and core numbers against the numpy peel, mapped back
    # from the undirected view by original id
    pos = u14.dense_of(g14.node_ids[:n14]).long().clamp(0, un - 1)
    present = (u14.node_ids[pos] == g14.node_ids[:n14]).cpu().numpy()
    pos = pos.cpu().numpy()
    check(np.array_equal(A.k_core(g14, 8).cpu().numpy(),
                         present & alive8[pos]), "k_core(8) vs numpy peel")
    check(np.array_equal(A.core_numbers(g14).cpu().numpy(),
                         np.where(present, core_np[pos], 0)),
          "core_numbers vs numpy peel")

    s, d = (t.cpu().numpy() for t in g14.out_edges())
    _, comp = sp_cc(sp.coo_matrix((np.ones(len(s)), (s, d)),
                                  shape=(n14, n14)),
                    directed=True, connection="strong")
    max_id = np.full(comp.max() + 1, -1)
    np.maximum.at(max_id, comp, np.arange(n14))
    scc = {}
    for be in ("xla", "bsr"):
        lab, scc[f"seconds_{be}"] = timed(
            lambda: A.strongly_connected_components(g14, backend=be))
        check(np.array_equal(lab.cpu().numpy(), max_id[comp]),
              f"scc {be} vs scipy")
    scc["components"] = int(comp.max() + 1)
    tri, t_tri = timed(lambda: A.per_node_triangles(u14))
    check(int(tri.sum()) == 3 * A.triangle_count(u14),
          "per-node triangles do not sum to 3 x triangle_count")
    c14 = {}
    frontier_vs_xla("closeness_16", lambda be: A.closeness_centrality(
        g14, n_samples=16, backend=be), c14)
    emit({"phase": "traversal_bsr", "scale": scales[1], "nodes": n14,
          "analytics": f14, "launches": launches,
          "k_core_8_rounds": kcore_rounds, "core_number_rounds": core_rounds,
          "max_core": int(core_np.max()), "scc": scc,
          "seconds_per_node_triangles": t_tri, "frontier": c14,
          "seconds": time.perf_counter() - t0})


SO_USERS = 12_000   # the user graph stays under the "bsr" ceiling of 2^14 nodes
SO_POSTS = 4_000_000


def tracked_syncs(g):
    """Host syncs of one tracked ``pagerank`` and of one untracked call (the
    function under ``@track``), on "xla" so that no kernel launch enters
    the window."""
    from repro_torch.core import algorithms as A
    _, tracked = count_syncs(lambda: A.pagerank(g, n_iter=10, backend="xla"))
    _, plain = count_syncs(lambda: A.pagerank.__wrapped__(g, n_iter=10,
                                                           backend="xla"))
    check(sum(tracked.values()) == sum(plain.values()),
          f"tracked pagerank syncs {tracked}, untracked {plain}")
    return {"tracked": tracked, "untracked": plain}


def check_ranked(ranked, g, pr, what):
    """``table_from_map``'s table against numpy's stable argsort of -pr."""
    pr_np = pr.cpu().numpy()
    order = np.argsort(-pr_np, kind="stable")
    cols = ranked.schema.names
    check(ranked.n_valid == g.n_nodes and np.array_equal(
        ranked.column_np(cols[0]), g.node_ids[:g.n_nodes].cpu().numpy()[order])
        and np.array_equal(ranked.column_np(cols[1]), pr_np[order]),
        f"{what}: table_from_map vs numpy's stable argsort of -pr")
    return pr_np, order


def check_replay(ranked, root_table, counter, want_launches, what):
    """``replay`` of ``ranked``'s chain against its root: bit-identical, with
    ``want_launches`` launches of ``counter``; the exported script compiles."""
    from repro_torch.core import provenance as P
    recs = P.records_of(ranked)
    (root,) = P.roots_of(recs)
    check(root == root_table.version, f"{what}: chain root is not the table")
    script = P.export_script(ranked, embed_roots=False)
    compile(script, "<export_script>", "exec")
    check("jax" not in script, f"{what}: exported script names jax")
    before = counter.launches
    again, t_replay = timed(lambda: P.replay(recs, {root: root_table}))
    launches = counter.launches - before
    check(launches == want_launches, f"{what}: replay launched "
          f"{counter.__name__} {launches} times, not {want_launches}")
    check(all(torch.equal(again.columns[c], ranked.columns[c])
              for c in ranked.schema.names)
          and torch.equal(again.row_ids, ranked.row_ids),
          f"{what}: replay is not bit-identical")
    return {"ops": [r.op for r in recs], "script_lines": script.count("\n"),
            "seconds_replay": t_replay, "replay_launches": launches}


def phase_tables_edges(dev, edges):
    """Phase 3c (a): the R-MAT scale-22 edge list as a 67,108,864-row table
    (self loops and duplicates as generated) -> select -> to_graph ->
    "pallas" PageRank (K2) -> table_from_map, plus group_by, join, the
    graph's edge table in order, export and replay; every step against
    numpy."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import relational as R
    from repro_torch.core.convert import (graph_to_edge_table,
                                          table_from_map, to_graph)
    from repro_torch.core.graph import Graph
    from repro_torch.core.table import INT, Table, next_capacity
    from repro_torch.kernels.segment_sum import segment_sum_chunked as k2
    t0 = time.perf_counter()
    src, dst = edges
    n = int(src.shape[0])
    weight = np.random.default_rng(7).integers(1, 10, n, dtype=np.int32)
    secs = {}

    def step(name, fn):
        out, secs[name] = timed(fn)
        return out

    t = step("from_columns", lambda: Table.from_columns(
        {"src": INT, "dst": INT, "weight": INT},
        {"src": src, "dst": dst, "weight": weight}, device=dev))
    check(t.n_valid == n and t.capacity == next_capacity(n) == 1 << 26,
          f"edge table: {t.n_valid} rows, capacity {t.capacity}")
    strong = step("select", lambda: R.select(t, "weight", ">=", 5))
    keep = np.flatnonzero(weight >= 5)
    ss, sd, sw = src[keep], dst[keep], weight[keep]
    check(strong.n_valid == keep.size and strong.capacity == t.capacity
          and np.array_equal(strong.row_ids[:keep.size].cpu().numpy(), keep)
          and np.array_equal(strong.column_np("dst"), sd),
          "select weight >= 5 vs numpy")

    g = step("to_graph", lambda: to_graph(strong, "src", "dst",
                                          drop_self_loops=True))
    ref = Graph.from_edges(ss, sd, drop_self_loops=True, device=dev)
    check(g.n_nodes == ref.n_nodes and g.n_edges == ref.n_edges and
          all(torch.equal(a, b) for a, b in zip(g.out_edges(), ref.out_edges()))
          and torch.equal(g.node_ids, ref.node_ids),
          "to_graph vs Graph.from_edges of the numpy-selected edges")
    del ref

    before = k2.launches
    pr = step("pagerank_pallas", lambda: A.pagerank(g, n_iter=10,
                                                    backend="pallas"))
    k2_pr = k2.launches - before
    want = step("pagerank_xla", lambda: A.pagerank(g, n_iter=10,
                                                   backend="xla"))
    err, scale = max_abs(pr, want), float(want.abs().max())
    check(err <= TOL * scale, f"pagerank pallas vs xla: {err} > {TOL} * {scale}")
    check(k2_pr == 10, f"K2 launched {k2_pr} times in 10 PageRank rounds")
    ranked = step("table_from_map", lambda: table_from_map(
        g, pr, "node", "pagerank"))
    pr_np, order = check_ranked(ranked, g, pr, "edges")

    aggs = {"deg": ("dst", "count"), "w": ("weight", "sum"),
            "wm": ("weight", "mean")}
    gb = step("group_by", lambda: R.group_by(strong, "src", aggs))
    keys = np.unique(ss)
    deg = np.bincount(ss, minlength=1 << 22)
    w = np.bincount(ss, weights=sw, minlength=1 << 22)
    wm_err = float(np.abs(gb.column_np("wm").astype(np.float64)
                          - w[keys] / deg[keys]).max())
    check(gb.n_valid == keys.size
          and np.array_equal(gb.column_np("src"), keys)
          and np.array_equal(gb.column_np("deg"), deg[keys])
          and np.array_equal(gb.column_np("w"), w[keys].astype(np.int64))
          and wm_err <= 1e-6, f"group_by vs numpy (mean max|d| {wm_err})")
    gb2 = step("group_by_again", lambda: R.group_by(strong, "src", aggs))
    check(all(torch.equal(gb.columns[c], gb2.columns[c]) for c in aggs)
          and torch.equal(gb.columns["src"], gb2.columns["src"]),
          "group_by twice: not the same bits")

    n_top = min(1000, ranked.n_valid)
    top = ranked.gathered(torch.arange(n_top, device=dev), n_top)
    j = step("join", lambda: R.join(top, strong, "node", "src"))
    top_nodes, top_pr = ranked.column_np("node")[:n_top], pr_np[order][:n_top]
    hit = np.isin(ss, top_nodes)
    by = np.argsort(top_nodes)
    score = top_pr[by][np.searchsorted(top_nodes[by], ss[hit])]
    want_rows = (ss[hit], score, ss[hit], sd[hit], sw[hit])
    got_rows = tuple(j.column_np(c) for c in j.schema.names)
    check(j.n_valid == int(deg[top_nodes].sum()) == int(hit.sum()),
          f"join: {j.n_valid} rows, not the top nodes' degree sum")
    ow, og = np.lexsort(want_rows[::-1]), np.lexsort(got_rows[::-1])
    check(j.schema.names == ("node", "pagerank", "src", "dst", "weight") and
          all(np.array_equal(a[og], b[ow]) for a, b in zip(got_rows, want_rows)),
          "join rows vs numpy as sorted multisets")

    e = step("graph_to_edge_table", lambda: graph_to_edge_table(g))
    o = step("order", lambda: R.order(e, ["src", "dst"]))
    es, ed = e.column_np("src"), e.column_np("dst")
    perm = np.lexsort((ed, es))
    check(e.n_valid == g.n_edges and np.array_equal(o.column_np("src"), es[perm])
          and np.array_equal(o.column_np("dst"), ed[perm])
          and np.array_equal(o.row_ids[:e.n_valid].cpu().numpy(), perm),
          "graph_to_edge_table + order vs np.lexsort")

    rec = check_replay(ranked, t, k2, 10, "edges")
    check(rec["ops"] == ["relational.select", "convert.to_graph",
                         "algorithms.pagerank", "convert.table_from_map"],
          f"ranked's chain is {rec['ops']}")
    emit({"phase": "tables_edges", "rows": n, "capacity": t.capacity,
          "selected": strong.n_valid, "nodes": g.n_nodes, "edges": g.n_edges,
          "groups": gb.n_valid, "join_rows": j.n_valid,
          "join_capacity": j.capacity, "table_bytes": t.nbytes(),
          "seconds_per_op": secs, "k2_launches_pagerank": k2_pr,
          "pagerank_max_abs_diff": err, "pagerank_max_abs_xla": scale,
          "group_by_mean_max_abs_err": wm_err, **rec,
          "syncs": tracked_syncs(g), "seconds": time.perf_counter() - t0})


def synthetic_posts(n_posts, n_users, seed=0):
    """numpy columns of a StackOverflow-shaped posts table (the shape of
    ``examples/stackoverflow_experts.py:synthetic_stackoverflow``, made in
    bulk): questions tagged Java/Python/C++ (p = .5/.3/.2) by uniform
    askers, 60% with an accepted answer right after them, 70% of the
    answers by one of 12 experts; cut to ``n_posts`` rows."""
    rng = np.random.default_rng(seed)
    experts = rng.choice(n_users, 12, replace=False)
    nq = int(n_posts / 1.6 * 1.01) + 16
    tag = rng.choice(3, nq, p=[0.5, 0.3, 0.2])
    asker = rng.integers(0, n_users, nq)
    answered = rng.random(nq) < 0.6
    answerer = np.where(rng.random(nq) < 0.7,
                        experts[rng.integers(0, 12, nq)],
                        rng.integers(0, n_users, nq))
    per_q = 1 + answered
    q_pid = np.cumsum(per_q) - per_q
    total = int(q_pid[-1] + per_q[-1])
    check(total >= n_posts, f"{total} posts made, {n_posts} asked for")
    a_pid = q_pid[answered] + 1
    is_q = np.zeros(total, bool)
    is_q[q_pid] = True
    user = np.empty(total, np.int64)
    user[q_pid], user[a_pid] = asker, answerer[answered]
    answer_id = np.full(total, -1, np.int64)
    answer_id[q_pid[answered]] = a_pid
    cut = slice(0, n_posts)
    return {"post_id": np.arange(n_posts), "is_q": is_q[cut],
            "tag": np.repeat(tag, per_q)[cut], "user": user[cut],
            "answer_id": answer_id[cut]}


def phase_tables_stackoverflow(dev, n_posts=SO_POSTS, n_users=SO_USERS):
    """Phase 3c (b): the paper's §4.1 pipeline on a synthetic posts table
    (select Tag=Java, Type=question / answer, join AnswerId = PostId,
    to_graph on the two users, "bsr" PageRank (K1), "bsr" triangles of the
    undirected user graph (K3), table_from_map, export and replay)."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import relational as R
    from repro_torch.core.convert import table_from_map, to_graph
    from repro_torch.core.table import INT, STR, Table
    from repro_torch.kernels.bsr_spmv import bsr_spmv as k1
    from repro_torch.kernels.bsr_tricount import bsr_tricount as k3
    t0 = time.perf_counter()
    cols, t_gen = timed(lambda: synthetic_posts(n_posts, n_users))
    tags, types = ("Java", "Python", "C++"), ("answer", "question")
    secs = {"synthetic_posts": t_gen}

    def step(name, fn):
        out, secs[name] = timed(fn)
        return out

    posts = step("from_columns", lambda: Table.from_columns(
        {"post_id": INT, "type": STR, "tag": STR, "user": INT,
         "answer_id": INT},
        {"post_id": cols["post_id"],
         "type": [types[q] for q in cols["is_q"].tolist()],
         "tag": [tags[c] for c in cols["tag"].tolist()],
         "user": cols["user"], "answer_id": cols["answer_id"]}, device=dev))
    java = cols["tag"] == 0
    jp = step("select_java", lambda: R.select(posts, "tag", "==", "Java"))
    q = step("select_question", lambda: R.select(jp, "type", "==", "question"))
    a = step("select_answer", lambda: R.select(jp, "type", "==", "answer"))
    jq, ja = java & cols["is_q"], java & ~cols["is_q"]
    for tab, mask, what in ((jp, java, "Tag=Java"), (q, jq, "Type=question"),
                            (a, ja, "Type=answer")):
        check(tab.n_valid == int(mask.sum()) and np.array_equal(
            tab.row_ids[:tab.n_valid].cpu().numpy(), np.flatnonzero(mask)),
            f"select {what} vs numpy")
    qa = step("join", lambda: R.join(q, a, "answer_id", "post_id"))
    pairs = jq & np.isin(cols["answer_id"], cols["post_id"][ja])
    asker = cols["user"][pairs]
    answerer = cols["user"][cols["answer_id"][pairs]]
    check(qa.n_valid == int(pairs.sum()) and np.array_equal(
        np.sort(qa.column_np("user_1") * n_users + qa.column_np("user_2")),
        np.sort(asker * n_users + answerer)), "join AnswerId = PostId vs numpy")
    G = step("to_graph", lambda: to_graph(qa, "user_1", "user_2"))
    key = np.unique(asker * n_users + answerer)
    s, d = (G.original_of(x).cpu().numpy() for x in G.out_edges())
    check(G.n_nodes <= 1 << 14 and np.array_equal(
        s.astype(np.int64) * n_users + d, key), "user graph vs numpy")

    before = k1.launches
    pr = step("pagerank_bsr", lambda: A.pagerank(G, n_iter=10, backend="bsr"))
    k1_pr = k1.launches - before
    want = step("pagerank_xla", lambda: A.pagerank(G, n_iter=10, backend="xla"))
    err, scale = max_abs(pr, want), float(want.abs().max())
    check(err <= TOL * scale, f"pagerank bsr vs xla: {err} > {TOL} * {scale}")
    check(k1_pr == 10, f"K1 launched {k1_pr} times in 10 PageRank rounds")
    U = step("to_undirected", lambda: G.to_undirected())
    before = k3.launches
    tri = step("triangles_bsr", lambda: A.triangle_count(U, backend="bsr"))
    k3_tri = k3.launches - before
    tri_x = step("triangles_xla", lambda: A.triangle_count(U))
    check(tri == tri_x and k3_tri == 1, f"triangles bsr {tri} vs xla {tri_x} "
          f"with {k3_tri} K3 launches")
    S = step("table_from_map", lambda: table_from_map(G, pr, "user", "score"))
    check_ranked(S, G, pr, "stackoverflow")
    rec = check_replay(S, posts, k1, 10, "stackoverflow")
    check(rec["ops"] == ["relational.select"] * 3 + [
        "relational.join", "convert.to_graph", "algorithms.pagerank",
        "convert.table_from_map"], f"S's chain is {rec['ops']}")
    emit({"phase": "tables_stackoverflow", "rows": posts.n_valid,
          "capacity": posts.capacity, "users": n_users,
          "java": jp.n_valid, "questions": q.n_valid, "answers": a.n_valid,
          "join_rows": qa.n_valid, "nodes": G.n_nodes, "edges": G.n_edges,
          "undirected_edges": U.n_edges, "triangles": tri,
          "seconds_per_op": secs, "k1_launches_pagerank": k1_pr,
          "k3_launches": k3_tri, "pagerank_max_abs_diff": err,
          "pagerank_max_abs_xla": scale, **rec, "syncs": tracked_syncs(G),
          "seconds": time.perf_counter() - t0})


def phase_tables(dev, edges, n_posts=SO_POSTS):
    """Phase 3c: the table front end and provenance, in a launch window of
    its own: K2 10 + 10 (part (a): PageRank and its replay), K1 10 + 10 and
    K3 1 (part (b))."""
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount)
    for k in kernels:
        k.launches = 0
    phase_tables_edges(dev, edges)
    phase_tables_stackoverflow(dev, n_posts)
    launches = {k.__name__: k.launches for k in kernels}
    check(launches == {"bsr_spmv": 20, "segment_sum_chunked": 20,
                       "bsr_tricount": 1},
          f"phase 3c launches {launches}")
    emit({"phase": "tables", "launches": launches})


DELTA_FRAC = 0.001    # phase 3d: the reference's bench_engine.py delta size
N_DELETES = 1_000     # phase 3d: deletes of the mixed delta at scale 22


def count_rounds(fn):
    """``fn()`` and the PageRank rounds it ran (calls of the round body)."""
    from repro_torch.core import algorithms as A
    body, n = A._pagerank_body, [0]

    def counted(*a):
        n[0] += 1
        return body(*a)

    A._pagerank_body = counted
    try:
        out = fn()
    finally:
        A._pagerank_body = body
    return out, n[0]


def no_edge_rederive(fn):
    """``fn()`` with ``Graph.in_edges`` / ``out_edges`` made to fail: a
    patched plan must not re-derive its edge arrays."""
    from repro_torch.core.graph import Graph

    def boom(*a, **k):
        raise RuntimeError("the patched plan re-derived its edges")

    saved = Graph.in_edges, Graph.out_edges
    Graph.in_edges = Graph.out_edges = boom
    try:
        return fn()
    finally:
        Graph.in_edges, Graph.out_edges = saved


def same_graph(a, b) -> bool:
    return (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges) and all(
        torch.equal(x, y) for x, y in zip(
            (a.node_ids, a.out_ptr, a.out_idx, a.in_ptr, a.in_idx),
            (b.node_ids, b.out_ptr, b.out_idx, b.in_ptr, b.in_idx)))


def family_tensors(plan):
    """Warm the undirected, csr, perm and chunks (pull layout) families of
    ``plan``; clones of their tensors, for the bit-identity check after
    eviction (the clones keep no family alive)."""
    u = plan.undirected()
    return {"undirected": [t.clone() for t in (
                u.node_ids, u.out_ptr, u.out_idx, u.in_ptr, u.in_idx)],
            "csr": [t.clone() for t in (*plan.csr_out(), *plan.csr_in())],
            "perm": [plan.in_perm_out().clone()],
            "chunks": [t.clone() for t in plan.chunk_layout_in()[:4]]}


def evict_measured(plan):
    """``plan.evict_all()`` and the drop in ``memory_allocated`` it causes
    (after ``gc.collect()``): (bytes reported, bytes the card freed)."""
    import gc
    gc.collect()
    sync()
    before = torch.cuda.memory_allocated()
    freed = plan.evict_all()
    gc.collect()
    sync()
    return freed, before - torch.cuda.memory_allocated()


def insert_delta_arrays(g):
    """The 0.1% insert-only delta of phase 3d (numpy seed 7): original-id
    ``(src, dst)`` pairs drawn from ``g``'s nodes, and the generator after
    drawing them."""
    n = g.n_nodes
    ids = g.node_ids[:n].cpu().numpy()
    rng = np.random.default_rng(7)
    k = max(1, int(g.n_edges * DELTA_FRAC))
    add_s = ids[rng.integers(0, n, k)].astype(np.int32)
    add_d = ids[rng.integers(0, n, k)].astype(np.int32)
    return add_s, add_d, rng


def phase_incremental_scale22(dev, g22):
    """Phase 3d (a): the reference's 0.1% insert delta on the scale-22 graph:
    ``apply_delta`` and the patched plan against a cold build, warm PageRank
    ("xla", then one "pallas" refresh: K2), warm BFS / SSSP / CC, a mixed
    delta that every helper declines, and the plan's byte accounting."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import engine
    from repro_torch.core.graph import EdgeDelta, Graph
    from repro_torch.kernels.segment_sum import segment_sum_chunked as k2
    t0 = time.perf_counter()
    n, e = g22.n_nodes, g22.n_edges
    parent = g22.plan()
    add_s, add_d, rng = insert_delta_arrays(g22)
    k = int(add_s.size)
    delta = EdgeDelta.inserts(add_s, add_d)
    secs = {}

    child, secs["apply_delta"] = timed(lambda: g22.apply_delta(delta))
    check(child._delta is not None and child._delta.insert_only,
          "apply_delta at scale 22 took the rebuild path")
    cplan, secs["patch"] = timed(lambda: no_edge_rederive(child.plan))
    check(cplan._parent is parent, "child.plan()._parent is not g22.plan()")
    # host syncs, on a second child of the same delta
    twin, syncs_apply = count_syncs(lambda: g22.apply_delta(delta))
    _, syncs_patch = count_syncs(twin.plan)
    del twin
    cs, cd = child.out_edges()
    cold, secs["cold_build_and_plan"] = timed(lambda: Graph.from_dense_edges(
        cs, cd, n, node_ids=g22.node_ids[:n], device=dev).plan())
    check(same_graph(child, cold.graph),
          "child CSR != from_dense_edges of the child's edges")
    check(all(torch.equal(getattr(cplan, f), getattr(cold, f)) for f in (
        "in_src", "in_dst", "out_src", "out_dst", "out_deg", "in_deg",
        "inv_out_deg", "dangling")), "patched plan != cold plan")
    del cold, cs, cd
    added = child.n_edges - e

    # warm PageRank against cold, on "xla"
    pr = {}
    parent_pr, pr["rounds_parent"] = count_rounds(
        lambda: A.pagerank(g22, tol=1e-6, backend="xla"))
    (warm, pr["rounds_warm"]), pr["seconds_warm"] = timed(lambda: count_rounds(
        lambda: A.pagerank(child, tol=1e-6, init=parent_pr, backend="xla")))
    (cold_pr, pr["rounds_cold"]), pr["seconds_cold"] = timed(
        lambda: count_rounds(lambda: A.pagerank(child, tol=1e-6,
                                                backend="xla")))
    pr["max_abs_warm_vs_cold"] = max_abs(warm, cold_pr)
    check(pr["max_abs_warm_vs_cold"] <= 1e-5, f"warm pagerank vs cold: "
          f"{pr['max_abs_warm_vs_cold']} > 1e-5")
    # one warm "pallas" refresh: K2, after the child's cold chunk layout
    _, pr["seconds_pallas_layout"] = timed(
        lambda: engine.get_exec(cplan, "pallas"))
    before = k2.launches
    (warm_p, pr["rounds_pallas"]), pr["seconds_pallas"] = timed(
        lambda: count_rounds(lambda: A.pagerank(
            child, tol=1e-6, init=parent_pr, backend="pallas")))
    pr["k2_launches"] = k2.launches - before
    pr["max_abs_pallas_vs_cold"] = max_abs(warm_p, cold_pr)
    check(pr["k2_launches"] == pr["rounds_pallas"] > 0,
          f"K2 launched {pr['k2_launches']} times in "
          f"{pr['rounds_pallas']} rounds")
    check(pr["max_abs_pallas_vs_cold"] <= 1e-5, f"warm pallas pagerank vs "
          f"cold: {pr['max_abs_pallas_vs_cold']} > 1e-5")
    del warm, warm_p, cold_pr

    # warm traversals from phase 3b's source, against cold; the patched
    # undirected view and the frontier Execs are built (and timed) first
    src = int(torch.argmax(parent.out_deg))
    _, secs["undirected_patch"] = timed(cplan.undirected)
    _, secs["cold_to_undirected"] = timed(child.to_undirected)
    _, secs["frontier_execs"] = timed(lambda: [engine.get_exec(
        p, "frontier") for p in (cplan, cplan.undirected().plan())])
    trav = {}
    parents = {"bfs": A.bfs(g22, src), "sssp": A.sssp(g22, src),
               "cc": A.connected_components(g22)}
    runs = {
        "bfs": (lambda: A.incremental_bfs(child, src, parents["bfs"]),
                lambda: A.bfs(child, src)),
        "sssp": (lambda: A.incremental_sssp(child, src, parents["sssp"]),
                 lambda: A.sssp(child, src)),
        "cc": (lambda: A.incremental_connected_components(child,
                                                          parents["cc"]),
               lambda: A.connected_components(child, backend="frontier")),
    }
    for name, (warm_fn, cold_fn) in runs.items():
        r0 = frontier_rounds()[0]
        got, t_warm = timed(warm_fn)
        r1 = frontier_rounds()[0]
        want, t_cold = timed(cold_fn)
        check(got is not None, f"incremental {name} declined an insert-only "
              f"delta")
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"incremental {name} != cold")
        trav[name] = {"rounds_warm": r1 - r0,
                      "rounds_cold": frontier_rounds()[0] - r1,
                      "seconds_warm": t_warm, "seconds_cold": t_cold}
    check(torch.equal(A.connected_components(child, backend="xla"),
                      A.connected_components(child, backend="frontier")),
          "cold cc: xla != frontier")
    check(child.plan().undirected()._delta is not None,
          "the child's undirected view was rebuilt, not patched")

    # a mixed delta: every helper declines, the cold path stays exact
    es, ed = g22.out_edges()
    pick = torch.from_numpy(rng.integers(0, e, N_DELETES)).to(dev)
    mixed = g22.apply_delta(EdgeDelta(add_s, add_d,
                                      g22.original_of(es[pick]),
                                      g22.original_of(ed[pick])))
    del es, ed
    check(mixed._delta is not None and not mixed._delta.insert_only,
          "the mixed delta did not delete")
    declined = {
        "bfs": A.incremental_bfs(mixed, src, parents["bfs"]),
        "sssp": A.incremental_sssp(mixed, src, parents["sssp"]),
        "cc": A.incremental_connected_components(mixed, parents["cc"]),
        "lp": A.incremental_label_propagation(mixed, parents["cc"],
                                              n_iter=n)}
    check(all(v is None for v in declined.values()),
          f"a helper warmed through deletions: "
          f"{[k for k, v in declined.items() if v is not None]}")
    fresh = Graph.from_dense_edges(*mixed.out_edges(), n,
                                   node_ids=g22.node_ids[:n], device=dev)
    check(torch.equal(A.bfs(mixed, src), A.bfs(fresh, src)) and torch.equal(
        A.connected_components(mixed), A.connected_components(fresh)),
        "mixed delta: cold bfs / cc != a lineage-free rebuild")
    mixed_edges = mixed.n_edges
    del mixed, fresh, child, cplan, parents

    # byte accounting and eviction on the parent's plan
    acc = {"as_left": parent.nbytes_by_family()}
    acc["evict_all_reported"], acc["evict_all_allocated_drop"] = \
        evict_measured(parent)
    acc["cold"] = parent.nbytes_by_family()
    snap, acc["seconds_rederive"] = timed(lambda: family_tensors(parent))
    acc["warm"] = parent.nbytes_by_family()
    acc["warm_evictable"] = parent.evictable_bytes()
    acc["evict_warm_reported"], acc["evict_warm_allocated_drop"] = \
        evict_measured(parent)
    for what in ("evict_all", "evict_warm"):
        rep, drop = acc[f"{what}_reported"], acc[f"{what}_allocated_drop"]
        check(rep > 0 and abs(rep - drop) <= 0.05 * rep,
              f"{what}: reported {rep} bytes freed, memory_allocated "
              f"dropped {drop}")
    again = family_tensors(parent)
    for fam, tensors in snap.items():
        check(all(torch.equal(a, b) for a, b in zip(tensors, again[fam])),
              f"family {fam} did not re-derive bit for bit")
    del snap, again
    launches = {"segment_sum_chunked": pr["k2_launches"]}
    emit({"phase": "incremental_scale", "scale": 22, "nodes": n,
          "edges": e, "delta_inserts": k, "edges_added": added,
          "mixed_deletes": N_DELETES, "mixed_edges": mixed_edges,
          "seconds_per_step": secs,
          "patch_speedup": secs["cold_build_and_plan"]
          / (secs["apply_delta"] + secs["patch"]),
          "syncs_apply_delta": syncs_apply, "syncs_patch": syncs_patch,
          "pagerank": pr, "traversals": trav, "bytes": acc,
          "seconds": time.perf_counter() - t0})
    return launches


def in_tile_inserts(g, k, seed=7):
    """``k`` original-id inserts of absent pairs whose tiles both BSR
    layouts of ``g`` already hold (numpy seed ``seed``)."""
    s, d = (t.cpu().numpy().astype(np.int64) for t in g.out_edges())
    have = set((s << 32 | d).tolist())
    _, rows, cols, _ = g.plan().bsr()
    # (dst, src) blocks of M[dst, src]; the transpose layout holds the
    # same pairs the other way round
    pull = set(zip(rows.cpu().numpy().tolist(), cols.cpu().numpy().tolist()))
    rng = np.random.default_rng(seed)
    picks = []
    while len(picks) < k:
        i, j = (int(x) for x in rng.integers(0, g.n_nodes, 2))
        if (j // 128, i // 128) in pull and (i << 32 | j) not in have:
            picks.append((i, j))
            have.add(i << 32 | j)
    ids = g.node_ids.cpu().numpy()
    return ([ids[i] for i, _ in picks], [ids[j] for _, j in picks])


def phase_incremental_bsr(dev, g14):
    """Phase 3d (b): a 0.1% insert delta that lands in existing tiles of the
    scale-14 graph: K1 on the patched tiles (warm "bsr" PageRank), the
    tiles bit-equal to a cold build, K3 on the patched undirected view
    with the parent's triples, and one insert that opens a new tile."""
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import EdgeDelta
    from repro_torch.kernels.bsr_spmv import bsr_spmv as k1
    from repro_torch.kernels.bsr_tricount import bsr_tricount as k3
    from repro_torch.kernels.ops import edges_to_bsr
    t0 = time.perf_counter()
    parent = g14.plan()
    k = max(1, int(g14.n_edges * DELTA_FRAC))
    add_s, add_d = in_tile_inserts(g14, k)
    child = g14.apply_delta(EdgeDelta.inserts(add_s, add_d))
    cplan = child.plan()
    secs = {}
    (tiles, rows, cols, nb), secs["patched_bsr"] = timed(cplan.bsr)
    check(rows is parent.bsr()[1] and cols is parent.bsr()[2],
          "the child's bsr tiles were rebuilt, not patched")
    cplan.bsr_t()
    s, d = (t.cpu().numpy() for t in child.out_edges())
    cold_pull, secs["cold_edges_to_bsr"] = timed(lambda: edges_to_bsr(
        s, d, child.n_nodes, device=dev))
    for got, cold in ((cplan.bsr(), cold_pull),
                      (cplan.bsr_t(), edges_to_bsr(d, s, child.n_nodes,
                                                   device=dev))):
        check(all(torch.equal(a, b) for a, b in zip(got[:3], cold[:3])),
              "patched tiles != a cold edges_to_bsr of the child")
    del cold, cold_pull

    before = k1.launches
    (parent_pr, r_parent), t_parent = timed(lambda: count_rounds(
        lambda: A.pagerank(g14, tol=1e-6, backend="bsr")))
    (warm, r_warm), t_warm = timed(lambda: count_rounds(lambda: A.pagerank(
        child, tol=1e-6, init=parent_pr, backend="bsr")))
    k1_used = k1.launches - before
    cold = A.pagerank(child, tol=1e-6, backend="xla")
    err = max_abs(warm, cold)
    check(err <= 1e-5, f"warm bsr pagerank vs cold xla: {err} > 1e-5")
    check(k1_used == r_parent + r_warm, f"K1 launched {k1_used} times in "
          f"{r_parent} + {r_warm} rounds")

    # K3 on the child's patched undirected view, the parent's triples reused
    uplan = parent.undirected().plan()
    _, secs["parent_triples"] = timed(uplan.tri_triples)
    cu = cplan.undirected()
    check(cu._delta is not None, "the child's undirected view was rebuilt")
    before = k3.launches
    tri, secs["triangles_bsr"] = timed(lambda: A.triangle_count(
        cu, backend="bsr"))
    k3_used = k3.launches - before
    check(cu.plan().tri_triples() is uplan.tri_triples()
          and cu.plan().bsr()[1] is uplan.bsr()[1],
          "the child's undirected tiles or triples were rebuilt")
    tri_x, secs["triangles_xla"] = timed(lambda: A.triangle_count(cu))
    check(tri == tri_x and k3_used == 1, f"triangles bsr {tri} vs xla "
          f"{tri_x} with {k3_used} K3 launches")

    # one insert in a block pair the parent's tiles lack: rebuild
    prow = parent.bsr()[1].cpu().numpy()
    pcol = parent.bsr()[2].cpu().numpy()
    present = set(zip(prow.tolist(), pcol.tolist()))
    missing = [(r, c) for r in range(nb) for c in range(nb)
               if (r, c) not in present]
    check(bool(missing), "every tile is present: no new-tile insert exists")
    rb, cb = missing[0]
    ids = g14.node_ids.cpu().numpy()
    lone = g14.apply_delta(EdgeDelta.inserts([ids[cb * 128]],
                                             [ids[rb * 128]]))
    (ltiles, lrows, _, _), secs["new_tile_rebuild"] = timed(lone.plan().bsr)
    ls, ld = (t.cpu().numpy() for t in lone.out_edges())
    cold_l = edges_to_bsr(ls, ld, lone.n_nodes, device=dev)
    check(lrows is not parent.bsr()[1]
          and ltiles.shape[0] == parent.bsr()[0].shape[0] + 1
          and all(torch.equal(a, b) for a, b in zip(
              (ltiles, lrows), cold_l[:2])),
          "a new-tile insert did not rebuild to the cold tiles")
    fams = cplan.nbytes_by_family()
    emit({"phase": "incremental_bsr", "scale": 14, "nodes": g14.n_nodes,
          "edges": g14.n_edges, "delta_inserts": k,
          "tiles": int(tiles.shape[0]), "new_tile": [rb, cb],
          "pagerank": {"rounds_parent": r_parent, "rounds_warm": r_warm,
                       "seconds_parent": t_parent, "seconds_warm": t_warm,
                       "max_abs_warm_vs_cold_xla": err,
                       "k1_launches": k1_used},
          "triangles": tri, "k3_launches": k3_used,
          "child_bytes": fams, "seconds_per_step": secs,
          "seconds": time.perf_counter() - t0})
    return {"bsr_spmv": k1_used, "bsr_tricount": k3_used}


def phase_incremental(dev, g22, g14):
    """Phase 3d: incremental maintenance and plan memory accounting, in a
    launch window of its own: K2 in the warm "pallas" refresh at scale 22,
    K1 in the two "bsr" PageRanks and K3 once at scale 14."""
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount)
    for k in kernels:
        k.launches = 0
    want = {**phase_incremental_scale22(dev, g22),
            **phase_incremental_bsr(dev, g14)}
    launches = {k.__name__: k.launches for k in kernels}
    check(launches == want and all(launches.values()),
          f"phase 3d launches {launches}, its steps counted {want}")
    emit({"phase": "incremental", "launches": launches})
    return launches


SERVICE_BFS = 16   # phase 3e: single-source BFS requests on g22, one session
SERVICE_PPR = 8    # phase 3e: personalized PageRank requests on g14, "bsr"
SERVICE_CLIENTS = 4   # phase 3e (b): RemoteService clients in threads


def host(x) -> np.ndarray:
    """A result as a host array, whichever transport returned it."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def top_sources(g, k, skip=0):
    """The dense ids of ``g``'s vertices ranked ``skip`` .. ``skip + k`` by
    out-degree: distinct, well-connected sources."""
    order = torch.argsort(g.plan().out_deg.long(), descending=True,
                          stable=True)
    return [int(x) for x in order[skip:skip + k].cpu()]


def engine_spans_ms(op, pendings):
    """Durations (ms) of the distinct ``engine.<op>`` spans that served
    ``pendings``, from this process's trace ring (host clock, closed after
    the service's device sync): one per engine call, fused or not."""
    from repro_torch import obs
    spans = {}
    for p in pendings:
        if p.trace is None:
            continue
        for e in obs.export_chrome_trace(trace=p.trace)["traceEvents"]:
            if e.get("ph") == "X" and e["name"] == f"engine.{op}":
                spans[(e["tid"], e["ts"])] = e["dur"] / 1e3
    return sorted(spans.values())


def pending_summary(pendings):
    """Per op: requests, fused, cached, median latency_ms and queued_ms
    (host clock, ``Pending`` / ``RemotePending``), and the engine calls
    that served them with their ms."""
    by_op = {}
    for op, p in pendings:
        by_op.setdefault(op, []).append(p)
    out = {}
    for op, ps in sorted(by_op.items()):
        lat = [p.latency_ms for p in ps if p.latency_ms is not None]
        qd = [p.queued_ms for p in ps if p.queued_ms is not None]
        eng = engine_spans_ms(ps[0].request.get("op", op), ps)
        out[op] = {"requests": len(ps), "engine_calls_ms": eng,
                   "fused": sum(bool(p.fused) for p in ps),
                   "cached": sum(bool(p.cached) for p in ps),
                   "median_latency_ms": statistics.median(lat) if lat
                   else None,
                   "median_queued_ms": statistics.median(qd) if qd
                   else None}
    return out


def sched_summary(snap):
    """``sched.engine_ms`` quantiles and ``sched.batch_size`` of a metrics
    snapshot (host clock; engine ms are taken after a device sync)."""
    from repro_torch.obs import quantile_from_snapshot
    out = {}
    h = snap.get("sched.engine_ms") or {}
    if h.get("count"):
        out["engine_ms"] = {"count": h["count"], "sum": h["sum"], **{
            f"p{int(q * 100)}": quantile_from_snapshot(h, q)
            for q in (0.5, 0.9, 0.99)}}
    b = snap.get("sched.batch_size") or {}
    if b.get("count"):
        out["batch_size"] = {"calls": b["count"], "requests": b["sum"],
                             "max_le": max(le for le, c in zip(
                                 b["buckets"], b["counts"]) if c)
                             if any(b["counts"][:-1]) else None}
    return out


def run_sessions(svc, reqs, timeout=600.0):
    """Each entry of ``reqs`` (session name -> requests) submits from its
    own thread, all starting together; returns [(session, op, Pending)] in
    submission order per session, after every result is in."""
    barrier = threading.Barrier(len(reqs))
    pend = {name: [] for name in reqs}
    errors = []

    def client(name):
        sess = svc.session(name)
        barrier.wait()
        try:
            for r in reqs[name]:
                pend[name].append((r["op"], sess.submit(r)))
            for _, p in pend[name]:
                p.result(timeout=timeout)
        except Exception as e:          # reported below; the phase fails
            errors.append(f"{name}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(n,)) for n in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"session requests failed: {errors}")
    return [(name, op, p) for name in reqs for op, p in pend[name]]


def phase_service_inprocess(dev, g22, g14, u14):
    """Phase 3e (a): ``GraphService(workers=2)`` on the card, four sessions
    submitting at once; the cache hit, the delta, the memory budget."""
    from repro_torch import obs
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import EdgeDelta
    from repro_torch.kernels.bsr_spmv import bsr_spmv as k1
    from repro_torch.kernels.bsr_tricount import bsr_tricount as k3
    from repro_torch.kernels.segment_sum import segment_sum_chunked as k2
    from repro_torch.serve.graph_service import GraphService
    t0 = time.perf_counter()
    svc = GraphService(workers=2, device=dev)
    for name, g in (("g22", g22), ("g14", g14), ("u14", u14)):
        svc.workspace.put(name, g)
    bfs_src = top_sources(g22, SERVICE_BFS)
    ppr_src = top_sources(g14, SERVICE_PPR)
    ppr_iters = [5 if i % 2 else 10 for i in range(SERVICE_PPR)]
    pr_pallas = {"op": "pagerank", "graph": "g22",
                 "params": {"n_iter": 10, "backend": "pallas"}}
    pr_tol = {"op": "pagerank", "graph": "g22",
              "params": {"tol": 1e-6, "backend": "xla"}}
    reqs = {
        "bfs": [{"op": "bfs", "graph": "g22", "params": {"source": s}}
                for s in bfs_src],
        "ppr": [{"op": "personalized_pagerank", "graph": "g14",
                 "params": {"source": s, "n_iter": it, "backend": "bsr"}}
                for s, it in zip(ppr_src, ppr_iters)],
        "pagerank": [pr_pallas, pr_tol],
        "triangles": [{"op": "triangle_count", "graph": "u14",
                       "params": {"backend": "bsr"}}],
    }
    before = dict(svc.stats)
    ran, secs_sessions = timed(lambda: run_sessions(svc, reqs))
    stats = {k: svc.stats[k] - before[k] for k in svc.stats}
    check(stats["fused_calls"] >= 1, f"no request fused: {stats}")
    got = {op: [p for _, o, p in ran if o == op] for op in
           ("bfs", "personalized_pagerank", "pagerank", "triangle_count")}
    check(sum(p.fused for p in got["personalized_pagerank"]) >= 2,
          "the personalized PageRank requests did not fuse")
    secs_standalone = 0.0
    for s, p in zip(bfs_src, got["bfs"]):
        want, secs = timed(lambda: A.bfs(g22, s))
        secs_standalone += secs
        check(torch.equal(p.value, want), f"fused bfs row {s} != standalone")
    for s, it, p in zip(ppr_src, ppr_iters, got["personalized_pagerank"]):
        check(torch.equal(p.value, A.personalized_pagerank(
            g14, s, n_iter=it, backend="bsr")),
            f"fused ppr row {s} (n_iter {it}) != standalone")
    pr_xla = A.pagerank(g22, n_iter=10, backend="xla")
    err = max_abs(got["pagerank"][0].value, pr_xla)
    scale = float(pr_xla.abs().max())
    check(err <= TOL * scale, f"service pallas pagerank vs xla {err}")
    tri = got["triangle_count"][0].value
    check(tri == A.triangle_count(u14), f"service bsr triangles {tri} != "
          f"xla {A.triangle_count(u14)}")
    # the repeat is a submit-time cache hit: no host sync, no launch
    counts = (k1.launches, k2.launches, k3.launches)
    hit, hit_syncs = count_syncs(lambda: svc.session("pagerank").submit(
        pr_pallas))
    check(hit.done and hit.cached and hit.result() is got["pagerank"][0].value,
          "repeated pallas pagerank was not a cache hit")
    check(sum(hit_syncs.values()) == 0, f"cache hit synced: {hit_syncs}")
    check((k1.launches, k2.launches, k3.launches) == counts,
          "the cache hit launched a kernel")
    _, xla_syncs = count_syncs(lambda: A.pagerank(g22, n_iter=10,
                                                  backend="xla"))
    check(sum(xla_syncs.values()) == 0 and obs.REGISTRY.enabled,
          f"xla pagerank with the instruments on synced: {xla_syncs}")
    summary = pending_summary([(op, p) for _, op, p in ran] +
                              [("pagerank_hit", hit)])

    # the delta: retained or warm, each equal to a cold run on the child
    add_s, add_d, _ = insert_delta_arrays(g22)
    before = dict(svc.stats)
    _, secs_delta = timed(lambda: svc.workspace.apply_delta(
        "g22", EdgeDelta.inserts(add_s, add_d)))
    child = svc.workspace.get("g22")
    check(child._delta is not None and child._delta.parent is g22,
          "Workspace.apply_delta did not keep the delta lineage")
    sess = svc.session("bfs")
    redo = [("bfs", sess.submit(reqs["bfs"][0])),
            ("pagerank", svc.session("pagerank").submit(pr_tol))]
    (bfs_new, pr_new), secs_redo = timed(
        lambda: [p.result(timeout=600) for _, p in redo])
    dstats = {k: svc.stats[k] - before[k] for k in svc.stats}
    check(dstats["retained"] + dstats["warm_starts"] >= 1,
          f"nothing retained or warm after the delta: {dstats}")
    check(torch.equal(bfs_new, A.bfs(child, bfs_src[0])),
          "bfs after the delta != a cold bfs on the child")
    cold_pr = A.pagerank(child, tol=1e-6, backend="xla")
    err_delta = max_abs(pr_new, cold_pr)
    check(err_delta <= 1e-5, f"pagerank after the delta vs cold {err_delta}")
    summary.update({f"{op}_after_delta": pending_summary([(op, p)])[op]
                    for op, p in redo})

    # a memory budget under the plan's evictable bytes: same answers
    budget = service_budget(dev, g14, ppr_src[0])
    snap = obs.dump_metrics()
    emit({"phase": "service_inprocess", "workers": 2,
          "sessions": {k: len(v) for k, v in reqs.items()},
          "stats": stats, "stats_after_delta": dstats,
          "ops": summary, "sched": sched_summary(snap),
          "bfs_standalone_seconds_total": secs_standalone,
          "pallas_pagerank_max_abs_vs_xla": err,
          "pagerank_after_delta_max_abs_vs_cold": err_delta,
          "cache_hit_syncs": hit_syncs, "xla_pagerank_syncs": xla_syncs,
          "budget": budget, "seconds_sessions": secs_sessions,
          "seconds_apply_delta": secs_delta, "seconds_after_delta": secs_redo,
          "seconds": time.perf_counter() - t0})
    return svc, child, bfs_src


def service_budget(dev, g14, source):
    """An unbounded and a budgeted service on fresh copies of ``g14`` (the
    same CSR tensors, no plan): the budget sits under the evictable plan
    bytes the unbounded one holds, and the answers must be the same bits."""
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.serve.policy import MemoryPolicy
    seq = [("pagerank", {"n_iter": 10, "backend": "bsr"}),
           ("personalized_pagerank", {"source": source, "backend": "bsr"}),
           ("k_core", {"k": 8, "backend": "bsr"}),
           ("connected_components", {}),
           ("bfs", {"source": source})]

    def run(svc):
        svc.workspace.put("g", dataclasses.replace(g14, _plan=None,
                                                   _delta=None))
        sess = svc.session("a")
        return [sess.execute({"op": op, "graph": "g", "params": params})
                for op, params in seq]

    free = GraphService(device=dev)
    want = run(free)
    evictable = free.memory_stats()["plan_evictable_bytes"]
    check(evictable > 0, "no evictable plan bytes on g14")
    tight = GraphService(device=dev,
                         memory=MemoryPolicy(budget_bytes=evictable // 4))
    got = run(tight)
    check(all(torch.equal(a, b) for a, b in zip(want, got)),
          "the budgeted service answered differently")
    mem = tight.memory_stats()
    check(tight.stats["evicted_bytes"] > 0 and
          mem["tracked_bytes"] <= evictable // 4,
          f"budget {evictable // 4} not kept: {mem}, {tight.stats}")
    return {"budget_bytes": evictable // 4, "unbounded_evictable": evictable,
            "tracked_bytes": mem["tracked_bytes"],
            "evicted_results": tight.stats["evicted_results"],
            "evicted_plan_families": tight.stats["evicted_plan_families"],
            "evicted_bytes": tight.stats["evicted_bytes"]}


def phase_service_tcp(dev, svc, child, bfs_src):
    """Phase 3e (b): ``GraphServer`` on the part-(a) service, four
    ``RemoteService`` clients in threads issuing BFS and PageRank on the
    (updated) scale-22 graph; stats, metrics, a trace, a draining
    shutdown."""
    from repro_torch.core import algorithms as A
    from repro_torch.serve.client import RemoteService
    from repro_torch.serve.server import GraphServer
    t0 = time.perf_counter()
    server = GraphServer(svc, port=0).start()
    fresh = top_sources(child, 4 * SERVICE_CLIENTS + 8, skip=SERVICE_BFS)
    pr_req = {"op": "pagerank", "graph": "g22", "params": {"n_iter": 10}}
    clients = [RemoteService(port=server.port, device=dev)
               for _ in range(SERVICE_CLIENTS)]
    results = [None] * SERVICE_CLIENTS
    errors = []
    barrier = threading.Barrier(SERVICE_CLIENTS)

    def client(i):
        sess = clients[i].session("analyst")
        barrier.wait()
        try:
            ps = [("bfs", s, sess.submit({"op": "bfs", "graph": "g22",
                                          "params": {"source": s}}))
                  for s in fresh[4 * i:4 * i + 4]]
            ps.append(("pagerank", None, sess.submit(pr_req)))
            results[i] = [(op, s, p, p.result(timeout=600))
                          for op, s, p in ps]
        except Exception as e:
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVICE_CLIENTS)]
    before = dict(svc.stats)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs_clients = time.perf_counter() - t0
    check(not errors, f"remote clients failed: {errors}")
    pr_local = svc.session("local").execute(pr_req)
    pr_direct = A.pagerank(child, n_iter=10)
    for rows in results:
        for op, s, _, v in rows:
            check(isinstance(v, np.ndarray), f"remote {op} is not numpy")
            if op == "bfs":
                check(np.array_equal(v, host(A.bfs(child, s))),
                      f"remote bfs {s} != in-process bfs")
            else:
                check(np.array_equal(v, host(pr_local)),
                      "remote pagerank != the in-process service's")
                check(max_abs(torch.from_numpy(v.copy()), pr_direct.cpu())
                      <= TOL * float(pr_direct.abs().max()),
                      "remote pagerank != a direct call")
    stats = clients[0].stats
    check(stats["fused_calls"] >= 1, f"remote stats show no fusion: {stats}")
    metrics = clients[1].metrics()
    backends = {b: metrics.get(f"engine.backend.{b}", {}).get("value", 0)
                for b in ("frontier", "bsr", "pallas", "xla")}
    check(all(backends[b] > 0 for b in ("frontier", "bsr", "pallas")),
          f"engine.backend counters {backends}")
    check(metrics.get("sched.engine_ms", {}).get("count", 0) > 0,
          "sched.engine_ms is empty")
    # a traced request: its engine span is in the server's trace
    traced = clients[2].session("tracer").submit(
        {"op": "bfs", "graph": "g22", "params": {"source": fresh[-1]}})
    traced.result(timeout=600)
    doc = clients[2].chrome_trace(trace=traced.trace)
    names = sorted({e["name"] for e in doc["traceEvents"]})
    check("engine.bfs" in names, f"no engine span in the trace: {names}")
    # shutdown drains: requests in flight all resolve
    late_src = fresh[-8:-1]
    late = [clients[3].session("late").submit(
        {"op": "bfs", "graph": "g22", "params": {"source": s}})
        for s in late_src]
    _, secs_shutdown = timed(server.shutdown)
    for s, p in zip(late_src, late):
        check(np.array_equal(p.result(timeout=60), host(A.bfs(child, s))),
              f"request {s} in flight at shutdown was dropped or wrong")
    for c in clients:
        c.close()
    remote = [(op, p) for rows in results for op, _, p, _ in rows]
    emit({"phase": "service_tcp", "clients": SERVICE_CLIENTS,
          "requests": len(remote) + 1 + len(late),
          "stats": {k: svc.stats[k] - before[k] for k in svc.stats},
          "ops": pending_summary(remote + [("bfs_late", p) for p in late]),
          "engine_backend": backends, "sched": sched_summary(metrics),
          "trace_spans": names, "seconds_clients": secs_clients,
          "seconds_shutdown": secs_shutdown,
          "seconds": time.perf_counter() - t0})


def phase_service_process(dev):
    """Phase 3e (c): ``spawn_server`` on the card at scale 14 and the
    port's §4.1 ``run_workload`` through ``RemoteService``: the exported
    script re-executes here to the same scores, the delta epilogue warms."""
    from repro_torch.examples.stackoverflow_experts import run_workload
    from repro_torch.serve.client import RemoteService
    from repro_torch.serve.server import spawn_server
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    t0 = time.perf_counter()
    proc, port = spawn_server(("--rmat-scale", "14", "--edge-factor", "16",
                               "--publish", "rmat14"), timeout=300.0)
    try:
        secs_spawn = time.perf_counter() - t0
        client = RemoteService(port=port, device=dev)
        check(client.server_pid == proc.pid, "the client reached another "
              "process than the spawned server")
        # the preloaded graph answers as one built here from the same edges
        pr = client.session("probe").execute(
            {"op": "pagerank", "graph": "rmat14", "params": {"n_iter": 10}})
        here = A.pagerank(Graph.from_edges(*rmat_edges(14, 16), device=dev),
                          n_iter=10)
        check(np.array_equal(pr, host(here)),
              "the spawned server's scale-14 pagerank != a local one")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            experts, secs_workload = timed(lambda: run_workload(client))
        stats = client.stats
        check(stats["warm_starts"] >= 1, f"no warm start remotely: {stats}")
        client.shutdown_server()
        client.close()
        rc = proc.wait(timeout=120)
        check(rc == 0, f"spawned server exited with rc {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    emit({"phase": "service_process", "server_rc": rc,
          "experts": experts.n_valid, "stats": stats,
          "workload_lines": len(out.getvalue().splitlines()),
          "seconds_spawn": secs_spawn, "seconds_workload": secs_workload,
          "seconds": time.perf_counter() - t0})


def phase_service(dev, g22, g14, u14):
    """Phase 3e: the interactive service, in a launch window of its own: K1
    in the fused "bsr" personalized PageRank, K2 in the "pallas" PageRank,
    K3 in the "bsr" triangle count."""
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount)
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    svc, child, bfs_src = phase_service_inprocess(dev, g22, g14, u14)
    phase_service_tcp(dev, svc, child, bfs_src)
    del svc, child
    phase_service_process(dev)
    launches = {k.__name__: k.launches for k in kernels}
    check(all(launches.values()), f"phase 3e launches {launches}")
    emit({"phase": "service", "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches

SHARD_PLAN_COUNTS = (2, 4, 8)   # phase 3f: ShardPlans built for their halo
SHARDED_RANKS = 2               # phase 3f (b): gloo ranks on the one card
SHARDED_JOIN_SECONDS = 300.0    # phase 3f (b): the ranks' deadline


def run_ranks(target, n: int, seconds: float, what: str, *args) -> None:
    """Spawn ``n`` processes running ``target(rank, n, *args)``, join them
    against ``seconds`` (killing any still running) and fail unless every
    one exited with 0."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, n) + args)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + seconds
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30.0)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * n, f"{what}: the ranks exited with {codes}")


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (NaN payloads and signed zeros too)."""
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.contiguous().view(torch.uint8),
                        b.contiguous().view(torch.uint8)))


def sharded_rank(rank: int, d: int, workdir: str, n: int, n_iter: int,
                 device: str):
    """Phase 3f (b), one rank: join a gloo world of ``d`` ranks on
    ``device`` (card 0), build the graph from the edges the parent saved,
    run the "sharded" PageRank and components at ``d`` shards; rank 0 saves
    its results."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core import algorithms as A
    from repro_torch.core import engine
    from repro_torch.core.graph import Graph
    work = Path(workdir)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=120))
    try:
        edges = np.load(work / "edges.npz")
        g, t_graph = timed(lambda: Graph.from_dense_edges(
            edges["src"], edges["dst"], n, device=device))
        check(engine.shard_count() == d, "the world is not the shard count")
        ex, t_exec = timed(lambda: engine.get_exec(g.plan(), "sharded"))
        check(type(ex) is engine.ShardedExec and ex.d == d,
              f"rank {rank}: no ShardedExec at d={d}")
        pr, t_first = timed(lambda: A.pagerank(g, n_iter=n_iter,
                                               backend="sharded"))
        pr2, t_pr = timed(lambda: A.pagerank(g, n_iter=n_iter,
                                             backend="sharded"))
        check(same_bits(pr, pr2), f"rank {rank}: two sharded PageRanks "
              f"differ")
        cc, t_cc = timed(lambda: A.connected_components(g, backend="sharded"))
        info = {"rank": rank, "d": d, "seconds_graph": t_graph,
                "seconds_exec": t_exec, "seconds_pagerank_first": t_first,
                "seconds_pagerank": t_pr,
                "ms_per_round": t_pr / n_iter * 1e3, "seconds_cc": t_cc,
                "halo_bytes_per_round":
                    g.plan().sharded(d).halo_bytes_per_round(),
                "result_bytes_per_round": d * ex.ns * 4,
                "edge_slots": ex.pull_blk.hi - ex.pull_blk.lo,
                "cc_halo_bytes_per_round":
                    g.plan().undirected().plan().sharded(d)
                    .halo_bytes_per_round()}
        if rank == 0:
            np.savez(work / "rank0.npz", pr=pr.cpu().numpy(),
                     cc=cc.cpu().numpy())
        (work / f"rank{rank}.json").write_text(json.dumps(info))
        dist.barrier()          # no rank tears down while a peer is busy
    finally:
        dist.destroy_process_group()


def sharded_world(g22, n_iter: int):
    """Phase 3f (b): ``SHARDED_RANKS`` spawned ranks on the card over gloo;
    returns rank 0's (PageRank, components) and every rank's record."""
    import shutil
    work = ROOT / "build" / "phase3f"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        src, dst = g22.out_edges()
        np.savez(work / "edges.npz", src=src.cpu().numpy(),
                 dst=dst.cpu().numpy())
        run_ranks(sharded_rank, SHARDED_RANKS, SHARDED_JOIN_SECONDS,
                  "phase 3f (b)", str(work), g22.n_nodes, n_iter,
                  g22.device.type)
        res = np.load(work / "rank0.npz")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(SHARDED_RANKS)]
        return (torch.from_numpy(res["pr"]), torch.from_numpy(res["cc"]),
                ranks)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_sharded(dev, g22, u14):
    """Phase 3f: the "sharded" backend and ``core/distributed.py``, in a
    launch window of its own (no kernel may launch in it)."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import distributed as D
    from repro_torch.core import engine
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    from repro_torch.serve.graph_service import GraphService
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    plan = g22.plan()
    n = g22.n_nodes
    check(engine.shard_count() == 1, "phase 3f (a) runs at one shard")
    src = int(torch.argmax(plan.out_deg))
    w = torch.from_numpy(np.random.default_rng(7).uniform(
        0.5, 4.0, g22.n_edges).astype(np.float32)).to(dev)
    ex, t_exec = timed(lambda: engine.get_exec(plan, "sharded"))
    check(type(ex) is engine.ShardedExec and ex.d == 1,
          "no ShardedExec at one shard")
    runs = {
        "pagerank_n10": lambda be: A.pagerank(g22, n_iter=10, backend=be),
        "pagerank_tol": lambda be: A.pagerank(g22, tol=1e-6, backend=be),
        "bfs": lambda be: A.bfs(g22, src, backend=be),
        "sssp_weighted": lambda be: A.sssp(g22, src, w, backend=be),
        "connected_components":
            lambda be: A.connected_components(g22, backend=be),
        "label_propagation_n20":
            lambda be: A.label_propagation(g22, n_iter=20, backend=be)}
    rec, xla = {}, {}
    for name, fn in runs.items():
        want, t_x = timed(lambda: fn("xla"))
        got, t_s = timed(lambda: fn("sharded"))
        check(same_bits(got, want), f"phase 3f: {name} sharded != xla")
        rec[name] = {"seconds_xla": t_x, "seconds_sharded": t_s}
        xla[name] = want
    pr = xla["pagerank_n10"]
    tri_x, t_tri_x = timed(lambda: A.triangle_count(u14))
    tri_s, t_tri_s = timed(lambda: A.triangle_count(u14, backend="sharded"))
    check(tri_s == tri_x, f"phase 3f: sharded triangles {tri_s} != {tri_x}")

    dg, t_dg = timed(lambda: D.shard_graph(g22))
    pr_d, t_prd = timed(lambda: D.pagerank_distributed(dg, n_iter=10))
    pr_b, t_prb = timed(lambda: D.pagerank_distributed(
        dg, n_iter=10, compress_bf16=True))
    s_out, d_out = g22.out_edges()
    dg2, t_conv = timed(lambda: D.distributed_to_graph(s_out, d_out, n))
    pr_c, _ = timed(lambda: D.pagerank_distributed(dg2, n_iter=10))
    deg = D.degrees_distributed(dg)
    dist_err = {"pagerank": max_abs(pr_d, pr), "pagerank_bf16":
                max_abs(pr_b, pr), "pagerank_converted": max_abs(pr_c, pr)}
    check(dist_err["pagerank"] <= 1e-6 and dist_err["pagerank_converted"]
          <= 1e-6 and dist_err["pagerank_bf16"] <= 5e-5,
          f"phase 3f: distributed PageRank errors {dist_err}")
    check(torch.equal(deg, g22.in_degrees().to(deg.dtype)),
          "phase 3f: degrees_distributed != in_degrees")
    del dg, dg2

    svc = GraphService(engine_backend="sharded", device=dev)
    try:
        svc.workspace.put("g", g22)
        got, t_svc = timed(lambda: svc.session("a").execute(
            {"op": "pagerank", "graph": "g", "params": {"n_iter": 10}}))
        check(same_bits(got, pr), "phase 3f: the sharded service's PageRank "
              "!= xla")
    finally:
        svc.close()

    plans = {1: {"halo_bytes_per_round":
                 plan.sharded(1).halo_bytes_per_round()}}
    for d in SHARD_PLAN_COUNTS:
        sp, t_sp = timed(lambda: plan.sharded(d))
        plans[d] = {"seconds_build": t_sp, "edge_slots": sp.pull.es,
                    "halo": sp.pull.halo,
                    "halo_bytes_per_round": sp.halo_bytes_per_round()}
    freed = plan.evict("sharded")
    torch.cuda.empty_cache()
    emit({"phase": "sharded_inprocess", "shards": 1, "nodes": n,
          "edges": g22.n_edges,
          "source": src, "seconds_exec": t_exec, "runs": rec,
          "triangles": tri_s, "seconds_triangles_xla": t_tri_x,
          "seconds_triangles_sharded": t_tri_s,
          "distributed": {"max_abs_vs_xla": dist_err,
                          "seconds_shard_graph": t_dg,
                          "seconds_pagerank": t_prd,
                          "seconds_pagerank_bf16": t_prb,
                          "seconds_distributed_to_graph": t_conv},
          "service_seconds": t_svc, "shard_plans": plans,
          "evicted_bytes": freed, "seconds": time.perf_counter() - t0})

    t1 = time.perf_counter()
    pr2, cc2, ranks = sharded_world(g22, 10)
    check(same_bits(pr2, pr.cpu()), "phase 3f (b): d=2 PageRank != xla")
    check(same_bits(cc2, xla["connected_components"].cpu()),
          "phase 3f (b): d=2 components != xla")
    emit({"phase": "sharded_ranks", "ranks": SHARDED_RANKS,
          "backend": "gloo", "per_rank": ranks,
          "seconds": time.perf_counter() - t1})
    launches = {k.__name__: k.launches for k in kernels}
    check(not any(launches.values()), f"phase 3f launched kernels: "
          f"{launches}")
    emit({"phase": "sharded", "launches": launches,
          "seconds": time.perf_counter() - t0})
    ref = {k: xla[k] for k in ("pagerank_n10", "pagerank_tol", "bfs",
                                "connected_components")}
    return launches, dict(ref, source=src)


SERVICE_RANKS = 2                 # phase 3g: gloo ranks of the "sharded" service
SERVICE_JOIN_SECONDS = 300.0      # phase 3g: the ranks' deadline


def service_rank(rank: int, d: int, workdir: str, n: int, device: str):
    """Phase 3g, one rank: join a gloo world of ``d`` ranks on ``device``
    (card 0).  Rank 0 builds the graph from the edges the parent saved and
    serves it through ``GraphService(engine_backend="sharded", workers=2)``
    (two sessions: PageRank to 10 rounds and to ``tol``, CC, two BFS that
    fuse, a cache hit, phase 3d's delta and a warm PageRank) and saves the
    results; every other rank runs ``serve_follower`` until rank 0's
    ``close``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core.graph import EdgeDelta, Graph
    from repro_torch.serve.graph_service import GraphService, serve_follower
    work = Path(workdir)
    if device == "cuda":
        torch.cuda.set_device(0)

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=120))
    try:
        if rank:
            info, secs = timed(lambda: serve_follower(device=device))
            info.update(rank=rank, seconds=secs)
            (work / f"rank{rank}.json").write_text(json.dumps(info))
            dist.barrier()
            return
        arr = np.load(work / "edges.npz")
        g, t_graph = timed(lambda: Graph.from_dense_edges(
            arr["src"], arr["dst"], n, node_ids=arr["ids"], device=device))
        svc = GraphService(engine_backend="sharded", workers=2, device=device)
        try:
            svc.workspace.put("g", g)
            a, b = svc.session("a"), svc.session("b")
            t_first = time.perf_counter()
            first = [
                a.submit({"op": "pagerank", "graph": "g",
                          "params": {"n_iter": 10}}),
                b.submit({"op": "connected_components", "graph": "g"}),
                a.submit({"op": "pagerank", "graph": "g",
                          "params": {"tol": 1e-6}}),
                a.submit({"op": "bfs", "graph": "g",
                          "params": {"source": int(arr["bfs"][0])}}),
                b.submit({"op": "bfs", "graph": "g",
                          "params": {"source": int(arr["bfs"][1])}})]
            for p in first:
                p.result(timeout=600)
            t_first = time.perf_counter() - t_first
            hit = a.submit({"op": "pagerank", "graph": "g",
                            "params": {"n_iter": 10}})
            _, t_delta = timed(lambda: svc.workspace.apply_delta(
                "g", EdgeDelta.inserts(arr["add_src"], arr["add_dst"])))
            warm, t_warm = timed(lambda: b.execute(
                {"op": "pagerank", "graph": "g", "params": {"tol": 1e-6}}))
            stats = dict(svc.stats)
            mirror = dict(svc._mirror.stats)
        finally:
            svc.close()
        np.savez(work / "rank0.npz", pagerank=first[0].value.cpu().numpy(),
                 cc=first[1].value.cpu().numpy(),
                 pagerank_tol=first[2].value.cpu().numpy(),
                 bfs0=first[3].value.cpu().numpy(),
                 bfs1=first[4].value.cpu().numpy(),
                 warm=warm.cpu().numpy(), hit_value=hit.result().cpu().numpy())
        info = {"rank": 0, "stats": stats, "mirror": mirror,
                "hit": hit.cached,
                "fused": [p.fused for p in first[3:]],
                "latency_ms": [p.latency_ms for p in first],
                "seconds_graph": t_graph, "seconds_requests": t_first,
                "seconds_apply_delta": t_delta, "seconds_warm": t_warm}
        (work / "rank0.json").write_text(json.dumps(info))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_sharded_service(dev, g22, ref):
    """Phase 3g: a 2-rank "sharded" ``GraphService`` on the card (gloo
    ranks spawned as in phase 3f (b)); every result equals phase 3f (a)'s
    "xla" bits, in a launch window of its own (no kernel launches)."""
    import shutil
    from repro_torch.core import algorithms as A
    from repro_torch.core.graph import EdgeDelta
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    n = g22.n_nodes
    src = ref["source"]
    src2 = int(torch.argmax(g22.in_degrees()))
    bfs2 = A.bfs(g22, src2, backend="xla")
    add_s, add_d, _ = insert_delta_arrays(g22)
    child = g22.apply_delta(EdgeDelta.inserts(add_s, add_d))
    warm_want = A.pagerank(child, tol=1e-6, init=ref["pagerank_tol"],
                           backend="xla")
    del child
    work = ROOT / "build" / "phase3g"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        s_out, d_out = g22.out_edges()
        np.savez(work / "edges.npz", src=s_out.cpu().numpy(),
                 dst=d_out.cpu().numpy(),
                 ids=g22.node_ids[:n].cpu().numpy(),
                 bfs=np.asarray([src, src2]), add_src=add_s, add_dst=add_d)
        run_ranks(service_rank, SERVICE_RANKS, SERVICE_JOIN_SECONDS,
                  "phase 3g", str(work), n, g22.device.type)
        got = np.load(work / "rank0.npz")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(SERVICE_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = {"pagerank": ref["pagerank_n10"], "cc": ref["connected_components"],
            "pagerank_tol": ref["pagerank_tol"], "bfs0": ref["bfs"],
            "bfs1": bfs2, "warm": warm_want, "hit_value": ref["pagerank_n10"]}
    for name, w in want.items():
        check(same_bits(torch.from_numpy(got[name]), w.cpu()),
              f"phase 3g: the 2-rank service's {name} != xla")
    r0 = ranks[0]
    check(r0["hit"], "phase 3g: the repeated PageRank was no cache hit")
    check(all(r0["fused"]) and r0["stats"]["fused_calls"] >= 1,
          f"phase 3g: the two BFS did not fuse: {r0['fused']}")
    check(r0["stats"]["warm_starts"] >= 1, "phase 3g: no warm start")
    for r in ranks[1:]:
        check(r["errors"] == 0 and r["calls"] == r0["mirror"]["calls"],
              f"phase 3g: follower {r['rank']} did {r}, rank 0 sent "
              f"{r0['mirror']}")
    launches = {k.__name__: k.launches for k in kernels}
    check(not any(launches.values()), f"phase 3g launched kernels: "
          f"{launches}")
    emit({"phase": "sharded_service", "ranks": SERVICE_RANKS,
          "backend": "gloo", "workers": 2, "per_rank": ranks,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


def left_padded(prompts) -> np.ndarray:
    plen = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        out[i, plen - len(p):] = p
    return out


def decode_vs_forward(model, batch, n_prompt, enc_out=None,
                      tol=DECODE_TOL) -> dict:
    """``decode_step`` after ``prefill`` of the first ``n_prompt`` tokens,
    fed the batch's own tokens, against ``forward``'s logits at every
    decoded position: the largest |difference| within ``tol`` of the
    largest |logit|."""
    with torch.no_grad():
        full, _ = model(batch)
        s = batch["tokens"].shape[1]
        pre = dict(batch, tokens=batch["tokens"][:, :n_prompt])
        _, cache = model.prefill(pre, s + model.cfg.n_patches)
        err, scale = 0.0, 0.0
        for t in range(n_prompt, s):
            dec, cache = model.decode_step(
                cache, batch["tokens"][:, t:t + 1],
                t + model.cfg.n_patches, enc_out=enc_out)
            want, got = full[:, t].float(), dec[:, 0].float()
            check(bool(torch.isfinite(want).all() and
                       torch.isfinite(got).all()),
                  f"{model.cfg.name}: finite forward and decode logits")
            err = max(err, max_abs(got, want))
            scale = max(scale, float(want.abs().max()))
    check(err <= tol * scale, f"{model.cfg.name}: decode vs forward: "
          f"max|d| {err} > {tol} * {scale}")
    return {"decoded_positions": s - n_prompt, "max_abs_diff": err,
            "max_abs_logit": scale, "tolerance": tol * scale}


def phase_serve(dev, kernels, profile):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-3b")          # full width and depth
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    check(len(model.layers) == cfg.n_layers == 36 and cfg.d_model == 2048,
          "qwen2.5-3b at full depth and width")
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = nbytes(*model.parameters())
    eng, t_engine = timed(lambda: Engine(cfg, model, ServeConfig(
        batch=4, max_seq=max(SERVE_PROMPTS) + SERVE_NEW), device=dev))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]

    for k in kernels:
        k.launches = 0
    by_variant = flash_attention_fwd.launches_by_variant
    for name in by_variant:
        by_variant[name] = 0
    out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
    launches = {k.__name__: k.launches for k in kernels}
    k4_variants = dict(by_variant)
    stats = dict(eng.stats)
    check(launches["flash_attention_fwd"] == cfg.n_layers,
          f"K4 launched {launches['flash_attention_fwd']} times in one "
          f"generate, not once per layer ({cfg.n_layers})")
    check(k4_variants["sm90_wgmma"] == cfg.n_layers,
          f"K4 launches by variant {k4_variants}: not all {cfg.n_layers} "
          f"through sm90_wgmma")
    check(all(len(o) == len(p) + SERVE_NEW for o, p in zip(out, prompts)),
          "each output holds its prompt plus the new tokens")
    check(all(o[:len(p)] == p for o, p in zip(out, prompts)),
          "each output starts with its prompt")
    check(all(0 <= t < cfg.vocab_size for o in out for t in o),
          "token ids in [0, vocab)")
    check(bool(torch.isfinite(eng.last_logits).all()), "finite logits")
    again, t_again = timed(lambda: eng.generate(prompts, SERVE_NEW))
    check(again == out, "a second generate gives the same tokens")
    peak = torch.cuda.max_memory_allocated()
    # phase 4f's d = 1 yardstick, on the engine's weights
    toks, teacher = yardstick_inputs(prompts, out, dev)
    yard = {"logits": yardstick(eng.model, toks, teacher,
                                eng.scfg.max_seq)[0],
            "teacher": teacher, "tokens": out, "prompts": prompts}
    del toks

    # decode agrees with forward (tests/test_models.py's check, on the card)
    b, s = DECODE_CHECK
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)
                                         ).astype(np.int32)).to(dev)
    dvf = decode_vs_forward(model, {"tokens": toks}, s - 1)

    rec = {}
    if profile:   # where the time goes: one prefill of the batch, one decode
        plen = max(SERVE_PROMPTS)
        batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev)}
        held = {}
        k4 = {"k4": ("flash_fwd",)}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), eng.model.prefill(batch, eng.scfg.max_seq))),
            k4)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: eng.model.decode_step(held["cache"], cur, plen), k4)
    new_tokens = len(prompts) * stats["decode_steps"]
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params,
          "param_bytes": param_bytes, "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype,
          "memory_allocated_before": mem_before,
          "max_memory_allocated": peak, "seconds_init": t_init,
          "seconds_engine": t_engine, "prompt_lens": list(SERVE_PROMPTS),
          "new_tokens": SERVE_NEW, "seconds_generate": t_gen,
          "seconds_generate_again": t_again,
          "prefill_seconds": stats["prefill_seconds"],
          "decode_seconds_per_token": stats["decode_seconds"]
          / stats["decode_steps"],
          "decode_tokens_per_second": new_tokens / stats["decode_seconds"],
          "tokens_per_second": new_tokens / t_gen,
          "launches": launches, "k4_launches_by_variant": k4_variants,
          "decode_vs_forward": dvf, **rec,
          "seconds": time.perf_counter() - t0})
    return launches["flash_attention_fwd"], k4_variants, yard


# phase 4c: each MoE config at full width, cut in depth to fit the card
MOE_MODELS = (("qwen3-moe-235b-a22b", 6), ("grok-1-314b", 2))
MOE_SAMPLE = 256           # tokens the per-token oracle checks
MOE_SAMPLE_DROPPED = 64    # of them, tokens with a dropped slot
MOE_NEAR_TIE = 1e-5        # float64 gap (k-th minus (k+1)-th probability)
                           # below which the card's routing may differ
MOE_BF16_TOL = 2e-2        # oracle check in bf16, relative to max|oracle|
MOE_F32_TOL = 1e-4         # the same in float32 compute


@torch.no_grad()
def moe_oracle_check(layer, x, cfg, seed: int = 0) -> dict:
    """One MoE layer on ``x`` (B, S, d), in its compute dtype and in
    float32, against an oracle that neither sorts nor buckets.

    The routing must equal a float64 recomputation on the host, but for
    tokens whose float64 gap between the k-th and (k+1)-th probability is
    below ``MOE_NEAR_TIE`` (counted).  An assignment (t, j) is kept iff
    fewer than C earlier assignments in flat order t·k + j went to its
    expert; the port's ``keep`` must say the same.  On ``MOE_SAMPLE`` tokens
    whose routing agrees (``MOE_SAMPLE_DROPPED`` of them with a dropped
    slot), the oracle is Σ over kept slots of gate · FFN_e(x_t) in float32
    from the expert's weight slices; the bf16 output must lie within
    ``MOE_BF16_TOL`` · max|oracle| of it and the float32 one within
    ``MOE_F32_TOL`` ·."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.n_experts
    r = moe.route(layer, x, cfg)
    out = moe.moe_apply(layer, x, cfg)[0].reshape(t, d)
    out32 = moe.moe_apply(layer, x.float(), cfg)[0].reshape(t, d)
    cap = r.capacity
    gate_idx = r.gate_idx.cpu().numpy()

    # the routing against float64 on the host
    x64 = x.reshape(t, d).double().cpu().numpy()
    logits = x64 @ layer.router.w.double().cpu().numpy()
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    rank64 = np.argsort(-probs, axis=1, kind="stable")[:, :k + 1]
    p_top = np.take_along_axis(probs, rank64, axis=1)
    near = p_top[:, k - 1] - p_top[:, k] < MOE_NEAR_TIE
    agree = (rank64[:, :k] == gate_idx).all(axis=1)
    check(bool(np.all(agree | near)), f"MoE routing: {int((~agree & ~near).sum())}"
          f" tokens pick other experts than float64 with a gap >= "
          f"{MOE_NEAR_TIE}")
    gates = p_top[:, :k] / p_top[:, :k].sum(axis=1, keepdims=True)

    # kept slots, counted in flat order
    kept = np.zeros(t * k, bool)
    seen = np.zeros(e, np.int64)
    for pos, ex in enumerate(gate_idx.reshape(-1).tolist()):
        kept[pos] = seen[ex] < cap
        seen[ex] += 1
    keep_tk = np.empty(t * k, bool)
    keep_tk[r.order.cpu().numpy()] = r.keep.cpu().numpy()
    check(bool(np.array_equal(keep_tk, kept)), "MoE keep differs from the "
          "flat-order count")
    kept = kept.reshape(t, k)

    rng = np.random.default_rng(seed)
    dropped = np.flatnonzero(agree & ~kept.all(axis=1))
    check(len(dropped) >= MOE_SAMPLE_DROPPED, f"MoE oracle: only "
          f"{len(dropped)} tokens with a dropped slot")
    pick = rng.choice(dropped, MOE_SAMPLE_DROPPED, replace=False)
    rest = np.setdiff1d(np.flatnonzero(agree), pick)
    sample = np.sort(np.concatenate([pick, rng.choice(
        rest, MOE_SAMPLE - MOE_SAMPLE_DROPPED, replace=False)]))

    xs = x.reshape(t, d)[torch.from_numpy(sample).to(x.device)].float()
    oracle = torch.zeros((len(sample), d), dtype=torch.float32,
                         device=x.device)
    idx_s, kept_s, gate_s = gate_idx[sample], kept[sample], gates[sample]
    for ex in np.unique(idx_s[kept_s]).tolist():
        rows, slots = np.nonzero((idx_s == ex) & kept_s)
        xe = xs[torch.from_numpy(rows).to(x.device)]
        h = xe @ layer.wi[ex].float()
        if layer.wg is not None:
            h = F.silu(xe @ layer.wg[ex].float()) * h
        else:
            h = F.gelu(h, approximate="tanh")
        y = (h @ layer.wo[ex].float()) * torch.from_numpy(
            gate_s[rows, slots].astype(np.float32)).to(x.device)[:, None]
        oracle.index_add_(0, torch.from_numpy(rows).to(x.device), y)
    scale = float(oracle.abs().max())
    sel = torch.from_numpy(sample).to(x.device)
    err = max_abs(out[sel], oracle)
    err32 = max_abs(out32[sel], oracle)
    check(err <= MOE_BF16_TOL * scale, f"MoE bf16 vs oracle: max|d| {err} > "
          f"{MOE_BF16_TOL} * {scale}")
    check(err32 <= MOE_F32_TOL * scale, f"MoE float32 vs oracle: max|d| "
          f"{err32} > {MOE_F32_TOL} * {scale}")
    return {"tokens": t, "capacity": cap,
            "assignments_dropped": int((~kept).sum()),
            "tokens_with_a_dropped_slot": int((~kept.all(axis=1)).sum()),
            "near_ties": int(near.sum()),
            "near_ties_routed_otherwise": int((near & ~agree).sum()),
            "sample": len(sample), "sample_with_a_dropped_slot": len(pick),
            "max_abs_oracle": scale, "bf16_max_abs_diff": err,
            "bf16_tolerance": MOE_BF16_TOL * scale,
            "f32_max_abs_diff": err32, "f32_tolerance": MOE_F32_TOL * scale}


@contextlib.contextmanager
def k4_calls():
    """Record each call of the models' attention through K4
    (``models.attention.flash_attention``) as (q shape, k shape, dtype,
    causal), and clone the q, k, v of the first call of each such key
    into the yielded dict (layer 0's, after RoPE and the GQA repeat;
    detached, so a train step's graph does not grow a branch)."""
    from repro_torch.models import attention as attn
    real, seen, first = attn.flash_attention, [], {}

    def spy(q, k, v, *args, **kwargs):
        causal = kwargs.get("causal", args[0] if args else True)
        key = (tuple(q.shape), tuple(k.shape), str(q.dtype), bool(causal))
        seen.append(key)
        if key not in first:
            first[key] = tuple(t.detach().clone() for t in (q, k, v))
        return real(q, k, v, *args, **kwargs)

    attn.flash_attention = spy
    try:
        yield seen, first
    finally:
        attn.flash_attention = real


def k4_tally(seen) -> list:
    """:func:`k4_calls`' keys as [q shape, k shape, dtype, causal, calls]."""
    return sorted([list(k[0]), list(k[1]), k[2], k[3], seen.count(k)]
                  for k in set(seen))


@contextlib.contextmanager
def moe_drops():
    """Count the assignments the MoE layers drop (``models.moe.route``'s
    ``keep``): one device scalar a routing, appended to the yielded list
    (read it with :func:`n_dropped`)."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append((~r.keep).sum())
        return r

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


def n_dropped(drops) -> int:
    return int(torch.stack(drops).sum()) if drops else 0


@contextlib.contextmanager
def moe_routes():
    """Record each routing of the MoE layers (``models.moe.route``): its
    experts, sorted within a token (T, k) int16, and the router's margin,
    its k-th minus its (k+1)-th probability (T,) float32, appended to the
    yielded list on the device (read it with :func:`host_routes`)."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def spy(p, x, cfg, *args, **kwargs):
        r = real(p, x, cfg, *args, **kwargs)
        k = cfg.experts_per_token
        top = torch.topk(r.probs, k + 1, dim=-1).values
        seen.append((torch.sort(r.gate_idx, dim=-1).values.to(torch.int16),
                     top[:, k - 1] - top[:, k]))
        return r

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


@contextlib.contextmanager
def moe_choices(replay=None):
    """Record each routing's experts (``models.moe.route``'s ``gate_idx``,
    (T, k) best first) on the host, in the yielded list; with ``replay``
    (such a list), route the i-th call to ``replay[i]``'s experts instead
    of its own top k, at the call's own probabilities there
    (``moe.assign``: the same gates, drops and buckets as the recorded
    call's wherever the router agrees), and append to the list the count
    of the call's own choices that differed."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def spy(p, x, cfg, *args, **kwargs):
        r = real(p, x, cfg, *args, **kwargs)
        if replay is None:
            seen.append(r.gate_idx.to("cpu", torch.int16, copy=True))
            return r
        idx = replay[len(seen)].to(r.probs.device, torch.long)
        seen.append(int((idx != r.gate_idx).sum()))
        return moe.assign(r.probs, idx, r.probs.gather(1, idx), r.capacity)

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


def host_routes(seen) -> list:
    return [(e.cpu(), m.cpu()) for e, m in seen]


def serve_moe(dev, arch, n_layers, profile, baseline=None):
    """Phase 4c for one MoE config: serve it, check it, hold layer 0's MoE
    to the oracle; returns its phase line, layer 0's K4 inputs and what
    ``baseline(model, prompts, tokens, max_seq)`` returns, called after the
    second ``generate`` (None without it)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.layers import embed_apply, norm_apply
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)   # depth is the cut
    check(cfg.param_dtype == cfg.compute_dtype == "bfloat16",
          f"{arch}: bf16 parameters and compute")
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    # a one-rank grid: the same weights and results, and expert_tp's own
    # path for a baseline that asks for it
    model, t_init = timed(lambda: Transformer.init_params(
        cfg, gen, device=dev, group=model_grid(1, 1)))
    check(len(model.layers) == n_layers and model.param_dtype ==
          torch.bfloat16, f"{arch}: {n_layers} bf16 layers")
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = nbytes(*model.parameters())
    max_seq = max(SERVE_PROMPTS) + SERVE_NEW
    eng = Engine(cfg, model, ServeConfig(batch=4, max_seq=max_seq),
                 device=dev)
    check(eng.model is model, f"{arch}: the engine made a weight copy")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    plen = max(SERVE_PROMPTS)
    want_shape = (4, plen, cfg.n_heads, cfg.resolved_head_dim)

    k4_before = flash_attention_fwd.launches
    by_variant = flash_attention_fwd.launches_by_variant
    variants_before = dict(by_variant)
    key = (want_shape, want_shape, "torch.bfloat16", True)
    with k4_calls() as (seen, first), moe_drops() as drops:
        out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
    k4 = flash_attention_fwd.launches - k4_before
    wgmma = by_variant["sm90_wgmma"] - variants_before["sm90_wgmma"]
    drops_generate = n_dropped(drops)
    stats = dict(eng.stats)
    check(k4 == n_layers, f"{arch}: K4 launched {k4} times in one generate, "
          f"not once per layer ({n_layers})")
    check(wgmma == n_layers, f"{arch}: {wgmma} of {n_layers} K4 launches "
          f"through sm90_wgmma")
    check(seen == [key] * n_layers,
          f"{arch}: K4 calls {seen}, want {key} {n_layers} times")
    k4_inputs = first.pop(key)
    check(all(len(o) == len(p) + SERVE_NEW and o[:len(p)] == p
              for o, p in zip(out, prompts)),
          f"{arch}: each output is its prompt plus {SERVE_NEW} tokens")
    check(all(0 <= tok < cfg.vocab_size for o in out for tok in o),
          f"{arch}: token ids in [0, vocab)")
    check(bool(torch.isfinite(eng.last_logits).all()),
          f"{arch}: finite logits")
    again, t_again = timed(lambda: eng.generate(prompts, SERVE_NEW))
    check(again == out, f"{arch}: a second generate gives the same tokens")
    stats_again = dict(eng.stats)
    yard = baseline(model, prompts, out, max_seq) if baseline else None

    # the prefill alone: its drops, and layer 0's normed MoE input
    batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev)}
    with torch.no_grad(), moe_drops() as drops:
        held = dict(zip(("logits", "cache"), model.prefill(batch, max_seq)))
    drops_prefill = n_dropped(drops)
    with torch.no_grad():
        blk = model.layers[0]
        x = embed_apply(model.embed["tok"], batch["tokens"], torch.bfloat16)
        a, _ = attn.attention_prefill(
            blk.attn, norm_apply(blk.ln1, x, cfg.norm), cfg,
            model._layer_cache(model.init_cache(4, max_seq), 0))
        h0 = norm_apply(blk.ln2, x + a, cfg.norm)
        del x, a
    oracle, t_oracle = timed(lambda: moe_oracle_check(blk.moe, h0, cfg))
    check(oracle["assignments_dropped"] <= drops_prefill,
          f"{arch}: layer 0 dropped more than the whole prefill")
    del h0
    peak = torch.cuda.max_memory_allocated()

    # decode agrees with forward, with no drops at any T (capacity E/k)
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts /
                                  cfg.experts_per_token)
    b, s = DECODE_CHECK
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)
                                         ).astype(np.int32)).to(dev)
    model.cfg = no_drop
    try:
        with moe_drops() as drops:
            dvf = decode_vs_forward(model, {"tokens": toks}, s - 1)
        check(n_dropped(drops) == 0, f"{arch}: drops at capacity factor "
              f"{no_drop.capacity_factor}")
    finally:
        model.cfg = cfg

    rec = {}
    if profile:   # one MoE prefill of the batch, one decode step
        top = {"k4": ("flash_fwd",)}
        rec["profile_prefill"] = device_busy(
            lambda: model.prefill(batch, max_seq), top, top=8)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: model.decode_step(held["cache"], cur, plen), top, top=8)
    new_tokens = len(prompts) * stats["decode_steps"]
    line = {"arch": arch, "n_layers": n_layers,
            "n_layers_published": full.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "n_experts": cfg.n_experts,
            "experts_per_token": cfg.experts_per_token, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "params": n_params,
            "param_bytes": param_bytes, "param_dtype": cfg.param_dtype,
            "memory_allocated_before": mem_before,
            "max_memory_allocated": peak, "seconds_init": t_init,
            "capacity_prefill": moe.capacity(4 * plen, cfg),
            "capacity_decode": moe.capacity(4, cfg),
            "assignments_dropped_prefill": drops_prefill,
            "assignments_dropped_decode": drops_generate - drops_prefill,
            "assignments_routed_prefill": n_layers * 4 * plen
            * cfg.experts_per_token,
            "assignments_routed_decode": n_layers * 4 * stats["decode_steps"]
            * cfg.experts_per_token,
            "k4_launches_generate": k4, "k4_shape": list(want_shape),
            "seconds_generate": t_gen, "seconds_generate_again": t_again,
            "prefill_seconds": stats["prefill_seconds"],
            "decode_seconds_per_token": stats["decode_seconds"]
            / stats["decode_steps"],
            "decode_tokens_per_second": new_tokens / stats["decode_seconds"],
            "tokens_per_second": new_tokens / t_gen,
            "prefill_seconds_again": stats_again["prefill_seconds"],
            "decode_seconds_per_token_again": stats_again["decode_seconds"]
            / stats_again["decode_steps"],
            "oracle": oracle, "seconds_oracle": t_oracle,
            "decode_vs_forward": {"capacity_factor": no_drop.capacity_factor,
                                  **dvf},
            **rec, "seconds": time.perf_counter() - t0}
    return line, k4_inputs, yard


def phase_moe_serve(dev, kernels, profile, baselines=None):
    """Phase 4c: serve each MoE config of ``MOE_MODELS`` in turn, in one
    launch window; then, outside the window, hold K4 to its plain version
    on the q, k, v that each model's layer 0 gave it in the first
    ``generate``.  ``baselines``: {arch: a ``serve_moe`` baseline, one
    prefill of the model}.  Returns the window's launches, K4's rows at
    those shapes and {arch: its baseline's result}."""
    t0 = time.perf_counter()
    baselines = baselines or {}
    for k in kernels:
        k.launches = 0
    lines, k4_inputs, yards = [], [], {}
    for arch, n_layers in MOE_MODELS:
        line, qkv, yard = serve_moe(dev, arch, n_layers, profile,
                                    baselines.get(arch))
        lines.append(line)
        k4_inputs.append((arch, qkv))
        if yard is not None:
            yards[arch] = yard
        del qkv
        torch.cuda.empty_cache()
    launches = {k.__name__: k.launches for k in kernels}
    n = sum(n_layers for _, n_layers in MOE_MODELS)
    # per model: two generates, the oracle's prefill and layer-0 attention,
    # the forward and the prefill of the decode check (+ the profile's);
    # a baseline's prefill
    want = (5 + profile) * n + len(MOE_MODELS) + \
        sum(n_layers for arch, n_layers in MOE_MODELS if arch in baselines)
    check(launches["flash_attention_fwd"] == want, f"phase 4c: K4 launched "
          f"{launches['flash_attention_fwd']} times, not {want}")
    check(not any(c for name, c in launches.items()
                  if name != "flash_attention_fwd"),
          f"phase 4c launched graph kernels: {launches}")
    k4_rows = []
    for arch, (q, k, v) in k4_inputs:
        k4_rows.append({"arch": arch, **k4_on_path_inputs(q, k, v)})
        del q, k, v
    del k4_inputs
    emit({"phase": "moe_serve", "models": lines, "launches": launches,
          "k4_on_path_inputs": k4_rows, "seconds": time.perf_counter() - t0})
    return launches, k4_rows, yards


# phase 4f: the dense and MoE families sharded over two ranks
SHARDED_LM_RANKS = 2            # gloo ranks on the one card
SHARDED_LM_JOIN_SECONDS = 600.0
YARD_STEPS = 4                  # teacher-forced decode steps held to d = 1
# An MoE at d = 2 against d = 1: a rounding difference flips a token's
# top-k among near-equal router probabilities (random weights).  qwen3-moe
# flips 6.6% of its (token, layer) routings; a row's decode step whose
# token flipped reads 3.1-5.0% of the largest logit, the others at most
# 1.25% (PERF.md, phase 4f).  The flipped steps are held to
# ROUTED_STEP_TOL, all else to DECODE_TOL.
ROUTED_STEP_TOL = 1e-1
ROUTE_FLIP_LIMIT = 0.15         # share of routings whose experts differ
# (arch, layers, moe_impl): phase 4's and phase 4c's first model
SHARDED_LM_MODELS = (("qwen2.5-3b", 0, "sorted"),
                     (MOE_MODELS[0][0], MOE_MODELS[0][1], "expert_tp"))


def sharded_lm_config(arch, n_layers, impl):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               moe_impl=impl)


@torch.no_grad()
def yardstick(model, tokens, teacher, max_seq, group=None) -> tuple:
    """The last position's prefill logits of ``tokens`` (B, S) and
    ``teacher.shape[1]`` teacher-forced decode steps -> ((B, 1 + n, V)
    float32 on the host, the prefill's and the steps' host seconds and,
    with ``group``, its collectives' counts, bytes and seconds)."""
    def snap():
        sync()
        return time.perf_counter(), dict(group.stats) if group else {}

    t0, c0 = snap()
    logits, cache = model.prefill({"tokens": tokens}, max_seq)
    rows = [logits[:, -1].float()]
    t1, c1 = snap()
    s = tokens.shape[1]
    for j in range(teacher.shape[1]):
        logits, cache = model.decode_step(cache, teacher[:, j:j + 1], s + j)
        rows.append(logits[:, -1].float())
    t2, c2 = snap()
    n = teacher.shape[1]
    rec = {"prefill_seconds": t1 - t0, "decode_seconds_per_token":
           (t2 - t1) / n}
    if group:
        rec["collectives_per_prefill"] = {k: c1[k] - c0[k] for k in c0}
        rec["collectives_per_token"] = {k: (c2[k] - c1[k]) / n for k in c0}
    return torch.stack(rows, 1).cpu(), rec


def sharded_lm_baselines() -> dict:
    """Phase 4f's d = 1 yardsticks that phase 4c runs: {arch: baseline}."""
    return {m[0]: sharded_lm_baseline(*m) for m in SHARDED_LM_MODELS
            if m[0] in dict(MOE_MODELS)}


def sharded_lm_baseline(arch, n_layers, impl):
    """Phase 4f's d = 1 yardstick for a model phase 4c serves (a
    ``serve_moe`` baseline): the yardstick on a shallow copy of the model
    that carries ``impl``'s config (over the one-rank grid, ``expert_tp``
    keeps its own capacity rule), with its routings (:func:`moe_routes`)."""
    cfg = sharded_lm_config(arch, n_layers, impl)

    def run(model, prompts, out, max_seq):
        toks, teacher = yardstick_inputs(prompts, out, model.device)
        view = copy.copy(model)
        view.cfg = cfg
        with moe_routes() as routes:
            logits = yardstick(view, toks, teacher, max_seq)[0]
        return {"logits": logits, "teacher": teacher, "tokens": out,
                "prompts": prompts, "routes": host_routes(routes)}
    return run


def route_flips(want, got, n_layers) -> dict:
    """The tokens whose experts differ between two runs' routings (lists
    of :func:`moe_routes` pairs in call order: the prefill's layers, then
    each decode step's), per position summed over the layers; for each
    decode step, whether each row's token chose other experts in any
    layer; and the router margins ``want`` had there."""
    check(len(got) == len(want), f"{len(got)} routings, want {len(want)}")
    diffs = [(we != ge).any(-1) for (we, _), (ge, _) in zip(want, got)]
    per = [diffs[c:c + n_layers] for c in range(0, len(diffs), n_layers)]
    flipped = torch.cat([m[d] for (_, m), d in zip(want, diffs)])
    first = want[0][1][diffs[0]]
    return {"flips_per_position": [sum(int(d.sum()) for d in p)
                                   for p in per],
            "routings_per_position": [sum(d.numel() for d in p)
                                      for p in per],
            "step_rows_flipped": [torch.stack(p).any(0).tolist()
                                  for p in per[1:]],
            "flip_share": sum(int(d.sum()) for d in diffs)
            / sum(d.numel() for d in diffs),
            "flips_prefill_per_layer": [int(d.sum()) for d in per[0]],
            "margin_median": float(torch.cat([m for _, m in want]).median()),
            "margin_median_flipped": float(flipped.median())
            if flipped.numel() else None,
            "margin_max_flipped": float(flipped.max())
            if flipped.numel() else None,
            "margin_max_flipped_prefill_layer0": float(first.max())
            if first.numel() else None}


def yardstick_inputs(prompts, out, dev):
    """Phase 4's left-padded prompts and the first ``YARD_STEPS`` tokens
    the d = 1 ``generate`` gave each, as the teacher."""
    toks = torch.from_numpy(left_padded(prompts)).to(dev)
    teacher = torch.tensor([o[len(p):len(p) + YARD_STEPS]
                            for o, p in zip(out, prompts)], device=dev)
    return toks, teacher


def sharded_lm_rank(rank: int, d: int, workdir: str, jobs, device: str):
    """Phase 4f, one rank: join a gloo world of ``d`` ranks on ``device``
    (card 0) and serve each of ``jobs`` ((config, prompts, teacher tokens))
    in turn over the (1, d) grid, one model at a time, freed before the
    next: init from seed 0 keeping this rank's blocks, ``Engine.generate``
    of the prompts, then the yardstick run.  Saves its logits and a JSON
    record per model; on the card rank 0 also holds K4 to its plain
    version on its layer-0 q, k, v."""
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(workdir)
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    by_variant = flash_attention_fwd.launches_by_variant
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=300))
    try:
        grid = model_grid(1, d)
        for cfg, prompts, teacher in jobs:
            t0 = time.perf_counter()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=device).manual_seed(0)
            model, t_init = timed(lambda: Transformer.init_params(
                cfg, gen, device=device, group=grid))
            plen = max(len(p) for p in prompts)
            eng = Engine(cfg, model, ServeConfig(
                batch=len(prompts), max_seq=plen + SERVE_NEW), device=device)
            key = ((len(prompts), plen, model.layers[0].attn.n_heads,
                    cfg.resolved_head_dim),) * 2 + \
                (str(dtype_of(cfg.compute_dtype)), True)
            for k in kernels:
                k.launches = 0
            for v in by_variant:
                by_variant[v] = 0
            c0 = dict(grid.model.stats)
            with k4_calls() as (seen, first):
                out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
            launches = {k.__name__: k.launches for k in kernels}
            variants = dict(by_variant)
            stats = dict(eng.stats)
            c_gen = {k: grid.model.stats[k] - c0[k] for k in c0}
            toks = torch.from_numpy(left_padded(prompts)).to(device)
            with moe_routes() as routes:
                logits, rec = yardstick(eng.model, toks, teacher.to(device),
                                        eng.scfg.max_seq, grid.model)
            torch.save([e for e, _ in host_routes(routes)],
                       work / f"rank{rank}_{cfg.name}_routes.pt")
            del routes
            k4_yard = flash_attention_fwd.launches - launches[
                "flash_attention_fwd"]
            torch.save(logits, work / f"rank{rank}_{cfg.name}.pt")
            info = {"rank": rank, "arch": cfg.name, "n_layers": cfg.n_layers,
                    "moe_impl": cfg.moe_impl,
                    "capacity_factor": cfg.capacity_factor,
                    "params_held": sum(p.numel()
                                       for p in model.parameters()),
                    "param_bytes_held": nbytes(*model.parameters()),
                    "serving_copy_bytes": nbytes(*eng.model.parameters()),
                    "seconds_init": t_init, "tokens": out,
                    "seconds_generate": t_gen,
                    "prefill_seconds": stats["prefill_seconds"],
                    "decode_seconds_per_token": stats["decode_seconds"]
                    / stats["decode_steps"],
                    "collectives_generate": c_gen, "yardstick_run": rec,
                    "launches": launches, "k4_launches_by_variant": variants,
                    "k4_launches_yardstick": k4_yard,
                    "k4_local_shape": list(key[0])}
            if on_card:
                info["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated()
            check(seen == [key] * cfg.n_layers,
                  f"phase 4f rank {rank} {cfg.name}: K4 calls {seen}, want "
                  f"{key} {cfg.n_layers} times")
            if rank == 0 and on_card:
                info["k4_on_path_inputs"] = k4_on_path_inputs(*first[key])
            del first, model, eng, logits
            info["seconds"] = time.perf_counter() - t0
            (work / f"rank{rank}_{cfg.name}.json").write_text(
                json.dumps(info))
            dist.barrier()      # one model on the card at a time
    finally:
        dist.destroy_process_group()


def phase_sharded_lm(dev, yards):
    """Phase 4f: qwen2.5-3b and qwen3-moe (phase 4c's cut, ``expert_tp``)
    served over two gloo ranks sharing the card, each held to the d = 1
    yardstick phases 4 and 4c wrote (``yards``: {arch: {"logits",
    "teacher", "tokens", "prompts"}}).  The ranks count their own
    launches.  Returns K4's launches in the phase (both ranks) and rank
    0's K4 rows at the local shapes."""
    import shutil
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase4f"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lines, total = [], 0
    try:
        jobs = [(sharded_lm_config(*m), yards[m[0]]["prompts"],
                 yards[m[0]]["teacher"].cpu()) for m in SHARDED_LM_MODELS]
        run_ranks(sharded_lm_rank, SHARDED_LM_RANKS, SHARDED_LM_JOIN_SECONDS,
                  "phase 4f", str(work), jobs, dev.type)
        for arch, n_layers, impl in SHARDED_LM_MODELS:
            want, d1_tokens = yards[arch]["logits"], yards[arch]["tokens"]
            ranks = [json.loads((work / f"rank{r}_{arch}.json").read_text())
                     for r in range(SHARDED_LM_RANKS)]
            scale = float(want.abs().max())
            errs, per_row = [], []
            for r, info in enumerate(ranks):
                got = torch.load(work / f"rank{r}_{arch}.pt")
                check(bool(torch.isfinite(got).all()) and
                      got.shape == want.shape,
                      f"phase 4f rank {r} {arch}: logits {tuple(got.shape)}")
                errs.append(max_abs(got, want))
                per_row.append((got.double() - want.double()).abs()
                               .amax(-1))                      # (B, 1 + n)
                n = info["n_layers"]
                la = info["launches"]
                check(la["flash_attention_fwd"] == n and
                      info["k4_launches_by_variant"]["sm90_wgmma"] == n and
                      info["k4_launches_yardstick"] == n,
                      f"phase 4f rank {r} {arch}: K4 {la}, "
                      f"{info['k4_launches_by_variant']}, yardstick "
                      f"{info['k4_launches_yardstick']}: not once a layer "
                      f"a prefill through sm90_wgmma")
                check(not any(c for k, c in la.items()
                              if k != "flash_attention_fwd"),
                      f"phase 4f rank {r} {arch} launched graph kernels: "
                      f"{la}")
                total += la["flash_attention_fwd"] + \
                    info["k4_launches_yardstick"]
            # DECODE_TOL, but ROUTED_STEP_TOL for a row's decode step whose
            # token chose other experts than d = 1's in some layer
            limit = torch.full_like(per_row[0], DECODE_TOL)
            flips = None
            if "routes" in yards[arch]:
                got = [torch.load(work / f"rank{r}_{arch}_routes.pt")
                       for r in range(SHARDED_LM_RANKS)]
                check(all(len(g) == len(got[0]) and
                          all(torch.equal(a, b) for a, b in zip(g, got[0]))
                          for g in got),
                      f"phase 4f {arch}: the ranks routed differently")
                flips = route_flips(yards[arch]["routes"],
                                    [(e, None) for e in got[0]],
                                    ranks[0]["n_layers"])
                check(flips["flip_share"] <= ROUTE_FLIP_LIMIT,
                      f"phase 4f {arch}: routings unlike d=1's {flips}")
                flipped = torch.tensor(flips["step_rows_flipped"]).T  # (B, n)
                limit[:, 1:][flipped] = ROUTED_STEP_TOL
            per_position = [p.amax(0).tolist() for p in per_row]
            check(all(bool((p <= limit * scale).all()) for p in per_row),
                  f"phase 4f {arch}: d=2 logits vs d=1 by row "
                  f"{[p.tolist() for p in per_row]} over {limit.tolist()} "
                  f"x {scale}")
            check(all(r["tokens"] == ranks[0]["tokens"] for r in ranks),
                  f"phase 4f {arch}: the ranks generated other tokens")
            k4 = ranks[0].pop("k4_on_path_inputs")
            prompts = yards[arch]["prompts"]
            same = sum(a == b for o, w, p in zip(ranks[0]["tokens"],
                                                 d1_tokens, prompts)
                       for a, b in zip(o[len(p):], w[len(p):]))
            lines.append({"arch": arch, "moe_impl": impl,
                          "yardstick_max_abs_diff": errs,
                          "yardstick_per_position": per_position,
                          "yardstick_max_abs_logit": scale,
                          "yardstick_per_row": per_row[0].tolist(),
                          "tolerance_per_row": (limit * scale).tolist(),
                          "routing_vs_d1": flips,
                          "new_tokens_equal_to_d1": same,
                          "new_tokens": len(prompts) * SERVE_NEW,
                          "k4_on_path_inputs": k4,
                          "per_rank": [{k: v for k, v in r.items()
                                        if k != "tokens"} for r in ranks]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "sharded_lm", "ranks": SHARDED_LM_RANKS,
          "backend": "gloo", "grid": [1, SHARDED_LM_RANKS], "models": lines,
          "k4_launches": total, "seconds": time.perf_counter() - t0})
    return {"flash_attention_fwd": total}, [
        {"arch": line["arch"], **line["k4_on_path_inputs"]}
        for line in lines]


# phase 4d: the xLSTM, whisper and VLM families
WHISPER_PROMPTS = (416, 320, 224, 128)   # + SERVE_NEW within 448 positions
WHISPER_CONTEXT = 448     # whisper's decoder positions
VLM_LAYERS = 24           # internvl2-26b's depth on one card (of 48)
XLSTM_STEP_TOKENS = 256   # layer 0's chunk-against-step check
XLSTM_BF16_TOL = 2e-2     # chunk vs step in bf16, relative to max|value|
XLSTM_F32_TOL = 1e-4      # the same in float32
XLSTM_F32_DECODE_TOL = 2e-3   # 128 decode steps vs forward in float32
                              # (tests/test_models.py's rtol)
XLSTM_BF16_DECODE_TOL = 8e-2  # the same steps in bf16: the reference's own
                              # drift at full width, 7.64% of the largest
                              # logit (probes/xlstm_bf16_drift.py --full)


@torch.no_grad()
def greedy(model, batch, max_seq, n_new, enc_out=None):
    """``Engine.generate``'s loop for a batch it does not take (frames,
    patches): ``prefill``, then ``n_new`` greedy ``decode_step``s at
    positions from P + S, one host read a token.  Returns (the new ids, a
    list per row; prefill seconds to the first read; decode seconds; the
    last logits)."""
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_seq)
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    pos = batch["tokens"].shape[1] + model.cfg.n_patches
    out, t_first = [], None
    for _ in range(n_new):
        out.append(cur[:, 0].tolist())
        if t_first is None:
            t_first = time.perf_counter()
        logits, cache = model.decode_step(cache, cur, pos, enc_out=enc_out)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos += 1
    sync()
    return [list(r) for r in zip(*out)], t_first - t0, \
        time.perf_counter() - t_first, logits


def rel_err(got, want) -> float:
    scale = float(want.double().abs().max())
    return max_abs(got, want) / scale if scale else max_abs(got, want)


@torch.no_grad()
def xlstm_chunk_vs_step(model, tokens, compute) -> dict:
    """Layer 0's chunked ``mlstm_train`` (block 0) and ``slstm_train``
    (block 1) in ``compute`` against a token-by-token replay of
    ``*_decode`` from the zero cache: outputs and terminal states, each
    within its tolerance of the largest value."""
    from repro_torch.models import xlstm as X
    from repro_torch.models.layers import embed_apply, norm_apply
    cfg = model.cfg
    tol = XLSTM_F32_TOL if compute == torch.float32 else XLSTM_BF16_TOL
    blk = model.layers[0]
    x = embed_apply(model.embed["tok"], tokens, compute)
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        h = norm_apply(blk.ln.row(i), x, cfg.norm)
        mix = blk.mixer(i)
        train, step, init = (X.mlstm_train, X.mlstm_decode,
                             X.mlstm_init_cache) if kind == "mlstm" else \
            (X.slstm_train, X.slstm_decode, X.slstm_init_cache)
        y, st = train(mix, h, cfg, return_state=True)
        cache = init(h.shape[0], cfg.d_model, cfg, device=h.device)
        ys = []
        for t in range(h.shape[1]):
            y1, cache = step(mix, h[:, t:t + 1], cfg, cache)
            ys.append(y1)
        errs = {"output": rel_err(torch.cat(ys, dim=1), y)}
        errs.update({k: rel_err(cache[k], st[k]) for k in st})
        check(all(e <= tol for e in errs.values()),
              f"xLSTM layer 0 {kind} chunk vs step ({compute}): relative "
              f"errors {errs} > {tol}")
        out[kind] = errs
        x = x + y
    return {"tokens": int(tokens.shape[1]), "tolerance": tol, **out}


def serve_xlstm(dev, profile):
    """xlstm-350m at full width and depth behind ``Engine`` with phase 4's
    prompts; chunk against step at layer 0; decode against forward."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import xlstm as X
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    cfg = get_config("xlstm-350m")
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    check(len(model.layers) * len(cfg.block_pattern) == cfg.n_layers == 24
          and cfg.d_model == 1024, "xlstm-350m at full depth and width")
    eng = Engine(cfg, model, ServeConfig(batch=4, max_seq=max(SERVE_PROMPTS)
                                         + SERVE_NEW), device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
    stats = dict(eng.stats)
    check(all(len(o) == len(p) + SERVE_NEW and o[:len(p)] == p
              for o, p in zip(out, prompts)),
          f"xlstm: each output is its prompt plus {SERVE_NEW} tokens")
    check(all(0 <= tok < cfg.vocab_size for o in out for tok in o),
          "xlstm: token ids in [0, vocab)")
    check(bool(torch.isfinite(eng.last_logits).all()), "xlstm: finite logits")
    again, t_again = timed(lambda: eng.generate(prompts, SERVE_NEW))
    check(again == out, "xlstm: a second generate gives the same tokens")
    stats_again = dict(eng.stats)

    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, XLSTM_STEP_TOKENS)).astype(np.int32)).to(dev)
    steps = {"bf16": xlstm_chunk_vs_step(eng.model, toks, torch.bfloat16),
             "f32": xlstm_chunk_vs_step(model, toks, torch.float32)}
    # decode vs forward.  bf16: the reference's invariant, a prefill of
    # S - 1 = 127 tokens (one chunk of 127) and one step.  float32: a
    # prefill of 128 and 128 teacher-forced steps, within the reference
    # test's rtol; the same steps in bf16 within the drift the reference's
    # own bf16 numerics show over them at this width
    b, s = DECODE_CHECK
    check_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                  .astype(np.int32)).to(dev)
    chunk = X.CHUNK
    dvf = decode_vs_forward(eng.model, {"tokens": check_toks[:, :chunk]},
                            chunk - 1)
    dvf_steps = decode_vs_forward(eng.model, {"tokens": check_toks}, chunk,
                                  tol=XLSTM_BF16_DECODE_TOL)
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    try:
        dvf_f32 = decode_vs_forward(model, {"tokens": check_toks}, chunk,
                                    tol=XLSTM_F32_DECODE_TOL)
    finally:
        model.cfg = cfg
    rec = {}
    if profile:
        batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev)}
        held = {}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), eng.model.prefill(batch, eng.scfg.max_seq))),
            {}, top=8)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: eng.model.decode_step(held["cache"], cur,
                                          max(SERVE_PROMPTS)), {}, top=8)
    new_tokens = len(prompts) * stats["decode_steps"]
    return {"arch": cfg.name, "blocks": cfg.n_layers,
            "block_pattern": list(cfg.block_pattern), "d_model": cfg.d_model,
            "params": sum(t.numel() for t in model.parameters()),
            "param_bytes": nbytes(*model.parameters()),
            "seconds_init": t_init, "prompt_lens": list(SERVE_PROMPTS),
            "seconds_generate": t_gen, "seconds_generate_again": t_again,
            "prefill_seconds": stats["prefill_seconds"],
            "decode_seconds_per_token": stats["decode_seconds"]
            / stats["decode_steps"],
            "decode_tokens_per_second": new_tokens / stats["decode_seconds"],
            "prefill_seconds_again": stats_again["prefill_seconds"],
            "decode_seconds_per_token_again": stats_again["decode_seconds"]
            / stats_again["decode_steps"],
            "chunk_vs_step": steps, "decode_vs_forward": dvf,
            "decode_vs_forward_f32_steps": dvf_f32,
            "decode_vs_forward_bf16_steps": dvf_steps, **rec,
            "seconds": time.perf_counter() - t0}


def check_outputs(arch, new, n_rows, vocab, logits):
    check(len(new) == n_rows and all(len(r) == SERVE_NEW for r in new),
          f"{arch}: {SERVE_NEW} new tokens for each of {n_rows} rows")
    check(all(0 <= tok < vocab for r in new for tok in r),
          f"{arch}: token ids in [0, vocab)")
    check(bool(torch.isfinite(logits).all()), f"{arch}: finite logits")


def serve_whisper(dev, profile, yards=None):
    """whisper-small at full width and depth: stub frames (4, 1536, 768),
    decoder prompts of ``WHISPER_PROMPTS`` ids, 32 greedy tokens through
    ``prefill``, ``encode`` and ``decode_step``; decode against forward.
    With ``yards`` (a dict), also phase 4j's d = 1 yardstick into it."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    t0 = time.perf_counter()
    cfg = get_config("whisper-small")
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    check(len(model.layers) == cfg.n_layers == 12 and
          len(model.enc["layers"]) == cfg.n_enc_layers == 12 and
          cfg.d_model == 768 and cfg.resolved_head_dim == 64,
          "whisper-small at full depth and width, D = 64")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_unpadded, n).tolist()
               for n in WHISPER_PROMPTS]
    check(max(WHISPER_PROMPTS) + SERVE_NEW <= WHISPER_CONTEXT,
          "whisper: prompt plus new tokens within its decoder context")
    frames = torch.randn((4, cfg.enc_seq_len, cfg.d_model), generator=gen,
                         device=dev)
    batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev),
             "enc_embeds": frames}

    def generate():
        t = time.perf_counter()
        enc = model.encode(frames)
        sync()
        t_enc = time.perf_counter() - t
        return (t_enc,) + greedy(model, batch, WHISPER_CONTEXT, SERVE_NEW,
                                 enc_out=enc)

    (t_enc, new, t_pre, t_dec, logits), t_gen = timed(generate)
    check_outputs(cfg.name, new, 4, cfg.vocab_size, logits)
    (_, again, t_pre2, t_dec2, _), t_again = timed(generate)
    check(again == new, "whisper: a second generation gives the same tokens")

    b, s = DECODE_CHECK
    check_batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_unpadded, (b, s))
                                   .astype(np.int32)).to(dev),
        "enc_embeds": torch.randn((b, cfg.enc_seq_len, cfg.d_model),
                                  generator=gen, device=dev)}
    dvf = decode_vs_forward(model, check_batch, s - 1,
                            enc_out=model.encode(check_batch["enc_embeds"]))
    rec = {}
    if yards is not None:   # phase 4j's d = 1 run on this model
        (yards[cfg.name], _), rec["seconds_heads_yardstick"] = timed(
            lambda: heads_yardstick(model, heads_inputs(cfg), dev))
    if profile:
        k4 = {"k4": ("flash_fwd",)}
        held = {}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), model.prefill(batch, WHISPER_CONTEXT))),
            k4, top=8)
        enc = model.encode(frames)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: model.decode_step(held["cache"], cur,
                                      max(WHISPER_PROMPTS), enc_out=enc),
            k4, top=8)
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
            "head_dim": cfg.resolved_head_dim, "enc_frames": cfg.enc_seq_len,
            "params": sum(t.numel() for t in model.parameters()),
            "param_bytes": nbytes(*model.parameters()),
            "seconds_init": t_init, "prompt_lens": list(WHISPER_PROMPTS),
            "seconds_generate": t_gen, "seconds_generate_again": t_again,
            "encode_seconds": t_enc, "prefill_seconds": t_pre,
            "decode_seconds_per_token": t_dec / SERVE_NEW,
            "decode_tokens_per_second": 4 * SERVE_NEW / t_dec,
            "prefill_seconds_again": t_pre2,
            "decode_seconds_per_token_again": t_dec2 / SERVE_NEW,
            "decode_vs_forward": dvf, **rec,
            "seconds": time.perf_counter() - t0}


def serve_vlm(dev, profile, yards=None):
    """internvl2-26b at full width, ``VLM_LAYERS`` of its layers, f32
    parameters: patch embeddings (4, 256, 6144) before phase 4's prompts,
    32 greedy tokens from position P + S; decode against forward.  With
    ``yards`` (a dict), also phase 4j's d = 1 yardstick into it."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    t0 = time.perf_counter()
    full = get_config("internvl2-26b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)   # depth is the cut
    check(cfg.param_dtype == "float32" and cfg.compute_dtype == "bfloat16",
          "internvl2: f32 parameters, bf16 compute")
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    check(len(model.layers) == VLM_LAYERS and cfg.d_model == 6144,
          f"internvl2: {VLM_LAYERS} layers at full width")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_unpadded, n).tolist()
               for n in SERVE_PROMPTS]
    patches = torch.randn((4, cfg.n_patches, cfg.d_model), generator=gen,
                          device=dev)
    batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev),
             "patch_embeds": patches}
    max_seq = cfg.n_patches + max(SERVE_PROMPTS) + SERVE_NEW
    (new, t_pre, t_dec, logits), t_gen = timed(
        lambda: greedy(model, batch, max_seq, SERVE_NEW))
    check_outputs(cfg.name, new, 4, cfg.vocab_size, logits)
    (again, t_pre2, t_dec2, _), t_again = timed(
        lambda: greedy(model, batch, max_seq, SERVE_NEW))
    check(again == new, "internvl2: a second generation gives the same "
          "tokens")
    b, s = DECODE_CHECK
    check_batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_unpadded, (b, s))
                                   .astype(np.int32)).to(dev),
        "patch_embeds": torch.randn((b, cfg.n_patches, cfg.d_model),
                                    generator=gen, device=dev)}
    dvf = decode_vs_forward(model, check_batch, s - 1)
    peak = torch.cuda.max_memory_allocated()
    rec = {}
    if yards is not None:   # phase 4j's d = 1 run on this model
        (yards[cfg.name], _), rec["seconds_heads_yardstick"] = timed(
            lambda: heads_yardstick(model, heads_inputs(cfg), dev))
    if profile:
        k4 = {"k4": ("flash_fwd",)}
        held = {}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), model.prefill(batch, max_seq))), k4, top=8)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: model.decode_step(held["cache"], cur, max_seq - SERVE_NEW),
            k4, top=8)
    kv = 2 * VLM_LAYERS * 4 * max_seq * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2
    return {"arch": cfg.name, "n_layers": VLM_LAYERS,
            "n_layers_published": full.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "n_patches": cfg.n_patches,
            "params": sum(t.numel() for t in model.parameters()),
            "param_bytes": nbytes(*model.parameters()),
            "params_published": full.param_count(),
            "kv_cache_bytes": kv, "memory_allocated_before": mem_before,
            "max_memory_allocated": peak, "seconds_init": t_init,
            "prompt_lens": list(SERVE_PROMPTS), "prefill_positions":
            cfg.n_patches + max(SERVE_PROMPTS),
            "seconds_generate": t_gen, "seconds_generate_again": t_again,
            "prefill_seconds": t_pre,
            "decode_seconds_per_token": t_dec / SERVE_NEW,
            "decode_tokens_per_second": 4 * SERVE_NEW / t_dec,
            "prefill_seconds_again": t_pre2,
            "decode_seconds_per_token_again": t_dec2 / SERVE_NEW,
            "decode_vs_forward": dvf, **rec,
            "seconds": time.perf_counter() - t0}


def phase_families(dev, kernels, profile):
    """Phase 4d: serve xlstm-350m, whisper-small and internvl2-26b (cut in
    depth) in turn, in one launch window, with phase 4j's d = 1 yardsticks
    of the last two; then, outside it, hold K4 to its plain version on the
    q, k, v of each distinct call the models' layer 0 gave it (whisper:
    encoder, decoder self- and cross-attention).  Returns the window's
    launches, K4's rows at those shapes and the yardsticks ({arch: logits
    on the host})."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    by_variant = flash_attention_fwd.launches_by_variant
    variants_before = dict(by_variant)
    lines, calls, yards = [], {}, {}
    for arch, serve in (("xlstm-350m", serve_xlstm),
                        ("whisper-small", functools.partial(
                            serve_whisper, yards=yards)),
                        ("internvl2-26b", functools.partial(
                            serve_vlm, yards=yards))):
        before = flash_attention_fwd.launches
        with k4_calls() as (seen, first):
            line = serve(dev, profile)
        line["k4_launches"] = flash_attention_fwd.launches - before
        line["k4_calls"] = sorted({str(key): seen.count(key)
                                   for key in set(seen)}.items())
        lines.append(line)
        calls[arch] = (seen, first)
        torch.cuda.empty_cache()
    launches = {k.__name__: k.launches for k in kernels}
    wgmma = by_variant["sm90_wgmma"] - variants_before["sm90_wgmma"]

    wcfg, vcfg = get_config("whisper-small"), get_config("internvl2-26b")
    n_enc, n_dec, n_vlm = wcfg.n_enc_layers, wcfg.n_layers, VLM_LAYERS
    per_prefill = n_enc + 2 * n_dec      # whisper: encoder, self, cross
    # two generations (encode + prefill), the check's forward, prefill and
    # encode, phase 4j's yardstick (prefill and encode) (+ the profile's
    # prefill and encode)
    want = {"xlstm-350m": 0,
            "whisper-small": (3 + profile) * (n_enc + per_prefill)
            + 2 * per_prefill + n_enc,
            "internvl2-26b": (5 + profile) * n_vlm}
    for line in lines:
        check(line["k4_launches"] == want[line["arch"]],
              f"phase 4d: {line['arch']} launched K4 {line['k4_launches']} "
              f"times, not {want[line['arch']]}")
    total = sum(want.values())
    check(launches["flash_attention_fwd"] == total == wgmma,
          f"phase 4d: K4 launched {launches['flash_attention_fwd']} times "
          f"({wgmma} through sm90_wgmma), not {total}")
    check(not any(c for name, c in launches.items()
                  if name != "flash_attention_fwd"),
          f"phase 4d launched graph kernels: {launches}")
    # whisper's on-path shapes: D = 64, non-causal, Sq != Sk
    heads = (wcfg.n_heads, wcfg.resolved_head_dim)
    wq = (4, max(WHISPER_PROMPTS)) + heads
    wk = (4, wcfg.enc_seq_len) + heads
    whisper_keys = {"encoder": (wk, wk, False),
                    "decoder_self": (wq, wq, True),
                    "cross": (wq, wk, False)}
    vlm_q = (4, vcfg.n_patches + max(SERVE_PROMPTS), vcfg.n_heads,
             vcfg.resolved_head_dim)
    want_keys = {"whisper-small": whisper_keys,
                 "internvl2-26b": {"decoder": (vlm_q, vlm_q, True)}}
    check(not calls["xlstm-350m"][0], "phase 4d: xLSTM called attention")
    k4_rows = []
    for arch, keys in want_keys.items():
        seen, first = calls[arch]
        for role, (qs, ks, causal) in keys.items():
            key = (qs, ks, "torch.bfloat16", causal)
            check(key in first, f"phase 4d: {arch} never called K4 at "
                  f"{key}; saw {sorted(set(seen))}")
            q, k, v = first.pop(key)
            k4_rows.append({"arch": arch, "role": role,
                            **k4_on_path_inputs(q, k, v, causal)})
            del q, k, v
        first.clear()
    emit({"phase": "families", "models": lines, "launches": launches,
          "k4_launches_predicted": want, "k4_on_path_inputs": k4_rows,
          "seconds": time.perf_counter() - t0})
    return launches, k4_rows, yards


# phase 4e: jamba's hybrid period at full width
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_PERIOD = 4        # attn_every: the reference's reduced() rule (min(8, 4))
MAMBA_CHECK_CHUNK = 64   # train vs decode: 4 chunks of DECODE_CHECK's 256
MAMBA_TOL = (1e-4, 1e-3)   # atol, rtol: test_mamba_decode_matches_train_tail's


@contextlib.contextmanager
def moe_near_ties():
    """Count, for each routing of the MoE layers (``models.moe.route``),
    the tokens whose k-th and (k+1)-th router probabilities, recomputed in
    float64, lie within ``MOE_NEAR_TIE``: one (tokens, device count) pair
    a routing, appended to the yielded list."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def spy(p, x, cfg, *args, **kwargs):
        t, k = x.shape[0] * x.shape[1], cfg.experts_per_token
        logits = x.reshape(t, -1).double() @ p.router.w.double()
        top = torch.softmax(logits, dim=-1).topk(k + 1, dim=-1).values
        seen.append((t, (top[:, k - 1] - top[:, k] < MOE_NEAR_TIE).sum()))
        return real(p, x, cfg, *args, **kwargs)

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


def allclose_rule(got, want, atol, rtol) -> dict:
    """``numpy.testing.assert_allclose``'s rule, |got - want| <= atol +
    rtol·|want| everywhere, with the largest |got - want| and the largest
    excess over rtol·|want|."""
    d = (got.double() - want.double()).abs()
    excess = float((d - rtol * want.double().abs()).max())
    return {"ok": excess <= atol, "max_abs_diff": float(d.max()),
            "max_excess": excess}


@torch.no_grad()
def mamba_train_vs_decode(model, tokens) -> dict:
    """Layer 0's first Mamba at full width in float32, on its own path
    input (the period's first pre-norm of the token embeddings): the
    chunked ``mamba_train`` (chunk ``MAMBA_CHECK_CHUNK``, the log-depth
    scan) against ``mamba_decode`` stepped over the same tokens from the
    zero cache, outputs and terminal states, by the reference test's rule
    (atol 1e-4, rtol 1e-3); and the chunked terminal ``h`` against a plain
    recomputation: the recurrence ``h = dA·h + dBu`` over the unchunked
    sequence's (dA, dBu), one token at a time."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    from repro_torch.models.layers import dense, embed_apply, norm_apply
    cfg = model.cfg
    blk = model.layers[0]
    mix = ssm.Mamba(cfg.d_model, cfg, device=tokens.device)
    mix.load_state_dict(blk.mamba[0].state_dict())         # float32 copy
    x = norm_apply(blk.mix_ln.row(0), embed_apply(
        model.embed["tok"], tokens, torch.float32), cfg.norm)
    b, s = tokens.shape
    y, st = ssm.mamba_train(mix, x, cfg, chunk=MAMBA_CHECK_CHUNK,
                            return_state=True)
    cache = ssm.mamba_init_cache(b, cfg.d_model, cfg, torch.float32,
                                 device=tokens.device)
    ys = []
    for t in range(s):
        y1, cache = ssm.mamba_decode(mix, x[:, t:t + 1], cfg, cache)
        ys.append(y1)
    u = F.silu(ssm._causal_conv(dense(mix.in_proj, x, torch.float32),
                                mix.conv_w))
    da, dbu, _ = ssm._ssm_params(mix, u, torch.float32)
    h = torch.zeros_like(st["h"])
    for t in range(s):
        h = da[:, t] * h + dbu[:, t]
    del u, da, dbu
    atol, rtol = MAMBA_TOL
    out = {"shape": [b, s, cfg.d_model], "chunk": MAMBA_CHECK_CHUNK,
           "mixer_bytes": nbytes(*mix.parameters()),
           "output": allclose_rule(torch.cat(ys, dim=1), y, atol, rtol),
           "h_vs_decode": allclose_rule(cache["h"], st["h"], atol, rtol),
           "conv_vs_decode": allclose_rule(cache["conv"], st["conv"], atol,
                                           rtol),
           "h_vs_plain": allclose_rule(st["h"], h, atol, rtol),
           "h_vs_plain_rel": rel_err(st["h"], h)}
    for key in ("output", "h_vs_decode", "conv_vs_decode", "h_vs_plain"):
        check(out[key]["ok"], f"jamba: full-width Mamba {key} outside "
              f"atol {atol} + rtol {rtol}: {out[key]}")
    return out


def phase_hybrid(dev, kernels, profile):
    """Phase 4e: jamba-1.5-large at full width, one period cut to
    ``attn_every = 4`` (3 Mamba mixers, then attention; MoE on sub-layers
    1 and 3, MLP on 0 and 2), bf16, behind ``Engine`` with phase 4's
    prompts, in a launch window of its own; then, outside it, K4 on the
    attention layer's own q, k, v.  Returns the window's launches and
    K4's row at that shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    by_variant = flash_attention_fwd.launches_by_variant
    variants_before = dict(by_variant)
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, attn_every=HYBRID_PERIOD,
                              n_layers=HYBRID_PERIOD)   # one period: the cut
    check(cfg.param_dtype == cfg.compute_dtype == "bfloat16" and
          (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.n_experts, cfg.ssm_expand * cfg.d_model) ==
          (8192, 64, 8, 24576, 16, 16384),
          "jamba: full width, bf16 parameters and compute")
    n_params = sum(t.numel() for t in
                   Transformer(cfg, device="meta").parameters())
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    param_bytes = nbytes(*model.parameters())
    blk = model.layers[0]
    check(len(model.layers) == 1 and (len(blk.mamba), len(blk.moe),
                                      len(blk.mlp)) == (3, 2, 2),
          "jamba: one period of 3 Mamba mixers, 2 MoE and 2 MLP FFNs")
    check(sum(t.numel() for t in model.parameters()) == n_params,
          "jamba: the meta count is the model's")
    max_seq = max(SERVE_PROMPTS) + SERVE_NEW
    eng = Engine(cfg, model, ServeConfig(batch=4, max_seq=max_seq),
                 device=dev)
    check(eng.model is model, "jamba: the engine made a weight copy")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    plen = max(SERVE_PROMPTS)
    want_shape = (4, plen, cfg.n_heads, cfg.resolved_head_dim)
    key = (want_shape, want_shape, "torch.bfloat16", True)
    with k4_calls() as (seen, first), moe_drops() as drops, \
            moe_near_ties() as ties:
        out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
    stats = dict(eng.stats)
    drops_generate = n_dropped(drops)
    check(seen == [key], f"jamba: K4 calls {seen}, want {key} once")
    k4_inputs = first.pop(key)
    check(all(len(o) == len(p) + SERVE_NEW and o[:len(p)] == p
              for o, p in zip(out, prompts)),
          f"jamba: each output is its prompt plus {SERVE_NEW} tokens")
    check(all(0 <= tok < cfg.vocab_size for o in out for tok in o),
          "jamba: token ids in [0, vocab)")
    check(bool(torch.isfinite(eng.last_logits).all()), "jamba: finite logits")
    again, t_again = timed(lambda: eng.generate(prompts, SERVE_NEW))
    check(again == out, "jamba: a second generate gives the same tokens")
    stats_again = dict(eng.stats)
    peak = torch.cuda.max_memory_allocated()

    b, s = DECODE_CHECK
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)
                                         ).astype(np.int32)).to(dev)
    mamba, t_mamba = timed(lambda: mamba_train_vs_decode(model, toks))
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts /
                                  cfg.experts_per_token)
    model.cfg = no_drop
    try:
        with moe_drops() as dvf_drops, moe_near_ties() as dvf_ties:
            dvf = decode_vs_forward(model, {"tokens": toks}, s - 1)
        check(n_dropped(dvf_drops) == 0, f"jamba: drops at capacity factor "
              f"{no_drop.capacity_factor}")
    finally:
        model.cfg = cfg
    rec = {}
    if profile:   # one prefill of the batch, one decode step
        top = {"k4": ("flash_fwd",)}
        batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev)}
        held = {}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), model.prefill(batch, max_seq))), top, top=8)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: model.decode_step(held["cache"], cur, plen), top, top=8)
        del held
    launches = {k.__name__: k.launches for k in kernels}
    wgmma = by_variant["sm90_wgmma"] - variants_before["sm90_wgmma"]
    # two generates, the check's forward and prefill (+ the profile's)
    want = 4 + profile
    check(launches["flash_attention_fwd"] == want == wgmma,
          f"phase 4e: K4 launched {launches['flash_attention_fwd']} times "
          f"({wgmma} through sm90_wgmma), not {want}")
    check(not any(c for name, c in launches.items()
                  if name != "flash_attention_fwd"),
          f"phase 4e launched graph kernels: {launches}")

    def tie_counts(rows):   # decode routes the batch's B <= 4 tokens
        return {"sequence": sum(int(c) for t, c in rows if t > 4),
                "decode": sum(int(c) for t, c in rows if t <= 4)}

    new_tokens = len(prompts) * stats["decode_steps"]
    del eng, model, blk
    torch.cuda.empty_cache()
    q, k, v = k4_inputs
    k4_row = {"arch": HYBRID_ARCH, "role": "attention (sub-layer 3)",
              **k4_on_path_inputs(q, k, v)}
    del q, k, v, k4_inputs
    emit({"phase": "hybrid", "arch": HYBRID_ARCH,
          "attn_every": HYBRID_PERIOD, "attn_every_published":
          full.attn_every, "n_layers": cfg.n_layers,
          "n_layers_published": full.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "d_ff": cfg.d_ff, "n_experts": cfg.n_experts,
          "experts_per_token": cfg.experts_per_token,
          "d_inner": cfg.ssm_expand * cfg.d_model,
          "ssm_state_dim": cfg.ssm_state_dim, "vocab_size": cfg.vocab_size,
          "params": n_params, "param_bytes": param_bytes,
          "params_published_period": dataclasses.replace(
              full, n_layers=full.attn_every).param_count(),
          "params_cut_config": cfg.param_count(),
          "memory_allocated_before": mem_before,
          "max_memory_allocated": peak, "seconds_init": t_init,
          "capacity_prefill": moe.capacity(4 * plen, cfg),
          "capacity_decode": moe.capacity(4, cfg),
          "assignments_dropped_generate": drops_generate,
          "near_ties_generate": tie_counts(ties),
          "near_ties_decode_vs_forward": tie_counts(dvf_ties),
          "k4_launches": want, "k4_shape": list(want_shape),
          "seconds_generate": t_gen, "seconds_generate_again": t_again,
          "prefill_seconds": stats["prefill_seconds"],
          "decode_seconds_per_token": stats["decode_seconds"]
          / stats["decode_steps"],
          "decode_tokens_per_second": new_tokens / stats["decode_seconds"],
          "prefill_seconds_again": stats_again["prefill_seconds"],
          "decode_seconds_per_token_again": stats_again["decode_seconds"]
          / stats_again["decode_steps"],
          "mamba_train_vs_decode": mamba, "seconds_mamba_check": t_mamba,
          "decode_vs_forward": {"capacity_factor": no_drop.capacity_factor,
                                **dvf},
          **rec, "launches": launches, "k4_on_path_inputs": k4_row,
          "seconds": time.perf_counter() - t0})
    return launches, [k4_row]


# phase 4m: the two largest dense configs at full width and depth
DENSE_CONFIGS = ("mistral-nemo-12b", "starcoder2-15b")
# their float32 weights (49.0 and 63.8 GB) beside Engine's bf16 copy do not
# fit the card: the weights are drawn in bf16, which Engine serves as they
# are (PERF.md section 4)
DENSE_CONFIGS_OVER = {"param_dtype": "bfloat16"}


def serve_dense(dev, arch, profile) -> tuple:
    """Phase 4m for one config: ``arch`` at its published width and depth,
    bf16 weights from seed 0 (``DENSE_CONFIGS_OVER``), behind ``Engine``
    with phase 4's batch and prompts; phase 4's checks.  Returns its line
    and layer 0's K4 inputs of the first ``generate``; the model is freed
    on return."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, **DENSE_CONFIGS_OVER)
    check(cfg.family == "dense" and cfg.n_layers == 40 and
          cfg.compute_dtype == "bfloat16",
          f"{arch}: 40 dense layers, bf16 compute")
    n_params = sum(t.numel() for t in
                   Transformer(cfg, device="meta").parameters())
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(cfg, gen,
                                                          device=dev))
    check(len(model.layers) == cfg.n_layers and model.param_dtype ==
          torch.bfloat16 and sum(t.numel() for t in model.parameters())
          == n_params, f"{arch}: {cfg.n_layers} bf16 layers, the meta "
          f"count's {n_params} parameters")
    param_bytes = nbytes(*model.parameters())
    max_seq = max(SERVE_PROMPTS) + SERVE_NEW
    eng = Engine(cfg, model, ServeConfig(batch=4, max_seq=max_seq),
                 device=dev)
    check(eng.model is model, f"{arch}: the engine made a weight copy")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    plen = max(SERVE_PROMPTS)
    want_shape = (4, plen, cfg.n_heads, cfg.resolved_head_dim)
    key = (want_shape, want_shape, "torch.bfloat16", True)
    by_variant = flash_attention_fwd.launches_by_variant
    k4_before, wgmma_before = (flash_attention_fwd.launches,
                               by_variant["sm90_wgmma"])
    with k4_calls() as (seen, first):
        out, t_gen = timed(lambda: eng.generate(prompts, SERVE_NEW))
    k4 = flash_attention_fwd.launches - k4_before
    wgmma = by_variant["sm90_wgmma"] - wgmma_before
    stats = dict(eng.stats)
    check(k4 == wgmma == cfg.n_layers, f"{arch}: K4 launched {k4} times "
          f"({wgmma} through sm90_wgmma) in one generate, not once per "
          f"layer ({cfg.n_layers})")
    check(seen == [key] * cfg.n_layers,
          f"{arch}: K4 calls {set(seen)}, want {key} {cfg.n_layers} times")
    k4_inputs = first.pop(key)
    check(all(len(o) == len(p) + SERVE_NEW and o[:len(p)] == p
              for o, p in zip(out, prompts)),
          f"{arch}: each output is its prompt plus {SERVE_NEW} tokens")
    check(all(0 <= tok < cfg.vocab_size for o in out for tok in o),
          f"{arch}: token ids in [0, {cfg.vocab_size})")
    check(bool(torch.isfinite(eng.last_logits).all()),
          f"{arch}: finite logits")
    again, t_again = timed(lambda: eng.generate(prompts, SERVE_NEW))
    check(again == out, f"{arch}: a second generate gives the same tokens")
    stats_again = dict(eng.stats)
    b, s = DECODE_CHECK
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)
                                         ).astype(np.int32)).to(dev)
    dvf = decode_vs_forward(model, {"tokens": toks}, s - 1)
    rec = {}
    if profile:   # one prefill of the batch, one decode step
        top = {"k4": ("flash_fwd",)}
        batch = {"tokens": torch.from_numpy(left_padded(prompts)).to(dev)}
        held = {}
        rec["profile_prefill"] = device_busy(lambda: held.update(zip(
            ("logits", "cache"), model.prefill(batch, max_seq))), top, top=8)
        cur = torch.argmax(held["logits"][:, -1], dim=-1)[:, None]
        rec["profile_decode_step"] = device_busy(
            lambda: model.decode_step(held["cache"], cur, plen), top, top=8)
        del held
    peak = torch.cuda.max_memory_allocated()
    new_tokens = len(prompts) * stats["decode_steps"]
    del eng, model
    line = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "act": cfg.act, "norm": cfg.norm,
            "qkv_bias": cfg.qkv_bias, "params": n_params,
            "param_bytes": param_bytes, "param_dtype": cfg.param_dtype,
            "param_dtype_published": full.param_dtype,
            "memory_allocated_before": mem_before,
            "max_memory_allocated": peak, "seconds_init": t_init,
            "k4_launches_generate": k4, "k4_shape": list(want_shape),
            "seconds_generate": t_gen, "seconds_generate_again": t_again,
            "prefill_seconds": stats["prefill_seconds"],
            "decode_seconds_per_token": stats["decode_seconds"]
            / stats["decode_steps"],
            "decode_tokens_per_second": new_tokens / stats["decode_seconds"],
            "prefill_seconds_again": stats_again["prefill_seconds"],
            "decode_seconds_per_token_again": stats_again["decode_seconds"]
            / stats_again["decode_steps"],
            "decode_vs_forward": dvf, **rec,
            "seconds": time.perf_counter() - t0}
    return line, k4_inputs


def phase_dense_configs(dev, kernels, profile):
    """Phase 4m: each config of ``DENSE_CONFIGS`` served in turn at full
    width and depth (:func:`serve_dense`), one model on the card at a time,
    in one launch window; then, outside it, K4 held to its plain version on
    the q, k, v that each model's layer 0 gave it.  Returns the window's
    launches and K4's rows at those shapes."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    wgmma_before = flash_attention_fwd.launches_by_variant["sm90_wgmma"]
    lines, k4_inputs, n = [], [], 0
    for arch in DENSE_CONFIGS:
        gc.collect()        # graphs in reference cycles can hold the card
        torch.cuda.empty_cache()
        line, qkv = serve_dense(dev, arch, profile)
        lines.append(line)
        k4_inputs.append((arch, qkv))
        n += line["n_layers"]
        del qkv
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k.__name__: k.launches for k in kernels}
    wgmma = flash_attention_fwd.launches_by_variant["sm90_wgmma"] - \
        wgmma_before
    # two generates, the check's forward and prefill (+ the profile's)
    want = (4 + profile) * n
    check(launches["flash_attention_fwd"] == want == wgmma,
          f"phase 4m: K4 launched {launches['flash_attention_fwd']} times "
          f"({wgmma} through sm90_wgmma), not {want}")
    check(not any(c for name, c in launches.items()
                  if name != "flash_attention_fwd"),
          f"phase 4m launched graph kernels: {launches}")
    k4_rows = []
    for arch, (q, k, v) in k4_inputs:
        k4_rows.append({"arch": arch, **k4_on_path_inputs(q, k, v)})
        del q, k, v
    del k4_inputs
    emit({"phase": "dense_configs", "models": lines, "launches": launches,
          "k4_on_path_inputs": k4_rows, "seconds": time.perf_counter() - t0})
    return launches, k4_rows


# phase 4g: the dry run, and rank 0 of one production-mesh cell on the card
DRYRUN_CELL = ("qwen2.5-3b", "prefill_32k")
DRYRUN_K4_SHAPE = (2, 32768, 1, 128)   # rank 0's heads after the GQA repeat
# (ok, skipped, error) of the single- and two-pod sweeps: every arch
# serves prefill and decode and trains (the sharded train step;
# qwen1.5-4b's and whisper's heads as whole heads), the giant models and
# jamba with their weights 2-D, and the ssm and hybrid families run
# long_500k too (their sLSTM loop counted one middle step for all); the
# others skip long_500k (tests/test_torch_dryrun.py lists the cells)
DRYRUN_STATUS = (64, 16, 0)
RINGO_CELLS = ("pagerank_twitter", "pagerank_twitter_2d")
RINGO_TOL = 1e-6   # card vs CPU, relative to the largest value


def dryrun_sweep() -> dict:
    """Phase 4g (a): ``--list`` and the two sweeps in-process."""
    import tempfile
    from repro_torch.launch import dryrun
    from repro_torch.launch.ringo_cells import GRAPHS, run_ringo_cell
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        check(dryrun.main(["--list"]) == 0, "dryrun --list failed")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out, \
            contextlib.redirect_stdout(io.StringIO()):
        rc = dryrun.main(["--all", "--mesh", "both", "--out", out])
        cells = [json.loads(f.read_text()) for f in sorted(Path(out).iterdir())]
    t_sweep = time.perf_counter() - t0
    status = {k: sum(c["status"] == k for c in cells)
              for k in ("ok", "skipped", "error")}
    check(rc == (1 if status["error"] else 0) and
          tuple(status.values()) == DRYRUN_STATUS,
          f"dry run: {status} cells ok / skipped / error, want "
          f"{DRYRUN_STATUS}")
    cell = next(c for c in cells if (c["arch"], c["shape"]) == DRYRUN_CELL
                and not c["multi_pod"])
    ringo = []
    for name in GRAPHS:
        for mp in (False, True):
            r = run_ringo_cell(name, mp)
            ringo.append({k: r.get(k) for k in (
                "shape", "multi_pod", "status", "n_chips", "shard",
                "collective_bytes_per_device", "wire_bytes_per_device",
                "bytes_per_device", "memory")})
    return {"list": listing.getvalue().splitlines(), "status": status,
            "seconds_sweep": t_sweep, "cell": {k: cell[k] for k in (
                "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "wire_bytes_per_device",
                "memory", "n_chips", "params", "compile_s")},
            "ringo": ringo}


def dryrun_cell_on_card(dev, meta_cell: dict):
    """Phase 4g (b): rank 0 of ``DRYRUN_CELL`` x single on the card, counted
    as the meta dry run counts it, then timed.  Returns its line and
    layer 0's q, k, v."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.mesh import (CollectiveLedger, counting_grid,
                                         make_production_mesh)
    from repro_torch.launch.specs import rules_for
    from repro_torch.models.transformer import Transformer
    arch, shape_name = DRYRUN_CELL
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh()
    ledger = CollectiveLedger()
    grid = counting_grid(mesh, ledger)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    model, t_init = timed(lambda: Transformer.init_params(
        cfg, gen, device=dev, group=grid,
        rules=rules_for(cfg, mesh, "prefill", shape)))
    meta_model, inputs, meta_arg_bytes = dryrun.build_cell(
        cfg, shape, mesh, "prefill")
    held = {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}
    check(held == {k: (tuple(p.shape), p.dtype)
                   for k, p in meta_model.named_parameters()},
          "phase 4g: the card's parameters are not the meta cell's")
    del meta_model
    (b, s), = {tuple(inputs[0]["tokens"].shape)}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)).to(dev)
    batch = {"tokens": tokens}
    arg_bytes = nbytes(*model.parameters(), tokens)
    check(arg_bytes == meta_arg_bytes == meta_cell["memory"]["argument_bytes"],
          f"phase 4g: argument bytes {arg_bytes} on the card, "
          f"{meta_arg_bytes} / {meta_cell['memory']['argument_bytes']} meta")
    step = dryrun.step_fn_for(cfg, "prefill")
    by_variant = flash_attention_fwd.launches_by_variant
    before = flash_attention_fwd.launches, dict(by_variant)
    sync()
    torch.cuda.reset_peak_memory_stats()
    with CostCounter(ledger) as c:
        logits, cache = step(model, batch)
        sync()
    k4_n = flash_attention_fwd.launches - before[0]
    wgmma = by_variant["sm90_wgmma"] - before[1]["sm90_wgmma"]
    check(c.cost.flops == meta_cell["flops_per_device"],
          f"phase 4g: {c.cost.flops} flops counted on the card, "
          f"{meta_cell['flops_per_device']} on meta")
    check(c.cost.collective_bytes == meta_cell["collective_bytes_per_device"]
          and c.wire_bytes == meta_cell["wire_bytes_per_device"],
          "phase 4g: the card's collectives are not the meta count's")
    check(bool(torch.isfinite(logits).all()) and
          tuple(logits.shape) == (b, 1, cfg.vocab_size),
          f"phase 4g: logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    del logits, cache
    with k4_calls() as (seen, first):
        out, t_prefill = timed(lambda: step(model, batch))
    del out
    peak = torch.cuda.max_memory_allocated() - mem_before
    key = (DRYRUN_K4_SHAPE, DRYRUN_K4_SHAPE, str(torch.bfloat16), True)
    check(k4_n == cfg.n_layers == wgmma and len(seen) == cfg.n_layers and
          set(seen) == {key},
          f"phase 4g: K4 {k4_n} launches ({wgmma} sm90_wgmma) at "
          f"{set(seen)}, want {cfg.n_layers} at {DRYRUN_K4_SHAPE}")
    qkv = first[key]
    del first, model
    return {"cell": f"{arch} x {shape_name} x single, rank 0 of "
                    f"{mesh.size}",
            "flops_counted": c.cost.flops,
            "flops_meta": meta_cell["flops_per_device"],
            "bytes_counted": c.cost.bytes,
            "bytes_meta": meta_cell["bytes_per_device"],
            "collective_bytes": c.cost.collective_bytes,
            "wire_bytes": c.wire_bytes,
            "collective_calls": c.collective_calls,
            "argument_bytes": arg_bytes,
            "seconds_init": t_init, "prefill_seconds": t_prefill,
            "prefill_tflops": c.cost.flops / t_prefill / 1e12,
            "max_memory_allocated": peak,
            "peak_bytes_meta_estimate": meta_cell["memory"]["peak_bytes"],
            "k4_launches": k4_n, "k4_launches_sm90_wgmma": wgmma,
            "k4_shape": list(DRYRUN_K4_SHAPE)}, qkv


def ringo_step_on_card(dev, name: str) -> dict:
    """Phase 4g (c): one PageRank step of rank 0 of ``name`` on the card
    and on the CPU, the same random shard (seed 0)."""
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.mesh import CollectiveLedger
    from repro_torch.launch.ringo_cells import ringo_shard
    ledger = CollectiveLedger()
    step, args, sizes, d = ringo_shard(name, device=dev, seed=0,
                                       ledger=ledger)
    with CostCounter(ledger) as c:
        got = step(*args)
        sync()
    cpu_step, cpu_args, _, _ = ringo_shard(name, device="cpu", seed=0)
    want = cpu_step(*cpu_args)
    scale = float(want.abs().max())
    err = max_abs(got.cpu(), want)
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape and
          err <= RINGO_TOL * scale,
          f"phase 4g {name}: card vs CPU max|d| {err} of {scale}")
    ms = cuda_ms(lambda: step(*args), 5)
    del args, got, cpu_args, want
    return {"shape": name, "n_ranks": d, "shard": sizes,
            "max_abs_diff_vs_cpu": err, "max_abs_cpu": scale,
            "tolerance": f"{RINGO_TOL} x max|cpu|", "ms": ms,
            "bytes_counted": c.cost.bytes,
            "bytes_per_ms": c.cost.bytes / ms,
            "collective_bytes": c.cost.collective_bytes,
            "wire_bytes": c.wire_bytes}


def phase_dryrun(dev, kernels):
    """Phase 4g: the dry run's sweeps, rank 0 of qwen2.5-3b x prefill_32k
    on the card (counted, then timed), and rank 0's PageRank step of two
    ringo cells, in a launch window of its own; then, outside it, K4 on
    the cell's layer-0 q, k, v.  Returns the window's launches and K4's
    row at that shape."""
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    sweep = dryrun_sweep()
    t_a = time.perf_counter() - t0
    cell, (q, k, v) = dryrun_cell_on_card(dev, sweep["cell"])
    torch.cuda.empty_cache()
    ringo = [ringo_step_on_card(dev, name) for name in RINGO_CELLS]
    torch.cuda.empty_cache()
    launches = {kern.__name__: kern.launches for kern in kernels}
    check(launches["flash_attention_fwd"] == 2 * cell["k4_launches"] and
          not any(n for name, n in launches.items()
                  if name != "flash_attention_fwd"),
          f"phase 4g launched {launches}: K4 twice a prefill, nothing else")
    k4_row = k4_on_path_inputs(q, k, v)
    del q, k, v
    k4_row["arch"] = f"{DRYRUN_CELL[0]} x {DRYRUN_CELL[1]} rank 0"
    emit({"phase": "dryrun", **sweep, "seconds_a": t_a, "card": cell,
          "ringo_steps": ringo, "launches": launches,
          "k4_on_path_inputs": k4_row,
          "seconds": time.perf_counter() - t0})
    return launches, [k4_row]


TRAIN_BATCH, TRAIN_SEQ = 2, 1024   # phase 4b: sequences of the random-walk corpus
TRAIN_STEPS = 5
# qwen2.5-3b's depth in phases 4b and 4h (a), of 36: the checkpoint's round
# trip through the host (~0.5 GB/s) took 178-207 s of 4b at 36 layers and
# 121-125 s at 18, and phase 4l takes 149-178 s (at 6 layers 4h (a)'s step
# 2 loss did not fall below step 0's on an H100)
TRAIN_LAYERS = 12
TRAIN_RMAT = (17, 16)   # phase 4b: R-MAT scale and edge factor of the corpus graph
TRAIN_CE_TOL = 1e-2     # step 0's ce vs the serving forward's, relative (bf16)
TRAIN_RESUME_TOL = 1e-3   # the resumed step's loss vs the uninterrupted one
TRAIN_SAVE_AFTER = 3    # checkpoint after this many steps, then resume from it


def train_config():
    """Phase 4b's model: qwen2.5-3b at full width, ``TRAIN_LAYERS``
    deep."""
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("qwen2.5-3b"),
                               n_layers=TRAIN_LAYERS)


def phase_train(dev, kernels, profile):
    """Phase 4b: train qwen2.5-3b at full width cut to ``TRAIN_LAYERS``
    on random walks over an R-MAT graph built by the engine
    (``remat="full"``, AdamW), with a checkpoint and a resume; K4 in every
    forward and recompute."""
    from repro_torch.checkpoint.store import config_hash, save_checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.core.graph import Graph
    from repro_torch.data.graph_corpus import RandomWalkCorpus
    from repro_torch.data.rmat import rmat_edges
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.train import load_train_state, train_state_tree
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    import shutil
    t0 = time.perf_counter()
    cfg = train_config()
    check(cfg.remat == "full" and cfg.optimizer == "adamw" and
          cfg.param_dtype == "float32" and cfg.compute_dtype == "bfloat16",
          f"qwen2.5-3b trains with remat {cfg.remat}, {cfg.optimizer}")
    scale, ef = TRAIN_RMAT
    s, d = rmat_edges(scale=scale, edge_factor=ef, seed=0)
    keep = s != d
    g, t_graph = timed(lambda: Graph.from_edges(s[keep], d[keep],
                                                dedupe=True, device=dev))
    check(g.n_nodes <= cfg.vocab_size, "the walks' node ids fit the vocab")
    corpus = RandomWalkCorpus(g, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in corpus.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    (model, opt_state), t_init = timed(
        lambda: init_train_state(cfg, gen, device=dev))
    check(len(model.layers) == cfg.n_layers == TRAIN_LAYERS and
          cfg.d_model == 2048 and cfg.vocab_size == 151936,
          f"qwen2.5-3b at full width, {TRAIN_LAYERS} layers")
    step_fn = make_train_step(cfg, OptHyper(), attn_chunk=TRAIN_SEQ)

    for k in kernels:
        k.launches = 0
    # the serving forward's cross entropy on step 0's batch, same weights
    b0 = batches[0]
    logits, _ = model(b0)
    lf = logits.float()
    ce_serve = float((torch.logsumexp(lf, -1) - torch.gather(
        lf, -1, b0["targets"].long()[..., None])[..., 0]).mean())
    del logits, lf
    n_fwd = 1

    def run(i):
        sync()
        t = time.perf_counter()
        _, _, m = step_fn(model, opt_state, batches[i], i)
        row = {k: float(v) for k, v in m.items()}
        sync()
        row["seconds"] = time.perf_counter() - t
        return row

    ckpt = ROOT / "build" / "phase4b"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, n_steps = [], 0
    try:
        for i in range(TRAIN_STEPS):
            steps.append(run(i))
            n_steps += 1
            if i + 1 == TRAIN_SAVE_AFTER:
                _, t_save = timed(lambda: save_checkpoint(
                    str(ckpt), i + 1, train_state_tree(model, opt_state),
                    meta={"config": config_hash(cfg)}))
        start, t_load = timed(lambda: load_train_state(str(ckpt), model,
                                                       opt_state, cfg))
        check(start == TRAIN_SAVE_AFTER, f"resumed at step {start}")
        resumed = run(start)
        n_steps += 1
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rec = {}
    if profile:
        rec["profile_step"] = device_busy(lambda: step_fn(
            model, opt_state, batches[start + 1], start + 1),
            {"k4": ("flash_fwd",)}, top=12)
        n_steps += 1
    peak = torch.cuda.max_memory_allocated()
    k4 = flash_attention_fwd.launches
    launches = {k.__name__: k.launches for k in kernels}
    per_step = 2 * cfg.n_layers          # the forward and remat's recompute
    want_k4 = n_steps * per_step + n_fwd * cfg.n_layers
    check(k4 == want_k4, f"phase 4b: K4 launched {k4} times, not "
          f"{n_steps} steps x {per_step} + {n_fwd} x {cfg.n_layers}")
    check(not any(n for name, n in launches.items()
                  if name != "flash_attention_fwd"),
          f"phase 4b launched graph kernels: {launches}")
    ce0 = steps[0]["ce"]
    check(abs(ce0 - ce_serve) <= TRAIN_CE_TOL * abs(ce_serve),
          f"phase 4b: step 0's ce {ce0} vs the serving forward's {ce_serve}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in steps + [resumed]), "phase 4b: a non-finite loss or "
          "gradient norm")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"phase 4b: step {TRAIN_STEPS - 1}'s loss {steps[-1]['loss']} is "
          f"not below step 0's {steps[0]['loss']}")
    d_resume = abs(resumed["loss"] - steps[start]["loss"])
    check(d_resume <= TRAIN_RESUME_TOL, f"phase 4b: the resumed step "
          f"{start}'s loss {resumed['loss']} vs {steps[start]['loss']}")
    warm = [r["seconds"] for r in steps[1:]]
    step_s = statistics.median(warm)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
          "params": sum(p.numel() for p in model.parameters()),
          "remat": cfg.remat, "optimizer": cfg.optimizer,
          "corpus": {"rmat_scale": scale, "edge_factor": ef,
                     "nodes": g.n_nodes, "edges": g.n_edges,
                     "seconds_graph": t_graph},
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
          "resumed_step": resumed, "resume_abs_diff": d_resume,
          "ce_serving_forward": ce_serve,
          "seconds_save": t_save, "seconds_load": t_load,
          "seconds_init": t_init, "step_seconds_median": step_s,
          "tokens_per_second": tokens / step_s,
          "memory_allocated_before": mem_before,
          "max_memory_allocated": peak, "k4_launches": k4,
          "k4_launches_predicted": want_k4, **rec,
          "seconds": time.perf_counter() - t0})
    baseline = {"steps": steps, "batches": [{k: v.cpu() for k, v in b.items()}
                                            for b in batches]}
    del model, opt_state, batches
    return launches, baseline


# phase 4h: the sharded train step, gloo ranks sharing the card
SHARDED_TRAIN_JOIN_SECONDS = 600.0
SHARDED_TRAIN_RUNS = (
    # (run, arch, layers kept (None: all), (data, model), steps, overrides)
    ("a", "qwen2.5-3b", TRAIN_LAYERS, (1, 2), 3, {}),
    ("b", "qwen2.5-3b", 6, (2, 2), 3, {}),
    ("c", "qwen3-moe-235b-a22b", 2, (1, 2), 2,
     {"moe_impl": "expert_tp", "capacity_factor": 1.25}),
)
SHARDED_TRAIN_LOSS_TOL = {"a": 1e-2, "b": 1e-2, "c": 2e-2}   # vs d = 1
SHARDED_TRAIN_NORM_TOL = 5e-2   # (a): the gradient norm vs phase 4b's
SHARDED_TRAIN_MEMORY = 72e9     # the reckoning's ceiling over all ranks


def sharded_train_config(arch, n_layers, over):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if n_layers:
        over = dict(over, n_layers=n_layers)
    return dataclasses.replace(cfg, **over)


def sharded_train_reckoning(cfg, data: int, model: int, arch=None,
                            batch: int = TRAIN_BATCH,
                            seq: int = TRAIN_SEQ) -> dict:
    """The bytes one rank of a (data, model) grid should hold at its peak
    in a step on ``batch`` rows of ``seq`` tokens: its parameter blocks;
    their gradients in the parameters' dtype and reduced to float32 ZeRO
    blocks; its ZeRO optimizer state; the logits of its rows (the
    gathered compute-dtype logits, a VLM's patch rows too, as the head
    computes them before ``_forward`` slices them off, then the tokens'
    float32 twice in the loss and its gradient).  Counted on the meta
    device.  With ``arch``, phase 4i's 2-D rules (:func:`two_d_rules`): a
    2-D block's gradient is its float32 reduced block alone (the gather's
    backward writes no ``grad``), and one layer's weights gathered whole
    over "data" add to the peak."""
    from repro_torch.launch.mesh import ModelGrid, ModelGroup
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import zero
    grid = ModelGrid(ModelGroup(data, 0), ModelGroup(model, 0))
    m = Transformer(cfg, device="meta", group=grid,
                    rules=two_d_rules(arch, grid, "train") if arch else None)
    lay = zero.layout(m)
    params = nbytes(*m.parameters())
    grads = nbytes(*(p for p in m.parameters() if not hasattr(p, "data_dim")))
    reduced = sum(4 * lay[k].zblock(p).numel()      # new float32 tensors
                  for k, p in m.named_parameters()
                  if data > 1 or p.dtype != torch.float32 or
                  len(lay[k].members) > 1)
    state = nbytes(*(t for *_, t in zero._state_leaves(
        zero.init_state(cfg.optimizer, m))))
    rows = batch // data * cfg.vocab_size
    logits = rows * ((seq + cfg.n_patches) *
                     dtype_of(cfg.compute_dtype).itemsize + seq * (4 + 4))
    gathered = gathered_bytes(m, data)
    rank = params + grads + reduced + state + logits + gathered
    return {"params": params, "grads": grads, "grads_reduced_f32": reduced,
            "state": state, "logits": logits, "gathered": gathered,
            "rank": rank, "all_ranks": rank * data * model}


def gathered_bytes(m, data: int) -> int:
    """The most a rank of ``m`` holds gathered whole over "data" at once:
    layer 0's 2-D blocks or the table's, ``data`` times; 0 with no 2-D
    weight."""
    layer = sum(data * nbytes(p) for k, p in m.named_parameters()
                if k.startswith("layers.0.") and hasattr(p, "data_dim"))
    table = m.embed["tok"].table
    return max(layer, data * nbytes(table) if hasattr(table, "data_dim")
               else 0)


def train_one_rank(dev, cfg, batches, steps: int) -> list:
    """The d = 1 yardstick: ``steps`` steps of ``cfg`` from seed 0 on the
    whole batches, in this process, freed after."""
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    gen = torch.Generator(device=dev).manual_seed(0)
    model, state = init_train_state(cfg, gen, device=dev)
    step_fn = make_train_step(cfg, OptHyper(), attn_chunk=TRAIN_SEQ)
    out = []
    for i in range(steps):
        b = {k: v.to(dev) for k, v in batches[i].items()}
        _, _, m = step_fn(model, state, b, i)
        out.append({k: float(v) for k, v in m.items()})
    del model, state
    torch.cuda.empty_cache()
    return out


def checksum(t: torch.Tensor) -> list:
    """Two int64 sums of a tensor's 32- or 16-bit words (on its device):
    equal bits give equal sums."""
    w = t.detach().contiguous()
    w = w.view(torch.int16 if w.element_size() == 2 else torch.int32).long()
    return [int(w.sum()), int((w * w).sum())]


def sharded_train_rank(rank: int, d: int, workdir: str, run: str, cfg,
                       shape, steps: int, batches, device: str):
    """Phase 4h, one rank: join a gloo world of ``d`` ranks on ``device``
    (card 0), lay it out as the (data, model) grid ``shape``, draw the
    one-rank model's weights from seed 0 keeping this rank's blocks, and
    take ``steps`` sharded train steps on this data shard's rows of
    ``batches``.  Writes a JSON record: each step's metrics, seconds, K4
    launches (by variant and shape) and collectives by phase; peak memory;
    the checksums of what ranks share; the ZeRO state's elements beside
    the blocks'; the bytes the gradients' reduction over "data"
    received."""
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import model_grid
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    work = Path(workdir)
    by_variant = flash_attention_fwd.launches_by_variant
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=300))
    try:
        data, model = shape
        grid = model_grid(data, model)
        gen = torch.Generator(device=device).manual_seed(0)
        (m, state), t_init = timed(lambda: init_train_state(
            cfg, gen, device=device, grid=grid))
        step_fn = make_train_step(cfg, OptHyper(), attn_chunk=TRAIN_SEQ)
        lay = zero.layout(m)
        di = grid.data.rank
        rows = []
        for i in range(steps):
            n = batches[i]["tokens"].shape[0] // data
            mine = {k: v[di * n:(di + 1) * n].to(device)
                    for k, v in batches[i].items()}
            flash_attention_fwd.launches = 0
            for v in by_variant:
                by_variant[v] = 0
            before = {ax: copy.deepcopy(g.phase_stats)
                      for ax, g in (("model", grid.model),
                                    ("data", grid.data))}
            sync()
            t = time.perf_counter()
            with k4_calls() as (seen, _):
                _, _, met = step_fn(m, state, mine, i)
                row = {k: float(v) for k, v in met.items()}
            sync()
            row["seconds"] = time.perf_counter() - t
            row["k4_launches"] = flash_attention_fwd.launches
            row["k4_by_variant"] = dict(by_variant)
            row["k4_shapes"] = sorted({str(list(k[0])) for k in seen})
            row["collectives"] = {
                ax: {ph: {k: v - before[ax].get(ph, {}).get(k, 0)
                          for k, v in st.items()}
                     for ph, st in g.phase_stats.items()}
                for ax, g in (("model", grid.model), ("data", grid.data))}
            rows.append(row)
        params = dict(m.named_parameters())
        shared = [k for k in params
                  if re.search(r"(norm|ln)[^.]*\.scale$|router\.w$|"
                               r"attn\.w[kv]\.[wb]$", k)]
        sums = {k: checksum(params[k]) for k in
                (params if data > 1 else shared)}
        state_elems = sum(t.numel() for *_, t in zero._state_leaves(state))
        whole = [k for k, leaf in lay.items()
                 if leaf.zdim is None] if data > 1 else []
        grad_bytes = sum(4 * p.numel() for p in params.values())
        want_rs = sum(4 * p.numel() * ((data - 1) / data
                                       if lay[k].zdim is not None
                                       else data - 1)
                      for k, p in params.items())
        info = {"rank": rank, "coords": grid.coords, "steps": rows,
                "seconds_init": t_init,
                "params_held": sum(p.numel() for p in params.values()),
                "param_bytes_held": nbytes(*params.values()),
                "state_elements": state_elems,
                "state_bytes": nbytes(*(t for *_, t in
                                        zero._state_leaves(state))),
                "zero_split_leaves": len(lay) - len(whole) if data > 1
                else 0,
                "zero_whole_leaves": whole,
                "zero_half": all(
                    2 * lay[k].zblock(p).numel() == p.numel()
                    for k, p in params.items() if lay[k].zdim is not None),
                "grad_bytes_f32": grad_bytes,
                "grad_reduce_received_predicted": want_rs,
                "holders": {k: lay[k].holders for k in shared},
                "checksums": sums}
        if on_card:
            info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        (work / f"rank{rank}.json").write_text(json.dumps(info))
        del m, state, params
    finally:
        dist.destroy_process_group()


def _same_checksums(ranks, leaf_filter) -> bool:
    """The ranks that hold the same block of a leaf (same model index, or
    the same holders) report the same checksums for it."""
    for k in ranks[0]["checksums"]:
        if not leaf_filter(k):
            continue
        for a in ranks:
            for b in ranks:
                ma, mb = a["coords"]["model"][0], b["coords"]["model"][0]
                held = a.get("holders", {}).get(k)
                if (ma == mb or held is not None and
                        held == b["holders"][k]) and \
                        a["checksums"][k] != b["checksums"][k]:
                    return False
    return True


@contextlib.contextmanager
def pre_clip_grads(keep, dtype=torch.float32):
    """Record the gradients a train step clips, before it clips them:
    ``train/step.py``'s one-rank step's, or ``train/zero.py``'s after its
    model-axis sums and its reduction over "data" (the float32 gradient of
    the rank's block).  The yielded dict gets, at each step taken inside,
    a host copy in ``dtype`` of each leaf whose name ``keep`` accepts."""
    from repro_torch.train import step as step_mod
    from repro_torch.train import zero
    real, got = zero.clip_by_global_norm, {}

    def spy(grads, *args, **kwargs):
        got.update({k: g.detach().to("cpu", dtype, copy=True)
                    for k, g in grads.items() if keep(k)})
        return real(grads, *args, **kwargs)

    step_mod.clip_by_global_norm = zero.clip_by_global_norm = spy
    try:
        yield got
    finally:
        step_mod.clip_by_global_norm = zero.clip_by_global_norm = real


def grad_block(leaf) -> list:
    """[(dim, start, size)]: the narrows that cut a one-rank parameter to
    the rank's block of it (``train/zero.Leaf``): its range on the model
    dim, then on a 2-D weight's "data" dim.  A leaf whose ZeRO block
    splits it over "data" has no such cut here."""
    if leaf.zdim is not None:
        raise ValueError("a ZeRO block's gradient is not the rank's block")
    out = []
    if leaf.mdim is not None:
        out.append((leaf.mdim, *leaf.mrange))
    if leaf.ddim is not None:
        n = leaf.full[leaf.ddim] // leaf.wd
        out.append((leaf.ddim, leaf.w_rank * n, n))
    return out


def leaf_grad_gaps(rec, want) -> dict:
    """{leaf: ||g - g1|| / ||g1||} (float32, on ``g1``'s device) of a rank's
    recorded gradients ``rec`` ({leaf: {"grad": g, "block":
    :func:`grad_block`}}) against the yardstick's whole gradients ``want``
    ({leaf: g1}) cut to the rank's block."""
    out = {}
    for k, r in sorted(rec.items()):
        w = want[k]
        for dim, start, size in r["block"]:
            w = w.narrow(dim, start, size)
        g = r["grad"].to(w.device, torch.float32)
        check(g.shape == w.shape, f"{k}: a block of {tuple(g.shape)} beside "
              f"the yardstick's cut {tuple(w.shape)}")
        w = w.float()
        out[k] = float(torch.linalg.vector_norm(g - w)
                       / torch.linalg.vector_norm(w))
    return out


def leaf_grad_check(what: str, gaps, tol: float) -> None:
    """Every rank's gap of every leaf (``gaps``: a :func:`leaf_grad_gaps`
    a rank) within ``tol``, each printed first."""
    print(json.dumps({"leaf_grad_gaps": what, "limit": tol,
                      "per_rank": gaps}), flush=True)
    bad = {r: {k: v for k, v in g.items() if not v <= tol}
           for r, g in enumerate(gaps)}
    bad = {r: b for r, b in bad.items() if b}
    check(not bad, f"{what}: step 0's gradient per leaf over {tol} "
          f"relative to the yardstick's: {bad}")


def phase_sharded_train(dev, kernels, baseline):
    """Phase 4h: the sharded train step (``train/zero.py``) over gloo ranks
    sharing the card, each run held to its one-rank yardstick: (a)
    phase 4b's qwen2.5-3b (``TRAIN_LAYERS``) over (1, 2) against its
    steps (``baseline``: its metrics and batches); (b) the same cut to 12
    layers over (2, 2), ZeRO-1 over two data ranks, against a one-rank run
    in this process first; (c) qwen3-moe at full width cut to 2 layers,
    ``expert_tp``, Adafactor, bf16 parameters, over (1, 2), against a
    one-rank run.  Returns K4's launches in the phase."""
    import shutil
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase4h"
    shutil.rmtree(work, ignore_errors=True)
    batches = baseline["batches"]
    lines, k4_total = [], 0
    try:
        for run, arch, n_layers, (data, model), steps, over in \
                SHARDED_TRAIN_RUNS:
            t_run = time.perf_counter()
            cfg = sharded_train_config(arch, n_layers, over)
            for k in kernels:
                k.launches = 0
            if run == "a":
                want, t_d1 = baseline["steps"][:steps], 0.0
            else:
                want, t_d1 = timed(lambda: train_one_rank(dev, cfg, batches,
                                                          steps))
            k4_total += flash_attention_fwd.launches
            torch.cuda.empty_cache()
            reck = sharded_train_reckoning(cfg, data, model)
            held = torch.cuda.memory_allocated()
            print(json.dumps({"phase4h_reckoning": run, "grid": [data, model],
                              "parent_memory_allocated": held, **reck}),
                  flush=True)
            check(reck["all_ranks"] + held <= SHARDED_TRAIN_MEMORY,
                  f"phase 4h ({run}): {reck['all_ranks'] + held} bytes "
                  f"reckoned over the ranks")
            (work / run).mkdir(parents=True)
            run_ranks(sharded_train_rank, data * model,
                      SHARDED_TRAIN_JOIN_SECONDS, f"phase 4h ({run})",
                      str(work / run), run, cfg, (data, model), steps,
                      batches[:steps], dev.type)
            ranks = [json.loads((work / run / f"rank{r}.json").read_text())
                     for r in range(data * model)]
            tol = SHARDED_TRAIN_LOSS_TOL[run]
            for r in ranks:
                got = r["steps"]
                check(all(np.isfinite(g["loss"]) and
                          np.isfinite(g["grad_norm"]) for g in got),
                      f"phase 4h ({run}) rank {r['rank']}: not finite")
                check(all(abs(g["loss"] - w["loss"]) <= tol * abs(w["loss"])
                          for g, w in zip(got, want)),
                      f"phase 4h ({run}) rank {r['rank']}: losses "
                      f"{[g['loss'] for g in got]} vs one rank's "
                      f"{[w['loss'] for w in want]}")
                k4_total += sum(g["k4_launches"] for g in got)
            first = ranks[0]["steps"]
            if run == "a":
                check(all(abs(g["grad_norm"] - w["grad_norm"]) <=
                          SHARDED_TRAIN_NORM_TOL * w["grad_norm"]
                          for g, w in zip(first, want)),
                      f"phase 4h (a): gradient norms "
                      f"{[g['grad_norm'] for g in first]} vs phase 4b's "
                      f"{[w['grad_norm'] for w in want]}")
                check(first[-1]["loss"] < first[0]["loss"],
                      f"phase 4h (a): step {steps - 1}'s loss is not below "
                      f"step 0's")
                heads = cfg.n_heads // model
                key = str([TRAIN_BATCH, TRAIN_SEQ, heads,
                           cfg.resolved_head_dim])
                for r in ranks:
                    for g in r["steps"]:
                        check(g["k4_launches"] == 2 * cfg.n_layers and
                              g["k4_by_variant"].get("sm90_wgmma") ==
                              2 * cfg.n_layers and g["k4_shapes"] == [key],
                              f"phase 4h (a) rank {r['rank']}: K4 "
                              f"{g['k4_launches']} {g['k4_by_variant']} "
                              f"{g['k4_shapes']}, want {2 * cfg.n_layers} "
                              f"sm90_wgmma at {key} a step")
            if run == "b":
                for r in ranks:
                    check(r["zero_half"] and all(
                        re.search(r"attn\.w[qkv]\.b$", k)
                        for k in r["zero_whole_leaves"]),
                          f"phase 4h (b) rank {r['rank']}: ZeRO blocks "
                          f"{r['zero_whole_leaves']} not split in half")
                    got_rs = r["steps"][-1]["collectives"]["data"][
                        "gradients"]["received"]
                    check(got_rs == r["grad_reduce_received_predicted"],
                          f"phase 4h (b) rank {r['rank']}: the gradients' "
                          f"reduction received {got_rs} bytes, predicted "
                          f"{r['grad_reduce_received_predicted']}")
            check(_same_checksums(ranks, lambda k: True),
                  f"phase 4h ({run}): ranks differ in the bits they share")
            lines.append({
                "run": run, "arch": cfg.name, "n_layers": cfg.n_layers,
                "grid": [data, model], "optimizer": cfg.optimizer,
                "param_dtype": cfg.param_dtype, "remat": cfg.remat,
                "moe_impl": cfg.moe_impl if cfg.n_experts else None,
                "capacity_factor": cfg.capacity_factor if cfg.n_experts
                else None,
                "one_rank_steps": want, "one_rank_seconds": t_d1,
                "reckoning": reck, "parent_memory_allocated": held,
                "step_seconds": [g["seconds"] for g in first],
                "tokens_per_second": TRAIN_BATCH * TRAIN_SEQ /
                statistics.median(g["seconds"] for g in first[1:] or first),
                "per_rank": [{k: v for k, v in r.items()
                              if k not in ("checksums", "holders")}
                             for r in ranks],
                "seconds": time.perf_counter() - t_run})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "sharded_train", "backend": "gloo", "runs": lines,
          "k4_launches": k4_total, "seconds": time.perf_counter() - t0})
    return {"flash_attention_fwd": k4_total}, {
        line["run"]: line["one_rank_steps"] for line in lines}


# phase 4i: weights split over "data" (two_d_weights), gloo ranks sharing
# the card
TWO_D_GRID = (2, 2)
TWO_D_JOIN_SECONDS = 900.0
TWO_D_RUNS = (
    # (run, arch, layers kept serving, new tokens, Engine.generate,
    #  layers kept training, train steps): the serving cut to one layer,
    # and with phase 4l to 2 and 1 new tokens (7-9 s a token: every call
    # gathers the rank's blocks through the host), keeps the smoke under
    # its limit; training stays at phase 4h (c)'s 2 layers, whose one-rank
    # losses it is held to
    ("a", "qwen3-moe-235b-a22b", 1, 2, True, 2, 2),
    ("b", "grok-1-314b", 1, 1, False, 0, 0),
)
TWO_D_OVER = {"moe_impl": "expert_tp", "capacity_factor": 1.25}
# (a)'s training vs phase 4h (c)'s one-rank run (PERF.md section 6):
# step 0's loss within SHARDED_TRAIN_LOSS_TOL["c"]; on an H100 its
# gradient norm read 8.3% low, and +83% with the 2-D gradients not
# divided by d, -35% with each block keeping only its own data rank's
# part; step 1's loss read 0.16% low (those two faults 0.14% and 0.12%:
# the norm catches them, this limit only a step that goes astray).  The
# same limit holds each rank's step-0 gradient of each 2-D block, relative
# L2, to the average of one rank's gradients on the two data halves
# (two_d_halves_grad): a block left undivided by d reads 1.0
TWO_D_NORM_TOL = 0.2      # step 0's gradient norm, and per leaf, relative
TWO_D_STEP1_TOL = 5e-3    # step 1's loss, relative
TWO_D_MEMORY = 72e9       # the reckoning's ceiling over the ranks


def two_d_rules(arch, grid, kind):
    """``rules_for``'s rules for the model at its published depth: the
    cut in depth is no other deployment, and ``is_giant(cfg, 2)`` holds
    for both models there, so every weight's d_model dim is on "data"."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import rules_for
    rules = rules_for(get_config(arch), grid, kind)
    check(rules.mapping["w_embed"] == "data" and
          rules.mapping["experts"] == "model",
          f"phase 4i {arch}: rules_for gives {rules.mapping}, not 2-D "
          f"weights with experts on \"model\"")
    return rules


def two_d_padded(prompts):
    """Each prompt left-padded with token 0 to the longest: what the d = 1
    engine feeds, so every data shard sees the same positions."""
    n = max(len(p) for p in prompts)
    return [[0] * (n - len(p)) + list(p) for p in prompts]


def two_d_reckoning(cfg, arch, data: int, model: int) -> dict:
    """Phase 4i's serving: a rank's bytes at its peak, counted on the meta
    device: its 2-D blocks and one layer's weights gathered whole over
    "data" (:func:`gathered_bytes`).  Its training is
    :func:`sharded_train_reckoning` with the 2-D rules."""
    from repro_torch.launch.mesh import ModelGrid, ModelGroup
    from repro_torch.models.transformer import Transformer
    grid = ModelGrid(ModelGroup(data, 0), ModelGroup(model, 0))
    m = Transformer(cfg, device="meta", group=grid,
                    rules=two_d_rules(arch, grid, "prefill"))
    blocks, gathered = nbytes(*m.parameters()), gathered_bytes(m, data)
    rank = blocks + gathered
    return {"blocks": blocks, "gathered": gathered, "rank": rank,
            "all_ranks": rank * data * model}


@torch.no_grad()
def two_d_yardstick(dev, cfg, halves, new: int) -> dict:
    """The d = 1 yardstick of phase 4i in this process, freed after: the
    cut model from seed 0 over the one-rank grid (``expert_tp`` routes
    all its tokens, so each data shard's half runs alone, as the ranks
    route theirs): per half, ``generate`` of ``new`` tokens, then the
    prefill's last logits and ``new`` teacher-forced decode steps with
    their routings."""
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Transformer.init_params(cfg, gen, device=dev,
                                    group=model_grid(1, 1))
    out = []
    for prompts in halves:
        plen = len(prompts[0])
        eng = Engine(cfg, model, ServeConfig(batch=len(prompts),
                                             max_seq=plen + new), device=dev)
        tokens = eng.generate(prompts, new)
        toks = torch.tensor(prompts, device=dev)
        teacher = torch.tensor([t[plen:] for t in tokens], device=dev)
        with moe_routes() as routes:
            logits, rec = yardstick(model, toks, teacher, plen + new)
        out.append({"tokens": tokens, "teacher": teacher.cpu(),
                    "logits": logits, "routes": host_routes(routes),
                    "yardstick_run": rec})
    del model, eng
    torch.cuda.empty_cache()
    return out


def two_d_halves_grad(dev, cfg, shards, keep, routes=None) -> tuple:
    """Phase 4i's per-leaf yardstick in this process, freed after: the
    model from seed 0 over the one-rank grid, step 0's gradient of the
    loss on each data shard's rows ``shards`` alone (``expert_tp`` routes
    them alone, as the shard's ranks do), each shard's routings replayed
    from ``routes[i]`` where given (:func:`moe_choices`: what the shard's
    ranks chose, so that a near tie the two computations round apart
    routes alike), averaged over the shards in float32 -> ({leaf:
    gradient} of the leaves ``keep`` accepts, each shard's count of
    choices its own router made otherwise)."""
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Transformer.init_params(cfg, gen, device=dev,
                                    group=model_grid(1, 1))
    params = {k: p for k, p in model.named_parameters() if keep(k)}
    out, differed = {}, []
    for i, rows in enumerate(shards):
        model.zero_grad(set_to_none=True)
        with moe_choices(routes[i]) if routes else \
                contextlib.nullcontext([]) as seen:
            loss, _ = model.loss_fn({k: v.to(dev) for k, v in rows.items()},
                                    chunk=TRAIN_SEQ)
            loss.backward()
        differed.append(sum(seen))
        del loss
        for k, p in params.items():
            g = p.grad.float()
            out[k] = g if k not in out else out[k].add_(g)
            p.grad = None
    del model, params
    gc.collect()
    return {k: g.div_(len(shards)) for k, g in out.items()}, differed


def two_d_rank(rank: int, d: int, workdir: str, all_jobs, device: str):
    """Phase 4i, one rank: join a gloo world of ``d`` ranks on ``device``
    (card 0) as the (2, 2) grid, and for each of its ``all_jobs[rank]``
    ((run, arch, serving config, this data shard's padded prompts, its
    teacher tokens, whether to ``generate``, training config, train steps,
    its rows of the batches)): draw the cut model's weights from seed 0
    keeping this rank's 2-D blocks, ``generate``, the yardstick; then,
    with train steps, the sharded train step from seed 0 again.
    Writes its logits and routings and a JSON record per run: seconds,
    K4's launches and shapes, the collectives by axis and phase (the
    "data" axis carries the weight gathers), peak memory; rank 0 also
    K4's first q, k, v of the serving and of step 0 (layer 0's); and
    step 0's reduced gradient of each 2-D block before clipping (bf16,
    with its :func:`grad_block`) and its routings (:func:`moe_choices`).
    """
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    on_card = device == "cuda"
    if on_card:     # four ranks' caches share the card: keep few slack
        expandable_segments()
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(workdir)
    by_variant = flash_attention_fwd.launches_by_variant
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=600))

    def zero_counts():
        flash_attention_fwd.launches = 0
        for v in by_variant:
            by_variant[v] = 0

    def axes(grid):
        return {"model": grid.model.phase_stats,
                "data": grid.data.phase_stats}

    try:
        grid = model_grid(*TWO_D_GRID)
        for (run, arch, cfg, prompts, teacher, serve_generate, train_cfg,
             steps, rows) in all_jobs[rank]:
            t0 = time.perf_counter()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            rules = two_d_rules(arch, grid, "prefill")
            gen = torch.Generator(device=device).manual_seed(0)
            model, t_init = timed(lambda: Transformer.init_params(
                cfg, gen, device=device, group=grid, rules=rules))
            plen, new = len(prompts[0]), teacher.shape[1]
            eng = Engine(cfg, model, ServeConfig(batch=len(prompts),
                                                 max_seq=plen + new),
                         device=device)
            before = copy.deepcopy(axes(grid))
            zero_counts()
            out, t_gen, stats = None, None, {}
            with k4_calls() as (seen, first):
                if serve_generate:
                    out, t_gen = timed(lambda: eng.generate(prompts, new))
                    stats = dict(eng.stats)
                k4_gen = flash_attention_fwd.launches
                toks = torch.tensor(prompts, device=device)
                with moe_routes() as routes:
                    logits, rec = yardstick(model, toks, teacher.to(device),
                                            plen + new, grid.data)
            torch.save(logits, work / f"rank{rank}_{run}.pt")
            torch.save([e for e, _ in host_routes(routes)],
                       work / f"rank{rank}_{run}_routes.pt")
            if rank == 0:
                save_first_qkv(first, seen, work / f"qkv_{run}_serve.pt")
            del first
            info = {"rank": rank, "coords": grid.coords, "run": run,
                    "arch": cfg.name, "n_layers": cfg.n_layers,
                    "two_d_leaves": sum(hasattr(p, "data_dim")
                                        for p in model.parameters()),
                    "leaves": sum(1 for _ in model.parameters()),
                    "param_bytes_held": nbytes(*model.parameters()),
                    "seconds_init": t_init, "tokens": out,
                    "seconds_generate": t_gen,
                    "prefill_seconds": stats.get("prefill_seconds"),
                    "decode_seconds_per_token": stats["decode_seconds"]
                    / stats["decode_steps"] if stats else None,
                    "yardstick_run": rec,
                    "k4_launches": flash_attention_fwd.launches,
                    "k4_launches_generate": k4_gen,
                    "k4_by_variant": dict(by_variant),
                    "k4_shapes": sorted({str(list(k[0])) for k in seen}),
                    "collectives_serve": {
                        ax: {ph: {k: v - before[ax].get(ph, {}).get(k, 0)
                                  for k, v in st.items()}
                             for ph, st in g.items()}
                        for ax, g in axes(grid).items()}}
            if on_card:
                info["max_memory_allocated_serve"] = \
                    torch.cuda.max_memory_allocated()
            del model, eng, logits, routes
            if steps:
                if on_card:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                gen = torch.Generator(device=device).manual_seed(0)
                (m, state), t_init = timed(lambda: init_train_state(
                    train_cfg, gen, device=device, grid=grid,
                    rules=two_d_rules(arch, grid, "train")))
                step_fn = make_train_step(train_cfg, OptHyper(),
                                          attn_chunk=TRAIN_SEQ)
                lay = zero.layout(m)
                two_d = {k for k, leaf in lay.items()
                         if leaf.ddim is not None}
                info["train"] = []
                for i in range(steps):
                    mine = {k: v.to(device) for k, v in rows[i].items()}
                    before = copy.deepcopy(axes(grid))
                    zero_counts()
                    rec = pre_clip_grads(two_d.__contains__, torch.bfloat16) \
                        if i == 0 else contextlib.nullcontext()
                    choices = moe_choices() if i == 0 else \
                        contextlib.nullcontext()
                    sync()
                    t = time.perf_counter()
                    with k4_calls() as (seen, first), rec as got, \
                            choices as chosen:
                        _, _, met = step_fn(m, state, mine, i)
                        row = {k: float(v) for k, v in met.items()}
                    if rank == 0 and i == 0:
                        save_first_qkv(first, seen,
                                       work / f"qkv_{run}_train.pt")
                    del first
                    sync()
                    row["seconds"] = time.perf_counter() - t
                    if got is not None:
                        torch.save({k: {"grad": g, "block":
                                        grad_block(lay[k])}
                                    for k, g in got.items()},
                                   work / f"rank{rank}_{run}_grads.pt")
                        torch.save(chosen, work /
                                   f"rank{rank}_{run}_train_routes.pt")
                        del got, chosen
                    row["k4_launches"] = flash_attention_fwd.launches
                    row["k4_by_variant"] = dict(by_variant)
                    row["k4_shapes"] = sorted({str(list(k[0]))
                                               for k in seen})
                    row["collectives"] = {
                        ax: {ph: {k: v - before[ax].get(ph, {}).get(k, 0)
                                  for k, v in st.items()}
                             for ph, st in g.items()}
                        for ax, g in axes(grid).items()}
                    info["train"].append(row)
                info["train_seconds_init"] = t_init
                info["train_quarters"] = all(
                    4 * p.numel() == math.prod(p.full_shape)
                    for p in m.parameters() if hasattr(p, "data_dim") and
                    any(p.shape[i] != p.full_shape[i] and i != p.data_dim
                        for i in range(p.dim())))
                info["train_norms_checksum"] = {
                    k: checksum(p) for k, p in m.named_parameters()
                    if re.search(r"(norm|ln)[^.]*\.scale$", k)}
                if on_card:
                    info["max_memory_allocated_train"] = \
                        torch.cuda.max_memory_allocated()
                del m, state
            info["seconds"] = time.perf_counter() - t0
            (work / f"rank{rank}_{run}.json").write_text(json.dumps(info))
            dist.barrier()      # one model on the card at a time
    finally:
        dist.destroy_process_group()


def save_first_qkv(first, seen, path):
    """K4's first q, k, v (``k4_calls``' ``first`` of its first key),
    detached on the host, to ``path``."""
    torch.save([t.detach().cpu() for t in first[seen[0]]], path)


def phase_two_d(dev, kernels, train_d1, batches):
    """Phase 4i: grok-1 and qwen3-moe with every weight's d_model dim on
    "data" (``two_d_weights``, ``rules_for``'s decision for both) over
    four gloo ranks sharing the card as the (2, 2) grid (``TWO_D_RUNS``).
    (a) qwen3-moe at full width, cut to 1 layer, serves 2 new tokens
    through ``Engine.generate`` and cut to 2 trains 2 Adafactor steps;
    (b) grok-1 cut to 1 layer serves 1 (the yardstick alone).  Each is
    held to a d = 1 run of the same cut model in this process first (per
    data shard's half: ``expert_tp`` routes each shard alone), within
    phase 4f's limits; (a)'s losses to phase 4h (c)'s one-rank run
    (``train_d1``), on its batches (``batches``, one row a data rank).
    Returns K4's launches in the phase and its rows on rank 0's layer-0
    inputs (serving and step 0)."""
    import shutil
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase4i"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data, model = TWO_D_GRID
    lines, k4_total, jobs, yards, halves = [], 0, [], {}, {}
    k4_rows = []
    try:
        for run, arch, n_layers, new, serve_generate, train_layers, steps \
                in TWO_D_RUNS:
            cfg = sharded_train_config(arch, n_layers, TWO_D_OVER)
            rng = np.random.default_rng(0)      # phase 4's prompts
            prompts = two_d_padded([rng.integers(0, cfg.vocab_size,
                                                 n).tolist()
                                    for n in SERVE_PROMPTS])
            n = len(prompts) // data
            halves[run] = [prompts[i * n:(i + 1) * n] for i in range(data)]
            for k in kernels:
                k.launches = 0
            yards[run], t_d1 = timed(lambda: two_d_yardstick(
                dev, cfg, halves[run], new))
            k4_total += flash_attention_fwd.launches
            yards[run + "_seconds"] = t_d1
            jobs.append((run, arch, cfg, serve_generate,
                         sharded_train_config(arch, train_layers, TWO_D_OVER)
                         if steps else None, steps))
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        recks = {}
        for run, arch, cfg, _, train_cfg, steps in jobs:
            recks[run] = two_d_reckoning(cfg, arch, data, model)
            if steps:
                recks[run + "_train"] = sharded_train_reckoning(
                    train_cfg, data, model, arch)
            for key in (run, run + "_train"):
                if key not in recks:
                    continue
                print(json.dumps({"phase4i_reckoning": key,
                                  "grid": [data, model],
                                  "parent_memory_reserved": held,
                                  **recks[key]}), flush=True)
                check(recks[key]["all_ranks"] + held <= TWO_D_MEMORY,
                      f"phase 4i ({key}): {recks[key]['all_ranks'] + held} "
                      f"bytes reckoned over the ranks")
        per_rank_jobs = [
            [(run, arch, cfg, halves[run][r // model], yards[run][r // model]
              ["teacher"], serve_generate, train_cfg, steps,
              [{k: v[r // model:r // model + 1] for k, v in b.items()}
               for b in batches[:steps]])
             for run, arch, cfg, serve_generate, train_cfg, steps in jobs]
            for r in range(data * model)]
        run_ranks(two_d_rank, data * model, TWO_D_JOIN_SECONDS,
                  "phase 4i", str(work), per_rank_jobs, dev.type)
        for run, arch, cfg, serve_generate, train_cfg, steps in jobs:
            ranks = [json.loads((work / f"rank{r}_{run}.json").read_text())
                     for r in range(data * model)]
            heads = cfg.n_heads // model
            n_new = yards[run][0]["teacher"].shape[1]
            serve_key = str([len(halves[run][0]), len(halves[run][0][0]),
                             heads, cfg.resolved_head_dim])
            errs, flips_all = [], []
            for r, info in enumerate(ranks):
                di = r // model
                want = yards[run][di]["logits"]
                got = torch.load(work / f"rank{r}_{run}.pt")
                check(bool(torch.isfinite(got).all()) and
                      got.shape == want.shape,
                      f"phase 4i ({run}) rank {r}: logits "
                      f"{tuple(got.shape)}")
                check(info["two_d_leaves"] > 0 and
                      info["tokens"] == ranks[di * model]["tokens"],
                      f"phase 4i ({run}) rank {r}: {info['two_d_leaves']} "
                      f"2-D leaves, or tokens unlike its data shard's")
                prefills = 2 if serve_generate else 1
                check(info["k4_launches"] == prefills * cfg.n_layers and
                      info["k4_by_variant"].get("sm90_wgmma") ==
                      prefills * cfg.n_layers and
                      info["k4_shapes"] == [serve_key],
                      f"phase 4i ({run}) rank {r}: K4 {info['k4_launches']} "
                      f"{info['k4_by_variant']} {info['k4_shapes']}, want "
                      f"{prefills * cfg.n_layers} sm90_wgmma at {serve_key}")
                k4_total += info["k4_launches"]
                routes = torch.load(work / f"rank{r}_{run}_routes.pt")
                flips = route_flips(yards[run][di]["routes"],
                                    [(e, None) for e in routes],
                                    cfg.n_layers)
                check(flips["flip_share"] <= ROUTE_FLIP_LIMIT,
                      f"phase 4i ({run}) rank {r}: routings unlike d=1's "
                      f"{flips}")
                per_row = (got.double() - want.double()).abs().amax(-1)
                limit = torch.full_like(per_row, DECODE_TOL)
                flipped = torch.tensor(flips["step_rows_flipped"]).T
                limit[:, 1:][flipped] = ROUTED_STEP_TOL
                scale = float(want.abs().max())
                check(bool((per_row <= limit * scale).all()),
                      f"phase 4i ({run}) rank {r}: logits vs d=1 by row "
                      f"{per_row.tolist()} over {limit.tolist()} x {scale}")
                errs.append(per_row.tolist())
                flips_all.append(flips["flip_share"])
                for g in info.get("train", []):
                    check(g["k4_by_variant"].get("sm90_wgmma") ==
                          g["k4_launches"] == 2 * train_cfg.n_layers and
                          g["k4_shapes"] == [str([1, TRAIN_SEQ, heads,
                                                  cfg.resolved_head_dim])],
                          f"phase 4i ({run}) rank {r}: train K4 "
                          f"{g['k4_launches']} {g['k4_shapes']}")
                    k4_total += g["k4_launches"]
            if steps:
                for r in ranks:
                    got = r["train"]
                    check(all(np.isfinite(g["loss"]) and
                              np.isfinite(g["grad_norm"]) for g in got),
                          f"phase 4i ({run}) rank {r['rank']}: not finite")
                    for i, key, tol in (
                            (0, "loss", SHARDED_TRAIN_LOSS_TOL["c"]),
                            (0, "grad_norm", TWO_D_NORM_TOL),
                            (1, "loss", TWO_D_STEP1_TOL)):
                        check(abs(got[i][key] - train_d1[i][key]) <=
                              tol * abs(train_d1[i][key]),
                              f"phase 4i ({run}) rank {r['rank']}: step "
                              f"{i}'s {key} {got[i][key]} vs one rank's "
                              f"{train_d1[i][key]}, over {tol} relative")
                    check(r["train_quarters"],
                          f"phase 4i ({run}) rank {r['rank']}: a leaf split "
                          f"over both axes is not a quarter")
                check(all(r["train_norms_checksum"] ==
                          ranks[0]["train_norms_checksum"] for r in ranks),
                      f"phase 4i ({run}): the ranks' norms differ")
                # step 0's 2-D blocks against the averaged halves' gradient
                files = [work / f"rank{r}_{run}_grads.pt"
                         for r in range(data * model)]
                names = set().union(*(torch.load(f, mmap=True)
                                      for f in files))
                torch.cuda.empty_cache()
                chosen = [torch.load(work / f"rank{h * model}_{run}_"
                                     f"train_routes.pt")
                          for h in range(data)]
                (want, differed), t_halves = timed(
                    lambda: two_d_halves_grad(
                        dev, train_cfg, [{k: v[h:h + 1] for k, v in
                                          batches[0].items()}
                                         for h in range(data)],
                        names.__contains__, chosen))
                del chosen
                gaps = [leaf_grad_gaps(torch.load(f, mmap=True), want)
                        for f in files]
                del want
                torch.cuda.empty_cache()
                leaf_grad_check(f"phase 4i ({run})", gaps, TWO_D_NORM_TOL)
            lines.append({
                "run": run, "arch": cfg.name, "n_layers": cfg.n_layers,
                "train_n_layers": train_cfg.n_layers if steps else None,
                "generate": serve_generate,
                "new_tokens_equal_to_d1": sum(
                    a == b for r in range(0, data * model, model)
                    for o, w in zip(ranks[r]["tokens"],
                                    yards[run][r // model]["tokens"])
                    for a, b in zip(o[-n_new:], w[-n_new:]))
                if serve_generate else None,
                "grid": [data, model], "new_tokens": n_new,
                "moe_impl": cfg.moe_impl,
                "capacity_factor": cfg.capacity_factor,
                "reckoning": recks[run],
                "reckoning_train": recks.get(run + "_train"),
                "parent_memory_reserved": held,
                "one_rank_seconds": yards[run + "_seconds"],
                "one_rank_yardstick": [y["yardstick_run"]
                                       for y in yards[run]],
                "yardstick_per_row": errs, "flip_share": flips_all,
                "train_one_rank": train_d1[:steps] if steps else None,
                "leaf_grad_gaps": gaps if steps else None,
                "halves_choices_differed": differed if steps else None,
                "seconds_halves_yardstick": t_halves if steps else None,
                "per_rank": [{k: v for k, v in r.items()
                              if k not in ("tokens",
                                           "train_norms_checksum")}
                             for r in ranks]})
            for use in ("serve", "train"):
                f = work / f"qkv_{run}_{use}.pt"
                if f.exists():
                    q, k, v = (t.to(dev) for t in torch.load(f))
                    k4_rows.append({"arch": cfg.name, "use": use,
                                    **k4_on_path_inputs(q, k, v)})
                    del q, k, v
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "two_d", "backend": "gloo", "grid": list(TWO_D_GRID),
          "runs": lines, "k4_launches": k4_total,
          "k4_on_path_inputs": k4_rows, "seconds": time.perf_counter() - t0})
    return {"flash_attention_fwd": k4_total}, k4_rows


# phase 4j: attention's heads over model ranks that do not split them
# evenly (whole heads a rank), and the audio and vlm families sharded
HEADS_RANKS = 8              # gloo ranks on the one card: (a), (b) over (1, 8)
HEADS_VLM_RANKS = 2          # (c) over (1, 2): ranks 0 and 1 (lm_rank's)
HEADS_JOIN_SECONDS = 600.0
HEADS_BATCH = 2
HEADS_DENSE_LAYERS = 8       # qwen1.5-4b's depth in phase 4j (of 40)
HEADS_PROMPT = {"qwen1.5-4b": 512, "whisper-small": 64, "internvl2-26b": 128}


def heads_config(arch):
    """Phase 4j's config of ``arch``: qwen1.5-4b cut to
    ``HEADS_DENSE_LAYERS``, whisper-small whole, internvl2-26b cut to
    ``VLM_LAYERS`` as phase 4d cuts it."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    cut = {"qwen1.5-4b": HEADS_DENSE_LAYERS,
           "internvl2-26b": VLM_LAYERS}.get(arch)
    return dataclasses.replace(cfg, n_layers=cut) if cut else cfg


def heads_inputs(cfg) -> dict:
    """Phase 4j's inputs for ``cfg`` on the host, from seed 0:
    ``HEADS_BATCH`` prompts of ``HEADS_PROMPT`` ids, ``YARD_STEPS`` teacher
    ids each, whisper's stub frames or the VLM's patches."""
    rng = np.random.default_rng(0)
    b, s = HEADS_BATCH, HEADS_PROMPT[cfg.name]
    vocab = min(getattr(cfg, "vocab_unpadded", 0) or cfg.vocab_size,
                cfg.vocab_size)
    out = {"tokens": torch.from_numpy(
               rng.integers(0, vocab, (b, s)).astype(np.int32)),
           "teacher": torch.from_numpy(
               rng.integers(0, vocab, (b, YARD_STEPS)).astype(np.int64))}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq_len, cfg.d_model), dtype=np.float32))
    if cfg.n_patches:
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model), dtype=np.float32))
    return out


@torch.no_grad()
def heads_yardstick(model, inputs, dev, group=None) -> tuple:
    """``prefill`` of ``inputs``' prompts (with their frames or patches),
    then a teacher-forced ``decode_step`` per teacher column (whisper's
    against ``encode``'s output) -> ((B, 1 + n, V) float32 on the host,
    the host seconds of each part and, with ``group``, its collectives'
    counts, bytes and seconds in each)."""
    cfg = model.cfg
    batch = {k: v.to(dev) for k, v in inputs.items() if k != "teacher"}
    teacher = inputs["teacher"].to(dev)
    s = batch["tokens"].shape[1] + cfg.n_patches
    n = teacher.shape[1]

    def snap():
        sync()
        return time.perf_counter(), dict(group.stats) if group else {}

    marks = [snap()]
    logits, cache = model.prefill(batch, s + n)
    rows = [logits[:, -1].float()]
    marks.append(snap())
    enc = model.encode(batch["enc_embeds"]) if cfg.is_encoder_decoder \
        else None
    marks.append(snap())
    for j in range(n):
        logits, cache = model.decode_step(cache, teacher[:, j:j + 1], s + j,
                                          enc_out=enc)
        rows.append(logits[:, -1].float())
    marks.append(snap())
    rec = {}
    for i, part in enumerate(("prefill", "encode", "decode")):
        (t0, c0), (t1, c1) = marks[i], marks[i + 1]
        per = n if part == "decode" else 1
        rec[f"{part}_seconds"] = (t1 - t0) / per   # decode: a token's
        if group:
            rec[f"collectives_{part}"] = {k: (c1[k] - c0[k]) / per
                                          for k in c0}
    return torch.stack(rows, 1).cpu(), rec


def heads_want_k4(cfg, heads: int) -> dict:
    """{(q shape, k shape, dtype, causal): launches} a rank holding
    ``heads`` query heads makes in :func:`heads_yardstick` (none without a
    head): whisper's encoder twice (prefill, ``encode``) non-causal,
    decoder self-attention causal and cross-attention non-causal at D =
    64; the others' layers causal, KV repeated to the query heads."""
    if heads == 0:
        return {}
    b, d = HEADS_BATCH, cfg.resolved_head_dim
    s = HEADS_PROMPT[cfg.name] + cfg.n_patches
    q = (b, s, heads, d)
    bf = str(torch.bfloat16)
    if not cfg.is_encoder_decoder:
        return {(q, q, bf, True): cfg.n_layers}
    e = (b, cfg.enc_seq_len, heads, d)
    return {(e, e, bf, False): 2 * cfg.n_enc_layers,
            (q, q, bf, True): cfg.n_layers, (q, e, bf, False): cfg.n_layers}


def rank_widths(model) -> dict:
    """What a rank of a sharded model holds: its attention's query and KV
    heads, or an xLSTM's mLSTM heads, and a recurrent family's share of
    the inner channels (:func:`lm_rank`'s record)."""
    blk = model.layers[0]
    if model.cfg.family == "ssm":
        return {"heads": blk.mixer(0).n_heads,
                "inner": blk.mixer(1).r_h.w.shape[1]}
    out = {"heads": blk.attn.n_heads, "kv_heads": model.kv_heads}
    if model.cfg.family == "hybrid":
        out["inner"] = blk.mamba[0].d_skip.shape[0]
    return out


def lm_rank(rank: int, d: int, workdir: str, jobs, device: str):
    """Phases 4j and 4k, one rank: join a gloo world of ``d`` ranks on
    ``device`` (card 0) and run each of ``jobs`` ((label, config, model
    ranks m, inputs)) in turn on ranks 0..m-1 over a (1, m) grid (m < d:
    ranks 0 and 1), one model at a time: init from seed 0 keeping this
    rank's blocks (the ranks one after another, so two full-size draws
    never overlap on the card), then :func:`heads_yardstick` with K4's
    calls recorded.  Saves its logits and a JSON record per job
    (:func:`rank_widths`, the headless calls of attention and of the
    mLSTM); on the card rank 0 and rank m - 1 (the fewest heads) also
    hold K4 to its plain version on each of their layer-0 shapes."""
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.segment_sum import segment_sum_chunked
    from repro_torch.launch.mesh import ModelGrid, ModelGroup, model_grid
    from repro_torch.models import attention as attn
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import Transformer
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(workdir)
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    by_variant = flash_attention_fwd.launches_by_variant
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=300))
    try:
        sub = dist.new_group([0, 1])        # every rank calls new_group
        for label, cfg, m, inputs in jobs:
            if rank >= m:
                dist.barrier()
                continue
            t0 = time.perf_counter()
            grid = model_grid(1, d) if m == d else \
                ModelGrid(ModelGroup(1, 0), ModelGroup(m, rank, sub))
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            for turn in range(m):           # the ranks' draws in turn
                if turn == rank:
                    gen = torch.Generator(device=device).manual_seed(0)
                    model, t_init = timed(lambda: Transformer.init_params(
                        cfg, gen, device=device, group=grid))
                    if on_card:
                        torch.cuda.empty_cache()
                dist.barrier(group=None if m == d else sub)
            for k in kernels:
                k.launches = 0
            for v in by_variant:
                by_variant[v] = 0
            attn.NO_HEAD["calls"] = xlstm.NO_HEAD["calls"] = 0
            with k4_calls() as (seen, first):
                logits, rec = heads_yardstick(model, inputs, device,
                                              grid.model)
            torch.save(logits, work / f"rank{rank}_{label}.pt")
            info = {"rank": rank, "arch": cfg.name, "label": label,
                    "grid": [1, m], "n_layers": cfg.n_layers,
                    **rank_widths(model),
                    "no_head_calls": attn.NO_HEAD["calls"]
                    + xlstm.NO_HEAD["calls"],
                    "params_held": sum(p.numel()
                                       for p in model.parameters()),
                    "param_bytes_held": nbytes(*model.parameters()),
                    "seconds_init": t_init, "yardstick": rec,
                    "launches": {k.__name__: k.launches for k in kernels},
                    "k4_launches_by_variant": dict(by_variant),
                    "k4_calls": k4_tally(seen)}
            if on_card:
                info["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated()
                if rank in (0, m - 1):
                    info["k4_on_path_inputs"] = [
                        {"rank": rank, "heads": info["heads"],
                         **k4_on_path_inputs(*first[key], key[3])}
                        for key in sorted(first, key=str)]
            del first, model, logits
            info["seconds"] = time.perf_counter() - t0
            (work / f"rank{rank}_{label}.json").write_text(json.dumps(info))
            dist.barrier()      # one model on the card at a time
    finally:
        dist.destroy_process_group()


def phase_heads(dev, kernels, yards):
    """Phase 4j: (a) qwen1.5-4b at full width, cut to
    ``HEADS_DENSE_LAYERS``, and (b) whisper-small at full width and depth,
    over (1, 8) gloo ranks sharing the card (20 and 12 heads: 3 or 2, 2 or
    1 a rank); (c) internvl2-26b at full width cut to ``VLM_LAYERS`` over
    (1, 2).  Each rank's logits of a prefill and ``YARD_STEPS``
    teacher-forced decode steps are held within ``DECODE_TOL`` of the
    largest logit to the d = 1 run of the same weights and inputs: (a)'s
    made here, (b)'s and (c)'s by phase 4d (``yards``: {arch: logits});
    every rank holds the same bits.  K4 runs on each rank's own heads, the
    launches counted a rank.  Returns K4's launches in the phase (the
    ranks' and (a)'s d = 1 run) and the ranks' K4 rows."""
    import shutil
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import Transformer
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase4j"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfgs = {label: heads_config(arch) for label, arch in
            (("a", "qwen1.5-4b"), ("b", "whisper-small"),
             ("c", "internvl2-26b"))}
    inputs = {label: heads_inputs(cfg) for label, cfg in cfgs.items()}
    before = flash_attention_fwd.launches
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    one = Transformer.init_params(cfgs["a"], gen, device=dev)
    (want_a, rec_a), t_one = timed(lambda: heads_yardstick(one, inputs["a"],
                                                           dev))
    del one
    torch.cuda.empty_cache()
    want = {"a": want_a, "b": yards["whisper-small"],
            "c": yards["internvl2-26b"]}
    total = flash_attention_fwd.launches - before
    check(total == cfgs["a"].n_layers,
          f"phase 4j: (a)'s d = 1 run launched K4 {total} times")
    ranks = {"a": HEADS_RANKS, "b": HEADS_RANKS, "c": HEADS_VLM_RANKS}
    lines, k4_rows = [], []
    try:
        jobs = [(label, cfgs[label], ranks[label], inputs[label])
                for label in ("a", "b", "c")]
        _, t_ranks = timed(lambda: run_ranks(
            lm_rank, HEADS_RANKS, HEADS_JOIN_SECONDS, "phase 4j",
            str(work), jobs, dev.type))
        for label, cfg, m, _ in jobs:
            per = [json.loads((work / f"rank{r}_{label}.json").read_text())
                   for r in range(m)]
            got = [torch.load(work / f"rank{r}_{label}.pt")
                   for r in range(m)]
            w = want[label]
            scale = float(w.abs().max())
            errs = []
            for r, (info, g) in enumerate(zip(per, got)):
                what = f"phase 4j ({label}) {cfg.name} rank {r}"
                check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                      f"{what}: logits {tuple(g.shape)}, want "
                      f"{tuple(w.shape)}")
                check(same_bits(g, got[0]), f"{what}: other logits than "
                      f"rank 0's")
                err = (g.double() - w.double()).abs().amax(-1)  # (B, 1 + n)
                errs.append(err.tolist())
                check(bool((err <= DECODE_TOL * scale).all()),
                      f"{what}: |d=m - d=1| by row and position "
                      f"{err.tolist()} over {DECODE_TOL} x {scale}")
                lo, hi = attn.head_range(cfg.n_heads, m, r)
                klo, khi = attn.kv_head_range(cfg.n_heads, cfg.n_kv_heads,
                                              m, r)
                check((info["heads"], info["kv_heads"]) ==
                      (hi - lo, khi - klo),
                      f"{what}: holds {info['heads']} / {info['kv_heads']} "
                      f"heads, want {hi - lo} / {khi - klo}")
                calls = {(tuple(c[0]), tuple(c[1]), c[2], c[3]): c[4]
                         for c in info["k4_calls"]}
                want_k4 = heads_want_k4(cfg, hi - lo)
                n = sum(want_k4.values())
                check(calls == want_k4 and
                      info["launches"]["flash_attention_fwd"] == n and
                      info["k4_launches_by_variant"]["sm90_wgmma"] == n,
                      f"{what}: K4 {calls}, {info['launches']}, "
                      f"{info['k4_launches_by_variant']}; want {want_k4}")
                layers = cfg.n_layers + (cfg.n_layers + 2 * cfg.n_enc_layers
                                         if cfg.is_encoder_decoder else 0)
                check(info["no_head_calls"] ==
                      (0 if hi > lo else layers + YARD_STEPS * (
                          2 if cfg.is_encoder_decoder else 1)
                       * cfg.n_layers),
                      f"{what}: {info['no_head_calls']} headless calls")
                check(not any(c for k, c in info["launches"].items()
                              if k != "flash_attention_fwd"),
                      f"{what} launched graph kernels: {info['launches']}")
                total += n
                for row in info.pop("k4_on_path_inputs", []):
                    k4_rows.append({"arch": cfg.name, **row})
            lines.append({"label": label, "arch": cfg.name,
                          "n_layers": cfg.n_layers,
                          "n_layers_published": get_config_layers(cfg.name),
                          "grid": [1, m], "heads_per_rank":
                          [i["heads"] for i in per],
                          "kv_heads_per_rank": [i["kv_heads"] for i in per],
                          "yardstick_max_abs_logit": scale,
                          "yardstick_per_row": errs[0],
                          "tolerance": DECODE_TOL * scale,
                          "per_rank": per})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "heads", "ranks": HEADS_RANKS, "backend": "gloo",
          "models": lines, "one_rank_a": rec_a, "seconds_one_rank_a": t_one,
          "seconds_ranks": t_ranks, "k4_launches": total,
          "k4_on_path_inputs": k4_rows,
          "seconds": time.perf_counter() - t0})
    return {"flash_attention_fwd": total}, k4_rows


# phase 4k: the ssm and hybrid families over model ranks
RECURRENT_RANKS = 8           # gloo ranks on the one card: (a) over (1, 8)
RECURRENT_HYBRID_RANKS = 2    # (b) over (1, 2): ranks 0 and 1 (lm_rank's)
RECURRENT_JOIN_SECONDS = 600.0
RECURRENT_BATCH = 2
RECURRENT_PROMPT = {"xlstm-350m": 64,                 # one mLSTM chunk
                    HYBRID_ARCH: 1024}                # 4 Mamba chunks
# xLSTM computes in float32 here: in bf16 its recurrences amplify the
# rounding of the ranks' partial sums, 6.6% of the largest logit against
# d = 1 after a 64-id prompt on an H100 (PERF.md, phase 4k), as they
# amplify the reference's own bf16 drift (7.6% over 128 steps,
# probes/xlstm_bf16_drift.py); in float32 the gap is the sharding's
RECURRENT_OVER = {"xlstm-350m": {"compute_dtype": "float32"},
                  HYBRID_ARCH: {"moe_impl": "expert_tp",
                                "capacity_factor": 1.25}}


def recurrent_config(arch):
    """Phase 4k's config of ``arch``: xlstm-350m whole, float32 compute;
    jamba at full width in phase 4e's period (``HYBRID_PERIOD``
    sub-layers), ``expert_tp``, bf16."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, attn_every=HYBRID_PERIOD,
                                  n_layers=HYBRID_PERIOD)
    return dataclasses.replace(cfg, **RECURRENT_OVER.get(arch, {}))


def recurrent_collectives(cfg, s: int) -> int:
    """The model group's calls in a prefill of ``s`` tokens (``s = 1``: a
    decode step): the embedding's psum and the logits' gather; an xLSTM
    period's sLSTM gathers ``h`` at each step and each block sums its
    ``proj_out``; a hybrid period's Mamba sums B, C, dt and ``out_proj``,
    its attention ``wo``, each MLP its output and each ``expert_tp`` MoE
    its output and its aux loss."""
    if cfg.family == "ssm":
        per = sum(s + 1 if k == "slstm" else 1 for k in cfg.block_pattern)
        return 2 + cfg.n_layers // len(cfg.block_pattern) * per
    n = cfg.attn_every
    moe = sum(i % cfg.moe_every == 1 for i in range(n))
    per = 2 * (n - 1) + 1 + (n - moe) + moe * (
        2 if cfg.moe_impl == "expert_tp" else 1)
    return 2 + cfg.n_layers // n * per


def recurrent_yardstick(cfg, inputs, dev) -> tuple:
    """The d = 1 run of phase 4k: seed-0 weights over the one-rank grid
    (so jamba's ``expert_tp`` keeps its own capacity rule, as its ranks
    do), :func:`heads_yardstick` -> (logits on the host, its record, K4's
    calls)."""
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, t_init = timed(lambda: Transformer.init_params(
        cfg, gen, device=dev, group=model_grid(1, 1)))
    with k4_calls() as (seen, _):
        logits, rec = heads_yardstick(model, inputs, dev)
    rec.update(seconds_init=t_init, param_bytes=nbytes(*model.parameters()),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    del model
    torch.cuda.empty_cache()
    return logits, rec, list(seen)


def phase_recurrent(dev, kernels):
    """Phase 4k: (a) xlstm-350m at full width and depth over (1, 8) gloo
    ranks sharing the card (its 4 mLSTM heads on ranks 0-3, none on 4-7;
    the sLSTM's 2048 channels as 256 a rank, its ``h`` gathered each step)
    and (b) jamba-1.5-large at full width in phase 4e's period over (1,
    2) on ranks 0 and 1 (``expert_tp``, capacity factor 1.25, bf16; 32
    query and 4 KV heads and 8192 Mamba channels a rank).  Each rank's
    logits of a prefill and ``YARD_STEPS`` teacher-forced decode steps
    are held within ``DECODE_TOL`` of the largest logit to the d = 1 run
    of the same weights and inputs, run here first and freed before the
    ranks spawn (jamba's d = 1 model, 45.94 GB, and both ranks' would not
    fit together); every rank holds the same bits.  Returns K4's
    launches in the phase (the d = 1 runs' and the ranks') and the ranks'
    K4 rows."""
    import shutil
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import attention as attn
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase4k"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for k in kernels:
        k.launches = 0
    cfgs = {"a": recurrent_config("xlstm-350m"),
            "b": recurrent_config(HYBRID_ARCH)}
    check(cfgs["b"].param_dtype == cfgs["b"].compute_dtype == "bfloat16"
          and cfgs["b"].d_model == 8192 and cfgs["b"].n_heads == 64,
          "phase 4k: jamba at full width, bf16")
    inputs = {}
    for label, cfg in cfgs.items():
        rng = np.random.default_rng(0)
        b, s = RECURRENT_BATCH, RECURRENT_PROMPT[cfg.name]
        inputs[label] = {
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, s)).astype(np.int32)),
            "teacher": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, YARD_STEPS)).astype(np.int64))}
    want, one = {}, {}
    for label in ("a", "b"):
        want[label], one[label], seen = recurrent_yardstick(
            cfgs[label], inputs[label], dev)
        one[label]["k4_calls"] = len(seen)
    total = flash_attention_fwd.launches
    check(total == 1 and one["a"]["k4_calls"] == 0,
          f"phase 4k: the d = 1 runs launched K4 {total} times (jamba's "
          f"attention once, xLSTM none)")
    ranks = {"a": RECURRENT_RANKS, "b": RECURRENT_HYBRID_RANKS}
    lines, k4_rows = [], []
    try:
        jobs = [(label, cfgs[label], ranks[label], inputs[label])
                for label in ("a", "b")]
        _, t_ranks = timed(lambda: run_ranks(
            lm_rank, RECURRENT_RANKS, RECURRENT_JOIN_SECONDS,
            "phase 4k", str(work), jobs, dev.type))
        for label, cfg, m, _ in jobs:
            per = [json.loads((work / f"rank{r}_{label}.json").read_text())
                   for r in range(m)]
            got = [torch.load(work / f"rank{r}_{label}.pt")
                   for r in range(m)]
            w = want[label]
            scale = float(w.abs().max())
            errs = []
            inner = cfg.d_model * cfg.ssm_expand // m
            for r, (info, g) in enumerate(zip(per, got)):
                what = f"phase 4k ({label}) {cfg.name} rank {r}"
                check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                      f"{what}: logits {tuple(g.shape)}, want "
                      f"{tuple(w.shape)}")
                check(same_bits(g, got[0]), f"{what}: other logits than "
                      f"rank 0's")
                err = (g.double() - w.double()).abs().amax(-1)  # (B, 1 + n)
                errs.append(err.tolist())
                check(bool((err <= DECODE_TOL * scale).all()),
                      f"{what}: |d=m - d=1| by row and position "
                      f"{err.tolist()} over {DECODE_TOL} x {scale}")
                lo, hi = attn.head_range(cfg.n_heads, m, r)
                check(info["heads"] == hi - lo and info["inner"] == inner,
                      f"{what}: holds {info['heads']} heads and "
                      f"{info['inner']} channels, want {hi - lo} and "
                      f"{inner}")
                rec = info["yardstick"]
                for part, s in (("prefill", RECURRENT_PROMPT[cfg.name]),
                                ("decode", 1)):
                    calls = rec[f"collectives_{part}"]["calls"]
                    check(calls == recurrent_collectives(cfg, s),
                          f"{what}: {calls} collectives a {part}, want "
                          f"{recurrent_collectives(cfg, s)}")
                headless = cfg.family == "ssm" and hi == lo
                n_mlstm = cfg.n_layers // len(cfg.block_pattern) \
                    if cfg.family == "ssm" else 0
                check(info["no_head_calls"] ==
                      (n_mlstm * (1 + YARD_STEPS) if headless else 0),
                      f"{what}: {info['no_head_calls']} headless calls")
                calls = {(tuple(c[0]), tuple(c[1]), c[2], c[3]): c[4]
                         for c in info["k4_calls"]}
                n = 0
                if cfg.family == "hybrid":
                    q = (RECURRENT_BATCH, RECURRENT_PROMPT[cfg.name],
                         hi - lo, cfg.resolved_head_dim)
                    want_k4 = {(q, q, str(torch.bfloat16), True): 1}
                    n = 1
                else:
                    want_k4 = {}
                check(calls == want_k4 and
                      info["launches"]["flash_attention_fwd"] == n and
                      info["k4_launches_by_variant"].get("sm90_wgmma", 0)
                      == n,
                      f"{what}: K4 {calls}, {info['launches']}, "
                      f"{info['k4_launches_by_variant']}; want {want_k4}")
                check(not any(c for k, c in info["launches"].items()
                              if k != "flash_attention_fwd"),
                      f"{what} launched graph kernels: {info['launches']}")
                total += n
                for row in info.pop("k4_on_path_inputs", []):
                    k4_rows.append({"arch": cfg.name, **row})
            lines.append({"label": label, "arch": cfg.name,
                          "n_layers": cfg.n_layers,
                          "n_layers_published": get_config_layers(cfg.name),
                          "grid": [1, m], "prompt": RECURRENT_PROMPT[cfg.name],
                          "batch": RECURRENT_BATCH,
                          "heads_per_rank": [i["heads"] for i in per],
                          "inner_per_rank": [i["inner"] for i in per],
                          "prefill_seconds": [i["yardstick"][
                              "prefill_seconds"] for i in per],
                          "prefill_ms_per_token": [
                              1e3 * i["yardstick"]["prefill_seconds"]
                              / RECURRENT_PROMPT[cfg.name] for i in per],
                          "decode_seconds_per_token": [i["yardstick"][
                              "decode_seconds"] for i in per],
                          "collectives_prefill": per[0]["yardstick"][
                              "collectives_prefill"],
                          "collectives_per_token": per[0]["yardstick"][
                              "collectives_decode"],
                          "max_memory_allocated": [
                              i.get("max_memory_allocated") for i in per],
                          "yardstick_max_abs_logit": scale,
                          "max_gap_over_max_logit": max(
                              max(max(row) for row in e) for e in errs)
                          / scale,
                          "tolerance": DECODE_TOL * scale,
                          "one_rank": one[label], "per_rank": per})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {k.__name__: k.launches for k in kernels}
    emit({"phase": "recurrent", "ranks": RECURRENT_RANKS, "backend": "gloo",
          "models": lines, "seconds_ranks": t_ranks, "k4_launches": total,
          "launches_parent": launches, "k4_on_path_inputs": k4_rows,
          "seconds": time.perf_counter() - t0})
    check(not any(c for k, c in launches.items()
                  if k != "flash_attention_fwd"),
          f"phase 4k launched graph kernels: {launches}")
    return {"flash_attention_fwd": total}, k4_rows


# phase 4l: the xLSTM, whisper, VLM and hybrid families trained over model
# ranks
FAMILY_TRAIN_RANKS = 16        # gloo ranks on the one card: (b) over (1, 16)
FAMILY_TRAIN_JOIN_SECONDS = 600.0
FAMILY_TRAIN_STEPS = 2         # step 1 takes step 0's optimizer state
FAMILY_TRAIN_RUNS = (
    # (run, arch, model ranks m, batch, tokens, layers kept (None: all),
    #  overrides); each over (1, m) on ranks 0..m-1
    # xlstm-350m cut to 12 of its 24 blocks and whisper-small to 2 + 2 of
    # its 12 + 12 layers: whole, their two steps took 39 and 69-90 s on an
    # H100, in host collectives (an sLSTM gather a token a block; psums of
    # (2, 1536, 768) encoder states)
    ("a", "xlstm-350m", 8, 2, 16, 12, {"compute_dtype": "float32"}),
    ("b", "whisper-small", 16, 2, 64, 2, {"n_enc_layers": 2}),
    ("c", "internvl2-26b", 2, 2, 128, 4, {}),
    ("d", HYBRID_ARCH, 2, 2, 512, 2,
     {"attn_every": 2, "n_experts": 4, "moe_impl": "expert_tp",
      "capacity_factor": 1.25}),
    # KV heads that several ranks share: starcoder2's 4 held by 4 ranks
    # each (3 query heads a rank), mistral-nemo's 8 by 2 (2 a rank)
    ("e", "starcoder2-15b", 16, 2, 128, 2, {}),
    ("f", "mistral-nemo-12b", 16, 2, 128, 2, {}),
)
# against d = 1: phase 4h's limits in bf16 compute (2e-2 for the routed
# MoE, as 4h (c)); 1e-4 relative in (a)'s float32 compute
FAMILY_TRAIN_LOSS_TOL = {"a": 1e-4, "b": 1e-2, "c": 1e-2, "d": 2e-2,
                         "e": 1e-2, "f": 1e-2}
FAMILY_TRAIN_NORM_TOL = {"a": 1e-4, "b": 5e-2, "c": 5e-2, "d": 5e-2,
                         "e": 5e-2, "f": 5e-2}
# step 0's gradient of each leaf that phase 4l records (a run whose KV
# heads several ranks share: every KV leaf, and layer 0's wq as a control
# no rank shares) against d = 1's cut to the rank's block, relative L2; a
# rank that kept only its own part of a KV head's sum would read ~0.7
# with 2 holders and ~0.87 with 4
FAMILY_TRAIN_GRAD_TOL = 5e-2
FAMILY_TRAIN_MEMORY = 72e9     # the reckoning's ceiling over the ranks
CUDA_CONTEXT_BYTES = 0.5e9     # a rank's CUDA context, outside the allocator
# the products' library workspaces (cuBLAS, cuBLASLt), a set for each
# thread that runs them (the caller's and autograd's device thread): an
# allowance of 64 MiB a thread (a rank's peak read 23 MB over the
# reckoning without it on an H100)
WORKSPACE_BYTES = 2 * 64 * 2 ** 20
SCAN_SAVED = 17   # (B, 256, di, N) float32 tensors a Mamba chunk saves


def family_train_batches(cfg, batch: int, seq: int, steps: int) -> list:
    """``steps`` batches on the host, batch ``i`` from numpy seed ``i``:
    ``batch`` rows of ``seq`` token and target ids, with whisper's stub
    frames ``enc_embeds`` or the VLM's ``patch_embeds`` (float32
    normals)."""
    vocab = min(getattr(cfg, "vocab_unpadded", 0) or cfg.vocab_size,
                cfg.vocab_size)
    out = []
    for i in range(steps):
        rng = np.random.default_rng(i)
        b = {k: torch.from_numpy(rng.integers(0, vocab, (batch, seq)).astype(
            np.int32)) for k in ("tokens", "targets")}
        if cfg.is_encoder_decoder:
            b["enc_embeds"] = torch.from_numpy(rng.standard_normal(
                (batch, cfg.enc_seq_len, cfg.d_model), dtype=np.float32))
        if cfg.n_patches:
            b["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model), dtype=np.float32))
        out.append(b)
    return out


def family_train_grad_leaf(name: str) -> bool:
    """A leaf whose step-0 gradient phase 4l holds to d = 1's: a KV leaf
    (``wk``, ``wv`` and their biases), or layer 0's ``wq`` (the control:
    no rank shares it)."""
    return bool(re.search(r"\.attn\.w[kv]\.[wb]$", name)) or \
        name.startswith("layers.0.attn.wq.")


def shares_kv(lay) -> bool:
    """Some KV leaf of the layout (``train/zero.layout``) is a sum over
    the ranks that share its heads."""
    return any(leaf.msum for k, leaf in lay.items()
               if family_train_grad_leaf(k) and ".attn.wq." not in k)


def family_train_one_rank(dev, cfg, batches, arrays: bool = False,
                          grads: bool = False) -> dict:
    """The d = 1 run of phase 4l: seed-0 weights over the one-rank grid
    (so jamba's ``expert_tp`` keeps its own capacity rule, as its ranks
    do), one train step a batch -> each step's metrics, seconds and K4
    calls, and the peak memory; with ``arrays`` also the weights before
    each step (``Transformer.to_arrays``), with ``grads`` step 0's
    gradient of each :func:`family_train_grad_leaf` before clipping
    (float32, on the host).  Freed after."""
    from repro_torch.launch.mesh import model_grid
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    (model, state), t_init = timed(lambda: init_train_state(
        cfg, gen, device=dev, grid=model_grid(1, 1)))
    step_fn = make_train_step(cfg, OptHyper(), attn_chunk=TRAIN_SEQ)
    rows, before = [], []
    for i, batch in enumerate(batches):
        if arrays:      # copies: a CPU model's arrays share its storage
            before.append(copy.deepcopy(model.to_arrays()))
        b = {k: v.to(dev) for k, v in batch.items()}
        rec = pre_clip_grads(family_train_grad_leaf) if grads and i == 0 \
            else contextlib.nullcontext()
        with k4_calls() as (seen, _), rec as got:
            (_, _, met), t = timed(lambda: step_fn(model, state, b, i))
            row = {k: float(v) for k, v in met.items()}
        rows.append({**row, "seconds": t, "k4_calls": k4_tally(seen)})
        if got is not None:
            step0 = got
    out = {"steps": rows, "seconds_init": t_init,
           "param_bytes": nbytes(*model.parameters())}
    if arrays:
        out["arrays"] = before
    if grads:
        out["grads"] = step0
    del model, state
    # a process's first step under remat="full" leaves its model in a
    # reference cycle
    gc.collect()
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    return out


def family_train_want_k4(cfg, heads: int, batch: int, seq: int) -> dict:
    """{(q shape, k shape, dtype, causal): calls} of a train step under
    ``remat="full"`` on a rank holding ``heads`` query heads: each
    attention layer once in the forward and once in the recompute
    (whisper's encoder non-causal, its decoder's self-attention causal and
    cross-attention non-causal; a VLM's queries behind its patches; a
    hybrid's one attention layer a period); none without a head, none in
    the xLSTM."""
    from repro_torch.models.layers import dtype_of
    if heads == 0 or cfg.family == "ssm":
        return {}
    dt, d = str(dtype_of(cfg.compute_dtype)), cfg.resolved_head_dim
    q = (batch, seq + cfg.n_patches, heads, d)
    if cfg.is_encoder_decoder:
        e = (batch, cfg.enc_seq_len, heads, d)
        return {(e, e, dt, False): 2 * cfg.n_enc_layers,
                (q, q, dt, True): 2 * cfg.n_layers,
                (q, e, dt, False): 2 * cfg.n_layers}
    n = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" \
        else cfg.n_layers
    return {(q, q, dt, True): 2 * n}


def family_train_no_head(cfg, heads: int) -> int:
    """The headless calls of a train step on a rank holding ``heads``
    attention or mLSTM heads: on a rank with none, every such call, in the
    forward and again in the recompute; 0 on a rank with a head."""
    if heads:
        return 0
    if cfg.family == "ssm":
        n = cfg.n_layers // len(cfg.block_pattern) * \
            cfg.block_pattern.count("mlstm")
    elif cfg.family == "hybrid":
        n = cfg.n_layers // cfg.attn_every
    else:
        n = cfg.n_layers + (cfg.n_layers + cfg.n_enc_layers
                            if cfg.is_encoder_decoder else 0)
    return 2 * n


def family_train_collectives(cfg, seq: int, lay) -> dict:
    """The model group's calls in a train step of ``seq`` tokens over
    (1, m), m > 1, ``remat="full"``, by phase.  Each block (a layer, an
    encoder layer, an xLSTM or hybrid period) makes L calls in the
    forward, calls E in the backward and makes L - T again in its
    recompute, which stops after the last tensor the block saves, before
    its T trailing sums (``torch.utils.checkpoint``'s early stop).  A
    layer's attention, MLP or Mamba output sum, its MoE's output sum and
    aux mean, a Mamba's B, C, dt sum and an sLSTM's gather of ``h`` a step
    are calls of the forward; the backward sums each entry's input
    gradient (an attention's, also cross-attention's encoder states', an
    MLP's, a Mamba's and its B, C, dt's, an xLSTM block's, an MoE's) and
    reduce-scatters each gather of a tracked ``h`` (every step but the
    first).  Outside the blocks: the embedding's sum and the logits'
    gather in the forward, the head's entry in the backward.  Then from
    the layout ``lay`` (``train/zero.layout``): a model-axis sum a leaf
    whose gradient ranks hold in part ("gradients"), and the norm's sum
    and Adafactor's sums over a model dim ("optimizer")."""
    from repro_torch.train.optimizer import _factored, stack_groups
    blocks = []                 # (L, E, T)
    if cfg.family == "ssm":
        per = [(1, 1) if k == "mlstm" else (seq + 1, seq)
               for k in cfg.block_pattern]
        blocks = [(sum(a for a, _ in per), sum(b for _, b in per), 1)] * (
            cfg.n_layers // len(cfg.block_pattern))
    elif cfg.family == "hybrid":
        n = cfg.attn_every
        moe = [i % cfg.moe_every == 1 and cfg.n_experts > 0
               for i in range(n)]
        tp = cfg.moe_impl == "expert_tp"
        ffn = [(2, 1) if m and tp else (1, 1) for m in moe]
        calls = 2 * (n - 1) + 1 + sum(a for a, _ in ffn)
        back = 2 * (n - 1) + 1 + sum(b for _, b in ffn)
        blocks = [(calls, back, ffn[-1][0])] * (cfg.n_layers // n)
    else:
        if cfg.is_encoder_decoder:
            blocks = [(2, 2, 1)] * cfg.n_enc_layers + [(3, 4, 1)] * \
                cfg.n_layers
        else:
            blocks = [(2, 2, 1)] * cfg.n_layers
    out = {"forward": 2 + sum(L for L, _, _ in blocks),
           "recompute": sum(L - T for L, _, T in blocks),
           "backward": 1 + sum(E for _, E, _ in blocks),
           "gradients": sum(leaf.msum for leaf in lay.values())}
    opt = 1                     # the global norm's sum
    if cfg.optimizer == "adafactor":
        for key, (stack, members) in stack_groups(lay).items():
            leaf = lay[members[0][1]]
            if leaf.mdim is None:
                continue
            nl, shape = len(leaf.full), tuple(stack) + leaf.full
            if _factored(shape) and nl >= 2:    # rows, cols, row mean
                opt += (leaf.mdim == nl - 1) + 2 * (leaf.mdim == nl - 2)
            elif _factored(shape):              # a stacked vector's rows
                opt += leaf.mdim == 0
            opt += 1                            # the update's RMS
    out["optimizer"] = opt
    return out


def family_train_activations(cfg, model: int, batch: int, seq: int) -> dict:
    """Bytes of a rank's activations at the peak of a train step under
    ``remat="full"`` over (1, ``model``): each layer's saved input (the
    encoder's over its frames), and the period the backward recomputes:
    a Mamba's chunks, ``SCAN_SAVED`` float32 (B, 256, di / m, N) tensors
    each (``saved_tensors_hooks`` on the CPU), or a layer's widest rows,
    four float32 (B, S, width) tensors, and that again for the gradients
    flowing back; and K4's PyTorch backward at the longest attention, four
    float32 (B, H / m, query block, Sk) score blocks."""
    from repro_torch.models.layers import dtype_of
    item = dtype_of(cfg.compute_dtype).itemsize
    s = seq + cfg.n_patches
    inputs = cfg.n_layers * batch * s * cfg.d_model * item
    width = max(cfg.d_model, cfg.d_ff // model if cfg.d_ff else 0,
                cfg.d_model * cfg.ssm_expand // model)
    rows = batch * s
    if cfg.is_encoder_decoder:
        inputs += cfg.n_enc_layers * batch * cfg.enc_seq_len * \
            cfg.d_model * item
        rows = max(rows, batch * cfg.enc_seq_len)
    period = 2 * 4 * rows * width * 4
    if cfg.family == "hybrid":
        chunk = min(256, seq)
        di = cfg.d_model * cfg.ssm_expand // model
        scan = SCAN_SAVED * batch * chunk * di * cfg.ssm_state_dim * 4
        period += (cfg.attn_every - 1) * seq // chunk * scan
    scores = 0      # K4's PyTorch backward: four float32 score blocks
    if cfg.family != "ssm":
        sk = cfg.enc_seq_len if cfg.is_encoder_decoder else s
        heads = -(-cfg.n_heads // model)
        scores = 4 * batch * heads * min(TRAIN_SEQ, sk) * sk * 4
    return {"layer_inputs": inputs, "recomputed": period,
            "attention_backward": scores,
            "activations": inputs + period + scores}


def family_train_reckoning(cfg, model: int, batch: int, seq: int) -> dict:
    """:func:`sharded_train_reckoning` of rank 0 (the most heads) over
    (1, ``model``) at ``batch`` x ``seq``, with the larger of the
    backward's :func:`family_train_activations` and the update's
    temporaries (four float32 copies of the rank's largest block) added to
    the rank, the backward freeing its activations before the update
    starts, and the products' workspaces (``WORKSPACE_BYTES``); or, if
    more, its blocks beside the float32 draw of the largest whole leaf
    (the weights' draw, before the state exists)."""
    from repro_torch.launch.mesh import ModelGrid, ModelGroup
    from repro_torch.models.transformer import Transformer
    reck = sharded_train_reckoning(cfg, 1, model, batch=batch, seq=seq)
    reck.update(family_train_activations(cfg, model, batch, seq))
    m = Transformer(cfg, device="meta", group=ModelGrid(
        ModelGroup(1, 0), ModelGroup(model, 0)))
    reck["optimizer_temporaries"] = 4 * 4 * max(
        p.numel() for p in m.parameters())
    reck["workspaces"] = WORKSPACE_BYTES
    reck["rank"] += max(reck["activations"], reck["optimizer_temporaries"]) \
        + WORKSPACE_BYTES
    # the draw of the weights: each whole leaf in float32 beside the rank's
    # blocks (layers.fill_normal_), mistral-nemo's 2.68 GB table the largest
    reck["init_draw"] = 4 * max(p.numel() for p in Transformer(
        cfg, device="meta").parameters())
    reck["rank"] = max(reck["rank"], reck["params"] + reck["init_draw"]
                       + WORKSPACE_BYTES)
    reck["all_ranks"] = reck["rank"] * model
    return reck


def shared_checksums(model, state, lay) -> tuple:
    """What ranks share after a step: each parameter that several model
    ranks hold (``Leaf.holders``: the norms, a KV head's columns) and, with
    AdamW, its m and v -> ({key: :func:`checksum`}, {key: holders})."""
    params = dict(model.named_parameters())
    held = {k: leaf.holders for k, leaf in lay.items()
            if len(leaf.holders) > 1}
    sums = {k: checksum(params[k]) for k in held}
    holders = dict(held)
    for part in ("m", "v"):     # Adafactor's state is by stacked group
        for k, t in state.get(part, {}).items():
            if k in held:
                sums[f"{k}:{part}"] = checksum(t)
                holders[f"{k}:{part}"] = held[k]
    return sums, holders


def family_train_rank(rank: int, d: int, workdir: str, jobs, device: str):
    """Phase 4l, one rank: one intra-op thread (16 ranks share 8 cores),
    join a gloo world of ``d`` ranks on ``device`` (card 0), then
    :func:`family_train_world`, the allocator's segments expandable
    (:func:`expandable_segments`)."""
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device == "cuda":
        expandable_segments()
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(workdir) / 'store'}", rank=rank,
        world_size=d, timeout=datetime.timedelta(seconds=300))
    try:
        family_train_world(workdir, jobs, device)
    finally:
        dist.destroy_process_group()


def family_train_world(workdir: str, jobs, device: str) -> list:
    """Phase 4l's jobs on this rank of an initialized gloo world: each of
    ``jobs`` ((label, config, model ranks m, batches)) in turn on ranks
    0..m-1 over a (1, m) grid, one model on the card at a time
    (:func:`family_train_job`).  Returns this rank's records."""
    import torch.distributed as dist
    rank = dist.get_rank()
    subs = {m: dist.new_group(list(range(m)))      # every rank calls it
            for m in sorted({job[2] for job in jobs})}
    out = []
    for label, cfg, m, batches in jobs:
        if rank < m:
            out.append(family_train_job(Path(workdir), label, cfg, subs[m],
                                        m, batches, device))
        dist.barrier()
    return out


def family_train_job(work: Path, label: str, cfg, sub, m: int, batches,
                     device: str) -> dict:
    """One run of phase 4l on this rank of ranks 0..m-1 (process group
    ``sub``): the weights from seed 0, this rank's blocks kept (the ranks'
    draws one after another, so two full-size draws never overlap on the
    card), then a sharded train step a batch.  Records each step's
    metrics, seconds, K4 launches by variant and calls by shape, headless
    calls and the model group's collectives by phase; what the rank holds
    (heads, parameter, gradient and state bytes) and, after each step, the
    checksums of what ranks share (:func:`shared_checksums`); on the card
    its peak memory, and on rank 0 and the last rank with a head K4 held
    to its plain version on step 0's layer-0 inputs.  Writes the record
    as ``rank<r>_<label>.json``; where KV heads are shared
    (:func:`shares_kv`), step 0's gradient of each
    :func:`family_train_grad_leaf` after the model-axis sums, before
    clipping, with its :func:`grad_block`, as ``rank<r>_<label>_grads.pt``.
    """
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import ModelGrid, ModelGroup
    from repro_torch.models import attention as attn
    from repro_torch.models import xlstm
    from repro_torch.train import zero
    from repro_torch.train.optimizer import OptHyper
    from repro_torch.train.step import init_train_state, make_train_step
    on_card = device == "cuda"
    rank = dist.get_rank()
    grid = ModelGrid(ModelGroup(1, 0), ModelGroup(m, rank, sub))
    by_variant = flash_attention_fwd.launches_by_variant
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for turn in range(m):
        if turn == rank:
            gen = torch.Generator(device=device).manual_seed(0)
            (model, state), t_init = timed(lambda: init_train_state(
                cfg, gen, device=device, grid=grid))
            if on_card:
                torch.cuda.empty_cache()
        dist.barrier(group=sub)
    step_fn = make_train_step(cfg, OptHyper(), attn_chunk=TRAIN_SEQ)
    lay = zero.layout(model)
    record = shares_kv(lay)
    grads, sums = {}, []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, k=k: grads.__setitem__(k, nbytes(p.grad)))
        for k, p in model.named_parameters()]
    rows, first = [], {}
    for i, batch in enumerate(batches):
        mine = {k: v.to(device) for k, v in batch.items()}
        flash_attention_fwd.launches = 0
        for v in by_variant:
            by_variant[v] = 0
        attn.NO_HEAD["calls"] = xlstm.NO_HEAD["calls"] = 0
        before = copy.deepcopy(grid.model.phase_stats)
        rec = pre_clip_grads(family_train_grad_leaf) \
            if record and i == 0 else contextlib.nullcontext()
        sync()
        t = time.perf_counter()
        with k4_calls() as (seen, firsts), rec as got:
            _, _, met = step_fn(model, state, mine, i)
            row = {k: float(v) for k, v in met.items()}
        sync()
        row["seconds"] = time.perf_counter() - t
        first = first or firsts
        if got is not None:
            torch.save({k: {"grad": g, "block": grad_block(lay[k])}
                        for k, g in got.items()},
                       work / f"rank{rank}_{label}_grads.pt")
        sums.append(shared_checksums(model, state, lay))
        row.update(
            k4_launches=flash_attention_fwd.launches,
            k4_by_variant=dict(by_variant), k4_calls=k4_tally(seen),
            no_head_calls=attn.NO_HEAD["calls"] + xlstm.NO_HEAD["calls"],
            collectives={ph: {k: v - before.get(ph, {}).get(k, 0)
                              for k, v in st.items()}
                         for ph, st in grid.model.phase_stats.items()})
        rows.append(row)
    for h in hooks:
        h.remove()
    params = dict(model.named_parameters())
    info = {"rank": rank, "label": label, "arch": cfg.name,
            "grid": [1, m], "coords": grid.coords,
            "n_layers": cfg.n_layers, **rank_widths(model), "steps": rows,
            "seconds_init": t_init,
            "params_held": sum(p.numel() for p in params.values()),
            "param_bytes_held": nbytes(*params.values()),
            "grad_bytes": sum(grads.values()), "grad_leaves": len(grads),
            "state_bytes": nbytes(*(t for *_, t in
                                    zero._state_leaves(state))),
            "shares_kv": record, "holders": sums[-1][1],
            "step_checksums": [s for s, _ in sums]}
    alive = weakref.ref(model)
    del model, state, params
    # a process's first step under remat="full" leaves its model in a
    # reference cycle
    gc.collect()
    info["model_freed"] = alive() is None
    if on_card:
        info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        if first and rank in (0, min(m, cfg.n_heads) - 1):
            info["k4_on_path_inputs"] = [
                {"rank": rank, "heads": info["heads"],
                 **k4_on_path_inputs(*first[key], key[3])}
                for key in sorted(first, key=str)]
    del first
    info["seconds"] = time.perf_counter() - t0
    (work / f"rank{rank}_{label}.json").write_text(json.dumps(info))
    return info


def family_train_check(label, cfg, m: int, batch: int, seq: int, per, want,
                       tol: float, norm_tol: float, on_card: bool) -> dict:
    """Phase 4l's checks of one run: ``per`` the records of ranks 0..m-1
    (:func:`family_train_job`), ``want`` the d = 1 run's steps.  Each
    step's loss within ``tol`` and step 0's gradient norm within
    ``norm_tol`` of d = 1's, relative, every value finite; the heads each
    rank holds; each step's collectives by phase equal to
    :func:`family_train_collectives` on rank 0's layout (on the meta
    device); the headless calls (:func:`family_train_no_head`) and K4's
    calls by shape (:func:`family_train_want_k4`), on the card each a
    ``"sm90_wgmma"`` launch; after each step, the ranks that hold a block
    the same bits of it and of its AdamW state; each rank's model freed
    before the next run draws its weights.  Returns the gaps against
    d = 1 and the predicted calls."""
    from repro_torch.launch.mesh import ModelGrid, ModelGroup
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import zero
    meta = Transformer(cfg, device="meta", group=ModelGrid(
        ModelGroup(1, 0), ModelGroup(m, 0)))
    calls = family_train_collectives(cfg, seq, zero.layout(meta))
    want_calls = {ph: n for ph, n in calls.items() if n}
    gaps = []
    for r, info in enumerate(per):
        what = f"phase 4l ({label}) {cfg.name} rank {r}"
        got = info["steps"]
        check(len(got) == len(want) and all(
            np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
            for g in got), f"{what}: steps {got}")
        gaps.append([abs(g["loss"] - w["loss"]) / abs(w["loss"])
                     for g, w in zip(got, want)])
        check(all(gap <= tol for gap in gaps[-1]),
              f"{what}: losses {[g['loss'] for g in got]} vs one rank's "
              f"{[w['loss'] for w in want]} (limit {tol} relative)")
        norm = abs(got[0]["grad_norm"] - want[0]["grad_norm"])
        check(norm <= norm_tol * want[0]["grad_norm"],
              f"{what}: step 0's gradient norm {got[0]['grad_norm']} vs "
              f"{want[0]['grad_norm']} (limit {norm_tol} relative)")
        lo, hi = attn.head_range(cfg.n_heads, m, r)
        check(info["heads"] == hi - lo,
              f"{what}: holds {info['heads']} heads, want {hi - lo}")
        check(info["model_freed"], f"{what}: the model outlived its run")
        want_k4 = family_train_want_k4(cfg, hi - lo, batch, seq)
        n_k4 = sum(want_k4.values())
        for i, g in enumerate(got):
            ph = {k: v["calls"] for k, v in g["collectives"].items()}
            check(ph == want_calls, f"{what} step {i}: collectives "
                  f"{ph}, want {want_calls}")
            check(g["no_head_calls"] == family_train_no_head(cfg, hi - lo),
                  f"{what} step {i}: {g['no_head_calls']} headless calls, "
                  f"want {family_train_no_head(cfg, hi - lo)}")
            k4 = {(tuple(c[0]), tuple(c[1]), c[2], c[3]): c[4]
                  for c in g["k4_calls"]}
            check(k4 == want_k4, f"{what} step {i}: K4 calls {k4}, want "
                  f"{want_k4}")
            check(not on_card or (
                g["k4_launches"] == n_k4 and
                g["k4_by_variant"].get("sm90_wgmma", 0) == n_k4),
                f"{what} step {i}: K4 {g['k4_launches']} launches "
                f"{g['k4_by_variant']}, want {n_k4} sm90_wgmma")
    for i in range(len(want)):
        recs = [{"coords": p["coords"], "holders": p["holders"],
                 "checksums": p["step_checksums"][i]} for p in per]
        check(_same_checksums(recs, lambda k: True),
              f"phase 4l ({label}) step {i}: ranks differ in the bits "
              f"they share")
    return {"loss_gap_over_one_rank": max(max(g) for g in gaps),
            "norm_gap_over_one_rank": abs(
                per[0]["steps"][0]["grad_norm"] - want[0]["grad_norm"])
            / want[0]["grad_norm"],
            "collectives_predicted": calls}


def phase_family_train(dev, kernels):
    """Phase 4l: the xLSTM, whisper, VLM and hybrid families trained over
    model ranks, 16 gloo ranks sharing the card, each run of
    ``FAMILY_TRAIN_RUNS`` on ranks 0..m-1 over (1, m),
    ``FAMILY_TRAIN_STEPS`` sharded train steps (``remat="full"``) held to
    the d = 1 run of the same weights and batches, run here first and
    freed before the ranks spawn: (a) xlstm-350m cut to 12 blocks, float32
    compute, over (1, 8) (mLSTM heads on ranks 0-3, none on 4-7); (b)
    whisper-small cut to 2 + 2 layers over (1, 16) (12 heads on ranks 0-11, none on
    12-15); (c)
    internvl2-26b at full width cut to 4 layers over (1, 2); (d)
    jamba-1.5-large at full width in one period of ``attn_every = 2`` with
    4 experts, ``expert_tp``, Adafactor, over (1, 2); (e) starcoder2-15b
    and (f) mistral-nemo-12b at full width cut to 2 layers over (1, 16),
    each KV head shared by 4 and 2 ranks.  Before the ranks spawn each
    run's reckoning (:func:`family_train_reckoning`) over its ranks, the
    CUDA contexts and what this process holds must stay under
    ``FAMILY_TRAIN_MEMORY`` (this process's reserved memory counted);
    after, each rank's peak under its reckoning,
    :func:`family_train_check`, and where KV heads are shared step 0's
    gradient of each :func:`family_train_grad_leaf` on every rank within
    ``FAMILY_TRAIN_GRAD_TOL`` of d = 1's cut to its block.  Returns K4's
    launches in the phase (the d = 1 runs' and the ranks') and the ranks'
    K4 rows."""
    import shutil
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import ModelGrid, ModelGroup
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import zero
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase4l"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for k in kernels:
        k.launches = 0
    runs, one, reck, want_grads = {}, {}, {}, {}
    for run, arch, m, b, s, n_layers, over in FAMILY_TRAIN_RUNS:
        cfg = sharded_train_config(arch, n_layers, over)
        runs[run] = (cfg, m, b, s, family_train_batches(
            cfg, b, s, FAMILY_TRAIN_STEPS))
        shared = shares_kv(zero.layout(Transformer(
            cfg, device="meta", group=ModelGrid(ModelGroup(1, 0),
                                                ModelGroup(m, 0)))))
        one[run] = family_train_one_rank(dev, cfg, runs[run][4],
                                         grads=shared)
        if shared:
            want_grads[run] = one[run].pop("grads")
        print(json.dumps({"phase4l_one_rank": run, **one[run]}), flush=True)
        n = sum(c[4] for st in one[run]["steps"] for c in st["k4_calls"])
        want_k4 = family_train_want_k4(cfg, cfg.n_heads, b, s)
        check(all({(tuple(c[0]), tuple(c[1]), c[2], c[3]): c[4]
                   for c in st["k4_calls"]} == want_k4
                  for st in one[run]["steps"]),
              f"phase 4l ({run}): the d = 1 run's K4 calls "
              f"{[st['k4_calls'] for st in one[run]['steps']]}, want "
              f"{want_k4} a step")
    total = flash_attention_fwd.launches
    check(total == sum(c[4] for o in one.values() for st in o["steps"]
                       for c in st["k4_calls"]),
          f"phase 4l: the d = 1 runs launched K4 {total} times")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()     # what this process keeps
    for run, (cfg, m, b, s, _) in runs.items():
        reck[run] = family_train_reckoning(cfg, m, b, s)
        need = reck[run]["all_ranks"] + FAMILY_TRAIN_RANKS * \
            CUDA_CONTEXT_BYTES + held
        print(json.dumps({"phase4l_reckoning": run, "grid": [1, m],
                          "parent_memory_reserved": held,
                          "with_contexts": need, **reck[run]}), flush=True)
        check(need <= FAMILY_TRAIN_MEMORY,
              f"phase 4l ({run}): {need} bytes reckoned over the ranks")
    lines, k4_rows = [], []
    try:
        jobs = [(run, cfg, m, batches)
                for run, (cfg, m, _, _, batches) in runs.items()]
        _, t_ranks = timed(lambda: run_ranks(
            family_train_rank, FAMILY_TRAIN_RANKS, FAMILY_TRAIN_JOIN_SECONDS,
            "phase 4l", str(work), jobs, dev.type))
        pers = {run: [json.loads((work / f"rank{r}_{run}.json")
                                 .read_text()) for r in range(m)]
                for run, (_, m, _, _, _) in runs.items()}
        for run, per in pers.items():       # every record before a check
            print(json.dumps({"phase4l_run": run, "per_rank": [
                {k: v for k, v in i.items()
                 if k not in ("step_checksums", "holders")}
                for i in per]}),
                flush=True)
        for run, (cfg, m, b, s, _) in runs.items():
            per = pers[run]
            line = {
                "run": run, "arch": cfg.name, "n_layers": cfg.n_layers,
                "n_layers_published": get_config_layers(cfg.name),
                "grid": [1, m], "batch": b, "tokens": s,
                "compute_dtype": cfg.compute_dtype,
                "param_dtype": cfg.param_dtype, "optimizer": cfg.optimizer,
                "remat": cfg.remat, "heads_per_rank":
                [i["heads"] for i in per], "one_rank": one[run],
                "reckoning": reck[run],
                "step_seconds": [[g["seconds"] for g in i["steps"]]
                                 for i in per],
                "collectives": [{ph: dict(c) for ph, c in
                                 g["collectives"].items()}
                                for g in per[0]["steps"]],
                "max_memory_allocated": [i["max_memory_allocated"]
                                         for i in per]}
            line.update(family_train_check(
                run, cfg, m, b, s, per, one[run]["steps"],
                FAMILY_TRAIN_LOSS_TOL[run], FAMILY_TRAIN_NORM_TOL[run],
                True))
            if run in want_grads:
                gaps = [leaf_grad_gaps(torch.load(
                    work / f"rank{r}_{run}_grads.pt"), want_grads[run])
                    for r in range(m)]
                leaf_grad_check(f"phase 4l ({run})", gaps,
                                FAMILY_TRAIN_GRAD_TOL)
                line["leaf_grad_gaps"] = gaps
            for info in per:
                check(info["max_memory_allocated"] <= reck[run]["rank"],
                      f"phase 4l ({run}) rank {info['rank']}: peak "
                      f"{info['max_memory_allocated']} bytes over the "
                      f"reckoning's {reck[run]['rank']}")
                total += sum(g["k4_launches"] for g in info["steps"])
                for row in info.get("k4_on_path_inputs", []):
                    k4_rows.append({"arch": cfg.name, **row})
            lines.append(line)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {k.__name__: k.launches for k in kernels}
    emit({"phase": "family_train", "ranks": FAMILY_TRAIN_RANKS,
          "backend": "gloo", "runs": lines, "seconds_ranks": t_ranks,
          "k4_launches": total, "launches_parent": launches,
          "k4_on_path_inputs": k4_rows,
          "seconds": time.perf_counter() - t0})
    check(not any(c for k, c in launches.items()
                  if k != "flash_attention_fwd"),
          f"phase 4l launched graph kernels: {launches}")
    return {"flash_attention_fwd": total}, k4_rows


def get_config_layers(arch) -> int:
    """``arch``'s published depth."""
    from repro_torch.configs.base import get_config
    return get_config(arch).n_layers


def one_ulp_ratio(got, want) -> float:
    """Largest |got - want| / (2^-7·|want| + 1e-6): <= 1 is one bf16 ulp."""
    limit = BF16_ULP * want.double().abs() + 1e-6
    return float(((got.double() - want.double()).abs() / limit).max())


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs K4 scores: all Sq·Sk, or with the causal mask
    (qpos >= kpos, top-left aligned) min(i + 1, Sk) for query i."""
    if not causal:
        return sq * sk
    full = max(0, sq - sk)              # rows past Sk see all Sk keys
    tri = min(sq, sk)
    return tri * (tri + 1) // 2 + full * sk


def k4_times(q, k, v, out, want, reps, causal=True):
    """K4's, its plain version's and SDPA's CUDA-event times on q, k, v
    (causal or not, Sq and Sk as given), and the bound for the work:
    q·kᵀ and p·v over the scored pairs, 4·D flops a pair.  The port's
    ``attention_flops`` (the formula the dry run counts) must equal that
    closed form, counted here from ``attention_pairs``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_flops, flash_attention_fwd, flash_attention_fwd_plain)
    b, sq, h, d = q.shape
    flops = 4 * d * b * h * attention_pairs(sq, k.shape[1], causal)
    counted = attention_flops(q.shape, k.shape, causal)
    check(counted == flops, f"attention_flops {counted} at {tuple(q.shape)} x "
          f"{tuple(k.shape)} causal={causal} != 4·D·B·H·pairs = {flops}")
    bnd, by = bound_ms(nbytes(q, k, v, out), flops, q.dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    return {"ms": cuda_ms(lambda: flash_attention_fwd(q, k, v, causal),
                          reps),
            "plain_ms": cuda_ms(
                lambda: flash_attention_fwd_plain(q, k, v, causal), 3),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps),
            "library_max_abs_diff": max_abs(lib.transpose(1, 2), want),
            "gflop": flops / 1e9, "shape": list(q.shape),
            "k_shape": list(k.shape), "causal": causal,
            "dtype": str(q.dtype)}


def k4_on_path_inputs(q, k, v, causal=True) -> dict:
    """K4 on inputs the main path gave it (bf16, after RoPE and the GQA
    repeat), held to its plain version by ``attention_error_ratios`` (ref:
    the plain version in float32; base: the plain version with p rounded
    to bf16, as ``kernel_k4``), then timed beside it and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (
        attention_error_ratios, flash_attention_fwd, flash_attention_fwd_plain)
    which = fa.variant(q.dtype, q.shape[3])
    check(which == "sm90_wgmma", f"K4 at {tuple(q.shape)} takes {which}")
    out = flash_attention_fwd(q, k, v, causal=causal)
    ref = flash_attention_fwd_plain(q.float(), k.float(), v.float(), causal)
    base = flash_attention_fwd_plain(q, k, v, causal, round_p=True)
    rule = attention_error_ratios(out, ref, base)
    check(rule["ok"], f"K4 wgmma {tuple(q.shape)} x {tuple(k.shape)} "
          f"causal={causal} on the path's inputs: error ratios {rule}")
    del base
    row = k4_times(q, k, v, out, ref, 20, causal)
    row.update(variant=which, max_abs_err=rule["max_abs_err"],
               error_ratios=rule)
    return row


def kernel_k4(launches, by_variant, moe_rows=(), family_rows=(),
              hybrid_rows=(), sharded_rows=(), dryrun_rows=(), two_d_rows=(),
              heads_rows=(), recurrent_rows=(), family_train_rows=(),
              dense_rows=()):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (
        attention_error_ratios, flash_attention_fwd, flash_attention_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    common = k4_times

    # the prefill's shape (B=4, S=2048, 16 heads after the GQA repeat)
    shape = (4, 2048, 16, 128)
    q, k, v = qkv(shape, torch.bfloat16)
    which = fa.variant(q.dtype, shape[3])
    check(which == "sm90_wgmma", f"the prefill shape takes {which}")
    out = flash_attention_fwd(q, k, v, causal=True)
    again = flash_attention_fwd(q, k, v, causal=True)
    sync()
    check(torch.equal(out, again), "K4 wgmma: two launches differ")
    ref = flash_attention_fwd_plain(q.float(), k.float(), v.float())
    base = flash_attention_fwd_plain(q, k, v, round_p=True)
    rule = attention_error_ratios(out, ref, base)
    check(rule["ok"], f"K4 wgmma {shape}: error ratios {rule}")
    row = common(q, k, v, out, ref, 20)
    row.update(name="flash_attention_fwd", launches=launches,
               launches_by_variant=by_variant, variant=which,
               max_abs_err=rule["max_abs_err"],
               tolerance="max|got-ref| <= 2*max|base-ref| + 1e-6 and "
                         "mean|got-ref| <= 2*mean|base-ref| (ref: plain f32,"
                         " base: plain with p rounded to bf16)",
               error_ratios=rule, target_ms=0.6,
               library="scaled_dot_product_attention(is_causal=True) on "
                       "(B, H, S, D) views")
    row["meets_target"] = row["ms"] <= row["target_ms"]
    # the CUDA-core kernel at the same bf16 shape: the time before this PR
    cc = fa.launch("cuda_core", q, k, v, causal=True)
    want = flash_attention_fwd_plain(q, k, v)
    cc_ratio = one_ulp_ratio(cc, want)
    check(cc_ratio <= 1.0, f"K4 cuda_core bf16 {shape}: max|d|/limit "
          f"{cc_ratio} > 1")
    row["cuda_core_bf16"] = {
        "ms": cuda_ms(lambda: fa.launch("cuda_core", q, k, v), 5),
        "max_abs_err": max_abs(cc, want), "max_err_over_limit": cc_ratio,
        "tolerance": f"{BF16_ULP}*|want| + 1e-6 per element"}
    del q, k, v, out, again, ref, base, cc, want

    f32_shape = (1, 1024, 16, 128)
    q, k, v = qkv(f32_shape, torch.float32)
    out = flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_fwd_plain(q, k, v)
    err = max_abs(out, want)
    check(err <= 2e-5, f"K4 float32 {f32_shape}: max|d| {err} > 2e-5")
    f32 = common(q, k, v, out, want, 5)
    f32.update(variant=fa.variant(q.dtype, f32_shape[3]), max_abs_err=err,
               tolerance=2e-5)
    row["f32"] = f32
    row["backward"] = kernel_k4_backward(qkv)
    row["backward_rank_heads"] = kernel_k4_backward(qkv, heads=8)
    row["backward_whisper"] = [kernel_k4_backward(qkv, shape=q, sk=sk,
                                                  causal=c)
                               for q, sk, c in WHISPER_K4_BACKWARD]
    row["moe_path_inputs"] = list(moe_rows)   # phase 4c's layer-0 inputs
    row["families_path_inputs"] = list(family_rows)   # phase 4d's
    row["hybrid_path_inputs"] = list(hybrid_rows)     # phase 4e's
    row["sharded_lm_path_inputs"] = list(sharded_rows)   # phase 4f's rank 0
    row["dryrun_path_inputs"] = list(dryrun_rows)   # phase 4g's rank 0
    row["two_d_path_inputs"] = list(two_d_rows)     # phase 4i's rank 0
    row["heads_path_inputs"] = list(heads_rows)     # phase 4j's ranks 0, m-1
    row["recurrent_path_inputs"] = list(recurrent_rows)   # phase 4k's jamba
    row["family_train_path_inputs"] = list(family_train_rows)   # 4l's
    row["dense_configs_path_inputs"] = list(dense_rows)   # phase 4m's
    return row


# whisper's three attentions a rank of phase 4l (b) trains, (q shape, key
# length, causal): the encoder's, the decoder's self- and cross-attention
WHISPER_K4_BACKWARD = (((2, 1536, 1, 64), 1536, False),
                       ((2, 64, 1, 64), 64, True),
                       ((2, 64, 1, 64), 1536, False))


def kernel_k4_backward(qkv, heads: int = 16, shape=None, sk=None,
                       causal: bool = True):
    """K4 under autograd at phase 4b's shape (``heads`` 16; 8: a rank's of
    phase 4h (a)), or at ``shape`` (B, Sq, H, D) against ``sk`` keys,
    causal or not: the autograd function's dq, dk, dv (K4 forward, the
    PyTorch backward) against autograd through the plain version, and the
    backward's time beside SDPA's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    shape = shape or (TRAIN_BATCH, TRAIN_SEQ, heads, 128)
    b, sq, h, d = shape
    sk = sk or sq
    q, k, v = qkv(shape, torch.bfloat16) if sk == sq else (
        qkv(shape, torch.bfloat16)[0], *qkv((b, sk, h, d), torch.bfloat16)[:2])
    dout = qkv(shape, torch.bfloat16)[0]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention(*leaves, causal=causal, q_chunk=TRAIN_SEQ)
    got = torch.autograd.grad(out, leaves, dout)
    check(fa.flash_attention_fwd.launches == before + 1,
          "the autograd function's forward did not launch K4")
    ref = fa.plain_grads(q.float(), k.float(), v.float(), dout.float(),
                         causal)
    base = fa.plain_grads(q, k, v, dout, causal, round_p=True)
    rule = fa.grad_error_ratios(got, ref, base)
    check(rule["ok"], f"K4 backward {shape} x {sk} keys causal={causal}: "
          f"error ratios {rule}")
    # q·kᵀ, p·v recomputed, and dv, dp, dq, dk: 6 products, 2·D a pair
    flops = 12 * d * b * h * attention_pairs(sq, sk, causal)
    bnd, by = bound_ms(nbytes(q, k, v, dout, *got), flops, q.dtype)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dlib = dout.transpose(1, 2)
    lib_grads = torch.autograd.grad(lib, (qt, kt, vt), dlib,
                                    retain_graph=True)
    return {"shape": list(shape), "k_shape": [b, sk, h, d],
            "causal": causal, "dtype": "torch.bfloat16",
            "route": "torch", "source":
                "src/repro_torch/kernels/flash_attention.py "
                "(flash_attention_bwd)",
            "ms": cuda_ms(lambda: fa.flash_attention_bwd(
                q, k, v, dout, causal, TRAIN_SEQ, True), 5),
            "plain_ms": cuda_ms(lambda: fa.plain_grads(
                q, k, v, dout, causal, round_p=True), 3),
            "bound_ms": bnd, "bound_by": by, "gflop": flops / 1e9,
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib, (qt, kt, vt), dlib, retain_graph=True), 5),
            "library": f"scaled_dot_product_attention(is_causal={causal}) "
                       f"backward, as a yardstick only",
            "library_max_abs_diff": max(
                max_abs(a.transpose(1, 2), r)
                for a, r in zip(lib_grads, ref)),
            "max_abs_err": max(rule[n]["max_abs_err"]
                               for n in ("dq", "dk", "dv")),
            "tolerance": "per gradient: max|got-ref| <= 2*max|base-ref| + "
                         "1e-6 and mean|got-ref| <= 2*mean|base-ref| (ref: "
                         "autograd through the plain f32 version, base: "
                         "through the plain bf16 version with p rounded)",
            "error_ratios": rule}


def kernel_k1(g14, launches, ptxas):
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_spmv as k1
    from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
    from repro_torch.kernels.pieces import piece_table
    tiles, rows, cols, nb = g14.plan().bsr()
    b, nnzb, dev = tiles.shape[1], tiles.shape[0], tiles.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((nb, b), generator=gen, device=dev)
    y = bsr_spmv(tiles, rows, cols, x, nb)
    y_again = bsr_spmv(tiles, rows, cols, x, nb)
    y_plain = bsr_spmv_plain(tiles, rows, cols, x, nb)
    check(torch.equal(y, y_again), "K1: two launches differ")
    err = max_abs(y, y_plain)
    tol = 1e-5 * max(1.0, float(y_plain.abs().max()))
    check(err <= tol, f"K1 f32: {err} > {tol}")
    tiles_bf = tiles.to(torch.bfloat16)
    err_bf = max_abs(bsr_spmv(tiles_bf, rows, cols, x, nb),
                     bsr_spmv_plain(tiles_bf, rows, cols, x, nb))
    tol_bf = 5e-2 * max(1.0, float(y_plain.abs().max()))
    check(err_bf <= tol_bf, f"K1 bf16: {err_bf} > {tol_bf}")
    # piece size -> ms: how PIECE_TILES was chosen
    sweep = {}
    for piece in (2, 4, 8, 16, 32):
        yp = k1.launch(tiles, rows, cols, x, nb, piece)
        check(max_abs(yp, y_plain) <= tol, f"K1 piece {piece}: differs")
        sweep[piece] = cuda_ms(lambda: k1.launch(
            tiles, rows, cols, x, nb, piece), 10)
    ms = cuda_ms(lambda: bsr_spmv(tiles, rows, cols, x, nb), 20)
    # the C entry point alone (its four kernels), the wrapper's
    # allocations and checks left out
    tables = torch.empty((2 * (nb + 1),), dtype=torch.int32, device=dev)
    max_pieces = nb + -(-nnzb // k1.PIECE_TILES)
    part = torch.empty((max_pieces, b), device=dev)
    y_k = torch.empty_like(y)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel_ms = cuda_ms(lambda: _build.launch(
        "bsr_spmv_f32", tiles.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        x.data_ptr(), tables.data_ptr(), part.data_ptr(), y_k.data_ptr(),
        nnzb, nb, b, k1.PIECE_TILES, max_pieces, stream), 20)
    check(torch.equal(y_k, y), "K1 kernels alone differ from the wrapper")
    row_start = torch.searchsorted(
        rows, torch.arange(nb + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    check(torch.equal(tables[:nb + 1], row_start) and torch.equal(
        tables[nb + 1:], piece_table(row_start, k1.PIECE_TILES)),
        "K1's device-built tables differ from piece_table")
    plain_ms = cuda_ms(lambda: bsr_spmv_plain(tiles, rows, cols, x, nb), 5)
    lib_ms, lib_note = None, "torch.sparse_bsr_tensor @ x"
    try:
        a = torch.sparse_bsr_tensor(row_start, cols, tiles,
                                    size=(nb * b, nb * b))
        xv = x.reshape(-1, 1)
        lib_err = max_abs((a @ xv).reshape(nb, b), y_plain)
        lib_ms = cuda_ms(lambda: a @ xv, 20)
        lib_note += f" (max|d| vs plain {lib_err})"
    except (RuntimeError, NotImplementedError) as e:   # yardstick only
        lib_note += f" unavailable: {str(e).splitlines()[0][:160]}"
    bnd, by = bound_ms(nbytes(tiles, rows, cols, x, y),
                       2 * nnzb * b * b, torch.float32)
    ms_bf = cuda_ms(lambda: bsr_spmv(tiles_bf, rows, cols, x, nb), 20)
    bnd_bf, _ = bound_ms(nbytes(tiles_bf, rows, cols, x, y),
                         2 * nnzb * b * b, torch.bfloat16)
    if lib_ms is not None:
        check(ms < lib_ms, f"K1 {ms} ms not faster than the library's "
              f"{lib_ms} ms")
    return {"name": "bsr_spmv", "launches": launches, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "library": lib_note, "kernels_only_ms": kernel_ms,
            "bit_equal_twice": True, "piece_tiles": k1.PIECE_TILES,
            "pieces": int(piece_table(row_start, k1.PIECE_TILES)[-1]),
            "piece_sweep_ms": sweep,
            "faster_than_library": None if lib_ms is None else ms < lib_ms,
            "share_of_byte_bound": bnd / ms, "ptxas": ptxas,
            "shape": {"tiles": list(tiles.shape), "n_row_blocks": nb},
            "bf16": {"max_abs_err": err_bf, "tolerance": tol_bf, "ms": ms_bf,
                     "bound_ms": bnd_bf,
                     "share_of_byte_bound": bnd_bf / ms_bf}}


def kernel_k2(g22, launches):
    from repro_torch.core import engine
    from repro_torch.kernels.segment_sum import (segment_sum_chunked,
                                                 segment_sum_chunked_plain)
    from repro_torch.kernels import segment_sum as ss
    ex = engine.get_exec(g22.plan(), "pallas")
    lids, blk, nb = ex.p_lids, ex.p_blk, ex.nb_in
    dev = lids.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ev = torch.rand((g22.n_edges,), generator=gen, device=dev)
    vals = torch.zeros(lids.shape, dtype=torch.float32, device=dev)
    vals.view(-1)[ex.p_pos] = ev
    y = segment_sum_chunked(vals, lids, blk, nb)
    y_again = segment_sum_chunked(vals, lids, blk, nb)
    y_plain = segment_sum_chunked_plain(vals, lids, blk, nb)
    check(torch.equal(y, y_again), "K2: two launches differ")
    err = max_abs(y, y_plain)
    tol = 1e-5 * max(1.0, float(y_plain.abs().max()))
    check(err <= tol, f"K2: {err} > {tol}")
    block_start = torch.searchsorted(
        blk, torch.arange(nb + 1, dtype=torch.int32, device=dev))
    longest = int((block_start[1:] - block_start[:-1]).max())
    pieces = int(ss.piece_table(block_start.to(torch.int32),
                                ss.PIECE_CHUNKS)[-1])
    sweep = {}   # piece size -> ms: how PIECE_CHUNKS was chosen
    for piece in (4, 8, 16, 32, 64):
        yp = ss.launch(vals, lids, blk, nb, piece)
        check(max_abs(yp, y_plain) <= tol, f"K2 piece {piece}: differs")
        sweep[piece] = cuda_ms(lambda: ss.launch(vals, lids, blk, nb, piece),
                               10)
    ms = cuda_ms(lambda: segment_sum_chunked(vals, lids, blk, nb), 20)
    # the C entry point alone (its four kernels), the wrapper's
    # allocations and checks left out
    from repro_torch.kernels import _build
    tables = torch.empty((2 * (nb + 1),), dtype=torch.int32, device=dev)
    max_pieces = nb + -(-vals.shape[0] // ss.PIECE_CHUNKS)
    part = torch.empty((max_pieces, 128), device=dev)
    y_k = torch.empty_like(y)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel_ms = cuda_ms(lambda: _build.launch(
        "segment_sum_chunked", vals.data_ptr(), lids.data_ptr(),
        blk.data_ptr(), tables.data_ptr(), part.data_ptr(), y_k.data_ptr(),
        vals.shape[0], nb, vals.shape[1], ss.PIECE_CHUNKS, max_pieces,
        stream), 20)
    check(torch.equal(y_k, y), "K2 kernels alone differ from the wrapper")
    bs32 = block_start.to(torch.int32)
    check(torch.equal(tables[:nb + 1], bs32) and torch.equal(
        tables[nb + 1:], ss.piece_table(bs32, ss.PIECE_CHUNKS)),
        "K2's device-built tables differ from piece_table")
    plain_ms = cuda_ms(lambda: segment_sum_chunked_plain(vals, lids, blk, nb), 3)
    keep = lids < 128
    gid = (blk.long()[:, None] * 128 + lids.long())[keep]
    flat = vals[keep]
    out = torch.zeros((nb * 128,), dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: out.zero_().index_add_(0, gid, flat), 10)
    bnd, by = bound_ms(nbytes(vals, lids, blk, y), vals.numel(),
                       torch.float32)
    return {"name": "segment_sum_chunked", "launches": launches,
            "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms,
            "library": "index_add_ over precomputed global ids (includes a zero_)",
            "bit_equal_twice": True, "piece_chunks": ss.PIECE_CHUNKS,
            "pieces": pieces, "longest_block_run_chunks": longest,
            "piece_sweep_ms": sweep, "kernels_only_ms": kernel_ms,
            "faster_than_library": ms < lib_ms,
            "shape": {"chunks": list(vals.shape), "n_out_blocks": nb}}


def kernel_k3(u14, launches, by_variant, ptxas):
    from repro_torch.kernels import bsr_tricount as k3
    from repro_torch.kernels.bsr_tricount import (bsr_tricount,
                                                  bsr_tricount_plain)
    plan = u14.plan()
    tiles, rows, cols, nb = plan.bsr()
    tiles = torch.clamp(tiles, max=1.0)
    t_ij, t_ik, t_kj = plan.tri_triples()
    b, n_tri, dev = tiles.shape[1], int(t_ij.shape[0]), tiles.device
    check(k3.variant(b) == "sm90_wgmma", f"K3 at B = {b} takes "
          f"{k3.variant(b)}")
    runs = torch.empty((n_tri + 2,), dtype=torch.int32, device=dev)
    got = int(k3.launch("sm90_wgmma", tiles, t_ij, t_ik, t_kj, runs=runs))
    want = int(bsr_tricount_plain(tiles, t_ij, t_ik, t_kj))
    check(got == want, f"K3: kernel {got} != plain {want}")
    table = k3.run_table(t_ij, k3.max_run(b))
    check(torch.equal(runs[:table.numel()], table),
          "K3's device-built run table differs from run_table")
    check(int(bsr_tricount(tiles, t_ij, t_ik, t_kj)) == got,
          "K3: two launches differ")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = torch.randperm(n_tri, generator=gen, device=dev)
    shuffled = [t[order].contiguous() for t in (t_ij, t_ik, t_kj)]
    got_shuffled = int(bsr_tricount(tiles, *shuffled))
    check(got_shuffled == want, f"K3 on shuffled triples: {got_shuffled} "
          f"!= {want}")
    ms = cuda_ms(lambda: bsr_tricount(tiles, t_ij, t_ik, t_kj), 5)
    shuffled_ms = cuda_ms(lambda: bsr_tricount(tiles, *shuffled), 2)
    got_wmma = int(k3.launch("wmma", tiles, t_ij, t_ik, t_kj))
    check(got_wmma == want, f"K3 wmma: {got_wmma} != {want}")
    wmma_ms = cuda_ms(lambda: k3.launch("wmma", tiles, t_ij, t_ik, t_kj), 3)
    check(wmma_ms >= 8 * ms, f"K3 wgmma {ms} ms is not 8x faster than "
          f"wmma {wmma_ms} ms")
    plain_ms = cuda_ms(lambda: bsr_tricount_plain(tiles, t_ij, t_ik, t_kj), 3)
    flops = 2 * b ** 3 * n_tri + b * b * n_tri
    bnd, by = bound_ms(nbytes(tiles, t_ij, t_ik, t_kj) + 8, flops,
                       torch.float16)
    # yardstick: the dense fp16 product A.A of the whole adjacency, the
    # product alone (no mask, no sum); timed only
    n = nb * b
    dense = torch.zeros((n, n), dtype=torch.float16, device=dev)
    dense.view(nb, b, nb, b)[rows.long(), :, cols.long(), :] = \
        tiles.to(torch.float16)
    lib_ms = cuda_ms(lambda: torch.mm(dense, dense), 5)
    del dense
    return {"name": "bsr_tricount", "launches": launches,
            "launches_by_variant": by_variant, "variant": k3.variant(b),
            "max_abs_err": float(abs(got - want)), "tolerance": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "tflops": flops / (ms * 1e9),
            "library_ms": lib_ms,
            "library": f"torch.mm of the dense ({n}, {n}) fp16 0/1 adjacency "
                       f"with itself: the product alone, timed only",
            "six_triangles": got, "six_triangles_shuffled": got_shuffled,
            "shuffled_ms": shuffled_ms, "runs": int(table[0]),
            "wmma": {"ms": wmma_ms, "six_triangles": got_wmma,
                     "speedup_of_wgmma": wmma_ms / ms},
            "ptxas": ptxas,
            "shape": {"tiles": list(tiles.shape), "triples": n_tri}}


def ptxas_report(source: str) -> dict:
    """Registers and spills of each kernel ptxas compiled from ``source``
    (from the build's ``-Xptxas -v`` log); fails on any spill."""
    from repro_torch.kernels import _build
    log = (_build.build_dir() / "build.log").read_text()
    text = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        # the mangled name without its anonymous-namespace prefix
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                      part.split("'", 1)[0])
        regs = part.split("Used ", 1)[1].split(" registers", 1)[0]
        spills = part.split("bytes stack frame, ", 1)[1].split("\n", 1)[0]
        out[name] = {"registers": int(regs), "spills": spills.strip()}
        check(spills.startswith("0 bytes spill stores, 0 bytes spill loads"),
              f"{source} {name}: {spills}")
    check(bool(out), f"no ptxas report for {source}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a 10-round \"bsr\" PageRank, one "
                         "prefill and one decode step of each model")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    expandable_segments()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmv import bsr_spmv
    from repro_torch.kernels.bsr_tricount import bsr_tricount
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.segment_sum import segment_sum_chunked

    # float32 products in the plain versions run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve(None)

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.load()
    emit({"phase": "build", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_seconds": _build.build_seconds,
          "build_dir": str(_build.build_dir().relative_to(ROOT)),
          "seconds": time.perf_counter() - t0})

    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    for k in kernels:
        k.launches = 0
    g22, edges22 = phase_pagerank_scale(dev, 22)
    g14, u14, k3_variants = phase_bsr(dev, 14)
    path = {k.__name__: k.launches for k in kernels[:3]}
    check(path["bsr_spmv"] == K1_PATH_LAUNCHES, f"K1 launched "
          f"{path['bsr_spmv']} times on the path, not {K1_PATH_LAUNCHES}")
    if args.profile:
        profile_bsr(g14)
    phase_traversal(dev, g22, g14, u14)
    phase_tables(dev, edges22)
    del edges22
    incremental = phase_incremental(dev, g22, g14)
    service = phase_service(dev, g22, g14, u14)
    sharded, sharded_ref = phase_sharded(dev, g22, u14)
    sharded_service = phase_sharded_service(dev, g22, sharded_ref)
    del sharded_ref
    path["flash_attention_fwd"], k4_variants, yard = phase_serve(
        dev, kernels, args.profile)
    for name, n in path.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    torch.cuda.empty_cache()
    moe_serve, k4_moe, yards = phase_moe_serve(
        dev, kernels, args.profile, sharded_lm_baselines())
    torch.cuda.empty_cache()
    sharded_lm, k4_sharded = phase_sharded_lm(
        dev, {SHARDED_LM_MODELS[0][0]: yard, **yards})
    del yard, yards
    families, k4_families, heads_yards = phase_families(dev, kernels,
                                                        args.profile)
    torch.cuda.empty_cache()
    hybrid, k4_hybrid = phase_hybrid(dev, kernels, args.profile)
    torch.cuda.empty_cache()
    dense, k4_dense = phase_dense_configs(dev, kernels, args.profile)
    dry, k4_dry = phase_dryrun(dev, kernels)
    torch.cuda.empty_cache()
    # the graph kernels' rows now; then the graphs' derived arrays go (their
    # plans outlive these names: 12.6 GB evicted on the card), so that
    # phases 4b and 4h have the card
    t0 = time.perf_counter()
    rows = [kernel_k1(g14, path["bsr_spmv"], ptxas_report("bsr_spmv.cu")),
            kernel_k2(g22, path["segment_sum_chunked"]),
            kernel_k3(u14, path["bsr_tricount"], k3_variants,
                      ptxas_report("bsr_tricount.cu"))]
    t_graph_rows = time.perf_counter() - t0
    for g in (g22, g14, u14):
        g.plan().evict_all()
    del g22, g14, u14
    gc.collect()        # the graphs' arrays sit in reference cycles
    torch.cuda.empty_cache()
    train, baseline = phase_train(dev, kernels, args.profile)
    torch.cuda.empty_cache()
    sharded_train, one_rank = phase_sharded_train(dev, kernels, baseline)
    batches = baseline["batches"]
    del baseline
    torch.cuda.empty_cache()
    two_d, k4_two_d = phase_two_d(dev, kernels, one_rank["c"], batches)
    del batches
    torch.cuda.empty_cache()
    heads, k4_heads = phase_heads(dev, kernels, heads_yards)
    del heads_yards
    torch.cuda.empty_cache()
    recurrent, k4_recurrent = phase_recurrent(dev, kernels)
    torch.cuda.empty_cache()
    family_train, k4_family_train = phase_family_train(dev, kernels)
    torch.cuda.empty_cache()

    t0 = time.perf_counter() - t_graph_rows
    rows.append(kernel_k4(path["flash_attention_fwd"], k4_variants, k4_moe,
                          k4_families, k4_hybrid, k4_sharded, k4_dry,
                          k4_two_d, k4_heads, k4_recurrent,
                          k4_family_train, k4_dense))
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]],
                 replaces=REPLACES[r["name"]],
                 launches_phase_3d=incremental.get(r["name"], 0),
                 launches_phase_3e=service.get(r["name"], 0),
                 launches_phase_3f=sharded.get(r["name"], 0),
                 launches_phase_3g=sharded_service.get(r["name"], 0),
                 launches_phase_moe=moe_serve.get(r["name"], 0),
                 launches_phase_sharded_lm=sharded_lm.get(r["name"], 0),
                 launches_phase_families=families.get(r["name"], 0),
                 launches_phase_hybrid=hybrid.get(r["name"], 0),
                 launches_phase_dense_configs=dense.get(r["name"], 0),
                 launches_phase_dryrun=dry.get(r["name"], 0),
                 launches_phase_train=train.get(r["name"], 0),
                 launches_phase_sharded_train=sharded_train.get(r["name"],
                                                                0),
                 launches_phase_two_d=two_d.get(r["name"], 0),
                 launches_phase_heads=heads.get(r["name"], 0),
                 launches_phase_recurrent=recurrent.get(r["name"], 0),
                 launches_phase_family_train=family_train.get(r["name"],
                                                              0))
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
