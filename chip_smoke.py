"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

  1. the card: name and power limit (nvidia-smi), torch / CUDA versions;
  2. build: every CUDA source under src/repro_torch/kernels/csrc, one nvcc
     per source, all started together; build seconds and ptxas's register,
     shared-memory and spill report; no instance of the cost-row tile loop
     (kexp.cu `cost_rows_kernel`: #5, #6, #7) may spill; their resident
     blocks an SM and dynamic shared memory (the occupancy calculator);
  3. the main path at sinkhorn-wmd/paper_5k (V = 100,000, w = 300,
     N = 5,000, v_r bucket 32, 15 iterations; `make_corpus(seed=0)`):
     `WMDService(device="cuda", cache_capacity=1024)` with its defaults
     (impl="kernel", kexp_impl="kernel") answers two Zipf batches of
     Q = 16 (19 words a query); the kernels' launch counts, read around
     exactly those two calls, must be 15 type1 and 1 type2 launches and
     two vocab-major copies (k_vocab_major: K's and K.*M's) per batch and
     one cdist_kexp_rows launch per 128-row miss chunk, all 30 #3
     launches on the query-group tile (`sddmm_spmm.tile_launches`) and
     each batch's ``fused_launches`` 16. Then batch 2's
     `query_batch` once more, counted (`_counted_wmd`, the cost model
     `repro_torch.launch.costmodel`): its flops, fused and eager bytes,
     each kernel's declared cost (`kernels.costs`) times its counted calls,
     which must equal the launches read around the call (15 #3, one #4,
     two copies), and the roofline's dominant term (`roofline.terms`:
     fp32 67 TFLOP/s, HBM 3.35 TB/s) against the device busy of the same
     call, and each kernel group's (KERNEL_GROUPS) summed declared cost
     against its kernels' device time in the same trace: each at most
     1.05 x (no card beats its roofline);
  4. correctness of what came out: the same batches through the plain
     engine on the same K rows (impl="fused"), through the all-plain route
     (impl="fused", kexp_impl="jnp"), cache on == use_cache=False bitwise,
     the legacy route (cache off), and the dense oracle
     `sinkhorn_wmd_dense` on a 64-doc slice (see `_compare` for the
     tolerances of routes whose K rows come from another spelling);
  6. the pruned path at paper_5k: `WMDService(device="cuda",
     cache_capacity=1024, mcache_capacity=1024)` with its defaults (impl,
     kexp_impl, bound_impl and lc_impl all "kernel", prune_chunk 64)
     answers `top_k_batch(prune=True)` with k = 10 on the two batches of
     phase 3, then batch 1 again with rerank="union". The launch counts,
     read around exactly those three calls, must be: type1 15 x and type2
     1 x the rerank programs, two k_vocab_major (K, K.*M) per stripe set
     (each query's on the per-query rerank, the batch's on the union
     rerank), one lc_rwmd_bound_batch (tier 1) and one rwmd_bound_batch
     (tier 2) per call, one cdist per 128-row chunk of M misses and one
     cdist_kexp_rows per 128-row chunk of K misses of each K-cache lookup
     (all read from last_prune_stats and mcache_stats); then batch 2's
     pruned per-query call counted as phase 3's (`_counted_wmd`);
  7. correctness of the pruned path: the exhaustive scan == pruned ==
     union, bitwise; the tier toggles (tier0=False, lc_impl=None) give the
     same bits; the pruned answer is the top-k of phase 3's full
     `query_batch` rows, bitwise; the same ids as the all-plain service
     (every impl "fused", kexp_impl "jnp"), distances by `_compare`,
     near-ties that the two routes order differently printed and held to
     that tolerance (`_check_plain_topk`); the kernel bounds
     (`query_batch_bounds`) <= the kernel route's distances on all
     16 x 5,000 pairs, and within rtol 1e-5, atol 1e-6 of the plain
     min-SDDMM on the same M stripes; then, where the time goes: batch 2
     once more through `query_batch` and both pruned reranks, warm, under
     torch.profiler: wall time, the device's busy time and idle share, the
     largest device entries, and the K / K.*M copies in the trace, which
     must be two per stripe set;
  8. the per-query path at paper_5k: a fresh `WMDService(device="cuda")`
     with its defaults (impl and kexp_impl "kernel", no cache) answers
     `top_k(r, 10)` for each of batch 1's 16 queries, then
     `query_batch_sequential(batch2)`: the per-query program
     (`core.distributed.build_wmd_fn`). The launch counts, read around
     exactly those calls, must be one cdist_kexp, two k_vocab_major (the
     query's K and K.*M stripes), 15 sddmm_spmm_type1 and one
     sddmm_spmm_type2 a query and nothing else (so never the #2 / #4
     oracle `sddmm_spmm_type2_naive`), every #1 on the warp tile (no
     query-group launch); `query(r)` must equal phase 3's
     `query_batch` rows bitwise on all 32 queries (and top_k
     their top-k); the all-plain per-query service (impl "fused",
     kexp_impl "jnp") and the dense oracle on the 64-doc slice by
     `_compare`; `sinkhorn_wmd_converged` for one query (n_iter, delta;
     bitwise the fixed fused loop at that n_iter); the per-query wall
     time, queries/s and the `[idle]` line of one warm `query(r)` (two
     copies in its trace, no oracle); that `query(r)` counted as phase 3's
     (`_counted_wmd`: one #5, two copies, 15 #1, one #2);
  9. async serving at paper_5k: a fresh `WMDService(device="cuda",
     cache_capacity=1024, mcache_capacity=1024)` with its defaults, an
     `EngineGuard` with the default `ResiliencePolicy`, a `Tracer`, and
     `svc.async_service(window_ms=2, max_batch=16, max_queue=256)` over
     them. `warm_registry(ks=(10,))` dispatches every shape once (every
     kernel library must already be loaded, by phase 2, so the warmup's
     nvcc compiles and library loads are 0 by construction; each shape's
     first-call seconds printed). Phase 3's 32 queries are submitted from
     4 client threads as plain requests, drained, then as
     `submit_top_k(r, 10)`: every plain row must be phase 3's
     `query_batch` row bitwise and replay bitwise from `batch_log`, every
     top-k answer the top-k of phase 3's rows; the launches, read around
     each run, must be 15 type1, 1 type2 and 2 k_vocab_major a plain
     dispatch and one cdist_kexp_rows a 128-row K miss chunk, and on the
     top-k run one lc_rwmd_bound_batch and one rwmd_bound_batch a
     dispatch plus phase 6's rerank counts (never the oracle); the
     guard's retries, failures, demotions and degraded answers must all
     be 0, every span tree must close exactly once. Then an open loop of
     64 `zipf_query_stream(seed=2)` queries at half the saturating plain
     rate (q/s, mean batch, triggers, latency p50/p95/p99), the `[idle]`
     lines of the coalesced plain run and of the synchronous
     `query_batch` of the same two batches, and the launcher's serving
     loop in-process (`launch.serve.main`, 64 top-10 requests,
     `--resilience`): its stats JSON must show 64 of 64 served, none
     degraded;
 10. the live corpus at paper_5k: a `LiveCorpus(normalize=False)` in a
     temporary directory, seeded from the corpus's docs through a history
     of 5 adds of docs 0-2,499, a compaction, 16 upserts of wrong content,
     8 extraneous ids >= 5,000 added and removed, 10 adds of docs
     2,500-4,999, the 16 corrected, and a kill injected at
     ``compact.snapshot.tmp`` (`serving.faultinject.CrashInjector`), then
     a reopen from disk: about half the docs in the base, half in the
     delta. `WMDService.from_live(..., device="cuda", cache_capacity=1024,
     mcache_capacity=1024)` must give `live_doc_ids == arange(5000)`; live
     `query_batch` rows bitwise phase 3's (launches: 15 type1 and 1 type2
     per non-empty segment, two k_vocab_major a call, one
     cdist_kexp_rows a 128-row miss chunk); live pruned top-k (k = 10)
     == the live scan == the top-k of phase 3's rows, bitwise (launches:
     one lc_rwmd_bound_batch and one rwmd_bound_batch over the base a
     call, then 15 type1 + 1 type2 a program, delta and base blocks, two
     k_vocab_major a query, cdist and cdist_kexp_rows per miss chunk);
     ``rerank="union"`` takes the counted full-scan fallback, same bits;
     live bounds == phase 7's static bounds, bitwise, and bounds; the
     `[idle]` lines of the static and the live `query_batch` and pruned
     calls; the ack latency (p50 / p99) of single-doc `add_docs`; a clean
     compaction at 5,000 docs (timed; rows and top-k bitwise again) and
     the recovery of its snapshot (timed); and the launcher twice on one
     ``--live-dir`` (seeded, then recovered; ``--ingest-stream 8
     --compact-every 3``, 64 top-10 requests): every write op acked;
 11. multi-device serving at paper_5k on single-controller meshes of
     logical shards on one card (`launch.mesh.make_mesh(..., devices=
     [cuda:0] * 4)`; the count of visible cards is printed, and where it is
     above 1 the (2, 2) mesh also runs over distinct cards, bitwise the
     one-card rows). A (4, 1) mesh (four doc shards of 1,250 docs,
     `cache_capacity=1024`, `mcache_capacity=1024`): `query_batch` rows,
     `query(r)` on all 32 queries, pruned top-k (per_query, union), bounds
     and a live service over phase 10's directory (a fifth of the docs
     upserted into its delta) are phase 3's / 6's / 7's answers, bitwise;
     launches exact (15 #3 and one #4 a doc shard, one pair of copies a
     stripe set, one #6 a 128-row miss chunk; the pruned calls' counts from
     `last_prune_stats`). A (2, 2) mesh (two 50,000-word stripes, two doc
     shards): each shard's K and K.*M stripes are phase 3's split at column
     50,000, bitwise; cache on == off, pruned == scan == union and
     `query(r)` == `query_batch` rows, bitwise; rows against phase 3's by
     `_compare` (max relative difference printed); launches exact (15 #3
     and one #4 a position, two copies a stripe, #6 a shard a chunk). With
     ``tol=1e-5`` (300 iterations at most) the (4, 1) n_iter equals the
     one-device program's and the (2, 2) one is within one. The `[idle]`
     lines of the warm `query_batch` of batch 2 on 1 x 1, (4, 1) and (2, 2)
     with each call's peak device memory, and the launcher in-process with
     ``--devices 4 --mesh 2x2 --top-k 10 --prune`` (every query answered);
  5. (run last, so that its launch column reads the runs of phases 3, 6,
     8, 9, 10 and 11: each kernel's launches summed over the six) each kernel
     against its plain PyTorch version at the main path's shapes (the
     per-query kernels #5, #1, #2 at one query's: v_r 32; #3 bitwise
     against #1 on each of the 16 queries, #4 against #2 on each, #1
     against #3 at Q = 1, #2 against #4 at Q = 1 and against its
     reference-layout oracle `sddmm_spmm_type2_naive` (the sha256 of #2's
     output printed); #3, #4, #1 and #2 reading the iterate x
     (``from_x``, the Sinkhorn loops' route) bitwise against `safe_recip`,
     the kernel on u and the divide by r, at the batch's shape and at a
     65,536-doc slice of the prod_5m corpus (`_fused_iterate_check`:
     x seeded with 0, values below 1e-30, -1, +inf, NaN and 1e38, four pad
     docs exactly 0, #3 on its query-group tile bitwise #3 on the warp tile
     (`sddmm_spmm_type1_batch_warp`), the device ms of both spellings and
     of #3 on both tiles, at the batch's Q and at Q 2-4); #5 against
     #6's rows, #5, #6 and #7 bitwise against their one-thread-an-output oracle `cost_rows_naive` (the
     sha256 of #6's and #5's outputs printed), own words exactly M = 0,
     K = 1, #9 against #8 and #8's two routes against each other (the
     gather route at tier 2's 256 docs, the dense route at all N, each
     also timed by the other route; `column_min_kernel` bitwise
     `torch.amin` and timed beside it; sector floors and sha256s printed);
     the K copy beside #3, #4 also at the per-query rerank's (1, 64) block,
     #1 with its copy and #2 with its two, both at docs_blk 4, 8 and 16,
     and #9 beside `torch.sparse.mm`), with its time (CUDA events), its
     device time (`_device_ms`: CUDA events around launches queued behind
     a spin kernel; #3's within 5% of its time a launch in a traced loop
     of 15), the plain version's time, a library yardstick where one
     exists, and the bound: the larger of the bytes
     the function must move over 3.35 TB/s and its fp32 operations over
     67 TFLOP/s (H100 SXM data sheet, 700 W).

  12. (run after phases 1-11 and 5 have released their tensors) the
     language model: `deepseek-moe-16b` as published (28 layers, d_model
     2048, 64 routed experts top-6 + 2 shared, vocab 102,400; 16.4 B
     float32 parameters made on the card from a `torch.Generator` seeded
     0), batch 4, prefill 64, 32 greedy decode steps, q_block = kv_block
     = 16 (the reference launcher's defaults), through `build_model` and
     `serving.build_serve_fns`: (a) with the published top-k router and
     with the Sinkhorn router on the same parameters: finite logits,
     tokens in range, a second decode loop from the same cache bitwise
     the first; prefill ms and decode ms a token (CUDA events), the
     decode step's `[idle]` line, the peak device memory and the decode
     step's HBM bound from the bytes the code moves; (d) the coefficient
     of variation of the expert loads of the first MoE layer's router
     logits of (a)'s prefill under both routers: Sinkhorn's under half
     top-k's; (b) decoding 8 tokens one by one gives the prefill's logits
     on the extended sequence (capacity factor 16, so that no token is
     dropped, as the reference test's factor 8 does at its smoke size):
     argmax equal, relative error under 5e-2; (c) two layers of the full width (the dense layer 0
     and one MoE layer) from one numpy tree through
     `convert.lm_params_from_numpy` on the CPU and the card: prefill
     logits within 2e-2 (bfloat16) and 1e-4 (float32 compute) of the
     largest |logit|; no WMD kernel launched in the phase; (e) the
     launcher as a subprocess (`python -m repro_torch.launch.serve --arch
     deepseek-moe-16b --batch 4 --prefill-len 64 --decode-steps 32`):
     exit 0 and both `[serve]` lines; (g) one bf16 top-k decode step
     counted on the card (`_phase12_count`): its eager bytes at least
     `_decode_bytes`' code figure, its fused bytes at most it, its
     roofline term (bf16 989.4 TFLOP/s, HBM) at most the measured decode
     ms; the same step lowered on meta (`launch.dryrun.analyze`): its
     memory_analysis arguments within 1% of the bytes of the card's
     parameter and cache storages, its temporaries within 25% of what one
     decode step adds to torch.cuda.memory_allocated at its peak
     (torch.cuda.max_memory_allocated after a reset).

  13. the remaining mixers on one card: its checks run in phase 16(a)'s
     1 x 1 runs, on the same parameters (listed there).

  14. (run after phase 12 has released its parameters) language-model
     training: `deepseek-moe-16b` at full width (d_model 2048, 64 routed
     experts top-6 + 2 shared, vocab 102,400) with its depth cut to 4
     layers (dense layer 0 + 3 stacked MoE units, 2,267,039,744 float32
     parameters; the published 28 layers need about 245 GiB of parameters,
     gradients and moments), bfloat16 compute, remat on, through
     `train.Trainer` with the reference launcher's defaults (batch 8 x 128
     tokens of `TokenPipeline(seed=0)`, `adamw(warmup_cosine(3e-4,
     warmup_steps=1, total_steps=10))`), 10 steps with each router (top-k,
     then Sinkhorn: 8 iterations, lambda 8). (a) The step ms (CUDA events,
     median of steps 2-10), tokens/s, peak memory and the losses (the
     last below the first); one profiled step's wall, device busy, idle
     share and largest device entries; the step's HBM bound from the
     bytes the code moves (`_train_bytes`) and the AdamW update alone. The
     trainer's checkpoints are not written here (`_NoCheckpoint`: 27 GB a
     state; (d) writes them). (b) Two steps from one state through two
     `build_train_step` calls: parameters, moments and metrics bitwise
     equal, both routers. (c) Two layers at full width, float32 compute,
     batch 2 x 32, one numpy tree on the card and the CPU: the donated
     step is the kept one bitwise and the kept step leaves its input as it
     was; microbatches 2 against 1 (no load-balance loss); a compressed
     step's residual finite; card against CPU: loss, grad_norm, per-leaf
     gradients and the update criterion (`_update_rel`) within their
     bounds (TOL_TRAIN_*). (d) `xlstm-125m` as published: 8 steps
     checkpointed every 4 with a failure injected at step 6, a fresh
     `Trainer` resumes at step 4 and ends bitwise where an uninterrupted
     run ends, its loss falls, the temporary directories are gone. (e) No
     WMD kernel launched. (f) The training launcher as a subprocess twice
     on one ``--ckpt-dir`` (`--arch deepseek-moe-16b --smoke`): exit 0,
     the second prints ``restoring step 4`` (run beside phase 18, as are
     15(e) and 16(e): `_Lane`).

  15. (run after phase 14 has released its state) the language-model
     mesh, on a (2, 2) ("data", "model") mesh of logical shards of
     `cuda:0` (`launch.mesh.make_mesh(..., devices=[cuda:0] * 4)`; the
     count of visible cards printed). (a) `deepseek-moe-16b` at full
     width, its depth cut to 8 layers (dense layer 0 and 7 MoE layers;
     phase 12 serves all 28), phase 12's traffic cut to 8 decode steps
     (batch 4, 64
     prompt tokens of numpy seed 0, q_block = kv_block = 16), both
     routers, bfloat16 (the config's) and float32 compute (a float32
     cache): the 1 x 1 runs first, their logits kept on the host and their
     greedy tokens fed to every run's decode; then the same parameters are
     placed on the mesh as views (`partitioning.shard`: moved, not
     copied). The mesh's prefill and decode logits within 1e-4 of the
     largest |logit| of the 1 x 1's in float32 with the same greedy tokens
     -- or, where a router call picks other experts, the first such call
     at a near-tie of the 1 x 1 scores (relative k-th / k+1-th gap under
     1e-4) after router logits within 1e-4 (the Sinkhorn router at decode
     saturates its expert marginal over 4 tokens, ROADMAP Queue 3) -- and
     within `_bf16_bound` in bfloat16; a kept and a donated decode loop
     from one cache bitwise equal; prefill and decode ms (CUDA events),
     the top-k bfloat16 decode step's `[idle]` line on each layout and the
     peak memory. (b) `deepseek-moe-16b` at full width, depth 2
     (`MESH_TRAIN_LAYERS`: phase 14 trains depth 4), float32
     compute, batch 8 x 128, both routers: one step on the mesh against
     the 1 x 1 step from one state (loss and grad_norm within 1e-5
     relative, the update criterion within phase 14's TOL_TRAIN_UPDATE),
     two mesh steps from one state bitwise (parameters and metrics), step
     ms and a profiled step's `[idle]` line. (c) A (2, 1, 2)
     ("pod", "data", "model") mesh, grad compression, depth 2, Sinkhorn,
     float32: the pod replicas of every parameter, moment and residual
     bitwise equal after each of 2 steps, the losses and the update within
     (b)'s bounds of the 1 x 1 run. (d) A deepseek smoke state placed on
     (2, 2) and saved: shard files byte-equal to a 1 x 1 save; restored on
     (1, 1) and (4, 1) bitwise. No WMD kernel launched. (e) Both
     launchers as subprocesses with ``--devices 4 --mesh 2x2`` (serve
     deepseek-moe-16b ``--smoke``; train gemma-2b ``--smoke`` twice on one
     ``--ckpt-dir``, the second resuming).

  16. (run after phase 15 has released its tensors) the remaining mixers,
     on one card and on the mesh: (a) `recurrentgemma-9b` (RG-LRU + local
     attention, d_model 4096; 8 of its 38 layers: two pattern units and
     its tail), `minicpm3-4b` (multi-head latent attention; 8 of its 62
     layers), `whisper-small` (encoder-decoder, 12 + 12 layers, 1,500
     frames) and `xlstm-125m` (mLSTM + sLSTM, 12 layers), all at full
     width (`_SERVE_CUT`), one at a time, parameters made on
     the card from a `torch.Generator` seeded 0; phase 12's traffic (batch
     4, 64 prompt tokens of numpy seed 0, q_block = kv_block = 16; whisper
     with (4, 1500, 768) frames of the same seed) through `build_model` and
     `serving.build_serve_fns`. First phase 13's checks on 1 x 1: (a) two
     greedy decode loops of 32 steps from one cache, one donated and one
     not, bitwise equal, the cache of the loop without donation unchanged,
     finite logits, tokens in range; prefill ms and decode ms a token (CUDA
     events, median), the decode step's HBM bound (`_decode_bytes`); these
     loops are also this phase's 1 x 1 bfloat16 run (its greedy feed and
     logits, its traced decode step); (b) decoding 8 tokens one by one
     gives the prefill's logits on the extended sequence, in bfloat16 and
     in float32 compute and cache: argmax equal, relative error under 2e-2
     (bfloat16: `_bf16_bound`); (d) minicpm3 only:
     `mla.fwd_decode_absorbed` against `mla.fwd_decode` at full width in
     float32, max abs difference within 2e-5. Then the 1 x 1 float32 run
     and the same parameters moved onto phase 15's (2, 2) logical shards
     of `cuda:0`, bfloat16 and float32 compute (a float32 run makes a
     float32 cache and lifts whisper's bfloat16 decoder embedding to
     float32, `_Float32Run`), 8 decode steps fed the 1 x 1 run's greedy
     tokens: the mesh's prefill and every decode step within 1e-4 of the
     largest |logit| with equal greedy tokens in float32, within
     `_bf16_bound` in bfloat16; a kept and a donated decode loop bitwise
     equal on both layouts; prefill and decode ms, each layout's traced
     bfloat16 decode step (`[idle]`) and peak memory. Last, phase 13's (c):
     the card against the CPU at full width and reduced depth (one pattern
     unit of recurrentgemma, 2 layers of minicpm3, 2 + 2 of whisper, all
     12 of xlstm) from one numpy tree: the prefill logits and a decode
     step from the CPU's cache within 2e-2 (bfloat16) and 1e-4 (float32)
     of the largest |logit| (whisper's decoder prefill runs in bfloat16 at
     either compute dtype, as the reference's: its prefill logits 2e-2,
     its encoder output 1e-4). (b) One float32 step of each at full width,
     batch 8 x 128 (minicpm3-4b cut to 1 layer and recurrentgemma-9b to
     one pattern unit of 3, the others whole): the mesh against the 1 x 1
     step from one state (loss and grad_norm within 1e-5 relative, the
     first moments within TOL_TRAIN_GRAD of each leaf's largest and the
     update criterion within phase 14's TOL_TRAIN_UPDATE; xlstm-125m's
     moments within TOL_MOMENT_XLSTM and its update criterion reported,
     `_UPDATE_REPORTED`), two mesh steps from one state bitwise. (c) An
     xlstm-125m step on a (2, 1, 2) pod mesh with grad compression, twice:
     pod replicas bitwise equal after each, losses within (b)'s bound and
     the first moments after step 1 within TOL_MOMENT_INT8 of the 1 x 1
     run's. (d) No WMD kernel launched. (e) Phase 13's (f): the serving
     launcher as a subprocess (`--arch whisper-small --decode-steps 8`):
     exit 0 and both `[serve]` lines.

  17. (from phase 15 on) the launch tools: `python -m
     repro_torch.launch.dryrun` on the 16 x 16 production mesh of ``meta``
     devices for sinkhorn-wmd paper_5k, prod_5m and prod_5m_opt,
     deepseek-moe-16b decode_32k and olmo-1b train_4k (one process a
     cell, all at once, on the host's CPU; nothing on the card; a decoder
     cell counts its two depths one after the other), then
     `python -m repro_torch.launch.roofline --mesh pod16x16`: every cell
     ``ok``, its seconds, counts and roofline row printed. The cells count
     while phases 15, 16 and 18 run on the card; the roofline runs after
     phase 18.

  18. (after phase 16, beside phase 17's cells and the launchers of
     phases 14-16, each lane of them in new processes one after the
     other, `_Lane`) the port's four examples
     on the card, each `main(argv)` in this process at its defaults
     (``--device cuda``), its printed lines echoed as ``[ex <name>]``, the
     kernels' launches read around each call: (a) `examples/
     torch_quickstart.py` (V 8,000, w 300, N 256, 15 iterations): the
     dense and the sparse solver within the engines' rtol 2e-3, launches
     exactly 2 x (15 #1, one #2, two copies): the warm and the timed
     solve; (b) `torch_doc_retrieval.py` (3 queries, 200 iterations, the
     converged loop up to 500 at tol 1e-4 on the plain contractions):
     launches exactly 3 x (200 #1, one #2, two copies); (c)
     `torch_wmd_query_service.py` in each mode of SERVICE_MODES (the
     default, ``--batch-queries``, ``--docs-chunk 128 --batch-queries``,
     ``--zipf-stream``, ``--coalesce``, ``--top-k 8 --prune``,
     ``--offline 64 --top-k 8 --prune``, ``--devices 4 --batch-queries``):
     each returns, on the card's kernels, the two pruned modes' bitwise
     asserts against `top_k_scan_batch` hold, the default mode launches
     exactly one #5, two copies, 15 #1 and one #2 a `top_k` call, the
     batched modes 15 #3 and one #4 a dispatch (a `query_batch` call),
     mesh position and doc chunk, and the modes together launch all nine
     kernels and the copies; beside them, ``--offline 16 --cache-dir D``
     twice on one new temporary directory, each in a new process (a
     `_Lane`): the first builds,
     the second reports 0 builds ("compiles") and loads the libraries;
     (d) `torch_train_moe_sinkhorn.py` (the ~100M MoE: 8 layers, d_model
     512, 8 experts top-2, vocab 16,384; batch 8 x 256) for 20 steps with
     each router, each on a new temporary ``--ckpt-dir`` (removed after):
     finite losses, the last below the first, no kernel launched.

The line before the last is a JSON object with one entry per kernel
(``launches_by_phase`` has phases 12, 14, 15 and 16's, which must be 0,
and phase 18's); a ``[phases]`` line before it gives each phase's
seconds (phase 18's with and without the launchers beside it) and the
script's; the last line is ``{"ok": true, "device":
{...}}``.
"""
import contextlib
import hashlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's peaks and HBM rate, and the roofline's terms, are the
# roofline tool's (a checkout without the package stops here)
from repro_torch.launch.roofline import (HBM_BW, PEAK_FLOPS,  # noqa: E402
                                         PEAK_FLOPS_FP32, terms)
TOL_ENGINE = dict(rtol=2e-3, atol=1e-5)   # the reference's engine tolerance
TOL_KERNEL = dict(rtol=1e-4, atol=1e-6)   # same math, sums reassociated
TOL_SELF_RTOL = 5e-3       # pairs that gather a word's own column: _compare
DEVICE_MS_TOL = 0.05       # `_device_ms` vs a launch's traced time (#3)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def _timed(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call from CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# the device spins this many cycles (about 50 ms) before `_device_ms`'s
# calls, so the host queues them all before the first one runs
SPIN_CYCLES = 100_000_000


def _device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call: CUDA events around ``reps`` calls that
    the host queues behind a spin kernel (`torch.cuda._sleep`), so that the
    device runs them back to back. Unlike `_timed`, it leaves out the host
    time between launches that a small kernel's CUDA-event time holds when
    the host, not the device, sets the pace. A torch.profiler trace's
    summed device events would say the same, but traces on the card drop
    a varying share of their events (on an H100, 15 back-to-back #3
    launches traced 21 times in one long process showed 0 to 15 of them,
    `scripts/trace_drops.py`), so no sum of a trace is read as a device
    time. Fails if the host took
    longer to queue the calls than the device spun."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin, start, stop = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    spin_ms = spin.elapsed_time(start)
    _check(host_ms < spin_ms, f"the host took {host_ms:.2f} ms to queue "
           f"{reps} calls, the device spun {spin_ms:.2f} ms: it waited")
    return start.elapsed_time(stop) / reps


def _bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS_FP32
           ) -> tuple[float, str]:
    """The least ms the card can take for the work (`roofline.terms`: its
    memory and compute terms, the fp32 CUDA cores' peak by default) and
    which term it is."""
    t = terms(flops, nbytes, peak=peak)
    return ((t["memory"] * 1e3, "bytes") if t["memory"] >= t["compute"]
            else (t["compute"] * 1e3, "operations"))


def _device_busy(call, marks=(), top=5, groups=()):
    """Run ``call`` (warm) once on the host clock, then once under
    torch.profiler. Returns (wall ms, wall ms under the profiler, summed
    device ms, the ``top`` largest device entries, {mark: (count, ms)} of the
    device entries whose name holds each of ``marks``, and of each
    (label, substrings) of ``groups``: the entries whose lower-cased name
    holds one of its substrings and none of an earlier group's, "other"
    the rest) from the device events of the trace (kernels and copies, one
    stream, no overlap); the device ms is None, with the reason in place of
    the entries, when the trace holds no device time. A trace may drop
    its first device events (`_device_ms`): each begins with TRACE_PROLOGUE
    spin kernels, left out of the reading, and the call is traced again,
    up to TRACE_TRIES times, while its trace holds fewer hand-kernel
    events than it launched hand kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    def timed_call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall = timed_call()
    try:
        for _ in range(TRACE_TRIES):
            before = sum(_build.launches.values())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_PROLOGUE):
                    torch.cuda._sleep(1)
                wall_prof = timed_call()
            launched = sum(_build.launches.values()) - before
            dev = [(e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.key]
            if sum(c for _, k, c in dev
                   if any(h in k for h in HAND_KERNELS)) >= launched:
                break
    except Exception as e:                  # a measurement, not the path
        return wall, float("nan"), None, f"profiler failed: {e!r}", {}
    busy = sum(ms for ms, _, _ in dev)
    if busy <= 0:
        return wall, wall_prof, None, "the trace holds no device events", {}
    marked = {m: (sum(c for _, k, c in dev if m in k),
                  sum(ms for ms, k, _ in dev if m in k)) for m in marks}
    if groups:
        for label, _ in (*groups, ("other", ())):
            marked[label] = (0, 0.0)
        for ms, key, count in dev:
            label = next((lb for lb, subs in groups
                          if any(x in key.lower() for x in subs)), "other")
            marked[label] = (marked[label][0] + count,
                             marked[label][1] + ms)
    return wall, wall_prof, busy, ", ".join(
        f"{key[:40]} {ms:.2f} ms x{count}"
        for ms, key, count in sorted(dev, reverse=True)[:top]), marked


def _idle_line(what, call, copies, *kernels):
    """Print the `[idle]` line of one warm ``call`` (`_device_busy`) with
    the count and device time of its vocab-major copies and of each
    (label, kernel name) of ``kernels`` in the trace; fail unless the trace
    holds ``copies`` copies. Does nothing more when the trace holds no
    device time (said so on the line)."""
    marks = ("::vocab_major_kernel",) + tuple(k for _, k in kernels)
    wall, wall_prof, busy, largest, marked = _device_busy(call, marks)
    if busy is None:
        print(f"[idle] {what}: {wall:.2f} ms wall; device time not "
              f"measured ({largest})")
        return
    parts = [f"{label} x{marked[k][0]} ({marked[k][1]:.3f} ms)"
             for label, k in (("copies",) + marks[:1],) + kernels]
    print(f"[idle] {what}: {wall:.2f} ms wall ({wall_prof:.2f} ms under "
          f"the profiler), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}; largest device entries: {largest}; "
          + ", ".join(parts))
    _check(marked[marks[0]][0] == copies, f"{what}: {marked[marks[0]][0]} "
           f"vocab-major copies in the trace, expected {copies}")
    _check(marked.get("type2_query_kernel", (0,))[0] == 0,
           f"{what}: the #2 / #4 oracle ran on a serving path")


# the declared kernel entries and the names of the kernels they launch in
# a trace, in groups: entries that launch a kernel of the same name share
# a group (#5-#7 one tiled loop, #8's dense route #9's walk)
KERNEL_GROUPS = (
    ("cost_rows", ("cdist_kexp", "cdist_kexp_rows", "cdist"),
     ("cost_rows_kernel", "cost_rows_naive_kernel")),
    ("type1", ("sddmm_spmm_type1", "sddmm_spmm_type1_batch"),
     ("type1_vm_kernel",)),
    ("type2", ("sddmm_spmm_type2", "sddmm_spmm_type2_batch"),
     ("type2_vm_kernel",)),
    ("vocab_major", ("k_vocab_major",), ("vocab_major_kernel",)),
    ("rwmd", ("rwmd_bound_batch", "lc_rwmd_bound_batch"),
     ("rwmd_gather_kernel", "column_min_kernel", "lc_rwmd_bound_kernel")),
)
ROOFLINE_SLACK = 1.05      # a counted term above this x the device time: wrong
# the hand kernels' names in a trace (a launch runs one, #8's dense route
# two), and how often `_device_busy` traces a call that holds fewer; the
# spin kernels each of its traces begins with (a trace on the card has
# dropped up to its first 15 device events, `scripts/trace_drops.py`)
TRACE_TRIES = 5
TRACE_PROLOGUE = 64
HAND_KERNELS = tuple(k for _, _, subs in KERNEL_GROUPS for k in subs) + (
    "type2_query_kernel",)


def _counted_wmd(what, call, want=None):
    """Count one warm ``call`` of a WMD phase (`launch.costmodel.count`)
    and print its flops, bytes and eager bytes, each kernel's declared cost
    times its counted calls, and the roofline's dominant term (fp32 peak,
    HBM rate) against the device busy of the same call (`_device_busy`),
    the whole call's and each kernel group's (KERNEL_GROUPS: its entries'
    summed declared cost against its kernels' device time). Fails unless
    the counted kernel calls are the launches read around the counted call
    (`_build.launches`) and ``want`` (the phase's launches a call), and
    unless each term is at most ROOFLINE_SLACK x its device time (no card
    beats its roofline: a declared cost too high, or a call not counted
    where its kernel ran, shows here)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import costmodel
    call()
    torch.cuda.synchronize()
    _build.reset_launches()
    with costmodel.count() as rec:
        call()
        torch.cuda.synchronize()
    launches = dict(_build.launches)
    _check(dict(rec.kernels) == launches and want in (None, launches),
           f"{what}: counted kernel calls {dict(rec.kernels)}, launches "
           f"{launches}, the phase's launches a call {want}")
    _, _, busy, largest, marked = _device_busy(
        call, groups=tuple((label, subs) for label, _, subs in KERNEL_GROUPS))
    t = terms(rec.flops, rec.bytes, peak=PEAK_FLOPS_FP32)
    dom, by = _bound(rec.bytes, rec.flops)
    kernels = ", ".join(
        f"{k} x{n} = {rec.kernel_sums[k][0]:.4g} B, "
        f"{rec.kernel_sums[k][1]:.4g} flops"
        for k, n in sorted(rec.kernels.items()))
    busy_txt = "not measured" if busy is None else f"{busy:.4f} ms"
    print(f"[count] {what}: flops {rec.flops:.6g}, bytes {rec.bytes:.6g}, "
          f"eager bytes {rec.eager_bytes:.6g}; kernels (declared cost x "
          f"calls, == launches): {kernels}; roofline {dom:.4f} ms ({by}; "
          f"operations {t['compute'] * 1e3:.4f}, bytes "
          f"{t['memory'] * 1e3:.4f}) vs device busy {busy_txt} of the same "
          f"call; counted in {rec.seconds:.2f} s")
    if busy is None:
        print(f"[count] {what}: device busy not measured ({largest})")
        return
    _check(dom <= ROOFLINE_SLACK * busy, f"{what}: roofline {dom:.4f} ms "
           f"above {ROOFLINE_SLACK} x the device busy {busy:.4f} ms: the "
           f"count is wrong")
    parts = []
    for label, entries, _ in KERNEL_GROUPS:
        sums = [rec.kernel_sums[e] for e in entries if e in rec.kernel_sums]
        if not sums:
            continue
        bound, gby = _bound(sum(b for b, _ in sums), sum(f for _, f in sums))
        n, ms = marked[label]
        parts.append(f"{label} {bound:.4f} ms ({gby}) vs {ms:.4f} ms x{n} "
                     f"(ratio {bound / ms if ms else float('nan'):.3f})")
        _check(n > 0 and bound <= ROOFLINE_SLACK * ms,
               f"{what}: kernel group {label}: declared roofline "
               f"{bound:.4f} ms against {ms:.4f} ms of device time in {n} "
               f"trace entries: the declared cost is wrong")
    print(f"[count] {what}: each kernel group's declared roofline vs its "
          f"device time: " + "; ".join(parts))


# the 65,536-doc slice of the prod_5m corpus that phase 5's check of the
# kernels reading the iterate runs on
PROD_SLICE_DOCS = 65_536


def _prod_slice(dev):
    """(cols, vals) of a ``PROD_SLICE_DOCS``-doc corpus of
    `configs.sinkhorn_wmd.config("prod_5m")` (`data.corpus.make_corpus`'s
    statistics, seed 1), on ``dev``."""
    import torch
    from repro_torch.configs.sinkhorn_wmd import config
    from repro_torch.data.corpus import make_corpus
    cfg = config("prod_5m")
    ell = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                      num_docs=PROD_SLICE_DOCS, num_queries=0, seed=1).ell
    return (torch.from_numpy(ell.cols).to(dev),
            torch.from_numpy(ell.vals).to(dev))


def _fused_iterate_check(what, k_vm, km_vm, r, cols, vals, x) -> dict:
    """#3, #4, #1 and #2 reading the iterate (``from_x``) against the
    element-wise spelling they replace on the card: `safe_recip`, the
    kernel on u with r = 1, then the divide by r; bitwise, compared as
    int32 bits so that NaN matches NaN. x (Q, v_r, N) is seeded with 0,
    values below TINY (a subnormal among them), a negative, +inf, NaN and
    1e38 (whose reciprocal is subnormal); four pad docs (every slot the pad
    id, val 0) with x = 0 are appended and must come out exactly 0. r is
    the batch's (not 1). #3 runs on the query-group tile (v_r 32, Q >= 3,
    `sddmm_spmm.type1_tile`) and must equal #3 on the warp tile
    (`sddmm_spmm_type1_batch_warp`) bit for bit. Returns the device ms
    (`_device_ms`) of #3 and #4 reading x, of #3 reading x on the warp
    tile, of the same launches on u, of the element-wise spelling (the
    passes and the launch on u), and of #3 reading x on both tiles at
    Q 2, 3 and 4 (the batch's first queries, bitwise alike)."""
    import torch
    from repro_torch.kernels import sddmm_spmm as k
    q, v_r, n = x.shape
    vp1 = k_vm.shape[1]
    pad = 4
    cols = torch.cat([cols, torch.full((pad, cols.shape[1]), vp1 - 1,
                                       dtype=cols.dtype, device=cols.device)])
    vals = torch.cat([vals, vals.new_zeros((pad, vals.shape[1]))])
    x = torch.cat([x, x.new_zeros((q, v_r, pad))], dim=2).contiguous()
    g = torch.Generator(device=x.device)
    g.manual_seed(31)
    special = torch.tensor([0.0, 1e-35, 1e-45, -1.0, float("inf"),
                            float("nan"), 1e38, 0.0], device=x.device)
    at = torch.randint(0, q * v_r * n, (4096,), generator=g,
                       device=x.device)
    flat = x.view(-1)
    flat[at] = special[torch.arange(at.numel(), device=x.device)
                       % special.numel()]
    x[:, :, n:] = 0.0             # a NaN u would give a pad doc's <u, 0> NaN
    ones = torch.ones_like(r)
    u = k.safe_recip(x)

    def bits(t):
        return t.contiguous().view(torch.int32)

    def same(a, b, msg):
        _check(torch.equal(bits(a), bits(b)), f"{what}: {msg}")

    x3 = k.sddmm_spmm_type1_batch_vm(k_vm, r, x, cols, vals, from_x=True)
    x3_w = k.sddmm_spmm_type1_batch_warp(k_vm, r, x, cols, vals,
                                         from_x=True)
    x3_in = k.sddmm_spmm_type1_batch_vm(k_vm, ones, x, cols, vals,
                                        from_x=True)
    x3_u = k.sddmm_spmm_type1_batch_vm(k_vm, ones, u, cols, vals)
    d4 = k.sddmm_spmm_type2_batch_vm(k_vm, km_vm, x, cols, vals,
                                     from_x=True)
    d4_u = k.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals)
    x1 = k.sddmm_spmm_type1_vm(k_vm[0], r[0], x[0], cols, vals, from_x=True)
    d2 = k.sddmm_spmm_type2_vm(k_vm[0], km_vm[0], x[0], cols, vals,
                               from_x=True)
    torch.cuda.synchronize()
    same(x3, x3_u / r[:, :, None], "#3 reading x with r is not safe_recip, "
         "#3 with r = 1, then / r")
    same(x3_in, x3_u, "#3 reading x is not safe_recip then #3 (r = 1)")
    same(x3, x3_w, f"#3 on the {k.type1_tile(q, v_r)} tile is not #3 on the "
         f"warp tile")
    same(d4, d4_u, "#4 reading x is not safe_recip then #4")
    same(x1, x3[0], "#1 reading x is not #3 reading x at Q = 1")
    same(d2, d4[0], "#2 reading x is not #4 reading x at Q = 1")
    _check(bool((x3[:, :, n:] == 0).all()) and bool((d4[:, n:] == 0).all()),
           f"{what}: a pad doc with x = 0 is not exactly 0")
    n_nan = int(torch.isnan(x3).any(dim=1).sum())
    print(f"[kernels] {what}: #3, #4, #1 and #2 reading the iterate == "
          f"safe_recip + the kernel on u (+ / r), #3 == #3 on the warp tile, "
          f"bitwise, on Q {q}, v_r "
          f"{v_r}, N {n} + {pad} pad docs, with x seeded with 0, <1e-30, "
          f"-1, +inf, NaN and 1e38 ({n_nan} (query, doc) columns NaN out); "
          f"pad docs exactly 0")
    out = {
        "type1_fused": _device_ms(lambda: k.sddmm_spmm_type1_batch_vm(
            k_vm, r, x, cols, vals, from_x=True)),
        "type1_warp": _device_ms(lambda: k.sddmm_spmm_type1_batch_warp(
            k_vm, r, x, cols, vals, from_x=True)),
        "type1_on_u": _device_ms(lambda: k.sddmm_spmm_type1_batch_vm(
            k_vm, ones, u, cols, vals)),
        "type1_passes": _device_ms(lambda: k.sddmm_spmm_type1_batch_vm(
            k_vm, ones, k.safe_recip(x), cols, vals) / r[:, :, None]),
        "type2_fused": _device_ms(lambda: k.sddmm_spmm_type2_batch_vm(
            k_vm, km_vm, x, cols, vals, from_x=True)),
        "type2_on_u": _device_ms(lambda: k.sddmm_spmm_type2_batch_vm(
            k_vm, km_vm, u, cols, vals)),
        "type2_passes": _device_ms(lambda: k.sddmm_spmm_type2_batch_vm(
            k_vm, km_vm, k.safe_recip(x), cols, vals)),
    }
    print(f"[kernels] {what}: device ms, #3 reading x "
          f"{out['type1_fused']:.4f} ({k.type1_tile(q, v_r)} tile; the warp "
          f"tile {out['type1_warp']:.4f}), on u {out['type1_on_u']:.4f}, "
          f"safe_recip + #3 + / r {out['type1_passes']:.4f}; #4 reading x "
          f"{out['type2_fused']:.4f}, on u {out['type2_on_u']:.4f}, "
          f"safe_recip + #4 {out['type2_passes']:.4f}")
    # the smallest batches the rule gives the query-group tile: the first
    # queries of the same launch, on both tiles
    for qs in (2, 3, 4):
        args = (k_vm[:qs], r[:qs], x[:qs], cols, vals)
        tile = k.type1_tile(qs, v_r)
        same(k.sddmm_spmm_type1_batch_vm(*args, from_x=True),
             k.sddmm_spmm_type1_batch_warp(*args, from_x=True),
             f"#3 on the {tile} tile at Q {qs} is not the warp tile")
        out[f"type1_q{qs}"] = _device_ms(
            lambda: k.sddmm_spmm_type1_batch_vm(*args, from_x=True))
        out[f"type1_q{qs}_warp"] = _device_ms(
            lambda: k.sddmm_spmm_type1_batch_warp(*args, from_x=True))
        print(f"[kernels] {what}: device ms, #3 reading x at Q {qs} "
              f"{out[f'type1_q{qs}']:.4f} ({tile} tile, bitwise the warp "
              f"tile's), the warp tile {out[f'type1_q{qs}_warp']:.4f}")
    return out


def _shares_word(batch, ell):
    """(Q, N) mask: doc j holds one of query q's words."""
    import numpy as np
    live = ell.vals != 0
    return np.stack([(np.isin(ell.cols, np.nonzero(r)[0]) & live).any(axis=1)
                     for r in batch])


def _compare(what, got, want, share):
    """Hold distances computed from two spellings of the K rows together.

    The matmul expansion |a|^2 + |b|^2 - 2ab cancels on a word's own column
    (|a|^2 ~ 500 at w = 300): the plain spelling (cuBLAS product, separate
    norms) leaves M(i, i) at fp32 round-off, up to ~2.5e-2, where the CUDA
    kernel gets exactly 0 (its norms and dot products run one fma chain).
    Only a (query, doc) pair whose doc holds one of the query's words
    gathers such a column, and 15 iterations amplify the difference to a
    few 1e-3 of the distance: those pairs are held to rtol 5e-3, every
    other pair to the engine tolerance rtol 2e-3, atol 1e-5."""
    import numpy as np
    rel = np.abs(got - want) / np.abs(want)
    print(f"[check] {what}: max rel {rel[~share].max(initial=0.0):.3g} "
          f"over {int((~share).sum())} pairs sharing no word (rtol 2e-3), "
          f"{rel[share].max(initial=0.0):.3g} over {int(share.sum())} "
          f"pairs sharing one (rtol {TOL_SELF_RTOL:g})")
    np.testing.assert_allclose(got[~share], want[~share], **TOL_ENGINE)
    np.testing.assert_allclose(got[share], want[share], rtol=TOL_SELF_RTOL,
                               atol=1e-5)


def _check_plain_topk(what, idx, dist, idx_q, d_full, d_plain, share):
    """The pruned kernel route against the pruned all-plain route: the same
    ids in the same order, distances by `_compare`. The two routes'
    distances differ by up to a few 1e-3 (see `_compare`), so docs whose
    distances lie that close may swap places, or trade the k-th place with
    a doc just outside the top k: such a query is printed with both routes'
    distances of the docs that moved, and accepted only if, in each route,
    those docs lie within the relative tolerance of `_compare` of each
    other."""
    import numpy as np
    rows = np.arange(idx.shape[0])[:, None]
    _compare(f"{what}, pruned kernel route vs pruned all-plain route",
             dist, d_plain[rows, idx], share[rows, idx])
    for qi in np.nonzero((idx != idx_q).any(axis=1))[0]:
        pos = np.nonzero(idx[qi] != idx_q[qi])[0]
        moved = np.union1d(idx[qi, pos], idx_q[qi, pos])
        outside = np.setxor1d(idx[qi], idx_q[qi])
        print(f"[check] {what}, query {qi}: the routes order docs "
              f"{moved.tolist()} differently at places {pos.tolist()} "
              f"(in one top-k only: {outside.tolist()}): kernel route d "
              f"{d_full[qi, moved].tolist()}, plain route d "
              f"{d_plain[qi, moved].tolist()}")
        for d_row in (d_full[qi], d_plain[qi]):
            band = d_row[moved]
            _check(bool(band.max() - band.min() <= TOL_SELF_RTOL * band.max()),
                   f"{what}, query {qi}: ids differ beyond a near-tie")
    print(f"[check] {what}: pruned ids equal to the all-plain route's, in "
          f"order, except for near-ties on "
          f"{int((idx != idx_q).any(axis=1).sum())} queries")


def _spills(log: str) -> dict[str, tuple[int, ...]]:
    """{entry: (spill store bytes, spill load bytes)} from a -Xptxas -v
    report."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln and entry is not None:
            out[entry] = tuple(int(n) for n in
                               re.findall(r"(\d+) bytes spill", ln))
    return out


def _sha(*tensors) -> str:
    return " ".join(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                    for t in tensors)


def _ptxas_summary(log: str) -> list[str]:
    keep = ("Compiling entry", "Used", "spill")
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def _phase9(cfg, data, batches, d_rows, k_top):
    """Phase 9: async serving at paper_5k (see the module docstring).
    Returns the launches of its main path: the plain run's and the top-k
    run's, each read with the counts set to 0 just before it."""
    import collections
    import threading

    import numpy as np
    import torch

    from repro_torch.data.corpus import zipf_query_stream
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import Tracer
    from repro_torch.serving import (EngineGuard, ResiliencePolicy,
                                     WMDService, open_loop)

    qs = [r for batch in batches for r in batch]          # phase 3's 32
    rows = np.concatenate(d_rows)
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                     cache_capacity=1024, mcache_capacity=1024)
    _check(svc.device.type == "cuda" and svc.impl == "kernel"
           and svc.kexp_impl == "kernel" and svc.bound_impl == "kernel"
           and svc.lc_impl == "kernel", "async service defaults changed")
    # per-call stats of the engine entry points the dispatcher calls, from
    # which the expected launches follow (misses per 128-row chunk), with
    # the payloads and results of plain calls for the replay
    calls = []

    def recorded(name):
        orig = getattr(svc, name)

        def call(*args, **kw):
            m0 = svc.mcache_stats.miss_rows
            out = orig(*args, **kw)
            calls.append((name, len(args[0]), dict(svc.last_batch_stats),
                          dict(svc.last_prune_stats),
                          svc.mcache_stats.miss_rows - m0,
                          list(args[0]), out))
            return out
        return call

    svc.query_batch = recorded("query_batch")
    svc.top_k_batch = recorded("top_k_batch")
    guard = EngineGuard(svc, ResiliencePolicy(), metrics=svc.metrics)
    # on the card the guard's ladder holds only rungs that launch kernels
    _check(set(guard.stats().breaker_states)
           == {"plain/0", "top_k/0", "top_k/1"},
           f"the guard's ladder leaves the kernels: "
           f"{sorted(guard.stats().breaker_states)}")
    tracer = Tracer()
    co = svc.async_service(window_ms=2, max_batch=16, max_queue=256,
                           resilience=guard, tracer=tracer,
                           metrics=svc.metrics)
    rb = svc.cache_rows_bucket
    try:
        # -- warmup: every shape the coalescer can cut. Phase 2 built and
        # loaded every library, so the build layer has nothing left to
        # compile or load: the warmup's compile and load counts are 0 by
        # construction, and what is checked is that every library is
        # already loaded
        _check(set(_build._libs) == set(_build.SOURCES),
               f"a kernel library is not loaded before the warmup: "
               f"{sorted(_build._libs)} of {list(_build.SOURCES)}")
        rep = co.warm_registry(ks=(k_top,))
        print(f"[async] warmup: {len(rep.shapes)} shapes in "
              f"{rep.wall_s:.2f} s (libraries {sorted(_build._libs)} "
              f"loaded by phase 2; compiles {rep.compiles}, loads "
              f"{rep.persistent_hits}, 0 by construction); first-call s: "
              + ", ".join(f"{lbl} {s.wall_s:.3f}"
                          for lbl, s in rep.shapes.items()))

        def serve(submit, n_clients=4):
            """Submit qs from n_clients threads (client c submits queries
            c, c + n_clients, ...), drain; returns (futures in qs order,
            wall s, ServingStats before, after); the seconds of each
            submit call go to ``submit_s``."""
            st0 = co.stats()
            futs = [None] * len(qs)

            def client(c):
                for i in range(c, len(qs), n_clients):
                    t = time.perf_counter()
                    futs[i] = submit(qs[i])
                    submit_s.append(time.perf_counter() - t)

            t0 = time.perf_counter()
            ts = [threading.Thread(target=client, args=(c,))
                  for c in range(n_clients)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            _check(not any(t.is_alive() for t in ts), "a client hung")
            co.drain(timeout=600)
            wall = time.perf_counter() - t0
            return futs, wall, st0, co.stats()

        def delta(st0, st1):
            n = st1.dispatches - st0.dispatches
            hist = collections.Counter(st1.batch_size_hist)
            hist.subtract(st0.batch_size_hist)
            return n, sum(q * c for q, c in hist.items()) / max(n, 1), {
                t: getattr(st1, f"dispatch_{t}") - getattr(st0,
                                                           f"dispatch_{t}")
                for t in ("fill", "window", "deadline", "drain")}

        # -- the plain run: launches read around exactly it
        submit_s = []
        calls.clear()
        _build.reset_launches()
        futs, wall_p, st0, st1 = serve(co.submit)
        launches_p = dict(_build.launches)
        plain_calls = [c for c in calls if c[0] == "query_batch"]
        n_p, mean_p, trig_p = delta(st0, st1)
        want = {"sddmm_spmm_type1_batch": cfg.max_iter * n_p,
                "sddmm_spmm_type2_batch": n_p, "k_vocab_major": 2 * n_p,
                "cdist_kexp_rows": sum(math.ceil(c[2]["misses"] / rb)
                                       for c in plain_calls)}
        want = {k: v for k, v in want.items() if v}
        print(f"[async] plain: 32 queries from 4 threads in "
              f"{wall_p * 1e3:.1f} ms ({32 / wall_p:.1f} queries/s), "
              f"{n_p} dispatches, mean batch {mean_p:.2f}, triggers "
              f"{trig_p}, batches in order {[c[1] for c in plain_calls]}, "
              f"submit calls mean {np.mean(submit_s) * 1e6:.0f} us, max "
              f"{np.max(submit_s) * 1e6:.0f} us; launches {launches_p}, "
              f"expected {want}")
        _check(len(plain_calls) == n_p, "plain dispatches != engine calls")
        _check(launches_p == want, f"async plain launch counts "
               f"{launches_p} != {want}")
        got = np.stack([f.result(timeout=60) for f in futs])
        _check(np.array_equal(got, rows), "a coalesced row is not phase "
               "3's query_batch row of its query, bitwise")
        # the replay: each dispatched composition (the batch_log's groups,
        # in order) through a direct query_batch gives the same bits
        groups = [g for g in co.batch_log if g[0] >= st0.submitted]
        _check([len(g) for g in groups] == [c[1] for c in plain_calls]
               and sum(map(len, groups)) == 32,
               "the batch log does not match the dispatches")
        for c in plain_calls:
            _check(np.array_equal(WMDService.query_batch(svc, c[5]), c[6]),
                   f"a dispatch of {c[1]} does not replay bitwise")
        print("[check] async plain rows == phase 3's query_batch rows == "
              "the batch_log replay, bitwise, on all 32 queries")

        # -- the top-k run
        calls.clear()
        _build.reset_launches()
        futs_k, wall_k, st0, st1 = serve(
            lambda r: co.submit_top_k(r, k_top))
        launches_k = dict(_build.launches)
        topk_calls = [c for c in calls if c[0] == "top_k_batch"]
        n_k, mean_k, trig_k = delta(st0, st1)
        programs = sum(c[3]["rerank_programs"] for c in topk_calls)
        want_k = {"sddmm_spmm_type1_batch": cfg.max_iter * programs,
                  "sddmm_spmm_type2_batch": programs,
                  "k_vocab_major": 2 * sum(c[1] for c in topk_calls),
                  "lc_rwmd_bound_batch": n_k, "rwmd_bound_batch": n_k,
                  "cdist": sum(math.ceil(c[4] / rb) for c in topk_calls),
                  "cdist_kexp_rows": sum(math.ceil(m / rb)
                                         for c in topk_calls
                                         for m in c[3]["kcache_misses"])}
        want_k = {k: v for k, v in want_k.items() if v}
        print(f"[async] top-k: 32 queries (k={k_top}) from 4 threads in "
              f"{wall_k * 1e3:.1f} ms ({32 / wall_k:.1f} queries/s), {n_k} "
              f"dispatches, mean batch {mean_k:.2f}, triggers {trig_k}, "
              f"batches in order {[c[1] for c in topk_calls]}, "
              f"{programs} rerank programs; launches {launches_k}, "
              f"expected {want_k}")
        _check(len(topk_calls) == n_k, "top-k dispatches != engine calls")
        _check(launches_k == want_k, f"async top-k launch counts "
               f"{launches_k} != {want_k}")
        for i, f in enumerate(futs_k):
            idx, dist = f.result(timeout=60)
            _check(np.array_equal(idx, WMDService._top_k(rows[i], k_top))
                   and np.array_equal(dist, rows[i][idx]),
                   f"async top-k of query {i} is not the top-k of its "
                   f"phase 3 row")
        print("[check] async top-k == top-k of phase 3's rows, bitwise "
              "(ids and distances), on all 32 queries")
        gs, st = guard.stats(), co.stats()
        print(f"[async] guard: dispatches {gs.dispatches}, retries "
              f"{gs.retries}, failures {gs.failures}, demoted {gs.demoted}, "
              f"degraded {gs.degraded}; ServingStats degraded "
              f"{st.degraded}, failed {st.failed}, hit_rate {st.hit_rate}")
        _check(gs.retries == gs.demoted == gs.degraded == gs.failures == 0
               and st.degraded == st.failed == 0
               and all(rung == 0 for _, rung, _ in guard.dispatch_log),
               "the fault-free guarded run retried, demoted or degraded")

        # -- the open loop at half the saturating plain rate
        stream = zipf_query_stream(vocab_size=cfg.vocab_size,
                                   query_words=19, seed=2)
        rate = 32 / wall_p / 2
        st0 = co.stats()
        lg = open_loop(co.submit, [next(stream) for _ in range(64)],
                       rate_qps=rate, seed=0)
        co.drain(timeout=600)
        n_o, mean_o, trig_o = delta(st0, co.stats())
        print(f"[async] open loop: {lg.completed}/{lg.submitted} at "
              f"{rate:.1f} q/s offered, {lg.throughput_qps:.1f} q/s "
              f"served; {n_o} dispatches, mean batch {mean_o:.2f}, "
              f"triggers {trig_o}; latency ms p50 {lg.percentile_ms(50):.2f}"
              f" p95 {lg.percentile_ms(95):.2f} p99 "
              f"{lg.percentile_ms(99):.2f}")
        _check(lg.completed == lg.submitted == 64 and lg.failed == 0,
               "the open loop lost requests")

        # -- where the time goes: the saturating plain run against the
        # synchronous query_batch of the same two batches
        runs = []

        def coalesced():
            st0 = co.stats()
            serve(co.submit)
            runs.append(co.stats().dispatches - st0.dispatches)

        marks = ("::vocab_major_kernel", "type1_vm_kernel",
                 "type2_vm_kernel", "type2_query_kernel")
        for what, call in (("synchronous query_batch, 2 x Q=16",
                            lambda: [svc.query_batch(b) for b in batches]),
                           ("coalesced plain, 32 queries from 4 threads",
                            coalesced)):
            wall, wall_prof, busy, largest, marked = _device_busy(call,
                                                                  marks)
            if busy is None:
                print(f"[idle] {what}: {wall:.2f} ms wall; device time not "
                      f"measured ({largest})")
                continue
            copies = 2 * (runs[-1] if runs else len(batches))
            print(f"[idle] {what}: {wall:.2f} ms wall ({wall_prof:.2f} ms "
                  f"under the profiler), device busy {busy:.2f} ms, idle "
                  f"share {1 - busy / wall:.3f}; largest device entries: "
                  f"{largest}; copies x{marked[marks[0]][0]}, #3 "
                  f"x{marked[marks[1]][0]} ({marked[marks[1]][1]:.3f} ms)")
            _check(marked[marks[0]][0] == copies, f"{what}: "
                   f"{marked[marks[0]][0]} copies, expected {copies}")
            _check(marked[marks[3]][0] == 0, f"{what}: the oracle ran")
        co.shutdown(drain=True, timeout=600)
        _check(tracer.open_count == 0
               and len(tracer.completed) == co.stats().submitted,
               "a request's span tree did not close exactly once")
    finally:
        co.shutdown(drain=False, timeout=600)
    del svc, co, guard

    # -- the launcher's serving loop, in-process
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stats.json")
        t0 = time.perf_counter()
        launch_serve.main(["--arch", "sinkhorn-wmd", "--coalesce-window-ms",
                           "2", "--requests", "64", "--top-k", str(k_top),
                           "--resilience", "--stats-out", path])
        with open(path) as f:
            stats = json.load(f)
    served = stats["serving"]
    print(f"[async] launcher: {served['completed']}/{served['submitted']} "
          f"served, degraded {served['degraded']}, resilience "
          f"{ {k: stats['resilience'][k] for k in ('retries', 'demoted')} }, "
          f"{time.perf_counter() - t0:.1f} s with its corpus")
    _check(served["completed"] == served["submitted"] == 64
           and served["degraded"] == 0, "the launcher's serving loop did not "
           "serve 64 of 64 undegraded")
    torch.cuda.synchronize()
    return {k: launches_p.get(k, 0) + launches_k.get(k, 0)
            for k in set(launches_p) | set(launches_k)}


def _phase10(cfg, data, batches, d_rows, lb_rows, svc, svc6, k_top, card):
    """Phase 10: the live corpus at paper_5k (see the module docstring).
    Returns the launches of its main path (the live query_batch and pruned
    calls, each read with the counts set to 0 just before it) and its
    corpus directory (phase 11 serves it on a mesh)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.formats import doc_lists_from_ell, next_pow2
    from repro_torch.data import LiveCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwmd as krwmd
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import WMDService
    from repro_torch.serving.faultinject import CrashInjector, InjectedCrash

    v, n = cfg.vocab_size, cfg.num_docs
    docs = doc_lists_from_ell(data.ell)
    rng = np.random.default_rng(10)
    tmp = tempfile.TemporaryDirectory(prefix="live-")
    acks = []                                      # single-doc add acks

    def add(lc, ids, rows):
        t = time.perf_counter()
        lc.add_docs(ids, rows)
        return time.perf_counter() - t

    # -- the mutation history
    hook = CrashInjector()                         # a counter until armed
    lc = LiveCorpus(tmp.name, v, normalize=False, crash_hook=hook)
    bulk = [add(lc, list(range(s, s + 500)), docs[s:s + 500])
            for s in range(0, 2500, 500)]
    t0 = time.perf_counter()
    lc.compact()
    t_compact_half = time.perf_counter() - t0
    wrong = rng.choice(2500, 16, replace=False).tolist()
    for i in wrong:                                # wrong content ...
        acks.append(add(lc, [i], [docs[(i + 1) % n]]))
    extra = list(range(n, n + 8))
    add(lc, extra, docs[:8])                       # extraneous ids ...
    lc.remove_docs(extra)                          # ... removed again
    bulk += [add(lc, list(range(s, s + 250)), docs[s:s + 250])
             for s in range(2500, n, 250)]
    for i in wrong:                                # ... corrected
        acks.append(add(lc, [i], [docs[i]]))
    hook.target = hook.count + 2                   # compact.snapshot.tmp
    try:
        lc.compact()
        raise RuntimeError("chip_smoke: the injected crash did not fire")
    except InjectedCrash:
        pass
    _check(hook.crashed_at[1] == "compact.snapshot.tmp",
           f"the kill landed at {hook.crashed_at}")
    del lc
    t0 = time.perf_counter()
    lc = LiveCorpus(tmp.name, v, normalize=False)  # recover from disk
    t_recover_wal = time.perf_counter() - t0
    st = lc.stats()
    print(f"[live] {card}: history of {hook.count} boundaries, killed at "
          f"{hook.crashed_at}; recovered {st['num_live']} docs in "
          f"{t_recover_wal:.3f} s (snapshot gen {st['gen']} of "
          f"{st['base_rows']} base rows, WAL replay of "
          f"{st['delta_rows']} delta rows, capacity "
          f"{st['delta_capacity']} x {st['delta_nnz_max']} slots); "
          f"compaction at 2,500 docs {t_compact_half:.3f} s; bulk adds of "
          f"500 / 250 docs {np.mean(bulk[:5]) * 1e3:.1f} / "
          f"{np.mean(bulk[5:]) * 1e3:.1f} ms mean")
    _check(st["num_live"] == n and st["gen"] == 1
           and 0 < st["delta_rows"] < n, f"unexpected corpus state {st}")

    live = WMDService.from_live(None, cfg, data.vecs, lc, device="cuda",
                                cache_capacity=1024, mcache_capacity=1024)
    _check(live.device.type == "cuda" and live.impl == "kernel"
           and live.kexp_impl == "kernel" and live.bound_impl == "kernel"
           and live.lc_impl == "kernel", "live service defaults changed")
    _check(np.array_equal(live.live_doc_ids, np.arange(n)),
           "live_doc_ids is not arange(5000)")
    base, delta = lc.base_ell, lc.delta_ell
    print(f"[live] segments: base {base.num_docs} x {base.nnz_max} "
          f"(route of #8: {krwmd.rwmd_route(*base.cols.shape, v + 1)}), "
          f"delta {delta.num_docs} x {delta.nnz_max} (route "
          f"{krwmd.rwmd_route(*delta.cols.shape, v + 1)})")
    rb = live.cache_rows_bucket

    # -- live query_batch: launches read around exactly the two calls
    _build.reset_launches()
    rows, stats = [], []
    for batch in batches:
        rows.append(live.query_batch(batch))
        stats.append(dict(live.last_batch_stats))
    launches_q = dict(_build.launches)
    segs = sum(s["segments"] for s in stats)
    want = {"sddmm_spmm_type1_batch": cfg.max_iter * segs,
            "sddmm_spmm_type2_batch": segs,
            "k_vocab_major": 2 * len(batches),
            "cdist_kexp_rows": sum(math.ceil(s["misses"] / rb)
                                   for s in stats)}
    want = {k: c for k, c in want.items() if c}
    print(f"[live] query_batch launches {launches_q}, expected {want}")
    _check(segs == 2 * len(batches), "a live segment was empty")
    _check(launches_q == want, f"live query_batch launches {launches_q} "
           f"!= {want}")
    for i, (got, d) in enumerate(zip(rows, d_rows)):
        _check(np.array_equal(got, d), f"batch {i + 1}: live query_batch "
               f"is not phase 3's static rows, bitwise")
    print("[check] live query_batch == phase 3's static rows, bitwise "
          "(incremental == one-shot on the kernel route), both batches")

    # -- live pruned top-k: launches read around exactly the two calls
    _build.reset_launches()
    pruned, pstats, m_miss = [], [], []
    for batch in batches:
        m0 = live.mcache_stats.miss_rows
        pruned.append(live.top_k_batch(batch, k_top, prune=True))
        pstats.append(dict(live.last_prune_stats))
        m_miss.append(live.mcache_stats.miss_rows - m0)
    launches_p = dict(_build.launches)
    programs = sum(p["rerank_programs"] for p in pstats)
    want_p = {"sddmm_spmm_type1_batch": cfg.max_iter * programs,
              "sddmm_spmm_type2_batch": programs,
              "k_vocab_major": 2 * sum(len(b) for b in batches),
              "lc_rwmd_bound_batch": len(batches),
              "rwmd_bound_batch": len(batches),
              "cdist": sum(math.ceil(m / rb) for m in m_miss),
              "cdist_kexp_rows": sum(math.ceil(m / rb) for p in pstats
                                     for m in p["kcache_misses"])}
    want_p = {k: c for k, c in want_p.items() if c}
    print(f"[live] pruned launches {launches_p}, expected {want_p}")
    _check(launches_p == want_p, f"live pruned launches {launches_p} != "
           f"{want_p}")
    for i, ((idx, dist), d, ps) in enumerate(zip(pruned, d_rows, pstats)):
        _check(np.array_equal(idx, WMDService._top_k(d, k_top))
               and np.array_equal(dist, np.take_along_axis(d, idx, -1)),
               f"batch {i + 1}: live pruned top-k is not the top-k of "
               f"phase 3's rows")
        idx_s, d_s = live.top_k_scan_batch(batches[i], k_top)
        _check(np.array_equal(idx_s, idx) and np.array_equal(d_s, dist),
               f"batch {i + 1}: live pruned != live scan, bitwise")
        print(f"[live] pruned batch {i + 1}: solves_avoided "
              f"{ps['solves_avoided']:.4f} ({ps['exact_solves']} of "
              f"{ps['scan_solves']}, {ps['delta_docs']} delta docs solved "
              f"whole), {ps['rerank_programs']} programs")
    fallbacks = live.metrics.counter("wmd_prune_fallback_total")
    f0 = fallbacks.value
    idx_u, d_u = live.top_k_batch(batches[0], k_top, prune=True,
                                  rerank="union")
    _check(fallbacks.value == f0 + 1
           and live.last_prune_stats["rerank"] == "live_full_scan",
           "union on the live service did not take the counted fallback")
    _check(np.array_equal(idx_u, pruned[0][0])
           and np.array_equal(d_u, pruned[0][1]),
           "live union fallback != live pruned, bitwise")
    print("[check] live pruned == live scan == top-k of phase 3's rows, "
          "bitwise; union took the full-scan fallback (counted once), "
          "same bits")

    # -- live bounds: phase 7's static bounds, bitwise
    for i, (batch, d, lb_static) in enumerate(zip(batches, d_rows,
                                                  lb_rows)):
        lb = live.query_batch_bounds(batch)
        _check(np.array_equal(lb, lb_static), f"batch {i + 1}: live bounds "
               f"are not phase 7's static bounds, bitwise")
        _check(bool((lb <= d * (1 + 1e-5) + 1e-6).all()),
               f"batch {i + 1}: a live bound exceeds its distance")
    print("[check] live query_batch_bounds == phase 7's static bounds, "
          "bitwise (#8 per segment), and <= the distances")

    # -- where the time goes: static, then live, warm, one call each
    timing = {}
    for what, call, copies in (
            ("static query_batch, batch 2",
             lambda: svc.query_batch(batches[1]), 2),
            ("live query_batch, batch 2",
             lambda: live.query_batch(batches[1]), 2),
            ("static pruned per_query, batch 2",
             lambda: svc6.top_k_batch(batches[1], k_top, prune=True),
             2 * len(batches[1])),
            ("live pruned per_query, batch 2",
             lambda: live.top_k_batch(batches[1], k_top, prune=True),
             2 * len(batches[1]))):
        wall, wall_prof, busy, largest, marked = _device_busy(
            call, ("::vocab_major_kernel", "type2_query_kernel"))
        timing[what] = (wall, busy)
        if busy is None:
            print(f"[idle] {card}: {what}: {wall:.2f} ms wall; device time "
                  f"not measured ({largest})")
            continue
        print(f"[idle] {card}: {what}: {wall:.2f} ms wall ({wall_prof:.2f} "
              f"ms under the profiler), device busy {busy:.2f} ms, idle "
              f"share {1 - busy / wall:.3f}; largest device entries: "
              f"{largest}; copies x{marked['::vocab_major_kernel'][0]}")
        _check(marked["::vocab_major_kernel"][0] == copies,
               f"{what}: {marked['::vocab_major_kernel'][0]} copies, "
               f"expected {copies}")
        _check(marked["type2_query_kernel"][0] == 0, f"{what}: the oracle "
               f"ran")
    for kind in ("query_batch", "pruned per_query"):
        (ws, bs), (wl, bl) = (timing[f"static {kind}, batch 2"],
                              timing[f"live {kind}, batch 2"])
        ratio = "not measured" if bs is None or bl is None \
            else f"{bl / bs:.3f}"
        print(f"[live] {card}: live / static {kind}: wall {wl / ws:.3f}, "
              f"device busy {ratio}")

    # -- ack latency: single-doc upserts (own content) through the service
    for i in rng.choice(n, 64, replace=False).tolist():
        t = time.perf_counter()
        live.add_docs([i], [docs[i]])
        acks.append(time.perf_counter() - t)
    p50, p99 = np.percentile(np.asarray(acks) * 1e3, (50, 99))
    print(f"[live] {card}: add_docs ack latency (one doc, WAL append + "
          f"fsync) over {len(acks)} calls: p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms")
    _check(np.array_equal(live.query_batch(batches[0]), d_rows[0]),
           "after 64 upserts, live query_batch is not phase 3's rows")

    # -- a clean compaction at 5,000 docs, then recovery of its snapshot
    t0 = time.perf_counter()
    live.compact()
    t_compact = time.perf_counter() - t0
    for i, (batch, d) in enumerate(zip(batches, d_rows)):
        _check(np.array_equal(live.query_batch(batch), d), f"batch {i + 1}: "
               f"after the compaction, query_batch is not phase 3's rows")
    _check(live._rerank_cols_d[0].shape[0] == next_pow2(n) + 1
           and live.last_batch_stats["segments"] == 1,
           "the device state did not follow the compaction")
    idx_c, d_c = live.top_k_batch(batches[0], k_top, prune=True)
    _check(np.array_equal(idx_c, pruned[0][0])
           and np.array_equal(d_c, pruned[0][1]),
           "after the compaction, live pruned top-k changed")
    lc.close()
    t0 = time.perf_counter()
    lc2 = LiveCorpus(tmp.name, v, normalize=False)
    t_recover = time.perf_counter() - t0
    _check(lc2.num_live == n and lc2.stats()["delta_rows"] == 0,
           "recovery after the clean compaction lost docs")
    lc2.close()
    print(f"[live] {card}: clean compaction at {n} docs {t_compact:.3f} s; "
          f"recovery of its snapshot {t_recover:.3f} s (after the kill: "
          f"{t_recover_wal:.3f} s with the WAL replay); query_batch and "
          f"pruned top-k bitwise again")
    del live

    # -- the launcher's ingest mode, twice on one --live-dir
    with tempfile.TemporaryDirectory() as d:
        for run in ("seeded", "recovered"):
            path = os.path.join(d, f"stats-{run}.json")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                launch_serve.main([
                    "--arch", "sinkhorn-wmd", "--coalesce-window-ms", "2",
                    "--requests", "64", "--top-k", str(k_top),
                    "--resilience", "--ingest-stream", "8",
                    "--compact-every", "3", "--live-dir",
                    os.path.join(d, "live"), "--stats-out", path])
            text = out.getvalue()
            with open(path) as f:
                stats = json.load(f)
            served, lstats = stats["serving"], stats["live_corpus"]
            line = [ln for ln in text.splitlines() if "ingest:" in ln]
            word = "seeded: " if run == "seeded" else "recovered: "
            print(f"[live] launcher, {run}: "
                  f"{[ln for ln in text.splitlines() if word in ln]}; "
                  f"{line}; served {served['completed']}/"
                  f"{served['submitted']}, failed {served['failed']}, "
                  f"degraded {served['degraded']}; corpus gen "
                  f"{lstats['gen']}, {lstats['num_live']} live; "
                  f"{time.perf_counter() - t0:.1f} s with its corpus")
            _check(f"live corpus {word}" in text, f"launcher {run}: no "
                   f"'live corpus {word}' line")
            _check(len(line) == 1 and "ingest: 8/8 write ops acked" in
                   line[0], f"launcher {run}: not every write op acked")
            _check(served["completed"] == served["submitted"] == 72
                   and served["failed"] == served["degraded"] == 0
                   and served["docs_added"] + served["docs_removed"] == 8,
                   f"launcher {run}: the serving loop lost requests")
    torch.cuda.synchronize()
    return {k: launches_q.get(k, 0) + launches_p.get(k, 0)
            for k in set(launches_q) | set(launches_p)}, tmp

def _mesh_launches(cfg, stats, n_doc, n_model, rb):
    """The launches of ``len(stats)`` stripes-route `query_batch` calls on
    a (n_doc, n_model) mesh whose doc shards share one card: 15 #3 and one
    #4 a position, one pair of copies a model shard, and one #6 a model
    shard a 128-row chunk of K misses."""
    cells = n_doc * n_model
    want = {"sddmm_spmm_type1_batch": cfg.max_iter * cells * len(stats),
            "sddmm_spmm_type2_batch": cells * len(stats),
            "k_vocab_major": 2 * n_model * len(stats),
            "cdist_kexp_rows": n_model * sum(math.ceil(s["misses"] / rb)
                                             for s in stats)}
    return {k: c for k, c in want.items() if c}


def _phase11(cfg, data, batches, d_rows, pruned, union1, lb_rows, svc,
             live_dir, k_top, card):
    """Phase 11: multi-device serving on a single-controller mesh at
    paper_5k (see the module docstring). Returns the launches of its main
    path: the (4, 1) and (2, 2) meshes' query_batch and pruned calls, each
    read with the counts set to 0 just before it."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.distributed import build_wmd_batch_fn_stripes
    from repro_torch.data import LiveCorpus
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import WMDService

    n_cards = torch.cuda.device_count()
    print(f"[mesh] {card}: torch.cuda.device_count() = {n_cards}; every "
          f"mesh below puts its shards on cuda:0 (one card: these numbers "
          f"test the program, they are no multi-GPU speed)")
    one_card = [torch.device("cuda", 0)] * 4
    kw = dict(cache_capacity=1024, mcache_capacity=1024)
    rb = 128
    total = {}

    def count(launches):
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c

    def serve(mesh, what):
        """Both batches through query_batch (launches read around them)."""
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        msvc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, mesh=mesh,
                          **kw)
        _check(msvc.device == torch.device("cuda", 0)
               and msvc.impl == "kernel" and msvc.kexp_impl == "kernel",
               f"{what}: mesh service defaults changed")
        _build.reset_launches()
        rows, stats = [], []
        for batch in batches:
            rows.append(msvc.query_batch(batch))
            stats.append(dict(msvc.last_batch_stats))
        launches = dict(_build.launches)
        count(launches)
        want = _mesh_launches(cfg, stats, *msvc._grid.shape, rb)
        print(f"[mesh] {what}: query_batch launches {launches}, expected "
              f"{want}")
        _check(launches == want, f"{what}: query_batch launches {launches} "
               f"!= {want}")
        print(f"[mesh] {card}, shards on one card: {what} service and both "
              f"query_batch calls: peak device memory "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
              f"over what was allocated before it")
        return msvc, rows

    def per_query(msvc, what, queries):
        """query(r) for each query (launches read around the loop): #5, the
        pair of copies, 15 #1 and one #2 a position (the stripe and copies
        once a model shard: the doc shards share the card)."""
        n_doc, n_model = msvc._grid.shape
        _build.reset_launches()
        rows = np.stack([msvc.query(r) for r in queries])
        launches = dict(_build.launches)
        count(launches)
        q = len(queries)
        want = {"cdist_kexp": n_model * q, "k_vocab_major": 2 * n_model * q,
                "sddmm_spmm_type1": cfg.max_iter * n_doc * n_model * q,
                "sddmm_spmm_type2": n_doc * n_model * q}
        print(f"[mesh] {what}: query(r) launches {launches}, expected {want}")
        _check(launches == want, f"{what}: query(r) launches {launches} != "
               f"{want}")
        return rows

    def pruned_runs(msvc, what):
        """Pruned top-k per query on both batches, then union on batch 1
        (launches read around the three calls): 15 #3 and one #4 a
        position a rerank program, two copies a model shard a stripe set,
        #9 and #8 once a call on the first device, #7 a 128-row chunk of M
        misses, #6 a model shard a chunk of K misses."""
        n_doc, n_model = msvc._grid.shape
        _build.reset_launches()
        out, stats, m_miss = [], [], []
        for batch, rerank in ((batches[0], "per_query"),
                              (batches[1], "per_query"),
                              (batches[0], "union")):
            m0 = msvc.mcache_stats.miss_rows
            out.append(msvc.top_k_batch(batch, k_top, prune=True,
                                        rerank=rerank))
            stats.append(dict(msvc.last_prune_stats))
            m_miss.append(msvc.mcache_stats.miss_rows - m0)
        launches = dict(_build.launches)
        count(launches)
        programs = sum(p["rerank_programs"] for p in stats)
        cells = n_doc * n_model
        want = {"sddmm_spmm_type1_batch": cfg.max_iter * cells * programs,
                "sddmm_spmm_type2_batch": cells * programs,
                "k_vocab_major": 2 * n_model * (sum(len(b) for b in batches)
                                                + 1),
                "lc_rwmd_bound_batch": 3, "rwmd_bound_batch": 3,
                "cdist": sum(math.ceil(m / rb) for m in m_miss),
                "cdist_kexp_rows": n_model * sum(
                    math.ceil(m / rb) for p in stats
                    for m in p["kcache_misses"])}
        want = {k: c for k, c in want.items() if c}
        print(f"[mesh] {what} pruned launches {launches}, expected {want} "
              f"({programs} rerank programs of {cells} positions)")
        _check(launches == want, f"{what} pruned launches {launches} != "
               f"{want}")
        return out

    # -- (4, 1): four doc shards of 1,250 docs, bitwise the one-device rows
    m41 = make_mesh((4, 1), ("data", "model"), devices=one_card)
    svc41, rows41 = serve(m41, "(4, 1)")
    for i, (got, d) in enumerate(zip(rows41, d_rows)):
        _check(np.array_equal(got, d), f"(4, 1) batch {i + 1}: query_batch "
               f"is not phase 3's rows, bitwise")
    q41 = per_query(svc41, "(4, 1)", [r for b in batches for r in b])
    _check(np.array_equal(q41, np.concatenate(d_rows)),
           "(4, 1): query(r) is not phase 3's rows, bitwise")
    got_p = pruned_runs(svc41, "(4, 1)")
    got_u = got_p.pop()
    for i, ((idx, dist), (idx6, d6)) in enumerate(zip(got_p, pruned)):
        _check(np.array_equal(idx, idx6) and np.array_equal(dist, d6),
               f"(4, 1) batch {i + 1}: pruned top-k is not phase 6's")
    _check(np.array_equal(got_u[0], union1[0])
           and np.array_equal(got_u[1], union1[1]),
           "(4, 1): union top-k is not phase 6's")
    for i, (batch, lb) in enumerate(zip(batches, lb_rows)):
        _check(np.array_equal(svc41.query_batch_bounds(batch), lb),
               f"(4, 1) batch {i + 1}: bounds are not phase 7's")
    # the live corpus of phase 10 (every doc in the base after its clean
    # compaction), a fifth of the docs upserted with their own content
    # (1,000 at paper_5k: the delta)
    lc = LiveCorpus(live_dir, cfg.vocab_size, normalize=False)
    live41 = WMDService.from_live(m41, cfg, data.vecs, lc, **kw)
    from repro_torch.core.formats import doc_lists_from_ell
    docs = doc_lists_from_ell(data.ell)
    upserts = cfg.num_docs // 5
    live41.add_docs(list(range(upserts)), docs[:upserts])
    for i, (batch, d) in enumerate(zip(batches, d_rows)):
        _check(np.array_equal(live41.query_batch(batch), d),
               f"(4, 1) live batch {i + 1}: query_batch is not phase 3's "
               f"rows")
        _check(live41.last_batch_stats["segments"] == 2,
               "(4, 1) live: a segment was empty")
    idx_l, d_l = live41.top_k_batch(batches[0], k_top, prune=True)
    _check(np.array_equal(idx_l, pruned[0][0])
           and np.array_equal(d_l, pruned[0][1]),
           "(4, 1) live pruned top-k is not phase 6's")
    lc.close()
    del live41
    print(f"[check] (4, 1) mesh, four doc shards on one card: query_batch, "
          f"query(r) (32 queries), pruned per_query and union, bounds and "
          f"the live service over phase 10's directory ({upserts} docs in "
          f"its delta) are phase 3's / 6's / 7's answers, bitwise")

    # -- (2, 2): two 50,000-word stripes, two doc shards of 2,500
    m22 = make_mesh((2, 2), ("data", "model"), devices=one_card)
    svc22, rows22 = serve(m22, "(2, 2)")
    sel_b, _, mask_b = svc._padded_query_batch(batches[0])
    k1, km1, _ = svc._kcache.stripes_for_batch(sel_b, mask_b)
    k2, km2, _ = svc22._kcache.stripes_for_batch(sel_b, mask_b)
    vloc = cfg.vocab_size // 2
    for whole, parts in ((k1[0], k2), (km1[0], km2)):
        for s, part in enumerate(parts):
            _check(torch.equal(part[..., :-1],
                               whole[..., s * vloc:(s + 1) * vloc])
                   and bool((part[..., -1] == 0).all()),
                   f"(2, 2): K-cache shard {s} is not phase 3's rows split "
                   f"at column {vloc}, bitwise")
    del k1, km1, k2, km2
    print(f"[check] (2, 2): the K and K.*M stripes of each shard are phase "
          f"3's rows split at column {vloc}, bitwise (#6 a shard against "
          f"its stripe)")
    _check(np.array_equal(per_query(svc22, "(2, 2)", batches[0]),
                          rows22[0]), "(2, 2) batch 1: query(r) is not its "
           "query_batch rows, bitwise")
    for i, (batch, got) in enumerate(zip(batches, rows22)):
        _check(np.array_equal(svc22.query_batch(batch, use_cache=False),
                              got), f"(2, 2) batch {i + 1}: cache on != off")
        _compare(f"(2, 2) batch {i + 1} vs phase 3's rows (the split sum's "
                 f"rounding)", got, d_rows[i], _shares_word(batch, data.ell))
        rel = np.abs(got - d_rows[i]) / np.abs(d_rows[i])
        print(f"[mesh] (2, 2) batch {i + 1}: max rel difference to phase 3's "
              f"rows {rel.max():.3g}")
    got_p = pruned_runs(svc22, "(2, 2)")
    scans = [svc22.top_k_scan_batch(b, k_top) for b in batches]
    for (idx, dist), want in zip(got_p, scans + [got_p[0]]):
        _check(np.array_equal(idx, want[0]) and np.array_equal(dist, want[1]),
               "(2, 2): pruned, scan and union are not bitwise equal")
    print("[check] (2, 2): cache on == off, query(r) == query_batch rows, "
          "pruned == scan == union, bitwise; rows within _compare's "
          "tolerances of phase 3's")

    # -- the vote: tol 1e-5, 300 iterations at most, the same K rows; then
    # the median delta the 1 x 1 run reached, so that about half the
    # queries freeze inside the budget
    r_t = torch.from_numpy(svc._padded_query_batch(batches[0])[1]).to("cuda")
    layouts = (("1 x 1", svc), ("(4, 1)", svc41), ("(2, 2)", svc22))
    tol = 1e-5
    for run in range(2):
        iters = {}
        for name, msvc in layouts:
            fn = build_wmd_batch_fn_stripes(msvc.mesh, max_iter=300, tol=tol,
                                            with_info=True)
            k_s, km_s, _ = msvc._kcache.stripes_for_batch(sel_b, mask_b)
            _, n_iter, delta = fn(k_s, km_s, r_t, msvc._cols_d, msvc._vals_d)
            iters[name] = n_iter.cpu().numpy()
            if name == "1 x 1":
                deltas = delta.cpu().numpy()
            print(f"[mesh] tol {tol:.6g}, batch 1, {name}: n_iter "
                  f"{iters[name].tolist()}; max delta "
                  f"{float(delta.max()):.6g}")
        _check(np.array_equal(iters["(4, 1)"], iters["1 x 1"]),
               "(4, 1): n_iter is not the one-device n_iter")
        _check(int(np.abs(iters["(2, 2)"].astype(int)
                          - iters["1 x 1"]).max()) <= 1,
               "(2, 2): n_iter more than one from the one-device n_iter")
        tol = float(np.median(deltas))

    # -- where the time goes: warm query_batch of batch 2, each layout
    for what, msvc, copies in (("1 x 1", svc, 2), ("(4, 1)", svc41, 2),
                               ("(2, 2)", svc22, 4)):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wall, wall_prof, busy, largest, marked = _device_busy(
            lambda: msvc.query_batch(batches[1]), ("::vocab_major_kernel",
                                                   "type1_vm_kernel"))
        peak = torch.cuda.max_memory_allocated() - before
        if busy is None:
            print(f"[idle] {card}: {what} query_batch, batch 2: {wall:.2f} "
                  f"ms wall; device time not measured ({largest})")
            continue
        print(f"[idle] {card}, shards on one card: {what} query_batch, "
              f"batch 2: {wall:.2f} ms wall ({wall_prof:.2f} ms under the "
              f"profiler), device busy {busy:.2f} ms, idle share "
              f"{1 - busy / wall:.3f}; #3 x{marked['type1_vm_kernel'][0]} "
              f"({marked['type1_vm_kernel'][1]:.3f} ms), copies "
              f"x{marked['::vocab_major_kernel'][0]}; largest device entries: "
              f"{largest}; the call's peak device memory over what was "
              f"allocated before it {peak / 2**30:.2f} GiB")
        _check(marked["::vocab_major_kernel"][0] == copies,
               f"{what}: {marked['::vocab_major_kernel'][0]} copies, "
               f"expected {copies}")

    # -- more than one card: the (2, 2) mesh over distinct cards
    if n_cards > 1:
        spread = make_mesh((2, 2), ("data", "model"),
                           devices=[torch.device("cuda", i % n_cards)
                                    for i in range(4)])
        s2 = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, mesh=spread,
                        **kw)
        for batch, got in zip(batches, rows22):
            _check(np.array_equal(s2.query_batch(batch), got),
                   "(2, 2) over distinct cards != (2, 2) on one card")
        print(f"[check] (2, 2) over {min(n_cards, 4)} cards: rows bitwise "
              f"the one-card (2, 2) rows")
        del s2
    else:
        print("[mesh] one card: multi-card placement and peer copies not "
              "run")

    # -- the launcher in-process on a 2 x 2 mesh of logical devices
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", "sinkhorn-wmd", "--devices", "4",
                           "--mesh", "2x2", "--top-k", str(k_top), "--prune",
                           "--num-queries", "16"])
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if f"top{k_top} docs" in ln]
    summary = [ln for ln in text.splitlines() if "solves avoided" in ln]
    print(f"[mesh] launcher --devices 4 --mesh 2x2 --top-k {k_top} --prune: "
          f"{len(lines)} of 16 queries answered; {summary}; "
          f"{time.perf_counter() - t0:.1f} s with its corpus")
    _check("Mesh(data=2, model=2" in text and len(lines) == 16
           and len(summary) == 1, "the launcher on the 2 x 2 mesh did not "
           "serve every request")
    del svc41, svc22
    torch.cuda.synchronize()
    return total


def _named(tree, path=""):
    """(path, tensor) of every tensor of a parameter or cache tree."""
    if isinstance(tree, dict):
        return [e for k, v in tree.items() for e in _named(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree) for e in _named(v, f"{path}/{i}")]
    return [(path, tree)] if hasattr(tree, "numel") else []


def _decode_bytes(params, cache, batch: int, vocab: int, *,
                  tied: bool = False) -> tuple[int, int]:
    """(bytes one decode step of the port's code moves at the least, bytes
    a step that read each weight once in bfloat16 would move). The code's:
    each weight but the embedding table and the norm scales read in
    float32, its bfloat16 copy written and read at its use
    (`sharding_hints.fsdp_use`, the ``.to(dtype)`` of
    `attention.fwd_decode`); the norm scales read once; the table's
    ``batch`` rows (``tied``: the whole table as well, the head's weight);
    each cache buffer read in bfloat16, its float32 copy written and read
    (`attention.fwd_decode`); the bfloat16 logits written."""
    named = _named(params)
    d = params["embedding"]["embed"].shape[1]
    norm = sum(t.numel() for p, t in named if "norm" in p)
    weights = sum(t.numel() for p, t in named
                  if "norm" not in p and (tied or p != "/embedding/embed"))
    kv = sum(t.numel() for _, t in _named(cache))
    rest = 4 * norm + 4 * batch * d + 2 * batch * vocab
    return (8 * weights + 10 * kv + rest, 2 * weights + 2 * kv + rest)


META_MEMORY_TOL = 0.25     # meta temporaries vs the card's step (2x fails)
META_ARGS_TOL = 0.01       # meta arguments vs the card's parameters + cache


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors of ``trees``."""
    seen = {}
    for tree in trees:
        for _, x in _named(tree):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _phase12_count(cfg, b, max_len, params, cache, tok, dec, decode_ms,
                   code_bytes, ideal_bytes):
    """12(g): one bf16 top-k decode step counted on the card
    (`launch.costmodel`): its eager bytes at least `_decode_bytes`' code
    figure (reckoned "at the least"), its fused bytes at most it, its
    roofline term (bf16 peak, HBM rate) at most the measured decode ms;
    then the same step lowered on meta (`launch.dryrun.analyze`), its
    ``memory_analysis`` held against the card in two parts: the arguments
    against the bytes of the parameters' and the cache's storages (within
    META_ARGS_TOL), the temporaries against what one decode step adds to
    the allocated bytes at its peak (torch.cuda.max_memory_allocated
    after a reset, less torch.cuda.memory_allocated before it; within
    META_MEMORY_TOL, which a count off by 2x fails). Resets the peak
    statistics: returns torch.cuda.max_memory_allocated from before."""
    import torch

    from repro_torch.distributed import partitioning
    from repro_torch.launch import costmodel, dryrun
    from repro_torch.launch.mesh import one_device_mesh
    from repro_torch.models import build_model
    from repro_torch.serving import build_serve_fns
    from repro_torch.train.step import _MetaKey

    with costmodel.count() as rec:
        dec(params, cache, tok)
        torch.cuda.synchronize()
    term, by = _bound(rec.bytes, rec.flops, PEAK_FLOPS)
    print(f"[count] deepseek-moe-16b bf16 top-k decode step (batch {b}): "
          f"flops {rec.flops:.6g} (matmul {rec.matmul_flops:.6g}), bytes "
          f"{rec.bytes:.6g}, eager bytes {rec.eager_bytes:.6g} against "
          f"_decode_bytes' code figure {code_bytes:.6g} and ideal "
          f"{ideal_bytes:.6g}; roofline {term:.3f} ms ({by}) vs measured "
          f"{decode_ms:.2f} ms a token; {sum(rec.ops.values())} ops counted "
          f"in {rec.seconds:.2f} s; no kernel {dict(rec.kernels)}")
    _check(rec.eager_bytes >= code_bytes, "the eager bytes are under "
           "_decode_bytes' code figure, reckoned at the least")
    _check(rec.bytes <= code_bytes, "the fused bytes exceed _decode_bytes' "
           "code figure")
    _check(term <= decode_ms, f"the roofline term {term:.3f} ms is above the "
           f"measured {decode_ms:.2f} ms")
    _check(not rec.kernels, "a WMD kernel counted in the LM decode step")
    # what one step adds to the card's allocated bytes at its peak
    card_args = _storage_bytes(params, cache)
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dec(params, cache, tok)
    torch.cuda.synchronize()
    card_temp = torch.cuda.max_memory_allocated() - before
    del out
    # the same call lowered on meta, as launch.dryrun lowers a cell
    model = build_model(cfg, q_block=16, kv_block=16, device="meta")
    mparams = model.init(_MetaKey())
    mcache = dryrun._full_cache(model.init_cache(b, max_len), cache["pos"])
    mesh = one_device_mesh(torch.device("meta"))
    args = dryrun.position_bytes(
        (mparams, mcache), (partitioning.param_shardings(mesh, mparams),
                            partitioning.cache_shardings(mesh, mcache)),
        mesh)
    _, mdec = build_serve_fns(model, None, max_len=max_len)
    mtok = torch.empty(tuple(tok.shape), dtype=tok.dtype, device="meta")
    got = dryrun.analyze(lambda: mdec(b)(mparams, mcache, mtok),
                         argument_bytes=args)
    ma = got["memory_analysis"]
    r_args = ma["argument_size_in_bytes"] / card_args
    r_temp = ma["temp_size_in_bytes"] / card_temp
    print(f"[count] the same step lowered on meta ({got['compile_seconds']:.2f}"
          f" s): memory_analysis arguments "
          f"{ma['argument_size_in_bytes'] / 2**30:.4f} GiB vs the card's "
          f"parameters + cache storages {card_args / 2**30:.4f} GiB (ratio "
          f"{r_args:.4f}); temporaries {ma['temp_size_in_bytes'] / 2**30:.4f}"
          f" GiB vs one decode step's peak increase on the card "
          f"{card_temp / 2**30:.4f} GiB (torch.cuda.max_memory_allocated "
          f"after a reset - memory_allocated before {before / 2**30:.2f} "
          f"GiB; ratio {r_temp:.3f}); meta flops "
          f"{got['jaxpr_cost']['flops']:.6g} == card flops {rec.flops:.6g}: "
          f"{got['jaxpr_cost']['flops'] == rec.flops}")
    _check(abs(r_args - 1) <= META_ARGS_TOL, f"meta arguments {r_args:.4f} "
           f"x the card's, outside {META_ARGS_TOL}")
    _check(abs(r_temp - 1) <= META_MEMORY_TOL, f"meta temporaries "
           f"{r_temp:.3f} x the card's step, outside {META_MEMORY_TOL}")
    return peak_before


def _phase12(card):
    """12. The language model on the card (see the module docstring).
    Returns the kernels' launch counts over the phase, read around it."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models.layers import moe
    from repro_torch.serving import build_serve_fns

    dev = torch.device("cuda")
    cfg = get_config("deepseek-moe-16b")
    b, t, steps = 4, 64, 32                  # the reference launcher's
    max_len = t + steps
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)
    batch = {"tokens": tokens}
    print(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model},"
          f" {cfg.num_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} (d_ff {cfg.moe.d_ff_expert}) + "
          f"{cfg.moe.num_shared} shared, layer 0 dense (d_ff "
          f"{cfg.moe.d_ff_dense_first}); batch {b}, prefill {t}, {steps} "
          f"decode steps, q_block = kv_block = 16; no depth cut")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    # -- (a) the full config, both routers, from one set of parameters
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, x in _named(params))
    print(f"[lm] {n_params:,} parameters, {4 * n_params / 1e9:.2f} GB "
          f"float32, made on the card in {time.perf_counter() - t0:.1f} s; "
          f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def greedy(dec, logits, cache):
        """``steps`` greedy decode steps from a copy of ``cache``."""
        from repro_torch.models.lm import _tree_map
        return _greedy_loop(dec, params, logits,
                            _tree_map(torch.clone, cache), steps)

    router_logits, peak_a = {}, 0
    for router in ("topk", "sinkhorn"):
        rcfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=router))
        model = build_model(rcfg, q_block=16, kv_block=16)
        prefill_for, decode_for = build_serve_fns(model, None,
                                                  max_len=max_len)
        prefill, dec = prefill_for(b), decode_for(b)
        seen, gates = [], moe._gates

        def spy(e, logits):                  # the router logits, for (d)
            seen.append(logits.detach().to(torch.float32).cpu())
            return gates(e, logits)

        moe._gates = spy
        try:
            logits, cache = prefill(params, batch)
        finally:
            moe._gates = gates
        router_logits[router] = seen
        torch.cuda.synchronize()
        prefill_ms = _timed(lambda: prefill(params, batch), 3, warmup=1)
        l1, t1, ms1 = greedy(dec, logits, cache)
        l2, t2, ms2 = greedy(dec, logits, cache)
        _check(bool(torch.isfinite(logits.float()).all())
               and bool(torch.isfinite(l1.float()).all()),
               f"{router}: logits not finite")
        _check(tuple(l1.shape) == (b, steps, cfg.vocab_size)
               and int(t1.min()) >= 0 and int(t1.max()) < cfg.vocab_size,
               f"{router}: decoded tokens out of range")
        _check(torch.equal(l1, l2) and torch.equal(t1, t2),
               f"{router}: a second decode loop from the same cache is not "
               f"bitwise the first")
        med = float(np.median(ms1 + ms2))
        print(f"[lm] {router}: prefill {prefill_ms:.2f} ms (batch {b} x "
              f"{t}, CUDA events, warm); decode {med:.2f} ms/token (median "
              f"of {2 * steps} steps, CUDA events; first {ms1[0]:.2f} ms); "
              f"a second decode loop from the same cache is bitwise the "
              f"first ({steps} steps of logits and tokens); tokens "
              f"{t1[0, :8].tolist()}...")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        wall, wall_prof, busy, largest, _ = _device_busy(
            lambda: dec(params, cache, tok))
        if busy is None:
            print(f"[idle] decode step ({router}): {wall:.2f} ms wall; "
                  f"device time not measured ({largest})")
        else:
            print(f"[idle] decode step ({router}): {wall:.2f} ms wall "
                  f"({wall_prof:.2f} ms under the profiler), device busy "
                  f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}; largest "
                  f"device entries: {largest}")
        if router == "topk":
            nbytes, ideal = _decode_bytes(params, cache, b, cfg.vocab_size)
            print(f"[lm] decode step HBM bound: {nbytes / 1e9:.1f} GB the "
                  f"code moves (float32 weights read, their bfloat16 copy "
                  f"written and read at each use) / 3.35e12 B/s = "
                  f"{nbytes / HBM_BW * 1e3:.1f} ms, measured "
                  f"{med:.2f} ms ({nbytes / HBM_BW * 1e3 / med:.2f} "
                  f"of the bound); each weight read once in bfloat16: "
                  f"{ideal / 1e9:.1f} GB, "
                  f"{ideal / HBM_BW * 1e3:.1f} ms")
            peak_a = _phase12_count(rcfg, b, max_len, params, cache, tok,
                                    dec, med, nbytes, ideal)
        del logits, cache, l1, l2
    peak_a = max(peak_a, torch.cuda.max_memory_allocated())
    print(f"[lm] peak device memory {peak_a / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated, (a))")

    # -- (d) the Sinkhorn router balances load: the first MoE layer's router
    # logits of the top-k prefill (its input does not depend on the router)
    cv = {}
    for router in ("topk", "sinkhorn"):
        e = dataclasses.replace(cfg.moe, router=router)
        ids, _, _ = moe._gates(e, router_logits["topk"][0])
        counts = np.bincount(ids.numpy().ravel(),
                             minlength=cfg.moe.num_experts)
        load = counts / counts.sum()
        cv[router] = float(load.std() / load.mean())
    print(f"[lm] router load over {cfg.moe.num_experts} experts, first MoE "
          f"layer, {b * t} tokens x top-{cfg.moe.top_k}: coefficient of "
          f"variation topk {cv['topk']:.4f}, sinkhorn {cv['sinkhorn']:.4f} "
          f"({cfg.moe.sinkhorn_iters} iterations, lambda "
          f"{cfg.moe.sinkhorn_lamb})")
    _check(cv["sinkhorn"] < 0.5 * cv["topk"],
           "the Sinkhorn router's load CV is not under half the top-k's")

    # -- (b) decode against prefill at full size (the reference's test), in
    # bfloat16 (the config's) and float32 compute (and cache). Its
    # capacity factor 8 leaves no token dropped at its smoke size (capacity
    # 49 for 24 tokens a row); here that takes a factor of 16 (capacity 97
    # for 64 tokens a row; at 8, 49 slots, a skewed expert drops the last
    # tokens of the prefill and not of the decode)
    cf = 16.0
    cap = int(t * cfg.moe.top_k * cf / cfg.moe.num_experts + 1)
    _check(cap >= t, f"capacity {cap} drops tokens of a {t}-token row")
    cfg8 = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)
    s1 = t - 8

    def routed(fn):
        """fn()'s result and the expert ids of each of its MoE layers."""
        seen, gates = [], moe._gates

        def spy(e, logits):
            out = gates(e, logits)
            seen.append(out[0].cpu())
            return out

        moe._gates = spy
        try:
            return fn(), seen
        finally:
            moe._gates = gates

    def decode_vs_prefill(c):
        """Decode tokens s1.. one by one after a prefill of s1, and prefill
        all t: (decode logits, prefill logits, (token, layer) pairs whose
        expert set differs between the two)."""
        model = build_model(c, q_block=16, kv_block=16)
        if c.compute_dtype == "float32":   # a float32 cache as well
            _, cache = _f32_prefill(c, params, {"tokens": toks[:, :s1]}, t)
        else:
            _, cache = model.prefill(params, {"tokens": toks[:, :s1]},
                                     max_len=t)

        def steps_():
            nonlocal cache
            for i in range(s1, t):
                out, cache = model.decode(params, cache, toks[:, i:i + 1],
                                          donate=True)
            return out

        logits_d, ids_d = routed(steps_)
        (logits_p, _), ids_p = routed(
            lambda: model.prefill(params, {"tokens": toks}, max_len=t))
        n_moe = len(ids_p)
        flips = sum(int((ids_d[j * n_moe + layer].sort(-1).values
                         != ids_p[layer].reshape(b, t, -1)[:, s1 + j]
                         .sort(-1).values).any(-1).sum())
                    for j in range(t - s1) for layer in range(n_moe))
        return (logits_d.float().cpu().numpy(),
                logits_p.float().cpu().numpy(), flips, (t - s1) * n_moe * b)

    for c in (cfg8, dataclasses.replace(cfg8, compute_dtype="float32")):
        a, r, flips, pairs = decode_vs_prefill(c)
        rel = float(np.abs(a - r).max() / np.abs(r).max())
        top2 = np.sort(r[:, -1], axis=-1)[:, -2:]
        print(f"[lm] decode vs prefill, compute {c.compute_dtype} (tokens "
              f"{s1}..{t - 1} decoded one by one, capacity factor {cf:g}: "
              f"{cap} slots an expert, no drop): relative error {rel:.3g} "
              f"(bound 5e-2), argmax {a.argmax(-1).ravel().tolist()} vs "
              f"{r.argmax(-1).ravel().tolist()}; the prefill's top-2 margins "
              f"{np.round(top2[:, 1] - top2[:, 0], 4).tolist()}, max abs "
              f"difference {float(np.abs(a - r).max()):.4f}; routing "
              f"differs in {flips} of {pairs} (token, MoE layer) pairs")
        _check(np.array_equal(a.argmax(-1), r.argmax(-1)),
               "decode and prefill disagree on the argmax")
        _check(rel < 5e-2, f"decode vs prefill relative error {rel}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the card against the CPU at full width: layer 0 (dense) and
    # one MoE layer, from one numpy tree
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    t0 = time.perf_counter()
    from repro_torch.models.lm import _tree_map
    tree = _tree_map(lambda x: x.numpy(),
                     build_model(cfg2, device="cpu").init(0))
    p_cpu = lm_params_from_numpy(tree, device="cpu")
    p_gpu = lm_params_from_numpy(tree, device="cuda")
    print(f"[lm] 2 layers at full width: "
          f"{sum(x.numel() for _, x in _named(p_cpu)):,} parameters from a "
          f"numpy tree, on the CPU and the card in "
          f"{time.perf_counter() - t0:.1f} s")
    for dtype, bound in (("bfloat16", 2e-2), ("float32", 1e-4)):
        c2 = dataclasses.replace(cfg2, compute_dtype=dtype)
        t0 = time.perf_counter()
        l_cpu, _ = build_model(c2, q_block=16, kv_block=16,
                               device="cpu").prefill(p_cpu, batch,
                                                     max_len=t)
        cpu_s = time.perf_counter() - t0
        l_gpu, _ = build_model(c2, q_block=16, kv_block=16).prefill(
            p_gpu, batch, max_len=t)
        a = l_gpu.float().cpu().numpy()
        r = l_cpu.float().numpy()
        rel = float(np.abs(a - r).max() / np.abs(r).max())
        print(f"[lm] card vs CPU, prefill logits, compute {dtype}: relative "
              f"error {rel:.3g} of max |logit| (bound {bound:g}); argmax "
              f"equal {int((a.argmax(-1) == r.argmax(-1)).sum())}/{b}; CPU "
              f"{cpu_s:.1f} s")
        _check(np.isfinite(a).all() and rel <= bound,
               f"card vs CPU ({dtype}): relative error {rel} > {bound}")
    del tree, p_cpu, p_gpu
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(_build.launches)
    print(f"[lm] kernel launches over phase 12: {launches or 'none'} (the "
          f"language-model path runs no hand-written kernel)")
    _check(sum(launches.values()) == 0, "phase 12 launched a WMD kernel")

    # -- (e) the launcher, as a subprocess, on the card it now has to itself
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "deepseek-moe-16b", "--batch", str(b), "--prefill-len", str(t),
           "--decode-steps", str(steps)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("[serve]")]
    for ln in lines:
        print(f"[lm launcher] {ln}")
    _check(run.returncode == 0, f"the launcher exited {run.returncode}: "
           f"{run.stderr[-2000:]}")
    _check(any("prefill" in ln for ln in lines)
           and any("decode steps" in ln for ln in lines),
           "the launcher did not print both [serve] lines")
    print(f"[lm launcher] {' '.join(cmd[2:])}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# the mixers (phase 16(a), which runs phase 13's checks in its 1 x 1 runs):
# each config at full width, one at a time
MIXER_ARCHS = ("recurrentgemma-9b", "minicpm3-4b", "whisper-small",
               "xlstm-125m")
# (a)'s depth: recurrentgemma-9b two pattern units and its tail of two
# RG-LRU layers (of 38), minicpm3-4b 8 of its 62 layers (the decode loops
# are host-bound, so their seconds go with the depth), whisper-small and
# xlstm-125m whole (at 4 + 4 layers whisper's float32 decode, against its
# prefill's bfloat16 decoder, picked another argmax in one of 4 rows at
# relative error 0.0079: ROADMAP Queue 3)
_SERVE_CUT = {"recurrentgemma-9b": dict(num_layers=8),
              "minicpm3-4b": dict(num_layers=8),
              "whisper-small": {}, "xlstm-125m": {}}
# (c)'s depth (the card against the CPU): one pattern unit, 2 layers,
# 2 + 2, all 12
_REDUCED = {"recurrentgemma-9b": dict(num_layers=3),
            "minicpm3-4b": dict(num_layers=2),
            "whisper-small": dict(num_layers=2, encoder_layers=2),
            "xlstm-125m": {}}
SERVE_B, SERVE_T = 4, 64      # phase 12's traffic: batch 4, 64 prompt tokens
SERVE_STEPS = 32              # (a)'s greedy decode steps a loop
MESH_STEPS = 8                # the mesh runs' decode steps
MLA_ATOL = 2e-5               # the reference's, `tests/test_layers.py:171`


def _cut(cfg, cut: dict):
    """``cfg`` with the depth ``cut`` (``encoder_layers``: the encoder's)."""
    import dataclasses
    cut = dict(cut)
    if "encoder_layers" in cut:
        cut["encoder"] = dataclasses.replace(
            cfg.encoder, num_layers=cut.pop("encoder_layers"))
    return dataclasses.replace(cfg, **cut)


def _greedy_loop(dec, params, logits, cache, steps):
    """``steps`` greedy decode steps of ``dec`` from ``cache`` (donated
    or not, as ``dec`` says): (logits (B, steps, V), tokens (B, steps),
    ms a step by CUDA events)."""
    import torch
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    outs, toks, events = [], [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = dec(params, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        stop.record()
        outs.append(logits)
        toks.append(tok)
        events.append((start, stop))
    torch.cuda.synchronize()
    return (torch.cat(outs, 1), torch.cat(toks, 1),
            [s.elapsed_time(e) for s, e in events])


def _rel_err(a, r) -> float:
    import numpy as np
    return float(np.abs(a - r).max() / np.abs(r).max())


def _bf16_bound(own: float) -> float:
    """The bound of a comparison of two bfloat16 runs: 2e-2, or twice the
    model's own bfloat16 error ``own`` (its bfloat16 prefill logits
    against its float32 ones, same inputs and parameters) where that is
    larger: each run may lie ``own`` from the exact logits. The xLSTM's
    mLSTM cell divides by max(|q . n|, exp(-m)), and one mLSTM block at
    xlstm-125m's width has a bfloat16 error of 3.5e-2 in the reference
    itself."""
    return max(2e-2, 2 * own)


def _f32_prefill(cfg, params, batch, max_len):
    """Prefill at float32 compute with a float32 cache (the model API's
    cache is bfloat16): (last-position logits, cache)."""
    import torch

    from repro_torch.models import encdec, lm
    from repro_torch.models.layers import embedding
    dev = params["embedding"]["embed"].device
    toks = torch.as_tensor(batch["tokens"]).to(dev)
    kw = dict(max_len=max_len, q_block=16, kv_block=16,
              cache_dtype=torch.float32)
    if cfg.family == "audio":
        frames = torch.as_tensor(batch["frames"]).to(dev)
        h, cache = encdec.prefill(cfg, params, frames, toks, **kw)
    else:
        x = embedding.embed(cfg, params["embedding"], toks,
                            dtype=torch.float32)
        h, cache = lm.prefill(cfg, params, x, **kw)
    return embedding.logits(cfg, params["embedding"], h[:, -1:]), cache


def _mixer_greedy(arch, cfg, params, batch, max_len):
    """Phase 13's (a) on the 1 x 1 layout: prefill, then two greedy decode
    loops of SERVE_STEPS from one cache, one donated and one not, bitwise
    equal, the cache of the loop without donation unchanged; prefill and
    decode ms, the decode step's HBM bound. Returns 16(a)'s 1 x 1 bfloat16
    run (prefill logits and the first MESH_STEPS decode logits on the
    host, prefill ms, decode ms a token), its greedy feed (the first
    MESH_STEPS tokens fed) and its traced decode step (`_launch_count`)."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.lm import _leaves, _tree_map
    from repro_torch.serving import build_serve_fns

    b, t, steps = SERVE_B, SERVE_T, SERVE_STEPS
    model = build_model(cfg, q_block=16, kv_block=16)
    prefill_for, decode_for = build_serve_fns(model, None, max_len=max_len)
    prefill = prefill_for(b)
    dec, dec_kept = decode_for(b), decode_for(b, donate_cache=False)
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = _timed(lambda: prefill(params, batch), 3, warmup=1)
    snap = _tree_map(torch.clone, cache)
    l1, t1, ms1 = _greedy_loop(dec, params, logits,
                               _tree_map(torch.clone, cache), steps)
    l2, t2, ms2 = _greedy_loop(dec_kept, params, logits, cache, steps)
    _check(bool(torch.isfinite(logits.float()).all())
           and bool(torch.isfinite(l1.float()).all()),
           f"{arch}: logits not finite")
    _check(tuple(l1.shape) == (b, steps, cfg.vocab_size)
           and int(t1.min()) >= 0 and int(t1.max()) < cfg.vocab_size,
           f"{arch}: decoded tokens out of range")
    _check(torch.equal(l1, l2) and torch.equal(t1, t2),
           f"{arch}: the loop without donation is not bitwise the donated "
           f"one")
    _check(all(torch.equal(x, y) for x, y in zip(_leaves(cache),
                                                 _leaves(snap),
                                                 strict=True))
           and cache["pos"] == snap["pos"] == t,
           f"{arch}: a decode step without donation changed its cache")
    del snap
    med = float(np.median(ms1 + ms2))
    print(f"[mix] {arch}: prefill {prefill_ms:.2f} ms (batch {b} x {t}, "
          f"CUDA events, warm); decode {med:.2f} ms/token (median of "
          f"{2 * steps} steps, CUDA events; first {ms1[0]:.2f} ms; donated "
          f"{float(np.median(ms1)):.2f}, without donation "
          f"{float(np.median(ms2)):.2f} ms); the loop "
          f"without donation is bitwise the donated one ({steps} steps of "
          f"logits and tokens) and left its cache as it was; tokens "
          f"{t1[0, :8].tolist()}...")
    tok0 = torch.argmax(logits[:, -1], dim=-1)[:, None]
    feed = torch.cat([tok0, t1[:, :MESH_STEPS - 1]], 1)
    report = _launch_count(lambda: dec_kept(params, cache, tok0))
    # the decode step reads the decoder's weights (not the encoder's) and
    # one row of a learned position table
    used = params if cfg.family != "audio" else {
        "embedding": {k: v for k, v in params["embedding"].items()
                      if k != "pos"},
        "decoder": params["decoder"], "final_norm": params["final_norm"]}
    nbytes, ideal = _decode_bytes(used, cache, b, cfg.vocab_size,
                                  tied=cfg.tie_embeddings)
    print(f"[mix] {arch}: decode step HBM bound {nbytes / 1e9:.2f} GB the "
          f"code moves / 3.35e12 B/s = {nbytes / HBM_BW * 1e3:.2f} "
          f"ms, measured {med:.2f} ms "
          f"({nbytes / HBM_BW * 1e3 / med:.2f} of the bound); each "
          f"weight read once in bfloat16: {ideal / 1e9:.2f} GB, "
          f"{ideal / HBM_BW * 1e3:.2f} ms")
    run = (logits.float().cpu(), l2[:, :MESH_STEPS].float().cpu(),
           prefill_ms, med)
    return run, feed, report


def _mixer_decode_vs_prefill(arch, cfg, params, batch):
    """Phase 13's (b): decoding 8 tokens one by one gives the prefill's
    logits on the extended sequence, bfloat16 and float32 compute (and
    cache): argmax equal, relative error within its bound."""
    import dataclasses

    import numpy as np

    from repro_torch.models import build_model

    b, t = SERVE_B, SERVE_T
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)
    s1 = t - 8
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    runs = {}
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="float32")):
        m = build_model(c, q_block=16, kv_block=16)
        head = {"tokens": toks[:, :s1], **extra}
        if c.compute_dtype == "float32":
            _, cache = _f32_prefill(c, params, head, t)
        else:
            _, cache = m.prefill(params, head, max_len=t)
        for i in range(s1, t):
            out, cache = m.decode(params, cache, toks[:, i:i + 1],
                                  donate=True)
        ref, _ = m.prefill(params, {"tokens": toks, **extra}, max_len=t)
        runs[c.compute_dtype] = (out.float().cpu().numpy(),
                                 ref.float().cpu().numpy())
        del cache, out, ref
    own = _rel_err(runs["bfloat16"][1], runs["float32"][1])
    print(f"[mix] {arch}: the model's own bfloat16 error: bfloat16 prefill "
          f"logits {own:.3g} of max |logit| from the float32 ones")
    for dtype, (a, r) in runs.items():
        rel = _rel_err(a, r)
        bound = _bf16_bound(own) if dtype == "bfloat16" else 2e-2
        print(f"[mix] {arch}: decode vs prefill, compute {dtype}"
              f"{' and cache' if dtype == 'float32' else ''} (tokens "
              f"{s1}..{t - 1} decoded one by one): relative error {rel:.3g} "
              f"(bound {bound:.3g}), argmax {a.argmax(-1).ravel().tolist()} "
              f"vs {r.argmax(-1).ravel().tolist()}")
        _check(np.array_equal(a.argmax(-1), r.argmax(-1)),
               f"{arch} ({dtype}): decode and prefill disagree on the argmax")
        _check(rel < bound, f"{arch} ({dtype}): decode vs prefill relative "
               f"error {rel}")


def _mixer_mla(arch, cfg, params, max_len):
    """Phase 13's (d): MLA's absorbed decode (the served one) against the
    naive one, float32, layer 0 at full width."""
    import dataclasses

    import torch

    from repro_torch.models.layers import mla
    from repro_torch.models.lm import _unit

    b, t, dev = SERVE_B, SERVE_T, torch.device("cuda")
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    p0 = _unit(params["units"], 0)[0]["mix"]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(b, t, cfg.d_model, generator=g, device=dev)
    _, (c_kv, k_rope) = mla.fwd_full(c32, p0, x, q_block=16, kv_block=16,
                                     return_latent=True)
    mc = mla.fill_cache(c32, c_kv, k_rope, max_len, torch.float32)
    worst, top = 0.0, 0.0
    for _ in range(4):
        x1 = torch.randn(b, 1, cfg.d_model, generator=g, device=dev)
        o_n, mc_n = mla.fwd_decode(c32, p0, x1, mc)
        o_a, _ = mla.fwd_decode_absorbed(c32, p0, x1, mc)
        worst = max(worst, float((o_a - o_n).abs().max()))
        top = max(top, float(o_n.abs().max()))
        mc = mc_n
    print(f"[mix] {arch}: MLA absorbed vs naive decode, float32, layer "
          f"0 at full width ({cfg.num_heads} heads, kv_lora "
          f"{cfg.mla.kv_lora_rank}, 4 steps after {t} tokens): max abs "
          f"difference {worst:.3g} (bound {MLA_ATOL:g}; "
          f"max |naive| {top:.3f})")
    _check(worst <= MLA_ATOL, f"{arch}: absorbed vs naive decode "
           f"{worst} > {MLA_ATOL}")


def _mixer_card_vs_cpu(arch, cfg, batch, max_len):
    """Phase 13's (c): the card against the CPU at full width and reduced
    depth (`_REDUCED`), from one numpy tree: the prefill logits and a
    decode step from the CPU's cache, bfloat16 and float32 compute."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import build_model, encdec
    from repro_torch.models.lm import _tree_map

    dev = torch.device("cuda")
    b = SERVE_B
    cfg_r = _cut(cfg, _REDUCED[arch])
    t0 = time.perf_counter()
    tree = _tree_map(lambda x: x.numpy(),
                     build_model(cfg_r, device="cpu").init(0))
    p_cpu = lm_params_from_numpy(tree, device="cpu")
    p_gpu = lm_params_from_numpy(tree, device="cuda")
    depth = (f"{cfg_r.encoder.num_layers} + {cfg_r.num_layers} layers"
             if cfg.family == "audio" else f"{cfg_r.num_layers} layers")
    print(f"[mix] {arch}: {depth} at full width: "
          f"{sum(x.numel() for _, x in _named(p_cpu)):,} parameters from a "
          f"numpy tree, on the CPU and the card in "
          f"{time.perf_counter() - t0:.1f} s")
    nxt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (b, 1)).astype(np.int32)
    rels = {}
    for dtype in ("bfloat16", "float32"):
        c2 = dataclasses.replace(cfg_r, compute_dtype=dtype)
        m_cpu = build_model(c2, q_block=16, kv_block=16, device="cpu")
        m_gpu = build_model(c2, q_block=16, kv_block=16)
        t0 = time.perf_counter()
        l_cpu, c_cpu = m_cpu.prefill(p_cpu, batch, max_len=max_len)
        d_cpu, _ = m_cpu.decode(p_cpu, c_cpu, nxt)
        cpu_s = time.perf_counter() - t0
        l_gpu, _ = m_gpu.prefill(p_gpu, batch, max_len=max_len)
        d_gpu, _ = m_gpu.decode(
            p_gpu, _tree_map(lambda x: x.to(dev), c_cpu), nxt)
        rels[dtype] = [l_cpu.float().numpy(), cpu_s,
                       _rel_err(l_gpu.float().cpu().numpy(),
                                l_cpu.float().numpy()),
                       _rel_err(d_gpu.float().cpu().numpy(),
                                d_cpu.float().numpy())]
        if cfg.family == "audio":
            e_cpu = encdec.encode(c2, p_cpu, torch.from_numpy(
                batch["frames"]))
            e_gpu = encdec.encode(c2, p_gpu, torch.from_numpy(
                batch["frames"]).to(dev))
            rels[dtype].append(_rel_err(e_gpu.float().cpu().numpy(),
                                        e_cpu.float().numpy()))
        del c_cpu, l_gpu, d_gpu
    own = _rel_err(rels["bfloat16"][0], rels["float32"][0])
    for dtype, (_, cpu_s, rel_p, rel_d, *rel_e) in rels.items():
        bound = _bf16_bound(own) if dtype == "bfloat16" else 1e-4
        # whisper's decoder prefill runs in bfloat16 whatever the compute
        # dtype (the reference embeds at embed()'s default): its logits get
        # the bfloat16 bound, its encoder the float32 one
        p_bound = _bf16_bound(own) if cfg.family == "audio" else bound
        msg = (f"[mix] {arch}: card vs CPU, compute {dtype}: prefill logits "
               f"{rel_p:.3g} of max |logit| (bound {p_bound:.3g}), a decode "
               f"step from the CPU's cache {rel_d:.3g} (bound {bound:.3g})")
        ok = rel_p <= p_bound and rel_d <= bound
        if rel_e:
            msg += f", encoder output {rel_e[0]:.3g} (bound {bound:.3g})"
            ok = ok and rel_e[0] <= bound
        print(f"{msg}; CPU {cpu_s:.1f} s")
        _check(ok, f"{arch}: card vs CPU ({dtype}) outside its bounds")
    print(f"[mix] {arch}: the model's own bfloat16 error at this depth, on "
          f"the CPU: {own:.3g} of max |logit|")
    del tree, p_cpu, p_gpu
    gc.collect()
    torch.cuda.empty_cache()


def _mixer_launcher():
    """Phase 13's (f): the serving launcher as a subprocess on the
    encoder-decoder (the launcher's one new batch field, the frames):
    exit 0 and both `[serve]` lines. Its spec for `_Lane` (run beside
    phase 18)."""
    return [("[mix launcher]", [sys.executable, "-m",
                                "repro_torch.launch.serve", "--arch",
                                "whisper-small", "--decode-steps", "8"],
             "[serve]", ("prefill", "decode steps"))]


# -- 14. language-model training -------------------------------------------

TRAIN_ARCH = "deepseek-moe-16b"
TRAIN_LAYERS = 4          # dense layer 0 + 3 stacked MoE units (module doc)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 128, 10   # the reference launcher's
TOL_TRAIN_LOSS = 1e-5     # card vs CPU, float32: relative
TOL_TRAIN_GRAD = 1e-4     # per leaf, of the leaf's largest |gradient|
TOL_TRAIN_UPDATE = 1e-2   # per leaf, ||dp_card - dp_cpu|| / ||dp_cpu||
TOL_MICRO = 1e-5          # microbatches 2 vs 1, no load-balance loss:
                          # the loss, relative; the first moments per leaf
                          # (`_phase14_depth2`) at TOL_TRAIN_GRAD


# the kinds of a train step's device entries, first match wins
# (`_device_busy`): the fp32 <-> bf16 casts are copies
TRAIN_GROUPS = (("casts and copies", ("copy",)),
                ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
                ("reductions", ("reduce",)),
                ("sort", ("sort", "radix")),
                ("indexing", ("index", "gather", "scatter")),
                ("element-wise", ("elementwise",)))


class _NoCheckpoint:
    """(a)'s checkpointer: it records the saves the trainer asks for and
    writes nothing. A depth-4 deepseek state is 27 GB: its host copy, the
    msgpack payload and the file would not fit the host's 96 GiB; (d) runs
    the checkpoint path."""

    def __init__(self):
        self.saved = []

    def save(self, step, state, *, mesh_signature=""):
        self.saved.append(step)

    def wait(self):
        pass


def _train_bytes(params) -> tuple[int, int]:
    """(bytes one training step of the port's code moves at the least,
    bytes a step would move that read each weight once in bfloat16 forward
    and backward and ran a fused AdamW). The code's, a parameter: forward,
    each weight but the embedding table and the norm scales read in
    float32, its bfloat16 copy written and read at its use (8 B), the
    stacked units' again in the remat recompute (8 B); backward, the
    bfloat16 copy read again, the bfloat16 gradient written, read and
    cast to float32 (10 B), the table's float32 gradient written whole (4
    B), the units' per-unit gradients read and stacked (8 B); every
    gradient read twice for the norms (8 B: `train.step`'s grad_norm,
    `optim.global_norm`); AdamW's 17 element-wise passes (160 B,
    `optim.adamw` ``upd``); the norm scales read (4 B). The ideal: 2 + 2 B
    a weight, the float32 gradient written (4 B), a fused AdamW (read g,
    p, m, v; write p, m, v: 28 B)."""
    named = _named(params)
    total = sum(t.numel() for _, t in named)
    table = params["embedding"]["embed"].numel()
    norm = sum(t.numel() for p, t in named if "norm" in p)
    units = sum(t.numel() for p, t in named if p.startswith("/units/"))
    weights = total - table - norm
    code = (18 * weights + 4 * norm + 16 * units + 4 * table
            + 168 * total)
    return code, 4 * weights + 32 * total


def _phase14_run(cfg, router):
    """(a) and (b) for one router (module docstring); every tensor freed
    on return."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import partitioning
    from repro_torch.launch.mesh import one_device_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer, build_train_step
    from repro_torch.train.step import place

    dev = torch.device("cuda")
    rcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            router=router))
    model = build_model(rcfg, device=dev)
    opt = adamw(warmup_cosine(3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1),
                              total_steps=TRAIN_STEPS))
    pipe = TokenPipeline(rcfg, batch=TRAIN_B, seq_len=TRAIN_T, seed=0)
    mesh = one_device_mesh(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as td:
        trainer = Trainer(model, opt, mesh, pipe, ckpt_dir=td,
                          log_fn=lambda s: None)
        trainer.async_ckpt = _NoCheckpoint()
        inner, events = trainer.step_fn, []

        def timed(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(state, batch)
            stop.record()
            events.append((start, stop))
            return out

        trainer.step_fn = timed
        t0 = time.perf_counter()
        out = trainer.run(torch.Generator(device=dev).manual_seed(0),
                          TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        saved = trainer.async_ckpt.saved
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [a.elapsed_time(b) for a, b in events]
    med = float(np.median(ms[1:]))
    losses = [h["loss"] for h in out["history"]]
    state = out["final_state"]
    n_params = sum(x.numel() for _, x in _named(state.params))
    _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
           f"{router}: {len(losses)} finite losses of {TRAIN_STEPS}")
    _check(losses[-1] < losses[0], f"{router}: the loss did not fall: "
           f"{losses[0]} -> {losses[-1]}")
    _check(saved == [TRAIN_STEPS], f"{router}: checkpoints asked {saved}")
    print(f"[train] {router}: {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_T} "
          f"tokens through Trainer.run in {run_s:.1f} s; step "
          f"{med:.2f} ms (CUDA events, median of steps 2-{TRAIN_STEPS}; "
          f"first {ms[0]:.2f} ms), {TRAIN_B * TRAIN_T / med * 1e3:,.0f} "
          f"tokens/s; stragglers {out['stragglers']}; peak device memory "
          f"{peak:.2f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in losses))

    host = pipe.batch_at(TRAIN_STEPS)
    batch = place(host, partitioning.batch_shardings(mesh, host))
    wall, wall_prof, busy, largest, groups = _device_busy(
        lambda: inner(state, batch), top=4, groups=TRAIN_GROUPS)
    if busy is None:
        print(f"[idle] train step ({router}): {wall:.2f} ms wall; device "
              f"time not measured ({largest})")
    else:
        print(f"[idle] train step ({router}): {wall:.2f} ms wall "
              f"({wall_prof:.2f} ms under the profiler), device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}; by kind: "
              + ", ".join(f"{label} {ms:.2f} ms (x{n})"
                          for label, (n, ms) in groups.items())
              + f"; largest device entries: {largest}")
    if router == "topk":
        nbytes, ideal = _train_bytes(state.params)
        grads = _tree.tree_map(lambda p: torch.full_like(p, 1e-3),
                               state.params)
        opt_ms = _timed(lambda: opt.update(grads, state.opt, state.params,
                                           donate=True), 2, warmup=1)
        del grads
        print(f"[train] {n_params:,} parameters ({TRAIN_LAYERS} layers at "
              f"full width); step HBM bound: {nbytes / 1e9:.1f} GB the code "
              f"moves / 3.35e12 B/s = {nbytes / HBM_BW * 1e3:.1f} "
              f"ms, measured {med:.2f} ms "
              f"({nbytes / HBM_BW * 1e3 / med:.2f} of the bound); "
              f"bf16 weights and a fused AdamW: {ideal / 1e9:.1f} GB, "
              f"{ideal / HBM_BW * 1e3:.1f} ms; the AdamW update "
              f"alone {opt_ms:.2f} ms (CUDA events) against "
              f"{160 * n_params / HBM_BW * 1e3:.1f} ms for its "
              f"160 B a parameter, "
              f"{28 * n_params / HBM_BW * 1e3:.1f} ms fused")

    # -- (b) two steps from one state, through two build_train_step calls,
    # each donated on its own copy on the card (two states and one step's
    # temporaries: about 68 GiB at depth 4)
    torch.cuda.empty_cache()
    twin = _tree.tree_map(torch.clone, state)
    s1, m1 = build_train_step(model, opt, mesh)(state, batch)
    s2, m2 = build_train_step(model, opt, mesh)(twin, batch)
    h1 = _tree.leaves(s1)
    same = all(torch.equal(a, b)
               for a, b in zip(h1, _tree.leaves(s2), strict=True))
    same_m = all(torch.equal(m1[k], m2[k]) for k in m1)
    _check(same and same_m, f"{router}: two steps from one state differ "
           f"(state {same}, metrics {same_m})")
    del twin, s2
    print(f"[train] {router}: two steps from one state (two "
          f"build_train_step calls, donated) bitwise equal: {len(h1)} "
          f"tensors (parameters, moments, step) and the metrics "
          f"{sorted(m1)}; loss {float(m1['loss']):.6f}")


def _grads(model, params, batch):
    """(loss, the float gradients in flatten order) of one batch."""
    import torch

    from repro_torch import _tree
    leaves = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
    loss, _ = model.loss(_tree.unflatten(params, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _update_rel(before, after_a, after_b) -> float:
    """max over leaves of ||(a - p) - (b - p)|| / ||b - p||, in float64 on
    the CPU: the update criterion (Adam's first steps move an element by
    about +-lr, so an element whose gradient sits at rounding level may
    flip between two correct runs)."""
    import torch
    worst = 0.0
    for p, a, b in zip(before, after_a, after_b, strict=True):
        p, a, b = (x.to("cpu", dtype=torch.float64) for x in (p, a, b))
        da, db = a - p, b - p
        worst = max(worst, float((da - db).norm() / max(db.norm(), 1e-30)))
    return worst


def _phase14_depth2(cfg):
    """(c) depth 2, full width, float32 compute, batch 2 x 32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models.lm import _tree_map
    from repro_torch.optim import adamw, compression, warmup_cosine
    from repro_torch.train import TrainState, build_train_step

    cfg2 = dataclasses.replace(cfg, num_layers=2, compute_dtype="float32")
    t0 = time.perf_counter()
    tree = _tree_map(lambda x: x.numpy(),
                     build_model(cfg2, device="cpu").init(0))
    params = {d: lm_params_from_numpy(tree, device=d) for d in ("cpu",
                                                                 "cuda")}
    del tree
    models = {d: build_model(cfg2, device=d) for d in ("cpu", "cuda")}
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=10))
    batch = TokenPipeline(cfg2, batch=2, seq_len=32, seed=0).batch_at(0)
    n = sum(x.numel() for x in _tree.leaves(params["cpu"]))
    print(f"[train] (c) 2 layers at full width, float32 compute: {n:,} "
          f"parameters from one numpy tree on the CPU and the card in "
          f"{time.perf_counter() - t0:.1f} s; batch 2 x 32")

    def fresh(d, comp=False):
        p = _tree.tree_map(torch.clone, params[d])
        return TrainState(params=p, opt=opt.init(p),
                          comp=compression.init_state(p) if comp else None)

    model = models["cuda"]
    state = fresh("cuda")
    before = [x.clone() for x in _tree.leaves(state)]
    kept, mk = build_train_step(model, opt, None, donate=False)(state, batch)
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(before, _tree.leaves(state), strict=True))
    donated, md = build_train_step(model, opt, None)(state, batch)
    same = all(torch.equal(a, b) for a, b in zip(
        _tree.leaves(kept), _tree.leaves(donated), strict=True))
    same = same and all(torch.equal(mk[k], md[k]) for k in mk)
    _check(unchanged, "(c) the kept step changed its input state")
    _check(same, "(c) the donated step is not the kept step bitwise")
    print(f"[train] (c) donated step == kept step bitwise "
          f"({len(before)} tensors and the metrics), the kept step's input "
          f"unchanged")
    del donated, md, state, kept, mk, before

    # microbatches 2 against 1, on the same parameters: the router's
    # load-balance loss is a product of means over a call's tokens, so it
    # is set to 0 here; then the two differ by rounding only
    nobal = build_model(dataclasses.replace(cfg2, moe=dataclasses.replace(
        cfg2.moe, router_aux_loss=0.0)), device="cuda")
    runs = []
    for mb in (1, 2):                  # one state on the card at a time
        s1, met = build_train_step(nobal, opt, None, microbatches=mb)(
            fresh("cuda"), batch)
        runs.append((_tree.leaves(s1.opt.mu), met))
        del s1
    (mu1, m1), (mu2, m2) = runs
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) \
        / abs(float(m1["loss"]))
    mu_rel = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(mu2, mu1, strict=True))
    print(f"[train] (c) microbatches 2 against 1 (load-balance loss 0): "
          f"loss {float(m2['loss']):.7f} / {float(m1['loss']):.7f} "
          f"(relative {loss_rel:.3g}, bound {TOL_MICRO:g}), grad_norm "
          f"{float(m2['grad_norm']):.6f} / {float(m1['grad_norm']):.6f}, "
          f"first moments {mu_rel:.3g} of each leaf's largest (bound "
          f"{TOL_TRAIN_GRAD:g})")
    _check(loss_rel <= TOL_MICRO and mu_rel <= TOL_TRAIN_GRAD,
           f"(c) microbatches 2 vs 1: loss {loss_rel}, moments {mu_rel}")
    del runs, mu1, mu2, nobal

    state = fresh("cuda", comp=True)
    kc, mc = build_train_step(model, opt, None, grad_compression=True,
                              donate=False)(state, batch)
    finite = all(bool(torch.isfinite(r).all())
                 for r in _tree.leaves(kc.comp.residual))
    res = max(float(r.abs().max()) for r in _tree.leaves(kc.comp.residual))
    _check(finite and np.isfinite(float(mc["loss"])),
           "(c) compressed step: residual or loss not finite")
    print(f"[train] (c) grad_compression: loss {float(mc['loss']):.6f}, "
          f"grad_norm {float(mc['grad_norm']):.6f}, residual finite, "
          f"largest |residual| {res:.3g}")
    del kc, state

    # card against CPU: loss, per-leaf gradients, one step
    out = {}
    for d in ("cpu", "cuda"):
        t0 = time.perf_counter()
        loss, g = _grads(models[d], params[d], batch)
        state = fresh(d)
        s1, m1 = build_train_step(models[d], opt, None,
                                  donate=False)(state, batch)
        out[d] = (float(loss), [x.to("cpu") for x in g],
                  [x.to("cpu") for x in _tree.leaves(s1.params)],
                  float(m1["grad_norm"]), time.perf_counter() - t0)
        del g, state, s1
    (l_c, g_c, s_c, n_c, sec_c), (l_g, g_g, s_g, n_g, sec_g) = \
        out["cpu"], out["cuda"]
    p_c = _tree.leaves(params["cpu"])
    g_rel = max(float((a - b).abs().max() / max(float(b.abs().max()),
                                                 1e-30))
                for a, b in zip(g_g, g_c, strict=True))
    l_rel = abs(l_g - l_c) / abs(l_c)
    n_rel = abs(n_g - n_c) / abs(n_c)
    upd = _update_rel(p_c, s_g, s_c)
    print(f"[train] (c) card vs CPU, one step: loss {l_g:.7f} / {l_c:.7f} "
          f"(relative {l_rel:.3g}, bound {TOL_TRAIN_LOSS:g}); grad_norm "
          f"relative {n_rel:.3g}; per-leaf gradients {g_rel:.3g} of each "
          f"leaf's largest (bound {TOL_TRAIN_GRAD:g}); update criterion "
          f"{upd:.3g} (bound {TOL_TRAIN_UPDATE:g}); CPU {sec_c:.1f} s, card "
          f"{sec_g:.1f} s")
    _check(l_rel <= TOL_TRAIN_LOSS and n_rel <= TOL_TRAIN_GRAD
           and g_rel <= TOL_TRAIN_GRAD and upd <= TOL_TRAIN_UPDATE,
           f"(c) card vs CPU: loss {l_rel}, grad_norm {n_rel}, gradients "
           f"{g_rel}, update {upd}")


def _phase14_restart():
    """(d) kill and restart on xlstm-125m as published."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import one_device_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer

    cfg = get_config("xlstm-125m")
    model = build_model(cfg, device="cuda")
    steps = 8
    opt = adamw(warmup_cosine(3e-4, warmup_steps=max(steps // 10, 1),
                              total_steps=steps))
    pipe = TokenPipeline(cfg, batch=TRAIN_B, seq_len=TRAIN_T, seed=0)
    mesh = one_device_mesh("cuda")
    logs = []
    os.environ.pop("REPRO_FAILED_ONCE", None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            tempfile.TemporaryDirectory() as td2:
        first = Trainer(model, opt, mesh, pipe, ckpt_dir=td, ckpt_every=4,
                        log_fn=logs.append)
        try:
            first.run(0, steps, fail_at=6)
            failed = False
        except RuntimeError:
            failed = True
        _check(failed, "(d) the injected failure at step 6 did not fire")
        shard = sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(td) for f in fs)
        out = Trainer(model, opt, mesh, pipe, ckpt_dir=td, ckpt_every=4,
                      log_fn=logs.append).run(0, steps)
        ref = Trainer(model, opt, mesh, pipe, ckpt_dir=td2, ckpt_every=4,
                      log_fn=lambda s: None).run(0, steps)
        ckpts = sorted(os.listdir(td))
    os.environ.pop("REPRO_FAILED_ONCE", None)
    h = out["history"]
    _check(h[0]["step"] == 4 and h[-1]["step"] == steps - 1,
           f"(d) resumed at {h[0]['step']}, ended at {h[-1]['step']}")
    _check(any("restoring step 4" in s for s in logs),
           "(d) no 'restoring step 4' log line")
    same = all(torch.equal(a, b) for a, b in zip(
        _tree.leaves(out["final_state"]), _tree.leaves(ref["final_state"]),
        strict=True))
    _check(same, "(d) the resumed run is not the uninterrupted run bitwise")
    _check(h[-1]["loss"] < h[0]["loss"],
           f"(d) the resumed run's loss did not fall: {h[0]['loss']} -> "
           f"{h[-1]['loss']}")
    _check(not os.path.exists(td) and not os.path.exists(td2),
           "(d) a checkpoint directory was left behind")
    n = sum(x.numel() for x in _tree.leaves(out["final_state"].params))
    print(f"[train] (d) xlstm-125m ({n:,} parameters): {steps} steps, "
          f"checkpoints every 4 ({shard / 1e9:.2f} GB a checkpoint on disk, "
          f"{ckpts}), a failure injected at step 6; a fresh Trainer resumed "
          f"at step 4 and its final state is the uninterrupted run's, "
          f"bitwise; losses {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
          f"{time.perf_counter() - t0:.1f} s (steps of the uninterrupted "
          f"run: median {np.median([r['sec'] for r in ref['history'][1:]]) * 1e3:.1f}"
          f" ms, host clock); the directories removed")


def _phase14_launcher():
    """(f) the training launcher twice on one --ckpt-dir, the second
    resuming: its specs for `_Lane` (run beside phase 18)."""
    return [("[train launcher]",
             [sys.executable, "-m", "repro_torch.launch.train", "--arch",
              TRAIN_ARCH, "--smoke", "--steps", str(steps), "--ckpt-every",
              "2", "--batch", "2", "--seq-len", "32", "--ckpt-dir", "{tmp}"],
             "[train", wants)
            for steps, wants in ((4, ("[train] done",)),
                                 (6, ("[train] done", "restoring step 4")))]


def _phase14():
    """14. Language-model training on the card (module docstring). Returns
    the kernels' launch counts over the phase, read around it."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.reset_launches()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    print(f"[train] {TRAIN_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared} shared, vocab {cfg.vocab_size}), depth cut "
          f"to {TRAIN_LAYERS} layers (dense layer 0 + "
          f"{TRAIN_LAYERS - 1} stacked MoE units), bfloat16 compute, remat "
          f"on; adamw(warmup_cosine(3e-4, warmup 1, total {TRAIN_STEPS}))")
    for router in ("topk", "sinkhorn"):
        _phase14_run(cfg, router)
        gc.collect()
        torch.cuda.empty_cache()
    _phase14_depth2(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    _phase14_restart()
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(_build.launches)
    print(f"[train] kernel launches over phase 14: {launches or 'none'} "
          f"(training runs no hand-written kernel)")
    _check(sum(launches.values()) == 0, "phase 14 launched a WMD kernel")
    print(f"[train] phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- 15. the language-model mesh ---------------------------------------------

MESH_SHAPE = (2, 2)            # logical shards of cuda:0 (module docstring)
MESH_TOL_F32 = 1e-4            # mesh vs 1 x 1 logits, of the largest |logit|
MESH_TOL_TRAIN = 1e-5          # mesh vs 1 x 1 loss and grad_norm: relative
ROUTE_TIE = 1e-4               # a near-tie of a token's k-th / k+1-th score
MESH_SERVE_LAYERS = 8          # (a)'s depth: dense layer 0 + 7 MoE layers
MESH_TRAIN_LAYERS = 2          # (b)'s: dense layer 0 + one MoE layer


def _first_routing_flip(e, one, mesh):
    """The first router call (execution order) whose experts differ
    between the 1 x 1 run and the mesh: (its index, the relative gap
    between the differing tokens' k-th and k+1-th 1 x 1 scores, a
    description, the call's router logits' relative difference); the
    index is None when every call routes alike. The Sinkhorn router at
    decode balances T = 4 tokens over 64 experts: an expert's column
    saturates at T / E, so a token's top-6 scores can tie within ~1e-6
    relative and float32 reassociation flips them (ROADMAP Queue 3)."""
    import torch

    from repro_torch.models.layers import moe
    for j, ((lg1, id1), (lgm, idm)) in enumerate(zip(one, mesh,
                                                     strict=True)):
        diff = (id1.sort(-1).values != idm.sort(-1).values).any(-1)
        if not bool(diff.any()):
            continue
        lg_rel = float((lgm - lg1).abs().max() / lg1.abs().max())
        scores = (moe._sinkhorn_scores(e, -torch.log_softmax(lg1, -1))
                  if e.router == "sinkhorn" else torch.softmax(lg1, -1))
        top = scores.sort(-1, descending=True).values[diff]
        k = e.top_k
        gap = float(((top[:, k - 1] - top[:, k]) / top[:, k - 1]).max())
        return j, gap, (
            f"first routing difference at router call {j} of {len(one)} "
            f"({int(diff.sum())} of {diff.numel()} tokens, "
            f"{lg1.shape[0]} routed): the 1 x 1 scores' k-th / k+1-th "
            f"relative gap there {gap:.3g} (near-tie bound {ROUTE_TIE:g}), "
            f"router logits {lg_rel:.3g} apart"), lg_rel
    return None, 0.0, f"routing equal in all {len(one)} router calls", 0.0


def _lm_mesh(shape, axes=("data", "model")):
    """A mesh of logical shards on cuda:0."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes,
                     devices=[torch.device("cuda", 0)] * math.prod(shape))


def _mesh_prefill(cfg, params, tokens, max_len, cache_dtype):
    """The model API's prefill with a cache of ``cache_dtype``, on the
    layout of ``params`` (placed on a mesh, or one device): (last-position
    logits, cache). For the float32 runs, whose float32 cache the serve
    entry (a bfloat16 cache) does not make."""
    from repro_torch.distributed import spmd
    from repro_torch.models import lm
    from repro_torch.models.layers import embedding
    from repro_torch.models.registry import _compute_dtype
    lay = lm.program_layout(cfg, params)
    toks = [spmd.rows_of(lay, tokens, g) for g in range(lay.n_groups)]
    x = embedding.mesh_embed(lay, cfg, params["embedding"], toks,
                             dtype=_compute_dtype(cfg))
    h, cache = lm.prefill(cfg, params, x, max_len=max_len, q_block=16,
                          kv_block=16, cache_dtype=cache_dtype)
    parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                         [hh[:, -1:] for hh in h])
    return embedding.mesh_unshard_logits(lay, parts, split), cache


def _forced_loop(dec, params, cache, feed):
    """Decode steps fed the tokens ``feed`` (B, steps): (logits (B, steps,
    V) on the host, ms a step by CUDA events)."""
    import torch
    outs, events = [], []
    for i in range(feed.shape[1]):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = dec(params, cache, feed[:, i:i + 1])
        stop.record()
        outs.append(logits)
        events.append((start, stop))
    torch.cuda.synchronize()
    return (torch.cat(outs, 1).float().cpu(),
            [s.elapsed_time(e) for s, e in events])


def _launch_count(call):
    """(wall ms, device busy ms, idle share, device entries) of one warm
    ``call`` (`_device_busy`); None where the trace holds no device time."""
    wall, _, busy, largest, groups = _device_busy(
        call, top=3, groups=(("all", ("",)),))
    if busy is None:
        return wall, None, None, None, largest
    return wall, busy, 1 - busy / wall, groups["all"][0], largest


def _phase15_serve(mesh):
    """(a) deepseek-moe-16b as published, 1 x 1 then the mesh, both routers,
    bfloat16 and float32 compute."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import partitioning
    from repro_torch.models import build_model
    from repro_torch.models.layers import moe
    from repro_torch.models.lm import _tree_map
    from repro_torch.models.sharding_hints import activation_sharding
    from repro_torch.serving import build_serve_fns

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=MESH_SERVE_LAYERS)
    b, t, steps = 4, 64, 8
    max_len = t + steps
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    runs, feeds, report = {}, {}, {}
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers   # calls a forward

    def serve(c, p, m, key):
        model = build_model(c, q_block=16, kv_block=16)
        prefill_for, decode_for = build_serve_fns(model, m, max_len=max_len)
        if c.compute_dtype == "bfloat16":   # the serve entry's own cache
            def pre():
                return prefill_for(b)(p, {"tokens": tokens})
        else:
            def pre():
                return _mesh_prefill(c, p, tokens, max_len, torch.float32)
        groups = 1 if m is None else m.size // m.shape["model"]
        routed, gates, spying = [], moe._gates, [True]

        def spy(e, lg):           # each router call's logits and experts
            out = gates(e, lg)
            if spying[0]:
                routed.append((lg.detach().float().cpu(), out[0].cpu()))
            return out

        moe._gates = spy
        try:
            with activation_sharding(m, "prefill"):
                logits, cache = pre()
            out = _serve_rest(c, p, m, key, logits, cache, pre, decode_for,
                              spying)
        finally:
            moe._gates = gates
        # the mesh runs the router on every batch group (all T tokens
        # each): group 0's calls stand for the layer's
        return out + (routed[::groups],)

    def _serve_rest(c, p, m, key, logits, cache, pre, decode_for, spying):
        if key not in feeds:                  # the 1 x 1 run: greedy
            spying[0] = False
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            fed = [tok]
            cur = _tree_map(torch.clone, cache)
            dec = decode_for(b)
            for _ in range(steps - 1):
                out, cur = dec(p, cur, tok)
                tok = torch.argmax(out[:, -1], -1)[:, None]
                fed.append(tok)
            feeds[key] = torch.cat(fed, 1)
            del cur
            spying[0] = True
        feed = feeds[key]
        with activation_sharding(m, "decode"):
            kept, ms = _forced_loop(decode_for(b, donate_cache=False), p,
                                    cache, feed)
            spying[0] = False
            donated, _ = _forced_loop(decode_for(b), p, cache, feed)
        _check(torch.equal(kept, donated), f"{key} on {m}: the donated "
               f"decode loop is not the kept one bitwise")
        torch.cuda.synchronize()
        with activation_sharding(m, "prefill"):
            pre_ms = _timed(pre, 1, warmup=0)
        out = (logits.float().cpu(), kept, feed.cpu(), pre_ms,
               float(np.median(ms)))
        if c.compute_dtype == "bfloat16" and c.moe.router == "topk":
            tok = feed[:, :1]
            with activation_sharding(m, "decode"):
                report[1 if m is None else m.size] = _launch_count(
                    lambda: decode_for(b, donate_cache=False)(p, cache, tok))
        del cache
        return out

    variants = [(r, d) for r in ("topk", "sinkhorn")
                for d in ("bfloat16", "float32")]
    cfgs = {(r, d): dataclasses.replace(
        cfg, compute_dtype=d, moe=dataclasses.replace(cfg.moe, router=r))
        for r, d in variants}
    torch.cuda.reset_peak_memory_stats()
    for key in variants:
        runs[("1x1",) + key] = serve(cfgs[key], params, None, key)
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    placed = partitioning.shard(params,
                                partitioning.param_shardings(mesh, params))
    del params          # the blocks are views: the parameters moved, no copy
    print(f"[mesh] (a) deepseek-moe-16b ({cfg.num_layers} layers at full "
          f"width)'s parameters placed on {mesh} in "
          f"{time.perf_counter() - t0:.2f} s (blocks that are views of "
          f"the one-card tensors); memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    for key in variants:
        runs[("mesh",) + key] = serve(cfgs[key], placed, mesh, key)
    peak_m = torch.cuda.max_memory_allocated() / 2**30
    del placed
    for r in ("topk", "sinkhorn"):
        f1 = runs[("1x1", r, "float32")]
        b1 = runs[("1x1", r, "bfloat16")]
        own = _rel_err(b1[0].numpy(), f1[0].numpy())
        for d in ("bfloat16", "float32"):
            one, mesh_run = runs[("1x1", r, d)], runs[("mesh", r, d)]
            pre = _rel_err(mesh_run[0].numpy(), one[0].numpy())
            dec = _rel_err(mesh_run[1].numpy(), one[1].numpy())
            bound = MESH_TOL_F32 if d == "float32" else _bf16_bound(own)
            same_tok = bool((mesh_run[1].argmax(-1)
                             == one[1].argmax(-1)).all())
            flip = _first_routing_flip(cfgs[(r, d)].moe, one[5],
                                       mesh_run[5])
            print(f"[mesh] (a) {r}, {d}: mesh vs 1 x 1 prefill logits "
                  f"{pre:.3g}, {steps} decode steps {dec:.3g} of the "
                  f"largest |logit| (bound {bound:g}); greedy tokens equal "
                  f"{same_tok}; prefill {mesh_run[3]:.2f} ms [1 x 1 "
                  f"{one[3]:.2f}], decode {mesh_run[4]:.2f} ms a token "
                  f"[{one[4]:.2f}] (CUDA events); donated and kept decode "
                  f"loops bitwise equal; {flip[2]}")
            _check(pre <= bound, f"(a) {r} {d}: mesh vs 1 x 1 prefill "
                   f"{pre} > {bound}")
            if d == "float32" and flip[0] is None:
                _check(dec <= bound and same_tok, f"(a) {r}: decode {dec} "
                       f"> {bound} or greedy tokens differ with the same "
                       f"routing")
            elif d == "float32":
                # a routing difference is allowed only at a near-tie of
                # the 1 x 1 scores, after router logits that agree; every
                # decode step before the step of that router call is held
                # as with equal routing
                _check(flip[1] <= ROUTE_TIE and flip[3] <= MESH_TOL_F32,
                       f"(a) {r}: the first routing difference is not at "
                       f"a near-tie: {flip[2]}")
                _check(len(one[5]) == n_moe * (steps + 1),
                       f"(a) {r}: {len(one[5])} router calls, not "
                       f"{n_moe} a forward over {steps + 1} forwards")
                held = flip[0] // n_moe - 1   # -1: in the prefill
                dec_h, tok_h = 0.0, True
                if held > 0:
                    dec_h = _rel_err(mesh_run[1][:, :held].numpy(),
                                     one[1][:, :held].numpy())
                    tok_h = bool((mesh_run[1][:, :held].argmax(-1)
                                  == one[1][:, :held].argmax(-1)).all())
                where = "the prefill" if held < 0 \
                    else f"decode step {held} (0-based)"
                print(f"[mesh] (a) {r}, {d}: the flip falls in {where}; "
                      f"the {max(held, 0)} decode steps before "
                      f"it {dec_h:.3g} of the largest |logit| (bound "
                      f"{bound:g}), greedy tokens equal {tok_h}")
                _check(dec_h <= bound and tok_h, f"(a) {r}: decode steps "
                       f"before the routing difference {dec_h} > {bound} "
                       f"or greedy tokens differ")
            else:
                _check(dec <= bound, f"(a) {r} {d}: decode {dec} > {bound}")
    for size, (wall, busy, idle, n, largest) in sorted(report.items()):
        where = "1 x 1" if size == 1 else str(mesh)
        if busy is None:
            print(f"[idle] (a) decode step on {where}: {wall:.2f} ms wall; "
                  f"device time not measured ({largest})")
        else:
            print(f"[idle] (a) decode step (top-k, bfloat16) on {where}: "
                  f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
                  f"share {idle:.3f}, {n} device entries; largest: "
                  f"{largest}")
    print(f"[mesh] (a) peak device memory {peak_m:.2f} GiB on the mesh "
          f"[1 x 1 {peak1:.2f}] (torch.cuda.max_memory_allocated)")


def _phase15_step(model, opt, mesh, batch, fresh, n_steps, check=None):
    """``n_steps`` donated steps from ``fresh()`` on ``mesh`` (None: one
    device): (metrics of each step on the host, the final state, ms a
    step by CUDA events)."""
    import torch

    from repro_torch.models.sharding_hints import activation_sharding
    from repro_torch.train import build_train_step, state_shardings
    from repro_torch.train.step import place

    state = fresh()
    if mesh is not None:
        state = place(state, state_shardings(mesh, state))
    step = build_train_step(model, opt, mesh, grad_compression=state.comp
                            is not None)
    mets, ms = [], []
    for _ in range(n_steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        with activation_sharding(mesh):
            state, met = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        mets.append({k: float(v) for k, v in met.items()})
        if check is not None:
            check(state)
    return mets, state, ms, step


def _host_leaves(tree):
    from repro_torch import _tree
    from repro_torch.distributed import partitioning
    return [x.unshard("cpu") if isinstance(x, partitioning.Placed)
            else x.to("cpu", copy=True) for x in _tree.leaves(tree)]


def _phase15_train(mesh):
    """(b) deepseek-moe-16b at full width, depth 2, float32 compute, both
    routers: the mesh step against the 1 x 1 step from one state, two mesh
    steps from one state bitwise."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models.sharding_hints import activation_sharding
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state

    dev = torch.device("cuda")
    base = dataclasses.replace(get_config(TRAIN_ARCH),
                               num_layers=MESH_TRAIN_LAYERS,
                               compute_dtype="float32")
    for router in ("topk", "sinkhorn"):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, router=router))
        model = build_model(cfg, device=dev)
        opt = adamw(warmup_cosine(3e-4, warmup_steps=1,
                                  total_steps=TRAIN_STEPS))
        batch = TokenPipeline(cfg, batch=TRAIN_B, seq_len=TRAIN_T,
                              seed=0).batch_at(0)

        def fresh():
            return init_state(model, opt,
                              torch.Generator(device=dev).manual_seed(0))

        torch.cuda.reset_peak_memory_stats()
        st = fresh()
        p0 = _host_leaves(st.params)
        del st
        after_one = []           # the 1 x 1 parameters after step 1

        def keep_first(state):
            if not after_one:
                after_one.append(_host_leaves(state.params))

        m_one, s1, ms1, _ = _phase15_step(model, opt, None, batch, fresh, 2,
                                          check=keep_first)
        peak1 = torch.cuda.max_memory_allocated() / 2**30
        p_one = after_one.pop()
        del s1
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mm, sm, msm, step = _phase15_step(model, opt, mesh, batch, fresh, 1)
        peak_m = torch.cuda.max_memory_allocated() / 2**30
        first = _host_leaves(sm.params)
        del sm
        gc.collect()
        torch.cuda.empty_cache()
        mm2, sm2, msm2, step = _phase15_step(model, opt, mesh, batch, fresh,
                                             1)
        second = _host_leaves(sm2.params)
        same = all(torch.equal(a, b) for a, b in zip(first, second,
                                                     strict=True))
        _check(same and mm[0] == mm2[0], f"(b) {router}: two mesh steps "
               f"from one state differ")
        with activation_sharding(mesh):
            wall, busy, idle, n, largest = _launch_count(
                lambda: step(sm2, batch))
        del sm2, second
        upd = _update_rel(p0, first, p_one)
        l_rel = abs(mm[0]["loss"] - m_one[0]["loss"]) / abs(m_one[0]["loss"])
        n_rel = abs(mm[0]["grad_norm"] - m_one[0]["grad_norm"]) \
            / abs(m_one[0]["grad_norm"])
        print(f"[mesh] (b) {router}: one step on {mesh} against 1 x 1, "
              f"float32: loss {mm[0]['loss']:.7f} / {m_one[0]['loss']:.7f} "
              f"(relative {l_rel:.3g}), grad_norm relative {n_rel:.3g} "
              f"(bound {MESH_TOL_TRAIN:g}); update criterion {upd:.3g} "
              f"(bound {TOL_TRAIN_UPDATE:g}); two mesh steps from one "
              f"state bitwise ({len(first)} parameter tensors, which the "
              f"moments update, and the metrics)")
        _check(l_rel <= MESH_TOL_TRAIN and n_rel <= MESH_TOL_TRAIN
               and upd <= TOL_TRAIN_UPDATE,
               f"(b) {router}: loss {l_rel}, grad_norm {n_rel}, update "
               f"{upd}")
        tok = TRAIN_B * TRAIN_T
        print(f"[mesh] (b) {router}: step {msm[0]:.2f} / {msm2[0]:.2f} ms on "
              f"the mesh ({tok / msm2[0] * 1e3:,.0f} tokens/s) [1 x 1 "
              f"{ms1[1]:.2f} ms, second step; {tok / ms1[1] * 1e3:,.0f} "
              f"tokens/s] (CUDA events); peak {peak_m:.2f} GiB [{peak1:.2f}]")
        if busy is None:
            print(f"[idle] (b) train step ({router}) on the mesh: "
                  f"{wall:.2f} ms wall; device time not measured "
                  f"({largest})")
        else:
            print(f"[idle] (b) train step ({router}) on the mesh: "
                  f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
                  f"share {idle:.3f}, {n} device entries; largest: "
                  f"{largest}")
        del first, p0, p_one
        gc.collect()
        torch.cuda.empty_cache()


def _phase15_pods():
    """(c) a (2, 1, 2) pod mesh with grad compression, depth 2."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2,
                              compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="sinkhorn"))
    model = build_model(cfg, device=dev)
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=TRAIN_STEPS))
    batch = TokenPipeline(cfg, batch=TRAIN_B, seq_len=TRAIN_T,
                          seed=0).batch_at(0)
    mesh = _lm_mesh((2, 1, 2), ("pod", "data", "model"))

    def fresh():
        return init_state(model, opt,
                          torch.Generator(device=dev).manual_seed(0),
                          grad_compression=True)

    st = fresh()
    n = sum(x.numel() for x in _tree.leaves(st.params))
    p0 = _host_leaves(st.params)
    del st
    print(f"[mesh] (c) {TRAIN_ARCH} depth 2, float32, Sinkhorn, grad "
          f"compression on {mesh}: {n:,} parameters; a pod replica holds "
          f"{16 * n / 1e9:.1f} GB of parameters, moments and residuals "
          f"({2 * 16 * n / 1e9:.1f} GB for both pods on the one card)")
    m1, s1, _, _ = _phase15_step(model, opt, None, batch, fresh, 2)
    p1 = _host_leaves(s1.params)
    del s1
    gc.collect()
    torch.cuda.empty_cache()
    checked = []

    def replicas_equal(state):
        ok = all(torch.equal(leaf.blocks[(0, *c)], leaf.blocks[(1, *c)])
                 for leaf in _tree.leaves((state.params, state.opt.mu,
                                           state.opt.nu, state.comp.residual))
                 for c in np.ndindex(leaf.blocks.shape[1:]))
        checked.append(ok)
        _check(ok, f"(c) pod replicas differ after step {len(checked)}")

    torch.cuda.reset_peak_memory_stats()
    mm, sm, ms, _ = _phase15_step(model, opt, mesh, batch, fresh, 2,
                                  check=replicas_equal)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pm = _host_leaves(sm.params)
    del sm
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(mm, m1)]
    upd = _update_rel(p0, pm, p1)
    print(f"[mesh] (c) pod replicas bitwise equal after each of "
          f"{len(checked)} steps; losses {[round(m['loss'], 6) for m in mm]}"
          f" vs 1 x 1 {[round(m['loss'], 6) for m in m1]} (relative "
          f"{max(rel):.3g}, bound {MESH_TOL_TRAIN:g}); update criterion "
          f"after 2 steps {upd:.3g} (bound {TOL_TRAIN_UPDATE:g}); step "
          f"{ms[1]:.2f} ms (CUDA events); peak {peak:.2f} GiB")
    _check(max(rel) <= MESH_TOL_TRAIN and upd <= TOL_TRAIN_UPDATE,
           f"(c) pods vs 1 x 1: loss {rel}, update {upd}")
    del p0, p1, pm


def _phase15_checkpoint():
    """(d) a deepseek smoke state written on (2, 2), restored on (1, 1)
    and (4, 1)."""
    import torch

    from repro_torch import _tree
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import partitioning
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, state_shardings
    from repro_torch.train.step import place, state_struct

    model = build_model(get_smoke_config(TRAIN_ARCH))
    opt = adamw(1e-3)
    state = init_state(model, opt, torch.Generator(device="cuda")
                       .manual_seed(0), grad_compression=True)
    placed = place(state, state_shardings(_lm_mesh(MESH_SHAPE), state))
    want = _host_leaves(state)
    with tempfile.TemporaryDirectory() as td:
        ckpt.save(os.path.join(td, "mesh"), 1, placed,
                  mesh_signature="data=2xmodel=2")
        ckpt.save(os.path.join(td, "one"), 1, state)
        step_dir = "step_00000001"
        names = sorted(os.listdir(os.path.join(td, "one", step_dir)))
        same = all(pathlib.Path(td, "mesh", step_dir, f).read_bytes()
                   == pathlib.Path(td, "one", step_dir, f).read_bytes()
                   for f in names if f.startswith("shard_"))
        struct = state_struct(model, opt, grad_compression=True)
        ok = {}
        for shape in ((1, 1), (4, 1)):
            got = ckpt.restore(os.path.join(td, "mesh"), 1, struct,
                               shardings=state_shardings(_lm_mesh(shape),
                                                         struct))
            placed_ok = all(isinstance(x, partitioning.Placed)
                            == (shape != (1, 1))
                            for x in _tree.leaves(got.params))
            ok[shape] = placed_ok and all(
                torch.equal(a, b) for a, b in zip(_host_leaves(got), want,
                                                  strict=True))
    print(f"[mesh] (d) a smoke state written on (2, 2): shard files "
          f"{names} byte-equal to a 1 x 1 save {same}; restored on (1, 1) "
          f"and (4, 1) bitwise {ok[(1, 1)]} / {ok[(4, 1)]}")
    _check(same and all(ok.values()), "(d) the elastic checkpoint")


def _phase15_launchers():
    """(e) both launchers as subprocesses on --devices 4 --mesh 2x2: the
    serving launcher, and the training launcher twice on one --ckpt-dir,
    the second resuming. Their specs for two `_Lane`s (run beside phase
    18)."""
    mesh = ["--devices", "4", "--mesh", "2x2"]
    serve = [("[mesh launcher]",
              [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "deepseek-moe-16b", "--smoke", *mesh], "[serve]",
              ("decode steps",))]
    train = [("[mesh launcher]",
              [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "gemma-2b", "--smoke", "--steps", str(steps), "--ckpt-every",
               "2", "--batch", "4", "--seq-len", "32", "--ckpt-dir", "{tmp}",
               *mesh], "[train", (want,))
             for steps, want in ((2, "[train] done"),
                                 (4, "restoring step 2"))]
    return [serve, train]


def _phase15():
    """15. The language-model mesh (module docstring). Returns the kernels'
    launch counts over the phase, read around it."""
    import gc

    import torch

    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.reset_launches()
    mesh = _lm_mesh(MESH_SHAPE)
    print(f"[mesh] phase 15 on {mesh}: {mesh.size} logical shards of one "
          f"card ({torch.cuda.device_count()} visible)")
    for part in (lambda: _phase15_serve(mesh), lambda: _phase15_train(mesh),
                 _phase15_pods, _phase15_checkpoint):
        t0 = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[mesh] ({time.perf_counter() - t0:.1f} s)")
    launches = dict(_build.launches)
    print(f"[mesh] kernel launches over phase 15: {launches or 'none'} (the "
          f"language-model mesh runs no hand-written kernel)")
    _check(sum(launches.values()) == 0, "phase 15 launched a WMD kernel")
    print(f"[mesh] phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- 16. the mixers on the mesh ----------------------------------------------

# (b)'s depth: minicpm3-4b and recurrentgemma-9b cut to one pattern unit
# (AdamW's state at full depth would not fit the card: 16 B a parameter),
# xlstm-125m and whisper-small whole
_MIX_TRAIN_CUT = {"minicpm3-4b": dict(num_layers=1),
                  "recurrentgemma-9b": dict(num_layers=3),
                  "xlstm-125m": {}, "whisper-small": {}}
# the configs whose update criterion is reported, not held, and whose
# first moments (0.1 x the gradient after one step) are held at
# TOL_MOMENT_XLSTM: xlstm-125m's gradients move with the order of any sum
# (the mLSTM divides by max(|q . n|, exp(-m))): a (2, 1) mesh, whose only
# change from 1 x 1 is the order in which the two batch groups'
# gradients are summed, moves them 2.0e-4 of a leaf's largest
# (`scripts/mesh_moments.py`),
# and its sLSTM bias has gradient elements at rounding level, which
# Adam's first step moves by a rounding-decided part of the learning
# rate (the port's and the reference's one-device steps at smoke size
# lie 8.5e-3 apart, `tests/test_torch_train_mixers_mesh.py`)
_UPDATE_REPORTED = ("xlstm-125m",)
TOL_MOMENT_XLSTM = 1e-3
TOL_MOMENT_INT8 = 1e-2     # (c): an int8 code at a rounding edge moves an
                           # element by one step, 1/127 of its block's max


def _moment_rel(a, b) -> float:
    """max over leaves of max |a - b| / max |b| (first moments)."""
    return max(float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))
               for x, y in zip(a, b, strict=True))


def _logical_leaves(tree):
    """The logical tensors of a tree's leaves on the card, one at a time
    (a placed leaf unsharded, a tensor as it is)."""
    from repro_torch import _tree
    from repro_torch.distributed import partitioning
    for x in _tree.leaves(tree):
        yield x.unshard() if isinstance(x, partitioning.Placed) else x


def _update_rel_card(before, after_a, after_b) -> float:
    """`_update_rel` on the card, leaf by leaf in float64 chunks (no host
    copy of a state: (b)'s recurrentgemma holds 1.7 B parameters)."""
    import torch
    worst, step = 0.0, 1 << 24
    for p, a, b in zip(before, after_a, after_b, strict=True):
        p, a, b = p.reshape(-1), a.reshape(-1), b.reshape(-1)
        num = den = 0.0
        for lo in range(0, p.numel(), step):
            pp = p[lo:lo + step].double()
            da, db = a[lo:lo + step].double() - pp, b[lo:lo + step].double() - pp
            num += float(torch.sum(torch.square(da - db)))
            den += float(torch.sum(torch.square(db)))
        worst = max(worst, num ** 0.5 / max(den ** 0.5, 1e-30))
    return worst


class _Float32Run:
    """A float32 run of the model API: its prefill makes a float32 cache
    (`lm.prefill` / `encdec.prefill` with ``cache_dtype`` float32), and
    whisper's decoder, which embeds at bfloat16 whatever the compute
    dtype (ROADMAP Queue 3), embeds at float32 (`embedding.mesh_embed`'s
    default lifted, as `tests/test_torch_mixers_mesh.py` lifts it).
    Nothing changes for a bfloat16 config."""

    def __init__(self, cfg):
        self.on = cfg.compute_dtype == "float32"

    def __enter__(self):
        import functools

        import torch

        from repro_torch.models import encdec, lm
        from repro_torch.models.layers import embedding
        self.saved = [(m, n, getattr(m, n)) for m, n in
                      ((lm, "prefill"), (encdec, "prefill"),
                       (embedding, "mesh_embed"))]
        if self.on:
            for m, n, f in self.saved:
                kw = ({"dtype": torch.float32} if n == "mesh_embed"
                      else {"cache_dtype": torch.float32})
                setattr(m, n, functools.partial(f, **kw))
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)
        return False


def _phase16_serve_arch(arch, mesh, card):
    """(a) One config at full width and `_SERVE_CUT`'s depth: phase 13's
    checks on the 1 x 1 layout
    ((a) two greedy decode loops, which give the 1 x 1 bfloat16 run; (b)
    decode against prefill; (d) MLA's absorbed decode), the 1 x 1 float32
    run, then the same parameters moved onto the mesh, bfloat16 and
    float32 compute, against the 1 x 1 runs; last, phase 13's (c): the
    card against the CPU at reduced depth."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import partitioning
    from repro_torch.models import build_model
    from repro_torch.models.lm import _tree_map, stack_plan
    from repro_torch.models.sharding_hints import activation_sharding
    from repro_torch.serving import build_serve_fns

    t_arch = time.perf_counter()
    cfg = _cut(get_config(arch), _SERVE_CUT[arch])
    b, t, steps = SERVE_B, SERVE_T, MESH_STEPS
    max_len = t + SERVE_STEPS
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(
            b, cfg.encoder.num_positions, cfg.d_model)).astype(np.float32)
    kinds = ("encoder-decoder, " + f"{cfg.encoder.num_layers} + "
             f"{cfg.num_layers} layers, {cfg.encoder.num_positions} frames"
             if cfg.family == "audio" else
             f"{cfg.num_layers} layers, units of {stack_plan(cfg).unit} x "
             f"{stack_plan(cfg).n_units} + tail {stack_plan(cfg).tail}")
    print(f"[mix] {arch}: {kinds}, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads (kv {cfg.num_kv_heads}), vocab {cfg.vocab_size}"
          f"{', MLA' if cfg.mla is not None else ''}; batch {b}, prefill "
          f"{t}, {SERVE_STEPS} decode steps (the mesh runs {steps}), "
          f"q_block = kv_block = 16; "
          f"{'depth cut (`_SERVE_CUT`)' if _SERVE_CUT[arch] else 'whole'}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, x in _named(params))
    print(f"[mix] {arch}: {n_params:,} parameters, "
          f"{4 * n_params / 1e9:.2f} GB float32, made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    runs, peak = {}, {}
    runs[("1x1", "bfloat16")], feed, traced = _mixer_greedy(
        arch, cfg, params, batch, max_len)
    feeds, report = {"bfloat16": feed}, {1: traced}
    _mixer_decode_vs_prefill(arch, cfg, params, batch)
    if cfg.mla is not None:
        _mixer_mla(arch, cfg, params, max_len)

    def serve(c, p, m):
        model = build_model(c, q_block=16, kv_block=16)
        prefill_for, decode_for = build_serve_fns(model, m, max_len=max_len)

        def pre():
            return prefill_for(b)(p, batch)

        with _Float32Run(c):
            with activation_sharding(m, "prefill"):
                logits, cache = pre()
            key = c.compute_dtype
            if key not in feeds:                  # the 1 x 1 run: greedy
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                fed, cur = [tok], _tree_map(torch.clone, cache)
                dec = decode_for(b)
                for _ in range(steps - 1):
                    out, cur = dec(p, cur, tok)
                    tok = torch.argmax(out[:, -1], -1)[:, None]
                    fed.append(tok)
                feeds[key] = torch.cat(fed, 1)
                del cur
            feed = feeds[key]
            with activation_sharding(m, "decode"):
                kept, ms = _forced_loop(decode_for(b, donate_cache=False),
                                        p, cache, feed)
                donated, _ = _forced_loop(decode_for(b), p,
                                          _tree_map(torch.clone, cache),
                                          feed)
            _check(torch.equal(kept, donated), f"{arch} {key} on {m}: the "
                   f"donated decode loop is not the kept one bitwise")
            torch.cuda.synchronize()
            with activation_sharding(m, "prefill"):
                pre_ms = _timed(pre, 1, warmup=0)
            if key == "bfloat16":
                tok = feed[:, :1]
                with activation_sharding(m, "decode"):
                    report[m.size] = _launch_count(
                        lambda: decode_for(b, donate_cache=False)(
                            p, cache, tok))
        del cache
        return (logits.float().cpu(), kept, pre_ms, float(np.median(ms)))

    cfgs = {d: dataclasses.replace(cfg, compute_dtype=d)
            for d in ("bfloat16", "float32")}
    runs[("1x1", "float32")] = serve(cfgs["float32"], params, None)
    peak[1] = torch.cuda.max_memory_allocated() / 2**30
    placed = partitioning.shard(params,
                                partitioning.param_shardings(mesh, params))
    del params          # the blocks are views: the parameters moved
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for d, c in cfgs.items():
        runs[("mesh", d)] = serve(c, placed, mesh)
    peak[mesh.size] = torch.cuda.max_memory_allocated() / 2**30
    del placed
    own = _rel_err(runs[("1x1", "bfloat16")][0].numpy(),
                   runs[("1x1", "float32")][0].numpy())
    for d in cfgs:
        one, mr = runs[("1x1", d)], runs[("mesh", d)]
        pre = _rel_err(mr[0].numpy(), one[0].numpy())
        dec = _rel_err(mr[1].numpy(), one[1].numpy())
        bound = MESH_TOL_F32 if d == "float32" else _bf16_bound(own)
        same_tok = bool((mr[1].argmax(-1) == one[1].argmax(-1)).all()
                        and (mr[0].argmax(-1) == one[0].argmax(-1)).all())
        print(f"[mesh16] (a) {arch}, {d}: mesh vs 1 x 1 prefill logits "
              f"{pre:.3g}, {steps} decode steps {dec:.3g} of the largest "
              f"|logit| (bound {bound:.3g}); greedy tokens equal {same_tok};"
              f" prefill {mr[2]:.2f} ms [1 x 1 {one[2]:.2f}], decode "
              f"{mr[3]:.2f} ms a token [{one[3]:.2f}] (CUDA events); "
              f"donated and kept decode loops bitwise equal; {card}")
        _check(pre <= bound and dec <= bound, f"(a) {arch} {d}: mesh vs "
               f"1 x 1 prefill {pre}, decode {dec} > {bound}")
        if d == "float32":
            _check(same_tok, f"(a) {arch}: greedy tokens differ")
    for size, (wall, busy, idle, n, largest) in sorted(report.items()):
        where = "1 x 1" if size == 1 else str(mesh)
        if busy is None:
            print(f"[idle] (a) {arch} decode step (bfloat16) on {where}: "
                  f"{wall:.2f} ms wall; device time not measured "
                  f"({largest})")
        else:
            print(f"[idle] (a) {arch} decode step (bfloat16) on {where}: "
                  f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
                  f"share {idle:.3f}, {n} device entries; largest: "
                  f"{largest}")
    print(f"[mesh16] (a) {arch}: peak device memory {peak[mesh.size]:.2f} "
          f"GiB on the mesh [1 x 1 {peak[1]:.2f}, phase 13's checks and "
          f"the float32 run included] (torch.cuda.max_memory_allocated); "
          f"the model's own bfloat16 error {own:.3g}")
    del runs, feeds, report
    gc.collect()
    torch.cuda.empty_cache()
    _mixer_card_vs_cpu(arch, cfg, batch, max_len)
    print(f"[mix] {arch}: {time.perf_counter() - t_arch:.1f} s")


def _phase16_train(mesh):
    """(b) One float32 mesh step of each config at full width against the
    1 x 1 step from one state; two mesh steps from one state bitwise."""
    import dataclasses
    import gc

    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state

    dev = torch.device("cuda")
    for arch in MIXER_ARCHS:
        t0 = time.perf_counter()
        base = get_config(arch)
        cut = dict(_MIX_TRAIN_CUT[arch])
        cfg = dataclasses.replace(base, compute_dtype="float32", **cut)
        model = build_model(cfg, device=dev)
        opt = adamw(warmup_cosine(3e-4, warmup_steps=1,
                                  total_steps=TRAIN_STEPS))
        batch = TokenPipeline(cfg, batch=TRAIN_B, seq_len=TRAIN_T,
                              seed=0).batch_at(0)

        def fresh():
            return init_state(model, opt,
                              torch.Generator(device=dev).manual_seed(0))

        # every state compared on the card, leaf by leaf
        with _Float32Run(cfg):
            st = fresh()
            n_par = sum(x.numel() for x in _tree.leaves(st.params))
            p0 = [x.clone() for x in _tree.leaves(st.params)]
            del st
            m_one, s1, ms1, _ = _phase15_step(model, opt, None, batch, fresh,
                                              1)
            p_one, mu_one = _tree.leaves(s1.params), _tree.leaves(s1.opt.mu)
            del s1
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mm, sm, _, _ = _phase15_step(model, opt, mesh, batch, fresh, 1)
            first = list(_logical_leaves(sm.params))
            mu_rel = _moment_rel(_logical_leaves(sm.opt.mu), mu_one)
            del sm, mu_one
            gc.collect()
            torch.cuda.empty_cache()
            mm2, sm, ms_b, _ = _phase15_step(model, opt, mesh, batch, fresh,
                                             1)
            same = mm[0] == mm2[0] and all(
                torch.equal(x, y) for x, y in zip(
                    _logical_leaves(sm.params), first, strict=True))
            del sm
            peak_m = torch.cuda.max_memory_allocated() / 2**30
        ma, ms_b = mm[0], ms_b[0]
        upd = _update_rel_card(p0, first, p_one)
        held = arch not in _UPDATE_REPORTED
        mu_bound = TOL_TRAIN_GRAD if held else TOL_MOMENT_XLSTM
        l_rel = abs(ma["loss"] - m_one[0]["loss"]) / abs(m_one[0]["loss"])
        n_rel = abs(ma["grad_norm"] - m_one[0]["grad_norm"]) \
            / abs(m_one[0]["grad_norm"])
        depth = (f"{cfg.encoder.num_layers} + {cfg.num_layers} layers"
                 if cfg.family == "audio" else f"{cfg.num_layers} layers")
        print(f"[mesh16] (b) {arch} ({depth}, {n_par:,} parameters, "
              f"float32, batch {TRAIN_B} x {TRAIN_T}): one step on {mesh} "
              f"against 1 x 1: loss {ma['loss']:.7f} / "
              f"{m_one[0]['loss']:.7f} (relative {l_rel:.3g}), grad_norm "
              f"relative {n_rel:.3g} (bound {MESH_TOL_TRAIN:g}); first "
              f"moments {mu_rel:.3g} of each leaf's largest (bound "
              f"{mu_bound:g}); update criterion {upd:.3g} "
              f"({f'bound {TOL_TRAIN_UPDATE:g}' if held else 'reported'});"
              f" two mesh steps from one state bitwise {same}; step "
              f"{ms_b:.2f} ms on "
              f"the mesh [1 x 1 {ms1[0]:.2f}] (CUDA events, first step "
              f"each); peak {peak_m:.2f} GiB on the mesh; "
              f"{time.perf_counter() - t0:.1f} s")
        _check(same, f"(b) {arch}: two mesh steps from one state differ")
        _check(l_rel <= MESH_TOL_TRAIN and n_rel <= MESH_TOL_TRAIN
               and mu_rel <= mu_bound
               and (upd <= TOL_TRAIN_UPDATE or not held),
               f"(b) {arch}: loss {l_rel}, grad_norm {n_rel}, moments "
               f"{mu_rel}, update {upd}")
        del first, p0, p_one
        gc.collect()
        torch.cuda.empty_cache()


def _phase16_pods():
    """(c) xlstm-125m on a (2, 1, 2) pod mesh with grad compression."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              compute_dtype="float32")
    model = build_model(cfg, device=dev)
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=TRAIN_STEPS))
    batch = TokenPipeline(cfg, batch=TRAIN_B, seq_len=TRAIN_T,
                          seed=0).batch_at(0)
    mesh = _lm_mesh((2, 1, 2), ("pod", "data", "model"))

    def fresh():
        return init_state(model, opt,
                          torch.Generator(device=dev).manual_seed(0),
                          grad_compression=True)

    p0 = _host_leaves(fresh().params)
    mu1 = []
    m1, s1, _, _ = _phase15_step(
        model, opt, None, batch, fresh, 2,
        check=lambda st: mu1.append(_host_leaves(st.opt.mu)))
    p1 = _host_leaves(s1.params)
    del s1
    checked, mum = [], []

    def replicas_equal(state):
        ok = all(torch.equal(leaf.blocks[(0, *c)], leaf.blocks[(1, *c)])
                 for leaf in _tree.leaves((state.params, state.opt.mu,
                                           state.opt.nu, state.comp.residual))
                 for c in np.ndindex(leaf.blocks.shape[1:]))
        checked.append(ok)
        _check(ok, f"(c) pod replicas differ after step {len(checked)}")
        mum.append(_host_leaves(state.opt.mu))

    mm, sm, ms, _ = _phase15_step(model, opt, mesh, batch, fresh, 2,
                                  check=replicas_equal)
    pm = _host_leaves(sm.params)
    del sm
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(mm, m1)]
    upd = _update_rel(p0, pm, p1)
    mu_rel = _moment_rel(mum[0], mu1[0])
    print(f"[mesh16] (c) xlstm-125m, float32, grad compression on {mesh}: "
          f"pod replicas bitwise equal after each of {len(checked)} steps; "
          f"losses {[round(m['loss'], 6) for m in mm]} vs 1 x 1 "
          f"{[round(m['loss'], 6) for m in m1]} (relative {max(rel):.3g}, "
          f"bound {MESH_TOL_TRAIN:g}); first moments after step 1 "
          f"{mu_rel:.3g} of each leaf's largest (bound {TOL_MOMENT_INT8:g});"
          f" update criterion after 2 steps {upd:.3g} (reported, as in "
          f"(b)); step {ms[1]:.2f} ms (CUDA events)")
    _check(max(rel) <= MESH_TOL_TRAIN and mu_rel <= TOL_MOMENT_INT8,
           f"(c) pods vs 1 x 1: loss {rel}, moments {mu_rel}")


def _phase16(card):
    """16. The mixers on the mesh (module docstring). Returns the kernels'
    launch counts over the phase, read around it."""
    import gc

    import torch

    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.reset_launches()
    mesh = _lm_mesh(MESH_SHAPE)
    print(f"[mesh16] phase 16 on {mesh}: {mesh.size} logical shards of one "
          f"card; {card}")
    parts = [(f"(a) {a}", lambda a=a: _phase16_serve_arch(a, mesh, card))
             for a in MIXER_ARCHS]
    parts += [("(b)", lambda: _phase16_train(mesh)), ("(c)", _phase16_pods)]
    for what, part in parts:
        t0 = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[mesh16] {what}: {time.perf_counter() - t0:.1f} s")
    launches = dict(_build.launches)
    print(f"[mesh16] (d) kernel launches over phase 16: "
          f"{launches or 'none'} (the mixers, on 1 x 1 and on the mesh, run "
          f"no hand-written kernel)")
    _check(sum(launches.values()) == 0, "phase 16 launched a WMD kernel")
    print(f"[mesh16] phase 16: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _wmd_phases():
    """Phases 1-11 and 5 (the Sinkhorn-WMD service and its kernels).
    Returns (the kernel entries, the card's nvidia-smi line); every tensor
    of these phases is released when it returns."""
    import numpy as np
    import torch
    import repro_torch  # noqa: F401  (precision pins)
    from repro_torch.configs.sinkhorn_wmd import config
    from repro_torch.core import sparse_sinkhorn as ss
    from repro_torch.core.convergence import sinkhorn_wmd_converged
    from repro_torch.core.distributed import pad_query
    from repro_torch.core.sinkhorn import select_query, sinkhorn_wmd_dense
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.core import rwmd as rwmd_core
    from repro_torch.core.cascade import min_cost_vectors
    from repro_torch.kernels import (_build, cdist, costs, kexp, lcrwmd, ops,
                                     sddmm_spmm)
    from repro_torch.kernels import rwmd as krwmd
    from repro_torch.serving import WMDService

    dev = torch.device("cuda")

    # -- 1. the card ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall, per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for name, log in _build.ptxas_log.items():
        for ln in _ptxas_summary(log):
            print(f"[ptxas {name}] {ln}")
    tiles = {e: sp for e, sp in _spills(_build.ptxas_log.get("kexp", ""))
             .items() if "cost_rows_kernel" in e}
    _check(all(sum(sp) == 0 for sp in tiles.values()),
           f"a cost-row tile instance spills: {tiles}")
    print(f"[ptxas kexp] {len(tiles)} cost_rows_kernel instances, none "
          f"spills" if tiles else "[ptxas kexp] not built in this run")
    print("[occupancy] " + ", ".join(
        f"{k}: {b} blocks/SM, {sm} B dynamic shared a block"
        for k, (b, sm) in kexp.occupancy().items()))

    # -- 3. the main path -------------------------------------------------------
    cfg = config("paper_5k")
    t0 = time.perf_counter()
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=1, seed=0)
    stream = zipf_query_stream(vocab_size=cfg.vocab_size, query_words=19,
                               seed=1)
    batch1 = [next(stream) for _ in range(16)]
    batch2 = [next(stream) for _ in range(16)]
    print(f"[data] paper_5k corpus: V {cfg.vocab_size}, w {cfg.embed_dim}, "
          f"N {data.ell.num_docs}, nnz_max {data.ell.nnz_max}, nnz "
          f"{data.ell.nnz}; {time.perf_counter() - t0:.1f} s on the host")
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                     cache_capacity=1024)
    _check(svc.device.type == "cuda" and svc.impl == "kernel"
           and svc.kexp_impl == "kernel", "service defaults changed")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tiles0 = dict(sddmm_spmm.tile_launches)
    t0 = time.perf_counter()
    d1 = svc.query_batch(batch1)
    t1 = time.perf_counter()
    stats1 = dict(svc.last_batch_stats)
    d2 = svc.query_batch(batch2)
    t2 = time.perf_counter()
    stats2 = dict(svc.last_batch_stats)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    chunks = sum(math.ceil(s["misses"] / svc.cache_rows_bucket)
                 for s in (stats1, stats2))
    want = {"sddmm_spmm_type1_batch": 2 * cfg.max_iter,
            "sddmm_spmm_type2_batch": 2, "cdist_kexp_rows": chunks,
            "k_vocab_major": 4}
    print(f"[main] launches {launches}, expected {want}")
    _check(launches == want, f"launch counts {launches} != {want}")
    _check(all(v > 0 for v in launches.values()), "a kernel never launched")
    # Q 16 at v_r 32: every #3 on the query-group tile
    tiles3 = {t: n - tiles0.get(t, 0)
              for t, n in sddmm_spmm.tile_launches.items()
              if n != tiles0.get(t, 0)}
    _check(tiles3 == {"group": 2 * cfg.max_iter},
           f"#3 launches of the two batches by tile {tiles3}, expected "
           f"{{'group': {2 * cfg.max_iter}}}")
    fused3 = [s["fused_launches"] for s in (stats1, stats2)]
    _check(fused3 == [cfg.max_iter + 1] * 2,
           f"fused launches a batch {fused3}, expected {cfg.max_iter + 1}")
    for i, (s, dt) in enumerate(((stats1, t1 - t0), (stats2, t2 - t1))):
        print(f"[main] batch {i + 1}: Q=16 in {dt * 1e3:.1f} ms "
              f"({16 / dt:.1f} queries/s); precompute_s "
              f"{s['precompute_s']:.4f}, solve_s {s['solve_s']:.4f}, "
              f"unique {s['unique']}, misses {s['misses']}, hit_rate "
              f"{s['hit_rate']:.3f}")
    print(f"[main] peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    _counted_wmd(
        "phase 3 query_batch, batch 2", lambda: svc.query_batch(batch2),
        {"sddmm_spmm_type1_batch": cfg.max_iter,
         "sddmm_spmm_type2_batch": 1, "k_vocab_major": 2})

    # -- 4. correctness of the output ----------------------------------------
    for d in (d1, d2):
        _check(d.shape == (16, cfg.num_docs) and np.isfinite(d).all()
               and (d > 0).all(), "distances not finite and positive")
    same_rows = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                           cache_capacity=1024, impl="fused")
    plain = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                       cache_capacity=1024, impl="fused", kexp_impl="jnp")
    plain_d = []
    for i, (d, batch) in enumerate(((d1, batch1), (d2, batch2))):
        b = same_rows.query_batch(batch)
        print(f"[check] batch {i + 1}, kernels vs plain engine (impl fused) "
              f"on the same K rows: max rel "
              f"{float((np.abs(d - b) / b).max()):.3g}, held to rtol 2e-3 "
              f"atol 1e-5")
        np.testing.assert_allclose(d, b, **TOL_ENGINE)
        plain_d.append(plain.query_batch(batch))
        _compare(f"batch {i + 1}, kernel route vs all-plain route (impl "
                 f"fused, kexp_impl jnp)", d, plain_d[-1],
                 _shares_word(batch, data.ell))
    again = svc.query_batch(batch1)
    off = svc.query_batch(batch1, use_cache=False)
    _check(np.array_equal(again, d1) and np.array_equal(off, d1),
           "cache on / hits / use_cache=False not bitwise equal")
    print("[check] cache hits == first call == use_cache=False: bitwise")
    legacy = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                        cache_capacity=0)
    d_leg = legacy.query_batch(batch1)
    _check(legacy.last_batch_stats["route"] == "legacy_fused",
           "legacy route not taken")
    _compare("legacy route (in-solve matmul precompute) vs stripes route",
             d_leg, d1, _shares_word(batch1, data.ell))
    docs = 64
    c = torch.zeros((cfg.vocab_size + 1, docs), device=dev)
    cols = torch.from_numpy(data.ell.cols[:docs]).long().to(dev)
    vals = torch.from_numpy(data.ell.vals[:docs]).to(dev)
    c[cols, torch.arange(docs, device=dev)[:, None].expand_as(cols)] = vals
    c = c[:cfg.vocab_size]
    vecs_d = svc._vecs_d
    dense = np.stack([sinkhorn_wmd_dense(
        *(torch.from_numpy(x).to(dev) for x in select_query(batch1[i])), c,
        vecs_d, cfg.lamb, cfg.max_iter).cpu().numpy() for i in range(3)])
    _compare(f"dense oracle on {docs} docs x 3 queries", d1[:3, :docs],
             dense, _shares_word(batch1[:3], data.ell)[:, :docs])
    del same_rows, legacy, c, vals

    # -- 6. the pruned path ----------------------------------------------------
    k_top = 10
    svc6 = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                      cache_capacity=1024, mcache_capacity=1024)
    _check(svc6.device.type == "cuda" and svc6.bound_impl == "kernel"
           and svc6.lc_impl == "kernel" and svc6.impl == "kernel"
           and svc6.kexp_impl == "kernel" and svc6.prune_chunk == 64,
           "pruned-path service defaults changed")
    torch.cuda.reset_peak_memory_stats()
    calls = (("batch 1, per_query", batch1, "per_query"),
             ("batch 2, per_query", batch2, "per_query"),
             ("batch 1, union", batch1, "union"))
    runs = []
    _build.reset_launches()
    for what, batch, rerank in calls:
        m_miss0 = svc6.mcache_stats.miss_rows
        t0 = time.perf_counter()
        out = svc6.top_k_batch(batch, k_top, prune=True, rerank=rerank)
        dt = time.perf_counter() - t0
        runs.append((what, out, dt, dict(svc6.last_prune_stats),
                     svc6.mcache_stats.miss_rows - m_miss0))
    launches6 = dict(_build.launches)
    peak6 = torch.cuda.max_memory_allocated()
    rb = svc6.cache_rows_bucket
    programs = sum(r[3]["rerank_programs"] for r in runs)
    # two vocab-major copies (K, K.*M) per stripe set: a query's on the
    # per-query rerank, the batch's on the union rerank
    stripe_sets = sum(len(batch) if rerank == "per_query" else 1
                      for _, batch, rerank in calls)
    want6 = {"sddmm_spmm_type1_batch": cfg.max_iter * programs,
             "sddmm_spmm_type2_batch": programs,
             "k_vocab_major": 2 * stripe_sets,
             "lc_rwmd_bound_batch": len(calls),
             "rwmd_bound_batch": len(calls),
             "cdist": sum(math.ceil(r[4] / rb) for r in runs),
             "cdist_kexp_rows": sum(math.ceil(m / rb) for r in runs
                                    for m in r[3]["kcache_misses"])}
    want6 = {k: v for k, v in want6.items() if v}
    print(f"[pruned] launches {launches6}, expected {want6}")
    _check(launches6 == want6, f"pruned-path launch counts {launches6} != "
           f"{want6}")
    for name in ("cdist", "rwmd_bound_batch", "lc_rwmd_bound_batch",
                 "sddmm_spmm_type1_batch", "sddmm_spmm_type2_batch",
                 "k_vocab_major"):
        _check(launches6.get(name, 0) > 0, f"{name} never launched on the "
               f"pruned path")
    for what, (idx, dist), dt, ps, m_miss in runs:
        print(f"[pruned] {what}: Q=16, k={k_top} in {dt * 1e3:.1f} ms "
              f"({16 / dt:.1f} queries/s); bound_s {ps['bound_s']:.4f}, "
              f"rerank_s {ps['rerank_s']:.4f}; solves_avoided "
              f"{ps['solves_avoided']:.4f}, exact_solves "
              f"{ps['exact_solves']}, rerank_programs "
              f"{ps['rerank_programs']}; M misses {m_miss}, K misses "
              f"{sum(ps['kcache_misses'])}")
        for t in ps["tiers"]:
            print(f"[pruned]   tier {t['tier']}: {t['seconds'] * 1e3:.2f} "
                  f"ms, survivors {t['survivors']}, cascade survivors "
                  f"{t['cascade_survivors']} (avoided "
                  f"{t['cascade_solves_avoided']:.4f})")
    print(f"[pruned] peak device memory {peak6 / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated, phase 6)")
    _counted_wmd("phase 6 pruned per_query top_k_batch, batch 2",
                 lambda: svc6.top_k_batch(batch2, k_top, prune=True))

    # -- 7. correctness of the pruned path -------------------------------------
    (idx_p1, d_p1), (idx_p2, d_p2), (idx_u1, d_u1) = (r[1] for r in runs)
    for idx, dist in ((idx_p1, d_p1), (idx_p2, d_p2)):
        _check(idx.shape == (16, k_top) and np.isfinite(dist).all()
               and (dist > 0).all(), "pruned top-k not finite and positive")
    idx_s1, d_s1 = svc6.top_k_scan_batch(batch1, k_top)
    _check(np.array_equal(idx_s1, idx_p1) and np.array_equal(d_s1, d_p1)
           and np.array_equal(idx_u1, idx_p1) and np.array_equal(d_u1, d_p1),
           "scan / pruned / union not bitwise equal")
    print(f"[check] batch 1: top_k_scan_batch == pruned == union, bitwise "
          f"(scan: {svc6.last_prune_stats['rerank_programs']} programs)")
    for field, value in (("tier0", False), ("lc_impl", None)):
        saved = getattr(svc6, field)
        setattr(svc6, field, value)
        try:
            idx_t, d_t = svc6.top_k_batch(batch1, k_top, prune=True)
            avoided = svc6.last_prune_stats["solves_avoided"]
        finally:
            setattr(svc6, field, saved)
        _check(np.array_equal(idx_t, idx_p1) and np.array_equal(d_t, d_p1),
               f"{field}={value} changed the pruned answer")
        print(f"[check] {field}={value}: same bits (solves_avoided "
              f"{avoided:.4f})")
    for i, (d, idx, dist) in enumerate(((d1, idx_p1, d_p1),
                                        (d2, idx_p2, d_p2))):
        _check(np.array_equal(idx, WMDService._top_k(d, k_top))
               and np.array_equal(dist, np.take_along_axis(d, idx, -1)),
               f"batch {i + 1}: pruned top-k is not the top-k of the full "
               f"query_batch rows")
    print("[check] pruned top-k == top-k of phase 3's query_batch rows, "
          "bitwise (ids and distances)")
    plain6 = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                        cache_capacity=1024, mcache_capacity=1024,
                        impl="fused", kexp_impl="jnp", bound_impl="fused",
                        lc_impl="fused")
    for i, (batch, idx, dist, d_full, d_plain) in enumerate(
            ((batch1, idx_p1, d_p1, d1, plain_d[0]),
             (batch2, idx_p2, d_p2, d2, plain_d[1]))):
        idx_q, _ = plain6.top_k_batch(batch, k_top, prune=True)
        _check_plain_topk(f"batch {i + 1}", idx, dist, idx_q, d_full,
                          d_plain, _shares_word(batch, data.ell))
    del plain6
    sel_1, _, mask_1 = svc6._padded_query_batch(batch1)
    m_pad, _ = svc6._mcache.m_stripes_for_batch(sel_1, mask_1)
    cols_e, vals_e = svc6._ell_cols_d, svc6._ell_vals_d
    lb_plain = rwmd_core.rwmd_bound_batch(
        m_pad, cols_e, vals_e, impl="fused",
        docs_chunk=svc6.bound_docs_chunk)[:16].cpu().numpy()
    lb_static = []
    for i, (batch, d) in enumerate(((batch1, d1), (batch2, d2))):
        lb = svc6.query_batch_bounds(batch)
        lb_static.append(lb)
        slack = lb - (d * (1 + 1e-5) + 1e-6)
        print(f"[check] batch {i + 1}: kernel bounds <= kernel distances on "
              f"{lb.size} pairs: max(bound - d(1+1e-5) - 1e-6) = "
              f"{slack.max():.3g}; bound / distance: mean "
              f"{float((lb / d).mean()):.4f}, max {float((lb / d).max()):.4f}")
        _check(bool((slack <= 0).all()), "a bound exceeds its distance")
        if i == 0:
            print(f"[check] kernel bounds vs plain min-SDDMM on the same M "
                  f"stripes: max abs {np.abs(lb - lb_plain).max():.3g}")
            np.testing.assert_allclose(lb, lb_plain, rtol=1e-5, atol=1e-6)
    del m_pad

    # -- where the time goes: the device's busy share of warm calls ----------
    # the trace also counts the vocab-major copies (K's and K.*M's, two per
    # stripe set: the batch's, each query's on the per-query rerank) beside
    # the launches of #3 and #4
    for what, call, copies in (
            ("query_batch, batch 2 (phase 3 path)",
             lambda: svc.query_batch(batch2), 2),
            ("pruned per_query, batch 2", lambda: svc6.top_k_batch(
                batch2, k_top, prune=True), 2 * len(batch2)),
            ("pruned union, batch 2", lambda: svc6.top_k_batch(
                batch2, k_top, prune=True, rerank="union"), 2)):
        _idle_line(what, call, copies, ("#3", "type1_vm_kernel"),
                   ("#4", "type2_vm_kernel"),
                   ("oracle", "type2_query_kernel"))

    # -- 8. the per-query path ------------------------------------------------
    svc8 = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell)
    _check(svc8.device.type == "cuda" and svc8.impl == "kernel"
           and svc8.kexp_impl == "kernel" and svc8.cache_capacity == 0,
           "per-query service defaults changed")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tiles0 = dict(sddmm_spmm.tile_launches)
    top1, times1 = [], []
    for r in batch1:
        t0 = time.perf_counter()
        top1.append(svc8.top_k(r, k_top))
        times1.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    d_seq2 = svc8.query_batch_sequential(batch2)
    t_seq2 = time.perf_counter() - t0
    launches8 = dict(_build.launches)
    peak8 = torch.cuda.max_memory_allocated()
    nq = len(batch1) + len(batch2)
    # two vocab-major copies a query (its K and K.*M stripes) for its 15
    # #1 and its one #2
    want8 = {"cdist_kexp": nq, "k_vocab_major": 2 * nq,
             "sddmm_spmm_type1": cfg.max_iter * nq, "sddmm_spmm_type2": nq}
    print(f"[per-query] launches {launches8}, expected {want8}")
    _check(launches8 == want8, f"per-query launch counts {launches8} != "
           f"{want8}")
    tiles8 = {t: n - tiles0.get(t, 0)
              for t, n in sddmm_spmm.tile_launches.items()}
    _check(tiles8.get("group", 0) == 0
           and tiles8.get("warp", 0) == cfg.max_iter * nq,
           f"per-query #1 launches by tile {tiles8}: all on the warp tile")
    warm = times1[1:]
    print(f"[per-query] top_k(r, {k_top}), batch 1: first query "
          f"{times1[0] * 1e3:.2f} ms; the other {len(warm)}: mean "
          f"{np.mean(warm) * 1e3:.3f} ms, median {np.median(warm) * 1e3:.3f}"
          f" ms, {len(warm) / sum(warm):.1f} queries/s")
    print(f"[per-query] query_batch_sequential, batch 2: Q=16 in "
          f"{t_seq2 * 1e3:.1f} ms ({t_seq2 / 16 * 1e3:.3f} ms a query, "
          f"{16 / t_seq2:.1f} queries/s); peak device memory "
          f"{peak8 / 2**30:.2f} GiB")
    d_seq1 = np.stack([svc8.query(r) for r in batch1])
    _check(np.array_equal(d_seq1, d1) and np.array_equal(d_seq2, d2),
           "query(r) is not bitwise phase 3's query_batch row")
    for i, (idx, dist) in enumerate(top1):
        _check(np.array_equal(idx, WMDService._top_k(d1[i], k_top))
               and np.array_equal(dist, d1[i][idx]),
               f"top_k(r), batch 1 query {i}: not the top-k of its row")
    print("[check] per-query: query(r) == phase 3's query_batch rows, "
          "bitwise, on all 32 queries; top_k(r) == their top-k, bitwise")
    plain8 = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, impl="fused",
                        kexp_impl="jnp")
    d_plain8 = plain8.query_batch_sequential(batch1)
    share1 = _shares_word(batch1, data.ell)
    _compare("batch 1, per-query kernel route vs per-query all-plain route "
             "(impl fused, kexp_impl jnp)", d_seq1, d_plain8, share1)
    _compare(f"per-query kernel route vs dense oracle on {docs} docs x 3 "
             f"queries", d_seq1[:3, :docs], dense, share1[:3, :docs])
    del plain8
    sel0, r0 = (torch.from_numpy(x).to(dev) for x in select_query(batch1[0]))
    cols8, vals8 = svc8._cols_d[0, 0], svc8._vals_d[0, 0]
    conv = sinkhorn_wmd_converged(sel0, r0, cols8, vals8, vecs_d, cfg.lamb,
                                  cfg.max_iter, tol=1e-6)
    fixed = ss.sinkhorn_wmd_sparse(sel0, r0, cols8, vals8, vecs_d, cfg.lamb,
                                   int(conv.n_iter), impl="fused")
    _check(conv.wmd.shape == (cfg.num_docs,)
           and bool(torch.isfinite(conv.wmd).all())
           and torch.equal(conv.wmd, fixed),
           "sinkhorn_wmd_converged is not the fixed loop at its n_iter")
    rel = float(np.max(np.abs(conv.wmd.cpu().numpy() - d_plain8[0])
                       / d_plain8[0]))
    print(f"[check] sinkhorn_wmd_converged, batch 1 query 0, tol 1e-6: "
          f"n_iter {int(conv.n_iter)} of {cfg.max_iter}, delta "
          f"{float(conv.delta):.3g}; bitwise the fixed fused loop at that "
          f"n_iter; max rel vs the all-plain per-query route {rel:.3g}")
    _idle_line("per-query query(r)", lambda: svc8.query(batch2[0]), 2,
               ("#1", "type1_vm_kernel"), ("#2", "type2_vm_kernel"),
               ("oracle", "type2_query_kernel"))
    _counted_wmd("phase 8 query(r), batch 2 query 0",
                 lambda: svc8.query(batch2[0]),
                 {k: v // nq for k, v in want8.items()})
    del svc8

    # -- 9. async serving ------------------------------------------------------
    launches9 = _phase9(cfg, data, (batch1, batch2), (d1, d2), k_top)

    # -- 10. the live corpus ---------------------------------------------------
    launches10, live_dir = _phase10(cfg, data, (batch1, batch2), (d1, d2),
                                    lb_static, svc, svc6, k_top, card)

    # -- 11. multi-device serving on a mesh ---------------------------------
    launches11 = _phase11(cfg, data, (batch1, batch2), (d1, d2),
                          ((idx_p1, d_p1), (idx_p2, d_p2)), (idx_u1, d_u1),
                          lb_static, svc, live_dir.name, k_top, card)
    live_dir.cleanup()

    # -- 5. the kernels at the main path's shapes ------------------------------
    sel_b, r_b, mask_b = svc._padded_query_batch(batch1)
    k_s, km_s, _ = svc._kcache.stripes_for_batch(sel_b, mask_b)
    k_pad, km_pad = k_s[0], km_s[0]
    r = torch.from_numpy(r_b).to(dev)
    cols, vals = svc._cols_d[0, 0], svc._vals_d[0, 0]
    q, v_r, n, nnz = 16, cfg.v_r, cols.shape[0], cols.shape[1]
    x = torch.full((q, v_r, n), 1.0 / v_r, device=dev)
    for _ in range(3):                        # a realistic iterate
        x = ops.sddmm_spmm_type1_batch(k_pad, r, ss.safe_recip(x), cols,
                                       vals)
    u = ss.safe_recip(x)
    live = vals != 0
    nnz_real = int(live.sum())
    uniq = int(torch.unique(cols[live]).numel())
    print(f"[kernels] Q {q}, v_r {v_r}, V+1 {k_pad.shape[-1]}, N {n}, "
          f"nnz_max {nnz}, nonzero slots {nnz_real}, distinct words {uniq}")
    results = []
    # a kernel's launches: the sum over the main paths' runs (each read
    # with the counts set to 0 just before it), and the runs apart
    by_phase = {"3": launches, "6": launches6, "8": launches8,
                "9": launches9, "10": launches10, "11": launches11}

    def record(name, source, replaces, got, want, kernel_fn, plain_fn,
               cost, library_fn=None, plain_reps=3):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = _timed(kernel_fn, 20)
        device_ms = _device_ms(kernel_fn)
        plain_ms = _timed(plain_fn, plain_reps, warmup=1)
        lib_ms = _timed(library_fn, 10) if library_fn else None
        bound_ms, bound_by = _bound(*cost)       # kernels.costs' formula
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(c.get(name, 0) for c in by_phase.values()),
                 "launches_by_phase": {p: c.get(name, 0)
                                       for p, c in by_phase.items()},
                 "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms}
        results.append(entry)
        print(f"[kernels] {name}: {ms:.4f} ms (device {device_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), max abs err {err:.3g}; "
              f"launches {entry['launches_by_phase']}")
        return entry

    src = "src/repro_torch/kernels/csrc/sddmm_spmm.cu"
    # the vocab-major copies (two per stripe set: K's and K.*M's), #3 on
    # K's, #4 on both
    k_vm = sddmm_spmm.k_vocab_major(k_pad)
    k_vm_p = sddmm_spmm.k_vocab_major_plain(k_pad)
    torch.cuda.synchronize()
    _check(torch.equal(k_vm, k_vm_p), "k_vocab_major is not the transpose")
    e_copy = record("k_vocab_major", src,
                    "src/repro/kernels/sddmm_spmm.py:239", [k_vm], [k_vm_p],
                    lambda: sddmm_spmm.k_vocab_major(k_pad),
                    lambda: sddmm_spmm.k_vocab_major_plain(k_pad),
                    cost=costs.vocab_major(q, v_r, k_pad.shape[-1]),
                    library_fn=lambda: k_pad.transpose(1, 2).contiguous(),
                    plain_reps=10)
    del k_vm_p
    x_k = sddmm_spmm.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals)
    x_p = sddmm_spmm.sddmm_spmm_type1_batch_vm_plain(k_vm, r, u, cols, vals)
    x_1 = [sddmm_spmm.sddmm_spmm_type1(k_pad[i], r[i], u[i], cols, vals)
           for i in range(q)]
    torch.cuda.synchronize()
    torch.testing.assert_close(x_k, x_p, **TOL_KERNEL)
    for i in range(q):
        _check(torch.equal(x_k[i], x_1[i]), f"sddmm_spmm_type1_batch (#3) "
               f"is not sddmm_spmm_type1 (#1) on query {i}, bitwise")
    print(f"[kernels] sddmm_spmm_type1_batch (#3) == sddmm_spmm_type1 (#1, "
          f"on each query's own copy) on each of the {q} queries, bitwise")
    e3 = record("sddmm_spmm_type1_batch", src,
                "src/repro/kernels/sddmm_spmm.py:239", [x_k], [x_p],
                lambda: sddmm_spmm.sddmm_spmm_type1_batch_vm(k_vm, r, u,
                                                             cols, vals),
                lambda: sddmm_spmm.sddmm_spmm_type1_batch_vm_plain(
                    k_vm, r, u, cols, vals),
                cost=costs.type1(q, v_r, n, nnz, uniq, nnz_real))
    # the device-ms reading (20 calls in one trace) against #3's traced
    # time a launch in a loop of the main path's max_iter launches
    _, _, busy3, why3, marked3 = _device_busy(
        lambda: [sddmm_spmm.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals)
                 for _ in range(cfg.max_iter)], marks=("type1_vm_kernel",))
    _check(busy3 is not None, f"#3's loop traced no device time ({why3})")
    n3, ms3 = marked3["type1_vm_kernel"]
    _check(n3 > 0, "#3's loop traced no #3")
    rel3 = abs(e3["device_ms"] - ms3 / n3) / (ms3 / n3)
    print(f"[kernels] sddmm_spmm_type1_batch (#3): device ms "
          f"{e3['device_ms']:.4f} (`_device_ms`) against {ms3 / n3:.4f} ms "
          f"a launch traced in a loop of {cfg.max_iter} launches ({n3} in "
          f"the trace): {rel3:.3%} apart (bound {DEVICE_MS_TOL:.0%})")
    _check(rel3 <= DEVICE_MS_TOL,
           f"#3's device ms {e3['device_ms']} is {rel3:.3%} from its traced "
           f"{ms3 / n3} ms a launch ({n3} launches traced)")
    del x_k, x_p, x_1
    km_vm = sddmm_spmm.k_vocab_major(km_pad)
    d_k = sddmm_spmm.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals)
    d_p = sddmm_spmm.sddmm_spmm_type2_batch_vm_plain(k_vm, km_vm, u, cols,
                                                     vals)
    d_2 = [sddmm_spmm.sddmm_spmm_type2(k_pad[i], km_pad[i], u[i], cols, vals)
           for i in range(q)]
    d_o = [sddmm_spmm.sddmm_spmm_type2_naive(k_pad[i], km_pad[i], u[i], cols,
                                             vals) for i in range(q)]
    torch.cuda.synchronize()
    _check(torch.equal(km_vm, km_pad.transpose(1, 2)),
           "k_vocab_major of K.*M is not the transpose")
    torch.testing.assert_close(d_k, d_p, **TOL_KERNEL)
    for i in range(q):
        _check(torch.equal(d_k[i], d_2[i]) and torch.equal(d_k[i], d_o[i]),
               f"sddmm_spmm_type2_batch (#4) is not sddmm_spmm_type2 (#2) "
               f"and the reference-layout oracle on query {i}, bitwise")
    print(f"[kernels] sddmm_spmm_type2_batch (#4) == sddmm_spmm_type2 (#2, "
          f"on each query's own copies) == sddmm_spmm_type2_naive (the "
          f"reference-layout oracle) on each of the {q} queries, bitwise")
    e4 = record("sddmm_spmm_type2_batch", src,
                "src/repro/kernels/sddmm_spmm.py:272", [d_k], [d_p],
                lambda: sddmm_spmm.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u,
                                                             cols, vals),
                lambda: sddmm_spmm.sddmm_spmm_type2_batch_vm_plain(
                    k_vm, km_vm, u, cols, vals),
                cost=costs.type2(q, v_r, n, nnz, uniq, nnz_real))
    # ... and at the per-query rerank's (1, 64) block: query 0's stripes and
    # its 64 nearest docs, the block its rerank solves first (a doc's bits
    # do not depend on its block)
    blk = torch.from_numpy(np.argsort(d1[0], kind="stable")[:64]).to(dev)
    cols_r, vals_r = cols[blk].contiguous(), vals[blk].contiguous()
    u_r = u[:1, :, blk].contiguous()
    k_vm1, km_vm1 = k_vm[:1], km_vm[:1]
    d_r = sddmm_spmm.sddmm_spmm_type2_batch_vm(k_vm1, km_vm1, u_r, cols_r,
                                               vals_r)
    torch.cuda.synchronize()
    _check(torch.equal(d_r[0], d_k[0, blk]), "#4 on a (1, 64) block is not "
           "its (16, 5000) launch's row, bitwise")
    live_r = vals_r != 0

    def rerank_call():
        return sddmm_spmm.sddmm_spmm_type2_batch_vm(k_vm1, km_vm1, u_r,
                                                    cols_r, vals_r)

    e4["rerank_ms"] = _timed(rerank_call, 50)
    e4["rerank_device_ms"] = _device_ms(rerank_call)
    e4["rerank_bound_ms"] = _bound(*costs.type2(
        1, v_r, 64, nnz, int(torch.unique(cols_r[live_r]).numel()),
        int(live_r.sum())))[0]
    print(f"[kernels] sddmm_spmm_type2_batch at the rerank's (1, 64) block: "
          f"{e4['rerank_ms']:.4f} ms (device {e4['rerank_device_ms']:.4f}), "
          f"bound {e4['rerank_bound_ms']:.5f} ms; bitwise the (16, 5000) "
          f"launch's row")
    dev_pair = _device_ms(lambda: (sddmm_spmm.k_vocab_major(k_pad),
                                   sddmm_spmm.k_vocab_major(km_pad)))
    print(f"[kernels] a batch's Sinkhorn solve: {cfg.max_iter} x #3 + #4 + "
          f"the two copies = "
          f"{cfg.max_iter * e3['ms'] + e4['ms'] + 2 * e_copy['ms']:.4f} ms "
          f"(events; device "
          f"{cfg.max_iter * e3['device_ms'] + e4['device_ms'] + dev_pair:.4f}"
          f" ms, the pair of copies {dev_pair:.4f})")
    # the kernels reading the iterate (the Sinkhorn loops' route), at this
    # shape and at a 65,536-doc slice of the prod_5m corpus
    e3["fused_device_ms"] = _fused_iterate_check(
        "paper_5k", k_vm, km_vm, r, cols, vals, x)
    cols_s, vals_s = _prod_slice(dev)
    x_s = torch.full((q, v_r, cols_s.shape[0]), 1.0 / v_r, device=dev)
    for _ in range(3):                        # a realistic iterate
        x_s = sddmm_spmm.sddmm_spmm_type1_batch_vm(k_vm, r, x_s, cols_s,
                                                   vals_s, from_x=True)
    e3["fused_device_ms_prod_slice"] = _fused_iterate_check(
        f"prod_5m's {cols_s.shape[0]:,}-doc slice", k_vm, km_vm, r,
        cols_s, vals_s, x_s)
    del cols_s, vals_s, x_s
    del d_k, d_p, d_2, d_o, d_r, k_s, km_s, x, u, k_vm, km_vm, k_vm1, km_vm1
    # the per-query kernels (#5, #1, #2) at batch 1 query 0's shapes: its
    # v_r = 32 stripe (pad rows masked) and a realistic iterate
    sel_p, r_p, mask_p = pad_query(*select_query(batch1[0]), cfg.v_r)
    a1 = vecs_d[torch.from_numpy(sel_p.astype(np.int64)).to(dev)]
    m1, w, v = a1.shape[0], cfg.embed_dim, cfg.vocab_size
    k5, km5 = kexp.cdist_kexp(a1, vecs_d, lamb=cfg.lamb)
    k5p, km5p = kexp.cdist_kexp_plain(a1, vecs_d, lamb=cfg.lamb)
    k6, km6 = kexp.cdist_kexp_rows(a1, vecs_d, lamb=cfg.lamb)
    k5n, km5n = kexp.cost_rows_naive(a1, vecs_d, epilogue="kexp",
                                     lamb=cfg.lamb)
    torch.cuda.synchronize()
    _check(torch.equal(k5, k6) and torch.equal(km5, km6),
           "cdist_kexp (#5) rows are not cdist_kexp_rows (#6) rows")
    _check(torch.equal(k5, k5n) and torch.equal(km5, km5n),
           "cdist_kexp (#5) is not cost_rows_naive, bitwise")
    print(f"[kernels] cdist_kexp (#5) == cost_rows_naive, bitwise; sha256 "
          f"of K, K.*M at batch 1 query 0: {_sha(k5, km5)}")
    del k5n, km5n
    near5 = (km5p / k5p) < 1.0
    _check(bool(((k5 - k5p).abs()[near5] <= 5e-2).all()),
           "cdist_kexp: K near the diagonal off by more than 5e-2")
    torch.testing.assert_close(k5[~near5], k5p[~near5], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(km5[~near5], km5p[~near5], rtol=1e-3,
                               atol=0.0)
    print(f"[kernels] cdist_kexp: rows == cdist_kexp_rows rows, bitwise; "
          f"{int(near5.sum())} near-diagonal entries (abs 5e-2), the rest "
          f"rtol 1e-3")
    record("cdist_kexp", "src/repro_torch/kernels/csrc/kexp.cu",
           "src/repro/kernels/kexp.py:58", [k5, km5], [k5p, km5p],
           lambda: kexp.cdist_kexp(a1, vecs_d, lamb=cfg.lamb),
           lambda: kexp.cdist_kexp_plain(a1, vecs_d, lamb=cfg.lamb),
           cost=costs.cost_rows(m1, v, w, 2),
           library_fn=lambda: torch.cdist(a1, vecs_d), plain_reps=10)
    mask_t = torch.from_numpy(mask_p).to(dev)[:, None]
    k1, km1 = ss.pad_k(k5 * mask_t), ss.pad_k(km5 * mask_t)
    r1 = torch.from_numpy(r_p).to(dev)
    del k5, km5, k5p, km5p, k6, km6
    x1 = torch.full((v_r, n), 1.0 / v_r, device=dev)
    for _ in range(3):                        # a realistic iterate
        x1 = ops.sddmm_spmm_type1(k1, r1, ss.safe_recip(x1), cols, vals)
    u1 = ss.safe_recip(x1)
    # #1 on the query's vocab-major copy (one a query)
    k1_vm = sddmm_spmm.k_vocab_major(k1[None])[0]
    x_k = sddmm_spmm.sddmm_spmm_type1_vm(k1_vm, r1, u1, cols, vals)
    x_p = sddmm_spmm.sddmm_spmm_type1_vm_plain(k1_vm, r1, u1, cols, vals)
    x_b = sddmm_spmm.sddmm_spmm_type1_batch_vm(k1_vm[None], r1[None],
                                               u1[None], cols, vals)[0]
    x_c = sddmm_spmm.sddmm_spmm_type1(k1, r1, u1, cols, vals)
    torch.cuda.synchronize()
    _check(torch.equal(x_k, x_b) and torch.equal(x_k, x_c),
           "sddmm_spmm_type1 (#1) is not sddmm_spmm_type1_batch (#3) at "
           "Q = 1, bitwise")
    torch.testing.assert_close(x_k, x_p, **TOL_KERNEL)
    e1 = record("sddmm_spmm_type1", src,
                "src/repro/kernels/sddmm_spmm.py:126", [x_k], [x_p],
                lambda: sddmm_spmm.sddmm_spmm_type1_vm(k1_vm, r1, u1, cols,
                                                       vals),
                lambda: sddmm_spmm.sddmm_spmm_type1_vm_plain(k1_vm, r1, u1,
                                                             cols, vals),
                cost=costs.type1(1, v_r, n, nnz, uniq, nnz_real))
    # ... with its copy (the reference-layout entry: copy + #1 in one
    # call), the copy alone, and #1 at docs_blk 4, 8, 16
    e1["with_copy_ms"] = _timed(
        lambda: sddmm_spmm.sddmm_spmm_type1(k1, r1, u1, cols, vals), 20)
    e1["copy_ms"] = _timed(lambda: sddmm_spmm.k_vocab_major(k1[None]), 20)
    e1["copy_device_ms"] = _device_ms(
        lambda: sddmm_spmm.k_vocab_major(k1[None]))
    e1["docs_blk"] = {}
    for b in (4, 8, 16):
        def call(b=b):
            return sddmm_spmm.sddmm_spmm_type1_vm(k1_vm, r1, u1, cols, vals,
                                                  docs_blk=b)
        e1["docs_blk"][b] = (_timed(call, 50), _device_ms(call))
    print(f"[kernels] sddmm_spmm_type1 (#1) with its copy "
          f"{e1['with_copy_ms']:.4f} ms; the copy (one query's stripe) "
          f"{e1['copy_ms']:.4f} ms (device {e1['copy_device_ms']:.4f}); "
          f"docs_blk (events ms, device ms): "
          + ", ".join(f"{b}: {t:.4f}, {d:.4f}"
                      for b, (t, d) in e1["docs_blk"].items()))
    # #2 on the query's vocab-major copies (K's and K.*M's, one pair a
    # query): bitwise the reference-layout oracle and #4 at Q = 1
    km1_vm = sddmm_spmm.k_vocab_major(km1[None])[0]
    d_k = sddmm_spmm.sddmm_spmm_type2_vm(k1_vm, km1_vm, u1, cols, vals)
    d_p = sddmm_spmm.sddmm_spmm_type2_vm_plain(k1_vm, km1_vm, u1, cols, vals)
    d_b = sddmm_spmm.sddmm_spmm_type2_batch_vm(k1_vm[None], km1_vm[None],
                                               u1[None], cols, vals)[0]
    d_o = sddmm_spmm.sddmm_spmm_type2_naive(k1, km1, u1, cols, vals)
    d_c = sddmm_spmm.sddmm_spmm_type2(k1, km1, u1, cols, vals)
    torch.cuda.synchronize()
    _check(torch.equal(km1_vm, km1.T), "k_vocab_major of one query's K.*M "
           "is not its transpose")
    _check(torch.equal(d_k, d_b), "sddmm_spmm_type2 (#2) is not "
           "sddmm_spmm_type2_batch (#4) at Q = 1, bitwise")
    _check(torch.equal(d_k, d_o) and torch.equal(d_c, d_k),
           "sddmm_spmm_type2 (#2) is not the reference-layout oracle "
           "sddmm_spmm_type2_naive, bitwise")
    torch.testing.assert_close(d_k, d_p, **TOL_KERNEL)
    print(f"[kernels] sddmm_spmm_type2 (#2, vocab-major copies) == "
          f"sddmm_spmm_type2_naive (reference layout) == "
          f"sddmm_spmm_type2_batch (#4) at Q = 1, bitwise; sha256 of wmd at "
          f"batch 1 query 0: {_sha(d_k)}")
    e2 = record("sddmm_spmm_type2", src,
                "src/repro/kernels/sddmm_spmm.py:154", [d_k], [d_p],
                lambda: sddmm_spmm.sddmm_spmm_type2_vm(k1_vm, km1_vm, u1,
                                                       cols, vals),
                lambda: sddmm_spmm.sddmm_spmm_type2_vm_plain(
                    k1_vm, km1_vm, u1, cols, vals),
                cost=costs.type2(1, v_r, n, nnz, uniq, nnz_real))
    e2["sha256"] = _sha(d_k)
    # ... with its copies (the reference-layout entry: both copies + #2 in
    # one call), the K.*M copy alone, the oracle, and #2 at docs_blk 4, 8,
    # 16
    e2["with_copy_ms"] = _timed(
        lambda: sddmm_spmm.sddmm_spmm_type2(k1, km1, u1, cols, vals), 20)
    e2["with_copy_device_ms"] = _device_ms(
        lambda: sddmm_spmm.sddmm_spmm_type2(k1, km1, u1, cols, vals))
    e2["km_copy_device_ms"] = _device_ms(
        lambda: sddmm_spmm.k_vocab_major(km1[None]))
    e2["oracle_device_ms"] = _device_ms(
        lambda: sddmm_spmm.sddmm_spmm_type2_naive(k1, km1, u1, cols, vals))
    e2["docs_blk"] = {}
    for b in (4, 8, 16):
        def call(b=b):
            return sddmm_spmm.sddmm_spmm_type2_vm(k1_vm, km1_vm, u1, cols,
                                                  vals, docs_blk=b)
        e2["docs_blk"][b] = (_timed(call, 50), _device_ms(call))
    print(f"[kernels] sddmm_spmm_type2 (#2) with its two copies "
          f"{e2['with_copy_ms']:.4f} ms (device "
          f"{e2['with_copy_device_ms']:.4f}); the K.*M copy device "
          f"{e2['km_copy_device_ms']:.4f} ms; the oracle device "
          f"{e2['oracle_device_ms']:.4f} ms; docs_blk (events ms, device "
          f"ms): " + ", ".join(f"{b}: {t:.4f}, {d:.4f}"
                               for b, (t, d) in e2["docs_blk"].items()))
    solve_q = (cfg.max_iter * e1["device_ms"] + e2["device_ms"]
               + e1["copy_device_ms"] + e2["km_copy_device_ms"])
    print(f"[kernels] a query's Sinkhorn solve: {cfg.max_iter} x #1 + #2 + "
          f"two copies = {solve_q:.4f} ms of device time")
    del km1_vm, d_o, d_c
    del k1, km1, k1_vm, x1, u1, x_k, x_p, x_b, x_c, d_k, d_p, d_b
    m = 128
    ids = torch.from_numpy(np.unique(sel_b)[:m].astype(np.int64)).to(dev)
    a = vecs_d[ids].contiguous()
    k_k, km_k = kexp.cdist_kexp_rows(a, vecs_d, lamb=cfg.lamb)
    k_p, km_p = kexp.cdist_kexp_rows_plain(a, vecs_d, lamb=cfg.lamb)
    k_n, km_n = kexp.cost_rows_naive(a, vecs_d, epilogue="kexp",
                                     lamb=cfg.lamb)
    torch.cuda.synchronize()
    _check(torch.equal(k_k, k_n) and torch.equal(km_k, km_n),
           "cdist_kexp_rows (#6) is not cost_rows_naive, bitwise")
    own = (torch.arange(m, device=dev), ids)
    _check(bool((k_k[own] == 1).all() and (km_k[own] == 0).all()),
           "cdist_kexp_rows: a row's own word is not exactly K = 1, M = 0")
    print(f"[kernels] cdist_kexp_rows (#6) == cost_rows_naive, bitwise; own "
          f"words K = 1, K.*M = 0 exactly; sha256 of K, K.*M at phase 5's "
          f"{m} rows: {_sha(k_k, km_k)}")
    del k_n, km_n
    # a row against its own word: |a|^2 + |b|^2 - 2ab cancels (|a|^2 ~ 500
    # at w = 300); the plain spelling keeps round-off there (M(i, i) up to
    # ~2.5e-2 instead of 0), the kernel cancels exactly (see kexp.cu), so K
    # there is held to an absolute 5e-2; off the diagonal only the
    # reassociated dot products differ
    near = (km_p / k_p) < 1.0
    _check(bool(((k_k - k_p).abs()[near] <= 5e-2).all()),
           "cdist_kexp_rows: K near the diagonal off by more than 5e-2")
    torch.testing.assert_close(k_k[~near], k_p[~near], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(km_k[~near], km_p[~near], rtol=1e-3,
                               atol=0.0)
    print(f"[kernels] cdist_kexp_rows: {int(near.sum())} near-diagonal "
          f"entries (abs 5e-2), the rest rtol 1e-3; largest M there: "
          f"kernel {float((km_k / k_k)[near].max()):.3g}, plain "
          f"{float((km_p / k_p)[near].max()):.3g}")
    record("cdist_kexp_rows", "src/repro_torch/kernels/csrc/kexp.cu",
           "src/repro/kernels/kexp.py:93", [k_k, km_k], [k_p, km_p],
           lambda: kexp.cdist_kexp_rows(a, vecs_d, lamb=cfg.lamb),
           lambda: kexp.cdist_kexp_rows_plain(a, vecs_d, lamb=cfg.lamb),
           cost=costs.cost_rows(m, v, w, 2),
           library_fn=lambda: torch.cdist(a, vecs_d), plain_reps=10)

    # cdist (#7): the M rows of the bound tiers, one 128-row miss chunk
    m_k = cdist.cdist(a, vecs_d)
    m_p = cdist.cdist_plain(a, vecs_d)
    (m_n,) = kexp.cost_rows_naive(a, vecs_d, epilogue="dist")
    (d2_n,) = kexp.cost_rows_naive(a, vecs_d, epilogue="dist_squared")
    d2_k = cdist.cdist(a, vecs_d, squared=True)
    torch.cuda.synchronize()
    _check(torch.equal(m_k, m_n) and torch.equal(d2_k, d2_n),
           "cdist (#7) is not cost_rows_naive, bitwise")
    print("[kernels] cdist (#7) == cost_rows_naive, bitwise (M and M^2)")
    del m_n, d2_n, d2_k
    live = k_k > 0
    _check(torch.equal(km_k[live], (k_k * m_k)[live]),
           "K*M of the kexp kernel is not K * M of the cdist kernel")
    _check(bool((m_k[torch.arange(m, device=dev), ids] == 0).all()),
           "cdist: a row's own word is not exactly 0")
    near_m = m_p < 1.0
    _check(bool(((m_k - m_p).abs()[near_m] <= 5e-2).all()),
           "cdist: M near the diagonal off by more than 5e-2")
    torch.testing.assert_close(m_k[~near_m], m_p[~near_m], rtol=1e-4,
                               atol=1e-5)
    print(f"[kernels] cdist: K*M(kexp) == K(kexp) * M(cdist) bitwise on "
          f"{int(live.sum())} entries; own words exactly 0; "
          f"{int(near_m.sum())} near-diagonal entries (abs 5e-2, largest "
          f"plain M there {float(m_p[near_m].max()):.3g}), the rest rtol "
          f"1e-4, atol 1e-5")
    record("cdist", "src/repro_torch/kernels/csrc/kexp.cu",
           "src/repro/kernels/cdist.py:41", [m_k], [m_p],
           lambda: cdist.cdist(a, vecs_d), lambda: cdist.cdist_plain(a, vecs_d),
           cost=costs.cost_rows(m, v, w, 1),
           library_fn=lambda: torch.cdist(a, vecs_d), plain_reps=10)
    del k_k, km_k, k_p, km_p, m_k, m_p
    # rwmd_bound_batch (#8) at the tier-2 shape: Q = 16, v_r = 32, the 256
    # docs of batch 1's subset (the cascade's own choice, recomputed from
    # its tier-0 and tier-1 bounds): the gather route
    sel_b, r_b, mask_b = svc6._padded_query_batch(batch1)
    m_pad, _ = svc6._mcache.m_stripes_for_batch(sel_b, mask_b)
    _, tiers = svc6._cascade_bounds(sel_b, r_b, mask_b)
    key = np.maximum(tiers[0]["bounds"], tiers[1]["bounds"]).min(axis=0)
    subset = np.sort(np.argsort(key, kind="stable")[:4 * svc6.prune_chunk])
    sub_t = torch.from_numpy(subset).to(dev)
    cols_s = cols_e[sub_t].contiguous()
    vals_s = vals_e[sub_t].contiguous()
    vp1 = m_pad.shape[-1]
    live_s = vals_s != 0
    nnz_s = int(live_s.sum())
    uniq_s = int(torch.unique(cols_s[live_s]).numel())
    route_s = krwmd.rwmd_route(*cols_s.shape, vp1)
    _check(route_s == "gather", f"tier 2 takes the {route_s} route")
    lb_k = ops.rwmd_bound_batch(m_pad, cols_s, vals_s)
    lb_p = rwmd_core.rwmd_bound_batch(m_pad, cols_s, vals_s, impl="fused")
    lb_s = krwmd.rwmd_bound_batch(m_pad, cols_s, vals_s)
    lb_sd = krwmd.rwmd_bound_batch_route(m_pad, cols_s, vals_s, "dense")
    torch.cuda.synchronize()
    _check(np.array_equal(lb_k.cpu().numpy(),
                          tiers[1]["bounds"][:16][:, subset]),
           "tier 2 (#8) differs from tier 1 (#9) on the subset")
    _check(torch.equal(lb_s, lb_sd), "#8's gather and dense routes differ "
           "on the tier-2 subset")
    torch.testing.assert_close(lb_k, lb_p, rtol=1e-5, atol=1e-6)
    e8 = record("rwmd_bound_batch", "src/repro_torch/kernels/csrc/rwmd.cu",
                "src/repro/kernels/rwmd.py:62", [lb_k], [lb_p],
                lambda: krwmd.rwmd_bound_batch(m_pad, cols_s, vals_s),
                lambda: krwmd.rwmd_bound_batch_plain(m_pad, cols_s, vals_s),
                cost=costs.rwmd(q, v_r, *cols_s.shape, uniq_s, nnz_s),
                plain_reps=10)

    def sector_floor(live_slots):
        """ms to move the Q v_r 32-byte sectors a live slot's column costs
        in the reference layout, at the HBM rate"""
        return q * v_r * live_slots * 32 / HBM_BW * 1e3

    e8["bound_route"] = route_s
    e8["sector_floor_ms"] = sector_floor(nnz_s)
    e8["sha256"] = _sha(lb_s)
    e8["dense_device_ms"] = _device_ms(lambda: krwmd.rwmd_bound_batch_route(
        m_pad, cols_s, vals_s, "dense"))
    print(f"[kernels] rwmd_bound_batch at tier 2 ({len(subset)} docs, "
          f"{nnz_s} live slots): route {route_s}, device "
          f"{e8['device_ms']:.4f} ms (the dense route "
          f"{e8['dense_device_ms']:.4f}); sector floor "
          f"{e8['sector_floor_ms']:.4f} ms; both routes bitwise equal; "
          f"sha256 {e8['sha256']}")
    # ... and at the bounds tier's shape, all N docs of the original ELL
    # (printed, not in the JSON line): the dense route, both routes timed;
    # the plain version runs chunked by bound_docs_chunk
    bdc = svc6.bound_docs_chunk
    n_e, nnz_e = cols_e.shape
    live_e = vals_e != 0
    nnz_real_e = int(live_e.sum())
    uniq_e = int(torch.unique(cols_e[live_e]).numel())
    route_e = krwmd.rwmd_route(n_e, nnz_e, vp1)
    _check(route_e == "dense", f"the bounds tier takes the {route_e} route")
    lb_full = krwmd.rwmd_bound_batch(m_pad, cols_e, vals_e)
    lb_full_g = krwmd.rwmd_bound_batch_route(m_pad, cols_e, vals_e, "gather")
    lb_full_p = rwmd_core.rwmd_bound_batch(m_pad, cols_e, vals_e,
                                           impl="fused", docs_chunk=bdc)
    minm_k = krwmd.column_min(m_pad)
    minm_t = torch.amin(m_pad, dim=1)
    torch.cuda.synchronize()
    _check(torch.equal(lb_full, lb_full_g), "#8's dense and gather routes "
           "differ at all N")
    _check(torch.equal(minm_k, minm_t), "column_min_kernel is not "
           "torch.amin(m_pad, dim=1), bitwise")
    torch.testing.assert_close(ops._finite(lb_full), lb_full_p, rtol=1e-5,
                               atol=1e-6)
    del minm_k, minm_t

    def full_call(route):
        return lambda: krwmd.rwmd_bound_batch_route(m_pad, cols_e, vals_e,
                                                    route)

    full = {r: (_timed(full_call(r), 10), _device_ms(full_call(r), 10))
            for r in ("dense", "gather")}
    cmin_dev = _device_ms(lambda: krwmd.column_min(m_pad))
    amin_dev = _device_ms(lambda: torch.amin(m_pad, dim=1))
    full_plain_ms = _timed(lambda: rwmd_core.rwmd_bound_batch(
        m_pad, cols_e, vals_e, impl="fused", docs_chunk=bdc), 3, warmup=1)
    full_bound, full_by = _bound(*costs.rwmd(q, v_r, n_e, nnz_e, uniq_e,
                                             nnz_real_e))
    dense_floor = _bound(4 * (q * v_r * vp1 + 2 * vp1 * q
                              + 2 * n_e * nnz_e + q * n_e), 0)[0]
    print(f"[kernels] rwmd_bound_batch at all N = {n_e} (query_batch_bounds, "
          f"{nnz_real_e} live slots): route {route_e}; dense "
          f"{full['dense'][0]:.4f} ms (device {full['dense'][1]:.4f}), "
          f"gather {full['gather'][0]:.4f} ms (device "
          f"{full['gather'][1]:.4f}); column_min_kernel device "
          f"{cmin_dev:.4f} ms vs torch.amin(m_pad, dim=1) {amin_dev:.4f}; "
          f"plain (chunked {bdc}) {full_plain_ms:.4f} ms; bound "
          f"{full_bound:.4f} ms ({full_by}), the dense route's floor "
          f"{dense_floor:.4f} ms, sector floor "
          f"{sector_floor(nnz_real_e):.4f} ms; both routes bitwise equal, "
          f"minm == torch.amin bitwise; sha256 {_sha(lb_full)}; max abs err "
          f"{float((ops._finite(lb_full) - lb_full_p).abs().max()):.3g}")
    # lc_rwmd_bound_batch (#9): tier 1 over all N, with the blocks the
    # cascade launches (sized from Q); must equal #8 bitwise, as must a
    # launch walking bound_docs_chunk docs a block
    minm = min_cost_vectors(m_pad)
    _check(minm.T.is_contiguous(), "min_cost_vectors is not vocab-major")
    lc_k = lcrwmd.lc_rwmd_bound_batch(minm, cols_e, vals_e)
    lc_b = lcrwmd.lc_rwmd_bound_batch(minm, cols_e, vals_e, docs_blk=bdc)
    lc_p = lcrwmd.lc_rwmd_bound_batch_plain(minm, cols_e, vals_e)
    torch.cuda.synchronize()
    _check(torch.equal(lc_k, lb_full) and torch.equal(lc_b, lb_full),
           "lc_rwmd_bound_batch (#9) is not bitwise equal to "
           "rwmd_bound_batch (#8)")
    print("[kernels] lc_rwmd_bound_batch == rwmd_bound_batch, bitwise, on "
          f"all {q} x {n_e} pairs")
    torch.testing.assert_close(lc_k, lc_p, rtol=1e-5, atol=1e-6)
    # the library yardstick: the same function as one sparse product, the
    # corpus as a CSR (N, V+1) matrix of its nonzero slots
    csr = torch.sparse_csr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   torch.cumsum(live_e.sum(dim=1), 0)]),
        cols_e[live_e].long(), vals_e[live_e], size=(n_e, v + 1))
    minm_t = minm.T.contiguous()
    lib = torch.sparse.mm(csr, minm_t).T
    torch.cuda.synchronize()
    torch.testing.assert_close(lib, lc_p, rtol=1e-5, atol=1e-6)
    record("lc_rwmd_bound_batch", "src/repro_torch/kernels/csrc/rwmd.cu",
           "src/repro/kernels/lcrwmd.py:60", [lc_k], [lc_p],
           lambda: lcrwmd.lc_rwmd_bound_batch(minm, cols_e, vals_e),
           lambda: lcrwmd.lc_rwmd_bound_batch_plain(minm, cols_e, vals_e),
           cost=costs.lc_rwmd(q, n_e, nnz_e, uniq_e, nnz_real_e),
           library_fn=lambda: torch.sparse.mm(csr, minm_t), plain_reps=10)
    lc = results[-1]
    dev_lc = _device_ms(lambda: lcrwmd.lc_rwmd_bound_batch(minm, cols_e,
                                                           vals_e))
    dev_lib = _device_ms(lambda: torch.sparse.mm(csr, minm_t))
    # a row-major minm costs the wrapper a vocab-major copy
    minm_rm = minm.contiguous()
    dev_rm = _device_ms(lambda: lcrwmd.lc_rwmd_bound_batch(minm_rm, cols_e,
                                                           vals_e))
    ms_rm = _timed(lambda: lcrwmd.lc_rwmd_bound_batch(minm_rm, cols_e,
                                                      vals_e), 20)
    print(f"[kernels] lc_rwmd_bound_batch vs torch.sparse.mm, each on its "
          f"layout made outside (minm vocab-major, as min_cost_vectors "
          f"makes it; minm.T): CUDA events {lc['ms']:.4f} vs "
          f"{lc['library_ms']:.4f} ms ({lc['library_ms'] / lc['ms']:.2f}x); "
          f"device time {dev_lc:.4f} vs {dev_lib:.4f} ms "
          f"({dev_lib / dev_lc:.2f}x); on a row-major minm (the copy in the "
          f"call) {ms_rm:.4f} ms events, {dev_rm:.4f} ms device")

    return results, card


# -- 17. the launch tools: the dry run and the roofline -------------------------

# the cells phase 17 counts on the 16 x 16 production mesh, in the order
# they are dropped from the end should the phase outgrow its time
PHASE17_CELLS = (("sinkhorn-wmd", "paper_5k"), ("sinkhorn-wmd", "prod_5m"),
                 ("sinkhorn-wmd", "prod_5m_opt"),
                 ("deepseek-moe-16b", "decode_32k"), ("olmo-1b", "train_4k"))
PHASE17_TIMEOUT_S = 600


def _phase17_start():
    """17. `python -m repro_torch.launch.dryrun` on pod16x16 for each of
    PHASE17_CELLS, one process a cell, all started together (meta tensors
    on the host's CPU, nothing on the card), each writing to a temporary
    file: the processes, which `_phase17_finish` waits for after phase 18
    (they count while phases 15, 16 and 18 use the card)."""
    import shutil

    shutil.rmtree(ROOT / "experiments" / "dryrun_torch" / "pod16x16",
                  ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in PHASE17_CELLS:
        out = tempfile.TemporaryFile("w+")
        procs.append((arch, shape, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT, text=True), out))
    return time.perf_counter(), procs


def _phase17_finish(started):
    """17 (cont.). Wait for the dry-run cells of `_phase17_start` (killing
    any left on a failure), then `python -m repro_torch.launch.roofline
    --mesh pod16x16`: every cell must come out ``ok``; each cell's seconds
    and roofline row printed."""
    from repro_torch.launch import roofline

    t0, procs = started
    out_dir = ROOT / "experiments" / "dryrun_torch" / "pod16x16"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        for arch, shape, p, out in procs:
            left = max(1.0, PHASE17_TIMEOUT_S - (time.perf_counter() - t0))
            p.wait(timeout=left)
            out.seek(0)
            for ln in out.read().strip().splitlines()[-3:]:
                print(f"[dryrun] {ln}")
            _check(p.returncode == 0, f"dryrun {arch} x {shape} exited "
                   f"{p.returncode}")
    finally:
        _stop(procs)
    cells_s = time.perf_counter() - t0
    rl = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                         "--mesh", "pod16x16"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
    _check(rl.returncode == 0, f"roofline exited {rl.returncode}: "
           f"{rl.stderr[-2000:]}")
    for arch, shape in PHASE17_CELLS:
        with open(out_dir / f"{arch}__{shape}.json") as f:
            rec = json.load(f)
        _check(rec.get("status") == "ok", f"dryrun {arch} x {shape}: "
               f"{rec.get('status')} {rec.get('error', '')}")
        r = roofline.analyze_cell(rec)
        ma = rec["memory_analysis"]
        print(f"[roofline] {arch} x {shape}: counted in "
              f"{rec['compile_seconds']:.1f} s; flops "
              f"{rec['jaxpr_cost']['flops']:.6g}, bytes "
              f"{rec['jaxpr_cost']['bytes']:.6g}, eager bytes "
              f"{rec['cost_analysis_raw']['bytes accessed']:.6g}, collective "
              f"bytes {rec['collectives']['total']:.6g}; arguments "
              f"{ma['argument_size_in_bytes'] / 2**30:.3f} GiB, temporaries "
              f"{ma['temp_size_in_bytes'] / 2**30:.3f} GiB a position; "
              f"worst-case ops {rec['worst_case_ops']}; {roofline.row(r)}")
    print(rl.stdout.strip().splitlines()[0])
    print(f"[dryrun] phase 17: {len(PHASE17_CELLS)} cells in parallel, "
          f"beside phases 15, 16 and 18, read {cells_s:.1f} s after they "
          f"started (each one's seconds above), roofline in "
          f"{time.perf_counter() - t0 - cells_s:.1f} s")


def _stop(procs):
    """Kill and reap each of ``procs`` ((arch, shape, Popen, its output
    file)) still running, and close the files."""
    for _, _, p, out in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()


class _Lane:
    """Commands run one after the other, each in a new process, on a
    thread beside this process's work: the launchers of phases 14-16 and
    18(c)'s ``--cache-dir`` runs, all beside phase 18's in-process runs.
    A spec is (tag, argument list, the prefix of the output lines kept,
    the strings some kept line must hold); ``{tmp}`` in an argument is
    the lane's temporary directory, which `stop` removes."""

    TIMEOUT_S = 600               # a command's

    def __init__(self, specs):
        import threading

        self.tmp = tempfile.mkdtemp(prefix="chip-smoke-")
        self.specs = [(tag, [a.replace("{tmp}", self.tmp) for a in cmd],
                       prefix, wants) for tag, cmd, prefix, wants in specs]
        self.runs, self.error, self.proc = [], None, None
        self.stopped = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("REPRO_FAILED_ONCE", None)
        try:
            for _, cmd, _, _ in self.specs:
                if self.stopped:
                    return
                t0 = time.perf_counter()
                self.proc = subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
                out, err = self.proc.communicate(timeout=self.TIMEOUT_S)
                self.runs.append((self.proc.returncode, out, err[-2000:],
                                  time.perf_counter() - t0))
        except Exception as e:                # reported by `finish`
            self.error = repr(e)
            if self.proc is not None:
                self.proc.kill()

    def finish(self):
        """Wait for the commands, echo each one's kept lines under its
        tag, and check that each exited 0 with its strings; the lane is
        stopped either way. Returns [(returncode, stdout, stderr's tail,
        seconds)]."""
        self.thread.join(timeout=self.TIMEOUT_S * len(self.specs))
        try:
            _check(not self.thread.is_alive() and self.error is None
                   and len(self.runs) == len(self.specs),
                   f"{self.specs[0][0]}: {self.error or 'not done'}")
            for (tag, cmd, prefix, wants), (rc, out, err, secs) in zip(
                    self.specs, self.runs):
                lines = [ln for ln in out.splitlines()
                         if ln.startswith(prefix)]
                for ln in lines:
                    print(f"{tag} {ln}")
                shown = " ".join(cmd[2:]).replace(self.tmp, "<tmp>")
                _check(rc == 0, f"{tag} {shown} exited {rc}: {err}")
                for want in wants:
                    _check(any(want in ln for ln in lines),
                           f"{tag} {shown}: no line with {want!r}: {lines}")
                print(f"{tag} {shown}: exit 0 in {secs:.1f} s")
        finally:
            self.stop()
        return self.runs

    def stop(self):
        """Kill the command running, run none after it, and remove the
        temporary directory."""
        import shutil

        self.stopped = True
        p = self.proc
        if p is not None and p.poll() is None:
            p.kill()
        self.thread.join(timeout=60)
        shutil.rmtree(self.tmp, ignore_errors=True)


def _launcher_lanes():
    """The launchers of phases 14-16 (each lane's commands one after the
    other, the lanes side by side), started beside phase 18."""
    return [_Lane(specs) for specs in (_phase14_launcher(),
                                       *_phase15_launchers(),
                                       _mixer_launcher())]


# -- 18. the port's examples on the card ------------------------------------

# (c): the service example's modes, each once at the example's defaults
SERVICE_MODES = (("default", []),
                 ("batch-queries", ["--batch-queries"]),
                 ("docs-chunk", ["--docs-chunk", "128", "--batch-queries"]),
                 ("zipf-stream", ["--zipf-stream"]),
                 ("coalesce", ["--coalesce"]),
                 ("top-k-prune", ["--top-k", "8", "--prune"]),
                 ("offline-top-k-prune", ["--offline", "64", "--top-k", "8",
                                          "--prune"]),
                 ("devices-4", ["--devices", "4", "--batch-queries"]))
EXAMPLE_TRAIN_STEPS = 20       # (d): the train example's steps a router
NINE = ("sddmm_spmm_type1", "sddmm_spmm_type2", "sddmm_spmm_type1_batch",
        "sddmm_spmm_type2_batch", "cdist_kexp", "cdist_kexp_rows", "cdist",
        "rwmd_bound_batch", "lc_rwmd_bound_batch")


def _example(name):
    """The port's example ``examples/torch_<name>.py`` as a fresh module
    (its `main(argv)` not run)."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(name, argv, total):
    """``main(argv)`` of the port's example ``name`` in this process, its
    printed lines echoed as ``[ex <name>]``. Returns (its return value,
    the kernels' launches read around the call, the service's
    `query_batch` calls: the batched dispatches); the launches are added
    to ``total``."""
    import io

    import torch

    from repro_torch.kernels import _build
    from repro_torch.serving import WMDService

    buf, calls = io.StringIO(), [0]
    plain_call = WMDService.query_batch

    def counted(self, *a, **kw):
        calls[0] += 1
        return plain_call(self, *a, **kw)

    t0 = time.perf_counter()
    WMDService.query_batch = counted
    _build.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            out = _example(name).main(argv)
        torch.cuda.synchronize()
    finally:
        WMDService.query_batch = plain_call
        for ln in buf.getvalue().splitlines():
            print(f"[ex {name}] {ln}")
    launches = dict(_build.launches)
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n
    print(f"[ex {name}] {' '.join(argv) or '(defaults)'}: "
          f"{time.perf_counter() - t0:.1f} s; launches {launches or 'none'}")
    return out, launches, calls[0]


def _cache_dir_runs():
    """(c)'s ``--offline 16 --cache-dir D`` twice on the lane's new
    temporary directory, each in a new process: its specs for `_Lane`."""
    cmd = [sys.executable, str(ROOT / "examples" /
                               "torch_wmd_query_service.py"),
           "--offline", "16", "--cache-dir", "{tmp}"]
    return [("[examples] (c)", cmd, "warmup:", ("warmup:",))] * 2


def _phase18():
    """18. The port's four examples on the card, each `main(argv)` in this
    process at its defaults (``--device cuda``), the launches read around
    each call (module docstring). Returns the kernels' launches over the
    phase."""
    import math
    import re

    t_phase = time.perf_counter()
    total = {}
    # (c)'s two cache-dir processes run beside the in-process runs
    cached = _Lane(_cache_dir_runs())
    try:
        # -- (a) quickstart: a warm and a timed sparse solve
        out, got, _ = _run_example("quickstart", [], total)
        want = {"sddmm_spmm_type1": 30, "sddmm_spmm_type2": 2,
                "k_vocab_major": 4}
        _check(out["rel_diff"] <= TOL_ENGINE["rtol"],
               f"(a) quickstart: dense vs sparse {out['rel_diff']}")
        _check(got == want, f"(a) quickstart launches {got} != {want}")
        print(f"[examples] (a) quickstart: max rel diff {out['rel_diff']:.3g}"
              f" (bound {TOL_ENGINE['rtol']:g}); launches {got} == 2 x (15 "
              f"#1, one #2, two copies)")

        # -- (b) doc_retrieval: 3 queries, a 200-iteration solve each
        out, got, _ = _run_example("doc_retrieval", [], total)
        want = {"sddmm_spmm_type1": 600, "sddmm_spmm_type2": 3,
                "k_vocab_major": 6}
        _check(got == want, f"(b) doc_retrieval launches {got} != {want} "
               f"(the converged loop must launch none)")
        _check(all(0 < q["n_iter"] <= 500 for q in out),
               f"(b) converged n_iter {[q['n_iter'] for q in out]}")
        print(f"[examples] (b) doc_retrieval: launches {got} == 3 x (200 "
              f"#1, one #2, two copies); converged in "
              f"{[q['n_iter'] for q in out]} iterations")

        # -- (c) the service, each mode once
        seen = {}
        for mode, argv in SERVICE_MODES:
            out, got, n_disp = _run_example("wmd_query_service", argv,
                                            total)
            svc = out["svc"]
            _check(svc.device.type == "cuda" and svc.impl == "kernel",
                   f"(c) {mode}: the service is not on the card's kernels")
            for k, n in got.items():
                seen[k] = seen.get(k, 0) + n
            if mode == "default":
                q = len(out["top"])
                want = {"cdist_kexp": q, "k_vocab_major": 2 * q,
                        "sddmm_spmm_type1": 15 * q, "sddmm_spmm_type2": q}
                _check(got == want, f"(c) default launches {got} != {want}")
            elif "--batch-queries" in argv or mode in ("zipf-stream",
                                                       "coalesce"):
                # a launch a mesh position and doc chunk (`--docs-chunk`
                # blocks each position's docs)
                blocks = svc.mesh.size * (math.ceil(
                    svc._cols_d[0, 0].shape[0] / svc.docs_chunk)
                    if svc.docs_chunk else 1)
                n1 = got.get("sddmm_spmm_type1_batch", 0)
                n2 = got.get("sddmm_spmm_type2_batch", 0)
                _check(n_disp > 0 and n1 == 15 * n_disp * blocks
                       and n2 == n_disp * blocks,
                       f"(c) {mode}: {n1} #3 and {n2} #4 for {n_disp} "
                       f"dispatches of {blocks} blocks")
                print(f"[examples] (c) {mode}: {n_disp} dispatches of "
                      f"{blocks} block(s) (mesh positions x doc chunks): 15 "
                      f"#3 and one #4 each")
            if mode.endswith("prune"):
                _check(out.get("exact") is True,
                       f"(c) {mode}: not bitwise the exact scan")
        missing = [k for k in NINE + ("k_vocab_major",) if not seen.get(k)]
        _check(not missing, f"(c) the service's modes launched no {missing}")
        print(f"[examples] (c) the service's {len(SERVICE_MODES)} modes "
              f"launched all nine kernels and the copies: {seen}")
        # -- (d) the train example, 20 steps a router, no hand-written kernel
        for router in ("sinkhorn", "topk"):
            with tempfile.TemporaryDirectory() as tmp:
                out, got, _ = _run_example(
                    "train_moe_sinkhorn",
                    ["--steps", str(EXAMPLE_TRAIN_STEPS), "--router", router,
                     "--ckpt-dir", os.path.join(tmp, "ckpt")], total)
            losses = [h["loss"] for h in out["history"]]
            _check(len(losses) == EXAMPLE_TRAIN_STEPS
                   and all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0],
                   f"(d) {router}: losses {losses}")
            _check(not got, f"(d) {router}: the LM launched {got}")
            print(f"[examples] (d) {router}: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f} over {len(losses)} steps, "
                  f"{sum(h['sec'] for h in out['history']):.1f} s of steps; "
                  f"the checkpoint directory removed")
        # -- (c) the two --cache-dir runs, which ran beside the rest
        warmups = []
        for i, (rc, text, err, _) in enumerate(cached.finish()):
            m = re.search(r"warmup: (\d+) shapes, (\d+) compiles .*?(\d+) "
                          r"persisted-cache hits", text)
            _check(rc == 0 and m is not None, f"(c) --cache-dir run {i + 1} "
                   f"exited {rc}: {err}")
            warmups.append((int(m.group(2)), int(m.group(3))))
        _check(warmups[0][0] > 0 and warmups[1][0] == 0
               and warmups[1][1] > 0,
               f"(c) --cache-dir: (compiles, loads) {warmups}; the second "
               f"run must build nothing")
    finally:
        cached.stop()

    print(f"[examples] phase 18: {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


def main() -> int:
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[label] = round(time.perf_counter() - t0, 1)

    results, card = timed("1-11, 5", _wmd_phases)
    launches = {}
    # phases 12, 14, 15 and 16 (each after the last has released its
    # tensors: phase 13's checks run in 16(a)), phase 17's dry-run cells
    # counting on the host's CPU from phase 15 on; then phase 18 on the
    # card beside the launchers of phases 14-16
    started, lanes = None, []
    try:
        for label, fn, args in (("12", _phase12, (card,)),
                                ("14", _phase14, ()), ("15", _phase15, ()),
                                ("16", _phase16, (card,))):
            gc.collect()
            torch.cuda.empty_cache()
            if label == "15":
                t17 = time.perf_counter()
                started = _phase17_start()
            launches[label] = timed(label, fn, *args)
        gc.collect()
        torch.cuda.empty_cache()
        t18 = time.perf_counter()
        lanes = _launcher_lanes()
        launches["18"] = timed("18", _phase18)
        for lane in lanes:
            lane.finish()
        seconds["18 and the launchers of 14-16"] = round(
            time.perf_counter() - t18, 1)
        _phase17_finish(started)
        seconds["17 (beside 15-18)"] = round(time.perf_counter() - t17, 1)
    finally:
        for lane in lanes:
            lane.stop()
        if started is not None:
            _stop(started[1])
    for entry in results:
        for label, counts in launches.items():
            entry["launches_by_phase"][label] = counts.get(entry["name"], 0)
    print(f"[phases] seconds: {seconds}; the script: "
          f"{time.perf_counter() - T_START:.1f} s")

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"[card] after the run: {clocks.stdout.strip()}")
    _check(all(e["route"] == "cuda" for e in results),
           "a kernel entry's route is not cuda")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
