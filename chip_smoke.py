#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check every result.

    python3 chip_smoke.py [--keys 134217728] [--seed 0] [--profile]
                          [--out results.json]

Run from the root of a checkout: it builds the port's CUDA kernels from
``src/repro_torch/csrc`` and then

1. runs the table's build -> query -> retrieve -> inner_join path through the
   public API, with D = 1 shard at N = 2^27 uint32 keys (uniform in [0, N),
   so keys repeat; ``hash_range = N``), then with D = 8 stacked shards at
   N / 8 = 2^24; each run is checked against a numpy oracle (counts, every
   retrieved value multiset, every join pair, ``num_dropped == 0``, exactly
   two exchange calls per retrieve and per join) and reports build keys/s,
   query keys/s and retrieve results/s;
2. runs the update path through the public API, at D = 1 / N = 2^27 and at
   D = 8 / N = 2^24: build the base (values = row ids), insert 4 batches of
   N/32 keys, delete 2^16 base keys, insert a fifth batch that re-inserts
   2^12 of them, upsert 2^16 keys (half present, half new), then at depth 6
   read (query all base keys plus 2^20 absent ones through the sorted table
   and through a ``paper_faithful_probe=True`` table on the same state,
   retrieve, inner_join and join_size of an N/32 batch), ``fold_oldest(3)``
   and read again, ``compact()`` and read again; at D = 8 one more insert of
   a batch skewed onto shard 0's hash range must take the skew guard's
   fallback, and the reads repeat on that mixed-split stack.  Every read is
   held against a numpy oracle of the live multiset, every step against
   ``num_dropped == 0`` and its exchange-call budget;
2b. runs both again with ``TableSchema("uint64", 4)`` (the u64x4 runs,
   fingerprint lane on by default): keys ``raw | raw << 32`` of the same
   ``raw`` draws (as ``benchmarks/bench_widths.py`` makes them), four int32
   value columns drawn from ``--seed`` on the card, the upsert with a TTL
   (pending throughout, so the live multiset is as in 2), and the same
   numpy oracles on the uint64 keys (counts, four-column value multisets,
   join rows), ``num_dropped == 0`` and exchange budgets;
2c. serves the table (the ``serve-table`` phase), at D = 1 / N = 2^27 and
   D = 8 / N = 2^24: a base of N uint32 keys uniform in [0, N) (values =
   row ids, ``tombstone_capacity = 2^15``, ``capacity_slack = 2.0`` for
   reads of 1024-4096 keys at D = 8) behind ``TableServer(write_bucket=
   2^16, policy=CompactionPolicy(max_delta_depth=8, fold_k=2),
   batcher=MicroBatcher(min_bucket=1024))``, warmed on buckets 1024-4096,
   depths 0-8 and two folds ahead (query, retrieve and per-layer
   retrieve), then, through ``AsyncFrontend(linger=0.002,
   flush_keys=4096)``, four readers submit 2,048 requests of 4-256 keys
   (90 % present, 10 % absent) while a fifth thread calls
   ``retrieve_many(per_layer_counts=True)`` on 64 groups of 8 and a writer
   submits 8 inserts of 2^16 keys (each with 512 copies of one key absent
   from the base), a delete and an upsert of 2^12 base keys; the policy
   folds at depth 8 while reads flow.  Gates: every response against a
   numpy oracle at the seqno it reports (counts, value multisets, per-layer
   counts summing to the counts), every future resolved once, zero drops,
   zero AOT misses and no kernel library build or load after ``warm()``,
   two exchange rounds per read execution and none per incremental fold
   (counted on each thread), reads whose kernels ran during the fold and
   none that waited for it (CUDA events), no ``last_error``, no skew
   fallback, one owner and one querier gather launch per retrieve batch
   and no Pallas-interface launch, the registry scraped back from its
   Prometheus text, and ``retrieve_auto`` / ``inner_join_auto`` of the
   hot key from a quarter of its caps equal to the oracle within two
   doublings.  It prints latency p50 / p99 / p999, keys/s, the tracer's
   phases, the fold's pause and the reads during it, warm-up seconds and
   grid entries, device ms and launches per batch at each bucket, peak
   bytes and the phase's seconds, and holds kernels 3-4 against their
   twins on one 4096-key retrieve batch of the final state;
2d. drives the table's users, each phase after the earlier runs' state is
   freed, its data from ``--seed``, every result against a numpy oracle,
   launches and exchange rounds counted on its thread
   (``counting.scoped``), its numbers ending with its seconds and peak
   bytes:
   - ``hashgraph-1``, the single-card API (Alg. 1) at the read run's draw
     (N = 2^27 keys uniform in [0, N), values = row ids, ``table_size =
     N``): ``hashgraph.build``, ``query_count_sorted`` and ``contains`` of
     the N keys plus 2^20 absent ones, ``lookup_first``, ``retrieve`` and
     ``inner_join`` of a 2^22-key batch, ``intersect_join_size`` against a
     graph of 2^22 keys; the counts and value multisets also equal to a
     D = 1 ``DistributedHashTable``'s on the same keys; no exchange round,
     and exactly two launches of kernel 3's Pallas-interface entry
     ``csr_gather`` (the retrieve and the join) and none of the table's
     gather entries; build keys/s, query keys/s, results/s;
   - ``hot-keys``, heavily duplicated keys at D = 8: a base of 2^24 uniform
     keys, one insert of 2^20 keys ``key_of(rank)`` with ranks zipfian over
     2^20 (theta 0.99, then 1.2, each on a fresh table) through
     ``replicate_hot_keys = 4`` at ``capacity_slack = 2.0``, then
     ``fold_oldest(1)`` and ``compact()``: hot keys registered, no skew
     fallback, no drops, counts of every distinct batch key and 2^20 base
     keys against the oracle after each step, 2 x 4 exchange rounds a
     query, a probe query of one kernel 5 launch per layer per replica
     round that never over-counts (its scan stops at ``max_probe``), the
     retrieve of the hot keys equal to the oracle's replica-0 rows; the
     theta-1.2 batch without replication (the control) takes the skew
     guard's fallback, reported; kernel 5's layer entry is held against its
     twin on replica round 1 and kernels 3-4 on the hot keys' retrieve;
   - ``kv-cache``, YCSB A to F through one ``KVCache`` at D = 1 / N = 2^26
     and D = 8 / N = 2^24 (theta 0.99, batches of 2^13 ops, 2^19 ops a
     letter, scans of 16 keys, ``tombstone_capacity = 2^17``, the default
     policy; ``capacity_slack = 2.5`` at D = 8), then a TTL run (2^16
     loaded keys put with ``ttl = 4``, read through ``now + 3``, missing
     from ``now + 4``, ``evict_expired()`` reclaiming at least 2^16 rows):
     every get against a numpy value array by insertion index,
     ``live_count`` after each letter, no drops or skew fallbacks, one
     querier gather launch a get and one owner launch a routing round;
     ops/s, get and put p50 / p99 from the cache's registry histograms,
     folds, evictions and delta depth per letter;
   - ``dedup``, exact dedup of a training stream: 2^20 rows of 128 tokens
     of ``SyntheticCorpus(vocab_size=151_936, dup_rate=0.1)`` drawn on the
     card, ``dedup_mask`` and ``dedup_mask_distributed`` (D = 8,
     ``hash_range = 2^20``) equal to a numpy MurmurHash3's first
     occurrences, then 4 steps of ``ShardedLoader(dedup="distributed",
     batch_size=2^16)`` (kept rows equal to the corpus's, refills in the
     vocab, ``skip_to(2)`` replaying steps 2-3 bit for bit); fingerprint,
     mask and distributed-mask rows/s;
   each phase holds the kernels it ran against their twins on its own
   inputs (``check_kernels``);
2e. runs the table across processes (the ``procs`` phase): the pass of
   ``repro_torch.launch.table_run`` (u32x1; N = 2^26 keys uniform over
   [0, N/2) with EMPTY rows, 2^22 reads; init, query / contains /
   join_size, plan_caps, retrieve with and without per-layer counts,
   inner_join, the auto retries from a quarter of their caps, two inserts
   of N/8, a delete and an upsert with TTL of N/32 replicated keys, the
   sorted and the probe query at depth 3, the clock past the TTL,
   ``fold_oldest(2)``, an insert skewed onto shard 0 that takes the skew
   guard's fallback, reads of the mixed-split stack, ``compact`` and reads)
   stacked at D = 4, then on four ranks of a gloo group on this card
   (``launch.mesh.spawn``; 2^24 keys a rank, each rank launching the
   kernels on its own shard, every exchange staged through host memory),
   then stacked at D = 1 and on one NCCL rank in this process.  Every
   rank's outputs equal its row of the stacked run bit for bit (chunk
   digests; a mismatch prints the first differing index), its scalars, its
   exchange rounds, bytes and launches per entry point equal the stacked
   run's, its sampled query rows equal a numpy oracle (counts, retrieved
   and joined value multisets), nothing is dropped, kernels 1-2 launch in
   the build, 3-4 once a side a retrieve or join and 5 once a layer of the
   depth-3 probe query (4); it prints each rank's wall, rounds, bytes and
   ``agree`` all-reduces per entry point and peak bytes, and rank 0 holds
   kernels 1, 2, 3-4 and 5 against their twins on its own inputs (rows
   ``procs-gloo-4``).  Then, in the same ranks, the table's users:
   ``launch/users_run.py`` (a zipfian hot-key insert of 2^20 at theta 1.2
   with R = 4, its offsets, the sorted and probe queries, fold, compaction
   and the hot keys' retrieve; a ``KVCache`` through YCSB A and F, 2^17
   ops a letter in 2^13-op batches, then 2^14 TTL puts read through their
   expiry and two evictions), every output equal to its row of the stacked
   run at D = 4 (and D = 1) with its rounds and launches per call, the
   probe query one kernel 5 launch a layer a replica round, a get one
   querier launch; and ``launch/serve_run.py``: the serve-table phase's
   server on every rank, warmed alike, rank 0's front end answering 4
   readers x 128 requests of 4-256 keys and 8 retrieve groups while 4
   inserts of 2^16, a background fold, a delete, an upsert with a TTL and
   the clock past it apply; every response equal to the numpy oracle at
   its seqno, 2 exchange rounds a read batch, no grid miss, every follower
   at rank 0's seqno with its read batches, writes and folds, every rank's
   shadow equal to its row of a stacked server replaying rank 0's log;
   rank 0 holds kernels 1, 2, 3-4 and 5 against their twins on its
   hot-key inputs (rows ``procs-users-gloo-4``);
3. serves qwen3-4b at full width (36 layers, d_model 2560, 32 query heads
   over 8 kv heads, vocab 151,936; random bf16 weights drawn on the card
   from ``--seed``) through the public API: ``build_model``, a
   ``ContinuousBatcher`` of 4 slots with 4096-token caches, 8 requests of
   prompts drawn from ``--seed`` in [1000, 3000] tokens, 32 new tokens each,
   run until drained; reports prefill tokens/s, decode tokens/s over the
   steps with every slot live, time to first token per request and peak
   bytes; replays every request through ``forward_train`` with plain
   attention and holds the batcher's logits at every generated position
   within ``LM_LOGIT_TOL`` of the replay's, and each generated token equal
   to the replay's argmax wherever its top-1 beats its top-2 by more than
   twice that;
4. serves xlstm-1.3b at full width (48 layers alternating mLSTM and sLSTM,
   d_model 2048, 4 heads, vocab 50,304; random bf16 weights drawn on the
   card from ``--seed`` by the reference's rule; the qwen3 model is freed
   first) with the qwen3 run's traffic and reports the same metrics; it
   holds the state carried from prefill into decode against a
   teacher-forced pass from each request's own prefill state
   (``XLSTM_LOGIT_TOL``), and again in f32 at full width in a second run of
   2 requests (3e-4); the whole-sequence replay through ``forward_train``
   is reported (the random-weight recurrence amplifies other roundings of
   the prefix over thousands of steps, so no fixed tolerance holds it);
4b. trains qwen3-4b at full width on the card (the ``train`` phase, after
   ``serve-xlstm-f32``): ``python -m repro_torch.launch.train``'s
   ``make_trainer`` with ``--layers 12 --seq 2048 --batch 4 --microbatches
   2 --steps 4 --dedup local --lr 1e-3`` (12 of 36 layers, bf16 compute
   over f32 masters and moments, random weights from ``--seed``, the
   loader's HashGraph dedup); it prints each step's loss, ce, grad norm,
   lr, step ms, tokens/s and peak bytes beside the card's name and power
   limit, and gates the first step's ce against the plain-attention
   model's on the same batch and weights (``TRAIN_CE_TOL``), finite
   metrics, a lower loss of the first batch after the 4 steps, kernel 6
   launched ``2 x 12 x 2 x 4`` times (each forward and its recomputation
   under remat), kernel 6's twin only in the backward and kernel 1 twice a
   batch (the dedup's build and lookup); then the gradients of the
   kernel-backed autograd Functions against the plain path's at the smoke
   configs (qwen3-4b and xlstm-1.3b, f32 and bf16) and at one full-width
   pattern period on 256 tokens (``TRAIN_GRAD_TOL``), each Function's
   gradients equal to its twin's, and a smoke run that crashes at step 4
   and resumes from its step-3 checkpoint to the straight run's final loss
   and weights bit for bit (deterministic algorithms);
5. counts the kernel launches of each run (every count is set to 0 just
   before a run and read just after it) and requires each kernel of the run
   > 0 (the update path runs all five table kernels; the u64x4 runs kernel
   1's two-output entry ``murmur_hash`` at 2 lanes, as many launches as the
   uint32 run of its path made of ``murmur_bucket``, and none of
   ``murmur_bucket``), exactly one launch of
   kernel 5's layer entry per layer per probe query in the update run (12 at
   D = 1, 14 at D = 8) and none of its window entry, exactly one launch of
   kernels 3-4's owner entry per routing round of a retrieve or join and
   one of their querier entry per call (2 and 2 a read run; 6 and 6 in the
   update run at D = 1, 10 and 8 at D = 8, whose mixed-split stack routes
   its two layers separately) and none of their Pallas-interface entries,
   exactly 36 x 8
   launches of kernel 6 (flash attention), one per layer per prefill, in
   the qwen3 serving run, and exactly 24 x (8 + decode steps) launches of
   kernel 7 (the sLSTM recurrence), one per sLSTM layer per prefill and per
   decode step, and none of kernel 6, in the xLSTM run;
6. calls each kernel's wrapper on the inputs each run gives it and holds it
   against its plain PyTorch twin (in the u64x4 runs: kernel 1 at 2 lanes
   with both outputs, kernels 3-4 with 4 value columns, kernel 5 at 2
   lanes): ``torch.equal`` for the table kernels
   (every output is an integer; kernels 3-4's owner and querier entries
   on the retrieve's own inputs for every owner, layer and querier, the
   table sectors the owner entry's picked words touch printed beside its
   bound, their
   Pallas-interface entries on owner 0's interleaved runs and querier 0's
   CSR; kernel 5's two entries on the depth-6
   probe query's base layer, the layer entry on its routed batch, with the
   sectors it touches printed beside its bound), ``FLASH_TOL`` for kernel 6 on request 0's
   layer-0 q, k, v and on small GQA, window, non-causal, decode-offset and
   ragged cases in bf16 and f32, ``SLSTM_TOL`` for kernel 7 on request 0's
   first sLSTM layer (S = 2675) with the model's bf16 r (the cluster
   kernel) and its f32 widening (the cooperative kernel), each in 256-step
   chunks from the kernel's own state (the whole launch equal to its chunks
   bit for bit; the bf16 launch also reported against the twin over all
   steps), on a decode-shaped call from the run's own states and on the JAX
   kernel tests' shapes with f32 and bf16 r; it times
   kernel, plain twin and a library yardstick (``torch.bincount`` for the
   histogram, ``scaled_dot_product_attention`` for kernel 6; none computes
   kernel 7's function) with CUDA events (kernels 3-4's owner and querier
   entries, 5's layer entry, 6 and 7 at their main shapes in 5 groups of
   20 launches: min, median, max)
   beside the least time the card
   could take: the larger of the bytes moved over 3.35 TB/s and the
   operations over the card's rate for them (int32 lanes for the table
   kernels, bf16 tensor cores for kernel 6, f32 units for kernel 7).

6b. trains over a mesh (the ``train-procs`` phase, after ``train``;
   ``launch/train_run.py``, the pass every rank runs): qwen3-4b at its
   published widths, bf16 compute over f32 masters, seq TRAIN_PROCS_SEQ,
   global batch 4 drawn by every rank with the loader's dedup over the
   group's table (kernel 1), depth cut per run (TRAIN_PROCS_LAYERS): (a)
   the GSPMD step, ZeRO-3 + TP on (data, model) = (2, 2), 2 microbatches;
   (b) manual DP with the int8 all-reduce on (data,) = (4,); (c) the GPipe
   pipeline on (stage,) = (4,), 4 microbatches; (a)-(c) in one spawn of
   four gloo ranks on this card; (d) (a)'s configuration on one NCCL rank.
   Each goes first unsharded on this card on the same weights and batches.
   Gates: (a) and (c) step 1's ce within TRAIN_CE_TOL of the unsharded
   run's; (a) every parameter after step 1 within 2 lr_1 of the unsharded
   run's and at most TRAIN_PROCS_FLIP_FRACTION of them beyond lr_1 / 2; (c)
   the grad norm within TRAIN_PROCS_GNORM_TOL; (b) step 1's loss within
   2^-8 and the all-reduce's bytes one a gradient element a hop plus the
   scales; (d) bit for bit; every rank's replicated blocks the same bits
   and its metrics rank 0's; collectives a step as
   ``train_run.design_collectives``; parameter and state bytes as
   ``shard_bytes_per_device``; kernel 6 launched on every attention layer
   a rank runs, forward and recomputation; finite metrics.  Rank 0 holds
   kernel 6 (its 16 of 32 q heads) and kernels 1 and 2 (its rows'
   fingerprints, as the dedup table's build hashes and bins them) against
   their twins (rows ``train-procs-gloo-4``); ``--profile``
   profiles one more step of each run on rank 0 (the card's busy time and
   the host time inside each kind of collective).

7. runs language-model parallelism across processes last (the ``lm-procs``
   phase; ``launch/lm_run.py``, the pass every rank runs), after freeing
   the card: (a) granite-20b (bf16, full width, 13 of its 52 layers) on a
   (data, model) = (1, 4) mesh with ``production_parallel``'s
   defaults (sequence-parallel prefill where the prompt divides by 4, a
   sequence-sharded KV cache of 1,024 positions a rank), 4 requests through
   2 slots of 4,096, 16 new tokens; (b) qwen3-4b (bf16, full width, 4 of
   its 36 layers) on (2, 2) (FSDP gathers over ``data``, a head-sharded
   cache), 4 requests, 8 new tokens; (c) xlstm-1.3b (f32, full width and
   depth) on (1, 4), 2 requests, 8 new tokens; (a)-(c) in one spawn of four
   gloo ranks on this card, every collective staged through host memory;
   (d) qwen3-4b (bf16, full width and depth) on one NCCL rank in this
   process with (a)'s traffic.  Prompts are drawn from ``--seed`` in
   [1000, 3000] tokens, the first rounded down to a multiple of 4, and
   weights by the reference's rule from ``--seed``.  Each run goes first
   unsharded on this card (its logits to host memory, its model freed) and
   the sharded run is fed its tokens.  Gates: every rank's tokens and
   logits the same bits; the logits at every generated position within
   ``LM_PROCS_LOGIT_TOL`` of the unsharded run's ((d): bit for bit) and the
   argmax equal to the unsharded token wherever its top-1 beats its top-2
   by twice that; each rank's parameter bytes equal to
   ``shard_bytes_per_device``; each call's collectives equal to
   ``lm_run.design_collectives``; kernel 6 once per attention layer per
   prefill and kernel 7 once per sLSTM layer per prefill and decode step,
   on each rank.  It prints, per rank and run, prefill tokens/s, TTFT,
   decode step ms, collectives and bytes a call, parameter and peak bytes
   and each request's prefill path, beside the unsharded run's, the
   unsharded run's own plain-attention replay ((a), (b)) and its logits'
   movement under a 1e-7 change of one weight ((c)); rank 0 holds kernel 6
   (granite's 12 query heads over its one kv head) and kernel 7's cluster
   variant (one head, the bf16 serving copy's r) against their twins on
   the inputs its own path gave them (rows ``lm-procs-gloo-4``).

8. runs MoE and the sliding-window ring cache last (the ``moe`` phase):
   (a) serves mixtral-8x22b at its published widths (d_model 6144, 48 q /
   8 kv heads, hd 128, 8 experts of d_ff 16384 top-2, vocab 32768, window
   4096; random bf16 weights from ``--seed``), MOE_LAYERS of its 56 layers,
   4 requests of 3,000 / 4,080 / 5,000 / 6,144 tokens (drawn from
   ``--seed``) through 2 slots of 8,192, 32 new tokens each: every ``swa``
   prefill runs kernel 6 with the window and cuts a 4,096-slot ring, the
   second request's decode crosses the window edge and the last two wrap
   the ring in prefill.  Gates: kernel 6 once a layer a prefill (32); each
   ring's ``kpos`` after prefill and after the last decode step equal to a
   numpy oracle; the batcher's logits at every generated position against
   a teacher-forced pass of prompt + generated tokens through the
   kernel-backed ``forward_train`` (kernel 6 once a layer), and each
   prefill's logits against the plain path's (masked-einsum attention with
   the window), within MOE_LOGIT_TOL where both passes chose the same
   experts (a position whose experts differ must sit at a router tie,
   MOE_TIE; they are counted and printed); kernel 6 at the longest
   request's layer-0 q, k, v with the window against its twin
   (FLASH_TOL), timed beside the twin and SDPA with the window as a
   boolean mask; one MoE layer's routing ids equal to the plain form's and
   its output within MOE_LAYER_TOL of the all-experts form's.  (b) runs
   its forward loss at full width, MOE_EP_LAYERS layers, a global batch of
   4 x 2,048 tokens from ``--seed``, with ``moe_impl="ep"`` on (data,
   model) = (4, 1): stacked on this card (``StackedGroup(4)``), then on four
   gloo ranks of this card (one row each), then dense on this card and on
   one NCCL rank.  Gates: each rank's row CE, loss and ``moe_aux`` bit for
   bit the stacked run's, ``moe_dropped`` equal (printed with its share of
   the routed rows); 2 exchange rounds a MoE layer under ``"moe"``, their
   bytes ``4 x capacity`` token rows of 6144 bf16 plus their ids out and
   the rows back, the loss's collectives as ``design_loss_collectives``
   (none inside the MoE); each rank holding its 2 experts a layer, its
   parameter bytes ``shard_bytes_per_device``; the NCCL rank's loss bit
   for bit the one-card dense run's.  It prints prefill tokens/s, TTFT,
   decode step ms, peak bytes and the phase's seconds, and with
   ``--profile`` a prefill's and a decode step's split by kernel class and
   by the MoE's ranges (routing, the experts).

9. runs the last model families last (the ``archs`` phase), each model
   freed before the next, random bf16 weights by the reference's rules
   from ``--seed``: (a) recurrentgemma-9b at its published widths and
   depth (38 layers: 26 ``rglru`` blocks with the MLP, 12 ``local``
   attention blocks, 16 q heads over one kv head of 256, window 2,048;
   d_model 4096, rnn_width 4096, d_ff 12288, vocab 256,000), 4 requests
   of 1,500 / 2,040 / 3,000 / 6,144 tokens (drawn from ``--seed``) through
   the continuous batcher's 2 slots of 8,192, 32 new tokens each: every
   ``local`` prefill runs kernel 6 at head dim 256 with the window and
   cuts a 2,048-slot ring, the second request's decode crosses the window
   edge and the last two wrap the ring in prefill.  Gates: kernel 6 once a
   ``local`` layer a prefill (12 x 4 = 48) and once a layer a request in
   the teacher-forced passes (48); each ring's ``kpos`` after prefill and
   after the last decode step equal to a numpy oracle; every RG-LRU state
   finite; the batcher's logits at every generated position against a
   teacher-forced pass of prompt + generated tokens through the
   kernel-backed ``forward_train``, and each prefill's logits against the
   plain path's (masked-einsum attention with the window), within
   ``ARCHS_LOGIT_TOL``, each token the pass's argmax where its top-1 beats
   its top-2 by twice the atol; kernel 6 at the longest request's first
   ``local`` layer's q, k, v against its twin (``FLASH_TOL``), timed beside
   the twin and SDPA with the window as a boolean mask.  (b) whisper-base
   at full width and depth (6 + 6 layers, d_model 512, 8 heads of 64,
   vocab 51,865): 4 clips of 1,500 frames (normal from ``--seed``: the
   stub frontend's output), prompts of 32 tokens, one batched prefill into
   448-token caches, 128 greedy decode steps.  Gates: kernel 6 6 + 6 times
   in each prefill (the encoder non-causal, the decoder causal) and in the
   teacher-forced pass; the decode logits against a teacher-forced
   ``forward_train`` of prompt + generated tokens, the prefill logits
   against the plain path's; kernel 6 at the encoder's layer-0 q, k, v (4,
   8, 1500, 64) non-causal against its twin, timed beside SDPA.  (c)
   pixtral-12b at its published widths, 8 of 40 layers: 256 patch
   embeddings (normal from ``--seed``) + 1,000 tokens through ``prefill``
   with ``patch_emb``, then 16 decode steps.  Gates: kernel 6 once a layer
   in each prefill and in the teacher-forced pass with the same prefix, the
   logits against that pass, the prefill logits against the plain path's.
   (b) and (c) warm up at the measured shape and time the median of 3
   prefills.  It prints each part's prefill tokens/s, TTFT,
   decode step ms, peak bytes and seconds beside the card's name and power
   limit, and with ``--profile`` (a)'s prefill and decode step split by
   kernel class and inside the RG-LRU scan's range (``rglru.scan``).

10. runs Griffin and the encoder-decoder over a mesh (the ``archs-procs``
   phase, after ``archs``; ``launch/lm_run.py``): (a) recurrentgemma-9b at
   its published widths, 6 of its 38 layers (two periods of rglru, rglru,
   local), on (data, model) = (1, 4): the RG-LRU on each rank's 1,024 of
   the 4,096 recurrence channels (``uf`` gathered over tp for the gates),
   the local ring of 2,048 split by sequence (512 slots a rank, one kv
   head), archs (a)'s 4 prompts through 2 slots of 8,192, 8 new tokens;
   (b) whisper-base at full width and depth on (1, 4) (2 of its 8 heads a
   rank; its vocab of 51,865 stays whole), 4 clips of 1,500 stub frames
   and 32-token prompts in one batched prefill into caches of 448, 16
   decode steps; (a) and (b) in one spawn of four gloo ranks on this card;
   (c) (a) on one NCCL rank in this process.  Each goes first unsharded on
   this card and the sharded run is fed its tokens.  Gates as ``lm-procs``'
   (``ARCHS_PROCS_LOGIT_TOL``; (c) bit for bit); (a)'s sensitivity of the
   unsharded logits to a 1e-7 change of one norm weight is printed; rank 0
   holds kernel 6 against its twin at its own 4 q heads over the kv head
   (head dim 256, the window of 2,048), whisper's encoder (2 heads,
   non-causal over 1,500 frames) and decoder prefill, timed beside SDPA.
11. trains mixtral-8x22b with expert parallelism through the exchange (the
   ``moe-train`` phase, last): its published widths, 1 of its 56 layers,
   f32 masters, a global batch of 4 x 1,024 tokens from ``--seed`` (one
   row a rank), ``moe_impl="ep"`` on (data, model) = (4, 1), 2 steps,
   the clip set not to bind (``MOE_TRAIN_CLIP``).  First the stacked EP
   step on this card (``make_ep_stacked_train_step``), then four gloo
   ranks of this card, then the dense step on this card and on one NCCL
   rank.  Gates: each rank's owned experts' first moments and parameters
   after step 1 bit for bit the stacked step's, its other blocks' moments
   within ``MOE_TRAIN_REDUCED_TOL`` of each leaf's largest entry; every
   step's loss, ce and aux within 1e-5 of the stacked step's; exchange
   rounds a step as ``train_run.design_rounds`` (forward, backward and
   remat's recomputation: six a MoE layer) and collectives as
   ``design_collectives``; parameter and state bytes as their specs; kernel
   6 twice a step (the forward and its recomputation); the NCCL rank's
   steps bit for bit the one-card dense step's.  It prints per rank the
   step ms, tokens/s, rounds, collectives and bytes, parameter, state and
   peak bytes, and the drops' share of the routed rows; rank 0 holds kernel
   6 against its twin on its own 48 q heads over 8 kv heads at the window
   of 4,096, timed beside SDPA.

12. runs the tooling last (the ``tooling`` phase): the autotuner
   (``repro_torch.kernels.autotune``) sweeps every candidate ``block_rows``
   of kernels 1-5 at 2^20 and 2^24 (the gathers at 1, 2 and 4 value
   columns), each timed with CUDA events (median of 5 after a warm-up) and
   logged beside the card's name and power limit; the cache is saved to its
   version-1 file and loaded back.  Kernels 1-4 are then relaunched on the
   read D = 1 run's own inputs and kernel 5 (both entries) on the update
   D = 1 run's base layer (host copies kept since those runs): each entry
   once through the resolver with the winners loaded (the counts set to 0
   just before; each > 0 after), every candidate's output equal to the
   default geometry's bit for bit, and ``check_kernels``' rows with path
   ``autotune`` (the tuned launch against its twin, timed, beside the bound
   as the earlier rows reckon it, with the default launch's ms and both
   tiles).  Meanwhile two CPU processes run ``repro_torch.launch.dryrun``
   for qwen3-4b and mixtral-8x22b at ``train_4k`` (one microbatch) and
   ``decode_32k`` on the single-pod mesh over a fake group of 256 ranks
   (torch's ``fake`` backend on this machine's torch); each cell must come
   back ``ok`` with finite positive terms, and their roofline rows (the
   H100's constants) are printed.

It prints the seconds each run took, the card's name and power limit, a
``{"kernels": [...]}`` line (one row per kernel and run, ``path`` and
``shards`` naming the run) and, last,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# int32 operations outside the tensor cores: 64 INT32 lanes per SM x 132 SMs
# x 1.98 GHz boost clock (H100 SXM).  Not half the 67 TFLOP/s float32 rate:
# that counts each fused multiply-add as two operations.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# bf16 dense tensor-core rate and f32 rate outside the tensor cores (H100 SXM data sheet).
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
ABSENT_QUERIES = 1 << 20
RETRIEVE_QUERIES = 1 << 22
TOMBSTONE_CAPACITY = 1 << 17
DELETES = 1 << 16
REINSERTS = 1 << 12
UPSERTS = 1 << 16
# The u64x4 runs: value columns, and a tombstone buffer for 2^16 deletes,
# 2^16 upserted keys and their 2^16 TTL entries; the TTL is never reached,
# so those entries stay pending and mask nothing.
WIDE_COLS = 4
WIDE_TOMBSTONE_CAPACITY = 1 << 18
UPSERT_TTL = 1000
# LM serving paths: qwen3-4b, then xlstm-1.3b, at full width, 8 requests
# through 4 slots (qwen3's KV caches of 4096 tokens; xLSTM states do not
# depend on the cache length).
LM_ARCH = "qwen3_4b"
XLSTM_ARCH = "xlstm_1_3b"
LM_REQUESTS, LM_SLOTS, LM_CACHE_LEN, LM_MAX_NEW = 8, 4, 4096, 32
LM_PROMPT_LENS = (1000, 3000)
# Kernel 6 against its twin: the same f32 arithmetic summed in another order
# (2e-5), and in bf16 the output rounded to 8 significant bits, where the two
# f32 sums can land one bf16 step apart (2e-2; |o| < 2).  Relative and absolute.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Kernel 6's small cases (hq, hkv, sq, skv, d, causal, window): GQA 4:1, a
# sliding window, non-causal, decode offsets (sq < skv), ragged lengths.
LM_FLASH_CASES = (
    (8, 2, 256, 256, 128, True, None),
    (4, 2, 300, 300, 128, True, 100),
    (4, 4, 200, 200, 64, False, None),
    (4, 1, 37, 900, 128, True, None),
    (4, 2, 1, 700, 128, True, None),
    (4, 2, 333, 333, 32, True, None),
    (4, 2, 130, 190, 64, False, 17),
    # the edges of the bf16 kernel's 128-row tiles
    (4, 2, 129, 129, 128, True, None),
    (4, 2, 127, 127, 128, True, None),
    (4, 2, 64, 127, 128, True, None),
)
# Kernel 6 at the main shape: groups of launches, timed in turns with its
# plain twin and the SDPA yardstick (min, median and max over the groups).
FLASH_TIMING = {"groups": 5, "launches": 20}
# The batcher's logits (flash prefill, plain decode over the cache) against a
# plain-attention replay of the whole sequence, both in bf16: the two round
# to bf16 at other points (kernel 6 against the einsum, GEMMs of M = 1 and of
# M = thousands) and the steps carry through 36 layers.  One bf16 step of a
# logit near 0.5 is 2^-9 ~ 0.002; the full-width runs on the card measured
# at most 0.0107 over 256 positions, against logits of std 0.114 and
# |max| ~0.6.  The gate is twice that maximum.
LM_LOGIT_TOL = 2e-2
# Kernel 7 against its twin, relative and absolute: the same f32 arithmetic
# with hd-term dot products summed in another order, 2e-5 over the JAX
# kernel tests' shapes and a single (decode) step, as those tests hold the
# Pallas kernel; 1e-4 on the main path's SLSTM_CHUNK-step chunks, each run
# from the kernel's own state.  Over all 2675 steps no fixed tolerance
# holds: the random-weight recurrence turns a 1e-7 change of its input into
# 2.3e-4 in h by the last step, and the whole launch left 279 outputs
# outside 1e-4 on the card; it is reported (``slstm_whole_launch``).
SLSTM_TOL = {"steps": 2e-5, "main": 1e-4}
# The xLSTM's decode logits against the teacher-forced pass from the same
# prefill state (``check_lm_continuation``).  bf16, the serving run: decode
# GEMMs of M = 4 round other partial sums to bf16 than the pass's M = 31,
# through 48 layers, on logits of std ~0.9 (an untied head, 8x qwen3's);
# the full-width runs on the card measured at most 0.1406 over 248
# positions, and the gate is twice that (the rule LM_LOGIT_TOL was set by).
# f32, a second run of 2 requests at full width: 3e-4, the JAX package's own
# f32 decode tolerance (measured 5.8e-6).  The whole-sequence replay through
# ``forward_train`` is reported, not gated, for the xLSTM: its prefix GEMMs
# have another M than the prefill's, and the random-weight recurrence
# amplifies those roundings over thousands of steps (``slstm_whole_launch``).
XLSTM_LOGIT_TOL = {"bfloat16": 0.3, "float32": 3e-4}
SLSTM_CHUNK = 256  # steps per chunk of the main-path comparison
# The JAX kernel tests' shapes (b, h, s, hd), with f32 r (the cooperative
# kernel) and bf16 r (the cluster kernel).
SLSTM_CASES = ((1, 1, 8, 16), (2, 2, 32, 32), (1, 4, 100, 64), (2, 1, 256, 128))
# Kernel 7 at the main shape: groups of launches of its bf16 (cluster) and
# f32 (cooperative) variants, timed in turns (min, median and max over the
# groups); its plain twin takes 0.3-1.1 s a call and is timed over 3 calls.
SLSTM_TIMING = {"groups": 5, "launches": 20}

# Kernel name -> (source in the repo, Pallas function it replaces).
KERNELS = {
    "murmur_bucket": ("src/repro_torch/csrc/murmur.cu", "src/repro/kernels/murmur.py:53"),
    "murmur_hash": ("src/repro_torch/csrc/murmur.cu", "src/repro/kernels/murmur.py:53"),
    "bin_histogram": ("src/repro_torch/csrc/histogram.cu", "src/repro/kernels/histogram.py:41"),
    "csr_gather": ("src/repro_torch/csrc/csr_gather.cu", "src/repro/kernels/bucket_probe.py:161"),
    "csr_gather_batched": (
        "src/repro_torch/csrc/csr_gather.cu",
        "src/repro/kernels/bucket_probe.py:206",
    ),
    "csr_gather_owners": (
        "src/repro_torch/csrc/csr_gather.cu",
        "src/repro/kernels/bucket_probe.py:206",
    ),
    "csr_gather_queriers": (
        "src/repro_torch/csrc/csr_gather.cu",
        "src/repro/kernels/bucket_probe.py:161",
    ),
    "bucket_probe": (
        "src/repro_torch/csrc/bucket_probe.cu",
        "src/repro/kernels/bucket_probe.py:40",
    ),
    "bucket_probe_layer": (
        "src/repro_torch/csrc/bucket_probe.cu",
        "src/repro/kernels/bucket_probe.py:40",
    ),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:126",
    ),
    "slstm_sequence": ("src/repro_torch/csrc/slstm.cu", "src/repro/kernels/slstm.py:93"),
}
# The build -> query -> retrieve path runs kernels 1-4; the update path all
# five table kernels, kernel 5 through its layer entry (one launch per layer
# per probe query; its window entry, the Pallas function's interface, is
# only held against its twin); the qwen3 serving path kernel 6 alone, the
# xLSTM serving path kernel 7 alone.  Kernels 3-4 run on the table's path
# as their owner and querier entries, one launch each per routing round of
# a retrieve or join; their Pallas-interface entries (``csr_gather``,
# ``csr_gather_batched``) are only held against their twin.
READ_PATH_KERNELS = ("murmur_bucket", "bin_histogram", "csr_gather_owners", "csr_gather_queriers")
TABLE_KERNELS = READ_PATH_KERNELS + ("bucket_probe_layer",)
# The u64x4 runs hash 2-lane keys through kernel 1's two-output entry.
WIDE_READ_KERNELS = ("murmur_hash",) + READ_PATH_KERNELS[1:]
WIDE_TABLE_KERNELS = WIDE_READ_KERNELS + ("bucket_probe_layer",)
# murmur_bucket launches of each uint32 run, by (path, shards): the u64x4
# run of the path must make as many launches of murmur_hash.
HASH_LAUNCHES: dict = {}
PALLAS_GATHERS = ("csr_gather", "csr_gather_batched")
# Kernel 5's layer entry at the depth-6 base layer and kernels 3-4's owner
# and querier entries: groups of launches (min, median and max over the
# groups), as kernels 6 and 7 are timed.
PROBE_TIMING = {"groups": 5, "launches": 20}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mean_ms(fn, reps: int, device) -> float:
    """Mean time of ``fn`` over ``reps`` calls after two warm-up calls
    (CUDA events on the card)."""
    import torch

    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn, device):
    """``(result, seconds)`` of one call, synchronised on both sides."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def repeat_walls(fn, device, repeats: int, parts, label: str):
    """Wall ms of ``repeats`` calls of ``fn`` after two warm-up calls, each
    synchronised on both sides (``wall``).  Every call's ``parts(result)``,
    a tuple of tensors, must equal the first call's.  Returns ``(walls,
    first)``."""
    import torch

    walls, first = [], None
    for i in range(2 + repeats):
        out, seconds = wall(fn, device)
        out = parts(out)
        if first is None:
            first = out
        check(all(torch.equal(a, b) for a, b in zip(out, first)),
              f"{label}: repeat {i} differs from the first")
        if i >= 2:
            walls.append(seconds * 1e3)
        del out
    return walls, first


def peak_bytes(fn, device) -> int:
    """Peak device bytes of one call of ``fn`` above those allocated before."""
    import torch

    sync(device)
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    sync(device)
    return torch.cuda.max_memory_allocated(device) - resident


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def keys_on(raw, device, wide: bool):
    """Host ``raw`` keys as the table takes them on ``device``: int32 bits,
    or for the u64x4 runs the ``(N, 2)`` lanes of ``raw | raw << 32`` (both
    lanes ``raw``)."""
    import torch

    k = to_device(raw, device)
    return torch.stack([k, k], -1).contiguous() if wide else k


def value_store(rows: int, seed: int, device):
    """The u64x4 runs' values: ``(rows, 4)`` int32 drawn on ``device`` from
    ``seed``; a table row's values are the store's row of its row id."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (rows, WIDE_COLS), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)


def store_pairs(pairs, store):
    """Oracle ``(query row, row id)`` pairs as ``(query row, value columns)``
    rows of the value store, sorted."""
    import torch

    if store is None:
        return pairs
    ids = torch.from_numpy(pairs[:, 1]).to(store.device)
    return sort_pairs(pairs[:, 0], store[ids].cpu().numpy())


class Oracle:
    """numpy reference of a multiset table: its live ``(key, value)`` rows.

    Keys lie in ``[0, n)`` (a u64x4 run's key ``raw | raw << 32`` is
    indexed by its ``raw``, the uint32 draw the table's lanes were made
    from), so per-key counts come from ``np.bincount``; a query outside
    ``[0, n)`` counts 0.  Pairs are read off a stable sort of only the rows
    whose key is queried.  (A binary search per query over 2^27 sorted keys
    would take minutes on the host.)
    """

    def __init__(self, keys, values, n: int):
        import numpy as np

        self.keys, self.values = keys, values
        self.tally = np.bincount(keys, minlength=n)

    def count(self, queries):
        import numpy as np

        inside = queries < self.tally.shape[0]
        return np.where(inside, self.tally[np.where(inside, queries, 0)], 0)

    def pairs(self, queries):
        """Every ``(query row, value)`` match, sorted."""
        import numpy as np

        wanted = np.zeros(self.tally.shape[0], bool)
        wanted[queries[queries < wanted.shape[0]]] = True
        sel = wanted[self.keys]
        order = np.argsort(self.keys[sel], kind="stable")
        keys, values = self.keys[sel][order], self.values[sel][order]
        cnt = self.count(queries)
        first = np.searchsorted(keys, queries)
        qidx = np.repeat(np.arange(queries.shape[0], dtype=np.int64), cnt)
        pos = np.repeat(first - (np.cumsum(cnt) - cnt), cnt) + np.arange(qidx.shape[0])
        return sort_pairs(qidx, values[pos])


def sort_pairs(qidx, vals):
    """``(query row, value columns...)`` int64 rows, ``vals`` ``(K,)`` or
    ``(K, C)``, in one canonical order, by one argsort of a 64-bit key: the
    query row and the value's 32-bit pattern (C = 1: the exact order), or
    the query row in the high bits and a 64-bit mix of the C patterns in the
    rest (C > 1).  Two sorted arrays hold the same multiset of rows iff
    they are equal, except where two distinct rows of one query share a
    key (a chance of ~2^-40 a pair), which can fail an equal pair of
    multisets but never pass unequal ones."""
    import numpy as np

    rows = np.column_stack([qidx, vals.reshape(qidx.shape[0], -1)]).astype(np.int64)
    q = rows[:, 0].astype(np.uint64)
    words = (rows[:, 1:] & 0xFFFFFFFF).astype(np.uint64)
    if words.shape[1] == 1:
        key = (q << np.uint64(32)) | words[:, 0]
    else:
        qbits = max(1, int(rows[:, 0].max(initial=0)).bit_length())
        h = np.zeros(rows.shape[0], np.uint64)
        for c in range(words.shape[1]):
            h = (h ^ words[:, c]) * np.uint64(0x9E3779B97F4A7C15)
            h ^= h >> np.uint64(29)
        key = (q << np.uint64(64 - qbits)) | (h >> np.uint64(qbits))
    return rows[np.argsort(key)]


def retrieval_pairs(result):
    """``(query row, value columns...)`` of every retrieved value, sorted:
    each shard's CSR sliced as ``retrieval_to_lists`` slices it, without
    making one array a query (4.2e6 of them cost the host tens of seconds
    a read)."""
    import numpy as np

    counts, offsets, values = (t.cpu().numpy() for t in (
        result.counts, result.offsets, result.values))
    d = offsets.shape[0] - counts.shape[0]
    n_local, out_cap = counts.shape[0] // d, values.shape[0] // d
    off2 = offsets.reshape(d, n_local + 1)
    flat = np.concatenate([values[s * out_cap: s * out_cap + off2[s, -1]] for s in range(d)])
    lens = np.diff(off2, axis=1).reshape(-1)
    qidx = np.repeat(np.arange(d * n_local, dtype=np.int64), lens)
    return sort_pairs(qidx, flat.astype(np.int64))


def join_pairs(join):
    """``(query row, value columns...)`` of every join pair, sorted."""
    from repro_torch import join_to_pairs

    got = join_to_pairs(join).astype("int64")
    return sort_pairs(got[:, 0], got[:, 1:])


def check_hash_launches(launches: dict, path: str, shards: int, wide: bool, label: str) -> None:
    """Kernel 1 in a u64x4 run: the two-output entry, as many launches as
    the uint32 run of the path made of the one-word entry, none of that."""
    if not wide:
        HASH_LAUNCHES[(path, shards)] = launches.get("murmur_bucket", 0)
        return
    check(launches.get("murmur_bucket", 0) == 0, f"{label}: a 2-lane run launched murmur_bucket")
    want = HASH_LAUNCHES.get((path, shards))
    if want is not None:
        check(launches.get("murmur_hash", 0) == want,
              f"{label}: {launches.get('murmur_hash', 0)} launches of murmur_hash, want {want} "
              f"(the uint32 run's murmur_bucket launches)")


def run_path(n_shards: int, n_keys: int, seed: int, device, log, wide: bool = False) -> dict:
    """One build -> query -> retrieve -> inner_join run through the public
    API; ``wide``: the u64x4 run (``TableSchema("uint64", 4)``, keys ``raw |
    raw << 32`` of the same draws, values from the value store)."""
    import numpy as np
    import torch

    from repro_torch import DistributedHashTable, TableSchema
    from repro_torch.core import exchange
    from repro_torch.kernels import build

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n_keys, dtype=np.uint32)
    absent = rng.integers(n_keys, 2**32 - 1, size=ABSENT_QUERIES, dtype=np.uint64).astype(np.uint32)
    queries = np.concatenate([keys, absent])
    batch = rng.integers(0, n_keys, size=RETRIEVE_QUERIES, dtype=np.uint32)
    keys_dev = keys_on(keys, device, wide)
    queries_dev = keys_on(queries, device, wide)
    batch_dev = keys_on(batch, device, wide)
    path = "read-u64x4" if wide else "read"
    store = value_store(n_keys, seed, device) if wide else None
    schema = TableSchema("uint64", WIDE_COLS) if wide else None
    table = DistributedHashTable(num_shards=n_shards, hash_range=n_keys, device=device,
                                 schema=schema)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    exchange.CALLS.clear()
    state, build_s = wall(lambda: table.init(keys_dev, store), device)
    calls_build = dict(exchange.CALLS)
    exchange.CALLS.clear()
    counts, query_s = wall(lambda: table.query(state, queries_dev), device)
    calls_query = dict(exchange.CALLS)
    exchange.CALLS.clear()
    retrieval, retrieve_s = wall(lambda: table.retrieve(state, batch_dev), device)
    calls_retrieve = dict(exchange.CALLS)
    exchange.CALLS.clear()
    join = table.inner_join(state, batch_dev)
    calls_join = dict(exchange.CALLS)
    join_size = int(table.join_size(state, batch_dev))
    sync(device)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    oracle = Oracle(keys, np.arange(n_keys, dtype=np.int64), n_keys)
    want_counts = oracle.count(queries)
    label = f"{path} D={n_shards}"
    check(int(state.num_dropped) == 0, f"{label}: build dropped {int(state.num_dropped)} rows")
    check(np.array_equal(counts.cpu().numpy(), want_counts), f"{label}: query counts differ")
    want_pairs = store_pairs(oracle.pairs(batch), store)
    total = want_pairs.shape[0]
    check(int(retrieval.num_dropped) == 0, f"{label}: retrieve dropped {int(retrieval.num_dropped)}")
    batch_counts = oracle.count(batch)
    check(np.array_equal(retrieval.counts.cpu().numpy(), batch_counts), f"{label}: retrieve counts differ")
    check(np.array_equal(retrieval_pairs(retrieval), want_pairs),
          f"{label}: retrieved value multisets differ from the oracle")
    check(int(join.num_dropped) == 0, f"{label}: join dropped {int(join.num_dropped)}")
    check(np.array_equal(join_pairs(join), want_pairs), f"{label}: join pairs differ")
    check(join_size == total == int(batch_counts.sum()), f"{label}: join_size {join_size} != {total}")
    check(calls_build == {"exchange": 1}, f"{label}: build exchange calls {calls_build}")
    check(calls_query == {"exchange": 2}, f"{label}: query exchange calls {calls_query}")
    for name, calls in (("retrieve", calls_retrieve), ("inner_join", calls_join)):
        check(calls == {"exchange": 2, "plan_caps": 1},
              f"{label}: {name} exchange calls {calls}, want 2 plus the sizing round")
    for name in (WIDE_READ_KERNELS if wide else READ_PATH_KERNELS) if device.type == "cuda" else ():
        check(launches.get(name, 0) > 0, f"{label}: kernel {name} never launched")
    if device.type == "cuda":
        # One routing round a retrieve and a join: one launch of each side.
        check_gather_launches(launches, {"csr_gather_owners": 2, "csr_gather_queriers": 2}, label)
        check_hash_launches(launches, "read", n_shards, wide, label)

    res = {
        "path": path,
        "shards": n_shards,
        "keys": n_keys,
        "queries": int(queries.shape[0]),
        "retrieve_queries": RETRIEVE_QUERIES,
        "retrieved_values": total,
        "build_s": build_s,
        "query_s": query_s,
        "retrieve_s": retrieve_s,
        "build_keys_per_s": n_keys / build_s,
        "query_keys_per_s": queries.shape[0] / query_s,
        "retrieve_results_per_s": total / retrieve_s,
        "exchange_calls": {"build": calls_build, "query": calls_query, "retrieve": calls_retrieve, "inner_join": calls_join},
        "launches": launches,
        "peak_bytes": peak,
    }
    log(f"path {'' if path == 'read' else path + ' '}D={n_shards} N={n_keys}: " + json.dumps(res))
    run = {"result": res, "table": table, "state": state, "keys": keys_dev,
           "queries": queries_dev, "batch": batch_dev}
    run["inputs"] = lambda: kernel_inputs(run)
    return run


def to_device(a, device):
    """A host uint32 or int32 array as the int32 tensor the port takes."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


class LiveRows:
    """The oracle's state: the live multiset, changed as the table is.

    A delete removes every live row of its keys (a tombstone of the current
    epoch hides every layer that exists), an insert appends rows, an upsert
    keeps the last row of each key in its batch, deletes the keys and
    inserts those rows.  Folds and compactions leave the multiset as it is.
    The changes are logged and applied when the rows are read: each row
    chunk once, each delete to the chunks before it, in one pass.
    """

    def __init__(self, keys, values, key_range: int):
        self.parts = [(keys, values)]  # row chunks, in insertion order
        self.deletes = []  # (chunks before it, its keys)
        self.key_range = key_range
        self.version = 0  # changes with the multiset (folds and compactions keep it)
        self._rows = None

    def insert(self, keys, values):
        import numpy as np

        self.parts.append((keys, values.astype(np.int64)))
        self.version += 1

    def delete(self, keys):
        self.deletes.append((len(self.parts), keys))
        self.version += 1

    def upsert(self, keys, values):
        import numpy as np

        _, first = np.unique(keys[::-1], return_index=True)
        last = np.sort(keys.shape[0] - 1 - first)
        self.delete(keys[last])
        self.insert(keys[last], values[last])

    def rows(self) -> tuple:
        """``(keys, values)`` of the live multiset: a row of chunk ``c`` is dead
        when a delete logged after ``c`` holds its key."""
        import numpy as np

        if self._rows is not None and self._rows[0] == self.version:
            return self._rows[1]
        keys = np.concatenate([k for k, _ in self.parts])
        values = np.concatenate([v for _, v in self.parts])
        if self.deletes:
            # the last delete that holds each key, as the chunks before it
            upto = np.zeros(self.key_range, np.int8)
            for before, dead in self.deletes:
                upto[dead] = before
            chunk = np.repeat(np.arange(len(self.parts), dtype=np.int8),
                              [k.shape[0] for k, _ in self.parts])
            keep = upto[keys] <= chunk
            keys, values = keys[keep], values[keep]
        self.parts, self.deletes = [(keys, values)], []
        self._rows = (self.version, (keys, values))
        return keys, values

    def oracle(self):
        return Oracle(*self.rows(), self.key_range)


def spread(a, extra, d: int):
    """``a`` with ``extra`` appended evenly to each of its ``d`` shard blocks."""
    import numpy as np

    return np.concatenate([a.reshape(d, -1), extra.reshape(d, -1)], axis=1).reshape(-1)


def skewed_batch(state, table, lo: int, n: int, wide: bool = False):
    """``n`` distinct keys from ``[lo, ...)`` (``raw``; the u64x4 runs hash
    ``raw | raw << 32``) whose hash lands in shard 0's range of ``state``'s
    base, found with the plain hash on the host (no kernel launch)."""
    import numpy as np
    import torch

    from repro_torch.core import hashing

    top = int(state.base.hash_splits[1])
    cand = np.arange(lo, lo + 16 * n, dtype=np.uint32)
    k = torch.from_numpy(cand.view(np.int32))
    if wide:
        k = torch.stack([k, k], -1)
    h = hashing.hash_to_buckets_plain(k, table.hash_range, table.seed, 2 if wide else 1)
    keys = cand[h.numpy() < top][:n]
    check(keys.shape[0] == n, f"only {keys.shape[0]} of {n} candidate keys hash to shard 0")
    return keys


def update_data(n_keys: int, seed: int, device, wide: bool = False) -> tuple[dict, dict]:
    """The update path's data, drawn from ``seed``: the base keys, 5 insert
    batches of N/32 (the fifth re-inserts 2^12 deleted keys) with their
    values, 2^16 deletes, a 2^16-key upsert (half present, half new), the
    queries (every base key plus 2^20 absent ones) and the retrieve batch.
    Values are row ids (base rows first, then the batches, the upsert and
    the skewed batch); ``wide`` makes the device keys ``raw | raw << 32``
    lanes and the device values the value store's rows of those row ids.
    Returns the host arrays (``raw`` keys) and their copies on ``device``."""
    import numpy as np

    batch_n = n_keys // 32
    # The counts are fixed at full size and shrink only for a small warm-up.
    n_del, n_ups = min(DELETES, n_keys // 64), min(UPSERTS, batch_n // 2)
    n_re = min(REINSERTS, n_del // 16)
    rng = np.random.default_rng(seed + 1)
    base_keys = rng.integers(0, n_keys, size=n_keys, dtype=np.uint32)
    batches = [rng.integers(0, n_keys, size=batch_n, dtype=np.uint32) for _ in range(4)]
    dels = base_keys[rng.choice(n_keys, n_del, replace=False)]
    batches.append(np.concatenate([
        dels[:n_re], rng.integers(0, n_keys, size=batch_n - n_re, dtype=np.uint32),
    ]))
    batch_vals = [(n_keys + i * batch_n + np.arange(batch_n)).astype(np.int32) for i in range(5)]
    ups = np.concatenate([
        base_keys[rng.choice(n_keys, n_ups // 2, replace=False)],
        (n_keys + rng.choice(n_keys, n_ups // 2, replace=False)).astype(np.uint32),
    ])
    ups_vals = (n_keys + 5 * batch_n + np.arange(n_ups)).astype(np.int32)
    absent = rng.integers(4 * n_keys, 2**32 - 1, size=ABSENT_QUERIES, dtype=np.uint64).astype(np.uint32)
    queries = np.concatenate([base_keys, absent])
    batch = np.concatenate([rng.integers(0, n_keys, size=batch_n - n_ups, dtype=np.uint32), ups])
    host = dict(keys=base_keys, batches=batches, batch_vals=batch_vals, dels=dels, ups=ups,
                ups_vals=ups_vals, queries=queries, batch=batch)
    dev = {name: keys_on(a, device, wide) for name, a in (
        ("keys", base_keys), ("dels", dels), ("ups", ups), ("queries", queries), ("batch", batch),
    )}
    dev["batches"] = [keys_on(b, device, wide) for b in batches]
    if wide:
        import torch

        store = value_store(n_keys + 7 * batch_n, seed, device)
        dev["store"] = store
        dev["base_vals"] = store[:n_keys]
        rows = [torch.from_numpy(v.astype(np.int64)).to(device) for v in batch_vals + [ups_vals]]
        dev["batch_vals"] = [store[r] for r in rows[:5]]
        dev["ups_vals"] = store[rows[5]]
    else:
        dev["store"] = dev["base_vals"] = None
        dev["batch_vals"] = [to_device(v, device) for v in batch_vals]
        dev["ups_vals"] = to_device(ups_vals, device)
    return host, dev


def depth6_state(table, dev: dict):
    """The update path's depth-6 state of ``table`` from ``update_data``'s
    device arrays, without the reads between: the base, four inserts, the
    deletes, a fifth insert and the upsert (seven layers, coherent)."""
    state = table.init(dev["keys"])
    for i in range(5):
        if i == 4:
            state = state.delete(dev["dels"])
        state = state.insert(dev["batches"][i], dev["batch_vals"][i])
    state = state.upsert(dev["ups"], dev["ups_vals"])
    check(state.epoch == 6 and state.coherent, f"depth {state.epoch}, coherent {state.coherent}")
    return state


def run_update_path(n_shards: int, n_keys: int, seed: int, device, log, skew: bool = True,
                    wide: bool = False) -> dict:
    """The update path through the public API: build, 5 inserts, a delete and
    an upsert to depth 6, reads there, ``fold_oldest(3)``, reads, ``compact()``,
    reads, and at D > 1 (with ``skew``) a skewed insert and reads on the
    mixed-split stack.  ``wide``: the u64x4 run (``TableSchema("uint64",
    4)``, the upsert with a TTL the clock never reaches).

    A mixed-split stack routes every query by each layer's own splits, and
    the skewed delta's splits are balanced on its own keys; at small N their
    noise can overflow the query dispatch, which zeroes counts silently (as
    in the reference), so the small warm-up run leaves the skew step out.
    """
    import numpy as np
    import torch

    from repro_torch import DistributedHashTable, TableSchema
    from repro_torch.core import exchange, maintenance
    from repro_torch.kernels import build

    d, batch_n = n_shards, n_keys // 32
    path = "update-u64x4" if wide else "update"
    label = f"{path} D={d}"
    host, dev = update_data(n_keys, seed, device, wide)
    base_keys, batches, batch_vals, dels, ups, ups_vals, queries, batch = (host[k] for k in (
        "keys", "batches", "batch_vals", "dels", "ups", "ups_vals", "queries", "batch"))
    store = dev["store"]
    # The oracle's keys: a u64x4 run's key ``raw | raw << 32`` is indexed by
    # its ``raw`` (as int64), the draw the table's lanes were made from.
    okeys = (lambda a: a.astype(np.int64)) if wide else (lambda a: a)
    all_queries, oracle_queries = queries, okeys(queries)
    kw = dict(num_shards=d, hash_range=n_keys, device=device,
              tombstone_capacity=WIDE_TOMBSTONE_CAPACITY if wide else TOMBSTONE_CAPACITY,
              schema=TableSchema("uint64", WIDE_COLS) if wide else None)
    table = DistributedHashTable(**kw)
    probe = DistributedHashTable(**kw, paper_faithful_probe=True)
    live = LiveRows(okeys(base_keys), np.arange(n_keys, dtype=np.int64), 3 * n_keys)
    seconds, calls_seen, reads = {}, {}, {}
    probe_layers = [0]  # layers read by probe queries: one kernel 5 launch each
    # Gather launches a retrieve or join makes: one owner launch a routing
    # round (one round on a coherent stack, one a layer on a mixed-split
    # one) and one querier launch.
    gathers = {"csr_gather_owners": 0, "csr_gather_queriers": 0}

    def step(name, fn, want_calls):
        exchange.CALLS.clear()
        out, secs = wall(fn, device)
        calls = dict(exchange.CALLS)
        check(calls == want_calls, f"{label}: {name} exchange calls {calls}, want {want_calls}")
        seconds[name], calls_seen[name] = secs, calls
        return out

    def no_drops(state, name):
        check(int(state.num_dropped) == 0, f"{label}: {name} dropped {int(state.num_dropped)} rows")

    wants = {}  # the oracle's answers for one multiset and one pair of query sets

    def oracle_answers(queries, batch):
        """The live multiset's counts of ``queries``, its counts of ``batch``
        and its ``(query row, values)`` pairs of ``batch``, sorted; computed
        once for each multiset (a fold or a compaction keeps it) and reused
        by every read of it."""
        key = (live.version, id(queries), id(batch))
        if wants.get("key") != key:
            wants.clear()
            oracle, okb = live.oracle(), okeys(batch)
            wants.update(key=key, counts=oracle.count(
                oracle_queries if queries is all_queries else okeys(queries)),
                batch_counts=oracle.count(okb), pairs=store_pairs(oracle.pairs(okb), store))
        return wants["counts"], wants["batch_counts"], wants["pairs"]

    def read_all(name, state, queries=queries, batch=batch):
        """Sorted and probe query, retrieve, inner_join, join_size of ``state``
        against the oracle and the exchange budgets."""
        rounds = 1 if state.coherent else len(state.layers)
        point, plan = {"exchange": 2 * rounds}, {"exchange": 2 * rounds, "plan_caps": rounds}
        q_dev, b_dev = keys_on(queries, device, wide), keys_on(batch, device, wide)
        want_counts, batch_counts, want_pairs = oracle_answers(queries, batch)
        out = {"layers": len(state.layers), "coherent": state.coherent}
        for kind, t in (("sorted", table), ("probe", probe)):
            counts = step(f"{name}: {kind} query", lambda t=t: t.query(state, q_dev), point)
            check(np.array_equal(counts.cpu().numpy(), want_counts),
                  f"{label}: {name}: {kind} query counts differ from the oracle")
            out[f"{kind}_query_keys_per_s"] = queries.shape[0] / seconds[f"{name}: {kind} query"]
            del counts
        probe_layers[0] += len(state.layers)
        gathers["csr_gather_owners"] += 2 * rounds
        gathers["csr_gather_queriers"] += 2
        retrieval = step(f"{name}: retrieve", lambda: table.retrieve(state, b_dev), plan)
        check(int(retrieval.num_dropped) == 0, f"{label}: {name}: retrieve dropped")
        check(np.array_equal(retrieval.counts.cpu().numpy(), batch_counts),
              f"{label}: {name}: retrieve counts differ from the oracle")
        check(np.array_equal(retrieval_pairs(retrieval), want_pairs),
              f"{label}: {name}: retrieved value multisets differ from the oracle")
        del retrieval
        join = step(f"{name}: inner_join", lambda: table.inner_join(state, b_dev), plan)
        check(int(join.num_dropped) == 0, f"{label}: {name}: join dropped")
        check(np.array_equal(join_pairs(join), want_pairs),
              f"{label}: {name}: join pairs differ from the oracle")
        del join
        size = step(f"{name}: join_size", lambda: int(table.join_size(state, b_dev)), point)
        check(size == want_pairs.shape[0], f"{label}: {name}: join_size {size} != {want_pairs.shape[0]}")
        out["queries"], out["retrieve_queries"] = int(queries.shape[0]), int(batch.shape[0])
        out["retrieved_values"] = int(want_pairs.shape[0])
        out["retrieve_results_per_s"] = want_pairs.shape[0] / seconds[f"{name}: retrieve"]
        reads[name] = out
        log(f"{label} N={n_keys} reads {name}: " + json.dumps(out))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    state = step("init", lambda: table.init(dev["keys"], dev["base_vals"]), {"exchange": 1})
    for i in range(5):
        if i == 4:
            state = step("delete", lambda s=state: s.delete(dev["dels"]), {})
            live.delete(okeys(dels))
        state = step(f"insert {i + 1}", lambda s=state, i=i: s.insert(
            dev["batches"][i], dev["batch_vals"][i]), {"exchange": 1})
        live.insert(okeys(batches[i]), batch_vals[i])
    ttl = UPSERT_TTL if wide else None
    state = step("upsert", lambda s=state: s.upsert(dev["ups"], dev["ups_vals"], ttl=ttl),
                 {"exchange": 1})
    live.upsert(okeys(ups), ups_vals)
    check(state.epoch == 6 and state.coherent, f"{label}: depth {state.epoch}, coherent {state.coherent}")
    no_drops(state, "depth 6")
    read_all("depth 6", state)
    state6 = state
    folded = step("fold_oldest", lambda: maintenance.fold_oldest(state6, 3), {})
    check(folded.epoch == 3 and folded.coherent, f"{label}: fold left depth {folded.epoch}")
    no_drops(folded, "fold_oldest")
    read_all("folded", folded)
    compacted = step("compact", lambda: folded.compact(), {"exchange": 2})
    check(compacted.epoch == 0, f"{label}: compact left depth {compacted.epoch}")
    no_drops(compacted, "compact")
    compact_live = int(live.rows()[0].shape[0])
    read_all("compacted", compacted)
    mixed = None
    if d > 1 and skew:
        skewed = skewed_batch(compacted, table, 2 * n_keys, batch_n, wide)
        skew_vals = (n_keys + 6 * batch_n + np.arange(batch_n)).astype(np.int32)
        skew_dev = to_device(skew_vals, device)
        if wide:
            skew_dev = store[skew_dev.to(torch.int64)]
        before = table.skew_fallbacks
        mixed = step("insert skewed", lambda: compacted.insert(
            keys_on(skewed, device, wide), skew_dev), {"exchange": 1})
        check(table.skew_fallbacks == before + 1 and not mixed.coherent,
              f"{label}: the skewed insert did not take the skew guard's fallback")
        no_drops(mixed, "insert skewed")
        live.insert(okeys(skewed), skew_vals)
        # Skewed keys join the reads spread evenly over the query shards and
        # within the routing slack: by the base's splits they all go to shard 0.
        read_all("mixed-split", mixed, spread(queries, skewed[: batch_n // 16], d),
                 spread(batch, skewed[: batch_n // 64], d))
    sync(device)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    for name in (WIDE_TABLE_KERNELS if wide else TABLE_KERNELS) if device.type == "cuda" else ():
        check(launches.get(name, 0) > 0, f"{label}: kernel {name} never launched")
    if device.type == "cuda":
        check_hash_launches(launches, "update", d, wide, label)
        check(launches.get("bucket_probe_layer", 0) == probe_layers[0],
              f"{label}: {launches.get('bucket_probe_layer', 0)} launches of bucket_probe_layer, "
              f"want one per layer per probe query ({probe_layers[0]})")
        check(launches.get("bucket_probe", 0) == 0,
              f"{label}: the probe path launched the window entry bucket_probe")
        check_gather_launches(launches, gathers, label)

    res = {
        "path": path,
        "shards": d,
        "keys": n_keys,
        "batch": batch_n,
        "seconds": seconds,
        "insert_keys_per_s": [batch_n / seconds[f"insert {i + 1}"] for i in range(5)],
        "delete_s": seconds["delete"],
        "upsert_s": seconds["upsert"],
        "fold_s": seconds["fold_oldest"],
        "compact_live_rows": compact_live,
        "compact_keys_per_s": compact_live / seconds["compact"],
        "skew_fallbacks": table.skew_fallbacks,
        "probe_layers_read": probe_layers[0],
        "reads": reads,
        "exchange_calls": calls_seen,
        "launches": launches,
        "peak_bytes": peak,
    }
    log(f"{label} N={n_keys}: " + json.dumps({k: v for k, v in res.items()
                                                if k not in ("reads", "exchange_calls")}))
    run = {"result": res, "table": table, "probe": probe, "state": state6, "folded": folded,
           "queries": dev["queries"], "batch": dev["batch"]}
    run["inputs"] = lambda: update_kernel_inputs(run)
    return run


def check_gather_launches(launches: dict, want: dict, label: str) -> None:
    """Kernels 3-4 on a path: exactly ``want`` launches of the entries it
    names, and none of the Pallas-interface entries it does not (only the
    single-card API's retrieve and join run ``csr_gather``)."""
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{label}: {launches.get(name, 0)} launches of {name}, want {n}")
    for name in PALLAS_GATHERS:
        if name not in want:
            check(launches.get(name, 0) == 0, f"{label}: the table's path launched {name}")


def kernel_class(name: str) -> str:
    """Which part of the work a device kernel belongs to, by its name."""
    low = name.lower()
    for cls, marks in (("kernel 7", ("slstm",)), ("kernel 6", ("flash_fwd",)),
                       ("kernel 5", ("probe",)), ("kernels 3-4", ("gather_tiles", "csr_gather")),
                       ("GEMM", ("nvjet", "gemm", "gemv", "xmma", "cutlass")),
                       ("copies", ("memcpy", "memset", "copy"))):
        if any(m in low for m in marks):
            return cls
    return "elementwise and reductions"


def _split_by_class(rows) -> dict:
    """``{class: {"ms", "launches"}}`` of ``(name, ms, launches)`` rows."""
    split: dict = {}
    for name, ms, n in rows:
        cls = kernel_class(name)
        t, c = split.get(cls, (0.0, 0))
        split[cls] = (t + ms, c + n)
    return {cls: {"ms": ms, "launches": n} for cls, (ms, n) in split.items()}


def profile_phases(phases: dict, device, window: str = None) -> dict:
    """Device time by operation for one more call of each phase
    (``torch.profiler``), with the device's busy share of the wall time and
    the busy time split by ``kernel_class``.  With ``window``, the name of
    ``record_function`` ranges the phase opens, each phase also reports the
    kernels and copies that ran on the card inside those ranges' device
    windows (one stream, so a window holds exactly the range's work); a
    tuple of names reports each under ``windows``."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for phase, fn in phases.items():
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, seconds = wall(fn, device)
        # Kernel rows only: operator rows repeat the device time of their kernels,
        # and the windows' own ranges (device-side annotations) span them.
        ranges = {window} if isinstance(window, str) else set(window or ())
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
                  and e.key not in ranges]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
        out[phase] = {
            "wall_ms": seconds * 1e3,
            "device_busy_ms": busy_ms,
            "by_class": _split_by_class(
                (e.key, e.self_device_time_total / 1e3, e.count) for e in events),
            "top": [[e.key, e.self_device_time_total / 1e3, e.count] for e in top],
        }
        if isinstance(window, str):
            out[phase]["window"] = _window_split(prof.events(), window)
        elif window is not None:
            trace = prof.events()
            out[phase]["windows"] = {name: _window_split(trace, name) for name in window}
    return out


def _window_split(trace, window: str) -> dict:
    """The kernels and copies that ran on the card inside the device windows
    of the ``record_function`` ranges named ``window``."""
    on_card = [e for e in trace if not str(e.device_type).endswith("CPU")]
    spans = [e.time_range for e in on_card if e.name == window]
    inside = [e for e in on_card if e.name != window and any(
        w.start <= e.time_range.start and e.time_range.end <= w.end for w in spans)]
    ms = [(e.name, e.time_range.elapsed_us() / 1e3, 1) for e in inside]
    return {
        "name": window,
        "calls": sum(1 for e in trace if e.name == window and str(e.device_type).endswith("CPU")),
        "device_windows": len(spans),
        "device_ms": sum(m for _, m, _ in ms),
        "launches": len(inside),
        "by_class": _split_by_class(ms),
        "top": [[n[:110], m] for n, m, _ in sorted(ms, key=lambda r: -r[1])[:12]],
    }


def read_path_phases(run: dict) -> dict:
    table, state = run["table"], run["state"]
    return {
        "build": lambda: table.init(run["keys"]),
        "query": lambda: table.query(state, run["queries"]),
        "retrieve": lambda: table.retrieve(state, run["batch"]),
    }


def update_path_phases(run: dict) -> dict:
    return {
        "probe query (depth 6)": lambda: run["probe"].query(run["state"], run["queries"]),
        "compact": lambda: run["folded"].compact(),
    }


def hash_inputs(table, keys) -> dict:
    """Phase 1 of a build over ``(D, n)`` keys: murmur and histogram inputs
    (EMPTY rows get bin -1, as the build leaves them out).  2-lane keys
    ``(D, n, 2)`` go to kernel 1's two-output entry, both outputs asked for,
    as the owner side of a build or a routed batch asks."""
    import torch

    from repro_torch.core import hashgraph, partition
    from repro_torch.kernels import murmur

    d, lanes = table.num_shards, hashgraph.shard_lanes(keys)
    h, _ = murmur.murmur_hash(keys, table.hash_range, table.seed, lanes=lanes)
    num_bins = table.num_bins or partition.choose_num_bins(table.hash_range, d)
    bsz = partition.bin_size_for(table.hash_range, num_bins)
    bins = torch.clamp(torch.div(h, bsz, rounding_mode="floor"), 0, num_bins - 1).to(torch.int32)
    bins = torch.where(hashgraph.is_empty_key(keys, lanes), -1, bins).to(torch.int32)
    name = "murmur_bucket" if lanes == 1 else "murmur_hash"
    return {
        name: dict(keys=keys, table_size=table.hash_range, seed=table.seed,
                   n=keys.numel() // lanes, lanes=lanes),
        "bin_histogram": dict(bins=bins, num_bins=num_bins),
    }


def gather_inputs(table, state, batch, caps=None) -> dict:
    """From the retrieve of ``batch`` on ``state``: the owner entry's inputs
    for every owner and layer, the querier entry's for every querier (as the
    path hands them over), and, for the Pallas-interface rows, owner 0's
    interleaved runs over its concatenated tables and querier 0's CSR.
    ``caps`` ``(out, seg)`` fixes the capacities (default: the counts
    round's exact sizing)."""
    import torch

    from repro_torch.core import exchange
    from repro_torch.core import multi_hashgraph as mh
    from repro_torch.kernels import ops

    d, local = table.num_shards, table.group.local
    q = batch.reshape(local, -1, *batch.shape[1:])
    tombstones = state.tombstones.index()
    out_cap, seg_cap = caps if caps is not None else table._resolve_caps(state, q, None, None)
    # With the fingerprint lane the routing also hashes the fingerprints (an
    # argument earlier sources, timed by tools/gather_ab.py, do not take).
    fp = any(getattr(layer.local, "fingerprints", None) is not None for layer in state.layers)
    routed = mh._route_queries_once(state.base, q, table.capacity_slack, *((True,) if fp else ()))
    starts_lr, counts_lr, tables = mh._layer_run_descriptors(state.layers, routed, tombstones)
    cap, nl = routed.capacity, len(state.layers)
    starts4 = starts_lr.reshape(nl, local, d, cap)
    counts4 = counts_lr.reshape(nl, local, d, cap)
    seg, _, slot_counts = ops.csr_gather_owners(starts4, counts4, tables, capacity=seg_cap)
    counts, starts, seg_flat = exchange.combine_ragged(seg, slot_counts, routed.route)
    del seg
    widths = torch.tensor([0] + [t.shape[1] for t in tables[:-1]], device=starts_lr.device)
    base = torch.cumsum(widths, 0).to(torch.int32).view(nl, 1, 1)
    starts_i, counts_i, table_cat = ops.interleave_layer_runs(
        starts4[:, 0] + base, counts4[:, 0], tuple(t[0] for t in tables))
    return {
        "csr_gather_owners": dict(starts=starts4, counts=counts4, tables=tables, capacity=seg_cap),
        "csr_gather_queriers": dict(starts=starts, counts=counts, table=seg_flat, capacity=out_cap),
        "csr_gather_batched": dict(
            offsets=ops.run_offsets(counts_i), starts=starts_i, table=table_cat, capacity=seg_cap
        ),
        "csr_gather": dict(
            offsets=ops.run_offsets(counts[0]), starts=starts[0], table=seg_flat[0], capacity=out_cap
        ),
    }


def kernel_inputs(run: dict) -> dict:
    """Each kernel's inputs as the read path hands them over: the sharded
    keys to murmur and histogram (build phase 1), and the gathers of the
    retrieve of the query batch (``gather_inputs``)."""
    table, state = run["table"], run["state"]
    keys = run["keys"].reshape(table.num_shards, -1, *run["keys"].shape[1:])
    return {**hash_inputs(table, keys), **gather_inputs(table, state, run["batch"])}


def update_kernel_inputs(run: dict) -> dict:
    """Each kernel's inputs as the update path hands them over: the rows the
    compaction rebuilds to murmur and histogram (its build's phase 1), the
    depth-6 retrieve's gathers, and the depth-6 probe query's base layer:
    its routed batch to kernel 5's layer entry (every shard's slots in one
    launch, the first layer writing the total), and the windows the plain
    steps find for it to the window entry."""
    from repro_torch.core import hashgraph, plans
    from repro_torch.core import multi_hashgraph as mh

    table, probe, state, folded = run["table"], run["probe"], run["state"], run["folded"]
    d = table.num_shards
    _, rebuild_rows = table._sizing_memo[plans.state_signature(folded)]
    keys, _, _ = table._compact_rows(folded, rebuild_rows)
    inputs = {**hash_inputs(table, keys), **gather_inputs(table, state, run["batch"])}
    base = state.base
    q = run["queries"]
    routed = mh._route_queries_once(base, q.reshape(d, -1, *q.shape[1:]), probe.capacity_slack)
    inputs["bucket_probe_layer"] = dict(
        rq=routed.rq, rh=routed.rh, lo=routed.lo,
        match_e=mh._tombstone_epochs(routed.rq, state.tombstones.index()),
        offsets=base.local.offsets, keys=base.local.keys, table_size=base.local_range_cap,
        stride=base.bucket_stride, epoch=0, max_probe=probe.max_probe, accumulate=False,
    )
    b = mh._rebase_buckets(routed.rh, routed.is_pad, routed.lo, base.local_range_cap,
                           base.bucket_stride)
    starts, ends = hashgraph.bucket_windows(base.local.offsets, base.local_range_cap, b)
    inputs["bucket_probe"] = dict(starts=starts.to(routed.rq.dtype), ends=ends.to(routed.rq.dtype),
                                  q=routed.rq, table=base.local.keys, max_probe=probe.max_probe)
    return inputs


def live_start_bytes(counts) -> int:
    """The bytes of a run-start array laid out as ``counts`` that a gather
    must read: 32 B for each 32-byte sector holding a start whose count is
    > 0 (no slot reads the start of an empty run)."""
    import torch

    live = counts.reshape(-1) > 0
    pad = (-live.numel()) % 8
    if pad:
        live = torch.cat([live, live.new_zeros(pad)])
    return 32 * int(live.view(-1, 8).any(1).sum())


def gather_work(offsets, starts, capacity: int, cols: int = 1) -> tuple[int, int]:
    """``(bytes, int32 ops)`` a Pallas-interface CSR gather needs on these
    inputs: the offsets read once, the starts of non-empty runs
    (``live_start_bytes``), the C table words of each row the valid slots
    select, C values and a row id written per slot; per valid slot 12
    operations (its row's step, the offset, the address and its clamp), per
    slot 1 + C for the stores."""
    import torch

    totals = offsets[..., -1].to(torch.int64)
    picked = int(torch.clamp(totals, max=capacity).sum())
    slots = capacity * (offsets.shape[0] if offsets.ndim == 2 else 1)
    nbytes = (4 * (offsets.numel() + cols * picked) + live_start_bytes(torch.diff(offsets, dim=-1))
              + 4 * (1 + cols) * slots)
    return nbytes, 12 * picked + (1 + cols) * slots


def owners_work(a: dict) -> tuple[int, int]:
    """``(bytes, int32 ops)`` the owner entry needs on these inputs, each
    byte once: the (L, D_o, D_s, R) counts, the starts of non-empty runs
    (``live_start_bytes``), one prefix sum per routed slot, the C words of
    each picked table row, the written segment (C words a slot) and one
    overflow word per block; per picked row 12 operations plus 3 per layer
    (the layer walk), per slot C for the stores."""
    import torch

    counts, cap = a["counts"], a["capacity"]
    cols = a["tables"][0].shape[-1] if a["tables"][0].ndim == 3 else 1
    nl = counts.shape[0]
    blocks = counts.shape[1] * counts.shape[2]
    totals = counts.sum((0, 3), dtype=torch.int64)
    picked = int(torch.clamp(totals, max=cap).sum())
    nbytes = (4 * (counts.numel() + counts[0].numel() + cols * (picked + blocks * cap) + blocks)
              + live_start_bytes(counts))
    return nbytes, picked * (12 + 3 * nl) + cols * blocks * cap


def owners_sectors(a: dict) -> dict:
    """The distinct 32-byte sectors of the layer tables that the owner
    entry's picked words touch (the runs of these inputs, every word once)
    and the floor they set: the streamed bytes (counts, the sectors of
    non-empty runs' starts, slot sums, segment) plus 32 B a table sector
    over the memory rate.  Where the tables are far beyond L2, each run that
    starts in a new sector is a separate DRAM access."""
    import torch

    starts, counts = a["starts"], a["counts"]
    cols = a["tables"][0].shape[-1] if a["tables"][0].ndim == 3 else 1
    d_o = counts.shape[1]
    per_owner = counts[0].numel() // d_o
    owner = torch.arange(d_o, device=counts.device).repeat_interleave(per_owner)
    sectors = 0
    for l, t in enumerate(a["tables"]):
        c = counts[l].reshape(-1).to(torch.int64)
        live = c > 0
        c = c[live]
        first = starts[l].reshape(-1)[live].to(torch.int64)
        run_start = torch.cumsum(c, 0) - c
        rows = (torch.repeat_interleave(first - run_start, c)
                + torch.arange(int(c.sum()), device=c.device))
        words = (t.data_ptr() // 4 + torch.repeat_interleave(owner[live], c) * t.stride(0)
                 + rows * cols)
        sectors += int(torch.unique(torch.cat([
            torch.div(words + j, 8, rounding_mode="floor") for j in range(cols)])).numel())
    blocks = counts.shape[1] * counts.shape[2]
    streamed = (4 * (counts.numel() + counts[0].numel() + cols * blocks * a["capacity"])
                + live_start_bytes(counts))
    return {"sectors": sectors, "sector_floor_ms": (streamed + 32 * sectors) / HBM_BYTES_PER_S * 1e3}


def queriers_work(a: dict) -> tuple[int, int]:
    """``(bytes, int32 ops)`` the querier entry needs on these inputs, each
    byte once: the counts, the starts of non-empty runs
    (``live_start_bytes``), the picked rows (C words) of the returned
    segments, C values and a row id written per slot, the clamped offsets
    and one overflow word per querier; per picked row 12 operations, per
    slot 1 + C."""
    import torch

    counts, cap = a["counts"], a["capacity"]
    cols = a["table"].shape[-1] if a["table"].ndim == 3 else 1
    d, n = counts.shape
    picked = int(torch.clamp(counts.to(torch.int64).sum(-1), max=cap).sum())
    nbytes = (4 * (counts.numel() + cols * picked + (1 + cols) * d * cap + d * (n + 1) + d)
              + live_start_bytes(counts))
    return nbytes, 12 * picked + (1 + cols) * d * cap


def probe_work(starts, ends, max_probe: int, word_bytes: int = 4) -> tuple[int, int]:
    """``(bytes, int32 ops)`` the window entry needs on these inputs: starts,
    ends and one count (4 B each) and q (a key word: 4 B, 8 B for 2
    lanes) per slot, and the table words inside each window up to
    ``max_probe``; per word a load address, a compare and an add, per slot 6
    for the window set-up."""
    import torch

    words = int(torch.clamp(ends.to(torch.int64) - starts.to(torch.int64), 0, max_probe).sum())
    return (12 + word_bytes) * starts.numel() + word_bytes * words, 3 * words + 6 * starts.numel()


def probe_layer_work(a: dict) -> dict:
    """What kernel 5's layer entry needs on these inputs, each byte once:
    per slot its key word rq (4 B; 8 B for 2 lanes) and 4 B each of rh and
    match_e and of total (twice where it accumulates); per live slot (not
    padding, not tombstoned) its offsets pair (8 B) and its window's key
    words up to ``max_probe``, each of the two arrays counted at most once
    whole.  Operations: per slot 12 for
    the set-up and mask, per word 3 (address, compare, add).  ``sectors``
    counts the distinct 32-byte sectors each live slot touches in offsets
    and keys (its pair's and its window's): where the tables are far beyond
    L2 each is a separate DRAM access, so ``sector_floor_ms`` (the streamed
    slot bytes plus 32 B a sector, over the memory rate) is a floor above
    the bytes-once bound."""
    import torch

    from repro_torch.core import hashgraph
    from repro_torch.core import multi_hashgraph as mh

    rq, offsets, keys = a["rq"], a["offsets"], a["keys"]
    d, n = rq.shape[:2]
    lanes = hashgraph.shard_lanes(rq)
    wb = 4 * lanes  # bytes of a key word
    live = ~hashgraph.is_empty_key(rq, lanes)
    if a["match_e"] is not None:
        live &= a["match_e"] < a["epoch"]
    b = mh._rebase_buckets(a["rh"], ~live, a["lo"], a["table_size"], a["stride"])
    starts, ends = hashgraph.bucket_windows(offsets, a["table_size"], b)
    words = torch.where(live, torch.clamp(ends - starts, 0, a["max_probe"]), 0)
    n_live, n_words = int(live.sum()), int(words.sum())
    slot_bytes = d * n * (wb + 4 * (2 + (a["match_e"] is not None) + bool(a["accumulate"])))
    nbytes = (slot_bytes + min(8 * n_live, 4 * offsets.numel())
              + min(wb * n_words, wb * keys.shape[0] * keys.shape[1]))
    shard = torch.arange(d, device=rq.device, dtype=torch.int64).unsqueeze(1)
    pair = shard * offsets.shape[1] + b.to(torch.int64)
    pair_sectors = torch.where(live, 1 + (pair + 1) // 8 - pair // 8, 0)
    first = (shard * keys.shape[1] + starts.to(torch.int64)) * wb  # byte address
    window_sectors = torch.where(words > 0, (first + wb * words - 1) // 32 - first // 32 + 1, 0)
    sectors = int(pair_sectors.sum()) + int(window_sectors.sum())
    return {
        "bytes": nbytes,
        "ops": 3 * n_words + 12 * d * n,
        "slots": d * n,
        "live_slots": n_live,
        "window_words": n_words,
        "sectors": sectors,
        "sector_floor_ms": (slot_bytes + 32 * sectors) / HBM_BYTES_PER_S * 1e3,
    }


def twin_error(name, got, want, tol, device):
    """The largest difference between a kernel's outputs and its plain
    twin's; fails the run where ``tol`` (see ``kernel_row``) does not hold."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    sync(device)
    for a, b in zip(got, want):
        if tol is None:
            check(a.shape == b.shape and torch.equal(a, b), f"kernel {name} differs from its plain twin")
        else:
            check(a.shape == b.shape and a.dtype == b.dtype, f"kernel {name}: {a.shape}/{a.dtype} "
                  f"against the plain twin's {b.shape}/{b.dtype}")
            bad = int(((a.float() - b.float()).abs() > tol * (1 + b.float().abs())).sum())
            check(bad == 0, f"kernel {name}: {bad} outputs differ from the plain twin by more "
                  f"than {tol} (relative and absolute)")
    if tol is None:
        return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
                   for a, b in zip(got, want))
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))


def kernel_row(name, meta: dict, shapes: str, kernel_fn, plain_fn, bounds: dict, device, log,
               library_fn=None, reps: int = 20, timing=None) -> dict:
    """One table kernel against its plain twin on the same card inputs (every
    output an integer: equal), timed.

    ``meta`` holds the row's ``path``, ``shards`` and ``launches`` (the count
    of its run); ``bounds`` the least time in ms by ``"bytes"`` and by
    ``"operations"``.  The kernel's ``ms`` is the mean of ``reps`` launches,
    or with ``timing`` the median over ``timing["groups"]`` groups of
    ``timing["launches"]`` (``ms_min_median_max`` beside it)."""
    bound_by = max(bounds, key=bounds.get)
    err = twin_error(name, kernel_fn(), plain_fn(), None, device)
    spread = None
    if timing is not None:
        spread = spread_ms({name: kernel_fn}, device, timing["groups"], timing["launches"])[name]
    row = {
        "name": name,
        **meta,
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "max_abs_err": err,
        "ms": spread[1] if spread else mean_ms(kernel_fn, reps, device),
        "ms_min_median_max": spread,
        "plain_ms": mean_ms(plain_fn, 3, device),
        "bound_ms": bounds[bound_by],
        "bound_by": bound_by,
        "library_ms": mean_ms(library_fn, reps, device) if library_fn else None,
        "shapes": shapes,
    }
    log(f"kernel {name} {meta['path']} {shapes}: max_abs_err={err} (exact) "
        f"kernel_ms={row['ms']} {'[min, median, max]=' + str(spread) + ' ' if spread else ''}plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
        f"bound_ms={row['bound_ms']} ({bound_by}) launches={row['launches']}")
    return row


def int_bounds(work: tuple[int, int]) -> dict:
    """Least times in ms of ``(bytes, int32 ops)``."""
    nbytes, nops = work
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": nops / INT32_OPS_PER_S * 1e3}


def check_kernels(run: dict, device, log) -> list:
    """Each kernel of the run against its plain twin on the run's own card
    inputs (those ``run["inputs"]()`` gives: a run checks the kernels it
    ran), timed; the launch counts of the run are reported beside."""
    import torch

    from repro_torch.core import hashgraph
    from repro_torch.core import multi_hashgraph as mh
    from repro_torch.kernels import bucket_probe, csr_gather, histogram, murmur

    inputs = run["inputs"]()
    path, shards = run["result"]["path"], run["result"]["shards"]
    launches = run["result"]["launches"]
    rows = []

    def record(name, shapes, kernel_fn, plain_fn, work, library_fn=None, timing=None):
        meta = {"path": path, "shards": shards, "launches": launches.get(name, 0)}
        rows.append(kernel_row(name, meta, shapes, kernel_fn, plain_fn, int_bounds(work), device,
                               log, library_fn=library_fn, timing=timing))

    if "murmur_bucket" in inputs:
        a = inputs["murmur_bucket"]
        record(
            "murmur_bucket", f"keys={tuple(a['keys'].shape)} int32 -> int32 of the same shape",
            lambda: murmur.murmur_bucket(a["keys"], a["table_size"], a["seed"]),
            lambda: murmur.murmur_bucket_plain(a["keys"], a["table_size"], a["seed"]),
            (8 * a["n"], 22 * a["n"]),  # 5 multiplies, 2 rotates, 3 shift-xors, mod, ...
        )
    elif "murmur_hash" in inputs:
        a = inputs["murmur_hash"]
        hash_kw = dict(lanes=a["lanes"], fingerprint=True)
        record(
            "murmur_hash",
            f"keys={tuple(a['keys'].shape)} int32 ({a['lanes']} lanes) -> bucket ids and "
            f"fingerprints, two int32 of {a['n']} rows",
            lambda: murmur.murmur_hash(a["keys"], a["table_size"], a["seed"], **hash_kw),
            lambda: murmur.murmur_hash_plain(a["keys"], a["table_size"], a["seed"], **hash_kw),
            # Read 4 L bytes, write 8; per hash 9 operations a word and 11
            # for the length mix and finalizer, one mod.
            ((4 * a["lanes"] + 8) * a["n"], (2 * (9 * a["lanes"] + 11) + 1) * a["n"]),
        )
    if "bin_histogram" in inputs:
        a = inputs["bin_histogram"]
        bins = a["bins"]
        record(
            "bin_histogram", f"bins={tuple(bins.shape)} int32 -> ({a['num_bins']},) int32",
            lambda: histogram.bin_histogram(bins, a["num_bins"]),
            lambda: histogram.bin_histogram_plain(bins, a["num_bins"]),
            (4 * bins.numel() + 4 * a["num_bins"], 3 * bins.numel()),  # 2 compares, 1 atomic
            library_fn=(lambda: torch.bincount(bins.reshape(-1), minlength=a["num_bins"]))
            if bool((bins >= 0).all()) else None,
        )
    if "csr_gather_owners" in inputs:
        a = inputs["csr_gather_owners"]
        owner_args = (a["starts"], a["counts"], a["tables"], a["capacity"])
        record(
            "csr_gather_owners",
            f"starts/counts={tuple(a['counts'].shape)} tables="
            f"{[tuple(t.shape) for t in a['tables']]} seg_capacity={a['capacity']} (every "
            f"owner, source and layer; plain twin: per owner, the runs rebased into the "
            f"concatenated tables, interleaved and gathered)",
            lambda: csr_gather.csr_gather_owners(*owner_args),
            lambda: csr_gather.csr_gather_owners_plain(*owner_args),
            owners_work(a),
            timing=PROBE_TIMING,
        )
        sectors = owners_sectors(a)
        rows[-1].update(sectors)
        log(f"kernel csr_gather_owners {path} D={shards}: " + json.dumps(sectors))
        a = inputs["csr_gather_queriers"]
        querier_args = (a["starts"], a["counts"], a["table"], a["capacity"])
        record(
            "csr_gather_queriers",
            f"starts/counts={tuple(a['counts'].shape)} table={tuple(a['table'].shape)} "
            f"capacity={a['capacity']} (every querier; plain twin: one CSR gather a querier)",
            lambda: csr_gather.csr_gather_queriers(*querier_args),
            lambda: csr_gather.csr_gather_queriers_plain(*querier_args),
            queriers_work(a),
            timing=PROBE_TIMING,
        )
    for name, fn in (("csr_gather_batched", csr_gather.csr_gather_batched_2d),
                     ("csr_gather", csr_gather.csr_gather_2d)):
        if name not in inputs:
            continue
        a = inputs[name]
        record(
            name,
            f"offsets={tuple(a['offsets'].shape)} starts={tuple(a['starts'].shape)} "
            f"table={tuple(a['table'].shape)} capacity={a['capacity']}",
            lambda fn=fn, a=a: fn(a["offsets"], a["starts"], a["table"], a["capacity"]),
            lambda a=a: csr_gather.gather_plain(a["offsets"], a["starts"], a["table"], a["capacity"]),
            gather_work(a["offsets"], a["starts"], a["capacity"],
                        1 if a["table"].ndim == 1 else a["table"].shape[-1]),
        )
    if "bucket_probe_layer" in inputs:
        a = inputs["bucket_probe_layer"]
        args = tuple(a[k] for k in ("rq", "rh", "lo", "match_e", "offsets", "keys"))
        kw = {k: a[k] for k in ("table_size", "stride", "epoch", "max_probe", "accumulate")}
        total = torch.empty(a["rq"].shape[:2], dtype=torch.int32, device=a["rq"].device)
        work = probe_layer_work(a)
        log(f"kernel bucket_probe_layer {path} D={shards} work: " + json.dumps(work))
        record(
            "bucket_probe_layer",
            f"rq/rh/match_e={tuple(a['rq'].shape)} offsets={tuple(a['offsets'].shape)} "
            f"keys={tuple(a['keys'].shape)} stride={a['stride']} max_probe={a['max_probe']} "
            f"({a.get('what', 'the depth-6 probe query' + chr(39) + 's base layer')}; plain "
            f"twin: rebase, windows, one probe step at a time, mask)",
            lambda: bucket_probe.bucket_probe_layer(*args, total=total, **kw),
            lambda: bucket_probe.bucket_probe_layer_plain(*args, total=torch.empty_like(total), **kw),
            (work["bytes"], work["ops"]),
            timing=PROBE_TIMING,
        )
        # A yardstick of the card's rate for random words: one torch.gather of
        # each slot's offsets word (it also streams its int64 index and output).
        pad = hashgraph.is_empty_key(a["rq"], hashgraph.shard_lanes(a["rq"]))
        buckets = mh._rebase_buckets(a["rh"], pad, a["lo"], a["table_size"],
                                     a["stride"]).to(torch.int64)
        gather_ms = mean_ms(lambda: torch.gather(a["offsets"], 1, buckets), 10, device)
        del buckets
        rows[-1].update(sectors=work["sectors"], sector_floor_ms=work["sector_floor_ms"],
                        random_gather_ms=gather_ms)
        log(f"kernel bucket_probe_layer {path} D={shards}: sectors={work['sectors']} "
            f"sector_floor_ms={work['sector_floor_ms']} random_gather_ms={gather_ms} "
            f"(torch.gather of one offsets word per slot)")
    if "bucket_probe" in inputs:
        a = inputs["bucket_probe"]
        record(
            "bucket_probe",
            f"starts/ends/q={tuple(a['q'].shape)} table={tuple(a['table'].shape)} "
            f"max_probe={a['max_probe']} (plain twin: one probe step at a time)",
            lambda: bucket_probe.bucket_probe(a["starts"], a["ends"], a["q"], a["table"], a["max_probe"]),
            lambda: bucket_probe.bucket_probe_plain(
                a["starts"], a["ends"], a["q"], a["table"], a["max_probe"]),
            probe_work(a["starts"], a["ends"], a["max_probe"], 4 * (a["q"].ndim - a["starts"].ndim + 1)),
        )
    del inputs
    return rows


# ---------------------------------------------------------------------------
# Table serving path: TableServer + AsyncFrontend on the card
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (1024, 2048, 4096)
SERVE_WRITE_BUCKET = 1 << 16
SERVE_TOMBSTONES = 1 << 15  # the stream's 2^13 tombstones stay below half of it
SERVE_READERS = 4
SERVE_REQUESTS = 2048  # query requests over all readers
SERVE_REQ_SIZES = (4, 256)  # uniform, as bench_serve.py's --req-min / --req-max
SERVE_ABSENT = 0.1
SERVE_GROUPS = 64  # retrieve_many calls of SERVE_GROUP requests, per-layer counts on
SERVE_GROUP = 8
SERVE_INSERTS = 8
SERVE_DELETES = 1 << 12
SERVE_UPSERTS = 1 << 12
SERVE_HOT_REPEATS = 512  # one key absent from the base, in every insert
SERVE_FOLD_HORIZON = 2
SERVE_PACING_S = 0.006  # mean gap between one reader's submissions
SERVE_GROUP_GAP_S = 0.01  # mean gap between the retrieve thread's calls
# A read batch of B keys sends each of the D^2 (source, owner) slots about
# B / D^2 keys: at D = 8 and B = 2048 that is 32 +- 5.3 against a slot of
# 48 at the default slack 1.25 (3 sigma, so one batch in ~12 drops a real
# key).  2.0 puts the slot at 72 (7.5 sigma) and costs the base build a
# larger dispatch buffer.
SERVE_CAPACITY_SLACK = 2.0


class ServeOracle:
    """numpy reference of the served table after each prefix of the write
    stream: the base's counts by ``np.bincount`` (its keys lie in [0, N);
    values = row ids), its rows of the ``wanted`` keys (those a retrieve
    asks for) in one stable sort, then the applied inserts, the delete and
    the upsert in submission order."""

    def __init__(self, keys, n_keys: int, wanted):
        import numpy as np

        self.n_keys = n_keys
        self.tally = np.bincount(keys, minlength=n_keys).astype(np.int32)
        mask = np.zeros(n_keys, bool)
        mask[wanted[wanted < n_keys]] = True
        rows = np.flatnonzero(mask[keys])
        order = np.argsort(keys[rows], kind="stable")
        self.sorted_keys, self.rows = keys[rows][order], rows[order].astype(np.int64)
        self.ops = []  # ("insert" | "delete" | "upsert", sorted keys, values in that order)

    def add(self, kind, keys, values=None):
        import numpy as np

        order = np.argsort(keys, kind="stable")
        self.ops.append((kind, keys[order], None if values is None else values[order]))

    @staticmethod
    def _runs(sorted_keys, q):
        import numpy as np

        lo = np.searchsorted(sorted_keys, q, "left")
        return lo, np.searchsorted(sorted_keys, q, "right") - lo

    def count(self, q, applied: int):
        import numpy as np

        inside = q < self.n_keys
        c = np.where(inside, self.tally[np.where(inside, q, 0)], 0).astype(np.int64)
        for kind, keys, _ in self.ops[:applied]:
            hit = self._runs(keys, q)[1]
            if kind == "insert":
                c = c + hit
            elif kind == "delete":
                c = np.where(hit > 0, 0, c)
            else:  # upsert: its keys are distinct, one row each after it
                c = np.where(hit > 0, 1, c)
        return c

    def values(self, k, applied: int) -> list:
        """The sorted values of a wanted key ``k`` after ``applied`` writes."""
        lo, n = self._runs(self.sorted_keys, k)
        vals = list(self.rows[lo: lo + n])
        for kind, keys, v in self.ops[:applied]:
            lo, n = self._runs(keys, k)
            if kind == "insert":
                vals += list(v[lo: lo + n])
            elif n:
                vals = [] if kind == "delete" else list(v[lo: lo + n])
        return sorted(int(x) for x in vals)


def serve_requests(rng, keys, n_keys: int, hot: int, count: int):
    """``count`` requests of ``SERVE_REQ_SIZES`` keys: 90 % drawn from the
    base's rows, 10 % absent (>= N, never the hot key)."""
    import numpy as np

    out = []
    for size in rng.integers(SERVE_REQ_SIZES[0], SERVE_REQ_SIZES[1] + 1, size=count):
        absent = rng.random(size) < SERVE_ABSENT
        req = keys[rng.integers(0, keys.shape[0], size=size)].astype(np.uint32)
        far = rng.integers(n_keys + 1024, 2**32 - 2, size=size, dtype=np.uint64).astype(np.uint32)
        req[absent] = far[absent]
        assert not (req == hot).any()
        out.append(req)
    return out


def _pctl(a, p):
    import numpy as np

    return float(np.percentile(np.asarray(a), p)) if len(a) else None


def run_serve_table(n_shards: int, n_keys: int, seed: int, device, log) -> dict:
    """The table server under load: a base of N uint32 keys (uniform in [0,
    N), values = row ids) behind ``TableServer`` and ``AsyncFrontend``,
    warmed, then four readers, a per-layer retrieve thread and one writer
    at once; every response is held against the oracle at its seqno."""
    import threading

    import numpy as np
    import torch

    from repro_torch import DistributedHashTable, retrieval_to_lists
    from repro_torch.kernels import build
    from repro_torch.obs import parse_prometheus, render_prometheus
    from repro_torch.serve_table import AsyncFrontend, CompactionPolicy, MicroBatcher, TableServer
    from repro_torch.utils import cdiv, on_stream

    on_card = device.type == "cuda"
    label = f"serve-table D={n_shards}"
    t_phase = time.perf_counter()
    if on_card:
        sync(device)  # the phase may be the process's first use of the card
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(seed + 2100 + n_shards)
    keys = rng.integers(0, n_keys, size=n_keys, dtype=np.uint32)
    values = np.arange(n_keys, dtype=np.int32)
    hot = n_keys + 7
    reader_reqs = [serve_requests(np.random.default_rng(seed + 31 * r + n_shards), keys, n_keys,
                                  hot, SERVE_REQUESTS // SERVE_READERS)
                   for r in range(SERVE_READERS)]
    groups = serve_requests(np.random.default_rng(seed + 977 + n_shards), keys, n_keys, hot,
                            SERVE_GROUPS * SERVE_GROUP)
    hot_req = np.concatenate([np.array([hot], np.uint32),
                              np.concatenate(reader_reqs[0])[: 128 * n_shards - 1]])
    oracle = ServeOracle(keys, n_keys, np.concatenate(groups + [hot_req]))
    groups = [groups[i: i + SERVE_GROUP] for i in range(0, len(groups), SERVE_GROUP)]
    data_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    table = DistributedHashTable(num_shards=n_shards, hash_range=n_keys, device=device,
                                 tombstone_capacity=SERVE_TOMBSTONES,
                                 capacity_slack=SERVE_CAPACITY_SLACK)
    server = TableServer(table, keys, values, write_bucket=SERVE_WRITE_BUCKET,
                         policy=CompactionPolicy(max_delta_depth=8, fold_k=2),
                         batcher=MicroBatcher(table, min_bucket=SERVE_BUCKETS[0]))
    build_s = time.perf_counter() - t0

    # Retrieve caps per bucket: one counts round on a sample of base rows
    # (every key present), with 2x headroom, rounded up to powers of two.
    state0 = server.current().state
    caps = {}
    for b in SERVE_BUCKETS:
        seg, out = table.plan_caps(state0, keys[rng.integers(0, n_keys, size=b)])
        caps[b] = (1 << (2 * out - 1).bit_length(), 1 << (2 * seg - 1).bit_length())
    del state0
    t0 = time.perf_counter()
    warm = server.warm(buckets=SERVE_BUCKETS, depths=range(9), fold_horizon=SERVE_FOLD_HORIZON,
                       retrieve_caps=caps, per_layer_counts=(False, True))
    warm_s = time.perf_counter() - t0
    library_after_warm = dict(build.LIBRARY_EVENTS)
    log(f"{label}: warmed {warm.entries} grid entries in {warm_s:.3f} s (caps {caps}; "
        f"profiled rounds {sorted({c.all_to_alls for c in warm.profiles})})")
    check(all(c.all_to_alls == 2 for c in warm.profiles), f"{label}: a warmed executor "
          f"makes other than 2 exchange rounds: {[c.as_dict() for c in warm.profiles]}")

    # The write stream: 8 inserts of 2^16 keys (512 copies of the hot key in
    # each), a delete of 2^12 base keys, an upsert of 2^12 other base keys.
    writes = []
    for i in range(SERVE_INSERTS):
        k = rng.integers(0, n_keys, size=SERVE_WRITE_BUCKET, dtype=np.uint32)
        k[rng.choice(SERVE_WRITE_BUCKET, SERVE_HOT_REPEATS, replace=False)] = hot
        writes.append(("insert", k, ((1 << 28) + i * SERVE_WRITE_BUCKET
                                     + np.arange(SERVE_WRITE_BUCKET)).astype(np.int32)))
    present = np.unique(keys[rng.choice(n_keys, 2 * (SERVE_DELETES + SERVE_UPSERTS),
                                        replace=False)])
    present = rng.permutation(present)[: SERVE_DELETES + SERVE_UPSERTS]
    writes.append(("delete", present[:SERVE_DELETES], None))
    ups = present[SERVE_DELETES:]
    writes.append(("upsert", ups, ((1 << 29) + np.arange(ups.shape[0])).astype(np.int32)))
    for kind, k, v in writes:
        oracle.add(kind, k, v)

    applied_at = {0: 0}  # seqno -> writes applied when it was published
    real_publish = server.registry.publish

    def publish(state, ready=None):
        snap = real_publish(state, ready)
        applied_at[snap.seqno] = int(server.metrics_registry.snapshot().value(
            "serve_writes_applied_total"))
        return snap

    server.registry.publish = publish

    fe = AsyncFrontend(server, linger=0.002, flush_keys=4096, write_backlog=64)
    phase2 = threading.Event()  # the inserts are published: the fold is next
    errors, responses, retrieved, resolved = [], [], [], {}
    lock = threading.Lock()
    build.LAUNCHES.clear()
    events0 = dict(build.LIBRARY_EVENTS)

    def reader(r):
        try:
            prng = np.random.default_rng(seed + 5000 + r)
            reqs = reader_reqs[r]
            for i, req in enumerate(reqs):
                if i == len(reqs) // 2:
                    check(phase2.wait(300), f"{label}: the inserts never published")
                t_sub = time.perf_counter()
                fut = fe.submit_query(req, timeout=60)

                def done(f, req=req, t_sub=t_sub):
                    with lock:
                        resolved[id(f)] = resolved.get(id(f), 0) + 1
                        responses.append((req, f, t_sub, time.perf_counter()))

                fut.add_done_callback(done)
                time.sleep(prng.exponential(SERVE_PACING_S))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"reader {r}: {type(e).__name__}: {e}")

    def retriever():
        try:
            prng = np.random.default_rng(seed + 6000)
            for i, group in enumerate(groups):
                if i == len(groups) // 2:
                    check(phase2.wait(300), f"{label}: the inserts never published")
                res, seqno = server.retrieve_many(group, per_layer_counts=True)
                retrieved.append((group, res, seqno))
                time.sleep(prng.exponential(SERVE_GROUP_GAP_S))
        except Exception as e:  # noqa: BLE001
            errors.append(f"retrieve: {type(e).__name__}: {e}")

    def writer():
        try:
            for kind, k, v in writes[:SERVE_INSERTS]:
                fe.submit_insert(k, v, timeout=300)
            deadline = time.monotonic() + 300
            while len(server.current().state.deltas) < SERVE_INSERTS:
                check(time.monotonic() < deadline and server._last_error is None,
                      f"{label}: the inserts did not publish ({server._last_error})")
                time.sleep(0.001)
            phase2.set()
            fe.submit_delete(writes[SERVE_INSERTS][1], timeout=300)
            fe.submit_upsert(writes[SERVE_INSERTS + 1][1], writes[SERVE_INSERTS + 1][2],
                             timeout=300)
        except Exception as e:  # noqa: BLE001
            errors.append(f"writer: {type(e).__name__}: {e}")
            phase2.set()

    base_event = None
    if on_card:
        sync(device)
        base_event = torch.cuda.Event(enable_timing=True)
        base_event.record(server.batcher.stream)
    t_traffic = time.perf_counter()
    fe.start()
    threads = [threading.Thread(target=reader, args=(r,), name=f"smoke-reader-{r}")
               for r in range(SERVE_READERS)]
    threads += [threading.Thread(target=retriever, name="smoke-retrieve"),
                threading.Thread(target=writer, name="smoke-writer")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), f"{label}: thread {t.name} did not finish")
    futures = [f for _, f, _, _ in responses]
    server.drain(timeout=300)
    fe.stop()
    if on_card:
        sync(device)
    traffic_s = time.perf_counter() - t_traffic
    launches = dict(build.LAUNCHES)
    check(not errors, f"{label}: {errors[:3]}")
    st = server.stats()
    check(st.last_error is None, f"{label}: last_error {st.last_error}")
    check(st.skew_fallbacks == 0, f"{label}: {st.skew_fallbacks} skew fallbacks")
    check(st.shadow.num_dropped == 0, f"{label}: the stack dropped {st.shadow.num_dropped} rows")
    check(dict(build.LIBRARY_EVENTS) == events0 == library_after_warm,
          f"{label}: the kernel library was built or loaded after warm()")
    fst = fe.stats()
    check(fst.submitted == fst.completed == SERVE_REQUESTS and fst.failed == 0,
          f"{label}: front end {fst}")
    check(len(responses) == SERVE_REQUESTS and all(v == 1 for v in resolved.values())
          and len(resolved) == SERVE_REQUESTS, f"{label}: a future resolved twice or never")
    check(st.warmup.aot_misses == 0, f"{label}: {st.warmup.aot_misses} reads missed the grid")

    # Every response against the oracle at the seqno it reports.
    n_keys_served = 0
    for req, fut, _, _ in responses:
        r = fut.result()
        check(r.seqno in applied_at, f"{label}: unknown seqno {r.seqno}")
        check(np.array_equal(np.asarray(r.counts), oracle.count(req, applied_at[r.seqno])),
              f"{label}: query counts at seqno {r.seqno} differ from the oracle")
        n_keys_served += req.shape[0]
    for group, res, seqno in retrieved:
        applied = applied_at[seqno]
        for req, (vals, lc) in zip(group, res):
            want = oracle.count(req, applied)
            check(lc.shape == (req.shape[0], lc.shape[1]) and (lc >= 0).all()
                  and np.array_equal(lc.sum(1), want),
                  f"{label}: per-layer counts at seqno {seqno} do not sum to the counts")
            for k, v in zip(req, vals):
                check(sorted(np.asarray(v).tolist()) == oracle.values(k, applied),
                      f"{label}: retrieved values of key {int(k)} at seqno {seqno} differ")
    final = applied_at[server.current().seqno]
    check(final == len(writes), f"{label}: {final} of {len(writes)} writes applied")

    # Exchange rounds and launches of every read execution and fold.
    timeline = list(server.batcher.timeline)
    for rec in timeline:
        check(rec.fused and rec.rounds == rec.budget == 2,
              f"{label}: a {rec.kind} execution made {rec.rounds} exchange rounds, want 2")
        if on_card and rec.kind == "retrieve":
            check(rec.launches.get("csr_gather_owners", 0) == 1
                  and rec.launches.get("csr_gather_queriers", 0) == 1,
                  f"{label}: a retrieve batch launched {rec.launches}")
    folds = list(server.fold_log)
    check(any(f.kind == "fold" for f in folds), f"{label}: no incremental fold ran")
    check(all(f.rounds == 0 for f in folds if f.kind == "fold"),
          f"{label}: an incremental fold made exchange rounds: {[f.rounds for f in folds]}")
    if on_card:
        for name in PALLAS_GATHERS + ("bucket_probe",):
            check(launches.get(name, 0) == 0, f"{label}: the server's path launched {name}")
        for name in READ_PATH_KERNELS:
            check(launches.get(name, 0) > 0, f"{label}: kernel {name} never launched")

    # Reads during a fold, judged with CUDA events on the read stream and
    # the fold stream (times from one event recorded before the traffic):
    # served during it = the read's kernels ran while the fold's did (and its
    # dispatch overlapped the fold on the host); waited = dispatched while
    # the fold's kernels still ran, yet started on its own stream only after
    # they ended, as a read queued behind the fold would.  "nested" reads
    # started and ended on the card inside the fold.
    during, waited, fold_rows = [], [], []
    at = (lambda e: base_event.elapsed_time(e)) if on_card else None
    for f in folds:
        host = [r for r in timeline if r.t0 < f.t_ready and r.t1 > f.t0]
        if on_card:
            fs, fe_ = at(f.start), at(f.end)
            inside = [r for r in host if at(r.start) < fe_ and at(r.end) > fs]
            nested = [r for r in inside if at(r.start) >= fs and at(r.end) <= fe_]
            waited += [r for r in host if r.t0 < f.t_ready - 1e-3 and at(r.start) > fe_]
        else:
            inside, nested = host, []
        during += inside
        fold_rows.append({"kind": f.kind, "background": f.background, "pause_s": f.t1 - f.t0,
                          "device_ms": (fe_ - fs) if on_card else None,
                          "reads_during": len(inside), "reads_nested": len(nested),
                          "rounds": f.rounds})
    log(f"{label}: folds {json.dumps(fold_rows)}")
    check(during, f"{label}: no read was served while a fold was in flight")
    check(not waited, f"{label}: {len(waited)} reads during the fold waited for it")

    # The hot key through the capacity-doubling retries from a quarter of its need.
    state = server.current().state
    with on_stream(server.batcher.stream):
        seg_need, out_need = table.plan_caps(state, hot_req)
        start = (cdiv(out_need, 4), cdiv(seg_need, 4))
        auto = table.retrieve_auto(state, hot_req, out_capacity=start[0], seg_capacity=start[1],
                                   max_retries=2)
        join = table.inner_join_auto(state, hot_req, out_capacity=start[0],
                                     seg_capacity=start[1], max_retries=2)
        check(int(auto.num_dropped) == 0 and int(join.num_dropped) == 0,
              f"{label}: the *_auto calls still drop after 2 doublings")
        lists = retrieval_to_lists(auto)
        pairs = join_pairs(join)
    want_hot = oracle.values(hot, final)
    check(len(want_hot) == SERVE_INSERTS * SERVE_HOT_REPEATS and sorted(lists[0].tolist()) == want_hot,
          f"{label}: retrieve_auto of the hot key differs from the oracle")
    want_pairs = []
    for i, k in enumerate(hot_req):
        check(sorted(lists[i].tolist()) == oracle.values(k, final),
              f"{label}: retrieve_auto of key {int(k)} differs from the oracle")
        want_pairs += [(i, v) for v in oracle.values(k, final)]
    check(np.array_equal(pairs, sort_pairs(np.array([p[0] for p in want_pairs], np.int64),
                                           np.array([p[1] for p in want_pairs], np.int64))),
          f"{label}: inner_join_auto pairs differ from the oracle")

    # The registry, scraped back from its Prometheus text.
    scraped = parse_prometheus(render_prometheus(server.metrics()))
    for name, want in (("aot_misses_total", 0), ("batch_exchange_budget_misses_total", 0),
                       ("maintenance_fold_budget_misses_total", 0), ("serve_dropped_rows", 0),
                       ("serve_skew_fallbacks", 0), ("frontend_failed_total", 0),
                       ("frontend_completed_total", SERVE_REQUESTS),
                       ("serve_reads_total", SERVE_GROUPS * SERVE_GROUP)):
        check(scraped.get((name, ()), 0) == want,
              f"{label}: scraped {name} = {scraped.get((name, ()))}, want {want}")

    snap = server.metrics()
    lat_ms = [(t1 - t0) * 1e3 for _, _, t0, t1 in responses]
    phases = {}
    for phase in ("admission", "linger", "dispatch", "device", "scatter"):
        h = snap.histogram("trace_phase_seconds", {"phase": phase})
        phases[phase] = {"count": h.count, "p50_ms": h.p50 * 1e3, "p99_ms": h.p99 * 1e3}
    by_bucket = {}
    for rec in timeline:
        row = by_bucket.setdefault(f"{rec.kind} {rec.bucket}", {"batches": 0, "device_ms": [],
                                                               "launches": []})
        row["batches"] += 1
        row["launches"].append(sum(rec.launches.values()))
        if on_card:
            row["device_ms"].append(rec.start.elapsed_time(rec.end))
    for row in by_bucket.values():
        row["device_ms_p50"] = _pctl(row.pop("device_ms"), 50)
        row["launches_p50"] = _pctl(row.pop("launches"), 50)
    first_sub = min(t0 for _, _, t0, _ in responses)
    last_done = max(t1 for _, _, _, t1 in responses)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    res = {
        "path": "serve-table",
        "shards": n_shards,
        "keys": n_keys,
        "requests": SERVE_REQUESTS,
        "retrieve_groups": SERVE_GROUPS,
        "keys_served": n_keys_served,
        "latency_ms": {"p50": _pctl(lat_ms, 50), "p99": _pctl(lat_ms, 99),
                       "p999": _pctl(lat_ms, 99.9)},
        "keys_per_s": n_keys_served / (last_done - first_sub),
        "tracer_phases": phases,
        "folds": fold_rows,
        "reads_during_folds": len(during),
        "warm_s": warm_s,
        "grid_entries": warm.entries,
        "caps": {str(b): c for b, c in caps.items()},
        "by_bucket": by_bucket,
        "data_s": data_s,
        "build_s": build_s,
        "traffic_s": traffic_s,
        "aot_hits": st.warmup.aot_hits,
        "seqnos": len(applied_at),
        "launches": launches,
        "peak_bytes": peak,
    }
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"path serve-table D={n_shards} N={n_keys}: " + json.dumps(res))
    run = {"result": res, "table": table, "state": state, "server": server,
           "batch": to_device(np.concatenate(reader_reqs[1])[: SERVE_BUCKETS[-1]], device),
           "caps": caps[SERVE_BUCKETS[-1]]}
    return run


def check_serve_kernels(run: dict, device, log) -> list:
    """Kernels 3-4 against their twins on one server retrieve batch of 4096
    keys at the final depth, with the server's capacities for that bucket."""
    from repro_torch.kernels import csr_gather

    table, state = run["table"], run["state"]
    out_cap, seg_cap = run["caps"]
    inputs = gather_inputs(table, state, run["batch"], caps=(out_cap, seg_cap))
    path, shards = run["result"]["path"], run["result"]["shards"]
    launches = run["result"]["launches"]
    rows = []
    a = inputs["csr_gather_owners"]
    owner_args = (a["starts"], a["counts"], a["tables"], a["capacity"])
    rows.append(kernel_row(
        "csr_gather_owners", {"path": path, "shards": shards,
                              "launches": launches.get("csr_gather_owners", 0)},
        f"starts/counts={tuple(a['counts'].shape)} seg_capacity={a['capacity']} (one server "
        f"retrieve batch of {run['batch'].shape[0]} keys at depth {len(state.deltas)})",
        lambda: csr_gather.csr_gather_owners(*owner_args),
        lambda: csr_gather.csr_gather_owners_plain(*owner_args),
        int_bounds(owners_work(a)), device, log, timing=PROBE_TIMING))
    a = inputs["csr_gather_queriers"]
    querier_args = (a["starts"], a["counts"], a["table"], a["capacity"])
    rows.append(kernel_row(
        "csr_gather_queriers", {"path": path, "shards": shards,
                                "launches": launches.get("csr_gather_queriers", 0)},
        f"starts/counts={tuple(a['counts'].shape)} table={tuple(a['table'].shape)} "
        f"capacity={a['capacity']} (the same batch)",
        lambda: csr_gather.csr_gather_queriers(*querier_args),
        lambda: csr_gather.csr_gather_queriers_plain(*querier_args),
        int_bounds(queriers_work(a)), device, log, timing=PROBE_TIMING))
    return rows


# ---------------------------------------------------------------------------
# The table's users: the single-card API, hot keys, the KV cache, dedup
# ---------------------------------------------------------------------------

INTERSECT_KEYS = 1 << 22  # the second graph of intersect_join_size
HOT_BASE_KEYS = 1 << 24
HOT_BATCH = 1 << 20  # one insert of key_of(rank), ranks zipfian over 2^20
HOT_THETAS = (0.99, 1.2)
HOT_REPLICAS = 4
HOT_SLACK = 2.0  # the reference test's capacity slack
KV_OPS = 1 << 19  # ops per workload letter
KV_BATCH = 1 << 13  # ops per generator batch
KV_SCAN_LEN = 16
KV_THETA = 0.99
KV_TOMBSTONES = 1 << 17
# D = 8: the zipfian reads of a 2^13-op batch put more than the default slack
# of 1.25 allows into one (source, owner) dispatch slot (the phase prints the
# largest share of each letter, ``dispatch_share_max``); 2.5 keeps them in.
KV_SLACK = {1: 1.25, 8: 2.5}
KV_TTL_KEYS = 1 << 16
KV_TTL = 4
DEDUP_ROWS = 1 << 20
DEDUP_SEQ = 128
DEDUP_VOCAB = 151_936  # qwen3-4b's vocab
DEDUP_DUP_RATE = 0.1
DEDUP_SHARDS = 8
DEDUP_HASH_RANGE = 1 << 20
LOADER_BATCH = 1 << 16
LOADER_STEPS = 4


def scoped_call(fn, device):
    """``(result, seconds, scope)``: one call synchronised on both sides
    (``wall``), its exchange rounds and launches counted on this thread."""
    from repro_torch import counting

    with counting.scoped() as scope:
        out, secs = wall(fn, device)
    return out, secs, scope


def add_launches(total: dict, scope) -> None:
    for name, n in scope.launches.items():
        total[name] = total.get(name, 0) + n


def phase_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def first_values(pairs, n: int):
    """The smallest value per query row of sorted ``(query row, value)``
    pairs, -1 for rows with none: the single-card ``lookup_first`` oracle
    (the first row of a key's run is its smallest row id)."""
    import numpy as np

    out = np.full(n, -1, np.int64)
    rows = pairs[:, 0]
    head = np.ones(rows.shape[0], bool)
    head[1:] = rows[1:] != rows[:-1]
    out[rows[head]] = pairs[head, 1]
    return out


def csr_pairs(offsets, values):
    """``(query row, value)`` pairs of one CSR, sorted."""
    import numpy as np

    off = offsets.cpu().numpy().astype(np.int64)
    qidx = np.repeat(np.arange(off.shape[0] - 1, dtype=np.int64), np.diff(off))
    return sort_pairs(qidx, values[: off[-1]].cpu().numpy().astype(np.int64))


def run_hashgraph_single(n_keys: int, seed: int, device, log) -> dict:
    """The single-card API at the read run's size: ``hashgraph.build`` of N
    uniform keys (the read run's draw; values = row ids, ``table_size =
    N``), ``query_count_sorted`` and ``contains`` of the N keys plus 2^20
    absent ones, and on the 2^22-key retrieve batch ``lookup_first``,
    ``retrieve`` and ``inner_join`` (capacity from one counts call), then
    ``intersect_join_size`` against a graph of 2^22 keys from [0, 2N).
    Every output against the numpy oracle, and the counts and value
    multisets against a D = 1 ``DistributedHashTable`` on the same keys;
    that table's ``build_query_hashgraph_sharded`` of the 2^22 keys holds
    each once and joins with the graph to the oracle's size."""
    import numpy as np
    import torch

    from repro_torch import DistributedHashTable
    from repro_torch.core import hashgraph, multi_hashgraph

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n_keys, dtype=np.uint32)
    absent = rng.integers(n_keys, 2**32 - 1, size=ABSENT_QUERIES, dtype=np.uint64).astype(np.uint32)
    queries = np.concatenate([keys, absent])
    batch = rng.integers(0, n_keys, size=RETRIEVE_QUERIES, dtype=np.uint32)
    second = rng.integers(0, 2 * n_keys, size=INTERSECT_KEYS, dtype=np.uint32)
    keys_dev, queries_dev, batch_dev, second_dev = (
        to_device(a, device) for a in (keys, queries, batch, second))
    label = f"hashgraph-1 N={n_keys}"
    launches, seconds, rounds = {}, {}, {}

    def call(name, fn):
        out, secs, scope = scoped_call(fn, device)
        add_launches(launches, scope)
        seconds[name], rounds[name] = secs, scope.exchange_rounds
        return out

    reset_peak(device)
    hg = call("build", lambda: hashgraph.build(keys_dev, n_keys))
    counts = call("query_count_sorted", lambda: hashgraph.query_count_sorted(hg, queries_dev))
    present = call("contains", lambda: hashgraph.contains(hg, queries_dev))
    first = call("lookup_first", lambda: hashgraph.lookup_first(hg, batch_dev))
    cap = call("counts round", lambda: int(hashgraph.query_count_sorted(hg, batch_dev).sum()))
    offsets, values, dropped = call(
        "retrieve", lambda: hashgraph.retrieve(hg, batch_dev, capacity=cap))
    join = call("inner_join", lambda: hashgraph.inner_join(hg, batch_dev, capacity=cap))
    hg2 = call("build 2^22", lambda: hashgraph.build(second_dev, INTERSECT_KEYS))
    size = call("intersect_join_size", lambda: int(hashgraph.intersect_join_size(hg, hg2)))
    peak = phase_peak(device)

    oracle = Oracle(keys, np.arange(n_keys, dtype=np.int64), n_keys)
    want_counts = oracle.count(queries)
    got_counts = counts.cpu().numpy()
    check(np.array_equal(got_counts, want_counts), f"{label}: query_count_sorted differs")
    check(np.array_equal(present.cpu().numpy(), want_counts > 0), f"{label}: contains differs")
    want_pairs = oracle.pairs(batch)
    check(np.array_equal(first.cpu().numpy(), first_values(want_pairs, batch.shape[0])),
          f"{label}: lookup_first differs from the smallest row id")
    check(cap == want_pairs.shape[0] and int(dropped) == 0,
          f"{label}: retrieve capacity {cap}, dropped {int(dropped)}")
    got_pairs = csr_pairs(offsets, values)
    check(np.array_equal(got_pairs, want_pairs), f"{label}: retrieved value multisets differ")
    qidx, jvals, nres, jdrop = join
    n_res = int(nres)
    check(n_res == cap and int(jdrop) == 0, f"{label}: join results {n_res}, dropped {int(jdrop)}")
    check(np.array_equal(sort_pairs(qidx[:n_res].cpu().numpy(), jvals[:n_res].cpu().numpy()),
                         want_pairs), f"{label}: join pairs differ")
    check(size == int(oracle.count(second).sum()), f"{label}: intersect_join_size {size}")
    check(all(r == 0 for r in rounds.values()), f"{label}: exchange rounds {rounds}")
    del present, first, join, hg2
    # The same keys through the D = 1 table: counts and value multisets.
    table = DistributedHashTable(num_shards=1, hash_range=n_keys, device=device)
    state = table.init(keys_dev)
    check(torch.equal(table.query(state, queries_dev), counts),
          f"{label}: the D = 1 table's counts differ from the single-card graph's")
    check(np.array_equal(retrieval_pairs(table.retrieve(state, batch_dev)), got_pairs),
          f"{label}: the D = 1 table's value multisets differ from the single-card graph's")
    # The paper's query phase 1 through the table: a second graph of the
    # 2^22 keys routed and bucketed by the build's splits (kernel 1 hashes
    # them), holding each once, joined with the single-card graph.
    qg = multi_hashgraph.build_query_hashgraph_sharded(state.base, table._pack_queries(second_dev))
    held = qg.keys[~hashgraph.is_empty_key(qg.keys)].cpu().numpy().view(np.uint32)
    check(np.array_equal(np.sort(held), np.sort(second)),
          f"{label}: the query graph does not hold each of the {INTERSECT_KEYS} keys once")
    check(int(hashgraph.intersect_join_size(hg, qg)) == size,
          f"{label}: the query graph's join size differs from the oracle's {size}")
    del state, table, counts, qg, held
    if device.type == "cuda":
        for name in ("murmur_bucket", "csr_gather"):
            check(launches.get(name, 0) > 0, f"{label}: kernel {name} never launched")
        # The single-card retrieve and join gather through kernel 3's
        # Pallas-interface entry, once each; the table's entries never run.
        check_gather_launches(launches, {"csr_gather": 2, "csr_gather_owners": 0,
                                         "csr_gather_queriers": 0, "csr_gather_batched": 0},
                              label)
    res = {
        "path": "hashgraph-1",
        "shards": 1,
        "keys": n_keys,
        "queries": int(queries.shape[0]),
        "retrieve_queries": RETRIEVE_QUERIES,
        "retrieved_values": cap,
        "seconds": seconds,
        "build_keys_per_s": n_keys / seconds["build"],
        "query_keys_per_s": queries.shape[0] / seconds["query_count_sorted"],
        "contains_keys_per_s": queries.shape[0] / seconds["contains"],
        "retrieve_results_per_s": cap / seconds["retrieve"],
        "join_results_per_s": cap / seconds["inner_join"],
        "launches": launches,
        "peak_bytes": peak,
    }
    log(f"path hashgraph-1 N={n_keys}: " + json.dumps(res))
    run = {"result": res, "graph": hg, "keys": keys_dev, "batch": batch_dev}
    run["inputs"] = lambda: single_graph_inputs(run)
    return run


def single_graph_inputs(run: dict) -> dict:
    """Kernel 1 on the build's keys and kernel 3's Pallas-interface entry on
    the retrieve's runs (``offsets`` of the counts, starts, the values)."""
    from repro_torch.core import hashgraph
    from repro_torch.core.hashing import DEFAULT_SEED
    from repro_torch.kernels import ops

    hg, keys, batch = run["graph"], run["keys"], run["batch"]
    starts, counts = hashgraph.query_locate(hg, batch)
    offsets = ops.run_offsets(counts)
    return {
        "murmur_bucket": dict(keys=keys, table_size=hg.table_size, seed=DEFAULT_SEED,
                              n=keys.numel(), lanes=1),
        "csr_gather": dict(offsets=offsets, starts=starts, table=hg.values[0],
                           capacity=int(offsets[-1])),
    }


def hot_oracle_counts(base_tally, uniq, uniq_counts, q):
    """Counts of ``q`` over a base of keys in ``[0, len(base_tally))`` and a
    batch of distinct keys ``uniq`` (sorted) with their counts."""
    import numpy as np

    inside = q < base_tally.shape[0]
    out = np.where(inside, base_tally[np.where(inside, q, 0)], 0).astype(np.int64)
    pos = np.clip(np.searchsorted(uniq, q), 0, uniq.shape[0] - 1)
    return out + np.where(uniq[pos] == q, uniq_counts[pos], 0)


def dispatch_pair_max(table, state, flat, offsets=None) -> int:
    """The largest per-(source, destination) share of a frozen-splits delta
    build of ``flat`` keys (as the skew guard histograms it)."""
    import torch

    from repro_torch.core import hashing, partition

    d = table.num_shards
    k = flat.reshape(d, -1)
    dest = partition.destination_of(hashing.hash_to_buckets(k, table.hash_range, table.seed),
                                    state.base.hash_splits)
    if offsets is not None:
        dest = (dest + offsets.reshape(d, -1)) % d
    pair = torch.arange(d, device=k.device).unsqueeze(1) * d + dest
    return int(torch.bincount(pair.reshape(-1), minlength=d * d).max())


def run_hot_keys(seed: int, device, log) -> dict:
    """k-mer-style counting of heavily duplicated keys at D = 8: a base of
    2^24 uniform keys, then one insert of 2^20 keys ``key_of(rank)`` with
    ranks zipfian over 2^20 (theta 0.99, then 1.2, each on a fresh table)
    with ``replicate_hot_keys = 4`` and ``capacity_slack = 2.0``, reads
    after the insert, after ``fold_oldest(1)`` and after ``compact()``.
    Gates: hot keys registered, no skew fallback, no drops, counts of every
    distinct batch key and 2^20 base keys against the oracle at each step,
    R routed rounds a query, a probe query of one kernel 5 launch per layer
    per round whose counts never exceed the sorted read's, and the retrieve
    of the hot keys equal to the oracle's replica-0 rows.  The theta-1.2
    batch through a table without replication is the control (reported)."""
    import numpy as np
    import torch

    from repro_torch import DistributedHashTable
    from repro_torch.cache import ZipfianGenerator, key_of
    from repro_torch.core import maintenance
    from repro_torch.core.multi_hashgraph import default_capacity

    d, n = 8, HOT_BASE_KEYS
    rng = np.random.default_rng(seed + 2)
    base = rng.integers(0, n, size=n, dtype=np.uint32)
    base_dev = to_device(base, device)
    base_tally = np.bincount(base, minlength=n)
    others = base[rng.choice(n, ABSENT_QUERIES, replace=False)]
    kw = dict(num_shards=d, hash_range=n, device=device, capacity_slack=HOT_SLACK)
    runs, launches = {}, {}
    reset_peak(device)
    for theta in HOT_THETAS:
        label = f"hot-keys theta={theta}"
        ranks = ZipfianGenerator(HOT_BATCH, theta=theta, seed=seed + 3).sample(HOT_BATCH)
        keys = key_of(ranks)
        vals = (n + np.arange(HOT_BATCH)).astype(np.int32)
        uniq, inv, uniq_counts = np.unique(keys, return_inverse=True, return_counts=True)
        rank_in_key = np.empty(HOT_BATCH, np.int64)  # occurrence rank in row order
        order = np.argsort(inv, kind="stable")
        starts = np.cumsum(uniq_counts) - uniq_counts
        rank_in_key[order] = np.arange(HOT_BATCH) - np.repeat(starts, uniq_counts)
        keys_dev, vals_dev = to_device(keys, device), to_device(vals, device)
        table = DistributedHashTable(**kw, replicate_hot_keys=HOT_REPLICAS)
        probe = DistributedHashTable(**kw, replicate_hot_keys=HOT_REPLICAS, paper_faithful_probe=True)
        out, secs = {}, {}
        st0 = table.init(base_dev)
        pair_plain = dispatch_pair_max(table, st0, keys_dev)
        st1, secs["insert"], scope = scoped_call(lambda: st0.insert(keys_dev, vals_dev), device)
        add_launches(launches, scope)
        hot = sorted(k[0] for k in table.hot_keys)
        r = max(table.hot_keys.values(), default=1)
        check(hot and r == HOT_REPLICAS, f"{label}: hot keys {table.hot_keys}")
        check(table.skew_fallbacks == 0, f"{label}: {table.skew_fallbacks} skew fallbacks")
        probe.hot_keys = table.hot_keys  # the registry the inserting table filled
        hot_offsets = torch.from_numpy(np.where(
            np.isin(keys, np.array(hot, np.uint32)), rank_in_key % r, 0).astype(np.int32)).to(device)
        pair_hot = dispatch_pair_max(table, st0, keys_dev, hot_offsets)
        q = np.concatenate([uniq, others])
        q = np.concatenate([q, others[: (-q.shape[0]) % d]])
        q_dev = to_device(q, device)
        want = hot_oracle_counts(base_tally, uniq, uniq_counts, q)
        steps = (("insert", st1), ("fold_oldest", None), ("compact", None))
        state = st1
        for name, _ in steps:
            if name == "fold_oldest":
                state, secs[name], scope = scoped_call(lambda: maintenance.fold_oldest(st1, 1), device)
                add_launches(launches, scope)
                check(state.epoch == 0 and state.coherent, f"{label}: fold left {state.epoch}")
            elif name == "compact":
                folded = state
                state, secs[name], scope = scoped_call(lambda: folded.compact(), device)
                add_launches(launches, scope)
            check(int(state.num_dropped) == 0, f"{label}: {name} dropped {int(state.num_dropped)}")
            counts, secs[f"{name}: query"], scope = scoped_call(lambda: table.query(state, q_dev), device)
            add_launches(launches, scope)
            check(scope.exchange_rounds == 2 * r,
                  f"{label}: {name}: {scope.exchange_rounds} exchange rounds, want {2 * r}")
            check(np.array_equal(counts.cpu().numpy(), want),
                  f"{label}: {name}: counts differ from the oracle")
            out[f"{name}_query_keys_per_s"] = q.shape[0] / secs[f"{name}: query"]
            del counts
        # The paper's probe on the insert's state: one launch a layer a round;
        # its scan stops at max_probe words, so a hot key's bucket counts less.
        pcounts, secs["probe query"], scope = scoped_call(lambda: probe.query(st1, q_dev), device)
        add_launches(launches, scope)
        if device.type == "cuda":
            check(scope.launches.get("bucket_probe_layer", 0) == r * len(st1.layers),
                  f"{label}: {scope.launches.get('bucket_probe_layer', 0)} probe launches, "
                  f"want {r * len(st1.layers)}")
        pc = pcounts.cpu().numpy()
        check(bool((pc <= want).all()), f"{label}: the probe query over-counts")
        out["probe_undercounted_keys"] = int((pc < want).sum())
        out["probe_undercounted_hot_keys"] = int(np.isin(q[pc < want], hot).sum())
        # Retrieve the hot keys: replica 0 only, as in the reference.
        hq = np.array(hot + [int(x) for x in others[: (-len(hot)) % d]], np.uint32)
        hq_dev = to_device(hq, device)
        res, secs["retrieve hot"], scope = scoped_call(lambda: table.retrieve(st1, hq_dev), device)
        add_launches(launches, scope)
        if device.type == "cuda":
            check(scope.launches.get("csr_gather_owners", 0) == 1
                  and scope.launches.get("csr_gather_queriers", 0) == 1,
                  f"{label}: retrieve gather launches {dict(scope.launches)}")
        check(int(res.num_dropped) == 0, f"{label}: retrieve of the hot keys dropped")
        rep0 = (hot_offsets.cpu().numpy() == 0) & np.isin(keys, hq)
        pair_keys = np.concatenate([base, keys[rep0]])
        pair_vals = np.concatenate([np.arange(n), vals[rep0]]).astype(np.int64)
        want_pairs = _pairs_of(pair_keys, pair_vals, hq)
        check(np.array_equal(retrieval_pairs(res), want_pairs),
              f"{label}: the hot keys' retrieve differs from the oracle's replica-0 rows")
        out.update({
            "hot_keys": len(hot), "replicas": r, "head_copies": int(uniq_counts.max()),
            "distinct_keys": int(uniq.shape[0]),
            "slot": default_capacity(HOT_BATCH // d, d, HOT_SLACK),
            "pair_max_without_replication": pair_plain, "pair_max_with_replication": pair_hot,
            "hot_retrieved_values": int(want_pairs.shape[0]),
            "insert_keys_per_s": HOT_BATCH / secs["insert"], "seconds": secs,
        })
        log(f"{label}: " + json.dumps(out))
        runs[theta] = out
        if theta == HOT_THETAS[-1]:
            kernel_state = dict(table=table, probe=probe, state=st1, q=q_dev, hq=hq_dev,
                                keys=keys_dev, r=r)
        del st0, st1, state, folded, res, pcounts
    # Control: the theta-1.2 batch without replication takes the guard's fallback.
    control = DistributedHashTable(**kw)
    st = control.insert(control.init(base_dev), keys_dev, vals_dev)
    runs["control"] = {"skew_fallbacks": control.skew_fallbacks, "coherent": st.coherent,
                       "num_dropped": int(st.num_dropped)}
    log("hot-keys control (theta 1.2, no replication): " + json.dumps(runs["control"]))
    del st, control
    peak = phase_peak(device)
    if device.type == "cuda":
        for name in TABLE_KERNELS:
            check(launches.get(name, 0) > 0, f"hot-keys: kernel {name} never launched")
        check_gather_launches(launches, {}, "hot-keys")
    res = {"path": "hot-keys", "shards": d, "keys": n, "batch": HOT_BATCH, "runs": runs,
           "launches": launches, "peak_bytes": peak}
    run = {"result": res, **kernel_state}
    run["inputs"] = lambda: hot_key_inputs(run)
    return run


def _pairs_of(keys, values, queries):
    """Sorted ``(query row, value)`` pairs of ``queries`` over the rows
    ``(keys, values)`` (any uint32 keys; a stable sort of the queried rows)."""
    import numpy as np

    sel = np.isin(keys, queries)
    k, v = keys[sel], values[sel]
    order = np.argsort(k, kind="stable")
    k, v = k[order], v[order]
    lo, hi = np.searchsorted(k, queries, "left"), np.searchsorted(k, queries, "right")
    cnt = hi - lo
    qidx = np.repeat(np.arange(queries.shape[0], dtype=np.int64), cnt)
    pos = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(qidx.shape[0])
    return sort_pairs(qidx, v[pos])


def hot_key_inputs(run: dict) -> dict:
    """Kernel 1 and 2 on the hot batch's routing (its sharded keys), kernels
    3-4 on the retrieve of the hot keys (buckets of tens of thousands of
    one key's copies), kernel 5's layer entry on the delta layer of replica
    round 1 of the probe query (every query lands off its owner, in a
    clamped edge bucket)."""
    from repro_torch.core import multi_hashgraph as mh

    table, probe, state, r = run["table"], run["probe"], run["state"], run["r"]
    d = table.num_shards
    inputs = table_user_inputs(table, state, run["hq"])
    inputs.update(hash_inputs(table, run["keys"].reshape(d, -1)))
    q = run["q"].reshape(d, -1)
    routed = mh._route_queries_once(state.base, q, probe.capacity_slack, False, 1)
    layer = state.deltas[0]
    inputs["bucket_probe_layer"] = dict(
        rq=routed.rq, rh=routed.rh, lo=routed.lo,
        match_e=mh._tombstone_epochs(routed.rq, state.tombstones.index()),
        offsets=layer.local.offsets, keys=layer.local.keys, table_size=layer.local_range_cap,
        stride=layer.bucket_stride, epoch=1, max_probe=probe.max_probe, accumulate=False,
        what="replica round 1 of the probe query on the hot batch's delta layer",
    )
    return inputs


def key_index(keys):
    """Inverse of ``key_of``'s affine map mod 2^31 - 1: each key's insertion
    index (the KV oracle's row)."""
    import numpy as np

    p, a, b = (1 << 31) - 1, 1103515245, 12345
    inv = pow(a, -1, p)
    k = keys.astype(np.uint64)
    return (((k + np.uint64(p - b)) % np.uint64(p)) * np.uint64(inv) % np.uint64(p)).astype(np.int64)


def keep_last(idx, vals):
    """The last occurrence of each index in a batch (an upsert's winners)."""
    import numpy as np

    _, first = np.unique(idx[::-1], return_index=True)
    last = idx.shape[0] - 1 - first
    return idx[last], vals[last]


def histogram_delta(after, before):
    """The observations a registry histogram took between two snapshots."""
    import dataclasses as dc

    return dc.replace(after, count=after.count - before.count, sum=after.sum - before.sum,
                      counts=tuple(a - b for a, b in zip(after.counts, before.counts)))


def run_kv_cache(n_shards: int, n_keys: int, seed: int, device, log) -> dict:
    """YCSB A to F through one ``KVCache`` (N records loaded, theta 0.99,
    generator batches of 2^13 ops, 2^19 ops a letter, scans of 16 keys,
    ``tombstone_capacity = 2^17``, the default policy), then a TTL run:
    2^16 loaded keys put with ``ttl = 4``, read through ``now + 3`` and
    missing from ``now + 4``, and ``evict_expired()``.  The oracle is a
    numpy value array by insertion index (``key_index`` inverts
    ``key_of``).  Gates: every get, ``live_count`` after each letter, no
    drops, no skew fallback, one querier gather launch a get and one owner
    launch a routing round, at least 2^16 rows reclaimed."""
    import numpy as np

    from repro_torch import DistributedHashTable
    from repro_torch.cache import WORKLOADS, KVCache, YCSBWorkload, key_of

    d = n_shards
    label = f"kv-cache D={d}"
    table = DistributedHashTable(num_shards=d, hash_range=n_keys, device=device,
                                 tombstone_capacity=KV_TOMBSTONES, capacity_slack=KV_SLACK[d])
    w = YCSBWorkload(WORKLOADS["A"], n_keys, theta=KV_THETA, batch=KV_BATCH,
                     scan_len=KV_SCAN_LEN, seed=seed)
    reset_peak(device)
    cache, load_s = wall(lambda: KVCache(table, w.load_keys(), w.load_values()), device)
    extra = 6 * KV_OPS  # room for every insert the letters could make
    oracle = np.full(n_keys + extra, -1, np.int32)
    oracle[:n_keys] = w.load_values()
    launches, letters = {}, {}
    reg = cache.metrics_registry
    walls = {"get": [], "put": []}  # synchronised wall ms of each call in a letter
    shares = []  # each get's largest (source, owner) dispatch share / the balanced share

    def get(keys):
        if d > 1:
            q, _ = cache._pad_queries(keys)
            shares.append(dispatch_pair_max(table, cache.state, q) / -(-(q.shape[0] // d) // d))
        out, secs, scope = scoped_call(lambda: cache.get(keys), device)
        walls["get"].append(secs * 1e3)
        add_launches(launches, scope)
        rounds = 1 if cache.state.coherent else len(cache.state.layers)
        if device.type == "cuda":
            check(scope.launches.get("csr_gather_queriers", 0) == 1
                  and scope.launches.get("csr_gather_owners", 0) == rounds,
                  f"{label}: get launched {dict(scope.launches)}, want 1 querier and "
                  f"{rounds} owner launches")
        check(np.array_equal(out, oracle[key_index(keys)]), f"{label}: get differs from the oracle")

    def put(keys, vals, ttl=None):
        _, secs, scope = scoped_call(lambda: cache.put(keys, vals, ttl=ttl), device)
        walls["put"].append(secs * 1e3)
        add_launches(launches, scope)
        idx, v = keep_last(key_index(keys), vals)
        oracle[idx] = v

    sample = {}  # one read and one write batch, for --profile
    for letter in "ABCDEF":
        w.spec = WORKLOADS[letter]
        h_get, h_put = reg.histogram("kvcache_get_seconds").snapshot(), reg.histogram(
            "kvcache_put_seconds").snapshot()
        folds, evictions = cache.folds, cache.evictions
        walls["get"].clear()
        walls["put"].clear()
        shares.clear()
        t0 = time.perf_counter()
        kinds = {}
        for kind, keys, vals in w.batches(KV_OPS):
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind in ("read", "scan", "rmw"):
                get(keys)
                sample.setdefault(f"get ({kind})", keys)
            if kind in ("update", "insert", "rmw"):
                put(keys, vals)
                sample.setdefault(f"put ({kind})", (keys, vals))
        sync(device)
        secs = time.perf_counter() - t0
        live = cache.live_count()
        check(live == int((oracle >= 0).sum()), f"{label}: {letter}: live_count {live}")
        st = cache.stats()
        check(st.num_dropped == 0, f"{label}: {letter}: {st.num_dropped} rows dropped")
        check(table.skew_fallbacks == 0, f"{label}: {letter}: skew fallback")
        g = histogram_delta(reg.histogram("kvcache_get_seconds").snapshot(), h_get)
        p = histogram_delta(reg.histogram("kvcache_put_seconds").snapshot(), h_put)
        letters[letter] = {
            "ops_per_s": KV_OPS / secs, "seconds": secs, "calls": kinds,
            "get_p50_ms": g.p50 * 1e3 if g.count else None,
            "get_p99_ms": g.p99 * 1e3 if g.count else None,
            "put_p50_ms": p.p50 * 1e3 if p.count else None,
            "put_p99_ms": p.p99 * 1e3 if p.count else None,
            "gets": g.count, "puts": p.count,
            # The registry's buckets are coarse; these are each call's wall.
            "get_wall_p50_ms": _pctl(walls["get"], 50), "get_wall_p99_ms": _pctl(walls["get"], 99),
            "put_wall_p50_ms": _pctl(walls["put"], 50), "put_wall_p99_ms": _pctl(walls["put"], 99),
            "dispatch_share_max": max(shares, default=None),
            "folds": cache.folds - folds, "evictions": cache.evictions - evictions,
            "delta_depth": st.delta_depth, "live": live,
        }
        log(f"{label} N={n_keys} YCSB-{letter}: " + json.dumps(letters[letter]))
    # TTL: expiry exactly at now + ttl, then the eviction pass reclaims it.
    rng = np.random.default_rng(seed + 4)
    ttl_idx = rng.choice(n_keys, KV_TTL_KEYS, replace=False)
    ttl_keys = key_of(ttl_idx)
    ttl_vals = (1 << 30) + np.arange(KV_TTL_KEYS, dtype=np.int32)
    cache.evict_expired()  # an empty buffer holds the put's deletes and TTL entries
    now = cache.now
    put(ttl_keys, ttl_vals, ttl=KV_TTL)
    for t in range(KV_TTL + 1):
        cache.advance(now + t)
        if t == KV_TTL:
            oracle[ttl_idx] = -1
        get(ttl_keys)
    live_before = cache.live_count()
    check(live_before == int((oracle >= 0).sum()), f"{label}: TTL: live_count {live_before}")
    reclaimed, evict_s = wall(cache.evict_expired, device)
    check(reclaimed >= KV_TTL_KEYS, f"{label}: evict_expired reclaimed {reclaimed} rows")
    live = cache.live_count()
    check(live == int((oracle >= 0).sum()), f"{label}: after eviction live_count {live}")
    check(cache.stats().num_dropped == 0, f"{label}: TTL run dropped rows")
    peak = phase_peak(device)
    if device.type == "cuda":
        for name in READ_PATH_KERNELS:
            check(launches.get(name, 0) > 0, f"{label}: kernel {name} never launched")
        check_gather_launches(launches, {}, label)
    res = {"path": "kv-cache", "shards": d, "keys": n_keys, "load_s": load_s,
           "letters": letters, "ttl": {"reclaimed_rows": reclaimed, "evict_s": evict_s,
                                       "live": live}, "folds": cache.folds,
           "evictions": cache.evictions, "launches": launches, "peak_bytes": peak}
    log(f"{label} N={n_keys}: " + json.dumps({k: v for k, v in res.items() if k != "letters"}))
    keys = to_device(key_of(np.arange(0, n_keys, max(1, n_keys // (1 << 16)))[: 1 << 16]), device)
    run = {"result": res, "table": table, "state": cache.state, "batch": keys, "cache": cache,
           "sample": sample}
    run["inputs"] = lambda: table_user_inputs(run["table"], run["state"], run["batch"])
    return run


def kv_phases(run: dict) -> dict:
    """One get and one put of the run's first batches of each kind, on the
    final cache (a put runs the policy first, as every put does)."""
    cache, phases = run["cache"], {}
    for name, arg in run["sample"].items():
        if name.startswith("get"):
            phases[f"{name[:-1]}, {arg.shape[0]} keys)"] = lambda k=arg: cache.get(k)
        else:
            phases[f"{name[:-1]}, {arg[0].shape[0]} keys)"] = lambda kv=arg: cache.put(*kv)
    return phases


def table_user_inputs(table, state, batch) -> dict:
    """Kernels 1-2 on ``batch``'s sharded keys and kernels 3-4's owner and
    querier entries on its retrieve (the phases that read through the
    table run no Pallas-interface gather)."""
    inputs = {**hash_inputs(table, batch.reshape(table.num_shards, -1, *batch.shape[1:])),
              **gather_inputs(table, state, batch)}
    for name in PALLAS_GATHERS:
        inputs.pop(name)
    return inputs


def np_murmur3_rows(words, seed: int):
    """MurmurHash3_x86_32 of each row of uint32 words in numpy (the dedup
    oracle, independent of the port's hashing)."""
    import numpy as np

    u = np.uint32
    cols = np.ascontiguousarray(words.astype(np.uint32).T)
    h = np.full(cols.shape[1], seed & 0xFFFFFFFF, np.uint32)
    with np.errstate(over="ignore"):
        for k in cols:
            k = k * u(0xCC9E2D51)
            k = (k << u(15)) | (k >> u(17))
            k = k * u(0x1B873593)
            h ^= k
            h = (h << u(13)) | (h >> u(19))
            h = h * u(5) + u(0xE6546B64)
        h ^= u(4 * cols.shape[0])
        h ^= h >> u(16)
        h = h * u(0x85EBCA6B)
        h ^= h >> u(13)
        h = h * u(0xC2B2AE35)
        h ^= h >> u(16)
    return h


def first_rows_mask(fp):
    import numpy as np

    _, first = np.unique(fp, return_index=True)
    keep = np.zeros(fp.shape[0], bool)
    keep[first] = True
    return keep


def run_dedup(seed: int, device, log) -> dict:
    """Exact dedup of a training stream: 2^20 rows of 128 tokens from
    ``SyntheticCorpus(vocab_size=151_936, seq_len=128, dup_rate=0.1)`` drawn
    on the card, ``dedup_mask`` (D = 1) and ``dedup_mask_distributed`` on a
    ``DistributedHashTable(num_shards=8, hash_range=2^20)``, both against a
    numpy MurmurHash3 of each row and its first occurrences; then 4 steps
    of ``ShardedLoader(dedup="distributed", batch_size=2^16)``: kept rows
    equal to the corpus's, refills in the vocab, ``skip_to(2)`` replaying
    steps 2-3 bit for bit."""
    import numpy as np
    import torch

    from repro_torch import DistributedHashTable
    from repro_torch.core.hashing import DEFAULT_SEED
    from repro_torch.data import (ShardedLoader, SyntheticCorpus, dedup_mask,
                                  dedup_mask_distributed, sequence_fingerprints)

    label = "dedup"
    reset_peak(device)
    corpus = SyntheticCorpus(vocab_size=DEDUP_VOCAB, seq_len=DEDUP_SEQ, seed=seed,
                             dup_rate=DEDUP_DUP_RATE, device=device)
    toks, draw_s = wall(lambda: corpus.batch(0, DEDUP_ROWS), device)
    rows = toks[:, :-1]
    table = DistributedHashTable(num_shards=DEDUP_SHARDS, hash_range=DEDUP_HASH_RANGE,
                                 device=device)
    launches, seconds = {}, {}

    def call(name, fn):
        out, secs, scope = scoped_call(fn, device)
        add_launches(launches, scope)
        seconds[name] = secs
        return out

    fp = call("fingerprints", lambda: sequence_fingerprints(rows))
    mask = call("dedup_mask", lambda: dedup_mask(rows))
    dmask = call("dedup_mask_distributed", lambda: dedup_mask_distributed(table, rows))
    host = rows.cpu().numpy()
    want_fp = np_murmur3_rows(host, DEFAULT_SEED)
    check(np.array_equal(fp.cpu().numpy().view(np.uint32), want_fp),
          f"{label}: fingerprints differ from numpy's MurmurHash3")
    want = first_rows_mask(want_fp)
    check(np.array_equal(mask.cpu().numpy(), want), f"{label}: dedup_mask differs")
    check(np.array_equal(dmask.cpu().numpy(), want), f"{label}: dedup_mask_distributed differs")
    dups = int((~want).sum())
    del host, fp, mask, dmask, rows, toks
    loader = ShardedLoader(corpus, batch_size=LOADER_BATCH, dedup="distributed", dedup_table=table)
    batches = []
    for step in range(LOADER_STEPS):
        out = call(f"loader step {step}", lambda: loader.next_batch()["tokens"])
        raw = corpus.batch(step, LOADER_BATCH).cpu().numpy()
        keep = first_rows_mask(np_murmur3_rows(raw[:, :-1], DEFAULT_SEED))
        got = out.cpu().numpy()
        check(got.shape == raw.shape and np.array_equal(got[keep], raw[keep]),
              f"{label}: loader step {step}: kept rows differ from the corpus's")
        check(bool(((got[~keep] >= 0) & (got[~keep] < DEDUP_VOCAB)).all()),
              f"{label}: loader step {step}: refills outside the vocab")
        batches.append(out)
    loader.skip_to(2)
    for step in (2, 3):
        check(torch.equal(loader.next_batch()["tokens"], batches[step]),
              f"{label}: skip_to(2) does not replay step {step}")
    peak = phase_peak(device)
    if device.type == "cuda":
        for name in ("murmur_bucket", "bin_histogram"):
            check(launches.get(name, 0) > 0, f"{label}: kernel {name} never launched")
        check_gather_launches(launches, {}, label)
    res = {"path": "dedup", "shards": DEDUP_SHARDS, "rows": DEDUP_ROWS, "seq_len": DEDUP_SEQ,
           "duplicate_rows": dups, "draw_s": draw_s, "seconds": seconds,
           "fingerprint_rows_per_s": DEDUP_ROWS / seconds["fingerprints"],
           "mask_rows_per_s": DEDUP_ROWS / seconds["dedup_mask"],
           "distributed_mask_rows_per_s": DEDUP_ROWS / seconds["dedup_mask_distributed"],
           "launches": launches, "peak_bytes": peak}
    log("path dedup: " + json.dumps(res))
    keys = sequence_fingerprints(corpus.batch(0, LOADER_BATCH)[:, :-1])
    run = {"result": res, "table": table, "keys": keys.reshape(DEDUP_SHARDS, -1)}
    run["inputs"] = lambda: hash_inputs(run["table"], run["keys"])
    return run


# ---------------------------------------------------------------------------
# The table across processes (procs): one shard per rank of a process group
# ---------------------------------------------------------------------------
PROCS_KEYS = 1 << 26  # 2^24 a shard at world 4
PROCS_QUERIES = 1 << 22  # the reads' global batch
PROCS_WORLD = 4
PROCS_TIMEOUT_S = 300.0
PROCS_CHUNK = 4096  # elements a digest covers
PROCS_SAMPLES = 4096  # query rows a rank holds against the numpy oracle
# The table's users on the same ranks (launch/users_run.py, launch/serve_run.py):
# one zipfian hot-key insert of 2^20 at theta 1.2 with R = 4, YCSB A and F
# (theta 0.99, 2^13-op batches, 2^17 ops a letter) then 2^14 TTL puts with
# capacity_slack 2.5 as the kv-cache phase at D = 8, and the serve-table
# phase's server (its defaults) under 4 readers x 128 requests, each fold
# held 0.25 s first so that the gate sees read batches run while a fold is in
# flight (a fold of the pass takes 8-210 ms alone on an H100, under one read
# batch).
PROCS_USERS = {"hot_batch": 1 << 20, "kv_batch": 1 << 13, "kv_ops": 1 << 17,
               "kv_ttl_keys": 1 << 14}
PROCS_SERVE = {"fold_pause_s": 0.25}  # else ServeConfig's own sizes


def procs_config(seed: int, n_keys: int = PROCS_KEYS):
    """The pass ``repro_torch.launch.table_run`` drives (u32x1): N keys,
    ``PROCS_QUERIES`` reads, two inserts of N/8, delete and upsert batches
    of N/32 (replicated), tombstone capacity 4 x N/32."""
    from repro_torch.launch import table_run

    return table_run.SliceConfig(n_keys=n_keys, seed=seed, queries=PROCS_QUERIES)


def chunk_digests(t):
    """``(rows, chunks)`` int64 digests of a ``(rows, ...)`` tensor, one a
    run of ``PROCS_CHUNK`` elements of a row (position-weighted, on the
    tensor's device): equal rows give equal digests."""
    import torch

    x = t.reshape(t.shape[0], -1).to(torch.int64)
    pad = (-x.shape[1]) % PROCS_CHUNK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=-7)
    x = x.reshape(x.shape[0], -1, PROCS_CHUNK)
    pos = torch.arange(1, PROCS_CHUNK + 1, dtype=torch.int64, device=x.device)
    return ((x ^ (pos * 0x27D4EB2F165667C5)) * 0x165667B19E3779F9).sum(-1)


class DigestSink:
    """A ``table_run`` sink that keeps each output's chunk digests and its
    blocks on the host (to place a mismatch and feed the oracle)."""

    def __init__(self):
        self.digests, self.scalars, self.raw = {}, {}, {}

    def put(self, name, blocks):
        self.digests[name] = chunk_digests(blocks).cpu().numpy()
        self.raw[name] = blocks.detach().cpu().numpy()

    def scalar(self, name, value):
        self.scalars[name] = value


def procs_kernel_inputs(run: dict) -> dict:
    """A rank's kernel inputs from its own pass (built on every rank: the
    gathers' inputs need the exchange): its block of the base keys to
    kernels 1-2, the final state's retrieve gathers to 3-4, the probe
    query's base layer to kernel 5's layer entry."""
    from repro_torch.core import multi_hashgraph as mh

    table, probe, state, q = run["table"], run["probe"], run["state"], run["queries"]
    d, local = table.num_shards, table.group.local
    keys = run["data"]["keys"]
    n = keys.shape[0] // d
    rank = table.group.rank
    mine = keys[rank * n : (rank + local) * n]
    packed = table.schema.pack_keys(mine, table.device).reshape(local, -1)
    qt = table.schema.pack_keys(q, table.device)
    inputs = {**hash_inputs(table, packed), **gather_inputs(table, state, qt)}
    base = state.base
    qt = qt.reshape(local, -1)
    routed = mh._route_queries_once(base, qt, probe.capacity_slack)
    inputs["bucket_probe_layer"] = dict(
        rq=routed.rq, rh=routed.rh, lo=routed.lo,
        match_e=mh._tombstone_epochs(routed.rq, state.tombstones.index()),
        offsets=base.local.offsets, keys=base.local.keys, table_size=base.local_range_cap,
        stride=base.bucket_stride, epoch=0, max_probe=probe.max_probe, accumulate=False,
        what="the compacted state's probe query",
    )
    for name in ("csr_gather_batched", "csr_gather"):
        inputs.pop(name, None)  # the Pallas-interface rows stay with the stacked runs
    return inputs




def users_configs(seed: int, n_keys: int):
    """The users' pass and the server pass of the procs phase at ``n_keys``."""
    from repro_torch.launch import serve_run, users_run

    return (users_run.UsersConfig(n_keys=n_keys, seed=seed, **PROCS_USERS),
            serve_run.ServeConfig(n_keys=n_keys, seed=seed, **PROCS_SERVE))


class DigestOnlySink(DigestSink):
    """A sink that keeps the digests only (a mismatch names its chunk)."""

    def put(self, name, blocks):
        self.digests[name] = chunk_digests(blocks).cpu().numpy()


def first_digest_mismatch(digests: dict, want: dict, rank: int):
    """The first output whose digests differ from row ``rank`` of ``want``."""
    import numpy as np

    for name, w in want.items():
        got = digests.get(name)
        if got is None or got.shape[1:] != w.shape[1:]:
            return {"name": name, "why": "missing or of another shape"}
        diff = np.nonzero(got[0] != w[rank])[0]
        if diff.shape[0]:
            return {"name": name, "chunk": int(diff[0])}
    if set(digests) != set(want):
        return {"name": sorted(set(digests) ^ set(want))[0], "why": "not in both"}
    return None


def users_kernel_inputs(run: dict) -> dict:
    """A rank's kernel inputs from its hot-key part (built on every rank: the
    routing needs the exchange): its block of the hot batch to kernels 1-2,
    the hot keys' retrieve to 3-4, replica round 1 of the probe query on the
    delta layer to kernel 5's layer entry."""
    from repro_torch.core import multi_hashgraph as mh

    table, state = run["hot_table"], run["hot_state"]
    d, local, rank = table.num_shards, table.group.local, table.group.rank

    def mine(a):
        m = a.shape[0] // d
        return table.schema.pack_keys(a[rank * m: (rank + local) * m], table.device)

    inputs = gather_inputs(table, state, mine(run["hot_retrieve"]))
    for name in PALLAS_GATHERS:
        inputs.pop(name)
    inputs.update(hash_inputs(table, mine(run["hot_batch"]).reshape(local, -1)))
    routed = mh._route_queries_once(state.base, mine(run["hot_queries"]).reshape(local, -1),
                                    table.capacity_slack, False, 1)
    layer = state.deltas[0]
    inputs["bucket_probe_layer"] = dict(
        rq=routed.rq, rh=routed.rh, lo=routed.lo,
        match_e=mh._tombstone_epochs(routed.rq, state.tombstones.index()),
        offsets=layer.local.offsets, keys=layer.local.keys, table_size=layer.local_range_cap,
        stride=layer.bucket_stride, epoch=1, max_probe=table.max_probe, accumulate=False,
        what="replica round 1 of the hot batch's probe query, its delta layer",
    )
    return inputs


def procs_users_rank(group, ucfg, scfg, uref: dict, path: str, check_kernels_here: bool,
                     device) -> dict:
    """A rank's users' part: the hot-key and KV pass (digests against row
    ``rank`` of the stacked run, steps, kernel inputs; rank 0's kernels
    against their twins), then the server pass (its result and its final
    shadow's digests)."""
    import torch

    from repro_torch.launch import serve_run, users_run

    card = device.type == "cuda"
    rank = group.rank
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    sink = DigestOnlySink()
    t0 = time.perf_counter()
    run = users_run.run_users(ucfg, sink, group=group, device=device, keep_state=True)
    run["hot_batch"] = users_run.hot_data(ucfg)["batch"]
    users_s = time.perf_counter() - t0
    inputs = users_kernel_inputs(run)
    launches = {}
    for st in run["steps"].values():
        for k, n in st["launches"].items():
            launches[k] = launches.get(k, 0) + n
    rows = []
    if check_kernels_here and rank == 0:
        rows = check_kernels({"inputs": lambda: inputs, "result": {
            "path": path, "shards": group.size, "launches": launches}}, device,
            lambda m: print(m, flush=True))
    steps = run["steps"]
    del inputs, run
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    users_peak = torch.cuda.max_memory_allocated(device) if card else None
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    ssink = DigestOnlySink()
    t1 = time.perf_counter()
    serve = serve_run.run_server(scfg, ssink, group=group, device=device)
    serve_s = time.perf_counter() - t1
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return {"rank": rank, "users_steps": steps, "users_s": users_s, "users_peak": users_peak,
            "users_mismatch": first_digest_mismatch(sink.digests, uref["digests"], rank),
            "users_scalars": sink.scalars, "users_launches": launches, "users_rows": rows,
            "serve": serve, "serve_s": serve_s, "shadow": ssink.digests,
            "shadow_scalars": ssink.scalars,
            "serve_peak": torch.cuda.max_memory_allocated(device) if card else None}


def procs_users_reference(ucfg, shards: int, device, log) -> dict:
    """The users' pass stacked at ``shards``: digests, scalars, steps."""
    import torch

    from repro_torch.launch import users_run

    sink = DigestOnlySink()
    t0 = time.perf_counter()
    out = users_run.run_users(ucfg, sink, num_shards=shards, device=device)
    secs = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walls = {k: round(v["wall_s"] * 1e3, 3) for k, v in out["steps"].items()
             if not k.startswith("kv.") or k.endswith((".load", ".evict"))}
    log(f"procs-users stacked D={shards}: the pass in {secs:.1f} s, {len(sink.digests)} outputs; "
        "wall ms per step (the KV gets and puts summed below) " + json.dumps(walls))
    return {"digests": sink.digests, "scalars": sink.scalars, "steps": out["steps"],
            "seconds": secs}


def procs_users_check(label: str, ranks: list, uref: dict, scfg, device, log, card: bool) -> dict:
    """The users' part of every rank: the hot-key and KV outputs and
    scalars bit for bit its stacked row, its rounds per call the stacked
    run's, kernel gates; the server: rank 0's responses equal the oracle at
    their seqno with zero budget misses and drops, every follower ran rank
    0's read batches, writes and folds and ends at its seqno, and every
    rank's shadow equals its row of a stacked server replaying rank 0's
    log.  Returns the figures reported."""
    import torch

    from repro_torch.launch import serve_run

    world = len(ranks)
    for res in ranks:
        r, mm = res["rank"], res["users_mismatch"]
        check(mm is None, f"{label} rank {r}: users' output {mm} differs from the stacked row")
        diff = {k: (v, uref["scalars"].get(k)) for k, v in res["users_scalars"].items()
                if uref["scalars"].get(k) != v}
        check(not diff and set(res["users_scalars"]) == set(uref["scalars"]),
              f"{label} rank {r}: users' scalars differ: " + str(diff)[:2000])
        for step, w in uref["steps"].items():
            g = res["users_steps"][step]
            check(g["rounds"] == w["rounds"] and g["launches"] == w["launches"],
                  f"{label} rank {r} {step}: rounds {g['rounds']} / launches {g['launches']}, "
                  f"the stacked run's {w['rounds']} / {w['launches']}")
        if card:
            st = res["users_steps"]
            # The coherent delta build hashes (kernel 1); the skew guard
            # histograms the batch's (source, owner) pairs (kernel 2).
            check(st["hot.insert"]["launches"].get("murmur_bucket", 0) >= 1
                  and st["hot.insert"]["launches"].get("bin_histogram", 0) >= 1,
                  f"{label} rank {r}: the hot insert launched {st['hot.insert']['launches']}")
            check_gather_launches(st["hot.retrieve"]["launches"],
                                  {"csr_gather_owners": 1, "csr_gather_queriers": 1},
                                  f"{label} rank {r} hot.retrieve")
            probe = st["hot.probe_query"]["launches"].get("bucket_probe_layer", 0)
            rounds = max((k[1] for k in uref["scalars"]["hot.keys"]), default=1)
            check(probe == 2 * rounds, f"{label} rank {r}: the probe query launched kernel 5 "
                  f"{probe} times, want {2 * rounds} (2 layers x {rounds} replica rounds)")
            for step, v in st.items():
                if step.endswith(".get"):
                    check(v["launches"].get("csr_gather_queriers", 0) == 1,
                          f"{label} rank {r} {step}: a get launched {v['launches']}")
    s = uref["scalars"]
    # At D = 1 no key exceeds a dispatch slot: nothing is replicated.
    check(s["hot.num_dropped"] == 0 and s["hot.skew_fallbacks"] == 0
          and bool(s["hot.keys"]) == (world > 1),
          f"{label}: hot keys {s['hot.keys'][:4]}, {s['hot.num_dropped']} dropped")
    check(s["kv.skew_fallbacks"] == 0, f"{label}: the KV cache took a skew fallback")
    lead = ranks[0]["serve"]
    check(not lead["errors"], f"{label}: server pass errors {lead['errors'][:3]}")
    check(lead["responses"] == lead["requests"] == lead["completed"] and lead["failed"] == 0,
          f"{label}: {lead['responses']} responses, {lead['failed']} failed")
    for res in ranks[1:]:  # every rank read the same states in the same order
        f = res["serve"]["reads"]
        at = next((i for i, (a, b) in enumerate(zip(f, lead["reads"])) if a != b), None)
        check(at is None and len(f) == len(lead["reads"]),
              f"{label} rank {res['rank']}: its {len(f)} read executions differ from rank 0's "
              f"{len(lead['reads'])}" + ("" if at is None else
                                         f" first at {at}: {f[at]} against {lead['reads'][at]}"))
    check(lead["bad"] == 0, f"{label}: {lead['bad']} responses differ from the oracle: "
          + json.dumps(lead["bad_samples"]))
    check(lead["applied_final"] == lead["writes"], f"{label}: {lead['applied_final']} of "
          f"{lead['writes']} writes applied")
    check(lead["rounds"] == [(2, 2)] and lead["budget_misses"] == 0
          and lead["fold_budget_misses"] == 0,
          f"{label}: read rounds {lead['rounds']}, budget misses {lead['budget_misses']} / "
          f"{lead['fold_budget_misses']}")
    check(lead["reads_during_folds"] > 0,
          f"{label}: no read batch ran while the background fold was in flight")
    check(lead["num_dropped"] == 0 and lead["last_error"] is None and lead["aot_misses"] == 0,
          f"{label}: server dropped {lead['num_dropped']}, error {lead['last_error']}, "
          f"{lead['aot_misses']} grid misses")
    kinds = [rec["kind"] for rec in lead["log"]]
    for res in ranks[1:]:
        f = res["serve"]
        for field in ("seqno", "read_batches", "writes_applied", "folds", "full_compacts"):
            check(f[field] == lead[field], f"{label} rank {res['rank']}: {field} {f[field]}, "
                  f"rank 0's {lead[field]}")
        check([rec["kind"] for rec in f["log"]] == kinds and f["last_error"] is None,
              f"{label} rank {res['rank']}: applied {[rec['kind'] for rec in f['log']]}, "
              f"rank 0 sent {kinds} ({f['last_error']})")
    sink = DigestOnlySink()
    t0 = time.perf_counter()
    serve_run.replay(scfg, lead["log"], world, device, sink)
    replay_s = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for res in ranks:
        mm = first_digest_mismatch(res["shadow"], sink.digests, res["rank"])
        check(mm is None, f"{label} rank {res['rank']}: shadow {mm} differs from the replay's row")
        check(res["shadow_scalars"] == sink.scalars,
              f"{label} rank {res['rank']}: shadow scalars differ from the replay's")
    return {"replay_s": replay_s, "log": kinds}


def procs_users_report(label: str, ranks: list, uref: dict, extra: dict, smi: str, log) -> dict:
    """Per rank: the users' pass and the server pass walls, their rounds and
    reductions, peak bytes; rank 0's server latency, rounds and folds."""
    for res in ranks:
        st = res["users_steps"]
        kv = [v for k, v in st.items() if k.startswith("kv.")]
        red = {}
        for v in st.values():
            for k, n in v["collectives"].items():
                red[k] = red.get(k, 0) + n
        hot = {k: [round(v["wall_s"] * 1e3, 3), v["rounds"], v["collectives"]]
               for k, v in st.items() if k.startswith("hot.")}
        f = res["serve"]
        log(f"{label} rank {res['rank']}: users' pass {res['users_s']:.2f} s (hot keys "
            f"[wall_ms, rounds, reductions] " + json.dumps(hot) + f"; KV {len(kv)} calls in "
            f"{sum(v['wall_s'] for v in kv):.3f} s, {sum(v['rounds'] for v in kv)} rounds), "
            f"reductions {json.dumps(red)}, peak {res['users_peak']} bytes; server pass "
            f"{res['serve_s']:.2f} s (build {f['build_s']:.2f}, warm {f['warm_s']:.2f} for "
            f"{f['grid_entries']} entries), {f['read_batches']} read batches, "
            f"{f['writes_applied']} writes, {f['folds']} folds, seqno {f['seqno']}, reductions "
            f"{json.dumps(f['reductions'])}, peak {res['serve_peak']} bytes ({smi})")
    lead = ranks[0]["serve"]
    out = {"users_s": [r["users_s"] for r in ranks], "serve_s": [r["serve_s"] for r in ranks],
           "users_peak_bytes": [r["users_peak"] for r in ranks],
           "serve_peak_bytes": [r["serve_peak"] for r in ranks],
           "stacked_users_s": uref["seconds"],
           **{k: lead[k] for k in ("latency_ms", "traffic_s", "fold_s", "reads_during_folds",
                                   "keys_served", "responses", "retrieved", "read_batches",
                                   "fold_rounds")}, **extra}
    log(f"{label} server (rank 0): " + json.dumps(out) + f" ({smi})")
    return out


def procs_rank(group, cfg, ref: dict, path: str, check_kernels_here: bool,
               users=None) -> dict:
    """One rank of a procs run: the pass on its shard, every output's
    digests against the stacked run's row ``rank`` (the first differing
    chunk sent back raw), its steps (wall, rounds, bytes, launches,
    reductions per entry point), the numpy oracle on sampled rows, its
    kernels' inputs built with the other ranks and, on rank 0 with
    ``check_kernels_here``, its kernels held against their twins."""
    import numpy as np
    import torch

    from repro_torch.launch import table_run

    started = time.time()
    card = torch.cuda.is_available()
    device = torch.device("cuda", torch.cuda.current_device()) if card else torch.device("cpu")
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    rank = group.rank
    sink = DigestSink()
    t0 = time.perf_counter()
    run = table_run.run_slice(cfg, sink, group=group, device=device, keep_state=True)
    pass_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if card else None
    mismatch = None
    for name, want in ref["digests"].items():
        got = sink.digests.get(name)
        if got is None or got.shape[1:] != want.shape[1:]:
            mismatch = {"name": name, "why": "missing or of another shape"}
            break
        diff = np.nonzero(got[0] != want[rank])[0]
        if diff.shape[0]:
            c = int(diff[0])
            mismatch = {"name": name, "chunk": c, "raw": sink.raw[name][0].reshape(-1)[
                c * PROCS_CHUNK : (c + 1) * PROCS_CHUNK].copy()}
            break
    t1 = time.perf_counter()
    oracle = table_run.sampled_oracle(run["data"], cfg.seed, group.size, rank,
                                      {k: v[0] for k, v in sink.raw.items()}, PROCS_SAMPLES)
    sink.raw.clear()
    t2 = time.perf_counter()
    inputs = procs_kernel_inputs(run)
    t3 = time.perf_counter()
    steps = run["steps"]
    launches = {}
    for s in steps.values():
        for k, n in s["launches"].items():
            launches[k] = launches.get(k, 0) + n
    rows = []
    if check_kernels_here and rank == 0:
        rows = check_kernels({"inputs": lambda: inputs, "result": {
            "path": path, "shards": group.size, "launches": launches}}, device,
            lambda m: print(m, flush=True))
    del inputs, run
    t4 = time.perf_counter()
    out = {}
    if users is not None:  # the table's users on the same ranks, after the table pass
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        ucfg, scfg, uref, upath = users
        out = procs_users_rank(group, ucfg, scfg, uref, upath, check_kernels_here, device)
    seconds = {"pass": pass_s, "compare": t1 - t0 - pass_s, "oracle": t2 - t1,
               "kernel_inputs": t3 - t2, "kernel_checks": t4 - t3,
               "users": time.perf_counter() - t4,
               "started_at": started, "ended_at": time.time()}
    return {**out, "rank": rank, "steps": steps, "pass_s": pass_s, "seconds": seconds,
            "peak_bytes": peak,
            "mismatch": mismatch, "scalars": sink.scalars, "oracle": oracle, "rows": rows,
            "launches": launches}


def procs_reference(cfg, shards: int, device, log) -> dict:
    """The stacked run of the pass at ``shards``: its digests and scalars
    for the ranks, its blocks on the host to place a mismatch, its steps."""
    import torch

    from repro_torch.launch import table_run

    sink = DigestSink()
    t0 = time.perf_counter()
    out = table_run.run_slice(cfg, sink, num_shards=shards, device=device)
    secs = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walls = {step: round(v["wall_s"] * 1e3, 3) for step, v in out["steps"].items()}
    log(f"procs stacked D={shards}: the pass in {secs:.1f} s, {len(sink.digests)} outputs; "
        "wall ms per step " + json.dumps(walls))
    return {"digests": sink.digests, "scalars": sink.scalars, "raw": sink.raw,
            "steps": out["steps"], "seconds": secs, "walls_ms": walls}


def procs_check(label: str, ranks: list, ref: dict, cfg, log, card: bool) -> None:
    """Every rank against the stacked run: outputs bit for bit (the first
    differing index printed), scalars, zero drops, the sampled oracle,
    rounds, bytes and launches per entry point equal to the stacked run's,
    and (``card``) the path's kernels gated."""
    for res in ranks:
        r, mm = res["rank"], res["mismatch"]
        if mm is not None:
            where = mm.get("why", "")
            if "chunk" in mm:
                want = ref["raw"][mm["name"]][r].reshape(-1)
                c = mm["chunk"]
                seg = want[c * PROCS_CHUNK : (c + 1) * PROCS_CHUNK]
                at = int((mm["raw"] != seg).argmax())
                where = (f"first differing flat index {c * PROCS_CHUNK + at}: {seg[at]} "
                         f"stacked, {mm['raw'][at]} on the rank")
            check(False, f"{label} rank {r}: {mm['name']} differs from the stacked row ({where})")
        diff = {k: (v, ref["scalars"].get(k)) for k, v in res["scalars"].items()
                if ref["scalars"].get(k) != v}
        check(not diff and set(res["scalars"]) == set(ref["scalars"]),
              f"{label} rank {r}: scalars differ from the stacked run's: " + str(diff)[:2000])
        check(res["oracle"]["bad"] == 0, f"{label} rank {r}: {res['oracle']['bad']} of "
              f"{res['oracle']['rows']} sampled rows differ from the numpy oracle")
        for step, w in ref["steps"].items():
            g = res["steps"][step]
            for field in ("rounds", "plan_rounds", "bytes", "launches"):
                check(g[field] == w[field], f"{label} rank {r} {step}: {field} {g[field]}, "
                      f"the stacked run's {w[field]}")
        if not card:
            continue
        st = res["steps"]
        init = st["init"]["launches"]
        check(init.get("murmur_bucket", 0) >= 1 and init.get("bin_histogram", 0) == 1,
              f"{label} rank {r}: the build's kernels 1-2 launched {init}")
        for step in ("r0.retrieve", "r0.inner_join", "r3.retrieve", "r_compact.retrieve"):
            check_gather_launches(st[step]["launches"],
                                  {"csr_gather_owners": 1, "csr_gather_queriers": 1},
                                  f"{label} rank {r} {step}")
        probe = st["r3.probe_query"]["launches"].get("bucket_probe_layer", 0)
        check(probe == 4, f"{label} rank {r}: the depth-3 probe query launched kernel 5 "
              f"{probe} times, want 4 (one a layer)")
    s = ref["scalars"]
    for name, v in s.items():
        if name.endswith("num_dropped"):
            check(v == 0, f"{label}: {name} = {v}")
    if len(ranks) > 1:
        check(s["skew.fallback"] == 1 and not s["skew.coherent"],
              f"{label}: the skewed insert did not take the skew guard's fallback")


def procs_report(label: str, ranks: list, smi: str, log) -> dict:
    """Per rank: [wall ms, exchange rounds, bytes, agree all-reduces] per
    entry point, and peak bytes; per world: the slowest rank's wall."""
    world = {}
    for res in ranks:
        per = {step: [round(v["wall_s"] * 1e3, 3), v["rounds"] + v["plan_rounds"], v["bytes"],
                      v["collectives"].get("agree", 0)]
               for step, v in res["steps"].items()}
        agree = sum(v["collectives"].get("agree", 0) for v in res["steps"].values())
        reduce = sum(sum(v["collectives"].values()) for v in res["steps"].values()) - agree
        log(f"{label} rank {res['rank']} [wall_ms, rounds, bytes, agree] per step: "
            + json.dumps(per) + f"; agree all-reduces {agree}, psum/pmax all-reduces {reduce}, "
            f"peak {res['peak_bytes']} bytes, seconds " + json.dumps(
                {k: round(v, 3) for k, v in res["seconds"].items()}) + f" ({smi})")
        for step, v in res["steps"].items():
            world[step] = max(world.get(step, 0.0), v["wall_s"] * 1e3)
    log(f"{label} world: the slowest rank's wall ms per step " + json.dumps(
        {k: round(v, 3) for k, v in world.items()}) + f" ({smi})")
    return world


def run_procs(seed: int, device, log, n_keys: int = PROCS_KEYS) -> dict:
    """The ``procs`` phase: the table's path with one shard per process.

    1. the stacked run at D = 4 (``n_keys``, 2^24 a shard by default);
    2. gloo-4: four ranks on ``device`` through ``launch.mesh.spawn``, each
       launching the port's kernels on its own shard, every exchange staged
       through host memory (its walls measure gloo's staging, not an
       exchange over NVLink): every rank's outputs equal the stacked run's
       row bit for bit, with its rounds, bytes and launches per entry point;
       rank 0 holds kernels 1, 2, 3-4 and 5 against their twins on its own
       inputs (rows ``procs-gloo-4``);
    3. nccl-1: the same pass over NCCL at world 1 in this process (gloo on
       the CPU), against the stacked run at D = 1."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    cfg = procs_config(seed, n_keys)
    ucfg, scfg = users_configs(seed, n_keys)
    result = {"path": "procs", "shards": PROCS_WORLD, "keys": n_keys, "queries": cfg.queries}
    ref4 = procs_reference(cfg, PROCS_WORLD, device, log)
    uref4 = procs_users_reference(ucfg, PROCS_WORLD, device, log)
    t0, wall0 = time.perf_counter(), time.time()
    ranks = mesh.spawn(procs_rank, PROCS_WORLD, "gloo", str(device),
                       args=(cfg, {"digests": ref4["digests"], "scalars": ref4["scalars"]},
                             "procs-gloo-4", card,
                             (ucfg, scfg, {"digests": uref4["digests"]}, "procs-users-gloo-4")),
                       timeout_s=PROCS_TIMEOUT_S)
    result["gloo4_s"] = time.perf_counter() - t0
    wall1 = time.time()
    for res in ranks:  # start-up (spawn to the rank's job) and wind-down, on the host clock
        sec = res["seconds"]
        sec["start_up"] = sec.pop("started_at") - wall0
        sec["wind_down"] = wall1 - sec.pop("ended_at")
    log(f"procs-gloo-4: {result['gloo4_s']:.2f} s from spawn to the last result; rank 0 "
        + json.dumps({k: round(v, 3) for k, v in ranks[0]["seconds"].items()}))
    procs_check("procs-gloo-4", ranks, ref4, cfg, log, card)
    result["gloo4"] = {"walls_ms": procs_report("procs-gloo-4", ranks, smi, log),
                       "peak_bytes": [r["peak_bytes"] for r in ranks],
                       "stacked_s": ref4["seconds"], "stacked_walls_ms": ref4["walls_ms"],
                       "oracle_rows": sum(r["oracle"]["rows"] for r in ranks)}
    extra = procs_users_check("procs-users-gloo-4", ranks, uref4, scfg, device, log, card)
    result["users_gloo4"] = procs_users_report("procs-users-gloo-4", ranks, uref4, extra, smi, log)
    result["launches"] = ranks[0]["launches"]
    result["users_launches"] = ranks[0]["users_launches"]
    rows = ranks[0]["rows"] + ranks[0]["users_rows"]
    del ranks, ref4, uref4
    gc.collect()
    ref1 = procs_reference(cfg, 1, device, log)
    uref1 = procs_users_reference(ucfg, 1, device, log)
    backend = "nccl" if card else "gloo"
    store = tempfile.mkdtemp(prefix="procs_world1_")
    t0 = time.perf_counter()
    group = mesh.init_shard_group(backend, "file://" + os.path.join(store, "store"),
                                  timeout_s=PROCS_TIMEOUT_S, rank=0, world_size=1, device=device)
    t_init = time.perf_counter() - t0
    try:
        one = procs_rank(group, cfg, {"digests": ref1["digests"], "scalars": ref1["scalars"]},
                         f"procs-{backend}-1", False,
                         (ucfg, scfg, {"digests": uref1["digests"]}, f"procs-users-{backend}-1"))
    finally:
        t1 = time.perf_counter()
        dist.destroy_process_group()
        t_destroy = time.perf_counter() - t1
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    result["world1_s"] = time.perf_counter() - t0
    for k in ("started_at", "ended_at"):
        one["seconds"].pop(k)
    log(f"procs-{backend}-1: group init {t_init:.2f} s, destroy {t_destroy:.2f} s, the rank "
        + json.dumps({k: round(v, 3) for k, v in one["seconds"].items()}))
    procs_check(f"procs-{backend}-1", [one], ref1, cfg, log, card)
    result["world1"] = {"backend": backend, "peak_bytes": one["peak_bytes"],
                        "stacked_s": ref1["seconds"], "stacked_walls_ms": ref1["walls_ms"],
                        "walls_ms": procs_report(f"procs-{backend}-1", [one], smi, log)}
    extra = procs_users_check(f"procs-users-{backend}-1", [one], uref1, scfg, device, log, card)
    result[f"users_{backend}1"] = procs_users_report(f"procs-users-{backend}-1", [one], uref1,
                                                     extra, smi, log)
    del one, ref1, uref1
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    log("path procs: " + json.dumps({k: v for k, v in result.items()
                                     if k not in ("gloo4", "world1") and not k.startswith("users_")}))
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# LM serving path (slice 3): qwen3-4b at full width through the batcher
# ---------------------------------------------------------------------------
def lm_settings() -> None:
    """Matrix products in full f32 accumulation: TF32 off and no reduced
    precision bf16 reductions (both PyTorch defaults are left alone inside
    the library; this script and the card tests set them)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """Kernel launches of a serving run: kernel 6 once per attention layer
    (``attn``, ``swa`` or ``local``; an encoder-decoder's encoder layers
    too) per prefill (decode attention is plain), kernel 7 once per sLSTM
    layer per prefill and per decode step."""
    layers = {bt: cfg.num_periods * cfg.block_pattern.count(bt)
              for bt in ("attn", "swa", "local", "slstm")}
    attention = layers["attn"] + layers["swa"] + layers["local"]
    if cfg.is_encoder_decoder:  # the encoder's layers too, once a prefill
        attention += cfg.encoder_layers
    want = {}
    if attention and cfg.attention_impl == "flash":
        want["flash_attention"] = attention * prefills
    if layers["slstm"]:
        want["slstm_sequence"] = layers["slstm"] * (prefills + decode_steps)
    return want


def run_lm_path(seed: int, device, log, cfg=None, requests: int = LM_REQUESTS,
                slots: int = LM_SLOTS, cache_len: int = LM_CACHE_LEN,
                prompt_lens: tuple = LM_PROMPT_LENS, max_new: int = LM_MAX_NEW,
                path: str = "serve", lens=None, routes: bool = False) -> dict:
    """Serve ``requests`` ragged prompts through the public API: build_model
    with seeded random bf16 weights on the device, a ContinuousBatcher of
    ``slots`` lanes of ``cache_len`` tokens, greedy decoding until drained.
    The run's launches must be ``expected_launches``; the batcher's logits
    are kept for the replay check and, for an xLSTM stack (whose states do
    not grow with the prompt), each request's own prefill caches for the
    continuation check; for ring caches (``swa``), each request's ``kpos``
    after its prefill and after its last decode step.  ``lens`` fixes the
    prompts' lengths (their tokens still drawn from ``seed``); ``routes``
    keeps the experts each MoE layer chose at every generated position, with
    the router's tie gap (``RouteCapture``)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models.api import build_model
    from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step

    cfg = cfg or get_config(LM_ARCH)
    bundle = build_model(cfg, device=device)
    params, init_s = wall(lambda: bundle.init(seed), device)
    rng = np.random.default_rng(seed + 2)
    drawn = rng.integers(prompt_lens[0], prompt_lens[1] + 1, size=requests)
    lens = drawn if lens is None else np.asarray(lens)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n), dtype=np.int32) for n in lens]
    # Warm-up outside the counted run: cuBLAS handles, the kernel's first launch.
    _, warm = bundle.prefill(params, {"tokens": prompts[0][None, :64]}, cache_len=80)
    bundle.decode_step(params, warm, prompts[0][None, 64:65], np.array([64], np.int32))
    del warm

    prefill, decode = make_prefill_step(bundle, cache_len=cache_len), make_serve_step(bundle)
    rec = {"prefill_s": [], "ttft_s": [], "decode": [], "logits": {i: [] for i in range(requests)},
           "caches": {}, "ring_prefill": {}, "ring_final": {}, "routes": {}}
    recurrent = all(bt in ("mlstm", "slstm") for bt in cfg.block_pattern)

    def rings(caches, slot):
        return {name: c.kpos[:, slot].clone() for name, c in caches.items() if hasattr(c, "kpos")}

    def timed_prefill(p, batch):
        uid = len(rec["prefill_s"])  # the batcher admits in submission order
        check(batch["tokens"].shape == (1, len(prompts[uid])), f"prefill {uid}: wrong prompt")
        with RouteCapture() if routes else contextlib.nullcontext() as cap:
            (logits, cache), secs = wall(lambda: prefill(p, batch), device)
        if routes:
            rec["routes"][uid] = [cap.at(len(prompts[uid]) - 1)]
        rec["prefill_s"].append(secs)
        rec["ttft_s"].append(time.perf_counter() - rec["start"])
        rec["logits"][uid].append(logits[0])
        if recurrent:
            rec["caches"][uid] = cache  # _write_slot copies from it and never writes it
        rec["ring_prefill"][uid] = rings(cache, 0)
        return logits, cache

    def timed_decode(p, caches, token, pos):
        live = [(i, r.uid) for i, r in enumerate(batcher.slots) if r is not None]
        with RouteCapture() if routes else contextlib.nullcontext() as cap:
            (logits, caches), secs = wall(lambda: decode(p, caches, token, pos), device)
        rec["decode"].append((len(live), secs))
        for i, uid in live:
            rec["logits"][uid].append(logits[i])
            if routes:
                rec["routes"][uid].append(cap.at(i))
            if len(batcher.slots[i].out_tokens) == max_new - 1:  # its last step
                rec["ring_final"][uid] = rings(caches, i)
        return logits, caches

    batcher = ContinuousBatcher(params, bundle.init_cache(slots, cache_len), timed_prefill,
                                timed_decode, num_slots=slots)
    for uid, prompt in enumerate(prompts):
        batcher.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    sync(device)
    rec["start"] = time.perf_counter()
    done = batcher.run_until_drained()
    sync(device)
    total_s = time.perf_counter() - rec["start"]
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    check(len(done) == requests and all(r.done and len(r.out_tokens) == max_new for r in done),
          f"LM: {len(done)} of {requests} requests finished with {max_new} tokens")
    if device.type == "cuda":
        want = expected_launches(cfg, requests, len(rec["decode"]))
        check(launches == want, f"LM {cfg.name}: launches {launches}, want {want}")
    full = [secs for live, secs in rec["decode"] if live == slots]
    res = {
        "path": path,
        "arch": cfg.name,
        "requests": requests,
        "slots": slots,
        "cache_len": cache_len,
        "prompt_lens": [int(n) for n in lens],
        "max_new_tokens": max_new,
        "init_s": init_s,
        "total_s": total_s,
        "prefill_tokens_per_s": float(lens.sum()) / sum(rec["prefill_s"]),
        "prefill_s": rec["prefill_s"],
        "decode_steps": len(rec["decode"]),
        "decode_steps_all_live": len(full),
        "decode_tokens_per_s": slots * len(full) / sum(full) if full else None,
        "decode_step_ms_all_live": 1e3 * sum(full) / len(full) if full else None,
        "ttft_s": rec["ttft_s"],
        "launches": launches,
        "peak_bytes": peak,
    }
    log(f"serve {cfg.name}: " + json.dumps(res))
    return {"result": res, "cfg": cfg, "bundle": bundle, "params": params, "prompts": prompts,
            "done": done, "logits": rec["logits"], "batcher": batcher,
            "prefill_caches": rec["caches"], "ring_prefill": rec["ring_prefill"],
            "ring_final": rec["ring_final"], "routes": rec["routes"]}


def check_lm_replay(run: dict, device, log, tol=LM_LOGIT_TOL) -> dict:
    """Replay every finished request through ``forward_train`` with plain
    attention on the device (prompt + generated[:-1]) and hold the batcher's
    logits at every generated position within ``tol`` of the replay's;
    each generated token must equal the replay's argmax wherever the
    replay's top-1 beats its top-2 by more than 2 * ``tol``.  The largest
    difference is reported apart for the prefill's position (no state or
    cache carried yet) and for the decode positions.  ``tol`` None reports
    the differences and gates only shapes and finite values (the xLSTM:
    see ``check_lm_continuation``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.api import build_model

    plain = build_model(dataclasses.replace(run["cfg"], attention_impl="plain"), device=device)
    worst, scale, decided, positions = 0.0, 0.0, 0, 0
    at_prefill, at_decode = 0.0, 0.0
    for req in run["done"]:
        toks = np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])[None]
        logits, _ = plain.forward_train(run["params"], toks)
        ref = logits[0, len(req.prompt) - 1:].float()
        got = torch.stack(run["logits"][req.uid]).float()
        check(got.shape == ref.shape, f"replay {req.uid}: {tuple(got.shape)} vs {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"replay {req.uid}: non-finite batcher logits")
        per_pos = (got - ref).abs().amax(dim=-1)
        err = float(per_pos.max())
        at_prefill = max(at_prefill, float(per_pos[0]))
        at_decode = max(at_decode, float(per_pos[1:].max()) if per_pos.numel() > 1 else 0.0)
        check(bool(torch.isfinite(ref).all()), f"replay {req.uid}: non-finite replay logits")
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * (tol if tol is not None else float("inf"))
        if tol is not None:
            check(err <= tol, f"request {req.uid}: batcher logits differ from the plain "
                  f"replay by {err} > {tol} (per position: {per_pos.tolist()})")
            tokens = torch.as_tensor(req.out_tokens, device=ref.device)
            check(bool((tokens[sure] == ref.argmax(-1)[sure]).all()),
                  f"request {req.uid}: a generated token differs from the replay's clear argmax")
        worst, scale = max(worst, err), max(scale, float(ref.abs().max()))
        decided += int(sure.sum())
        positions += ref.shape[0]
        del logits, ref, got
    out = {"logit_tol": tol, "max_abs_err": worst, "max_abs_err_prefill": at_prefill,
           "max_abs_err_decode": at_decode, "max_abs_logit": scale,
           "positions": positions, "tokens_compared": decided,
           "positions_inside_margin": positions - decided}
    log(f"{run['result']['path']} replay (plain attention, forward_train): " + json.dumps(out))
    return out


def continue_from_state(params, cfg, cache, tokens):
    """Logits (1, k, V) of a teacher-forced pass of ``tokens`` (1, k) that
    starts from ``cache``, one request's recurrent states after its
    prefill: every mLSTM block chunkwise over the k tokens, every sLSTM
    block one kernel 7 call over them (xLSTM stacks only)."""
    import torch

    from repro_torch.models import ssm, transformer

    with torch.no_grad():
        x = transformer._embed(params, tokens, cfg)
        for i, period in enumerate(params.layers):
            for j, bt in enumerate(cfg.block_pattern):
                c = cache[f"b{j}"]
                block = ssm.mlstm_block if bt == "mlstm" else ssm.slstm_block
                x, _ = block(getattr(period, f"b{j}").mixer, x, cfg, type(c)(*(t[i] for t in c)))
        return transformer._head(params, x, cfg)


def check_lm_continuation(run: dict, device, log, tol) -> dict:
    """The state carried from prefill into decode against the teacher-forced
    pass from the same prefill state: for every request, its generated
    tokens but the last run through ``continue_from_state`` from its own
    prefill caches, and the batcher's decode logits (positions 1..n-1) held
    within ``tol`` of that pass's; each token it generated there must equal
    the pass's argmax wherever the pass's top-1 beats its top-2 by more
    than 2 * ``tol``.  Both start from one bitwise-identical prefill, so
    only the decode path (one token a step, the states written into and
    read back from the batcher's slots) is compared with the sequence path."""
    import torch

    worst, scale, positions, decided = 0.0, 0.0, 0, 0
    for req in run["done"]:
        toks = torch.as_tensor(req.out_tokens[:-1], device=device)[None]
        ref = continue_from_state(run["params"], run["cfg"], run["prefill_caches"][req.uid],
                                  toks)[0].float()
        got = torch.stack(run["logits"][req.uid][1:]).float()
        check(got.shape == ref.shape, f"continuation {req.uid}: {tuple(got.shape)} vs "
              f"{tuple(ref.shape)}")
        check(bool(torch.isfinite(ref).all()), f"continuation {req.uid}: non-finite logits")
        err = float((got - ref).abs().max())
        check(err <= tol, f"request {req.uid}: decode logits differ from the teacher-forced "
              f"pass from the prefill state by {err} > {tol}")
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        tokens = torch.as_tensor(req.out_tokens[1:], device=ref.device)
        check(bool((tokens[sure] == ref.argmax(-1)[sure]).all()),
              f"request {req.uid}: a decoded token differs from the pass's clear argmax")
        worst, scale = max(worst, err), max(scale, float(ref.abs().max()))
        positions += ref.shape[0]
        decided += int(sure.sum())
    out = {"logit_tol": tol, "max_abs_err": worst, "max_abs_logit": scale,
           "positions": positions, "tokens_compared": decided}
    log(f"{run['result']['path']} continuation from the prefill state: " + json.dumps(out))
    return out


def block_qkv(params, prompt, cfg, device, index: int):
    """q (Hq, S, D), k, v (Hkv, S, D) of block ``index`` of period 0 (an
    attention block) in a prefill of ``prompt``, as kernel 6 receives them:
    the blocks before it run first."""
    import torch

    from repro_torch.models import attention, layers, transformer

    tokens = torch.as_tensor(prompt[None], device=device)
    with torch.no_grad():
        x = transformer._embed(params, tokens, cfg)
        positions = torch.arange(x.shape[1], device=device, dtype=torch.int32)[None]
        period = params.layers[0]
        for j in range(index):
            x = transformer.apply_block_train(cfg.block_pattern[j], getattr(period, f"b{j}"), x,
                                              positions, cfg)
        block = getattr(period, f"b{index}")
        q, k, v = attention._project_qkv(block.attn, layers.rmsnorm(x, block.norm1), cfg,
                                         positions)
    _, kvh, g, s, hd = q.shape
    return q.reshape(1, kvh * g, s, hd)[0], k[0], v[0]


def spread_ms(fns: dict, device, groups: int, launches: int) -> dict:
    """``{name: [min, median, max]}`` ms per call of each function over
    ``groups`` groups of ``launches`` calls, the functions timed in turns
    within each group after one warm-up call each (CUDA events on the card)."""
    import statistics

    import torch

    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(groups):
        for name, fn in fns.items():
            sync(device)
            if device.type != "cuda":
                t0 = time.perf_counter()
                for _ in range(launches):
                    fn()
                times[name].append((time.perf_counter() - t0) * 1e3 / launches)
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / launches)
    return {name: [min(t), statistics.median(t), max(t)] for name, t in times.items()}


def ptxas_report(source: str, pattern: str) -> dict:
    """Registers, spills and ptxas notes of the kernels of one source file,
    from the ``ptxas -v`` output kept in ``build.log`` beside the library;
    ``pattern`` names a kernel by the groups of its mangled name."""
    import re

    from repro_torch.kernels import build

    build.library()
    text = (build.BUILD_DIR / "build.log").read_text()
    section = text.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    report, name = {}, None
    for line in section.splitlines():
        found = re.search(r"Compiling entry function '.*?" + pattern, line)
        if found:
            groups = [x for x in found.groups()[1:] if x is not None]
            name = found.group(1) + (f"<{', '.join(groups)}>" if groups else "")
            report[name] = {}
        elif name and "registers" in line:
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif name and "spill" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[name]["spill_bytes"] = {"stores": int(stores), "loads": int(loads)}
        elif name and "Potential Performance Loss" in line:
            report[name].setdefault("ptxas_notes", []).append(line.strip())
    return report


def flash_build_report() -> dict:
    """Registers, spills and shared memory of kernel 6's compiled kernels:
    ``ptxas -v`` from ``build.log`` beside the library, and each block's
    dynamic shared memory from the library itself."""
    from repro_torch.kernels import build

    report = ptxas_report("flash_attention.cu", r"(flash_fwd_\w+?)ILi(\d+)E")
    for name, entry in report.items():
        kind, d = name[:-1].split("<")
        entry["dynamic_smem_bytes"] = build.library().flash_attention_smem_bytes(
            int(d), int(kind == "flash_fwd_wgmma"))
    return report


def slstm_build_report(hd: int, batch: int, heads: int) -> dict:
    """Registers and spills of kernel 7's compiled kernels (``slstm_cluster<KS,
    NT>``, ``slstm_coop``) and the plan of each variant at the given shape
    (``slstm_plan``: cluster size, units, threads, dynamic shared bytes)."""
    import torch

    from repro_torch.kernels import slstm

    return {"kernels": ptxas_report("slstm.cu", r"\d(slstm_(?:cluster|coop))(?:ILi(\d+)ELi(\d+)E)?"),
            "plans": {str(dt): slstm.card_plan(hd, dt, batch, heads)
                      for dt in (torch.bfloat16, torch.float32)}}


def attention_bounds(hq: int, hkv: int, sq: int, skv: int, d: int, dtype: str, live: int) -> dict:
    """Least times in ms of one attention call: q, k, v read once and o
    written once over the memory rate; 4 * D FLOPs per live (query, key)
    pair per query head (q.k and p.v) over the card's rate for the type
    (bf16 tensor cores; f32 outside them)."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * d * (2 * hq * sq + 2 * hkv * skv)
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": 4 * d * live * hq / rate * 1e3}


def flash_row(path: str, q, k, v, args: dict, launches: int, shapes: str, device, log,
              library_fn, shards=None) -> dict:
    """Kernel 6 on ``q, k, v`` (3-D or batched 4-D) against its twin
    (FLASH_TOL of their type), timed in FLASH_TIMING's groups beside the
    library call; the twin over 3 calls; the bound from this call's live
    pairs."""
    from repro_torch.kernels import flash_attention as flash

    *lead, hq, s, d = q.shape
    hkv, skv = k.shape[-3], k.shape[-2]
    batch = lead[0] if lead else 1
    dtype = str(q.dtype).split(".")[-1]
    mask = flash.live_mask(s, skv, causal=args.get("causal", True), window=args.get("window"),
                           device=device)
    live = int(mask.sum())  # (query, key) pairs of one query head
    del mask
    bounds = attention_bounds(hq * batch, hkv * batch, s, skv, d, dtype, live)
    bound_by = max(bounds, key=bounds.get)
    tol = FLASH_TOL[dtype]
    call = flash.flash_attention_bhsd if lead else flash.flash_attention_fhsd
    err = twin_error("flash_attention", call(q, k, v, **args),
                     flash.flash_attention_plain(q, k, v, **args), tol, device)
    times = spread_ms({"kernel": lambda: call(q, k, v, **args), "library": library_fn}, device,
                      FLASH_TIMING["groups"], FLASH_TIMING["launches"])
    row = {
        "name": "flash_attention", "path": path, "shards": shards, "launches": launches,
        "route": "cuda", "source": KERNELS["flash_attention"][0],
        "replaces": KERNELS["flash_attention"][1], "max_abs_err": err,
        "ms": times["kernel"][1],
        "plain_ms": mean_ms(lambda: flash.flash_attention_plain(q, k, v, **args), 3, device),
        "bound_ms": bounds[bound_by], "bound_by": bound_by, "library_ms": times["library"][1],
        "shapes": shapes, "spread_ms": times, "bounds_ms": bounds, "live_pairs": live,
        "tflops": 4 * d * live * hq * batch / times["kernel"][1] / 1e9,
    }
    log(f"kernel flash_attention {path} {shapes}: max_abs_err={err} (tol {tol}) [min, median, "
        f"max] ms over {FLASH_TIMING['groups']} groups of {FLASH_TIMING['launches']}: "
        f"{json.dumps(times)} plain_ms={row['plain_ms']} bound_ms={row['bound_ms']} "
        f"({bound_by}, {live} live pairs a head) = {row['bound_ms'] / row['ms']:.3f} of the kernel's "
        f"median, {row['tflops']:.1f} TFLOP/s, launches={launches}")
    return row


def check_lm_kernels(run: dict, device, log) -> list:
    """Kernel 6 against its plain twin on request 0's layer-0 q, k, v (the
    main path's shape), read through the strided views the model hands over
    and as contiguous copies; timed in turns with the twin and
    ``scaled_dot_product_attention`` (a yardstick the port never calls) in
    FLASH_TIMING's groups; then on the small cases of LM_FLASH_CASES in bf16
    and f32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash

    if device.type == "cuda":
        log("kernel flash_attention build: " + json.dumps(flash_build_report()))
    cfg = run["cfg"]
    q, k, v = block_qkv(run["params"], run["prompts"][0], cfg, device, 0)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    hq, s, d = q.shape
    hkv, group = k.shape[0], cfg.q_per_kv
    live = int(flash.live_mask(s, s, causal=True, window=None, device=device).sum())
    bounds = attention_bounds(hq, hkv, s, s, d, "bfloat16", live)
    bound_by = max(bounds, key=bounds.get)
    tol = FLASH_TOL["bfloat16"]
    fns = {
        "kernel": lambda: flash.flash_attention_fhsd(q, k, v, q_heads_per_kv=group),
        "kernel_contiguous": lambda: flash.flash_attention_fhsd(qc, kc, vc, q_heads_per_kv=group),
        "plain": lambda: flash.flash_attention_plain(q, k, v, q_heads_per_kv=group),
        "library": lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True)[0],
        "library_contiguous": lambda: F.scaled_dot_product_attention(
            qc[None], kc[None], vc[None], is_causal=True, enable_gqa=True)[0],
    }
    if device.type != "cuda":  # rehearsal on the CPU: the wrappers take the twin there
        fns = {name: fns[name] for name in ("kernel", "plain", "library")}
    want = fns["plain"]()
    err = max(twin_error("flash_attention", fns[name](), want, tol, device)
              for name in ("kernel", "kernel_contiguous") if name in fns)
    del want
    times = spread_ms(fns, device, FLASH_TIMING["groups"], FLASH_TIMING["launches"])
    row = {
        "name": "flash_attention", "path": "serve", "shards": None,
        "launches": run["result"]["launches"].get("flash_attention", 0),
        "route": "cuda", "source": KERNELS["flash_attention"][0],
        "replaces": KERNELS["flash_attention"][1], "max_abs_err": err,
        "ms": times["kernel"][1], "plain_ms": times["plain"][1],
        "bound_ms": bounds[bound_by], "bound_by": bound_by, "library_ms": times["library"][1],
        "shapes": f"q=({hq}, {s}, {d}) k/v=({hkv}, {s}, {d}) bf16 causal (request 0, layer 0, "
                  "strided views of the projections)",
        "spread_ms": times, "bounds_ms": bounds, "tflops": 4 * d * live * hq / times["kernel"][1] / 1e9,
    }
    log(f"kernel flash_attention serve {row['shapes']}: max_abs_err={err} (tol {tol}) "
        f"[min, median, max] ms over {FLASH_TIMING['groups']} groups of "
        f"{FLASH_TIMING['launches']}: {json.dumps(times)} bound_ms={row['bound_ms']} ({bound_by}) "
        f"= {row['bound_ms'] / row['ms']:.3f} of the kernel's median, {row['tflops']:.1f} "
        f"TFLOP/s, launches={row['launches']}")
    del q, k, v, qc, kc, vc
    gen = torch.Generator(device=device).manual_seed(7)
    for hq, hkv, sq, skv, d, causal, window in LM_FLASH_CASES:
        for dtype in ("bfloat16", "float32"):
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(getattr(torch, dtype))
                       for shape in ((hq, sq, d), (hkv, skv, d), (hkv, skv, d)))
            args = dict(causal=causal, window=window, q_heads_per_kv=hq // hkv)
            if device.type == "cuda":
                got = flash.flash_attention_fhsd(q, k, v, **args)
            else:  # rehearsal on the CPU: the wrapper takes the twin there
                got = flash.flash_attention_plain(q, k, v, **args)
            want = flash.flash_attention_plain(q, k, v, **args)
            sync(device)
            tol = FLASH_TOL[dtype]
            diff = (got.float() - want.float()).abs()
            check(got.dtype == want.dtype and bool((diff <= tol * (1 + want.float().abs())).all()),
                  f"kernel flash_attention {(hq, hkv, sq, skv, d, causal, window)} {dtype}: "
                  f"max error {float(diff.max())} over tolerance {tol}")
            log(f"kernel flash_attention case hq={hq} hkv={hkv} sq={sq} skv={skv} d={d} "
                f"causal={causal} window={window} {dtype}: max_abs_err={float(diff.max())} (tol {tol})")
    return [row]


def slstm_layer0_inputs(params, prompt, cfg, device):
    """The first sLSTM layer's kernel 7 inputs in a prefill of ``prompt``:
    ``pre`` (1, H, S, 4, hd) (a view of the block's projection), its ``r``
    and the initial states, as ``ssm.slstm_block`` hands them over."""
    import torch

    from repro_torch.models import layers, ssm, transformer

    tokens = torch.as_tensor(prompt[None], device=device)
    h = cfg.num_heads
    hd = cfg.d_model // h
    with torch.no_grad():
        x = transformer._embed(params, tokens, cfg)
        x, _ = ssm.mlstm_block(params.layers[0].b0.mixer, x, cfg)
        p = params.layers[0].b1.mixer
        pre = (layers.rmsnorm(x, p.norm) @ p.w_in.to(x.dtype)).float() + p.b
    s = pre.shape[1]
    pre5 = pre.view(1, s, 4, h, hd).permute(0, 3, 1, 2, 4)
    states = tuple(t.reshape(1, h, hd) for t in ssm.slstm_init_state(cfg, 1, device))
    return pre5, p.r, states


def slstm_bounds(b: int, h: int, s: int, hd: int, r_bytes: int) -> dict:
    """Least times in ms of one kernel 7 call: pre and hs once, r once, the
    states read and written once, over the memory rate; 8 hd^2 FLOPs per
    (b, h, step) (4 gates of an hd x hd product) over the f32 rate."""
    nbytes = 4 * b * h * s * hd * (4 + 1) + r_bytes * h * 4 * hd * hd + 4 * 8 * b * h * hd
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": 8 * hd * hd * b * h * s / F32_FLOPS_PER_S * 1e3}


def slstm_chunks_against_twin(pre, r, states, device) -> float:
    """Kernel 7 over the whole sequence must equal, bit for bit, its own
    launches over SLSTM_CHUNK-step chunks, each from the previous chunk's
    final states; and each chunk must agree with the plain twin run from
    the same states within SLSTM_TOL["main"], which holds the kernel step by
    step however far the random-weight recurrence amplifies an earlier
    difference over the whole sequence (``slstm_whole_launch``).  Returns the
    largest chunk error and the whole launch's outputs."""
    import torch

    from repro_torch.kernels import slstm

    tol = SLSTM_TOL["main"]
    whole_hs, whole_fin = slstm.slstm_sequence(pre, r, *states)
    st, worst = states, 0.0
    for t0 in range(0, pre.shape[2], SLSTM_CHUNK):
        part = pre[:, :, t0:t0 + SLSTM_CHUNK]
        hk, fk = slstm.slstm_sequence(part, r, *st)
        hp, fp = slstm.slstm_sequence_plain(part, r, *st)
        sync(device)
        check(torch.equal(hk, whole_hs[:, :, t0:t0 + SLSTM_CHUNK]),
              f"kernel slstm_sequence: the whole launch differs from its chunk at step {t0}")
        for a, b in zip((hk, *fk), (hp, *fp)):
            diff = (a - b).abs()
            check(bool((diff <= tol * (1 + b.abs())).all()), f"kernel slstm_sequence: chunk at "
                  f"step {t0} differs from the twin by {float(diff.max())} > {tol}")
            worst = max(worst, float(diff.max()))
        st = fk
    check(all(torch.equal(a, b) for a, b in zip(st, whole_fin)),
          "kernel slstm_sequence: the whole launch's final states differ from its chunks'")
    return worst, (whole_hs, whole_fin)


def slstm_whole_launch(pre, r, states, device, kernel_out) -> dict:
    """The whole kernel launch against the twin over the whole sequence
    (reported, not gated): the largest difference of each output, the count
    outside SLSTM_TOL["main"], and max |dh| over (b, h, unit) at a few steps,
    beside the twin's own after a 1e-7 relative change of ``pre`` (normal
    noise): how far the recurrence amplifies a difference."""
    import torch

    from repro_torch.kernels import slstm

    gen = torch.Generator(device=device).manual_seed(13)
    noisy = pre * (1 + 1e-7 * torch.randn(pre.shape, generator=gen, device=device))
    hs, finals = slstm.slstm_sequence_plain(pre, r, *states)
    moved, _ = slstm.slstm_sequence_plain(noisy, r, *states)
    k_hs, k_finals = kernel_out
    tol = SLSTM_TOL["main"]
    s = pre.shape[2]
    steps = sorted({0, min(255, s - 1), min(1023, s - 1), s - 1})
    out = {"max_abs_err": {}, "outside_tol": 0}
    for name, a, b in zip(("hs", "c", "n", "h", "m"), (k_hs, *k_finals), (hs, *finals)):
        diff = (a - b).abs()
        out["max_abs_err"][name] = float(diff.max())
        out["outside_tol"] += int((diff > tol * (1 + b.abs())).sum())
    for name, other in (("kernel", k_hs), ("twin, pre changed by 1e-7", moved)):
        d = (hs - other).abs().amax(dim=(0, 1, 3))
        out[f"{name}: max |dh| at step"] = {str(t): float(d[t]) for t in steps}
    return out


def check_slstm_kernel(run: dict, device, log) -> list:
    """Kernel 7 against its plain twin on request 0's first sLSTM layer (the
    main path's shape): the bf16 r of the model (the cluster kernel) and its
    f32 widening (the cooperative kernel), each in SLSTM_CHUNK-step chunks,
    timed in turns in SLSTM_TIMING's groups; then on a decode-shaped call
    (all slots, S = 1) from the run's own layer-0 states, and on the JAX
    kernel tests' shapes with f32 and bf16 r."""
    import torch

    from repro_torch.kernels import slstm

    def flat(out):
        hs, finals = out
        return (hs, *finals)

    def held(name, got, want, tol):
        sync(device)
        worst = 0.0
        for a, b in zip(flat(got), flat(want)):
            diff = (a - b).abs()
            check(a.shape == b.shape and bool((diff <= tol * (1 + b.abs())).all()),
                  f"kernel slstm_sequence {name}: max error {float(diff.max())} over {tol}")
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        log(f"kernel slstm_sequence {name}: max_abs_err={worst} (tol {tol})")

    cuda = device.type == "cuda"
    cfg = run["cfg"]
    pre, r, states = slstm_layer0_inputs(run["params"], run["prompts"][0], cfg, device)
    b, h, s, _, hd = pre.shape
    rf = r.float()
    plans = {str(dt): (slstm.card_plan(hd, dt, b, h) if cuda else slstm.launch_plan(hd, dt, b))
             for dt in (r.dtype, rf.dtype)}
    if cuda:
        log("kernel slstm_sequence build: " + json.dumps(slstm_build_report(hd, b, h)))
    err, whole = slstm_chunks_against_twin(pre, r, states, device)
    log(f"kernel slstm_sequence main shape, {r.dtype} r ({plans[str(r.dtype)]['variant']}), "
        f"{SLSTM_CHUNK}-step chunks from the kernel's own states: max_abs_err={err} (tol "
        f"{SLSTM_TOL['main']}); the whole launch equals its chunks bit for bit")
    whole_launch = slstm_whole_launch(pre, r, states, device, whole)
    log("kernel slstm_sequence whole launch against the twin over all steps (not gated): "
        + json.dumps(whole_launch))
    del whole
    err32, whole32 = slstm_chunks_against_twin(pre, rf, states, device)
    log(f"kernel slstm_sequence main shape, f32 r ({plans[str(rf.dtype)]['variant']}), "
        f"{SLSTM_CHUNK}-step chunks: max_abs_err={err32} (tol {SLSTM_TOL['main']}); the whole "
        "launch equals its chunks bit for bit")
    del whole32
    times = spread_ms({"kernel": lambda: slstm.slstm_sequence(pre, r, *states),
                       "kernel_f32": lambda: slstm.slstm_sequence(pre, rf, *states)},
                      device, SLSTM_TIMING["groups"], SLSTM_TIMING["launches"])
    bounds = slstm_bounds(b, h, s, hd, r.element_size())
    bound_by = max(bounds, key=bounds.get)
    plan = plans[str(r.dtype)]
    row = {
        "name": "slstm_sequence", "path": run["result"]["path"], "shards": None,
        "launches": run["result"]["launches"].get("slstm_sequence", 0),
        "route": "cuda", "source": KERNELS["slstm_sequence"][0],
        "replaces": KERNELS["slstm_sequence"][1], "max_abs_err": max(err, err32),
        "ms": times["kernel"][1],
        "plain_ms": mean_ms(lambda: flat(slstm.slstm_sequence_plain(pre, r, *states)), 3, device),
        "bound_ms": bounds[bound_by], "bound_by": bound_by, "library_ms": None,
        "shapes": f"pre=({b}, {h}, {s}, 4, {hd}) f32 (strided view) r=({h}, 4, {hd}, {hd}) "
                  f"{r.dtype} (request 0, first sLSTM layer)",
        "variant": plan["variant"], "cluster": plan["cluster"], "spread_ms": times,
        "ns_per_step": times["kernel"][1] * 1e6 / s, "f32_ms": times["kernel_f32"][1],
        "f32_variant": plans[str(rf.dtype)]["variant"], "whole_launch": whole_launch,
    }
    log(f"kernel slstm_sequence {row['path']} {row['shapes']}: variant={row['variant']} "
        f"cluster={row['cluster']} [min, median, max] ms over {SLSTM_TIMING['groups']} groups of "
        f"{SLSTM_TIMING['launches']}: {json.dumps(times)} ns_per_step={row['ns_per_step']:.1f} "
        f"plain_ms={row['plain_ms']} bound_ms={row['bound_ms']} ({bound_by}) = "
        f"{row['bound_ms'] / row['ms']:.3f} of the kernel's median, launches={row['launches']}")
    del pre, rf
    # Decode shape: every slot, one step, from the states the run left in
    # the first sLSTM layer (non-zero), with bf16 r.
    gen = torch.Generator(device=device).manual_seed(11)
    cache = run["batcher"].caches["b1"]
    slots = cache.c.shape[1]
    dec_states = tuple(t[0].reshape(slots, h, hd).clone() for t in cache)
    dec_pre = 0.5 * torch.randn((slots, h, 1, 4, hd), generator=gen, device=device)
    run_kernel = slstm.slstm_sequence if cuda else slstm.slstm_sequence_plain
    held(f"decode pre=({slots}, {h}, 1, 4, {hd}) from the run's states",
         run_kernel(dec_pre, r, *dec_states),
         slstm.slstm_sequence_plain(dec_pre, r, *dec_states), SLSTM_TOL["steps"])
    decode = lambda: run_kernel(dec_pre, r, *dec_states)  # noqa: E731
    row["decode_ms"] = spread_ms({"decode": decode}, device, SLSTM_TIMING["groups"],
                                 SLSTM_TIMING["launches"])["decode"]
    if cuda:  # the device's time a launch (torch.profiler), without the host's share
        prof = profile_phases({"decode": lambda: [decode() for _ in range(SLSTM_TIMING["launches"])]},
                              device)["decode"]["by_class"].get("kernel 7")
        # After many profiler sessions in one process (--profile) the
        # profiler can return no device rows: the device time is then not
        # measured (the events' times above are).
        row["decode_device_ms"] = prof["ms"] / prof["launches"] if prof else None
    else:
        row["decode_device_ms"] = None
    log(f"kernel slstm_sequence decode shape: [min, median, max] ms a call {row['decode_ms']} "
        f"(host included), device ms a launch {row['decode_device_ms']}")
    for b, h, s, hd in SLSTM_CASES:
        pre = 0.5 * torch.randn((b, h, s, 4, hd), generator=gen, device=device)
        rr = torch.randn((h, 4, hd, hd), generator=gen, device=device) / hd ** 0.5
        z = torch.zeros((b, h, hd), device=device)
        st = (z, z, z, torch.full_like(z, -1e30))
        for r_dtype in (torch.float32, torch.bfloat16):
            rd = rr.to(r_dtype)
            held(f"case b={b} h={h} s={s} hd={hd} {r_dtype} r", run_kernel(pre, rd, *st),
                 slstm.slstm_sequence_plain(pre, rd, *st), SLSTM_TOL["steps"])
    return [row]


def lm_path_phases(run: dict) -> dict:
    """One more prefill of request 0 and one more decode step of all slots."""
    import numpy as np

    bundle, params, batcher = run["bundle"], run["params"], run["batcher"]
    prompt = run["prompts"][0]
    slots = batcher.num_slots
    token = np.ones((slots, 1), np.int32)
    pos = np.full((slots,), len(prompt), np.int32)
    return {
        "prefill (request 0)": lambda: bundle.prefill(
            params, {"tokens": prompt[None]}, cache_len=run["result"]["cache_len"]),
        "decode step (all slots)": lambda: bundle.decode_step(params, batcher.caches, token, pos),
    }


# ---------------------------------------------------------------------------
# Training on one card (the train phase)
# ---------------------------------------------------------------------------
# qwen3-4b at full width, TRAIN_LAYERS of its 36 layers: f32 masters, their
# gradients and two f32 moments take 16 bytes a parameter, 64.3 GB at 36
# layers before any activation; 12 layers hold 1.60 B parameters (25.6 GB).
TRAIN_LAYERS = 12
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCHES = 4, 2048, 4, 2
TRAIN_LR = 1e-3  # peak; the schedule's 10 warm-up steps give 1e-4 .. 4e-4
# The first step's ce (kernel 6 in every attention forward) against the
# plain-attention model's on the same batch and weights, relative: one bf16
# step of the value (2^-8).  The two round to bf16 at other points (kernel 6
# rounds p before p.v), and the mean over 8,192 positions averages out.
TRAIN_CE_TOL = 2.0 ** -8
# Gradients of a loss through the kernel-backed autograd Functions against
# the plain path's, per leaf: max |difference| over the leaf's largest
# |plain| entry.  f32: the forwards differ by f32 summation order
# (FLASH_TOL, SLSTM_TOL); bf16 compute: they round to bf16 at other points,
# one bf16 step (2^-8) of an activation carried back through the layers.
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_GRAD_SEQ = 256  # the full-width single-layer cases
TRAIN_RESUME = {"steps": 6, "every": 3, "crash": 4, "seq": 64, "batch": 4}


def train_args(seed: int) -> list:
    """The train phase's command line of ``repro_torch.launch.train``."""
    return ["--arch", "qwen3_4b", "--layers", str(TRAIN_LAYERS), "--seq", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH), "--microbatches", str(TRAIN_MICROBATCHES),
            "--steps", str(TRAIN_STEPS), "--dedup", "local", "--lr", str(TRAIN_LR),
            "--seed", str(seed)]


class PlainCalls:
    """Counts the plain attention's calls while the train steps run:
    ``masked`` (the einsum path, which must not run where kernel 6 should)
    and ``flash_plain`` (kernel 6's twin, which runs in each backward)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as kflash
        from repro_torch.models import attention

        self.masked = self.flash_plain = 0
        self._mods = (attention, kflash)
        self._fns = (attention._masked_attention, kflash.flash_attention_plain)

        def masked(*a, **kw):
            self.masked += 1
            return self._fns[0](*a, **kw)

        def flash_plain(*a, **kw):
            self.flash_plain += 1
            return self._fns[1](*a, **kw)

        attention._masked_attention, kflash.flash_attention_plain = masked, flash_plain
        return self

    def __exit__(self, *exc):
        self._mods[0]._masked_attention, self._mods[1].flash_attention_plain = self._fns
        return False


def batch_ce(params, tokens, cfg, k: int) -> float:
    """Mean ce of ``tokens`` over ``k`` microbatches (as the train step takes
    them), no gradients."""
    import torch

    from repro_torch.models import transformer

    with torch.no_grad():
        parts = [transformer.loss_fn(params, {"tokens": mb}, cfg)[1]["ce"]
                 for mb in tokens.reshape(k, -1, tokens.shape[1])]
    return float(sum(float(c) for c in parts) / k)


def train_flash_row(trainer, tokens, launches: int, device, log) -> dict:
    """Kernel 6 at the train step's shape (microbatch 0's layer-0 q, k, v
    of the trained weights) against its twin (``flash_row``), with the
    backward its autograd Function runs (the twin recomputed and
    differentiated) timed beside."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import attention, layers, transformer

    cfg = trainer.bundle.cfg
    mb = tokens.reshape(TRAIN_MICROBATCHES, -1, tokens.shape[1])[0][:, :-1]
    with torch.no_grad():
        x = transformer._embed(trainer.params, mb, cfg)
        block = trainer.params.layers[0].b0
        b, s = mb.shape
        positions = torch.arange(s, device=device, dtype=torch.int32).expand(b, s)
        q, k, v = attention._project_qkv(block.attn, layers.rmsnorm(x, block.norm1), cfg,
                                         positions)
    kvh, g, hd = q.shape[1], q.shape[2], q.shape[4]
    q = q.reshape(b, kvh * g, s, hd)
    row = flash_row("train", q, k, v, dict(causal=True, q_heads_per_kv=g), launches,
                    f"q=({b}, {kvh * g}, {s}, {hd}) k/v=({b}, {kvh}, {s}, {hd}) bf16 causal "
                    "(microbatch 0, layer 0, strided views of the projections)", device, log,
                    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                           enable_gqa=True))
    grad_out = torch.randn((b, s, kvh * g, hd), device=device,
                           generator=torch.Generator(device=device).manual_seed(3)).to(q.dtype)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def backward():
        out = flash.FlashAttention.apply(qg, kg, vg, True, None, None, g)
        return torch.autograd.grad(out, (qg, kg, vg), grad_out)

    row["forward_and_plain_backward_ms"] = mean_ms(backward, 3, device)
    log(f"kernel flash_attention train forward+plain backward ms="
        f"{row['forward_and_plain_backward_ms']}")
    return row


def run_train(seed: int, device, log) -> dict:
    """The train phase's main run: ``repro_torch.launch.train`` with
    ``train_args`` (qwen3-4b, TRAIN_LAYERS layers at full width, bf16
    compute over f32 masters, seq 2048, batch 4 in 2 microbatches, the
    loader's HashGraph dedup, 4 steps), its weights drawn on the card from
    ``seed``.  Gates: the first step's ce within TRAIN_CE_TOL of the
    plain-attention model's on the same batch and weights; every metric
    finite; after the steps, the first batch's loss below step 1's; kernel 6
    launched ``2 x layers x microbatches x steps`` times (each forward, and
    its recomputation under remat in the backward), the plain attention
    never in a forward and kernel 6's twin once per layer per microbatch
    per step (the backward); kernel 1 twice per batch (the dedup's build and
    its lookup) and nothing else.  Returns the result and the phase's
    kernel rows (kernel 6 at the step's shape, kernel 1 on the dedup's
    keys)."""
    import dataclasses
    import math

    from repro_torch.core.hashing import DEFAULT_SEED
    from repro_torch.data import ShardedLoader, sequence_fingerprints
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    from repro_torch.utils import tree_param_count, tree_size_bytes

    label = "train"
    reset_peak(device)
    args = train_cli.parse(train_args(seed))
    trainer, init_s = wall(lambda: train_cli.make_trainer(args, log), device)
    cfg, k = trainer.bundle.cfg, args.microbatches
    params_n = tree_param_count(trainer.params)
    state_bytes = tree_size_bytes(trainer.params) + tree_size_bytes(trainer.opt_state)
    first = ShardedLoader(trainer.loader.corpus, batch_size=args.batch,
                          dedup=args.dedup).next_batch()["tokens"]
    plain_ce = batch_ce(trainer.params, first, dataclasses.replace(cfg, attention_impl="plain"),
                        k)
    build.LAUNCHES.clear()
    with PlainCalls() as calls:
        out, run_s = wall(trainer.run, device)
    launches = dict(build.LAUNCHES)
    hist = out["history"]
    check(out["final_step"] == args.steps and len(hist) == args.steps,
          f"{label}: {len(hist)} logged steps of {args.steps}")
    for h in hist:
        check(all(math.isfinite(h[m]) for m in ("loss", "ce", "moe_aux", "grad_norm", "lr")),
              f"{label}: step {h['step']} has a non-finite metric: {h}")
    first_ce = hist[0]["ce"]
    check(abs(first_ce - plain_ce) <= TRAIN_CE_TOL * abs(plain_ce),
          f"{label}: step 1 ce {first_ce} against the plain-attention model's {plain_ce}")
    after = batch_ce(trainer.params, first, cfg, k)
    check(after < hist[0]["loss"], f"{label}: batch 0's loss {after} after {args.steps} steps "
          f"is not below step 1's {hist[0]['loss']}")
    attn_layers = cfg.num_periods * cfg.block_pattern.count("attn")
    fwd = attn_layers * k * args.steps
    if device.type == "cuda":
        want = {"flash_attention": 2 * fwd, "murmur_bucket": 2 * args.steps}
        check(launches == want, f"{label}: launches {launches}, want {want} (kernel 6: 2 x "
              f"{attn_layers} layers x {k} microbatches x {args.steps} steps)")
    check(calls.masked == 0, f"{label}: {calls.masked} plain-attention forwards")
    if device.type == "cuda":  # on the CPU the twin is kernel 6's forward too
        check(calls.flash_plain == fwd, f"{label}: {calls.flash_plain} calls of kernel 6's "
              f"twin, want {fwd} (one backward a layer, microbatch and step)")
    smi = card_line() if device.type == "cuda" else "cpu"
    res = {
        "path": label, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": params_n, "state_bytes": state_bytes, "seq": args.seq, "batch": args.batch,
        "microbatches": k, "dedup": args.dedup, "init_s": init_s, "run_s": run_s,
        "steps": [{"step": h["step"], "loss": h["loss"], "ce": h["ce"],
                   "grad_norm": h["grad_norm"], "lr": h["lr"], "step_ms": 1e3 * h["step_time_s"],
                   "tokens_per_s": h["tokens_per_s"], "peak_bytes": h.get("peak_bytes")}
                  for h in hist],
        "plain_ce_step1": plain_ce, "ce_step1": first_ce, "ce_tol": TRAIN_CE_TOL,
        "batch0_loss_after": after, "stragglers": out["stragglers"], "launches": launches,
        "plain_calls": {"masked_attention": calls.masked, "flash_plain_backward": calls.flash_plain},
        "card": smi,
    }
    for h in res["steps"]:
        log(f"train step {h['step']}: loss={h['loss']:.6f} grad_norm={h['grad_norm']:.6f} "
            f"lr={h['lr']:.3e} step_ms={h['step_ms']:.1f} tokens/s={h['tokens_per_s']:.1f} "
            f"peak_bytes={h['peak_bytes']} ({smi})")
    rows = [train_flash_row(trainer, first, launches.get("flash_attention", 0), device, log)]
    fp = sequence_fingerprints(first[:, :-1])
    run = {"result": {"path": label, "shards": 1, "launches": launches},
           "inputs": lambda: {"murmur_bucket": dict(keys=fp, table_size=max(8, fp.numel()),
                                                    seed=DEFAULT_SEED, n=fp.numel(), lanes=1)}}
    rows += check_kernels(run, device, log)
    res["peak_bytes"] = phase_peak(device)
    log("path train: " + json.dumps(res))
    return {"result": res, "rows": rows, "trainer": trainer, "first": first}


def train_phases(run: dict) -> dict:
    """One more train step on the first batch, for ``profile_phases``."""
    trainer, batch = run["trainer"], {"tokens": run["first"]}
    return {"train step": lambda: trainer._step_fn(trainer.params, trainer.opt_state, batch)}


@contextlib.contextmanager
def plain_twins():
    """Kernels 6 and 7 replaced by their plain twins in the models' forward
    (the autograd Functions' backward is the twins' already)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import slstm as kslstm

    bhsd, seq = kflash.flash_attention_bhsd, kslstm.slstm_sequence

    def plain_bhsd(q, k, v, *, out=None, **kw):
        got = kflash.flash_attention_plain(q, k, v, **kw)
        return got if out is None else out.copy_(got)

    kflash.flash_attention_bhsd, kslstm.slstm_sequence = plain_bhsd, kslstm.slstm_sequence_plain
    try:
        yield
    finally:
        kflash.flash_attention_bhsd, kslstm.slstm_sequence = bhsd, seq


def leaf_grads(cfg, seed: int, tokens, device) -> tuple:
    """``(loss, {name: gradient})`` of one loss on ``tokens`` of a model
    drawn from ``seed`` (f32 masters)."""
    import torch

    from repro_torch.models.api import build_model

    bundle = build_model(cfg, device=device)
    params = bundle.init_train(seed)
    loss, _ = bundle.loss(params, {"tokens": tokens})
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.item(), dict(zip(names, grads))


def train_grad_cases() -> list:
    """``(name, config, batch, sequence)`` of the whole-model gradient
    checks: the smoke configs in f32 and bf16, then one pattern period at
    full width."""
    import dataclasses

    from repro_torch.configs.base import get_config, get_smoke_config

    cases = []
    for arch in ("qwen3_4b", "xlstm_1_3b"):
        for dtype in ("float32", "bfloat16"):
            cases.append((f"{arch} smoke {dtype}",
                          dataclasses.replace(get_smoke_config(arch), dtype=dtype), 2, 64))
        full = get_config(arch)
        cases.append((f"{arch} full width, one period, bf16",
                      dataclasses.replace(full, num_layers=len(full.block_pattern)), 1,
                      TRAIN_GRAD_SEQ))
    return cases


def check_train_grads(seed: int, device, log) -> dict:
    """Gradients through the kernel-backed autograd Functions against the
    plain path's autograd on the card: whole models at the smoke configs
    (qwen3-4b and xlstm-1.3b, f32 and bf16) and at full width with one
    pattern period (qwen3-4b's one layer, xlstm-1.3b's mLSTM and sLSTM) on
    a sequence of TRAIN_GRAD_SEQ, per leaf within TRAIN_GRAD_TOL; then each
    Function alone at the full-width shapes (kernel 6: 32 query heads over
    8 of 128, bf16; kernel 7: 4 heads of 512, f32 and bf16 r): outputs
    within the kernels' twin tolerances and gradients equal bit for bit to
    the twin's (the backward is the twin's)."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import slstm as kslstm

    gen = torch.Generator(device=device).manual_seed(seed + 11)
    out = {"cases": {}, "functions": {}, "tol": TRAIN_GRAD_TOL}
    for name, cfg, b, s in train_grad_cases():
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device=device,
                             dtype=torch.int32)
        loss_k, got = leaf_grads(cfg, seed, toks, device)
        with plain_twins():
            loss_p, want = leaf_grads(dataclasses.replace(cfg, attention_impl="plain"), seed,
                                      toks, device)
        worst = max((float((got[n].float() - w.float()).abs().max())
                     / max(float(w.float().abs().max()), 1e-30), n) for n, w in want.items())
        tol = TRAIN_GRAD_TOL[cfg.dtype]
        out["cases"][name] = {"loss": loss_k, "plain_loss": loss_p, "worst_leaf": worst[1],
                              "worst_ratio": worst[0], "tol": tol}
        log(f"train grads {name}: loss {loss_k} (plain {loss_p}), worst leaf {worst[1]} at "
            f"{worst[0]:.3e} of its scale (tol {tol})")
        check(worst[0] <= tol, f"train grads {name}: leaf {worst[1]} differs by {worst[0]} of "
              f"its scale from the plain path's")
        del got, want
    q = torch.randn((1, 32, TRAIN_GRAD_SEQ, 128), generator=gen, device=device).bfloat16()
    k, v = (torch.randn((1, 8, TRAIN_GRAD_SEQ, 128), generator=gen, device=device).bfloat16()
            for _ in range(2))
    go = torch.randn((1, TRAIN_GRAD_SEQ, 32, 128), generator=gen, device=device).bfloat16()
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    o = kflash.FlashAttention.apply(*ins, True, None, None, 4)
    gk = torch.autograd.grad(o, ins, go)
    po = kflash.flash_attention_plain(*ins, q_heads_per_kv=4)
    gp = torch.autograd.grad(po, ins, go.permute(0, 2, 1, 3))
    err = twin_error("flash_attention", o.permute(0, 2, 1, 3), po, FLASH_TOL["bfloat16"], device)
    check(all(torch.equal(a, b) for a, b in zip(gk, gp)),
          "FlashAttention's gradients differ from its twin's")
    out["functions"]["FlashAttention"] = {"max_abs_err": err, "grads_equal": True}
    hd, h, s = 512, 4, TRAIN_GRAD_SEQ
    pre = torch.randn((1, h, s, 4, hd), generator=gen, device=device)
    states = [torch.zeros((1, h, hd), device=device) for _ in range(3)]
    states.append(torch.full((1, h, hd), -1e30, device=device))
    for rdt in (torch.float32, torch.bfloat16):
        r = (torch.randn((h, 4, hd, hd), generator=gen, device=device) / hd ** 0.5).to(rdt)
        ins = [t.clone().requires_grad_(True) for t in (pre, r, *states)]
        outs = kslstm.SlstmSequence.apply(*ins)
        ghs = torch.randn(outs[0].shape, generator=gen, device=device)
        gk = torch.autograd.grad(outs[0], ins, ghs)
        hs_p, _ = kslstm.slstm_sequence_plain(*ins)
        gp = torch.autograd.grad(hs_p, ins, ghs)
        err = twin_error("slstm_sequence", outs[0], hs_p, SLSTM_TOL["main"], device)
        check(all(torch.equal(a, b) for a, b in zip(gk, gp)),
              f"SlstmSequence's gradients differ from its twin's (r {rdt})")
        out["functions"][f"SlstmSequence r {str(rdt)[6:]}"] = {"max_abs_err": err,
                                                              "grads_equal": True}
    log("train grads functions: " + json.dumps(out["functions"]))
    return out


def check_train_resume(seed: int, device, log) -> dict:
    """Crash and resume at the smoke config on the card: 6 steps straight
    (run A); 6 steps with a checkpoint every 3 and a crash before step 4,
    then a new Trainer on the same directory (run B).  B resumes at step 3
    and reaches A's final loss and weights bit for bit under
    ``torch.use_deterministic_algorithms(True)``; where an operation has no
    deterministic implementation (it raises), the runs repeat without and
    the final losses must agree within 1e-6 relative (the reason is
    reported)."""
    import tempfile

    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import ShardedLoader, SyntheticCorpus
    from repro_torch.models.api import build_model
    from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig, TrainStepConfig

    r = TRAIN_RESUME
    tcfg = TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=r["steps"])

    def trainer(directory=None, crash=None):
        cfg = get_smoke_config("qwen3_4b")
        corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=r["seq"], seed=seed,
                                 device=device)
        return Trainer(build_model(cfg, device=device), ShardedLoader(corpus, r["batch"]), tcfg,
                       TrainerConfig(total_steps=r["steps"], log_every=1, seed=seed,
                                     checkpoint_every=r["every"] if directory else 0,
                                     checkpoint_dir=directory, crash_at_step=crash),
                       log_fn=lambda m: None)

    def runs():
        a = trainer()
        loss_a = a.run()["history"][-1]["loss"]
        with tempfile.TemporaryDirectory() as d:
            try:
                trainer(d, crash=r["crash"]).run()
                crashed = False
            except SimulatedFailure:
                crashed = True
            b = trainer(d)
            resumed_at = b.step
            loss_b = b.run()["history"][-1]["loss"]
        same = all(torch.equal(x, y) for x, y in zip(a.params.parameters(), b.params.parameters()))
        return {"crashed": crashed, "resumed_at": resumed_at, "loss_a": loss_a,
                "loss_b": loss_b, "weights_equal": same}

    prev = torch.are_deterministic_algorithms_enabled()
    reason = None
    try:
        torch.use_deterministic_algorithms(True)
        res = runs()
    except RuntimeError as err:
        if "determinis" not in str(err):
            raise
        reason = str(err).splitlines()[0]
        torch.use_deterministic_algorithms(False)
        res = runs()
    finally:
        torch.use_deterministic_algorithms(prev)
    res.update(deterministic=reason is None, reason=reason)
    log("train resume: " + json.dumps(res))
    check(res["crashed"] and res["resumed_at"] == r["every"],
          f"train resume: crashed={res['crashed']} resumed at {res['resumed_at']}")
    if reason is None:
        check(res["loss_b"] == res["loss_a"] and res["weights_equal"],
              f"train resume: the resumed run ends at {res['loss_b']}, the straight run at "
              f"{res['loss_a']} (weights equal: {res['weights_equal']})")
    else:
        check(abs(res["loss_b"] - res["loss_a"]) <= 1e-6 * abs(res["loss_a"]),
              f"train resume: {res['loss_b']} against {res['loss_a']} ({reason})")
    return res


# ---------------------------------------------------------------------------
# Training over a mesh (the train-procs phase)
# ---------------------------------------------------------------------------
TRAIN_PROCS_WORLD = 4
TRAIN_PROCS_TIMEOUT_S = 600.0
# Depth cuts (qwen3-4b's widths stay; seq TRAIN_PROCS_SEQ, global batch 4):
# (a) on (2, 2) holds a quarter of each layer's f32 masters and moments a
# rank; (b) replicates the whole model on four ranks at 16 bytes a
# parameter plus the bf16 error (the tied embedding alone is 7.0 GB a
# rank); (c) gives each of four stages TRAIN_PROCS_LAYERS["c"] / 4 layers
# beside a replicated embedding.
TRAIN_PROCS_LAYERS = {"a": 4, "b": 1, "c": 4}
TRAIN_PROCS_SEQ = 1024
TRAIN_PROCS_STEPS = {"a": 2, "b": 2, "c": 2}
# (a)'s parameters after step 1 against the unsharded run's: AdamW's first
# step moves a weight by lr_1 g / (|g| + eps), so where both runs agree on
# the sign of g they agree to the f32 rounding of the update, and where the
# bf16 reductions flip it (g within a bf16 rounding of 0) they differ by
# 2 lr_1.  Gates: every entry within 2 lr_1 (+ 1e-6 |p|), and at most
# TRAIN_PROCS_FLIP_FRACTION of the entries beyond lr_1 / 2.
TRAIN_PROCS_FLIP_FRACTION = 1e-2
# (c)'s grad norm against the unsharded run's (relative): the same bf16
# forward, the microbatches' gradients summed in autograd on each stage
# and over stages in f32 against the one-card step's f32 accumulation.
TRAIN_PROCS_GNORM_TOL = 1e-2


def train_procs_configs(seed: int) -> dict:
    """The phase's runs, qwen3-4b at its published widths (bf16 compute over
    f32 masters), global batch 4 of TRAIN_PROCS_SEQ tokens, the loader's
    dedup over the group's table: (a) the GSPMD step (ZeRO-3 + TP) on
    (data, model) = (2, 2), 2 microbatches; (b) manual DP with the int8
    all-reduce on (data,) = (4,); (c) the pipeline on (stage,) = (4,), 4
    microbatches; (d) (a)'s configuration on one rank."""
    from repro_torch.launch.train_run import TrainRunConfig

    common = dict(arch="qwen3_4b", seq=TRAIN_PROCS_SEQ, batch=4, lr=TRAIN_LR, warmup_steps=10,
                  total_steps=100, dedup="distributed", seed=seed)
    return {
        "a": TrainRunConfig(kind="gspmd", mesh=(2, 2), microbatches=2,
                            num_layers=TRAIN_PROCS_LAYERS["a"], steps=TRAIN_PROCS_STEPS["a"],
                            **common),
        "b": TrainRunConfig(kind="manual_dp", mesh=(4,), grad_compression=True,
                            num_layers=TRAIN_PROCS_LAYERS["b"], steps=TRAIN_PROCS_STEPS["b"],
                            **common),
        "c": TrainRunConfig(kind="pipeline", mesh=(4,), microbatches=4,
                            num_layers=TRAIN_PROCS_LAYERS["c"], steps=TRAIN_PROCS_STEPS["c"],
                            **common),
        "d": TrainRunConfig(kind="gspmd", mesh=(1, 1), microbatches=2,
                            num_layers=TRAIN_PROCS_LAYERS["a"], steps=TRAIN_PROCS_STEPS["a"],
                            **common),
    }


def save_params_hook(path: str):
    """An ``on_step`` hook that writes the parameters after step 1 (whole,
    by name, on the host) to ``path``."""
    import torch

    def hook(i, params, opt, bundle):
        if i == 0:
            torch.save({n: p.detach().cpu() for n, p in params.named_parameters()}, path)
        return None

    return hook


def compare_params_hook(path: str):
    """An ``on_step`` hook that holds a rank's blocks after step 1 against
    the whole parameters at ``path``: the max |difference|, the largest
    |parameter|, and the count of entries beyond each threshold of the lr
    it is given later (returned as the differences' sorted quantiles)."""
    import torch

    from repro_torch.distributed import sharding

    def hook(i, params, opt, bundle):
        if i != 0:
            return None
        whole = torch.load(path, mmap=True)
        lay = bundle.layout
        worst, big, name_worst = 0.0, 0.0, None
        over = {}
        n = 0
        for name, p in params.named_parameters():
            want = whole[name][sharding.block_slices(lay.full_shapes[name], lay.specs[name],
                                                     lay.parallel.mesh, lay.coord)]
            want = want.to(p.device)
            diff = (p.detach().float() - want).abs()
            d = float(diff.max())
            if d > worst:
                worst, name_worst = d, name
            big = max(big, float(want.abs().max()))
            for k in (1e-6, 5e-5, 1e-4, 2e-4):
                over[k] = over.get(k, 0) + int((diff > k).sum())
            n += diff.numel()
        return {"max_abs": worst, "worst_leaf": name_worst, "max_param": big, "entries": n,
                "over": {str(k): v for k, v in over.items()}}

    return hook


def train_procs_rank(group, cfgs: dict, whole_path: str, device_name: str,
                     profile: bool = False) -> dict:
    """One rank of the spawned group: runs (a)-(c) in turn on the global
    batches it draws itself (the loader's dedup over the group's table);
    (a) holds its blocks after step 1 against the unsharded run's
    parameters at ``whole_path``; rank 0 captures kernel 6's inputs in
    (a) and keeps its rows of the first batch's fingerprints for kernel 1;
    with ``profile`` every run takes one more step, which rank 0 profiles
    (``train_procs_profile``)."""
    import torch

    from repro_torch.data import sequence_fingerprints
    from repro_torch.launch import train_run

    device = torch.device(device_name)
    lm_settings()
    out = {"rank": group.rank, "runs": {}}
    for key, cfg in cfgs.items():
        capture = KernelCapture(cfg.seq if group.rank == 0 and key == "a" else -1)
        hook = compare_params_hook(whole_path) if key == "a" else None
        extra = train_procs_profile(group.rank, device) if profile else None
        t0 = time.perf_counter()
        with capture:
            res = train_run.run_train(cfg, device=device, group=group, on_step=hook,
                                      extra_step=extra, timeout_s=TRAIN_PROCS_TIMEOUT_S)
        if group.rank == 0:
            print(f"train-procs ({key}) rank 0: {time.perf_counter() - t0:.1f} s, steps "
                  f"{[round(s['s'], 3) for s in res['steps']]} s, peak {res['peak_bytes']}",
                  flush=True)
        if group.rank == 0 and key == "a":
            out["flash"] = capture.flash
            # the first batch again through the local dedup (the same mask, no collective)
            first = train_run.draw_batches(dataclasses.replace(cfg, steps=1, dedup="local"),
                                           device)[0]
            n = first.shape[0] // group.size
            out["fingerprints"] = sequence_fingerprints(first[:n, :-1]).reshape(1, -1)
        out["runs"][key] = res
        del capture, res
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if group.rank == 0 and out.get("flash") is not None:
        a = out["runs"]["a"]
        out["rows"] = [train_procs_flash_row(*out.pop("flash"), a["launches"].get(
            "flash_attention", 0), device, print)]
        fp = out.pop("fingerprints")
        from types import SimpleNamespace

        from repro_torch.core.hashing import DEFAULT_SEED

        # The group's dedup table (DistributedHashTable's defaults): kernel 1
        # hashes rank 0's rows, kernel 2 bins them, as its build does.
        table = SimpleNamespace(num_shards=group.size, hash_range=train_run.DEDUP_HASH_RANGE,
                                seed=DEFAULT_SEED, num_bins=None)
        run = {"result": {"path": f"train-procs-gloo-{TRAIN_PROCS_WORLD} (a) loader",
                          "shards": TRAIN_PROCS_WORLD, "launches": a["data_launches"]},
               "inputs": lambda: hash_inputs(table, fp)}
        out["rows"] += check_kernels(run, device, print)
    else:
        out.pop("flash", None)
        out.pop("fingerprints", None)
    return out


class CollectiveClock:
    """Host seconds spent inside each kind of collective call of an
    ``Axis`` (the outermost call; under gloo a CUDA tensor's staging to
    host memory and back is inside), while the block runs."""

    KINDS = ("all_reduce", "all_gather", "all_gather_cols", "all_gather_bytes",
             "reduce_scatter", "broadcast", "all_to_all", "ppermute")

    def __enter__(self):
        from repro_torch.distributed import collectives

        self.seconds, self._depth = {}, 0
        self._axis = collectives.Axis
        self._orig = {k: getattr(self._axis, k) for k in self.KINDS}

        def wrap(kind, fn):
            def timed(axis, *a, **kw):
                if self._depth or axis.size == 1:
                    return fn(axis, *a, **kw)
                self._depth += 1
                t0 = time.perf_counter()
                try:
                    return fn(axis, *a, **kw)
                finally:
                    self._depth -= 1
                    self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0
            return timed

        for k, fn in self._orig.items():
            setattr(self._axis, k, wrap(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(self._axis, k, fn)
        return False


def train_procs_profile(rank: int, device):
    """An ``extra_step`` for ``run_train``: every rank runs one more step;
    rank 0 profiles it (``profile_phases``, with kernel 6's backward and the
    optimizer as windows) and times its collectives on the host
    (``CollectiveClock``)."""
    from repro_torch.kernels.flash_attention import BACKWARD_RANGE
    from repro_torch.train.step import OPTIMIZER_RANGE

    def extra(step, params, opt, batch):
        run = lambda: step(params, opt, batch)  # noqa: E731
        if rank != 0:
            run()
            return None
        with CollectiveClock() as clock:
            prof = profile_phases({"step": run}, device,
                                  window=(BACKWARD_RANGE, OPTIMIZER_RANGE))["step"]
        wall_ms = prof["wall_ms"]
        return {"wall_ms": wall_ms, "device_busy_ms": prof["device_busy_ms"],
                "device_busy_share": prof["device_busy_ms"] / wall_ms,
                "collectives_host_ms": {k: 1e3 * v for k, v in clock.seconds.items()},
                "collectives_share": 1e3 * sum(clock.seconds.values()) / wall_ms,
                "by_class": prof["by_class"],
                "top": [[k[:60], ms, n] for k, ms, n in prof["top"][:8]],
                "windows": {w: {"device_ms": x["device_ms"], "launches": x["launches"]}
                            for w, x in prof["windows"].items()}}

    return extra


def train_procs_flash_row(q, k, v, launches: int, device, log) -> dict:
    """Kernel 6 on rank 0's heads of (a)'s first attention call (its row of
    microbatch 0, layer 0) against its twin, timed beside the twin and
    SDPA."""
    return lm_procs_flash_row(q, k, v, launches, device,
                              f"train-procs-gloo-{TRAIN_PROCS_WORLD} (a)", log,
                              "rank 0's heads and row, microbatch 0, layer 0")


def train_procs_expected_launches(cfg) -> int:
    """Kernel 6's launches on one rank of a run: every attention layer the
    rank runs, forward and recomputation, per microbatch (gspmd), per step
    on the rank's rows (manual DP), per tick on the stage's layers
    (pipeline)."""
    from repro_torch.launch import train_run

    mcfg = train_run.model_config(cfg)
    layers = mcfg.num_periods * mcfg.block_pattern.count("attn")
    if cfg.kind == "gspmd":
        return 2 * layers * cfg.microbatches * cfg.steps
    if cfg.kind == "manual_dp":
        return 2 * layers * cfg.steps
    stages = cfg.mesh[0]
    return 2 * (layers // stages) * (cfg.microbatches + stages - 1) * cfg.steps


def train_procs_check(label: str, key: str, cfg, ranks: list, ref: dict, card: bool,
                      log) -> dict:
    """Gates of one run (module docstring, item 6b)."""
    import math

    from repro_torch.launch import train_run

    mcfg = train_run.model_config(cfg)
    first = ranks[0]
    gate = {}
    for res in ranks:
        r = res["rank"]
        check(res["batch_digests"] == ref["batch_digests"],
              f"{label}: rank {r}'s batches differ from the unsharded run's")
        check(res["param_bytes"] == res["expected_param_bytes"]
              and res["state_bytes"] == res["expected_state_bytes"],
              f"{label}: rank {r} holds {res['param_bytes']} parameter and {res['state_bytes']} "
              f"state bytes; shard_bytes_per_device says {res['expected_param_bytes']} and "
              f"{res['expected_state_bytes']}")
        want = train_run.design_collectives(mcfg, cfg.mesh, cfg.kind, cfg.seq, cfg.batch,
                                            cfg.microbatches,
                                            grad_compression=cfg.grad_compression,
                                            seq_parallel=cfg.seq_parallel)
        for st in res["steps"]:
            check(st["collectives"] == want, f"{label}: rank {r} step {st['step']}: collectives "
                  f"{st['collectives']}, the design {want}")
            check(all(math.isfinite(v) for v in st["metrics"].values()),
                  f"{label}: rank {r} step {st['step']}: a metric is not finite: {st['metrics']}")
            check(st["metrics"] == first["steps"][st["step"] - 1]["metrics"],
                  f"{label}: rank {r}'s metrics differ from rank 0's at step {st['step']}")
        if card:
            n6 = train_procs_expected_launches(cfg)
            check(res["launches"] == {"flash_attention": n6}, f"{label}: rank {r} launches "
                  f"{res['launches']}, want kernel 6 {n6} times")
            check(res["data_launches"].get("murmur_bucket", 0) > 0,
                  f"{label}: rank {r}'s loader launched {res['data_launches']}, no kernel 1")
    # replicated leaves: the same bits wherever a rank holds the same block
    for st in range(len(first["steps"])):
        seen = {}
        for res in ranks:
            for name, dig in res["steps"][st]["digests"].items():
                where = (name, tuple(res["block_slices"].get(name, ())))
                check(seen.setdefault(where, dig) == dig,
                      f"{label}: rank {res['rank']}'s block {where} differs from another rank's "
                      f"copy after step {st + 1}")
    m1, w1 = first["steps"][0]["metrics"], ref["steps"][0]["metrics"]
    gate["ce_step1"], gate["unsharded_ce_step1"] = m1["ce"], w1["ce"]
    if key in "ac":
        check(abs(m1["ce"] - w1["ce"]) <= TRAIN_CE_TOL * abs(w1["ce"]),
              f"{label}: step 1 ce {m1['ce']} against the unsharded run's {w1['ce']}")
    if key == "b":
        check(abs(m1["loss"] - w1["loss"]) <= TRAIN_CE_TOL * abs(w1["loss"]),
              f"{label}: step 1 loss {m1['loss']} against the unsharded run's {w1['loss']}")
        import torch

        from repro_torch.models import transformer

        numels = [p.numel() for p in transformer.Transformer(mcfg, dtype=torch.float32,
                                                             device="meta").parameters()]
        want_bytes = train_run.int8_wire_bytes(numels, cfg.mesh[0])
        for res in ranks:
            for st in res["steps"]:
                got = {k: st["bytes"].get(k, 0) for k in want_bytes}
                check(got == want_bytes, f"{label}: rank {res['rank']} step {st['step']}: the "
                      f"int8 all-reduce moved {got} bytes, one a gradient element a hop and "
                      f"the scales make {want_bytes}")
        gate["int8_wire_bytes"] = want_bytes
        gate["f32_all_reduce_bytes"] = 4 * sum(numels)
    if key == "c":
        g, gw = m1["grad_norm"], w1["grad_norm"]
        check(abs(g - gw) <= TRAIN_PROCS_GNORM_TOL * gw,
              f"{label}: step 1 grad norm {g} against the unsharded run's {gw}")
        gate["grad_norm_step1"], gate["unsharded_grad_norm_step1"] = g, gw
    if key == "a":
        lr1 = w1["lr"]
        worst = max(r["steps"][0]["check"]["max_abs"] for r in ranks)
        entries = sum(r["steps"][0]["check"]["entries"] for r in ranks)
        flips = sum(r["steps"][0]["check"]["over"]["5e-05"] for r in ranks)
        big = max(r["steps"][0]["check"]["max_param"] for r in ranks)
        check(worst <= 2 * lr1 + 1e-6 * big, f"{label}: a parameter after step 1 differs from "
              f"the unsharded run's by {worst} > 2 lr_1 = {2 * lr1}")
        check(flips <= TRAIN_PROCS_FLIP_FRACTION * entries,
              f"{label}: {flips} of {entries} parameter entries differ by more than lr_1 / 2")
        gate.update(params_max_abs=worst, lr1=lr1, entries_beyond_half_lr=flips, entries=entries,
                    over=[r["steps"][0]["check"]["over"] for r in ranks])
    log(f"{label} gates held: " + json.dumps(gate))
    return gate


def train_procs_report(label: str, cfg, ranks: list, ref: dict, smi: str, log) -> dict:
    """Per rank: each step's loss, ce, grad norm, wall and tokens/s, the
    collectives and bytes a step, parameter, state and peak bytes; beside
    the unsharded run's."""

    def figures(res):
        return {"steps": [{"step": s["step"], **{k: s["metrics"][k] for k in
                                                ("loss", "ce", "grad_norm", "lr")},
                           "step_ms": 1e3 * s["s"],
                           "tokens_per_s": cfg.batch * cfg.seq / s["s"]} for s in res["steps"]],
                "collectives": res["steps"][0]["collectives"],
                "bytes": res["steps"][0]["bytes"],
                "param_bytes": res["param_bytes"], "state_bytes": res["state_bytes"],
                "peak_bytes": res["peak_bytes"], "init_s": res["init_s"],
                "data_s": res["data_s"], "launches": res["launches"],
                "data_launches": res["data_launches"]}

    out = {"kind": cfg.kind, "mesh": cfg.mesh, "layers": ref["layers"], "seq": cfg.seq,
           "batch": cfg.batch, "microbatches": cfg.microbatches,
           "unsharded": figures(ref), "ranks": [figures(r) for r in ranks]}
    log(f"{label} unsharded ({smi}): " + json.dumps(out["unsharded"]))
    for res, fig in zip(ranks, out["ranks"]):
        log(f"{label} rank {res['rank']} of {len(ranks)} mesh {cfg.mesh} ({smi}): "
            + json.dumps(fig))
    return out


def run_train_procs(seed: int, device, log, profile: bool = False) -> dict:
    """The ``train-procs`` phase: training over a mesh.  Each run
    (``train_procs_configs``) goes first unsharded on this card, in this
    process, on the same weights and batches (its figures to host memory,
    (a)'s parameters after step 1 to a file, its model freed); then (a)-(c)
    run in one spawn of four gloo ranks on this card and (d) on one NCCL
    rank in this process, bit for bit the unsharded step.  ``profile``: rank
    0 profiles one more step of each run (``train_procs_profile``)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh, train_run

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    t_phase = time.perf_counter()
    cfgs = train_procs_configs(seed)
    scratch = tempfile.mkdtemp(prefix="train_procs_")
    whole_path = os.path.join(scratch, "a_step1.pt")

    def unsharded(key, hook=None):
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = train_run.run_train(cfgs[key], sharded=False, device=device, on_step=hook)
        log(f"train-procs ({key}) unsharded {ref['arch']} ({ref['layers']} layers, "
            f"{cfgs[key].kind} reference): {time.perf_counter() - t0:.1f} s")
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        return ref

    try:
        refs = {"a": unsharded("a", save_params_hook(whole_path)),
                "b": unsharded("b"), "c": unsharded("c")}
        label = f"train-procs-gloo-{TRAIN_PROCS_WORLD}"
        t0 = time.perf_counter()
        ranks = mesh.spawn(train_procs_rank, TRAIN_PROCS_WORLD, "gloo", str(device),
                           args=({k: cfgs[k] for k in "abc"}, whole_path, str(device),
                                 profile), timeout_s=TRAIN_PROCS_TIMEOUT_S)
        result = {"path": "train-procs", "gloo4_s": time.perf_counter() - t0, "runs": {}}
        log(f"{label}: {result['gloo4_s']:.1f} s from spawn to the last result")
        for key in "abc":
            runs = [r["runs"][key] for r in ranks]
            result["runs"][key] = train_procs_report(f"{label} ({key})", cfgs[key], runs,
                                                     refs[key], smi, log)
            result["runs"][key]["gate"] = train_procs_check(f"{label} ({key})", key, cfgs[key],
                                                            runs, refs[key], card, log)
            if runs[0]["extra"] is not None:
                result["runs"][key]["profile"] = runs[0]["extra"]
                log(f"profile {label} ({key}) rank 0 ({smi}): " + json.dumps(runs[0]["extra"]))
        rows = ranks[0].get("rows", [])
        if card:
            check({row["name"] for row in rows} == {"flash_attention", "murmur_bucket",
                                                    "bin_histogram"},
                  f"{label}: rank 0 checked {[row['name'] for row in rows]}")
        del ranks
    finally:
        for name in os.listdir(scratch):
            os.remove(os.path.join(scratch, name))
        os.rmdir(scratch)
    backend = "nccl" if card else "gloo"
    store = tempfile.mkdtemp(prefix="train_procs_world1_")
    mesh.init_shard_group(backend, "file://" + os.path.join(store, "store"),
                          timeout_s=TRAIN_PROCS_TIMEOUT_S, rank=0, world_size=1, device=device)
    try:
        one = train_run.run_train(cfgs["d"], device=device, timeout_s=TRAIN_PROCS_TIMEOUT_S)
    finally:
        dist.destroy_process_group()
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    label1 = f"train-procs-{backend}-1 (d)"
    ref = refs["a"]
    same = ([s["metrics"] for s in one["steps"]] == [s["metrics"] for s in ref["steps"]]
            and [s["digests"] for s in one["steps"]] == [s["digests"] for s in ref["steps"]])
    check(same, f"{label1}: the steps differ from the unsharded run's (want bit for bit)")
    check(one["batch_digests"] == ref["batch_digests"], f"{label1}: other batches")
    check(one["launches"] == ref["launches"], f"{label1}: launches {one['launches']}, the "
          f"unsharded run's {ref['launches']}")
    if card:
        n6 = train_procs_expected_launches(cfgs["d"])
        check(one["launches"] == {"flash_attention": n6},
              f"{label1}: launches {one['launches']}, want kernel 6 {n6} times")
    result["runs"]["d"] = train_procs_report(label1, cfgs["d"], [one], ref, smi, log)
    result["runs"]["d"]["gate"] = {"bit_for_bit": same}
    del one, refs
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    result["run_s"] = time.perf_counter() - t_phase
    log(f"run train-procs: {result['run_s']:.1f} s (three unsharded runs, four gloo ranks on one "
        f"card, one {backend} rank, gates and rank 0's kernel checks; {smi})")
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# LM parallelism across processes (the lm-procs phase)
# ---------------------------------------------------------------------------
LM_PROCS_WORLD = 4
LM_PROCS_TIMEOUT_S = 600.0
# Run (a)'s depth: granite-20b at 13 of its 52 layers (full width, its one
# kv head, the sequence-sharded cache and the sequence-parallel prefill as
# at 52): at 52 it took ≈ 94 of the phase's 194 s on four gloo ranks of an
# H100, and the script's time limit needs the room.  Run (b)'s: qwen3-4b's
# 36 layers would gather every layer's FSDP blocks over `data` through gloo
# (host memory) at every prefill and decode step, minutes of staging on one
# card; 4 layers keep the widths and every layer's gathers.
LM_PROCS_GRANITE_LAYERS = 13
LM_PROCS_QWEN_LAYERS = 4
# Logits of the sharded runs against the unsharded run's (absolute).
# (a) granite-20b, bf16: its untied head gives logits up to ~4.5, where one
# bf16 step is 2^-6 ~ 0.016 (qwen3's tied head stays under 0.7, so
# LM_LOGIT_TOL holds (b)); at its 52 layers the card measured at most
# 0.0938 over 64 positions, and the unsharded run's own replay through
# forward_train with plain attention differs from it by 0.0781: the gate is
# twice that sharded maximum, kept at 13 layers (measured 0.0625 there, the
# replay 0.0527).  (c) xlstm-1.3b, f32: the split row-parallel sums and out_norm's
# mean over tp round in another order, and the random-weight recurrence
# amplifies a rounding over the prompt: the unsharded model's own logits
# move by 0.0989 (2,672 tokens) and 0.0159 (1,523) when one norm weight of
# layer 0 changes by 1e-7 relative (``lm_procs_sensitivity``, reported every
# run), and the card measured at most 0.176: the gate is twice that maximum.
# Kernel 7 adds nothing: a rank's one-head launches are bit for bit the
# whole launch's heads (tests/test_torch_cuda.py -k slstm_head_slices).
LM_PROCS_LOGIT_TOL = {"a": 0.2, "b": LM_LOGIT_TOL, "c": 0.36}


def lm_procs_configs(seed: int) -> dict:
    """The phase's four runs: (a) granite-20b bf16 at full width,
    LM_PROCS_GRANITE_LAYERS layers, on (1, 4) with production_parallel's
    defaults; (b) qwen3-4b bf16 at full width, LM_PROCS_QWEN_LAYERS layers,
    on (2, 2); (c) xlstm-1.3b f32 at full
    width and depth on (1, 4); (d) qwen3-4b bf16 at full width and depth on
    one NCCL rank.  Prompts from ``seed`` in LM_PROMPT_LENS, the first
    rounded down to a multiple of 4; slots of LM_CACHE_LEN."""
    from repro_torch.launch.lm_run import LMRunConfig

    common = dict(slots=2, cache_len=LM_CACHE_LEN, prompt_lens=LM_PROMPT_LENS,
                  first_multiple=4, seed=seed)
    return {
        "a": LMRunConfig(arch="granite_20b", num_layers=LM_PROCS_GRANITE_LAYERS, mesh=(1, 4),
                         requests=4, max_new=(16,), **common),
        "b": LMRunConfig(arch="qwen3_4b", num_layers=LM_PROCS_QWEN_LAYERS, mesh=(2, 2),
                         requests=4, max_new=(8,), **common),
        "c": LMRunConfig(arch="xlstm_1_3b", dtype="float32", mesh=(1, 4), requests=2,
                         max_new=(8,), **common),
        "d": LMRunConfig(arch="qwen3_4b", mesh=(1, 1), requests=4, max_new=(16,), **common),
    }


class KernelCapture:
    """Copies of the inputs kernels 6 and 7 get on this rank, for the kernel
    checks after the run: kernel 6's first call at each sequence length of
    ``lengths`` (q, k, v and its options, in ``calls``; ``flash`` the first
    length's q, k, v) and kernel 7's first call at the first length
    (``slstm``).  The launches themselves go through unchanged."""

    def __init__(self, lengths=()):
        self.lengths = (lengths,) if isinstance(lengths, int) else tuple(lengths)
        self.calls, self.slstm = {}, None

    @property
    def flash(self):
        got = self.calls.get(self.lengths[0]) if self.lengths else None
        return None if got is None else got[:3]

    def __enter__(self):
        from repro_torch.kernels import flash_attention, slstm

        self._flash, self._slstm = flash_attention, slstm
        self._flash_fn, self._slstm_fn = flash_attention.flash_attention_bhsd, slstm.slstm_sequence

        def flash(q, k, v, **kw):
            s = q.shape[2]
            if s in self.lengths and s not in self.calls:
                self.calls[s] = tuple(t.detach().clone() for t in (q, k, v)) + (
                    {n: kw[n] for n in ("causal", "window", "q_heads_per_kv") if n in kw},)
            return self._flash_fn(q, k, v, **kw)

        def recurrence(pre, r, *states):
            if self.slstm is None and self.lengths and pre.shape[2] == self.lengths[0]:
                self.slstm = (pre.detach().clone(), r.detach().clone(),
                              tuple(t.detach().clone() for t in states))
            return self._slstm_fn(pre, r, *states)

        flash_attention.flash_attention_bhsd, slstm.slstm_sequence = flash, recurrence
        return self

    def __exit__(self, *exc):
        self._flash.flash_attention_bhsd = self._flash_fn
        self._slstm.slstm_sequence = self._slstm_fn
        return False


def lm_procs_flash_row(q, k, v, launches: int, device, label: str, log,
                       what: str = "rank 0's heads, request 0, layer 0") -> dict:
    """Kernel 6 on rank 0's own heads of one run's first layer (q (1, Hq, S,
    D) over k/v (1, Hkv, S, D)) against its twin, timed beside the twin and
    SDPA."""
    import torch.nn.functional as F

    _, hq, s, d = q.shape
    hkv = k.shape[1]
    return flash_row(label, q, k, v, dict(causal=True, q_heads_per_kv=hq // hkv), launches,
                     f"q=(1, {hq}, {s}, {d}) k/v=(1, {hkv}, {s}, {d}) {q.dtype} causal ({what})",
                     device, log, lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=True), shards=LM_PROCS_WORLD)


def lm_procs_slstm_row(pre, r, states, launches: int, device, label: str, log) -> dict:
    """Kernel 7 on rank 0's head of request 0's first sLSTM layer (the bf16
    serving copy's r: the cluster variant) against its twin in
    SLSTM_CHUNK-step chunks, timed."""
    from repro_torch.kernels import slstm

    b, h, s, _, hd = pre.shape
    err, _ = slstm_chunks_against_twin(pre, r, states, device)
    times = spread_ms({"kernel": lambda: slstm.slstm_sequence(pre, r, *states)}, device,
                      SLSTM_TIMING["groups"], SLSTM_TIMING["launches"])
    bounds = slstm_bounds(b, h, s, hd, r.element_size())
    bound_by = max(bounds, key=bounds.get)
    plan = slstm.card_plan(hd, r.dtype, b, h) if device.type == "cuda" else \
        slstm.launch_plan(hd, r.dtype, b)
    row = {"name": "slstm_sequence", "path": label, "shards": LM_PROCS_WORLD,
           "launches": launches, "route": "cuda", "source": KERNELS["slstm_sequence"][0],
           "replaces": KERNELS["slstm_sequence"][1], "max_abs_err": err,
           "ms": times["kernel"][1],
           "plain_ms": mean_ms(lambda: slstm.slstm_sequence_plain(pre, r, *states), 3, device),
           "bound_ms": bounds[bound_by], "bound_by": bound_by, "library_ms": None,
           "shapes": f"pre=({b}, {h}, {s}, 4, {hd}) f32 r=({h}, 4, {hd}, {hd}) {r.dtype} "
                     "(rank 0's head, request 0, first sLSTM layer)",
           "variant": plan["variant"], "spread_ms": times}
    log(f"kernel slstm_sequence {label} {row['shapes']}: variant={plan['variant']} "
        f"max_abs_err={err} (tol {SLSTM_TOL['main']}, {SLSTM_CHUNK}-step chunks) [min, median, "
        f"max] ms: {json.dumps(times)} plain_ms={row['plain_ms']} bound_ms={row['bound_ms']} "
        f"({bound_by}) launches={launches}")
    return row


def lm_procs_rank(group, cfgs: dict, forced: dict, device_name: str) -> dict:
    """One rank of the spawned group: runs (a)-(c) in turn, each teacher-
    forced with the unsharded run's tokens; rank 0 keeps the logits and
    holds kernels 6 and 7 against their twins on the inputs its own path
    gave them (rows ``lm-procs-gloo-4``)."""
    import torch

    from repro_torch.launch import lm_run

    device = torch.device(device_name)
    lm_settings()
    label = f"lm-procs-gloo-{LM_PROCS_WORLD}"
    out = {"rank": group.rank, "runs": {}, "rows": []}
    for key, cfg in cfgs.items():
        first = len(lm_run.draw_prompts(cfg, lm_run.model_config(cfg).vocab_size)[0])
        capture = KernelCapture(first if group.rank == 0 else -1)
        with capture:
            res = lm_run.run_lm(cfg, device=device, forced=forced[key],
                                keep_logits=group.rank == 0, timeout_s=LM_PROCS_TIMEOUT_S)
        if group.rank == 0 and capture.flash is not None and key == "a":
            out["rows"].append(lm_procs_flash_row(*capture.flash,
                                                  res["launches"].get("flash_attention", 0),
                                                  device, f"{label} (a)", print))
        if group.rank == 0 and capture.slstm is not None and key == "c":
            out["rows"].append(lm_procs_slstm_row(*capture.slstm,
                                                  res["launches"].get("slstm_sequence", 0),
                                                  device, f"{label} (c)", print))
        out["runs"][key] = res
        del capture, res
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def lm_procs_check(label: str, cfg, ranks: list, ref: dict, tol, card: bool, log) -> dict:
    """Gates of one run: every rank's tokens and logits the same bits; rank
    0's logits at every generated position within ``tol`` of the unsharded
    run's (``tol`` None: equal bit for bit) and its argmax the unsharded
    token wherever that run's top-1 beats its top-2 by more than 2 * tol;
    each rank's parameter bytes ``shard_bytes_per_device``; each call's
    collectives ``lm_run.design_collectives``; kernel 6 once per attention
    layer per prefill, kernel 7 once per sLSTM layer per prefill and decode
    step (on the card)."""
    import numpy as np

    from repro_torch.launch import lm_run

    mcfg = lm_run.model_config(cfg)
    first = ranks[0]
    worst, sure, positions = 0.0, 0, 0
    for res in ranks:
        check(res["tokens"] == first["tokens"] and res["logit_digests"] == first["logit_digests"],
              f"{label}: rank {res['rank']}'s tokens or logits differ from rank 0's")
        check(res["param_bytes"] == res["shard_bytes"],
              f"{label}: rank {res['rank']} holds {res['param_bytes']} parameter bytes, "
              f"shard_bytes_per_device says {res['shard_bytes']}")
        for call in res["prefill"]:
            want = lm_run.design_collectives(mcfg, cfg.mesh, "prefill", call["len"],
                                             call.get("rows", 1), cfg.cache_len)
            check(call["collectives"] == want, f"{label}: rank {res['rank']} prefill of "
                  f"{call['len']}: collectives {call['collectives']}, the design {want}")
        for call in res["decode"]:
            want = lm_run.design_collectives(mcfg, cfg.mesh, "decode", 1, cfg.slots,
                                             cfg.cache_len)
            check(call["collectives"] == want, f"{label}: rank {res['rank']} decode step: "
                  f"collectives {call['collectives']}, the design {want}")
        if card:
            want = expected_launches(mcfg, len(res["prefill"]), len(res["decode"]))
            check(res["launches"] == want, f"{label}: rank {res['rank']} launches "
                  f"{res['launches']}, want {want}")
    for uid, want in ref["logits"].items():
        got = first["logits"][uid]
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"{label}: request {uid}: logits {got.shape} against {want.shape}")
        if tol is None:
            check(np.array_equal(got, want), f"{label}: request {uid}: logits differ from the "
                  "unsharded run's (want bit for bit)")
            clear = np.ones(len(want), bool)
        else:
            per_pos = np.abs(got - want).max(axis=-1)
            err = float(per_pos.max())
            worst = max(worst, err)
            check(err <= tol, f"{label}: request {uid}: logits differ from the unsharded run's "
                  f"by {err} > {tol} (per position: {per_pos.tolist()}; |logits| up to "
                  f"{float(np.abs(want).max())})")
            top2 = np.sort(want, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * tol
        mine = np.argmax(got, axis=-1)
        check(np.array_equal(mine[clear], np.asarray(ref["tokens"][uid])[clear]),
              f"{label}: request {uid}: a token differs from the unsharded run's clear argmax")
        sure, positions = sure + int(clear.sum()), positions + len(clear)
    gate = {"logit_tol": tol, "max_abs_err": worst if tol is not None else 0.0,
            "positions": positions, "tokens_compared": sure}
    log(f"{label} gates held: " + json.dumps(gate))
    return gate


def lm_procs_report(label: str, cfg, ranks: list, ref: dict, smi: str, log) -> dict:
    """Per rank: prefill tokens/s, TTFT, decode step ms, collectives and
    bytes a call, parameter and peak bytes, each request's prefill path;
    beside the unsharded run's."""

    def figures(res):
        pre = res["prefill"]
        full = [c["s"] for c in res["decode"] if c["live"] == cfg.slots]
        return {
            "prefill_tokens_per_s": sum(c["len"] for c in pre) / sum(c["s"] for c in pre),
            "ttft_s": [c["ttft_s"] for c in pre],
            "prefill_s": [c["s"] for c in pre],
            "prefill_paths": [c["path"] for c in pre],
            "decode_step_ms_all_live": 1e3 * sum(full) / len(full) if full else None,
            "decode_steps": len(res["decode"]),
            "collectives_prefill": [c["collectives"] for c in pre],
            "bytes_prefill": [sum(c["bytes"].values()) for c in pre],
            "collectives_decode": res["decode"][0]["collectives"] if res["decode"] else {},
            "bytes_decode": sum(res["decode"][0]["bytes"].values()) if res["decode"] else 0,
            "param_bytes": res["param_bytes"], "peak_bytes": res["peak_bytes"],
            "init_s": res["init_s"], "total_s": res["total_s"], "launches": res["launches"],
        }

    out = {"arch": ref["arch"], "layers": ref["layers"], "dtype": ref["dtype"],
           "mesh": cfg.mesh, "prompt_lens": ref["prompt_lens"],
           "replay": ref.get("replay"), "sensitivity": ref.get("sensitivity"),
           "unsharded": figures(ref),
           "ranks": [figures(r) for r in ranks]}
    log(f"{label} unsharded ({smi}): " + json.dumps(out["unsharded"]))
    for res, fig in zip(ranks, out["ranks"]):
        log(f"{label} rank {res['rank']} of {len(ranks)} mesh {cfg.mesh} ({smi}): "
            + json.dumps(fig))
    log(f"{label}: " + json.dumps({k: v for k, v in out.items() if k not in ("unsharded",
                                                                           "ranks")}))
    return out


def lm_procs_replay(ref: dict) -> dict:
    """How far the unsharded run's logits lie from its own teacher-forced
    replay through ``forward_train`` with plain attention, on the device:
    the bf16 noise of an equally valid computation, reported beside the
    sharded run's gate (not gated)."""
    import dataclasses

    import numpy as np

    from repro_torch.models.api import build_model

    bundle, params = ref["bundle"], ref["params"]
    plain = build_model(dataclasses.replace(bundle.cfg, attention_impl="plain"),
                        device=bundle.device)
    worst, scale = 0.0, 0.0
    for uid, prompt in enumerate(ref["prompts"]):
        toks = np.concatenate([prompt, np.asarray(ref["tokens"][uid][:-1], np.int32)])
        logits, _ = plain.forward_train(params, np.concatenate([toks, [0]])[None].astype(np.int32))
        replay = logits[0, len(prompt) - 1:].float().cpu().numpy()
        worst = max(worst, float(np.abs(replay - ref["logits"][uid]).max()))
        scale = max(scale, float(np.abs(replay).max()))
        del logits
    return {"max_abs_err": worst, "max_abs_logit": scale}


def lm_procs_sensitivity(ref: dict) -> dict:
    """How far the unsharded model's own prefill logits move when one norm
    weight of its first layer changes by 1e-7 relative (normal noise), per
    request: the scale at which the recurrence amplifies a rounding
    (reported beside the gate of the xLSTM run, not gated)."""
    import numpy as np
    import torch

    from repro_torch.serve import make_prefill_step

    bundle, params = ref["bundle"], ref["params"]
    prefill = make_prefill_step(bundle, cache_len=max(len(p) for p in ref["prompts"]))
    w = params.layers[0].b0.mixer.norm
    keep = w.detach().clone()
    gen = torch.Generator(device=w.device).manual_seed(5)
    noise = 1 + 1e-7 * torch.randn(w.shape, generator=gen, device=w.device)
    out = {}
    for uid, prompt in enumerate(ref["prompts"]):
        with torch.no_grad():
            w.mul_(noise)
            moved = prefill(params, {"tokens": prompt[None]})[0][0].float().cpu().numpy()
            w.copy_(keep)
        out[uid] = float(np.abs(moved - ref["logits"][uid][0]).max())
    return out


def run_lm_procs(seed: int, device, log) -> dict:
    """The ``lm-procs`` phase: LM parallelism across processes.  Each run
    (``lm_procs_configs``) goes first unsharded on this card (its logits to
    host memory, its model freed), then (a)-(c) run in one spawn of four
    gloo ranks on this card, teacher-forced with the unsharded tokens, and
    (d) on one NCCL rank in this process, bit for bit."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import lm_run, mesh

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    t_phase = time.perf_counter()
    cfgs = lm_procs_configs(seed)
    tols = {**LM_PROCS_LOGIT_TOL, "d": None}

    def unsharded(key):
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = lm_run.run_lm(cfgs[key], sharded=False, device=device, keep_model=True)
        if key in "ab":
            ref["replay"] = lm_procs_replay(ref)
        if key == "c":
            ref["sensitivity"] = lm_procs_sensitivity(ref)
        for name in ("bundle", "params", "prompts"):
            ref.pop(name)
        log(f"lm-procs ({key}) unsharded {ref['arch']} ({ref['layers']} layers, {ref['dtype']}): "
            f"{time.perf_counter() - t0:.1f} s; its own replay {ref.get('replay')}, its "
            f"sensitivity {ref.get('sensitivity')}")
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        return ref

    refs = {key: unsharded(key) for key in "abc"}
    label = f"lm-procs-gloo-{LM_PROCS_WORLD}"
    t0 = time.perf_counter()
    ranks = mesh.spawn(lm_procs_rank, LM_PROCS_WORLD, "gloo", str(device),
                       args=({k: cfgs[k] for k in "abc"},
                             {k: refs[k]["tokens"] for k in "abc"}, str(device)),
                       timeout_s=LM_PROCS_TIMEOUT_S)
    result = {"path": "lm-procs", "gloo4_s": time.perf_counter() - t0, "runs": {}}
    log(f"{label}: {result['gloo4_s']:.1f} s from spawn to the last result")
    for key in "abc":
        runs = [r["runs"][key] for r in ranks]
        result["runs"][key] = lm_procs_report(f"{label} ({key})", cfgs[key], runs, refs[key],
                                              smi, log)
    for key in "abc":
        runs = [r["runs"][key] for r in ranks]
        result["runs"][key]["gate"] = lm_procs_check(f"{label} ({key})", cfgs[key], runs,
                                                     refs[key], tols[key], card, log)
    rows = ranks[0]["rows"]
    if card:
        check({row["name"] for row in rows} == {"flash_attention", "slstm_sequence"},
              f"{label}: rank 0 checked {[row['name'] for row in rows]}")
    del ranks, refs
    ref = unsharded("d")
    backend = "nccl" if card else "gloo"
    store = tempfile.mkdtemp(prefix="lm_procs_world1_")
    mesh.init_shard_group(backend, "file://" + os.path.join(store, "store"),
                          timeout_s=LM_PROCS_TIMEOUT_S, rank=0, world_size=1, device=device)
    try:
        one = lm_run.run_lm(cfgs["d"], device=device, forced=ref["tokens"],
                            timeout_s=LM_PROCS_TIMEOUT_S)
    finally:
        dist.destroy_process_group()
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    label1 = f"lm-procs-{backend}-1 (d)"
    result["runs"]["d"] = lm_procs_report(label1, cfgs["d"], [one], ref, smi, log)
    result["runs"]["d"]["gate"] = lm_procs_check(label1, cfgs["d"], [one], ref, None, card, log)
    del one, ref
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    result["run_s"] = time.perf_counter() - t_phase
    log(f"run lm-procs: {result['run_s']:.1f} s (four unsharded runs, four gloo ranks on one "
        f"card, one {backend} rank, gates and rank 0's kernel checks; {smi})")
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# MoE and the sliding-window ring cache (the moe phase)
# ---------------------------------------------------------------------------
MOE_ARCH = "mixtral_8x22b"
# (a) mixtral-8x22b at its published widths, 8 of its 56 layers: 2.504e9
# parameters a layer (5.01 GB in bf16) and 0.81 GB of embedding and head;
# 56 layers would take ~281 GB, 8 take ~40.9 GB of the card's 80.
MOE_LAYERS = 8
MOE_PROMPT_LENS = (3000, 4080, 5000, 6144)  # the second crosses the window while it decodes
MOE_SLOTS, MOE_CACHE_LEN, MOE_MAX_NEW = 2, 8192, 32
# Logits of the kernel-backed path (kernel 6 with the window, the grouped
# MoE) against the plain path and the teacher-forced pass: bf16 rounding in
# another order; the tests' bf16 logit tolerance, |a - b| <= atol + rtol |b|
# (tests/test_torch_lm.py: one bf16 step at |logit| ~ 4-8 is 2^-5).
MOE_LOGIT_TOL = {"atol": 6e-2, "rtol": 2e-2}
# A position whose experts differ between two passes is a router tie that
# rounding flipped only where the first differing layer's top-k gap (k-th
# minus (k+1)-th probability) is below this: bf16 rounding of the router's
# input (d = 6144, |x_i| ~ 1 after the norm, weights ~ 1/sqrt(d)) moves a
# logit by ~2^-9, a probability by ~1e-3 at most.
MOE_TIE = 1e-2
# One MoE layer's output against the all-experts form on the same input
# (relative and absolute: the experts' products at other row counts).
MOE_LAYER_TOL = 2e-2
# (b) expert parallelism across processes: 2 of 56 layers at full width,
# one row of MOE_EP_SEQ tokens a rank on (data, model) = (MOE_EP_WORLD, 1).
MOE_EP_LAYERS, MOE_EP_WORLD, MOE_EP_SEQ = 2, 4, 2048
MOE_EP_TIMEOUT_S = 300.0


def moe_serve_config():
    """(a)'s model: mixtral-8x22b at its published widths, MOE_LAYERS layers."""
    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)


def moe_ep_config(seed: int):
    """(b)'s run: mixtral-8x22b at full width, MOE_EP_LAYERS layers, EP on
    (data, model) = (MOE_EP_WORLD, 1)."""
    from repro_torch.launch import lm_run

    return lm_run.LMRunConfig(arch=MOE_ARCH, num_layers=MOE_EP_LAYERS,
                              mesh=(MOE_EP_WORLD, 1), moe_impl="ep", seed=seed)


def ring_oracle(length: int, width: int) -> "np.ndarray":
    """kpos of a ring of ``width`` slots after positions 0..length-1: the
    last ``width`` at ``pos % width``, -1 elsewhere (numpy)."""
    import numpy as np

    out = np.full(width, -1, np.int32)
    pos = np.arange(max(0, length - width), length, dtype=np.int32)
    out[pos % width] = pos
    return out


def check_ring_kpos(run: dict, log) -> dict:
    """Every request's ring ``kpos`` (each ``swa`` or ``local`` layer) after
    its prefill and after its last decode step equal to :func:`ring_oracle`."""
    import numpy as np

    cfg = run["cfg"]
    path = run["result"]["path"]
    width = min(cfg.sliding_window or cfg.local_window, run["result"]["cache_len"])
    new = run["result"]["max_new_tokens"]
    checked = 0
    for uid, prompt in enumerate(run["prompts"]):
        n = len(prompt)
        for when, got, length in (("prefill", run["ring_prefill"][uid], n),
                                  ("decode", run["ring_final"][uid], n + new - 1)):
            want = ring_oracle(length, width)
            for name, kpos in got.items():
                k = kpos.cpu().numpy()
                check(k.shape == (cfg.num_periods, width) and (k == want[None]).all(),
                      f"{path} ring {name} of request {uid} after {when}: kpos differs from the "
                      f"oracle of positions 0..{length - 1} ({int((k != want[None]).sum())} slots)")
                checked += 1
    out = {"width": width, "rings_checked": checked,
           "wrapped_in_prefill": [len(p) > width for p in run["prompts"]],
           "crossed_in_decode": [len(p) <= width < len(p) + new - 1 for p in run["prompts"]]}
    log(f"{path} ring kpos against the oracle: " + json.dumps(out))
    return out


class RouteCapture:
    """The experts every MoE layer of a pass chose (``ids`` (T, k), sorted
    per token) and each token's tie gap there (``gaps`` (T,): the router's
    k-th minus its (k+1)-th probability), in layer order."""

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route, self.ids, self.gaps = moe, moe.route, [], []

        def route(router, x2d, cfg):
            r = self._route(router, x2d, cfg)
            top = r.probs.topk(cfg.experts_per_token + 1, dim=-1).values
            self.ids.append(r.ids.sort(dim=-1).values)
            self.gaps.append(top[:, -2] - top[:, -1])
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False

    def at(self, row: int) -> tuple:
        """``(ids (L, k), gaps (L,))`` of one token over the layers."""
        import torch

        return (torch.stack([i[row] for i in self.ids]), torch.stack([g[row] for g in self.gaps]))


def route_flips(got: tuple, want: tuple) -> tuple:
    """Whether one token's experts differ between two passes at any layer,
    and, where they do, the first such layer's tie gap (the smaller of the
    two passes'): below MOE_TIE rounding alone can flip the choice."""
    (ids_a, gap_a), (ids_b, gap_b) = got, want
    differ = (ids_a != ids_b).any(dim=-1)
    if not bool(differ.any()):
        return False, None
    first = int(differ.nonzero()[0, 0])
    return True, float(min(gap_a[first], gap_b[first]))


def check_moe_serve(run: dict, device, log) -> dict:
    """The moe phase's model gates.  The batcher's logits at every
    generated position against a teacher-forced pass of prompt + generated
    tokens through the kernel-backed ``forward_train`` (kernel 6 once a
    layer), and each request's prefill logits against the plain path's
    (masked-einsum attention with the window), within MOE_LOGIT_TOL, each
    token the pass's argmax where its top-1 beats its top-2 by more than
    twice its atol.  A position whose experts differ between the two passes at
    some layer (a router tie that rounding flipped) is reported, not held
    to the tolerance, and the first differing layer's tie gap must lie
    below MOE_TIE; the prompt tokens whose experts differ between the
    kernel and the plain path are counted per layer."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.api import build_model

    cfg, bundle, params = run["cfg"], run["bundle"], run["params"]
    plain = build_model(dataclasses.replace(cfg, attention_impl="plain"), device=device)
    out = {"logit_tol": MOE_LOGIT_TOL, "tie": MOE_TIE, "prefill_max_abs_err": 0.0,
           "decode_max_abs_err": 0.0, "flipped_positions": [], "prompt_routes_differing": [],
           "routed_prompt_tokens": 0, "tokens_compared": 0, "positions": 0}

    def gate(label, got, want, flip, gap):
        err = float((got - want).abs().max())
        if flip:
            check(gap < MOE_TIE, f"{label}: experts differ at a router gap of {gap} >= {MOE_TIE}")
            out["flipped_positions"].append({"at": label, "max_abs_err": err, "gap": gap})
            return None
        ok = bool(((got - want).abs() <= MOE_LOGIT_TOL["atol"]
                   + MOE_LOGIT_TOL["rtol"] * want.abs()).all())
        check(ok, f"{label}: logits differ by up to {err} (tolerance {MOE_LOGIT_TOL})")
        return err

    build.LAUNCHES.clear()
    for req in run["done"]:
        n = len(req.prompt)
        toks = np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])[None]
        with RouteCapture() as forced:
            logits, _ = bundle.forward_train(params, toks)
        ref = logits[0, n - 1:].float()
        got = torch.stack(run["logits"][req.uid]).float()
        check(got.shape == ref.shape and bool(torch.isfinite(ref).all()),
              f"moe request {req.uid}: {tuple(got.shape)} against {tuple(ref.shape)}")
        kept = []
        for j in range(ref.shape[0]):
            flip, gap = route_flips(run["routes"][req.uid][j], forced.at(n - 1 + j))
            err = gate(f"moe request {req.uid} position {n - 1 + j} (teacher-forced)", got[j],
                       ref[j], flip, gap)
            if err is not None:
                kept.append(j)
                out["decode_max_abs_err"] = max(out["decode_max_abs_err"], err)
        top2 = ref.topk(2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > 2 * MOE_LOGIT_TOL["atol"]).cpu()
        sure &= torch.isin(torch.arange(ref.shape[0]), torch.as_tensor(kept, dtype=torch.long))
        tokens = torch.as_tensor(req.out_tokens)
        check(bool((tokens[sure] == ref.argmax(-1).cpu()[sure]).all()),
              f"moe request {req.uid}: a generated token differs from the pass's clear argmax")
        with RouteCapture() as flat:
            plain_logits, _ = plain.prefill(params, {"tokens": req.prompt[None]}, cache_len=n)
        flip, gap = route_flips(run["routes"][req.uid][0], flat.at(n - 1))
        pre = gate(f"moe request {req.uid} prefill (plain path)", got[0],
                   plain_logits[0].float(), flip, gap)
        if pre is not None:
            out["prefill_max_abs_err"] = max(out["prefill_max_abs_err"], pre)
        check(len(forced.ids) == len(flat.ids) == cfg.num_layers,
              f"moe: {len(forced.ids)} / {len(flat.ids)} routed layers, want {cfg.num_layers}")
        out["prompt_routes_differing"].append(
            [int((a[:n] != b).any(dim=-1).sum()) for a, b in zip(forced.ids, flat.ids)])
        out["routed_prompt_tokens"] += n * cfg.num_layers
        out["tokens_compared"] += int(sure.sum())
        out["positions"] += ref.shape[0]
        del logits, plain_logits, ref, got
    out["launches"] = dict(build.LAUNCHES)
    want = cfg.num_layers * len(run["done"])
    if device.type == "cuda":
        check(out["launches"] == {"flash_attention": want},
              f"moe teacher-forced passes: launches {out['launches']}, want {want} of kernel 6")
    log("moe serve gates held (teacher-forced pass through kernel 6, plain path): "
        + json.dumps(out))
    return out


def moe_layer_input(params, prompt, cfg, device):
    """Layer 0's MoE input in a prefill of ``prompt`` (the normed residual
    after its windowed attention)."""
    import torch

    from repro_torch.models import layers, transformer

    tokens = torch.as_tensor(prompt[None], device=device)
    with torch.no_grad():
        x = transformer._embed(params, tokens, cfg)
        block = params.layers[0].b0
        positions = torch.arange(x.shape[1], device=device, dtype=torch.int32)[None]
        x = transformer._mix_train("swa", block, x, positions, cfg)
        return layers.rmsnorm(x, block.norm2)


def check_moe_kernels(run: dict, device, log) -> list:
    """Kernel 6 at mixtral's windowed shape (request 3's layer-0 q, k, v:
    48 q heads over 8 kv heads, 6,144 tokens, window 4,096) against its
    twin (FLASH_TOL), timed beside the twin and SDPA with the window as an
    explicit boolean mask; one MoE layer (layer 0 on request 0's prompt):
    the grouped form's routing ids and output against the all-experts form,
    both timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import moe

    cfg, params = run["cfg"], run["params"]
    window = cfg.sliding_window
    prompt = max(run["prompts"], key=len)
    q, k, v = block_qkv(params, prompt, cfg, device, 0)
    hq, s, d = q.shape
    args = dict(causal=True, window=window, q_heads_per_kv=cfg.q_per_kv)
    mask = flash.live_mask(s, s, causal=True, window=window, device=device)
    row = flash_row("moe-serve", q, k, v, args, run["result"]["launches"].get("flash_attention", 0),
                    f"q=({hq}, {s}, {d}) k/v=({k.shape[0]}, {s}, {d}) bf16 causal window={window} "
                    "(the longest request, layer 0, strided views of the projections)", device,
                    log, lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                                attn_mask=mask, enable_gqa=True)[0])
    del q, k, v, mask
    x = moe_layer_input(params, run["prompts"][0], cfg, device)
    m = params.layers[0].b0.mlp.moe
    x2 = x.reshape(-1, cfg.d_model)
    got, want = moe.route(m.router, x2, cfg).ids, torch.topk(
        torch.softmax(x2.float() @ m.router.float(), dim=-1), cfg.experts_per_token).indices
    check(torch.equal(got, want), "moe layer 0: routing ids differ from the plain form's")
    out, _ = moe.moe_dense(m, x, cfg)
    ref, _ = moe.moe_dense_all(m, x, cfg)
    diff = (out.float() - ref.float()).abs()
    bad = int((diff > MOE_LAYER_TOL * (1 + ref.float().abs())).sum())
    check(bad == 0, f"moe layer 0: {bad} outputs differ from the all-experts form by more than "
          f"{MOE_LAYER_TOL}")
    ms = {"grouped": mean_ms(lambda: moe.moe_dense(m, x, cfg), 3, device),
          "all_experts": mean_ms(lambda: moe.moe_dense_all(m, x, cfg), 3, device)}
    t = x2.shape[0]
    flops = 2 * 3 * cfg.d_model * cfg.d_ff * t * cfg.experts_per_token
    layer = {"tokens": t, "max_abs_err": float(diff.max()), "tol": MOE_LAYER_TOL, "ms": ms,
             "expert_flops": flops, "expert_bound_ms": flops / BF16_FLOPS_PER_S * 1e3}
    log("moe layer 0 (request 0): routing ids equal, grouped against all-experts: "
        + json.dumps(layer))
    run["result"]["moe_layer"] = layer
    return [row]


def moe_serve_phases(run: dict) -> dict:
    """One more prefill of the longest request (its ranges: routing, the
    experts' grouped products) and one more decode step of both slots."""
    import numpy as np

    bundle, params, batcher = run["bundle"], run["params"], run["batcher"]
    prompt = max(run["prompts"], key=len)
    token = np.ones((batcher.num_slots, 1), np.int32)
    pos = np.full((batcher.num_slots,), len(prompt), np.int32)
    return {
        "prefill (longest request)": lambda: bundle.prefill(
            params, {"tokens": prompt[None]}, cache_len=run["result"]["cache_len"]),
        "decode step (all slots)": lambda: bundle.decode_step(params, batcher.caches, token, pos),
    }


def moe_ep_check(label: str, ranks: list, ref: dict, cfg, log) -> dict:
    """(b)'s gates on each rank against the stacked run: loss and row CE
    (``loss_rows``, ``ce_rows``) and ``moe_aux`` bit for bit, ``moe_dropped``
    equal per layer; exactly 2 exchange rounds a MoE layer under the MoE's
    label and nothing under another; a round's bytes those of the design
    (dispatch: ``D · capacity`` token rows of d bf16 plus their int64 ids;
    combine: the rows back); the loss's collectives those of
    ``design_loss_collectives`` (none inside the MoE); the rank's experts
    those it owns, its parameter bytes ``shard_bytes_per_device``."""
    import numpy as np

    from repro_torch.launch import lm_run
    from repro_torch.models import moe

    mcfg = lm_run.model_config(cfg)
    world = len(ranks)
    seq = ref["seq"]
    cap = moe.ep_capacity(seq, mcfg)
    row_bytes = mcfg.d_model * 2
    want_bytes = mcfg.num_layers * (world * cap * (row_bytes + 8) + world * cap * row_bytes)
    owned = len(moe.owned_experts(0, world, mcfg.num_experts))
    m0 = ranks[0]["metrics"]
    for res in ranks:
        r, m = res["rank"], res["metrics"]
        for key in ("loss_rows", "ce_rows"):
            check(np.array_equal(m[key], ref["metrics"][key][r]),
                  f"{label}: rank {r}'s {key} {m[key]} differs from the stacked run's "
                  f"{ref['metrics'][key][r]}")
        check(np.array_equal(m["moe_aux"], ref["metrics"]["moe_aux"]),
              f"{label}: rank {r}'s moe_aux {m['moe_aux']} differs from the stacked run's "
              f"{ref['metrics']['moe_aux']}")
        check(np.array_equal(m["moe_dropped"], ref["metrics"]["moe_dropped"]),
              f"{label}: rank {r}'s drops {m['moe_dropped']} against the stacked "
              f"{ref['metrics']['moe_dropped']}")
        check(np.array_equal(m["loss"], m0["loss"]), f"{label}: rank {r}'s loss differs")
        check(res["rounds"] == {moe.LABEL: 2 * mcfg.num_layers},
              f"{label}: rank {r} made rounds {res['rounds']}, want 2 a MoE layer under "
              f"{moe.LABEL!r}")
        check(res["round_bytes"] == {moe.LABEL: want_bytes},
              f"{label}: rank {r} sent {res['round_bytes']} bytes, want {want_bytes}")
        want = lm_run.design_loss_collectives(mcfg, cfg.mesh, world, seq, cfg.moe_impl)
        check(res["collectives"] == want, f"{label}: rank {r} collectives "
              f"{res['collectives']}, the design {want}")
        check(res["expert_shapes"] == [(owned, mcfg.d_model, mcfg.d_ff)],
              f"{label}: rank {r} holds experts {res['expert_shapes']}, owns {owned}")
        check(res["param_bytes"] == res["shard_bytes"], f"{label}: rank {r} holds "
              f"{res['param_bytes']} parameter bytes, shard_bytes_per_device "
              f"{res['shard_bytes']}")
    routed = world * seq * mcfg.experts_per_token
    dropped = [int(x) for x in ref["metrics"]["moe_dropped"]]
    out = {"capacity": cap, "round_bytes": want_bytes // (2 * mcfg.num_layers),
           "dropped_per_layer": dropped, "routed_rows_per_layer": routed,
           "dropped_share": [x / routed for x in dropped],
           "experts_a_rank": owned, "loss": float(m0["loss"]),
           "moe_aux": float(m0["moe_aux"])}
    log(f"{label} gates held (every rank its stacked row bit for bit): " + json.dumps(out))
    return out


def moe_ep_rank(group, cfg, batch: int, seq: int, device_name: str) -> dict:
    """One rank of (b)'s gloo group: the forward loss with this script's
    matrix-product settings (``lm_settings``), as the stacked run had."""
    from repro_torch.launch import lm_run

    lm_settings()
    return lm_run.run_loss(cfg, batch, seq, device=device_name, timeout_s=MOE_EP_TIMEOUT_S)


def run_moe_ep(seed: int, device, log) -> dict:
    """(b): mixtral-8x22b at full width, MOE_EP_LAYERS layers, a forward
    loss over a global batch of MOE_EP_WORLD rows of MOE_EP_SEQ tokens with
    ``moe_impl="ep"`` on (data, model) = (MOE_EP_WORLD, 1): first stacked
    on this card (``StackedGroup``), then on four gloo ranks of this card
    (one row each), then dense on this card and on one NCCL rank (where the
    reference's ``moe`` takes dense), bit for bit."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import lm_run, mesh

    card = device.type == "cuda"
    cfg = moe_ep_config(seed)
    t0 = time.perf_counter()
    ref = lm_run.run_loss(cfg, MOE_EP_WORLD, MOE_EP_SEQ, sharded=False, stacked=MOE_EP_WORLD,
                          device=device)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    log(f"moe-ep stacked D={MOE_EP_WORLD}: {ref['s']:.3f} s, rounds {ref['rounds']}, "
        f"peak {ref['peak_bytes']}, {json.dumps({k: np.asarray(v).tolist() for k, v in ref['metrics'].items()})}")
    label = f"moe-ep-gloo-{MOE_EP_WORLD}"
    t1 = time.perf_counter()
    ranks = mesh.spawn(moe_ep_rank, MOE_EP_WORLD, "gloo", str(device),
                       args=(cfg, MOE_EP_WORLD, MOE_EP_SEQ, str(device)),
                       timeout_s=MOE_EP_TIMEOUT_S)
    gloo_s = time.perf_counter() - t1
    for res in ranks:
        log(f"{label} rank {res['rank']}: loss {float(res['metrics']['loss'])} "
            f"{res['s']:.3f} s, rounds {res['rounds']} bytes {res['round_bytes']}, "
            f"collectives {res['collectives']} bytes {res['collective_bytes']}, "
            f"experts {res['expert_shapes']}, parameter bytes {res['param_bytes']}, "
            f"peak {res['peak_bytes']}")
    gate = moe_ep_check(label, ranks, ref, cfg, log)
    one = dataclasses.replace(cfg, mesh=(1, 1))
    dense = lm_run.run_loss(one, MOE_EP_WORLD, MOE_EP_SEQ, sharded=False, device=device)
    gc.collect()
    backend = "nccl" if card else "gloo"
    store = tempfile.mkdtemp(prefix="moe_world1_")
    mesh.init_shard_group(backend, "file://" + os.path.join(store, "store"),
                          timeout_s=MOE_EP_TIMEOUT_S, rank=0, world_size=1, device=device)
    try:
        nccl = lm_run.run_loss(one, MOE_EP_WORLD, MOE_EP_SEQ, device=device,
                               timeout_s=MOE_EP_TIMEOUT_S)
    finally:
        dist.destroy_process_group()
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    for key in ("loss", "ce", "moe_aux"):
        check(np.array_equal(nccl["metrics"][key], dense["metrics"][key]),
              f"moe-ep {backend}-1: {key} {nccl['metrics'][key]} differs from the one-card "
              f"dense run's {dense['metrics'][key]}")
    check(nccl["rounds"] == {} and dense["rounds"] == {},
          f"moe-ep {backend}-1 took the exchange: {nccl['rounds']}")
    log(f"moe-ep {backend}-1: dense, bit for bit the one-card run: loss "
        f"{float(nccl['metrics']['loss'])} ({nccl['s']:.3f} s; one card {dense['s']:.3f} s)")
    del dense
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return {"path": "moe-ep", "layers": MOE_EP_LAYERS, "world": MOE_EP_WORLD, "seq": MOE_EP_SEQ,
            "stacked_s": ref["s"], "gloo4_s": gloo_s, "gate": gate,
            "ranks": [{k: res[k] for k in ("rank", "s", "rounds", "round_bytes", "collectives",
                                           "collective_bytes", "param_bytes", "peak_bytes")}
                      for res in ranks],
            "nccl1_loss": float(nccl["metrics"]["loss"]),
            "run_s": time.perf_counter() - t0}


def run_moe(seed: int, device, log, profile: bool = False) -> dict:
    """The ``moe`` phase: (a) mixtral-8x22b served at full width on the card
    (MOE_LAYERS layers, a 4,096-slot ring a layer, the MoE in every block)
    with its gates and kernel 6 at its windowed shape; (b) its forward loss
    with expert parallelism across processes (:func:`run_moe_ep`)."""
    import torch

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    t0 = time.perf_counter()
    cfg = moe_serve_config()
    run = run_lm_path(seed, device, log, cfg=cfg, requests=len(MOE_PROMPT_LENS),
                      slots=MOE_SLOTS, cache_len=MOE_CACHE_LEN, max_new=MOE_MAX_NEW,
                      path="moe-serve", lens=MOE_PROMPT_LENS, routes=True)
    serve_s = time.perf_counter() - t0
    result = {"serve": run["result"]}
    result["serve"]["rings"] = check_ring_kpos(run, log)
    result["serve"]["gates"] = check_moe_serve(run, device, log)
    rows = check_moe_kernels(run, device, log)
    profiled = None
    if profile:
        from repro_torch.models import moe

        profiled = profile_phases(moe_serve_phases(run), device,
                                  window=(moe.ROUTE_RANGE, moe.EXPERTS_RANGE))
        log("profile moe-serve: " + json.dumps({phase: {
            "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
            "by_class": v["by_class"], "top": [[k[:60], ms, n] for k, ms, n in v["top"][:8]],
            "windows": {w: {"device_ms": x["device_ms"], "launches": x["launches"],
                            "by_class": x["by_class"]} for w, x in v["windows"].items()},
        } for phase, v in profiled.items()}))
    a_s = time.perf_counter() - t0
    log(f"run moe (a) serve: {a_s:.1f} s ({serve_s:.1f} s serving; {smi})")
    del run
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    result["ep"] = run_moe_ep(seed, device, log)
    result.update(path="moe", a_s=a_s, profile=profiled, run_s=time.perf_counter() - t0)
    log(f"run moe: {result['run_s']:.1f} s ((a) {a_s:.1f} s, (b) {result['ep']['run_s']:.1f} s; "
        f"{smi})")
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# The last model families: Griffin, the encoder-decoder, the patch prefix
# ---------------------------------------------------------------------------
ARCHS_GRIFFIN = "recurrentgemma_9b"
# (a) recurrentgemma-9b at its published widths and depth (38 layers, 2
# periods of 19 blocks: 26 rglru, 12 local; 10.4e9 parameters, 20.9 GB in
# bf16), 4 requests through 2 slots of 8,192 (rings of 2,048): the second
# request's decode crosses the window edge, the last two wrap the ring in
# prefill.
ARCHS_GRIFFIN_LAYERS = 38
ARCHS_GRIFFIN_LENS = (1500, 2040, 3000, 6144)
ARCHS_GRIFFIN_SLOTS, ARCHS_GRIFFIN_CACHE_LEN, ARCHS_GRIFFIN_MAX_NEW = 2, 8192, 32
# Logits of the kernel-backed path against the teacher-forced pass and the
# plain path, |a - b| <= atol + rtol |b|: bf16 roundings in another order.
# Measured by the phase's gate lines (seed 0, on an H100 80GB HBM3 at
# 700 W): pixtral 0.0625 at most, inside the tests' bf16
# logit tolerance (MOE_LOGIT_TOL).  recurrentgemma: the RG-LRU carries each
# rounding of h forward over thousands of steps with a = 0.9-0.999, and h
# reaches |h| ~ 63 (a bf16 step of 0.25 where it is rounded for the
# output gate), so decode (one step at a time) and the scan differ by more:
# 0.121 (prefill against the plain path) and 0.148 (decode against the
# teacher-forced pass); the bound is twice that, the xLSTM's bf16 bound
# (XLSTM_LOGIT_TOL).  whisper: its tied embedding (std 1/sqrt(51865)) keeps
# the logits small (|logit| <= 0.42), so its atol is four times the
# largest difference measured (0.0039, two bf16 steps there).
ARCHS_LOGIT_TOL = {"recurrentgemma": {"atol": 0.3, "rtol": 2e-2},
                   "whisper": {"atol": 1.6e-2, "rtol": 2e-2},
                   "pixtral": {"atol": 6e-2, "rtol": 2e-2}}
ARCHS_WHISPER = "whisper_base"
# (b) whisper-base at full width and depth: 4 clips of 1,500 frames
# (whisper's 30 s window after its conv stride, stubbed as d_model-wide
# normal frames), prompts of 32 tokens, one batched prefill into caches of
# 448 (whisper's text context), then 128 greedy decode steps.
ARCHS_WHISPER_CLIPS, ARCHS_WHISPER_PROMPT = 4, 32
ARCHS_WHISPER_CACHE_LEN, ARCHS_WHISPER_STEPS = 448, 128
ARCHS_PIXTRAL = "pixtral_12b"
# (c) pixtral-12b at its published widths, 8 of its 40 layers (the patch
# prefix sits before layer 0, so depth adds only time): 256 patch
# embeddings + 1,000 tokens, then 16 decode steps.
ARCHS_PIXTRAL_LAYERS, ARCHS_PIXTRAL_PROMPT, ARCHS_PIXTRAL_STEPS = 8, 1000, 16
# (b) and (c) time this many prefills at the measured shape, after one
# warm-up at that shape, and report their median.
ARCHS_PREFILL_REPEATS = 3


def archs_configs() -> dict:
    """The phase's three models: (a) recurrentgemma-9b, (b) whisper-base,
    (c) pixtral-12b, each at its published widths (depth as above)."""
    from repro_torch.configs.base import get_config

    return {"recurrentgemma": dataclasses.replace(get_config(ARCHS_GRIFFIN),
                                                  num_layers=ARCHS_GRIFFIN_LAYERS),
            "whisper": get_config(ARCHS_WHISPER),
            "pixtral": dataclasses.replace(get_config(ARCHS_PIXTRAL),
                                           num_layers=ARCHS_PIXTRAL_LAYERS)}


def within(got, want, tol: dict):
    """``(ok, max |got - want|)`` under |a - b| <= atol + rtol |b|."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return ok, float(diff.max())


def clear_argmax_equal(tokens, ref, tol: dict) -> tuple:
    """Each token equal to ``ref``'s argmax wherever its top-1 beats its top-2
    by more than twice ``tol``'s atol: ``(all equal, positions compared)``."""
    import torch

    top2 = ref.float().topk(2, dim=-1).values
    sure = ((top2[..., 0] - top2[..., 1]) > 2 * tol["atol"]).cpu()
    tokens = torch.as_tensor(tokens).reshape(sure.shape)
    return bool((tokens[sure] == ref.argmax(-1).cpu()[sure]).all()), int(sure.sum())


def timed_prefills(fn, device, want: dict, label: str) -> tuple:
    """ARCHS_PREFILL_REPEATS calls of ``fn`` (a prefill, warmed up at the
    same shape before), each timed by ``wall`` with the kernel counts set to
    0 before it and held to ``want`` after it (on the card): the last call's
    result and every call's seconds."""
    from repro_torch.kernels import build

    out, walls = None, []
    for _ in range(ARCHS_PREFILL_REPEATS):
        del out
        build.LAUNCHES.clear()
        out, secs = wall(fn, device)
        walls.append(secs)
        if device.type == "cuda":
            check(dict(build.LAUNCHES) == want,
                  f"{label} prefill: launches {dict(build.LAUNCHES)}, want {want}")
    return out, walls


def attention_layer_count(cfg) -> int:
    return cfg.num_periods * sum(cfg.block_pattern.count(bt) for bt in ("attn", "swa", "local"))


def check_rglru_states(run: dict, log) -> dict:
    """Every RG-LRU state of the batcher's slots after the run finite."""
    import torch

    from repro_torch.models import rglru

    states = [(name, c) for name, c in run["batcher"].caches.items()
              if isinstance(c, rglru.RGLRUState)]
    for name, c in states:
        check(bool(torch.isfinite(c.h).all()) and bool(torch.isfinite(c.conv).all()),
              f"{run['result']['path']}: RG-LRU state {name} is not finite")
    out = {"blocks": len(states), "h_abs_max": max(float(c.h.abs().max()) for _, c in states)}
    log(f"{run['result']['path']} RG-LRU states finite: " + json.dumps(out))
    return out


def check_archs_serve(run: dict, device, log, tol: dict) -> dict:
    """The batcher's logits at every generated position against a
    teacher-forced pass of prompt + generated tokens through the
    kernel-backed ``forward_train`` (kernel 6 once an attention layer a
    request), and each request's prefill logits against the plain path's
    (masked-einsum attention with the window), within ``tol``; each token
    the pass's argmax where its top-1 beats its top-2 by twice the atol."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.api import build_model

    cfg, bundle, params = run["cfg"], run["bundle"], run["params"]
    path = run["result"]["path"]
    plain = build_model(dataclasses.replace(cfg, attention_impl="plain"), device=device)
    out = {"logit_tol": tol, "prefill_max_abs_err": 0.0, "decode_max_abs_err": 0.0,
           "max_abs_logit": 0.0, "tokens_compared": 0, "positions": 0}
    build.LAUNCHES.clear()
    for req in run["done"]:
        n = len(req.prompt)
        toks = np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])[None]
        logits, _ = bundle.forward_train(params, toks)
        ref = logits[0, n - 1:].float()
        got = torch.stack(run["logits"][req.uid]).float()
        check(got.shape == ref.shape and bool(torch.isfinite(ref).all()),
              f"{path} request {req.uid}: {tuple(got.shape)} against {tuple(ref.shape)}")
        ok, err = within(got, ref, tol)
        check(ok, f"{path} request {req.uid}: logits differ from the teacher-forced pass by up "
              f"to {err} (tolerance {tol})")
        out["decode_max_abs_err"] = max(out["decode_max_abs_err"], err)
        out["max_abs_logit"] = max(out["max_abs_logit"], float(ref.abs().max()))
        same, compared = clear_argmax_equal(req.out_tokens, ref, tol)
        check(same, f"{path} request {req.uid}: a generated token differs from the pass's "
              "clear argmax")
        plain_logits, _ = plain.prefill(params, {"tokens": req.prompt[None]}, cache_len=n)
        ok, err = within(got[0], plain_logits[0], tol)
        check(ok, f"{path} request {req.uid}: prefill logits differ from the plain path's by up "
              f"to {err} (tolerance {tol})")
        out["prefill_max_abs_err"] = max(out["prefill_max_abs_err"], err)
        out["tokens_compared"] += compared
        out["positions"] += ref.shape[0]
        del logits, plain_logits, ref, got
    out["launches"] = dict(build.LAUNCHES)
    want = attention_layer_count(cfg) * len(run["done"])
    if device.type == "cuda":
        check(out["launches"] == {"flash_attention": want},
              f"{path} teacher-forced passes: launches {out['launches']}, want {want} of kernel 6")
    log(f"{path} gates held (teacher-forced pass through kernel 6, plain path): "
        + json.dumps(out))
    return out


def check_griffin_kernel(run: dict, device, log) -> list:
    """Kernel 6 at head dim 256: the longest request's first ``local``
    layer (16 q heads over one kv head, window 2,048) against its twin,
    timed beside the twin and SDPA with the window as a boolean mask
    (``enable_gqa``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash

    cfg, params = run["cfg"], run["params"]
    window = cfg.local_window
    prompt = max(run["prompts"], key=len)
    q, k, v = block_qkv(params, prompt, cfg, device, cfg.block_pattern.index("local"))
    hq, s, d = q.shape
    args = dict(causal=True, window=window, q_heads_per_kv=cfg.q_per_kv)
    mask = flash.live_mask(s, s, causal=True, window=window, device=device)
    row = flash_row(run["result"]["path"], q, k, v, args,
                    run["result"]["launches"].get("flash_attention", 0),
                    f"q=({hq}, {s}, {d}) k/v=({k.shape[0]}, {s}, {d}) bf16 causal window={window} "
                    "(the longest request, the first local layer, strided views of the "
                    "projections)", device, log,
                    lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                           attn_mask=mask, enable_gqa=True)[0])
    del q, k, v, mask
    return [row]


def griffin_phases(run: dict) -> dict:
    """One more prefill of the longest request and one more decode step of
    both slots (``--profile``; the scan inside ``rglru.SCAN_RANGE``)."""
    import numpy as np

    bundle, params, batcher = run["bundle"], run["params"], run["batcher"]
    prompt = max(run["prompts"], key=len)
    token = np.ones((batcher.num_slots, 1), np.int32)
    pos = np.full((batcher.num_slots,), len(prompt), np.int32)
    return {
        "prefill (longest request)": lambda: bundle.prefill(
            params, {"tokens": prompt[None]}, cache_len=run["result"]["cache_len"]),
        "decode step (all slots)": lambda: bundle.decode_step(params, batcher.caches, token, pos),
    }


def run_archs_griffin(seed: int, device, log, cfg, profile: bool = False) -> dict:
    """(a): recurrentgemma-9b served through the continuous batcher, its
    gates and kernel 6 at head dim 256."""
    run = run_lm_path(seed, device, log, cfg=cfg, requests=len(ARCHS_GRIFFIN_LENS),
                      slots=ARCHS_GRIFFIN_SLOTS, cache_len=ARCHS_GRIFFIN_CACHE_LEN,
                      max_new=ARCHS_GRIFFIN_MAX_NEW, path="archs-recurrentgemma",
                      lens=ARCHS_GRIFFIN_LENS)
    result = run["result"]
    result["rings"] = check_ring_kpos(run, log)
    result["states"] = check_rglru_states(run, log)
    result["gates"] = check_archs_serve(run, device, log, ARCHS_LOGIT_TOL["recurrentgemma"])
    rows = check_griffin_kernel(run, device, log)
    if profile:
        from repro_torch.models import rglru

        prof = profile_phases(griffin_phases(run), device, window=(rglru.SCAN_RANGE,))
        result["profile"] = prof
        log("profile archs-recurrentgemma: " + json.dumps({phase: {
            "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
            "by_class": v["by_class"], "top": [[k[:60], ms, n] for k, ms, n in v["top"][:8]],
            "windows": {w: {"device_ms": x["device_ms"], "launches": x["launches"],
                            "by_class": x["by_class"]} for w, x in v["windows"].items()},
        } for phase, v in prof.items()}))
    return {"result": result, "rows": rows}


def run_archs_whisper(seed: int, device, log, cfg) -> dict:
    """(b): whisper-base, one batched prefill of ARCHS_WHISPER_CLIPS clips
    (frames normal from ``seed``) and prompts, then ARCHS_WHISPER_STEPS
    greedy decode steps through the bundle; the prefill's time the median of
    ``timed_prefills``.  Gates: kernel 6 once an encoder layer and once a
    decoder layer in each prefill; the decode logits against a
    teacher-forced ``forward_train`` of prompt + generated tokens, the
    prefill logits against the plain path's; kernel 6 at the encoder's
    layer-0 q, k, v (non-causal) against its twin, timed beside SDPA."""
    import statistics

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.models import attention, layers, transformer
    from repro_torch.models.api import build_model

    path, tol = "archs-whisper", ARCHS_LOGIT_TOL["whisper"]
    bundle = build_model(cfg, device=device)
    params, init_s = wall(lambda: bundle.init(seed), device)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    b, p = ARCHS_WHISPER_CLIPS, ARCHS_WHISPER_PROMPT
    frames = torch.randn((b, cfg.frontend_len, cfg.d_model), generator=gen, device=device)
    prompts = np.random.default_rng(seed + 5).integers(1, cfg.vocab_size, (b, p), np.int32)
    batch = {"tokens": prompts, "frames": frames}
    want = {"flash_attention": cfg.encoder_layers + cfg.num_layers}
    _, warm = bundle.prefill(params, batch, cache_len=ARCHS_WHISPER_CACHE_LEN)
    bundle.decode_step(params, warm, prompts[:, :1], np.full((b,), p, np.int32))
    del warm
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    (logits, caches), walls = timed_prefills(
        lambda: bundle.prefill(params, batch, cache_len=ARCHS_WHISPER_CACHE_LEN), device, want,
        path)
    prefill_s = statistics.median(walls)
    launches = dict(build.LAUNCHES)
    got, tokens, steps = [logits.float()], [logits.argmax(-1)], []
    for t in range(ARCHS_WHISPER_STEPS):
        pos = torch.full((b,), p + t, dtype=torch.int32, device=device)
        (logits, caches), secs = wall(lambda: bundle.decode_step(
            params, caches, tokens[-1][:, None].to(torch.int32), pos), device)
        steps.append(secs)
        got.append(logits.float())
        tokens.append(logits.argmax(-1))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if device.type == "cuda":
        check(launches == want and dict(build.LAUNCHES) == want,
              f"{path}: launches {dict(build.LAUNCHES)} (prefill {launches}), want {want}")
    got = torch.stack(got, 1)  # (B, 1 + steps, V)
    generated = torch.stack(tokens, 1).cpu().numpy().astype(np.int32)
    toks = np.concatenate([prompts, generated], axis=1)
    build.LAUNCHES.clear()
    ref, _ = bundle.forward_train(params, toks, frames)
    forced = dict(build.LAUNCHES)
    ref = ref[:, p - 1:].float()
    check(ref.shape == got.shape and bool(torch.isfinite(ref).all()),
          f"{path}: {tuple(got.shape)} against the teacher-forced {tuple(ref.shape)}")
    if device.type == "cuda":
        check(forced == want, f"{path} teacher-forced pass: launches {forced}, want {want}")
    ok, decode_err = within(got, ref, tol)
    check(ok, f"{path}: logits differ from the teacher-forced pass by up to {decode_err} "
          f"(tolerance {tol})")
    same, compared = clear_argmax_equal(generated, ref, tol)
    check(same, f"{path}: a generated token differs from the teacher-forced pass's clear argmax")
    plain = build_model(dataclasses.replace(cfg, attention_impl="plain"), device=device)
    plain_logits, _ = plain.prefill(params, batch, cache_len=ARCHS_WHISPER_CACHE_LEN)
    ok, prefill_err = within(got[:, 0], plain_logits, tol)
    check(ok, f"{path}: prefill logits differ from the plain path's by up to {prefill_err}")
    del ref, plain_logits
    result = {
        "path": path, "arch": cfg.name, "clips": b, "frames": cfg.frontend_len,
        "prompt_len": p, "cache_len": ARCHS_WHISPER_CACHE_LEN, "decode_steps": len(steps),
        "init_s": init_s, "prefill_s": prefill_s, "prefill_walls_s": walls, "ttft_s": prefill_s,
        "prefill_tokens_per_s": b * (p + cfg.frontend_len) / prefill_s,
        "decode_step_ms": 1e3 * sum(steps) / len(steps),
        "decode_tokens_per_s": b * len(steps) / sum(steps), "launches": launches,
        "peak_bytes": peak,
        "gates": {"logit_tol": tol, "decode_max_abs_err": decode_err,
                  "prefill_max_abs_err": prefill_err, "max_abs_logit": float(got.abs().max()),
                  "tokens_compared": compared,
                  "positions": int(got.shape[0] * got.shape[1]), "teacher_forced_launches": forced},
    }
    log(f"serve {cfg.name}: " + json.dumps(result))
    with torch.no_grad():
        dt = transformer.compute_dtype(cfg)
        x = frames.to(dt) + layers.sinusoidal_positions(cfg.frontend_len, cfg.d_model,
                                                        device=device).to(dt)
        enc0 = params.enc_layers[0]
        q, k, v = attention._project_qkv(enc0.attn, layers.rmsnorm(x, enc0.norm1), cfg, None)
    q = q.reshape(b, cfg.num_heads, cfg.frontend_len, cfg.head_dim_)
    args = dict(causal=False, q_heads_per_kv=cfg.q_per_kv)
    row = flash_row(path, q, k, v, args, launches.get("flash_attention", 0),
                    f"q=({b}, {cfg.num_heads}, {cfg.frontend_len}, {cfg.head_dim_}) bf16 "
                    "non-causal (the encoder's layer 0, strided views of the projections)",
                    device, log,
                    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=False))
    return {"result": result, "rows": [row]}


def run_archs_pixtral(seed: int, device, log, cfg) -> dict:
    """(c): pixtral-12b, one request of ``frontend_len`` patch embeddings
    (normal from ``seed``) and ARCHS_PIXTRAL_PROMPT tokens through the
    bundle's prefill with ``patch_emb``, then ARCHS_PIXTRAL_STEPS decode
    steps; the prefill's time the median of ``timed_prefills``.  Gates:
    kernel 6 once a layer in each prefill; the logits against a
    teacher-forced ``forward_train`` with the same prefix, the prefill
    logits against the plain path's."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.api import build_model

    path, tol = "archs-pixtral", ARCHS_LOGIT_TOL["pixtral"]
    bundle = build_model(cfg, device=device)
    params, init_s = wall(lambda: bundle.init(seed), device)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    patch = torch.randn((1, cfg.frontend_len, cfg.d_model), generator=gen, device=device)
    prompt = np.random.default_rng(seed + 6).integers(1, cfg.vocab_size,
                                                       (1, ARCHS_PIXTRAL_PROMPT), np.int32)
    pl = cfg.frontend_len
    cache_len = pl + ARCHS_PIXTRAL_PROMPT + ARCHS_PIXTRAL_STEPS
    batch = {"tokens": prompt, "patch_emb": patch}
    want = {"flash_attention": attention_layer_count(cfg)}
    _, warm = bundle.prefill(params, batch, cache_len=cache_len)
    bundle.decode_step(params, warm, prompt[:, :1],
                       np.array([pl + ARCHS_PIXTRAL_PROMPT], np.int32))
    del warm
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    (logits, caches), walls = timed_prefills(
        lambda: bundle.prefill(params, batch, cache_len=cache_len), device, want, path)
    prefill_s = statistics.median(walls)
    launches = dict(build.LAUNCHES)
    got, tokens, steps = [logits[0].float()], [int(logits[0].argmax())], []
    for t in range(ARCHS_PIXTRAL_STEPS):
        pos = np.array([pl + ARCHS_PIXTRAL_PROMPT + t], np.int32)
        (logits, caches), secs = wall(lambda: bundle.decode_step(
            params, caches, np.array([[tokens[-1]]], np.int32), pos), device)
        steps.append(secs)
        got.append(logits[0].float())
        tokens.append(int(logits[0].argmax()))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if device.type == "cuda":
        check(launches == want and dict(build.LAUNCHES) == want,
              f"{path}: launches {dict(build.LAUNCHES)} (prefill {launches}), want {want}")
    got = torch.stack(got)
    toks = np.concatenate([prompt[0], np.asarray(tokens, np.int32)])[None]
    build.LAUNCHES.clear()
    ref, _ = bundle.forward_train(params, toks, patch_emb=patch)
    forced = dict(build.LAUNCHES)
    ref = ref[0, ARCHS_PIXTRAL_PROMPT - 1:].float()
    check(ref.shape == got.shape and bool(torch.isfinite(ref).all()),
          f"{path}: {tuple(got.shape)} against the teacher-forced {tuple(ref.shape)}")
    if device.type == "cuda":
        check(forced == want, f"{path} teacher-forced pass: launches {forced}, want {want}")
    ok, err = within(got, ref, tol)
    check(ok, f"{path}: logits differ from the teacher-forced pass by up to {err} "
          f"(tolerance {tol})")
    same, compared = clear_argmax_equal(tokens, ref, tol)
    check(same, f"{path}: a generated token differs from the teacher-forced pass's clear argmax")
    del ref
    plain = build_model(dataclasses.replace(cfg, attention_impl="plain"), device=device)
    plain_logits, _ = plain.prefill(params, batch, cache_len=cache_len)
    ok, prefill_err = within(got[0], plain_logits[0], tol)
    check(ok, f"{path}: prefill logits differ from the plain path's by up to {prefill_err}")
    del plain_logits
    result = {
        "path": path, "arch": cfg.name, "layers": cfg.num_layers, "patches": pl,
        "prompt_len": ARCHS_PIXTRAL_PROMPT, "decode_steps": len(steps), "init_s": init_s,
        "prefill_s": prefill_s, "prefill_walls_s": walls, "ttft_s": prefill_s,
        "prefill_tokens_per_s": (pl + ARCHS_PIXTRAL_PROMPT) / prefill_s,
        "decode_step_ms": 1e3 * sum(steps) / len(steps), "launches": launches,
        "peak_bytes": peak,
        "gates": {"logit_tol": tol, "max_abs_err": err, "prefill_max_abs_err": prefill_err,
                  "max_abs_logit": float(got.abs().max()),
                  "tokens_compared": compared,
                  "positions": int(got.shape[0]), "teacher_forced_launches": forced},
    }
    log(f"serve {cfg.name}: " + json.dumps(result))
    return {"result": result, "rows": []}


def run_archs(seed: int, device, log, profile: bool = False) -> dict:
    """The ``archs`` phase: (a) recurrentgemma-9b, (b) whisper-base, (c)
    pixtral-12b served on the card, each freed before the next; each part's
    seconds beside the card's name and power limit."""
    import torch

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    t0 = time.perf_counter()
    cfgs = archs_configs()
    parts, rows = {}, []
    for name, runner in (
        ("recurrentgemma", lambda c: run_archs_griffin(seed, device, log, c, profile)),
        ("whisper", lambda c: run_archs_whisper(seed, device, log, c)),
        ("pixtral", lambda c: run_archs_pixtral(seed, device, log, c)),
    ):
        t1 = time.perf_counter()
        out = runner(cfgs[name])
        out["result"]["run_s"] = time.perf_counter() - t1
        log(f"run archs ({name}): {out['result']['run_s']:.1f} s, peak "
            f"{out['result']['peak_bytes']} bytes ({smi})")
        parts[name] = out["result"]
        rows += out["rows"]
        del out
        gc.collect()
        if card:
            torch.cuda.empty_cache()
    result = {"path": "archs", "parts": parts, "run_s": time.perf_counter() - t0}
    log(f"run archs: {result['run_s']:.1f} s ((a) {parts['recurrentgemma']['run_s']:.1f} s, "
        f"(b) {parts['whisper']['run_s']:.1f} s, (c) {parts['pixtral']['run_s']:.1f} s; {smi})")
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# Griffin and the encoder-decoder over a mesh (the archs-procs phase)
# ---------------------------------------------------------------------------
ARCHS_PROCS_WORLD = 4
ARCHS_PROCS_TIMEOUT_S = 600.0
# (a) recurrentgemma-9b at its published widths, 6 of its 38 layers: two
# periods of (rglru, rglru, local), the model's 2:1 mix (its published
# period of 19 blocks cannot be cut to 6), 1.31e9 parameters in the blocks;
# (a)'s traffic: archs (a)'s four prompts through 2 slots of 8,192, 8 new
# tokens each.
ARCHS_PROCS_GRIFFIN = {"num_layers": 6, "block_pattern": ("rglru", "rglru", "local")}
ARCHS_PROCS_GRIFFIN_MAX_NEW = 8
# (b) whisper-base at full width and depth: archs (b)'s 4 clips, 32-token
# prompts and caches of 448, then 16 decode steps.
ARCHS_PROCS_WHISPER_STEPS = 16
# The sharded runs' logits against the unsharded run's (absolute), read
# from the first run on the card (NVIDIA H100 80GB HBM3, 700 W, seed 0) and
# set at about twice its maximum.  (a) recurrentgemma, bf16: the split
# w_out and MLP sums round in another order and the RG-LRU carries each
# rounding over thousands of steps: the sharded run's logits moved by at
# most 0.109 over 32 positions, and the unsharded model's own prefill
# logits move by 0.055-0.075 when one norm weight of its first layer
# changes by 1e-7 relative (lm_procs_sensitivity, reported every run).
# (b) whisper, bf16: its tied embedding keeps |logit| under 0.42, where a
# bf16 step is 2^-9 to 2^-10; the first run moved by at most 0.0040.
ARCHS_PROCS_LOGIT_TOL = {"a": 0.22, "b": 8e-3}


def archs_procs_configs(seed: int) -> dict:
    """The phase's runs: (a) recurrentgemma-9b (ARCHS_PROCS_GRIFFIN's cut)
    and (b) whisper-base on (data, model) = (1, 4); (c) (a) on one NCCL
    rank."""
    from repro_torch.launch.lm_run import LMRunConfig

    a = LMRunConfig(arch=ARCHS_GRIFFIN, mesh=(1, ARCHS_PROCS_WORLD),
                    requests=len(ARCHS_GRIFFIN_LENS), slots=ARCHS_GRIFFIN_SLOTS,
                    cache_len=ARCHS_GRIFFIN_CACHE_LEN, lens=ARCHS_GRIFFIN_LENS,
                    max_new=(ARCHS_PROCS_GRIFFIN_MAX_NEW,), seed=seed, **ARCHS_PROCS_GRIFFIN)
    b = LMRunConfig(arch=ARCHS_WHISPER, mesh=(1, ARCHS_PROCS_WORLD),
                    requests=ARCHS_WHISPER_CLIPS, slots=ARCHS_WHISPER_CLIPS,
                    cache_len=ARCHS_WHISPER_CACHE_LEN,
                    lens=(ARCHS_WHISPER_PROMPT,) * ARCHS_WHISPER_CLIPS,
                    max_new=(ARCHS_PROCS_WHISPER_STEPS + 1,), seed=seed)
    return {"a": a, "b": b, "c": dataclasses.replace(a, mesh=(1, 1))}


def captured_flash_row(q, k, v, kw: dict, launches: int, device, label: str, what: str,
                       log) -> dict:
    """Kernel 6 on a rank's own captured call against its twin, timed beside
    SDPA (``enable_gqa``; a window or a non-causal call as a boolean mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash

    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    args = dict(causal=kw.get("causal", True), window=kw.get("window"),
                q_heads_per_kv=kw.get("q_heads_per_kv", hq // hkv))
    if args["window"] is None and args["causal"]:
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
    else:
        mask = flash.live_mask(s, skv, causal=args["causal"], window=args["window"],
                               device=device)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,  # noqa: E731
                                                      enable_gqa=True)
    shapes = (f"q=({b}, {hq}, {s}, {d}) k/v=({b}, {hkv}, {skv}, {d}) {q.dtype} "
              f"{'causal' if args['causal'] else 'non-causal'}"
              f"{'' if args['window'] is None else ' window=' + str(args['window'])} ({what})")
    return flash_row(label, q, k, v, args, launches, shapes, device, log, sdpa,
                     shards=ARCHS_PROCS_WORLD)


def archs_procs_rank(group, cfgs: dict, forced: dict, device_name: str,
                     profile: bool = False) -> dict:
    """One rank of the spawned group: runs (a) and (b) in turn, each
    teacher-forced with the unsharded run's tokens; rank 0 keeps the
    logits and captures kernel 6's inputs (the longest Griffin request's
    first ``local`` layer; whisper's encoder and decoder prefills); with
    ``profile`` rank 0 runs each under ``torch.profiler`` (its card's busy
    share of the run's wall)."""
    import torch

    from repro_torch.launch import lm_run

    device = torch.device(device_name)
    lm_settings()
    out = {"rank": group.rank, "runs": {}, "flash": {}}
    for key, cfg in cfgs.items():
        lengths = ()
        if group.rank == 0:
            lengths = (max(cfg.lens),) if key == "a" else (lm_run.model_config(cfg).frontend_len,
                                                           cfg.lens[0])
        def run():
            return lm_run.run_lm(cfg, device=device, forced=forced[key],
                                 keep_logits=group.rank == 0, timeout_s=ARCHS_PROCS_TIMEOUT_S)

        got = {}
        with KernelCapture(lengths) as capture:
            if profile and group.rank == 0:
                prof = profile_phases({"run": lambda: got.setdefault("res", run())},
                                      device)["run"]
                res = got["res"]
                res["profile"] = {"wall_ms": prof["wall_ms"],
                                  "device_busy_ms": prof["device_busy_ms"],
                                  "device_busy_share": prof["device_busy_ms"] / prof["wall_ms"],
                                  "by_class": prof["by_class"]}
            else:
                res = run()
        out["runs"][key] = res
        out["flash"][key] = capture.calls
        del capture, res
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if group.rank == 0:
        label = f"archs-procs-gloo-{ARCHS_PROCS_WORLD}"
        rows = []
        for key, what in (("a", "rank 0's 4 q heads over the kv head, the longest request's "
                                "first local layer"),
                          ("b", "rank 0's 2 heads, the encoder's layer 0"),
                          ("b", "rank 0's 2 heads, the decoder's layer-0 prefill")):
            calls = out["flash"][key]
            length = sorted(calls)[-1] if "encoder" in what or key == "a" else sorted(calls)[0]
            rows.append(captured_flash_row(*calls[length], out["runs"][key]["launches"].get(
                "flash_attention", 0), device, f"{label} ({key})", what, print))
        out["rows"] = rows
    out.pop("flash")
    return out


def run_archs_procs(seed: int, device, log, profile: bool = False) -> dict:
    """The ``archs-procs`` phase: Griffin and the encoder-decoder over a mesh
    (``archs_procs_configs``).  (a) and (b) go first unsharded on this card
    (their logits to host memory, their models freed; (a)'s sensitivity to a
    1e-7 change of one norm weight reported), then in one spawn of four gloo
    ranks on this card, teacher-forced with the unsharded tokens; (c) on one
    NCCL rank in this process, bit for bit."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import lm_run, mesh

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    t_phase = time.perf_counter()
    cfgs = archs_procs_configs(seed)

    def unsharded(key):
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = lm_run.run_lm(cfgs[key], sharded=False, device=device, keep_model=key != "b")
        if key == "a":
            ref["sensitivity"] = lm_procs_sensitivity(ref)
        for name in ("bundle", "params", "prompts"):
            ref.pop(name, None)
        log(f"archs-procs ({key}) unsharded {ref['arch']} ({ref['layers']} layers): "
            f"{time.perf_counter() - t0:.1f} s; its sensitivity {ref.get('sensitivity')}")
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        return ref

    refs = {key: unsharded(key) for key in "ab"}
    label = f"archs-procs-gloo-{ARCHS_PROCS_WORLD}"
    t0 = time.perf_counter()
    ranks = mesh.spawn(archs_procs_rank, ARCHS_PROCS_WORLD, "gloo", str(device),
                       args=({k: cfgs[k] for k in "ab"}, {k: refs[k]["tokens"] for k in "ab"},
                             str(device), profile),
                       timeout_s=ARCHS_PROCS_TIMEOUT_S)
    result = {"path": "archs-procs", "gloo4_s": time.perf_counter() - t0, "runs": {}}
    log(f"{label}: {result['gloo4_s']:.1f} s from spawn to the last result")
    for key in "ab":
        runs = [r["runs"][key] for r in ranks]
        result["runs"][key] = lm_procs_report(f"{label} ({key})", cfgs[key], runs, refs[key],
                                              smi, log)
        result["runs"][key]["gate"] = lm_procs_check(f"{label} ({key})", cfgs[key], runs,
                                                     refs[key], ARCHS_PROCS_LOGIT_TOL[key],
                                                     card, log)
        if "profile" in runs[0]:
            result["runs"][key]["profile"] = runs[0]["profile"]
            log(f"{label} ({key}) rank 0 under the profiler ({smi}): "
                + json.dumps(runs[0]["profile"]))
    rows = ranks[0]["rows"]
    check(len(rows) == 3, f"{label}: rank 0 checked {len(rows)} kernel 6 shapes, want 3")
    del ranks
    backend = "nccl" if card else "gloo"
    store = tempfile.mkdtemp(prefix="archs_procs_world1_")
    mesh.init_shard_group(backend, "file://" + os.path.join(store, "store"),
                          timeout_s=ARCHS_PROCS_TIMEOUT_S, rank=0, world_size=1, device=device)
    try:
        one = lm_run.run_lm(cfgs["c"], device=device, forced=refs["a"]["tokens"],
                            timeout_s=ARCHS_PROCS_TIMEOUT_S)
    finally:
        dist.destroy_process_group()
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    label1 = f"archs-procs-{backend}-1 (c)"
    result["runs"]["c"] = lm_procs_report(label1, cfgs["c"], [one], refs["a"], smi, log)
    result["runs"]["c"]["gate"] = lm_procs_check(label1, cfgs["c"], [one], refs["a"], None,
                                                 card, log)
    del one, refs
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    result["run_s"] = time.perf_counter() - t_phase
    log(f"run archs-procs: {result['run_s']:.1f} s (two unsharded runs, four gloo ranks on one "
        f"card, one {backend} rank, gates and rank 0's kernel checks; {smi})")
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# expert-parallel training through the exchange (the moe-train phase)
# ---------------------------------------------------------------------------
MOE_TRAIN_WORLD = 4
MOE_TRAIN_TIMEOUT_S = 600.0
# mixtral-8x22b at its published widths, 1 of its 56 layers: f32 masters,
# their gradients and AdamW's moments take 16 bytes a parameter, and one
# layer holds 2.42e9 expert parameters beside 0.49e9 of attention, embedding
# and head.  A global batch of 4 x 1,024 tokens (one row a rank), 2 steps.
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 1, 1024, 2
# The clip does not bind (its norm is summed over the ranks in gloo's
# order, so a binding clip would move every update by its last bit): each
# rank's owned experts after step 1 are then the stacked step's, bit for bit.
MOE_TRAIN_CLIP = 1e9
# The reduced leaves' first moments after step 1 against the stacked step's,
# as a share of each leaf's largest entry (f32 gradients summed over the
# ranks in another order; tests/test_torch_moe_train_procs.py holds 1e-6 at
# smoke size).
MOE_TRAIN_REDUCED_TOL = 1e-5


def moe_train_config(seed: int):
    from repro_torch.launch.train_run import TrainRunConfig

    return TrainRunConfig(arch=MOE_ARCH, kind="gspmd", num_layers=MOE_TRAIN_LAYERS,
                          mesh=(MOE_TRAIN_WORLD, 1), batch=MOE_TRAIN_WORLD, seq=MOE_TRAIN_SEQ,
                          steps=MOE_TRAIN_STEPS, lr=1e-4, warmup_steps=1, total_steps=10,
                          clip_norm=MOE_TRAIN_CLIP, seed=seed)


def moe_train_batches(cfg) -> list:
    """The phase's global batches (token ids uniform in [1, vocab) from the
    seed, the same on every rank)."""
    import numpy as np

    from repro_torch.launch import train_run

    rng = np.random.default_rng(cfg.seed + 9)
    vocab = train_run.model_config(cfg).vocab_size
    return [rng.integers(1, vocab, (cfg.batch, cfg.seq + 1), dtype=np.int32)
            for _ in range(cfg.steps)]


def stacked_moments_hook(path: str, digests: dict):
    """An ``on_step`` hook of the stacked run: after step 1 the digests of
    every expert's first moments and parameters (``digests``: (leaf, expert)
    -> (moments, parameters)), and every other leaf's first moments written
    whole to ``path``."""
    import torch

    from repro_torch.launch import train_run

    def hook(i, params, opt, bundle):
        if i != 0:
            return None
        rest = {}
        for name, p in params.named_parameters():
            m = opt["m"][name]
            if ".moe.w_" in name:
                for e in range(p.shape[0]):
                    digests[(name, e)] = (train_run._digest(m[e]), train_run._digest(p[e]))
            else:
                rest[name] = m.detach().cpu()
        torch.save(rest, path)
        return None

    return hook


def rank_moments_hook(path: str, digests: dict):
    """An ``on_step`` hook of a rank: after step 1 its owned experts'
    moments and parameters against the stacked step's digests (bit for
    bit), its other blocks' moments against the stacked step's at ``path``
    (the largest |difference| over the leaf's largest entry)."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import train_run
    from repro_torch.models import moe

    def hook(i, params, opt, bundle):
        if i != 0:
            return None
        lay = bundle.layout
        whole = torch.load(path, mmap=True)
        owned = moe.owned_experts(lay.dp.index, lay.dp.size, bundle.cfg.num_experts)
        experts, worst = {}, {}
        for name, p in params.named_parameters():
            m = opt["m"][name]
            if ".moe.w_" in name:
                for j, e in enumerate(owned):
                    got = (train_run._digest(m[j]), train_run._digest(p[j]))
                    experts[f"{name}[{e}]"] = got == digests[(name, e)]
                continue
            want = whole[name][sharding.block_slices(lay.full_shapes[name], lay.specs[name],
                                                     lay.parallel.mesh, lay.coord)].to(m.device)
            scale = max(float(want.abs().max()), 1e-30)
            worst[name] = float((m - want).abs().max()) / scale
        return {"experts": experts, "reduced": worst}

    return hook


class ExchangeClock:
    """Host seconds and calls inside the exchange's rounds over a process
    group (``ProcessGroup._exchange_bytes``: the one ``all_to_all_single``
    of a round, its staging through host memory under gloo included),
    forward and backward, on every thread, while the block runs."""

    def __enter__(self):
        from repro_torch.core import exchange

        self.seconds, self.calls = 0.0, 0
        self._cls = exchange.ProcessGroup
        self._orig = self._cls._exchange_bytes
        orig = self._orig

        def timed(group, send):
            t0 = time.perf_counter()
            try:
                return orig(group, send)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        self._cls._exchange_bytes = timed
        return self

    def __exit__(self, *exc):
        self._cls._exchange_bytes = self._orig
        return False


def moe_train_rank(group, cfg, batches, path: str, digests: dict, device_name: str,
                   profile: bool = False) -> dict:
    """One rank of the spawned group: the EP train step's 2 steps, held
    after step 1 against the stacked step (``rank_moments_hook``); rank 0
    captures kernel 6's inputs in the first forward and holds them against
    the twin after the run; with ``profile`` every rank takes one more
    step, which rank 0 profiles (``train_procs_profile``)."""
    import torch

    from repro_torch.launch import train_run

    device = torch.device(device_name)
    lm_settings()
    with KernelCapture((cfg.seq,) if group.rank == 0 else ()) as capture, \
            CollectiveClock() as clock, ExchangeClock() as rounds:
        res = train_run.run_train(cfg, device=device, batches=batches,
                                  on_step=rank_moments_hook(path, digests),
                                  extra_step=train_procs_profile(group.rank, device)
                                  if profile else None, timeout_s=MOE_TRAIN_TIMEOUT_S)
    res["host_s"] = {"exchange": rounds.seconds, "exchange_rounds": rounds.calls,
                     **clock.seconds}
    res["rows"] = []
    if group.rank == 0:
        q, k, v, kw = capture.calls[cfg.seq]
        res["rows"].append(captured_flash_row(
            q, k, v, kw, res["launches"].get("flash_attention", 0), device,
            f"moe-train-gloo-{MOE_TRAIN_WORLD}", "rank 0's row, the EP train step's forward",
            print))
    return res


def run_moe_train(seed: int, device, log, profile: bool = False) -> dict:
    """The ``moe-train`` phase: mixtral-8x22b (MOE_TRAIN_LAYERS layer) trained
    with ``moe_impl="ep"`` on (data, model) = (4, 1).  First the stacked EP
    step on this card (``make_ep_stacked_train_step``), its step-1 moments
    kept (digests of every expert's, the rest on the host), freed; then four
    gloo ranks of this card (one row each), each held after step 1 against
    it; then the one-card dense step on this card and the same on one NCCL
    rank, bit for bit."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh, train_run

    card = device.type == "cuda"
    smi = card_line() if card else "cpu"
    t_phase = time.perf_counter()
    cfg = moe_train_config(seed)
    mcfg = train_run.model_config(cfg)
    batches = moe_train_batches(cfg)
    scratch = tempfile.mkdtemp(prefix="moe_train_")
    path = os.path.join(scratch, "moments.pt")
    digests: dict = {}
    try:
        t0 = time.perf_counter()
        ref = train_run.run_train(cfg, sharded=False, stacked=MOE_TRAIN_WORLD, device=device,
                                  batches=batches, on_step=stacked_moments_hook(path, digests))
        ref_s = time.perf_counter() - t0
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        log(f"moe-train stacked D={MOE_TRAIN_WORLD}: {ref_s:.1f} s, steps "
            f"{[round(s['s'], 3) for s in ref['steps']]} s, rounds "
            f"{[s['rounds'] for s in ref['steps']]}, peak {ref['peak_bytes']} ({smi}): "
            + json.dumps([s["metrics"] for s in ref["steps"]]))
        label = f"moe-train-gloo-{MOE_TRAIN_WORLD}"
        t0 = time.perf_counter()
        ranks = mesh.spawn(moe_train_rank, MOE_TRAIN_WORLD, "gloo", str(device),
                           args=(cfg, batches, path, digests, str(device), profile),
                           timeout_s=MOE_TRAIN_TIMEOUT_S)
        gloo_s = time.perf_counter() - t0
    finally:
        for name in os.listdir(scratch):
            os.remove(os.path.join(scratch, name))
        os.rmdir(scratch)
    rounds = train_run.design_rounds(mcfg, cfg.mesh, 1)
    want = train_run.design_collectives(mcfg, cfg.mesh, "gspmd", cfg.seq, cfg.batch, 1)
    gate = {"reduced_tol": MOE_TRAIN_REDUCED_TOL, "reduced_max": 0.0, "experts_bit_for_bit": 0}
    tokens = cfg.batch * cfg.seq // MOE_TRAIN_WORLD
    for res in ranks:
        r = res["rank"]
        held = res["steps"][0]["check"]
        check(all(held["experts"].values()) and held["experts"],
              f"{label}: rank {r}'s owned experts after step 1 differ from the stacked step's: "
              f"{held['experts']}")
        gate["experts_bit_for_bit"] += len(held["experts"])
        worst = max(held["reduced"].values())
        check(worst <= MOE_TRAIN_REDUCED_TOL, f"{label}: rank {r}'s reduced leaves differ from "
              f"the stacked step's by {worst} of their largest entry: {held['reduced']}")
        gate["reduced_max"] = max(gate["reduced_max"], worst)
        for got, ref_step in zip(res["steps"], ref["steps"]):
            for key in ("loss", "ce", "moe_aux"):
                a, b = got["metrics"][key], ref_step["metrics"][key]
                check(abs(a - b) <= 1e-5 * abs(b) and math.isfinite(a),
                      f"{label}: rank {r} step {got['step']} {key} {a} against the stacked {b}")
            check(got["rounds"] == rounds, f"{label}: rank {r} step {got['step']} rounds "
                  f"{got['rounds']}, the design {rounds}")
            check(got["collectives"] == want, f"{label}: rank {r} step {got['step']} "
                  f"collectives {got['collectives']}, the design {want}")
        check(res["param_bytes"] == res["expected_param_bytes"]
              and res["state_bytes"] == res["expected_state_bytes"],
              f"{label}: rank {r} holds {res['param_bytes']} / {res['state_bytes']} parameter / "
              f"state bytes, the specs say {res['expected_param_bytes']} / "
              f"{res['expected_state_bytes']}")
        if card:
            want_k6 = {"flash_attention": 2 * MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS}
            check(res["launches"] == want_k6, f"{label}: rank {r} launches {res['launches']}, "
                  f"want {want_k6} (each forward and its recomputation)")
        steps_s = [s["s"] for s in res["steps"]]
        log(f"{label} rank {r} ({smi}): " + json.dumps({
            "step_ms": [1e3 * s for s in steps_s],
            "tokens_per_s": [tokens / s for s in steps_s],
            "metrics": [s["metrics"] for s in res["steps"]],
            "rounds": res["steps"][0]["rounds"], "collectives": res["steps"][0]["collectives"],
            "bytes": res["steps"][0]["bytes"], "host_s_in_calls": res["host_s"],
            "param_bytes": res["param_bytes"], "state_bytes": res["state_bytes"],
            "peak_bytes": res["peak_bytes"], "init_s": res["init_s"]}))
    routed = cfg.batch * cfg.seq * mcfg.experts_per_token * MOE_TRAIN_LAYERS
    gate["dropped_share"] = [s["metrics"].get("moe_dropped", 0.0) / routed for s in ref["steps"]]
    log(f"{label} gates held: " + json.dumps(gate))
    if ranks[0].get("extra"):
        log(f"{label} rank 0's extra step under the profiler ({smi}): "
            + json.dumps(ranks[0]["extra"]))
    rows = ranks[0]["rows"]
    result = {"path": "moe-train", "layers": MOE_TRAIN_LAYERS, "world": MOE_TRAIN_WORLD,
              "seq": cfg.seq, "stacked_s": ref_s, "gloo4_s": gloo_s, "gate": gate,
              "stacked_peak_bytes": ref["peak_bytes"],
              "ranks": [{"rank": res["rank"], "steps_s": [s["s"] for s in res["steps"]],
                         "host_s": res["host_s"], "peak_bytes": res["peak_bytes"],
                         "param_bytes": res["param_bytes"], "state_bytes": res["state_bytes"]}
                        for res in ranks]}
    del ranks, ref
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    # Dense on one card and on one NCCL rank, bit for bit.
    one = dataclasses.replace(cfg, mesh=(1, 1))
    dense = train_run.run_train(one, sharded=False, device=device, batches=batches)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    backend = "nccl" if card else "gloo"
    store = tempfile.mkdtemp(prefix="moe_train_world1_")
    mesh.init_shard_group(backend, "file://" + os.path.join(store, "store"),
                          timeout_s=MOE_TRAIN_TIMEOUT_S, rank=0, world_size=1, device=device)
    try:
        nccl = train_run.run_train(one, device=device, batches=batches,
                                   timeout_s=MOE_TRAIN_TIMEOUT_S)
    finally:
        dist.destroy_process_group()
        for name in os.listdir(store):
            os.remove(os.path.join(store, name))
        os.rmdir(store)
    for a, b in zip(nccl["steps"], dense["steps"]):
        check(a["metrics"] == b["metrics"] and a["digests"] == b["digests"] and not a["rounds"],
              f"moe-train {backend}-1 step {a['step']}: {a['metrics']} against the one-card "
              f"dense step's {b['metrics']} (rounds {a['rounds']})")
    log(f"moe-train {backend}-1: dense, bit for bit the one-card step: "
        + json.dumps([s["metrics"] for s in nccl["steps"]]) + f"; peak {nccl['peak_bytes']}")
    result["nccl1_metrics"] = [s["metrics"] for s in nccl["steps"]]
    del dense, nccl
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    result["run_s"] = time.perf_counter() - t_phase
    log(f"run moe-train: {result['run_s']:.1f} s (the stacked step, four gloo ranks, the dense "
        f"step on one card and on one {backend} rank, gates and rank 0's kernel check; {smi})")
    return {"result": result, "rows": rows}


# ---------------------------------------------------------------------------
# The tooling: the launch resolver's autotuner on the card and the dry run
# ---------------------------------------------------------------------------

TOOLING_SIZES = (1 << 20, 1 << 24)
TOOLING_WIDTHS = (1, 2, 4)
TOOLING_REPEATS = 5
# The dry run's cells; one microbatch a train step keeps the trace inside
# the phase (the CLI's default is the reference's 8).
TOOLING_DRYRUN = {"archs": ("qwen3_4b", "mixtral_8x22b"), "cells": ("train_4k", "decode_32k"),
                  "microbatches": 1}
TOOLING_DRYRUN_TIMEOUT_S = 300.0
# The entries of kernels 1-5 the phase relaunches, by the resolver's key.
TOOLING_KERNELS = {"murmur_bucket": "murmur", "bin_histogram": "bin_histogram",
                   "csr_gather_owners": "csr_gather_batched",
                   "csr_gather_queriers": "csr_gather_batched",
                   "csr_gather": "csr_gather", "csr_gather_batched": "csr_gather_batched",
                   "bucket_probe_layer": "bucket_probe", "bucket_probe": "bucket_probe"}


def sweep_work(kernel: str, n: int, width: int) -> tuple[int, int]:
    """``(bytes, int32 ops)`` of one launch of the autotuner's driver for
    ``kernel`` at size ``n`` and ``width`` (``kernels/autotune.py``'s
    shapes), counted as the phases' rows count them: murmur reads the keys
    and writes each output once (the 2-lane entry both outputs); the
    histogram reads the ids and writes 256 counters; the probe's windows
    of 8 keys (``probe_work``: starts, ends, q and a count a slot, the
    window's words); the gathers' runs of 8 rows, every slot valid
    (``gather_work``: offsets, the starts, the picked C words, C values
    and a row id a slot)."""
    if kernel == "murmur":
        return ((4 * width + 8) * n, (2 * (9 * width + 11) + 1) * n) if width > 1 else \
            (8 * n, 22 * n)
    if kernel == "bin_histogram":
        return 4 * n + 4 * 256, 3 * n
    if kernel == "bucket_probe":
        words = 8 * n
        return (12 + 4 * width) * n + 4 * width * words, 3 * words + 6 * n
    sources = 1 if kernel == "csr_gather" else 4
    rows = max(1, n // (8 * sources))
    slots = rows * 8 * sources
    nbytes = 4 * (sources * (rows + 1) + width * slots) + 4 * sources * rows + \
        4 * (1 + width) * slots
    return nbytes, 12 * slots + (1 + width) * slots


def moved(inputs, device):
    """``inputs`` (kernel -> argument dict, tensors in lists too) with every
    tensor on ``device``."""
    import torch

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v

    return {k: {n: move(v) for n, v in a.items()} for k, a in inputs.items()}


def tooling_launches(inputs: dict) -> dict:
    """Name -> a function of ``block_rows`` that launches that entry of
    kernels 1-5 once on its captured inputs."""
    from repro_torch.kernels import bucket_probe, csr_gather, histogram, murmur

    fns = {}
    if "murmur_bucket" in inputs:
        a = inputs["murmur_bucket"]
        fns["murmur_bucket"] = lambda br, a=a: murmur.murmur_bucket(
            a["keys"], a["table_size"], a["seed"], block_rows=br)
    if "bin_histogram" in inputs:
        a = inputs["bin_histogram"]
        fns["bin_histogram"] = lambda br, a=a: histogram.bin_histogram(
            a["bins"], a["num_bins"], block_rows=br)
    if "csr_gather_owners" in inputs:
        o, q = inputs["csr_gather_owners"], inputs["csr_gather_queriers"]
        fns["csr_gather_owners"] = lambda br: csr_gather.csr_gather_owners(
            o["starts"], o["counts"], o["tables"], o["capacity"], block_rows=br)
        fns["csr_gather_queriers"] = lambda br: csr_gather.csr_gather_queriers(
            q["starts"], q["counts"], q["table"], q["capacity"], block_rows=br)
    for name, fn in (("csr_gather", csr_gather.csr_gather_2d),
                     ("csr_gather_batched", csr_gather.csr_gather_batched_2d)):
        if name in inputs:
            a = inputs[name]
            fns[name] = lambda br, fn=fn, a=a: fn(a["offsets"], a["starts"], a["table"],
                                                  a["capacity"], block_rows=br)
    if "bucket_probe_layer" in inputs:
        p = inputs["bucket_probe_layer"]
        args = tuple(p[k] for k in ("rq", "rh", "lo", "match_e", "offsets", "keys"))
        kw = {k: p[k] for k in ("table_size", "stride", "epoch", "max_probe", "accumulate")}

        def layer(br):
            import torch

            total = torch.empty(p["rq"].shape[:2], dtype=torch.int32, device=p["rq"].device)
            return bucket_probe.bucket_probe_layer(*args, total=total, block_rows=br, **kw)
        fns["bucket_probe_layer"] = layer
    if "bucket_probe" in inputs:
        a = inputs["bucket_probe"]
        fns["bucket_probe"] = lambda br, a=a: bucket_probe.bucket_probe(
            a["starts"], a["ends"], a["q"], a["table"], a["max_probe"], block_rows=br)
    return fns


def start_dryrun(out_dir: str, log) -> list:
    """One ``repro_torch.launch.dryrun`` process an arch of
    ``TOOLING_DRYRUN`` (the single-pod mesh, on the CPU: it sees no card),
    started together; returns ``(arch, Popen, log path)``."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch in TOOLING_DRYRUN["archs"]:
        path = os.path.join(out_dir, f"{arch}.log")
        with open(path, "w") as out:
            procs.append((arch, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--cell", ",".join(TOOLING_DRYRUN["cells"]), "--mesh", "single",
                 "--microbatches", str(TOOLING_DRYRUN["microbatches"]), "--out", out_dir],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT), path))
    log(f"tooling: dry run of {TOOLING_DRYRUN['archs']} x {TOOLING_DRYRUN['cells']} on the "
        f"(16, 16) mesh started ({len(procs)} processes, fake group of 256)")
    return procs


def finish_dryrun(procs: list, out_dir: str, log) -> list:
    """Wait for the dry-run processes (stopping them at the time limit), gate
    each cell ``ok`` with finite positive terms, and print their roofline
    rows (H100 constants)."""
    from repro_torch.analysis import roofline

    t0 = time.perf_counter()
    for arch, proc, path in procs:
        try:
            left = TOOLING_DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            code = proc.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            code = "timeout"
        with open(path) as f:
            tail = f.read()[-2000:]
        check(code == 0, f"tooling: the dry run of {arch} exited {code}:\n{tail}")
    records = []
    for arch in TOOLING_DRYRUN["archs"]:
        for cell in TOOLING_DRYRUN["cells"]:
            with open(os.path.join(out_dir, f"{arch}.{cell}.single.json")) as f:
                rec = json.load(f)
            check(rec["status"] == "ok", f"tooling: dry run {arch} {cell}: {rec.get('error')}")
            terms = rec["terms_s"]
            check(all(math.isfinite(v) and v > 0 for v in terms.values()),
                  f"tooling: dry run {arch} {cell} terms {terms}")
            check(rec["memory_analysis"]["temp_size_in_bytes"] > 0,
                  f"tooling: dry run {arch} {cell} tracked no temporary bytes")
            records.append(rec)
            log(f"tooling: dry run {arch} {cell}: trace {rec['trace_s']} s, "
                f"flops/rank {rec['flops_per_rank']:.4e}, bytes/rank {rec['bytes_per_rank']:.4e}, "
                f"wire/rank {rec['wire_bytes_per_rank']:.4e}, collectives "
                f"{json.dumps(rec['collective_op_counts'])}, microbatches {rec['microbatches']}, "
                f"memory {json.dumps(rec['memory_analysis'])}")
    rows = [roofline.derive(r) for r in records]
    log("tooling: roofline (H100 SXM5: 989e12 FLOP/s bf16, 3.35e12 B/s, 50e9 B/s a link; "
        "seconds a step a rank):\n" + roofline.markdown_table(rows))
    return records


def run_tooling(seed: int, device, log, captured: dict) -> dict:
    """The ``tooling`` phase: the autotuner's sweep on the card at
    ``TOOLING_SIZES`` x ``TOOLING_WIDTHS`` (each candidate's ms logged), its
    cache saved and loaded back, then kernels 1-5 relaunched on ``captured``
    (host copies of the read D = 1 run's inputs of kernels 1-4 and the
    update D = 1 run's of kernel 5) through the resolver: each entry once
    with the counts set to 0 just before (the phase's main path), every
    candidate's output equal to the default geometry's bit for bit, and
    ``check_kernels``' rows (path ``"autotune"``: the tuned launch against
    its twin, timed, beside the bound) with the default launch's ms; the
    dry run meanwhile in two CPU processes (``start_dryrun``)."""
    import shutil

    import torch

    from repro_torch.kernels import autotune, build, common

    t0 = time.perf_counter()
    smi = card_line() if device.type == "cuda" else "cpu"
    out_dir = os.path.join(REPO, "build", f"tooling_{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = start_dryrun(out_dir, log)
    try:
        autotune.clear_cache()
        t_sweep = time.perf_counter()
        records = autotune.autotune(sizes=TOOLING_SIZES, widths=TOOLING_WIDTHS,
                                    repeats=TOOLING_REPEATS, device=device)
        sweep_s = time.perf_counter() - t_sweep
        for rec in records:
            kernel = rec["key"].split("|")[0]
            check(rec["block_rows"] in common.CANDIDATES[kernel]
                  and set(rec["timings_ms"]) == {str(c) for c in common.CANDIDATES[kernel]},
                  f"tooling: sweep record {rec}")
            bounds = int_bounds(sweep_work(kernel, rec["n"], rec["width"]))
            rec["bound_ms"], rec["bound_by"] = max(bounds.values()), max(bounds, key=bounds.get)
            log(f"tooling: autotune {rec['key']} n={rec['n']} width={rec['width']}: winner "
                f"block_rows={rec['block_rows']} (default {common.DEFAULT_BLOCK_ROWS[kernel]}) "
                f"ms by candidate {json.dumps(rec['timings_ms'])}, bound {rec['bound_ms']} ms "
                f"({rec['bound_by']}) ({smi})")
        path = autotune.save_cache(os.path.join(out_dir, "autotune_cache.json"))
        before = dict(autotune._cache)
        autotune.clear_cache()
        check(autotune.load_cache(path) == len(before) and autotune._cache == before,
              "tooling: the autotune cache did not round-trip through its file")
        inputs = moved(captured, device)
        fns = tooling_launches(inputs)
        check(set(fns) == set(TOOLING_KERNELS), f"tooling: captured {sorted(fns)}")
        resolved = {name: {"default": common.DEFAULT_BLOCK_ROWS[TOOLING_KERNELS[name]]}
                    for name in fns}
        build.LAUNCHES.clear()
        for fn in fns.values():  # the phase's main path: each entry once, tuned
            fn(None)
        sync(device)
        launches = dict(build.LAUNCHES)
        for name in fns:  # (the CPU's twins launch nothing)
            check(device.type != "cuda" or launches.get(name, 0) > 0,
                  f"tooling: {name} launched no time: {launches}")
        for name, fn in fns.items():
            key = TOOLING_KERNELS[name]
            want = fn(common.DEFAULT_BLOCK_ROWS[key])
            want = tuple(t for t in (want if isinstance(want, tuple) else (want,)) if t is not None)
            for br in common.CANDIDATES[key]:
                got = fn(br)
                got = tuple(t for t in (got if isinstance(got, tuple) else (got,)) if t is not None)
                check(len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"tooling: {name} at block_rows={br} differs from the default launch")
            resolved[name]["default_ms"] = mean_ms(
                lambda fn=fn, br=common.DEFAULT_BLOCK_ROWS[key]: fn(br), 10, device)
        from repro_torch.kernels import csr_gather as kgather

        # the resolver's (n, width) of each entry, as its wrapper asks
        sizes = {"murmur_bucket": lambda a: (a["keys"].numel(), 1),
                 "bin_histogram": lambda a: (a["bins"].numel(), 1),
                 "csr_gather_owners": lambda a: (a["capacity"], kgather._cols(a["tables"][0], 1)),
                 "csr_gather_queriers": lambda a: (a["capacity"], kgather._cols(a["table"], 1)),
                 "csr_gather": lambda a: (a["capacity"], kgather._cols(a["table"], 0)),
                 "csr_gather_batched": lambda a: (a["capacity"], kgather._cols(a["table"], 0)),
                 "bucket_probe_layer": lambda a: (a["rq"].shape[0] * a["rq"].shape[1], 1),
                 "bucket_probe": lambda a: (a["q"].numel(), 1)}
        for name in fns:
            n, width = sizes[name](inputs[name])
            resolved[name]["tuned"] = common.resolve_block_rows(TOOLING_KERNELS[name], n=n,
                                                                width=width)
        rows = check_kernels({"inputs": lambda: inputs, "result": {
            "path": "autotune", "shards": 1, "launches": launches}}, device, log)
        for row in rows:
            r = resolved[row["name"]]
            row.update(block_rows=r["tuned"], default_block_rows=r["default"],
                       default_ms=r["default_ms"])
            log(f"tooling: {row['name']} tuned block_rows={r['tuned']} {row['ms']} ms, default "
                f"block_rows={r['default']} {r['default_ms']} ms, bound {row['bound_ms']} ms "
                f"({row['bound_by']}), launches {row['launches']} ({smi})")
        del inputs, fns
        gc.collect()
        torch.cuda.empty_cache()
        dry = finish_dryrun(procs, out_dir, log)
    finally:
        autotune.clear_cache()
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    result = {"path": "tooling", "sweep_s": sweep_s, "sweep": records, "resolved": resolved,
              "dryrun": dry, "run_s": time.perf_counter() - t0}
    log(f"run tooling: {result['run_s']:.1f} s (the sweep {sweep_s:.1f} s, the relaunches and "
        f"their checks, the dry run; {smi})")
    return {"rows": rows, "result": result}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--keys", type=int, default=1 << 27,
                        help="N of the D = 1 run; the D = 8 run takes N / 8")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="also write the results as JSON here")
    parser.add_argument("--procs-keys", type=int, default=PROCS_KEYS,
                        help="N of the procs phase (its D = 4 and D = 1 runs)")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one more build, query and retrieve of the D = 1 read "
                        "run, one more depth-6 probe query and compact of the D = 1 update run, "
                        "one get and one put of each kind of the D = 1 KV-cache run, "
                        "and one more prefill and decode step of each LM serving run "
                        "(the moe phase's split by its routing and expert ranges, the archs "
                        "phase's by the RG-LRU scan's range) "
                        "and one more train step")
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)", file=sys.stderr)
        return 2
    # cuBLAS reads its workspace setting once; the train phase's crash and
    # resume runs under torch.use_deterministic_algorithms, which needs it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    lm_settings()
    smi = card_line()
    print(smi, flush=True)

    def log(msg):
        print(msg, flush=True)

    t0 = time.perf_counter()
    build.library()
    log(f"kernels built from {build.CSRC} in {time.perf_counter() - t0:.1f} s")
    log("kernel bucket_probe build: " + json.dumps(ptxas_report(
        "bucket_probe.cu", r"\d(probe_(?:layer|windows)_kernel)ILi(\d+)E(?:Lb(\d)E)?([ix])E")))
    log("kernel csr_gather build: " + json.dumps(
        ptxas_report("csr_gather.cu", r"\d(gather_tiles)ILi(\d+)ELi(\d)E")))
    log("kernel murmur_hash build: " + json.dumps(
        ptxas_report("murmur.cu", r"\d(murmur_hash_kernel)ILi(\d)ELb(\d)ELb(\d)E")))
    run_path(1, 1 << 14, args.seed, device, lambda m: None)  # warm-up at a small size
    run_update_path(8, 1 << 17, args.seed, device, lambda m: None, skew=False)

    rows, paths, profiled = [], [], {}
    tooling_inputs = {}  # host copies of the D = 1 runs' inputs of kernels 1-5 (the tooling phase)
    wide_read = functools.partial(run_path, wide=True)
    wide_update = functools.partial(run_update_path, wide=True)
    for runner, shards, n_keys, phases in (
        (run_path, 1, args.keys, read_path_phases),
        (run_path, 8, args.keys // 8, None),
        (run_update_path, 1, args.keys, update_path_phases),
        (run_update_path, 8, args.keys // 8, None),
        (wide_read, 1, args.keys, None),
        (wide_read, 8, args.keys // 8, None),
        (wide_update, 1, args.keys, None),
        (wide_update, 8, args.keys // 8, None),
    ):
        t_run = time.perf_counter()
        run = runner(shards, n_keys, args.seed, device, log)
        rows += check_kernels(run, device, log)
        run["result"]["run_s"] = time.perf_counter() - t_run
        log(f"run {run['result']['path']} D={shards}: {run['result']['run_s']:.1f} s "
            "(the run, its oracles and its kernel checks)")
        if shards == 1 and runner in (run_path, run_update_path):
            wanted = READ_PATH_KERNELS + PALLAS_GATHERS if runner is run_path else \
                ("bucket_probe_layer", "bucket_probe")
            tooling_inputs.update(moved({k: v for k, v in run["inputs"]().items()
                                         if k in wanted}, torch.device("cpu")))
        if args.profile and phases is not None:
            key = f"{run['result']['path']} D={shards}"
            profiled[key] = profile_phases(phases(run), device)
            log(f"profile {key}: " + json.dumps({phase: {
                "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
                "top": [[k[:60], ms, n] for k, ms, n in v["top"][:6]],
            } for phase, v in profiled[key].items()}))
        paths.append(run["result"])
        del run  # free each run's tables before the next one builds
        gc.collect()  # run["inputs"] closes over run: a cycle that del alone leaves
    for shards, n_keys in ((1, args.keys), (8, args.keys // 8)):
        t_run = time.perf_counter()
        run = run_serve_table(shards, n_keys, args.seed, device, log)
        rows += check_serve_kernels(run, device, log)
        run["result"]["run_s"] = time.perf_counter() - t_run
        log(f"run serve-table D={shards}: {run['result']['run_s']:.1f} s (warm-up, traffic, "
            f"oracles and kernel checks; {smi})")
        paths.append(run["result"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
    # The table's users: the single-card API, hot keys, the KV cache, dedup.
    for name, runner, phases in (
        ("hashgraph-1", lambda: run_hashgraph_single(args.keys, args.seed, device, log), None),
        ("hot-keys", lambda: run_hot_keys(args.seed, device, log), None),
        ("kv-cache D=1", lambda: run_kv_cache(1, args.keys // 2, args.seed, device, log),
         kv_phases),
        ("kv-cache D=8", lambda: run_kv_cache(8, args.keys // 8, args.seed, device, log), None),
        ("dedup", lambda: run_dedup(args.seed, device, log), None),
    ):
        t_run = time.perf_counter()
        run = runner()
        rows += check_kernels(run, device, log)
        run["result"]["run_s"] = time.perf_counter() - t_run
        if args.profile and phases is not None:
            profiled[name] = profile_phases(phases(run), device)
            log(f"profile {name}: " + json.dumps({phase: {
                "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
                "by_class": v["by_class"], "top": [[k[:60], ms, n] for k, ms, n in v["top"][:8]],
            } for phase, v in profiled[name].items()}))
        log(f"run {name}: {run['result']['run_s']:.1f} s, peak {run['result']['peak_bytes']} "
            f"bytes (the phase, its oracles and its kernel checks; {smi})")
        paths.append(run["result"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
    # The table across processes: gloo-4 on this card and NCCL at world 1.
    t_run = time.perf_counter()
    procs = run_procs(args.seed, device, log, n_keys=args.procs_keys)
    rows += procs["rows"]
    procs["result"]["run_s"] = time.perf_counter() - t_run
    log(f"run procs: {procs['result']['run_s']:.1f} s (stacked runs, four ranks, one NCCL "
        f"rank, oracles and rank 0's kernel checks; {smi})")
    paths.append(procs["result"])
    del procs
    gc.collect()
    torch.cuda.empty_cache()
    t_run = time.perf_counter()
    lm = run_lm_path(args.seed, device, log)
    lm["result"]["replay"] = check_lm_replay(lm, device, log)
    rows += check_lm_kernels(lm, device, log)
    log(f"run serve: {time.perf_counter() - t_run:.1f} s")
    if args.profile:
        profiled["serve"] = profile_phases(lm_path_phases(lm), device)
        log("profile serve: " + json.dumps({phase: {
            "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
            "by_class": v["by_class"], "top": [[k[:60], ms, n] for k, ms, n in v["top"][:8]],
        } for phase, v in profiled["serve"].items()}))
    paths.append(lm["result"])
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    t_run = time.perf_counter()
    xl = run_lm_path(args.seed, device, log, cfg=get_config(XLSTM_ARCH), path="serve-xlstm")
    xl["result"]["replay"] = check_lm_replay(xl, device, log, tol=None)
    xl["result"]["continuation"] = check_lm_continuation(xl, device, log,
                                                         XLSTM_LOGIT_TOL["bfloat16"])
    rows += check_slstm_kernel(xl, device, log)
    log(f"run serve-xlstm: {time.perf_counter() - t_run:.1f} s")
    if args.profile:
        profiled["serve-xlstm"] = profile_phases(lm_path_phases(xl), device)
        log("profile serve-xlstm: " + json.dumps({phase: {
            "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
            "by_class": v["by_class"], "top": [[k[:60], ms, n] for k, ms, n in v["top"][:8]],
        } for phase, v in profiled["serve-xlstm"].items()}))
    paths.append(xl["result"])
    del xl
    gc.collect()
    torch.cuda.empty_cache()
    # The state carry again in f32 at full width, where rounding cannot hide a fault.
    t_run = time.perf_counter()
    xf = run_lm_path(args.seed, device, log, requests=2, slots=2, max_new=8,
                     cfg=dataclasses.replace(get_config(XLSTM_ARCH), dtype="float32"),
                     path="serve-xlstm-f32")
    xf["result"]["continuation"] = check_lm_continuation(xf, device, log,
                                                         XLSTM_LOGIT_TOL["float32"])
    log(f"run serve-xlstm-f32: {time.perf_counter() - t_run:.1f} s")
    paths.append(xf["result"])
    del xf
    gc.collect()
    torch.cuda.empty_cache()  # the card is free for the ranks of the last phase
    # Training on one card: qwen3-4b at full width, then the gradient checks
    # of the kernel-backed autograd Functions and a crash and resume.
    t_run = time.perf_counter()
    tr = run_train(args.seed, device, log)
    rows += tr["rows"]
    if args.profile:
        from repro_torch.kernels.flash_attention import BACKWARD_RANGE
        from repro_torch.train.step import OPTIMIZER_RANGE

        profiled["train"] = profile_phases(train_phases(tr), device,
                                           window=(BACKWARD_RANGE, OPTIMIZER_RANGE))
        log("profile train: " + json.dumps({phase: {
            "wall_ms": v["wall_ms"], "device_busy_ms": v["device_busy_ms"],
            "by_class": v["by_class"], "top": [[k[:60], ms, n] for k, ms, n in v["top"][:8]],
            "windows": {w: {"device_ms": x["device_ms"], "launches": x["launches"],
                            "by_class": x["by_class"]} for w, x in v["windows"].items()},
        } for phase, v in profiled["train"].items()}))
    train_res = tr["result"]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    train_res["grads"] = check_train_grads(args.seed, device, log)
    train_res["resume"] = check_train_resume(args.seed, device, log)
    train_res["run_s"] = time.perf_counter() - t_run
    log(f"run train: {train_res['run_s']:.1f} s (the 4 steps, their gates, the gradient checks "
        f"and the crash and resume; {smi})")
    paths.append(train_res)
    gc.collect()
    torch.cuda.empty_cache()
    # Training over a mesh: four gloo ranks on this card and one NCCL rank.
    tp = run_train_procs(args.seed, device, log, profile=args.profile)
    rows += tp["rows"]
    paths.append(tp["result"])
    del tp
    gc.collect()
    torch.cuda.empty_cache()
    lm = run_lm_procs(args.seed, device, log)
    rows += lm["rows"]
    paths.append(lm["result"])
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    # MoE and the ring cache: mixtral-8x22b served on the card, then expert
    # parallelism through the exchange across processes.
    moe_run = run_moe(args.seed, device, log, profile=args.profile)
    rows += moe_run["rows"]
    paths.append(moe_run["result"])
    del moe_run
    gc.collect()
    torch.cuda.empty_cache()
    # The last model families: Griffin, the encoder-decoder, the patch prefix.
    archs = run_archs(args.seed, device, log, profile=args.profile)
    rows += archs["rows"]
    paths.append(archs["result"])
    del archs
    gc.collect()
    torch.cuda.empty_cache()
    # The last model paths over a mesh: Griffin and whisper over tp ranks,
    # then expert-parallel training through the exchange's backward.
    for runner in (run_archs_procs, run_moe_train):
        out = runner(args.seed, device, log, profile=args.profile)
        rows += out["rows"]
        paths.append(out["result"])
        del out
        gc.collect()
        torch.cuda.empty_cache()
    # The tooling: the autotuner on the card, the tuned relaunches, the dry run.
    tooling = run_tooling(args.seed, device, log, tooling_inputs)
    del tooling_inputs
    rows += tooling["rows"]
    paths.append(tooling["result"])
    kernels = {"kernels": [{k: row[k] for k in (
        "name", "path", "shards", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for row in rows]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "paths": paths,
                       "profile": profiled or None, "kernels": rows}, f, indent=1)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps(kernels), flush=True)
    # The script drives cuda:0 alone, so it reports one card.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
