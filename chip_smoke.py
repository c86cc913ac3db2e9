"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--vocab-scale 1.0] [--batches 8] [--train-steps 8]

Phases (any failure exits non-zero, with no result line):

1. the card: ``nvidia-smi`` name and power limit; exits when CUDA is absent.
2. build: every CUDA source of the port's paths (victim threshold,
   gather-decode, FM interaction, embedding bag, bucketize, flash
   attention's bf16 tensor-core, fp32 3xTF32 tensor-core and fp32 SIMT
   kernels), from this checkout, in one ``build_all`` call (one ``nvcc``
   per source, all started together); prints the two tensor-core kernels'
   ptxas registers and spills for each instantiation, and fails on a
   spill, or on a serialised wgmma pipeline in the 3xTF32 kernel.
3. kernels, each held against its plain PyTorch version on the card: the
   victim threshold (one launch: a radix select over a cooperative grid)
   bitwise on >= 20 seeded tie-heavy trials with the
   planner's sentinel keys, at the DLRM path's shape (capacity 506 438, kv
   425 984) and at FM's (capacity = kv = 2 097 152); the tiered-arena
   gather-decode bitwise on 24 seeded fp16 / int8 cases (D 8, 16, 36, 128;
   slots at -1, H-1, H, H+T-1, H+T and far out of range) and at the paper
   shape (H 126 610, T 379 828, D 128, K 65 536), and its fused host
   encode (``gather_decode_encode``, fp16 / int8 tails into fp16 / int8
   hosts) payload and sideband bitwise on 24 cases (constant rows, D 5
   and 37 on the scalar path, the paper shape) and on 6 rows with
   signed-zero extremes (zp by value there; torch's own amin / amax sign
   bits printed: they depend on its reduction order); the FM interaction on 24
   cases (``test_kernels.py``'s shapes, B 4097, FM's (65536, 40, 10); fp32
   and bf16; contiguous and the strided ``[..., :D]`` view of [B, F, D+1])
   within the reference's rtol 1e-3 / atol 1e-5 * (max|ref| + 1) (bf16 rtol
   + 2^-7: one output rounding); the embedding bag on 26 cases
   (``test_kernels.py``'s sweep, bags longer than ``max_bag``, empty bags,
   -1 lanes, D 37, path (b)'s shape; sum and mean; fp32 and bf16) within
   fp32 1e-5 / bf16 3e-2, and each case again through the many-feature call
   (its lanes, their first half, a copy with -1 and S lanes added and an
   empty feature, in one launch) bitwise the per-feature plain version; the
   bucketize bitwise on 28 cases (S 1, 2, 4, 8;
   U 0, 1, 3, 4097, 425 984; owners out of [0, S); every lane padding;
   every lane replicated), and the route + image entry
   (``route_bucketize``: owner, local and image, and ``route_image``, the
   image alone as the sharded plan calls it) on 88 cases (rep_k 0 and
   2048, uniq aligned and one lane off, padding and past-the-table ranks,
   every lane padding, every lane replicated).
4. serve: the paper's DLRM (``configs/dlrm_criteo.CONFIG``: 26 fields, dim
   128, MLPs 512-256-128 / 1024-1024-512-256-1, batch 16384) with
   ``use_pallas_plan=True``: a 33 762 577-row fp32 host table pinned in host
   memory, a 506 438-row arena on the card, cache warm-up, then
   ``ServeEngine.score`` on ``--batches`` Zipf batches.  Checks finite
   scores, no unique-buffer overflow, one threshold launch per plan, and the
   cache invariant: logits from cached rows equal logits from rows read
   straight out of the host table.  Then one more plan's eviction key is
   captured and the kernel held against its plain version on it.  The host
   table is unpinned and freed before the next phase.
5. train: the same DLRM with ``arena_precision="int8"`` (126 610 fp32 head
   slots, 379 828 int8 tail slots): init + warm-up, then ``--train-steps``
   ``DLRM.train_step`` calls on batches of 16384 with writeback on; then
   two bag steps (path (b): each field's 16384 ids regrouped into 4096 bags
   of 1-4 lanes; ``prepare`` with writeback, ``pool`` through the
   embedding-bag kernel with ``max_bag=4``, sum then mean, autograd of
   sum_f <pooled_f, g_f>, ``apply_grads``); then ``DLRM.flush``.  Checks
   finite losses, no overflow, one threshold launch per plan, one bag
   launch per bag step (all 26 features of the slab), the pooled output bitwise the per-feature plain version of the
   live call, the bag kernel route = the plain route (gather + segment
   sum) in pooled output and gradient within 1e-5, one
   gather-decode launch per writeback round the plans implied plus one per
   flush round, the kernel bitwise = plain on one live writeback, and,
   after the flush, that every resident slot of the torch-decoded arena
   equals its host row bitwise.  Then a synced stage breakdown and a
   profiled step.
5b. sharded: the same DLRM split over 4 shards on the card
   (``model_shards=4``, ``replicate_top_k=2048``, fp32 exchange and arena,
   full-width plans: 4 x 425 984 slots, one 17.3 GB table pinned whole):
   ``ServeEngine`` on ``DIST_SERVE`` (3; ``--batches`` before phase 19,
   whose ranks take these batches) batches, then a warm-up and
   ``--train-steps`` ``train_step`` calls, each run with the launch counts
   at 0 before it and read after it (one bucketize launch, the route +
   image entry, and 4 threshold launches per plan).  Checks finite scores
   and losses, no overflow, cached logits = ``dense_reference`` logits
   (rtol 1e-5 / atol 1e-6), ``route_bucketize`` and ``bucketize`` bitwise
   = plain on the first plan's live router inputs, one profiled plan's
   device ops through ``route_bucketize`` and with the composition it
   replaced patched in (>= 15 fewer a routed image), and after
   ``flush`` every resident slot of every shard and every replicated row
   equal to its host row bitwise.  Prints per-step routed lanes per shard,
   exchange id / row bytes, ``shard_imbalance``, a synced stage breakdown
   and a profiled step.  Then, at vocab scale 0.02, 4 steps sharded and 4
      unsharded from one seed: losses within rtol 1e-5; and 6 sharded steps
   by the serial ``Trainer`` and by the ``PipelinedTrainer`` at depth 2
   (both under torch's deterministic algorithms): losses bitwise equal, two bucketize launches a plan with a window, the
   kernel bitwise = plain on a captured window image.
5c. budget mode: the same DLRM with ``device_budget_bytes=1 << 30``,
   ``host_precision="int8"`` and ``arena_precision="int8"``: the planner
   makes 21 tables DEVICE (569 296 rows on the card) and caches f2, f3,
   f11, f15 and f20 (33 193 281 rows) each in its own arena at ratio 0.015
   with an int8 tail, their int8 host tier (136 B a row, 0.266x fp32)
   drawn in device chunks, encoded on the card and pinned.  Warm-up,
   ``ServeEngine`` on ``--batches`` batches, ``--train-steps`` train steps,
   one bag step over the mixed plan (one embedding-bag launch per slab, 26
   in all) and ``flush``, each with the launch counts at 0 before it and
   read after it.  Checks the plan, ``device_total`` within the budget, 5
   threshold launches a plan, every write-back's gather-decode launch the
   fused ``gather_decode_encode`` into the int8 host (the first live one
   bitwise its plain version), wire bytes = (loaded + written-back lanes,
   counted off the plans) x 136 B from the exact counters, cached logits =
   logits from ``full_lookup`` rows (rtol 1e-5 / atol 1e-6), the pooled
   output bitwise the per-slab plain version, and after the flush every
   resident row's host payload and sideband bitwise the port's int8 encode
   of its arena row.  Prints serve and train p50 / p99, the wire bytes a
   step, the launches a plan and a profiled step's idle share.
5d. pipelined training: the DLRM with an fp32 host tier and arena trained
   ``PIPE_STEPS`` (4) steps by the serial ``Trainer`` (its step split into
   plan / apply / compute under spans: bitwise ``train_step``), then by
   the ``PipelinedTrainer`` at depths 1 and 3, each run from ``init(0)``
   under torch's deterministic algorithms (the card's ``index_add_`` sums
   duplicate lanes with atomics in no fixed order), the counts at 0 before
   each run and read after it, then 4 more steps of the same schedule in
   the default mode for its times.  Every run of 5d and 5f starts from one
   ``init(0)`` and its host copy (``InitSnapshot``: the 17.3 GB pinned
   table and every other leaf copied back in place; ``MemAvailable``
   printed).  Checks losses and AUCs bitwise equal across the checked
   runs, ``future_unresident`` 0, one threshold launch a plan (4 / 4 / 2),
   the depth-3 run's first lookahead key (kv = 506 438: the protected,
   pinned, policy and empty tiers) through the kernel bitwise = plain and
   the victim order = a stable argsort, and after the depth-3 schedule's
   flush every resident arena row bitwise its host row.  Prints each timed
   run's step p50 / p99, the host ms of plan, apply and compute a step,
   the plans a group and a profiled group's idle share.
5e. the sharded budget mode: phase 5c's plan (1 GiB a device, int8 host
   tier and arena) with every CACHED slab split over 4 shards (the card
   holds all four shards' arenas; the int8 sideband stacked [S, vs, 2]):
   ``--batches`` served, ``--train-steps`` trained, flush, the counts at 0
   before each and read after.  Checks the plan, ``device_per_shard``
   within the budget, 20 threshold and 5 bucketize launches a plan (all
   ``route_bucketize``), gather-decode in the write-backs (all
   ``gather_decode_encode``), cached = ``dense_reference`` logits
   (rtol 1e-5 / atol 1e-6), and after the flush every resident row's host
   payload and sideband bitwise the int8 encode of its arena row, shard by
   shard.  Then 5g's re-homing on that flushed state (below).
5f. the adaptive refresh, unsharded, on a drifting Zipf stream (the hot
   set moves every 3 steps): phase 5d's DLRM (fp32 tiers) served by a
   ``ServeEngine`` with ``refresh_every`` 2 and by one without (3 batches,
   scores bitwise batch by batch; one init, its device leaves restored
   between the engines: serving without a refresh writes no host row); trained ``REFRESH_STEPS`` (5) steps by
   the serial ``Trainer`` without a refresh, with ``refresh_interval`` 3,
   and by the depth-3 ``PipelinedTrainer`` with it, each from ``init(0)``
   under torch's deterministic algorithms (losses bitwise equal); the
   serial run with the refresh then goes on 5 steps in the default mode
   for its step times and each pass's planning and surgery ms.  Then the
   int8 host tier and arena trained 5 steps with the interval (the dirty
   passes' write-backs through the gather-decode kernel), flushed (host
   payload and sideband = the int8 encode of each resident arena row),
   and a refresh of the clean state (``dense_reference`` bitwise).
5g. the sharded refresh: phase 5b's fp32 4-shard DLRM trained 3 steps on
   the drifting stream and flushed, one pass at ``max_swaps`` 4096 with
   ``exchange_budget`` 1024 (``dense_reference`` after a flush bitwise
   before and after; cross-shard rows within the budget; swaps + deferred
   = the unbudgeted plan's swaps), one step over the swapped homes.  Its
   re-homing runs at the end of 5e, on 5e's flushed state: a re-homing
   pass with the median slab's live imbalance as ``rebalance_threshold``
   (the slabs above it re-homed, their imbalance lowered, the others
   untouched; ``dense_reference`` bitwise; served logits over the new
   homes = ``dense_reference`` logits; the host RSS peak), one step over
   the new homes, on the drifting stream.
5h. ``benchmarks/bench_drift.py``'s run in the port (vocab 400 000, dim 32,
   batch 8192, the hot set moving every 150 steps, 450 steps, a refresh
   every 5 steps at ``max_swaps`` 4096 and ``min_gain`` 0.25), with and
   without the refresh from the same init, the plans through the
   threshold kernel: hit and miss counts, hit rates, swaps and rows moved
   equal to the JAX package's on the CPU (``scripts/drift_reference.py``).
   Each new path runs with the launch counts at 0 before it and read
   after it; the ``kernels`` line counts them by path.  Phase 5f runs
   after 5d; 5g-5h after phase 17d and before phase 8.
6. FM serve: ``configs/fm.CONFIG`` at full width (40 fields, 33 764 352
   rows of 11 fp32 = 1.486 GB pinned, a 2 097 152-slot arena, batch 65536)
   with ``use_pallas=True``: ``ServeEngine(FMModel.serve_step)`` on
   ``FM_BATCHES`` (8) batches.  Checks finite scores, no overflow, one
   threshold and one FM-kernel launch per batch, the cache invariant, the
   FM kernel = plain on one live batch's strided v, and the threshold =
   plain (victim order = argsort) on one more plan's live key.  The table
   is unpinned and freed.
7. FM train: the same FM with ``use_pallas=False`` (the kernel has no
   backward): ``FM_TRAIN_STEPS`` (4) ``train_step`` calls, then ``flush``.
   Checks finite losses, no overflow, one threshold launch per plan, and
   that after the flush every resident arena row equals its host row
   bitwise.
7b. FM chunked staging: phase 7 again from the same seed, at row
   granularity and with ``chunk_rows=64`` (which divides FM's 33 764 352
   rows), ``FM_CHECK_STEPS`` (2) steps each under torch's deterministic
   algorithms, then ``FM_TRAIN_STEPS`` (4) chunked steps in the default
   mode for their times: every load
   packs whole 64-row chunks into the staging block, sized by the round's
   unique chunks, and picks the rows out on the card; every write-back
   read-modify-writes the touched chunks on the host.  Checks losses
   bitwise phase 7's, every move chunked (the transmitter's counter) and
   the post-flush rows; prints the largest staging block's bytes.
14a. the paper's single-table ``core.cached_embedding`` at full Criteo
   width: the 26 fields concatenated into one 33 762 577-row fp32 table of
   dim 128 (17.29 GB pinned), 506 438 slots, ``ids_per_step`` 16 384 x 26,
   ``use_pallas_plan``.  ``CE_SERVE`` (8) batches through ``embed_onehot``
   with write-back off (the rows bitwise ``dense_reference_lookup``), the
   threshold bitwise its plain version on one more plan's live key, then
   ``CE_TRAIN`` (4) ``EmbTrainStep`` steps (the Criteo DLRM's bottom MLP,
   dot interaction and top MLP, SGD), ``flush_state`` (every resident slot
   = its host row, bitwise); the table is freed and a second one with
   ``rowwise_adagrad`` trains ``CE_ADAGRAD`` (2) steps and flushes (rows,
   and each resident row's accumulator = the host's, bitwise).  Prints the
   hit rate, the step p50 and the host RSS.
14b. the paper's Avazu DLRM (``configs/dlrm_avazu.CONFIG``: 13 fields,
   9 445 823 rows of dim 128 = 4.84 GB pinned, 8 dense features, batch
   65 536, 851 968 slots, ``use_pallas_plan``): ``ServeEngine`` on
   ``AVAZU_SERVE`` (8) batches (cached = ``dense_reference`` logits), the
   threshold bitwise plain on the live key, then the ``Trainer``'s
   ``AVAZU_TRAIN`` (4) steps and a flush (every resident slot = its host
   row, bitwise).  Prints serve and train p50, a profiled step's idle
   share and the host wire bytes.  Both phases run with the launch counts
   at 0 before each run and read after it.
15a. DIN (``configs/din.CONFIG``: items 10 000 000, categories 1 000 000,
   users 1 000 256, dim 18, histories of 100, attention MLP 80-40, MLP
   200-80, batch 65 536; ``use_pallas_plan``): a 12 000 256 x 18 fp32 host
   table (864 MB) pinned, a 4 194 304-slot arena (the unique bound 2^22),
   13 303 808 id lanes a plan (the history lanes past ``hist_len`` are
   -1).  ``ServeEngine`` scores ``--batches`` batches (cached logits =
   ``dense_reference`` logits within rtol 1e-5 / atol 1e-6, no overflow,
   one threshold launch a plan), the threshold is held bitwise to its plain
   version (victim order = argsort) on one more plan's live 4 194 304-entry
   key, ``retrieval_score`` scores one user against 65 536 candidates
   (finite, shape [65 536]; a CUT from ``N_CANDIDATES`` = 10^6, logged:
   DIN's attention input alone would be 57.6 GB there), then the
   ``Trainer`` takes ``--train-steps`` steps and flushes (every resident
   slot = its host row, bitwise).  Prints serve p50 / p99, train p50, the
   hit rate, peak device memory, a profiled step's idle share.  The
   batches are built before the timed loops (``recsys_batch`` takes ~0.3 s
   of host time at 65 536 x 100).
15b. DIEN (``configs/dien.CONFIG``: DIN's tables, a GRU and an AUGRU of 108
   units): the same checks, ``DIEN_SERVE`` (4) batches and ``DIEN_TRAIN``
   (4) steps at the published batch (autograd keeps ~55 GB of the card's
   80 at B 65 536 x T 100 x H 108), retrieval at 10^6 candidates (GRU1's
   states only, as in the reference).
15c. MIND (``configs/mind.CONFIG``: items 4 000 000, users 1 000 000, dim
   64, 4 interests, 3 routing iterations): a 1.28 GB host table, a
   4 194 304-slot arena (1.07 GB); the same checks as 15a, retrieval at
   10^6 candidates.  Each of 15a-15c runs with the launch counts at 0
   before each run and read after it; the ``kernels`` line counts them
   under ``din`` / ``dien`` / ``mind``.
8. timing, last, in a fresh child process of this script, which loads the
   live inputs from a file under ``build/`` (``torch.profiler`` drops the
   device events of short windows around the port's kernels late in a long
   process, see ``scripts/profiler_probe.py``; a window whose events are
   not all there is taken again): each kernel, its plain version (and ``torch.topk`` beside the
   threshold, ``F.embedding_bag`` beside the bag) by CUDA events over
   back-to-back calls, their summed device time per call from
   ``torch.profiler``, and the wrapper's host enqueue time (the median of
   5 warmed windows of 100 calls), on the live inputs of the main paths.
   First the launch floor: an empty kernel (``scripts/empty_launch.cu``,
   built with the port's sources) through ``build.Kernel``, its
   enqueue read in windows alternating with each enqueue of rows 2 and 3.
   ``gather_decode`` on the live fp32 write-back;
   ``gather_decode_encode`` on phase 5c's first live int8 write-back, one
   device op a call, beside the composition it replaced (the gather-decode
   kernel, then ``Int8Codec.encode``) and one profiled write-back round
   both ways (>= 12 device ops fewer); ``route_bucketize`` on the first
   sharded plan's live router inputs as the plan calls it (``route_image``),
   one device op a call, beside the composition it replaced (the route's
   torch ops, then the bucketize kernel) and the entry that also writes
   owner and local, and ``bucketize`` alone on that route's owner and
   local.  The
   threshold is timed on the DLRM serve plan's, FM's, phase 5d's depth-3
   lookahead, 14a's, 14b's, 15a's and 15c's keys (DIN's and MIND's:
   4 194 304 entries; the plain version and ``torch.topk`` profiled on
   the DLRM key only); each call must show one device op and no memset.  The bag is timed as the main path calls
   it, once over a live bag step's 26 features (against one
   ``F.embedding_bag`` call over the same bags; the ``kernels`` line
   carries this call), and alone on two live features, f0 (vocab 1460) and
   f2 (vocab 10 131 227, the largest); then the bag step's kernel route,
   forward plus backward, in host enqueue and event ms: one many-feature
   op against 26 single-feature ops.

9. flash kernels: the flash-attention kernels against their plain version
   on ``test_kernels.py``'s sweep, head dims 16 and 20 (the SMOKE
   configs'), 15 query heads over 5 KV heads, a length of 96, a window
   wider than S and d 256, fp32 (the 3xTF32 tensor-core kernel up to d
   128, the SIMT kernel at d 256) and bf16 (the bf16 tensor-core kernel),
   each launch counted on the route its dtype and head width select, within
   2e-5 * (1 + |o|) per element (the reference's fp32 tolerance), plus one
   bf16 ulp of o in bf16; then the autograd backward (kernel forward, plain
   recompute) against the plain version's autograd, q/k/v grads within
   1e-4.
10. LM serve: SmolLM-360M (``configs/smollm_360m.CONFIG``: 32 layers,
   d_model 960, 15/5 heads of 64, d_ff 2560, vocab 49152, bf16) with
   ``use_pallas=True``, initialised on the card from a seeded generator:
   a warm-up and ``LM_PREFILLS`` (3) ``prefill_step`` requests of B 8 x S
   4096 from ``seq_batch`` (the batch cut from prefill_32k's 32 for the
   full-vocab logits; printed), one request of B 1 x S 32 768, and a
   greedy decode of B 8 (a 64-token prompt through ``decode_fn`` from
   position 0 into 4096-slot caches, then 64 tokens).  Checks finite
   logits, 32 kernel launches per prefill and none in decode, and the
   kernel against plain, within the bound of phase 9, on layer 0's live
   q/k/v at both lengths (captured where the model calls
   ``ops.flash_attention``; max and mean |o| printed).
   Prints prefill p50 and tokens/s, decode ms/token p50, the max |diff|
   of last logits against the ``use_pallas=False`` route (not gated: the
   routes round differently in bf16), and profiles one prefill and one
   decode step; every prefill launch takes the tensor-core route, and the
   profiled prefill must show the tensor-core kernel's symbol and not the
   SIMT kernel's.
11. LM fp32: the same model in fp32 (TF32 off for torch's matmuls), B 2 x
   S 4096: last logits of the kernel route and the chunked route, and 64
   teacher-forced ``decode_step`` calls against ``forward``'s logits at
   positions 0-63, within rtol 1e-4, atol 1e-4 * max|logit|; 32 launches,
   all on the 3xTF32 route (d 64); the kernel against plain on layer 0's
   live fp32 q/k/v; a timed ``prefill_step`` (wall ms printed) and a
   profiled one, which must show the 3xTF32 kernel's symbol and not the
   SIMT kernel's.
12. Gemma: ``configs/gemma3_27b.CONFIG`` at published width (d_model 5376,
   32/16 heads of 128, d_ff 21504, vocab 262144, window 1024, bf16), depth
   cut to one pattern group of 6 (5 local, 1 global; printed): a prefill
   of B 1 x S 8192 through the kernel; checks finite logits, 6 launches and
   the kernel against plain on layer 0's live windowed q/k/v.
13. flash timing: on the live layer-0 q/k/v of the B 8 x 4096 prefill, the
   tensor-core kernel, its plain version and
   ``F.scaled_dot_product_attention`` (the yardstick; the port never calls
   it), with the bound from the live (q, k) pairs at 989 TFLOP/s bf16 and
   the bytes at 3.35 TB/s; the same kernel on Gemma's live windowed
   layer-0 inputs (d 128) beside their bound; and on phase 11's live fp32
   inputs the 3xTF32 kernel and the SIMT kernel (called straight through
   its C entry, uncounted, as the before figure) in turns (SIMT, 3xTF32,
   3xTF32, SIMT), the 3xTF32 kernel's device time from guarded profiler
   windows and its host enqueue, the plain version and SDPA, bound at 67
   TFLOP/s fp32, with the three TF32 products' floor at 495 TFLOP/s beside
   it; and the SIMT kernel (fp32 heads of 129-256) on phase 9's d 256
   inputs beside its plain version and SDPA with the same mask, bound by
   the FLOP of the pairs the mask keeps at 67 TFLOP/s.

16a. LM training: SmolLM-360M (``configs/smollm_360m.CONFIG``, 32 layers,
   d_model 960, 15/5 heads of 64, vocab 49152, bf16 compute, remat) with
   ``use_pallas=True`` from ``LMModel.init`` (the reference's training
   dtypes: fp32 matrices and AdamW moments, bf16 table and norms; checked),
   at S 4096 and the largest batch of 8, 4, 2 that fits (cut from
   train_4k's 256; printed): a warm-up and ``TRAIN_STEPS`` (2) timed
   ``train_step`` calls with compressor ``none``, ``TRAIN_INT8_STEPS`` (1)
   with ``int8``, each with 2 x 32 flash launches (forward and remat
   recompute), all on the tensor-core route, finite loss and gradient
   norm; layer 0's live q/k/v through kernel and plain within phase 9's
   bound; the kernel, plain and SDPA timed on them with the bound; step
   p50, tokens/s, peak device memory, a profiled step's idle share.
16b. LM training in fp32 (TF32 off): the same width, depth cut to 4
   (printed), B 2 x S 4096: one step through the 3xTF32 kernel and one
   through the chunked route from one state and batch: loss and gradient
   norm within rtol 1e-4, every updated parameter within rtol 1e-4 / atol
   0.2 lr; 8 launches, all 3xTF32, 0 on the chunked route.
16c. OLMoE-1B-7B (``configs/olmoe_1b_7b.CONFIG``: 16 layers, d_model 2048,
   16/16 heads, 64 experts of d_ff 1024, top-8, ``moe_impl="shard_map"``)
   served at published width and depth in bf16: prefills of B 4 x S 4096
   (16 launches each; the pairs dropped by capacity per layer printed;
   layer 0's live MoE input through ``moe_apply_shard_map`` and
   ``moe_apply`` in fp32 within rtol 1e-4 / atol 1e-4 * max|out| on every
   token without a router near tie), a greedy decode of B 8 (a 64-token
   prompt, 32 tokens; 0 launches); then trained at published width, depth
   cut to 4 (printed), B 2 x S 4096: 8 launches a step, peak memory.
16d. Grok-1-314B (``configs/grok_1_314b.CONFIG``: d_model 6144, 48/8 heads
   with ``kv_repeat=2``, 8 experts of d_ff 32768, top-2, vocab 131072,
   bf16), depth cut to one layer (printed): one prefill of B 1 x S 8192,
   one launch, finite logits, layer 0's live q/k/v (16 replicated KV
   heads) through kernel and plain.
16e. int8 KV-cache decode: SmolLM-360M with ``kv_cache_int8=True`` (phase
   10's weights and prompt), B 8, 64 prompt tokens and 64 greedy tokens
   into 4096-slot caches, 0 launches: on the last step's live layer-0
   tensors, the int8 attention on the card against the same function on
   the CPU (the query codes and q.k accumulators bitwise, the w.v
   accumulators bitwise the exact integer dot of the card's codes, the
   weight codes within one, the output within 1e-4 of max|o| plus the
   effect of any code that rounds the other way); printed, not gated: ms
   a token against phase 10's, the caches' bytes, the greedy tokens'
   agreement.  Each of 16a-16e runs with the launch counts at 0 before
   each call and read after it; the ``kernels`` line counts the flash
   launches by call.

17a. GatedGCN (``models/gatedgcn.py``) at the published width of
   ``configs/gatedgcn.SHAPE_CFG`` (16 layers, d_hidden 70, fp32, TF32
   off), full_graph_sm: Cora padded to 512 (N 3 072, E 10 752, 1 433
   features, 7 classes).  The card's logits against the same model's
   forward on the CPU at this shape (rtol 1e-4, atol 1e-5 * max|logit|;
   printed), one train step's loss and new state against the CPU's (the
   tolerances of ``tests/test_torch_gnn.py``), two runs of 2 train steps
   under torch's deterministic algorithms bitwise equal (the card's
   ``index_add_`` sums in no fixed order outside that mode); then
   ``GNN_SERVE`` (5) ``serve_step`` and ``GNN_TRAIN`` (5) ``train_step``
   calls: p50 / p99, nodes/s, peak device memory, a profiled train step's
   idle share and device ops, the host seconds a batch.
17b. minibatch_lg: a fresh ``sampled_batch`` a step (1 024 seeds, fanouts
   15 and 10: N 169 984, E 168 960; 602 features, 41 classes) from a
   random graph of Reddit's 232 965 nodes and 11 606 919 edges: serve and
   train as 17a, losses finite.
17c. molecule: 128 graphs of up to 30 nodes and 64 edges (16 features,
   graph regression): serve and train as 17a, losses finite, every graph
   pooling at least one node.
17d. ogb_products: N 2 449 408 at 100 features and 47 classes,
   ``serve_step`` only: the forward at the full 61 859 328 edges, then
   every 2nd, 4th, ... edge until it fits (the cut printed as ``reduced``
   beside its peak); timed and profiled serves; then one train step at
   that cut, which is expected not to fit (no remat or edge sharding, as
   in the reference).  17a-17d launch no kernel of the port: every
   wrapper's count is the same before and after them.

18. the hot-path contract gate on the card: ``python -m
   repro_torch.analysis.run --strict --device cuda --json`` in a fresh
   child process, every registered entry point's smoke case under the sync
   census and the operation recorder; fails on a non-zero exit, and unless
   each hand-written kernel (the threshold, ``bucketize`` and
   ``route_bucketize``, ``gather_decode`` and ``gather_decode_encode``,
   the bag, FM, and flash by its three routes) launched in the child with
   no sync in its entry's case.  Prints the entries, the findings by site
   and each wrapper's launches.  Beside it, the census
   (``analysis.census.sync_census``) of one full-width step of the main
   paths, each inside the phase that holds its state: a DLRM serve batch
   (4), an int8-tiered train step (5), a depth-3 pipelined group (5d), a
   SmolLM-360M decode token at B 8 (10) and a SmolLM-360M train step
   (16a); and, for the CUDA-graph items, a train step of DIN, DIEN and
   MIND (15a-15c) and of GatedGCN's full_graph_sm (17a).  Each prints its
   syncs by ``file:line``; a site in the port that
   ``analysis/baseline.json``'s ``sync_sites`` does not hold fails the
   smoke.

19. hybrid parallel over ranks, one cache shard a process (``dist/run.py``
   spawns the ranks, which run ``tests/torch_rank_jobs.py``'s jobs, after
   the parent built every kernel; a failing rank fails the smoke).  Every
   four-rank job below (19a; 19b's 4-shard and ``(2, 2)`` cases; 19d; 19f;
   19e) runs in ONE world of four gloo ranks, each job on a fresh mesh of
   its own shape, and 19b's two-rank jobs in one world of two
   (``ranks_phase``); the parent checks each phase after, and prints its
   seconds (its jobs on the slowest rank and its checks).  19a:
   5b's DLRM (4 shards, K 2048, fp32 exchange) with an int8-tiered arena
   and the row leg at the compact width ``DIST_WIDTH`` (16 384) in four
   gloo ranks time-sharing the card, each pinning its 4.32 GB host slice:
   ``DIST_SERVE`` (3) batches through a ``ServeEngine`` after a warm-up
   batch, a warm-up step, ``DIST_TRAIN`` (4) train steps, all on 5b's
   batches (5b serves ``DIST_SERVE`` batches too), a flush, then one
   census step (its syncs by site, held to the baseline), in torch's
   default mode.  Checks every rank's scores, losses and replicated leaves
   (MLPs, replicated head, routing maps) bitwise the others', cached logits = the uncached rows as the tiered arena holds
   them (rtol 1e-5 / atol 1e-6), a rank's plan 1 ``route_bucketize`` and 1
   threshold launch, ``gather_decode`` launches = the write-back and flush
   rounds the plans imply, and the count-valued exchange metrics a step = 5b's
   stacked run on the same batches.  Prints each rank's serve and step
   p50, the collectives, their host ms and the bytes sent a step, RSS and
   peak device memory.  19b: at vocab scale 0.02 and batch ``DIST_BATCH``
   (2048), gloo ranks at S 2 and 4 with the fp32 and int8 exchange, the
   row leg at every lane's width and at compact ones, and one int8-tiered
   arena into an int8 host (``gather_decode_encode``), 3 steps and a flush
   each, against the one-process stacked layout run by the parent:
   losses, arena, host slice and head of every shard bitwise (all under
   ``deterministic()``); the int8 case's checkpoint, saved by the ranks,
   restored into the stacked layout: its next loss bitwise the ranks'.
   At the same cut, phase 5e's budget plan (21 DEVICE tables, 5 cached
   slabs, int8 host and arena, K 2048) at ``(1, 2)`` and ``(2, 2)``: 3
   steps, a flush and a checkpoint restored into the stacked layout; the
   same steps, then a refresh pass and a forced re-homing; a bag step
   (``pool`` under the mesh, one ``embedding_bag`` launch a slab) from the
   init, then a flush.  Held to the stacked layout: losses, each shard,
   the DEVICE tables and MLPs bitwise at ``(1, 2)`` (at ``(2, 2)`` the
   losses within rtol 1e-5, slot maps bitwise, the replicas bitwise each
   other), the passes bitwise, the bag step's pooled rows, gradients and
   updated shards bitwise at both (the stacked yardstick differentiates
   each replica's bags alone and sums them in data-rank order).
   19c: one NCCL rank on ``cuda:0`` (S 1, the Criteo DLRM at vocab scale
   0.02, 2 steps) bitwise the unsharded DLRM.  19d: 5b's DLRM (K 2048, int8-tiered
   arena, the plan at the compact width ``DATA_WIDTH``, 32 768) on a
   ``(data=2, model=2)`` mesh of four gloo ranks sharing the card, each
   data replica feeding 8 192 of every global batch of 16 384 and each
   rank pinning half of the host table (``MemAvailable`` printed before
   the spawn), in torch's default mode: ``DATA_SERVE`` (2) served batches
   after a warm-up, a warm-up step, ``DATA_TRAIN`` (3) serial steps, a
   flush and one ``PipelinedTrainer`` group of depth 2 from that state.
   Checks every replica's shard (arena, host slice, head, slot map)
   bitwise its twin's, every rank's replicated leaves (MLPs, head,
   routing maps), losses and scores bitwise the others', cached =
   uncached logits, a plan's 1 threshold and 1 ``route_bucketize`` (the
   group's plan: 1 and 2, its window's image in the second), and
   ``gather_decode`` = the rounds the plans imply.  Prints a rank's step,
   serve and group ms, the bytes it sends a step and a batch by leg and
   axis, RSS and peak device memory.  19e: at 19b's cut (vocab scale
   0.02, global batch 2 048, 3 steps, an int8-tiered arena over an fp32
   host, K 2048, ``(1, 4)`` under ``deterministic()``) gloo ranks at ``(2, 2)`` and
   ``(1, 4)`` train, then make a refresh pass (``max_swaps`` 4096,
   ``exchange_budget`` 1024; the replicated head made the coldest ranks,
   so the pass demotes it) and a forced re-homing across the ranks; the
   parent rebuilds the stacked layout from the ranks' state before the
   passes and makes the same passes: every rank's state after each pass
   (swaps, homes, rows, host slices, trackers) bitwise the stacked
   layout's shard, the reports equal, a lookup and ``dense_reference``
   after them bitwise on the replica's rows, each pass's
   ``gather_decode`` launches = the rounds of its moves out of the arena
   (no plan kernel in a pass), and the losses bitwise the stacked
   layout's at ``(1, 4)`` and within rtol 1e-5 of the stacked ``(1, 2)``
   layout's at ``(2, 2)``, on the same global batches.  19f: phase 5e's
   plan (1 GiB a device, int8 host and arena: the 21 DEVICE tables whole
   on every rank, each cached slab one shard a rank) on the ``(2, 2)``
   mesh at full width, in torch's default mode: 2 served batches after a
   warm-up, a warm-up step, 2 steps, one bag step (sum) through
   ``pool(use_pallas=True, max_bag=4)`` on ``bag_batch``'s bags, a flush.
   Checks ``device_process`` within 1 GiB, every replica's shard bitwise
   its twin's, every rank's DEVICE tables, MLPs and routing maps bitwise
   the others', losses and scores equal, cached = ``dense_reference``
   logits, a plan's 1 threshold and 1 ``route_bucketize`` a cached slab,
   the bag step's 26 ``embedding_bag`` launches (each output bitwise the
   plain version on its gathered lanes), ``gather_decode_encode`` = the
   rounds, every resident row's int8 host row the encode of its arena row
   after the flush, the DEVICE tables' gradient leg within its bound
   (Σ min(vocab, lanes) rows).  Prints the p50s, the bytes by leg and
   axis (the DEVICE leg beside its bound and the whole tables), RSS and
   peak device memory.

20. examples: each of the port's four examples (``examples/torch_*.py``)
   through its ``main`` on the card at its twin's sizes, and again with
   ``--device cpu`` at the same arguments (a card run starts from the CPU
   run's weights: each model's ``init`` draws on the CPU, the state moved
   through numpy): quickstart (30 lookups of 4 096 Zipf ids through a
   4 096-slot cache of 100 000 x 64 rows), serve_recsys (MIND at 200 000
   items: 8 batches, one user against 100 000 candidates), train_dlrm
   (five tables, 380 000 rows, batch 1 024: 50 steps with a checkpoint,
   the same directory resumed to 100, an uninterrupted 100;
   ``--device-budget-mb 20`` for 50; ``--verify-pipeline --pipeline-depth
   2 --cache-ratio 0.05`` for 50) and multi_device_scaling (8 gloo ranks
   sharing the card on a ``(data=2, model=4)`` mesh, 5 steps; its CPU
   world of 8 ranks from the same stacked init).  Checks every card run's
   hit, miss and eviction counts (host wire bytes, plans, assignments,
   device bytes) equal to the CPU run's, losses and retrieval scores within
   rtol 1e-4, quickstart's cache equal to the dense table, the resumed
   curve the uninterrupted one's, ``--verify-pipeline``'s own assert
   (bitwise, deterministic mode on the card), a threshold launch on every
   example's path and ``route_bucketize`` on the ranks, and no bag, FM or
   flash launch.  Each kernel row of the ``kernels`` line gains the
   examples' launches as ``examples_*`` paths.  Prints each example's
   step or batch p50.

They run in the order 1-2, 18, 3-5b, 19 (19a, 19b, 19d, 19f, 19e), 19c, 5c,
5d, 5f, 5e (with 5g's re-homing), 6-7b, 14a-14b, 15a-15c, 9-13, 16a-16e,
17a-17d, 5g-5h, 20, 8.  Each phase's seconds are printed.  The last three
lines are the
``kernels`` JSON, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  ``--vocab-scale`` < 1 cuts only the vocabularies
(never dim, widths, fields or batch) and says so.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
TOL_RTOL, TOL_ATOL = 1e-5, 1e-6  # cached vs uncached logits (fp32)
FM_BATCHES, FM_TRAIN_STEPS = 8, 4  # FM serve batches and train steps
FM_CHUNK_ROWS = 64  # phase 7b's chunk: divides FM's 33 764 352 rows (2^10 . 3 . 29 . 379)
FM_CHECK_STEPS = 2  # 7b's deterministic pair (the sort-based sums take ~2 s a step there)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def rss_gb() -> float:
    """This process's resident host memory, GB."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return kb * 1024 / 1e9


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

_BIG = (2**31 - 1) // 2


def _tie_heavy(rng, c):
    pool = np.concatenate([rng.integers(-4, 4, size=c), np.array([_BIG, -_BIG, -(_BIG // 2)])])
    return rng.choice(pool, size=c).astype(np.int32)


def _freq_lfu_keys(rng, c, vocab, n_protect):
    """Eviction keys as the paper's planner builds them: the resident row's
    rank per slot, -BIG for slots the batch needs, +BIG for empty slots."""
    key = rng.choice(vocab, size=c, replace=False).astype(np.int32)
    key[rng.permutation(c)[:n_protect]] = -_BIG
    key[rng.random(c) < 0.001] = _BIG
    return key


def kernel_phase(dev, capacity, kv, vocab):
    from repro_torch.kernels.cache_ops import kernel, ops, ref

    rng = np.random.default_rng(0)
    cases = []
    for trial in range(24):
        c = int(rng.integers(1, 200_000))
        k = int(rng.integers(1, c + 1))
        if trial % 3 == 0:
            key = rng.integers(-(2**31), 2**31 - 1, size=c, dtype=np.int64).astype(np.int32)
        else:
            key = _tie_heavy(rng, c)
        cases.append((key, k))
    main_key = _freq_lfu_keys(rng, capacity, vocab, n_protect=capacity // 5)
    cases.append((main_key, kv))
    cases.append((_tie_heavy(rng, capacity), kv))
    max_err = 0
    for i, (key_np, k) in enumerate(cases):
        key = torch.from_numpy(key_np).to(dev)
        t, n_gt = kernel.victim_threshold(key, k)
        t_p, n_p = kernel.victim_threshold_plain(key, k)
        err = max(abs(int(t) - int(t_p)), abs(int(n_gt) - int(n_p)))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"threshold case {i}: kernel ({int(t)}, {int(n_gt)}) != "
                                 f"plain ({int(t_p)}, {int(n_p)})")
        got = ops.victim_topk_impl(key, k)
        if not torch.equal(got, ref.victim_topk(key, k)):
            raise AssertionError(f"victim_topk case {i}: kernel route != plain route")
        if i >= len(cases) - 2:  # main-path shapes: also the full stable argsort
            want = torch.argsort(key, descending=True, stable=True)[:k].to(torch.int32)
            if not torch.equal(got, want):
                raise AssertionError(f"victim_topk case {i}: != argsort oracle")
    log(f"kernel phase: {len(cases)} cases bitwise equal (max_abs_err {max_err}), "
        f"main shape capacity={capacity} kv={kv}")
    return max_err


def check_threshold(key, kv, what):
    """The kernel against its plain version (bitwise) and the victim order
    against the full stable argsort, on one key vector; returns max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel, ops

    t, n_gt = kernel.victim_threshold(key, kv)
    t_p, n_p = kernel.victim_threshold_plain(key, kv)
    err = max(abs(int(t) - int(t_p)), abs(int(n_gt) - int(n_p)))
    if err:
        raise AssertionError(f"{what}: kernel ({int(t)}, {int(n_gt)}) != plain ({int(t_p)}, {int(n_p)})")
    want = torch.argsort(key, descending=True, stable=True)[:kv].to(torch.int32)
    if not torch.equal(ops.victim_topk_impl(key, kv), want):
        raise AssertionError(f"{what}: victim_topk != argsort oracle")
    return err


def capture_plan_key(plan):
    """The int32 eviction key and kv a plan hands to victim selection:
    planning is pure, so ``plan()`` re-plans one batch against the live
    state with the selection wrapped."""
    from repro_torch.kernels.cache_ops import ops

    captured = []
    select = ops.victim_topk_impl

    def capture(key, kv):
        captured.append((key.clone(), kv))
        return select(key, kv)

    ops.victim_topk_impl = capture
    try:
        plan()
    finally:
        ops.victim_topk_impl = select
    if len(captured) != 1:
        raise AssertionError(f"plan_prepare selected victims {len(captured)} times, not once")
    return captured[0]


GUARD_LAUNCHES = 32  # spin-kernel launches at both ends of a profiled window (F2)
GUARD_CYCLES = 1000  # each a ~1 us spin
GUARD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, left out of every sum


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` window over the card whose body is fenced by
    ``GUARD_LAUNCHES`` tiny spin kernels on each side.  The profiler drops
    a few device events of each window, more the older the process (F2,
    ``scripts/profiler_probe.py``); the guards are the events it drops.
    Readers leave ``GUARD_KERNEL`` out."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(GUARD_LAUNCHES):
            torch.cuda._sleep(GUARD_CYCLES)
        yield prof
        for _ in range(GUARD_LAUNCHES):
            torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()


def device_ms(fn, iters: int = 20, tries: int = 5):
    """Mean device time per call of ``fn`` (kernels, copies and memsets summed,
    from torch.profiler) and that time by device op; (None, {}) where the
    profiler cannot trace the card.  A window in which an op's event count
    is not a multiple of ``iters`` lost events (F2): it is taken again, up
    to ``tries`` times, and (None, {}) if none is whole."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        try:
            with profiled() as prof:
                for _ in range(iters):
                    fn()
        except RuntimeError as e:
            log(f"profiler: not measured ({e})")
            return None, {}
        by_op, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and GUARD_KERNEL not in e.key:
                us = (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0))
                by_op[e.key[:60]] = by_op.get(e.key[:60], 0.0) + us / 1e3 / iters
                counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
        if by_op and all(c % iters == 0 for c in counts.values()):
            if attempt:
                log(f"profiler: a whole window on try {attempt + 1} of {tries}")
            return sum(by_op.values()), by_op
    log(f"profiler: device events lost in all {tries} windows (last counts {counts})")
    return None, {}


def host_ms(fn, iters: int = 100, windows: int = 5, warmup: int = 10, against=None):
    """Host time to enqueue one call of ``fn`` (no sync inside): the median
    over ``windows`` warmed windows of the mean of ``iters`` back-to-back
    calls, the card synchronised between windows.  With ``against`` (the
    launch floor's call) its windows alternate with ``fn``'s and the result
    is the pair of medians, ``fn``'s then its: the host's noise on a shared
    machine moves both alike."""
    fns = [fn] if against is None else [fn, against]
    for f in fns:
        for _ in range(warmup):
            f()
    per = [[] for _ in fns]
    for _ in range(windows):
        for f, p in zip(fns, per):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                f()
            p.append(1e3 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    med = [float(np.median(p)) for p in per]
    return med[0] if against is None else tuple(med)


def device_ops(fn, iters: int = 5):
    """Device ops per call of ``fn``: the profiler's device events (kernels,
    copies, memsets; the guard kernels left out) over ``iters`` calls in a
    guarded window, per call, by op and in all; None where the profiler
    cannot trace the card."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    try:
        with profiled() as prof:
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        log(f"profiler: not measured ({e})")
        return None, {}
    by_op = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and GUARD_KERNEL not in e.key:
            by_op[e.key[:60]] = by_op.get(e.key[:60], 0) + e.count / iters
    return sum(by_op.values()), by_op


def time_threshold(live, max_err, launches_by_path):
    """Times the kernel, its plain version and torch.topk on the main paths'
    live key vectors (the DLRM serve plan's, FM's, the depth-3 lookahead's,
    the single table's, the Avazu DLRM's, DIN's and MIND's): back-to-back
    CUDA-event time (what a caller pays on the stream), summed device time
    per call by op (the plain version's and topk's on the DLRM key only,
    whose row the ``kernels`` line carries), and the kernel wrapper's host
    enqueue time.  Every kernel call must show one device op and no
    memset."""
    from repro_torch.kernels.cache_ops import kernel

    rows = {}
    for what, (key, kv) in live.items():
        n = key.shape[0]
        calls = {"kernel": lambda: kernel.victim_threshold(key, kv),
                 "plain": lambda: kernel.victim_threshold_plain(key, kv),
                 "topk": lambda: torch.topk(key, kv)}
        ev = {name: cuda_ms(fn) for name, fn in calls.items()}
        dev, by_op = {}, {}
        for name, fn in calls.items():
            if name == "kernel" or what == "DLRM serve":
                dev[name], by_op[name] = device_ms(fn)
        enqueue = host_ms(calls["kernel"])
        ops = by_op["kernel"]
        if len(ops) != 1 or any("emset" in op for op in ops):
            raise AssertionError(f"victim_threshold on the {what} key: device ops {ops}, want "
                                 f"one kernel and no memset")
        n_bytes = n * 4 + 8 + 4  # keys read once; t and n_gt written once
        bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
        log(f"victim_threshold on the {what} plan's key [{n}] kv={kv}: event-timed ms "
            + ", ".join(f"{name} {ms}" for name, ms in ev.items()) + "; device ms per call "
            + ", ".join(f"{name} {ms}" for name, ms in dev.items()) + f"; kernel host enqueue "
            f"{enqueue} ms; bound {bound_ms} ms (1 read of {n_bytes} B), below one launch's "
            f"latency; kernel device ms per call by op {json.dumps(ops)}")
        rows[what] = {"n": n, "kv": kv, "event_ms": ev, "device_ms": dev,
                      "host_enqueue_ms": enqueue, "bound_ms": bound_ms}
    main = rows["DLRM serve"]
    return {
        "name": "victim_threshold",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/victim_threshold.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:79",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max_err,
        "ms": main["event_ms"]["kernel"],
        "plain_ms": main["event_ms"]["plain"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["event_ms"]["topk"],
        "device_ms": main["device_ms"]["kernel"],
        "plain_device_ms": main["device_ms"]["plain"],
        "library_device_ms": main["device_ms"]["topk"],
        "host_enqueue_ms": main["host_enqueue_ms"],
        "by_key": rows,
    }


# ---------------------------------------------------------------------------
# phase 4: serve the paper's DLRM through the cache
# ---------------------------------------------------------------------------


def serve_phase(dev, vocab_scale, n_batches):
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine

    cfg = _scaled(vocab_scale)
    model = DLRM(cfg)
    spec = model.collection.cached_slabs["__shared__"]
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs["__shared__"]
    log(f"init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x {spec.dim} fp32 "
        f"= {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; arena {spec.capacity} "
        f"rows = {spec.capacity * spec.dim * 4 / 1e6} MB on {torch.cuda.get_device_name(0)}")

    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    # measured, invariant check, 3 breakdown, profiled, warm-up, census
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 0, i) for i in range(n_batches + 7)]
    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(
        model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad, device=dev,
        state_stats_fn=lambda s: model.collection.metrics(s["emb"], writeback=False),
        obs_annotate=True,
    )
    engine.score(batches[n_batches + 5])  # first call: library handles, allocator, cuBLAS
    engine.stats = type(engine.stats)()  # latency of the measured batches only
    base = engine.summary()  # cumulative counters so far (warm-up batch)

    # --- the main path: counts at 0, n_batches scored requests, counts read ---
    kernel.victim_threshold.launches = 0
    lat, all_scores = [], []
    for b in batches[:n_batches]:
        t0 = time.perf_counter()
        all_scores.append(engine.score(b))
        lat.append(1e3 * (time.perf_counter() - t0))
    launches = kernel.victim_threshold.launches
    summary = engine.summary()
    hits = summary["cache_hits"] - base["cache_hits"]
    misses = summary["cache_misses"] - base["cache_misses"]
    wire = summary["host_wire_bytes"] - base["host_wire_bytes"]

    scores = np.concatenate(all_scores)
    if scores.shape != (n_batches * cfg.batch_size,) or not np.isfinite(scores).all():
        raise AssertionError(f"scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if summary["uniq_overflows"] != 0:
        raise AssertionError(f"uniq_overflows = {summary['uniq_overflows']}")
    if launches != n_batches:
        raise AssertionError(f"victim_threshold launched {launches} times for {n_batches} plans")
    log(f"serve: {n_batches} batches of {cfg.batch_size}; per-batch ms {lat}")
    log(f"serve summary: {json.dumps(summary, sort_keys=True)}")
    log(f"serve (measured batches): p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms "
        f"(histogram bounds), requests/s {summary['requests'] / (sum(lat) / 1e3)}, "
        f"hit rate {hits / max(hits + misses, 1)} ({hits} id hits, {misses} row misses), "
        f"host wire bytes {wire}, kernel launches {launches}")
    log(f"score span: {json.dumps(engine.tracer.stage_summary())}")
    census_call("4 (DLRM serve batch)", lambda: engine.score(batches[n_batches + 6]))

    # --- cache invariant on the card: cached rows == host-table rows --------
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_batches].items()}
    logits, emb = model.serve_step(engine.state, b)
    ref_rows = model.collection.dense_reference(emb, model.features(b))
    ref_logits = model.fwd(engine.state["params"], {k: v.to(dev) for k, v in ref_rows.items()}, b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"cached vs uncached logits differ by {diff}")
    log(f"cache invariant: max |cached - uncached| logit = {diff} "
        f"(tolerance rtol {TOL_RTOL} atol {TOL_ATOL})")

    # --- stage by stage with syncs, three batches: where the time goes ------
    st = dict(engine.state, emb=emb)
    coll = model.collection
    for i in range(n_batches + 1, n_batches + 4):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}
        fb, t_feat = sync_ms(lambda: model.features(b))
        plan, t_plan = sync_ms(lambda: coll.plan_prepare(st["emb"], fb, writeback=False))
        emb2, t_apply = sync_ms(lambda: coll.apply_plan(st["emb"], plan))
        rows, t_gather = sync_ms(lambda: coll.gather(coll.weights(emb2), plan.addresses, fb))
        logits, t_dense = sync_ms(lambda: model.fwd(st["params"], rows, b))
        _, t_resp = sync_ms(lambda: logits.cpu())
        st = dict(st, emb=emb2)
        log(f"breakdown ms (synced, batch {i}): features {t_feat}, plan_prepare {t_plan}, "
            f"apply_plan {t_apply}, gather {t_gather}, dense {t_dense}, response copy {t_resp}")
    engine.state = st

    # --- the kernel on a real plan's eviction key ----------------------------
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_batches + 1].items()}
    key, kv = capture_plan_key(lambda: coll.plan_prepare(st["emb"], model.features(b),
                                                         writeback=False))
    err = check_threshold(key, kv, "serve plan key")
    log(f"serve plan key [{key.shape[0]}] kv={kv}: kernel bitwise = plain, victim order = "
        f"argsort; protected {int((key == -_BIG).sum())}, empty {int((key == _BIG).sum())}, "
        f"distinct {int(torch.unique(key).numel())}")

    spans = set(engine.tracer.stage_summary())
    profile_call("one score call", lambda: engine.score(batches[n_batches + 4]), skip=spans)
    slab.full.close()
    return launches, key, kv, err


# ---------------------------------------------------------------------------
# phase 3b: tiered-arena gather-decode vs its plain version
# ---------------------------------------------------------------------------

PAPER_H, PAPER_T, PAPER_K = 126_610, 379_828, 65_536  # head / tail of 506 438 slots


def _gd_inputs(rng, dev, codec, h, t, d, k):
    """Head, encoded tail (+ sideband), and slots with every edge lane."""
    from repro_torch.store.codec import get_codec

    head = torch.randn((h, d), generator=rng, device=dev)
    rows = torch.randn((t, d), generator=rng, device=dev) * 3
    payload, side = get_codec(codec).encode(rows)
    edges = torch.tensor([-1, h - 1, h, h + t - 1, h + t, 2**31 - 1, -(2**31), h + t + 1000],
                         dtype=torch.int32, device=dev)
    rand = torch.randint(-2, h + t + 2, (k - edges.numel(),), generator=rng, device=dev,
                         dtype=torch.int32)
    return head, payload.contiguous(), side, torch.cat([edges, rand])


def check_gather_decode(args, codec, what):
    """The kernel against its plain version on one input, bitwise; returns
    max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel

    got = kernel.gather_decode(*args, codec)
    want = kernel.gather_decode_plain(*args, codec)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"gather_decode {what}: kernel != plain (max |diff| {err})")
    return err


def _bits(x):
    """A tensor's bit pattern (so that +0 and -0 differ)."""
    return x.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()])


def check_gather_decode_encode(args, codec, host, what, zp_by_value=False):
    """The fused gather + decode + host encode against its plain version on
    one input: payload and sideband bitwise (``zp_by_value``: the
    sideband's zero points by value, for rows whose extremes are zeros of
    both signs); returns max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel

    got = kernel.gather_decode_encode(*args, codec, host)
    want = kernel.gather_decode_encode_plain(*args, codec, host)
    ok = torch.equal(_bits(got[0]), _bits(want[0]))
    if host == "int8":
        ok = ok and torch.equal(_bits(got[1][:, 0]), _bits(want[1][:, 0]))
        ok = ok and (torch.equal(got[1][:, 1], want[1][:, 1]) if zp_by_value else
                     torch.equal(_bits(got[1][:, 1]), _bits(want[1][:, 1])))
    if not ok:
        err = float((got[0].float() - want[0].float()).abs().max())
        raise AssertionError(f"gather_decode_encode {what}: kernel != plain (payload max |diff| "
                             f"{err})")
    return 0.0


def _gd_fused_inputs(rng, dev, codec, h, t, d, k):
    """``_gd_inputs`` with constant rows (mx = mn): head row 0 at 0.75, head
    row 1 zeros, tail row 0 decoding to one value; slots 0 and 1 added."""
    head, tail, side, slots = _gd_inputs(rng, dev, codec, h, t, d, k)
    head[0] = 0.75
    if h > 1:
        head[1] = 0.0
    if codec == "int8":
        tail[0] = 0  # decodes to zp
    else:
        tail[0] = 1.5
    extra = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    return head, tail, side, torch.cat([slots, extra])


def _signed_zero_rows(dev, d):
    """Head rows whose extremes are zeros of both signs (+-0 patterns, each
    sign first, all -0, and a -0 minimum under a positive maximum), for the
    fused int8 encode; returns the gather-decode arguments and torch's own
    amin / amax sign bits on the rows (1 = -0)."""
    rows = torch.zeros((6, d), device=dev)
    rows[0, 1::2] = -0.0  # +0 first
    rows[1] = -0.0
    rows[1, 1::2] = 0.0  # -0 first
    rows[2] = -0.0  # all -0
    rows[3, ::3] = -0.0  # mostly +0
    rows[4, 0] = -0.0
    rows[4, 1] = 2.0  # min a signed-zero tie, max 2
    rows[5] = torch.linspace(-1, 1, d, device=dev)
    tail = torch.zeros((1, d), dtype=torch.int8, device=dev)
    side = torch.ones((1, 2), device=dev)
    slots = torch.arange(6, dtype=torch.int32, device=dev)
    signs = [torch.signbit(f(rows, 1)).int().tolist() for f in (torch.amin, torch.amax)]
    return (rows, tail, side, slots), signs


def gather_decode_phase(dev):
    rng = torch.Generator(device=dev).manual_seed(0)
    sizes = np.random.default_rng(0)
    cases = fused = 0
    max_err = 0.0
    for codec in ("fp16", "int8"):
        for d in (8, 16, 36, 128):
            for _ in range(3):
                h, t, k = (int(x) for x in sizes.integers(1, 5000, size=3))
                args = _gd_inputs(rng, dev, codec, h, t, d, k + 8)
                max_err = max(max_err, check_gather_decode(args, codec, f"{codec} D={d}"))
                cases += 1
            h, t, k = (int(x) for x in sizes.integers(2, 5000, size=3))
            args = _gd_fused_inputs(rng, dev, codec, h, t, d, k + 8)
            for host in ("fp16", "int8"):
                check_gather_decode_encode(args, codec, host, f"{codec} -> {host} D={d}")
                fused += 1
        args = _gd_inputs(rng, dev, codec, PAPER_H, PAPER_T, 128, PAPER_K)
        max_err = max(max_err, check_gather_decode(args, codec, f"{codec} paper shape"))
        cases += 1
        for host in ("fp16", "int8"):
            check_gather_decode_encode(args, codec, host, f"{codec} -> {host} paper shape")
            fused += 1
    for d in (5, 37):  # the scalar path: D % 4 != 0
        args = _gd_fused_inputs(rng, dev, "int8", 300, 700, d, 500)
        for host in ("fp16", "int8"):
            check_gather_decode_encode(args, "int8", host, f"int8 -> {host} D={d}")
            fused += 1
    zero_args, signs = _signed_zero_rows(dev, 128)
    check_gather_decode_encode(zero_args, "int8", "fp16", "signed-zero rows -> fp16")
    check_gather_decode_encode(zero_args, "int8", "int8", "signed-zero rows -> int8",
                               zp_by_value=True)
    from repro_torch.kernels.cache_ops import kernel

    zp_k = kernel.gather_decode_encode(*zero_args, "int8", "int8")[1][:, 1]
    zp_p = kernel.gather_decode_encode_plain(*zero_args, "int8", "int8")[1][:, 1]
    log(f"gather_decode phase: {cases} cases bitwise equal (max_abs_err {max_err}), incl. the "
        f"paper shape H={PAPER_H} T={PAPER_T} D=128 K={PAPER_K} for fp16 and int8; "
        f"gather_decode_encode: {fused} cases (fp16 / int8 tails into fp16 / int8 hosts, D 5, "
        f"8, 16, 36, 37, 128, constant rows, the paper shape) payload and sideband bitwise the "
        f"plain version; 6 rows with signed-zero extremes: payload and scale bitwise, zp equal "
        f"by value (sign bits, 1 = -0: kernel {torch.signbit(zp_k).int().tolist()}, plain "
        f"{torch.signbit(zp_p).int().tolist()}; sign bits of torch's amin {signs[0]}, amax "
        f"{signs[1]}: rows 0 and 1 hold the same zeros in two orders)")
    return max_err


# ---------------------------------------------------------------------------
# phase 5: train the paper's DLRM through an int8-tiered arena
# ---------------------------------------------------------------------------


def _scaled(vocab_scale):
    from repro_torch.configs.dlrm_criteo import CONFIG

    vocabs = CONFIG.vocab_sizes
    if vocab_scale != 1.0:
        vocabs = tuple(max(1, int(v * vocab_scale)) for v in vocabs)
        log(f"CUT: vocabularies scaled by {vocab_scale} (total {sum(vocabs)} rows, "
            f"full {sum(CONFIG.vocab_sizes)}); dim, widths, fields and batch unchanged")
    return dataclasses.replace(CONFIG, vocab_sizes=vocabs, use_pallas_plan=True)


def train_phase(dev, vocab_scale, n_steps):
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel, ops
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.obs.hub import fetch_ints

    cfg = dataclasses.replace(_scaled(vocab_scale), arena_precision="int8")
    model = DLRM(cfg)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs[SHARED_ARENA]
    arena = slab.cache.cached_rows
    log(f"train init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x {spec.dim} "
        f"fp32 = {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; int8 arena "
        f"{arena.capacity} slots = {arena.head_capacity} fp32 head + "
        f"{arena.capacity - arena.head_capacity} int8 tail: device_bytes {arena.device_bytes()} "
        f"vs fp32_equiv_bytes {arena.fp32_equiv_bytes()} "
        f"({arena.fp32_equiv_bytes() / arena.device_bytes()}x); collection device_bytes "
        f"{json.dumps(coll.device_bytes())}; host RSS {rss_gb()} GB")

    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    # warm-up, measured, breakdown (3), profiled, census
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + 6)]

    def dev_batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}

    state, m = model.train_step(state, dev_batch(n_steps + 4))  # allocator, cuBLAS, autograd
    float(m["loss"])
    b = dev_batch(n_steps + 5)  # uploaded before the census: the caller's copy

    def census_step():
        st, m = model.train_step(state, b)
        float(m["loss"])
        return st, m

    state, m = census_call("5 (int8-tiered DLRM train step, its loss fetched)", census_step)
    counters = ("cache_evictions", "cache_misses", "uniq_overflows", "slab_hits",
                "slab_tier_promotions", "slab_tier_demotions", "host_moved_rows")
    prev = fetch_ints({k: m[k] for k in counters})

    captured = []
    impl = ops.arena_gather_impl

    def capture(head, tail, sideband, slots, codec):  # the first writeback's arguments
        if not captured:
            captured.append(tuple(None if x is None else x.clone()
                                  for x in (head, tail, sideband, slots)))
        return impl(head, tail, sideband, slots, codec)

    # --- the main path: counts at 0, n_steps train steps, the two bag steps
    # (sum, mean) and the flush, counts read
    ops.arena_gather_impl = capture
    kernel.victim_threshold.launches = 0
    kernel.gather_decode.launches = kernel.gather_decode.fused_launches = 0
    eb_kernel.embedding_bag_multi.launches = 0
    try:
        step_ms, losses, per_step = [], [], []
        for i in range(n_steps):
            b = dev_batch(i)
            t0 = time.perf_counter()
            state, m = model.train_step(state, b)
            losses.append(float(m["loss"]))  # the step's one sync
            step_ms.append(1e3 * (time.perf_counter() - t0))
            cur = fetch_ints({k: m[k] for k in counters})
            per_step.append({k: (cur[k] - prev[k]) if not isinstance(cur[k], dict) else
                             sum(cur[k].values()) - sum(prev[k].values()) for k in counters})
            per_step[-1]["hit_rate"] = float(m["hit_rate"])
            prev = cur
        bag_rng = np.random.default_rng(2)
        gen = torch.Generator(device=dev).manual_seed(2)
        bags = []
        for j, combiner in enumerate(("sum", "mean")):
            fb = bag_batch(model, dev, j, bag_rng)
            t0 = time.perf_counter()
            state, info = bag_step(model, state, fb, combiner, gen)
            torch.cuda.synchronize()
            info["ms"] = 1e3 * (time.perf_counter() - t0)
            m = coll.metrics(state["emb"])
            cur = fetch_ints({k: m[k] for k in counters})
            per_step.append({k: (cur[k] - prev[k]) if not isinstance(cur[k], dict) else
                             sum(cur[k].values()) - sum(prev[k].values()) for k in counters})
            per_step[-1]["hit_rate"] = float(m["hit_rate"])
            prev = cur
            bags.append(info)
        ops.arena_gather_impl = impl  # the flush's gathers are not captured
        resident = int((state["emb"].slabs[SHARED_ARENA].cache.slot_to_row >= 0).sum())
        t0 = time.perf_counter()
        state = model.flush(state)
        torch.cuda.synchronize()
        flush_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        ops.arena_gather_impl = impl
    thr_launches = kernel.victim_threshold.launches
    gd_launches = kernel.gather_decode.launches
    eb_launches = eb_kernel.embedding_bag_multi.launches

    rows_per_round = min(spec.cache_config().buffer_rows,
                         min(spec.unique_size(cfg.batch_size * cfg.n_sparse), spec.capacity))
    wb_rounds = sum(-(-p["cache_evictions"] // rows_per_round) for p in per_step)
    flush_rounds = -(-resident // min(spec.cache_config().buffer_rows, spec.capacity))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(p["uniq_overflows"] for p in per_step):
        raise AssertionError(f"unique-buffer overflow: {per_step}")
    if thr_launches != n_steps + len(bags):
        raise AssertionError(f"victim_threshold launched {thr_launches} times for "
                             f"{n_steps + len(bags)} plans")
    if eb_launches != len(bags):
        raise AssertionError(f"embedding_bag: {eb_launches} launches in {len(bags)} bag steps "
                             f"of {cfg.n_sparse} bag features (want one a step)")
    if gd_launches != wb_rounds + flush_rounds or not gd_launches:
        raise AssertionError(f"gather_decode launched {gd_launches} times; the plans imply "
                             f"{wb_rounds} writeback rounds + {flush_rounds} flush rounds")
    if kernel.gather_decode.fused_launches:  # an fp32 host tier takes the fp32 rows
        raise AssertionError(f"gather_decode_encode launched "
                             f"{kernel.gather_decode.fused_launches} times into an fp32 host")
    if not captured:
        raise AssertionError("no live writeback went through arena_gather_impl")
    live_err = check_gather_decode(captured[0], "int8", "live writeback")
    wb_slots = captured[0][3]
    log(f"train: {n_steps} steps of {cfg.batch_size}; losses {losses}; step ms {step_ms}; "
        f"p50 {np.percentile(step_ms, 50)} ms, p99 {np.percentile(step_ms, 99)} ms "
        f"(numpy percentiles of {n_steps} samples); flush {flush_ms} ms")
    log(f"train per step, the last {len(bags)} the bag steps (evictions, misses, hits, tier "
        f"promotions / demotions, host rows moved, hit rate): {json.dumps(per_step)}")
    log(f"bag steps ({BAGS} bags of <= {BAG_LANES} lanes x {cfg.n_sparse} features, sum then "
        f"mean; prepare with writeback, pool through the kernel, autograd, apply_grads, and "
        f"the plain-route check): ms {[b['ms'] for b in bags]}; embedding_bag launches "
        f"{eb_launches} ({[b['launches'] for b in bags]} per step: one for the slab's "
        f"{cfg.n_sparse} features); pooled output bitwise "
        f"the per-feature plain version of the live call; kernel route = plain route "
        f"within 1e-5: max |diff| pooled {[b['err'] for b in bags]}, gradient |diff| / (sum "
        f"of magnitudes + 1) {[b['grad_err'] for b in bags]}; their write-back rounds are in "
        f"the gather_decode count below")
    moved = sum(p["host_moved_rows"] for p in per_step)
    log(f"train totals: host wire bytes {moved * slab.full.row_wire_bytes()} "
        f"({moved} rows x {slab.full.row_wire_bytes()} B), threshold launches {thr_launches} "
        f"(1 per plan), gather_decode launches {gd_launches} = {wb_rounds} writeback rounds "
        f"+ {flush_rounds} flush rounds of <= {rows_per_round} lanes; live writeback "
        f"[{wb_slots.numel()} lanes, {int((wb_slots < arena.head_capacity).sum())} head] "
        f"kernel bitwise = plain; host RSS {rss_gb()} GB")

    # --- after the flush: every resident slot of the torch-decoded arena ==
    # its host row (the kernel wrote them), bitwise
    check_resident(coll.weights(state["emb"])[SHARED_ARENA],
                   state["emb"].slabs[SHARED_ARENA].cache.slot_to_row, slab.full,
                   "DLRM train (int8 arena)")

    # --- stage by stage with syncs, three steps: where the time goes --------
    grads_ms = []
    apply_grads = coll.apply_grads

    def timed_apply_grads(*a, **k):
        out, ms = sync_ms(lambda: apply_grads(*a, **k))
        grads_ms.append(ms)
        return out

    coll.apply_grads = timed_apply_grads
    try:
        for i in range(n_steps, n_steps + 3):
            b = dev_batch(i)
            plan, t_plan = sync_ms(lambda: model.plan_step(state, b))
            state, t_apply = sync_ms(lambda: model.apply_step(state, plan))
            (state, m), t_compute = sync_ms(lambda: model.compute_step(state, b, plan.addresses))
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"non-finite loss {float(m['loss'])} at step {i}")
            log(f"train breakdown ms (synced, step {i}): plan_prepare {t_plan}, apply_plan "
                f"(writeback + load) {t_apply}, fwd+bwd+dense SGD {t_compute - grads_ms[-1]}, "
                f"apply_grads (decode, SGD, re-encode) {grads_ms[-1]}")
    finally:
        del coll.apply_grads
    mem = torch.cuda.memory_stats()
    log(f"card memory after the breakdown: peak allocated {mem['allocated_bytes.all.peak'] / 1e9} "
        f"GB, reserved {mem['reserved_bytes.all.current'] / 1e9} GB, allocator retries "
        f"{mem['num_alloc_retries']}, cudaFree calls {mem.get('num_device_free', 'n/a')}")
    b = dev_batch(n_steps + 3)
    profile_call("one train step", lambda: model.train_step(state, b))
    return {"launches": gd_launches, "thr_launches": thr_launches, "captured": captured[0],
            "live_err": live_err, "arena": state["emb"].slabs[SHARED_ARENA].cache.cached_rows,
            "full": slab.full, "bag_launches": eb_launches, "bag_live": bags[0]["live"],
            "bag_multi": bags[0]["multi"]}


FUSED_EVENT_ITERS = 200  # back-to-back calls a CUDA-event time of rows 2 and 3


EMPTY_SOURCE = Path(ROOT) / "scripts" / "empty_launch.cu"  # the floor's empty kernel


def time_launch_floor():
    """The floor of a launch through the port's binding: an empty kernel
    (one pointer argument, nothing allocated) launched by ``build.Kernel``,
    the wrappers' lean path; its host enqueue and back-to-back event ms,
    and the call itself (``host_ms``'s ``against``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_ops import kernel

    empty = build.Kernel(EMPTY_SOURCE, "empty_launch", 1)
    x = torch.empty((1,), device="cuda")
    ptr, card = x.data_ptr(), x.get_device()

    def call():
        empty(card, ptr)

    r = {"host_enqueue_ms": host_ms(call), "ms": cuda_ms(call, iters=FUSED_EVENT_ITERS)}
    log(f"launch floor (an empty kernel through build.Kernel): host enqueue "
        f"{r['host_enqueue_ms']} ms, event-timed {r['ms']} ms a launch back to back")
    return r, call


def _gd_bytes(head, tail, side, slots, out_row_bytes=None):
    """Bytes the gather-decode must move for these slots: each slot read,
    each lane's head row or tail payload (+ sideband) read, each output row
    written (fp32, or ``out_row_bytes`` a row; out-of-range lanes read no
    row)."""
    h, d = head.shape
    t = tail.shape[0]
    n_head = int(((slots >= 0) & (slots < h)).sum())
    n_tail = int(((slots >= h) & (slots < h + t)).sum())
    tail_row = d * tail.element_size() + (0 if side is None else 2 * side.element_size())
    k = slots.numel()
    out_row = d * 4 if out_row_bytes is None else out_row_bytes
    return k * 4 + n_head * d * head.element_size() + n_tail * tail_row + k * out_row


def _enqueue(fn, floor):
    """``fn``'s host enqueue ms and, with the floor's call, the floor's ms
    read in alternating windows beside it (None without)."""
    if floor is None:
        return host_ms(fn, windows=9), None
    return host_ms(fn, windows=9, against=floor)


def time_gather_decode(live, tiers, max_err, launches, floor=None):
    """Times the kernel and its plain version by CUDA events and profiler
    device time, and the wrapper's host enqueue, on the live writeback's
    arguments (the main path's call), on one all-tail flush-size round and
    on a whole-arena gather of the trained arena (``tiers``: its fp32 head,
    int8 tail and sideband).  ``floor``, the launch floor's call, is read in
    windows alternating with the enqueue's."""
    from repro_torch.kernels.cache_ops import kernel

    args = tuple(tiers)
    h, t = args[0].shape[0], args[1].shape[0]
    dev = args[0].device
    g = torch.Generator(device=dev).manual_seed(1)
    k = min(PAPER_K, t)
    tail_round = h + torch.randperm(t, generator=g, device=dev)[:k].to(torch.int32)
    whole = torch.arange(h + t, dtype=torch.int32, device=dev)
    out = {}
    for what, inp in (("live writeback", live),
                      ("all-tail round", args + (tail_round,)),
                      ("whole arena", args + (whole,))):
        check_gather_decode(inp, "int8", what)
        calls = {"kernel": lambda inp=inp: kernel.gather_decode(*inp, "int8"),
                 "plain": lambda inp=inp: kernel.gather_decode_plain(*inp, "int8")}
        enqueue, floor_ms = _enqueue(calls["kernel"], floor)  # before any profiler window
        ev = {"kernel": cuda_ms(calls["kernel"], iters=FUSED_EVENT_ITERS),
              "plain": cuda_ms(calls["plain"])}
        dv = {n: device_ms(fn)[0] for n, fn in calls.items()}
        n_bytes = _gd_bytes(*inp)
        r = {"lanes": inp[3].numel(), "ms": ev["kernel"], "plain_ms": ev["plain"],
             "device_ms": dv["kernel"], "plain_device_ms": dv["plain"],
             "host_enqueue_ms": enqueue, "floor_enqueue_ms": floor_ms, "bytes": n_bytes,
             "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
             "enqueue_over_floor_ms": None if floor_ms is None else enqueue - floor_ms}
        out[what] = r
        log(f"gather_decode on the {what} [{r['lanes']} lanes]: event-timed ms kernel "
            f"{r['ms']}, plain {r['plain_ms']}; device ms kernel {r['device_ms']}, plain "
            f"{r['plain_device_ms']}; host enqueue {r['host_enqueue_ms']} ms (the launch floor "
            f"{floor_ms} ms in alternating windows: {r['enqueue_over_floor_ms']} ms over it); "
            f"bound {r['bound_ms']} ms ({n_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s)")
    live_r = out["live writeback"]
    return {
        "name": "gather_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/gather_decode.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:178",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": live_r["ms"],
        "plain_ms": live_r["plain_ms"],
        "bound_ms": live_r["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call gathers and decodes a tiered arena
        "device_ms": live_r["device_ms"],
        "plain_device_ms": live_r["plain_device_ms"],
        "host_enqueue_ms": live_r["host_enqueue_ms"],
        "floor_enqueue_ms": live_r["floor_enqueue_ms"],
        "enqueue_over_floor_ms": live_r["enqueue_over_floor_ms"],
        "lanes": live_r["lanes"],
        "all_tail_round": out["all-tail round"],
        "whole_arena": out["whole arena"],
    }


def _encode_composition(head, tail, sideband, slots, codec, host_codec):
    """What one gather_decode_encode launch replaced: the gather-decode
    kernel's fp32 rows, then the host codec's eager encode."""
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.store.codec import get_codec

    return get_codec(host_codec).encode(kernel.gather_decode(head, tail, sideband, slots, codec))


def _writeback_round_ops(live):
    """Device ops of one profiled write-back round into an int8 host tier on
    the live write-back's lanes: ``transmitter.move_rows`` from the live
    arena tiers into a pinned int8 host store of as many rows, through the
    fused entry and with the composition it replaced patched in."""
    from repro_torch.core import transmitter
    from repro_torch.kernels.cache_ops import ops
    from repro_torch.store.arena import ArenaStore
    from repro_torch.store.host_store import HostStore

    head, tail, side, slots, codec, host_codec = live
    k, d = slots.numel(), head.shape[1]
    arena = ArenaStore(head={"weight": head}, tail={"weight": tail},
                       sideband={} if side is None else {"weight": side}, raw={}, codec=codec)
    host = HostStore.create({"weight": torch.zeros((k, d))}, host_codec, pin=head.is_cuda)
    dst = torch.arange(k, dtype=torch.int32, device=head.device)
    active = torch.ones((k,), dtype=torch.bool, device=head.device)
    impl, out = ops.arena_gather_encode_impl, {}
    try:
        for name, fn in (("fused", impl), ("composition", _encode_composition)):
            ops.arena_gather_encode_impl = fn
            try:
                out[name] = device_ops(lambda: transmitter.move_rows(
                    arena, host, slots, dst, active, buffer_rows=k), iters=1)
            finally:
                ops.arena_gather_encode_impl = impl
    finally:
        host.close()
    return out


def time_gather_decode_encode(live, max_err, launches, floor=None):
    """The fused gather + decode + host encode on the first live int8
    write-back (phase 5c's): CUDA-event, profiler device and host enqueue
    ms of the kernel, one device op a call, its bound, and in the same
    process the composition it replaced (the gather-decode kernel, then
    ``Int8Codec.encode``) with its device ops, and its plain version; then
    the device ops of one profiled write-back round both ways.  ``floor``
    as in :func:`time_gather_decode`."""
    from repro_torch.kernels.cache_ops import kernel

    args, (codec, host) = live[:4], live[4:]
    check_gather_decode_encode(args, codec, host, "the live int8 write-back")
    calls = {"kernel": lambda: kernel.gather_decode_encode(*args, codec, host),
             "composition": lambda: _encode_composition(*args, codec, host),
             "plain": lambda: kernel.gather_decode_encode_plain(*args, codec, host)}
    enq, floor_ms = _enqueue(calls["kernel"], floor)  # before any profiler window
    enq = {"kernel": enq, "composition": host_ms(calls["composition"])}
    ev = {n: cuda_ms(fn, iters=FUSED_EVENT_ITERS if n == "kernel" else 20)
          for n, fn in calls.items()}
    dv = {n: device_ms(fn)[0] for n, fn in calls.items() if n != "plain"}
    ops_k, by_k = device_ops(calls["kernel"])
    ops_c, by_c = device_ops(calls["composition"])
    if ops_k is not None and (ops_k != 1 or any("emset" in op or "elementwise" in op.lower()
                                                for op in by_k)):
        raise AssertionError(f"gather_decode_encode: device ops {by_k}, want one kernel")
    d = args[0].shape[1]
    out_row = d * (1 if host == "int8" else 2) + (8 if host == "int8" else 0)
    n_bytes = _gd_bytes(*args, out_row_bytes=out_row)
    bound = 1e3 * n_bytes / HBM_BYTES_PER_S
    rnd = _writeback_round_ops(live)
    (rf, rbf), (rc, rbc) = rnd["fused"], rnd["composition"]
    log(f"gather_decode_encode ({codec} tail -> {host} host) on the live write-back "
        f"[{args[3].numel()} lanes]: event-timed ms kernel {ev['kernel']}, composition "
        f"(gather_decode + encode) {ev['composition']}, plain {ev['plain']}; device ms kernel "
        f"{dv['kernel']}, composition {dv['composition']}; host enqueue kernel {enq['kernel']} "
        f"ms (the launch floor {floor_ms} ms in alternating windows), composition "
        f"{enq['composition']} ms; device ops a call kernel {ops_k} ({json.dumps(by_k)}), "
        f"composition {ops_c} ({json.dumps(by_c)}); bound {bound} ms ({n_bytes} B at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s: slots, rows read, {out_row} B host rows written)")
    log(f"one profiled int8 write-back round ({args[3].numel()} lanes, move_rows into a pinned "
        f"int8 host store): {rf} device ops fused, {rc} with the composition (1 encoded leaf: "
        f"{None if rf is None else rc - rf} fewer); by op fused {json.dumps(rbf)}, composition "
        f"{json.dumps(rbc)}")
    if rf is not None and rc - rf < 12:
        raise AssertionError(f"int8 write-back round: {rc - rf} fewer device ops, want >= 12")
    return {
        "name": "gather_decode_encode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/gather_decode.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:178",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max_err,
        "ms": ev["kernel"],
        "plain_ms": ev["plain"],
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call gathers, decodes and encodes
        "device_ms": dv["kernel"],
        "host_enqueue_ms": enq["kernel"],
        "floor_enqueue_ms": floor_ms,
        "enqueue_over_floor_ms": None if floor_ms is None else enq["kernel"] - floor_ms,
        "device_ops": ops_k,
        "composition": {"ms": ev["composition"], "device_ms": dv["composition"],
                        "host_enqueue_ms": enq["composition"], "device_ops": ops_c},
        "writeback_round_ops": {"fused": rf, "composition": rc},
        "lanes": args[3].numel(),
        "bytes": n_bytes,
    }


# ---------------------------------------------------------------------------
# phase 3c: the FM-interaction and embedding-bag kernels vs their plain versions
# ---------------------------------------------------------------------------

FM_RTOL = 1e-3  # the reference's FM sweep: rtol 1e-3, atol 1e-5 * (max|ref| + 1)
BF16_ULP = 2**-7  # one bf16 rounding of the output, either way: relative <= 2^-7
BAG_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}  # the reference's bag sweep


def check_fm(v, what):
    """The FM kernel against its plain version on one input, at the
    reference's sweep tolerance (bf16: plus one output rounding); returns
    max_abs_err."""
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel

    got = fm_kernel.fm_interaction(v)
    want = fm_kernel.fm_interaction_plain(v)
    if got.dtype != v.dtype or got.shape != (v.shape[0],):
        raise AssertionError(f"fm_interaction {what}: got {got.dtype} {tuple(got.shape)}")
    scale = float(want.float().abs().max()) + 1.0
    rtol = FM_RTOL + (BF16_ULP if v.dtype == torch.bfloat16 else 0.0)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=1e-5 * scale):
        raise AssertionError(f"fm_interaction {what}: kernel != plain (max |diff| {err}, "
                             f"rtol {rtol}, atol {1e-5 * scale})")
    return err


def fm_kernel_phase(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    shapes = [(64, 39, 10), (1000, 26, 16), (128, 8, 128), (1, 4, 4), (4097, 40, 10),
              (65536, 40, 10)]  # test_kernels.py's, a B that fits no block, FM's
    for b, f, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for strided in (False, True):  # strided: the [..., :D] view of [B, F, D+1]
                v = torch.randn((b, f, d + 1), generator=g, device=dev).to(dtype)
                v = v[..., :d] if strided else v[..., :d].contiguous()
                errs[dtype] = max(errs[dtype], check_fm(v, f"{(b, f, d)} {dtype} "
                                                           f"strided={strided}"))
                cases += 1
    log(f"fm_interaction phase: {cases} cases within rtol {FM_RTOL} / atol 1e-5*(max|ref|+1) "
        f"(bf16 rtol + {BF16_ULP}); max_abs_err fp32 {errs[torch.float32]}, bf16 "
        f"{errs[torch.bfloat16]}; shapes {shapes}, fp32 and bf16, contiguous and strided")
    return errs[torch.float32]


def check_bag(args, what):
    """The embedding-bag kernel against its plain version on one input,
    within the reference's sweep tolerance; returns (max_abs_err, bitwise)."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel

    got = eb_kernel.embedding_bag(*args)
    want = eb_kernel.embedding_bag_plain(*args)
    tol = BAG_TOL[args[0].dtype]
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if got.dtype != want.dtype or not torch.allclose(got.float(), want.float(), rtol=tol,
                                                     atol=tol):
        raise AssertionError(f"embedding_bag {what}: kernel != plain (max |diff| {err}, "
                             f"tol {tol})")
    return err, bool(torch.equal(got, want))


def _bag_case(rng, dev, v, d, n, s, dtype, max_bag=None, id_lo=-1):
    seg = np.sort(rng.integers(0, s, n)).astype(np.int32)
    ids = rng.integers(id_lo, v, n).astype(np.int32)
    if max_bag is None:  # the reference sweep's: the longest bag
        max_bag = int(np.bincount(seg, minlength=s).max())
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dev, dtype)
    return (table, torch.from_numpy(ids).to(dev), torch.from_numpy(seg).to(dev), s, max_bag)


def bag_kernel_phase(dev):
    rng = np.random.default_rng(0)
    cases, errs, bitwise = [], {torch.float32: 0.0, torch.bfloat16: 0.0}, True
    for v, d, n, s in ((64, 512, 40, 10), (128, 1024, 100, 7), (32, 256, 16, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((f"sweep {(v, d, n, s)}", _bag_case(rng, dev, v, d, n, s, dtype)))
    for dtype in (torch.float32, torch.bfloat16):
        # bags longer than max_bag, empty segments, -1/-2 lanes, D % 4 != 0
        cases.append(("truncated", _bag_case(rng, dev, 500, 64, 4000, 300, dtype, max_bag=3,
                                             id_lo=-2)))
        cases.append(("empty bags", _bag_case(rng, dev, 500, 32, 50, 400, dtype, max_bag=0)))
        cases.append(("D=37", _bag_case(rng, dev, 300, 37, 200, 90, dtype, max_bag=2)))
    cases.append(("path (b) shape", _bag_case(rng, dev, 506_438, 128, 16384, 4096,
                                              torch.float32, max_bag=4)))
    n = 0
    for what, (table, ids, seg, s, mb) in cases:
        for combiner in ("sum", "mean"):
            err, same = check_bag((table, ids, seg, s, combiner, mb), f"{what} {combiner}")
            errs[table.dtype] = max(errs[table.dtype], err)
            bitwise &= same
            check_bag_multi((table, *_multi_case(ids, seg, s), s, combiner, mb),
                            f"{what} {combiner}")
            n += 1
    log(f"embedding_bag phase: {n} cases within fp32 1e-5 / bf16 3e-2 (the reference sweep's); "
        f"max_abs_err fp32 {errs[torch.float32]}, bf16 {errs[torch.bfloat16]}; bitwise equal "
        f"on every case: {bitwise}; the many-feature call (each case's lanes, its first "
        f"half, itself with -1 and S lanes added, an empty feature: one launch) bitwise the "
        f"per-feature plain version on every case")
    return errs[torch.float32]


def _multi_case(ids, seg, s):
    """One case's lanes as four features of unequal lane counts for the
    many-feature call: all lanes, the first half, all lanes with a -1 lane
    before and an S lane after them (lanes in no bag), and an empty feature;
    returns (ids, seg, lane_offsets)."""
    n = ids.numel()
    edge = lambda v: torch.full((1,), v, dtype=torch.int32, device=ids.device)
    feats = [(ids, seg), (ids[:n // 2], seg[:n // 2]),
             (torch.cat([ids[:1], ids, ids[:1]]), torch.cat([edge(-1), seg, edge(s)])),
             (ids[:0], seg[:0])]
    offsets = [0]
    for i, _ in feats:
        offsets.append(offsets[-1] + i.numel())
    return (torch.cat([i for i, _ in feats]).contiguous(),
            torch.cat([g for _, g in feats]).contiguous(), offsets)


def check_bag_multi(args, what):
    """The many-feature call (one launch) against its plain version (the
    plain version per feature, stacked), bitwise."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel

    before = eb_kernel.embedding_bag_multi.launches
    got = eb_kernel.embedding_bag_multi(*args)
    launches = eb_kernel.embedding_bag_multi.launches - before
    want = eb_kernel.embedding_bag_multi_plain(*args)
    if launches != 1 or got.dtype != want.dtype or not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        raise AssertionError(f"embedding_bag_multi {what}: {launches} launches, kernel != plain "
                             f"(max |diff| {err})")


def time_fm(v, max_err, launches):
    """The FM kernel and its plain version on the live serve batch's v."""
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel

    calls = {"kernel": lambda: fm_kernel.fm_interaction(v),
             "plain": lambda: fm_kernel.fm_interaction_plain(v)}
    ev = {n: cuda_ms(fn) for n, fn in calls.items()}
    dv = {n: device_ms(fn)[0] for n, fn in calls.items()}
    enqueue = host_ms(calls["kernel"])
    b, f, d = v.shape
    n_bytes = b * f * d * v.element_size() + b * v.element_size()  # v read once, out written
    n_ops = 3 * b * f * d + 3 * b * d  # s += x, sq += x*x; s*s - sq summed over d
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / FP32_OPS_PER_S
    log(f"fm_interaction on the live serve batch v {tuple(v.shape)} strides {v.stride()} "
        f"{v.dtype}: event-timed ms kernel {ev['kernel']}, plain {ev['plain']}; device ms "
        f"kernel {dv['kernel']}, plain {dv['plain']}; host enqueue {enqueue} ms; bound "
        f"{max(bytes_ms, ops_ms)} ms ({n_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s: {bytes_ms} "
        f"ms; {n_ops} fp32 ops at {FP32_OPS_PER_S / 1e12} TFLOP/s: {ops_ms} ms)")
    return {
        "name": "fm_interaction",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fm_interaction/csrc/fm_interaction.cu",
        "replaces": "src/repro/kernels/fm_interaction/kernel.py:24",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ev["kernel"],
        "plain_ms": ev["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the FM interaction
        "device_ms": dv["kernel"],
        "plain_device_ms": dv["plain"],
        "host_enqueue_ms": enqueue,
    }


def time_bag(feature, args):
    """The embedding-bag kernel called for one feature, its plain version
    and F.embedding_bag (on the same bags with the -1 lanes compacted away)
    on one live feature of a bag step."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel

    table, ids, seg, s, combiner, mb = args
    lib_ids, offsets, n_rows = _library_bags(ids, seg, (0, ids.numel()), s, mb)
    if bool((lib_ids >= table.shape[0]).any()):
        raise AssertionError("a live bag lane addresses a slot past the arena")
    lib = lambda: torch.nn.functional.embedding_bag(lib_ids, table, offsets, mode=combiner)
    if not torch.allclose(lib(), eb_kernel.embedding_bag(*args), rtol=1e-5, atol=1e-5):
        raise AssertionError("F.embedding_bag disagrees with the kernel on the live bags")
    calls = {"kernel": lambda: eb_kernel.embedding_bag(*args),
             "plain": lambda: eb_kernel.embedding_bag_plain(*args), "library": lib}
    ev = {n: cuda_ms(fn) for n, fn in calls.items()}
    dv = {n: device_ms(fn)[0] for n, fn in calls.items()}
    enqueue = host_ms(calls["kernel"])
    n_distinct = int(torch.unique(lib_ids).numel())
    d = table.shape[1]
    item = table.element_size()
    # each distinct kept row read once (a repeat comes from L2), the ids and
    # segment ids read once, the output written once
    n_bytes = n_distinct * d * item + ids.numel() * 8 + s * d * item
    n_ops = n_rows * d + (s * d if combiner == "mean" else 0)
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / FP32_OPS_PER_S
    log(f"embedding_bag on live bag feature {feature} ({ids.numel()} lanes, {n_rows} kept of "
        f"{n_distinct} distinct rows, {s} bags, D {d}, {combiner}): event-timed ms kernel "
        f"{ev['kernel']}, plain {ev['plain']}, F.embedding_bag {ev['library']}; device ms kernel {dv['kernel']}, plain "
        f"{dv['plain']}, F.embedding_bag {dv['library']}; host enqueue {enqueue} ms; bound "
        f"{max(bytes_ms, ops_ms)} ms ({n_bytes} B: {bytes_ms} ms; {n_ops} ops: {ops_ms} ms)")


def _library_bags(ids, seg, offsets, s, mb):
    """The kept lanes of F features' bags as ``F.embedding_bag`` takes them:
    the -1 lanes and the lanes past ``max_bag`` compacted away, one offset
    per (feature, bag); built once, outside any timing."""
    from repro_torch.core.lanes import segment_sum, take_fill
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel

    lib_ids, counts = [], []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        i, g = ids[lo:hi], seg[lo:hi]
        pos = torch.arange(i.numel(), device=i.device) - take_fill(eb_kernel.bag_starts(g, s), g, 0)
        kept = (i >= 0) & (pos < mb) & (g >= 0) & (g < s)
        lib_ids.append(i[kept].to(torch.int64))
        counts.append(segment_sum(kept.to(torch.int64), g, s))
    counts = torch.cat(counts)
    return torch.cat(lib_ids), torch.cumsum(counts, 0) - counts, int(counts.sum())


def time_bag_multi(args, max_err, launches):
    """The many-feature call over a live bag step's 26 features (the main
    path's one launch), its plain version, and one ``F.embedding_bag`` call
    over the same bags; the ``kernels`` line's row for the bag kernel."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel

    table, ids, seg, offsets, s, combiner, mb = args
    n_feat = len(offsets) - 1
    lib_ids, lib_off, n_rows = _library_bags(ids, seg, offsets, s, mb)
    if bool((lib_ids >= table.shape[0]).any()):
        raise AssertionError("a live bag lane addresses a slot past the arena")
    lib = lambda: torch.nn.functional.embedding_bag(lib_ids, table, lib_off, mode=combiner)
    fused = eb_kernel.embedding_bag_multi(*args)
    if not torch.allclose(lib().reshape(fused.shape), fused, rtol=1e-5, atol=1e-5):
        raise AssertionError("F.embedding_bag disagrees with the many-feature kernel")
    calls = {"kernel": lambda: eb_kernel.embedding_bag_multi(*args),
             "plain": lambda: eb_kernel.embedding_bag_multi_plain(*args), "library": lib}
    ev = {n: cuda_ms(fn) for n, fn in calls.items()}
    dv, by_op = {}, {}
    for n, fn in calls.items():
        dv[n], by_op[n] = device_ms(fn)
    enqueue = host_ms(calls["kernel"])
    n_distinct = int(torch.unique(lib_ids).numel())
    d, item = table.shape[1], table.element_size()
    # each distinct kept row read once (a repeat comes from L2), the ids and
    # segment ids read once, the [F, S, D] output written once
    n_bytes = n_distinct * d * item + ids.numel() * 8 + n_feat * s * d * item
    n_ops = n_rows * d + (n_feat * s * d if combiner == "mean" else 0)
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / FP32_OPS_PER_S
    log(f"embedding_bag_multi on the live bag step ({n_feat} features, {ids.numel()} lanes, "
        f"{n_rows} kept of {n_distinct} distinct rows, {n_feat * s} bags, D {d}, {combiner}): "
        f"event-timed ms kernel {ev['kernel']}, plain {ev['plain']}, F.embedding_bag "
        f"{ev['library']} (one call over the same bags); device ms kernel {dv['kernel']}, "
        f"plain {dv['plain']}, F.embedding_bag {dv['library']}; host enqueue {enqueue} ms; "
        f"bound {max(bytes_ms, ops_ms)} ms ({n_bytes} B: {bytes_ms} ms; {n_ops} ops: {ops_ms} "
        f"ms); kernel device ms by op {json.dumps(by_op['kernel'])}")
    return {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:36",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ev["kernel"],
        "plain_ms": ev["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ev["library"],
        "device_ms": dv["kernel"],
        "plain_device_ms": dv["plain"],
        "library_device_ms": dv["library"],
        "host_enqueue_ms": enqueue,
        "features": n_feat,
        "lanes": ids.numel(),
        "kept_rows": n_rows,
        "distinct_rows": n_distinct,
    }


def time_bag_routes(args):
    """Host ms of a bag step's kernel route, forward plus backward, with the
    step's loss ``sum_f <pooled_f, g_f>``: one single-feature op per feature
    against the one many-feature op that ``pool`` makes, in host enqueue
    time and CUDA-event time, in the same run."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    table, ids, seg, offsets, s, combiner, mb = args
    n_feat = len(offsets) - 1
    gen = torch.Generator(device=table.device).manual_seed(5)
    g = torch.randn((n_feat, s, table.shape[1]), generator=gen, device=table.device) / s

    def fused():
        w = table.detach().requires_grad_()
        pooled = torch.unbind(eb_ops.embedding_bag_multi(w, ids, seg, offsets, s, combiner, mb))
        return torch.autograd.grad(sum(torch.sum(p * g[f]) for f, p in enumerate(pooled)), [w])

    def single():
        w = table.detach().requires_grad_()
        pooled = [eb_ops.embedding_bag(w, ids[lo:hi], seg[lo:hi], s, combiner, mb)
                  for lo, hi in zip(offsets[:-1], offsets[1:])]
        return torch.autograd.grad(sum(torch.sum(p * g[f]) for f, p in enumerate(pooled)), [w])

    calls = {"fused": fused, "single": single}
    host = {n: host_ms(fn) for n, fn in calls.items()}
    ev = {n: cuda_ms(fn, iters=10) for n, fn in calls.items()}
    log(f"bag step kernel route, forward + backward ({n_feat} features): host enqueue ms fused "
        f"{host['fused']} vs {n_feat} single calls {host['single']} (saves "
        f"{host['single'] - host['fused']} ms); event ms fused {ev['fused']} vs single "
        f"{ev['single']}")
    return {"host_ms": host, "event_ms": ev}


# ---------------------------------------------------------------------------
# phase 5b: bag pooling through the cache (inside the DLRM training run)
# ---------------------------------------------------------------------------

BAGS, BAG_LANES = 4096, 4  # 16384 lanes per field per step, as the DLRM's batch


def bag_batch(model, dev, step, rng):
    """A ``synth.sparse_batch`` of 16384 rows regrouped per field into 4096
    bags of 4 lanes, each bag 1-4 lanes long (the rest -1)."""
    from repro_torch.core.collection import FeatureBatch
    from repro_torch.data import synth

    cfg = model.cfg
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    sparse = synth.sparse_batch(spec, BAGS * BAG_LANES, 2, step)["sparse"]
    seg = torch.arange(BAGS, dtype=torch.int32, device=dev).repeat_interleave(BAG_LANES)
    bags = {}
    for j, name in enumerate(model.feature_names):
        ids = sparse[:, j].reshape(BAGS, BAG_LANES).copy()
        length = rng.integers(1, BAG_LANES + 1, size=BAGS)
        ids[np.arange(BAG_LANES)[None, :] >= length[:, None]] = -1
        bags[name] = (torch.from_numpy(ids.reshape(-1)).to(dev), seg)
    return FeatureBatch.from_bags(bags, num_segments=BAGS)


def bag_step(model, state, fb, combiner, gen):
    """prepare (writeback on) -> decoded weights -> pool through the kernel
    -> loss = sum_f <pooled_f, g_f> -> autograd -> apply_grads.  Holds the
    pooled output and the gradient to the plain route (gather + segment
    sum) on the same weights and addresses, within 1e-5: the pooled output
    absolutely and relatively; the gradient relative to the sum of the
    magnitudes it adds up (a hot row sums thousands of lanes, and both
    routes' ``index_add_`` sum them with atomics, in no fixed order).
    Returns (state, info)."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel

    coll = model.collection
    emb, addr = coll.prepare(state["emb"], fb, writeback=True)
    base = coll.weights(emb)
    # a cotangent of the size a batch-mean loss gives each bag (O(1 / bags)):
    # SGD at the DLRM's lr 1.0 keeps the trained rows in range
    g = {f: torch.randn((BAGS, model.cfg.embed_dim), generator=gen, device=addr[f].device) / BAGS
         for f in fb.segments}

    def route(use_pallas, cot):
        w = {k: v.detach().requires_grad_() for k, v in base.items()}
        rows = {} if use_pallas else coll.gather(w, addr, fb)
        pooled = coll.pool(rows, fb, combiner, weights=w, addresses=addr,
                           use_pallas=use_pallas, max_bag=BAG_LANES)
        loss = sum(torch.sum(pooled[f] * cot[f]) for f in fb.segments)
        grads = torch.autograd.grad(loss, list(w.values()))
        return {f: x.detach() for f, x in pooled.items()}, dict(zip(w, grads))

    before = eb_kernel.embedding_bag_multi.launches
    pooled, grads = route(True, g)
    step_launches = eb_kernel.embedding_bag_multi.launches - before
    slabs = {coll.table_slab[coll.feature_to_table[f]][0] for f in fb.segments}
    if step_launches != len(slabs):
        raise AssertionError(f"embedding_bag: {step_launches} launches for {len(slabs)} slabs "
                             f"of {len(fb.segments)} bag features (want one a slab)")
    pooled_p, grads_p = route(False, g)
    # the gradient is linear in g: with |g| it is the sum of the magnitudes added
    _, magnitude = route(False, {f: x.abs() for f, x in g.items()})
    err_out = max(float((pooled[f] - pooled_p[f]).abs().max()) for f in fb.segments)
    err_grad = max(float(((grads[k] - grads_p[k]).abs() / (magnitude[k] + 1)).max())
                   for k in grads)
    bad = [f for f in fb.segments if not torch.allclose(pooled[f], pooled_p[f], rtol=1e-5,
                                                        atol=1e-5)]
    bad += [k for k in grads if err_grad > 1e-5]
    if bad:
        raise AssertionError(f"bag step ({combiner}): kernel route != plain route on {bad}: "
                             f"max |diff| pooled {err_out}, gradient relative to its summed "
                             f"magnitudes {err_grad}")
    # the kernel's live arguments: each slab's one many-feature call (as pool
    # builds it), then the first feature and the largest-vocab one alone
    vocab = dict(zip(model.feature_names, model.cfg.vocab_sizes))

    def slab_of(f):
        return coll.table_slab[coll.feature_to_table[f]][0]

    by_slab = {}
    for f in fb.segments:
        by_slab.setdefault(slab_of(f), []).append(f)
    multis = {}
    for sname, feats in by_slab.items():
        flat = [addr[f].reshape(-1) for f in feats]
        offsets = [0]
        for x in flat:
            offsets.append(offsets[-1] + x.numel())
        multis[sname] = (base[sname].detach(), torch.cat(flat),
                         torch.cat([fb.segments[f] for f in feats]), offsets, BAGS, combiner,
                         BAG_LANES)
        fused = torch.stack([pooled[f] for f in feats])
        if not torch.equal(fused, eb_kernel.embedding_bag_multi_plain(*multis[sname])):
            raise AssertionError(f"bag step ({combiner}): slab {sname}'s pooled output is not "
                                 f"bitwise the per-feature plain version of the live call")
    live = {f: (base[slab_of(f)].detach(), addr[f].reshape(-1), fb.segments[f], BAGS, combiner,
                BAG_LANES)
            for f in (model.feature_names[0], max(fb.segments, key=vocab.get))}
    emb = coll.apply_grads(emb, grads, model.cfg.lr)
    return dict(state, emb=emb), {"launches": step_launches, "err": err_out,
                                  "grad_err": err_grad, "live": live,
                                  "multi": next(iter(multis.values())), "slabs": len(multis)}


# ---------------------------------------------------------------------------
# phase 3d + 5b: the bucketize kernel, and the DLRM split over 4 shards
# ---------------------------------------------------------------------------

SHARDS, REP_K = 4, 2048  # the sharded phase: 4 shards, BENCH_PR7's replicated head


def check_bucketize(owner, local, s, what):
    """The bucketize kernel against its plain version, bitwise; returns
    max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel

    got = kernel.bucketize(owner, local, s)
    want = kernel.bucketize_plain(owner, local, s)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"bucketize {what}: kernel != plain")
    return 0


def check_route_bucketize(uniq, rank_owner, rank_local, rep_k, s, what):
    """The route + bucketize kernel against its plain version, by both
    entries: owner, local and the image, and the image alone (the sharded
    plan's call), bitwise; returns max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel

    got = kernel.route_bucketize(uniq, rank_owner, rank_local, rep_k, s)
    want = kernel.route_bucketize_plain(uniq, rank_owner, rank_local, rep_k, s)
    got += (kernel.route_image(uniq, rank_owner, rank_local, rep_k, s),)
    for g, w, part in zip(got, want + want[2:], ("owner", "local", "image", "image alone")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"route_bucketize {what}: kernel {part} != plain")
    return 0


def bucketize_kernel_phase(dev):
    from repro_torch.kernels.cache_ops.ops import PAD_RANK

    rng = np.random.default_rng(0)
    n = fused = 0
    n_rank = 1 << 20
    for s in (1, 2, 4, 8):
        for u in (0, 1, 3, 4097, 425_984):
            owner = torch.from_numpy(rng.integers(-2, s + 2, u).astype(np.int32)).to(dev)
            local = torch.from_numpy(rng.integers(-1, 1 << 23, u).astype(np.int32)).to(dev)
            check_bucketize(owner, local, s, f"S={s} U={u}")
            n += 1
        pad = torch.full((425_984,), -1, dtype=torch.int32, device=dev)
        check_bucketize(pad, pad, s, f"S={s} every lane padding")
        rep = torch.zeros_like(pad)
        check_bucketize(rep, pad, s, f"S={s} every lane replicated")
        n += 2
        r_owner = torch.from_numpy(rng.integers(0, s, n_rank).astype(np.int32)).to(dev)
        r_local = torch.from_numpy(rng.integers(-1, n_rank // s, n_rank).astype(np.int32)).to(dev)
        for rep_k in (0, 2048):
            for u in (0, 1, 3, 4097, 425_984):
                ranks = rng.integers(-2, n_rank + 2, u).astype(np.int32)
                ranks[rng.random(u) < 0.05] = PAD_RANK
                uniq = torch.from_numpy(ranks).to(dev)
                check_route_bucketize(uniq, r_owner, r_local, rep_k, s,
                                      f"S={s} U={u} rep_k={rep_k}")
                # a view one lane in: uniq off its 16 B boundary (scalar loads)
                check_route_bucketize(torch.cat([uniq[:1], uniq])[1:], r_owner, r_local, rep_k,
                                      s, f"S={s} U={u} rep_k={rep_k} unaligned")
                fused += 2
        for what, lanes in (("every lane padding", torch.full((4097,), PAD_RANK)),
                            ("every lane replicated", torch.arange(4097) % 2048)):
            check_route_bucketize(lanes.to(torch.int32).to(dev), r_owner, r_local, 2048, s,
                                  f"S={s} {what}")
            fused += 1
    log(f"bucketize phase: {n} cases bitwise equal (S 1, 2, 4, 8; U 0, 1, 3, 4097, 425984, "
        f"owners in [-2, S + 2); every lane padding; every lane replicated); route_bucketize: "
        f"{fused} cases, owner, local and image bitwise the plain version (S 1, 2, 4, 8; rep_k "
        f"0 and 2048; U 0, 1, 3, 4097, 425984, uniq aligned and one lane off; ranks in [-2, "
        f"{n_rank} + 2) of {n_rank}-entry tables, 5 % padding; every lane padding; every lane "
        f"replicated)")
    return 0


def _sharded_cfg(vocab_scale):
    return dataclasses.replace(_scaled(vocab_scale), model_shards=SHARDS, replicate_top_k=REP_K,
                               exchange_codec="fp32", max_routed_per_shard=0)


def _exchange_ints(m):
    """Routed lanes per slab and per shard, and the overflow count, as ints
    (one device-to-host copy)."""
    from repro_torch.obs.hub import fetch_ints

    per = m["exchange_per_shard_lanes"]
    out = fetch_ints({"lanes": m["exchange_routed_lanes"], "overflows": m["uniq_overflows"],
                      "per_shard": {str(s): per[s] for s in range(per.shape[0])}})
    out["per_shard"] = [out["per_shard"][str(s)] for s in range(per.shape[0])]
    return out


def sharded_phase(dev, vocab_scale, n_batches, n_steps):
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.core.sharded import flat_store
    from repro_torch.data import synth
    from torch_rank_jobs import count_metrics
    from repro_torch.kernels.cache_ops import kernel, ops
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine

    cfg = _sharded_cfg(vocab_scale)
    model = DLRM(cfg)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    S, cap, vs = cfg.model_shards, coll.shard_capacity(spec), coll.rows_per_shard(spec)
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs[SHARED_ARENA]
    log(f"sharded init+warmup {time.perf_counter() - t0} s: {S} shards x {vs} rows x {spec.dim} "
        f"fp32 in one host table = {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; "
        f"arena {S} x {cap} slots = {S * cap * spec.dim * 4 / 1e6} MB; replicated head "
        f"{slab.rep.rows.shape[0]} rows; device_bytes {json.dumps(coll.device_bytes())}; "
        f"host RSS {rss_gb()} GB")
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    serve_b = [synth.sparse_batch(bspec, cfg.batch_size, 0, i) for i in range(n_batches + 2)]
    train_b = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + 5)]

    def dev_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(
        model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad, device=dev,
        state_stats_fn=lambda st: coll.metrics(st["emb"], writeback=False),
    )
    engine.score(serve_b[n_batches + 1])  # first call: allocator, cuBLAS
    engine.stats = type(engine.stats)()
    captured = []
    impl = ops.route_image_impl

    def capture(uniq, rank_owner, rank_local, rep_k, s):  # the first plan's live router inputs
        if not captured:
            captured.append((uniq.clone(), rank_owner, rank_local, rep_k, s))
        return impl(uniq, rank_owner, rank_local, rep_k, s)

    # --- main path 1: serve, counts at 0 before and read after --------------
    ops.route_image_impl = capture
    try:
        kernel.bucketize.launches = kernel.victim_threshold.launches = 0
        kernel.bucketize.fused_launches = 0
        lat, scores = [], []
        for b in serve_b[:n_batches]:
            t0 = time.perf_counter()
            scores.append(engine.score(b))
            lat.append(1e3 * (time.perf_counter() - t0))
        serve_bz, serve_thr = kernel.bucketize.launches, kernel.victim_threshold.launches
        serve_fused = kernel.bucketize.fused_launches
    finally:
        ops.route_image_impl = impl
    summary = engine.summary()
    scores = np.concatenate(scores)
    if scores.shape != (n_batches * cfg.batch_size,) or not np.isfinite(scores).all():
        raise AssertionError(f"sharded scores: shape {scores.shape}, finite "
                             f"{np.isfinite(scores).all()}")
    if summary["uniq_overflows"] != 0:
        raise AssertionError(f"sharded serve uniq_overflows = {summary['uniq_overflows']}")
    if serve_bz != n_batches or serve_thr != S * n_batches or serve_fused != serve_bz:
        raise AssertionError(f"sharded serve: bucketize launched {serve_bz} ({serve_fused} "
                             f"route + image), threshold {serve_thr} times for {n_batches} "
                             f"plans of {S} shards")
    log(f"sharded serve: {n_batches} batches of {cfg.batch_size}; per-batch ms {lat}; p50 "
        f"{np.percentile(lat, 50)} ms, p99 {np.percentile(lat, 99)} ms (numpy percentiles of "
        f"{n_batches}); requests/s {summary['requests'] / (sum(lat) / 1e3)}; hit rate "
        f"{summary['hit_rate']}; launches: bucketize {serve_bz}, threshold {serve_thr}")
    b = dev_batch(serve_b[n_batches])
    logits, emb = model.serve_step(engine.state, b)
    ref_rows = coll.dense_reference(emb, model.features(b))
    ref_logits = model.fwd(engine.state["params"], ref_rows, b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"sharded cached vs dense_reference logits differ by {diff}")
    log(f"sharded cache invariant: max |cached - dense_reference| logit = {diff} (rtol "
        f"{TOL_RTOL} atol {TOL_ATOL})")
    state = dict(engine.state, emb=emb)

    # --- main path 2: train, counts at 0 before and read after --------------
    kernel.bucketize.launches = kernel.victim_threshold.launches = 0
    kernel.bucketize.fused_launches = 0
    step_ms, losses, per_step, counts = [], [], [], []
    prev = None
    for i in range(n_steps + 1):  # step 0 warms the allocator and autograd up
        t0 = time.perf_counter()
        state, m = model.train_step(state, dev_batch(train_b[n_steps + 4 if i == 0 else i - 1]))
        losses.append(float(m["loss"]))  # the step's one sync
        dt = 1e3 * (time.perf_counter() - t0)
        cur = _exchange_ints(m)
        if prev is not None:
            counts.append(count_metrics(m))  # phase 19a's ranks take these batches too
            step_ms.append(dt)
            lanes = cur["lanes"][SHARED_ARENA] - prev["lanes"][SHARED_ARENA]
            per_step.append({"routed_lanes_per_shard": [c - p for c, p in zip(
                cur["per_shard"], prev["per_shard"])], "exchange_id_bytes": 4 * lanes,
                "exchange_row_bytes": lanes * spec.dim * 4,
                "shard_imbalance": float(m["shard_imbalance"]), "hit_rate": float(m["hit_rate"])})
        prev = cur
    train_bz, train_thr = kernel.bucketize.launches, kernel.victim_threshold.launches
    train_fused = kernel.bucketize.fused_launches
    if not all(np.isfinite(losses)):
        raise AssertionError(f"sharded non-finite loss: {losses}")
    if prev["overflows"]:
        raise AssertionError(f"sharded train uniq_overflows = {prev['overflows']}")
    if train_bz != n_steps + 1 or train_thr != S * (n_steps + 1) or train_fused != train_bz:
        raise AssertionError(f"sharded train: bucketize launched {train_bz} ({train_fused} "
                             f"route + image), threshold {train_thr} times for {n_steps + 1} "
                             f"plans of {S} shards")
    log(f"sharded train: {n_steps} steps of {cfg.batch_size} after a warm-up step; losses "
        f"{losses}; step ms {step_ms}; p50 {np.percentile(step_ms, 50)} ms, p99 "
        f"{np.percentile(step_ms, 99)} ms (numpy percentiles of {n_steps}); launches: "
        f"bucketize {train_bz}, threshold {train_thr}; D2H lane syncs per step "
        f"{2 * S} (a writeback and a load move per shard)")
    log(f"sharded train per step (routed lanes per shard, exchange id / row bytes, live "
        f"shard_imbalance, hit rate): {json.dumps(per_step)}")

    # --- stage by stage with syncs, three steps: where the time goes --------
    grads_ms = []
    apply_grads = coll.apply_grads

    def timed_apply_grads(*a, **k):
        out, ms = sync_ms(lambda: apply_grads(*a, **k))
        grads_ms.append(ms)
        return out

    coll.apply_grads = timed_apply_grads
    try:
        for i in range(n_steps, n_steps + 3):
            b = dev_batch(train_b[i])
            plan, t_plan = sync_ms(lambda: model.plan_step(state, b))
            state, t_apply = sync_ms(lambda: model.apply_step(state, plan))
            (state, m), t_compute = sync_ms(lambda: model.compute_step(state, b, plan.addresses))
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"sharded non-finite loss {float(m['loss'])} at step {i}")
            log(f"sharded train breakdown ms (synced, step {i}): plan_prepare {t_plan}, "
                f"apply_plan ({S} shards: writeback + load) {t_apply}, fwd+bwd+dense SGD "
                f"{t_compute - grads_ms[-1]}, apply_grads {grads_ms[-1]}; routed lanes per "
                f"shard {plan.routed[SHARED_ARENA].tolist()}")
    finally:
        del coll.apply_grads
    b = dev_batch(train_b[n_steps + 3])
    profile_call("one sharded train step", lambda: model.train_step(state, b))
    plan_ops = sharded_plan_ops(model, state, b)

    # --- flush: every shard's residents and the replicated head on the host
    t0 = time.perf_counter()
    state = model.flush(state)
    torch.cuda.synchronize()
    log(f"sharded flush {1e3 * (time.perf_counter() - t0)} ms")
    slab = state["emb"].slabs[SHARED_ARENA]
    arena = coll.weights(state["emb"])[SHARED_ARENA]
    K = slab.rep.rows.shape[0]
    stale = []
    for s in range(S):
        # a warm copy of a replicated rank's home may sit in an arena slot:
        # it is never read (those lanes read the replicated arena), and the
        # flush writes the replicated row over its home after the shards'
        rows = slab.cache.slot_to_row[s].clone()
        skip = torch.isin(rows, slab.rank_local[:K][slab.rank_owner[:K] == s]) & (rows >= 0)
        stale.append(int(skip.sum()))
        rows[skip] = -1
        check_resident(arena[s], rows, slab.full.shard(s), f"sharded shard {s}")
    log(f"sharded post-flush: resident warm copies of replicated homes (never read, left "
        f"out above) per shard {stale}")
    homes = (slab.rank_owner[:K].long() * vs + slab.rank_local[:K].long()).cpu()
    host = flat_store(slab.full).decode_rows(homes)["weight"]
    if not torch.equal(slab.rep.rows.cpu(), host):
        raise AssertionError("sharded post-flush: replicated rows != their host homes")
    log(f"sharded post-flush: all {K} replicated rows equal their host homes bitwise")
    live_err = check_route_bucketize(*captured[0], "live router inputs of the first plan")
    owner, local, _ = kernel.route_bucketize_plain(*captured[0])
    live_err = max(live_err, check_bucketize(owner, local, S, "the first plan's live route"))
    log(f"route_bucketize and bucketize on the first plan's live router inputs "
        f"[{captured[0][0].numel()} lanes, {int((local >= 0).sum())} routed]: kernels bitwise "
        f"= plain")
    slab.full.close()
    return {"launches": {"serve": serve_bz, "train": train_bz},
            "fused_launches": {"serve": serve_fused, "train": train_fused},
            "thr_launches": serve_thr + train_thr, "captured": captured[0],
            "live_err": live_err, "plan_ops": plan_ops, "counts": counts}


def sharded_plan_ops(model, state, batch):
    """Device ops of one profiled sharded plan (``plan_step``: planning
    only, the state untouched), through the route + bucketize kernel and
    again with the composition it replaced (the route's torch ops, then
    the bucketize kernel) patched in: the ops a plan saves."""
    from repro_torch.kernels.cache_ops import kernel, ops

    impl = ops.route_image_impl
    images = []

    def counted(*a):
        images.append(1)
        return impl(*a)

    out = {}
    for name, fn in (("fused", counted), ("composition", _route_composition)):
        ops.route_image_impl = fn
        try:
            out[name] = device_ops(lambda: model.plan_step(state, batch), iters=1)
        finally:
            ops.route_image_impl = impl
    n_img = len(images) // 2  # device_ops calls fn twice (a warm call, the window)
    (fused, by_f), (comp, by_c) = out["fused"], out["composition"]
    log(f"one profiled sharded plan: {fused} device ops through route_bucketize, {comp} with "
        f"the composition it replaced ({n_img} routed image a plan): "
        f"{None if fused is None else (comp - fused) / n_img} fewer ops a routed image; by op "
        f"fused {json.dumps(by_f)}, composition {json.dumps(by_c)}")
    if fused is not None and comp - fused < 15 * n_img:
        raise AssertionError(f"sharded plan: {comp - fused} fewer device ops for {n_img} routed "
                             f"images, want >= 15 each")
    return {"fused": fused, "composition": comp, "images": n_img}


def sharded_crosscheck(dev, vocab_scale=0.02, n_steps=4):
    """4 train steps split over 4 shards and 4 unsharded, from one seed and
    the same batches: losses within rtol 1e-5 (bitwise on the CPU; the
    card's atomic ``index_add_`` sums in no fixed order)."""
    from repro_torch.data import synth
    from repro_torch.models.dlrm import DLRM

    log(f"sharded cross-check at vocab scale {vocab_scale}:")
    runs = {}
    for name, cfg in (("sharded", _sharded_cfg(vocab_scale)),
                      ("unsharded", dataclasses.replace(_scaled(vocab_scale), model_shards=0))):
        model = DLRM(cfg)
        state = model.init(0, device=dev)
        bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
        losses = []
        for i in range(n_steps):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in synth.sparse_batch(bspec, cfg.batch_size, 1, i).items()}
            state, m = model.train_step(state, b)
            losses.append(float(m["loss"]))
        for slab in state["emb"].slabs.values():
            slab.full.close()
        runs[name] = np.asarray(losses)
    diff = float(np.abs(runs["sharded"] - runs["unsharded"]).max())
    if not np.allclose(runs["sharded"], runs["unsharded"], rtol=1e-5, atol=0):
        raise AssertionError(f"sharded vs unsharded losses differ by {diff}: {runs}")
    log(f"sharded cross-check: losses sharded {runs['sharded'].tolist()}, unsharded "
        f"{runs['unsharded'].tolist()}, max |diff| {diff} (rtol 1e-5)")
    return diff


# ---------------------------------------------------------------------------
# phase 19: hybrid parallel over ranks, one cache shard a process
# ---------------------------------------------------------------------------

DIST_SERVE, DIST_TRAIN = 3, 4  # 19a: served batches and train steps
# 19a's compact width: 5b's plans route at most 11 299 distinct rows to a shard (its log)
DIST_WIDTH = 16384
# what 19a holds to 5b's full-width stacked run: the exchange's counts (the cache's own
# counts differ: the compact plan sizes its unique and victim buffers at W, not U, and
# takes other victims; 19b holds compact ranks bitwise to a compact stacked run)
EXCHANGE_COUNTS = ("uniq_overflows", "exchange_id_bytes", "exchange_row_bytes", "exchange_bytes",
                   "exchange_routed_lanes", "exchange_per_shard_lanes")
DIST_SCALE, DIST_STEPS, DIST_BATCH = 0.02, 3, 2048  # 19b: vocab scale, train steps, batch
# 19b's cases: (shards, exchange codec, arena and host codec, compact width (0: every
# lane)); the int8-tiered one also hands its checkpoint to the stacked layout.  A batch of
# 2048 routes ~2 650 distinct rows to each of 2 shards, ~1 330 to each of 4.
DIST_CASES = ((2, "fp32", "fp32", 0), (2, "int8", "fp32", 4096), (4, "fp32", "fp32", 2048),
              (4, "int8", "fp32", 0), (4, "fp32", "int8", 2048))
NCCL_STEPS = 2  # 19c


def _rank_census(res, what):
    """Each rank's census of one step: logged, kept for the census line,
    and held to the baseline's sync sites."""
    from repro_torch.analysis import run as gate

    held = {s["site"] for s in json.loads(gate._DEFAULT_BASELINE.read_text())["sync_sites"]}
    for r in res:
        c = r["census"]
        unheld = {site: f for site, f in c["port_sites"].items() if site not in held}
        CENSUS[f"{what}, rank {r['rank']}"] = dict(c, unheld=unheld, seconds=0.0)
        log(f"census {what}, rank {r['rank']}: {c['syncs']} host syncs ({c['documented']} "
            f"documented) by site {json.dumps(c['by_site'])}; by thread "
            f"{json.dumps(c['by_thread'])}; sites in the port outside the baseline: "
            f"{unheld or 'none'}")
        if unheld:
            raise AssertionError(f"census {what}: host syncs at sites the baseline does not "
                                 f"hold: {unheld}")


def _gloo_cfg(vocab_scale):
    return dataclasses.replace(_sharded_cfg(vocab_scale), arena_precision="int8",
                               max_routed_per_shard=DIST_WIDTH)


def dist_gloo_job(vocab_scale, n_batches, n_steps, warm_index):
    """19a's rank job (run in :func:`ranks_phase`'s four-rank world): phase
    5b's DLRM (4 shards, K 2048, fp32 exchange) with an int8-tiered arena
    and the row leg at the compact width ``DIST_WIDTH``, one shard a rank,
    each pinning only its host slice: a ServeEngine, a warm-up, the train
    steps and a flush on 5b's batches, then a census step; in torch's
    default (nondeterministic) mode."""
    return dict(cfg=_gloo_cfg(vocab_scale), serve=n_batches, warm_serve=True,
                check_dense=(TOL_RTOL, TOL_ATOL), train=n_steps, warm_train=True,
                warm_index=warm_index, census=True, count=True, replicated=True)


def dist_gloo_check(res, vocab_scale, n_batches, n_steps, stacked_counts):
    """19a: every rank's scores, losses and replicated leaves (MLPs,
    replicated head, routing maps) bitwise the others' in the default
    mode, cached = ``dense_reference`` logits, a plan's launches, the
    ``gather_decode`` rounds, the exchange's counts those of 5b's stacked
    run, the census.  Returns the ranks' launches."""
    S = _gloo_cfg(vocab_scale).model_shards
    r0 = res[0]
    for r in res:
        if not (np.isfinite(r["scores"]).all() and np.isfinite(r["losses"]).all()):
            raise AssertionError(f"19a rank {r['rank']}: non-finite scores or losses")
        if not np.array_equal(r["scores"], r0["scores"]) or r["losses"] != r0["losses"]:
            raise AssertionError(f"19a rank {r['rank']}: scores or losses differ from rank 0's: "
                                 f"{r['losses']} vs {r0['losses']}")
        if r["replicated"] != r0["replicated"]:
            bad = sorted(k for k in r0["replicated"] if r["replicated"][k] != r0["replicated"][k])
            raise AssertionError(f"19a rank {r['rank']}: replicated leaves drifted from rank "
                                 f"0's in the default mode: {bad}")
        if not r["dense_close"]:
            raise AssertionError(f"19a rank {r['rank']}: cached vs dense_reference logits differ "
                                 f"by {r['dense_diff']}")
        sl, tl, rounds = r["serve_launches"], r["train_launches"], r["rounds"]
        want = {"serve": n_batches, "train": n_steps}
        for path, got in (("serve", sl), ("train", tl)):
            n = want[path]
            if (got["route_bucketize"], got["bucketize"], got["victim_threshold"]) != (n, n, n):
                raise AssertionError(f"19a rank {r['rank']} {path}: {got} for {n} plans (want "
                                     f"1 route_bucketize and 1 threshold a plan)")
        if sl["gather_decode"] or tl["gather_decode"] != rounds["writeback"] + rounds["flush"] \
                or not tl["gather_decode"] or tl["gather_decode_encode"]:
            raise AssertionError(f"19a rank {r['rank']}: gather_decode {sl['gather_decode']} "
                                 f"serving, {tl['gather_decode']} training; the plans imply "
                                 f"{rounds}")
        n = min(len(stacked_counts), len(r["metrics"]))
        got = [{k: m[k] for k in EXCHANGE_COUNTS} for m in r["metrics"][:n]]
        want = [{k: m[k] for k in EXCHANGE_COUNTS} for m in stacked_counts[:n]]
        if got != want:
            raise AssertionError(f"19a rank {r['rank']}: count-valued exchange metrics differ "
                                 f"from the stacked layout's (5b): {got} vs {want}")
    log(f"19a: {S} gloo ranks on one card (they time-share it: these times say nothing of "
        f"scaling), torch's default mode, the row leg at width {DIST_WIDTH}; scores, losses "
        f"and the {len(r0['replicated'])} replicated leaves bitwise across the ranks; losses "
        f"{r0['losses']}; cached = dense_reference within rtol "
        f"{TOL_RTOL} atol {TOL_ATOL} (max |diff| {max(r['dense_diff'] for r in res)}); count-"
        f"valued exchange metrics of {min(len(stacked_counts), n_steps)} steps = the stacked "
        f"layout's (5b); a rank's plan: 1 route_bucketize, 1 threshold; gather_decode = the plans' "
        f"write-back + flush rounds {[r['rounds'] for r in res]}")
    for r in res:
        tt, st = r["train_traffic"], r["serve_traffic"]
        log(f"19a rank {r['rank']} (shard {r['model_rank']}): init {r['init_s']} s, host slice "
            f"{r['host_process_bytes'] / 1e9} GB pinned; serve ms {r['serve_ms']} p50 "
            f"{np.percentile(r['serve_ms'], 50)}; train step ms {r['step_ms']} p50 "
            f"{np.percentile(r['step_ms'], 50)}; flush {r['flush_ms']} ms; collectives a step "
            f"{tt['collectives'] / n_steps}, their host ms a step {1e3 * tt['seconds'] / n_steps}, "
            f"bytes sent a step {tt['bytes_sent'] / n_steps} (serve: a batch "
            f"{st['collectives'] / n_batches} collectives, {1e3 * st['seconds'] / n_batches} ms, "
            f"{st['bytes_sent'] / n_batches} B); launches serve {r['serve_launches']} train "
            f"{r['train_launches']}; RSS after init, serving, training, at the end "
            f"{r['rss_gb']} GB, peak device memory {r['peak_device_gb']} GB; device_bytes "
            f"{json.dumps(r['device_bytes'])}")
    log(f"19a card: {card_line()}")
    _rank_census(res, "19a (gloo rank DLRM train step, after the flush)")
    return {k: sum(r["serve_launches"][k] + r["train_launches"][k] for r in res)
            for k in r0["train_launches"]}


def _stacked_case(cfg, n_steps, dev):
    """The one-process stacked run of a 19b case: losses, each shard's
    digests after the flush, and the flushed state."""
    from torch_rank_jobs import shard_digests

    from repro_torch.data import synth
    from repro_torch.dist.mesh import HybridMesh
    from repro_torch.dist.partitioning import shard_state
    from repro_torch.models.dlrm import DLRM

    model = DLRM(cfg)
    state = model.init(0, device=dev)
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    losses = []
    for i in range(n_steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in synth.sparse_batch(bspec, cfg.batch_size, 1, i).items()}
        state, m = model.train_step(state, b)
        losses.append(float(m["loss"]))
    state = model.flush(state)
    specs = model.state_specs()
    digests = [shard_digests(shard_state(state, specs, HybridMesh.coordinate(cfg.model_shards, s)))
               for s in range(cfg.model_shards)]
    return model, state, losses, digests


def dist_bitwise_jobs(world, ck_root, vocab_scale=DIST_SCALE, n_steps=DIST_STEPS):
    """19b's rank jobs for a world of ``world`` ranks: the ``DIST_CASES`` at
    ``S == world`` (the int8-tiered one saves a checkpoint), then the
    budget plan and the bag step at ``(world / 2, 2)``
    (:func:`_budget_bitwise_jobs`).  Returns (cases, their jobs, the budget
    jobs)."""
    cases = [c for c in DIST_CASES if c[0] == world]
    jobs = []
    for S, xc, prec, width in cases:
        cfg = dataclasses.replace(_scaled(vocab_scale), model_shards=S, replicate_top_k=REP_K,
                                  exchange_codec=xc, arena_precision=prec, host_precision=prec,
                                  batch_size=DIST_BATCH, max_routed_per_shard=width)
        job = dict(cfg=cfg, train=n_steps, digests=True, count=True, deterministic=True)
        if prec == "int8":
            job.update(save=str(ck_root / f"s{S}"), next_step=True)
        jobs.append(job)
    return cases, jobs, _budget_bitwise_jobs(world // BUDGET_SHARDS, ck_root)


def dist_bitwise_check(cases, jobs, res, dev, ck_root, n_steps=DIST_STEPS):
    """19b: gloo ranks sharing the card against the one-process stacked
    layout, every run under ``deterministic()``: losses, arena and host
    slices bitwise; the int8-tiered case's checkpoint, saved by the ranks,
    restored into the stacked layout, whose next step is bitwise the
    ranks'.  Cut to batch ``DIST_BATCH`` (the rows on the wire and the
    time scale with it).  Cases at a compact width run the row leg at it,
    and so does their stacked run's plan.  ``res[r]``: rank ``r``'s results
    of ``jobs``.  Returns the ranks' ``gather_decode`` launches."""
    from repro_torch.data import synth
    from repro_torch.train import checkpoint as ckpt

    launches = {"gather_decode": 0, "gather_decode_encode": 0}
    for j, ((S, xc, prec, width), job) in enumerate(zip(cases, jobs)):
        with deterministic():
            model, state, losses, digests = _stacked_case(job["cfg"], n_steps, dev)
        for r in res:
            got = r[j]
            if got["losses"] != losses or got["digests"] != digests[got["model_rank"]]:
                bad = sorted(k for k in digests[got["model_rank"]]
                             if got["digests"].get(k) != digests[got["model_rank"]][k])
                raise AssertionError(f"19b S {S} exchange {xc} codec {prec} width {width} rank "
                                     f"{got['rank']}: losses {got['losses']} vs stacked "
                                     f"{losses}; leaves not bitwise {bad}")
            for k in launches:
                launches[k] += got["train_launches"][k]
        if prec == "int8":
            if not all(r[j]["train_launches"]["gather_decode_encode"] for r in res):
                raise AssertionError(f"19b S {S}: no gather_decode_encode launch into the int8 "
                                     f"host")
            with deterministic():
                template = model.init(1, device=dev)
                template, step = ckpt.restore(ck_root / f"s{S}", template)
                bspec = synth.ZipfSparseSpec(vocab_sizes=job["cfg"].vocab_sizes,
                                             n_dense=job["cfg"].n_dense)
                b = {k: torch.from_numpy(v).to(dev) for k, v in synth.sparse_batch(
                    bspec, job["cfg"].batch_size, 1, n_steps).items()}
                template, m = model.train_step(template, b)
                nxt = float(m["loss"])
            _close(template)
            if any(r[j]["next_loss"] != nxt for r in res):
                raise AssertionError(f"19b S {S}: the stacked layout restored from the ranks' "
                                     f"checkpoint steps to {nxt}, the ranks to "
                                     f"{[r[j]['next_loss'] for r in res]}")
            log(f"19b S {S}: the ranks' checkpoint (step {step}) restored into the stacked "
                f"layout; its next loss {nxt} bitwise the ranks'")
        _close(state)
        del model, state
        gc.collect()
        log(f"19b S {S} exchange {xc} arena/host {prec} row leg width {width or 'every lane'}: "
            f"losses {losses} bitwise the stacked layout's on every rank; arena, host slice "
            f"(payload and sideband), replicated head and slot map of each shard bitwise after "
            f"the flush; rank launches {[r[j]['train_launches'] for r in res]}")
    return launches


BUDGET_SHARDS = 2  # 19b's budget plan and bag step: at (1, 2) and (2, 2)


def _budget_bitwise_jobs(D, ck_root):
    """19b's budget cases at ``(D, 2)``, all under ``deterministic()``: phase
    5e's plan cut to 19b's scale (vocab 0.02, global batch 2 048; the
    budget that keeps its placements, K 2048): ``DIST_STEPS`` steps, a
    flush and a checkpoint save; the same steps, then a refresh pass and a
    forced re-homing; a bag step from the init (``BAG_LANES`` lanes a bag),
    then a flush."""
    cfg = dataclasses.replace(_budget_cfg(DIST_SCALE, DIST_BATCH), model_shards=BUDGET_SHARDS,
                              replicate_top_k=REP_K)
    common = dict(cfg=cfg, count=True, deterministic=True, digests=True, replicated=True)
    return [dict(common, train=DIST_STEPS, save=str(ck_root / f"budget_{D}"), next_step=True,
                 check_flushed=True),
            dict(common, train=DIST_STEPS, flush=False, digests=False,
                 refresh=dict(cfg=REHOME_REFRESH, rebalance=0.0, digests=True, probe=99,
                              cool_head=True)),
            dict(common, train=0, check_flushed=True,
                 bag=dict(bags=DIST_BATCH // BAG_LANES, lanes=BAG_LANES, combiner="sum",
                          step=0))]


def _budget_bitwise_check(res, jobs, D, dev, ck_root):
    """Holds 19b's budget cases (:func:`_budget_bitwise_jobs`; ``res[r]`` is
    rank ``r``'s results of them) to the one-process stacked layout, every
    run under ``deterministic()``:

    * the steps: losses, each shard (arena, host slice and sideband, head,
      slot map) after the flush and the leaves every rank holds whole (the
      DEVICE tables, MLPs, routing maps) bitwise at ``(1, 2)``; at ``(2,
      2)`` (each replica's loss is the mean of its half of the batch) the
      losses within rtol 1e-5 of the stacked layout's and the slot maps
      bitwise, the replicas bitwise each other and the whole leaves bitwise
      across the ranks; the ranks' checkpoint restored into
      the stacked layout is bitwise each rank's shard, and its next loss
      the ranks' (within rtol 1e-5 at ``(2, 2)``);
    * the refresh pass and the re-homing (:func:`_rehome_check`), over the
      budget plan's five cached slabs with their own int8 host codecs;
    * the bag step: each replica's pooled rows, its gradients, each shard
      and the DEVICE tables after the update and a flush bitwise the
      stacked layout's
      (``torch_rank_jobs.stacked_bag_step``: at ``(2, 2)`` each replica's
      bags differentiated alone, summed in data-rank order);

    and a plan's one threshold and one ``route_bucketize`` launch a cached
    slab, the bag step's one ``embedding_bag`` launch a slab (each output
    bitwise the plain version on its gathered lanes), ``gather_decode_encode``
    = the write-back and flush rounds.  Returns the launches by case."""
    import torch_rank_jobs as rank_jobs

    from repro_torch.dist.mesh import HybridMesh
    from repro_torch.dist.partitioning import shard_state, sharded_paths
    from repro_torch.train import checkpoint as ckpt

    S = BUDGET_SHARDS
    cfg = jobs[0]["cfg"]
    what = f"19b budget ({D}, {S})"
    train_res, refresh_res, bag_res = ([r[i] for r in res] for i in range(3))
    with deterministic():
        model, state, losses, digests = _stacked_case(cfg, DIST_STEPS, dev)
    coll = model.collection
    split = sharded_paths(model.state_specs())

    def replicated(st):  # the leaves every rank holds whole: DEVICE tables, MLPs, routing maps
        return {k: rank_jobs.digest(v) for k, v in ckpt._flatten(st) if k not in split}

    whole = replicated(state)
    n_cached, n_slabs = len(coll.cached_slabs), len(coll.cached_slabs) + len(coll.device_slabs)
    for r in train_res + refresh_res + bag_res:
        tl, rounds = r["train_launches"], r["rounds"]
        n = n_cached * (DIST_STEPS if "bag_loss" not in r else 1)
        gde = rounds["writeback"] + rounds["flush"]
        if ((tl["victim_threshold"], tl["route_bucketize"], tl["bucketize"]) != (n, n, n)
                or tl["gather_decode"] != gde or tl["gather_decode_encode"] != gde
                or ("flushed_rows" in r and not gde)):
            raise AssertionError(f"{what} rank {r['rank']}: launches {tl}; the plans imply "
                                 f"{n} threshold and route_bucketize, {rounds} rounds")
    for r in train_res:
        at = f"{what} rank {r['rank']}"
        twin = next(x for x in train_res if x["model_rank"] == r["model_rank"])
        want = digests[r["model_rank"]]
        if D == 1:
            ok = r["losses"] == losses and r["digests"] == want and r["replicated"] == whole
        else:
            ok = (np.allclose(r["losses"], losses, rtol=1e-5, atol=0)
                  and r["digests"] == twin["digests"]
                  and r["replicated"] == train_res[0]["replicated"]
                  and all(r["digests"][k] == want[k] for k in want if k.endswith("slot_to_row")))
        if not ok or not r["flushed_rows"]:
            bad = sorted(k for k in want if r["digests"].get(k) != want[k])
            raise AssertionError(f"{at}: losses {r['losses']} vs stacked {losses}; leaves not "
                                 f"bitwise {bad}; rows checked after the flush "
                                 f"{r['flushed_rows']}")
    # the ranks' checkpoint, restored into the stacked layout
    template = model.init(1, device=dev)
    with deterministic():
        template, step = ckpt.restore(ck_root / f"budget_{D}", template)
        restored = [rank_jobs.shard_digests(shard_state(template, model.state_specs(),
                                                        HybridMesh.coordinate(S, s)))
                    for s in range(S)]
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             synth_batch(synth_spec(cfg), cfg.batch_size, 1, DIST_STEPS).items()}
        template, m = model.train_step(template, b)
        nxt = float(m["loss"])
    _close(template)
    for r in train_res:
        if restored[r["model_rank"]] != r["digests"] or not (
                r["next_loss"] == nxt if D == 1 else np.isclose(r["next_loss"], nxt, rtol=1e-5,
                                                                atol=0)):
            raise AssertionError(f"{what} rank {r['rank']}: the checkpoint (step {step}) "
                                 f"restored into the stacked layout is not its shard, or its "
                                 f"next loss {nxt} vs the ranks' {r['next_loss']}")
    _close(state)
    del state, template
    gc.collect()
    swaps, moves, cross, deferred = _rehome_check(refresh_res, cfg, D, S, dev,
                                                  f"{what} refresh")
    # the bag step: the stacked layout's from the init, with the ranks' bags
    spec = jobs[2]["bag"]
    with deterministic():
        state = model.init(0, device=dev)
        step = rank_jobs.global_bags(cfg, model.feature_names, spec["bags"], spec["lanes"],
                                     spec["step"])
        emb, reps, grads, _ = rank_jobs.stacked_bag_step(
            coll, state["emb"], step, step["cot"], D, spec["combiner"], spec["lanes"], cfg.lr,
            dev)
        state = model.flush(dict(state, emb=emb))
    bag_digests = [rank_jobs.shard_digests(shard_state(state, model.state_specs(),
                                                       HybridMesh.coordinate(S, s)))
                   for s in range(S)]
    bag_whole = replicated(state)
    for r in bag_res:
        at = f"{what} bag step rank {r['rank']}"
        s_, d_ = r["model_rank"], r["data_rank"]
        want_g = {k: rank_jobs.digest(g[s_:s_ + 1] if k in coll.cached_slabs else g)
                  for k, g in grads.items()}
        want_p = {f: rank_jobs.digest(x) for f, x in reps[d_]["pooled"].items()}
        if (r["bag_pooled"] != want_p or r["bag_grads"] != want_g
                or r["digests"] != bag_digests[s_] or r["replicated"] != bag_whole):
            raise AssertionError(f"{at}: pooled rows {r['bag_pooled'] == want_p}, gradients "
                                 f"{r['bag_grads'] == want_g}, shard after the update "
                                 f"{r['digests'] == bag_digests[s_]}, DEVICE tables and the "
                                 f"other whole leaves {r['replicated'] == bag_whole} bitwise "
                                 f"the stacked layout's")
        if (r["bag_launches"]["embedding_bag"], r["bag_calls"]) != (n_slabs, n_slabs) or \
                not r["bag_exact"]:
            raise AssertionError(f"{at}: {r['bag_launches']} launches in {r['bag_calls']} calls "
                                 f"for {n_slabs} slabs; bitwise the plain version: "
                                 f"{r['bag_exact']}")
    _close(state)
    del state, model
    gc.collect()
    log(f"{what}: phase 5e's plan at vocab scale {DIST_SCALE}, batch {cfg.batch_size} "
        f"({n_slabs - n_cached} DEVICE, {n_cached} cached slabs, K {cfg.replicate_top_k}), every "
        f"run deterministic: losses {losses} "
        + ("bitwise, each shard bitwise after the flush" if D == 1 else
           "within rtol 1e-5, slot maps bitwise, replicas bitwise each other")
        + f"; the ranks' checkpoint restored into the stacked layout bitwise each shard, next "
        f"loss {nxt}; a refresh pass ({swaps} swaps, {deferred} deferred, {cross} cross-shard "
        f"rows) and a re-homing ({moves} ranks moved) bitwise the stacked passes; the bag step "
        f"({spec['bags']} bags of {spec['lanes']}): pooled rows, gradients and the updated "
        f"shards bitwise the stacked layout's, {n_slabs} embedding_bag launches a rank, each "
        f"bitwise the plain version; rank ms: bag {[r['bag_ms'] for r in bag_res]}, refresh "
        f"{[r['refresh_ms'] for r in refresh_res]}, re-homing "
        f"{[r['rebalance_ms'] for r in refresh_res]}")
    return {name: {k: sum(r["train_launches"][k] + sum(r.get(f"{p}_launches", {}).get(k, 0)
                                                       for p in ("refresh", "rebalance"))
                          for r in rs) for k in rs[0]["train_launches"]}
            for name, rs in (("budget", train_res + refresh_res), ("bag", bag_res))}


def dist_nccl_phase(dev, vocab_scale, n_steps=NCCL_STEPS):
    """19c: one NCCL rank on cuda:0, one shard (S 1) of the Criteo DLRM at
    ``vocab_scale`` (the smoke passes 19b's ``DIST_SCALE``: the check is the
    NCCL backend's path, which the table's height does not change; the
    full width cost two 17.3 GB inits): losses bitwise the unsharded
    DLRM's, both under ``deterministic()``."""
    import torch_rank_jobs as rank_jobs

    from repro_torch.data import synth
    from repro_torch.dist import run
    from repro_torch.models.dlrm import DLRM

    cfg = dataclasses.replace(_scaled(vocab_scale), model_shards=1)
    job = dict(cfg=cfg, train=n_steps, flush=False, count=True, deterministic=True)
    t0 = time.perf_counter()
    (r,) = [x[0] for x in run.run_ranks(rank_jobs.dlrm_rank, 1, "nccl", None, ([job],))]
    log(f"19c: the NCCL rank took {time.perf_counter() - t0} s (init {r['init_s']} s); its "
        f"launches {r['train_launches']}; traffic {r['train_traffic']}")
    ucfg = dataclasses.replace(cfg, model_shards=0)
    model = DLRM(ucfg)
    bspec = synth.ZipfSparseSpec(vocab_sizes=ucfg.vocab_sizes, n_dense=ucfg.n_dense)
    losses = []
    with deterministic():
        state = model.init(0, device=dev)
        for i in range(n_steps):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in synth.sparse_batch(bspec, ucfg.batch_size, 1, i).items()}
            state, m = model.train_step(state, b)
            losses.append(float(m["loss"]))
    for s_ in state["emb"].slabs.values():
        s_.full.close()
    if r["losses"] != losses:
        raise AssertionError(f"19c: the NCCL rank's losses {r['losses']} != the unsharded "
                             f"DLRM's {losses}")
    log(f"19c: one NCCL rank (S 1, vocab scale {vocab_scale}): losses {losses} bitwise the "
        f"unsharded DLRM's")
    return r["train_launches"]


# 19d: the (data, model) mesh, served batches, serial steps and the pipelined group's depth
DATA_SHAPE, DATA_SERVE, DATA_TRAIN, DATA_GROUP = (2, 2), 2, 3, 2
# 19d's compact width: at 2 shards a full-width plan routes ~22 300 distinct rows to a shard
# (5b's 44 610 over 4), past 19a's 16 384; 32 768 holds them
DATA_WIDTH = 32768
REHOME_SHAPES = ((2, 2), (1, 4))  # 19e: the (data, model) meshes
REHOME_REFRESH = dict(max_swaps=4096, exchange_budget=1024)  # 19e's pass (5g's)


def mem_available_gb() -> float:
    """The host's ``MemAvailable`` now, GB."""
    with open("/proc/meminfo") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("MemAvailable:"))
    return kb * 1024 / 1e9


def _legs_a_step(traffic, n):
    """A rank's bytes sent a step (or batch), by leg and by axis."""
    return {"model": traffic["bytes_sent"] / n, "data": traffic["data_bytes_sent"] / n,
            "legs": {k: v / n for k, v in sorted(traffic["legs"].items())},
            "collectives": (traffic["collectives"] + traffic["data_collectives"]) / n,
            "host_ms": 1e3 * (traffic["seconds"] + traffic["data_seconds"]) / n}


# 19f: phase 5e's budget plan on 19d's mesh: served batches and train steps
BUDGET_SERVE, BUDGET_TRAIN = 2, 2


def _budget_ranks_cfg(vocab_scale):
    """19f's config: phase 5e's plan (1 GiB a device, int8 host and arena:
    21 DEVICE tables + ``BUDGET_CACHED``) at ``DATA_SHAPE``'s shard count."""
    return dataclasses.replace(_budget_cfg(vocab_scale), model_shards=DATA_SHAPE[1])


def _device_leg_bytes(cfg, D):
    """The DEVICE tables' gradient leg a rank sends a step over the data
    axis (float32): each table at the global batch's distinct ids, at most
    ``min(vocab, lanes)`` rows (the bound), and the whole tables' bytes."""
    from repro_torch.models.dlrm import DLRM

    coll = DLRM(cfg).collection
    row = 4 * cfg.embed_dim * (D - 1)
    bound = sum(min(t.vocab, cfg.batch_size) for t in coll.device_slabs.values()) * row
    return bound, sum(t.vocab for t in coll.device_slabs.values()) * row


def _data_cfg(vocab_scale):
    return dataclasses.replace(_sharded_cfg(vocab_scale), model_shards=DATA_SHAPE[1],
                               arena_precision="int8", max_routed_per_shard=DATA_WIDTH)


def dist_data_job(vocab_scale):
    """19d's rank job: phase 5b's DLRM (K 2048, fp32 exchange) with an
    int8-tiered arena on a ``(data=2, model=2)`` mesh of four gloo ranks
    sharing the card, each pinning its shard's half of the host table; the
    plan at the compact width ``DATA_WIDTH``; torch's default mode.  Each
    data replica feeds half of every global batch of 16 384:
    ``DATA_SERVE`` served batches after a warm-up, a warm-up step,
    ``DATA_TRAIN`` serial steps, a flush, then one ``PipelinedTrainer``
    group of depth ``DATA_GROUP`` from that state."""
    return dict(cfg=_data_cfg(vocab_scale), serve=DATA_SERVE, warm_serve=True,
                check_dense=(TOL_RTOL, TOL_ATOL), train=DATA_TRAIN, warm_train=True,
                group=DATA_GROUP, count=True, replicated=True, digests=True)


def budget_ranks_job(vocab_scale):
    """19f's rank job (see :func:`budget_ranks_check`)."""
    return dict(cfg=_budget_ranks_cfg(vocab_scale), serve=BUDGET_SERVE, warm_serve=True,
                check_dense=(TOL_RTOL, TOL_ATOL), train=BUDGET_TRAIN, warm_train=True,
                count=True, replicated=True, digests=True, check_flushed=True,
                bag=dict(bags=BAGS, lanes=BAG_LANES, combiner="sum", step=0))


def dist_data_check(res, vocab_scale):
    """19d: every replica's shard state and every rank's replicated leaves
    (MLPs, head, routing maps) bitwise equal, every rank's losses and
    scores the same, cached = uncached logits, a plan's 1 threshold and 1
    ``route_bucketize`` launch (the group's plan 1 and 2: its window routes
    in a second launch), ``gather_decode`` = the rounds the plans imply.
    Returns the ranks' launches."""
    D, S = DATA_SHAPE
    cfg = _data_cfg(vocab_scale)
    r0 = res[0]
    for r in res:
        what = f"19d rank {r['rank']} (data {r['data_rank']}, shard {r['model_rank']})"
        if not (np.isfinite(r["scores"]).all() and np.isfinite(r["losses"]).all()
                and np.isfinite(r["pipe_losses"]).all()):
            raise AssertionError(f"{what}: non-finite scores or losses")
        if (not np.array_equal(r["scores"], r0["scores"]) or r["losses"] != r0["losses"]
                or r["pipe_losses"] != r0["pipe_losses"]):
            raise AssertionError(f"{what}: scores or losses differ from rank 0's: "
                                 f"{r['losses']} {r['pipe_losses']} vs {r0['losses']} "
                                 f"{r0['pipe_losses']}")
        if r["replicated"] != r0["replicated"]:
            bad = sorted(k for k in r0["replicated"] if r["replicated"][k] != r0["replicated"][k])
            raise AssertionError(f"{what}: replicated leaves drifted from rank 0's: {bad}")
        twin = next(x for x in res if x["model_rank"] == r["model_rank"])
        if r["digests"] != twin["digests"]:
            bad = sorted(k for k in twin["digests"] if r["digests"][k] != twin["digests"][k])
            raise AssertionError(f"{what}: its shard differs from its data replica's: {bad}")
        if not r["dense_close"]:
            raise AssertionError(f"{what}: cached vs dense_reference logits differ by "
                                 f"{r['dense_diff']}")
        sl, tl, gl = r["serve_launches"], r["train_launches"], r["pipe_launches"]
        rounds = r["rounds"]
        for path, got, (thr, route) in (("serve", sl, (DATA_SERVE,) * 2),
                                        ("train", tl, (DATA_TRAIN,) * 2),
                                        ("group", gl, (1, 2))):
            if (got["victim_threshold"], got["route_bucketize"], got["bucketize"]) != (
                    thr, route, route):
                raise AssertionError(f"{what} {path}: launches {got} (want {thr} threshold, "
                                     f"{route} route_bucketize)")
        if sl["gather_decode"] or tl["gather_decode"] != rounds["writeback"] + rounds["flush"] \
                or not tl["gather_decode"] or tl["gather_decode_encode"]:
            raise AssertionError(f"{what}: gather_decode {sl['gather_decode']} serving, "
                                 f"{tl['gather_decode']} training; the plans imply {rounds}")
    log(f"19d: ({D}, {S}) mesh of {D * S} gloo ranks on one card (they time-share it: no "
        f"scaling figure), global batch {cfg.batch_size} ({cfg.batch_size // D} a replica), "
        f"plan width {DATA_WIDTH}, torch's default mode; every replica's shard (arena, host "
        f"slice, head, slot map) bitwise its twin's and the {len(r0['replicated'])} replicated "
        f"leaves bitwise across the ranks; losses {r0['losses']}, group {r0['pipe_losses']}, "
        f"scores the same on every rank; cached = dense_reference within rtol {TOL_RTOL} atol "
        f"{TOL_ATOL} (max |diff| {max(r['dense_diff'] for r in res)}); a plan: 1 threshold, 1 "
        f"route_bucketize (the group's: 1 and 2); gather_decode = the rounds "
        f"{[r['rounds'] for r in res]}")
    for r in res:
        log(f"19d rank {r['rank']} (data {r['data_rank']}, shard {r['model_rank']}): init "
            f"{r['init_s']} s, host slice {r['host_process_bytes'] / 1e9} GB pinned; serve ms "
            f"{r['serve_ms']} p50 {np.percentile(r['serve_ms'], 50)}; train step ms "
            f"{r['step_ms']} p50 {np.percentile(r['step_ms'], 50)}; the group's step ms "
            f"{r['pipe_step_ms']} ({r['pipe_ms']} ms with its init); flush {r['flush_ms']} ms; "
            f"sent a train step {json.dumps(_legs_a_step(r['train_traffic'], DATA_TRAIN))}; "
            f"a served batch {json.dumps(_legs_a_step(r['serve_traffic'], DATA_SERVE))}; "
            f"launches serve {r['serve_launches']} train {r['train_launches']} group "
            f"{r['pipe_launches']}; RSS after init, serving, training, at the end {r['rss_gb']} "
            f"GB, peak device memory {r['peak_device_gb']} GB")
    log(f"19d card: {card_line()}")
    return {k: sum(r["serve_launches"][k] + r["train_launches"][k] + r["pipe_launches"][k]
                   for r in res) for k in r0["train_launches"]}


def budget_ranks_check(res, vocab_scale):
    """19f: phase 5e's budget plan (1 GiB a device, int8 host and arena: the
    21 DEVICE tables whole on every rank, each ``BUDGET_CACHED`` slab one
    shard a rank) on 19d's ``(data=2, model=2)`` mesh of gloo ranks sharing
    the card, each replica feeding half of every global batch, in torch's
    default mode: ``BUDGET_SERVE`` served batches after a warm-up, a
    warm-up step, ``BUDGET_TRAIN`` steps, one bag step (sum) through
    ``pool(use_pallas=True, max_bag=BAG_LANES)`` on ``bag_batch``'s bags,
    then a flush.  Checks ``device_process`` within the budget on every
    rank, every replica's shard bitwise its twin's, every rank's DEVICE
    tables, MLPs and routing maps bitwise the others', losses and scores
    the same on every rank, cached = ``dense_reference`` logits, a plan's
    one threshold and one ``route_bucketize`` launch a cached slab, the
    bag step's one ``embedding_bag`` launch a slab with each output bitwise
    the kernel's plain version on the same gathered lanes,
    ``gather_decode_encode`` = the write-back and flush rounds (every
    ``gather_decode`` fused into the int8 host), and after the flush every
    resident row's host payload and sideband the encode of its arena row;
    the DEVICE tables' gradient leg within its bound.  Returns the ranks'
    launches."""
    from repro_torch.models.dlrm import DLRM

    D, S = DATA_SHAPE
    cfg = _budget_ranks_cfg(vocab_scale)
    coll = DLRM(cfg).collection
    n_cached, n_slabs = len(coll.cached_slabs), len(coll.cached_slabs) + len(coll.device_slabs)
    if vocab_scale == 1.0 and (n_cached, n_slabs) != (len(BUDGET_CACHED), 26):
        raise AssertionError(f"19f: the 1 GiB plan is not 21 DEVICE + {BUDGET_CACHED}: "
                             f"{coll.plan.summary()}")
    bound, whole = _device_leg_bytes(cfg, D)
    r0 = res[0]
    for r in res:
        what = f"19f rank {r['rank']} (data {r['data_rank']}, shard {r['model_rank']})"
        if not (np.isfinite(r["scores"]).all() and np.isfinite(r["losses"]).all()
                and np.isfinite(r["bag_loss"])):
            raise AssertionError(f"{what}: non-finite scores or losses")
        if (not np.array_equal(r["scores"], r0["scores"]) or r["losses"] != r0["losses"]
                or r["bag_loss"] != r0["bag_loss"]):
            raise AssertionError(f"{what}: scores or losses differ from rank 0's: {r['losses']} "
                                 f"{r['bag_loss']} vs {r0['losses']} {r0['bag_loss']}")
        if r["replicated"] != r0["replicated"]:
            bad = sorted(k for k in r0["replicated"] if r["replicated"][k] != r0["replicated"][k])
            raise AssertionError(f"{what}: replicated leaves (DEVICE tables, MLPs, routing "
                                 f"maps) drifted from rank 0's: {bad}")
        twin = next(x for x in res if x["model_rank"] == r["model_rank"])
        if r["digests"] != twin["digests"] or r["bag_grads"] != twin["bag_grads"]:
            raise AssertionError(f"{what}: its shard or its bag gradients differ from its data "
                                 f"replica's")
        if not r["dense_close"]:
            raise AssertionError(f"{what}: cached vs dense_reference logits differ by "
                                 f"{r['dense_diff']}")
        if r["device_bytes"]["device_process"] > BUDGET_BYTES:
            raise AssertionError(f"{what}: device_process {r['device_bytes']['device_process']} "
                                 f"over the per-device budget {BUDGET_BYTES}")
        sl, tl, rounds = r["serve_launches"], r["train_launches"], r["rounds"]
        plans = {"serve": BUDGET_SERVE, "train": BUDGET_TRAIN + 1}  # the bag step's plan too
        for path, got in (("serve", sl), ("train", tl)):
            n = n_cached * plans[path]
            if (got["victim_threshold"], got["route_bucketize"], got["bucketize"]) != (n, n, n):
                raise AssertionError(f"{what} {path}: launches {got} for {plans[path]} plans of "
                                     f"{n_cached} cached slabs (want 1 threshold and 1 "
                                     f"route_bucketize a slab)")
        gde = rounds["writeback"] + rounds["flush"]
        if (sl["gather_decode"] or not gde or tl["gather_decode"] != gde
                or tl["gather_decode_encode"] != gde):
            raise AssertionError(f"{what}: gather_decode {sl['gather_decode']} serving, "
                                 f"{tl['gather_decode']} ({tl['gather_decode_encode']} fused) "
                                 f"training; the plans imply {rounds}")
        if (r["bag_launches"]["embedding_bag"], tl["embedding_bag"], r["bag_calls"]) != (
                n_slabs, n_slabs, n_slabs) or not r["bag_exact"]:
            raise AssertionError(f"{what}: the bag step made {r['bag_launches']} launches in "
                                 f"{r['bag_calls']} calls for {n_slabs} slabs; outputs bitwise "
                                 f"the plain version: {r['bag_exact']} (max |diff| "
                                 f"{r['bag_err']})")
        dev_leg = r["train_traffic"]["parts"]["grads.device"] / BUDGET_TRAIN
        if not 0 < dev_leg <= bound:
            raise AssertionError(f"{what}: the DEVICE tables' gradient leg sent {dev_leg} B a "
                                 f"step, over its bound {bound}")
        if not r["flushed_rows"]:
            raise AssertionError(f"{what}: no resident row checked after the flush")
    log(f"19f: phase 5e's budget plan ({cfg.device_budget_bytes} B a device, int8 host and "
        f"arena: {n_slabs - n_cached} DEVICE tables whole on every rank, {n_cached} cached "
        f"slabs one shard a rank) on a ({D}, {S}) mesh of {D * S} gloo ranks sharing the card, "
        f"global batch {cfg.batch_size}, torch's default mode; every replica's shard bitwise "
        f"its twin's, the {len(r0['replicated'])} replicated leaves (DEVICE tables, MLPs, "
        f"routing maps) bitwise across the ranks; losses {r0['losses']}, bag loss "
        f"{r0['bag_loss']}, scores the same on every rank; cached = dense_reference within "
        f"rtol {TOL_RTOL} atol {TOL_ATOL} (max |diff| {max(r['dense_diff'] for r in res)}); a "
        f"plan: 1 threshold and 1 route_bucketize a cached slab; the bag step: 1 embedding_bag "
        f"launch a slab ({n_slabs}), each bitwise the plain version on its gathered lanes (max "
        f"|diff| {max(r['bag_err'] for r in res)}); gather_decode_encode = the rounds "
        f"{[r['rounds'] for r in res]}; after the flush {[r['flushed_rows'] for r in res]} "
        f"resident rows' int8 host payload and sideband bitwise the encode of their arena rows; "
        f"device_process {[r['device_bytes']['device_process'] for r in res]} B (the budget "
        f"{BUDGET_BYTES}; the planner's {cfg.device_budget_bytes})")
    for r in res:
        tt = r["train_traffic"]
        log(f"19f rank {r['rank']} (data {r['data_rank']}, shard {r['model_rank']}): init "
            f"{r['init_s']} s, host slices {r['host_process_bytes'] / 1e9} GB pinned; serve ms "
            f"{r['serve_ms']} p50 {np.percentile(r['serve_ms'], 50)}; train step ms "
            f"{r['step_ms']} p50 {np.percentile(r['step_ms'], 50)}; bag step {r['bag_ms']} ms "
            f"(p50 of 1); flush {r['flush_ms']} ms; sent a train step "
            f"{json.dumps(_legs_a_step(tt, BUDGET_TRAIN))}, of it the DEVICE tables' gradient "
            f"leg {tt['parts']['grads.device'] / BUDGET_TRAIN} B (bound {bound}; the whole "
            f"tables {whole}) and the arenas' {tt['parts']['grads.arenas'] / BUDGET_TRAIN} B; "
            f"the bag step sent {json.dumps(_legs_a_step(r['bag_traffic'], 1))}; a served batch "
            f"{json.dumps(_legs_a_step(r['serve_traffic'], BUDGET_SERVE))}; launches serve "
            f"{r['serve_launches']} train and bag {r['train_launches']}; RSS after init, "
            f"serving, training, at the end {r['rss_gb']} GB, peak device memory "
            f"{r['peak_device_gb']} GB; device_bytes {json.dumps(r['device_bytes'])}; its job "
            f"{r['job_s']} s")
    log(f"19f card: {card_line()}")
    return {k: sum(r["serve_launches"][k] + r["train_launches"][k] for r in res)
            for k in r0["train_launches"]}


def _rehome_check(res, cfg, D, S, dev, what):
    """The checks of a refresh pass and a forced re-homing across ranks
    (rank jobs with ``refresh=dict(cfg=REHOME_REFRESH, rebalance=0.0,
    digests=True, probe=99, cool_head=True)``): each pass's
    ``gather_decode`` launches on every rank equal to the rounds of its moves
    out of the arena (fused into the host codec's encode where the host is
    encoded; more than 0 in all) and no plan kernel inside a pass; the
    parent rebuilds the stacked layout from the ranks' state before the
    passes and makes the same passes: every rank's state after each pass
    bitwise the stacked layout's shard, the reports equal, a lookup and
    ``dense_reference`` after the passes bitwise on the replica's rows.
    Returns the stacked passes' swaps, ranks moved, cross-shard rows and
    deferred swaps (summed over the cached slabs)."""
    import torch_rank_jobs as rank_jobs

    from repro_torch.core import refresh as refresh_lib
    from repro_torch.dist.partitioning import sharded_paths
    from repro_torch.models.dlrm import DLRM
    from repro_torch.train import checkpoint as ckpt

    digest = rank_jobs.digest
    fused = cfg.host_precision != "fp32"
    for r in res:
        for p in ("refresh", "rebalance"):
            got, rounds = r[f"{p}_launches"], r[f"{p}_rounds"]
            if (got["gather_decode"] != rounds or got["gather_decode_encode"] != fused * rounds
                    or got["victim_threshold"] or got["bucketize"]):
                raise AssertionError(f"{what} rank {r['rank']}: the {p} pass launched {got}; "
                                     f"its moves out of the arena take {rounds} rounds")
    if not (sum(r["refresh_rounds"] for r in res) and all(r["rebalance_rounds"] for r in res)):
        raise AssertionError(f"{what}: no gather_decode in the passes: refresh "
                             f"{[r['refresh_rounds'] for r in res]}, re-homing "
                             f"{[r['rebalance_rounds'] for r in res]} rounds")
    model = DLRM(cfg)
    coll = model.collection
    state = model.init(0, device=dev)
    split = sharded_paths(coll.shard_specs())
    lead = sorted((r for r in res if r["data_rank"] == 0), key=lambda r: r["model_rank"])
    for key, t in ckpt._flatten(state["emb"]):
        parts = [r["refresh_before"][key] for r in lead]
        t.copy_(torch.cat(parts) if key in split else parts[0])
    emb, rep = coll.refresh(state["emb"], refresh_lib.RefreshConfig(**REHOME_REFRESH))
    shard_after = {s: {k: digest(v[s:s + 1] if k in split else v)
                       for k, v in ckpt._flatten(emb)} for s in range(S)}
    emb, reb = coll.refresh(emb, refresh_lib.RefreshConfig(max_swaps=0, rebalance_threshold=0.0))
    shard_reb = {s: {k: digest(v[s:s + 1] if k in split else v)
                     for k, v in ckpt._flatten(emb)} for s in range(S)}
    bspec = synth_spec(cfg)
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         synth_batch(bspec, cfg.batch_size, 1, 99).items()}
    fb = model.features(b)
    dense = coll.dense_reference(emb, fb)
    emb, _, rows = coll.lookup(emb, fb)
    swaps, moves = rep.total_swaps, sum(reb.rebalance_moves.values())
    if not swaps or not moves or max(rep.cross_shard_rows.values()) > \
            REHOME_REFRESH["exchange_budget"]:
        raise AssertionError(f"{what}: swaps {rep}, re-homing {reb}")
    bsz = cfg.batch_size // D
    for r in res:
        at = f"{what} rank {r['rank']}"
        got_rep, got_reb = r["refresh_report"], r["rebalance_report"]
        if (got_rep["swaps"], got_rep["deferred_swaps"], got_rep["cross_shard_rows"],
                got_reb["rebalance_moves"]) != (rep.swaps, rep.deferred_swaps,
                                                rep.cross_shard_rows, reb.rebalance_moves):
            raise AssertionError(f"{at}: reports {got_rep} {got_reb} vs {rep} {reb}")
        for name, whole, mine in (("refresh", shard_after, r["refresh_after"]),
                                  ("rebalance", shard_reb, r["rebalance_after"])):
            want = whole[r["model_rank"]]
            bad = sorted(k for k in want if mine.get(k) != want[k])
            if bad or set(mine) != set(want):
                raise AssertionError(f"{at}: after the {name} pass, leaves not bitwise the "
                                     f"stacked layout's: {bad}")
        lo = r["data_rank"] * bsz
        for f in fb.features:
            if not (torch.equal(r["probe_dense"][f], dense[f][lo:lo + bsz].cpu())
                    and torch.equal(r["probe_rows"][f], rows[f][lo:lo + bsz].cpu())):
                raise AssertionError(f"{at}: lookup after the passes differs on {f}")
    _close(dict(state, emb=emb))
    del state, emb
    gc.collect()
    return swaps, moves, sum(rep.cross_shard_rows.values()), sum(rep.deferred_swaps.values())


def _rehome_cfg(S, vocab_scale=DIST_SCALE):
    return dataclasses.replace(_scaled(vocab_scale), model_shards=S, replicate_top_k=REP_K,
                               batch_size=DIST_BATCH, arena_precision="int8")


def dist_rehome_jobs(vocab_scale=DIST_SCALE, n_steps=DIST_STEPS):
    """19e's rank jobs, one a ``REHOME_SHAPES`` mesh (see
    :func:`dist_rehome_check`)."""
    return [dict(cfg=_rehome_cfg(S, vocab_scale), train=n_steps, flush=False, count=True,
                 # bitwise losses (D == 1) need deterministic mode; the passes are bitwise
                 # in either
                 deterministic=D == 1,
                 refresh=dict(cfg=REHOME_REFRESH, rebalance=0.0, digests=True, probe=99,
                              cool_head=True))
            for D, S in REHOME_SHAPES]


def dist_rehome_check(res_by_shape, dev, vocab_scale=DIST_SCALE, n_steps=DIST_STEPS):
    """19e: the refresh and the rebalance across ranks.  Gloo ranks sharing
    the card at each ``REHOME_SHAPES`` mesh (19b's cut: vocab scale 0.02,
    global batch 2 048, 3 steps; an int8-tiered arena over an fp32 host, so
    the rows the passes move out of the arena go through ``gather_decode``;
    K 2048; at ``(1, S)`` under ``deterministic()``) train, then make a refresh pass
    (``REHOME_REFRESH``: ``exchange_budget`` metering the cross-shard
    pairs; the replicated head made the coldest ranks first, so the pass
    demotes it and the head pulls the promoted rows from their owners) and
    a forced re-homing (threshold 0); the parent rebuilds the stacked
    layout from the ranks' state before the passes and makes the same
    passes.  Checks every rank's state after each pass (swaps, homes,
    rows, host slices, trackers) bitwise the stacked layout's shard, the
    reports equal, a lookup and ``dense_reference`` after the passes
    bitwise the stacked layout's on the replica's rows; each pass's
    ``gather_decode`` launches on every rank equal to the rounds of its
    moves out of the arena (the swaps' write-backs, the re-homing's flush;
    more than 0 in all), and no plan kernel inside a pass (the re-warm
    loads the hottest ranks with no plan); the losses bitwise the stacked
    layout's at ``(1, S)`` and within rtol 1e-5 of them at ``data > 1``, on
    the same global batches."""
    launches = {}
    for (D, S), res in zip(REHOME_SHAPES, res_by_shape):
        cfg = _rehome_cfg(S, vocab_scale)
        for r in res:
            for k in r["train_launches"]:
                launches[k] = launches.get(k, 0) + sum(
                    r[p][k] for p in ("train_launches", "refresh_launches", "rebalance_launches"))
        swaps, moves, cross, deferred = _rehome_check(res, cfg, D, S, dev, f"19e ({D}, {S})")
        with deterministic() if D == 1 else contextlib.nullcontext():
            _, st, losses, _ = _stacked_case(cfg, n_steps, dev)
        _close(st)
        del st
        gc.collect()
        for r in res:
            if not (np.allclose(r["losses"], losses, rtol=1e-5, atol=0)
                    and (D > 1 or r["losses"] == losses)):
                raise AssertionError(f"19e ({D}, {S}) rank {r['rank']}: losses {r['losses']} "
                                     f"vs the stacked layout's {losses}")
        rel = max(abs(a / b - 1) for a, b in zip(res[0]["losses"], losses))
        tol = (f"; losses {res[0]['losses']} " + (
            f"within rtol 1e-5 of the (1, {S}) layout's {losses} (max rel {rel})" if D > 1
            else "bitwise the stacked layout's"))
        log(f"19e ({D}, {S}): a refresh pass ({swaps} swaps, {deferred} deferred, {cross} "
            f"cross-shard rows of budget {REHOME_REFRESH['exchange_budget']}) and a forced "
            f"re-homing ({moves} ranks moved): every rank's state after each pass bitwise the "
            f"stacked layout's shard, the reports equal, the lookup and dense_reference after "
            f"them bitwise{tol}; gather_decode in the passes = their rounds out of the arena "
            f"(refresh {[r['refresh_rounds'] for r in res]}, re-homing "
            f"{[r['rebalance_rounds'] for r in res]}), no plan kernel in them; a rank's ms: "
            f"refresh {[r['refresh_ms'] for r in res]}, "
            f"re-homing {[r['rebalance_ms'] for r in res]}; the re-homing sent a rank "
            f"{[r['rebalance_traffic']['legs'] for r in res]} B")
    log(f"19e card: {card_line()}")
    return launches


def ranks_phase(dev, vocab_scale, n_batches, n_steps, stacked_counts, warm_index):
    """Phase 19's gloo ranks, one spawn a world size: every four-rank job
    (19a; 19b's 4-shard cases and its budget cases at ``(2, 2)``; 19d; 19f;
    19e at ``(2, 2)`` and ``(1, 4)``) runs in ONE world of four ranks
    sharing the card, each job on a fresh mesh of its own shape, then 19b's
    2-shard cases and its budget cases at ``(1, 2)`` in one world of two;
    the parent checks each phase's results after.  Each phase logs its
    seconds: its jobs on the slowest rank plus its checks here.  Returns
    each phase's launches (19b's budget and bag cases apart)."""
    import torch_rank_jobs as rank_jobs

    from repro_torch.dist import run

    ck_root = Path(ROOT) / "build" / "dist_ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    b4, b2 = dist_bitwise_jobs(4, ck_root), dist_bitwise_jobs(2, ck_root)
    four = {"19a": [dist_gloo_job(vocab_scale, n_batches, n_steps, warm_index)],
            "19b": b4[1] + b4[2], "19d": [dist_data_job(vocab_scale)],
            "19f": [budget_ranks_job(vocab_scale)], "19e": dist_rehome_jobs()}
    log(f"19: MemAvailable before spawning {mem_available_gb()} GB")
    worlds = {}
    for world, jobs in ((4, four), (2, {"19b": b2[1] + b2[2]})):
        flat = [j for js in jobs.values() for j in js]
        t0 = time.perf_counter()
        res = run.run_ranks(rank_jobs.dlrm_rank, world, "gloo", None, (flat,))
        worlds[world] = {}
        i = 0
        for phase, js in jobs.items():  # [job][rank]
            worlds[world][phase] = [[r[i + j] for r in res] for j in range(len(js))]
            i += len(js)
        log(f"19: the world of {world} gloo ranks ran {len(flat)} jobs in "
            f"{time.perf_counter() - t0} s (spawn, rendezvous and jobs; by phase, the jobs on "
            f"the slowest rank: "
            f"{ {p: sum(max(r['job_s'] for r in x) for x in v) for p, v in worlds[world].items()} })")

    def jobs_s(world, phase):
        return sum(max(r["job_s"] for r in x) for x in worlds[world][phase])

    out = {}
    t0 = time.perf_counter()
    out["19a"] = dist_gloo_check(worlds[4]["19a"][0], vocab_scale, n_batches, n_steps,
                                 stacked_counts)
    log(f"phase 19a: {jobs_s(4, '19a') + time.perf_counter() - t0} s (its job on the slowest "
        f"rank and its checks)")
    t0 = time.perf_counter()
    out["19b"], out["19b_budget"] = {}, {}
    for world, (cases, jobs, budget) in ((2, b2), (4, b4)):
        res = [[x[j] for x in worlds[world]["19b"]] for j in range(world)]  # [rank][job]
        got = dist_bitwise_check(cases, jobs, [r[:len(jobs)] for r in res], dev, ck_root)
        for k, v in got.items():
            out["19b"][k] = out["19b"].get(k, 0) + v
        got = _budget_bitwise_check([r[len(jobs):] for r in res], budget,
                                    world // BUDGET_SHARDS, dev, ck_root)
        for case, v in got.items():
            out["19b_budget"].setdefault(case, {})
            for k, n in v.items():
                out["19b_budget"][case][k] = out["19b_budget"][case].get(k, 0) + n
    shutil.rmtree(ck_root, ignore_errors=True)
    log(f"phase 19b: {jobs_s(2, '19b') + jobs_s(4, '19b') + time.perf_counter() - t0} s (its "
        f"jobs on the slowest rank of each world and its checks)")
    for phase, check in (("19d", dist_data_check), ("19f", budget_ranks_check)):
        t0 = time.perf_counter()
        out[phase] = check(worlds[4][phase][0], vocab_scale)
        log(f"phase {phase}: {jobs_s(4, phase) + time.perf_counter() - t0} s (its job on the "
            f"slowest rank and its checks)")
    t0 = time.perf_counter()
    out["19e"] = dist_rehome_check(worlds[4]["19e"], dev)
    log(f"phase 19e: {jobs_s(4, '19e') + time.perf_counter() - t0} s (its jobs on the slowest "
        f"rank and its checks)")
    return out


def synth_spec(cfg):
    from repro_torch.data import synth

    return synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)


def synth_batch(spec, batch, stream, step):
    from repro_torch.data import synth

    return synth.sparse_batch(spec, batch, stream, step)


def _route_composition(uniq, rank_owner, rank_local, rep_k, s):
    """What the sharded plan's one route_bucketize launch (``route_image``)
    replaced: the route's torch ops, then the bucketize kernel; the image."""
    from repro_torch.kernels.cache_ops import kernel

    return kernel.bucketize(*kernel.route_plain(uniq, rank_owner, rank_local, rep_k), s)


def time_bucketize(live, max_err, launches, fused_launches, floor=None):
    """On the first sharded plan's live router inputs: the route + bucketize
    kernel as the plan calls it (``route_image``, the image alone: CUDA-event,
    profiler device and host enqueue ms, one device op a call), its bound,
    its plain version and, in the same process, the composition it replaced
    (the route's torch ops, then the bucketize kernel) with its device ops,
    and the entry that also writes owner and local (event and enqueue ms);
    and the image-only bucketize kernel and its plain version on the live
    route's owner and local.  ``floor`` as in :func:`time_gather_decode`."""
    from repro_torch.kernels.cache_ops import kernel

    uniq, r_owner, r_local, rep_k, s = live
    owner, local, _ = kernel.route_bucketize_plain(*live)
    calls = {"route": lambda: kernel.route_image(*live),
             "composition": lambda: _route_composition(*live),
             "route_plain": lambda: kernel.route_image_plain(*live),
             "route_three": lambda: kernel.route_bucketize(*live),
             "kernel": lambda: kernel.bucketize(owner, local, s),
             "plain": lambda: kernel.bucketize_plain(owner, local, s)}
    enq, floors = {}, {}
    for n in ("route", "kernel", "route_three"):  # before any profiler window
        enq[n], floors[n] = _enqueue(calls[n], floor)
    enq["composition"] = host_ms(calls["composition"])
    ev = {n: cuda_ms(fn, iters=FUSED_EVENT_ITERS if n in ("route", "kernel", "route_three")
                     else 20)
          for n, fn in calls.items()}
    dv = {n: device_ms(calls[n])[0] for n in ("route", "composition", "kernel", "plain")}
    ops_r, by_r = device_ops(calls["route"])
    ops_c, by_c = device_ops(calls["composition"])
    if ops_r is not None and (ops_r != 1 or any("emset" in op for op in by_r)):
        raise AssertionError(f"route_bucketize: device ops {by_r}, want one kernel")
    u = uniq.numel()
    n_bytes = 2 * 4 * u + 4 * s * u  # owner and local read once, the image written once
    n_ops = 3 * s * u  # two compares and a select per output word
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / FP32_OPS_PER_S
    routed = int(((uniq >= max(rep_k, 0)) & (uniq < r_owner.numel())).sum())
    # uniq read, two 4 B table reads a routed lane, the image written
    r_bytes = 4 * u + 8 * routed + 4 * s * u
    r_sector = 4 * u + 2 * 32 * routed + 4 * s * u  # a 32 B sector a random read
    r_ops = 3 * s * u + 4 * u  # the image's, and the route's range checks and selects
    r_bound = max(1e3 * r_bytes / HBM_BYTES_PER_S, 1e3 * r_ops / FP32_OPS_PER_S)
    log(f"route_bucketize on the live router inputs (U {u}, {routed} routed, S {s}, rep_k "
        f"{rep_k}, tables of {r_owner.numel()}): event-timed ms kernel {ev['route']}, "
        f"composition (route ops + bucketize) {ev['composition']}, plain {ev['route_plain']}; "
        f"device ms kernel {dv['route']}, composition {dv['composition']}; host enqueue kernel "
        f"{enq['route']} ms (the launch floor {floors['route']} ms in alternating windows), "
        f"composition {enq['composition']} ms; device ops a call kernel {ops_r} "
        f"({json.dumps(by_r)}), composition {ops_c} ({json.dumps(by_c)}); bound {r_bound} ms "
        f"({r_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s; {1e3 * r_sector / HBM_BYTES_PER_S} ms "
        f"if each random table read costs a 32 B sector); the entry that also writes owner and "
        f"local: event-timed {ev['route_three']} ms, host enqueue {enq['route_three']} ms "
        f"(floor {floors['route_three']} ms)")
    log(f"bucketize on the live route's owner / local (U {u}, S {s}): event-timed ms kernel "
        f"{ev['kernel']}, plain {ev['plain']}; device ms kernel {dv['kernel']}, plain "
        f"{dv['plain']}; host enqueue {enq['kernel']} ms (the launch floor {floors['kernel']} "
        f"ms in alternating windows); bound {max(bytes_ms, ops_ms)} ms ({n_bytes} B "
        f"at {HBM_BYTES_PER_S / 1e12} TB/s: {bytes_ms} ms; {n_ops} int32 ops at the fp32 SIMT "
        f"rate {FP32_OPS_PER_S / 1e12} T/s: {ops_ms} ms)")
    image = {
        "name": "bucketize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/bucketize.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:131",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "fused_launches": sum(fused_launches.values()),
        "max_abs_err": max_err,
        "ms": ev["kernel"],
        "plain_ms": ev["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call builds the per-shard image
        "device_ms": dv["kernel"],
        "plain_device_ms": dv["plain"],
        "host_enqueue_ms": enq["kernel"],
        "floor_enqueue_ms": floors["kernel"],
        "enqueue_over_floor_ms": None if floor is None else enq["kernel"] - floors["kernel"],
        "lanes": u,
        "shards": s,
    }
    fused = {
        "name": "route_bucketize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/bucketize.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:131",
        "launches": sum(fused_launches.values()),
        "launches_by_path": fused_launches,
        "max_abs_err": max_err,
        "ms": ev["route"],
        "plain_ms": ev["route_plain"],
        "bound_ms": r_bound,
        "bound_by": "bytes" if 1e3 * r_bytes / HBM_BYTES_PER_S >= 1e3 * r_ops / FP32_OPS_PER_S
        else "operations",
        "library_ms": None,  # no single PyTorch call routes and builds the image
        "sector_bound_ms": 1e3 * r_sector / HBM_BYTES_PER_S,
        "device_ms": dv["route"],
        "host_enqueue_ms": enq["route"],
        "floor_enqueue_ms": floors["route"],
        "enqueue_over_floor_ms": None if floor is None else enq["route"] - floors["route"],
        "device_ops": ops_r,
        "composition": {"ms": ev["composition"], "device_ms": dv["composition"],
                        "host_enqueue_ms": enq["composition"], "device_ops": ops_c},
        "with_owner_local": {"ms": ev["route_three"], "host_enqueue_ms": enq["route_three"],
                             "floor_enqueue_ms": floors["route_three"]},
        "lanes": u,
        "routed": routed,
        "shards": s,
    }
    return image, fused


# ---------------------------------------------------------------------------
# phase 5c: the paper's device-budget mode (DEVICE + per-table CACHED slabs,
# int8 host tier)
# ---------------------------------------------------------------------------

BUDGET_BYTES = 1 << 30  # the budget phase's device budget at full width
BUDGET_CACHED = ("f2", "f3", "f11", "f15", "f20")  # what the planner caches at 1 GiB
INT8_ROW_BYTES = 128 + 8  # an int8 host row of dim 128: payload + (scale, zp)


def _budget_cfg(vocab_scale, batch_size=None):
    """The Criteo DLRM under a 1 GiB device budget with int8 host and arena
    codecs.  A cut vocabulary (or a cut ``batch_size``) gets the budget that
    holds the other 21 tables whole and the five at their own ratio, so the
    cut keeps the full-width placements."""
    from repro_torch.core.collection import PlacementPlanner
    from repro_torch.models.dlrm import DLRM

    cfg = dataclasses.replace(_scaled(vocab_scale), device_budget_bytes=BUDGET_BYTES,
                              host_precision="int8", arena_precision="int8")
    if batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    if vocab_scale != 1.0:  # the planner's own prices; no table is built
        price = PlacementPlanner(0, arena_precision="int8")
        budget = sum(price._fast_bytes(t, t.cache_ratio) if t.name in BUDGET_CACHED
                     else t.full_bytes for t in DLRM(cfg).collection.tables.values())
        cfg = dataclasses.replace(cfg, device_budget_bytes=budget)
        log(f"CUT: device budget {budget} B for the cut vocabularies")
    return cfg


class _MoveCounter:
    """Counts the lanes each ``cache.apply_plan`` moves (loads, and
    write-backs when the plan writes back), from the plans themselves: an
    independent check of the metrics' wire bytes."""

    def __init__(self):
        from repro_torch.core import cache as cache_lib

        self.lib, self.apply = cache_lib, cache_lib.apply_plan
        self.loaded = self.written = 0

    def __enter__(self):
        def counted(cfg, full, state, plan):
            self.loaded += int(plan.load_active.sum())
            if cfg.writeback:
                self.written += int(plan.evict_active.sum())
            return self.apply(cfg, full, state, plan)

        self.lib.apply_plan = counted
        return self

    def __exit__(self, *exc):
        self.lib.apply_plan = self.apply


def _exact_wire(m):
    return sum(int(m["host_moved_rows"][k]) * int(m["host_row_bytes"][k])
               for k in m["host_moved_rows"])


def budget_phase(dev, vocab_scale, n_batches, n_steps):
    """The paper's production mode at full Criteo width: 21 small tables
    DEVICE, the 5 large ones each in its own frequency-aware cache at ratio
    0.015 with an int8 tail, their host tier int8 (136 B a row) and pinned.
    Warm-up, ``--batches`` served batches, ``--train-steps`` train steps,
    one bag step over the mixed plan, flush; each path with the launch
    counts at 0 before it and read after it."""
    from repro_torch.core import collection as col
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel, ops
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.store.codec import get_codec

    cfg = _budget_cfg(vocab_scale)
    model = DLRM(cfg)
    coll = model.collection
    plan = coll.plan
    cached = sorted(coll.cached_slabs, key=lambda n: int(n[1:]))
    log(f"budget plan ({cfg.device_budget_bytes} B): {len(coll.device_slabs)} DEVICE "
        f"({sum(t.vocab for t in coll.device_slabs.values())} rows), {len(cached)} CACHED "
        f"{cached} ({sum(coll.cached_slabs[n].vocab for n in cached)} rows); placements "
        f"{json.dumps(plan.summary())}; ratios "
        f"{ {n: plan.placements[n].cache_ratio for n in cached} }")
    if not coll.device_slabs or not cached or col.SHARED_ARENA in coll.cached_slabs:
        raise AssertionError(f"want DEVICE and CACHED slabs only, got {plan.summary()}")
    if vocab_scale == 1.0 and (tuple(cached) != BUDGET_CACHED or len(coll.device_slabs) != 21
                               or {plan.placements[n].cache_ratio for n in cached} != {0.015}):
        raise AssertionError(f"the 1 GiB plan is not 21 DEVICE + {BUDGET_CACHED} at 0.015: "
                             f"{plan.summary()}")
    db = coll.device_bytes()
    log(f"budget device_bytes {json.dumps(db)}")
    if db["device_total"] > cfg.device_budget_bytes:
        raise AssertionError(f"device_total {db['device_total']} over the budget")

    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    slabs = state["emb"].slabs
    host = sum(slabs[n].full.host_bytes() for n in cached)
    fp32 = sum(slabs[n].full.fp32_equiv_bytes() for n in cached)
    rows = {slabs[n].full.row_wire_bytes() for n in cached}
    log(f"budget init+warmup {init_s} s: int8 host tier {host} B pinned="
        f"{all(slabs[n].full.pinned for n in cached)} against {fp32} B fp32 "
        f"({host / fp32}x), {rows} B a row; card memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9} GB; host RSS {rss_gb()} GB")
    if rows != {INT8_ROW_BYTES} or host * 512 != fp32 * INT8_ROW_BYTES:
        raise AssertionError(f"int8 host tier: {rows} B a row, {host} of {fp32} B")
    if dev.type == "cuda" and not all(slabs[n].full.pinned for n in cached):
        raise AssertionError("the int8 host tier is not pinned")

    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    serve_b = [synth.sparse_batch(bspec, cfg.batch_size, 0, i) for i in range(n_batches + 2)]
    train_b = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + 4)]

    def dev_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def counts_zero():
        kernel.victim_threshold.launches = 0
        kernel.gather_decode.launches = kernel.gather_decode.fused_launches = 0
        eb_kernel.embedding_bag_multi.launches = 0

    def counts():
        return (kernel.victim_threshold.launches, kernel.gather_decode.launches,
                eb_kernel.embedding_bag_multi.launches)

    # --- serve: read-only plans, one threshold launch per CACHED slab -------
    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad,
                         device=dev,
                         state_stats_fn=lambda st: coll.metrics(st["emb"], writeback=False))
    engine.score(serve_b[n_batches + 1])  # first call: allocator, cuBLAS
    engine.stats = type(engine.stats)()
    m0 = coll.metrics(engine.state["emb"], writeback=False)
    counts_zero()
    lat = []
    with _MoveCounter() as moved:
        for b in serve_b[:n_batches]:
            t0 = time.perf_counter()
            scores = engine.score(b)
            lat.append(1e3 * (time.perf_counter() - t0))
            if scores.shape != (cfg.batch_size,) or not np.isfinite(scores).all():
                raise AssertionError(f"budget serve scores: {scores.shape}, non-finite")
    serve_thr, serve_gd, _ = counts()
    m1 = coll.metrics(engine.state["emb"], writeback=False)
    serve_wire = _exact_wire(m1) - _exact_wire(m0)
    summary = engine.summary()
    if serve_thr != len(cached) * n_batches:
        raise AssertionError(f"budget serve: {serve_thr} threshold launches for {n_batches} "
                             f"plans of {len(cached)} CACHED slabs")
    if serve_wire != (moved.loaded + moved.written) * INT8_ROW_BYTES or moved.written:
        raise AssertionError(f"budget serve wire bytes {serve_wire} != ({moved.loaded} + "
                             f"{moved.written}) lanes x {INT8_ROW_BYTES} B")
    if int(m1["uniq_overflows"]):
        raise AssertionError("budget serve: unique-buffer overflow")
    log(f"budget serve: {n_batches} batches of {cfg.batch_size}; per-batch ms {lat}; p50 "
        f"{summary['p50_ms']} ms, p99 {summary['p99_ms']} ms (histogram bounds); threshold "
        f"launches {serve_thr} ({serve_thr / n_batches} a plan), gather_decode {serve_gd}; "
        f"wire bytes {serve_wire} = {moved.loaded} loaded lanes x {INT8_ROW_BYTES} B "
        f"({serve_wire / n_batches} a batch); hit rate {float(m1['hit_rate'])}")

    # --- the cache invariant: cached logits == logits from full_lookup rows --
    b = dev_batch(serve_b[n_batches])
    logits, emb = model.serve_step(engine.state, b)
    fb = model.features(b)
    ref_rows = {f: coll.full_lookup(emb, coll.feature_to_table[f], fb.ids[f])
                for f in fb.features}
    ref_logits = model.fwd(engine.state["params"], ref_rows, b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"budget: cached vs full_lookup logits differ by {diff}")
    log(f"budget cache invariant: max |cached - full_lookup| logit = {diff} (rtol {TOL_RTOL} "
        f"atol {TOL_ATOL})")
    state = dict(engine.state, emb=emb)
    for i in range(2):  # where a served batch's time goes, stage by stage with syncs
        b = dev_batch(serve_b[i])
        fb, _ = sync_ms(lambda: model.features(b))
        plan, t_plan = sync_ms(lambda: coll.plan_prepare(state["emb"], fb, writeback=False))
        emb, t_apply = sync_ms(lambda: coll.apply_plan(state["emb"], plan))
        rows, t_gather = sync_ms(lambda: coll.gather(coll.weights(emb), plan.addresses, fb))
        _, t_dense = sync_ms(lambda: model.fwd(state["params"], rows, b))
        state = dict(state, emb=emb)
        log(f"budget serve breakdown ms (synced): plan_prepare ({len(cached)} plans) {t_plan}, "
            f"apply_plan ({len(cached)} loads) {t_apply}, gather (26 slabs) {t_gather}, dense "
            f"{t_dense}")

    # --- train: write-backs encode on the card, in the gather (one
    # gather_decode_encode launch a round); then one bag step and flush ----
    state, m = model.train_step(state, dev_batch(train_b[n_steps + 1]))  # warm-up
    float(m["loss"])
    m0 = m
    captured = []
    impl = ops.arena_gather_encode_impl

    def capture(head, tail, sideband, slots, codec, host_codec):  # the first write-back's
        if not captured:
            captured.append((head.clone(), tail.clone(), sideband.clone(), slots.clone(), codec,
                             host_codec))
        return impl(head, tail, sideband, slots, codec, host_codec)

    counts_zero()
    step_ms, losses = [], []
    ops.arena_gather_encode_impl = capture
    try:
        with _MoveCounter() as moved:
            for i in range(n_steps):
                t0 = time.perf_counter()
                state, m = model.train_step(state, dev_batch(train_b[i]))
                losses.append(float(m["loss"]))
                step_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        ops.arena_gather_encode_impl = impl
    train_thr, train_gd, _ = counts()
    train_fused = kernel.gather_decode.fused_launches
    train_wire = _exact_wire(m) - _exact_wire(m0)
    ev = int(m["cache_evictions"]) - int(m0["cache_evictions"])
    if not np.isfinite(losses).all() or int(m["uniq_overflows"]):
        raise AssertionError(f"budget train: losses {losses}, overflows {int(m['uniq_overflows'])}")
    if train_thr != len(cached) * n_steps:
        raise AssertionError(f"budget train: {train_thr} threshold launches for {n_steps} "
                             f"plans of {len(cached)} CACHED slabs")
    if train_wire != (moved.loaded + moved.written) * INT8_ROW_BYTES or moved.written != ev:
        raise AssertionError(f"budget train wire bytes {train_wire} != ({moved.loaded} + "
                             f"{moved.written}) lanes x {INT8_ROW_BYTES} B ({ev} evictions)")
    if ev and not train_gd:
        raise AssertionError("budget train: write-backs ran no gather_decode launch")
    if train_fused != train_gd or not captured:
        raise AssertionError(f"budget train: {train_fused} of {train_gd} gather_decode launches "
                             f"encoded for the int8 host (want all)")
    live_err = check_gather_decode_encode(captured[0][:4], *captured[0][4:],
                                          "the first live int8 write-back")
    log(f"budget train: {n_steps} steps; losses {losses}; step ms {step_ms}; p50 "
        f"{np.percentile(step_ms, 50)} ms, p99 {np.percentile(step_ms, 99)} ms (numpy "
        f"percentiles); threshold launches {train_thr} ({train_thr / n_steps} a plan), "
        f"gather_decode {train_gd} ({train_gd / n_steps} a plan: one a write-back round of a "
        f"slab; {train_fused} of them gather_decode_encode into the int8 host, the first live "
        f"one [{captured[0][3].numel()} lanes] bitwise its plain version); wire bytes "
        f"{train_wire} = ({moved.loaded} loaded + {moved.written} written back) lanes x "
        f"{INT8_ROW_BYTES} B ({train_wire / n_steps} a step)")

    counts_zero()
    fb = bag_batch(model, dev, 0, np.random.default_rng(3))
    t0 = time.perf_counter()
    state, bag = bag_step(model, state, fb, "sum", torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    bag_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    state = model.flush(state)
    torch.cuda.synchronize()
    flush_ms = 1e3 * (time.perf_counter() - t0)
    bag_thr, bag_gd, bag_eb = counts()
    if kernel.gather_decode.fused_launches != bag_gd:
        raise AssertionError(f"budget bag step + flush: {kernel.gather_decode.fused_launches} of "
                             f"{bag_gd} gather_decode launches encoded for the int8 host")
    if bag_eb != bag["slabs"] or bag["slabs"] != len(coll.device_slabs) + len(cached):
        raise AssertionError(f"budget bag step: {bag_eb} embedding_bag launches for "
                             f"{bag['slabs']} slabs")
    log(f"budget bag step + flush: bag {bag_ms} ms ({bag_eb} embedding_bag launches, one per "
        f"slab; pooled output bitwise the per-slab plain version; kernel route = plain route "
        f"within 1e-5: pooled {bag['err']}, gradient {bag['grad_err']}), flush {flush_ms} ms; "
        f"threshold {bag_thr}, gather_decode {bag_gd} launches")

    # --- after the flush: each resident row's host payload and sideband are
    # the port's encode of the arena row, bitwise ---------------------------
    weights = coll.weights(state["emb"])
    int8 = get_codec("int8")
    resident_rows = 0
    for n in cached:
        slab = state["emb"].slabs[n]
        slots = torch.nonzero(slab.cache.slot_to_row >= 0)[:, 0]
        rows_idx = slab.cache.slot_to_row[slots].cpu().to(torch.int64)
        payload, side = int8.encode(weights[n][slots])
        if not (torch.equal(payload.cpu(), slab.full.data["weight"][rows_idx])
                and torch.equal(side.cpu(), slab.full.sideband["weight"][rows_idx])):
            raise AssertionError(f"budget post-flush: slab {n}'s host payload / sideband != "
                                 f"the encode of its arena rows")
        resident_rows += slots.numel()
    log(f"budget post-flush: all {resident_rows} resident rows of {len(cached)} CACHED slabs: "
        f"host payload and sideband bitwise the port's int8 encode of the arena row")

    for i in (n_steps + 2, n_steps + 3):  # where a train step's time goes
        b = dev_batch(train_b[i])
        plan, t_plan = sync_ms(lambda: model.plan_step(state, b))
        state, t_apply = sync_ms(lambda: model.apply_step(state, plan))
        (state, m), t_compute = sync_ms(lambda: model.compute_step(state, b, plan.addresses))
        log(f"budget train breakdown ms (synced, step {i}): plan_prepare ({len(cached)} plans) "
            f"{t_plan}, apply_plan ({len(cached)} write-backs + {len(cached)} loads) {t_apply}, "
            f"fwd+bwd+SGD+apply_grads {t_compute}; loss {float(m['loss'])}")
    stats = {}
    b = dev_batch(train_b[n_steps])
    profile_call("one budget train step", lambda: model.train_step(state, b), stats=stats)
    idle = 1 - stats["busy"] / stats["wall"] if stats else None
    log(f"budget idle share of one profiled train step: {idle}")
    for n in cached:
        state["emb"].slabs[n].full.close()
    return {"thr_launches": serve_thr + train_thr + bag_thr, "gd_launches": train_gd + bag_gd,
            "bag_launches": bag_eb, "captured": captured[0], "live_err": live_err}


# ---------------------------------------------------------------------------
# phase 5d: lookahead-pipelined training (PipelinedTrainer) at full width
# ---------------------------------------------------------------------------

PIPE_STEPS, PIPE_DEPTHS = 4, (1, 3)  # steps a run (9 before phase 19); the runs' depths


class InitSnapshot:
    """One ``model.init(0)`` of the fp32 Criteo DLRM (phases 5d and 5f) and a
    host copy of its every leaf: :meth:`restore` copies them back into the
    init's own tensors, in place, and returns that state, equal leaf for
    leaf to a fresh ``init(0)`` (the host table keeps its pin; a run that
    started from it updated the same tensors).  One full-width init in
    place of seven; the copy holds a second 17.3 GB in host memory."""

    def __init__(self, model, dev):
        from repro_torch.train import checkpoint as ckpt

        log(f"init snapshot: MemAvailable {mem_available_gb()} GB before")
        t0 = time.perf_counter()
        self.state = model.init(0, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.leaves = [(v, v.detach().clone()) for _, v in ckpt._flatten(self.state)]
        torch.cuda.synchronize()
        self.restores = 0
        log(f"init snapshot: init(0) {t1 - t0} s, its copy {time.perf_counter() - t1} s "
            f"({sum(c.numel() * c.element_size() for _, c in self.leaves) / 1e9} GB); "
            f"MemAvailable {mem_available_gb()} GB after")

    def restore(self):
        t0 = time.perf_counter()
        with torch.no_grad():
            for v, c in self.leaves:
                v.copy_(c)
        torch.cuda.synchronize()
        self.restores += 1
        log(f"init snapshot: restore {self.restores} in {time.perf_counter() - t0} s")
        return self.state

    def close(self):
        _close(self.state)
        self.leaves = self.state = None


def _group_profile(model, state, now, ahead, depth, census=False):
    """One steady-state group under the profiler: the next group's plan,
    the group's computes (each loss fetched, as the trainer's), then the
    next plan's apply.  ``now`` are the group's batches (planned and applied
    before the profile), ``ahead`` the next group's.  Depth 0 profiles one
    serial step: plan, apply, compute.  Returns the idle share."""
    stats = {}
    if depth == 0:
        def fn():
            plan = model.plan_step(state, now[0])
            st = model.apply_step(state, plan)
            return float(model.compute_step(st, now[0], plan.addresses)[1]["loss"])
    else:
        cur = model.plan_step(state, now[0], tuple(now[1:]))
        st0 = model.apply_step(state, cur)
        addrs = (cur.addresses,) + tuple(cur.future_addresses)

        def fn():
            nxt = model.plan_step(st0, ahead[0], tuple(ahead[1:]))
            st = st0
            for j, b in enumerate(now):
                st, m = model.compute_step(st, b, addrs[j])
                float(m["loss"])
            return model.apply_step(st, nxt)
    if census:  # the same group once more, under the sync census
        census_call(f"5d (one depth-{depth} pipelined group, each loss fetched)", fn)
    profile_call(f"one {'serial step' if depth == 0 else f'depth-{depth} group'}", fn,
                 stats=stats)
    return 1 - stats["busy"] / stats["wall"] if stats else None


def _train_run(model, depth, init_fn, make_batch, n_steps, dev, tracer, plans):
    """One training run of ``n_steps``: the serial ``Trainer`` (depth 0; its
    step split into the three stages under spans, bitwise ``train_step``)
    or the ``PipelinedTrainer`` at ``depth``.  ``plans`` receives each plan's
    ``future_unresident`` and window length.  Returns (state, history)."""
    from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

    def plan_fn(state, batch, future=()):
        plan = model.plan_step(state, batch, future)
        plans.append((plan.future_unresident, 1 + len(future)))
        return plan

    def step_fn(state, batch):
        with tracer.span("plan"):
            plan = plan_fn(state, batch)
        with tracer.span("apply"):
            state = model.apply_step(state, plan)
        with tracer.span("compute"):
            return model.compute_step(state, batch, plan.addresses)

    kw = dict(init_fn=init_fn, make_batch=make_batch, device=dev)
    if depth == 0:
        trainer = Trainer(TrainerConfig(max_steps=n_steps), step_fn=step_fn, **kw)
    else:
        trainer = PipelinedTrainer(TrainerConfig(max_steps=n_steps, pipeline_depth=depth),
                                   plan_fn=plan_fn, compute_fn=model.compute_step,
                                   apply_fn=model.apply_step, **kw)
    trainer.tracer = tracer
    return trainer.run(), trainer.history


def pipeline_phase(dev, vocab_scale, n_steps, snap):
    """The paper's DLRM (fp32 host tier and arena, ``use_pallas_plan``)
    trained by the serial ``Trainer`` and by the ``PipelinedTrainer`` at each
    depth of ``PIPE_DEPTHS``.  Each schedule first runs ``n_steps`` from
    ``init(0)`` under ``deterministic()`` (the counts at 0 before it and
    read after): losses and AUCs bitwise equal across the schedules,
    ``future_unresident`` 0, one threshold launch a plan; then continues
    ``n_steps`` more in the default mode, which gives its step times, the
    host ms of its stages and a profiled group's idle share (the
    deterministic sums take the card's slow sort-based path).  The
    depth-3 run's first lookahead key (kv = capacity) is held to the plain
    version and a stable argsort; after that schedule's flush every
    resident arena row is bitwise its host row.  Every schedule starts
    from ``snap``'s ``init(0)`` (:class:`InitSnapshot`), restored in place."""
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel, ops
    from repro_torch.models.dlrm import DLRM
    from repro_torch.obs import Tracer

    cfg = _scaled(vocab_scale)  # fp32 host tier and arena: pipelined = serial, bitwise
    model = DLRM(cfg)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    d_max = max(PIPE_DEPTHS)
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 2, i)
               for i in range(2 * n_steps + 2 * d_max)]

    def dev_batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}

    select = ops.victim_topk_impl
    captured = []

    def capture(key, kv):  # the first plan whose window lifts kv to the capacity
        if kv == spec.capacity and not captured:
            captured.append((key.clone(), kv))
        return select(key, kv)

    runs = {}
    for depth in (0, *PIPE_DEPTHS):
        name = "serial" if depth == 0 else f"depth {depth}"
        plans = []
        if depth == d_max:
            ops.victim_topk_impl = capture
        # --- main path: counts at 0, the checked run (init, warm-up, n_steps), counts read
        kernel.victim_threshold.launches = 0
        t0 = time.perf_counter()
        try:
            with deterministic():
                state, h = _train_run(model, depth, snap.restore, lambda s: batches[s],
                                      n_steps, dev, Tracer(), plans)
        finally:
            ops.victim_topk_impl = select
        run_s = time.perf_counter() - t0
        thr = kernel.victim_threshold.launches
        unresident = int(torch.stack([u.to(dev) for u, _ in plans]).sum())
        if len(h) != n_steps or not np.isfinite([r["loss"] for r in h]).all():
            raise AssertionError(f"pipelined {name}: {len(h)} steps, losses "
                                 f"{[r['loss'] for r in h]}")
        if unresident:
            raise AssertionError(f"pipelined {name}: future_unresident {unresident}")
        if thr != len(plans) or len(plans) != -(-n_steps // max(depth, 1)):
            raise AssertionError(f"pipelined {name}: {thr} threshold launches for "
                                 f"{len(plans)} plans of {n_steps} steps")
        det_ms = [1e3 * r["time_s"] for r in h]
        # --- the same schedule, n_steps more from that state, default mode: its times
        tracer, timed_plans = Tracer(), []
        kernel.victim_threshold.launches = 0
        state, ht = _train_run(model, depth, lambda: state, lambda s: batches[n_steps + s],
                               n_steps, dev, tracer, timed_plans)
        thr_t = kernel.victim_threshold.launches
        if thr_t != len(timed_plans) or not np.isfinite([r["loss"] for r in ht]).all():
            raise AssertionError(f"pipelined {name} (timed): {thr_t} threshold launches for "
                                 f"{len(timed_plans)} plans; losses {[r['loss'] for r in ht]}")
        step_ms = [1e3 * r["time_s"] for r in ht]
        stages = tracer.stage_summary()
        g = max(depth, 1)
        idle = _group_profile(model, state, [dev_batch(2 * n_steps + j) for j in range(g)],
                              [dev_batch(2 * n_steps + g + j) for j in range(g)], depth,
                              census=depth == d_max)
        runs[name] = {"losses": [r["loss"] for r in h], "aucs": [r["auc"] for r in h],
                      "thr": thr + thr_t, "idle": idle,
                      "stage_ms": {k: 1e3 * v["total_s"] / n_steps for k, v in stages.items()
                                   if k in ("plan", "apply", "compute")}}
        log(f"pipelined {name}: checked run ({n_steps} steps from init(0), deterministic) "
            f"{run_s} s with the {spec.vocab} x {spec.dim} fp32 table's restore; losses "
            f"{runs[name]['losses']}; its step ms {det_ms}; plans {len(plans)} (window lengths "
            f"{[n for _, n in plans]}: one a group), threshold launches {thr}, "
            f"future_unresident 0.  Timed run ({n_steps} more steps, default mode): step ms "
            f"{step_ms}; p50 {np.percentile(step_ms, 50)} ms, p99 {np.percentile(step_ms, 99)} "
            f"ms, mean {np.mean(step_ms)} ms (numpy, of {n_steps}); host ms a step by stage "
            f"{json.dumps(runs[name]['stage_ms'])} (span counts "
            f"{json.dumps({k: v['count'] for k, v in stages.items()})}); threshold launches "
            f"{thr_t}; idle share of one profiled group {idle}")
        if depth == d_max:
            t0 = time.perf_counter()
            state = model.flush(state)
            torch.cuda.synchronize()
            log(f"pipelined {name} flush {1e3 * (time.perf_counter() - t0)} ms")
            emb = state["emb"]
            check_resident(coll.weights(emb)[SHARED_ARENA],
                           emb.slabs[SHARED_ARENA].cache.slot_to_row,
                           emb.slabs[SHARED_ARENA].full, f"pipelined {name}")
        del state  # its table is the snapshot's: the next schedule restores it
        gc.collect()
    base = runs["serial"]
    for name, r in runs.items():
        if r["losses"] != base["losses"] or r["aucs"] != base["aucs"]:
            raise AssertionError(f"pipelined {name} != serial: losses {r['losses']} vs "
                                 f"{base['losses']}, aucs {r['aucs']} vs {base['aucs']}")
    if not captured:
        raise AssertionError(f"no depth-{d_max} plan selected kv = {spec.capacity}")
    key, kv = captured[0]
    err = check_threshold(key, kv, f"depth-{d_max} lookahead plan key")
    tiers = {"protected": int((key == -_BIG).sum()), "pinned": int((key == -(_BIG // 2)).sum()),
             "empty": int((key == _BIG).sum())}
    tiers["policy"] = key.numel() - sum(tiers.values())
    log(f"pipelined: losses and AUCs of the serial run and depths {list(PIPE_DEPTHS)} bitwise "
        f"equal; the depth-{d_max} lookahead key [{key.numel()}] at kv={kv}: kernel bitwise = "
        f"plain, victim order = stable argsort; key tiers {json.dumps(tiers)}")
    return {"thr_launches": {n: r["thr"] for n, r in runs.items()}, "key": key, "kv": kv,
            "thr_err": err}


# ---------------------------------------------------------------------------
# phase 5e: the sharded budget mode (per-device budget, int8 host tiers)
# ---------------------------------------------------------------------------


def sharded_budget_phase(dev, vocab_scale, n_batches, n_steps):
    """Phase 5c's plan (1 GiB a device, int8 host and arena) with every
    CACHED slab split over ``SHARDS`` shards (the card holds all four
    shards' arenas): serve ``n_batches``, train ``n_steps``, flush, each
    path with the counts at 0 before it and read after it.  Cached logits
    = ``dense_reference`` logits within the sharded bound; after the flush
    every resident row's host payload and sideband bitwise the int8 encode
    of its arena row, shard by shard.  Then phase 5g's re-homing on the
    flushed state (:func:`rebalance_on`)."""
    from repro_torch.core import collection as col
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.store.codec import get_codec

    cfg = dataclasses.replace(_budget_cfg(vocab_scale), model_shards=SHARDS)
    model = DLRM(cfg)
    coll = model.collection
    cached = sorted(coll.cached_slabs, key=lambda n: int(n[1:]))
    log(f"sharded budget plan ({cfg.device_budget_bytes} B a device, {SHARDS} shards): "
        f"{len(coll.device_slabs)} DEVICE {sorted(coll.device_slabs, key=lambda n: int(n[1:]))}, "
        f"{len(cached)} CACHED {cached}; placements {json.dumps(coll.plan.summary())}; shard "
        f"capacity {({n: coll.shard_capacity(coll.cached_slabs[n]) for n in cached})}")
    if not coll.device_slabs or not cached or col.SHARED_ARENA in coll.cached_slabs:
        raise AssertionError(f"want DEVICE and CACHED slabs only, got {coll.plan.summary()}")
    if vocab_scale == 1.0 and (tuple(cached) != BUDGET_CACHED or len(coll.device_slabs) != 21):
        raise AssertionError(f"the 1 GiB plan is not 21 DEVICE + {BUDGET_CACHED}")
    db = coll.device_bytes()
    log(f"sharded budget device_bytes {json.dumps(db)}")
    if db["device_per_shard"] > cfg.device_budget_bytes:
        raise AssertionError(f"device_per_shard {db['device_per_shard']} over the budget")
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slabs = state["emb"].slabs
    host = sum(slabs[n].full.host_bytes() for n in cached)
    log(f"sharded budget init+warmup {time.perf_counter() - t0} s: int8 host tiers {host} B "
        f"(payload [S, vs, 128] + sideband [S, vs, 2]) pinned="
        f"{all(slabs[n].full.pinned for n in cached)}; card memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9} GB; host RSS {rss_gb()} GB")
    if {slabs[n].full.sideband["weight"].shape[2] for n in cached} != {2}:
        raise AssertionError("the int8 sideband is not stacked [S, vs, 2]")

    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    serve_b = [synth.sparse_batch(bspec, cfg.batch_size, 0, i) for i in range(n_batches + 2)]
    train_b = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + 2)]

    def dev_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def counts_zero():
        kernel.victim_threshold.launches = kernel.bucketize.launches = 0
        kernel.gather_decode.launches = 0
        kernel.bucketize.fused_launches = kernel.gather_decode.fused_launches = 0

    def counts():
        return (kernel.victim_threshold.launches, kernel.bucketize.launches,
                kernel.gather_decode.launches)

    def fused_ok(what, bz, gd):  # every image routed in its launch, every write-back encoded
        fused = (kernel.bucketize.fused_launches, kernel.gather_decode.fused_launches)
        if fused != (bz, gd):
            raise AssertionError(f"sharded budget {what}: fused launches (route_bucketize, "
                                 f"gather_decode_encode) {fused} of {(bz, gd)}")

    per_plan = (SHARDS * len(cached), len(cached))  # threshold, bucketize
    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad,
                         device=dev,
                         state_stats_fn=lambda st: coll.metrics(st["emb"], writeback=False))
    engine.score(serve_b[n_batches + 1])  # first call: allocator, cuBLAS
    engine.stats = type(engine.stats)()
    # --- main path 1: serve --------------------------------------------------
    counts_zero()
    lat = []
    for b in serve_b[:n_batches]:
        t0 = time.perf_counter()
        scores = engine.score(b)
        lat.append(1e3 * (time.perf_counter() - t0))
        if scores.shape != (cfg.batch_size,) or not np.isfinite(scores).all():
            raise AssertionError(f"sharded budget serve scores: {scores.shape}, non-finite")
    serve_thr, serve_bz, serve_gd = counts()
    fused_ok("serve", serve_bz, serve_gd)
    if (serve_thr, serve_bz) != (per_plan[0] * n_batches, per_plan[1] * n_batches):
        raise AssertionError(f"sharded budget serve: threshold {serve_thr}, bucketize "
                             f"{serve_bz} for {n_batches} plans of {len(cached)} slabs x "
                             f"{SHARDS} shards")
    log(f"sharded budget serve: {n_batches} batches; per-batch ms {lat}; p50 "
        f"{np.percentile(lat, 50)} ms, p99 {np.percentile(lat, 99)} ms (numpy percentiles); "
        f"launches: threshold {serve_thr} ({serve_thr // n_batches} a plan), bucketize "
        f"{serve_bz} ({serve_bz // n_batches} a plan), gather_decode {serve_gd}")
    b = dev_batch(serve_b[n_batches])
    logits, emb = model.serve_step(engine.state, b)
    ref_logits = model.fwd(engine.state["params"], coll.dense_reference(emb, model.features(b)), b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"sharded budget: cached vs dense_reference logits differ by {diff}")
    log(f"sharded budget cache invariant: max |cached - dense_reference| logit = {diff} (rtol "
        f"{TOL_RTOL} atol {TOL_ATOL})")
    state = dict(engine.state, emb=emb)

    # --- main path 2: train (write-backs through the gather-decode kernel) ---
    state, m = model.train_step(state, dev_batch(train_b[n_steps]))  # warm-up
    float(m["loss"])
    counts_zero()
    step_ms, losses = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, m = model.train_step(state, dev_batch(train_b[i]))
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    train_thr, train_bz, train_gd = counts()
    fused_ok("train", train_bz, train_gd)
    if not np.isfinite(losses).all() or int(m["uniq_overflows"]):
        raise AssertionError(f"sharded budget train: losses {losses}, overflows "
                             f"{int(m['uniq_overflows'])}")
    if (train_thr, train_bz) != (per_plan[0] * n_steps, per_plan[1] * n_steps):
        raise AssertionError(f"sharded budget train: threshold {train_thr}, bucketize "
                             f"{train_bz} for {n_steps} plans")
    if int(m["cache_evictions"]) and not train_gd:
        raise AssertionError("sharded budget train: write-backs ran no gather_decode launch")
    log(f"sharded budget train: {n_steps} steps; losses {losses}; step ms {step_ms}; p50 "
        f"{np.percentile(step_ms, 50)} ms, p99 {np.percentile(step_ms, 99)} ms; launches: "
        f"threshold {train_thr}, bucketize {train_bz}, gather_decode {train_gd}; host wire "
        f"bytes {_exact_wire(m)} since init; exchange bytes {float(m['exchange_bytes'])}")
    stats = {}
    profile_call("one sharded budget train step",
                 lambda: model.train_step(state, dev_batch(train_b[n_steps + 1])), stats=stats)
    log(f"sharded budget idle share of one profiled train step: "
        f"{1 - stats['busy'] / stats['wall'] if stats else None}")

    # --- flush, then each resident row's host payload and sideband = the
    # int8 encode of its arena row, shard by shard ---------------------------
    counts_zero()
    t0 = time.perf_counter()
    state = model.flush(state)
    torch.cuda.synchronize()
    flush_ms = 1e3 * (time.perf_counter() - t0)
    _, _, flush_gd = counts()
    fused_ok("flush", 0, flush_gd)
    weights = coll.weights(state["emb"])
    int8 = get_codec("int8")
    resident = 0
    for n in cached:
        slab = state["emb"].slabs[n]
        for s in range(SHARDS):
            rows = slab.cache.slot_to_row[s]
            slots = torch.nonzero(rows >= 0)[:, 0]
            idx = rows[slots].cpu().to(torch.int64)
            payload, side = int8.encode(weights[n][s][slots])
            shard = slab.full.shard(s)
            if not (torch.equal(payload.cpu(), shard.data["weight"][idx])
                    and torch.equal(side.cpu(), shard.sideband["weight"][idx])):
                raise AssertionError(f"sharded budget post-flush: slab {n} shard {s}: host "
                                     f"payload / sideband != the encode of its arena rows")
            resident += slots.numel()
    log(f"sharded budget flush {flush_ms} ms ({flush_gd} gather_decode launches, all "
        f"gather_decode_encode); post-flush: all {resident} resident rows of {len(cached)} "
        f"slabs x {SHARDS} shards: host payload and sideband bitwise the int8 encode of the "
        f"arena row")
    t0 = time.perf_counter()
    rebalance, state = rebalance_on(model, state, dev)  # 5g's re-homing, on this state
    log(f"phase 5g (the re-homing, on 5e's state): {time.perf_counter() - t0} s")
    for n in cached:
        state["emb"].slabs[n].full.close()
    return {"thr_launches": serve_thr + train_thr, "bz_launches": serve_bz + train_bz,
            "gd_launches": serve_gd + train_gd + flush_gd, "rebalance": rebalance}


def sharded_pipelined_crosscheck(dev, vocab_scale=0.02, n_steps=6, depth=2):
    """The sharded DLRM (phase 5b's shape at ``vocab_scale``) trained by the
    serial ``Trainer`` and by the ``PipelinedTrainer`` at ``depth`` from one
    seed: losses bitwise equal; the bucketize kernel held bitwise to its
    plain version on a captured window image (a plan's second bucketize)."""
    from repro_torch.kernels.cache_ops import kernel, ops
    from repro_torch.data import synth
    from repro_torch.models.dlrm import DLRM
    from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

    cfg = _sharded_cfg(vocab_scale)
    model = DLRM(cfg)
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + depth)]
    impl, calls, window = ops.route_image_impl, [], []

    def capture(uniq, rank_owner, rank_local, rep_k, s):
        calls.append((uniq.clone(), rank_owner, rank_local, rep_k, s))
        return impl(uniq, rank_owner, rank_local, rep_k, s)

    def plan_fn(state, batch, future=()):
        calls.clear()
        plan = model.plan_step(state, batch, future)
        if future and not window:
            window.append(calls[1])  # the batch's image first, then the window's
        return plan

    kw = dict(init_fn=lambda: model.init(0, device=dev), make_batch=lambda s: batches[s],
              device=dev)
    runs = {}
    for name in ("serial", "pipelined"):
        if name == "serial":
            trainer = Trainer(TrainerConfig(max_steps=n_steps), step_fn=model.train_step, **kw)
        else:
            trainer = PipelinedTrainer(TrainerConfig(max_steps=n_steps, pipeline_depth=depth),
                                       plan_fn=plan_fn, compute_fn=model.compute_step,
                                       apply_fn=model.apply_step, **kw)
        ops.route_image_impl = capture
        kernel.bucketize.launches = kernel.victim_threshold.launches = 0
        kernel.bucketize.fused_launches = 0
        try:
            state = trainer.run()
        finally:
            ops.route_image_impl = impl
        runs[name] = {"losses": [h["loss"] for h in trainer.history],
                      "bz": kernel.bucketize.launches, "thr": kernel.victim_threshold.launches,
                      "bz_fused": kernel.bucketize.fused_launches}
        for slab in state["emb"].slabs.values():
            slab.full.close()
        del state
    if runs["serial"]["losses"] != runs["pipelined"]["losses"]:
        raise AssertionError(f"sharded pipelined != serial: {runs}")
    n_plans = -(-n_steps // depth)
    if runs["pipelined"]["bz"] != 2 * n_plans - (n_steps % depth == 1):
        raise AssertionError(f"sharded pipelined: {runs['pipelined']['bz']} bucketize launches "
                             f"for {n_plans} plans with a window")
    for name, r in runs.items():  # every image routed in its launch
        if r["bz_fused"] != r["bz"]:
            raise AssertionError(f"sharded {name}: {r['bz_fused']} of {r['bz']} bucketize "
                                 f"launches through route_bucketize")
    err = check_route_bucketize(*window[0], "captured window image")
    routed = int((kernel.route_bucketize_plain(*window[0])[1] >= 0).sum())
    log(f"sharded pipelined cross-check (vocab scale {vocab_scale}, depth {depth}, {n_steps} "
        f"steps): losses bitwise equal to the serial run {runs['serial']['losses']}; launches "
        f"serial bucketize {runs['serial']['bz']} / threshold {runs['serial']['thr']}, "
        f"pipelined {runs['pipelined']['bz']} / {runs['pipelined']['thr']} ({n_plans} plans, "
        f"two route + bucketize a plan with a window; all route_bucketize, serial "
        f"{runs['serial']['bz_fused']}, pipelined {runs['pipelined']['bz_fused']}); "
        f"route_bucketize bitwise = plain on the window image [{window[0][0].numel()} lanes, "
        f"{routed} routed]")
    return {"bz_launches": runs["pipelined"]["bz"], "thr_launches": runs["pipelined"]["thr"],
            "bz_fused": runs["pipelined"]["bz_fused"], "err": err}


# ---------------------------------------------------------------------------
# phases 5f-5h: the adaptive frequency refresh
# ---------------------------------------------------------------------------

# 5f: steps a run and the cadence (7 and 4 before phases 19d-19e, 9 and 4 before 19a-19c:
# at 3 a refresh still falls inside the serial run and at the depth-3 run's first boundary)
REFRESH_STEPS, REFRESH_INTERVAL = 5, 3
REFRESH_SERVE_BATCHES, REFRESH_EVERY = 3, 2  # 5f: served batches (4 before 19d, 8 before 19a)
REFRESH_DRIFT = 3  # 5f / 5g: steps per popularity phase of the drifting stream
SHARDED_SWAPS, EXCHANGE_BUDGET = 4096, 1024  # 5g: pairs a pass, cross-shard rows a pass
# 5h: benchmarks/bench_drift.py's shapes (vocab, dim, batch, drift_every,
# cache ratio, refresh every, max_swaps), and the JAX package's numbers
# for them on the CPU (scripts/drift_reference.py)
DRIFT_SHAPES = {"full": (400_000, 32, 8192, 150, 0.02, 5, 4096),
                "smoke": (20_000, 8, 512, 40, 0.04, 2, 512)}
DRIFT_REF = {
    "full": {"no_refresh": {"hit_pre": 0.9032432965687743, "hit_post": 0.8094591769303321,
                            "trough": 0.003651300775901415, "hits": 3050500, "misses": 579934,
                            "swaps": 0, "rows_moved": 0},
             "refresh": {"hit_pre": 0.8975456657322511, "hit_post": 0.8593567810784758,
                         "trough": 0.003227293683725219, "hits": 3138743, "misses": 507590,
                         "swaps": 20018, "rows_moved": 40036}},
    "smoke": {"no_refresh": {"hit_pre": 0.8636899273671534, "hit_post": 0.6959720375601564,
                             "trough": 0.004672897196261682, "hits": 44924, "misses": 14752,
                             "swaps": 0, "rows_moved": 0},
              "refresh": {"hit_pre": 0.8443856434828937, "hit_post": 0.7601471792967242,
                          "trough": 0.004672897196261682, "hits": 45994, "misses": 13762,
                          "swaps": 1472, "rows_moved": 2944}},
}


class _RefreshClock:
    """Synced host ms of the refresh's parts, by patching the functions it
    calls: ``plan`` (the tracker to the host, the numpy plan), ``surgery``
    (the write-back, invalidation, host-row permutation and remap),
    ``assign`` (``assign_devices`` on the live scores), ``rebalance`` (the
    re-homing surgery) and ``rewarm`` (each shard's cache warm-up)."""

    def __init__(self):
        from repro_torch.core import cache as cache_lib
        from repro_torch.core import refresh as refresh_lib
        from repro_torch.core.collection import PlacementPlanner

        self.targets = [(refresh_lib, n, p) for n, p in (
            ("plan_cached", "plan"), ("plan_sharded", "plan"), ("apply_swaps", "surgery"),
            ("apply_swaps_sharded", "surgery"), ("apply_rebalance", "rebalance"))]
        self.targets += [(PlacementPlanner, "assign_devices", "assign"),
                         (cache_lib, "warmup", "rewarm")]
        self.orig = [owner.__dict__[name] for owner, name, _ in self.targets]
        self.ms = {p: 0.0 for _, _, p in self.targets}

    def __enter__(self):
        for (owner, name, part), fn in zip(self.targets, self.orig):
            timed = self._timed(getattr(owner, name), part)
            setattr(owner, name, staticmethod(timed) if isinstance(fn, staticmethod) else timed)
        return self

    def _timed(self, fn, part):
        def timed(*a, **k):
            out, ms = sync_ms(lambda: fn(*a, **k))
            self.ms[part] += ms
            return out
        return timed

    def __exit__(self, *exc):
        for (owner, name, _), fn in zip(self.targets, self.orig):
            setattr(owner, name, fn)


class _PeakRSS:
    """The process's resident host memory, sampled every 5 ms by a thread
    while the block runs: its peak, GB."""

    def __enter__(self):
        import threading

        self.peak, self.stop = rss_gb(), threading.Event()

        def sample():
            while not self.stop.wait(0.005):
                self.peak = max(self.peak, rss_gb())

        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)
        self.peak = max(self.peak, rss_gb())


def _timed_refresh(coll, passes, **kw):
    """A trainer's / engine's ``refresh_fn`` over ``coll`` that logs each
    pass: swaps, rows moved, and its synced host ms split into planning and
    surgery."""
    def run(state):
        clock = _RefreshClock()
        with clock:
            (emb, rep), ms = sync_ms(lambda: coll.refresh(state["emb"], **kw))
        passes.append({"swaps": rep.total_swaps, "rows_moved": rep.total_rows_moved, "ms": ms,
                       "plan_ms": clock.ms["plan"], "surgery_ms": clock.ms["surgery"]})
        return dict(state, emb=emb)

    return run


def _drift_batches(cfg, n, seed):
    from repro_torch.data import synth

    spec = synth.DriftingZipfSpec(
        base=synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense),
        drift_every=REFRESH_DRIFT)
    return [synth.drifting_sparse_batch(spec, cfg.batch_size, seed, i) for i in range(n)]


def _close(state):
    for slab in state["emb"].slabs.values():
        if hasattr(slab, "full"):
            slab.full.close()


def _check_int8_flushed(coll, emb, slabs, what):
    """After a flush: every resident row's host payload and sideband are
    bitwise the int8 encode of its arena row (shard by shard when
    sharded).  Returns the rows checked."""
    from repro_torch.store.codec import get_codec

    int8 = get_codec("int8")
    weights = coll.weights(emb)
    n = 0
    for name in slabs:
        slab = emb.slabs[name]
        stacked = slab.cache.slot_to_row.dim() == 2
        for s in range(slab.cache.slot_to_row.shape[0] if stacked else 1):
            rows = slab.cache.slot_to_row[s] if stacked else slab.cache.slot_to_row
            arena = weights[name][s] if stacked else weights[name]
            host = slab.full.shard(s) if stacked else slab.full
            slots = torch.nonzero(rows >= 0)[:, 0]
            idx = rows[slots].cpu().to(torch.int64)
            payload, side = int8.encode(arena[slots])
            if not (torch.equal(payload.cpu(), host.data["weight"][idx])
                    and torch.equal(side.cpu(), host.sideband["weight"][idx])):
                raise AssertionError(f"{what}: slab {name}: host payload / sideband != the int8 "
                                     f"encode of its arena rows")
            n += slots.numel()
    if not n:
        raise AssertionError(f"{what}: no resident row to check")
    return n


@contextlib.contextmanager
def _host_writes(out):
    """Appends to ``out`` the name of each ``transmitter`` call made inside
    that writes rows into a host table."""
    from repro_torch.core import transmitter
    from repro_torch.store.host_store import HostStore

    move, write = transmitter.move_rows, transmitter.write_rows

    def move_rows(src, dst, *a, **k):
        if isinstance(dst, HostStore):
            out.append("move_rows")
        return move(src, dst, *a, **k)

    def write_rows(rows, dst, *a, **k):
        if isinstance(dst, HostStore):
            out.append("write_rows")
        return write(rows, dst, *a, **k)

    transmitter.move_rows, transmitter.write_rows = move_rows, write_rows
    try:
        yield out
    finally:
        transmitter.move_rows, transmitter.write_rows = move, write


def refresh_phase(dev, vocab_scale, snap, n_steps=REFRESH_STEPS, n_serve=REFRESH_SERVE_BATCHES):
    """5f: the unsharded refresh at full width, on a drifting stream.
    Serving: an engine with ``refresh_every`` 2 against one without, scores
    bitwise batch by batch.  Training (fp32 host tier and arena, phase
    5d's DLRM): ``refresh_interval`` 4 against none, and the depth-3
    ``PipelinedTrainer`` with the interval against the serial run with it,
    each from ``init(0)`` (``snap``, phase 5d's :class:`InitSnapshot`,
    restored) under ``deterministic()``: losses bitwise; then
    the serial run with the interval goes on in the default mode for its
    step times and each pass's planning and surgery ms.  Last the int8
    host tier and arena: training with the interval (dirty refreshes,
    their write-backs through the gather-decode kernel), a flush (host
    payload and sideband = the int8 encode of each resident arena row),
    then a refresh of the clean state (``dense_reference`` bitwise)."""
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

    cfg = _scaled(vocab_scale)
    model = DLRM(cfg)
    coll = model.collection
    batches = _drift_batches(cfg, 2 * n_steps + n_serve, 3)
    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    launches = {}

    # --- serving: refresh_every 2 against no refresh, batch by batch -------
    served, first_hits = {}, {}
    state = snap.restore()
    # serving with writeback=False and no refresh writes nothing to the host table
    # (checked: no row move into it), so the refreshing engine starts from the same
    # init: its device leaves restored (checked, and its first batch's hits and misses
    # are the first engine's)
    init_leaves = {k: v.clone() for k, v in ckpt._flatten(state) if ".full." not in k}
    for every in (None, REFRESH_EVERY):
        passes = []
        if every:
            for k, v in ckpt._flatten(state):
                if k in init_leaves:
                    v.copy_(init_leaves[k])
            restored = dict(ckpt._flatten(state))
            bad = sorted(k for k, v in init_leaves.items() if not torch.equal(restored[k], v))
            if bad or {k for k in restored if ".full." not in k} != set(init_leaves):
                raise AssertionError(f"refresh serve: device leaves not restored to the init: "
                                     f"{bad}")
        engine = ServeEngine(
            model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad, device=dev,
            state_stats_fn=lambda s: coll.metrics(s["emb"], writeback=False),
            refresh_fn=_timed_refresh(coll, passes, writeback=False) if every else None,
            refresh_every=every)
        kernel.victim_threshold.launches = 0
        scores, lat, host_writes = [], [], []
        with _host_writes(host_writes):
            for i, b in enumerate(batches[:n_serve]):
                t0 = time.perf_counter()
                scores.append(engine.score(b))
                lat.append(1e3 * (time.perf_counter() - t0))
                if i == 0:  # after the clock: the counters' fetch
                    m = coll.metrics(engine.state["emb"], writeback=False)
                    first_hits[every] = (int(sum(m["slab_hits"].values())),
                                        int(m["cache_misses"]))
        thr = kernel.victim_threshold.launches
        if not every and host_writes:
            raise AssertionError(f"refresh serve: serving with writeback=False wrote into the "
                                 f"host table ({host_writes})")
        summary = engine.summary()
        if every:  # the table is the snapshot's: the training runs restore it
            del state, init_leaves
        del engine
        gc.collect()
        if thr != n_serve or not all(np.isfinite(s).all() for s in scores):
            raise AssertionError(f"refresh serve (every {every}): {thr} threshold launches for "
                                 f"{n_serve} plans, or non-finite scores")
        served[every] = scores
        if every:
            launches["serve"] = thr
            if len(passes) != n_serve // every or summary["refresh_swaps"] <= 0:
                raise AssertionError(f"refresh serve: {len(passes)} passes, swaps "
                                     f"{summary['refresh_swaps']}")
            log(f"refresh serve (refresh_every {every}, writeback=False): per-batch ms {lat} "
                f"(score calls; the refresh runs after the call returns); passes {passes}; "
                f"hit rate {summary['hit_rate']}, refresh swaps {summary['refresh_swaps']}, "
                f"rows moved {summary['refresh_rows_moved']}; threshold launches {thr}")
        else:
            log(f"refresh serve (no refresh): per-batch ms {lat}; hit rate {summary['hit_rate']}")
    for i, (a, b) in enumerate(zip(served[None], served[REFRESH_EVERY])):
        if not np.array_equal(a, b):
            raise AssertionError(f"refresh serve: batch {i} scores differ (max |diff| "
                                 f"{np.abs(a - b).max()})")
    if first_hits[None] != first_hits[REFRESH_EVERY]:
        raise AssertionError(f"refresh serve: the engines' first batches (hits, misses) "
                             f"{first_hits} differ: they did not start from one state")
    log(f"refresh serve: scores of all {n_serve} batches bitwise equal with and without the "
        f"refresh; no host row written by the first engine; both started from the init "
        f"(first batch's hits, misses {first_hits[None]})")

    # --- training: deterministic runs, losses bitwise -------------------------
    def train(depth, interval, passes, init_fn, offset, steps):
        kw = dict(init_fn=init_fn, make_batch=lambda s: batches[offset + s], device=dev,
                  refresh_fn=_timed_refresh(coll, passes) if interval else None)
        tc = TrainerConfig(max_steps=steps, pipeline_depth=depth, refresh_interval=interval)
        if depth:
            tr = PipelinedTrainer(tc, plan_fn=model.plan_step, compute_fn=model.compute_step,
                                  apply_fn=model.apply_step, **kw)
        else:
            tr = Trainer(tc, step_fn=model.train_step, **kw)
        return tr.run(), tr.history

    runs = {}
    for name, depth, interval in (("serial", 0, None), ("serial+refresh", 0, REFRESH_INTERVAL),
                                  ("depth 3+refresh", 3, REFRESH_INTERVAL)):
        passes = []
        kernel.victim_threshold.launches = 0
        t0 = time.perf_counter()
        with deterministic():
            state, h = train(depth, interval, passes, snap.restore, 0, n_steps)
        thr = kernel.victim_threshold.launches
        runs[name] = [r["loss"] for r in h]
        if len(h) != n_steps or not np.isfinite(runs[name]).all():
            raise AssertionError(f"refresh train {name}: losses {runs[name]}")
        if interval and (not passes or h[-1]["refresh_swaps"] <= 0):
            raise AssertionError(f"refresh train {name}: passes {passes}")
        if interval:
            launches["train" if not depth else "pipelined"] = thr
        if not thr:
            raise AssertionError(f"refresh train {name}: no threshold launch")
        log(f"refresh train {name} ({n_steps} steps from init(0), deterministic, "
            f"{time.perf_counter() - t0} s with the init): losses {runs[name]}; passes {passes}; "
            f"threshold launches {thr}")
        if name == "serial+refresh":  # n_steps more in the default mode: the times
            passes = []
            kernel.victim_threshold.launches = 0
            state, ht = train(0, REFRESH_INTERVAL, passes, lambda: state, n_steps, n_steps)
            launches["train_timed"] = kernel.victim_threshold.launches
            step_ms = [1e3 * r["time_s"] for r in ht]
            log(f"refresh train timed (default mode, {n_steps} more steps, refresh_interval "
                f"{REFRESH_INTERVAL}): step ms {step_ms}; p50 {np.percentile(step_ms, 50)} ms, "
                f"p99 {np.percentile(step_ms, 99)} ms (numpy, of {n_steps}; a pass runs between "
                f"steps, outside the step clock); passes (swaps, rows moved, host ms = plan + "
                f"surgery): {passes}; threshold launches {launches['train_timed']}")
        del state  # its table is the snapshot's
        gc.collect()
    if runs["serial+refresh"] != runs["serial"]:
        raise AssertionError(f"refresh train: losses with the refresh {runs['serial+refresh']} "
                             f"!= without {runs['serial']}")
    if runs["depth 3+refresh"] != runs["serial+refresh"]:
        raise AssertionError(f"refresh train: depth-3 losses {runs['depth 3+refresh']} != "
                             f"serial {runs['serial+refresh']}")
    log(f"refresh train: losses with refresh_interval {REFRESH_INTERVAL} bitwise those without, "
        f"and the depth-3 pipelined run's bitwise the serial run's (deterministic)")

    # --- the int8 host tier and arena: dirty refreshes, flush, clean refresh
    cfg8 = dataclasses.replace(cfg, host_precision="int8", arena_precision="int8")
    model8 = DLRM(cfg8)
    coll8 = model8.collection
    passes = []
    kernel.victim_threshold.launches = kernel.gather_decode.launches = 0
    kernel.gather_decode.fused_launches = 0
    tr = Trainer(TrainerConfig(max_steps=n_steps, refresh_interval=REFRESH_INTERVAL),
                 init_fn=lambda: model8.init(0, device=dev), step_fn=model8.train_step,
                 make_batch=lambda s: batches[s], device=dev,
                 refresh_fn=_timed_refresh(coll8, passes))
    state = tr.run()
    losses = [r["loss"] for r in tr.history]
    state = model8.flush(state)
    torch.cuda.synchronize()
    n_checked = _check_int8_flushed(coll8, state["emb"], [SHARED_ARENA], "refresh int8")
    probe = model8.features({k: torch.from_numpy(v).to(dev)
                             for k, v in batches[n_steps + 1].items()})
    before = coll8.dense_reference(state["emb"], probe)
    clock = _RefreshClock()
    with clock:
        emb, rep = coll8.refresh(state["emb"])
    emb = coll8.flush(emb)
    after = coll8.dense_reference(emb, probe)
    launches["int8_thr"] = kernel.victim_threshold.launches
    launches["int8_gd"] = kernel.gather_decode.launches
    launches["int8_gd_fused"] = kernel.gather_decode.fused_launches
    if launches["int8_gd_fused"] != launches["int8_gd"]:
        raise AssertionError(f"refresh int8: {launches['int8_gd_fused']} of "
                             f"{launches['int8_gd']} write-backs encoded in the gather")
    if not np.isfinite(losses).all() or not passes or rep.total_swaps <= 0:
        raise AssertionError(f"refresh int8: losses {losses}, passes {passes}, clean pass "
                             f"{rep.total_swaps} swaps")
    if not all(torch.equal(before[f], after[f]) for f in before):
        raise AssertionError("refresh int8: dense_reference changed across a clean refresh")
    if not launches["int8_gd"]:
        raise AssertionError("refresh int8: the write-backs ran no gather_decode launch")
    log(f"refresh int8 (int8 host tier and arena, refresh_interval {REFRESH_INTERVAL}, "
        f"{n_steps} steps, default mode): losses {losses}; dirty passes {passes}; after the "
        f"flush all {n_checked} resident rows' host payload and sideband bitwise the int8 "
        f"encode of the arena row; a clean refresh ({rep.total_swaps} swaps, plan "
        f"{clock.ms['plan']} ms, surgery {clock.ms['surgery']} ms) leaves dense_reference "
        f"bitwise; launches threshold {launches['int8_thr']}, gather_decode "
        f"{launches['int8_gd']} (all gather_decode_encode into the int8 host)")
    _close(dict(state, emb=emb))
    del state, emb
    gc.collect()
    return launches


SH_REFRESH_STEPS, SH_AFTER_STEPS = 3, 1  # 5g: steps before a pass and after it (4 and 2 before 19d)


def sharded_refresh_phase(dev, vocab_scale, n_steps=SH_REFRESH_STEPS):
    """5g: phase 5b's fp32 4-shard DLRM trained on the drifting stream, a
    refresh with ``exchange_budget`` (``dense_reference`` after a flush
    bitwise before and after; cross-shard rows within the budget; swaps +
    deferred = the unbudgeted plan's swaps), then two steps planned over
    the swapped homes.  (The re-homing of phase 5e's sharded budget mode
    runs on 5e's flushed state: :func:`rebalance_on`.)"""
    from repro_torch.core import refresh as refresh_lib
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM

    def counts_zero():
        kernel.victim_threshold.launches = kernel.bucketize.launches = 0
        kernel.gather_decode.launches = 0
        kernel.bucketize.fused_launches = kernel.gather_decode.fused_launches = 0

    def counts():
        return {"thr": kernel.victim_threshold.launches, "bz": kernel.bucketize.launches,
                "gd": kernel.gather_decode.launches, "bz_fused": kernel.bucketize.fused_launches,
                "gd_fused": kernel.gather_decode.fused_launches}

    def dev_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def steps(model, state, bs):
        losses = []
        for b in bs:
            state, m = model.train_step(state, dev_batch(b))
            losses.append(float(m["loss"]))
        if not np.isfinite(losses).all() or int(m["uniq_overflows"]):
            raise AssertionError(f"sharded refresh: losses {losses}")
        return state, losses

    out = {}
    # --- the fp32 4-shard DLRM: a budgeted exchange ---------------------------
    cfg = _sharded_cfg(vocab_scale)
    model = DLRM(cfg)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    batches = _drift_batches(cfg, n_steps + 3, 4)
    counts_zero()
    state = model.init(0, device=dev)
    state, losses = steps(model, state, batches[:n_steps])
    state = model.flush(state)
    probe = model.features(dev_batch(batches[n_steps + 2]))
    before = coll.dense_reference(state["emb"], probe)
    ccfg = coll.shard_cache_config(spec)
    slab = state["emb"].slabs[SHARED_ARENA]
    unb = refresh_lib.plan_sharded(ccfg, slab, refresh_lib.RefreshConfig(max_swaps=SHARDED_SWAPS),
                                   *refresh_lib.homes(slab))[0].size
    del slab
    clock = _RefreshClock()
    with clock:
        (emb, rep), ms = sync_ms(lambda: coll.refresh(state["emb"], refresh_lib.RefreshConfig(
            max_swaps=SHARDED_SWAPS, exchange_budget=EXCHANGE_BUDGET)))
    emb = coll.flush(emb)
    after = coll.dense_reference(emb, probe)
    swaps, deferred = rep.swaps[SHARED_ARENA], rep.deferred_swaps[SHARED_ARENA]
    cross = rep.cross_shard_rows[SHARED_ARENA]
    if not all(torch.equal(before[f], after[f]) for f in before):
        raise AssertionError("sharded refresh: dense_reference changed across the refresh")
    if cross > EXCHANGE_BUDGET or swaps + deferred != unb or not swaps:
        raise AssertionError(f"sharded refresh: {swaps} swaps + {deferred} deferred vs {unb} "
                             f"unbudgeted; cross-shard rows {cross} of {EXCHANGE_BUDGET}")
    state, after_losses = steps(model, dict(state, emb=emb),
                                batches[n_steps:n_steps + SH_AFTER_STEPS])
    out["sharded"] = counts()
    if not (out["sharded"]["thr"] and out["sharded"]["bz"]) or (
            out["sharded"]["bz_fused"] != out["sharded"]["bz"]):
        raise AssertionError(f"sharded refresh: launches {out['sharded']}")
    log(f"sharded refresh (fp32, {SHARDS} shards, replicate_top_k {REP_K}): {n_steps} train "
        f"steps on the drifting stream (losses {losses}), flush, one pass at max_swaps "
        f"{SHARDED_SWAPS} with exchange_budget {EXCHANGE_BUDGET}: {swaps} swaps ({deferred} "
        f"deferred; the unbudgeted plan {unb}), {rep.rows_moved[SHARED_ARENA]} rows moved, "
        f"{cross} cross-shard rows; {ms} ms (plan {clock.ms['plan']}, surgery "
        f"{clock.ms['surgery']}); dense_reference bitwise before and after; {SH_AFTER_STEPS} "
        f"step(s) after it (losses {after_losses}); launches {out['sharded']}")
    _close(state)
    del state, emb
    gc.collect()

    return out


def rebalance_on(model, state, dev):
    """5g's re-homing, on phase 5e's flushed state (the sharded budget mode,
    int8 host and arena, 4 shards stacked): a re-homing pass (no swaps)
    with ``rebalance_threshold`` the median slab's live imbalance: the live
    imbalance before and after, the moves, the host RSS peak;
    ``dense_reference`` bitwise before and after, served logits over the
    new homes = ``dense_reference`` logits; then ``SH_AFTER_STEPS`` steps
    over the new homes on the drifting stream.  The launches from the pass
    on.  Returns them and the state."""
    from repro_torch.core import refresh as refresh_lib
    from repro_torch.kernels.cache_ops import kernel

    coll, cfg = model.collection, model.cfg
    cached = sorted(coll.cached_slabs, key=lambda n: int(n[1:]))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in _drift_batches(cfg, SH_AFTER_STEPS + 1, 5)]
    kernel.victim_threshold.launches = kernel.bucketize.launches = 0
    kernel.gather_decode.launches = 0
    kernel.bucketize.fused_launches = kernel.gather_decode.fused_launches = 0
    b = batches[SH_AFTER_STEPS]
    fb = model.features(b)
    before = coll.dense_reference(state["emb"], fb)
    imb0 = {n: _live_imbalance(coll, state["emb"], n) for n in cached}
    # the threshold: the median slab's live imbalance, so the slabs above it
    # are re-homed and the others are not
    threshold = float(np.median(list(imb0.values())))
    owners0 = {n: state["emb"].slabs[n].rank_owner.clone() for n in cached}
    rss0 = rss_gb()
    clock = _RefreshClock()
    with clock, _PeakRSS() as rss:
        (emb, rep), ms = sync_ms(lambda: coll.refresh(state["emb"], refresh_lib.RefreshConfig(
            max_swaps=0, rebalance_threshold=threshold)))
    imb1 = {n: _live_imbalance(coll, emb, n) for n in cached}
    after = coll.dense_reference(emb, fb)
    logits, emb = model.serve_step(dict(state, emb=emb), b)
    ref_logits = model.fwd(state["params"], after, b)
    diff = float((logits - ref_logits).abs().max())
    moved = {n: rep.rebalance_moves[n] for n in cached}
    over = [n for n in cached if imb0[n] > threshold]
    if rep.rebalance_imbalance != imb0:
        raise AssertionError(f"rebalance measured {rep.rebalance_imbalance}, not {imb0}")
    if not over or any(not moved[n] for n in over) or any(moved[n] for n in cached
                                                          if n not in over):
        raise AssertionError(f"rebalance: imbalance {rep.rebalance_imbalance}, moves {moved}")
    if any(torch.equal(owners0[n], emb.slabs[n].rank_owner) or imb1[n] >= imb0[n]
           for n in over):
        raise AssertionError(f"rebalance: homes or imbalance unchanged: {imb0} -> {imb1}")
    if not all(torch.equal(before[f], after[f]) for f in before):
        raise AssertionError("rebalance: dense_reference changed across the re-homing")
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"rebalance: cached vs dense_reference logits differ by {diff}")
    state = dict(state, emb=emb)
    after_losses = []
    for bt in batches[:SH_AFTER_STEPS]:
        state, m = model.train_step(state, bt)
        after_losses.append(float(m["loss"]))
    if not np.isfinite(after_losses).all() or int(m["uniq_overflows"]):
        raise AssertionError(f"rebalance: losses after it {after_losses}")
    r = {"thr": kernel.victim_threshold.launches, "bz": kernel.bucketize.launches,
         "gd": kernel.gather_decode.launches, "bz_fused": kernel.bucketize.fused_launches,
         "gd_fused": kernel.gather_decode.fused_launches}
    if not all(r.values()) or (r["bz_fused"], r["gd_fused"]) != (r["bz"], r["gd"]):
        raise AssertionError(f"rebalance: launches {r}")
    log(f"rebalance (5e's flushed state: sharded budget mode, int8 host and arena, {SHARDS} "
        f"shards, {len(cached)} CACHED slabs, threshold {threshold}, the median slab's): "
        f"per-slab live imbalance {rep.rebalance_imbalance}, moves {moved}, live imbalance by "
        f"slab {imb0} -> {imb1}; {ms} ms (swap plan {clock.ms['plan']}, assign_devices "
        f"{clock.ms['assign']}, re-homing surgery {clock.ms['rebalance']}, re-warm "
        f"{clock.ms['rewarm']}); host RSS {rss0} GB before, peak {rss.peak} GB during (sampled "
        f"every 5 ms); dense_reference bitwise before and after; served logits over the new "
        f"homes = dense_reference logits (max |diff| {diff}); {SH_AFTER_STEPS} step(s) after "
        f"it on the drifting stream (losses {after_losses}); launches from the pass on {r}")
    return r, state


def _live_imbalance(coll, emb, name):
    """A sharded slab's live routed imbalance as the rebalance measures it:
    max / mean of the shards' decayed tracker mass, replicated ranks out."""
    from repro_torch.core import refresh as refresh_lib

    slab = emb.slabs[name]
    K = slab.rep.rows.shape[0]
    owner, local = refresh_lib.homes(slab)
    scores = refresh_lib.sharded_scores(slab, coll.cached_slabs[name].arena.freq_half_life,
                                        owner, local)
    load = np.zeros((coll.num_shards,), np.float64)
    np.add.at(load, owner[K:], scores[K:])
    return float(load.max() / load.mean()) if load.mean() > 0 else 1.0


def drift_phase(dev, shape="full"):
    """5h: ``benchmarks/bench_drift.py``'s run in the port: a drifting Zipf
    stream through one cached table, with and without a refresh every few
    steps, each from the same init; the plans take the threshold kernel
    (``use_pallas_plan``, bitwise the argsort route).  Hit and miss counts,
    swaps, rows moved and the hit rates equal the JAX package's on the CPU
    (``DRIFT_REF``)."""
    from repro_torch.core import collection as col
    from repro_torch.core.refresh import RefreshConfig
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel

    vocab, dim, batch, drift_every, ratio, every, max_swaps = DRIFT_SHAPES[shape]
    spec = synth.DriftingZipfSpec(base=synth.ZipfSparseSpec(vocab_sizes=(vocab,)),
                                  drift_every=drift_every)
    table = col.TableConfig("items", vocab, dim, ids_per_step=batch, cache_ratio=ratio,
                            freq_half_life=max(drift_every // 8, 1))
    ids = [synth.drifting_sparse_batch(spec, batch, 0, s)["sparse"] for s in range(3 * drift_every)]
    counts = np.zeros((vocab,), np.int64)
    for s in range(drift_every):
        np.add.at(counts, ids[s].reshape(-1), 1)
    res, launches = {}, {}
    for mode in ("no_refresh", "refresh"):
        coll = col.EmbeddingCollection.create([table], cache_ratio=ratio, use_pallas_plan=True)
        state = coll.init(0, counts={"items": counts}, device=dev)
        kernel.victim_threshold.launches = 0
        hits, misses, step_ms, refresh_ms = [], [], [], []
        for s in range(3 * drift_every):
            fb = col.FeatureBatch.from_onehot(("items",), torch.from_numpy(ids[s]).to(dev))
            t0 = time.perf_counter()
            state, _ = coll.prepare(state, fb)
            c = state.slabs[col.SHARED_ARENA].cache
            h, m = (int(x) for x in torch.stack([c.hits, c.misses]).cpu())
            step_ms.append(1e3 * (time.perf_counter() - t0))
            hits.append(h)
            misses.append(m)
            if mode == "refresh" and (s + 1) % every == 0:
                (state, _), ms = sync_ms(lambda: coll.refresh(
                    state, RefreshConfig(max_swaps=max_swaps, min_gain=0.25)))
                refresh_ms.append(ms)
        launches[mode] = kernel.victim_threshold.launches
        met = coll.metrics(state)
        res[mode] = {**_drift_summary(hits, misses, drift_every),
                     "swaps": int(met["refresh_swaps"]),
                     "rows_moved": int(met["refresh_rows_moved"])}
        state.slabs[col.SHARED_ARENA].full.close()
        log(f"drift {mode}: {json.dumps(res[mode])}; prepare ms p50 {np.percentile(step_ms, 50)} "
            f"(median of {len(step_ms)}, to the counters' fetch); refresh ms "
            f"{'p50 ' + str(np.percentile(refresh_ms, 50)) if refresh_ms else 'none'} "
            f"({len(refresh_ms)} passes); threshold launches {launches[mode]}")
        if launches[mode] != 3 * drift_every and dev.type == "cuda":
            raise AssertionError(f"drift {mode}: {launches[mode]} threshold launches")
    want = DRIFT_REF[shape]
    if res != want:
        raise AssertionError(f"drift: the port's counts {res} != the JAX package's {want}")
    log(f"drift ({shape}: vocab {vocab}, dim {dim}, batch {batch}, drift_every {drift_every}, "
        f"{3 * drift_every} steps, refresh every {every}, max_swaps {max_swaps}, min_gain 0.25): "
        f"hit counts, hit rates, swaps and rows moved equal to the JAX package's on the CPU; "
        f"hit_post {res['refresh']['hit_post']} with the refresh against "
        f"{res['no_refresh']['hit_post']} without")
    return sum(launches.values())


def _drift_summary(hits, misses, drift_every):
    """bench_drift's windows over the per-step hit rates (as
    ``scripts/drift_reference.py`` computes them)."""
    rates, ph, pm = [], 0, 0
    for h, m in zip(hits, misses):
        dh, dm = h - ph, m - pm
        ph, pm = h, m
        rates.append(dh / (dh + dm) if dh + dm else None)

    def steady(lo, hi):
        window = [r for r in rates[lo:hi] if r is not None]
        return float(np.mean(window)) if window else 0.0

    steps = len(rates)
    return {"hit_pre": steady(drift_every - drift_every // 3, drift_every),
            "hit_post": steady(steps - drift_every // 2, steps),
            "trough": min(r for r in rates[drift_every:] if r is not None),
            "hits": hits[-1], "misses": misses[-1]}


# ---------------------------------------------------------------------------
# phases 14a-14b: the paper's single table; the Avazu DLRM
# ---------------------------------------------------------------------------

CE_SERVE, CE_TRAIN, CE_ADAGRAD = 8, 4, 2  # 14a: served batches, SGD steps, Adagrad steps
AVAZU_SERVE, AVAZU_TRAIN = 8, 4  # 14b: served batches, train steps


def _ce_train(ecfg, model, est, params, batches, dev):
    """``EmbTrainStep`` over ``batches`` (the DLRM's dense part as ``fwd``,
    SGD at the DLRM's lr); returns (state, losses, step ms, threshold
    launches), each step timed to its loss fetch."""
    from repro_torch.core import cached_embedding as ce
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.common import EmbTrainStep
    from repro_torch.optim import optimizers as opt_lib

    cfg = model.cfg
    b_sz, f = cfg.batch_size, cfg.n_sparse

    def fwd(p, rows, batch):
        emb = rows.reshape(b_sz, f, cfg.embed_dim)
        return model.fwd(p, {n: emb[:, i] for i, n in enumerate(model.feature_names)}, batch), {}

    offsets = est.offsets
    step = EmbTrainStep(emb_cfg=ecfg, optimizer=opt_lib.sgd(cfg.lr), fwd=fwd, emb_lr=cfg.lr,
                        collect_ids=lambda batch: (batch["sparse"] + offsets).reshape(-1))
    state = {"params": params, "opt": (), "emb": est,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    losses, ms = [], []
    kernel.victim_threshold.launches = 0
    for b in batches:
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
        if int(m["uniq_overflows"]):
            raise AssertionError("cached embedding: unique-buffer overflow")
    launches = kernel.victim_threshold.launches
    if not np.isfinite(losses).all():
        raise AssertionError(f"cached embedding: losses {losses}")
    if launches != len(batches):
        raise AssertionError(f"cached embedding: {launches} threshold launches for "
                             f"{len(batches)} plans")
    return ce.flush_state(ecfg, state["emb"]), state["params"], losses, ms, launches


def cached_embedding_phase(dev, vocab_scale, n_serve=CE_SERVE, n_train=CE_TRAIN,
                           n_adagrad=CE_ADAGRAD):
    """14a: the paper's single-table ``CachedEmbedding`` at full Criteo width
    (26 fields concatenated into one 33 762 577-row frequency-ordered fp32
    table of dim 128, pinned; 506 438 slots; ``use_pallas_plan``), its ids
    ranked as phase 4's (no counts: a Zipf id is its rank).  Serves
    ``n_serve`` batches of 16 384 through ``embed_onehot`` with write-back
    off (rows bitwise ``dense_reference_lookup``), trains ``n_train``
    ``EmbTrainStep`` steps (the DLRM's dense part, SGD), flushes (every
    resident slot's row = its host row, bitwise); then a second table with
    ``rowwise_adagrad`` trains ``n_adagrad`` steps and flushes (rows and
    each resident row's accumulator = the host's, bitwise).  The counts
    are at 0 before each run and read after it.  Returns the live key, its
    kv, the kernel's error on it and the launches by run."""
    from repro_torch.core import cached_embedding as ce
    from repro_torch.core import collection as col
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.nn.layers import mlp_init

    cfg = _scaled(vocab_scale)
    model = DLRM(cfg)
    ecfg = ce.CachedEmbeddingConfig(vocab_sizes=cfg.vocab_sizes, dim=cfg.embed_dim,
                                    ids_per_step=cfg.batch_size * cfg.n_sparse,
                                    cache_ratio=cfg.cache_ratio, use_pallas_plan=True)
    serve_cfg = dataclasses.replace(ecfg, writeback=False)
    t0 = time.perf_counter()
    est = ce.init_state(ecfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"cached embedding init+warmup {time.perf_counter() - t0} s: one table {ecfg.vocab} x "
        f"{ecfg.dim} fp32 = {est.full.host_bytes() / 1e9} GB pinned={est.full.pinned}; arena "
        f"{ecfg.capacity} slots (unique bound {ecfg.unique_size}); device_bytes "
        f"{json.dumps(ce.device_bytes(ecfg))}; host RSS {rss_gb()} GB")
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 4, i)
               for i in range(n_serve + n_train + n_adagrad + 1)]

    # --- serve: counts at 0, n_serve embed_onehot calls, counts read --------
    kernel.victim_threshold.launches = 0
    lat, hits0, misses0 = [], int(est.cache.hits), int(est.cache.misses)
    for b in batches[:n_serve]:
        ids = torch.from_numpy(b["sparse"]).to(dev)
        t0 = time.perf_counter()
        est, _, rows = ce.embed_onehot(serve_cfg, est, ids)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        want = ce.dense_reference_lookup(est, ids)
        if not torch.equal(rows, want):
            raise AssertionError(f"cached embedding serve: rows != dense_reference_lookup "
                                 f"(max |diff| {float((rows - want).abs().max())})")
    serve_launches = kernel.victim_threshold.launches
    if serve_launches != n_serve:
        raise AssertionError(f"cached embedding serve: {serve_launches} threshold launches")
    hits, misses = int(est.cache.hits) - hits0, int(est.cache.misses) - misses0
    log(f"cached embedding serve: {n_serve} batches of {cfg.batch_size} x {cfg.n_sparse} ids, "
        f"rows bitwise dense_reference_lookup; per-batch ms {lat} (p50 "
        f"{np.percentile(lat, 50)}); hit rate {hits / max(hits + misses, 1)} ({hits} id hits, "
        f"{misses} row misses); threshold launches {serve_launches}")

    # --- the kernel on the live key of one more plan -------------------------
    gids = ce.globalize(est, torch.from_numpy(batches[-1]["sparse"]).to(dev)).reshape(-1)
    key, kv = capture_plan_key(lambda: col.cached_slab_plan(serve_cfg.cache_config(),
                                                            est.slab(), gids))
    err = check_threshold(key, kv, "cached embedding plan key")
    log(f"cached embedding plan key [{key.shape[0]}] kv={kv}: kernel bitwise = plain, victim "
        f"order = argsort")

    # --- train (SGD), flush, resident rows = host rows -----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"bottom": mlp_init(gen, (cfg.n_dense,) + cfg.bottom_mlp, cfg.dtypes, dev),
              "top": mlp_init(gen, (model.top_in,) + cfg.top_mlp + (1,), cfg.dtypes, dev)}
    est, params, losses, ms, train_launches = _ce_train(
        ecfg, model, est, params, batches[n_serve:n_serve + n_train], dev)
    check_resident(est.cache.cached_rows["weight"], est.cache.slot_to_row, est.full,
                   "cached embedding (SGD)")
    hit_rate = float(est.cache.hit_rate())
    log(f"cached embedding train (EmbTrainStep, the DLRM's dense part, SGD lr {cfg.lr}): "
        f"losses {losses}; step ms {ms} (p50 {np.percentile(ms, 50)}, to the loss fetch); "
        f"cumulative hit rate {hit_rate}; threshold launches {train_launches}; host RSS "
        f"{rss_gb()} GB")
    est.full.close()
    del est
    gc.collect()

    # --- row-wise Adagrad: the accumulators travel with their rows -----------
    acfg = dataclasses.replace(ecfg, rowwise_adagrad=True)
    est = ce.init_state(acfg, 1, device=dev)
    est, _, a_losses, a_ms, a_launches = _ce_train(
        acfg, model, est, params, batches[n_serve + n_train:n_serve + n_train + n_adagrad], dev)
    check_resident(est.cache.cached_rows["weight"], est.cache.slot_to_row, est.full,
                   "cached embedding (row-wise Adagrad)")
    resident = torch.nonzero(est.cache.slot_to_row >= 0)[:, 0]
    arena_acc = est.cache.cached_rows["accum"][resident].cpu()
    host_acc = est.full.data["accum"][est.cache.slot_to_row[resident].cpu().to(torch.int64)]
    if not torch.equal(arena_acc, host_acc) or not bool((arena_acc > 0).any()):
        raise AssertionError("cached embedding (row-wise Adagrad): host accumulators != arena's")
    log(f"cached embedding row-wise Adagrad: losses {a_losses}; step ms {a_ms}; after the flush "
        f"all {resident.numel()} resident accumulators equal their host rows' bitwise "
        f"({int((arena_acc > 0).sum())} touched); threshold launches {a_launches}; host RSS "
        f"{rss_gb()} GB")
    est.full.close()
    del est
    gc.collect()
    log(f"host RSS after the cached embedding phase (tables unpinned and freed) {rss_gb()} GB")
    return {"key": key, "kv": kv, "err": err,
            "launches": serve_launches + train_launches + a_launches}


def avazu_phase(dev, vocab_scale, n_serve=AVAZU_SERVE, n_train=AVAZU_TRAIN):
    """14b: the paper's Avazu DLRM (``configs/dlrm_avazu.CONFIG``: 13 fields,
    9 445 823 rows of dim 128 pinned, batch 65 536, 851 968 slots, 8 dense
    features; ``use_pallas_plan``).  ``ServeEngine`` scores ``n_serve``
    batches (cached logits = ``dense_reference`` logits), then the
    ``Trainer`` takes ``n_train`` steps and flushes (every resident slot =
    its host row, bitwise); the counts at 0 before each and read after.
    Returns the live key, its kv, the kernel's error on it and the
    launches."""
    from repro_torch.configs.dlrm_avazu import CONFIG
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    vocabs = CONFIG.vocab_sizes
    if vocab_scale != 1.0:
        vocabs = tuple(max(1, int(v * vocab_scale)) for v in vocabs)
        log(f"CUT: Avazu vocabularies scaled by {vocab_scale} (total {sum(vocabs)} rows)")
    cfg = dataclasses.replace(CONFIG, vocab_sizes=vocabs, use_pallas_plan=True)
    model = DLRM(cfg)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs[SHARED_ARENA]
    log(f"avazu init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x {spec.dim} "
        f"fp32 = {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; arena "
        f"{spec.capacity} slots (unique bound {spec.unique_size()}) = "
        f"{spec.capacity * spec.dim * 4 / 1e6} MB; host RSS {rss_gb()} GB")
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 5, i) for i in range(n_serve + 3)]
    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(
        model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad, device=dev,
        state_stats_fn=lambda s: coll.metrics(s["emb"], writeback=False))
    engine.score(batches[n_serve + 2])  # first call: library handles, allocator, cuBLAS
    engine.stats = type(engine.stats)()
    base = engine.summary()

    # --- serve: counts at 0, n_serve batches, counts read --------------------
    kernel.victim_threshold.launches = 0
    lat = []
    for b in batches[:n_serve]:
        t0 = time.perf_counter()
        scores = engine.score(b)
        lat.append(1e3 * (time.perf_counter() - t0))
        if scores.shape != (cfg.batch_size,) or not np.isfinite(scores).all():
            raise AssertionError(f"avazu scores: shape {scores.shape}")
    serve_launches = kernel.victim_threshold.launches
    summary = engine.summary()
    if serve_launches != n_serve or summary["uniq_overflows"]:
        raise AssertionError(f"avazu serve: {serve_launches} threshold launches, overflows "
                             f"{summary['uniq_overflows']}")
    hits = summary["cache_hits"] - base["cache_hits"]
    misses = summary["cache_misses"] - base["cache_misses"]
    wire = summary["host_wire_bytes"] - base["host_wire_bytes"]
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_serve].items()}
    logits, emb = model.serve_step(engine.state, b)
    ref_rows = coll.dense_reference(emb, model.features(b))
    ref_logits = model.fwd(engine.state["params"], ref_rows, b)
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"avazu: cached vs uncached logits differ by "
                             f"{float((logits - ref_logits).abs().max())}")
    log(f"avazu serve: {n_serve} batches of {cfg.batch_size}; per-batch ms {lat} (p50 "
        f"{np.percentile(lat, 50)}); hit rate {hits / max(hits + misses, 1)} ({hits} id hits, "
        f"{misses} row misses); host wire bytes {wire}; cached logits = uncached within rtol "
        f"{TOL_RTOL} / atol {TOL_ATOL} (max |diff| {float((logits - ref_logits).abs().max())}); "
        f"threshold launches {serve_launches}")
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_serve + 1].items()}
    key, kv = capture_plan_key(lambda: coll.plan_prepare(emb, model.features(b),
                                                         writeback=False))
    err = check_threshold(key, kv, "avazu plan key")
    log(f"avazu plan key [{key.shape[0]}] kv={kv}: kernel bitwise = plain, victim order = "
        f"argsort")

    # --- train: counts at 0, the Trainer's n_train steps + flush, counts read
    serve_state = dict(engine.state, emb=emb)
    del engine
    kernel.victim_threshold.launches = 0
    trainer = Trainer(TrainerConfig(max_steps=n_train), init_fn=lambda: serve_state,
                      step_fn=model.train_step,
                      make_batch=lambda s: synth.sparse_batch(bspec, cfg.batch_size, 6, s),
                      device=dev)
    state = model.flush(trainer.run())
    train_launches = kernel.victim_threshold.launches
    h = trainer.history
    losses = [r["loss"] for r in h]
    if not np.isfinite(losses).all() or train_launches != n_train:
        raise AssertionError(f"avazu train: losses {losses}, {train_launches} threshold launches")
    slab = state["emb"].slabs[SHARED_ARENA]
    check_resident(slab.cache.cached_rows["weight"], slab.cache.slot_to_row, slab.full,
                   "avazu")
    ms = [1e3 * r["time_s"] for r in h]
    stats = {}
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_serve + 2].items()}
    profile_call("one avazu train step", lambda: float(model.train_step(state, b)[1]["loss"]),
                 stats=stats)
    idle = 1 - stats["busy"] / stats["wall"] if stats else None
    log(f"avazu train ({n_train} Trainer steps of {cfg.batch_size}, lr {cfg.lr}): losses "
        f"{losses}; step ms {ms} (p50 {np.percentile(ms, 50)}); host wire bytes "
        f"{h[-1]['host_wire_bytes']} in all ({h[-1]['host_wire_bytes'] / n_train} a step); "
        f"hit rate {h[-1]['hit_rate']}; idle share of one profiled step {idle}; threshold "
        f"launches {train_launches}; host RSS {rss_gb()} GB")
    slab.full.close()
    return {"key": key, "kv": kv, "err": err, "launches": serve_launches + train_launches}


# ---------------------------------------------------------------------------
# phases 15a-15c: DIN, DIEN and MIND at full published width
# ---------------------------------------------------------------------------

RECSYS_CANDIDATES = {"din": 65536, "dien": 1_000_000, "mind": 1_000_000}  # retrieval widths
DIEN_SERVE, DIEN_TRAIN = 4, 4  # 15b: served batches, train steps (a step runs 2 x 100 GRU cells)


def _recsys_cfg(arch, vocab_scale):
    """The arch's published config with ``use_pallas_plan``; ``vocab_scale``
    < 1 cuts the tables only (never dim, widths, seq or batch)."""
    from repro_torch.configs import dien, din, mind
    from repro_torch.models.recsys_models import DIENModel, DINModel, MINDModel

    mod, cls = {"din": (din, DINModel), "dien": (dien, DIENModel),
                "mind": (mind, MINDModel)}[arch]
    cfg = dataclasses.replace(mod.CONFIG, use_pallas_plan=True)
    if vocab_scale != 1.0:
        cut = {k: max(64, int(getattr(cfg, k) * vocab_scale))
               for k in ("n_items", "n_cates", "n_users") if hasattr(cfg, k)}
        cfg = dataclasses.replace(cfg, **cut)
        log(f"CUT: {arch} tables scaled by {vocab_scale} ({cut}); dim, widths, seq and batch "
            f"unchanged")
    return cfg, cls(cfg)


def _recsys_unique(coll, fb):
    """(valid lanes, unique rows) of a feature batch over the shared arena."""
    parts = []
    for f, ids in fb.ids.items():
        ids = ids.reshape(-1).cpu().numpy().astype(np.int64)
        parts.append(ids[ids >= 0] + coll.table_slab[coll.feature_to_table[f]][1])
    ids = np.concatenate(parts)
    return ids.size, np.unique(ids).size


def recsys_phase(dev, arch, vocab_scale, n_serve, n_train, n_cand):
    """15a-15c: DIN, DIEN or MIND (``configs/{din,dien,mind}.CONFIG``,
    ``use_pallas_plan``) at full published width: the host table pinned, a
    4 194 304-slot arena (the unique bound).  ``ServeEngine`` scores
    ``n_serve`` batches of 65 536 (cached logits = ``dense_reference``
    logits, no overflow, one threshold launch a plan), the threshold is held
    bitwise to its plain version on one more plan's live key,
    ``retrieval_score`` scores one user against ``n_cand`` candidates
    (finite, shape ``[n_cand]``), then the ``Trainer`` takes ``n_train``
    steps and flushes (every resident slot = its host row, bitwise).  The counts are at 0 before each run and read after it;
    the batches are built before the timed loops.  Returns the live key,
    its kv, the kernel's error on it and the launches by run."""
    from repro_torch.configs.shapes import N_CANDIDATES
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.launch.serve import pad_example
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, model = _recsys_cfg(arch, vocab_scale)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    b_sz = cfg.batch_size
    n_cates = None if arch == "mind" else cfg.n_cates
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs[SHARED_ARENA]
    log(f"{arch} init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x {spec.dim} "
        f"fp32 = {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; arena "
        f"{spec.capacity} slots (unique bound {spec.unique_size()}) = "
        f"{spec.capacity * spec.dim * 4 / 1e6} MB; {spec.ids_per_step} id lanes a step; host "
        f"RSS {rss_gb()} GB")

    def make(seed, step):
        return synth.recsys_batch(cfg.n_items, cfg.n_users, cfg.seq_len, b_sz, seed, step,
                                  n_cates=n_cates)

    t0 = time.perf_counter()
    batches = [make(7, i) for i in range(n_serve + 3)]
    train_batches = [make(8, s) for s in range(n_train)]
    log(f"{arch}: {len(batches) + n_train} batches built on the host in "
        f"{time.perf_counter() - t0} s (before the timed loops)")
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
    valid, uniq = _recsys_unique(coll, model.features(b))
    log(f"{arch} batch 0: {valid} valid id lanes of {spec.ids_per_step}, {uniq} unique rows")
    engine = ServeEngine(
        model.serve_step, state, batch_size=b_sz, pad_example=pad_example(cfg),
        device=dev, state_stats_fn=lambda s: coll.metrics(s["emb"], writeback=False))
    engine.score(batches[n_serve + 2])  # first call: library handles, allocator, cuBLAS
    engine.stats = type(engine.stats)()
    base = engine.summary()

    # --- serve: counts at 0, n_serve batches, counts read --------------------
    torch.cuda.reset_peak_memory_stats()
    kernel.victim_threshold.launches = 0
    lat = []
    for bb in batches[:n_serve]:
        t0 = time.perf_counter()
        scores = engine.score(bb)
        lat.append(1e3 * (time.perf_counter() - t0))
        if scores.shape != (b_sz,) or not np.isfinite(scores).all():
            raise AssertionError(f"{arch} scores: shape {scores.shape}")
    serve_launches = kernel.victim_threshold.launches
    serve_peak = torch.cuda.max_memory_allocated()
    summary = engine.summary()
    if serve_launches != n_serve or summary["uniq_overflows"]:
        raise AssertionError(f"{arch} serve: {serve_launches} threshold launches, overflows "
                             f"{summary['uniq_overflows']}")
    hits = summary["cache_hits"] - base["cache_hits"]
    misses = summary["cache_misses"] - base["cache_misses"]
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_serve].items()}
    logits, emb = model.serve_step(engine.state, b)
    ref_logits = model.fwd(engine.state["params"], coll.dense_reference(emb, model.features(b)),
                           b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"{arch}: cached vs uncached logits differ by {diff}")
    log(f"{arch} serve: {n_serve} batches of {b_sz}; per-batch ms {lat} (p50 "
        f"{np.percentile(lat, 50)}, p99 {np.percentile(lat, 99)}); hit rate "
        f"{hits / max(hits + misses, 1)} ({hits} id hits, {misses} row misses); host wire bytes "
        f"{summary['host_wire_bytes'] - base['host_wire_bytes']}; peak device memory "
        f"{serve_peak / 1e9} GB; cached logits = uncached within rtol {TOL_RTOL} / atol "
        f"{TOL_ATOL} (max |diff| {diff}); threshold launches {serve_launches}")
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_serve + 1].items()}
    key, kv = capture_plan_key(lambda: coll.plan_prepare(emb, model.features(b),
                                                         writeback=False))
    err = check_threshold(key, kv, f"{arch} plan key")
    log(f"{arch} plan key [{key.shape[0]}] kv={kv}: kernel bitwise = plain, victim order = "
        f"argsort")

    # --- retrieval: one user against n_cand candidates -----------------------
    if n_cand < N_CANDIDATES:
        log(f"CUT: {arch} retrieval scores {n_cand} candidates, not N_CANDIDATES = "
            f"{N_CANDIDATES}: DIN's attention input alone is [N, {cfg.seq_len}, "
            f"{8 * cfg.embed_dim}] fp32, {N_CANDIDATES * cfg.seq_len * 8 * cfg.embed_dim * 4 / 1e9}"
            f" GB at N = {N_CANDIDATES}")
    rng = np.random.default_rng(11)
    cands = rng.integers(0, cfg.n_items, n_cand).astype(np.int32)
    user = {k: b[k][:1] for k in ("hist_items", "hist_cates", "hist_len", "user") if k in b}
    rb = dict(user, candidates=torch.from_numpy(cands).to(dev))
    if n_cates is not None:
        rb["candidate_cates"] = torch.from_numpy(cands % n_cates).to(dev)
    serve_state = dict(engine.state, emb=emb)
    del engine
    torch.cuda.reset_peak_memory_stats()
    kernel.victim_threshold.launches = 0
    ret_ms = []
    for _ in range(2):  # the first call warms the allocator
        t0 = time.perf_counter()
        scores, emb = model.retrieval_score(serve_state, rb)
        torch.cuda.synchronize()
        ret_ms.append(1e3 * (time.perf_counter() - t0))
        serve_state = dict(serve_state, emb=emb)
    ret_launches = kernel.victim_threshold.launches
    if scores.shape != (n_cand,) or not bool(torch.isfinite(scores).all()) or ret_launches != 2:
        raise AssertionError(f"{arch} retrieval: shape {tuple(scores.shape)}, finite "
                             f"{bool(torch.isfinite(scores).all())}, {ret_launches} launches")
    log(f"{arch} retrieval_score: one user against {n_cand} candidates, finite, shape "
        f"{tuple(scores.shape)}; ms {ret_ms} (the second warm); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9} GB; threshold launches {ret_launches}")

    # --- train: counts at 0, the Trainer's n_train steps + flush, counts read
    torch.cuda.reset_peak_memory_stats()
    kernel.victim_threshold.launches = 0
    trainer = Trainer(TrainerConfig(max_steps=n_train), init_fn=lambda: serve_state,
                      step_fn=model.train_step,  # (the prefetcher reads past the last step)
                      make_batch=lambda s: train_batches[min(s, n_train - 1)],
                      device=dev)
    state = model.flush(trainer.run())
    train_launches = kernel.victim_threshold.launches
    train_peak = torch.cuda.max_memory_allocated()
    h = trainer.history
    losses = [r["loss"] for r in h]
    if not np.isfinite(losses).all() or train_launches != n_train:
        raise AssertionError(f"{arch} train: losses {losses}, {train_launches} threshold "
                             f"launches")
    slab = state["emb"].slabs[SHARED_ARENA]
    check_resident(slab.cache.cached_rows["weight"], slab.cache.slot_to_row, slab.full, arch)
    ms = [1e3 * r["time_s"] for r in h]
    stats = {}
    b = {k: torch.from_numpy(v).to(dev) for k, v in train_batches[-1].items()}
    census_call(f"15 ({arch} train step, its loss fetched)",
                lambda: float(model.train_step(state, b)[1]["loss"]))
    profile_call(f"one {arch} train step", lambda: float(model.train_step(state, b)[1]["loss"]),
                 stats=stats)
    idle = 1 - stats["busy"] / stats["wall"] if stats else None
    log(f"{arch} train ({n_train} Trainer steps of {b_sz}, lr {cfg.lr}): losses {losses}; "
        f"step ms {ms} (p50 {np.percentile(ms, 50)}); hit rate {h[-1]['hit_rate']}; host wire "
        f"bytes {h[-1]['host_wire_bytes'] / n_train} a step; peak device memory "
        f"{train_peak / 1e9} GB; idle share of one profiled step {idle}; threshold launches "
        f"{train_launches}; host RSS {rss_gb()} GB")
    slab.full.close()
    return {"key": key, "kv": kv, "err": err,
            "launches": serve_launches + ret_launches + train_launches}


# ---------------------------------------------------------------------------
# phases 6-7: FM at full width, served through its kernel and trained
# ---------------------------------------------------------------------------


def _fm_scaled(vocab_scale, **kw):
    from repro_torch.configs.fm import CONFIG

    vocabs = CONFIG.vocab_sizes
    if vocab_scale != 1.0:
        vocabs = tuple(max(1, int(v * vocab_scale)) for v in vocabs)
        log(f"CUT: FM vocabularies scaled by {vocab_scale} (total {sum(vocabs)} rows, full "
            f"{sum(CONFIG.vocab_sizes)}); dim, fields and batch unchanged")
    return dataclasses.replace(CONFIG, vocab_sizes=vocabs, use_pallas_plan=True, **kw)


def _fm_init(model, dev, what):
    from repro_torch.core.collection import SHARED_ARENA

    spec = model.collection.cached_slabs[SHARED_ARENA]
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs[SHARED_ARENA]
    log(f"FM {what} init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x "
        f"{spec.dim} fp32 = {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; arena "
        f"{spec.capacity} slots (unique bound {spec.unique_size()}) = "
        f"{spec.capacity * spec.dim * 4 / 1e6} MB; host RSS {rss_gb()} GB")
    return state, slab


def fm_serve_phase(dev, vocab_scale, n_batches):
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel
    from repro_torch.kernels.fm_interaction import ops as fm_ops
    from repro_torch.models.recsys_models import FMModel
    from repro_torch.serve.engine import ServeEngine

    cfg = _fm_scaled(vocab_scale, use_pallas=True)
    model = FMModel(cfg)
    state, slab = _fm_init(model, dev, "serve")
    n_fields = len(cfg.vocab_sizes)
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes)
    # measured, invariant check, profiled, warm-up
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 0, i) for i in range(n_batches + 3)]
    pad = {"sparse": np.zeros((n_fields,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(
        model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad, device=dev,
        state_stats_fn=lambda s: model.collection.metrics(s["emb"], writeback=False),
        obs_annotate=True,
    )
    engine.score(batches[n_batches + 2])
    engine.stats = type(engine.stats)()
    base = engine.summary()

    # --- the main path: counts at 0, n_batches scored requests, counts read ---
    kernel.victim_threshold.launches = 0
    fm_kernel.fm_interaction.launches = 0
    lat, all_scores = [], []
    for b in batches[:n_batches]:
        t0 = time.perf_counter()
        all_scores.append(engine.score(b))
        lat.append(1e3 * (time.perf_counter() - t0))
    thr_launches = kernel.victim_threshold.launches
    fm_launches = fm_kernel.fm_interaction.launches
    summary = engine.summary()
    hits = summary["cache_hits"] - base["cache_hits"]
    misses = summary["cache_misses"] - base["cache_misses"]

    scores = np.concatenate(all_scores)
    if scores.shape != (n_batches * cfg.batch_size,) or not np.isfinite(scores).all():
        raise AssertionError(f"FM scores: shape {scores.shape}, finite "
                             f"{np.isfinite(scores).all()}")
    if summary["uniq_overflows"] != 0:
        raise AssertionError(f"FM uniq_overflows = {summary['uniq_overflows']}")
    if thr_launches != n_batches or fm_launches != n_batches:
        raise AssertionError(f"FM serve: victim_threshold launched {thr_launches}, "
                             f"fm_interaction {fm_launches} times for {n_batches} batches")
    log(f"FM serve: {n_batches} batches of {cfg.batch_size} x {n_fields} fields; per-batch ms "
        f"{lat}; p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms (histogram bounds), "
        f"requests/s {summary['requests'] / (sum(lat) / 1e3)}, hit rate "
        f"{hits / max(hits + misses, 1)} ({hits} id hits, {misses} row misses), host wire "
        f"bytes {summary['host_wire_bytes'] - base['host_wire_bytes']}, launches: threshold "
        f"{thr_launches}, fm_interaction {fm_launches}")
    log(f"FM score span: {json.dumps(engine.tracer.stage_summary())}")

    # --- cache invariant, and the kernel on one live batch's v ---------------
    captured = []
    impl = fm_ops.fm_interaction

    def capture(v):  # the strided [..., :D] view the model hands the kernel
        captured.append(v)
        return impl(v)

    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_batches].items()}
    fm_ops.fm_interaction = capture
    try:
        logits, emb = model.serve_step(engine.state, b)
    finally:
        fm_ops.fm_interaction = impl
    ref_rows = model.collection.dense_reference(emb, model.features(b))
    ref_logits = model.fwd(engine.state["params"], {k: v.to(dev) for k, v in ref_rows.items()},
                           b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"FM cached vs uncached logits differ by {diff}")
    v = captured[0]
    live_err = check_fm(v, "live serve batch")
    log(f"FM cache invariant: max |cached - uncached| logit = {diff} (rtol {TOL_RTOL} atol "
        f"{TOL_ATOL}); kernel = plain on the live v {tuple(v.shape)} strides {v.stride()} "
        f"(max |diff| {live_err})")
    engine.state = dict(engine.state, emb=emb)
    key, kv = capture_plan_key(lambda: model.collection.plan_prepare(
        engine.state["emb"], model.features(b), writeback=False))
    thr_err = check_threshold(key, kv, "FM serve plan key")
    log(f"FM serve plan key [{key.shape[0]}] kv={kv}: kernel bitwise = plain, victim order = "
        f"argsort; protected {int((key == -_BIG).sum())}, empty {int((key == _BIG).sum())}")
    profile_call("one FM score call", lambda: engine.score(batches[n_batches + 1]),
                 skip=set(engine.tracer.stage_summary()))
    slab.full.close()
    return {"fm_launches": fm_launches, "thr_launches": thr_launches, "v": v,
            "live_err": live_err, "key": key, "kv": kv, "thr_err": thr_err}


def _fm_chunk(vocab_scale):
    """``FM_CHUNK_ROWS``, which divides the full FM table's 33 764 352 rows;
    a cut table takes the largest power of two <= it that divides its rows."""
    from repro_torch.models.recsys_models import FMModel

    vocab = FMModel(_fm_scaled(vocab_scale)).collection.cached_slabs["__shared__"].vocab
    chunk = FM_CHUNK_ROWS
    while vocab % chunk:
        chunk //= 2
    if chunk != FM_CHUNK_ROWS:
        log(f"CUT: chunk_rows {chunk} divides the cut FM table's {vocab} rows")
    return chunk


def fm_train_phase(dev, vocab_scale, n_steps, chunk_rows=0):
    """FM trained ``n_steps`` steps and flushed; with ``chunk_rows`` the host
    side of every move stages whole chunks (phase 7b), whose losses must be
    bitwise phase 7's."""
    from repro_torch.core import transmitter
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel
    from repro_torch.models.recsys_models import FMModel
    from repro_torch.obs.hub import fetch_ints

    # the FM kernel has no backward
    cfg = _fm_scaled(vocab_scale, use_pallas=False, chunk_rows=chunk_rows)
    model = FMModel(cfg)
    what = f"train, chunk_rows {chunk_rows}" if chunk_rows else "train"
    state, slab = _fm_init(model, dev, what)
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes)
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + 2)]

    def dev_batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}

    state, m = model.train_step(state, dev_batch(n_steps + 1))  # allocator, autograd
    counters = ("cache_evictions", "cache_misses", "uniq_overflows", "slab_hits",
                "host_moved_rows")
    prev = fetch_ints({k: m[k] for k in counters})

    # --- the main path: counts at 0, n_steps train steps + flush, counts read
    kernel.victim_threshold.launches = 0
    fm_kernel.fm_interaction.launches = 0
    transmitter.moves.update(rows=0, chunked=0, chunk_block_bytes=0)
    step_ms, losses, per_step = [], [], []
    for i in range(n_steps):
        b = dev_batch(i)
        t0 = time.perf_counter()
        state, m = model.train_step(state, b)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        cur = fetch_ints({k: m[k] for k in counters})
        per_step.append({k: (cur[k] - prev[k]) if not isinstance(cur[k], dict) else
                         sum(cur[k].values()) - sum(prev[k].values()) for k in counters})
        per_step[-1]["hit_rate"] = float(m["hit_rate"])
        prev = cur
    t0 = time.perf_counter()
    state = model.flush(state)
    torch.cuda.synchronize()
    flush_ms = 1e3 * (time.perf_counter() - t0)
    thr_launches = kernel.victim_threshold.launches
    fm_launches = fm_kernel.fm_interaction.launches
    moves = dict(transmitter.moves)

    if not all(np.isfinite(losses)):
        raise AssertionError(f"FM non-finite training loss: {losses}")
    if chunk_rows and (not moves["chunked"] or moves["rows"]):
        raise AssertionError(f"FM chunk_rows {chunk_rows}: moves {moves} (want chunked only)")
    if any(p["uniq_overflows"] for p in per_step):
        raise AssertionError(f"FM unique-buffer overflow: {per_step}")
    if thr_launches != n_steps or fm_launches != 0:
        raise AssertionError(f"FM train: victim_threshold launched {thr_launches} times for "
                             f"{n_steps} plans, fm_interaction {fm_launches} (want 0)")
    log(f"FM {what}: {n_steps} steps of {cfg.batch_size}; losses {losses}; step ms {step_ms}; "
        f"p50 {np.percentile(step_ms, 50)} ms, p99 {np.percentile(step_ms, 99)} ms (numpy "
        f"percentiles of {n_steps}); flush {flush_ms} ms; per step {json.dumps(per_step)}; "
        f"transmitter moves {json.dumps(moves)} (chunk_block_bytes: the largest staging block "
        f"a chunked load filled; row granularity stages at most {cfg.buffer_rows} rows x "
        f"{slab.full.row_wire_bytes()} B = {cfg.buffer_rows * slab.full.row_wire_bytes()} B)")

    # --- after the flush: every resident arena row == its host row, bitwise
    cache = state["emb"].slabs[SHARED_ARENA].cache
    check_resident(cache.cached_rows["weight"], cache.slot_to_row, slab.full, f"FM {what}")
    b = dev_batch(n_steps)
    profile_call(f"one FM {what} step", lambda: model.train_step(state, b))
    slab.full.close()
    return {"thr_launches": thr_launches, "losses": losses, "moves": moves}


# ---------------------------------------------------------------------------
# phases 9-13: the LM family (SmolLM-360M and Gemma-3-27B) and flash attention
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores (NVIDIA data sheet)
FLASH_TOL = 2e-5  # the reference's fp32 flash sweep: rtol and atol
LM_RTOL = 1e-4  # fp32 routes: rtol and atol 1e-4 * max|logit|; read: 3e-6 relative
LM_PREFILLS, LM_B, LM_S = 3, 8, 4096  # prefill requests of B 8 x S 4096 (train_4k's length)
LM_LONG_S = 32768  # one B 1 request at prefill_32k's length
LM_PROMPT, LM_NEW, LM_MAX_LEN = 64, 64, 4096  # decode: prompt, greedy tokens, cache length
GEMMA_S = 8192
# the flash kernels' symbols: bf16 tensor cores, fp32 tensor cores (3xTF32), fp32 SIMT
WGMMA_SYMBOL, TF32_SYMBOL = "flash_wgmma_kernel", "flash_tf32x3_kernel"
SIMT_SYMBOL = "flash_fwd_kernel"


def _bf16_ulp(x):
    """The spacing of bf16 values at each element of ``x`` (0 where x is 0)."""
    m, e = torch.frexp(x.float())  # |x| in [2^(e-1), 2^e): 8 significant bits
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


def _route(dtype, d):
    """The flash kernel a dtype and head width launch (``kernel.route``)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    return fa_kernel.route(dtype, d)


def check_flash(q, k, v, causal, window, what, show=False):
    """The flash kernel against its plain version on [B, S, H, D] inputs;
    returns max_abs_err.  fp32 is held within the reference sweep's 2e-5
    (rtol and atol).  The two bf16 outputs are each one rounding of fp32
    results, so bf16 is held within that plus one bf16 ulp of the plain
    output: a bound that scales with |o| (the sweep's flat 3e-2 would pass
    a kernel that drops a key tile of a long row, whose |o| is ~0.01-0.05)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    route = _route(q.dtype, q.shape[-1])
    before = fa_kernel.flash_attention.route_launches[route]
    got = fa_kernel.flash_attention(qt, kt, vt, causal, window)
    if fa_kernel.flash_attention.route_launches[route] != before + 1:
        raise AssertionError(f"flash_attention {what}: {q.dtype} d {q.shape[-1]} did not launch "
                             f"the {route} kernel")
    want = fa_kernel.flash_attention_plain(qt, kt, vt, causal, window)
    if got.dtype != q.dtype or got.shape != qt.shape:
        raise AssertionError(f"flash_attention {what}: got {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    bound = FLASH_TOL * (1 + want.float().abs())
    if q.dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(want)
    err, o = float(diff.max()), want.float().abs()
    if not bool(torch.isfinite(got).all()) or not bool((diff <= bound).all()):
        raise AssertionError(f"flash_attention {what}: kernel != plain (max |diff| {err}, "
                             f"worst excess over the bound {float((diff - bound).max())})")
    if show:
        log(f"flash_attention {what}: {q.dtype} ({route}) max |diff| {err}, max |o| "
            f"{float(o.max())}, "
            f"mean |o| {float(o.mean())}; bound per element "
            + ("2e-5 (1 + |o|)" + ("" if q.dtype == torch.float32 else " + one bf16 ulp of o")))
    return err


def flash_kernel_phase(dev):
    """Phase 9: the kernel against its plain version on the reference sweep,
    the SMOKE configs' head dims, SmolLM's 15/5 heads, a ragged length, a
    window wider than S and the widest head; then the autograd backward."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cases = [(2, 4, 2, 512, 64, True, None), (1, 4, 4, 512, 64, True, 128),
             (2, 8, 2, 256, 32, False, None), (1, 2, 1, 1024, 128, True, 256),
             (2, 6, 3, 256, 16, True, None), (2, 6, 2, 256, 20, True, 64),
             (1, 15, 5, 512, 64, True, None), (2, 4, 2, 96, 64, True, None),
             (1, 4, 2, 512, 64, True, 4096), (1, 2, 1, 256, 256, False, 100)]
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"wgmma": 0.0, "tf32x3": 0.0, "simt": 0.0}  # max_abs_err by route
    before = dict(fa_kernel.flash_attention.route_launches)
    for b, hq, hkv, s, d, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
                       for h in (hq, hkv, hkv))
            route = _route(dtype, d)
            errs[route] = max(errs[route], check_flash(q, k, v, causal, window,
                                                       f"{(b, hq, hkv, s, d, causal, window)}"))
            if route == "simt":  # the SIMT kernel's inputs, timed in phase 13
                simt_live = (q, k, v, causal, window)
    by_route = {r: n - before[r] for r, n in fa_kernel.flash_attention.route_launches.items()}
    want = [torch.randn((1, 256, h, 32), generator=g, device=dev) for h in (4, 2, 2)]
    got = [t.clone().requires_grad_() for t in want]
    want = [t.requires_grad_() for t in want]
    cot = torch.randn((1, 256, 4, 32), generator=g, device=dev)
    (fa_ops.flash_attention(*got) * cot).sum().backward()
    q, k, v = (t.transpose(1, 2) for t in want)
    (fa_kernel.flash_attention_plain(q, k, v).transpose(1, 2) * cot).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max()) for a, b in zip(got, want))
    if grad_err > 1e-4:
        raise AssertionError(f"flash_attention backward: q/k/v grads off the plain "
                             f"version's autograd by {grad_err} > 1e-4")
    log(f"flash_attention phase: {len(cases)} shapes x fp32 (3xTF32 kernel up to d 128, SIMT "
        f"kernel at d 256) / bf16 (bf16 tensor-core kernel) within 2e-5 (1 + |o|), bf16 plus one "
        f"bf16 ulp of o; launches by route {by_route}; max_abs_err by route {errs}; autograd "
        f"(kernel forward, plain recompute backward) q/k/v grads within {grad_err} of the plain "
        f"version's (<= 1e-4)")
    return errs, simt_live


@contextlib.contextmanager
def layer0_inputs():
    """Records the first (q, k, v, causal, window) that the model hands
    ``ops.flash_attention`` inside the block: layer 0's live inputs, in the
    model's [B, S, H, D] layout."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    seen, impl = [], fa_ops.flash_attention

    def capture(q, k, v, causal=True, window=None):
        if not seen:
            seen.append((q, k, v, causal, window))
        return impl(q, k, v, causal, window)

    fa_ops.flash_attention = capture
    try:
        yield seen
    finally:
        fa_ops.flash_attention = impl


def _prefill(model, params, batch, what):
    """One prefill request, timed to its sync, with the kernel's launches
    counted from 0; checks finite [B, V] logits.  Returns the logits, the
    ms, the launches and layer 0's live kernel inputs."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    route = _route(model.cfg.dtypes.compute, model.cfg.head_dim)
    fa_kernel.flash_attention.launches = 0
    before = fa_kernel.flash_attention.route_launches[route]
    with layer0_inputs() as seen:
        logits, ms = sync_ms(lambda: model.prefill_step(params, batch))
    n = fa_kernel.flash_attention.launches
    if fa_kernel.flash_attention.route_launches[route] - before != n:
        raise AssertionError(f"{what}: {n} flash launches, not all on the {route} route")
    b = batch["tokens"].shape[0]
    if logits.shape != (b, model.cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: logits {tuple(logits.shape)} not finite [B, V]")
    return logits, ms, n, seen[0]


def lm_serve_phase(dev, cfg, b=LM_B, s=LM_S, n_requests=LM_PREFILLS, long_s=LM_LONG_S,
                   prompt=LM_PROMPT, new=LM_NEW, max_len=LM_MAX_LEN):
    """Phase 10: SmolLM-360M served at its published width and depth in bf16
    with ``use_pallas=True``: prefill requests, one long request, a greedy
    decode against KV caches, layer 0's live inputs through the kernel, the
    chunked route beside it, and one profiled prefill."""
    from repro_torch.data import synth
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import LMModel
    from repro_torch.nn import transformer as T

    model = LMModel(cfg)
    params, init_ms = sync_ms(  # serving's init: every leaf in dtypes.param
        lambda: T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"lm serve: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d_head {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtypes.compute}; {n_bytes} B of weights, init {init_ms} ms; "
        f"cut: prefill batch {b} (prefill_32k's is 32: the full-vocab [B, S, V] logits) at S "
        f"{s} (train_4k's length), and one request of B 1 at S {long_s}")
    batches = [synth.seq_batch(cfg.vocab, b, s, 0, i) for i in range(n_requests + 1)]
    _prefill(model, params, batches[0], "warm-up prefill")
    lat, counts = [], []
    for i in range(n_requests):
        logits, ms, n, live = _prefill(model, params, batches[i + 1], f"prefill request {i}")
        lat.append(ms)
        counts.append(n)
    if counts != [cfg.n_layers] * n_requests:
        raise AssertionError(f"lm serve: kernel launches per prefill {counts}, want "
                             f"{cfg.n_layers} each")
    p50 = float(np.percentile(lat, 50))
    log(f"lm serve prefill B {b} x S {s}: ms {lat}, p50 {p50}, {b * s / p50 * 1e3} tokens/s; "
        f"kernel launches per prefill {counts}")

    last = batches[n_requests]  # the last request's tokens and logits
    err = check_flash(*live, f"live layer-0 q/k/v at B {b} x S {s}", show=True)
    chunked = LMModel(dataclasses.replace(cfg, use_pallas=False))
    ref_logits, ref_ms = sync_ms(lambda: chunked.prefill_step(params, last))
    delta = float((logits.float() - ref_logits.float()).abs().max())
    log(f"lm serve: kernel within {err} of plain on live layer-0 q/k/v {tuple(live[0].shape)} "
        f"(causal {live[3]}, window {live[4]}); last-position logits of the last request vs the use_pallas=False route: max |diff| "
        f"{delta} "
        f"(max |logit| {float(ref_logits.float().abs().max())}; printed, not gated: the routes "
        f"round p differently in bf16); chunked route {ref_ms} ms")
    del ref_logits
    stats = {}
    profile_call(f"one prefill B {b} x S {s}", lambda: model.prefill_step(params, last),
                 stats=stats)
    # the bf16 prefill runs the tensor-core kernel, never the SIMT one
    by_kernel = stats.get("by_kernel", {})
    fa = sum(ms for name, ms in by_kernel.items() if WGMMA_SYMBOL in name)
    simt = [name for name in by_kernel if SIMT_SYMBOL in name]
    if fa <= 0 or simt:
        raise AssertionError(f"lm serve profiled prefill: {fa} ms of {WGMMA_SYMBOL}, SIMT "
                             f"kernels {simt}: want the tensor-core kernel alone")
    fa_per_launch = fa / cfg.n_layers  # the kernel's device ms a launch
    log(f"lm serve profiled prefill: flash kernel ({WGMMA_SYMBOL}) {fa} ms of {stats['busy']} "
        f"ms device busy (share {fa / stats['busy']}, {fa_per_launch} ms a launch); idle share "
        f"{1 - stats['busy'] / stats['wall']}")

    long_batch = synth.seq_batch(cfg.vocab, 1, long_s, 0, n_requests + 1)
    _, long_ms, long_n, long_live = _prefill(model, params, long_batch,
                                             f"prefill B 1 x S {long_s}")
    if long_n != cfg.n_layers:
        raise AssertionError(f"lm serve long prefill: {long_n} launches, want {cfg.n_layers}")
    long_err = check_flash(*long_live, f"live layer-0 q/k/v at B 1 x S {long_s}", show=True)
    del long_live
    log(f"lm serve prefill B 1 x S {long_s}: {long_ms} ms, {long_s / long_ms * 1e3} tokens/s, "
        f"{long_n} launches; kernel within {long_err} of plain on live layer-0 q/k/v")

    fa_kernel.flash_attention.launches = 0
    caches = T.init_decode_caches(cfg, b, max_len, device=dev)
    prompt_toks = torch.from_numpy(batches[1]["tokens"][:, :prompt]).to(dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    step_ms, greedy = [], []
    for t in range(prompt + new):
        tok = prompt_toks[:, t:t + 1] if t < prompt else nxt
        (out, caches), ms = sync_ms(lambda: model.decode_fn(params, caches, tok, pos))
        nxt = out.argmax(-1, keepdim=True).to(torch.int32)
        pos = pos + 1
        if t >= prompt:
            step_ms.append(ms)
            greedy.append(nxt)
    if not bool(torch.isfinite(out).all()) or fa_kernel.flash_attention.launches != 0:
        raise AssertionError(f"lm decode: finite logits {bool(torch.isfinite(out).all())}, "
                             f"{fa_kernel.flash_attention.launches} kernel launches (want 0)")
    census_call(f"10 (SmolLM-360M decode token, B {b})",
                lambda: model.decode_fn(params, caches, nxt, pos))
    profile_call(f"one decode step B {b}", lambda: model.decode_fn(params, caches, nxt, pos))
    dec_p50 = float(np.percentile(step_ms, 50))
    log(f"lm decode B {b}: {prompt}-token prompt from position 0 into caches of max_len "
        f"{max_len}, then {new} greedy tokens: ms/token p50 {dec_p50} (min {min(step_ms)}, max "
        f"{max(step_ms)}), {b / dec_p50 * 1e3} tokens/s; 0 kernel launches")
    return {"live": live, "err": max(err, long_err), "launches": sum(counts) + long_n,
            "device_ms": fa_per_launch,
            "decode": {"ms": dec_p50, "tokens": torch.cat(greedy, 1).cpu(),
                       "cache_bytes": sum(t.numel() * t.element_size() for t in _leaves(caches)),
                       "prompt": prompt_toks.cpu()}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def lm_fp32_phase(dev, cfg, b=2, s=LM_S, steps=LM_PROMPT):
    """Phase 11: SmolLM-360M at the same width in fp32 (TF32 off): prefill
    through the kernel and through the chunked route, and teacher-forced
    decode steps from position 0 against ``forward``'s logits."""
    from repro_torch.data import synth
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import LMModel
    from repro_torch.nn import transformer as T

    model = LMModel(cfg)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(1), cfg, dev)
    toks = torch.from_numpy(synth.seq_batch(cfg.vocab, b, s, 1, 0)["tokens"]).to(dev)
    route = _route(cfg.dtypes.compute, cfg.head_dim)
    counts = {}

    def counted(what, fn):  # one layer pass, its launches counted from 0
        fa_kernel.flash_attention.launches = 0
        before = fa_kernel.flash_attention.route_launches[route]
        out = fn()
        n = fa_kernel.flash_attention.launches
        if n != cfg.n_layers or fa_kernel.flash_attention.route_launches[route] - before != n:
            raise AssertionError(f"lm fp32 {what}: {n} flash launches, want {cfg.n_layers}, all "
                                 f"on the {route} route")
        counts[what] = n
        return out

    with torch.no_grad(), layer0_inputs() as seen:
        logits, _ = counted("forward", lambda: T.forward(params, cfg, toks))
    n = counts["forward"]
    live = seen[0]
    live_err = check_flash(*live, f"fp32 live layer-0 q/k/v at B {b} x S {s}", show=True)
    del seen
    chunked = LMModel(dataclasses.replace(cfg, use_pallas=False))
    ref_last = chunked.prefill_step(params, {"tokens": toks})
    last = logits[:, -1]
    scale = float(ref_last.abs().max())
    d_route = float((last - ref_last).abs().max())
    ok_route = torch.allclose(last, ref_last, rtol=LM_RTOL, atol=LM_RTOL * scale)
    caches = T.init_decode_caches(cfg, b, steps, device=dev)
    d_dec = 0.0
    ok_dec = True
    for t in range(steps):
        out, caches = model.decode_fn(params, caches, toks[:, t:t + 1],
                                      torch.tensor(t, dtype=torch.int32, device=dev))
        want = logits[:, t]
        d_dec = max(d_dec, float((out - want).abs().max()))
        ok_dec &= torch.allclose(out, want, rtol=LM_RTOL,
                                 atol=LM_RTOL * float(want.abs().max()))
    log(f"lm fp32 (TF32 off) B {b} x S {s}: {n} kernel launches; last logits kernel route vs "
        f"use_pallas=False route max |diff| {d_route} (max |logit| {scale}, relative "
        f"{d_route / scale}); {steps} teacher-forced decode steps vs forward's logits at "
        f"positions 0-{steps - 1}: max |diff| {d_dec}; tolerance rtol {LM_RTOL}, atol "
        f"{LM_RTOL} * max|logit|")
    if not (ok_route and ok_dec):
        raise AssertionError(f"lm fp32: routes agree {ok_route}, decode agrees {ok_dec}")

    batch = {"tokens": toks}
    counted("warm-up prefill_step", lambda: model.prefill_step(params, batch))
    _, prefill_ms = counted("timed prefill_step",
                            lambda: sync_ms(lambda: model.prefill_step(params, batch)))
    stats = {}
    profile_call(f"one fp32 prefill B {b} x S {s}", lambda: model.prefill_step(params, batch),
                 stats=stats)
    by_kernel = stats.get("by_kernel", {})
    fa = sum(ms for name, ms in by_kernel.items() if TF32_SYMBOL in name)
    simt = [name for name in by_kernel if SIMT_SYMBOL in name]
    if fa <= 0 or simt:
        raise AssertionError(f"lm fp32 profiled prefill: {fa} ms of {TF32_SYMBOL}, SIMT kernels "
                             f"{simt}: want the 3xTF32 kernel alone")
    log(f"lm fp32 prefill_step B {b} x S {s}: {prefill_ms} ms wall ({b * s / prefill_ms * 1e3} "
        f"tokens/s); profiled: flash kernel ({TF32_SYMBOL}) {fa} ms of {stats['busy']} ms device "
        f"busy (share {fa / stats['busy']}, {fa / cfg.n_layers} ms a launch); launches by call "
        f"{counts}, all on the {route} route")
    return {"live": live, "err": live_err, "launches": sum(counts.values()),
            "launches_by_call": counts, "prefill_ms": prefill_ms,
            "prefill_device_ms": fa / cfg.n_layers}


def gemma_phase(dev, cfg, s=GEMMA_S):
    """Phase 12: Gemma-3-27B at its published width, depth cut to one pattern
    group (5 local layers of window 1024, 1 global): one prefill through the
    kernel, and layer 0's live windowed inputs through it."""
    from repro_torch.data import synth
    from repro_torch.models.lm import LMModel
    from repro_torch.nn import transformer as T

    model = LMModel(cfg)
    params, init_ms = sync_ms(
        lambda: T.init_lm(torch.Generator(device=dev).manual_seed(2), cfg, dev))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"gemma: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}, "
        f"{cfg.dtypes.compute}; cut: depth 62 -> {cfg.n_layers} (one group: "
        f"{cfg.pattern.count('local')} local, {cfg.pattern.count('global')} global); "
        f"{n_bytes} B of weights, init {init_ms} ms")
    batch = synth.seq_batch(cfg.vocab, 1, s, 0, 0)
    _prefill(model, params, batch, "gemma warm-up prefill")
    _, ms, n, live = _prefill(model, params, batch, f"gemma prefill B 1 x S {s}")
    if n != cfg.n_layers:
        raise AssertionError(f"gemma prefill: {n} launches, want {cfg.n_layers}")
    if live[3:] != (True, cfg.window):
        raise AssertionError(f"gemma layer 0: causal {live[3]}, window {live[4]}; want a local "
                             f"layer of window {cfg.window}")
    err = check_flash(*live, f"gemma live layer-0 q/k/v (window {cfg.window})", show=True)
    log(f"gemma prefill B 1 x S {s}: {ms} ms, {s / ms * 1e3} tokens/s, {n} launches; kernel "
        f"within {err} of plain on live layer-0 q/k/v {tuple(live[0].shape)}, window "
        f"{cfg.window}")
    return {"live": live, "err": err, "launches": n}


# ---------------------------------------------------------------------------
# phases 16a-16e: LM training, the MoE family (OLMoE, Grok-1) and int8 decode
# ---------------------------------------------------------------------------

TRAIN_S = 4096  # train_4k's length
TRAIN_BATCHES = (8, 4, 2)  # 16a: the largest that fits, cut from train_4k's 256
# 16a: timed steps with compressor none, then int8 (3 and 2 before phases 19d-19e)
TRAIN_STEPS, TRAIN_INT8_STEPS = 2, 1
FP32_TRAIN_LAYERS, FP32_TRAIN_B = 4, 2  # 16b: depth cut, batch (phase 11's)
OLMOE_B, OLMOE_PREFILLS, OLMOE_NEW = 4, 3, 32  # 16c: prefills of B x S 4096, decode tokens
OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_B, OLMOE_TRAIN_STEPS = 4, 2, 2
GROK_S = 8192
MOE_TIE = 1e-5  # a router gap below this between the k-th and (k+1)-th expert is a near tie


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    else:
        yield path, tree


def check_train_dtypes(state, cfg, what):
    """The reference's training state: the embedding table and the norm
    scales in ``dtypes.param``, every other matrix, the AdamW moments and
    the int8 error feedback fp32."""
    def want(path):
        return cfg.dtypes.param if path.rsplit("/", 1)[-1] in ("table", "scale") else torch.float32

    bad = [(p, t.dtype) for p, t in _paths(state["params"]) if t.dtype != want(p)]
    for part in ("opt", "comp"):
        bad += [(part + p, t.dtype) for p, t in _paths(state.get(part, {}))
                if t.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{what}: state dtypes off the reference's: {bad[:8]}")


def _train_step(model, state, batch, what, route, want):
    """One ``train_step`` timed to its sync with the flash launches counted
    from 0: ``want`` launches, all on ``route``; a finite loss and gradient
    norm.  Returns (state, ms, loss, grad norm)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    fa_kernel.flash_attention.launches = 0
    before = fa_kernel.flash_attention.route_launches[route]
    (state, m), ms = sync_ms(lambda: model.train_step(state, batch))
    n = fa_kernel.flash_attention.launches
    if n != want or fa_kernel.flash_attention.route_launches[route] - before != n:
        raise AssertionError(f"{what}: {n} flash launches, want {want}, all on the {route} route")
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"{what}: loss {loss}, grad norm {gnorm}")
    return state, ms, loss, gnorm


def _lm_batch(dev, vocab, b, s, step):
    from repro_torch.data import synth

    return {k: torch.from_numpy(v).to(dev) for k, v in synth.seq_batch(vocab, b, s, 0,
                                                                         step).items()}


def _detached(live):
    return tuple(t.detach() if torch.is_tensor(t) else t for t in live)


def time_live_flash(live, what):
    """The bf16 kernel, its plain version and SDPA on live [B, S, H, D]
    inputs by CUDA events, and the bound (:func:`_flash_work`)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    q, k, v = (t.transpose(1, 2) for t in live[:3])
    window = live[4]
    ev = {"kernel": cuda_ms(lambda: fa_kernel.flash_attention(q, k, v, True, window), iters=10),
          "plain": cuda_ms(lambda: fa_kernel.flash_attention_plain(q, k, v, True, window),
                           iters=3, warmup=1),
          "sdpa": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True), iters=10)}
    flops, n_bytes, ops_ms, bytes_ms = _flash_work(q, k, window, BF16_OPS_PER_S)
    bound = max(ops_ms, bytes_ms)
    log(f"flash_attention on {what} {tuple(q.shape)} / {tuple(k.shape)}: event-timed ms kernel "
        f"{ev['kernel']}, plain {ev['plain']}, sdpa {ev['sdpa']}; bound {bound} ms ({flops} "
        f"FLOP at {BF16_OPS_PER_S / 1e12} TFLOP/s: {ops_ms} ms; {n_bytes} B: {bytes_ms} ms); "
        f"fraction of the bound {bound / ev['kernel']}")
    return {"shape": list(q.shape), "ms": ev["kernel"], "plain_ms": ev["plain"],
            "library_ms": ev["sdpa"], "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "flops": flops}


def lm_train_phase(dev, cfg, s=TRAIN_S, batches=TRAIN_BATCHES, n_steps=TRAIN_STEPS,
                   n_int8=TRAIN_INT8_STEPS):
    """Phase 16a: SmolLM-360M trained at published width and depth (bf16
    compute, fp32 matrices and moments, remat, the flash kernel): the
    largest batch of ``batches`` that fits at S ``s``, ``n_steps`` timed
    steps with compressor ``none``, ``n_int8`` with ``int8``, a profiled
    step, layer 0's live q/k/v through kernel and plain."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import LMModel

    route = _route(cfg.dtypes.compute, cfg.head_dim)
    want = 2 * cfg.n_layers  # each layer's forward and its remat recompute
    model = LMModel(cfg)
    state, init_ms = sync_ms(
        lambda: model.init(torch.Generator(device=dev).manual_seed(3), dev))
    check_train_dtypes(state, cfg, "lm train init")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    launches = {"train_none": 0, "train_int8": 0, "profiled": 0}
    for b in batches:  # the warm-up step at each batch until one fits
        try:
            state, warm_ms, _, _ = _train_step(model, state, _lm_batch(dev, cfg.vocab, b, s, 0),
                                               f"lm train warm-up B {b}", route, want)
            launches["train_none"] += want
            break
        except torch.OutOfMemoryError as e:
            log(f"lm train: B {b} x S {s} does not fit on the card ({str(e)[:120]})")
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError(f"lm train: none of the batches {batches} fits at S {s}")
    log(f"lm train: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.dtypes.compute} compute, remat {cfg.remat}; state {n_bytes} B (params, AdamW m "
        f"and v), init {init_ms} ms; cut: batch {b} of train_4k's 256 at S {s} (the largest of "
        f"{batches} that fits: the full-vocab logits and their fp32 copies); warm-up {warm_ms} ms")
    torch.cuda.reset_peak_memory_stats()
    lat, losses, norms = [], [], []
    for i in range(n_steps):
        batch = _lm_batch(dev, cfg.vocab, b, s, i + 1)
        if i == 0:
            with layer0_inputs() as seen:
                state, ms, loss, gn = _train_step(model, state, batch, f"lm train step {i}",
                                                  route, want)
            live = _detached(seen[0])
            del seen
        else:
            state, ms, loss, gn = _train_step(model, state, batch, f"lm train step {i}", route,
                                              want)
        launches["train_none"] += want
        lat.append(ms)
        losses.append(loss)
        norms.append(gn)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.percentile(lat, 50))
    log(f"lm train B {b} x S {s}, compressor none: step ms {lat}, p50 {p50} (4031 ms on "
        f"this card when AdamW made two host-to-device syncs an update), "
        f"{b * s / p50 * 1e3} tokens/s; losses {losses}; grad norms {norms}; peak device "
        f"memory {peak / 1e9} GB; {want} flash launches a step, all on the {route} route")

    model8 = LMModel(cfg, compressor="int8")
    state = dict(state, comp=model8.compressor.init(state["params"]))
    lat8, losses8 = [], []
    for i in range(n_int8):
        state, ms, loss, _ = _train_step(model8, state,
                                         _lm_batch(dev, cfg.vocab, b, s, n_steps + 1 + i),
                                         f"lm train int8 step {i}", route, want)
        launches["train_int8"] += want
        lat8.append(ms)
        losses8.append(loss)
    check_train_dtypes(state, cfg, "lm train after the int8 steps")
    log(f"lm train compressor int8 (error feedback): step ms {lat8}, losses {losses8}; "
        f"wire bytes a step {model8.compressor.wire_bytes(state['params'])} B against "
        f"{model.compressor.wire_bytes(state['params'])} B uncompressed")

    err = check_flash(*live, f"16a live layer-0 q/k/v at B {b} x S {s}", show=True)
    stats = {}
    batch = _lm_batch(dev, cfg.vocab, b, s, n_steps + n_int8 + 1)
    census_call(f"16a (SmolLM-360M train step B {b} x S {s}, its loss fetched)",
                lambda: float(model.train_step(state, batch)[1]["loss"]))
    fa_kernel.flash_attention.launches = 0
    profile_call(f"one SmolLM-360M train step B {b} x S {s}",
                 lambda: model.train_step(state, batch), stats=stats)
    launches["profiled"] = fa_kernel.flash_attention.launches
    by_kernel = stats.get("by_kernel", {})
    fa = sum(ms for name, ms in by_kernel.items() if WGMMA_SYMBOL in name)
    if fa <= 0 or any(SIMT_SYMBOL in name for name in by_kernel):
        raise AssertionError(f"lm train profiled step: {fa} ms of {WGMMA_SYMBOL}; want the "
                             f"tensor-core kernel alone")
    idle = 1 - stats["busy"] / stats["wall"]
    log(f"lm train profiled step: flash kernel {fa} ms of {stats['busy']} ms device busy "
        f"(share {fa / stats['busy']}, {fa / want} ms a launch: forward and recompute); idle "
        f"share {idle}")
    kernel = time_live_flash(live, "16a's live layer-0 training q/k/v")
    kernel["device_ms"] = fa / want
    return {"launches": launches, "live_err": err, "batch": b, "step_p50": p50,
            "tokens_per_s": b * s / p50 * 1e3, "peak_gb": peak / 1e9, "idle": idle,
            "kernel": kernel}


def lm_fp32_train_phase(dev, cfg, b=FP32_TRAIN_B, s=TRAIN_S):
    """Phase 16b: SmolLM-360M's width in fp32 (TF32 off), depth cut: one
    ``train_step`` through the 3xTF32 kernel and one through the chunked
    route from one state and one batch: loss and gradient norm within rtol
    1e-4 (phase 11's LM tolerance), every updated parameter within rtol
    1e-4 and atol 0.2 lr (AdamW's step has slope lr / 1e-8 at a zero
    gradient, see ``tests/test_torch_lm_train.py``)."""
    from repro_torch.models.lm import LMModel

    route = _route(cfg.dtypes.compute, cfg.head_dim)
    model = LMModel(cfg)
    chunked = LMModel(dataclasses.replace(cfg, use_pallas=False))
    state = model.init(torch.Generator(device=dev).manual_seed(4), dev)
    check_train_dtypes(state, cfg, "lm fp32 train init")
    batch = _lm_batch(dev, cfg.vocab, b, s, 0)
    with layer0_inputs() as seen:
        new_k, ms_k, loss_k, gn_k = _train_step(model, state, batch, "lm fp32 kernel route",
                                                route, 2 * cfg.n_layers)
    live = _detached(seen[0])
    del seen
    new_c, ms_c, loss_c, gn_c = _train_step(chunked, state, batch, "lm fp32 chunked route",
                                            route, 0)
    lr = 3e-4  # LMModel's default
    worst, bad = 0.0, []
    for (path, a), (_, c) in zip(_paths(new_k["params"]), _paths(new_c["params"])):
        excess = float(((a - c).abs() - (1e-4 * c.abs() + 0.2 * lr)).max())
        worst = max(worst, float((a - c).abs().max()))
        if excess > 0:
            bad.append((path, excess))
    err = check_flash(*live, f"16b live fp32 layer-0 q/k/v at B {b} x S {s}", show=True)
    log(f"lm fp32 train ({cfg.n_layers} layers of SmolLM's width, cut from 32; B {b} x S {s}; "
        f"TF32 off): kernel route loss {loss_k}, grad norm {gn_k}, {ms_k} ms; chunked route "
        f"loss {loss_c}, grad norm {gn_c}, {ms_c} ms; relative diffs "
        f"{abs(loss_k - loss_c) / abs(loss_c)}, {abs(gn_k - gn_c) / gn_c}; updated parameters "
        f"max |diff| {worst}; {2 * cfg.n_layers} launches on the {route} route, 0 on the "
        f"chunked route")
    if (abs(loss_k - loss_c) > 1e-4 * abs(loss_c) or abs(gn_k - gn_c) > 1e-4 * gn_c or bad):
        raise AssertionError(f"lm fp32 train: kernel route != chunked route (loss {loss_k} vs "
                             f"{loss_c}, grad norm {gn_k} vs {gn_c}, params off: {bad[:6]})")
    return {"launches": 2 * cfg.n_layers, "live_err": err}


@contextlib.contextmanager
def moe_calls(capture_first=True):
    """Watches ``moe_apply_shard_map`` (the configs' MoE route): each
    call's (token, expert) pairs dropped by capacity, from its routing
    recomputed (a 0-dim tensor a call, no sync), and the first call's
    parameters and input (layer 0's)."""
    from repro_torch.nn import moe as M

    seen = {"drops": [], "first": None}
    impl = M.moe_apply_shard_map

    def watch(p, x, dt, *, top_k, capacity_factor=1.25):
        with torch.no_grad():
            t, e = x.shape[0] * x.shape[1], p["router"].shape[-1]
            logits = (x.reshape(t, -1).to(dt.compute) @ p["router"].to(dt.compute)).float()
            idx = torch.topk(torch.softmax(logits, -1), top_k, dim=-1).indices
            over = torch.bincount(idx.reshape(-1), minlength=e) - M.moe_capacity(
                t, e, top_k, capacity_factor)
            seen["drops"].append(torch.clamp_min(over, 0).sum())
        if capture_first and seen["first"] is None:
            seen["first"] = (p, x.detach())
        return impl(p, x, dt, top_k=top_k, capacity_factor=capacity_factor)

    M.moe_apply_shard_map = watch
    try:
        yield seen
    finally:
        M.moe_apply_shard_map = impl


def check_moe_routes(p, x, cfg, what):
    """``moe_apply_shard_map`` against ``moe_apply`` (the "global" route)
    in fp32 on one live layer's input: outputs within rtol 1e-4 / atol
    1e-4 * max|out| on every token without a near tie in its router (a gap
    under ``MOE_TIE`` between its k-th and (k+1)-th expert, where the two
    routes' last bits may pick different experts), aux within rtol 1e-4."""
    from repro_torch.nn import moe as M
    from repro_torch.nn.layers import Dtypes

    dt = Dtypes(param=torch.float32, compute=torch.float32)
    p32 = {k: v.detach().float() for k, v in p.items()}
    x32 = x.float()
    with torch.no_grad():
        out_s, aux_s = M.moe_apply_shard_map(p32, x32, dt, top_k=cfg.top_k,
                                             capacity_factor=cfg.capacity_factor)
        out_g, aux_g = M.moe_apply(p32, x32, dt, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   dp_groups=cfg.moe_dp_groups)
        probs = torch.softmax(x32.reshape(-1, x32.shape[-1]) @ p32["router"], -1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        tie = (top[:, -2] - top[:, -1]) < MOE_TIE
    diff = (out_s - out_g).abs().reshape(-1, x.shape[-1])
    scale = float(out_g.abs().max())
    ok_rows = (diff <= 1e-4 * out_g.abs().reshape(diff.shape) + 1e-4 * scale).all(-1)
    bad = int((~ok_rows & ~tie).sum())
    worst = float(diff[~tie].max())
    log(f"{what}: shard_map route vs global route in fp32 on live layer-0 input "
        f"{tuple(x.shape)}: max |diff| {worst} (max |out| {scale}) over the "
        f"{int((~tie).sum())} tokens without a near tie ({int(tie.sum())} with one); aux "
        f"{float(aux_s)} vs {float(aux_g)}")
    if bad or abs(float(aux_s) - float(aux_g)) > 1e-4 * abs(float(aux_g)):
        raise AssertionError(f"{what}: shard_map != global on {bad} tokens (max |diff| {worst}), "
                             f"aux {float(aux_s)} vs {float(aux_g)}")
    return worst


def olmoe_phase(dev, cfg, b=OLMOE_B, s=LM_S, n_requests=OLMOE_PREFILLS, prompt=LM_PROMPT,
                new=OLMOE_NEW, max_len=LM_MAX_LEN, train_layers=OLMOE_TRAIN_LAYERS,
                train_b=OLMOE_TRAIN_B, n_train=OLMOE_TRAIN_STEPS):
    """Phase 16c: OLMoE-1B-7B served at published width and depth in bf16
    (prefills, the MoE routes against each other on layer 0's live input, a
    greedy decode), then trained at published width with depth cut."""
    from repro_torch.data import synth
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import LMModel
    from repro_torch.nn import transformer as T

    model = LMModel(cfg)
    params, init_ms = sync_ms(lambda: T.init_lm(torch.Generator(device=dev).manual_seed(5),
                                                cfg, dev))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"olmoe serve: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, vocab "
        f"{cfg.vocab}, moe_impl {cfg.moe_impl}, {cfg.dtypes.compute}; {n_bytes} B of weights, "
        f"init {init_ms} ms; cut: prefill batch {b} (prefill_32k's is 32) at S {s}")
    batches = [synth.seq_batch(cfg.vocab, b, s, 0, i) for i in range(n_requests + 1)]
    with moe_calls() as seen:
        _prefill(model, params, batches[0], "olmoe warm-up prefill")
    drops = [int(d) for d in seen["drops"]]
    route_err = check_moe_routes(*seen["first"], cfg, "olmoe")
    del seen
    cap = cfg.capacity_factor
    log(f"olmoe prefill B {b} x S {s}: (token, expert) pairs dropped by capacity (factor {cap}) "
        f"per layer {drops} of {b * s * cfg.top_k} a layer")
    lat, counts = [], []
    for i in range(n_requests):
        _, ms, n, live = _prefill(model, params, batches[i + 1], f"olmoe prefill {i}")
        lat.append(ms)
        counts.append(n)
    if counts != [cfg.n_layers] * n_requests:
        raise AssertionError(f"olmoe: launches per prefill {counts}, want {cfg.n_layers}")
    p50 = float(np.percentile(lat, 50))
    err = check_flash(*live, f"olmoe live layer-0 q/k/v at B {b} x S {s}", show=True)
    del live
    log(f"olmoe prefill B {b} x S {s}: ms {lat}, p50 {p50}, {b * s / p50 * 1e3} tokens/s; "
        f"launches {counts}")

    db = LM_B
    fa_kernel.flash_attention.launches = 0
    caches = T.init_decode_caches(cfg, db, max_len, device=dev)
    prompt_toks = torch.from_numpy(synth.seq_batch(cfg.vocab, db, s, 0, 1)["tokens"][:, :prompt]
                                   ).to(dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    step_ms = []
    for t in range(prompt + new):
        tok = prompt_toks[:, t:t + 1] if t < prompt else nxt
        (out, caches), ms = sync_ms(lambda: model.decode_fn(params, caches, tok, pos))
        nxt = out.argmax(-1, keepdim=True).to(torch.int32)
        pos = pos + 1
        if t >= prompt:
            step_ms.append(ms)
    if not bool(torch.isfinite(out).all()) or fa_kernel.flash_attention.launches != 0:
        raise AssertionError(f"olmoe decode: finite {bool(torch.isfinite(out).all())}, "
                             f"{fa_kernel.flash_attention.launches} kernel launches (want 0)")
    dec_p50 = float(np.percentile(step_ms, 50))
    log(f"olmoe decode B {db}: {prompt}-token prompt, then {new} greedy tokens into caches of "
        f"{max_len}: ms/token p50 {dec_p50} (min {min(step_ms)}, max {max(step_ms)})")
    del params, caches, out
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, n_layers=train_layers)
    tmodel = LMModel(tcfg)
    state = tmodel.init(torch.Generator(device=dev).manual_seed(6), dev)
    check_train_dtypes(state, tcfg, "olmoe train init")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    route = _route(cfg.dtypes.compute, cfg.head_dim)
    want = 2 * train_layers
    torch.cuda.reset_peak_memory_stats()
    with moe_calls(capture_first=False) as seen:
        state, warm_ms, _, _ = _train_step(tmodel, state, _lm_batch(dev, cfg.vocab, train_b, s,
                                                                      0),
                                           "olmoe train warm-up", route, want)
    train_drops = [int(d) for d in seen["drops"][:train_layers]]
    del seen
    lat_t, losses = [], []
    for i in range(n_train):
        state, ms, loss, _ = _train_step(tmodel, state, _lm_batch(dev, cfg.vocab, train_b, s,
                                                                    i + 1),
                                         f"olmoe train step {i}", route, want)
        lat_t.append(ms)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    t50 = float(np.percentile(lat_t, 50))
    log(f"olmoe train: cut: depth 16 -> {train_layers} layers at published width; B {train_b} "
        f"x S {s}; state {n_bytes} B (fp32 matrices, bf16 table and norms, fp32 moments); "
        f"warm-up {warm_ms} ms, step ms {lat_t}, p50 {t50}, {train_b * s / t50 * 1e3} tokens/s; "
        f"losses {losses}; peak device memory {peak / 1e9} GB; drops per layer (forward) "
        f"{train_drops}; {want} flash launches a step")
    del state
    return {"launches": {"olmoe_prefill": sum(counts), "olmoe_train": want * (1 + n_train)},
            "err": err, "route_err": route_err, "prefill_p50": p50, "decode_ms": dec_p50,
            "train_p50": t50, "peak_gb": peak / 1e9}


def grok_phase(dev, cfg, s=GROK_S):
    """Phase 16d: Grok-1 at published width, depth cut to one layer: one
    prefill of B 1 x S ``s`` through the kernel (KV heads replicated 2x),
    layer 0's live q/k/v through kernel and plain."""
    from repro_torch.data import synth
    from repro_torch.models.lm import LMModel
    from repro_torch.nn import transformer as T

    model = LMModel(cfg)
    params, init_ms = sync_ms(lambda: T.init_lm(torch.Generator(device=dev).manual_seed(7),
                                                cfg, dev))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe = params["groups"]["p0"]["moe"]
    expert_bytes = sum(moe[k].numel() * moe[k].element_size() for k in ("gate", "up", "down"))
    log(f"grok: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (x{cfg.kv_repeat} "
        f"replicated), d_head {cfg.head_dim}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, "
        f"top-{cfg.top_k}, vocab {cfg.vocab}, {cfg.dtypes.compute}; cut: depth 64 -> "
        f"{cfg.n_layers}; {n_bytes} B of weights ({expert_bytes} B the layer's experts), init "
        f"{init_ms} ms")
    batch = synth.seq_batch(cfg.vocab, 1, s, 0, 0)
    with moe_calls(capture_first=False) as seen:
        _prefill(model, params, batch, "grok warm-up prefill")
    drops = [int(d) for d in seen["drops"]]
    _, ms, n, live = _prefill(model, params, batch, f"grok prefill B 1 x S {s}")
    if n != cfg.n_layers:
        raise AssertionError(f"grok prefill: {n} launches, want {cfg.n_layers}")
    if live[1].shape[2] != cfg.eff_kv_heads:
        raise AssertionError(f"grok layer 0: {live[1].shape[2]} KV heads, want the replicated "
                             f"{cfg.eff_kv_heads}")
    err = check_flash(*live, f"grok live layer-0 q/k/v ({cfg.n_heads}/{cfg.eff_kv_heads} heads)",
                      show=True)
    log(f"grok prefill B 1 x S {s}: {ms} ms, {s / ms * 1e3} tokens/s, {n} launch; pairs dropped "
        f"by capacity {drops} of {s * cfg.top_k}")
    return {"launches": n, "err": err, "ms": ms}


def int8_decode_phase(dev, cfg, ref, prompt=LM_PROMPT, new=LM_NEW, max_len=LM_MAX_LEN):
    """Phase 16e: SmolLM-360M (phase 10's weights and prompt) decoded greedily
    into int8 KV caches; the int8 attention on the card against the same
    function on the CPU on the last step's live layer-0 tensors.  ``ref``
    is phase 10's bf16-cache decode (ms a token, tokens, cache bytes)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import LMModel
    from repro_torch.nn import transformer as T

    model = LMModel(cfg)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)  # phase 10's
    b = ref["prompt"].shape[0]
    caches = T.init_decode_caches(cfg, b, max_len, device=dev)
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(caches))
    prompt_toks = ref["prompt"].to(dev)
    live, impl = [], T._decode_attention_i8

    def capture(*args):  # layer 0's inputs of the step: the cache views are final after it
        if not live:
            live.extend(args)
        return impl(*args)

    fa_kernel.flash_attention.launches = 0
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    step_ms, greedy = [], []
    for t in range(prompt + new):
        tok = prompt_toks[:, t:t + 1] if t < prompt else nxt
        if t == prompt + new - 1:
            T._decode_attention_i8 = capture
        try:
            (out, caches), ms = sync_ms(lambda: model.decode_fn(params, caches, tok, pos))
        finally:
            T._decode_attention_i8 = impl
        nxt = out.argmax(-1, keepdim=True).to(torch.int32)
        pos = pos + 1
        if t >= prompt:
            step_ms.append(ms)
            greedy.append(nxt)
    if not bool(torch.isfinite(out).all()) or fa_kernel.flash_attention.launches != 0:
        raise AssertionError(f"int8 decode: finite {bool(torch.isfinite(out).all())}, "
                             f"{fa_kernel.flash_attention.launches} kernel launches (want 0)")
    tokens = torch.cat(greedy, 1).cpu()
    same = float((tokens == ref["tokens"]).float().mean())
    first = [int(torch.nonzero(r != w)[0]) if bool((r != w).any()) else len(r)
             for r, w in zip(tokens, ref["tokens"])]

    card = T._attention_i8_parts(*live)
    cpu = T._attention_i8_parts(*(t.cpu() for t in live))
    vc = live[2].cpu().to(torch.int64)
    exact = torch.einsum("bhgs,bshd->bhgd", card["w8"].cpu().to(torch.int64), vc)
    flips = (card["w8"].cpu().to(torch.int64) - cpu["w8"].to(torch.int64)).abs()
    ok_int = (torch.equal(card["q8"].cpu(), cpu["q8"]) and torch.equal(card["raw"].cpu(),
                                                                       cpu["raw"])
              and torch.equal(card["acc"].cpu().to(torch.int64), exact))
    out_card = card["acc"].cpu().float() * (card["wmax"].cpu() / 127.0)
    out_cpu = cpu["acc"].float() * (cpu["wmax"] / 127.0)
    bound = (cpu["wmax"] / 127.0) * torch.einsum("bhgs,bshd->bhgd", flips.float(),
                                                 vc.abs().float())
    diff = (out_card - out_cpu).abs()
    ok_out = bool((diff <= 1e-4 * out_cpu.abs().max() + 1e-4 * out_cpu.abs() + bound).all())
    dec_p50 = float(np.percentile(step_ms, 50))
    log(f"int8 decode B {b}: {prompt}-token prompt, {new} greedy tokens into int8 caches of "
        f"{max_len}: ms/token p50 {dec_p50} against the bf16 caches' {ref['ms']} (phase 10, "
        f"printed, not gated); cache bytes {cache_bytes} against {ref['cache_bytes']}; greedy "
        f"tokens equal to phase 10's: {same} of {tokens.numel()} (first difference per row "
        f"{first}); last step's layer 0 (cache length {int(live[5])}): q codes and q.k "
        f"accumulators bitwise the CPU's {torch.equal(card['raw'].cpu(), cpu['raw'])}, w.v "
        f"accumulators bitwise the exact integer dot of the card's codes "
        f"{torch.equal(card['acc'].cpu().to(torch.int64), exact)}; weight codes off the CPU's "
        f"by one: {int((flips > 0).sum())} of {flips.numel()}; output max |diff| "
        f"{float(diff.max())} (max |o| {float(out_cpu.abs().max())})")
    if not (ok_int and ok_out and int(flips.max()) <= 1):
        raise AssertionError(f"int8 decode attention: integers exact {ok_int}, output within "
                             f"bound {ok_out}, max weight code diff {int(flips.max())}")
    return {"ms": dec_p50, "agree": same, "cache_bytes": cache_bytes}


# ---------------------------------------------------------------------------
# phases 17a-17d: GatedGCN at published width (no kernel of the port)
# ---------------------------------------------------------------------------

GNN_SERVE, GNN_TRAIN = 5, 5  # 17a-17c: timed serve calls and train steps (8, 8 before 19)
OGB_SERVE = 1  # 17d: timed serve calls (3 before phase 19)
REDDIT_NODES, REDDIT_EDGES = 232_965, 11_606_919  # GraphSAGE's Reddit graph (17b)
GNN_SEEDS, GNN_FANOUTS = 1024, (15, 10)  # 17b: minibatch_lg's block
GNN_LOGIT_RTOL = 1e-4  # 17a: card vs CPU logits, rtol and atol 1e-5 * max|logit|
GNN_STATE_TOL = {"params": (1e-5, 2e-4), "m": (1e-4, 1e-6), "v": (1e-4, 1e-9)}
GNN_NEAR_ZERO = 1e-5  # tests/test_torch_gnn.py: a gradient below this of max|g| is near zero


def _gnn(shape):
    """(model, n_nodes, n_edges, extras) of ``configs.gatedgcn.SHAPE_CFG[shape]`` at
    the published 16 layers and d_hidden 70."""
    from repro_torch.configs.gatedgcn import SHAPE_CFG
    from repro_torch.models.gatedgcn import GatedGCNConfig, GatedGCNModel

    _, n, e, d_feat, n_classes, task, extra = SHAPE_CFG[shape]
    return GatedGCNModel(GatedGCNConfig(d_feat=d_feat, n_classes=n_classes, task=task)), n, e, \
        extra


def _gnn_batch(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def _gnn_state_to(state, dev):
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda x: x.to(dev), state)


def gnn_run(model, state, batches, what, n_serve=GNN_SERVE, n_train=GNN_TRAIN, census=False):
    """``serve_step`` on ``n_serve`` batches, then ``n_train`` train steps
    (batch ``i`` of ``batches`` at call ``i``), after one untimed call of
    each; each call synced.  Prints p50 / p99, nodes/s, peak device memory
    and a profiled train step's idle share and device ops."""
    n_nodes = batches[0]["feat"].shape[0]
    model.serve_step(state, batches[0])
    state, _ = model.train_step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serve_ms = []
    for i in range(n_serve):
        logits, ms = sync_ms(lambda i=i: model.serve_step(state, batches[i % len(batches)])[0])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{what} serve: non-finite logits")
        serve_ms.append(ms)
    serve_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_ms, losses = [], []
    for i in range(n_train):
        t0 = time.perf_counter()
        state, m = model.train_step(state, batches[i % len(batches)])
        losses.append(float(m["loss"]))  # the step's one sync
        train_ms.append(1e3 * (time.perf_counter() - t0))
    train_peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what} train: losses {losses}")
    stats = {}
    b = batches[n_train % len(batches)]
    if census:
        census_call(f"{what} (train step, its loss fetched)",
                    lambda: float(model.train_step(state, b)[1]["loss"]))
    profile_call(f"one {what} train step", lambda: float(model.train_step(state, b)[1]["loss"]),
                 stats=stats)
    idle = 1 - stats["busy"] / stats["wall"] if stats else None
    out = {"serve_p50": float(np.percentile(serve_ms, 50)),
           "serve_p99": float(np.percentile(serve_ms, 99)),
           "train_p50": float(np.percentile(train_ms, 50)),
           "train_p99": float(np.percentile(train_ms, 99)),
           "serve_peak_gb": serve_peak / 1e9, "train_peak_gb": train_peak / 1e9,
           "idle": idle, "ops": stats.get("ops"), "losses": losses}
    out["nodes_per_s"] = n_nodes / out["train_p50"] * 1e3
    log(f"{what} ({model.cfg.n_layers} layers, d_hidden {model.cfg.d_hidden}, N {n_nodes}, E "
        f"{batches[0]['src'].shape[0]}): serve ms {serve_ms} (p50 {out['serve_p50']}, p99 "
        f"{out['serve_p99']}, {n_nodes / out['serve_p50'] * 1e3} nodes/s), peak "
        f"{out['serve_peak_gb']} GB; train step ms {train_ms} (p50 {out['train_p50']}, p99 "
        f"{out['train_p99']}, {out['nodes_per_s']} nodes/s), losses {losses}, peak "
        f"{out['train_peak_gb']} GB; a profiled train step: idle share {idle}, "
        f"{out['ops']} device ops")
    return out


def _flat_leaves(tree):
    return {path: x.detach().cpu() for path, x in _paths(tree)}


def check_gnn_step(want, got, what, lr):
    """One train step from one state on the CPU (``want``) and the card:
    parameters and Adam's moments at ``tests/test_torch_gnn.py``'s
    tolerances; an element whose gradient (``m / (1 - b1)`` after the
    first step) is nonzero but below ``GNN_NEAR_ZERO`` of its tensor's max
    (a layer's, in the stacked leaves) is held to 2.01 lr (Adam's first
    step is ``lr * sign(g)``).  Returns (max |param diff| elsewhere,
    near-zero elements)."""
    params = (_flat_leaves(want["params"]), _flat_leaves(got["params"]))
    ms = (_flat_leaves(want["opt"]["m"]), _flat_leaves(got["opt"]["m"]))
    vs = (_flat_leaves(want["opt"]["v"]), _flat_leaves(got["opt"]["v"]))
    worst, n_near = 0.0, 0
    for path, w in params[0].items():
        g = params[1][path]
        grad = ms[0][path].double().abs() / 0.1
        # a stacked [L, ...] leaf is L tensors: each layer's own max
        top = grad.flatten(1).amax(1).view(-1, *[1] * (grad.dim() - 1)) if \
            path.startswith("/layers/") else grad.max()
        near = (grad != 0) & (grad < GNN_NEAR_ZERO * top)
        n_near += int(near.sum())
        keep = ~near
        rtol, atol = GNN_STATE_TOL["params"]
        if not torch.allclose(g[keep], w[keep], rtol=rtol, atol=atol) or (
                near.any() and float((g[near] - w[near]).abs().max()) > 2.01 * lr):
            raise AssertionError(f"{what} {path}: params differ by "
                                 f"{float((g - w).abs().max())}")
        worst = max(worst, float((g[keep] - w[keep]).abs().max()) if keep.any() else 0.0)
        for part, (a, b) in (("m", ms), ("v", vs)):
            rtol, atol = GNN_STATE_TOL[part]
            if not torch.allclose(b[path], a[path], rtol=rtol, atol=atol):
                raise AssertionError(f"{what} {path} {part}: differ by "
                                     f"{float((b[path] - a[path]).abs().max())}")
    return worst, n_near


def _gnn_run_steps(model, state, batches):
    losses = []
    for b in batches:
        state, m = model.train_step(state, b)
        losses.append(m["loss"])
    return [float(x) for x in losses], _flat_leaves(state)


def gnn_full_graph_phase(dev, n_serve=GNN_SERVE, n_train=GNN_TRAIN):
    """Phase 17a, full_graph_sm: Cora padded (N 3 072, E 10 752, 1 433
    features, 7 classes), TF32 off.  The card's logits against the same
    model's forward on the CPU (rtol 1e-4, atol 1e-5 * max|logit|); one
    train step's loss and state against the CPU's; two deterministic runs
    of 2 steps bitwise equal; then the timed serve and train calls."""
    from repro_torch.data import graphs

    model, n, e, _ = _gnn("full_graph_sm")
    cfg = model.cfg
    t0 = time.perf_counter()
    nbs = [graphs.full_graph_batch(n, e, cfg.d_feat, cfg.n_classes, s) for s in range(3)]
    host_s = (time.perf_counter() - t0) / len(nbs)
    log(f"17a full_graph_sm: N {n} and E {e} (Cora's 2 708 / 10 556 padded to 512), "
        f"{cfg.d_feat} features, {cfg.n_classes} classes; {host_s} s a batch on the host")
    cpu_state = model.init(0, device="cpu")
    state = _gnn_state_to(cpu_state, dev)
    cb, batches = _gnn_batch(nbs[0], "cpu"), [_gnn_batch(b, dev) for b in nbs]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = model.serve_step(cpu_state, cb)[0]
        got = model.serve_step(state, batches[0])[0].cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=GNN_LOGIT_RTOL, atol=1e-5 * scale):
            raise AssertionError(f"17a logits: card vs CPU max |diff| {err} (max|logit| {scale})")
        log(f"17a logits [{n}, {cfg.n_classes}]: card = CPU within rtol {GNN_LOGIT_RTOL}, atol "
            f"1e-5 * max|logit| (max |diff| {err}, {err / scale} of max|logit| {scale})")
        w_state, w_m = model.train_step(cpu_state, cb)
        g_state, g_m = model.train_step(state, batches[0])
        w_loss, g_loss = float(w_m["loss"]), float(g_m["loss"])
        if not np.isclose(g_loss, w_loss, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"17a train step loss: card {g_loss}, CPU {w_loss}")
        worst, n_near = check_gnn_step(w_state, g_state, "17a train step", cfg.lr)
        log(f"17a one train step: loss card {g_loss} CPU {w_loss}; parameters within rtol 1e-5 / "
            f"atol 2e-4 (max |diff| {worst}), {n_near} near-zero gradient elements held to 2.01 "
            f"lr, m and v within tests/test_torch_gnn.py's tolerances")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    with deterministic():
        runs = [_gnn_run_steps(model, _gnn_state_to(cpu_state, dev), batches[:2])
                for _ in range(2)]
    (l0, s0), (l1, s1) = runs
    if l0 != l1 or any(not torch.equal(s0[k], s1[k]) for k in s0):
        raise AssertionError(f"17a deterministic runs differ: losses {l0} vs {l1}")
    log(f"17a: two runs of 2 train steps under deterministic algorithms bitwise equal (losses "
        f"{l0}, every state leaf)")
    out = gnn_run(model, state, batches, "17a full_graph_sm", n_serve, n_train, census=True)
    return dict(out, host_s=host_s, logit_err=err / scale)


def gnn_minibatch_phase(dev, n_serve=GNN_SERVE, n_train=GNN_TRAIN):
    """Phase 17b, minibatch_lg: a fresh ``sampled_batch`` (1 024 seeds,
    fanouts 15 and 10: N 169 984, E 168 960) a step from a random graph of
    Reddit's node and edge count, 602 features, 41 classes."""
    from repro_torch.data import graphs

    model, n, e, _ = _gnn("minibatch_lg")
    cfg = model.cfg
    t0 = time.perf_counter()
    indptr, indices, _ = graphs.random_graph_csr(REDDIT_NODES, REDDIT_EDGES, 0)
    csr_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(REDDIT_NODES, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, REDDIT_NODES).astype(np.int32)
    t0 = time.perf_counter()
    nbs = [graphs.sampled_batch(indptr, indices, feats, labels, GNN_SEEDS, GNN_FANOUTS, 0, s)
           for s in range(max(n_serve, n_train) + 1)]
    host_s = (time.perf_counter() - t0) / len(nbs)
    if nbs[0]["feat"].shape[0] != n or nbs[0]["src"].shape[0] != e:
        raise AssertionError(f"17b block: N {nbs[0]['feat'].shape[0]}, E "
                             f"{nbs[0]['src'].shape[0]}; want {n}, {e}")
    pad = float(np.mean([(b["src"] < 0).mean() for b in nbs]))
    log(f"17b minibatch_lg: graph of {REDDIT_NODES} nodes and {REDDIT_EDGES} edges in {csr_s} s "
        f"on the host; blocks of {GNN_SEEDS} seeds, fanouts {GNN_FANOUTS}: N {n}, E {e} "
        f"({pad} of the edges padding), {host_s} s a block on the host")
    del feats
    batches = [_gnn_batch(b, dev) for b in nbs]
    del nbs
    state = model.init(0, device=dev)
    out = gnn_run(model, state, batches, "17b minibatch_lg", n_serve, n_train)
    return dict(out, host_s=host_s, csr_s=csr_s)


def gnn_molecule_phase(dev, n_serve=GNN_SERVE, n_train=GNN_TRAIN):
    """Phase 17c, molecule: 128 graphs of up to 30 nodes and 64 edges, 16
    features, graph regression; checks every graph pools at least one node."""
    from repro_torch.core.lanes import segment_sum
    from repro_torch.data import graphs

    model, n, e, extra = _gnn("molecule")
    cfg = model.cfg
    g = extra["n_graphs"]
    t0 = time.perf_counter()
    nbs = [graphs.molecule_batch(g, n // g, e // g, cfg.d_feat, 0, s)
           for s in range(max(n_serve, n_train) + 1)]
    host_s = (time.perf_counter() - t0) / len(nbs)
    batches = [_gnn_batch(b, dev) for b in nbs]
    counts = [segment_sum((b["node_mask"] > 0).float()[:, None], b["graph_id"], g)
              for b in batches]
    least = min(float(c.min()) for c in counts)
    if least < 1:
        raise AssertionError(f"17c: a graph pools {least} nodes")
    log(f"17c molecule: {g} graphs, N {n}, E {e}, {cfg.d_feat} features, graph regression; "
        f"{host_s} s a batch on the host; every graph pools >= 1 node (least {least})")
    state = model.init(0, device=dev)
    out = gnn_run(model, state, batches, "17c molecule", n_serve, n_train)
    return dict(out, host_s=host_s)


def gnn_ogb_phase(dev, n_serve=OGB_SERVE):
    """Phase 17d, ogb_products at published width (N 2 449 408, 100
    features, 47 classes): ``serve_step`` only.  The edges are halved (a
    uniform 1/k sample of the graph's 61 859 328) until the forward fits;
    then one train step at that cut, which is expected not to fit."""
    from repro_torch.data import graphs

    model, n, e, _ = _gnn("ogb_products")
    cfg = model.cfg
    t0 = time.perf_counter()
    nb = graphs.full_graph_batch(n, e, cfg.d_feat, cfg.n_classes, 0)
    host_s = time.perf_counter() - t0
    log(f"17d ogb_products: N {n}, E {e}, {cfg.d_feat} features, {cfg.n_classes} classes; "
        f"{host_s} s to build the batch on the host; one edge tensor [E, {cfg.d_hidden}] fp32 "
        f"= {e * cfg.d_hidden * 4 / 1e9} GB")
    state = model.init(0, device=dev)
    feat = torch.from_numpy(nb["feat"]).to(dev)
    for k in (1, 2, 4, 8):
        b = {"feat": feat, "src": torch.from_numpy(nb["src"][::k].copy()).to(dev),
             "dst": torch.from_numpy(nb["dst"][::k].copy()).to(dev)}
        torch.cuda.reset_peak_memory_stats()
        try:
            logits, ms = sync_ms(lambda b=b: model.serve_step(state, b)[0])
            break
        except torch.OutOfMemoryError as err:
            log(f"17d: the forward at E {b['src'].shape[0]} ({1 / k} of {e}) does not fit: "
                f"peak {torch.cuda.max_memory_allocated() / 1e9} GB before the failed "
                f"allocation ({str(err)[:160]})")
        del b
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError("17d: no edge cut down to 1/8 fits the forward")
    first_peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits).all()) or tuple(logits.shape) != (n, cfg.n_classes):
        raise AssertionError(f"17d logits: shape {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    cut = b["src"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    lat = [sync_ms(lambda: model.serve_step(state, b)[0])[1] for _ in range(n_serve)]
    peak = torch.cuda.max_memory_allocated()
    stats = {}
    profile_call("one 17d ogb_products serve", lambda: model.serve_step(state, b)[0],
                 stats=stats)
    idle = 1 - stats["busy"] / stats["wall"] if stats else None
    p50 = float(np.percentile(lat, 50))
    log(f"17d ogb_products serve: CUT (reduced) E {cut} = {cut / e} of {e} (every {k}-th edge), "
        f"N {n} whole; first call {ms} ms, peak {first_peak / 1e9} GB; serve ms {lat} (p50 {p50}, "
        f"p99 {float(np.percentile(lat, 99))}, {n / p50 * 1e3} nodes/s), peak {peak / 1e9} GB; "
        f"a profiled serve: idle share {idle}, {stats.get('ops')} device ops")
    torch.cuda.reset_peak_memory_stats()
    try:
        model.train_step(state, dict(b, label=torch.from_numpy(nb["label"]).to(dev),
                                     label_mask=torch.from_numpy(nb["label_mask"]).to(dev)))
        torch.cuda.synchronize()
        train = f"fits at E {cut}, peak {torch.cuda.max_memory_allocated() / 1e9} GB"
    except torch.OutOfMemoryError as err:
        train = (f"does not fit at E {cut}: peak {torch.cuda.max_memory_allocated() / 1e9} GB "
                 f"before the failed allocation ({str(err)[:160]})")
    log(f"17d: one train step (autograd keeps each layer's edge tensors for the backward; no "
        f"remat or edge sharding, as in the reference) {train}")
    del b, feat
    gc.collect()
    torch.cuda.empty_cache()
    return {"cut": cut, "share": cut / e, "serve_p50": p50, "peak_gb": peak / 1e9, "idle": idle,
            "ops": stats.get("ops"), "host_s": host_s, "train": train}


def _live_pairs(s, window):
    """(q, k) pairs a causal mask with this window keeps: sum_q min(q+1, W)."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _flash_work(q, k, window, ops_per_s):
    """FLOP over the live (q, k) pairs of a causal layer (q.k and p.v), the
    bytes of q, k, v read and o written, and the bound: the larger of the
    FLOP at ``ops_per_s`` and the bytes at 3.35 TB/s, in ms."""
    b, hq, s, d = q.shape
    flops = 4 * d * _live_pairs(s, window) * b * hq
    n_bytes = (2 * b * hq + 2 * b * k.shape[1]) * s * d * q.element_size()
    ops_ms, bytes_ms = 1e3 * flops / ops_per_s, 1e3 * n_bytes / HBM_BYTES_PER_S
    return flops, n_bytes, ops_ms, bytes_ms


def _simt_call(q, k, v, causal, window):
    """The SIMT kernel straight through its C entry (no launch counted): the
    fp32 route's before figure, on [B, H, S, D] views, as the wrapper
    would launch it."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    launch = build.entry(fa_kernel.SOURCE, "flash_attention_fwd",
                         fa_kernel.ARGTYPES + (ctypes.c_void_p,))
    w = 0 if window is None else max(-sk, min(window, sq))

    def call():
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk,
                     d, *q.stride(), *k.stride(), *v.stride(), *out.stride(), 1.0 / math.sqrt(d),
                     int(causal), int(window is not None), w,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"SIMT flash kernel launch failed: CUDA error {err}")
        return out

    return call


def time_flash(smol, gemma, fp32, errs, ptxas, simt_live):
    """The bf16 tensor-core kernel, its plain version and
    F.scaled_dot_product_attention on the live layer-0 inputs of a SmolLM
    prefill, the same kernel on Gemma's live windowed layer-0 inputs, and
    on phase 11's live fp32 inputs the 3xTF32 kernel, the SIMT kernel
    (called straight, the before figure) in turns (SIMT, 3xTF32, 3xTF32,
    SIMT), plain and SDPA; and the SIMT kernel on phase 9's d 256 inputs
    (:func:`time_simt`).  The bf16 kernel's device time a launch comes
    from phase 10's profiled prefill: on an H100, a profile of back-to-back
    calls here, late in the process, lost most of a kernel's events (2.2 ms
    reported for 11.2 ms); the 3xTF32 kernel's from guarded windows that
    are retaken until whole (``device_ms``), beside phase 11's profiled
    prefill."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    def views(live):
        return [t.transpose(1, 2) for t in live[:3]]  # [B, H, S, D] views

    entries = []
    for name, source, live, window, ops_per_s, launches_by_path, err in (
            ("flash_attention", fa_kernel.SM90_SOURCE, smol["live"], None, BF16_OPS_PER_S,
             {"smollm_prefill": smol["launches"], "gemma_prefill": gemma["launches"]},
             max(errs["wgmma"], smol["err"], gemma["err"])),
            ("flash_attention_fp32", fa_kernel.TF32_SOURCE, fp32["live"], None, FP32_OPS_PER_S,
             {f"smollm_fp32 {call}": n for call, n in fp32["launches_by_call"].items()},
             max(errs["tf32x3"], fp32["err"]))):
        q, k, v = views(live)
        calls = {"kernel": lambda: fa_kernel.flash_attention(q, k, v, True, window),
                 "plain": lambda: fa_kernel.flash_attention_plain(q, k, v, True, window),
                 "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                enable_gqa=True)}
        tf32 = source == fa_kernel.TF32_SOURCE
        if tf32:  # the SIMT kernel's before figure, in turns with the kernel
            simt = _simt_call(q, k, v, True, window)
            turns = [cuda_ms(fn, iters=10) for fn in (simt, calls["kernel"], calls["kernel"], simt)]
            ev = {"kernel": (turns[1] + turns[2]) / 2, "simt": (turns[0] + turns[3]) / 2}
            ev.update({n: cuda_ms(calls[n], iters=10) for n in ("plain", "sdpa")})
        else:
            ev = {n: cuda_ms(fn, iters=10) for n, fn in calls.items()}
        enqueue = host_ms(calls["kernel"])
        flops, n_bytes, ops_ms, bytes_ms = _flash_work(q, k, window, ops_per_s)
        log(f"{name} on live layer-0 q/k/v {tuple(q.shape)} / {tuple(k.shape)} {q.dtype}: "
            f"event-timed ms kernel {ev['kernel']}, plain {ev['plain']}, sdpa {ev['sdpa']} "
            f"(kernel / sdpa {ev['kernel'] / ev['sdpa']}); host enqueue {enqueue} ms; bound "
            f"{max(ops_ms, bytes_ms)} ms ({flops} FLOP at {ops_per_s / 1e12} TFLOP/s: {ops_ms} "
            f"ms; {n_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s: {bytes_ms} ms); achieved "
            f"{flops / ev['kernel'] / 1e9} TFLOP/s")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": os.path.relpath(source, ROOT),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": err,
            "ms": ev["kernel"],
            "plain_ms": ev["plain"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": ev["sdpa"],
            "host_enqueue_ms": enqueue,
            "flops": flops,
            "bytes": n_bytes,
        })
        if tf32:
            dev_ms, by_op = device_ms(calls["kernel"], iters=10)
            tc_floor = 1e3 * 3 * flops / TF32_OPS_PER_S  # three TF32 products an fp32 one
            entries[-1].update({
                "device_ms": dev_ms, "device_ms_by_op": by_op,
                "prefill_device_ms": fp32["prefill_device_ms"],
                "tf32x3_bound_ms": tc_floor, "before_ms": ev["simt"],
                "before": {"kernel": "flash_attention.cu (SIMT)", "turns_ms": turns},
                "prefill_ms": fp32["prefill_ms"], "ptxas": ptxas["tf32x3"]})
            log(f"{name}: 3xTF32 kernel {ev['kernel']} ms (turns {turns[1]}, {turns[2]}) against "
                f"the SIMT kernel's {ev['simt']} ms (turns {turns[0]}, {turns[3]}) in the same "
                f"call, {ev['simt'] / ev['kernel']}x; device ms a call "
                f"{'not measured' if dev_ms is None else dev_ms} (by op {json.dumps(by_op)}; "
                f"{fp32['prefill_device_ms']} a launch in phase 11's profiled prefill); its "
                f"three TF32 products' floor {tc_floor} ms ({3 * flops} FLOP at "
                f"{TF32_OPS_PER_S / 1e12} TFLOP/s); fraction of the fp32 bound "
                f"{max(ops_ms, bytes_ms) / ev['kernel']}")
    tc = entries[0]
    tc["device_ms"] = smol["device_ms"]
    tc["ptxas"] = ptxas["wgmma"]
    q, k, v = views(gemma["live"])
    window = gemma["live"][4]
    g_ms = cuda_ms(lambda: fa_kernel.flash_attention(q, k, v, True, window), iters=10)
    flops, n_bytes, ops_ms, bytes_ms = _flash_work(q, k, window, BF16_OPS_PER_S)
    tc["gemma_window"] = {"ms": g_ms, "bound_ms": max(ops_ms, bytes_ms), "flops": flops,
                          "window": window}
    log(f"flash_attention on gemma's live layer-0 q/k/v {tuple(q.shape)} / {tuple(k.shape)} "
        f"window {window}: event-timed {g_ms} ms; bound {max(ops_ms, bytes_ms)} ms ({flops} "
        f"FLOP at {BF16_OPS_PER_S / 1e12} TFLOP/s); achieved {flops / g_ms / 1e9} TFLOP/s")
    entries[1]["simt_d256"] = time_simt(*simt_live)
    return entries


def time_simt(q, k, v, causal, window):
    """The SIMT kernel (fp32 heads of 129-256) on phase 9's d 256 inputs
    ([B, S, H, D]), through its C entry, beside its plain version and SDPA
    with the same mask, and its bound: the FLOP of the (q, k) pairs the
    mask keeps at 67 TFLOP/s against the bytes of q, k, v and o at 3.35
    TB/s."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D] views
    b, hq, s, d = q.shape
    qi, ki = torch.arange(s, device=q.device)[:, None], torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= (qi - ki) < window
    pairs = int(mask.sum())
    flops = 4 * d * pairs * b * hq
    n_bytes = (2 * b * hq + 2 * b * k.shape[1]) * s * d * q.element_size()
    ops_ms, bytes_ms = 1e3 * flops / FP32_OPS_PER_S, 1e3 * n_bytes / HBM_BYTES_PER_S
    ev = {"kernel": cuda_ms(_simt_call(q, k, v, causal, window)),
          "plain": cuda_ms(lambda: fa_kernel.flash_attention_plain(q, k, v, causal, window)),
          "sdpa": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                 enable_gqa=True))}
    bound = max(ops_ms, bytes_ms)
    log(f"flash_attention SIMT kernel on phase 9's fp32 d {d} inputs {tuple(q.shape)} / "
        f"{tuple(k.shape)} (causal {causal}, window {window}; {pairs} live pairs a head): "
        f"event-timed ms kernel {ev['kernel']}, plain {ev['plain']}, sdpa {ev['sdpa']}; bound "
        f"{bound} ms ({flops} FLOP at {FP32_OPS_PER_S / 1e12} TFLOP/s: {ops_ms} ms; {n_bytes} B "
        f"at {HBM_BYTES_PER_S / 1e12} TB/s: {bytes_ms} ms); fraction of the bound "
        f"{bound / ev['kernel']}")
    return {"ms": ev["kernel"], "plain_ms": ev["plain"], "library_ms": ev["sdpa"],
            "bound_ms": bound, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": n_bytes, "shape": list(q.shape)}


def ptxas_usage(report, symbol):
    """Registers and spill bytes of each instantiation of the kernel
    ``symbol`` in an ``nvcc -Xptxas -v`` report, named by its template
    arguments (the bf16 kernel's <64-column atoms of the head, copy bytes>,
    the 3xTF32 kernel's <64-column atoms>), and whether ptxas serialised
    its wgmma pipeline (warning C7518)."""
    rows, name, spills = [], None, None
    serialised = {m.group(1) for m in re.finditer(
        r"C7518\).*?" + symbol + r"I((?:Li\d+E)+)E", report)}
    for line in report.splitlines():
        m = re.search(symbol + r"I((?:Li\d+E)+)E", line)
        if m and "Function properties" in line:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append({"kernel": "<" + ", ".join(re.findall(r"\d+", name)) + ">",
                         "registers": int(m.group(1)), "spill_bytes": spills,
                         "serialised": name in serialised})
            name = None
    return rows


def check_resident(rows, slot_to_row, full, what):
    """After a flush: every resident slot's arena row (``rows``, the arena's
    fp32 ``[capacity, dim]`` view) equals its host row in ``full``,
    bitwise; a flush that left no slot resident fails too."""
    resident = torch.nonzero(slot_to_row >= 0)[:, 0]
    if not resident.numel():
        raise AssertionError(f"{what} post-flush: no resident slot to check")
    got = rows[resident].cpu()
    want = full.decode_rows(slot_to_row[resident].cpu().to(torch.int64))["weight"]
    if not torch.equal(got, want):
        diff = float((got - want).abs().max())
        raise AssertionError(f"{what} post-flush: arena rows != host rows (max |diff| {diff})")
    log(f"{what} post-flush: all {resident.numel()} resident arena rows of "
        f"{slot_to_row.numel()} slots equal their host rows bitwise")


def profile_call(what, fn, skip=(), stats=None):
    """Device time by kernel over one call of ``fn`` (torch.profiler); a
    machine where the profiler cannot trace the card reports it as not
    measured.  ``skip`` names span annotations to leave out; a ``stats``
    dict receives the wall and busy ms and the device ms by kernel."""
    from torch.autograd import DeviceType

    try:
        with profiled() as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    except RuntimeError as e:
        log(f"profiler: not measured ({e})")
        return None

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels and copies): CPU ops would count their
    # kernels twice, and span annotations cover whole calls
    events = prof.key_averages()
    rows = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.key not in skip
                   and GUARD_KERNEL not in e.key), key=lambda e: -dev_us(e))
    busy = sum(dev_us(e) for e in rows) / 1e3
    top = [(e.key[:60], e.count, dev_us(e) / 1e3) for e in rows[:12]]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU and e.key not in skip),
                  key=lambda e: -e.self_cpu_time_total)
    top_host = [(e.key[:40], e.count, e.self_cpu_time_total / 1e3) for e in host[:10]]
    if stats is not None:
        stats.update(wall=wall, busy=busy, by_kernel={e.key: dev_us(e) / 1e3 for e in rows},
                     ops=sum(e.count for e in rows))
    log(f"profiler: {what} {wall} ms wall, device busy {busy} ms (sum of kernel and copy "
        f"times; idle share {1 - busy / wall}); top device (name, calls, ms): {top}; "
        f"top host ops by self time (name, calls, ms): {top_host}")
    return out


def time_in_fresh_process(jobs):
    """Phase 8 (the kernel timings on their live inputs: gather-decode, the
    bag, FM, the threshold, the bucketize) run by a child process of this
    script, which loads ``jobs``
    from a file, times them on the same card and writes back their
    ``kernels`` rows.  Late in a long process ``torch.profiler`` drops the
    device events of short windows around the port's kernels, whatever ran
    before (``scripts/profiler_probe.py``: lost after 150-300 s of age in
    an idle process too); a fresh process records them."""
    path = os.path.join(ROOT, "build", f"phase8-{os.getpid()}.pt")
    torch.save(jobs, path)
    try:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels", path],
                       check=True, timeout=900)
        with open(path + ".json") as f:
            return json.load(f)
    finally:
        for name in (path, path + ".json"):
            if os.path.exists(name):
                os.remove(name)


def time_kernels(path):
    """The child's side of :func:`time_in_fresh_process`."""
    jobs = torch.load(path, weights_only=True)
    floor_row, floor = time_launch_floor()
    rows = {"launch_floor": floor_row,
            "gather_decode": time_gather_decode(*jobs["gather_decode"], floor=floor),
            "gather_decode_encode": time_gather_decode_encode(*jobs["gather_decode_encode"],
                                                              floor=floor)}
    rows["bucketize"], rows["route_bucketize"] = time_bucketize(*jobs["bucketize"], floor=floor)
    live, multi, bag_err, bag_launches = jobs["bag"]
    for f, a in live.items():  # f0, then the largest-vocab feature
        time_bag(f, a)
    rows["bag"] = time_bag_multi(multi, bag_err, bag_launches)
    rows["bag"]["step_routes"] = time_bag_routes(multi)
    rows.update(fm=time_fm(*jobs["fm"]), threshold=time_threshold(*jobs["threshold"]))
    with open(path + ".json", "w") as f:
        json.dump(rows, f)


def deterministic():
    """torch's deterministic algorithms, for comparisons of two runs bit
    for bit (``repro_torch.device.deterministic``: on the card
    ``index_add_``, the gather's backward, sums a row's duplicate lanes with
    atomics in no fixed order, and the mode sums them in a fixed one)."""
    from repro_torch.device import deterministic as det

    return det()


def timed(what, fn, *args):
    """``fn(*args)``, logging the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {what}: {time.perf_counter() - t0} s")
    return out


CENSUS = {}  # path -> its census, printed on a line of its own at the end


def census_call(what, fn):
    """``fn()`` under the sync census (``analysis.census``): logs its syncs by
    site, fails on a site in the port that the baseline's ``sync_sites``
    does not hold.  Returns ``fn()``'s result."""
    from repro_torch.analysis import run as gate
    from repro_torch.analysis.census import sync_census

    held = {s["site"] for s in json.loads(gate._DEFAULT_BASELINE.read_text())["sync_sites"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_census() as c:
        out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    summary = c.summary()
    unheld = {site: f for site, f in c.port_sites().items() if site not in held}
    CENSUS[what] = dict(summary, unheld=unheld, seconds=secs)
    log(f"census {what}: {summary['syncs']} host syncs ({summary['documented']} documented) "
        f"by site {json.dumps(summary['by_site'])}; by thread {json.dumps(summary['by_thread'])}; "
        f"sites in the port outside the baseline: {unheld or 'none'}; {secs} s")
    if unheld:
        raise AssertionError(f"census {what}: host syncs at sites the baseline does not hold: "
                             f"{unheld}")
    return out


# the hand-written kernels each smoke case of the gate must launch on the card
GATE_KERNELS = ("victim_threshold", "bucketize", "route_bucketize", "gather_decode",
                "gather_decode_encode", "embedding_bag", "fm_interaction", "flash_wgmma",
                "flash_tf32x3", "flash_simt")


def gate_phase():
    """Phase 18: the contract gate on the card, in a fresh child process."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.run", "--strict",
                          "--device", "cuda", "--json"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        log(out.stdout[-4000:])
        log(out.stderr[-4000:])
        raise AssertionError(f"phase 18: the gate exited {out.returncode} on the card")
    rep = json.loads(out.stdout)
    launches, synced = {}, {}  # over the kernels' own entries (repro_torch.kernels.*)
    for name, e in rep["per_entry"].items():
        if not name.startswith("repro_torch.kernels."):
            continue
        for k, n in e["launches"].items():
            launches[k] = launches.get(k, 0) + n
        if e["syncs"] or e["documented"]:
            synced[name] = (e["syncs"], e["documented"])
    log(f"phase 18 gate: {len(rep['entries'])} entries on {rep['device']}: {rep['entries']}")
    for v in rep["baselined"]:
        log(f"  known {v['check']} {v['entry']}: {v['detail'][:300]} ({v['rationale']})")
    for name, e in rep["per_entry"].items():
        log(f"  entry {name}: syncs by site {e['syncs']}, documented {e['documented']}, "
            f"largest sort {e['largest_sort']}, kernel launches {e['launches']}")
    missing = [k for k in GATE_KERNELS if not launches.get(k)]
    if missing or synced:
        raise AssertionError(f"phase 18: kernels not launched by the smoke cases {missing}; "
                             f"kernel entries that synced {synced}")
    secs = time.perf_counter() - t0
    log(f"phase 18: exit 0, {len(rep['new'])} new, {len(rep['baselined'])} baselined, "
        f"{len(rep['stale_baseline'])} stale; the kernel entries' cases launched {launches} in "
        f"the child, none with a sync; {secs} s")
    return secs


# ----- phase 20: the port's four examples ---------------------------------------------

EX_RESUME = (50, 100)  # train_dlrm: a run cut at its checkpoint (ckpt_every 50), resumed
EX_STEPS = 50  # train_dlrm's budget and pipelined runs
EX_RTOL = 1e-4  # card vs CPU losses and scores (default mode); the resumed curve
EX_COUNTS = ("cache_hits", "cache_misses", "cache_evictions", "host_wire_bytes")
EX_OFF_PATH = ("embedding_bag", "fm_interaction", "flash_attention")  # no example launches them


def example_module(name):
    """``examples/<name>.py`` (the port's examples import ``repro_torch`` only)."""
    import importlib

    path = os.path.join(ROOT, "examples")
    if path not in sys.path:  # the spawned ranks import the example by name too
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _kernel_launches():
    """Every kernel wrapper's launch count (``repro_torch.kernels.counters``:
    the one table the examples' ranks read too), the flash kernel's also by
    route."""
    from repro_torch.kernels import counters

    return counters.launch_counts()


def zero_launch_counts():
    from repro_torch.kernels import counters

    counters.zero_launch_counts()


@contextlib.contextmanager
def cpu_drawn_init(*classes):
    """Each class's ``init`` draws on the CPU and moves the state to the
    asked device through numpy (``convert``): a card run starts from the
    weights of the CPU run it is held to (the two devices' generators draw
    different numbers)."""
    from repro_torch import convert

    saved = {cls: cls.init for cls in classes}

    def wrap(orig):
        def init(self, seed, counts=None, device=None):
            state = orig(self, seed, counts=counts, device="cpu")
            if device is not None and torch.device(device).type == "cpu":
                return state
            return convert.state_from_numpy(convert.to_numpy(state), device=device,
                                            collection=self.collection)
        return init

    for cls, orig in saved.items():
        cls.init = wrap(orig)
    try:
        yield
    finally:
        for cls, orig in saved.items():
            cls.init = orig


def run_example(name, argv, card=True, what=None):
    """``main(argv)`` of the example on the card (its launches counted from
    0 just before and read just after) or with ``--device cpu``."""
    mod = example_module(name)
    argv = [*argv, "--device", "cuda" if card else "cpu"]
    if card:
        torch.cuda.synchronize()
        zero_launch_counts()
    t0 = time.perf_counter()
    out = mod.main(argv)
    if card:
        torch.cuda.synchronize()
        out["launches"] = _kernel_launches()
    out["seconds"] = time.perf_counter() - t0
    log(f"example {what or name} {' '.join(argv)}: {out['seconds']} s"
        + (f"; launches {json.dumps(out['launches'])}" if card else ""))
    return out


def _history_counts(h):
    return [[r[k] for k in EX_COUNTS] for r in h]


def check_example_history(card, cpu, what, rtol=EX_RTOL):
    """A card run's step counts equal the CPU run's; losses within ``rtol``."""
    if _history_counts(card) != _history_counts(cpu):
        raise AssertionError(f"{what}: card counts {_history_counts(card)[-3:]} != CPU "
                             f"{_history_counts(cpu)[-3:]} (last 3 steps)")
    a, b = np.array([r["loss"] for r in card]), np.array([r["loss"] for r in cpu])
    if len(a) != len(b) or not np.all(np.isfinite(a)) or not np.allclose(a, b, rtol=rtol,
                                                                         atol=0):
        raise AssertionError(f"{what}: card losses {a[-3:]} vs CPU {b[-3:]} beyond rtol {rtol}")
    return float(np.max(np.abs(a - b) / np.abs(b)))


def examples_phase(dev):
    """Phase 20: each of the port's four examples through its ``main`` on
    the card at its twin's sizes, held to the same example with ``--device
    cpu`` at the same arguments: hit, miss and eviction counts (and host
    wire bytes) equal, losses within ``EX_RTOL`` from the same weights, and
    each example's own checks (the cache equals the dense table, the
    pipelined losses bitwise the serial ones, the resume)."""
    from repro_torch import convert
    from repro_torch.models.dlrm import DLRM
    from repro_torch.models.recsys_models import MINDModel

    launches, p50, rel = {}, {}, {}

    card, cpu = (run_example("torch_quickstart", [], c) for c in (True, False))
    keys = ("hits", "misses", "evictions", "capacity")
    if [card[k] for k in keys] != [cpu[k] for k in keys] or not (card["exact"] and cpu["exact"]):
        raise AssertionError(f"quickstart: card {[card[k] for k in keys]} exact "
                             f"{card['exact']} vs CPU {[cpu[k] for k in keys]} {cpu['exact']}")
    launches["examples_quickstart"], p50["quickstart lookup"] = (
        card["launches"], float(np.median(card["step_ms"])))
    log(f"quickstart: hits {card['hits']}, misses {card['misses']}, evictions "
        f"{card['evictions']} on the card = the CPU run's; cache == dense table")

    with cpu_drawn_init(MINDModel):
        card, cpu = (run_example("torch_serve_recsys", [], c) for c in (True, False))
    keys = ("hits", "misses", "evictions")
    if [card[k] for k in keys] != [cpu[k] for k in keys]:
        raise AssertionError(f"serve_recsys: card {[card[k] for k in keys]} != CPU "
                             f"{[cpu[k] for k in keys]}")
    s_card, s_cpu = card["retrieval_scores"], cpu["retrieval_scores"]
    scale = float(np.abs(s_cpu).max())
    if not np.allclose(s_card, s_cpu, rtol=EX_RTOL, atol=EX_RTOL * scale):
        raise AssertionError(f"serve_recsys: retrieval scores differ by "
                             f"{np.abs(s_card - s_cpu).max()} (max |score| {scale})")
    rel["serve_recsys retrieval"] = float(np.abs(s_card - s_cpu).max() / scale)
    launches["examples_serve_recsys"], p50["serve_recsys batch"] = (
        card["launches"], float(np.median(card["batch_ms"])))
    log(f"serve_recsys: hits {card['hits']}, misses {card['misses']} = the CPU run's; top-5 "
        f"card {card['top5']}, CPU {cpu['top5']}")

    ck = os.path.join(ROOT, "build", f"examples-{os.getpid()}")
    dlrm_runs = (  # (key, arguments, checkpoint directory: the cut run's is resumed)
        ("cut", ["--steps", str(EX_RESUME[0])], "resume"),
        ("resume", ["--steps", str(EX_RESUME[1])], "resume"),
        ("budget", ["--steps", str(EX_STEPS), "--device-budget-mb", "20"], "budget"),
        ("pipeline", ["--verify-pipeline", "--pipeline-depth", "2", "--cache-ratio", "0.05",
                      "--steps", str(EX_STEPS)], None))
    shutil.rmtree(ck, ignore_errors=True)
    runs = {}
    try:
        with cpu_drawn_init(DLRM):
            for key, argv, ckpt in dlrm_runs:
                for on_card in (True, False):
                    a = argv + (["--ckpt-dir", os.path.join(ck, ckpt + ("" if on_card else "-cpu"))]
                                if ckpt else [])
                    runs[key, on_card] = run_example("torch_train_dlrm", a, on_card,
                                                     f"train_dlrm ({key})")
            whole = run_example("torch_train_dlrm", ["--steps", str(EX_RESUME[1]), "--ckpt-dir",
                                                     os.path.join(ck, "whole")],
                                True, "train_dlrm (uninterrupted)")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    for key in ("cut", "resume", "budget", "pipeline"):
        rel[f"train_dlrm {key}"] = check_example_history(
            runs[key, True]["history"], runs[key, False]["history"], f"train_dlrm ({key})")
        if runs[key, True]["plan"] != runs[key, False]["plan"]:
            raise AssertionError(f"train_dlrm ({key}): plans differ")
        launches[f"examples_train_dlrm_{key}"] = runs[key, True]["launches"]
        p50[f"train_dlrm {key} step"] = runs[key, True]["p50_ms"]
    pipe = runs["pipeline", True]
    rel["train_dlrm pipeline serial"] = check_example_history(
        pipe["serial_history"], runs["pipeline", False]["serial_history"],
        "train_dlrm (pipeline, its serial run)")
    if not (pipe["verified"] and runs["pipeline", False]["verified"]):
        raise AssertionError("train_dlrm --verify-pipeline did not verify")
    p50["train_dlrm pipeline serial step"] = pipe["serial_p50_ms"]
    resumed = runs["resume", True]["history"]
    if [r["step"] for r in resumed] != list(range(*EX_RESUME)):
        raise AssertionError(f"train_dlrm: the resumed run stepped {resumed[0]['step']}.."
                             f"{resumed[-1]['step']}, not {EX_RESUME[0]}..{EX_RESUME[1] - 1}")
    rel["train_dlrm resume vs uninterrupted"] = check_example_history(
        resumed, whole["history"][EX_RESUME[0]:], "train_dlrm (resumed vs uninterrupted)")
    check_example_history(runs["cut", True]["history"], whole["history"][:EX_RESUME[0]],
                          "train_dlrm (cut vs uninterrupted)")
    launches["examples_train_dlrm_uninterrupted"] = whole["launches"]
    budget = runs["budget", True]
    log(f"train_dlrm: plan {runs['cut', True]['plan']}; budget plan {budget['plan']} (device "
        f"bytes {budget['device_bytes']['device_total']} of 20 000 000); the budget run "
        f"launched gather_decode {budget['launches']['gather_decode']} times; the resumed curve {EX_RESUME[0]}..{EX_RESUME[1] - 1} = the "
        f"uninterrupted run's within rtol {EX_RTOL}, counts equal")

    mds = example_module("torch_multi_device_scaling")
    init = DLRM(mds.CFG).init(0, counts=mds.counts(), device="cpu")  # the stacked layout
    init_np = convert.to_numpy(init)
    card, cpu = (mds.main(["--device", d], init_state=init_np) for d in ("cuda", "cpu"))
    if ({len(r["steps"]) for r in card["ranks"] + cpu["ranks"]} != {mds.STEPS}
            or not len(card["ranks"]) == len(cpu["ranks"]) == mds.WORLD):
        raise AssertionError("multi_device_scaling: a rank is missing, or a step")
    for r_card, r_cpu in zip(card["ranks"], cpu["ranks"]):
        what = f"multi_device_scaling rank {r_card['rank']}"
        for s_card, s_cpu in zip(r_card["steps"], r_cpu["steps"]):
            for k in (*mds._EXACT, "exchange_bytes", "hit_rate"):
                if s_card[k] != s_cpu[k]:
                    raise AssertionError(f"{what}: {k} card {s_card[k]} != CPU {s_cpu[k]}")
        a = np.array([s["loss"] for s in r_card["steps"]])
        b = np.array([s["loss"] for s in r_cpu["steps"]])
        if not np.allclose(a, b, rtol=EX_RTOL, atol=0):
            raise AssertionError(f"{what}: losses card {a} vs CPU {b}")
        if r_card["assignments"] != r_cpu["assignments"] or r_card["device_bytes"] != r_cpu[
                "device_bytes"]:
            raise AssertionError(f"{what}: assignments or device bytes differ")
    # every rank reads every wrapper's count (the table of _kernel_launches)
    total = {k: sum(r["launches"][k] for r in card["ranks"]) for k in _kernel_launches()}
    launches["examples_multi_device_scaling"] = total
    p50["multi_device_scaling step (rank 0)"] = card["p50_ms"]
    log(f"multi_device_scaling: 8 gloo ranks sharing the card, (data=2, model=4), "
        f"{card['world_s']} s (the CPU world {cpu['world_s']} s); launches summed over the "
        f"ranks {json.dumps(total)}; counts = the CPU ranks', losses within rtol {EX_RTOL}")

    for path, n in launches.items():
        if n["victim_threshold"] <= 0:
            raise AssertionError(f"{path}: no victim-threshold launch on the card")
        if any(n[k] for k in EX_OFF_PATH):
            raise AssertionError(f"{path}: a kernel off the example's path launched: {n}")
    if total["route_bucketize"] <= 0:
        raise AssertionError("multi_device_scaling: no route_bucketize launch on the ranks")
    log(f"phase 20 p50 ms (host clock to a sync): {json.dumps(p50)}")
    log(f"phase 20 card vs CPU largest relative loss / score difference: {json.dumps(rel)}")
    return launches


def add_example_launches(rows, launches):
    """Each ``kernels`` row gains the examples' launches as ``examples_*``
    paths (0 where the row's kernel did not launch), and its total."""
    for key, row in rows.items():
        paths = row["launches_by_path"]
        for path, n in launches.items():
            paths[path] = n.get(key, 0)
        row["launches"] = sum(paths.values())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab-scale", type=float, default=1.0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=8)
    ap.add_argument("--time-kernels", default=None, help=argparse.SUPPRESS)  # phase 8's child
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # torch_rank_jobs: phase 19's rank jobs
    if args.time_kernels:
        time_kernels(args.time_kernels)
        return
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the DLRM computes in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    reports = build.build_all([kernel.SOURCE, kernel.GATHER_DECODE_SOURCE, fm_kernel.SOURCE,
                               eb_kernel.SOURCE, kernel.BUCKETIZE_SOURCE, fa_kernel.SOURCE,
                               fa_kernel.SM90_SOURCE, fa_kernel.TF32_SOURCE, EMPTY_SOURCE])
    log(f"build {time.perf_counter() - t0} s: " + " | ".join(
        f"{src.name}: {' '.join(r.split())}" for src, r in reports.items()))
    ptxas = {}
    for route, source, symbol, params in (
            ("wgmma", fa_kernel.SM90_SOURCE, WGMMA_SYMBOL, "head atoms of 64, copy bytes"),
            ("tf32x3", fa_kernel.TF32_SOURCE, TF32_SYMBOL, "head atoms of 64")):
        rows = ptxas[route] = ptxas_usage(reports.get(source, ""), symbol)
        log(f"{source.name} ptxas (kernel<{params}>: registers, spill bytes, wgmma serialised): "
            f"{[(r['kernel'], r['registers'], r['spill_bytes'], r['serialised']) for r in rows]}")
        if not rows or any(r["spill_bytes"] for r in rows):
            raise AssertionError(f"{source.name}: no ptxas report, or spills: {rows}")
    if any(r["serialised"] for r in ptxas["tf32x3"]):
        raise AssertionError(f"{fa_kernel.TF32_SOURCE.name}: ptxas serialised the wgmma "
                             f"pipeline: {ptxas['tf32x3']}")

    gate_s = gate_phase()

    from repro_torch.configs import fm
    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.models.dlrm import DLRM
    from repro_torch.models.recsys_models import FMModel

    spec = DLRM(CONFIG).collection.cached_slabs["__shared__"]  # the main paths' geometry
    fm_spec = FMModel(fm.CONFIG).collection.cached_slabs["__shared__"]
    max_err = kernel_phase(dev, spec.capacity, spec.unique_size(), spec.vocab)
    rng = np.random.default_rng(1)  # FM: the unique bound equals the capacity (kv == capacity)
    for what, key in (("FM planner keys", _freq_lfu_keys(rng, fm_spec.capacity, fm_spec.vocab,
                                                          n_protect=fm_spec.capacity // 3)),
                      ("FM tie-heavy keys", _tie_heavy(rng, fm_spec.capacity))):
        key = torch.from_numpy(key).to(dev)
        max_err = max(max_err, check_threshold(key, fm_spec.unique_size(), what))
    log(f"threshold at FM's shape: capacity {fm_spec.capacity}, kv {fm_spec.unique_size()}: "
        f"kernel bitwise = plain, victim order = argsort, on planner and tie-heavy keys")
    gd_err = gather_decode_phase(dev)
    fm_err = fm_kernel_phase(dev)
    bag_err = bag_kernel_phase(dev)
    bz_err = bucketize_kernel_phase(dev)
    log(f"host RSS before serve {rss_gb()} GB")
    serve_launches, key, kv, err = serve_phase(dev, args.vocab_scale, args.batches)
    gc.collect()
    log(f"host RSS after serve (table unpinned and freed) {rss_gb()} GB")
    train = train_phase(dev, args.vocab_scale, args.train_steps)
    live_bag_err = max(check_bag(a, f"live bag feature {f}")[0]
                       for f, a in train["bag_live"].items())
    check_bag_multi(train["bag_multi"], "the live bag step")
    arena = train["arena"]
    # phase 8's live inputs of this path, timed at the end (time_in_fresh_process)
    jobs = {"gather_decode": (train["captured"], (arena.head["weight"], arena.tail["weight"],
                                                  arena.sideband["weight"]),
                              max(gd_err, train["live_err"]), train["launches"]),
            "bag": (train["bag_live"], train["bag_multi"], max(bag_err, live_bag_err),
                    train["bag_launches"])}
    gd_launches, bag_launches = train["launches"], train["bag_launches"]
    train["full"].close()
    train_thr = train["thr_launches"]
    del train
    gc.collect()
    log(f"host RSS after train (table unpinned and freed) {rss_gb()} GB")
    # 5b serves as many batches as 19a's ranks, which are held to its counts
    sharded = sharded_phase(dev, args.vocab_scale, min(args.batches, DIST_SERVE),
                            args.train_steps)
    gc.collect()
    log(f"host RSS after sharded (table unpinned and freed) {rss_gb()} GB")
    sharded_crosscheck(dev)
    gc.collect()
    with deterministic():
        sh_pipe = timed("5b (sharded pipelined cross-check)", sharded_pipelined_crosscheck, dev)
    gc.collect()
    # phase 19 after 5b, whose counts 19a's ranks are held to; no table is pinned here
    log(f"host RSS before the ranks (5b's table unpinned and freed) {rss_gb()} GB")
    # 19a, 19b, 19d, 19e and 19f: one world of four gloo ranks and one of two
    ranks = timed("19 (gloo ranks sharing the card: 19a, 19b, 19d, 19e, 19f)", ranks_phase,
                  dev, args.vocab_scale, min(args.batches, DIST_SERVE),
                  min(args.train_steps, DIST_TRAIN), sharded["counts"], args.train_steps + 4)
    dist_a, dist_b, dist_bb, dist_d, dist_e, dist_f = (
        ranks[k] for k in ("19a", "19b", "19b_budget", "19d", "19e", "19f"))
    gc.collect()
    dist_c = timed("19c (one NCCL rank)", dist_nccl_phase, dev, DIST_SCALE)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"host RSS after phase 19 {rss_gb()} GB")
    budget = timed("5c (budget mode)", budget_phase, dev, args.vocab_scale, args.batches,
                   args.train_steps)
    gc.collect()
    log(f"host RSS after budget (tables unpinned and freed) {rss_gb()} GB")
    snap = timed("5d-5f init snapshot", InitSnapshot, DLRM(_scaled(args.vocab_scale)), dev)
    pipe = timed("5d (pipelined training)", pipeline_phase, dev, args.vocab_scale, PIPE_STEPS,
                 snap)
    gc.collect()
    rf = timed("5f (refresh)", refresh_phase, dev, args.vocab_scale, snap)
    snap.close()
    del snap
    gc.collect()

    log(f"host RSS after pipelined (tables unpinned and freed) {rss_gb()} GB")
    sh_budget = timed("5e (sharded budget mode)", sharded_budget_phase, dev, args.vocab_scale,
                      args.batches, args.train_steps)
    gc.collect()
    log(f"host RSS after sharded budget (tables unpinned and freed) {rss_gb()} GB")
    gd_paths = {"train": gd_launches, "budget": budget["gd_launches"],
                "sharded_budget": sh_budget["gd_launches"]}
    # every write-back of these two paths went into an int8 host: all fused
    gde_paths = {"budget": budget["gd_launches"], "sharded_budget": sh_budget["gd_launches"]}
    rebalance = sh_budget["rebalance"]
    jobs["gather_decode_encode"] = (budget["captured"], max(gd_err, budget["live_err"]),
                                    gde_paths)
    bag_paths = {"train": bag_launches, "budget": budget["bag_launches"]}
    fm_serve = fm_serve_phase(dev, args.vocab_scale, FM_BATCHES)
    gc.collect()
    fm_train = fm_train_phase(dev, args.vocab_scale, FM_TRAIN_STEPS)
    gc.collect()
    with deterministic():  # phase 7 again, then chunked: bitwise the same
        fm_rows = timed("7b (FM rows, deterministic)", fm_train_phase, dev, args.vocab_scale,
                        FM_CHECK_STEPS)
        gc.collect()
        fm_chunk = timed("7b (FM chunked staging)", fm_train_phase, dev, args.vocab_scale,
                         FM_CHECK_STEPS, _fm_chunk(args.vocab_scale))
    gc.collect()
    fm_chunk_t = timed("7b (FM chunked staging, default mode: its times)", fm_train_phase, dev,
                       args.vocab_scale, FM_TRAIN_STEPS, _fm_chunk(args.vocab_scale))
    gc.collect()
    if fm_chunk["losses"] != fm_rows["losses"]:
        raise AssertionError(f"FM chunked losses {fm_chunk['losses']} != row-granular "
                             f"{fm_rows['losses']}")
    log(f"FM chunked staging: losses bitwise the row-granular run's {fm_chunk['losses']} "
        f"(both deterministic); chunked moves {fm_chunk['moves']['chunked']}, row moves "
        f"{fm_chunk['moves']['rows']}, largest staging block "
        f"{fm_chunk['moves']['chunk_block_bytes']} B")
    ce_run = timed("14a (the single-table CachedEmbedding)", cached_embedding_phase, dev,
                   args.vocab_scale)
    gc.collect()
    avazu = timed("14b (the Avazu DLRM)", avazu_phase, dev, args.vocab_scale)
    gc.collect()
    log(f"host RSS after 14a-14b (tables unpinned and freed) {rss_gb()} GB")
    recsys = {}
    for arch, what, n_serve, n_train in (("din", "15a (DIN)", args.batches, args.train_steps),
                                         ("dien", "15b (DIEN)", DIEN_SERVE, DIEN_TRAIN),
                                         ("mind", "15c (MIND)", args.batches, args.train_steps)):
        recsys[arch] = timed(what, recsys_phase, dev, arch, args.vocab_scale, n_serve, n_train,
                             RECSYS_CANDIDATES[arch])
        gc.collect()
        torch.cuda.empty_cache()
    log(f"host RSS after 15a-15c (tables unpinned and freed) {rss_gb()} GB")
    # phase 8's live inputs, timed last in a fresh process (see
    # time_in_fresh_process); the refresh phases add their launches below
    jobs.update({
        "fm": (fm_serve["v"], max(fm_err, fm_serve["live_err"]), fm_serve["fm_launches"]),
        "threshold": ({"DLRM serve": (key, kv), "FM serve": (fm_serve["key"], fm_serve["kv"]),
                       "DLRM depth-3 lookahead": (pipe["key"], pipe["kv"]),
                       "cached_embedding": (ce_run["key"], ce_run["kv"]),
                       "avazu": (avazu["key"], avazu["kv"]),
                       "DIN": (recsys["din"]["key"], recsys["din"]["kv"]),
                       "MIND": (recsys["mind"]["key"], recsys["mind"]["kv"])},
                      max(max_err, err, fm_serve["thr_err"], pipe["thr_err"], ce_run["err"],
                          avazu["err"], *(r["err"] for r in recsys.values())),
                      {"serve": serve_launches, "train": train_thr,
                       "sharded": sharded["thr_launches"],
                       "sharded_pipelined": sh_pipe["thr_launches"],
                       "budget": budget["thr_launches"],
                       **{f"pipelined {k}": v for k, v in pipe["thr_launches"].items()},
                       "sharded_budget": sh_budget["thr_launches"],
                       "fm_serve": fm_serve["thr_launches"],
                       "fm_train": fm_train["thr_launches"],
                       "fm_7b": (fm_rows["thr_launches"] + fm_chunk["thr_launches"]
                                 + fm_chunk_t["thr_launches"]),
                       "cached_embedding": ce_run["launches"],
                       "avazu": avazu["launches"],
                       **{arch: r["launches"] for arch, r in recsys.items()}}),
        # every sharded plan of these paths routes in the bucketize launch: all fused
        "bucketize": (sharded["captured"], max(bz_err, sharded["live_err"], sh_pipe["err"]),
                      {**sharded["launches"], "sharded_pipelined": sh_pipe["bz_launches"],
                       "sharded_budget": sh_budget["bz_launches"]},
                      {**sharded["fused_launches"], "sharded_pipelined": sh_pipe["bz_fused"],
                       "sharded_budget": sh_budget["bz_launches"]}),
    })
    # the ranks' launches (each rank's wrappers counted, summed over the ranks)
    # 19b's budget and bag cases and 19f count under their own keys
    ranks = {"ranks_19a": dist_a, "ranks_19c": dist_c, "ranks_19d": dist_d, "ranks_19e": dist_e,
             "ranks_19b_budget": dist_bb["budget"], "ranks_19b_bag": dist_bb["bag"],
             "ranks_19f": dist_f}
    jobs["threshold"][2].update({k: v["victim_threshold"] for k, v in ranks.items()})
    jobs["bucketize"][2].update({k: v["bucketize"] for k, v in ranks.items()})
    jobs["bucketize"][3].update({k: v["route_bucketize"] for k, v in ranks.items()})
    gd_paths.update({k: ranks[k]["gather_decode"] for k in ("ranks_19a", "ranks_19d", "ranks_19e",
                                                            "ranks_19b_budget", "ranks_19b_bag",
                                                            "ranks_19f")},
                    ranks_19b=dist_b["gather_decode"])
    jobs["gather_decode_encode"][2].update(
        {k: ranks[k]["gather_decode_encode"] for k in ("ranks_19b_budget", "ranks_19b_bag",
                                                       "ranks_19f")},
        ranks_19b=dist_b["gather_decode_encode"])
    bag_paths.update({k: ranks[k]["embedding_bag"] for k in ("ranks_19b_bag", "ranks_19f")})
    del sharded, budget, fm_serve, fm_train, fm_rows, fm_chunk, fm_chunk_t, pipe, sh_budget
    del ce_run, avazu, recsys
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 3-7b, 14a-15c: {time.perf_counter() - t0} s since the build began")

    from repro_torch.configs import gemma3_27b, smollm_360m
    from repro_torch.nn.layers import Dtypes

    fa_errs, simt_live = timed("9 (flash kernels)", flash_kernel_phase, dev)
    smol = timed("10 (SmolLM-360M serve)", lm_serve_phase, dev,
                 dataclasses.replace(smollm_360m.CONFIG, use_pallas=True))
    fp32 = Dtypes(param=torch.float32, compute=torch.float32)
    fp32_lm = timed("11 (SmolLM-360M fp32 routes and decode)", lm_fp32_phase, dev,
                    dataclasses.replace(smollm_360m.CONFIG, dtypes=fp32, use_pallas=True))
    gc.collect()
    torch.cuda.empty_cache()
    gemma = timed("12 (Gemma-3-27B one group)", gemma_phase, dev,
                  dataclasses.replace(gemma3_27b.CONFIG, n_layers=6, use_pallas=True))
    fa = timed("13 (flash timing)", time_flash, smol, gemma, fp32_lm, fa_errs, ptxas,
               simt_live)
    smol_decode = smol["decode"]
    del simt_live
    del smol, gemma, fp32_lm
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.configs import grok_1_314b, olmoe_1b_7b

    t16 = time.perf_counter()
    lm_train = timed("16a (SmolLM-360M training)", lm_train_phase, dev,
                     dataclasses.replace(smollm_360m.CONFIG, use_pallas=True))
    gc.collect()
    torch.cuda.empty_cache()
    fp32_train = timed("16b (SmolLM-360M fp32 training, kernel vs chunked)",
                       lm_fp32_train_phase, dev,
                       dataclasses.replace(smollm_360m.CONFIG, dtypes=fp32,
                                           n_layers=FP32_TRAIN_LAYERS, use_pallas=True))
    gc.collect()
    torch.cuda.empty_cache()
    olmoe = timed("16c (OLMoE-1B-7B)", olmoe_phase, dev,
                  dataclasses.replace(olmoe_1b_7b.CONFIG, use_pallas=True))
    gc.collect()
    torch.cuda.empty_cache()
    grok = timed("16d (Grok-1-314B, one layer)", grok_phase, dev,
                 dataclasses.replace(grok_1_314b.CONFIG, n_layers=1, use_pallas=True))
    gc.collect()
    torch.cuda.empty_cache()
    timed("16e (SmolLM-360M int8 KV-cache decode)", int8_decode_phase, dev,
          dataclasses.replace(smollm_360m.CONFIG, use_pallas=True, kv_cache_int8=True),
          smol_decode)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 16a-16e: {time.perf_counter() - t16} s")

    t17 = time.perf_counter()
    launches = _kernel_launches()
    for what, phase in (("17a (GatedGCN full_graph_sm)", gnn_full_graph_phase),
                        ("17b (GatedGCN minibatch_lg)", gnn_minibatch_phase),
                        ("17c (GatedGCN molecule)", gnn_molecule_phase),
                        ("17d (GatedGCN ogb_products, serve)", gnn_ogb_phase)):
        timed(what, phase, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if _kernel_launches() != launches:
        raise AssertionError(f"phases 17a-17d launched a kernel of the port: counts {launches} "
                             f"-> {_kernel_launches()}; no kernel lies on the GNN path")
    log(f"phases 17a-17d: {time.perf_counter() - t17} s; no kernel of the port launched (every "
        f"wrapper's count unchanged: none lies on the GNN path)")
    bf16_row, fp32_row = fa
    bf16_row["launches_by_path"].update({f"smollm_{k}": n for k, n in lm_train["launches"].items()})
    bf16_row["launches_by_path"].update(olmoe["launches"], grok_prefill=grok["launches"])
    bf16_row["max_abs_err"] = max(bf16_row["max_abs_err"], lm_train["live_err"], olmoe["err"],
                                  grok["err"])
    bf16_row["train_live"] = lm_train["kernel"]
    fp32_row["launches_by_path"]["smollm_fp32_train"] = fp32_train["launches"]
    fp32_row["max_abs_err"] = max(fp32_row["max_abs_err"], fp32_train["live_err"])
    for row in (bf16_row, fp32_row):
        row["launches"] = sum(row["launches_by_path"].values())
    del lm_train, olmoe, grok

    sh_rf = timed("5g (sharded refresh; its re-homing ran on 5e's state)",
                  sharded_refresh_phase, dev, args.vocab_scale)
    gc.collect()
    log(f"host RSS after the refresh phases (tables unpinned and freed) {rss_gb()} GB")
    drift_thr = timed("5h (drift)", drift_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()

    jobs["threshold"][2].update({
        "refresh_serve": rf["serve"], "refresh_train": rf["train"] + rf["train_timed"],
        "refresh_pipelined": rf["pipelined"], "refresh_int8": rf["int8_thr"],
        "refresh_sharded": sh_rf["sharded"]["thr"], "rebalance": rebalance["thr"],
        "drift": drift_thr})
    jobs["bucketize"][2].update({"refresh_sharded": sh_rf["sharded"]["bz"],
                                 "rebalance": rebalance["bz"]})
    jobs["bucketize"][3].update({"refresh_sharded": sh_rf["sharded"]["bz_fused"],
                                 "rebalance": rebalance["bz_fused"]})
    jobs["gather_decode_encode"][2].update({"refresh_int8": rf["int8_gd_fused"],
                                            "rebalance": rebalance["gd_fused"]})
    ex_launches = timed("20 (the port's examples)", examples_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    rows = timed("8 (kernel timing, in a fresh process)", time_in_fresh_process, jobs)
    fmk, thr, bz, rbz, gd, gde, bag = (rows[k] for k in (
        "fm", "threshold", "bucketize", "route_bucketize", "gather_decode",
        "gather_decode_encode", "bag"))
    gd_paths.update({"refresh_int8": rf["int8_gd"], "rebalance": rebalance["gd"]})
    for row, paths in ((gd, gd_paths), (bag, bag_paths)):
        row["launches_by_path"] = paths
        row["launches"] = sum(paths.values())
    fmk["launches_by_path"] = {"fm_serve": fmk["launches"]}
    add_example_launches({"victim_threshold": thr, "gather_decode": gd,
                          "gather_decode_encode": gde, "fm_interaction": fmk,
                          "embedding_bag": bag, "bucketize": bz, "route_bucketize": rbz,
                          "flash_wgmma": bf16_row, "flash_tf32x3": fp32_row}, ex_launches)
    gd["fused_launches"] = gde["launches"]
    log(f"launch floor {json.dumps(rows['launch_floor'])}; the fused entries' launches are "
        f"counted in their kernels' rows too (gather_decode {gd['launches']} of which "
        f"gather_decode_encode {gde['launches']}; bucketize {bz['launches']} of which "
        f"route_bucketize {rbz['launches']})")

    census_s = sum(c["seconds"] for c in CENSUS.values())
    log(f"phase 18 and the census: {gate_s} + {census_s} = {gate_s + census_s} s")
    log(json.dumps({"census": {k: {"syncs": c["syncs"], "by_site": c["by_site"]}
                               for k, c in CENSUS.items()}}))
    log(f"all phases: {time.perf_counter() - t0} s since the build began")
    log(json.dumps({"kernels": [thr, gd, gde, fmk, bag, bz, rbz, *fa]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": 1}}))


if __name__ == "__main__":
    main()
