#!/usr/bin/env python3
"""Drive the PyTorch port's allocation, serve and train paths on one CUDA
card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card: its name, and name and power limit from nvidia-smi;
2. build the CUDA kernels from src/repro_torch/csrc (seconds printed; one
   nvcc per source, all started together);
2s. the port's seeded draws are the same on the card and on the CPU: one
   seed's run_scan at the paper's setting and one run_batch seed with
   gauss_markov / gilbert / mmpp, warm coop on "reference" on both devices
   (held to each other by compare_episodes); XLSTMLM.init and
   CausalLM.init at reduced width bitwise equal on both; serve's prompts
   for one seed equal on both; the seconds of each model's full-width
   init on the card (its weights drawn on the CPU); and the host's ms per
   market-scale period of draws, alone, on one intra-op thread and with
   the copy to the card, and per operator under the CPU profiler;
2a. the mLSTM kernel (B7 mlstm_chunk) against its plain version on the
   card, in bfloat16 and float32, with the JAX kernel test's inputs (k /
   sqrt(Dh), i ~ N(0, 0.5), f ~ N(2, 0.5)) and tolerances (rtol = atol =
   5e-4 float32, 5e-2 bfloat16) on y and the final C, n and m: the serve
   shape (B = 4, H = 4, S = 2048, Dh = 1024) from the zero state, a ragged
   shape (2, 2, 1100, 128), and a carry (the serve shape's first 1000
   positions, then the rest from the state they end in, against the whole
   sequence).  In bfloat16 a call is two kernels, each also held to its
   own plain version (mlstm_parts: the chunk states and final state of
   mlstm_states_kernel, the y of mlstm_outputs_kernel) and timed alone.
   Times as in phase 4, no library call (library_ms null), and the bound:
   4 Dh (Dh + 64) operations per (position, head) over the peak for the
   type (64: the first B7 kernel's chunk, kept whatever chunk the kernels
   use, so bounds stay comparable), against
   the inputs, y and the state;
2b. the xLSTM serve path (slice 4's main path), through
   repro_torch.launch.serve.main: full-width xlstm-1.3b in bfloat16 cut to
   XLSTM_SERVE's 16 of 48 layers (serve's config replaced in depth, no
   command-line flag), from a seeded init, batch 4, prompt 2048, 32 greedy
   tokens, after a warm-up serve of a 256-token prompt at 8 layers.
   Counted from 0 just before it: exactly 14
   mlstm_chunk launches (one per mLSTM layer; decode steps run the plain
   recurrent step, as the JAX model does) and no other kernel; finite
   logits and a cache length of 2079; peak memory, one profiled decode
   step, and one mLSTM and one sLSTM block timed over the prompt.  Then
   one no-cache forward of the same prompts, itself a main path: again
   exactly 14 launches, and its last logits within 5e-2 of the prefill's;
2c. the xLSTM kernel path against the plain path end to end: full-width
   xlstm-1.3b in float32 cut to 8 layers (one super-block, 7 mLSTM + 1
   sLSTM), batch 2, prompt 1024, 8 greedy tokens in lockstep, as phase 6;
3. every kernel against its plain PyTorch version on the card, at the
   market shape (N = 8192 services, K = 32 clients, first 10% inactive,
   sample_services on a generator seeded 5, warm seed = cold price x 1.03),
   a ragged shape (N = 8191, K = 45) and the paper's ten services (N = 10,
   K = 45: where B1's and B2's launches come from, so their kernels-line
   times); B1 and B2 bitwise the same over 21 more calls and at every
   speculation depth; mbdf_demand on the prices of
   uniform_truthful_bids (M = 5 at the market shape, M = 3 at the ragged
   one) for alpha_fair 0, 0.5 and 1, its demands >= 0, non-increasing
   along the price grid and 0 on inactive rows.  Per kernel: the largest
   deviation per output (tolerances below), the kernel's device time
   (CUDA events around one call queued behind a device sleep, so the
   host's launch path is hidden; median of 21) with the profiler's mean
   as a cross-check (kernel_profiler_ms: an untimed call inside the
   window and FILLERS tiny kernels at both ends, records from
   prof.events(), after a 20 ms host pause that lets tracing start; the
   fillers each end lost are tallied over every window in the
   profiler_windows line, and a window that loses half of them at either
   end fails the phase), the wrapper's and the plain
   version's time per call
   (CUDA events, median of 21 calls, host launch path included), and the
   bound (the larger of float32 operations over 67 TFLOP/s and bytes
   over 3.35 TB/s, counting about 5 operations per valid (row, client,
   trip), 6 for mbdf_demand's per price); market_clear's outputs bitwise
   the same over 21 more calls (lam above all: every block folds the
   same partials in the same order).  Then B1-B4 in parts, through
   their own launch arguments (b12_parts: B1 and B2 with 0 and their full
   trips at 10 x 45, 8192 x 45 and both market shapes, on the market and
   its full copy, the wrapper's time beside the kernel's, and each
   speculation depth over N from 10 to 8192 at K = 45 with the depth the
   launch picks; b3_parts: no trips, 6 trips without
   bisection, plus the 6 x 24 Newton steps, the full call, at both
   shapes and on a copy of each market with every row active and full,
   giving the cost of a trip, of a bisection step and of the zero lanes;
   b4_parts: M = 5 at alpha_fair 0.5 and 0, with 48 and with 0 trips,
   on the market and its full copy), each with the count of divide
   checks and slow-path calls in the kernels' SASS (cuobjdump); and the
   edge matrix (edge_matrix: tests/test_tile_edges.py's shapes mirrored,
   N in {1, 31, 8191} x K in {1, 7, 31, 32, 33, 45, 64, 65, 128, 1024},
   an all-inactive market and one with a single active row, B1 with a
   b = 0 row, B2 on a price per row, B4 at M in
   {1, 5, 8, 9}), each kernel against its plain version within the
   tolerances above, B1 and B2 alike at every depth, B4's demands >= 0,
   non-increasing and 0 on
   inactive rows; before it, the lane group the kernels pick for every
   K up to 1024 (L in 8, 16, 32 and K <= L R <= 32 L);
4. the attention kernels (B5 flash_attention, B6 decode_attention)
   against their plain versions on the card, in bfloat16 and float32:
   B5 at gemma3-1b's prefill shape (B = 4, Hq = 4, Hkv = 1, S = 2048,
   D = 256) with the local window of 1024 and global, and at a ragged
   shape (B = 2, Hq = 8, Hkv = 2, S = 1100, D = 128); B6 at the decode
   shape (cache 2080, valid_len 2079) global, on the local window's slice
   of the cache (the last 1024 positions) and at a ragged valid_len
   (1337); and B5 in bfloat16 once more at the local shape on transposed
   views of (B, S, H, D) tensors, the layout the model hands in.  The
   zoo's cases (ZOO_FLASH_CASES, ZOO_DECODE_CASES): B5 without the causal
   mask at the enc-dec's cross shape (B = 4, Hq = Hkv = 16, Sq 2048, Skv
   1500, D = 64) and at Sq = Skv (its encoder), B5 bfloat16 at G = 5
   (hymba's D = 64 with its window of 1024, llama4's D = 128) and G = 7
   (qwen2-vl), B6 at llama4's decode shape (40/8, D = 128), hymba's
   (25/5, D = 64, its window's slice) and qwen2-vl's (28/4), and the soft
   cap c = 50 at gemma3-1b's local B5 and global B6 shapes (their
   library call: torch.compile of flex_attention with the soft cap as its
   score_mod, the window as its block mask; held to the plain version
   within the case's tolerance).
   Tolerances are the JAX kernel tests' (rtol = atol = 2e-5 in float32,
   2e-2 in bfloat16).  B5's L (each row's log-sum-exp, which the forward
   writes for the backward) against the plain version's: float32 within
   1e-5 of the largest |L|, bf16 inputs within 1e-3 absolute (LSE_TOL).
   Per case: kernel, profiler (the kernel's own name:
   flash_attention_wgmma_kernel for bf16 B5, flash_attention_kernel for
   float32, decode_attention_kernel, one launch a call), wrapper and plain
   times as in phase 3, the time of one
   F.scaled_dot_product_attention(enable_gqa=True) call on the same inputs
   (library_ms; the port never calls it), the bound: the larger of the
   operations (4 D per live (query, key) pair, counted from the mask) over
   989 TFLOP/s for bfloat16 or 67 TFLOP/s for float32, and the bytes of
   q, the live k and v, and the output over 3.35 TB/s; and the achieved
   rate of what bounds it (TFLOP/s or GB/s) with bound_ms / ms;
5. the serve path (slice 3's main path), through
   repro_torch.launch.serve.main: full-width gemma3-1b in bfloat16 from a
   seeded init, batch 4, prompt 2048, 32 greedy tokens, after one short
   warm-up serve.  Counted from 0 just before it: exactly 26
   flash_attention and 26 x 31 = 806 decode_attention launches and no
   other kernel (no mlstm_chunk); finite logits and a cache filled to 2079; then one more
   decode step under the profiler (its device activities and busy time)
   and one more prefill under it (device busy time and B5's share);
6. the kernel path against the plain path end to end: full-width
   gemma3-1b in float32 cut to 2 layers (one local, one global), one
   parameter set on the card and on the CPU, batch 2, prompt 2048, 8
   greedy tokens stepped in lockstep: last-position logits within
   MODEL_TOL at every step and the same tokens (a flip at a near-tie is
   reported with the CPU's top-2 gap and fails unless that gap is within
   2 atol);
6z. the zoo path (slice 12): gemma-2b, gemma-7b, command-r-35b (every
   layer, or the most that fit: the cut is printed), qwen2-vl-7b (256
   vision-patch embeddings, (3, B, S) M-RoPE positions, through
   serve.generate with its decode steps' positions),
   seamless-m4t-large-v2 (through serve.main), hymba-1.5b
   at full depth, llama4-maverick cut to one (dense, MoE) pair and
   deepseek-v2 to its dense lead and 2 MoE layers (every width kept),
   each in bfloat16 from a card-generator init in the compute dtype,
   batch 4, prompt 2048, 16 greedy tokens after a warm-up serve of 512;
   each serve its own counted path: exactly one B5 launch per layer and
   one B6 per layer a step (the enc-dec: encoder + 2 x decoder B5, 2 x
   decoder B6 a step; MLA layers none) and no other kernel, finite
   logits, the cache filled to 2063, init, prefill and decode times, the
   step's bytes over 3.35 TB/s, peak memory.  Then float32 parity as
   phase 6 (ZOO_PARITY_CASES: full width cut to 2 layers, batch 2,
   prompt 1024, 8 tokens in lockstep, weights drawn on the card): llama4
   (one pair, 16 routed experts), deepseek (lead + 1 MoE, 32 routed
   experts), hymba, seamless (a source of 1500 frames against the
   1024-token prompt), qwen2-vl with vision and M-RoPE, command-r's
   parallel block (one layer), gemma3-1b with the int8 cache (its CPU side adopting
   the card's quanta behind a guard; its readings per call, and two
   planted faults on the card -- B6 reading one key fewer in every layer
   and in the last one only, k and v with relative noise of 1e-3 -- each
   of which must fail it) and with the soft cap 50;
6b. B5's backward (csrc/flash_attention_bwd.cu: slice 14's bf16 kernels on
   wgmma, Delta, dk and dv (their float32 parts summed where the key tiles
   are split), dq; float32 slice 13's FMA pair, dq then dk and dv, both
   reading L from the forward) against flash_attention_bwd_plain on the
   card, on the forward kernel's own output and L (L first held to the
   plain one, as phase 4) and a random dO: the train shape (B = 2
   clients folded, Hq = 4, Hkv = 1, S = 2048, D = 256, window 1024 and
   global) and phase 4's B5 cases (FLASH_CASES and ZOO_FLASH_CASES), in
   bfloat16, and in float32 where BWD_FLOAT32 names the case; the
   largest |dq|, |dk|, |dv| deviation within BWD_TOL of the largest |grad|
   (2e-2 bfloat16, 1e-4 float32), the same bits over BWD_REPEATS more
   calls, kernel ms (as phase 4), profiler ms of each kernel (BWD_KERNELS),
   wrapper and plain ms, the library time (torch.autograd.grad through
   one F.scaled_dot_product_attention call, for the soft cap through one
   flex_softcap call, whose gradients are held to the plain version's
   within BWD_TOL; the port never calls either) and the bound: 10 D
   operations per live (query, key) pair over the peak of the type,
   against q, k, v, o, dO, dq, dk and dv over 3.35 TB/s;
6m. B7's backward (csrc/mlstm_chunk_bwd.cu: the scores, reverse states,
   per-chunk gradient and gates kernels on the FMA units) against
   mlstm_chunk_bwd_plain on the card, on the forward kernels' own saved
   tensors (the state at every chunk of 256's start and ell, sgn per
   position, first held to chunk_states_plain and chunk_stats_plain) and
   a random dy, with phase 2a's input recipe on the even heads (k /
   sqrt(Dh): the floor exp(-m_t) wins) and k as drawn on the odd ones
   (|N_t| wins at most positions), the floor's share of the positions
   strictly inside MLSTM_FLOOR_SHARE: the train shape (B = 2
   clients folded, H = 4, S = 2048, Dh = 1024), the serve shape (4 x 4 x
   2048 x 1024) and a ragged one (2 x 2 x 1100 x 128), in bfloat16, and in
   float32 where MLSTM_BWD_FLOAT32 names the case; in each group of
   heads, the largest |dq|, |dk|, |dv|, |di|, |df| deviation within
   BWD_TOL of the group's largest |grad|, the
   same bits over BWD_REPEATS more calls, each of the four kernels held
   to its own plain version on the same inputs (mlstm_bwd_parts), kernel
   ms, profiler ms of each kernel (MLSTM_BWD_KERNELS), wrapper and plain
   ms, no library call, and the bound: 8 Dh^2 operations a (position,
   head) plus 10 Dh a live (query, key) pair of a chunk, over the peak of
   the type, against q, k, v, y, dy, dq, dk, dv, the gates and their
   gradients, the chunk states and the statistics over 3.35 TB/s;
6t. the train path (slice 13), through repro_torch.launch.train.main:
   full-width gemma3-1b (26 layers, d 1152, vocab 262144), float32
   params, bf16 compute, 2 clients, batch 1, 2048 tokens (above the local
   layers' window of 1024), 1 local step, 2 periods of at most 2 rounds,
   coop on "pallas", with a period of TRAIN["period_s"] (the paper's 20 s
   fits no round of a 1 B-parameter service: t* = 1514 s).  Counted from
   0 just before it: exactly n_layers x local steps x rounds launches of
   flash_attention and of flash_attention_bwd (the clients folded into
   one launch), TRAIN_B1_PER_PERIOD bisect_alloc a period and no other
   kernel; finite losses; peak GB and ms a round, and B5's backward ms a
   round: 6b's profiler ms at the train shapes (train_local,
   train_global) times the run's local and global layers a round.  (A
   profile of the whole round: tests/torch_train_profile.py.)  Then, each
   its own counted path: the xLSTM train path (slice 15), full-width
   xlstm-1.3b (d_model 2048, 4 heads of Dh 1024, vocab 50304) cut to
   XLSTM_TRAIN's 8 of 48 layers (one super-block of 7 mLSTM + 1 sLSTM;
   launch.train's config replaced in depth, no command-line flag), 2 clients x
   batch 1 x 2048 tokens, 1 local step, 2 periods of at most 1 round, coop
   on "pallas": exactly 7 x local steps x rounds launches of mlstm_chunk
   and of mlstm_chunk_bwd, TRAIN_B1_PER_PERIOD bisect_alloc a period and
   no other kernel, finite losses, peak GB, ms a round, B7's backward ms a
   round (6m's profiler ms at the train shape x 7; the sLSTM's and B7's
   shares of a profiled round: tests/torch_train_profile.py --arch
   xlstm-1.3b); one round of the
   reduced gemma3-1b and of the reduced xlstm-1.3b in float32 on the card
   and on the CPU from one parameter set and batch (loss and each leaf's
   change within MODEL_TOL of the CPU's largest change of the leaf); the
   train entry point's default CLI (TRAIN_CLI: gemma-2b and xlstm-1.3b
   reduced, on the card), one B5 and B5 backward a layer, one B7 and B7
   backward a mLSTM layer, a local step a round, and no other kernel; and
   smoke-size
   co-trained episodes (run_cotrain_scan, task "zoo", gemma3-1b and
   xlstm-1.3b) on "pallas", whose durations equal those on "reference"
   and of plain run_scan; and, outside the paths, B6 refuses CUDA inputs
   that require grad (decode is never differentiated), launching
   nothing;
7. the allocation paths, each driven with the launch counts set to 0 just
   before it and read just after:
   a. slice 1: run_scan episodes of coop (warm and cold), es, pp and ec
      at the paper's setting (SimConfig defaults; the cold coop pair cut
      to SLICE1_CUTS' 120 periods and compared up to there), each with a
      kernel backend and with "reference" on one sampler stream, then a
      market-scale warm coop episode on "megakernel": 8192 services all
      arriving at period 0 with the paper's 1 MHz per service (B = 8192
      MHz) and 100 rounds to finish, 10 periods;
   b. selfish: the auction policy on "pallas" and "megakernel" at the
      paper's setting, then the same market-scale episode on "pallas";
   c. run_batch over 3 seeds with gauss_markov channels, gilbert churn
      and mmpp arrivals, warm coop on "megakernel" against "reference";
   d. cotrain (slice 9): co-trained episodes (fl.cotrain, FedAvg of
      bigram tables paced by each period's allocation) at BENCH_cotrain's
      setting (benchmarks/paper_figs_cotrain.py:81-87: 5 services, K =
      32, B = 2 MHz, T = 4 s, 48 rounds, 64 periods; vocab 32, seq 8,
      batch 4, eval batch 32, rounds_cap 14, lr 0.5): warm coop on
      "megakernel" and "pallas", es, pp and selfish on "pallas", and at
      the paper's setting warm coop on "megakernel" and selfish on
      "pallas", each against the same episode on "reference" on the card
      (durations by compare_episodes; where the two trained the same
      rounds with the same participants, loss and train_loss within
      rtol 1e-4 / atol 1e-5, acc within one eval token, the final tables
      within 1e-4) and against the plain run_scan of its config in the
      same call (durations bitwise; periods/s, the ratio the cost of
      training a period); per episode the host ms of a round's data
      draws and the launches a period by kernel.  Then (cotrain_engines)
      one seed's warm coop co-trained episode on the card against the
      CPU, run_cotrain_batch over seeds 0-2 against run_cotrain_fleet at
      chunk 2 and run_fleet over seeds 0-4 at chunk 2 against run_batch
      (bitwise), the legacy run against run_scan (durations) and resumed
      from its period-2 JSON snapshot against itself uninterrupted;
   e. allocd (slice 10): the live daemon (launch.allocd over
      fl.control_plane, solves in an executor thread).  At the paper's
      network (16 slots, K = 45, 400 rounds, 40 ticks of Poisson(0.5)
      admissions): warm coop on "megakernel" and "pallas", selfish and es
      on "pallas", each against the same daemon on "reference" on the card
      (compare_episodes on the served streams, completions equal) and
      replayed through run_scan on the card bitwise (the ticks before the
      first slot reuse: 19 admissions into 16 slots), warm coop
      "megakernel" on the CPU too; at market capacity (MARKET_N services
      admitted at tick 0, market_setting's network, 100 rounds, 10 ticks)
      warm coop "megakernel" and selfish "pallas", replayed bitwise; each
      with ticks/s, run_scan's periods/s on the same trace and the ms a
      tick draws inline.  Then the poison drill (full planes poisoned at
      NaN, +Inf and -Inf in the channel state and the warm seed, each
      poisoned tick run on "reference" on the same inputs: the same
      rescues and b, f within tolerance), the zero-load drill (clients
      with alpha = 0, a whole row and each row's slowest, on "pallas" and
      "megakernel" against "reference"), bench_fault's storms
      (benchmarks/bench_fault.py:44-46: 16, 64, 256 slots, 40 periods,
      on "megakernel" and "pallas", each twice with equal digests, every
      invariant ok, every poisoned tick probed as above, the trajectory
      against the "reference" storm's), bench_robust's Byzantine
      co-training (benchmarks/bench_robust.py:68-85: sign_flip and nan
      at 20% against fedavg, trimmed_mean, median and krum; durations
      those of the clean episode, training bitwise alike on "megakernel"
      and "reference", card against CPU loss within 1e-5, finite tables
      from the robust aggregators under nan) and the CLI's --check;
      then, outside the counted paths, C8's one_client_poison drill (the
      Table-1 set with alpha[1, 0] = NaN: on every demand backend the
      rescue is flagged and equals, bit for bit, the cold bisection of
      the set with that client dropped);
   f. sharded (slice 11): disba_sharded over torch.distributed.  World 1
      on nccl: at the market shape of phase 3 (8192 x 32, B = 10 MHz),
      "newton" on "pallas" and on "reference" from 1.05 x the dense cold
      price and "bisect", each against the dense solve of its method on
      the card (b and f within rtol 1e-3 / atol as above, lam rtol 1e-3;
      whether bitwise is printed; B2 launched once a Newton trip); then
      run_fleet (the paper's setting cut to 40 periods) and
      run_cotrain_fleet (cut to 8) of warm coop on "megakernel" and
      selfish on "pallas", seeds 0-5 at chunk 2, bitwise per seed against
      run_batch / run_cotrain_batch on the card, the "fleet" record the
      reference's geometry.  Then 4 gloo ranks on the same card, spawned
      from the phase (they load the built kernels): the same solves on
      2048 rows a rank and the same fleets, held to the same dense solves
      and batches.  In the same ranks, slice 16 (sharded_moe) on a (data
      2, model 2) mesh: (a) deepseek-v2's MoE layer at full width in bf16
      (router 5120 x 160, routed 160 x 5120 x 1536 x 3, 2 shared experts),
      drawn by every rank from one seed on the card, resharded
      (distributed.elastic.reshard, fsdp off: 80 experts a rank) and
      freed, each local block bitwise its slice; (b) the expert-parallel
      forward (models.moe._apply_moe_ep through apply_moe) on it over 4 x
      2048 bf16 tokens split over data, each data shard's output within
      max |dev| / max |out| <= 2e-2 of the generic apply_moe at world 1
      on that shard's 4096 tokens (the parent computes it, the card
      alone); (c) tests/test_distributed.py's EP setting in float32 (E =
      8, k = 2, capacity 8.0) on the whole values and on reshard's
      DTensors with FSDP on, against the dense oracle (rtol 2e-4, atol
      2e-5), gradients against the generic path's at world 1 within 1e-4
      of the largest |grad|; (d) ms of an EP layer (median of 5, CUDA
      events; gloo stages the card's tensors through the host), of the
      generic layer at world 1 over all 8192 tokens, of the (4096, 5120)
      all-reduce over model alone, and each rank's peak GB.  Outside the
      counted paths (sharded_times): ms a solve
      by method and world, ms a trip of the collective alone, B2's kernel
      ms at each world's shard shape, B2 launches a solve per rank;
   per episode: rounds and durations equal (see compare_episodes for the
   one allowed exception), per-period b and f within tolerance (an
   auction's f beyond it must be the reference's f*(b) at its own b, see
   check_surplus_split), no solver rescue, the kernels each backend
   launched (none for "reference"), and at market scale draw_wait_ms:
   the median ms the period loop waited on a period's draws, periods 1-9
   (the engine's own sampler draws the next periods on host threads
   there); then, outside the counted paths, draw_samplers: the market
   coop episode and the paper's under three samplers in turns
   (prefetching, inline, and drawn before the episode and already on the
   card), their periods/s and equal durations;
8. the auction entry on the card: run_auction at 8192 services, M = 5,
   B = 8192 MHz (b sums to B, charges cover the fairness cost, the same
   call on the CPU agrees), and charges(method="prefix") against "rerun"
   at N = 256 (the rerun builds an (N, N*M) book);
9. the kernels line: per kernel, its launches on the paths of phases 2b,
   5, 6z, 6t and 7 (summed; 7d, 7e and 7f must each launch each of B1-B4), its
   deviation, times and bound (B1 and B2 at 10 x
   45, B3 and B4 at the market shape, B5's and B7's backwards at the train
   shape); B7's and B5's and B7's backwards' rows list their kernels under
   "parts" (a launch count is a call of them all).

Tolerances are rtol and atol as in the CPU tests, but atol is never more
than 1e-3 of the mean |value| of the output checked: at the market shape b
is about 1e-3 and a client's split about 5e-5, where a fixed atol would
check nothing.  Charges get atol 1e-4 + 1e-6 of the book's welfare
sum_j F_j(b_j): the prefix charge is a difference of two such sums.  An
auction allocation gives each period's surplus to the services bidding at
the clearing price, which absorb every other service's float deviation:
see check_surplus_split.

The last line is {"ok": true, "device": {...}}; every JSON line is also
written to build/chip_smoke.jsonl.  The script needs a CUDA card and the
repository's src/ beside it, and fails without either.
TF32 is off for every float32 product (set in main and again in phase 6).
Slice 4's phases (2a-2c) run right after the build and slice 3's (4-6)
and slice 12's (6z) before the allocation paths, so a fault in any shows
within the first minutes; a "seconds" line before the kernels line gives each phase's wall
time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
B_TOTAL = 10.0
PEAK_F32_OPS = 67e12      # H100 SXM float32 outside the tensor cores, op/s
PEAK_BF16_OPS = 989e12    # H100 SXM bf16 tensor cores, dense, op/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
OPS_PER_CLIENT_TRIP = 5
OPS_PER_CLIENT_TRIP_PRICE = 6   # mbdf_demand
TOL = {"t_star": (1e-4, 0.0), "split": (1e-3, 1e-4), "b": (1e-3, 1e-4),
       "slope": (1e-3, 1e-4), "f": (1e-3, 1e-5), "lam": (1e-4, 0.0),
       "split_sum": (1e-5, 0.0), "demand": (1e-4, 1e-5),
       "price": (1e-4, 0.0)}
ATOL_OF_MEAN = 1e-3      # atol <= this fraction of the output's mean |value|
SLEEP_CYCLES = 2_000_000  # device sleep queued ahead of a timed kernel call
KERNELS = {
    "bisect_alloc": "src/repro/kernels/bisect_alloc.py:29",
    "dual_demand": "src/repro/kernels/dual_demand.py:94",
    "market_clear": "src/repro/kernels/market_clear.py:86",
    "mbdf_demand": "src/repro/kernels/market_clear.py:204",
    "flash_attention": "src/repro/kernels/flash_attention.py:33",
    # B5's backward: the Pallas kernel has none (the JAX model differentiates
    # its plain chunked attention); the port's forward runs B5, so this pair
    # is its gradient
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:33",
    "decode_attention": "src/repro/kernels/decode_attention.py:28",
    "mlstm_chunk": "src/repro/kernels/mlstm_chunk.py:27",
    # B7's backward: as B5's, the Pallas kernel has none (the JAX model
    # differentiates its plain chunkwise form); these kernels are the
    # gradient of the port's B7
    "mlstm_chunk_bwd": "src/repro/kernels/mlstm_chunk.py:27",
}
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # rtol = atol
MLSTM_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}      # rtol = atol
LOG = ROOT / "build" / "chip_smoke.jsonl"   # every emitted line
MODEL_TOL = 1e-4          # rtol = atol of the float32 end-to-end parity
# Sizes (the phases above).
# (N, K, M of mbdf_demand): the market shape, a ragged one, and the paper's
# ten services, where B1's and B2's launches come from (the kernels line).
KERNEL_SHAPES = ((8192, 32, 5), (8191, 45, 3), (10, 45, 5))
MAIN_PATH_SHAPE = (10, 45)   # B1 and B2 in the kernels line
DEPTHS = (1, 2)              # B1 and B2's speculation depths, the same bits
MARKET_N = 8192
PAPER = {}                   # SimConfig overrides of the paper's setting
AUCTION_N, RERUN_N = 8192, 256
BATCH_SEEDS = (0, 1, 2)
# (B, Hq, Hkv, S, D, window) of B5; (B, Hq, Hkv, cache, D, valid_len, lo) of
# B6, whose kernel sees the cache's positions [lo, valid_len).
FLASH_CASES = {"local": (4, 4, 1, 2048, 256, 1024),
               "global": (4, 4, 1, 2048, 256, 0),
               "ragged": (2, 8, 2, 1100, 128, 0)}
DECODE_CASES = {"global": (4, 4, 1, 2080, 256, 2079, 0),
                "local": (4, 4, 1, 2080, 256, 2079, 1055),
                "ragged": (4, 4, 1, 2080, 256, 1337, 0)}
# B5 on transposed views of (B, S, H, D) tensors, the layout the model
# hands in (bf16 only; the float32 parity phase covers it end to end).
SERVE_LAYOUT_CASES = {"local_serve_layout": (4, 4, 1, 2048, 256, 1024)}
# Slice 12's cases, at the zoo path's shapes.  B5: (B, Hq, Hkv, Sq, Skv, D,
# window, causal, softcap), the G = 5 and 7 ones in bf16 only; B6: (B, Hq,
# Hkv, cache, D, valid_len, lo, softcap).
ZOO_FLASH_CASES = {
    "encdec_cross": (4, 16, 16, 2048, 1500, 64, 0, False, 0.0),
    "encoder_self": (4, 16, 16, 2048, 2048, 64, 0, False, 0.0),
    "hymba_g5_local": (4, 25, 5, 2048, 2048, 64, 1024, True, 0.0),
    "llama4_g5": (4, 40, 8, 2048, 2048, 128, 0, True, 0.0),
    "qwen2vl_g7": (4, 28, 4, 2048, 2048, 128, 0, True, 0.0),
    "local_softcap50": (4, 4, 1, 2048, 2048, 256, 1024, True, 50.0)}
BF16_ONLY = ("hymba_g5_local", "llama4_g5", "qwen2vl_g7")
ZOO_DECODE_CASES = {
    "llama4_g5": (4, 40, 8, 2080, 128, 2079, 0, 0.0),
    "hymba_g5_local": (4, 25, 5, 2080, 64, 2079, 1055, 0.0),
    "qwen2vl_g7": (4, 28, 4, 2080, 128, 2079, 0, 0.0),
    "global_softcap50": (4, 4, 1, 2080, 256, 2079, 0, 50.0)}
MAIN_CASE = "local"       # the kernels line: 22 of gemma3-1b's 26 layers
SERVE = dict(arch="gemma3-1b", batch=4, prompt_len=2048, gen=32)
PARITY = dict(n_layers=2, batch=2, prompt_len=2048, gen=8)
# (B, H, S, Dh, split) of B7: the carry case runs [0, split) and then
# [split, S) from the state the first half ends in.
MLSTM_CASES = {"serve": (4, 4, 2048, 1024, 0),
               "ragged": (2, 2, 1100, 128, 0),
               "carry": (4, 4, 2048, 1024, 1000)}
# xlstm-1.3b served cut to 16 of its 48 layers (two super-blocks of 7
# mLSTM + 1 sLSTM), its warm-up to 8, for the run's time limit
XLSTM_SERVE = dict(arch="xlstm-1.3b", n_layers=16, batch=4, prompt_len=2048,
                   gen=32, warmup_prompt_len=256, warmup_layers=8)
# B7's bf16 kernels; the bound keeps the first B7 kernel's count of
# 4 Dh (Dh + 64) operations per (position, head), whatever chunk the
# kernels use.
MLSTM_KERNELS = ("mlstm_states_kernel", "mlstm_outputs_kernel")
BOUND_CHUNK = 64
XLSTM_PARITY = dict(n_layers=8, batch=2, prompt_len=1024, gen=8)
# The zoo path (slice 12): each arch served at full width in bf16, cut in
# depth only where named (layers run), after a warm-up serve of a short
# prompt; then float32 parity at full width cut to 2 layers.
ZOO_SERVE = dict(batch=4, prompt_len=2048, gen=16, warmup_prompt_len=512)
ZOO_ARCHS = {"gemma-2b": None, "gemma-7b": None, "command-r-35b": None,
             "qwen2-vl-7b": None, "seamless-m4t-large-v2": None,
             "hymba-1.5b": None,
             "llama4-maverick-400b-a17b": 2,   # one (dense, MoE) pair
             "deepseek-v2-236b": 3}            # the dense lead + 2 MoE
ZOO_FIT_MARGIN_GB = 8.0   # left free beside weights and cache (activations)
# The int8 parity's guard (adopting_card_quantization): card and CPU x /
# scale that round apart must lie within QUANT_TIE quanta of each other,
# and the scales within QUANT_SCALE_RTOL relative.
QUANT_TIE = 0.02
QUANT_SCALE_RTOL = 1e-4
ZOO_PARITY = dict(n_layers=2, batch=2, prompt_len=1024, gen=8)
# The enc-dec's source in the parity: frames of a length of their own, so
# its cross-attention runs B5 over Skv != Sq and B6 up to valid_len 1500.
ZOO_PARITY_SRC_LEN = 1500
# (arch, label, config overrides) of the parity runs; routed experts cut
# to fit two float32 copies (card and CPU) and the CPU's time, command-r
# to one layer (its CPU side takes ~22 s at two)
ZOO_PARITY_CASES = (
    ("llama4-maverick-400b-a17b", "llama4", dict(n_experts=16)),
    ("deepseek-v2-236b", "deepseek", dict(n_experts=32)),
    ("hymba-1.5b", "hymba", dict(global_every=2)),
    ("seamless-m4t-large-v2", "seamless", dict(n_encoder_layers=2)),
    ("qwen2-vl-7b", "qwen2-vl", {}),
    ("command-r-35b", "command-r", dict(n_layers=1)),
    ("gemma3-1b", "gemma3-int8", dict(global_every=2, kv_cache_dtype="int8")),
    ("gemma3-1b", "gemma3-softcap50", dict(global_every=2,
                                           logit_softcap=50.0)))
SEEDED_SEED = 0           # the seed the card and the CPU both run
# Slice 13: B5's backward, (B, Hq, Hkv, Sq, Skv, D, window, causal,
# softcap): the train shape (two clients folded into B) and phase 4's B5
# cases; float32 only where BWD_FLOAT32 names the case.
BWD_CASES = {"train_local": (2, 4, 1, 2048, 2048, 256, 1024, True, 0.0),
             "train_global": (2, 4, 1, 2048, 2048, 256, 0, True, 0.0),
             **{case: (b, hq, hkv, s, s, d, w, True, 0.0) for case, (
                 b, hq, hkv, s, d, w) in FLASH_CASES.items()},
             **ZOO_FLASH_CASES}
BWD_FLOAT32 = ("train_local", "train_global", "ragged", "encdec_cross",
               "local_softcap50")
BWD_MAIN_CASE = "train_local"   # the kernels line: the train path's shape
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of the largest |grad|
BWD_REPS = 7
# B7's forward's ell = m_t + log(den_t) against the plain one, absolute
# (a log: a relative error of den; ~0 wherever the floor exp(-m_t) wins)
ELL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
BWD_REPEATS = 3
# The backward's kernels by dtype (slice 14: bf16 on wgmma; the sum of the
# dk/dv parts only where flash_attention.dkdv_splits > 1).
BWD_KERNELS = {torch.bfloat16: ("flash_attention_bwd_delta_kernel",
                                "flash_attention_bwd_dkdv_wgmma_kernel",
                                "flash_attention_bwd_dkdv_sum_kernel",
                                "flash_attention_bwd_dq_wgmma_kernel"),
               torch.float32: ("flash_attention_bwd_dq_kernel",
                               "flash_attention_bwd_dkdv_kernel")}
# The forward's L against the plain one: float32 of the largest |L|,
# bf16 inputs absolute (L is float32 from the same bf16 logits).
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
OPS_PER_PAIR_BWD = 10     # per head dim: S, dP, dq, dk, dv (2 each)
# The train path: full-width gemma3-1b through launch.train.main.
TRAIN = dict(arch="gemma3-1b", clients=2, batch=1, seq=2048, local_steps=1,
             periods=2, max_rounds=2, period_s=3600.0, policy="coop",
             intra_backend="pallas")
# coop on "pallas": the dual solve's final f*(b), then the client split
TRAIN_B1_PER_PERIOD = 2
TRAIN_PARITY = dict(clients=2, local_steps=2, batch=2, seq=64, lr=0.5)
TRAIN_COTRAIN_SIM = dict(policy="coop", warm_start=True, n_services_total=2,
                         rounds_required=4, p_arrive=2.0, max_periods=16,
                         k_max=5, mean_clients=3.0, var_clients=1.0)
TRAIN_COTRAIN_NET = dict(mean_clients=3.0, var_clients=1.0)
TRAIN_COTRAIN_SPEC = dict(task="zoo", arch="gemma3-1b", seq_len=8,
                          batch_size=2, eval_batch=2, rounds_cap=2,
                          client_lr=0.1)
# Slice 15: B7's backward, (B, H, S, Dh): the train shape (two clients
# folded into B), the serve shape and the ragged one; float32 where
# MLSTM_BWD_FLOAT32 names the case.
MLSTM_BWD_CASES = {"train": (2, 4, 2048, 1024), "serve": (4, 4, 2048, 1024),
                   "ragged": (2, 2, 1100, 128)}
MLSTM_BWD_FLOAT32 = ("train", "ragged")
MLSTM_BWD_MAIN_CASE = "train"    # the kernels line: the train path's shape
# 6m's heads with k / sqrt(Dh) (the floor wins) and with k as drawn (|N|
# wins at most positions), checked apart; the share of positions where
# the floor wins must lie strictly inside MLSTM_FLOOR_SHARE in every case
MLSTM_FLOOR_HEADS = slice(0, None, 2)
MLSTM_HEAD_GROUPS = {"floor_heads": MLSTM_FLOOR_HEADS,
                     "norm_heads": slice(1, None, 2)}
MLSTM_FLOOR_SHARE = (0.05, 0.95)
MLSTM_BWD_KERNELS = ("mlstm_bwd_scores_kernel", "mlstm_bwd_states_kernel",
                     "mlstm_bwd_grads_kernel", "mlstm_bwd_gates_kernel")
# The bound's work: 8 Dh^2 a (position, head) (C dY, dC v, dC^T k and the
# state's q~ dY^T) and 10 Dh a live (query, key) pair of a chunk (S,
# dy v^T, dS k, dS^T q~, W^T dY), at the kernels' chunk of 256.
OPS_PER_POS_MLSTM_BWD = 8        # x Dh^2
OPS_PER_PAIR_MLSTM_BWD = 10      # x Dh
# The xLSTM train path: full-width xlstm-1.3b cut to two super-blocks (7
# mLSTM + 1 sLSTM each) through launch.train.main.
XLSTM_TRAIN = dict(arch="xlstm-1.3b", n_layers=8, clients=2, batch=1,
                   seq=2048, local_steps=1, periods=2, max_rounds=1,
                   period_s=TRAIN["period_s"], policy="coop",
                   intra_backend="pallas")
XLSTM_TRAIN_MLSTM_LAYERS = 7
TRAIN_CLI = ("--periods", "2")   # launch.train's defaults otherwise


def emit(obj) -> None:
    """Print one JSON line, and append it to LOG: the whole record of a
    run, where a terminal may keep only its end."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def event_ms(fn, reps: int = 21, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``: the device timeline
    from before the call is issued to after its last kernel, so it includes
    any wait of the device on the host's launch path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 21, warmup: int = 3) -> float:
    """Median CUDA-event time of the device work of one call of ``fn``.
    A device sleep is queued before the start event, so the host has issued
    the call before the device reaches it: the launch path is hidden."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


FILLERS = 1024  # tiny kernels at each end of a kernel_profiler_ms window
# Per window, its names and the filler records the profiler did not keep
# at its start and at its end: the edge loss the fillers take (see
# _profiled_records).  A window that loses FILLERS_LOST_LIMIT or more at
# either end fails the phase: the loss may reach the kernel's records.
FILLERS_LOST: list[tuple[str, int, int]] = []
FILLERS_LOST_LIMIT = FILLERS // 2
# Host pause between entering the profiler and the first launch: tracing
# starts asynchronously, and without it a window lost 263-600 of its first
# fillers now and then (tests/torch_profiler_fillers.py).
PROFILER_SETTLE_S = 0.02


def _profiled_records(fn, reps: int, names) -> dict:
    """One profiler window: a PROFILER_SETTLE_S pause, FILLERS tiny
    kernels, an untimed call of ``fn`` and a synchronise, then ``reps``
    calls and FILLERS more tiny kernels.  A window can lose the device
    records of its first launches; the fillers take that loss, and how
    many of them each end lost goes to FILLERS_LOST; FILLERS_LOST_LIMIT or
    more at either end raises, naming the window.  Returns, per name, the
    device events whose names contain it."""
    from torch.autograd import DeviceType

    pad = torch.zeros(16, device=DEVICE)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(PROFILER_SETTLE_S)
        for _ in range(FILLERS):
            pad.add_(1.0)
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        for _ in range(FILLERS):
            pad.add_(1.0)
        torch.cuda.synchronize()
    device = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    filler = device[-1].name if device else None
    ends = []
    for seq in (device, device[::-1]):
        kept = 0
        while kept < min(FILLERS, len(seq)) and seq[kept].name == filler:
            kept += 1
        ends.append(FILLERS - kept)
    FILLERS_LOST.append((" ".join(names), *ends))
    if max(ends) >= FILLERS_LOST_LIMIT:
        raise AssertionError(
            f"profiler window {' '.join(names)}: lost {ends[0]} of its "
            f"{FILLERS} fillers at its start and {ends[1]} at its end "
            f"(limit {FILLERS_LOST_LIMIT}): its kernel records are suspect")
    return {name: [e for e in device if name in e.name] for name in names}


def kernel_profiler_ms(fn, kernel: str, reps: int = 21,
                       names: tuple[str, ...] = (),
                       min_records: int | None = None) -> float:
    """Mean device time per call of the CUDA kernels whose names contain
    ``names`` (default ``{kernel}_kernel``), from the profiler's CUDA
    activity records of ``reps`` + 1 calls (``_profiled_records``: the
    first call is untimed by the events, but its record counts).  At
    least ``min_records`` (default reps // 2) records of each must
    survive."""
    names = names or (f"{kernel}_kernel",)
    least = reps // 2 if min_records is None else min_records
    fn()
    torch.cuda.synchronize()
    records = _profiled_records(fn, reps, names)
    kept = {name: len(recs) for name, recs in records.items()}
    if any(not least <= n <= reps + 1 for n in kept.values()):
        raise AssertionError(f"profiler kept {kept} records of {names}, "
                             f"expected {least}..{reps + 1} each")
    return sum(sum(e.time_range.elapsed_us() for e in recs) / len(recs) / 1e3
               for recs in records.values())


def _np64(x) -> np.ndarray:
    return np.asarray(x.detach().double().cpu().numpy()
                      if torch.is_tensor(x) else x, np.float64)


def check_close(name: str, got, want, key: str, atol=None) -> dict:
    """Raise unless |got - want| <= atol + rtol |want| everywhere, with
    atol no more than ATOL_OF_MEAN of mean |want| (unless given); returns
    the largest absolute deviation and the tolerance applied."""
    rtol, default_atol = TOL[key]
    got, want = _np64(got), _np64(want)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}/{key}: shape {got.shape} vs "
                             f"{want.shape} or non-finite values")
    if atol is None:
        atol = default_atol
        if want.size:
            atol = min(atol, ATOL_OF_MEAN * float(np.mean(np.abs(want))))
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        raise AssertionError(f"{name}/{key}: {int(bad.sum())} entries beyond "
                             f"rtol {rtol} atol {atol}; max dev {err.max()}")
    return {"max_dev": float(err.max()) if err.size else 0.0,
            "rtol": rtol, "atol": atol}


def check_surplus_split(name: str, got_b, want_b, got_f, want_f,
                        f_at=None) -> dict:
    """Hold an auction allocation (Eq. 26) to the reference one.  Each
    period's surplus B - sum_j d_j(zeta+) goes to the few services bidding
    exactly at the clearing price, so their b absorbs the summed deviation
    of every other service's demand, which grows with N, and the float32
    rounding of the period's aggregate demand, a fraction of an ulp of B
    in each run.  So: b and f within TOL everywhere except at such
    entries, and in every period the summed |deviation| of the entries
    beyond TOL is at most that of the entries within it plus atol plus 2
    ulps of the period's total; their f is then held by the rounds check
    of compare_episodes.

    A b within its TOL can still move f = f*(b) (Eq. 7) past f's TOL where
    b is small.  Such an entry must then be f*(its own b): ``f_at(mask)``
    gives the reference's plain f*(got_b) at the masked entries, and got_f
    is held to it within TOL["f"] (listed under f/own_b).  Without
    ``f_at`` every f is held to want_f."""
    got_b, want_b = _np64(got_b), _np64(want_b)
    got_f, want_f = _np64(got_f), _np64(want_f)
    n = got_b.shape[-1]
    rtol, atol = TOL["b"]
    atol = min(atol, ATOL_OF_MEAN * float(np.mean(np.abs(want_b))))
    err = np.abs(got_b - want_b)
    out = err > atol + rtol * np.abs(want_b)
    err2, out2 = err.reshape(-1, n), out.reshape(-1, n)
    totals = np.abs(want_b).reshape(-1, n).sum(axis=1).astype(np.float32)
    for row in np.flatnonzero(out2.any(axis=1)):
        carried = float(err2[row][out2[row]].sum())
        absorbed = (float(err2[row][~out2[row]].sum()) + atol
                    + 2.0 * float(np.spacing(totals[row])))
        if carried > absorbed:
            raise AssertionError(
                f"{name}/b: period {row} deviates by {carried} at "
                f"{int(out2[row].sum())} services, more than the "
                f"{absorbed} the others' demands account for")
    keep = ~out
    checks = {"b": check_close(name, got_b[keep], want_b[keep], "b")}
    f_rtol, f_atol = TOL["f"]
    f_atol = min(f_atol, ATOL_OF_MEAN * float(np.mean(np.abs(want_f[keep]))))
    f_err = np.abs(got_f - want_f)
    own_b = keep & (f_err > f_atol + f_rtol * np.abs(want_f))
    if own_b.any() and f_at is None:
        raise AssertionError(f"{name}/f: {int(own_b.sum())} entries beyond "
                             f"rtol {f_rtol} atol {f_atol}; max dev "
                             f"{f_err[keep].max()}")
    checks["f"] = check_close(name, got_f[keep & ~own_b],
                              want_f[keep & ~own_b], "f", atol=f_atol)
    if own_b.any():
        plain = _np64(f_at(own_b))
        checks["f"]["own_b"] = {
            **check_close(f"{name}/f*(own b)", got_f[own_b], plain, "f",
                          atol=f_atol),
            "entries": [{"index": [int(i) for i in idx],
                         "b": float(got_b[idx]),
                         "b_reference": float(want_b[idx]),
                         "f": float(got_f[idx]),
                         "f_reference": float(want_f[idx]),
                         "f_plain_at_b": float(p)}
                        for idx, p in zip(zip(*np.nonzero(own_b)), plain)]}
    checks["b"]["surplus_entries"] = int(out.sum())
    checks["b"]["surplus_max_dev"] = float(err[out].max()) if out.any() else 0.0
    return checks


def bound(ops: float, nbytes: float,
          peak_ops: float = PEAK_F32_OPS) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def market(n: int, k: int):
    from repro_torch.core import network
    from repro_torch.core.types import mask_inactive

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    svc, _ = network.sample_services(gen, n, k_max=k)
    n_off = max(1, round(n * 0.1))
    return mask_inactive(svc, torch.arange(n, device=DEVICE) >= n_off)


def time_row(name: str, kern, plain, work_ops: float, nbytes: float) -> dict:
    bound_ms, bound_by = bound(work_ops, nbytes)
    return {"ms": device_ms(kern), "profiler_ms": kernel_profiler_ms(kern, name),
            "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_phase(n: int, k: int, m: int) -> dict:
    """Phase 3 at one shape: every kernel against its plain version."""
    from repro_torch.core import auction, disba
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
    from repro_torch.kernels.dual_demand import dual_demand_plain
    from repro_torch.kernels.market_clear import (market_clear_plain,
                                                  mbdf_demand_plain)

    svc = market(n, k)
    a, t, mk = svc.alpha, svc.t_comp, svc.mask
    cold = disba.solve_lambda_newton(svc, B_TOTAL)
    lam_prev = cold.lam * 1.03
    b = cold.b.contiguous()
    valid = float(mk.sum())             # (row, client) pairs with work
    nk = float(n * k)                   # also the mask's bytes
    trips_mc = 6 * disba.WARM_INNER_ITERS + 2 * 48
    cases = {
        "bisect_alloc": (
            lambda: ops.intra_allocate(a, t, mk, b),
            lambda: bisect_alloc_plain(a, t, mk, b),
            ("t_star", "split"),
            valid * 48, 4 * (2 * nk + n) + nk + 4 * (n + nk)),
        "dual_demand": (
            lambda: ops.dual_demand(a, t, mk, lam_prev,
                                    iters=disba.WARM_INNER_ITERS),
            lambda: dual_demand_plain(a, t, mk, lam_prev,
                                      disba.WARM_INNER_ITERS),
            ("b", "slope"),
            valid * disba.WARM_INNER_ITERS, 4 * (2 * nk + 1) + nk + 4 * 2 * n),
        "market_clear": (
            lambda: ops.market_clear(a, t, mk, B_TOTAL, lam_prev),
            lambda: market_clear_plain(a, t, mk, B_TOTAL, lam_prev),
            ("b", "f", "lam"),
            valid * trips_mc, 4 * (2 * nk + 2) + nk + 4 * (2 * n + 1)),
    }
    out = {}
    for name, (kern, plain, keys, work, nbytes) in cases.items():
        launches_before = ops.LAUNCHES[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        tag = f"{name}@{n}x{k}"
        checks = {key: check_close(tag, g, w, key)
                  for g, w, key in zip(got, want, keys)}
        if name == "bisect_alloc":
            # the water-filling split of every row sums to its budget
            checks["split_sum"] = check_close(tag, got[1].sum(dim=1), b,
                                              "split_sum")
        if name in ("bisect_alloc", "dual_demand"):
            checks["bitwise_repeats"] = bitwise_repeats(tag, kern, got)
            checks["depths_bitwise"] = depths_bitwise(tag, name, a, t, mk, (
                b if name == "bisect_alloc" else lam_prev), iters=(
                48 if name == "bisect_alloc" else disba.WARM_INNER_ITERS))
        if name == "market_clear":
            checks["b_total"] = check_close(tag, got[0].sum(),
                                            torch.tensor(B_TOTAL), "b")
            checks["bitwise_repeats"] = bitwise_repeats(tag, kern, got)
        row = {"name": name, "n": n, "k": k,
               "max_abs_err": max(checks[key]["max_dev"] for key in keys),
               "checks": checks,
               **time_row(name, kern, plain, OPS_PER_CLIENT_TRIP * work,
                          nbytes),
               "launches": ops.LAUNCHES[name] - launches_before}
        emit({"phase": "kernel_vs_plain", **row})
        out[name] = row

    # mbdf_demand on the bid grids of uniform_truthful_bids.
    name = "mbdf_demand"
    launches_before = ops.LAUNCHES[name]
    inactive = a.sum(dim=1) == 0
    checks = {}
    for alpha_fair in (0.0, 0.5, 1.0):
        prices = auction.uniform_truthful_bids(svc, m, alpha_fair).prices
        got = ops.mbdf_demand(a, t, mk, prices, alpha_fair)
        want = mbdf_demand_plain(a, t, mk, prices, alpha_fair)
        torch.cuda.synchronize()
        tag = f"{name}@{n}x{k}x{m}/a={alpha_fair}"
        checks[f"demand@{alpha_fair}"] = check_close(tag, got, want, "demand")
        if not bool((got >= 0).all()):
            raise AssertionError(f"{tag}: negative demand")
        if not bool((got[:, 1:] <= got[:, :-1]).all()):
            raise AssertionError(f"{tag}: demand rises along the price grid")
        if not bool((got[inactive] == 0).all()):
            raise AssertionError(f"{tag}: inactive rows demand bandwidth")
    prices = auction.uniform_truthful_bids(svc, m, 0.5).prices
    work = valid * 48 * m
    nbytes = 4 * (2 * nk + n * m) + nk + 4 * n * m
    row = {"name": name, "n": n, "k": k, "m": m, "alpha_fair": 0.5,
           "max_abs_err": max(c["max_dev"] for c in checks.values()),
           "checks": checks,
           **time_row(name, lambda: ops.mbdf_demand(a, t, mk, prices, 0.5),
                      lambda: mbdf_demand_plain(a, t, mk, prices, 0.5),
                      OPS_PER_CLIENT_TRIP_PRICE * work, nbytes),
           "launches": ops.LAUNCHES[name] - launches_before}
    emit({"phase": "kernel_vs_plain", **row})
    out[name] = row
    return out


def bitwise_repeats(tag: str, kern, first, reps: int = 21) -> int:
    """Raise unless ``reps`` more calls of ``kern`` give the bits of
    ``first`` in every output (lam above all: every block of the launch
    must fold the same partials in the same order)."""
    for i in range(reps):
        again = kern()
        for j, (x, y) in enumerate(zip(first, again)):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"{tag}: call {i + 1} changed output "
                                     f"{j}'s bits")
    return reps


def depths_bitwise(tag: str, name: str, a, t, mk, x, iters: int) -> list:
    """Raise unless B1 (``x`` the budgets) or B2 (``x`` the prices) gives
    the bits of depth 1 at every depth of DEPTHS compiled for its K (depth
    2 where K <= 64); returns those depths."""
    from repro_torch.kernels.bisect_alloc import (bisect_alloc_cuda,
                                                  bisect_alloc_plan)
    from repro_torch.kernels.dual_demand import dual_demand_cuda

    fn = bisect_alloc_cuda if name == "bisect_alloc" else dual_demand_cuda
    depths = []
    for j in DEPTHS:
        with contextlib.suppress(ValueError):   # no kernel at this depth
            depths.append(bisect_alloc_plan(*a.shape, j, device=DEVICE))
    first = fn(a, t, mk, x, iters, depth=depths[0])
    for j in depths[1:]:
        bitwise_repeats(f"{tag}/depth {j}",
                        lambda: fn(a, t, mk, x, iters, depth=j), first, reps=1)
    return depths


# The shape matrix of tests/test_tile_edges.py, mirrored for B3 and B4 on
# the card: every lane-group width and the ragged edges of N and K.
EDGE_K = (1, 7, 31, 32, 33, 45, 64, 65, 128, 1024)
EDGE_N = (1, 31, 8191)
EDGE_M = (1, 5, 8, 9)


def edge_market(n: int, k: int, active: str = "ragged"):
    """An (n, k) market from numpy's generator: alpha ~ U(0.01, 0.3),
    t^C ~ U(0.01, 0.06), each row's clients a ragged prefix, one row in
    ten inactive (rows 5, 15, ...); ``active`` "none" (every row inactive) or "one" (row
    n // 2 alone active)."""
    from repro_torch.core.types import ServiceSet

    rng = np.random.default_rng([n, k])
    alpha = rng.uniform(0.01, 0.3, (n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, (n, k)).astype(np.float32)
    mask = np.arange(k)[None, :] < rng.integers(1, k + 1, (n, 1))
    if active == "ragged":
        mask[5::10] = False
    else:
        mask[:] = False
        if active == "one":
            mask[n // 2, : max(1, k // 2)] = True
    alpha = torch.from_numpy(np.where(mask, alpha, 0.0)).to(DEVICE)
    t_comp = torch.from_numpy(np.where(mask, t_comp, 0.0)).to(DEVICE)
    return ServiceSet(alpha=alpha.contiguous(), t_comp=t_comp.contiguous(),
                      mask=torch.from_numpy(mask).to(DEVICE))


def edge_matrix_phase() -> dict:
    """B1-B4 against their plain versions on the card over the edge
    matrix, after the lane group chosen for every K up to ops.MAX_K is checked
    (L in 8, 16, 32, K <= L R <= 32 L): N x K, an all-inactive and a one-active-row market, and B4 at
    every M of EDGE_M, on price grids 1.15 m p_max / (M + 1): the top
    prices pass p_max (the opt-out), and none lies within 2% of it, where
    the demand jumps to 0 and an ulp of q decides the side.  B3 is seeded
    warm at 1.03 x the plain version's cold price (12 trips of 48 steps); tolerances as in phase 3.
    B1 on budgets U(0.2, 4), 0 on inactive rows and on one active row
    (t* = 1/TINY there, its split 0), its split summing to each budget;
    B2 at 24 trips on a price per row, p_max times U(0.1, 0.9) and 1.15 on
    every seventh row (the opt-out); both bitwise alike at every depth."""
    from repro_torch.core import intra
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
    from repro_torch.kernels.dual_demand import dual_demand_plain
    from repro_torch.kernels.market_clear import (grid_limits,
                                                  market_clear_plain,
                                                  mbdf_demand_plain)

    dev = torch.device(DEVICE).index or 0
    for k in range(1, ops.MAX_K + 1):
        lanes, regs = grid_limits(k, dev)[2:]
        if lanes not in (8, 16, 32) or not k <= lanes * regs <= 32 * lanes:
            raise AssertionError(f"lane group ({lanes}, {regs}) for K = {k}")
    cases = [(n, k, "ragged") for n in EDGE_N for k in EDGE_K]
    cases += [(31, 45, "none"), (31, 45, "one")]
    worst = {name: 0.0 for name in ("bisect_alloc", "dual_demand",
                                     "market_clear", "mbdf_demand")}
    groups = set()
    for n, k, active in cases:
        svc = edge_market(n, k, active)
        a, t, mk = svc.alpha, svc.t_comp, svc.mask
        groups.add(grid_limits(k, dev)[2:])
        rng = np.random.default_rng([n, k, 1])
        live = (a.sum(dim=1) > 0).cpu().numpy()
        b = np.where(live, rng.uniform(0.2, 4.0, n), 0.0)
        b[np.flatnonzero(live)[len(np.flatnonzero(live)) // 2:][:1]] = 0.0
        b = torch.tensor(b, dtype=torch.float32, device=DEVICE)
        tag = f"bisect_alloc@{n}x{k}/{active}"
        got = ops.intra_allocate(a, t, mk, b)
        want = bisect_alloc_plain(a, t, mk, b)
        for g, w, key in zip(got, want, ("t_star", "split")):
            worst["bisect_alloc"] = max(worst["bisect_alloc"], check_close(
                tag, g, w, key)["max_dev"])
        check_close(tag, got[1].sum(dim=1), b, "split_sum")
        depths_bitwise(tag, "bisect_alloc", a, t, mk, b, 48)
        u = rng.uniform(0.1, 0.9, n)
        u[::7] = 1.15
        lam = (intra.p_max(svc) * torch.tensor(u, dtype=torch.float32,
                                               device=DEVICE)).contiguous()
        tag = f"dual_demand@{n}x{k}/{active}"
        got = ops.dual_demand(a, t, mk, lam, iters=24)
        want = dual_demand_plain(a, t, mk, lam, 24)
        for g, w, key in zip(got, want, ("b", "slope")):
            worst["dual_demand"] = max(worst["dual_demand"], check_close(
                tag, g, w, key)["max_dev"])
        depths_bitwise(tag, "dual_demand", a, t, mk, lam, 24)
        cold = market_clear_plain(a, t, mk, B_TOTAL, torch.tensor(
            -1.0, device=DEVICE), iters=12, newton_inner_iters=48)[2]
        lam_prev = (cold * 1.03).contiguous()
        tag = f"market_clear@{n}x{k}/{active}"
        got = ops.market_clear(a, t, mk, B_TOTAL, lam_prev)
        want = market_clear_plain(a, t, mk, B_TOTAL, lam_prev)
        for g, w, key in zip(got, want, ("b", "f", "lam")):
            worst["market_clear"] = max(worst["market_clear"], check_close(
                tag, g, w, key)["max_dev"])
        if active != "none":
            check_close(tag, got[0].sum(), torch.tensor(B_TOTAL), "b")
        inactive = a.sum(dim=1) == 0
        pmax = intra.p_max(svc)
        for m in EDGE_M:
            steps = torch.arange(1, m + 1, dtype=torch.float32, device=DEVICE)
            prices = (1.15 * steps[None, :] * pmax[:, None]
                      / (m + 1)).contiguous()
            tag = f"mbdf_demand@{n}x{k}x{m}/{active}"
            got = ops.mbdf_demand(a, t, mk, prices, 0.5)
            want = mbdf_demand_plain(a, t, mk, prices, 0.5)
            worst["mbdf_demand"] = max(worst["mbdf_demand"], check_close(
                tag, got, want, "demand")["max_dev"])
            if not bool((got >= 0).all()):
                raise AssertionError(f"{tag}: negative demand")
            if not bool((got[:, 1:] <= got[:, :-1]).all()):
                raise AssertionError(f"{tag}: demand rises along the grid")
            if not bool((got[inactive] == 0).all()):
                raise AssertionError(f"{tag}: inactive rows demand bandwidth")
    torch.cuda.synchronize()
    row = {"shapes": len(cases), "b4_grids": len(cases) * len(EDGE_M),
           "lane_groups": sorted(groups), "max_dev": worst}
    emit({"phase": "edge_matrix", **row})
    return row


def full_market(n: int, k: int):
    """The market of ``market`` drawn with every row active and full: no
    alpha = 0 anywhere (the zero lanes' share of B3's and B4's time)."""
    from repro_torch.core import network

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    counts = torch.full((n,), k, dtype=torch.int32, device=DEVICE)
    svc, _ = network.sample_services(gen, n, k_max=k, client_counts=counts)
    return svc


def divide_sass(name: str) -> dict | None:
    """The built library's SASS per kernel function (cuobjdump -sass):
    how many divide checks (FCHK) and subroutine calls (CALL, the IEEE
    divide's slow path) each holds.  The text goes to build/sass_{name}.txt.
    None where the toolkit has no cuobjdump."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(_build._library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    (ROOT / "build" / f"sass_{name}.txt").write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"FCHK": 0, "CALL": 0, "MUFU.RCP": 0}
        elif fn is not None:
            for op in counts[fn]:
                if f" {op}" in line:
                    counts[fn][op] += 1
    return counts


def b3_parts() -> dict:
    """B3's time in parts, from its own launch arguments, at both market
    shapes and on the full copy of each: (a) no trips (the barriers of the
    bracket top and the projection, loads, stores), (b) six Newton trips
    without bisection (their reductions and barriers), (c) plus the 6 x 24
    Newton bisection steps, (d) the full call (plus 2 x 48 steps of the
    final demand and the frequency).  Derived: per trip, per bisection
    step (one step of every row), and the full copy's difference."""
    from repro_torch.core import disba
    from repro_torch.kernels import ops

    variants = {"a": (0, 0, 0), "b": (6, 0, 0), "c": (6, 0, 24),
                "d": (6, 48, 24)}
    out = {}
    for n, k, _ in KERNEL_SHAPES[:2]:
        for label, svc in ((f"{n}x{k}", market(n, k)),
                           (f"{n}x{k}_full", full_market(n, k))):
            a, t, mk = svc.alpha, svc.t_comp, svc.mask
            lam_prev = disba.solve_lambda_newton(svc, B_TOTAL).lam * 1.03
            ms = {v: device_ms(lambda it=it: ops.market_clear(
                      a, t, mk, B_TOTAL, lam_prev, iters=it[0],
                      inner_iters=it[1], newton_inner_iters=it[2]))
                  for v, it in variants.items()}
            out[label] = {**ms, "per_trip_ms": (ms["b"] - ms["a"]) / 6,
                          "per_newton_step_ms": (ms["c"] - ms["b"]) / 144,
                          "per_final_step_ms": (ms["d"] - ms["c"]) / 96}
        out[f"{n}x{k}"]["full_minus_market_ms"] = (
            out[f"{n}x{k}_full"]["d"] - out[f"{n}x{k}"]["d"])
    row = {"variants": {v: {"iters": it[0], "inner_iters": it[1],
                            "newton_inner_iters": it[2]}
                        for v, it in variants.items()},
           **out, "sass": divide_sass("market_clear")}
    emit({"phase": "b3_parts", **row})
    return row


def b4_parts() -> dict:
    """B4's time at M = 5 on the market and its full copy, at alpha_fair
    0.5 and 0 (a_fair / (1 + f) divides 0 when alpha_fair is 0), and with
    no bisection trips (iters 0: loads, the final demand, stores)."""
    from repro_torch.core import auction
    from repro_torch.kernels import ops

    n, k, _ = KERNEL_SHAPES[0]
    m = 5
    out = {}
    for label, svc in (("market", market(n, k)), ("full", full_market(n, k))):
        a, t, mk = svc.alpha, svc.t_comp, svc.mask
        for alpha_fair in (0.5, 0.0):
            prices = auction.uniform_truthful_bids(svc, m, alpha_fair).prices
            for iters in (48, 0):
                out[f"{label}@a={alpha_fair},iters={iters}"] = device_ms(
                    lambda: ops.mbdf_demand(a, t, mk, prices, alpha_fair,
                                            iters=iters))
    per_step = {key: (out[f"{key},iters=48"] - out[f"{key},iters=0"]) / 48
                for key in ("market@a=0.5", "market@a=0.0", "full@a=0.5",
                            "full@a=0.0")}
    row = {"n": n, "k": k, "m": m, "ms": out, "per_step_ms": per_step,
           "sass": divide_sass("mbdf_demand")}
    emit({"phase": "b4_parts", **row})
    return row


# B1 and B2 in parts: the main path's shape (10 x 45: the paper's ten
# services, 25 +- sqrt(15) clients, K = simulator._k_cap), B1's market
# selfish shape (8192 x 45), and phase 3's two market shapes.
B12_SHAPES = ((10, 45), (8192, 45), (8191, 45), (8192, 32))
B12_SWEEP_N = (10, 132, 528, 1056, 2112, 8192)   # the depth sweep, K = 45


def b12_parts() -> dict:
    """B1 and B2's time in parts at each of B12_SHAPES, on the market (as
    ``market``: seed 5, 10% of rows inactive, cold coop price and budget)
    and on its full copy: B1 with 0 and 48 trips, B2 with 0, 24 and 48
    (giving the cost of a trip, and the zero lanes' cost as the full copy's
    difference), the wrapper's time per call beside the kernel's, and the
    count of divide checks and slow-path calls in each kernel's SASS.  Then
    B1 (48 trips) and B2 (24 trips) at every speculation depth of
    DEPTHS over B12_SWEEP_N at K = 45, each depth's outputs bitwise
    those of depth 1, and the depth a launch picks by itself (one rule
    for both)."""
    from repro_torch.core import disba
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import (bisect_alloc_cuda,
                                                  bisect_alloc_plan)
    from repro_torch.kernels.dual_demand import dual_demand_cuda

    def inputs(svc):
        cold = disba.solve_lambda_newton(svc, B_TOTAL)
        return (svc.alpha, svc.t_comp, svc.mask, cold.b.contiguous(),
                (cold.lam * 1.03).contiguous())

    out = {}
    for n, k in B12_SHAPES:
        for label, svc in ((f"{n}x{k}", market(n, k)),
                           (f"{n}x{k}_full", full_market(n, k))):
            a, t, mk, b, lam = inputs(svc)
            ms = {f"b1@{it}": device_ms(
                      lambda it=it: bisect_alloc_cuda(a, t, mk, b, it))
                  for it in (0, 48)}
            ms.update({f"b2@{it}": device_ms(
                           lambda it=it: dual_demand_cuda(a, t, mk, lam, it))
                       for it in (0, 24, 48)})
            out[label] = {
                "ms": ms,
                "b1_per_trip_us": 1e3 * (ms["b1@48"] - ms["b1@0"]) / 48,
                "b2_per_trip_us": 1e3 * (ms["b2@24"] - ms["b2@0"]) / 24,
                "wrapper_ms": {
                    "b1@48": event_ms(lambda: ops.intra_allocate(a, t, mk, b)),
                    "b2@24": event_ms(lambda: ops.dual_demand(
                        a, t, mk, lam, iters=disba.WARM_INNER_ITERS))}}
        for key in ("b1@48", "b2@24", "b2@48"):
            out[f"{n}x{k}"].setdefault("full_minus_market_ms", {})[key] = (
                out[f"{n}x{k}_full"]["ms"][key] - out[f"{n}x{k}"]["ms"][key])
    sweep = {}
    for n in B12_SWEEP_N:
        a, t, mk, b, lam = inputs(market(n, 45))
        row, first = {}, {}
        for j in DEPTHS:
            for name, fn in (
                    ("b1@48", lambda: bisect_alloc_cuda(a, t, mk, b, 48,
                                                        depth=j)),
                    ("b2@24", lambda: dual_demand_cuda(a, t, mk, lam, 24,
                                                       depth=j))):
                got = fn()
                if name in first:
                    bitwise_repeats(f"{name}@{n}x45/depth {j}", fn,
                                    first[name], reps=1)
                else:
                    first[name] = got
                row[f"{name}/depth{j}"] = device_ms(fn)
        row["picked"] = bisect_alloc_plan(n, 45, device=DEVICE)
        sweep[f"{n}x45"] = row
    row = {**out, "sweep": sweep,
           "sass": {name: divide_sass(name)
                    for name in ("bisect_alloc", "dual_demand")}}
    emit({"phase": "b12_parts", **row})
    return row


def compare_episodes(name: str, got: dict, want: dict, period_s: float,
                     must_finish: bool, auction: bool = False,
                     f_at=None) -> dict:
    """Hold a kernel-backend episode to the reference one.

    Rounds per period (floor(f T)) and durations must be equal, with one
    exception: where the two runs' f lie on either side of an integer of
    rounds, floor(f T) may differ by one (float32 f from two summation
    orders), and then that service's duration may differ by one.  Every
    such flip is reported.  b and f are within tolerance; for an auction
    policy (``auction``) by ``check_surplus_split`` (with ``f_at``)."""
    if got["periods"] != want["periods"] or (
            must_finish and not (got["finished"] and want["finished"])):
        raise AssertionError(f"{name}: episodes ran {got['periods']} and "
                             f"{want['periods']} periods, finished "
                             f"{got['finished']} and {want['finished']}")
    if got["fallbacks"] or want["fallbacks"]:
        raise AssertionError(f"{name}: the warm solver's rescue ran "
                             f"{got['fallbacks']} and {want['fallbacks']} "
                             f"times")
    h, rh = got["history"], want["history"]
    dev = (check_surplus_split(name, h["b"], rh["b"], h["f"], rh["f"], f_at)
           if auction else {key: check_close(name, h[key], rh[key], key)
                            for key in ("b", "f")})
    f_got = np.float32(period_s) * got["history"]["f"].astype(np.float32)
    f_want = np.float32(period_s) * want["history"]["f"].astype(np.float32)
    r_got, r_want = got["history"]["rounds"], want["history"]["rounds"]
    straddle = np.floor(f_got) != np.floor(f_want)
    differ = r_got != r_want
    flips = np.argwhere(differ & straddle & (np.abs(r_got - r_want) == 1))
    if np.any(differ & ~straddle) or len(flips) != int(differ.sum()):
        raise AssertionError(f"{name}: rounds differ at "
                             f"{np.argwhere(differ)[:10].tolist()}")
    flipped = set(int(svc) for _, svc in flips)
    d_got, d_want = list(got["durations"]), list(want["durations"])
    bad = [i for i, (x, y) in enumerate(zip(d_got, d_want))
           if x != y and not (i in flipped and abs(x - y) == 1)]
    if bad:
        raise AssertionError(f"{name}: durations differ for services {bad}")
    surplus = {key: dev[col][key] for col, key in (
                   ("b", "surplus_entries"), ("b", "surplus_max_dev"),
                   ("f", "own_b")) if key in dev[col]}
    return {"max_dev_b": dev["b"]["max_dev"], "atol_b": dev["b"]["atol"],
            **surplus,
            "max_dev_f": dev["f"]["max_dev"], "atol_f": dev["f"]["atol"],
            "rounds_per_period_max": int(r_want.max()),
            "durations_min_max": [int(min(d_want)), int(max(d_want))],
            "round_flips": [{"period": int(p), "service": int(v),
                             "fT_kernel": float(f_got[p, v]),
                             "fT_reference": float(f_want[p, v])}
                            for p, v in flips]}


# Kernels each kernel backend must launch in an episode of each policy,
# per path of phase 4.
SLICE1 = {("coop", True, "megakernel"): ("market_clear",),
          ("coop", True, "pallas"): ("dual_demand", "bisect_alloc"),
          ("coop", False, "pallas"): ("bisect_alloc",),
          ("es", False, "pallas"): ("bisect_alloc",),
          ("pp", False, "pallas"): ("bisect_alloc",),
          ("ec", False, "pallas"): ()}
# Episodes cut to a number of periods, compared up to there: the cold coop
# pair runs ~0.5 s a period on both backends (host-bound), ~205 s for the
# whole ~205-period pair, which the run's time limit cannot hold beside the
# xLSTM paths; at 120 periods the services that started first finish.
SLICE1_CUTS = {("coop", False, "pallas"): 120}
SELFISH = {("selfish", False, "pallas"): ("mbdf_demand", "bisect_alloc"),
           ("selfish", False, "megakernel"): ("mbdf_demand", "bisect_alloc")}
EXPECTED = {**SLICE1, **SELFISH}


def _check_launches(label: str, backend: str, key, klaunch: dict,
                    rlaunch: dict) -> None:
    if any(rlaunch.values()):
        raise AssertionError(f"{label}: the reference run launched {rlaunch}")
    missing = [name for name in EXPECTED[key] if not klaunch[name]]
    if missing:
        raise AssertionError(f"{label}: the {backend} run never launched "
                             f"{missing} ({klaunch})")


@contextlib.contextmanager
def recording_sets(policy: str, sets: list):
    """Within the block, ``policy`` appends every service set it is handed
    (masked, as it sees it) to ``sets``; it computes as before."""
    from repro_torch.core import policy as policy_mod

    factory = policy_mod._REGISTRY[policy]

    def recording(**options):
        fn = factory(**options)

        def step(svc, b_total):
            sets.append(svc)
            return fn(svc, b_total)

        return step

    policy_mod.register(policy)(recording)
    try:
        yield sets
    finally:
        policy_mod.register(policy)(factory)


def f_at_own_b(sets: list, b_hist: np.ndarray):
    """``check_surplus_split``'s f_at for an episode: the reference
    backend's plain f*(b) at each period's own b, on the set its policy
    was handed that period."""
    from repro_torch.core import policy as policy_mod

    freq = policy_mod.freq_fn("reference")

    def f_at(mask: np.ndarray) -> np.ndarray:
        out = []
        for period in np.flatnonzero(mask.any(axis=1)):
            b = torch.from_numpy(np.ascontiguousarray(b_hist[period]))
            f = freq(sets[period], b.to(DEVICE)).cpu().numpy()
            out.append(f[mask[period]])
        return np.concatenate(out)

    return f_at


@contextlib.contextmanager
def keeping_samplers(samplers: list):
    """Within the block, every sampler an engine makes for itself (no
    ``sampler`` given) is appended to ``samplers``; its ``waits`` are the
    seconds the period loop waited on each period's draws."""
    from repro_torch.fl import simulator

    real = simulator._PrefetchingSampler

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            samplers.append(self)

    simulator._PrefetchingSampler = Kept
    try:
        yield samplers
    finally:
        simulator._PrefetchingSampler = real


def draw_wait_ms(samplers: list) -> float | None:
    """Median ms the period loop waited on a period's draws, periods 1-9
    (period 0's draws cannot be made ahead); None where the engine drew
    inline (periods under PREFETCH_MIN_SLOTS slots, the paper's)."""
    if not samplers:
        return None
    (sampler,) = samplers
    return 1e3 * float(np.median(sampler.waits[1:10]))


def run_pair(cfg_kw: dict, label: str, must_finish: bool = True,
             net=None, arrivals=None, counts=None) -> dict:
    """One episode with the kernel backend, one with "reference", on the
    same sampler stream; each run's kernel launches are counted.  For
    ``selfish`` the kernel run's service sets are kept for
    ``check_surplus_split``'s f*(own b)."""
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    backend = cfg_kw["intra_backend"]
    auction = cfg_kw["policy"] == "selfish"
    runs, sets, waits = {}, [], {}
    for bk in (backend, "reference"):
        cfg = simulator.SimConfig(**{**PAPER, **cfg_kw, "intra_backend": bk},
                                  collect_alloc=True)
        net = net or simulator._default_net(cfg)
        before = dict(ops.LAUNCHES)
        record = (recording_sets(cfg.policy, sets) if auction and bk == backend
                  else contextlib.nullcontext())
        samplers = []
        t0 = time.perf_counter()
        with record, keeping_samplers(samplers):
            res = simulator.run_scan(cfg, net, arrivals=arrivals,
                                     counts=counts, device=DEVICE)
        sec = time.perf_counter() - t0
        runs[bk] = (res, sec, {name: ops.LAUNCHES[name] - before[name]
                               for name in ops.LAUNCHES})
        waits[bk] = (draw_wait_ms(samplers),
                     [1e3 * w for w in samplers[0].waits] if samplers
                     else None)
    (kres, ksec, klaunch), (rres, rsec, rlaunch) = runs[backend], runs["reference"]
    _check_launches(label, backend,
                    (cfg_kw["policy"], cfg_kw["warm_start"], backend),
                    klaunch, rlaunch)
    if auction and len(sets) != kres["periods"]:
        raise AssertionError(f"{label}: {len(sets)} sets kept for "
                             f"{kres['periods']} periods")
    row = {"case": label, "periods": kres["periods"],
           "kernel_s": ksec, "reference_s": rsec,
           "kernel_periods_per_s": kres["periods"] / ksec,
           "reference_periods_per_s": rres["periods"] / rsec,
           "avg_duration": kres["avg_duration"], "launches": klaunch,
           "draw_wait_ms": waits[backend][0],
           "reference_draw_wait_ms": waits["reference"][0],
           "draw_waits_ms": {bk: w[1] for bk, w in waits.items()},
           **compare_episodes(label, kres, rres, net.period_s, must_finish,
                              auction=auction,
                              f_at=f_at_own_b(sets, kres["history"]["b"]))}
    emit({"phase": "episode", **row})
    return row


def market_kw() -> dict:
    return dict(n_services_total=MARKET_N, max_periods=10,
                rounds_required=100)


def market_setting():
    """The market-scale episode's network (the paper's 1 MHz a service),
    arrivals (all at period 0) and client counts."""
    from repro_torch.fl import simulator

    cfg = simulator.SimConfig(**market_kw())
    net = simulator._default_net(cfg)
    net = dataclasses.replace(net, total_bandwidth_mhz=(
        net.total_bandwidth_mhz * cfg.n_services_total
        / simulator.SimConfig().n_services_total))
    _, counts = simulator._static_draws(cfg, net)
    return net, np.zeros(cfg.n_services_total, np.int64), counts


def market_pair(policy: str, warm: bool, backend: str) -> dict:
    """The market-scale episode: every service arrives at period 0 and gets
    the paper's share of 1 MHz (B = 10 MHz over 10 services), so each runs
    several rounds per period; 100 rounds (not 2000) let services finish,
    at different periods, within the 10-period episode."""
    net, arrivals, counts = market_setting()
    return run_pair(dict(policy=policy, warm_start=warm,
                         intra_backend=backend, **market_kw()),
                    f"{policy}{'-warm' if warm else ''}-{backend}"
                    f"-market{MARKET_N}", must_finish=False, net=net,
                    arrivals=arrivals, counts=counts)


def draw_samplers() -> dict:
    """The measure of C6 and the evidence for PREFETCH_MIN_SLOTS: warm coop
    on "megakernel", at market scale and at the paper's setting, under
    three samplers run in turns (ABC CBA; periods/s of each, median of its
    two runs): the prefetching sampler (the engine's own at market scale),
    default_sampler inline (the engine's own at the paper's), and every
    period's draws made before the episode and already on the card (the
    episode with no host draws).  The episodes must agree in every
    duration."""
    from repro_torch.fl import simulator

    out = {}
    for label in ("market", "paper"):
        common = dict(policy="coop", warm_start=True,
                      intra_backend="megakernel", collect_alloc=True)
        if label == "market":
            net, arrivals, counts = market_setting()
            cfg = simulator.SimConfig(**market_kw(), **common)
        else:
            cfg = simulator.SimConfig(**PAPER, **common)
            net = simulator._default_net(cfg)
            arrivals, counts = simulator._static_draws(cfg, net)
        run = functools.partial(simulator.run_scan, cfg, net,
                                arrivals=arrivals, counts=counts,
                                device=DEVICE)
        inline = simulator.default_sampler(cfg, net, counts, DEVICE)
        card = [inline(p) for p in range(run(sampler=inline)["periods"])]
        samplers = {
            "prefetch": lambda: simulator._PrefetchingSampler(
                cfg, net, counts, DEVICE),
            "inline": lambda: inline,
            "on_card": lambda: card.__getitem__}
        rates, durations = {name: [] for name in samplers}, set()
        for name in list(samplers) + list(samplers)[::-1]:
            sampler = samplers[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = run(sampler=sampler)
                torch.cuda.synchronize()
            finally:
                if name == "prefetch":
                    sampler.close()
            rates[name].append(res["periods"] / (time.perf_counter() - t0))
            durations.add(tuple(res["durations"]))
        if len(durations) != 1:
            raise AssertionError(f"draw_samplers/{label}: the samplers ran "
                                 f"different episodes")
        out[label] = {"periods": res["periods"],
                      "slots": cfg.n_services_total * simulator._k_cap(cfg),
                      "engine_prefetches": cfg.n_services_total
                      * simulator._k_cap(cfg) >= simulator.PREFETCH_MIN_SLOTS,
                      "periods_per_s": {name: float(np.median(r))
                                        for name, r in rates.items()},
                      "runs": rates}
    emit({"phase": "draw_samplers", **out})
    return out


def batch_pair() -> dict:
    """run_batch over BATCH_SEEDS with correlated scenario processes, warm
    coop on "megakernel" against "reference"; each seed's episode held to
    the reference's by compare_episodes."""
    from repro_torch import scenarios
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    cfg_kw = dict(PAPER, policy="coop", warm_start=True,
                  channel_process=scenarios.spec("gauss_markov"),
                  churn_process=scenarios.spec("gilbert"),
                  arrival_process="mmpp", collect_alloc=True)
    runs = {}
    for bk in ("megakernel", "reference"):
        cfg = simulator.SimConfig(**cfg_kw, intra_backend=bk)
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        res = simulator.run_batch(cfg, list(BATCH_SEEDS), device=DEVICE)
        runs[bk] = (res, time.perf_counter() - t0,
                    {name: ops.LAUNCHES[name] - before[name]
                     for name in ops.LAUNCHES})
    (kres, ksec, klaunch), (rres, rsec, rlaunch) = (runs["megakernel"],
                                                    runs["reference"])
    _check_launches("run_batch", "megakernel", ("coop", True, "megakernel"),
                    klaunch, rlaunch)
    period_s = simulator._default_net(cfg).period_s
    rows = []
    for i, seed in enumerate(BATCH_SEEDS):
        per = [_episode(kres, i), _episode(rres, i)]
        rows.append({"seed": seed, "periods": per[0]["periods"],
                     **compare_episodes(f"run_batch/seed {seed}", *per,
                                        period_s, must_finish=True)})
    periods = sum(r["periods"] for r in rows)
    row = {"case": "run_batch-gauss_markov-gilbert-mmpp-coop-warm-megakernel",
           "seeds": list(BATCH_SEEDS), "kernel_s": ksec, "reference_s": rsec,
           "kernel_periods_per_s": periods / ksec,
           "reference_periods_per_s": periods / rsec,
           "launches": klaunch, "per_seed": rows}
    emit({"phase": "episode", **row})
    return row


def drive_path(label: str, fn, keep: bool = False):
    """Run one main path with the launch counts set to 0 just before it,
    and return the counts read just after (with ``keep``, the path's
    result instead; the counts are in PATH_LAUNCHES either way)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    result = fn()
    launches = dict(ops.LAUNCHES)
    PATH_LAUNCHES[label] = launches
    emit({"phase": "path", "path": label, "launches": launches})
    return result if keep else launches


PATH_LAUNCHES: dict[str, dict] = {}


def path_slice1() -> None:
    for pol, warm, backend in SLICE1:
        cut = SLICE1_CUTS.get((pol, warm, backend))
        run_pair(dict(policy=pol, warm_start=warm, intra_backend=backend,
                      **({} if cut is None else {"max_periods": cut})),
                 f"{pol}{'-warm' if warm else ''}-{backend}",
                 must_finish=cut is None)
    market_pair("coop", True, "megakernel")


def path_selfish() -> None:
    for pol, warm, backend in SELFISH:
        run_pair(dict(policy=pol, warm_start=warm, intra_backend=backend),
                 f"{pol}-{backend}")
    market_pair("selfish", False, "pallas")


# ---------------------------------------------------------------------------
# Slice 9: training paced by allocation (fl.cotrain), run_fleet, legacy run.
# ---------------------------------------------------------------------------

# BENCH_cotrain's setting (benchmarks/paper_figs_cotrain.py:81-87).
COTRAIN_SIM = dict(n_services_total=5, rounds_required=48, p_arrive=3.0,
                   max_periods=64, k_max=32, mean_clients=12.0,
                   var_clients=12.0)
COTRAIN_NET = dict(total_bandwidth_mhz=2.0, period_s=4.0, mean_clients=12.0,
                   var_clients=12.0, t_local_lo=0.15, t_local_hi=0.3)
COTRAIN_TRAIN = dict(vocab=32, seq_len=8, batch_size=4, eval_batch=32,
                     rounds_cap=14, client_lr=0.5)
# (policy, warm, kernel backend), each against "reference" on the card
COTRAIN_CASES = (("coop", True, "megakernel"), ("coop", True, "pallas"),
                 ("es", False, "pallas"), ("pp", False, "pallas"),
                 ("selfish", False, "pallas"))
COTRAIN_PAPER_CASES = (("coop", True, "megakernel"),
                       ("selfish", False, "pallas"))
# The paper-setting cases cut to 40 periods (the whole episodes, 190-205
# periods of up to 139 executed rounds, took 35 s on the card and 55 s on
# "reference"): services arrive and train, none finishes.
COTRAIN_PAPER = {"max_periods": 40}
COTRAIN_SEEDS = (0, 1, 2)   # run_cotrain_batch against run_cotrain_fleet
FLEET_SEEDS = (0, 1, 2, 3, 4)
FLEET_CHUNK = 2
COTRAIN_KERNELS = ("bisect_alloc", "dual_demand", "market_clear",
                   "mbdf_demand")
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5   # loss, train_loss (the CPU tests')
PARAMS_ATOL = 1e-4


class TimedData:
    """A co-trained episode's batch stream with the host seconds of its
    training draws (one call a round; the episode's one eval draw is not
    counted)."""

    def __init__(self, data):
        self.data, self.seconds, self.rounds = data, 0.0, 0

    def batches(self, step, batch_size, client_ids):
        from repro_torch.fl import cotrain

        t0 = time.perf_counter()
        out = self.data.batches(step, batch_size, client_ids)
        if not np.all(np.asarray(step) == cotrain._EVAL_STEP):
            self.seconds += time.perf_counter() - t0
            self.rounds += 1
        return out


def cotrain_setting():
    """(SimConfig kwargs, NetworkConfig, TrainSpec) of BENCH_cotrain."""
    from repro_torch.core import network
    from repro_torch.fl import cotrain

    return (dict(COTRAIN_SIM), network.NetworkConfig(**COTRAIN_NET),
            cotrain.TrainSpec(**COTRAIN_TRAIN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cotrain_run(cfg, train, net, device=None) -> tuple:
    """One co-trained episode: (result, seconds, launches by kernel, the
    timed batch stream)."""
    from repro_torch.fl import cotrain
    from repro_torch.kernels import ops

    device = device or DEVICE
    data = TimedData(cotrain.default_data(train))
    before = dict(ops.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    res = cotrain.run_cotrain_scan(cfg, train, net, data=data, device=device)
    _sync(device)
    sec = time.perf_counter() - t0
    return (res, sec, {name: ops.LAUNCHES[name] - before[name]
                       for name in ops.LAUNCHES}, data)


def training_deviation(label: str, got: dict, want: dict, train) -> dict:
    """Where two co-trained episodes trained the same rounds with the same
    participants: loss and train_loss within TRAIN_RTOL / TRAIN_ATOL, acc
    within one eval token, the final tables within PARAMS_ATOL (raises
    beyond).  Else the check is not made, and the row says so."""
    h, rh = got["history"], want["history"]
    same = (h["trained"].shape == rh["trained"].shape
            and np.array_equal(h["trained"], rh["trained"])
            and np.array_equal(h["participants"], rh["participants"]))
    if not same:
        return {"same_trained_stream": False}
    out = {"same_trained_stream": True}
    for key in ("loss", "train_loss"):
        err = np.abs(h[key].astype(np.float64) - rh[key])
        if np.any(err > TRAIN_ATOL + TRAIN_RTOL * np.abs(rh[key])):
            raise AssertionError(f"{label}: {key} off by {err.max()}")
        out[f"max_dev_{key}"] = float(err.max())
    one_token = 1.0 / (train.eval_batch * train.seq_len)
    acc = float(np.max(np.abs(h["acc"] - rh["acc"])))
    params = float(np.max(np.abs(got["params"] - want["params"])))
    if acc > one_token + 1e-6 or params > PARAMS_ATOL:
        raise AssertionError(f"{label}: acc off by {acc}, params by "
                             f"{params}")
    out.update(max_dev_acc=acc, one_eval_token=one_token,
               max_dev_params=params)
    return out


def cotrain_pair(label: str, cfg_kw: dict, net, train,
                 must_finish: bool) -> dict:
    """A co-trained episode on a kernel backend and on "reference" on the
    card (durations as compare_episodes holds them, training by
    training_deviation), and the plain run_scan of the kernel backend's
    config in the same call: its durations bitwise the co-trained
    episode's, its periods/s the ratio's denominator."""
    from repro_torch.fl import simulator

    backend = cfg_kw["intra_backend"]
    auction = cfg_kw["policy"] == "selfish"
    runs, sets = {}, []
    for bk in (backend, "reference"):
        cfg = simulator.SimConfig(**{**cfg_kw, "intra_backend": bk})
        record = (recording_sets(cfg.policy, sets) if auction and bk == backend
                  else contextlib.nullcontext())
        with record:
            runs[bk] = cotrain_run(cfg, train, net)
    (kres, ksec, klaunch, kdata), (rres, rsec, rlaunch, _) = (
        runs[backend], runs["reference"])
    _check_launches(label, backend,
                    (cfg_kw["policy"], cfg_kw["warm_start"], backend),
                    klaunch, rlaunch)
    cfg = simulator.SimConfig(**cfg_kw)
    _sync(DEVICE)
    t0 = time.perf_counter()
    plain = simulator.run_scan(cfg, net, device=DEVICE)
    _sync(DEVICE)
    plain_s = time.perf_counter() - t0
    if (plain["durations"] != kres["durations"]
            or plain["periods"] != kres["periods"]):
        raise AssertionError(f"{label}: co-trained durations "
                             f"{kres['durations']} differ from run_scan's "
                             f"{plain['durations']}")
    periods = kres["periods"]
    row = {"case": label, "periods": periods,
           "services": cfg.n_services_total, "k_max": simulator._k_cap(cfg),
           "cotrain_s": ksec, "reference_cotrain_s": rsec, "plain_s": plain_s,
           "cotrain_periods_per_s": periods / ksec,
           "plain_periods_per_s": plain["periods"] / plain_s,
           "cotrain_over_plain": (periods / ksec) / (plain["periods"]
                                                    / plain_s),
           "reference_cotrain_periods_per_s": rres["periods"] / rsec,
           "executed_rounds": int(sum(kres["trained_rounds"])),
           "clipped_rounds": kres["clipped_rounds"],
           "rounds_per_period_max": int(kres["history"]["trained"].sum(
               axis=1).max()),
           "training_rounds_drawn": kdata.rounds,
           "host_ms_per_round_draws": (1e3 * kdata.seconds
                                       / max(kdata.rounds, 1)),
           "launches": klaunch,
           "launches_per_period": {name: count / periods
                                   for name, count in klaunch.items()
                                   if count},
           "final_loss": kres["history"]["loss"][-1].tolist(),
           "final_acc": kres["history"]["acc"][-1].tolist(),
           **training_deviation(label, kres, rres, train),
           **compare_episodes(label, kres, rres, net.period_s, must_finish,
                              auction=auction,
                              f_at=f_at_own_b(sets, kres["history"]["b"]))}
    emit({"phase": "cotrain", **row})
    return row


def _bitwise(label: str, got, want) -> None:
    """Every array of two results (nested dicts and lists) equal bit for
    bit."""
    if isinstance(want, dict):
        for key in want:
            _bitwise(f"{label}/{key}", got[key], want[key])
    elif isinstance(want, np.ndarray):
        if not np.array_equal(got, want, equal_nan=want.dtype.kind == "f"):
            raise AssertionError(f"{label} differs")
    elif got != want:
        raise AssertionError(f"{label} differs: {got} and {want}")


def cotrain_engines() -> dict:
    """At BENCH_cotrain's setting: one seed's warm coop co-trained episode
    on the card and on the CPU; run_cotrain_batch over COTRAIN_SEEDS
    against run_cotrain_fleet at chunk 2; run_fleet over FLEET_SEEDS at
    FLEET_CHUNK against run_batch (warm coop on "megakernel"); the legacy
    run against run_scan, and resumed from its period-2 snapshot against
    itself uninterrupted."""
    from repro_torch.fl import cotrain, simulator

    cfg_kw, net, train = cotrain_setting()
    out = {}
    warm_ref = simulator.SimConfig(**cfg_kw, policy="coop", warm_start=True,
                                   seed=SEEDED_SEED)
    (card, card_s, _, _), (cpu, cpu_s, _, _) = (
        cotrain_run(warm_ref, train, net, device=dev)
        for dev in (DEVICE, "cpu"))
    out["card_vs_cpu"] = {
        "case": f"cotrain coop-warm-reference/seed {SEEDED_SEED}",
        "periods": card["periods"], "card_s": card_s, "cpu_s": cpu_s,
        "durations_equal": card["durations"] == cpu["durations"],
        **training_deviation("cotrain card vs cpu", card, cpu, train),
        **compare_episodes("cotrain card vs cpu", card, cpu, net.period_s,
                           must_finish=True)}

    warm = simulator.SimConfig(**cfg_kw, policy="coop", warm_start=True,
                               intra_backend="megakernel")
    t0 = time.perf_counter()
    batch = cotrain.run_cotrain_batch(warm, train, COTRAIN_SEEDS, net,
                                      device=DEVICE)
    t1 = time.perf_counter()
    fleet = cotrain.run_cotrain_fleet(warm, train, COTRAIN_SEEDS, net,
                                      chunk_size=2, device=DEVICE)
    t2 = time.perf_counter()
    _bitwise("run_cotrain_fleet vs run_cotrain_batch",
             {k: v for k, v in fleet.items() if k != "fleet"}, batch)
    out["cotrain_fleet"] = {"seeds": list(COTRAIN_SEEDS),
                            "periods": batch["periods"].tolist(),
                            "batch_s": t1 - t0, "fleet_s": t2 - t1,
                            "fleet": fleet["fleet"], "bitwise": True}

    t0 = time.perf_counter()
    batch = simulator.run_batch(warm, list(FLEET_SEEDS), net, device=DEVICE)
    t1 = time.perf_counter()
    fleet = simulator.run_fleet(warm, FLEET_SEEDS, net,
                                chunk_size=FLEET_CHUNK, device=DEVICE)
    t2 = time.perf_counter()
    _bitwise("run_fleet vs run_batch",
             {k: v for k, v in fleet.items() if k != "fleet"}, batch)
    out["run_fleet"] = {"seeds": list(FLEET_SEEDS), "batch_s": t1 - t0,
                        "fleet_s": t2 - t1, "fleet": fleet["fleet"],
                        "bitwise": True}

    scan = simulator.run_scan(warm, net, device=DEVICE)
    t0 = time.perf_counter()
    full = simulator.run(warm, net, device=DEVICE)
    t1 = time.perf_counter()
    path = ROOT / "build" / "legacy_run.json"
    path.unlink(missing_ok=True)
    simulator.run(dataclasses.replace(warm, max_periods=2), net,
                  checkpoint_path=str(path), device=DEVICE)
    snap = json.loads(path.read_text())
    resumed = simulator.run(warm, net, state=snap, device=DEVICE)
    if full["durations"] != scan["durations"]:
        raise AssertionError(f"legacy run: durations {full['durations']}, "
                             f"run_scan's {scan['durations']}")
    if resumed["durations"] != full["durations"] or (
            resumed["state"] != full["state"]):
        raise AssertionError("legacy run: the resumed run differs from "
                             "the uninterrupted one")
    out["legacy_run"] = {"periods": full["periods"], "run_s": t1 - t0,
                         "durations_equal_run_scan": True,
                         "resumed_from_period": snap["period"],
                         "resume_equal": True,
                         "draw_stream": snap["draw_stream"]}
    emit({"phase": "cotrain_engines", **out})
    return out


def cotrain_phase() -> dict:
    """Slice 9's path: co-trained episodes at BENCH_cotrain's setting
    (COTRAIN_CASES) and at the paper's (COTRAIN_PAPER_CASES), then the
    engines (cotrain_engines)."""
    from repro_torch.fl import simulator

    cfg_kw, net, train = cotrain_setting()
    # warm-up, untimed: the first vmapped grad steps on the card set up
    # cuBLAS and the batching rules (~8 s)
    cotrain_run(simulator.SimConfig(**{**cfg_kw, "max_periods": 4},
                                    policy="coop", warm_start=True,
                                    intra_backend="megakernel"), train, net)
    rows = []
    for pol, warm, backend in COTRAIN_CASES:
        rows.append(cotrain_pair(
            f"cotrain-bench-{pol}{'-warm' if warm else ''}-{backend}",
            dict(cfg_kw, policy=pol, warm_start=warm, intra_backend=backend),
            net, train, must_finish=True))
    paper = simulator.SimConfig(**PAPER, **COTRAIN_PAPER)
    for pol, warm, backend in COTRAIN_PAPER_CASES:
        rows.append(cotrain_pair(
            f"cotrain-paper-{pol}{'-warm' if warm else ''}-{backend}",
            dict(PAPER, **COTRAIN_PAPER, policy=pol, warm_start=warm,
                 intra_backend=backend),
            simulator._default_net(paper), train,
            must_finish=COTRAIN_PAPER.get("max_periods") is None))
    return {"episodes": rows, **cotrain_engines()}


# ---------------------------------------------------------------------------
# Slice 10: the live allocation daemon (allocd), its chaos drills, and
# Byzantine clients in co-training.
# ---------------------------------------------------------------------------

# The paper's network (NetworkConfig(): B = 10 MHz, T = 20 s) at K = 45
# (simulator._k_cap of the paper's SimConfig), 40 ticks of Poisson(0.5)
# admissions (poisson_admissions on default_rng(0)).
ALLOCD_PAPER = dict(capacity=16, k_max=45, rounds_required=400)
ALLOCD_TICKS, ALLOCD_RATE = 40, 0.5
ALLOCD_CASES = (("coop", True, "megakernel"), ("coop", True, "pallas"),
                ("selfish", False, "pallas"), ("es", False, "pallas"))
ALLOCD_MARKET_TICKS = 10
ALLOCD_MARKET_CASES = (("coop", True, "megakernel"),
                       ("selfish", False, "pallas"))
# benchmarks/bench_fault.py:44-46 (its full plan) and :49-55 (the storm's
# config), on the kernel backends.
STORM = dict(capacities=(16, 64, 256), periods=40, k_max=16,
             rounds_required=400, seed=42, save_every=5)
STORM_BACKENDS = ("megakernel", "pallas")
# benchmarks/bench_robust.py:68-85, warm coop on "megakernel".
ROBUST_SIM = dict(policy="coop", warm_start=True, n_services_total=2,
                  rounds_required=40, p_arrive=2.0, max_periods=60, k_max=12,
                  mean_clients=9.0, var_clients=1.0)
ROBUST_NET = dict(period_s=1.0, mean_clients=9.0, var_clients=1.0)
ROBUST_TRAIN = dict(vocab=16, seq_len=6, batch_size=2, eval_batch=32,
                    rounds_cap=3)
ROBUST_ATTACKS = ("sign_flip", "nan")
ROBUST_AGGREGATORS = ("fedavg", "trimmed_mean", "median", "krum")
ROBUST_ATTACK = dict(byz_frac=0.2, scale=20.0, seed=1)
ROBUST_OPTIONS = dict(trim_frac=0.25, byz_f=3)
CARD_CPU_LOSS_ATOL = 1e-5
# The CLI at its defaults but the capacity: 40 periods of Poisson(0.5)
# admit 19 services, and in the default 16 slots the 17th reuses a freed
# slot, which no single run_scan episode replays (the JAX package's CLI
# prints "trace not replayable" at the defaults too).
ALLOCD_CLI = ("--periods", "40", "--check", "--capacity", "24")
ALLOCD_KERNELS = COTRAIN_KERNELS


async def _serve_ticks(daemon, workload: dict, n_ticks: int,
                       prefix: dict, tick_s: list) -> None:
    """allocd's workload loop, keeping in ``prefix`` the last trace that
    still replayed as one run_scan episode, and each tick's seconds."""
    for p in range(n_ticks):
        for req in workload.get(p, ()):
            daemon.submit(req)
        if daemon.plane.replayable:
            prefix.update(period=daemon.plane.period,
                          trace=daemon.plane.trace())
        t0 = time.perf_counter()
        await daemon.step_period()
        tick_s.append(time.perf_counter() - t0)
    await daemon.close()


def daemon_run(cfg, net, workload: dict, n_ticks: int, device=None) -> dict:
    """One daemon serving ``workload`` for ``n_ticks`` ticks (asyncio loop,
    solves in the executor thread), with its seconds, launches by kernel,
    the seconds each tick spent drawing its period inline, and the longest
    replayable prefix of its trace."""
    import asyncio

    from repro_torch.kernels import ops
    from repro_torch.launch import allocd

    device = device or DEVICE
    daemon = allocd.AllocDaemon(cfg, net, device=device)
    draw_s, tick_s, prefix = [], [], {}
    inner = daemon.plane._draws

    def timed_draws(period):
        t0 = time.perf_counter()
        out = inner(period)
        draw_s.append(time.perf_counter() - t0)
        return out

    daemon.plane._draws = timed_draws
    before = dict(ops.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    asyncio.run(_serve_ticks(daemon, workload, n_ticks, prefix, tick_s))
    _sync(device)
    return {"daemon": daemon, "seconds": time.perf_counter() - t0,
            "tick_s": tick_s, "draw_s": draw_s, "prefix": prefix,
            "launches": {name: ops.LAUNCHES[name] - before[name]
                         for name in ops.LAUNCHES}}


def replay_check(label: str, run: dict) -> dict:
    """The daemon's fresh stream against run_scan on its trace, on its
    device, bit for bit: invariants._check_replay where the whole trace
    replays, else the longest replayable prefix (the ticks before the
    first slot reuse) the same way.  Returns run_scan's rate on it."""
    from repro_torch.chaos import invariants
    from repro_torch.fl import simulator

    plane = run["daemon"].plane
    _sync(plane.device)
    t0 = time.perf_counter()
    if plane.replayable:
        res = invariants._check_replay(plane)
        periods = plane.period
    else:
        periods, (arrivals, counts) = (run["prefix"]["period"],
                                       run["prefix"]["trace"])
        cfg = dataclasses.replace(plane.replay_sim_config(),
                                  max_periods=max(periods, 1))
        hist = simulator.run_scan(cfg, plane.net, arrivals=arrivals,
                                  counts=counts,
                                  device=plane.device)["history"]
        done = [d for d in plane.decisions if d.period < len(hist["b"])]
        bad = [d.period for d in done if not all(
            np.array_equal(getattr(d, key), hist[key][d.period])
            for key in ("b", "f", "active"))]
        res = {"ok": not bad, "skipped": False, "checked": len(done),
               "mismatch_periods": bad[:10]}
        periods = len(hist["b"])
    _sync(plane.device)
    sec = time.perf_counter() - t0
    if not res["ok"] or res["skipped"] or not res["checked"]:
        raise AssertionError(f"{label}: the daemon's stream does not "
                             f"replay through run_scan: {res}")
    return {"replay_bitwise_ticks": res["checked"],
            "replay_whole_trace": plane.replayable,
            "unreplayable_reasons": plane.unreplayable_reasons,
            "run_scan_periods_per_s": periods / sec}


def daemon_episode(run: dict, period_s: float) -> dict:
    """A daemon's served stream in compare_episodes's terms: b, f and
    activity per tick, the rounds floor(f T) the tick granted, and per
    slot the ticks it was active."""
    daemon = run["daemon"]
    served = daemon.served
    f = np.stack([d.f for d in served])
    active = np.stack([d.active for d in served])
    return {"periods": len(served), "finished": True,
            "fallbacks": daemon.plane.metrics["solver_fallbacks"],
            "durations": active.sum(axis=0).tolist(),
            "history": {"b": np.stack([d.b for d in served]), "f": f,
                        "active": active,
                        "rounds": np.maximum(np.floor(
                            np.float32(period_s) * f), 0).astype(np.int32)}}


def _retired(run: dict) -> list:
    return [(r.service_id, r.slot, r.retired_period)
            for r in run["daemon"].plane.retired]


def _rates(run: dict) -> dict:
    ticks = len(run["tick_s"])
    return {"ticks_per_s": ticks / run["seconds"],
            "steady_ticks_per_s": (ticks - 1) / sum(run["tick_s"][1:]),
            "tick_ms_median": 1e3 * float(np.median(run["tick_s"])),
            "first_tick_ms": 1e3 * run["tick_s"][0],
            "draw_ms_median": 1e3 * float(np.median(run["draw_s"])),
            "launches_per_tick": {name: n / ticks for name, n in
                                  run["launches"].items() if n}}


def allocd_paper_case(policy: str, warm: bool, backend: str) -> dict:
    """The daemon at the paper's network on a kernel backend and on
    "reference" on the card (served streams held by compare_episodes,
    completions equal), its replay through run_scan, and for warm coop on
    "megakernel" the same daemon on the CPU."""
    from repro_torch.core import network
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    label = f"allocd-paper-{policy}{'-warm' if warm else ''}-{backend}"
    net = network.NetworkConfig()
    workload = allocd.poisson_admissions(
        np.random.default_rng(0), ALLOCD_RATE, ALLOCD_TICKS,
        ALLOCD_PAPER["k_max"])
    auction = policy == "selfish"
    runs, sets = {}, []
    for bk in (backend, "reference"):
        cfg = control_plane.ControlPlaneConfig(
            **ALLOCD_PAPER, policy=policy, warm_start=warm, intra_backend=bk)
        record = (recording_sets(policy, sets) if auction and bk == backend
                  else contextlib.nullcontext())
        with record:
            # the step caches its policy: build it inside the recording
            control_plane._serve_step.cache_clear()
            runs[bk] = daemon_run(cfg, net, workload, ALLOCD_TICKS)
        control_plane._serve_step.cache_clear()
    kern, ref = runs[backend], runs["reference"]
    _check_launches(label, backend, (policy, warm, backend),
                    kern["launches"], ref["launches"])
    got = daemon_episode(kern, net.period_s)
    row = {"case": label, "ticks": ALLOCD_TICKS,
           "admitted": kern["daemon"].plane.metrics["admitted"],
           **_rates(kern),
           "reference_ticks_per_s": ALLOCD_TICKS / ref["seconds"],
           "launches": kern["launches"],
           **replay_check(label, kern),
           **compare_episodes(label, got, daemon_episode(ref, net.period_s),
                              net.period_s, must_finish=False,
                              auction=auction,
                              f_at=f_at_own_b(sets, got["history"]["b"]))}
    row["daemon_over_run_scan"] = (row["ticks_per_s"]
                                   / row["run_scan_periods_per_s"])
    row["retired_equal"] = _retired(kern) == _retired(ref)
    if not row["retired_equal"] and not row["round_flips"]:
        raise AssertionError(f"{label}: services completed at other ticks "
                             f"than on \"reference\" with no round flip")
    if (policy, warm, backend) == ("coop", True, "megakernel"):
        cpu = daemon_run(runs[backend]["daemon"].plane.cfg, net, workload,
                         ALLOCD_TICKS, device="cpu")
        row["card_vs_cpu"] = {
            "cpu_ticks_per_s": ALLOCD_TICKS / cpu["seconds"],
            **compare_episodes(f"{label} card vs cpu", got,
                               daemon_episode(cpu, net.period_s),
                               net.period_s, must_finish=False)}
    emit({"phase": "allocd", **row})
    return row


def allocd_market_case(policy: str, warm: bool, backend: str) -> dict:
    """The daemon at market capacity: MARKET_N services admitted at tick 0
    (market_setting's client counts and 1 MHz a service), 10 ticks; its
    replay through run_scan bitwise, ticks/s against run_scan's periods/s
    on the same trace, and the ms a tick spends drawing its period."""
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    label = f"allocd-market{MARKET_N}-{policy}{'-warm' if warm else ''}" \
            f"-{backend}"
    net, _, counts = market_setting()
    cfg = control_plane.ControlPlaneConfig(
        capacity=MARKET_N, k_max=45, rounds_required=100, policy=policy,
        warm_start=warm, intra_backend=backend)
    workload = {0: [allocd.Admit(i, int(c)) for i, c in enumerate(counts)]}
    run = daemon_run(cfg, net, workload, ALLOCD_MARKET_TICKS)
    missing = [name for name in EXPECTED[policy, warm, backend]
               if not run["launches"][name]]
    if missing:
        raise AssertionError(f"{label}: never launched {missing}")
    row = {"case": label, "ticks": ALLOCD_MARKET_TICKS, **_rates(run),
           "launches": run["launches"],
           "retired": run["daemon"].plane.metrics["retired"],
           **replay_check(label, run)}
    row["daemon_over_run_scan"] = (row["ticks_per_s"]
                                   / row["run_scan_periods_per_s"])
    emit({"phase": "allocd", **row})
    return row


@contextlib.contextmanager
def probing_poisoned_ticks(probes: list):
    """Within the block, every plane built through ``allocd`` runs each
    tick whose carry holds a non-finite value (a chaos poisoning) through
    the same period step on "reference" too, on copies of the same inputs,
    and appends the comparison to ``probes``: the rescue counts, the
    carry's non-finite entries and where b and f are finite must agree,
    and b and f within tolerance there (raises beyond)."""
    from repro_torch import scenarios, tree
    from repro_torch.core import policy as policy_mod
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    def rescues(pol_state) -> int:
        return (int(pol_state.fallbacks)
                if isinstance(pol_state, policy_mod.WarmDualState) else 0)

    class ProbedPlane(control_plane.ControlPlane):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, **kwargs)
            inner = self._step
            ref_step = control_plane._serve_step(
                cfg.policy, cfg.n_bids, cfg.alpha_fair, "reference",
                cfg.warm_start, self.net, cfg.rounds_required,
                scenarios.as_spec(cfg.channel_process, "iid"),
                scenarios.as_spec(cfg.churn_process, "none"))[0]

            def step(*args):
                floats = [x for x in tree.leaves(args[:5])
                          if x.is_floating_point()]
                if all(bool(torch.isfinite(x).all()) for x in floats):
                    return inner(*args)
                copy = tree.tree_map(
                    lambda x: x.clone() if torch.is_tensor(x) else x,
                    list(args))
                out = inner(*args)
                want = ref_step(*copy)
                label = f"poisoned tick {args[5]} ({cfg.intra_backend})"
                got_fb, want_fb = rescues(out[4]), rescues(want[4])
                bad = [sum(int((~torch.isfinite(x)).sum()) for x in
                           tree.leaves(o[:5]) if x.is_floating_point())
                       for o in (out, want)]
                if got_fb != want_fb or bad[0] != bad[1]:
                    raise AssertionError(
                        f"{label}: rescues {got_fb} / {want_fb}, non-finite "
                        f"carry entries {bad[0]} / {bad[1]}")
                row = {"period": int(args[5]), "policy": cfg.policy,
                       "backend": cfg.intra_backend, "fallbacks": got_fb,
                       "carry_nonfinite": bad[0]}
                for key in ("b", "f"):
                    g, w = out[6][key].cpu(), want[6][key].cpu()
                    fin = torch.isfinite(w)
                    if not torch.equal(torch.isfinite(g), fin):
                        raise AssertionError(f"{label}: {key} non-finite "
                                             f"at other entries")
                    row[key] = (check_close(label, g[fin], w[fin],
                                            key)["max_dev"]
                                if fin.any() else None)
                    row[f"{key}_nonfinite"] = int((~fin).sum())
                probes.append(row)
                return out

            self._step = step

    real = allocd.ControlPlane
    allocd.ControlPlane = ProbedPlane
    try:
        yield probes
    finally:
        allocd.ControlPlane = real


@contextlib.contextmanager
def keeping_engines(engines: list):
    """Within the block, every chaos engine a storm builds is appended to
    ``engines`` (its served stream, for tracing a divergence)."""
    from repro_torch.chaos import engine as engine_mod

    real = engine_mod.ChaosEngine

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    engine_mod.ChaosEngine = Kept
    try:
        yield engines
    finally:
        engine_mod.ChaosEngine = real


POISON_CASES = (("coop", True, "megakernel"), ("coop", True, "pallas"),
                ("es", False, "pallas"), ("selfish", False, "pallas"))


def poison_drill() -> list:
    """Non-finite inputs on the card, where they reach the kernels: a plane
    at the paper's network with every slot admitted at its full cohort
    (so every channel entry is an active client) ticks, is poisoned as
    SolverChaos poisons (a channel-state entry, for warm coop also the warm
    seed, at NaN, +Inf and -Inf), and ticks twice more: each poisoned tick
    is probed against "reference" on its inputs (probing_poisoned_ticks),
    the decisions served are finite, and the plane's counters equal those
    of the same drill on "reference"."""
    from repro_torch.chaos import injectors
    from repro_torch.core import network
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    rows = []
    for policy, warm, backend in POISON_CASES:
        for poison in ("channel", "seed") if warm else ("channel",):
            for value in (float("nan"), float("inf"), float("-inf")):
                metrics, probes = {}, []
                for bk in (backend, "reference"):
                    cfg = control_plane.ControlPlaneConfig(
                        capacity=16, k_max=45, rounds_required=100_000,
                        policy=policy, warm_start=warm, intra_backend=bk,
                        channel_process="gauss_markov")
                    with probing_poisoned_ticks(probes if bk == backend
                                                else []):
                        plane = allocd.ControlPlane(
                            cfg, network.NetworkConfig(), device=DEVICE)
                        for i in range(cfg.capacity):
                            plane.admit(i, cfg.k_max)
                        plane.tick()
                        if poison == "seed":
                            ev = injectors.poison_warm_seed(plane, None,
                                                            value=value)
                        else:
                            ev = poison_value(plane, value)
                        served = [plane.tick(), plane.tick()]
                    if not all(np.isfinite(d.b).all() and np.isfinite(d.f)
                               .all() for d in served):
                        raise AssertionError(f"poison drill {policy}/{bk}: "
                                             f"a non-finite decision served")
                    metrics[bk] = dict(plane.metrics)
                label = f"poison-{policy}-{backend}-{poison}-{value}"
                if metrics[backend] != metrics["reference"] or not probes:
                    raise AssertionError(f"{label}: counters {metrics}, "
                                         f"{len(probes)} ticks probed")
                rows.append({"case": label, "event": ev,
                             "probes": probes, **{
                                 key: metrics[backend][key] for key in (
                                     "solver_fallbacks", "carry_repairs",
                                     "nonfinite_decisions",
                                     "degraded_decisions")}})
    emit({"phase": "poison_drill", "rows": rows})
    return rows


def zero_load_drill() -> list:
    """Clients with no transmission load (alpha = 0: an infinite rate, as
    a path loss poisoned to -inf dB gives) stay clients on the card: in
    ten sampled services at K = 45, service 0 wholly (``all``), or in
    every service the slowest client, its t^C raised 50-fold so that it
    alone sets max t^C and the round time (``slowest``).  Each policy of
    POISON_CASES and cold coop on "pallas" and "megakernel" (B1-B4 take a
    row's clients from the set's mask) against "reference" on the same
    inputs: b and f within tolerance."""
    from repro_torch.core import network, policy

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    base, _ = network.sample_services(gen, 10, k_max=45)
    rows = []
    for case in ("all", "slowest"):
        alpha, t_comp = base.alpha.clone(), base.t_comp.clone()
        if case == "all":
            alpha[0] = 0.0
        else:
            tc = torch.where(base.mask, t_comp, -torch.inf)
            idx = torch.argmax(tc, dim=1)
            rows_i = torch.arange(alpha.shape[0], device=DEVICE)
            alpha[rows_i, idx] = 0.0
            t_comp[rows_i, idx] *= 50.0
        svc = base._replace(alpha=alpha, t_comp=t_comp)
        for name, warm in sorted({(p, w) for p, w, _ in POISON_CASES}
                                 | {("coop", False)}):
            out = {}
            for backend in ("reference", "pallas", "megakernel"):
                pol = policy.get_stateful_policy(
                    name, warm_start=warm, intra_backend=backend)
                out[backend] = pol.step(svc, B_TOTAL,
                                        pol.init_state(10, device=DEVICE))
            label = f"zero_load-{case}-{name}{'-warm' if warm else ''}"
            devs = {}
            for backend in ("pallas", "megakernel"):
                got, want = out[backend], out["reference"]
                devs[backend] = {
                    "b": check_close(f"{label}/{backend}", got[0], want[0],
                                     "b")["max_dev"],
                    "f": check_close(f"{label}/{backend}", got[1], want[1],
                                     "f")["max_dev"]}
            rows.append({"case": label, "max_dev": devs})
    emit({"phase": "zero_load_drill", "rows": rows})
    return rows


def poison_value(plane, value: float) -> dict:
    """poison_channel_state's write, at a given value: the first float leaf
    of the channel state, entry 0 (an active client's here)."""
    from repro_torch import tree

    carry = list(plane._carry)
    leaves = tree.leaves(carry[2])
    leaf = leaves[0].clone()
    leaf.view(-1)[0] = value
    carry[2] = tree.unflatten(carry[2], [leaf] + leaves[1:])
    plane._carry = tuple(carry)
    return {"action": "poison_channel", "leaf": 0, "index": 0,
            "value": repr(value)}


def storm_once(capacity: int, backend: str, probes: list | None = None):
    """One bench_fault storm on the card: (report, engine, seconds)."""
    import tempfile

    from repro_torch import chaos
    from repro_torch.fl import control_plane

    cfg = control_plane.ControlPlaneConfig(
        capacity=capacity, k_max=STORM["k_max"], policy="coop",
        warm_start=True, rounds_required=STORM["rounds_required"],
        channel_process="gauss_markov", heartbeat_timeout_periods=2, seed=0,
        intra_backend=backend)
    engines = []
    probe = (probing_poisoned_ticks(probes) if probes is not None
             else contextlib.nullcontext())
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt, probe, \
            keeping_engines(engines):
        _sync(DEVICE)
        t0 = time.perf_counter()
        report = chaos.run_storm(cfg, seed=STORM["seed"],
                                 n_periods=STORM["periods"],
                                 checkpoint_dir=ckpt,
                                 save_every=STORM["save_every"],
                                 max_stale_streak=4, device=DEVICE)
        _sync(DEVICE)
    return report, engines[0], time.perf_counter() - t0


def trajectory_against(label: str, got, want, period_s: float) -> dict:
    """A kernel storm's event trajectory against the "reference" storm's:
    equal, or the first divergence with the one-round flip before it that
    explains it (raises when no flip does)."""
    (report, engine), (ref_report, ref_engine) = got, want
    if report["events"] == ref_report["events"]:
        return {"trajectory_equal_reference": True}
    events = (report["events"], ref_report["events"])
    first = next((i for i, (a, b) in enumerate(zip(*events)) if a != b),
                 min(map(len, events)))
    period = min(ev[first]["period"] for ev in events if first < len(ev))
    flips = []
    for t, (d, r) in enumerate(zip(engine.served[:period + 1],
                                   ref_engine.served[:period + 1])):
        a = np.float32(period_s) * d.f
        b = np.float32(period_s) * r.f
        for slot in np.flatnonzero(np.floor(a) != np.floor(b)):
            flips.append({"tick": t, "slot": int(slot),
                          "fT_kernel": float(a[slot]),
                          "fT_reference": float(b[slot])})
    if not flips or any(abs(np.floor(f["fT_kernel"])
                            - np.floor(f["fT_reference"])) != 1
                        for f in flips):
        raise AssertionError(f"{label}: the trajectory leaves the "
                             f"reference's at event {first} (period "
                             f"{period}) with no one-round flip before it")
    return {"trajectory_equal_reference": False, "first_divergence":
            {"event": first, "period": period}, "round_flips": flips}


def storm_phase() -> list:
    """bench_fault's full plan on the card: per capacity the storm on
    "reference" and, per kernel backend, twice (equal digests; the first
    run's poisoned ticks probed against "reference"), every invariant ok,
    the trajectory against the reference's."""
    rows = []
    for capacity in STORM["capacities"]:
        ref_report, ref_engine, ref_s = storm_once(capacity, "reference")
        for backend in STORM_BACKENDS:
            probes = []
            r1, e1, s1 = storm_once(capacity, backend, probes)
            r2, _, s2 = storm_once(capacity, backend)
            label = f"storm-{capacity}-{backend}"
            failed = [k for k, v in r1["invariants"].items() if not v["ok"]]
            if failed or r1["digest"] != r2["digest"]:
                raise AssertionError(f"{label}: invariants failed {failed}, "
                                     f"digests {r1['digest']} / "
                                     f"{r2['digest']}")
            poisoned = sum(e["action"].startswith("poison")
                           for e in r1["events"])
            m = r1["metrics"]
            row = {"case": label, "capacity": capacity, "backend": backend,
                   "periods": STORM["periods"], "seconds": [s1, s2],
                   "reference_seconds": ref_s, "digest": r1["digest"],
                   "digest_repeat_equal": True, "n_events": r1["n_events"],
                   "restarts": r1["restarts"], "served": r1["served"],
                   "decisions_lost": r1["decisions_lost"],
                   "recovery": r1["recovery"],
                   **{key: m[key] for key in (
                       "solver_fallbacks", "nonfinite_decisions",
                       "carry_repairs", "checkpoint_skips", "admit_retries",
                       "heartbeat_drops", "stale_decisions",
                       "degraded_decisions")},
                   "reference_metrics": ref_report["metrics"],
                   "invariants_ok": True, "replay": r1["invariants"][
                       "replay"],
                   "poison_events": poisoned, "poisoned_ticks": probes,
                   **trajectory_against(label, (r1, e1),
                                        (ref_report, ref_engine),
                                        e1.daemon.plane.net.period_s)}
            emit({"phase": "storm", **row})
            rows.append(row)
    return rows


def robust_phase() -> list:
    """bench_robust's Byzantine co-training on the card: warm coop on
    "megakernel" and "reference" and on the CPU, under sign_flip and nan
    at 20% with each aggregator: durations those of the unattacked
    episode, training bitwise alike on both backends, card against CPU
    loss within CARD_CPU_LOSS_ATOL, finite tables from every robust
    aggregator under nan."""
    from repro_torch.chaos import AttackSpec, invariants
    from repro_torch.core import network
    from repro_torch.fl import cotrain, simulator

    net = network.NetworkConfig(**ROBUST_NET)
    train = cotrain.TrainSpec(**ROBUST_TRAIN)
    cfg = simulator.SimConfig(**ROBUST_SIM, intra_backend="megakernel")
    clean = cotrain.run_cotrain_scan(cfg, train, net, device=DEVICE)
    plain = simulator.run_scan(cfg, net, device=DEVICE)
    if clean["durations"] != plain["durations"]:
        raise AssertionError("robust: the clean co-trained durations differ "
                             "from run_scan's")
    rows = []
    for attack in ROBUST_ATTACKS:
        spec_atk = AttackSpec(attack=attack, **ROBUST_ATTACK)
        for aggregator in ROBUST_AGGREGATORS:
            label = f"robust-{attack}-{aggregator}"
            spec = dataclasses.replace(train, aggregator=aggregator,
                                       **ROBUST_OPTIONS)
            runs = {}
            for name, bk, dev in (("card", "megakernel", DEVICE),
                                  ("card_reference", "reference", DEVICE),
                                  ("cpu", "megakernel", "cpu")):
                _sync(DEVICE)
                t0 = time.perf_counter()
                runs[name] = cotrain.run_cotrain_scan(
                    dataclasses.replace(cfg, intra_backend=bk), spec, net,
                    device=dev, attack=spec_atk)
                _sync(DEVICE)
                runs[name]["seconds"] = time.perf_counter() - t0
            got = runs["card"]
            for name, res in runs.items():
                if res["durations"] != clean["durations"]:
                    raise AssertionError(f"{label}/{name}: the attack moved "
                                         f"the durations")
            training = ("loss", "acc", "train_loss", "trained",
                        "participants")
            _bitwise(f"{label} megakernel vs reference",
                     {"history": {k: got["history"][k] for k in training},
                      "params": got["params"]},
                     {"history": {k: runs["card_reference"]["history"][k]
                                  for k in training},
                      "params": runs["card_reference"]["params"]})
            loss_dev = np.abs(got["history"]["loss"].astype(np.float64)
                              - runs["cpu"]["history"]["loss"])
            nan_same = np.array_equal(np.isnan(got["history"]["loss"]),
                                      np.isnan(runs["cpu"]["history"]["loss"]))
            loss_dev = float(np.nanmax(loss_dev)) if np.isfinite(
                loss_dev).any() else 0.0
            if not nan_same or loss_dev > CARD_CPU_LOSS_ATOL:
                raise AssertionError(f"{label}: card against CPU loss off by "
                                     f"{loss_dev} (NaN where the CPU's is: "
                                     f"{nan_same})")
            finite = invariants.params_finite(got["params"])["ok"]
            if attack == "nan" and aggregator != "fedavg" and not finite:
                raise AssertionError(f"{label}: a robust aggregator served "
                                     f"non-finite tables")
            acc = got["history"]["acc"][got["periods"] - 1]
            row = {"case": label, "periods": got["periods"],
                   "card_s": got["seconds"],
                   "reference_s": runs["card_reference"]["seconds"],
                   "cpu_s": runs["cpu"]["seconds"],
                   "durations_equal_clean": True,
                   "training_bitwise_megakernel_reference": True,
                   "card_cpu_loss_max_dev": loss_dev,
                   "params_finite": finite,
                   "final_acc": float(np.mean(acc)),
                   "clean_final_acc": float(np.mean(
                       clean["history"]["acc"][clean["periods"] - 1]))}
            emit({"phase": "robust", **row})
            rows.append(row)
    return rows


def allocd_phase() -> dict:
    """Slice 10's path: the daemon at the paper's network (ALLOCD_CASES)
    and at market capacity (ALLOCD_MARKET_CASES), the chaos storms, the
    Byzantine co-training, and the CLI's replay check."""
    from repro_torch.core import network
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    # warm-up, untimed: the first asyncio loop and executor thread
    daemon_run(control_plane.ControlPlaneConfig(
        **ALLOCD_PAPER, intra_backend="megakernel"), network.NetworkConfig(),
        {0: [allocd.Admit("w", 8)]}, 3)
    out = {"paper": [allocd_paper_case(*case) for case in ALLOCD_CASES],
           "market": [allocd_market_case(*case)
                      for case in ALLOCD_MARKET_CASES],
           "poison": poison_drill(), "zero_load": zero_load_drill(),
           "storms": storm_phase(),
           "robust": robust_phase()}
    t0 = time.perf_counter()
    cli = allocd.main([*ALLOCD_CLI, "--device", DEVICE])
    if not (cli.get("replay") or {}).get("bitwise"):
        raise AssertionError(f"allocd CLI: replay check failed: {cli}")
    out["cli"] = {"argv": [*ALLOCD_CLI, "--device", DEVICE], "seconds":
                  time.perf_counter() - t0, **cli}
    emit({"phase": "allocd_cli", **out["cli"]})
    return out


# ---------------------------------------------------------------------------
# C8: a partly poisoned row, rescued without the poisoned client.
# ---------------------------------------------------------------------------

def one_client_poison() -> dict:
    """The Table-1 set (table1_service_set(0), B = 10 MHz) with alpha[1, 0]
    = NaN: on every demand backend the warm solver flags the rescue, and
    its b, f and lam equal bit for bit the cold bisection on the card of
    the set with that client dropped (types.mask_clients)."""
    from repro_torch.core import disba, network
    from repro_torch.core.types import ServiceSet, mask_clients

    svc, _ = network.table1_service_set(0)
    svc = ServiceSet(*(x.to(DEVICE) for x in svc[:3]))
    alpha = svc.alpha.clone()
    alpha[1, 0] = float("nan")
    svc = svc._replace(alpha=alpha)
    want = disba.solve_lambda_bisect(
        mask_clients(svc, torch.isfinite(svc.alpha)
                     & torch.isfinite(svc.t_comp)), B_TOTAL)
    rows = []
    for backend in disba.DEMAND_BACKENDS:
        res = disba.solve_lambda_newton_warm(svc, B_TOTAL, disba.WARM_COLD,
                                             backend=backend)
        bitwise = {key: bool(torch.equal(getattr(res, key),
                                         getattr(want, key)))
                   for key in ("b", "f", "lam")}
        if not bool(res.fallback) or not all(bitwise.values()):
            raise AssertionError(
                f"one_client_poison/{backend}: fallback {bool(res.fallback)}"
                f", bitwise {bitwise}: b {res.b.tolist()} against the "
                f"dropped-client solve's {want.b.tolist()}")
        rows.append({"backend": backend, "fallback": True,
                     "bitwise": bitwise, "b": res.b.tolist()})
    out = {"dropped_b": want.b.tolist(), "rows": rows}
    emit({"phase": "one_client_poison", **out})
    return out


# ---------------------------------------------------------------------------
# Slice 11: the allocation half of the distributed layer -- disba_sharded
# over torch.distributed, and fleets over ranks.
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4          # gloo ranks, all on the one card
# (method, demand backend) of disba_sharded; "newton" from 1.05 x the
# dense cold price, WARM_ITERS trips
SHARDED_SOLVES = (("newton", "pallas"), ("newton", "reference"),
                  ("bisect", "reference"))
SHARDED_SOLVE_REPS = 5
COLLECTIVE_TRIPS = 200
SHARDED_SEEDS = (0, 1, 2, 3, 4, 5)
SHARDED_CHUNK = 2
SHARDED_CASES = (("coop", True, "megakernel"), ("selfish", False, "pallas"))
# The paper's setting cut in depth: run_fleet to 40 periods (whole
# episodes run ~200), run_cotrain_fleet to 8.
SHARDED_FLEET = {"max_periods": 40}
SHARDED_COTRAIN = {"max_periods": 8}
SHARDED_KERNELS = COTRAIN_KERNELS
TOL["lam_sharded"] = (1e-3, 0.0)   # tests/test_market_clear.py:130-133
RANK_SETUP = None   # a rehearsal's hook, called first in every spawned rank
# Slice 16, in the same ranks: the model half of the distributed layer on
# a (data 2, model 2) mesh.  deepseek-v2's MoE layer at full width in
# bf16 (160 routed experts, top-6, 2 shared, capacity 1.0; fsdp off, so
# a rank holds 80 experts) over B x S = 4 x 2048 tokens (>= 8 E), and
# tests/test_distributed.py's EP setting in float32.
EP_MESH = ((2, 2), ("data", "model"))
EP = {"arch": "deepseek-v2-236b", "batch": 4, "seq": 2048, "reps": 3}
EP_TOL = 2e-2         # max |EP - generic| / max |generic|, bf16
EP_SMALL = dict(name="ep-small", family="moe", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=2, head_dim=16, d_ff=0, vocab_size=64,
                n_experts=8, n_experts_per_token=2, d_ff_expert=48,
                capacity_factor=8.0, dtype="float32")
EP_SMALL_TOL = (2e-4, 2e-5)   # rtol, atol against the dense oracle
EP_GRAD_TOL = 1e-4            # of the largest |grad| of the generic path


def sharded_solves(svc, lam_prev: float, mesh) -> dict:
    """Each SHARDED_SOLVES case of disba_sharded on this rank: its result
    (numpy), the dual_demand launches of its first call, and the median
    ms of SHARDED_SOLVE_REPS more (every rank starts each together)."""
    import torch.distributed as dist

    from repro_torch.core import disba
    from repro_torch.kernels import ops

    out = {}
    for method, backend in SHARDED_SOLVES:
        def solve():
            return disba.disba_sharded(
                mesh, svc, B_TOTAL, method=method, lam_prev=lam_prev,
                iters=disba.WARM_ITERS if method == "newton"
                else disba.BISECT_ITERS, demand_backend=backend)

        before = ops.LAUNCHES["dual_demand"]
        res = solve()
        launches = ops.LAUNCHES["dual_demand"] - before
        times = []
        for _ in range(SHARDED_SOLVE_REPS):
            _sync(DEVICE)
            if dist.is_initialized():
                dist.barrier()
            t0 = time.perf_counter()
            solve()
            _sync(DEVICE)
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"{method}-{backend}"] = {
            **{key: getattr(res, key).cpu().numpy()
               for key in ("b", "f", "lam")},
            "dual_demand_launches": launches,
            "ms": float(np.median(times))}
    return out


def collective_trip_ms(mesh) -> float:
    """ms per Newton trip's collective alone: the (demand, slope) pair's
    all-reduce over the mesh, COLLECTIVE_TRIPS in a row."""
    from repro_torch.distributed import collectives

    pair = torch.ones(2, device=DEVICE)
    for _ in range(10):
        collectives.all_reduce(pair, mesh, ("data",))
    _sync(DEVICE)
    t0 = time.perf_counter()
    for _ in range(COLLECTIVE_TRIPS):
        collectives.all_reduce(pair, mesh, ("data",))
    _sync(DEVICE)
    return 1e3 * (time.perf_counter() - t0) / COLLECTIVE_TRIPS


def sharded_configs() -> dict:
    """label -> (engine, config, TrainSpec or None) of the fleets."""
    from repro_torch.fl import cotrain, simulator

    train = cotrain.TrainSpec(**COTRAIN_TRAIN)
    out = {}
    for pol, warm, backend in SHARDED_CASES:
        kw = dict(PAPER, policy=pol, warm_start=warm, intra_backend=backend)
        label = f"{pol}{'-warm' if warm else ''}-{backend}"
        out[f"run_fleet-{label}"] = (
            "run_fleet", simulator.SimConfig(**{**kw, **SHARDED_FLEET}), None)
        out[f"run_cotrain_fleet-{label}"] = (
            "run_cotrain_fleet",
            simulator.SimConfig(**{**kw, **SHARDED_COTRAIN}), train)
    return out


def sharded_fleets(batch: bool = False) -> dict:
    """Every sharded_configs fleet over the world's ranks (mesh=None), at
    SHARDED_CHUNK over SHARDED_SEEDS: label -> (summary, seconds); with
    ``batch`` the same seeds through run_batch / run_cotrain_batch."""
    from repro_torch.fl import cotrain, simulator

    out = {}
    for label, (engine, cfg, train) in sharded_configs().items():
        net = simulator._default_net(cfg)
        seeds = list(SHARDED_SEEDS)
        _sync(DEVICE)
        t0 = time.perf_counter()
        if engine == "run_fleet":
            res = (simulator.run_batch(cfg, seeds, net, device=DEVICE)
                   if batch else simulator.run_fleet(
                       cfg, seeds, net, chunk_size=SHARDED_CHUNK,
                       device=DEVICE))
        else:
            res = (cotrain.run_cotrain_batch(cfg, train, seeds, net,
                                             device=DEVICE)
                   if batch else cotrain.run_cotrain_fleet(
                       cfg, train, seeds, net, chunk_size=SHARDED_CHUNK,
                       device=DEVICE))
        _sync(DEVICE)
        out[label] = (res, time.perf_counter() - t0)
    return out


def _sharded_rank(rank: int, world: int, run_dir: str) -> None:
    """One of SHARDED_RANKS gloo ranks on the card: the solves on its
    rows, the collective's ms a trip, the fleets; its result (or its
    traceback) pickled to run_dir/rank<r>.pkl."""
    import datetime
    import pickle
    import traceback

    import torch.distributed as dist

    global DEVICE
    path = Path(run_dir)
    try:
        with open(path / "inputs.pkl", "rb") as fh:
            inputs = pickle.load(fh)
        DEVICE = inputs["device"]
        if inputs["setup"] is not None:
            inputs["setup"]()
        torch.set_num_threads(2)
        if DEVICE == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(path / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
        try:
            from repro_torch import interop
            from repro_torch.launch import mesh as mesh_lib

            svc = interop.service_set_from_arrays(*inputs["market"],
                                                  device=DEVICE)
            mesh = mesh_lib.make_mesh((world,), ("data",))
            t0 = time.perf_counter()
            result = {"solves": sharded_solves(svc, inputs["lam_prev"], mesh),
                      "collective_trip_ms": collective_trip_ms(mesh),
                      "fleets": sharded_fleets()}
            result["seconds"] = time.perf_counter() - t0
            result["moe"] = ep_rank_part(inputs["moe_refs"])
        finally:
            dist.destroy_process_group()
        result = {"ok": True, "result": result}
    except Exception:  # reported by the parent, which raises
        result = {"ok": False, "error": traceback.format_exc()}
    with open(path / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def ep_layer():
    """(config, deepseek-v2's MoE layer in bf16, the B x S x d bf16 tokens),
    drawn on the card from seeds 0 and 1: the same on every rank and in
    the parent."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_config(EP["arch"])
    layer = moe.init_moe(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                         device=DEVICE, dtype=torch.bfloat16)
    x = torch.randn((EP["batch"], EP["seq"], cfg.d_model), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(1))
    return cfg, layer, x.to(torch.bfloat16)


def ep_references() -> dict:
    """World 1, the card alone, no mesh: the generic apply_moe of the whole
    layer on each data shard's tokens (the references of the ranks' EP
    outputs: the same per-shard capacity, so the same kept slots), and its
    ms over all B x S tokens (median of EP["reps"], CUDA events)."""
    from repro_torch.models import moe

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, layer, x = ep_layer()
    shards = EP_MESH[0][0]
    per = EP["batch"] // shards
    with torch.no_grad():
        refs = [moe.apply_moe(layer, x[i * per:(i + 1) * per], cfg)[0].cpu()
                for i in range(shards)]
        # the shards' calls above warmed the path
        generic_ms = event_ms(lambda: moe.apply_moe(layer, x, cfg),
                              reps=EP["reps"], warmup=0)
    out = {"refs": refs, "generic_ms": generic_ms,
           "layer_gb": _nbytes(layer) / 1e9,
           "generic_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del layer, x
    torch.cuda.empty_cache()
    return out


def _ep_grads(p, x, cfg) -> tuple:
    """apply_moe's output and the gradients of sum(out ** 2) with respect
    to every parameter leaf (path -> grad), under the registered mesh."""
    from repro_torch.models import moe
    from repro_torch.tree import leaves_with_names

    leaves = dict(leaves_with_names(p))
    for leaf in leaves.values():
        leaf.requires_grad_()
    out, _ = moe.apply_moe(p, x, cfg)
    (out ** 2).sum().backward()
    return out.detach(), {k: v.grad for k, v in leaves.items()}


def ep_small(mesh) -> dict:
    """(c) EP_SMALL in float32 on the card: the EP path on the whole
    values and on reshard's DTensors with FSDP on (its gathers and, in the
    backward, reduce-scatters) against the dense oracle (EP_SMALL_TOL), and
    its gradients against the generic path's at world 1 (no mesh), each
    leaf within EP_GRAD_TOL of its largest |grad| (a DTensor's local block
    against the same block).  Then api.constrain on the card: the whole
    tokens pinned to ("batch", None, None) hold this rank's data block,
    and that block pinned to no axis the whole tokens, bitwise."""
    from repro_torch.distributed import api, elastic, specs
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import tree_map

    cfg = ModelConfig(**EP_SMALL)
    gen = torch.Generator().manual_seed(0)
    base = moe.init_moe(gen, cfg, device=DEVICE)
    x = torch.randn(8, 16, cfg.d_model, generator=gen).to(DEVICE)
    dense = moe.apply_moe_dense_ref(base, x, cfg)
    _, want = _ep_grads(tree_map(torch.clone, base), x, cfg)
    rtol, atol = EP_SMALL_TOL
    rows = {}
    api.set_mesh(mesh)
    try:
        for run in ("whole", "fsdp"):
            if run == "whole":
                p, xr = tree_map(torch.clone, base), x
            else:
                p = elastic.reshard(cfg, base, mesh, fsdp=True)
                xr = specs.place(x, ("data", None, None), mesh)
            out, grads = _ep_grads(p, xr, cfg)
            ref = dense
            if run == "fsdp":       # this rank's data shard of the batch
                per = x.shape[0] // mesh.shape["data"]
                d = mesh.coordinate("data")
                out, ref = out.to_local(), dense[d * per:(d + 1) * per]
            err = (out - ref).abs()
            if not bool(torch.all(err <= atol + rtol * ref.abs())):
                raise AssertionError(f"ep small {run}: max |out - dense| "
                                     f"{float(err.max())}")
            grad_err = {}
            for path, g in grads.items():
                w = want[path]
                if run == "fsdp":
                    spec = specs.spec_of(g, mesh)
                    g, w = g.to_local(), w[specs.local_slices(
                        spec, tuple(w.shape), mesh)]
                rel = float((g - w).abs().max() / want[path].abs().max())
                if not rel <= EP_GRAD_TOL:
                    raise AssertionError(f"ep small {run} {path}: gradient "
                                         f"{rel} of the largest |grad|")
                grad_err[path] = rel
            rows[run] = {"max_abs_err": float(err.max()),
                         "grad_rel_err": max(grad_err.values())}
        split = api.constrain(specs.place(x, (), mesh), "batch", None, None)
        whole = api.constrain(split, None, None, None)
        if not (torch.equal(split.to_local(), xr.to_local())
                and torch.equal(whole.to_local(), x)):
            raise AssertionError("constrain: a block is not its slice")
        rows["constrain_bitwise"] = True
    finally:
        api.set_mesh(None)
    return rows


def ep_rank_part(refs: list) -> dict:
    """Slice 16's part of a sharded rank, on an EP_MESH mesh.  (a) Every
    rank draws deepseek-v2's MoE layer and the tokens (12.7 GB at the
    peak of a rank's draw, 51 GB for the four at once), reshards the layer
    (fsdp off) and places the tokens (split over data), checks every
    local block bitwise against its slice of the drawn tensors and frees
    them.  (b) The EP forward on the resharded layer (a DTensor
    out, this rank's data shard): max |dev| over max |out| of the generic
    layer's reference for that shard, EP_TOL.  (c) ep_small.  (d) ms of
    an EP layer and of the (T_loc, d) all-reduce over model alone
    (medians of EP["reps"], CUDA events), and the rank's peak GB."""
    import torch.distributed as dist

    from repro_torch.distributed import api, collectives, elastic, specs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.tree import leaves_with_names

    t0 = time.perf_counter()
    # a DTensor keeps its block on its mesh's device type
    mesh = mesh_lib.make_mesh(*EP_MESH, device_type=torch.device(DEVICE).type)
    marks = {"mesh": time.perf_counter()}
    torch.cuda.reset_peak_memory_stats()
    out: dict = {"coords": [mesh.coordinate(ax) for ax in mesh.axis_names]}
    cfg, full, x_full = ep_layer()
    _sync(DEVICE)
    marks["draw"] = time.perf_counter()
    placed = elastic.reshard(cfg, full, mesh, fsdp=False)
    x = specs.place(x_full, ("data", None, None), mesh)
    local, by_path = {}, {}
    whole = dict(leaves_with_names(full))
    for path, leaf in [*leaves_with_names(placed), ("x", x)]:
        src = x_full if path == "x" else whole[path]
        spec = specs.spec_of(leaf, mesh)
        block = leaf.to_local()
        if not torch.equal(block, src[specs.local_slices(
                spec, tuple(src.shape), mesh)]):
            raise AssertionError(f"reshard {path}: local block is not its "
                                 f"slice")
        local[path], by_path[path] = list(block.shape), spec
    out["reshard"] = {
        "bitwise": True, "local_shapes": local,
        "specs": {k: [v if not isinstance(v, tuple) else list(v)
                      for v in spec] for k, spec in by_path.items()},
        "local_gb": _nbytes([leaf.to_local() for _, leaf in
                             leaves_with_names(placed)]) / 1e9}
    del full, x_full, whole
    torch.cuda.empty_cache()
    dist.barrier()
    marks["reshard"] = time.perf_counter()
    experts = placed["routed"]["w_gate"].to_local().shape[0]
    if experts != cfg.n_experts // mesh.shape["model"]:
        raise AssertionError(f"a rank holds {experts} experts")

    api.set_mesh(mesh)
    try:
        with torch.no_grad():
            got, aux = moe.apply_moe(placed, x, cfg)
            got = got.to_local()
            ref = refs[mesh.coordinate("data")].to(DEVICE)
            scale = float(ref.abs().max())
            dev = float((got.float() - ref.float()).abs().max()) / scale
            if not (bool(torch.isfinite(got).all()) and dev <= EP_TOL):
                raise AssertionError(f"EP forward: max |dev| / max |out| "
                                     f"{dev}, limit {EP_TOL}")
            out["forward"] = {"rel_err": dev, "max_abs_out": scale,
                              "aux": float(aux.to_local()),
                              "shape": list(got.shape)}
            # the forward above warmed the layer and its all-reduce
            out["ep_ms"] = event_ms(lambda: moe.apply_moe(placed, x, cfg),
                                    reps=EP["reps"], warmup=0)
            flat = got.reshape(-1, got.shape[-1])
            out["all_reduce_ms"] = event_ms(
                lambda: collectives.sum_over(flat, mesh, ("model",)),
                reps=EP["reps"], warmup=0)
    finally:
        api.set_mesh(None)
    del placed, x
    torch.cuda.empty_cache()
    marks["forward"] = time.perf_counter()
    out["small"] = ep_small(mesh)
    marks["small"] = time.perf_counter()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t0
    ends = [t0, *marks.values()]
    out["part_seconds"] = {k: ends[i + 1] - ends[i]
                           for i, k in enumerate(marks)}
    return out


def check_ep_ranks(ranks: list, refs: dict) -> dict:
    """The ranks' slice-16 results: (a)-(c) were checked in the ranks
    (which raise); here every (data, model) coordinate once, the model
    ranks of a data shard alike in their EP output's deviation, and the
    line's figures."""
    coords = sorted(tuple(r["moe"]["coords"]) for r in ranks)
    want = [(d, m) for d in range(EP_MESH[0][0])
            for m in range(EP_MESH[0][1])]
    if coords != want:
        raise AssertionError(f"EP ranks at {coords}, expected {want}")
    parts = [r["moe"] for r in ranks]
    return {
        "mesh": dict(zip(EP_MESH[1], EP_MESH[0])), "arch": EP["arch"],
        "tokens": [EP["batch"], EP["seq"]], "layer_gb": refs["layer_gb"],
        "reshard": {"bitwise": all(p["reshard"]["bitwise"] for p in parts),
                    "specs": parts[0]["reshard"]["specs"],
                    "rank0_shapes": parts[0]["reshard"]["local_shapes"],
                    "local_gb": [p["reshard"]["local_gb"] for p in parts]},
        "forward": {"limit": EP_TOL,
                    "rel_err": [p["forward"]["rel_err"] for p in parts],
                    "aux": [p["forward"]["aux"] for p in parts]},
        "small": [p["small"] for p in parts],
        "ep_ms_rank0": parts[0]["ep_ms"],
        "ep_ms": [p["ep_ms"] for p in parts],
        "generic_world1_ms": refs["generic_ms"],
        "generic_world1_peak_gb": refs["generic_peak_gb"],
        "all_reduce_ms": [p["all_reduce_ms"] for p in parts],
        "peak_gb": [p["peak_gb"] for p in parts],
        "seconds": [p["seconds"] for p in parts],
        "part_seconds": [p["part_seconds"] for p in parts],
        "backend": "gloo"}


def spawn_ranks(world: int, inputs: dict, timeout: float = 300) -> list:
    """_sharded_rank on ``world`` spawned processes: their results in rank
    order.  Raises with the failing ranks' tracebacks, or if any rank is
    still running after ``timeout`` s (then it is terminated)."""
    import multiprocessing
    import pickle
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run_dir:
        with open(Path(run_dir) / "inputs.pkl", "wb") as fh:
            pickle.dump(inputs, fh)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_sharded_rank, args=(r, world, run_dir))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
        if hung:
            raise AssertionError(f"sharded ranks {hung} still running after "
                                 f"{timeout} s")
        results = []
        for rank, proc in enumerate(procs):
            path = Path(run_dir) / f"rank{rank}.pkl"
            if not path.exists():
                raise AssertionError(f"sharded rank {rank} wrote no result "
                                     f"(exit code {proc.exitcode})")
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
    errors = [r["error"] for r in results if not r["ok"]]
    if errors:
        raise AssertionError("sharded ranks failed:\n" + "\n".join(errors))
    return [r["result"] for r in results]


def check_sharded_solves(label: str, got: dict, dense: dict) -> dict:
    """Each solve of ``got`` against the dense solve of its method: b and f
    within TOL (rtol 1e-3), lam within rtol 1e-3; whether bitwise.  A
    Newton solve on "pallas" must have launched B2 once a trip."""
    from repro_torch.core import disba

    rows = {}
    for key, res in got.items():
        want = dense[key]
        name = f"{label}/{key}"
        rows[key] = {
            "b": check_close(name, res["b"], want.b, "b"),
            "f": check_close(name, res["f"], want.f, "f"),
            "lam": check_close(name, res["lam"], want.lam, "lam_sharded"),
            "bitwise": {k: bool(np.array_equal(
                res[k], getattr(want, k).cpu().numpy()))
                for k in ("b", "f", "lam")},
            "ms": res["ms"], "dual_demand_launches":
            res["dual_demand_launches"]}
        expected = disba.WARM_ITERS if key == "newton-pallas" else 0
        if res["dual_demand_launches"] != expected:
            raise AssertionError(f"{name}: {res['dual_demand_launches']} "
                                 f"dual_demand launches, expected "
                                 f"{expected}")
    return rows


def check_sharded_fleets(label: str, fleets: dict, batches: dict,
                         n_dev: int) -> dict:
    """Each fleet bitwise per seed against its batch, its "fleet" record
    the reference's geometry for ``n_dev`` ranks."""
    from repro_torch.fl import simulator

    rows = {}
    for key, (fleet, seconds) in fleets.items():
        fleet = dict(fleet)
        record = fleet.pop("fleet")
        chunk, n_chunks, padded_to = simulator._fleet_shape(
            len(SHARDED_SEEDS), n_dev, SHARDED_CHUNK)
        want = {"n_devices": n_dev, "mesh_axis": "seeds", "chunk": chunk,
                "n_chunks": n_chunks, "padded_to": padded_to}
        if record != want:
            raise AssertionError(f"{label}/{key}: fleet record {record}, "
                                 f"the reference's geometry {want}")
        _bitwise(f"{label}/{key} vs its batch", fleet, batches[key][0])
        rows[key] = {"seconds": seconds, "batch_seconds": batches[key][1],
                     "fleet": record, "bitwise": True}
    return rows


def sharded_phase() -> dict:
    """Slice 11's path.  (1) World 1 on nccl: disba_sharded at the market
    shape (8192 x 32, phase 3's market, B = 10 MHz) by every
    SHARDED_SOLVES case against the dense solve of its method on the card,
    and the fleets (sharded_configs) against run_batch /
    run_cotrain_batch, bitwise per seed.  (2) SHARDED_RANKS gloo ranks on
    the card, spawned here: each solves on its 2048 rows (B2 a Newton
    trip), held to the same dense solves, and runs its share of the same
    fleets, held to the same batches bitwise."""
    import torch.distributed as dist

    from repro_torch.core import disba
    from repro_torch.launch import mesh as mesh_lib

    t_start = time.perf_counter()
    svc = market(MARKET_N, 32)
    lam_prev = float(disba.solve_lambda_newton(svc, B_TOTAL).lam) * 1.05
    dense = {"newton-pallas": disba.solve_lambda_newton_warm(
                 svc, B_TOTAL, lam_prev, backend="pallas"),
             "newton-reference": disba.solve_lambda_newton_warm(
                 svc, B_TOTAL, lam_prev, backend="reference"),
             "bisect-reference": disba.solve_lambda_bisect(svc, B_TOTAL)}
    batches = sharded_fleets(batch=True)
    out = {"market": [MARKET_N, 32], "lam_prev": lam_prev}

    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",
            init_method=f"file://{store}/world1", rank=0, world_size=1)
        try:
            if DEVICE == "cuda":
                torch.cuda.set_device(0)
            backend = dist.get_backend()
            mesh = mesh_lib.make_mesh((1,), ("data",))
            t0 = time.perf_counter()
            solves = sharded_solves(svc, lam_prev, mesh)
            out["world1"] = {
                "backend": backend,
                "solves": check_sharded_solves("sharded world 1", solves,
                                               dense),
                "collective_trip_ms": collective_trip_ms(mesh),
                "fleets": check_sharded_fleets(
                    "sharded world 1", sharded_fleets(), batches, 1),
                "seconds": time.perf_counter() - t0}
        finally:
            dist.destroy_process_group()

    t0 = time.perf_counter()
    moe_refs = ep_references()
    ranks = spawn_ranks(SHARDED_RANKS, {
        "device": DEVICE, "setup": RANK_SETUP, "lam_prev": lam_prev,
        "market": tuple(x.cpu().numpy() for x in (svc.alpha, svc.t_comp,
                                                  svc.mask)),
        "moe_refs": moe_refs["refs"]})
    rows = []
    for rank, res in enumerate(ranks):
        label = f"sharded {SHARDED_RANKS} ranks/rank {rank}"
        rows.append({
            "rank": rank, "seconds": res["seconds"],
            "collective_trip_ms": res["collective_trip_ms"],
            "solves": check_sharded_solves(label, res["solves"], dense),
            "fleets": check_sharded_fleets(label, res["fleets"], batches,
                                           SHARDED_RANKS)})
    for key in ranks[0]["solves"]:
        for res in ranks[1:]:
            for k in ("b", "f", "lam"):
                if not np.array_equal(res["solves"][key][k],
                                      ranks[0]["solves"][key][k]):
                    raise AssertionError(f"sharded {SHARDED_RANKS} ranks: "
                                         f"{key} {k} differs between ranks")
    out[f"world{SHARDED_RANKS}"] = {"backend": "gloo", "ranks": rows,
                                    "seconds": time.perf_counter() - t0}
    emit({"phase": "sharded_moe", **check_ep_ranks(ranks, moe_refs)})
    out["batch_seconds"] = {k: v[1] for k, v in batches.items()}
    out["seconds"] = time.perf_counter() - t_start
    emit({"phase": "sharded", **out})
    return out


def sharded_kernel_times(sharded: dict) -> dict:
    """Outside the counted paths: B2's kernel ms at the shape a rank's
    Newton trip gives it (the whole market at world 1, its first 2048
    rows at 4 ranks; WARM_INNER_ITERS trips; CUDA events behind a device
    sleep), beside the ms a trip of the collective alone and each world's
    ms a solve (host clock around a synchronised call)."""
    from repro_torch.core import disba
    from repro_torch.kernels import ops

    svc = market(MARKET_N, 32)
    lam = torch.tensor(sharded["lam_prev"], dtype=torch.float32,
                       device=DEVICE)
    rows = MARKET_N // SHARDED_RANKS
    b2 = {}
    for world, n in ((1, MARKET_N), (SHARDED_RANKS, rows)):
        a, t, mk = svc.alpha[:n], svc.t_comp[:n], svc.mask[:n]
        b2[world] = device_ms(lambda: ops.dual_demand(
            a, t, mk, lam, iters=disba.WARM_INNER_ITERS))
    world_n = sharded[f"world{SHARDED_RANKS}"]["ranks"]
    out = {
        "world1": {"backend": sharded["world1"]["backend"],
                   "collective_trip_ms":
                   sharded["world1"]["collective_trip_ms"],
                   "dual_demand_ms": b2[1], "shard": [MARKET_N, 32],
                   "solve_ms": {k: v["ms"] for k, v in
                                sharded["world1"]["solves"].items()},
                   "dual_demand_launches_per_solve": sharded["world1"][
                       "solves"]["newton-pallas"]["dual_demand_launches"]},
        f"world{SHARDED_RANKS}": {
            "backend": "gloo",
            "collective_trip_ms": [r["collective_trip_ms"] for r in world_n],
            "dual_demand_ms": b2[SHARDED_RANKS], "shard": [rows, 32],
            "solve_ms": {k: [r["solves"][k]["ms"] for r in world_n]
                         for k in world_n[0]["solves"]},
            "dual_demand_launches_per_solve": [
                r["solves"]["newton-pallas"]["dual_demand_launches"]
                for r in world_n]},
        "phase_seconds": sharded["seconds"]}
    emit({"phase": "sharded_times", **out})
    return out


def auction_phase() -> dict:
    """Phase 8: the auction entry on the card against the same call on the
    CPU, and the prefix charges against the rerun."""
    from repro_torch.core import auction, fairness
    from repro_torch.core.types import ServiceSet

    def welfare_atol(bid, b):
        welfare = float(auction.pseudo_mmvf_integral(
            bid, torch.zeros_like(b), b).sum())
        return 1e-4 + 1e-6 * welfare

    svc = market(AUCTION_N, 32)
    b_total = float(AUCTION_N)            # the paper's 1 MHz per service
    t0 = time.perf_counter()
    res = auction.run_auction(svc, b_total, 5, 0.5, backend="pallas")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = ServiceSet(*(None if x is None else x.cpu() for x in svc))
    t0 = time.perf_counter()
    ref = auction.run_auction(cpu, b_total, 5, 0.5, backend="pallas")
    cpu_s = time.perf_counter() - t0
    tag = f"run_auction@{AUCTION_N}"
    total = check_close(tag, res.b.sum(), torch.tensor(b_total), "split_sum")
    short = res.charges - fairness.fairness_cost(res.f, 0.5)
    if not bool((short >= -1e-6).all()):
        raise AssertionError(f"{tag}: a charge is below its fairness cost "
                             f"by {float(-short.min())}")
    bid = auction.uniform_truthful_bids(cpu, 5, 0.5, backend="pallas")
    atol = welfare_atol(bid, ref.b)
    checks = {"b_total": total,
              "price": check_close(tag, res.price, ref.price, "price"),
              **check_surplus_split(tag, res.b, ref.b, res.f, ref.f),
              "charges": check_close(tag, res.charges, ref.charges, "demand",
                                     atol=atol)}

    small = market(RERUN_N, 32)
    bid = auction.uniform_truthful_bids(small, 5, 0.5, backend="pallas")
    b, _ = auction.allocate(bid, float(RERUN_N))
    args = (small, bid, b, float(RERUN_N), 0.5)
    prefix = auction.charges(*args, method="prefix")
    rerun = auction.charges(*args, method="rerun")
    tag = f"charges@{RERUN_N}"
    checks["prefix_vs_rerun"] = check_close(tag, prefix, rerun, "demand",
                                            atol=welfare_atol(bid, b))
    row = {"n": AUCTION_N, "m": 5, "b_total": b_total,
           "price": float(res.price), "card_s": card_s, "cpu_s": cpu_s,
           "prefix_ms": event_ms(lambda: auction.charges(*args,
                                                         method="prefix")),
           "rerun_ms": event_ms(lambda: auction.charges(*args,
                                                        method="rerun")),
           "checks": checks}
    emit({"phase": "auction", **row})
    return row


# ---------------------------------------------------------------------------
# The serve path of gemma3-1b: attention kernels, serving, parity.
# ---------------------------------------------------------------------------

def _live_pairs(s_len: int, window: int, causal: bool = True,
                kv_len: int | None = None) -> int:
    """(query, key) pairs the causal mask, and the window if > 0, keep;
    without the causal mask every (query, key) pair."""
    if not causal:
        return s_len * (s_len if kv_len is None else kv_len)
    if window <= 0:
        return s_len * (s_len + 1) // 2
    w = min(window, s_len)
    return w * (w + 1) // 2 + (s_len - w) * w


def _heads(gen, dtype, *shapes):
    return [torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            for shape in shapes]


def _sdpa_mask(s_len: int, window: int):
    rows = torch.arange(s_len, device=DEVICE)[:, None]
    cols = torch.arange(s_len, device=DEVICE)[None, :]
    return (rows >= cols) & (rows - cols < window)


def _max_err(got, want, tol: float, label: str) -> float:
    """Raise unless |got - want| <= tol + tol |want| and got is finite, of
    want's shape and dtype; returns the largest deviation."""
    err = (got.double() - want.double()).abs()
    bad = err > tol + tol * want.double().abs()
    if got.shape != want.shape or got.dtype != want.dtype or bad.any() \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: {int(bad.sum())} entries beyond "
                             f"rtol = atol = {tol}; max dev "
                             f"{float(err.max())}; shapes {tuple(got.shape)}"
                             f" {tuple(want.shape)}")
    return float(err.max())


def attention_row(name: str, case: str, dtype, kern, plain, library,
                  work_ops: float, nbytes: float, names=(),
                  library_err: float | None = None,
                  extra: dict | None = None) -> dict:
    """One attention case: the deviation from the plain version, the times,
    the bound, and the achieved rate of the resource that bounds the case
    (TFLOP/s of live work, or GB/s of the bytes the bound counts) with
    bound_ms / ms, the kernel's share of its bound; ``library``: one
    PyTorch call computing the same function, timed as library_ms
    (``library_err``: its deviation from the plain version, where held
    to it)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = ATTENTION_TOL[dtype]
    max_dev = _max_err(got, want, tol, f"{name}/{case}/{dtype}")
    peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
    bound_ms, bound_by = bound(work_ops, nbytes, peak)
    ms = device_ms(kern)
    rate = ({"tflop_per_s": work_ops / ms / 1e9} if bound_by == "operations"
            else {"gb_per_s": nbytes / ms / 1e6})
    row = {"name": name, "case": case, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max_dev, "rtol": tol, "atol": tol,
           "ms": ms,
           "profiler_ms": kernel_profiler_ms(kern, name, names=names,
                                             min_records=1),
           "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
           "library_ms": device_ms(library),
           "library_max_abs_err": library_err,
           "bound_ms": bound_ms, "bound_by": bound_by, **rate,
           "share_of_bound": bound_ms / ms,
           "gflop": work_ops / 1e9, "mbytes": nbytes / 1e6, **(extra or {})}
    emit({"phase": "attention_vs_plain", **row})
    return row


def lse_err(q, k, v, opts: tuple, label: str) -> dict:
    """The forward kernel's L (B5 writes it for the backward) against the
    plain version's, within LSE_TOL: in float32 of the largest |L|, for
    bf16 inputs absolute."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain_lse

    causal, window, cap = opts
    _, got = ops.flash_attention_op(q, k, v, causal, window, cap)
    _, want = flash_attention_plain_lse(q, k, v, causal=causal,
                                        window=window, softcap=cap)
    torch.cuda.synchronize()
    dev = float((got.double() - want.double()).abs().max())
    scale = 1.0 if q.dtype == torch.bfloat16 else float(
        want.double().abs().max())
    tol = LSE_TOL[q.dtype]
    if got.shape != want.shape or got.dtype != torch.float32 or \
            dev > tol * scale or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: L deviates {dev} (limit {tol} x "
                             f"{scale}); shapes {tuple(got.shape)} "
                             f"{tuple(want.shape)}")
    return {"lse_max_abs_err": dev, "lse_tol": tol,
            "lse_tol_of": "absolute" if scale == 1.0 else "largest |L|"}


_FLEX: dict = {}


def flex_softcap(q, k, v, cap: float, window: int):
    """The soft-cap cases' library call: ``torch.compile`` of FlexAttention
    with c tanh(s / c) of the scaled logits as its score_mod and, where
    ``window``, the causal window as its block mask (else every key:
    decode's live slice).  The port never calls it."""
    from torch.nn.attention import flex_attention as fa

    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(fa.flex_attention, dynamic=False)

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    mask = None
    if window:
        def in_window(b, h, q_idx, kv_idx):
            return (q_idx >= kv_idx) & (q_idx - kv_idx < window)
        mask = fa.create_block_mask(in_window, None, None, q.shape[2],
                                    k.shape[2], device=q.device)
    return lambda: _FLEX["fn"](q, k, v, score_mod=score_mod,
                               block_mask=mask, enable_gqa=True)


def attention_phase() -> dict:
    """Phase 4: B5 and B6 against their plain versions on the card: slice
    3's cases (FLASH_CASES, DECODE_CASES, SERVE_LAYOUT_CASES) and the zoo's
    (ZOO_FLASH_CASES, ZOO_DECODE_CASES: B5 without the causal mask over
    Skv != Sq and Sq = Skv, B5 and B6 at groups 5 and 7, the soft cap at
    gemma3-1b's shapes, whose c = 0 twins are "local" and "global")."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    rows = {}
    flash_kernel = {torch.bfloat16: "flash_attention_wgmma_kernel",
                    torch.float32: "flash_attention_kernel"}
    # (B, Hq, Hkv, Sq, Skv, D, window, causal, softcap) and (B, Hq, Hkv,
    # cache, D, valid_len, lo, softcap)
    flash_cases = {case: (b, hq, hkv, s, s, d, w, True, 0.0) for case, (
        b, hq, hkv, s, d, w) in {**FLASH_CASES, **SERVE_LAYOUT_CASES}.items()}
    flash_cases.update(ZOO_FLASH_CASES)
    decode_cases = {case: (*shape, 0.0) for case, shape in
                    DECODE_CASES.items()}
    decode_cases.update(ZOO_DECODE_CASES)
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        for case, (b, hq, hkv, sq, skv, d, window, causal,
                   cap) in flash_cases.items():
            if (case in SERVE_LAYOUT_CASES or case in BF16_ONLY) and \
                    dtype != torch.bfloat16:
                continue
            if case in SERVE_LAYOUT_CASES:   # (B, S, H, D) -> (B, H, S, D)
                q, k, v = (x.transpose(1, 2) for x in _heads(
                    gen, dtype, (b, sq, hq, d), (b, skv, hkv, d),
                    (b, skv, hkv, d)))
            else:
                q, k, v = _heads(gen, dtype, (b, hq, sq, d),
                                 (b, hkv, skv, d), (b, hkv, skv, d))
            kw = dict(causal=causal, window=window, softcap=cap)
            mask = _sdpa_mask(sq, window) if window else None
            library_err = None
            if cap:
                library = flex_softcap(q, k, v, cap, window)
                library_err = _max_err(
                    library(), flash_attention_plain(q, k, v, **kw),
                    ATTENTION_TOL[dtype], f"flex/{case}/{dtype}")
            else:
                library = (lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True))
            rows["flash_attention", case, dtype] = attention_row(
                "flash_attention", case, dtype,
                lambda: ops.attention(q, k, v, **kw),
                lambda: flash_attention_plain(q, k, v, **kw), library,
                4.0 * d * b * hq * _live_pairs(sq, window, causal, skv),
                elt * (2 * b * hq * sq * d + 2 * b * hkv * skv * d),
                names=(flash_kernel[dtype],), library_err=library_err,
                extra=lse_err(q, k, v, (causal, window, cap),
                              f"flash_attention/{case}/{dtype}"))
        for case, (b, hq, hkv, cache, d, valid, lo,
                   cap) in decode_cases.items():
            q, k, v = _heads(gen, dtype, (b, hq, d), (b, cache, hkv, d),
                             (b, cache, hkv, d))
            kw, vw, n = k[:, lo:valid], v[:, lo:valid], valid - lo
            kt, vt = kw.transpose(1, 2), vw.transpose(1, 2)
            library_err = None
            if cap:
                library = flex_softcap(q[:, :, None], kt, vt, cap, 0)
                library_err = _max_err(
                    library()[:, :, 0], decode_attention_plain(
                        q, kw, vw, n, softcap=cap),
                    ATTENTION_TOL[dtype], f"flex/{case}/{dtype}")
            else:
                library = (lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kt, vt, enable_gqa=True))
            rows["decode_attention", case, dtype] = attention_row(
                "decode_attention", case, dtype,
                lambda: ops.attention_decode(q, kw, vw, n, softcap=cap),
                lambda: decode_attention_plain(q, kw, vw, n, softcap=cap),
                library, 4.0 * d * b * hq * n,
                elt * (2 * b * hq * d + 2 * b * hkv * n * d),
                names=("decode_attention_kernel",), library_err=library_err)
    return rows


def serve_phase() -> dict:
    """Phase 5: full-width gemma3-1b served through the port's entry point;
    the launch counts of the counted run are checked by main."""
    from repro_torch.launch import serve

    argv = ["--arch", SERVE["arch"], "--no-reduced", "--batch",
            str(SERVE["batch"]), "--prompt-len", str(SERVE["prompt_len"]),
            "--temperature", "0", "--device", DEVICE]
    serve.main(argv + ["--gen", "2"])          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = drive_path("serve", lambda: serve.main(argv + ["--gen",
                                                         str(SERVE["gen"])]),
                     keep=True)
    wall = time.perf_counter() - t0
    out, info = res["tokens"], res["info"]
    b, gen = SERVE["batch"], SERVE["gen"]
    want_len = SERVE["prompt_len"] + gen - 1
    if out.shape != (b, gen) or info["cache"]["len"] != want_len:
        raise AssertionError(f"serve: tokens {tuple(out.shape)}, cache len "
                             f"{info['cache']['len']}, expected ({b}, {gen}) "
                             f"and {want_len}")
    if not bool(torch.isfinite(info["logits"]).all()):
        raise AssertionError("serve: non-finite logits")
    profile = decode_profile(res["model"], res["params"], info["cache"],
                             out[:, -1:])
    prefill = prefill_profile(res["model"], res["params"], res["prompts"],
                              SERVE["prompt_len"] + gen,
                              "flash_attention_wgmma_kernel")
    row = {"arch": SERVE["arch"], "batch": b, "prompt_len": SERVE["prompt_len"],
           "gen": gen, "dtype": "bfloat16", "prefill_s": info["t_prefill"],
           "decode_steps": info["decode_steps"], "decode_s": info["t_decode"],
           "decode_ms_per_step": 1e3 * info["t_decode"] / info["decode_steps"],
           "decode_tokens_per_s": b * info["decode_steps"] / info["t_decode"],
           "prefill_tokens_per_s": b * SERVE["prompt_len"] / info["t_prefill"],
           "wall_s_with_init": wall, "cache_len": info["cache"]["len"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_step_profile": profile, "prefill_profile": prefill}
    emit({"phase": "serve", **row})
    return row


def decode_profile(model, params, cache, tok) -> dict:
    """One more decode step (the cache has room for it) under the profiler:
    the device activities it records (kernels, copies), their summed
    device time, the top names, and the step's wall time (inflated by the
    profiler; the serve row's decode ms per step is the unprofiled one).
    Informational: the profiler may drop records."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in device:
        entry = by_name.setdefault(e.name[:60], [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    busy_ms = sum(v[1] for v in by_name.values())
    return {"device_activities": len(device), "device_busy_ms": busy_ms,
            "profiled_wall_ms": wall_ms,
            "top": [{"name": k, "count": v[0], "ms": v[1]} for k, v in top]}


def prefill_profile(model, params, prompts, max_len: int,
                    kernel: str) -> dict:
    """One more prefill of the served prompts under the profiler (outside
    the counted path): its device activities, their summed device time,
    the device time of the kernels whose names contain ``kernel``, and the
    prefill's wall time (inflated by the profiler; the serve row's
    prefill_s is the unprofiled one).  It says how much of the prefill
    the device is busy, and how much of that the attention kernel takes.
    Informational: the profiler may drop records."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": prompts},
                                  max_len=max_len)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in device if kernel in e.name]
    return {"device_activities": len(device),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in device) / 1e3,
            "kernel": kernel, "kernel_launches": len(mine),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in mine) / 1e3,
            "profiled_wall_ms": wall_ms}


def lockstep_parity(label: str, cfg, batch: int, prompt_len: int,
                    gen: int, extra: dict | None = None, decode_kw=None,
                    card_init: bool = False, side: dict | None = None
                    ) -> dict:
    """The kernel path on the card against the plain path on the CPU: one
    float32 parameter set on both, prefill then greedy decode in lockstep
    (both sides take the CPU's token).  Last-position logits within
    MODEL_TOL at every step; a token that differs is reported with the
    CPU's top-2 gap and fails unless that gap is within 2 atol (a near
    tie).  ``extra``: more prefill inputs (CPU tensors: positions, frontend
    embeddings); ``decode_kw(step)``: a decode step's keyword arguments (CPU
    tensors); ``card_init``: draw the weights on a card generator seeded 0
    and copy them to the CPU (seconds, where the CPU's draws of a
    full-width layer take minutes); ``side["now"]`` is set to "card" or
    "cpu" before each side's call."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = registry.build_model(cfg)
    if card_init:
        card_params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                                 device=DEVICE)
        cpu_params = _to_device(card_params, "cpu")
    else:
        cpu_params = model.init(0, device="cpu")
        card_params = _to_device(cpu_params)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(3))
    extra = extra or {}
    runs = {"card": (card_params, {"tokens": prompts, **extra}),
            "cpu": (cpu_params, {"tokens": prompts, **extra})}
    side = {} if side is None else side
    state = {}
    for dev, (params, inputs) in runs.items():
        side["now"] = dev
        where = DEVICE if dev == "card" else "cpu"
        state[dev] = model.prefill(params, {k: x.to(where)
                                            for k, x in inputs.items()},
                                   max_len=prompt_len + gen)
    steps, flips = [], []
    for step in range(gen + 1):
        logits = {dev: state[dev][0][:, -1].double().cpu() for dev in state}
        err = (logits["card"] - logits["cpu"]).abs()
        bad = err > MODEL_TOL + MODEL_TOL * logits["cpu"].abs()
        if bad.any() or not bool(torch.isfinite(logits["card"]).all()):
            raise AssertionError(f"{label} step {step}: {int(bad.sum())} "
                                 f"logits beyond rtol = atol = {MODEL_TOL}; "
                                 f"max dev {float(err.max())}")
        steps.append(float(err.max()))
        if step == gen:
            break
        toks = {dev: serve.sample_token(None, state[dev][0], 0.0)
                for dev in state}
        for row in torch.nonzero(toks["card"].cpu() != toks["cpu"])[:, 0]:
            top2 = torch.topk(logits["cpu"][row], 2).values
            gap = float(top2[0] - top2[1])
            flips.append({"step": step, "row": int(row), "cpu_gap": gap})
            if gap > 2 * MODEL_TOL:
                raise AssertionError(f"{label} step {step}: greedy tokens "
                                     f"differ at row {int(row)} with a top-2 "
                                     f"gap of {gap}")
        tok = toks["cpu"]
        kw = decode_kw(prompt_len + step) if decode_kw else {}
        for dev, (params, _) in runs.items():
            side["now"] = dev
            where = state[dev][0].device
            state[dev] = model.decode_step(
                params, state[dev][1], tok.to(where),
                **{k: x.to(where) for k, x in kw.items()})
    row = {"arch": cfg.name, "dtype": "float32", "n_layers": cfg.n_layers,
           "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "rtol": MODEL_TOL, "atol": MODEL_TOL, "max_dev_per_step": steps,
           "max_dev": max(steps), "token_flips": flips}
    return row


def parity_phase() -> dict:
    """Phase 6: gemma3-1b in float32 cut to 2 layers (one local, one
    global), card against CPU."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(SERVE["arch"]),
                              n_layers=PARITY["n_layers"], global_every=2,
                              dtype="float32")
    row = lockstep_parity("parity", cfg, PARITY["batch"],
                          PARITY["prompt_len"], PARITY["gen"])
    row["windows"] = [0 if cfg.is_global_layer(i) else cfg.sliding_window
                      for i in range(cfg.n_layers)]
    emit({"phase": "parity", **row})
    return row


# ---------------------------------------------------------------------------
# The xLSTM serve path of xlstm-1.3b: the mLSTM kernel, serving, parity.
# ---------------------------------------------------------------------------

def mlstm_phase() -> dict:
    """B7 against its plain version on the card, bfloat16 and float32:
    the serve shape from the zero state, a ragged shape, and a carry (two
    halves with the state handed across, against the whole sequence).
    Inputs follow the JAX kernel test's recipe (k / sqrt(Dh), i ~ N(0, 0.5),
    f ~ N(2, 0.5)); y and the final C, n and m are checked.  In bfloat16
    each of the two kernels is also held to its own plain version: the
    states kernel's chunk states and final state against
    chunk_states_plain, the outputs kernel's y against chunk_outputs_plain
    on the same (the kernel's) states."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_plain

    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale
                + shift)

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        tol = MLSTM_TOL[dtype]
        for case, (b, h, s_len, dh, split) in MLSTM_CASES.items():
            q, k, v = (draw(b, h, s_len, dh).to(dtype) for _ in range(3))
            k = k / dh ** 0.5
            ig = draw(b, h, s_len, scale=0.5).to(dtype)
            fg = draw(b, h, s_len, scale=0.5, shift=2.0).to(dtype)
            full = (q, k, v, ig, fg)
            want_y, want_state = mlstm_chunk_plain(*full)
            if split:
                first = [x[:, :, :split] for x in full]
                second = [x[:, :, split:] for x in full]
                y1, mid = ops.mlstm(*first)
                y2, got_state = ops.mlstm(*second, mid)
                got_y = torch.cat([y1, y2], dim=2)
                timed, state_in = second, mid
                tokens = s_len - split
            else:
                got_y, got_state = ops.mlstm(*full)
                timed, state_in = full, None
                tokens = s_len
            torch.cuda.synchronize()
            label = f"mlstm_chunk/{case}/{dtype}"
            errs = [_max_err(got_y, want_y, tol, label + "/y")]
            errs += [_max_err(g, w, tol, f"{label}/{key}") for g, w, key in
                     zip(got_state, want_state, ("C", "n", "m"))]
            kern = (lambda: ops.mlstm(*timed, state_in))
            plain = (lambda: mlstm_chunk_plain(*timed, state_in))
            work = 4.0 * dh * (dh + BOUND_CHUNK) * b * h * tokens
            state_bytes = 4 * b * h * (dh * dh + dh + 1)
            nbytes = (elt * (4 * b * h * tokens * dh + 2 * b * h * tokens)
                      + state_bytes * (2 if split else 1))
            peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
            bound_ms, bound_by = bound(work, nbytes, peak)
            names = (MLSTM_KERNELS if dtype == torch.bfloat16
                     else ("mlstm_chunk_kernel",))
            row = {"name": "mlstm_chunk", "case": case,
                   "shape": [b, h, s_len, dh], "split": split,
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err_y_C_n_m": errs, "rtol": tol, "atol": tol,
                   "ms": device_ms(kern),
                   "profiler_ms": kernel_profiler_ms(
                       kern, "mlstm_chunk", names=names, min_records=1),
                   "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "gflop": work / 1e9,
                   "mbytes": nbytes / 1e6}
            if dtype == torch.bfloat16:
                row["kernels"] = mlstm_parts(label, timed, state_in, tol)
                errs += [e for part in row["kernels"]
                         for e in part["max_abs_err"]]
            row["max_abs_err"] = max(errs)
            row["share_of_bound"] = bound_ms / row["ms"]
            emit({"phase": "mlstm_vs_plain", **row})
            rows[case, dtype] = row
    return rows


def mlstm_parts(label: str, args, state_in, tol: float) -> list[dict]:
    """B7's two bf16 kernels, each against its own plain version on the
    same inputs: the states kernel's chunk states (C_c in bf16, n_c, m_c)
    and final (C, n, m) against chunk_states_plain, and the outputs
    kernel's y, on the states the states kernel wrote, against
    chunk_outputs_plain on those states.  Per kernel: deviations, the
    kernel's device time and profiler time, its plain version's time."""
    from repro_torch.kernels.mlstm_chunk import (chunk_outputs_plain,
                                                 chunk_states_plain,
                                                 mlstm_outputs_cuda,
                                                 mlstm_states_cuda)

    q, k, v, ig, fg = args
    states, final = mlstm_states_cuda(k, v, ig, fg, state_in)
    y = mlstm_outputs_cuda(q, k, v, ig, fg, states)
    torch.cuda.synchronize()
    want_states, want_final = chunk_states_plain(*args, state_in)
    errs = [_max_err(g.float(), w, tol, f"{label}/states/{key}")
            for g, w, key in zip((*states, *final),
                                 (*want_states, *want_final),
                                 ("C_c", "n_c", "m_c", "C", "n", "m"))]
    y_err = _max_err(y, chunk_outputs_plain(*args, states), tol,
                     f"{label}/outputs/y")
    calls = {"mlstm_states_kernel": (
                 lambda: mlstm_states_cuda(k, v, ig, fg, state_in),
                 lambda: chunk_states_plain(*args, state_in), errs),
             "mlstm_outputs_kernel": (
                 lambda: mlstm_outputs_cuda(q, k, v, ig, fg, states),
                 lambda: chunk_outputs_plain(*args, states), [y_err])}
    return [{"name": name, "max_abs_err": err, "ms": device_ms(kern),
             "profiler_ms": kernel_profiler_ms(kern, name, names=(name,),
                                               min_records=1),
             "plain_ms": event_ms(plain)}
            for name, (kern, plain, err) in calls.items()]


# ---------------------------------------------------------------------------
# One seed, the same draws on every device (the port's own generators).
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _episode(res: dict, i: int | None = None) -> dict:
    """One episode of run_scan's (i None) or run_batch's (seed i) result in
    compare_episodes' form."""
    if i is None:
        return res
    done = res["history"]["all_done"][i]
    periods = int(np.argmax(done)) + 1 if done.any() else len(done)
    return {"periods": periods, "finished": bool(res["finished"][i]),
            "fallbacks": int(res["fallbacks"][i]),
            "durations": res["durations"][i].tolist(),
            "history": {key: res["history"][key][i][:periods]
                        for key in ("b", "f", "rounds")}}


def seeded_draws_phase() -> dict:
    """The card and the CPU draw the same for one seed: run_scan at the
    paper's setting and a run_batch seed with gauss_markov / gilbert /
    mmpp, warm coop on "reference" on both devices (durations equal, with
    compare_episodes' one straddle exception); XLSTMLM.init and
    CausalLM.init at reduced width bitwise equal on both; serve's prompts
    for one seed equal on both.  Also the seconds of the full-width init
    of each model on the card (every weight drawn on the CPU, then
    copied), and the host's milliseconds per market-scale period of draws
    (on the CPU alone, on one intra-op thread, and with the copy to the
    card), with the CPU's time per operator from the profiler."""
    from repro_torch import configs, scenarios
    from repro_torch.fl import simulator
    from repro_torch.launch import serve
    from repro_torch.models import registry

    out = {"episodes": []}
    warm = dict(policy="coop", warm_start=True, intra_backend="reference",
                collect_alloc=True)
    scan_cfg = simulator.SimConfig(**PAPER, **warm, seed=SEEDED_SEED)
    batch_cfg = simulator.SimConfig(
        **PAPER, **warm, channel_process=scenarios.spec("gauss_markov"),
        churn_process=scenarios.spec("gilbert"), arrival_process="mmpp")
    period_s = simulator._default_net(scan_cfg).period_s
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        scan = simulator.run_scan(scan_cfg, device=dev)
        t1 = time.perf_counter()
        batch = simulator.run_batch(batch_cfg, [SEEDED_SEED], device=dev)
        runs[dev] = (scan, batch, t1 - t0, time.perf_counter() - t1)
    (scan, batch, scan_s, batch_s), (rscan, rbatch, rscan_s, rbatch_s) = (
        runs[DEVICE], runs["cpu"])
    for label, got, want, sec, rsec in (
            ("run_scan", _episode(scan), _episode(rscan), scan_s, rscan_s),
            ("run_batch-gauss_markov-gilbert-mmpp", _episode(batch, 0),
             _episode(rbatch, 0), batch_s, rbatch_s)):
        row = {"case": f"{label}/seed {SEEDED_SEED}",
               "periods": got["periods"], "card_s": sec, "cpu_s": rsec,
               "durations_equal": got["durations"] == want["durations"],
               **compare_episodes(f"{label} card vs cpu", got, want,
                                  period_s, must_finish=True)}
        out["episodes"].append(row)

    equal = {}
    for arch in (XLSTM_SERVE["arch"], SERVE["arch"]):
        model = registry.build_model(configs.get_smoke_config(arch))
        cpu, card = model.init(0, device="cpu"), model.init(0, device=DEVICE)
        pairs = list(zip(_leaves(cpu), _leaves(card)))
        if not all(c.device.type == "cpu"
                   and g.device.type == torch.device(DEVICE).type
                   and torch.equal(c, g.cpu()) for c, g in pairs):
            raise AssertionError(f"{arch}: init(0) differs between the card "
                                 f"and the CPU")
        equal[arch] = len(pairs)
    argv = ["--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--temperature", "1.0"]
    served = {dev: serve.main(argv + ["--device", dev])
              for dev in (DEVICE, "cpu")}
    if not torch.equal(served[DEVICE]["prompts"].cpu(),
                       served["cpu"]["prompts"]):
        raise AssertionError("serve: one seed gave other prompts on the card")
    out["init_tensors_equal"] = equal
    out["serve_prompts_equal"] = True
    out["serve_tokens_equal"] = bool(torch.equal(
        served[DEVICE]["tokens"].cpu(), served["cpu"]["tokens"]))

    # the host's share of a market-scale period: its draws, then the copy
    market = simulator.SimConfig(n_services_total=MARKET_N)
    market_net = simulator._default_net(market)
    _, market_counts = simulator._static_draws(market, market_net)
    draw_ms = {}
    threads = torch.get_num_threads()
    for label, dev, n_threads in (("cpu", "cpu", threads),
                                  ("cpu_one_thread", "cpu", 1),
                                  (DEVICE, DEVICE, threads)):
        torch.set_num_threads(n_threads)
        sampler = simulator.default_sampler(market, market_net, market_counts,
                                            dev)
        sampler(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for period in range(1, 6):
            sampler(period)
        torch.cuda.synchronize()
        draw_ms[label] = 1e3 * (time.perf_counter() - t0) / 5
    torch.set_num_threads(threads)
    # where the CPU's share goes: per operator, its calls and self time a
    # period; the rest (seeding the generator, Python) outside any operator
    sampler = simulator.default_sampler(market, market_net, market_counts,
                                        "cpu")
    for periods in (range(1), range(1, 6)):  # the first starts the profiler
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for period in periods:
                sampler(period)
        wall_ms = 1e3 * (time.perf_counter() - t0) / len(periods)
    per_op = {e.key: {"calls": e.count / 5,
                      "ms": e.self_cpu_time_total / 1e3 / 5}
              for e in prof.key_averages() if e.self_cpu_time_total > 0}
    out["market_period_draws_ms"] = {
        "draw_on_cpu": draw_ms["cpu"], "intra_op_threads": threads,
        "draw_on_cpu_one_thread": draw_ms["cpu_one_thread"],
        "draw_and_copy_to_card": draw_ms[DEVICE],
        "profiled_on_cpu": wall_ms,
        "outside_operators": wall_ms - sum(v["ms"] for v in per_op.values()),
        "per_operator": per_op}

    init_s, init_layers = {}, {}
    for arch in (XLSTM_SERVE["arch"], SERVE["arch"]):
        cfg = configs.get_config(arch)
        if arch == XLSTM_SERVE["arch"]:   # the depth it is served at
            cfg = dataclasses.replace(cfg, n_layers=XLSTM_SERVE["n_layers"])
        init_layers[arch] = cfg.n_layers
        model = registry.build_model(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(0, device=DEVICE)
        torch.cuda.synchronize()
        init_s[arch] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
    out["full_init_s"], out["full_init_layers"] = init_s, init_layers
    emit({"phase": "seeded_draws", **out})
    return out


def _mlstm_layers(arch: str, n_layers: int | None = None) -> int:
    from repro_torch import configs
    from repro_torch.models import registry

    cfg = configs.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_super, n_m = registry.build_model(cfg)._layout
    return n_super * n_m


def xlstm_serve_phase() -> dict:
    """Full-width xlstm-1.3b in bfloat16, cut to XLSTM_SERVE's layers,
    served through the port's entry point (batch 4, prompt 2048, 32 greedy
    tokens, after a short warm-up at fewer layers), then one no-cache
    forward of the same prompts; each is a main path counted from 0
    (checked by main).  The forward's last logits must agree with the
    prefill's within bf16 tolerance."""
    from repro_torch.launch import serve

    cfg_s = XLSTM_SERVE
    argv = ["--arch", cfg_s["arch"], "--no-reduced", "--batch",
            str(cfg_s["batch"]), "--temperature", "0", "--device", DEVICE]
    with cut_in_depth(cfg_s["arch"], cfg_s["warmup_layers"], serve):
        serve.main(argv + ["--prompt-len", str(cfg_s["warmup_prompt_len"]),
                           "--gen", "2"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cut_in_depth(cfg_s["arch"], cfg_s["n_layers"], serve):
        res = drive_path("xlstm_serve", lambda: serve.main(
            argv + ["--prompt-len", str(cfg_s["prompt_len"]),
                    "--gen", str(cfg_s["gen"])]), keep=True)
    wall = time.perf_counter() - t0
    out, info = res["tokens"], res["info"]
    b, gen = cfg_s["batch"], cfg_s["gen"]
    want_len = cfg_s["prompt_len"] + gen - 1
    if out.shape != (b, gen) or info["cache"]["len"] != want_len:
        raise AssertionError(f"xlstm serve: tokens {tuple(out.shape)}, cache "
                             f"len {info['cache']['len']}, expected "
                             f"({b}, {gen}) and {want_len}")
    if not bool(torch.isfinite(info["logits"]).all()):
        raise AssertionError("xlstm serve: non-finite logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, params = res["model"], res["params"]
    profile = decode_profile(model, params, info["cache"], out[:, -1:])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = drive_path("xlstm_forward", lambda: model.forward(
        params, res["prompts"], logits_mode="last"), keep=True)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    dev = _max_err(logits, info["prefill_logits"], MLSTM_TOL[torch.bfloat16],
                   "xlstm no-cache forward vs prefill")
    row = {"arch": cfg_s["arch"], "n_layers": cfg_s["n_layers"], "batch": b,
           "prompt_len": cfg_s["prompt_len"], "gen": gen, "dtype": "bfloat16",
           "prefill_s": info["t_prefill"],
           "decode_steps": info["decode_steps"], "decode_s": info["t_decode"],
           "decode_ms_per_step": 1e3 * info["t_decode"] / info["decode_steps"],
           "decode_tokens_per_s": b * info["decode_steps"] / info["t_decode"],
           "prefill_tokens_per_s": b * cfg_s["prompt_len"] / info["t_prefill"],
           "wall_s_with_init": wall, "cache_len": info["cache"]["len"],
           "peak_mem_gb": peak_gb, "no_cache_forward_s": forward_s,
           "forward_vs_prefill_max_dev": dev,
           "block_s": block_times(model, params, res["prompts"]),
           "decode_step_profile": profile}
    emit({"phase": "xlstm_serve", **row})
    return row


def block_times(model, params, prompts) -> dict:
    """Wall seconds of one mLSTM block and one sLSTM block over the whole
    prompt (host clock around synchronized work, median of 3), to split
    the prefill between the two; informational."""
    from repro_torch.models import xlstm

    cfg = model.cfg
    x = params["embed"][prompts].to(cfg.compute_dtype)
    blocks = {"mlstm": lambda: xlstm.apply_mlstm_block(
                  params["m_blocks"][0][0], cfg, x),
              "slstm": lambda: xlstm.apply_slstm_block(
                  params["s_blocks"][0], cfg, x)}
    out = {}
    for name, fn in blocks.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times))
    return out


def xlstm_parity_phase() -> dict:
    """Full-width xlstm-1.3b in float32 cut in depth to one super-block
    (7 mLSTM + 1 sLSTM), card against CPU."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(XLSTM_SERVE["arch"]),
                              n_layers=XLSTM_PARITY["n_layers"],
                              dtype="float32")
    row = lockstep_parity("xlstm parity", cfg, XLSTM_PARITY["batch"],
                          XLSTM_PARITY["prompt_len"], XLSTM_PARITY["gen"])
    emit({"phase": "xlstm_parity", **row})
    return row


# ---------------------------------------------------------------------------
# The zoo path (slice 12): the rest of the model zoo served at full width.
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def zoo_config(arch: str):
    """The arch's public config, cut in depth where ZOO_ARCHS says, and for
    command-r to the most layers whose bf16 weights and cache leave
    ZOO_FIT_MARGIN_GB of the card free (every layer, where they fit).
    Returns (config, cut note or None)."""
    from repro_torch import configs
    from repro_torch.models import registry

    cfg = configs.get_config(arch)
    keep = ZOO_ARCHS[arch]
    if keep is None:
        torch.cuda.empty_cache()
        model = registry.build_model(cfg)
        meta = model.init(0, device="meta", dtype=cfg.compute_dtype)
        blocks = meta.get("blocks") or meta.get("dec_blocks")
        per_layer = _nbytes(blocks) / len(blocks)
        rest = _nbytes(meta) - _nbytes(blocks)
        b, s = ZOO_SERVE["batch"], ZOO_SERVE["prompt_len"] + ZOO_SERVE["gen"]
        cache = model.init_cache(b, s, *([s] if cfg.family == "encdec"
                                         else []), device="meta")
        per_cache = _nbytes({k: v for k, v in cache.items()
                             if k != "len"}) / cfg.n_layers
        free = torch.cuda.mem_get_info()[0] - ZOO_FIT_MARGIN_GB * 1e9
        keep = min(cfg.n_layers, int((free - rest) // (per_layer + per_cache)))
        if keep < 1:
            raise AssertionError(f"zoo {arch}: no layer fits the card")
    if keep == cfg.n_layers:
        return cfg, None
    cut = f"{keep} of {cfg.n_layers} layers (every width kept)"
    return dataclasses.replace(cfg, n_layers=keep), cut


def zoo_batch(cfg, batch: int, prompt_len: int, seed: int = 1,
              src_len: int | None = None) -> dict:
    """Prompts from a CPU generator seeded ``seed``; M-RoPE's (3, B, S)
    positions (the text's: arange in all three streams); the vision stub's
    N_VISION_PATCHES patch embeddings or the audio stub's ``src_len``
    frames (prompt_len where None, as serve draws them), standard normals
    x 0.1 from the same generator."""
    from repro_torch.models import registry

    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen)
    out = {"tokens": tokens}
    if cfg.mrope_sections:
        out["positions"] = torch.arange(prompt_len, dtype=torch.int32)[
            None, None].expand(3, batch, prompt_len).contiguous()
    n_frames = {"vision": registry.N_VISION_PATCHES,
                "audio": src_len or prompt_len}.get(cfg.frontend)
    if n_frames:
        out["frontend_embeds"] = 0.1 * torch.randn(
            (batch, n_frames, cfg.d_model), generator=gen)
    return out


def _mrope_decode_kw(cfg, batch: int):
    """A decode step's keyword arguments: M-RoPE's position of the token
    fed at ``pos``, the same in all three streams; nothing otherwise."""
    if not cfg.mrope_sections:
        return None
    return lambda pos: {"positions": torch.full((3, batch, 1), pos,
                                                dtype=torch.int32)}


def zoo_generate(model, params, batch: dict, gen: int) -> tuple:
    """``serve.generate``, greedy, with M-RoPE's decode positions where the
    config has them (``decode_kw``)."""
    from repro_torch.launch import serve

    b, p = batch["tokens"].shape
    return serve.generate(model, params,
                          {k: x.to(DEVICE) for k, x in batch.items()},
                          max_len=p + gen, gen=gen, temperature=0.0,
                          generator=torch.Generator(),
                          decode_kw=_mrope_decode_kw(model.cfg, b))


def zoo_expected_launches(cfg, gen: int) -> dict:
    """B5 once a layer's whole-sequence attention and B6 once a layer's
    decode attention; MLA's layers launch neither; the enc-dec's encoder,
    decoder self and cross-attention each run B5 at prefill, its self and
    cross-attention each B6 a step."""
    out = {name: 0 for name in KERNELS}
    steps = gen - 1
    if cfg.family == "encdec":
        out["flash_attention"] = cfg.n_encoder_layers + 2 * cfg.n_layers
        out["decode_attention"] = 2 * cfg.n_layers * steps
    elif cfg.family != "mla_moe":
        out["flash_attention"] = cfg.n_layers
        out["decode_attention"] = cfg.n_layers * steps
    return out


def zoo_serve(arch: str) -> dict:
    """One arch served in bf16 at full width (ZOO_SERVE): weights drawn on
    a card generator in the compute dtype (init_s), a warm-up serve of a
    short prompt, then the counted serve (its own path, ``zoo:<arch>``):
    seamless through ``serve.main`` (its CPU-drawn init inside), the others
    through ``zoo_generate``.  Checks the launches, finite logits and the
    cache length; the decode step against the bytes it must read (every
    parameter once -- the MoE layers' every expert, as the grouped product
    reads them -- but the encoder's, and the whole cache) over 3.35 TB/s."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg, cut = zoo_config(arch)
    b, p, gen = ZOO_SERVE["batch"], ZOO_SERVE["prompt_len"], ZOO_SERVE["gen"]
    model = registry.build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    zoo_generate(model, params, zoo_batch(cfg, b, ZOO_SERVE[
        "warmup_prompt_len"]), 2)
    batch = zoo_batch(cfg, b, p)
    if cfg.family == "encdec":
        del params
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg.family == "encdec":
        argv = ["--arch", arch, "--no-reduced", "--batch", str(b),
                "--prompt-len", str(p), "--gen", str(gen), "--temperature",
                "0", "--device", DEVICE]
        res = drive_path(f"zoo:{arch}", lambda: serve.main(argv), keep=True)
        out, info, params = res["tokens"], res["info"], res["params"]
    else:
        out, info = drive_path(f"zoo:{arch}", lambda: zoo_generate(
            model, params, batch, gen), keep=True)
    wall = time.perf_counter() - t0
    want = zoo_expected_launches(cfg, gen)
    if PATH_LAUNCHES[f"zoo:{arch}"] != want:
        raise AssertionError(f"zoo {arch} launched "
                             f"{PATH_LAUNCHES[f'zoo:{arch}']}, expected {want}")
    if out.shape != (b, gen) or info["cache"]["len"] != p + gen - 1:
        raise AssertionError(f"zoo {arch}: tokens {tuple(out.shape)}, cache "
                             f"len {info['cache']['len']}, expected "
                             f"({b}, {gen}) and {p + gen - 1}")
    if not (bool(torch.isfinite(info["logits"]).all())
            and bool(torch.isfinite(info["prefill_logits"]).all())):
        raise AssertionError(f"zoo {arch}: non-finite logits")
    read = {k: v for k, v in params.items() if k != "enc_blocks"}
    step_bytes = _nbytes(read) + _nbytes(
        {k: v for k, v in info["cache"].items() if k != "len"})
    decode_ms = 1e3 * info["t_decode"] / info["decode_steps"]
    row = {"arch": arch, "cut": cut, "n_layers": cfg.n_layers,
           "dtype": "bfloat16", "batch": b, "prompt_len": p, "gen": gen,
           "params_b": sum(x.numel() for x in _leaves(params)) / 1e9,
           "weights_gb": _nbytes(params) / 1e9,
           "init_s": init_s if cfg.family != "encdec" else None,
           "serve_wall_s": wall, "prefill_s": info["t_prefill"],
           "decode_steps": info["decode_steps"],
           "decode_ms_per_step": decode_ms,
           "decode_step_bytes_gb": step_bytes / 1e9,
           "decode_bound_ms": 1e3 * step_bytes / PEAK_BYTES,
           "decode_share_of_bound": 1e3 * step_bytes / PEAK_BYTES / decode_ms,
           "cache_len": info["cache"]["len"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": PATH_LAUNCHES[f"zoo:{arch}"]}
    emit({"phase": "zoo_serve", **row})
    del params, info, out
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def adopting_card_quantization(stats: list, card_fault=None):
    """Within: the int8 cache's quantization (``transformer._quantize_kv``)
    of each CPU call returns what the card's matching call returned (the
    side of each call is the ``"now"`` of the yielded dict, which
    ``lockstep_parity(side=...)`` sets; card first), as the lockstep takes
    the CPU's token.  The two devices' float32 k and v differ in their
    last bits (layer 1's inherit layer 0's deviations, and a row's scale
    is its largest |x| / 127, so the scales differ as those do), and where
    x / scale sits near a half the two round to different int8 values: one
    such quantum moves a logit by up to ~1e-3 (a 1e-7 relative change of
    layer 0's k and v projections moved gemma3-1b's logits by 5.5e-4 on a
    CPU), far past MODEL_TOL.  Each CPU call's own result is compared
    first: the scales must agree within QUANT_SCALE_RTOL relative, and
    every quantum that differs must be one where the two devices' x /
    scale lie within QUANT_TIE of each other (so a half lies between
    them), or it raises.  Per call, ``stats`` gets the differing quanta,
    the scales' largest relative gap, and the largest |card - CPU| of x /
    scale over all entries and over the differing ones.  ``card_fault(x)``
    (a planted fault): what the card's calls quantize instead of x."""
    from repro_torch.models import transformer

    own = transformer._quantize_kv
    pending: list = []
    side = {"now": None}

    def quantize(x):
        if side["now"] == "card":
            x = x if card_fault is None else card_fault(x)
            q, scale = own(x)
            pending.append((q, scale, x.float() / scale[..., None]))
            return q, scale
        q, scale = own(x)
        card_q, card_scale, card_y = (t.cpu() for t in pending.pop(0))
        rel = float(((card_scale - scale).abs() / scale).max())
        gap = (card_y - x.float() / scale[..., None]).abs()
        diff = card_q != q
        flip_gap = float(gap[diff].max()) if diff.any() else 0.0
        if rel > QUANT_SCALE_RTOL or flip_gap > QUANT_TIE:
            raise AssertionError(
                f"int8 quantization differs beyond a half-quantum tie: "
                f"scales {rel}, {int(diff.sum())} quanta, largest gap "
                f"{flip_gap}")
        stats.append({"flips": int(diff.sum()), "scale_rel": rel,
                      "y_gap": float(gap.max()), "flip_gap": flip_gap})
        return card_q, card_scale

    transformer._quantize_kv = quantize
    try:
        yield side
    finally:
        transformer._quantize_kv = own


def zoo_parity_case(arch: str, label: str, change: dict,
                    card_fault=None, card_decode=None) -> dict:
    """One ZOO_PARITY_CASES entry: the arch at full width cut to 2 layers
    (or the case's n_layers) in float32, the kernel path on the card against the plain path on the
    CPU in lockstep (``lockstep_parity``, weights drawn on the card), with
    the model's frontend inputs and M-RoPE positions; the int8 cache's
    CPU run adopts the card's quanta (``adopting_card_quantization``, with
    ``card_fault``).  ``card_decode(own, *args, **kw)`` (a planted fault)
    takes the card side's B6 calls, ``own`` being ``ops.attention_decode``."""
    from repro_torch import configs
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(configs.get_config(arch), **{
        "n_layers": ZOO_PARITY["n_layers"], "dtype": "float32", **change})
    b, p = ZOO_PARITY["batch"], ZOO_PARITY["prompt_len"]
    extra = {k: x for k, x in zoo_batch(
        cfg, b, p, src_len=ZOO_PARITY_SRC_LEN).items() if k != "tokens"}
    t0 = time.perf_counter()
    stats: list = []
    own_decode = ops.attention_decode
    with (adopting_card_quantization(stats, card_fault)
          if cfg.kv_cache_dtype == "int8"
          else contextlib.nullcontext({})) as side:
        if card_decode is not None:
            ops.attention_decode = lambda *args, **kw: (
                card_decode(own_decode, *args, **kw) if side["now"] == "card"
                else own_decode(*args, **kw))
        try:
            row = lockstep_parity(f"zoo parity {label}", cfg, b, p,
                                  ZOO_PARITY["gen"], extra=extra,
                                  decode_kw=_mrope_decode_kw(cfg, b),
                                  card_init=True, side=side)
        finally:
            ops.attention_decode = own_decode
    row.update(label=label, overrides=change,
               seconds=time.perf_counter() - t0)
    if "frontend_embeds" in extra:
        row["frontend_len"] = extra["frontend_embeds"].shape[1]
    if cfg.kv_cache_dtype == "int8":
        row.update(quant_calls=len(stats),
                   quant_flips=sum(c["flips"] for c in stats),
                   **{f"quant_{key}_max": max(c[key] for c in stats)
                      for key in ("scale_rel", "y_gap", "flip_gap")})
    torch.cuda.empty_cache()
    return row


def int8_planted_faults(arch: str, change: dict) -> list:
    """The int8 parity with a fault planted on the card, each of which must
    fail it (the quantization guard or MODEL_TOL) although the CPU adopts
    the card's quanta: B6 reading one key fewer (its own token's key) in
    every layer, and in the last layer only (whose output no quantization
    sees, so MODEL_TOL alone can catch it), and the card's k and v with
    relative noise of 1e-3 before they are quantized (about TF32's
    rounding of the projections)."""
    def one_key_fewer(every: int):
        calls = [0]

        def decode(own, q, k, v, valid_len, **kw):
            calls[0] += 1
            return own(q, k, v, valid_len - (calls[0] % every == 0), **kw)
        return decode

    def noisy(x):
        gen = torch.Generator(device=x.device).manual_seed(0)
        return x * (1 + 1e-3 * torch.randn(x.shape, generator=gen,
                                           device=x.device))

    faults = {"b6_one_key_fewer": {"card_decode": one_key_fewer(1)},
              "b6_one_key_fewer_last_layer": {
                  "card_decode": one_key_fewer(ZOO_PARITY["n_layers"])},
              "card_kv_noise_1e-3": {"card_fault": noisy}}
    rows = []
    for name, fault in faults.items():
        try:
            zoo_parity_case(arch, f"planted {name}", change, **fault)
            caught = None
        except AssertionError as err:
            caught = str(err)[:200]
        row = {"fault": name, "failed_with": caught}
        emit({"phase": "int8_planted_fault", **row})
        if caught is None:
            raise AssertionError(f"int8 parity passed with the planted "
                                 f"fault {name}")
        rows.append(row)
    return rows


def zoo_parity() -> list:
    """Float32 parity of each new family and feature (ZOO_PARITY_CASES),
    then the int8 case's planted faults."""
    rows = []
    for arch, label, change in ZOO_PARITY_CASES:
        row = zoo_parity_case(arch, label, change)
        emit({"phase": "zoo_parity", **row})
        rows.append(row)
        if change.get("kv_cache_dtype") == "int8":
            row["planted_faults"] = int8_planted_faults(arch, change)
    return rows


def zoo_phase() -> dict:
    """The zoo path: every arch of ZOO_ARCHS served (each its own counted
    path), then the float32 parity."""
    serves = {arch: zoo_serve(arch) for arch in ZOO_ARCHS}
    return {"serve": serves, "parity": zoo_parity()}


# ---------------------------------------------------------------------------
# Slice 13: B5's backward and the train path.
# ---------------------------------------------------------------------------

def _grad_err(got, want, tol: float, label: str,
              names=("dq", "dk", "dv")) -> float:
    """Raise unless each of got's outputs is finite, of want's shape and
    dtype, and within tol of want's largest |value|; returns the largest
    deviation over that scale."""
    worst = 0.0
    for name, g, w in zip(names, got, want, strict=True):
        if g.dtype != w.dtype:
            raise AssertionError(f"{label}/{name}: {g.dtype}, not {w.dtype}")
        worst = max(worst, _rel_err(g, w, tol, f"{label}/{name}"))
    return worst


def _rel_err(got, want, tol: float, label: str) -> float:
    """Raise unless ``got`` is finite, of ``want``'s shape and within
    ``tol`` of ``want``'s largest |value|; returns the deviation over that
    scale."""
    scale = float(want.double().abs().max())
    dev = float((got.double() - want.double()).abs().max()) / max(scale,
                                                                  1e-30)
    if got.shape != want.shape or dev > tol or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: deviation {dev} of the largest "
                             f"|value| {scale}, limit {tol}; shapes "
                             f"{tuple(got.shape)} {tuple(want.shape)}")
    return dev


def _bwd_profiler_ms(kern, names) -> dict:
    """Mean device ms a call of each of the backward's kernels ``names``,
    from one profiler window (_profiled_records)."""
    kern()
    torch.cuda.synchronize()
    records = _profiled_records(kern, BWD_REPS, names)
    if any(not recs for recs in records.values()):
        raise AssertionError(f"profiler kept "
                             f"{({k: len(v) for k, v in records.items()})} "
                             f"records of {names}")
    return {name: sum(e.time_range.elapsed_us() for e in recs) / len(recs)
            / 1e3 for name, recs in records.items()}


def attention_bwd_phase() -> dict:
    """Phase 6b: B5's backward kernels against their plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels import _bisect, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
        for case, (b, hq, hkv, sq, skv, d, window, causal,
                   cap) in BWD_CASES.items():
            if dtype == torch.float32 and case not in BWD_FLOAT32:
                continue
            q, k, v, do = _heads(gen, dtype, (b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d), (b, hq, sq, d))
            opts = (causal, window, cap)
            label = f"flash_attention_bwd/{case}/{dtype}"
            lse_row = lse_err(q, k, v, opts, label)
            o, lse = ops.flash_attention_op(q, k, v, *opts)

            def kern():
                return ops.flash_attention_bwd_op(q, k, v, o, lse, do, *opts)

            def plain():
                return flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal=causal, window=window,
                    softcap=cap)

            first = kern()
            torch.cuda.synchronize()
            err = _grad_err(first, plain(), BWD_TOL[dtype], label)
            repeats = bitwise_repeats(label, kern, first, BWD_REPEATS)
            ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
            library_err = None
            if cap:
                out = flex_softcap(ql, kl, vl, cap, window)()
            else:
                mask = _sdpa_mask(sq, window) if window else None
                out = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)

            def library():
                return torch.autograd.grad(out, (ql, kl, vl), do,
                                           retain_graph=True)

            if cap:
                library_err = _grad_err(library(), plain(), BWD_TOL[dtype],
                                        f"flex {label}")
            work = OPS_PER_PAIR_BWD * d * b * hq * _live_pairs(
                sq, window, causal, skv)
            nbytes = elt * (4 * b * hq * sq * d + 4 * b * hkv * skv * d)
            bound_ms, bound_by = bound(work, nbytes, peak)
            ms = device_ms(kern, reps=BWD_REPS)
            splits = 1
            if dtype == torch.bfloat16:
                splits = fa.dkdv_splits(b * hkv * -(-skv // 64),
                                        _bisect.sm_count(DEVICE))
            names = tuple(n for n in BWD_KERNELS[dtype]
                          if splits > 1 or "_sum_" not in n)
            parts = _bwd_profiler_ms(kern, names)
            row = {"name": "flash_attention_bwd", "case": case,
                   "dtype": str(dtype).split(".")[-1],
                   "shape": [b, hq, hkv, sq, skv, d], "window": window,
                   "causal": causal, "softcap": cap,
                   "max_abs_err": err, "err_of": "largest |grad|",
                   "tol": BWD_TOL[dtype], "bitwise_repeats": repeats,
                   **lse_row, "dkdv_splits": splits,
                   "ms": ms, "profiler_ms": sum(parts.values()),
                   "kernels": parts,
                   "wrapper_ms": event_ms(kern, reps=BWD_REPS),
                   "plain_ms": event_ms(plain, reps=BWD_REPS),
                   "library_ms": device_ms(library, reps=BWD_REPS),
                   "library_max_abs_err": library_err,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflop_per_s": work / ms / 1e9,
                   "share_of_bound": bound_ms / ms, "gflop": work / 1e9,
                   "mbytes": nbytes / 1e6}
            emit({"phase": "attention_bwd", **row})
            rows[case, dtype] = row
            del q, k, v, do, o, lse, first, ql, kl, vl, out, library
            torch.cuda.empty_cache()
    return rows


def _chunk_live_mask(s_len: int, n_chunks: int, chunk: int) -> torch.Tensor:
    """(n_chunks, chunk, chunk) bool: the (query, key) pairs of each chunk
    that the scores kernel computes, key <= query < the chunk's length."""
    t = torch.arange(chunk, device=DEVICE)
    lens = (s_len - chunk * torch.arange(n_chunks, device=DEVICE)).clamp(
        max=chunk)
    return ((t[None, :, None] >= t[None, None, :])
            & (t[None, :, None] < lens[:, None, None]))


def mlstm_bwd_parts(label: str, args, tol: float, groups) -> dict:
    """B7's four backward kernels, each against its plain version on the
    same inputs (the plain outputs of the kernels before it): every
    output, in each group of heads, within ``tol`` of its largest |value|
    there; the scores kernel's W, dS and G on the live pairs only (the
    launcher leaves the rest unwritten; no kernel reads it)."""
    from repro_torch.kernels import mlstm_chunk as mc

    q, k, v, ig, fg, y, states, m, stats, dy = args
    scores = mc.chunk_scores_plain(q, k, v, ig, fg, y, dy, states, m, stats)
    aux, so, w, ds, g = scores
    back = mc.chunk_states_bwd_plain(q, dy, aux, so, states)
    grads = mc.chunk_grads_plain(q, k, v, dy, aux, w, ds, states, *back[:2])
    live = _chunk_live_mask(q.shape[2], so.shape[2], mc.CHUNK)
    got_scores = mc.mlstm_bwd_scores_cuda(q, k, v, ig, fg, y, dy, states, m,
                                          stats)
    calls = {
        "scores": ((*got_scores[:2], *(torch.where(live, x, 0.0)
                                       for x in got_scores[2:])), scores),
        "states": (mc.mlstm_bwd_states_cuda(q, dy, aux, so, states), back),
        "grads": (mc.mlstm_bwd_grads_cuda(q, k, v, dy, aux, w, ds, states,
                                          *back[:2]), grads),
        "gates": (mc.mlstm_bwd_gates_cuda(fg, aux, so, g, *grads[3:],
                                          back[2]),
                  mc.chunk_gates_bwd_plain(fg, aux, so, g, *grads[3:],
                                           back[2]))}
    torch.cuda.synchronize()
    # aux is (N_AUX, B, H, S): its heads are dim 2, every other output's 1
    return {name: [max(_rel_err(_head_slice(a, hs,
                                            i == 0 and name == "scores"),
                                _head_slice(b, hs,
                                            i == 0 and name == "scores"),
                                tol, f"{label}/{name}/{i}/{group}")
                       for group, hs in groups.items())
                   for i, (a, b) in enumerate(zip(got, want, strict=True))]
            for name, (got, want) in calls.items()}


def _head_slice(x: torch.Tensor, heads: slice, aux: bool = False):
    """x's heads ``heads`` (dim 1, or dim 2 of the scores kernel's aux) as
    float32."""
    return (x[:, :, heads] if aux else x[:, heads]).float()


def mlstm_saved_err(label: str, args, saved, tol: float) -> dict:
    """The forward kernels' saved tensors against their plain versions:
    the state at every chunk's start within ``tol`` of each one's largest
    |value|, ell per position within ELL_TOL absolute, and the share of
    positions where the normaliser's floor wins, which must lie within
    MLSTM_FLOOR_SHARE (both branches of max(|N|, exp(-m)) in real shares);
    sgn may differ only at near-ties of |N| and the floor (counted)."""
    from repro_torch.kernels import mlstm_chunk as mc

    cs, ns, ms, stats = saved
    want, _ = mc.chunk_states_plain(*args)
    want_stats = mc.chunk_stats_plain(args[0], args[1], args[3], args[4],
                                      (cs, ns, ms))
    flips = int((stats[:, :, 1] != want_stats[:, :, 1]).sum())
    if flips > 1e-3 * stats[:, :, 1].numel():
        raise AssertionError(f"{label}: sgn differs at {flips} positions")
    ell_err = float((stats[:, :, 0] - want_stats[:, :, 0]).abs().max())
    if not ell_err <= ELL_TOL[args[0].dtype]:
        raise AssertionError(f"{label}/ell: {ell_err} apart, limit "
                             f"{ELL_TOL[args[0].dtype]}")
    floor_share = float((stats[:, :, 1] == 0).float().mean())
    lo, hi = MLSTM_FLOOR_SHARE
    if not lo < floor_share < hi:
        raise AssertionError(f"{label}: the floor wins at {floor_share} of "
                             f"the positions, outside ({lo}, {hi})")
    return {"C_c": _rel_err(cs.float(), want[0], tol, f"{label}/C_c"),
            "n_c": _rel_err(ns, want[1], tol, f"{label}/n_c"),
            "m_c": _rel_err(ms, want[2], tol, f"{label}/m_c"),
            "ell_abs": ell_err,
            "ell_absmax": float(stats[:, :, 0].abs().max()),
            "sgn_flips": flips,
            "floor_share": floor_share,
            "floor_share_by_head": (stats[:, :, 1] == 0).float().mean(
                (0, 2)).tolist()}


def mlstm_bwd_phase() -> dict:
    """Phase 6m: B7's backward kernels against their plain versions, on
    the forward kernels' own saved tensors and a random dy.  k is scaled
    by 1 / sqrt(Dh) on the even heads (phase 2a's recipe: the floor
    exp(-m_t) wins at nearly every position) and left as drawn on the odd
    ones (|N_t| wins at about two thirds of theirs), so that dN, dn and a
    nonzero ell are all held to their plain versions; every check is made
    on each group of heads apart, against that group's largest |value|."""
    from repro_torch.kernels import mlstm_chunk as mc
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEVICE).manual_seed(23)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale
                + shift)

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
        tol = BWD_TOL[dtype]
        for case, (b, h, s_len, dh) in MLSTM_BWD_CASES.items():
            if dtype == torch.float32 and case not in MLSTM_BWD_FLOAT32:
                continue
            q, k, v, dy = (draw(b, h, s_len, dh) for _ in range(4))
            k[:, MLSTM_FLOOR_HEADS] /= dh ** 0.5
            q, k, v, dy = (x.to(dtype) for x in (q, k, v, dy))
            ig = draw(b, h, s_len, scale=0.5).to(dtype)
            fg = draw(b, h, s_len, scale=0.5, shift=2.0).to(dtype)
            y, _, _, m, cs, ns, ms, stats = ops.mlstm_chunk_op(
                q, k, v, ig, fg, None, None, None, True)
            label = f"mlstm_chunk_bwd/{case}/{dtype}"
            saved = mlstm_saved_err(label, (q, k, v, ig, fg),
                                    (cs, ns, ms, stats), tol)
            args = (q, k, v, ig, fg, y, (cs, ns, ms), m, stats, dy)

            def kern():
                return ops.mlstm_chunk_bwd_op(q, k, v, ig, fg, y, cs, ns, ms,
                                              m, stats, dy)

            def plain():
                return mc.mlstm_chunk_bwd_plain(*args)

            first = kern()
            torch.cuda.synchronize()
            want = plain()
            err = max(_grad_err([x[:, hs] for x in first],
                                [x[:, hs] for x in want], tol,
                                f"{label}/{group}",
                                names=("dq", "dk", "dv", "di", "df"))
                      for group, hs in MLSTM_HEAD_GROUPS.items())
            del want
            repeats = bitwise_repeats(label, kern, first, BWD_REPEATS)
            parts_err = mlstm_bwd_parts(label, args, tol, MLSTM_HEAD_GROUPS)
            n_chunks = -(-s_len // mc.CHUNK)
            pairs = sum(n * (n + 1) // 2 for n in (
                min(mc.CHUNK, s_len - lo) for lo in range(0, s_len, mc.CHUNK)))
            work = b * h * dh * (OPS_PER_POS_MLSTM_BWD * dh * s_len
                                 + OPS_PER_PAIR_MLSTM_BWD * pairs)
            # q, k, v, y, dy in and dq, dk, dv out; both gates in and out;
            # the chunk states, the statistics and the final m in
            nbytes = b * h * (elt * (8 * s_len * dh + 4 * s_len)
                              + n_chunks * (elt * dh * dh + 4 * dh + 4)
                              + 8 * s_len + 4)
            bound_ms, bound_by = bound(work, nbytes, peak)
            ms_kern = device_ms(kern, reps=BWD_REPS)
            parts = _bwd_profiler_ms(kern, MLSTM_BWD_KERNELS)
            row = {"name": "mlstm_chunk_bwd", "case": case,
                   "dtype": str(dtype).split(".")[-1],
                   "shape": [b, h, s_len, dh], "max_abs_err": err,
                   "err_of": "largest |grad|", "tol": tol,
                   "bitwise_repeats": repeats, "saved": saved,
                   "kernel_errs": parts_err, "ms": ms_kern,
                   "profiler_ms": sum(parts.values()), "kernels": parts,
                   "wrapper_ms": event_ms(kern, reps=BWD_REPS),
                   "plain_ms": event_ms(plain, reps=BWD_REPS),
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "tflop_per_s": work / ms_kern / 1e9,
                   "share_of_bound": bound_ms / ms_kern, "gflop": work / 1e9,
                   "mbytes": nbytes / 1e6}
            emit({"phase": "mlstm_bwd", **row})
            rows[case, dtype] = row
            del q, k, v, dy, ig, fg, y, cs, ns, ms, stats, first, args
            torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def cut_in_depth(arch: str, n_layers: int, launcher=None):
    """``launcher``'s configs (launch.train's by default, or launch.serve's)
    with ``arch``'s full config cut to ``n_layers`` (every width kept), for
    the duration; no command-line flag."""
    if launcher is None:
        from repro_torch.launch import train as launcher

    resolve = launcher.resolve_config

    def cut(name: str, reduced: bool):
        cfg = resolve(name, reduced)
        return (dataclasses.replace(cfg, n_layers=n_layers)
                if name == arch and not reduced else cfg)

    launcher.resolve_config = cut
    try:
        yield
    finally:
        launcher.resolve_config = resolve


def train_run(t: dict = TRAIN) -> dict:
    """A train path's run through the entry point a user calls: ``t``'s
    arch at full width (cut to ``t["n_layers"]`` where given)."""
    from repro_torch.launch import train

    argv = ["--services", t["arch"], "--no-reduced", "--clients",
            str(t["clients"]), "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--local-steps", str(t["local_steps"]),
            "--periods", str(t["periods"]), "--max-rounds-per-period",
            str(t["max_rounds"]), "--period-s", str(t["period_s"]),
            "--policy", t["policy"], "--intra-backend", t["intra_backend"],
            "--device", DEVICE]
    cut = (cut_in_depth(t["arch"], t["n_layers"]) if "n_layers" in t
           else contextlib.nullcontext())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cut:
        res = train.main(argv)
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    return res


def train_parity(arch: str = TRAIN["arch"]) -> dict:
    """One round of ``arch``'s reduced config (float32) on the card and on
    the CPU from one parameter set and batch."""
    from repro_torch import configs
    from repro_torch.fl import server
    from repro_torch.models import registry
    from repro_torch.tree import leaves_with_names

    cfg = configs.get_smoke_config(arch)
    if cfg.compute_dtype != torch.float32:
        raise AssertionError(f"{cfg.name}'s smoke config is not float32")
    model = registry.build_model(cfg)
    params = model.init(0, device="cpu")
    t = TRAIN_PARITY
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (t["clients"], t["local_steps"],
                                            t["batch"], t["seq"] + 1),
                        generator=gen)
    batches = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    weights = torch.ones((t["clients"],))
    step = server.make_fl_round_step(model.loss,
                                     local_steps=t["local_steps"],
                                     client_lr=t["lr"])
    cpu_new, cpu_m = step(params, batches, weights)
    card_new, card_m = step(_to_device(params), _to_device(batches),
                            weights.to(DEVICE))
    loss_dev = abs(float(card_m["loss"]) - float(cpu_m["loss"]))
    if loss_dev > MODEL_TOL * (1 + abs(float(cpu_m["loss"]))):
        raise AssertionError(f"train parity: loss {float(card_m['loss'])} "
                             f"on the card, {float(cpu_m['loss'])} on the "
                             f"CPU")
    worst = 0.0
    for (name, new_c), (_, new_h), (_, old) in zip(
            leaves_with_names(card_new), leaves_with_names(cpu_new),
            leaves_with_names(params)):
        change = (new_h - old).double()
        dev = float(((new_c.cpu() - old).double() - change).abs().max())
        scale = float(change.abs().max())
        if dev > MODEL_TOL * max(scale, 1e-12):
            raise AssertionError(f"train parity: {name} changed {dev} apart "
                                 f"(largest change {scale})")
        worst = max(worst, dev / max(scale, 1e-12))
    row = {"arch": cfg.name, "config": "smoke (float32)", **t,
           "loss_card": float(card_m["loss"]), "loss_cpu": float(cpu_m["loss"]),
           "loss_dev": loss_dev, "max_change_dev": worst, "tol": MODEL_TOL}
    emit({"phase": "train_parity", **row})
    return row


def cotrain_zoo(arch: str = TRAIN_COTRAIN_SPEC["arch"]) -> dict:
    """A smoke-size co-trained episode of the zoo task (``arch``'s smoke
    config) on "pallas": its durations equal "reference"'s and plain
    run_scan's."""
    from repro_torch.core import network
    from repro_torch.fl import cotrain, simulator

    net = network.NetworkConfig(**TRAIN_COTRAIN_NET)
    spec = cotrain.TrainSpec(**{**TRAIN_COTRAIN_SPEC, "arch": arch})
    runs = {}
    for backend in ("pallas", "reference"):
        cfg = simulator.SimConfig(**TRAIN_COTRAIN_SIM, intra_backend=backend)
        t0 = time.perf_counter()
        runs[backend] = cotrain.run_cotrain_scan(cfg, spec, net,
                                                 device=DEVICE)
        runs[backend]["seconds"] = time.perf_counter() - t0
    plain = simulator.run_scan(simulator.SimConfig(
        **TRAIN_COTRAIN_SIM, intra_backend="pallas"), net, device=DEVICE)
    got = runs["pallas"]
    if not got["durations"] == runs["reference"]["durations"] == \
            plain["durations"]:
        raise AssertionError(f"cotrain zoo: durations {got['durations']}, "
                             f"reference {runs['reference']['durations']}, "
                             f"run_scan {plain['durations']}")
    h = got["history"]
    if not (np.all(np.isfinite(h["loss"])) and sum(got["trained_rounds"]) > 0
            and np.all((h["acc"] >= 0) & (h["acc"] <= 1))):
        raise AssertionError(f"cotrain zoo: trained {got['trained_rounds']}, "
                             f"loss {h['loss'].tolist()}")
    row = {"arch": spec.arch, "durations": got["durations"],
           "trained_rounds": got["trained_rounds"],
           "periods": got["periods"], "seconds": got["seconds"],
           "reference_seconds": runs["reference"]["seconds"],
           "final_loss": h["loss"][-1].tolist()}
    emit({"phase": "cotrain_zoo", **row})
    return row


def grad_guards() -> dict:
    """B6 has no backward (decode is never differentiated): on CUDA inputs
    that require grad its wrapper raises (naming ROADMAP) and launches
    nothing."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEVICE).manual_seed(19)
    q, k, v = _heads(gen, torch.bfloat16, (2, 4, 64), (2, 16, 1, 64),
                     (2, 16, 1, 64))
    calls = {"decode_attention": lambda: ops.attention_decode(
                 q.requires_grad_(), k, v, 8)}
    before = dict(ops.LAUNCHES)
    out = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as exc:
            if "ROADMAP" not in str(exc):
                raise
            out[name] = str(exc)
        else:
            raise AssertionError(f"{name} returned under grad on the card")
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("a refused call launched a kernel")
    emit({"phase": "grad_guards", "raised": out})
    return out


def xlstm_train_phase(mlstm_bwd_rows: dict) -> dict:
    """The xLSTM train path (counted): full-width xlstm-1.3b cut to
    XLSTM_TRAIN["n_layers"] through launch.train.main; exactly
    XLSTM_TRAIN_MLSTM_LAYERS x local steps x rounds launches of B7 and of
    its backward, TRAIN_B1_PER_PERIOD of B1 a period, no other kernel;
    finite losses; B7's backward ms a round from 6m's profiler ms at the
    train shape, and the run's device allocations and allocation retries
    (the caching allocator's growth, which the first round pays)."""
    torch.cuda.empty_cache()
    t = XLSTM_TRAIN
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    res = drive_path("train_xlstm", lambda: train_run(t), keep=True)
    after = torch.cuda.memory_stats()
    allocator = {key: after.get(key, 0) - before.get(key, 0)
                 for key in ("num_device_alloc", "num_alloc_retries")}
    name = t["arch"]
    rounds = res["rounds_done"][name]
    per_round = XLSTM_TRAIN_MLSTM_LAYERS * t["local_steps"]
    expected = {k: 0 for k in KERNELS}
    expected.update(mlstm_chunk=per_round * rounds,
                    mlstm_chunk_bwd=per_round * rounds,
                    bisect_alloc=TRAIN_B1_PER_PERIOD * len(res["periods"]))
    losses = res["services"][0]["losses"]
    if rounds < 1 or PATH_LAUNCHES["train_xlstm"] != expected:
        raise AssertionError(f"train xlstm: {rounds} rounds launched "
                             f"{PATH_LAUNCHES['train_xlstm']}, expected "
                             f"{expected}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"train xlstm: losses {losses}")
    round_ms = 1e3 * float(np.median(res["services"][0]["round_s"]))
    last_ms = 1e3 * res["services"][0]["round_s"][-1]
    bwd_ms = per_round * mlstm_bwd_rows[MLSTM_BWD_MAIN_CASE,
                                        torch.bfloat16]["profiler_ms"]
    row = {**t, "rounds": rounds, "losses": losses, "periods": res["periods"],
           "peak_gb": (None if res["peak_bytes"] is None
                       else res["peak_bytes"] / 1e9),
           "ms_per_round": round_ms,
           "round_ms": [1e3 * x for x in res["services"][0]["round_s"]],
           "wall_s": res["wall_s"], "bwd_launches_per_round": per_round,
           "last_round_ms": last_ms, "bwd_ms_per_round": bwd_ms,
           "bwd_share_of_last_round": bwd_ms / last_ms,
           "allocator": allocator,
           "launches": PATH_LAUNCHES["train_xlstm"]}
    emit({"phase": "train_xlstm", **row})
    return row


def train_cli() -> dict:
    """launch.train.main with its own defaults (gemma-2b and xlstm-1.3b,
    reduced, on the card) but TRAIN_CLI's periods; the launches checked
    by train_phase."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    res = train.main(list(TRAIN_CLI))
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    return res


def check_train_cli(res: dict) -> dict:
    """Exactly one B5 and one B5 backward launch a layer a local step a
    round for the transformer service, one B7 and one B7 backward a mLSTM
    layer likewise for the xLSTM one, no other kernel; finite losses."""
    from repro_torch.launch import train
    from repro_torch.models import registry

    args = train.build_parser().parse_args(list(TRAIN_CLI))
    expected = {k: 0 for k in KERNELS}
    for svc in res["services"]:
        cfg = train.resolve_config(svc["name"], args.reduced)
        calls = args.local_steps * svc["rounds_done"]
        if cfg.family == "ssm":
            n_super, n_m = registry.build_model(cfg)._layout
            keys, per = ("mlstm_chunk", "mlstm_chunk_bwd"), n_super * n_m
        else:
            keys, per = ("flash_attention", "flash_attention_bwd"), \
                cfg.n_layers
        for key in keys:
            expected[key] += per * calls
        if svc["rounds_done"] < 1 or not np.all(np.isfinite(svc["losses"])):
            raise AssertionError(f"train cli: {svc['name']} trained "
                                 f"{svc['rounds_done']} rounds, losses "
                                 f"{svc['losses']}")
    if PATH_LAUNCHES["train_cli"] != expected:
        raise AssertionError(f"train cli launched {PATH_LAUNCHES['train_cli']}"
                             f", expected {expected}")
    row = {"argv": list(TRAIN_CLI), "wall_s": res["wall_s"],
           "services": [{k: svc[k] for k in ("name", "rounds_done")}
                        | {"final_loss": svc["losses"][-1]}
                        for svc in res["services"]],
           "launches": PATH_LAUNCHES["train_cli"]}
    emit({"phase": "train_cli", **row})
    return row


def train_phase(bwd_rows: dict, mlstm_bwd_rows: dict) -> dict:
    """Phase 6t: the train path (counted), then the xLSTM train path, the
    float32 parity of both families, launch.train's default CLI and the
    zoo's co-trained episodes of both (each counted on its own), and the
    guard.  ``bwd_rows`` are phase 6b's, whose profiler ms at the train
    shapes give B5's backward ms a round; ``mlstm_bwd_rows`` phase 6m's,
    B7's backward's."""
    from repro_torch import configs

    torch.cuda.empty_cache()
    res = drive_path("train", train_run, keep=True)
    t = TRAIN
    name = t["arch"]
    rounds = res["rounds_done"][name]
    cfg = configs.get_config(name)
    n_layers = cfg.n_layers
    expected = {k: 0 for k in KERNELS}
    expected.update(flash_attention=n_layers * t["local_steps"] * rounds,
                    flash_attention_bwd=n_layers * t["local_steps"] * rounds,
                    bisect_alloc=TRAIN_B1_PER_PERIOD * len(res["periods"]))
    losses = res["services"][0]["losses"]
    if rounds < 1 or PATH_LAUNCHES["train"] != expected:
        raise AssertionError(f"train: {rounds} rounds launched "
                             f"{PATH_LAUNCHES['train']}, expected {expected}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    round_s = res["services"][0]["round_s"]
    n_global = sum(cfg.is_global_layer(i) for i in range(n_layers))
    per_round = {"train_local": (n_layers - n_global) * t["local_steps"],
                 "train_global": n_global * t["local_steps"]}
    bwd_ms = sum(n * bwd_rows[case, torch.bfloat16]["profiler_ms"]
                 for case, n in per_round.items())
    row = {**t, "rounds": rounds, "losses": losses, "periods": res["periods"],
           "peak_gb": (None if res["peak_bytes"] is None
                       else res["peak_bytes"] / 1e9),
           "ms_per_round": 1e3 * float(np.median(round_s)),
           "round_ms": [1e3 * x for x in round_s], "wall_s": res["wall_s"],
           "bwd_launches_per_round": per_round,
           "bwd_ms_per_round": bwd_ms,
           "bwd_share_of_round": bwd_ms / (1e3 * float(np.median(round_s))),
           "launches": PATH_LAUNCHES["train"]}
    emit({"phase": "train", **row})
    del res
    torch.cuda.empty_cache()
    xlstm_arch = XLSTM_TRAIN["arch"]
    return {"train": row,
            "train_xlstm": xlstm_train_phase(mlstm_bwd_rows),
            "parity": drive_path("train_parity", train_parity, keep=True),
            "parity_xlstm": drive_path(
                "train_parity_xlstm", lambda: train_parity(xlstm_arch),
                keep=True),
            "cli": check_train_cli(drive_path("train_cli", train_cli,
                                              keep=True)),
            "cotrain_zoo": drive_path("cotrain_zoo", cotrain_zoo, keep=True),
            "cotrain_zoo_xlstm": drive_path(
                "cotrain_zoo_xlstm", lambda: cotrain_zoo(xlstm_arch),
                keep=True),
            "guards": grad_guards()}


def _to_device(tree, device=None):
    if isinstance(tree, list):
        return [_to_device(x, device) for x in tree]
    if isinstance(tree, dict):
        return {key: _to_device(x, device) for key, x in tree.items()}
    return tree.to(device or DEVICE)


def card_info() -> tuple[str, str]:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return kind, smi


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, smi = card_info()
    emit({"phase": "card", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    clock = {"start": time.perf_counter()}
    emit({"phase": "build", "seconds": _build.build()})
    clock["build"] = time.perf_counter()

    # --- the port's seeded draws: the same on the card and the CPU --------
    seeded_draws_phase()
    clock["seeded_draws"] = time.perf_counter()

    # --- slice 4 first: B7, then the xLSTM serve path and its parity -------
    mlstm = mlstm_phase()
    clock["mlstm_kernel"] = time.perf_counter()
    xlstm_serve_phase()
    m_layers = _mlstm_layers(XLSTM_SERVE["arch"], XLSTM_SERVE["n_layers"])
    for path in ("xlstm_serve", "xlstm_forward"):
        expected = {name: 0 for name in KERNELS}
        expected["mlstm_chunk"] = m_layers
        if PATH_LAUNCHES[path] != expected:
            raise AssertionError(f"{path} launched {PATH_LAUNCHES[path]}, "
                                 f"expected {expected}")
    clock["xlstm_serve"] = time.perf_counter()
    xlstm_parity_phase()
    clock["xlstm_parity"] = time.perf_counter()

    per_shape = {(n, k): kernel_phase(n, k, m) for n, k, m in KERNEL_SHAPES}
    b12_parts()
    b3_parts()
    b4_parts()
    edge_matrix_phase()
    clock["allocation_kernels"] = time.perf_counter()
    attention = attention_phase()
    clock["attention_kernels"] = time.perf_counter()

    # --- the gemma3-1b serve path ------------------------------------------
    serve_phase()
    from repro_torch import configs
    n_layers = configs.get_config(SERVE["arch"]).n_layers
    expected = {name: 0 for name in KERNELS}
    expected.update(flash_attention=n_layers,
                    decode_attention=n_layers * (SERVE["gen"] - 1))
    if PATH_LAUNCHES["serve"] != expected:
        raise AssertionError(f"serve launched {PATH_LAUNCHES['serve']}, "
                             f"expected {expected}")
    clock["serve"] = time.perf_counter()
    parity_phase()
    clock["parity"] = time.perf_counter()

    # --- the zoo path: the rest of the zoo's serve paths -------------------
    zoo_phase()
    clock["zoo"] = time.perf_counter()

    # --- slice 13: B5's backward, then training ----------------------------
    attention_bwd = attention_bwd_phase()
    clock["attention_bwd"] = time.perf_counter()
    mlstm_bwd = mlstm_bwd_phase()
    clock["mlstm_bwd"] = time.perf_counter()
    train_phase(attention_bwd, mlstm_bwd)
    clock["train"] = time.perf_counter()

    paths = {"xlstm_serve": PATH_LAUNCHES["xlstm_serve"],
             "xlstm_forward": PATH_LAUNCHES["xlstm_forward"],
             "serve": PATH_LAUNCHES["serve"],
             **{f"zoo:{arch}": PATH_LAUNCHES[f"zoo:{arch}"]
                for arch in ZOO_ARCHS},
             **{path: PATH_LAUNCHES[path]
                for path in ("train", "train_xlstm", "train_parity",
                             "train_parity_xlstm", "train_cli", "cotrain_zoo",
                             "cotrain_zoo_xlstm")},
             "slice1": drive_path("slice1", path_slice1),
             "selfish": drive_path("selfish", path_selfish),
             "run_batch": drive_path("run_batch", batch_pair)}
    clock["allocation_paths"] = time.perf_counter()
    paths["cotrain"] = drive_path("cotrain", cotrain_phase)
    clock["cotrain"] = time.perf_counter()
    paths["allocd"] = drive_path("allocd", allocd_phase)
    clock["allocd"] = time.perf_counter()
    one_client_poison()    # C8's drill, outside the counted paths
    clock["one_client_poison"] = time.perf_counter()
    sharded = drive_path("sharded", sharded_phase, keep=True)
    paths["sharded"] = PATH_LAUNCHES["sharded"]
    clock["sharded"] = time.perf_counter()
    launches = {name: sum(p[name] for p in paths.values()) for name in KERNELS}
    emit({"phase": "launches", "launches": launches, "per_path": paths})
    missing = [name for name, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"main paths never launched {missing}")
    for path, kernels in (("cotrain", COTRAIN_KERNELS),
                          ("allocd", ALLOCD_KERNELS),
                          ("sharded", SHARDED_KERNELS)):
        missing = [name for name in kernels if not PATH_LAUNCHES[path][name]]
        if missing:
            raise AssertionError(f"the {path} path never launched "
                                 f"{missing}")
    sharded_kernel_times(sharded)   # after the paths, as draw_samplers
    draw_samplers()        # after the paths: its episodes count in no path
    clock["draw_samplers"] = time.perf_counter()

    auction_phase()
    clock["auction"] = time.perf_counter()
    lost = np.array([w[1:] for w in FILLERS_LOST]).reshape(-1, 2)
    emit({"phase": "profiler_windows", "windows": len(lost),
          "fillers": FILLERS,
          "lost_at_start": {int(k): int(v) for k, v in
                            zip(*np.unique(lost[:, 0], return_counts=True))},
          "lost_at_end": {int(k): int(v) for k, v in
                          zip(*np.unique(lost[:, 1], return_counts=True))},
          "limit": FILLERS_LOST_LIMIT,
          "most_lost": max(FILLERS_LOST, key=lambda w: max(w[1:]),
                           default=None)})
    marks = list(clock.items())
    emit({"phase": "seconds", **{name: t - marks[i][1]
                                 for i, (name, t) in enumerate(marks[1:])}})

    rows = dict(per_shape[KERNEL_SHAPES[0][:2]])
    errors = {name: max(per_shape[s][name]["max_abs_err"] for s in per_shape)
              for name in rows}
    for name in ("bisect_alloc", "dual_demand"):   # where their launches are
        rows[name] = per_shape[MAIN_PATH_SHAPE][name]
    for name in ("flash_attention", "decode_attention"):
        rows[name] = attention[name, MAIN_CASE, torch.bfloat16]
        errors[name] = max(row["max_abs_err"] for key, row in attention.items()
                           if key[0] == name)
    rows["flash_attention_bwd"] = attention_bwd[BWD_MAIN_CASE, torch.bfloat16]
    errors["flash_attention_bwd"] = max(row["max_abs_err"]
                                        for row in attention_bwd.values())
    rows["mlstm_chunk"] = mlstm["serve", torch.bfloat16]
    errors["mlstm_chunk"] = max(row["max_abs_err"] for row in mlstm.values())
    rows["mlstm_chunk_bwd"] = mlstm_bwd[MLSTM_BWD_MAIN_CASE, torch.bfloat16]
    errors["mlstm_chunk_bwd"] = max(row["max_abs_err"]
                                    for row in mlstm_bwd.values())
    print(smi, flush=True)
    # B7 is one row: one call (one launch count) runs its two bf16 kernels,
    # listed under "parts" with their own times; so are B5's and B7's
    # backwards (their max_abs_err is of the largest |grad|; parts the
    # profiler ms of each kernel).
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{name}.cu", "replaces": where,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": rows[name]["ms"], "profiler_ms": rows[name]["profiler_ms"],
         "wrapper_ms": rows[name]["wrapper_ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name].get("library_ms"),
         **({"parts": rows[name]["kernels"]} if "kernels" in rows[name]
            else {})}
        for name, where in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
