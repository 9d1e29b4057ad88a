#!/usr/bin/env python3
"""Build the port's CUDA kernels, check them, serve seesaw-150m and train
it with a Seesaw batch ramp, save, stop and resume that run and train it
under the adaptive ramp, train mamba2-2.7b with a Seesaw ramp and serve
it from the recurrent state pool, serve seesaw-150m and starcoder2-3b
through the blocking ``Server`` (starcoder2-3b from its sliding-window
ring cache), run the paper's benchmarks and train seesaw-150m at its
critical batch size, Seesaw against cosine, train and serve the MoE
granite-moe-1b-a400m, run the reference's serving, engine and
checkpoint benchmarks, train and serve the RG-LRU hybrid
recurrentgemma-9b, train and serve the encoder-decoder
seamless-m4t-medium, serve internvl2-76b with its image prefix and
mistral-nemo-12b, train seesaw-150m data-parallel as two launcher
processes sharing the card, train seesaw-150m and llama3.2-3b sharded
over a data x model mesh of launcher processes sharing the card, and
run the kernel benchmark on one NVIDIA card.

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the JAX package ``repro``; it runs
``src/repro_torch`` from this checkout.  The engines run on the card
through CUDA graphs, the port's compile cache: one captured graph per
training (batch size, micro) and per serving prompt bucket, and one
decode graph, each replayed once per step.

- Build: nvcc compiles ``src/repro_torch/csrc`` for sm_90a (one process
  per source, in parallel) into ``build/kernels``.  Then what was
  compiled is read back: the bfloat16 flash forward, dq and dk/dv kernels
  (hd 64 and 128) must hold HMMA (tensor-core mma.sync) instructions in
  their SASS (``cuobjdump -sass``) and their float32 forms none, and
  ptxas must report no spills for the bfloat16 ones at hd 64; likewise
  the bfloat16 SSD chunk kernel must hold HMMA and spill nothing and its
  float32 form hold none; HMMA counts, registers and spill bytes (the
  RMSNorm backward's too) go into the ``kernels`` line.
- Phase 1, kernels against their plain versions: RMSNorm forward, the
  causal GQA flash forward and the ragged decode, each on the serving
  path's shapes (seesaw-150m prefill at S=1024, decode at 8 slots over a
  1024-token window with ragged lengths) and on llama3.2-3b's GQA heads
  (H=24, Hkv=8, hd=128), in float32 (tolerance 2e-5) and bfloat16
  (2e-2), TF32 off; the flash forward also at S = 1, 15, 16, 63, 64, 65
  and 129 (hd 64, MHA; hd 128, GQA groups of 3), the edges of the bf16
  kernel's tiles.  The decode kernel twice: through its gathered-window
  entry (against ``ragged_decode_ref``), and reading K and V through the
  page table from a pool (``paged_decode_attention_pool``, against
  ``paged_decode_ref``) at page sizes 1, 4 and 16, with shuffled page
  ids, null-page entries, an inactive slot and lengths at the page edges
  and at the window's last key.  Then each kernel (``ms``), its plain
  version (``plain_ms``) and one PyTorch call that computes the same
  function (``library_ms``, a yardstick the port never calls) are timed
  with CUDA events, L2 flushed before every launch and the host's
  enqueue hidden behind a device spin (``Timer``), at the serving path's
  shapes in bfloat16; the decode also at lengths that fit one split of
  the kernel (no merge) and at full windows, its paged entry (page 16,
  the same lengths) beside its gathered one, and ``gather_pages`` alone
  at phase 2's table shape (8 x 64 pages of 16), the copy the page-table
  read spares the serving step.  The RMSNorm forward is checked and timed
  at the other prompt buckets of phase 2's mix too (64-512 rows of 1024),
  and beside its ``ms`` it gets ``graph_us``: the device time of one
  launch as a CUDA graph of 200 back-to-back calls replays it
  (``GraphTimer``, L2 warm, no host launch cost), below ``Timer``'s
  floor of ~5 us; ``F.rms_norm`` beside it (``library_graph_us``), and
  so at the training shapes of phases 1b and 1c.
- Phase 1d, the streaming normalize of the kernel benchmark's overlap
  probe (``kernels/overlap.py``, bulk asynchronous copies through a
  ring of ``depth`` shared-memory stages) against its plain version in
  float32 (2e-5): at 8192 x 512 at every (block_rows, depth) of the
  benchmark's sweep that fits the card's shared memory, and at edge
  shapes (fewer row-blocks than SMs, more depth than row-blocks per SM,
  d = 256, 1028 and 4, depth 3 and 16).  Then, for what the kernel's
  gap to its bound is made of, two reference times with the same timer:
  a device copy of the same 8192 x 512 and a kernel touching 4 bytes.
- Phase 2, the engine: ``get_config("seesaw-150m")`` unreduced, random
  weights from a seed, bfloat16, 8 decode slots, page 16, max_len 1024;
  16 seeded requests with prompts of 64-768 tokens and 32-128 new
  tokens, EOS off.  A warm-up of one request per bucket this mix and the
  profiled one use runs the first prefill and decode eagerly and
  captures the CUDA graphs (one per bucket, one decode graph); the timed
  run is replays only and must capture nothing.  Every request must
  finish with exactly its max_new_tokens tokens in [0, vocab), the pool
  must drain to 0 pages, the engine must hold one decode entry and no
  more entries than its budget (buckets + 1), and the tokens must equal
  those of the same mix served by an engine whose every call runs
  eagerly (timed too: ``eager_tok_per_s``).  The kernels' launch counts
  (counted through the replays) are set to 0 just before the timed run
  and read just after; each must be > 0.  A torch.profiler run of 8 more
  requests gives the device time per decode step and the graph and
  kernel launches the host made.
- Phase 3, the card against the CPU: two of those requests, 8 new tokens
  each, in float32 through the same engine on the card (kernels) and on
  the CPU (plain versions), same weights.  First-token logits must agree
  within 1e-3 and the greedy tokens must be equal.
- Phase 1b, the backward kernels against their plain versions: RMSNorm
  backward at the training rows (8·1024 × 1024), at (1000 × 3072) and
  at 150 × 2560 (fewer rows than the kernel's grid has blocks), and the
  RMSNorm forward on the training rows' x (its staged form; the
  ``train_shape_max_abs_err`` of its ``kernels`` entry);
  the flash backward (dq, dk/dv) at seesaw-150m's training shapes (B=8,
  S=1024, H=Hkv=16, hd=64) and at llama3.2-3b's GQA heads with a ragged
  S=1000, and at phase 1's edge lengths; float32 (2e-5) and bfloat16
  (2e-2), TF32 off.  At each of those shapes the flash forward's out and
  lse are held to ``attention_ref`` too before the backward reads them
  (``train_shape_max_abs_err`` in its ``kernels`` entry).  RMSNorm's
  dscale, a float32 sum over all rows, is held to 2e-5 of the sum of its
  terms' magnitudes.  Then each is timed as in phase 1 at the training
  shapes in bfloat16; ``library_ms`` is ``torch.autograd.grad`` through
  ``F.rms_norm`` and through ``F.scaled_dot_product_attention``, the
  forward outside the timed call; the RMSNorm backward's time includes
  dscale, summed inside its one launch.  The flash forward and the
  RMSNorm forward are timed at the training shape too, beside SDPA's
  forward / ``F.rms_norm`` and their bounds (``train_shape_*`` in their
  ``kernels`` entries).
- Phase 4, training at full width: seesaw-150m unreduced, bfloat16
  compute with float32 weights and AdamW state (β 0.9/0.95, clip 1.0),
  ``kind="seesaw"``, α=2, B0=8, two cuts, seq 1024, 24·8·1024 tokens,
  ``fuse_steps=4``, ``max_device_batch=8``, data ``MarkovLM(2048, 0)``:
  phases B = 8 / 16 / 32 over 16 / 2 / 1 steps, accumulating 1 / 2 / 4
  micro-batches.  Every loss must be finite, each step's LR, batch size
  and phase must be the plan's, the mean loss of the last 3 steps must
  be at least 0.5 below step 1's, and the five training kernels' launch
  counts (set to 0 just before the run, read just after) must equal
  what remat gives per micro-batch: RMSNorm forward 4L+1, backward
  2L+1, flash forward 2L, dq and dk/dv L each.  The first step runs
  eagerly, every later one as the replay of its (batch size, micro)
  graph: the step cache must hold exactly the three keys, each captured
  once.  Reports tokens/s and wall time per step at each batch size
  (capture time taken out; ``captures_s`` beside), peak memory, and a
  torch.profiler breakdown of one more step at B=8, which must be one
  ``cudaGraphLaunch`` and fewer than 50 ``cudaLaunchKernel`` calls.
- Phase 5, training on the card against the CPU in float32:
  seesaw-150m widths at 2 layers, S=256, B=2, the same weights on both.
  Loss within 1e-4; every grad within 1e-3 of its tensor's largest
  |grad|; AdamW applied on each device to the same (CPU) grads at a
  fixed LR within 1e-6.  Then three engine steps on each device (on the
  card an eager one, a capture and its replay, a replay), SGD at LR
  0.1: every step's loss within 1e-4, each tensor's change within 1e-3
  of its largest change.
- Phase 9, replays against eager steps bit for bit: seesaw-150m cut to
  2 layers of d_model 256; two training steps at micro 1 and two at
  micro 2 (AdamW, bf16), each replayed by the engine and run eagerly
  on a clone of the state before it (parameters, AdamW state with its
  count, metrics), and three decode steps (next tokens, pool).
- Phase 10, checkpoint and adaptive (after phase 4's profile, on its
  trainer): (a) phase 4's run again in a fresh ``Trainer`` with async
  saves every 8 steps (``save_every=8``), stopped by ``stop_fn`` at step
  16, the 8 -> 16 boundary; its steps 1-16 must be phase 4's bit for
  bit. The loop's stall on an async save (the snapshot on the card) is
  timed beside a sync save of the same state. A fresh trainer restores
  with ``verify=True`` and runs steps 17-19; phase 4's trainer, whose
  three graphs are captured, restores the same checkpoint in place and
  replays 17-19 with no capture. Each must end on phase 4's losses, LR,
  batch, phase, parameters, m, v and count bit for bit, and launch the
  five training kernels as phase 4 did over those steps. (b) The same
  model and data under ``adaptive-seesaw`` (``ADAPTIVE``): at least two
  cuts within ``ADAPTIVE_STEPS``, each cutting the LR by 1/sqrt(2) and
  doubling the batch, one graph per (batch size, micro), and a resume
  between the first two cuts ending bit for bit on the uninterrupted run
  with the same cut steps. The controller replayed on the host over the
  run's own losses must give the same cuts; the band of thresholds that
  make them, and the run's margin in it, go into the ``adaptive`` record.
  Each cut's new graph is captured in the background
  (``PhaseEngine.prewarm_async``): the record's ``cuts`` give its
  ``capture_s``, the wait for it at its key's first chunk, that chunk's
  wall and the stall beside the key's steady steps (every chunk timed to
  a sync).  The checkpoints go to a temporary directory the phase
  deletes.
- Phase 1c, the SSD chunk kernel against its plain version, and RMSNorm
  forward and backward at Mamba-2's widths (8192 rows of d = 2560 and
  5120, float32 2e-5 and bfloat16 2e-2, timed in bfloat16).  The kernel: at
  mamba2-2.7b's training shapes (B=4, S=2048, H=80, P=64, N=128, Q=256,
  x, B and C as views of one (B, S, 5376) tensor as the mixer hands
  them over) with its init's decay (A = -(1..80), dt around the
  log-spaced [1e-3, 1e-1]: cum reaches ~-2000 inside a chunk), and at a
  ragged S=1000; float32 and bfloat16.  There the kernel and the float32
  plain version are both held to a float64 evaluation of the plain
  version, and the kernel's error must be at most twice the plain
  version's (float32 sums of such a cum differ by ~1e-4 relative).  At
  small decays (the reduced config's heads, H=8, P=64, N=16, Q=32, and
  a ragged S=100) it is held to the plain version at 2e-5 / 2e-2.  Then
  timed as in phase 1 at the 2.7B shapes in bfloat16 (the bfloat16
  kernel runs on the tensor cores; ``tflops`` counts the causal work of
  the bound, not the split products); no single PyTorch call computes
  this function, so ``library_ms`` is null.  Then the kernel as the
  Mamba-2 serving prefill calls it: one request (B=1) at mamba2-2.7b's
  heads and decay, S = 1, 3, 77, 255, 257 and 768, Q = min(256, S),
  float32 and bfloat16, under the float64 rule above (with one float32
  ulp of the largest output as the least error allowed: at S = 1 or 3 a
  single C·B product sets the plain version's error), and timed in
  bfloat16 (``prefill_shapes`` of its ``kernels`` entry, ``graph_us``
  beside ``ms``); and the RMSNorm forward at a decode step's rows, 8 x
  2560 and 8 x 5120, checked and timed (``mamba2_decode_d*``).
- Phase 6, mamba2-2.7b at full width and depth (64 layers, d_model
  2560, 80 SSD heads, 2.70B parameters), random weights from a seed:
  ``kind="seesaw"``, α=2, B0=4, two cuts, seq 2048, 11·4·2048 tokens,
  base LR 8e-4, ``fuse_steps=1``, ``max_device_batch=4``, bfloat16
  compute with float32 weights and AdamW, remat on, data
  ``MarkovLM(2048, 0)``: B = 4 / 8 / 16 over 7 / 1 / 1 steps, 13
  micro-batches.  Every loss and grad norm must be finite, each step's
  LR, batch size and phase the plan's, the last loss below the first,
  the launch counts exactly, per micro-batch, ``ssd_chunk`` 2L,
  RMSNorm forward 4L+1 and backward 2L+1 (through the replays), and
  the step cache the three keys, as in phase 4.  Reports tokens/s and
  wall time per step at each batch size, capture time, peak memory,
  and a torch.profiler breakdown of one more B=4 step (one replay).
- Phase 7, the reduced mamba2 in float32 on the card against the CPU,
  same weights: loss within 1e-4, grads within 1e-3 of each tensor's
  largest |grad|; then three engine steps on each device, replays on
  the card, as in phase 5.
- Phase 11, mamba2-2.7b served at full width and depth (after phase
  6's trainer is freed): ``ServingEngine`` in its ``"state"`` mode,
  random weights from a seed, bfloat16, 8 slots, max_len 1024, one
  state page per request (h and the conv rows of all 64 layers), phase
  2's request mix.  A warm-up runs the first prefill and decode eagerly
  and captures one graph per distinct prompt length of the mix and the
  decode graph; the timed run must capture nothing.  Every request must
  finish with its max_new_tokens tokens, the pool drain to 0 pages, the
  engine hold one prefill entry per distinct length and one decode
  entry (its budget), the tokens equal those of an engine whose every
  call runs eagerly, and the launches (set to 0 just before the timed
  run) be exactly ``ssd_chunk`` 64 a prefill and the RMSNorm forward
  129 a prefill and a decode step, every other kernel 0.  Reports tok/s
  (and eager), decode steps, occupancy, captures and their seconds,
  peak memory, the pool's bytes, and one replayed decode step under
  torch.profiler (busy share, top kernels) beside its bytes bound.
- Phase 11b, the reduced mamba2 in float32 served on the card and on
  the CPU, same weights: first-token logits within 1e-3 and equal
  greedy tokens over a short mix (prompts of 2-100); and on the card
  the prefill of p[:-8] then 8 decode steps of p's last 8 tokens give
  the logits of the prefill of p within 1e-3.
- Phase 12, the blocking ``Server`` (``repro_torch.train.serve``) over
  the contiguous caches, decoding through one captured graph per
  (batch, cache layout) after an eager first step.  (a) seesaw-150m at
  full width and depth, bf16, max_len 1024: 8 prompts of 500 (bucket
  512), 64 new each; launches exactly flash 12 (one prefill), the
  RMSNorm forward 25 a prefill and a decode step, the ragged decode 12
  a decode step; tokens equal to an all-eager Server's; tok/s, the
  prefill's ms, a replayed step beside its bytes bound.  Then float32:
  phase 2's first 8 requests through the engine (8 slots) and each
  alone through a Server sized to the engine's page window (the
  reference's oracle test): first-token logits within 1e-3, tokens
  equal.  (b) starcoder2-3b at full width and depth (30 layers, GQA
  24/2, hd 128, a 4096-token window), bf16, max_len 8192: a ring of
  4096 slots a layer.  2 prompts of 4,500 with 64 new (the ring built
  from S >= W), 2 of 4,000 with 160 new (the ring wraps at decode step
  97); launches exactly the ragged decode 30 a decode step, the RMSNorm
  forward 61 a prefill and a decode step, flash 0 (windowed layers run
  ``chunked_attention``); tokens equal to an all-eager Server's; tok/s,
  the prefill's seconds, peak memory, a replayed step beside its bytes
  bound and under torch.profiler, and one windowed layer's attention
  at S = 4,500 beside the flash kernel's with no window.  (c) float32:
  starcoder2-3b's width at 4 layers, the prefill of p[:-k] and k decode
  steps against the prefill of p within 1e-3 at (4,090, 12), which
  wraps the ring, and (4,500, 8); the reduced starcoder2 on the card
  and on the CPU, same weights, through the Server: first-token logits
  within 1e-3, tokens equal, over prompts that wrap its 64-slot ring.
  Phase 1 also checks the ragged decode at starcoder2-3b's ring (B=2,
  Skv=4096, H=24, Hkv=2, hd=128) and the RMSNorm forward at 2 x 3072;
  both are timed (the decode at full windows, beside SDPA with GQA and a
  length mask), as is the RMSNorm forward at 1000 x 3072.

- Phase 13, the paper's runs.  (a) The flash forward, dq and dk/dv at
  head_dim 32 (the figure LMs' 4 heads of 32) against their plain
  versions, float32 (2e-5) and bfloat16 (2e-2), at (B, S, H, Hkv) = (8,
  64, 4, 4), (128, 64, 4, 4), (8, 77, 4, 4) and (8, 64, 4, 2); timed in
  bfloat16 at B = 128 and 8 beside SDPA forward and backward and their
  bounds (the ``*/hd32`` entries of the ``kernels`` line).  (b) Every
  suite of ``repro_torch.bench.run`` on the card, in process: every row
  printed, an ``ERROR`` row fails the phase; each of the 7 LM runs
  (figures 1, 4 and 6, bf16, remat off) launches exactly, per
  micro-batch, RMSNorm forward 2L+1 and backward 2L+1, flash forward, dq
  and dk/dv L each (counts set to 0 just before each ``Trainer.run``).
  Then figure 1's model and Seesaw plan in float32 on the card against
  the CPU from the same weights, 10 steps: loss within 1e-4 at every
  step, LR, batch and phase equal.  (c) seesaw-150m at full width and
  depth at its CBS: ``paper_run`` (AdamW 0.9/0.95, 10% warmup, lr 3e-3,
  α = 2, seq 1024, bf16, remat), B0 = ``CBS`` = 256, cut to a horizon of
  20 cosine steps (5,242,880 tokens) and 2 cuts, ``MarkovLM(2048, 0)``,
  micro-batches of 32: cosine 20 steps at 256, Seesaw 14 / 1 / 1 at 256
  / 512 / 1024.  Both must train exactly 5,242,880 tokens on the plan at
  every step, launch exactly (remat's counts), stay finite and fall 0.5
  nats; the loss at the token counts both reach, each run's first step
  and second within 0.05 nats of cosine's final loss, tok/s per batch
  size, captures and peak memory are reported (the ``paper`` line).
- Phase 14, the MoE family and the reference's remaining benchmarks.
  (a) The ragged decode at head_dim 32 against its plain versions, f32
  (2e-5) and bf16 (2e-2): the gathered entry at (B, Skv, H, Hkv) = (4,
  128, 4, 2) (bench.serve's LM), (8, 1024, 4, 4) and (8, 1024, 8, 1)
  (two groups of 4 query heads), the paged entry at 8 slots of those
  heads at pages of 1 and 16; timed in bf16 at the first two beside SDPA
  with a length mask and the bytes bound (``ragged_decode/hd32`` in the
  ``kernels`` line; its launches are 14d's bench.serve run's).  (b)
  granite-moe-1b-a400m at full width and depth (24 layers, d 1024, GQA
  16/8, 32 experts, top-8, d_expert 512, vocab 49,155; 1.33B
  parameters), seeded weights, bf16 compute, float32 weights and AdamW,
  remat: Seesaw α = 2, B0 = 8, one cut, seq 1024, 10·8·1024 tokens,
  ``fuse_steps=4``, ``max_device_batch=8``, ``MarkovLM(2048, 0)``: 7
  steps at B = 8 and 2 at B = 16 (micro 2).  Each step's LR, batch and
  phase the plan's, the losses finite and falling, ``lb_loss``,
  ``rz_loss`` and ``frac_dropped`` recorded every step, the launches per
  micro-batch exactly remat's (RMSNorm forward 4L+1 = 97, backward 49,
  flash 48, dq and dk/dv 24), one graph per (batch size, micro); tok/s
  per batch size with captures apart, peak memory and a profile of one
  replayed B = 8 step; then a step at B = 8 and one at B = 16, each
  replayed and run eagerly on a clone of the state, bit for bit.  The
  reduced granite in f32 on the card against the CPU (phase 5's gates
  and three engine steps each), and one layer's MoE at full width (B =
  8 x 1024, f32, capacity factor 0.5, which drops half the choices)
  against the one-hot ``moe_forward_ref``: y within 1e-5, the kept sets
  equal.  (c) granite-moe-1b served from the paged engine: phase 2's
  cell and gates (bf16, 8 slots, page 16, max_len 1024, 16 requests,
  graphs against an all-eager engine, token for token), a replayed
  decode step with every slot live against its bytes bound (every weight
  read once, each slot's K and V to its length) and under
  torch.profiler; then the f32 engine against each request alone
  through a Server (phase 12a's oracle).  (d) The reference's
  ``engine`` and ``serve`` suites (``bench/engine.py``,
  ``bench/serve.py``: every row, ``check_compiles`` with no error; the
  adaptive compiles record too) and the checkpoint benchmark
  (``bench/checkpoint.py``: ``check_stall``, ``check_schema``), in
  process, and ``examples.serve_decode --arch granite-moe-1b-a400m``
  (its reduced config, bf16).  The ``moe`` line holds it all.
- Phase 15, the RG-LRU hybrid (recurrentgemma-9b, arXiv:2402.19427).
  (a) The RG-LRU scan kernels (``csrc/rglru_scan.cu``: the recurrence
  and its reverse sweep; the reference has no Pallas kernel here)
  against their plain versions in float32, within 2e-5 of each output's
  max, at 15b's micro-batch (4, 1024, 4096) and 15c's prefill (2, 2500,
  4096, with h0); the ragged decode at head_dim 256 on recurrentgemma's
  ring (B=2, Skv=2048, H=16 on one kv head) and paged (8 slots, pages of
  16), f32 (2e-5) and bf16 (2e-2); RMSNorm forward and backward at d
  4096 (4,096 rows and a decode step's 2).  Each timed as phase 1
  times, beside its bound, its plain version and a library call (SDPA
  with GQA and a mask for the decode, ``F.rms_norm`` for RMSNorm; none
  computes a linear recurrence).  (b) recurrentgemma-9b at full width
  cut to 5 layers (2.97B parameters, 47.5 GB of float32 weights, grads
  and AdamW state), bf16 compute, remat: Seesaw alpha = 2, one cut, 6
  steps at B = 4 and 2 at B = 8 (micro 2) of 1024, ``MarkovLM(2048,
  0)``: each step's LR, batch and phase the plan's, the loss falling,
  every kernel's launches exactly remat's per micro-batch (RMSNorm 21 /
  11, the scan 8 and its backward 4, flash 0), one graph per (batch
  size, micro); tok/s, peak and a profile of one replayed B = 4 step.
  Then the same widths with the vocabulary cut to 2048: a replayed step
  at B = 4 and one at B = 8 against eager steps on a clone of the state,
  bit for bit; and the reduced hybrid in f32 on the card against the
  CPU (loss 1e-4, grads 1e-3 of each tensor's max), and its three SGD
  steps at LR 0.1 split four ways (the card with the scan kernel and
  with the plain chunked scan, the CPU with the plain chunked scan and
  with a sequential loop, the kernel's order): per tensor, the card's
  kernel run within twice the CPU's order spread (or 1e-4) of the card's
  plain run, and that within 1e-3 of the CPU's.  (c) recurrentgemma-
  9b at full width and depth (38 layers, 17.1 GB in bf16) through the
  ``Server`` (max_len 4096: a 2048-slot ring in each attention layer): 2
  prompts of 2,500 with 64 new (the ring built from S >= W), and
  batches of 1- and 2-token prompts, through one captured decode graph:
  launches exact (the scan 26 a prefill, the ragged decode 12 and the
  RMSNorm forward 77 a decode step), tokens equal to an all-eager
  Server's; tok/s, the prefill's ms split into windowed attention, scan
  and the rest, a replayed decode step beside its bytes bound and
  under torch.profiler, peak memory; the reduced hybrid in f32 on the
  card against the CPU through the Server (first-token logits 1e-3,
  tokens equal).  The ``hybrid`` line holds it all.
- Phase 16, the last families.  (a) The flash forward, dq and dk/dv
  and the ragged decode (gathered and paged) at hd 128 with GQA groups
  of 8 (internvl2-76b's 64/8) and 7 (yi-34b's 56/8: the decode serves a
  group in blocks of 4 heads, so a tail of 3), the RMSNorm forward at d
  8192; f32 (2e-5) and bf16 (2e-2), then timed beside their bounds,
  plain versions and SDPA / ``F.rms_norm``; the float32 dk/dv at
  starcoder2-3b's prompt (S = 4,500, GQA 24/2) and its plain version,
  each against float64: the kernel no further off than the plain
  version, or within 2e-5.  (b) seamless-m4t-medium
  (the enc-dec) trained at full width and depth through the engine's
  grad step: bf16 compute, float32 weights and AdamW, remat, Seesaw
  alpha = 2 with one cut (B = 4, then 8 at micro 2), each example 1,024
  seeded normal frames and 1,024 ``MarkovLM(2048, 0)`` tokens: LR and
  batch the plan's, the loss falling, launches exactly remat's, replays
  equal to eager steps bit for bit, the reduced seamless card against
  CPU (loss 1e-4, grads 1e-3); tok/s, step ms, peak, the held and the
  counted parameters.  (c) seamless-m4t-medium through the ``Server``:
  2 sources of 1,024 frames, prompts of 16, 64 new, one decode graph
  (its cross-attention through the ragged decode over the frames),
  launches exact, tokens equal to an all-eager Server's; tok/s, the
  prefill split into encoder, decoder and head, a replayed decode step
  against its bytes bound, the peak; the reduced seamless card against
  CPU (logits 1e-3, tokens equal).  (d) internvl2-76b at full width cut
  to 16 layers through the bucketed ``Server``: 2 prompts of a 1,024-
  patch prefix and 64 text tokens, 32 new, the same gates and reports,
  and the reduced internvl card against CPU.  (e) mistral-nemo-12b at
  full width and depth through the paged engine on phase 2's mix:
  tokens equal to an all-eager engine's, tok/s beside eager tok/s, a
  replayed decode step against its bound.  The ``families`` line holds
  it all.
- Phase 17, data parallelism (``phase17``): ``python -m
  repro_torch.launch.train``'s ``main`` as two processes on the one card
  (``--coordinator 127.0.0.1:<free port> --num-processes 2 --process-id
  r --per-host``: a gloo group, since the ranks share the card) and as
  one, seesaw-150m at full width and depth (``DP_ARGS``: bf16, AdamW,
  Seesaw alpha = 2 from B = 8 to 16, at most 8 rows a micro-batch, 8
  steps, ``MarkovLM(2048)``).  Two ranks train steps 1-4 alone and
  save; then side by side two ranks resume for 5-8, one process resumes
  the same save, and one process trains the whole plan.  The
  ranks must log one run, the runs must match the one process's (steps,
  LR, batch and phase equal, loss and grad norm within 2e-2, each
  leaf's weights apart by at most a quarter of its update), the save's
  writers must rotate over
  the ranks, and each process must launch the training kernels exactly
  remat's counts times its micro-batches.  The ``data_parallel`` line
  gives the walls, the all-reduce's ms a step, each rank's peak memory
  and the largest differences.
- Phase 18, the model axis (``phase18``): processes on the one card as a
  data x model mesh (gloo; FSDP over data, tensor-parallel over model,
  ``repro_torch.parallel``), each step eager.  (a) float32, the same
  weights (the trainer's seed) and rows, 2 steps at B = 8: seesaw-150m
  at full width and depth on a 2x2 mesh and llama3.2-3b at full width
  cut to 2 layers on a 1x2 mesh (``MESH_RANK``), each against one
  process: the first batch's loss within 1e-4 and every gathered grad
  within 1e-3 of its leaf's max, grad norm within 1e-3 relative, then
  the two steps' loss (1e-4) and grad norm (1e-3).  (b) bf16,
  seesaw-150m through the launcher (``MESH_ARGS`` + ``--mesh 2x2``): a
  Seesaw alpha = 2 ramp from B = 8 to 16 (4 + 2 steps) at lr 1e-4 (at
  phase 17's 3e-3 the run spikes and parts two float32 runs by 29% in
  grad norm within 6 steps; ``MESH_LR``), four ranks
  alone for steps 1-4 and a 2x2 save; then side by side the four ranks
  resume for 5-6, one process resumes the save and one trains the whole
  plan.  The one-process restore of the 2x2 save equals its blocks bit
  for bit; the history equals the one process's (steps, tokens, LR,
  batch, phase; loss and grad norm within 2e-2); the save's leaves have
  several blocks and their writers rotate over the four ranks.  Every
  process launches the five training kernels exactly remat's counts
  times its micro-batches.  The ``mesh`` line gives a step's wall, each
  kind of collective's ms and MB a step, each rank's peak memory and
  the differences.  No speed is claimed: the ranks share one card.
- Phase 8, the kernel benchmark: ``repro_torch.bench.kernels`` at full
  size through its ``main`` (the reference's attention, RMSNorm and SSD
  sweeps in float32, kernel and plain, forward and forward+backward; the
  overlap profile at 8192 x 512 over block rows 1-32 and depth 1-8),
  written to ``chiprun_out/bench_kernels.json``.  Every overlap config
  run must be within 2e-5 of the plain version; every sweep row must
  hold its four times, and its outputs and grads must be within 2e-5
  abs/rel of the plain version's on the same inputs (RMSNorm's dscale,
  a sum over every row, within 2e-5 of its terms' magnitude, as in
  phase 1b); the seven kernels
  on the benchmark's path
  (RMSNorm forward and backward, flash forward, dq, dk/dv, the SSD
  chunk, the overlap normalize) must each be launched in the run.

Prints the card's name and power limit, one ``kernels`` JSON line (the
eight kernels, the flash kernels at hd 32, the ragged decode at hd 32
and 256, the RG-LRU scan pair, and on the flash, decode and RMSNorm
entries the shapes of phase 16), one ``engine`` and one ``train``
JSON line (phase 9's result in the latter), one ``mamba2`` JSON line,
one ``mamba2_serve``
line (phases 11 and 11b, with the card), one ``server`` line (phase
12), one ``paper`` line (phase 13), one ``moe`` line (phase 14), one
``hybrid`` line (phase 15), one ``families`` line (phase 16), one
``data_parallel`` line (phase 17), one ``mesh`` line (phase 18), one
``checkpoint`` line
(phase 10: bytes written, write, restore and verify seconds and GB/s,
the async save's stall beside a sync save's time, the adaptive run's
cuts, the card's name and power limit), and last ``{"ok": true,
"device": {...}}``; the
full record goes to ``chiprun_out/chip_smoke.json``.  Any failed check
raises, so the script exits non-zero before the last line.  Without a
CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.bench.timing import GraphTimer, Timer, bound  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
DTYPES = (torch.float32, torch.bfloat16)
# (B, S, H, Hkv, hd, tag): lengths that start, fill, cross and overrun the
# bf16 flash kernels' 16-row warp tiles and 32/64-row block tiles, at hd 64
# (MHA) and hd 128 (GQA groups of 3)
FLASH_EDGES = tuple((B, S, H, Hkv, hd, f"edge-S{S}-hd{hd}")
                    for B, H, Hkv, hd in ((2, 4, 4, 64), (1, 6, 2, 128))
                    for S in (1, 15, 16, 63, 64, 65, 129))
# the prompt buckets phase 2's mix prefills (rows of d_model 1024); the
# largest is phase 1's "prefill" shape
PREFILL_BUCKETS = (64, 128, 256, 512)
# prompt lengths at which phase 1c holds the SSD chunk kernel as the
# Mamba-2 serving prefill calls it (B = 1, Q = min(256, S)): a chunk of
# 1 and of d_conv - 1 steps, chunks that are no multiple of 16 or 64,
# one step past a chunk, three chunks
PREFILL_SSD_S = (1, 3, 77, 255, 257, 768)
F32_EPS = float(torch.finfo(torch.float32).eps)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def max_err(got, want, dtype) -> float:
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    return err


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #

def rmsnorm_case(RN, ref, rows, d, dtype, g):
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    s = 0.1 * torch.randn(d, generator=g, device="cuda")
    got = RN.rmsnorm_fwd(x, s, 1e-5)
    torch.cuda.synchronize()
    return x, s, max_err(got, ref.rmsnorm_ref(x, s, 1e-5), dtype)


def flash_case(FA, ref, B, S, H, Hkv, hd, dtype, g):
    # the models' (B, S, H, hd) layout, read through transposed views
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out, lse = FA.flash_fwd(qt, kt, vt)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref(qt, kt, vt)
    err = max_err(out, want, dtype)
    max_err(lse, want_lse, dtype)
    return (qt, kt, vt), err


def decode_case(PG, ref, B, Skv, H, Hkv, hd, dtype, g, rng):
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    # a gathered head-interleaved page window, split into strided views
    kv = torch.randn(B, Skv, 2 * Hkv, hd, generator=g,
                     device="cuda").to(dtype)
    k, v = kv[:, :, 0::2].transpose(1, 2), kv[:, :, 1::2].transpose(1, 2)
    lens = rng.integers(64, Skv, B).astype(np.int32)
    lens[0] = 0                                  # an inactive slot
    lengths = torch.from_numpy(lens).cuda()
    got = PG.ragged_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    err = max_err(got, ref.ragged_decode_ref(q, k, v, lengths), dtype)
    return (q, k, v, lengths, lens, kv), err


def paged_case(PG, ref, B, window, H, Hkv, hd, ps, dtype, g, rng):
    """A random pool and a shuffled page table: lengths ps - 1, ps, ps + 1
    (the page edges), an inactive slot (length 0, all-null row), the
    window's last key, the rest random; live pages distinct and shuffled,
    the other entries the null page 0, whose data is random too."""
    P = window // ps
    lens = rng.integers(1, window, B)
    lens[:5] = [ps - 1, ps, ps + 1, 0, window - 1]
    need = [0 if b == 3 else int(n) // ps + 1 for b, n in enumerate(lens)]
    n_pages = sum(need) + 5
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, P), np.int64)
    used = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[used:used + n]
        used += n
    pool = torch.randn(n_pages, ps, 2 * Hkv, hd, generator=g,
                       device="cuda").to(dtype)
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    pages = torch.from_numpy(table).cuda()
    lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
    got = PG.paged_decode_attention_pool(q, pool, pages, lengths,
                                         page_size=ps)
    torch.cuda.synchronize()
    return max_err(got, ref.paged_decode_ref(q, pool, pages, lengths,
                                             page_size=ps), dtype)


def phase1(RN, FA, PG, ref):
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for rows, d, tag in ((1024, 1024, "prefill"), (8, 1024, "decode"),
                             (1000, 3072, "llama"),
                             (2, 3072, "starcoder2-decode"),
                             *((n, 1024, f"bucket{n}")
                               for n in PREFILL_BUCKETS)):
            x, s, err = rmsnorm_case(RN, ref, rows, d, dtype, g)
            errors.append(("rmsnorm_fwd", tag, dn, err))
            inputs[("rmsnorm_fwd", tag, dn)] = (x, s)
        for B, S, H, Hkv, hd, tag in ((1, 1024, 16, 16, 64, "seesaw"),
                                      (1, 1000, 24, 8, 128, "llama"),
                                      *FLASH_EDGES):
            t, err = flash_case(FA, ref, B, S, H, Hkv, hd, dtype, g)
            errors.append(("flash_fwd", tag, dn, err))
            inputs[("flash_fwd", tag, dn)] = t
        for B, Skv, H, Hkv, hd, tag in ((8, 1024, 16, 16, 64, "seesaw"),
                                        (8, 1008, 24, 8, 128, "llama"),
                                        (2, 4096, 24, 2, 128, "starcoder2")):
            t, err = decode_case(PG, ref, B, Skv, H, Hkv, hd, dtype, g, rng)
            errors.append(("ragged_decode", tag, dn, err))
            inputs[("ragged_decode", tag, dn)] = t
            if tag == "starcoder2":
                continue        # the Server's ring is a gathered window
            for ps in (1, 4, 16):
                err = paged_case(PG, ref, B, Skv, H, Hkv, hd, ps, dtype, g,
                                 rng)
                errors.append(("paged_decode", f"{tag}-ps{ps}", dn, err))
    for name, tag, dn, err in errors:
        log(f"phase 1: {name} {tag} {dn}: max |err| {err:.3g}")
    return errors, inputs


def paged_window(kv, ps, seed=0):
    """The gathered window kv (B, Skv, 2·Hkv, hd) scattered into a pool of
    pages of ``ps`` under a shuffled page table (every page of the window
    allocated, page 0 left null): (pool, pages (B, Skv / ps) int64)."""
    B, Skv = kv.shape[:2]
    P = Skv // ps
    ids = np.random.default_rng(seed).permutation(np.arange(1, B * P + 1))
    pages = torch.from_numpy(ids.reshape(B, P).astype(np.int64)).cuda()
    pool = torch.zeros(B * P + 1, ps, *kv.shape[2:], dtype=kv.dtype,
                       device="cuda")
    pool[pages] = kv.reshape(B, P, ps, *kv.shape[2:])
    return pool, pages


def measure(RN, FA, PG, ref, SC, inputs):
    """Kernel, plain and library times at the serving path's shapes in
    bfloat16, each with its bound; the decode kernel's paged entry at the
    same lengths with page 16 (which must agree with its gathered entry
    to 2e-2), and ``gather_pages`` alone at that table."""
    timer, graph_timer = Timer(), GraphTimer()
    bf = torch.bfloat16
    rows = {}

    def row(name, key, kernel, plain, library, b):
        rows[name] = dict(ms=timer(kernel), plain_ms=timer(plain),
                          library_ms=timer(library),
                          host_us=timer.host_us(kernel),
                          library_host_us=timer.host_us(library),
                          shape=key, **b)

    for tag in ("prefill", "decode", "llama", "starcoder2-decode"):
        x, s = inputs[("rmsnorm_fwd", tag, "bfloat16")]
        w = (1.0 + s).to(bf)
        d = x.shape[-1]
        row(f"rmsnorm_fwd/{tag}", f"x ({x.shape[0]}, {d}) bf16",
            lambda: RN.rmsnorm_fwd(x, s, 1e-5),
            lambda: ref.rmsnorm_ref(x, s, 1e-5),
            lambda: F.rms_norm(x, (d,), w, 1e-5),
            bound(2 * x.numel() * x.element_size() + 4 * d,
                  4 * x.numel(), bf))
        rows[f"rmsnorm_fwd/{tag}"].update(
            graph_us=graph_timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            library_graph_us=graph_timer(
                lambda: F.rms_norm(x, (d,), w, 1e-5)))
    # the other prompt buckets, cold and as the prefill graphs replay them
    for n in PREFILL_BUCKETS:
        x, s = inputs[("rmsnorm_fwd", f"bucket{n}", "bfloat16")]
        w = (1.0 + s).to(bf)
        d = x.shape[-1]
        rows[f"rmsnorm_fwd/bucket{n}"] = dict(
            ms=timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            library_ms=timer(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            graph_us=graph_timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            library_graph_us=graph_timer(
                lambda: F.rms_norm(x, (d,), w, 1e-5)),
            shape=f"x ({n}, {d}) bf16",
            **bound(2 * x.numel() * x.element_size() + 4 * d,
                    4 * x.numel(), bf))

    qt, kt, vt = inputs[("flash_fwd", "seesaw", "bfloat16")]
    B, H, S, hd = qt.shape
    es = qt.element_size()
    row("flash_fwd", f"q (B={B}, S={S}, H={H}, hd={hd}) bf16, causal",
        lambda: FA.flash_fwd(qt, kt, vt),
        lambda: ref.attention_ref(qt, kt, vt),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        bound(4 * qt.numel() * es + 4 * B * H * S,
              4 * B * H * hd * S * (S + 1) / 2, bf))

    q, k, v, lengths, lens, kv = inputs[("ragged_decode", "seesaw",
                                         "bfloat16")]
    B, H, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    keys = float(np.sum(lens.astype(np.int64) + 1))
    mask = (torch.arange(Skv, device="cuda")[None, :]
            <= lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None]
    row("ragged_decode",
        f"q (B={B}, H={H}, hd={hd}), window Skv={Skv}, lengths "
        f"{lens.tolist()} bf16",
        lambda: PG.ragged_decode_attention(q, k, v, lengths),
        lambda: ref.ragged_decode_ref(q, k, v, lengths),
        lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask),
        bound(2 * q.numel() * es + 2 * keys * Hkv * hd * es + 4 * B,
              4 * keys * H * hd, bf))

    # the same window at lengths that fit one split of the kernel (no
    # merge) and at full windows (every split, then the merge)
    for tag, n in (("one_split", 100), ("full_window", Skv - 1)):
        ln = torch.full((B,), n, dtype=torch.int32, device="cuda")
        mk = (torch.arange(Skv, device="cuda")[None, :]
              <= ln.long()[:, None])[:, None, None, :]
        nk = float(B * (n + 1))
        row(f"ragged_decode/{tag}",
            f"the same q and window, every length {n}",
            lambda: PG.ragged_decode_attention(q, k, v, ln),
            lambda: ref.ragged_decode_ref(q, k, v, ln),
            lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mk),
            bound(2 * q.numel() * es + 2 * nk * Hkv * hd * es + 4 * B,
                  4 * nk * H * hd, bf))

    # starcoder2-3b's ring after a wrap: every one of the W = 4096 slots
    # in the window (lengths W - 1), the Server's decode at batch 2
    q2, k2, v2, _, _, _ = inputs[("ragged_decode", "starcoder2",
                                  "bfloat16")]
    B2, H2, _ = q2.shape
    Hkv2, W = k2.shape[1], k2.shape[2]
    ln = torch.full((B2,), W - 1, dtype=torch.int32, device="cuda")
    got = PG.ragged_decode_attention(q2, k2, v2, ln)
    torch.cuda.synchronize()
    ring_err = max_err(got, ref.ragged_decode_ref(q2, k2, v2, ln), bf)
    nk = float(B2 * W)
    row("ragged_decode/starcoder2",
        f"q (B={B2}, H={H2}, hd={q2.shape[2]}), ring Skv={W}, Hkv={Hkv2}, "
        f"every length {W - 1} bf16",
        lambda: PG.ragged_decode_attention(q2, k2, v2, ln),
        lambda: ref.ragged_decode_ref(q2, k2, v2, ln),
        lambda: F.scaled_dot_product_attention(
            q2[:, :, None], k2, v2, attn_mask=(
                torch.arange(W, device="cuda")[None, :]
                <= ln.long()[:, None])[:, None, None, :], enable_gqa=True),
        bound(2 * q2.numel() * es + 2 * nk * Hkv2 * q2.shape[2] * es
              + 4 * B2, 4 * nk * H2 * q2.shape[2], bf))
    rows["ragged_decode/starcoder2"]["max_abs_err"] = ring_err

    # the same window and lengths read through a page table of 16
    ps = 16
    pool, pages = paged_window(kv, ps)
    want = PG.ragged_decode_attention(q, k, v, lengths)
    got = PG.paged_decode_attention_pool(q, pool, pages, lengths,
                                         page_size=ps)
    torch.cuda.synchronize()
    paged_vs_gathered = max_err(got, want, bf)
    n_table = float(np.sum((lens.astype(np.int64) + ps) // ps))
    rows["ragged_decode/paged"] = dict(
        ms=timer(lambda: PG.paged_decode_attention_pool(
            q, pool, pages, lengths, page_size=ps)),
        plain_ms=timer(lambda: ref.paged_decode_ref(
            q, pool, pages, lengths, page_size=ps)),
        host_us=timer.host_us(lambda: PG.paged_decode_attention_pool(
            q, pool, pages, lengths, page_size=ps)),
        max_abs_err_vs_gathered=paged_vs_gathered,
        shape=f"the same q and lengths, K/V read through a shuffled page "
              f"table ({B} x {pages.shape[1]} pages of {ps}) bf16",
        **bound(2 * q.numel() * es + 2 * keys * Hkv * hd * es + 4 * B
                + 8 * n_table, 4 * keys * H * hd, bf))
    rows["gather_pages"] = dict(
        ms=timer(lambda: SC.gather_pages(pool, pages, page_size=ps)),
        shape=f"pool[pages] of a ({B}, {pages.shape[1]}) table, pages of "
              f"{ps} x {2 * Hkv} x {hd} bf16: the window copy the serving "
              f"step made before each decode launch, per layer",
        **bound(2 * pool[pages].numel() * es + 8 * pages.numel(), 0, bf))
    return rows


# --------------------------------------------------------------------- #
# phase 1b: backward kernels against their plain versions
# --------------------------------------------------------------------- #

def dscale_rel_err(x, gy, ds, want, eps=1e-5) -> float:
    """RMSNorm's dscale is a float32 sum over every row, taken in another
    order than the plain version's: its error, over the sum of the
    terms' magnitudes, must stay within 2e-5."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    xh = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    mag = (gy.float().reshape(-1, d) * xh).abs().sum(0) + 1e-30
    rel = float(((ds - want).abs() / mag).max())
    if rel > 2e-5:
        raise AssertionError(f"dscale: error {rel:.3g} of the terms' "
                             f"magnitude > 2e-5")
    return rel


def phase1b(RN, FA, ref):
    g = torch.Generator(device="cuda").manual_seed(10)
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for rows, d, tag in ((8 * 1024, 1024, "train"),
                             (1000, 3072, "llama"),
                             (150, 2560, "few-rows")):
            x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
            s = 0.1 * torch.randn(d, generator=g, device="cuda")
            gy = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
            dx, ds = RN.rmsnorm_bwd(x, s, gy, 1e-5)
            torch.cuda.synchronize()
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, gy, 1e-5)
            errors.append(("rmsnorm_bwd", tag, dn,
                           max_err(dx, want_dx, dtype)))
            errors.append(("rmsnorm_bwd/dscale_rel", tag, dn,
                           dscale_rel_err(x, gy, ds, want_ds)))
            inputs[("rmsnorm_bwd", tag, dn)] = (x, s, gy)
            if tag == "train":
                # the forward at the dense training shape (the staged
                # form), on the x that measure_bwd times it at
                y = RN.rmsnorm_fwd(x, s, 1e-5)
                torch.cuda.synchronize()
                errors.append(("rmsnorm_fwd", tag, dn, max_err(
                    y, ref.rmsnorm_ref(x, s, 1e-5), dtype)))
                del y
        for B, S, H, Hkv, hd, tag in ((8, 1024, 16, 16, 64, "seesaw"),
                                      (1, 1000, 24, 8, 128, "llama"),
                                      *FLASH_EDGES):
            q, k, v, do = (torch.randn(B, S, n, hd, generator=g,
                                       device="cuda").to(dtype)
                           for n in (H, Hkv, Hkv, H))
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            out, lse = FA.flash_fwd(qt, kt, vt)
            torch.cuda.synchronize()
            # the forward at the shapes training gives it, before the
            # backward reads its out and lse
            want, want_lse = ref.attention_ref(qt, kt, vt)
            errors.append(("flash_fwd", f"bwd-{tag}", dn,
                           max_err(out, want, dtype)))
            max_err(lse, want_lse, dtype)
            del want, want_lse
            dq, dk, dv = FA.flash_bwd(qt, kt, vt, out, lse, dot)
            torch.cuda.synchronize()
            wq, wk, wv = ref.flash_bwd_ref(qt, kt, vt, out, lse, dot)
            errors.append(("flash_bwd_dq", tag, dn, max_err(dq, wq, dtype)))
            errors.append(("flash_bwd_dkv", tag, dn,
                           max(max_err(dk, wk, dtype),
                               max_err(dv, wv, dtype))))
            inputs[("flash_bwd", tag, dn)] = (qt, kt, vt, out, lse, dot)
            del dq, dk, dv, wq, wk, wv
    for name, tag, dn, err in errors:
        log(f"phase 1b: {name} {tag} {dn}: max |err| {err:.3g}")
    return errors, inputs


def measure_bwd(RN, FA, ref, inputs):
    """Backward kernel, plain and library times at the training shapes in
    bfloat16, each with its bound.  The plain version and the library
    call compute dq, dk and dv together, so the two flash rows share
    them."""
    timer = Timer(iters=20)
    bf = torch.bfloat16
    rows = {}

    x, s, gy = inputs[("rmsnorm_bwd", "train", "bfloat16")]
    n, d = x.shape
    es = x.element_size()
    xr = x.detach().clone().requires_grad_()
    w = (1.0 + s).to(bf).requires_grad_()
    y = F.rms_norm(xr, (d,), w, 1e-5)
    rows["rmsnorm_bwd"] = dict(
        ms=timer(lambda: RN.rmsnorm_bwd(x, s, gy, 1e-5)),
        plain_ms=timer(lambda: ref.rmsnorm_bwd_ref(x, s, gy, 1e-5)),
        library_ms=timer(lambda: torch.autograd.grad(
            y, (xr, w), gy, retain_graph=True)),
        host_us=timer.host_us(lambda: RN.rmsnorm_bwd(x, s, gy, 1e-5)),
        shape=f"x, g ({n}, {d}) bf16; dx and dscale from one launch",
        **bound(3 * n * d * es + 8 * d, 12 * n * d, bf))
    del xr, w, y
    # the forward at the training shape (4L+1 launches a micro-batch)
    wb = (1.0 + s).to(bf)
    rows["rmsnorm_fwd/train"] = dict(
        ms=timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
        plain_ms=timer(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
        library_ms=timer(lambda: F.rms_norm(x, (d,), wb, 1e-5)),
        graph_us=GraphTimer()(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
        library_graph_us=GraphTimer()(lambda: F.rms_norm(x, (d,), wb,
                                                         1e-5)),
        shape=f"x ({n}, {d}) bf16",
        **bound(2 * n * d * es + 4 * d, 4 * n * d, bf))

    flash = flash_rows(FA, ref, inputs[("flash_bwd", "seesaw", "bfloat16")],
                       timer)
    rows.update({"flash_bwd_dq": flash["dq"], "flash_bwd_dkv": flash["dkv"],
                 "flash_bwd": flash["bwd"], "flash_fwd/train": flash["fwd"]})
    return rows


def flash_rows(FA, ref, t, timer):
    """The flash forward, dq and dk/dv timed on one (q, k, v, out, lse,
    do) in bfloat16 (MHA or GQA), each beside its plain version, one PyTorch call and
    its bound: ``fwd``, ``dq``, ``dkv`` and ``bwd`` (delta, dq and dk/dv
    through ``flash_bwd``).  The plain version and the library call
    compute dq, dk and dv together, so the two backward rows share
    them."""
    bf = torch.bfloat16
    qt, kt, vt, out, lse, dot = t
    B, H, S, hd = qt.shape
    Hkv = kt.shape[1]
    es = qt.element_size()
    delta = (dot.float() * out.float()).sum(-1).reshape(B * H, S) \
        .contiguous()
    pairs = B * H * S * (S + 1) / 2
    reads = (2 * B * H + 2 * B * Hkv) * S * hd * es + 8 * B * H * S
    qa, ka, va = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    gqa = H != Hkv
    o = F.scaled_dot_product_attention(qa, ka, va, is_causal=True,
                                       enable_gqa=gqa)
    plain_ms = timer(lambda: ref.flash_bwd_ref(qt, kt, vt, out, lse, dot))
    library_ms = timer(lambda: torch.autograd.grad(
        o, (qa, ka, va), dot, retain_graph=True))
    shape = f"q (B={B}, S={S}, H={H}, hd={hd}), Hkv={Hkv} bf16, causal"
    rows = {}
    rows["dq"] = dict(
        ms=timer(lambda: FA.flash_bwd_dq(qt, kt, vt, dot, lse, delta)),
        plain_ms=plain_ms, library_ms=library_ms,
        host_us=timer.host_us(
            lambda: FA.flash_bwd_dq(qt, kt, vt, dot, lse, delta)),
        shape=shape, **bound(reads + B * H * S * hd * es, 6 * hd * pairs,
                             bf))
    rows["dkv"] = dict(
        ms=timer(lambda: FA.flash_bwd_dkv(qt, kt, vt, dot, lse, delta)),
        plain_ms=plain_ms, library_ms=library_ms,
        host_us=timer.host_us(
            lambda: FA.flash_bwd_dkv(qt, kt, vt, dot, lse, delta)),
        shape=shape, **bound(reads + 2 * B * Hkv * S * hd * es,
                             8 * hd * pairs, bf))
    rows["bwd"] = dict(
        ms=timer(lambda: FA.flash_bwd(qt, kt, vt, out, lse, dot)),
        shape=shape + "; delta, dq and dk/dv")
    # the forward, as remat launches it 2L times a micro-batch (L without)
    rows["fwd"] = dict(
        ms=timer(lambda: FA.flash_fwd(qt, kt, vt)),
        plain_ms=timer(lambda: ref.attention_ref(qt, kt, vt)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)),
        shape=shape,
        **bound((2 * B * H + 2 * B * Hkv) * S * hd * es + 4 * B * H * S,
                4 * hd * pairs, bf))
    return rows


def compiled_report(_build, lib):
    """What the build made of the flash, SSD chunk and RMSNorm backward
    kernels: per instantiation, the count of HMMA (mma.sync)
    instructions in its SASS (``cuobjdump -sass``) and ptxas's registers
    and spill bytes.  The bfloat16 forward, dq and dk/dv kernels must
    hold HMMA and spill nothing at hd 64, the bfloat16 SSD chunk kernel
    must hold HMMA and spill nothing; their float32 forms must hold
    none."""
    regs = _build.ptxas_report(lib)
    hmma = _build.sass_counts(lib, "HMMA")
    out = {}
    for mangled, r in regs.items():
        m = re.search(r"(flash_[a-z_]+?_kernel)ILi(\d+)E", mangled)
        if m:
            name, hd = m.groups()
            # the CUDA-core forms are float32 alone, the mma forms
            # bfloat16 alone
            dtype = "bfloat16" if name.endswith("_mma_kernel") else "float32"
            out[f"{name}<{dtype}, hd {hd}>"] = dict(hmma=hmma[mangled], **r)
        if "ssd_chunk_mma_kernel" in mangled:
            out["ssd_chunk_mma_kernel<bfloat16>"] = dict(hmma=hmma[mangled],
                                                         **r)
        m = re.search(r"(ssd_chunk|rmsnorm_bwd)_kernelI(f|13__nv_bfloat16)E",
                      mangled)
        if m:
            dtype = "float32" if m.group(2) == "f" else "bfloat16"
            out[f"{m.group(1)}_kernel<{dtype}>"] = dict(hmma=hmma[mangled],
                                                        **r)
        m = re.search(r"(rglru_scan_(?:fwd|bwd))_kernel", mangled)
        if m:
            out[f"{m.group(1)}_kernel"] = dict(hmma=hmma[mangled], **r)
        m = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                      r"Li(\d+)E", mangled)
        if m:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            out[f"paged_decode_kernel<{dtype}, hd {m.group(2)}, "
                f"{m.group(3)} heads>"] = dict(**r)
    tc, f32 = (out["ssd_chunk_mma_kernel<bfloat16>"],
               out["ssd_chunk_kernel<float32>"])
    if not tc["hmma"] > 0 or f32["hmma"] != 0 \
            or tc["spill_stores"] or tc["spill_loads"]:
        raise AssertionError(f"ssd_chunk: HMMA and spills in the bf16 form "
                             f"{tc}, HMMA in the f32 form {f32}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for hd in (32, 64, 128):
            tc = out[f"{name}_mma_kernel<bfloat16, hd {hd}>"]
            f32 = out[f"{name}_kernel<float32, hd {hd}>"]
            if not tc["hmma"] > 0 or f32["hmma"] != 0:
                raise AssertionError(f"{name} hd {hd}: HMMA in the bf16 "
                                     f"form {tc}, in the f32 form {f32}")
            if hd == 64 and (tc["spill_stores"] or tc["spill_loads"]):
                raise AssertionError(f"{name} bf16 hd 64 spills: {tc}")
    return out


# --------------------------------------------------------------------- #
# phase 1c: the SSD chunk kernel against its plain version
# --------------------------------------------------------------------- #

def ssd_inputs(B, S, H, P, N, dtype, g, mamba_decay):
    """x, B, C as views of one (B, S, H·P + 2N) tensor, as the mixer hands
    them to the kernel.  ``mamba_decay``: mamba2-2.7b's init (A =
    -(1..H), dt = softplus(dt_bias + 0.5·noise) around its log-spaced
    [1e-3, 1e-1]); else small decays (A = -exp(0.3·noise), dt =
    softplus(noise))."""
    di = H * P
    xbc = torch.randn(B, S, di + 2 * N, generator=g, device="cuda").to(dtype)
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    noise = torch.randn(B, S, H, generator=g, device="cuda")
    if mamba_decay:
        dt0 = torch.exp(torch.linspace(np.log(1e-3), np.log(1e-1), H,
                                       device="cuda"))
        dt = F.softplus(dt0 + torch.log(-torch.expm1(-dt0)) + 0.5 * noise)
        A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    else:
        dt = F.softplus(noise)
        A = -torch.exp(0.3 * torch.randn(H, generator=g, device="cuda"))
    return xh, dt, A, Bm, Cm


def phase1c(SSD, RN, ref):
    """Errors: at small decays the largest |kernel - plain| over the three
    outputs, held to TOL; at mamba2-2.7b's decay the largest error of the
    kernel and of the float32 plain version against a float64 evaluation
    of the plain version, the kernel's at most twice the plain's.  And
    RMSNorm forward and backward at Mamba-2's widths (the block norm at
    d=2560, the gated norm at d=5120, 8192 rows: one micro-batch)."""
    g = torch.Generator(device="cuda").manual_seed(20)
    errors, f64, inputs = [], [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for d in (2560, 5120):
            x, sc, err = rmsnorm_case(RN, ref, 8192, d, dtype, g)
            errors.append(("rmsnorm_fwd", f"mamba2-d{d}", dn, err))
            gy = torch.randn(8192, d, generator=g, device="cuda").to(dtype)
            dx, ds = RN.rmsnorm_bwd(x, sc, gy, 1e-5)
            torch.cuda.synchronize()
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, sc, gy, 1e-5)
            errors.append(("rmsnorm_bwd", f"mamba2-d{d}", dn,
                           max_err(dx, want_dx, dtype)))
            errors.append(("rmsnorm_bwd/dscale_rel", f"mamba2-d{d}", dn,
                           dscale_rel_err(x, gy, ds, want_ds)))
            inputs[("rmsnorm", d, dn)] = (x, sc, gy)
        for B, S, H, P, N, Q, tag in ((2, 256, 8, 64, 16, 32, "reduced"),
                                      (2, 100, 8, 64, 16, 32, "ragged")):
            args = ssd_inputs(B, S, H, P, N, dtype, g, False)
            got = SSD.ssd_chunk(*args, Q)
            torch.cuda.synchronize()
            want = ref.ssd_chunk_ref(*args, Q)
            errors.append(("ssd_chunk", tag, dn, max(
                max_err(a, b, dtype) for a, b in zip(got, want))))
        for B, S, tag in ((4, 2048, "2.7b"), (1, 1000, "2.7b-ragged")):
            args = ssd_inputs(B, S, 80, 64, 128, dtype, g, True)
            got = SSD.ssd_chunk(*args, 256)
            torch.cuda.synchronize()
            plain = ref.ssd_chunk_ref(*args, 256)
            exact = ref.ssd_chunk_ref(*(t.double() for t in args), 256)
            for out, a, p, e in zip(("y_intra", "states", "T"), got, plain,
                                    exact):
                err = float((a.double() - e).abs().max())
                perr = float((p.double() - e).abs().max())
                if not (err <= 2 * perr and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"ssd_chunk {tag} {dn} {out}: error {err:.3g} vs "
                        f"float64, plain float32 {perr:.3g}")
                f64.append({"shape": tag, "dtype": dn, "output": out,
                            "kernel_err": err, "plain_err": perr,
                            "kernel_vs_plain": float((a - p).abs().max()),
                            "exact_max_abs": float(e.abs().max())})
            errors.append(("ssd_chunk", tag, dn,
                           max(float((a - p).abs().max())
                               for a, p in zip(got, plain))))
            if tag == "2.7b":
                inputs[("ssd", dn)] = args
            del got, plain, exact
            torch.cuda.empty_cache()
        # the serving prefill's calls: one request, Q = min(256, S)
        for S in PREFILL_SSD_S:
            tag, Q = f"prefill-S{S}", min(256, S)
            args = ssd_inputs(1, S, 80, 64, 128, dtype, g, True)
            got = SSD.ssd_chunk(*args, Q)
            torch.cuda.synchronize()
            plain = ref.ssd_chunk_ref(*args, Q)
            exact = ref.ssd_chunk_ref(*(t.double() for t in args), Q)
            for out, a, p, e in zip(("y_intra", "states", "T"), got, plain,
                                    exact):
                err = float((a.double() - e).abs().max())
                perr = float((p.double() - e).abs().max())
                # at S = 1 or 3 one C.B product decides the plain error,
                # which can land near 0: an error within one float32 ulp
                # of the largest output passes as well
                ulp = F32_EPS * float(e.abs().max())
                if not (err <= 2 * max(perr, ulp)
                        and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"ssd_chunk {tag} {dn} {out}: error {err:.3g} vs "
                        f"float64, plain float32 {perr:.3g}, ulp {ulp:.3g}")
                f64.append({"shape": tag, "dtype": dn, "output": out,
                            "kernel_err": err, "plain_err": perr,
                            "ulp_floor": ulp,
                            "kernel_vs_plain": float((a - p).abs().max()),
                            "exact_max_abs": float(e.abs().max())})
            errors.append(("ssd_chunk", tag, dn,
                           max(float((a - p).abs().max())
                               for a, p in zip(got, plain))))
            if dtype == torch.bfloat16:
                inputs[("ssd", tag)] = args
            del got, plain, exact
        # the decode step's norms: 8 slots at d = 2560 and d_inner 5120
        for d in (2560, 5120):
            x, sc, err = rmsnorm_case(RN, ref, 8, d, dtype, g)
            errors.append(("rmsnorm_fwd", f"mamba2-decode-d{d}", dn, err))
            inputs[("rmsnorm_decode", d, dn)] = (x, sc)
    for name, tag, dn, err in errors:
        log(f"phase 1c: {name} {tag} {dn}: max |err| {err:.3g}")
    for r in f64:
        log(f"phase 1c: vs float64 {r}")
    return errors, f64, inputs


def measure_ssd(SSD, RN, ref, inputs):
    """Kernel and plain times at mamba2-2.7b's training shapes in
    bfloat16, with the bound.  Bytes: x, B, C and dt read once, y_intra
    and the states written once in float32.  Operations: the causal
    halves of C·Bᵀ (2N per entry) and of M·x (2P per entry) and the
    state's 2·Q·N·P, per (b, chunk, head) cell.  RMSNorm forward and
    backward at Mamba-2's widths, timed as in phases 1 and 1b."""
    timer = Timer(iters=20)
    bf = torch.bfloat16
    rows = {}
    for d in (2560, 5120):
        x, sc, gy = inputs[("rmsnorm", d, "bfloat16")]
        n = x.shape[0]
        w = (1.0 + sc).to(bf)
        xr = x.detach().clone().requires_grad_()
        wr = w.detach().clone().requires_grad_()
        y = F.rms_norm(xr, (d,), wr, 1e-5)
        rows[f"rmsnorm_fwd/mamba2-d{d}"] = dict(
            ms=timer(lambda: RN.rmsnorm_fwd(x, sc, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_ref(x, sc, 1e-5)),
            library_ms=timer(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            graph_us=GraphTimer()(lambda: RN.rmsnorm_fwd(x, sc, 1e-5)),
            library_graph_us=GraphTimer()(
                lambda: F.rms_norm(x, (d,), w, 1e-5)),
            shape=f"x ({n}, {d}) bf16",
            **bound(4 * n * d + 4 * d, 4 * n * d, bf))
        rows[f"rmsnorm_bwd/mamba2-d{d}"] = dict(
            ms=timer(lambda: RN.rmsnorm_bwd(x, sc, gy, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_bwd_ref(x, sc, gy, 1e-5)),
            library_ms=timer(lambda: torch.autograd.grad(
                y, (xr, wr), gy, retain_graph=True)),
            shape=f"x, g ({n}, {d}) bf16",
            **bound(6 * n * d + 8 * d, 12 * n * d, bf))
        del xr, wr, y
    for d in (2560, 5120):
        x, sc = inputs[("rmsnorm_decode", d, "bfloat16")]
        w = (1.0 + sc).to(bf)
        rows[f"rmsnorm_fwd/mamba2-decode-d{d}"] = dict(
            ms=timer(lambda: RN.rmsnorm_fwd(x, sc, 1e-5)),
            graph_us=GraphTimer()(lambda: RN.rmsnorm_fwd(x, sc, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_ref(x, sc, 1e-5)),
            library_ms=timer(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            library_graph_us=GraphTimer()(
                lambda: F.rms_norm(x, (d,), w, 1e-5)),
            shape=f"x (8, {d}) bf16: a Mamba-2 decode step at 8 slots",
            **bound(4 * 8 * d + 4 * d, 4 * 8 * d, bf))

    def ssd_row(xh, dt, A, Bm, Cm, Q, graph):
        B, S, H, P = xh.shape
        N = Bm.shape[-1]
        nc = -(-S // Q)
        es = xh.element_size()
        n_bytes = (B * S * H * P * es + 2 * B * S * N * es + 4 * B * S * H
                   + 4 * H + 4 * B * S * H * P + 4 * B * nc * H * N * P
                   + 4 * B * nc * H)
        n_ops = B * nc * H * (Q * (Q + 1) * (N + P) + 2 * Q * N * P)
        row = dict(
            ms=timer(lambda: SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)),
            plain_ms=timer(lambda: ref.ssd_chunk_ref(xh, dt, A, Bm, Cm, Q)),
            library_ms=None,
            host_us=timer.host_us(
                lambda: SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)),
            shape=f"x (B={B}, S={S}, H={H}, P={P}) bf16 strided as in the "
                  f"mixer, N={N}, Q={Q}",
            **bound(n_bytes, n_ops, bf))
        if graph:
            row["graph_us"] = GraphTimer(n=50)(
                lambda: SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q))
        row["tflops"] = n_ops / row["ms"] / 1e9
        return row

    rows["ssd_chunk"] = ssd_row(*inputs[("ssd", "bfloat16")], 256, False)
    rows["ssd_chunk"]["library_note"] = \
        "no single PyTorch call computes the SSD chunk terms"
    rows["ssd_chunk/prefill"] = {
        S: ssd_row(*inputs[("ssd", f"prefill-S{S}")], min(256, S), True)
        for S in PREFILL_SSD_S}
    return rows


# --------------------------------------------------------------------- #
# phase 1d: the overlap kernel against its plain version
# --------------------------------------------------------------------- #

def phase1d(OV, ref):
    """The streaming normalize against ``overlap_norm_ref`` in float32
    (2e-5): at the benchmark's 8192 x 512 at every (block_rows, depth)
    of its sweep whose stages fit the card's shared memory, and at edge
    shapes.  Returns [(rows, d, block_rows, depth, max |err|)], the
    configs over budget as (rows, d, block_rows, depth, None), and the
    times of a device copy of the 8192 x 512 input (``copy_ms``) and of
    a kernel touching 4 bytes (``launch_floor_ms``)."""
    from repro_torch.bench.kernels import OVERLAP
    g = torch.Generator(device="cuda").manual_seed(30)
    rows, d, blocks, depths = OVERLAP[False]
    cases = [(rows, d, b, k) for b in blocks for k in depths]
    cases += [
        (64, 512, 16, 1),       # 4 row-blocks: fewer than SMs
        (64, 512, 4, 8),        # 16 row-blocks, deeper than each one
        (4096, 256, 16, 4),     # 256 row-blocks: ~2 a block, depth 4
        (4096, 256, 1, 2), (4096, 256, 8, 8),               # d = 256
        (8192, 512, 1, 16),     # deeper than the 8 stores waited on
        (264, 1028, 2, 3),      # d not a power of 2, odd depth
        (1000, 4, 8, 2)]        # 16-byte rows, one vector each
    budget = OV.smem_budget("cuda")
    out, xs = [], {}
    for n, dd, b, k in cases:
        if OV.smem_bytes(b, dd, k) > budget:
            out.append((n, dd, b, k, None))
            continue
        if (n, dd) not in xs:
            xs[(n, dd)] = torch.randn(n, dd, generator=g, device="cuda")
        x = xs[(n, dd)]
        got = OV.overlap_norm(x, block_rows=b, depth=k)
        torch.cuda.synchronize()
        out.append((n, dd, b, k,
                    max_err(got, ref.overlap_norm_ref(x), torch.float32)))
    for n, dd, b, k, err in out:
        log(f"phase 1d: overlap_norm {n}x{dd} block_rows {b} depth {k}: "
            + ("over the shared memory budget" if err is None
               else f"max |err| {err:.3g}"))
    timer = Timer(iters=20)
    x = xs[(rows, d)]
    y = torch.empty_like(x)
    probes = {"copy_ms": timer(lambda: y.copy_(x)),
              "launch_floor_ms": timer(lambda: y[:1, :1].zero_())}
    log(f"phase 1d: {probes}")
    return out, probes


# --------------------------------------------------------------------- #
# phase 8: the kernel benchmark
# --------------------------------------------------------------------- #

def phase8(ctr):
    """``python -m repro_torch.bench.kernels`` at full size through its
    ``main``, writing ``chiprun_out/bench_kernels.json``.  The launch
    counters ``ctr`` are set to 0 just before and read just after; each
    must be > 0.  Every overlap config run must be within 2e-5 of the
    plain version, at least one at depth 1 and one deeper; every sweep
    row must hold its four times, and its outputs' and grads' errors
    (``fwd_err``, ``grad_err``: |kernel - plain| / (1 + |plain|), for
    RMSNorm's dscale / its terms' magnitude) must be within TOL[float32],
    whose atol and rtol are equal."""
    import contextlib
    from repro_torch.bench import kernels as BK
    for mod, attr in ctr.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(sys.stderr):
        res = BK.main(["--out", os.path.join(OUT_DIR, "bench_kernels.json")])
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr)
                in ctr.items()}
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"benchmark: kernel {name} never launched")
    times = ("kernel_fwd_ms", "kernel_bwd_ms", "plain_fwd_ms",
             "plain_bwd_ms")
    tol = TOL[torch.float32]["atol"]
    assert tol == TOL[torch.float32]["rtol"]
    for section, cfgs in (("attention", BK.ATTENTION[False]),
                          ("rmsnorm", BK.RMSNORM[False]),
                          ("ssd", BK.SSD[False])):
        if len(res[section]) != len(cfgs):
            raise AssertionError(f"benchmark: {section} has "
                                 f"{len(res[section])} rows of {len(cfgs)}")
        for row in res[section]:
            if not all(np.isfinite(row.get(t, np.nan)) for t in times):
                raise AssertionError(f"benchmark: {section} row {row}")
            errs = [row["fwd_err"], *row["grad_err"].values()]
            if not all(e <= tol for e in errs):
                raise AssertionError(f"benchmark: {section} row {row}: "
                                     f"kernel vs plain over {tol}")
    ov = res["overlap"]
    ran = [c for c in ov["configs"] if "ms" in c]
    bad = [c for c in ran if not c["max_err"] <= 2e-5]
    if bad or not any(c["buffer_depth"] == 1 for c in ran) \
            or not any(c["buffer_depth"] >= 2 for c in ran):
        raise AssertionError(f"benchmark: overlap configs {ov['configs']}")
    skipped = [c for c in ov["configs"] if "skipped" in c]
    return {"launches": launches, "overlap": ov,
            "skipped": [(c["block_rows"], c["buffer_depth"])
                        for c in skipped],
            "errors": {s: max(max(r["fwd_err"], *r["grad_err"].values())
                              for r in res[s])
                       for s in ("attention", "rmsnorm", "ssd")},
            "rows": {s: len(res[s]) for s in ("attention", "rmsnorm",
                                              "ssd")}}


# --------------------------------------------------------------------- #
# phases 2 and 3: the engine
# --------------------------------------------------------------------- #

def requests(cfg, n=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(64, 769))
        out.append((rng.integers(0, cfg.vocab_size, s).astype(np.int32),
                    int(rng.integers(32, 129))))
    return out


class _EveryCallEager(set):
    """A ``ServingEngine._warm`` that never records a kind as warm, so
    each call runs its entry's eager function: the reference the
    replayed engine's tokens are held to."""

    def add(self, kind):
        pass


def serve(eng, serving, reqs):
    """Serve ``reqs`` through ``eng.drain()``, timed to a sync; returns
    (rids, results, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(serving.GenerationRequest(prompt=prompt,
                                                 max_new_tokens=n))
            for prompt, n in reqs]
    done = {r.rid: r for r in eng.drain()}
    torch.cuda.synchronize()
    return rids, [done.get(rid) for rid in rids], time.perf_counter() - t0


def phase2(cfg, R, serving, kernel_modules):
    model = R.init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = serving.ServingEngine(cfg, model, decode_slots=8, page_size=16,
                                max_len=1024, dtype=torch.bfloat16)
    reqs = requests(cfg)
    # warm-up, outside the counted run: the first prefill and the first
    # decode run eagerly (kernel build, cuBLAS handles); then one graph
    # per bucket this mix and the profiled one use and the decode graph
    # are captured
    buckets = sorted({eng._bucket_for(len(p)) for p, _ in
                      reqs + requests(cfg, n=8, seed=1)})
    for b in buckets[:1] + buckets:
        eng.submit(serving.GenerationRequest(
            prompt=np.arange(b - 8, dtype=np.int32), max_new_tokens=4))
    eng.drain()
    eng.reset()
    warm = {"captures": eng.captures, "captures_s": eng.capture_s}
    for m in kernel_modules:
        m.launches = 0
    rids, results, wall = serve(eng, serving, reqs)
    done = {r.rid for r in results if r is not None}
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches
                for m in kernel_modules}
    if eng.captures != warm["captures"]:
        raise AssertionError(f"{eng.captures - warm['captures']} graphs "
                             f"captured during the timed run")
    if eng.n_decode_executables != 1 or \
            eng.executables > eng.executable_budget:
        raise AssertionError(f"{eng.n_prefill_executables} prefill + "
                             f"{eng.n_decode_executables} decode entries, "
                             f"budget {eng.executable_budget}")
    # the same mix through an engine whose every call runs eagerly
    ref = serving.ServingEngine(cfg, model, decode_slots=8, page_size=16,
                                max_len=1024, dtype=torch.bfloat16)
    ref._warm = _EveryCallEager()
    _, eager, eager_wall = serve(ref, serving, reqs)
    if ref.captures:
        raise AssertionError("the eager reference engine captured graphs")
    for rid, a, b in zip(rids, results, eager):
        if a is None or b is None or a.tokens.tolist() != b.tokens.tolist():
            raise AssertionError(f"rid {rid}: replayed tokens differ from "
                                 f"the eager engine's")

    if len(done) != len(reqs) or None in results:
        raise AssertionError(f"{len(done)} of {len(reqs)} finished")
    n_tok = 0
    for rid, res, (prompt, n) in zip(rids, results, reqs):
        toks = res.tokens
        if len(toks) != n or res.finish_reason != "length":
            raise AssertionError(f"rid {rid}: {len(toks)} tokens, "
                                 f"{res.finish_reason}, want {n}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"rid {rid}: token out of [0, vocab)")
        n_tok += len(toks)
    if eng.pool.n_used != 0:
        raise AssertionError(f"{eng.pool.n_used} pages still in use")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched")
    return eng, {"requests": len(reqs), "tokens": n_tok,
            "prompt_tokens": int(sum(len(p) for p, _ in reqs)),
            "decode_steps": eng.steps, "wall_s": wall,
            "tok_per_s": n_tok / wall, "mean_occupancy":
            eng.mean_occupancy(), "launches": launches,
            "n_prefill_executables": eng.n_prefill_executables,
            "n_decode_executables": eng.n_decode_executables,
            "executables": eng.executables,
            "executable_budget": eng.executable_budget,
            "captures": eng.captures, "captures_s": warm["captures_s"],
            "eager_wall_s": eager_wall,
            "eager_tok_per_s": n_tok / eager_wall,
            "tokens_equal_eager": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def host_calls(avgs):
    """Graph launches and kernel launches the host made in a profiled
    window."""
    return {"cuda_graph_launch_calls": sum(
                e.count for e in avgs if e.key == "cudaGraphLaunch"),
            "cuda_launch_kernel_calls": sum(
                e.count for e in avgs if e.key == "cudaLaunchKernel")}


def profile_engine(cfg, eng, serving):
    """Where the time goes: torch.profiler over a short run of the warm
    phase-2 engine (8 more requests, 16 new tokens each), replays only.
    Sums device time by kernel; the device's busy share is that sum over
    the wall time of the window (the profiler's own cost is in the wall
    time)."""
    from torch.profiler import ProfilerActivity, profile
    reqs = requests(cfg, n=8, seed=1)
    for prompt, _ in reqs:
        eng.submit(serving.GenerationRequest(prompt=prompt,
                                             max_new_tokens=16))
    torch.cuda.synchronize()
    steps0, captures0 = eng.steps, eng.captures
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    steps = eng.steps - steps0
    if eng.captures != captures0:
        raise AssertionError("the profiled requests captured a graph")
    avgs = prof.key_averages()
    kernels = []
    for e in avgs:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.self_device_time_total, e.key, e.count))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    decode_us = sum(us for us, name, _ in kernels
                    if "paged_decode_kernel" in name)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            **host_calls(avgs),
            "decode_steps": steps,
            "device_us_per_decode_step": busy_us / steps,
            "decode_kernel_us": decode_us,
            "decode_kernel_share_of_device": decode_us / busy_us,
            "top_kernels": [
                {"us": us, "name": name[:90], "count": n}
                for us, name, n in kernels[:12]]}


def phase3(cfg, R, serving, transformer):
    card = R.init_model(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = transformer.Transformer(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    reqs = requests(cfg)[:2]
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        logits = []
        with torch.inference_mode():
            for prompt, _ in reqs:
                toks = torch.from_numpy(prompt.astype(np.int64))[None]
                lens = torch.tensor([len(prompt)], dtype=torch.int32)
                lg, _, _ = R.prefill_ragged(model, cfg, toks.to(dev),
                                            lens.to(dev))
                logits.append(lg.cpu())
        eng = serving.ServingEngine(cfg, model, decode_slots=2,
                                    page_size=16, max_len=1024,
                                    dtype=torch.float32)
        for prompt, _ in reqs:
            eng.submit(serving.GenerationRequest(prompt=prompt,
                                                 max_new_tokens=8))
        toks = {r.rid: r.tokens.tolist() for r in eng.drain()}
        out[dev] = (logits, toks)
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][0], out["cpu"][0]))
    if diff > 1e-3:
        raise AssertionError(f"first-token logits differ by {diff:.3g}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"tokens differ: card {out['cuda'][1]}, "
                             f"cpu {out['cpu'][1]}")
    return {"first_token_logit_max_abs_diff": diff,
            "tokens": out["cuda"][1]}


# --------------------------------------------------------------------- #
# phases 4 and 5: training
# --------------------------------------------------------------------- #

def counters(RN, FA):
    """Each training kernel's launch counter: (module, attribute)."""
    return {"rmsnorm_fwd": (RN, "launches"),
            "rmsnorm_bwd": (RN, "bwd_launches"),
            "flash_fwd": (FA, "launches"),
            "flash_bwd_dq": (FA, "dq_launches"),
            "flash_bwd_dkv": (FA, "dkv_launches")}


def run_ramp(run, ctr, *, fuse_steps, max_device_batch, want):
    """Train ``run`` on the card through ``Trainer`` over its whole Seesaw
    plan, on ``MarkovLM(2048, seed 0)``, with every engine call timed to
    a sync.  ``want`` = (batch sizes, steps per phase, micro-batches per
    step), checked before the run.  The launch counters ``ctr`` are set
    to 0 just before the run and read just after.  Checks that every
    loss and grad norm is finite and every step's LR, batch size and
    phase are the plan's; returns the trainer and the run's numbers."""
    from repro_torch.data import MarkovLM, PhaseDataLoader
    from repro_torch.train.trainer import Trainer
    tr = Trainer(run, device="cuda", fuse_steps=fuse_steps,
                 max_device_batch=max_device_batch)
    plan, eng, seq = tr.plan, tr.engine, run.seq_len
    steps = plan.steps_per_phase(seq)
    micro = [eng.micro_batches(b) for b in plan.batch_sizes()]
    if (plan.batch_sizes(), steps, micro) != want:
        raise AssertionError(f"plan: batches {plan.batch_sizes()}, steps "
                             f"{steps}, micro-batches {micro}; want {want}")
    loader = PhaseDataLoader(MarkovLM(2048, seed=0), plan, seq,
                             device="cuda")
    # each engine call timed to a sync: (batch size, steps, seconds)
    chunks = []
    run_chunk = eng.run_chunk

    def timed(model, opt_state, tokens_seen, stacked, n_valid=None,
              **kw):
        t, cap = time.perf_counter(), eng.capture_s
        out = run_chunk(model, opt_state, tokens_seen, stacked,
                        n_valid=n_valid, **kw)
        torch.cuda.synchronize()
        chunks.append((next(iter(stacked.values())).shape[1], n_valid,
                       time.perf_counter() - t, eng.capture_s - cap))
        return out

    eng.run_chunk = timed
    for mod, attr in ctr.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.run(loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr)
                in ctr.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved = torch.cuda.max_memory_reserved() / 1e9
    eng.run_chunk = run_chunk

    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != sum(steps) or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{len(hist)} steps, losses {losses}, grad "
                             f"norms {norms}")
    tok = 0
    for i, h in enumerate(hist):
        ph = plan.realized_phase_at(tok, seq)
        want_lr = float(eng.lr_fn(float(tok), i))
        if (h["lr"], h["batch_size"], h["phase"]) != \
                (want_lr, ph.batch_size, ph.index):
            raise AssertionError(f"step {i + 1}: lr {h['lr']}, batch "
                                 f"{h['batch_size']}, phase {h['phase']}; "
                                 f"plan {want_lr}, {ph.batch_size}, "
                                 f"{ph.index}")
        tok += ph.batch_size * seq
    # the compile cache: one graph per (batch size, micro)
    keys = [(b, m) for b, m in zip(plan.batch_sizes(), micro)]
    if sorted(tr._step_cache) != sorted(keys) or eng.captures != len(keys):
        raise AssertionError(f"step cache {sorted(tr._step_cache)}, "
                             f"{eng.captures} captures; want {keys}")
    # wall per step at each batch size, capture time taken out; the first
    # chunk (its first step eager: the kernels' build, cuBLAS set-up, the
    # allocator's first growth) is left out of the first batch size's
    stats = {}
    for b in plan.batch_sizes():
        timed_chunks = [(n, dt - cap) for i, (bb, n, dt, cap)
                        in enumerate(chunks)
                        if bb == b and not (i == 0 and len(chunks) > 1)]
        n = sum(c[0] for c in timed_chunks)
        sec = sum(c[1] for c in timed_chunks)
        stats[str(b)] = {"wall_s_per_step": sec / n,
                         "tok_per_s": b * seq * n / sec,
                         "steps_timed": n}
    mb = sum(n * m for n, m in zip(steps, micro))
    return tr, {"steps": len(hist), "plan_steps": steps,
                "batch_sizes": plan.batch_sizes(), "micro_batches": micro,
                "executables": len(tr._step_cache),
                "captures_s": eng.capture_s,
                "wall_s": wall, "tokens": hist[-1]["tokens"],
                "tok_per_s": hist[-1]["tokens"] / wall,
                "per_batch_size": stats, "peak_mem_gb": peak,
                "peak_reserved_gb": peak_reserved,
                "loss_first": losses[0], "loss_last": losses[-1],
                "loss_last3": float(np.mean(losses[-3:])),
                "losses": losses, "grad_norms": norms,
                "lrs": [h["lr"] for h in hist], "launches": launches,
                "chunks": chunks, "micro_batches_run": mb}


def check_launches(out, want_per_micro_batch):
    """The counts of the run must be exactly ``want`` per micro-batch."""
    mb = out["micro_batches_run"]
    want = {k: v * mb for k, v in want_per_micro_batch.items()}
    if out["launches"] != want:
        raise AssertionError(f"launches {out['launches']}, remat gives "
                             f"{want}")
    out["launches_per_micro_batch"] = want_per_micro_batch


def phase4_run(cfg, total_tokens=24 * 8 * 1024, **schedule):
    """Phase 4's run config: seesaw-150m, B0=8, seq 1024, AdamW, bf16;
    ``schedule`` overrides the Seesaw schedule (phase 10's adaptive
    ramp)."""
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    sch = dict(kind="seesaw", alpha=2.0, n_cuts=2)
    sch.update(schedule)
    return RunConfig(model=cfg, schedule=ScheduleConfig(**sch),
                     optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                               beta2=0.95, grad_clip=1.0),
                     seq_len=1024, global_batch_size=8,
                     total_tokens=total_tokens, dtype="bfloat16")


def phase4(cfg, RN, FA):
    run = phase4_run(cfg)
    tr, out = run_ramp(run, counters(RN, FA), fuse_steps=4,
                       max_device_batch=8,
                       want=([8, 16, 32], [16, 2, 1], [1, 2, 4]))
    losses = out["losses"]
    drop = losses[0] - float(np.mean(losses[-3:]))
    if drop < 0.5:
        raise AssertionError(f"loss fell {drop:.3f} < 0.5 nats: {losses}")
    check_launches(out, per_micro_batch(cfg, run.remat))
    return tr, out


def profile_train(tr, step_s: float, batch: int, name: str):
    """Where the time goes: torch.profiler over one more optimizer step at
    the first batch size of the ramp on the trained model, one replay of
    that batch size's graph (one ``cudaGraphLaunch``, and fewer than 50
    ``cudaLaunchKernel`` calls for the copies around it).  Device time
    by kernel; the busy share is that sum over the window's wall time,
    which holds the profiler's own host cost, and ``busy_share_of_step``
    the same sum over ``step_s``, the ramp's unprofiled wall time of a
    step at that batch size.  The table goes to ``chiprun_out/<name>``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import MarkovLM
    raw = MarkovLM(2048, seed=1).sample(0, batch, tr.cfg.seq_len)
    batch = {k: torch.from_numpy(v.astype(np.int64))[None].cuda()
             for k, v in raw.items()}
    st = tr.state

    def one():
        tr.engine.run_chunk(st.model, st.opt_state, 0, batch, n_valid=1,
                            step=0)

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    avgs = prof.key_averages()
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy_us = sum(k[0] for k in kernels)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=50))
    out = {"wall_us": wall_us, "device_busy_us": busy_us,
           "device_busy_share": busy_us / wall_us,
           "busy_share_of_step": busy_us / (step_s * 1e6),
           "device_kernels": sum(k[2] for k in kernels),
           **host_calls(avgs),
           "top_kernels": [{"us": us, "name": name[:70], "count": n}
                           for us, name, n in kernels[:15]]}
    # the profiled step is one replay of the batch size's graph
    if out["cuda_graph_launch_calls"] != 1 or \
            out["cuda_launch_kernel_calls"] >= 50 or not out["device_kernels"]:
        raise AssertionError(f"profiled step: {out}")
    return out


def sgd_updates(small, cpu_model, dev, scan, raw):
    """Steps of SGD at LR 0.1 (no clipping) of ``cpu_model``'s weights on
    ``dev``, one a batch of ``raw`` (stacked (steps, B, S)), with ``scan``
    as ``kernels.backend.rglru_scan`` (None: the backend's own), through
    the engine (on the card the first step eager, then one graph
    replayed).  Returns (losses, each tensor's change, captures)."""
    import copy
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    from repro_torch.core.seesaw import build_plan
    from repro_torch.kernels import backend as KB
    from repro_torch.optim import optimizers as O
    from repro_torch.train import engine as E
    run = RunConfig(model=small, schedule=ScheduleConfig(),
                    optimizer=OptimizerConfig(kind="sgd", grad_clip=0.0),
                    seq_len=raw["tokens"].shape[-1],
                    global_batch_size=raw["tokens"].shape[1],
                    dtype="float32")
    plan = build_plan(kind="constant", base_lr=0.1, total_tokens=1e9,
                      warmup_frac=0.0, b0=run.global_batch_size)
    own = KB.rglru_scan
    KB.rglru_scan = scan or own
    try:
        model = copy.deepcopy(cpu_model).to(dev)
        before = [p.detach().clone() for p in model.parameters()]
        eng = E.PhaseEngine(run, O.sgd(), plan)
        _, _, m = eng.run_chunk(
            model, O.sgd().init(dict(model.named_parameters())), 0,
            {k: torch.from_numpy(v.astype(np.int64)).to(dev)
             for k, v in raw.items()}, step=0)
        return ([float(x) for x in m["loss"].cpu()],
                [(p.detach() - b).cpu()
                 for p, b in zip(model.parameters(), before)], eng.captures)
    finally:
        KB.rglru_scan = own


def replayed_card_vs_cpu(small, cpu_model, raw):
    """Three engine steps on the CPU and on the card from ``cpu_model``'s
    weights, on the same batches: on the card the first runs eagerly,
    the second is captured and replayed, the third replayed.  Float32,
    SGD at a constant LR 0.1, no clipping, so the parameters' change is
    -0.1 × the sum of the grads.  Every step's loss must agree within
    1e-4 and each tensor's change within 1e-3 of its largest |change|:
    phase 5's gates for the loss and the grads, on replayed steps."""
    out = {}
    for dev in ("cpu", "cuda"):
        *out[dev], captures = sgd_updates(small, cpu_model, dev, None, raw)
        if dev == "cuda" and captures != 1:
            raise AssertionError(f"{captures} captures, want 1")
    loss_diff = max(abs(a - b) for a, b in zip(out["cpu"][0],
                                               out["cuda"][0]))
    if loss_diff > 1e-4:
        raise AssertionError(f"replayed steps' losses {out['cuda'][0]}, "
                             f"cpu {out['cpu'][0]}")
    rel = 0.0
    for (name, _), a, b in zip(cpu_model.named_parameters(), out["cpu"][1],
                               out["cuda"][1]):
        r = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        if r > 1e-3:
            raise AssertionError(f"update of {name} after replays: {r:.3g} "
                                 f"of its max")
        rel = max(rel, r)
    return {"replayed_losses_cpu": out["cpu"][0],
            "replayed_losses_cuda": out["cuda"][0],
            "replayed_loss_abs_diff": loss_diff,
            "replayed_update_max_rel_diff": rel}


def phase5(cfg, R, O):
    """seesaw-150m widths at 2 layers, float32, on the card and the CPU
    with the same weights: loss, grads, and AdamW on the same grads."""
    from repro_torch.data import MarkovLM
    small = dataclasses.replace(cfg, n_layers=2)
    cpu = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                        trainable=True).cuda()
    raw = MarkovLM(2048, seed=2).sample(0, 2, 256)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                 for k, v in raw.items()}
        loss, _ = R.loss_fn(model, small, batch, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    loss_diff = abs(out["cpu"][0] - out["cuda"][0])
    if loss_diff > 1e-4:
        raise AssertionError(f"loss differs by {loss_diff:.3g}")
    grad_rel = 0.0
    for (name, _), a, b in zip(cpu.named_parameters(), out["cpu"][1],
                               out["cuda"][1]):
        rel = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        if rel > 1e-3:
            raise AssertionError(f"grad of {name}: {rel:.3g} of its max")
        grad_rel = max(grad_rel, rel)
    params = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        opt = O.adamw()
        p = dict(model.named_parameters())
        grads = {n: g.to(dev) for n, g in zip(p, out["cpu"][1])}
        opt.update(grads, opt.init(p), p, torch.tensor(1e-3))
        params[dev] = [t.detach().cpu() for t in p.values()]
    upd = max(float((a - b).abs().max())
              for a, b in zip(params["cpu"], params["cuda"]))
    if upd > 1e-6:
        raise AssertionError(f"AdamW update differs by {upd:.3g}")
    return {"loss_cpu": out["cpu"][0], "loss_cuda": out["cuda"][0],
            "loss_abs_diff": loss_diff, "grad_max_rel_diff": grad_rel,
            "adamw_param_max_abs_diff": upd,
            **replayed_card_vs_cpu(small, cpu, {
                k: v.reshape(3, 2, 256) for k, v in
                MarkovLM(2048, seed=2).sample(2, 6, 256).items()})}


# --------------------------------------------------------------------- #
# phase 9: replays against the eager step, bit for bit
# --------------------------------------------------------------------- #

def clone_state(model, opt_state):
    import copy
    return copy.deepcopy(model), {
        k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
            else v.clone()) for k, v in opt_state.items()}


def same_state(a, b) -> bool:
    (ma, oa), (mb, ob) = a, b
    if not all(torch.equal(p, q) for p, q in zip(ma.parameters(),
                                                 mb.parameters())):
        return False
    return all(all(torch.equal(oa[k][n], ob[k][n]) for n in oa[k])
               if isinstance(oa[k], dict) else torch.equal(oa[k], ob[k])
               for k in oa)


def phase9(cfg, R, serving):
    """seesaw-150m cut to 2 layers of d_model 256 (4 heads of 64, d_ff
    1024), random weights from a seed, bfloat16 compute.  Training (AdamW,
    clip 1.0, S=256, ``max_device_batch=4``): after the engine's eager
    first step, two steps at B=4 (micro 1) and two at B=8 (micro 2), each
    run once as the engine's replay and once as the eager step it was
    captured from, on a clone of the state before it: parameters, AdamW
    state (the step count included) and metrics must be equal bit for
    bit.  Serving (4 slots, page 16): three decode steps, each replayed
    by the engine and run eagerly on a copy of the pool from the same
    packed input: the next tokens and the pool bit for bit."""
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    from repro_torch.data import MarkovLM
    from repro_torch.serving import engine as SE
    from repro_torch.train.trainer import Trainer
    small = dataclasses.replace(cfg, n_layers=2, d_model=256, n_heads=4,
                                n_kv_heads=4, head_dim=64, d_ff=1024)
    seq = 256
    run = RunConfig(model=small,
                    schedule=ScheduleConfig(kind="constant", base_lr=3e-3,
                                            warmup_frac=0.5),
                    optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                              beta2=0.95, grad_clip=1.0),
                    seq_len=seq, global_batch_size=4,
                    total_tokens=seq * 4 * 16, dtype="bfloat16")
    tr = Trainer(run, device="cuda", max_device_batch=4)
    eng, st = tr.engine, tr.state
    src = MarkovLM(2048, seed=5)

    def batch(start, b):
        return {k: torch.from_numpy(v.astype(np.int64))[None].cuda()
                for k, v in src.sample(start, b, seq).items()}

    eng.run_chunk(st.model, st.opt_state, 0, batch(0, 4), step=0)
    out, step, tok, start = {}, 1, 4 * seq, 4
    for b in (4, 8):
        for _ in range(2):
            chunk = batch(start, b)
            twin = clone_state(st.model, st.opt_state)
            _, _, m = eng.run_chunk(st.model, st.opt_state, tok, chunk,
                                    step=step)
            _, _, want = eng.step_for(b).grad(
                *twin, {k: v[0] for k, v in chunk.items()},
                m["lr"][0].cuda())
            torch.cuda.synchronize()
            if not same_state((st.model, st.opt_state), twin) or not all(
                    torch.equal(m[k][0], v) for k, v in want.items()):
                raise AssertionError(f"B={b} step {step}: the replay "
                                     f"differs from the eager step")
            step, tok, start = step + 1, tok + b * seq, start + b
        out[f"train_micro{eng.micro_batches(b)}_steps"] = 2
    if eng.captures != 2 or int(st.opt_state["count"]) != 5:
        raise AssertionError(f"{eng.captures} captures, count "
                             f"{int(st.opt_state['count'])}")
    del tr, eng, st

    model = R.init_model(small, seed=6, dtype=torch.bfloat16, device="cuda")
    srv = serving.ServingEngine(small, model, decode_slots=4, page_size=16,
                                max_len=256, dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    for s_, n in zip((20, 70, 33, 100), (12, 9, 16, 10)):
        srv.submit(serving.GenerationRequest(
            prompt=rng.integers(0, 2048, s_).astype(np.int32),
            max_new_tokens=n))
    seen = []
    inputs = srv._decode_inputs
    srv._decode_inputs = lambda active: seen.append(inputs(active)) or \
        seen[-1]
    checked = 0
    while checked < 3:
        ent = srv._decode_fns.get(srv.decode_slots)
        if ent is None or ent.graph is None or srv.n_pending:
            srv.step()
            continue
        kv0 = srv.pool.kv.clone()
        srv.step()
        want = SE._decode_packed(model, small, kv0,
                                 torch.from_numpy(seen[-1]).cuda(),
                                 slots=srv.decode_slots, page_size=16)
        torch.cuda.synchronize()
        if not (torch.equal(ent.graph.out, want)
                and torch.equal(srv.pool.kv, kv0)):
            raise AssertionError(f"decode step {srv.steps}: the replay "
                                 f"differs from the eager step")
        checked += 1
    out["decode_steps"] = checked
    out["bitwise"] = True
    return out


# --------------------------------------------------------------------- #
# phase 10: checkpoint, resume and the adaptive ramp
# --------------------------------------------------------------------- #

# phase 10b's adaptive Seesaw: phase 4's model, data and optimizer, a
# horizon of 40 steps at B=32, a 2% warmup, the plateau controller's
# knobs set to fire its two cuts (B 8 -> 16 -> 32) within ADAPTIVE_STEPS.
# The threshold sits mid-band: the thresholds that make this run's cut
# decisions are those above its firing tests' relative gains and at most
# the gain of the test that re-arms it (``controller_replay``)
ADAPTIVE = dict(kind="adaptive-seesaw", alpha=2.0, n_cuts=2, base_lr=3e-3,
                warmup_frac=0.02, ema_decay=0.5, plateau_window=4,
                plateau_threshold=2.25e-3, plateau_min_steps=4)
ADAPTIVE_TOKENS = 40 * 32 * 1024
# past the second cut (step 36) by two chunks: the new key's first and a
# steady one
ADAPTIVE_STEPS = 44
HIST_KEYS = ("step", "tokens", "lr", "batch_size", "phase", "loss",
             "grad_norm")


def hist_rows(hist):
    return [[h[k] for k in HIST_KEYS] for h in hist]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def resumed_loader(tr, tokens=0):
    from repro_torch.data import MarkovLM, PhaseDataLoader
    return PhaseDataLoader(MarkovLM(2048, seed=0), tr.plan, tr.cfg.seq_len,
                           device="cuda").resume(tokens)


def counted_run(tr, ctr, tokens, **kw):
    """``tr.run`` from ``tokens`` with the launch counters set to 0 just
    before and read just after."""
    for mod, attr in ctr.values():
        setattr(mod, attr, 0)
    tr.run(resumed_loader(tr, tokens), **kw)
    torch.cuda.synchronize()
    return {name: getattr(mod, attr) for name, (mod, attr) in ctr.items()}


def phase10a(cfg, RN, FA, tr4, hist4, final4, per_micro, tmp):
    """Save and resume at full width on phase 4's plan.  A fresh trainer
    trains with async saves every 8 steps and stops by ``stop_fn`` at
    step 16, the 8 -> 16 boundary; its steps 1-16 must be phase 4's bit
    for bit.  There the loop's stall on an async save (snapshot, to a
    sync) is timed against a sync save of the same state.  A fresh
    trainer restores with ``verify=True`` and runs steps 17-19 (the first
    eager, then captures); then phase 4's trainer, whose three graphs are
    captured, restores the same checkpoint in place and replays 17-19
    with no capture.  Both must end on phase 4's history and final
    parameters, m, v and count bit for bit, with phase 4's launches over
    those steps (its per-micro-batch counts times the 2 + 2 + 4
    micro-batches)."""
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.trainer import Trainer
    ctr = counters(RN, FA)
    run = phase4_run(cfg)
    path = os.path.join(tmp, "ck")
    tr = Trainer(run, device="cuda", fuse_steps=4, max_device_batch=8)
    stamps = {}

    def stop_at_16():
        # each chunk boundary timed to a sync: steps 9-16 train while the
        # step-8 save streams on the writer thread
        torch.cuda.synchronize()
        stamps[tr.state.step] = time.perf_counter()
        return tr.state.step >= 16

    tr.run(resumed_loader(tr), checkpoint_path=path, save_every=8,
           stop_fn=stop_at_16)
    tr.close()
    mgr = tr.checkpoint_manager
    if (tr.state.step, mgr.saves_committed) != (16, 2):
        raise AssertionError(f"stopped at step {tr.state.step} after "
                             f"{mgr.saves_committed} saves; want 16, 2")
    if hist_rows(tr.history) != hist_rows(hist4[:16]):
        raise AssertionError("steps 1-16 differ from phase 4's")
    nbytes = dir_bytes(path)
    loop_write_s, loop_stall_s = mgr.last_write_s, mgr.last_stall_s
    # the loop's stall: an async save (the on-card snapshot) against a
    # sync save of the same state
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.save_checkpoint(os.path.join(tmp, "async"), block=False)
    torch.cuda.synchronize()
    async_stall_s = time.perf_counter() - t
    mgr.finalize()
    async_write_s = mgr.last_write_s
    t = time.perf_counter()
    tr.save_checkpoint(os.path.join(tmp, "sync"))
    sync_s = time.perf_counter() - t
    man = {}
    for name in ("ck", "async", "sync"):
        with open(os.path.join(tmp, name, "manifest.json")) as f:
            m = json.load(f)
        man[name] = (m["meta"], {k: [sh["crc32"] for sh in e["shards"]]
                                 for k, e in m["arrays"].items()})
    if not man["ck"] == man["async"] == man["sync"]:
        raise AssertionError("the step-16 saves differ")
    del tr, mgr
    torch.cuda.empty_cache()

    tr = Trainer(run, device="cuda", fuse_steps=4, max_device_batch=8)
    torch.cuda.synchronize()
    t = time.perf_counter()
    meta = tr.restore_checkpoint(path, verify=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    t = time.perf_counter()
    with open(os.path.join(path, "manifest.json")) as f:
        CKPT._verify_manifest(path, json.load(f))
    verify_s = time.perf_counter() - t
    if (meta["step"], meta["phase"], meta["batch_size"]) != (16, 1, 16):
        raise AssertionError(f"checkpoint meta {meta}")
    want_launches = {k: v * (2 + 2 + 4) for k, v in per_micro.items()}
    launches = counted_run(tr, ctr, tr.state.tokens_seen)
    if hist_rows(tr.history) != hist_rows(hist4[16:]) or \
            not same_state((tr.state.model, tr.state.opt_state), final4):
        raise AssertionError("the resumed run differs from phase 4's")
    if launches != want_launches:
        raise AssertionError(f"resumed launches {launches}, phase 4's "
                             f"{want_launches}")
    fresh = {"captures": tr.engine.captures, "launches": launches}
    del tr
    torch.cuda.empty_cache()

    captures = tr4.engine.captures
    tr4.history = []
    tr4.restore_checkpoint(path)
    launches = counted_run(tr4, ctr, tr4.state.tokens_seen)
    if tr4.engine.captures != captures:
        raise AssertionError(f"{tr4.engine.captures - captures} captures "
                             f"after an in-place restore")
    if hist_rows(tr4.history) != hist_rows(hist4[16:]) or \
            not same_state((tr4.state.model, tr4.state.opt_state), final4):
        raise AssertionError("the in-place restore's replays differ from "
                             "phase 4's")
    if launches != want_launches:
        raise AssertionError(f"replayed launches {launches}, phase 4's "
                             f"{want_launches}")
    gb = nbytes / 1e9
    return {"bytes": nbytes, "leaves": len(man["ck"][1]),
            "write_s": sync_s, "write_gb_s": gb / sync_s,
            "async_write_s": async_write_s,
            "async_write_gb_s": gb / async_write_s,
            "restore_s": restore_s, "restore_gb_s": gb / restore_s,
            "verify_s": verify_s, "verify_gb_s": gb / verify_s,
            "async_stall_s": async_stall_s, "sync_save_s": sync_s,
            "loop_request_s": loop_stall_s, "loop_write_s": loop_write_s,
            "steps_9_16_s_while_saving": stamps[16] - stamps[8],
            "resume_step": meta["step"], "resumed_steps": 3,
            "fresh_trainer": fresh,
            "in_place": {"captures_before": captures,
                         "captures_after": tr4.engine.captures,
                         "launches": launches},
            "bitwise": True}


def controller_replay(losses, sch, fuse: int):
    """The run's plateau controller replayed on the host over the run's
    own losses: each ``fuse``-step chunk's loss EMA by the engine's
    float32 recursion (``ema_update``), fed to a fresh ``AdaptiveSeesaw``
    with the run's knobs.  Returns the cut steps at the run's threshold,
    each plateau test's (step, relative gain) along the run, and the
    band (lo, hi] of thresholds that make the same decisions, so the
    same run: a test with a gain below the threshold does not improve."""
    from repro_torch.core.adaptive import AdaptiveSeesaw
    from repro_torch.train.engine import ema_update
    stream, ema = [], torch.tensor(-1.0)
    for s in range(0, len(losses), fuse):
        chunk = torch.tensor(losses[s:s + fuse], dtype=torch.float32)
        ema = ema_update(ema, chunk, len(chunk), sch["ema_decay"])
        stream.append((len(chunk), float(ema)))
    min_steps = sch.get("plateau_min_steps") or sch["plateau_window"]

    def replay(threshold):
        c = AdaptiveSeesaw(alpha=sch["alpha"], window=sch["plateau_window"],
                           rel_threshold=threshold, max_cuts=sch["n_cuts"],
                           min_steps_between=min_steps)
        gains, test = [], c._test_window

        def traced(mean):
            prev = c._prev_window_mean
            if prev is not None:
                gains.append((c.steps,
                              (prev - mean) / max(abs(prev), 1e-12)))
            return test(mean)

        c._test_window = traced
        for n, e in stream:
            c.observe_smoothed(e, n)
        return c.cut_steps, gains

    t = sch["plateau_threshold"]
    cuts, gains = replay(t)
    # between two neighbouring gains every decision is the same
    edges = [-math.inf] + sorted({g for _, g in gains}) + [math.inf]

    def same(i):
        lo, hi = edges[i], edges[i + 1]
        mid = (hi - 1.0 if lo == -math.inf else
               lo + 1.0 if hi == math.inf else (lo + hi) / 2)
        return replay(mid)[0] == cuts

    i = next(i for i in range(len(edges) - 1) if t <= edges[i + 1])
    j = i
    while i > 0 and same(i - 1):
        i -= 1
    while j < len(edges) - 2 and same(j + 1):
        j += 1
    return cuts, gains, (edges[i], edges[j + 1])


def phase10b(cfg, RN, FA, tmp, knobs=None, steps=ADAPTIVE_STEPS):
    """The adaptive ramp at full width: phase 4's model, data and
    optimizer under ``ADAPTIVE`` for ``steps`` steps.  At least two cuts;
    at each the LR x 1/sqrt(alpha) and the batch x alpha; one graph per
    (batch size, micro).  The run saves (async) at the chunk boundary 4
    steps past its first cut; a fresh trainer restores it with
    ``verify=True`` and must fire the same later cuts and end on the
    uninterrupted run's history and state bit for bit."""
    from repro_torch.train.trainer import Trainer
    sch = dict(ADAPTIVE, **(knobs or {}))
    run = phase4_run(cfg, total_tokens=ADAPTIVE_TOKENS, **sch)
    path = os.path.join(tmp, "adaptive")
    tr = Trainer(run, device="cuda", fuse_steps=4, max_device_batch=8)
    eng = tr.engine
    # each engine call timed to a sync (the controller reads each chunk's
    # EMA, a sync, anyway): (step before, batch size, n, seconds)
    chunks, run_chunk = [], eng.run_chunk

    def timed(model, opt_state, tokens_seen, stacked, n_valid=None, **kw):
        t = time.perf_counter()
        out = run_chunk(model, opt_state, tokens_seen, stacked,
                        n_valid=n_valid, **kw)
        torch.cuda.synchronize()
        chunks.append((tr.state.step, next(iter(stacked.values())).shape[1],
                       n_valid, time.perf_counter() - t))
        return out

    def save_between_cuts():
        cuts = tr.controller.cut_steps
        if len(cuts) == 1 and tr.state.step == cuts[0] + 4:
            tr.save_checkpoint(path, block=False)
        return False

    eng.run_chunk = timed
    tr.run(resumed_loader(tr), max_steps=steps, stop_fn=save_between_cuts)
    eng.run_chunk = run_chunk
    tr.close()
    cuts, hist = tr.controller.cut_steps, tr.history
    out = {"knobs": sch, "steps": len(hist), "cut_steps": cuts,
           "cut_tokens": tr.cut_tokens,
           "batch_sizes": tr.plan.batch_sizes(),
           "losses": [h["loss"] for h in hist],
           "lrs": [h["lr"] for h in hist], "loss_ema": tr.state.loss_ema}
    if len(hist) != steps or not all(np.isfinite(out["losses"])):
        raise AssertionError(f"adaptive run: {out}")
    # a flip of a plateau decision (the threshold left its band) is told
    # apart from a fault (the run's controller disagrees with the host's)
    replayed, gains, band = controller_replay(out["losses"], sch, 4)
    t = sch["plateau_threshold"]
    out.update(replayed_cut_steps=replayed, plateau_gains=gains,
               threshold_band=list(band),
               threshold_margin=min(t - band[0], band[1] - t) / t)
    if replayed != cuts:
        raise AssertionError(f"the run cut at {cuts}, its controller "
                             f"replayed on the host over the run's own "
                             f"losses at {replayed}: {out}")
    if len(cuts) < 2:
        raise AssertionError(f"{len(cuts)} cut(s), as the host replay "
                             f"of this run's losses: a plateau decision "
                             f"moved (thresholds in {band} give these "
                             f"cuts): {out}")
    by_step = {h["step"]: h for h in hist}
    for c in cuts:
        a, b = by_step[c], by_step[c + 1]
        if b["batch_size"] != 2 * a["batch_size"] or \
                abs(b["lr"] * 2 ** 0.5 / a["lr"] - 1) > 1e-6:
            raise AssertionError(f"cut at step {c}: {a} -> {b}")
    keys = sorted({(h["batch_size"], eng.micro_batches(h["batch_size"]))
                   for h in hist})
    if sorted(tr._step_cache) != keys or eng.captures != len(keys):
        raise AssertionError(f"step cache {sorted(tr._step_cache)}, "
                             f"{eng.captures} captures; want {keys}")
    out["graphs"] = [list(k) for k in keys]
    out["cuts"] = background_captures(eng, cuts, chunks)

    tr2 = Trainer(run, device="cuda", fuse_steps=4, max_device_batch=8)
    meta = tr2.restore_checkpoint(path, verify=True)
    tr2.run(resumed_loader(tr2, tr2.state.tokens_seen), max_steps=steps)
    if tr2.controller.cut_steps != cuts or \
            hist_rows(tr2.history) != hist_rows(hist[meta["step"]:]) or \
            not same_state((tr2.state.model, tr2.state.opt_state),
                           (tr.state.model, tr.state.opt_state)):
        raise AssertionError(f"resume at step {meta['step']}: cuts "
                             f"{tr2.controller.cut_steps}, want {cuts}; "
                             f"or the history or state differ")
    out.update(resume_step=meta["step"], resumed_cut_steps=cuts,
               bitwise=True)
    return out


def background_captures(eng, cuts, chunks) -> list:
    """At each cut: the new key's graph, captured in the background from
    the cut's boundary (``capture_s``), the main thread's wait for it at
    the key's first chunk (``join_wait_s``), that chunk's wall, and the
    median wall a step of the key's later chunks; ``stall_s``, the first
    less as many steady steps, is what the background capture did not
    hide."""
    rows = []
    for c in cuts:
        after = [ch for ch in chunks if ch[0] >= c]
        b = after[0][1]
        key = (b, eng.micro_batches(b))
        ent = eng._cache[key]
        steady = [dt / n for _, bb, n, dt in after[1:] if bb == b]
        first, n_first = after[0][3], after[0][2]
        if key not in eng.prewarm_wait_s or not steady:
            raise AssertionError(f"cut at step {c}: key {key} was not "
                                 f"captured in the background, or no "
                                 f"steady chunk followed")
        row = {"step": c, "batch_size": b, "key": list(key),
               "capture_s": ent.graph.capture_s,
               "join_wait_s": eng.prewarm_wait_s[key],
               "first_chunk_s": first, "first_chunk_steps": n_first,
               "steady_step_s": float(np.median(steady)),
               "steady_chunks": len(steady)}
        row["stall_s"] = first - n_first * row["steady_step_s"]
        rows.append(row)
    return rows


def phase10(cfg, RN, FA, tr4, hist4, final4, per_micro):
    """Checkpoint and adaptive, on the card; the checkpoints go to a
    temporary directory that the phase deletes."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        out = phase10a(cfg, RN, FA, tr4, hist4, final4, per_micro, tmp)
        torch.cuda.empty_cache()
        adaptive = phase10b(cfg, RN, FA, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, adaptive


# --------------------------------------------------------------------- #
# phases 6 and 7: Mamba-2 training
# --------------------------------------------------------------------- #

def mamba2_counters(RN, FA, SSD):
    """The launch counters phase 6 reads: Mamba-2's kernels, and the flash
    kernels, which it must not launch."""
    return {"ssd_chunk": (SSD, "launches"),
            "rmsnorm_fwd": (RN, "launches"),
            "rmsnorm_bwd": (RN, "bwd_launches"),
            "flash_fwd": (FA, "launches"),
            "flash_bwd_dq": (FA, "dq_launches"),
            "flash_bwd_dkv": (FA, "dkv_launches")}


def phase6(cfg, RN, FA, SSD):
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    # base LR 8e-4: five times GPT-3's 2.7B rate, the Mamba recipe
    run = RunConfig(model=cfg,
                    schedule=ScheduleConfig(kind="seesaw", base_lr=8e-4,
                                            alpha=2.0, n_cuts=2),
                    optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                              beta2=0.95, grad_clip=1.0),
                    seq_len=2048, global_batch_size=4,
                    total_tokens=11 * 4 * 2048, dtype="bfloat16")
    tr, out = run_ramp(run, mamba2_counters(RN, FA, SSD), fuse_steps=1,
                       max_device_batch=4,
                       want=([4, 8, 16], [7, 1, 1], [1, 2, 4]))
    if not out["loss_last"] < out["loss_first"]:
        raise AssertionError(f"last loss {out['loss_last']} not below the "
                             f"first {out['loss_first']}")
    L = cfg.n_layers
    check_launches(out, {"ssd_chunk": 2 * L, "rmsnorm_fwd": 4 * L + 1,
                         "rmsnorm_bwd": 2 * L + 1, "flash_fwd": 0,
                         "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    out["param_count"] = sum(p.numel() for p in tr.state.model.parameters())
    return tr, out


def phase7(R):
    """The reduced mamba2 (2 layers, d=256, 8 heads, d_state 16, chunk 32)
    in float32 on the card and on the CPU with the same weights: the loss
    and every grad, S=200 (a ragged last chunk)."""
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLM
    small = get_config("mamba2-2.7b").reduced()
    cpu = R.init_model(small, seed=4, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(small, seed=4, dtype=torch.float32, device="cpu",
                        trainable=True).cuda()
    raw = MarkovLM(small.vocab_size, seed=3).sample(0, 2, 200)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                 for k, v in raw.items()}
        loss, _ = R.loss_fn(model, small, batch, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    loss_diff = abs(out["cpu"][0] - out["cuda"][0])
    if loss_diff > 1e-4:
        raise AssertionError(f"loss differs by {loss_diff:.3g}")
    grad_rel = 0.0
    for (name, _), a, b in zip(cpu.named_parameters(), out["cpu"][1],
                               out["cuda"][1]):
        rel = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        if rel > 1e-3:
            raise AssertionError(f"grad of {name}: {rel:.3g} of its max")
        grad_rel = max(grad_rel, rel)
    raw3 = MarkovLM(small.vocab_size, seed=3).sample(0, 6, 200)
    raw3 = {k: v.reshape(3, 2, 200) for k, v in raw3.items()}
    return {"loss_cpu": out["cpu"][0], "loss_cuda": out["cuda"][0],
            "loss_abs_diff": loss_diff, "grad_max_rel_diff": grad_rel,
            **replayed_card_vs_cpu(small, cpu, raw3)}


# --------------------------------------------------------------------- #
# phases 11 and 11b: Mamba-2 served from the recurrent state pool
# --------------------------------------------------------------------- #

def serve_counters(RN, FA, PG, SSD, OV):
    """Every kernel's launch counter: phase 11 reads the two Mamba-2
    serving launches and holds the others at 0."""
    return dict(mamba2_counters(RN, FA, SSD),
                ragged_decode=(PG, "launches"),
                overlap_norm=(OV, "launches"))


def decode_step_bytes(model, eng) -> int:
    """The least bytes a decode step moves: every weight read once, and
    each slot's state (h and the conv rows) read and written once."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    page = sum(t[:, 0].numel() * t.element_size()
               for t in eng.pool.leaves())
    return weights + 2 * eng.decode_slots * page


def profile_state_decode(cfg, eng, serving, reqs):
    """Replayed decode steps under torch.profiler: 8 requests of the mix
    (lengths already captured) fill the slots, then two ``step()`` calls
    with nothing to admit, the second timed to a sync.  A profiler's
    first replay can lose its first kernels (126 of a step's 128 ``w_z``
    and ``w_x`` GEMVs were seen once), so only the second step's kernels
    count: those after the widest gap on the device timeline, the host's
    time between the two replays.  Reports their sum (busy), the span
    from its first kernel's start to its last one's end (the sum plus
    the gaps between the graph's kernels) and the top kernels
    (``second_step_kernels``); then 8 more steps between CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    for prompt, _ in reqs[:eng.decode_slots]:
        eng.submit(serving.GenerationRequest(prompt=prompt,
                                             max_new_tokens=24))
    eng.step()                          # admits all and decodes once
    if eng.n_pending or eng.n_active != eng.decode_slots:
        raise AssertionError("the profiled step's slots are not all live")
    captures0 = eng.captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t = time.perf_counter()
    for _ in range(8):
        eng.step()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / 8
    events_ms = start.elapsed_time(end) / 8
    eng.drain()
    if eng.captures != captures0:
        raise AssertionError("the profiled decode steps captured a graph")
    return {**second_step_kernels(prof, wall_us, "profile_mamba2_decode.txt"),
            "step_ms_events": events_ms, "step_ms_host": host_ms}


def second_step_kernels(prof, wall_us: float, fname: str) -> dict:
    """The kernels of the second of two profiled steps: those after the
    widest gap on the device timeline, the host's time between the two
    replays (a profiler's first replay can lose its first kernels).
    Their summed time (busy) over the second step's wall, the span from
    its first kernel's start to its last one's end (the sum plus the
    gaps between the graph's kernels), the top kernels; the table goes
    to ``chiprun_out/<fname>``."""
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if len(kern) > 1:
        cut = max(range(1, len(kern)),
                  key=lambda i: kern[i][0] - kern[i - 1][1])
        kern = kern[cut:]
    by_name = {}
    for s0, s1, name in kern:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + s1 - s0, n + 1)
    top = sorted(((us, name, n) for name, (us, n) in by_name.items()),
                 reverse=True)
    busy_us = sum(us for us, _, _ in top)
    span_us = kern[-1][1] - kern[0][0] if kern else 0.0
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "device_span_us": span_us, "device_kernels": len(kern),
            "rmsnorm_kernels_seen": sum(n for _, name, n in top
                                        if "rmsnorm_fwd" in name),
            "profiled_steps": 2, **host_calls(prof.key_averages()),
            "top_kernels": [{"us": us, "name": name[:90], "count": n}
                            for us, name, n in top[:12]]}


def phase11(cfg, R, serving, ctr, smi):
    """mamba2-2.7b at full width and depth, bf16, served in the engine's
    state mode: 8 slots, max_len 1024, phase 2's request mix."""
    torch.cuda.reset_peak_memory_stats()
    model = R.init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = serving.ServingEngine(cfg, model, decode_slots=8, max_len=1024,
                                dtype=torch.bfloat16)
    if (eng.mode, eng.page_size, eng.pages_per_slot) != ("state", 1, 1):
        raise AssertionError(f"engine mode {eng.mode}, page size "
                             f"{eng.page_size}")
    reqs = requests(cfg)
    lengths = sorted({len(p) for p, _ in reqs})
    # warm-up, outside the counted run: the first prefill and the first
    # decode run eagerly; then one graph per distinct prompt length of
    # the mix and the decode graph are captured
    rng = np.random.default_rng(11)
    for n in lengths[:1] + lengths:
        eng.submit(serving.GenerationRequest(
            prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=4))
    eng.drain()
    eng.reset()
    if eng.captures != len(lengths) + 1:
        raise AssertionError(f"warm-up captured {eng.captures} graphs, "
                             f"want {len(lengths) + 1}")
    warm = {"captures": eng.captures, "captures_s": eng.capture_s}
    for m, a in ctr.values():
        setattr(m, a, 0)
    rids, results, wall = serve(eng, serving, reqs)
    launches = {n: getattr(m, a) for n, (m, a) in ctr.items()}
    steps, occupancy = eng.steps, eng.mean_occupancy()
    if eng.captures != warm["captures"]:
        raise AssertionError(f"{eng.captures - warm['captures']} graphs "
                             f"captured during the timed run")
    if (eng.n_prefill_executables, eng.n_decode_executables) != \
            (len(lengths), 1) or eng.executables != eng.executable_budget:
        raise AssertionError(f"{eng.n_prefill_executables} prefill + "
                             f"{eng.n_decode_executables} decode entries, "
                             f"budget {eng.executable_budget}, "
                             f"{len(lengths)} lengths")
    L = cfg.n_layers
    want = dict({n: 0 for n in ctr}, ssd_chunk=L * len(reqs),
                rmsnorm_fwd=(2 * L + 1) * (len(reqs) + steps))
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    n_tok = 0
    for rid, res, (prompt, n) in zip(rids, results, reqs):
        if res is None or len(res.tokens) != n \
                or res.finish_reason != "length":
            raise AssertionError(f"rid {rid}: {res}, want {n} tokens")
        # the greedy runs over the padded vocab, as the reference's does
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.padded_vocab:
            raise AssertionError(f"rid {rid}: token out of the vocab")
        n_tok += n
    if eng.pool.n_used != 0:
        raise AssertionError(f"{eng.pool.n_used} pages still in use")
    # the same mix through an engine whose every call runs eagerly
    ref = serving.ServingEngine(cfg, model, decode_slots=8, max_len=1024,
                                dtype=torch.bfloat16)
    ref._warm = _EveryCallEager()
    _, eager, eager_wall = serve(ref, serving, reqs)
    if ref.captures:
        raise AssertionError("the eager reference engine captured graphs")
    for rid, a, b in zip(rids, results, eager):
        if b is None or a.tokens.tolist() != b.tokens.tolist():
            raise AssertionError(f"rid {rid}: replayed tokens differ from "
                                 f"the eager engine's")
    del ref
    torch.cuda.empty_cache()
    eng.reset()
    prof = profile_state_decode(cfg, eng, serving, reqs)
    step_bound = bound(decode_step_bytes(model, eng), 0, torch.bfloat16)
    return {"model": cfg.name, "requests": len(reqs), "tokens": n_tok,
            "prompt_tokens": int(sum(len(p) for p, _ in reqs)),
            "distinct_lengths": len(lengths), "decode_steps": steps,
            "wall_s": wall, "tok_per_s": n_tok / wall,
            "mean_occupancy": occupancy,
            "launches": launches,
            "n_prefill_executables": eng.n_prefill_executables,
            "n_decode_executables": eng.n_decode_executables,
            "executables": eng.executables,
            "executable_budget": eng.executable_budget,
            "captures": warm["captures"], "captures_s": warm["captures_s"],
            "eager_wall_s": eager_wall,
            "eager_tok_per_s": n_tok / eager_wall,
            "tokens_equal_eager": True,
            "pool_bytes": eng.pool.nbytes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_step": {**prof, "bound_ms": step_bound["bound_ms"],
                            "bound_bytes": step_bound["bytes"]},
            "card": smi}


def phase11b(R, serving):
    """The reduced mamba2 in float32 served on the card and on the CPU
    with the same weights: first-token logits within 1e-3 and equal
    greedy tokens over a short mix (prompts of 2-100); on the card, the
    prefill of p[:-8] and 8 decode steps of p's last 8 tokens give the
    prefill of p's logits within 1e-3."""
    from repro_torch.configs import get_config
    small = get_config("mamba2-2.7b").reduced()
    cpu = R.init_model(small, seed=5, dtype=torch.float32, device="cpu")
    card = R.init_model(small, seed=5, dtype=torch.float32,
                        device="cpu").cuda()
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, small.vocab_size, n).astype(np.int32), k)
            for n, k in ((2, 6), (37, 8), (100, 5), (64, 7), (37, 4))]
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        logits = []
        with torch.inference_mode():
            for prompt, _ in reqs:
                toks = torch.from_numpy(prompt.astype(np.int64))[None]
                lg, _ = R.prefill(model, small, toks.to(dev))
                logits.append(lg.cpu())
        eng = serving.ServingEngine(small, model, decode_slots=2,
                                    max_len=128, dtype=torch.float32)
        for prompt, n in reqs:
            eng.submit(serving.GenerationRequest(prompt=prompt,
                                                 max_new_tokens=n))
        out[dev] = (logits, {r.rid: r.tokens.tolist() for r in eng.drain()})
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][0], out["cpu"][0]))
    if diff > 1e-3:
        raise AssertionError(f"first-token logits differ by {diff:.3g}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"tokens differ: card {out['cuda'][1]}, "
                             f"cpu {out['cpu'][1]}")
    k = 8
    p = torch.from_numpy(rng.integers(0, small.vocab_size, 150))[None]
    p = p.cuda()
    with torch.inference_mode():
        want, _ = R.prefill(card, small, p)
        got, cache = R.prefill(card, small, p[:, :-k])
        for i in range(k, 0, -1):
            got, cache = R.decode_step(card, small, cache,
                                       p[:, -i:p.shape[1] - i + 1])
    step_diff = float((got - want).abs().max())
    if step_diff > 1e-3 or cache.lengths.tolist() != [p.shape[1]]:
        raise AssertionError(f"prefill + {k} decode steps differ from the "
                             f"prefill by {step_diff:.3g}")
    return {"first_token_logit_max_abs_diff": diff,
            "tokens": out["cuda"][1],
            "prefill_plus_decode_vs_prefill_max_abs_diff": step_diff,
            "decode_steps": k}


# --------------------------------------------------------------------- #
# phase 12: the blocking Server over the contiguous caches
# --------------------------------------------------------------------- #

def quiet_generate(srv, toks, n_new, prefix_emb=None):
    """``srv.generate`` without its DeprecationWarning, timed to its end
    (it returns after reading the tokens back): (tokens, seconds)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = srv.generate(toks, n_new, prefix_emb=prefix_emb)
    return out, time.perf_counter() - t


def event_ms(fn, reps: int) -> float:
    """Median device ms of ``fn()`` between CUDA events over ``reps``
    calls, the queue drained before each."""
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def server_step(srv, cfg, positions: int, smi, profile_name=None,
                n_bytes=None):
    """The Server's one captured decode graph, each replay continuing the
    last batch from where it stopped: ``step_ms``, the mean of 10
    replays queued back to back between CUDA events (as a generation
    queues its steps; median of 3 runs), and ``one_replay_ms``, one
    replay on a drained queue (median of 10; it adds the graph launch's
    latency), beside the step's bytes bound: every weight read once (of
    the embedding only the rows the batch looks up, when it is not the
    tied head) and the ``positions`` cache slots a row reads, K and V,
    every layer.  ``n_bytes`` replaces that count where the cache is
    not a K/V cache in every layer (the hybrid's: ``hybrid_step_bytes``).
    With ``profile_name``, two more replays under torch.profiler."""
    (ent,) = [e for e in srv._decode_fns.values() if e.graph is not None]
    model = srv.model
    B = ent.token.shape[0]
    es = model.tok.element_size()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if model.lm_head is not None:
        weights -= model.tok.numel() * es - B * cfg.d_model * es
    cache = B * cfg.n_layers * positions * 2 * cfg.kv_dim * es
    if n_bytes is not None:
        weights, cache = None, None
    replay = ent.graph.replay
    one_ms = event_ms(replay, 10)
    step_ms = event_ms(lambda: [replay() for _ in range(10)], 3) / 10
    out = {"step_ms": step_ms, "one_replay_ms": one_ms,
           **bound(n_bytes if n_bytes is not None else weights + cache, 0,
                   srv.dtype),
           "weight_bytes": weights, "cache_bytes": cache,
           "batch": B, "card": smi}
    if profile_name:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
            t = time.perf_counter()
            replay()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        out["profile"] = second_step_kernels(prof, wall_us, profile_name)
        # the profiler's own cost stretches the profiled wall; the busy
        # share of a step as the events time it
        out["profile"]["device_busy_share_of_step_ms"] = \
            out["profile"]["device_busy_us"] / (step_ms * 1e3)
    return out


def eager_server(Server, cfg, model, **kw):
    """A Server whose every decode step runs eagerly: the reference its
    replayed tokens are held to."""
    srv = Server(cfg, model, **kw)
    srv._warm = _EveryCallEager()
    return srv


def phase12a(cfg, R, serving, Server, ctr, smi):
    """seesaw-150m at full width and depth.  bf16: ``Server(max_len=
    1024)`` generates 64 tokens for 8 prompts of 500 (bucket 512), after
    a warm-up that runs the entry's first step eagerly and captures its
    graph; launches exact, tokens equal to an all-eager Server's; tok/s,
    the prefill's ms and a replayed step against its bound.  float32:
    phase 2's first 8 requests through the engine at 8 slots and each
    alone through a Server sized to the engine's page window with its
    buckets (the reference's oracle test): first-token logits within
    1e-3 (the Server's prefill against the engine's prefill entry's
    function), greedy tokens equal."""
    bf = torch.bfloat16
    L = cfg.n_layers
    model = R.init_model(cfg, seed=0, dtype=bf, device="cuda")
    srv = Server(cfg, model, max_len=1024, dtype=bf)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (8, 500)).astype(np.int32)
    quiet_generate(srv, toks, 3)     # eager first step, then the capture
    if srv.captures != 1:
        raise AssertionError(f"warm-up captured {srv.captures} graphs")
    for m, a in ctr.values():
        setattr(m, a, 0)
    out, wall = quiet_generate(srv, toks, 64)
    launches = {n: getattr(m, a) for n, (m, a) in ctr.items()}
    want = dict({n: 0 for n in ctr}, rmsnorm_fwd=(2 * L + 1) * 64,
                flash_fwd=L, ragged_decode=L * 63)
    if launches != want or srv.captures != 1:
        raise AssertionError(f"launches {launches}, want {want}; "
                             f"{srv.captures} captures")
    eager, eager_wall = quiet_generate(
        eager_server(Server, cfg, model, max_len=1024, dtype=bf), toks, 64)
    if not np.array_equal(out, eager):
        raise AssertionError("replayed tokens differ from the eager ones")
    if out.min() < 0 or out.max() >= cfg.padded_vocab:
        raise AssertionError("token out of the vocab")
    dev = torch.from_numpy(toks.astype(np.int64)).cuda()
    prefill_ms = event_ms(lambda: srv.prefill(dev), 5)
    step = server_step(srv, cfg, 500 + 63 + 1, smi)
    bf_rec = {"batch": 8, "prompt": 500, "bucket": 512, "new": 64,
              "wall_s": wall, "tok_per_s": 8 * 64 / wall,
              "eager_wall_s": eager_wall,
              "eager_tok_per_s": 8 * 64 / eager_wall,
              "tokens_equal_eager": True, "launches": launches,
              "captures": srv.captures, "captures_s": srv.capture_s,
              "n_prefill_executables": srv.n_prefill_executables,
              "prefill_ms": prefill_ms, "decode_step": step}
    del srv, model
    torch.cuda.empty_cache()
    return {**bf_rec, "oracle": engine_vs_solo_server(cfg, R, serving,
                                                      Server)}


def engine_vs_solo_server(cfg, R, serving, Server):
    """float32: phase 2's first 8 requests through the engine at 8 slots
    and each alone through a Server sized to the engine's page window
    with its buckets (the reference's oracle test): first-token logits
    within 1e-3 (the Server's prefill against the engine's prefill
    entry's function), greedy tokens equal."""
    f32 = torch.float32
    model = R.init_model(cfg, seed=0, dtype=f32, device="cuda")
    eng = serving.ServingEngine(cfg, model, decode_slots=8, page_size=16,
                                max_len=1024, dtype=f32)
    reqs = requests(cfg)[:8]
    rids, results, _ = serve(eng, serving, reqs)
    oracle = Server(cfg, model, max_len=eng.pages_per_slot * eng.page_size,
                    buckets=eng.buckets, dtype=f32)
    diff = 0.0
    for rid, res, (prompt, n) in zip(rids, results, reqs):
        solo, _ = quiet_generate(oracle, prompt[None], n)
        if res is None or res.tokens.tolist() != solo[0].tolist():
            raise AssertionError(f"rid {rid}: the engine's tokens differ "
                                 f"from the solo Server's")
        S = len(prompt)
        bucket = eng._bucket_for(S)
        padded = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
        padded[0, :S] = torch.from_numpy(prompt.astype(np.int64))
        with torch.inference_mode():
            got, _ = oracle.prefill(padded[:, :S])
            want, _, _ = R.prefill_ragged(
                model, cfg, padded, torch.tensor([S], dtype=torch.int32,
                                                 device="cuda"))
        diff = max(diff, float((got - want).abs().max()))
    if diff > 1e-3:
        raise AssertionError(f"first-token logits differ by {diff:.3g}")
    return {"requests": len(reqs), "dtype": "float32",
            "tokens_equal": True, "first_token_logit_max_abs_diff": diff,
            "oracle_max_len": oracle.max_len,
            "oracle_captures": oracle.captures}


def phase12b(cfg, R, Server, ctr, smi):
    """starcoder2-3b at full width and depth, bf16, ``Server(max_len=
    8192)``: a ring of W = 4096 slots a layer.  Batch (i): 2 prompts of
    4,500, 64 new (the window binds in the prefill, the ring is built
    from S >= W); batch (ii): 2 prompts of 4,000, 160 new (the ring
    wraps at decode step 97).  Launches exact (the ragged decode 30 a
    decode step, the RMSNorm forward 61 a prefill and a decode step,
    flash 0), tokens equal to an all-eager Server's; tok/s, the
    prefill's seconds, peak memory, a replayed step against its bound
    and under torch.profiler; and one windowed layer's attention
    (``chunked_attention``) at S = 4,500 beside the flash kernel's with
    no window."""
    from repro_torch.kernels import backend as KB
    from repro_torch.models.attention import chunked_attention
    bf = torch.bfloat16
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = R.init_model(cfg, seed=0, dtype=bf, device="cuda")
    srv = Server(cfg, model, max_len=8192, dtype=bf)
    eager = eager_server(Server, cfg, model, max_len=8192, dtype=bf)
    rng = np.random.default_rng(13)
    quiet_generate(srv, rng.integers(0, cfg.vocab_size, (2, 64)), 3)
    if srv.captures != 1:
        raise AssertionError(f"warm-up captured {srv.captures} graphs")
    batches = {}
    for tag, S, n_new in (("i", 4500, 64), ("ii", 4000, 160)):
        toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        for m, a in ctr.values():
            setattr(m, a, 0)
        out, wall = quiet_generate(srv, toks, n_new)
        launches = {n: getattr(m, a) for n, (m, a) in ctr.items()}
        want = dict({n: 0 for n in ctr}, rmsnorm_fwd=(2 * L + 1) * n_new,
                    ragged_decode=L * (n_new - 1))
        if launches != want or srv.captures != 1:
            raise AssertionError(f"batch {tag}: launches {launches}, want "
                                 f"{want}; {srv.captures} captures")
        ref_out, eager_wall = quiet_generate(eager, toks, n_new)
        if not np.array_equal(out, ref_out):
            raise AssertionError(f"batch {tag}: replayed tokens differ "
                                 f"from the eager ones")
        if out.min() < 0 or out.max() >= cfg.padded_vocab:
            raise AssertionError(f"batch {tag}: token out of the vocab")
        dev = torch.from_numpy(toks.astype(np.int64)).cuda()
        batches[tag] = {"batch": 2, "prompt": S, "new": n_new,
                        "wall_s": wall, "tok_per_s": 2 * n_new / wall,
                        "eager_wall_s": eager_wall,
                        "eager_tok_per_s": 2 * n_new / eager_wall,
                        "tokens_equal_eager": True, "launches": launches,
                        "prefill_s": event_ms(lambda: srv.prefill(dev),
                                              3) / 1e3}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step = server_step(srv, cfg, 4096, smi, "profile_starcoder2_decode.txt")
    del srv, eager
    torch.cuda.empty_cache()
    # one windowed layer's attention at S = 4,500 beside flash's
    g = torch.Generator(device="cuda").manual_seed(12)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn(2, 4500, H, hd, generator=g, device="cuda").to(bf)
    k = torch.randn(2, 4500, Hkv, hd, generator=g, device="cuda").to(bf)
    v = torch.randn(2, 4500, Hkv, hd, generator=g, device="cuda").to(bf)
    timer = Timer(iters=10)
    with torch.inference_mode():
        window_ms = timer(lambda: chunked_attention(
            q, k, v, window=cfg.sliding_window))
        flash_ms = timer(lambda: KB.attention(q, k, v))
    return {"model": cfg.name, "params": cfg.param_count(),
            "weight_gb": sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 1e9,
            "max_len": 8192, "ring_slots": min(cfg.sliding_window, 8192),
            "batches": batches, "captures": 1, "peak_mem_gb": peak,
            "decode_step": step,
            "windowed_attention_layer_ms": window_ms,
            "flash_layer_ms_no_window": flash_ms,
            "attention_shape": f"q (2, 4500, {H}, {hd}), k/v (2, 4500, "
                               f"{Hkv}, {hd}) bf16", "card": smi}


def phase12c(cfg, R, Server):
    """The ring's numbers.  float32 on the card, starcoder2-3b's full
    width cut to 4 layers: the prefill of p[:-k] then k decode steps give
    the prefill of p's last logits within 1e-3, at (S0 = 4,090, k = 12),
    which wraps the ring during the decode, and (4,500, 8).  The reduced
    starcoder2 (window 64) in float32 on the card and on the CPU with
    the same weights: first-token logits within 1e-3 and equal greedy
    tokens over prompts that wrap its 64-slot ring."""
    f32 = torch.float32
    cut = dataclasses.replace(cfg, n_layers=4)
    model = R.init_model(cut, seed=1, dtype=f32, device="cuda")
    rng = np.random.default_rng(14)
    ring = {}
    with torch.inference_mode():
        for S0, k in ((4090, 12), (4500, 8)):
            p = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (1, S0 + k))).cuda()
            want, _ = R.prefill(model, cut, p, cache_len_cap=8192)
            got, cache = R.prefill(model, cut, p[:, :S0], cache_len_cap=8192)
            for i in range(S0, S0 + k):
                got, cache = R.decode_step(model, cut, cache, p[:, i:i + 1])
            d = float((got - want).abs().max())
            if d > 1e-3 or cache.lengths.tolist() != [S0 + k]:
                raise AssertionError(f"S0 {S0}, k {k}: prefill + decode "
                                     f"differ from the prefill by {d:.3g}")
            ring[f"S0={S0},k={k}"] = d
    del model, cache
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    small = get_config("starcoder2-3b").reduced()
    batches = [(rng.integers(0, small.vocab_size, (2, 60)), 20),
               (rng.integers(0, small.vocab_size, (1, 100)), 30)]
    diff, toks = server_card_vs_cpu(small, R, Server, batches, seed=5)
    return {"prefill_plus_decode_vs_prefill_max_abs_diff": ring,
            "reduced_first_token_logit_max_abs_diff": diff,
            "reduced_tokens": toks}


def server_card_vs_cpu(small, R, Server, batches, seed):
    """``small`` in float32 through a Server on the card and on the CPU,
    the same weights (``seed``): each batch's first-token logits within
    1e-3, its greedy tokens equal.  A batch is (tokens, n_new) or
    (tokens, n_new, prefix_emb).  Returns (the logits' largest
    difference, the card's tokens)."""
    f32 = torch.float32
    cpu = R.init_model(small, seed=seed, dtype=f32, device="cpu")
    card = R.init_model(small, seed=seed, dtype=f32, device="cpu").cuda()
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        srv = Server(small, model, max_len=256, dtype=f32)
        logits, toks = [], []
        for t, n, *pre in batches:
            pre = pre[0] if pre else None
            with torch.inference_mode():
                lg, _ = srv.prefill(torch.from_numpy(t).to(dev), pre)
            logits.append(lg.cpu())
            toks.append(quiet_generate(srv, t, n, prefix_emb=pre)[0]
                        .tolist())
        out[dev] = (logits, toks)
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][0], out["cpu"][0]))
    if diff > 1e-3:
        raise AssertionError(f"{small.name}: first-token logits differ by "
                             f"{diff:.3g}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"{small.name}: tokens differ: card "
                             f"{out['cuda'][1]}, cpu {out['cpu'][1]}")
    return diff, out["cuda"][1]



# --------------------------------------------------------------------- #

# --------------------------------------------------------------------- #
# phase 13: the paper's runs
# --------------------------------------------------------------------- #

# (B, S, H, Hkv, tag): the figure LMs' attention (4 heads of 32, S = 64,
# B = 8 and the ramp's 128), a ragged S and GQA; hd 32 throughout
FLASH_HD32 = ((8, 64, 4, 4, "fig-B8"), (128, 64, 4, 4, "fig-B128"),
              (8, 77, 4, 4, "ragged-S77"), (8, 64, 4, 2, "gqa"))
# 13c: seesaw-150m at its CBS, the horizon cut to 20 cosine steps and the
# schedule to 2 cuts (the reference's planner then keeps every token)
PAPER_HORIZON, PAPER_CUTS, PAPER_MICRO = 20, 2, 32


def phase13a(FA, ref):
    """The flash forward, dq and dk/dv at hd 32 against their plain
    versions in float32 (2e-5) and bfloat16 (2e-2) at ``FLASH_HD32``, then
    timed in bfloat16 at the two figure-LM shapes."""
    g = torch.Generator(device="cuda").manual_seed(13)
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for B, S, H, Hkv, tag in FLASH_HD32:
            q, k, v, do = (torch.randn(B, S, n, 32, generator=g,
                                       device="cuda").to(dtype)
                           for n in (H, Hkv, Hkv, H))
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            out, lse = FA.flash_fwd(qt, kt, vt)
            torch.cuda.synchronize()
            want, want_lse = ref.attention_ref(qt, kt, vt)
            errors.append(("flash_fwd", f"hd32-{tag}", dn,
                           max(max_err(out, want, dtype),
                               max_err(lse, want_lse, dtype))))
            dq, dk, dv = FA.flash_bwd(qt, kt, vt, out, lse, dot)
            torch.cuda.synchronize()
            wq, wk, wv = ref.flash_bwd_ref(qt, kt, vt, out, lse, dot)
            errors.append(("flash_bwd_dq", f"hd32-{tag}", dn,
                           max_err(dq, wq, dtype)))
            errors.append(("flash_bwd_dkv", f"hd32-{tag}", dn,
                           max(max_err(dk, wk, dtype),
                               max_err(dv, wv, dtype))))
            inputs[(tag, dn)] = (qt, kt, vt, out, lse, dot)
    for name, tag, dn, err in errors:
        log(f"phase 13a: {name} {tag} {dn}: max |err| {err:.3g}")
    timer = Timer(iters=30)
    times = {tag: flash_rows(FA, ref, inputs[(tag, "bfloat16")], timer)
             for tag in ("fig-B128", "fig-B8")}
    return errors, times


def per_micro_batch(cfg, remat: bool) -> dict:
    """The five training kernels' launches a micro-batch: under remat
    each layer's forward kernels run twice."""
    L, r = cfg.n_layers, 2 if remat else 1
    return {"rmsnorm_fwd": 2 * L * r + 1, "rmsnorm_bwd": 2 * L + 1,
            "flash_fwd": L * r, "flash_bwd_dq": L, "flash_bwd_dkv": L}


def figure1_card_vs_cpu(steps=10):
    """Figure 1's model and Seesaw plan in float32 on the card and on the
    CPU from the same weights, for its first ``steps`` steps: the loss
    within 1e-4 at every step, LR, batch and phase equal."""
    from repro_torch.bench import figure1 as F1
    from repro_torch.data import MarkovLM, PhaseDataLoader
    from repro_torch.train.trainer import Trainer
    cfg = F1.config("seesaw", dtype="float32")
    hist = {}
    cpu = Trainer(cfg, device="cpu")
    card = Trainer(cfg, device="cuda")
    card.state.model.load_state_dict(cpu.state.model.state_dict())
    for dev, tr in (("cpu", cpu), ("cuda", card)):
        hist[dev] = tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan,
                                           cfg.seq_len, device=dev),
                           max_steps=steps)
    diffs = []
    for a, b in zip(hist["cuda"], hist["cpu"]):
        if (a["lr"], a["batch_size"], a["phase"], a["tokens"]) != \
                (b["lr"], b["batch_size"], b["phase"], b["tokens"]):
            raise AssertionError(f"figure 1, step {a['step']}: card {a}, "
                                 f"CPU {b}")
        diffs.append(abs(a["loss"] - b["loss"]))
    if len(diffs) != steps or max(diffs) > 1e-4:
        raise AssertionError(f"figure 1 card vs CPU: {len(diffs)} steps, "
                             f"loss diffs {diffs}")
    return {"steps": steps, "max_loss_diff": max(diffs),
            "loss_diffs": diffs,
            "losses": [h["loss"] for h in hist["cuda"]]}


def phase13b(ctr):
    """The paper's suites of ``repro_torch.bench.run`` on the card (its
    ``engine`` and ``serve`` suites run in phase 14d), in process: every
    row (an ``ERROR`` row fails the phase), and each LM run's launches,
    set to 0 just before its ``Trainer.run`` and read just after, exactly
    ``per_micro_batch`` times its micro-batches.  Then the float32 gate
    of figure 1 against the CPU."""
    from repro_torch.bench import figure1 as F1
    from repro_torch.bench import run as BR
    from repro_torch.train import trainer as TRN
    runs, rows, suite_s = [], [], {}
    plain_run = TRN.Trainer.run

    def counted_run(self, loader, *a, **kw):
        for mod, attr in ctr.values():
            setattr(mod, attr, 0)
        t = time.perf_counter()
        hist = plain_run(self, loader, *a, **kw)
        torch.cuda.synchronize()
        launches = {n: getattr(mod, attr) for n, (mod, attr) in ctr.items()}
        mb = sum(self.engine.micro_batches(h["batch_size"]) for h in hist)
        want = {k: v * mb for k, v in per_micro_batch(
            self.cfg.model, self.cfg.remat).items()}
        runs.append({"model": self.cfg.model.name,
                     "kind": self.cfg.schedule.kind,
                     "z_loss": self.cfg.z_loss,
                     "weight_decay": self.cfg.optimizer.weight_decay,
                     "dtype": self.cfg.dtype, "steps": len(hist),
                     "tokens": hist[-1]["tokens"],
                     "batch_sizes": sorted({h["batch_size"] for h in hist}),
                     "captures": self.engine.captures,
                     "captures_s": self.engine.capture_s,
                     "wall_s": time.perf_counter() - t,
                     "micro_batches_run": mb, "launches": launches,
                     "launches_ok": launches == want})
        if launches != want:
            raise AssertionError(f"{self.cfg.model.name} "
                                 f"{self.cfg.schedule.kind}: launches "
                                 f"{launches}, want {want}")
        return hist

    TRN.Trainer.run = counted_run
    errors = []
    try:
        for name in BR.SUITES:
            if name in ("engine", "serve"):
                continue
            t = time.perf_counter()
            try:
                got = BR.suite_rows(name, "cuda")
            except Exception as e:       # an ERROR row, then the phase fails
                errors.append(f"{name}/ERROR,0,{type(e).__name__}:{e}")
                log(errors[-1])
                continue
            finally:
                suite_s[name] = time.perf_counter() - t
            for row in got:
                rows.append(BR.csv_row(*row))
                log(f"phase 13b: {rows[-1]}")
    finally:
        TRN.Trainer.run = plain_run
    if errors:
        raise AssertionError(f"phase 13b: {errors}")
    if len(runs) != 7 or not all(r["launches_ok"] for r in runs):
        raise AssertionError(f"phase 13b: {len(runs)} LM runs, want 7: "
                             f"{runs}")
    return {"rows": rows, "runs": runs, "suite_s": suite_s,
            "launches_per_micro_batch": per_micro_batch(
                F1.MODEL, F1.config("cosine").remat),
            "figure1_card_vs_cpu": figure1_card_vs_cpu()}


def paper_cfg(cfg, kind):
    """13c's run: ``paper_run`` of seesaw-150m at its CBS, cut to
    ``PAPER_HORIZON`` cosine steps of tokens and ``PAPER_CUTS`` cuts."""
    from repro_torch.configs.seesaw_paper import CBS, paper_run
    run = paper_run(cfg, kind=kind)
    b0 = CBS[cfg.name]
    return dataclasses.replace(
        run, total_tokens=PAPER_HORIZON * b0 * run.seq_len,
        schedule=dataclasses.replace(run.schedule, n_cuts=PAPER_CUTS))


def phase13c(cfg, ctr):
    """seesaw-150m at its critical batch size, Seesaw against cosine at
    equal tokens (``paper_cfg``), each a fresh ``Trainer`` through
    ``run_ramp`` (one step an engine call, timed to a sync): both train
    exactly the horizon's tokens on the plan at every step, with exact
    launches and a loss that falls at least 0.5 nats.  Reports per step
    the loss, LR, batch, tokens and wall second (captures apart), tok/s
    at each batch size, peak memory, the losses at the token counts both
    runs reach, and the step and second at which each run first comes
    within 0.05 nats of the cosine run's final loss (a reading, not a
    gate)."""
    from repro_torch.core.seesaw import measured_speedup
    want = {"cosine": ([256], [20], [8]),
            "seesaw": ([256, 512, 1024], [14, 1, 1], [8, 16, 32])}
    out, plans = {}, {}
    for kind in ("cosine", "seesaw"):
        run = paper_cfg(cfg, kind)
        tr, res = run_ramp(run, ctr, fuse_steps=1,
                           max_device_batch=PAPER_MICRO, want=want[kind])
        check_launches(res, per_micro_batch(cfg, run.remat))
        tokens = PAPER_HORIZON * run.global_batch_size * run.seq_len
        if res["tokens"] != tokens:
            raise AssertionError(f"13c {kind}: trained {res['tokens']} "
                                 f"tokens, want {tokens}")
        drop = res["losses"][0] - res["loss_last3"]
        if drop < 0.5:
            raise AssertionError(f"13c {kind}: loss fell {drop:.3f} < 0.5 "
                                 f"nats: {res['losses']}")
        hist = tr.history
        # per step: the engine call's seconds, its capture apart
        walls = np.cumsum([dt - cap for _, _, dt, cap in res["chunks"]])
        res.update(kind=kind, loss_drop=drop,
                   tokens_per_step=[h["tokens"] for h in hist],
                   batch_per_step=[h["batch_size"] for h in hist],
                   wall_s_at_step=[float(w) for w in walls],
                   wall_s_excl_captures=float(walls[-1]),
                   micro=PAPER_MICRO, horizon_cosine_steps=PAPER_HORIZON,
                   n_cuts=PAPER_CUTS,
                   tokens_scheduled=tr.plan.total_tokens_scheduled(
                       run.seq_len))
        plans[kind] = tr.plan
        out[kind] = res
        log(f"phase 13c {kind}: {res['steps']} steps, {res['tokens']} "
            f"tokens, wall {res['wall_s']:.1f} s ({res['captures_s']:.1f} "
            f"s captures), {res['per_batch_size']}, peak "
            f"{res['peak_mem_gb']:.2f} GB, losses {res['losses']}")
        del tr
        torch.cuda.empty_cache()
    cos, see = out["cosine"], out["seesaw"]
    common = sorted(set(cos["tokens_per_step"]) & set(see["tokens_per_step"]))
    at = {k: dict(zip(out[k]["tokens_per_step"], out[k]["losses"]))
          for k in out}
    target = cos["losses"][-1] + 0.05
    reach = {}
    for k, r in out.items():
        hit = next((i for i, v in enumerate(r["losses"]) if v <= target),
                   None)
        reach[k] = None if hit is None else {
            "step": hit + 1, "tokens": r["tokens_per_step"][hit],
            "wall_s": r["wall_s_at_step"][hit]}
    return {"runs": out,
            "loss_at_common_tokens": {t: {k: at[k][t] for k in at}
                                      for t in common},
            "final_loss_gap": see["losses"][-1] - cos["losses"][-1],
            "target_loss": target, "first_within_0.05_of_cosine": reach,
            "measured_speedup": measured_speedup(plans["seesaw"],
                                                 plans["cosine"], 1024),
            "wall_ratio_seesaw_over_cosine": (see["wall_s_excl_captures"]
                                              / cos["wall_s_excl_captures"])}


# --------------------------------------------------------------------- #
# phase 14: the MoE family, the ragged decode at hd 32, the reference's
# serving, engine and checkpoint benchmarks
# --------------------------------------------------------------------- #

MOE_ARCH = "granite-moe-1b-a400m"
# (B, Skv, H, Hkv, tag): bench.serve's LM (4 slots over its max_len of
# 128, 4 heads of 32 on 2 kv heads), the figure LMs' heads (MHA) over a
# window of 8 splits, and two groups of 4 query heads a kv head
DECODE_HD32 = ((4, 128, 4, 2, "serve-lm"), (8, 1024, 4, 4, "mha-1024"),
               (8, 1024, 8, 1, "gqa8-1024"))


def phase14a(PG, ref):
    """The ragged decode at head_dim 32 against its plain versions, f32
    (2e-5) and bf16 (2e-2): the gathered entry at ``DECODE_HD32`` (GQA
    2, 1 and 8: two head groups a kv head), the paged entry at 8 slots
    of the same heads at pages of 1 and 16 (page edges, an inactive
    slot, shuffled ids).  Timed in bf16 at bench.serve's decode shape
    and at the 1024 window beside SDPA with a length mask."""
    g = torch.Generator(device="cuda").manual_seed(14)
    rng = np.random.default_rng(14)
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for B, Skv, H, Hkv, tag in DECODE_HD32:
            t, err = decode_case(PG, ref, B, Skv, H, Hkv, 32, dtype, g, rng)
            errors.append(("ragged_decode", f"hd32-{tag}", dn, err))
            inputs[(tag, dn)] = t
            for ps in (1, 16):
                err = paged_case(PG, ref, 8, Skv, H, Hkv, 32, ps, dtype, g,
                                 rng)
                errors.append(("paged_decode", f"hd32-{tag}-ps{ps}", dn,
                               err))
    for name, tag, dn, err in errors:
        log(f"phase 14a: {name} {tag} {dn}: max |err| {err:.3g}")
    timer, bf = Timer(iters=30), torch.bfloat16
    times = {}
    for tag in ("serve-lm", "mha-1024"):
        q, k, v, lengths, lens, _ = inputs[(tag, "bfloat16")]
        B, H, hd = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        es = q.element_size()
        keys = float(np.sum(lens.astype(np.int64) + 1))
        mask = (torch.arange(Skv, device="cuda")[None, :]
                <= lengths.long()[:, None])[:, None, None, :]
        q4 = q[:, :, None]
        times[tag] = dict(
            ms=timer(lambda: PG.ragged_decode_attention(q, k, v, lengths)),
            plain_ms=timer(lambda: ref.ragged_decode_ref(q, k, v,
                                                         lengths)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask, enable_gqa=H != Hkv)),
            shape=f"q (B={B}, H={H}, hd={hd}), Hkv={Hkv}, window "
                  f"Skv={Skv}, lengths {lens.tolist()} bf16",
            **bound(2 * q.numel() * es + 2 * keys * Hkv * hd * es + 4 * B,
                    4 * keys * H * hd, bf))
    log(f"phase 14a: {times}")
    return errors, times


def moe_vs_ref(cfg, M):
    """One granite layer's MoE at full width (B = 8 x 1024 tokens, 4
    groups of 2048), float32, TF32 off, at capacity factor 0.5 (drops):
    ``moe_forward`` against the one-hot ``moe_forward_ref`` on the card:
    y within 1e-5, the kept sets equal, the aux within 1e-6; both
    timed."""
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    gen = torch.Generator(device="cuda").manual_seed(15)
    moe = M.MoE(c, dtype=torch.float32, device="cuda")
    moe.init_weights(gen, c.n_layers)
    x = torch.randn(8, 1024, c.d_model, generator=gen, device="cuda")
    with torch.inference_mode():
        y, aux = M.moe_forward(moe, x, c)
        yr, auxr = M.moe_forward_ref(moe, x, c)
        G, g, cap = M.groups(c, x.shape[0] * x.shape[1])
        probs = torch.softmax((x.reshape(G, g, -1) @ moe.router).float(), -1)
        keep = M._route(probs, c.moe.top_k, cap)[3]
        keep_ref = M.route_ref(probs, c.moe.top_k, cap)[4]
        torch.cuda.synchronize()
        err = float((y - yr).abs().max())
        torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
        if not torch.equal(keep, keep_ref):
            raise AssertionError("the kept sets differ")
        aux_err = max(abs(float(aux[k]) - float(auxr[k])) for k in aux)
        if aux_err > 1e-6:
            raise AssertionError(f"aux differs by {aux_err:.3g}")
        ms = event_ms(lambda: M.moe_forward(moe, x, c), 5)
        ref_ms = event_ms(lambda: M.moe_forward_ref(moe, x, c), 5)
    return {"tokens": 8 * 1024, "groups": G, "capacity": cap,
            "capacity_factor": 0.5,
            "frac_dropped": float(aux["frac_dropped"]),
            "y_max_abs_err": err, "aux_max_abs_err": aux_err,
            "kept_equal": True, "ms": ms, "ref_ms": ref_ms}


def loss_card_vs_cpu(small, R):
    """``small`` in float32 on the card and on the CPU from the same
    weights (seed 3), one batch of 2 x 256 from ``MarkovLM`` (and for the
    enc-dec 2 sources of seeded normal frames): the loss within 1e-4 and
    every grad within 1e-3 of its tensor's largest |grad|.  Returns (the
    record, the CPU model)."""
    from repro_torch.data import MarkovLM
    cpu = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                        trainable=True).cuda()
    raw = MarkovLM(small.vocab_size, seed=2).sample(0, 2, 256)
    if small.arch_type in ("encdec", "audio"):
        raw["src_emb"] = np.random.default_rng(2).standard_normal(
            (2, small.frontend_tokens, small.frontend_dim),
            dtype=np.float32)
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        batch = {k: torch.from_numpy(v if v.dtype == np.float32
                                     else v.astype(np.int64)).to(dev)
                 for k, v in raw.items()}
        loss, m = R.loss_fn(model, small, batch, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        res[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    {k: float(v.detach()) for k, v in m.items()})
    loss_diff = abs(res["cpu"][0] - res["cuda"][0])
    if loss_diff > 1e-4:
        raise AssertionError(f"{small.name}: loss differs by "
                             f"{loss_diff:.3g}")
    grad_rel = 0.0
    for (name, _), a, b in zip(cpu.named_parameters(), res["cpu"][1],
                               res["cuda"][1]):
        rel = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        if rel > 1e-3:
            raise AssertionError(f"{small.name}: grad of {name}: "
                                 f"{rel:.3g} of its max")
        grad_rel = max(grad_rel, rel)
    return {"loss_cpu": res["cpu"][0], "loss_cuda": res["cuda"][0],
            "loss_abs_diff": loss_diff, "grad_max_rel_diff": grad_rel,
            "metrics_cuda": res["cuda"][2]}, cpu


def phase14b(cfg, R, RN, FA, smi):
    """granite-moe-1b-a400m at full width and depth (24 layers, d 1024,
    GQA 16/8, 32 experts, top-8, d_expert 512, vocab 49,155; 1.33B
    parameters), seeded weights, bf16 compute with float32 weights and
    AdamW, remat: Seesaw α = 2 at B = 8 -> 16 of 1024, 10·8·1024 tokens,
    ``MarkovLM(2048, 0)``: 7 steps at B = 8, 2 at B = 16 (micro 2).
    Gates: each step's LR, batch and phase the plan's; the losses finite
    and falling, the MoE metrics recorded every step; launches exactly
    remat's per micro-batch; one graph per (batch size, micro); then a
    step at B = 8 and one at B = 16, each replayed and run eagerly on a
    clone of the state, bit for bit.  Then the reduced granite in f32 on
    the card against the CPU (phase 5's gates, and three engine steps
    each), and one layer's MoE against the one-hot formulation."""
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    from repro_torch.data import MarkovLM
    from repro_torch.models import moe as M
    run = RunConfig(model=cfg,
                    schedule=ScheduleConfig(kind="seesaw", alpha=2.0,
                                            n_cuts=1),
                    optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                              beta2=0.95, grad_clip=1.0),
                    seq_len=1024, global_batch_size=8,
                    total_tokens=10 * 8 * 1024, dtype="bfloat16")
    tr, out = run_ramp(run, counters(RN, FA), fuse_steps=4,
                       max_device_batch=8, want=([8, 16], [7, 2], [1, 2]))
    hist = tr.history
    if not out["loss_last"] < out["loss_first"]:
        raise AssertionError(f"the loss did not fall: {out['losses']}")
    for h in hist:
        if not all(np.isfinite(h.get(k, np.nan))
                   for k in ("lb_loss", "rz_loss", "frac_dropped")):
            raise AssertionError(f"step {h['step']}: MoE metrics {h}")
    out["moe_metrics"] = {k: [h[k] for h in hist]
                          for k in ("lb_loss", "rz_loss", "frac_dropped")}
    check_launches(out, per_micro_batch(cfg, run.remat))
    out["params"] = cfg.param_count()
    out["active_params"] = cfg.active_param_count()
    out["card"] = smi
    out["profile"] = profile_train(
        tr, out["per_batch_size"]["8"]["wall_s_per_step"], 8,
        "profile_granite_train.txt")
    # replays against eager steps, bit for bit, at micro 1 and 2
    eng, st = tr.engine, tr.state
    src = MarkovLM(2048, seed=9)
    tok, start = st.tokens_seen, 0
    for b in (8, 16):
        chunk = {k: torch.from_numpy(v.astype(np.int64))[None].cuda()
                 for k, v in src.sample(start, b, 1024).items()}
        twin = clone_state(st.model, st.opt_state)
        _, _, m = eng.run_chunk(st.model, st.opt_state, tok, chunk,
                                step=st.step)
        _, _, want = eng.step_for(b).grad(
            *twin, {k: v[0] for k, v in chunk.items()}, m["lr"][0].cuda())
        torch.cuda.synchronize()
        if not same_state((st.model, st.opt_state), twin) or not all(
                torch.equal(m[k][0], v) for k, v in want.items()):
            raise AssertionError(f"B={b}: the replay differs from the "
                                 f"eager step")
        del twin
        st.step, tok, start = st.step + 1, tok + b * 1024, start + b
    out["graphs_bitwise"] = {"micro1_steps": 1, "micro2_steps": 1,
                             "captures": eng.captures}
    del tr, eng, st
    torch.cuda.empty_cache()

    small = cfg.reduced()
    rec, cpu = loss_card_vs_cpu(small, R)
    out["card_vs_cpu"] = {
        **rec,
        **replayed_card_vs_cpu(small, cpu, {
            k: v.reshape(3, 2, 256) for k, v in
            MarkovLM(small.vocab_size, seed=2).sample(2, 6, 256).items()})}
    out["moe_vs_ref"] = moe_vs_ref(cfg, M)
    log(f"phase 14b: card vs cpu {out['card_vs_cpu']}, moe vs ref "
        f"{out['moe_vs_ref']}")
    return out


def engine_decode_step(eng, serving, reqs, cfg, smi,
                       profile_name="profile_granite_decode.txt"):
    """One replayed decode step of the engine with every slot live (8
    requests of the mix admitted and prefilled, then one step): the mean
    of 10 replays queued back to back between CUDA events (median of 3
    runs), one replay on a drained queue (median of 10), and two more
    under torch.profiler, beside the step's bytes bound: every weight
    read once (of the tied embedding only the head's reads count once;
    of an untied one only the rows the slots look up) and each slot's K
    and V up to its length, every layer."""
    for prompt, _ in reqs[:eng.decode_slots]:
        eng.submit(serving.GenerationRequest(prompt=prompt,
                                             max_new_tokens=24))
    eng.step()
    if eng.n_pending or eng.n_active != eng.decode_slots:
        raise AssertionError("the timed step's slots are not all live")
    ent = eng._decode_fns[eng.decode_slots]
    lengths = [s.length for s in eng.slots]
    model = eng.model
    es = model.tok.element_size()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if model.lm_head is not None:
        weights -= model.tok.numel() * es - len(lengths) * cfg.d_model * es
    cache = sum(lengths) * cfg.n_layers * 2 * cfg.kv_dim * es
    replay = ent.graph.replay
    one_ms = event_ms(replay, 10)
    step_ms = event_ms(lambda: [replay() for _ in range(10)], 3) / 10
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
        t = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    prof_rec = second_step_kernels(prof, wall_us, profile_name)
    prof_rec["device_busy_share_of_step_ms"] = \
        prof_rec["device_busy_us"] / (step_ms * 1e3)
    eng.drain()
    eng.reset()
    return {"step_ms": step_ms, "one_replay_ms": one_ms,
            **bound(weights + cache, 0, eng.dtype),
            "weight_bytes": weights, "cache_bytes": cache,
            "lengths": lengths, "profile": prof_rec, "card": smi}


def phase14c(cfg, R, serving, Server, kernel_modules, smi):
    """granite-moe-1b-a400m served from the paged engine at full width
    and depth: phase 2's cell (bf16, 8 slots, page 16, max_len 1024, 16
    requests, prompts 64-768, 32-128 new) through the graphs, its tokens
    equal to an all-eager engine's; a replayed decode step against its
    bytes bound; then float32, the engine against each request alone
    through a Server (phase 12a's oracle)."""
    torch.cuda.reset_peak_memory_stats()
    eng, rec = phase2(cfg, R, serving, kernel_modules)
    eng.reset()
    rec["decode_step"] = engine_decode_step(eng, serving, requests(cfg), cfg,
                                            smi)
    rec["pool_bytes"] = eng.pool.kv.numel() * eng.pool.kv.element_size()
    del eng
    torch.cuda.empty_cache()
    rec["oracle"] = engine_vs_solo_server(cfg, R, serving, Server)
    torch.cuda.empty_cache()
    return rec


def phase14d(PG, smi):
    """The reference's serving, engine and checkpoint benchmarks on the
    card, in process, at the sizes of ``bench.run``'s suites: the
    ``engine`` suite's rows (with the adaptive record) and its
    ``check_compiles``; the ``serve`` suite's rows (16 requests) and its
    ``check_compiles``, the ragged decode's launches at hd 32 counted
    over it; the checkpoint suite's rows, ``check_stall`` and
    ``check_schema``.  Every row printed; a suite that raises or a check
    that returns an error fails the phase.  Then ``examples.
    serve_decode --arch granite-moe-1b-a400m`` (reduced, bf16)."""
    from repro_torch.bench import checkpoint as BC
    from repro_torch.bench import engine as BE
    from repro_torch.bench import run as bench_run
    from repro_torch.bench import serve as BS
    from repro_torch.examples import serve_decode
    if list(bench_run.SUITES)[-2:] != ["engine", "serve"]:
        raise AssertionError(f"bench.run suites {list(bench_run.SUITES)}")
    out, errors = {}, []
    t = time.perf_counter()
    rows, res = BE._measure(144, schedule="adaptive-seesaw", device="cuda")
    errors += [f"engine: {e}" for e in BE.check_compiles(res)]
    out["engine"] = {"rows": [bench_run.csv_row(*r) for r in rows],
                     "result": res, "s": time.perf_counter() - t}
    t = time.perf_counter()
    PG.launches = 0
    rows, res = BS._measure(n_requests=16, device="cuda")
    launches = PG.launches
    errors += [f"serve: {e}" for e in BS.check_compiles(res)]
    out["serve"] = {"rows": [bench_run.csv_row(*r) for r in rows],
                    "result": res, "ragged_decode_hd32_launches": launches,
                    "s": time.perf_counter() - t}
    if launches <= 0:
        errors.append("serve: the ragged decode never launched at hd 32")
    t = time.perf_counter()
    rows, res = BC._measure(5, device="cuda")
    errors += [f"checkpoint: {e}" for e in BC.check_stall(res)]
    errors += [f"checkpoint schema: {e}" for e in BC.check_schema("cuda")]
    out["checkpoint"] = {"rows": [bench_run.csv_row(*r) for r in rows],
                         "result": res, "s": time.perf_counter() - t}
    for suite in ("engine", "serve", "checkpoint"):
        for r in out[suite]["rows"]:
            log(f"phase 14d: {r}")
    if errors:
        raise AssertionError(f"phase 14d: {errors}")
    t = time.perf_counter()
    eng = serve_decode.main(["--arch", MOE_ARCH])
    res = eng._results.values()
    if not eng.done or len(res) != 4 or any(
            r.tokens.min() < 0 or r.tokens.max() >= eng.cfg.padded_vocab
            for r in res):
        raise AssertionError("serve_decode: requests unfinished or tokens "
                             "out of the vocab")
    out["serve_decode"] = {"arch": eng.cfg.name, "requests": len(res),
                           "tokens": int(sum(len(r.tokens) for r in res)),
                           "executables": eng.executables,
                           "captures": eng.captures,
                           "s": time.perf_counter() - t}
    out["card"] = smi
    return out


# --------------------------------------------------------------------- #
# phase 15: the RG-LRU hybrid (recurrentgemma-9b)
# --------------------------------------------------------------------- #

HYBRID_ARCH = "recurrentgemma-9b"
# (B, S, W, tag): the scan at 15b's micro-batch (4 x 1024) and at 15c's
# prefill (2 prompts of 2,500), recurrentgemma's LRU width
SCAN_SHAPES = ((4, 1024, 4096, "train"), (2, 2500, 4096, "prefill"))
# 15b: Seesaw alpha = 2, one cut, B0 = 4 of 1024: 6 steps at B = 4 and 2
# at B = 8 (micro 2)
HYBRID_TOKENS = 9 * 4 * 1024


def scan_case(B, S, W, g):
    """Inputs as the RG-LRU makes them: a = exp(-8 softplus(lam) r) with
    lam at the init's (softplus 0.1-0.5 across the width) and r a sigmoid,
    so a lies in (0.018, 1); b, h0, dhs and dh_last normal."""
    lam = torch.log(torch.expm1(torch.linspace(0.1, 0.5, W,
                                               device="cuda")))
    r = torch.sigmoid(torch.randn(B, S, W, generator=g, device="cuda"))
    a = torch.exp(-8.0 * F.softplus(lam) * r)
    b, dhs = (torch.randn(B, S, W, generator=g, device="cuda")
              for _ in range(2))
    h0, dhl = (torch.randn(B, W, generator=g, device="cuda")
               for _ in range(2))
    return a, b, h0, dhs, dhl


def scan_err(got, want, rel=2e-5) -> float:
    """max |got - want|, which must stay within ``rel`` of max |want| (the
    scan's gate: 2e-5 of the output's largest magnitude)."""
    err = float((got - want).abs().max())
    if err > rel * float(want.abs().max()):
        raise AssertionError(f"error {err:.3g} > {rel} x the output's max "
                             f"{float(want.abs().max()):.3g}")
    return err


def phase15a(RG, PG, RN, ref):
    """The RG-LRU scan forward and backward at ``SCAN_SHAPES`` against
    their plain versions (the reference's chunked scan and its written-out
    reverse sweep), float32, within 2e-5 of each output's max; the ragged
    decode at head_dim 256 on recurrentgemma's ring (B=2, Skv=2048, H=16,
    Hkv=1), gathered and paged (pages of 16), f32 (2e-5) and bf16 (2e-2);
    RMSNorm forward and backward at d 4096 (15b's 4,096 rows and a decode
    step's 2), f32 and bf16.  Each timed as phase 1 does, beside its
    bound, its plain version and a library call where one computes the
    same function (none for the scan)."""
    g = torch.Generator(device="cuda").manual_seed(15)
    rng = np.random.default_rng(15)
    errors, times, inputs = [], {}, {}
    timer, bf, f32 = Timer(iters=20), torch.bfloat16, torch.float32
    for B, S, W, tag in SCAN_SHAPES:
        a, b, h0, dhs, dhl = scan_case(B, S, W, g)
        h = h0 if tag == "prefill" else None
        hs, hl = RG.rglru_scan_fwd(a, b, h)
        torch.cuda.synchronize()
        whs, whl = ref.rglru_scan_ref(a, b, h)
        errors.append(("rglru_scan_fwd", tag, "float32",
                       max(scan_err(hs, whs), scan_err(hl, whl))))
        da, db, dh0 = RG.rglru_scan_bwd(a, hs, h, dhs, dhl, h is not None)
        torch.cuda.synchronize()
        want = ref.rglru_scan_bwd_ref(a, whs, h, dhs, dhl)
        errors.append(("rglru_scan_bwd", tag, "float32", max(
            scan_err(x, y) for x, y in zip((da, db, dh0), want)
            if x is not None)))
        del whs, whl, want, da, db, dh0
        n = B * S * W
        times[f"rglru_scan_fwd/{tag}"] = dict(
            ms=timer(lambda: RG.rglru_scan_fwd(a, b, h)),
            plain_ms=timer(lambda: ref.rglru_scan_ref(a, b, h)),
            library_ms=None,
            shape=f"a, b ({B}, {S}, {W}) f32"
                  f"{', h0' if h is not None else ''}",
            **bound(12 * n + 4 * B * W * (2 if h is not None else 1),
                    2 * n, f32))
        times[f"rglru_scan_bwd/{tag}"] = dict(
            ms=timer(lambda: RG.rglru_scan_bwd(a, hs, h, dhs, dhl,
                                               h is not None)),
            plain_ms=timer(lambda: ref.rglru_scan_bwd_ref(a, hs, h, dhs,
                                                          dhl)),
            library_ms=None,
            shape=f"a, hs, dhs ({B}, {S}, {W}) f32 -> da, db",
            **bound(20 * n + 4 * B * W * (3 if h is not None else 1),
                    3 * n, f32))
        del a, b, h0, dhs, dhl, hs, hl
        torch.cuda.empty_cache()
    note = "none: no single PyTorch call computes a linear recurrence"
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        t, err = decode_case(PG, ref, 2, 2048, 16, 1, 256, dtype, g, rng)
        errors.append(("ragged_decode", "hd256-ring", dn, err))
        inputs[("decode", dn)] = t
        err = paged_case(PG, ref, 8, 2048, 16, 1, 256, 16, dtype, g, rng)
        errors.append(("paged_decode", "hd256-ps16", dn, err))
        for rows, tag in ((4096, "train"), (2, "decode")):
            x, s, err = rmsnorm_case(RN, ref, rows, 4096, dtype, g)
            errors.append(("rmsnorm_fwd", f"d4096-{tag}", dn, err))
            inputs[("rmsnorm", tag, dn)] = (x, s)
        x, s = inputs[("rmsnorm", "train", dn)]
        gy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        dx, ds = RN.rmsnorm_bwd(x, s, gy, 1e-5)
        torch.cuda.synchronize()
        want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, gy, 1e-5)
        errors.append(("rmsnorm_bwd", "d4096-train", dn,
                       max_err(dx, want_dx, dtype)))
        errors.append(("rmsnorm_bwd/dscale_rel", "d4096-train", dn,
                       dscale_rel_err(x, gy, ds, want_ds)))
        inputs[("rmsnorm_bwd", dn)] = gy
    for name, tag, dn, err in errors:
        log(f"phase 15a: {name} {tag} {dn}: max err {err:.3g}")

    # the decode on a full ring (every slot valid: lengths W - 1), bf16
    q, k, v, _, _, _ = inputs[("decode", "bfloat16")]
    B, H, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    es = q.element_size()
    ln = torch.full((B,), W - 1, dtype=torch.int32, device="cuda")
    full = PG.ragged_decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    ring_err = max_err(full, ref.ragged_decode_ref(q, k, v, ln), bf)
    mask = (torch.arange(W, device="cuda")[None, :]
            <= ln.long()[:, None])[:, None, None, :]
    nk = float(B * W)
    times["ragged_decode/hd256"] = dict(
        ms=timer(lambda: PG.ragged_decode_attention(q, k, v, ln)),
        plain_ms=timer(lambda: ref.ragged_decode_ref(q, k, v, ln)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)),
        max_abs_err=ring_err,
        shape=f"q (B={B}, H={H}, hd={hd}), ring Skv={W}, Hkv={Hkv}, every "
              f"length {W - 1} bf16",
        **bound(2 * q.numel() * es + 2 * nk * Hkv * hd * es + 4 * B,
                4 * nk * H * hd, bf))
    for rows, tag in ((4096, "train"), (2, "decode")):
        x, s = inputs[("rmsnorm", tag, "bfloat16")]
        d = x.shape[-1]
        w = (1.0 + s).to(bf)
        times[f"rmsnorm_fwd/d4096-{tag}"] = dict(
            ms=timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            graph_us=GraphTimer()(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
            library_ms=timer(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            library_graph_us=GraphTimer()(lambda: F.rms_norm(x, (d,), w,
                                                             1e-5)),
            shape=f"x ({rows}, {d}) bf16",
            **bound(2 * x.numel() * es + 4 * d, 4 * x.numel(), bf))
    x, s = inputs[("rmsnorm", "train", "bfloat16")]
    gy = inputs[("rmsnorm_bwd", "bfloat16")]
    n, d = x.shape
    xr = x.detach().clone().requires_grad_()
    w = (1.0 + s).to(bf).requires_grad_()
    y = F.rms_norm(xr, (d,), w, 1e-5)
    times["rmsnorm_bwd/d4096-train"] = dict(
        ms=timer(lambda: RN.rmsnorm_bwd(x, s, gy, 1e-5)),
        plain_ms=timer(lambda: ref.rmsnorm_bwd_ref(x, s, gy, 1e-5)),
        library_ms=timer(lambda: torch.autograd.grad(
            y, (xr, w), gy, retain_graph=True)),
        shape=f"x, g ({n}, {d}) bf16; dx and dscale from one launch",
        **bound(3 * n * d * es + 8 * d, 12 * n * d, bf))
    for k_ in [k_ for k_ in times if k_.startswith("rglru")]:
        times[k_]["library_note"] = note
    log(f"phase 15a: {times}")
    return errors, times


def hybrid_step_bytes(model, cfg, batch: int, positions: int) -> int:
    """Bytes a hybrid decode step must move at least: every weight once
    (of the untied embedding only the ``batch`` rows looked up), each
    ring's K and V over ``positions`` slots a row, each recurrent
    layer's conv rows and float32 state read and written."""
    from repro_torch.models import rglru as HY
    w = cfg.hybrid.lru_width or cfg.d_model
    es = model.tok.element_size()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    weights -= model.tok.numel() * es - batch * cfg.d_model * es
    n_rec = sum(k == "recurrent" for k in HY.kinds(cfg))
    rings = (cfg.n_layers - n_rec) * batch * positions * 2 * cfg.kv_dim * es
    states = n_rec * 2 * batch * w * ((cfg.hybrid.conv1d_width - 1) * es
                                      + 4)
    return weights + rings + states


def hybrid_counters(RN, FA, PG, SSD, OV, RG):
    """Every kernel's launch counter, the scan pair's among them."""
    return dict(serve_counters(RN, FA, PG, SSD, OV),
                rglru_scan_fwd=(RG, "launches"),
                rglru_scan_bwd=(RG, "bwd_launches"))


def hybrid_run(cfg):
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    return RunConfig(model=cfg,
                     schedule=ScheduleConfig(kind="seesaw", alpha=2.0,
                                             n_cuts=1),
                     optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                               beta2=0.95, grad_clip=1.0),
                     seq_len=1024, global_batch_size=4,
                     total_tokens=HYBRID_TOKENS, dtype="bfloat16")


def hybrid_launches(cfg, remat: bool) -> dict:
    """Every kernel's launches a micro-batch of the hybrid: RMSNorm 4L+1
    forward (2L+1 without remat) and 2L+1 backward, the scan once per
    recurrent layer (twice under remat) and its backward once; the
    windowed attention layers launch no kernel (``chunked_attention``)."""
    from repro_torch.models import rglru as HY
    L, r = cfg.n_layers, 2 if remat else 1
    n_rec = sum(k == "recurrent" for k in HY.kinds(cfg))
    return {"rmsnorm_fwd": 2 * L * r + 1, "rmsnorm_bwd": 2 * L + 1,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "ragged_decode": 0, "ssd_chunk": 0, "overlap_norm": 0,
            "rglru_scan_fwd": n_rec * r, "rglru_scan_bwd": n_rec}


def sequential_scan(a, b, h0=None):
    """h_t = a_t·h_{t−1} + b_t one step after another, the scan kernel's
    order of sums (forward, and the reverse sweep under autograd)."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def hybrid_update_split(small, R, ref):
    """Where the card's three-step update of the reduced hybrid parts from
    the CPU's, in float32: on the card with the scan kernel and with
    ``rglru_scan_ref`` in its place (the same GEMMs, the reference's
    chunked order), on the CPU with ``rglru_scan_ref`` and with a
    sequential loop (the kernel's order), from the same weights on the
    same three batches.  Per tensor, relative to its largest |change|:
    the card's kernel run must lie within twice the CPU's order spread
    (sequential against chunked) or 1e-4 of the card's plain run, and
    the card's plain run within phase 5's 1e-3 of the CPU's.  A change
    is read as the difference of two float32 weights, so it is resolved
    to one spacing of the weight: both gates have a floor of two float32
    spacings of the tensor's largest |weight| (a w_r update of ~3e-6
    spans ~800 spacings of its weights, so one flipped last bit is
    ~1.2e-3 of it; on the CPU the two orders of the scan alone flip
    it)."""
    from repro_torch.data import MarkovLM
    cpu = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                       trainable=True)
    raw = {k: v.reshape(3, 2, 256) for k, v in
           MarkovLM(small.vocab_size, seed=2).sample(2, 6, 256).items()}
    runs = {(dev, name): sgd_updates(small, cpu, dev, scan, raw)
            for dev, name, scan in (
                ("cuda", "kernel", None),
                ("cuda", "plain", ref.rglru_scan_ref),
                ("cpu", "plain", ref.rglru_scan_ref),
                ("cpu", "sequential", sequential_scan))}

    def diff(x, y):
        return [float((a - b).abs().max())
                for a, b in zip(runs[x][1], runs[y][1])]

    scale = [float(u.abs().max().clamp(min=1e-30))
             for u in runs[("cpu", "plain")][1]]
    # two float32 spacings of each tensor's largest |weight| after the run
    floor = []
    for p, u in zip(cpu.parameters(), runs[("cpu", "plain")][1]):
        w = (p.detach() + u).abs().max()
        floor.append(2 * float(torch.nextafter(w, w + 1) - w))
    spread = diff(("cpu", "sequential"), ("cpu", "plain"))
    kernel = diff(("cuda", "kernel"), ("cuda", "plain"))
    plain = diff(("cuda", "plain"), ("cpu", "plain"))
    worst = {}
    for (n, _), sc, fl, s_, k_, p_ in zip(cpu.named_parameters(), scale,
                                          floor, spread, kernel, plain):
        if k_ > max(2 * s_, 1e-4 * sc, fl):
            raise AssertionError(f"hybrid update of {n}: the scan kernel "
                                 f"{k_ / sc:.3g} of its max from the plain "
                                 f"scan on the card, the CPU's order "
                                 f"spread {s_ / sc:.3g}, floor "
                                 f"{fl / sc:.3g}")
        if p_ > max(1e-3 * sc, fl):
            raise AssertionError(f"hybrid update of {n}: the card's plain "
                                 f"run {p_ / sc:.3g} of its max from the "
                                 f"CPU's, floor {fl / sc:.3g}")
        worst[n] = {"order_spread_cpu": s_ / sc,
                    "kernel_vs_plain_card": k_ / sc,
                    "plain_card_vs_cpu": p_ / sc,
                    "floor_two_spacings": fl / sc,
                    "plain_card_vs_cpu_in_spacings": 2 * p_ / fl}
    keys = ("order_spread_cpu", "kernel_vs_plain_card", "plain_card_vs_cpu",
            "plain_card_vs_cpu_in_spacings")
    return {"losses": {f"{d}/{n}": v[0] for (d, n), v in runs.items()},
            "max": {k: max(w[k] for w in worst.values()) for k in keys},
            "top_tensors": {n: worst[n] for n in sorted(
                worst, key=lambda n: -worst[n]["plain_card_vs_cpu"])[:4]}}


def phase15b(cfg, R, ctr, smi):
    """recurrentgemma-9b at full width, cut to 5 layers (one (recurrent,
    recurrent, attention) group and a remainder of two, 2,971,807,744
    parameters, 47.5 GB of float32 weights, grads and AdamW state): bf16
    compute, remat, Seesaw alpha = 2 with one cut, 6 steps at B = 4 and 2
    at B = 8 (micro 2) of 1024, ``MarkovLM(2048, 0)``.  Gates: each step's
    LR, batch and phase the plan's, losses finite and falling, every
    kernel's launches exactly remat's per micro-batch, one graph per
    (batch size, micro).  Then, at the same layer widths with the
    vocabulary cut to the data's 2048 (a clone of the 47.5 GB state does
    not fit beside it), a replayed step at B = 4 and one at B = 8, each
    against the eager step on a clone of the state, bit for bit; and the
    reduced hybrid in float32 on the card against the CPU: the loss
    within 1e-4 and every grad within 1e-3 of its tensor's max.  (Phase
    5's three SGD steps at LR 0.1 are not gated here: the three-step
    update of ``w_r``, a sum of small gradients, lands past that gate's
    1e-3 of its max from the CPU's while one step's grads agree far
    inside theirs.)  That gap is split instead
    (``hybrid_update_split``): the card's kernel run against the card's
    run with the plain scan, gated at twice the CPU's spread between the
    scan's two orders of sums, and the card's plain run against the
    CPU's at phase 5's 1e-3, both floored at two float32 spacings of
    the weights.  The gap is no fault of the kernel or of the layers
    around it: it is the last bit of w_r's float32 weights, which the
    CPU's two orders of the scan flip too."""
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import ref
    five = dataclasses.replace(cfg, n_layers=5)
    run = hybrid_run(five)
    tr, out = run_ramp(run, ctr, fuse_steps=4, max_device_batch=4,
                       want=([4, 8], [6, 2], [1, 2]))
    if not out["loss_last"] < out["loss_first"]:
        raise AssertionError(f"the loss did not fall: {out['losses']}")
    check_launches(out, hybrid_launches(five, run.remat))
    # the config's param_count is the reference's formula, which leaves
    # out each recurrent layer's w_r and w_i (W x W)
    out["params"] = sum(p.numel() for p in tr.state.model.parameters())
    out["config_param_count"] = five.param_count()
    out["state_gb"] = 16 * out["params"] / 1e9
    out["card"] = smi
    out["profile"] = profile_train(
        tr, out["per_batch_size"]["4"]["wall_s_per_step"], 4,
        "profile_hybrid_train.txt")
    # the trainer's graphs hold its pool until the cycles through the
    # engine are collected
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(five, vocab_size=2048)
    tr, cut_out = run_ramp(hybrid_run(cut), ctr, fuse_steps=4,
                           max_device_batch=4,
                           want=([4, 8], [6, 2], [1, 2]))
    eng, st = tr.engine, tr.state
    src = MarkovLM(2048, seed=9)
    tok, start = st.tokens_seen, 0
    for b in (4, 8):
        chunk = {k: torch.from_numpy(v.astype(np.int64))[None].cuda()
                 for k, v in src.sample(start, b, 1024).items()}
        twin = clone_state(st.model, st.opt_state)
        _, _, m = eng.run_chunk(st.model, st.opt_state, tok, chunk,
                                step=st.step)
        _, _, want = eng.step_for(b).grad(
            *twin, {k: v[0] for k, v in chunk.items()}, m["lr"][0].cuda())
        torch.cuda.synchronize()
        if not same_state((st.model, st.opt_state), twin) or not all(
                torch.equal(m[k][0], v) for k, v in want.items()):
            raise AssertionError(f"B={b}: the replay differs from the "
                                 f"eager step")
        del twin
        st.step, tok, start = st.step + 1, tok + b * 1024, start + b
    out["graphs_bitwise"] = {
        "model": "recurrentgemma-9b widths, 5 layers, vocab 2048",
        "params": sum(p.numel() for p in st.model.parameters()),
        "micro1_steps": 1, "micro2_steps": 1,
        "captures": eng.captures,
        "tok_per_s": {b: r["tok_per_s"]
                      for b, r in cut_out["per_batch_size"].items()},
        "launches": cut_out["launches"]}
    del tr, eng, st
    gc.collect()
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg.reduced(), n_layers=5)
    out["card_vs_cpu"], _ = loss_card_vs_cpu(small, R)
    out["update_split"] = hybrid_update_split(small, R, ref)
    log(f"phase 15b: card vs cpu {out['card_vs_cpu']}, three-step update "
        f"{out['update_split']}")
    return out


def phase15c(cfg, R, Server, ctr, smi):
    """recurrentgemma-9b at full width and depth (38 layers: 26 recurrent,
    12 attention; 8.53B parameters, 17.1 GB in bf16) through the
    ``Server``, ``max_len`` 4096: a ring of 2048 slots in each attention
    layer.  A warm-up runs the entry's first decode step eagerly and
    captures its graph.  Then 2 prompts of 2,500 with 64 new (the ring
    built from S >= W, and wrapped), and batches of 2 prompts of 1 and of
    2 tokens (16 new), through the one graph: launches exactly the scan
    26 a prefill and never in a decode step, its backward never, the
    ragged decode 12 a decode step, the RMSNorm forward 77 a prefill and
    a decode step, flash 0; tokens equal to an all-eager Server's.
    Reports tok/s, the prefill's ms split into the windowed attention
    (12 x one layer's ``chunked_attention`` at S = 2,500), the scan (26 x
    one launch at (2, 2,500, 4,096)) and the rest, a replayed decode
    step beside its bytes bound and under torch.profiler, and the peak.
    Then the reduced hybrid (5 layers) in float32 on the card and on the
    CPU through the Server: first-token logits within 1e-3, tokens equal,
    prompts of 90 (past its window of 64), 1 and 2."""
    from repro_torch.kernels import rglru as RG
    from repro_torch.models import rglru as HY
    from repro_torch.models.attention import chunked_attention
    bf = torch.bfloat16
    L = cfg.n_layers
    n_rec = sum(k == "recurrent" for k in HY.kinds(cfg))
    n_att = L - n_rec
    torch.cuda.reset_peak_memory_stats()
    model = R.init_model(cfg, seed=0, dtype=bf, device="cuda")
    srv = Server(cfg, model, max_len=4096, dtype=bf)
    eager = eager_server(Server, cfg, model, max_len=4096, dtype=bf)
    rng = np.random.default_rng(15)
    quiet_generate(srv, rng.integers(0, cfg.vocab_size, (2, 64)), 3)
    if srv.captures != 1:
        raise AssertionError(f"warm-up captured {srv.captures} graphs")
    batches = {}
    for tag, S, n_new in (("long", 2500, 64), ("one", 1, 16),
                          ("two", 2, 16)):
        toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        for m, a in ctr.values():
            setattr(m, a, 0)
        out, wall = quiet_generate(srv, toks, n_new)
        launches = {n: getattr(m, a) for n, (m, a) in ctr.items()}
        want = dict({n: 0 for n in ctr}, rmsnorm_fwd=(2 * L + 1) * n_new,
                    rglru_scan_fwd=n_rec, ragged_decode=n_att * (n_new - 1))
        if launches != want or srv.captures != 1:
            raise AssertionError(f"batch {tag}: launches {launches}, want "
                                 f"{want}; {srv.captures} captures")
        ref_out, eager_wall = quiet_generate(eager, toks, n_new)
        if not np.array_equal(out, ref_out):
            raise AssertionError(f"batch {tag}: replayed tokens differ "
                                 f"from the eager ones")
        if out.min() < 0 or out.max() >= cfg.padded_vocab:
            raise AssertionError(f"batch {tag}: token out of the vocab")
        batches[tag] = {"batch": 2, "prompt": S, "new": n_new,
                        "wall_s": wall, "tok_per_s": 2 * n_new / wall,
                        "eager_wall_s": eager_wall,
                        "eager_tok_per_s": 2 * n_new / eager_wall,
                        "tokens_equal_eager": True, "launches": launches}
    long = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, 2500))).cuda()
    prefill_ms = event_ms(lambda: srv.prefill(long), 3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_bytes = hybrid_step_bytes(model, cfg, 2, 2048)
    step = server_step(srv, cfg, 2048, smi, "profile_hybrid_decode.txt",
                       n_bytes=n_bytes)
    del srv, eager
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(16)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn(2, 2500, H, hd, generator=g, device="cuda").to(bf)
    k = torch.randn(2, 2500, Hkv, hd, generator=g, device="cuda").to(bf)
    v = torch.randn(2, 2500, Hkv, hd, generator=g, device="cuda").to(bf)
    a, b, _, _, _ = scan_case(2, 2500, 4096, g)
    with torch.inference_mode():
        attn_ms = event_ms(lambda: chunked_attention(
            q, k, v, window=cfg.hybrid.local_window), 3)
        scan_ms = event_ms(lambda: RG.rglru_scan_fwd(a, b), 5)
    del q, k, v, a, b
    split = {"prefill_ms": prefill_ms,
             "windowed_attention_ms": n_att * attn_ms,
             "scan_ms": n_rec * scan_ms,
             "rest_ms": prefill_ms - n_att * attn_ms - n_rec * scan_ms,
             "one_layer_attention_ms": attn_ms, "one_scan_ms": scan_ms}
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg.reduced(), n_layers=5)
    diff, toks = server_card_vs_cpu(
        small, R, Server, [(rng.integers(0, small.vocab_size, (2, S)), n)
                           for S, n in ((90, 20), (1, 8), (2, 8))], seed=5)
    return {"model": cfg.name, "params": n_params,
            "config_param_count": cfg.param_count(),
            "weight_gb": weight_gb, "max_len": 4096,
            "ring_slots": min(cfg.hybrid.local_window, 4096),
            "recurrent_layers": n_rec, "attention_layers": n_att,
            "batches": batches, "captures": 1, "peak_mem_gb": peak,
            "prefill": split, "decode_step": step,
            "card_vs_cpu": {"first_token_logit_max_abs_diff": diff,
                            "tokens": toks},
            "card": smi}


def hybrid_kernel_entries(kernels, record):
    """Phase 15's part of the ``kernels`` line: the RG-LRU scan pair and
    the ragged decode at hd 256 as entries of their own; RMSNorm at d
    4096, and every kernel's launches in the hybrid's runs, on the
    entries of earlier phases."""
    hyb = record["hybrid"]
    h_errors, h_times = hyb["kernels"]["errors"], hyb["kernels"]["times"]
    err15 = {(n, tag, dn): e for n, tag, dn, e in h_errors}
    for k in kernels:
        if k["name"] in ("rmsnorm_fwd", "rmsnorm_bwd"):
            k["hybrid_train_launches"] = hyb["train"]["launches"][k["name"]]
            k["d4096"] = {
                tag: {**tm,
                      "max_abs_err": err15[(k["name"], f"d4096-{tag}",
                                            "bfloat16")],
                      "max_abs_err_f32": err15[(k["name"], f"d4096-{tag}",
                                                "float32")]}
                for tag in ("train", "decode")
                for tm in [h_times.get(f"{k['name']}/d4096-{tag}")]
                if tm is not None}
        if k["name"] in ("rmsnorm_fwd", "ragged_decode"):
            k["hybrid_serve_launches"] = {
                t: b["launches"][k["name"]]
                for t, b in hyb["serve"]["batches"].items()}
    for name in ("rglru_scan_fwd", "rglru_scan_bwd"):
        tm, tp = h_times[f"{name}/train"], h_times[f"{name}/prefill"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/models/rglru.py:41",
            "replaces_note": "no Pallas kernel: the reference's chunked "
                             "lax.associative_scan in XLA (rglru_scan)",
            "launches": hyb["train"]["launches"][name],
            "max_abs_err": err15[(name, "train", "float32")],
            "max_abs_err_f32": err15[(name, "train", "float32")],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "library_note": tm["library_note"],
            "shape": tm["shape"],
            "prefill_shape": {**{f: tp[f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "shape")},
                "max_abs_err": err15[(name, "prefill", "float32")]},
            "serving_launches": {
                t: b["launches"][name]
                for t, b in hyb["serve"]["batches"].items()},
            "bitwise_run_launches": hyb["train"]["graphs_bitwise"][
                "launches"][name],
            "compiled": {c: v for c, v in record["compiled"].items()
                         if c.startswith(name)}})
    tm = h_times["ragged_decode/hd256"]
    kernels.append({
        "name": "ragged_decode/hd256", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged.py:32",
        "launches": sum(b["launches"]["ragged_decode"]
                        for b in hyb["serve"]["batches"].values()),
        "max_abs_err": err15[("ragged_decode", "hd256-ring", "bfloat16")],
        "max_abs_err_f32": err15[("ragged_decode", "hd256-ring",
                                  "float32")],
        "full_ring_max_abs_err": tm["max_abs_err"],
        "paged_max_abs_err": err15[("paged_decode", "hd256-ps16",
                                    "bfloat16")],
        "paged_max_abs_err_f32": err15[("paged_decode", "hd256-ps16",
                                        "float32")],
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"], "shape": tm["shape"],
        "compiled": {c: v for c, v in record["compiled"].items()
                     if c.startswith("paged_decode") and "hd 256" in c},
        "launches_by": "phase 15c: recurrentgemma-9b's 12 attention "
                       "layers through the Server's decode graph"})


# --------------------------------------------------------------------- #
# phase 16: the last families — the enc-dec, the VLM prefix, mistral-nemo
# --------------------------------------------------------------------- #

ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-medium", "internvl2-76b"
NEMO_ARCH, YI_ARCH = "mistral-nemo-12b", "yi-34b"
VLM_LAYERS = 16
# 16b's plan: 6 steps at B = 4 and 2 at B = 8 of 1,024 text tokens (as 15b)
ENCDEC_TOKENS = 9 * 4 * 1024
# (B, S, H, Hkv, tag), hd 128: internvl's GQA 64/8 at its prefill of a
# 1,024-patch prefix and 64 text tokens, yi-34b's 56/8 (a group of 7),
# and ragged lengths at the tiles' edges
FLASH_GQA = ((2, 1088, 64, 8, "internvl-prefill"), (1, 1024, 56, 8, "yi"),
             (1, 77, 56, 8, "yi-S77"), (1, 65, 64, 8, "internvl-S65"))
FLASH_GQA_TIMED = ("internvl-prefill", "yi")
# (B, Skv, H, Hkv, tag), hd 128: the decode kernel serves a kv head's
# group in blocks of 4 heads, so yi's group of 7 leaves a tail of 3
DECODE_GQA = ((2, 2048, 64, 8, "internvl"), (8, 2048, 56, 8, "yi"))


def phase16a(RN, FA, PG, ref):
    """The kernels at the new families' head shapes against their plain
    versions, float32 (2e-5) and bfloat16 (2e-2): the flash forward, dq
    and dk/dv at hd 128 with GQA groups of 8 and 7 (``FLASH_GQA``), the
    ragged decode's gathered and paged entries at the same groups
    (``DECODE_GQA``), the RMSNorm forward at d 8192 (internvl's) at 2
    and 2 x 1,088 rows.  Then each timed in bfloat16 beside its plain
    version, its bound and SDPA or ``F.rms_norm``; and the float32 dk/dv
    at starcoder2's prompt held to float64 (``starcoder2_dkv_f64``)."""
    g = torch.Generator(device="cuda").manual_seed(16)
    rng = np.random.default_rng(16)
    bf = torch.bfloat16
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for B, S, H, Hkv, tag in FLASH_GQA:
            q, k, v, do = (torch.randn(B, S, n, 128, generator=g,
                                       device="cuda").to(dtype)
                           for n in (H, Hkv, Hkv, H))
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            out, lse = FA.flash_fwd(qt, kt, vt)
            torch.cuda.synchronize()
            want, want_lse = ref.attention_ref(qt, kt, vt)
            errors.append(("flash_fwd", f"hd128-{tag}", dn,
                           max(max_err(out, want, dtype),
                               max_err(lse, want_lse, dtype))))
            del want, want_lse
            dq, dk, dv = FA.flash_bwd(qt, kt, vt, out, lse, dot)
            torch.cuda.synchronize()
            wq, wk, wv = ref.flash_bwd_ref(qt, kt, vt, out, lse, dot)
            errors.append(("flash_bwd_dq", f"hd128-{tag}", dn,
                           max_err(dq, wq, dtype)))
            errors.append(("flash_bwd_dkv", f"hd128-{tag}", dn,
                           max(max_err(dk, wk, dtype),
                               max_err(dv, wv, dtype))))
            del dq, dk, dv, wq, wk, wv
            if dtype is bf and tag in FLASH_GQA_TIMED:
                inputs[tag] = (qt, kt, vt, out, lse, dot)
        for B, Skv, H, Hkv, tag in DECODE_GQA:
            t, err = decode_case(PG, ref, B, Skv, H, Hkv, 128, dtype, g, rng)
            errors.append(("ragged_decode", f"hd128-{tag}", dn, err))
            if dtype is bf:
                inputs[("decode", tag)] = t
            errors.append(("paged_decode", f"hd128-{tag}-ps16", dn,
                           paged_case(PG, ref, 8, Skv, H, Hkv, 128, 16,
                                      dtype, g, rng)))
        for rows, tag in ((2, "decode"), (2 * 1088, "prefill")):
            x, s, err = rmsnorm_case(RN, ref, rows, 8192, dtype, g)
            errors.append(("rmsnorm_fwd", f"d8192-{tag}", dn, err))
            if dtype is bf:
                inputs[("rmsnorm", tag)] = (x, s)
        torch.cuda.empty_cache()
    for name, tag, dn, err in errors:
        log(f"phase 16a: {name} {tag} {dn}: max |err| {err:.3g}")
    timer = Timer(iters=30)
    times = {f"flash/{tag}": flash_rows(FA, ref, inputs[tag], timer)
             for tag in FLASH_GQA_TIMED}
    for tag in ("internvl", "yi"):
        q, k, v, lengths, lens, _ = inputs[("decode", tag)]
        B, H, hd = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        es = q.element_size()
        keys = float(np.sum(lens.astype(np.int64) + 1))
        mask = (torch.arange(Skv, device="cuda")[None, :]
                <= lengths.long()[:, None])[:, None, None, :]
        times[f"ragged_decode/{tag}"] = dict(
            ms=timer(lambda: PG.ragged_decode_attention(q, k, v, lengths)),
            plain_ms=timer(lambda: ref.ragged_decode_ref(q, k, v,
                                                         lengths)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)),
            shape=f"q (B={B}, H={H}, hd={hd}), Hkv={Hkv}, window "
                  f"Skv={Skv}, lengths {lens.tolist()} bf16",
            **bound(2 * q.numel() * es + 2 * keys * Hkv * hd * es + 4 * B,
                    4 * keys * H * hd, bf))
    for tag in ("decode", "prefill"):
        x, s = inputs[("rmsnorm", tag)]
        d, w = x.shape[-1], (1.0 + s).to(bf)
        times[f"rmsnorm_fwd/d8192-{tag}"] = dict(
            ms=timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            graph_us=GraphTimer()(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
            library_ms=timer(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            library_graph_us=GraphTimer()(lambda: F.rms_norm(x, (d,), w,
                                                             1e-5)),
            shape=f"x ({x.shape[0]}, {d}) bf16",
            **bound(2 * x.numel() * x.element_size() + 4 * d,
                    4 * x.numel(), bf))
    times["flash/starcoder2"], err = starcoder2_flash_fwd(FA, ref, timer, g)
    errors.append(("flash_fwd", "hd128-starcoder2", "bfloat16", err))
    times["flash_bwd_dkv/starcoder2_f64"] = starcoder2_dkv_f64(FA, ref, g)
    log(f"phase 16a: {times}")
    return errors, times


def starcoder2_flash_fwd(FA, ref, timer, g):
    """Phase 12b's starcoder2-3b prompt through the flash forward (B=2,
    S = 4,500, GQA 24/2, hd 128, no window), in bfloat16 as the Server
    runs it: checked against ``attention_ref`` (2e-2) and timed beside
    its plain version, its bound and SDPA.  No path runs the backward at
    this shape (starcoder2 trains through its windowed layers)."""
    bf = torch.bfloat16
    B, S, H, Hkv, hd = 2, 4500, 24, 2, 128
    q, k, v = (torch.randn(B, n, S, hd, generator=g, device="cuda").to(bf)
               for n in (H, Hkv, Hkv))
    out, lse = FA.flash_fwd(q, k, v)
    want, want_lse = ref.attention_ref(q, k, v)
    err = max(max_err(out, want, bf), max_err(lse, want_lse, bf))
    del want, want_lse
    pairs = B * H * S * (S + 1) / 2
    row = dict(
        ms=timer(lambda: FA.flash_fwd(q, k, v)),
        plain_ms=timer(lambda: ref.attention_ref(q, k, v)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        shape=f"q (B={B}, S={S}, H={H}, hd={hd}), Hkv={Hkv} bf16, causal",
        **bound((2 * B * H + 2 * B * Hkv) * S * hd * 2 + 4 * B * H * S,
                4 * hd * pairs, bf))
    torch.cuda.empty_cache()
    return row, err


def starcoder2_dkv_f64(FA, ref, g) -> dict:
    """The float32 flash dk/dv at starcoder2-3b's prompt shape (B=2,
    S = 4,500, GQA 24/2, hd 128), where the kernel once missed the 2e-5
    gate against ``flash_bwd_ref`` (ROADMAP Queue 3): the kernel and the
    plain version each held to a float64 dk/dv of the same inputs (q, k,
    v, do, and the kernel forward's out and lse), computed a head at a
    time.  Gate: the kernel no further from float64 than the plain
    version, or within 2e-5 of it."""
    B, S, H, Hkv, hd = 2, 4500, 24, 2, 128
    G = H // Hkv
    q, k, v, do = (torch.randn(B, n, S, hd, generator=g, device="cuda")
                   for n in (H, Hkv, Hkv, H))
    out, lse = FA.flash_fwd(q, k, v)
    _, dk, dv = FA.flash_bwd(q, k, v, out, lse, do)
    _, wk, wv = ref.flash_bwd_ref(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    dk64 = torch.zeros(B, Hkv, S, hd, dtype=torch.float64, device="cuda")
    dv64 = torch.zeros_like(dk64)
    keep = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    lse4 = lse.reshape(B, H, S).double()
    for b in range(B):
        for h in range(H):
            j = h // G
            q64, k64, v64 = q[b, h].double(), k[b, j].double(), \
                v[b, j].double()
            do64, o64 = do[b, h].double(), out[b, h].double()
            s = (q64 @ k64.T) / math.sqrt(hd)
            p = torch.exp(s.masked_fill(~keep, -math.inf)
                          - lse4[b, h, :, None])
            delta = (do64 * o64).sum(dim=-1, keepdim=True)
            ds = p * (do64 @ v64.T - delta) / math.sqrt(hd)
            dk64[b, j] += ds.T @ q64
            dv64[b, j] += p.T @ do64
    del p, ds, s

    def gap(xk, xv, yk, yv):
        d = torch.maximum((xk.double() - yk.double()).abs().amax(),
                          (xv.double() - yv.double()).abs().amax())
        return float(d)

    row = {"kernel_vs_f64": gap(dk, dv, dk64, dv64),
           "plain_vs_f64": gap(wk, wv, dk64, dv64),
           "kernel_vs_plain": gap(dk, dv, wk, wv),
           "kernel_over_2e-5_vs_f64": int(
               ((dk.double() - dk64).abs() > 2e-5).sum()
               + ((dv.double() - dv64).abs() > 2e-5).sum()),
           "plain_over_2e-5_vs_f64": int(
               ((wk.double() - dk64).abs() > 2e-5).sum()
               + ((wv.double() - dv64).abs() > 2e-5).sum()),
           "elements": 2 * dk.numel(), "max_abs_dk_dv": float(torch.maximum(
               dk64.abs().amax(), dv64.abs().amax())),
           "shape": f"q (B={B}, S={S}, H={H}, hd={hd}), Hkv={Hkv} float32, "
                    f"causal"}
    del q, k, v, do, out, lse, dk, dv, wk, wv, dk64, dv64
    torch.cuda.empty_cache()
    if row["kernel_vs_f64"] > max(row["plain_vs_f64"], 2e-5):
        raise AssertionError(f"flash dk/dv at starcoder2's shape: {row}")
    return row


def encdec_launches(cfg, remat: bool) -> dict:
    """The enc-dec's kernel launches a micro-batch: RMSNorm 2 a layer of
    the encoder and 3 of the decoder, plus ``enc_norm`` and
    ``final_norm``, forward (twice under remat) and backward; flash
    forward once a decoder layer (twice under remat), dq and dk/dv once;
    the bidirectional attention (the encoder's, the cross-attention)
    launches none (``chunked_attention``)."""
    Le, Ld, r = cfg.n_encoder_layers, cfg.n_layers, 2 if remat else 1
    norms = 2 * Le + 3 * Ld
    return {"rmsnorm_fwd": norms * r + 2, "rmsnorm_bwd": norms + 2,
            "flash_fwd": Ld * r, "flash_bwd_dq": Ld, "flash_bwd_dkv": Ld}


def encdec_run(cfg):
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    return RunConfig(model=cfg,
                     schedule=ScheduleConfig(kind="seesaw", alpha=2.0,
                                             n_cuts=1),
                     optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                               beta2=0.95, grad_clip=1.0),
                     seq_len=1024, global_batch_size=4,
                     total_tokens=ENCDEC_TOKENS, dtype="bfloat16")


def encdec_chunk(src, rng, start, k, B, cfg, seq):
    """k steps of B examples, stacked (k, B, ...) on the card: text from
    ``MarkovLM`` sequences start.., frames seeded numpy normals (B,
    frontend_tokens, frontend_dim) float32."""
    raw = src.sample(start, k * B, seq)
    out = {n: torch.from_numpy(v.astype(np.int64).reshape(k, B, seq)).cuda()
           for n, v in raw.items()}
    out["src_emb"] = torch.from_numpy(rng.standard_normal(
        (k, B, cfg.frontend_tokens, cfg.frontend_dim),
        dtype=np.float32)).cuda()
    return out


def bidirectional_attention_ms(cfg, B: int, S: int) -> dict:
    """One layer's bidirectional ``chunked_attention`` (the enc-dec's
    encoder and cross-attention; plain PyTorch in float32, as the
    reference's XLA path) at (B, S, H, hd) bf16: the forward, and the
    forward with its backward, in device ms; ``step_ms`` what a B-row
    micro-batch spends in them under remat (2·12 layers, each forward
    twice and backward once)."""
    from repro_torch.models.attention import chunked_attention
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn(B, S, cfg.n_heads, cfg.head_dim, generator=g,
                           device="cuda").to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    with torch.no_grad():
        fwd = event_ms(lambda: chunked_attention(q, k, v, causal=False), 3)
    both = event_ms(lambda: torch.autograd.grad(
        chunked_attention(q, k, v, causal=False).float().sum(), (q, k, v)),
        3)
    layers = cfg.n_encoder_layers + cfg.n_layers
    return {"shape": f"q, k, v ({B}, {S}, {cfg.n_heads}, {cfg.head_dim}) "
                     f"bf16, float32 scores", "fwd_ms": fwd,
            "fwd_bwd_ms": both, "step_ms": layers * (fwd + both)}


def phase16b(cfg, R, ctr, smi):
    """seamless-m4t-medium at full width and depth (12 + 12 layers, 877.2M
    parameters held, 675.7M counted by the reference's formula; 14.0 GB
    of float32 weights, grads and AdamW state), bf16 compute, remat,
    through the engine's grad step (``train.engine.PhaseEngine``; the
    reference's ``Trainer`` cannot feed frames either): Seesaw α = 2 with
    one cut, 6 steps at B = 4 and 2 at B = 8 (micro 2), each example
    1,024 frames and 1,024 text tokens of ``MarkovLM(2048, 0)``.  Gates:
    each step's LR, batch and phase the plan's; losses finite and
    falling; launches exactly remat's per micro-batch; one graph per
    (batch size, micro); a step at B = 4 and one at B = 8 replayed and
    run eagerly on a clone of the state, bit for bit; the reduced
    seamless in float32 on the card against the CPU (loss 1e-4, grads
    1e-3 of each tensor's max)."""
    from repro_torch.core.seesaw import build_plan
    from repro_torch.data import MarkovLM
    from repro_torch.optim import optimizers as O
    from repro_torch.train import engine as E
    run = encdec_run(cfg)
    sch, seq = run.schedule, run.seq_len
    plan = build_plan(kind=sch.kind, base_lr=sch.base_lr,
                      total_tokens=run.total_tokens,
                      warmup_frac=sch.warmup_frac, b0=run.global_batch_size,
                      alpha=sch.alpha, n_cuts=sch.n_cuts)
    opt = O.from_config(run.optimizer)
    eng = E.PhaseEngine(run, opt, plan, max_device_batch=4)
    steps = plan.steps_per_phase(seq)
    micro = [eng.micro_batches(b) for b in plan.batch_sizes()]
    if (plan.batch_sizes(), steps, micro) != ([4, 8], [6, 2], [1, 2]):
        raise AssertionError(f"plan: {plan.batch_sizes()} {steps} {micro}")
    torch.cuda.reset_peak_memory_stats()
    model = R.init_model(cfg, seed=0, dtype=torch.float32, device="cuda",
                         trainable=True)
    opt_state = opt.init(dict(model.named_parameters()))
    src, rng = MarkovLM(2048, seed=0), np.random.default_rng(16)
    for m, a in ctr.values():
        setattr(m, a, 0)
    chunks, hist = [], []
    tok = step = start = 0
    t0 = time.perf_counter()
    for ph, n_steps in zip(plan.phases, steps):
        B = ph.batch_size
        for c in range(0, n_steps, 4):
            k = min(4, n_steps - c)
            stacked = encdec_chunk(src, rng, start, k, B, cfg, seq)
            torch.cuda.synchronize()
            t, cap = time.perf_counter(), eng.capture_s
            model, opt_state, m = eng.run_chunk(model, opt_state, tok,
                                                stacked, step=step)
            torch.cuda.synchronize()
            chunks.append((B, k, time.perf_counter() - t,
                           eng.capture_s - cap))
            for i in range(k):
                want_lr = float(eng.lr_fn(float(tok + i * B * seq),
                                          step + i))
                if float(m["lr"][i]) != want_lr:
                    raise AssertionError(f"step {step + i + 1}: lr "
                                         f"{float(m['lr'][i])}, plan "
                                         f"{want_lr}")
                hist.append({"step": step + i + 1, "batch_size": B,
                             "phase": ph.index, "lr": want_lr,
                             "loss": float(m["loss"][i]),
                             "grad_norm": float(m["grad_norm"][i])})
            tok, step, start = tok + k * B * seq, step + k, start + k * B
    wall = time.perf_counter() - t0
    launches = {n: getattr(mod, a) for n, (mod, a) in ctr.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    mb = sum(n * mi for n, mi in zip(steps, micro))
    per = encdec_launches(cfg, run.remat)
    want = dict({n: 0 for n in ctr}, **{n: v * mb for n, v in per.items()})
    if launches != want:
        raise AssertionError(f"launches {launches}, remat gives {want}")
    if eng.captures != 2:
        raise AssertionError(f"{eng.captures} captures, want 2")
    stats = {}
    for b in plan.batch_sizes():
        timed = [(n, dt - cap) for i, (bb, n, dt, cap) in enumerate(chunks)
                 if bb == b and i > 0]
        n, sec = sum(c[0] for c in timed), sum(c[1] for c in timed)
        stats[str(b)] = {"step_ms": 1e3 * sec / n,
                         "tok_per_s": b * seq * n / sec,
                         "frames_and_tok_per_s": 2 * b * seq * n / sec,
                         "steps_timed": n}
    n_params = sum(p.numel() for p in model.parameters())
    out = {"model": cfg.name, "params": n_params,
           "config_param_count": cfg.param_count(),
           "state_gb": 16 * n_params / 1e9, "steps": len(hist),
           "plan_steps": steps, "batch_sizes": plan.batch_sizes(),
           "micro_batches": micro, "wall_s": wall,
           "captures": eng.captures, "captures_s": eng.capture_s,
           "per_batch_size": stats, "peak_mem_gb": peak,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "grad_norms": norms,
           "lrs": [h["lr"] for h in hist], "launches": launches,
           "launches_per_micro_batch": per, "micro_batches_run": mb,
           "card": smi}
    # replays against eager steps, bit for bit, at micro 1 and 2
    for b in (4, 8):
        chunk = encdec_chunk(MarkovLM(2048, seed=9), rng, start, 1, b, cfg,
                             seq)
        twin = clone_state(model, opt_state)
        _, _, m = eng.run_chunk(model, opt_state, tok, chunk, step=step)
        _, _, want_m = eng.step_for(b).grad(
            *twin, {k: v[0] for k, v in chunk.items()}, m["lr"][0].cuda())
        torch.cuda.synchronize()
        if not same_state((model, opt_state), twin) or not all(
                torch.equal(m[k][0], v) for k, v in want_m.items()):
            raise AssertionError(f"B={b}: the replay differs from the "
                                 f"eager step")
        del twin
        step, tok, start = step + 1, tok + b * seq, start + b
    out["graphs_bitwise"] = {"micro1_steps": 1, "micro2_steps": 1,
                             "captures": eng.captures}
    del model, opt_state, eng
    gc.collect()
    torch.cuda.empty_cache()
    out["bidirectional_attention"] = bidirectional_attention_ms(cfg, 4, seq)
    out["card_vs_cpu"], _ = loss_card_vs_cpu(cfg.reduced(), R)
    log(f"phase 16b: {stats}, card vs cpu {out['card_vs_cpu']}")
    return out


def encdec_step_bytes(model, cfg, batch: int, positions: int) -> int:
    """Bytes an enc-dec decode step must move at least: the decoder's
    weights once (not the encoder's, nor the cross-attention's w_k and
    w_v, which the prefill used), of the untied embedding only the
    ``batch`` rows looked up, the head; each layer's self-attention K/V
    over ``positions`` slots and its cross-attention ek/ev over the
    frames, a row."""
    es = model.tok.element_size()
    dec = sum(p.numel() * p.element_size()
              for n, p in model.named_parameters()
              if n.startswith("decoder.") and not n.endswith(
                  ("cross_attn.w_k", "cross_attn.w_v")))
    head = model.lm_head.numel() * es + batch * cfg.d_model * es
    kv = batch * cfg.n_layers * (positions + cfg.frontend_tokens) * 2 \
        * cfg.kv_dim * es
    return dec + head + model.final_norm.numel() * 4 + kv


def served_generate(srv, eager, ctr, toks, prefix, n_new, want):
    """``toks`` through the replayed Server and through the all-eager one,
    the source frames or patches as ``prefix``: launches (counted on the
    replayed one) exactly ``want``, tokens equal and in the vocab."""
    for m, a in ctr.values():
        setattr(m, a, 0)
    out, wall = quiet_generate(srv, toks, n_new, prefix_emb=prefix)
    launches = {n: getattr(m, a) for n, (m, a) in ctr.items()}
    if launches != dict({n: 0 for n in ctr}, **want):
        raise AssertionError(f"launches {launches}, want {want}")
    ref_out, eager_wall = quiet_generate(eager, toks, n_new,
                                         prefix_emb=prefix)
    if not np.array_equal(out, ref_out):
        raise AssertionError("replayed tokens differ from the eager ones")
    if out.min() < 0 or out.max() >= srv.cfg.padded_vocab:
        raise AssertionError("token out of the vocab")
    B = toks.shape[0]
    return {"batch": B, "prompt": toks.shape[1], "prefix": prefix.shape[1],
            "new": n_new, "wall_s": wall, "tok_per_s": B * n_new / wall,
            "eager_wall_s": eager_wall,
            "eager_tok_per_s": B * n_new / eager_wall,
            "tokens_equal_eager": True, "launches": launches}


def phase16c(cfg, R, Server, ctr, smi):
    """seamless-m4t-medium at full width and depth through the ``Server``
    (bf16, ``max_len`` 128): 2 sources of 1,024 frames, prompts of 16
    tokens, 64 new, after a warm-up that runs the entry's first decode
    step eagerly and captures its graph.  Launches exactly: a prefill
    RMSNorm 2·12 + 1 (encoder) + 3·12 + 1 (decoder), flash 12; a decode
    step RMSNorm 3·12 + 1 and the ragged decode 24 (self- and
    cross-attention); tokens equal an all-eager Server's.  Reports
    tok/s, the prefill's ms split into the encoder (and of it 12 layers'
    bidirectional ``chunked_attention``, timed alone at (2, 1,024, 16,
    64)), the decoder and the head, a replayed decode step against its
    bytes bound, the peak; then
    the reduced seamless in float32 on the card and the CPU: first-token
    logits within 1e-3, tokens equal."""
    from repro_torch.models import encdec as ED
    from repro_torch.models.transformer import logits_from_hidden
    bf = torch.bfloat16
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = R.init_model(cfg, seed=0, dtype=bf, device="cuda")
    srv = Server(cfg, model, max_len=128, dtype=bf)
    eager = eager_server(Server, cfg, model, max_len=128, dtype=bf)
    rng = np.random.default_rng(16)

    def frames():
        return rng.standard_normal((2, cfg.frontend_tokens,
                                    cfg.frontend_dim)).astype(np.float32)

    quiet_generate(srv, rng.integers(0, cfg.vocab_size, (2, 16)), 3,
                   prefix_emb=frames())
    if srv.captures != 1:
        raise AssertionError(f"warm-up captured {srv.captures} graphs")
    n_new = 64
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    src = frames()
    rec = served_generate(srv, eager, ctr, toks, src, n_new, {
        "rmsnorm_fwd": 2 * Le + 3 * Ld + 2 + (3 * Ld + 1) * (n_new - 1),
        "flash_fwd": Ld, "ragged_decode": 2 * Ld * (n_new - 1)})
    if srv.captures != 1:
        raise AssertionError(f"{srv.captures} captures, want 1")
    t = torch.from_numpy(toks).long().cuda()
    s = torch.from_numpy(src).to(device="cuda", dtype=bf)
    attn_ms = bidirectional_attention_ms(cfg, 2, cfg.frontend_tokens)[
        "fwd_ms"]
    with torch.inference_mode():
        prefill_ms = event_ms(lambda: srv.prefill(t, s), 5)
        enc_ms = event_ms(lambda: ED.encode(model, cfg, s, remat=False), 5)
        h = torch.randn(2, 1, cfg.d_model, device="cuda").to(bf)
        head_ms = event_ms(lambda: logits_from_hidden(model, h), 5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step = server_step(srv, cfg, 128, smi, "profile_encdec_decode.txt",
                       n_bytes=encdec_step_bytes(model, cfg, 2, 128))
    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    del srv, eager, model
    torch.cuda.empty_cache()
    small = cfg.reduced()
    r = np.random.default_rng(5)
    diff, small_toks = server_card_vs_cpu(small, R, Server, [
        (r.integers(0, small.vocab_size, (2, S)), n,
         r.standard_normal((2, small.frontend_tokens,
                            small.frontend_dim)).astype(np.float32))
        for S, n in ((9, 12), (1, 6))], seed=5)
    return {"model": cfg.name, "params": n_params,
            "config_param_count": cfg.param_count(), "weight_gb": weight_gb,
            "max_len": 128, "generate": rec, "captures": 1,
            "peak_mem_gb": peak,
            "prefill": {"prefill_ms": prefill_ms, "encoder_ms": enc_ms,
                        "encoder_attention_ms": Le * attn_ms,
                        "one_layer_bidirectional_attention_ms": attn_ms,
                        "head_ms": head_ms,
                        "decoder_ms": prefill_ms - enc_ms - head_ms},
            "decode_step": step,
            "card_vs_cpu": {"first_token_logit_max_abs_diff": diff,
                            "tokens": small_toks},
            "card": smi}


def phase16d(cfg, R, Server, ctr, smi):
    """internvl2-76b at full width cut to 16 of its 80 layers (15.8B
    parameters, 31.6 GB in bf16) through the bucketed ``Server``
    (``max_len`` 2048): 2 prompts of a 1,024-patch prefix and 64 text
    tokens, 32 new, after a warm-up that captures the decode graph.
    Launches exactly: a prefill RMSNorm 2·16 + 1, flash 16; a decode step
    RMSNorm 2·16 + 1, the ragged decode 16; tokens equal an all-eager
    Server's.  Reports tok/s, the prefill's ms split into the trunk and
    the head, a replayed decode step against its bytes bound, the peak;
    then the reduced internvl in float32 on the card and the CPU with a
    prefix: first-token logits within 1e-3, tokens equal."""
    from repro_torch.models.transformer import logits_from_hidden
    bf = torch.bfloat16
    cut = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    L = cut.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = R.init_model(cut, seed=0, dtype=bf, device="cuda")
    srv = Server(cut, model, max_len=2048, dtype=bf)
    eager = eager_server(Server, cut, model, max_len=2048, dtype=bf)
    rng = np.random.default_rng(17)

    def patches():
        return rng.standard_normal((2, cut.frontend_tokens,
                                    cut.frontend_dim)).astype(np.float32)

    quiet_generate(srv, rng.integers(0, cut.vocab_size, (2, 64)), 3,
                   prefix_emb=patches())
    if srv.captures != 1:
        raise AssertionError(f"warm-up captured {srv.captures} graphs")
    n_new = 32
    toks = rng.integers(0, cut.vocab_size, (2, 64)).astype(np.int32)
    pre = patches()
    rec = served_generate(srv, eager, ctr, toks, pre, n_new, {
        "rmsnorm_fwd": (2 * L + 1) * n_new, "flash_fwd": L,
        "ragged_decode": L * (n_new - 1)})
    if srv.captures != 1 or srv.n_prefill_executables != 1:
        raise AssertionError(f"{srv.captures} captures, "
                             f"{srv.n_prefill_executables} prefill keys")
    t = torch.from_numpy(toks).long().cuda()
    p = torch.from_numpy(pre).to(device="cuda", dtype=bf)
    with torch.inference_mode():
        prefill_ms = event_ms(lambda: srv.prefill(t, p), 3)
        h = torch.randn(2, 1, cut.d_model, device="cuda").to(bf)
        head_ms = event_ms(lambda: logits_from_hidden(model, h), 5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    positions = cut.frontend_tokens + 64 + n_new
    step = server_step(srv, cut, positions, smi, "profile_vlm_decode.txt")
    n_params = sum(p_.numel() for p_ in model.parameters())
    weight_gb = sum(p_.numel() * p_.element_size()
                    for p_ in model.parameters()) / 1e9
    del srv, eager, model
    torch.cuda.empty_cache()
    small = cfg.reduced()
    r = np.random.default_rng(6)
    diff, small_toks = server_card_vs_cpu(small, R, Server, [
        (r.integers(0, small.vocab_size, (2, S)), n,
         r.standard_normal((2, small.frontend_tokens,
                            small.frontend_dim)).astype(np.float32))
        for S, n in ((20, 12), (1, 6))], seed=6)
    return {"model": f"{cfg.name} cut to {L} layers", "params": n_params,
            "full_depth_params": cfg.param_count(), "weight_gb": weight_gb,
            "max_len": 2048, "generate": rec, "captures": 1,
            "peak_mem_gb": peak,
            "prefill": {"prefill_ms": prefill_ms, "head_ms": head_ms,
                        "trunk_ms": prefill_ms - head_ms,
                        "positions": cut.frontend_tokens + 64},
            "decode_step": step,
            "card_vs_cpu": {"first_token_logit_max_abs_diff": diff,
                            "tokens": small_toks},
            "card": smi}


def phase16e(cfg, R, serving, kernel_modules, smi):
    """mistral-nemo-12b at full width and depth (40 layers, 12.25B
    parameters, 24.5 GB in bf16) from the paged engine on phase 2's mix
    (8 slots, page 16, max_len 1024, 16 requests): tokens equal an
    all-eager engine's, tok/s beside the eager tok/s, and a replayed
    decode step with every slot live against its bytes bound."""
    torch.cuda.reset_peak_memory_stats()
    eng, rec = phase2(cfg, R, serving, kernel_modules)
    eng.reset()
    rec["decode_step"] = engine_decode_step(
        eng, serving, requests(cfg), cfg, smi, "profile_nemo_decode.txt")
    rec["params"] = sum(p.numel() for p in eng.model.parameters())
    rec["config_param_count"] = cfg.param_count()
    rec["card"] = smi
    del eng
    torch.cuda.empty_cache()
    return rec


def phase16_kernel_entries(kernels, record):
    """Phase 16's part of the ``kernels`` line: on the flash, ragged
    decode and RMSNorm forward entries, the new head shapes (hd 128, GQA
    groups of 8 and 7; d 8192) with their errors, ms, bound, plain and
    library ms, each kernel's launches in 16b-16e, and the float32 dk/dv
    at starcoder2's prompt against float64."""
    fam = record["families"]
    err = {(n, tag, dn): e for n, tag, dn, e in fam["kernels"]["errors"]}
    times = fam["kernels"]["times"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    for k in kernels:
        name = k["name"]
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            row = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
                   "flash_bwd_dkv": "dkv"}[name]
            k["hd128_gqa"] = {
                tag: {**{f: times[f"flash/{tag}"][row][f] for f in keys},
                      "max_abs_err": err[(name, f"hd128-{tag}",
                                          "bfloat16")],
                      "max_abs_err_f32": err[(name, f"hd128-{tag}",
                                              "float32")]}
                for tag in ("internvl-prefill", "yi")}
            k["hd128_gqa_max_abs_err_all_shapes"] = {
                dn: max(e for (n, _, d), e in err.items()
                        if n == name and d == dn)
                for dn in ("bfloat16", "float32")}
            if name == "flash_fwd":
                k["starcoder2_prompt"] = {
                    **{f: times["flash/starcoder2"][f] for f in keys},
                    "max_abs_err": err[(name, "hd128-starcoder2",
                                        "bfloat16")]}
            if name == "flash_bwd_dkv":
                k["starcoder2_f32_vs_float64"] = times[
                    "flash_bwd_dkv/starcoder2_f64"]
        if name == "ragged_decode":
            k["hd128_gqa"] = {
                tag: {**{f: times[f"ragged_decode/{tag}"][f] for f in keys},
                      "max_abs_err": err[(name, f"hd128-{tag}",
                                          "bfloat16")],
                      "max_abs_err_f32": err[(name, f"hd128-{tag}",
                                              "float32")],
                      "paged_max_abs_err": err[("paged_decode",
                                                f"hd128-{tag}-ps16",
                                                "bfloat16")]}
                for tag in ("internvl", "yi")}
        if name == "rmsnorm_fwd":
            k["d8192"] = {
                tag: {**{f: times[f"rmsnorm_fwd/d8192-{tag}"][f]
                         for f in keys + ("graph_us", "library_graph_us")},
                      "max_abs_err": err[(name, f"d8192-{tag}",
                                          "bfloat16")],
                      "max_abs_err_f32": err[(name, f"d8192-{tag}",
                                              "float32")]}
                for tag in ("decode", "prefill")}
        if name in fam["encdec_train"]["launches"]:
            k["encdec_train_launches"] = fam["encdec_train"]["launches"][
                name]
        for cell in ("encdec_serve", "vlm_serve"):
            got = fam[cell]["generate"]["launches"]
            if name in got:
                k[f"{cell}_launches"] = got[name]
        mod = {"rmsnorm_fwd": "rmsnorm", "flash_fwd": "flash_attention",
               "ragged_decode": "paged"}.get(name)
        if mod:
            k["nemo_serve_launches"] = fam["nemo_serve"]["launches"][mod]


# --------------------------------------------------------------------- #
# phase 17: data parallelism, two launcher processes on the one card
# --------------------------------------------------------------------- #

# seesaw-150m at full width and depth, bf16 compute, float32 AdamW,
# phase 4's MarkovLM(2048) data, Seesaw alpha = 2 from B = 8 to B = 16
# (6 + 2 steps), micro-batches of at most 8 rows
DP_ARGS = ["--arch", "seesaw-150m", "--schedule", "seesaw", "--alpha", "2",
           "--max-cuts", "1", "--batch-size", "8", "--seq-len", "1024",
           "--total-tokens", str(8 * 1024 * 9), "--max-device-batch", "8",
           "--fuse-steps", "1"]
DP_SAVE_STEP = 4
# each process: the launcher's main with the flags given, then its
# history, wall, launch counts and peak memory into a JSON file
DP_RANK = r"""
import json, sys, time
import torch
from repro_torch import graphs
from repro_torch.launch import train
t = time.perf_counter()
hist = train.main(sys.argv[2:])
torch.cuda.synchronize()
with open(sys.argv[1], "w") as f:
    json.dump({"history": hist, "wall_s": time.perf_counter() - t,
               "launches": list(graphs.launch_counts()),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9},
              f)
"""
DP_HIST_KEYS = ("step", "tokens", "lr", "batch_size", "phase")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(tmp, tag, n, extra, args=None):
    """Start the launcher as ``n`` processes (n = 1: no group) with
    ``args`` (``DP_ARGS`` by default) ``+ extra``; returns the processes
    and their JSON paths."""
    args = DP_ARGS if args is None else args
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(free_port())
    procs = []
    for r in range(n):
        group = (["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                  str(n), "--process-id", str(r), "--per-host"]
                 if n > 1 else [])
        out = os.path.join(tmp, f"{tag}{r}.json")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", DP_RANK, out, *args, *extra, *group],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    return procs


def wait_ranks(procs, timeout=300):
    """Each process's (JSON record, stdout); raises if one failed."""
    res = []
    try:
        for p, out in procs:
            text, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"launcher process exited "
                                     f"{p.returncode}: {text[-4000:]}")
            with open(out) as f:
                rec = json.load(f)
            rec["stdout"] = text
            res.append(rec)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def dp_initial_params(cfg) -> dict:
    """The launcher's initial parameters (``Trainer``'s seed 0 on the
    card), by checkpoint leaf."""
    from repro_torch.models import registry as R
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.weights import param_tree
    model = R.init_model(cfg, seed=0, dtype=torch.float32, device="cuda",
                         trainable=True)
    return {f"p:{k}": (torch.stack(list(v)) if isinstance(v, CKPT.Stacked)
                       else v).detach()
            for k, v in CKPT._flatten(param_tree(model)).items()}


def dp_weights_diff(a: str, b: str, w0: dict) -> dict:
    """Two runs' parameters from one start ``w0``, checkpoint leaf by
    leaf: ||a - b|| over ||a - w0||, the runs' difference against the
    update (the gate's measure: a leaf that starts at zero, as the norm
    scales do, has a norm of its update's size), the worst leaf and the
    median; and the largest |a - b| over the leaf's largest |a - w0|.
    AdamW moves an element whose grad sits near zero by up to the LR a
    step on a rounding change, so single elements drift far more than
    the leaf."""
    with open(os.path.join(a, "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(b, "manifest.json")) as f:
        mb = json.load(f)
    if ma["arrays"].keys() != mb["arrays"].keys() or \
            not set(w0) <= ma["arrays"].keys():
        raise AssertionError("the checkpoints hold other leaves")
    norm, elem = {}, {}
    for key, w in w0.items():
        x, y = (torch.from_numpy(np.load(os.path.join(
            d, m["arrays"][key]["shards"][0]["file"]))).cuda().double()
            for d, m in ((a, ma), (b, mb)))
        up, d = x - w.double(), x - y
        norm[key] = float(d.norm() / up.norm())
        elem[key] = float(d.abs().max() / up.abs().max())
    k, j = max(norm, key=norm.get), max(elem, key=elem.get)
    return {"update_rel": norm[k], "leaf": k,
            "median_update_rel": float(np.median(list(norm.values()))),
            "max_elem_update_rel": elem[j], "elem_leaf": j}


def dp_check_run(got, want, tol, what):
    """LR, batch, phase and tokens equal step for step; loss and grad norm
    within ``tol`` relative: the largest differences found."""
    if [[h[k] for k in DP_HIST_KEYS] for h in got] != \
            [[h[k] for k in DP_HIST_KEYS] for h in want]:
        raise AssertionError(f"{what}: steps, LR, batch or phase differ: "
                             f"{[[h[k] for k in DP_HIST_KEYS] for h in got]}")
    worst = {}
    for name in ("loss", "grad_norm"):
        rel = [abs(a[name] - b[name]) / abs(b[name])
               for a, b in zip(got, want)]
        worst[name] = max(rel)
        if worst[name] > tol or not all(np.isfinite([a[name] for a in got])):
            raise AssertionError(f"{what}: {name} {rel} beyond {tol}")
    return worst


def phase17(cfg, ctr, smi):
    """Data parallelism on the card: the training launcher as two
    processes on the one H100 (``--coordinator 127.0.0.1:<port>
    --num-processes 2 --process-id r --per-host``; the ranks share the
    card, so the group is gloo), against one process of the same plan
    (``DP_ARGS``).  The two ranks train steps 1-4 alone on the card and
    save (a two-rank checkpoint); then, side by side, two ranks resume it
    for steps 5-8, one process resumes it too, and one process trains
    the whole plan.  The processes side by side share the card and the
    host: their walls are not one run's alone.  Gates: every process exits 0; the two ranks
    log one run (bitwise the same history); steps, tokens, LR, batch and
    phase equal the one process's; loss and grad norm within 2e-2 of its
    (bf16: another row split, other GEMM shapes); each leaf's final
    parameters apart by at most a quarter of its update from the initial
    ones (``dp_weights_diff``); the checkpoint's writers rotate over
    the two ranks and ``save_process_count`` is 2; each process launches
    the five training kernels exactly remat's counts times its
    micro-batches.  Reports the wall a step, the all-reduce's ms a step,
    each rank's peak memory and the differences."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    try:
        ck1, ck2 = os.path.join(tmp, "one"), os.path.join(tmp, "two")
        # alone on the card: the walls and the all-reduce's time are the
        # two ranks' own
        two_a = wait_ranks(launch_ranks(
            tmp, "two_a", 2, ["--steps", str(DP_SAVE_STEP),
                              "--checkpoint", ck2]))
        t_two_a = time.perf_counter()
        with open(os.path.join(ck2, "manifest.json")) as f:
            man = json.load(f)
        ck21 = os.path.join(tmp, "two_to_one")
        # the blocks linked, not copied: a save writes new files only
        shutil.copytree(ck2, ck21, copy_function=lambda a, b: (
            os.link(a, b) if a.endswith(".npy") else shutil.copy2(a, b)))
        procs = launch_ranks(tmp, "two_b", 2, ["--resume", "--checkpoint",
                                               ck2])
        procs += launch_ranks(tmp, "one_b", 1, ["--resume", "--checkpoint",
                                                ck21])
        procs += launch_ranks(tmp, "one", 1, ["--checkpoint", ck1])
        res = wait_ranks(procs)
        two_b, one_b, one = res[:2], res[2], res[3]
        t_end = time.perf_counter()
        want = one["history"]
        if len(want) != 8 or {h["batch_size"] for h in want} != {8, 16}:
            raise AssertionError(f"one process: {len(want)} steps")
        rows = [[{k: v for k, v in h.items() if k != "wall"}
                 for h in r["history"]] for r in two_a + two_b]
        if rows[0] != rows[1] or rows[2] != rows[3]:
            raise AssertionError("the two ranks logged different runs")
        diffs = {
            "two_ranks": dp_check_run(two_a[0]["history"]
                                      + two_b[0]["history"], want, 2e-2,
                                      "two ranks"),
            "two_to_one": dp_check_run(one_b["history"],
                                       want[DP_SAVE_STEP:], 2e-2,
                                       "2 -> 1 resume")}
        meta = man["meta"]
        writers = [e["shards"][0]["writer"] for _, e in
                   sorted(man["arrays"].items())]
        if meta["save_process_count"] != 2 or meta["step"] != \
                DP_SAVE_STEP or writers != [i % 2 for i in
                                            range(len(writers))]:
            raise AssertionError(f"two-rank save: meta {meta}, writers "
                                 f"{writers[:6]}...")
        t_w = time.perf_counter()
        w0 = dp_initial_params(cfg)
        diffs["weights_two_ranks"] = dp_weights_diff(ck1, ck2, w0)
        diffs["weights_two_to_one"] = dp_weights_diff(ck1, ck21, w0)
        del w0
        torch.cuda.empty_cache()
        for k in ("weights_two_ranks", "weights_two_to_one"):
            if diffs[k]["update_rel"] > 0.25:
                raise AssertionError(f"{k}: {diffs[k]}")
        from repro_torch import graphs as G
        per_micro = per_micro_batch(cfg, True)
        names = {n: G.COUNTERS.index(c) for n, c in ctr.items()}
        launches = {}
        for tag, recs, micro in (("one", [one], 6 + 2 * 2),
                                 ("two_ranks_steps_1_4", two_a, 4),
                                 ("two_ranks_steps_5_8", two_b, 2 + 2),
                                 ("two_to_one_steps_5_8", [one_b],
                                  2 + 2 * 2)):
            for r, rec in enumerate(recs):
                got = {n: rec["launches"][i] for n, i in names.items()}
                wantl = {n: v * micro for n, v in per_micro.items()}
                if got != wantl:
                    raise AssertionError(f"{tag} rank {r}: launches {got}, "
                                         f"remat gives {wantl}")
                launches[f"{tag}/rank{r}"] = got
        allreduce = []
        for rec in two_a + two_b:
            m = re.search(r"all-reduce: (\d+) steps, ([\d.]+) ms a step",
                          rec["stdout"])
            if not m:
                raise AssertionError("no all-reduce line: "
                                     + rec["stdout"][-2000:])
            allreduce.append(float(m.group(2)))

        def step_walls(hist):
            return [b["wall"] - a["wall"] for a, b in zip(hist, hist[1:])]

        out = {
            "plan": {"batch_sizes": [8, 16], "steps": [6, 2],
                     "micro_batches_one": [1, 2],
                     "micro_batches_per_rank": [1, 1],
                     "save_step": DP_SAVE_STEP},
            "wall_s": {"one": one["wall_s"],
                       "two_ranks_steps_1_4": [r["wall_s"] for r in two_a],
                       "two_ranks_steps_5_8": [r["wall_s"] for r in two_b],
                       "two_to_one_steps_5_8": one_b["wall_s"]},
            "phase_s": {"two_ranks_steps_1_4": t_two_a - t0,
                        "resumes_beside_one": t_end - t_two_a,
                        "weights_check": time.perf_counter() - t_w},
            # wall between a rank's consecutive logged steps (gloo makes
            # every step of the group wait for its all-reduce)
            "two_rank_step_walls_s": {
                "steps_1_4": step_walls(two_a[0]["history"]),
                "steps_5_8": step_walls(two_b[0]["history"])},
            "allreduce_ms_per_step": allreduce,
            "peak_gb": {"one": one["peak_gb"],
                        "two_ranks": [r["peak_gb"] for r in two_a + two_b],
                        "two_to_one": one_b["peak_gb"]},
            "peak_reserved_gb": [r["peak_reserved_gb"]
                                 for r in two_a + two_b],
            "largest_differences": diffs, "launches": launches,
            "losses": {"one": [h["loss"] for h in want],
                       "two_ranks": [h["loss"] for h in two_a[0]["history"]
                                     + two_b[0]["history"]]},
            "card": smi}
        m = re.search(r"all-reduce: \d+ steps, [\d.]+ ms a step \(([\d.]+) MB",
                      two_a[0]["stdout"])
        out["allreduce_mb"] = float(m.group(1))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# phase 18: the model axis, a data x model mesh of processes
# --------------------------------------------------------------------- #

# 18a: float32, B = 8 of 1,024 tokens, 2 steps of a constant LR
MESH_SEQ, MESH_B, MESH_STEPS = 1024, 8, 2
MESH_18A = (("seesaw-150m", 0, "2x2"), ("llama3.2-3b", 2, "1x2"))
# 18b: phase 17's run on a 2x2 mesh, 4 + 2 steps (B = 8 then 16), at
# lr 1e-4: at phase 17's 3e-3 the run spikes (loss 10.1 -> 13.4 at step
# 4) and turns any rounding difference into a different run (one process
# in float32 against itself on the mesh: loss 1e-6 apart at step 5, grad
# norm 29% at step 6), which no sharded arithmetic could meet 2e-2 on
MESH_LR = 1e-4
MESH_ARGS = DP_ARGS[:DP_ARGS.index("--total-tokens")] + [
    "--total-tokens", str(8 * 1024 * 7), "--max-device-batch", "8",
    "--fuse-steps", "1", "--lr", str(MESH_LR)]
MESH_SAVE_STEP = 4
# one rank of 18a: the trainer's seed-0 weights cut to the mesh (none
# for "1x1": one process), the first batch's loss and grads (gathered
# whole on the mesh; rank 0 saves them), then MESH_STEPS steps
MESH_RANK = r"""
import json, math, sys, time
from dataclasses import replace
import torch
from repro_torch import graphs, parallel
from repro_torch.configs import (OptimizerConfig, RunConfig,
                                 ScheduleConfig, get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.launch import mesh as M
from repro_torch.launch.train import maybe_init_distributed
from repro_torch.optim import optimizers as O
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
out, arch, layers, spec, port, rank, seq, b, steps = sys.argv[1:10]
layers, rank, seq, b, steps = map(int, (layers, rank, seq, b, steps))
dev = "cuda:0"
world = math.prod(M.parse_mesh(spec).values())
mesh = None
if world > 1:
    assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                                  device="cuda")
    mesh = M.make_launch_mesh(spec, distributed=True)
torch.cuda.set_device(dev)
cfg = get_config(arch)
if layers:
    cfg = replace(cfg, n_layers=layers)
run = RunConfig(model=cfg, schedule=ScheduleConfig(kind="constant",
                                                   base_lr=3e-3),
                optimizer=OptimizerConfig(kind="adamw"), seq_len=seq,
                global_batch_size=b, total_tokens=b * seq * steps,
                dtype="float32")
tr = Trainer(run, device=dev, mesh=mesh, max_device_batch=b)
slot = (dict(per_host=True, process_index=mesh.fsdp_index(rank),
             process_count=mesh.n_fsdp) if mesh else {})


def loader():
    return PhaseDataLoader(MarkovLM(2048, seed=0), tr.plan, seq,
                           device=dev, **slot)


it = iter(loader())
_, _, batch = next(it)
it.close()
model = tr.state.model
params = dict(model.named_parameters())
names, plist = list(params), list(params.values())
grads, metrics = E._local_grads(model, cfg, batch, names, params, 1, 0.0,
                                torch.float32, run.remat)
if mesh is None:
    norm, full = O.global_norm(grads), dict(zip(names, grads))
else:
    grads, metrics = parallel.reduce_grads(model.tp, plist, grads, metrics)
    norm = parallel.global_norm(model.tp, plist, grads)
    full = {}
    for n, g in zip(names, grads):
        shape, sp = model.full_shapes[n], model.specs[n]
        full[n] = parallel.gather_full(g, shape, [
            M.shard_box(shape, sp, mesh, r) for r in range(mesh.size)])
if rank == 0:
    torch.save({n: g.cpu() for n, g in full.items()}, out + ".grads.pt")
first = {"loss": float(metrics["loss"]), "grad_norm": float(norm)}
del grads, full, metrics
if mesh is not None:
    model.tp.comms.reset()
torch.cuda.synchronize()
t = time.perf_counter()
hist = tr.run(loader(), max_steps=steps)
torch.cuda.synchronize()
with open(out, "w") as f:
    json.dump({"first": first, "history": hist,
               "wall_s": time.perf_counter() - t,
               "launches": list(graphs.launch_counts()),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "comms": (model.tp.comms.summary() if mesh is not None
                         else None)}, f)
if mesh is not None:
    torch.distributed.destroy_process_group()
"""


def mesh_ranks(tmp, tag, arch, layers, spec):
    """Start ``MESH_RANK`` as one process a slot of ``spec`` ("1x1": one
    process, no group); returns the processes and their JSON paths."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(free_port())
    n = math.prod(int(x) for x in spec.split("x"))
    procs = []
    for r in range(n):
        out = os.path.join(tmp, f"{tag}{r}.json")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", MESH_RANK, out, arch, str(layers), spec,
             port, str(r), str(MESH_SEQ), str(MESH_B), str(MESH_STEPS)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    return procs


def mesh_grads_diff(a: str, b: str) -> dict:
    """The largest |a - b| of two saved grad sets over each leaf's
    largest |b|, on the card, and its leaf."""
    ga = torch.load(a, weights_only=True)
    gb = torch.load(b, weights_only=True)
    if ga.keys() != gb.keys():
        raise AssertionError("the grad sets hold other leaves")
    rel = {}
    for n, want in gb.items():
        x, y = ga[n].cuda(), want.cuda()
        if x.shape != y.shape:
            raise AssertionError(f"{n}: {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        rel[n] = float((x - y).abs().max() / y.abs().max())
    k = max(rel, key=rel.get)
    return {"max_rel": rel[k], "leaf": k, "leaves": len(rel)}


def check_rank_launches(recs, ctr, per_micro, micro, what):
    """Each process's launches of the training kernels: remat's counts
    a micro-batch times its ``micro`` micro-batches."""
    from repro_torch import graphs as G
    names = {n: G.COUNTERS.index(c) for n, c in ctr.items()}
    want = {n: v * micro for n, v in per_micro.items()}
    out = {}
    for r, rec in enumerate(recs):
        got = {n: rec["launches"][i] for n, i in names.items()}
        if got != want:
            raise AssertionError(f"{what} rank {r}: launches {got}, remat "
                                 f"gives {want}")
        out[f"{what}/rank{r}"] = got
    return out


def phase18a(tmp, ctr):
    """Float32, the same weights and rows: each ``MESH_18A`` config on its
    mesh against one process (all four runs side by side)."""
    from repro_torch.configs import get_config
    procs = {}
    for arch, layers, spec in MESH_18A:
        procs[(arch, spec)] = mesh_ranks(tmp, f"{arch}-{spec}-", arch,
                                         layers, spec)
        procs[(arch, "1x1")] = mesh_ranks(tmp, f"{arch}-1x1-", arch, layers,
                                          "1x1")
    flat = wait_ranks([p for ps in procs.values() for p in ps], timeout=600)
    res, i = {}, 0
    for k, ps in procs.items():
        res[k], i = flat[i:i + len(ps)], i + len(ps)
    out, launches = {}, {}
    for arch, layers, spec in MESH_18A:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        ranks, one = res[(arch, spec)], res[(arch, "1x1")][0]
        rows = [[{k: v for k, v in h.items() if k != "wall"}
                 for h in r["history"]] for r in ranks]
        if any(r != rows[0] for r in rows):
            raise AssertionError(f"{arch}: the ranks logged other runs")
        first, want = ranks[0]["first"], one["first"]
        d_loss = abs(first["loss"] - want["loss"])
        d_norm = abs(first["grad_norm"] - want["grad_norm"]) / \
            want["grad_norm"]
        grads = mesh_grads_diff(
            os.path.join(tmp, f"{arch}-{spec}-0.json.grads.pt"),
            os.path.join(tmp, f"{arch}-1x1-0.json.grads.pt"))
        steps = []
        for a, b in zip(ranks[0]["history"], one["history"]):
            if [a[k] for k in DP_HIST_KEYS] != [b[k] for k in DP_HIST_KEYS]:
                raise AssertionError(f"{arch}: step {a} against {b}")
            steps.append({"loss": abs(a["loss"] - b["loss"]),
                          "grad_norm": abs(a["grad_norm"] - b["grad_norm"])
                          / b["grad_norm"]})
        if len(steps) != MESH_STEPS or d_loss > 1e-4 or d_norm > 1e-3 or \
                grads["max_rel"] > 1e-3 or any(
                    s["loss"] > 1e-4 or s["grad_norm"] > 1e-3
                    for s in steps):
            raise AssertionError(f"{arch} on {spec}: loss {d_loss}, grad "
                                 f"norm {d_norm}, grads {grads}, steps "
                                 f"{steps}")
        per_micro = per_micro_batch(cfg, True)
        launches.update(check_rank_launches(ranks, ctr, per_micro,
                                            1 + MESH_STEPS, f"{arch}/{spec}"))
        launches.update(check_rank_launches([one], ctr, per_micro,
                                            1 + MESH_STEPS, f"{arch}/one"))
        out[f"{arch}/{spec}"] = {
            "layers": cfg.n_layers, "first_loss": first["loss"],
            "first_loss_diff": d_loss, "first_grad_norm_rel": d_norm,
            "grads": grads, "steps": steps,
            "wall_s_per_step": ranks[0]["wall_s"] / MESH_STEPS,
            "one_wall_s_per_step": one["wall_s"] / MESH_STEPS,
            "comms_per_step": {k: {f: v / MESH_STEPS for f, v in c.items()}
                               for k, c in ranks[0]["comms"].items()},
            "peak_gb": [r["peak_gb"] for r in ranks],
            "one_peak_gb": one["peak_gb"]}
    return out, launches


def ckpt_blocks(path: str) -> dict:
    """A checkpoint's leaves reassembled from their blocks (numpy)."""
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    out = {}
    for key, e in man["arrays"].items():
        a = np.empty(e["shape"], e["dtype"])
        for s in e["shards"]:
            a[tuple(slice(x, y) for x, y in zip(s["start"], s["stop"]))] = \
                np.load(os.path.join(path, s["file"]))
        out[key] = a
    return out


def restore_one_process_bitwise(cfg, path: str) -> int:
    """The 2x2 save restored into one process's trainer on the card (the
    launcher's run config) equals its blocks bit for bit; returns the
    leaves compared."""
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.trainer import Trainer
    from repro_torch.weights import to_jax_opt_state, to_jax_params
    run = RunConfig(model=cfg, schedule=ScheduleConfig(
        kind="seesaw", base_lr=MESH_LR, alpha=2.0, beta=2.0, n_cuts=1),
        optimizer=OptimizerConfig(kind="adamw"), seq_len=1024,
        global_batch_size=8, total_tokens=8 * 1024 * 7)
    tr = Trainer(run, device="cuda")
    tr.restore_checkpoint(path, verify=True)
    got = CKPT._flat_state(to_jax_params(tr.state.model),
                           to_jax_opt_state(tr.state.model,
                                            tr.state.opt_state))
    want = ckpt_blocks(path)
    if got.keys() != want.keys():
        raise AssertionError("the restore holds other leaves")
    for k, w in want.items():
        if not np.array_equal(np.asarray(got[k]), w):
            raise AssertionError(f"{k}: the one-process restore is not the "
                                 f"2x2 save's blocks")
    del tr
    torch.cuda.empty_cache()
    return len(want)


def phase18b(tmp, cfg, ctr):
    """bf16 through the launcher: a 2x2 mesh alone for steps 1-4 and its
    save; then side by side the mesh resuming for 5-6, one process
    resuming the save and one process for the whole plan."""
    import shutil
    t0 = time.perf_counter()
    mesh = ["--mesh", "2x2"]
    ck22, ck1 = os.path.join(tmp, "mesh22"), os.path.join(tmp, "mesh_one")
    a = wait_ranks(launch_ranks(tmp, "mesh_a", 4, mesh + [
        "--steps", str(MESH_SAVE_STEP), "--checkpoint", ck22],
        args=MESH_ARGS))
    t_a = time.perf_counter()
    with open(os.path.join(ck22, "manifest.json")) as f:
        man = json.load(f)
    ck21 = os.path.join(tmp, "mesh22_to_one")
    shutil.copytree(ck22, ck21, copy_function=lambda x, y: (
        os.link(x, y) if x.endswith(".npy") else shutil.copy2(x, y)))
    procs = launch_ranks(tmp, "mesh_b", 4, mesh + [
        "--resume", "--checkpoint", ck22], args=MESH_ARGS)
    procs += launch_ranks(tmp, "mesh_one_b", 1, ["--resume", "--checkpoint",
                                                 ck21], args=MESH_ARGS)
    procs += launch_ranks(tmp, "mesh_one", 1, ["--checkpoint", ck1],
                          args=MESH_ARGS)
    res = wait_ranks(procs, timeout=600)
    b, one_b, one = res[:4], res[4], res[5]
    t_b = time.perf_counter()
    # the mesh's final save (step 6, 2x2) into one process
    leaves = restore_one_process_bitwise(cfg, ck22)
    want = one["history"]
    if len(want) != 6 or [h["batch_size"] for h in want] != [8] * 4 + \
            [16] * 2:
        raise AssertionError(f"one process: {[h['batch_size'] for h in want]}")
    rows = [[{k: v for k, v in h.items() if k != "wall"}
             for h in r["history"]] for r in a + b]
    if any(r != rows[0] for r in rows[:4]) or \
            any(r != rows[4] for r in rows[4:]):
        raise AssertionError("the ranks logged other runs")
    diffs = {"mesh": dp_check_run(a[0]["history"] + b[0]["history"], want,
                                  2e-2, "2x2 mesh"),
             "mesh_to_one": dp_check_run(one_b["history"],
                                         want[MESH_SAVE_STEP:], 2e-2,
                                         "2x2 -> 1 resume")}
    meta = man["meta"]
    blocks = [len(e["shards"]) for e in man["arrays"].values()]
    writers = sorted({s["writer"] for e in man["arrays"].values()
                      for s in e["shards"]})
    if meta["save_process_count"] != 4 or meta["step"] != MESH_SAVE_STEP \
            or max(blocks) != 4 or writers != [0, 1, 2, 3]:
        raise AssertionError(f"2x2 save: meta {meta}, blocks {blocks}, "
                             f"writers {writers}")
    per_micro = per_micro_batch(cfg, True)
    launches = {}
    for tag, recs, micro in (("mesh_steps_1_4", a, 4),
                             ("mesh_steps_5_6", b, 2),
                             ("one", [one], 4 + 2 * 2),
                             ("mesh_to_one_steps_5_6", [one_b], 2 * 2)):
        launches.update(check_rank_launches(recs, ctr, per_micro, micro,
                                            tag))
    comms = {}
    for kind in ("fsdp_gather", "grad_reduce", "model_all_reduce"):
        got = [re.search(kind + r": (\d+) calls, ([\d.]+) ms, ([\d.]+) MB",
                         r["stdout"]) for r in a]
        if not all(got):
            raise AssertionError(f"no {kind} line: "
                                 + a[0]["stdout"][-2000:])
        comms[kind] = {"calls": int(got[0].group(1)),
                       "ms": [float(m.group(2)) for m in got],
                       "MB": float(got[0].group(3))}

    def step_walls(hist):
        return [y["wall"] - x["wall"] for x, y in zip(hist, hist[1:])]

    return {
        "plan": {"batch_sizes": [8, 16], "steps": [4, 2],
                 "micro_batches_one": [1, 2],
                 "micro_batches_per_rank": [1, 1],
                 "save_step": MESH_SAVE_STEP},
        "step_walls_s": {"mesh_steps_1_4": step_walls(a[0]["history"]),
                         "mesh_steps_5_6": step_walls(b[0]["history"])},
        "wall_s": {"mesh_steps_1_4": [r["wall_s"] for r in a],
                   "mesh_steps_5_6": [r["wall_s"] for r in b],
                   "one": one["wall_s"], "mesh_to_one": one_b["wall_s"]},
        "phase_s": {"mesh_alone": t_a - t0, "side_by_side": t_b - t_a,
                    "restore_check": time.perf_counter() - t_b},
        "collectives_per_step_steps_1_4": comms,
        "peak_gb": {"mesh": [r["peak_gb"] for r in a + b],
                    "one": one["peak_gb"], "mesh_to_one": one_b["peak_gb"]},
        "checkpoint": {"leaves": len(blocks), "max_blocks": max(blocks),
                       "writers": writers, "restored_bitwise": leaves},
        "largest_differences": diffs, "launches": launches,
        "losses": {"one": [h["loss"] for h in want],
                   "mesh": [h["loss"] for h in a[0]["history"]
                            + b[0]["history"]]}}


def phase18(cfg, ctr, smi):
    """The model axis on the card: 18a and 18b (see the module doc).  The
    steps run eagerly: a gloo collective is host work no CUDA graph
    holds."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t = time.perf_counter()
        f32, launches = phase18a(tmp, ctr)
        t_a = time.perf_counter() - t
        bf16 = phase18b(tmp, cfg, ctr)
        launches.update(bf16.pop("launches"))
        return {"float32": f32, "bf16": bf16, "launches": launches,
                "phase_s": {"18a": t_a, "18b": time.perf_counter() - t -
                            t_a},
                "steps": "eager: a gloo collective is host work that no "
                         "CUDA graph holds; the four ranks share one card, "
                         "so no speed is claimed",
                "card": smi}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels run only on "
            "an NVIDIA card")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import overlap as OV
    from repro_torch.kernels import paged as PG
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import registry as R
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers as O
    from repro_torch import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    record["build_s"] = time.perf_counter() - t0
    record["ptxas"] = [ln for ln in lib.with_suffix(".ptxas.txt")
                       .read_text().splitlines()
                       if "registers" in ln or "spill" in ln]
    log(f"build: {record['build_s']:.1f} s")
    for ln in record["ptxas"]:
        log(f"  {ln.strip()}")
    record["compiled"] = compiled_report(_build, lib)
    log(f"compiled: {record['compiled']}")

    t = time.perf_counter()
    errors, inputs = phase1(RN, FA, PG, ref)
    times = measure(RN, FA, PG, ref, serving.cache, inputs)
    del inputs
    record["phase1"] = {"errors": errors, "times": times,
                        "s": time.perf_counter() - t}
    log(f"phase 1: {record['phase1']['s']:.1f} s")
    t = time.perf_counter()
    bwd_errors, inputs = phase1b(RN, FA, ref)
    bwd_times = measure_bwd(RN, FA, ref, inputs)
    del inputs
    torch.cuda.empty_cache()
    record["phase1b"] = {"errors": bwd_errors, "times": bwd_times,
                         "s": time.perf_counter() - t}
    log(f"phase 1b: {record['phase1b']['s']:.1f} s {bwd_times}")
    t = time.perf_counter()
    ssd_errors, ssd_f64, inputs = phase1c(SSD, RN, ref)
    ssd_times = measure_ssd(SSD, RN, ref, inputs)
    del inputs
    torch.cuda.empty_cache()
    record["phase1c"] = {"errors": ssd_errors, "vs_float64": ssd_f64,
                         "times": ssd_times, "s": time.perf_counter() - t}
    log(f"phase 1c: {record['phase1c']['s']:.1f} s {ssd_times}")
    t = time.perf_counter()
    ov_errors, ov_probes = phase1d(OV, ref)
    record["phase1d"] = {"errors": ov_errors, "probes": ov_probes,
                         "s": time.perf_counter() - t}
    log(f"phase 1d: {record['phase1d']['s']:.1f} s")
    OV.launches = 0         # phases 2-7 must not launch it

    cfg = get_config("seesaw-150m")
    t = time.perf_counter()
    eng, record["engine"] = phase2(cfg, R, serving, (RN, FA, PG))
    log(f"phase 2: {time.perf_counter() - t:.1f} s {record['engine']}")
    eng.reset()
    record["profile"] = profile_engine(cfg, eng, serving)
    del eng
    log(f"profile: {record['profile']}")
    t = time.perf_counter()
    record["card_vs_cpu"] = phase3(cfg, R, serving, transformer)
    log(f"phase 3: {time.perf_counter() - t:.1f} s {record['card_vs_cpu']}")
    t = time.perf_counter()
    tr, record["train"] = phase4(cfg, RN, FA)
    log(f"phase 4: {time.perf_counter() - t:.1f} s {record['train']}")
    hist4 = list(tr.history)
    final4 = clone_state(tr.state.model, tr.state.opt_state)
    record["train_profile"] = profile_train(
        tr, record["train"]["per_batch_size"]["8"]["wall_s_per_step"], 8,
        "profile_train.txt")
    log(f"train profile: {record['train_profile']}")
    t = time.perf_counter()
    record["checkpoint"], record["adaptive"] = phase10(
        cfg, RN, FA, tr, hist4, final4,
        record["train"]["launches_per_micro_batch"])
    record["checkpoint"]["s"] = time.perf_counter() - t
    log(f"phase 10: {record['checkpoint']['s']:.1f} s "
        f"{record['checkpoint']} {record['adaptive']}")
    del tr, final4
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["train_card_vs_cpu"] = phase5(cfg, R, O)
    log(f"phase 5: {time.perf_counter() - t:.1f} s "
        f"{record['train_card_vs_cpu']}")
    t = time.perf_counter()
    record["graphs_bitwise"] = phase9(cfg, R, serving)
    log(f"phase 9: {time.perf_counter() - t:.1f} s "
        f"{record['graphs_bitwise']}")
    torch.cuda.empty_cache()
    mcfg = get_config("mamba2-2.7b")
    t = time.perf_counter()
    tr, record["mamba2"] = phase6(mcfg, RN, FA, SSD)
    record["mamba2"]["s"] = time.perf_counter() - t
    log(f"phase 6: {record['mamba2']['s']:.1f} s {record['mamba2']}")
    record["mamba2_profile"] = profile_train(
        tr, record["mamba2"]["per_batch_size"]["4"]["wall_s_per_step"], 4,
        "profile_mamba2.txt")
    log(f"mamba2 profile: {record['mamba2_profile']}")
    del tr
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["mamba2_card_vs_cpu"] = phase7(R)
    log(f"phase 7: {time.perf_counter() - t:.1f} s "
        f"{record['mamba2_card_vs_cpu']}")
    if OV.launches:
        raise AssertionError(f"overlap_norm launched {OV.launches} times "
                             f"on the serving and training paths")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["mamba2_serve"] = phase11(mcfg, R, serving,
                                     serve_counters(RN, FA, PG, SSD, OV),
                                     smi)
    record["mamba2_serve"]["s"] = time.perf_counter() - t
    log(f"phase 11: {record['mamba2_serve']['s']:.1f} s "
        f"{record['mamba2_serve']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["mamba2_serve_card_vs_cpu"] = phase11b(R, serving)
    log(f"phase 11b: {time.perf_counter() - t:.1f} s "
        f"{record['mamba2_serve_card_vs_cpu']}")
    torch.cuda.empty_cache()
    from repro_torch.train.serve import Server
    ctr = serve_counters(RN, FA, PG, SSD, OV)
    t = time.perf_counter()
    record["server"] = {"seesaw": phase12a(cfg, R, serving, Server, ctr,
                                           smi)}
    torch.cuda.empty_cache()
    record["server"]["starcoder2"] = phase12b(get_config("starcoder2-3b"),
                                              R, Server, ctr, smi)
    torch.cuda.empty_cache()
    record["server"]["ring"] = phase12c(get_config("starcoder2-3b"), R,
                                        Server)
    record["server"]["s"] = time.perf_counter() - t
    log(f"phase 12: {record['server']['s']:.1f} s {record['server']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    hd32_errors, hd32_times = phase13a(FA, ref)
    record["paper"] = {"flash_hd32": {"errors": hd32_errors,
                                      "times": hd32_times}}
    log(f"phase 13a: {time.perf_counter() - t:.1f} s {hd32_times}")
    t13 = time.perf_counter()
    record["paper"]["benchmarks"] = phase13b(counters(RN, FA))
    record["paper"]["benchmarks"]["s"] = time.perf_counter() - t13
    log(f"phase 13b: {record['paper']['benchmarks']['s']:.1f} s "
        f"{record['paper']['benchmarks']['runs']} "
        f"{record['paper']['benchmarks']['figure1_card_vs_cpu']}")
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    record["paper"]["cbs"] = phase13c(cfg, counters(RN, FA))
    record["paper"]["cbs"]["s"] = time.perf_counter() - t13
    record["paper"]["s"] = time.perf_counter() - t
    log(f"phase 13: {record['paper']['s']:.1f} s")
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    hd32_dec_errors, hd32_dec_times = phase14a(PG, ref)
    record["moe"] = {"decode_hd32": {"errors": hd32_dec_errors,
                                     "times": hd32_dec_times}}
    log(f"phase 14a: {time.perf_counter() - t14:.1f} s")
    gcfg = get_config(MOE_ARCH)
    t = time.perf_counter()
    record["moe"]["train"] = phase14b(gcfg, R, RN, FA, smi)
    record["moe"]["train"]["s"] = time.perf_counter() - t
    log(f"phase 14b: {record['moe']['train']['s']:.1f} s "
        f"{record['moe']['train']['per_batch_size']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["moe"]["serve"] = phase14c(gcfg, R, serving, Server,
                                      (RN, FA, PG), smi)
    record["moe"]["serve"]["s"] = time.perf_counter() - t
    log(f"phase 14c: {record['moe']['serve']['s']:.1f} s "
        f"{record['moe']['serve']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["moe"]["benchmarks"] = phase14d(PG, smi)
    record["moe"]["benchmarks"]["s"] = time.perf_counter() - t
    record["moe"]["s"] = time.perf_counter() - t14
    log(f"phase 14d: {record['moe']['benchmarks']['s']:.1f} s; phase 14: "
        f"{record['moe']['s']:.1f} s")
    # phase 15 needs the card to itself: earlier trainers' graph pools go
    # once the cycles through their engines are collected
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.kernels import rglru as RG
    hctr = hybrid_counters(RN, FA, PG, SSD, OV, RG)
    t15 = time.perf_counter()
    h_errors, h_times = phase15a(RG, PG, RN, ref)
    record["hybrid"] = {"kernels": {"errors": h_errors, "times": h_times,
                                    "s": time.perf_counter() - t15}}
    log(f"phase 15a: {record['hybrid']['kernels']['s']:.1f} s")
    torch.cuda.empty_cache()
    hcfg = get_config(HYBRID_ARCH)
    t = time.perf_counter()
    record["hybrid"]["train"] = phase15b(hcfg, R, hctr, smi)
    record["hybrid"]["train"]["s"] = time.perf_counter() - t
    log(f"phase 15b: {record['hybrid']['train']['s']:.1f} s "
        f"{record['hybrid']['train']['per_batch_size']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["hybrid"]["serve"] = phase15c(hcfg, R, Server, hctr, smi)
    record["hybrid"]["serve"]["s"] = time.perf_counter() - t
    record["hybrid"]["s"] = time.perf_counter() - t15
    log(f"phase 15c: {record['hybrid']['serve']['s']:.1f} s "
        f"{record['hybrid']['serve']}; phase 15: "
        f"{record['hybrid']['s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    f_errors, f_times = phase16a(RN, FA, PG, ref)
    fam = record["families"] = {"kernels": {
        "errors": f_errors, "times": f_times,
        "s": time.perf_counter() - t16}}
    log(f"phase 16a: {fam['kernels']['s']:.1f} s")
    torch.cuda.empty_cache()
    for key, fn in (
            ("encdec_train", lambda: phase16b(get_config(ENCDEC_ARCH), R,
                                              counters(RN, FA), smi)),
            ("encdec_serve", lambda: phase16c(get_config(ENCDEC_ARCH), R,
                                              Server, hctr, smi)),
            ("vlm_serve", lambda: phase16d(get_config(VLM_ARCH), R, Server,
                                           hctr, smi)),
            ("nemo_serve", lambda: phase16e(get_config(NEMO_ARCH), R,
                                            serving, (RN, FA, PG), smi))):
        t = time.perf_counter()
        fam[key] = fn()
        fam[key]["s"] = time.perf_counter() - t
        log(f"phase 16 {key}: {fam[key]['s']:.1f} s {fam[key]}")
        gc.collect()
        torch.cuda.empty_cache()
    fam["s"] = time.perf_counter() - t16
    t = time.perf_counter()
    record["data_parallel"] = phase17(cfg, counters(RN, FA), smi)
    record["data_parallel"]["s"] = time.perf_counter() - t
    log(f"phase 17: {record['data_parallel']['s']:.1f} s "
        f"{record['data_parallel']}")
    t = time.perf_counter()
    record["mesh"] = phase18(cfg, counters(RN, FA), smi)
    record["mesh"]["s"] = time.perf_counter() - t
    log(f"phase 18: {record['mesh']['s']:.1f} s {record['mesh']}")
    t = time.perf_counter()
    bench_ctr = dict(counters(RN, FA), ssd_chunk=(SSD, "launches"),
                     overlap_norm=(OV, "launches"))
    record["bench_kernels"] = phase8(bench_ctr)
    record["bench_kernels"]["s"] = time.perf_counter() - t
    log(f"phase 8: {record['bench_kernels']['s']:.1f} s "
        f"{record['bench_kernels']['launches']} "
        f"{record['bench_kernels']['errors']}")

    launches = record["engine"]["launches"]
    train_launches = record["train"]["launches"]
    err_of = {(n, tag, dn): e
              for n, tag, dn, e in errors + bwd_errors + ssd_errors}
    kernels = []
    for name, mod, src, replaces, key, tag in (
            ("rmsnorm_fwd", "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:30", "rmsnorm_fwd/prefill",
             "prefill"),
            ("flash_fwd", "flash_attention",
             "src/repro_torch/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention.py:58", "flash_fwd",
             "seesaw"),
            ("ragged_decode", "paged", "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/paged.py:32", "ragged_decode", "seesaw")):
        tm = times[key]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[mod],
                 "max_abs_err": err_of[(name, tag, "bfloat16")],
                 "max_abs_err_f32": err_of[(name, tag, "float32")],
                 "ms": tm["ms"],
                 "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                 "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                 "host_us": tm["host_us"],
                 "library_host_us": tm["library_host_us"],
                 "shape": tm["shape"]}
        if name == "flash_fwd":
            tr = bwd_times["flash_fwd/train"]
            entry.update(train_shape_max_abs_err=err_of[
                             ("flash_fwd", "bwd-seesaw", "bfloat16")],
                         train_shape_max_abs_err_f32=err_of[
                             ("flash_fwd", "bwd-seesaw", "float32")],
                         train_shape_ms=tr["ms"],
                         train_shape_library_ms=tr["library_ms"],
                         train_shape_bound_ms=tr["bound_ms"],
                         train_shape=tr["shape"])
        if name == "ragged_decode":
            pg, ga = times["ragged_decode/paged"], times["gather_pages"]
            paged = [e for n, _, _, e in errors if n == "paged_decode"]
            entry.update(
                paged_ms=pg["ms"], paged_plain_ms=pg["plain_ms"],
                paged_bound_ms=pg["bound_ms"], paged_host_us=pg["host_us"],
                paged_max_abs_err=max(
                    e for n, _, dn, e in errors
                    if n == "paged_decode" and dn == "bfloat16"),
                paged_max_abs_err_f32=max(
                    e for n, _, dn, e in errors
                    if n == "paged_decode" and dn == "float32"),
                paged_cases=len(paged),
                paged_vs_gathered_max_abs_err=pg["max_abs_err_vs_gathered"],
                paged_shape=pg["shape"],
                **{f"{t}_{f}": times[f"ragged_decode/{t}"][f]
                   for t in ("one_split", "full_window")
                   for f in ("ms", "bound_ms", "library_ms")},
                gather_pages_ms=ga["ms"],
                gather_pages_bound_ms=ga["bound_ms"],
                gather_pages_shape=ga["shape"])
        if name == "rmsnorm_fwd":
            dec = times["rmsnorm_fwd/decode"]
            tr = bwd_times["rmsnorm_fwd/train"]
            entry.update(graph_us=tm["graph_us"],
                         library_graph_us=tm["library_graph_us"],
                         decode_rows_ms=dec["ms"],
                         decode_rows_graph_us=dec["graph_us"],
                         decode_rows_bound_ms=dec["bound_ms"],
                         decode_rows_library_ms=dec["library_ms"],
                         decode_rows_library_graph_us=dec[
                             "library_graph_us"],
                         train_shape_max_abs_err=err_of[
                             ("rmsnorm_fwd", "train", "bfloat16")],
                         train_shape_max_abs_err_f32=err_of[
                             ("rmsnorm_fwd", "train", "float32")],
                         train_shape_ms=tr["ms"],
                         train_shape_graph_us=tr["graph_us"],
                         train_shape_plain_ms=tr["plain_ms"],
                         train_shape_bound_ms=tr["bound_ms"],
                         train_shape_library_ms=tr["library_ms"],
                         train_shape_library_graph_us=tr[
                             "library_graph_us"],
                         train_shape=tr["shape"],
                         prefill_buckets={
                             n: {f: times[f"rmsnorm_fwd/bucket{n}"][f]
                                 for f in ("ms", "graph_us", "bound_ms",
                                           "library_ms",
                                           "library_graph_us")}
                             for n in PREFILL_BUCKETS})
        if name in train_launches:
            entry["train_launches"] = train_launches[name]
        if name == "flash_fwd":
            entry["compiled"] = {k: v for k, v in record["compiled"].items()
                                 if k.startswith("flash_fwd")}
        kernels.append(entry)
    for name, src, replaces, tag in (
            ("rmsnorm_bwd", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:38", "train"),
            ("flash_bwd_dq", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/kernels/flash_attention.py:161", "seesaw"),
            ("flash_bwd_dkv", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/kernels/flash_attention.py:200", "seesaw")):
        tm = bwd_times[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": train_launches[name],
                 "max_abs_err": err_of[(name, tag, "bfloat16")],
                 "max_abs_err_f32": err_of[(name, tag, "float32")],
                 "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                 "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                 "library_ms": tm["library_ms"], "host_us": tm["host_us"],
                 "shape": tm["shape"]}
        if name == "rmsnorm_bwd":
            entry["dscale_rel_err"] = err_of[("rmsnorm_bwd/dscale_rel",
                                              tag, "bfloat16")]
            entry["dscale_rel_err_f32"] = err_of[("rmsnorm_bwd/dscale_rel",
                                                  tag, "float32")]
            entry["few_rows_max_abs_err"] = err_of[("rmsnorm_bwd",
                                                    "few-rows", "bfloat16")]
            entry["compiled"] = {k: v for k, v in record["compiled"].items()
                                 if k.startswith(name)}
        else:
            entry["plain_and_library_compute"] = "dq, dk and dv together"
            entry["flash_bwd_ms"] = bwd_times["flash_bwd"]["ms"]
            entry["compiled"] = {k: v for k, v in record["compiled"].items()
                                 if k.startswith(name)}
        kernels.append(entry)
    tm = ssd_times["ssd_chunk"]
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd.py:28",
        "launches": record["mamba2"]["launches"]["ssd_chunk"],
        "max_abs_err": err_of[("ssd_chunk", "2.7b", "bfloat16")],
        "max_abs_err_f32": err_of[("ssd_chunk", "2.7b", "float32")],
        "max_abs_err_small_decay": err_of[("ssd_chunk", "ragged",
                                           "bfloat16")],
        "vs_float64": [r for r in ssd_f64 if r["shape"] == "2.7b"],
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None, "library_note": tm["library_note"],
        "tflops": tm["tflops"], "host_us": tm["host_us"],
        "shape": tm["shape"],
        "serving_launches": record["mamba2_serve"]["launches"]["ssd_chunk"],
        "prefill_shapes": {
            S: {**{f: r[f] for f in ("ms", "graph_us", "plain_ms",
                                     "bound_ms", "bound_by", "shape")},
                "max_abs_err": err_of[("ssd_chunk", f"prefill-S{S}",
                                       "bfloat16")],
                "max_abs_err_f32": err_of[("ssd_chunk", f"prefill-S{S}",
                                           "float32")]}
            for S, r in ssd_times["ssd_chunk/prefill"].items()},
        "compiled": {k: v for k, v in record["compiled"].items()
                     if k.startswith("ssd_chunk")}})
    server = record["server"]
    for k in kernels:
        if k["name"] in ("rmsnorm_fwd", "flash_fwd", "ragged_decode"):
            k["server_launches"] = {
                "seesaw": server["seesaw"]["launches"][k["name"]],
                **{f"starcoder2_{t}": b["launches"][k["name"]]
                   for t, b in server["starcoder2"]["batches"].items()}}
        if k["name"] == "ragged_decode":
            tm = times["ragged_decode/starcoder2"]
            k["starcoder2_ring"] = {f: tm[f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "shape")}
        if k["name"] == "rmsnorm_fwd":
            k["d3072"] = {
                tag: {**{f: times[f"rmsnorm_fwd/{tag}"][f] for f in (
                          "ms", "graph_us", "plain_ms", "library_ms",
                          "library_graph_us", "bound_ms", "bound_by",
                          "shape")},
                      "max_abs_err": err_of[("rmsnorm_fwd", tag,
                                             "bfloat16")]}
                for tag in ("llama", "starcoder2-decode")}
            k["mamba2_serving_launches"] = \
                record["mamba2_serve"]["launches"]["rmsnorm_fwd"]
            for d in (2560, 5120):
                tm = ssd_times[f"rmsnorm_fwd/mamba2-decode-d{d}"]
                k[f"mamba2_decode_d{d}"] = {
                    **{f: tm[f] for f in ("ms", "graph_us", "plain_ms",
                                          "library_ms", "library_graph_us",
                                          "bound_ms", "bound_by")},
                    "max_abs_err": err_of[("rmsnorm_fwd",
                                           f"mamba2-decode-d{d}",
                                           "bfloat16")]}
        if k["name"] in ("rmsnorm_fwd", "rmsnorm_bwd"):
            k["mamba2_launches"] = record["mamba2"]["launches"][k["name"]]
            for d in (2560, 5120):
                tm = ssd_times[f"{k['name']}/mamba2-d{d}"]
                k[f"mamba2_d{d}"] = {
                    "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                    "library_ms": tm["library_ms"],
                    **{f: tm[f] for f in ("graph_us", "library_graph_us")
                       if f in tm},
                    "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                    "max_abs_err": err_of[(k["name"], f"mamba2-d{d}",
                                           "bfloat16")],
                    "max_abs_err_f32": err_of[(k["name"], f"mamba2-d{d}",
                                               "float32")]}
    ov = record["bench_kernels"]["overlap"]
    best = ov["best"]
    kernels.append({
        "name": "overlap_norm", "route": "cuda",
        "source": "src/repro_torch/csrc/overlap.cu",
        "replaces": "benchmarks/bench_kernels.py:187",
        "launches": record["bench_kernels"]["launches"]["overlap_norm"],
        "max_abs_err": max(c["max_err"] for c in ov["configs"]
                           if "ms" in c),
        "max_abs_err_f32": max(e for n, d, b, k, e in ov_errors
                               if e is not None and (n, d) == (8192, 512)),
        "ms": best["ms"], "depth1_ms": ov["depth1_ms"],
        "block_rows": best["block_rows"], "depth": best["buffer_depth"],
        "plain_ms": ov["plain_ms"], "bound_ms": ov["bound_ms"],
        "bound_by": ov["bound_by"], "library_ms": ov["library_ms"],
        **ov_probes,
        "skipped_over_budget": record["bench_kernels"]["skipped"],
        "serving_and_training_launches": 0,
        "shape": f"x ({ov['rows']}, {ov['d']}) float32, the kernel "
                 f"benchmark's path (phase 8)"})
    # phase 13: the flash kernels at hd 32, launched by the figure LMs
    paper = record["paper"]
    err13 = {(n, tag, dn): e for n, tag, dn, e in hd32_errors}
    for name, key, src, replaces in (
            ("flash_fwd", "fwd", "src/repro_torch/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention.py:58"),
            ("flash_bwd_dq", "dq", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/kernels/flash_attention.py:161"),
            ("flash_bwd_dkv", "dkv", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/kernels/flash_attention.py:200")):
        tm, tm8 = hd32_times["fig-B128"][key], hd32_times["fig-B8"][key]
        kernels.append({
            "name": f"{name}/hd32", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(r["launches"][name]
                            for r in paper["benchmarks"]["runs"]),
            "max_abs_err": err13[(name, "hd32-fig-B128", "bfloat16")],
            "max_abs_err_f32": err13[(name, "hd32-fig-B128", "float32")],
            "max_abs_err_all_shapes": {
                dn: max(e for n, _, d, e in hd32_errors
                        if n == name and d == dn)
                for dn in ("bfloat16", "float32")},
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"], "shape": tm["shape"],
            "b8": {f: tm8[f] for f in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "shape")},
            "launches_by_run": {f"{r['model']} {r['kind']}":
                                r["launches"][name]
                                for r in paper["benchmarks"]["runs"]}})
    for k in kernels:
        if k["name"] in counters(RN, FA):
            k["paper_cbs_launches"] = {
                kind: r["launches"][k["name"]]
                for kind, r in paper["cbs"]["runs"].items()}
    # phase 14: granite's launches, and the ragged decode at hd 32
    moe = record["moe"]
    for k in kernels:
        if k["name"] in moe["train"]["launches"]:
            k["granite_train_launches"] = moe["train"]["launches"][k["name"]]
        mod = {"rmsnorm_fwd": "rmsnorm", "flash_fwd": "flash_attention",
               "ragged_decode": "paged"}.get(k["name"])
        if mod:
            k["granite_serve_launches"] = moe["serve"]["launches"][mod]
    err14 = {(n, tag, dn): e for n, tag, dn, e in hd32_dec_errors}
    tm, tm2 = hd32_dec_times["serve-lm"], hd32_dec_times["mha-1024"]
    kernels.append({
        "name": "ragged_decode/hd32", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged.py:32",
        "launches": moe["benchmarks"]["serve"][
            "ragged_decode_hd32_launches"],
        "max_abs_err": err14[("ragged_decode", "hd32-serve-lm",
                              "bfloat16")],
        "max_abs_err_f32": err14[("ragged_decode", "hd32-serve-lm",
                                  "float32")],
        "max_abs_err_all_cases": {
            dn: max(e for _, _, d, e in hd32_dec_errors if d == dn)
            for dn in ("bfloat16", "float32")},
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"], "shape": tm["shape"],
        "window1024": {f: tm2[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "shape")},
        "launches_by": "bench.serve (phase 14d): its engine's decode "
                       "steps and its Server baseline's"})
    hybrid_kernel_entries(kernels, record)
    phase16_kernel_entries(kernels, record)
    # phase 17: each launcher process's launches of the training kernels
    for k in kernels:
        if k["name"] in counters(RN, FA):
            k["data_parallel_launches"] = {
                tag: c[k["name"]] for tag, c in
                record["data_parallel"]["launches"].items()}
            k["mesh_launches"] = {
                tag: c[k["name"]] for tag, c in
                record["mesh"]["launches"].items()}
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": record["engine"],
                      "card_vs_cpu": record["card_vs_cpu"]}))
    long = ("losses", "lrs", "chunks", "grad_norms")
    train = {k: v for k, v in record["train"].items() if k not in long}
    print(json.dumps({"train": train, "profile": record["train_profile"],
                      "card_vs_cpu": record["train_card_vs_cpu"],
                      "graphs_bitwise": record["graphs_bitwise"],
                      "mesh_steps": record["mesh"]["steps"]}))
    mamba2 = {k: v for k, v in record["mamba2"].items() if k not in long}
    print(json.dumps({"mamba2": mamba2,
                      "profile": record["mamba2_profile"],
                      "card_vs_cpu": record["mamba2_card_vs_cpu"]}))
    print(json.dumps({"mamba2_serve": record["mamba2_serve"],
                      "card_vs_cpu": record["mamba2_serve_card_vs_cpu"]}))
    print(json.dumps({"server": record["server"]}))
    adaptive = {k: v for k, v in record["adaptive"].items()
                if k not in ("losses", "lrs")}
    cbs = dict(paper["cbs"], runs={
        kind: {k: v for k, v in r.items() if k != "chunks"}
        for kind, r in paper["cbs"]["runs"].items()})
    print(json.dumps({"paper": {
        "benchmarks": paper["benchmarks"], "cbs": cbs,
        "flash_hd32_errors": hd32_errors, "s": paper["s"], "card": smi}}))
    mtrain = {k: v for k, v in moe["train"].items()
              if k not in ("losses", "lrs", "chunks", "grad_norms")}
    mbench = {n: {"rows": b["rows"], "s": b["s"]}
              for n, b in moe["benchmarks"].items()
              if isinstance(b, dict) and "rows" in b}
    print(json.dumps({"moe": {
        "train": mtrain, "serve": moe["serve"], "benchmarks": mbench,
        "serve_decode": moe["benchmarks"]["serve_decode"],
        "hd32_decode_errors": hd32_dec_errors, "s": moe["s"],
        "card": smi}}))
    hyb = record["hybrid"]
    htrain = {k: v for k, v in hyb["train"].items()
              if k not in ("losses", "lrs", "chunks", "grad_norms")}
    print(json.dumps({"hybrid": {
        "train": htrain, "losses": hyb["train"]["losses"],
        "serve": hyb["serve"], "kernel_errors": h_errors, "s": hyb["s"],
        "card": smi}}))
    etrain = {k: v for k, v in fam["encdec_train"].items()
              if k not in ("grad_norms", "lrs")}
    print(json.dumps({"families": {
        "encdec_train": etrain, "encdec_serve": fam["encdec_serve"],
        "vlm_serve": fam["vlm_serve"], "nemo_serve": fam["nemo_serve"],
        "kernel_errors": f_errors, "s": fam["s"], "card": smi}}))
    print(json.dumps({"data_parallel": {
        k: v for k, v in record["data_parallel"].items()
        if k not in ("losses", "launches")}}))
    print(json.dumps({"mesh": {
        k: v for k, v in record["mesh"].items() if k != "launches"}}))
    print(json.dumps({"checkpoint": record["checkpoint"],
                      "adaptive": adaptive, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
