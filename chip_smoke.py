#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: its main paths end to end on one
NVIDIA GPU — the micro interpreter (single, batched and ragged
dispatch), dense-LM serving (contiguous, paged and quantized),
recurrent-state serving (Mamba-2, Zamba2, float and quantized), MoE
serving (DeepSeek-MoE-16B, Qwen3-MoE-30B-A3B), PaliGemma and Whisper,
the overlapped decode loop, the multi-tenant host, the replica router,
the streaming server, the profiler, the calibration cost model,
training, mesh-sharded serving and mesh-sharded training — with every
CUDA kernel of those paths held against its plain PyTorch version.

Run from the root of a checkout (needs one CUDA card and nvcc):

    python3 chip_smoke.py

Phases — any failure raises and the script exits non-zero:

  1. the card's name and power limit, torch and CUDA versions; nvcc
     builds every kernel from ``src/repro_torch/kernels/csrc`` (timed,
     one nvcc per source, all at once); K1's (each path), K2's, K3's,
     K5's, K6's and K8's (each of its three kernels) registers a thread
     and shared memory a block at their path shapes
     (``cudaFuncGetAttributes``).
  2. each kernel against its plain version on the card: K1 quant_matmul
     at the interpreter's FC shapes and two larger ones (outputs equal
     exactly, with the weight both as a (K, N) tensor and as the
     transposed view of an (N, K) one that the FC layer passes; the path
     each layout took, and at M = 1 the tiled path's time beside it), K2
     flash_attention causal, non-causal, GQA, sliding window (float32
     within 1e-5) and bfloat16, K3 decode_attention at Yi-6B's and
     Phi-3-mini's decode shapes with lengths 1, 37, 1500 and 2048 (a
     full ring), a window, a cache length off the kernel's 128-position
     run (float32 within 1e-5, bfloat16 within ``BF16_ATOL``), and at
     Yi-6B's shape also with the cache out of L2 (each call on the next
     of 16 copies, beside SDPA on the same copies), K4
     paged_decode_attention at Yi-6B's paged decode shape (pool of 513
     blocks of 16, a permuted table, unmapped tails on block 0, the same
     lengths) and with float32, a window, blocks of 8 and 64, Phi-3-mini's
     heads, each also bit-equal to K3 on the equal contiguous cache; K5
     dequant_matmul and K6 dequant_matmul_i4 at Yi-6B's MLP shapes at 4
     slots and at 1 and at two shapes off the tiles (float32 within
     1e-5 of the largest output; a row's values independent of the
     other rows; two calls bit-equal), at 4 slots also with the weight
     out of L2 (each call on the next of enough copies to hold 150 MB,
     beside the bf16 cuBLAS product on copies of the float weight), K7 paged_decode_attention_q at K4's cases on int8
     pools with row scales (float32 within 1e-5, bfloat16 within
     ``BF16_ATOL``, and bit-equal to K4 on the float32 pools that hold
     float(q8) * s); kernel, plain and library times from CUDA events
     (K4: K3's time on the equal cache, and a gather + SDPA as two
     calls; K5: ``torch._weight_int8pack_mm`` where it runs, and the
     bf16 cuBLAS product on the float weight; K7: K4 on the bf16 pool,
     and a gather + dequant + SDPA chain), and the card's least
     possible time (the bound).  K8 ssd_scan at Mamba2-780m's prefill
     shapes (512 and 128 tokens, bf16, without and with an initial
     state), Zamba2-1.2B's heads and N 64, float32, groups of 2 with D,
     192 tokens with the wrapper's chunk of 64, and a padded tail of dt =
     0 rows (an exact no-op on the state), against ``ssd_scan_ref``
     within atol 5e-4 / rtol 1e-3 (bf16 y: one bf16 ulp besides); two
     bounds, the least operations on the CUDA cores in float32 and on
     the tensor cores in bf16; no single library call computes the
     scan.  K3 and K4 in the forms a 2-rank mesh runs them
     (``check_sharded_decode_attention``): Yi-6B's cache, bf16 and f32,
     split into the halves of its rows (K3) or of every 16-row block of
     the permuted table (K4, blocks of 8), each half with its clamped
     lengths (row counts) and ``return_lse``: each half against its plain
     version, a half with no valid row 0 and -inf, the merged halves
     against the unsplit kernel (f32 within 1e-5, bf16 within
     ``BF16_ATOL``), the lse launch's output bit-equal to the
     argument-free one's; and both timed at a rank's ``heads`` share
     (4, 16, 2, 2048, 128) and half rows, beside the plain version, the
     bound and SDPA.
  Each main path (phases 3-4, 7, 9, 10 (a)-(c), 12, 13, 14, 15-24) runs
  inside ``main_path``: every launch count set to 0 just before it, the
  device traced by torch.profiler over it, and after it each kernel's
  launches counted in the trace (by the device function one launch of
  its wrapper runs) must equal its wrapper's count; the traced counts
  are the ones checked and printed.  Every program runs replayed from
  its CUDA graph unless a phase says eager (``disable_capture()``).

  3. the micro main path: ``MicroInterpreter(..., AllOpsResolver(tags=("cuda",
     "reference")), device="cuda")`` answers 8 requests on each of
     conv_reference, hotword and vww (float) and conv_reference, vww and
     fc_stack (int8), all at full width and exported by the port's own
     exporter from seeded weights; every output is held against the same
     blob on a CPU ``("reference",)`` interpreter.
  4. still on the micro path: a one-op ATTENTION graph (q, k, v of
     (2, 4, 256, 64), causal) through the interpreter on the card.
     The launch counts are read after it and must match the ops served.
  5. after the counts are read, untraced: every model's requests again
     replayed (the median invoke) and eagerly, each bit-equal to phase
     3's outputs, one program per model; torch.profiler over 3 more
     invokes per model gives the device time by kernel and the device's
     busy share.
  6. Yi-6B at full width in float32 (24.3 GB, TF32 off for matmuls and
     cuDNN): 4 seeded prompts prefilled, then 16 teacher-forced decode
     steps through ``lm_decode`` with K3 and with its plain version,
     both fed the plain run's greedy tokens; logits agree within
     1e-4 · max |logit| at every step.
  7. the serving main path, bfloat16, counts set to 0 just before it:
     ``ServingEngine(get_model(yi-6b), ..., max_slots=4, cache_len=2048,
     tags=("cuda", "reference"), device="cuda")`` answers 8 seeded
     requests (prompts of 16–512 tokens, 32 new tokens each).  K3's
     launches equal 32 layers × the decode steps; the cache keeps its
     addresses, device memory after every step is its value after the
     first plus at most ``NEW_PROGRAM_BYTES`` a program captured since,
     the arena's persistent bytes do not change; programs: decode 1,
     prefill one per bucket hit.  Then the same requests again untraced
     (the timed run): the same tokens, no capture, memory flat.  Then
     torch.profiler over pure decode steps (busy share, top device
     operations), and an EDF run in which a tight-deadline request
     displaces a decoding one: both emit exactly their tokens of the
     uninterrupted run; the same requests through a fresh engine under
     ``disable_capture()`` give the same tokens and the eager medians.
     Each prompt's bucketed prefill against its exact-length one: K/V
     at layer 0 within one bfloat16 ulp of each row's largest entry,
     the worst layer reported (phase 15's drift on a dense model).
  8. Yi-6B reduced, float32: the engine on the card and on the CPU emit
     identical greedy tokens, contiguous and with ``kv_block=8,
     prefill_chunk=8`` (also equal to the contiguous engine's), and
     quantized: int8 weights and KV contiguous, int4 weights and int8 KV
     with ``kv_block=8``; Mamba2-780m and Zamba2-1.2B reduced, float32:
     card (K8) and CPU (plain scan) tokens identical, exact and with
     ``prefill_chunk=8``.
  9. the paged serving main path, counts set to 0 just before it: the
     phase-7 model and requests through ``ServingEngine(...,
     kv_block=16)``.  Tokens equal phase 7's request for request; K4's
     launches equal 32 layers × the decode steps and K3's are 0; the
     pool and block table keep their addresses, device memory after
     every step equals its value after the first, every block comes
     back.  Then the profile (busy share), EDF displacement on the paged
     engine (the checkpoint carries block ids, the tokens are the
     uninterrupted run's), a pool of two full-length slots under the
     admission gate (same tokens), and ``prefill_chunk=128`` on the
     paged engine: every request finishes, and the longest prompt's K/V
     rows after chunked prefill agree with one-shot prefill's at layer 0
     within one bfloat16 ulp of each row's largest entry.
  10. the quantized serving main path: Yi-6B at full width with 8 of its
     32 layers (``QUANT_LAYERS``), quantized on the card by the engine,
     and the phase-7 requests, counts set to 0 just before each run,
     through (a) ``weight_dtype="int8",
     kv_dtype="int8"`` contiguous (K5 launched 3 x 32 times a decode
     step, K3 32 times over the dequantized cache), (b) the same with
     ``kv_block=16`` (K7 32 times a step, K3 and K4 never; tokens equal
     (a)'s) and (c) ``weight_dtype="int4"`` paged (K6); each run keeps
     its cache in place and device memory flat, every block comes back,
     the resident weights are at least 1.9x (int8) and 3.6x (int4)
     smaller than bf16 and the KV 1.9x; the profile of each (with K5's
     or K6's mean device time a launch inside the step); the bytes of
     the engine's one graph pool beside those of a pool for each program
     (the same requests again, captured anew); an EDF
     displacement on (b) emits (b)'s tokens; the largest |logit|
     difference from the bf16 engine over 16 teacher-forced steps, for
     (a) within 0.25 of the largest |logit| (``INT8_VS_BF16_RTOL``), for
     int4 reported; and how many greedy tokens equal the bf16 engine's
     on the same 16 layers.
  11. Mamba2-780m at full width in float32 (3.1 GB): 4 seeded prompts
     (512, 128, 77 and 384 tokens) through ``ssm_prefill`` with the scan
     on K8 and on the plain ``ssd_chunked``: conv windows, SSD states and
     logits within 1e-4 of the largest entry; 16 teacher-forced decode
     steps from each state, the same bound; the chunked prefill (chunks
     of 128 from an empty cache, K8 with the carried state as h0, a
     padded final chunk) gives the one-shot cache within it.
  12. the recurrent serving main path, bfloat16, counts set to 0 just
     before each run, at full width with ``RECURRENT_LAYERS`` (24 of
     Mamba2-780m's 48, 18 of Zamba2-1.2B's 38):
     ``ServingEngine(get_model(mamba2-780m), ...,
     max_slots=4, cache_len=2048, device="cuda")`` serves (a) 8 seeded
     requests one-shot (prompts less one of 64-128, 256, 384 or 512
     tokens) and (b) 8 with ``prefill_chunk=128`` (100-600 tokens), 32
     new tokens each: K8 launched 24 x (one-shot prefills + chunk steps)
     and nothing else, the cache in place, memory flat; torch.profiler
     over decode steps and over a 512-token prefill (with K8's device
     time a launch inside it); an EDF displacement on (a) emits the
     uninterrupted tokens.  Then Zamba2-1.2B the same
     way with 4 requests a run (K8 18 x per prefill or chunk).
  13. every micro op on the card, counts set to 0 just before: one
     decoder block at Yi-6B's published widths (d 4096, 32 query heads
     of 128, 4 KV heads repeated to 32 by CONCATENATION, d_ff 11008, rope
     base 5e6, vocab 64000; 1.7 GB of seeded float32 consts) over 256
     tokens — EMBEDDING_LOOKUP, RMS_NORM, MATMUL, RESHAPE, ROPE,
     TRANSPOSE, ATTENTION on K2 at (1, 32, 256, 128) causal, ADD, SILU,
     MUL — and the op-coverage graph at VWW's 96x96 input
     (``repro_torch.apps.graphs``), float (every other new opcode,
     IDENTITY and DROPOUT kept) and int8 (every quantizable one, its FC on
     K1); 4 seeded requests each against the same blob on the CPU: float
     within ``GRAPH_RTOL`` of each output's largest entry, int8 within
     ``INT8_ATOL``.  Then, untraced, phase 5's pass: replays bit-equal to
     eager, the medians, one program each, the device time.
  14. ragged micro dispatch, counts set to 0 just before the waves: one
     ``RaggedInterpreterPool`` of four 16-lane buckets under the
     ``("cuda", "reference")`` tags — fc_stack int8 (K1 at M = 16),
     conv_reference int8, hotword float with each lowering (exact and
     lane-stacked) — over 12 waves whose occupancy cycles 0.25, 0.5,
     0.75, 1.0 (the reference benchmark's, benchmarks/ragged_invoke.py),
     requests of 1-4 streamed frames admitted and retired between waves,
     a hotword lane of each lowering snapshotted, retired and restored
     into another lane.  Every int8 and exact lane bit-equal to its
     request alone through a ``MicroInterpreter`` on the card, the other
     float lanes within ``RAGGED_FLOAT_ATOL``; one masked program and one
     capture per bucket through every admission and retirement; device
     memory the same after every wave from the second on (the first
     still holds its eager warm-up's outputs); K1's launches equal the
     waves' int8 FC ops.  Then, untraced, the per-request us of a wave at each
     occupancy against a request alone.
  15. MoE serving, counts set to 0 just before each run:
     DeepSeek-MoE-16B at full width with 10 of its 28 layers
     (``MOE_LAYERS``) in bfloat16, seeded on the card, 5 requests of
     16-512 tokens, 16 new:
     (a) contiguous (K3 28 x the decode steps), replays bit-equal to an
     eager engine; (b) bucketed: one prefill program per bucket hit, its
     prefill K/V within one bf16 ulp of (a)'s at layer 0 (a bf16 GEMM
     rounds by its shape, so later layers and tokens may drift; both
     counted), and the first MoE layer's block fed each prompt's rows
     unpadded and padded to its bucket (masked dispatch): the same
     dispatch ids, outputs within 4 bf16 ulps of each row's max; (c)
     paged with ``kv_block=16`` (K4) with (a)'s tokens, and an EDF
     displacement on it emits them too; (d) int8 weights and KV, paged
     (K5 3 x a step on the dense first block's MLP, K7 28 x); (e) int4
     weights (K6, K7); for each, the served weights layer by layer on
     one prompt's rows: the first block's MLP on K5/K6 within 2 bf16
     ulps of its plain version, it and the first MoE block (experts
     dequantized) within a relative 0.05 (int8) / 0.5 (int4) of bf16;
     teacher-forced logits against the bf16 engine and the plain
     versions reported (over 28 routed layers any rounding flips
     routing: (a) on K3 against the plain versions is reported too);
     and DeepSeek reduced in float32, int8 and int4 paged: card tokens
     equal the CPU's.  Then Qwen3-MoE-30B-A3B at full width with 4 of
     its 48 layers: contiguous and bucketed on K3 (4 x a step),
     compared as (a) and (b).
  16. PaliGemma-3B at full width, 9 of its 18 layers (``VLM_LAYERS``),
     in bfloat16 with seeded patch
     embeddings: bucketed, ``prefill_chunk=128``, paged and int8 KV; no
     kernel launched on any run (vlm keeps reference attention, as in
     the JAX package); paged emits the bucketed tokens; chunked prefill
     against one-shot, K/V at layer 0 within one bf16 ulp of each row's
     max; int8 KV against bf16, teacher-forced logits within 0.25 of the
     largest |logit|, its tokens counted.
  17. Whisper-large-v3 at full width, 16 of its 32 encoder and 32
     decoder layers (``AUDIO_LAYERS``), in bfloat16 with seeded frames:
     exact, replays bit-equal to eager, and checkpointed (an EDF
     displacement, the checkpoint carrying the cross K/V) with the
     uninterrupted tokens; no kernel launched.
  18. Mamba2-780m and Zamba2-1.2B at full width and phase 12's depth
     (``RECURRENT_LAYERS``), int8 and int4 weights:
     K8 once per Mamba layer per prefill and nothing else; a float engine
     on the dequantized weights emits the same tokens.
  19. Yi-6B (phase 7's weights, drawn again from its seed) with
     ``overlap=True``, contiguous (K3) and paged with ``kv_block=16``
     (K4): phase 7's tokens, request for request; every uid's
     StreamEvents in order, each once, one final; one decode and one
     argmax program; a forced evict after a drain, then the restore,
     emits no duplicate and drops no token.  Then, in turns on warm
     engines, the median tick (host clock around ``step()``) sync and
     overlapped, and each one's device ms per step and busy share.
  20. one ``MultiTenantHost`` arena: Yi-6B (``overlap=True``), a ragged
     fc_stack int8 tenant (K1, 16 lanes) and the streaming hotword
     (exact), through ``run_all`` 3 times: phase 7's tokens, every micro
     output bit-equal to its request alone through a ``MicroInterpreter``
     on the card, the arena's usage the tenants' persistents stacked with
     the largest scratch, device memory flat from the second run on; K1
     launched once per int8 FC op per fc wave; then an EDF lane
     preemption on a host of its own restores bit-identically.
  21. two Yi-6B replicas sharing the weight module, each with its own KV
     (``add_replicated_model``, ``overlap=True``), 12 requests under
     round-robin, least-loaded and locality (swapped in mid-serve):
     one sync engine's tokens each time, no new capture, no uid lost or
     duplicated.
  22. a ``StreamingServer`` over an overlapped engine, phase 7's requests
     submitted from the main thread and consumed by a thread each:
     phase 7's tokens, programs captured on the loop thread; on the warm
     engine each request's TTFT and inter-token latency (mean, median,
     max), the loop's median and longest ticks and the cyclic
     collector's pauses, and ``shutdown()`` ends an unfinished stream
     with an error.
  23. ``MicroProfiler`` on vww int8 and fc_stack int8 (``"cuda"`` tags):
     per-op µs, the bottleneck (a convolution on vww), the per-op sum
     against the replayed invoke, K1 launched per FC op per call; and
     ``measure_compile_and_step`` on a fresh Yi-6B decode program: the
     first call (eager run and capture) against a replay.
  24. the calibration cost model: (a) Yi-6B (phase 7's weights) at 4
     slots x 2048, calibrated untraced through the real programs on 64
     prompt lengths (phase 7's 8 among them) with chunks (0, 128, 256),
     decode slots (1, 2, 4), paged blocks (8, 16, 32, 64), precisions
     fp32/fp32, int8/int8, int4/int8, fc_stack int8 lanes (1, 2, 4, 8,
     16) and replicas (1, 2) at a target that needs two: every
     candidate's compile (eager run + capture) and step, the solved
     configuration against the default table's expected time, the
     calibration's seconds, peak memory and counted launches (K1, K3,
     K4, K5, K6); the profile saved to the port's cache and loaded back
     equal.  (b) ``ServingEngine.from_profile`` serves the 64 prompts (8
     new tokens) as a main path: tokens bit-equal to an engine configured
     by hand with the same table, chunk and block; prefill programs =
     ``predicted_compiles``, a chunk program exactly when a request was
     chunked; K3 (K4 with a solved ``kv_block``) traced = counted; memory
     flat on the second pass; phase 7's layer-0 K/V check; tokens equal
     to phase 7's counted; the median decode tick and the summed prefill
     ms beside the default engine's.  A ``MultiTenantHost(profile=)``
     with two Yi-6B tenants (sharing the profile's table and chunk) and
     fc_stack int8 at the profile's lane width serves through ``run_all``
     as a main path: the from-profile engine's tokens, micro outputs
     bit-equal to each request alone, K1 and K3 traced = counted.  (c)
     Mamba2-780m calibrated at full width on levels inside the one-shot
     contract and chunks (0, 128), then served from its profile: K8
     traced = counted, tokens bit-equal to the hand-configured engine.
     (d) the profile from (a) makes ``from_profile`` on a CPU engine
     raise, and a CPU profile (reduced Yi-6B) does on the card.
  25. training: Yi-6B at full width with 8 of its 32 layers, bfloat16
     (1.92 B parameters), seeded weights, on ``PackedLMDataset`` seed 0.
     (a) 30 steps of 4 x 2048 tokens through ``make_train_step`` (remat,
     a cosine schedule, one ``CapturedProgram``), the last 4 traced as a
     main path (no kernel may launch): the loss falls by at least 0.5 and
     stays finite, one capture, device memory flat from the second step;
     median replayed step, tokens/s, MFU (PaLM's count over 989 TFLOP/s),
     device ms a step, busy share and the top device records, peak
     memory, losses and gradient norms.  (b) Run first: the first 3 steps
     under ``disable_capture()`` from the same weights, their losses
     within 1e-3 and the parameters within 2 x the summed lr + one bf16
     ulp of the leaf's largest entry of the captured run's (the share
     bit-equal printed).  (c) The final TrainState saved with
     ``save_checkpoint`` under ``build/`` and restored onto the card,
     every leaf bit-equal; bytes and seconds.  (d) The restored weights
     served (main path, K3 traced = counted) with the trained weights'
     tokens; the share of greedy tokens that are Markov successors and a
     held-out batch's loss, trained and untrained.  (e) Every family
     reduced in float32, 3 train steps on the card and on the CPU, the
     card's state set to the CPU's before each (``FAMILY_ARCHS``'
     tolerances).
  26. mesh-sharded serving (``mesh_serving``), with the earlier phases'
     models freed: (a) Yi-6B at full width and depth in bfloat16 on
     ``make_serving_mesh(1)``, a world of one rank over NCCL in this
     process whose collectives are captured in the programs, as a main
     path: phase 7's requests give phase 7's tokens, K3 traced = counted
     = 32 x the decode steps, the programs as on one device, the NCCL
     kernels' device time; (b) two ranks, one process each
     (``chip_smoke.py --mesh-rank R ...``): NCCL a card a rank where the
     machine shows two cards, else gloo with both on the one card,
     eager (gloo stages CUDA tensors through the host, which a graph
     cannot record); the backend and card count printed.  Float32:
     full widths (``MESH_MODELS``): Yi-6B at full depth contiguous (K3)
     and paged (K4) in ``heads``/``kv_heads`` mode, and, cut in depth
     for time, Mamba2-780m with 24 of its 48 layers
     one-shot and ``prefill_chunk=128`` on 24 of its 48 SSD heads a rank
     (K8), PaliGemma-3B with 9 of its 18 layers in ``heads``/``sequence``
     mode (its one KV head's rows halved; reference attention, its head
     dim of 256 above K3's), and DeepSeek-MoE-16B with 4 of its 28
     layers (32 experts a rank): each
     rank's greedy tokens, through a forced evict and restore, equal the
     same model's single-device engine's in this process; each rank's
     decode-step median, collective time in a trace, peak memory and
     resident weight and KV bytes against the single device's.
  27. mesh-sharded training (``mesh_training``), with the earlier
     phases' models freed: (a) a world of two ranks, this process rank 0
     and a ``chip_smoke.py --mesh-rank 1 ... --mesh-task parity`` process
     rank 1 (NCCL a card a rank where two cards show, else gloo with
     both on the one card, eager; the backend and card count printed):
     Yi-6B at full width with 2 layers, DeepSeek-MoE-16B at full width
     with its dense block and one MoE layer (capacity factor 11,
     dropless on the expert-parallel path) and Whisper-large-v3 at full
     width with 2 + 2 layers, float32, on ``(data=2, model=1)`` (FSDP)
     and ``(1, 2)`` (tensor parallel, and sequence parallel but for
     Whisper; the MoE layer through ``moe_block_ep``), and Whisper with 5
     heads of 256 on ``(1, 2)``, where the heads do not divide and the
     decoder's attention splits K/V by sequence and merges (the merges
     counted; no other case merges); 3 steps of 2 x 512 tokens (Whisper
     2 x (1,500 frames, 448 tokens)) from
     the seed-0 weights: every rank runs the same model's single-device
     loss and gradients on its card and sets its slices to that model's
     before each sharded step; every rank's loss within 1e-5 relative
     and its slice of each leaf of the gradient the step applied (read
     back from the first moment) within 1e-4 of the leaf's largest
     entry; no kernel launched; Yi-6B's world checkpoint on ``(2, 1)``,
     written whole by rank 0, restored on every card bit-equal to the
     state's slices.  (b) Where two cards show: phase 25's
     configuration (Yi-6B 8 layers bf16, 4 x 2048 tokens, phase 25's
     schedule and clip) and Whisper with 8 + 8 of its 32 + 32 layers,
     bf16, 4 x (1,500 frames, 448 tokens), on ``(2, 1)`` and ``(1, 2)``,
     one process a card over NCCL, captured, 10 steps, the last 2
     traced: the median step a rank, tokens/s, NCCL device ms a step,
     peak memory a rank, the loss falling (Yi-6B's logged beside phase
     25's first ten; Whisper's steps beside one card's, run first in
     this process).  (c) Where four cards show: Yi-6B at full depth
     (which one card cannot hold for training), FSDP over ``(4, 1)``,
     and Whisper at full depth on ``(2, 2)``, 5 steps each: finite,
     falling loss, the median step, NCCL ms and the peak a rank.
  Each of phases 15-27 logs its seconds and its peak device memory
  (15-18 also their replayed and eager decode step medians).
  Phase 2 also holds K1 at (16, 64, 32), its rows path at phase 14's M,
  K2 at (1, 32, 256, 128) causal float32, phase 13's shape, and phase
  15's new shapes: K3, K4 and K7 at DeepSeek's (4, 16, 16, 2048, 128)
  bf16 (group 1), K5 and K6 at its first block's MLP, (4, 2048) x
  (2048, 10944) and (4, 10944) x (10944, 2048).
  A JSON line of phases 15-27's summaries, one of the models, one
  listing the kernels (K1-K8; K1's and K2's launches summed over phases
  3-4, 13 and 14, with each path's count; K3-K8 with their launches on
  phases 15, 18, 19-24's, 25 (d)'s and 26's runs; K3's and K4's rows
  with their sharded forms), then the last line
  ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_REQUESTS = 8
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12       # dense int8 tensor cores
H100_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12        # dense bf16 tensor cores
# float models on the card vs the CPU: float32 sums in another order
FLOAT_ATOL = 1e-5
# int8 models: the kernel's f32-scale requant may differ from gemmlowp's
# fixed point by one output LSB (1/256 on the probabilities)
INT8_ATOL = 1.5 / 256
# bfloat16 attention: one rounding of the f32 result to bfloat16, one ulp
# for outputs below 4 in magnitude
BF16_ATOL = 2.0 ** -6
# copies of K3's path-shape cache for its cold-L2 time: 16 x 7.3 MB of
# valid rows pass through the 50 MB L2 between two uses of one copy
COLD_COPIES = 16
# K5's and K6's cold-L2 times rotate weight copies of at least this many
# bytes in all (the 45.1 MB int8 weight 4 times, the 22.5 MB int4 one 7)
COLD_BYTES = 150e6


T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def phase(msg: str) -> None:
    log(f"{msg}  [{time.perf_counter() - T0:.0f} s]")


def time_ms(torch, fn, calls: int = 20, reps: int = 10):
    """(device ms per call, ms per call run eagerly back to back).

    The device time replays a CUDA graph of ``calls`` captured calls, so
    host dispatch is left out; the eager time is what a Python caller
    pays per call, launch overhead included.  Both from CUDA events,
    after a warm-up (operands stay in L2, as they do between invokes)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls * reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / (calls * reps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps), eager


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(least time in ms, what bounds it) on the H100."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _times(row) -> str:
    lib = row["library_ms"]
    return (f"kernel {row['ms'] * 1e3:.2f} us (per call "
            f"{row['call_ms'] * 1e3:.2f})  plain "
            f"{row['plain_ms'] * 1e3:.2f} us  library "
            f"{'-' if lib is None else f'{lib * 1e3:.2f} us'}  bound "
            f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']})")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_quant_matmul(torch, np, dev):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quant_matmul as K1
    from repro_torch.kernels.quant_matmul import quant_matmul_cuda

    rng = np.random.default_rng(11)
    # (M, K, N): vww, fc_stack x3, conv_reference FC layers; a larger
    # block; a ragged large shape; fc_stack's first layer over the 16
    # lanes of a ragged bucket (phase 14)
    shapes = [(1, 256, 2), (1, 64, 32), (1, 32, 32), (1, 32, 8), (1, 16, 10),
              (64, 128, 96), (300, 1000, 520), (16, 64, 32)]
    rows = []
    for m, k, n in shapes:
        x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
        bias = torch.from_numpy(rng.integers(-4000, 4000, n, dtype=np.int32))
        scale = torch.from_numpy(rng.uniform(1e-4, 4e-3, n)
                                 .astype(np.float32))
        x_zp, out_zp = (int(v) for v in rng.integers(-128, 128, 2))
        x, w, bias, scale = (t.to(dev) for t in (x, w, bias, scale))
        wsum = w.sum(dim=0, dtype=torch.int32)
        # the FC layer's weight is (N, K); it reaches the kernel as the
        # transposed view: the rows path at M <= 16, above it the tiled
        # kernel's other load branch
        w_nk_t = w.t().contiguous().t()
        want = ref.quant_matmul_ref(x, w, bias, x_zp, scale, out_zp)
        err = 0
        for layout, wl in (("(K,N)", w), ("(N,K).T", w_nk_t)):
            got = ops.quant_matmul(x, wl, bias, x_zp, scale, out_zp)
            torch.cuda.synchronize()
            err = max(err, (got.int() - want.int()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {m}x{k}x{n} weight {layout}: kernel "
                                     f"differs from the plain version by up "
                                     f"to {err}")
        # the kernels line's time is the FC layer's layout, the path's
        row = {"shape": [m, k, n], "max_abs_err": err, "library_ms": None,
               "weight": "(N,K).T", "path": K1.path(m, k, w_nk_t.stride()),
               "path_weight_kn": K1.path(m, k, w.stride())}
        row["ms"], row["call_ms"] = time_ms(torch, lambda: quant_matmul_cuda(
            x, w_nk_t, bias, wsum, scale, x_zp=x_zp, out_zp=out_zp))
        row["ms_weight_kn"], _ = time_ms(torch, lambda: quant_matmul_cuda(
            x, w, bias, wsum, scale, x_zp=x_zp, out_zp=out_zp))
        if row["path"] != "tiles":      # the tiled path on the same call
            tiled, _ = K1._quant_matmul(x, w_nk_t, bias, wsum, scale, x_zp,
                                        out_zp, "tiles")
            if not torch.equal(tiled, want):
                raise AssertionError(f"K1 {m}x{k}x{n} tiled path differs")
            row["tiles_ms"], _ = time_ms(torch, lambda: K1._quant_matmul(
                x, w_nk_t, bias, wsum, scale, x_zp, out_zp, "tiles"))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.quant_matmul_ref(x, w, bias, x_zp, scale,
                                                out_zp))
        row["bound_ms"], row["bound_by"] = bound(
            m * k + k * n + 12 * n + m * n, 2 * m * n * k,
            H100_INT8_OPS_PER_S)
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            # no single torch call computes K1; the yardstick is the int8
            # GEMM torch._int_mm plus a torch requant epilogue
            wc = w.t().contiguous().t()

            def library():
                acc = torch._int_mm(x, wc) - x_zp * wsum + bias
                out = torch.round(acc.float() * scale) + out_zp
                return out.clamp(-128, 127).to(torch.int8)
            if not torch.equal(library(), want):
                raise AssertionError(f"K1 yardstick {m}x{k}x{n} disagrees")
            row["library_ms"], _ = time_ms(torch, library)
            row["library"] = "torch._int_mm + torch epilogue"
        rows.append(row)
        tiles = (f"; the tiled path {row['tiles_ms'] * 1e3:.2f} us"
                 if "tiles_ms" in row else "")
        log(f"  K1 {m:>4}x{k:<5}x{n:<4} equal in both weight layouts; "
            f"(N,K).T weight, path {row['path']}: " + _times(row)
            + f"  (K,N) weight, path {row['path_weight_kn']}: "
            f"{row['ms_weight_kn'] * 1e3:.2f} us" + tiles)
    return rows


def _valid_pairs(s, causal, window):
    pairs = 0
    for i in range(s):
        lo = 0 if window is None else max(0, i - window + 1)
        hi = i if causal else s - 1
        pairs += max(0, hi - lo + 1)
    return pairs


def check_flash_attention(torch, np, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cpu").manual_seed(5)
    # (b, h, kh, s, d, causal, window, dtype); the first is the path's,
    # the last phase 13's decoder block at Yi-6B's heads
    cases = [(2, 4, 4, 256, 64, True, None, torch.float32),
             (2, 4, 4, 256, 64, False, None, torch.float32),
             (1, 8, 2, 256, 64, True, None, torch.float32),
             (2, 4, 4, 256, 64, True, 64, torch.float32),
             (2, 4, 4, 256, 64, True, None, torch.bfloat16),
             (1, 32, 32, 256, 128, True, None, torch.float32)]
    rows = []
    for b, h, kh, s, d, causal, window, dt in cases:
        q = torch.randn(b, h, s, d, generator=g).to(dev, dt)
        k = torch.randn(b, kh, s, d, generator=g).to(dev, dt)
        v = torch.randn(b, kh, s, d, generator=g).to(dev, dt)
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.mha_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dt == torch.float32 else BF16_ATOL
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"K2 {(b, h, kh, s, d, causal, window, dt)}"
                                 f": max abs err {err} > {tol}")
        item = q.element_size()
        row = {"shape": [b, h, kh, s, d], "causal": causal, "window": window,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "library_ms": None}
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: flash_attention_cuda(q, k, v, **kw))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.mha_ref(q, k, v, **kw))
        row["bound_ms"], row["bound_by"] = bound(
            item * (2 * b * h * s * d + 2 * b * kh * s * d),
            4 * b * h * d * _valid_pairs(s, causal, window),
            H100_F32_OPS_PER_S if dt == torch.float32
            else H100_BF16_OPS_PER_S)
        # the yardstick: one SDPA call, with GQA through enable_gqa and a
        # window through a boolean mask made once, outside the timing
        lib_kw = {"enable_gqa": True} if h != kh else {}
        if window is None:
            lib_kw["is_causal"] = causal
        else:
            i = torch.arange(s, device=dev)
            mask = i[None, :] > i[:, None] - window
            if causal:
                mask &= i[None, :] <= i[:, None]
            lib_kw["attn_mask"] = mask

        def library():
            return F.scaled_dot_product_attention(q, k, v, **lib_kw)
        lib_err = (library().float() - want.float()).abs().max().item()
        if lib_err > 10 * tol:
            raise AssertionError(f"K2 yardstick disagrees by {lib_err}")
        row["library_ms"], _ = time_ms(torch, library)
        row["library"] = ("torch.nn.functional.scaled_dot_product_attention"
                          + "".join(f" {key}" for key in lib_kw))
        rows.append(row)
        log(f"  K2 {(b, h, kh, s, d)} causal={causal} window={window} "
            f"{row['dtype']}: err {err:.3g}; " + _times(row))
    return rows


def _decode_valid_rows(lengths, s, window):
    """Cache positions each row attends: p < length and, with a window,
    p >= length - window."""
    rows = 0
    for n in lengths:
        lo = 0 if window is None else max(0, n - window)
        rows += max(0, min(n, s) - lo)
    return rows


def check_decode_attention(torch, np, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    g = torch.Generator(device="cpu").manual_seed(3)
    # (b, h, kh, s, d, window, dtype); the first is the serving path's:
    # Yi-6B's decode step at 4 slots of 2048 positions in bfloat16
    cases = [(4, 32, 4, 2048, 128, None, torch.bfloat16),
             (4, 32, 4, 2048, 128, None, torch.float32),
             (4, 32, 32, 2048, 96, None, torch.float32),
             (4, 32, 32, 2048, 96, None, torch.bfloat16),
             (4, 32, 4, 2048, 128, 256, torch.float32),
             (4, 32, 4, 2000, 128, None, torch.float32),
             # DeepSeek-MoE-16B's decode step (phase 15): group 1, D 128
             (4, 16, 16, 2048, 128, None, torch.bfloat16)]
    rows = []
    for b, h, kh, s, d, window, dt in cases:
        q = torch.randn(b, h, d, generator=g).to(dev, dt)
        k = torch.randn(b, kh, s, d, generator=g).to(dev, dt)
        v = torch.randn(b, kh, s, d, generator=g).to(dev, dt)
        # one entry, a short row, a long one, and a full (wrapped) ring
        lens = [1, 37, 1500, s]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, k, v, lengths, window=window)
        want = ref.decode_attention_ref(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dt == torch.float32 else BF16_ATOL
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"K3 {(b, h, kh, s, d, window, dt)}: max "
                                 f"abs err {err} > {tol}")
        item = q.element_size()
        valid = _decode_valid_rows(lens, s, window)
        row = {"shape": [b, h, kh, s, d], "lengths": lens, "window": window,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err}
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: decode_attention_cuda(q, k, v, lengths,
                                                 window=window))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.decode_attention_ref(q, k, v, lengths,
                                                    window=window))
        # bytes: q and out once, the valid K and V rows once, lengths
        row["bound_ms"], row["bound_by"] = bound(
            item * (2 * b * h * d + 2 * valid * kh * d) + 4 * b,
            4 * h * d * valid,
            H100_F32_OPS_PER_S if dt == torch.float32
            else H100_BF16_OPS_PER_S)
        # the yardstick: one SDPA call over the whole cache with a
        # boolean mask of the valid positions (made once, outside the
        # timing) and GQA through enable_gqa
        pos = torch.arange(s, device=dev)[None, :]
        mask = pos < lengths[:, None]
        if window is not None:
            mask &= pos >= lengths[:, None] - window
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library()[:, :, 0].float() - want.float()).abs().max()
        if lib_err.item() > 10 * tol:
            raise AssertionError(f"K3 yardstick disagrees by {lib_err}")
        row["library_ms"], _ = time_ms(torch, library)
        row["library"] = ("torch.nn.functional.scaled_dot_product_attention"
                          " attn_mask enable_gqa")
        cold = ""
        if not rows:
            # the serving path's shape: on the decode path each layer's
            # cache is read once a step, so it is not in L2.  Each call
            # of the captured graph reads the next of COLD_COPIES copies.
            copies = [(k.clone(), v.clone()) for _ in range(COLD_COPIES)]
            kernel = itertools.cycle([functools.partial(
                decode_attention_cuda, q, kc, vc, lengths, window=window)
                for kc, vc in copies])
            sdpa = itertools.cycle([functools.partial(
                F.scaled_dot_product_attention, q4, kc, vc, attn_mask=mask,
                enable_gqa=True) for kc, vc in copies])
            row["cold_ms"], _ = time_ms(torch, lambda: next(kernel)(),
                                        calls=COLD_COPIES)
            row["library_cold_ms"], _ = time_ms(torch, lambda: next(sdpa)(),
                                                calls=COLD_COPIES)
            del copies, kernel, sdpa
            cold = (f"  cold L2: kernel {row['cold_ms'] * 1e3:.2f} us, "
                    f"library {row['library_cold_ms'] * 1e3:.2f} us")
        rows.append(row)
        log(f"  K3 {(b, h, kh, s, d)} window={window} {row['dtype']}: "
            f"err {err:.3g}; " + _times(row) + cold)
    return rows


def _paged_layout(torch, dev, dt, b, kh, s, bs, d, lens, seed):
    """A contiguous (B,KH,S,D) cache and the same rows in a pool of
    B·S/BS + 1 blocks under a permuted table: row i maps the blocks its
    length reaches, its tail entries stay on block 0; the pool's other
    blocks hold unrelated values."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = s // bs
    n_blocks = b * t + 1
    k_pool, v_pool = (torch.randn(n_blocks, kh, bs, d, generator=g)
                      .to(dev, dt) for _ in range(2))
    ids = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros(b, t, dtype=torch.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            tables[i, j] = ids.pop()
    tables = tables.to(dev)
    idx = tables.long()
    k = k_pool[idx].transpose(1, 2).reshape(b, kh, s, d).contiguous()
    v = v_pool[idx].transpose(1, 2).reshape(b, kh, s, d).contiguous()
    return k_pool, v_pool, tables, k, v


def check_paged_decode_attention(torch, np, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda

    g = torch.Generator(device="cpu").manual_seed(4)
    # (b, h, kh, t, bs, d, window, dtype); the first is the paged serving
    # path's: Yi-6B's decode step at 4 slots of 128 blocks of 16 in bf16
    cases = [(4, 32, 4, 128, 16, 128, None, torch.bfloat16),
             (4, 32, 4, 128, 16, 128, None, torch.float32),
             (4, 32, 4, 128, 16, 128, 256, torch.float32),
             (4, 32, 4, 256, 8, 128, None, torch.bfloat16),
             (4, 32, 4, 32, 64, 128, None, torch.bfloat16),
             (4, 32, 32, 128, 16, 96, None, torch.float32),
             (4, 32, 32, 128, 16, 96, None, torch.bfloat16),
             # DeepSeek-MoE-16B's paged decode step (phase 15)
             (4, 16, 16, 128, 16, 128, None, torch.bfloat16)]
    rows = []
    for b, h, kh, t, bs, d, window, dt in cases:
        s = t * bs
        lens = [1, 37, 1500, s]
        k_pool, v_pool, tables, k, v = _paged_layout(
            torch, dev, dt, b, kh, s, bs, d, lens, seed=t + bs + d)
        q = torch.randn(b, h, d, generator=g).to(dev, dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                         window=window)
        want = ref.paged_decode_attention_ref(q, k_pool, v_pool, tables,
                                              lengths, window=window)
        k3 = decode_attention_cuda(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dt == torch.float32 else BF16_ATOL
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"K4 {(b, h, kh, t, bs, d, window, dt)}: "
                                 f"max abs err {err} > {tol}")
        if not torch.equal(got, k3):
            raise AssertionError(f"K4 {(b, h, kh, t, bs, d, window, dt)} "
                                 f"differs from K3 on the equal cache")
        item = q.element_size()
        valid = _decode_valid_rows(lens, s, window)
        # the table entries the valid rows reach
        blocks = sum(-(-min(n, s) // bs) for n in lens)
        row = {"shape": [b, h, kh, t, bs, d], "pool_blocks": b * t + 1,
               "lengths": lens, "window": window,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "equals_k3": True, "library_ms": None,
               "library": "none: no single PyTorch call walks a block table"}
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: paged_decode_attention_cuda(
                q, k_pool, v_pool, tables, lengths, window=window))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.paged_decode_attention_ref(
                q, k_pool, v_pool, tables, lengths, window=window))
        row["k3_ms"], _ = time_ms(torch, lambda: decode_attention_cuda(
            q, k, v, lengths, window=window))
        # bytes: q and out once, the valid K and V rows once, lengths,
        # and the table entries those rows need
        row["bound_ms"], row["bound_by"] = bound(
            item * (2 * b * h * d + 2 * valid * kh * d) + 4 * b + 4 * blocks,
            4 * h * d * valid,
            H100_F32_OPS_PER_S if dt == torch.float32
            else H100_BF16_OPS_PER_S)
        # two calls, for scale only: gather the table's blocks, then one
        # SDPA over the gathered cache (bool mask, GQA through enable_gqa)
        pos = torch.arange(s, device=dev)[None, :]
        mask = pos < lengths[:, None]
        if window is not None:
            mask &= pos >= lengths[:, None] - window
        mask = mask[:, None, None, :]
        idx = tables.long()

        def gather_sdpa():
            kc = k_pool[idx].transpose(1, 2).reshape(b, kh, s, d)
            vc = v_pool[idx].transpose(1, 2).reshape(b, kh, s, d)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=True)
        lib_err = (gather_sdpa()[:, :, 0].float() - want.float()).abs().max()
        if lib_err.item() > 10 * tol:
            raise AssertionError(f"K4 gather + SDPA disagrees by {lib_err}")
        row["gather_sdpa_ms"], _ = time_ms(torch, gather_sdpa)
        rows.append(row)
        log(f"  K4 {(b, h, kh, t, bs, d)} window={window} {row['dtype']}: "
            f"err {err:.3g}, equal to K3; " + _times(row)
            + f"  K3 {row['k3_ms'] * 1e3:.2f} us  gather+SDPA (two calls) "
            f"{row['gather_sdpa_ms'] * 1e3:.2f} us")
    return rows


# a rank's share of Yi-6B's decode step on a 2-rank mesh
SPLIT_RANKS = 2


def _merge_partials(torch, outs, lses):
    """Partial attentions over disjoint rows with their log-sum-exp,
    merged as the ranks merge them (``Comm.combine``), in float32."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.max(dim=0).values)
    num = (torch.stack(outs).float() * w[..., None]).sum(dim=0)
    return num / w.sum(dim=0)[..., None]


def _split_row(torch, label, shape, lens, dt, kernel, plain, library, nbytes,
               ops):
    """One sharded-form timing row: the kernel (with its log-sum-exp, as
    a rank's step launches it), its plain version, the library call and
    the bound, at a rank's shape."""
    row = {"shape": shape, "lengths": lens, "window": None, "form": label,
           "dtype": str(dt).replace("torch.", ""), "max_abs_err": 0.0}
    row["ms"], row["call_ms"] = time_ms(torch, kernel)
    row["plain_ms"], row["plain_call_ms"] = time_ms(torch, plain)
    row["library_ms"] = None if library is None else time_ms(torch,
                                                             library)[0]
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, ops, H100_F32_OPS_PER_S if dt == torch.float32
        else H100_BF16_OPS_PER_S)
    return row


def check_sharded_decode_attention(torch, np, dev):
    """K3 and K4 in the forms a 2-rank mesh runs them, on Yi-6B's cache
    (4, 32, 4, 2048, 128), bf16 and f32, lengths 1, 37, 1500, 2048:
    K3 on each half of the rows with its clamped lengths, K4 on each half
    of every 16-row block of phase 2's permuted table (blocks of 8) with
    its row counts, both with ``return_lse``.  Each half's output and
    log-sum-exp against its plain version, a half with no valid row 0
    and -inf, the halves merged against the unsplit kernel (f32 within
    1e-5, bf16 within ``BF16_ATOL``), and the lse launch's output
    bit-equal to the argument-free launch's.  Then each timed at a
    rank's shapes: the ``heads`` share (4, 16, 2, 2048, 128) and the
    half rows (4, 32, 4, 1024, 128), beside the plain version, the bound
    and SDPA on the same inputs (K4: no single call walks a table).
    Returns (K3's rows, K4's rows)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda

    b, h, kh, s, bs, d = 4, 32, 4, 2048, PAGED_BLOCK, 128
    m, t = SPLIT_RANKS, s // PAGED_BLOCK
    lens = [1, 37, 1500, s]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    g = torch.Generator(device="cpu").manual_seed(26)
    k3_rows, k4_rows, split_err = [], [], {}
    for dt in (torch.bfloat16, torch.float32):
        tol = 1e-5 if dt == torch.float32 else BF16_ATOL
        q = torch.randn(b, h, d, generator=g).to(dev, dt)
        k_pool, v_pool, tables, k, v = _paged_layout(
            torch, dev, dt, b, kh, s, bs, d, lens, seed=26)
        forms = {}
        c = s // m
        forms["K3"] = (
            decode_attention_cuda(q, k, v, lengths),
            [(decode_attention_cuda, ref.decode_attention_ref,
              (q, k[:, :, r * c:(r + 1) * c].contiguous(),
               v[:, :, r * c:(r + 1) * c].contiguous(),
               torch.clamp(lengths - r * c, 0, c).to(torch.int32)))
             for r in range(m)])
        held = bs // m
        forms["K4"] = (
            paged_decode_attention_cuda(q, k_pool, v_pool, tables, lengths),
            [(paged_decode_attention_cuda, ref.paged_decode_attention_ref,
              (q, k_pool[:, :, r * held:(r + 1) * held].contiguous(),
               v_pool[:, :, r * held:(r + 1) * held].contiguous(), tables,
               ((lengths // bs) * held + torch.clamp(
                   lengths % bs - r * held, 0, held)).to(torch.int32)))
             for r in range(m)])
        for name, (whole, parts) in forms.items():
            outs, lses, errs = [], [], []
            for r, (kern, plain, args) in enumerate(parts):
                out, lse = kern(*args, return_lse=True)
                bare = kern(*args)
                want, want_lse = plain(*args, return_lse=True)
                torch.cuda.synchronize()
                n = args[-1]
                if not torch.equal(out, bare):
                    raise AssertionError(f"{name} half {r} {dt}: the lse "
                                         f"launch's output differs")
                errs.append((out.float() - want.float()).abs().max().item())
                lse_err = (lse - want_lse)[n > 0].abs().max().item()
                none = n == 0
                if errs[-1] > tol or lse_err > 1e-4 or not (
                        torch.equal(out[none], torch.zeros_like(out[none]))
                        and torch.isneginf(lse[none]).all()):
                    raise AssertionError(
                        f"{name} half {r} {dt}: err {errs[-1]}, lse err "
                        f"{lse_err}, empty rows {none.tolist()}")
                outs.append(out)
                lses.append(lse)
            merged = _merge_partials(torch, outs, lses)
            err = (merged - whole.float()).abs().max().item()
            if err > tol:
                raise AssertionError(f"{name} {dt}: the merged halves differ "
                                     f"from the unsplit kernel by {err}")
            split_err[name] = max(errs + [err])
            log(f"  {name} {str(dt)[6:]} split over {m} ranks' rows: halves "
                f"within {max(errs):.3g} of their plain versions (lse within "
                f"1e-4, empty halves 0 and -inf), merged within {err:.3g} "
                f"of the unsplit kernel")
        if dt != torch.bfloat16:
            continue
        item = q.element_size()
        # the rank's shapes: its heads (heads/kv_heads) and its half rows
        hq, hk = q[:, :h // m].contiguous(), k[:, :kh // m].contiguous()
        hv = v[:, :kh // m].contiguous()
        _, _, half_args = forms["K3"][1][0]
        _, _, paged_args = forms["K4"][1][0]
        hpool = [x[:, :kh // m].contiguous() for x in (k_pool, v_pool)]
        pos = torch.arange(s, device=dev)[None, :]
        mask = (pos < lengths[:, None])[:, None, None, :]
        hmask = (torch.arange(c, device=dev)[None, :]
                 < half_args[3][:, None])[:, None, None, :]
        n_half = half_args[3].tolist()
        valid, valid_half = sum(min(n, s) for n in lens), sum(n_half)
        k3_rows.append(_split_row(
            torch, "mesh heads share", [b, h // m, kh // m, s, d], lens, dt,
            lambda: decode_attention_cuda(hq, hk, hv, lengths,
                                          return_lse=True),
            lambda: ref.decode_attention_ref(hq, hk, hv, lengths,
                                             return_lse=True),
            lambda: F.scaled_dot_product_attention(
                hq[:, :, None], hk, hv, attn_mask=mask, enable_gqa=True),
            item * (2 * b * h // m * d + 2 * valid * kh // m * d) + 4 * b
            + 4 * b * h // m, 4 * h // m * d * valid))
        k3_rows.append(_split_row(
            torch, "mesh half rows", [b, h, kh, c, d], n_half, dt,
            lambda: decode_attention_cuda(*half_args, return_lse=True),
            lambda: ref.decode_attention_ref(*half_args, return_lse=True),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], half_args[1], half_args[2], attn_mask=hmask,
                enable_gqa=True),
            item * (2 * b * h * d + 2 * valid_half * kh * d) + 4 * b
            + 4 * b * h, 4 * h * d * valid_half))
        n_paged = paged_args[4].tolist()
        k4_rows.append(_split_row(
            torch, "mesh heads share", [b, h // m, kh // m, t, bs, d], lens,
            dt, lambda: paged_decode_attention_cuda(
                hq, *hpool, tables, lengths, return_lse=True),
            lambda: ref.paged_decode_attention_ref(
                hq, *hpool, tables, lengths, return_lse=True), None,
            item * (2 * b * h // m * d + 2 * valid * kh // m * d) + 4 * b
            + 4 * b * h // m + 4 * sum(-(-n // bs) for n in lens),
            4 * h // m * d * valid))
        k4_rows.append(_split_row(
            torch, "mesh half rows of each block", [b, h, kh, t, held, d],
            n_paged, dt,
            lambda: paged_decode_attention_cuda(*paged_args,
                                                return_lse=True),
            lambda: ref.paged_decode_attention_ref(*paged_args,
                                                   return_lse=True), None,
            item * (2 * b * h * d + 2 * sum(n_paged) * kh * d) + 4 * b
            + 4 * b * h + 4 * sum(-(-n // held) for n in n_paged),
            4 * h * d * sum(n_paged)))
        for name, row in (("K3", k3_rows[-2]), ("K3", k3_rows[-1]),
                          ("K4", k4_rows[-2]), ("K4", k4_rows[-1])):
            # the bf16 halves' and merge's largest error (checked above)
            row["max_abs_err"] = split_err[name]
            row["library"] = ("none: no single PyTorch call walks a block "
                              "table" if row["library_ms"] is None else
                              "torch.nn.functional.scaled_dot_product_"
                              "attention attn_mask enable_gqa")
            log(f"  {name} {row['form']} {tuple(row['shape'])} "
                f"{row['dtype']}: " + _times(row))
    return k3_rows, k4_rows


def cold_time_ms(torch, w, fn):
    """(device ms per call of ``fn`` on a weight out of L2, copies): each
    call of the captured graph reads the next of enough copies of ``w``
    to hold ``COLD_BYTES``."""
    n = max(2, -(-int(COLD_BYTES) // (w.numel() * w.element_size())))
    calls = itertools.cycle([functools.partial(fn, w.clone())
                             for _ in range(n)])
    ms, _ = time_ms(torch, lambda: next(calls)(), calls=n)
    return ms, n


def check_dequant_matmul(torch, np, dev):
    """K5 and K6 against their plain versions: Yi-6B's MLP shapes at 4
    decode slots (wi/wg, then wo) and at one, and two shapes off the
    tiles (rows of bytes not a multiple of 16, read byte by byte; partial
    column tiles): within 1e-5 of the largest output, a row alone equal
    to the same row in the batch, two calls equal; at 4 slots also the
    time with the weight out of L2."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dequant_matmul import (dequant_matmul_cuda,
                                                    dequant_matmul_i4_cuda)
    from repro_torch.models import lm_quant

    g = torch.Generator(device="cpu").manual_seed(5)
    cases = [(4, 4096, 11008), (4, 11008, 4096), (1, 4096, 11008),
             (1, 11008, 4096), (3, 1000, 522), (5, 777, 1000),
             # DeepSeek-MoE-16B's first-block MLP at 4 slots (phase 15)
             (4, 2048, 10944), (4, 10944, 2048)]
    out = {False: [], True: []}
    int8pack_error = None
    for int4 in (False, True):
        name = "K6" if int4 else "K5"
        plain = ref.dequant_matmul_i4_ref if int4 else ref.dequant_matmul_ref
        kernel = dequant_matmul_i4_cuda if int4 else dequant_matmul_cuda
        for m, k, n in cases:
            w_f = torch.randn(k, n, generator=g).to(dev)
            leaf = lm_quant._quantize_leaf(w_f, 4 if int4 else 8)
            del w_f
            w = leaf.q4 if int4 else leaf.q8
            scale = leaf.qs.reshape(-1)
            x = torch.randn(m, k, generator=g).to(dev)
            got = ops.dequant_matmul(x, leaf)
            want = plain(x, w, scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-5 * want.abs().max().item()
            if not (torch.isfinite(got).all() and err <= tol):
                raise AssertionError(f"{name} {(m, k, n)}: max abs err {err}"
                                     f" > {tol}")
            if not torch.equal(ops.dequant_matmul(x[-1:].clone(), leaf),
                               got[-1:]):
                raise AssertionError(f"{name} {(m, k, n)}: a row's values "
                                     f"depend on the other rows")
            if not torch.equal(ops.dequant_matmul(x, leaf), got):
                raise AssertionError(f"{name} {(m, k, n)}: two calls differ")
            row = {"shape": [m, k, n], "dtype": "float32",
                   "weight": "int4" if int4 else "int8", "max_abs_err": err,
                   "tolerance": tol}
            row["ms"], row["call_ms"] = time_ms(
                torch, lambda: kernel(x, w, scale))
            row["plain_ms"], row["plain_call_ms"] = time_ms(
                torch, lambda: plain(x, w, scale))
            # bytes: x, the weight, the scales and the output, each once;
            # float32 multiply-adds on the CUDA cores
            row["bound_ms"], row["bound_by"] = bound(
                4 * m * k + w.numel() + 4 * n + 4 * m * n, 2 * m * k * n,
                H100_F32_OPS_PER_S)
            row["library_ms"] = None
            if int4:
                row["library"] = ("none: torch._weight_int4pack_mm computes "
                                  "another function (asymmetric group "
                                  "scales in a tiled layout)")
            else:
                # the yardstick, where this torch has a CUDA kernel for it:
                # x @ w.T * scale with w as (N, K) int8
                wt = w.t().contiguous()
                if int8pack_error is None:
                    try:
                        lib = torch._weight_int8pack_mm(x, wt, scale)
                        torch.cuda.synchronize()
                    except (RuntimeError, NotImplementedError) as e:
                        int8pack_error = str(e).splitlines()[0][:120]
                if int8pack_error is None:
                    lib_err = (lib.float() - want).abs().max().item()
                    if lib_err > 1e-3 * want.abs().max().item():
                        raise AssertionError(f"K5 yardstick disagrees by "
                                             f"{lib_err}")
                    row["library_ms"], _ = time_ms(
                        torch, lambda: torch._weight_int8pack_mm(x, wt,
                                                                 scale))
                    row["library"] = "torch._weight_int8pack_mm"
                else:
                    row["library"] = (f"none: torch._weight_int8pack_mm "
                                      f"raises on this card's torch "
                                      f"({int8pack_error})")
                del wt
            # what the unquantized engine pays at this shape: the bf16
            # cuBLAS product on the float weight (labelled, not a library
            # call of this function)
            xb = x.bfloat16()
            wb = lm_quant.dequant_leaf(leaf, torch.bfloat16)
            row["bf16_cublas_ms"], _ = time_ms(torch, lambda: xb @ wb)
            cold = ""
            if m == 4:
                # the decode step's shapes: there each launch reads another
                # layer's weight from HBM; each call of the captured graph
                # reads the next of enough copies to pass COLD_BYTES
                # through the 50 MB L2 between two uses of one copy
                row["cold_ms"], row["cold_copies"] = cold_time_ms(
                    torch, w, lambda wc: kernel(x, wc, scale))
                row["bf16_cublas_cold_ms"], row["bf16_cublas_cold_copies"] = \
                    cold_time_ms(torch, wb, lambda wc: xb @ wc)
                cold = (f"  out of L2: kernel {row['cold_ms'] * 1e3:.2f} us "
                        f"({row['cold_copies']} copies), bf16 cuBLAS "
                        f"{row['bf16_cublas_cold_ms'] * 1e3:.2f} us")
            del xb, wb
            out[int4].append(row)
            log(f"  {name} {(m, k, n)}: err {err:.3g} (tol {tol:.3g}); "
                + _times(row) + f"  bf16 cuBLAS on the float weight "
                f"{row['bf16_cublas_ms'] * 1e3:.2f} us" + cold)
    return out[False], out[True]


def check_paged_decode_attention_q(torch, np, dev):
    """K7 at K4's phase-2 cases on int8 pools with row scales: against
    its plain version, and bit-equal to K4 on the float32 pools that
    hold float(q8) * s (q taken in float32, the result rounded once to
    q's dtype)."""
    import torch.nn.functional as F

    from repro_torch.core.quantize import (dequantize_kv_heads,
                                           quantize_kv_heads)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.paged_decode_attention_q import \
        paged_decode_attention_q_cuda

    g = torch.Generator(device="cpu").manual_seed(14)
    # (b, h, kh, t, bs, d, window, dtype); the first is the paged int8-KV
    # serving path's: Yi-6B at 4 slots of 128 blocks of 16, q bfloat16
    cases = [(4, 32, 4, 128, 16, 128, None, torch.bfloat16),
             (4, 32, 4, 128, 16, 128, None, torch.float32),
             (4, 32, 4, 128, 16, 128, 256, torch.float32),
             (4, 32, 4, 256, 8, 128, None, torch.bfloat16),
             (4, 32, 4, 32, 64, 128, None, torch.bfloat16),
             # DeepSeek-MoE-16B's int8-KV paged decode step (phase 15)
             (4, 16, 16, 128, 16, 128, None, torch.bfloat16)]
    rows = []
    for b, h, kh, t, bs, d, window, dt in cases:
        s = t * bs
        lens = [1, 37, 1500, s]
        k_pool, v_pool, tables, _, _ = _paged_layout(
            torch, dev, torch.float32, b, kh, s, bs, d, lens, seed=t + bs + d)
        (kq, ks), (vq, vs) = quantize_kv_heads(k_pool), \
            quantize_kv_heads(v_pool)
        kf, vf = dequantize_kv_heads(kq, ks), dequantize_kv_heads(vq, vs)
        del k_pool, v_pool
        q = torch.randn(b, h, d, generator=g).to(dev, dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, kq, vq, ks, vs, tables, lengths)
        got = ops.quant_paged_decode_attention(*args, window=window)
        want = ref.paged_decode_attention_q_ref(*args, window=window)
        k4 = paged_decode_attention_cuda(q.float(), kf, vf, tables, lengths,
                                         window=window).to(dt)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dt == torch.float32 else BF16_ATOL
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"K7 {(b, h, kh, t, bs, d, window, dt)}: "
                                 f"max abs err {err} > {tol}")
        if not torch.equal(got, k4):
            raise AssertionError(f"K7 {(b, h, kh, t, bs, d, window, dt)} "
                                 f"differs from K4 on the float32 pool of "
                                 f"float(q8) * s")
        item = q.element_size()
        valid = _decode_valid_rows(lens, s, window)
        blocks = sum(-(-min(n, s) // bs) for n in lens)
        row = {"shape": [b, h, kh, t, bs, d], "pool_blocks": b * t + 1,
               "lengths": lens, "window": window,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "equals_k4_on_dequantized_pool": True, "library_ms": None,
               "library": "none: no single PyTorch call walks a block table "
                          "or dequantizes int8 rows"}
        row["ms"], row["call_ms"] = time_ms(
            torch, lambda: paged_decode_attention_q_cuda(*args,
                                                         window=window))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.paged_decode_attention_q_ref(*args,
                                                            window=window))
        # K4 as an unquantized engine runs it: on the same rows in q's
        # dtype
        kd, vd = kf.to(dt), vf.to(dt)
        row["k4_ms"], _ = time_ms(torch, lambda: paged_decode_attention_cuda(
            q, kd, vd, tables, lengths, window=window))
        del kd, vd
        # bytes: q and out once, the valid int8 K and V rows and their
        # float32 scales once, lengths, the table entries those rows need
        row["bound_ms"], row["bound_by"] = bound(
            item * 2 * b * h * d + 2 * valid * kh * (d + 4) + 4 * b
            + 4 * blocks, 4 * h * d * valid,
            H100_F32_OPS_PER_S if dt == torch.float32
            else H100_BF16_OPS_PER_S)
        # the chain of calls, for scale only: gather the table's blocks
        # and scales, dequantize to q's dtype, one SDPA (bool mask, GQA)
        pos = torch.arange(s, device=dev)[None, :]
        mask = pos < lengths[:, None]
        if window is not None:
            mask &= pos >= lengths[:, None] - window
        mask = mask[:, None, None, :]
        idx = tables.long()

        def chain():
            def gather(pool, sc):
                rows_ = pool[idx].transpose(1, 2).reshape(b, kh, s, d)
                return (rows_.float() * sc[idx].transpose(1, 2).reshape(
                    b, kh, s)[..., None]).to(dt)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], gather(kq, ks), gather(vq, vs),
                attn_mask=mask, enable_gqa=True)
        lib_err = (chain()[:, :, 0].float() - want.float()).abs().max()
        if lib_err.item() > 10 * tol:
            raise AssertionError(f"K7 gather + dequant + SDPA disagrees by "
                                 f"{lib_err}")
        row["gather_dequant_sdpa_ms"], _ = time_ms(torch, chain)
        rows.append(row)
        log(f"  K7 {(b, h, kh, t, bs, d)} window={window} {row['dtype']}: "
            f"err {err:.3g}, equal to K4 on the dequantized pool; "
            + _times(row) + f"  K4 on the {row['dtype']} pool "
            f"{row['k4_ms'] * 1e3:.2f} us  gather+dequant+SDPA (several "
            f"calls) {row['gather_dequant_sdpa_ms'] * 1e3:.2f} us")
    return rows


# the SSD scan against its plain version: tests/test_kernels.py's bound
SSD_ATOL, SSD_RTOL = 5e-4, 1e-3


def ssd_bound(b, s, h, p, g, n, chunk, item, h0, d,
              ops_per_s=H100_F32_OPS_PER_S):
    """(least ms, what bounds it) of one SSD scan: the bytes of x, y, dt,
    B, C, A (and D, h0) once and the float32 state out; the least
    operations — C·Bᵀ once per group and chunk and only its causal half,
    the causal half of the (L, L)·(L, P) product, C·stateᵀ and the state
    update per head and chunk — on the CUDA cores (``ops_per_s``: at
    another rate, such as the tensor cores')."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    nbytes = (2 * item * b * s * h * p + 4 * b * s * h + 2 * item * b * s * g
              * n + 4 * h * (2 if d else 1) + 4 * b * h * p * n * (2 if h0
                                                                   else 1))
    ops = (b * g * nc * 2 * tri * n
           + b * h * nc * (2 * tri * p + 4 * chunk * n * p))
    return bound(nbytes, ops, ops_per_s)


# K8's phase-2 cases (b, s, h, p, g, n, dtype, h0, D, tail); the first is
# the main path's: Mamba2-780m's one-shot prefill of 512 tokens
K8_CASES = [(1, 512, 48, 64, 1, 128, "bfloat16", False, False, 0),
            (1, 512, 48, 64, 1, 128, "bfloat16", True, False, 0),
            (1, 128, 48, 64, 1, 128, "bfloat16", False, False, 0),
            (1, 128, 48, 64, 1, 128, "bfloat16", True, False, 0),
            (1, 512, 64, 64, 1, 64, "bfloat16", False, False, 0),
            (1, 512, 48, 64, 1, 128, "float32", True, False, 0),
            (2, 256, 8, 64, 2, 64, "float32", True, True, 0),
            (1, 192, 48, 64, 1, 128, "float32", True, False, 0),
            (1, 128, 48, 64, 1, 128, "float32", True, False, 28)]


def k8_inputs(torch, np, dev, i):
    """(x, dt, A, B, C, D, h0) of ``K8_CASES[i]`` on ``dev``, from seed
    100 + i; a tail of dt = 0 rows where the case has one."""
    b, s, h, p, g, n, dtype, h0, d, tail = K8_CASES[i]
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(100 + i)
    t = lambda shape, lo=None, hi=None: torch.from_numpy(
        (rng.normal(0, 1, shape) if lo is None
         else rng.uniform(lo, hi, shape)).astype(np.float32)).to(dev)
    x, bm, cm = t((b, s, h, p)).to(dtype), t((b, s, g, n)).to(dtype), \
        t((b, s, g, n)).to(dtype)
    dt = t((b, s, h), 0.001, 0.1)
    if tail:
        dt[:, s - tail:] = 0
    a = -t((h,), 0.5, 2.0)
    dd = t((h,)) if d else None
    st = t((b, h, p, n)) if h0 else None
    return x, dt, a, bm, cm, dd, st


def check_ssd_scan(torch, np, dev):
    """K8 against its plain version on the card: Mamba2-780m's prefill
    shapes (48 heads of 64, N 128, bf16) at 512 and 128 tokens, without
    and with a carried state; Zamba2-1.2B's (64 heads, N 64); float32;
    groups of 2 with D; 192 tokens with the wrapper's chunk of 64; a
    padded tail of dt = 0 rows.  float32 within the JAX package's bound
    for this kernel (atol 5e-4, rtol 1e-3), bfloat16 y within one
    bfloat16 ulp besides."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as K8
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    f32 = torch.float32
    rows = []
    for i, (b, s, h, p, g, n, _, h0, d, tail) in enumerate(K8_CASES):
        x, dt, a, bm, cm, dd, st = k8_inputs(torch, np, dev, i)
        dt_ = x.dtype
        chunk = ops._pick_block(s)
        y, state = ops.ssd_scan(x, dt, a, bm, cm, dd, h0=st)
        want_y, want_s = ref.ssd_scan_ref(x, dt, a, bm, cm, dd, chunk=chunk,
                                          h0=st)
        torch.cuda.synchronize()
        y_rtol = SSD_RTOL if dt_ == f32 else 2.0 ** -7
        dy = (y.float() - want_y.float()).abs()
        ds = (state - want_s).abs()
        ok = (torch.isfinite(y).all() and torch.isfinite(state).all()
              and bool((dy <= SSD_ATOL + y_rtol * want_y.float().abs()).all())
              and bool((ds <= SSD_ATOL + SSD_RTOL * want_s.abs()).all()))
        if tail:        # the padded rows are exact no-ops on the state
            _, real = ref.ssd_scan_ref(x[:, :s - tail], dt[:, :s - tail], a,
                                       bm[:, :s - tail], cm[:, :s - tail],
                                       dd, chunk=s - tail, h0=st)
            ok = ok and bool(((state - real).abs()
                              <= SSD_ATOL + SSD_RTOL * real.abs()).all())
        err = max(dy.max().item(), ds.max().item())
        label = (f"{(b, s, h, p, g, n)} {str(dt_)[6:]} chunk {chunk}"
                 f"{' h0' if h0 else ''}{' D' if d else ''}"
                 f"{f' tail {tail}' if tail else ''}")
        if not ok:
            raise AssertionError(f"K8 {label}: max abs err {err} beyond "
                                 f"atol {SSD_ATOL} / rtol {y_rtol}")
        row = {"shape": [b, s, h, p, g, n], "chunk": chunk,
               "dtype": str(dt_).replace("torch.", ""), "h0": h0, "D": d,
               "masked_tail": tail, "max_abs_err": err,
               "max_abs_err_y": dy.max().item(),
               "max_abs_err_state": ds.max().item(), "library_ms": None,
               "library": "none: no single PyTorch call computes the scan"}
        row["ms"], row["call_ms"] = time_ms(torch, lambda: ssd_scan_cuda(
            x, dt, a, bm, cm, dd, chunk=chunk, h0=st))
        row["plain_ms"], row["plain_call_ms"] = time_ms(
            torch, lambda: ref.ssd_scan_ref(x, dt, a, bm, cm, dd,
                                            chunk=chunk, h0=st))
        row["bound_ms"], row["bound_by"] = ssd_bound(
            b, s, h, p, g, n, chunk, x.element_size(), h0, d)
        # the same least operations on the tensor cores in bf16, which
        # carry the kernel's products
        row["bound_tensor_core_ms"], row["bound_tensor_core_by"] = ssd_bound(
            b, s, h, p, g, n, chunk, x.element_size(), h0, d,
            H100_BF16_OPS_PER_S)
        row["tiles"] = list(K8.tiling(s, h, p, n, chunk, dt_))
        rows.append(row)
        log(f"  K8 {label}: err {err:.3g}; " + _times(row)
            + f"; on the tensor cores {row['bound_tensor_core_ms'] * 1e3:.4f}"
            f" us ({row['bound_tensor_core_by']}); tiles {row['tiles']}")
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: the interpreter on the card against the CPU reference
# ---------------------------------------------------------------------------

def outputs(it):
    return [it.output(k) for k in range(len(it.model.outputs))]


def serve(np, card, cpu, requests, atol, label, relative=False):
    """Answer every request on both interpreters; returns the median
    invoke ms on the card (set_input, invoke, outputs), the max error
    (abs, or with ``relative`` over the largest |entry| of each CPU
    output) and the card's outputs (a list per request)."""
    times, err, allocs, outs = [], 0.0, None, []
    for i, feeds in enumerate(requests):
        t0 = time.perf_counter()
        for pos, x in enumerate(feeds):
            card.set_input(pos, x)
        card.invoke()
        got = outputs(card)
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(got)
        if i == 0:
            allocs = card.shared.alloc_count
        for pos, x in enumerate(feeds):
            cpu.set_input(pos, x)
        cpu.invoke()
        for g, w in zip(got, outputs(cpu)):
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"{label}: bad output {g.shape}")
            e = float(np.abs(g - w).max())
            err = max(err, e / float(np.abs(w).max()) if relative else e)
    if err > atol:
        raise AssertionError(f"{label}: card vs CPU reference max "
                             f"{'relative' if relative else 'abs'} err "
                             f"{err} > {atol}")
    if card.shared.alloc_count != allocs:
        raise AssertionError(f"{label}: the arena pool allocated after the "
                             f"first invoke")
    return statistics.median(times), err, outs


def run_models(np, dev):
    from repro_torch.apps.models import (build_conv_reference, build_fc_stack,
                                         build_hotword, build_vww,
                                         representative_dataset)
    from repro_torch.core import (AllOpsResolver, MicroInterpreter,
                                  MicroModel, OpCode, export)

    card_res = AllOpsResolver(tags=("cuda", "reference"))
    cpu_res = AllOpsResolver(tags=("reference",))
    plan = [("conv_reference", build_conv_reference, False),
            ("hotword", build_hotword, False),
            ("vww", build_vww, False),
            ("conv_reference", build_conv_reference, True),
            ("vww", build_vww, True),
            ("fc_stack", build_fc_stack, True)]
    blobs = []
    for name, builder, int8 in plan:
        gb = builder()
        blobs.append(export(gb, representative_dataset(gb),
                            quantize_int8=True) if int8 else export(gb))
    rows, cards, int8_fc_invokes = [], [], 0
    for (name, _, int8), blob in zip(plan, blobs):
        label = f"{name} {'int8' if int8 else 'float'}"
        model = MicroModel(blob)
        size = MicroInterpreter.required_arena_size(model, card_res)
        card = MicroInterpreter(model, card_res, size, device=dev)
        cpu = MicroInterpreter(model, cpu_res, size, device="cpu")
        rng = np.random.default_rng(len(rows))
        shape = card.input_spec(0).shape
        requests = [(rng.normal(0, 1, shape).astype(np.float32),)
                    for _ in range(N_REQUESTS)]
        ms, err, outs = serve(np, card, cpu, requests,
                              INT8_ATOL if int8 else FLOAT_ATOL, label)
        replayed = list(outs)
        fc = sum(1 for op in model.operators
                 if op.opcode == OpCode.FULLY_CONNECTED
                 and model.tensor(op.inputs[0]).dtype == "int8")
        int8_fc_invokes += fc * N_REQUESTS
        if card.alloc.var_specs:
            # the SVDF state carried across the requests: from a reset
            # state request 0 gets its first answer again, request 1 not
            for i, same in ((0, True), (1, False)):
                card.reset_variable_tensors()
                card.set_input(0, requests[i][0])
                card.invoke()
                if np.allclose(card.output(0), outs[i][0],
                               atol=1e-6) != same:
                    raise AssertionError(f"{label}: variable state did not "
                                         f"carry across invokes")
        rows.append({"model": label, "ops": len(model.operators),
                     "blob_bytes": len(blob), "arena_bytes": size,
                     "median_invoke_ms": ms, "max_abs_err": err,
                     "int8_fc_ops": fc})
        cards.append((card, requests, replayed))
        log(f"  {label:<20} {len(model.operators):>3} ops  blob "
            f"{len(blob):>8,} B  arena {size:>8,} B  median invoke "
            f"{ms:8.3f} ms  max err {err:.3g}")
    return rows, cards, int8_fc_invokes


def run_attention(np, dev):
    from repro_torch.core import (AllOpsResolver, GraphBuilder,
                                  MicroInterpreter, MicroModel, export)

    shape = (2, 4, 256, 64)
    gb = GraphBuilder("attention")
    q, k, v = (gb.input(n, shape) for n in "qkv")
    gb.mark_output(gb.attention(q, k, v, causal=True))
    blob = export(gb)
    model = MicroModel(blob)
    card_res = AllOpsResolver(tags=("cuda", "reference"))
    size = MicroInterpreter.required_arena_size(model, card_res)
    card = MicroInterpreter(model, card_res, size, device=dev)
    cpu = MicroInterpreter(model, AllOpsResolver(), size, device="cpu")
    rng = np.random.default_rng(99)
    requests = [tuple(rng.normal(0, 1, shape).astype(np.float32)
                      for _ in range(3)) for _ in range(N_REQUESTS)]
    ms, err, outs = serve(np, card, cpu, requests, FLOAT_ATOL, "attention")
    log(f"  attention (2,4,256,64) causal  blob {len(blob):,} B  arena "
        f"{size:,} B  median invoke {ms:.3f} ms  max err {err:.3g}")
    return {"model": "attention float", "ops": 1, "blob_bytes": len(blob),
            "arena_bytes": size, "median_invoke_ms": ms,
            "max_abs_err": err}, (card, requests, outs)


def eager_invokes(np, rows, cards) -> None:
    """Phase 5: every micro model's requests twice more from the same
    variable state, untraced: replayed, then eagerly
    (``disable_capture()``); outputs bit-equal to those of phases 3-4
    both times, the replayed median invoke beside the eager one, one
    captured program per model."""
    from repro_torch.core import capture_count, disable_capture

    def timed(card, requests, want, label):
        card.reset_variable_tensors()
        times = []
        for feeds, out in zip(requests, want):
            t0 = time.perf_counter()
            for pos, x in enumerate(feeds):
                card.set_input(pos, x)
            card.invoke()
            got = outputs(card)
            times.append((time.perf_counter() - t0) * 1e3)
            if not all(np.array_equal(g, o) for g, o in zip(got, out)):
                raise AssertionError(f"{label}: an invoke differs from the "
                                     f"replayed one of phase 3")
        return statistics.median(times)

    for row, (card, requests, replayed) in zip(rows, cards):
        prog = card.compiled.program
        row["traced_median_invoke_ms"] = row["median_invoke_ms"]
        row["median_invoke_ms"] = timed(card, requests, replayed,
                                        row["model"])
        with disable_capture():
            eager = timed(card, requests, replayed, row["model"] + " eager")
        if capture_count(prog) != 1 or prog.captures != 1:
            raise AssertionError(f"{row['model']}: {capture_count(prog)} "
                                 f"programs, {prog.captures} captures")
        row.update(eager_median_invoke_ms=eager,
                   replay_bit_equal_eager=True, captures=capture_count(prog),
                   capture_s=prog.capture_s)
        log(f"  {row['model']:<20} invoke median eager "
            f"{row['eager_median_invoke_ms']:.3f} ms, replayed "
            f"{row['median_invoke_ms']:.3f} ms; {len(requests)} replayed "
            f"outputs bit-equal to eager; 1 program, captured in "
            f"{prog.capture_s * 1e3:.1f} ms")


def profile_invokes(torch, rows, cards) -> None:
    """Where an invoke's time goes on the card: device time by kernel
    from torch.profiler over 3 invokes, replayed and eager, and the share
    of the median invoke (phases 3-5, not profiled) during which the
    device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import disable_capture

    for row, (card, requests, _) in zip(rows, cards):
        feeds = requests[0]
        for key, ctx in (("", contextlib.nullcontext()),
                         ("eager_", disable_capture())):
            with ctx, profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    for pos, x in enumerate(feeds):
                        card.set_input(pos, x)
                    card.invoke()
            events = sorted((e for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA),
                            key=lambda e: -e.self_device_time_total)
            device_ms = sum(e.self_device_time_total for e in events) / 3e3
            row[key + "device_ms_per_invoke"] = device_ms
            row[key + "device_busy_share"] = (
                device_ms / row[key + "median_invoke_ms"])
            row[key + "top_device"] = [
                {"name": e.key[:80], "us_per_invoke":
                 e.self_device_time_total / 3,
                 "count_per_invoke": e.count / 3} for e in events[:6]]
        us = row["device_ms_per_invoke"] * 1e3
        log(f"  {row['model']:<20} device {us:9.1f} us per invoke: busy "
            f"{100 * row['device_busy_share']:5.1f}% replayed, "
            f"{100 * row['eager_device_busy_share']:5.1f}% eager "
            f"({row['eager_device_ms_per_invoke'] * 1e3:.1f} us); top: "
            + "; ".join(f"{t['name'][:40]} {t['us_per_invoke']:.1f} us"
                        for t in row["top_device"][:3]))


# ---------------------------------------------------------------------------
# phases 13-14: the micro interpreter complete (every micro op; batched
# and ragged dispatch)
# ---------------------------------------------------------------------------

BLOCK_SEQ = 256
N_GRAPH_REQUESTS = 4
# float32 graphs on the card vs the CPU: a Yi-6B block sums 4096 and
# 11008 products per output in another order, the coverage graph's
# transcendentals differ in their last ulps; the stated bound is relative
# to the largest entry of each output
GRAPH_RTOL = 1e-4


def graph_requests(np, model, seed, n, vocab):
    """n seeded requests: token ids in [0, vocab) for an int32 input,
    N(0, 1) for a float one."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        feeds = []
        for t in model.inputs:
            spec = model.tensor(t)
            feeds.append(rng.integers(0, vocab, spec.shape).astype(np.int32)
                         if spec.dtype == "int32" else
                         rng.normal(0, 1, spec.shape).astype(np.float32))
        reqs.append(tuple(feeds))
    return reqs


def run_new_ops(np, dev):
    """Phase 13: the decoder block at Yi-6B's widths (float32, K2 at
    (1, 32, 256, 128)) and the op-coverage graph at VWW's input, float
    (serialized with its IDENTITY and DROPOUT) and int8, each on the card
    against the same blob on the CPU.  Returns the rows, the cards for
    phase 5's replay-vs-eager pass, and the K1 and K2 launches the
    invokes make."""
    from repro_torch.apps.graphs import build_decoder_block, build_op_coverage
    from repro_torch.apps.models import representative_dataset
    from repro_torch.configs import get_config
    from repro_torch.core import (AllOpsResolver, MicroInterpreter,
                                  MicroModel, OpCode, export)

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    block = export(build_decoder_block(cfg, BLOCK_SEQ, seed=13))
    log(f"  {LM_ARCH} block blob: {len(block):,} B, built in "
        f"{time.perf_counter() - t0:.1f} s")
    cov_q = build_op_coverage(96, quantizable_only=True)
    plan = [(f"{LM_ARCH} block float32", block, GRAPH_RTOL, True,
             cfg.vocab),
            ("op coverage float", build_op_coverage(96).build(), GRAPH_RTOL,
             True, 50),
            ("op coverage int8", export(cov_q, representative_dataset(cov_q),
                                        quantize_int8=True),
             INT8_ATOL, False, 50)]
    card_res = AllOpsResolver(tags=("cuda", "reference"))
    cpu_res = AllOpsResolver(tags=("reference",))
    rows, cards = [], []
    want = {"quant_matmul": 0, "flash_attention": 0}
    for label, blob, tol, relative, vocab in plan:
        model = MicroModel(blob)
        size = MicroInterpreter.required_arena_size(model, card_res)
        card = MicroInterpreter(model, card_res, size, device=dev)
        cpu = MicroInterpreter(model, cpu_res, size, device="cpu")
        requests = graph_requests(np, model, len(rows), N_GRAPH_REQUESTS,
                                  vocab)
        ms, err, outs = serve(np, card, cpu, requests, tol, label, relative)
        del cpu
        ops = [op.opcode for op in model.operators]
        int8_fc = sum(1 for op in model.operators
                      if op.opcode == OpCode.FULLY_CONNECTED
                      and model.tensor(op.inputs[0]).dtype == "int8")
        want["quant_matmul"] += int8_fc * N_GRAPH_REQUESTS
        want["flash_attention"] += ops.count(OpCode.ATTENTION) * \
            N_GRAPH_REQUESTS
        rows.append({"model": label, "ops": len(ops),
                     "opcodes": len(set(ops)), "blob_bytes": len(blob),
                     "arena_bytes": size, "median_invoke_ms": ms,
                     ("max_rel_err" if relative else "max_abs_err"): err})
        cards.append((card, requests, outs))
        log(f"  {label:<24} {len(ops):>3} ops ({len(set(ops))} opcodes)  "
            f"blob {len(blob):>13,} B  arena {size:>10,} B  median invoke "
            f"{ms:8.3f} ms  max {'rel' if relative else 'abs'} err "
            f"{err:.3g} (bound {tol:.3g})")
    return rows, cards, want


RAGGED_LANES = 16
OCCUPANCIES = (0.25, 0.5, 0.75, 1.0)
RAGGED_WAVES = 12
TIMED_WAVES = 20
# hotword float lanes of the throughput lowering (each op once over the
# 16 stacked lanes) against a single invoke: float32 sums in another
# order, on softmax outputs in [0, 1]
RAGGED_FLOAT_ATOL = 1e-5


def ragged_buckets():
    """(bucket, blob, exact, frames a request): the reference
    benchmark's int8 buckets (benchmarks/ragged_invoke.py) and the
    streaming hotword, under both lowerings."""
    from repro_torch.apps.models import (build_conv_reference, build_fc_stack,
                                         build_hotword, representative_dataset)
    from repro_torch.core import export

    def int8(gb):
        return export(gb, representative_dataset(gb), quantize_int8=True)
    hotword = export(build_hotword())
    return [("fc_stack int8", int8(build_fc_stack()), False, (1, 1)),
            ("conv_reference int8", int8(build_conv_reference()), False,
             (1, 1)),
            ("hotword float", hotword, False, (1, 4)),
            ("hotword float exact", hotword, True, (1, 4))]


def run_ragged(torch, np, pool, buckets, shapes):
    """Phase 14's waves: each bucket's occupancy cycles through
    ``OCCUPANCIES`` of its 16 lanes; a request streams 1-4 frames
    (hotword) or one; one hotword lane of each lowering is snapshotted
    and retired at wave 2 and restored into a free lane at wave 5.
    Returns {bucket: {uid: (frames, outputs)}} and each wave's device
    memory."""
    rng = np.random.default_rng(14)
    reqs = {name: {} for name, *_ in buckets}
    live = {name: {} for name, *_ in buckets}        # uid -> slot
    parked, restored, memory, uid = {}, set(), [], 0
    for wave in range(RAGGED_WAVES):
        occ = int(OCCUPANCIES[wave % len(OCCUPANCIES)] * RAGGED_LANES)
        for name, _, exact, (lo, hi) in buckets:
            if wave == 5 and name in parked:
                ckpt = parked.pop(name)
                slot = pool.free_lanes(name)[-1]
                live[name][ckpt.uid] = pool.restore_lane(ckpt, slot)
                restored.add(name)
            while len(live[name]) < occ:
                n = int(rng.integers(lo, hi + 1))
                frames = [rng.normal(0, 1, shapes[name]).astype(np.float32)
                          for _ in range(n)]
                reqs[name][uid] = (frames, [])
                live[name][uid] = pool.admit(name, uid=uid)
                uid += 1
            for u, slot in live[name].items():
                frames, outs = reqs[name][u]
                pool.set_input(name, slot, 0, frames[len(outs)])
        pool.dispatch()
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated())
        for name, _, exact, _ in buckets:
            got = pool.outputs(name, 0)
            for u, slot in list(live[name].items()):
                frames, outs = reqs[name][u]
                outs.append(got[slot].copy())
                if wave == 2 and name.startswith("hotword") and \
                        name not in parked and len(outs) < len(frames):
                    parked[name] = pool.snapshot_lane(name, slot)
                    pool.retire(name, slot)
                    del live[name][u]
                elif len(outs) == len(frames):
                    pool.retire(name, slot)
                    del live[name][u]
    for name, lanes in live.items():             # unfinished at the end
        for u, slot in lanes.items():
            pool.retire(name, slot)
            frames, outs = reqs[name][u]
            del frames[len(outs):]
    streaming = {name for name, *_ in buckets if name.startswith("hotword")}
    if parked or restored != streaming:
        raise AssertionError(f"phase 14: snapshotted and restored lanes in "
                             f"{sorted(restored)}, of {sorted(streaming)}")
    return reqs, memory


def ragged_micro(torch, np, dev):
    """Phase 14: ragged micro dispatch on the card (main path), then the
    checks and the timing.  Returns the row and the K1 launches the
    waves make."""
    from repro_torch.core import (AllOpsResolver, MicroInterpreter,
                                  MicroModel, OpCode, RaggedInterpreterPool,
                                  capture_count)

    res = AllOpsResolver(tags=("cuda", "reference"))
    buckets = ragged_buckets()
    models = {name: MicroModel(blob) for name, blob, *_ in buckets}
    shapes = {name: tuple(m.tensor(m.inputs[0]).shape)
              for name, m in models.items()}
    pool = RaggedInterpreterPool(device=dev)
    for name, _, exact, _ in buckets:
        pool.add_bucket(name, models[name], res, RAGGED_LANES, exact=exact)
    want_k1 = RAGGED_WAVES * sum(
        1 for m in models.values() for op in m.operators
        if op.opcode == OpCode.FULLY_CONNECTED
        and m.tensor(op.inputs[0]).dtype == "int8")
    with main_path(torch, "the ragged micro path (phase 14)") as traced:
        reqs, memory = run_ragged(torch, np, pool, buckets, shapes)
    if traced["quant_matmul"] != want_k1:
        raise AssertionError(f"phase 14: K1 launched "
                             f"{traced['quant_matmul']} times, the waves' "
                             f"int8 FC ops {want_k1}")
    # the first dispatch of each bucket returns its eager warm-up's
    # outputs (freed at the next wave); from then on nothing may move
    if len(set(memory[1:])) != 1 or memory[1] > memory[0]:
        raise AssertionError(f"phase 14: device memory moved after the "
                             f"first wave: {memory}")
    row = {"model": "ragged micro", "lanes": RAGGED_LANES,
           "waves": RAGGED_WAVES, "buckets": {}}
    for name, _, exact, _ in buckets:
        prog = pool.program(name)
        if capture_count(prog) != 1 or prog.captures != 1:
            raise AssertionError(f"phase 14 {name}: {capture_count(prog)} "
                                 f"programs, {prog.captures} captures")
        alone = MicroInterpreter(models[name], res,
                                 MicroInterpreter.required_arena_size(
                                     models[name], res), device=dev)
        err, n = 0.0, 0
        for frames, outs in reqs[name].values():
            alone.reset_variable_tensors()
            for f, got in zip(frames, outs):
                alone.set_input(0, f)
                alone.invoke()
                e = float(np.abs(got - alone.output(0)).max())
                if (exact or "int8" in name) and e != 0.0:
                    raise AssertionError(f"phase 14 {name}: a lane differs "
                                         f"from its request alone by {e}")
                err, n = max(err, e), n + 1
        if err > RAGGED_FLOAT_ATOL:
            raise AssertionError(f"phase 14 {name}: max abs err {err} > "
                                 f"{RAGGED_FLOAT_ATOL}")
        row["buckets"][name] = {"exact": exact, "requests": len(reqs[name]),
                                "frames": n, "max_abs_err": err,
                                "captures": 1, "alone": alone}
        log(f"  {name:<22} {len(reqs[name]):>3} requests, {n:>3} frames: "
            + ("bit-equal to each request alone" if exact or "int8" in name
               else f"max abs err {err:.3g} (bound {RAGGED_FLOAT_ATOL})")
            + "; 1 masked program, 1 capture")
    log(f"  device memory {memory[1]:,} B after every wave from the "
        f"second to the {RAGGED_WAVES}th ({memory[0] - memory[1]:,} B more "
        f"after the first: its eager warm-up's outputs); lanes admitted, "
        f"retired, snapshotted and restored across waves")
    row["memory_bytes_after_waves"] = memory
    time_ragged(np, pool, buckets, shapes, row)
    return row, want_k1


def time_ragged(np, pool, buckets, shapes, row) -> None:
    """Per-request us of a wave at each occupancy (set_input for its
    lanes, one dispatch, the outputs read), the median of TIMED_WAVES,
    against one request alone through a MicroInterpreter (set_input,
    invoke, output), each bucket on its own."""
    rng = np.random.default_rng(41)
    for name, _, _, _ in buckets:
        b = row["buckets"][name]
        alone = b.pop("alone")
        x = rng.normal(0, 1, shapes[name]).astype(np.float32)

        def single():
            alone.set_input(0, x)
            alone.invoke()
            alone.output(0)
        b["sequential_us"] = median_us(single)
        b["wave_us_per_request"] = {}
        for occ in OCCUPANCIES:
            k = int(occ * RAGGED_LANES)
            slots = [pool.admit(name) for _ in range(k)]

            def wave():
                for slot in slots:
                    pool.set_input(name, slot, 0, x)
                pool.dispatch()
                pool.outputs(name, 0)
            b["wave_us_per_request"][occ] = median_us(wave) / k
            for slot in slots:
                pool.retire(name, slot)
        log(f"  {name:<22} per request: alone {b['sequential_us']:7.1f} us; "
            "a wave at occupancy " + ", ".join(
                f"{occ:.2f} {us:6.1f} us"
                for occ, us in b["wave_us_per_request"].items()))


def median_us(fn, n: int = TIMED_WAVES) -> float:
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases 6-8: dense-LM serving (Yi-6B)
# ---------------------------------------------------------------------------

LM_ARCH = "yi-6b"
SERVE_SLOTS, SERVE_CACHE = 4, 2048
# phase 10's Yi-6B: full width, 8 of its 32 layers (phases 26 and 27
# need the script's time; phases 7 and 9 serve all 32)
QUANT_LAYERS = 8
N_SERVE, SERVE_NEW = 8, 32
PAGED_BLOCK, CHUNK = 16, 128
TF_STEPS = 16
# float32 teacher-forced logits: K3's online softmax and the plain
# softmax differ in rounding only; the stated bound is relative to the
# step's largest logit
TF_RTOL = 1e-4


def teacher_forced(torch, np, dev):
    """Phase 6: Yi-6B at full width in float32, decode on K3 against its
    plain version, both fed the plain run's greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import get_model, lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(6)
    # prefills of 2048 (the first decode step wraps the ring), 36, 299
    # and 511 tokens
    prompts = [rng.integers(0, cfg.vocab - 2, n) for n in (2049, 37, 300,
                                                          512)]
    caches = [bundle.empty_cache(len(prompts), SERVE_CACHE, torch.float32,
                                 dev) for _ in range(2)]
    worst, steps = 0.0, []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            _, one = lm.lm_prefill(model, cfg,
                                   torch.as_tensor(p[None, :-1], device=dev),
                                   SERVE_CACHE, window=cfg.sliding_window)
            for cache in caches:
                for name in ("k", "v"):
                    cache[name][:, i:i + 1].copy_(one[name])
        lengths = torch.tensor([len(p) - 1 for p in prompts],
                               dtype=torch.int32, device=dev)
        cur = torch.tensor([[int(p[-1])] for p in prompts], device=dev)
        for _ in range(TF_STEPS):
            want, _ = lm.lm_decode(model, cfg, caches[0], cur, lengths,
                                   attn_impl=ref.decode_attention_ref)
            got, _ = lm.lm_decode(model, cfg, caches[1], cur, lengths,
                                  attn_impl=ops.decode_attention)
            top = want.abs().max().item()
            err = (got - want).abs().max().item()
            if not (torch.isfinite(got).all() and err <= TF_RTOL * top):
                raise AssertionError(f"teacher-forced step {len(steps)}: "
                                     f"max |dlogit| {err} > {TF_RTOL} * "
                                     f"{top}")
            worst = max(worst, err / top)
            steps.append(err)
            cur = want[:, :cfg.vocab].argmax(dim=-1, keepdim=True)
            lengths += 1
    del model, caches
    torch.cuda.empty_cache()
    log(f"  {cfg.arch_id} float32, {n_params:,} parameters, {TF_STEPS} "
        f"steps: max |dlogit| {max(steps):.3g}, at most {worst:.3g} of the "
        f"step's largest logit (bound {TF_RTOL})")
    return {"model": f"{cfg.arch_id} float32 teacher-forced K3 vs plain",
            "parameters": n_params, "steps": TF_STEPS,
            "max_abs_dlogit": max(steps), "max_rel_dlogit": worst}


def family_extras(np, cfg, uid):
    """Request ``uid``'s seeded stub-frontend inputs: PaliGemma's patch
    embeddings, Whisper's frame embeddings; None for the other
    families."""
    rng = np.random.default_rng(40_000 + uid)
    if cfg.family == "vlm":
        return {"vision": rng.normal(0, 1, (cfg.n_vision_tokens,
                                            cfg.d_vision)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.normal(0, 1, (cfg.n_audio_ctx,
                                            cfg.d_model)).astype(np.float32)}
    return None


def serving_workload(np, vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab - 2, int(n)).astype(np.int32)
            for n in rng.integers(16, 513, N_SERVE)]


def kv_state(eng):
    """The engine's device KV state: the rings, or the pool and table."""
    if eng.paged:
        return [*eng.kv_pool.values(), eng.block_tables]
    return list(eng.cache.values())


def captures(eng) -> int:
    """Captures the engine's programs made so far."""
    return sum(p.captures for p in eng.programs().values())


def capture_cost(torch, programs):
    """(seconds the programs spent capturing, warm-up included; bytes of
    device memory their graph pools hold)."""
    pools = {tuple(p.pool.handle) for p in programs
             if p.pool.handle is not None}
    held = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)
    return sum(p.capture_s for p in programs), held


# device memory a newly captured program may add (its graph's memory
# stays in the engine's pool, which memory_allocated does not count)
NEW_PROGRAM_BYTES = 1 << 20


def serve_lm(torch, np, dev, eng, prompts, eager=False, new=SERVE_NEW):
    """Phases 7, 9, 10 and 12: every request through ``eng``, replayed
    from CUDA graphs (or, with ``eager``, under ``disable_capture()``);
    checks what stays in place, that device memory after each decode
    step (with no chunked prefill in flight) is its value after the
    first one plus at most ``NEW_PROGRAM_BYTES`` for each program
    captured since, and the program counts (decode 1, chunk 1, prefill
    one per length hit: the buckets on a bucketed engine), and returns
    the run's numbers."""
    from repro_torch.core import capture_count, disable_capture
    from repro_torch.serving import Request

    # earlier phases' garbage freed now, not during the run, where the
    # memory check below would see device memory fall
    gc.collect()
    ptrs = [t.data_ptr() for t in kv_state(eng)]
    persistent = eng.arena.usage().persistent
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=new,
                           extras=family_extras(np, eng.cfg, uid)))
    mem0, caps0, growth, decode_steps, step_ms = None, 0, 0, 0, []
    prefills = chunk_steps = 0
    lengths = set()
    ctx = disable_capture() if eager else contextlib.nullcontext()
    t_run = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with ctx:
            more = eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        prefills += len(eng.last_step["prefill_tokens"])
        lengths.update(eng.last_step["prefill_tokens"])
        chunk_steps += eng.last_step["chunks"]
        # a prompt mid-chunked-prefill holds its own batch=1 cache, so
        # memory is compared at the steps where none is in flight
        if eng.last_step["decoded"]:
            decode_steps += 1
        if eng.last_step["decoded"] and not eng._chunking:
            mem = torch.cuda.memory_allocated()
            if mem0 is None:
                mem0, caps0 = mem, captures(eng)
            growth = max(growth, mem - mem0)
            fresh = captures(eng) - caps0
            if not 0 <= mem - mem0 <= NEW_PROGRAM_BYTES * fresh:
                raise AssertionError(f"device memory {mem} B after decode "
                                     f"step {decode_steps}, {mem0} B after "
                                     f"the first, {fresh} programs captured "
                                     f"since")
            if not eng.last_step["prefill_tokens"]:
                step_ms.append(dt)
        if [t.data_ptr() for t in kv_state(eng)] != ptrs:
            raise AssertionError("the KV cache, pool or block table moved")
        if not more:
            break
    wall = time.perf_counter() - t_run
    if eng.arena.usage().persistent != persistent:
        raise AssertionError("the arena's persistent bytes changed")
    res = {uid: eng.results[uid] for uid in range(len(prompts))}
    for uid, r in res.items():
        if not (r.done and 1 <= len(r.output) <= new and all(
                0 <= t < eng.cfg.vocab for t in r.output)):
            raise AssertionError(f"request {uid} did not finish well: "
                                 f"{r.output}")
    if eng.paged and eng.pool.free_blocks() != eng.pool.usable_blocks:
        raise AssertionError(f"{eng.pool.free_blocks()} of "
                             f"{eng.pool.usable_blocks} blocks came back")
    counts = {"decode": capture_count(eng._decode),
              "prefill": eng.prefill_compiles(),
              "chunk": eng.chunk_compiles()}
    want = ({"decode": 0, "prefill": 0, "chunk": 0} if eager else
            {"decode": 1, "prefill": len(lengths),
             "chunk": int(bool(eng.chunk_tokens))})
    if counts != want:
        raise AssertionError(f"programs {counts}, expected {want}")
    # on a bucketed engine every prefill length is a bucket hit (or a
    # chunked prompt's first chunk)
    if eng.bucket_table is not None and not \
            lengths - {eng.chunk_tokens} <= set(eng.bucket_table.hits):
        raise AssertionError(f"prefill lengths {sorted(lengths)}, buckets "
                             f"hit {sorted(eng.bucket_table.hits)}")
    cap_s, pool_bytes = capture_cost(torch, eng.programs().values())
    tokens = sum(len(r.output) for r in res.values())
    median = statistics.median(step_ms)
    paged = f", kv_block {eng.kv_block}" if eng.paged else ""
    if eng.chunk_tokens:
        paged += f", prefill_chunk {eng.chunk_tokens}"
    paged += ", eager" if eager else ""
    row = {"model": f"{eng.cfg.arch_id} bfloat16 serving{paged}",
           "slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
           "requests": len(res), "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new, "tokens": tokens,
           "decode_steps": decode_steps, "prefills": prefills,
           "chunk_steps": chunk_steps,
           "prefill_ms": [res[u].prefill_s * 1e3 for u in sorted(res)],
           "median_decode_step_ms": median,
           "decode_step_ms_min_max": [min(step_ms), max(step_ms)],
           "weight_bound_ms": eng.param_bytes / H100_BYTES_PER_S * 1e3,
           "param_bytes": eng.param_bytes, "kv_bytes": eng.kv_bytes,
           "decode_tok_per_s": SERVE_SLOTS / median * 1e3,
           "wall_s": wall, "wall_tok_per_s": tokens / wall,
           "device_memory_bytes": mem0,
           "device_memory_growth_bytes": growth, "programs": counts,
           "prefill_lengths": sorted(lengths),
           "captures": captures(eng), "capture_s": cap_s,
           "graph_pool_bytes": pool_bytes}
    log(f"  {len(res)} requests, {tokens} tokens in {wall:.2f} s "
        f"({decode_steps} decode steps); prefill ms "
        + ", ".join(f"{p} tok {ms:.1f}" for p, ms in
                    zip(row["prompt_lens"], row["prefill_ms"])))
    how = "eager" if eager else "replayed"
    log(f"  decode step median {median:.3f} ms {how} (min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f}; {len(step_ms)} "
        f"steps without prefill) vs weight-streaming bound "
        f"{row['weight_bound_ms']:.3f} ms; {row['decode_tok_per_s']:.1f} "
        f"tok/s at {SERVE_SLOTS} slots; programs {counts}, "
        f"{row['captures']} captures in {cap_s:.2f} s, graph pools "
        f"{pool_bytes:,} B; device memory {growth:,} B above the first "
        f"step's at most (allowed {NEW_PROGRAM_BYTES:,} B a new program)")
    return row, {u: r.output for u, r in res.items()}


def serve_main(torch, np, dev, eng, prompts, what, new=SERVE_NEW):
    """A serving main path: the requests through ``eng`` once inside
    ``main_path`` (counts from 0, the launches traced), then once more
    untraced with every program held, the timed run: its tokens equal
    the first run's, it captures nothing and device memory stays at its
    first step's value.  Returns the timed run's row, with the traced
    launches, and the tokens."""
    with main_path(torch, what) as traced:
        first, served = serve_lm(torch, np, dev, eng, prompts, new=new)
    row, again = serve_lm(torch, np, dev, eng, prompts, new=new)
    if again != served or row["decode_steps"] != first["decode_steps"]:
        raise AssertionError(f"the timed run emitted {again}, the counted "
                             f"one {served}")
    if row["captures"] != first["captures"] or \
            row["device_memory_growth_bytes"]:
        raise AssertionError(f"the timed run captured "
                             f"{row['captures'] - first['captures']} "
                             f"programs, memory grew "
                             f"{row['device_memory_growth_bytes']} B")
    row["launches"] = traced
    row["traced_run"] = {k: first[k] for k in (
        "median_decode_step_ms", "device_memory_growth_bytes", "wall_s",
        "captures")}
    log(f"  timed run: the same tokens, no capture, memory flat; decode "
        f"step median {row['median_decode_step_ms']:.3f} ms (the traced "
        f"run's {first['median_decode_step_ms']:.3f} ms)")
    return row, served


def eager_twin(torch, np, dev, eng, prompts, row, served, new=SERVE_NEW):
    """The same requests through a fresh engine (``eng``) under
    ``disable_capture()``: tokens equal the replayed run's request for
    request; the eager run's row (its decode-step median, its profile)
    goes under ``row["eager"]``."""
    from repro_torch.core import disable_capture

    erow, etoks = serve_lm(torch, np, dev, eng, prompts, eager=True,
                           new=new)
    if etoks != served:
        raise AssertionError(f"replayed tokens {served} != eager {etoks}")
    with disable_capture():
        profile_decode(torch, np, eng, erow)
    row["eager"] = erow
    row["replay_tokens_equal_eager"] = True
    log(f"  replayed tokens equal the eager engine's, request for request; "
        f"decode step median {erow['median_decode_step_ms']:.3f} ms eager, "
        f"{row['median_decode_step_ms']:.3f} ms replayed (bound "
        f"{row['weight_bound_ms']:.3f} ms); busy "
        f"{100 * erow['device_busy_share']:.1f}% eager, "
        f"{100 * row['device_busy_share']:.1f}% replayed")


def private_pools(torch, np, dev, eng, prompts, served) -> int:
    """The requests through ``eng`` again with each of its programs
    captured anew in a graph pool of its own instead of the engine's
    shared one; the tokens stay ``served``.  Returns the bytes the
    programs' pools then hold."""
    from repro_torch.core import GraphPool

    programs = eng.programs().values()
    for prog in programs:
        prog.clear()
        prog.pool = GraphPool()
    torch.cuda.empty_cache()
    _, toks = serve_lm(torch, np, dev, eng, prompts)
    if toks != served:
        raise AssertionError("private graph pools changed the tokens")
    return capture_cost(torch, programs)[1]


def profile_decode(torch, np, eng, row, n_steps: int = 8) -> None:
    """Phases 7, 9, 10 and 12, after the counts are read: device time by
    operation over pure decode steps (replayed, or eager under
    ``disable_capture()``), and the share of the median step (measured
    unprofiled above, the same way) during which the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import capture_count
    from repro_torch.serving import Request

    rng = np.random.default_rng(8)
    for uid in range(SERVE_SLOTS):
        eng.submit(Request(uid=1000 + uid, tokens=rng.integers(
            0, eng.cfg.vocab - 2, 64).astype(np.int32),
            max_new_tokens=n_steps + 4,
            extras=family_extras(np, eng.cfg, 1000 + uid)))
    eng.step()                                  # admission + first step
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / n_steps / 1e3
    row["device_ms_per_decode_step"] = device_ms
    row["device_busy_share"] = device_ms / row["median_decode_step_ms"]
    row["top_device"] = [
        {"name": e.key[:80], "us_per_step": e.self_device_time_total / n_steps,
         "count_per_step": e.count / n_steps} for e in events[:8]]
    # the mean device time of each launch of K5 and K6 in the step
    per_launch = {}
    for e in events:
        if "dequant_matmul_kernel" in e.key and e.count:
            name = ("dequant_matmul_i4" if "Int4W" in e.key
                    else "dequant_matmul")
            per_launch[name] = e.self_device_time_total / e.count
    if per_launch:
        row["kernel_us_per_launch"] = per_launch
    if capture_count(eng._decode):
        # the decode program alone between two CUDA events: its graph's
        # device time plus one launch (the slots are idle by now, so the
        # repeated step writes only rows nothing reads)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        kv = ((eng.kv_pool, eng.block_tables) if eng.paged
              else (eng.cache,))
        ms = []
        for _ in range(5):
            start.record()
            eng._decode((eng.params, *kv, eng.cur_tokens, eng.lengths))
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        row["replay_event_ms"] = statistics.median(ms)
        log(f"  one replay of the decode program between CUDA events: "
            f"{row['replay_event_ms']:.3f} ms")
    log(f"  device {device_ms:.3f} ms per decode step = "
        f"{100 * row['device_busy_share']:.1f}% of the median step; top: "
        + "; ".join(f"{t['name'][:48]} {t['us_per_step']:.1f} us x"
                    f"{t['count_per_step']:.0f}"
                    for t in row["top_device"][:5])
        + "".join(f"; {name} {us:.2f} us a launch"
                  for name, us in row.get("kernel_us_per_launch",
                                          {}).items()))


def check_preemption(eng, prompts, want, new=SERVE_NEW) -> None:
    """Phases 7 and 9: a tight deadline displaces a decoding request;
    both (and the others) emit exactly the uninterrupted run's tokens.
    On a paged engine the checkpoint carries block ids, no KV, and every
    block comes back."""
    import numpy as np

    from repro_torch.serving import Request

    urgent = SERVE_SLOTS
    for uid in range(SERVE_SLOTS):
        eng.submit(Request(uid=uid, tokens=prompts[uid],
                           max_new_tokens=new,
                           extras=family_extras(np, eng.cfg, uid)))
    for _ in range(6):
        eng.step()
    eng.submit(Request(uid=urgent, tokens=prompts[urgent],
                       max_new_tokens=new, deadline_us=100,
                       extras=family_extras(np, eng.cfg, urgent)))
    eng.step()
    ckpts = list(eng._ckpt.values())
    if len(ckpts) != 1 or ckpts[0].phase != "decode":
        raise AssertionError(f"expected one decode checkpoint, got {ckpts}")
    if eng.paged and (ckpts[0].cache is not None or not ckpts[0].blocks):
        raise AssertionError("a paged checkpoint must carry blocks, not KV")
    res = eng.run()
    if eng.paged and eng.pool.free_blocks() != eng.pool.usable_blocks:
        raise AssertionError("blocks missing after preempt/restore")
    evicted = [u for u, r in res.items() if r.preemptions]
    if len(evicted) != 1 or res[urgent].preemptions:
        raise AssertionError(f"expected one eviction, got {evicted}")
    for uid, r in res.items():
        if r.output != want[uid]:
            raise AssertionError(f"request {uid} emitted {r.output} after "
                                 f"preemption, {want[uid]} uninterrupted")
    carried = (f" (checkpoint: {len(ckpts[0].blocks)} block ids, no KV)"
               if eng.paged else "")
    log(f"  EDF displacement: request {evicted[0]} evicted mid-decode "
        f"for request {urgent}, restored{carried}; all {len(res)} requests "
        f"emit their uninterrupted tokens")


def paged_gated_run(torch, np, eng, prompts, want):
    """Phase 9: a pool of two full-length slots' blocks (plus the garbage
    block) serves the phase-7 requests under the admission gate; every
    request finishes with phase 7's tokens and every block comes back."""
    from repro_torch.serving import Request

    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=SERVE_NEW))
    held, peak = 0, 0
    while True:
        more = eng.step()
        # a slot is free and the policy's pick cannot reserve its worst
        # case: the next admission waits for blocks
        held += bool(eng.queue) and not eng.active.all() and not \
            eng._paged_admissible(eng.queue[eng.policy.select(eng.queue)])
        peak = max(peak, eng.pool.usable_blocks - eng.pool.free_blocks())
        if not more:
            break
    got = {u: r.output for u, r in eng.results.items()}
    if got != want or not all(r.done for r in eng.results.values()):
        raise AssertionError(f"gated pool: tokens {got} != {want}")
    if eng.pool.free_blocks() != eng.pool.usable_blocks:
        raise AssertionError("gated pool: blocks missing at the end")
    log(f"  pool of {eng.pool.n_blocks} blocks (two full-length slots): "
        f"{len(got)} requests finish with phase 7's tokens; at most {peak} "
        f"blocks promised at once, the gate held a request back at "
        f"{held} steps")
    return {"pool_blocks": eng.pool.n_blocks, "peak_blocks_promised": peak,
            "steps_gate_held": held, "tokens_equal": True}


def slot_rows(torch, eng, slot, n):
    """Positions 0..n-1 of ``slot`` gathered from the pool through its
    table row: {k, v} of (L, KH, n, dh)."""
    idx = torch.from_numpy(eng._table_row(slot)).long().to(eng.device)
    out = {}
    for name, pool in eng.kv_pool.items():
        l, _, kh, bs, dh = pool.shape
        rows = pool[:, idx].transpose(1, 2).reshape(l, kh, -1, dh)
        out[name] = rows[:, :, :n].float()
    return out


def paged_chunked_run(torch, np, engine, prompts, want):
    """Phase 9: ``prefill_chunk=CHUNK`` on the paged engine serves every
    request; then the longest prompt's K/V rows after chunked prefill
    against those after one-shot prefill: layer 0 within one bfloat16
    rounding of each row's largest entry, the last layer's difference
    reported."""
    from repro_torch.serving import Request

    eng = engine(kv_block=PAGED_BLOCK, prefill_chunk=CHUNK)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=SERVE_NEW))
    chunks = 0
    while eng.step():
        chunks += eng.last_step["chunks"]
    res = eng.results
    if not all(r.done and r.output for r in res.values()):
        raise AssertionError("chunked prefill: a request did not finish")
    if eng.pool.free_blocks() != eng.pool.usable_blocks:
        raise AssertionError("chunked prefill: blocks missing at the end")
    same = sum(res[u].output == want[u] for u in res)
    del eng
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    m = len(prompts[longest]) - 1
    rows = []
    for kw in ({"prefill_chunk": CHUNK}, {}):
        e = engine(kv_block=PAGED_BLOCK, **kw)
        e.submit(Request(uid=0, tokens=prompts[longest], max_new_tokens=2))
        while not e.results[0].output:
            e.step()
        rows.append(slot_rows(torch, e, 0, m))
        e.run()
    diffs = {}
    for name in ("k", "v"):
        chunked, oneshot = rows[0][name], rows[1][name]
        d = (chunked - oneshot).abs()
        ulps = row_ulps(torch, chunked, oneshot)
        worst0 = ulps[0].max().item()
        if worst0 > 1.0:
            raise AssertionError(f"chunked vs one-shot prefill, layer 0 "
                                 f"{name}: {worst0:.3g} ulps of the row max")
        diffs[name] = {"layer0_max_ulps_of_row_max": worst0,
                       "layer0_max_abs": d[0].max().item(),
                       "last_layer_max_abs": d[-1].max().item(),
                       "last_layer_max_ulps_of_row_max":
                           ulps[-1].max().item()}
    log(f"  prefill_chunk={CHUNK}: {len(res)} requests finish, {chunks} "
        f"chunk steps, {same} of {len(res)} emit phase 7's tokens; prompt "
        f"of {m + 1} tokens, chunked vs one-shot K/V rows: layer 0 within "
        + ", ".join(f"{n} {v['layer0_max_ulps_of_row_max']:.2f}"
                    for n, v in diffs.items())
        + " ulps of the row max, last layer max |d| "
        + ", ".join(f"{n} {v['last_layer_max_abs']:.3g}"
                    for n, v in diffs.items()))
    return {"chunk": CHUNK, "requests": len(res), "chunk_steps": chunks,
            "requests_with_phase7_tokens": same, "compared_prompt": m + 1,
            "kv_chunked_vs_oneshot": diffs}


def reduced_card_vs_cpu(torch, np, dev):
    """Phase 8: yi-6b reduced, float32: the engine on the card and on the
    CPU emit identical greedy tokens, contiguous and with
    ``kv_block=8, prefill_chunk=8`` (which must also equal the contiguous
    CPU engine's), and quantized: int8 weights and KV contiguous, int4
    weights and int8 KV paged."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(LM_ARCH, reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (5, 30, 1, 70, 12, 40)]
    outs = {}
    runs = {"float": {},
            "float paged+chunked": {"kv_block": 8, "prefill_chunk": 8},
            "int8/int8": {"weight_dtype": "int8", "kv_dtype": "int8"},
            "int4/int8 paged": {"weight_dtype": "int4", "kv_dtype": "int8",
                                "kv_block": 8}}
    for label, kw in runs.items():
        for where in ("cpu", dev):
            eng = ServingEngine(bundle, model.to(where), max_slots=4,
                                cache_len=64, device=where, **kw)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid=uid, tokens=p, max_new_tokens=40))
            outs[label, str(where)] = {u: r.output
                                       for u, r in eng.run().items()}
    for (label, where), got in outs.items():
        # the float runs all equal the contiguous CPU engine; each
        # quantized run equals its own configuration on the CPU
        want = outs["float" if label.startswith("float") else label, "cpu"]
        if got != want:
            raise AssertionError(f"reduced {LM_ARCH} {label} on {where}: "
                                 f"tokens {got} != {want}")
    n = sum(len(o) for o in outs["float", "cpu"].values())
    log(f"  {cfg.arch_id}: {len(prompts)} requests, {n} tokens; card == CPU "
        f"contiguous and with kv_block=8, prefill_chunk=8 (== contiguous), "
        f"and quantized int8/int8 contiguous and int4/int8 paged")
    return {"model": f"{cfg.arch_id} float32 card vs CPU, contiguous, "
                     f"paged+chunked, int8/int8, int4/int8 paged",
            "requests": len(prompts), "tokens": n, "tokens_equal": True}


# ---------------------------------------------------------------------------
# phase 10: quantized serving (Yi-6B)
# ---------------------------------------------------------------------------

LOGIT_STEPS = 16
# teacher-forced max |dlogit| over the reference's largest |logit|:
# int8 weights (per-channel scales) and/or an int8 KV cache against the
# bf16 engine; quantization error, held for int8 (the int4 one is only
# reported: on random weights it is of the logits' own size)
INT8_VS_BF16_RTOL = 0.25
# the resident footprint against bfloat16: int8 weights carry their
# float32 scales, int4 ones too, int8 KV one float32 scale per 128
WEIGHT_RATIO = {"int8": 1.9, "int4": 3.6}
KV_RATIO = 1.9


def kernel_of(name: str):
    """The kernel whose wrapper launched the device function ``name`` (a
    symbol in a torch.profiler trace), by the one function each launch
    of the wrapper runs: K3, K4 and K7 run one function of K3's device
    code and differ in its template arguments; K8 runs one state pass or
    one single-chunk kernel a call.  None for any other function."""
    if "decode_simt_kernel" in name or "decode_mma_kernel" in name:
        if "ContiguousRows" in name:
            return "decode_attention"
        return ("paged_decode_attention_q" if "RowScale" in name
                else "paged_decode_attention")
    if "dequant_matmul_kernel" in name:
        return "dequant_matmul_i4" if "Int4W" in name else "dequant_matmul"
    if "quant_matmul_rows" in name or "quant_matmul_kernel" in name:
        return "quant_matmul"
    if "flash_attention_kernel" in name:
        return "flash_attention"
    if "state_pass_kernel" in name or "one_chunk_kernel" in name:
        return "ssd_scan"
    return None


# marker kernels main_path launches around a traced run, by a function of
# their own (no path computes a Bessel function): i0e before the run, i1e
# after it
LEAD_MARKER, TRAIL_MARKER = "i0e", "i1e"


def trace_records(prof):
    """(each kernel's launches, the lead-in markers, the trailing markers)
    in a torch.profiler trace of the device, read from the trace's raw
    records (``key_averages`` would build an event object for each of the
    run's ~10^5 launches)."""
    from torch.autograd import DeviceType

    from repro_torch.kernels import _build

    counts = dict.fromkeys(_build.launches, 0)
    lead = trail = 0
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name not in names:
            names[name] = kernel_of(name)
            if names[name] is None:
                names[name] = (LEAD_MARKER if LEAD_MARKER in name else
                               TRAIL_MARKER if TRAIL_MARKER in name else None)
        kind = names[name]
        if kind == LEAD_MARKER:
            lead += 1
        elif kind == TRAIL_MARKER:
            trail += 1
        elif kind is not None:
            counts[kind] += 1
    return counts, lead, trail


def trace_launches(prof):
    """Each kernel's launches in a torch.profiler trace of the device."""
    return trace_records(prof)[0]


# The trace keeps only the device records whose timestamps fall inside its
# window on the host clock, and the records at its edges can come back with
# timestamps hundreds of ms off, so those are dropped (on the H100 machine:
# in many traces the records of its first ~0.5 s, and now and then one at
# its end; the markers' counts in each phase's log line show it).  A lead-in of marker kernels, one every
# TRACE_TICK_S for TRACE_LEAD_S, lets the timestamps settle before the main
# path starts; TRACE_TRAIL_S of trailing markers, then TRACE_MARGIN_S idle,
# close the window.  The lead-in's last TRACE_SETTLED markers and every
# trailing one must be in the trace, so a run the window did not cover is
# named as such.
TRACE_LEAD_S, TRACE_TRAIL_S, TRACE_TICK_S = 1.5, 0.25, 0.01
TRACE_MARGIN_S = 0.25
TRACE_SETTLED = 10


def trace_markers(torch, probe, fn, seconds: float) -> int:
    """``fn(probe)`` launched and waited for once every ``TRACE_TICK_S``
    over ``seconds``; returns how many were launched."""
    n, end = 0, time.perf_counter() + seconds
    while time.perf_counter() < end:
        fn(probe)
        torch.cuda.synchronize()
        n += 1
        time.sleep(TRACE_TICK_S)
    return n


def trace_device_us(prof):
    """(the summed device µs of every record in a torch.profiler trace of
    the device but the markers, the µs by record name)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() == DeviceType.CUDA and LEAD_MARKER not in name
                and TRAIL_MARKER not in name):
            by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e3
    return sum(by_name.values()), by_name


@contextlib.contextmanager
def main_path(torch, what: str, device_time=None):
    """Drive a main path inside the block: every launch count is set to
    0 just before it and the device is traced by torch.profiler over
    it, between a lead-in and a tail of marker kernels.  After it, the
    trace must hold the lead-in's last markers and every trailing one,
    and each kernel's launches counted in the trace must equal its
    wrapper's count (``_build.launches``: the eager launches plus what
    each replay's capture recorded); the yielded dict is filled with the
    traced counts.  A ``device_time`` dict gets the run's device µs
    under ``"us"`` and by record name under ``"by_name"``
    (``trace_device_us``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    traced = {}
    probe = torch.ones(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        n_lead = trace_markers(torch, probe, torch.special.i0e, TRACE_LEAD_S)
        for name in _build.launches:
            _build.launches[name] = 0
        yield traced
        torch.cuda.synchronize()
        counted = dict(_build.launches)
        n_trail = trace_markers(torch, probe, torch.special.i1e,
                                TRACE_TRAIL_S)
        time.sleep(TRACE_MARGIN_S)
    counts, lead, trail = trace_records(prof)
    traced.update(counts)
    if device_time is not None:
        device_time["us"], device_time["by_name"] = trace_device_us(prof)
    if lead < TRACE_SETTLED or lead > n_lead or trail != n_trail:
        raise AssertionError(
            f"{what}: the trace holds {lead} of the {n_lead} lead-in markers "
            f"(at least the last {TRACE_SETTLED} needed) and {trail} of the "
            f"{n_trail} trailing ones: its window did not cover the run")
    if traced != counted:
        raise AssertionError(f"{what}: launches in the trace {traced}, the "
                             f"wrappers counted {counted}")
    log(f"  launches on {what}, traced on the device (equal to the "
        f"wrappers' counts): "
        + ", ".join(f"{k} {n}" for k, n in traced.items() if n)
        + f"; lead-in markers traced {lead} of {n_lead}")


def teacher_forced_logits(torch, np, dev, bundle, model, prompt, want=None,
                          extras=None, **kw):
    """The largest |logit| difference between a reference engine
    (``want``'s keywords; by default the bf16 engine) and a quantized one
    (``kw``) over the prefill and ``LOGIT_STEPS`` decode steps, both fed
    the reference's greedy tokens; batch 1, contiguous KV; ``extras``
    the request's (PaliGemma's patch embeddings)."""
    from repro_torch.core import disable_capture
    from repro_torch.serving import ServingEngine

    def engine(**q):
        return ServingEngine(bundle, model, max_slots=1,
                             cache_len=SERVE_CACHE, prefill_buckets=False,
                             device=dev, **q)
    feng, qeng = engine(**(want or {})), engine(**kw)
    v = bundle.cfg.vocab
    # a comparison on new tensors at every step: run eagerly
    with torch.no_grad(), disable_capture():
        lf, cf = feng._run_prefill(prompt[:-1], extras)
        lq, cq = qeng._run_prefill(prompt[:-1], extras)
        err = (lf[..., :v].float() - lq[..., :v].float()).abs().max().item()
        top = lf[..., :v].float().abs().max().item()
        pos, cur = feng._vis() + len(prompt) - 1, int(prompt[-1])
        for _ in range(LOGIT_STEPS):
            curs = torch.tensor([[cur]], device=dev)
            lens = torch.tensor([pos], dtype=torch.int32, device=dev)
            lf, cf = feng._decode((feng.params, cf, curs, lens))
            lq, cq = qeng._decode((qeng.params, cq, curs, lens))
            err = max(err, (lf[:, :v].float()
                            - lq[:, :v].float()).abs().max().item())
            top = max(top, lf[:, :v].float().abs().max().item())
            cur = int(lf[0, :v].float().argmax())
            pos += 1
    del feng, qeng, cf, cq
    return err, top


def check_logits(label, err, top, rtol) -> dict:
    """A teacher-forced comparison's reading, held to ``rtol`` of the
    reference's largest |logit| (reported only where ``rtol`` is
    None)."""
    out = {"max_abs_dlogit": err, "max_abs_logit": top, "rtol": rtol}
    if rtol is not None and err > rtol * top:
        raise AssertionError(f"{label}: max |dlogit| {err:.4g} > {rtol} x "
                             f"the largest |logit| {top:.4g}")
    log(f"  {label}, {LOGIT_STEPS} teacher-forced steps: max |dlogit| "
        f"{err:.4g}, {err / top:.4g} of the largest |logit| {top:.4g}"
        + (f" (limit {rtol})" if rtol is not None else " (reported)"))
    return out


def quantized_serving(torch, np, dev):
    """Phase 10: Yi-6B at full width with ``QUANT_LAYERS`` of its layers
    (seed 0), quantized on the card, and phase 7's requests through (a)
    int8 weights and KV, contiguous, (b) the same paged with blocks of
    16, (c) int4 weights and int8 KV, paged.  Each run counts its kernels
    from 0, keeps memory flat and its cache in place (``serve_lm``); (b)
    emits (a)'s tokens and (b) preempted and restored emits them too;
    each run's resident bytes and tokens against the bf16 engine of the
    same model.  Returns the runs' rows and each kernel's launches on its
    run."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    bundle = get_model(dataclasses.replace(get_config(LM_ARCH),
                                           n_layers=QUANT_LAYERS))
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    prompts = serving_workload(np, bundle.cfg.vocab)
    engine = family_engine(dev, bundle, model)
    fp_rows = {}
    for name, kw in (("contiguous", {}), ("paged",
                                          {"kv_block": PAGED_BLOCK})):
        eng = engine(**kw)
        fp_rows[name] = {"param_bytes": eng.param_bytes,
                         "kv_bytes": eng.kv_bytes}
        if name == "contiguous":
            _, served = serve_lm(torch, np, dev, eng, prompts)
        del eng
    n_layers = bundle.cfg.n_layers
    runs = {"a": {"weight_dtype": "int8", "kv_dtype": "int8"},
            "b": {"weight_dtype": "int8", "kv_dtype": "int8",
                  "kv_block": PAGED_BLOCK},
            "c": {"weight_dtype": "int4", "kv_dtype": "int8",
                  "kv_block": PAGED_BLOCK}}
    rows, toks, path_launches = {}, {}, {}
    for key, kw in runs.items():
        eng = engine(**kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        row, toks[key] = serve_main(torch, np, dev, eng, prompts,
                                    f"quantized run ({key})")
        counts = row["launches"]
        steps = row["decode_steps"]
        mm = "dequant_matmul_i4" if kw["weight_dtype"] == "int4" \
            else "dequant_matmul"
        attn = ("paged_decode_attention_q" if kw.get("kv_block")
                else "decode_attention")
        want = {name: 0 for name in counts}
        want[mm] = 3 * n_layers * steps
        want[attn] = n_layers * steps
        if counts != want:
            raise AssertionError(f"({key}) launches {counts}, expected "
                                 f"{want}")
        # K5 on (a), K7 on (b), K6 on (c); K3's path is phase 7
        for name in (mm, attn):
            if name != "decode_attention":
                path_launches.setdefault(name, counts[name])
        fp = fp_rows["paged" if kw.get("kv_block") else "contiguous"]
        row.update(
            model=f"{bundle.cfg.arch_id} serving, {kw['weight_dtype']} "
                  f"weights, int8 KV"
                  + (f", kv_block {PAGED_BLOCK}" if kw.get("kv_block")
                     else ""),
            launches=counts,
            weight_ratio_vs_bf16=fp["param_bytes"] / row["param_bytes"],
            kv_ratio_vs_bf16=fp["kv_bytes"] / row["kv_bytes"],
            peak_above_resident_bytes=(torch.cuda.max_memory_allocated()
                                       - resident),
            tokens_equal_bf16=sum(a == b for u in served for a, b in
                                  zip(toks[key][u], served[u])),
            requests_equal_bf16=sum(toks[key][u] == served[u]
                                    for u in served),
            tokens=sum(len(t) for t in toks[key].values()))
        if row["weight_ratio_vs_bf16"] < WEIGHT_RATIO[kw["weight_dtype"]] \
                or row["kv_ratio_vs_bf16"] < KV_RATIO:
            raise AssertionError(f"({key}) resident bytes: weights "
                                 f"{row['weight_ratio_vs_bf16']:.3f}x, KV "
                                 f"{row['kv_ratio_vs_bf16']:.3f}x smaller "
                                 f"than bf16")
        log(f"  ({key}) weights {row['param_bytes']:,} B "
            f"({row['weight_ratio_vs_bf16']:.3f}x smaller than bf16), KV "
            f"{row['kv_bytes']:,} B ({row['kv_ratio_vs_bf16']:.3f}x); peak "
            f"{row['peak_above_resident_bytes']:,} B above the resident "
            f"bytes; {row['tokens_equal_bf16']} of {row['tokens']} greedy "
            f"tokens at the bf16 engine's positions equal its, "
            f"{row['requests_equal_bf16']} of {len(served)} requests "
            f"whole")
        profile_decode(torch, np, eng, row)
        row["private_pools_bytes"] = private_pools(torch, np, dev, eng,
                                                   prompts, toks[key])
        log(f"  ({key}) graph pool {row['graph_pool_bytes']:,} B shared by "
            f"the engine's programs; {row['private_pools_bytes']:,} B with "
            f"a pool for each program")
        del eng
        eager_twin(torch, np, dev, engine(**kw), prompts, row, toks[key])
        torch.cuda.empty_cache()
        rows[key] = row
    if toks["b"] != toks["a"]:
        raise AssertionError(f"paged int8-KV tokens {toks['b']} != "
                             f"contiguous ones {toks['a']}")
    log("  (b) paged int8 KV emits (a)'s contiguous tokens, request for "
        "request; every block came back")
    check_preemption(engine(policy="edf", preempt="edf-displace",
                            clock=lambda: 0, **runs["b"]), prompts, toks["b"])
    longest = max(prompts, key=len)
    for key in ("a", "c"):
        err, top = teacher_forced_logits(
            torch, np, dev, bundle, model, longest,
            weight_dtype=runs[key]["weight_dtype"], kv_dtype="int8")
        rows[key]["max_abs_dlogit_vs_bf16"] = err
        rows[key]["max_abs_logit_bf16"] = top
        check_logits(f"({key}) vs the bf16 engine, prompt of {len(longest)} "
                     f"tokens", err, top,
                     INT8_VS_BF16_RTOL if key == "a" else None)
    return list(rows.values()), path_launches


# ---------------------------------------------------------------------------
# phases 8, 11-12: recurrent-state serving (Mamba2-780m, Zamba2-1.2B)
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "zamba2-1.2b"
# phases 12 and 18's depth: half of Mamba2-780m's 48 layers, 18 of
# Zamba2-1.2B's 38 (the shared block after every 6th, 3 times); phases
# 26 and 27 need the script's time
RECURRENT_LAYERS = {SSM_ARCH: 24, HYBRID_ARCH: 18}
# float32 Mamba2-780m, K8 against the plain scan: the two sum in other
# orders; the stated bound is relative to the largest entry of each
# compared tensor (a layer's states, a step's logits)
SSM_RTOL = 1e-4


def reduced_recurrent_card_vs_cpu(torch, np, dev):
    """Phase 8: mamba2-780m and zamba2-1.2b reduced, float32: the engine on
    the card (K8 under the prefill and chunk scans) and on the CPU (the
    plain scan) emit identical greedy tokens, exact and with
    ``prefill_chunk=8``."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, ServingEngine

    tokens = []
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = get_config(arch, reduced=True)
        bundle = get_model(cfg)
        model = bundle.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(10)
        prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
                   for n in (21, 13, 30, 1, 9, 40)]
        n = 0
        for kw in ({}, {"prefill_chunk": 8}):
            outs = []
            for where in ("cpu", dev):
                eng = ServingEngine(bundle, model.to(where), max_slots=4,
                                    cache_len=64, device=where, **kw)
                for uid, p in enumerate(prompts):
                    eng.submit(Request(uid=uid, tokens=p, max_new_tokens=24))
                outs.append({u: r.output for u, r in eng.run().items()})
            if outs[0] != outs[1]:
                raise AssertionError(f"reduced {arch} {kw} on the card: "
                                     f"tokens {outs[1]} != CPU {outs[0]}")
            n += sum(len(o) for o in outs[0].values())
        tokens.append(n)
        log(f"  {cfg.arch_id}: {len(prompts)} requests, card == CPU exact "
            f"and with prefill_chunk=8 ({n} tokens)")
    return {"model": f"{SSM_ARCH}, {HYBRID_ARCH} reduced float32 card vs "
                     f"CPU, exact and prefill_chunk=8",
            "tokens": tokens, "tokens_equal": True}


def _rel(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def ssm_teacher_forced(torch, np, dev):
    """Phase 11: Mamba2-780m at full width in float32: 4 seeded prompts
    prefilled one-shot through ``ssm_prefill`` with the scan on K8 and
    with the plain scan (final conv windows, SSD states and logits
    within ``SSM_RTOL`` of the largest entry), 16 teacher-forced decode
    steps from each state (fed the plain run's greedy tokens), and the
    chunked prefill (chunks of 128 from an empty cache, K8 with the
    carried state as h0) against the one-shot K8 cache."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model, ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32")
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(11)
    # one-shot prefills of 512, 128, 77 and 384 tokens: each at most 128
    # or a multiple of 128, the reference's contract
    prompts = [rng.integers(0, cfg.vocab - 2, n) for n in (513, 129, 78,
                                                          385)]
    kernel = ops.ssd_chunked_kernel
    caches = {k: bundle.empty_cache(len(prompts), 0, torch.float32, dev)
              for k in ("kernel", "plain")}
    worst = {"prefill_logits": 0.0, "state": 0.0, "conv": 0.0,
             "chunked_state": 0.0, "chunked_conv": 0.0, "decode_logits": 0.0}
    chunk = 128
    with torch.no_grad():
        for i, p in enumerate(prompts):
            toks = torch.as_tensor(p[None, :-1], device=dev)
            lk, ck = ssm.ssm_prefill(model, cfg, toks, ssd_impl=kernel)
            lp, cp = ssm.ssm_prefill(model, cfg, toks)
            worst["prefill_logits"] = max(worst["prefill_logits"],
                                          _rel(lk, lp))
            for name in ("state", "conv"):
                worst[name] = max(worst[name], max(
                    _rel(ck[name][l], cp[name][l])
                    for l in range(cfg.n_layers)))
            m = toks.shape[1]
            one = bundle.empty_cache(1, 0, torch.float32, dev)
            for start in range(0, m, chunk):
                piece = torch.zeros((1, chunk), dtype=toks.dtype, device=dev)
                real = min(chunk, m - start)
                piece[:, :real] = toks[:, start:start + real]
                ssm.ssm_prefill_chunk(model, cfg, one, piece, real,
                                      ssd_impl=kernel)
            for name in ("state", "conv"):
                worst["chunked_" + name] = max(worst["chunked_" + name], max(
                    _rel(one[name][l], ck[name][l])
                    for l in range(cfg.n_layers)))
            for key, c in (("kernel", ck), ("plain", cp)):
                for name in ("conv", "state"):
                    caches[key][name][:, i:i + 1].copy_(c[name])
        lengths = torch.tensor([len(p) - 1 for p in prompts],
                               dtype=torch.int32, device=dev)
        cur = torch.tensor([[int(p[-1])] for p in prompts], device=dev)
        for _ in range(TF_STEPS):
            want, _ = ssm.ssm_decode(model, cfg, caches["plain"], cur,
                                     lengths)
            got, _ = ssm.ssm_decode(model, cfg, caches["kernel"], cur,
                                    lengths)
            if not torch.isfinite(got).all():
                raise AssertionError("teacher-forced Mamba2 logits not "
                                     "finite")
            worst["decode_logits"] = max(worst["decode_logits"],
                                         _rel(got, want))
            cur = want[:, :cfg.vocab].argmax(dim=-1, keepdim=True)
            lengths += 1
    del model, caches
    torch.cuda.empty_cache()
    log(f"  {cfg.arch_id} float32, {n_params:,} parameters, prompts of "
        f"{[len(p) for p in prompts]}: K8 vs the plain scan, largest "
        f"difference over the largest entry: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (bound {SSM_RTOL})")
    bad = {k: v for k, v in worst.items() if not v <= SSM_RTOL}
    if bad:
        raise AssertionError(f"Mamba2 float32, K8 vs the plain scan: {bad} "
                             f"beyond {SSM_RTOL} of the largest entry")
    return {"model": f"{cfg.arch_id} float32 one-shot and chunked prefill "
                     f"on K8 vs the plain scan, {TF_STEPS} teacher-forced "
                     f"decode steps", "parameters": n_params,
            "prompt_lens": [len(p) for p in prompts],
            "max_rel_diff": worst, "bound": SSM_RTOL}


def recurrent_workload(np, vocab, seed, n, lo, hi, contract):
    """``n`` seeded prompts; with ``contract`` their lengths less one are
    64-128 or 256/384/512 (one-shot prefill's lengths), else ``lo``-``hi``
    tokens."""
    rng = np.random.default_rng(seed)
    if contract:
        lens = [int(rng.integers(64, 129)) + 1 for _ in range(n - n // 2)]
        lens += [m + 1 for m in (512, 384, 256, 512)[:n // 2]]
    else:
        lens = [int(v) for v in rng.integers(lo, hi + 1, n)]
    return [rng.integers(0, vocab - 2, m).astype(np.int32) for m in lens]


def profile_prefill(torch, np, eng, row, prompt) -> None:
    """Device time by operation of one one-shot prefill of ``prompt``, and
    its share of the host time around the same call (unprofiled): the
    engine's prefill program replayed, then eagerly under
    ``disable_capture()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import disable_capture
    from repro_torch.kernels import ssd_scan as K8

    for key, ctx in (("prefill_profile", contextlib.nullcontext()),
                     ("eager_prefill_profile", disable_capture())):
        with torch.no_grad(), ctx:
            eng._run_prefill(prompt[:-1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._run_prefill(prompt[:-1])
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng._run_prefill(prompt[:-1])
                torch.cuda.synchronize()
            k8_calls = trace_launches(prof)["ssd_scan"]
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        device = sum(e.self_device_time_total for e in events) / 1e3
        # K8's three kernels (chunk_state, state_pass, chunk_output) a call
        k8_us = sum(e.self_device_time_total for e in events
                    if any(k in e.key for k in K8.KERNEL_NAMES))
        prof_row = row[key] = {
            "tokens": len(prompt) - 1, "host_ms": host, "device_ms": device,
            "busy_share": device / host,
            "ssd_scan_us": k8_us, "ssd_scan_calls": k8_calls,
            "ssd_scan_us_per_launch": k8_us / max(k8_calls, 1),
            "top_device": [{"name": e.key[:80],
                            "us": e.self_device_time_total,
                            "count": e.count} for e in events[:8]]}
        log(f"  prefill of {len(prompt) - 1} tokens, "
            f"{'eager' if 'eager' in key else 'replayed'}: host {host:.2f} "
            f"ms, device {device:.2f} ms ({100 * device / host:.1f}% busy); "
            f"K8 {k8_us / 1e3:.3f} ms in {k8_calls} calls "
            f"({k8_us / max(k8_calls, 1):.2f} us a call); top: "
            + "; ".join(f"{t['name'][:48]} {t['us']:.0f} us x{t['count']}"
                        for t in prof_row["top_device"][:5]))


def profile_chunked_prefill(torch, eng, row, prompt) -> None:
    """Device time of one chunked prefill of ``prompt`` on a chunking
    engine (its chunk steps alone, replayed), beside the host time of the
    same calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    req = Request(uid=30_000, tokens=prompt, max_new_tokens=1)
    eng.submit(req)
    eng.queue.remove(req)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._start_chunked(req, 0)
        chunks = 1
        while 0 in eng._chunking:
            eng._advance_chunk(0)
            chunks += 1
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    eng.run()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    row["chunked_prefill_profile"] = {"tokens": len(prompt) - 1,
                                      "chunks": chunks, "host_ms": host,
                                      "device_ms": device}
    log(f"  chunked prefill of {len(prompt) - 1} tokens in {chunks} chunk "
        f"steps, replayed (profiled): host {host:.2f} ms, device "
        f"{device:.2f} ms ({100 * device / host:.1f}% busy)")


def timed_prefill(eng, prompt, n: int = 3) -> float:
    """Median ms of ``n`` prefills of ``prompt`` through ``eng``, one
    request at a time after one untimed, each to its completion on the
    device (the request's ``prefill_s``: one-shot, or the sum of its
    chunk steps)."""
    from repro_torch.serving import Request

    times = []
    for i in range(n + 1):
        uid = 20_000 + i
        eng.submit(Request(uid=uid, tokens=prompt, max_new_tokens=1))
        eng.run()
        times.append(eng.results[uid].prefill_s * 1e3)
    return statistics.median(times[1:])


def recurrent_serving(torch, np, dev, arch, n_requests, *, preempt):
    """Phase 12: ``arch`` at full width with ``RECURRENT_LAYERS[arch]`` of
    its layers in bfloat16 through
    ``ServingEngine(..., max_slots=4, cache_len=2048, device="cuda")``:
    (a) one-shot prefill, prompts inside the reference's contract, (b)
    ``prefill_chunk=128``, prompts of 100-600 tokens.  Counts set to 0
    just before each run: K8 launched once per Mamba layer per one-shot
    prefill and per chunk step, no other kernel; the cache in place and
    memory flat (``serve_lm``); the profile of a decode step and of a
    512-token prefill on (a); with ``preempt``, an EDF displacement on
    (a) emits the uninterrupted tokens.  Returns (rows, K8's launches on
    each run)."""
    from repro_torch.configs import get_config
    from repro_torch.core import disable_capture
    from repro_torch.models import get_model
    from repro_torch.serving import ServingEngine

    bundle = get_model(dataclasses.replace(
        get_config(arch), n_layers=RECURRENT_LAYERS[arch]))
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    n_layers, vocab = bundle.cfg.n_layers, bundle.cfg.vocab

    def engine(**kw):
        return ServingEngine(bundle, model, max_slots=SERVE_SLOTS,
                             cache_len=SERVE_CACHE,
                             tags=("cuda", "reference"), device=dev, **kw)
    runs = {"a": ({}, recurrent_workload(np, vocab, 12, n_requests, 0, 0,
                                         True)),
            "b": ({"prefill_chunk": CHUNK},
                  recurrent_workload(np, vocab, 13, n_requests, 100, 600,
                                     False))}
    rows, launches, served = [], {}, {}
    for key, (kw, prompts) in runs.items():
        eng = engine(**kw)
        row, served[key] = serve_main(torch, np, dev, eng, prompts,
                                      f"{arch} run ({key})")
        counts = row["launches"]
        want = {name: 0 for name in counts}
        want["ssd_scan"] = n_layers * (row["prefills"] + row["chunk_steps"])
        if counts != want or not want["ssd_scan"]:
            raise AssertionError(f"({key}) launches {counts}, expected "
                                 f"{want} ({n_layers} layers x "
                                 f"({row['prefills']} prefills + "
                                 f"{row['chunk_steps']} chunk steps))")
        launches[key] = counts["ssd_scan"]
        profile_decode(torch, np, eng, row)
        if key == "a":
            profile_prefill(torch, np, eng, row,
                            max(prompts, key=len))
        # a 512-token prompt's prefill, one-shot on (a), in chunks of
        # CHUNK on (b), replayed and eager
        long_prompt = recurrent_workload(np, vocab, 14, 2, 0, 0, True)[-1]
        row["prefill_512_ms"] = timed_prefill(eng, long_prompt)
        with disable_capture():
            row["eager_prefill_512_ms"] = timed_prefill(eng, long_prompt)
        log(f"  ({key}) a {len(long_prompt) - 1}-token prompt's prefill "
            f"({'one-shot' if key == 'a' else f'chunks of {CHUNK}'}): "
            f"{row['prefill_512_ms']:.2f} ms replayed, "
            f"{row['eager_prefill_512_ms']:.2f} ms eager")
        if key == "b":
            profile_chunked_prefill(torch, eng, row, long_prompt)
        del eng
        eager_twin(torch, np, dev, engine(**kw), prompts, row, served[key])
        torch.cuda.empty_cache()
        rows.append(row)
    if preempt:
        check_preemption(engine(policy="edf", preempt="edf-displace",
                                clock=lambda: 0), runs["a"][1], served["a"])
    del model
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# phases 15-18: MoE, VLM, encoder-decoder and quantized recurrent serving
# ---------------------------------------------------------------------------

MOE_ARCH, MOE2_ARCH = "deepseek-moe-16b", "qwen3-moe-30b-a3b"
# Qwen3-MoE-30B-A3B at full width with 4 of its 48 layers (its 32/4/128
# heads and 128 experts per layer are what this checks; 48 layers would
# add 57 GB of bf16 weights beside DeepSeek's)
MOE2_LAYERS = 4
# phase 15's DeepSeek-MoE-16B: the dense first block and 9 MoE layers of
# its 28 (phases 26 and 27 need the script's time)
MOE_LAYERS = 10
VLM_ARCH, AUDIO_ARCH = "paligemma-3b", "whisper-large-v3"
# phases 16 and 17's depth: half of PaliGemma-3B's 18 layers and of
# Whisper-large-v3's 32 encoder and 32 decoder layers (phases 26 and 27
# need the script's time)
VLM_LAYERS, AUDIO_LAYERS = 9, 16
# requests a run: more than the 4 slots, so admission waits and a
# fifth request is there for the preemption check; new tokens each
N_FAMILY, FAMILY_NEW = 5, 16


def family_workload(np, vocab, seed, lo, hi):
    """``N_FAMILY`` seeded prompts of ``lo``-``hi`` tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 2, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi + 1, N_FAMILY)]


def family_engine(dev, bundle, model):
    """The phase's engine factory: 4 slots of 2048 positions on the card
    under the ``("cuda", "reference")`` tags, keywords on top."""
    from repro_torch.serving import ServingEngine

    def engine(**kw):
        return ServingEngine(bundle, model, max_slots=SERVE_SLOTS,
                             cache_len=SERVE_CACHE,
                             tags=("cuda", "reference"), device=dev, **kw)
    return engine


def describe(kw) -> str:
    return ", ".join(f"{k}={v}" for k, v in kw.items()) or "defaults"


def family_run(torch, np, dev, engine, prompts, label, kw, per_step):
    """One run of a family's main path through ``engine(**kw)``
    (``serve_main``: counted from 0 and traced, then the timed run).
    Each kernel's launches must equal ``per_step[name]`` x the decode
    steps, every other kernel's 0.  Returns (engine, row, tokens)."""
    t0 = time.perf_counter()
    eng = engine(**kw)
    row, toks = serve_main(torch, np, dev, eng, prompts,
                           f"{label} ({describe(kw)})", new=FAMILY_NEW)
    row["run_s"] = time.perf_counter() - t0
    log(f"  {label}: engine built and both runs in {row['run_s']:.1f} s")
    steps = row["decode_steps"]
    want = dict.fromkeys(row["launches"], 0)
    want.update({name: n * steps for name, n in per_step.items()})
    if row["launches"] != want:
        raise AssertionError(f"{label} ({describe(kw)}): launches "
                             f"{row['launches']}, expected {want} "
                             f"({steps} decode steps)")
    row["model"] = f"{eng.cfg.arch_id} bfloat16 serving, {describe(kw)}"
    return eng, row, toks


def same_tokens(label, got, want) -> None:
    if got != want:
        raise AssertionError(f"{label}: tokens {got} != {want}")
    log(f"  {label}: the same tokens, request for request")


def row_ulps(torch, got, want):
    """|got - want| in bfloat16 ulps of each row's largest |entry| of
    ``want`` (2^(floor(log2) - 7)), both (..., rows, dh) float32."""
    top = want.abs().amax(dim=-1, keepdim=True).clamp_min(2 ** -126)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)


def bucketed_vs_exact(torch, np, exact, bucketed, prompts):
    """Each prompt's prefill through the exact-length engine and through
    the bucketed one (right-padded to its bucket; on a moe engine the
    dispatch masked to the true length): K/V rows of the real positions,
    in bfloat16 ulps of each row's largest entry.  On the card a bf16
    GEMM rounds by its shape (a bucket's M is not the prompt's), so the
    rows may differ by rounding: layer 0 (one projection from the
    embedding) must be within one ulp; the worst layer is reported (on
    a moe model ``moe_masked_witness`` holds the MoE block itself)."""
    worst0 = worst = 0.0
    for p in prompts:
        m = len(p) - 1
        _, c1 = exact._run_prefill(np.asarray(p[:-1]))
        want = {k: c1[k][:, 0, :, :m].float().clone() for k in ("k", "v")}
        padded = np.concatenate([p[:-1], np.zeros(
            bucketed.bucket_table.fit(m) - m, p.dtype)])
        _, c2 = bucketed._run_prefill(padded, None, m)
        for name in ("k", "v"):
            ulps = row_ulps(torch, c2[name][:, 0, :, :m].float(), want[name])
            worst0 = max(worst0, ulps[0].max().item())
            worst = max(worst, ulps.max().item())
    if worst0 > 1.0:
        raise AssertionError(f"bucketed vs exact prefill, layer 0: "
                             f"{worst0:.3g} bf16 ulps of the row max")
    log(f"  bucketed vs exact-length prefill of the {len(prompts)} prompts: "
        f"layer 0 K/V within {worst0:.3g} bf16 ulps of each row's max, the "
        f"worst layer {worst:.3g}")
    return {"layer0_max_ulps": worst0, "max_ulps": worst}


# bucketed MoE prefill: one MoE block fed the same rows unpadded and
# right-padded to the bucket (the masked dispatch).  The expert and
# shared-expert products run at another M, which a bf16 GEMM may round
# differently: each output row within this many bf16 ulps of its
# largest |entry|
MOE_MASKED_ULPS = 4.0


def layer_inputs(torch, model, cfg, tokens):
    """An exact-length prefill of ``tokens`` (1,S) through the model's
    first layers: each layer's block and feed-forward input, in cache
    order up to and including the first MoE layer."""
    from repro_torch.models import lm
    from repro_torch.models.common import rms_norm

    out = []
    x = lm.embed_tokens(model, cfg, tokens)
    s = x.shape[1]
    for blk in lm.blocks(model):
        ck = x.new_empty(1, cfg.n_kv_heads, s, cfg.dh)
        h = lm.prefill_attention(blk, cfg, x, ck, torch.empty_like(ck))
        hin = rms_norm(h, blk.ln2, cfg.norm_eps)
        out.append((blk, hin))
        if getattr(blk, "moe", None) is not None:
            return out
        x = h + lm.ffn(blk, cfg, hin)
    raise AssertionError(f"{cfg.arch_id}: no MoE layer")


def moe_masked_witness(torch, np, model, cfg, bucket_table, prompts):
    """Bucketed MoE prefill at the MoE block itself.  Each prompt's input
    to the first MoE layer's feed-forward (an exact-length prefill of
    the layers before it and of that layer's attention) goes through
    ``moe_block`` unpadded, and right-padded to its bucket (the pad rows
    those of the padded prompt) in the masked mode at the true length
    and its capacity, as the bucketed engine's prefill runs it.  Each
    expert's first C slots (C the true length's capacity) must hold the
    same tokens, its further slots none; y within ``MOE_MASKED_ULPS``.
    The combine weights' largest difference is reported."""
    from repro_torch.models import lm

    dev = model.embed.device
    worst = dw = 0.0
    e = cfg.n_experts
    with torch.no_grad():
        for p in prompts:
            m = len(p) - 1
            b = bucket_table.fit(m)
            toks = torch.as_tensor(p[None, :-1].astype(np.int64), device=dev)
            blk, x = layer_inputs(torch, model, cfg, toks)[-1]
            moe = blk.moe
            xb = layer_inputs(torch, model, cfg, torch.cat(
                [toks, toks.new_zeros(1, b - m)], 1))[-1][1]
            xpad = torch.cat([x, xb[:, m:]], dim=1)
            cm, cb = lm.moe_capacity(cfg, m), lm.moe_capacity(cfg, b)
            n_valid = torch.tensor(m, dtype=torch.int32, device=dev)
            cap = torch.tensor(cm, dtype=torch.int32, device=dev)
            du, wu, _ = lm.moe_dispatch(x.float() @ moe.router, cfg, cm)
            dp, wp, _ = lm.moe_dispatch(xpad.float() @ moe.router, cfg, cb,
                                        n_valid, cap)
            du, wu = du.view(e, cm), wu.view(e, cm)
            dp, wp = dp.view(e, cb), wp.view(e, cb)
            ids = torch.where(dp[:, :cm] == b, m, dp[:, :cm])
            if not (torch.equal(ids, du) and bool((dp[:, cm:] == b).all())):
                raise AssertionError(
                    f"{cfg.arch_id} masked dispatch at bucket {b}, true "
                    f"length {m}: {int((ids != du).sum())} slots differ "
                    f"from the unpadded dispatch")
            dw = max(dw, (wp[:, :cm] - wu).abs().max().item(),
                     wp[:, cm:].abs().max().item() if cb > cm else 0.0)
            yu = lm.moe_block(moe, cfg, x)[0]
            yp = lm.moe_block(moe, cfg, xpad, n_valid=n_valid,
                              eff_capacity=cap)[0][:, :m]
            worst = max(worst, row_ulps(torch, yp.float(),
                                        yu.float()).max().item())
    if worst > MOE_MASKED_ULPS:
        raise AssertionError(f"{cfg.arch_id} masked MoE block at the "
                             f"bucket: {worst:.3g} bf16 ulps of the row max")
    log(f"  masked MoE block at the bucket vs unpadded, the first MoE "
        f"layer's input of the {len(prompts)} prompts: the same dispatch "
        f"ids, combine weights within {dw:.3g}, y within {worst:.3g} bf16 "
        f"ulps of each row's max (limit {MOE_MASKED_ULPS})")
    return {"moe_block_max_ulps": worst, "combine_max_abs": dw,
            "dispatch_ids_equal": True}


def vlm_chunked_vs_oneshot(torch, np, cfg, engine, prompts):
    """PaliGemma's ``prefill_chunk=CHUNK`` against one-shot prefill, as
    phase 9 holds the dense chunked prefill: the longest prompt, cut to
    the longest that a one-shot prefill takes (vision prefix + prompt
    within 512 positions), through both exact-length engines; its K/V
    rows, vision prefix included, at layer 0 within one bfloat16
    rounding of each row's largest entry, the last layer's reported."""
    from repro_torch.serving import Request

    p = max(prompts, key=len)[:512 - cfg.n_vision_tokens + 1]
    n = cfg.n_vision_tokens + len(p) - 1
    extras = family_extras(np, cfg, 0)
    rows = []
    for kw in ({"prefill_chunk": CHUNK}, {}):
        e = engine(prefill_buckets=False, **kw)
        e.submit(Request(uid=0, tokens=p, max_new_tokens=2, extras=extras))
        while not e.results[0].output:
            e.step()
        slot = int(np.flatnonzero(e.active)[0])
        rows.append({name: e.cache[name][:, slot, :, :n].float().clone()
                     for name in ("k", "v")})
        e.run()
        del e
    out = {"compared_prompt": len(p), "positions": n}
    for name in ("k", "v"):
        ulps = row_ulps(torch, rows[0][name], rows[1][name])
        out[f"{name}_layer0_max_ulps"] = ulps[0].max().item()
        out[f"{name}_last_layer_max_ulps"] = ulps[-1].max().item()
        worst0 = out[f"{name}_layer0_max_ulps"]
        if worst0 > 1.0:
            raise AssertionError(f"vlm chunked vs one-shot prefill, layer 0 "
                                 f"{name}: {worst0:.3g} ulps of the row max")
    log(f"  prefill_chunk={CHUNK} vs one-shot, prompt of {len(p)} tokens "
        f"after the {cfg.n_vision_tokens}-token vision prefix: K/V rows at "
        f"layer 0 within {out['k_layer0_max_ulps']:.3g} / "
        f"{out['v_layer0_max_ulps']:.3g} bf16 ulps of the row max, the last "
        f"layer {out['k_last_layer_max_ulps']:.3g} / "
        f"{out['v_last_layer_max_ulps']:.3g}")
    return out


def quantized_vs_references(torch, np, dev, bundle, model, prompt, kw,
                            rtol, extras=None) -> dict:
    """A quantized engine's teacher-forced logits (``kw``: its weight and
    KV dtypes, contiguous KV) against the bf16 engine, held to ``rtol``
    (reported where it is None), and with quantized weights against the
    same weights through the plain versions (the reference tag chain),
    reported."""
    q = {k: kw[k] for k in ("weight_dtype", "kv_dtype") if kw.get(k)}
    out = {}
    # the served run's engines gone before two more are built
    gc.collect()
    torch.cuda.empty_cache()
    if q.get("weight_dtype"):
        out["vs_plain"] = check_logits(
            f"{describe(q)} on the kernels vs the plain versions",
            *teacher_forced_logits(torch, np, dev, bundle, model, prompt,
                                   want={"tags": ("reference",), **q},
                                   extras=extras, **q), None)
    out["vs_bf16"] = check_logits(
        f"{describe(q)} vs the bf16 engine",
        *teacher_forced_logits(torch, np, dev, bundle, model, prompt,
                               extras=extras, **q), rtol)
    torch.cuda.empty_cache()
    return out


# the served quantized weights at full width, one prompt's rows at the
# first two layers (``quantized_layers``): the dense first block's MLP on
# K5/K6 against the same weights through their plain versions (float32
# sums in another order, then the bf16 casts), within this many bf16
# ulps of each row's max ...
QUANT_MLP_ULPS = 2.0
# ... and ||quantized - bf16|| / ||bf16|| of that MLP and of the first
# MoE block (its experts dequantized; the router is not quantized, so
# the dispatch is the bf16 one): quantization error, from per-channel
# steps of max|w|/127 (int8) and max|w|/7 (int4)
QUANT_LAYER_REL = {"int8": 0.05, "int4": 0.5}


def quantized_layers(torch, np, model, qmodel, cfg, prompt, wd) -> dict:
    """Phase 15 (d)/(e): the engine's quantized weights (``qmodel``, of
    ``model`` quantized to ``wd``) on the exact-length prefill's rows of
    ``prompt`` at the dense first block and the first MoE layer:
    ``QUANT_MLP_ULPS`` and ``QUANT_LAYER_REL``.  Layer by layer, so a
    fault in the dequantized experts or the K5/K6 MLP shows apart from
    the routing flips that rounding causes over the full depth."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import dequant_matmul_i4_ref, \
        dequant_matmul_ref
    from repro_torch.models import lm, lm_quant

    def plain(x, w):
        fn = dequant_matmul_i4_ref if w.int4 else dequant_matmul_ref
        return fn(x.float(), w.q4 if w.int4 else w.q8, w.qs.reshape(-1))

    def rel(got, want):
        return ((got.float() - want.float()).norm()
                / want.float().norm()).item()

    dt = cfg.torch_dtype()
    toks = torch.as_tensor(prompt[None, :-1].astype(np.int64),
                           device=model.embed.device)
    out = {}
    with torch.no_grad():
        (fb, h0), (mb, h1) = layer_inputs(torch, model, cfg, toks)
        qfb, qmb = qmodel.first_block, qmodel.layers[0]
        got = lm_quant.mlp_block_q(qfb.mlp, cfg, h0, mm=kops.dequant_matmul)
        want = lm_quant.mlp_block_q(qfb.mlp, cfg, h0, mm=plain)
        out["mlp_kernel_vs_plain_ulps"] = row_ulps(
            torch, got.float(), want.float()).max().item()
        out["mlp_rel_vs_bf16"] = rel(got, lm.mlp_block(fb.mlp, cfg, h0))
        out["moe_rel_vs_bf16"] = rel(
            lm.moe_block(lm_quant.dequant_params(qmb.moe, dt), cfg, h1)[0],
            lm.moe_block(mb.moe, cfg, h1)[0])
    limit = QUANT_LAYER_REL[wd]
    if out["mlp_kernel_vs_plain_ulps"] > QUANT_MLP_ULPS \
            or max(out["mlp_rel_vs_bf16"], out["moe_rel_vs_bf16"]) > limit:
        raise AssertionError(f"{cfg.arch_id} {wd} weights, layer by layer: "
                             f"{out} (limits {QUANT_MLP_ULPS} ulps, {limit})")
    log(f"  {wd} weights, prompt of {len(prompt)} tokens: the first block's "
        f"MLP on the kernel within {out['mlp_kernel_vs_plain_ulps']:.3g} "
        f"bf16 ulps of its plain version (limit {QUANT_MLP_ULPS}); against "
        f"bf16, relative error {out['mlp_rel_vs_bf16']:.4g} (that MLP) and "
        f"{out['moe_rel_vs_bf16']:.4g} (the first MoE block, experts "
        f"dequantized), limit {limit}")
    return out


def reduced_moe_card_vs_cpu(torch, np, dev) -> dict:
    """Phase 15, as phase 8 for Yi-6B: DeepSeek-MoE-16B reduced, float32,
    int8 weights and KV and int4 weights and int8 KV, paged by 8: the
    engine on the card emits the CPU engine's greedy tokens, its decode
    steps on K5 or K6 (the first block's MLP) and K7."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(MOE_ARCH, reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (5, 30, 1, 70, 12, 40)]
    out = {}
    for wd, mm in (("int8", "dequant_matmul"), ("int4", "dequant_matmul_i4")):
        outs = []
        for where in ("cpu", dev):
            before = dict(_build.launches)
            eng = ServingEngine(bundle, model.to(where), max_slots=4,
                                cache_len=128, device=where, weight_dtype=wd,
                                kv_dtype="int8", kv_block=8)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid=uid, tokens=p, max_new_tokens=24))
            outs.append({u: r.output for u, r in eng.run().items()})
        new = {k: n - before[k] for k, n in _build.launches.items()
               if n != before[k]}
        if outs[0] != outs[1] or not new.get(mm) \
                or not new.get("paged_decode_attention_q"):
            raise AssertionError(f"reduced {MOE_ARCH} {wd}: card tokens "
                                 f"{outs[1]}, CPU {outs[0]}; launches {new}")
        out[wd] = {"tokens": sum(len(o) for o in outs[0].values()),
                   "launches": new}
    log(f"  {cfg.arch_id} reduced, float32, int8/int8 and int4/int8 paged by "
        f"8: card == CPU, {len(prompts)} requests, "
        + ", ".join(f"{wd} {v['tokens']} tokens ({v['launches']})"
                    for wd, v in out.items()))
    return out


def tokens_equal(label, got, want) -> dict:
    """How many of ``got``'s requests and tokens equal ``want``'s."""
    out = {"requests_equal": sum(got[u] == want[u] for u in want),
           "tokens_equal": sum(a == b for u in want
                               for a, b in zip(got[u], want[u])),
           "tokens": sum(len(t) for t in want.values())}
    log(f"  {label}: {out['requests_equal']} of {len(want)} requests and "
        f"{out['tokens_equal']} of {out['tokens']} tokens equal")
    return out


def phase_summary(torch, label, t0, rows):
    """The phase's seconds, decode-step medians (replayed, and eager where
    an eager twin ran) and peak device memory, logged and returned."""
    info = {"phase": label, "seconds": time.perf_counter() - t0,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "median_decode_step_ms": {
                r["model"]: r["median_decode_step_ms"] for r in rows},
            "eager_median_decode_step_ms": {
                r["model"]: r["eager"]["median_decode_step_ms"]
                for r in rows if "eager" in r}}
    log(f"  {label}: {info['seconds']:.1f} s, peak device memory "
        f"{info['peak_memory_bytes'] / 2**30:.2f} GiB; decode step medians "
        "replayed " + ", ".join(f"{m} {ms:.3f} ms" for m, ms in
                                info["median_decode_step_ms"].items())
        + "; eager " + ", ".join(
            f"{m} {ms:.3f} ms"
            for m, ms in info["eager_median_decode_step_ms"].items()))
    return info


def moe_serving(torch, np, dev):
    """Phase 15: DeepSeek-MoE-16B at full width with ``MOE_LAYERS`` of its
    28 layers in bfloat16 (seeded on the card): (a) contiguous on K3, its
    replays bit-equal to an eager engine; (b) bucketed (one prefill
    program per bucket hit; its prefill K/V against (a)'s within
    rounding, ``bucketed_vs_exact``, the MoE block's masked dispatch
    against the unpadded one, ``moe_masked_witness``, and the tokens
    that stay equal counted); (c) paged with blocks of 16 on K4 with
    (a)'s tokens, and an EDF displacement on (c) with the uninterrupted
    tokens; (d) int8 weights and KV paged (K5 on the dense first block's
    MLP, K7), (e) int4 weights (K6, K7), each held layer by layer
    (``quantized_layers``), its teacher-forced logits reported
    (``quantized_vs_references``), and both held in float32 at the
    reduced size, card against CPU (``reduced_moe_card_vs_cpu``).  Then
    Qwen3-MoE-30B-A3B at full width with 4 of its 48 layers: contiguous
    and bucketed on K3, compared as (a) and (b).  Returns (rows,
    summaries, launches by run)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = get_model(dataclasses.replace(get_config(MOE_ARCH),
                                           n_layers=MOE_LAYERS))
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {MOE_ARCH}: {n_params / 1e9:.2f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"seeded in {time.perf_counter() - t0:.1f} s")
    engine = family_engine(dev, bundle, model)
    layers = bundle.cfg.n_layers
    prompts = family_workload(np, bundle.cfg.vocab, 31, 16, 512)
    exact = {"prefill_buckets": False}
    q8 = {**exact, "kv_block": PAGED_BLOCK, "weight_dtype": "int8",
          "kv_dtype": "int8"}
    runs = {"a": (exact, {"decode_attention": layers}),
            "b": ({}, {"decode_attention": layers}),
            "c": ({**exact, "kv_block": PAGED_BLOCK},
                  {"paged_decode_attention": layers}),
            "d": (q8, {"dequant_matmul": 3,
                       "paged_decode_attention_q": layers}),
            "e": ({**q8, "weight_dtype": "int4"},
                  {"dequant_matmul_i4": 3,
                   "paged_decode_attention_q": layers})}
    rows, toks, launches, engines = [], {}, {}, {}
    for key, (kw, per_step) in runs.items():
        eng, row, toks[key] = family_run(torch, np, dev, engine, prompts,
                                         f"{MOE_ARCH} run ({key})", kw,
                                         per_step)
        launches[f"{MOE_ARCH} ({key})"] = {
            k: n for k, n in row["launches"].items() if n}
        if key in ("a", "d"):
            profile_decode(torch, np, eng, row)
        if key == "a":
            eager_twin(torch, np, dev, engine(**kw), prompts, row, toks[key],
                       new=FAMILY_NEW)
            engines["a"] = eng
        if key == "b":
            row["vs_exact"] = {**bucketed_vs_exact(
                torch, np, engines.pop("a"), eng, prompts),
                **moe_masked_witness(torch, np, model, bundle.cfg,
                                     eng.bucket_table, prompts),
                **tokens_equal("(b) against (a)", toks["b"], toks["a"])}
        if key in ("d", "e"):
            row["layers"] = quantized_layers(
                torch, np, model, eng.params, bundle.cfg,
                max(prompts, key=len), kw["weight_dtype"])
        del eng
        if key == "c":
            same_tokens("(c) against (a)", toks["c"], toks["a"])
            check_preemption(engine(policy="edf", preempt="edf-displace",
                                    clock=lambda: 0, **kw), prompts,
                             toks["a"], new=FAMILY_NEW)
        if key in ("d", "e"):
            row["requests_equal_bf16"] = sum(toks[key][u] == toks["a"][u]
                                             for u in toks["a"])
            log(f"  ({key}) {row['requests_equal_bf16']} of {len(prompts)} "
                f"requests emit (a)'s bf16 tokens whole; weights "
                f"{row['param_bytes']:,} B")
            row["teacher_forced"] = quantized_vs_references(
                torch, np, dev, bundle, model, max(prompts, key=len), kw,
                None)
        if key == "a":
            # the same reading with nothing quantized: how far rounding
            # alone moves the logits through 28 routed layers
            row["teacher_forced_vs_plain"] = check_logits(
                "bf16 on K3 vs the plain versions", *teacher_forced_logits(
                    torch, np, dev, bundle, model, max(prompts, key=len),
                    want={"tags": ("reference",)}), None)
        torch.cuda.empty_cache()
        rows.append(row)
    rows[-1]["reduced_card_vs_cpu"] = reduced_moe_card_vs_cpu(torch, np, dev)
    summaries = [phase_summary(torch, f"phase 15 {MOE_ARCH}", t0, rows)]
    del model, engine
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE2_ARCH), n_layers=MOE2_LAYERS)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(dev).manual_seed(1))
    engine = family_engine(dev, bundle, model)
    prompts = family_workload(np, cfg.vocab, 32, 16, 512)
    rows2 = []
    for key, kw in (("a", exact), ("b", {})):
        eng, row, toks[f"q{key}"] = family_run(
            torch, np, dev, engine, prompts,
            f"{MOE2_ARCH} {MOE2_LAYERS} layers run ({key})", kw,
            {"decode_attention": MOE2_LAYERS})
        row["model"] += f", {MOE2_LAYERS} of 48 layers"
        launches[f"{MOE2_ARCH} ({key})"] = {
            k: n for k, n in row["launches"].items() if n}
        if key == "a":
            profile_decode(torch, np, eng, row)
            eager_twin(torch, np, dev, engine(**kw), prompts, row,
                       toks["qa"], new=FAMILY_NEW)
            engines["a"] = eng
        else:
            row["vs_exact"] = {**bucketed_vs_exact(
                torch, np, engines.pop("a"), eng, prompts),
                **moe_masked_witness(torch, np, model, cfg,
                                     eng.bucket_table, prompts),
                **tokens_equal("(b) against (a)", toks["qb"], toks["qa"])}
        del eng
        rows2.append(row)
    summaries.append(phase_summary(torch, f"phase 15 {MOE2_ARCH}", t0,
                                   rows2))
    del model, engine
    torch.cuda.empty_cache()
    return rows + rows2, summaries, launches


def vlm_serving(torch, np, dev):
    """Phase 16: PaliGemma-3B at full width in bfloat16 with seeded patch
    embeddings: (a) bucketed, (b) ``prefill_chunk=128``, (c) bucketed
    and paged with blocks of 16, (d) bucketed with an int8 KV cache.
    The family keeps reference attention on every path, as in the JAX
    package: each run launches no kernel (counted and traced); (c)
    emits (a)'s tokens; (b) against one-shot prefill
    (``vlm_chunked_vs_oneshot``); (d) against the bf16 engine
    (``quantized_vs_references``) and its tokens against (a)'s."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bundle = get_model(dataclasses.replace(get_config(VLM_ARCH),
                                           n_layers=VLM_LAYERS))
    model = bundle.init(torch.Generator(dev).manual_seed(2))
    engine = family_engine(dev, bundle, model)
    vocab = bundle.cfg.vocab
    # one-shot prompts keep vision prefix + bucket within 512 positions
    # (the prefill's query-chunked attention takes multiples of 512 past
    # that, as the JAX package's); the chunked run takes longer ones
    short = family_workload(np, vocab, 33, 16, 257)
    runs = {"a": ({}, short),
            "b": ({"prefill_buckets": False, "prefill_chunk": CHUNK},
                  family_workload(np, vocab, 34, 100, 600)),
            "c": ({"kv_block": PAGED_BLOCK}, short),
            "d": ({"kv_dtype": "int8"}, short)}
    rows, toks, launches = [], {}, {}
    for key, (kw, prompts) in runs.items():
        eng, row, toks[key] = family_run(torch, np, dev, engine, prompts,
                                         f"{VLM_ARCH} run ({key})", kw, {})
        launches[f"{VLM_ARCH} ({key})"] = sum(row["launches"].values())
        if key == "a":
            profile_decode(torch, np, eng, row)
        del eng
        if key == "a":
            eager_twin(torch, np, dev, engine(**kw), prompts, row, toks[key],
                       new=FAMILY_NEW)
        if key == "b":
            row["vs_oneshot"] = vlm_chunked_vs_oneshot(
                torch, np, bundle.cfg, engine, prompts)
        if key == "d":
            row["vs_bf16"] = tokens_equal("(d) against (a)", toks["d"],
                                          toks["a"])
            i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
            row["teacher_forced"] = quantized_vs_references(
                torch, np, dev, bundle, model, prompts[i], kw,
                INT8_VS_BF16_RTOL, extras=family_extras(np, bundle.cfg, i))
        torch.cuda.empty_cache()
        rows.append(row)
    same_tokens("(c) against (a)", toks["c"], toks["a"])
    log("  no kernel launched on any run: vlm decodes on reference "
        "attention, as in the JAX package")
    summary = phase_summary(torch, f"phase 16 {VLM_ARCH}", t0, rows)
    del model, engine
    torch.cuda.empty_cache()
    return rows, [summary], launches


def audio_serving(torch, np, dev):
    """Phase 17: Whisper-large-v3 at full width in bfloat16 with seeded
    frame embeddings (1500 frames): (a) exact, its replays bit-equal to
    an eager engine; then an EDF displacement (checkpointed: the
    checkpoint carries the cross K/V) emits the uninterrupted tokens.
    No kernel on the path (counted and traced)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bundle = get_model(dataclasses.replace(
        get_config(AUDIO_ARCH), n_layers=AUDIO_LAYERS,
        n_encoder_layers=AUDIO_LAYERS))
    model = bundle.init(torch.Generator(dev).manual_seed(3))
    engine = family_engine(dev, bundle, model)
    prompts = family_workload(np, bundle.cfg.vocab, 35, 4, 64)
    eng, row, toks = family_run(torch, np, dev, engine, prompts,
                                f"{AUDIO_ARCH} run (a)", {}, {})
    profile_decode(torch, np, eng, row)
    del eng
    eager_twin(torch, np, dev, engine(), prompts, row, toks,
               new=FAMILY_NEW)
    check_preemption(engine(policy="edf", preempt="edf-displace",
                            clock=lambda: 0), prompts, toks, new=FAMILY_NEW)
    summary = phase_summary(torch, f"phase 17 {AUDIO_ARCH}", t0, [row])
    del model, engine
    torch.cuda.empty_cache()
    return [row], [summary]


def dequantized_copy(torch, qmodel, cfg, dev):
    """A float model of ``qmodel``'s class holding its dequantized
    weights (``lm_quant.dequant_leaf``) and its float ones."""
    from repro_torch.models import lm_quant
    from repro_torch.models.registry import empty_model

    out = empty_model(cfg, dev)
    with torch.no_grad():
        for name, p in out.named_parameters():
            leaf = qmodel
            for part in name.split("."):
                leaf = getattr(leaf, part)
            if lm_quant.is_qleaf(leaf):
                leaf = lm_quant.dequant_leaf(leaf, p.dtype)
            p.copy_(leaf)
    return out


def quantized_recurrent_serving(torch, np, dev):
    """Phase 18: Mamba2-780m and Zamba2-1.2B at full width, int8 and int4
    weight-only (the embedding, and Zamba2's shared block, quantized, as
    in the JAX package): one-shot prefill with the scan on K8 (one launch
    per Mamba layer per prefill, nothing else), then the same requests
    through a float engine over the dequantized weights: the same
    tokens.  The int8 run's replays bit-equal to an eager engine."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    rows, summaries, launches = [], [], {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        bundle = get_model(dataclasses.replace(
            get_config(arch), n_layers=RECURRENT_LAYERS[arch]))
        model = bundle.init(torch.Generator(dev).manual_seed(4))
        engine = family_engine(dev, bundle, model)
        layers, vocab = bundle.cfg.n_layers, bundle.cfg.vocab
        prompts = recurrent_workload(np, vocab, 36, N_FAMILY, 0, 0, True)
        arch_rows = []
        for wd in ("int8", "int4"):
            kw = {"weight_dtype": wd}
            eng = engine(**kw)
            row, toks = serve_main(torch, np, dev, eng, prompts,
                                   f"{arch} {wd} weights", new=FAMILY_NEW)
            want = dict.fromkeys(row["launches"], 0)
            want["ssd_scan"] = layers * row["prefills"]
            if row["launches"] != want:
                raise AssertionError(f"{arch} {wd}: launches "
                                     f"{row['launches']}, expected {want}")
            launches[f"{arch} {wd}"] = want["ssd_scan"]
            row["model"] = f"{arch} bfloat16 serving, {wd} weights"
            if wd == "int8":
                profile_decode(torch, np, eng, row)
            fengine = family_engine(dev, bundle, dequantized_copy(
                torch, eng.params, bundle.cfg, dev))
            del eng
            _, ftoks = serve_lm(torch, np, dev, fengine(), prompts,
                                new=FAMILY_NEW)
            same_tokens(f"{arch} {wd}: a float engine on the dequantized "
                        f"weights", ftoks, toks)
            del fengine
            if wd == "int8":
                eager_twin(torch, np, dev, engine(**kw), prompts, row, toks,
                           new=FAMILY_NEW)
            torch.cuda.empty_cache()
            arch_rows.append(row)
        summaries.append(phase_summary(torch, f"phase 18 {arch}", t0,
                                       arch_rows))
        rows += arch_rows
        del model, engine
        torch.cuda.empty_cache()
    return rows, summaries, launches


# ---------------------------------------------------------------------------
# phases 19-23: overlapped decode, the multi-tenant host, the replica
# router, the streaming server and the profiler (Yi-6B)
# ---------------------------------------------------------------------------

# the host's arena: Yi-6B's 4 x 2048 bfloat16 KV is 1 GiB a replica
HOST_ARENA_BYTES = 4 << 30
HOST_MAX_PROMPT = 512
# the host's micro tenants: the fc_stack int8 ragged bucket on K1 and the
# streaming hotword (exact lowering: bit-equal to a lone invoke); its
# lane-preemption check runs the hotword alone on two lanes
HOST_FC_LANES, HOST_HW_LANES = 16, 4
HOST_FC_REQUESTS, HOST_HW_REQUESTS = 40, 12
HOST_RUNS = 3
# the router's workload: phase 7's 8 requests and 4 more
N_ROUTED = 12
PROFILE_WARMUP, PROFILE_ITERS = 2, 10


def check_streams(label, events, outputs, runs: int = 1) -> None:
    """Each uid's StreamEvents over ``runs`` runs of the same uids: in
    each run, indices 0, 1, ... with no gap and no repeat, the tokens its
    output, exactly one final and it the last."""
    per = {}
    for ev in events:
        per.setdefault(ev.uid, []).append(ev)
    if sorted(per) != sorted(outputs):
        raise AssertionError(f"{label}: events for uids {sorted(per)}, "
                             f"outputs for {sorted(outputs)}")
    for uid, evs in per.items():
        n = len(outputs[uid])
        if len(evs) != runs * n:
            raise AssertionError(f"{label}: uid {uid} has {len(evs)} events "
                                 f"for {runs} x {n} tokens")
        for r in range(runs):
            run = evs[r * n:(r + 1) * n]
            if ([e.index for e in run] != list(range(n))
                    or [e.token for e in run] != outputs[uid]
                    or [e.final for e in run] != [False] * (n - 1) + [True]):
                raise AssertionError(f"{label}: uid {uid}'s events break "
                                     f"the in-order exactly-once contract")


def tick_ms(torch, eng, prompts, new=SERVE_NEW):
    """Every request through ``eng``, host clock around each ``step()``
    and nothing else (an overlapped step returns with the next step in
    flight); returns (ms of the ticks that decoded and ran no prefill,
    the tokens)."""
    from repro_torch.serving import Request

    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=new))
    ms = []
    while True:
        t0 = time.perf_counter()
        more = eng.step()
        dt = (time.perf_counter() - t0) * 1e3
        if eng.last_step["decoded"] and not eng.last_step["prefill_tokens"]:
            ms.append(dt)
        if not more:
            break
    torch.cuda.synchronize()
    return ms, {u: eng.results[u].output for u in range(len(prompts))}


def evict_midstream(eng, prompts, served) -> None:
    """Phase 19: the requests through the overlapped ``eng``; six ticks
    in, one decoding request is evicted (after a drain) and later
    restored: every request emits phase 7's tokens, each token once, in
    order."""
    from repro_torch.serving import Request

    events = []
    eng.on_token = events.append
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=SERVE_NEW))
    for _ in range(6):
        eng.step()
    eng.drain()
    victim = next(s for s in range(eng.max_slots) if eng.active[s])
    uid = eng.slot_meta[victim].uid
    done = len(eng.results[uid].output)
    eng._evict(victim)
    res = eng.run()
    outs = {u: r.output for u, r in res.items()}
    if res[uid].preemptions != 1 or outs != served:
        raise AssertionError(f"overlapped evict/restore: request {uid} "
                             f"preempted {res[uid].preemptions} times, "
                             f"tokens {outs} != {served}")
    check_streams("overlapped evict/restore", events, outs)
    eng.on_token = None
    log(f"  forced evict of request {uid} after {done} tokens, then its "
        f"restore: phase 7's tokens, every event once and in order")


def overlapped_decode(torch, np, dev, engine, prompts, served, n_layers):
    """Phase 19: ``overlap=True`` on a contiguous engine (K3) and a paged
    one (K4): phase 7's tokens, the StreamEvent contract, one decode and
    one argmax program, a forced mid-stream evict/restore; then the tick
    (host clock around ``step()``) sync against overlapped, in turns on
    warm engines, and each one's device time per step and busy share."""
    from repro_torch.core import capture_count

    rows, launches = [], {}
    for label, kw, kname in (
            ("contiguous", {}, "decode_attention"),
            ("paged", {"kv_block": PAGED_BLOCK}, "paged_decode_attention")):
        events = []
        eng = engine(overlap=True, on_token=events.append, **kw)
        row, toks = serve_main(torch, np, dev, eng, prompts,
                               f"the overlapped {label} decode (phase 19)")
        same_tokens(f"overlapped {label} vs phase 7", toks, served)
        check_streams(f"overlapped {label}", events, toks, runs=2)
        want = dict.fromkeys(row["launches"], 0)
        want[kname] = n_layers * row["decode_steps"]
        if row["launches"] != want:
            raise AssertionError(f"overlapped {label}: launches "
                                 f"{row['launches']}, expected {want}")
        launches[f"phase 19 overlapped {label}"] = (kname, want[kname])
        programs = {n: capture_count(p) for n, p in eng.programs().items()}
        if programs["decode"] != 1 or programs["argmax"] != 1:
            raise AssertionError(f"overlapped {label}: programs {programs}")
        eng.on_token = None
        evict_midstream(eng, prompts, served)
        sync = engine(**kw)
        tick_ms(torch, sync, prompts)               # captures its programs
        ticks = {"sync": [], "overlap": []}
        for which in ("sync", "overlap", "overlap", "sync"):
            ms, got = tick_ms(torch, sync if which == "sync" else eng,
                              prompts)
            same_tokens(f"timed {which} {label}", got, served)
            ticks[which] += ms
        med = {k: statistics.median(v) for k, v in ticks.items()}
        sync_row = {"median_decode_step_ms": med["sync"]}
        profile_decode(torch, np, sync, sync_row)
        row["median_decode_step_ms"] = med["overlap"]
        profile_decode(torch, np, eng, row)
        row.update({
            "model": f"{LM_ARCH} bfloat16 serving, overlap, {label}",
            "tick_ms_sync": med["sync"], "tick_ms_overlap": med["overlap"],
            "ticks": {k: len(v) for k, v in ticks.items()},
            "sync_device_ms_per_decode_step":
                sync_row["device_ms_per_decode_step"],
            "sync_device_busy_share": sync_row["device_busy_share"],
            "programs": programs})
        log(f"  {label}: median tick {med['sync']:.3f} ms sync, "
            f"{med['overlap']:.3f} ms overlapped ({len(ticks['sync'])} and "
            f"{len(ticks['overlap'])} ticks, in turns); device "
            f"{sync_row['device_ms_per_decode_step']:.3f} ms a step sync, "
            f"{row['device_ms_per_decode_step']:.3f} ms overlapped; busy "
            f"{100 * sync_row['device_busy_share']:.1f}% sync, "
            f"{100 * row['device_busy_share']:.1f}% overlapped; {kname} "
            f"{want[kname]} launches")
        rows.append(row)
        del eng, sync
    return rows, launches


def micro_models():
    """(fc_stack int8, streaming hotword float) micro models."""
    from repro_torch.apps.models import (build_fc_stack, build_hotword,
                                         representative_dataset)
    from repro_torch.core import MicroModel, export

    gb = build_fc_stack()
    return (MicroModel(export(gb, representative_dataset(gb),
                              quantize_int8=True)),
            MicroModel(export(build_hotword())))


def lone_interpreter(dev, model, res):
    """A MicroInterpreter of ``model`` on the card, for requests alone."""
    from repro_torch.core import MicroInterpreter

    return MicroInterpreter(model, res, MicroInterpreter.required_arena_size(
        model, res), device=dev)


def input_shape(model):
    return tuple(model.tensor(model.inputs[0]).shape)


def alone_outputs(it, frames):
    """A request's outputs through the MicroInterpreter ``it`` alone,
    from its initial variable state."""
    it.reset_variable_tensors()
    out = []
    for f in frames:
        it.set_input(0, f)
        it.invoke()
        out.append(it.output(0).copy())
    return out


def micro_bit_equal(np, it, reqs, results, label) -> int:
    """Every micro request's outputs bit-equal to it alone through the
    interpreter ``it``; returns the frames compared."""
    n = 0
    for uid, frames in reqs.items():
        got = results[uid]
        if not got.done or got.steps != len(frames):
            raise AssertionError(f"{label} request {uid}: done {got.done}, "
                                 f"{got.steps} of {len(frames)} steps")
        for a, b in zip(got.outputs, alone_outputs(it, frames)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{label} request {uid} differs from "
                                     f"its run alone")
            n += 1
    return n


def tenant_arena(model, res):
    """A micro tenant's (persistent, head, temp high water) bytes, planned
    alone in an arena of its own."""
    from repro_torch.core import TwoStackArena, plan_model

    probe = TwoStackArena(1 << 30)
    plan_model(model, res, host_arena=probe, device="cpu")
    u = probe.usage()
    return u.persistent, u.nonpersistent, u.temp_high_water


def multitenant_host(torch, np, dev, bundle, model, prompts, served,
                     n_layers):
    """Phase 20: one ``MultiTenantHost`` arena holding Yi-6B
    (``overlap=True``), a ragged fc_stack int8 micro tenant (K1, 16
    lanes) and the streaming hotword, driven through ``run_all``
    ``HOST_RUNS`` times: phase 7's tokens, micro outputs bit-equal to
    each request alone, the arena's usage the tenants' persistents
    stacked with the largest scratch, device memory flat from the second
    run on; then an EDF lane preemption on a host of its own."""
    from repro_torch.core import AllOpsResolver, OpCode
    from repro_torch.core.arena import align_up
    from repro_torch.serving import MultiTenantHost, Request
    from repro_torch.serving.host import _scratch_bytes

    res = AllOpsResolver(tags=("cuda", "reference"))
    fc, hw = micro_models()
    alone = {"fc": lone_interpreter(dev, fc, res),
             "hw": lone_interpreter(dev, hw, res)}
    host = MultiTenantHost(HOST_ARENA_BYTES, device=dev)
    eng = host.add_model(LM_ARCH, bundle, model, max_slots=SERVE_SLOTS,
                         cache_len=SERVE_CACHE, max_prompt=HOST_MAX_PROMPT,
                         overlap=True)
    host.add_ragged_micro("fc", fc, res, lanes=HOST_FC_LANES)
    host.add_ragged_micro("hw", hw, res, lanes=HOST_HW_LANES, exact=True)
    rng = np.random.default_rng(20)
    fc_reqs = {i: [rng.normal(0, 1, input_shape(fc)).astype(np.float32)]
               for i in range(HOST_FC_REQUESTS)}
    hw_reqs = {i: [rng.normal(0, 1, input_shape(hw)).astype(np.float32)
                   for _ in range(1 + i % 4)]
               for i in range(HOST_HW_REQUESTS)}
    n_fc = sum(op.opcode == OpCode.FULLY_CONNECTED
               and fc.tensor(op.inputs[0]).dtype == "int8"
               for op in fc.operators)
    fc_bucket = host.ragged._buckets["fc"]

    def run():
        for uid, p in enumerate(prompts):
            host.submit(LM_ARCH, Request(uid=uid, tokens=p,
                                         max_new_tokens=SERVE_NEW))
        for name, reqs in (("fc", fc_reqs), ("hw", hw_reqs)):
            for uid, frames in reqs.items():
                host.submit_micro(name, uid, [[f] for f in frames])
        t0 = time.perf_counter()
        out = host.run_all()
        wall = time.perf_counter() - t0
        gc.collect()
        return wall, out, torch.cuda.memory_allocated()

    def check(out) -> int:
        """The run's tokens and micro outputs; returns the frames
        compared (each request alone, outside the counted run)."""
        toks = {u: r.output for u, r in out[LM_ARCH].items()}
        same_tokens("the host's Yi-6B tenant vs phase 7", toks, served)
        return (micro_bit_equal(np, alone["fc"], fc_reqs,
                                host.micro_results["fc"], "fc")
                + micro_bit_equal(np, alone["hw"], hw_reqs,
                                  host.micro_results["hw"], "hotword"))

    dispatches = fc_bucket.dispatch_count
    with main_path(torch, "the multi-tenant host (phase 20)") as traced:
        runs = [run()]
    fc_waves = fc_bucket.dispatch_count - dispatches
    frames = check(runs[0][1])
    if traced["quant_matmul"] != n_fc * fc_waves:
        raise AssertionError(f"phase 20: K1 launched "
                             f"{traced['quant_matmul']} times for {fc_waves} "
                             f"fc waves of {n_fc} int8 FC ops")
    k3 = traced["decode_attention"]
    if not k3 or k3 % n_layers or any(
            n for k, n in traced.items()
            if k not in ("quant_matmul", "decode_attention")):
        raise AssertionError(f"phase 20: launches {traced}")
    for _ in range(HOST_RUNS - 1):
        runs.append(run())
        check(runs[-1][1])
    memory = [m for _, _, m in runs]
    if len(set(memory[1:])) != 1:
        raise AssertionError(f"phase 20: device memory after each run_all "
                             f"{memory}, not flat from the second")
    # the arena: each tenant's persistents stacked, the head section the
    # largest micro plan, the temp high water the largest scratch
    tenants = [tenant_arena(m, res) for m in (fc, hw)]
    want = (eng.arena.usage().capacity,
            align_up(eng.kv_bytes) + sum(t[0] for t in tenants),
            max(t[1] for t in tenants),
            max([_scratch_bytes(bundle, HOST_MAX_PROMPT)]
                + [t[2] for t in tenants]))
    u = host.usage()
    got = (u.capacity, u.persistent, u.nonpersistent, u.temp_high_water)
    if got != want:
        raise AssertionError(f"phase 20: arena (capacity, persistent, head, "
                             f"temp) {got}, the tenants' {want}")
    preempt = lane_preemption(np, dev, hw, res, alone["hw"])
    row = {"model": f"{LM_ARCH} + fc_stack int8 + hotword on one host",
           "runs": HOST_RUNS, "run_all_s": [w for w, _, _ in runs],
           "micro_frames_bit_equal": frames,
           "memory_bytes_after_run_all": memory,
           "arena": dict(zip(("capacity", "persistent", "nonpersistent",
                              "temp_high_water"), got)),
           "launches": traced, "fc_waves": fc_waves,
           "lane_preemption": preempt}
    log(f"  {HOST_RUNS} run_all: {', '.join(f'{w:.2f}' for w, _, _ in runs)}"
        f" s; Yi-6B tokens equal phase 7's and {frames} micro frames "
        f"bit-equal to each request alone, each run; device memory "
        f"{memory[1]:,} B from the second run on; arena persistent "
        f"{u.persistent:,} B (KV {eng.kv_bytes:,} + micro "
        f"{sum(t[0] for t in tenants):,}), head {u.nonpersistent:,} B, temp "
        f"{u.temp_high_water:,} B (the Yi-6B scratch); K1 "
        f"{traced['quant_matmul']} = {n_fc} x {fc_waves} waves")
    return row, {"quant_matmul": traced["quant_matmul"],
                 "decode_attention": k3}


def lane_preemption(np, dev, hw, res, alone) -> dict:
    """Phase 20's EDF lane preemption: two 6-frame hotword monopolizers
    hold both lanes; a one-frame request with a deadline displaces one
    (snapshot + retire), which later restores: every request's outputs
    bit-equal to it alone."""
    from repro_torch.serving import MultiTenantHost

    rng = np.random.default_rng(21)
    frame = lambda: rng.normal(0, 1, input_shape(hw)).astype(np.float32)
    host = MultiTenantHost(64 << 20, policy="edf", preempt="edf-displace",
                           clock=lambda: 0, device=dev)
    host.add_ragged_micro("hw", hw, res, lanes=2, exact=True,
                          bucket_lanes=False)
    reqs = {0: [frame() for _ in range(6)], 1: [frame() for _ in range(6)]}
    for uid, frames in reqs.items():
        host.submit_micro("hw", uid, [[f] for f in frames], arrival_us=0)
    host.micro_step()
    host.micro_step()
    reqs[2] = [frame()]
    host.submit_micro("hw", 2, [reqs[2]], deadline_us=50, arrival_us=0)
    host.micro_step()
    out = host.micro_results["hw"]
    if not out[2].done or out[0].preemptions + out[1].preemptions != 1:
        raise AssertionError("phase 20: the deadline request did not "
                             "displace a lane")
    while host.micro_step():
        pass
    n = micro_bit_equal(np, alone, reqs, out, "preempted hotword")
    victim = 0 if out[0].preemptions else 1
    log(f"  EDF lane preemption: request {victim} snapshotted after 2 of 6 "
        f"frames for the deadline request, restored; {n} frames bit-equal "
        f"to each request alone")
    return {"victim": victim, "frames_bit_equal": n}


def replica_router(torch, np, dev, engine, bundle, model, prompts, served,
                   n_layers):
    """Phase 21: two Yi-6B replicas sharing the one weight module, each
    with its own KV (``add_replicated_model``, ``overlap=True``), serve
    12 requests under each routing policy: every policy emits one
    synchronous engine's tokens; a policy swap mid-serve adds no capture;
    no uid is lost or duplicated."""
    from repro_torch.core import capture_count
    from repro_torch.serving import MultiTenantHost, Request

    rng = np.random.default_rng(70)
    routed = prompts + [rng.integers(0, bundle.cfg.vocab - 2, int(n))
                        .astype(np.int32)
                        for n in rng.integers(16, 513, N_ROUTED - N_SERVE)]
    _, base = tick_ms(torch, engine(), routed)
    if {u: base[u] for u in range(N_SERVE)} != served:
        raise AssertionError("phase 21: the sync engine's first 8 requests "
                             "differ from phase 7's")
    host = MultiTenantHost(HOST_ARENA_BYTES, device=dev)
    router = host.add_replicated_model(
        LM_ARCH, bundle, model, replicas=2, max_slots=SERVE_SLOTS,
        cache_len=SERVE_CACHE, max_prompt=HOST_MAX_PROMPT, overlap=True)
    if any(e.params is not model for e in router.replicas):
        raise AssertionError("phase 21: the replicas do not share the "
                             "weight module")
    events = []
    router.set_on_token(events.append)
    row = {"model": f"{LM_ARCH} x 2 replicas behind a ReplicaRouter",
           "requests": N_ROUTED, "policies": {}}
    traced = {}

    def programs():
        return [(capture_count(e._decode), capture_count(e._argmax))
                for e in router.replicas]

    for k, policy in enumerate(("round-robin", "least-loaded", "locality")):
        uid0 = 100 * k
        events.clear()
        t0 = time.perf_counter()
        ctx = (main_path(torch, "the replica router (phase 21)")
               if k == 0 else contextlib.nullcontext(traced))
        with ctx as traced:
            if k == 2:
                # the swap lands mid-serve: half the requests in flight
                router.set_routing("least-loaded")
                for i in range(N_ROUTED // 2):
                    router.submit(Request(uid=uid0 + i, tokens=routed[i],
                                          max_new_tokens=SERVE_NEW))
                for _ in range(4):
                    router.step()
                before = programs()
                router.set_routing(policy)
                rest = range(N_ROUTED // 2, N_ROUTED)
            else:
                router.set_routing(policy)
                rest = range(N_ROUTED)
            for i in rest:
                router.submit(Request(uid=uid0 + i, tokens=routed[i],
                                      max_new_tokens=SERVE_NEW))
            out = host.run_all()[LM_ARCH]
        wall = time.perf_counter() - t0
        uids = set(range(uid0, uid0 + N_ROUTED))
        held = [u for e in router.replicas for u in e.results if u in uids]
        if sorted(held) != sorted(uids) or any(
                router.routed[u] != i for i, e in enumerate(router.replicas)
                for u in e.results if u in uids):
            raise AssertionError(f"phase 21 {policy}: uids held {held}")
        toks = {u - uid0: out[u].output for u in uids}
        same_tokens(f"routed {policy} vs one sync engine", toks, base)
        check_streams(f"routed {policy}", events,
                      {u: out[u].output for u in uids})
        if k == 2 and programs() != before:
            raise AssertionError(f"phase 21: the policy swap captured: "
                                 f"{before} -> {programs()}")
        row["policies"][policy] = {
            "wall_s": wall, "per_replica": [
                sum(u in uids for u in e.results) for e in router.replicas]}
    if programs() != [(1, 1), (1, 1)]:
        raise AssertionError(f"phase 21: programs {programs()}")
    k3 = traced["decode_attention"]
    if not k3 or k3 % n_layers or any(
            n for k, n in traced.items() if k != "decode_attention"):
        raise AssertionError(f"phase 21: launches {traced}")
    row.update({"launches": dict(traced), "migrations": router.migrations,
                "programs": programs()})
    log(f"  {N_ROUTED} requests under round-robin, least-loaded and "
        f"locality (swapped in mid-serve): one sync engine's tokens each "
        f"time, no uid lost or duplicated, {router.migrations} queue "
        f"migrations, decode and argmax one program a replica; per replica "
        + "; ".join(f"{p} {v['per_replica']} in {v['wall_s']:.2f} s"
                    for p, v in row["policies"].items()))
    return row, k3


def streaming_server(torch, np, dev, engine, prompts, served, n_layers):
    """Phase 22: a ``StreamingServer`` over an overlapped engine serves
    phase 7's requests, submitted from the main thread and each consumed
    by a thread of its own: the streamed tokens are phase 7's; the
    engine's programs are captured on the loop thread.  The traced run
    counts; a second server on the same (now warm) engine gives each
    request's TTFT and mean inter-token latency, and then its
    ``shutdown()`` must unblock a stream it leaves unfinished."""
    import threading

    from repro_torch.core import capture_count
    from repro_torch.launch.serve import StreamingServer
    from repro_torch.serving import default_clock

    eng = engine(overlap=True)
    ticks = []

    def timed_step():
        """The engine's step, its host-clock span recorded with whether
        requests were queued and whether it decoded without a prefill."""
        t0 = time.perf_counter()
        more = type(eng).step(eng)
        ticks.append((t0, time.perf_counter(), bool(eng.queue),
                      eng.last_step["decoded"]
                      and not eng.last_step["prefill_tokens"]))
        return more

    def serve(long_tail):
        server = StreamingServer(eng).start()
        got, t_sub, errors = {}, {}, []

        def consume(uid):
            try:
                got[uid] = list(server.stream(uid, timeout=300))
            except RuntimeError as e:
                errors.append((uid, str(e)))
        threads = []
        for uid, p in enumerate(prompts):
            t_sub[uid] = default_clock()
            server.submit(p, max_new_tokens=SERVE_NEW, uid=uid)
            threads.append(threading.Thread(target=consume, args=(uid,)))
            threads[-1].start()
        for th in threads:
            th.join(timeout=300)
        cut = None
        if long_tail:
            # a request whose budget outlasts the server: shutdown() must
            # end its stream with an error, not leave its consumer waiting
            cut = server.submit(prompts[0], max_new_tokens=SERVE_CACHE // 2,
                                uid=len(prompts))
            th = threading.Thread(target=consume, args=(cut,))
            th.start()
            while eng.results.get(cut) is None or \
                    len(eng.results[cut].output) < 4:
                time.sleep(0.01)
            threads.append(th)
        server.shutdown()
        for th in threads:
            th.join(timeout=60)
        if any(th.is_alive() for th in threads):
            raise AssertionError("phase 22: a consumer still waits")
        toks = {u: [e.token for e in got[u]] for u in range(len(prompts))}
        same_tokens("streamed vs phase 7", toks, served)
        check_streams("streamed", [e for u in sorted(got) for e in got[u]],
                      {u: eng.results[u].output for u in got})
        if long_tail and not (len(errors) == 1 and errors[0][0] == cut
                              and "shut down" in errors[0][1]):
            raise AssertionError(f"phase 22: shutdown left {errors}")
        return {u: ((got[u][0].t_us - t_sub[u]) / 1e3,
                    np.diff([e.t_us for e in got[u]]) / 1e3)
                for u in range(len(prompts))}

    with main_path(torch, "the streaming server (phase 22)") as traced:
        serve(long_tail=False)
    programs = {n: capture_count(p) for n, p in eng.programs().items()}
    if programs["decode"] != 1 or programs["argmax"] != 1:
        raise AssertionError(f"phase 22: programs {programs}")
    k3 = traced["decode_attention"]
    if not k3 or k3 % n_layers:
        raise AssertionError(f"phase 22: launches {traced}")
    # the timed run's cyclic-collector pauses (ms, generation)
    pauses = []

    def on_gc(when, info):
        if when == "start":
            on_gc.t0 = time.perf_counter()
        else:
            pauses.append(((time.perf_counter() - on_gc.t0) * 1e3,
                           info["generation"]))
    eng.step = timed_step
    gc.callbacks.append(on_gc)
    try:
        lat = serve(long_tail=True)
    finally:
        gc.callbacks.remove(on_gc)
        del eng.step
    # the loop's decode ticks without a prefill, with requests queued
    # behind the slots and without, and the loop's time between ticks
    spans = {q: [(b - a) * 1e3 for a, b, qd, dec in ticks if dec and qd == q]
             for q in (True, False)}
    gaps = [(ticks[i + 1][0] - ticks[i][1]) * 1e3
            for i in range(len(ticks) - 1)]
    tick = {f"median_tick_ms_{'queued' if q else 'no_queue'}":
            statistics.median(v) if v else None for q, v in spans.items()}
    tick["median_gap_ms"] = statistics.median(gaps)
    tick["max_gap_ms"] = max(gaps)
    # the longest ticks: ms, requests queued, prefill tokens run
    longest = sorted(((b - a) * 1e3, qd, not dec) for a, b, qd, dec in ticks)
    row = {"model": f"{LM_ARCH} bfloat16 through a StreamingServer",
           "requests": len(prompts), "launches": dict(traced),
           "programs": programs,
           "ttft_ms": [lat[u][0] for u in sorted(lat)],
           "mean_itl_ms": [float(lat[u][1].mean()) for u in sorted(lat)],
           "median_itl_ms": [float(np.median(lat[u][1])) for u in sorted(lat)],
           "max_itl_ms": [float(lat[u][1].max()) for u in sorted(lat)],
           "longest_ticks": [{"ms": ms, "queued": qd, "prefill_or_idle": pi}
                             for ms, qd, pi in longest[-4:]],
           "gc_pauses": {"n": len(pauses),
                         "total_ms": sum(p for p, _ in pauses),
                         "max_ms": max((p for p, _ in pauses), default=0.0),
                         "gen2": sum(g == 2 for _, g in pauses)}, **tick}
    log("  phase 7's tokens streamed to 8 consumer threads, programs "
        f"{programs} captured on the loop thread; shutdown() ended an "
        "unfinished stream with an error; TTFT / ITL mean, median, max ms: "
        + ", ".join(f"{t:.1f}/{i.mean():.2f},{np.median(i):.2f},{i.max():.1f}"
                    for t, i in lat.values())
        + "; loop ticks (decode, no prefill) "
        + ", ".join(f"{k} {v:.3f}" for k, v in tick.items()
                    if v is not None)
        + "; longest ticks ms " + ", ".join(f"{ms:.1f}" for ms, _, _ in
                                            longest[-4:])
        + f"; cyclic collector {len(pauses)} pauses, "
        f"{row['gc_pauses']['total_ms']:.1f} ms in all, longest "
        f"{row['gc_pauses']['max_ms']:.1f} ms")
    return row, k3


def profiles(torch, np, dev, engine):
    """Phase 23: ``MicroProfiler`` on vww int8 and fc_stack int8 under the
    ``"cuda"`` tag chain (per-op µs, the bottleneck, the per-op sum
    against the replayed invoke; K1 launches = (warm-up + timed) x the
    int8 FC ops, per-op and invoked), then ``measure_compile_and_step``
    on a fresh Yi-6B engine's decode program: capture against replay.
    The profiles run traced for the counts, then again untraced for the
    times reported (the trace slows every launch)."""
    from repro_torch.apps.models import (build_fc_stack, build_vww,
                                         representative_dataset)
    from repro_torch.core import (AllOpsResolver, MicroInterpreter,
                                  MicroModel, OpCode, export)
    from repro_torch.core.profiler import (MicroProfiler,
                                           measure_compile_and_step)

    res = AllOpsResolver(tags=("cuda", "reference"))
    cases = {}
    for name, build in (("vww int8", build_vww),
                        ("fc_stack int8", build_fc_stack)):
        gb = build()
        m = MicroModel(export(gb, representative_dataset(gb),
                              quantize_int8=True))
        it = MicroInterpreter(m, res, MicroInterpreter.required_arena_size(
            m, res), device=dev)
        xs = [np.random.default_rng(23).normal(
            0, 1, gb.tensors[t].shape).astype(np.float32) for t in gb.inputs]
        n_fc = sum(op.opcode == OpCode.FULLY_CONNECTED
                   and m.tensor(op.inputs[0]).dtype == "int8"
                   for op in m.operators)
        cases[name] = (it, xs, n_fc, len(m.operators))

    def profile_all():
        reps = {}
        for name, (it, xs, _, n_ops) in cases.items():
            rep = MicroProfiler.profile(it, xs, warmup=PROFILE_WARMUP,
                                        iters=PROFILE_ITERS)
            if len(rep.per_op) != n_ops or rep.device != it.device:
                raise AssertionError(f"phase 23 {name}: {len(rep.per_op)} "
                                     f"ops profiled on {rep.device}")
            reps[name] = rep
        return reps

    with main_path(torch, "the profiler (phase 23)") as traced:
        profile_all()
    want_k1 = sum(2 * (PROFILE_WARMUP + PROFILE_ITERS) * n_fc
                  for _, _, n_fc, _ in cases.values())
    # the reported times: the same profiles again, untraced
    out = {}
    for name, rep in profile_all().items():
        out[name] = {"per_op_us": {f"{p.index} {p.op_name}": p.wall_us
                                   for p in rep.per_op},
                     "by_op_type_us": rep.by_op_type(),
                     "bottleneck": rep.bottleneck(),
                     "per_op_sum_us": rep.eager_total_us,
                     "replayed_invoke_us": rep.fused_total_us}
        log(rep.render())
    eng = engine()
    timing = measure_compile_and_step(
        eng._decode, (eng.params, eng.cache, eng.cur_tokens, eng.lengths),
        iters=PROFILE_ITERS)
    if "CONV" not in out["vww int8"]["bottleneck"]:
        raise AssertionError(f"phase 23: vww's bottleneck "
                             f"{out['vww int8']['bottleneck']}")
    if traced["quant_matmul"] != want_k1:
        raise AssertionError(f"phase 23: K1 launched "
                             f"{traced['quant_matmul']} times, expected "
                             f"{want_k1}")
    out["yi-6b decode program"] = {
        "first_call_s": timing.compile_us / 1e6,
        "replay_ms": timing.step_us / 1e3, "replays": timing.iters}
    log(f"  Yi-6B decode program: first call (eager run + capture) "
        f"{timing.compile_us / 1e6:.3f} s, replay median "
        f"{timing.step_us / 1e3:.3f} ms over {timing.iters}")
    return {"model": "MicroProfiler and measure_compile_and_step",
            "profiles": out, "launches": dict(traced)}, dict(traced)


# phase 24: the calibration cost model.  Yi-6B is calibrated on
# CAL_REQUESTS prompt lengths (phase 7's prompts first, the rest drawn
# from its 16-512 range), every calibrate() option on: the chunk sizes,
# decode slots, paged blocks, precisions, micro lanes and replica counts
# below; then served from the profile, CAL_NEW tokens a request
CAL_REQUESTS, CAL_NEW = 64, 8
CAL_CHUNKS = (0, 128, 256)
CAL_SLOTS = (1, 2, 4)
CAL_BLOCKS = (8, 16, 32, 64)
CAL_QUANT = (("fp32", "fp32"), ("int8", "int8"), ("int4", "int8"))
CAL_LANES = (1, 2, 4, 8, 16)
# the micro demand the lane width is solved for: the widest candidate's
# lanes busy on every one of CAL_REQUESTS ticks (one tick would weigh
# each width's capture against a single dispatch)
CAL_LANE_DEMAND = (CAL_LANES[-1],) * CAL_REQUESTS
CAL_REPLICAS = (1, 2)
# a decode throughput one replica of 4 slots cannot give and two can, for
# a measured 4-slot step of 6-12 ms (phase 7's replay takes ~9)
CAL_TARGET_TOK_PER_US = 1.5 * SERVE_SLOTS / 9000.0
# Mamba2-780m's measured levels, each inside the one-shot contract
# (S % min(128, S) == 0), and its chunk sizes
SSM_CAL_LEVELS = (64, 128, 256, 384, 512)
SSM_CAL_CHUNKS = (0, 128)
# fc_stack int8 requests through the host's micro tenant
CAL_FC_REQUESTS = 24


def calibration_workload(np, vocab):
    """Phase 7's prompts, then seeded prompts of 16-512 tokens up to
    ``CAL_REQUESTS``."""
    rng = np.random.default_rng(24)
    more = [rng.integers(0, vocab - 2, int(n)).astype(np.int32)
            for n in rng.integers(16, 513, CAL_REQUESTS - N_SERVE)]
    return serving_workload(np, vocab) + more


def log_profile(prof) -> None:
    """Every measured candidate and the solved configuration."""
    from repro_torch.core.costmodel import solve_precision

    def line(label, costs, key):
        log(f"  {label}: " + "; ".join(
            f"{getattr(c, key)} {c.compile_us / 1e3:.1f}/"
            f"{c.step_us / 1e3:.3f}" for c in costs)
            + "  (compile ms / step ms)")
    line("prefill levels", prof.bucket_costs, "length")
    line("chunk sizes", prof.chunk_costs, "chunk")
    line("decode slots", prof.decode_costs, "slots")
    line("paged blocks", prof.block_costs, "block")
    line("micro lanes", prof.lane_costs, "lanes")
    if prof.quant_costs:
        log("  precisions: " + "; ".join(
            f"{q.weight_dtype}/{q.kv_dtype} {q.compile_us / 1e3:.1f}/"
            f"{q.step_us / 1e3:.3f} ms, {q.hbm_bytes:,} B"
            for q in prof.quant_costs))
        pick = solve_precision(prof.quant_costs)
        log(f"  solve_precision (no bounds: the smallest footprint): "
            f"{pick.weight_dtype}/{pick.kv_dtype}")
    log(f"  solved: levels {prof.bucket_levels}, prefill_chunk "
        f"{prof.prefill_chunk}, kv_block {prof.kv_block}, micro_lanes "
        f"{prof.micro_lanes}, replicas {prof.replicas}; predicted prefill "
        f"programs {prof.predicted_compiles}; expected "
        f"{prof.expected_us / 1e3:.1f} ms against the default table's "
        f"{prof.default_expected_us / 1e3:.1f} ms (feasible "
        f"{prof.feasible}); meta {prof.meta}")


def profile_row(prof) -> dict:
    """The profile's fields for the models line."""
    from repro_torch.core.costmodel import solve_precision

    d = json.loads(prof.to_json())
    if prof.quant_costs:
        pick = solve_precision(prof.quant_costs)
        d["solve_precision"] = [pick.weight_dtype, pick.kv_dtype]
    return d


def calibrate_counted(torch, fn):
    """``fn()`` (a calibration, untraced) with every launch count set to
    0 just before it; returns (its result, the launches counted, its
    seconds, the peak device memory over it)."""
    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in _build.launches:
        _build.launches[name] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, {k: n for k, n in _build.launches.items() if n}, seconds,
            torch.cuda.max_memory_allocated())


def cost_model(torch, np, dev, bundle, model, served):
    """Phase 24: the calibration cost model on the card.  (a) calibrate
    Yi-6B (phase 7's weights) untraced, every option on; save the profile
    to the port's cache and load it back.  (b) ``from_profile`` serves
    the calibrated workload as a main path: tokens bit-equal to an engine
    configured by hand with the same table, chunk and block, prefill
    programs = ``predicted_compiles``, K3 or K4 launches traced = counted,
    memory flat, phase 7's layer-0 K/V check; a ``MultiTenantHost``
    with the profile, two Yi-6B tenants sharing its table and fc_stack
    int8 at the profile's lane width, through ``run_all``.  (c) calibrate
    Mamba2-780m on levels inside the one-shot contract and serve from its
    profile (K8).  (d) the profile never crosses devices.  Returns (rows,
    the phase's summary, each run's launches by kernel)."""
    from repro_torch.apps.models import build_fc_stack, representative_dataset
    from repro_torch.configs import get_config
    from repro_torch.core import (AllOpsResolver, BucketTable, MicroModel,
                                  OpCode, calibrate, export,
                                  load_cached_profile, save_cached_profile)
    from repro_torch.models import get_model
    from repro_torch.serving import MultiTenantHost, Request, ServingEngine

    t_phase = time.perf_counter()
    cfg, n_layers = bundle.cfg, bundle.cfg.n_layers
    prompts = calibration_workload(np, cfg.vocab)
    lengths = [len(p) for p in prompts]
    res = AllOpsResolver(tags=("cuda", "reference"))
    gb = build_fc_stack()
    fc = MicroModel(export(gb, representative_dataset(gb),
                           quantize_int8=True))
    runs, rows = {}, []

    # (a) the calibration, untraced
    prof, cal_launches, cal_s, cal_peak = calibrate_counted(
        torch, lambda: calibrate(
            bundle, model, lengths, cache_len=SERVE_CACHE, seed=24,
            chunk_candidates=CAL_CHUNKS, decode_slots=CAL_SLOTS,
            block_candidates=CAL_BLOCKS, new_tokens=CAL_NEW,
            quant_candidates=CAL_QUANT, lane_candidates=CAL_LANES,
            lane_demand=CAL_LANE_DEMAND, micro=(fc, res),
            replica_candidates=CAL_REPLICAS,
            target_tokens_per_us=CAL_TARGET_TOK_PER_US, device=dev))
    log(f"  (a) {cfg.arch_id} calibrated in {cal_s:.1f} s, peak device "
        f"memory {cal_peak / 2**30:.2f} GiB; launches counted (untraced) "
        + ", ".join(f"{k} {n}" for k, n in cal_launches.items()))
    log_profile(prof)
    for name, n in cal_launches.items():
        runs.setdefault(name, {})["phase 24 (a) calibration"] = n
    want_meta = {"device": "cuda",
                 "device_name": torch.cuda.get_device_name(dev)}
    if not prof.matches_device(dev) or \
            {k: prof.meta[k] for k in want_meta} != want_meta:
        raise AssertionError(f"phase 24: profile meta {prof.meta}")
    if prof.replicas != 2 or prof.micro_lanes not in CAL_LANES or \
            prof.kv_block not in CAL_BLOCKS:
        raise AssertionError(f"phase 24: replicas {prof.replicas}, "
                             f"micro_lanes {prof.micro_lanes}, kv_block "
                             f"{prof.kv_block}")
    for name in ("quant_matmul", "decode_attention", "paged_decode_attention",
                 "dequant_matmul", "dequant_matmul_i4"):
        if not cal_launches.get(name):
            raise AssertionError(f"phase 24 (a): {name} never launched")
    path = save_cached_profile(prof)
    loaded = load_cached_profile(prof.model_key)
    if loaded is None or loaded.to_json() != prof.to_json() or \
            loaded != prof:
        raise AssertionError("phase 24: the cached profile differs")
    log(f"  saved to the port's profile cache ({Path(path).relative_to(ROOT)}"
        f") and loaded back equal")
    rows.append({"model": f"{cfg.arch_id} calibration profile",
                 "seconds": cal_s, "peak_memory_bytes": cal_peak,
                 "launches_counted": cal_launches,
                 "profile": profile_row(prof)})

    # (b) served from the profile
    engine = family_engine(dev, bundle, model)
    eng = ServingEngine.from_profile(bundle, model, loaded,
                                     max_slots=SERVE_SLOTS, device=dev)
    if (eng.bucket_table != prof.bucket_table()
            or eng.chunk_tokens != prof.prefill_chunk
            or eng.kv_block != prof.kv_block):
        raise AssertionError("phase 24: from_profile did not apply the "
                             "profile")
    kernel = "paged_decode_attention" if prof.kv_block else \
        "decode_attention"
    srow, toks = serve_main(torch, np, dev, eng, prompts,
                            "the from-profile engine (phase 24 (b))",
                            new=CAL_NEW)
    want = dict.fromkeys(srow["launches"], 0)
    want[kernel] = n_layers * srow["decode_steps"]
    if srow["launches"] != want:
        raise AssertionError(f"phase 24 (b): launches {srow['launches']}, "
                             f"expected {want}")
    runs.setdefault(kernel, {})["phase 24 (b) from profile"] = \
        srow["launches"][kernel]
    chunked = any(eng.chunk_tokens and len(p) - 1 > eng.chunk_tokens
                  and -(-(len(p) - 1) // eng.chunk_tokens)
                  * eng.chunk_tokens <= SERVE_CACHE for p in prompts)
    if eng.prefill_compiles() != prof.predicted_compiles or \
            eng.chunk_compiles() != int(chunked):
        raise AssertionError(f"phase 24: {eng.prefill_compiles()} prefill "
                             f"programs (predicted "
                             f"{prof.predicted_compiles}), "
                             f"{eng.chunk_compiles()} chunk programs")
    log(f"  prefill programs {eng.prefill_compiles()} = predicted_compiles; "
        f"chunk programs {eng.chunk_compiles()}; buckets hit "
        f"{eng.bucket_table.buckets()}")
    kv = bucketed_vs_exact(torch, np, engine(prefill_buckets=False), eng,
                           prompts[:N_SERVE])
    phase7 = tokens_equal(
        "the from-profile engine's first tokens vs phase 7's",
        {u: toks[u] for u in range(N_SERVE)},
        {u: served[u][:CAL_NEW] for u in range(N_SERVE)})
    del eng
    hand = engine(prefill_buckets=BucketTable.from_levels(
        prof.bucket_levels), prefill_chunk=prof.prefill_chunk or None,
        kv_block=prof.kv_block or None)
    hrow, hand_toks = serve_lm(torch, np, dev, hand, prompts, new=CAL_NEW)
    same_tokens("the from-profile engine vs one configured by hand",
                toks, hand_toks)
    del hand
    default = engine()
    cold, _ = serve_lm(torch, np, dev, default, prompts, new=CAL_NEW)
    drow, _ = serve_lm(torch, np, dev, default, prompts, new=CAL_NEW)
    del default
    torch.cuda.empty_cache()

    def numbers(r):
        return {"median_decode_tick_ms": r["median_decode_step_ms"],
                "prefill_ms_sum": sum(r["prefill_ms"]),
                "prefill_programs": r["programs"]["prefill"]}
    # cold: each configuration's first pass, its captures included (what
    # the solver's objective prices); warm: a second pass, none
    compare = {"cold": {"from_profile": numbers(hrow),
                        "default": numbers(cold)},
               "warm": {"from_profile": numbers(srow),
                        "default": numbers(drow)}}
    for when, pair in compare.items():
        a, b = pair["from_profile"], pair["default"]
        log(f"  {when}, untraced, the same {len(prompts)} requests: median "
            f"decode tick {a['median_decode_tick_ms']:.3f} ms from the "
            f"profile vs {b['median_decode_tick_ms']:.3f} ms default; "
            f"prefill ms summed {a['prefill_ms_sum']:.1f} vs "
            f"{b['prefill_ms_sum']:.1f} ({a['prefill_programs']} vs "
            f"{b['prefill_programs']} prefill programs)")
    rows.append({"model": f"{cfg.arch_id} served from its profile",
                 "serving": srow, "layer0_kv": kv, "vs_phase7": phase7,
                 "vs_default": compare, "hand_configured_tokens_equal": True})

    # (b) the host: the profile's table shared by two Yi-6B tenants, the
    # fc_stack tenant at the profile's lane width
    alone = lone_interpreter(dev, fc, res)
    host = MultiTenantHost(HOST_ARENA_BYTES, profile=loaded, device=dev)
    engines = [host.add_model(name, bundle, model, max_slots=SERVE_SLOTS,
                              cache_len=SERVE_CACHE,
                              max_prompt=HOST_MAX_PROMPT)
               for name in ("yi-a", "yi-b")]
    host.add_ragged_micro("fc", fc, res, lanes=prof.micro_lanes,
                          bucket_lanes=False)
    if any(e.bucket_table is not host.prompt_buckets
           or e.chunk_tokens != prof.prefill_chunk for e in engines) or \
            host.prompt_buckets != prof.bucket_table():
        raise AssertionError("phase 24: the host's tenants do not share the "
                             "profile's table and chunk")
    rng = np.random.default_rng(24)
    fc_reqs = {i: [rng.normal(0, 1, input_shape(fc)).astype(np.float32)]
               for i in range(CAL_FC_REQUESTS)}
    for uid, p in enumerate(prompts):
        host.submit("yi-a", Request(uid=uid, tokens=p,
                                    max_new_tokens=CAL_NEW))
    for uid, p in enumerate(prompts[:N_SERVE]):
        host.submit("yi-b", Request(uid=uid, tokens=p,
                                    max_new_tokens=CAL_NEW))
    for uid, frames in fc_reqs.items():
        host.submit_micro("fc", uid, [[f] for f in frames])
    n_fc = sum(op.opcode == OpCode.FULLY_CONNECTED
               and fc.tensor(op.inputs[0]).dtype == "int8"
               for op in fc.operators)
    bucket = host.ragged._buckets["fc"]
    waves = bucket.dispatch_count
    with main_path(torch, "the host from the profile (phase 24 (b))") \
            as traced:
        out = host.run_all()
    waves = bucket.dispatch_count - waves
    same_tokens("the host's first Yi-6B tenant vs the from-profile engine",
                {u: r.output for u, r in out["yi-a"].items()}, toks)
    same_tokens("the host's second Yi-6B tenant vs the from-profile engine",
                {u: r.output for u, r in out["yi-b"].items()},
                {u: toks[u] for u in range(N_SERVE)})
    frames = micro_bit_equal(np, alone, fc_reqs, host.micro_results["fc"],
                             "fc")
    k3 = traced["decode_attention"]
    if traced["quant_matmul"] != n_fc * waves or not k3 or k3 % n_layers \
            or any(n for k, n in traced.items()
                   if k not in ("quant_matmul", "decode_attention")):
        raise AssertionError(f"phase 24 host: launches {traced} ({waves} fc "
                             f"waves of {n_fc} int8 FC ops)")
    runs.setdefault("quant_matmul", {})["phase 24 (b) host"] = \
        traced["quant_matmul"]
    runs.setdefault("decode_attention", {})["phase 24 (b) host"] = k3
    log(f"  host: both Yi-6B tenants on the profile's table "
        f"{host.prompt_buckets.levels} and chunk {prof.prefill_chunk}, "
        f"fc_stack at {prof.micro_lanes} lanes ({waves} waves, {frames} "
        f"frames bit-equal to each request alone)")
    rows.append({"model": "MultiTenantHost from the profile",
                 "tenants": ["yi-a", "yi-b", "fc"],
                 "levels": host.prompt_buckets.levels,
                 "chunk": prof.prefill_chunk, "micro_lanes": prof.micro_lanes,
                 "fc_waves": waves, "micro_frames_bit_equal": frames,
                 "launches": traced})
    del host, engines
    torch.cuda.empty_cache()

    # (c) a recurrent calibration: Mamba2-780m
    sbundle = get_model(get_config(SSM_ARCH))
    smodel = sbundle.init(torch.Generator(dev).manual_seed(0))
    sprompts = recurrent_workload(np, sbundle.cfg.vocab, 24, N_SERVE, 0, 0,
                                  True)
    sprof, s_launches, s_s, s_peak = calibrate_counted(
        torch, lambda: calibrate(
            sbundle, smodel, [len(p) for p in sprompts],
            cache_len=SERVE_CACHE, seed=24, candidate_levels=SSM_CAL_LEVELS,
            chunk_candidates=SSM_CAL_CHUNKS, device=dev))
    log(f"  (c) {SSM_ARCH} calibrated in {s_s:.1f} s, peak device memory "
        f"{s_peak / 2**30:.2f} GiB; launches counted (untraced) "
        + ", ".join(f"{k} {n}" for k, n in s_launches.items()))
    log_profile(sprof)
    if not s_launches.get("ssd_scan"):
        raise AssertionError("phase 24 (c): K8 never launched")
    runs.setdefault("ssd_scan", {})["phase 24 (c) calibration"] = \
        s_launches["ssd_scan"]
    seng = ServingEngine.from_profile(sbundle, smodel, sprof,
                                      max_slots=SERVE_SLOTS, device=dev)
    if seng.bucket_table is not None or \
            seng.chunk_tokens != sprof.prefill_chunk:
        raise AssertionError("phase 24 (c): from_profile did not apply the "
                             "profile")
    s_row, s_toks = serve_main(torch, np, dev, seng, sprompts,
                               "the recurrent from-profile engine "
                               "(phase 24 (c))", new=CAL_NEW)
    want = dict.fromkeys(s_row["launches"], 0)
    want["ssd_scan"] = sbundle.cfg.n_layers * (s_row["prefills"]
                                               + s_row["chunk_steps"])
    if s_row["launches"] != want or not want["ssd_scan"]:
        raise AssertionError(f"phase 24 (c): launches {s_row['launches']}, "
                             f"expected {want}")
    runs["ssd_scan"]["phase 24 (c) from profile"] = want["ssd_scan"]
    del seng
    shand = ServingEngine(sbundle, smodel, max_slots=SERVE_SLOTS,
                          cache_len=SERVE_CACHE,
                          prefill_chunk=sprof.prefill_chunk or None,
                          device=dev)
    _, shand_toks = serve_lm(torch, np, dev, shand, sprompts, new=CAL_NEW)
    same_tokens(f"the {SSM_ARCH} from-profile engine vs one configured by "
                f"hand", s_toks, shand_toks)
    del shand, smodel
    torch.cuda.empty_cache()
    rows.append({"model": f"{SSM_ARCH} calibration profile", "seconds": s_s,
                 "peak_memory_bytes": s_peak,
                 "launches_counted": s_launches,
                 "profile": profile_row(sprof), "serving": s_row})
    # (d) the profile never crosses devices: the card's on the CPU ...
    refusals = []
    try:
        ServingEngine.from_profile(bundle, model, loaded,
                                   max_slots=SERVE_SLOTS, device="cpu")
    except ValueError as e:
        refusals.append(str(e))
    # ... and a CPU calibration (reduced Yi-6B) on the card
    rcfg = get_config(LM_ARCH, reduced=True)
    rbundle = get_model(rcfg)
    cpu_model = rbundle.init(torch.Generator("cpu").manual_seed(0))
    cpu_prof = calibrate(rbundle, cpu_model, [6, 9, 17, 30] * 2,
                         cache_len=64, candidate_levels=(8, 16, 32, 64),
                         chunk_candidates=(0, 8), iters=2, device="cpu")
    if cpu_prof.meta.get("device") != "cpu" or cpu_prof.matches_device(dev):
        raise AssertionError(f"phase 24: CPU profile meta {cpu_prof.meta}")
    try:
        ServingEngine.from_profile(
            rbundle, rbundle.init(torch.Generator(dev).manual_seed(0)),
            cpu_prof, max_slots=2, device=dev)
    except ValueError as e:
        refusals.append(str(e))
    if len(refusals) != 2 or not all("measured on" in r for r in refusals):
        raise AssertionError(f"phase 24 (d): refusals {refusals}")
    log("  (d) refused: " + " | ".join(r[:110] for r in refusals))

    rows.append({"model": "profiles across devices", "refusals": refusals,
                 "cpu_profile_meta": cpu_prof.meta})
    info = {"phase": "phase 24 cost model",
            "seconds": time.perf_counter() - t_phase,
            "calibration_seconds": {cfg.arch_id: cal_s, SSM_ARCH: s_s},
            "calibration_peak_memory_bytes": {cfg.arch_id: cal_peak,
                                              SSM_ARCH: s_peak},
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return rows, info, runs


# ---------------------------------------------------------------------------
# phase 25: training
# ---------------------------------------------------------------------------

# Yi-6B at full width, 8 of its 32 layers (the cut PERF.md §4 lists)
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 30
# the schedule and clip tools/train_lr_scan.py chose (PERF.md §6):
# a cosine from 2.5e-4 to 0.3 of it, no warm-up; the run's global norm
# stays within 0.82-5.98 (NVIDIA H100 80GB HBM3, 700 W), so a clip of 10
# never acts (the trainer's default 1.0 would scale the first steps by
# ~1/6)
TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_FLOOR = 2.5e-4, 0, 0.3
TRAIN_MAX_GRAD_NORM = 10.0
# the last steps run traced (device ms a step, busy share); the median
# step is taken over the untraced replays before them
TRAIN_TRACED = 4
# the JAX package's bar (test_loss_decreases_on_markov_data)
TRAIN_LOSS_DROP = 0.5
EAGER_STEPS = 3
# captured against eager, bf16: the embedding's backward accumulates with
# atomics, so gradients may differ in their last bf16 bits; Adam's step
# m/(sqrt(v) + 1e-8) of an element whose gradient is that close to 0 may
# then differ by up to 2 lr a step (a flipped sign), and the bf16
# parameter by one ulp of the leaf's largest entry; the losses, taken
# over 8,192 tokens, within 1e-3
EAGER_LOSS_RTOL = 1e-3
TRAIN_PROMPT, TRAIN_NEW = 64, 16
# (e) the six families reduced, float32, card against CPU, each step from
# the same state: metrics within 1e-5 relative; moments (linear in the
# gradient) within 1e-4 of each leaf's largest entry, as gradients; the
# parameters within 1e-5 of each leaf's largest entry + lr / 2 (Adam's
# step of an element whose gradient is within rounding of 0 is a fraction
# of lr that rounding sets), and no more than 1% of a leaf's elements
# (at least 1) beyond 1e-5 of its largest entry
FAMILY_ARCHS = ("yi-6b", "deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b",
                "paligemma-3b", "whisper-large-v3")
FAMILY_LR, FAMILY_STEPS = 1e-3, 3
METRIC_RTOL, MOMENT_TOL, PARAM_TOL, PARAM_OUTLIERS = 1e-5, 1e-4, 1e-5, 1e-2


def train_flops_per_token(cfg, model) -> float:
    """PaLM's count (appendix B): 6 N + 12 L H dh S, N the parameters
    but the embedding table; the remat recompute is not counted."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if name != "embed")
    return 6 * n + 12 * cfg.n_layers * cfg.n_heads * cfg.dh * TRAIN_SEQ


def bits(torch, t):
    """A tensor's bits as integers (bit-equality, -0.0 and NaNs
    included)."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}
                  .get(t.dtype, t.dtype))


def train_step_fn(bundle, lr):
    """Phase 25's train step: remat, one MoE group, its clip."""
    from repro_torch.training import make_train_step

    return make_train_step(bundle.loss, lr=lr,
                           max_grad_norm=TRAIN_MAX_GRAD_NORM, remat=True,
                           data_shards=1)


def eager_steps(torch, np, dev, bundle, lr, batches):
    """(b), run first: ``EAGER_STEPS`` steps under ``disable_capture()``
    from the seed-0 weights; returns their losses and the parameters
    after them, on the host."""
    from repro_torch.core import capture_count, disable_capture
    from repro_torch.training import init_train_state

    model = bundle.init(torch.Generator(dev).manual_seed(0))
    state = init_train_state(model)
    step = train_step_fn(bundle, lr)
    losses = []
    with disable_capture():
        for batch in batches[:EAGER_STEPS]:
            _, m = step(state, batch)
            losses.append(float(m["loss"]))
    if capture_count(step.program):
        raise AssertionError("an eager step recorded a signature")
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params


def eager_vs_captured(torch, eager_params, model, lrs):
    """(b)'s comparison after the captured run's third step, leaf by leaf
    on the device: the largest difference against its bound, and the
    share of elements bit-equal."""
    worst, equal, total = 0.0, 0, 0
    lr_sum = sum(lrs[:EAGER_STEPS])
    for name, p in model.named_parameters():
        want = eager_params[name].to(p.device)
        diff = float((p.float() - want.float()).abs().max())
        bound = 2 * lr_sum + float(p.float().abs().max()) * 2.0 ** -7
        if not diff <= bound:
            raise AssertionError(f"(b) {name}: captured and eager differ by "
                                 f"{diff} after {EAGER_STEPS} steps, bound "
                                 f"{bound}")
        worst = max(worst, diff / bound)
        equal += int((bits(torch, p) == bits(torch, want)).sum())
        total += p.numel()
        del want
    return worst, equal / total


def successor_share(np, successors, prompts, outputs) -> float:
    """The share of greedy tokens that follow their previous token in the
    Markov source's table (an EOS or a padded-vocab token has no row)."""
    hits = n = 0
    for uid, out in outputs.items():
        prev = int(prompts[uid][-1])
        for tok in out:
            n += 1
            hits += prev < len(successors) and tok in successors[prev]
            prev = int(tok)
    return hits / n


def serve_trained(torch, np, dev, bundle, params, prompts):
    """Up to ``TRAIN_NEW`` greedy tokens for each prompt (an EOS ends a
    request, as in the JAX engine) through a ``ServingEngine`` on
    ``params`` under the default tags."""
    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(bundle, params, max_slots=len(prompts),
                        cache_len=2 * TRAIN_PROMPT, device=dev)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=TRAIN_NEW))
    out = {u: list(r.output) for u, r in eng.run().items()}
    del eng
    return out


def carry_state(torch, dst, src) -> None:
    """Copy a TrainState's parameters, moments and step into another's
    tensors, in place (their addresses, the programs' inputs, stay)."""
    with torch.no_grad():
        for (_, d), (_, s_) in zip(dst.params.named_parameters(),
                                   src.params.named_parameters()):
            d.copy_(s_)
        for mom in ("mu", "nu"):
            for n, d in getattr(dst.opt, mom).items():
                d.copy_(getattr(src.opt, mom)[n])
        dst.opt.step.copy_(src.opt.step)


def leaf_check(torch, label, got, want, tol, slack=0.0, outliers=None):
    """``got`` against ``want`` (tensors by name): every element within
    ``tol`` of the leaf's largest |entry| + ``slack``; with
    ``outliers``, at most that share of a leaf's elements (at least 1)
    beyond ``tol`` of it.  Returns the largest difference over the
    leaf's largest entry."""
    worst = 0.0
    for name, w in want.items():
        g = got[name].detach().float().cpu()
        w = w.detach().float().cpu()
        top = float(w.abs().max()) or 1.0
        d = (g - w).abs()
        if float(d.max()) > tol * top + slack:
            raise AssertionError(f"{label} {name}: off by {float(d.max())} "
                                 f"(largest entry {top}, bound "
                                 f"{tol * top + slack})")
        if outliers is not None:
            n_out = int((d > tol * top).sum())
            if n_out > max(outliers * d.numel(), 1):
                raise AssertionError(f"{label} {name}: {n_out} of "
                                     f"{d.numel()} elements beyond {tol} "
                                     f"of the largest entry")
        worst = max(worst, float(d.max()) / top)
    return worst


def family_train_card_vs_cpu(torch, np, dev):
    """(e): each family's reduced float32 config, ``FAMILY_STEPS`` train
    steps on the card (captured) and on the CPU, the card's state set to
    the CPU's before each step; rows of the largest differences."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core import capture_count
    from repro_torch.core.executor import setup_device
    from repro_torch.data import make_batches
    from repro_torch.models import get_model
    from repro_torch.training import init_train_state, make_train_step

    setup_device(dev)
    rows = []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch, reduced=True)
        bundle = get_model(cfg)
        cpu_model = bundle.init(torch.Generator().manual_seed(0))
        states = {"cpu": init_train_state(cpu_model),
                  "card": init_train_state(copy.deepcopy(cpu_model).to(dev))}
        steps = {w: make_train_step(bundle.loss, lr=FAMILY_LR, remat=True,
                                    data_shards=1) for w in states}
        row = {"model": f"{cfg.arch_id} float32 train step card vs CPU",
               "steps": FAMILY_STEPS, "metric_rel": 0.0, "moment": 0.0,
               "param": 0.0}
        for i, batch in enumerate(make_batches(cfg, 4, 32, FAMILY_STEPS)):
            carry_state(torch, states["card"], states["cpu"])
            _, want = steps["cpu"](states["cpu"], batch)
            _, got = steps["card"](states["card"], batch)
            for k, w in want.items():
                rel = abs(float(got[k]) - float(w)) / max(abs(float(w)),
                                                          1e-30)
                if not rel <= METRIC_RTOL:
                    raise AssertionError(f"(e) {arch} step {i} {k}: card "
                                         f"{float(got[k])} CPU {float(w)}")
                row["metric_rel"] = max(row["metric_rel"], rel)
            c, g = states["cpu"], states["card"]
            for mom in ("mu", "nu"):
                row["moment"] = max(row["moment"], leaf_check(
                    torch, f"(e) {arch} step {i} {mom}",
                    getattr(g.opt, mom), getattr(c.opt, mom), MOMENT_TOL))
            row["param"] = max(row["param"], leaf_check(
                torch, f"(e) {arch} step {i}",
                dict(g.params.named_parameters()),
                dict(c.params.named_parameters()), PARAM_TOL,
                slack=FAMILY_LR / 2, outliers=PARAM_OUTLIERS))
        row["captures"] = capture_count(steps["card"].program)
        if row["captures"] != 1:
            raise AssertionError(f"(e) {arch}: {row['captures']} captures")
        log(f"  (e) {cfg.arch_id}: {FAMILY_STEPS} steps card == CPU: metrics "
            f"within {row['metric_rel']:.2e} rel, moments "
            f"{row['moment']:.2e}, parameters {row['param']:.2e} of the "
            f"leaf's largest entry; 1 capture")
        rows.append(row)
    return rows


def training(torch, np, dev):
    """Phase 25: Yi-6B at full width with ``TRAIN_LAYERS`` layers, bf16,
    trained ``TRAIN_STEPS`` steps through the captured train step on the
    packed Markov source; (b) its first steps eager; (c) checkpointed and
    restored bit-equal; (d) the restored weights served on K3 (main
    path); (e) each family reduced, card against CPU.  Returns (rows, the
    phase's summary, K3's launches on (d))."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import capture_count
    from repro_torch.data import PackedLMDataset
    from repro_torch.models import get_model
    from repro_torch.training import cosine_schedule, init_train_state

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    bundle = get_model(cfg)
    t0 = time.perf_counter()
    ds = PackedLMDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [ds.next_batch() for _ in range(TRAIN_STEPS)]
    data_s = time.perf_counter() - t0
    lr = cosine_schedule(TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_STEPS,
                         TRAIN_FLOOR)
    lrs = [float(lr(torch.tensor(i + 1))) for i in range(TRAIN_STEPS)]
    row = {"model": f"{cfg.arch_id} {TRAIN_LAYERS} of 32 layers bf16 "
                    f"training", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "lr": [TRAIN_PEAK_LR, TRAIN_WARMUP,
                                        TRAIN_FLOOR],
           "max_grad_norm": TRAIN_MAX_GRAD_NORM, "data_s": data_s}

    # (b) first: the eager steps from the seed-0 weights, kept on the host
    torch.cuda.reset_peak_memory_stats()
    eager_losses, eager_params = eager_steps(torch, np, dev, bundle, lr,
                                             batches)

    # (a) the captured run
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(model)
    step = train_step_fn(bundle, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, mem, gnorms = [], [], [], []

    def run(i):
        t = time.perf_counter()
        _, m = step(state, batches[i])
        losses.append(float(m["loss"]))          # waits for the step
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        mem.append(torch.cuda.memory_allocated())

    for i in range(TRAIN_STEPS - TRAIN_TRACED):
        run(i)
        if i == EAGER_STEPS - 1:
            worst_b, equal_b = eager_vs_captured(torch, eager_params, model,
                                                 lrs)
    device = {}
    with main_path(torch, "the train step (phase 25 (a))",
                   device) as traced_train:
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS - TRAIN_TRACED, TRAIN_STEPS):
            run(i)
        traced_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TRACED
    if any(traced_train.values()):
        raise AssertionError(f"the train step launched kernels: "
                             f"{traced_train}")
    untraced = ms[1:TRAIN_STEPS - TRAIN_TRACED]
    median = statistics.median(untraced)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops_per_token(cfg, model) * tokens
    row.update({
        "parameters": n_params, "first_step_ms": ms[0],
        "median_step_ms": median, "tokens_per_s": tokens / median * 1e3,
        "mfu": flops / (median / 1e3) / H100_BF16_OPS_PER_S,
        "flops_per_step": flops,
        "device_ms_per_step": device["us"] / 1e3 / TRAIN_TRACED,
        "traced_step_ms": traced_ms,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "memory_after_step": mem, "losses": losses, "grad_norms": gnorms,
        "captures": capture_count(step.program),
        "capture_s": step.program.capture_s})
    row["busy_share"] = row["device_ms_per_step"] / traced_ms
    top = sorted(device["by_name"].items(), key=lambda kv: -kv[1])[:10]
    row["top_device"] = [{"name": n[:80], "ms_per_step":
                          us / 1e3 / TRAIN_TRACED} for n, us in top]
    log(f"  (a) {n_params:,} parameters, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens (data {data_s:.1f} s): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; first step (eager run + "
        f"capture) {ms[0]:.1f} ms, median replayed step {median:.2f} ms, "
        f"{row['tokens_per_s']:,.0f} tokens/s, MFU "
        f"{100 * row['mfu']:.1f}% ({flops / 1e12:.1f} TFLOP a step over "
        f"989 TFLOP/s); traced: device {row['device_ms_per_step']:.2f} ms a "
        f"step of {traced_ms:.2f} ({100 * row['busy_share']:.1f}% busy); "
        f"peak memory {row['peak_memory_bytes'] / 2**30:.2f} GiB, after "
        f"each step {sorted(set(mem))}; captures {row['captures']}")
    log("  losses: " + " ".join(f"{x:.3f}" for x in losses))
    log("  global gradient norms: " + " ".join(f"{x:.2f}" for x in gnorms))
    log("  device ms a step, top records: " + "; ".join(
        f"{t['name'][:60]} {t['ms_per_step']:.2f}" for t in row["top_device"]))
    if row["captures"] != 1:
        raise AssertionError(f"the train step captured {row['captures']} "
                             f"programs for one batch shape")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] <= losses[0] - TRAIN_LOSS_DROP:
        raise AssertionError(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                             f"fell by less than {TRAIN_LOSS_DROP}")
    flat = mem[1:TRAIN_STEPS - TRAIN_TRACED]
    if len(set(flat)) != 1:
        raise AssertionError(f"device memory after the steps is not flat: "
                             f"{mem}")
    # (b)
    for i, (e, c) in enumerate(zip(eager_losses, losses)):
        if not abs(e - c) <= EAGER_LOSS_RTOL * abs(e):
            raise AssertionError(f"(b) step {i}: eager loss {e}, captured "
                                 f"{c}")
    row["eager_losses"] = eager_losses
    row["eager_vs_captured"] = {"worst_over_bound": worst_b,
                                "bit_equal_share": equal_b}
    log(f"  (b) {EAGER_STEPS} eager steps: losses "
        + " ".join(f"{e:.5f}/{c:.5f}" for e, c in zip(eager_losses, losses))
        + f" (eager/captured); parameters after them within "
        f"{worst_b:.3f} of the bound (2 x summed lr + one bf16 ulp of "
        f"the leaf's largest entry), {100 * equal_b:.4f}% bit-equal")
    del eager_params

    # (c) the final state checkpointed and restored
    step.program.clear()
    del step
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = ROOT / "build" / "phase25_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    out = save_checkpoint(str(ckpt), TRAIN_STEPS, state)
    save_s = time.perf_counter() - t0
    files = list(Path(out).iterdir())
    nbytes = sum(f.stat().st_size for f in files)
    t0 = time.perf_counter()
    restored = restore_checkpoint(str(ckpt), TRAIN_STEPS, state, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    pairs = [(n, a, b) for (n, a), (_, b) in zip(
        model.named_parameters(), restored.params.named_parameters())]
    pairs += [(f"{mom} {n}", t, getattr(restored.opt, mom)[n])
              for mom in ("mu", "nu") for n, t in getattr(state.opt,
                                                          mom).items()]
    pairs.append(("step", state.opt.step, restored.opt.step))
    for n, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(bits(torch, a),
                                                 bits(torch, b)):
            raise AssertionError(f"(c) restored {n} is not bit-equal")
    row["checkpoint"] = {"bytes": nbytes, "files": len(files),
                         "save_s": save_s, "restore_s": restore_s,
                         "leaves": len(pairs)}
    log(f"  (c) checkpoint of the final TrainState: {nbytes:,} bytes in "
        f"{len(files)} files, saved in {save_s:.1f} s, restored onto the "
        f"card in {restore_s:.1f} s; {len(pairs)} leaves bit-equal")
    del state
    restored = restored.params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the restored weights served (main path), then the in-memory
    # trained weights and the untrained ones
    prompts = list(PackedLMDataset(cfg, 4, TRAIN_PROMPT,
                                   seed=1).next_batch()["tokens"])
    with main_path(torch, "serving the restored weights (phase 25 (d))"
                   ) as traced:
        served = serve_trained(torch, np, dev, bundle, restored, prompts)
    if not traced["decode_attention"]:
        raise AssertionError("(d) the restored weights were served without "
                             "K3")
    trained = serve_trained(torch, np, dev, bundle, model, prompts)
    if served != trained:
        raise AssertionError(f"(d) the restored weights served {served}, "
                             f"the trained ones {trained}")
    untrained = bundle.init(torch.Generator(dev).manual_seed(0))
    fresh = serve_trained(torch, np, dev, bundle, untrained, prompts)
    successors = ds.source.successors
    held_out = {k: torch.from_numpy(v).to(dev) for k, v in PackedLMDataset(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=2).next_batch().items()}
    with torch.no_grad():
        held = {w: float(bundle.loss(m, held_out, remat=False,
                                     data_shards=1)[0])
                for w, m in (("trained", restored), ("untrained",
                                                     untrained))}
    eos = cfg.vocab - 1
    counts = {w: (sum(len(o) for o in out.values()),
                  sum(o.count(eos) for o in out.values()))
              for w, out in (("trained", served), ("untrained", fresh))}
    row["served"] = {
        "prompts": len(prompts), "max_new_tokens": TRAIN_NEW,
        "tokens_and_eos": counts,
        "k3_launches": traced["decode_attention"],
        "successor_share_trained": successor_share(np, successors, prompts,
                                                   served),
        "successor_share_untrained": successor_share(np, successors,
                                                     prompts, fresh),
        "held_out_loss": held}
    log(f"  (d) restored weights served on K3 ({traced['decode_attention']} "
        f"launches traced = counted), tokens equal to the in-memory trained "
        f"weights'; greedy tokens (EOS among them, which ends a request): "
        f"trained {counts['trained'][0]} ({counts['trained'][1]}), "
        f"untrained {counts['untrained'][0]} ({counts['untrained'][1]}); "
        f"Markov successors among them: trained "
        f"{100 * row['served']['successor_share_trained']:.1f}%, untrained "
        f"{100 * row['served']['successor_share_untrained']:.1f}%; loss on "
        f"a held-out batch: restored {held['trained']:.4f}, untrained "
        f"{held['untrained']:.4f}")
    del restored
    del model, untrained
    gc.collect()
    torch.cuda.empty_cache()

    # (e)
    rows = [row] + family_train_card_vs_cpu(torch, np, dev)
    summary = {"phase": "phase 25 training",
               "seconds": time.perf_counter() - t_phase,
               "peak_memory_bytes": row["peak_memory_bytes"]}
    log(f"  phase 25 training: {summary['seconds']:.1f} s, peak device "
        f"memory {summary['peak_memory_bytes'] / 2**30:.2f} GiB")
    return rows, summary, traced["decode_attention"]


# ---------------------------------------------------------------------------
# phase 26: mesh-sharded serving
# ---------------------------------------------------------------------------

# (b)'s ranks, the models they serve and how: (arch, layers kept (None:
# all), the init seed, the runs as (label, engine keywords, the kernel
# the run must launch), the workload).  float32, so the ranks' tokens can
# be held equal to the single device's
MESH_WORLD, MESH_NEW, MESH_REQUESTS = 2, 8, 4
MESH_MODELS = [
    (LM_ARCH, None, 0, [("contiguous", {}, "decode_attention"),
                        ("paged", {"kv_block": PAGED_BLOCK},
                         "paged_decode_attention")], "lm"),
    (SSM_ARCH, 24, 0, [("one-shot", {}, "ssd_scan"),
                       (f"prefill_chunk={CHUNK}", {"prefill_chunk": CHUNK},
                        "ssd_scan")], "ssm"),
    (VLM_ARCH, 9, 2, [("bucketed", {}, None)], "vlm"),
    (MOE_ARCH, 4, 0, [("contiguous", {"prefill_buckets": False},
                       "decode_attention")], "moe"),
]
# a rank of (b): the whole of its run, and a collective's wait
MESH_RANKS_S, MESH_COLLECTIVE_S = 600, 300


def mesh_bundle(arch, layers):
    """The float32 bundle of ``arch`` at full width (``layers`` of its
    layers when given)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return get_model(cfg)


def mesh_workload(np, vocab, kind, label):
    """The requests of one (b) run: Yi-6B's and DeepSeek's from phase 7's
    and 15's, Mamba2-780m's inside one-shot prefill's contract (or longer
    for the chunked run), PaliGemma's vision prefix plus prompt within 512
    positions."""
    if kind in ("lm", "moe"):
        return serving_workload(np, vocab)[:MESH_REQUESTS]
    if kind == "ssm":
        return (recurrent_workload(np, vocab, 13, MESH_REQUESTS, 100, 600,
                                   False) if "chunk" in label else
                recurrent_workload(np, vocab, 12, MESH_REQUESTS, 0, 0, True))
    return family_workload(np, vocab, 33, 16, 257)[:MESH_REQUESTS]


def mesh_serve(torch, np, eng, prompts, evict=False):
    """The requests through ``eng`` (a forced evict and restore after the
    third step with ``evict``); returns (tokens, the median ms of the
    decode steps without a prefill, whether a request was evicted)."""
    from repro_torch.serving import Request

    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=MESH_NEW,
                           extras=family_extras(np, eng.cfg, uid)))
    step_ms, steps, evicted = [], 0, False
    while True:
        t0 = time.perf_counter()
        more = eng.step()
        torch.cuda.synchronize()
        if eng.last_step["decoded"] and not eng.last_step["prefill_tokens"]:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        steps += 1
        if evict and not evicted and steps == 3:
            eng.drain()
            victim = next(s for s in range(eng.max_slots)
                          if eng.active[s] or s in eng._chunking)
            eng._evict(victim)
            evicted = True
        if not more:
            break
    return ({u: eng.results[u].output for u in range(len(prompts))},
            statistics.median(step_ms), evicted)


def mesh_collectives(torch, np, eng, n_steps: int = 4):
    """Device and host ms a decode step spends in collectives, from a
    torch.profiler trace of ``n_steps`` decode steps of fresh requests:
    the device records of NCCL kernels, the host records of the gloo and
    NCCL ops (each key named in the result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    rng = np.random.default_rng(8)
    for uid in range(SERVE_SLOTS):
        eng.submit(Request(uid=1000 + uid, tokens=rng.integers(
            0, eng.cfg.vocab - 2, 64).astype(np.int32),
            max_new_tokens=n_steps + 3,
            extras=family_extras(np, eng.cfg, 1000 + uid)))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    device, host, keys = 0.0, 0.0, set()
    for e in prof.key_averages():
        key = e.key.lower()
        if e.device_type == DeviceType.CUDA and "nccl" in key:
            device += e.self_device_time_total
            keys.add(e.key[:60])
        elif e.device_type == DeviceType.CPU and (
                key.startswith("gloo:") or key.startswith("nccl:")):
            host += e.cpu_time_total
            keys.add(e.key[:60])
    return {"device_ms_per_step": device / n_steps / 1e3,
            "host_ms_per_step": host / n_steps / 1e3,
            "keys": sorted(keys)}


def mesh_rank_main(argv) -> int:
    """One rank of phase 26 (b), started by ``mesh_two_ranks`` as
    ``chip_smoke.py --mesh-rank R --mesh-world N --mesh-port P
    --mesh-backend nccl|gloo --mesh-out DIR`` (or of phase 27 with
    ``--mesh-task parity|perf|full``, ``train_mesh_rank``): joins the
    world, builds
    this rank's shards of each model (one rank at a time on a shared
    card: each builds the whole model, shards it and frees it), serves
    each run with a forced evict and restore, and writes its tokens,
    step medians, collective time, launches, peak memory and resident
    bytes to ``DIR/rank<R>.json``."""
    import datetime

    opts = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(opts["--mesh-rank"]), int(opts["--mesh-world"])
    backend = opts["--mesh-backend"]
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    task = opts.get("--mesh-task", "serve")
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{opts['--mesh-port']}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_S
                                   if task == "serve"
                                   else TRAIN_MESH_COLLECTIVE_S))
    if task != "serve":
        from repro_torch.core.executor import setup_device

        setup_device(dev)
        train_mesh_rank(torch, np, dev, rank, task, opts["--mesh-out"])
        dist.destroy_process_group()
        return 0
    from repro_torch.core import disable_capture
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import ServingEngine

    mesh = make_serving_mesh(world)
    # gloo stages CUDA tensors through the host, which a CUDA graph
    # cannot record: on a shared card the ranks run eagerly
    ctx = disable_capture() if backend == "gloo" else contextlib.nullcontext()
    results = {}
    with ctx:
        for arch, layers, seed, runs, kind in MESH_MODELS:
            bundle = mesh_bundle(arch, layers)
            local = None
            for turn in range(world):
                if turn == rank:
                    full = bundle.init(torch.Generator(dev).manual_seed(seed))
                    local = shard_params(full, mesh)
                    del full
                    gc.collect()
                    torch.cuda.empty_cache()
                dist.barrier()
            for label, kw, _ in runs:
                torch.cuda.reset_peak_memory_stats(dev)
                eng = ServingEngine(bundle, local, max_slots=SERVE_SLOTS,
                                    cache_len=SERVE_CACHE,
                                    tags=("cuda", "reference"), device=dev,
                                    mesh=mesh, **kw)
                prompts = mesh_workload(np, bundle.cfg.vocab, kind, label)
                before = dict(_build.launches)
                toks, median, evicted = mesh_serve(torch, np, eng, prompts,
                                                   evict=True)
                launches = {k: n - before[k] for k, n in
                            _build.launches.items() if n != before[k]}
                res = {"tokens": {str(u): t for u, t in toks.items()},
                       "median_decode_step_ms": median, "evicted": evicted,
                       "launches": launches, "seq_kv": eng._seq_kv,
                       "param_bytes": eng.param_bytes,
                       "kv_bytes": eng.kv_bytes,
                       "collectives": mesh_collectives(torch, np, eng),
                       "peak_memory_bytes":
                           torch.cuda.max_memory_allocated(dev)}
                if "state" in (eng.cache or {}):
                    res["ssd_heads"] = eng.cache["state"].shape[3]
                results[f"{arch} {label}"] = res
                del eng
                torch.cuda.empty_cache()
            del local
            gc.collect()
            torch.cuda.empty_cache()
    out = Path(opts["--mesh-out"]) / f"rank{rank}.json"
    out.write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


def mesh_one_rank(torch, np, dev, served, want_prefill):
    """Phase 26 (a): Yi-6B at full width and depth in bfloat16 on
    ``make_serving_mesh(1)`` — a world of one rank over NCCL in this
    process, its collectives issued (on one rank) and captured in the
    programs — as a main path: phase 7's requests give phase 7's tokens,
    K3 launched 32 x the decode steps (traced = counted), the programs as
    on one device.  Returns (row, K3's launches)."""
    import torch.distributed

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import get_model
    from repro_torch.serving import ServingEngine

    mesh = make_serving_mesh(1)
    bundle = get_model(get_config(LM_ARCH))
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    prompts = serving_workload(np, bundle.cfg.vocab)
    eng = ServingEngine(bundle, model, max_slots=SERVE_SLOTS,
                        cache_len=SERVE_CACHE, tags=("cuda", "reference"),
                        device=dev, mesh=mesh)
    dt = {}
    with main_path(torch, "phase 26 (a) one rank over NCCL",
                   device_time=dt) as traced:
        first, toks = serve_lm(torch, np, dev, eng, prompts)
    row, again = serve_lm(torch, np, dev, eng, prompts)
    layers = bundle.cfg.n_layers
    want = dict.fromkeys(traced, 0)
    want["decode_attention"] = layers * first["decode_steps"]
    if traced != want:
        raise AssertionError(f"(a) launches {traced}, expected {want}")
    if toks != served or again != served:
        raise AssertionError("(a) tokens differ from phase 7's")
    if row["programs"]["prefill"] != want_prefill or row["captures"] != \
            first["captures"]:
        raise AssertionError(f"(a) programs {row['programs']}, phase 7's "
                             f"prefill programs {want_prefill}")
    nccl_us = sum(us for name, us in dt["by_name"].items()
                  if "nccl" in name.lower())
    row.update(model=f"{LM_ARCH} bfloat16 serving, make_serving_mesh(1) "
                     f"over NCCL", launches=traced,
               mesh=repr(mesh), traced_device_us=dt["us"],
               traced_nccl_us=nccl_us)
    log(f"  (a) {mesh!r}: phase 7's tokens, request for request; programs "
        f"{row['programs']} as on one device; decode step median "
        f"{row['median_decode_step_ms']:.3f} ms replayed (phase 7's run "
        f"without a mesh, above); NCCL kernels "
        f"{nccl_us / 1e3:.2f} ms of the traced run's {dt['us'] / 1e3:.1f} "
        f"ms device time")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return row, traced["decode_attention"]


def mesh_two_ranks(torch, np, dev):
    """Phase 26 (b): each of ``MESH_MODELS`` at full width and its
    depth there, float32, on a world of ``MESH_WORLD`` ranks, one process
    a rank (``mesh_rank_main``): NCCL, a card a rank, where the machine
    shows that many cards; else gloo with every rank on the one card,
    eager.  Each run's tokens, through a forced evict and restore, equal
    the same model's single-device engine's here, each rank launched its
    run's kernel, and each rank's resident weight and KV bytes are logged
    against the single device's.  Returns (rows, launches by run)."""
    from repro_torch.serving import ServingEngine

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_WORLD else "gloo"
    log(f"  (b) {MESH_WORLD} ranks over {backend}; "
        f"torch.cuda.device_count() = {cards}")
    refs = {}
    for arch, layers, seed, runs, kind in MESH_MODELS:
        bundle = mesh_bundle(arch, layers)
        model = bundle.init(torch.Generator(dev).manual_seed(seed))
        for label, kw, _ in runs:
            eng = ServingEngine(bundle, model, max_slots=SERVE_SLOTS,
                                cache_len=SERVE_CACHE,
                                tags=("cuda", "reference"), device=dev, **kw)
            prompts = mesh_workload(np, bundle.cfg.vocab, kind, label)
            toks, median, _ = mesh_serve(torch, np, eng, prompts)
            refs[f"{arch} {label}"] = {
                "tokens": {str(u): t for u, t in toks.items()},
                "median_decode_step_ms": median,
                "param_bytes": eng.param_bytes, "kv_bytes": eng.kv_bytes}
            del eng
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out = ROOT / "build" / "mesh26"
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("rank*.json"):
        old.unlink()
    t0 = time.perf_counter()
    mesh_wait(mesh_launch(0, MESH_WORLD, free_port(), backend, out, "serve"),
              t0, MESH_RANKS_S)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(MESH_WORLD)]
    log(f"  (b) ranks done in {time.perf_counter() - t0:.1f} s")
    rows, launches = [], {}
    for arch, layers, seed, runs, kind in MESH_MODELS:
        for label, kw, kernel in runs:
            key = f"{arch} {label}"
            ref = refs[key]
            for r, res in enumerate(ranks):
                got = res[key]
                if got["tokens"] != ref["tokens"] or not got["evicted"]:
                    raise AssertionError(f"(b) {key} rank {r}: tokens "
                                         f"{got['tokens']} != the single "
                                         f"device's {ref['tokens']}")
                if kernel and not got["launches"].get(kernel):
                    raise AssertionError(f"(b) {key} rank {r} launched "
                                         f"{got['launches']}, no {kernel}")
                if kernel:
                    launches.setdefault(kernel, {})[
                        f"phase 26 (b) {key} rank {r}"] = \
                        got["launches"][kernel]
            row = {"model": f"{key}, float32, {MESH_WORLD} ranks over "
                            f"{backend}", "backend": backend, "cards": cards,
                   "single_device": ref, "ranks": ranks_rows(ranks, key)}
            rows.append(row)
            w = [x["param_bytes"] / ref["param_bytes"] for x in row["ranks"]]
            kv = [x["kv_bytes"] / ref["kv_bytes"] for x in row["ranks"]]
            col = row["ranks"][0]["collectives"]
            log(f"  (b) {key}: the single device's tokens on every rank "
                f"through an evict and restore; decode step median "
                + ", ".join(f"{x['median_decode_step_ms']:.2f}"
                            for x in row["ranks"])
                + f" ms a rank ({ref['median_decode_step_ms']:.2f} ms on one "
                f"device); collectives {col['device_ms_per_step']:.2f} ms "
                f"device, {col['host_ms_per_step']:.2f} ms host a step "
                f"(rank 0: {', '.join(col['keys'][:3]) or 'none traced'}); "
                f"resident weights {', '.join(f'{v:.3f}' for v in w)} and KV "
                f"{', '.join(f'{v:.3f}' for v in kv)} of the single device's "
                f"a rank; peak "
                + ", ".join(f"{x['peak_memory_bytes'] / 2**30:.2f}"
                            for x in row["ranks"]) + " GiB a rank"
                + (f"; SSD heads a rank {row['ranks'][0]['ssd_heads']}"
                   if "ssd_heads" in row["ranks"][0] else "")
                + f"; KV rows split: {row['ranks'][0]['seq_kv']}")
    return rows, launches


def ranks_rows(ranks, key):
    """Each rank's numbers of run ``key``, tokens left out."""
    return [{k: v for k, v in res[key].items() if k != "tokens"}
            for res in ranks]


def mesh_serving(torch, np, dev, served, want_prefill):
    """Phase 26: (a) then (b), with the earlier phases' models freed.
    Returns (rows, the phase's summary, launches by kernel and run)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row_a, k3 = mesh_one_rank(torch, np, dev, served, want_prefill)
    rows_b, launches = mesh_two_ranks(torch, np, dev)
    launches.setdefault("decode_attention", {})[
        "phase 26 (a) one rank over NCCL"] = k3
    info = {"phase": "phase 26 mesh-sharded serving",
            "seconds": time.perf_counter() - t0,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    log(f"  phase 26: {info['seconds']:.1f} s, peak device memory of this "
        f"process {info['peak_memory_bytes'] / 2**30:.2f} GiB")
    return [row_a, *rows_b], info, launches


# ---------------------------------------------------------------------------
# phase 27: mesh-sharded training
# ---------------------------------------------------------------------------

# (a) parity, float32, two ranks: (arch, config fields replaced, meshes,
# tokens a row).  Yi-6B at full width with 2 layers; DeepSeek-MoE-16B at
# full width with its dense first block and one MoE layer, its capacity
# factor dropless on the expert-parallel path (a rank's capacity
# int(t·6·11/64) >= t); Whisper at full width with 2 + 2 layers, 1,500
# frames and 448 tokens (its decoder's context) a row; and the K/V split:
# Whisper with 5 heads of 256 (its width), which do not divide over
# model=2, so the decoder's self-attention splits K/V by sequence
TRAIN_MESH_WORLD = 2
TRAIN_MESH_SHAPES = [(2, 1), (1, 2)]
AUDIO_TRAIN_LAYERS = {"n_layers": 2, "n_encoder_layers": 2}
AUDIO_SPLIT_HEADS = {"n_heads": 5, "n_kv_heads": 5, "head_dim": 256}
TRAIN_MESH_PARITY = [
    (LM_ARCH, {"n_layers": 2}, TRAIN_MESH_SHAPES, 512),
    (MOE_ARCH, {"n_layers": 2, "capacity_factor": 11.0}, TRAIN_MESH_SHAPES,
     512),
    (AUDIO_ARCH, AUDIO_TRAIN_LAYERS, TRAIN_MESH_SHAPES, 448),
    (AUDIO_ARCH, dict(AUDIO_TRAIN_LAYERS, **AUDIO_SPLIT_HEADS), [(1, 2)],
     448)]
TRAIN_MESH_BATCH, TRAIN_MESH_STEPS = 2, 3
# a small constant lr: the ranks run free from the same seeded weights,
# and Adam's first steps move an element whose gradient is within
# rounding of 0 by up to 2 lr, which must not move the next gradients
TRAIN_MESH_LR = 1e-5
TRAIN_MESH_LOSS_RTOL, TRAIN_MESH_GRAD_TOL = 1e-5, 1e-4
# (b) on two cards: phase 25's configuration, and Whisper at full width
# with 8 + 8 of its 32 + 32 layers, bf16, 4 x (1,500 frames, 448 tokens);
# (c) on four: Yi-6B at full depth, FSDP over four, and Whisper at full
# depth on (2, 2): (arch, config fields replaced, rows, tokens a row,
# meshes)
TRAIN_MESH_PERF = [
    (LM_ARCH, {"n_layers": TRAIN_LAYERS}, TRAIN_BATCH, TRAIN_SEQ,
     TRAIN_MESH_SHAPES),
    (AUDIO_ARCH, {"n_layers": 8, "n_encoder_layers": 8}, 4, 448,
     TRAIN_MESH_SHAPES)]
TRAIN_MESH_FULL = [(LM_ARCH, {}, TRAIN_BATCH, TRAIN_SEQ, [(4, 1)]),
                   (AUDIO_ARCH, {}, 4, 448, [(2, 2)])]
TRAIN_MESH_PERF_STEPS, TRAIN_MESH_FULL_STEPS = 10, 5
TRAIN_MESH_TRACED = 2
# a rank's whole run, and a collective's wait
TRAIN_MESH_RANKS_S, TRAIN_MESH_COLLECTIVE_S = 900, 300


def mesh_launch(first, world, port, backend, out, task):
    """Ranks ``first`` .. ``world - 1`` of a world of ``world`` running
    ``task`` (phase 26's ``serve`` or one of phase 27's), one
    ``chip_smoke.py --mesh-rank R ...`` process each."""
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
         "--mesh-world", str(world), "--mesh-port", str(port),
         "--mesh-backend", backend, "--mesh-out", str(out),
         "--mesh-task", task]) for r in range(first, world)]


def mesh_wait(procs, t0, limit):
    """Wait for ``procs`` (killed past ``limit`` seconds from ``t0``);
    raises unless every one exited 0."""
    try:
        for p in procs:
            p.wait(timeout=max(1.0, limit - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"ranks exited {[p.returncode for p in procs]}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_parity_rank(torch, np, dev, rank):
    """Phase 27 (a) on this rank of a world of ``TRAIN_MESH_WORLD``: each
    of ``TRAIN_MESH_PARITY`` on each of its meshes (``parity_model``),
    the merges of K/V-split partial attentions (``collectives.combine``)
    counted.  Returns rank 0's rows (None elsewhere)."""
    from repro_torch.distributed import collectives

    rows, merges = [], [0]
    combine = collectives.combine

    def counted_combine(*args):
        merges[0] += 1
        return combine(*args)

    collectives.combine = counted_combine
    try:
        for arch, fields, shapes, seq in TRAIN_MESH_PARITY:
            rows += parity_model(torch, dev, rank, arch, fields, shapes, seq,
                                 merges)
    finally:
        collectives.combine = combine
    return rows if rank == 0 else None


def parity_model(torch, dev, rank, arch, fields, shapes, seq, merges):
    """(a) for one model: from the seed-0 weights, ``TRAIN_MESH_STEPS``
    sharded steps on each of ``shapes``, each held against the same
    model's single-device loss and gradients, which every rank (rank 0
    is the launching process) runs on its own card on the whole batch,
    clipped as the step clips them.  Before each step the sharded
    parameters are set to this rank's slices of the single-device ones
    (which follow plain SGD steps of the clipped gradient), so every
    step starts from the same parameters: routing flips on a
    rounding-level drift would move an MoE's gradients.  Each rank holds
    its loss, and its slice of the gradient the sharded step applied,
    read back from its first moment (mu_t = b1 mu_t-1 + (1 - b1) g_t),
    against the single device's.  The step's context must split K/V by
    sequence exactly where the heads do not divide over ``model``, and
    then merge (``merges[0]``, the calls counted); elsewhere nothing
    merges.  On Yi-6B's first mesh the world's checkpoint, written whole
    by rank 0, is restored on every rank's card and its slices held
    bit-equal to the rank's state.  Returns rank 0's rows."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import capture_count
    from repro_torch.data import make_batches
    from repro_torch.distributed.sharding import (shard_batch, shard_local,
                                                  shard_params)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.training import (clip_by_global_norm, init_train_state,
                                      make_train_step)
    from repro_torch.training.trainer import loss_and_grads, step_context

    b1 = 0.9                              # adamw_update's default
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **fields)
    bundle = get_model(cfg)
    batches = make_batches(cfg, TRAIN_MESH_BATCH, seq, TRAIN_MESH_STEPS,
                           seed=0)
    layers = (f"{cfg.n_encoder_layers} + {cfg.n_layers} layers"
              if cfg.family == "audio" else f"{cfg.n_layers} layers")
    if "n_heads" in fields:
        layers += f", {cfg.n_heads} heads of {cfg.dh}"
    rows = []
    for shape in shapes:
        mesh = make_mesh(shape)
        kw = dict(remat=True, data_shards=shape[0])
        ref = bundle.init(torch.Generator(dev).manual_seed(0))
        state = init_train_state(shard_params(ref, mesh, fsdp=True))
        step = make_train_step(bundle.loss, lr=TRAIN_MESH_LR, mesh=mesh,
                               **kw)
        specs = state.params.specs
        with step_context(cfg, mesh, shard_batch(batches[0], mesh)) as ctx:
            kv_seq = ctx.kv_seq
        if kv_seq != (cfg.n_heads % shape[1] != 0):
            raise AssertionError(f"(a) {arch} {layers} on {shape}: K/V "
                                 f"split by sequence {kv_seq}")
        row = {"model": f"{arch} {layers} float32 training, mesh {shape}",
               "backend": mesh.backend, "tokens_a_row": seq,
               "kv_seq_split": kv_seq, "losses": [], "loss_rel": [],
               "grad": [], "grad_norm_rel": [], "step_ms": [],
               "ref_grad_ms": []}
        before = dict(_build.launches)
        merges[0] = 0
        for batch in batches:
            whole = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            l0, _, g0 = loss_and_grads(bundle.loss, ref, whole, **kw)
            g0, n0 = clip_by_global_norm(g0, 1.0)
            torch.cuda.synchronize()
            row["ref_grad_ms"].append((time.perf_counter() - t) * 1e3)
            with torch.no_grad():
                for n, p in state.params.named_parameters():
                    p.copy_(shard_local(ref.get_parameter(n), specs[n],
                                        mesh))
            mu_prev = {n: t.clone() for n, t in state.opt.mu.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            row["step_ms"].append((time.perf_counter() - t) * 1e3)
            worst = 0.0
            for n, mu in state.opt.mu.items():
                applied = (mu - b1 * mu_prev[n]) / (1 - b1)
                want = shard_local(g0[n], specs[n], mesh)
                top = float(g0[n].abs().max()) or 1.0
                worst = max(worst, float((applied - want).abs().max())
                            / top)
            del mu_prev
            mine = torch.tensor(
                [float(m["loss"]), abs(float(m["loss"]) - float(l0))
                 / abs(float(l0)), abs(float(m["grad_norm"]) - float(n0))
                 / float(n0), worst], device=dev)
            every = [torch.zeros(4, device=dev) for _ in range(mesh.size)]
            dist.all_gather(every, mine)
            every = [[float(x) for x in e] for e in every]
            row["losses"].append([e[0] for e in every])
            row["loss_rel"].append(max(e[1] for e in every))
            row["grad_norm_rel"].append(max(e[2] for e in every))
            row["grad"].append(max(e[3] for e in every))
            with torch.no_grad():
                for n, p in ref.named_parameters():
                    p.sub_(TRAIN_MESH_LR * g0[n])
            del g0
        if dict(_build.launches) != before:
            raise AssertionError(f"(a) the sharded step launched "
                                 f"kernels: {_build.launches}")
        # the merges of the step's runs (a captured step merges only
        # while it is captured; over gloo every step runs eagerly)
        row["merges"] = merges[0]
        if (merges[0] > 0) != kv_seq:
            raise AssertionError(f"(a) {row['model']}: {merges[0]} merges "
                                 f"with K/V split by sequence {kv_seq}")
        row["captures"] = capture_count(step.program)
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        bad = [(i, x) for i, x in enumerate(row["loss_rel"])
               if not x <= TRAIN_MESH_LOSS_RTOL]
        bad += [(i, x) for i, x in enumerate(row["grad"])
                if not x <= TRAIN_MESH_GRAD_TOL]
        if bad:
            raise AssertionError(f"(a) {row['model']}: steps off one "
                                 f"device's: {bad}")
        if (arch, shape) == (LM_ARCH, TRAIN_MESH_SHAPES[0]):
            row["checkpoint"] = world_checkpoint(
                torch, dev, rank, state, save_checkpoint, restore_checkpoint)
        if rank == 0:
            rows.append(row)
            log(f"  (a) {row['model']} over {mesh.backend}: rank losses "
                + "; ".join("/".join(f"{x:.6f}" for x in ls)
                            for ls in row["losses"])
                + f" (worst {max(row['loss_rel']):.2e} rel of one "
                f"device's); each step's applied gradient within "
                + ", ".join(f"{x:.2e}" for x in row["grad"])
                + " of each leaf's largest entry, its norm within "
                + ", ".join(f"{x:.1e}" for x in row["grad_norm_rel"])
                + " rel; sharded step ms "
                + ", ".join(f"{x:.1f}" for x in row["step_ms"])
                + " (one device's loss and gradients "
                + ", ".join(f"{x:.1f}" for x in row["ref_grad_ms"])
                + f"); captures {row['captures']}"
                + (f"; K/V split by sequence, {row['merges']} merges"
                   if kv_seq else "")
                + (f"; the world's checkpoint ({row['checkpoint']}) "
                   f"restored on one card bit-equal"
                   if row.get("checkpoint") else ""))
        del state, ref, step
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def world_checkpoint(torch, dev, rank, state, save_checkpoint,
                     restore_checkpoint):
    """(a)'s checkpoint: the world's state saved under ``build/`` (rank 0
    writes it whole), restored on every rank's card (one device's whole
    state) and each leaf's slice held bit-equal to the rank's; returns
    the leaves, bytes and seconds."""
    import shutil

    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_local

    ckpt = ROOT / "build" / "phase27_ckpt"
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    dist.barrier()
    t = time.perf_counter()
    out = save_checkpoint(str(ckpt), TRAIN_MESH_STEPS, state)
    save_s = time.perf_counter() - t
    like = whole_like(state)
    t = time.perf_counter()
    back = restore_checkpoint(str(ckpt), TRAIN_MESH_STEPS, like, device=dev)
    restore_s = time.perf_counter() - t
    mesh, specs = state.params.mesh, state.params.specs
    pairs = [(n, p, shard_local(back.params.get_parameter(n), specs[n], mesh))
             for n, p in state.params.named_parameters()]
    pairs += [(f"{mom} {n}", t_, shard_local(getattr(back.opt, mom)[n],
                                             specs[n], mesh))
              for mom in ("mu", "nu")
              for n, t_ in getattr(state.opt, mom).items()]
    pairs.append(("step", state.opt.step, back.opt.step))
    for n, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(bits(torch, a),
                                                 bits(torch, b)):
            raise AssertionError(f"(a) rank {rank}: restored {n} is not "
                                 f"bit-equal")
    nbytes = sum(f.stat().st_size for f in Path(out).iterdir())
    del back
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"leaves": len(pairs), "bytes": nbytes, "save_s": save_s,
            "restore_s": restore_s}


def whole_like(state):
    """A TrainState of ``state``'s whole shapes on the meta device, for
    ``restore_checkpoint``'s ``like`` on one device."""
    from repro_torch.models.registry import empty_model
    from repro_torch.training import TrainState
    from repro_torch.training.optimizer import AdamWState

    model = empty_model(state.params.cfg, "meta")
    mom = {n: p.detach().float() for n, p in model.named_parameters()}
    return TrainState(model, AdamWState(step=state.opt.step, mu=mom,
                                        nu=mom))


def layers_label(cfg, arch) -> str:
    """``cfg``'s depth against ``arch``'s published one, e.g. "8 of 32
    layers" or Whisper's "8 + 8 of 32 + 32 layers"."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    if cfg.family == "audio":
        return (f"{cfg.n_encoder_layers} + {cfg.n_layers} of "
                f"{full.n_encoder_layers} + {full.n_layers} layers")
    return f"{cfg.n_layers} of {full.n_layers} layers"


def train_perf_rank(torch, np, dev, rank, arch, fields, rows_a_step, seq,
                    shapes, steps):
    """Phase 27 (b)/(c) on this rank: ``arch`` at full width with
    ``fields`` replaced, bfloat16, ``rows_a_step`` x ``seq`` tokens a step
    (Whisper's rows with their 1,500 frames) on each mesh of ``shapes``
    (None: one card, no mesh), ``steps`` captured steps over NCCL with
    phase 25's schedule and clip, the last ``TRAIN_MESH_TRACED`` traced
    by torch.profiler; returns this rank's rows: losses, step ms, peak
    memory, NCCL device ms a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import capture_count
    from repro_torch.data import PackedLMDataset
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.training import (cosine_schedule, init_train_state,
                                      make_train_step)

    cfg = dataclasses.replace(get_config(arch), **fields)
    bundle = get_model(cfg)
    ds = PackedLMDataset(cfg, rows_a_step, seq, seed=0)
    batches = [ds.next_batch() for _ in range(steps)]
    rows = []
    for shape in shapes:
        mesh = make_mesh(shape) if shape else None
        torch.cuda.reset_peak_memory_stats(dev)
        full = bundle.init(torch.Generator(dev).manual_seed(0))
        n_params = sum(p.numel() for p in full.parameters())
        state = init_train_state(shard_params(full, mesh, fsdp=True)
                                 if mesh else full)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # phase 25's schedule, so (b)'s Yi-6B steps are phase 25's first ten
        lr = cosine_schedule(TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_STEPS,
                             TRAIN_FLOOR)
        step = make_train_step(bundle.loss, lr=lr,
                               max_grad_norm=TRAIN_MAX_GRAD_NORM, remat=True,
                               data_shards=shape[0] if shape else 1,
                               mesh=mesh)
        losses, ms = [], []
        before = dict(_build.launches)

        def run(batch):
            t = time.perf_counter()
            _, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)

        for batch in batches[:-TRAIN_MESH_TRACED]:
            run(batch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for batch in batches[-TRAIN_MESH_TRACED:]:
                run(batch)
        nccl_records = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and "nccl" in e.key.lower()]
        nccl = sum(e.self_device_time_total for e in nccl_records)
        device = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        if dict(_build.launches) != before:
            raise AssertionError("the sharded step launched kernels")
        median = statistics.median(ms[1:-TRAIN_MESH_TRACED])
        tokens = rows_a_step * seq
        where = (f"mesh {shape} over {mesh.backend}" if mesh
                 else "one card")
        rows.append({
            "model": f"{cfg.arch_id} {layers_label(cfg, arch)} bf16 training, "
                     f"{where}",
            "rank": rank, "parameters": n_params, "losses": losses,
            "step_ms": ms, "median_step_ms": median,
            "tokens_per_s": tokens / median * 1e3,
            "nccl_device_ms_per_step": nccl / 1e3 / TRAIN_MESH_TRACED,
            "nccl_kernels_per_step": sum(e.count for e in nccl_records)
            / TRAIN_MESH_TRACED,
            "device_ms_per_step": device / 1e3 / TRAIN_MESH_TRACED,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "captures": capture_count(step.program),
            "capture_s": step.program.capture_s})
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def train_mesh_rank(torch, np, dev, rank, task, out):
    """A ``--mesh-task`` rank of phase 27: ``parity`` ((a)'s rank 1),
    ``perf`` ((b), ``TRAIN_MESH_PERF``) or ``full`` ((c),
    ``TRAIN_MESH_FULL``); writes its rows to ``out/rank<R>.json``."""
    if task == "parity":
        rows = train_parity_rank(torch, np, dev, rank)
    else:
        runs, steps = ((TRAIN_MESH_PERF, TRAIN_MESH_PERF_STEPS)
                       if task == "perf"
                       else (TRAIN_MESH_FULL, TRAIN_MESH_FULL_STEPS))
        rows = [row for arch, fields, n, seq, shapes in runs
                for row in train_perf_rank(torch, np, dev, rank, arch,
                                           fields, n, seq, shapes, steps)]
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(rows))


def train_mesh_world(torch, np, n, backend, task):
    """(b)/(c): ``n`` ranks of ``task``, one process a card over
    ``backend``; returns every rank's rows."""
    out = ROOT / "build" / f"mesh27_{task}"
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("rank*.json"):
        old.unlink()
    t0 = time.perf_counter()
    mesh_wait(mesh_launch(0, n, free_port(), backend, out, task), t0,
              TRAIN_MESH_RANKS_S)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]


def mesh_training(torch, np, dev, phase25_losses=None):
    """Phase 27: (a) parity on a world of two ranks — this process is
    rank 0, a ``--mesh-rank 1`` process rank 1, each running the
    single-device loss and gradients beside its share: NCCL a card a
    rank where two cards show, else gloo with both on the one card,
    eager; (b) with two cards, phase 25's configuration and Whisper at 8
    + 8 layers captured over NCCL on (2, 1) and (1, 2), Yi-6B's losses
    logged beside ``phase25_losses``' first (same weights, data and
    schedule), Whisper's steps beside one card's; (c) with four, Yi-6B
    at full depth, FSDP over four, and Whisper at full depth on (2, 2).
    Returns (rows, the phase's summary)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.executor import setup_device

    t_phase = time.perf_counter()
    setup_device(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= TRAIN_MESH_WORLD else "gloo"
    log(f"  (a) {TRAIN_MESH_WORLD} ranks over {backend}; "
        f"torch.cuda.device_count() = {cards}")
    out = ROOT / "build" / "mesh27_parity"
    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = mesh_launch(1, TRAIN_MESH_WORLD, port, backend, out, "parity")
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=0,
            world_size=TRAIN_MESH_WORLD,
            timeout=datetime.timedelta(seconds=TRAIN_MESH_COLLECTIVE_S))
        try:
            rows = train_parity_rank(torch, np, dev, 0)
        finally:
            dist.destroy_process_group()
    finally:
        mesh_wait(procs, t0, TRAIN_MESH_RANKS_S)
    for row in rows:
        row["cards"] = cards
    if cards >= 2:
        # one card's steps of each (b) model but Yi-6B (phase 25's)
        one = {}
        for arch, fields, n, seq, _ in TRAIN_MESH_PERF:
            if arch != LM_ARCH:
                one[arch] = train_perf_rank(torch, np, dev, 0, arch, fields,
                                            n, seq, [None],
                                            TRAIN_MESH_PERF_STEPS)[0]
                rows.append(dict(one[arch], cards=cards))
                log(f"  (b) {one[arch]['model']}: median step "
                    f"{one[arch]['median_step_ms']:.2f} ms, peak "
                    f"{one[arch]['peak_memory_bytes'] / 1e9:.2f} GB")
        ranks = train_mesh_world(torch, np, 2, "nccl", "perf")
        runs = [(arch, shape) for arch, _, _, _, shapes in TRAIN_MESH_PERF
                for shape in shapes]
        for i, (arch, shape) in enumerate(runs):
            per = [r[i] for r in ranks]
            losses = per[0]["losses"]
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"(b) {arch} {shape}: losses {losses}")
            rows.append({"model": per[0]["model"], "cards": cards,
                         "ranks": per})
            ref = one.get(arch)
            log(f"  (b) {per[0]['model']}: median step "
                + ", ".join(f"{r['median_step_ms']:.2f}" for r in per)
                + (f" ms a rank (one card: {ref['median_step_ms']:.2f}), "
                   if ref else " ms a rank (phase 25, one card: 809.80), ")
                + ", ".join(f"{r['tokens_per_s']:,.0f}" for r in per)
                + " tokens/s; NCCL device "
                + ", ".join(f"{r['nccl_device_ms_per_step']:.2f}"
                            for r in per)
                + " ms a step ("
                + ", ".join(f"{r['nccl_kernels_per_step']:.0f}" for r in per)
                + " NCCL kernels, the recomputed layers' again); peak "
                + ", ".join(f"{r['peak_memory_bytes'] / 1e9:.2f}"
                            for r in per)
                + (f" GB a rank (one card: "
                   f"{ref['peak_memory_bytes'] / 1e9:.2f}); loss "
                   if ref else " GB a rank (phase 25: 31.6); loss ")
                + " ".join(f"{x:.3f}" for x in losses)
                + (" (phase 25's first steps: " + " ".join(
                    f"{x:.3f}" for x in phase25_losses[:len(losses)]) + ")"
                   if phase25_losses and arch == LM_ARCH else "")
                + f"; captures {per[0]['captures']}")
    if cards >= 4:
        ranks = train_mesh_world(torch, np, 4, "nccl", "full")
        for i in range(len(TRAIN_MESH_FULL)):
            per = [r[i] for r in ranks]
            losses = per[0]["losses"]
            if not (all(np.isfinite(losses))
                    and min(losses[1:]) < losses[0]):
                raise AssertionError(f"(c) {per[0]['model']}: losses "
                                     f"{losses}")
            rows.append({"model": per[0]["model"], "cards": cards,
                         "ranks": per})
            log(f"  (c) {per[0]['model']} ({per[0]['parameters']:,} "
                f"parameters): loss " + " ".join(f"{x:.3f}" for x in losses)
                + "; median step " + ", ".join(
                    f"{r['median_step_ms']:.1f}" for r in per)
                + " ms a rank; NCCL device " + ", ".join(
                    f"{r['nccl_device_ms_per_step']:.2f}" for r in per)
                + " ms a step; peak " + ", ".join(
                    f"{r['peak_memory_bytes'] / 1e9:.2f}" for r in per)
                + " GB a rank")
    info = {"phase": "phase 27 mesh-sharded training",
            "seconds": time.perf_counter() - t_phase, "backend": backend,
            "cards": cards,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    log(f"  phase 27: {info['seconds']:.1f} s, peak device memory of this "
        f"process {info['peak_memory_bytes'] / 2**30:.2f} GiB")
    return rows, info


def serving_layers(torch, np, dev, served):
    """Phases 19-24 on Yi-6B at full width in bfloat16, its weights drawn
    again from phase 7's seed (``served`` are phase 7's tokens).  Returns
    the rows, the phases' summaries and each new run's launches by
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    bundle = get_model(get_config(LM_ARCH))
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    prompts = serving_workload(np, bundle.cfg.vocab)
    engine = family_engine(dev, bundle, model)
    n_layers = bundle.cfg.n_layers
    rows, summaries, runs = [], [], {}

    def summary(label, t0, new_rows):
        info = {"phase": label, "seconds": time.perf_counter() - t0,
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        log(f"  {label}: {info['seconds']:.1f} s, peak device memory "
            f"{info['peak_memory_bytes'] / 2**30:.2f} GiB")
        summaries.append(info)
        rows.extend(new_rows)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    phase("phase 19: overlapped decode, contiguous (K3) and paged (K4) "
          "(main path)")
    ov_rows, ov_launches = overlapped_decode(torch, np, dev, engine, prompts,
                                             served, n_layers)
    for run, (kname, n) in ov_launches.items():
        runs.setdefault(kname, {})[run] = n
    summary("phase 19 overlapped decode", t0, ov_rows)
    t0 = time.perf_counter()
    phase("phase 20: MultiTenantHost, Yi-6B + fc_stack int8 + hotword on "
          "one arena (main path)")
    host_row, host_launches = multitenant_host(torch, np, dev, bundle, model,
                                               prompts, served, n_layers)
    for kname, n in host_launches.items():
        runs.setdefault(kname, {})["phase 20 host"] = n
    summary("phase 20 host", t0, [host_row])
    t0 = time.perf_counter()
    phase("phase 21: ReplicaRouter, two Yi-6B replicas (main path)")
    router_row, k3 = replica_router(torch, np, dev, engine, bundle, model,
                                    prompts, served, n_layers)
    runs.setdefault("decode_attention", {})["phase 21 router"] = k3
    summary("phase 21 router", t0, [router_row])
    t0 = time.perf_counter()
    phase("phase 22: StreamingServer (main path)")
    stream_row, k3 = streaming_server(torch, np, dev, engine, prompts,
                                      served, n_layers)
    runs["decode_attention"]["phase 22 streaming server"] = k3
    summary("phase 22 streaming server", t0, [stream_row])
    t0 = time.perf_counter()
    phase("phase 23: MicroProfiler and measure_compile_and_step (main path)")
    prof_row, prof_launches = profiles(torch, np, dev, engine)
    runs.setdefault("quant_matmul", {})["phase 23 profiler"] = \
        prof_launches["quant_matmul"]
    summary("phase 23 profiler", t0, [prof_row])
    del engine
    torch.cuda.empty_cache()
    phase("phase 24: the calibration cost model — calibrate, then serve "
          "from the profile (main path)")
    cal_rows, cal_info, cal_runs = cost_model(torch, np, dev, bundle, model,
                                              served)
    for kname, per_run in cal_runs.items():
        runs.setdefault(kname, {}).update(per_run)
    rows.extend(cal_rows)
    summaries.append(cal_info)
    log(f"  phase 24 cost model: {cal_info['seconds']:.1f} s (calibration "
        + ", ".join(f"{k} {v:.1f} s" for k, v in
                    cal_info["calibration_seconds"].items())
        + f"), peak device memory "
        f"{cal_info['peak_memory_bytes'] / 2**30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return rows, summaries, runs


def main() -> int:
    if "--mesh-rank" in sys.argv:
        return mesh_rank_main(sys.argv[1:])
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2

    # phase 1: the card, the toolchain, the build
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card_line)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(_build.KERNELS)})")
    for name, report in _build.BUILD_LOGS.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    from repro_torch.kernels import decode_attention as K3
    from repro_torch.kernels import dequant_matmul as K56
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import quant_matmul as K1
    dev = torch.device("cuda")
    # registers and shared memory a block at the path shapes
    from repro_torch.kernels import ssd_scan as K8
    attrs = {"quant_matmul": K1.kernel_attributes("rows"),
             "flash_attention": K2.kernel_attributes(torch.float32, 64),
             "decode_attention": K3.kernel_attributes(torch.bfloat16, 8,
                                                      128),
             "dequant_matmul": K56.kernel_attributes(False),
             "dequant_matmul_i4": K56.kernel_attributes(True),
             "ssd_scan": K8.kernel_attributes(torch.bfloat16, 2, 512, 48, 64,
                                              128, 128)}
    for name, (regs, smem) in attrs.items():
        log(f"  {name} at its path shape: {regs} registers a thread, "
            f"{smem} bytes of shared memory a block")
    k8_parts = {f"{part} {str(dt)[6:]} {s}": K8.kernel_attributes(
        dt, which, s, 48, 64, 128, 128)
        for which, part in enumerate(K8.KERNEL_NAMES)
        for dt in (torch.bfloat16, torch.float32) for s in (512, 128)}
    log("  quant_matmul paths: " + ", ".join(
        f"{p_} {K1.kernel_attributes(p_)}" for p_ in K1.PATHS)
        + " (registers, static bytes); ssd_scan at Mamba2-780m's shapes: "
        + ", ".join(f"{k} {v}" for k, v in k8_parts.items())
        + " (registers, bytes)")
    log(f"  flash_attention bfloat16 D 64: "
        f"{K2.kernel_attributes(torch.bfloat16, 64)}; decode_attention "
        f"float32 G 8 D 128: "
        f"{K3.kernel_attributes(torch.float32, 8, 128)} (registers, bytes)")

    phase("phase 2: kernels against their plain versions")
    k1_rows = check_quant_matmul(torch, np, dev)
    k2_rows = check_flash_attention(torch, np, dev)
    k3_rows = check_decode_attention(torch, np, dev)
    k4_rows = check_paged_decode_attention(torch, np, dev)
    k3_split, k4_split = check_sharded_decode_attention(torch, np, dev)
    k3_rows += k3_split
    k4_rows += k4_split
    k5_rows, k6_rows = check_dequant_matmul(torch, np, dev)
    k7_rows = check_paged_decode_attention_q(torch, np, dev)
    k8_rows = check_ssd_scan(torch, np, dev)

    phase("phase 3: the interpreter on the card (main path)")
    with main_path(torch, "the micro path (phases 3-4)") as traced:
        model_rows, cards, want_k1 = run_models(np, dev)
        phase("phase 4: ATTENTION through the interpreter (main path)")
        row, card = run_attention(np, dev)
        model_rows.append(row)
        cards.append(card)
    launches = {"quant_matmul": traced["quant_matmul"],
                "flash_attention": traced["flash_attention"]}
    if launches["quant_matmul"] != want_k1:
        raise AssertionError(f"quant_matmul launched "
                             f"{launches['quant_matmul']} times, the int8 "
                             f"FC ops served {want_k1}")
    if launches["flash_attention"] != N_REQUESTS:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times for "
                             f"{N_REQUESTS} ATTENTION invokes")
    phase("phase 5: replayed invokes against eager ones; where an invoke's "
        "time goes (torch.profiler)")
    eager_invokes(np, model_rows, cards)
    profile_invokes(torch, model_rows, cards)

    phase(f"phase 6: {LM_ARCH} full width, float32, K3 vs its plain version "
        f"(teacher-forced)")
    model_rows.append(teacher_forced(torch, np, dev))

    phase(f"phase 7: {LM_ARCH} full width, bfloat16, through the "
        f"ServingEngine (main path)")
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import ServingEngine
    bundle = get_model(get_config(LM_ARCH))
    lm_model = bundle.init(torch.Generator(dev).manual_seed(0))
    prompts = serving_workload(np, bundle.cfg.vocab)

    def engine(**kw):
        return ServingEngine(bundle, lm_model, max_slots=SERVE_SLOTS,
                             cache_len=SERVE_CACHE,
                             tags=("cuda", "reference"), device=dev, **kw)
    eng = engine()
    serve_row, served = serve_main(torch, np, dev, eng, prompts,
                                   "the serving path")
    n_layers = bundle.cfg.n_layers
    want = dict.fromkeys(serve_row["launches"], 0)
    want["decode_attention"] = n_layers * serve_row["decode_steps"]
    if serve_row["launches"] != want:
        raise AssertionError(f"launches {serve_row['launches']}, expected "
                             f"{want} ({serve_row['decode_steps']} decode "
                             f"steps of {n_layers} layers)")
    launches["decode_attention"] = want["decode_attention"]
    profile_decode(torch, np, eng, serve_row)
    # the bf16 drift of bucketed against exact-length prefill on a dense
    # model, beside phase 15's on the MoE ones
    serve_row["bucketed_vs_exact"] = bucketed_vs_exact(
        torch, np, engine(prefill_buckets=False), eng, prompts)
    del eng
    eager_twin(torch, np, dev, engine(), prompts, serve_row, served)
    check_preemption(engine(policy="edf", preempt="edf-displace",
                            clock=lambda: 0), prompts, served)
    model_rows.append(serve_row)

    phase("phase 8: reduced models, the engine on the card vs the CPU")
    model_rows.append(reduced_card_vs_cpu(torch, np, dev))
    model_rows.append(reduced_recurrent_card_vs_cpu(torch, np, dev))

    phase(f"phase 9: {LM_ARCH} full width, bfloat16, paged KV "
        f"(kv_block={PAGED_BLOCK}) through the ServingEngine (main path)")
    eng = engine(kv_block=PAGED_BLOCK)
    paged_row, paged_served = serve_main(torch, np, dev, eng, prompts,
                                         "the paged serving path")
    want = dict.fromkeys(paged_row["launches"], 0)
    want["paged_decode_attention"] = n_layers * paged_row["decode_steps"]
    if paged_row["launches"] != want:
        raise AssertionError(f"launches {paged_row['launches']}, expected "
                             f"{want} ({paged_row['decode_steps']} decode "
                             f"steps of {n_layers} layers; pool "
                             f"{eng.pool.n_blocks} blocks of {PAGED_BLOCK})")
    launches["paged_decode_attention"] = want["paged_decode_attention"]
    if paged_served != served:
        raise AssertionError(f"paged tokens {paged_served} != phase 7's "
                             f"contiguous tokens {served}")
    log("  paged tokens equal phase 7's contiguous tokens, request for "
        "request; every block came back")
    profile_decode(torch, np, eng, paged_row)
    del eng
    eager_twin(torch, np, dev, engine(kv_block=PAGED_BLOCK), prompts,
               paged_row, paged_served)
    check_preemption(engine(kv_block=PAGED_BLOCK, policy="edf",
                            preempt="edf-displace", clock=lambda: 0),
                     prompts, served)
    paged_row["gated"] = paged_gated_run(
        torch, np, engine(kv_block=PAGED_BLOCK,
                          kv_pool_blocks=2 * SERVE_CACHE // PAGED_BLOCK + 1),
        prompts, served)
    paged_row["chunked"] = paged_chunked_run(torch, np, engine, prompts,
                                             served)
    model_rows.append(paged_row)

    phase(f"phase 10: {LM_ARCH} full width, bfloat16, quantized serving "
        f"through the ServingEngine (main path)")
    del lm_model, bundle
    torch.cuda.empty_cache()
    q_rows, q_launches = quantized_serving(torch, np, dev)
    launches.update(q_launches)
    model_rows.extend(q_rows)
    torch.cuda.empty_cache()

    phase(f"phase 11: {SSM_ARCH} full width, float32, prefill on K8 vs the "
        f"plain scan (one-shot, chunked, teacher-forced decode)")
    model_rows.append(ssm_teacher_forced(torch, np, dev))

    phase(f"phase 12: {SSM_ARCH} full width, bfloat16, through the "
        f"ServingEngine (main path)")
    ssm_rows, ssm_launches = recurrent_serving(torch, np, dev, SSM_ARCH,
                                               N_SERVE, preempt=True)
    model_rows.extend(ssm_rows)
    log(f"  then {HYBRID_ARCH} full width, bfloat16")
    hybrid_rows, hybrid_launches = recurrent_serving(
        torch, np, dev, HYBRID_ARCH, SERVE_SLOTS, preempt=False)
    model_rows.extend(hybrid_rows)
    launches["ssd_scan"] = ssm_launches["a"]

    phase("phase 13: every micro op on the card — a Yi-6B decoder block "
          "and the op-coverage graph (main path)")
    with main_path(torch, "the new micro ops (phase 13)") as traced:
        graph_rows, graph_cards, want = run_new_ops(np, dev)
    for name, n in want.items():
        if traced[name] != n:
            raise AssertionError(f"phase 13: {name} launched {traced[name]} "
                                 f"times, the invokes' ops {n}")
    eager_invokes(np, graph_rows, graph_cards)
    profile_invokes(torch, graph_rows, graph_cards)
    model_rows.extend(graph_rows)
    del graph_cards
    torch.cuda.empty_cache()

    phase("phase 14: ragged micro dispatch on the card (main path)")
    ragged_row, ragged_k1 = ragged_micro(torch, np, dev)
    model_rows.append(ragged_row)
    micro_paths = {
        "phases 3-4": {k: launches[k] for k in want},
        "phase 13": {k: traced[k] for k in want},
        "phase 14": {"quant_matmul": ragged_k1, "flash_attention": 0}}
    for name in want:
        launches[name] = sum(path[name] for path in micro_paths.values())

    phase(f"phase 15: DeepSeek-MoE-16B full width, {MOE_LAYERS} of 28 "
          f"layers, bfloat16, and Qwen3-MoE-30B-A3B full width, through the "
          f"ServingEngine (main path)")
    moe_rows, summaries, family_launches = moe_serving(torch, np, dev)
    model_rows.extend(moe_rows)
    phase("phase 16: PaliGemma-3B full width, bfloat16, through the "
          "ServingEngine (main path)")
    vlm_rows, vlm_summary, vlm_launches = vlm_serving(torch, np, dev)
    model_rows.extend(vlm_rows)
    summaries += vlm_summary
    phase("phase 17: Whisper-large-v3 full width, bfloat16, through the "
          "ServingEngine (main path)")
    audio_rows, audio_summary = audio_serving(torch, np, dev)
    model_rows.extend(audio_rows)
    summaries += audio_summary
    phase("phase 18: Mamba2-780m and Zamba2-1.2B full width, int8 and int4 "
          "weights, through the ServingEngine (main path)")
    rq_rows, rq_summaries, rq_launches = quantized_recurrent_serving(
        torch, np, dev)
    model_rows.extend(rq_rows)
    summaries += rq_summaries
    layer_rows, layer_summaries, layer_runs = serving_layers(torch, np, dev,
                                                             served)
    model_rows.extend(layer_rows)
    summaries += layer_summaries
    phase(f"phase 25: training — {LM_ARCH} full width, {TRAIN_LAYERS} "
          f"layers, bfloat16, trained, checkpointed and served (main path)")
    train_rows, train_summary, train_k3 = training(torch, np, dev)
    model_rows.extend(train_rows)
    summaries.append(train_summary)
    layer_runs.setdefault("decode_attention", {})[
        "phase 25 (d) restored weights"] = train_k3
    phase("phase 26: mesh-sharded serving — (a) Yi-6B on one rank over "
          "NCCL, (b) four models on two ranks (main path)")
    mesh_rows, mesh_summary, mesh_runs = mesh_serving(
        torch, np, dev, served, serve_row["programs"]["prefill"])
    model_rows.extend(mesh_rows)
    summaries.append(mesh_summary)
    for kname, per_run in mesh_runs.items():
        layer_runs.setdefault(kname, {}).update(per_run)
    phase("phase 27: mesh-sharded training — (a) Yi-6B, DeepSeek-MoE-16B "
          "and Whisper (and its K/V split) on two ranks against one "
          "device, (b) phase 25's model and Whisper on two cards, (c) "
          "Yi-6B and Whisper at full depth on four (where the cards show)")
    mt_rows, mt_summary = mesh_training(torch, np, dev,
                                        train_rows[0]["losses"])
    model_rows.extend(mt_rows)
    summaries.append(mt_summary)

    def entry(name, source, replaces, rows):
        path = rows[0]                       # the main path's shape
        for r in rows:                       # aliases: kernel_ms, max_err
            r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
        err = max(r["max_abs_err"] for r in rows
                  if r.get("dtype", "int8") != "bfloat16")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "max_err": err,
                "ms": path["ms"], "kernel_ms": path["ms"],
                "plain_ms": path["plain_ms"],
                "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
                "library_ms": path["library_ms"], "shape": path["shape"],
                "per_shape": rows}

    kernels = [
        entry("quant_matmul", "src/repro_torch/kernels/csrc/quant_matmul.cu",
              "src/repro/kernels/quant_matmul.py:58", k1_rows),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:100", k2_rows),
        entry("decode_attention",
              "src/repro_torch/kernels/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:82", k3_rows),
        entry("paged_decode_attention",
              "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
              "src/repro/kernels/decode_attention.py:308", k4_rows),
        entry("dequant_matmul",
              "src/repro_torch/kernels/csrc/dequant_matmul.cu",
              "src/repro/kernels/dequant_matmul.py:58", k5_rows),
        entry("dequant_matmul_i4",
              "src/repro_torch/kernels/csrc/dequant_matmul.cu",
              "src/repro/kernels/dequant_matmul.py:114", k6_rows),
        entry("paged_decode_attention_q",
              "src/repro_torch/kernels/csrc/paged_decode_attention_q.cu",
              "src/repro/kernels/decode_attention.py:242", k7_rows),
        entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:87", k8_rows),
    ]
    for kern in kernels:
        if kern["name"] in attrs:
            kern["registers"], kern["smem_bytes"] = attrs[kern["name"]]
    for kern in kernels:
        if kern["name"] not in ("dequant_matmul", "dequant_matmul_i4"):
            continue
        kern["decode_step_us_per_launch"] = {      # phase 10's profiles
            r["model"]: r["kernel_us_per_launch"][kern["name"]]
            for r in q_rows
            if kern["name"] in r.get("kernel_us_per_launch", {})}
    for kern in kernels[:2]:
        kern["launches_on_paths"] = {
            path: n[kern["name"]] for path, n in micro_paths.items()}
    kernels[-1]["bound_tensor_core_ms"] = k8_rows[0]["bound_tensor_core_ms"]
    kernels[-1]["bound_tensor_core_by"] = k8_rows[0]["bound_tensor_core_by"]
    kernels[-1]["us_per_launch_in_prefill"] = {
        r["model"]: r["prefill_profile"]["ssd_scan_us_per_launch"]
        for r in ssm_rows + hybrid_rows if "prefill_profile" in r}
    kernels[-1]["launches_on_runs"] = {
        f"{SSM_ARCH} one-shot": ssm_launches["a"],
        f"{SSM_ARCH} prefill_chunk={CHUNK}": ssm_launches["b"],
        f"{HYBRID_ARCH} one-shot": hybrid_launches["a"],
        f"{HYBRID_ARCH} prefill_chunk={CHUNK}": hybrid_launches["b"],
        **{f"{run} weights (phase 18)": n for run, n in rq_launches.items()}}
    # phase 15's runs: each kernel's launches on each MoE run (the VLM
    # and Whisper runs launch none, asserted)
    for kern in kernels:
        runs = {f"{run} (phase 15)": counts[kern["name"]]
                for run, counts in family_launches.items()
                if kern["name"] in counts}
        if runs:
            kern.setdefault("launches_on_runs", {}).update(runs)
    # phases 19-23's runs: K1's, K3's and K4's launches on each
    for kern in kernels:
        kern.setdefault("launches_on_runs", {}).update(
            layer_runs.get(kern["name"], {}))
    if any(vlm_launches.values()):
        raise AssertionError(f"vlm launched kernels: {vlm_launches}")
    cap = [(r["model"], r["capture_s"], r.get("graph_pool_bytes"))
           for r in model_rows if "capture_s" in r]
    log(f"capture cost: {sum(c[1] for c in cap):.2f} s over "
        f"{len(cap)} models and engines; graph pools "
        + ", ".join(f"{m} {b:,} B" for m, _, b in cap if b is not None))
    log(json.dumps({"phases": summaries}))
    log(json.dumps({"models": model_rows}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
