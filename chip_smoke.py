#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

run from the root of a checkout; it puts ``src`` on the path itself and
builds the CUDA kernels on first use.  It imports nothing of JAX
or of the ``repro`` package.  Phases:

1. Device: name, count, ``nvidia-smi`` name and power limit, the board's
   idle power from NVML before any model is drawn, build time.
2. Each kernel against its plain PyTorch version at the main path's shapes
   (bf16, plus fp32 and edge cases), with kernel, plain, library and bound
   times; K1 plain and with the residual add fused, at the decode and
   prefill shapes, also with its host time per eager call; K3 also at
   ``bench_serve``'s contiguous cache (8 rows over 1024 slots), checked
   with rows on both sides of every chunk edge and timed with its bound,
   plain and SDPA times in the band its traffic decodes in; K3 calls (at
   recurrentgemma's ring and at that cache) and one K4 call captured in
   CUDA graphs and replayed as q_pos crosses their chunk boundaries; K2 at the serving engine's unified-step shapes
   (llama3.1-8b over the gathered pool, recurrentgemma-2b over its ring
   and the chunk) captured and replayed, timed with its bound and SDPA,
   beside the pool gather that feeds it, and K2 at the speculative verify
   window's shape (q (8,5,32,128) over the gathered pool) the same way;
   K4 and K5 also timed at other chunk plans; K1-K4 also at the MoE
   paths' shapes (qwen3-moe-30b-a3b's heads 32/4 and moonshot-v1-16b-a3b's
   16/16 of 128: K2 at the prefill and the unified step, K3 at the measure
   path's cache and a serving one, K3 and K4 replayed from CUDA graphs;
   K1 at d = 2048 over the serving decode's 8 rows and the unified step's
   2048), each held to its plain version and timed under ``moe`` (K1
   under ``modes``); and at the last two families' shapes under
   ``families``: llava-next-34b's heads 56/8 of 128 (G = 7; K2 at its
   prefill of 1024 positions, K3 at the measure path's (1, 1057) cache
   replayed from a graph, K4 over its serving pool of 8 * 128 + 1 blocks,
   K1 at d = 7168) and seamless-m4t-large-v2's MHA 16 of 64 (K2 without
   the causal mask at the encoder's 256 frames and the cross attention's
   512 queries over 256 memory rows, K3 at its self-attention cache and
   one query over 272 memory rows of which 256 are filled, K1 at d =
   1024); K1's split norm (each slice's sum of squares, their sum, each
   slice normalised with it) at xlstm-1.3b's cell norm over W = 4096 cut
   to a tp = 2 and a tp = 4 rank's slice, and at the weight-stationary
   decode's residual stream (2 rows over d = 2048 and 12288 cut by data
   2), held to the whole rows' plain norm and timed under ``modes``; K3 at
   that decode's (data 2, model 2) rank, one row and a model rank's heads
   of tinyllama-1.1b and command-r-plus-104b over 516 slots, under
   ``serve_repl``; one ``{"kernels": [...]}`` line.
3. The measured path at full width: ``Elana("llama3.1-8b").measure``
   (TTFT eager; TPOT and TTLT from the decode step replayed from a CUDA
   graph), then the same with NVML energy; size and cache reports; launch
   counts of every kernel checked against the forward passes run, replays
   credited.  Then the replayed loop against the eager one on the same
   prompt (identical greedy tokens), TPOT both ways with the device time
   per replay and the busy share, one replay traced with
   ``capture_torch_trace``, and the ``h100`` estimate beside the
   measurement.
4. Device time by kernel, the number of device kernels and the device's
   busy share (torch.profiler) of an eager prefill and eager decode steps.
5. The serving path at full width: ``ServingEngine`` with a paged KV
   cache and its decode step replayed from a CUDA graph serves 24
   requests with NVML energy attribution; finishes, block accounting,
   launch counts and dispatches per step checked; one decode replay
   traced and split by kernel family in an untimed run of its own.  Then
   the same greedy trace with and without the graph: identical streams.
   Then chunked prefill (chunk and budget 256) through the unified step,
   replayed from its own CUDA graph: with the prefix cache on a
   shared-prefix trace (24 requests, 2 prefixes of 448 tokens; prefix
   counters checked, and the same run without the graphs gives identical
   streams), and without it on the first trace, printed beside the
   whole-prompt numbers, with the unified replay's device time, busy
   share and split by kernel family.
6. Full-width parity: prefill + 4 greedy decode steps through the kernels
   and through the plain versions, both held against an fp32 copy of the
   same weights, over a contiguous cache (B=1), a paged one (B=4,
   shuffled block tables) and the paged one prefilled in chunks of 256,
   whose first-token logits and greedy streams are also held to the
   whole prompt's.  Then, for llama3.1-8b, preemption with recompute (the
   first trace on a pool cut to 129 blocks, chunked through the unified
   graph, against the same trace uncontended) and prompt-lookup
   speculation (a tiled-motif trace, whole-prompt and chunked, and an
   adversarial drafter on the first trace, each against the run without
   speculation), every difference between two runs' streams held to the
   margin of the decision it flipped.  Then the serving front end, llama
   only: the paged engine (CUDA-graph decode step, NVML energy) prewarmed
   and served over HTTP by ``start_http_server``, the 24 greedy requests
   of ``serve_arrivals`` sent at once by the port's ``stream_completion``
   (every request streams its budget in contiguous chunks, each emitted
   before it arrived; client TTFT >= engine TTFT; ``/metrics`` dispatches
   per step p50 = 1, p95 <= 2; streams gated against the same trace
   served directly; the client-minus-engine TTFT split into its parts
   from the server's stamps); ``OpenLoopDriver`` over the same lengths arriving as
   a Poisson process at 8 requests/s (no request submitted early; streams
   gated against the same trace at t = 0); and, once the model is freed,
   ``bench_serve.main``'s two steps twice in this process (llama3.1-8b
   drawn anew, contiguous cache, prompt 256, 32 new tokens, 3 s warm-up,
   a 5 s window, NVML, ``--check``), closed loop at concurrency 8 and
   open loop at 4 requests/s: every request sent finished without an
   error with its budget, launch counts exact, the TTFT split printed.
7. The dry-run (``dryrun_phase``), run last, after phase 14, whose
   counts it reads: ``launch.dryrun.run_cell`` on this machine's host in
   ``DRYRUN_WORKERS`` processes started before phase 14 (they need the
   CPU only, and run while its ranks do), no kernel launched, for one
   cell of each shape at the production mesh's 16 x 16 (tinyllama-1.1b
   train_4k, qwen3-moe-30b-a3b prefill_32k, command-r-plus-104b
   decode_32k under FSDP and with ``serve_repl``, printed side by side,
   the all-gathers falling by at least 0.95 of the weights FSDP gathers,
   xlstm-1.3b long_500k; llama3.1-8b's long_500k skipped, as
   ``should_skip`` says), every per-device field filled; the sharded
   phase's counted steps at (2, 2), the two weight-stationary decode
   steps among them: their collectives equal, by axis and kind in count
   and bytes, what each rank counted, and their per-device peak
   estimates within ``PEAK_BAND`` of each rank's measured peak; then the
   calibration: llama3.1-8b at full width, its prefill of 1 x 8192 and
   its decode step at 32 x 8192 counted on one device and run through
   K1-K3, timed by ``time_callable``, every sample at least the dry-run's
   bound, launches exact; the dry-run's FLOPs beside ``prefill_flops`` and
   ``train_flops``.
8. Phases 3-6 again for the RG-LRU hybrid recurrentgemma-2b (26 layers:
   18 RG-LRU, 8 local attention over a 2048-token ring), once llama3.1-8b
   is freed: measure with exact launch counts (K5 18 per forward pass),
   graph against eager, the profile, 16 requests served (paged, CUDA-graph
   step) and 8 greedy ones with and without the graph, the same 16
   chunked through the unified step, and the parity over a 2304-token
   prompt, past the window, so the ring wraps (whole and in chunks), with
   the tied embedding table scaled by 0.05 so that rows decide.
9. The xLSTM family, each model drawn once the one before it is freed:
   phases 3-6 for nemotron-h-8b at full width on 26 of its 52 layers (one
   whole block pattern: 16 mLSTM cells of 128 heads x 64, 7 FFN-only
   layers, 3 GQA attention layers; K1 twice per mLSTM block, K2/K3 on the
   attention layers, K4 when served paged; its size report at all 52),
   16 requests served and 8 greedy ones with and without the graph, the
   same 16 chunked through the unified step, and the parity at 512 tokens
   (contiguous, paged, paged in chunks of 256); then xlstm-1.3b (mLSTM
   and sLSTM layers 7:1, no attention: K1 only) at full width on 8 of
   its 48 layers (its size report at all 48): measure, graph against
   eager, the profile and the parity over a contiguous cache, whole and
   in chunks.  Each model's phases print their time.
10. The MoE family, each model drawn once the one before it is freed
   (capacity dispatch into (E, C, d) and the three expert products over
   every expert, plain ``torch.bmm``; K1-K4 as for a dense decoder, no
   kernel for the experts): phases 3-6 for qwen3-moe-30b-a3b at full width
   on 12 of its 48 layers (128 experts top-8; its size report at all 48,
   61.06 GB; the TPOT bound printed with every expert read and with the
   active ones only), 16 requests served and 8 greedy ones with and
   without the graph, the same 16 chunked through the unified step; then
   the same for moonshot-v1-16b-a3b (12 of 48 layers, 64 experts top-6 and
   2 shared, 57.11 GB whole).  Each model's parity runs on a model of
   4 layers at full width drawn once the whole one is freed, with every
   routing decision also forced to the fp32 run's (the count of top-k
   sets that flip under bf16 printed; the kernels held to the plain path
   with the routes forced), and its chunked-vs-whole check at a capacity
   factor of E / k, where nothing is dropped, with the chunked run's routes
   forced to the whole run's.
11. The last two families, each drawn once the model before it is freed:
   phases 3-6 for llava-next-34b at full width on 15 of its 60 layers (GQA
   56/8, 68.78 GB whole), measured at 1024 positions (its 576 patch embeddings
   and 448 tokens; decode from position 1024), served (paged, B = 8,
   max_len 2048, 8 * 128 + 1 blocks) and chunked through the per-chunk
   path (its patches with the first chunk), parity on 4 of its layers at
   full width; then seamless-m4t-large-v2 (24 encoder and 24 decoder
   layers, 2.74 GB), measured at 512 tokens and 256 frames (the encoder's
   K2 launches without the causal mask and every decoder layer's cross
   attention, K2 then K3, in the exact counts), the serving engine's
   refusal, and parity at full depth over a contiguous cache, whole and
   in chunks of 256.
12. Tensor-parallel serving on this one card (``tp_phase``; ranks spawned
   by ``launch.mesh.spawn_tp`` run ``sharding.runs.run_plan``), every model
   at full width (``TP_RUNS``): llama3.1-8b on 8 of its 32 layers,
   moonshot-v1-16b-a3b (32 experts a rank, half the shared MLP, 8/8 heads)
   and llava-next-34b (28/4 heads, 576 patches before the tokens) on 4 of
   theirs over 2 gloo ranks, one spawn; command-r-plus-104b (d 12288,
   96/8 heads, d_ff 33792, 256000 tied, parallel block) and
   qwen3-moe-30b-a3b (32 experts a rank, 8/1 heads) on 4 of theirs over 4,
   one spawn; recurrentgemma-2b on 6 of its 26 layers (the LRU width and
   the gates' input rows split; 5/1 heads at tp = 2, attention whole at
   tp = 4; its 2048-slot ring L-sharded) and xlstm-1.3b on 8 of its 48
   (the mLSTM's width and heads split, the sLSTM cell whole, its FFN
   replicated at tp = 4) in both spawns; qwen2.5-1.5b on 8 of its 28 over
   4 (3/1 heads: its 2 KV heads on every rank, the pool replicated and
   read by K4 at the rank's q_head0, the contiguous cache L-sharded); each
   rank drawing its shard of seed 0's weights, model after
   model, collectives staged through the host, steps eager.  Each model is
   held to the tp = 1 model run first and freed before the ranks start:
   its parity prompt (512 tokens, llava 1024 positions with seeded
   patches, recurrentgemma 2304 tokens with its table x0.05, so the ring
   wraps) + 4 greedy steps over a contiguous cache, a paged one and the
   paged one in chunks of 256 (the recurrent models: contiguous, whole and
   in chunks) (logits within its ``parity_phase``'s
   tolerance, top-1 equal where tp = 1's margin exceeds it; every rank's
   logits bit for bit rank 0's), 8 greedy requests of at most 16 tokens
   served (llama: paged and contiguous, whole and in chunks of 256 through
   the per-chunk path; the others: paged; recurrentgemma, xlstm and
   qwen2.5 4 of at most 8, recurrentgemma at tp = 4 only, contiguous, and
   xlstm at tp = 2 only), every rank's streams exactly rank 0's and rank
   0's held to tp = 1's by the margin rule, the per-device KV bytes those
   of the reference's layout (``sharding.rules.cache_dim``: a share of tp
   = 1's pool, the whole replicated pool on every rank, or a contiguous
   cache's L slice or heads) and every
   rank's pool accounting tiling; every rank launching the kernels of its
   model's path.  A MoE model's parity and serving jobs take tp = 1's
   recorded routes (bf16 flips top-k sets); one more parity job routes on
   its own, every rank as rank 0, and its flips against tp = 1 are
   printed.  llama3.1-8b, command-r-plus-104b, recurrentgemma and qwen2.5
   run ``parity_phase`` at their tp depth for the tolerance (once for both
   tp), the others reuse their parity phase's (xlstm at 8 layers, the
   others at 4).  Each rank runs one intra-op thread.  With 2 GPUs or more,
   llama3.1-8b also over 2 NCCL ranks with captured steps; else a line
   says it was not run.  The phase's times check correctness only ("gloo
   over one card, host-staged: not a TP latency"); the tp = 2 and tp = 4
   spawns run at the same time.  K1-K4 at one rank's
   shapes are timed in phase 2 (``tp`` under each entry; K4 also over a
   pool of every KV head at query-head offsets 0, 3, 6 and 9; K5 at the
   width's halves and quarters).
13. Training through ``launch.train`` (``train_phase``): tinyllama-1.1b at
   full width and depth, bf16 weights and fp32 moments, 20 steps of 8 x
   1024 synthetic tokens with NVML energy (the loss must fall); on 4 of
   its layers at full width the same run uninterrupted, then preempted
   before step 10, which checkpoints, and resumed from that checkpoint to
   step 20 (its losses bit for bit the uninterrupted run's);
   3 steps with ``--remat``; one step timed by part (forward, backward,
   clip + AdamW) and traced; recurrentgemma-2b at full width and depth, 4
   steps of 2 x 2304 (past its window, so K2's window and K5 are in the
   gradients).  Launch counts exact for the forwards each run made (K1
   and K2 again in remat's recompute); step ms, tokens/s, J/step and
   J/token, the share of the step's bound and the peak memory printed.
   Then one step's gradients through the kernels and through the plain
   versions, each against an fp32 copy (tinyllama-1.1b at full depth,
   recurrentgemma-2b on 4 layers at full width): the kernels' worst
   relative error at most twice the plain path's.  Then one model of each
   other family at full width, 4 steps with NVML energy, the loss falling
   and launches exact, and its gradient parity: xlstm-1.3b on 24 of its
   48 layers (2 x 512; K1 for each block norm and cell norm; parity on 8
   layers), seamless-m4t-large-v2 at full depth (24 + 24 layers, 4 x 1024
   tokens over 512 frames a row; K1 for ``norm_c`` and the encoder's
   norms, K2 per encoder layer and per cross attention; also 2 steps with
   ``--remat``, the encoder's layers recomputed), moonshot-v1-16b-a3b on
   4 of its 48 layers (4 x 1024; parity with the bf16 paths' routes
   forced to the fp32 run's) and llava-next-34b on 4 of its 60 layers
   (2 x 448 tokens after its 576 patches).  K1, K2 and K5 at the training
   shapes are held and timed in phase 2, each with its autograd
   Function's gradients held to the plain version's (``train`` under K2
   and K5, K1's rows under ``modes``).
14. Sharded training (``sharded_train_phase``): one spawn of (data 2,
   model 2) gloo ranks sharing the card, one intra-op thread each, runs
   the driver (``launch.train.run(args, mesh=)``) with FSDP over data and
   tensor parallelism over model: tinyllama-1.1b at full width and depth,
   3 steps of 8 x 1024 ending in a checkpoint, then the trained shards'
   loss and gradients on step 4's batch, gathered; and
   seamless-m4t-large-v2 at full width on 2 encoder and 2 decoder layers,
   2 steps of 4 x 1024 over 512 frames (the sharded encoder and cross
   attention).  Losses finite, tinyllama's falling, K1/K2 launches exact
   on every rank.  Then in this process: the unsharded 5 steps from the
   same seed, whose first 3 losses are within ``SHARDED_LOSS_RTOL`` of
   the sharded run's; the sharded checkpoint restored on one device (the
   elastic case), its gradients on step 4's batch held to an fp32 copy's
   (the sharded ones within 1.5x the bf16 path's distance) and steps 4-5
   run from it, step 4's loss within ``SHARDED_LOSS_RTOL`` of the sharded
   step 4's and both within it of the unsharded run's.  Step times are gloo host copies on one card, not
   FSDP's latency across GPUs.  The same spawn first runs a prefill of 2 x
   512 and 4 greedy decode steps of tinyllama-1.1b at full width on 8 of
   its 22 layers (``Model.prefill``/``decode_step`` under FSDP, one row a
   data rank), held to the one-device model of the same seed by the bf16
   floor, K1-K3 launches exact on every rank; then the same prefill and
   greedy decode steps under the serve rules (weight-stationary: the
   residual stream split over data, the batch whole on every rank, no
   weight gathered) for tinyllama-1.1b on those 8 layers and
   command-r-plus-104b at full width on 2 of its 64 (``SERVE_REPL``):
   every rank's logits equal rank 0's, within twice the bf16 floor of the
   one-device model's and of its fp32 copy's, top-1 equal on decided
   rows, K1 two launches a norm (its split mode) and K3 one an attention
   layer a step on every rank; each rank counts its collectives and
   measures its peak bytes in each prefill, each decode step and each
   train step of tinyllama's run, for phase 7.  Each serve job's time on
   rank 0 is printed by part; they are gloo host copies, not latencies.
15. The last line: ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line is printed; so does a
machine without a CUDA device.
"""

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama3.1-8b"
HYBRID = "recurrentgemma-2b"
NEMOTRON = "nemotron-h-8b"   # the paper's mLSTM hybrid
XLSTM = "xlstm-1.3b"         # mLSTM and sLSTM, no attention
QWEN_MOE = "qwen3-moe-30b-a3b"   # 128 routed experts, top-8
MOONSHOT = "moonshot-v1-16b-a3b"  # 64 routed experts, top-6, 2 shared
LLAVA = "llava-next-34b"          # 576 patch embeddings before the tokens, GQA 56/8
SEAMLESS = "seamless-m4t-large-v2"  # 24 encoder + 24 decoder layers, cross attention
COMMAND_R = "command-r-plus-104b"   # d 12288, GQA 96/8, parallel block, tied; 208 GB
QWEN15 = "qwen2.5-1.5b"             # GQA 12/2 of 128: tp = 4 replicates its KV heads
# tensor parallelism on one card: (arch, tp, one rank's q heads, the KV
# heads they read, head dim, window, softcap); recurrentgemma-2b at tp = 2
# (5 of its 10 heads over its 1 KV head), qwen2.5-1.5b at tp = 4 (3 of 12
# over 1 of its 2 KV heads, which every rank holds)
TP_HEADS = [(ARCH, 2, 16, 4, 128, 0, 0.0), (COMMAND_R, 4, 24, 2, 128, 0, 0.0),
            (QWEN_MOE, 4, 8, 1, 128, 0, 0.0), (MOONSHOT, 2, 8, 8, 128, 0, 0.0),
            (LLAVA, 2, 28, 4, 128, 0, 0.0), (HYBRID, 2, 5, 1, 256, 2048, 30.0),
            (QWEN15, 4, 3, 1, 128, 0, 0.0)]
# qwen2.5-1.5b's rank at tp = 4 over the replicated pool: K4 reads pool head
# (q_head0 + h) // 6 for query head h, rank r's q_head0 = 3 r
TP_POOL = (QWEN15, 8, 3, 2, 6, (0, 3, 6, 9))   # arch, rows, q heads, pool heads, G, offsets
# command-r-plus-104b at full width on 4 of its 64 layers: all of it would
# not fit one 80 GB card
TP_LAYERS = 4
# 8 greedy requests of ``serve_arrivals``, each cut to 16 new tokens, and
# chunked prefill through the per-chunk path: an eager step of gloo ranks
# sharing the card takes ~150-970 ms (66 host-staged collectives a forward
# of llama3.1-8b), a unified step's B x W = 2048 rows ~7 s (the CPU tests
# hold the unified step at tp = 2 and 4)
TP_REQUESTS, TP_MAX_NEW = 8, 16
# xlstm-1.3b's measure and parity paths on 8 of its 48 layers (1 of its 6
# mLSTM x 7 + sLSTM groups) at full width: its sLSTM prefill is ~128k
# host launches at 48, and the script must end within its 1200 s
XLSTM_LAYERS = 8
# nemotron-h-8b on 26 of its 52 layers (one whole block pattern, its
# attention layers included), the MoE models on 12 of their 48 and
# llava-next-34b on 15 of its 60, each at full width, for every phase (the
# size report whole): at full depth the script took 1125 s of its 1200 on
# an H100 80GB HBM3 (700 W), and another such card ran past 1200 s
NEMOTRON_LAYERS, MOE_LAYERS, LLAVA_LAYERS = 26, 12, 15
SIZE_GB = {ARCH: "16.06", HYBRID: "5.36", NEMOTRON: "16.38",   # the reference's
           XLSTM: "3.77", QWEN_MOE: "61.06", MOONSHOT: "57.11",  # size reports
           LLAVA: "68.78", SEAMLESS: "2.74"}
# the MoE models' and llava-next-34b's parity: a model of this many layers
# at full width, drawn once the whole model is freed (an fp32 copy of all
# 48 or 60 would not fit)
PARITY_LAYERS = 4
# the tensor-parallel runs, gloo ranks sharing this card, one spawn of ranks
# for each tp: (arch, tp, layers at full width, 0 for all).  llama3.1-8b on
# 8 of its 32 layers (the whole model took 103 s of the script's 1200 in PR
# 24); the MoE models and llava-next-34b on ``PARITY_LAYERS``: the model of
# their parity phase (same seed), whose tolerance the run reuses; eager gloo
# steps of the whole models would not fit the script's 1200 s
TP_LLAMA_LAYERS = 8
# the recurrent families and the undivided KV heads, each over 2 and / or
# 4 ranks inside the same two spawns: recurrentgemma-2b on 6 of its 26
# layers (two groups of RG-LRU, RG-LRU, local attention), xlstm-1.3b on
# ``XLSTM_LAYERS``, the model of its parity phase, whose tolerance the run
# reuses (one group of 7 mLSTM + 1 sLSTM; at tp = 4 its sLSTM FFN of 2730
# is replicated), qwen2.5-1.5b on 8 of its 28 (2 KV heads: at tp = 4 the
# pool replicated, the contiguous cache L-sharded)
TP_HYBRID_LAYERS, TP_XLSTM_LAYERS, TP_QWEN15_LAYERS = 6, XLSTM_LAYERS, 8
BATCH, PROMPT, GEN, ITERS = 1, 512, 32, 3
# llava-next-34b's prompt: its 576 patches and 448 tokens (a prompt no
# longer than the patches leaves no token)
PROMPTS = {LLAVA: 1024}
HYBRID_PARITY_PROMPT = 2304  # past the 2048-token window: the ring wraps
# the parity of a tp run's model, run at its depth in ``tp_phase``, as the
# model's own parity phase runs: recurrentgemma-2b over its 2304-token
# prompt (the L-sharded ring wraps) with its tied table x0.05, the
# recurrent models on the contiguous layout (their state is per row); the
# ranks' jobs take the same prompt and table
TP_PARITY = {HYBRID: dict(prompt=HYBRID_PARITY_PROMPT, paged=False, table_scale=0.05),
             XLSTM: dict(paged=False)}
# the serving path: paged pool of 8 * 64 + 1 blocks of 16 tokens
SERVE = dict(cache_layout="paged", kv_block_size=16, max_batch=8, max_len=1024,
             prompt_bucket=64, seed=0)
SERVE_REQUESTS = {ARCH: 24, HYBRID: 16, NEMOTRON: 16, QWEN_MOE: 16, MOONSHOT: 16, LLAVA: 16}
# llava-next-34b: every prompt after its 576 patches, so max_len 2048 and a
# pool of 8 * 128 + 1 blocks (~4.0 GB of KV beside 68.78 GB of weights)
SERVE_ARCH = {LLAVA: dict(max_len=2048, kv_num_blocks=8 * 128 + 1)}
# chunked prefill through the unified step, and the shared-prefix trace's
# system prompt (28 blocks of 16)
CHUNKED = dict(prefill_chunk=256, prefill_budget=256)
TP_CHUNKED = dict(CHUNKED, unified_step=False)
SHARED_PREFIX = 448
# each run's serving jobs, by name: llama3.1-8b paged and contiguous, whole
# and in chunks; the others paged and whole.  The recurrent models serve at
# one tp each (their parity runs at both): recurrentgemma-2b at tp = 4 over
# the contiguous layout (its attention whole and its local attention's
# cache L-sharded, 256 of 1024 slots a rank, which the ledger check reads;
# it has no full-context layer, so the paged layout would run the same
# steps), xlstm-1.3b at tp = 2 (its sLSTM FFN split)
PAGED, CONTIGUOUS = {"paged whole": {}}, {"contiguous whole": dict(cache_layout="contiguous")}
TP_LLAMA_SERVES = {"paged whole": {}, "paged chunked": TP_CHUNKED,
                   "contiguous whole": dict(cache_layout="contiguous"),
                   "contiguous chunked": dict(TP_CHUNKED, cache_layout="contiguous")}
TP_RUNS = [(ARCH, 2, TP_LLAMA_LAYERS, TP_LLAMA_SERVES), (MOONSHOT, 2, PARITY_LAYERS, PAGED),
           (LLAVA, 2, PARITY_LAYERS, PAGED), (HYBRID, 2, TP_HYBRID_LAYERS, {}),
           (XLSTM, 2, TP_XLSTM_LAYERS, PAGED), (COMMAND_R, 4, TP_LAYERS, PAGED),
           (QWEN_MOE, 4, PARITY_LAYERS, PAGED), (HYBRID, 4, TP_HYBRID_LAYERS, CONTIGUOUS),
           (XLSTM, 4, TP_XLSTM_LAYERS, {}), (QWEN15, 4, TP_QWEN15_LAYERS, PAGED)]
# the recurrent and qwen2.5-1.5b runs' requests: 4 of at most 8 new tokens
# (their eager gloo steps carry a block's gathers and fp32 partials)
TP_SMALL = {HYBRID: (4, 8), XLSTM: (4, 8), QWEN15: (4, 8)}
GRAPH_REQUESTS = {ARCH: 24, HYBRID: 8, NEMOTRON: 8, QWEN_MOE: 8, MOONSHOT: 8, LLAVA: 8}
# preemption: the pool cut to two worst-case requests and the garbage block
# (2 * 64 + 1 blocks of 16), overcommit survived by recompute
PREEMPT = dict(kv_num_blocks=129, preemption="recompute")
# speculation: prompt-lookup drafts of up to 4 tokens, on prompts that tile
# a motif of 8 tokens 8 times, 64 greedy tokens each
SPEC = dict(speculative="lookup", spec_tokens=4)
LOOKUP = dict(num_requests=16, motif_len=8, repeats=8, max_new=64)
VERIFY_W = SPEC["spec_tokens"] + 1   # the verify window: last token + draft
# training (``train_phase``): tinyllama-1.1b at full width and depth, batch
# 8 x 1024 of synthetic data, 20 steps (and on ``RESUME_LAYERS`` layers
# checkpointed at 10 by a preempted run, then resumed), 3 steps with
# remat; recurrentgemma-2b at full
# width and depth, 4 steps of 2 x 2304 (past its window); gradient parity
# on tinyllama at full depth (2 x 1024) and recurrentgemma on 4 layers
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS, TRAIN_CKPT_AT = 20, 10
# the preempted run and its resume on 4 of tinyllama's 22 layers at full
# width, held to an uninterrupted run of that depth: at 22 layers each of
# their checkpoints is 10.25 GiB on disk (two written, one read: 65-73 s)
RESUME_LAYERS = 4
TRAIN = ["--batch", "8", "--seq-len", "1024", "--lr", "1e-3", "--warmup", "4",
         "--log-every", "5"]
HYBRID_TRAIN_STEPS = 4
HYBRID_TRAIN = ["--batch", "2", "--seq-len", str(HYBRID_PARITY_PROMPT), "--lr", "1e-3",
                "--warmup", "2", "--log-every", "1"]
TRAIN_PARITY = {TRAIN_ARCH: (2, 1024, 0), HYBRID: (2, HYBRID_PARITY_PROMPT, 4)}
# the other families, each at full width through ``launch.train`` for
# FAMILY_TRAIN_STEPS steps with NVML energy: (layers, 0 for all; batch;
# text tokens a row; peak learning rate).  xlstm-1.3b on 24 of its 48
# layers (3 of its 6 groups: at 48 a step took 14 s of host launches) and
# seamless-m4t-large-v2 (512 frames a row) at full depth;
# moonshot-v1-16b-a3b and llava-next-34b (its 576 patches before the
# tokens: 1024 positions) on 4 of their 48 and 60 layers, whose whole would
# need ~319 and ~384 GiB of state at 12 bytes a parameter.  From the
# random init (N(0, 1) tables: first losses 145-480) Adam's first steps
# move every weight by about the learning rate, so the rate at which the
# loss falls shrinks with the width: at 1e-4 over 4 steps seamless's and
# llava's rise, at 1e-5 moonshot's stays flat
FAMILY_TRAIN = {XLSTM: (24, 2, 512, "3e-5"), SEAMLESS: (0, 4, 1024, "3e-5"),
                MOONSHOT: (4, 4, 1024, "1e-4"), LLAVA: (4, 2, 448, "1e-5")}
FAMILY_TRAIN_STEPS = 4
FAMILY_ARGS = ["--warmup", "2", "--log-every", "1"]
# their gradient parity: (batch, text tokens, layers); xlstm-1.3b on one
# group of its pattern (7 mLSTM + 1 sLSTM)
FAMILY_PARITY = {XLSTM: (2, 512, 8), SEAMLESS: (2, 1024, 0), MOONSHOT: (2, 1024, 4),
                 LLAVA: (2, 448, 4)}
# sharded training (``sharded_train_phase``): one spawn of (data 2, model
# 2) gloo ranks on the card; tinyllama-1.1b at full width and depth, 3
# steps of 8 x 1024 ending in its checkpoint (on an H100 80GB HBM3 a step
# is 9-15 s of host-staged collectives and each 11 GB checkpoint 31-39 s,
# so one checkpoint, at the end: the script must stay within its limit),
# then the loss and gradients of the step after it;
# at ``TRAIN``'s peak 1e-3 the first steps from the random init raise the
# loss sharded and unsharded alike (200.8 -> 483.3 -> 358.5 unsharded),
# so the peak is 3e-5, as the other families' runs take;
# seamless-m4t-large-v2 at full width on 2 encoder and 2 decoder layers
# (4 + 4 took 12 s a step), 2 steps of 4 x 1024 tokens over 512 frames a
# row
SHARDED_MESH = (2, 2)
SHARDED_STEPS = 3
# every tinyllama loss of the phase (sharded, unsharded, resumed on one
# device from the sharded checkpoint) within this of the others: half a
# bf16 ulp, relative.  On an H100 80GB HBM3 (700 W) the sharded losses
# read 6.3e-5 from the unsharded ones over 3 steps, and the one-device
# resume 2.4e-4 from the unsharded step 4
SHARDED_LOSS_RTOL = 2.0 ** -8
PARITY_CHUNKS = 4   # the fp32 copy's row blocks in ``sharded_grad_parity``
SHARDED_TRAIN = ["--batch", "8", "--seq-len", "1024", "--lr", "3e-5", "--warmup", "4",
                 "--log-every", "1"]
SHARDED_SEAMLESS = (2, ["--batch", "4", "--seq-len", "1024", "--lr", "3e-5", "--steps", "2"]
                    + FAMILY_ARGS)
# prefill and decode on the same (data 2, model 2) mesh, in the same spawn:
# tinyllama-1.1b at full width on 8 of its 22 layers, bf16, drawn from seed
# 0; a prefill of 2 x 512 (one row a data rank) and 4 greedy decode steps
SHARDED_SERVE_LAYERS = 8
SHARDED_SERVE = (2, 512, 4)   # rows, prompt, decode steps
# the weight-stationary decode (``sharding.rules.use_serve_rules``, the
# reference's ``--opt serve_repl``) in the same spawn: the same prefill,
# then its greedy decode steps under the serve rules on the same cache;
# arch -> layers at full width: tinyllama-1.1b on ``SHARDED_SERVE_LAYERS``
# and command-r-plus-104b on 2 of its 64 (~12.6 GB in bf16, a quarter a
# rank; the check's one-device model and its fp32 copy ~38 GB more, drawn
# once the ranks are gone)
SERVE_REPL = {TRAIN_ARCH: SHARDED_SERVE_LAYERS, COMMAND_R: 2}
# the dry-run's per-device peak estimate (arguments + temp) over a rank's
# measured peak (``torch.cuda.max_memory_allocated`` over the step), for
# the train step, the prefill and a decode step: the band predicted in
# PERF.md (PR 31) before the first run; 1.5x either way bounds it anyway
PEAK_BAND = (0.75, 1.15)
# processes the dry-run's cells run in, side by side, on this host's CPU
# while the sharded phase's ranks run (``start_dryrun``)
DRYRUN_WORKERS = 3
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
BF16_FLOPS = 989e12             # dense tensor-core bf16, published
FP32_FLOPS = 67e12              # fp32 outside the tensor cores, published
L2_BYTES = 50 * 2**20


class CheckFailed(Exception):
    pass


def prompt_of(cfg):
    """The measured prompt's positions (patches and tokens) of ``cfg``."""
    return PROMPTS.get(cfg.name, PROMPT)


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n_inputs, iters=60, warmup=6):
    """Mean device time per call with CUDA events; ``fn(i)`` runs on input
    set ``i % n_inputs``, which rotate through more than the L2 cache so
    each call finds its inputs cold, as on the main path.  The device first
    spins for ~0.1 s while the host enqueues every launch, so the events
    time the device's work and not the host's launch rate."""
    import torch

    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=200, rounds=5):
    """Host time per eager call (µs): the median over ``rounds`` of
    ``calls`` calls enqueued behind a device spin, so the device never
    holds the host back."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def copies(nbytes):
    """Input sets to rotate through so that they exceed the L2 cache."""
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def close(a, b, tol):
    import torch

    try:
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    except AssertionError as e:
        raise CheckFailed(str(e)) from None


def grad_check(name, counter, call, plain, inputs, tol):
    """``call`` (a kernel wrapper) with grad on: one launch (on
    ``counter``) inside its autograd Function, and every input's gradient
    held to autograd through ``plain`` on the same inputs and cotangents
    (within ``tol``: the Function's backward is that VJP).  Returns the
    largest gradient difference."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = counter.launches
    outs = call(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    check(counter.launches == before + 1 and all(o.grad_fn is not None for o in outs),
          f"{name}: the kernel did not launch inside its autograd Function")
    g = torch.Generator(device=outs[0].device).manual_seed(2)
    cots = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype) for o in outs]
    got = torch.autograd.grad(outs, leaves, cots)
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref_outs = plain(*ref_leaves)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    want = torch.autograd.grad(ref_outs, ref_leaves, cots)
    torch.cuda.synchronize()
    check(counter.launches == before + 1, f"{name}: the backward launched the kernel")
    err = max(max_err(a, b) for a, b in zip(got, want))
    for a, b in zip(got, want):
        close(a, b, tol)
    log(f"check {name} gradients: max_abs_err={err:.3e} tol={tol} (the plain version's VJP)")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.linear_recurrence import ops as lr_ops, ref as lr_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops, ref as rn_ref

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    tol = {bf16: 2e-2, torch.float32: 2e-5}   # as the reference's kernel tests
    entries = []
    moe_heads = [(arch, get_config(arch).num_heads, get_config(arch).num_kv_heads)
                 for arch in (QWEN_MOE, MOONSHOT)]

    def moe_rows(entry, rows, key="moe"):
        """Another family's paths' rows under ``entry[key]`` (``moe``,
        ``families`` for llava-next-34b and seamless-m4t-large-v2, ``tp``
        for one tensor-parallel rank's heads); their errors count in the
        entry's ``max_abs_err``."""
        for row in rows:
            log(f"time {entry['name']} {row['arch']} {row['path']}: " + json.dumps(row))
        entry[key] = rows
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [r["max_abs_err"] for r in rows])

    def log_time(name, shape, fn, case):
        """Device time of ``fn`` at a second shape of the path, inputs
        rotated past the L2 cache as for the table's shape."""
        *tensors, kw = case
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        n = copies(nbytes)
        sets = [[t.clone() for t in tensors] + [kw] for _ in range(n)]
        log(f"time {name} {shape}: kernel_ms={cuda_ms(lambda i: fn(sets[i]), n):.4f}")

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def arange_pos(B, n, offset=0):
        return (torch.arange(n, dtype=torch.int32, device=dev) + offset).expand(B, n).contiguous()

    # -- K2 flash attention ---------------------------------------------------
    def fa_case(name, B, S, T, Hq, Hkv, D, dtype, window=0, softcap=0.0, k_offset=0,
                q_offset=0, causal=True, memory=False):
        """``memory``: the keys are an encoder memory, every row at 0."""
        q, k, v = randn(B, S, Hq, D, dtype=dtype), randn(B, T, Hkv, D, dtype=dtype), \
            randn(B, T, Hkv, D, dtype=dtype)
        qp, kp = arange_pos(B, S, q_offset), arange_pos(B, T, k_offset)
        if memory:
            kp = torch.zeros_like(kp)
        kw = dict(q_positions=qp, k_positions=kp, causal=causal, window=window, softcap=softcap)
        out = fa_ops.flash_attention(q, k, v, **kw)
        ref = fa_ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        log(f"check flash_attention {name}: max_abs_err={err:.3e} tol={tol[dtype]}")
        return (q, k, v, kw), err

    (q, k, v, kw), err = fa_case("main B=1 S=512 Hq=32 Hkv=8 D=128 causal",
                                 BATCH, PROMPT, PROMPT, 32, 8, 128, bf16)
    errs = [err]
    errs.append(fa_case("window=32 softcap=30 ragged S=96 D=80", 2, 96, 96, 4, 2, 80, bf16,
                        window=32, softcap=30.0)[1])
    (q2, k2, v2, kw2), e2 = fa_case("row with no valid key", 1, 64, 64, 4, 2, 64, bf16,
                                    k_offset=10)
    out2 = fa_ops.flash_attention(q2, k2, v2, **kw2)
    check(out2[:, :10].abs().max().item() == 0.0, "no-valid-key rows must be 0")
    errs.append(e2)
    fa_case("fp32 window=24 S=100 D=64", 2, 100, 100, 8, 2, 64, torch.float32, window=24)
    # recurrentgemma-2b's local attention: MQA G=10, D=256, window 2048, softcap 30
    hybrid_fa, e_h = fa_case(f"recurrentgemma B=1 S={PROMPT} Hq=10 Hkv=1 D=256 window=2048 "
                             f"softcap=30", 1, PROMPT, PROMPT, 10, 1, 256, bf16, window=2048,
                             softcap=30.0)
    errs.append(e_h)
    hybrid_long, e_l = fa_case(f"recurrentgemma past the window S={HYBRID_PARITY_PROMPT}", 1,
                               HYBRID_PARITY_PROMPT, HYBRID_PARITY_PROMPT, 10, 1, 256, bf16,
                               window=2048, softcap=30.0)
    errs.append(e_l)
    # the tensor-core kernel's edges: D = 8 padded to the mma depth, D = 256
    # with a ragged query tile, and a chunk of 96 queries over a cache
    errs.append(fa_case("D=8 padded S=100", 2, 100, 100, 8, 2, 8, bf16)[1])
    errs.append(fa_case("D=256 ragged S=70 softcap=30", 1, 70, 70, 10, 1, 256, bf16,
                        softcap=30.0)[1])
    errs.append(fa_case("chunk S=96 at 320.. over T=400 keys at 16..", 2, 96, 400, 32, 8, 128,
                        bf16, q_offset=320, k_offset=16)[1])
    fa_call = lambda args: fa_ops.flash_attention(*args[:3], **args[3])  # noqa: E731
    log_time("flash_attention", f"q (1,{PROMPT},10,256) window=2048 softcap=30", fa_call,
             hybrid_fa)
    log_time("flash_attention", f"q (1,{HYBRID_PARITY_PROMPT},10,256) window=2048 softcap=30",
             fa_call, hybrid_long)

    def fa_row(case, prefill=True):
        """Kernel, plain and SDPA times of K2 on ``case``'s inputs, with the
        bound of the K and V rows some query of each row sees (all of them
        in a prefill, and every filled one without the causal mask).  SDPA:
        causal in a causal prefill, unmasked without the causal mask, else
        a boolean mask from the same positions."""
        q, k, v, kw = case
        B, S, Hq, D = q.shape
        qp, kp = kw["q_positions"], kw["k_positions"]
        if not kw["causal"]:
            check(bool((kp >= 0).all()), "an unmasked K2 row is timed with every key filled")
            qp = torch.full_like(qp, int(kp.max()))  # every key visible to every query
        window, softcap = kw.get("window", 0), kw.get("softcap", 0.0)
        visible = (kp[:, None, :] >= 0) & (qp[:, :, None] >= kp[:, None, :])
        if window:
            visible &= qp[:, :, None] - kp[:, None, :] < window
            prefill = False  # SDPA takes the window as a boolean mask
        pairs = visible.sum().item()
        seen = visible.any(dim=1).sum().item()
        nbytes = 2 * 2 * q.numel() + 2 * 2 * seen * k.shape[2] * D + 4 * (qp.numel() + kp.numel())
        n = copies(2 * (2 * q.numel() + k.numel() + v.numel()))
        sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
        tq = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
               c.transpose(1, 2).contiguous()) for a, b, c in sets]
        mask = None if prefill else visible[:, None]
        if not kw["causal"]:
            mask, prefill = None, False
        library = None  # SDPA has no softcap: no one PyTorch call computes it
        if not softcap:
            library = cuda_ms(lambda i: F.scaled_dot_product_attention(
                *tq[i], attn_mask=mask, is_causal=prefill, enable_gqa=True), n)
        return dict(
            shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} "
                  f"{'bf16' if q.dtype == torch.bfloat16 else 'fp32'} "
                  f"{'causal' if kw['causal'] else 'unmasked'}"
                  + (f" window={window}" if window else "")
                  + (f" softcap={softcap:g}" if softcap else ""),
            ms=cuda_ms(lambda i: fa_ops.flash_attention(*sets[i], **kw), n),
            plain_ms=cuda_ms(lambda i: fa_ref.plain_attention(*sets[i], **kw), n, iters=20),
            library_ms=library,
            **bound(nbytes, 4 * D * pairs * Hq, BF16_FLOPS))

    entries.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:100",
        max_abs_err=max(errs), **fa_row((q, k, v, kw))))
    entries[-1]["unified"] = unified_flash_check(dev, randn)
    # the MoE paths: the measure path's prefill and the unified step's
    # (8, 256) frontier over the 1024 gathered keys, at each model's heads
    moe = []
    for arch, Hq, Hkv in moe_heads:
        case, err = fa_case(f"{arch} B=1 S={PROMPT} Hq={Hq} Hkv={Hkv} D=128 causal", BATCH,
                            PROMPT, PROMPT, Hq, Hkv, 128, bf16)
        moe.append(dict(arch=arch, path="prefill", max_abs_err=err, **fa_row(case)))
        starts = [256] + [0] * 7
        q, k, v, kw = unified_flash_case(dev, randn, "paged", starts, starts, heads=(Hq, Hkv))
        got, ref = fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        close(got, ref, tol[bf16])
        log(f"check flash_attention {arch} unified step q {tuple(q.shape)} k {tuple(k.shape)}: "
            f"max_abs_err={err:.3e} tol={tol[bf16]}")
        moe.append(dict(arch=arch, path="unified step", max_abs_err=err,
                        **fa_row((q, k, v, kw), prefill=False)))
    moe_rows(entries[-1], moe)
    # llava-next-34b's prefill of 1024 positions at its heads 56/8 of 128
    # (G = 7); seamless-m4t-large-v2's encoder self-attention (no mask)
    # over 256 frames and its decoder's cross attention, 512 queries over
    # the 256 memory rows, MHA 16 of 64
    fams = []
    lv, nvh, nvk = PROMPTS[LLAVA], 56, 8
    case, err = fa_case(f"{LLAVA} B=1 S={lv} Hq={nvh} Hkv={nvk} D=128 causal", 1, lv, lv, nvh,
                        nvk, 128, bf16)
    fams.append(dict(arch=LLAVA, path="prefill", max_abs_err=err, **fa_row(case)))
    case, err = fa_case(f"{SEAMLESS} encoder B=1 S=256 Hq=16 Hkv=16 D=64 unmasked", 1, 256, 256,
                        16, 16, 64, bf16, causal=False)
    fams.append(dict(arch=SEAMLESS, path="encoder", max_abs_err=err, **fa_row(case)))
    case, err = fa_case(f"{SEAMLESS} cross B=1 S={PROMPT} over 256 memory rows Hq=16 D=64", 1,
                        PROMPT, 256, 16, 16, 64, bf16, causal=False, memory=True)
    fams.append(dict(arch=SEAMLESS, path="cross prefill", max_abs_err=err, **fa_row(case)))
    moe_rows(entries[-1], fams, "families")
    # tensor parallelism: one rank's heads at the prefill (llama3.1-8b at
    # tp = 2, 16/4; command-r-plus-104b at tp = 4, 24/2, G = 12; qwen3-moe
    # at tp = 4, 8/1; moonshot at tp = 2, 8/8; llava-next-34b at tp = 2,
    # 28/4 over its 1024 positions) and the unified step's frontier at 16/4
    tps = []
    for arch, tp, Hq, Hkv, D, window, softcap in TP_HEADS:
        S = PROMPTS.get(arch, PROMPT)
        mask = {k: v for k, v in (("window", window), ("softcap", softcap)) if v}
        case, err = fa_case(f"{arch} tp={tp} B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} causal {mask}",
                            BATCH, S, S, Hq, Hkv, D, bf16, **mask)
        tps.append(dict(arch=arch, path=f"tp={tp} prefill", max_abs_err=err, **fa_row(case)))
    starts = [256] + [0] * 7
    q, k, v, kw = unified_flash_case(dev, randn, "paged", starts, starts, heads=(16, 4))
    got, ref = fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    close(got, ref, tol[bf16])
    log(f"check flash_attention {ARCH} tp=2 unified step q {tuple(q.shape)} k {tuple(k.shape)}: "
        f"max_abs_err={err:.3e} tol={tol[bf16]}")
    tps.append(dict(arch=ARCH, path="tp=2 unified step", max_abs_err=err,
                    **fa_row((q, k, v, kw), prefill=False)))
    moe_rows(entries[-1], tps, "tp")
    # training (``train_phase``): tinyllama-1.1b's batch 8 x 1024 at its
    # heads 32/4 of 64, recurrentgemma-2b's 2 x 2304 past its window; the
    # forward held to the plain version, the autograd Function's gradients
    # to the plain version's
    # and the other families' training runs: seamless-m4t-large-v2's
    # encoder (4 x 512 frames, unmasked), decoder (4 x 1024) and cross
    # attention (1024 queries over the 512 frames), MHA 16 of 64;
    # moonshot-v1-16b-a3b's 4 x 1024 at 16/16 of 128; llava-next-34b's 2 x
    # 1024 positions (576 patches, 448 tokens) at 56/8 of 128; and one rank
    # of the (data 2, model 2) sharded runs (``sharded_train_phase``):
    # tinyllama-1.1b's 4 rows at 16/2 of 64, seamless-m4t-large-v2's 2 rows
    # at 8 of its 16 heads (encoder, decoder, cross)
    unmasked = dict(causal=False)
    trains = []
    for arch, path, shape, mask in (
            (TRAIN_ARCH, "train", (8, 1024, 1024, 32, 4, 64), {}),
            (HYBRID, "train", (2, HYBRID_PARITY_PROMPT, HYBRID_PARITY_PROMPT, 10, 1, 256),
             dict(window=2048, softcap=30.0)),
            (SEAMLESS, "train encoder", (4, 512, 512, 16, 16, 64), unmasked),
            (SEAMLESS, "train", (4, 1024, 1024, 16, 16, 64), {}),
            (SEAMLESS, "train cross", (4, 1024, 512, 16, 16, 64), dict(unmasked, memory=True)),
            (MOONSHOT, "train", (4, 1024, 1024, 16, 16, 128), {}),
            (LLAVA, "train", (2, PROMPTS[LLAVA], PROMPTS[LLAVA], 56, 8, 128), {}),
            (TRAIN_ARCH, "sharded train rank", (4, 1024, 1024, 16, 2, 64), {}),
            (SEAMLESS, "sharded train rank encoder", (2, 512, 512, 8, 8, 64), unmasked),
            (SEAMLESS, "sharded train rank", (2, 1024, 1024, 8, 8, 64), {}),
            (SEAMLESS, "sharded train rank cross", (2, 1024, 512, 8, 8, 64),
             dict(unmasked, memory=True))):
        case, err = fa_case(f"{arch} {path} B={shape[0]} S={shape[1]} T={shape[2]} "
                            f"Hq={shape[3]} Hkv={shape[4]} D={shape[5]} {mask or 'causal'}",
                            *shape, bf16, **mask)
        q, k, v, kw = case
        gerr = grad_check(f"flash_attention {arch} {path}", fa_ops.flash_attention,
                          lambda q, k, v: fa_ops.flash_attention(q, k, v, **kw),
                          lambda q, k, v: fa_ref.plain_attention(q, k, v, **kw), (q, k, v),
                          tol[bf16])
        trains.append(dict(arch=arch, path=path, max_abs_err=err, grad_max_abs_err=gerr,
                           **fa_row(case)))
    moe_rows(entries[-1], trains, "train")

    # -- K3 decode attention --------------------------------------------------
    L = PROMPT + GEN + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def da_case(name, B, L, Hq, Hkv, D, dtype, q_at, filled, window=0, ring_at=None,
                softcap=0.0, memory=False):
        """``q_at`` and ``filled`` (slots below it hold keys) are one value
        for every row or a list of one per row; ``memory``: the filled
        slots are an encoder memory, every row at position 0."""
        def rows(x):
            return torch.tensor(x if isinstance(x, list) else [x] * B, dtype=torch.int32,
                                device=dev)[:, None]

        q = randn(B, 1, Hq, D, dtype=dtype)
        kc, vc = randn(B, L, Hkv, D, dtype=dtype), randn(B, L, Hkv, D, dtype=dtype)
        if ring_at is None:
            kp = arange_pos(B, L)
            kp = torch.where(kp < rows(filled), 0 if memory else kp, -1).to(torch.int32)
            kp = kp.contiguous()
        else:  # ring: slot j holds the latest position = j (mod L)
            slots = torch.arange(L, device=dev)
            kp = (ring_at - (ring_at - slots) % L).to(torch.int32).expand(B, L).contiguous()
        qp = rows(q_at).contiguous()
        kw = dict(q_positions=qp, k_positions=kp, window=window, softcap=softcap)
        out = da_ops.decode_attention(q, kc, vc, **kw)
        ref = da_ref.decode_attention(q, kc, vc, **kw)
        # the merge algebra at the chunks the kernel itself splits into
        chunk = da_ops.split_plan(B, Hkv, L, sms)[1]
        split = da_ref.decode_attention_split(q, kc, vc, chunk=chunk, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        close(out, split, tol[dtype])
        log(f"check decode_attention {name}: max_abs_err={err:.3e} tol={tol[dtype]}; "
            f"against the split merge at chunk {chunk}: {max_err(out, split):.3e}")
        return (q, kc, vc, kw), err

    fill = PROMPT + 8  # slots beyond the decoded tokens are still -1
    (q, kc, vc, kw), err = da_case(f"main B=1 L={L} Hq=32 Hkv=8 D=128", 1, L, 32, 8, 128,
                                   bf16, q_at=fill - 1, filled=fill)
    errs = [err]
    errs.append(da_case(f"B=8 L={L}", 8, L, 32, 8, 128, bf16, q_at=fill - 1, filled=fill)[1])
    errs.append(da_case("ring L=64 window=64 at 150", 2, 64, 8, 2, 128, bf16, q_at=150,
                        filled=0, window=64, ring_at=150)[1])
    errs.append(da_case("no valid key", 1, 64, 4, 2, 64, bf16, q_at=5, filled=0)[1])
    da_case("fp32 MHA G=1 D=64", 3, 96, 4, 4, 64, torch.float32, q_at=50, filled=51)
    da_case("fp32 G=16 D=80", 2, 130, 16, 1, 80, torch.float32, q_at=129, filled=130)
    # recurrentgemma-2b: G=10, D=256 over its 2048-token ring, wrapped; B=8
    # over the serving engine's 1024-token ring
    hybrid_da, e_h = da_case("recurrentgemma ring L=2048 window=2048 softcap=30 at 2304", 1,
                             2048, 10, 1, 256, bf16, q_at=2304, filled=0, window=2048,
                             ring_at=2304, softcap=30.0)
    errs.append(e_h)
    errs.append(da_case("recurrentgemma B=8 L=1024 softcap=30", 8, 1024, 10, 1, 256, bf16,
                        q_at=700, filled=701, window=2048, softcap=30.0)[1])
    # split-KV edges: a wrapped ring whose window of 300 leaves every chunk
    # between slots 100 and 1849 invisible; L = 1000 in 4 chunks of 256
    # (the last ragged); one row empty over 32 chunks; the serving ring
    ring_at = 2 * 2048 + 100
    errs.append(da_case(f"ring L=2048 window=300 at {ring_at}: middle chunks empty", 1, 2048,
                        10, 1, 256, bf16, q_at=ring_at, filled=0, window=300,
                        ring_at=ring_at)[1])
    errs.append(da_case("B=8 L=1000 Hq=32 Hkv=8", 8, 1000, 32, 8, 128, bf16, q_at=999,
                        filled=1000)[1])
    # llama3.1-8b behind bench_serve: a contiguous (8, 1024) cache, split
    # into 4 chunks of 256; rows on both sides of each chunk edge, then
    # rows in the band its traffic decodes in
    spread = [0, 255, 256, 270, 511, 512, 768, 1023]
    errs.append(da_case(f"llama B=8 L=1024 rows at {spread}", 8, 1024, 32, 8, 128, bf16,
                        q_at=spread, filled=[p + 1 for p in spread])[1])
    band = [256 + 4 * b for b in range(8)]
    serving_llama, e_l = da_case(f"llama bench_serve B=8 L=1024 rows at {band}", 8, 1024, 32,
                                 8, 128, bf16, q_at=band, filled=[p + 1 for p in band])
    errs.append(e_l)
    (q0, kc0, vc0, kw0), e0 = da_case("no valid key over L=2048", 1, 2048, 10, 1, 256, bf16,
                                      q_at=5, filled=0)
    check(da_ops.decode_attention(q0, kc0, vc0, **kw0).abs().max().item() == 0.0,
          "a row with no valid key in any chunk must be 0")
    errs.append(e0)
    serving_da, e_s = da_case("recurrentgemma serving B=8 ring L=1024 at 1500", 8, 1024, 10, 1,
                              256, bf16, q_at=1500, filled=0, window=2048, ring_at=1500,
                              softcap=30.0)
    errs.append(e_s)
    da_call = lambda args: da_ops.decode_attention(*args[:3], **args[3])  # noqa: E731
    log_time("decode_attention", "q (1,1,10,256) ring (1,2048,1,256) softcap=30", da_call,
             hybrid_da)
    log_time("decode_attention", "q (8,1,10,256) ring (8,1024,1,256) softcap=30", da_call,
             serving_da)
    decode_graph_check(dev, randn, 1, 2048, 10, 1, 256, (62, 63, 64, 65, 127, 128, 1000, 2047),
                       window=2048, softcap=30.0)
    decode_graph_check(dev, randn, 8, 1024, 32, 8, 128, ([255] * 8, band, spread,
                                                           [p + 1 for p in spread], [1023] * 8))

    def da_row(case):
        """Kernel, plain and SDPA times of K3 on ``case``'s inputs, with the
        bound of the keys its rows see."""
        q, kc, vc, kw = case
        B, L, Hkv, D = kc.shape
        Hq = q.shape[2]
        qp, kp = kw["q_positions"], kw["k_positions"]
        valid = ((kp >= 0) & (kp <= qp)).sum().item()
        nbytes = 2 * (2 * valid * Hkv * D + 2 * q.numel()) + 4 * (qp.numel() + kp.numel())
        n = copies(2 * 2 * kc.numel())
        sets = [(q.clone(), kc.clone(), vc.clone()) for _ in range(n)]
        tq = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
               c.transpose(1, 2).contiguous()) for a, b, c in sets]
        mask = ((kp >= 0) & (kp <= qp))[:, None, None, :]
        return dict(
            shape=f"q ({B},1,{Hq},{D}) cache ({B},{L},{Hkv},{D}) bf16, {valid} valid keys",
            ms=cuda_ms(lambda i: da_ops.decode_attention(*sets[i], **kw), n),
            plain_ms=cuda_ms(lambda i: da_ref.decode_attention(*sets[i], **kw), n),
            # SDPA has no softcap: no one PyTorch call computes a capped row
            library_ms=None if kw["softcap"] else cuda_ms(
                lambda i: F.scaled_dot_product_attention(*tq[i], attn_mask=mask,
                                                         enable_gqa=True), n),
            **bound(nbytes, 4 * D * valid * Hq, BF16_FLOPS))

    entries.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:93",
        max_abs_err=max(errs), **da_row((q, kc, vc, kw))))
    # bench_serve's contiguous cache (B = 8, max_len 1024): prompts of 256
    # and 32 new tokens put every row in the 256-287 band
    entries[-1]["serving"] = da_row(serving_llama)
    log("time decode_attention bench_serve: " + json.dumps(entries[-1]["serving"]))
    # the MoE paths: the measure path's decode over (1, 545), replayed
    # from a graph across its chunk edges, and a contiguous serving cache
    # (8, 1024) with rows on both sides of each chunk edge
    moe = []
    for arch, Hq, Hkv in moe_heads:
        case, err = da_case(f"{arch} B=1 L={L} Hq={Hq} Hkv={Hkv} D=128", 1, L, Hq, Hkv, 128,
                            bf16, q_at=fill - 1, filled=fill)
        moe.append(dict(arch=arch, path="measure decode", max_abs_err=err, **da_row(case)))
        chunk = da_ops.split_plan(1, Hkv, L, sms)[1]
        decode_graph_check(dev, randn, 1, L, Hq, Hkv, 128,
                           (0, chunk - 1, chunk, 2 * chunk, fill - 1, L - 1))
        case, err = da_case(f"{arch} B=8 L=1024 Hq={Hq} Hkv={Hkv} rows at {spread}", 8, 1024,
                            Hq, Hkv, 128, bf16, q_at=spread, filled=[p + 1 for p in spread])
        moe.append(dict(arch=arch, path="serving decode", max_abs_err=err, **da_row(case)))
    moe_rows(entries[-1], moe)
    # llava-next-34b's measure decode over (1, 1057) at G = 7, replayed
    # across its chunk edges; seamless-m4t-large-v2's self-attention decode
    # and its cross attention, one query over 272 memory rows of which the
    # prompt's 256 are filled
    fams = []
    Lv, fill_v = lv + GEN + 1, lv + 8
    case, err = da_case(f"{LLAVA} B=1 L={Lv} Hq={nvh} Hkv={nvk} D=128", 1, Lv, nvh, nvk, 128,
                        bf16, q_at=fill_v - 1, filled=fill_v)
    fams.append(dict(arch=LLAVA, path="measure decode", max_abs_err=err, **da_row(case)))
    chunk = da_ops.split_plan(1, nvk, Lv, sms)[1]
    decode_graph_check(dev, randn, 1, Lv, nvh, nvk, 128,
                       (0, chunk - 1, chunk, 2 * chunk, fill_v - 1, Lv - 1))
    case, err = da_case(f"{SEAMLESS} self B=1 L={L} Hq=16 Hkv=16 D=64", 1, L, 16, 16, 64, bf16,
                        q_at=fill - 1, filled=fill)
    fams.append(dict(arch=SEAMLESS, path="self decode", max_abs_err=err, **da_row(case)))
    case, err = da_case(f"{SEAMLESS} cross B=1 over 272 memory rows, 256 filled", 1, L // 2, 16,
                        16, 64, bf16, q_at=fill - 1, filled=PROMPT // 2, memory=True)
    fams.append(dict(arch=SEAMLESS, path="cross decode", max_abs_err=err, **da_row(case)))
    moe_rows(entries[-1], fams, "families")
    # tensor parallelism: the measure path's (1, 545) cache at one rank's heads
    tps = []
    for arch, tp, Hq, Hkv, D, window, softcap in TP_HEADS:
        case, err = da_case(f"{arch} tp={tp} B=1 L={L} Hq={Hq} Hkv={Hkv} D={D} "
                            f"window={window} softcap={softcap}", 1, L, Hq, Hkv, D, bf16,
                            q_at=fill - 1, filled=fill, window=window, softcap=softcap)
        tps.append(dict(arch=arch, path=f"tp={tp} measure decode", max_abs_err=err,
                        **da_row(case)))
    moe_rows(entries[-1], tps, "tp")
    # the weight-stationary decode on a (data 2, model 2) rank: one row of
    # the batch (its cache's), a model rank's heads, over the sharded
    # phase's prompt and decode steps
    B2, P2, n2 = SHARDED_SERVE
    repl = []
    for arch, Hq, Hkv, D in ((TRAIN_ARCH, 16, 2, 64), (COMMAND_R, 48, 4, 128)):
        case, err = da_case(f"{arch} serve_repl rank B={B2 // SHARDED_MESH[0]} L={P2 + n2} "
                            f"Hq={Hq} Hkv={Hkv} D={D}", B2 // SHARDED_MESH[0], P2 + n2, Hq, Hkv,
                            D, bf16, q_at=P2 + n2 - 1, filled=P2 + n2)
        repl.append(dict(arch=arch, path="serve_repl decode", max_abs_err=err,
                         **da_row(case)))
    moe_rows(entries[-1], repl, "serve_repl")

    # -- K4 paged decode attention ---------------------------------------------
    def pda_case(name, B, Hq, Hkv, D, dtype, q_pos, bs=16, nb=64, N=513, window=0,
                 softcap=0.0, garbage_rows=(), q_head0=0, group=0):
        """Rows at ragged ``q_pos`` over a shuffled pool of N blocks of Hkv
        heads; each row's table names the blocks its keys need, unused
        entries (and every entry of a garbage row, or of a row at -1 with
        no valid key) point at block 0.  Query head h reads pool head
        (q_head0 + h) // group (0: Hq / Hkv).  Also held to the split merge
        algebra at the chunk the kernel splits the positions into."""
        q = randn(B, 1, Hq, D, dtype=dtype)
        kp, vp = randn(N, bs, Hkv, D, dtype=dtype), randn(N, bs, Hkv, D, dtype=dtype)
        perm = (torch.randperm(N - 1, generator=g, device=dev) + 1).tolist()
        tables = torch.zeros(B, nb, dtype=torch.int32)
        for b, p in enumerate(q_pos):
            need = 0 if b in garbage_rows else max(p, -1) // bs + 1
            tables[b, :need] = torch.tensor([perm.pop() for _ in range(need)])
        tables = tables.to(dev)
        qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)[:, None]
        kw = dict(block_tables=tables, q_positions=qp, window=window, softcap=softcap,
                  q_head0=q_head0, group=group)
        out = da_ops.paged_decode_attention(q, kp, vp, **kw)
        ref = da_ref.paged_decode_attention(q, kp, vp, **kw)
        heads = da_ref.pool_heads(Hq, Hkv, q_head0, group)
        chunk = da_ops.split_plan(B, heads.stop - heads.start, nb * bs, sms)[1]
        split = da_ref.paged_decode_attention_split(q, kp, vp, chunk=chunk, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        close(out, split, tol[dtype])
        log(f"check paged_decode_attention {name}: max_abs_err={err:.3e} tol={tol[dtype]}; "
            f"against the split merge at chunk {chunk}: {max_err(out, split):.3e}")
        return (q, kp, vp, kw), err

    # fixed row lengths (5266 valid keys), so K4's time compares from run to run
    q_pos = [447, 768, 758, 604, 388, 823, 517, 953]
    (q, kp, vp, kw), err = pda_case(f"main B=8 Hq=32 Hkv=8 D=128 bs=16 q_pos={q_pos}",
                                    8, 32, 8, 128, bf16, q_pos)
    errs = [err]
    errs.append(pda_case("window=100 softcap=30", 4, 32, 8, 128, bf16, [0, 99, 500, 1000],
                         window=100, softcap=30.0)[1])
    errs.append(pda_case("G=1 D=64 garbage rows q_pos 0", 4, 8, 8, 64, bf16, [0, 300, 0, 31],
                         garbage_rows=(0, 2))[1])
    errs.append(pda_case("G=12 (command-r-plus) bs=32", 3, 96, 8, 128, bf16, [700, 63, 2],
                         bs=32, nb=32, N=97)[1])
    pda_case("fp32 window=64 G=4", 3, 16, 4, 128, torch.float32, [10, 640, 1000], window=64)
    # split-KV edges at the serving shape's 4 chunks of 256: rows on either
    # side of each boundary, the last position, a row with no valid key; a
    # window of 300 that empties the first three chunks of a long row; 48
    # positions a pool block (not a divisor of the 64-key tile)
    edges = [255, 256, 257, 511, 512, 767, 1023, -1]
    (q0, kp0, vp0, kw0), e0 = pda_case(f"split edges q_pos={edges}", 8, 32, 8, 128, bf16,
                                       edges)
    check(da_ops.paged_decode_attention(q0, kp0, vp0, **kw0)[-1].abs().max().item() == 0.0,
          "a row with no valid key must be 0")
    errs.append(e0)
    errs.append(pda_case("window=300 empties leading chunks", 4, 32, 8, 128, bf16,
                         [1000, 900, 300, 40], window=300)[1])
    errs.append(pda_case("bs=48 G=10 D=256 softcap=30", 4, 20, 2, 256, bf16,
                         [1000, 47, 48, 600], bs=48, nb=22, N=89, softcap=30.0)[1])
    paged_graph_check(dev, randn)

    def pda_row(case):
        """Kernel and plain times of K4 on ``case``'s inputs (no window),
        with the bound of the keys its rows see and their table entries."""
        q, kp, vp, kw = case
        B, _, Hq, D = q.shape
        N, bs, pool_heads = kp.shape[:3]
        heads = da_ref.pool_heads(Hq, pool_heads, kw["q_head0"], kw["group"])
        Hkv = heads.stop - heads.start  # the pool heads the call reads
        q_pos = kw["q_positions"][:, 0].tolist()
        valid = int(sum(max(p, -1) + 1 for p in q_pos))  # keys the rows attend to
        nbytes = (2 * (2 * valid * Hkv * D + 2 * q.numel())
                  + 4 * (sum(max(p, -1) // bs + 1 for p in q_pos) + len(q_pos)))
        n = copies(2 * 2 * valid * Hkv * D)
        sets = [(q.clone(), kp.clone(), vp.clone()) for _ in range(n)]
        return dict(
            shape=(f"q ({B},1,{Hq},{D}) pool ({N},{bs},{pool_heads},{D}) bf16, {valid} valid "
                   f"keys" + (f", q_head0 {kw['q_head0']} G {kw['group']}" if kw["group"]
                              else "")),
            ms=cuda_ms(lambda i: da_ops.paged_decode_attention(*sets[i], **kw), n),
            plain_ms=cuda_ms(lambda i: da_ref.paged_decode_attention(*sets[i], **kw), n,
                             iters=20),
            library_ms=None,  # no one PyTorch call gathers through a block table and attends
            **bound(nbytes, 4 * D * valid * Hq, BF16_FLOPS))

    B, Hkv, bs, nb = q.shape[0], kp.shape[2], kp.shape[1], kw["block_tables"].shape[1]
    n = copies(2 * 2 * int(sum(p + 1 for p in q_pos)) * Hkv * q.shape[3])
    sets = [(q.clone(), kp.clone(), vp.clone()) for _ in range(n)]
    pda_call = lambda i: da_ops.paged_decode_attention(*sets[i], **kw)  # noqa: E731
    for per_sm in (1, 2, 4, 8):  # the chunk plan's aim, beside the one it takes
        with patched(da_ops, "BLOCKS_PER_SM", per_sm):
            plan = da_ops.split_plan(B, Hkv, nb * bs, sms)
            log(f"time paged_decode_attention at {per_sm} blocks per SM, (n_split, chunk) = "
                f"{plan}: kernel_ms={cuda_ms(pda_call, n):.4f}")
    entries.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:202",
        max_abs_err=max(errs), **pda_row((q, kp, vp, kw))))
    # the MoE paths' serving decode: 8 rows at the main case's positions
    # over the engine's pool, at each model's heads, also replayed from a
    # graph across the chunk edges
    moe = []
    for arch, Hq, Hkv in moe_heads:
        case, err = pda_case(f"{arch} B=8 Hq={Hq} Hkv={Hkv} D=128 bs=16 q_pos={q_pos}", 8, Hq,
                             Hkv, 128, bf16, q_pos)
        moe.append(dict(arch=arch, path="serving decode", max_abs_err=err, **pda_row(case)))
        paged_graph_check(dev, randn, Hq, Hkv)
    moe_rows(entries[-1], moe)
    # llava-next-34b's serving decode: 8 rows past its 576 patches over the
    # engine's pool (128 blocks of 16 per row, 8 * 128 + 1 blocks), G = 7
    q_pos_v = [p + get_config(LLAVA).num_vision_tokens for p in q_pos]
    case, err = pda_case(f"{LLAVA} B=8 Hq={nvh} Hkv={nvk} D=128 bs=16 q_pos={q_pos_v}", 8, nvh,
                         nvk, 128, bf16, q_pos_v, nb=128, N=8 * 128 + 1)
    paged_graph_check(dev, randn, nvh, nvk)
    moe_rows(entries[-1], [dict(arch=LLAVA, path="serving decode", max_abs_err=err,
                                **pda_row(case))], "families")
    # tensor parallelism: the serving decode over the 513-block pool at one
    # rank's heads
    tps = []
    for arch, tp, Hq, Hkv, D, window, softcap in TP_HEADS:
        if "attn" not in get_config(arch).blocks():
            continue  # sliding-window rings only: no pool, K3 decodes
        if arch == TP_POOL[0]:
            continue  # below: its pool holds every KV head
        case, err = pda_case(f"{arch} tp={tp} B=8 Hq={Hq} Hkv={Hkv} D={D} bs=16 q_pos={q_pos}",
                             8, Hq, Hkv, D, bf16, q_pos, window=window, softcap=softcap)
        tps.append(dict(arch=arch, path=f"tp={tp} serving decode", max_abs_err=err,
                        **pda_row(case)))
    # a rank's query heads over a pool of every KV head, read in place at
    # the rank's offset (the kernel's q_head0)
    # (each offset held to the plain version, the last one timed)
    arch, B, Hq, Hkv, G, offsets = TP_POOL
    errs = [pda_case(f"{arch} tp=4 B={B} Hq={Hq} over pool heads {Hkv} q_head0={q_head0} "
                     f"G={G} D=128 bs=16 q_pos={q_pos}", B, Hq, Hkv, 128, bf16, q_pos,
                     q_head0=q_head0, group=G) for q_head0 in offsets]
    tps.append(dict(arch=arch, path=f"tp=4 serving decode, q_head0 in {list(offsets)}",
                    max_abs_err=max(e for _, e in errs), **pda_row(errs[-1][0])))
    moe_rows(entries[-1], tps, "tp")

    # -- K1 rmsnorm, plain and with the residual add fused in front ------------
    def rn_case(rows, d, dtype, fused):
        """Held to the plain version; the fused sum bit for bit ``x + r``."""
        x, s = randn(rows, d, dtype=dtype), (randn(d) * 0.1).to(dtype)
        r = randn(rows, d, dtype=dtype) * 3.0 if fused else None
        if fused:
            (got_s, out), ref = rn_ops.add_rmsnorm(x, r, s, 1e-6), \
                rn_ref.add_rmsnorm(x, r, s, 1e-6)[1]
        else:
            out, ref = rn_ops.rmsnorm(x, s, 1e-6), rn_ref.rmsnorm(x, s, 1e-6)
        torch.cuda.synchronize()
        if fused:
            check(torch.equal(got_s, x + r), f"add_rmsnorm {rows}x{d}: sum differs from x + r")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        log(f"check {'add_rmsnorm' if fused else 'rmsnorm'} {rows}x{d} {dtype}: "
            f"max_abs_err={err:.3e} tol={tol[dtype]}" + ("; sum == x + r" if fused else ""))
        return (x, r, s), err

    errs = [rn_case(rows, d, dtype, fused)[1] for fused in (False, True)
            for rows, d, dtype in ((7, 12288, torch.float32), (5, 100, bf16),
                                   (5, 100, torch.float32))]
    # the floor of a launch in this timing: a kernel that does nothing
    empty_ms = cuda_ms(lambda i: torch.cuda._sleep(1), 1)
    log(f"time empty kernel (torch.cuda._sleep(1)): kernel_ms={empty_ms:.4f}")
    modes = []
    shapes = [(rows, 4096, fused) for rows in (1, 8, PROMPT) for fused in (False, True)]
    # the xLSTM paths' norms: nemotron-h-8b's mLSTM cell norm over W = 8192
    # (plain mode); xlstm-1.3b's blocks at d = 2048 (both modes; its cell
    # norm's W = 4096 is the width above)
    shapes += [(rows, 8192, False) for rows in (1, 8, PROMPT)]
    shapes += [(rows, 2048, fused) for rows in (1, PROMPT) for fused in (False, True)]
    # the MoE models' blocks at d = 2048: the serving decode's 8 rows and
    # the unified step's 8 x 256
    shapes += [(rows, 2048, fused) for rows in (8, 8 * 256) for fused in (False, True)]
    # llava-next-34b at d = 7168 (its decode, serving decode and prefill
    # rows) and seamless-m4t-large-v2 at d = 1024 (its decode, the
    # encoder's 256 frames and the decoder's 512 tokens)
    shapes += [(rows, 7168, fused) for rows in (1, 8, lv) for fused in (False, True)]
    shapes += [(rows, 1024, fused) for rows in (1, 256, PROMPT) for fused in (False, True)]
    # command-r-plus-104b at d = 12288: its decode and prefill rows
    shapes += [(rows, 12288, fused) for rows in (1, PROMPT) for fused in (False, True)]
    # training: tinyllama-1.1b's 8 x 1024 rows at d = 2048, recurrentgemma-2b's
    # 2 x 2304 at d = 2560; xlstm-1.3b's 2 x 512 at d = 2048 (block and sLSTM
    # cell norms) and W = 4096 (mLSTM cell norms); seamless-m4t-large-v2's
    # 4 x 1024 decoder and 4 x 512 encoder rows at d = 1024;
    # moonshot-v1-16b-a3b's 4 x 1024 at d = 2048 (also a tinyllama-1.1b rank's
    # rows in ``sharded_train_phase``); llava-next-34b's 2 x 1024 positions at
    # d = 7168; a seamless-m4t-large-v2 rank's 2 x 512 encoder rows (its 2 x
    # 1024 decoder rows are the 4 x 512 above); each also through its
    # autograd Function
    train_norms = [(8 * 1024, 2048), (2 * HYBRID_PARITY_PROMPT, 2560), (2 * 512, 2048),
                   (2 * 512, 4096), (4 * 1024, 1024), (4 * 512, 1024), (4 * 1024, 2048),
                   (2 * PROMPTS[LLAVA], 7168), (2 * 512, 1024)]
    shapes += [(rows, d, fused) for rows, d in train_norms for fused in (False, True)]
    for rows, d, fused in shapes:
        (x, r, s), err = rn_case(rows, d, bf16, fused)
        errs.append(err)
        numel = rows * d
        # decode rows arrive hot from the kernel that wrote them; prompt
        # rows are rotated past the L2 cache, as for the other kernels
        n = copies(2 * 2 * numel) if rows >= PROMPT else 1
        sets = [(x.clone(), None if r is None else r.clone()) for _ in range(n)]
        w = (1.0 + s.float()).to(bf16)
        if fused:
            kern = lambda i: rn_ops.add_rmsnorm(*sets[i], s, 1e-6)  # noqa: E731
            plain = lambda i: rn_ref.add_rmsnorm(*sets[i], s, 1e-6)  # noqa: E731
            lib = lambda i: F.rms_norm(sets[i][0] + sets[i][1], (d,), weight=w,  # noqa: E731
                                       eps=1e-6)
            sep = lambda i: rn_ops.rmsnorm(sets[i][0] + sets[i][1], s, 1e-6)  # noqa: E731
            nbytes, flops = 2 * (4 * numel + d), 5 * numel
        else:
            kern = lambda i: rn_ops.rmsnorm(sets[i][0], s, 1e-6)  # noqa: E731
            plain = lambda i: rn_ref.rmsnorm(sets[i][0], s, 1e-6)  # noqa: E731
            lib = lambda i: F.rms_norm(sets[i][0], (d,), weight=w, eps=1e-6)  # noqa: E731
            sep = None
            nbytes, flops = 2 * (2 * numel + d), 4 * numel
        mode = dict(mode="add_rmsnorm" if fused else "rmsnorm", shape=f"({rows},{d}) bf16",
                    max_abs_err=err, ms=cuda_ms(kern, n), plain_ms=cuda_ms(plain, n),
                    library_ms=cuda_ms(lib, n),
                    separate_add_then_kernel_ms=None if sep is None else cuda_ms(sep, n),
                    host_us=host_us(lambda: kern(0)),
                    **bound(nbytes, flops, FP32_FLOPS))
        if (rows, d) in train_norms:
            inputs, eps = (x, r, s) if fused else (x, s), 1e-6
            call = (lambda x, r, s: rn_ops.add_rmsnorm(x, r, s, eps)) if fused else \
                (lambda x, s: rn_ops.rmsnorm(x, s, eps))
            plain_fn = (lambda x, r, s: rn_ref.add_rmsnorm(x, r, s, eps)) if fused else \
                (lambda x, s: rn_ref.rmsnorm(x, s, eps))
            mode["grad_max_abs_err"] = grad_check(
                f"{mode['mode']} ({rows},{d}) train", rn_ops.rmsnorm, call, plain_fn, inputs,
                tol[bf16])
        log("time " + json.dumps(mode))
        modes.append(mode)
    # the split norm of a tensor-parallel rank: xlstm-1.3b's mLSTM cell norm
    # over W = 4096 cut to W / 2 and W / 4 (its decode and prompt rows); and
    # of a weight-stationary decode step's residual stream, the whole batch
    # over d cut to d / 2 by data 2 (tinyllama-1.1b, command-r-plus-104b):
    # K1's two launches around a sum of every slice's statistic (the ranks'
    # all-reduce), the slices side by side held to the plain norm of the
    # whole rows; one rank's two launches timed
    split_norms = [(4096, tp, rows, "tp") for tp in (2, 4) for rows in (1, PROMPT)]
    split_norms += [(d, SHARDED_MESH[0], SHARDED_SERVE[0], "data")
                    for d in (2048, 12288)]
    for W, tp, rows, axis in split_norms:
        x, sc = randn(rows, W, dtype=bf16), (randn(W) * 0.1).to(bf16)
        parts = [t.contiguous() for t in x.chunk(tp, -1)]
        scs = [t.contiguous() for t in sc.chunk(tp, -1)]
        stat = sum(rn_ops.rmsnorm_sumsq(t) for t in parts)
        out = torch.cat([rn_ops.rmsnorm(t, g, 1e-6, stat=stat, width=W)
                         for t, g in zip(parts, scs)], -1)
        ref = rn_ref.rmsnorm(x, sc, 1e-6)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        close(out, ref, tol[bf16])
        errs.append(err)
        d = W // tp
        numel = rows * d
        log(f"check split rmsnorm {rows}x{W} over {axis}={tp}: max_abs_err={err:.3e} "
            f"tol={tol[bf16]}")
        n = copies(2 * 2 * numel) if rows >= PROMPT else 1
        sets = [parts[0].clone() for _ in range(n)]
        kern = lambda i: rn_ops.rmsnorm(  # noqa: E731
            sets[i], scs[0], 1e-6, stat=rn_ops.rmsnorm_sumsq(sets[i]), width=W)
        plain = lambda i: rn_ref.rmsnorm(  # noqa: E731
            sets[i], scs[0], 1e-6, stat=rn_ref.sumsq(sets[i]), width=W)
        mode = dict(mode="split rmsnorm (sumsq, then stat)",
                    shape=f"({rows},{d}) bf16, a slice of W = {W} at {axis} = {tp}",
                    max_abs_err=err, ms=cuda_ms(kern, n), plain_ms=cuda_ms(plain, n),
                    library_ms=None, host_us=host_us(lambda: kern(0)),
                    **bound(2 * (2 * numel + d) + 4 * rows, 4 * numel, FP32_FLOPS))
        log("time " + json.dumps(mode))
        modes.append(mode)
    table = next(m for m in modes
                 if m["mode"] == "rmsnorm" and m["shape"].startswith(f"({PROMPT},"))
    entries.append(dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/rmsnorm.py:26",
        shape=f"x {table['shape']}, plain mode (every mode and shape under 'modes')",
        max_abs_err=max(errs),
        **{k: table[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        empty_kernel_ms=empty_ms, modes=modes))

    # -- K5 linear recurrence -----------------------------------------------------
    def lr_case(name, Bn, S, W, pad=False, a_max=None):
        """a in (0.8, 1), b ~ 0.1 N, nonzero h0 (the reference's sweep);
        ``pad`` makes the last third of every row identity steps (a=1,
        b=0), as padded positions arrive; ``a_max`` draws a from (0,
        a_max) instead, where chunk products underflow.  rtol 1e-4 / atol
        1e-5, as the reference holds Pallas to its ref; also held to the
        split algebra at the chunk the kernel splits S into."""
        f32 = torch.float32
        a = torch.sigmoid(randn(Bn, S, W, dtype=f32)) * 0.2 + 0.8
        if a_max is not None:
            a = torch.rand(Bn, S, W, generator=g, device=dev) * a_max
        b, h0 = randn(Bn, S, W, dtype=f32) * 0.1, randn(Bn, W, dtype=f32)
        if pad:
            a[:, S - S // 3:] = 1.0
            b[:, S - S // 3:] = 0.0
        out, ref = lr_ops.linear_recurrence(a, b, h0), lr_ref.linear_recurrence(a, b, h0)
        chunk = lr_ops.scan_plan(Bn, S, W, sms)[1]
        split = lr_ref.linear_recurrence_chunked(a, b, h0, chunk)
        torch.cuda.synchronize()
        check(out.shape == a.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        try:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(out, split, rtol=1e-4, atol=1e-5)
        except AssertionError as exc:
            raise CheckFailed(f"linear_recurrence {name}: {exc}") from None
        log(f"check linear_recurrence {name}: max_abs_err={err:.3e} rtol=1e-4 atol=1e-5; "
            f"against the split algebra at chunk {chunk}: {max_err(out, split):.3e}")
        return (a, b, h0), err

    W = 2560  # recurrentgemma's lru_width
    (a, b, h0), err = lr_case(f"main B=1 S={PROMPT} W={W}", 1, PROMPT, W)
    errs = [err]
    long_lr, e_l = lr_case(f"prompt past the window B=1 S={HYBRID_PARITY_PROMPT} W={W}", 1,
                           HYBRID_PARITY_PROMPT, W)
    errs.append(e_l)
    (a1, b1, h01), e1 = lr_case(f"serving decode B=8 S=1 W={W}", 8, 1, W)
    errs.append(e1)
    errs.append(lr_case("ragged B=2 S=37 W=100", 2, 37, 100)[1])
    errs.append(lr_case("identity pad steps B=2 S=37 W=100", 2, 37, 100, pad=True)[1])
    errs.append(lr_case(f"identity pad steps B=4 S=300 W={W}", 4, 300, W, pad=True)[1])
    errs.append(lr_case(f"admission B=8 S={PROMPT} W={W}", 8, PROMPT, W)[1])
    errs.append(lr_case(f"a in (0, 1e-3), decay products underflow B=1 S={PROMPT} W={W}", 1,
                        PROMPT, W, a_max=1e-3)[1])
    errs.append(lr_case("ragged split B=3 S=300 W=129", 3, 300, 129)[1])
    t1 = cuda_ms(lambda i: lr_ops.linear_recurrence(a1, b1, h01), 1)
    log(f"time linear_recurrence 8x1x{W}: kernel_ms={t1:.4f} (the serving decode shape)")
    lr_call = lambda args: lr_ops.linear_recurrence(*args[:3])  # noqa: E731
    Bn, S, W = a.shape
    for case, shape in (((a, b, h0, {}), (Bn, S, W)), (long_lr + ({},), long_lr[0].shape)):
        log_time("linear_recurrence", f"{tuple(shape)} in {lr_ops.scan_plan(*shape, sms)} "
                 f"(n_chunks, chunk)", lr_call, case)
        with patched(lr_ops, "MIN_CHUNK", 1 << 30):  # one chunk: the single pass
            log_time("linear_recurrence", f"{tuple(shape)} in one chunk", lr_call, case)
    n = copies(3 * 4 * a.numel())
    sets = [(a.clone(), b.clone(), h0.clone()) for _ in range(n)]

    def lr_row(sets, n):
        a, h0 = sets[0][0], sets[0][2]
        return dict(
            ms=cuda_ms(lambda i: lr_ops.linear_recurrence(*sets[i]), n),
            plain_ms=cuda_ms(lambda i: lr_ref.linear_recurrence(*sets[i]), n),
            # no one PyTorch call computes a first-order linear recurrence
            # (the cumprod/cumsum closed form divides by the decay product,
            # which underflows)
            library_ms=None,
            # one pass's bytes (a, b read once, h written once), though the
            # split kernel reads a and b twice
            **bound(4 * (3 * a.numel() + h0.numel()), 2 * a.numel(), FP32_FLOPS))

    entries.append(dict(
        name="linear_recurrence", route="cuda",
        source="src/repro_torch/kernels/csrc/linear_recurrence.cu",
        replaces="src/repro/kernels/linear_recurrence/linear_recurrence.py:55",
        shape=f"a/b ({Bn},{S},{W}) h0 ({Bn},{W}) fp32",
        max_abs_err=max(errs), **lr_row(sets, n)))
    # training: recurrentgemma-2b's 2 x 2304 rows, forward and the autograd
    # Function's gradients (the doubling scan's VJP)
    (a, b, h0), err = lr_case(f"train B=2 S={HYBRID_PARITY_PROMPT} W={W}", 2,
                              HYBRID_PARITY_PROMPT, W)
    gerr = grad_check("linear_recurrence train", lr_ops.linear_recurrence,
                      lr_ops.linear_recurrence, lr_ref.linear_recurrence, (a, b, h0), 1e-4)
    n = copies(3 * 4 * a.numel())
    moe_rows(entries[-1], [dict(
        arch=HYBRID, path="train", shape=f"a/b {tuple(a.shape)} h0 {tuple(h0.shape)} fp32",
        max_abs_err=err, grad_max_abs_err=gerr,
        **lr_row([(a.clone(), b.clone(), h0.clone()) for _ in range(n)], n))], "train")
    # tensor parallelism: a rank's slice of recurrentgemma-2b's width at
    # tp = 2 and 4, the measure prompt
    tps = []
    for tp in (2, 4):
        (a, b, h0), err = lr_case(f"{HYBRID} tp={tp} B=1 S={PROMPT} W={W // tp}", 1, PROMPT,
                                  W // tp)
        n = copies(3 * 4 * a.numel())
        tps.append(dict(arch=HYBRID, path=f"tp={tp} prefill",
                        shape=f"a/b {tuple(a.shape)} h0 {tuple(h0.shape)} fp32",
                        max_abs_err=err,
                        **lr_row([(a.clone(), b.clone(), h0.clone()) for _ in range(n)], n)))
    moe_rows(entries[-1], tps, "tp")
    for e in entries:
        e["kernel_ms"] = e["ms"]
    return entries


def unified_flash_case(dev, randn, layout, starts, lengths, W=256, heads=(32, 8)):
    """K2's inputs in the serving engine's unified step, B = len(starts)
    chunk rows of W queries at ``starts`` (``lengths`` of them tokens).
    ``paged`` (llama3.1-8b's ``heads``, Hq and Hkv of 128, or another
    model's): over the gathered pool of 64 blocks of 16, keys at 0..1023.  ``ring`` (recurrentgemma-2b): over a 1024-slot ring
    filled up to each row's start (-1 where a row has no chunk and
    nothing cached) plus the chunk, its pad columns at -1, window 2048,
    softcap 30: T = 1280 keys, not sorted."""
    import torch

    B = len(starts)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)[:, None]
    col = torch.arange(W, dtype=torch.int32, device=dev)[None]
    qp = (st + col).contiguous()
    if layout == "paged":
        (Hq, Hkv), D, T, kw = heads, 128, 1024, {}
        kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
    else:
        Hq, Hkv, D, L, kw = 10, 1, 256, 1024, dict(window=2048, softcap=30.0)
        slots = torch.arange(L, dtype=torch.int32, device=dev)[None]
        ring = (st - 1) - torch.remainder(st - 1 - slots, L)
        ring = torch.where((ring >= 0) & (ln > 0), ring, -1)
        kp = torch.cat([ring, torch.where(col < ln, qp, -1)], dim=1).to(torch.int32)
        kp, T = kp.contiguous(), L + W
    q, k, v = randn(B, W, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    return q, k, v, dict(q_positions=qp, k_positions=kp, causal=True, **kw)


def unified_flash_check(dev, randn):
    """K2 at the unified step's shapes.  llama3.1-8b: q (8,256,32,128) over
    1024 gathered keys, one row a cursor at 256 (its second chunk), seven
    without a chunk at 0, as the main path gives them; recurrentgemma-2b:
    q (8,256,10,256) over its ring plus the chunk.  Each held to its plain
    version (bf16 tolerance), captured in a CUDA graph and replayed as the
    starts move (equal to the eager call); the llama shape timed against
    its bound, its plain version and SDPA (a boolean mask from the same
    positions), and the pool gather (``cache.gather_paged_kv``) that feeds
    it, per layer, against the gather's bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.models import cache as cache_lib

    out = {}
    for layout, lengths in (("paged", [256] + [0] * 7), ("ring", [256, 0, 0, 77, 0, 0, 0, 0])):
        starts = [256] + [0] * 7
        q, k, v, kw = unified_flash_case(dev, randn, layout, starts, lengths)
        got, ref = fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        close(got, ref, 2e-2)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = fa_ops.flash_attention(q, k, v, **kw)
        moves = ([768, 3, 0, 100, 900, 0, 17, 0], [0, 0, 1023, 767, 0, 5, 0, 1], starts)
        for st in moves:
            new = unified_flash_case(dev, randn, layout, st, lengths)[3]
            kw["q_positions"].copy_(new["q_positions"])
            kw["k_positions"].copy_(new["k_positions"])
            graph.replay()
            eager = fa_ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(torch.equal(replayed, eager), f"unified K2 {layout}: replay differs from eager")
            close(replayed, fa_ref.attention(q, k, v, **kw), 2e-2)
        del graph
        log(f"check flash_attention unified step {layout} q {tuple(q.shape)} k "
            f"{tuple(k.shape)}: max_abs_err={err:.3e} tol=2e-2; {len(moves)} graph replays "
            f"equal eager")
        n = copies(2 * (2 * q.numel() + k.numel() + v.numel()))
        sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
        row = dict(shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal"
                   + (" window=2048 softcap=30" if layout == "ring" else ""),
                   starts=starts, lengths=lengths, max_abs_err=err,
                   ms=cuda_ms(lambda i: fa_ops.flash_attention(*sets[i], **kw), n))
        if layout == "paged":
            qp, kp = kw["q_positions"], kw["k_positions"]
            pairs = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= kp[:, None, :])).sum().item()
            B, S, Hq, D = q.shape
            # K and V only of the keys some query of the row sees (at or
            # before its last query position): 2304 of the 8 x 1024 here
            seen = ((kp >= 0) & (kp <= qp.max(dim=1, keepdim=True).values)).sum().item()
            nbytes = (2 * 2 * q.numel() + 2 * 2 * seen * k.shape[2] * D
                      + 4 * (qp.numel() + kp.numel()))
            mask = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= kp[:, None, :]))[:, None]
            tq = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
                   c.transpose(1, 2).contiguous()) for a, b, c in sets]
            row.update(plain_ms=cuda_ms(lambda i: fa_ref.attention(*sets[i], **kw), n, iters=10),
                       library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
                           *tq[i], attn_mask=mask, enable_gqa=True), n),
                       keys_seen=seen, **bound(nbytes, 4 * D * pairs * Hq, BF16_FLOPS))
            # the gather of one attention layer: the serving pool (513 blocks
            # of 16) through 8 shuffled table rows of 64 blocks
            pool = [dict(kp=randn(513, 16, 8, 128), vp=randn(513, 16, 8, 128))
                    for _ in range(2)]
            tables = (torch.randperm(512, device=dev) + 1).to(torch.int32).reshape(8, 64)
            gathered = cache_lib.gather_paged_kv(pool[0], tables)
            check(torch.equal(gathered[0][3, 16 * 5:16 * 6], pool[0]["kp"][tables[3, 5]]),
                  "gather_paged_kv does not read the table's blocks")
            # K and V: each referenced block read once, each gathered row
            # written once (bf16), and the table
            gbytes = 2 * 2 * 2 * gathered[0].numel() + 4 * tables.numel()
            row["gather"] = dict(
                shape="pool (513,16,8,128) x2 bf16 -> (8,1024,8,128) x2",
                ms=cuda_ms(lambda i: cache_lib.gather_paged_kv(pool[i % 2], tables), 2),
                **bound(gbytes, 0, BF16_FLOPS))
        log("time flash_attention unified " + layout + ": " + json.dumps(row))
        out[layout] = row
    out["verify"] = verify_flash_check(dev, randn)
    return out


VERIFY_STARTS = [700, 433, 0, 911, 0, 250, 1019, 0]
VERIFY_LENGTHS = [5, 5, 0, 3, 0, 5, 5, 0]


def verify_flash_check(dev, randn):
    """K2 at the speculative verify step's shape on llama3.1-8b: q
    (8, 5, 32, 128), each row's window at its own position over the 1024
    keys gathered from the pool, three rows idle (length 0: their queries
    run at a frozen position, their outputs dropped).  Held to the plain
    version (bf16 tolerance), captured in a CUDA graph and replayed as the
    positions move (equal to the eager call), timed against its bound
    (K and V only of the keys some query of a row sees), its plain version
    and SDPA (a boolean mask from the same positions); the pool gather
    that feeds it timed per layer at this shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.models import cache as cache_lib

    q, k, v, kw = unified_flash_case(dev, randn, "paged", VERIFY_STARTS, VERIFY_LENGTHS,
                                     W=VERIFY_W)
    got, ref = fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    close(got, ref, 2e-2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fa_ops.flash_attention(q, k, v, **kw)
    moves = ([0, 1, 2, 63, 64, 511, 512, 1019], [1019, 800, 17, 0, 300, 0, 955, 64],
             VERIFY_STARTS)
    for st in moves:
        kw["q_positions"].copy_(unified_flash_case(dev, randn, "paged", st, VERIFY_LENGTHS,
                                                   W=VERIFY_W)[3]["q_positions"])
        graph.replay()
        eager = fa_ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(replayed, eager), "verify K2: replay differs from eager")
        close(replayed, fa_ref.attention(q, k, v, **kw), 2e-2)
    del graph
    log(f"check flash_attention verify window q {tuple(q.shape)} k {tuple(k.shape)} at "
        f"{VERIFY_STARTS}: max_abs_err={err:.3e} tol=2e-2; {len(moves)} graph replays equal "
        f"eager")
    n = copies(2 * (2 * q.numel() + k.numel() + v.numel()))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
    qp, kp = kw["q_positions"], kw["k_positions"]
    B, S, Hq, D = q.shape
    pairs = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= kp[:, None, :])).sum().item()
    seen = ((kp >= 0) & (kp <= qp.max(dim=1, keepdim=True).values)).sum().item()
    nbytes = 2 * 2 * q.numel() + 2 * 2 * seen * k.shape[2] * D + 4 * (qp.numel() + kp.numel())
    mask = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= kp[:, None, :]))[:, None]
    tq = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
           c.transpose(1, 2).contiguous()) for a, b, c in sets]
    row = dict(shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
               starts=VERIFY_STARTS, lengths=VERIFY_LENGTHS, max_abs_err=err,
               ms=cuda_ms(lambda i: fa_ops.flash_attention(*sets[i], **kw), n),
               plain_ms=cuda_ms(lambda i: fa_ref.attention(*sets[i], **kw), n),
               library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
                   *tq[i], attn_mask=mask, enable_gqa=True), n),
               keys_seen=seen, **bound(nbytes, 4 * D * pairs * Hq, BF16_FLOPS))
    pool = [dict(kp=randn(513, 16, 8, 128), vp=randn(513, 16, 8, 128)) for _ in range(2)]
    tables = (torch.randperm(512, device=dev) + 1).to(torch.int32).reshape(8, 64)
    gathered = cache_lib.gather_paged_kv(pool[0], tables)
    check(torch.equal(gathered[1][6, 16 * 63:], pool[0]["vp"][tables[6, 63]]),
          "gather_paged_kv does not read the table's blocks")
    row["gather"] = dict(
        shape="pool (513,16,8,128) x2 bf16 -> (8,1024,8,128) x2",
        ms=cuda_ms(lambda i: cache_lib.gather_paged_kv(pool[i % 2], tables), 2),
        **bound(2 * 2 * 2 * gathered[0].numel() + 4 * tables.numel(), 0, BF16_FLOPS))
    log("time flash_attention verify: " + json.dumps(row))
    return row


def decode_graph_check(dev, randn, B, L, Hq, Hkv, D, positions, window=0, softcap=0.0):
    """One K3 call over a (B, L) cache captured in a CUDA graph, replayed
    at each entry of ``positions`` (one q_pos for every row, or a list of
    one per row; each row's slots filled up to it), across the chunk
    boundaries of its plan: bit-identical to the eager call, and within
    bf16 tolerance of the plain version, at every position."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref

    q = randn(B, 1, Hq, D)
    kc, vc = randn(B, L, Hkv, D), randn(B, L, Hkv, D)
    qp = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    kp = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    slots = torch.arange(L, dtype=torch.int32, device=dev)[None]
    kw = dict(q_positions=qp, k_positions=kp, window=window, softcap=softcap)
    da_ops.decode_attention(q, kc, vc, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.decode_attention(q, kc, vc, **kw)
    for pos in positions:
        qp.copy_(torch.tensor(pos if isinstance(pos, list) else [pos] * B,
                              dtype=torch.int32, device=dev)[:, None])
        kp.copy_(torch.where(slots <= qp, slots, -1))
        graph.replay()
        eager = da_ops.decode_attention(q, kc, vc, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"graph replay at q_pos {pos} differs from eager")
        close(out, da_ref.decode_attention(q, kc, vc, **kw), 2e-2)
    log(f"check decode_attention in a CUDA graph over ({B},{L},{Hkv},{D}): "
        f"{len(positions)} replays at q_pos {positions} equal eager")


def paged_graph_check(dev, randn, Hq=32, Hkv=8):
    """One K4 call at the serving shape (8 rows of 64 blocks of 16
    positions, D = 128; llama3.1-8b's heads unless given) captured in a
    CUDA graph, replayed as the
    rows' q_pos advance across the chunk boundaries of its plan: identical
    to the eager call, and within bf16 tolerance of the plain version, at
    every position."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref

    B, nb, bs = 8, 64, 16
    q = randn(B, 1, Hq, 128)
    kp, vp = randn(B * nb + 1, bs, Hkv, 128), randn(B * nb + 1, bs, Hkv, 128)
    tables = (torch.randperm(B * nb, device=dev) + 1).to(torch.int32).reshape(B, nb)
    qp = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    kw = dict(block_tables=tables, q_positions=qp)
    da_ops.paged_decode_attention(q, kp, vp, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.paged_decode_attention(q, kp, vp, **kw)
    rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    positions = (0, 62, 63, 250, 255, 256, 505, 760, 1015)
    for pos in positions:
        qp.copy_(pos + rows)  # rows one position apart, straddling the boundaries
        graph.replay()
        eager = da_ops.paged_decode_attention(q, kp, vp, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"paged graph replay at q_pos {pos}.. differs from eager")
        close(out, da_ref.paged_decode_attention(q, kp, vp, **kw), 2e-2)
    log(f"check paged_decode_attention in a CUDA graph, Hq={Hq} Hkv={Hkv}: {len(positions)} "
        f"replays at rows from q_pos {positions} equal eager")


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block (to time a kernel at
    another plan than the one its wrapper picks)."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def per_forward(cfg):
    """Layers of one forward pass by the kernel they launch: attention
    layers (K2 in a prefill; in a decode step K3, or K4 for full-context
    layers over a paged pool), full-context ones among them, RG-LRU layers
    (K5), mLSTM and sLSTM layers (no kernel of their own: plain products),
    and RMSNorm launches (K1: two per attention, RG-LRU, mLSTM or sLSTM
    block, the last two being the block norm and the cell's norm over its
    width; one per ``ffn`` or parallel attention block; one final).  An
    encoder-decoder model adds a cross attention (K2 in a prefill, K3 in
    a decode step) and its ``norm_c`` (K1) to every decoder attention
    layer, and in a prefill its encoder layers (K2 and two K1 each, one
    final K1)."""
    kinds = cfg.blocks()
    attn = ("attn", "local_attn")
    norms = sum(1 if (k == "ffn" or (k in attn and cfg.parallel_block)) else 2
                for k in kinds) + 1
    n_attn = sum(k in attn for k in kinds)
    return dict(attn=n_attn, full=sum(k == "attn" for k in kinds),
                rec=sum(k == "rglru" for k in kinds),
                xlstm=sum(k in ("mlstm", "slstm") for k in kinds), norms=norms,
                cross=n_attn if cfg.is_encdec else 0, enc=cfg.num_encoder_layers)


def expected_launches(cfg, prefills, decodes, paged=False, chunks=0):
    """Launches of each kernel over ``prefills`` prefills, ``chunks`` chunk
    passes (``prefill_chunk``: K2 over the cache and the chunk, so counted
    as a prefill) and ``decodes`` decode steps; a unified step is one chunk
    pass and one decode step, a verify step one chunk pass, and a unified
    step with speculation two."""
    n = per_forward(cfg)
    full_paged = n["full"] if paged else 0
    seq = prefills + chunks
    enc_norms = 2 * n["enc"] + 1 if n["enc"] else 0
    return {"flash_attention": (n["attn"] + n["cross"] + n["enc"]) * seq,
            "decode_attention": (n["attn"] - full_paged + n["cross"]) * decodes,
            "paged_decode_attention": full_paged * decodes,
            "rmsnorm": (n["norms"] + n["cross"]) * (seq + decodes) + enc_norms * seq,
            "linear_recurrence": n["rec"] * (seq + decodes)}


class Calls:
    """Counts the model's forward passes, to hold the launch counts to."""

    def __init__(self, model):
        self.prefill = self.decode = 0
        prefill, decode = model.prefill, model.decode_step

        def counted_prefill(*a, **kw):
            self.prefill += 1
            return prefill(*a, **kw)

        def counted_decode(*a, **kw):
            self.decode += 1
            return decode(*a, **kw)

        model.prefill, model.decode_step = counted_prefill, counted_decode

    def forwards(self, lp):
        """(prefills, decode steps) the kernels ran so far: Python calls of
        ``decode_step``, less the one per capture (whose launches the
        capture takes back), plus the graph replays, which make no call."""
        runs = lp.runners.values()
        return self.prefill, (self.decode - sum(r.graph is not None for r in runs)
                              + sum(r.replays for r in runs))


def measured_launches(e, counters, calls, **measure_kw):
    """``e.measure(**measure_kw)`` with every count from 0; the launches
    checked against the forward passes it ran.  Returns (metrics,
    launches)."""
    lp = e._latency_profiler()
    (p0, d0), r0 = calls.forwards(lp), sum(r.replays for r in lp.runners.values())
    reset_counts(counters)
    m = e.measure(batch=BATCH, prompt_len=prompt_of(e.cfg), gen_len=GEN, iters=ITERS,
                  **measure_kw)
    launches = read_counts(counters)
    (p1, d1), r1 = calls.forwards(lp), sum(r.replays for r in lp.runners.values())
    want = expected_launches(e.cfg, p1 - p0, d1 - d0)
    log(f"{e.cfg.name} forward passes: {p1 - p0} prefill, {d1 - d0} decode ({r1 - r0} of "
        f"them graph replays); per forward {per_forward(e.cfg)}; launches {launches}, "
        f"expected {want}")
    check(launches == want, f"launch counts {launches} != {want}")
    check(r1 - r0 > 0, "no decode step was replayed from the graph")
    return m, launches


def prefill_flops(cfg, params, tokens):
    """Operations of one prefill's weight products over ``tokens`` tokens:
    2 per parameter per token, except that a MoE layer's experts compute
    their full capacity of rows each (the reference's (E, C, d) buffer)."""
    if not cfg.is_moe:
        return 2 * params * tokens
    from repro_torch.models.moe import capacity

    E, k = cfg.num_experts, cfg.num_experts_per_tok
    per_expert = 3 * cfg.d_model * cfg.d_ff
    layers = sum(kind in ("attn", "local_attn") for kind in cfg.blocks())
    C = capacity(tokens, E, k, cfg.moe_capacity_factor)
    return 2 * (params - layers * E * per_expert) * tokens + 2 * layers * E * C * per_expert


def main_path_phase(arch, counters, layers=0):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.energy import NvmlReader, PowerReader
    from repro_torch.core.profiler import Elana
    from repro_torch.core.size import profile_size

    full = profile_size(get_config(arch))
    log(full.fmt())
    check(f"{full.param_bytes / 1e9:.2f}" == SIZE_GB[arch],
          f"{arch} must read {SIZE_GB[arch]} GB")
    if layers:
        log(f"{arch}: measured on {layers} of its {get_config(arch).num_layers} layers")
        e = Elana(config=get_config(arch).replace(num_layers=layers), device="cuda", seed=0)
    else:
        e = Elana(arch, device="cuda", seed=0)
    size = e.size_report()
    cfg, prompt = e.cfg, prompt_of(e.cfg)
    log(e.cache_report(BATCH, prompt + GEN + 1).fmt())
    # bounds: the weights' matrix products over the prompt at the bf16 peak
    # (embedding tables only gathered, or used at one position; an
    # encoder and the cross K/V projections over the prompt // 2 frames
    # only), and per decode step one read of every weight the step uses
    # (not an untied input table, which it gathers, nor the encoder or the
    # cross K/V projections, which ran in the prefill), of the KV at
    # mid-generation and the cross memory, and of each recurrent state
    # (read once, written once)
    itemsize = getattr(torch, cfg.param_dtype).itemsize
    comp = size.by_component
    tables = sum(comp.get(k, 0) for k in ("embed", "lm_head")) // itemsize
    enc = sum(b for k, b in comp.items() if k.startswith("encoder.")) // itemsize
    cross_kv = (cfg.num_layers * 2 * cfg.d_model * cfg.num_kv_heads * cfg.resolved_head_dim
                if cfg.is_encdec else 0)
    frames = BATCH * (prompt // 2) if cfg.is_encdec else 0
    flops = (prefill_flops(cfg, size.param_count - tables - enc - cross_kv, BATCH * prompt)
             + 2 * (enc + cross_kv) * frames)
    state = e.cache_report(BATCH, prompt + GEN + 1).state_bytes
    weights = (size.param_bytes - (0 if cfg.tie_embeddings else comp["embed"])
               - (enc + cross_kv) * itemsize)
    kv = (e.cache_report(BATCH, prompt + GEN // 2).kv_bytes
          + e.cache_report(BATCH, prompt).cross_bytes)
    bounds = {"ttft_bound_ms": flops / BF16_FLOPS * 1e3,
              "tpot_bound_ms": (weights + kv + 2 * state) / HBM_BYTES_PER_S * 1e3,
              "decode_step_bytes": weights + kv + 2 * state}
    if e.cfg.is_moe:  # the function reads every expert; the estimator the active ones
        bounds["tpot_bound_active_experts_ms"] = (size.active_param_bytes
                                                  / HBM_BYTES_PER_S * 1e3)
    t0 = time.perf_counter()
    model = e.model
    torch.cuda.synchronize()
    log(f"weights drawn on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    calls = Calls(model)

    m, launches = measured_launches(e, counters, calls)
    n = per_forward(e.cfg)
    path = {"rmsnorm"}
    if n["attn"]:
        path |= {"flash_attention", "decode_attention"}
    if n["rec"]:
        path.add("linear_recurrence")
    check(all(launches[k] > 0 for k in path), "a kernel of the path never launched")
    check(all(math.isfinite(v) and v > 0 for v in m.values()), f"bad metrics {m}")
    log("measure: " + json.dumps({"arch": arch, "batch": BATCH, "prompt_len": prompt,
                                  "gen_len": GEN, "iters": ITERS, **m, **bounds}))

    class CountingReader(PowerReader):
        def __init__(self, inner):
            self.inner, self.reads = inner, 0

        def read_watts(self):
            self.reads += 1
            return self.inner.read_watts()

    nvml = NvmlReader([0])
    reader = CountingReader(nvml)
    t0 = time.perf_counter()
    try:
        me, _ = measured_launches(e, counters, calls, power_reader=reader)
    finally:
        nvml.close()
    hz = reader.reads / (time.perf_counter() - t0)
    check(all(math.isfinite(v) and v > 0 for v in me.values()), f"bad energy metrics {me}")
    log("energy: " + json.dumps({"arch": arch, **me, "sampler_hz": hz}))
    return e, launches, {**me, **m, **bounds}


def kernel_family(name):
    """A traced kernel's family: the port's own kernels by name, cuBLAS's
    matrix products, and PyTorch's other kernels (elementwise, copies,
    gathers, reductions)."""
    import re

    own = re.search(r"repro_torch::(?:\(anonymous namespace\)::)?(\w+)", name)
    if own:
        return own.group(1)
    if any(k in name for k in ("nvjet", "gemm", "gemv", "cutlass", "cublas")):
        return "cublas matmul"
    return "torch other"


def trace_split(path):
    """A traced replay's kernel events (``capture_torch_trace``'s chrome
    JSON) counted and timed by ``kernel_family``, with the eight longest
    kernels."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    check(kernels, f"the trace of a replay holds no kernel event ({len(events)} events)")
    by_name, by_family = {}, {}
    for ev in kernels:
        name, us = ev["name"], ev.get("dur", 0.0)
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + us
        fam = kernel_family(name)
        n, t = by_family.get(fam, (0, 0.0))
        by_family[fam] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"path": str(Path(path).relative_to(ROOT)), "events": len(events),
            "kernel_events": len(kernels), "kernel_us": sum(by_name.values()),
            "span_us": (max(ev["ts"] + ev.get("dur", 0.0) for ev in kernels)
                        - min(ev["ts"] for ev in kernels)),
            "graph_launches": sum("GraphLaunch" in ev.get("name", "") for ev in events),
            "by_family_count_us": dict(sorted(by_family.items(), key=lambda kv: -kv[1][1])),
            "top_us": {k: v for k, v in top}}


def measure_graph_phase(e, dev, measured):
    """The measured decode step replayed from its CUDA graph against the
    same step run eagerly, on one prompt: identical greedy tokens for GEN
    steps and equal logits at each (for an encoder-decoder model also
    shown to fail with the memory's empty rows unmasked); TPOT both ways,
    the device time of each replay (CUDA events) and the busy share; one replay traced with ``capture_torch_trace``
    (its JSON parsed, its kernel events counted); and the ``h100``
    estimate beside the measured TTFT/TPOT/TTLT and joules.  Returns the
    replay's split by kernel family."""
    import statistics

    import torch

    from repro_torch.core.latency import LatencyProfiler, random_batch
    from repro_torch.core.trace import capture_torch_trace
    from repro_torch.models.cache import reset_cache

    lp = e._latency_profiler()
    eager = LatencyProfiler(e.cfg, e.model, seed=0, device=dev, cuda_graph=False)
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = prompt_of(e.cfg)
    batch = random_batch(e.cfg, BATCH, prompt, g)

    def stream(p, unmask=False):
        """The greedy tokens (B, GEN + 1) and each decode step's logits;
        with ``unmask`` the cross memory's rows past the prompt's frames
        are read as filled, a fault of the decode's mask."""
        run = p.runner(BATCH, prompt + GEN + 1)
        reset_cache(run.cache)
        run.prefill(batch)
        for entry in run.cache if unmask else ():
            if "cross_pos" in entry:
                entry["cross_pos"].fill_(0)
        toks, logits = [run.tok.clone()], []
        for _ in range(GEN):
            logits.append(run.step().clone())
            run.advance()
            toks.append(run.tok.clone())
        return torch.cat(toks, dim=1).cpu(), torch.stack(logits)

    (tg, lg), (te, le) = stream(lp), stream(eager)
    same = int((tg == te).all(dim=0).sum())
    check(torch.equal(tg, te), f"graph and eager greedy tokens differ: {tg.tolist()} {te.tolist()}")
    # a stream can be one repeated token (recurrentgemma, xlstm, seamless at
    # random weights) that a fault of the captured step leaves as it is, so
    # the logits are held too: the replay and the eager step launch the same
    # kernels on the same inputs, so they agree to a library's algorithm
    # choice; an encoder-decoder model's memory mask read wrong in the
    # replay must move them past the tolerance
    diff = float((lg - le).abs().max())
    tol = 1e-3 * float(le.abs().max())
    check(diff <= tol, f"graph and eager decode logits differ by {diff} (tol {tol})")
    unmasked = float((stream(lp, unmask=True)[1] - le).abs().max()) if e.cfg.is_encdec else None
    check(unmasked is None or unmasked > tol,
          f"unmasking the cross memory's empty rows moved the logits by {unmasked} only "
          f"(tol {tol})")

    run = lp.runner(BATCH, prompt + GEN + 1)
    check(run.graph is not None, "the measured decode step was not captured")
    timed = TimedGraph(run.graph)
    run.graph = timed
    try:
        graph_st = lp.tpot(BATCH, prompt, gen_len=GEN)
    finally:
        run.graph = timed.graph
    eager_st = eager.tpot(BATCH, prompt, gen_len=GEN)
    replay_ms = statistics.median(timed.device_ms()[-GEN:])
    out = {"arch": e.cfg.name, "identical_tokens": f"{same}/{GEN + 1}",
           "distinct_tokens": len(set(tg[0].tolist())), "logits_max_abs_diff": diff,
           "logits_tol": tol, "unmasked_memory_logits_diff": unmasked,
           "tpot_graph_ms": graph_st.mean_ms, "tpot_graph_p50_ms": graph_st.p50_s * 1e3,
           "tpot_eager_ms": eager_st.mean_ms, "tpot_eager_p50_ms": eager_st.p50_s * 1e3,
           "replay_device_ms_p50": replay_ms,
           "replay_busy_share": replay_ms / (graph_st.p50_s * 1e3),
           "capture_and_warmup_ms": graph_st.compile_s * 1e3,
           "tpot_bound_ms": measured["tpot_bound_ms"]}
    log("measure graph vs eager: " + json.dumps(out))
    del eager
    torch.cuda.empty_cache()

    path = ROOT / "build" / f"trace_{e.cfg.name}_decode_replay.json"
    path.parent.mkdir(exist_ok=True)
    capture_torch_trace(str(path), run.step)
    split = trace_split(path)
    log("trace of one replay: " + json.dumps(split))

    est = e.estimate(hardware="h100", batch=BATCH, prompt_len=prompt, gen_len=GEN)
    row = {}
    for key, est_v in (("ttft_ms", est.ttft.latency_s * 1e3),
                       ("tpot_ms", est.tpot.latency_s * 1e3),
                       ("ttlt_ms", est.ttlt.latency_s * 1e3),
                       ("j_per_prompt", est.ttft.joules), ("j_per_token", est.tpot.joules),
                       ("j_per_request", est.ttlt.joules)):
        row[key] = {"measured": measured[key], "estimated": est_v,
                    "measured_over_estimated": measured[key] / est_v}
    log("estimate h100 vs measured: " + json.dumps({"arch": e.cfg.name, "batch": BATCH,
                                                   "prompt_len": prompt, "gen_len": GEN,
                                                   **row}))
    return split


def profile_phase(e, dev, decode_steps=8):
    """Where the time goes: device time by kernel, the number of device
    kernels (memory copies and sets aside) and the device's busy share of
    the wall clock, for one prefill and for ``decode_steps`` decode steps,
    each with its greedy pick (torch.profiler over the CUDA activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.latency import random_batch

    model = e.model
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = prompt_of(e.cfg)
    batch = random_batch(e.cfg, BATCH, prompt, g)
    cache = model.init_cache(BATCH, prompt + decode_steps + 1)
    pos = torch.full((BATCH,), prompt, dtype=torch.int32, device=dev)
    out = {}

    def prefill():
        return model.prefill(batch, cache)[0]

    def decode():
        tok = logits.argmax(-1, keepdim=True)
        for _ in range(decode_steps):
            tok = model.decode_step(tok, pos, cache)[0].argmax(-1, keepdim=True)
            pos.add_(1)

    for name, fn in (("prefill", prefill), ("decode", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if name == "prefill":
            logits = res
        by_kernel, kernels = {}, 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue  # host ops: their kernels are listed on their own
            us = evt.device_time_total
            by_kernel[evt.key[:70]] = by_kernel.get(evt.key[:70], 0.0) + us
            if not evt.key.startswith(("Memcpy", "Memset")):
                kernels += evt.count
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        steps = decode_steps if name == "decode" else 1
        out[name] = {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
                     "busy_share": busy / wall_us, "device_kernels": kernels,
                     "device_kernels_per_step": kernels / steps,
                     "top_ms": {k: v / 1e3 for k, v in top}}
        log(f"profile {name}: " + json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# phase 5: the serving path at full width
# ---------------------------------------------------------------------------

class TimedGraph:
    """Stands in for one of the engine's CUDA graphs: records device time
    around each replay (CUDA events) and the host clock at each call; the
    ``trace_at``-th replay (0-based) runs under ``capture_torch_trace``
    into ``trace_path``."""

    def __init__(self, graph, trace_at=None, trace_path=None):
        import torch

        self.graph, self.events, self.calls = graph, [], []
        self.trace_at, self.trace_path = trace_at, trace_path
        self._event = lambda: torch.cuda.Event(enable_timing=True)

    def replay(self):
        from repro_torch.core.trace import capture_torch_trace

        start, end = self._event(), self._event()
        traced = len(self.calls) == self.trace_at
        self.calls.append(time.perf_counter())
        start.record()
        if traced:
            capture_torch_trace(str(self.trace_path), self.graph.replay)
        else:
            self.graph.replay()
        end.record()
        self.events.append((start, end))

    def device_ms(self):
        return [s.elapsed_time(e) for s, e in self.events]


def serve_arrivals(cfg, n_requests, greedy_only=False, arrival_rate=0.0):
    """``n_requests``, all at t = 0 (or Poisson at ``arrival_rate`` per
    second): lognormal prompts (mean 256, 32..768), 16..63 new tokens; even
    uids greedy, odd ones at temperature 0.7, top-k 50 (or every one
    greedy)."""
    import dataclasses

    from repro_torch.serving.workload import LengthDist, WorkloadSpec, poisson_trace

    spec = WorkloadSpec(arrival_rate=arrival_rate, num_requests=n_requests,
                        prompt_len=LengthDist(kind="lognormal", mean=256.0, low=32, high=768),
                        output_len=LengthDist(kind="uniform", low=16, high=64),
                        temperature=0.7, top_k=50, seed=0)
    arrivals = poisson_trace(spec, cfg.vocab_size)
    for i, a in enumerate(arrivals):
        if greedy_only or i % 2 == 0:
            a.params = dataclasses.replace(a.params, temperature=0.0)
    return arrivals


def serve(e, arrivals, **kw):
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(e.model, **{**SERVE, **SERVE_ARCH.get(e.cfg.name, {}), **kw},
                        device="cuda")
    for a in arrivals:
        eng.submit(a.prompt, a.params)
    return eng


SERVE_KEYS = ("requests", "output_tokens", "tokens_per_sec", "ttft_ms", "ttft_p50_ms",
              "ttft_p95_ms", "ttft_p99_ms", "tpot_ms", "tpot_p50_ms", "tpot_p95_ms",
              "tpot_p99_ms", "ttlt_ms", "ttlt_p50_ms", "ttlt_p95_ms", "ttlt_p99_ms",
              "kv_bytes_peak", "kv_bytes_worst_case", "steps_per_sec",
              "dispatches_per_step_p50", "dispatches_per_step_p95", "pool_occupancy_p95",
              "joules_total", "joules_per_request", "joules_per_token",
              "power_samples_per_sec")
PREFIX_KEYS = ("prefix_lookups", "prefix_hit_rate", "prefix_blocks_reused",
               "prefill_tokens_skipped", "prefix_block_hits", "prefix_block_misses",
               "prefix_block_evictions", "prefix_blocks_resident")


def p50(xs):
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def traced_replay(e, arrivals, trace_name, at=None, **engine_kw):
    """One replay of the engine's CUDA graph (decode replay ``at``, 40 by
    default, or unified replay 8 where the engine has that step) traced by
    kernel, in a run of
    its own that serves the same trace up to that replay and is timed by
    nothing: the profiler's start, stop and export stay out of every
    serving statistic.  All arrivals are at t = 0, so that replay meets the
    same batch as in the timed run.  Returns ``trace_split`` of it."""
    import torch

    eng = serve(e, arrivals, **engine_kw)
    trace = ROOT / "build" / f"trace_{e.cfg.name}_{trace_name}_replay.json"
    trace.parent.mkdir(exist_ok=True)
    if eng.unified:
        timed = eng._unified_graph = TimedGraph(eng._unified_graph, 8, trace)
    else:
        timed = eng._graph = TimedGraph(eng._graph, 40 if at is None else at, trace)
    while len(timed.calls) <= timed.trace_at:
        check(eng.step(), f"{trace_name}: the trace drained before replay {timed.trace_at}")
    torch.cuda.synchronize()
    del eng, timed
    torch.cuda.empty_cache()
    return trace_split(trace)


ENGINE_COUNTS = ("prefills", "chunk_forwards", "decode_forwards", "prefix_hits",
                 "prefix_blocks_reused", "prefill_tokens_skipped", "preemptions",
                 "recompute_tokens", "_drafted_tokens", "_accepted_tokens", "_spec_verifies",
                 "_decode_tokens", "num_blocks")


def served(e, arrivals, counters, trace_name, trace=True, trace_at=None, setup=None,
           open_loop=False, **engine_kw):
    """Serve ``arrivals`` at full width with NVML energy, each of the
    engine's CUDA graphs timed per replay (the decode step's is the verify
    step's with speculation); the counts from 0 for this run only;
    ``setup(engine)`` first where given.  Every request is submitted at the
    start, or with ``open_loop`` at its time in the trace by
    ``OpenLoopDriver`` (each request's submit time less its scheduled time
    then in ``stats["submit_lag_s"]``).  Checks: launch counts exact
    against the forward passes run, replays credited; every request emits
    its budget; blocks drained, the free stack full and table rows back at
    block 0; dispatches per step p50 = 1 and p95 <= 2.  Then, with
    ``trace``, one replay traced by kernel in an untimed run of its own
    (``traced_replay``).  Returns (launches, stats, streams, engine
    counters)."""
    import torch

    from repro_torch.core.energy import NvmlReader, PowerMonitor
    from repro_torch.serving.workload import OpenLoopDriver

    monitor = PowerMonitor(NvmlReader([0]))
    eng = serve(e, [] if open_loop else arrivals, monitor=monitor, **engine_kw)
    driver = OpenLoopDriver(eng, arrivals)
    if setup is not None:
        setup(eng)
    check(eng._graph is not None, "the decode step was not captured")
    check(eng.unified == (eng._unified_graph is not None), "the unified step was not captured")
    step_kind = "verify" if eng.spec_k else "decode"
    timed = {step_kind: TimedGraph(eng._graph)}
    eng._graph = timed[step_kind]
    if eng.unified:
        timed["unified"] = TimedGraph(eng._unified_graph)
        eng._unified_graph = timed["unified"]
    walls = []
    step = eng.step

    def timed_step():
        before = ({k: len(t.calls) for k, t in timed.items()}, eng.prefills)
        t0 = time.perf_counter()
        out = step()
        ms = (time.perf_counter() - t0) * 1e3
        ran = [k for k, t in timed.items() if len(t.calls) > before[0][k]]
        kind = ("prefill+decode" if eng.prefills > before[1] else ran[0] if ran else "host")
        walls.append((kind, ms))
        return out

    eng.step = timed_step
    reset_counts(counters)
    try:
        with monitor:
            finished = driver.run() if open_loop else eng.run()
    finally:
        monitor.reader.close()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    summary = eng.latency_summary()

    want = expected_launches(e.cfg, eng.prefills, eng.decode_forwards, paged=True,
                             chunks=eng.chunk_forwards)
    log(f"serve {e.cfg.name} {trace_name}: {eng.prefills} admission prefills, "
        f"{eng.chunk_forwards} chunk passes, {eng.decode_forwards} decode passes "
        f"({len(timed[step_kind].calls)} {step_kind} and "
        f"{len(timed['unified'].calls) if 'unified' in timed else 0} unified replays); "
        f"launches {launches}, expected {want}")
    check(launches == want, f"serve launch counts {launches} != {want}")
    check(len(finished) == len(arrivals), f"{len(finished)} of {len(arrivals)} finished")
    budgets = {i: a.params.max_new_tokens for i, a in enumerate(arrivals)}
    check(all(len(r.output_tokens) == budgets[r.uid] for r in finished),
          "a request did not emit its budget of tokens")
    check(eng.blocks_in_use == 0, f"{eng.blocks_in_use} blocks still in use at drain")
    check(len(eng._pool.free_stack) + len(eng._pool.evictable) == eng.num_blocks - 1,
          "the pool's free stack is not full at drain")
    check(not eng._state["block_tables"].any().item(), "a table row not back at block 0")
    # a chunk on the per-chunk path (a vision model) is a dispatch of its
    # own beside the decode step, and an admission's row reset another
    per_chunk = eng.chunk > 0 and not eng.unified
    check(summary["dispatches_per_step_p50"] == 1
          and summary["dispatches_per_step_p95"] <= (3 if per_chunk else 2),
          f"dispatches/step {summary}")
    check(all(math.isfinite(v) for v in summary.values()), f"bad summary {summary}")
    check(summary["joules_per_token"] > 0, "no energy attributed")

    stats = {k: summary[k] for k in SERVE_KEYS + (PREFIX_KEYS if eng.prefix_cache else ())}
    device = {k: t.device_ms() for k, t in timed.items()}
    for kind in timed:
        step_ms = p50([ms for k, ms in walls if k == kind])
        stats[f"{kind}_replays"] = len(device[kind])
        stats[f"{kind}_replay_device_ms_p50"] = p50(device[kind])
        stats[f"{kind}_step_wall_ms_p50"] = step_ms
        stats[f"{kind}_busy_share"] = p50(device[kind]) / step_ms
    stats["steps_by_kind"] = {k: sum(1 for kk, _ in walls if kk == k)
                              for k in sorted({k for k, _ in walls})}
    stats["replay_device_share_of_steps"] = (sum(sum(d) for d in device.values())
                                             / sum(ms for _, ms in walls))
    if open_loop:
        stats["submit_lag_s"] = [r.submit_time - driver.t0 - arrivals[r.uid].time_s
                                 for r in sorted(finished, key=lambda r: r.uid)]
    streams = {r.uid: list(r.output_tokens) for r in finished}
    counts = {k: getattr(eng, k) for k in ENGINE_COUNTS}
    counts["chunk_unified"] = eng.unified
    for k in ("spec_accept_rate", "drafted_tokens", "accepted_tokens", "tokens_per_dispatch",
              "preemptions", "recompute_tokens"):
        if k in summary:
            stats[k] = summary[k]
    del eng, timed, driver
    torch.cuda.empty_cache()
    stats["trace"] = (traced_replay(e, arrivals, trace_name, at=trace_at, **engine_kw)
                      if trace else None)
    return launches, stats, streams, counts


def serve_phase(e, counters):
    """The whole-prompt engine at full width on ``serve_arrivals``;
    returns its launches, stats and streams."""
    arrivals = serve_arrivals(e.cfg, SERVE_REQUESTS[e.cfg.name])
    launches, stats, streams, _ = served(e, arrivals, counters, "serve_decode")
    log("serve: " + json.dumps({"arch": e.cfg.name, **SERVE, **SERVE_ARCH.get(e.cfg.name, {}),
                                **stats}))
    return launches, stats, streams


def chunked_serve_phase(e, counters, whole, measure_split):
    """Chunked prefill (chunk and budget 256) through the unified step,
    replayed from its CUDA graph (a vision model: through the per-chunk
    path, its patches with the first chunk).  llama3.1-8b: first with the prefix
    cache on ``shared_prefix_trace`` (24 requests at t = 0, 2 prefixes of
    448 tokens + 64, 32 new tokens, greedy; prompts of 32 blocks, 28
    shareable): prefix hits, tokens skipped = 16 x blocks reused <= 448 x
    hits, and the same run without the graphs gives identical streams.
    Both models: then ``serve_arrivals`` without the prefix cache, beside
    the whole-prompt serve phase (``whole``: launches, stats, streams) of
    the same run.  Returns each path's launches."""
    import torch

    from repro_torch.serving.workload import shared_prefix_trace

    paths = {}
    if e.cfg.name == ARCH:
        arrivals = shared_prefix_trace(e.cfg.vocab_size, num_requests=24,
                                       shared_prefix_len=SHARED_PREFIX, num_prefixes=2,
                                       suffix_len=64, max_new=32, seed=0)
        launches, stats, streams, n = served(e, arrivals, counters, "prefix_unified",
                                             prefix_cache=True, **CHUNKED)
        paths[f"{e.cfg.name} prefix serve"] = launches
        check(n["prefix_hits"] > 0, "no prefix hit")
        check(n["prefill_tokens_skipped"] == 16 * n["prefix_blocks_reused"]
              <= SHARED_PREFIX * n["prefix_hits"],
              f"prefix counters {n}: a hit reached past the shared prefix")
        eng = serve(e, arrivals, cuda_graph=False, prefix_cache=True, **CHUNKED)
        eager = {r.uid: list(r.output_tokens) for r in eng.run()}
        del eng
        torch.cuda.empty_cache()
        same = sum(streams[u] == eager[u] for u in streams)
        log("prefix serve: " + json.dumps({
            "arch": e.cfg.name, **SERVE, **CHUNKED, "prefix_cache": True,
            "shared_prefix_len": SHARED_PREFIX, "suffix_len": 64, "max_new": 32, **n, **stats,
            "graph_vs_eager_identical_streams": f"{same}/{len(streams)}"}))
        check(streams == eager, "unified graph and eager streams differ")

    arrivals = serve_arrivals(e.cfg, SERVE_REQUESTS[e.cfg.name])
    launches, stats, streams, n = served(e, arrivals, counters, "chunked_unified", **CHUNKED)
    paths[f"{e.cfg.name} chunked serve"] = launches
    w_launches, w_stats, w_streams = whole
    keys = ("ttft_ms", "ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms", "tpot_ms", "tpot_p50_ms",
            "tpot_p95_ms", "tpot_p99_ms", "ttlt_ms", "tokens_per_sec", "steps_per_sec",
            "dispatches_per_step_p50", "dispatches_per_step_p95", "joules_per_token",
            "decode_replay_device_ms_p50", "decode_busy_share")
    log("chunked vs whole-prompt serve: " + json.dumps({
        "arch": e.cfg.name, **SERVE, **SERVE_ARCH.get(e.cfg.name, {}), **CHUNKED, **n,
        "chunked": {**stats, "trace": None}, "whole": {k: w_stats[k] for k in keys},
        "identical_streams": f"{sum(streams[u] == w_streams[u] for u in streams)}"
                             f"/{len(streams)}"}))
    chunked = "unified_B8_W256" if n["chunk_unified"] else "chunked_decode_B8"
    log("serving replays by kernel family: " + json.dumps({
        "arch": e.cfg.name, "measure_decode_B1": measure_split["by_family_count_us"],
        "serve_decode_B8": w_stats["trace"]["by_family_count_us"],
        "serve_decode_B8_kernel_us": w_stats["trace"]["kernel_us"],
        chunked: stats["trace"]["by_family_count_us"],
        f"{chunked}_kernel_us": stats["trace"]["kernel_us"]}))
    for path, counts in paths.items():
        check(counts["flash_attention"] > 0, f"K2 never launched on {path}")
    return paths


def graph_phase(e):
    """The same trace, every request greedy, with the decode step replayed
    from its CUDA graph and run eagerly: the streams must be identical
    (the same kernels at the same shapes).  Returns the graph run's streams
    and latencies."""
    import torch

    arrivals = serve_arrivals(e.cfg, GRAPH_REQUESTS[e.cfg.name], greedy_only=True)
    streams, tpot = {}, {}
    for graph in (True, False):
        eng = serve(e, arrivals, cuda_graph=graph)
        streams[graph] = {r.uid: r.output_tokens for r in eng.run()}
        summary = eng.latency_summary()
        tpot[graph] = {k: summary[k] for k in ("tpot_ms", "tpot_p50_ms", "tpot_p95_ms",
                                                "ttft_ms", "tokens_per_sec", "steps_per_sec")}
        del eng
        torch.cuda.empty_cache()
    same = sum(streams[True][u] == streams[False][u] for u in streams[True])
    log("graph vs eager: " + json.dumps({"arch": e.cfg.name, "graph": tpot[True],
                                         "eager": tpot[False],
                                         "identical_streams": f"{same}/{len(streams[True])}"}))
    check(streams[True] == streams[False], "graph and eager streams differ")
    return streams[True], tpot[True]


# ---------------------------------------------------------------------------
# phase 6: kernels against plain versions on the full-width model
# ---------------------------------------------------------------------------

def parity_phase(e, dev, prompt=None, paged=True, table_scale=1.0):
    """Prefill + 4 greedy decode steps through the kernels and through the
    plain versions, both in bf16, each held against the plain versions run
    on an fp32 copy of the same weights; over a contiguous cache (B=1) and,
    with ``paged``, over a paged one (B=4, each row's blocks shuffled
    through the pool); and ``chunked``: the prompt of the last of those
    layouts through ``prefill_chunk`` in chunks of 256 (per-row starts and
    lengths, as the unified step passes them) before the same decode steps.
    The kernels pass if they add no more error than bf16 itself: the plain
    bf16 path's distance from fp32 is the floor (it rounds probabilities
    and activations to bf16, and 32 random layers amplify such
    differences), and the kernel path may be at most twice as far.  Top-1
    must match fp32 wherever fp32's top-2 margin exceeds that floor.  The
    chunked kernels' first-token logits are held to the whole prompt's
    within that same bound, and their greedy streams must agree wherever
    the whole prompt's top-2 margin exceeds it.  ``table_scale`` scales the
    embedding table for the phase (recurrentgemma-2b's tied table: random
    weights otherwise drive every logit into the softcap, where no row's
    top-2 margin clears the floor).  ``prompt`` (``prompt_of`` the model
    by default) counts a vision model's patches, which ride with the first
    chunk; an encoder-decoder model's frames (``random_batch``) go with
    every chunk."""
    import torch

    from repro_torch.core.latency import random_batch
    from repro_torch.models.cache import blocks_per_slot

    model = e.model
    prompt = prompt or prompt_of(e.cfg)
    nv = e.cfg.num_vision_tokens
    g = torch.Generator(device=dev).manual_seed(1)
    steps, bs, paged_batch = 4, 16, 4
    max_len = prompt + steps + 1
    nb = blocks_per_slot(max_len, bs)
    pool = paged_batch * nb + 9  # unnamed spare blocks besides the garbage block
    tables = (torch.randperm(pool - 1, generator=g, device=dev)[:paged_batch * nb] + 1)
    tables = tables.reshape(paged_batch, nb).to(torch.int32)
    layouts = {"contiguous": (BATCH, {})}
    if paged:
        layouts["paged"] = (paged_batch, dict(layout="paged", block_size=bs, num_blocks=pool))
    batches = {name: random_batch(e.cfg, b, prompt, g) for name, (b, _) in layouts.items()}
    whole = list(layouts)[-1]
    layouts["chunked"], batches["chunked"] = layouts[whole], batches[whole]
    chunk = CHUNKED["prefill_chunk"]

    def prefill(m, name, cache, bt):
        batch = batches[name]
        if name != "chunked":
            return m.prefill(batch, cache, block_tables=bt)[0]
        tokens = batch["tokens"]
        b, text = tokens.shape
        for i in range(0, text, chunk):
            c = min(chunk, text - i)
            kw = dict(enc_embeds=batch.get("enc_embeds"))
            if nv and i == 0:  # the patches ride with the first chunk, at 0
                kw.update(start=0, vision_embeds=batch["vision_embeds"])
            else:  # per-row starts and lengths, as the unified step passes them
                kw.update(start=torch.full((b,), nv + i, dtype=torch.int32, device=dev),
                          lengths=torch.full((b,), c, dtype=torch.int32, device=dev))
            logits, _ = m.prefill_chunk(tokens[:, i:i + c], cache, block_tables=bt, **kw)
        return logits

    def run(m, name, dtype=None, forced=None):
        b, kw = layouts[name]
        bt = tables if kw else None
        cache = m.init_cache(b, max_len, dtype, **kw)
        logits = prefill(m, name, cache, bt)
        out, toks = [logits], []
        for i in range(steps):
            tok = logits.argmax(-1, keepdim=True) if forced is None else forced[i]
            toks.append(tok)
            logits, cache = m.decode_step(tok, prompt + i, cache, block_tables=bt)
            out.append(logits)
        return torch.stack(out), toks

    saved = model.embed.table.clone() if table_scale != 1.0 else None
    if saved is not None:
        model.embed.table.mul_(table_scale)
    try:
        return _parity_checks(e, model, layouts, run, steps, prompt, whole, table_scale)
    finally:
        if saved is not None:
            model.embed.table.copy_(saved)


@contextlib.contextmanager
def moe_routes(log=None, forced=None):
    """Inside the block, each MoE routing decision's (T, k) expert ids are
    appended to ``log`` (when the block ends); with ``forced``, each call
    takes the next of those ids instead of its own top-k (its gates
    recomputed from its own probabilities at them), so two paths route
    alike: ``models.moe.routing``, which raises where forced ids are left
    over."""
    from repro_torch.models import moe as moe_lib

    calls = None if log is None else []
    with moe_lib.routing(calls, forced):
        yield
    if log is not None:
        log.extend(idx for idx, _ in calls)


def route_flips(a, b):
    """(token rows whose top-k expert sets differ between two runs' routing
    logs, rows compared)."""
    flips = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                for x, y in zip(a, b))
    return flips, sum(x.shape[0] for x in a)


def chunk_routes(log, b, prompt, chunk):
    """A whole-prompt run's routing log in the order a run of the same
    prompt in chunks of ``chunk`` routes: each chunk's rows of every
    prefill layer's (b * prompt, k) ids, chunk by chunk, then the decode
    steps' ids as they are."""
    pre = [x for x in log if x.shape[0] == b * prompt]
    return [x.reshape(b, prompt, -1)[:, i:i + chunk].reshape(-1, x.shape[-1])
            for i in range(0, prompt, chunk) for x in pre] + log[len(pre):]


def _parity_checks(e, model, layouts, run, steps, prompt, whole, table_scale):
    """The checks of ``parity_phase``.  A MoE model routes each token by a
    top-k over bf16-rounded activations, so a token whose k-th and
    (k+1)-th experts lie within bf16 noise of each other can take another
    expert on either bf16 path than in fp32; its error then measures the
    flip, not the kernels.  So for MoE the kernels and the plain bf16 path
    are also run with every routing decision forced to the fp32 run's, and
    the kernels must be within twice the plain path's distance from fp32
    with the routes forced (the unforced distances are printed, not held:
    the flips swamp them); the top-1 check holds on the forced runs, the
    floor is the forced plain distance, and the number of (layer, token)
    top-k sets that differ from fp32's is printed.  The chunked-vs-whole
    comparison of a MoE model runs at a capacity factor of E / k, where
    nothing is dropped (capacity is per call, so 256-token chunks drop
    other pairs than the 512-token prompt, a real difference of the
    function), with the chunked run's routes forced to the whole run's, so
    that a flip cannot stand in for a kernel fault."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.model import Model

    dev = model.device
    moe = e.cfg.is_moe
    logs = {}

    def logged(tag, fn, forced=None):
        if not moe:
            return fn()
        logs[tag] = []
        with moe_routes(logs[tag], forced):
            return fn()

    results = {name: logged(("kern", name), lambda n=name: run(model, n)) for name in layouts}
    forced_res = {}
    with dispatch.use_backend("torch"):  # same inputs at every step
        plain = {name: logged(("plain", name), lambda n=name: run(
            model, n, forced=results[n][1])[0]) for name in layouts}
        ref32 = Model(e.cfg.replace(dtype="float32", param_dtype="float32"), device=dev)
        with torch.no_grad():
            for p32, p in zip(ref32.parameters(), model.parameters()):
                p32.copy_(p)
        ref = {name: logged(("ref", name), lambda n=name: run(
            ref32, n, torch.float32, forced=results[n][1])[0]) for name in layouts}
        del ref32
        if moe:  # the bf16 plain path with the fp32 run's routes
            forced_res["plain"] = {name: logged(("plain forced", name), lambda n=name: run(
                model, n, forced=results[n][1])[0], forced=logs["ref", name])
                for name in layouts}
    if moe:  # and the kernels
        forced_res["kern"] = {name: logged(("kern forced", name), lambda n=name: run(
            model, n, forced=results[n][1])[0], forced=logs["ref", name]) for name in layouts}
    torch.cuda.synchronize()
    floor = {}
    for name, (b, _) in layouts.items():
        kern = results[name][0]
        check(kern.shape == (steps + 1, b, e.cfg.vocab_size), f"{name}: shape {kern.shape}")
        check(all(torch.isfinite(t).all().item() for t in (kern, plain[name], ref[name])),
              f"{name}: non-finite logits")
        err_kern = (kern - ref[name]).abs().max().item()
        err_plain = (plain[name] - ref[name]).abs().max().item()
        stats = {"max_abs_logit_fp32": ref[name].abs().max().item(), "kernels_vs_fp32": err_kern,
                 "plain_bf16_vs_fp32": err_plain,
                 "kernels_vs_plain": (kern - plain[name]).abs().max().item()}
        if moe:
            for path in ("kern", "plain"):
                flips, rows = route_flips(logs[path, name], logs["ref", name])
                stats[f"route_flips_{path}_vs_fp32"] = f"{flips}/{rows}"
            kern = forced_res["kern"][name]
            check(all(torch.isfinite(t).all().item() for t in (kern, forced_res["plain"][name])),
                  f"{name}: non-finite logits with forced routes")
            err_kern = (kern - ref[name]).abs().max().item()
            err_plain = (forced_res["plain"][name] - ref[name]).abs().max().item()
            stats.update(forced_routes_kernels_vs_fp32=err_kern,
                         forced_routes_plain_bf16_vs_fp32=err_plain)
        floor[name] = err_plain
        top2 = ref[name].topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > err_plain
        agree = kern.argmax(-1) == ref[name].argmax(-1)
        log(f"parity {e.cfg.name} {name} B={b} prompt={prompt}: " + json.dumps({
            **stats, "top1_agree": f"{int(agree.sum())}/{agree.numel()}",
            "decided_rows": int(decided.sum())}))
        check(err_kern <= 2 * err_plain,
              f"{name}: kernels {err_kern} from fp32, plain bf16 {err_plain}")
        check(bool(agree[decided].all()),
              f"{name}: top-1 differs from fp32 on a row with a clear margin")
    # the chunked prompt against the whole one, both through the kernels
    tol = 2 * floor["chunked"]
    factor = None
    if moe:
        factor = e.cfg.num_experts / e.cfg.num_experts_per_tok
        b = layouts[whole][0]
        with patched(model, "cfg", e.cfg.replace(moe_capacity_factor=factor)):
            results = {whole: logged("whole", lambda: run(model, whole))}
            forced = chunk_routes(logs["whole"], b, prompt, CHUNKED["prefill_chunk"])
            results["chunked"] = logged("chunked", lambda: run(model, "chunked"), forced=forced)
    kc, kw_ = results["chunked"][0], results[whole][0]
    first = (kc[0] - kw_[0]).abs().max().item()
    tc, tw = (torch.cat(results[n][1], dim=1) for n in ("chunked", whole))
    top2 = kw_[:steps].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).transpose(0, 1)  # (B, steps)
    same = (tc == tw).int().cumprod(dim=1).bool()   # agreed so far
    first_diff = ~same & torch.cat([torch.ones_like(same[:, :1]), same[:, :-1]], dim=1)
    log(f"parity {e.cfg.name} chunked vs whole prompt={prompt}: " + json.dumps({
        "first_token_max_abs_diff": first, "tol": tol, "table_scale": table_scale,
        "moe_capacity_factor": factor,
        "identical_greedy_streams": f"{int(same[:, -1].sum())}/{same.shape[0]}",
        "first_token_decided_rows": int((margin[:, 0] > tol).sum()),
        "diverged_at_decided_step": int((first_diff & (margin > tol)).sum())}))
    check(first <= tol, f"chunked first-token logits {first} from the whole prompt's, tol {tol}")
    check(not bool((first_diff & (margin > tol)).any()),
          "chunked and whole-prompt greedy streams differ on a step with a clear margin")
    return tol


# ---------------------------------------------------------------------------
# phase 6b: preemption with recompute and speculative decoding at full width
# ---------------------------------------------------------------------------

def suggested_blocks(arrivals):
    """``--kv-num-blocks auto`` for ``arrivals`` at the serving shape."""
    from repro_torch.models.cache import suggest_num_blocks
    from repro_torch.serving.workload import estimate_concurrency

    return suggest_num_blocks([len(a.prompt) + a.params.max_new_tokens for a in arrivals],
                              SERVE["kv_block_size"], SERVE["max_len"], SERVE["max_batch"],
                              concurrency=estimate_concurrency(arrivals, SERVE["max_batch"]))


def decision_margins(e, a, uid, stream):
    """The margin of every decision that drew request ``uid``'s ``stream``
    (arrival ``a``), recomputed eagerly through the kernels on the context
    the engine saw: the prompt left-padded to its bucket, prefilled whole
    (token 0's logits), then the stream but its last token as one chunk
    with every column's logits (tokens 1..).  A greedy request's margin is
    the top-2 gap of its logits; a sampled one's the top-2 gap of its
    masked, scaled logits plus its Gumbel noise at each draw
    (``sampling.sample_slots_keyed``), times the temperature, so both read
    in logit units.  Returns a (len(stream),) fp32 tensor."""
    import numpy as np
    import torch

    from repro_torch.serving.sampling import _mask_slot_logits, _uniforms, request_key

    model, dev, n = e.model, e.model.device, len(stream)
    nv = e.cfg.num_vision_tokens  # zero patches before the prompt, as the engine serves
    b = SERVE["prompt_bucket"]
    max_len = {**SERVE, **SERVE_ARCH.get(e.cfg.name, {})}["max_len"]
    plen = min(max_len - 1 - nv, -(-len(a.prompt) // b) * b)
    prompt = np.concatenate([np.zeros(plen - len(a.prompt), np.int64), a.prompt[-plen:]])
    cache = model.init_cache(1, nv + plen + n)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(dev)}
    if nv:
        batch["vision_embeds"] = torch.zeros((1, nv, e.cfg.d_model), device=dev)
    logits = [model.prefill(batch, cache)[0]]
    if n > 1:
        rest = torch.as_tensor(np.asarray(stream[:-1], np.int64))[None].to(dev)
        logits.append(model.prefill_chunk(rest, cache, nv + plen, all_logits=True)[0][0])
    logits = torch.cat(logits)
    p = a.params
    if p.temperature > 0:
        full = lambda v, dt: torch.full((n,), v, dtype=dt, device=dev)  # noqa: E731
        masked = _mask_slot_logits(logits, full(p.temperature, torch.float32),
                                   full(p.top_k, torch.int32), 64)
        u = _uniforms(full(request_key(SERVE["seed"], uid), torch.int64),
                      torch.arange(n, device=dev), logits.shape[-1])
        logits = (masked - torch.log(-torch.log(u))) * p.temperature
    top2 = logits.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).float().cpu()


def gate_streams(e, arrivals, base, other, tol, label, exact_before=None):
    """``other`` against ``base`` (streams by uid), both from kernels in
    bf16, whose paths may round differently: where a stream differs, its
    first differing token must be one whose decision in ``base`` had a
    margin below ``tol`` (``decision_margins``), and it must not differ
    before ``exact_before[uid]`` tokens where given.  Also reports each
    such margin's rank among the margins of all the stream's decisions (a
    flip by rounding falls among the smallest).  Returns the count of
    identical streams and, per differing stream, (token, margin, rank)."""
    check(set(base) == set(other), f"{label}: different requests finished")
    flips = {}
    for uid, want in base.items():
        got = other[uid]
        check(len(got) == len(want), f"{label}: request {uid} emitted {len(got)} tokens, "
                                     f"{len(want)} in the run it is held to")
        diff = [j for j, (x, y) in enumerate(zip(got, want)) if x != y]
        if not diff:
            continue
        j = diff[0]
        if exact_before is not None and uid in exact_before:
            check(j >= exact_before[uid], f"{label}: request {uid} differs at token {j}, "
                                          f"before its first preemption at {exact_before[uid]}")
        margins = decision_margins(e, arrivals[uid], uid, want)
        m = margins[j].item()
        flips[uid] = (j, round(m, 4), round((margins <= m).float().mean().item(), 3))
        check(m < tol, f"{label}: request {uid} differs at token {j}, where the margin {m} "
                       f"is above tol {tol}")
    ranks = sorted(r for _, _, r in flips.values())
    log(f"{label}: {len(base) - len(flips)}/{len(base)} streams identical; first differences "
        f"(uid: token, margin, rank among the stream's margins) {flips}, tol {tol}; ranks "
        f"median {ranks[len(ranks) // 2] if ranks else None}")
    return len(base) - len(flips), flips


def preemption_phase(e, counters, tol):
    """``serve_arrivals`` (24 requests, EOS off, so the schedule depends on
    lengths alone) on the pool cut to 129 blocks under
    ``preemption="recompute"``, chunked through the unified graph, then the
    same trace uncontended on the full pool.  Checks (beside ``served``'s):
    preemptions and recomputed tokens happened; each stream equals the
    uncontended run's up to the request's first preemption, and any later
    difference is one the bf16 recompute may make (``gate_streams``).
    Prints the suggested ``--kv-num-blocks auto`` size.  Returns the
    path's launches."""
    t0 = time.perf_counter()
    arrivals = serve_arrivals(e.cfg, SERVE_REQUESTS[e.cfg.name])
    first = {}

    def record_preemptions(eng):
        preempt = eng._preempt

        def recorded(slot):
            req = eng.slots[slot]
            first.setdefault(req.uid, len(req.output_tokens) + int(eng._ring_n[slot]))
            preempt(slot)

        eng._preempt = recorded

    launches, stats, streams, n = served(e, arrivals, counters, "preempt_unified",
                                         setup=record_preemptions, **CHUNKED, **PREEMPT)
    check(n["preemptions"] >= 1 and n["recompute_tokens"] > 0 and first,
          f"the cut pool never preempted: {n}")
    base_launches, base_stats, base, _ = served(e, arrivals, counters, "preempt_uncontended",
                                                trace=False, **CHUNKED)
    same, flips = gate_streams(e, arrivals, base, streams, tol, "preemption vs uncontended",
                                 exact_before=first)
    keys = ("ttft_ms", "tpot_ms", "tpot_p95_ms", "tokens_per_sec", "steps_per_sec",
            "joules_per_token", "pool_occupancy_p95", "kv_bytes_peak",
            "dispatches_per_step_p50", "dispatches_per_step_p95", "unified_replays",
            "unified_replay_device_ms_p50", "decode_replays", "decode_replay_device_ms_p50")
    log("preemption serve: " + json.dumps({
        "arch": e.cfg.name, **SERVE, **CHUNKED, **PREEMPT,
        "preemptions": n["preemptions"], "recompute_tokens": n["recompute_tokens"],
        "first_preemption_at_token": first,
        "suggested_kv_num_blocks": suggested_blocks(arrivals),
        "identical_streams": f"{same}/{len(base)}", "first_differences": flips,
        "preempted": {k: stats.get(k) for k in keys}, "trace": stats["trace"],
        "uncontended": {k: base_stats.get(k) for k in keys},
        "wall_s": time.perf_counter() - t0}))
    return {f"{e.cfg.name} preemption serve": launches,
            f"{e.cfg.name} uncontended serve": base_launches}


def speculative_phase(e, counters, tol):
    """Prompt-lookup speculation (``spec_tokens`` 4) at full width.
    ``lookup_friendly_trace`` (16 greedy requests, a motif of 8 tiled 8
    times, 64 tokens each), whole-prompt and chunked through the unified
    graph, each with and without speculation; then a drafter that always
    proposes [3, 1, 4, 1] on the sampled ``serve_arrivals`` trace, with and
    without.  Checks (beside ``served``'s): streams equal those without
    speculation, any difference gated by its margin (``gate_streams``);
    drafts were made; the adversarial run rejects drafts; every verify
    emits its accepted tokens and one more.  Prints the accept rate,
    tokens per dispatch, the verify replay's device ms and busy share, its
    split by kernel family (one traced replay, untimed), and TTFT, TPOT
    and J per token beside the run without speculation; no speed-up is
    asserted.  Returns the paths' launches."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.workload import lookup_friendly_trace

    t0 = time.perf_counter()
    paths, rows = {}, {}
    lookup = lookup_friendly_trace(e.cfg.vocab_size, seed=0, **LOOKUP)
    adversarial = serve_arrivals(e.cfg, SERVE_REQUESTS[e.cfg.name])
    runs = (("lookup whole", lookup, {}), ("lookup chunked", lookup, CHUNKED),
            ("adversarial chunked", adversarial, CHUNKED))
    for label, arrivals, kw in runs:
        name = label.replace(" ", "_")
        streams, stats = {}, {}
        for spec in (False, True):
            drafter = engine_mod.prompt_lookup_draft
            if spec and label.startswith("adversarial"):
                drafter = lambda hist, k, ngram_max=3: [3, 1, 4, 1][:k]  # noqa: E731
            with patched(engine_mod, "prompt_lookup_draft", drafter):
                launches, st, streams[spec], n = served(
                    e, arrivals, counters, f"{name}_{'spec' if spec else 'plain'}",
                    trace=spec and label == "lookup whole", trace_at=8, **kw,
                    **(SPEC if spec else {}))
            paths[f"{e.cfg.name} {label}{' spec' if spec else ''}"] = launches
            stats[spec] = st
            if spec:
                check(n["_drafted_tokens"] > 0, f"{label}: nothing was drafted")
                check(n["_decode_tokens"] == n["_spec_verifies"] + n["_accepted_tokens"],
                      f"{label}: emission balance {n}")
                check(n["decode_forwards"] == 0, f"{label}: a plain decode step ran")
                if label.startswith("adversarial"):
                    check(n["_accepted_tokens"] < n["_drafted_tokens"],
                          "the adversarial drafter's drafts were all accepted")
        same, flips = gate_streams(e, arrivals, streams[False], streams[True], tol,
                                   f"speculative vs plain, {label}")
        keys = ("ttft_ms", "ttft_p50_ms", "tpot_ms", "tpot_p50_ms", "tpot_p95_ms",
                "tokens_per_sec", "steps_per_sec", "joules_per_token", "tokens_per_dispatch",
                "dispatches_per_step_p50", "dispatches_per_step_p95", "decode_replays",
                "decode_replay_device_ms_p50", "decode_busy_share", "verify_replays",
                "verify_replay_device_ms_p50", "verify_busy_share", "unified_replays",
                "unified_replay_device_ms_p50", "unified_busy_share", "spec_accept_rate",
                "drafted_tokens", "accepted_tokens")
        rows[label] = {"identical_streams": f"{same}/{len(arrivals)}",
                       "first_differences": flips,
                       "spec": {k: stats[True][k] for k in keys if k in stats[True]},
                       "plain": {k: stats[False][k] for k in keys if k in stats[False]}}
        if stats[True]["trace"] is not None:
            rows[label]["verify_trace"] = stats[True]["trace"]
        log(f"speculative serve {label}: " + json.dumps({"arch": e.cfg.name, **SERVE, **kw,
                                                        **SPEC, **rows[label]}))
    log(f"speculative phase: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 6c: the serving front end at full width: HTTP, open loop, bench_serve
# ---------------------------------------------------------------------------

def request_stats(recs):
    """The load generator's summary of the client records ``recs`` over
    the span from the first send to the last chunk (``loadgen.summarize``:
    client TTFT/TPOT and the client-minus-engine deltas), with the engine's
    side it lacks, from the engine's stamps in the final chunks: mean TTFT
    and TPOT, tokens/s over the engine's span and J/token from the
    requests' joules (the prewarm requests the server's ``/metrics`` also
    counts left out)."""
    from repro_torch.serving.loadgen import summarize

    eng = [r.engine for r in recs]
    tokens = sum(len(r.tokens) for r in recs)
    span = max(x["engine_finish_s"] for x in eng) - min(x["engine_submit_s"] for x in eng)
    window = (min(r.send_time for r in recs), max(r.last_chunk_time for r in recs))
    return {"ttft_ms": sum(x["engine_ttft_s"] for x in eng) / len(eng) * 1e3,
            "tpot_ms": sum(x["engine_tpot_s"] for x in eng) / len(eng) * 1e3,
            "tokens_per_sec": tokens / span,
            "joules_per_token": sum(x["joules"] for x in eng) / tokens,
            **summarize(recs, window)}


TTFT_PARTS = ("send_to_queued", "queued_to_admitted", "first_token_to_hook", "hook_to_client")


def ttft_split(recs, server):
    """The client-minus-engine TTFT of ``recs`` in its parts (ms, mean and
    p95), from the client's send and first-chunk stamps and the server's
    ``front_stamps``: send -> queued (HTTP, parsing and the event loop's
    wait for the interpreter lock), queued -> admitted (the wait for the
    engine thread's current step), first token -> stream hook, hook ->
    first chunk at the client.  Checks that the parts add up to the
    delta."""
    from repro_torch.serving.loadgen import _percentile

    stamps = {s[0]: s for s in server.front_stamps}
    parts = {k: [] for k in TTFT_PARTS + ("total",)}
    for r in recs:
        submit, queued, hook = stamps[r.engine["engine_submit_s"]]
        values = (queued - r.send_time, submit - queued, hook - r.engine["engine_first_token_s"],
                  r.first_chunk_time - hook, r.client_ttft_s - r.engine_ttft_s)
        check(abs(sum(values[:-1]) - values[-1]) < 1e-6, "the TTFT parts do not add up")
        for k, v in zip(parts, values):
            parts[k].append(v * 1e3)
    return {f"{k}_ms": {"mean": sum(v) / len(v), "p95": _percentile(v, 95)}
            for k, v in parts.items()}


def http_serve_phase(e, counters, tol, direct):
    """The ``SERVE`` engine (NVML monitor, CUDA-graph decode step) prewarmed
    at the traffic's bucket and served by ``start_http_server``; the 24
    greedy requests of ``serve_arrivals`` sent at once by the port's
    ``stream_completion``, each chunk recorded as it arrives.  Checks: every
    request finishes without error with its budget; within each stream the
    chunks are contiguous and in order and each was emitted before it
    arrived; client TTFT >= engine TTFT; launch counts exact against the
    forward passes run (the counts from 0 after the prewarm); ``/metrics``
    dispatches per step p50 = 1 and p95 <= 2; the engine thread did not
    fail (closing re-raises); the streams equal ``direct`` (the same trace
    served by the engine at t = 0, ``graph_phase``) but where a decision's
    margin is below ``tol`` (``gate_streams``).  The monitor is attached
    after the prewarm, so only the traffic's tokens take its energy.
    Returns the launches."""
    import asyncio

    import torch

    from repro_torch.core.energy import NvmlReader, PowerMonitor
    from repro_torch.serving import client as client_mod
    from repro_torch.serving.client import fetch_metrics, stream_completion
    from repro_torch.serving.loadgen import prewarm_engine
    from repro_torch.serving.server import start_http_server

    t0 = time.perf_counter()
    arrivals = serve_arrivals(e.cfg, GRAPH_REQUESTS[ARCH], greedy_only=True)
    eng = serve(e, [])
    check(eng._graph is not None, "the decode step was not captured")
    prewarm_engine(eng, prompt_len=256, concurrency=SERVE["max_batch"],
                   vocab_size=e.cfg.vocab_size)
    torch.cuda.synchronize()
    monitor = PowerMonitor(NvmlReader([0]))
    eng.attach_monitor(monitor)
    before = (eng.prefills, eng.chunk_forwards, eng.decode_forwards)
    seen = []  # (arrival time, SSE data) of each stream, as stream_completion reads them
    sse_data = client_mod.sse_data

    def recording(blocks):
        events = []
        seen.append(events)

        async def gen():
            async for data in sse_data(blocks):
                events.append((time.perf_counter(), data))
                yield data
        return gen()

    async def go(url):
        recs = await asyncio.gather(*[
            stream_completion(url, a.prompt.tolist(), max_tokens=a.params.max_new_tokens,
                              timeout_s=300.0) for a in arrivals])
        return recs, await fetch_metrics(url)

    reset_counts(counters)
    try:
        with monitor, patched(client_mod, "sse_data", recording):
            with start_http_server(eng, model_name=e.cfg.name) as handle:
                recs, metrics = asyncio.run(go(handle.url))
    finally:
        monitor.reader.close()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    ran = [n - b for n, b in zip((eng.prefills, eng.chunk_forwards, eng.decode_forwards), before)]
    want = expected_launches(e.cfg, ran[0], ran[2], paged=True, chunks=ran[1])
    log(f"http serve {e.cfg.name}: {ran[0]} admission prefills, {ran[2]} decode passes; "
        f"launches {launches}, expected {want}")
    check(launches == want, f"http serve launch counts {launches} != {want}")
    errors = [r.error for r in recs if r.error]
    check(not errors, f"{len(errors)} requests failed over HTTP: {errors[:3]}")
    check(all(len(r.tokens) == a.params.max_new_tokens and r.finish_reason == "length"
              for r, a in zip(recs, arrivals)), "a request did not stream its budget")
    check(all(r.client_ttft_s >= r.engine_ttft_s > 0 for r in recs),
          "a client TTFT is below the engine's")
    by_submit = {r.engine["engine_submit_s"]: r for r in recs}
    check(len(seen) == len(recs), f"{len(seen)} event streams for {len(recs)} requests")
    for events in seen:
        objs = [(t, json.loads(d)) for t, d in events if d != "[DONE]"]
        rec = by_submit[objs[-1][1]["elana"]["engine_submit_s"]]
        index = 0
        for t, obj in objs[:-1]:
            ext = obj["elana"]
            check(ext["first_index"] == index, "a stream's chunks are not contiguous")
            check(ext["emit_s"] <= t, "a chunk arrived before it was emitted")
            index += len(ext["tokens"])
        check(index == len(rec.tokens) and events[-1][1] == "[DONE]",
              "a stream's chunks do not add up to its tokens")
    check(metrics["dispatches_per_step_p50"] == 1 and metrics["dispatches_per_step_p95"] <= 2,
          f"dispatches/step under the server {metrics}")
    check(eng.blocks_in_use == 0, f"{eng.blocks_in_use} blocks still in use at drain")
    stats = {**request_stats(recs), "ttft_split": ttft_split(recs, handle.server),
             "requests": len(recs),
             "chunks": sum(r.chunks for r in recs),
             "server_requests_received": metrics["server_requests_received"],
             "server_chunks_streamed": metrics["server_chunks_streamed"],
             "metrics_dispatches_per_step_p50": metrics["dispatches_per_step_p50"],
             "metrics_dispatches_per_step_p95": metrics["dispatches_per_step_p95"],
             "power_samples_per_sec": metrics["power_samples_per_sec"]}
    del eng
    torch.cuda.empty_cache()
    streams = {i: r.tokens for i, r in enumerate(recs)}
    same, flips = gate_streams(e, arrivals, direct[0], streams, tol, "http vs direct")
    log("http serve: " + json.dumps({
        "arch": e.cfg.name, **SERVE, "prewarm": {"prompt_len": 256,
                                                 "concurrency": SERVE["max_batch"]},
        "http": stats, "direct_t0": direct[1], "identical_streams": f"{same}/{len(recs)}",
        "first_differences": flips, "wall_s": time.perf_counter() - t0}))
    return launches


OPEN_LOOP_RATE = 8.0  # requests / s


def open_loop_phase(e, counters, tol):
    """``OpenLoopDriver`` on the ``SERVE`` engine over ``serve_arrivals``
    arriving as a Poisson process at 8 requests/s (24 greedy requests),
    then the same trace submitted at t = 0 (``served`` both, with its
    checks).  Checks: no request submitted before its time; the streams
    equal the t = 0 run's but where a decision's margin is below ``tol``.
    Returns the paths' launches."""
    t0 = time.perf_counter()
    arrivals = serve_arrivals(e.cfg, GRAPH_REQUESTS[ARCH], greedy_only=True,
                              arrival_rate=OPEN_LOOP_RATE)
    launches, stats, streams, _ = served(e, arrivals, counters, "open_loop", trace=False,
                                         open_loop=True)
    lag = stats.pop("submit_lag_s")
    check(min(lag) >= 0, f"a request was submitted {-min(lag)} s before its time")
    base_launches, base_stats, base, _ = served(e, arrivals, counters, "open_loop_t0",
                                                trace=False)
    same, flips = gate_streams(e, arrivals, base, streams, tol, "open loop vs t = 0")
    keys = ("ttft_ms", "ttft_p50_ms", "ttft_p95_ms", "tpot_ms", "tpot_p50_ms", "tpot_p95_ms",
            "ttlt_ms", "tokens_per_sec", "steps_per_sec", "joules_per_token",
            "dispatches_per_step_p50", "dispatches_per_step_p95", "decode_replays",
            "decode_replay_device_ms_p50", "decode_busy_share", "steps_by_kind")
    log("open loop serve: " + json.dumps({
        "arch": e.cfg.name, **SERVE, "arrival_rate": OPEN_LOOP_RATE,
        "trace_span_s": arrivals[-1].time_s,
        "submit_lag_ms": {"min": min(lag) * 1e3, "p50": p50(lag) * 1e3, "max": max(lag) * 1e3},
        "open_loop": {k: stats[k] for k in keys}, "t0": {k: base_stats[k] for k in keys},
        "identical_streams": f"{same}/{len(arrivals)}", "first_differences": flips,
        "wall_s": time.perf_counter() - t0}))
    return {f"{e.cfg.name} open loop": launches, f"{e.cfg.name} open loop t=0": base_launches}


BENCH_SERVE = ["--arch", ARCH, "--max-batch", "8", "--max-len", "1024", "--prompt-len", "256",
               "--max-new", "32", "--warmup-s", "3", "--duration-s", "5",
               "--power-reader", "nvml", "--check"]
BENCH_MODES = {"closed": ["--mode", "closed", "--concurrency", "8"],
               "open": ["--mode", "open", "--qps", "4"]}


def bench_serve_phase(counters):
    """The two steps of ``bench_serve.main`` in this process (so its
    launches count), ``run`` then ``report``: closed loop at concurrency 8
    and open loop at 4 requests/s, each drawing llama3.1-8b's weights anew
    and serving from a contiguous cache (K3).  Its ``--check`` gates hold;
    every request sent, warm-up and the window's tail included, finished
    without an error with its budget, and the engine finished each of them
    beside the prewarm's; the launch counts are exact against the forward
    passes its engine ran and the capture's two warm-up runs.  Prints each
    run's output and its client-minus-engine TTFT split.  Returns the
    paths' launches."""
    import io

    import torch

    from repro_torch.launch import bench_serve

    paths = {}
    for mode, flags in BENCH_MODES.items():
        t0 = time.perf_counter()
        args = bench_serve.build_parser().parse_args(BENCH_SERVE + flags)
        out = io.StringIO()
        reset_counts(counters)
        with contextlib.redirect_stdout(out):
            bench = bench_serve.run(args)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        try:
            with contextlib.redirect_stdout(out):
                bench_serve.report(bench, args)
        except SystemExit as exc:  # a failed --check
            log(out.getvalue())
            raise CheckFailed(f"bench_serve {mode}: {exc.code}") from None
        log(out.getvalue())
        result, eng = bench.result, bench.server.engine
        sent = result.all_records
        errors = [r.error for r in sent if r.error]
        check(result.summary["errors"] == 0 and not errors,
              f"bench_serve {mode}: {len(errors)} requests failed: {errors[:3]}")
        check(all(len(r.tokens) == args.max_new and r.finish_reason == "length" for r in sent),
              f"bench_serve {mode}: a request did not stream its budget")
        prewarm = max(min(args.concurrency, args.max_batch), 1)
        check(len(eng.finished) == prewarm + len(sent),
              f"bench_serve {mode}: the engine finished {len(eng.finished)} requests, "
              f"{prewarm} prewarm + {len(sent)} sent")
        # the engine was built inside the counted run, and its capture ran
        # the decode step twice before capturing it (dispatch.capture_graph)
        check(eng._graph is not None and eng._unified_graph is None,
              "bench_serve's engine has not the one captured decode step")
        want = expected_launches(eng.cfg, eng.prefills, eng.decode_forwards + 2)
        log(f"bench_serve {mode}: " + json.dumps({
            "arch": ARCH, "argv": BENCH_SERVE + flags, "prefills": eng.prefills,
            "decode_forwards": eng.decode_forwards, "requests_sent": len(sent),
            "requests_served": len(eng.finished), "launches": launches, "expected": want,
            "summary": result.summary, "ttft_split": ttft_split(result.records, bench.server),
            "wall_s": time.perf_counter() - t0}, default=float))
        check(launches == want, f"bench_serve {mode} launch counts {launches} != {want}")
        paths[f"{ARCH} bench_serve {mode}"] = launches
        del eng, bench, result, sent
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def model_phases(arch, dev, counters, paths, serve=True, parity_layers=0, layers=0,
                 **parity_kw):
    """Phases 3-6 for one more model at full width, drawn once the model
    before it is freed: measure with exact launch counts, graph against
    eager, the profile; with ``serve`` the whole-prompt serve (paged,
    CUDA-graph step), greedy streams with and without the graph and the
    chunked serve through the unified step; then the parity
    (``parity_phase(**parity_kw)``), with ``parity_layers`` on a model of
    that many layers at full width drawn once the whole one is freed.
    ``layers`` cuts the model to that many layers for every phase (its size
    report whole).  Adds each path's launches to ``paths``; frees the model
    and prints the phases' time."""
    import torch

    from repro_torch.core.profiler import Elana

    t0 = time.perf_counter()
    e, paths[f"{arch} measure"], measured = main_path_phase(arch, counters, layers)
    if e.cfg.is_encdec:
        engine_refusal_check(e)
    measure_split = measure_graph_phase(e, dev, measured)
    profile_phase(e, dev)
    if serve:
        whole = serve_phase(e, counters)
        paths[f"{arch} serve"] = whole[0]
        graph_phase(e)
        paths.update(chunked_serve_phase(e, counters, whole, measure_split))
    if parity_layers:
        cfg = e.cfg.replace(num_layers=parity_layers)
        log(f"parity {arch}: a model of {parity_layers} of its {e.cfg.num_layers} layers at "
            f"full width, drawn from seed 0 once the whole model is freed")
        del e
        gc.collect()
        torch.cuda.empty_cache()
        e = Elana(config=cfg, device="cuda", seed=0)
    tol = parity_phase(e, dev, **parity_kw)
    del e
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{arch} phases took {time.perf_counter() - t0:.1f} s")
    return tol


# ---------------------------------------------------------------------------
# phase 12: tensor-parallel serving
# ---------------------------------------------------------------------------

TP_NOTE = "gloo over one card, host-staged: not a TP latency"


def tp_parity_jobs(cfg, dev, prompt=None, paged=True):
    """``parity_phase``'s inputs as ``sharding.runs.Logits`` jobs: a prompt
    of ``prompt`` positions (``prompt_of(cfg)`` by default) over a
    contiguous cache (B = 1), a paged one (B = 4, each row's blocks
    shuffled through the pool) and the paged one in chunks of 256, then 4
    greedy decode steps; without ``paged`` (a recurrent model, whose state
    is per row), as ``parity_phase(paged=False)``: the contiguous cache,
    whole and in chunks.  A vision model's prompt is its patches, seeded
    0.1 N(0, 1) embeddings as ``random_batch`` draws them (the same on
    every rank), then tokens."""
    import numpy as np

    from repro_torch.models.cache import blocks_per_slot
    from repro_torch.sharding import runs

    rng = np.random.default_rng(1)
    steps, bs, paged_batch = 4, 16, 4
    prompt, nv = prompt or prompt_of(cfg), cfg.num_vision_tokens
    max_len = prompt + steps + 1
    nb = blocks_per_slot(max_len, bs)
    pool = paged_batch * nb + 9
    tables = (rng.permutation(pool - 1)[:paged_batch * nb] + 1).reshape(paged_batch, nb)
    tokens = {b: rng.integers(0, cfg.vocab_size, (b, prompt - nv)) for b in (BATCH, paged_batch)}
    vision = {b: (0.1 * rng.standard_normal((b, nv, cfg.d_model))).astype(np.float32)
              if nv else None for b in (BATCH, paged_batch)}
    jobs = {"contiguous": runs.Logits(tokens[BATCH], None, max_len, greedy=steps,
                                      vision=vision[BATCH])}
    if not paged:
        jobs["chunked"] = runs.Logits(tokens[BATCH], None, max_len,
                                      chunk=CHUNKED["prefill_chunk"], greedy=steps,
                                      vision=vision[BATCH])
        return jobs
    pool_kw = dict(layout="paged", block_size=bs, num_blocks=pool)
    tables = tables.astype(np.int32)
    jobs["paged"] = runs.Logits(tokens[paged_batch], None, max_len, pool_kw, tables,
                                greedy=steps, vision=vision[paged_batch])
    jobs["chunked"] = runs.Logits(tokens[paged_batch], None, max_len, pool_kw, tables,
                                  chunk=CHUNKED["prefill_chunk"], greedy=steps,
                                  vision=vision[paged_batch])
    return jobs


def tp_serve_jobs(cfg, configs, cuda_graph=False):
    """``TP_REQUESTS`` greedy requests of ``serve_arrivals``, at most
    ``TP_MAX_NEW`` new tokens each (``TP_SMALL``'s for its models), served
    at the model's serving shape, one ``sharding.runs.Serve`` job per
    named config."""
    import dataclasses

    from repro_torch.sharding import runs

    requests, max_new = TP_SMALL.get(cfg.name, (TP_REQUESTS, TP_MAX_NEW))
    arrivals = serve_arrivals(cfg, requests, greedy_only=True)
    for a in arrivals:
        a.params = dataclasses.replace(
            a.params, max_new_tokens=min(a.params.max_new_tokens, max_new))
    shape = {**SERVE, **SERVE_ARCH.get(cfg.name, {})}
    return arrivals, [runs.Serve(name, {**shape, **kw, "cuda_graph": cuda_graph},
                                 [(a.prompt, a.params) for a in arrivals])
                      for name, kw in configs.items()]


def served_margins(e, dev, job):
    """Each request's decision margins in a whole-prompt serving run of
    greedy requests, read from the logits each token was drawn from:
    ``job`` (a ``sharding.runs.Serve``, eager steps; a MoE model's routes
    forced to those it recorded) served again on the tp = 1 model with the
    model's decode step and the engine's first-token and decode-output
    hooks wrapped.  A MoE layer's capacity counts the rows a token is
    batched with, so a request replayed alone (``decision_margins``)
    would read the margins of another function.  Returns (the streams,
    {uid: (tokens,) fp32 margins})."""
    import numpy as np
    import torch

    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.engine import ServingEngine

    model, margins, last = e.model, {}, {}

    def top2(row):
        v = row.float().topk(2).values
        return float(v[0] - v[1])

    decode = model.decode_step

    def decode_step(*a, **kw):
        last["logits"], cache = decode(*a, **kw)
        return last["logits"], cache

    eng = ServingEngine(model, device=dev, **job.engine)
    start, process = eng._start_decoding, eng._process_decode_out

    def start_decoding(req, slot, plen, logits, *a, **kw):
        margins.setdefault(req.uid, []).append(top2(logits[0]))
        return start(req, slot, plen, logits, *a, **kw)

    def process_decode_out(out_np):
        for slot in np.nonzero(out_np[2])[0]:
            if eng.slots[slot] is not None:
                margins.setdefault(eng.slots[slot].uid, []).append(top2(last["logits"][slot]))
        return process(out_np)

    eng._start_decoding, eng._process_decode_out = start_decoding, process_decode_out
    model.decode_step = decode_step
    try:
        for prompt, params in job.arrivals:
            eng.submit(prompt, params)
        forced = None if job.routes is None else [torch.from_numpy(r) for r in job.routes]
        with moe_lib.routing(forced=forced):
            eng.run()
    finally:
        del model.decode_step
    streams = {r.uid: list(r.output_tokens) for r in eng.finished}
    return streams, {uid: torch.tensor(m) for uid, m in margins.items()}


def tp_reference(e, dev, parity, serves, arrivals):
    """The tp = 1 model's side, on the host: each parity job's logits (its
    greedy steps then forced on the ranks), each serving run's streams,
    ledgers and summary, and the margins of every decision of every stream
    (``decision_margins``), so the model can be freed before the ranks
    start.  A MoE model's routing is recorded and forced on the ranks'
    parity and serving jobs (bf16 flips top-k sets, and a flip is not a
    fault of the sharding), and its margins are read from the serving run
    itself (``served_margins``: capacity makes a token's logits depend on
    the rows beside it); one more parity job, the contiguous one with its
    own routing, records the ranks' routes for the flip count.
    Returns (ref, tp1_runs, margins, serves, flips), ``serves`` the jobs
    for the ranks and ``flips`` None or (that job, tp = 1's routes)."""
    import dataclasses

    import numpy as np
    import torch

    moe = e.cfg.is_moe
    ref, routes = {}, {}
    for name, job in parity.items():
        out = dataclasses.replace(job, record=moe).run(e.model, None, dev)
        logits = out["logits"] if moe else out
        ref[name] = logits
        routes[name] = out["ids"] if moe else None
        parity[name] = dataclasses.replace(job, steps=logits[:-1].argmax(-1), greedy=0,
                                           routes=routes[name])
    tp1_runs = {job.name: dataclasses.replace(job, record=moe).run(e.model, None, dev)
                for job in serves}
    margins = {}
    flips = None
    if moe:  # the margins of the batched run itself, its routes forced
        serves = [dataclasses.replace(job, routes=tp1_runs[job.name]["routes"]["ids"])
                  for job in serves]
        for job in serves:
            streams, by_uid = served_margins(e, dev, job)
            check(streams == tp1_runs[job.name]["streams"],
                  f"{e.cfg.name} {job.name}: the replay with its own routes forced gave "
                  f"other streams")
            check(all(len(by_uid[uid]) == len(s) for uid, s in streams.items()),
                  f"{e.cfg.name} {job.name}: a margin for every token")
            margins.update({(uid, tuple(s)): by_uid[uid] for uid, s in streams.items()})
        flips = (dataclasses.replace(parity["contiguous"], routes=None, record=True),
                 routes["contiguous"])
    for out in tp1_runs.values():
        for uid, stream in out["streams"].items():
            key = (uid, tuple(stream))
            if key not in margins:
                margins[key] = decision_margins(e, arrivals[uid], uid, stream)
    torch.cuda.synchronize()
    check(all(np.isfinite(v).all() for v in ref.values()), "tp=1 logits not finite")
    return ref, tp1_runs, margins, serves, flips


def tp_kv_per_device(cfg, tp, engine, base):
    """Each rank's KV bytes as the reference's layout holds them
    (``sharding.rules.cache_dim``, the reference's ``cache_shardings``, to
    which the CPU tests hold it), in the ledger's scope, from the full
    cache of the serving shape ``engine`` on meta: paged, the pool's share
    of tp = 1's aggregate ``base`` (its heads, or the whole pool on every
    rank: "replication is real memory"); contiguous, every ``k``/``v``
    leaf, each cut to its KV heads or its L slots where tp divides them."""
    import torch

    from repro_torch.models.cache import init_cache
    from repro_torch.sharding.rules import cache_dim

    layout = engine["cache_layout"]
    full = init_cache(cfg, engine["max_batch"], engine["max_len"], getattr(torch, cfg.dtype),
                      "meta",
                      layout=layout, block_size=engine["kv_block_size"],
                      num_blocks=engine.get("kv_num_blocks", 0))
    leaves = ("kp", "vp") if layout == "paged" else ("k", "v")
    cut = [(t, cache_dim(leaf, t.shape, tp)) for entry in full for leaf, t in entry.items()
           if leaf in leaves]
    if layout == "paged":
        return [base // tp if cut and cut[0][1] is not None else base] * tp
    return [sum(t.numel() * t.element_size() // (1 if dim is None else tp) for t, dim in cut)] * tp


def tp_kernels(cfg):
    """The kernels every rank of a tp run of ``cfg`` launches: K1; K2 and
    K3 with attention layers (a local one decodes over its ring through
    K3); K4 with full-context ones (the serving runs are paged); K5 with
    RG-LRU layers."""
    kinds = set(cfg.blocks())
    want = ["rmsnorm"]
    if kinds & {"attn", "local_attn"}:
        want += ["flash_attention", "decode_attention"]
    if "attn" in kinds:
        want.append("paged_decode_attention")
    if "rglru" in kinds:
        want.append("linear_recurrence")
    return want


def tp_compare(arch, tp, ranks, ref, tp1_runs, margins, tol, label, cfg, engines):
    """The ranks' results (each rank's list of job results after the first
    ``Launches``) against tp = 1's: each rank's parity logits bit for bit
    rank 0's and within ``tol`` of tp = 1's; each rank's streams exactly
    rank 0's, and rank 0's held to tp = 1's by the margin rule of
    ``gate_streams`` (a first difference only where tp = 1's decision had a
    margin below ``tol``); the per-device KV bytes those of the reference's
    layout (``tp_kv_per_device``, each serving job's engine by name in
    ``engines``), and every rank's pool partition tiling its blocks."""
    import numpy as np

    n_par = len(ref)
    lead = ranks[0]
    forced = any("routes" in base for base in tp1_runs.values())  # a MoE model's
    for i, name in enumerate(ref):
        want = ref[name]
        got = lead[i]
        check(got.shape == want.shape, f"{label} {name}: logits {got.shape}, tp=1 {want.shape}")
        for r in range(1, tp):
            check(np.array_equal(ranks[r][i], got),
                  f"{label} {name}: rank {r}'s logits differ from rank 0's")
        diff = float(np.abs(got - want).max())
        agree = got.argmax(-1) == want.argmax(-1)
        top2 = np.sort(want, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > tol
        log(f"{label} parity {name}: " + json.dumps({
            "max_abs_diff_vs_tp1": diff, "tol": tol, "max_abs_logit": float(np.abs(want).max()),
            "top1_agree": f"{int(agree.sum())}/{agree.size}", "decided_rows": int(decided.sum()),
            "tp1_routes_forced": forced}))
        check(diff <= tol, f"{label} {name}: logits {diff} from tp=1's, tol {tol}")
        check(bool(agree[decided].all()), f"{label} {name}: top-1 differs from tp=1's on a "
                                          f"row with a clear margin")
    for j, (name, base) in enumerate(tp1_runs.items()):
        out = lead[n_par + j]
        for r in range(1, tp):
            other = ranks[r][n_par + j]
            check(other["streams"] == out["streams"], f"{label} {name}: rank {r}'s streams "
                                                      f"differ from rank 0's")
            view = other["pool_accounting"]
            check(view["free"] + view["in_use"] + view["evictable"] == view["allocatable"],
                  f"{label} {name}: rank {r}'s pool does not tile its blocks")
        check(set(out["streams"]) == set(base["streams"]), f"{label} {name}: other requests")
        flips = {}
        for uid, want in base["streams"].items():
            got = out["streams"][uid]
            check(len(got) == len(want), f"{label} {name}: request {uid} length")
            diff = [k for k, (x, y) in enumerate(zip(got, want)) if x != y]
            if diff:
                m = margins[(uid, tuple(want))][diff[0]].item()
                flips[uid] = (diff[0], round(m, 4))
                check(m < tol, f"{label} {name}: request {uid} differs at token {diff[0]}, "
                               f"margin {m} above tol {tol}")
        s = out["summary"]
        per = s["kv_bytes_peak_per_device"]
        want_per = tp_kv_per_device(cfg, tp, engines[name], base["kv_bytes_peak"])
        check(s["tp_devices"] == tp and per == want_per,
              f"{label} {name}: per-device KV {per}, the reference's layout {want_per} "
              f"(tp=1's {base['kv_bytes_peak']})")
        for view in out["pool_accounting_by_device"]:
            check(view["free"] + view["in_use"] + view["evictable"] == view["allocatable"]
                  and view["in_use"] == 0, f"{label} {name}: pool accounting {view}")
        step_ms = 1e3 / s["steps_per_sec"]
        log(f"{label} serve {name}: " + json.dumps({
            "identical_streams": f"{len(base['streams']) - len(flips)}/{len(base['streams'])}",
            "first_differences (uid: token, margin)": flips, "tol": tol,
            "tp1_routes_forced": forced,
            "kv_bytes_peak_per_device": per, "kv_bytes_peak_tp1": base["kv_bytes_peak"],
            "kv_bytes_per_device_reference_layout": want_per,
            "dispatches_per_step_p95": s["dispatches_per_step_p95"],
            "step_ms": step_ms, "tp_broadcast_us_p50": s["tp_broadcast_us_p50"],
            "tp_broadcast_us_p95": s["tp_broadcast_us_p95"], "wall_s": out["wall_s"],
            "tp1_eager_step_ms": 1e3 / base["summary"]["steps_per_sec"],
            "timing": TP_NOTE}))


def tp_route_flips(label, tp, ranks, flips, want_logits):
    """Every rank's own routing of the contiguous parity job (no routes
    forced) equal to rank 0's, and the token rows whose top-k expert set
    differs from tp = 1's printed with the rows compared, as information
    (bf16 flips such sets; the checks force tp = 1's)."""
    import numpy as np

    lead = ranks[0][-1]
    for r in range(1, tp):
        other = ranks[r][-1]
        check(len(other["ids"]) == len(lead["ids"])
              and all(np.array_equal(a, b) for a, b in zip(other["ids"], lead["ids"])),
              f"{label}: rank {r} routed a MoE call otherwise than rank 0")
    want = flips[1]
    check(len(want) == len(lead["ids"]), f"{label}: {len(lead['ids'])} MoE calls, tp=1 "
                                          f"{len(want)}")
    n = sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
            for a, b in zip(lead["ids"], want))
    rows = sum(a.shape[0] for a in want)
    log(f"{label} route flips vs tp=1, contiguous parity job, routes not forced: "
        + json.dumps({"rows_with_another_topk_set": n, "rows_compared": rows,
                      "moe_calls": len(want), "unforced_logits_max_abs_diff_vs_tp1":
                      float(np.abs(lead["logits"] - want_logits).max())}))


def tp_run(tp, dev, paths, cases, backend):
    """One spawn of ``tp`` ranks of ``backend`` (gloo: sharing this card;
    None: NCCL, one card each) for every case (``tp_phase``): each rank
    draws its shard of a case's seed-0 weights in turn, runs its parity
    and serving jobs (and a MoE model's flip job) between two launch
    reads, frees it, then the next case's; each case is held to tp = 1's.
    Every rank must launch K1-K4 on every case."""
    from repro_torch.launch.mesh import spawn_tp
    from repro_torch.sharding import runs

    plan = []
    for c in cases:
        extra = [c["flips"][0]] if c["flips"] else []
        plan.append((runs.Weights(c["cfg"], seed=0, table_scale=c["table_scale"]),
                     [runs.Launches(), *c["parity"].values(), *c["serves"], *extra,
                      runs.Launches()]))
    t0 = time.perf_counter()
    # one intra-op thread a rank: the ranks share the host's cores
    ranks = spawn_tp(runs.run_plan, tp, "cuda", plan, backend=backend, threads=1)
    wall = time.perf_counter() - t0
    for i, c in enumerate(cases):
        arch = c["arch"]
        label = f"tp {arch} tp={tp} {backend or 'nccl'}"
        mine = [ranks[r][i] for r in range(tp)]
        check(all(isinstance(m, list) for m in mine), f"{label}: a rank could not build: {mine}")
        want = tp_kernels(c["cfg"])
        for r in range(tp):
            paths[f"{arch} tp={tp} {backend or 'nccl'} rank {r}"] = mine[r][-1]
            check(all(mine[r][-1][k] > 0 for k in want),
                  f"{label}: rank {r} did not launch {want}: {mine[r][-1]}")
        results = [m[1:-1] for m in mine]
        tp_compare(arch, tp, results, c["ref"], c["tp1_runs"], c["margins"], c["tol"], label,
                   c["cfg"], {job.name: job.engine for job in c["serves"]})
        if c["flips"]:
            tp_route_flips(label, tp, results, c["flips"], c["ref"]["contiguous"])
    log(f"tp={tp} {backend or 'nccl'} ranks ran {', '.join(c['arch'] for c in cases)}: "
        f"{wall:.1f} s ({TP_NOTE if backend == 'gloo' else 'NCCL'})")


def tp_phase(dev, paths, tols):
    """Tensor-parallel serving on this card (``TP_RUNS``): llama3.1-8b on
    ``TP_LLAMA_LAYERS`` layers, moonshot-v1-16b-a3b and llava-next-34b over
    2 gloo ranks, command-r-plus-104b, qwen3-moe-30b-a3b and qwen2.5-1.5b
    over 4, recurrentgemma-2b and xlstm-1.3b over 2 and over 4, every
    model at full width, every rank sharing this card, its collectives
    staged through the host, its steps eager.  Each model is held to its
    tp = 1 model, run here first and once for both tp (parity logits
    within the bf16 tolerance of its ``parity_phase`` — ``tols[arch]``
    where the model's own parity phase gave it at this depth, else run
    here with ``TP_PARITY``'s prompt and table — streams by the margin
    rule, ledgers against the reference's layout; a MoE model with tp =
    1's routes forced, its unforced flips printed).  Each run serves the
    jobs ``TP_RUNS`` names for it (tp = 1 serves every tp's once); the
    recurrent models serve at one tp.  With 2 or more GPUs llama3.1-8b
    also runs over 2 NCCL ranks with captured steps.  The times printed
    check correctness: they are not TP latencies."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.profiler import Elana

    t_all = time.perf_counter()
    cases, refs = [], {}
    for arch, tp, layers, configs in TP_RUNS:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full.replace(num_layers=layers) if layers else full
        log(f"tp {arch} tp={tp}: full width on {cfg.num_layers} of its {full.num_layers} "
            f"layers")
        if (arch, layers) not in refs:
            kw = TP_PARITY.get(arch, {})
            scale = kw.get("table_scale", 1.0)
            parity = tp_parity_jobs(cfg, dev, kw.get("prompt"), kw.get("paged", True))
            every = {name: engine for a, _, n, named in TP_RUNS if (a, n) == (arch, layers)
                     for name, engine in named.items()}  # every tp's, once
            arrivals, serves = tp_serve_jobs(cfg, every)
            e = Elana(config=cfg, device="cuda", seed=0)
            tol = tols.get(arch)
            if tol is None:  # the kernels held to plain and fp32 at this depth
                tol = parity_phase(e, dev, **kw)
            with torch.no_grad():
                e.model.embed.table.mul_(scale)  # as the ranks' (``runs.Weights``)
            refs[arch, layers] = dict(
                tol=tol, parity=parity, table_scale=scale, configs=every,
                **dict(zip(("ref", "tp1_runs", "margins", "serves", "flips"),
                           tp_reference(e, dev, parity, serves, arrivals))))
            del e
            gc.collect()
            torch.cuda.empty_cache()
            log(f"tp {arch}: tp=1 reference (eager) took {time.perf_counter() - t0:.1f} s")
        ref = dict(refs[arch, layers])
        ref["serves"] = [job for job in ref["serves"] if job.name in configs]
        ref["tp1_runs"] = {name: out for name, out in ref["tp1_runs"].items() if name in configs}
        cases.append(dict(arch=arch, tp=tp, cfg=cfg, **ref))
    # the two spawns overlap, each waited on from a thread of its own: their
    # ranks share the card and the host's cores (one intra-op thread each)
    tps = sorted({c["tp"] for c in cases})
    with ThreadPoolExecutor(len(tps)) as pool:
        runs = [pool.submit(tp_run, tp, dev, paths, [c for c in cases if c["tp"] == tp], "gloo")
                for tp in tps]
        for run in runs:
            run.result()
    if torch.cuda.device_count() >= 2:
        c = dict(next(c for c in cases if c["arch"] == ARCH))
        _, c["serves"] = tp_serve_jobs(c["cfg"], c["configs"], cuda_graph=True)
        tp_run(2, dev, paths, [c], None)
    else:
        log(f"tp {ARCH} nccl: not run: {torch.cuda.device_count()} GPU visible, and NCCL "
            f"takes one GPU per rank; the captured NCCL steps stay unverified here")
    log(f"tp phases took {time.perf_counter() - t_all:.1f} s")


def engine_refusal_check(e):
    """The serving engine refuses an encoder-decoder model, which the
    reference's engine cannot serve."""
    from repro_torch.serving.engine import ServingEngine

    try:
        ServingEngine(e.model, **SERVE, device="cuda")
    except ValueError as exc:
        check("cannot serve" in str(exc), f"the engine refused {e.cfg.name} for another reason")
        log(f"serve {e.cfg.name}: refused: {exc}")
        return
    raise CheckFailed(f"the serving engine took the encoder-decoder {e.cfg.name}")


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

def train_launches(cfg, forwards, recomputed=0):
    """Launches of every kernel over ``forwards`` training forwards,
    ``recomputed`` of them under remat, whose backward runs each group's
    forward again (the decoder's grouped layers and every encoder layer;
    not the remainder layers or the final norms): K1 per norm (an
    attention block's two, one more for an enc-dec block's ``norm_c``, one
    for an ``ffn`` or parallel block, an RG-LRU block's two, an xLSTM
    block's norm and its cell's, each final norm), K2 per self- and cross
    attention layer, K5 per RG-LRU layer; an encoder layer two K1 and one
    K2; no decode kernel."""
    attn = ("attn", "local_attn")
    cross = 1 if cfg.is_encdec else 0

    def count(kinds, enc):
        return {"rmsnorm": sum((1 if cfg.parallel_block else 2) + cross if k in attn
                               else 1 if k == "ffn" else 2 for k in kinds) + 2 * enc,
                "flash_attention": sum(1 + cross for k in kinds if k in attn) + enc,
                "linear_recurrence": sum(k == "rglru" for k in kinds)}

    kinds, enc = cfg.blocks(), cfg.num_encoder_layers
    plen, (groups, _) = len(cfg.block_pattern), cfg.layer_groups()
    once, again = count(kinds, enc), count(kinds[:groups * plen], enc)
    once["rmsnorm"] += 1 + (1 if enc else 0)
    want = {"decode_attention": 0, "paged_decode_attention": 0}
    want.update({k: once[k] * forwards + again[k] * recomputed for k in once})
    return want


def train_bound_ms(cfg, model, batch, seq):
    """The least time of one train step: its products (``train_flops``) at
    989 TFLOP/s and AdamW's bytes at 3.35 TB/s (a parameter and its
    gradient read, the parameter written, two fp32 moments read and
    written)."""
    adam = sum(p.numel() * (3 * p.element_size() + 16) for p in model.parameters())
    return (train_flops(cfg, model, batch, seq) / BF16_FLOPS + adam / HBM_BYTES_PER_S) * 1e3


def train_flops(cfg, model, batch, seq):
    """The operations one train step's products need.  A product
    costs 6 FLOPs per weight per row it takes, forward and backward: the
    decoder's rows are its positions, a vision config's patches included
    (its logits too); an encoder's and a cross attention's K/V
    projections' rows are the frames (``seq // 2`` a row, as
    ``batch_for_model`` draws them); a MoE layer's experts each take their
    capacity's C rows, the router and shared experts every position; an
    untied input table is gathered, not multiplied.  Attention: 4 D FLOPs
    per visible pair and head forward, twice that backward: causal or
    windowed in the decoder, every pair in the encoder (frames x frames)
    and in cross attention (positions x frames).  The mLSTM's chunk scan:
    per chunk of L positions and head of D, the three (L, L) products and
    the two (D, D) ones, 6 L D + 4 D^2 FLOPs per position forward, three
    times that in all."""
    from repro_torch.models import moe as moe_lib

    rows = batch * (cfg.num_vision_tokens + seq)
    frames = batch * max(seq // 2, 1)
    cap = (moe_lib.capacity(rows, cfg.num_experts, cfg.num_experts_per_tok,
                            cfg.moe_capacity_factor) if cfg.is_moe else 0)
    flops = 0
    for name, p in model.named_parameters():
        if name == "embed.table" and not cfg.tie_embeddings:
            continue
        n = rows
        if name.startswith("encoder.") or ".cross.wk" in name or ".cross.wv" in name:
            n = frames
        elif (cfg.is_moe and name.rsplit(".", 1)[-1] in ("wg", "wu", "wd")
              and ".shared." not in name):
            n = cap  # each expert's weights over its C rows: numel / E * E * C
        flops += 6 * p.numel() * n
    L = cfg.num_vision_tokens + seq
    pairs = 0
    for kind in cfg.blocks():
        if kind in ("attn", "local_attn"):
            w = cfg.sliding_window if kind == "local_attn" and cfg.sliding_window else L
            pairs += sum(min(i + 1, w) for i in range(L)) * batch
            if cfg.is_encdec:
                pairs += L * (frames // batch) * batch
    pairs += cfg.num_encoder_layers * (frames // batch) ** 2 * batch
    flops += 12 * cfg.resolved_head_dim * cfg.num_heads * pairs
    n_mlstm = sum(k == "mlstm" for k in cfg.blocks())
    if n_mlstm:
        H = cfg.resolved_rec_heads
        D = int(cfg.d_model * cfg.mlstm_proj_factor) // H
        chunk = min(cfg.recurrent_chunk, L)
        flops += 3 * n_mlstm * rows * H * (6 * chunk * D + 4 * D * D)
    return flops


def train_stats(arch, label, out, rec, tokens, bound_ms, peak_gib):
    """Step ms (the median past the first step, which builds and tunes),
    tokens/s, NVML J/step and J/token (the whole run, and the steps past
    the first), the share of the step's bound."""
    import statistics

    ms = statistics.median(rec.seconds[1:]) * 1e3
    row = dict(arch=arch, run=label, card=", ".join(card()), steps=len(rec.losses),
               step_ms=ms, first_step_ms=rec.seconds[0] * 1e3, tokens_per_s=tokens / ms * 1e3,
               bound_ms=bound_ms, bound_share=bound_ms / ms, peak_memory_gib=peak_gib,
               loss_first=rec.losses[0], loss_last=rec.losses[-1])
    if rec.monitor is not None:
        steady = rec.monitor.joules_between(rec.ends[0], rec.ends[-1]) / (len(rec.ends) - 1)
        row.update(j_per_step=out["j_per_step"], j_per_token=out["j_per_step"] / tokens,
                   steady_j_per_step=steady, steady_j_per_token=steady / tokens,
                   avg_watts=out["avg_watts"])
    log(f"train {arch} {label}: " + json.dumps(row))
    return row


def train_parity(arch, dev, batch, seq, layers=0):
    """One step's gradients of ``arch`` (cut to ``layers`` at full width
    where given) through the kernels and through the plain versions
    (``use_backend("torch")``), both in bf16, each against the plain
    versions on an fp32 copy of the same weights on the same batch (with
    the patch or frame embeddings the config needs): for each parameter
    ||g - g32|| / ||g32||.  The kernels' worst may be at most twice the
    plain bf16 path's worst (the rule of ``parity_phase``: bf16 itself is
    the floor).  A MoE model's bf16 paths take the fp32 run's routes
    (``moe_routes``), as in ``parity_phase``: bf16 flips 7-16 % of the
    top-k sets, and a flipped token measures the flip, not the kernels."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset, batch_for_model
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as model_lib
    from repro_torch.training import step as step_lib

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                            batch_size=batch, seed=1)).batch_at(0)
    data = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_model(
        cfg, data, np.random.default_rng(1)).items()}
    loss_fn = step_lib.make_loss_fn(cfg, remat=False)
    routes = [] if cfg.is_moe else None

    def grads(m, log=None, forced=None):
        named = dict(m.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        with moe_routes(log, forced) if cfg.is_moe else contextlib.nullcontext():
            loss, _ = loss_fn(m, data)
            return loss.item(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    model = model_lib.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    with dispatch.use_backend("torch"):
        ref32 = model_lib.Model(cfg.replace(dtype="float32", param_dtype="float32"), device=dev)
        with torch.no_grad():
            for (_, a), (_, b) in zip(ref32.named_parameters(), model.named_parameters()):
                a.copy_(b.float())
        ref = grads(ref32, log=routes)
        del ref32
        plain = grads(model, forced=routes)
    kern = grads(model, forced=routes)
    del model

    # an sLSTM cell's input-gate bias from a fresh state has a gradient of
    # zero in exact arithmetic (a shift of a unit's log_i at every step
    # shifts its stabilizer, which starts at -1e30, by as much): each path
    # gives rounding noise there, whose ratio to fp32's noise measures
    # nothing, so those leaves are printed beside the rest, not held
    zero = {f"layers.{i}.cell.b_i" for i, k in enumerate(cfg.blocks()) if k == "slstm"}

    def rel(g):
        return {k: ((g[k].float() - g32).norm() / g32.norm().clamp_min(1e-30)).item()
                for k, g32 in ref[1].items()}

    rk, rp = rel(kern[1]), rel(plain[1])
    held_k = {k: v for k, v in rk.items() if k not in zero}
    held_p = {k: v for k, v in rp.items() if k not in zero}
    worst_k = max((v, k) for k, v in held_k.items())
    worst_p = max((v, k) for k, v in held_p.items())
    top = max(g.norm().item() for g in ref[1].values())
    row = dict(arch=arch, layers=cfg.num_layers, batch=batch, seq=seq, loss_kernels=kern[0],
               loss_plain=plain[0], loss_fp32=ref[0], worst_kernels=worst_k,
               worst_plain=worst_p, median_kernels=sorted(held_k.values())[len(held_k) // 2],
               median_plain=sorted(held_p.values())[len(held_p) // 2],
               routes_forced_to_fp32=cfg.is_moe,
               zero_gradient_leaves={k: dict(kernels=rk[k], plain=rp[k],
                                             fp32_norm=ref[1][k].norm().item(),
                                             largest_fp32_norm=top) for k in sorted(zero)})
    log("train gradient parity: " + json.dumps(row))
    check(worst_k[0] <= 2 * worst_p[0],
          f"{arch}: the kernels' gradients are {worst_k} from fp32, more than twice the "
          f"plain bf16 path's {worst_p}")
    return row


def train_breakdown(dev):
    """Where a tinyllama-1.1b train step's time goes: after two warm
    steps, CUDA events around its forward (with the loss), its backward,
    and clipping with the AdamW update; then one step traced with
    ``capture_torch_trace`` and split by kernel family."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.trace import capture_torch_trace
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import step as step_lib

    cfg = get_config(TRAIN_ARCH)
    opt = opt_lib.AdamW(schedule=opt_lib.constant_schedule(1e-4))
    state = step_lib.init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                            batch_size=8)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    loss_fn = step_lib.make_loss_fn(cfg, remat=False)
    params = state.params()
    ndims = opt_lib.reference_ndims(cfg, params)

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = loss_fn(state.model, batch)
        ev[1].record()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        ev[2].record()
        grads, _ = opt_lib.clip_by_global_norm(grads, 1.0)
        opt.update(grads, state.opt, params, ndims)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    step()
    step()
    fwd, bwd, upd = step()
    path = ROOT / "build" / f"trace_{TRAIN_ARCH}_train_step.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    capture_torch_trace(str(path), step)
    row = dict(forward_ms=fwd, backward_ms=bwd, clip_adamw_ms=upd, trace=trace_split(path))
    log(f"train step breakdown {TRAIN_ARCH} 8 x 1024: " + json.dumps(row))
    return row


def train_run(dev, counters, paths, arch, label, argv, forwards, recomputed=0, layers=0):
    """``launch.train.run`` on ``argv``, its launches held to
    ``train_launches`` and read into ``paths``; ``layers``: the config cut
    to that many layers at full width (the driver has no depth flag).
    Returns (the printed keys, the run's record with its state freed, the
    peak GiB, the step's bound in ms)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_lib

    args = train_lib.build_argparser().parse_args(["--arch", arch] + argv)
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(counters)
    out, rec = train_lib.run(args, cfg=cfg)
    launched = read_counts(counters)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    want = train_launches(cfg, forwards, recomputed)
    log(f"{arch} {label} ({cfg.num_layers} layers): {json.dumps(out)}; launches {launched}, "
        f"expected {want}; losses {rec.losses}")
    check(launched == want, f"{arch} {label}: launch counts {launched} != {want}")
    check(all(math.isfinite(x) for x in rec.losses), f"{arch} {label}: a loss is not finite")
    paths[f"{arch} {label}"] = launched
    bound = train_bound_ms(cfg, rec.state.model, args.batch, args.seq_len)
    rec.state = None  # free the model and the moments
    return out, rec, peak, bound


def family_train_phase(dev, counters, paths):
    """One model of each other family at full width through
    ``launch.train`` (``FAMILY_TRAIN``: the depth cut through the config,
    ``train_run``), ``FAMILY_TRAIN_STEPS`` steps with NVML energy: finite
    losses that fall, exact launches; seamless-m4t-large-v2 also 2 steps
    with ``--remat`` (the encoder's layers recomputed); then each model's
    gradient parity (``FAMILY_PARITY``)."""
    import torch

    from repro_torch.configs import get_config

    rows = []
    for arch, (layers, b, seq, lr) in FAMILY_TRAIN.items():
        t = time.perf_counter()
        shape = ["--batch", str(b), "--seq-len", str(seq), "--lr", lr] + FAMILY_ARGS
        out, rec, peak, bound = train_run(
            dev, counters, paths, arch, "train",
            shape + ["--steps", str(FAMILY_TRAIN_STEPS), "--energy"], FAMILY_TRAIN_STEPS,
            layers=layers)
        check(rec.losses[-1] < rec.losses[0], f"{arch}: the loss did not fall")
        row = train_stats(arch, "train", out, rec, b * seq, bound, peak)
        row.update(layers=layers or get_config(arch).num_layers, batch=b, text_tokens=seq, lr=lr)
        rows.append(row)
        if arch == SEAMLESS:  # the encoder's layers recomputed too
            out, rec, peak, bound = train_run(dev, counters, paths, arch, "train remat",
                                              shape + ["--steps", "2", "--remat"], 2,
                                              recomputed=2)
            rows.append(train_stats(arch, "train remat", out, rec, b * seq, bound, peak))
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(train_parity(arch, dev, *FAMILY_PARITY[arch]))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch} train and parity took {time.perf_counter() - t:.1f} s")
    return rows


def train_phase(dev, counters, paths):
    """``launch.train`` at full width on the card: tinyllama-1.1b for
    ``TRAIN_STEPS`` steps of 8 x 1024 with NVML energy (the loss must
    fall); on ``RESUME_LAYERS`` layers at full width the same run
    uninterrupted, then preempted before step ``TRAIN_CKPT_AT``, which
    checkpoints, and resumed from that checkpoint to the end (its losses
    bit for bit the uninterrupted run's); steps with ``--remat``; recurrentgemma-2b for ``HYBRID_TRAIN_STEPS`` steps
    of 2 x 2304.  Every run's launches are exact for the forwards it ran
    (remat's recompute counted), read into ``paths``.  Then the gradient
    parity of both models (``train_parity``).  Then one model per other
    family (``FAMILY_TRAIN``: xlstm-1.3b, seamless-m4t-large-v2, also 2
    steps with ``--remat``, and moonshot-v1-16b-a3b and llava-next-34b cut
    to 4 layers), each for ``FAMILY_TRAIN_STEPS`` steps with NVML energy
    (finite losses that fall, exact launches) and its gradient parity
    (``FAMILY_PARITY``)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as train_lib
    from repro_torch.training import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    rows = []

    def run(*args, **kwargs):
        return train_run(dev, counters, paths, *args, **kwargs)

    B, S = 8, 1024
    out, whole, peak, bound = run(TRAIN_ARCH, "train", TRAIN + [
        "--steps", str(TRAIN_STEPS), "--energy"], TRAIN_STEPS)
    check(whole.losses[-1] < whole.losses[0], f"{TRAIN_ARCH}: the loss did not fall")
    rows.append(train_stats(TRAIN_ARCH, "train", out, whole, B * S, bound, peak))

    class Preempted(train_lib.PreemptionHandler):
        """Asks to stop before step ``TRAIN_CKPT_AT`` (polled once before
        each step)."""
        polls = 0

        @property
        def preemption_requested(self):
            Preempted.polls += 1
            return Preempted.polls > TRAIN_CKPT_AT

    uninterrupted = run(TRAIN_ARCH, "train uninterrupted", TRAIN + [
        "--steps", str(TRAIN_STEPS)], TRAIN_STEPS, layers=RESUME_LAYERS)[1]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ckpt_args = TRAIN + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt,
                             "--ckpt-every", str(10 * TRAIN_STEPS)]
        t = time.perf_counter()
        with patched(train_lib, "PreemptionHandler", Preempted):
            first, pre = run(TRAIN_ARCH, "train preempted", ckpt_args, TRAIN_CKPT_AT,
                             layers=RESUME_LAYERS)[:2]
        check(first["preempted"] and first["final_step"] == TRAIN_CKPT_AT
              and ckpt_lib.latest_step(ckpt) == TRAIN_CKPT_AT,
              f"the preempted run did not checkpoint step {TRAIN_CKPT_AT}")
        log(f"preempted run and its checkpoint: {time.perf_counter() - t:.1f} s; "
            f"{sum(f.stat().st_size for f in Path(ckpt).rglob('*') if f.is_file()) / 2**30:.2f}"
            f" GiB on disk")
        t = time.perf_counter()
        second, resumed = run(TRAIN_ARCH, "train resumed", ckpt_args,
                              TRAIN_STEPS - TRAIN_CKPT_AT, layers=RESUME_LAYERS)[:2]
        log(f"resumed run with its restore and checkpoint: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(second["final_step"] == TRAIN_STEPS and resumed.steps[0] == TRAIN_CKPT_AT,
          "the resumed run did not continue from its checkpoint")
    want = uninterrupted.losses[TRAIN_CKPT_AT:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, want))
    log(f"resumed losses {resumed.losses} against the uninterrupted {want}: max relative "
        f"difference {rel:.3e} (bitwise: {resumed.losses == want}); steps before the "
        f"checkpoint bitwise: {pre.losses == uninterrupted.losses[:TRAIN_CKPT_AT]}")
    # Exact: the checkpoint holds the bf16 parameters and fp32 moments bit for
    # bit, the data resumes at its offset, and nothing on this path sums in an
    # order that varies from run to run in one process (the embedding's
    # backward sorts its indices; cross entropy's gather scatters to distinct
    # places).  Any slack would pass a resume that lost the moments or read
    # the data a step off.
    check(resumed.losses == want,
          f"the resumed losses differ from the uninterrupted run's by {rel:.3e} relative")
    out, remat, peak, bound = run(TRAIN_ARCH, "train remat", TRAIN + ["--steps", "3", "--remat"],
                                  3, recomputed=3)
    rows.append(train_stats(TRAIN_ARCH, "train remat", out, remat, B * S, bound, peak))
    gc.collect()
    torch.cuda.empty_cache()
    rows.append(train_breakdown(dev))
    gc.collect()
    torch.cuda.empty_cache()

    out, hyb, peak, bound = run(HYBRID, "train", HYBRID_TRAIN + [
        "--steps", str(HYBRID_TRAIN_STEPS), "--energy"], HYBRID_TRAIN_STEPS)
    rows.append(train_stats(HYBRID, "train", out, hyb, 2 * HYBRID_PARITY_PROMPT, bound, peak))
    gc.collect()
    torch.cuda.empty_cache()
    for arch, (b, seq, layers) in TRAIN_PARITY.items():
        rows.append(train_parity(arch, dev, b, seq, layers))
        gc.collect()
        torch.cuda.empty_cache()
    rows += family_train_phase(dev, counters, paths)
    log(f"train phase took {time.perf_counter() - t0:.1f} s")
    return rows


def _grads(model, loss_fn, data):
    """``loss_fn``'s loss on ``data`` and every parameter's gradient."""
    import torch

    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, data)
    return loss.item(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def sharded_grad_parity(dev, model, data, sharded):
    """The sharded run's gradients (``sharded``: gathered over both axes)
    and the unsharded bf16 path's through the kernels, both of ``model``'s
    weights on the global batch ``data``, each against the plain versions
    on an fp32 copy of those weights: per parameter ||g - g32|| /
    ||g32||; the sharded run's worst at most 1.5x the unsharded path's
    (bf16 is the floor, as in ``train_parity``)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import model as model_lib
    from repro_torch.training import step as step_lib

    cfg = model.cfg
    # no remat: the backend choice is thread-local, and a recompute in the
    # backward runs on autograd's device thread, under the kernels
    loss_fn = step_lib.make_loss_fn(cfg, remat=False)
    with dispatch.use_backend("torch"):
        ref32 = model_lib.Model(cfg.replace(dtype="float32", param_dtype="float32"), device=dev)
        with torch.no_grad():
            for (_, a), (_, b) in zip(ref32.named_parameters(), model.named_parameters()):
                a.copy_(b.float())
        # the plain attention keeps (B, H, S, T) fp32 scores for the
        # backward: the global batch's mean as the mean of its
        # ``PARITY_CHUNKS`` equal row blocks' (every row counts its S
        # positions), one block at a time
        n = data["tokens"].shape[0] // PARITY_CHUNKS
        loss32, g32 = 0.0, None
        for i in range(PARITY_CHUNKS):
            part, g = _grads(ref32, loss_fn, {k: v[i * n:(i + 1) * n] for k, v in data.items()})
            loss32 += part / PARITY_CHUNKS
            g32 = g if g32 is None else {k: g32[k] + g[k] for k in g32}
            del g
        g32 = {k: t / PARITY_CHUNKS for k, t in g32.items()}
        del ref32
    loss_bf16, unsharded = _grads(model, loss_fn, data)

    def rel(g):
        return {k: ((g[k].to(dev).float() - want).norm() / want.norm().clamp_min(1e-30)).item()
                for k, want in g32.items()}

    rs, ru = rel(sharded), rel(unsharded)
    del unsharded, g32
    worst_s, worst_u = max((v, k) for k, v in rs.items()), max((v, k) for k, v in ru.items())
    row = dict(arch=cfg.name, batch=data["tokens"].shape[0], seq=data["tokens"].shape[1],
               loss_fp32=loss32, loss_unsharded_bf16=loss_bf16, worst_sharded=worst_s,
               worst_unsharded=worst_u, median_sharded=sorted(rs.values())[len(rs) // 2],
               median_unsharded=sorted(ru.values())[len(ru) // 2])
    log("sharded train gradient parity: " + json.dumps(row))
    check(worst_s[0] <= 1.5 * worst_u[0],
          f"the sharded run's gradients are {worst_s} from fp32, more than 1.5x the "
          f"unsharded bf16 path's {worst_u}")
    return row


def sharded_resume(dev, ckpt, args, steps, sharded):
    """The checkpoint the ranks wrote at their last step, restored on one
    device (the elastic restore: the one-device tree); the gradients of
    its weights on the next step's batch held to the sharded run's
    (``sharded``: the ranks' loss and gathered gradients on that batch,
    ``sharded_grad_parity``); then the driver's steps after the checkpoint
    up to ``steps`` (its schedule's length) run from it.  Returns their
    losses and the parity row."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset, batch_for_model
    from repro_torch.models import model as model_lib
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import step as step_lib

    cfg = get_config(TRAIN_ARCH)
    opt = opt_lib.AdamW(schedule=opt_lib.warmup_cosine_schedule(args.lr, args.warmup, steps))
    state = step_lib.train_state(model_lib.Model(cfg, device=dev), opt)
    tree = {"params": state.params(), "opt_mu": state.opt.mu, "opt_nu": state.opt.nu}
    restored, manifest = ckpt_lib.restore(ckpt, tree, device=dev)
    with torch.no_grad():
        for part, leaves in tree.items():
            for k, t in leaves.items():
                t.copy_(restored[part][k])
    del restored
    state.opt.count = state.step = manifest["step"]
    check(sharded["step"] == manifest["step"],
          f"the sharded gradients are of step {sharded['step']}, the checkpoint's {manifest}")
    ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                          batch_size=args.batch, seed=args.seed))
    rng = np.random.default_rng(args.seed)  # as the driver's resume draws its stubs
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                batch_for_model(cfg, ds.batch_at(i), rng).items()}
               for i in range(manifest["step"], steps)]
    row = sharded_grad_parity(dev, state.model, batches[0], sharded["grads"])
    gc.collect()
    torch.cuda.empty_cache()
    step = step_lib.make_train_step(cfg, opt, remat=args.remat, microbatches=args.microbatches)
    return [float(step(state, batch)["loss"]) for batch in batches], row


def sharded_train_phase(dev, counters, paths):
    """Sharded training on (data 2, model 2) gloo ranks that share the
    card, through ``launch.train.run(args, mesh=, cfg=)``: tinyllama-1.1b
    at full width and depth (``SHARDED_STEPS`` steps ending in a
    checkpoint, then the trained shards' loss and gradients on the next
    step's batch) and seamless-m4t-large-v2 at full width on 2 + 2 layers
    (2 steps), in one spawn; each rank's K1/K2 launches exact for the
    forwards the driver ran, read into ``"<arch> sharded train"`` (summed
    over the ranks).  Then the unsharded run from the same seed two steps
    longer, its losses held to the sharded run's; the checkpoint restored
    on one device (the elastic case), its gradients held to the sharded
    run's (``sharded_resume``) and the two steps after it run from it,
    held to the sharded run's next loss and the unsharded run's: every
    loss within ``SHARDED_LOSS_RTOL``.  The per-step times are those of
    gloo host copies among 4 ranks on one card."""
    import shutil
    import statistics
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.sharding import runs

    def rel(a, b):
        return abs(a - b) / abs(b)

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    rows = []
    try:
        ckpt, grads_file = os.path.join(tmp, "ckpt"), os.path.join(tmp, "grads.pt")
        tiny = ["--arch", TRAIN_ARCH] + SHARDED_TRAIN + [
            "--steps", str(SHARDED_STEPS), "--ckpt-dir", ckpt, "--energy"]
        layers, seam_argv = SHARDED_SEAMLESS
        seam_cfg = get_config(SEAMLESS).replace(num_layers=layers, num_encoder_layers=layers)
        serve = sharded_serve_job()
        repl = [sharded_serve_job(arch, n, serve=True) for arch, n in SERVE_REPL.items()]
        first = 1 + len(repl)  # the training jobs' index
        jobs = [serve] + repl + [
            runs.DriverTrain(tiny, shape=SHARDED_MESH, grads_to=grads_file, count=True),
            runs.DriverTrain(["--arch", SEAMLESS] + seam_argv, cfg=seam_cfg,
                             shape=SHARDED_MESH)]
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ranks = spawn_mesh(runs.train_plan, SHARDED_MESH, "cuda", jobs, backend="gloo",
                           threads=1)
        log(f"sharded train spawn ({SHARDED_MESH[0]} x {SHARDED_MESH[1]} gloo ranks on one "
            f"card) took {time.perf_counter() - t:.1f} s")
        served = [r[0] for r in ranks]
        for j, job in enumerate([serve] + repl):
            log(f"sharded {job.cfg.name} {'serve_repl' if job.serve else 'serve'} job on rank "
                f"0: {ranks[0][j]['seconds']:.1f} s, of which " + ", ".join(
                    f"{ph['phase']} {ph['seconds']:.2f} s" for ph in ranks[0][j]["phases"]))
        for j, (arch, cfg) in enumerate(((TRAIN_ARCH, get_config(TRAIN_ARCH)),
                                         (SEAMLESS, seam_cfg)), start=first):
            done = [r[j] for r in ranks]
            want = train_launches(cfg, len(done[0]["losses"]))
            for rank, run in enumerate(done):
                check(run["launches"] == want, f"{arch} sharded train rank {rank}: launch "
                      f"counts {run['launches']} != {want}")
                check(all(math.isfinite(x) for x in run["losses"]),
                      f"{arch} sharded train rank {rank}: a loss is not finite")
                check(run["losses"] == done[0]["losses"],
                      f"{arch} sharded train: rank {rank}'s losses differ from rank 0's")
            paths[f"{arch} sharded train"] = {k: sum(run["launches"][k] for run in done)
                                              for k in counters}
            row = dict(arch=arch, run="sharded train", card=", ".join(card()),
                       mesh=dict(data=SHARDED_MESH[0], model=SHARDED_MESH[1]),
                       backend="gloo, 4 ranks on one card (host-staged collectives)",
                       layers=cfg.num_layers, encoder_layers=cfg.num_encoder_layers,
                       steps=len(done[0]["losses"]), losses=done[0]["losses"],
                       step_ms=[x * 1e3 for x in done[0]["seconds"]],
                       median_step_ms=statistics.median(done[0]["seconds"][1:]) * 1e3,
                       peak_gib_per_rank=[run["peak_gib"] for run in done],
                       launches_per_rank={k: want[k] for k in ("rmsnorm", "flash_attention")},
                       printed=done[0]["out"])
            log("sharded train: " + json.dumps(row))
            rows.append(row)
        mesh_runs = {"train": [r[first]["steps"][1] for r in ranks],
                     "prefill": [r["phases"][0] for r in served],
                     "decode": [r["phases"][1] for r in served]}
        for k, job in enumerate(repl, start=1):
            mesh_runs[f"{job.cfg.name} serve_repl decode"] = [r[k]["phases"][1] for r in ranks]
        check(all(r[first]["steps"][1]["step"] == 1 for r in ranks),
              "the counted train step is not the sharded run's second")
        rows.append(sharded_serve_check(dev, serve, served, counters, paths))
        for k, job in enumerate(repl, start=1):
            t = time.perf_counter()
            rows.append(sharded_serve_check(dev, job, [r[k] for r in ranks], counters, paths))
            log(f"{job.cfg.name} serve_repl check took {time.perf_counter() - t:.1f} s")
        tiny_losses = rows[0]["losses"]
        check("joules" in rows[0]["printed"],
              "the sharded run's --energy window printed no joules")
        check(tiny_losses[-1] < tiny_losses[0],
              f"{TRAIN_ARCH}: the sharded loss did not fall: {tiny_losses}")
        nxt = torch.load(grads_file)
        next_loss = nxt["loss"]
        check(math.isfinite(next_loss), f"the sharded run's next loss {next_loss}")

        args = train_lib.build_argparser().parse_args(tiny)
        total = SHARDED_STEPS + 2  # the one-device resume's two steps after the checkpoint
        _, whole, _, _ = train_run(dev, counters, paths, TRAIN_ARCH, "train unsharded",
                                   SHARDED_TRAIN + ["--steps", str(total)], total)
        gc.collect()
        torch.cuda.empty_cache()
        resumed, parity = sharded_resume(dev, ckpt, args, total, nxt)
        del nxt
        gc.collect()
        torch.cuda.empty_cache()
        gaps = dict(sharded_vs_unsharded=max(rel(a, b) for a, b in zip(tiny_losses,
                                                                       whole.losses)),
                    resumed_vs_sharded=rel(resumed[0], next_loss),
                    resumed_vs_unsharded=max(rel(a, b) for a, b in
                                             zip(resumed, whole.losses[SHARDED_STEPS:])))
        row = dict(arch=TRAIN_ARCH, sharded=tiny_losses, sharded_next=next_loss,
                   unsharded=whole.losses, one_device_resumed=resumed, max_rel=gaps,
                   tol=SHARDED_LOSS_RTOL)
        log("sharded train elastic restore on one device: " + json.dumps(row))
        for name, gap in gaps.items():
            check(gap <= SHARDED_LOSS_RTOL, f"{TRAIN_ARCH} losses {name}: {gap:.3e} relative, "
                  f"more than {SHARDED_LOSS_RTOL:.3e} ({row})")
        rows += [row, parity]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"sharded train phase took {time.perf_counter() - t0:.1f} s")
    return rows, mesh_runs


def sharded_serve_job(arch=TRAIN_ARCH, layers=SHARDED_SERVE_LAYERS, serve=False):
    """``sharding.runs.MeshLogits`` on ``SHARDED_MESH``: ``arch`` at full
    width on ``layers`` layers from seed 0, a prompt of ``SHARDED_SERVE``
    random tokens (seeded) and its greedy decode steps; with ``serve``
    those under the serve rules (weight-stationary)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.sharding import runs

    B, P, n = SHARDED_SERVE
    cfg = get_config(arch).replace(num_layers=layers)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, P))
    return runs.MeshLogits(cfg=cfg, tokens=tokens, max_len=P + n, greedy=n,
                           shape=SHARDED_MESH, seed=0, serve=serve)


def sharded_serve_check(dev, job, served, counters, paths):
    """The ranks' prefill and greedy decode steps (``sharded_serve_job``)
    against the one-device model of the same seed fed the ranks' greedy
    tokens: the logits within twice the plain bf16 path's distance from
    an fp32 copy (the bf16 floor ``tp_compare`` holds tensor-parallel
    logits to) of both that copy's and the one-device kernels' logits,
    top-1 equal wherever fp32's margin clears it; a data
    rank's model ranks alike (every rank alike under the serve rules,
    whose steps return the whole batch); K1, K2 and K3 launched on every
    rank exactly as often as one device launches them for a prefill and
    the decode steps, but K1's split norms twice under the serve rules.
    The path's counts go to ``"<arch> sharded serve"`` or ``"<arch>
    serve_repl"``."""
    import numpy as np
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import model as model_lib

    cfg, (B, P, n) = job.cfg, SHARDED_SERVE
    want = expected_launches(cfg, 1, n)
    if job.serve:  # K1 in its split mode: two launches a norm in a decode step
        want["rmsnorm"] += expected_launches(cfg, 0, n)["rmsnorm"]
    what = "serve_repl" if job.serve else "sharded serve"
    for rank, r in enumerate(served):
        check(r["launches"] == want, f"{cfg.name} {what} rank {rank}: launches "
                                     f"{r['launches']} != {want}")
    paths[f"{cfg.name} {what}"] = {k: sum(r["launches"][k] for r in served) for k in counters}
    dp, tp = SHARDED_MESH
    if job.serve:
        for rank in range(1, dp * tp):
            check(np.array_equal(served[rank]["logits"], served[0]["logits"]),
                  f"{what}: rank {rank}'s logits differ from rank 0's")
        got = served[0]["logits"]
    else:
        for i in range(dp):
            for j in range(1, tp):
                check(np.array_equal(served[i * tp + j]["logits"], served[i * tp]["logits"]),
                      f"{what}: rank {i * tp + j}'s logits differ from rank {i * tp}'s")
        got = np.concatenate([served[i * tp]["logits"] for i in range(dp)], axis=1)
        check([served[i * tp]["row"] for i in range(dp)] == [i * (B // dp) for i in range(dp)],
              f"{what}: the data ranks' rows are not the batch's in order")
    tokens = torch.from_numpy(job.tokens).to(dev)
    picked = [torch.from_numpy(got[i].argmax(-1)).to(dev)[:, None] for i in range(n)]
    model = model_lib.init(cfg, torch.Generator(device=dev).manual_seed(job.seed), dev)

    def run(m, dtype=None):
        cache = m.init_cache(B, P + n, dtype)
        logits = m.prefill({"tokens": tokens}, cache)[0]
        out = [logits]
        for i in range(n):
            logits, cache = m.decode_step(picked[i], P + i, cache)
            out.append(logits)
        return torch.stack(out).float()

    kern = run(model).cpu().numpy()
    with dispatch.use_backend("torch"):
        plain = run(model)
        ref32 = model_lib.Model(cfg.replace(dtype="float32", param_dtype="float32"), device=dev)
        with torch.no_grad():
            for p32, p in zip(ref32.parameters(), model.parameters()):
                p32.copy_(p)
        del model
        ref = run(ref32, torch.float32)
    del ref32
    floor = (plain - ref).abs().max().item()
    tol = 2 * floor
    ref = ref.cpu().numpy()
    diff = float(np.abs(got - kern).max())
    diff32 = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > floor
    agree = got.argmax(-1) == ref.argmax(-1)
    row = dict(arch=cfg.name, run=what, layers=cfg.num_layers, rows=B, prompt=P, decode_steps=n,
               mesh=dict(data=dp, model=tp), max_abs_diff_vs_one_device=diff,
               max_abs_diff_vs_fp32=diff32, tol=tol,
               plain_bf16_vs_fp32=floor, max_abs_logit=float(np.abs(ref).max()),
               top1_agree_fp32=f"{int(agree.sum())}/{agree.size}",
               decided_rows=int(decided.sum()), card=", ".join(card()),
               launches_per_rank=want,
               seconds_rank0={"job": served[0]["seconds"],
                              **{ph["phase"]: ph["seconds"] for ph in served[0]["phases"]}},
               peak_bytes_per_rank={ph["phase"]: [r["phases"][k]["peak_bytes"] for r in served]
                                    for k, ph in enumerate(served[0]["phases"])})
    log(f"{what}: " + json.dumps(row))
    check(diff <= tol, f"{cfg.name} {what}: logits {diff} from the one-device model's, "
                       f"tol {tol}")
    check(diff32 <= tol, f"{cfg.name} {what}: logits {diff32} from the fp32 copy's, tol {tol}")
    check(bool(agree[decided].all()),
          f"{cfg.name} {what}: top-1 differs from fp32 on a row with a clear margin")
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 7: the dry-run: a sweep cell of each shape, and the bound it gives
# held to measured times
# ---------------------------------------------------------------------------

# one cell of each of the reference's shapes, four families, each with its
# options: command-r-plus-104b's decode under FSDP and weight-stationary
# (``serve_repl``); the last is skipped, as the reference's should_skip says
DRYRUN_CELLS = [(TRAIN_ARCH, "train_4k", ()), (QWEN_MOE, "prefill_32k", ()),
                (COMMAND_R, "decode_32k", ()), (COMMAND_R, "decode_32k", ("serve_repl",)),
                (XLSTM, "long_500k", ()), (ARCH, "long_500k", ())]
CALIB_PREFILL = (1, 8192)   # rows, positions
CALIB_DECODE = (32, 8192)   # rows, cache length; the step at the last position
CALIB_TRAIN = (8, 1024)     # the train phase's rows and positions
CALIB_ITERS = {"prefill": (2, 5), "decode": (3, 20)}   # warm-up calls, timed calls


def calibration_cells(cfg, prefill, decode):
    """The dry-run jobs of ``calibrate``: ``cfg``'s prefill and decode step
    on one device (mesh (1, 1))."""
    from repro_torch.models.config import ShapeConfig

    return [(cfg.name, ShapeConfig("calib_prefill", prefill[1], prefill[0], "prefill"),
             dict(mesh=(1, 1))),
            (cfg.name, ShapeConfig("calib_decode", decode[1], decode[0], "decode"),
             dict(mesh=(1, 1)))]


def calibrate(dev, counters, cfg, prefill, decode, counted):
    """``cfg``'s prefill and decode step, counted by the dry-run on one
    device (``counted``: the results of ``calibration_cells``), run on
    ``dev`` through the kernels, each timed by ``time_callable``; every
    timed sample must take at least the dry-run's bound (the largest of
    its terms).  The decode cache is filled with random K/V at every
    position, so the step attends to all of them.  Returns (rows,
    launches)."""
    import torch

    from repro_torch.core.latency import time_callable
    from repro_torch.models import model as model_lib

    gen = torch.Generator(device=dev).manual_seed(0)
    model = model_lib.init(cfg, gen, dev)
    reset_counts(counters)
    B, S = prefill
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}
    cache = model.init_cache(B, S)
    warm, iters = CALIB_ITERS["prefill"]
    stats = {"prefill": time_callable(lambda: model.prefill(batch, cache)[0], iters=iters,
                                      warmup=warm, name="prefill")}
    del cache
    B, L = decode
    cache = model.init_cache(B, L)
    for entry in cache:
        if "k" in entry:
            entry["k"].normal_(generator=gen)
            entry["v"].normal_(generator=gen)
            entry["pos"].copy_(torch.arange(L, dtype=torch.int32, device=dev).expand(B, L))
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    warm, iters = CALIB_ITERS["decode"]
    stats["decode"] = time_callable(lambda: model.decode_step(tok, L - 1, cache)[0],
                                    iters=iters, warmup=warm, name="decode")
    launches = read_counts(counters)
    del model, cache
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = []
    for kind, st in stats.items():
        r = counted[kind]["roofline"]
        bound_ms = r["bound_s"] * 1e3
        row = {"arch": cfg.name, "kind": kind, "shape": prefill if kind == "prefill" else decode,
               "flops": counted[kind]["cost"]["flops_global"],
               "argument_bytes": counted[kind]["memory"]["argument_bytes_global"],
               "compute_term_ms": r["compute_term_s"] * 1e3,
               "memory_term_ms": r["memory_term_s"] * 1e3, "bound_ms": bound_ms,
               "bound_by": r["dominant"], "ms_min": min(st.samples_s) * 1e3,
               "ms_p50": st.p50_s * 1e3, "ms_mean": st.mean_ms, "n": len(st.samples_s),
               "measured_over_bound": st.p50_s * 1e3 / bound_ms,
               "min_over_bound": min(st.samples_s) * 1e3 / bound_ms}
        log("dryrun calibration: " + json.dumps(row))
        check(row["ms_min"] >= bound_ms,
              f"{cfg.name} {kind} ran in {row['ms_min']:.3f} ms, under the dry-run's bound "
              f"{bound_ms:.3f} ms: the count or the bytes are wrong")
        rows.append(row)
    return rows, launches


def mesh_cells():
    """The dry-run jobs of the sharded phase's counted steps at
    ``SHARDED_MESH``: tinyllama-1.1b's train step at 8 x 1024 (full depth,
    one microbatch, no remat, as the driver ran it), the 8-layer model's
    prefill and decode step of ``SHARDED_SERVE``, and each ``SERVE_REPL``
    model's weight-stationary decode step (``serve_repl``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig

    B, P, n = SHARDED_SERVE
    tb, ts = CALIB_TRAIN
    cfg = get_config(TRAIN_ARCH).replace(num_layers=SHARDED_SERVE_LAYERS)
    cells = {"train": (TRAIN_ARCH, ShapeConfig("sharded_train", ts, tb, "train", 1),
                       dict(mesh=SHARDED_MESH, remat=False)),
             "prefill": (TRAIN_ARCH, ShapeConfig("sharded_prefill", P, B, "prefill"),
                         dict(mesh=SHARDED_MESH, cfg=cfg)),
             "decode": (TRAIN_ARCH, ShapeConfig("sharded_decode", P + n, B, "decode"),
                        dict(mesh=SHARDED_MESH, cfg=cfg))}
    for arch, layers in SERVE_REPL.items():
        cells[f"{arch} serve_repl decode"] = (
            arch, ShapeConfig("serve_repl_decode", P + n, B, "decode"),
            dict(mesh=SHARDED_MESH, cfg=get_config(arch).replace(num_layers=layers),
                 opts=("serve_repl",)))
    return cells


def dryrun_jobs():
    """Every dry-run cell of ``dryrun_phase``, as ``run_cells`` takes them:
    ``DRYRUN_CELLS`` at 16 x 16, ``mesh_cells``, ``calibration_cells`` and
    tinyllama-1.1b's train step at the train phase's 8 x 1024 on one
    device."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig

    tb, ts = CALIB_TRAIN
    return ([(arch, shape, dict(opts=opts)) for arch, shape, opts in DRYRUN_CELLS]
            + list(mesh_cells().values())
            + calibration_cells(get_config(ARCH), CALIB_PREFILL, CALIB_DECODE)
            + [(TRAIN_ARCH, ShapeConfig("calib_train", ts, tb, "train"), dict(mesh=(1, 1)))])


def start_dryrun():
    """``dryrun_jobs`` in ``DRYRUN_WORKERS`` processes on this host, from
    a thread, so the cells (CPU only, meta tensors) run while the sharded
    phase's ranks do; ``dryrun_phase`` reads the future.  Returns (the
    future, its start time)."""
    import concurrent.futures

    from repro_torch.launch import dryrun

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(dryrun.run_cells, dryrun_jobs(), DRYRUN_WORKERS)
    pool.shutdown(wait=False)
    return future, time.perf_counter()


def dryrun_phase(dev, counters, paths, mesh_runs, cells):
    """``launch.dryrun.run_cell`` on this machine's host (``cells``:
    ``start_dryrun``'s future of ``dryrun_jobs``, run in
    ``DRYRUN_WORKERS`` processes), no kernel launched in any:
    ``DRYRUN_CELLS`` at the production mesh's 16 x 16 (each ``ok`` with
    every per-device field filled, or ``skipped`` where ``should_skip``
    says; command-r-plus-104b's decode under FSDP beside ``serve_repl``);
    the sharded phase's steps at ``SHARDED_MESH`` (``mesh_cells``),
    whose collectives must equal, by axis and kind in count and bytes,
    what each rank counted in them (``mesh_runs``), and whose per-device peak
    estimates must be within ``PEAK_BAND`` (and 1.5x) of each rank's
    measured peak; then ``calibrate`` on llama3.1-8b at full width
    (prefill 1 x 8192, decode 32 x 8192; launches exact), then the
    dry-run's FLOPs beside this script's own: ``prefill_flops`` for the
    same prefill and ``train_flops`` for tinyllama-1.1b's train step at
    the train phase's 8 x 1024."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.size import profile_size
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    tb, ts = CALIB_TRAIN
    mesh_jobs = mesh_cells()
    future, started = cells
    out = future.result()
    log(f"dryrun cells ({len(out)} in {DRYRUN_WORKERS} processes, started "
        f"{t0 - started:.1f} s before this phase) done after {time.perf_counter() - t0:.1f} s "
        f"of waiting; each cell's count_s and rank_count_s below")
    check(all(n == 0 for _, launches in out for n in launches.values()),
          "the dry-run launched a kernel")
    results = [res for res, _ in out]
    for (arch, shape, opts), res in zip(DRYRUN_CELLS, results):
        want = "skipped" if dryrun.should_skip(get_config(arch), SHAPES[shape]) else "ok"
        check(res["status"] == want, f"dry-run {arch} {shape}: {res['status']}, want {want}")
        row = {"arch": arch, "shape": shape, "opts": list(opts), "status": res["status"],
               "mesh": res["mesh"]}
        if want == "ok":
            r, mem, coll = res["roofline"], res["memory"], res["collectives"]
            row.update(count_s=res["count_s"], rank_count_s=res["rank_count_s"],
                       flops=res["cost"]["flops_global"],
                       flops_perdev=res["cost"]["flops_perdev_corrected"],
                       microbatches=res["cost"]["microbatches"],
                       argument_bytes=mem["argument_bytes_global"],
                       argument_bytes_per_device=mem["argument_bytes_per_device"],
                       temp_bytes_per_device=mem["temp_bytes_per_device"],
                       peak_bytes_estimate=mem["peak_bytes_estimate"],
                       collective_counts=coll["counts"],
                       collective_bytes_per_device=coll["bytes_perdev_corrected"],
                       collectives_by_axis_kind=coll["by_axis_kind_perdev"],
                       compute_term_ms=r["compute_term_s"] * 1e3,
                       memory_term_ms=r["memory_term_s"] * 1e3,
                       collective_term_ms=r["collective_term_s"] * 1e3, dominant=r["dominant"],
                       model_flops=r["model_flops"], useful_flops_ratio=r["useful_flops_ratio"])
            check(math.isfinite(row["flops"]) and row["flops"] > 0, f"no count for {arch} {shape}")
            check(res["mesh"] == "16x16" and all(
                v is not None for part in ("memory", "collectives") for v in res[part].values())
                  and res["cost"]["flops_perdev_corrected"] > 0
                  and res["roofline"]["collective_term_s"] is not None,
                  f"dry-run {arch} {shape}: a per-device field is null")
        log("dryrun cell: " + json.dumps(row))
    by_cell = dict(zip(DRYRUN_CELLS, results))
    fsdp, repl = (by_cell[(COMMAND_R, "decode_32k", opts)]["collectives"]
                  for opts in ((), ("serve_repl",)))
    weights = fsdp["by_axis_kind_perdev"]["data all-gather"][1]  # FSDP's weight gathers
    fall = (fsdp["bytes_by_kind_perdev_once"]["all-gather"]
            - repl["bytes_by_kind_perdev_once"]["all-gather"])
    log(f"dryrun {COMMAND_R} decode_32k at 16x16, FSDP beside serve_repl: " + json.dumps({
        "all_gather_bytes": [c["bytes_by_kind_perdev_once"]["all-gather"] for c in (fsdp, repl)],
        "collective_bytes": [c["bytes_perdev_corrected"] for c in (fsdp, repl)],
        "fsdp_weight_gather_bytes": weights, "all_gather_fall": fall}))
    check(fall >= 0.95 * weights, f"serve_repl's all-gathers fall by {fall} B, less than the "
                                  f"{weights} B of weights FSDP gathers")

    mesh_res = dict(zip(mesh_jobs, results[len(DRYRUN_CELLS):]))
    for kind, res in mesh_res.items():
        coll, mem = res["collectives"], res["memory"]
        want = (coll["counts"], coll["bytes_by_kind_perdev_once"], coll["by_axis_kind_perdev"])
        estimate = mem["peak_bytes_estimate"]
        ratios = [estimate / r["peak_bytes"] for r in mesh_runs[kind]]
        log(f"dryrun {kind} at {res['mesh']}: " + json.dumps({
            "collective_counts": coll["counts"], "bytes_by_kind": coll["bytes_by_kind_perdev_once"],
            "ranks_counted": [r["collectives"]["counts"] for r in mesh_runs[kind]],
            "argument_bytes_per_device": mem["argument_bytes_per_device"],
            "temp_bytes_per_device": mem["temp_bytes_per_device"],
            "peak_bytes_estimate": estimate,
            "measured_peak_bytes_per_rank": [r["peak_bytes"] for r in mesh_runs[kind]],
            "measured_base_bytes_per_rank": [r["base_bytes"] for r in mesh_runs[kind]],
            "estimate_over_measured": ratios, "band": PEAK_BAND, "card": card()}))
        for rank, r in enumerate(mesh_runs[kind]):
            got = (r["collectives"]["counts"], r["collectives"]["bytes_by_kind"],
                   r["collectives"]["by_axis_kind"])
            check(got == want, f"dry-run {kind} at {res['mesh']}: rank {rank} counted {got}, "
                               f"the dry-run {want}")
        for rank, ratio in enumerate(ratios):
            check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1] and 1 / 1.5 <= ratio <= 1.5,
                  f"dry-run {kind}: peak estimate over rank {rank}'s measured peak {ratio:.3f}, "
                  f"outside {PEAK_BAND}")

    first = len(DRYRUN_CELLS) + len(mesh_jobs)
    counted = {"prefill": results[first], "decode": results[first + 1]}
    train = results[first + 2]
    rows, launches = calibrate(dev, counters, cfg, CALIB_PREFILL, CALIB_DECODE, counted)
    paths[f"{ARCH} dryrun calibration"] = launches
    (wp, ip), (wd, idc) = CALIB_ITERS["prefill"], CALIB_ITERS["decode"]
    want = expected_launches(cfg, wp + ip, wd + idc)
    check(launches == want, f"calibration launches {launches} != {want}")
    size = profile_size(cfg)
    tables = (sum(size.by_component.get(k, 0) for k in ("embed", "lm_head"))
              // getattr(torch, cfg.param_dtype).itemsize)
    B, S = CALIB_PREFILL
    mine = prefill_flops(cfg, size.param_count - tables, B * S)
    theirs = counted["prefill"]["cost"]["flops_global"]
    tcfg = get_config(TRAIN_ARCH)
    analytic = train_flops(tcfg, Model(tcfg, device="meta"), tb, ts)
    log("dryrun flops: " + json.dumps({
        f"{ARCH} prefill {B}x{S}": {"dryrun": theirs, "prefill_flops": mine,
                                     "dryrun_over_prefill_flops": theirs / mine},
        f"{TRAIN_ARCH} train {tb}x{ts}": {"dryrun": train["cost"]["flops_global"],
                                          "train_flops": analytic,
                                          "dryrun_over_train_flops":
                                              train["cost"]["flops_global"] / analytic}}))
    log(f"dryrun phase took {time.perf_counter() - t0:.1f} s")
    return rows


def card():
    """``nvidia-smi``'s name and power limit of each card, one line each."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()


def idle_power(samples=20, interval_s=0.1):
    """The board's power from NVML before any model is drawn (the ``h100``
    spec's ``idle_watts``)."""
    import statistics

    from repro_torch.core.energy import NvmlReader

    nvml = NvmlReader([0])
    try:
        watts = []
        for _ in range(samples):
            watts.append(nvml.read_watts()[0])
            time.sleep(interval_s)
    finally:
        nvml.close()
    log("idle power: " + json.dumps({"watts_median": statistics.median(watts),
                                     "watts_min": min(watts), "watts_max": max(watts),
                                     "samples": samples, "interval_s": interval_s}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, dispatch

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = card()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    idle_power()
    t0 = time.perf_counter()
    _build.load()
    log(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s")

    counters = dispatch.KERNELS
    entries = kernel_phase(dev)
    paths = {}  # each path's counts, read right after that path ran
    t_arch = time.perf_counter()
    e, paths[f"{ARCH} measure"], measured = main_path_phase(ARCH, counters)
    measure_split = measure_graph_phase(e, dev, measured)
    profile_phase(e, dev)
    whole = serve_phase(e, counters)
    paths[f"{ARCH} serve"] = whole[0]
    direct = graph_phase(e)
    paths.update(chunked_serve_phase(e, counters, whole, measure_split))
    tol = parity_phase(e, dev)
    paths.update(preemption_phase(e, counters, tol))
    paths.update(speculative_phase(e, counters, tol))
    paths[f"{ARCH} http serve"] = http_serve_phase(e, counters, tol, direct)
    paths.update(open_loop_phase(e, counters, tol))
    del e  # free llama3.1-8b before bench_serve draws it anew
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(bench_serve_phase(counters))
    gc.collect()
    torch.cuda.empty_cache()
    for path, decode in (("http serve", "paged_decode_attention"),
                         ("open loop", "paged_decode_attention"),
                         ("bench_serve closed", "decode_attention"),
                         ("bench_serve open", "decode_attention")):
        check(all(paths[f"{ARCH} {path}"][k] > 0 for k in ("rmsnorm", "flash_attention", decode)),
              f"K1, K2 or {decode} never launched on {path}")

    log(f"{ARCH} phases took {time.perf_counter() - t_arch:.1f} s")

    model_phases(HYBRID, dev, counters, paths, prompt=HYBRID_PARITY_PROMPT, paged=False,
                 table_scale=0.05)
    model_phases(NEMOTRON, dev, counters, paths, layers=NEMOTRON_LAYERS)
    check(paths[f"{NEMOTRON} serve"]["paged_decode_attention"] > 0,
          f"K4 never launched on the {NEMOTRON} serve path")
    # the parity models' tolerances, for their tp runs: xlstm-1.3b's at its
    # tp depth, the MoE models' and llava-next-34b's at 4 layers
    tols = {XLSTM: model_phases(XLSTM, dev, counters, paths, serve=False, paged=False,
                                layers=XLSTM_LAYERS)}
    for arch in (QWEN_MOE, MOONSHOT):
        tols[arch] = model_phases(arch, dev, counters, paths, parity_layers=PARITY_LAYERS,
                                  layers=MOE_LAYERS)
        for path in ("measure", "serve", "chunked serve"):
            check(all(paths[f"{arch} {path}"][k] > 0 for k in ("rmsnorm", "flash_attention")),
                  f"K1 or K2 never launched on the {arch} {path} path")
        check(paths[f"{arch} measure"]["decode_attention"] > 0
              and paths[f"{arch} serve"]["paged_decode_attention"] > 0,
              f"K3 or K4 never launched on the {arch} paths")
    tols[LLAVA] = model_phases(LLAVA, dev, counters, paths, parity_layers=PARITY_LAYERS,
                               layers=LLAVA_LAYERS)
    for path in ("measure", "serve", "chunked serve"):
        check(all(paths[f"{LLAVA} {path}"][k] > 0 for k in ("rmsnorm", "flash_attention")),
              f"K1 or K2 never launched on the {LLAVA} {path} path")
    check(paths[f"{LLAVA} measure"]["decode_attention"] > 0
          and paths[f"{LLAVA} serve"]["paged_decode_attention"] > 0
          and paths[f"{LLAVA} chunked serve"]["paged_decode_attention"] > 0,
          f"K3 or K4 never launched on the {LLAVA} paths")
    model_phases(SEAMLESS, dev, counters, paths, serve=False, paged=False)
    check(all(paths[f"{SEAMLESS} measure"][k] > 0
              for k in ("rmsnorm", "flash_attention", "decode_attention")),
          f"K1, K2 or K3 never launched on the {SEAMLESS} measure path")
    tp_phase(dev, paths, tols)
    train_phase(dev, counters, paths)
    for path in ("train", "train uninterrupted", "train preempted", "train resumed",
                 "train remat"):
        check(all(paths[f"{TRAIN_ARCH} {path}"][k] > 0 for k in ("rmsnorm", "flash_attention")),
              f"K1 or K2 never launched on the {TRAIN_ARCH} {path} path")
    check(paths[f"{HYBRID} train"]["linear_recurrence"] > 0,
          f"K5 never launched on the {HYBRID} train path")
    check(paths[f"{XLSTM} train"]["rmsnorm"] > 0, f"K1 never launched on the {XLSTM} train path")
    for arch in (SEAMLESS, MOONSHOT, LLAVA):
        check(all(paths[f"{arch} train"][k] > 0 for k in ("rmsnorm", "flash_attention")),
              f"K1 or K2 never launched on the {arch} train path")
    cells = start_dryrun()
    _, mesh_runs = sharded_train_phase(dev, counters, paths)
    for arch in (TRAIN_ARCH, SEAMLESS):
        check(all(paths[f"{arch} sharded train"][k] > 0 for k in ("rmsnorm", "flash_attention")),
              f"K1 or K2 never launched on the {arch} sharded train path")
    for path in [f"{TRAIN_ARCH} sharded serve"] + [f"{arch} serve_repl" for arch in SERVE_REPL]:
        check(all(paths[path][k] > 0 for k in ("rmsnorm", "flash_attention", "decode_attention")),
              f"K1, K2 or K3 never launched on the {path} path")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(dev, counters, paths, mesh_runs, cells)
    for entry in entries:
        k = entry["name"]
        entry["launches_by_path"] = {path: counts[k] for path, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        check(entry["launches"] > 0, f"{k} never launched on its path")

    log(json.dumps({"kernels": entries}))
    log(smi[0] if smi else "nvidia-smi: no output")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
