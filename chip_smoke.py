#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
final line:

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 off for matmul and cuDNN;
2. the hand-written kernels, built from the checkout's sources (one nvcc
   per source, all at once), each against its plain PyTorch version on
   the card, with its time, the plain version's, one library call's (the
   yardstick, never used by the port) and the bound: flash attention
   (qwen2.5-32b and qwen2-moe prefill shapes, head dims 96, 192 and 256 at
   the prefill heads of phi3-mini, nemotron-4-340b and gemma-7b,
   internvl2-26b's 48/8 heads, whisper-small's decoder (B=8, S=448, hd
   64), ragged causal, non-causal T != S, float32 (also at qwen2-moe's
   prefill, as the expert-parallel phase runs it); SDPA as yardstick; the device's
   share of the kernel's time by the profiler; ptxas registers and spill
   bytes of every flash instance, and the wgmma/TMA instructions in its
   SASS) and moe_gather, bit for bit
   (qwen2-moe prefill and decode dispatch shapes, one expert-parallel
   rank's (15 of 60 experts), ragged float32, bf16
   rows that are not whole 16-byte words; ``index_select`` as yardstick;
   whether rows move in 16-byte words or elements, the device's share of
   the time by the profiler; at the prefill's and the rank's shapes one
   call with x just written and one after the L2 is flushed, the latter
   also on the device) and ssm_scan within 1e-5 (jamba's
   prefill shape, one tensor-parallel rank's quarter of its channels
   (18g's) and a ragged shape; no PyTorch call computes a selective
   scan, so no yardstick; the inputs copied for TMA; the scan kernels'
   SASS instruction and MUFU.EX2 counts; a spill in the scan or the
   gather, forward or backward, fails the run), moe_gather's backward bit
   for bit (the training step's dispatch, float32 and bf16, given the
   (T, k) map of each token's slots, built outside the timed call; the
   same bits twice and through ``ops.moe_gather(..., slots=)`` with
   autograd; ``index_add_`` as yardstick; maps of 10 and ~38 slots a
   token, past the kernel's fan of 8, untimed) and ssm_scan's backward within
   1e-4 of each output's largest value against the plain version's
   autograd (jamba's full Mamba shape, a rank's quarter of its channels
   and the reduced training shape, B and C strided; both instances, 4 lanes a channel at 128 and 32
   channels a block, given the checkpointing forward's checkpoints and
   without them; the same bits twice; the checkpointing forward's y the
   serving forward's bits, its checkpoints bit-equal through autograd;
   the backward, the checkpointing forward and the pair timed beside their
   bounds and the function's own minimum; no yardstick) and
   paged_attention (the
   decode shapes of
   qwen2.5-32b, jamba, qwen2-moe and internvl2-26b (48/8), head dims 96,
   192 and 256 at the heads of phi3-mini, nemotron-4-340b and gemma-7b
   (gemma's also as the last layer's view of a 28-layer pool), a ragged
   float32 case
   with holes, and the long-context step's shape in bf16 and in float32
   with holes; the bf16 cases also row by row against the float32 answer;
   SDPA over a dense copy gathered beforehand as yardstick; the device's
   share of the kernel's time by the profiler), and paged_attention's
   partial mode at one rank's share of a long context split over the
   sequence (``PARTIAL_CASES``: nemotron-4-340b's 96/8 heads of 192, B=4
   rows of 4,096 tokens in 64-token pages cut into 16 shards by the
   round-robin rule; a hole, a short row whose later shards are empty, a
   row whose pages sit on one shard; bf16 and float32): each shard's
   partial against its plain version, the 16 merged in shard order
   against ``paged_attention`` over the whole pool and its plain version,
   one shard's call timed beside its bound;
3. dense prefill at full width: qwen2.5-32b, all 64 layers, bf16 random
   weights drawn on the card from a seed, B=1, S=4096, through the flash
   kernel (one launch per layer), checked against the plain attention
   path, and the serving decode path checked against prefill: over the
   dense cache, over the paged pool (page 4, through the paged kernel, one
   launch per layer and step) and over the int8 cache; then the
   continuous-batching engine over the paged pool (page 16): 8 requests
   (``SERVE_MAX_NEW``: 19 tokens each, two pages), batch 4, one
   paged-attention launch per layer and decode step, every
   request finished and every page released; then a long-context paged
   decode step on the same weights: B=4, 4,000-4,090 cached tokens a row
   (state built directly, random K/V), 5 steps, with the device's busy
   share and paged_attention's share of device time;
4. dense serving at full width through ``serve_batch``: 8 requests,
   batch 4, greedy, every request finished and every KV page released;
5. MoE prefill at full width and depth: qwen2-moe-a2.7b, all 24 layers,
   60 experts top-4 + 4 shared, B=1, S=4096, through flash attention and
   the moe_gather dispatch (one launch of each per layer), checked against
   the plain attention path; decode (dense, paged and int8) checked
   against prefill with the capacity lifted; paged serving as in 3;
6. MoE serving through ``serve_batch``: 8 requests, batch 4, one
   moe_gather launch per layer and decode step;
7. hybrid prefill at full width: jamba-1.5-large cut to one group of 8
   layers (7 Mamba, 1 attention; 4 MoE, 4 dense FFN) and 12 of its 16
   experts, so that its 66.3 GiB of bf16 weights fit one card (one group
   at 16 experts is 84.3 GiB and cannot; 18g splits the group over four
   ranks at 8 experts: at 12 the ranks' contexts, the whole leaf drawn in
   turns and the activations leave too little room); B=1,
   S=4096, through flash (1 launch), moe_gather (4) and ssm_scan (7;
   the scan inputs copied for TMA printed, none at jamba's layout),
   checked against the plain attention path; decode (the plain one-step
   recurrence; dense and paged) checked against prefill (the scan kernel)
   with the capacity lifted (a hybrid config ignores the int8 KV cache, as
   the reference does); paged serving as in 3;
8. hybrid serving through ``serve_batch`` with the same cut: 8 requests,
   batch 4, moe_gather 4 launches per decode step, no flash or scan;
9-18. the other families, every published width and full depth (but
   xlstm's, cut below), bf16
   random weights drawn on the card, each a prefill phase as 3 and a
   serving phase as 4: gemma-7b (28 layers, 16/16 heads of 256, q_dim
   4096 against d_model 3072, tied embeddings), phi3-mini (32 layers,
   32/32 heads of 96) and internvl2-26b (48 layers, 48/8 heads: G=6; the
   first 256 positions patch embeddings), each with flash one launch per
   layer, decode over the dense cache, the paged pool (one paged_attention
   launch per layer and step) and the int8 cache, and serving over both;
   whisper-small (B=8 sequences of its 448-token decoder context over
   1,500 encoder frames, ``Model.encode`` timed; flash in the decoder's
   12 layers, the encoder on the plain path as the reference; dense
   decode from the encoder's output; the paged pool and the int8 cache
   refused, as the reference has neither for it); xlstm-125m (cut to 4
   of its 12 blocks, one sLSTM block,
   no attention and no kernel: the sLSTM's 4,096 sequential steps a
   layer, the profiler's breakdown over the first 512 tokens; decode over
   the recurrent state against prefill, held in float32; no paged pool). Then one summary line per model: prefill tokens/s, the dense
   decode step's ms and busy share, serving tokens/s, peak memory, beside
   the card's name and power limit.
18a. training at full width: ``train_loop`` on qwen2-moe-a2.7b cut to 4
   of its 24 layers (~2.90 B parameters; float32 weights and AdamW
   moments, 16 bytes a parameter), B=4 x 1,025 tokens, 5 steps on one
   repeated batch at lr 3e-5, each layer rematerialized (the config's
   remat "full"): per step its ms, tokens/s, loss and gradient norm; the
   loss must fall and stay finite; moe_gather twice per layer a step
   (the forward and remat's recompute) and its backward once, flash and
   paged attention never; the peak memory (under 75 GiB); one more step
   alone, then under the profiler: the device's busy share and its top
   kernels; its step and peak beside the same run's without remat;
18b. training at ``reduced_config`` on the card for qwen2-moe, jamba
   (ssm_scan and its backward) and xlstm-125m (no kernel), 8 steps each,
   against the same port run on the CPU from the same weights and
   batches (losses within 1e-3 relative, step for step); then jamba with
   a checkpoint every 4 steps and a failure injected before step 6: the
   supervisor restores step 4 on the card and replays, the replayed
   losses equal to the first pass's. Checkpointing at full width (~43 GiB
   a save) is left out for time.
18c. explicit expert parallelism: qwen2-moe-a2.7b over a (data 1, model
   4) mesh of four processes sharing the card (gloo on CUDA tensors, as
   NCCL refuses two ranks on one device), each rank holding its slices
   under ``param_specs``: a quarter of the heads, ff and vocab, 15 of the
   60 experts and a quarter of the shared experts' ff (two all-reduces a
   layer and one for the embedding, the logits all-gathered), drawn in
   turns from the seed so that one whole leaf at a time is on the card. First the collective functions and the pipeline
   at 4 stages on the ranks, against the single-process answer; then (a)
   float32 at every published width, 2 of 24 layers: prefill B=1,
   S=4096 under ``Ctx(use_flash=True)`` (flash and moe_gather once per
   layer on every rank), every position's log_softmax within 2e-3 of the
   single process's forward on rank 0, every rank's logits the same
   bits; 4 requests served through ``serve_model`` under the
   EP context, token for token the single process's engine; (b) bf16 at
   8 of 24 layers: prefill B=1, S=4096 timed (tokens/s against the
   single-process bf16 prefill of the same run), peak memory a rank, the
   card's busy share (the ranks' kernel time over the wall, and apart
   from it their copies' and memsets') and the all-reduce's share (a run
   with each all-reduce timed alone), the last position's logits against
   the single process's, held at LOGITS_TOL, with the count of (token,
   expert) routes that differ ((a) counts its routes too); beside it the
   noise floor of that comparison: the single process against itself
   with its experts in reverse order (``reverse_experts``: the same
   function, each token's k expert outputs added in the opposite order
   in bf16), its routes that differ and its logits' distance;
18d. the tensor-parallel split of the dense layers: the single process
   first, in this process, then four processes over the same (data 1,
   model 4) mesh, each holding its slices under ``param_specs`` (a
   quarter of the heads, ff and vocab, drawn in turns from the seed): (a)
   gemma-7b float32 at every published width, 1 of 28 layers (16/16
   heads of 256, geglu, tied embeddings): prefill B=1, S=4096 under
   ``Ctx(use_flash=True)`` on the ranks (flash once per layer, at 4/4
   heads), every position's log_softmax within 2e-3 of the single
   process's plain forward (``Ctx()``, its logits written to a file the
   ranks read), every rank's logits the same bits; paged decode fed the
   single process's greedy tokens (paged_attention once per layer and
   step), each step within 2e-3 on log_softmax and the same argmax, and
   4 requests through ``serve_model`` over the paged pool,
   token for token the single process's engine; (b) nemotron-4-340b bf16
   at every published width, 2 of 96 layers (30.4 GiB, 7.6 GiB a rank;
   96/8 heads of 192, 24/2 a rank; relu2): the single process's plain
   last logits, its flash prefill timed, its greedy paged decode and
   paged serving, then freed; on the ranks prefill B=1, S=4096, the
   median of 3 after a warm run (tokens/s beside the single process's),
   the all-reduces' and the all-gather's share of the wall (a run with
   each timed alone), the kernels' busy share (copies and memsets apart),
   peak memory a rank, the last logits within LOGITS_TOL of the single
   process's plain ones; paged decode fed its greedy tokens, each step
   within LOGITS_TOL; paged serving, the same tokens on every rank, the
   count that differ from the single process's printed;
18e. training over the (data, model) mesh on the split placement (the
   split products' backward, the loss over the split vocab, one
   all-reduce a leaf over the data axis, AdamW on each rank's slices,
   checkpoints of whole leaves): the single processes first, in this
   process, then four processes sharing the card: (a) 18a's run, qwen2-moe-a2.7b at
   every published width, 4 of 24 layers, float32 weights and moments,
   its repeated B=4 x 1,025 batch, learning rate and seed, the first 3
   of its 5 steps, over (data 1, model 4) through ``train_loop(mesh=)``:
   each step's loss and
   gradient norm within 1e-3 relative of 18a's history, every whole leaf
   the same bits on every rank after the last step, moe_gather 8 a step
   (remat's recompute) and its backward 4 on every rank and no attention
   kernel; per step its
   ms and tokens/s, then one more step with each collective timed alone
   (their share of the wall), one uninstrumented and one under the
   profiler (the ranks' kernels and, apart, their copies against the
   wall), peak memory a rank and in all; (b) gemma-7b float32 at every
   published width, 1 of 28 layers (``fsdp=False``, its only edit: it
   holds the split path without FSDP; 18f runs the published plan), 2
   steps of 4 x 256 tokens in one process and over (data 2, model 2),
   every loss and gradient norm within 1e-3 of the single process's;
18f. FSDP over the data axis at the published plans (``fsdp=True``,
   ``remat="full"``; the leaves' ``embed`` / ``ff`` / ``inner`` /
   ``vocab`` dim over ``data``, all-gathered where a layer takes them,
   inside its remat region, the gradients reduce-scattered): the single
   processes first, then four processes sharing the card: (b)
   qwen2-moe-a2.7b float32 at every published width, 1 of 24 layers, 18a's
   batch and learning rate, 1 step over (data 4, model 1) (the plain MoE
   path) against a single process at the same depth, within 1e-3, every
   collective timed alone (the gathers', reduce-scatters' and
   all-reduces' share of the wall), P3 2 and its backward 1 a rank, peak
   memory a rank and in all; (a) gemma-7b float32 at its published
   settings, 1 of 28 layers, 18e (b)'s batch: 1 step over (data 2,
   model 2) and a save of whole leaves (the files one process writes;
   every leaf but the norms split over both axes), a restart over (data
   1, model 4) under the supervisor that restores it (no step after),
   every loss and gradient norm within 1e-3 of 18e (b)'s single process,
   peak memory a rank beside 18e (b)'s; (d) gemma-7b bf16 at 2 of 28
   layers at the serve plan over (data 2, model 2): each data rank 2 of
   4 rows, a 1,024-token prefill through flash (2 a rank) and 2 paged
   decode steps (P2 2 a step), each step's last logits within LOGITS_TOL
   of the single process's;
18g. the hybrid family split over the model axis (Mamba's ``inner``:
   each rank 1/4 of the channels of every Mamba leaf, ``in_proj``'s
   output handed round by one all-to-all so that a rank holds its
   channels of ``xb`` and ``z``, ``x_proj``'s partials summed in
   float32, P4 on the rank's channels; attention and MoE as 18d and
   18c): the single processes first, in this process, then four
   processes sharing the card: (a) jamba-1.5-large bf16 at every
   published width, one group of 8 layers and 8 of its 16 experts (48.3
   GiB, 12.1 GiB a rank; 2 experts a rank) over (data 1, model 4): the
   single process's plain last logits, flash prefill, greedy paged
   decode, dense decode fed its tokens and paged serving, then freed; on
   the ranks prefill B=1, S=4096 under ``Ctx(use_flash=True)`` (P1 1, P4
   7, P3 4 a rank) after a warm run, tokens/s beside the single
   process's, the all-reduces' (bf16 and float32), the redistributions'
   and the gathers' shares of the wall (each collective timed alone, in
   the prefill and in one dense decode step, where the conv windows'
   gathers run), the kernels' busy share, peak memory a rank, the last
   logits within LOGITS_TOL; dense and paged decode fed the single
   process's greedy tokens (P3 4 a step, P2 1 on the paged pool), each
   step's rows within LOGITS_TOL where every rank's MoE routes, at that
   step and the row's earlier ones, are the single process's (a route
   that flips on the bf16 sums' order is counted, beside the flips of
   the single process with its experts reversed; at most half the rows
   may flip), the conv windows the same bits on every rank;
   paged serving, the same tokens on every rank, the count that differ
   from the single process's printed; (b) one Mamba layer at jamba's full
   width in float32 on (1, 4096, 8192) inputs: forward and backward on
   the rank's slices against the single process's ``mamba_apply`` and
   autograd on the whole leaves (each rank computes it), the output
   within 1e-5 of its largest value and each gradient slice within 1e-4
   of its leaf's largest; (c) reduced jamba at its published plan
   (``fsdp``, ``remat="full"``; ``capacity_factor`` 4.0): 2 steps and a
   save over (data 2, model 2), a restart over (data 1, model 4) for the
   third under the supervisor, every loss and gradient norm within 1e-3
   of the single process's, P4, P3 and their backwards on every rank;
18h. decode over the sequence-sharded KV cache: nemotron-4-340b bf16 at
   every published width, 2 of 96 layers, over (data 1, model 16), the
   reference's production model axis, where its 8 kv heads do not divide
   the axis (the plan's "sequence" kv strategy): the single process
   first, in this process (greedy dense decode of 16 steps at B=4 from a
   4-token prompt, paged decode of 1-token pages fed its tokens, paged
   serving), then sixteen processes sharing the card, each holding its
   slices and its span of the positions for every kv head (dense cache
   (2, 4, 1, 8, 192)) or its shard of the pool (one page of each row):
   dense and paged decode fed the single
   process's tokens, each step's logits within LOGITS_TOL, the paged
   kernel's partial mode once a layer a paged step on every rank; one
   dense step with each collective timed alone (the q all-gathers, the
   partials' all-to-alls, the all-reduces, the logits' gather); paged
   serving of 2 requests, the same tokens on every rank, those that
   differ from the single process's counted; start-up, draw, step ms
   and peak memory a rank beside the card's total;
18i. the q_dim split inside a head, run by 18h's sixteen processes once
   nemotron's leaves are freed (one spawn and one mesh start-up for
   both): qwen2.5-32b bf16 at every published width, 2 of 64 layers,
   over the same (data 1, model 16), where a rank's block of 320 of the
   5,120 q_dim columns is 2.5 heads of 128: the single process first, in
   this process (a prefill at B=1, S=512 through P1, then 18h's greedy
   dense decode, paged decode and paged serving), then on each rank its
   320 columns of ``wq``/``bq`` and rows of ``wo``, ``wk``/``wv`` whole:
   the prefill through P1 once a layer at the 3 q heads / 1 kv head its
   block overlaps (after one exchange of the edge heads' columns), its
   logits within LOGITS_TOL, again with each collective timed alone (the
   q exchange, the all-reduces, the logits' gather); dense and paged
   decode fed the single process's tokens within LOGITS_TOL, the paged
   kernel's partial mode once a layer a paged step, one dense step with
   each collective timed alone; paged serving, the same tokens on every
   rank, those that differ from the single process's counted; peak
   memory a rank and 18i's seconds;

19. the relational engine: the expression core (K1) over every (op,
   dtype pair) numpy computes at the executor's 8,192-row batch, and the
   segment reduction (K2) over sum / min / max at 3, 10,000 and 2^20 + 1
   groups (float64 with NaN payloads and +-0.0, int32 wrapping, bool, a
   (rows, 3) column; rows outside [0, n) dropped) and at linalg's shape
   ((rows, 16,384) float64 blocks into 64 groups), each bit for bit
   against numpy's bytes and its plain version, K2's sums timed by events
   and on the device; ptxas registers, stack frame and spill bytes of
   both sources (K2's chain kernel, ``ring_sums``, must have neither), no
   FMA in either's SASS but the division routines' own (as many as a
   ``-fmad=false`` build holds); the card's DADD latency (a one-thread
   chain of dependent ``__dadd_rn``) and host link rates (pinned copies
   each way); then TPC-H Q1 at scale factor 1.25 (7,498,256 lineitems,
   an eighth of SF 10's, 4 partitions) through ``Session`` /
   ``q1_pricing_summary``: the numpy
   backend once as the oracle, the torch backend warm and then 3 timed
   runs, every column byte-identical to the oracle's, K1 once per batch
   and K2 once per partition, a traced query's span split (its copies
   through pinned staging: no pageable one), K1 at the query's batch over
   both input paths (mapped pinned reads, the engine's; one staged copy)
   beside its bytes and link bounds, K2 at the first partition beside its
   bytes bound, its chain bound (the largest group's rows x the DADD
   latency) and ``scatter_reduce_``, with its kernels' device split, the
   device's busy share over one query and the peak device memory. Phase
   2 builds K1 and K2 with the other four kernels.
20. the worker runtime: the same Q1 at SF 1.25 (phase 19's set and its
   numpy answer as the oracle) through ``Session(backend="workers",
   num_workers=4, worker_kind="thread")`` on ``expr_backend="torch"``,
   the four ranks threads sharing the card: a warm run, then 3 timed
   runs, each byte-identical with K1 once per batch of every rank and K2
   once per rank holding rows; the pinned host memory; one query's busy
   share;
   then socket workers launched as threads (real TCP), traced (every
   rank's spans), byte-identical with the thread workers' per-rank
   shuffle bytes;
21. the join and top-k entry points (``customers_per_supplier``,
   ``topk_jaccard``) over ``denormalized_tpch`` at bench_oo's size on the
   local torch backend, thread and socket-thread workers, each
   byte-identical to the local numpy backend, the workers' per-rank
   shuffle bytes equal to numpy workers';
22. the query service: ``QueryService(launch="thread", num_workers=4,
   expr_backend="torch")`` over phase 19's store, a cold Q1 (SETUP bytes,
   launches as phase 20), then 4 ``Session.connect`` clients at once (2
   admitted at a time, the rest queued by the service's admission
   control), each a warm Q1 (0 SETUP bytes) and two lambda-DSL queries (the
   service refuses native lambdas, so the entry points cannot go there),
   every answer byte-identical; the cold and warm walls;
23. the tools at the reference's benchmark sizes: lilLinAlg's Gram matrix
   and multiply (n 4,096 x 32, blocks of 64) and k-means (20,000 x 32, k
   10, 3 iterations), byte-identical to the numpy backend.

Launch counts are set to 0 just before each main-path run of phases 3-23
(prefill, paged decode, paged serving, the long-context step, serving,
the training runs, each rank's EP prefill and serving, each rank's
tensor-parallel prefill, decode and serving, each rank's training runs
over the mesh and under FSDP, each FSDP rank's prefill and decode, each
hybrid rank's prefill, decode, serving, layer and training runs, each
sequence-sharded rank's decode and serving runs, the timed Q1
runs, the workers', the entry points', the service's cold Q1, the
tools') and read just after it. The last two lines are a JSON object
with one entry per ported kernel and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

ARCH = "qwen25_32b"
MOE_ARCH = "qwen2_moe"
HYBRID_ARCH = "jamba15_large"
# the other model families, every published width and full depth but
# xlstm's, after the three above: (registry name, label)
OTHER_ARCHS = [("gemma_7b", "gemma"), ("phi3_mini", "phi3"),
               ("internvl2_26b", "vlm"), ("whisper_small", "audio"),
               ("xlstm_125m", "ssm")]
# xlstm-125m cut to 4 of its 12 blocks (one sLSTM block of its three):
# the eager sLSTM steps of its prefill took 50-66 s of the run, and the
# run's time goes to phases 20-23 within its 1,200 s
OTHER_CUTS = {"xlstm_125m": {"n_layers": 4}}
# jamba-1.5-large's cuts (its widths are all published values): 72 -> 8
# layers (one group; the stack runs whole groups) and 16 -> 12 experts.
# One group at 16 experts is 84.3 GiB of bf16 weights: it cannot fit one
# card; at 12, 66.3 GiB. Phase 18g runs the same group split over four
# ranks at 8 experts (48.3 GiB, 12.1 GiB a rank): at 12 the four CUDA
# contexts, the whole leaf that ``init_shards`` draws (the 4 MoE layers'
# w_up, 19.3 GB at 12 experts) and the prefill's activations leave too
# little room beside 66.3 GiB on the 80 GB card.
HYBRID_CUTS = {"n_layers": 8, "n_experts": 12}
DEVICE = "cuda"
SEED = 0
PREFILL_SEQ = 4096
# whisper's prefill: B=8 sequences of its published decoder context (448
# tokens), each over the encoder's 1,500 frames
AUDIO_BATCH, AUDIO_SEQ = 8, 448
# xlstm's prefill is ~310,000 eager launches (the sLSTM's 12,288 steps);
# the profiler took ~150 s over them, so its breakdown covers the first
# SSM_PROFILE_SEQ tokens, whose steps are the same ops
SSM_PROFILE_SEQ = 512
KERNEL_CASES = [  # (name, B, S, T, H, K, hd, causal, dtype)
    ("prefill", 1, PREFILL_SEQ, PREFILL_SEQ, 40, 8, 128, True, "bfloat16"),
    ("moe_prefill", 1, PREFILL_SEQ, PREFILL_SEQ, 16, 16, 128, True,
     "bfloat16"),
    # the head dims of phi3-mini (32/32 heads), nemotron-4-340b (96/8) and
    # gemma-7b (16/16) at their prefill heads
    ("prefill_hd96", 1, PREFILL_SEQ, PREFILL_SEQ, 32, 32, 96, True,
     "bfloat16"),
    ("prefill_hd192", 1, PREFILL_SEQ, PREFILL_SEQ, 96, 8, 192, True,
     "bfloat16"),
    ("prefill_hd256", 1, PREFILL_SEQ, PREFILL_SEQ, 16, 16, 256, True,
     "bfloat16"),
    # internvl2-26b's prefill heads (48/8: G=6) and whisper-small's decoder
    # self-attention (12/12, hd 64, S=448: a ragged last tile)
    ("prefill_vlm", 1, PREFILL_SEQ, PREFILL_SEQ, 48, 8, 128, True,
     "bfloat16"),
    ("prefill_audio", AUDIO_BATCH, AUDIO_SEQ, AUDIO_SEQ, 12, 12, 64, True,
     "bfloat16"),
    ("ragged", 1, 1000, 1000, 40, 8, 128, True, "bfloat16"),
    ("cross", 2, 512, 1536, 40, 8, 128, False, "bfloat16"),
    ("f32", 1, 1024, 1024, 8, 2, 128, True, "float32"),
    # the float32 instance at qwen2-moe's prefill, as the expert-parallel
    # phase's float32 ranks run it
    ("moe_prefill_f32", 1, PREFILL_SEQ, PREFILL_SEQ, 16, 16, 128, True,
     "float32"),
    # a rank's heads at the tensor-parallel phases' prefill (a quarter of
    # them): nemotron-4-340b's 24/2 at hd 192, gemma-7b's float32 4/4 at hd
    # 256, qwen2-moe's 4/4 at hd 128 in float32 ((a) of 18c) and bf16
    ("tp_hd192", 1, PREFILL_SEQ, PREFILL_SEQ, 24, 2, 192, True, "bfloat16"),
    ("tp_hd256_f32", 1, PREFILL_SEQ, PREFILL_SEQ, 4, 4, 256, True,
     "float32"),
    ("tp_moe_f32", 1, PREFILL_SEQ, PREFILL_SEQ, 4, 4, 128, True, "float32"),
    ("tp_moe", 1, PREFILL_SEQ, PREFILL_SEQ, 4, 4, 128, True, "bfloat16"),
    # a rank's heads in 18i's prefill: the 3 q heads (1 kv head) that
    # qwen2.5-32b's block of 320 q_dim columns overlaps over 16 ranks
    ("tp_qdim", 1, 512, 512, 3, 1, 128, True, "bfloat16"),
]
# moe_gather at qwen2-moe's dispatch shapes: T tokens of width d into
# S = 60 experts x capacity slots, T*top_k = n_kept of them filled.
GATHER_CASES = [  # (name, T, d, S, n_kept, dtype)
    ("prefill", PREFILL_SEQ, 2048, 60 * 344, 4 * PREFILL_SEQ, "bfloat16"),
    ("decode", 4, 2048, 60 * 8, 16, "bfloat16"),
    # one rank's dispatch in the expert-parallel phase: its 15 of the 60
    # experts, a quarter of the prefill's top-4 slots
    ("ep_local", PREFILL_SEQ, 2048, 15 * 344, PREFILL_SEQ, "bfloat16"),
    ("ragged_f32", 100, 48, 333, 250, "float32"),
    # rows of 2,002 bytes, not whole 16-byte words: copied element by
    # element (the kernel's other instance)
    ("odd_bf16", 100, 1001, 333, 250, "bfloat16"),
]
# ssm_scan at jamba's prefill shape (Bt, L, di, N) and a ragged one (L
# not a multiple of the 16-step chunk, di not of a block's channels)
SCAN_CASES = [  # (name, Bt, L, di, N)
    ("prefill", 1, PREFILL_SEQ, 16384, 16),
    ("ragged", 2, 1001, 3000, 16),
    # one rank's channels of jamba's prefill in phase 18g: di 16,384 over
    # a model axis of 4
    ("tp_rank", 1, PREFILL_SEQ, 4096, 16),
]
SCAN_TOL = 1e-5  # as tests/test_kernels.py holds the Pallas scan
# The training phase: qwen2-moe-a2.7b at every published width, cut to
# TRAIN_LAYERS of its 24 layers: float32 weights and AdamW moments are 16
# bytes a parameter, ~2.90 B parameters (43.3 GiB) at 4 layers beside
# ~10 GiB of activations, where all 24 (14.3 B) would need ~213 GiB; B x
# (S + 1) = TRAIN_BATCH x (TRAIN_SEQ + 1) tokens, TRAIN_STEPS steps on one
# repeated batch. The reference's peak learning rate (3e-4) overshoots at
# this width when 5 steps leave its warmup one step (max(1, 5 // 20)):
# ``python -m repro_torch.launch.train --arch qwen2_moe --layers 4 --steps
# 5 --batch 4 --seq 1024 --records 4`` gave losses 12.41, 12.41, 16.02,
# 13.02, 12.93 on an H100 80GB HBM3 at 700 W; at TRAIN_LR the loss falls
# every step after the first.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 1024, 5
# this run without remat (an H100 80GB HBM3 at 700 W): one step and the
# peak memory
NO_REMAT_STEP_MS, NO_REMAT_PEAK_GIB = 646.6, 53.66
TRAIN_LR = 3e-5
TRAIN_PEAK_GIB = 75
TRAIN_TOKENS = TRAIN_BATCH * (TRAIN_SEQ + 1)
# reduced_config training on the card against the same port run on the
# CPU (same weights and batches): losses within TRAIN_LOSS_TOL relative,
# step for step; then RESTART_ARCH with a checkpoint every RESTART_EVERY
# steps and a failure injected before step RESTART_FAIL_AT
REDUCED_TRAIN = ["qwen2_moe", "jamba15_large", "xlstm_125m"]
REDUCED_STEPS, REDUCED_BATCH, REDUCED_SEQ = 8, 4, 64
TRAIN_LOSS_TOL = 1e-3
RESTART_ARCH = "jamba15_large"
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 12, 4, 6
# The expert-parallel phase: qwen2-moe-a2.7b over a (data 1, model 4) mesh
# of EP_WORLD processes sharing the one card, each holding its slices under
# ``Model.param_specs`` (a quarter of the heads, ff and vocab, and 15 of
# the 60 experts), drawn in turns from SEED (``Model.init_shards``); (a)
# float32 at every published width
# and EP_F32_LAYERS of 24 layers (~0.44 B parameters a rank), held within EP_TOL of the single process's
# log_softmax at every position, and token for token when serving; (b)
# bf16 at all 24 layers (~4.97 B parameters a rank), timed against the
# single-process bf16 forward of the same run, its last logits held at
# LOGITS_TOL of the single process's.
EP_MESH = (1, 4)
EP_WORLD = 4
# every serving run: 8 requests of 2-7 prompt tokens at batch 4, each
# running to max_seq - 1 = SERVE_MAX_NEW + 15 tokens (19, two pages of
# PAGE_SIZE), so the second four reuse the first four's slots and pages;
# 38 steps (46 at 8 until phase 18h came in, 94 at 32 before the smoke
# first outgrew its time limit)
SERVE_MAX_NEW = 4
EP_F32_LAYERS = 2
# (b)'s depth: 8 of 24 layers since phase 18h came in (all 24 before)
EP_BF16_LAYERS = 8
EP_TOL = 2e-3  # tests/test_multidevice.py's bound on log_softmax
EP_AUX_RTOL = 1e-4  # one aux of (a)'s prefill against the single process's
EP_WALL_S = 600  # the four ranks' run, and each collective's timeout
# the mesh phases' serving runs (18c, 18d, 18g): 4 of those requests, one
# batch, 19 steps (8 requests and 46 steps until phase 18h came in: the
# smoke took 1,162 s on an H100 80GB HBM3 at 700 W)
EP_SERVE = {"n_requests": 4, "max_new": SERVE_MAX_NEW, "batch_size": 4}
# The tensor-parallel phase over the same mesh: (a) TP_F32_ARCH float32 at
# TP_F32_LAYERS of its 28 layers; (b)
# TP_BF16_ARCH bf16 at TP_BF16_LAYERS of its 96 layers (30.45 GiB, 7.61
# GiB a rank; the largest whole leaf drawn, the embedding, 8.79 GiB).
# Paged decode of TP_DECODE_STEPS steps at TP_DECODE_BATCH rows, the first
# TP_PROMPT tokens drawn from SEED and the rest the single process's
# greedy choices; (b)'s prefill timed TP_TIMED times after a warm run.
# (a) at 1 layer since phase 18h came in (2 before)
TP_F32_ARCH, TP_F32_LAYERS = "gemma_7b", 1
TP_BF16_ARCH, TP_BF16_LAYERS = "nemotron4_340b", 2
# 8 decode steps (12 until phase 18h came in; at 6 the prompts SEED draws
# differ and 18g's first route flip fell at 0.057 of the router's std,
# past TPH_TIE, on an H100 80GB HBM3 at 700 W)
TP_DECODE_BATCH, TP_PROMPT, TP_DECODE_STEPS = 4, 4, 8
TP_TIMED = 3
# Training over the mesh (phase 18e), ranks sharing the card as in 18c
# and 18d: (a) the training phase's run (MOE_ARCH at every published
# width, TRAIN_LAYERS layers, float32 weights and moments, the same
# repeated batch, learning rate and seed) over the (data 1, model 4)
# mesh, each of its MT_A_STEPS steps' loss and gradient norm held within
# TRAIN_LOSS_TOL of phase 18a's; (b) MT_B_ARCH at every published width,
# MT_B_LAYERS of 28 layers, float32, with ``fsdp=False`` (the config's
# only edit: it holds the split path without FSDP, 18f runs the
# published plan), MT_B_STEPS steps of MT_B_BATCH x (MT_B_SEQ + 1)
# tokens in one process and over MT_B_MESH. The mesh checkpoint at full
# width is 18f (a)'s (its save over (data 2, model 2), its restart's
# over (data 1, model 4)), reduced jamba's over a data axis 18g (c)'s:
# 18e (b)'s own save and restart (62 s of the smoke's 1,087 s on an H100
# 80GB HBM3 at 700 W) and the reduced jamba runs over (data 2, model 1)
# of 18e (c) and 18f (c) went when the smoke outgrew its time limit.
MT_A_MESH = (1, 4)
# (a) runs the first MT_A_STEPS of 18a's TRAIN_STEPS (step 2's loss takes
# in step 1's update; lr is 0 at step 0)
MT_A_STEPS = 3
MT_B_ARCH, MT_B_LAYERS = "gemma_7b", 1
# (2 steps and a save after 1 since phase 18h came in; 3 and 2 before)
MT_B_BATCH, MT_B_SEQ, MT_B_STEPS, MT_B_SAVE = 4, 255, 2, 1
MT_B_MESH = (2, 2)
# FSDP over the data axis (phase 18f), ranks sharing the card as in 18e,
# every model at its published plan (``fsdp=True``, ``remat="full"``):
# (a) MT_B_ARCH as 18e (b) runs it but for its config, MT_B_SAVE steps and
# a save over FSDP_A_MESHES[0], a restart over FSDP_A_MESHES[1] for the
# rest (and its save there), against 18e (b)'s single process; (b)
# MOE_ARCH float32 at every published width, FSDP_B_LAYERS of 24 layers,
# 18a's batch and learning rate, FSDP_B_STEPS steps over FSDP_B_MESH
# (pure FSDP: the plain MoE path) against a single process at the same
# depth, every collective timed alone; (d) serving MT_B_ARCH bf16 at
# FSDP_D_LAYERS of 28 layers at the serve plan over FSDP_D_MESH: each
# data rank a row of a FSDP_D_SEQ-token prefill through flash, then
# FSDP_D_STEPS paged decode steps, each step's logits against the single
# process's.
# (a)'s restart over (1, 4), not (4, 1): its step there took 21.4 s of
# gathers (an H100 80GB HBM3 at 700 W), and pure FSDP is (b)'s
FSDP_A_MESHES = ((2, 2), (1, 4))
# (b) at 1 layer: at 2 the phase took 256-271 s (an H100 80GB HBM3 at
# 700 W), the embedding's and head's gathers more than the layers'; and
# 1 step since phase 18g came in (the smoke took 1,071 s; the second step
# took 19.9 s and, warmup-cosine's lr being 0 at step 0, repeated the
# first's loss)
FSDP_B_LAYERS, FSDP_B_STEPS, FSDP_B_MESH = 1, 1, (4, 1)
# (d) 2 decode steps since phase 18h came in (4 before)
FSDP_D_LAYERS, FSDP_D_MESH, FSDP_D_SEQ, FSDP_D_STEPS = 2, (2, 2), 1024, 2
# The hybrid family split over the model axis (phase 18g), ranks sharing
# the card as in 18c-18f: (a) HYBRID_ARCH bf16 at every published width
# cut by TPH_CUTS (one group; 8 of 16 experts, 2 a rank under expert
# parallelism: see HYBRID_CUTS) over EP_MESH, against the single process;
# (b) one Mamba layer at full width in float32 on (1, PREFILL_SEQ,
# d_model) inputs, forward and backward on the ranks against the single
# process's, the output within TPH_OUT_TOL of its largest value and each
# gradient slice within TPH_GRAD_TOL of its leaf's largest
# (tests/test_torch_mesh_train.py's bounds); (c) reduced HYBRID_ARCH at
# its published plan, TPH_C_SAVE steps and a save over TPH_C_MESHES[0],
# a restart over TPH_C_MESHES[1] to step TPH_C_STEPS.
TPH_CUTS = {"n_layers": 8, "n_experts": 8}
# (a)'s decode: a MoE route of a rank may differ from the single
# process's only where the single process's top_k-th and next router
# logits lie within TPH_TIE of the logits' standard deviation: the bf16
# sums' order moves the residual by ~1-2% (the prefill's last logits
# within 0.024 of the largest); the rows before their first flip are held
# at LOGITS_TOL
TPH_TIE = 0.05
TPH_OUT_TOL, TPH_GRAD_TOL = 1e-5, 1e-4
TPH_C_MESHES = ((2, 2), (1, 4))
TPH_C_SAVE, TPH_C_STEPS = 2, 3
# Decode over the sequence-sharded cache (phase 18h): TP_BF16_ARCH in bf16
# at every published width, TP_BF16_LAYERS layers (18d (b)'s cut), over
# (data 1, model KVS_WORLD), the reference's production model axis, whose
# 16 ranks its 8 kv heads do not divide: the plan's "sequence" kv
# strategy, each rank caching its span of the positions for every kv head
# (or its shard of the paged pool). KVS_BATCH rows, a KVS_PROMPT-token
# prompt drawn from SEED, KVS_STEPS steps over a dense cache of KVS_STEPS
# positions and over the paged pool of KVS_PAGE-token pages: each of the
# 16 ranks holds one position of each row in both (64 steps of 4-token
# pages took 2.6 s a dense step and 0.86 s a paged one over the 16 gloo
# ranks, 292 s in all: an H100 80GB HBM3 at 700 W); paged serving of
# KVS_SERVE.
KVS_MESH = (1, 16)
KVS_WORLD = 16
KVS_BATCH, KVS_PROMPT, KVS_STEPS, KVS_PAGE = 4, 4, 16, 1
KVS_SERVE = {"n_requests": 2, "max_new": SERVE_MAX_NEW, "batch_size": 2}
# The q_dim split inside a head (phase 18i, run by 18h's ranks once
# nemotron's leaves are freed): ARCH in bf16 at every published width,
# QDIM_LAYERS of its 64 layers, over the same (data 1, model 16), where
# its 40 heads of 128 give each rank a block of 320 q_dim columns, 2.5
# heads: a rank computes the 3 heads its block overlaps (one kv head). A
# prefill of QDIM_SEQ tokens at B=1 through P1, then 18h's decode and
# serving.
QDIM_LAYERS, QDIM_SEQ = 2, 512
# moe_gather's backward at the training step's dispatch (TRAIN_TOKENS
# tokens into 60 experts x 344 slots, top-4), float32 as trained and bf16
GATHER_BWD_CASES = [  # (name, T, d, S, n_kept, dtype)
    ("train", TRAIN_TOKENS, 2048, 60 * 344, 4 * TRAIN_TOKENS, "float32"),
    ("train_bf16", TRAIN_TOKENS, 2048, 60 * 344, 4 * TRAIN_TOKENS,
     "bfloat16"),
]
# and, checked but not timed, maps past the kernel's fan of 8 slots a
# token: 10 slots a token, and ~38 (a second word of the ballot's walk)
GATHER_BWD_WIDE = [  # (T, d, S, n_kept, dtype)
    (8, 7, 100, 80, "float32"), (4, 2048, 200, 150, "float32"),
    (4, 2048, 200, 150, "bfloat16"),
]
# ssm_scan's backward at jamba's full Mamba shape and at the reduced
# training run's (B=4 rows of 65 steps, di 128, N 8)
SCAN_BWD_CASES = [  # (name, Bt, L, di, N)
    ("jamba", 1, PREFILL_SEQ, 16384, 16),
    ("reduced", REDUCED_BATCH, REDUCED_SEQ + 1, 128, 8),
    ("tp_rank", 1, PREFILL_SEQ, 4096, 16),  # a rank's channels, as above
]
# float32; the kernel decays by ex2 and sums in another order than the
# plain loop's autograd: max |err| per output within 1e-4 of its largest
SCAN_BWD_TOL = 1e-4
SCAN_BWD_REPS = 20  # calls a timing: the reduced shape's are host-bound
# paged_attention at the decode shapes: qwen2.5-32b (40/8 heads, 4,096
# tokens of 64-token pages), jamba (64/8 heads, 128-token pages) and
# qwen2-moe (16/16), lengths drawn in [1, max_pages * page], tables a
# random permutation of a pool max_pages pages larger than they need; the
# head dims of the reference's other configs (phi3-mini 96 at 32/32 heads,
# nemotron-4-340b 192 at 96/8, gemma-7b 256 at 16/16); a ragged float32
# case with a hole inside a row and a row of holes only; and the shape of
# the long-context decode step below (its span plan), in bf16 and in
# float32 with holes, lengths drawn in LONG_LENGTHS; internvl2-26b's decode
# heads (48/8: G=6); gemma-7b's (16/16, hd 256) read as the last layer's
# view of a pool of its 28 layers (POOL_LAYERS: the other layers zeros).
# The long-context paged decode step on the loaded qwen2.5-32b weights:
# B rows of LONG_LENGTHS cached tokens in pages of LONG_PAGE, LONG_STEPS
# steps (the pool holds LONG_SEQ tokens a row, room for the steps).
LONG_BATCH, LONG_SEQ, LONG_PAGE, LONG_STEPS = 4, 4096, 64, 5
LONG_LENGTHS = (4000, LONG_SEQ - LONG_STEPS)
PAGED_CASES = [  # (name, B, H, K, hd, page, max_pages, dtype, holes,
    #                lengths drawn in [lo, hi) or None for [1, the table])
    ("decode", 32, 40, 8, 128, 64, 64, "bfloat16", False, None),
    ("jamba", 8, 64, 8, 128, 128, 32, "bfloat16", False, None),
    ("moe", 4, 16, 16, 128, 64, 8, "bfloat16", False, None),
    ("hd96", 8, 32, 32, 96, 64, 64, "bfloat16", False, None),
    ("hd192", 8, 96, 8, 192, 64, 64, "bfloat16", False, None),
    ("hd256", 8, 16, 16, 256, 64, 64, "bfloat16", False, None),
    ("vlm", 32, 48, 8, 128, 64, 64, "bfloat16", False, None),
    ("gemma_pool", 8, 16, 16, 256, 64, 16, "bfloat16", False, None),
    ("ragged", 6, 10, 2, 64, 16, 9, "float32", True, None),
    ("long", LONG_BATCH, 40, 8, 128, LONG_PAGE, LONG_SEQ // LONG_PAGE,
     "bfloat16", False, LONG_LENGTHS),
    ("long_f32", LONG_BATCH, 40, 8, 128, LONG_PAGE, LONG_SEQ // LONG_PAGE,
     "float32", True, LONG_LENGTHS),
    # a rank's decode heads in the tensor-parallel phase's paged decode and
    # serving (pages of 16, 2 a 24-token sequence): nemotron-4-340b's 24/2
    # at hd 192 and gemma-7b's float32 4/4 at hd 256
    ("tp_hd192", 4, 24, 2, 192, 16, 2, "bfloat16", False, None),
    ("tp_hd256_f32", 4, 4, 4, 256, 16, 2, "float32", False, None),
]
POOL_LAYERS = {"gemma_pool": 28}
# the paged kernel's partial mode at one rank's share of a long context
# split over the sequence: nemotron-4-340b's decode heads (96/8, hd 192),
# B rows of ``tokens`` in pages of ``page``, cut into ``shards`` shards by
# the round-robin rule (shard_layout)
PARTIAL_CASES = [  # (name, B, H, K, hd, page, tokens, shards, dtype)
    ("shard", 4, 96, 8, 192, 64, 4096, 16, "bfloat16"),
    ("shard_f32", 4, 96, 8, 192, 64, 4096, 16, "float32"),
]
PAGE_SIZE = 16  # paged serving: a 19-token sequence spans 2 pages
# the relational kernels launch nowhere on a model's path, the backward
# kernels nowhere but in training
NO_RELATIONAL = {"expr_core": 0, "segment_reduce": 0}
NO_BACKWARD = {"moe_gather_bwd": 0, "ssm_scan_bwd": 0}
# the paged kernel's partial mode runs only over a pool split over the
# sequence (phase 18h)
NO_PARTIAL = {"paged_attention_partial": 0}
# phase 19, the relational engine: TPC-H Q1 at scale factor 1.25 (an
# eighth of the spec's 59,986,052 lineitem rows at scale factor 10: with
# the mesh-training phase the whole run came within 72 s of its 1,200 s
# limit at SF 10 and within 98 s at SF 5 on slow hosts; SF 2.5 until phase
# 18h came in) over the executor's 4
# partitions; K1's op x dtype matrix at the executor's batch of 8,192
# rows; K2's cases (name, rows, groups)
Q1_ROWS = 59_986_052 // 8
Q1_PARTITIONS = 4
Q1_TIMED = 3
EXPR_ROWS = 8192
SEGMENT_CASES = [  # (name, rows, groups, inner: None for the column mix)
    ("3 groups", 200_000, 3, None), ("10k groups", 200_000, 10_000, None),
    ("2^20+1 groups", 1_500_000, 2**20 + 1, None),
    ("linalg blocks", 1024, 64, 16_384)]
DADD_STEPS = 1 << 23  # the DADD latency probe's chain
K2_KERNELS = ("count_digits", "scan_tiles", "scan_tile_sums", "scan_apply",
              "scatter_digits", "group_starts", "gather_lanes",
              "piece_partials", "finish", "ring_sums")  # segment_reduce.cu
# phases 20-23: the worker runtime, the query service and the tools on
# the torch backend, the WORKERS ranks threads sharing the card; Q1 over
# the workers is timed WORKERS_TIMED times; the entry
# points over denormalized_tpch at benchmarks/bench_oo.py's largest size
# (1,600 customers, seed 1, k 16); the tools at benchmarks/bench_linalg.py
# :28 (n 4,096, blocks of 64; its wider dims, 32) and bench_ml.py:20
WORKERS = 4
WORKERS_TIMED = 3
TPCH_CUSTOMERS = 1600
TPCH_TOPK = 16
SERVICE_CLIENTS = 4
# the service admits SERVICE_ADMITTED of the clients' queries at once and
# queues the rest: all four at once took 82-137 s, 5-9x one query, in
# four runs (a new query thread pays the first-run cost that phase 20's
# warm run shows, ~2x)
SERVICE_ADMITTED = 2
LINALG_ROWS, LINALG_DIM, LINALG_BLOCK = 4096, 32, 64
KMEANS_POINTS, KMEANS_DIM, KMEANS_K, KMEANS_ITERS = 20_000, 32, 10, 3
# the relational kernels' operations (float64, integer, compares) run on
# CUDA cores, at most at the H100's float32 rate (NVIDIA's data sheet,
# 67 TFLOP/s; float64 is slower), so their time is at least count / rate
PEAK_OPS_CUDA_CORES = 67e12
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: no tensor cores
PEAK_BYTES = 3.35e12
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
# paged_attention's bf16 output against the float32 answer on the same
# inputs, per (sequence, head) row: max |err| over the row's largest
# |value|. The output's rounding costs at most 2^-8 of a value and the
# kernel's bf16 P about as much again, so ~8e-3 at worst; a page lost at a
# span's edge moves a 4,000-token row by a few 1e-2 of its scale.
PAGED_ROW_TOL = 1e-2
# Full-depth bf16 logits of two paths that round at different places
# (flash rounds unnormalised P to bf16, the plain path normalised weights;
# decode and prefill run matmuls of other shapes): max |a - b| over the
# largest |b|. 64 layers of bf16 (2^-9 relative rounding each) give ~1e-2.
LOGITS_TOL = 5e-2


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def single_call_ms(torch, fn, before, reps: int = 30) -> float:
    """Median device time of one call of fn, each after ``before`` (which
    sets the L2 cache's state), by CUDA events around the call alone."""
    times = []
    for _ in range(reps):
        before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def attention_bound_ms(B, S, T, H, K, hd, causal, dtype, elem):
    """(ms, "operations" | "bytes"): the least time for the work these
    inputs need, 4*hd operations per (query, visible key) pair and head
    (q.k and p.v), against reading q, k, v once and writing o once."""
    if causal:
        pairs = sum(min(i + 1, T) for i in range(S))
    else:
        pairs = S * T
    flops = 4.0 * hd * pairs * B * H
    nbytes = elem * (2 * B * S * H * hd + 2 * B * T * K * hd)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_bound_ms(lengths, tables, page, H, K, hd, dtype, elem,
                   partial: bool = False):
    """(ms, "operations" | "bytes"): the K and V rows of every valid
    position read once (a row with no valid position reads V of each
    distinct page it gathers, for the reference's uniform mean; in the
    ``partial`` mode nothing), q read and the output written once (in the
    partial mode float32, with its (max, sum)); against 4*hd operations
    per (query head, valid position) (q.k and p.v)."""
    row = K * hd * elem  # bytes of one token's K (or V) row, all kv heads
    out_row = 4 * (hd + 2) if partial else hd * elem
    nbytes = len(lengths) * H * (hd * elem + out_row)
    positions = 0
    for length, ids in zip(lengths, tables):
        held = [j for j in range(min(-(-int(length) // page), len(ids)))
                if ids[j] >= 0]
        valid = sum(min(page, int(length) - j * page) for j in held)
        if valid:
            nbytes += 2 * valid * row
            positions += valid
        elif not partial:
            nbytes += len({max(int(i), 0) for i in ids}) * page * row
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 4.0 * hd * H * positions / PEAK_FLOPS[dtype]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_name(mangled: str) -> str:
    """``flash_fwd_bf16<128>`` or ``ssm_scan_kernel<4, true>`` from a
    kernel's mangled name (a length-prefixed name in an anonymous
    namespace, int or bool template arguments); the mangled name where it
    is not of that form."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)(.*)", mangled)
    if not m:
        return mangled
    n, rest = int(m.group(1)), m.group(2)
    name, rest = rest[:n], rest[n:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not args:
        return name
    shown = [v if t == "i" else ("true" if v == "1" else "false")
             for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return f"{name}<{', '.join(shown)}>"


def ptxas_report(log_path) -> list:
    """[(kernel, registers, spill bytes, stack frame bytes)] for each entry
    function of an nvcc build log (``-Xptxas -v``)."""
    out, fn, spill, stack = [], None, 0, 0
    for line in open(log_path).read().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill, stack = kernel_name(m.group(1)), 0, 0
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            stack = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill, stack))
            fn = None
    return out


def sass_function_counts(lib, match: str, opcodes) -> dict:
    """For each kernel of the library whose mangled name holds ``match``
    (every kernel for ""): its SASS instruction count and how many of them
    are each opcode (``cuobjdump -sass``, from the toolkit beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_name(m.group(1)) if match in m.group(1) else None
            if name:
                out.setdefault(name, {"instructions": 0,
                                      **{op: 0 for op in opcodes}})
            continue
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[name]["instructions"] += 1
            for op in opcodes:
                out[name][op] += f" {op}" in line
    return out


def rel_err(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def device_ms(torch, fn, reps: int, match: str,
              launches: Optional[int] = None) -> Optional[float]:
    """Device time per call of the kernels whose name holds ``match``,
    over reps calls of fn under torch.profiler: the card's share of what
    ``cuda_ms`` times, without the host's launch path. One call runs
    under the profiler's warmup step, whose events it drops, before the
    reps recorded ones. The profiler can miss launches, and a trace that
    lacks some reads too short a time, so the trace is taken again once,
    and None comes back, if it holds fewer than reps launches of such
    kernels, or not ``launches`` a call where that count is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and match in e.key]
        seen = sum(e.count for e in events)
        if seen >= reps if launches is None else seen == reps * launches:
            return sum(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)
                       for e in events) / 1e3 / reps
        log(f"[profiler] a trace of {reps} calls holds "
            f"{json.dumps({e.key[:60]: e.count for e in events})} launches "
            f"of {match!r} kernels, want {launches or 'at least 1'} a "
            f"call: not read")
    return None


def on_device(dev_ms: Optional[float], ms: float) -> str:
    """``device_ms``'s reading beside the events' time as the logs print
    it: the device time and its share, or that it was not measured."""
    if dev_ms is None:
        return "the device's share not measured"
    return f"{dev_ms:.4f} ms of it on the device, {dev_ms / ms:.1%}"


def device_breakdown(torch, fn, wall_s: float, label: str,
                     top: int = 6) -> tuple:
    """Run fn once under torch.profiler and print the kernels' device time
    against ``wall_s`` (the same work timed without the profiler): the
    device's busy share, and the kernels that take most of it. Returns the
    device seconds and {kernel name: device seconds}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    busy = sum(dev_us(e) for e in kernels) / 1e6
    log(f"[{label}] device: {busy * 1e3:.1f} ms of kernels in "
        f"{wall_s * 1e3:.1f} ms wall: busy {busy / wall_s:.1%}, idle "
        f"{1 - busy / wall_s:.1%}; {sum(e.count for e in kernels)} launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"[{label}]   {dev_us(e) / 1e3:8.2f} ms {dev_us(e) / 1e6 / busy:6.1%}"
            f" x{e.count:<5d} {e.key[:70]}")
    return busy, {e.key: dev_us(e) / 1e6 for e in kernels}


# ---------------------------------------------------------------- phase 1
def phase_environment(torch) -> str:
    nvcc = subprocess.run(
        [_nvcc_path(), "--version"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[-1]
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc}")
    log(f"[env] card: {smi} (count {torch.cuda.device_count()})")
    log("[env] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


def _nvcc_path() -> str:
    from repro_torch.kernels import nvcc
    return nvcc.nvcc_path()


# ---------------------------------------------------------------- phase 2
def phase_kernel(torch) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as mg
    from repro_torch.kernels import nvcc, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import attention_ref

    t0 = time.perf_counter()
    modules = (fa, mg, ss, pa, ec, sr)
    libs = nvcc.compile_all([m.SOURCE for m in modules])
    for m in modules:
        m.build()
    names = ", ".join(os.path.relpath(m.SOURCE, ROOT) for m in modules)
    log(f"[kernel] built {names} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for lib in libs:
        for fn, regs, spill, _ in ptxas_report(lib.with_suffix(".log")):
            log(f"[kernel] ptxas {lib.stem}: {fn}: {regs} registers, "
                f"{spill} bytes of spill (stores + loads)")
    flash_lib = libs[modules.index(fa)]
    sass = {op: sum(c[op] for c in sass_function_counts(
        flash_lib, "", ("HGMMA", "UTMALDG", "UTMASTG")).values())
        for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    log(f"[kernel] SASS of {flash_lib.name}: {json.dumps(sass)}")
    if not (sass["HGMMA"] and sass["UTMALDG"]):
        raise AssertionError("the flash kernel issues no wgmma or TMA load")
    for m, kernel in ((ss, "ssm_scan_kernel"), (mg, "moe_gather_rows"),
                      (ss, "ssm_scan_bwd"), (mg, "moe_gather_bwd_rows")):
        lib = libs[modules.index(m)]
        spills = [(fn, spill) for fn, _, spill, _ in ptxas_report(
            lib.with_suffix(".log")) if fn.startswith(kernel) and spill]
        if spills:
            raise AssertionError(f"{kernel} spills: {spills}")
    scan_sass = sass_function_counts(libs[modules.index(ss)],
                                     "ssm_scan_kernel",
                                     ("MUFU.EX2", "UTMALDG", "UTMASTG"))
    for fn, counts in scan_sass.items():
        log(f"[kernel] SASS of {fn}: {json.dumps(counts)} (16 unrolled "
            f"steps: one MUFU.EX2 a state step)")
    if not all(c["MUFU.EX2"] and c["UTMALDG"] for c in scan_sass.values()):
        raise AssertionError("the scan kernel has no ex2 or TMA load")
    bwd_sass = sass_function_counts(libs[modules.index(ss)],
                                    "ssm_scan_bwd_kernel",
                                    ("MUFU.EX2", "UTMALDG", "UTMASTG",
                                     "SHFL"))
    for fn, counts in bwd_sass.items():
        log(f"[kernel] SASS of {fn}: {json.dumps(counts)} (a chunk of 8 "
            f"steps unrolled: one MUFU.EX2 a state step of a lane)")
    if not all(c["MUFU.EX2"] and c["UTMALDG"] and c["UTMASTG"]
               for c in bwd_sass.values()):
        raise AssertionError("the scan's backward has no ex2, TMA load or "
                             "TMA store")

    rng = np.random.default_rng(SEED)
    results = {}
    for name, B, S, T, H, K, hd, causal, dtype in KERNEL_CASES:
        dt = getattr(torch, dtype)

        def mk(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(DEVICE, dt)

        q, k, v = mk(B, S, H, hd), mk(B, T, K, hd), mk(B, T, K, hd)
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = KERNEL_TOL[dtype]
        bad = (out.float() - want.float()).abs() > tol + tol * want.float().abs()
        if not torch.isfinite(out).all() or bool(bad.any()):
            raise AssertionError(f"kernel case {name}: max |err| {err:.3g} "
                                 f"outside atol=rtol={tol}")
        del want
        ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                        causal=causal), 20)
        dev_ms = device_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal), 20, "flash_fwd")
        plain_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal),
                           3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        bound, bound_by = attention_bound_ms(B, S, T, H, K, hd, causal,
                                             dtype, q.element_size())
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by)
        log(f"[kernel] {name}: B={B} S={S} T={T} H={H} K={K} hd={hd} "
            f"causal={causal} {dtype}: max|err| {err:.3g} (tol {tol}) "
            f"kernel {ms:.4f} ms by events ({on_device(dev_ms, ms)}), "
            f"plain {plain_ms:.3f} ms, "
            f"sdpa (library_ms) {lib_ms:.4f} ms, bound {bound:.4f} ms by "
            f"{bound_by} "
            f"(roofline share {bound / ms:.1%})")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    log(f"[kernel] kernels: {json.dumps(ops.launch_counts())}")
    return results


def phase_gather(torch) -> dict:
    """moe_gather against its plain version, bit for bit, at the dispatch
    shapes of qwen2-moe's prefill and decode and a ragged float32 one."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_gather_ref
    from repro_torch.launch.bounds import gather_bound_ms

    rng = np.random.default_rng(SEED)
    results = {}
    for name, T, d, S, n_kept, dtype in GATHER_CASES:
        x = torch.from_numpy(rng.standard_normal(
            (T, d), dtype=np.float32)).to(DEVICE, getattr(torch, dtype))
        slots = rng.choice(S, n_kept, replace=False)
        ids_np = np.full(S, -1, np.int32)
        ids_np[slots] = rng.permutation(np.resize(np.arange(T), n_kept))
        ids = torch.from_numpy(ids_np).to(DEVICE)
        keep = ids >= 0
        out = ops.moe_gather(x, ids, keep)
        torch.cuda.synchronize()
        want = moe_gather_ref(x, ids, keep)
        view = torch.int16 if x.element_size() == 2 else torch.int32
        if not torch.equal(out.view(view), want.view(view)):
            raise AssertionError(f"moe_gather case {name}: not bit-equal to "
                                 f"the plain version")
        err = float((out.float() - want.float()).abs().max())
        ms = cuda_ms(torch, lambda: ops.moe_gather(x, ids, keep), 50)
        dev_ms = device_ms(torch, lambda: ops.moe_gather(x, ids, keep), 50,
                           "moe_gather")
        words = ("16-byte words" if (d * x.element_size()) % 16 == 0
                 else "elements")
        plain_ms = cuda_ms(torch, lambda: moe_gather_ref(x, ids, keep), 50)
        lib_ids = ids.clamp(min=0)
        lib_ms = cuda_ms(torch, lambda: torch.index_select(x, 0, lib_ids), 50)
        rows = len(np.unique(ids_np[slots]))
        bound, bound_by = gather_bound_ms(rows, d, S, x.element_size())
        if name in ("prefill", "ep_local"):  # one call at a time
            x_copy = x.clone()
            flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)

            def cold():  # 256 MiB written: nothing of x left in the L2
                flush.zero_()

            def written():  # x just written, as the layer before leaves it
                cold()
                x.copy_(x_copy)

            gather = lambda: ops.moe_gather(x, ids, keep)  # noqa: E731
            one = single_call_ms(torch, gather, written)
            one_lib = single_call_ms(
                torch, lambda: torch.index_select(x, 0, lib_ids), written)
            one_cold = single_call_ms(torch, gather, cold)
            dev_cold = device_ms(torch, lambda: (cold(), gather()), 30,
                                 "moe_gather")
            log(f"[gather] {name}: one call with x just written (L2 "
                f"flushed, then x copied in): kernel {one:.4f} ms "
                f"({bound / one:.1%} of the bound), index_select "
                f"{one_lib:.4f} ms; one call after the L2 is flushed: "
                f"kernel {one_cold:.4f} ms ({bound / one_cold:.1%} of the "
                f"bound), on the device "
                + ("not measured" if dev_cold is None else
                   f"{dev_cold:.4f} ms ({bound / dev_cold:.1%} of the "
                   f"bound)"))
            del x_copy, flush
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by)
        log(f"[gather] {name}: T={T} d={d} S={S} kept {n_kept} ({rows} "
            f"distinct rows) {dtype}: bit-equal, max|err| {err:.3g}; "
            f"copied in {words}: kernel {ms:.4f} ms by events "
            f"({on_device(dev_ms, ms)}), plain "
            f"{plain_ms:.4f} ms, index_select "
            f"(library_ms) {lib_ms:.4f} ms, bound {bound:.4f} ms by "
            f"{bound_by} (roofline share {bound / ms:.1%})")
        del x, ids, keep, out, want, lib_ids
    torch.cuda.empty_cache()
    log(f"[gather] kernels: {json.dumps(ops.launch_counts())}")
    return results


def phase_scan(torch) -> dict:
    """ssm_scan against its plain version (the sequential loop) at
    jamba's prefill shape and a ragged one."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import ssm_scan_ref
    from repro_torch.launch.bounds import scan_bound_ms

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    results = {}
    for name, Bt, L, di, N in SCAN_CASES:
        def mk(*shape):
            return torch.randn(shape, device=DEVICE, generator=gen)

        # tests/test_kernels.py's distribution
        dt = F.softplus(mk(Bt, L, di)) * 0.1
        A = -torch.exp(mk(di, N) * 0.3)
        B, C, x = mk(Bt, L, N), mk(Bt, L, N), mk(Bt, L, di)
        want = ssm_scan_ref(dt, A, B, C, x)
        copies = ss.COPIES.count
        out = ss.ssm_scan(dt, A, B, C, x)
        torch.cuda.synchronize()
        copies = ss.COPIES.count - copies
        diff = (out - want).abs()
        err = float(diff.max())
        rel = err / float(want.abs().max())
        bad = diff > SCAN_TOL + SCAN_TOL * want.abs()
        if not torch.isfinite(out).all() or bool(bad.any()):
            raise AssertionError(f"ssm_scan case {name}: max |err| {err:.3g} "
                                 f"outside atol=rtol={SCAN_TOL}")
        ms = cuda_ms(torch, lambda: ss.ssm_scan(dt, A, B, C, x), 20)
        plain_ms = cuda_ms(torch, lambda: ssm_scan_ref(dt, A, B, C, x),
                           2, warmup=1)
        bound, bound_by = scan_bound_ms(Bt, L, di, N)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound,
                             bound_by=bound_by)
        log(f"[scan] {name}: Bt={Bt} L={L} di={di} N={N} float32: "
            f"max|err| {err:.3g} (max|err|/max|plain| {rel:.3g}; tol "
            f"atol=rtol={SCAN_TOL}; inputs copied for TMA: {copies}) "
            f"kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, no library call, bound {bound:.4f} ms "
            f"by {bound_by} (roofline share {bound / ms:.1%})")
        del dt, A, B, C, x, want, out, diff, bad
        torch.cuda.empty_cache()
    log(f"[scan] kernels: {json.dumps(ops.launch_counts())}")
    return results


def phase_gather_bwd(torch) -> dict:
    """moe_gather's forward and backward against their plain versions, bit
    for bit, at the training dispatch shape in float32 and bf16: the
    backward given the (T, k) map of each token's slots (built outside the
    timed call by ``ref.gather_slots``, its time logged apart), twice for
    the same bits, and through ``ops.moe_gather(..., slots=)`` with
    autograd (one launch of each kernel, the same bits); ``index_add_``
    over the kept rows as yardstick. Then, untimed, the backward bit for
    bit at GATHER_BWD_WIDE, maps wider than the kernel's fan of 8 slots a
    token."""
    import numpy as np

    from repro_torch.kernels import moe_dispatch as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (gather_slots, moe_gather_bwd_ref,
                                         moe_gather_ref)
    from repro_torch.launch.bounds import gather_bwd_bound_ms

    rng = np.random.default_rng(SEED)
    results = {}
    for name, T, d, S, n_kept, dtype in GATHER_BWD_CASES:
        slots_np = rng.choice(S, n_kept, replace=False)
        ids_np = np.full(S, -1, np.int32)
        ids_np[slots_np] = rng.permutation(np.resize(np.arange(T), n_kept))
        ids = torch.from_numpy(ids_np).to(DEVICE)
        keep = ids >= 0
        g = torch.from_numpy(rng.standard_normal(
            (S, d), dtype=np.float32)).to(DEVICE, getattr(torch, dtype))
        x = g[:T]  # the forward at the same dispatch
        view = torch.int16 if g.element_size() == 2 else torch.int32
        if not torch.equal(mg.moe_gather(x, ids, keep).view(view),
                           moe_gather_ref(x, ids, keep).view(view)):
            raise AssertionError(f"moe_gather at the training case {name}: "
                                 f"not bit-equal to the plain version")
        map_ms = cuda_ms(torch, lambda: gather_slots(ids, keep, T), 5)
        slots = gather_slots(ids, keep, T)
        out = mg.moe_gather_bwd(g, slots)
        again = mg.moe_gather_bwd(g, slots)
        torch.cuda.synchronize()
        want = moe_gather_bwd_ref(g, slots)
        if not torch.equal(out.view(view), want.view(view)):
            raise AssertionError(f"moe_gather_bwd case {name}: not "
                                 f"bit-equal to the plain version")
        if not torch.equal(out.view(view), again.view(view)):
            raise AssertionError(f"moe_gather_bwd case {name}: two runs "
                                 f"differ")
        xg = x.detach().clone().requires_grad_(True)
        ops.reset_launch_counts()
        dx, = torch.autograd.grad(ops.moe_gather(xg, ids, keep, slots=slots),
                                  xg, g)
        counts = ops.launch_counts()
        if counts["moe_gather"] != 1 or counts["moe_gather_bwd"] != 1 \
                or not torch.equal(dx.view(view), out.view(view)):
            raise AssertionError(f"moe_gather_bwd case {name}: the autograd "
                                 f"path's launches {counts} or bits differ "
                                 f"from the direct call's")
        err = float((out.float() - want.float()).abs().max())
        ms = cuda_ms(torch, lambda: mg.moe_gather_bwd(g, slots), 50)
        dev_ms = device_ms(torch, lambda: mg.moe_gather_bwd(g, slots), 50,
                           "moe_gather_bwd", launches=1)
        plain_ms = cuda_ms(torch, lambda: moe_gather_bwd_ref(g, slots), 5,
                           warmup=1)
        rows, g_kept = ids[keep].long(), g[keep]
        acc = torch.zeros((T, d), dtype=g.dtype, device=DEVICE)
        lib_ms = cuda_ms(torch, lambda: acc.index_add_(0, rows, g_kept), 50)
        bound, bound_by = gather_bwd_bound_ms(n_kept, T, d, slots.shape[1],
                                              g.element_size())
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by, dev_ms=dev_ms)
        alone = ("the kernel's device time not measured" if dev_ms is None
                 else f"the kernel {dev_ms:.4f} ms on the device, "
                 f"{bound / dev_ms:.1%} of the bound")
        log(f"[gather_bwd] {name}: T={T} d={d} S={S} kept {n_kept} {dtype}, "
            f"map ({T}, {slots.shape[1]}): the forward bit-equal; the "
            f"backward bit-equal, the same bits twice and through autograd "
            f"(one launch each), max|err| {err:.3g}; wrapper {ms:.4f} ms by "
            f"events ({alone}), plain "
            f"{plain_ms:.4f} ms, index_add_ (library_ms) {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms by {bound_by} (roofline share "
            f"{bound / ms:.1%}); the "
            f"map from ids and keep flags (ref.gather_slots, outside the "
            f"timed call; moe_apply hands over its own) {map_ms:.4f} ms")
        del g, x, ids, keep, out, again, want, rows, g_kept, acc, slots, dx
    for T, d, S, n_kept, dtype in GATHER_BWD_WIDE:
        ids_np = np.full(S, -1, np.int32)
        ids_np[rng.choice(S, n_kept, replace=False)] = rng.permutation(
            np.resize(np.arange(T), n_kept))
        ids = torch.from_numpy(ids_np).to(DEVICE)
        g = torch.from_numpy(rng.standard_normal(
            (S, d), dtype=np.float32)).to(DEVICE, getattr(torch, dtype))
        slots = gather_slots(ids, ids >= 0, T)
        view = torch.int16 if g.element_size() == 2 else torch.int32
        out = mg.moe_gather_bwd(g, slots)
        if slots.shape[1] != -(-n_kept // T) or not torch.equal(
                out.view(view), moe_gather_bwd_ref(g, slots).view(view)):
            raise AssertionError(f"moe_gather_bwd at T={T} d={d} S={S} kept "
                                 f"{n_kept} {dtype}, map {tuple(slots.shape)}"
                                 f": not bit-equal to the plain version")
        log(f"[gather_bwd] wide map: T={T} d={d} S={S} kept {n_kept} "
            f"{dtype}, map {tuple(slots.shape)}: bit-equal")
    torch.cuda.empty_cache()
    return results


def phase_scan_bwd(torch) -> dict:
    """ssm_scan's backward against the plain version's autograd (the
    sequential loop, differentiated by torch) at jamba's full Mamba shape
    and at the reduced training shape, within SCAN_BWD_TOL of each
    output's largest value: each instance (``ss.BWD_CHANNELS``) given the
    checkpointing forward's checkpoints, twice for the same bits, and
    without them (the wrapper runs that forward first) for the same bits
    again; the checkpointing forward's y equal to the serving forward's,
    and within SCAN_TOL of the plain loop's; its checkpoints bit-equal
    through autograd, whose gradients are the direct call's bits with one
    launch of each kernel. Times the backward given the checkpoints, the
    checkpointing forward and the pair, each beside its bound and the
    function's own minimum (the bound without the checkpoints' traffic,
    which the design's spacing sets)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import (ssm_scan_bwd_ref,
                                         ssm_scan_checkpointed_ref,
                                         ssm_scan_ref)
    from repro_torch.launch.bounds import scan_bound_ms, scan_bwd_bound_ms

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    results = {}
    for name, Bt, L, di, N in SCAN_BWD_CASES:
        def mk(*shape):
            return torch.randn(shape, device=DEVICE, generator=gen)

        dt = F.softplus(mk(Bt, L, di)) * 0.1
        A = -torch.exp(mk(di, N) * 0.3)
        proj = mk(Bt, L, 2 * N + 8)  # B, C strided, as mamba_apply's
        B, C = proj[..., 8:8 + N], proj[..., 8 + N:]
        x, g = mk(Bt, L, di), mk(Bt, L, di)
        y_ck, ck = ss.ssm_scan_checkpointed(dt, A, B, C, x)
        y = ss.ssm_scan(dt, A, B, C, x)
        if not torch.equal(y_ck, y):
            raise AssertionError(f"ssm_scan case {name}: the checkpointing "
                                 f"forward's y differs from the serving "
                                 f"forward's")
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (dt, A, B, C, x)]
        y_ref = ssm_scan_ref(*leaves)
        want = torch.autograd.grad(y_ref, leaves, g)
        y_ref = y_ref.detach()
        if bool(((y - y_ref).abs() > SCAN_TOL + SCAN_TOL * y_ref.abs())
                .any()):
            raise AssertionError(f"ssm_scan at the case {name}: outside "
                                 f"atol=rtol={SCAN_TOL}")
        ck_ref = ssm_scan_checkpointed_ref(dt, A, B, C, x)[1]
        ck_err = float((ck - ck_ref).abs().max() / ck_ref.abs().max())
        if not ck_err <= SCAN_BWD_TOL:
            raise AssertionError(f"ssm_scan case {name}: checkpoints off "
                                 f"the plain loop's states by {ck_err:.3g} "
                                 f"of their largest")
        del leaves, y, y_ref, y_ck, ck_ref
        per_plan, outs = {}, {}
        for channels in ss.BWD_CHANNELS:
            label = f"{ss.BWD_LANES}x{channels}"

            def bwd(ck=ck, channels=channels):
                return ss.ssm_scan_bwd(dt, A, B, C, x, g, ck=ck,
                                       channels=channels)

            out, again, direct = bwd(), bwd(), bwd(None)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(out, again, direct)):
                raise AssertionError(f"ssm_scan_bwd case {name}, {label}: "
                                     f"two runs, or the runs with and "
                                     f"without the checkpoints, differ")
            errs, rels = {}, {}
            for gname, got, w in zip(("ddt", "dA", "dB", "dC", "dx"), out,
                                     want):
                errs[gname] = float((got - w).abs().max())
                rels[gname] = errs[gname] / float(w.abs().max())
                if not torch.isfinite(got).all() \
                        or rels[gname] > SCAN_BWD_TOL:
                    raise AssertionError(
                        f"ssm_scan_bwd case {name}, {label}: {gname} "
                        f"max|err| {errs[gname]:.3g} over {SCAN_BWD_TOL} of "
                        f"its largest value ({rels[gname]:.3g})")
            per_plan[label] = dict(ms=cuda_ms(torch, bwd, SCAN_BWD_REPS),
                                   bwd=bwd, max_abs_err=max(errs.values()),
                                   rels=rels)
            outs[label] = out
            del again, direct
        # the autograd path: the checkpointing forward, then the backward
        # reading its checkpoints, at the plan's instance
        default = ss.bwd_plan(Bt, di)
        label = f"{default.lanes}x{default.channels}"
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (dt, A, proj, x)]
        lp = leaves[2]
        ops.reset_launch_counts()
        y = ops.ssm_scan(leaves[0], leaves[1], lp[..., 8:8 + N],
                         lp[..., 8 + N:], leaves[3])
        ck_fwd = y.grad_fn.saved_tensors[5]
        grads = torch.autograd.grad(y, leaves, g)
        counts = ops.launch_counts()
        auto = (grads[0], grads[1], grads[2][..., 8:8 + N],
                grads[2][..., 8 + N:], grads[3])
        if not torch.equal(ck_fwd, ck) \
                or not all(torch.equal(a, b)
                           for a, b in zip(auto, outs[label])) \
                or counts["ssm_scan"] != 1 or counts["ssm_scan_bwd"] != 1:
            raise AssertionError(f"ssm_scan_bwd case {name}: the autograd "
                                 f"path's checkpoints, gradients or "
                                 f"launches {counts} differ from the direct "
                                 f"call's")
        del leaves, lp, y, ck_fwd, grads, auto, outs
        bwd_ms = per_plan[label]["ms"]
        fwd_ms = cuda_ms(torch, lambda: ss.ssm_scan(dt, A, B, C, x),
                         SCAN_BWD_REPS)
        fwd_ck_ms = cuda_ms(
            torch, lambda: ss.ssm_scan_checkpointed(dt, A, B, C, x),
            SCAN_BWD_REPS)


        def pair():
            _, c = ss.ssm_scan_checkpointed(dt, A, B, C, x)
            return ss.ssm_scan_bwd(dt, A, B, C, x, g, ck=c)

        pair_ms = cuda_ms(torch, pair, SCAN_BWD_REPS)
        for v in per_plan.values():  # the kernel and its finish, a call
            v["dev_ms"] = device_ms(torch, v.pop("bwd"), SCAN_BWD_REPS,
                                    "ssm_scan_bwd", 2)
        plain_ms = cuda_ms(torch, lambda: ssm_scan_bwd_ref(dt, A, B, C, x, g),
                           1, warmup=1)
        bound, bound_by = scan_bwd_bound_ms(Bt, L, di, N)
        own, own_by = scan_bwd_bound_ms(Bt, L, di, N, checkpoints=False)
        fwd_bound, _ = scan_bound_ms(Bt, L, di, N)
        ck_bound, ck_by = scan_bound_ms(Bt, L, di, N, checkpoints=True)
        results[name] = dict(max_abs_err=per_plan[label]["max_abs_err"],
                             ms=bwd_ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound, bound_by=bound_by,
                             fwd_ck_ms=fwd_ck_ms, pair_ms=pair_ms)
        plans = "; ".join(
            f"{k} {v['ms']:.4f} ms ({on_device(v['dev_ms'], v['ms'])}), "
            f"max|err|/max|plain autograd| "
            f"{json.dumps({n: float(f'{e:.3g}') for n, e in v['rels'].items()})}"
            for k, v in per_plan.items())
        log(f"[scan_bwd] {name}: Bt={Bt} L={L} di={di} N={N} float32, B "
            f"and C strided: instances (lanes x channels) {plans} (tol "
            f"{SCAN_BWD_TOL}; each the same bits twice and without the "
            f"checkpoints); the checkpointing forward's y the serving "
            f"forward's bits, its checkpoints within {ck_err:.3g} of the "
            f"plain loop's states and bit-equal through autograd, whose "
            f"gradients are the {label} call's bits (one launch each)")
        log(f"[scan_bwd] {name}: the backward given the checkpoints "
            f"({label}) {bwd_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
            f"(roofline share {bound / bwd_ms:.1%}; the function's own "
            f"minimum, without the checkpoints' reads, {own:.4f} ms by "
            f"{own_by}: {own / bwd_ms:.1%}); the checkpointing forward "
            f"{fwd_ck_ms:.4f} ms, bound {ck_bound:.4f} ms by {ck_by} (the "
            f"serving forward {fwd_ms:.4f} ms, bound {fwd_bound:.4f}); the "
            f"pair a training step pays {pair_ms:.4f} ms, bound "
            f"{bound + ck_bound:.4f} ms ({(bound + ck_bound) / pair_ms:.1%});"
            f" without checkpoint traffic {own + fwd_bound:.4f} ms "
            f"({(own + fwd_bound) / pair_ms:.1%}); plain reverse scan "
            f"{plain_ms:.3f} ms, no library call")
        del dt, A, proj, B, C, x, g, ck
        torch.cuda.empty_cache()
    return results


def phase_paged(torch) -> dict:
    """paged_attention against its plain version (gather every table
    entry's page, full softmax) at the decode shapes and a ragged one."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import paged_attention_ref

    rng = np.random.default_rng(SEED)
    results = {}
    for name, B, H, K, hd, page, max_pages, dtype, holes, lens \
            in PAGED_CASES:
        dt = getattr(torch, dtype)
        P = B * max_pages + max_pages

        def mk(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(DEVICE, dt)

        q = mk(B, H, hd)
        layers = POOL_LAYERS.get(name, 1)
        pools = []
        for _ in range(2):  # K and V: the last layer's view of the pool
            pools.append(torch.zeros((layers, P, page, K, hd), dtype=dt,
                                     device=DEVICE))
            pools[-1][-1].copy_(mk(P, page, K, hd))
        k_pages, v_pages = pools[0][-1], pools[1][-1]
        tables_np = rng.permutation(P)[:B * max_pages].reshape(
            B, max_pages).astype(np.int32)
        lengths_np = rng.integers(*(lens or (1, max_pages * page + 1)),
                                  B).astype(np.int32)
        if holes:  # a hole inside row 0's length, row B-1 holes only
            lengths_np[0] = max(lengths_np[0], 2 * page + 1)
            tables_np[0, 1] = -1
            tables_np[-1] = -1
        tables = torch.from_numpy(tables_np).to(DEVICE)
        lengths = torch.from_numpy(lengths_np).to(DEVICE)
        args = (q, k_pages, v_pages, tables, lengths)
        out = ops.paged_attention(*args)
        torch.cuda.synchronize()
        want = paged_attention_ref(*args)
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        tol = KERNEL_TOL[dtype]
        if not torch.isfinite(out).all() or \
                bool((diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(f"paged_attention case {name}: max |err| "
                                 f"{err:.3g} outside atol=rtol={tol}")
        row_note = ""
        if dtype == "bfloat16":  # against the float32 answer, row by row
            want32 = paged_attention_ref(q.float(), k_pages.float(),
                                         v_pages.float(), tables, lengths)
            row_err = float(((out.float() - want32).abs().amax(-1)
                             / want32.abs().amax(-1)).max())
            row_note = (f", row err vs the float32 answer {row_err:.3g} "
                        f"(tol {PAGED_ROW_TOL})")
            if not row_err <= PAGED_ROW_TOL:
                raise AssertionError(f"paged_attention case {name}: row err "
                                     f"{row_err:.3g} against the float32 "
                                     f"answer, over {PAGED_ROW_TOL}")
            del want32
        ms = cuda_ms(torch, lambda: ops.paged_attention(*args), 20)
        dev_ms = device_ms(torch, lambda: ops.paged_attention(*args), 20,
                           "paged_")
        plain_ms = cuda_ms(torch, lambda: paged_attention_ref(*args), 3,
                           warmup=1)
        # the yardstick: SDPA over a dense (B, K, T, hd) copy of the pages,
        # gathered here and not timed, with the valid positions as a mask
        T = max_pages * page
        ids = tables.long().clamp(min=0)
        kd, vd = (x[ids].reshape(B, T, K, hd).transpose(1, 2).contiguous()
                  for x in (k_pages, v_pages))
        pos = torch.arange(T, device=DEVICE)
        mask = ((pos[None] < lengths[:, None])
                & (tables >= 0).repeat_interleave(page, dim=1))[:, None, None]
        qd = q[:, :, None]
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), 20)
        bound, bound_by = paged_bound_ms(lengths_np, tables_np, page, H, K,
                                         hd, dtype, q.element_size())
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by)
        view = (f" (layer {layers - 1} of a {layers}-layer pool)"
                if layers > 1 else "")
        log(f"[paged] {name}: B={B} H={H} K={K} hd={hd} page={page} "
            f"max_pages={max_pages} pool={P}{view} {dtype} lengths "
            f"{int(lengths_np.min())}..{int(lengths_np.max())} (mean "
            f"{lengths_np.mean():.0f}){', holes' if holes else ''}: "
            f"max|err| {err:.3g} (tol {tol}){row_note}; kernel {ms:.4f} ms "
            f"by events ({on_device(dev_ms, ms)}), plain "
            f"{plain_ms:.3f} ms, sdpa over the pre-gathered dense copy "
            f"(library_ms; gather not timed) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms by {bound_by} (roofline share "
            f"{bound / ms:.1%})")
        del q, k_pages, v_pages, pools, args, out, want, diff, kd, vd, mask
        torch.cuda.empty_cache()
    log(f"[paged] kernels: {json.dumps(ops.launch_counts())}")
    return results


def shard_layout(np, rng, B: int, tokens: int, page: int, shards: int):
    """A pool of B rows of ``tokens`` cut into ``shards`` shards by the
    round-robin rule (page k of a row on shard k mod shards, entry k //
    shards): the local tables and page maps (shards, B, slots), the whole
    pool's table (B, pages) of global ids and each row's length, with row
    0 full but for a hole (its page 5), row 1 short (its later shards
    empty), row 2's pages all on shard 3 (as stolen pages sit) and row 3
    drawn."""
    pages = tokens // page
    slots = -(-pages // shards)
    pps = B * slots
    tables = np.full((shards, B, slots), -1, np.int32)
    seq_pages = np.full_like(tables, -1)
    lengths = np.array([tokens, 5 * page - 3, 4 * page - 1,
                        rng.integers(tokens // 2, tokens)], np.int32)[:B]
    for b in range(B):
        for k in range(pages if b != 2 else min(slots, pages)):
            s, j = (k % shards, k // shards) if b != 2 else (3 % shards, k)
            tables[s, b, j] = b * slots + j
            seq_pages[s, b, j] = k
    whole = np.full((B, pages), -1, np.int32)
    for s in range(shards):
        for b, j in zip(*np.nonzero(seq_pages[s] >= 0)):
            whole[b, seq_pages[s, b, j]] = s * pps + tables[s, b, j]
    hole = (5 % shards, 5 // shards)
    tables[hole[0], 0, hole[1]] = -1
    whole[0, 5] = -1
    return tables, seq_pages, whole, lengths, pps


def phase_paged_partial(torch) -> dict:
    """The paged kernel's partial mode at a rank's share of a long
    context split over the sequence (PARTIAL_CASES: nemotron-4-340b's
    96/8 heads of 192 over 4,096-token rows of 64-token pages, 16 shards):
    each shard's partial against its plain version; the 16 partials
    merged in shard order (``attention.merge_partials``) against
    ``ops.paged_attention`` over the whole pool and against
    ``paged_attention_ref``; one shard's call timed beside its bound, its
    plain version and SDPA over the shard's pre-gathered dense copy (the
    normalised output only, not the (max, sum))."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (paged_attention_partial_ref,
                                         paged_attention_ref)
    from repro_torch.models.attention import merge_partials
    from repro_torch.objectmodel.kvcache import shard_lengths

    rng = np.random.default_rng(SEED)
    results = {}
    for name, B, H, K, hd, page, tokens, shards, dtype in PARTIAL_CASES:
        dt = getattr(torch, dtype)
        tables_np, seq_np, whole_np, lengths_np, pps = shard_layout(
            np, rng, B, tokens, page, shards)

        def mk(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(DEVICE, dt)

        q = mk(B, H, hd)
        k_pool, v_pool = mk(shards * pps, page, K, hd), mk(shards * pps,
                                                            page, K, hd)
        lengths = torch.from_numpy(lengths_np).to(DEVICE)
        tol = KERNEL_TOL[dtype]
        args, outs, mls, err, ml_err = [], [], [], 0.0, 0.0
        for sh in range(shards):
            table = torch.from_numpy(tables_np[sh]).to(DEVICE)
            held = shard_lengths(table, torch.from_numpy(seq_np[sh]).to(
                DEVICE), lengths, page)
            a = (q, k_pool[sh * pps:(sh + 1) * pps],
                 v_pool[sh * pps:(sh + 1) * pps], table, held)
            out, ml = ops.paged_attention_partial(*a)
            want, want_ml = paged_attention_partial_ref(*a)
            for got, w in ((out, want), (ml, want_ml)):
                diff = (got - w).abs()
                if not torch.isfinite(got).all() or \
                        bool((diff > tol + tol * w.abs()).any()):
                    raise AssertionError(
                        f"partial case {name} shard {sh}: max |err| "
                        f"{float(diff.max()):.3g} outside atol=rtol={tol}")
            err = max(err, float((out - want).abs().max()))
            ml_err = max(ml_err, float(((ml - want_ml).abs()
                                        / want_ml.abs().clamp(min=1)).max()))
            args.append(a)
            outs.append(out)
            mls.append(ml)
        merged = merge_partials(torch.stack(outs), torch.stack(mls))
        whole = (q, k_pool, v_pool, torch.from_numpy(whole_np).to(DEVICE),
                 lengths)
        merge_err = {}
        for label, want in (("kernel", ops.paged_attention(*whole)),
                            ("plain", paged_attention_ref(*whole))):
            diff = (merged - want.float()).abs()
            merge_err[label] = float(diff.max())
            if bool((diff > tol + tol * want.float().abs()).any()):
                raise AssertionError(
                    f"partial case {name}: the shards merged against "
                    f"{label} over the whole pool off by {float(diff.max())}")
        empty = [int((ml[:, 0, 1] == 0).sum()) for ml in mls]
        a = args[0]
        ms = cuda_ms(torch, lambda: ops.paged_attention_partial(*a), 20)
        dev_ms = device_ms(torch, lambda: ops.paged_attention_partial(*a),
                           20, "paged_")
        plain_ms = cuda_ms(torch, lambda: paged_attention_partial_ref(*a),
                           3, warmup=1)
        T = tables_np.shape[2] * page
        ids = a[3].long().clamp(min=0)
        kd, vd = (x[ids].reshape(B, T, K, hd).transpose(1, 2).contiguous()
                  for x in a[1:3])
        pos = torch.arange(T, device=DEVICE)
        mask = ((pos[None] < a[4][:, None])
                & (a[3] >= 0).repeat_interleave(page, dim=1))[:, None, None]
        mask[..., 0] |= ~mask.any(-1)  # SDPA needs one visible key a row
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True), 20)
        bound, bound_by = paged_bound_ms(a[4].cpu().numpy(), tables_np[0],
                                         page, H, K, hd, dtype,
                                         q.element_size(), partial=True)
        results[name] = dict(max_abs_err=max(err, *merge_err.values()),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=bound_by)
        log(f"[paged partial] {name}: B={B} H={H} K={K} hd={hd} page={page} "
            f"{tokens} tokens a row over {shards} shards ({pps} pages a "
            f"shard, {tables_np.shape[2]} entries a row; row 0 a hole, row "
            f"1 {int(lengths_np[1])} tokens, row 2's pages on shard 3), "
            f"{dtype}: each shard's partial within {err:.3g} of its plain "
            f"version, its (max, sum) within {ml_err:.3g} relative (tol "
            f"{tol}); the {shards} partials merged in shard "
            f"order against the whole pool's kernel {merge_err['kernel']:.3g}"
            f" and plain version {merge_err['plain']:.3g}; rows with an "
            f"empty partial on each shard {empty}; shard 0's call "
            f"{ms:.4f} ms by events ({on_device(dev_ms, ms)}), plain "
            f"{plain_ms:.3f} ms, sdpa over its pre-gathered dense copy "
            f"(library_ms; the output alone, no (max, sum); gather not "
            f"timed) {lib_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
            f"(roofline share {bound / ms:.1%})")
        del q, k_pool, v_pool, args, outs, mls, merged, whole, kd, vd, mask
        torch.cuda.empty_cache()
    log(f"[paged partial] kernels: {json.dumps(ops.launch_counts())}")
    return results


# ------------------------------------------------------ phases 3, 5, 7
@contextlib.contextmanager
def dispatch_ids(ops, record: list):
    """Record the token ids of every moe_gather dispatch, one (slots,)
    device tensor a MoE layer (no host sync); a slot is kept where its id
    is not negative."""
    real = ops.moe_gather

    def recording(x, token_ids, keep, slots=None):
        record.append(token_ids)
        return real(x, token_ids, keep, slots=slots)

    ops.moe_gather = recording
    try:
        yield
    finally:
        ops.moe_gather = real


def n_attention_layers(cfg) -> int:
    """The attention layers that prefill runs through flash and paged
    decode through paged_attention: whisper's decoder (its encoder runs
    the plain path, as the reference's), none in the xLSTM stack."""
    if cfg.family == "ssm":
        return 0
    return (cfg.n_layers // cfg.attn_period if cfg.family == "hybrid"
            else cfg.n_layers)


def paged_family(cfg) -> bool:
    """Whether the family decodes over the paged pool: the reference has
    no paged decode, and the port none for audio and ssm (ValueError)."""
    return cfg.family not in ("audio", "ssm")


def expected_launches(cfg) -> dict:
    """Launches of each kernel in one prefill forward: flash per attention
    layer, moe_gather per MoE layer, ssm_scan per Mamba layer."""
    n_attn = n_attention_layers(cfg)
    if cfg.family == "hybrid":
        return {"flash_attention": n_attn, "paged_attention": 0,
                "moe_gather": cfg.n_layers // cfg.moe_period,
                "ssm_scan": cfg.n_layers - n_attn, **NO_RELATIONAL,
                **NO_BACKWARD, **NO_PARTIAL}
    return {"flash_attention": n_attn, "paged_attention": 0,
            "moe_gather": cfg.n_layers if cfg.is_moe else 0, "ssm_scan": 0,
            **NO_RELATIONAL, **NO_BACKWARD, **NO_PARTIAL}


def decode_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` decode steps over the paged
    pool: paged_attention per attention layer, moe_gather per MoE layer."""
    moe = expected_launches(cfg)["moe_gather"]
    return {"flash_attention": 0, "paged_attention":
            n_attention_layers(cfg) * steps, "moe_gather": moe * steps,
            "ssm_scan": 0, **NO_RELATIONAL, **NO_BACKWARD, **NO_PARTIAL}


def hybrid_config():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(HYBRID_ARCH), **HYBRID_CUTS)


def other_arch(name: str):
    """A family of OTHER_ARCHS: its name (all layers), or its config with
    the OTHER_CUTS applied."""
    from repro_torch.configs import get_arch
    if name not in OTHER_CUTS:
        return name
    return dataclasses.replace(get_arch(name), **OTHER_CUTS[name])


def prefill_batch(torch, model) -> dict:
    """Prefill inputs drawn from SEED: B=1, S=PREFILL_SEQ tokens; for an
    audio model AUDIO_BATCH sequences of AUDIO_SEQ tokens and the
    encoder's frames (B, encoder_len, d), for a vlm the patch embeddings
    (B, n_patches, d) that replace the first n_patches positions; frames
    and patches drawn on the card in the model's dtype, as the reference's
    input specs give them."""
    import numpy as np
    cfg = model.cfg
    B, S = ((AUDIO_BATCH, AUDIO_SEQ) if cfg.family == "audio"
            else (1, PREFILL_SEQ))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S))).to(DEVICE)}
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    extra = {"vlm": ("patches", cfg.n_patches),
             "audio": ("frames", cfg.encoder_len)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.randn((B, extra[1], cfg.d_model),
                                      generator=gen, device=DEVICE,
                                      dtype=model.dtype)
    return batch


def phase_prefill(torch, arch, label: str, summary: dict,
                  long_context: bool = False) -> tuple:
    """Full-width prefill through the flash kernel (and, for a MoE model,
    the moe_gather dispatch; for a hybrid, also the ssm_scan kernel),
    checked against the plain attention path and the decode paths (dense;
    where the family has them, paged and int8; whisper's from the
    encoder's output); then, where the family has it, serving over the
    paged pool, and with ``long_context`` the long-context paged decode
    step. ``arch`` is a name (all layers) or a cut ArchConfig. Fills
    ``summary`` (prefill tokens/s, the dense decode step's ms and busy
    share, peak memory) and returns the main-path runs' launch counts
    (prefill, paged decode, paged serving, long context) and the paged
    serving run's result (None without a paged pool)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import Ctx, build_model

    torch.cuda.reset_peak_memory_stats()
    model = build_model(arch)
    cfg = model.cfg
    n_moe = expected_launches(cfg)["moe_gather"]
    t0 = time.perf_counter()
    model.init_params(torch.Generator(DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    experts = (f", {cfg.n_experts} experts top-{cfg.top_k} + "
               f"{cfg.n_shared_experts} shared" if cfg.is_moe else "")
    if cfg.family == "hybrid":
        experts += (f", attention every {cfg.attn_period} layers, MoE every "
                    f"{cfg.moe_period}; Mamba d_inner "
                    f"{cfg.ssm_expand * cfg.d_model} d_state {cfg.d_state} "
                    f"d_conv {cfg.d_conv}")
    elif cfg.family == "ssm":
        experts += (f", every {cfg.slstm_period}th block sLSTM, the rest "
                    f"mLSTM")
    elif cfg.family == "audio":
        experts += (f", encoder {cfg.encoder_layers} layers over "
                    f"{cfg.encoder_len} frames")
    elif cfg.family == "vlm":
        experts += f", {cfg.n_patches} patch positions"
    full = get_arch(cfg.name)  # the registry's config, uncut
    cut = [f"{f.name} {getattr(full, f.name)} -> {getattr(cfg, f.name)}"
           for f in dataclasses.fields(cfg)
           if getattr(cfg, f.name) != getattr(full, f.name)]
    cuts = ("cut: " + ", ".join(cut) + "; every other field as published"
            if cut else "no depth cut")
    log(f"[{label}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (hd "
        f"{cfg.resolved_head_dim}), d_ff {cfg.d_ff}{experts}, vocab "
        f"{cfg.vocab_size}{', tied embeddings' if cfg.tie_embeddings else ''}"
        f": {model.param_count():,} parameters in {model.dtype}, drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"({cuts})")
    batch = prefill_batch(torch, model)
    tokens = batch["tokens"]
    B, S = tokens.shape

    ids = []
    copies = ss.COPIES.count
    ops.reset_launch_counts()
    with dispatch_ids(ops, ids):
        flash, aux = model.forward(batch, Ctx(use_flash=True),
                                   last_only=True)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = expected_launches(cfg)
    log(f"[{label}] launches in one forward: {json.dumps(launches)}")
    if want["ssm_scan"]:
        log(f"[{label}] ssm_scan inputs copied for TMA in the forward: "
            f"{ss.COPIES.count - copies} (B and C read in place as column "
            f"slices of the x_proj output)")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if flash.shape != (B, 1, cfg.padded_vocab) or \
            not torch.isfinite(flash[..., :cfg.vocab_size]).all() or \
            not torch.isfinite(aux):
        raise AssertionError(f"bad prefill logits {tuple(flash.shape)} or "
                             f"aux {float(aux)}")
    if cfg.is_moe:
        from repro_torch.models.moe import expert_capacity
        per_layer = PREFILL_SEQ * cfg.top_k - torch.stack(
            [(t >= 0).sum() for t in ids]).cpu()
        slots = n_moe * PREFILL_SEQ * cfg.top_k
        dropped = int(per_layer.sum())
        log(f"[{label}] dispatch: capacity {expert_capacity(cfg, PREFILL_SEQ)}"
            f" per expert; {dropped} of {slots} token-slots dropped over "
            f"{n_moe} MoE layers ({dropped / slots:.2%}); aux loss "
            f"{float(aux):.4f} summed over layers; dropped by MoE layer "
            f"{per_layer.tolist()}")

    def median_s(fn) -> tuple:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1], times

    if cfg.family == "audio":
        enc_s, _ = median_s(lambda: model.encode(batch["frames"]))
        log(f"[{label}] Model.encode: B={B} x {cfg.encoder_len} frames, "
            f"{cfg.encoder_layers} layers (plain attention, as the "
            f"reference's encoder): {enc_s * 1e3:.1f} ms median of 3")
    prefill_s, times = median_s(lambda: model.forward(
        batch, Ctx(use_flash=True), last_only=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _ = model.forward(batch, Ctx(use_flash=False), last_only=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = rel_err(torch, flash[..., :cfg.vocab_size],
                  plain[..., :cfg.vocab_size])
    same_top = bool((flash.argmax(-1) == plain.argmax(-1)).all())
    log(f"[{label}] flash vs plain attention path, last-position logits: "
        f"max|diff|/max|plain| = {err:.3g} (tol {LOGITS_TOL}); same argmax: "
        f"{same_top}")
    if not err <= LOGITS_TOL:
        raise AssertionError("flash prefill disagrees with the plain path")
    summary.update(name=cfg.name, layers=cfg.n_layers, B=B, S=S,
                   prefill_tps=B * S / prefill_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[{label}] B={B} S={S}: {prefill_s * 1e3:.1f} ms median of "
        f"3 ({sorted(t * 1e3 for t in times)} ms), "
        f"{B * S / prefill_s:.0f} tokens/s; plain attention path "
        f"{plain_s * 1e3:.1f} ms; peak memory "
        f"{summary['peak_gib']:.2f} GiB")

    # serving path vs prefill on the same weights: teacher-forced decode.
    # A MoE model drops slots by batch composition, so both sides run with
    # the capacity lifted to n_experts (no drops), on the same tensors.
    check = model
    if cfg.is_moe:
        check = build_model(dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts)))
        check.load_state_dict(model.state_dict(), assign=True)
    n = 8
    # decode reads no patches; whisper's reads the encoder's output
    frames = {"frames": batch["frames"]} if cfg.family == "audio" else {}
    ref, _ = check.forward({"tokens": tokens[:, :n], **frames}, Ctx())
    enc = check.encode(batch["frames"]) if frames else None
    lifted = " (capacity lifted)" if cfg.is_moe else ""
    worst, _ = teacher_forced(torch, check, tokens, ref, n,
                              f"{label}: dense decode{lifted}", enc_out=enc)
    # The xLSTM's mLSTM divides by a denominator that is small at some
    # positions of random-weight inputs, where one bf16 ulp moves its
    # output by several percent (tests/test_torch_xlstm.py): its bf16
    # decode is printed here and held against prefill in float32 below.
    recurrent = cfg.family == "ssm"
    if not (recurrent or worst <= LOGITS_TOL):
        raise AssertionError("decode path disagrees with prefill")
    # Over the paged pool and the int8 cache. A MoE router's top-k choice
    # flips on bf16 rounding differences (the kernel keeps the softmax
    # weights in float32, the plain path rounds them to bf16) and on int8
    # quantization error, so for the MoE model these two are printed here
    # and the paged path is held against prefill in float32 below.
    paged_runs = [launches]
    moe = cfg.family == "moe"
    if paged_family(cfg):
        worst, paged_launches = teacher_forced(
            torch, check, tokens, ref, n, f"{label}: paged decode (page 4)",
            kv_layout="paged", page_size=4)
        paged_runs.append(paged_launches)
        if not (moe or worst <= LOGITS_TOL):
            raise AssertionError("paged decode disagrees with prefill")
    if cfg.family in ("dense", "moe", "vlm"):  # hybrid, ssm: no int8 cache
        worst, _ = teacher_forced(torch, check, tokens, ref, n,
                                  f"{label}: int8 KV decode",
                                  kv_dtype="int8")
        if not (moe or worst <= LOGITS_TOL):
            raise AssertionError("int8 KV decode disagrees with prefill")
    refused = ([{"kv_layout": "paged"}] if not paged_family(cfg) else []) \
        + ([{"kv_dtype": "int8"}] if cfg.family == "audio" else [])
    for kw in refused:
        try:
            model.init_decode_state(1, 16, **kw)
        except ValueError as e:
            log(f"[{label}] init_decode_state({kw}) refused, as the "
                f"reference has no such decode: {e}")
        else:
            raise AssertionError(f"{cfg.family}: {kw} was not refused")
    if moe:
        log(f"[{label}] bf16 paged and int8 decode errors above are printed, "
            f"not held to {LOGITS_TOL}: the top-{cfg.top_k} router flips on "
            f"rounding and quantization differences; the float32 checks "
            f"after serving hold the paged path")
    profiled, profiled_s, note = batch, prefill_s, ""
    if cfg.family == "ssm":
        profiled = {"tokens": tokens[:, :SSM_PROFILE_SEQ]}
        profiled_s, _ = median_s(lambda: model.forward(
            profiled, Ctx(use_flash=True), last_only=True))
        note = f" (the first {SSM_PROFILE_SEQ} tokens)"
    busy, by_name = device_breakdown(torch, lambda: model.forward(
        profiled, Ctx(use_flash=True), last_only=True), profiled_s,
        label + note)
    if want["flash_attention"]:
        flash_s = sum(t for k, t in by_name.items() if "flash_fwd" in k)
        log(f"[{label}] flash_attention: {flash_s * 1e3:.2f} ms = "
            f"{flash_s / busy:.1%} of device time "
            f"({flash_s * 1e3 / want['flash_attention']:.4f} ms per launch)")
    token = tokens[:1, :1].expand(4, 1).contiguous()
    for layout in ("dense", "paged") if paged_family(cfg) else ("dense",):
        state = model.init_decode_state(4, 48, kv_layout=layout,
                                        page_size=PAGE_SIZE)
        steps = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = model.decode_step(token, state)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        wall = sorted(steps)[1]
        busy, _ = device_breakdown(
            torch, lambda: model.decode_step(token, state), wall,
            f"{label}: {layout} decode step, batch 4")
        if layout == "dense":
            summary.update(decode_ms=wall * 1e3, decode_busy=busy / wall)
        del state
    served = None
    if paged_family(cfg):
        served, serve_launches = paged_serving(torch, model, label)
        paged_runs.append(serve_launches)
    if long_context:
        paged_runs.append(long_context_decode(torch, model, label))
    del model, flash, plain, ref, batch, enc
    gc.collect()
    if moe or recurrent:
        paged_runs.append(float32_decode_checks(torch, check, tokens, n,
                                                label))
    del check
    gc.collect()
    torch.cuda.empty_cache()
    return paged_runs, served


def long_context_decode(torch, model, label: str) -> dict:
    """Paged decode steps at long context on the loaded model: the state
    is built directly (random K/V drawn into the whole pool, each row's
    table a slice of a random permutation of the pool's pages, lengths
    drawn in ``LONG_LENGTHS``, the tail pages looked up from the tables),
    not decoded up to there. Prints the wall time per step, the device's
    busy share and ``paged_attention``'s share of device time; checks one
    launch per attention layer and step and finite logits. Returns the
    run's launch counts."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import PagedDecodeState
    from repro_torch.objectmodel.kvcache import (global_page_tables,
                                                 tail_pages)
    cfg = model.cfg
    B, page = LONG_BATCH, LONG_PAGE
    state = model.init_decode_state(B, LONG_SEQ, kv_layout="paged",
                                    page_size=page)
    kv = state.kv
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    for pool in (kv.k_pages, kv.v_pages):
        pool.normal_(generator=gen)
    rng = np.random.default_rng(SEED)
    n_pages = kv.k_pages.shape[1]
    kv.block_tables[0].copy_(torch.from_numpy(
        rng.permutation(n_pages).astype(np.int32).reshape(B, -1)))
    lengths_np = rng.integers(*LONG_LENGTHS, B).astype(np.int32)
    kv.length.copy_(torch.from_numpy(lengths_np))
    tables = global_page_tables(kv.block_tables, n_pages)
    state = PagedDecodeState(kv, tail_pages(tables, kv.length, page),
                             state.mamba)
    pool_gib = 2 * kv.k_pages.numel() * kv.k_pages.element_size() / 2**30
    token = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))).to(
        DEVICE)
    ops.reset_launch_counts()
    steps, finite = [], True
    for _ in range(LONG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state = model.decode_step(token, state)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(out[..., :cfg.vocab_size]).all())
    launches = ops.launch_counts()
    want = decode_launches(cfg, LONG_STEPS)
    wall = sorted(steps)[len(steps) // 2]
    busy, by_name = device_breakdown(
        torch, lambda: model.decode_step(token, state), wall,
        f"{label}: long-context paged decode step")
    paged_s = sum(t for k, t in by_name.items() if "paged_" in k)
    log(f"[{label}: long-context paged decode] B={B} page {page} lengths "
        f"{int(lengths_np.min())}..{int(lengths_np.max())} (+{LONG_STEPS} "
        f"steps), pool {pool_gib:.2f} GiB: {wall * 1e3:.1f} ms/step median "
        f"of {LONG_STEPS} ({sorted(round(t * 1e3, 1) for t in steps)} ms); "
        f"device busy {busy / wall:.1%}; paged_attention {paged_s * 1e3:.2f} "
        f"ms = {paged_s / busy:.1%} of device time "
        f"({paged_s * 1e3 / n_attention_layers(cfg):.4f} ms per layer); "
        f"logits finite: {finite}; launches {json.dumps(launches)}")
    if launches != want or not finite:
        raise AssertionError(f"long-context decode: launches {launches} "
                             f"(want {want}), finite logits {finite}")
    del state, kv, tables, out
    torch.cuda.empty_cache()
    return launches


def teacher_forced(torch, model, tokens, ref, n: int, label: str,
                   enc_out=None, **state_kw) -> tuple:
    """Teacher-forced decode of ``tokens[:, :n]`` from the state
    ``model.init_decode_state(B, 16, model.dtype, **state_kw)`` builds
    (with ``enc_out`` set, for whisper), against prefill's logits ``ref``.
    Returns max |diff| / max |prefill| over the steps and the run's launch
    counts; a paged run's launches are checked (one paged_attention per
    attention layer and step)."""
    from repro_torch.kernels import ops
    cfg = model.cfg
    state = model.init_decode_state(tokens.shape[0], 16, model.dtype,
                                    **state_kw)
    if enc_out is not None:
        state = state._replace(enc_out=enc_out)
    ops.reset_launch_counts()
    worst = 0.0
    for t in range(n):
        step, state = model.decode_step(tokens[:, t:t + 1], state)
        worst = max(worst, rel_err(torch, step[..., :cfg.vocab_size],
                                   ref[:, t:t + 1, :cfg.vocab_size]))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"[{label}] vs prefill logits over {n} teacher-forced tokens, "
        f"{model.dtype}: max|diff|/max|prefill| = {worst:.3g} (tol "
        f"{LOGITS_TOL}); launches {json.dumps(launches)}")
    if state_kw.get("kv_layout") == "paged" and \
            launches != decode_launches(cfg, n):
        raise AssertionError(f"expected launches {decode_launches(cfg, n)}"
                             f", got {launches}")
    return worst, launches


def float32_decode_checks(torch, model, tokens, n: int, label: str) -> dict:
    """The decode paths against prefill in float32, for the models whose
    bf16 decode is printed, not held (the MoE model's paged and int8
    paths: its router flips on rounding; the xLSTM's dense decode):
    ``model`` (for the MoE model the capacity-lifted view of the loaded
    weights) is converted in place leaf by leaf, so the bf16 copy is freed
    as the float32 one is made. Returns the launch counts of the paged run
    (of the dense run where the family has no paged pool)."""
    from repro_torch.models import Ctx
    cfg = model.cfg
    for module in model.modules():
        for name, p in list(module.named_parameters(recurse=False)):
            setattr(module, name, torch.nn.Parameter(p.data.float(),
                                                     requires_grad=False))
            del p
        torch.cuda.empty_cache()
    log(f"[{label}] weights converted in place to {model.dtype}: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ref, _ = model.forward({"tokens": tokens[:, :n]}, Ctx())
    runs = [("dense decode", {})]
    if paged_family(cfg):
        runs.append(("paged decode (page 4)",
                     {"kv_layout": "paged", "page_size": 4}))
    if cfg.family in ("dense", "moe", "vlm"):
        runs.append(("int8 KV decode", {"kv_dtype": "int8"}))
    results = {name: teacher_forced(torch, model, tokens, ref, n,
                                    f"{label}: {name}", **kw)
               for name, kw in runs}
    for name, _ in runs[:2]:  # int8: printed (quantization flips routing)
        if not results[name][0] <= LOGITS_TOL:
            raise AssertionError(f"float32 {name} disagrees with prefill")
    return results[runs[1][0] if paged_family(cfg) else "dense decode"][1]


def paged_serving(torch, model, label: str) -> tuple:
    """The serving engine over the paged pool on the loaded model: the
    requests of the dense serving phase, batch 4, max_seq 24, page 16.
    Returns its result and launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    cfg = model.cfg
    ops.reset_launch_counts()
    out = serve_model(model, n_requests=8, max_new=SERVE_MAX_NEW,
                      batch_size=4, seed=SEED, kv_layout="paged",
                      page_size=PAGE_SIZE)
    launches = ops.launch_counts()
    tps = out["tokens"] / out["seconds"]
    log(f"[{label}: paged serve] {out['finished']}/8 requests finished, "
        f"{out['tokens']} tokens in {out['iters']} decode steps, "
        f"{out['seconds']:.2f} s: {tps:.1f} tokens/s, "
        f"{out['seconds'] / out['iters'] * 1e3:.1f} ms/step at batch 4, "
        f"page {PAGE_SIZE}; KV pages in use {out['pages_in_use']}; launches "
        f"{json.dumps(launches)}")
    if out["finished"] != 8 or out["pages_in_use"] != 0:
        raise AssertionError(f"paged serving did not complete: "
                             f"{ {k: v for k, v in out.items() if k != 'outputs'} }")
    want = decode_launches(cfg, out["iters"])
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    return out, launches


# ------------------------------------------------------ phases 4, 6, 8
def phase_serving(torch, arch, label: str, paged, summary: dict) -> dict:
    """serve_batch at full width: 8 requests, batch 4, greedy, over the
    dense cache; printed beside ``paged``, the same requests served over
    the paged pool in the prefill phase (None: the family has no paged
    pool). ``arch`` is a name (all layers) or a cut ArchConfig. Puts the
    tokens/s in ``summary``; returns the run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch

    cfg = arch if not isinstance(arch, str) else get_arch(arch)
    layers = expected_launches(cfg)["moe_gather"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_batch(arch, n_requests=8, max_new=SERVE_MAX_NEW,
                      batch_size=4, reduced=False, seed=SEED, device=DEVICE)
    launches = ops.launch_counts()
    tps = out["tokens"] / out["seconds"]
    summary["serve_tps"] = tps
    log(f"[{label}] {out['finished']}/8 requests finished, {out['tokens']} "
        f"tokens in {out['iters']} decode steps, {out['seconds']:.2f} s: "
        f"{tps:.1f} tokens/s, {out['seconds'] / out['iters'] * 1e3:.1f} "
        f"ms/step at batch 4; KV pages in use {out['pages_in_use']}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {json.dumps(launches)} (decode reads the dense cache and "
        f"steps the recurrences in plain torch; moe_gather {layers} "
        f"per step)")
    if out["finished"] != 8 or out["pages_in_use"] != 0:
        raise AssertionError(f"serving did not complete: "
                             f"{ {k: v for k, v in out.items() if k != 'outputs'} }")
    want = {"flash_attention": 0, "paged_attention": 0,
            "moe_gather": layers * out["iters"], "ssm_scan": 0,
            **NO_RELATIONAL, **NO_BACKWARD, **NO_PARTIAL}
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if paged is None:
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    pairs = [(a, b) for got, ref in zip(paged["outputs"], out["outputs"])
             for a, b in zip(got, ref)]
    same = sum(a == b for a, b in pairs)
    log(f"[{label}] paged vs dense serving: {paged['tokens'] / paged['seconds']:.1f}"
        f" vs {tps:.1f} tokens/s, "
        f"{paged['seconds'] / paged['iters'] * 1e3:.1f} vs "
        f"{out['seconds'] / out['iters'] * 1e3:.1f} ms/step; {same} of "
        f"{len(pairs)} generated tokens agree (not asserted: bf16 dense "
        f"decode rounds the softmax weights to bf16, the kernel keeps them "
        f"in float32)")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 18c

def log_softmax_err(torch, a, b, rows: int = 512) -> float:
    """max |log_softmax(a) - log_softmax(b)| over (S, V) logits, a block
    of rows at a time."""
    worst = 0.0
    for i in range(0, a.shape[0], rows):
        diff = (torch.log_softmax(a[i:i + rows].float(), dim=-1)
                - torch.log_softmax(b[i:i + rows].float(), dim=-1))
        worst = max(worst, float(diff.abs().max()))
    return worst


def lost_routes(want, got) -> int:
    """The (token, expert) routes kept in ``want`` and not in ``got``: two
    sequences of one expert's slots' token ids (numpy, -1 where empty),
    the same experts in the same order."""
    import numpy as np
    return sum(len(np.setdiff1d(a[a >= 0], b[b >= 0]))
               for a, b in zip(want, got))


def routes_differ(ids, whole, cfg, mesh) -> int:
    """The (token, expert) routes that the single process's dispatch
    keeps and this rank's does not, over the layers: ``ids`` this rank's
    token ids a MoE layer (its E/tp experts' C slots each), ``whole`` the
    single process's (all E experts', numpy)."""
    E_local = cfg.n_experts // mesh.shape["model"]
    my = mesh.index("model")
    differ = 0
    for got, want in zip(ids, whole):
        C = got.numel() // E_local
        mine = want.reshape(cfg.n_experts, C)[my * E_local:(my + 1) * E_local]
        differ += lost_routes(mine, got.cpu().numpy().reshape(E_local, C))
    return differ


def reverse_experts(model) -> None:
    """Reverse the order of the experts in ``model``'s weights, in place:
    the router's columns and every expert leaf. The function is the same
    in exact arithmetic; its rounding is not: the combine adds each
    token's k expert outputs in increasing expert id, so now in the
    opposite order (in the model's dtype), and the router's float32
    softmax sums its 60 terms in the opposite order."""
    from repro_torch.models import params as pp
    for path, d in pp.tree_paths(model.defs).items():
        if "experts" in d.axes:
            dim = d.axes.index("experts")
        elif path.endswith("moe.router"):
            dim = len(d.shape) - 1
        else:
            continue
        t = model.get_parameter(path).data
        t.copy_(t.flip(dim))


def ep_collectives(torch) -> dict:
    """The collective functions and the pipeline on the four ranks, on
    CUDA tensors at the CPU tests' sizes (tests/test_torch_mesh.py), each
    against the single-process answer computed on the rank."""
    import numpy as np

    from repro_torch.engine.aggregation import (broadcast_join,
                                                grad_reduce_two_stage,
                                                hash_partition_join,
                                                two_stage_aggregate)
    from repro_torch.engine.pipeline_parallel import pipeline_forward
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("data",), DEVICE)
    g, r = mesh.group("data"), mesh.index("data")
    cu = lambda t: t.to(DEVICE)  # noqa: E731
    keys, vals = torch.arange(64) % 16, torch.arange(64.0)
    got = two_stage_aggregate(cu(keys[16 * r:16 * r + 16]),
                              cu(vals[16 * r:16 * r + 16]), 16, g)
    want = torch.zeros(16).index_add_(0, keys, vals)[4 * r:4 * r + 4]
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"two_stage_aggregate: {got} != {want}")
    probe = torch.arange(32) % 10
    bk = torch.nn.functional.pad(torch.arange(10), (0, 2))
    bv = torch.nn.functional.pad((torch.arange(10) * 10.0)[:, None],
                                 (0, 0, 0, 2))
    m, v = broadcast_join(cu(probe[8 * r:8 * r + 8]), cu(bk[3 * r:3 * r + 3]),
                          cu(bv[3 * r:3 * r + 3]), g)
    if not (m.all() and torch.equal(v[:, 0].cpu(),
                                    probe[8 * r:8 * r + 8] * 10.0)):
        raise AssertionError(f"broadcast_join: {m} {v}")
    hk = torch.arange(64) % 4
    hv = torch.stack([torch.arange(64.0), hk.float()], dim=1)
    rk, rv = hash_partition_join(cu(hk[16 * r:16 * r + 16]),
                                 cu(hv[16 * r:16 * r + 16]), 4, g)
    rows = sorted(rv[rk >= 0][:, 0].tolist())
    if not ((rk[rk >= 0] == r).all() and rows == list(range(r, 64, 4))):
        raise AssertionError(f"hash_partition_join: rank {r} got {rk}")
    grads = [{"a": torch.randn(8, 3, generator=torch.Generator().manual_seed(
        100 + i)), "b": torch.arange(3.0) * (i + 1)} for i in range(4)]
    red = grad_reduce_two_stage({k: cu(t) for k, t in grads[r].items()}, g)
    total_a = sum(x["a"] for x in grads)[2 * r:2 * r + 2]
    if not (torch.allclose(red["a"].cpu(), total_a, rtol=1e-6, atol=1e-6)
            and torch.equal(red["b"].cpu(), torch.arange(3.0) * 10)):
        raise AssertionError(f"grad_reduce_two_stage: {red}")
    pipe = make_mesh((4,), ("pipe",), DEVICE)
    rng = np.random.default_rng(0)
    Ws = cu(torch.from_numpy((rng.standard_normal((4, 16, 16)) / 4.0
                              ).astype(np.float32)))
    x = cu(torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)))
    stage = lambda W, h: torch.tanh(h @ W)  # noqa: E731
    out = pipeline_forward(stage, Ws, x, 4, pipe)
    want = x
    for W in Ws:
        want = stage(W, want)
    err = float((out - want).abs().max())
    if err > 2e-5:
        raise AssertionError(f"pipeline_forward: max |err| {err}")
    return {"pipeline_err": err}


def ep_float32(torch, mesh) -> dict:
    """(a): float32 at EP_F32_LAYERS layers; the EP prefill at every
    position and the EP engine's tokens against the single process's,
    which rank 0 computes after its EP runs."""
    import torch.distributed as dist

    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model

    model = build_model(MOE_ARCH, EP_F32_LAYERS)
    cfg = model.cfg
    plan = make_plan(cfg, mesh.shape, get_shape("prefill_32k"),
                     hbm_bytes=torch.cuda.get_device_properties(0)
                     .total_memory)
    if plan.moe_strategy != "ep":
        raise AssertionError(f"plan {plan.decisions}: not expert-parallel")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.init_shards(torch.Generator(DEVICE).manual_seed(SEED), plan, mesh,
                      torch.float32)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    held = sum(p.numel() for p in model.parameters())
    batch = prefill_batch(torch, model)
    ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True, use_flash=True)
    ids = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), dispatch_ids(ops, ids):
        logits, aux = model.forward(batch, ctx)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    torch.cuda.empty_cache()  # four ranks' caches share the card
    prefill = ops.launch_counts()
    if prefill != expected_launches(cfg):
        raise AssertionError(f"EP prefill launches {prefill}, want "
                             f"{expected_launches(cfg)}")
    ops.reset_launch_counts()
    serve_ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True)
    with torch.no_grad():
        served = serve_model(model, ctx=serve_ctx, **EP_SERVE)
    serve = ops.launch_counts()
    want = {**{k: 0 for k in serve}, "moe_gather": cfg.n_layers *
            served["iters"]}
    if serve != want:
        raise AssertionError(f"EP serve launches {serve}, want {want}")
    sums = [0.0, 0.0]  # float64 sums, a block of rows at a time
    for block in logits[0].split(512):
        block = block.double()
        sums = [sums[0] + float(block.sum()),
                sums[1] + float(block.square().sum())]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if mesh.rank != 0:
        del logits
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()  # every rank's cache freed before rank 0's single model
    ref = [None, None, None, None]
    if mesh.rank == 0:  # the single process, on rank 0's share of the card
        single = build_model(MOE_ARCH, EP_F32_LAYERS).init_params(
            torch.Generator(DEVICE).manual_seed(SEED), torch.float32)
        single_ids = []
        with torch.no_grad():
            with dispatch_ids(ops, single_ids):
                want_logits, want_aux = single.forward(batch,
                                                       Ctx(use_flash=True))
            V = cfg.vocab_size  # the pad columns are -1e30 in both
            ref[0] = log_softmax_err(torch, logits[0, :, :V],
                                     want_logits[0, :, :V])
            ref[2] = float(want_aux)
            ref[3] = [t.cpu().numpy() for t in single_ids]
            del want_logits
            ref[1] = serve_model(single, **EP_SERVE)["outputs"]
        del single, logits
        gc.collect()
        torch.cuda.empty_cache()
    dist.broadcast_object_list(ref, src=0)
    every = [None] * mesh.size
    dist.all_gather_object(every, sums)
    if any(s != every[0] for s in every):
        raise AssertionError(f"the ranks' logits differ: {every}")
    err, want_served, want_aux, single_ids = ref
    differ = routes_differ(ids, single_ids, cfg, mesh)
    if not err < EP_TOL:
        raise AssertionError(f"EP float32 log_softmax off by {err}")
    if served["outputs"] != want_served:
        raise AssertionError("EP engine's tokens differ from the single "
                             "process's")
    if abs(float(aux) - want_aux) > EP_AUX_RTOL * abs(want_aux):
        raise AssertionError(f"EP aux {float(aux)}, single {want_aux}")
    del model, ids
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "held": held, "draw_s": draw_s,
            "prefill_s": prefill_s, "err": err, "aux": float(aux),
            "differ": differ, "routes": cfg.n_layers * batch[
                "tokens"].numel() * cfg.top_k,
            "want_aux": want_aux, "served": served["tokens"],
            "finished": served["finished"], "serve_s": served["seconds"],
            "iters": served["iters"], "peak_gib": peak,
            "launches": [prefill, serve]}


def ep_bf16(torch, mesh, ref: dict) -> dict:
    """(b): bf16 at EP_BF16_LAYERS layers; a warm prefill (recording each layer's
    dispatch), one timed (the main path's), one with every all-reduce
    timed alone, one under the profiler; the last position's logits and
    the routes against the single process's."""
    import torch.distributed as dist

    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx, build_model

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = build_model(MOE_ARCH, EP_BF16_LAYERS)
    cfg = model.cfg
    plan = make_plan(cfg, mesh.shape, get_shape("prefill_32k"),
                     hbm_bytes=torch.cuda.get_device_properties(0)
                     .total_memory)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.init_shards(torch.Generator(DEVICE).manual_seed(SEED), plan, mesh)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    held = sum(p.numel() for p in model.parameters())
    batch = prefill_batch(torch, model)
    S = batch["tokens"].shape[1]
    ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True, use_flash=True)
    ids = []

    def forward():
        return model.forward(batch, ctx, last_only=True)[0]

    with torch.no_grad():
        with dispatch_ids(ops, ids):
            first = forward()
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        if launches != expected_launches(cfg):
            raise AssertionError(f"EP bf16 prefill launches {launches}")
        spent, real = [], coll.all_reduce

        def timed(t, group):  # gloo's all-reduce, its copies included
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = real(t, group)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t1)
            return out

        dist.barrier()
        coll.all_reduce = timed
        try:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            timed_wall = time.perf_counter() - t0
        finally:
            coll.all_reduce = real
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa
                        or getattr(e, "self_cuda_time_total", 0.0))
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    copy_s = sum(dev_us(e) for e in copies) / 1e6
    top = [(e.key[:60], dev_us(e) / 1e6) for e in
           sorted(kernels, key=dev_us, reverse=True)[:4]]
    peak = torch.cuda.max_memory_allocated() / 2**30
    same_bits = bool(torch.equal(first, logits))
    V = cfg.vocab_size  # the pad columns are -1e30 in both
    want = torch.from_numpy(ref["logits"]).to(DEVICE)
    err = rel_err(torch, logits[..., :V], want[..., :V])
    finite = bool(torch.isfinite(logits[..., :V]).all())
    differ = routes_differ(ids, ref["ids"], cfg, mesh)
    del model, logits, first, want, ids
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "held": held, "draw_s": draw_s,
            "wall_s": wall, "timed_wall_s": timed_wall,
            "allreduce_s": sum(spent), "allreduces": len(spent),
            "busy_s": busy_s, "copy_s": copy_s, "top": top,
            "peak_gib": peak, "err": err,
            "differ": differ, "routes": cfg.n_layers * S * cfg.top_k,
            "same_bits": same_bits, "finite": finite, "experts": [
                cfg.n_experts // mesh.shape["model"], cfg.n_experts],
            "launches": launches}


def run_rank_processes(fn, where: str, ref: dict, label: str,
                       world: int = EP_WORLD, loader=None) -> list:
    """``world`` spawned processes of ``fn(rank, world, where, ref)``,
    waited for at most EP_WALL_S (a rank that fails fails the phase);
    returns each rank's saved results: ``rank<r>.json``, or with
    ``loader`` (``torch.load``) ``rank<r>.pt``."""
    import torch.multiprocessing as mp
    procs = mp.start_processes(fn, args=(world, where, ref),
                               nprocs=world, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + EP_WALL_S
    while not procs.join(timeout=5):
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise AssertionError(f"[{label}] the ranks did not finish in "
                                 f"{EP_WALL_S} s")
    if loader is not None:
        return [loader(os.path.join(where, f"rank{r}.pt"))
                for r in range(world)]
    ranks = []
    for r in range(world):
        with open(os.path.join(where, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def ep_rank(rank: int, world: int, where: str, ref: dict) -> None:
    """One rank of the expert-parallel phase, a process of its own: the
    collectives, then (a) and (b) over the (data 1, model 4) mesh; its
    results go to ``where``/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mt_start_rank(torch, rank, world, where)
    out = {"collectives": ep_collectives(torch)}
    mesh = make_mesh(EP_MESH, ("data", "model"), DEVICE)
    out["mesh"] = repr(mesh)
    out["f32"] = ep_float32(torch, mesh)
    out["bf16"] = ep_bf16(torch, mesh, ref)
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_ep(torch, smi: str) -> dict:
    """Explicit expert parallelism on the card: first the single-process
    bf16 prefill at EP_BF16_LAYERS layers ((b)'s reference: its last position's
    logits, each layer's dispatch, its time) and the same model with its
    experts in reverse order (that comparison's noise floor,
    ``reverse_experts``), then EP_WORLD processes over
    the (data 1, model 4) mesh, started together and waited for at most
    EP_WALL_S (a rank that fails fails the phase): the collectives, (a)
    and (b) (``ep_rank``). Returns the ranks' main-path launches summed:
    (a)'s prefill and serving and (b)'s timed prefill."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.models import Ctx, build_model

    label = "ep"
    torch.cuda.empty_cache()
    model = build_model(MOE_ARCH, EP_BF16_LAYERS)
    model.init_params(torch.Generator(DEVICE).manual_seed(SEED))
    batch = prefill_batch(torch, model)
    S = batch["tokens"].shape[1]
    ids = []
    with torch.no_grad():
        with dispatch_ids(ops, ids):
            want = model.forward(batch, Ctx(use_flash=True), last_only=True)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(batch, Ctx(use_flash=True), last_only=True)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
    ref = {"logits": want.float().cpu().numpy(),
           "ids": [t.cpu().numpy() for t in ids]}
    # The noise floor of (b)'s comparison: the single process again with
    # its experts in reverse order, the same function with its sums
    # rounded in another order (``reverse_experts``), held against itself
    E, V = model.cfg.n_experts, model.cfg.vocab_size
    reverse_experts(model)
    rev_ids = []
    with torch.no_grad(), dispatch_ids(ops, rev_ids):
        rev = model.forward(batch, Ctx(use_flash=True), last_only=True)[0]
    floor = {"err": rel_err(torch, rev[..., :V], want[..., :V]),
             "differ": sum(lost_routes(
                 w.reshape(E, -1), g.cpu().numpy().reshape(E, -1)[::-1])
                 for w, g in zip(ref["ids"], rev_ids))}
    del model, want, ids, batch, rev, rev_ids
    gc.collect()
    torch.cuda.empty_cache()
    where = tempfile.mkdtemp(prefix="ep_ranks_")
    t0 = time.perf_counter()
    try:
        ranks = run_rank_processes(ep_rank, where, ref, label)
    finally:
        shutil.rmtree(where, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    a0, b = ranks[0]["f32"], [r["bf16"] for r in ranks]
    log(f"[{label}] {EP_WORLD} ranks, one process each, on one card as a "
        f"(data {EP_MESH[0]}, model {EP_MESH[1]}) mesh: "
        f"{ranks[0]['mesh']}; transport gloo (NCCL refuses two ranks on "
        f"one device) on CUDA tensors, gloo staging them through the "
        f"host itself; the ranks' run "
        f"{ranks_s:.1f} s")
    log(f"[{label}] collectives on the four ranks (CUDA tensors, the CPU "
        f"tests' sizes): two_stage_aggregate, broadcast_join, "
        f"hash_partition_join, grad_reduce_two_stage equal to the "
        f"single-process answer; pipeline_forward at 4 stages max |err| "
        f"{max(r['collectives']['pipeline_err'] for r in ranks):.3g} "
        f"(bound 2e-5)")
    log(f"[{label} a] {MOE_ARCH} float32, every published width, "
        f"{a0['layers']} of 24 layers: {a0['held'] / 1e9:.3f} B parameters "
        f"a rank ({b[0]['experts'][0]} of {b[0]['experts'][1]} experts), "
        f"drawn in turns in "
        f"{max(r['f32']['draw_s'] for r in ranks):.1f} s; prefill B=1 S={S} "
        f"in {a0['prefill_s']:.2f} s: max |log_softmax - the single "
        f"process's| {a0['err']:.3g} over every position (bound {EP_TOL}), "
        f"aux {a0['aux']:.6f} (single {a0['want_aux']:.6f}), every rank's "
        f"logits the same bits, (token, expert) routes the single process "
        f"keeps and the ranks do not: "
        f"{sum(r['f32']['differ'] for r in ranks)} of {a0['routes']}; "
        f"serving {a0['finished']} requests, "
        f"{a0['served']} tokens in {a0['serve_s']:.1f} s ({a0['iters']} "
        f"steps), token for token the single process's engine; peak "
        f"memory a rank {max(r['f32']['peak_gib'] for r in ranks):.2f} GiB")
    busy = sum(r["busy_s"] for r in b)
    copied = sum(r["copy_s"] for r in b)
    wall = max(r["wall_s"] for r in b)
    share = max(r["allreduce_s"] / r["timed_wall_s"] for r in b)
    log(f"[{label} b] {MOE_ARCH} bf16, {b[0]['layers']} of 24 layers: "
        f"{b[0]['held'] / 1e9:.3f} B parameters a rank, drawn in turns in "
        f"{max(r['draw_s'] for r in b):.1f} s; prefill B=1 S={S}: "
        f"{wall * 1e3:.1f} ms, {S / wall:.0f} tokens/s (ranks "
        f"{', '.join(f'{r['wall_s'] * 1e3:.1f}' for r in b)} ms), against "
        f"the single process's {single_s * 1e3:.1f} ms, {S / single_s:.0f} "
        f"tokens/s in this run; peak memory a rank "
        f"{max(r['peak_gib'] for r in b):.2f} GiB; the card's kernels "
        f"{busy / wall:.1%} of the wall (the ranks' kernels, copies not "
        f"counted: {', '.join(f'{r['busy_s'] * 1e3:.1f}' for r in b)} ms), "
        f"its copies and memsets {copied / wall:.1%} ("
        f"{', '.join(f'{r['copy_s'] * 1e3:.1f}' for r in b)} ms); "
        f"all-reduce {share:.1%} of the wall in a run with each of its "
        f"{b[0]['allreduces']} all-reduces timed alone ("
        f"{', '.join(f'{r['allreduce_s'] * 1e3:.1f}' for r in b)} ms of "
        f"{', '.join(f'{r['timed_wall_s'] * 1e3:.1f}' for r in b)} ms); "
        f"{smi}")
    log(f"[{label} b] rank 0's top kernels: " + "; ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in b[0]["top"]))
    differ = sum(r["differ"] for r in b)
    log(f"[{label} b] last position's logits against the single process's: "
        f"{b[0]['err']:.3g} of the largest (LOGITS_TOL {LOGITS_TOL}); "
        f"(token, expert) routes kept by the single process and not by the "
        f"ranks: {differ} of {b[0]['routes']}; the timed run's logits the "
        f"warm run's bits: {all(r['same_bits'] for r in b)}")
    log(f"[{label} b] noise floor, the single process against itself with "
        f"its experts in reverse order (each token's k expert outputs added "
        f"in the opposite order in bf16, the router's softmax summed in the "
        f"opposite order): {floor['differ']} of {b[0]['routes']} routes "
        f"differ, the last position's logits {floor['err']:.3g} of the "
        f"largest apart")
    if not all(r["finite"] for r in b) or not b[0]["err"] < LOGITS_TOL:
        raise AssertionError(f"[{label} b] logits off by {b[0]['err']} of "
                             f"the largest (LOGITS_TOL {LOGITS_TOL}), or not "
                             f"finite")
    runs = [run for r in ranks for run in r["f32"]["launches"]] + [
        r["bf16"]["launches"] for r in ranks]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    log(f"[{label}] launches over the ranks' main-path runs ((a)'s prefill "
        f"and serving, (b)'s timed prefill): {json.dumps(launches)}")
    return {"launches": launches, "tokens_per_s": S / wall,
            "single_tokens_per_s": S / single_s, "floor": floor}


# ------------------------------------------------------------ phase 18d
def tp_prompts(torch, cfg):
    """TP_DECODE_BATCH rows of TP_DECODE_STEPS tokens drawn from SEED:
    the first TP_PROMPT the prompt, the rest what a greedy run fills in."""
    import numpy as np
    return torch.from_numpy(np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, (TP_DECODE_BATCH, TP_DECODE_STEPS))).to(DEVICE)


def tp_decode(torch, model, tokens, ctx=None, greedy: bool = False,
              kv_layout: str = "paged"):
    """Decode over the paged pool (page PAGE_SIZE; ``kv_layout="dense"``:
    the dense cache) from an empty state, ``tokens`` (B, n) fed one column
    a step; with ``greedy``, each column past TP_PROMPT is instead the
    step before's argmax (the single process's run). Returns the tokens
    fed, each step's (B, V) float32 logits on the host and the state
    after the last step."""
    fed = tokens.clone()
    B, n = fed.shape
    state = model.init_decode_state(B, n + 4, model.dtype,
                                    kv_layout=kv_layout, page_size=PAGE_SIZE,
                                    ctx=ctx)
    steps = []
    for t in range(n):
        logits, state = model.decode_step(fed[:, t:t + 1], state, ctx)
        steps.append(logits[:, 0].float().cpu())
        if greedy and TP_PROMPT <= t + 1 < n:
            fed[:, t + 1] = logits[:, 0].argmax(-1)
    return fed, steps, state


def tp_single(torch, arch, layers: int, dtype, where: str, label: str
              ) -> dict:
    """The single process in the parent, before the ranks: its plain
    prefill (``Ctx()``: (a) every position's logits, written to ``where``
    for the ranks to read; (b) the last position's), for (b) its flash
    prefill timed, its greedy paged decode and its paged serving; then
    freed."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(arch, layers).init_params(
        torch.Generator(DEVICE).manual_seed(SEED), dtype)
    torch.cuda.synchronize()
    out = {"params": model.param_count(),
           "draw_s": time.perf_counter() - t0}
    cfg = model.cfg
    batch = prefill_batch(torch, model)
    with torch.no_grad():
        if dtype == torch.float32:
            want = model.forward(batch, Ctx())[0][0]
            path = os.path.join(where, f"{label}_logits.npy")
            np.save(path, want.cpu().numpy())
            out["logits"] = path
        else:
            want = model.forward(batch, Ctx(), last_only=True)[0]
            out["logits"] = want.cpu().numpy()
            model.forward(batch, Ctx(use_flash=True), last_only=True)
            walls = []
            for _ in range(TP_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.forward(batch, Ctx(use_flash=True), last_only=True)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out["prefill_s"] = sorted(walls)[len(walls) // 2]
        del want
        fed, steps, _ = tp_decode(torch, model, tp_prompts(torch, cfg),
                                  greedy=True)
        out["fed"] = fed.cpu().numpy()
        out["steps"] = [s.numpy() for s in steps]
        ops.reset_launch_counts()
        served = serve_model(model, kv_layout="paged", page_size=PAGE_SIZE,
                             **EP_SERVE)
    out.update(served=served["outputs"], serve_s=served["seconds"],
               serve_tokens=served["tokens"],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank_model(torch, mesh, arch, layers: int, dtype):
    """This rank's slices of ``arch`` under ``param_specs``, drawn in
    turns from SEED, and its plan, context and draw time."""
    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.models import Ctx, build_model

    model = build_model(arch, layers)
    plan = make_plan(model.cfg, mesh.shape, get_shape("prefill_32k"),
                     hbm_bytes=torch.cuda.get_device_properties(0)
                     .total_memory)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.init_shards(torch.Generator(DEVICE).manual_seed(SEED), plan, mesh,
                      dtype)
    torch.cuda.synchronize()
    return (model, Ctx(plan=plan, mesh=mesh, use_flash=True),
            time.perf_counter() - t0)


def tp_decode_and_serve(torch, model, ctx, ref: dict) -> dict:
    """Teacher-forced paged decode fed the single process's tokens, each
    step's logits beside its, and the paged engine; both runs' launches
    checked."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx

    cfg = model.cfg
    V = cfg.vocab_size
    fed = torch.from_numpy(ref["fed"]).to(DEVICE)
    ops.reset_launch_counts()
    with torch.no_grad():
        _, steps, _ = tp_decode(torch, model, fed, ctx)
    torch.cuda.synchronize()
    decode = ops.launch_counts()
    if decode != decode_launches(cfg, fed.shape[1]):
        raise AssertionError(f"tp decode launches {decode}")
    rel = [rel_err(torch, got[:, :V], torch.from_numpy(want[:, :V]))
           for got, want in zip(steps, ref["steps"])]
    lsm = [log_softmax_err(torch, got[:, :V], torch.from_numpy(want[:, :V]))
           for got, want in zip(steps, ref["steps"])]
    # the argmax each step against the token the single process chose
    argmax = sum(int((got[:, :V].argmax(-1) != torch.from_numpy(
        ref["fed"][:, t + 1])).sum()) for t, got in enumerate(steps[:-1])
        if t + 1 >= TP_PROMPT)
    ops.reset_launch_counts()
    with torch.no_grad():
        served = serve_model(model, ctx=Ctx(plan=ctx.plan, mesh=ctx.mesh),
                             kv_layout="paged", page_size=PAGE_SIZE,
                             **EP_SERVE)
    serve = ops.launch_counts()
    if serve != decode_launches(cfg, served["iters"]):
        raise AssertionError(f"tp serve launches {serve}")
    differ = sum(sum(a != b for a, b in zip(got, want))
                 + abs(len(got) - len(want))
                 for got, want in zip(served["outputs"], ref["served"]))
    return {"decode_rel": max(rel), "decode_lsm": max(lsm),
            "argmax_differ": argmax, "served": served["outputs"],
            "served_differ": differ, "serve_s": served["seconds"],
            "serve_tokens": served["tokens"], "iters": served["iters"],
            "launches": [decode, serve]}


def tp_float32(torch, mesh, ref: dict) -> dict:
    """(a): gemma-7b float32 at TP_F32_LAYERS layers; the split prefill at
    every position against the single process's plain forward, every
    rank's logits the same bits; decode and serving against the single
    process's."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.kernels import ops

    model, ctx, draw_s = tp_rank_model(torch, mesh, TP_F32_ARCH,
                                       TP_F32_LAYERS, torch.float32)
    cfg = model.cfg
    held = sum(p.numel() for p in model.parameters())
    batch = prefill_batch(torch, model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.forward(batch, ctx)[0][0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill = ops.launch_counts()
    if prefill != expected_launches(cfg):
        raise AssertionError(f"tp float32 prefill launches {prefill}")
    V = cfg.vocab_size  # the pad columns are -1e30 in both
    want = np.load(ref["logits"], mmap_mode="r")
    err, sums = 0.0, [0.0, 0.0]
    for i in range(0, logits.shape[0], 512):
        block = logits[i:i + 512]
        err = max(err, log_softmax_err(torch, block[:, :V], torch.from_numpy(
            np.array(want[i:i + 512, :V])).to(DEVICE)))
        block = block.double()
        sums = [sums[0] + float(block.sum()),
                sums[1] + float(block.square().sum())]
    del logits, want
    torch.cuda.empty_cache()
    every = [None] * mesh.size
    dist.all_gather_object(every, sums)
    if any(s != every[0] for s in every):
        raise AssertionError(f"the ranks' logits differ: {every}")
    if not err < EP_TOL:
        raise AssertionError(f"tp float32 log_softmax off by {err}")
    rest = tp_decode_and_serve(torch, model, ctx, ref)
    if rest["decode_lsm"] >= EP_TOL or rest["argmax_differ"]:
        raise AssertionError(f"tp float32 decode: {rest}")
    if rest["served"] != ref["served"]:
        raise AssertionError("tp float32 engine's tokens differ from the "
                             "single process's")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "held": held, "draw_s": draw_s,
            "prefill_s": prefill_s, "err": err, "peak_gib": peak,
            **{k: v for k, v in rest.items() if k != "launches"},
            "launches": [prefill, *rest["launches"]]}


def tp_bf16(torch, mesh, ref: dict) -> dict:
    """(b): nemotron-4-340b bf16 at TP_BF16_LAYERS layers; a warm prefill,
    TP_TIMED timed (the main path's), one with every all-reduce and the
    all-gather timed alone, one under the profiler; the last position's
    logits, each teacher-forced decode step's and the engine's tokens
    against the single process's."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import ops

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, ctx, draw_s = tp_rank_model(torch, mesh, TP_BF16_ARCH,
                                       TP_BF16_LAYERS, torch.bfloat16)
    cfg = model.cfg
    held = sum(p.numel() for p in model.parameters())
    batch = prefill_batch(torch, model)

    def forward():
        return model.forward(batch, ctx, last_only=True)[0]

    with torch.no_grad():
        first = forward()
        walls, launches = [], None
        for _ in range(TP_TIMED):
            torch.cuda.synchronize()
            dist.barrier()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits = forward()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            if launches != expected_launches(cfg):
                raise AssertionError(f"tp bf16 prefill launches {launches}")
        spent = {"all_reduce": [], "all_gather": []}
        real = {name: getattr(coll, name) for name in spent}

        def timer(name):
            def timed(*args, **kw):  # gloo's call, its copies included
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = real[name](*args, **kw)
                torch.cuda.synchronize()
                spent[name].append(time.perf_counter() - t1)
                return out
            return timed

        dist.barrier()
        for name in spent:
            setattr(coll, name, timer(name))
        try:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            timed_wall = time.perf_counter() - t0
        finally:
            for name, fn in real.items():
                setattr(coll, name, fn)
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa
                        or getattr(e, "self_cuda_time_total", 0.0))
    V = cfg.vocab_size
    err = rel_err(torch, logits[..., :V],
                  torch.from_numpy(ref["logits"]).to(DEVICE)[..., :V])
    finite = bool(torch.isfinite(logits[..., :V]).all())
    same_bits = bool(torch.equal(first, logits))
    del logits, first
    rest = tp_decode_and_serve(torch, model, ctx, ref)
    every = [None] * mesh.size
    dist.all_gather_object(every, rest["served"])
    if any(s != every[0] for s in every):
        raise AssertionError("tp bf16: the ranks served different tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not (finite and err < LOGITS_TOL and rest["decode_rel"] < LOGITS_TOL):
        raise AssertionError(f"tp bf16 logits off by {err} (prefill), "
                             f"{rest['decode_rel']} (decode) of the largest, "
                             f"or not finite")
    return {"layers": cfg.n_layers, "held": held, "draw_s": draw_s,
            "wall_s": sorted(walls)[len(walls) // 2], "walls": walls,
            "timed_wall_s": timed_wall,
            "allreduce_s": sum(spent["all_reduce"]),
            "allreduces": len(spent["all_reduce"]),
            "allgather_s": sum(spent["all_gather"]),
            "busy_s": sum(dev_us(e) for e in kernels) / 1e6,
            "copy_s": sum(dev_us(e) for e in copies) / 1e6,
            "top": [(e.key[:60], dev_us(e) / 1e6) for e in
                    sorted(kernels, key=dev_us, reverse=True)[:4]],
            "peak_gib": peak, "err": err, "same_bits": same_bits,
            **{k: v for k, v in rest.items() if k != "launches"},
            "launches": [launches, *rest["launches"]]}


def tp_rank(rank: int, world: int, where: str, ref: dict) -> None:
    """One rank of the tensor-parallel phase, a process of its own: (a)
    and (b) over the (data 1, model 4) mesh; its results go to
    ``where``/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mt_start_rank(torch, rank, world, where)
    mesh = make_mesh(EP_MESH, ("data", "model"), DEVICE)
    out = {"mesh": repr(mesh), "f32": tp_float32(torch, mesh, ref["f32"]),
           "bf16": tp_bf16(torch, mesh, ref["bf16"])}
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_tp(torch, smi: str) -> dict:
    """The tensor-parallel split of the dense layers on the card: the
    single process first, in this process ((a) gemma-7b float32 and (b)
    nemotron-4-340b bf16, each freed before the next), then EP_WORLD
    processes over the (data 1, model 4) mesh (``tp_rank``). Returns the
    ranks' main-path launches summed: (a)'s prefill, decode and serving,
    (b)'s last timed prefill, decode and serving."""
    import shutil
    import tempfile

    label = "tp"
    where = tempfile.mkdtemp(prefix="tp_ranks_")
    try:
        t0 = time.perf_counter()
        ref = {"f32": tp_single(torch, TP_F32_ARCH, TP_F32_LAYERS,
                                torch.float32, where, "f32"),
               "bf16": tp_single(torch, TP_BF16_ARCH, TP_BF16_LAYERS,
                                 torch.bfloat16, where, "bf16")}
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_rank_processes(tp_rank, where, ref, label)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    a, b = [r["f32"] for r in ranks], [r["bf16"] for r in ranks]
    S, sa, sb = PREFILL_SEQ, ref["f32"], ref["bf16"]
    log(f"[{label}] {EP_WORLD} ranks, one process each, on one card as a "
        f"(data {EP_MESH[0]}, model {EP_MESH[1]}) mesh: {ranks[0]['mesh']}; "
        f"heads, ff and vocab split over the model axis "
        f"(``param_specs``), one all-reduce for the embedding and for each "
        f"layer's attention and FFN, one all-gather of the logits; the "
        f"single processes {single_s:.1f} s, the ranks' run {ranks_s:.1f} s")
    log(f"[{label} a] {TP_F32_ARCH} float32, every published width, "
        f"{a[0]['layers']} of 28 layers ({sa['params'] / 1e9:.3f} B "
        f"parameters): {a[0]['held'] / 1e9:.3f} B a rank, drawn in turns in "
        f"{max(r['draw_s'] for r in a):.1f} s; prefill B=1 S={S} in "
        f"{max(r['prefill_s'] for r in a):.2f} s: max |log_softmax - the "
        f"single process's plain forward| {max(r['err'] for r in a):.3g} "
        f"over every position (bound {EP_TOL}), every rank's logits the "
        f"same bits; paged decode of {TP_DECODE_STEPS} steps at B="
        f"{TP_DECODE_BATCH} fed the single process's greedy tokens: max "
        f"|log_softmax diff| {max(r['decode_lsm'] for r in a):.3g}, argmax "
        f"differs {sum(r['argmax_differ'] for r in a)} times; paged serving "
        f"{a[0]['serve_tokens']} tokens in {a[0]['serve_s']:.1f} s "
        f"({a[0]['iters']} steps), token for token the single process's "
        f"engine; peak memory a rank {max(r['peak_gib'] for r in a):.2f} GiB")
    busy = sum(r["busy_s"] for r in b)
    copied = sum(r["copy_s"] for r in b)
    wall = max(r["wall_s"] for r in b)
    reduce_share = max(r["allreduce_s"] / r["timed_wall_s"] for r in b)
    gather_share = max(r["allgather_s"] / r["timed_wall_s"] for r in b)
    log(f"[{label} b] {TP_BF16_ARCH} bf16, every published width, "
        f"{b[0]['layers']} of 96 layers ({sb['params'] / 1e9:.3f} B "
        f"parameters, the single process's peak {sb['peak_gib']:.2f} GiB): "
        f"{b[0]['held'] / 1e9:.3f} B a rank, drawn in turns in "
        f"{max(r['draw_s'] for r in b):.1f} s; prefill B=1 S={S}, median of "
        f"{TP_TIMED} after a warm run: {wall * 1e3:.1f} ms, {S / wall:.0f} "
        f"tokens/s (rank 0's runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in b[0]['walls'])} ms), against "
        f"the single process's flash prefill {sb['prefill_s'] * 1e3:.1f} ms, "
        f"{S / sb['prefill_s']:.0f} tokens/s in this run; peak memory a "
        f"rank {max(r['peak_gib'] for r in b):.2f} GiB; the card's kernels "
        f"{busy / wall:.1%} of the wall (the ranks' kernels, copies not "
        f"counted: {', '.join(f'{r['busy_s'] * 1e3:.1f}' for r in b)} ms), "
        f"its copies and memsets {copied / wall:.1%} ("
        f"{', '.join(f'{r['copy_s'] * 1e3:.1f}' for r in b)} ms); in a run "
        f"with each collective timed alone, the {b[0]['allreduces']} "
        f"all-reduces {reduce_share:.1%} of the wall ("
        f"{', '.join(f'{r['allreduce_s'] * 1e3:.1f}' for r in b)} ms of "
        f"{', '.join(f'{r['timed_wall_s'] * 1e3:.1f}' for r in b)} ms) and "
        f"the logits' all-gather {gather_share:.1%}; {smi}")
    log(f"[{label} b] rank 0's top kernels: " + "; ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in b[0]["top"]))
    log(f"[{label} b] last position's logits against the single process's "
        f"plain forward: {b[0]['err']:.3g} of the largest (LOGITS_TOL "
        f"{LOGITS_TOL}); the timed run's logits the warm run's bits: "
        f"{all(r['same_bits'] for r in b)}; paged decode fed the single "
        f"process's greedy tokens ({TP_DECODE_STEPS} steps at B="
        f"{TP_DECODE_BATCH}): worst step {max(r['decode_rel'] for r in b):.3g} "
        f"of the largest, argmax differs "
        f"{max(r['argmax_differ'] for r in b)} times; paged serving "
        f"{b[0]['serve_tokens']} tokens in {b[0]['serve_s']:.1f} s "
        f"({b[0]['iters']} steps; the single process "
        f"{sb['serve_tokens']} in {sb['serve_s']:.1f} s), the same tokens "
        f"on every rank, {b[0]['served_differ']} of them differ from the "
        f"single process's")
    runs = [run for r in ranks for run in r["f32"]["launches"]] + [
        run for r in ranks for run in r["bf16"]["launches"]]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    log(f"[{label}] launches over the ranks' main-path runs ((a)'s prefill, "
        f"decode and serving, (b)'s last timed prefill, decode and "
        f"serving): {json.dumps(launches)}")
    return {"launches": launches, "tokens_per_s": S / wall,
            "single_tokens_per_s": S / sb["prefill_s"]}


# ------------------------------------------------------------ phase 18e
def mt_start_rank(torch, rank: int, world: int, where: str):
    """Join the ranks' gloo group on the card (TF32 off, as the single
    process runs), with one intra-op thread: the ranks share the host's
    cores (sixteen ranks of one thread a core took 2.5-3.0 s a decode step
    of phase 18h, 0.67 s with one thread each, on an H100 80GB HBM3's
    host at 700 W)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_ranks(rank, world, device=DEVICE, timeout_s=EP_WALL_S,
               store=dist.FileStore(os.path.join(where, "store"), world))


def mt_digests(torch, model, params) -> dict:
    """sha256 of the bytes of every leaf this rank holds whole."""
    import hashlib

    from repro_torch.models.params import flatten, tree_paths

    whole = {k: d.shape for k, d in tree_paths(model.defs).items()}
    return {k: hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
            for k, t in flatten(params).items()
            if tuple(t.shape) == tuple(whole[k])}


def mt_history(out: dict) -> dict:
    return {"loss": [h["loss"] for h in out["history"]],
            "grad_norm": [h["grad_norm"] for h in out["history"]],
            "seconds": [h["seconds"] for h in out["history"]]}


def timed_collectives(torch, names, key=None):
    """Wrap each of ``collectives``' functions ``names`` to time every
    call alone (the card synchronised on either side; gloo's own copies
    inside); returns (the seconds of each call by name, or by ``key(name,
    tensor)`` where given, and undo)."""
    from repro_torch.distributed import collectives as coll
    spent = {name: [] for name in names} if key is None else {}
    real = {name: getattr(coll, name) for name in names}

    def timer(name):
        def timed(t, *args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = real[name](t, *args, **kw)
            torch.cuda.synchronize()
            spent.setdefault(name if key is None else key(name, t),
                             []).append(time.perf_counter() - t1)
            return got
        return timed

    for name in names:
        setattr(coll, name, timer(name))

    def undo():
        for name, fn in real.items():
            setattr(coll, name, fn)
    return spent, undo


def mt_full_width(torch, mesh) -> dict:
    """(a) on this rank: ``train_loop`` over the mesh (the main path,
    launches counted from 0), then one more step of the same state with
    every collective timed alone (the card synchronised on either side;
    gloo's own copies inside), one uninstrumented and one under the
    profiler (kernels and copies apart)."""
    import numpy as np
    import torch.distributed as dist

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tr
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.planner import make_plan
    from repro_torch.engine import TrainConfig, make_train_step, shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import AdamWConfig, constant

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_loop(MOE_ARCH, reduced=False, layers=TRAIN_LAYERS,
                     steps=MT_A_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     records=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED, mesh=mesh,
                     log_every=MT_A_STEPS + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    model = build_model(MOE_ARCH, TRAIN_LAYERS)  # meta: the config only
    res = {"wall_s": wall, "launches": launches, **mt_history(out),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "held": sum(t.numel() for t in tr.leaves(out["params"])),
           "digests": mt_digests(torch, model, out["params"])}

    plan = make_plan(model.cfg, mesh.shape, ShapeConfig(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True)
    step = make_train_step(model, ctx, TrainConfig(
        opt=AdamWConfig(moment_dtype="float32")), constant(TRAIN_LR))
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
        dtype=np.int32))
    batch = {k: t.to(mesh.device) for k, t in shard_batch(
        {"tokens": toks, "labels": toks}, ctx).items()}
    state = [out["params"], out["opt"]]
    del out

    def one():
        state[0], state[1], _, m = step(state[0], state[1], None, batch)
        return float(m["total_loss"])

    dist.barrier()
    spent, undo = timed_collectives(
        torch, ("all_reduce", "all_reduce_max", "all_gather"))
    try:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        res["timed_wall_s"] = time.perf_counter() - t0
    finally:
        undo()
    res["collective_s"] = {k: sum(v) for k, v in spent.items()}
    res["collectives"] = {k: len(v) for k, v in spent.items()}
    dist.barrier()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    res["step_s"] = time.perf_counter() - t0
    dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa
                        or getattr(e, "self_cuda_time_total", 0.0))
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    res["busy_s"] = sum(dev_us(e) for e in events if e not in copies) / 1e6
    res["copy_s"] = sum(dev_us(e) for e in copies) / 1e6
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mt_gemma_config():
    """MT_B_ARCH with ``fsdp=False``, the only edit: 18e (b) holds the
    split path without FSDP; 18f (a) runs the published plan."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MT_B_ARCH), fsdp=False)


def mt_gemma(torch, mesh, steps: int, ckpt: Optional[str] = None,
             cfg=None) -> dict:
    """18e (b) and 18f (a) on this rank: ``train_loop`` of ``cfg``
    (default ``mt_gemma_config()``) over ``mesh`` to step ``steps``; with
    ``ckpt``, under the supervisor, saving to (or resuming from) it."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop

    spent = {"save": [], "restore": []}
    real = {name: getattr(Checkpointer, name) for name in spent}

    def timer(name):
        def timed(*args, **kw):
            t1 = time.perf_counter()
            got = real[name](*args, **kw)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t1)
            return got
        return timed

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    ops.reset_launch_counts()
    for name in spent:
        setattr(Checkpointer, name, timer(name))
    t0 = time.perf_counter()
    try:
        out = train_loop(cfg or mt_gemma_config(), reduced=False,
                         layers=MT_B_LAYERS, steps=steps, batch=MT_B_BATCH,
                         seq=MT_B_SEQ, lr=TRAIN_LR, seed=SEED, mesh=mesh,
                         ckpt_dir=ckpt, save_every=MT_B_SAVE,
                         log_every=steps + 1)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(Checkpointer, name, fn)
    res = {"wall_s": time.perf_counter() - t0, "save_s": spent["save"],
           "restore_s": spent["restore"],
           "launches": ops.launch_counts(), **mt_history(out),
           "restored_from": (out["report"].restored_from
                             if out["report"] else []),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "mesh": repr(mesh)}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mt_rank(rank: int, world: int, where: str, ref: dict) -> None:
    """One rank of phase 18e's four, a process of its own: (a) over
    MT_A_MESH, then (b) over MT_B_MESH; its results go to
    ``where``/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mt_start_rank(torch, rank, world, where)
    out = {"a": mt_full_width(torch, make_mesh(MT_A_MESH, ("data", "model"),
                                                DEVICE)),
           "b": mt_gemma(torch, make_mesh(MT_B_MESH, ("data", "model"),
                                          DEVICE), MT_B_STEPS)}
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def mt_within(got: list, want: list) -> float:
    """The largest |got - want| / |want| over the steps."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_mesh_train(torch, smi: str, train: dict) -> dict:
    """Training over the (data, model) mesh on the split placement: the
    single process first, in this process ((a) reuses phase 18a's
    history; (b) runs here and is freed), then four spawned processes
    for (a) and (b) (``mt_rank``). Returns the ranks' main-path launches
    summed."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model

    label = "mesh train"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gemma = train_loop(mt_gemma_config(), reduced=False, layers=MT_B_LAYERS,
                       steps=MT_B_STEPS, batch=MT_B_BATCH, seq=MT_B_SEQ,
                       lr=TRAIN_LR, seed=SEED, device=DEVICE,
                       log_every=MT_B_STEPS + 1)
    gemma_params = build_model(mt_gemma_config(), MT_B_LAYERS).param_count()
    gemma = mt_history(gemma)
    gc.collect()
    torch.cuda.empty_cache()
    single_s = time.perf_counter() - t0
    where = tempfile.mkdtemp(prefix="mt_ranks_")
    try:
        t0 = time.perf_counter()
        ranks = run_rank_processes(mt_rank, where, {}, label)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)

    # (a) against the first MT_A_STEPS of phase 18a's history
    cfg = build_model(MOE_ARCH, TRAIN_LAYERS).cfg
    a = [r["a"] for r in ranks]
    want = train["history"][:MT_A_STEPS]
    loss_err = max(mt_within(r["loss"], [h["loss"] for h in want])
                   for r in a)
    norm_err = max(mt_within(r["grad_norm"],
                             [h["grad_norm"] for h in want]) for r in a)
    per_step = train_launches(cfg, MT_A_STEPS)
    for r in a:
        full = {**{k: 0 for k in r["launches"]}, **per_step}
        if r["launches"] != full:
            raise AssertionError(f"[{label} a] launches {r['launches']}, "
                                 f"want {full}")
    digests = a[0]["digests"]
    same_bits = all(r["digests"] == digests for r in a)
    if not (same_bits and loss_err <= TRAIN_LOSS_TOL
            and norm_err <= TRAIN_LOSS_TOL
            and all(np.isfinite(r["loss"]).all() for r in a)):
        raise AssertionError(
            f"[{label} a] losses {a[0]['loss']} against phase 18a's "
            f"{[h['loss'] for h in want]} ({loss_err:.3g}), gradient norms "
            f"{norm_err:.3g}, whole leaves the same bits: {same_bits}")
    tokens = TRAIN_TOKENS
    log(f"[{label}] {EP_WORLD} ranks, one process each, sharing the card "
        f"(gloo on CUDA tensors); the single process (b) {single_s:.1f} s, "
        f"the ranks' run for (a) and (b) {ranks_s:.1f} s; {smi}")
    log(f"[{label} a] {cfg.name} at every published width, {cfg.n_layers} "
        f"of 24 layers, float32 weights and AdamW moments, over (data "
        f"{MT_A_MESH[0]}, model {MT_A_MESH[1]}): {a[0]['held'] / 1e9:.3f} B "
        f"parameters a rank; B={TRAIN_BATCH} x {TRAIN_SEQ + 1} tokens, one "
        f"repeated batch, the first {MT_A_STEPS} of its {TRAIN_STEPS} steps "
        f"at lr {TRAIN_LR}: losses "
        f"{[round(x, 6) for x in a[0]['loss']]}, gradient norms "
        f"{[round(x, 6) for x in a[0]['grad_norm']]}; phase 18a's within "
        f"{loss_err:.3g} (losses) and {norm_err:.3g} (norms) relative (tol "
        f"{TRAIN_LOSS_TOL}); the {len(digests)} whole leaves the same bits "
        f"on every rank; train_loop {max(r['wall_s'] for r in a):.1f} s; "
        f"{smi}")
    for i in range(MT_A_STEPS):
        s = max(r["seconds"][i] for r in a)
        log(f"[{label} a] step {i}: {s * 1e3:.1f} ms (ranks "
            f"{', '.join(f'{r['seconds'][i] * 1e3:.1f}' for r in a)}), "
            f"{tokens / s:.0f} tokens/s; {smi}")
    step_s = max(r["step_s"] for r in a)
    coll_s = [sum(r["collective_s"].values()) for r in a]
    busy = sum(r["busy_s"] for r in a)
    copied = sum(r["copy_s"] for r in a)
    log(f"[{label} a] one more step, uninstrumented: {step_s * 1e3:.1f} ms "
        f"({tokens / step_s:.0f} tokens/s); with each collective timed "
        f"alone ({a[0]['collectives']} calls a rank): "
        f"{', '.join(f'{c * 1e3:.1f}' for c in coll_s)} ms of "
        f"{', '.join(f'{r['timed_wall_s'] * 1e3:.1f}' for r in a)} ms, "
        f"{max(c / r['timed_wall_s'] for c, r in zip(coll_s, a)):.1%} of "
        f"the wall (rank 0: {json.dumps({k: round(v * 1e3, 1) for k, v in a[0]['collective_s'].items()})} "
        f"ms); under the profiler the ranks' kernels "
        f"{', '.join(f'{r['busy_s'] * 1e3:.1f}' for r in a)} ms ("
        f"{min(r['busy_s'] for r in a) / step_s:.1%}-"
        f"{max(r['busy_s'] for r in a) / step_s:.1%} of the uninstrumented "
        f"step's wall each, {busy / step_s:.1%} summed: past 100% the "
        f"processes' kernels overlap on the card or their spans take in "
        f"one another's time slices, which the profiler does not tell "
        f"apart), their copies and memsets "
        f"{', '.join(f'{r['copy_s'] * 1e3:.1f}' for r in a)} ms "
        f"({copied / step_s:.1%} summed); peak "
        f"memory a rank {', '.join(f'{r['peak_gib']:.2f}' for r in a)} GiB, "
        f"{sum(r['peak_gib'] for r in a):.2f} GiB in all (the single "
        f"process's {train['peak_gib']:.2f}); launches a rank "
        f"{json.dumps(a[0]['launches'])}; {smi}")

    # (b) against the single process
    b = [r["b"] for r in ranks]
    b_loss = max(mt_within(r["loss"], gemma["loss"]) for r in b)
    b_norm = max(mt_within(r["grad_norm"], gemma["grad_norm"]) for r in b)
    if not (b_loss <= TRAIN_LOSS_TOL and b_norm <= TRAIN_LOSS_TOL
            and all(len(r["loss"]) == MT_B_STEPS for r in b)):
        raise AssertionError(
            f"[{label} b] losses {[r['loss'] for r in b]} against the "
            f"single process's {gemma['loss']}")
    gtok = MT_B_BATCH * (MT_B_SEQ + 1)
    log(f"[{label} b] {MT_B_ARCH} float32 at every published width, "
        f"{MT_B_LAYERS} of 28 layers ({gemma_params / 1e9:.3f} B "
        f"parameters; fsdp=False, the only edit), B={MT_B_BATCH} x "
        f"{MT_B_SEQ + 1} tokens: the single process's {MT_B_STEPS} steps "
        f"{[round(x, 6) for x in gemma['loss']]} "
        f"({', '.join(f'{s * 1e3:.1f}' for s in gemma['seconds'])} ms); "
        f"over {b[0]['mesh']}: {MT_B_STEPS} steps "
        f"({', '.join(f'{max(r['seconds'][i] for r in b) * 1e3:.1f}' for i in range(MT_B_STEPS))} "
        f"ms, {gtok / max(b[0]['seconds']):.0f} tokens/s at the slowest; "
        f"train_loop {max(r['wall_s'] for r in b):.1f} s, peak "
        f"{max(r['peak_gib'] for r in b):.2f} GiB a rank): losses "
        f"{[round(x, 6) for x in b[0]['loss']]}, the single process's "
        f"within {b_loss:.3g}, gradient norms within {b_norm:.3g} (tol "
        f"{TRAIN_LOSS_TOL}); {smi}")
    runs = [r[k]["launches"] for r in ranks for k in ("a", "b")]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    log(f"[{label}] launches over the ranks' main-path runs ((a)'s "
        f"{MT_A_STEPS} steps, (b)'s {MT_B_STEPS} a rank): "
        f"{json.dumps(launches)}")
    return {"launches": launches, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "gemma": gemma,
            "gemma_peak_gib": max(r["peak_gib"] for r in b)}


# ------------------------------------------------------------ phase 18f
def fsdp_moe(torch, mesh) -> dict:
    """(b) on this rank: ``train_loop`` of MOE_ARCH at FSDP_B_LAYERS over
    ``mesh`` (the main path, launches counted from 0), every collective
    timed alone in it: the seconds of the gathers (all-gather), the
    reduce-scatters and the all-reduces over the run, beside its wall."""
    import torch.distributed as dist

    from repro_torch import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    names = ("all_gather", "reduce_scatter", "all_reduce", "all_reduce_max")
    dist.barrier()
    spent, undo = timed_collectives(torch, names)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = train_loop(MOE_ARCH, reduced=False, layers=FSDP_B_LAYERS,
                         steps=FSDP_B_STEPS, batch=TRAIN_BATCH,
                         seq=TRAIN_SEQ, records=TRAIN_BATCH, lr=TRAIN_LR,
                         seed=SEED, mesh=mesh, log_every=FSDP_B_STEPS + 1)
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    res = {"wall_s": wall, "launches": ops.launch_counts(),
           **mt_history(out),
           "collective_s": {k: sum(v) for k, v in spent.items()},
           "collectives": {k: len(v) for k, v in spent.items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "held": sum(t.numel() for t in tr.leaves(out["params"]))}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fsdp_serve_model(torch, mesh):
    """(d)'s model on this rank: its blocks of MT_B_ARCH bf16 at
    FSDP_D_LAYERS under the serve plan's ``param_specs`` (FSDP on), drawn
    in turns from SEED, and its context."""
    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.models import Ctx, build_model

    model = build_model(MT_B_ARCH, FSDP_D_LAYERS)
    plan = make_plan(model.cfg, mesh.shape, get_shape("prefill_32k"))
    if not plan.fsdp:
        raise AssertionError(f"{MT_B_ARCH}'s serve plan: {plan.decisions}")
    model.init_shards(torch.Generator(DEVICE).manual_seed(SEED), plan, mesh,
                      torch.bfloat16)
    return model, Ctx(plan=plan, mesh=mesh, use_flash=True)


def fsdp_serve(torch, model, ctx, rows, tokens, steps) -> dict:
    """(d) on a model: the prefill of ``tokens``' ``rows`` through flash
    (its last logits), then paged decode of ``steps``' rows, each step's
    logits; the launches of each, counted from 0."""
    from repro_torch.kernels import ops

    B = rows.stop - rows.start
    out = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.forward({"tokens": tokens[rows]}, ctx,
                               last_only=True)[0]
    torch.cuda.synchronize()
    out.update(prefill_s=time.perf_counter() - t0,
               prefill=logits[:, 0].float().cpu(),
               prefill_launches=ops.launch_counts())
    state = model.init_decode_state(B, steps.shape[1] + 4, model.dtype,
                                    kv_layout="paged", page_size=PAGE_SIZE,
                                    ctx=ctx)
    ops.reset_launch_counts()
    walls, decode = [], []
    with torch.no_grad():
        for t in range(steps.shape[1]):
            t0 = time.perf_counter()
            logits, state = model.decode_step(steps[rows, t:t + 1], state,
                                              ctx)
            decode.append(logits[:, 0].float().cpu())
            walls.append(time.perf_counter() - t0)
    out.update(decode=decode, decode_s=walls,
               decode_launches=ops.launch_counts())
    return out


def fsdp_rank(rank: int, world: int, where: str, ref: dict) -> None:
    """One rank of 18f's four, a process of its own: (b) over
    FSDP_B_MESH, (a) over FSDP_A_MESHES (a save, then a restart), (d)
    over FSDP_D_MESH; its results to ``where``/rank<rank>.pt."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import flatten

    mt_start_rank(torch, rank, world, where)
    axes = ("data", "model")
    out = {"b": fsdp_moe(torch, make_mesh(FSDP_B_MESH, axes, DEVICE))}
    ckpt = os.path.join(where, "ckpt")
    cfg = build_model(MT_B_ARCH).cfg  # the published config
    out["a_save"] = mt_gemma(torch, make_mesh(FSDP_A_MESHES[0], axes,
                                              DEVICE), MT_B_SAVE, ckpt, cfg)
    if rank == 0:
        d = os.path.join(ckpt, f"step_{MT_B_SAVE}")
        out["ckpt_files"] = sorted(os.listdir(d))
        out["ckpt_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                for f in out["ckpt_files"])
    # the restart restores the save over another mesh and stops: a step
    # more would end in a second 12 GB save (its step and save, 37 s, went
    # when phase 18h came in)
    out["a_restart"] = mt_gemma(torch, make_mesh(FSDP_A_MESHES[1], axes,
                                                 DEVICE), MT_B_SAVE, ckpt,
                                cfg)
    mesh = make_mesh(FSDP_D_MESH, axes, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    model, ctx = fsdp_serve_model(torch, mesh)
    n = ref["tokens"].shape[0] // FSDP_D_MESH[0]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
    dist.barrier()
    out["d"] = fsdp_serve(torch, model, ctx, rows,
                          torch.from_numpy(ref["tokens"]).to(DEVICE),
                          torch.from_numpy(ref["steps"]).to(DEVICE))
    out["d"].update(rows=(rows.start, rows.stop), coords=mesh.coords,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    specs={k: tuple(v) for k, v in flatten(
                        model.param_specs(ctx.plan)).items()})
    del model
    torch.save(out, os.path.join(where, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_fsdp(torch, smi: str, train: dict, mesh_train: dict) -> dict:
    """FSDP over the data axis at the published plans: the single
    processes first, in this process ((a) reuses 18e (b)'s; (b) and (d)
    run here and are freed), then four spawned processes for (a), (b)
    and (d) (``fsdp_rank``). Returns the ranks' main-path launches
    summed."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model

    label = "fsdp"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe = train_loop(MOE_ARCH, reduced=False, layers=FSDP_B_LAYERS,
                     steps=FSDP_B_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     records=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                     device=DEVICE, log_every=FSDP_B_STEPS + 1)
    moe = {**mt_history(moe),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    gc.collect()
    torch.cuda.empty_cache()
    # (d)'s single process: bf16 from SEED, the prefill's last logits
    # through flash and each paged decode step's
    model = build_model(MT_B_ARCH, FSDP_D_LAYERS).init_params(
        torch.Generator(DEVICE).manual_seed(SEED), torch.bfloat16)
    rng = np.random.default_rng(SEED)
    rows = 2 * FSDP_D_MESH[0]
    tokens = rng.integers(0, model.cfg.vocab_size, (rows, FSDP_D_SEQ))
    steps = rng.integers(0, model.cfg.vocab_size, (rows, FSDP_D_STEPS))
    from repro_torch.models import Ctx
    serve = fsdp_serve(torch, model, Ctx(use_flash=True), slice(0, rows),
                       torch.from_numpy(tokens).to(DEVICE),
                       torch.from_numpy(steps).to(DEVICE))
    d_params = model.param_count()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    single_s = time.perf_counter() - t0
    where = tempfile.mkdtemp(prefix="fsdp_ranks_")
    try:
        t0 = time.perf_counter()
        ranks = run_rank_processes(fsdp_rank, where, {
            "tokens": tokens, "steps": steps}, label, loader=torch.load)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    log(f"[{label}] {EP_WORLD} ranks, one process each, sharing the card "
        f"(gloo on CUDA tensors), every model at its published plan "
        f"(fsdp=True, remat=\"full\"); the single processes ((b), (d)) "
        f"{single_s:.1f} s, the ranks' run for (b), (a) and (d) "
        f"{ranks_s:.1f} s; {smi}")

    # (a) against 18e (b)'s single process
    gemma = mesh_train["gemma"]
    a1, a2 = [r["a_save"] for r in ranks], [r["a_restart"] for r in ranks]
    got = [r["loss"] for r in a1]
    a_loss = max(mt_within(g, gemma["loss"]) for g in got)
    a_norm = max(mt_within(r["grad_norm"], gemma["grad_norm"]) for r in a1)
    for r in a1 + a2:
        if any(r["launches"].values()):
            raise AssertionError(f"[{label} a] launches {r['launches']}")
    if not (a_loss <= TRAIN_LOSS_TOL and a_norm <= TRAIN_LOSS_TOL
            and all(r["restored_from"] == [MT_B_SAVE] for r in a2)
            and all(len(g) == MT_B_SAVE for g in got)
            and not any(r["loss"] or r["save_s"] for r in a2)):
        raise AssertionError(
            f"[{label} a] losses {got} against 18e (b)'s single process's "
            f"{gemma['loss']}; restored from "
            f"{[r['restored_from'] for r in a2]}")
    gtok = MT_B_BATCH * (MT_B_SEQ + 1)
    log(f"[{label} a] {MT_B_ARCH} float32 at its published settings, "
        f"{MT_B_LAYERS} of 28 layers, B={MT_B_BATCH} x {MT_B_SEQ + 1} "
        f"tokens: over {a1[0]['mesh']} {MT_B_SAVE} steps "
        f"({', '.join(f'{max(r['seconds'][i] for r in a1) * 1e3:.1f}' for i in range(MT_B_SAVE))} "
        f"ms, {gtok / max(max(r['seconds']) for r in a1):.0f} tokens/s at "
        f"the slower) and a save of {len(ranks[0]['ckpt_files'])} files, "
        f"{ranks[0]['ckpt_bytes'] / 2**30:.2f} GiB, in "
        f"{max(sum(r['save_s']) for r in a1):.1f} s; restarted over "
        f"{a2[0]['mesh']} from step {a2[0]['restored_from']} (the restore "
        f"{max(sum(r['restore_s']) for r in a2):.1f} s, no step after it); "
        f"losses "
        f"{[round(x, 6) for x in got[0]]}, 18e (b)'s single process's "
        f"within {a_loss:.3g}, gradient norms within {a_norm:.3g} (tol "
        f"{TRAIN_LOSS_TOL}); peak memory a rank over the FSDP mesh "
        f"{', '.join(f'{r['peak_gib']:.2f}' for r in a1)} GiB, after the "
        f"restart (no data axis to split over) "
        f"{', '.join(f'{r['peak_gib']:.2f}' for r in a2)} GiB, "
        f"beside 18e (b)'s {mesh_train['gemma_peak_gib']:.2f} GiB a rank "
        f"without FSDP; {smi}")

    # (b) against the single process at the same depth
    b = [r["b"] for r in ranks]
    cfg = build_model(MOE_ARCH, FSDP_B_LAYERS).cfg
    b_loss = max(mt_within(r["loss"], moe["loss"]) for r in b)
    b_norm = max(mt_within(r["grad_norm"], moe["grad_norm"]) for r in b)
    b_want = train_launches(cfg, FSDP_B_STEPS)
    for r in b:
        full = {**{k: 0 for k in r["launches"]}, **b_want}
        if r["launches"] != full:
            raise AssertionError(f"[{label} b] launches {r['launches']}, "
                                 f"want {full}")
    if not (b_loss <= TRAIN_LOSS_TOL and b_norm <= TRAIN_LOSS_TOL
            and all(np.isfinite(r["loss"]).all() for r in b)):
        raise AssertionError(f"[{label} b] losses {[r['loss'] for r in b]} "
                             f"against the single process's {moe['loss']}")
    tokens_b = TRAIN_TOKENS
    log(f"[{label} b] {cfg.name} float32 at every published width, "
        f"{cfg.n_layers} of 24 layers, over (data {FSDP_B_MESH[0]}, model "
        f"{FSDP_B_MESH[1]}): {b[0]['held'] / 1e9:.3f} B parameters a rank "
        f"(FSDP's blocks); B={TRAIN_BATCH} x {TRAIN_SEQ + 1} tokens, "
        f"{FSDP_B_STEPS} step(s) at lr {TRAIN_LR} (warmup-cosine's lr is 0 "
        f"at step 0): losses "
        f"{[round(x, 6) for x in b[0]['loss']]}, the single process's "
        f"{[round(x, 6) for x in moe['loss']]} within {b_loss:.3g} (norms "
        f"{b_norm:.3g}; tol {TRAIN_LOSS_TOL}); launches a rank "
        f"{json.dumps(b[0]['launches'])}; train_loop "
        f"{max(r['wall_s'] for r in b):.1f} s; {smi}")
    for i in range(FSDP_B_STEPS):
        s = max(r["seconds"][i] for r in b)
        log(f"[{label} b] step {i}: {s * 1e3:.1f} ms (ranks "
            f"{', '.join(f'{r['seconds'][i] * 1e3:.1f}' for r in b)}), "
            f"{tokens_b / s:.0f} tokens/s (the single process "
            f"{moe['seconds'][i] * 1e3:.1f} ms); {smi}")
    walls = [r["wall_s"] for r in b]
    for name in ("all_gather", "reduce_scatter", "all_reduce",
                 "all_reduce_max"):
        log(f"[{label} b] {name}: {b[0]['collectives'][name]} calls a "
            f"rank, {', '.join(f'{r['collective_s'][name]:.2f}' for r in b)}"
            f" s of train_loop's "
            f"{', '.join(f'{w:.1f}' for w in walls)} s "
            f"({max(r['collective_s'][name] / r['wall_s'] for r in b):.1%} "
            f"at most); {smi}")
    log(f"[{label} b] the collectives together "
        f"{max(sum(r['collective_s'].values()) / r['wall_s'] for r in b):.1%}"
        f" of the wall at most; peak memory a rank "
        f"{', '.join(f'{r['peak_gib']:.2f}' for r in b)} GiB, "
        f"{sum(r['peak_gib'] for r in b):.2f} GiB in all (the single "
        f"process's {moe['peak_gib']:.2f} GiB); {smi}")


    # (d) against the single process
    d = [r["d"] for r in ranks]
    dcfg = build_model(MT_B_ARCH, FSDP_D_LAYERS).cfg
    V = dcfg.vocab_size
    errs = []
    for r in d:
        lo, hi = r["rows"]
        if r["prefill_launches"] != expected_launches(dcfg):
            raise AssertionError(f"[{label} d] prefill launches "
                                 f"{r['prefill_launches']}")
        if r["decode_launches"] != decode_launches(dcfg, FSDP_D_STEPS):
            raise AssertionError(f"[{label} d] decode launches "
                                 f"{r['decode_launches']}")
        errs.append([rel_err(torch, r["prefill"][:, :V],
                             serve["prefill"][lo:hi, :V])] + [
            rel_err(torch, got[:, :V], want[lo:hi, :V])
            for got, want in zip(r["decode"], serve["decode"])])
    over = [r["specs"]["embed.tokens"] for r in d][0]
    worst = max(max(e) for e in errs)
    if not worst <= LOGITS_TOL or "data" not in over:
        raise AssertionError(f"[{label} d] last logits off by {errs}; "
                             f"embed.tokens {over}")
    log(f"[{label} d] {MT_B_ARCH} bf16 at its serve plan (FSDP on: "
        f"embed.tokens {over}), {FSDP_D_LAYERS} of 28 layers "
        f"({d_params / 1e9:.3f} B parameters), over (data "
        f"{FSDP_D_MESH[0]}, model {FSDP_D_MESH[1]}): each data rank "
        f"{rows // FSDP_D_MESH[0]} of {rows} rows, a {FSDP_D_SEQ}-token "
        f"prefill through flash in "
        f"{max(r['prefill_s'] for r in d) * 1e3:.1f} ms at the slowest "
        f"(the single process's {rows} rows "
        f"{serve['prefill_s'] * 1e3:.1f} ms), then {FSDP_D_STEPS} paged "
        f"decode steps of "
        f"{', '.join(f'{max(r['decode_s'][i] for r in d) * 1e3:.1f}' for i in range(FSDP_D_STEPS))} "
        f"ms (the single process "
        f"{', '.join(f'{s * 1e3:.1f}' for s in serve['decode_s'])} ms); "
        f"the last logits of each within {worst:.3g} of the single "
        f"process's (tol {LOGITS_TOL}); launches on each rank "
        f"{json.dumps(d[0]['prefill_launches'])} and "
        f"{json.dumps(d[0]['decode_launches'])}; peak memory a rank "
        f"{', '.join(f'{r['peak_gib']:.2f}' for r in d)} GiB; {smi}")
    runs = [r[k]["launches"] for r in ranks
            for k in ("b", "a_save", "a_restart")] + [
        r["d"][k] for r in ranks
        for k in ("prefill_launches", "decode_launches")]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    log(f"[{label}] launches over the ranks' main-path runs ((b)'s "
        f"{FSDP_B_STEPS} step(s), (a)'s {MT_B_STEPS}, (d)'s prefill and "
        f"{FSDP_D_STEPS} decode steps a rank): {json.dumps(launches)}")
    return {"launches": launches,
            "b_step_ms": max(max(r["seconds"]) for r in b) * 1e3}


# ------------------------------------------------------------ phase 18g
def tph_config():
    """HYBRID_ARCH at every published width, cut by TPH_CUTS."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(HYBRID_ARCH), **TPH_CUTS)


def tph_train_config():
    """(c)'s config: reduced HYBRID_ARCH at its published plan (``fsdp``,
    ``remat="full"``) with ``capacity_factor`` 4.0, as the CPU
    mesh-training tests set it under expert parallelism at dp 2 (a data
    shard ranks its own tokens: at the published capacity the shards and
    the single process drop other slots)."""
    from repro_torch.configs import get_arch, reduced_config
    return dataclasses.replace(reduced_config(get_arch(HYBRID_ARCH)),
                               fsdp=True, remat="full", capacity_factor=4.0)


def tph_routes(ids, B: int, steps: int, held: int):
    """The recorded dispatches of ``steps`` decode steps (each MoE layer's
    token ids over the slots of the ``held`` experts, a step's B tokens
    the rows 0 .. B-1) as a (steps, MoE layers, B, held) bool array: the
    experts that take each row."""
    import numpy as np
    out = np.zeros((len(ids), B, held), bool)
    for i, t in enumerate(ids):
        a = t.cpu().numpy().reshape(held, -1)
        for e in range(held):
            out[i, a[e][a[e] >= 0], e] = True
    return out.reshape(steps, -1, B, held)


@contextlib.contextmanager
def router_margins(torch, record: list):
    """Record, for every MoE layer call, each token's router margin: the
    gap between its top_k-th and (top_k + 1)-th router logits over the
    standard deviation of its logits (float32, as ``moe_apply`` routes);
    a route that another summation order flips lies within a small one."""
    from repro_torch.models import transformer as tf
    real = tf.moe_apply

    def recording(cfg, p, x, ctx):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        top = logits.topk(cfg.top_k + 1, dim=-1).values
        record.append(((top[:, -2] - top[:, -1])
                       / logits.std(dim=-1)).cpu().numpy())
        return real(cfg, p, x, ctx)

    tf.moe_apply = recording
    try:
        yield
    finally:
        tf.moe_apply = real


def tph_decode(torch, model, tokens, ctx, kv_layout: str,
               greedy: bool = False) -> tuple:
    """``tp_decode`` with the MoE dispatches recorded: (the tokens fed,
    each step's logits, the state after, ``tph_routes``, and each MoE
    layer's router margins (steps, MoE layers, B), ``router_margins``)."""
    import numpy as np

    from repro_torch.kernels import ops
    ids, margins = [], []
    with torch.no_grad(), dispatch_ids(ops, ids), \
            router_margins(torch, margins):
        fed, steps, state = tp_decode(torch, model, tokens, ctx, greedy,
                                      kv_layout)
    held = model.get_parameter("groups.moe.w_up").shape[1]
    B, n = fed.shape
    return (fed, steps, state, tph_routes(ids, B, n, held),
            np.stack(margins).reshape(n, -1, B))


def tph_rows(got: list, want: list):
    """(steps, B): each row's max |got - want| over its step's largest
    |want|, over the vocab's columns."""
    import numpy as np
    return np.array([(np.abs(np.asarray(g, np.float32) - w).max(-1)
                      / np.abs(w).max()) for g, w in zip(got, want)])


def tph_held(errs, flipped, margins) -> dict:
    """``flipped`` (steps, MoE layers, B): where some rank's routes are not
    the single process's. The steps' rows whose routes, at every MoE layer
    of this step and of the row's earlier steps, are the single
    process's: the largest error among them and among the others; each
    row's first flip (step, layer; none: -1) and the single process's
    router margin there (``margins``, as ``flipped``), whose largest over
    the rows is ``first_margin``: a flip that the sums' order explains
    lies at a near-tie."""
    import numpy as np
    cum = np.logical_or.accumulate(flipped.any(axis=1), axis=0)
    first, first_margins = [], []
    for b in range(flipped.shape[2]):
        at = np.argwhere(flipped[:, :, b])  # (step, layer), step-major
        first.append([int(v) for v in at[0]] if len(at) else [-1, -1])
        if len(at):
            first_margins.append(float(margins[at[0][0], at[0][1], b]))
    return {"flipped": int(cum.sum()), "rows": int(cum.size),
            "held_err": float(errs[~cum].max(initial=0.0)),
            "flipped_err": float(errs[cum].max(initial=0.0)),
            "first_flip": first,
            "first_margin": max(first_margins, default=0.0)}


def tph_single(torch) -> dict:
    """The single process of (a) in the parent, before the ranks: its
    plain last logits, its flash prefill timed, its greedy paged decode
    and the dense cache fed the same tokens (each with its MoE routes and
    router margins recorded) and its paged serving; then freed."""
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(tph_config()).init_params(
        torch.Generator(DEVICE).manual_seed(SEED), torch.bfloat16)
    torch.cuda.synchronize()
    out = {"params": model.param_count(),
           "draw_s": time.perf_counter() - t0}
    batch = prefill_batch(torch, model)
    with torch.no_grad():
        out["logits"] = model.forward(batch, Ctx(),
                                      last_only=True)[0].cpu().numpy()
        model.forward(batch, Ctx(use_flash=True), last_only=True)
        walls = []
        for _ in range(TP_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward(batch, Ctx(use_flash=True), last_only=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["prefill_s"] = sorted(walls)[len(walls) // 2]
        fed, steps, _, routes, margins = tph_decode(
            torch, model, tp_prompts(torch, model.cfg), None, "paged",
            greedy=True)
        out.update(fed=fed.cpu().numpy(), paged_routes=routes,
                   paged_margins=margins, steps=[t.numpy() for t in steps])
        _, steps, _, routes, margins = tph_decode(torch, model, fed, None,
                                                  "dense")
        out.update(dense_steps=[t.numpy() for t in steps],
                   dense_routes=routes, dense_margins=margins)
        served = serve_model(model, kv_layout="paged", page_size=PAGE_SIZE,
                             **EP_SERVE)
        out.update(served=served["outputs"], serve_s=served["seconds"],
                   serve_tokens=served["tokens"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tph_key(name: str, t) -> str:
    """What a timed collective of 18g carries: the redistributions, the
    float32 sums (``x_proj``'s partials), the bf16 ones (each split
    product's), the conv windows' gathers (bf16) and the logits' (f32)."""
    if name == "inner_halves":
        return "redistribute"
    kind = "sum" if name == "all_reduce" else "gather"
    return f"{kind} {str(t.dtype).split('.')[-1]}"


def tph_prefill(torch, mesh, ref: dict) -> dict:
    """(a) on this rank: its slices of the cut jamba drawn in turns, a
    warm prefill, the main path's (launches from 0, timed), one with each
    collective timed alone and one under the profiler; the last logits
    against the single process's plain ones; dense decode, then paged
    decode, fed the single process's tokens, each with its MoE routes
    recorded (the conv windows' bits gathered from every rank after the
    dense one, and one more step with each collective timed alone); paged
    serving."""
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx

    model, ctx, draw_s = tp_rank_model(torch, mesh, tph_config(), None,
                                       torch.bfloat16)
    ctx = dataclasses.replace(ctx, ep_shard_map=True)
    cfg, plan = model.cfg, ctx.plan
    if plan.moe_strategy != "ep" or plan.kv_strategy != "heads":
        raise AssertionError(f"18g plan: {plan.decisions}")
    held = sum(p.numel() for p in model.parameters())
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()
              if k.startswith("groups.mamba.")}
    batch = prefill_batch(torch, model)

    def forward():
        return model.forward(batch, ctx, last_only=True)[0]

    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        if launches != expected_launches(cfg):
            raise AssertionError(f"18g prefill launches {launches}")
        dist.barrier()
        spent, undo = timed_collectives(
            torch, ("all_reduce", "inner_halves", "all_gather"), tph_key)
        try:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            timed_wall = time.perf_counter() - t0
        finally:
            undo()
        prefill_spent = {k: sum(v) for k, v in spent.items()}
        prefill_calls = {k: len(v) for k, v in spent.items()}
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa
                        or getattr(e, "self_cuda_time_total", 0.0))
    V = cfg.vocab_size
    err = rel_err(torch, logits[..., :V],
                  torch.from_numpy(ref["logits"]).to(DEVICE)[..., :V])
    finite = bool(torch.isfinite(logits[..., :V]).all())
    del logits

    # decode fed the single process's tokens, dense then paged: launches;
    # each step's rows against the single process's where every rank's
    # routes are its (a route that flips on the bf16 sums' order is
    # counted, ROADMAP.md queue 3); after the dense steps the conv windows'
    # bits on every rank and one step more with each collective timed alone
    fed = torch.from_numpy(ref["fed"]).to(DEVICE)
    n = fed.shape[1]
    E_local = model.get_parameter("groups.moe.w_up").shape[1]
    mine = slice(mesh.index("model") * E_local,
                 (mesh.index("model") + 1) * E_local)
    errs, flips, runs = {}, {}, []
    for layout in ("dense", "paged"):
        ops.reset_launch_counts()
        _, steps, state, routes, _ = tph_decode(torch, model, fed, ctx,
                                                layout)
        torch.cuda.synchronize()
        runs.append(ops.launch_counts())
        want = decode_launches(cfg, n)
        if layout == "dense":
            want["paged_attention"] = 0
        if runs[-1] != want:
            raise AssertionError(f"18g {layout} decode launches {runs[-1]}")
        key = "dense_steps" if layout == "dense" else "steps"
        errs[layout] = tph_rows([t[:, :V].numpy() for t in steps],
                                [w[:, :V] for w in ref[key]])
        flips[layout] = (routes != ref[f"{layout}_routes"][..., mine]).any(
            axis=3)  # (steps, MoE layers, B)
        if layout == "paged":
            continue
        conv = hashlib.sha256(state.mamba.conv.float().cpu().numpy()
                              .tobytes()).hexdigest()
        h_shape, conv_shape = (tuple(state.mamba.h.shape),
                               tuple(state.mamba.conv.shape))
        spent, undo = timed_collectives(
            torch, ("all_reduce", "inner_halves", "all_gather"), tph_key)
        try:
            dist.barrier()
            t0 = time.perf_counter()
            with torch.no_grad():
                model.decode_step(fed[:, -1:], state, ctx)
            torch.cuda.synchronize()
            step_wall = time.perf_counter() - t0
        finally:
            undo()
        decode_spent = {k: sum(v) for k, v in spent.items()}
        decode_calls = {k: len(v) for k, v in spent.items()}
        del state
    ops.reset_launch_counts()
    with torch.no_grad():
        served = serve_model(model, ctx=Ctx(plan=ctx.plan, mesh=ctx.mesh,
                                            ep_shard_map=True),
                             kv_layout="paged", page_size=PAGE_SIZE,
                             **EP_SERVE)
    runs.append(ops.launch_counts())
    if runs[-1] != decode_launches(cfg, served["iters"]):
        raise AssertionError(f"18g serve launches {runs[-1]}")
    differ = sum(sum(a != b for a, b in zip(got, want))
                 + abs(len(got) - len(want))
                 for got, want in zip(served["outputs"], ref["served"]))
    every = [None] * mesh.size
    dist.all_gather_object(every, (conv, served["outputs"], flips))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if any(e[0] != every[0][0] for e in every):
        raise AssertionError("18g: the ranks' conv windows differ")
    if any(e[1] != every[0][1] for e in every):
        raise AssertionError("18g: the ranks served different tokens")
    # the rows whose routes every rank found to be the single process's
    # are held at LOGITS_TOL; each row's first flip must lie at a near-tie
    # of the single process's router (TPH_TIE)
    hold = {k: tph_held(errs[k], np.any([e[2][k] for e in every], axis=0),
                        ref[f"{k}_margins"]) for k in errs}
    if not (finite and err < LOGITS_TOL and all(
            h["held_err"] < LOGITS_TOL and h["first_margin"] <= TPH_TIE
            for h in hold.values())):
        raise AssertionError(f"18g logits off by {err} (prefill) of the "
                             f"largest, or not finite; decode {hold}")
    return {"held": held, "draw_s": draw_s, "shapes": shapes,
            "wall_s": wall, "timed_wall_s": timed_wall,
            "prefill_spent": prefill_spent, "prefill_calls": prefill_calls,
            "busy_s": sum(dev_us(e) for e in kernels) / 1e6,
            "copy_s": sum(dev_us(e) for e in copies) / 1e6,
            "top": [(e.key[:60], dev_us(e) / 1e6) for e in
                    sorted(kernels, key=dev_us, reverse=True)[:4]],
            "err": err, "decode": hold, "h_shape": h_shape,
            "conv_shape": conv_shape, "step_wall_s": step_wall,
            "decode_spent": decode_spent, "decode_calls": decode_calls,
            "peak_gib": peak, "served_differ": differ,
            "serve_s": served["seconds"], "serve_tokens": served["tokens"],
            "iters": served["iters"], "launches": [launches, *runs]}


def tph_layer(torch, mesh) -> dict:
    """(b) on this rank: one Mamba layer at jamba's full width in
    float32, drawn whole from SEED (the same on every rank), first as the
    single process runs it (``mamba_apply`` under ``Ctx()`` and its
    autograd), then on the rank's slices under ``param_specs``; the output
    and each leaf's gradient slice against the single process's."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.planner import P, make_plan
    from repro_torch.distributed.elastic import local_index
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten, initialize
    from repro_torch.models.ssm import mamba_apply, mamba_defs

    cfg = get_arch(HYBRID_ARCH)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    whole = initialize(mamba_defs(cfg), gen, torch.float32, DEVICE)
    x = torch.randn((1, PREFILL_SEQ, cfg.d_model), generator=gen,
                    device=DEVICE)
    g = torch.randn((1, PREFILL_SEQ, cfg.d_model), generator=gen,
                    device=DEVICE)

    def run(p, ctx):
        leaves = {k: t.requires_grad_(True) for k, t in p.items()}
        xin = x.clone().requires_grad_(True)
        y = mamba_apply(cfg, leaves, xin, ctx)
        grads = torch.autograd.grad(y, [xin, *leaves.values()], g)
        return y.detach(), dict(zip(["x", *leaves], grads))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    y1, g1 = run({k: t.clone() for k, t in whole.items()}, Ctx())
    plan = make_plan(cfg, mesh.shape, get_shape("prefill_32k"))
    specs = flatten(build_model(cfg, 8).param_specs(plan))
    ctx = Ctx(plan=plan, mesh=mesh)
    index = {k: local_index(t.shape, P(*tuple(
        specs[f"groups.mamba.{k}"])[1:]), mesh) for k, t in whole.items()}
    mine = {k: t[index[k]].contiguous() for k, t in whole.items()}
    del whole
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, grads = run(mine, ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    out_err = float((y - y1).abs().max() / y1.abs().max())
    grad_err = {}
    for k, got in grads.items():
        want = g1[k] if k == "x" else g1[k][index[k]]
        grad_err[k] = float((got - want).abs().max() / g1[k].abs().max())
    shapes = {k: tuple(t.shape) for k, t in mine.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del y1, g1, y, grads, mine, x, g
    gc.collect()
    torch.cuda.empty_cache()
    if not (out_err <= TPH_OUT_TOL
            and max(grad_err.values()) <= TPH_GRAD_TOL):
        raise AssertionError(f"18g (b): output {out_err:.3g}, gradients "
                             f"{grad_err}")
    want = {**{k: 0 for k in launches}, "ssm_scan": 1, "ssm_scan_bwd": 1}
    if launches != want:
        raise AssertionError(f"18g (b) launches {launches}")
    return {"out_err": out_err, "grad_err": grad_err, "wall_s": wall,
            "shapes": shapes, "peak_gib": peak, "launches": launches}


def tph_train(torch, mesh, steps: int, ckpt: str, weights) -> dict:
    """(c) on this rank: ``train_loop`` of ``tph_train_config()`` from
    the single process's weights over ``mesh`` to step ``steps`` under
    the supervisor, saving to (or resuming from) ``ckpt``."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop

    dist.barrier()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_loop(tph_train_config(), reduced=False, steps=steps,
                     batch=REDUCED_BATCH, seq=REDUCED_SEQ, seed=SEED,
                     weights=weights, mesh=mesh, ckpt_dir=ckpt,
                     save_every=TPH_C_SAVE, log_every=steps + 1)
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0,
           "launches": ops.launch_counts(), **mt_history(out),
           "restored_from": out["report"].restored_from,
           "mesh": repr(mesh)}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tph_rank(rank: int, world: int, where: str, ref: dict) -> None:
    """One rank of 18g's four, a process of its own: (a) and (b) over
    (data 1, model 4), then (c) over TPH_C_MESHES (a save, then a
    restart); its results go to ``where``/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mt_start_rank(torch, rank, world, where)
    axes = ("data", "model")
    mesh = make_mesh(EP_MESH, axes, DEVICE)
    out = {"mesh": repr(mesh), "a": tph_prefill(torch, mesh, ref["a"]),
           "b": tph_layer(torch, mesh)}
    ckpt = os.path.join(where, "ckpt")
    out["c_save"] = tph_train(torch, make_mesh(TPH_C_MESHES[0], axes,
                                               DEVICE), TPH_C_SAVE, ckpt,
                              ref["weights"])
    out["c_restart"] = tph_train(torch, make_mesh(TPH_C_MESHES[1], axes,
                                                  DEVICE), TPH_C_STEPS, ckpt,
                                 ref["weights"])
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_hybrid_tp(torch, smi: str) -> dict:
    """The hybrid family split over the model axis: the single processes
    first, in this process ((a)'s cut jamba in bf16, then (c)'s reduced
    training, each freed), then four spawned processes over the card
    (``tph_rank``). Returns the ranks' main-path launches summed: (a)'s
    timed prefill, dense and paged decode and serving, (b)'s layer and
    (c)'s steps."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model

    label = "hybrid tp"
    where = tempfile.mkdtemp(prefix="tph_ranks_")
    try:
        t0 = time.perf_counter()
        a_ref = tph_single(torch)
        margins = np.concatenate([a_ref["dense_margins"].ravel(),
                                  a_ref["paged_margins"].ravel()])
        log(f"[{label} a] the single process: flash prefill "
            f"{a_ref['prefill_s'] * 1e3:.1f} ms; its decode's router "
            f"margins (top-{tph_config().top_k} gap over the logits' std) "
            f"at the 1st / 5th / 50th percentile "
            f"{', '.join(f'{np.percentile(margins, q):.4f}' for q in (1, 5, 50))}")
        tcfg = tph_train_config()
        weights = build_model(tcfg).init_params(
            torch.Generator().manual_seed(SEED), "float32").state_dict()
        c_ref = mt_history(train_loop(
            tcfg, reduced=False, steps=TPH_C_STEPS, batch=REDUCED_BATCH,
            seq=REDUCED_SEQ, seed=SEED, weights=weights, device=DEVICE,
            log_every=TPH_C_STEPS + 1))
        gc.collect()
        torch.cuda.empty_cache()
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_rank_processes(tph_rank, where, {
            "a": a_ref, "weights": weights}, label)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    a, b = [r["a"] for r in ranks], [r["b"] for r in ranks]
    cfg = tph_config()
    S, di = PREFILL_SEQ, cfg.ssm_expand * cfg.d_model
    log(f"[{label}] {EP_WORLD} ranks, one process each, on one card as a "
        f"(data {EP_MESH[0]}, model {EP_MESH[1]}) mesh: {ranks[0]['mesh']}; "
        f"Mamba's inner ({di}) over the model axis, {di // EP_MESH[1]} "
        f"channels a rank (in_proj {a[0]['shapes']['groups.mamba.in_proj']}"
        f", x_proj {a[0]['shapes']['groups.mamba.x_proj']}, out_proj "
        f"{a[0]['shapes']['groups.mamba.out_proj']} a rank), heads, ff and "
        f"vocab as 18d, the experts as 18c; the single processes "
        f"{single_s:.1f} s, the ranks' run {ranks_s:.1f} s")
    wall = max(r["wall_s"] for r in a)
    busy = sum(r["busy_s"] for r in a)
    copied = sum(r["copy_s"] for r in a)
    shares = {k: max(r["prefill_spent"][k] / r["timed_wall_s"] for r in a)
              for k in a[0]["prefill_spent"]}
    dshares = {k: max(r["decode_spent"][k] / r["step_wall_s"] for r in a)
               for k in a[0]["decode_spent"]}
    n_attn = n_attention_layers(cfg)
    n_moe = cfg.n_layers // cfg.moe_period
    log(f"[{label} a] {cfg.name} bf16, every published width, "
        f"{cfg.n_layers // cfg.attn_period} group(s) of "
        f"{cfg.attn_period} layers "
        f"({cfg.n_layers - n_attn} Mamba, {n_attn} attention; {n_moe} MoE, "
        f"{cfg.n_layers - n_moe} dense), {cfg.n_experts} of 16 experts "
        f"({a_ref['params'] / 1e9:.3f} B "
        f"parameters, {a_ref['params'] * 2 / 2**30:.1f} GiB; the single "
        f"process's peak {a_ref['peak_gib']:.2f} GiB): "
        f"{a[0]['held'] / 1e9:.3f} B a rank, drawn in turns in "
        f"{max(r['draw_s'] for r in a):.1f} s; prefill B=1 S={S} after a "
        f"warm run: {wall * 1e3:.1f} ms, {S / wall:.0f} tokens/s (ranks "
        f"{', '.join(f'{r['wall_s'] * 1e3:.1f}' for r in a)} ms), against "
        f"the single process's flash prefill {a_ref['prefill_s'] * 1e3:.1f}"
        f" ms, {S / a_ref['prefill_s']:.0f} tokens/s in this run; peak "
        f"memory a rank {', '.join(f'{r['peak_gib']:.2f}' for r in a)} GiB;"
        f" the card's kernels {busy / wall:.1%} of the wall (the ranks' "
        f"kernels, copies not counted: "
        f"{', '.join(f'{r['busy_s'] * 1e3:.1f}' for r in a)} ms), its "
        f"copies and memsets {copied / wall:.1%}; {smi}")
    log(f"[{label} a] prefill with each collective timed alone (rank 0 "
        f"{a[0]['timed_wall_s'] * 1e3:.1f} ms; calls a rank "
        f"{json.dumps(a[0]['prefill_calls'])}): shares of the wall at the "
        f"largest rank {json.dumps({k: round(v, 4) for k, v in shares.items()})}"
        f" (rank 0's ms "
        f"{json.dumps({k: round(v * 1e3, 1) for k, v in a[0]['prefill_spent'].items()})}"
        f"); one dense decode step at B={TP_DECODE_BATCH} timed alike "
        f"({max(r['step_wall_s'] for r in a) * 1e3:.1f} ms; calls "
        f"{json.dumps(a[0]['decode_calls'])}): "
        f"{json.dumps({k: round(v, 4) for k, v in dshares.items()})}; {smi}")
    log(f"[{label} a] rank 0's top kernels: " + "; ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in a[0]["top"]))
    dec = a[0]["decode"]  # the ranks hold the same logits and flips
    log(f"[{label} a] last position's logits against the single process's "
        f"plain forward: {max(r['err'] for r in a):.3g} of the largest "
        f"(LOGITS_TOL {LOGITS_TOL}); decode fed the single process's "
        f"greedy tokens ({TP_DECODE_STEPS} steps at B={TP_DECODE_BATCH}), "
        f"each step's rows against the single process's: dense "
        f"{json.dumps(dec['dense'])}, paged {json.dumps(dec['paged'])} "
        f"(rows whose routes flipped at a MoE layer, then or earlier, on "
        f"some rank; the others held at LOGITS_TOL; each row's first flip "
        f"(step, layer) at the single process's router margin within "
        f"TPH_TIE {TPH_TIE}); a rank's Mamba state h {a[0]['h_shape']} "
        f"and conv window {a[0]['conv_shape']}, the windows the same bits "
        f"on every rank; paged serving {a[0]['serve_tokens']} tokens in "
        f"{a[0]['serve_s']:.1f} s ({a[0]['iters']} steps; the single "
        f"process {a_ref['serve_tokens']} in {a_ref['serve_s']:.1f} s), the "
        f"same tokens on every rank, {a[0]['served_differ']} of them differ "
        f"from the single process's")
    log(f"[{label} b] one Mamba layer of {HYBRID_ARCH} at full width "
        f"(d {cfg.d_model}, di {di}, N {cfg.d_state}) in float32, x (1, "
        f"{S}, {cfg.d_model}): the rank's slices "
        f"{json.dumps({k: list(v) for k, v in b[0]['shapes'].items()})}; "
        f"forward and backward {max(r['wall_s'] for r in b) * 1e3:.1f} ms "
        f"at the slowest rank (P4 and its backward once each on every "
        f"rank); output within {max(r['out_err'] for r in b):.3g} of its "
        f"largest value (tol {TPH_OUT_TOL}), each gradient slice within "
        f"{json.dumps({k: float(f'{max(r['grad_err'][k] for r in b):.3g}') for k in b[0]['grad_err']})}"
        f" of its leaf's largest (tol {TPH_GRAD_TOL}) of the single "
        f"process's; peak memory a rank "
        f"{max(r['peak_gib'] for r in b):.2f} GiB; {smi}")
    c1, c2 = [r["c_save"] for r in ranks], [r["c_restart"] for r in ranks]
    got = [r1["loss"] + r2["loss"] for r1, r2 in zip(c1, c2)]
    got_norm = [r1["grad_norm"] + r2["grad_norm"] for r1, r2 in zip(c1, c2)]
    c_loss = max(mt_within(x, c_ref["loss"]) for x in got)
    c_norm = max(mt_within(x, c_ref["grad_norm"]) for x in got_norm)
    tcfg = tph_train_config()
    for runs, steps in ((c1, TPH_C_SAVE), (c2, TPH_C_STEPS - TPH_C_SAVE)):
        want = train_launches(tcfg, steps)
        for r in runs:
            full = {**{k: 0 for k in r["launches"]}, **want}
            if r["launches"] != full:
                raise AssertionError(f"[{label} c] launches {r['launches']},"
                                     f" want {full}")
    if not (c_loss <= TRAIN_LOSS_TOL and c_norm <= TRAIN_LOSS_TOL
            and all(r["restored_from"] == [TPH_C_SAVE] for r in c2)
            and all(len(x) == TPH_C_STEPS for x in got)):
        raise AssertionError(
            f"[{label} c] losses {got} against the single process's "
            f"{c_ref['loss']}; restored from "
            f"{[r['restored_from'] for r in c2]}")
    log(f"[{label} c] {HYBRID_ARCH} reduced at its published plan (fsdp, "
        f"remat full; capacity_factor 4.0): {TPH_C_SAVE} steps over "
        f"{c1[0]['mesh']} and a save, a restart over {c2[0]['mesh']} from "
        f"step {c2[0]['restored_from']} for step {TPH_C_STEPS}: losses "
        f"{[round(x, 6) for x in got[0]]}, the single process's within "
        f"{c_loss:.3g}, gradient norms within {c_norm:.3g} (tol "
        f"{TRAIN_LOSS_TOL}); launches a rank {json.dumps(c1[0]['launches'])}"
        f" and {json.dumps(c2[0]['launches'])}; train_loop "
        f"{max(r['wall_s'] for r in c1):.1f} s and "
        f"{max(r['wall_s'] for r in c2):.1f} s; {smi}")
    runs = [run for r in a for run in r["launches"]] + [
        r["launches"] for r in b] + [r["launches"] for r in c1 + c2]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    log(f"[{label}] launches over the ranks' main-path runs ((a)'s timed "
        f"prefill, dense and paged decode and serving, (b)'s layer, (c)'s "
        f"{TPH_C_STEPS} steps a rank): {json.dumps(launches)}")
    return {"launches": launches, "tokens_per_s": S / wall,
            "single_tokens_per_s": S / a_ref["prefill_s"]}


# ------------------------------------------------------------ phase 18h
def seq_launches(cfg, steps: int, kv_layout: str) -> dict:
    """Launches of ``steps`` decode steps on a rank of a sequence-sharded
    cache: the paged kernel's partial mode once per attention layer a step
    over the pool, nothing over the dense cache (its span's partial is
    plain torch, as the reference's decode attention)."""
    paged = n_attention_layers(cfg) * steps if kv_layout == "paged" else 0
    return {"flash_attention": 0, "paged_attention": 0,
            "paged_attention_partial": paged, "moe_gather": 0,
            "ssm_scan": 0, **NO_RELATIONAL, **NO_BACKWARD}


def kvs_decode(torch, model, tokens, ctx, kv_layout: str,
               greedy: bool = False) -> tuple:
    """Decode of ``tokens`` (B, n) fed one column a step from an empty
    state of n positions (the dense cache, or the pool of KVS_PAGE-token
    pages), laid out as ``ctx`` places it; with ``greedy`` each column past
    KVS_PROMPT is the step before's argmax. Returns the tokens fed, each
    step's (B, V) float32 logits on the host, each step's wall seconds
    (its logits copied out) and the state."""
    fed = tokens.clone()
    B, n = fed.shape
    state = model.init_decode_state(B, n, model.dtype,
                                    kv_layout=kv_layout, page_size=KVS_PAGE,
                                    ctx=ctx)
    steps, walls = [], []
    for t in range(n):
        t0 = time.perf_counter()
        logits, state = model.decode_step(fed[:, t:t + 1], state, ctx)
        steps.append(logits[:, 0].float().cpu())
        walls.append(time.perf_counter() - t0)
        if greedy and KVS_PROMPT <= t + 1 < n:
            fed[:, t + 1] = logits[:, 0].argmax(-1)
    return fed, steps, walls, state


def kvs_single(torch, where: str, arch, layers: int, tag: str,
               prefill_seq: int = 0) -> dict:
    """The single process of 18h (``tag`` "h") or 18i ("i") in the parent,
    before the ranks: with ``prefill_seq`` a prefill of that many tokens at
    B=1 through P1, then greedy dense decode, paged decode fed its tokens
    (each step's logits, and the prefill's, written to ``where`` for the
    ranks to read by memory map), paged serving; then freed."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(arch, layers).init_params(
        torch.Generator(DEVICE).manual_seed(SEED), torch.bfloat16)
    torch.cuda.synchronize()
    V = model.cfg.vocab_size
    out = {"params": model.param_count(),
           "draw_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        1, V, (KVS_BATCH, KVS_STEPS))).to(DEVICE)
    with torch.no_grad():
        if prefill_seq:
            tokens = rng.integers(1, V, (1, prefill_seq))
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits = model.forward({"tokens": torch.from_numpy(tokens).to(
                DEVICE)}, Ctx(use_flash=True))[0]
            torch.cuda.synchronize()
            out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            if ops.launch_counts()["flash_attention"] != layers:
                raise AssertionError(f"18{tag} single prefill launches "
                                     f"{ops.launch_counts()}")
            out["prefill"] = os.path.join(where, f"kvs_{tag}_prefill.npy")
            np.save(out["prefill"], logits[0, :, :V].float().cpu().numpy())
            out["prefill_tokens"] = tokens
            del logits
        fed, dense, dense_walls, _ = kvs_decode(torch, model, prompts, None,
                                                "dense", greedy=True)
        _, paged, paged_walls, _ = kvs_decode(torch, model, fed, None,
                                              "paged")
        served = serve_model(model, kv_layout="paged", page_size=KVS_PAGE,
                             **KVS_SERVE)
    for name, steps in (("dense", dense), ("paged", paged)):
        out[name] = os.path.join(where, f"kvs_{tag}_{name}.npy")
        np.save(out[name], np.stack([t.numpy() for t in steps]))
    out.update(fed=fed.cpu().numpy(),
               dense_ms=1e3 * float(np.median(dense_walls)),
               paged_ms=1e3 * float(np.median(paged_walls)),
               served=served["outputs"], serve_s=served["seconds"],
               serve_tokens=served["tokens"],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model, dense, paged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def qdim_collective(hd: int):
    """The key of a collective call in 18h's and 18i's timed runs: the q
    all-gather of decode (a (B, W) block of q_dim columns), the q exchange
    of prefill (an all-to-all of columns, not of (B, hd + 2) partials), or
    the call's own name."""
    def key(name, t):
        if name == "all_gather" and t.dim() == 2:
            return "q_gather"
        if name == "all_to_all" and t.shape[-1] != hd + 2:
            return "q_exchange"
        return name
    return key


def kvs_model(torch, mesh, arch, layers: int, ref: dict, tag: str) -> dict:
    """One model's part of a rank of 18h / 18i: its slices drawn in turns,
    with ``ref["prefill"]`` a prefill through P1 (then again with each
    collective timed alone), dense and paged decode fed the single
    process's tokens over its span or shard, one more dense step with each
    collective timed alone, paged serving. Raises on any check that
    fails; returns what the rank measured."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_shape
    from repro_torch.core.planner import make_plan
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.attention import head_block

    t_start = time.perf_counter()
    model = build_model(arch, layers)
    cfg = model.cfg
    plan = make_plan(cfg, mesh.shape, get_shape("decode_32k"),
                     hbm_bytes=torch.cuda.get_device_properties(0)
                     .total_memory)
    if plan.kv_strategy != "sequence":
        raise AssertionError(f"18{tag}: the plan's kv strategy is "
                             f"{plan.kv_strategy}, not sequence")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.init_shards(torch.Generator(DEVICE).manual_seed(SEED), plan, mesh,
                      torch.bfloat16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    ctx = Ctx(plan=plan, mesh=mesh)
    V, hd = cfg.vocab_size, cfg.resolved_head_dim
    W = model.blocks.attn.wq.shape[-1]
    key = qdim_collective(hd)
    fed = torch.from_numpy(ref["fed"]).to(DEVICE)
    n = fed.shape[1]
    out = {"draw_s": draw_s, "span": list(ctx.seq_span),
           "held": sum(p.numel() for p in model.parameters()),
           "block": list(head_block(cfg, W, ctx.tp_index)), "W": W}
    if "prefill" in ref:
        tokens = torch.from_numpy(ref["prefill_tokens"]).to(DEVICE)
        fctx = dataclasses.replace(ctx, use_flash=True)
        shapes = []
        real = ops.flash_attention

        def spy(q, k, v, **kw):
            shapes.append([list(q.shape), list(k.shape)])
            return real(q, k, v, **kw)
        dist.barrier()
        ops.reset_launch_counts()
        ops.flash_attention = spy
        try:
            t0 = time.perf_counter()
            with torch.no_grad():
                logits = model.forward({"tokens": tokens}, fctx)[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ops.flash_attention = real
        launches = ops.launch_counts()
        if launches != expected_launches(cfg):
            raise AssertionError(f"18{tag} prefill launches {launches}")
        single = np.load(ref["prefill"], mmap_mode="r")
        err = rel_err(torch, logits[0, :, :V],
                      torch.from_numpy(np.array(single)).to(logits.device))
        del logits
        spent, undo = timed_collectives(
            torch, ("all_gather", "all_to_all", "all_reduce"), key)
        try:
            dist.barrier()
            t0 = time.perf_counter()
            with torch.no_grad():
                model.forward({"tokens": tokens}, fctx)
            torch.cuda.synchronize()
            timed = time.perf_counter() - t0
        finally:
            undo()
        out["prefill"] = {"err": err, "ms": 1e3 * wall, "shapes": shapes,
                          "launches": launches, "timed_s": timed,
                          "spent": {k: sum(v) for k, v in spent.items()},
                          "calls": {k: len(v) for k, v in spent.items()}}
    for layout in ("dense", "paged"):
        dist.barrier()
        ops.reset_launch_counts()
        with torch.no_grad():
            _, steps, walls, state = kvs_decode(torch, model, fed, ctx,
                                                layout)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if launches != seq_launches(cfg, n, layout):
            raise AssertionError(f"18{tag} {layout} decode launches "
                                 f"{launches}")
        single = np.load(ref[layout], mmap_mode="r")
        err = max(rel_err(torch, got[:, :V], torch.from_numpy(
            np.array(single[t, :, :V]))) for t, got in enumerate(steps))
        out[layout] = {"err": err, "step_ms": 1e3 * float(np.median(walls)),
                       "steps_ms": [round(1e3 * w, 1) for w in walls],
                       "launches": launches}
        if layout == "paged":
            out["pool"] = list(state.kv.k_pages.shape)
            out["seq_pages"] = state.seq_pages[0].tolist()
            continue
        out["cache"] = list(state.k_cache.shape)
        spent, undo = timed_collectives(
            torch, ("all_gather", "all_to_all", "all_reduce"), key)
        try:
            dist.barrier()
            t0 = time.perf_counter()
            with torch.no_grad():
                model.decode_step(fed[:, -1:], state, ctx)
            torch.cuda.synchronize()
            out["timed_step_s"] = time.perf_counter() - t0
        finally:
            undo()
        out["spent"] = {k: sum(v) for k, v in spent.items()}
        out["calls"] = {k: len(v) for k, v in spent.items()}
        del state
    dist.barrier()
    ops.reset_launch_counts()
    with torch.no_grad():
        served = serve_model(model, ctx=ctx, kv_layout="paged",
                             page_size=KVS_PAGE, **KVS_SERVE)
    out["serve_launches"] = ops.launch_counts()
    if out["serve_launches"] != seq_launches(cfg, served["iters"], "paged"):
        raise AssertionError(f"18{tag} serve launches "
                             f"{out['serve_launches']}")
    every = [None] * mesh.size
    dist.all_gather_object(every, served["outputs"])
    if any(e != every[0] for e in every):
        raise AssertionError(f"18{tag}: the ranks served different tokens")
    out.update(served_differ=sum(
        sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        for got, want in zip(served["outputs"], ref["served"])),
        serve_s=served["seconds"], serve_tokens=served["tokens"],
        iters=served["iters"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    errs = [out[k]["err"] for k in ("prefill", "dense", "paged") if k in out]
    if not max(errs) < LOGITS_TOL:
        raise AssertionError(f"18{tag} logits off by {errs} (prefill, "
                             f"dense, paged) of the largest")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def kvs_rank(rank: int, world: int, where: str, ref: dict) -> None:
    """One rank of 18h's sixteen, a process of its own: nemotron's part
    (18h), then, its leaves freed, qwen2.5-32b's (18i) on the same mesh
    (``kvs_model``); its results go to ``where``/rank<rank>.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mt_start_rank(torch, rank, world, where)
    mesh = make_mesh(KVS_MESH, ("data", "model"), DEVICE)
    out = {"mesh": repr(mesh), "start_s": time.time() - ref["spawned"]}
    out["h"] = kvs_model(torch, mesh, TP_BF16_ARCH, TP_BF16_LAYERS,
                         ref["h"], "h")
    out["i"] = kvs_model(torch, mesh, ARCH, QDIM_LAYERS, ref["i"], "i")
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def kvs_shares(ranks, tag: str, part=None) -> dict:
    """Each collective's share of the timed run's wall at the rank where
    it is largest: the dense step's, or with ``part`` the prefill's."""
    def of(r):
        m = r[tag] if part is None else r[tag][part]
        return m["spent"], m["timed_step_s" if part is None else "timed_s"]
    return {k: round(max(of(r)[0][k] / of(r)[1] for r in ranks), 4)
            for k in of(ranks[0])[0]}


def phase_kv_seq(torch, smi: str) -> dict:
    """Decode over the sequence-sharded cache on the card (18h), then the
    q_dim split inside a head (18i): both single processes first, in this
    process, then KVS_WORLD processes over (data 1, model 16)
    (``kvs_rank``), one spawn for both. Returns the ranks' main-path
    launches summed: 18i's prefill, dense and paged decode and serving of
    both."""
    import shutil
    import tempfile

    label, qlabel = "kv seq", "qdim split"
    where = tempfile.mkdtemp(prefix="kvs_ranks_")
    try:
        t0 = time.perf_counter()
        ref = {"h": kvs_single(torch, where, TP_BF16_ARCH, TP_BF16_LAYERS,
                               "h")}
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref["i"] = kvs_single(torch, where, ARCH, QDIM_LAYERS, "i",
                              QDIM_SEQ)
        qsingle_s = time.perf_counter() - t0
        ref["spawned"] = time.time()
        t0 = time.perf_counter()
        ranks = run_rank_processes(kvs_rank, where, ref, label,
                                   world=KVS_WORLD)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    r0 = ranks[0]
    h0, i0 = r0["h"], r0["i"]
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    log(f"[{label}] {KVS_WORLD} ranks, one process each, on one card as a "
        f"(data {KVS_MESH[0]}, model {KVS_MESH[1]}) mesh: {r0['mesh']}; "
        f"{TP_BF16_ARCH}'s 8 kv heads do not divide the model axis: the "
        f"plan's \"sequence\" kv strategy, a rank's dense cache "
        f"{h0['cache']} (its span of {KVS_STEPS} positions, every kv head), "
        f"its pool {h0['pool']} of {KVS_PAGE}-token pages (shard 0's page "
        f"map, row 0: {h0['seq_pages']}); the single "
        f"process {single_s:.1f} s, the ranks' run (18h and 18i) "
        f"{ranks_s:.1f} s, their start-up (spawn to mesh) "
        f"{min(r['start_s'] for r in ranks):.1f}-"
        f"{max(r['start_s'] for r in ranks):.1f} s, 18h's draw in turns "
        f"{max(r['h']['draw_s'] for r in ranks):.1f} s, 18h on the ranks "
        f"{max(r['h']['seconds'] for r in ranks):.1f} s")
    log(f"[{label}] {TP_BF16_ARCH} bf16, every published width, "
        f"{TP_BF16_LAYERS} of 96 layers ({ref['h']['params'] / 1e9:.3f} B "
        f"parameters, the single process's peak "
        f"{ref['h']['peak_gib']:.2f} GiB): {h0['held'] / 1e9:.3f} B a rank; "
        f"peak memory a rank {min(r['h']['peak_gib'] for r in ranks):.2f}-"
        f"{max(r['h']['peak_gib'] for r in ranks):.2f} GiB of the card's "
        f"{total:.1f} GiB; decode at B={KVS_BATCH} fed the single process's "
        f"greedy tokens ({KVS_STEPS} steps): a step's median "
        f"{max(r['h']['dense']['step_ms'] for r in ranks):.1f} ms dense, "
        f"{max(r['h']['paged']['step_ms'] for r in ranks):.1f} ms paged (the "
        f"slowest rank), against the single process's "
        f"{ref['h']['dense_ms']:.1f} and {ref['h']['paged_ms']:.1f} ms; each "
        f"step's logits within "
        f"{max(r['h']['dense']['err'] for r in ranks):.3g} (dense) and "
        f"{max(r['h']['paged']['err'] for r in ranks):.3g} (paged) of the "
        f"largest (LOGITS_TOL {LOGITS_TOL}); rank 0's steps (ms) dense "
        f"{h0['dense']['steps_ms']}, paged {h0['paged']['steps_ms']}; {smi}")
    log(f"[{label}] one dense step with each collective timed alone (rank "
        f"0 {h0['timed_step_s'] * 1e3:.1f} ms; calls a rank "
        f"{json.dumps(h0['calls'])}): shares of the wall at the largest "
        f"rank {json.dumps(kvs_shares(ranks, 'h'))} (rank 0's ms "
        f"{json.dumps({k: round(v * 1e3, 2) for k, v in h0['spent'].items()})}"
        f"); paged serving {h0['serve_tokens']} tokens in "
        f"{h0['serve_s']:.1f} s ({h0['iters']} steps; the single process "
        f"{ref['h']['serve_tokens']} in {ref['h']['serve_s']:.1f} s), the "
        f"same tokens on every rank, {h0['served_differ']} of them differ "
        f"from the single process's; {smi}")
    qi = ref["i"]
    pre = [r["i"]["prefill"] for r in ranks]
    log(f"[{qlabel}] {ARCH} bf16, every published width, {QDIM_LAYERS} of "
        f"64 layers ({qi['params'] / 1e9:.3f} B parameters, the single "
        f"process's peak {qi['peak_gib']:.2f} GiB) over the same mesh: a "
        f"rank's block of q_dim columns {i0['W']} (its head map, rank 0 / "
        f"1 / 15: {ranks[0]['i']['block']} / {ranks[1]['i']['block']} / "
        f"{ranks[-1]['i']['block']} as (first head, heads, offset, kv "
        f"heads)), {i0['held'] / 1e9:.3f} B parameters a rank; P1's inputs "
        f"on every rank (q, k): "
        f"{sorted({json.dumps(p['shapes'][0]) for p in pre})}"
        f"; peak memory a rank {min(r['i']['peak_gib'] for r in ranks):.2f}-"
        f"{max(r['i']['peak_gib'] for r in ranks):.2f} GiB of the card's "
        f"{total:.1f} GiB; the single process {qsingle_s:.1f} s, 18i on the "
        f"ranks {max(r['i']['seconds'] for r in ranks):.1f} s (its draw in "
        f"turns {max(r['i']['draw_s'] for r in ranks):.1f} s); {smi}")
    pre_ms = {k: round(v * 1e3, 2) for k, v in pre[0]["spent"].items()}
    log(f"[{qlabel}] prefill B=1 S={QDIM_SEQ} through P1: "
        f"{max(p['ms'] for p in pre):.1f} ms at the slowest rank against the "
        f"single process's {qi['prefill_ms']:.1f} ms, logits within "
        f"{max(p['err'] for p in pre):.3g} of the largest; again with each "
        f"collective timed alone (rank 0 {pre[0]['timed_s'] * 1e3:.1f} ms; "
        f"calls a rank {json.dumps(pre[0]['calls'])}): shares of the wall "
        f"at the largest rank {json.dumps(kvs_shares(ranks, 'i', 'prefill'))}"
        f" (rank 0's ms {json.dumps(pre_ms)}"
        f"); {smi}")
    log(f"[{qlabel}] decode at B={KVS_BATCH} fed the single process's greedy "
        f"tokens ({KVS_STEPS} steps): a step's median "
        f"{max(r['i']['dense']['step_ms'] for r in ranks):.1f} ms dense, "
        f"{max(r['i']['paged']['step_ms'] for r in ranks):.1f} ms paged (the "
        f"slowest rank), against the single process's {qi['dense_ms']:.1f} "
        f"and {qi['paged_ms']:.1f} ms; each step's logits within "
        f"{max(r['i']['dense']['err'] for r in ranks):.3g} (dense) and "
        f"{max(r['i']['paged']['err'] for r in ranks):.3g} (paged) of the "
        f"largest (LOGITS_TOL {LOGITS_TOL}); one dense step with each "
        f"collective timed alone (rank 0 {i0['timed_step_s'] * 1e3:.1f} ms; "
        f"calls a rank {json.dumps(i0['calls'])}): shares of the wall at the "
        f"largest rank {json.dumps(kvs_shares(ranks, 'i'))}; paged serving "
        f"{i0['serve_tokens']} tokens in {i0['serve_s']:.1f} s "
        f"({i0['iters']} steps; the single process {qi['serve_tokens']} in "
        f"{qi['serve_s']:.1f} s), the same tokens on every rank, "
        f"{i0['served_differ']} of them differ from the single process's; "
        f"{smi}")
    runs = [run for r in ranks for m in (r["h"], r["i"]) for run in (
        m["dense"]["launches"], m["paged"]["launches"], m["serve_launches"])
        ] + [p["launches"] for p in pre]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    qdim = {k: sum(run[k] for run in [p["launches"] for p in pre] + [
        r["i"][x]["launches"] for r in ranks for x in ("dense", "paged")] + [
        r["i"]["serve_launches"] for r in ranks]) for k in runs[0]}
    log(f"[{label}] launches over the ranks' main-path runs (18h and 18i: "
        f"18i's prefill, dense and paged decode, serving): "
        f"{json.dumps(launches)}; 18i's alone {json.dumps(qdim)}")
    return {"launches": launches,
            "step_ms": max(r["h"]["paged"]["step_ms"] for r in ranks),
            "single_ms": ref["h"]["paged_ms"],
            "qdim_prefill_ms": max(p["ms"] for p in pre),
            "qdim_single_ms": qi["prefill_ms"]}


# ------------------------------------------------------------- phase 19
def expr_values(np, rng, dt, n: int):
    """n values of numpy dtype dt for the expression matrix: random over
    the type's range, small integers, and the edge values (the extremes,
    0, +-0.0, +-inf, NaN); a NaN only ever meets a NaN of the same bits
    (numpy's choice between two different NaNs depends on its code path)."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, n).astype(bool)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        small = rng.integers(-3 if dt.kind == "i" else 0, 4, n).astype(dt)
        v = np.where(rng.random(n) < 0.3, small, v)
        edge = [info.min, info.max, 0, 1, info.max - 1, info.min + 1]
    else:
        with np.errstate(over="ignore"):
            v = (rng.standard_normal(n)
                 * 10.0 ** rng.integers(-5, 6, n)).astype(dt)
        v = np.where(rng.random(n) < 0.2,
                     rng.integers(-3, 4, n).astype(dt), v)
        edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                np.finfo(dt).tiny, np.finfo(dt).max]
    v[:len(edge)] = (np.array(edge, dt) if dt.kind != "f"
                     else np.array(edge, np.float64).astype(dt))
    return v


def same_bits(torch, a, b) -> bool:
    """Two tensors equal bit for bit (NaNs included)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def max_abs_diff(torch, a, b) -> float:
    """The largest |a - b| between two tensors of one shape, in float64:
    0 where both are NaN or equal (infinities too), inf where only one is
    NaN."""
    x, y = a.to(torch.float64), b.to(torch.float64)
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    d = torch.nan_to_num((x - y).abs(), nan=float("inf"))
    d = torch.where(same, torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def span_split(trace, rank="any") -> dict:
    """{span name: ms} over one query's trace (one worker rank's spans
    with ``rank``): the op spans, and the "stage" (fused runs: host
    prologue, copy in, K1, copy out, host epilogue) and "agg" (AGG:
    concatenation, key discovery, copy in, K2, copy out or the host's
    scatter, the merge into the map) spans that split them."""
    out: dict = {}
    for sp in trace.spans:
        if sp.cat in ("op", "stage", "agg") and rank in ("any", sp.rank):
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur_ms
    return out


def expr_bound_ms(program, inputs, n: int) -> tuple:
    """(ms, "bytes" | "operations"): K1's inputs read once (a constant one
    value) and its outputs written once, against one operation per
    instruction and element."""
    nbytes = sum(x.numel() * x.element_size() for x in inputs)
    nbytes += sum(n * dt.itemsize for dt in program.out_dtypes)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = n * len(program.instrs) / PEAK_OPS_CUDA_CORES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def segment_bound_ms(inv, n: int, vals, dtypes, combiners) -> tuple:
    """(ms, "bytes" | "operations"): K2's group ids and values read once
    and its accumulators written once, against one operation per value."""
    from repro_torch.kernels.segment_reduce import acc_dtype
    nbytes = inv.numel() * 8 + sum(v.numel() * v.element_size()
                                   for v in vals)
    nbytes += sum(n * max(1, v[:1].numel()) * acc_dtype(dt, c).itemsize
                  for v, dt, c in zip(vals, dtypes, combiners))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(v.numel() for v in vals) / PEAK_OPS_CUDA_CORES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_relational_kernels(torch) -> dict:
    """K1 and K2 on the card, bit for bit against numpy's bytes and their
    plain versions: K1 over every (op, dtype pair) numpy computes, at the
    executor's batch; K2 over sum / min / max of float64 (NaN and +-0.0
    among the values), int32 (wrapping sums), bool and a (rows, 3) float32
    column, at 3 and 10,000 groups. Neither source's SASS may hold an FMA
    that nvcc contracted from a product and a sum: each must hold as many
    DFMA and FFMA (the division routines' own) as its build with
    ``-fmad=false``, which contracts nothing."""
    import itertools
    import warnings

    import numpy as np

    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import nvcc, ops
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels.transfer import to_device

    t0 = time.perf_counter()
    sources = [ec.SOURCE, sr.SOURCE]
    nofmad = [nvcc.BUILD_DIR / f"{s.stem}-fmad-false.so" for s in sources]
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = [subprocess.Popen([_nvcc_path(), *nvcc.NVCC_FLAGS,
                                "-fmad=false", "-o", str(out), str(s)],
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
              for s, out in zip(sources, nofmad)]
    libs = nvcc.compile_all(sources)
    ec.build(), sr.build()
    for proc in builds:
        if proc.wait(timeout=600) != 0:
            raise AssertionError("the -fmad=false build of the relational "
                                 "sources failed")
    for lib in libs:
        for fn, regs, spill, stack in ptxas_report(lib.with_suffix(".log")):
            log(f"[relational] ptxas {lib.stem}: {fn}: {regs} registers, "
                f"{stack} bytes stack frame, {spill} bytes of spill "
                f"(stores + loads)")
            if fn.startswith("ring_sums") and (stack or spill):
                raise AssertionError(f"{fn}: {stack} bytes of stack frame, "
                                     f"{spill} of spill: K2's chain is in "
                                     f"local memory")
    fma = ("DFMA", "FFMA", "DADD", "DMUL", "MUFU.RCP64H")
    for lib, lib_nofmad in zip(libs, nofmad):
        counts = sass_function_counts(lib, "", fma)
        plain = sass_function_counts(lib_nofmad, "", fma)
        for fn, c in counts.items():
            log(f"[relational] SASS of {fn}: {json.dumps(c)}; with "
                f"-fmad=false: {json.dumps(plain.get(fn))}")
        if not counts or set(counts) != set(plain) or any(
                (c["DFMA"], c["FFMA"]) != (plain[fn]["DFMA"],
                                           plain[fn]["FFMA"])
                for fn, c in counts.items()):
            raise AssertionError(f"{lib.stem}: FMAs beyond those of its "
                                 f"-fmad=false build (a contraction), or "
                                 f"no function: {counts} against {plain}")

    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    ufuncs = {"==": np.equal, "!=": np.not_equal, "<": np.less,
              "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
              "+": np.add, "-": np.subtract, "*": np.multiply,
              "/": np.true_divide, "&&": np.logical_and,
              "||": np.logical_or}
    dtypes = ["?", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2",
              "f4", "f8"]
    n, cases = EXPR_ROWS, 0
    for op, da, db in itertools.product(ufuncs, dtypes, dtypes):
        a, b = expr_values(np, rng, da, n), expr_values(np, rng, db, n)
        try:
            with np.errstate(all="ignore"), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = ufuncs[op](a, b)
        except TypeError:  # numpy refuses it (bool - bool)
            continue
        prog = ec.encode([(op, 2, (0, 1))],
                         {0: a.dtype, 1: b.dtype, 2: want.dtype}, [0, 1], [2])
        ins = to_device([a, b], dev)
        got = ops.expr_core(prog, ins, n)[0]
        plain = ec.expr_core_ref(prog, ins, n)[0]
        torch.cuda.synchronize()
        got_np = got.cpu().numpy().view(want.dtype)
        if got_np.tobytes() != want.tobytes() \
                or not same_bits(torch, got, plain):
            bad = np.nonzero(got_np.view(np.uint8).reshape(n, -1)
                             != want.view(np.uint8).reshape(n, -1))[0][:3]
            raise AssertionError(
                f"expr_core {da} {op} {db}: not numpy's bytes (or the plain "
                f"version's) at rows {bad}: a {a[bad]}, b {b[bad]}, kernel "
                f"{got_np[bad]}, numpy {want[bad]}")
        cases += 1
    for da in dtypes:  # logical not
        a = expr_values(np, rng, da, n)
        want = np.logical_not(a)
        prog = ec.encode([("!", 1, (0,))], {0: a.dtype, 1: want.dtype},
                         [0], [1])
        ins = to_device([a], dev)
        got = ops.expr_core(prog, ins, n)[0]
        if got.cpu().numpy().tobytes() != want.tobytes() or not same_bits(
                torch, got, ec.expr_core_ref(prog, ins, n)[0]):
            raise AssertionError(f"expr_core !{da}: not numpy's bytes")
        cases += 1
    log(f"[relational] expr_core: {cases} (op, dtype pair) cases at "
        f"{n} rows bit-equal to numpy and to the plain version on the card")

    probes = relational_probes(torch, sr)
    segs, k2_ms = 0, {}
    for name, rows, groups, inner in SEGMENT_CASES:
        inv = rng.integers(0, groups, rows).astype(np.int64)
        inv[:groups] = rng.permutation(groups)
        inv[rng.random(rows) < 0.001] = -1  # dropped, as numpy drops it
        if inner is None:
            f64 = rng.standard_normal(rows) * 10.0 ** rng.integers(-3, 4, rows)
            k = rng.random(rows)
            f64[k < 0.01] = np.nan
            f64[(k >= 0.01) & (k < 0.03)] = 0.0
            f64[(k >= 0.03) & (k < 0.05)] = -0.0
            cols = {"float64": f64,
                    "int32": rng.integers(-2**31, 2**31 - 1, rows,
                                          dtype=np.int32),
                    "bool": rng.random(rows) < 0.5,
                    "float32 (rows, 3)": rng.standard_normal(
                        (rows, 3)).astype(np.float32)}
        else:  # linalg's block sums: (rows, inner) float64 blocks
            f64 = rng.standard_normal((rows, inner))
            f64[rng.random(f64.shape) < 0.001] = np.nan
            f64[rng.random(f64.shape) < 0.01] = -0.0
            cols = {f"float64 (rows, {inner})": f64}
        # NaNs of one group share a payload: numpy keeps either of two
        # different NaNs by its code path
        bits = f64.view(np.uint64)
        nan = np.isnan(f64)
        where = np.broadcast_to(inv.reshape((-1,) + (1,) * (f64.ndim - 1)),
                                f64.shape)[nan]
        bits[nan] = np.uint64(0x7ff8000000000000) | (
            (where % 7).astype(np.uint64) + np.uint64(1))
        kept = (inv >= 0) & (inv < groups)
        for comb in ("sum", "min", "max"):
            vals = list(cols.values())
            wants = []
            for v in vals:
                acc = sr.acc_dtype(v.dtype, comb)
                shape = (groups,) + v.shape[1:]
                if comb == "sum":
                    w = np.zeros(shape, acc)
                    np.add.at(w, inv[kept], v[kept])
                else:
                    w = np.full(shape, np.inf if comb == "min" else -np.inf)
                    with np.errstate(invalid="ignore"):
                        (np.minimum if comb == "min" else np.maximum).at(
                            w, inv[kept], v[kept])
                wants.append(w)
            flat = to_device([inv] + vals, dev)
            tv = [t.reshape(v.shape) for t, v in zip(flat[1:], vals)]
            dts = [v.dtype for v in vals]
            combs = [comb] * len(vals)
            got = ops.segment_reduce(flat[0], groups, tv, dts, combs)
            plain = sr.segment_reduce_ref(flat[0], groups, tv, dts, combs)
            torch.cuda.synchronize()
            for col, g, p, w in zip(cols, got, plain, wants):
                g_np = g.cpu().numpy().view(w.dtype)
                if g_np.tobytes() != w.tobytes() \
                        or not same_bits(torch, g, p):
                    raise AssertionError(
                        f"segment_reduce {name} {comb} {col}: not numpy's "
                        f"bytes (or the plain version's)")
            if comb == "sum":
                def call():
                    return ops.segment_reduce(flat[0], groups, tv, dts,
                                              combs)
                k2_ms[name] = cuda_ms(torch, call, 3, warmup=1)
                dev_ms = device_ms(torch, call, 3, "")
                log(f"[relational] segment_reduce {name} ({rows:,} rows, "
                    f"{groups:,} groups, {len(vals)} columns, sums): "
                    f"{k2_ms[name]:.3f} ms by events "
                    f"({on_device(dev_ms, k2_ms[name])}); {probes['smi']}")
            segs += 1
            del flat, tv, got, plain
    log(f"[relational] segment_reduce: {segs} calls (float64 with NaN "
        f"payloads and +-0.0, int32 wrapping, bool, float32 (rows, 3); "
        f"(rows, 16,384) float64 blocks) at "
        f"{', '.join(c[0] for c in SEGMENT_CASES)}, rows outside [0, n) "
        f"dropped, bit-equal to np.add.at / np.minimum.at / np.maximum.at "
        f"and to the plain version; {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return {"expr_cases": cases, "segment_calls": segs,
            "segment_ms": k2_ms, **probes}


def relational_probes(torch, sr) -> dict:
    """The card's own figures for K1's and K2's second bounds: the
    latency of one DADD (a one-thread chain of dependent ``__dadd_rn``,
    ``segment_reduce.dadd_chain``, by events) and the host link's rates
    (a pinned copy each way, ``kernel_compare.link_rates``)."""
    from repro_torch.launch.kernel_compare import link_rates

    x = torch.tensor([1.0, 2.0 ** -60], dtype=torch.float64, device=DEVICE)
    out = sr.dadd_chain(x, 8)
    torch.cuda.synchronize()
    if float(out[0]) != 1.0:  # 1 + 2^-60 rounds back to 1, eight times
        raise AssertionError(f"dadd_chain: {float(out[0])!r}")
    ms = cuda_ms(torch, lambda: sr.dadd_chain(x, DADD_STEPS), 3, warmup=1)
    dadd_ns = ms * 1e6 / DADD_STEPS
    rates = link_rates()
    smi = nvidia_smi()
    clocks = nvidia_smi("clocks.sm,clocks.max.sm")
    log(f"[relational] DADD latency: {dadd_ns:.3f} ns ({DADD_STEPS:,} "
        f"dependent __dadd_rn in one thread, {ms:.2f} ms by events; SM "
        f"clock now, max: {clocks}); host link, pinned copies of "
        f"256 MiB: {rates['h2d'] / 1e9:.2f} GB/s to the card, "
        f"{rates['d2h'] / 1e9:.2f} GB/s back; {smi}")
    return {"dadd_ns": dadd_ns, "link": rates, "smi": smi}


def capture_first_call(ops, name: str, record: dict):
    """A context that keeps the arguments of the first call of
    ``ops.<name>`` in ``record[name]`` (the calls run as before); host
    tensors (views of a staging buffer that the next call refills) as
    copies."""
    inner = getattr(ops, name)

    def keep(a):
        if isinstance(a, (list, tuple)):
            return type(a)(keep(x) for x in a)
        return a.clone() if hasattr(a, "is_cuda") and not a.is_cuda else a

    def spy(*args, **kw):
        if name not in record:
            record[name] = (keep(args), kw)
        return inner(*args, **kw)

    @contextlib.contextmanager
    def patched():
        setattr(ops, name, spy)
        try:
            yield
        finally:
            setattr(ops, name, inner)
    return patched()


def phase_q1(torch, smi: str, probes: dict) -> dict:
    """TPC-H Q1 at scale factor 1.25 through the Session API: the numpy
    backend once as the oracle, then ``expr_backend="torch"`` on the card
    (one warm run, then Q1_TIMED timed): every output column
    byte-identical to the oracle's, shuffle bytes and elided exchanges
    equal, K1 launched once per batch and K2 once per partition, the
    traced query's copies through pinned staging (no pageable one). Times
    K1 (both input paths, ``kernel_compare.compare_expr_io``) and K2 at the
    query's own inputs, beside their bounds: bytes, and K1's link bound and
    K2's chain bound from ``probes`` (``relational_probes``)."""
    import numpy as np

    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.data.synthetic import tpch_q1_lineitems
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.obs import render_analyze

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    recs = tpch_q1_lineitems(Q1_ROWS, seed=SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = Session(num_partitions=Q1_PARTITIONS, expr_backend="numpy")
    ds = host.load("lineitem", recs, LineitemQ1)
    load_s = time.perf_counter() - t0
    del recs
    stored = host.store.get_set(ds.set_name)
    batches = sum(-(-int(c) // host.executor.vector_rows)
                  for c in stored.counts)
    log(f"[q1] {Q1_ROWS:,} lineitems ({stored.dtype.itemsize} bytes each, "
        f"{len(stored.counts)} pages, {batches} batches of "
        f"{host.executor.vector_rows} rows): generated in {gen_s:.2f} s, "
        f"loaded in {load_s:.2f} s")

    def run(sess):
        t = time.perf_counter()
        out = q1_pricing_summary(sess.store, ds.set_name,
                                 session=sess).collect()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    host.trace = True  # per-op spans (obs.trace), and the splits of ops
    want, host_s = run(host)
    host_stats = host.last_stats
    host_split = span_split(host.last_trace)
    for line in render_analyze(host.last_trace).splitlines():
        log(f"[q1: numpy backend] {line}")
    card = Session(store=host.store, num_partitions=Q1_PARTITIONS,
                   expr_backend="torch")
    seen: dict = {}
    with capture_first_call(ops, "expr_core", seen), \
            capture_first_call(ops, "segment_reduce", seen):
        _, warm_s = run(card)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walls, got = [], None
    for _ in range(Q1_TIMED):
        got, wall = run(card)
        walls.append(wall)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = sorted(walls)[len(walls) // 2]
    stats = card.last_stats
    for name in want:
        if got[name].dtype != want[name].dtype \
                or got[name].tobytes() != want[name].tobytes():
            raise AssertionError(f"q1: column {name} differs from the numpy "
                                 f"backend's bytes")
    if (stats.shuffle_bytes, stats.exchanges_elided) != (
            host_stats.shuffle_bytes, host_stats.exchanges_elided):
        raise AssertionError(
            f"q1: shuffle_bytes/exchanges_elided {stats.shuffle_bytes}/"
            f"{stats.exchanges_elided}, numpy backend's "
            f"{host_stats.shuffle_bytes}/{host_stats.exchanges_elided}")
    per_query = {k: v / Q1_TIMED for k, v in launches.items()}
    parts = min(len(stored.counts), Q1_PARTITIONS)  # partitions with pages
    want_launches = {**{k: 0 for k in launches}, "expr_core": batches,
                     "segment_reduce": parts}
    if per_query != want_launches:
        raise AssertionError(f"q1 launches per query {per_query}, want "
                             f"{want_launches}")
    groups = len(next(iter(want.values())))
    log(f"[q1] numpy backend (oracle): {host_s:.2f} s, "
        f"{Q1_ROWS / host_s:,.0f} rows/s; torch backend on the card: warm "
        f"run {warm_s:.2f} s, then {wall:.2f} s median of {Q1_TIMED} "
        f"({', '.join(f'{w:.2f}' for w in walls)} s), "
        f"{Q1_ROWS / wall:,.0f} rows/s; {groups} groups, every column "
        f"byte-identical to the oracle's; shuffle_bytes "
        f"{stats.shuffle_bytes}, exchanges_elided {stats.exchanges_elided} "
        f"on both; peak device memory {peak:.2f} GiB; {smi}")
    log(f"[q1] launches per query: expr_core {per_query['expr_core']:.0f} "
        f"(batches that reached the core: {batches}), segment_reduce "
        f"{per_query['segment_reduce']:.0f} (partitions holding rows: "
        f"{parts} of {Q1_PARTITIONS})")
    card.trace = True
    _, traced_s = run(card)
    card.trace = False
    card_split = span_split(card.last_trace)
    pageable = {"stage:to_device", "stage:to_host", "agg:to_device"}
    if pageable & set(card_split) or not {
            "stage:pinned_in", "stage:pinned_out",
            "agg:pinned_in"} <= set(card_split):
        raise AssertionError(f"q1: the traced query's copies are not the "
                             f"pinned path's: {sorted(card_split)}")
    for line in render_analyze(card.last_trace).splitlines():
        log(f"[q1: torch backend] {line}")
    for label, split, s in (("numpy backend", host_split, host_s),
                            ("torch backend", card_split, traced_s)):
        log(f"[q1: {label}] one traced query, {s:.2f} s; ms by span: "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    busy, by_name = device_breakdown(torch, lambda: run(card), wall,
                                     "q1: one query on the card")

    from repro_torch.launch.kernel_compare import compare_expr_io

    (prog, ins, n), _ = seen["expr_core"]
    arrays = [x.numpy().view(dt) for x, dt in zip(ins, prog.in_dtypes)]
    io = compare_expr_io(prog, arrays, n, probes["link"])
    ins = [x.to(DEVICE) for x in ins]
    got1 = ops.expr_core(prog, ins, n)
    plain1 = ec.expr_core_ref(prog, ins, n)
    torch.cuda.synchronize()
    if not all(same_bits(torch, g, p) for g, p in zip(got1, plain1)):
        raise AssertionError("expr_core at Q1's batch: not the plain "
                             "version's bytes")
    k1_err = max(max_abs_diff(torch, g, p) for g, p in zip(got1, plain1))
    k1_ms = io["mapped"]["events_ms"]
    k1_plain = cuda_ms(torch, lambda: ec.expr_core_ref(prog, ins, n), 20)
    k1_bound, k1_by = expr_bound_ms(prog, ins, n)
    (inv, groups_n, vals, dts, combs), _ = seen["segment_reduce"]
    k2_ms = cuda_ms(torch, lambda: ops.segment_reduce(
        inv, groups_n, vals, dts, combs), 3, warmup=1)
    t0 = time.perf_counter()
    plain = sr.segment_reduce_ref(inv, groups_n, vals, dts, combs)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    got2 = ops.segment_reduce(inv, groups_n, vals, dts, combs)
    for g, p in zip(got2, plain):
        if not same_bits(torch, g, p):
            raise AssertionError("segment_reduce at Q1's partition: not the "
                                 "plain version's bytes")
    k2_err = max(max_abs_diff(torch, g, p) for g, p in zip(got2, plain))

    def scatter_reduce():  # the yardstick: atomics, not numpy's bytes
        for v, dt, c in zip(vals, dts, combs):
            acc = torch.zeros((groups_n,) + tuple(v.shape[1:]),
                              dtype=torch.float64 if c != "sum" or
                              dt.kind == "f" else torch.int64, device=inv.device)
            src = v.to(acc.dtype)
            acc.scatter_reduce_(0, inv.view((-1,) + (1,) * (v.dim() - 1))
                                .expand_as(src), src,
                                {"sum": "sum", "min": "amin",
                                 "max": "amax"}[c])
    k2_lib = cuda_ms(torch, scatter_reduce, 3, warmup=1)
    k2_bound, k2_by = segment_bound_ms(inv, groups_n, vals, dts, combs)
    sizes = torch.bincount(inv[(inv >= 0) & (inv < groups_n)],
                           minlength=groups_n).tolist()
    chain_bound = max(sizes) * probes["dadd_ns"] * 1e-6
    device_breakdown(
        torch, lambda: ops.segment_reduce(inv, groups_n, vals, dts, combs),
        k2_ms / 1e3, "q1: K2 at the first partition", top=10)
    k1_dev = sum(t for k, t in by_name.items() if "expr_core" in k)
    k2_dev = sum(t for k, t in by_name.items()
                 if any(f"::{f}(" in k for f in K2_KERNELS))
    log(f"[q1] expr_core at Q1's batch ({n} rows, {len(ins)} inputs, "
        f"{len(prog.instrs)} instructions, {len(prog.outputs)} outputs, "
        f"{io['bytes']:,} bytes): reading pinned inputs through the card's "
        f"mapping {k1_ms:.4f} ms per launch by events, "
        f"{io['mapped']['device_ms']:.4f} ms on the device, "
        f"{io['mapped']['per_batch_host_ms']:.4f} ms a batch on the host "
        f"clock (pack, launch, wait, copy out); staged by one copy "
        f"{io['staged']['events_ms']:.4f} / "
        f"{io['staged']['device_ms']:.4f} / "
        f"{io['staged']['per_batch_host_ms']:.4f} ms; plain "
        f"{k1_plain:.4f} ms, bound {k1_bound:.6f} ms by {k1_by}, link "
        f"bound {io['link_bound_ms']:.4f} ms; {k1_dev * 1e3:.1f} ms of the "
        f"query's device time")
    log(f"[q1] segment_reduce at Q1's first partition ({inv.shape[0]:,} "
        f"rows, {groups_n} groups of {sizes} rows, {len(vals)} columns): "
        f"{k2_ms:.2f} ms per launch by events, plain (on the host) "
        f"{k2_plain:.1f} ms, scatter_reduce_ (library_ms, atomics: not "
        f"numpy's bytes) {k2_lib:.3f} ms, bound {k2_bound:.4f} ms by "
        f"{k2_by} ({k2_bound / k2_ms:.2%} of it), chain bound "
        f"{chain_bound:.3f} ms ({max(sizes):,} rows x "
        f"{probes['dadd_ns']:.3f} ns; {chain_bound / k2_ms:.1%} of it); "
        f"{k2_dev * 1e3:.1f} ms of the query's device time")
    log(f"[q1] largest |kernel - plain version| at Q1's inputs: "
        f"expr_core {k1_err}, segment_reduce {k2_err}")
    log(f"[q1] phase: {time.perf_counter() - t_phase:.1f} s")
    del seen, ins, arrays, inv, vals, got1, plain1, got2, plain
    torch.cuda.empty_cache()
    return {"launches": launches, "oracle": want, "store": host.store,
            "set": ds.set_name, "batches": batches, "parts": parts,
            "numpy_s": host_s, "torch_s": wall,
            "expr_core": dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
                              bound_ms=k1_bound, bound_by=k1_by,
                              library_ms=None),
            "segment_reduce": dict(max_abs_err=k2_err, ms=k2_ms,
                                   plain_ms=k2_plain, bound_ms=k2_bound,
                                   bound_by=k2_by, library_ms=k2_lib),
            "k1_io": io, "k2_chain_bound_ms": chain_bound,
            "k2_group_rows": sizes}


# ---------------------------------------------------------- phases 20-23
def same_columns(got: dict, want: dict, label: str) -> None:
    """Every column of ``want`` in ``got`` with its dtype, shape and bytes;
    AssertionError naming the first that differs."""
    import numpy as np
    if set(got) != set(want):
        raise AssertionError(f"{label}: columns {sorted(got)}, want "
                             f"{sorted(want)}")
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape \
                or g.tobytes() != w.tobytes():
            raise AssertionError(f"{label}: column {name} differs from the "
                                 f"numpy backend's bytes")


def check_launches(ops, want: dict, label: str) -> dict:
    """The launch counts since the last reset, which must be ``want`` for
    the relational kernels and 0 for every other kernel."""
    got = ops.launch_counts()
    full = {**{k: 0 for k in got}, **want}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, want {full}")
    return got


def rank_bytes(sess) -> list:
    return [w.shuffle_bytes for w in sess.executor.worker_stats]


def pinned_host_gib(torch) -> str:
    """What the host holds in pinned (page-locked) memory through torch's
    caching host allocator, GiB, now and at its peak."""
    stats = torch.cuda.host_memory_stats()
    return (f"{stats.get('allocated_bytes.current', 0) / 2**30:.2f} GiB "
            f"(peak {stats.get('allocated_bytes.peak', 0) / 2**30:.2f} GiB) "
            f"in {stats.get('allocations.current', 0)} blocks")


def phase_workers_q1(torch, smi: str, q1: dict) -> dict:
    """Phase 20: TPC-H Q1 at SF 1.25 (phase 19's lineitem set, no cut) over
    WORKERS thread workers sharing the card, on ``expr_backend="torch"``:
    one warm run, then WORKERS_TIMED runs; every column byte-identical to
    phase 19's numpy-backend answer, K1 once per batch of every rank and
    K2 once per rank holding rows, each run. Then one query's device busy share, and
    the same query through socket workers launched as threads (real TCP),
    traced (every rank's spans), whose per-rank shuffle bytes equal the
    thread workers'."""
    from repro_torch.apps.tpch import q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    want, store, name = q1["oracle"], q1["store"], q1["set"]
    expect = {"expr_core": q1["batches"], "segment_reduce": q1["parts"]}

    def run(sess):
        t = time.perf_counter()
        out = q1_pricing_summary(sess.store, name, session=sess).collect()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    workers = Session(store=store, backend="workers", num_workers=WORKERS,
                      worker_kind="thread", expr_backend="torch")
    _, warm_s = run(workers)
    log(f"[workers q1] pinned host memory after the warm run: "
        f"{pinned_host_gib(torch)}")
    walls = []
    launches = {k: 0 for k in ops.launch_counts()}
    for _ in range(WORKERS_TIMED):
        ops.reset_launch_counts()
        got, wall = run(workers)
        counts = check_launches(ops, expect, "workers q1")
        same_columns(got, want, "workers q1")
        walls.append(wall)
        launches = {k: launches[k] + v for k, v in counts.items()}
    wall = sorted(walls)[len(walls) // 2]
    sb = rank_bytes(workers)
    log(f"[workers q1] {Q1_ROWS:,} lineitems over {WORKERS} thread workers "
        f"on one card: warm run {warm_s:.2f} s, then {wall:.2f} s median "
        f"of {len(walls)} ({', '.join(f'{w:.2f}' for w in walls)} s), "
        f"{Q1_ROWS / wall:,.0f} rows/s; local torch "
        f"backend (phase 19) {q1['torch_s']:.2f} s, numpy backend "
        f"{q1['numpy_s']:.2f} s; every column byte-identical to the numpy "
        f"backend's; per-rank shuffle_bytes {sb}; {smi}")
    log(f"[workers q1] launches per query: expr_core "
        f"{expect['expr_core']} (the ranks' batches), segment_reduce "
        f"{expect['segment_reduce']} (ranks holding rows); pinned host "
        f"memory {pinned_host_gib(torch)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy, _ = device_breakdown(torch, lambda: run(workers), wall,
                               "workers q1: one query, 4 ranks on the card")
    sock = Session(store=store, backend="workers", num_workers=WORKERS,
                   worker_kind="socket", socket_launch="thread",
                   expr_backend="torch", trace=True)
    ops.reset_launch_counts()
    got, sock_s = run(sock)
    trace = sock.last_trace
    for rank in trace.ranks():
        split = span_split(trace, rank)
        top = sorted(split.items(), key=lambda kv: -kv[1])[:8]
        total = sum(sp.dur_ms for sp in trace.find("worker", rank=rank))
        log(f"[workers q1: rank {rank}] {total:.1f} ms in the worker span "
            f"of the {sock_s:.2f} s traced socket query; ms by span: "
            + ", ".join(f"{k} {v:.1f}" for k, v in top))
    counts = check_launches(ops, expect, "socket workers q1")
    same_columns(got, want, "socket workers q1")
    if rank_bytes(sock) != sb:
        raise AssertionError(f"socket workers q1: per-rank shuffle_bytes "
                             f"{rank_bytes(sock)}, thread workers' {sb}")
    launches = {k: launches[k] + v for k, v in counts.items()}
    log(f"[workers q1] socket workers launched as threads (real TCP), "
        f"traced: {sock_s:.2f} s, every column byte-identical, per-rank "
        f"shuffle_bytes equal to the thread workers'; {smi}")
    log(f"[workers q1] phase: {time.perf_counter() - t_phase:.1f} s")
    del workers, sock, got, trace
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall, "socket_s": sock_s,
            "busy": busy / wall}


def entry_points(sess, cust, lines, n_parts, query) -> tuple:
    """``customers_per_supplier`` and ``topk_jaccard`` through ``sess`` as
    one dict of columns, and each one's per-rank shuffle bytes (workers
    sessions; [] otherwise)."""
    import numpy as np

    from repro_torch.apps.tpch import (customers_per_supplier, load_tpch,
                                       topk_jaccard)
    ranks = (rank_bytes if hasattr(sess.executor, "worker_stats")
             else lambda s: [])
    _, ln = load_tpch(sess.store, cust, lines, session=sess)
    cps = customers_per_supplier(sess.store, ln, n_parts, session=sess)
    cps_bytes = ranks(sess)
    ids, scores = topk_jaccard(sess.store, ln, n_parts, query,
                               k=TPCH_TOPK, session=sess)
    cols = {f"cps {s}:{c}": v for s, per in cps.items()
            for c, v in per.items()}
    cols.update(ids=np.asarray(ids), scores=np.asarray(scores))
    return cols, (cps_bytes, ranks(sess))


def phase_entry_points(torch, smi: str) -> dict:
    """Phase 21: the join and top-k entry points (``apps/tpch.py``
    ``customers_per_supplier``, a two-key aggregation, and
    ``topk_jaccard``, an aggregation written in place then a top-k) over
    ``denormalized_tpch`` at bench_oo's largest size, on the local numpy
    (the oracle) and torch backends and on WORKERS workers: numpy thread
    workers, torch thread workers and torch socket workers launched as
    threads. Every answer byte-identical to the oracle's; the torch
    workers' per-rank shuffle bytes equal the numpy workers'."""
    import numpy as np

    from repro_torch.core import Session
    from repro_torch.data.synthetic import denormalized_tpch
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    cust, lines, _n_supp, n_parts = denormalized_tpch(TPCH_CUSTOMERS,
                                                      seed=1)
    query = np.unique(lines["partkey"][:32])
    want, _ = entry_points(Session(num_partitions=WORKERS,
                                   expr_backend="numpy"),
                           cust, lines, n_parts, query)
    _, numpy_bytes = entry_points(
        Session(backend="workers", num_workers=WORKERS,
                expr_backend="numpy"), cust, lines, n_parts, query)
    launches = {k: 0 for k in ops.launch_counts()}
    walls = {}
    for label, kw in (("local", {"num_partitions": WORKERS}),
                      ("thread workers", {"backend": "workers",
                                          "num_workers": WORKERS}),
                      ("socket workers", {"backend": "workers",
                                          "num_workers": WORKERS,
                                          "worker_kind": "socket",
                                          "socket_launch": "thread"})):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got, got_bytes = entry_points(Session(expr_backend="torch", **kw),
                                      cust, lines, n_parts, query)
        walls[label] = time.perf_counter() - t0
        counts = ops.launch_counts()
        same_columns(got, want, f"entry points on {label}")
        if label != "local" and got_bytes != numpy_bytes:
            raise AssertionError(
                f"entry points on {label}: per-rank shuffle_bytes "
                f"{got_bytes}, numpy workers' {numpy_bytes}")
        if not counts["segment_reduce"]:  # native lambdas: no K1 core
            raise AssertionError(f"entry points on {label}: launches "
                                 f"{counts}")
        launches = {k: launches[k] + v for k, v in counts.items()}
    log(f"[entry points] {len(cust):,} customers, {len(lines):,} "
        f"lineitems, {n_parts} parts: customers_per_supplier "
        f"({len([c for c in want if c.startswith('cps')])} (supplier, "
        f"customer) sets) and topk_jaccard (k={TPCH_TOPK}) byte-identical "
        f"to the local numpy backend on "
        + ", ".join(f"{k} ({v:.2f} s)" for k, v in walls.items())
        + f"; per-rank shuffle_bytes equal to the numpy workers' "
        f"{numpy_bytes}; launches {launches}; {smi}")
    log(f"[entry points] phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "walls": walls}


def dsl_queries(core, ds) -> dict:
    """The lambda-DSL queries the service's clients send beside Q1 (the
    service ships programs pickled, so native lambdas, and with them the
    TPC-H entry points, are refused there): a group-by over the
    denormalized lineitems and a top-k."""
    agg = core.agg
    by_supp = (ds.filter(lambda r: r.qty > 5)
                 .group_by("suppkey")
                 .agg(n=agg.count(), qty=agg.sum("qty"),
                      hi=agg.max("price"), avg=agg.mean("price"))
                 .collect())
    top = ds.top_k(TPCH_TOPK, score="price", payload="orderkey").collect()
    return {**{f"by_supp {k}": v for k, v in by_supp.items()},
            **{f"top {k}": v for k, v in top.items()}}


def phase_service(torch, smi: str, q1: dict) -> dict:
    """Phase 22: the query service. A ``QueryService(launch="thread",
    num_workers=WORKERS, expr_backend="torch")`` over phase 19's store: a
    cold Q1 at SF 1.25 ships the shards (SETUP bytes), then SERVICE_CLIENTS
    ``Session.connect`` clients submit Q1 (warm: zero SETUP bytes) and
    the DSL queries at the same time, SERVICE_ADMITTED of them admitted
    at once. Every answer byte-identical to the
    numpy backend's; K1 and K2 counted on the cold query alone."""
    import threading

    import repro_torch.core as core
    from repro_torch.apps.tpch import Lineitem, q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.data.synthetic import denormalized_tpch
    from repro_torch.kernels import ops
    from repro_torch.service import QueryService

    t_phase = time.perf_counter()
    want, store, name = q1["oracle"], q1["store"], q1["set"]
    _cust, lines, _, _ = denormalized_tpch(TPCH_CUSTOMERS, seed=1)
    local = Session(num_partitions=WORKERS, expr_backend="numpy")
    want_dsl = dsl_queries(core, local.load("denorm", lines, Lineitem))
    expect = {"expr_core": q1["batches"], "segment_reduce": q1["parts"]}
    results, errors = {}, []
    with QueryService(store=store, num_workers=WORKERS, launch="thread",
                      expr_backend="torch",
                      max_concurrent=SERVICE_ADMITTED) as svc:
        svc.wait_ready(60)
        first = Session.connect(svc)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = q1_pricing_summary(svc.store, name, session=first).collect()
        cold_s = time.perf_counter() - t0
        launches = check_launches(ops, expect, "service q1, cold")
        same_columns(got, want, "service q1, cold")
        cold_setup = first.executor.last_setup_bytes
        if not cold_setup:
            raise AssertionError("service q1, cold: no SETUP bytes shipped")
        barrier = threading.Barrier(SERVICE_CLIENTS)

        def client(k):
            try:
                sess = Session.connect(svc)
                ds = sess.load(f"denorm{k}", lines, Lineitem)
                barrier.wait(timeout=600)
                t = time.perf_counter()
                out = q1_pricing_summary(svc.store, name,
                                         session=sess).collect()
                q1_s = time.perf_counter() - t
                setup = sess.executor.last_setup_bytes
                dsl = dsl_queries(core, ds)
                results[k] = (out, setup, q1_s, dsl,
                              time.perf_counter() - t)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append((k, e))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVICE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        warm_s = time.perf_counter() - t0
        if errors or len(results) != SERVICE_CLIENTS:
            raise AssertionError(f"service clients failed: {errors}")
        for k, (out, setup, _, dsl, _) in sorted(results.items()):
            same_columns(out, want, f"service client {k}: q1")
            same_columns(dsl, want_dsl, f"service client {k}: DSL queries")
            if setup:
                raise AssertionError(f"service client {k}: the warm Q1 "
                                     f"shipped {setup} SETUP bytes")
        runs = svc.queries_run
    log(f"[service] {WORKERS} resident thread workers on the card: Q1 at "
        f"SF 1.25 cold {cold_s:.2f} s ({cold_setup:,} SETUP bytes); then "
        f"{SERVICE_CLIENTS} clients at once ({SERVICE_ADMITTED} admitted at "
        f"a time), each a warm Q1 (0 SETUP "
        f"bytes) and the DSL queries, in {warm_s:.2f} s wall (Q1 "
        + ", ".join(f"{r[2]:.2f}" for _, r in sorted(results.items()))
        + f" s; a client's queries "
        + ", ".join(f"{r[4]:.2f}" for _, r in sorted(results.items()))
        + f" s); {runs} queries run; every answer byte-identical to the "
        f"numpy backend's; pinned host memory {pinned_host_gib(torch)}; "
        f"{smi}")
    log(f"[service] phase: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return {"launches": launches, "cold_s": cold_s, "warm_s": warm_s}


def phase_tools(torch, smi: str) -> dict:
    """Phase 23: the tools at the reference's benchmark sizes on the torch
    backend, each byte-identical to the numpy backend's: lilLinAlg's Gram
    matrix and multiply (``benchmarks/bench_linalg.py:28``: n = 4,096 rows
    of LINALG_DIM, blocks of 64), the block products' sums through K2; and
    k-means (``benchmarks/bench_ml.py:20``: 20,000 points of 32 dims, k =
    10, 3 iterations)."""
    import numpy as np

    from repro_torch.apps import KMeans, LinAlgSession
    from repro_torch.data.synthetic import points
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(LINALG_ROWS, LINALG_DIM))
    x, _ = points(KMEANS_POINTS, KMEANS_DIM, n_clusters=KMEANS_K, seed=0)

    def tools(kw):
        la = LinAlgSession(block_size=LINALG_BLOCK, num_partitions=4, **kw)
        la.load("X", X)
        t0 = time.perf_counter()
        out = la.run("G = X '* X\nM = X %*% G")
        la_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cents = KMeans(KMEANS_K, iters=KMEANS_ITERS, **kw).fit(x)
        km_s = time.perf_counter() - t0
        return ({"G": la.fetch(out["G"]), "M": la.fetch(out["M"]),
                 "centroids": cents}, la_s, km_s)

    want, la_np, km_np = tools({"expr_backend": "numpy"})
    ops.reset_launch_counts()
    got, la_s, km_s = tools({"expr_backend": "torch"})
    launches = ops.launch_counts()
    same_columns(got, want, "tools")
    if not launches["segment_reduce"]:
        raise AssertionError(f"tools: launches {launches}")
    err = float(np.abs(got["G"] - X.T @ X).max())
    log(f"[tools] lilLinAlg G = X'X, M = X G (X {LINALG_ROWS}x{LINALG_DIM}, "
        f"blocks of {LINALG_BLOCK}): torch {la_s:.2f} s, numpy "
        f"{la_np:.2f} s; k-means ({KMEANS_POINTS:,} x {KMEANS_DIM}, k "
        f"{KMEANS_K}, {KMEANS_ITERS} iterations): torch {km_s:.2f} s, numpy "
        f"{km_np:.2f} s; every result byte-identical to the numpy "
        f"backend's (G against X.T @ X: {err:.2e}); launches {launches}; "
        f"{smi}")
    log(f"[tools] phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def train_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` training steps: moe_gather and
    its backward per MoE layer, ssm_scan and its backward per Mamba layer,
    flash and paged attention none (training runs attention on the plain
    path). Under ``cfg.remat`` "full" or "dots" each layer's forward runs
    again in the backward, its kernels too: two forward launches a layer
    a step."""
    per = expected_launches(cfg)
    again = 2 if cfg.remat in ("full", "dots") else 1
    return {"moe_gather": per["moe_gather"] * steps * again,
            "moe_gather_bwd": per["moe_gather"] * steps,
            "ssm_scan": per["ssm_scan"] * steps * again,
            "ssm_scan_bwd": per["ssm_scan"] * steps}


def moe_train_flops(cfg, B: int, S: int) -> float:
    """The matmul operations of one training step of a MoE decoder-only
    stack (the forward's, x 3 for the backward's two products each): per
    layer the q/k/v/o projections, the plain path's full (S, S) scores
    and weighted sum, the router, the E x C slots' three expert products
    (kept or not) and the shared experts'; then the LM head."""
    from repro_torch.models.moe import expert_capacity
    T, d, hd = B * S, cfg.d_model, cfg.head_dim or cfg.d_model // cfg.n_heads
    qkvo = 2 * T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    scores = 2 * 2 * B * cfg.n_heads * S * S * hd
    slots = cfg.n_experts * expert_capacity(cfg, T)
    experts = 2 * 3 * slots * d * cfg.d_ff
    shared = 2 * 3 * T * d * cfg.n_shared_experts * cfg.d_ff
    router = 2 * T * d * cfg.n_experts
    head = 2 * T * d * cfg.vocab_size
    return 3.0 * (cfg.n_layers * (qkvo + scores + experts + shared + router)
                  + head)


def phase_train(torch, smi: str) -> dict:
    """The training stack at full width: ``train_loop`` on qwen2-moe-a2.7b
    cut to TRAIN_LAYERS layers, float32 weights and AdamW moments, one
    repeated batch; per step its ms, tokens/s, loss and gradient norm;
    the peak memory; the launches (both gather kernels once per MoE layer
    a step, no attention kernel); then one more step of the same state
    under the profiler for the device's busy share."""
    import numpy as np

    from repro_torch.engine import TrainConfig, make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import AdamWConfig, constant

    label = "train"
    model = build_model(MOE_ARCH, TRAIN_LAYERS)  # meta: the config only
    cfg = model.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_loop(MOE_ARCH, reduced=False, layers=TRAIN_LAYERS,
                     steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     records=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                     device=DEVICE, log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(ops, train_launches(cfg, TRAIN_STEPS), label)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_BATCH * (TRAIN_SEQ + 1)
    log(f"[{label}] {cfg.name} at every published width, {cfg.n_layers} of "
        f"24 layers ({model.param_count() / 1e9:.3f} B parameters), float32 "
        f"weights and AdamW moments, B={TRAIN_BATCH} x {TRAIN_SEQ + 1} "
        f"tokens, one repeated batch, lr {TRAIN_LR} (warmup-cosine over "
        f"{TRAIN_STEPS} steps): {wall:.1f} s for train_loop (weights drawn, "
        f"the first step's set-up); {smi}")
    for h in out["history"]:
        log(f"[{label}] step {h['step']}: {h['seconds'] * 1e3:.1f} ms, "
            f"{tokens / h['seconds']:.0f} tokens/s, loss {h['loss']:.4f}, "
            f"grad norm {h['grad_norm']:.4f}, lr {h['lr']:.3g}")
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} are not finite or "
                             f"do not fall on one repeated batch")
    log(f"[{label}] peak memory {peak:.2f} GiB (limit {TRAIN_PEAK_GIB}); "
        f"launches over the {TRAIN_STEPS} steps: {json.dumps(launches)}")
    if peak > TRAIN_PEAK_GIB:
        raise AssertionError(f"{label}: peak memory {peak:.2f} GiB")

    # one more step of the same state and batch shape, timed, then profiled
    step = make_train_step(model, Ctx(), TrainConfig(
        opt=AdamWConfig(moment_dtype="float32")), constant(TRAIN_LR))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
        dtype=np.int32)).to(DEVICE)
    batch = {"tokens": toks, "labels": toks}
    state = [out["params"], out["opt"]]
    history = out["history"]
    del out

    def one():
        state[0], state[1], _, m = step(state[0], state[1], None, batch)
        return float(m["total_loss"])

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    step_s = time.perf_counter() - t0
    busy, kernels = device_breakdown(torch, one, step_s, label, top=8)
    flops = moe_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ + 1)
    log(f"[{label}] one more step timed alone: {step_s * 1e3:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, device busy {busy / step_s:.1%}; "
        f"{flops / 1e12:.2f} TFLOP of matmuls a step, "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / PEAK_FLOPS['float32']:.1%} of the float32 peak "
        f"(TF32 off); {smi}")
    log(f"[{label}] remat={cfg.remat!r} (the config's; each layer's forward "
        f"runs again in the backward): {step_s * 1e3:.1f} ms a step and "
        f"{peak:.2f} GiB peak, beside {NO_REMAT_STEP_MS} ms and "
        f"{NO_REMAT_PEAK_GIB} GiB for this run without remat; "
        f"{smi}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "peak_gib": peak,
            "busy": busy / step_s, "history": history}


def phase_train_reduced(torch, smi: str) -> list:
    """``train_loop`` at ``reduced_config`` on the card for each of
    REDUCED_TRAIN, against the same run on the CPU from the same weights
    and batches (losses within TRAIN_LOSS_TOL, step for step; launches as
    ``train_launches``); then one run with a checkpoint directory and an
    injected failure: the supervisor restores the last checkpoint on the
    card and replays, the replayed steps' losses equal to the first
    pass's. Returns each card run's launch counts."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model

    runs = []
    for name in REDUCED_TRAIN:
        label = f"train {name} reduced"
        cfg = reduced_config(get_arch(name))
        weights = build_model(cfg).init_params(
            torch.Generator().manual_seed(SEED), "float32").state_dict()
        kw = dict(reduced=False, steps=REDUCED_STEPS, batch=REDUCED_BATCH,
                  seq=REDUCED_SEQ, seed=SEED, weights=weights,
                  log_every=REDUCED_STEPS)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card = train_loop(cfg, device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(check_launches(ops, train_launches(cfg, REDUCED_STEPS),
                                   label))
        host = train_loop(cfg, device="cpu", **kw)
        rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                   host["losses"])]
        if not all(np.isfinite(card["losses"])) or max(rel) > TRAIN_LOSS_TOL:
            raise AssertionError(f"{label}: card {card['losses']} against "
                                 f"the CPU's {host['losses']}")
        log(f"[{label}] {REDUCED_STEPS} steps of B={REDUCED_BATCH} x "
            f"{REDUCED_SEQ + 1} tokens in {wall:.2f} s on the card; losses "
            f"{[round(x, 5) for x in card['losses']]}, the CPU's within "
            f"{max(rel):.2g} relative (tol {TRAIN_LOSS_TOL}); launches "
            f"{json.dumps(runs[-1])}")
    cfg = reduced_config(get_arch(RESTART_ARCH))
    label = f"train {RESTART_ARCH} restart"
    with tempfile.TemporaryDirectory() as ckpt:
        out = train_loop(cfg, reduced=False, steps=RESTART_STEPS,
                         batch=REDUCED_BATCH, seq=REDUCED_SEQ, seed=SEED,
                         ckpt_dir=ckpt, save_every=RESTART_EVERY,
                         fail_at=RESTART_FAIL_AT, device=DEVICE,
                         log_every=RESTART_STEPS)
    rep, losses = out["report"], out["losses"]
    last = RESTART_FAIL_AT // RESTART_EVERY * RESTART_EVERY
    first = losses[last:RESTART_FAIL_AT]
    replay = losses[RESTART_FAIL_AT:RESTART_FAIL_AT + len(first)]
    if rep.restarts != 1 or rep.restored_from != [last] or \
            len(losses) != RESTART_STEPS + RESTART_FAIL_AT - last or \
            not np.allclose(first, replay, rtol=TRAIN_LOSS_TOL, atol=0):
        raise AssertionError(f"{label}: report {rep}, losses {losses}")
    log(f"[{label}] failure injected before step {RESTART_FAIL_AT}: "
        f"{rep.restarts} restart from the step-{last} checkpoint, steps "
        f"{last}-{RESTART_FAIL_AT - 1} replayed with losses "
        f"{[round(x, 6) for x in replay]} (first pass "
        f"{[round(x, 6) for x in first]}), {rep.steps_run} steps run, final "
        f"loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    start = time.perf_counter()
    smi = phase_environment(torch)
    kernel = phase_kernel(torch)
    gather = phase_gather(torch)
    scan = phase_scan(torch)
    gather_bwd = phase_gather_bwd(torch)
    scan_bwd = phase_scan_bwd(torch)
    paged = phase_paged(torch)
    partial = phase_paged_partial(torch)
    log(f"[timing] phases 1-2: {time.perf_counter() - start:.1f} s")
    runs, summaries = [], []
    models = [(ARCH, "", True), (MOE_ARCH, "moe ", False),
              (hybrid_config(), "hybrid ", False)] + [
        (other_arch(name), f"{label} ", False)
        for name, label in OTHER_ARCHS]
    for arch, label, long_context in models:
        t0 = time.perf_counter()
        summary = {}
        prefill_runs, served = phase_prefill(torch, arch, f"{label}prefill",
                                             summary, long_context)
        runs += prefill_runs
        runs.append(phase_serving(torch, arch, f"{label}serve", served,
                                  summary))
        summaries.append(summary)
        log(f"[timing] {label}prefill and serve phases: "
            f"{time.perf_counter() - t0:.1f} s (run so far "
            f"{time.perf_counter() - start:.1f} s)")
    for m in summaries:
        log(f"[summary] {m['name']} ({m['layers']} layers): prefill "
            f"{m['prefill_tps']:.0f} tokens/s (B={m['B']} S={m['S']}); "
            f"decode {m['decode_ms']:.1f} ms/step at batch 4, dense cache "
            f"(device busy {m['decode_busy']:.1%}); serve_batch "
            f"{m['serve_tps']:.1f} tokens/s; peak memory "
            f"{m['peak_gib']:.2f} GiB; {smi}")
    t0 = time.perf_counter()
    train = phase_train(torch, smi)
    runs.append(train["launches"])
    runs += phase_train_reduced(torch, smi)
    log(f"[summary] {MOE_ARCH} training at full width, {TRAIN_LAYERS} "
        f"layers: {train['step_ms']:.1f} ms/step, {train['tokens_per_s']:.0f}"
        f" tokens/s (B={TRAIN_BATCH} x {TRAIN_SEQ + 1}), peak memory "
        f"{train['peak_gib']:.2f} GiB, device busy {train['busy']:.1%}; "
        f"{smi}")
    log(f"[timing] training phases: {time.perf_counter() - t0:.1f} s (run "
        f"so far {time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    ep = phase_ep(torch, smi)
    runs.append(ep["launches"])
    log(f"[timing] expert-parallel phase: {time.perf_counter() - t0:.1f} s "
        f"(run so far {time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    tp = phase_tp(torch, smi)
    runs.append(tp["launches"])
    log(f"[summary] {TP_BF16_ARCH} bf16, {TP_BF16_LAYERS} layers, over a "
        f"(data 1, model 4) mesh of {EP_WORLD} processes on the card: "
        f"prefill {tp['tokens_per_s']:.0f} tokens/s against the single "
        f"process's {tp['single_tokens_per_s']:.0f}; {smi}")
    log(f"[timing] tensor-parallel phase: {time.perf_counter() - t0:.1f} s "
        f"(run so far {time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    mesh_train = phase_mesh_train(torch, smi, train)
    runs.append(mesh_train["launches"])
    log(f"[summary] {MOE_ARCH} training at full width, {TRAIN_LAYERS} "
        f"layers, over a (data {MT_A_MESH[0]}, model {MT_A_MESH[1]}) mesh of "
        f"{EP_WORLD} processes on the card: {mesh_train['step_ms']:.1f} "
        f"ms/step, {mesh_train['tokens_per_s']:.0f} tokens/s against the "
        f"single process's {train['step_ms']:.1f} ms/step; {smi}")
    log(f"[timing] training over the mesh: {time.perf_counter() - t0:.1f} s "
        f"(run so far {time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    fsdp = phase_fsdp(torch, smi, train, mesh_train)
    runs.append(fsdp["launches"])
    log(f"[summary] {MOE_ARCH} training at full width, {FSDP_B_LAYERS} "
        f"layers, FSDP over a (data {FSDP_B_MESH[0]}, model "
        f"{FSDP_B_MESH[1]}) mesh of {EP_WORLD} processes on the card: "
        f"{fsdp['b_step_ms']:.1f} ms at its slowest step; {smi}")
    log(f"[timing] FSDP phase: {time.perf_counter() - t0:.1f} s (run so far "
        f"{time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    hybrid_tp = phase_hybrid_tp(torch, smi)
    runs.append(hybrid_tp["launches"])
    log(f"[summary] {HYBRID_ARCH} bf16, one group of 8 layers at "
        f"{TPH_CUTS['n_experts']} experts, over a (data {EP_MESH[0]}, model "
        f"{EP_MESH[1]}) mesh of {EP_WORLD} processes on the card: prefill "
        f"{hybrid_tp['tokens_per_s']:.0f} tokens/s against the single "
        f"process's {hybrid_tp['single_tokens_per_s']:.0f}; {smi}")
    log(f"[timing] hybrid tensor-parallel phase: "
        f"{time.perf_counter() - t0:.1f} s (run so far "
        f"{time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    kv_seq = phase_kv_seq(torch, smi)
    runs.append(kv_seq["launches"])
    log(f"[summary] {TP_BF16_ARCH} bf16, {TP_BF16_LAYERS} layers, decode "
        f"over a sequence-sharded cache on a (data {KVS_MESH[0]}, model "
        f"{KVS_MESH[1]}) mesh of {KVS_WORLD} processes on the card: a paged "
        f"step {kv_seq['step_ms']:.1f} ms against the single process's "
        f"{kv_seq['single_ms']:.1f} ms; {smi}")
    log(f"[summary] {ARCH} bf16, {QDIM_LAYERS} layers, a q_dim block "
        f"inside a head over the same mesh: prefill B=1 S={QDIM_SEQ} "
        f"{kv_seq['qdim_prefill_ms']:.1f} ms against the single process's "
        f"{kv_seq['qdim_single_ms']:.1f} ms; {smi}")
    log(f"[timing] sequence-sharded decode and q_dim split phases: "
        f"{time.perf_counter() - t0:.1f} s (run so far "
        f"{time.perf_counter() - start:.1f} s)")
    launches = {name: sum(run[name] for run in runs) for name in runs[0]}
    log(f"[main path] launches over phases 3-18, the training phases and "
        f"the expert-parallel, tensor-parallel, mesh-training, FSDP, "
        f"hybrid tensor-parallel, sequence-sharded and q_dim split phases' "
        f"ranks: "
        f"{json.dumps(launches)}")
    t0 = time.perf_counter()
    rel = phase_relational_kernels(torch)
    q1 = phase_q1(torch, smi, rel)
    log(f"[timing] relational phase: {time.perf_counter() - t0:.1f} s (run "
        f"so far {time.perf_counter() - start:.1f} s)")
    t0 = time.perf_counter()
    relational = [q1, phase_workers_q1(torch, smi, q1),
                  phase_entry_points(torch, smi),
                  phase_service(torch, smi, q1), phase_tools(torch, smi)]
    rel_launches = {name: sum(r["launches"][name] for r in relational)
                    for name in ("expr_core", "segment_reduce")}
    log(f"[main path] relational launches over phases 19-23 (local Q1 x"
        f"{Q1_TIMED}, the workers' Q1 runs, the entry points, the "
        f"service's cold Q1, the tools): {json.dumps(rel_launches)}")
    log(f"[timing] workers, service and tools phases: "
        f"{time.perf_counter() - t0:.1f} s (run so far "
        f"{time.perf_counter() - start:.1f} s)")
    flash, moe, ssm = kernel["prefill"], gather["prefill"], scan["prefill"]
    decode = paged["decode"]
    line = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches["flash_attention"],
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]}, {
        "name": "moe_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gather.cu",
        "replaces": "src/repro/kernels/moe_dispatch.py:37",
        "launches": launches["moe_gather"],
        "max_abs_err": max(c["max_abs_err"] for c in gather.values()),
        "ms": moe["ms"], "plain_ms": moe["plain_ms"],
        "bound_ms": moe["bound_ms"], "bound_by": moe["bound_by"],
        "library_ms": moe["library_ms"]}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:43",
        "launches": launches["ssm_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in scan.values()),
        "ms": ssm["ms"], "plain_ms": ssm["plain_ms"],
        "bound_ms": ssm["bound_ms"], "bound_by": ssm["bound_by"],
        "library_ms": None}, {
        "name": "moe_gather_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gather.cu",
        "replaces": "src/repro/models/moe.py:116",
        "launches": launches["moe_gather_bwd"],
        "max_abs_err": max(c["max_abs_err"] for c in gather_bwd.values()),
        **{k: gather_bwd["train"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/models/ssm.py:84",
        "launches": launches["ssm_scan_bwd"],
        "max_abs_err": max(c["max_abs_err"] for c in scan_bwd.values()),
        **{k: scan_bwd["jamba"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:65",
        "launches": launches["paged_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in paged.values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"]}, {
        "name": "paged_attention_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:65",
        "launches": launches["paged_attention_partial"],
        "max_abs_err": max(c["max_abs_err"] for c in partial.values()),
        **{k: partial["shard"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "launches": rel_launches[name], **q1[name]}
        for name, replaces in (
            ("expr_core", "src/repro/core/exprc.py:490"),
            ("segment_reduce", "src/repro/core/relops.py:562"))]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
