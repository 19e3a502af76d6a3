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
   64), ragged causal, non-causal T != S, float32; SDPA as yardstick; the device's
   share of the kernel's time by the profiler; ptxas registers and spill
   bytes of every flash instance, and the wgmma/TMA instructions in its
   SASS) and moe_gather, bit for bit
   (qwen2-moe prefill and decode dispatch shapes, ragged float32, bf16
   rows that are not whole 16-byte words; ``index_select`` as yardstick;
   whether rows move in 16-byte words or elements, the device's share of
   the time by the profiler, one prefill call with x just written) and ssm_scan within 1e-5 (jamba's
   prefill shape and a ragged shape; no PyTorch call computes a selective
   scan, so no yardstick; the inputs copied for TMA; the scan kernels'
   SASS instruction and MUFU.EX2 counts; a spill in the scan or the
   gather fails the run) and paged_attention (the decode shapes of
   qwen2.5-32b, jamba, qwen2-moe and internvl2-26b (48/8), head dims 96,
   192 and 256 at the heads of phi3-mini, nemotron-4-340b and gemma-7b
   (gemma's also as the last layer's view of a 28-layer pool), a ragged
   float32 case
   with holes, and the long-context step's shape in bf16 and in float32
   with holes; the bf16 cases also row by row against the float32 answer;
   SDPA over a dense copy gathered beforehand as yardstick; the device's
   share of the kernel's time by the profiler);
3. dense prefill at full width: qwen2.5-32b, all 64 layers, bf16 random
   weights drawn on the card from a seed, B=1, S=4096, through the flash
   kernel (one launch per layer), checked against the plain attention
   path, and the serving decode path checked against prefill: over the
   dense cache, over the paged pool (page 4, through the paged kernel, one
   launch per layer and step) and over the int8 cache; then the
   continuous-batching engine over the paged pool (page 16): 8 requests,
   batch 4, one paged-attention launch per layer and decode step, every
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
   experts, so that its 66.3 GiB of bf16 weights fit one card; B=1,
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
   each way); then TPC-H Q1 at scale factor 10 (59,986,052 lineitems, 4
   partitions) through ``Session`` / ``q1_pricing_summary``: the numpy
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
20. the worker runtime: the same Q1 at SF 10 (phase 19's set and its
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
the timed Q1 runs, the workers', the entry points', the service's cold
Q1, the tools') and read just after it. The last two lines are a JSON object with one
entry per ported kernel and ``{"ok": true, "device": {...}}``. Without a
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
# One group at 16 experts is 84.3 GiB of bf16 weights; at 12, 66.3 GiB.
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
]
# moe_gather at qwen2-moe's dispatch shapes: T tokens of width d into
# S = 60 experts x capacity slots, T*top_k = n_kept of them filled.
GATHER_CASES = [  # (name, T, d, S, n_kept, dtype)
    ("prefill", PREFILL_SEQ, 2048, 60 * 344, 4 * PREFILL_SEQ, "bfloat16"),
    ("decode", 4, 2048, 60 * 8, 16, "bfloat16"),
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
]
SCAN_TOL = 1e-5  # as tests/test_kernels.py holds the Pallas scan
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
]
POOL_LAYERS = {"gemma_pool": 28}
PAGE_SIZE = 16  # paged serving: a 48-token sequence spans 3 pages
# the relational kernels launch nowhere on a model's path
NO_RELATIONAL = {"expr_core": 0, "segment_reduce": 0}
# phase 19, the relational engine: TPC-H Q1 at scale factor 10 (the spec's
# lineitem rows) over the executor's 4 partitions; K1's op x dtype matrix
# at the executor's batch of 8,192 rows; K2's cases (name, rows, groups)
Q1_ROWS = 59_986_052
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


def paged_bound_ms(lengths, tables, page, H, K, hd, dtype, elem):
    """(ms, "operations" | "bytes"): the K and V rows of every valid
    position read once (a row with no valid position reads V of each
    distinct page it gathers, for the reference's uniform mean), q read
    and the output written once; against 4*hd operations per (query head,
    valid position) (q.k and p.v)."""
    row = K * hd * elem  # bytes of one token's K (or V) row, all kv heads
    nbytes = 2 * len(lengths) * H * hd * elem
    positions = 0
    for length, ids in zip(lengths, tables):
        held = [j for j in range(min(-(-int(length) // page), len(ids)))
                if ids[j] >= 0]
        valid = sum(min(page, int(length) - j * page) for j in held)
        if valid:
            nbytes += 2 * valid * row
            positions += valid
        else:
            nbytes += len({max(int(i), 0) for i in ids}) * page * row
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 4.0 * hd * H * positions / PEAK_FLOPS[dtype]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_name(mangled: str) -> str:
    """``flash_fwd_bf16<128>`` from a kernel's mangled name (a
    length-prefixed name in an anonymous namespace, an int template
    argument); the mangled name where it is not of that form."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)(.*)", mangled)
    if not m:
        return mangled
    n, rest = int(m.group(1)), m.group(2)
    name, rest = rest[:n], rest[n:]
    arg = re.match(r"ILi(\d+)E", rest)
    return f"{name}<{arg.group(1)}>" if arg else name


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


def device_ms(torch, fn, reps: int, match: str) -> float:
    """Device time per call of the kernels whose name holds ``match``,
    over reps calls of fn under torch.profiler: the card's share of what
    ``cuda_ms`` times, without the host's launch path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and match in e.key)
    return total / 1e3 / reps


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
    for m, kernel in ((ss, "ssm_scan_kernel"), (mg, "moe_gather_rows")):
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
            f"kernel {ms:.4f} ms by events ({dev_ms:.4f} ms of it on the "
            f"device, {dev_ms / ms:.1%}), plain {plain_ms:.3f} ms, "
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
        if name == "prefill":  # one call, x just written, as in the model
            x_copy = x.clone()
            flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)

            def written():
                flush.zero_()
                x.copy_(x_copy)

            one = single_call_ms(
                torch, lambda: ops.moe_gather(x, ids, keep), written)
            one_lib = single_call_ms(
                torch, lambda: torch.index_select(x, 0, lib_ids), written)
            log(f"[gather] {name}: one call with x just written (L2 "
                f"flushed, then x copied in): kernel {one:.4f} ms "
                f"({bound / one:.1%} of the bound), index_select "
                f"{one_lib:.4f} ms")
            del x_copy, flush
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by)
        log(f"[gather] {name}: T={T} d={d} S={S} kept {n_kept} ({rows} "
            f"distinct rows) {dtype}: bit-equal, max|err| {err:.3g}; "
            f"copied in {words}: kernel {ms:.4f} ms by events ({dev_ms:.4f} "
            f"ms of it on the device, {dev_ms / ms:.1%}), plain "
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
            f"by events ({dev_ms:.4f} ms of it on the device), plain "
            f"{plain_ms:.3f} ms, sdpa over the pre-gathered dense copy "
            f"(library_ms; gather not timed) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms by {bound_by} (roofline share "
            f"{bound / ms:.1%})")
        del q, k_pages, v_pages, pools, args, out, want, diff, kd, vd, mask
        torch.cuda.empty_cache()
    log(f"[paged] kernels: {json.dumps(ops.launch_counts())}")
    return results


# ------------------------------------------------------ phases 3, 5, 7
@contextlib.contextmanager
def kept_slots(ops, record: list):
    """Record the kept-slot count of every moe_gather dispatch, a device
    scalar each (no host sync), summed after the run."""
    real = ops.moe_gather

    def recording(x, token_ids, keep):
        record.append(keep.sum())
        return real(x, token_ids, keep)

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
                "ssm_scan": cfg.n_layers - n_attn, **NO_RELATIONAL}
    return {"flash_attention": n_attn, "paged_attention": 0,
            "moe_gather": cfg.n_layers if cfg.is_moe else 0, "ssm_scan": 0,
            **NO_RELATIONAL}


def decode_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` decode steps over the paged
    pool: paged_attention per attention layer, moe_gather per MoE layer."""
    moe = expected_launches(cfg)["moe_gather"]
    return {"flash_attention": 0, "paged_attention":
            n_attention_layers(cfg) * steps, "moe_gather": moe * steps,
            "ssm_scan": 0, **NO_RELATIONAL}


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

    kept = []
    copies = ss.COPIES.count
    ops.reset_launch_counts()
    with kept_slots(ops, kept):
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
        per_layer = PREFILL_SEQ * cfg.top_k - torch.stack(kept).cpu()
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
    requests of the dense serving phase, batch 4, max_seq 48, page 16.
    Returns its result and launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_model
    cfg = model.cfg
    ops.reset_launch_counts()
    out = serve_model(model, n_requests=8, max_new=32, batch_size=4,
                      seed=SEED, kv_layout="paged", page_size=PAGE_SIZE)
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
    out = serve_batch(arch, n_requests=8, max_new=32, batch_size=4,
                      reduced=False, seed=SEED, device=DEVICE)
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
            **NO_RELATIONAL}
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
                on_device = device_ms(torch, call, 3, "")
                log(f"[relational] segment_reduce {name} ({rows:,} rows, "
                    f"{groups:,} groups, {len(vals)} columns, sums): "
                    f"{k2_ms[name]:.3f} ms by events, {on_device:.3f} ms "
                    f"on the device; {probes['smi']}")
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
    """TPC-H Q1 at scale factor 10 through the Session API: the numpy
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
    """Phase 20: TPC-H Q1 at SF 10 (phase 19's lineitem set, no cut) over
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
    cold Q1 at SF 10 ships the shards (SETUP bytes), then SERVICE_CLIENTS
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
        f"SF 10 cold {cold_s:.2f} s ({cold_setup:,} SETUP bytes); then "
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
    paged = phase_paged(torch)
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
    launches = {name: sum(run[name] for run in runs) for name in runs[0]}
    log(f"[main path] launches over phases 3-18: {json.dumps(launches)}")
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
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:65",
        "launches": launches["paged_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in paged.values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"]}] + [{
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
