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
9-18. the other families, every published width and full depth, bf16
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
   refused, as the reference has neither for it); xlstm-125m (12 blocks,
   no attention and no kernel: the sLSTM's 4,096 sequential steps a
   layer, the profiler's breakdown over the first 512 tokens; decode over
   the recurrent state against prefill, held in float32; no paged pool). Then one summary line per model: prefill tokens/s, the dense
   decode step's ms and busy share, serving tokens/s, peak memory, beside
   the card's name and power limit.

Launch counts are set to 0 just before each main-path run of phases 3-18
(prefill, paged decode, paged serving, the long-context step, serving)
and read just after it. The last two lines are a JSON object with one
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
# the other model families, every published width and full depth, after
# the three above: (registry name, label)
OTHER_ARCHS = [("gemma_7b", "gemma"), ("phi3_mini", "phi3"),
               ("internvl2_26b", "vlm"), ("whisper_small", "audio"),
               ("xlstm_125m", "ssm")]
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
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
    """[(kernel, registers, spill bytes)] for each entry function of an
    nvcc build log (``-Xptxas -v``)."""
    out, fn, spill = [], None, 0
    for line in open(log_path).read().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = kernel_name(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
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

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as mg
    from repro_torch.kernels import nvcc, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import attention_ref

    t0 = time.perf_counter()
    modules = (fa, mg, ss, pa)
    libs = nvcc.compile_all([m.SOURCE for m in modules])
    for m in modules:
        m.build()
    names = ", ".join(os.path.relpath(m.SOURCE, ROOT) for m in modules)
    log(f"[kernel] built {names} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for lib in libs:
        for fn, regs, spill in ptxas_report(lib.with_suffix(".log")):
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
        spills = [(fn, spill) for fn, _, spill in ptxas_report(
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
                "ssm_scan": cfg.n_layers - n_attn}
    return {"flash_attention": n_attn, "paged_attention": 0,
            "moe_gather": cfg.n_layers if cfg.is_moe else 0, "ssm_scan": 0}


def decode_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` decode steps over the paged
    pool: paged_attention per attention layer, moe_gather per MoE layer."""
    moe = expected_launches(cfg)["moe_gather"]
    return {"flash_attention": 0, "paged_attention":
            n_attention_layers(cfg) * steps, "moe_gather": moe * steps,
            "ssm_scan": 0}


def hybrid_config():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(HYBRID_ARCH), **HYBRID_CUTS)


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
            "moe_gather": layers * out["iters"], "ssm_scan": 0}
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
        (name, f"{label} ", False) for name, label in OTHER_ARCHS]
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
        "library_ms": decode["library_ms"]}]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
