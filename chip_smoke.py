#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
final line:

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 off for matmul and cuDNN;
2. the hand-written flash-attention kernel, built from the checkout's
   source, against its plain PyTorch version on the card (full-width
   prefill shape, ragged causal, non-causal T != S, float32), with its
   time, the plain version's, SDPA's (the library yardstick, never used
   by the port) and the bound;
3. prefill at full width: qwen2.5-32b, all 64 layers, bf16 random weights
   drawn on the card from a seed, B=1, S=4096, through the kernel (one
   launch per layer), checked against the plain attention path, and the
   serving decode path checked against prefill on the same weights;
4. serving at full width through ``serve_batch``: 8 requests, batch 4,
   greedy, every request finished and every KV page released.

The last two lines are a JSON object with one entry per ported kernel and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

ARCH = "qwen25_32b"
DEVICE = "cuda"
SEED = 0
PREFILL_SEQ = 4096
KERNEL_CASES = [  # (name, B, S, T, H, K, hd, causal, dtype)
    ("prefill", 1, PREFILL_SEQ, PREFILL_SEQ, 40, 8, 128, True, "bfloat16"),
    ("ragged", 1, 1000, 1000, 40, 8, 128, True, "bfloat16"),
    ("cross", 2, 512, 1536, 40, 8, 128, False, "bfloat16"),
    ("f32", 1, 1024, 1024, 8, 2, 128, True, "float32"),
]
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: no tensor cores
PEAK_BYTES = 3.35e12
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
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


def rel_err(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def device_breakdown(torch, fn, wall_s: float, label: str,
                     top: int = 6) -> None:
    """Run fn once under torch.profiler and print the kernels' device time
    against ``wall_s`` (the same work timed without the profiler): the
    device's busy share, and the kernels that take most of it."""
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
    from repro_torch.kernels import flash_attention as fa
    return fa._nvcc()


# ---------------------------------------------------------------- phase 2
def phase_kernel(torch) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    t0 = time.perf_counter()
    fa.build()
    log(f"[kernel] built {os.path.relpath(fa.SOURCE, ROOT)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for path in sorted(fa.BUILD_DIR.glob("*.log")):
        for line in path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[kernel] ptxas: {line.strip()}")

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
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa (library_ms) {lib_ms:.4f} ms, bound {bound:.4f} ms by "
            f"{bound_by} "
            f"(roofline share {bound / ms:.1%})")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    log(f"[kernel] kernels: {json.dumps(ops.launch_counts())}")
    return results


# ---------------------------------------------------------------- phase 3
def phase_prefill(torch) -> int:
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import Ctx, build_model

    torch.cuda.reset_peak_memory_stats()
    model = build_model(ARCH)
    cfg = model.cfg
    t0 = time.perf_counter()
    model.init_params(torch.Generator(DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[prefill] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {model.param_count():,} parameters in "
        f"{model.dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"(no depth cut)")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, PREFILL_SEQ))).to(DEVICE)
    batch = {"tokens": tokens}

    ops.reset_launch_counts()
    flash, _ = model.forward(batch, Ctx(use_flash=True), last_only=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_attention"]
    log(f"[prefill] flash launches in one forward: {launches}")
    if launches != cfg.n_layers:
        raise AssertionError(f"expected {cfg.n_layers} flash launches, got "
                             f"{launches}")
    if flash.shape != (1, 1, cfg.padded_vocab) or \
            not torch.isfinite(flash[..., :cfg.vocab_size]).all():
        raise AssertionError(f"bad prefill logits {tuple(flash.shape)}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(batch, Ctx(use_flash=True), last_only=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_s = sorted(times)[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _ = model.forward(batch, Ctx(use_flash=False), last_only=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = rel_err(torch, flash[..., :cfg.vocab_size],
                  plain[..., :cfg.vocab_size])
    same_top = int(flash.argmax()) == int(plain.argmax())
    log(f"[prefill] flash vs plain attention path, last-position logits: "
        f"max|diff|/max|plain| = {err:.3g} (tol {LOGITS_TOL}); same argmax: "
        f"{same_top}")
    if not err <= LOGITS_TOL:
        raise AssertionError("flash prefill disagrees with the plain path")
    log(f"[prefill] B=1 S={PREFILL_SEQ}: {prefill_s * 1e3:.1f} ms median of "
        f"3 ({sorted(t * 1e3 for t in times)} ms), "
        f"{PREFILL_SEQ / prefill_s:.0f} tokens/s; plain attention path "
        f"{plain_s * 1e3:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # serving path vs prefill on the same weights: teacher-forced decode
    n = 8
    ref, _ = model.forward({"tokens": tokens[:, :n]}, Ctx())
    state = model.init_decode_state(1, 16)
    worst = 0.0
    for t in range(n):
        step, state = model.decode_step(tokens[:, t:t + 1], state)
        worst = max(worst, rel_err(torch, step[..., :cfg.vocab_size],
                                   ref[:, t:t + 1, :cfg.vocab_size]))
    log(f"[prefill] decode vs prefill logits over {n} teacher-forced tokens: "
        f"max|diff|/max|prefill| = {worst:.3g} (tol {LOGITS_TOL})")
    if not worst <= LOGITS_TOL:
        raise AssertionError("decode path disagrees with prefill")
    device_breakdown(torch, lambda: model.forward(
        batch, Ctx(use_flash=True), last_only=True), prefill_s, "prefill")
    token = tokens[:, :1].expand(4, 1).contiguous()
    state = model.init_decode_state(4, 48)
    steps = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = model.decode_step(token, state)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    device_breakdown(torch, lambda: model.decode_step(token, state),
                     sorted(steps)[1], "decode step, batch 4")
    del model, flash, plain, ref, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 4
def phase_serving(torch) -> None:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_batch(ARCH, n_requests=8, max_new=32, batch_size=4,
                      reduced=False, seed=SEED, device=DEVICE)
    tps = out["tokens"] / out["seconds"]
    log(f"[serve] {out['finished']}/8 requests finished, {out['tokens']} "
        f"tokens in {out['iters']} decode steps, {out['seconds']:.2f} s: "
        f"{tps:.1f} tokens/s, {out['seconds'] / out['iters'] * 1e3:.1f} "
        f"ms/step at batch 4; KV pages in use {out['pages_in_use']}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash "
        f"launches {ops.launch_counts()['flash_attention']} (decode reads "
        f"the dense cache in plain torch)")
    if out["finished"] != 8 or out["pages_in_use"] != 0:
        raise AssertionError(f"serving did not complete: {out}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    smi = phase_environment(torch)
    kernel = phase_kernel(torch)
    launches = phase_prefill(torch)
    phase_serving(torch)
    full = kernel["prefill"]
    line = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches, "max_abs_err": full["max_abs_err"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"]}]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
