"""Time this tree's flash attention kernel against another tree's, on one
CUDA card, in one process, at the prefill shapes of the reference's
configs.

    PYTHONPATH=src python -m repro_torch.launch.flash_compare \\
        --other PATH_TO_OTHER_CHECKOUT

``--other`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive``); its
``src/repro_torch/kernels/flash_attention.py`` is loaded as a module of
its own and builds its own source. Each case is checked on both kernels
against the plain version (``ref.attention_ref``, 2e-2 in bf16), then
timed with CUDA events (the mean of 20 launches) in turns: other, this,
this, other, twice; beside one SDPA call and the bound (4*hd operations per
visible pair and head at 989 TFLOP/s, or the bytes of q, k, v, o at 3.35
TB/s). A case whose head dim the other kernel does not take is timed on
this one only. Prints one line per case, the card's name and power limit,
and a JSON object of the numbers as the last line. The loader and the
turns are ``kernel_compare``'s.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch.kernel_compare import events_ms, load_other, turns

__all__ = ["CASES", "bound_ms", "main"]

# (name, B, S, T, H, K, hd, causal): qwen2.5-32b, qwen2-moe, phi3-mini,
# nemotron-4-340b and gemma-7b at prefill, S = T = 4096
CASES = [
    ("prefill", 1, 4096, 4096, 40, 8, 128, True),
    ("moe_prefill", 1, 4096, 4096, 16, 16, 128, True),
    ("prefill_hd96", 1, 4096, 4096, 32, 32, 96, True),
    ("prefill_hd192", 1, 4096, 4096, 96, 8, 192, True),
    ("prefill_hd256", 1, 4096, 4096, 16, 16, 256, True),
]
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, bf16 dense
REPS, ROUNDS = 20, 2


def bound_ms(B, S, T, H, K, hd, causal, elem=2) -> tuple:
    pairs = (sum(min(i + 1, T) for i in range(S)) if causal else S * T)
    t_ops = 4.0 * hd * pairs * B * H / PEAK_FLOPS
    t_bytes = elem * (2 * B * S * H * hd + 2 * B * T * K * hd) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 2
    other = load_other(args.other.resolve(), "flash_attention")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    results = {}
    for name, B, S, T, H, K, hd, causal in CASES:
        def mk(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to("cuda", torch.bfloat16)

        q, k, v = mk(B, S, H, hd), mk(B, T, K, hd), mk(B, T, K, hd)
        want = attention_ref(q, k, v, causal=causal).float()
        kernels = {"this": fa}
        if hd in other.HEAD_DIMS:
            kernels["other"] = other
        errs = {}
        for who, mod in kernels.items():
            out = mod.flash_attention_fwd(q, k, v, causal=causal).float()
            errs[who] = float((out - want).abs().max())
            if not (out - want).abs().le(2e-2 + 2e-2 * want.abs()).all():
                raise AssertionError(f"{name}: {who} kernel off by "
                                     f"{errs[who]:.3g}")
        del want, out
        order = (["other", "this", "this", "other"] if "other" in kernels
                 else ["this", "this"])
        times = turns({who: (lambda mod=mod: mod.flash_attention_fwd(
            q, k, v, causal=causal)) for who, mod in kernels.items()},
            order, REPS, ROUNDS)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = events_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), REPS)
        bound, by = bound_ms(B, S, T, H, K, hd, causal)
        results[name] = {"shape": [B, S, T, H, K, hd, causal],
                         "this_ms": times["this"],
                         "other_ms": times.get("other"),
                         "sdpa_ms": sdpa, "bound_ms": bound, "bound_by": by,
                         "max_abs_err": errs}
        best = min(times["this"])
        print(f"[flash_compare] {name}: B={B} S={S} T={T} H={H} K={K} "
              f"hd={hd} causal={causal}: this {times['this']} ms, other "
              f"{times.get('other', 'not taken')} ms, sdpa {sdpa:.4f} ms, "
              f"bound {bound:.4f} ms by {by} (this at {bound / best:.1%} "
              f"of it); max|err| {errs}", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": smi, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
