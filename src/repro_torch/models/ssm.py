"""Mamba selective-SSM block for the jamba hybrid family (port of
``repro.models.ssm``).

The full-sequence pass runs the recurrence through ``kernels.ops.ssm_scan``:
the hand-written CUDA kernel for tensors on a card, its plain sequential
version on the CPU. The reference runs the same recurrence as a chunked
associative scan in plain XLA, so the two round in another order (the
CPU tests hold them at 1e-4). Decode is the one-step recurrence in plain
torch, as in the reference.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.context import Ctx
from repro_torch.models.params import ParamDef

__all__ = ["mamba_defs", "mamba_apply", "mamba_decode_step", "MambaState",
           "mamba_init_state", "dt_rank"]


def dt_rank(cfg: ArchConfig) -> int:
    return max(16, cfg.d_model // 16)


class MambaState(NamedTuple):
    h: torch.Tensor  # (B, di, N) SSM state, float32
    conv: torch.Tensor  # (B, d_conv-1, di) rolling conv window


def mamba_defs(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.d_state
    R = dt_rank(cfg)
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    return {
        "in_proj": ParamDef((*lead, d, 2 * di), (*la, "embed", "inner")),
        "conv_w": ParamDef((*lead, cfg.d_conv, di), (*la, None, "inner"),
                           init="small"),
        "conv_b": ParamDef((*lead, di), (*la, "inner"), init="zeros"),
        "x_proj": ParamDef((*lead, di, R + 2 * N), (*la, "inner", None)),
        "dt_proj": ParamDef((*lead, R, di), (*la, None, "inner"),
                            init="small"),
        "dt_bias": ParamDef((*lead, di), (*la, "inner"), init="zeros"),
        "A_log": ParamDef((*lead, di, N), (*la, "inner", None), init="small"),
        "D": ParamDef((*lead, di), (*la, "inner"), init="ones"),
        "out_proj": ParamDef((*lead, di, d), (*la, "inner", "embed")),
    }


def _ssm_inputs(cfg: ArchConfig, p: Dict, xb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """xb: (..., di) conv output -> (dt, B, C, A) in float32. B and C are
    column views of the x_proj output (not copied)."""
    N = cfg.d_state
    R = dt_rank(cfg)
    proj = (xb @ p["x_proj"]).float()
    dt_low, Bc, Cc = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = F.softplus(dt_low @ p["dt_proj"].float()
                    + p["dt_bias"].float())  # (..., di)
    A = -torch.exp(p["A_log"].float())  # (di, N)
    return dt, Bc, Cc, A


def _causal_conv(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time, in x's dtype. x: (B, L, di)."""
    K = cfg.d_conv
    if window is None:
        window = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([window, x], dim=1)
    L = x.shape[1]
    out = xp[:, 0:L] * p["conv_w"][0]
    for i in range(1, K):
        out = out + xp[:, i:i + L] * p["conv_w"][i]
    return F.silu(out + p["conv_b"])


def mamba_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor, ctx: Ctx
                ) -> torch.Tensor:
    """Full-sequence (prefill) pass. x: (B, L, d)."""
    di = cfg.ssm_expand * x.shape[-1]
    xz = x @ p["in_proj"]
    xb, z = xz[..., :di], xz[..., di:]
    xb = _causal_conv(cfg, p, ctx.constrain(xb, "batch", None, "inner"))
    dt, Bc, Cc, A = _ssm_inputs(cfg, p, xb)
    xf = xb.float()
    y = kops.ssm_scan(dt, A, Bc, Cc, xf)
    y = y + xf * p["D"].float()
    return (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]


def mamba_init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device, layers: int) -> MambaState:
    """Zero states for ``layers`` Mamba layers, stacked: h (layers, B, di,
    N) float32, conv (layers, B, d_conv-1, di) in ``dtype``."""
    di = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros((layers, batch, di, cfg.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((layers, batch, cfg.d_conv - 1, di), dtype=dtype,
                         device=device))


def mamba_decode_step(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
                      state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrence. x_t: (B, 1, d); state holds one layer's
    h (B, di, N) and conv (B, d_conv-1, di). Returns (y, new state)."""
    di = cfg.ssm_expand * cfg.d_model
    xz = x_t @ p["in_proj"]
    xb, z = xz[..., :di], xz[..., di:]
    window = torch.cat([state.conv, xb], dim=1)  # (B, K, di)
    conv = window[:, 0] * p["conv_w"][0]
    for i in range(1, cfg.d_conv):
        conv = conv + window[:, i] * p["conv_w"][i]
    xb1 = F.silu(conv + p["conv_b"])[:, None]  # (B, 1, di)
    dt, Bc, Cc, A = _ssm_inputs(cfg, p, xb1)
    a = torch.exp(dt[..., None] * A)[:, 0]  # (B, di, N)
    b = ((dt * xb1.float())[..., None] * Bc[..., None, :])[:, 0]
    h = a * state.h + b
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
    y = y + xb1.float() * p["D"].float()
    y = (y.to(x_t.dtype) * F.silu(z)) @ p["out_proj"]
    return y, MambaState(h=h, conv=window[:, 1:])
