"""Mamba selective-SSM block for the jamba hybrid family (port of
``repro.models.ssm``).

The full-sequence pass runs the recurrence through ``kernels.ops.ssm_scan``:
the hand-written CUDA kernel for tensors on a card, its plain sequential
version on the CPU. The reference runs the same recurrence as a chunked
associative scan in plain XLA, so the two round in another order (the
CPU tests hold them at 1e-4). Decode is the one-step recurrence in plain
torch, as in the reference.

On a rank of a mesh (``Ctx.tp`` > 1) the block computes with the slices
of ``inner`` that ``Model.param_specs`` places over the model axis: w =
di/tp channels, the width read from the leaves (``D``), never from the
residual stream, which is whole. ``x`` enters through ``layers.to_model``;
the rank's block of ``in_proj`` gives it 2w contiguous columns of the
2·di, which ``collectives.inner_halves`` hands round so that the rank
holds its w channels of both ``xb`` and ``z``. The causal conv, ``dt``,
``A``, ``D`` and the scan (P4) are per channel and run on the rank's;
``x_proj``'s rows are split, so its partial product is summed over the
model axis in float32 (``model_sum``) and enters the channels again
through ``to_model``; ``out_proj``'s partials end in ``model_sum``. A
rank's decode state holds ``h`` at its w channels and the conv window
whole (``decode_state_specs`` keeps it whole: its dim 2 is d_conv - 1):
the rank convolves its channels of it, and the new column is
all-gathered over the model axis, so that every rank's window is the
same.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.models.context import Ctx
from repro_torch.models.layers import held_split, model_sum, to_model
from repro_torch.models.params import ParamDef

__all__ = ["mamba_defs", "mamba_apply", "mamba_decode_step", "MambaState",
           "mamba_init_state", "dt_rank"]


def dt_rank(cfg: ArchConfig) -> int:
    return max(16, cfg.d_model // 16)


class MambaState(NamedTuple):
    h: torch.Tensor  # (B, di, N) SSM state, float32 (a rank: its channels)
    conv: torch.Tensor  # (B, d_conv-1, di) rolling conv window, whole


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


def _ssm_inputs(cfg: ArchConfig, p: Dict, xb: torch.Tensor,
                ctx: Optional[Ctx] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """xb: (..., di) conv output -> (dt, B, C, A) in float32. B and C are
    column views of the x_proj output (not copied). With ``ctx`` (the
    rank's channels of a split ``inner``) the rank's partial product is
    summed over the model axis in float32."""
    N = cfg.d_state
    R = dt_rank(cfg)
    proj = (xb @ p["x_proj"]).float()
    if ctx is not None:
        proj = to_model(model_sum(proj, ctx), ctx)
    dt_low, Bc, Cc = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = F.softplus(dt_low @ p["dt_proj"].float()
                    + p["dt_bias"].float())  # (..., di)
    A = -torch.exp(p["A_log"].float())  # (di, N)
    return dt, Bc, Cc, A


def _split(cfg: ArchConfig, p: Dict, ctx: Optional[Ctx]) -> bool:
    """Whether ``p`` holds this rank's channels of a split ``inner``
    (``held_split`` of ``D``) rather than all of them; an ``in_proj``
    block that is not twice the rank's channels raises ValueError."""
    w = p["D"].shape[-1]
    split = held_split(w, cfg.ssm_expand * cfg.d_model, ctx)
    if p["in_proj"].shape[-1] != 2 * w:
        raise ValueError(
            f"{cfg.name}: an in_proj block of {p['in_proj'].shape[-1]} "
            f"columns beside {w} channels of D: a rank holds 2·di/tp "
            f"columns of in_proj where it holds di/tp channels")
    return split


def _project_in(p: Dict, x: torch.Tensor, ctx: Optional[Ctx], split: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xb, z), each (..., w) over the channels that ``p`` holds."""
    if split:
        xz = coll.inner_halves(to_model(x, ctx) @ p["in_proj"],
                               ctx.tp_group)
    else:
        xz = x @ p["in_proj"]
    w = p["D"].shape[-1]
    return xz[..., :w], xz[..., w:]


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
    """Full-sequence (prefill) pass. x: (B, L, d), whole on every rank."""
    split = _split(cfg, p, ctx)
    xb, z = _project_in(p, x, ctx, split)
    xb = _causal_conv(cfg, p, ctx.constrain(xb, "batch", None, "inner"))
    dt, Bc, Cc, A = _ssm_inputs(cfg, p, xb, ctx if split else None)
    xf = xb.float()
    y = kops.ssm_scan(dt, A, Bc, Cc, xf)
    y = y + xf * p["D"].float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return model_sum(y, ctx) if split else y


def mamba_init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device, layers: int, inner: Optional[int] = None
                     ) -> MambaState:
    """Zero states for ``layers`` Mamba layers, stacked: h (layers, B,
    inner, N) float32, ``inner`` the channels a rank holds (default all
    di), and conv (layers, B, d_conv-1, di) in ``dtype``, whole."""
    di = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros((layers, batch, inner or di, cfg.d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((layers, batch, cfg.d_conv - 1, di), dtype=dtype,
                         device=device))


def mamba_decode_step(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
                      state: MambaState, ctx: Optional[Ctx] = None
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrence. x_t: (B, 1, d); state holds one layer's
    h (B, w, N) over the channels that ``p`` holds and the whole conv
    window (B, d_conv-1, di). Returns (y, new state)."""
    split = _split(cfg, p, ctx)
    xb, z = _project_in(p, x_t, ctx, split)
    w = xb.shape[-1]
    if split:
        c0 = ctx.tp_index * w
        mine = state.conv[..., c0:c0 + w]
        column = coll.all_gather(xb, ctx.tp_group, dim=-1)  # (B, 1, di)
    else:
        mine, column = state.conv, xb
    window = torch.cat([mine, xb], dim=1)  # (B, K, w)
    conv = window[:, 0] * p["conv_w"][0]
    for i in range(1, cfg.d_conv):
        conv = conv + window[:, i] * p["conv_w"][i]
    xb1 = F.silu(conv + p["conv_b"])[:, None]  # (B, 1, w)
    dt, Bc, Cc, A = _ssm_inputs(cfg, p, xb1, ctx if split else None)
    a = torch.exp(dt[..., None] * A)[:, 0]  # (B, w, N)
    b = ((dt * xb1.float())[..., None] * Bc[..., None, :])[:, 0]
    h = a * state.h + b
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
    y = y + xb1.float() * p["D"].float()
    y = (y.to(x_t.dtype) * F.silu(z)) @ p["out_proj"]
    if split:
        y = model_sum(y, ctx)
    return y, MambaState(h=h, conv=torch.cat([state.conv[:, 1:], column],
                                             dim=1))
