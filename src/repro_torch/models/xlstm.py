"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential recurrence), per arXiv:2405.04517 (port of
``repro.models.xlstm``).

The mLSTM full-sequence pass is the exact chunkwise-parallel form: within
a chunk of ``MLSTM_CHUNK`` steps the decay matrix D_ts = F_t - F_s + i_s
(s <= t, -inf above the diagonal) weighs an attention-like product, with
a log-space stabiliser ``m``; across chunks a (dk, dv) state, its
normaliser and stabiliser are carried in a loop over the chunks. The
sLSTM has recurrent gate inputs, so its full-sequence pass is a loop over
time, as the reference's ``lax.scan`` is. Decode is one step of each.
Every gate and state computation is float32, in the reference's order.
Nothing here reaches a Pallas kernel: it is plain PyTorch on the card too.

Decode states are stacked over the layers of their kind (``layers``
leading), as ``transformer.init_decode_state`` keeps them; the decode
steps take one layer's views and return new tensors.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.context import Ctx
from repro_torch.models.params import ParamDef

__all__ = ["mlstm_defs", "mlstm_apply", "mlstm_init_state",
           "mlstm_decode_step", "MLSTMState", "slstm_defs", "slstm_apply",
           "slstm_init_state", "slstm_decode_step", "SLSTMState"]

MLSTM_CHUNK = 64


# ===================================================================== mLSTM
class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, dk, dv) float32
    n: torch.Tensor  # (B, H, dk) float32
    m: torch.Tensor  # (B, H) float32
    conv: torch.Tensor  # (B, d_conv-1, di) rolling conv window


def mlstm_defs(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    d = cfg.d_model
    di = 2 * d
    H = cfg.n_heads
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    return {
        "up_proj": ParamDef((*lead, d, 2 * di), (*la, "embed", "inner")),
        "conv_w": ParamDef((*lead, cfg.d_conv, di), (*la, None, "inner"),
                           init="small"),
        "conv_b": ParamDef((*lead, di), (*la, "inner"), init="zeros"),
        "wq": ParamDef((*lead, di, di), (*la, "inner", None)),
        "wk": ParamDef((*lead, di, di), (*la, "inner", None)),
        "wv": ParamDef((*lead, di, di), (*la, "inner", None)),
        "w_i": ParamDef((*lead, di, H), (*la, "inner", None), init="small"),
        "w_f": ParamDef((*lead, di, H), (*la, "inner", None), init="small"),
        "b_i": ParamDef((*lead, H), (*la, None), init="zeros"),
        "b_f": ParamDef((*lead, H), (*la, None), init="ones"),
        "ln_scale": ParamDef((*lead, di), (*la, "inner"), init="ones"),
        "skip": ParamDef((*lead, di), (*la, "inner"), init="ones"),
        "down_proj": ParamDef((*lead, di, d), (*la, "inner", "embed")),
    }


def _conv(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, L, di), zero history, then silu."""
    K = cfg.d_conv
    pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    L = x.shape[1]
    out = sum(xp[:, i:i + L] * p["conv_w"][i] for i in range(K))
    return F.silu(out + p["conv_b"])


def _headify(x: torch.Tensor, H: int) -> torch.Tensor:
    B, L, di = x.shape
    return x.reshape(B, L, H, di // H).transpose(1, 2)  # (B, H, L, dh)


def _groupnorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head normalisation over the feature dim (the last)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def mlstm_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor, ctx: Ctx
                ) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d), from a zero state."""
    B, L, d = x.shape
    di = 2 * d
    H = cfg.n_heads
    dh = di // H
    up = x @ p["up_proj"]
    xb, z = up[..., :di], up[..., di:]
    xc = _conv(cfg, p, xb)
    q = _headify(xc @ p["wq"], H).float()
    k = _headify(xc @ p["wk"], H).float() / math.sqrt(dh)
    v = _headify(xb @ p["wv"], H).float()
    # per-head scalar gates from the pre-activation features
    li = (xb @ p["w_i"] + p["b_i"]).float()  # (B, L, H) log input gate
    lf = F.logsigmoid((xb @ p["w_f"] + p["b_f"]).float())

    c = min(MLSTM_CHUNK, L)
    n_chunks = -(-L // c)
    pad = n_chunks * c - L
    if pad:  # padded steps: no input (li = -1e30), no decay (lf = 0)
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad))
    Lp = n_chunks * c
    li = li.transpose(1, 2).reshape(B, H, n_chunks, c)
    lf = lf.transpose(1, 2).reshape(B, H, n_chunks, c)
    qc = q.reshape(B, H, n_chunks, c, dh)
    kc = k.reshape(B, H, n_chunks, c, dh)
    vc = v.reshape(B, H, n_chunks, c, dh)

    above = ~torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    hs = []
    for j in range(n_chunks):
        qb, kb, vb = qc[:, :, j], kc[:, :, j], vc[:, :, j]  # (B, H, c, dh)
        lib, lfb = li[:, :, j], lf[:, :, j]  # (B, H, c)
        Fcum = torch.cumsum(lfb, dim=-1)
        # intra-chunk decay D_ts = (F_t - F_s) + li_s for s <= t
        Dm = Fcum[..., :, None] - Fcum[..., None, :] + lib[..., None, :]
        Dm = Dm.masked_fill(above, -math.inf)
        # inter-chunk contribution decay: g_t = m + F_t
        inter_log = m[..., None] + Fcum
        m_new = torch.maximum(Dm.amax(-1), inter_log)  # the stabiliser
        intra_w = torch.exp(Dm - m_new[..., None])
        scores = torch.einsum("bhtd,bhsd->bhts", qb, kb) * intra_w
        inter = torch.exp(inter_log - m_new)
        num = (torch.einsum("bhts,bhsd->bhtd", scores, vb)
               + inter[..., None] * torch.einsum("bhtd,bhdv->bhtv", qb, C))
        den = scores.sum(-1) + inter * torch.einsum("bhtd,bhd->bht", qb, n)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_new))[..., None])
        # state update to the end of the chunk
        Fc = Fcum[..., -1]  # (B, H)
        m_state = torch.maximum(m + Fc, (Fc[..., None] - Fcum + lib).amax(-1))
        w_in = torch.exp(Fc[..., None] - Fcum + lib - m_state[..., None])
        decay = torch.exp(m + Fc - m_state)
        C = decay[..., None, None] * C + torch.einsum(
            "bhsd,bhsv->bhdv", w_in[..., None] * kb, vb)
        n = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", w_in, kb)
        m = m_state
    h = torch.stack(hs, dim=2).reshape(B, H, Lp, dh)[:, :, :L]
    h = _groupnorm(h).transpose(1, 2).reshape(B, L, di)
    h = h.to(x.dtype) * p["ln_scale"] + xc * p["skip"]
    return (h * F.silu(z)) @ p["down_proj"]


def mlstm_init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device, layers: int) -> MLSTMState:
    """Zero states for ``layers`` mLSTM layers, stacked: C, n, m float32,
    the conv window in ``dtype``."""
    di, H = 2 * cfg.d_model, cfg.n_heads
    dh = di // H

    def zeros(*shape, dt=torch.float32):
        return torch.zeros((layers, batch, *shape), dtype=dt, device=device)

    return MLSTMState(C=zeros(H, dh, dh), n=zeros(H, dh), m=zeros(H),
                      conv=zeros(cfg.d_conv - 1, di, dt=dtype))


def mlstm_decode_step(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
                      st: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """One step. x_t: (B, 1, d); st holds one layer's state. Returns
    (y (B, 1, d), new state)."""
    B = x_t.shape[0]
    di, H = 2 * cfg.d_model, cfg.n_heads
    dh = di // H
    up = x_t @ p["up_proj"]
    xb, z = up[..., :di], up[..., di:]
    window = torch.cat([st.conv, xb], dim=1)  # (B, d_conv, di)
    xc = F.silu(sum(window[:, i] * p["conv_w"][i]
                    for i in range(cfg.d_conv)) + p["conv_b"])[:, None]
    q = (xc @ p["wq"]).reshape(B, H, dh).float()
    k = (xc @ p["wk"]).reshape(B, H, dh).float() / math.sqrt(dh)
    v = (xb @ p["wv"]).reshape(B, H, dh).float()
    li = (xb @ p["w_i"] + p["b_i"])[:, 0].float()  # (B, H)
    # the reference takes log_sigmoid in the parameters' dtype here (and
    # in float32 in mlstm_apply)
    lf = F.logsigmoid(xb @ p["w_f"] + p["b_f"])[:, 0].float()
    m_new = torch.maximum(lf + st.m, li)
    fg = torch.exp(lf + st.m - m_new)[..., None]  # (B, H, 1)
    ig = torch.exp(li - m_new)[..., None]
    C = fg[..., None] * st.C + ig[..., None] * k[..., None] * v[..., None, :]
    n = fg * st.n + ig * k
    num = torch.einsum("bhd,bhdv->bhv", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    h = _groupnorm(h[:, :, None])[:, :, 0].reshape(B, 1, di)
    h = h.to(x_t.dtype) * p["ln_scale"] + xc * p["skip"]
    y = (h * F.silu(z)) @ p["down_proj"]
    return y, MLSTMState(C=C, n=n, m=m_new, conv=window[:, 1:])


# ===================================================================== sLSTM
class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d) float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_defs(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    ffi = int(d * 4 / 3 // 8 * 8)
    return {
        "w_in": ParamDef((*lead, d, 4 * d), (*la, "embed", "inner")),
        "r": ParamDef((*lead, H, dh, 4 * dh), (*la, None, None, None),
                      init="small"),
        "bias": ParamDef((*lead, 4 * d), (*la, "inner"), init="zeros"),
        "ln_scale": ParamDef((*lead, d), (*la, None), init="ones"),
        "ff_gate": ParamDef((*lead, d, ffi), (*la, "embed", "ff")),
        "ff_up": ParamDef((*lead, d, ffi), (*la, "embed", "ff")),
        "ff_down": ParamDef((*lead, ffi, d), (*la, "ff", "embed")),
    }


def slstm_init_state(cfg: ArchConfig, batch: int, device,
                     layers: Optional[int] = None) -> SLSTMState:
    """Zero float32 states (B, d), or (layers, B, d) stacked; four
    tensors, each updated on its own."""
    lead = () if layers is None else (layers,)

    def zeros():
        return torch.zeros((*lead, batch, cfg.d_model), dtype=torch.float32,
                           device=device)

    return SLSTMState(c=zeros(), n=zeros(), h=zeros(), m=zeros())


def _slstm_cell(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
                st: SLSTMState, r: torch.Tensor, bias: torch.Tensor
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """x_t: (B, d) one step's input; r, bias: the float32 recurrent
    weights and bias (cast once by the caller). Returns (h, new state)."""
    B, d = x_t.shape
    H = cfg.n_heads
    hr = st.h.float().reshape(B, H, d // H)
    rec = torch.einsum("bhd,hdf->bhf", hr, r)
    pre = (x_t @ p["w_in"]).float() + rec.reshape(B, 4 * d) + bias
    zi, ii, fi, oi = pre.split(d, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    lf = F.logsigmoid(fi)
    m_new = torch.maximum(lf + st.m, ii)
    ig = torch.exp(ii - m_new)
    fg = torch.exp(lf + st.m - m_new)
    c = fg * st.c + ig * zt
    n = fg * st.n + ig
    h = ot * c / torch.clamp(n, min=1.0)
    return h, SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_ffn(p: Dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The block's gated feed-forward (4/3 factor) on x + h."""
    xin = x + h
    return (F.gelu(xin @ p["ff_gate"], approximate="tanh")
            * (xin @ p["ff_up"])) @ p["ff_down"]


def slstm_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor, ctx: Ctx
                ) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d): the recurrence step by step from a zero
    state (L sequential steps, as the reference's scan), then the FFN."""
    B, L, _ = x.shape
    r, bias = p["r"].float(), p["bias"].float()
    st = slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(L):
        h_t, st = _slstm_cell(cfg, p, x[:, t], st, r, bias)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).to(x.dtype) * p["ln_scale"]
    return h + _slstm_ffn(p, x, h)


def slstm_decode_step(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
                      st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One step. x_t: (B, 1, d); st holds one layer's state."""
    h, st = _slstm_cell(cfg, p, x_t[:, 0], st, p["r"].float(),
                        p["bias"].float())
    h = h[:, None].to(x_t.dtype) * p["ln_scale"]
    return h + _slstm_ffn(p, x_t, h), st
