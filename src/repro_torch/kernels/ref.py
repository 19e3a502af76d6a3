"""Plain PyTorch versions of the hand-written kernels (the allclose
references, port of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "paged_attention_ref", "moe_gather_ref",
           "ssm_scan_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd). Materialized-softmax attention in
    f32. GQA is contiguous: q head h reads kv head h // (H // K).
    The causal mask is top-left (q_idx >= k_idx), masked scores are -1e30."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (hd ** -0.5)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = s.masked_fill_(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v_pages: (P,ps,K,hd); tables: (B,maxp) global page
    ids (-1 = hole); lengths: (B,). Gathers every table entry's page (a
    hole reads page 0, as the reference's ``max(tables, 0)``), then a full
    float32 softmax with invalid positions at -1e30: a row with no valid
    position gets the uniform mean of V over its gathered positions."""
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    maxp = tables.shape[1]
    G = H // K
    t = tables.long().clamp(min=0)
    k_seq = k_pages[t].reshape(B, maxp * ps, K, hd)  # (B, S, K, hd)
    v_seq = v_pages[t].reshape(B, maxp * ps, K, hd)
    pos = torch.arange(maxp * ps, device=q.device)
    page_ok = (tables >= 0).repeat_interleave(ps, dim=1)
    valid = (pos[None] < lengths[:, None]) & page_ok
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_seq.float()) * (hd ** -0.5)
    s = s.masked_fill(~valid[:, None, None], -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", w, v_seq.float())
    return o.reshape(B, H, hd).to(q.dtype)


def moe_gather_ref(x: torch.Tensor, token_ids: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """Gather token rows into the (S, d) dispatch buffer: row i is
    ``x[token_ids[i]]`` where ``keep[i]``, else 0. Ids are clamped to
    [0, T) as the reference's gather clamps them (unkept slots hold -1).

    x: (T, d); token_ids: (S,) source row per slot; keep: (S,) bool."""
    rows = x[token_ids.long().clamp(0, x.shape[0] - 1)]
    return torch.where(keep[:, None], rows, 0)


def ssm_scan_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Selective-SSM scan, sequential over time, all in float32:
    ``h = exp(dt_t A) h + (dt_t x_t) B_t``, ``y_t = h . C_t`` from h = 0.

    dt, x: (Bt, L, di); A: (di, N); B, C: (Bt, L, N). Returns y:
    (Bt, L, di) float32. The reference's oracle over a batch dimension."""
    dt, A, B, C, x = (t.float() for t in (dt, A, B, C, x))
    Bt, L, di = x.shape
    h = torch.zeros((Bt, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(L):
        dt_t = dt[:, t, :, None]  # (Bt, di, 1)
        h = torch.exp(dt_t * A) * h + (dt_t * x[:, t, :, None]) \
            * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    if not ys:
        return x.new_zeros((Bt, 0, di))
    return torch.stack(ys, dim=1)
