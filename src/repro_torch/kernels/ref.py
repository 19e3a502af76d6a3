"""Plain PyTorch versions of the hand-written kernels (the allclose
references, port of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "flash_attention_tiled_ref", "paged_attention_ref",
           "paged_attention_split_ref", "moe_gather_ref", "ssm_scan_ref",
           "ssm_scan_ex2_ref"]

LOG2E = 1.4426950408889634


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


def flash_attention_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              q_tile: int = 128,
                              kv_tile: int = 128) -> torch.Tensor:
    """``attention_ref``'s function by the CUDA kernel's algorithm, in
    plain PyTorch: for each tile of ``q_tile`` query rows, the kv tiles of
    ``kv_tile`` positions in order (under ``causal`` only those up to the
    tile's last row), an online softmax with float32 running max m, sum l
    of p = exp(s - m) and accumulator of p V, where p enters p V rounded
    to q's dtype (the kernel feeds bf16 p to its tensor cores; l adds the
    float32 p); at the end acc / max(l, 1e-30). Masked scores are -1e30,
    the causal mask top-left. Shapes as ``attention_ref``."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, K, G, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, q_tile):
        q1 = min(q0 + q_tile, S)
        n = -(-T // kv_tile)
        if causal:
            n = min(n, (q1 - 1) // kv_tile + 1)
        qi = torch.arange(q0, q1, device=q.device)
        m = torch.full((B, K, G, q1 - q0), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, G, q1 - q0, hd), device=q.device)
        for t in range(n):
            k0, k1 = t * kv_tile, min((t + 1) * kv_tile, T)
            s = torch.einsum("bqkgd,btkd->bkgqt", qf[:, q0:q1],
                             kf[:, k0:k1]) * (hd ** -0.5)
            if causal:
                ki = torch.arange(k0, k1, device=q.device)
                s = s.masked_fill(ki[None, :] > qi[:, None], -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(q.dtype).float(), vf[:, k0:k1])
            m = m_new
        out[:, q0:q1] = (acc / l.clamp(min=1e-30)[..., None]).permute(
            0, 3, 1, 2, 4)
    return out.reshape(B, S, H, hd).to(q.dtype)


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


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor,
                              tokens_per_span: int) -> torch.Tensor:
    """``paged_attention_ref``'s function by the CUDA kernel's algorithm
    (split-sequence flash-decoding), in plain PyTorch: each row's
    ``max_pages * ps`` positions are cut into spans of ``tokens_per_span``
    (a whole number of pages); each span gives a partial (max m, sum l of
    p = exp(s - m), float32 accumulator of p V with p rounded to q's dtype
    first, as the kernel feeds bf16 p to its tensor cores; the kernel's p
    is relative to a running max, so its roundings differ in the bits)
    over its valid positions, or an empty one (m -1e30, l 0); the
    partials are merged in span order,
    ``M = max m_s``, ``out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M)
    l_s`` over the non-empty spans. A row whose every span is empty has no
    valid position: the uniform mean of V over its gathered positions, as
    the reference gives. Shapes as ``paged_attention_ref``."""
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    maxp = tables.shape[1]
    if tokens_per_span <= 0 or tokens_per_span % ps:
        raise ValueError(f"tokens_per_span {tokens_per_span}: a positive "
                         f"multiple of the page size {ps}")
    G = H // K
    T = maxp * ps
    t = tables.long().clamp(min=0)
    k_seq = k_pages[t].reshape(B, T, K, hd).float()
    v_seq = v_pages[t].reshape(B, T, K, hd).float()
    pos = torch.arange(T, device=q.device)
    page_ok = (tables >= 0).repeat_interleave(ps, dim=1)
    valid = (pos[None] < lengths[:, None]) & page_ok  # (B, T)
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_seq) * (hd ** -0.5)
    neg = torch.tensor(-1e30, device=q.device)
    parts = []
    for s0 in range(0, T, tokens_per_span):  # each span's partial
        sl = slice(s0, min(s0 + tokens_per_span, T))
        ok = valid[:, None, None, sl]
        x = torch.where(ok, s[..., sl], neg)
        m = x.amax(-1)  # -1e30 for an empty span
        p = torch.where(ok, torch.exp(x - m[..., None]), 0.)
        p_v = p.to(q.dtype).float()
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgt,btkd->bkgd", p_v, v_seq[:, sl])))
    # the combine: the largest max of the non-empty spans, then the sums
    # in span order
    M = torch.stack([torch.where(l > 0, m, neg) for m, l, _ in parts]).amax(0)
    l_all = torch.zeros_like(M)
    acc_all = torch.zeros((B, K, G, hd), device=q.device)
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), 0.)
        l_all = l_all + w * l
        acc_all = acc_all + w[..., None] * acc
    out = acc_all / l_all.clamp(min=1e-30)[..., None]
    mean = v_seq.mean(1)  # (B, K, hd): the uniform softmax of an empty row
    none = (l_all == 0)[..., None]
    out = torch.where(none, mean[:, :, None], out)
    return out.reshape(B, H, hd).to(q.dtype)


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


def ssm_scan_ex2_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, x: torch.Tensor,
                     lanes: int = 2) -> torch.Tensor:
    """``ssm_scan_ref``'s function by the CUDA kernel's arithmetic, in
    plain PyTorch, all float32: A is scaled by log2 e once and the decay
    is ``exp2(dt_t * A')``; the N states (zero-padded to 16) are split
    among ``lanes`` lanes in runs of 16 / lanes, each lane sums its
    ``h * C_t`` terms in state order, and the lanes' parts are added as the
    kernel's reduce-scatter adds them (2 lanes: p0 + p1; 4 lanes:
    (p0 + p2) + (p1 + p3)). Shapes as ``ssm_scan_ref``."""
    if lanes not in (1, 2, 4, 8, 16):
        raise ValueError(f"lanes {lanes}: a power of two dividing 16")
    dt, A, B, C, x = (t.float() for t in (dt, A, B, C, x))
    Bt, L, di = x.shape
    N = A.shape[1]
    if N > 16:
        raise ValueError(f"state size N={N} over the kernel's 16")
    A2 = A * torch.tensor(LOG2E, dtype=torch.float32)
    per = 16 // lanes
    h = torch.zeros((Bt, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dt_t = dt[:, t, :, None]  # (Bt, di, 1)
        h = torch.exp2(dt_t * A2) * h + (dt_t * x[:, t, :, None]) \
            * B[:, t, None, :]
        hc = torch.nn.functional.pad(h * C[:, t, None, :], (0, 16 - N))
        parts = []
        for q in range(lanes):
            acc = hc[..., q * per]
            for j in range(q * per + 1, (q + 1) * per):
                acc = acc + hc[..., j]
            parts.append(acc)
        while len(parts) > 1:  # the reduce-scatter's rounds
            half = len(parts) // 2
            parts = [parts[i] + parts[i + half] for i in range(half)]
        ys.append(parts[0])
    if not ys:
        return x.new_zeros((Bt, 0, di))
    return torch.stack(ys, dim=1)
