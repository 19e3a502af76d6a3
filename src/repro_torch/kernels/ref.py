"""Plain PyTorch versions of the hand-written kernels (the allclose
references, port of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import BWD_CHUNK

__all__ = ["attention_ref", "flash_attention_tiled_ref", "paged_attention_ref",
           "paged_attention_split_ref", "paged_attention_partial_ref",
           "moe_gather_ref", "gather_inverse",
           "gather_slots", "moe_gather_bwd_ref", "ssm_scan_ref",
           "ssm_scan_checkpointed_ref", "ssm_scan_ex2_ref",
           "ssm_scan_bwd_ref"]

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


def paged_attention_partial_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor) -> tuple:
    """The paged kernel's partial mode in plain PyTorch: over the pages
    that ``tables`` gives each row (a rank's sub-pool and local table),
    each (row, head)'s unfinished softmax in float32. Returns (out, ml):
    out (B,H,hd) float32, the row's p V over its own sum l; ml (B,H,2)
    float32, its max score m (scale included) and l, the sum of exp(s -
    m) over the valid positions; a row with no valid position gives zeros
    and (-1e30, 0), the empty partial. Shapes as ``paged_attention_ref``."""
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    maxp = tables.shape[1]
    G = H // K
    t = tables.long().clamp(min=0)
    k_seq = k_pages[t].reshape(B, maxp * ps, K, hd).float()
    v_seq = v_pages[t].reshape(B, maxp * ps, K, hd).float()
    pos = torch.arange(maxp * ps, device=q.device)
    page_ok = (tables >= 0).repeat_interleave(ps, dim=1)
    ok = ((pos[None] < lengths[:, None]) & page_ok)[:, None, None]
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, K, G, hd).float(),
                     k_seq) * (hd ** -0.5)
    s = s.masked_fill(~ok, -1e30)
    m = s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.)
    l = p.sum(-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_seq) / l.clamp(
        min=1e-30)[..., None]
    ml = torch.stack([torch.where(l > 0, m, -1e30), l], -1)
    return o.reshape(B, H, hd), ml.reshape(B, H, 2)


def moe_gather_ref(x: torch.Tensor, token_ids: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """Gather token rows into the (S, d) dispatch buffer: row i is
    ``x[token_ids[i]]`` where ``keep[i]``, else 0. Ids are clamped to
    [0, T) as the reference's gather clamps them (unkept slots hold -1).

    x: (T, d); token_ids: (S,) source row per slot; keep: (S,) bool."""
    rows = x[token_ids.long().clamp(0, x.shape[0] - 1)]
    return torch.where(keep[:, None], rows, 0)


def gather_inverse(token_ids: torch.Tensor, keep: torch.Tensor, T: int
                   ) -> tuple:
    """The gather's inverse map, built on the ids' device: (order, offsets)
    int32, where ``order[offsets[t]:offsets[t + 1]]`` are the kept slots
    whose (clamped) id is token t, in increasing slot order (a stable sort
    by token); order's entries past ``offsets[T]`` are the unkept slots."""
    key = torch.where(keep, token_ids.long().clamp(0, T - 1), T)
    sorted_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(T + 1, device=key.device))
    return order.to(torch.int32), offsets.to(torch.int32)


def gather_slots(token_ids: torch.Tensor, keep: torch.Tensor, T: int
                 ) -> torch.Tensor:
    """The gather's backward map from its ids and keep flags, for a caller
    that does not hold one (``moe_apply`` hands over its ``pos_tok``): a
    (T, k) int64 tensor on the ids' device whose row t lists the kept slots
    whose (clamped) id is token t in increasing slot order (as
    ``gather_inverse`` groups them), then S, the buffer's size, which the
    backward skips; k is the most slots a token has (read on the host)."""
    S = token_ids.shape[0]
    order, offsets = gather_inverse(token_ids, keep, T)
    offsets = offsets.long()
    counts = offsets[1:] - offsets[:-1]
    k = int(counts.max()) if T else 0
    slots = torch.full((T, k), S, dtype=torch.int64, device=token_ids.device)
    n = int(offsets[-1])
    tok = torch.repeat_interleave(
        torch.arange(T, device=token_ids.device), counts, output_size=n)
    col = torch.arange(n, device=token_ids.device) - offsets[tok]
    slots[tok, col] = order[:n].long()
    return slots


def moe_gather_bwd_ref(g: torch.Tensor, slots: torch.Tensor
                       ) -> torch.Tensor:
    """The gradient of ``moe_gather_ref`` with respect to x: dx (T, d) in
    g's dtype, row t the sum of g[s] over the slots s of row t of
    ``slots`` that lie in [0, S), added in the map's order in float32 from
    0 and rounded once (the kernel's order, so the two agree bit for bit).

    g: (S, d) the dispatch buffer's gradient; slots: (T, k) int64, each
    token's slots in increasing slot order, dropped ones at S or beyond
    (``moe_apply``'s ``pos_tok``, or ``gather_slots``)."""
    S = g.shape[0]
    acc = torch.zeros((slots.shape[0], g.shape[1]), dtype=torch.float32,
                      device=g.device)
    for i in range(slots.shape[1]):
        s = slots[:, i]
        has = (s >= 0) & (s < S)
        acc[has] += g[s[has]].float()
    return acc.to(g.dtype)


def ssm_scan_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Selective-SSM scan, sequential over time, all in float32:
    ``h = exp(dt_t A) h + (dt_t x_t) B_t``, ``y_t = h . C_t`` from h = 0.

    dt, x: (Bt, L, di); A: (di, N); B, C: (Bt, L, N). Returns y:
    (Bt, L, di) float32. The reference's oracle over a batch dimension."""
    return _scan_ref(dt, A, B, C, x)[0]


def ssm_scan_checkpointed_ref(dt: torch.Tensor, A: torch.Tensor,
                              B: torch.Tensor, C: torch.Tensor,
                              x: torch.Tensor,
                              every: int = BWD_CHUNK) -> tuple:
    """``ssm_scan_ref`` that also keeps the states the backward starts its
    chunks from: (y, ck), y the same bits, ck (Bt, ceil(L / every), di, N)
    float32 with ck[b, k, c, n] the state h[n] of channel c before step
    ``every`` k (the CUDA kernel's checkpoints)."""
    return _scan_ref(dt, A, B, C, x, every)


def _scan_ref(dt, A, B, C, x, every: int = 0) -> tuple:
    dt, A, B, C, x = (t.float() for t in (dt, A, B, C, x))
    Bt, L, di = x.shape
    h = torch.zeros((Bt, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys, cks = [], []
    for t in range(L):
        if every and t % every == 0:
            cks.append(h)
        dt_t = dt[:, t, :, None]  # (Bt, di, 1)
        h = torch.exp(dt_t * A) * h + (dt_t * x[:, t, :, None]) \
            * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((Bt, 0, di))
    ck = torch.stack(cks, dim=1) if cks else \
        x.new_zeros((Bt, 0, di, A.shape[1]))
    return y, (ck if every else None)


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


def ssm_scan_bwd_ref(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                     ck: torch.Tensor = None,
                     every: int = BWD_CHUNK) -> tuple:
    """The gradient of ``ssm_scan_ref`` given g = dL/dy (Bt, L, di), as the
    reverse-time scan the kernel runs, in plain PyTorch, all float32: from
    the checkpoints ``ck`` kept every ``every`` steps
    (``ssm_scan_checkpointed_ref``'s; None: they are computed first) the
    chunks of ``every`` steps from the last, each chunk's
    states and decays recomputed from its checkpoint, then from its last
    step down ``dh = g_t C_t + exp(dt_{t+1} A) dh_{t+1}``, ``w = dh h_{t-1}
    exp(dt_t A)``, ``ddt_t = x_t (dh . B_t) + w . A``, ``dx_t = dt_t (dh .
    B_t)``, ``dB_t = sum_c dh dt_t x_t``, ``dC_t = sum_c g_t h_t``, ``dA =
    sum_{b,t} w dt_t``. Returns (ddt, dA, dB, dC, dx) in the inputs'
    order, float32 and contiguous."""
    dt, A, B, C, x, g = (t.float() for t in (dt, A, B, C, x, g))
    if ck is None:
        ck = ssm_scan_checkpointed_ref(dt, A, B, C, x, every)[1]
    Bt, L, di = x.shape
    ddt, dx = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = torch.zeros_like(A)
    carry = x.new_zeros((Bt, di, A.shape[1]))  # exp(dt_{t+1} A) dh_{t+1}
    for k in reversed(range(ck.shape[1])):
        t0 = k * every
        h = ck[:, k].float()
        hs, decays = {t0: h}, {}
        for t in range(t0, min(t0 + every, L)):
            a = torch.exp(dt[:, t, :, None] * A)  # (Bt, di, N)
            h = a * h + (dt[:, t, :, None] * x[:, t, :, None]) \
                * B[:, t, None, :]
            hs[t + 1], decays[t] = h, a
        for t in reversed(decays):
            dh = g[:, t, :, None] * C[:, t, None, :] + carry
            w = dh * hs[t] * decays[t]
            s1 = (dh * B[:, t, None, :]).sum(-1)
            ddt[:, t] = x[:, t] * s1 + (w * A).sum(-1)
            dx[:, t] = dt[:, t] * s1
            dB[:, t] = (dh * (dt[:, t] * x[:, t])[..., None]).sum(1)
            dC[:, t] = (g[:, t, :, None] * hs[t + 1]).sum(1)
            dA += (w * dt[:, t, :, None]).sum(0)
            carry = decays[t] * dh
    return ddt, dA, dB, dC, dx
