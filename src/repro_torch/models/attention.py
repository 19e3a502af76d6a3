"""GQA attention: prefill (full + chunked online-softmax paths, or the
hand-written flash kernel), decode against a dense KV cache or, through
the hand-written paged-attention kernel, a paged pool, and the
encoder-decoder's cross-attention (port of ``repro.models.attention``).

Layouts are the reference's: q (B,S,H,hd), k/v (B,T,K,hd); q head h
reads kv head h // G (contiguous grouping). The attention functions take
the head counts from their inputs' shapes.

On a rank of a mesh the projections hold the slices ``Model.param_specs``
places: ``wq``/``bq`` and ``wo`` split by ``q_dim`` give the rank a block
of W = H·hd/tp columns (rows of ``wo``). Where the model axis divides H
that is H/tp whole heads; elsewhere (qwen2.5-32b's 40 heads over 16) the
block may cut a head at either edge, and the rank computes every head its
block overlaps (``head_block``): prefill brings the rest of each edge
head from the neighbour that holds it by one exchange over the model axis
before RoPE (``collectives.exchange_columns``), a head two ranks share is
computed by both, and each keeps only its own columns of the output for
its rows of ``wo`` (``attn_output``), so the all-reduce's sum is the
single device's. ``wk``/``wv``/``bk``/``bv`` split by ``kv_heads``
(``kv_strategy == "heads"``, where the axis divides K and so H: whole
heads) give the rank K/tp, and its decode cache holds those K/tp heads
over every position. Where they are whole (K does not divide the model
axis: the "sequence" strategy), prefill projects only the kv heads that
the rank's q heads read (one a q head where those fall unevenly over the
kv groups); decode runs over a cache split along the sequence, each rank
holding its span of the positions for every kv head (or its shard of the
paged pool), as the reference's ``decode_state_specs`` places it. There
the rank all-gathers its q columns over the model axis (every head),
computes each head's partial softmax over its span (``decode_partial``;
on the pool the paged kernel's partial mode), and the partials of the
heads its block overlaps come back from every span by one all-to-all,
merged in span order by the log-sum-exp rule (``combine_spans``,
``merge_partials``). The new token's k and v (all K heads: ``wk`` and
``wv`` are whole) are written by the rank whose span holds its position.
Either way the rank's heads' attention is the single device's, and the
``wo`` product's partials are summed by one all-reduce over the model
axis. For the gradient the inputs enter the split projections through
``layers.to_model``, and so do whole ``wk``/``wv`` (and biases) before a
rank slices them: the ranks that read one kv head add up its gradient;
the exchange's backward sends each rank the gradient of its columns that
a neighbour read.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.models.context import Ctx
from repro_torch.models.layers import held_split, model_sum, rope, to_model
from repro_torch.models.params import ParamDef

__all__ = ["attn_defs", "HeadBlock", "head_block", "attn_heads",
           "attn_project_qkv", "attn_output",
           "full_attention",
           "chunked_attention", "decode_attention", "paged_decode_attention",
           "decode_partial", "merge_partials", "combine_spans",
           "attention_block", "cross_attention_block"]

_NEG = -1e30
CHUNKED_THRESHOLD = 8192  # use online-softmax KV chunking above this S


def attn_defs(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    out = {
        "wq": ParamDef((*lead, d, H * hd), (*la, "embed", "q_dim")),
        "wk": ParamDef((*lead, d, K * hd), (*la, "embed", "kv_heads")),
        "wv": ParamDef((*lead, d, K * hd), (*la, "embed", "kv_heads")),
        "wo": ParamDef((*lead, H * hd, d), (*la, "q_dim", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((*lead, H * hd), (*la, "q_dim"), init="zeros")
        out["bk"] = ParamDef((*lead, K * hd), (*la, "kv_heads"), init="zeros")
        out["bv"] = ParamDef((*lead, K * hd), (*la, "kv_heads"), init="zeros")
    return out


class HeadBlock(NamedTuple):
    """The q heads that a rank's block of ``wq``'s q_dim columns overlaps:
    heads ``first`` .. ``first + count - 1``, its first column at
    ``offset`` inside head ``first``; and ``kv``, the kv heads its
    attention reads, in the order of its k / v heads: ``kv(first)`` ..
    ``kv(last)``, or one a q head where the overlapped heads read their
    kv heads unevenly (not ``count / len(kv)`` a kv head in order)."""
    first: int
    count: int
    offset: int
    kv: Tuple[int, ...]


def head_block(cfg: ArchConfig, q_width: int, rank: int) -> HeadBlock:
    """The ``HeadBlock`` of model rank ``rank``'s q_dim columns [rank·W,
    (rank+1)·W), W = ``q_width``. Where the model axis divides H the
    block is H/tp whole heads at offset 0; elsewhere its edges may cut a
    head, which the neighbour's block shares."""
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    lo, hi = rank * q_width, (rank + 1) * q_width
    first, last = lo // hd, -(-hi // hd) - 1
    count, k0, k1 = last - first + 1, first // G, last // G
    per = count // (k1 - k0 + 1)
    kv = tuple(range(k0, k1 + 1))
    if any((first + j) // G != k0 + j // per for j in range(count)) or \
            per * len(kv) != count:
        kv = tuple((first + j) // G for j in range(count))
    return HeadBlock(first, count, lo - first * hd, kv)


def attn_heads(cfg: ArchConfig, q_width: int, k_width: int, rank: int = 0
               ) -> Tuple[int, int]:
    """(q heads, kv heads) that model rank ``rank``'s prefill computes,
    from the widths of the ``wq`` and ``wk`` it holds: both whole, both
    split (H/tp, K/tp: whole heads, the "heads" strategy), or ``wq`` split
    and ``wk`` whole (the "sequence" strategy), where it computes the q
    heads its block overlaps and the kv heads ``head_block`` gives
    them."""
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    if q_width == H * hd or k_width < K * hd:
        if q_width % hd:
            raise ValueError(
                f"{cfg.name}: a q_dim block of {q_width} splits a head of "
                f"{hd} under the \"heads\" kv strategy, whose model axis "
                f"divides the heads")
        return q_width // hd, k_width // hd
    block = head_block(cfg, q_width, rank)
    return block.count, len(block.kv)


def _head_columns(cfg: ArchConfig, q: torch.Tensor, ctx: Ctx
                  ) -> torch.Tensor:
    """A rank's (..., W) block of ``x @ wq`` that cuts a head -> the
    (..., count·hd) columns of the heads it overlaps: one exchange over
    the model axis brings the rest of each edge head from the neighbours
    that hold it (``collectives.exchange_columns``)."""
    W, hd = q.shape[-1], cfg.resolved_head_dim
    held, wanted = [], []
    for r in range(ctx.tp):
        b = head_block(cfg, W, r)
        held.append((r * W, (r + 1) * W))
        wanted.append((b.first * hd, (b.first + b.count) * hd))
    return coll.exchange_columns(q, ctx.tp_group, held, wanted)


def attn_project_qkv(cfg: ArchConfig, p: Dict, xq: torch.Tensor,
                     xkv: Optional[torch.Tensor] = None,
                     ctx: Optional[Ctx] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q (B,S,H,hd) from xq, k/v (B,T,K,hd) from xkv (default
    xq; the encoder output for cross-attention): H and K the heads that
    ``p`` gives this rank (``attn_heads``; where its ``wq`` block cuts a
    head, whole heads from the neighbours' columns)."""
    if xkv is None:
        xkv = xq
    hd = cfg.resolved_head_dim
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    rank = ctx.tp_index if ctx is not None else 0
    H, K = attn_heads(cfg, p["wq"].shape[-1], wk.shape[-1], rank)
    kv = None
    if held_split(p["wq"].shape[-1], cfg.n_heads * hd, ctx):
        same = xkv is xq
        xq = to_model(xq, ctx)
        xkv = xq if same else to_model(xkv, ctx)
        if wk.shape[-1] == cfg.n_kv_heads * hd:
            # kv whole: this rank's q heads read kv heads k0 .. k1
            kv = head_block(cfg, p["wq"].shape[-1], rank).kv
            cols = slice(kv[0] * hd, (kv[-1] + 1) * hd)
            wk = to_model(wk, ctx)[..., cols]
            wv = to_model(wv, ctx)[..., cols]
            if cfg.qkv_bias:
                bk = to_model(bk, ctx)[..., cols]
                bv = to_model(bv, ctx)[..., cols]
    q, k, v = xq @ p["wq"], xkv @ wk, xkv @ wv
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    if q.shape[-1] % hd:  # the block cuts a head: whole heads first
        q = _head_columns(cfg, q, ctx)
    B, S = xq.shape[:2]
    T = xkv.shape[1]
    k, v = k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd)
    if kv is not None and len(kv) != k.shape[2]:  # uneven: one a q head
        pick = torch.tensor([h - kv[0] for h in kv], device=k.device)
        k, v = k.index_select(2, pick), v.index_select(2, pick)
    return q.reshape(B, S, H, hd), k, v


def attn_output(cfg: ArchConfig, p: Dict, out: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
    """out (B,S,H*hd) @ ``wo``; with ``wo``'s q_dim rows split over the
    model axis, the rank's columns of the heads it computed (those of its
    block, at ``head_block``'s offset, where the block cuts a head) times
    its rows, the ranks' partials summed by one all-reduce."""
    W = p["wo"].shape[-2]
    if out.shape[-1] != W:
        offset = head_block(cfg, W, ctx.tp_index).offset
        out = out[..., offset:offset + W]
    y = out @ p["wo"]
    if held_split(W, cfg.n_heads * cfg.resolved_head_dim, ctx):
        y = model_sum(y, ctx)
    return y


def _gqa_shape(q: torch.Tensor, K: int) -> torch.Tensor:
    B, S, H, hd = q.shape
    return q.reshape(B, S, K, H // K, hd)


def _scores(qg: torch.Tensor, k: torch.Tensor, spec: str) -> torch.Tensor:
    """The q.k product with f32 output (JAX's preferred_element_type=f32):
    bf16 products are exact in f32, so upcasting first is the same sum."""
    return torch.einsum(spec, qg.float(), k.float())


def full_attention(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, causal: bool,
                   q_offset: int = 0) -> torch.Tensor:
    """Materialized-scores attention. q:(B,S,H,hd), k/v:(B,T,K,hd)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    scores = _scores(_gqa_shape(q, k.shape[2]), k, "bskgd,btkd->bkgst")
    scores.mul_(hd ** -0.5)  # in place: one (B,K,G,S,T) f32 buffer, not two
    if causal:
        qi = torch.arange(S, device=q.device) + q_offset
        ki = torch.arange(T, device=q.device)
        scores.masked_fill_(qi[:, None] < ki[None, :], _NEG)
    w = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def chunked_attention(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, causal: bool, chunk: int = 1024
                      ) -> torch.Tensor:
    """Online softmax over KV chunks (the flash algorithm, plain torch)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    K = k.shape[2]
    G = H // K
    qg = _gqa_shape(q, K)
    scale = hd ** -0.5
    qi = torch.arange(S, device=q.device)
    m = torch.full((B, K, G, S), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=q.device)
    for start in range(0, T, chunk):
        kb, vb = k[:, start:start + chunk], v[:, start:start + chunk]
        s = _scores(qg, kb, "bskgd,btkd->bkgst") * scale
        ki = start + torch.arange(kb.shape[1], device=q.device)
        if causal:
            s.masked_fill_(qi[:, None] < ki[None, :], _NEG)
        # the reference pads T to a chunk multiple and masks the pad; the
        # ragged last chunk here has no pad columns to mask
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def decode_attention(cfg: ArchConfig, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """One-token attention vs a dense cache.

    q: (B,1,H,hd); k/v_cache: (B,Smax,K,hd); length: (B,) valid prefix."""
    B, _, H, hd = q.shape
    Smax = k_cache.shape[1]
    qg = _gqa_shape(q, k_cache.shape[2])[:, 0]  # (B,K,G,hd)
    s = _scores(qg, k_cache, "bkgd,btkd->bkgt") * hd ** -0.5
    valid = torch.arange(Smax, device=q.device)[None, :] < length[:, None]
    s.masked_fill_(~valid[:, None, None], _NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One-token attention vs one layer's view of the paged pool.

    q: (B,1,H,hd); k/v_pages: (P,page,K,hd); tables: (B,max_pages) int32
    global page ids, -1 a hole; lengths: (B,) int32 valid prefix."""
    return kops.paged_attention(q[:, 0], k_pages, v_pages, tables,
                                lengths)[:, None]


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token attention over a span of a dense cache, unfinished: q
    (B,H,hd); k/v (B,T,K,hd), the span's positions; valid (B,T) bool.
    Returns (out (B,H,hd), ml (B,H,2)) float32 as the paged kernel's
    partial mode gives them: each row's p V over its own sum l, and (max
    score, l); zeros and (-1e30, 0) for a row with no valid position."""
    B, H, hd = q.shape
    K = k.shape[2]
    s = _scores(q.reshape(B, K, H // K, hd), k, "bkgd,btkd->bkgt") \
        * hd ** -0.5
    ok = valid[:, None, None]
    s.masked_fill_(~ok, _NEG)
    m = s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.)
    l = p.sum(-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float()) / l.clamp(
        min=1e-30)[..., None]
    ml = torch.stack([torch.where(l > 0, m, _NEG), l], -1)
    return out.reshape(B, H, hd), ml.reshape(B, H, 2)


def merge_partials(out: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """The spans' partials (out (n,B,H,hd), ml (n,B,H,2) float32, span
    order) merged by ``ref.paged_attention_split_ref``'s rule: M the
    largest max of the non-empty spans, each span weighted by e^(m - M) l,
    the weighted outputs and the weights summed in span order. A row with
    no valid position in any span gives zeros (only an idle serving slot
    has none). Returns (B,H,hd) float32."""
    m, l = ml[..., 0], ml[..., 1]
    live = l > 0
    M = torch.where(live, m, _NEG).amax(0)
    w = torch.where(live, torch.exp(m - M), 0.) * l
    acc = torch.zeros_like(out[0])
    total = torch.zeros_like(l[0])
    for s in range(out.shape[0]):
        acc.addcmul_(w[s, ..., None], out[s])
        total.add_(w[s])
    return acc / total.clamp(min=1e-30)[..., None]


def combine_spans(out: torch.Tensor, ml: torch.Tensor, ctx: Ctx,
                  blocks) -> torch.Tensor:
    """Every head's partial over this rank's span (out (B,H,hd), ml
    (B,H,2)) -> the attention (B,n,hd) float32 of the n heads that this
    rank's q_dim block overlaps, ``blocks[i]`` the ``HeadBlock`` of model
    index i: each span's partials of a rank's heads go to it by one
    all-to-all over ``ctx.seq_group`` (the ranks of the spans, in span
    order; span j sits at model index j mod tp), a head that two blocks
    share to both, then ``merge_partials`` in span order."""
    B, H, hd = out.shape
    tp, (_, n) = ctx.tp, ctx.seq_span
    parts = torch.cat([out, ml], -1).movedim(1, 0)  # (H, B, hd + 2)
    dests = [blocks[j % tp] for j in range(n)]
    send = torch.cat([parts[b.first:b.first + b.count] for b in dests])
    mine = blocks[ctx.tp_index].count
    got = coll.all_to_all(send, ctx.seq_group, [b.count for b in dests],
                          [mine] * n)
    got = got.view(n, mine, B, hd + 2).transpose(1, 2)
    return merge_partials(got[..., :hd], got[..., hd:])


def attention_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True,
                    use_flash: bool = False,
                    ctx: Optional[Ctx] = None) -> torch.Tensor:
    """Self-attention over a full sequence (prefill), over the heads that
    ``p`` gives this rank."""
    q, k, v = attn_project_qkv(cfg, p, x, ctx=ctx)
    if cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    if use_flash:
        out = kops.flash_attention(q, k, v, causal=causal)
    elif S >= CHUNKED_THRESHOLD:
        out = chunked_attention(cfg, q, k, v, causal)
    else:
        out = full_attention(cfg, q, k, v, causal)
    return attn_output(cfg, p, out.reshape(B, S, -1), ctx)


def cross_attention_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                          enc: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention onto the encoder output: the plain path,
    no positions, not causal (as the reference)."""
    q, k, v = attn_project_qkv(cfg, p, x, enc)
    out = full_attention(cfg, q, k, v, causal=False)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]
