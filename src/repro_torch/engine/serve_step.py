"""Serving step: one-token decode against the KV cache, sampling, and a
continuous-batching host loop driven by the KV page allocator (port of
``repro.engine.serve_step``; eager PyTorch, no jit). The engine decodes
against the dense cache, as the reference does, or against the paged
pool, whose pages the allocator places."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.context import Ctx
from repro_torch.models.model_zoo import Model
from repro_torch.objectmodel.kvcache import KVCacheConfig, KVPageManager

__all__ = ["make_serve_step", "sample_token", "ServingEngine"]


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, 1, V) -> (B, 1) int32. Greedy is argmax over the padded
    vocab (first index on ties, as jnp.argmax)."""
    lg = logits[:, -1]
    if temperature <= 0.0:
        return lg.argmax(dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(lg / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def make_serve_step(model: Model, ctx: Ctx, temperature: float = 0.0):
    """serve_step(token, state, generator) -> (next_token, logits, state).

    One new token per slot; the state's caches are updated in place."""

    def serve_step(token, state, generator=None):
        logits, state = model.decode_step(token, state, ctx)
        return sample_token(logits, generator, temperature), logits, state

    return serve_step


@dataclasses.dataclass
class _Seq:
    sid: int
    prompt: List[int]
    out: List[int]
    done: bool = False


class ServingEngine:
    """Host-side continuous batching on top of the KV page allocator.

    Slots in the device batch are the buffer-pool frames; finished
    sequences release their KV pages back to the free list and the slot is
    refilled from the queue. With ``kv_layout="dense"`` the model decodes
    against its dense cache, and the allocator only keeps the books, as in
    the reference. With ``kv_layout="paged"`` it decodes against the paged
    pool (``page_size`` tokens a page): before each step every active slot
    gets room for one more token (a new page at a page boundary), and the
    block tables and each slot's tail page go to the card in one copy
    each; an idle slot's table row is all holes and its write is dropped
    (the dense, MoE, vlm and hybrid families; audio and ssm raise). A
    hybrid or xLSTM model also keeps its per-slot recurrent states; an
    audio model decodes against ``enc_out`` zeros, as the reference's
    serving never runs the encoder.

    Under a mesh ``ctx`` every rank of the model axis runs the same
    engine over its slices of the model (``Model.param_specs``): the same
    requests, the same page books, its own kv heads in the cache or pool,
    and the same greedy token from the logits that every rank holds
    whole. Under the "sequence" kv strategy the books place pages over as
    many shards as there are spans (``Ctx.seq_span``), and each rank
    takes its shard's table row and page map, and the global tail page,
    whose id names the shard that writes."""

    def __init__(self, model: Model, batch_size: int, max_seq: int,
                 ctx: Optional[Ctx] = None, eos_id: int = 0,
                 page_size: int = 64, kv_layout: str = "dense"):
        self.model = model
        self.B = batch_size
        self.max_seq = max_seq
        self.ctx = ctx or Ctx()
        self.eos = eos_id
        cfg = model.cfg
        # the reference's books count cfg.n_layers (an ssm config's too)
        n_attn = (cfg.n_layers // cfg.attn_period if cfg.family == "hybrid"
                  else cfg.n_layers)
        seq = self.ctx.kv_seq
        self.shard, shards = self.ctx.seq_span if seq else (0, 1)
        pages = batch_size * (-(-max_seq // page_size)) * 2
        self.kv_cfg = KVCacheConfig(
            n_layers=n_attn,
            n_kv_heads=model.kv_cache_heads(seq) or cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, max_seq_len=max_seq,
            page_size=page_size, num_pages=-(-pages // shards) * shards,
            num_shards=shards)
        self.pages = KVPageManager(self.kv_cfg)
        self.paged = kv_layout == "paged"
        self.state = model.init_decode_state(
            batch_size, max_seq, model.dtype, kv_layout=kv_layout,
            page_size=page_size, num_pages=self.kv_cfg.num_pages,
            ctx=self.ctx)
        self.slots: List[Optional[_Seq]] = [None] * batch_size
        self.queue: List[_Seq] = []
        self.finished: List[_Seq] = []
        self._sid = 0
        self._step = make_serve_step(model, self.ctx)
        self._tokens = np.zeros((batch_size, 1), np.int32)
        self._prompts_pending: Dict[int, List[int]] = {}

    def submit(self, prompt: List[int]) -> int:
        self._sid += 1
        self.queue.append(_Seq(self._sid, list(prompt), []))
        return self._sid

    def _admit(self) -> None:
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                seq = self.queue.pop(0)
                self.slots[i] = seq
                self.pages.allocate(seq.sid, len(seq.prompt) + 8)
                self._prompts_pending[i] = list(seq.prompt)
                # reset this slot's cache length. As in the reference, a
                # hybrid model's Mamba state (h, conv window) and an xLSTM
                # model's states are not reset: a new request starts from
                # the previous one's state.
                self.state.length[i] = 0

    def step(self, generator: Optional[torch.Generator] = None) -> int:
        """One engine iteration; returns number of active slots."""
        self._admit()
        active = 0
        for i, seq in enumerate(self.slots):
            if seq is None:
                continue
            active += 1
            pend = self._prompts_pending.get(i)
            if pend:
                self._tokens[i, 0] = pend.pop(0)  # prompt feeding
        if active == 0:
            return 0
        if self.paged:
            self._place_pages()
        token = torch.from_numpy(self._tokens).to(self.model.device)
        nxt, _, self.state = self._step(token, self.state, generator)
        if self.paged:
            for seq in self.slots:
                if seq is not None:
                    self.pages.advance(seq.sid)
        nxt = nxt.cpu().numpy()
        lengths = self.state.length.cpu().numpy()
        for i, seq in enumerate(self.slots):
            if seq is None:
                continue
            if self._prompts_pending.get(i):  # still consuming the prompt
                continue
            tok = int(nxt[i, 0])
            seq.out.append(tok)
            self._tokens[i, 0] = tok
            if tok == self.eos or int(lengths[i]) >= self.max_seq - 1 \
                    or len(seq.out) >= self.max_seq:
                seq.done = True
                self.pages.release(seq.sid)  # recycle KV pages
                self.finished.append(seq)
                self.slots[i] = None
                self._prompts_pending.pop(i, None)
        return active

    def _place_pages(self) -> None:
        """Room for this step's token in every active slot's pages, then
        the block tables (a rank split over the sequence: its shard's row
        and page map) and the tail pages to the card, once per step."""
        sids, tail = [], np.full(self.B, -1, np.int32)
        for i, seq in enumerate(self.slots):
            sids.append(-1 if seq is None else seq.sid)  # -1: owns no page
            if seq is not None:
                self.pages.allocate(seq.sid, 1)
                tail[i] = self.pages.tail_physical_page(seq.sid)
        s = self.shard  # this rank's shard (0 of 1 when not split)
        self.state.kv.block_tables.copy_(
            torch.from_numpy(self.pages.build_tables(sids)[s:s + 1]))
        if self.state.seq_pages is not None:
            self.state.seq_pages.copy_(
                torch.from_numpy(self.pages.build_page_map(sids)[s]))
        self.state.tail.copy_(torch.from_numpy(tail))
