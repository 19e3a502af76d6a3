"""Model facade (port of ``repro.models.model_zoo``): one ``nn.Module`` per
architecture holding its parameters, with forward and decode.

``state_dict`` keys are the reference's parameter tree paths joined by
``.`` (``blocks.attn.wq``), with the reference's shapes: weights
``(d_in, d_out)`` used as ``x @ W``, layer-stacked leaves ``(L, ...)``.
``build_model`` makes the parameters on the meta device (no memory, the
counterpart of ``abstract_params``); ``init_params`` or
``load_state_dict(..., assign=True)`` gives them storage. Parameters are
inference-only by default (``requires_grad=False``: serving builds no
autograd graph); ``init_params(..., trainable=True)``, or
``requires_grad_(True)`` on a loaded model, makes them trainable.

The sharding side is the reference's: ``param_specs(plan)`` and
``decode_state_specs(plan, kv_dtype)`` give partition spec trees
(``core.planner.P``) over the same paths, ``abstract_params`` meta tensors.
A rank of a mesh holds exactly its slice of every leaf under
``param_specs(plan)`` (``distributed.elastic.local_slice``): heads, ff and
vocab split over the model axis, the experts too under expert
parallelism, norms whole; under FSDP (``plan.fsdp`` on a data axis of
more than one rank) a dim of the larger leaves (``embed``, ``ff``,
``inner`` or ``vocab``) split over the data axis too, a leaf then a block
over two axes. ``init_shards`` draws those blocks and ``load_shards``
puts them in place of the parameters; ``forward`` and ``decode_step``
under ``Ctx(plan=, mesh=)`` compute with them (``transformer``, which
all-gathers the data axis's blocks where it reads a leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from repro_torch import tree as tr
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.core.planner import P, ShardingPlan
from repro_torch.models import params as pp
from repro_torch.models import transformer as tf
from repro_torch.models.context import Ctx

__all__ = ["Model", "build_model", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """Entry points run on CUDA unless the caller names another device;
    with no card and no device named, they raise (never a silent CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def _register(module: nn.Module, defs: Dict[str, Any]) -> None:
    for key, sub in sorted(defs.items()):
        if isinstance(sub, pp.ParamDef):
            module.register_parameter(key, nn.Parameter(
                torch.empty(sub.shape, device="meta"), requires_grad=False))
        else:
            child = nn.Module()
            _register(child, sub)
            module.add_module(key, child)


def _tree(module: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.defs = tf.model_defs(cfg)
        _register(self, self.defs)

    # ------------------------------------------------------------ params
    def init_params(self, generator: torch.Generator,
                    dtype=None, trainable: bool = False) -> "Model":
        """Draw every leaf on ``generator.device`` in ``dtype`` (default
        the config's ``param_dtype``); ``trainable`` makes every parameter
        require grad."""
        dt = pp.torch_dtype(dtype or self.cfg.param_dtype)
        tree = pp.initialize(self.defs, generator, dt, generator.device)
        self.load_state_dict(pp.flatten(tree), assign=True)
        return self.requires_grad_(trainable)

    def abstract_params(self, dtype=None) -> Dict[str, Any]:
        return pp.abstract(self.defs, dtype or self.cfg.param_dtype)

    def param_specs(self, plan: ShardingPlan) -> Dict[str, Any]:
        return pp.specs(self.defs, plan)

    def init_shards(self, generator: torch.Generator, plan: ShardingPlan,
                    mesh, dtype=None) -> "Model":
        """This rank's slices (``param_specs``) of the very weights
        ``init_params(generator, dtype)`` draws in one process: each leaf
        is drawn whole on the generator's device, in that order, its slice
        kept and the whole freed. The ranks take turns, a barrier each, so
        that ranks sharing a card never hold more than one whole leaf on
        it at once: on a card the rank hands each freed leaf's block back
        at once (``torch.cuda.empty_cache``), else its caching allocator
        keeps a whole leaf's room for the rest of the run, and carves the
        next leaves' slices out of it, so that it cannot be handed back
        (sixteen ranks on one card ran out of memory so)."""
        import torch.distributed as dist
        from repro_torch.distributed.elastic import local_slice
        dt = pp.torch_dtype(dtype or self.cfg.param_dtype)
        specs = pp.flatten(self.param_specs(plan))
        shards = {}
        for turn in range(mesh.size):
            if turn == mesh.rank:
                for path, d in pp.tree_paths(self.defs).items():
                    whole = pp.init_leaf(d, generator, dt, generator.device)
                    shards[path] = local_slice(whole, specs[path], mesh).to(
                        mesh.device, memory_format=torch.contiguous_format,
                        copy=True)
                    del whole
                    if generator.device.type == "cuda":
                        torch.cuda.empty_cache()
            dist.barrier()
        return self.load_shards(shards)

    def load_shards(self, state: Dict[str, torch.Tensor]) -> "Model":
        """``load_state_dict(state, assign=True)`` for a rank's local
        slices (``distributed.elastic.reshard_state`` of the parameters
        under ``param_specs``), whose shapes are not the full ones: each
        dim of a leaf whole or an even block of it (ValueError
        otherwise)."""
        defs = pp.tree_paths(self.defs)
        for key, t in state.items():
            module, _, name = key.rpartition(".")
            old = self.get_parameter(key)
            whole = defs[key].shape
            if t.dim() != len(whole) or any(
                    n <= 0 or w % n for n, w in zip(t.shape, whole)):
                raise ValueError(f"{key}: {tuple(t.shape)} is not a block "
                                 f"of {whole}")
            setattr(self.get_submodule(module), name,
                    nn.Parameter(t, requires_grad=old.requires_grad))
        return self

    def params(self) -> Dict[str, Any]:
        """The parameters as the reference's nested dict."""
        return _tree(self)

    def param_count(self) -> int:
        return pp.count(self.defs)

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.tokens.dtype

    # ----------------------------------------------------------- compute
    def forward(self, batch: Dict, ctx: Optional[Ctx] = None,
                last_only: bool = False):
        return tf.forward(self.cfg, self.params(), batch, ctx or Ctx(),
                          last_only)

    def encode(self, frames: torch.Tensor, ctx: Optional[Ctx] = None
               ) -> torch.Tensor:
        """The whisper encoder: frames (B, encoder_len, d) -> its output,
        which decode reads as ``DecodeState.enc_out``."""
        if self.cfg.family != "audio":
            raise ValueError(f"encode: {self.cfg.name} ({self.cfg.family}) "
                             f"has no encoder")
        return tf.encode_whisper(self.cfg, self.params(), frames,
                                 ctx or Ctx())

    def decode_step(self, token, state, ctx: Optional[Ctx] = None):
        return tf.decode_step(self.cfg, self.params(), token, state,
                              ctx or Ctx())

    def init_decode_state(self, batch: int, max_seq: int, dtype=None,
                          kv_dtype: Optional[str] = None, device=None,
                          kv_layout: str = "dense", page_size: int = 64,
                          num_pages: Optional[int] = None,
                          ctx: Optional[Ctx] = None):
        """The dense KV cache (``kv_dtype="int8"``: int8 with scales;
        another float type: a cache of it), the xLSTM states, or, with
        ``kv_layout="paged"``, the paged pool of ``page_size``-token pages
        (``transformer.init_decode_state``); dtype defaults to the config's
        ``param_dtype`` and device to the parameters' device. On a rank of
        a mesh the state is laid out as ``decode_state_specs`` places it:
        the caches hold the rank's kv heads (``kv_cache_heads``) or, under
        the "sequence" strategy, which ``ctx`` (the rank's plan and mesh)
        must then give, its span of the positions or its shard of the pool
        (``Ctx.seq_span``); a hybrid model's Mamba states its channels
        (``inner_held``)."""
        seq = ctx is not None and ctx.kv_seq
        return tf.init_decode_state(
            self.cfg, batch, max_seq,
            pp.torch_dtype(dtype or self.cfg.param_dtype),
            device or self.device, kv_dtype=kv_dtype, kv_layout=kv_layout,
            page_size=page_size, num_pages=num_pages,
            kv_heads=self.kv_cache_heads(seq), inner=self.inner_held(),
            seq_span=ctx.seq_span if seq else None)

    def kv_cache_heads(self, seq: bool = False) -> Optional[int]:
        """The kv heads this model's decode cache holds: those of the
        ``wk`` it holds, all of them or, on a rank under the "heads"
        strategy, its K/tp; None without attention. A rank whose ``wq`` is
        split and ``wk`` whole (the "sequence" strategy) caches every kv
        head over its span of the positions, and only with ``seq`` (its
        context's span): ValueError otherwise."""
        for path in ("blocks.attn", "groups.attn", "decoder.attn"):
            try:
                attn = self.get_submodule(path)
            except AttributeError:
                continue
            hd = self.cfg.resolved_head_dim
            whole = attn.wq.shape[-1] == self.cfg.n_heads * hd
            if not (whole or seq) and \
                    attn.wk.shape[-1] == self.cfg.n_kv_heads * hd:
                raise ValueError(
                    f"{self.cfg.name}: this rank's kv heads are whole and "
                    f"its q heads split (the \"sequence\" kv strategy): its "
                    f"decode state is its span of the sequence, which "
                    f"init_decode_state builds from ctx=")
            return attn.wk.shape[-1] // hd
        return None

    def inner_held(self) -> Optional[int]:
        """The Mamba channels this model computes, and so the width of its
        decode state's ``h``: di, or on a rank of a mesh the di/tp of its
        slices of ``inner`` (read from ``D``); None without Mamba."""
        try:
            return self.get_submodule("groups.mamba").D.shape[-1]
        except AttributeError:
            return None

    def decode_state_specs(self, plan: ShardingPlan,
                           kv_dtype: Optional[str] = None):
        """The decode state's specs (dense layout): KV caches over the
        batch axis and the kv strategy's, scales as their cache minus the
        head dim, ``enc_out`` as an activation, ``length`` whole, recurrent
        states over the batch with their inner dim over the model axis."""
        # An audio config's int8 cache is refused by init_decode_state (the
        # reference builds it and then fails to decode it); its tree is the
        # float one's plus the two scales, whose specs come from the path.
        audio_int8 = self.cfg.family == "audio" and kv_dtype == "int8"
        st = self.init_decode_state(1, 1, device="meta",
                                    kv_dtype=None if audio_int8 else kv_dtype)
        if audio_int8:
            st = st._replace(k_scale=st.length, v_scale=st.length)

        def spec_for(path: str, leaf):
            if "k_cache" in path or "v_cache" in path:
                return _kv_spec(plan, heads=(plan.kv_strategy == "heads"))
            if "k_scale" in path or "v_scale" in path:
                # (L, B, S, K): co-sharded with the cache minus head dim
                full = _kv_spec(plan, heads=(plan.kv_strategy == "heads"))
                return P(*tuple(full)[:4])
            if "enc_out" in path:
                return plan.act_spec("batch", None, None)
            if "length" in path:
                return P()
            return _state_spec(plan, leaf)

        specs = [spec_for("/".join(map(str, path)), leaf)
                 for path, leaf in tr.leaves_with_path(st)]
        return tr.unflatten(st, specs)


def _batch_axis(plan: ShardingPlan):
    if not plan.shard_batch:
        return None
    dp = (*plan.dp_axes, *plan.batch_extra_axes)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _kv_spec(plan: ShardingPlan, heads: bool) -> P:
    b = _batch_axis(plan)
    # (L, B, S, K, hd)
    if heads and plan.tp_axis:
        return P(None, b, None, plan.tp_axis, None)
    if plan.tp_axis:  # sequence-sharded KV (paged/flash-decode layout)
        # batch replicated (long_500k): spread the sequence over ALL axes
        seq = (plan.tp_axis if plan.shard_batch
               else (*plan.dp_axes, plan.tp_axis))
        return P(None, b, seq, None, None)
    return P(None, b, None, None, None)


def _state_spec(plan: ShardingPlan, leaf) -> P:
    b = _batch_axis(plan)
    nd = leaf.ndim
    if nd >= 3:
        # (L, B, inner, ...): TP-shard the inner dim when divisible
        inner = leaf.shape[2]
        tp = plan.tp_axis if (plan.tp_axis and inner % plan.tp_size == 0
                              and inner >= plan.tp_size) else None
        return P(None, b, tp, *([None] * (nd - 3)))
    if nd == 2:
        return P(None, b)
    return P()


def build_model(arch: Union[str, ArchConfig],
                layers: Optional[int] = None) -> Model:
    """``layers`` cuts the depth (never the width; whisper's decoder
    only). A hybrid stack runs whole groups, so its depth must be a
    multiple of ``attn_period``, an xLSTM stack's of ``slstm_period``
    (ValueError otherwise)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return Model(cfg)
