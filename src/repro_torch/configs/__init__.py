"""Architecture + shape configuration registry (the port's own copy).

A plain copy of the reference registry: frozen :class:`ArchConfig`,
:class:`ShapeConfig`, ``SHAPES``, ``get_arch``, ``list_archs``, ``cells``,
``cell_is_runnable`` and ``reduced_config``.
``get_arch`` loads ``repro_torch.configs.<name>``, a plain copy of the
reference's config module, for every architecture of ``ARCH_IDS``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "ARCH_IDS",
    "SHAPES",
    "get_arch",
    "get_shape",
    "list_archs",
    "cells",
    "cell_is_runnable",
    "reduced_config",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """Static architecture description (exact numbers from the assignment)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # Attention details
    head_dim: Optional[int] = None  # default: d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"  # rope | learned | none
    norm: str = "rmsnorm"  # rmsnorm | layernorm

    # FFN
    activation: str = "swiglu"  # swiglu | geglu | relu2 | gelu

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_period: int = 1  # every `moe_period`-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_len: int = 0  # fixed number of (stub) frame embeddings

    # Hybrid SSM (jamba) / mamba params
    attn_period: int = 0  # every `attn_period`-th layer is attention (jamba: 8)
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2

    # xLSTM
    slstm_period: int = 0  # every `slstm_period`-th block is sLSTM

    # VLM
    n_patches: int = 0

    # Embedding
    tie_embeddings: bool = False

    # Memory / numerics knobs (per-arch defaults; see DESIGN.md §6)
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: str = "full"  # full | none | dots
    fsdp: bool = True  # shard params + opt state over the data axis

    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so 16-way TP sharding divides evenly."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_recurrent(self) -> bool:
        """Has O(1)-state (sub-quadratic) token mixing in at least some layers."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_attention_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.attn_period > 0:
            return self.n_layers // self.attn_period
        return self.n_layers

    # -- parameter counting (used for roofline MODEL_FLOPS = 6*N*D) -----
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; `active_only` counts top-k routed experts."""
        d, hd = self.d_model, self.resolved_head_dim
        q_dim = self.n_heads * hd
        kv_dim = self.n_kv_heads * hd
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d  # wq, wk, wv, wo
        if self.qkv_bias:
            attn += q_dim + 2 * kv_dim
        gated = self.activation in ("swiglu", "geglu")
        ffn_dense = d * self.d_ff * (3 if gated else 2)

        def expert_ffn() -> int:
            return d * self.d_ff * (3 if gated else 2)

        total = 0
        n_dec = self.n_layers
        for i in range(n_dec):
            # token mixer
            if self.family == "ssm":
                total += self._xlstm_block_params(i)
                continue
            if self.family == "hybrid" and self.attn_period > 0 and (i % self.attn_period != self.attn_period - 1):
                total += self._mamba_params()
            else:
                total += attn
            # channel mixer
            if self.is_moe and (i % self.moe_period == self.moe_period - 1):
                n_routed = self.top_k if active_only else self.n_experts
                total += d * self.n_experts  # router
                total += (n_routed + self.n_shared_experts) * expert_ffn()
            elif self.d_ff > 0:
                total += ffn_dense
        # encoder (whisper): self-attn + ffn per layer; decoder adds cross-attn
        if self.is_encoder_decoder:
            total += self.encoder_layers * (attn + ffn_dense)
            total += n_dec * attn  # cross-attention in each decoder layer
        # embeddings (+ untied head)
        emb = self.padded_vocab * d
        total += emb if self.tie_embeddings else 2 * emb
        if self.pos_embedding == "learned":
            total += 8192 * d  # learned positions (generous cap)
        if self.n_patches:
            total += self.n_patches * d  # stub patch position table
        return total

    def _mamba_params(self) -> int:
        d, e = self.d_model, self.ssm_expand
        di = e * d
        p = 2 * d * di  # in_proj (x and z branches)
        p += di * self.d_conv  # short conv
        p += di * (2 * self.d_state + 1)  # B, C, dt projections (x-dependent)
        p += di  # A (log) diagonal + D skip
        p += di * d  # out_proj
        return p

    def _xlstm_block_params(self, i: int) -> int:
        d = self.d_model
        if self.slstm_period and (i % self.slstm_period == self.slstm_period - 1):
            # sLSTM: 4 gates (i,f,z,o) recurrent + input, + gated FFN (4/3 factor)
            p = 8 * d * d
            p += int(2 * d * (4 * d / 3))
        else:
            # mLSTM: up-proj x2, q/k/v from inner dim, learnable skip, down-proj
            di = 2 * d
            p = 2 * d * di + 3 * di * di // 4 + di * d + di
        return p


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS: List[str] = [
    "whisper_small",
    "phi35_moe",
    "qwen2_moe",
    "nemotron4_340b",
    "gemma_7b",
    "qwen25_32b",
    "phi3_mini",
    "internvl2_26b",
    "xlstm_125m",
    "jamba15_large",
]

_REGISTRY: Dict[str, ArchConfig] = {}


def _load(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        _REGISTRY[name] = mod.CONFIG
    return _REGISTRY[name]


def get_arch(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "")
    aliases = {
        "whisper-small": "whisper_small",
        "phi3.5-moe-42b-a6.6b": "phi35_moe",
        "qwen2-moe-a2.7b": "qwen2_moe",
        "nemotron-4-340b": "nemotron4_340b",
        "gemma-7b": "gemma_7b",
        "qwen2.5-32b": "qwen25_32b",
        "phi3-mini-3.8b": "phi3_mini",
        "internvl2-26b": "internvl2_26b",
        "xlstm-125m": "xlstm_125m",
        "jamba-1.5-large-398b": "jamba15_large",
    }
    key = aliases.get(name, key)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    return _load(key)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def list_archs() -> List[ArchConfig]:
    return [_load(a) for a in ARCH_IDS]


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not arch.is_recurrent:
        return False, "long_500k requires sub-quadratic attention (skip: pure full-attention arch)"
    return True, ""


def cells() -> List[Tuple[ArchConfig, ShapeConfig, bool, str]]:
    """All 40 (arch x shape) cells with runnability annotations."""
    out = []
    for a in list_archs():
        for s in SHAPES.values():
            ok, why = cell_is_runnable(a, s)
            out.append((a, s, ok, why))
    return out


def reduced_config(cfg: ArchConfig, seq_hint: int = 64) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests (paper-style reduced run)."""
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, min(cfg.n_heads, 4))
    # keep GQA ratio: heads divisible by kv
    heads = (heads // kv) * kv or kv
    changes = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family in ("hybrid", "ssm") else 2),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_len=min(cfg.encoder_len, 16) if cfg.encoder_len else 0,
        n_patches=min(cfg.n_patches, 4),
        d_state=min(cfg.d_state, 8),
        fsdp=False,
        remat="none",
    )
    if cfg.family == "hybrid" and cfg.attn_period:
        changes["attn_period"] = 2
        changes["moe_period"] = min(cfg.moe_period, 2)
    return replace(cfg, **changes)
