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
``requires_grad_(True)`` on a loaded model, makes them trainable. Sharding
specs wait for the parallelism slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from repro_torch.configs import ArchConfig, get_arch
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
                          num_pages: Optional[int] = None):
        """The dense KV cache (``kv_dtype="int8"``: int8 with scales;
        another float type: a cache of it), the xLSTM states, or, with
        ``kv_layout="paged"``, the paged pool of ``page_size``-token pages
        (``transformer.init_decode_state``); dtype defaults to the config's
        ``param_dtype`` and device to the parameters' device."""
        return tf.init_decode_state(
            self.cfg, batch, max_seq,
            pp.torch_dtype(dtype or self.cfg.param_dtype),
            device or self.device, kv_dtype=kv_dtype, kv_layout=kv_layout,
            page_size=page_size, num_pages=num_pages)


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
