"""Model facade: build any architecture of the port and describe its inputs
and decode cache (`repro.models.model`'s `build_model`, `input_specs` and
`cache_specs`).

The specs are `torch.empty(..., device="meta")` tensors: shape and dtype
with no storage, the counterpart of the reference's `ShapeDtypeStruct`s.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import LM, init_block_cache

_INT = torch.int32


def build_model(cfg: ModelConfig, device="cuda", train: bool = False):
    """The model of `cfg` on `device` (the card by default): `EncDecLM` for
    the encoder-decoder family, else `LM`; for serving, or with `train=True`
    holding master parameters for `loss`."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device, train=train)
    return LM(cfg, device=device, train=train)


def _spec(shape, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = L.torch_dtype(dtype)
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for the step function's data arguments.  Modality frontends
    are stubs: embeddings arrive precomputed."""
    B, S = shape.global_batch, shape.seq_len
    specs: dict = {}
    if cfg.family == "encdec":
        specs["src_embeddings"] = _spec((B, max(S // 8, 16), cfg.d_model),
                                        cfg.compute_dtype)
        if shape.kind == "decode":
            specs["tokens"] = _spec((B, 1), _INT)
        else:
            specs["tokens"] = _spec((B, S), _INT)
            if shape.kind == "train":
                specs["labels"] = _spec((B, S), _INT)
        return specs
    if shape.kind == "decode":
        if cfg.input_mode == "embeddings":
            specs["embeddings"] = _spec((B, 1, cfg.d_model), cfg.compute_dtype)
        else:
            specs["tokens"] = _spec((B, 1), _INT)
        return specs
    if cfg.input_mode == "embeddings":
        specs["embeddings"] = _spec((B, S, cfg.d_model), cfg.compute_dtype)
    else:
        specs["tokens"] = _spec((B, S), _INT)
    if cfg.mrope:
        specs["positions"] = _spec((3, B, S), _INT)
    if shape.kind == "train":
        specs["labels"] = _spec((B, S), _INT)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache's stand-ins: one entry a layer (and, for the
    encoder-decoder, the encoder output beside the caches)."""
    B, S = shape.global_batch, shape.seq_len
    spec = L.CacheSpec(S, cfg.kv_cache_dtype)
    meta = torch.device("meta")
    if cfg.family == "encdec":
        caches = [{"self": L.init_kv_cache(cfg, B, spec, meta)}
                  for _ in range(cfg.num_layers)]
        return caches, _spec((B, max(S // 8, 16), cfg.d_model),
                             cfg.compute_dtype)
    pattern = cfg.block_pattern
    return [init_block_cache(pattern[i % len(pattern)], cfg, B, spec, meta)
            for i in range(cfg.num_layers)]
