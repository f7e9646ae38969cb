"""Model facade: build an architecture of the port (`repro.models.model`'s
`build_model`)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM


def build_model(cfg: ModelConfig, device="cuda", train: bool = False) -> LM:
    """The LM of `cfg` on `device` (the card by default): for serving, or
    with `train=True` holding f32 master parameters for `LM.loss`.  The
    encoder-decoder family, like every block kind but `attn`, is not ported
    yet and raises NotImplementedError."""
    return LM(cfg, device=device, train=train)
