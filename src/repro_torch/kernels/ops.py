"""Public entry points of the LM kernels (the port of `repro.kernels.ops`).

Each takes torch tensors, or array-likes that are placed on `device` (the
card by default; without CUDA that raises a RuntimeError naming the device).
On CUDA tensors they launch the hand-written kernels, on CPU tensors they run
the plain versions; see `tiled_matmul` and `flash_attention` for the
constraints and the launch counts (`tiled_matmul.launches`,
`flash_attention.launches`, and `flash_attention_bwd.launches` when autograd
differentiates `attention`).  The defaults are the Hopper kernels' tiles
(`tiled_matmul.default_blocks`), not the reference's TPU blocks.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import TILE, flash_attention
from repro_torch.kernels.tiled_matmul import tiled_matmul


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, device=resolve_device(device))


def matmul(x, w, bm: int | None = None, bk: int | None = None,
           bn: int | None = None, device="cuda"):
    return tiled_matmul(_tensor(x, device), _tensor(w, device),
                        bm=bm, bk=bk, bn=bn)


def attention(q, k, v, bq: int = TILE, bk: int = TILE, device="cuda"):
    return flash_attention(_tensor(q, device), _tensor(k, device),
                           _tensor(v, device), bq=bq, bk=bk)
