"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: `cost_forward` (the cost model's whole forward in one launch, K1b),
`edp_reduce` (its per-mapping reduction alone, the TPU kernel K1),
`tiled_matmul` (K2), `flash_attention` (K3, the causal GQA attention of the
LM's prefill and training forward) and `flash_attention_bwd` (K3-bwd, its
gradient, through the registered op `repro_torch::flash_attention_fwd`); `ops` holds the LM's entry points to
K2 and K3.  K4, the GP's whole Adam fit (`gp_fit`), is the module
`repro_torch.kernels.gp_fit`, used by `core.gp`."""

from repro_torch.kernels.cost_forward import cost_forward, cost_forward_ref
from repro_torch.kernels.edp_reduce import edp_reduce, reduce_edp_terms
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_lse_ref,
                                     flash_attention_ref, matmul_ref)
from repro_torch.kernels.tiled_matmul import tiled_matmul

__all__ = ["cost_forward", "cost_forward_ref", "edp_reduce",
           "reduce_edp_terms", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_lse_ref", "flash_attention_ref", "matmul_ref",
           "tiled_matmul"]
