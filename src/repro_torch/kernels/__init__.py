"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`edp_reduce`: the cost model's per-mapping reduction, K1)."""

from repro_torch.kernels.edp_reduce import edp_reduce, reduce_edp_terms

__all__ = ["edp_reduce", "reduce_edp_terms"]
