"""PyTorch/CUDA port of the hardware/software co-design search.

A package of its own beside `repro` (the JAX reference, which it never
imports): the nested constrained-BO co-design (`repro_torch.core`), the
analytical cost model with its torch device engine (`repro_torch.timeloop`),
the LM stack's serving and training (`models`, `launch`, `optim`, `data`,
`checkpoint`, `runtime`), and the hand-written Hopper kernels
(`repro_torch.kernels`, CUDA sources in `csrc/`, built with nvcc at first
use).  Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`.
"""
