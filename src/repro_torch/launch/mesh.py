"""Production meshes and the card's constants (the port of
`repro.launch.mesh`).

Importing this module starts no process group; meshes are built inside
functions only.  The dry-run's cells are the reference's: a pod of 16 x 16 =
256 devices ("data", "model") and two pods, 2 x 16 x 16 = 512 ("pod",
"data", "model").  A mesh is a `DeviceMesh` over the ranks of the current
world: a real one (NCCL or gloo) or the fake world `fake_world` starts,
whose collectives move nothing, for the dry-run.

The roofline constants are one NVIDIA H100 SXM5 80 GB's, at its 700 W
limit.
"""

from __future__ import annotations

import contextlib

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 tensor-core
# peak (the 1,979 TFLOPS it lists is with 2:4 sparsity), FLOP/s.
PEAK_FLOPS_BF16 = 989e12
# Same datasheet, SXM5: HBM3 bandwidth, B/s.
HBM_BW = 3.35e12
# Same datasheet, SXM5: 80 GB of device memory, taken as 80 GiB.
HBM_BYTES = 80 * 2**30
# InfiniBand NDR, 400 Gb/s a GPU (one ConnectX-7 port a GPU in a DGX H100):
# the slowest link a 16-wide model axis crosses, since a node holds 8 GPUs.
COLL_BW = 50e9


def production_axes(multi_pod: bool = False) -> dict[str, int]:
    """{axis: size} of the production mesh, in mesh order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_shape_for(devices: int, model_parallel: int = 16) -> tuple[int, int]:
    """(data, model) of the biggest mesh for `devices` devices: the model
    axis is the largest divisor of `devices` up to `model_parallel`."""
    model = min(model_parallel, devices)
    while devices % model:
        model -= 1
    return devices // model, model


def make_mesh(shape: tuple, names: tuple, device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` named `names` over ranks 0..n-1 of the
    current world."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 x 16 (or 2 x 16 x 16) `DeviceMesh` over ranks 0..255 (511) of
    the current world."""
    axes = production_axes(multi_pod)
    return make_mesh(tuple(axes.values()), tuple(axes), device_type)


def make_mesh_for(devices: int, model_parallel: int = 16,
                  device_type: str = "cuda"):
    """Elastic variant: the biggest (data, model) mesh for `devices` devices
    (`mesh_shape_for`), over ranks 0..devices-1 of the current world."""
    return make_mesh(mesh_shape_for(devices, model_parallel), ("data", "model"),
                 device_type)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of `world_size` ranks whose collectives move
    nothing (backend "fake"), this process rank 0: the dry-run's stand-in
    for a cluster.  Destroyed on exit.  `FakeStore` lives in a private torch
    module, imported here only."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
