"""Production mesh construction and the card's constants for the roofline.

PyTorch counterpart of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.DeviceMesh`` over a fake process group: one process
holds rank 0 of a world of 256 (or 512) ranks whose collectives move no
data, which is what the dry-run traces against.  ``fake_process_group``
opens that group and always closes it: ``init_process_group`` is
process-wide and holds one world size at a time.

256 H100s are 32 HGX nodes of 8 GPUs.  A 16-wide mesh axis therefore
crosses nodes, whose links are slower than NVLink, so the collective term
of the roofline (bytes over ``LINK_BW``) is a lower bound.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5 column (dense rates,
# no sparsity; at the full 700 W power limit)
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per GPU, bf16 tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s per GPU, f32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per GPU, HBM3
HBM_BYTES = 80e9             # bytes of HBM3 per GPU
LINK_BW = 450e9              # bytes/s per GPU one way: NVLink 4 is 900 GB/s
#                              in both directions together

# The meshes are typed "cpu": the dry-run runs on the host, on meta tensors.
# On such a mesh DTensor stands an all-gather and a chunk in for each
# all-to-all (gloo has none), and the counters see those.
MESH_DEVICE = "cpu"

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks (this process is rank
    0) for the body of the ``with``; destroyed on the way out, also on an
    error."""
    import torch.distributed as dist
    # registers the "fake" backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` with the axis ``names``, over the open
    process group, whose world must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs a process group of "
                           f"{n} ranks: open one with fake_process_group")
    return init_device_mesh(MESH_DEVICE, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or multi-pod (2, 16, 16)
    ``("pod", "data", "model")``, inside ``fake_process_group(256 or
    512)``."""
    return make_mesh(*PRODUCTION_SHAPES[multi_pod])


def make_local_mesh():
    """1-rank mesh with the production axis names, inside
    ``fake_process_group(1)``."""
    return make_mesh((1, 1), ("data", "model"))
