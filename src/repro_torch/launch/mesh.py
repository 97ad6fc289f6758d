"""Production mesh builders (the JAX package's ``launch/mesh.py``).

Defined as FUNCTIONS, so importing this module touches no
``torch.distributed`` state: only the dry run builds the production mesh,
and nothing on a serving or training path ever does.

The production mesh is the counterpart of the JAX dry run's 512 forced
host devices: a ``DeviceMesh`` over torch's ``fake`` process group, one
process that plays rank 0 of a 256- or 512-rank world.  The fake group
executes nothing (its collectives return at once and move no bytes); it
gives DTensor the many-device view under which the dry run traces a step
on fake tensors and counts what each device would compute, hold and send.
"""
from __future__ import annotations

from typing import Tuple

import torch

SINGLE_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = (
    (16, 16), ("data", "model"))
MULTI_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = (
    (2, 16, 16), ("pod", "data", "model"))


def _register_fake_backend(dist) -> None:
    """torch registers the ``fake`` backend's constructor only when its
    test helpers are imported; register the same constructor here."""
    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is not None:
            return make(common_opts.group_rank, common_opts.group_size,
                        backend_opts)
        return FakeProcessGroup(common_opts.group_rank,
                                common_opts.group_size)

    dist.Backend.register_backend(dist.Backend.FAKE, create,
                                  extended_api=True,
                                  devices=["cpu", "cuda"])


def _ensure_world(backend: str, world: int) -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world:
            raise RuntimeError(
                f"a process group of {have} ranks exists; this mesh needs "
                f"{world} (destroy it first: "
                "torch.distributed.destroy_process_group())")
        return
    if backend == "fake":
        _register_fake_backend(dist)
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model").
    Built over a fake process group of that size, created when no group
    exists; an existing group of another size raises."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    _ensure_world("fake", int(torch.Size(shape).numel()))
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(device_type: str = "cuda"):
    """Degenerate 1x1 ("data", "model") mesh over a one-rank group on the
    real device: nccl on the card, gloo on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    _ensure_world("nccl" if device_type == "cuda" else "gloo", 1)
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def destroy_mesh() -> None:
    """Destroy the process group a mesh builder created (the fake group is
    process-global: a test or phase that made one tears it down)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# H100 SXM5 hardware model used for the roofline analysis (per GPU).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s: datasheet, dense bf16 tensor core
HBM_BANDWIDTH = 3.35e12         # B/s: datasheet, HBM3
# B/s per GPU for collectives: datasheet, one 400 Gb/s NDR InfiniBand link
# per GPU.  The 16-wide "model" axis spans two 8-GPU nodes, so its rings
# cross that link; NVLink's 450 GB/s a direction holds only inside a node.
ICI_BANDWIDTH = 50e9
HBM_BYTES = 80 * 10 ** 9        # capacity: datasheet, 80 GB
