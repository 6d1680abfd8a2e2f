"""Production mesh construction, as ``DeviceMesh``es.

Single pod: 16x16 = 256 ranks, axes ("data", "model").
Multi-pod: 2x16x16 = 512 ranks, axes ("pod", "data", "model").

A ``DeviceMesh`` needs a process group of its size: the dry-run starts a
fake one (``launch/dryrun.py``), real runs one rank per process.  Defined
as functions so importing this module touches no process group.
"""
from __future__ import annotations


def make_production_mesh(device_type: str, *, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_stage_submesh(mesh, axis: str, lo: int, hi: int):
    """Carve a stage submesh out of the global mesh along one axis
    (per-stage accelerator allocation, paper §3.3): ranks [lo, hi) of
    ``axis`` become the stage's own mesh with the same axis names.  Every
    rank of ``mesh`` calls it, because the new mesh's groups are made
    collectively; a rank outside the submesh gets a mesh it is not in."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh
    idx = mesh.mesh_dim_names.index(axis)
    sl = [slice(None)] * ranks.ndim
    sl[idx] = slice(lo, hi)
    return DeviceMesh(mesh.device_type, ranks[tuple(sl)].clone(),
                      mesh_dim_names=mesh.mesh_dim_names)


# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from NVIDIA's data sheet
# (dense rates, no sparsity): the roofline's peaks per card
PEAK_FLOPS_BF16 = 989e12        # tensor cores, bf16
HBM_BW = 3.35e12                # bytes/s of device memory per card
