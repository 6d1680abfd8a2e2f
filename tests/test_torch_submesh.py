"""Per-stage accelerator allocation (paper Fig 3(c)): carving stage
submeshes out of the global mesh with ``repro_torch/launch/mesh.py:
make_stage_submesh``, the checks of tests/test_submesh.py on four
``gloo`` ranks of the CPU (a (2, 2) and a (1, 4) mesh), and the dry-run
pipeline's carve of a fake 16x16 world into 128/64/64 ranks."""
import os

import numpy as np
import torch
from test_torch_moe_ep import spawn_ranks

from repro_torch.launch import dryrun as D
from repro_torch.launch import dryrun_pipeline as DP
from repro_torch.launch.mesh import make_production_mesh, make_stage_submesh


def _ranks(mesh) -> set:
    return set(mesh.mesh.flatten().tolist())


def _submesh_rank(rank, world, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import specs as S
    g = torch.Generator().manual_seed(0)
    w, x = torch.randn((16, 16), generator=g), torch.randn((4, 16), generator=g)
    checks = []
    for shape in ((2, 2), (1, 4)):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        half = shape[1] // 2
        # the thinker takes model-axis ranks [0, half), the talker the rest
        stages = [make_stage_submesh(mesh, "model", 0, half),
                  make_stage_submesh(mesh, "model", half, shape[1])]
        a, b = (_ranks(m) for m in stages)
        checks += [a.isdisjoint(b), a | b == _ranks(mesh),
                   all(m.mesh_dim_names == mesh.mesh_dim_names for m in stages),
                   all(tuple(m.mesh.shape) == (shape[0], half) for m in stages)]
        for m in stages:
            # each stage computes on ITS OWN submesh: DTensors over it
            dw = distribute_tensor(w, m, S.placements(m, S.P(None, "model")))
            dx = distribute_tensor(x, m, S.placements(m, S.P("data", None)))
            out = dx @ dw
            checks.append(_ranks(out.device_mesh) <= _ranks(m))
            if rank in _ranks(m):
                checks.append(bool(torch.allclose(out.full_tensor(), x @ w, atol=1e-5)))
            else:                                   # a rank outside holds nothing of it
                checks.append(out.to_local().numel() == 0)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.array(checks))


def test_stage_submesh_allocation(tmp_path):
    spawn_ranks(_submesh_rank, 4, tmp_path, str(tmp_path))
    for r in range(4):
        checks = np.load(tmp_path / f"rank{r}.npy")
        assert checks.size >= 16 and checks.all(), (r, checks)


def test_pipeline_carve_of_the_production_mesh():
    with D.fake_world(256):
        mesh = make_production_mesh("cpu")
        subs = DP.carve(mesh)
        assert [m.mesh.numel() for m in subs] == [128, 64, 64]
        sets = [_ranks(m) for m in subs]
        assert sets[0].isdisjoint(sets[1]) and sets[1].isdisjoint(sets[2])
        assert sets[0].isdisjoint(sets[2])
        assert set().union(*sets) == set(range(256))
        assert all(m.mesh_dim_names == ("data", "model") for m in subs)
        assert [tuple(m.mesh.shape) for m in subs] == [(16, 8), (16, 4), (16, 4)]
        # each stage's rank lies inside its own submesh
        assert all(lo in s for (_, lo, _), s in zip(DP.STAGES, sets))
