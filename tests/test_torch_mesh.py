"""repro_torch.launch.mesh: the production meshes over a running group.

The meshes are laid over fake process groups (``torch.testing``'s
``FakeStore``, backend "fake") of 256, 512 and 8 ranks. A default group is
process-global, so the groups run in one subprocess (the module's
problem), which reports what it built as JSON. The reference builds its
meshes from jax devices; its shapes and axis names are held here to the
reference's source of truth, ``jax.sharding.AbstractMesh``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

_SRC = str(Path(__file__).resolve().parents[1] / "src")

_SCRIPT = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as M

out = {}

def err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None

out["no_group"] = err(lambda: M.make_production_mesh(device_type="cpu"))
out["no_group_host"] = err(lambda: M.make_host_mesh(2, device_type="cpu"))
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    m = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    out[str(world)] = [list(m.shape), list(m.mesh_dim_names), m.device_type,
                       list(M.MeshShape.of(m).sizes)]
    out[f"{world}_wrong"] = err(lambda: M.make_production_mesh(multi_pod=not multi,
                                                               device_type="cpu"))
    dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
out["host"] = [list(M.make_host_mesh(2, device_type="cpu").shape),
               list(M.make_host_mesh(device_type="cpu").shape)]
out["host_3"] = err(lambda: M.make_host_mesh(3, device_type="cpu"))
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def built():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [_SRC, os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("world,multi", [(256, False), (512, True)])
def test_production_mesh_matches_the_reference(built, world, multi):
    from jax.sharding import AbstractMesh

    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    ref = AbstractMesh(shape, axes)           # the reference's make_production_mesh shape
    sizes, names, device_type, ms = built[str(world)]
    assert tuple(sizes) == tuple(ref.shape.values()) == tuple(ms)
    assert tuple(names) == tuple(ref.axis_names)
    assert device_type == "cpu"


def test_a_group_of_another_size_is_refused(built):
    assert "needs 512 ranks" in built["256_wrong"]
    assert "needs 256 ranks" in built["512_wrong"]
    assert "none is running" in built["no_group"]
    assert "no group" in built["no_group_host"]


def test_host_mesh(built):
    assert built["host"] == [[4, 2], [8, 1]]
    assert "must divide" in built["host_3"]


def test_mesh_shape_without_a_group():
    from repro_torch.launch.mesh import MeshShape, production_shape

    m = production_shape(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert MeshShape.of(m) is m
    assert production_shape() == MeshShape((16, 16), ("data", "model"))
