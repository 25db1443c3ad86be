"""The meshes, each made by a function (never a module-level constant: a
process holds one default process group, and importing the port sets none
up).

``make_production_mesh`` lays the reference's production meshes, 16x16
(``data``, ``model``) and 2x16x16 (``pod``, ``data``, ``model``), over a
``torch.distributed`` "fake" process group of 512 ranks: no rank but this
process exists and no collective moves a byte, which is all the dry run
needs (``launch/dryrun.py``). The 16x16 mesh takes ranks 0-255, as the
reference's takes 256 of its 512 host devices; this process is rank 0.

``make_dev_mesh`` is a real 1 x N mesh over the ranks that exist: a
one-rank group on a local file store where none is set up (NCCL on the
card, gloo on the CPU; no network), or the caller's group of N ranks.

Each mesh is made with every run of two or more of its dims flattened into
one group as well, so DTensor redistributes a tensor over several mesh
dims in one collective, as GSPMD does, whatever else ran in the process
first (a flattened group, once made, is used by every later redistribution
over those dims).
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

FAKE_WORLD = 512


def init_fake_world(world_size: int = FAKE_WORLD) -> None:
    """Make this process rank 0 of a fake group of ``world_size`` ranks
    (a no-op where that group is already the default)."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        raise RuntimeError(
            f"a {dist.get_backend()} process group of {dist.get_world_size()}"
            " ranks is already set up; the fake mesh needs a process of its "
            "own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _with_flattened_runs(mesh: DeviceMesh) -> DeviceMesh:
    """``mesh``, each run of two or more consecutive dims flattened."""
    names = mesh.mesh_dim_names
    for lo in range(len(names) - 1):
        for hi in range(lo + 2, len(names) + 1):
            mesh[names[lo:hi]]._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world()
    n = 1
    for s in shape:
        n *= s
    return _with_flattened_runs(DeviceMesh(
        "cpu", torch.arange(n).reshape(shape), mesh_dim_names=axes))


def make_dev_mesh() -> DeviceMesh:
    """Whatever is actually there: (1, world size) over ``data``, ``model``;
    world size 1 unless the caller set up a group of more ranks."""
    cuda = torch.cuda.is_available()
    if cuda:                         # the group's device: this process's
        torch.cuda.set_device(torch.cuda.current_device())
    if not dist.is_initialized():
        store = dist.FileStore(os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_mesh_"), "store"), 1)
        dist.init_process_group("nccl" if cuda else "gloo", store=store,
                                rank=0, world_size=1)
    elif dist.get_backend() == "fake":
        raise RuntimeError("this process holds the fake group; a device "
                           "mesh needs a process of its own")
    n = dist.get_world_size()
    return _with_flattened_runs(DeviceMesh(
        "cuda" if cuda else "cpu", torch.arange(n).reshape(1, n),
        mesh_dim_names=("data", "model")))


def mesh_axes(mesh) -> dict:
    """Logical -> physical axis mapping for a mesh."""
    names = mesh.mesh_dim_names
    multi = "pod" in names
    return {
        "batch": ("pod", "data") if multi else ("data",),
        "fsdp": "data",
        "tp": "model",
        "rows": ("pod", "data", "model") if multi else ("data", "model"),
        "edges": ("pod", "data", "model") if multi else ("data", "model"),
        "cands": ("data", "model") if not multi else ("pod", "data", "model"),
        "seq": "model",
        "kv_all": ("pod", "data", "model") if multi else ("data", "model"),
    }
