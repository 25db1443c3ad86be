"""The port's multi-architecture dry run (``repro_torch.launch.{steps,
dryrun,mesh}``, ``repro_torch.configs.base.input_specs``) against the JAX
package's, on the CPU. Nothing here needs a card.

- ``input_specs``: the same names, shapes and dtypes for every cell of
  ``all_cells()``.
- The cells: every cell built on the reference's one-device
  ``make_dev_mesh()`` and on the port's (a one-rank gloo group, in a
  subprocess) has the reference's kind, model FLOPs (exactly), argument
  names, shapes and dtypes, and sharding specs (the port's placements
  mapped back to spec tuples).
- The dry run itself, each in a subprocess of its own (a process holds one
  default process group; the dry run's is a fake one of 512 ranks):
  colberter/serve_q32 on both meshes and with ``--set shard_encode=true``;
  per-device FLOPs are counted on the local shards (a product sharded 32
  ways on its rows counts 1/32 of the global product); smollm-135m's
  decode_32k counted directly equals its L=1 and L=2 probes extrapolated;
  and on a one-device mesh, the dry run's product FLOPs equal
  ``FlopCounterMode``'s count of the same step on plain tensors (the card's
  check, rehearsed).
- The dry run's terms against the reference's own dry run of the same
  cells (``_torch_dry_ref``: compiled by the reference, its collectives
  counted from the partitioned HLO tuple-aware): the same collective kinds,
  the wire bytes of each kind within 10%, FLOPs within 25%, equal argument
  bytes and peaks within 1.5x either way; and every ``fm`` cell counts
  FLOPs.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

from _torch_dry_ref import count_collectives
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import input_specs as ref_input_specs
from repro.configs.base import shapes_for as ref_shapes_for
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro_torch.configs.base import get_config, input_specs, shapes_for
from repro_torch.launch.steps import all_cells

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
CELLS = all_cells()
IDS = [f"{a}/{s}" for a, s in CELLS]


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _script(code: str, *args, timeout=600) -> dict:
    r = _run(["-c", code, *args], timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _dtype(d) -> str:
    return str(d).split(".")[-1] if "torch" in str(d) else jnp.dtype(d).name


def test_all_cells_are_the_reference_cells():
    assert CELLS == ref_steps.all_cells() and len(CELLS) == 42


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_input_specs_equal_reference(cell):
    arch, shape = cell
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    got = input_specs(cfg, shapes_for(cfg)[shape])
    want = ref_input_specs(ref_cfg, ref_shapes_for(ref_cfg)[shape])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert _dtype(t.dtype) == _dtype(want[k].dtype), k


# -- the cells on the one-device meshes ---------------------------------------

_PORT_CELLS = r"""
import json
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models.layers import Sharding
from repro_torch.launch.steps import all_cells, build_cell

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out

def dims(sh):
    assert isinstance(sh, Sharding)
    return [p.dim if p.is_shard() else None for p in sh.placements]

mesh = make_dev_mesh()
out = {"names": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
       "cells": {}}
for arch, shape in all_cells():
    c = build_cell(arch, shape, mesh)
    out["cells"][f"{arch}/{shape}"] = {
        "kind": c.kind, "model_flops": c.model_flops,
        "args": {k: [list(t.shape), str(t.dtype), t.device.type]
                 for k, t in flat(c.args).items()},
        "in": {k: dims(s) for k, s in flat(c.in_shardings).items()},
        "out": {k: dims(s) for k, s in flat(c.out_shardings).items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_cells():
    return _script(_PORT_CELLS)


def _ref_flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(_ref_flat(v, f"{prefix}{k}/"))
    return out


def _spec(entries, ndim=None) -> list:
    """A spec as one tuple of mesh axes per tensor dim, trailing
    replicated dims dropped where ``ndim`` is None."""
    out = [() if a is None else (a,) if isinstance(a, str) else tuple(a)
           for a in entries]
    if ndim is not None:
        return out + [()] * (ndim - len(out))
    while out and out[-1] == ():
        out.pop()
    return out


def _port_spec(dims, names, ndim=None) -> list:
    n = ndim if ndim is not None else max(
        [d + 1 for d in dims if d is not None], default=0)
    return _spec([tuple(a for a, d in zip(names, dims) if d == i)
                  for i in range(n)], ndim)


@pytest.fixture(scope="module")
def ref_dev_mesh():
    return ref_mesh.make_dev_mesh()


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_cell_equals_reference(cell, port_cells, ref_dev_mesh):
    arch, shape = cell
    names = port_cells["names"]
    assert names == list(ref_dev_mesh.axis_names) == ["data", "model"]
    assert port_cells["shape"] == [1, 1]
    got = port_cells["cells"][f"{arch}/{shape}"]
    ref = ref_steps.build_cell(arch, shape, ref_dev_mesh)
    assert got["kind"] == ref.kind
    assert got["model_flops"] == ref.model_flops
    ref_args = _ref_flat(ref.args)
    assert set(got["args"]) == set(ref_args)
    for k, (shp, dt, dev) in got["args"].items():
        assert dev == "meta"
        assert tuple(shp) == tuple(ref_args[k].shape), k
        assert _dtype(dt) == _dtype(ref_args[k].dtype), k
    ref_in = _ref_flat(ref.in_shardings)
    assert set(got["in"]) == set(ref_in) == set(ref_args)
    for k, dims in got["in"].items():
        ndim = len(ref_args[k].shape)
        assert (_port_spec(dims, names, ndim)
                == _spec(ref_in[k].spec, ndim)), k
    ref_out = _ref_flat(ref.out_shardings)
    assert set(got["out"]) == set(ref_out)
    for k, dims in got["out"].items():
        assert _port_spec(dims, names) == _spec(ref_out[k].spec), k


# -- the dry run ----------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_cell_runs(tmp_path, mesh):
    out = tmp_path / "m.json"
    r = _run(["-m", "repro_torch.launch.dryrun", "--mesh", mesh, "--arch",
              "colberter", "--shape", "serve_q32", "--out", str(out)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    m = json.loads(out.read_text())
    (key,) = m.keys()
    assert key == ("colberter/serve_q32/" + ("single-pod-16x16"
                                             if mesh == "single"
                                             else "multi-pod-2x16x16"))
    rec = m[key]
    assert rec["status"] == "ok", rec
    assert rec["raw_source"] == "direct" and rec["kind"] == "serve"
    ma = rec["memory_analysis"]
    assert 0 < ma["peak_gb"] < 16.0
    assert ma["peak_gb"] == pytest.approx(
        ma["argument_gb"] + ma["output_gb"] + ma["temp_gb"]
        - ma["alias_gb"], abs=2e-3)
    roof = rec["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert roof["compute_ms"] > 0 and roof["memory_ms"] > 0
    assert roof["flops_per_dev"] > 0 and roof["bytes_per_dev"] > 0


def test_dryrun_override_flags(tmp_path):
    """``--set shard_encode=true`` encodes the queries over the whole mesh
    and reshards them for the MaxSim. The reference's own test of this
    (``tests/test_dryrun.py::test_dryrun_override_flags``) fails on jax
    0.9.0: ``jax.make_mesh`` gives Explicit axes by default, and
    ``with_sharding_constraint`` refuses them; the port redistributes
    DTensors and runs."""
    out = tmp_path / "m.json"
    r = _run(["-m", "repro_torch.launch.dryrun", "--mesh", "single",
              "--arch", "colberter", "--shape", "serve_q32", "--set",
              "shard_encode=true", "--tag", "t", "--out", str(out)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    m = json.loads(out.read_text())
    (key,) = m.keys()
    assert key.endswith("#t")
    assert m[key]["status"] == "ok", m[key]
    # the reshard to the MaxSim's layout shows as collectives
    assert m[key]["roofline"]["wire_bytes_per_dev"] > 0


_TOY = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.dryrun import fake_args
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models.layers import Sharding
from repro_torch.roofline.analysis import record_step
init_fake_world()
mesh = DeviceMesh("cpu", torch.arange(32), mesh_dim_names=("rows",))
fm = FakeTensorMode(allow_non_fake_inputs=True)
a = torch.empty(1024, 4096, device="meta")
b = torch.empty(4096, 4096, device="meta")
args = fake_args((a, b), (Sharding(mesh, (Shard(0),)),
                          Sharding(mesh, (Replicate(),))), fm)
rec, out = record_step(lambda x, y: x @ y, args, fake_mode=fm)
with FlopCounterMode(display=False) as above:      # above DTensor: global
    args[0] @ args[1]
print(json.dumps({"flops": rec.flops, "above": above.get_total_flops(),
                  "wire": rec.coll.wire_bytes,
                  "local": list(out.to_local().shape),
                  "out_bytes": rec.output_bytes}))
"""


def test_per_device_flops_are_local_shard_counts():
    got = _script(_TOY)
    assert got["flops"] == 2 * 32 * 4096 * 4096
    assert got["above"] == 2 * 1024 * 4096 * 4096
    assert got["local"] == [32, 4096] and got["wire"] == 0
    assert got["out_bytes"] == 32 * 4096 * 4


_PROBES = r"""
import json
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh(multi_pod=False)
m = {}
out = {}
for probes in (False, True):
    rec = run_cell("smollm-135m", "decode_32k", mesh, "single-pod-16x16", m,
                   verbose=False, probes=probes)
    assert rec["status"] == "ok", rec
    out[str(probes)] = {"src": rec["raw_source"], **rec["roofline"]}
print(json.dumps(out))
"""


def test_probe_extrapolation_equals_direct_count():
    got = _script(_PROBES)
    direct, probed = got["False"], got["True"]
    assert direct["src"] == "direct"
    assert probed["src"] == "probe-extrapolated(L=1,2)"
    for k in ("flops_per_dev", "bytes_per_dev", "wire_bytes_per_dev"):
        assert probed[k] == pytest.approx(direct[k], rel=1e-9), k
    assert direct["flops_per_dev"] > 0 and direct["wire_bytes_per_dev"] > 0
    assert probed["counts"] == direct["counts"]


_DEV_MESH = r"""
import json
import torch
from torch.utils.flop_counter import FlopCounterMode
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import record_cell
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.steps import build_cell
mesh = make_dev_mesh()
out = {}
for arch, shape in (("colberter", "serve_q32"), ("fm", "serve_p99"),
                    ("gatedgcn", "full_graph_sm")):
    cell = build_cell(arch, shape, mesh)
    rec = record_cell(cell)
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    def plain(t):
        if isinstance(t, dict):
            return {k: plain(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(plain(v) for v in t)
        with fm:
            return torch.empty(t.shape, dtype=t.dtype)
    args = plain(cell.args)
    with fm, FlopCounterMode(display=False) as fc:
        cell.step_fn(*args)
    out[f"{arch}/{shape}"] = {"dry": rec.product_flops,
                              "plain": fc.get_total_flops(),
                              "all": rec.flops, "peak": rec.peak_bytes,
                              "args": rec.argument_bytes,
                              "wire": rec.coll.wire_bytes}
print(json.dumps(out))
"""


def test_dev_mesh_dry_run_counts_what_flop_counter_counts():
    """The card's check, on the CPU with fake tensors: on a one-device
    mesh the dry run's per-device product FLOPs are ``FlopCounterMode``'s
    count of the same step on plain tensors, the whole count (elementwise
    work included) lies above them, and no byte crosses a wire."""
    got = _script(_DEV_MESH)
    assert set(got) == {"colberter/serve_q32", "fm/serve_p99",
                        "gatedgcn/full_graph_sm"}
    for cell, r in got.items():
        assert r["dry"] == r["plain"], cell
        assert r["all"] > r["dry"], cell
        assert r["wire"] == 0, cell
        assert r["peak"] >= r["args"] > 0, cell
    assert got["colberter/serve_q32"]["dry"] > 0
    assert got["gatedgcn/full_graph_sm"]["dry"] > 0


# -- the dry run's terms against the reference's ------------------------------

# The cells whose reference dry run compiles on this jax (its LM cells do
# not: ``tests/test_dryrun.py::test_dryrun_override_flags``' cause):
# colberter on both meshes, RecSys cells of every lookup layout (the table
# sliced where it lies, gathered, or both; the in-batch logits) and one GNN
# cell.
VS_REF = (("colberter", "serve_q32", "single"),
          ("colberter", "serve_q32", "multi"),
          ("fm", "serve_p99", "single"),
          ("fm", "retrieval_cand", "single"),
          ("dlrm-mlperf", "serve_bulk", "single"),
          ("dlrm-mlperf", "retrieval_cand", "single"),
          ("two-tower-retrieval", "train_batch", "single"),
          ("two-tower-retrieval", "serve_bulk", "single"),
          ("gatedgcn", "full_graph_sm", "single"))
MESH_NAMES = {"single": "single-pod-16x16", "multi": "multi-pod-2x16x16"}
FM_CELLS = tuple(("fm", s, "single") for s in ("train_batch", "serve_p99",
                                               "serve_bulk", "retrieval_cand"))

PEAK_FACTOR = 1.5        # port's peak_gb / the reference's, either way
ARG_TOL_GB = 2e-3        # argument_gb: equal but for the records' rounding
WIRE_TOL = 0.10          # each kind's wire bytes, port / reference - 1
FLOPS_TOL = 0.25         # FLOPs, port / reference - 1
# Cells whose FLOPs XLA counts beyond what the step computes, and the band
# the port's count is held to instead: fm/retrieval_cand counts 8.12e6
# FLOPs a device against XLA's 16.73e6. XLA adds the reference's
# ``jnp.take`` semantics (each id wrapped if negative and range-checked,
# each looked-up value selected against a NaN fill: ~3.5e6), a padded
# reduce-window for the sum over the 39 fields (~2.0e6) and the bf16
# round trip recomputed in two fusions (~3.0e6); the port's lookup and
# sums do none of that work.
FLOPS_APART = {"fm/retrieval_cand": (0.45, 1.0)}

_PORT_DRY = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh
cells = json.loads(sys.argv[1])
names = {"single": "single-pod-16x16", "multi": "multi-pod-2x16x16"}
meshes, out = {}, {}
for arch, shape, m in cells:
    if m not in meshes:
        meshes[m] = make_production_mesh(multi_pod=m == "multi")
    rec = run_cell(arch, shape, meshes[m], names[m], out, verbose=False)
    rec.pop("trace", None)
print(json.dumps(out))
"""


def _start(args, env):
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _last_json(proc, timeout=900) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dry_vs_ref():
    """Both packages' records of ``VS_REF`` and the fm cells, each package in a process of its own, the two at once. The
    reference's: ``_torch_dry_ref`` (its jax must start with the reference's
    ``XLA_FLAGS``, which its dry-run module sets)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    cells = json.dumps(VS_REF + tuple(c for c in FM_CELLS if c not in VS_REF))
    ref = _start([os.path.join(REPO, "tests", "_torch_dry_ref.py"), cells],
                 dict(env, PYTHONPATH=SRC + os.pathsep
                      + os.path.join(REPO, "tests")))
    port = _start(["-c", _PORT_DRY, cells],
                  dict(os.environ, PYTHONPATH=SRC))
    return {"ref": _last_json(ref), "port": _last_json(port)}


# two collectives of the reference's partitioned HLO of dlrm-mlperf's
# serve_bulk on 16x16: one of its eight ids gathers, and the one all-reduce
# that sums the eight tables' partial rows (a tuple, which
# ``parse_collectives`` does not match)
_HLO = """\
  %all-gather.7 = s32[262144,1]{1,0} all-gather(%select_bitcast_fusion.4), \
channel_id=55, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}, \
use_global_device_ids=true
  %all-reduce.8 = (f32[262144,128]{1,0}, f32[262144,128]{1,0}, \
f32[262144,128]{1,0}, f32[262144,128]{1,0}, f32[262144,128]{1,0}, \
/*index=5*/f32[262144,128]{1,0}, f32[262144,128]{1,0}, \
f32[262144,128]{1,0}) all-reduce(%bitcast_select_fusion.7), channel_id=28, \
replica_groups=[1,256]<=[256], use_global_device_ids=true, to_apply=%add
  %get-tuple-element.2 = f32[262144,128]{1,0} get-tuple-element(\
%all-reduce.8), index=0
  %collective-permute = f32[392,256]{1,0} collective-permute(%p), \
channel_id=50, source_target_pairs={{0,0},{1,16},{16,1}}
  ROOT %all-gather.2 = f32[32,32]{1,0} all-gather(%f), channel_id=3, \
replica_groups={{0,16,32,48},{1,17,33,49}}, dimensions={0}
  %all-reduce.9 = f32[64]{0} all-reduce(%x), replica_groups={}, to_apply=%add
"""


def test_tuple_aware_count_of_hlo_lines():
    """``_torch_dry_ref.count_collectives`` on literal HLO lines: a tuple
    all-reduce's elements are all counted, a group comes from either form
    of ``replica_groups``, a permute bills its result, a group of one
    nothing; the reference's own parser misses the tuple."""
    from repro.roofline.analysis import parse_collectives
    got = count_collectives(_HLO)
    assert got.counts == {"all-gather": 2, "all-reduce": 1,
                          "collective-permute": 1}
    rows = 8 * 262144 * 128 * 4
    assert got.by_kind["all-reduce"] == 2.0 * rows * 255 / 256
    assert got.by_kind["all-gather"] == (262144 * 4 * 15 / 16
                                         + 32 * 32 * 4 * 3 / 4)
    assert got.by_kind["collective-permute"] == 392 * 256 * 4
    assert got.by_kind["all-reduce"] == pytest.approx(2.139e9, rel=1e-3)
    assert got.wire_bytes == sum(got.by_kind.values())
    assert "all-reduce" not in parse_collectives(_HLO).counts


@pytest.mark.parametrize("cell", VS_REF, ids=[f"{a}/{s}/{m}"
                                              for a, s, m in VS_REF])
def test_dry_run_terms_match_the_reference(cell, dry_vs_ref):
    """The port's record of a cell against the reference's on the same
    mesh (``_torch_dry_ref``: XLA's cost and memory analysis, the
    collectives of its partitioned HLO counted tuple-aware). The same
    collective kinds, each kind's wire bytes within ``WIRE_TOL``; FLOPs as
    XLA's cost analysis counts them, within ``FLOPS_TOL`` (``FLOPS_APART``
    says where XLA counts work the step does not do); argument bytes equal
    and peaks within ``PEAK_FACTOR``. Bytes moved are not compared: the
    port's are unfused op by op, XLA's those of its fusions."""
    arch, shape, m = cell
    key = f"{arch}/{shape}/{MESH_NAMES[m]}"
    ref, port = dry_vs_ref["ref"][key], dry_vs_ref["port"][key]
    assert port["status"] == "ok", port
    pr = port["roofline"]
    lo, hi = FLOPS_APART.get(f"{arch}/{shape}", (1 - FLOPS_TOL,
                                                 1 + FLOPS_TOL))
    assert lo * ref["flops"] <= pr["flops_per_dev"] <= hi * ref["flops"]
    assert set(pr["wire_by_kind"]) == set(ref["by_kind"])
    for kind, wire in ref["by_kind"].items():
        assert pr["wire_by_kind"][kind] == pytest.approx(
            wire, rel=WIRE_TOL), kind
    pm = port["memory_analysis"]
    assert pm["argument_gb"] == pytest.approx(ref["argument_gb"],
                                              abs=ARG_TOL_GB)
    assert (ref["peak_gb"] / PEAK_FACTOR <= pm["peak_gb"]
            <= ref["peak_gb"] * PEAK_FACTOR)


def test_two_tower_train_batch_wire_and_peak(dry_vs_ref):
    """two-tower-retrieval/train_batch on 16x16, the cell furthest from
    the reference before its in-batch logits took GSPMD's layout: at most
    1.1x the reference's 1.51 GB of wire and 1.5x its 6.72 GB peak."""
    port = dry_vs_ref["port"][
        "two-tower-retrieval/train_batch/single-pod-16x16"]
    assert port["roofline"]["wire_bytes_per_dev"] <= 1.66e9
    assert port["memory_analysis"]["peak_gb"] <= 10.1


@pytest.mark.parametrize("cell", FM_CELLS, ids=[s for _, s, _ in FM_CELLS])
def test_fm_cells_count_flops(cell, dry_vs_ref):
    """fm runs no matrix product: its FLOPs are its elementwise work, more
    than none, and its useful ratio (model FLOPs over the devices' FLOPs)
    is of the reference's order: the FLOPs within 4x of XLA's either way
    (fm/train_batch counts 0.31x: XLA recounts the bf16 round trip of the
    (4,096, 39, 10) lookups in each of 80 fusions, and sums the stacked
    fields' gradient in 78 full-size adds)."""
    key = "/".join(cell[:2]) + "/" + MESH_NAMES[cell[2]]
    pr, ref = dry_vs_ref["port"][key]["roofline"], dry_vs_ref["ref"][key]
    assert pr["flops_per_dev"] > 0 and pr["product_flops_per_dev"] == 0
    assert ref["flops"] / 4 <= pr["flops_per_dev"] <= 4 * ref["flops"]
    assert 0 < pr["useful_ratio"] < float("inf")


# -- the reference's knobs in the dry run --------------------------------------

_KNOBS = r"""
import json, sys
from repro_torch.launch import dryrun
out = sys.argv[1]
runs = (("train_4k", "", ()), ("train_4k", "remat_true", ("remat=true",)),
        ("train_4k", "remat_false", ("remat=false",)),
        ("train_4k", "causal_skip", ("causal_skip=true",)),
        ("train_4k", "score_bf16", ("score_dtype=bf16",)),
        ("train_4k", "seq_shard", ("seq_shard_acts=true",)),
        ("decode_32k", "", ()), ("decode_32k", "onehot",
                                 ("onehot_cache_update=true",)))
for shape, tag, sets in runs:
    args = ["--mesh", "single", "--arch", "smollm-135m", "--shape", shape,
            "--set", "n_layers=2", "--out", out, "--merge"]
    for kv in sets:
        args += ["--set", kv]
    if tag:
        args += ["--tag", tag]
    dryrun.main(args)
print(json.dumps(json.load(open(out))))
"""


def test_dryrun_lm_knobs_change_the_record(tmp_path):
    """``--set`` reaches the LM's knobs, as it reaches the reference's
    model (smollm-135m at 2 layers on 16x16, train_4k and decode_32k):
    ``remat=true`` is the default's record; ``remat=false`` keeps every
    layer's working set (peak up) and recomputes nothing (FLOPs down);
    ``causal_skip`` skips the chunks above the diagonal (FLOPs and bytes
    down); ``score_dtype=bf16`` halves the score blocks (bytes down);
    ``seq_shard_acts`` keeps the residuals sequence-sharded (peak down);
    ``onehot_cache_update`` writes the whole cache (bytes up)."""
    got = _script(_KNOBS, str(tmp_path / "m.json"), timeout=600)

    def rec(shape, tag=""):
        r = got[f"smollm-135m/{shape}/single-pod-16x16"
                + (f"#{tag}" if tag else "")]
        assert r["status"] == "ok", r
        return (r["memory_analysis"]["peak_gb"], r["roofline"])

    peak, base = rec("train_4k")
    same_peak, same = rec("train_4k", "remat_true")
    assert same_peak == peak
    for k in ("flops_per_dev", "bytes_per_dev", "wire_bytes_per_dev",
              "counts"):
        assert same[k] == base[k], k
    off_peak, off = rec("train_4k", "remat_false")
    assert off_peak > peak and off["flops_per_dev"] < base["flops_per_dev"]
    _, skip = rec("train_4k", "causal_skip")
    assert skip["flops_per_dev"] < base["flops_per_dev"]
    assert skip["bytes_per_dev"] < base["bytes_per_dev"]
    _, bf16 = rec("train_4k", "score_bf16")
    assert bf16["bytes_per_dev"] < base["bytes_per_dev"]
    sharded_peak, _ = rec("train_4k", "seq_shard")
    assert sharded_peak < peak
    _, dec = rec("decode_32k")
    _, onehot = rec("decode_32k", "onehot")
    assert onehot["bytes_per_dev"] > dec["bytes_per_dev"]


_EDGE_COLLECTIVES = r"""
import json
from repro_torch.launch.dryrun import record_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.roofline import analysis
seen = []
dispatch = analysis.StepRecorder.__torch_dispatch__
def spy(self, func, types, args=(), kwargs=None):
    if func.namespace in ("_c10d_functional", "_dtensor"):
        seen.append([func._overloadpacket.__name__,
                     [list(t.shape) for t in analysis._tensors(args)]])
    return dispatch(self, func, types, args, kwargs)
analysis.StepRecorder.__torch_dispatch__ = spy
cell = build_cell("gatedgcn", "full_graph_sm",
                  make_production_mesh(multi_pod=False))
rec = record_cell(cell)
print(json.dumps({"seen": seen, "counts": rec.coll.counts,
                  "edges": list(cell.args[2]["edge_src"].shape)}))
"""


def test_gatedgcn_moves_no_edge_sized_tensor():
    """gatedgcn/full_graph_sm on the 16x16 mesh, its edges split over all
    256 devices: every segment sum (forward, and the gathers' backward) is
    made whole by one all-reduce of (nodes, D) partials; no collective has
    an operand of the edges' length, global (10,752) or local (42)."""
    got = _script(_EDGE_COLLECTIVES)
    (n_edges,) = got["edges"]
    assert set(got["counts"]) == {"all-reduce"}
    ops = [s for op, shapes in got["seen"] for s in shapes
           if op not in ("wait_tensor",)]
    assert ops
    for shape in ops:
        assert n_edges not in shape and n_edges // 256 not in shape, shape


_DEV_MESH_REMAT = r"""
import json
import torch
from torch.utils.flop_counter import FlopCounterMode
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import record_cell
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.steps import lm_cell
mesh = make_dev_mesh()
shape = ShapeSpec("train_4k", "train", {"seq_len": 2048, "global_batch": 2})
out = {}
for remat in (True, False):
    cfg = get_config("smollm-135m").scaled(n_layers=2, remat=remat)
    cell = lm_cell(cfg, shape, mesh)
    rec = record_cell(cell)
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    def plain(t):
        if isinstance(t, dict):
            return {k: plain(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(plain(v) for v in t)
        with fm:
            return torch.empty(t.shape, dtype=t.dtype)
    with fm, FlopCounterMode(display=False) as fc:
        cell.step_fn(*plain(cell.args))
    out[str(remat)] = {"dry": rec.product_flops,
                       "plain": fc.get_total_flops(),
                       "peak": rec.peak_bytes, "wire": rec.coll.wire_bytes}
print(json.dumps(out))
"""


def test_dev_mesh_remat_step_counts_what_flop_counter_counts():
    """The card's check of an LM training step, rehearsed on the CPU with
    fake tensors (smollm-135m at 2 layers, 2 x 2,048 tokens, two kv chunks,
    on a one-device mesh): with and without ``remat`` the dry run's FLOPs
    are ``FlopCounterMode``'s count of the same step on plain tensors, the
    recomputed layers included (the products: ``FlopCounterMode`` knows
    no other op); remat adds FLOPs and lowers the peak."""
    got = _script(_DEV_MESH_REMAT)
    for remat, r in got.items():
        assert r["dry"] == r["plain"] > 0, remat
        assert r["wire"] == 0, remat
    assert got["True"]["dry"] > got["False"]["dry"]
    assert got["True"]["peak"] < got["False"]["peak"]

