"""Multi-pod dry run.

For every (architecture x input shape) cell: build the step, lay its
arguments out as DTensors of the cell's shardings on the production mesh
(``FakeTensorMode`` local shards: nothing is allocated), run the step once
under ``roofline.analysis.StepRecorder``, print the per-device memory and
roofline terms (collective bytes from the redistributions DTensor issued)
and append them to a JSON manifest. It needs no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both     # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
        --arch smollm-135m --shape train_4k --set remat=false --tag noremat

The production meshes live on a fake process group of 512 ranks, which
this process joins as rank 0 (``launch/mesh.py``); run a dry run in a
process of its own.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch


def _tree_map2(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map2(fn, v, s)
                          for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def fake_args(args, shardings, fake_mode):
    """Each ``meta`` tensor of ``args`` as a DTensor of its sharding whose
    local shard (this rank's) is a ``fake_mode`` tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(meta, sh):
        local_shape, _ = compute_local_shape_and_global_offset(
            meta.shape, sh.mesh, list(sh.placements))
        with fake_mode:
            local = torch.empty(local_shape, dtype=meta.dtype)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=meta.shape,
                                  stride=meta.stride())
    return _tree_map2(one, args, shardings)


def record_cell(cell):
    """Run ``cell``'s step once on fake DTensors; its ``StepRecord``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.analysis import (record_step,
                                               register_replicated_ops)
    register_replicated_ops()
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = fake_args(cell.args, cell.in_shardings, fake_mode)
    record, _ = record_step(cell.step_fn, args, fake_mode=fake_mode)
    return record


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             manifest: dict, verbose: bool = True,
             probes: bool = False, overrides: dict | None = None,
             tag: str = "") -> dict:
    """Record one cell into ``manifest``. The trace counts every layer
    (``raw_source`` "direct"); ``probes=True`` takes the terms from L=1 and
    L=2 probe runs instead, extrapolated as the reference does."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import build_cell, probe_plan
    from repro_torch.roofline.analysis import (extract_raw, extrapolate_raw,
                                               memory_gb, roofline_from_raw)

    key = f"{arch}/{shape_name}/{mesh_name}" + (f"#{tag}" if tag else "")
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, mesh, overrides)
        record = record_cell(cell)
        raw = extract_raw(record)
        raw_src = "direct"
        plan = probe_plan(arch, overrides) if probes else None
        if plan is not None:
            r1 = extract_raw(record_cell(
                build_cell(arch, shape_name, mesh, plan[0])))
            r2 = extract_raw(record_cell(
                build_cell(arch, shape_name, mesh, plan[1])))
            raw = extrapolate_raw(r1, r2, get_config(arch).n_layers)
            raw_src = "probe-extrapolated(L=1,2)"
        roof = roofline_from_raw(raw, arch=arch, shape=shape_name,
                                 mesh_name=mesh_name, n_dev=mesh.size(),
                                 model_flops=cell.model_flops,
                                 mem_gb=memory_gb(record))
        rec = {
            "status": "ok",
            "kind": cell.kind,
            "raw_source": raw_src,
            "compile_s": round(time.time() - t0, 1),
            "memory_analysis": {
                "argument_gb": round(record.argument_bytes / 2**30, 3),
                "output_gb": round(record.output_bytes / 2**30, 3),
                "temp_gb": round(record.temp_bytes / 2**30, 3),
                "alias_gb": round(record.alias_bytes / 2**30, 3),
                "peak_gb": round(record.peak_bytes / 2**30, 3),
            },
            "roofline": roof.row(),
        }
        if verbose:
            print(f"[{key}] OK compile={rec['compile_s']}s "
                  f"peak/dev={rec['memory_analysis']['peak_gb']}GB "
                  f"bottleneck={roof.bottleneck} "
                  f"terms(ms)=c{roof.row()['compute_ms']}/m"
                  f"{roof.row()['memory_ms']}/x{roof.row()['collective_ms']} "
                  f"useful={roof.useful_ratio:.2f}", flush=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug we record
        rec = {"status": "fail", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:],
               "compile_s": round(time.time() - t0, 1)}
        if verbose:
            print(f"[{key}] FAIL {rec['error']}", flush=True)
    manifest[key] = rec
    return rec


def parse_overrides(pairs: list[str]) -> dict:
    """``key=value`` pairs: true/false, bf16/f32 (torch dtypes), ints, or
    strings."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        elif v in ("bf16", "f32", "fp32", "float32", "bfloat16"):
            overrides[k] = torch.bfloat16 if "b" in v else torch.float32
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = v
    return overrides


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default=None, help="only this arch")
    ap.add_argument("--shape", default=None, help="only this shape")
    ap.add_argument("--out", default="dryrun_manifest_torch.json")
    ap.add_argument("--merge", action="store_true",
                    help="merge into existing manifest instead of overwrite")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (perf iterations), e.g. "
                         "--set remat=false --set causal_skip=true "
                         "--set score_dtype=bf16 --set seq_shard_acts=true "
                         "--set onehot_cache_update=true "
                         "--set shard_encode=true; a key "
                         "an arch's config lacks is ignored for that arch")
    ap.add_argument("--tag", default="", help="manifest key suffix")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.overrides)

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import all_cells

    manifest = {}
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            manifest = json.load(f)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single-pod-16x16",
                       make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi-pod-2x16x16",
                       make_production_mesh(multi_pod=True)))

    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    for mesh_name, mesh in meshes:
        for arch, shape_name in cells:
            run_cell(arch, shape_name, mesh, mesh_name, manifest,
                     overrides=overrides or None, tag=args.tag)
            with open(args.out, "w") as f:
                json.dump(manifest, f, indent=1)

    ok = sum(1 for v in manifest.values() if v.get("status") == "ok")
    print(f"\n{ok}/{len(manifest)} cells OK -> {args.out}")


if __name__ == "__main__":
    main()
