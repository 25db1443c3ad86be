"""The reference's dry run of a cell, its collectives counted from the
partitioned HLO tuple-aware (test-only).

``repro.roofline.analysis.parse_collectives`` reads one shape before the
op's name, so it misses a combined collective, whose result is a tuple
(``%all-reduce.8 = (f32[262144,128]{1,0}, ...) all-reduce(...)``): GSPMD
sums the partial rows of all a step's lookups in one such all-reduce.
``count_collectives`` reads every collective line, tuple-shaped ones
included, and gives each its wire bytes by the reference's formula (the
tuple's bytes summed; the group from ``replica_groups``).

``reference_records`` compiles cells through the reference's own
``launch.steps.build_cell`` and ``launch.dryrun._compile`` (layered archs
through its L=1 and L=2 probes and ``extrapolate_raw``, as its ``run_cell``
does on 16x16, on either mesh: XLA counts a layer loop's body once) and
returns, per cell, the compiler's FLOPs, transcendentals and
bytes, this count of the collectives, and the memory analysis. The
reference sets ``XLA_FLAGS`` (512 host devices) when its dry-run module is
imported, before jax starts, so this runs in a process of its own:

    PYTHONPATH=src:tests python tests/_torch_dry_ref.py \
        '[["fm", "serve_p99", "single"]]'

prints one JSON object, keyed ``arch/shape/mesh-name``; with ``--table
MANIFEST`` (the port's dry-run manifest of the same cells) it prints a
markdown table of the two side by side instead: wire bytes by kind, the
peak and the FLOPs a device.
"""
from __future__ import annotations

import json
import re
import sys

from repro.roofline.analysis import (CollectiveStats, _GROUPS_IOTA_RE,
                                     _GROUPS_RE, _shape_bytes)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
MESH_NAMES = {"single": "single-pod-16x16", "multi": "multi-pod-2x16x16"}

# ``%name = <shape or (tuple of shapes)> kind(`` ; the result's type is all
# that stands between the ``=`` and the op's name
_LINE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.+?)\s+("
    + "|".join(KINDS) + r")(-start)?\(")


def _group_size(line: str) -> int:
    gm = _GROUPS_RE.search(line)
    if gm:
        ids = gm.group(1)
        return ids.count(",") + 1 if ids else 1
    gi = _GROUPS_IOTA_RE.search(line)
    return int(gi.group(2)) if gi else 1


def _wire(kind: str, out_bytes: float, g: int) -> float | None:
    """The reference's ring formula (``parse_collectives``), None where it
    counts nothing."""
    if g <= 1 and kind != "collective-permute":
        return None
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes


def count_collectives(hlo_text: str) -> CollectiveStats:
    """Every collective of ``hlo_text``, one a line, tuple-shaped results
    included (their elements' bytes summed)."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _LINE_RE.match(line)
        if not m:
            continue
        if m.group(3):
            # an async start's tuple holds its operands beside its results;
            # the CPU backend, which the dry run compiles for, issues none
            raise ValueError(f"async collective: {line[:200]}")
        wire = _wire(m.group(2), _shape_bytes(m.group(1)), _group_size(line))
        if wire is not None:
            stats.add(m.group(2), wire)
    return stats


def _raw(compiled) -> dict:
    ca = compiled.cost_analysis() or {}
    if isinstance(ca, (list, tuple)):
        ca = {k: sum(float(p.get(k, 0.0)) for p in ca)
              for k in ("flops", "transcendentals", "bytes accessed")}
    coll = count_collectives(compiled.as_text())
    return {"flops": float(ca.get("flops", 0.0)),
            "transcendentals": float(ca.get("transcendentals", 0.0)),
            "bytes": float(ca.get("bytes accessed", 0.0)),
            "wire_bytes": coll.wire_bytes, "by_kind": dict(coll.by_kind),
            "counts": dict(coll.counts)}


def reference_records(cells) -> dict:
    """(arch, shape, "single" | "multi") -> the reference's record (see the
    module's docstring). Imports the reference's dry run: call it in a
    process whose jax has not started."""
    from repro.launch.dryrun import _compile       # sets XLA_FLAGS first
    from repro.configs.base import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_cell, probe_plan
    from repro.roofline.analysis import extrapolate_raw

    meshes, out = {}, {}
    for arch, shape, m in cells:
        if m not in meshes:
            meshes[m] = make_production_mesh(multi_pod=m == "multi")
        mesh = meshes[m]
        compiled = _compile(build_cell(arch, shape, mesh), mesh)
        ma = compiled.memory_analysis()
        raw = _raw(compiled)
        plan = probe_plan(arch)
        if plan is not None:
            r1, r2 = (_raw(_compile(build_cell(arch, shape, mesh, p), mesh))
                      for p in plan)
            n = get_config(arch).n_layers
            trans = max(0.0, r1["transcendentals"] + (
                r2["transcendentals"] - r1["transcendentals"]) * (n - 1))
            raw = dict(extrapolate_raw(r1, r2, n), transcendentals=trans)
        peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
        out[f"{arch}/{shape}/{MESH_NAMES[m]}"] = {
            **raw, "argument_gb": ma.argument_size_in_bytes / 2**30,
            "peak_gb": peak / 2**30}
    return out


_ABBR = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}


def _kinds(by_kind: dict, counts: dict) -> str:
    return ", ".join(f"{_ABBR[k]} {counts.get(k, 0)} {by_kind[k] / 1e9:.4f}"
                     for k in sorted(by_kind))


def table(ref: dict, port: dict) -> str:
    """Markdown: each cell of ``ref`` beside the port's record of it."""
    rows = ["| cell | port wire GB (kind count GB) | reference wire GB, "
            "tuple-aware | peak GB port / ref | FLOPs a device port / ref |",
            "| --- | --- | --- | --- | --- |"]
    for key, r in ref.items():
        p = port[key]
        pr, pm = p["roofline"], p["memory_analysis"]
        rows.append(
            f"| {key.rsplit('/', 1)[0]} | {pr['wire_bytes_per_dev'] / 1e9:.4f}"
            f" ({_kinds(pr['wire_by_kind'], pr['counts'])}) | "
            f"{r['wire_bytes'] / 1e9:.4f} ({_kinds(r['by_kind'], r['counts'])})"
            f" | {pm['peak_gb']:.3f} / {r['peak_gb']:.3f} | "
            f"{pr['flops_per_dev']:.4g} / {r['flops']:.4g} |")
    return "\n".join(rows)


if __name__ == "__main__":
    records = reference_records(json.loads(sys.argv[1]))
    if "--table" in sys.argv:
        with open(sys.argv[sys.argv.index("--table") + 1]) as f:
            print(table(records, json.load(f)))
    else:
        print(json.dumps(records))
