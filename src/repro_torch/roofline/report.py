"""Render the roofline tables from a dry-run manifest.

    PYTHONPATH=src python -m repro_torch.roofline.report dryrun_manifest_torch.json
    PYTHONPATH=src python -m repro_torch.roofline.report dryrun_manifest_torch.json --both

``--both`` prints one table of every cell on both meshes instead (16x16's
terms, 2x16x16's peak, collective term and bottleneck).
"""
from __future__ import annotations

import json
import sys


def roofline_table(manifest: dict, mesh_sub: str = "single") -> str:
    rows = []
    hdr = ("| arch | shape | kind | peak GB/dev | compute ms | memory ms | "
           "collective ms | bottleneck | useful | collectives |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    for key in sorted(manifest):
        v = manifest[key]
        if mesh_sub not in key or "#" in key or v.get("status") != "ok":
            continue
        r = v["roofline"]
        arch, shape, _ = key.split("/")
        cnt = ",".join(f"{k.replace('all-','a').replace('collective-','c')}"
                       f"x{n}" for k, n in sorted(r["counts"].items()))
        rows.append(
            f"| {arch} | {shape} | {v['kind']} | "
            f"{v['memory_analysis']['peak_gb']:.2f} | "
            f"{r['compute_ms']:.2f} | {r['memory_ms']:.1f} | "
            f"{r['collective_ms']:.2f} | {r['bottleneck']} | "
            f"{r['useful_ratio']:.3f} | {cnt} |")
    return "\n".join(rows)


def multi_pod_table(manifest: dict) -> str:
    rows = ["| arch | shape | status | peak GB/dev | compile s |",
            "|---|---|---|---|---|"]
    for key in sorted(manifest):
        v = manifest[key]
        if "multi" not in key or "#" in key:
            continue
        arch, shape, _ = key.split("/")
        if v.get("status") == "ok":
            rows.append(f"| {arch} | {shape} | OK | "
                        f"{v['memory_analysis']['peak_gb']:.2f} | "
                        f"{v['compile_s']} |")
        else:
            rows.append(f"| {arch} | {shape} | FAIL: "
                        f"{v.get('error', '?')[:60]} | - | {v['compile_s']} |")
    return rows and "\n".join(rows) or ""


def perf_rows(manifest: dict) -> str:
    """Tagged (hillclimb) entries vs their baselines."""
    rows = ["| cell | variant | peak GB | compute ms | memory ms | "
            "collective ms | bottleneck |", "|---|---|---|---|---|---|---|"]
    for key in sorted(manifest):
        if "#" not in key:
            continue
        v = manifest[key]
        base, tag = key.split("#")
        if v.get("status") != "ok":
            rows.append(f"| {base} | {tag} | FAIL {v.get('error','')[:50]} |"
                        " - | - | - | - |")
            continue
        r = v["roofline"]
        rows.append(f"| {base} | {tag} | "
                    f"{v['memory_analysis']['peak_gb']:.2f} | "
                    f"{r['compute_ms']:.2f} | {r['memory_ms']:.1f} | "
                    f"{r['collective_ms']:.2f} | {r['bottleneck']} |")
    return "\n".join(rows)


def both_meshes_table(manifest: dict) -> str:
    """One row a cell: its 16x16 record's peak, terms, bottleneck and
    useful ratio, beside its 2x16x16 record's peak, collective term and
    bottleneck."""
    rows = ["| arch | shape | kind | peak GB | compute ms | memory ms | "
            "collective ms | bottleneck | useful | 2x16x16 peak GB | "
            "2x16x16 collective ms | 2x16x16 bottleneck |",
            "|" + "---|" * 12]
    for key in sorted(manifest):
        v = manifest[key]
        if "single" not in key or "#" in key or v.get("status") != "ok":
            continue
        arch, shape, _ = key.split("/")
        r = v["roofline"]
        m = manifest.get(f"{arch}/{shape}/multi-pod-2x16x16", {})
        multi = (f"{m['memory_analysis']['peak_gb']:.2f} | "
                 f"{m['roofline']['collective_ms']:.2f} | "
                 f"{m['roofline']['bottleneck']}"
                 if m.get("status") == "ok" else "- | - | -")
        rows.append(
            f"| {arch} | {shape} | {v['kind']} | "
            f"{v['memory_analysis']['peak_gb']:.2f} | {r['compute_ms']:.2f} | "
            f"{r['memory_ms']:.1f} | {r['collective_ms']:.2f} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.3f} | {multi} |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_manifest_torch.json"
    with open(path) as f:
        manifest = json.load(f)
    if "--both" in sys.argv[2:]:
        print(both_meshes_table(manifest))
        return
    ok = sum(1 for v in manifest.values() if v.get("status") == "ok")
    print(f"## {ok}/{len(manifest)} cells OK\n")
    print("### single-pod roofline\n")
    print(roofline_table(manifest))
    print("\n### multi-pod (2x16x16) compile results\n")
    print(multi_pod_table(manifest))
    print("\n### perf iterations\n")
    print(perf_rows(manifest))


if __name__ == "__main__":
    main()
