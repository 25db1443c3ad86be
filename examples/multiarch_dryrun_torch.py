"""Drive the port's multi-pod dry run for any (arch x shape) from the public
API: the large-scale deployment entry point. Needs no card; the process
joins a fake 512-rank process group as rank 0.

    PYTHONPATH=src python examples/multiarch_dryrun_torch.py --arch smollm-135m \
        --shape decode_32k --multi-pod
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    name = "multi-pod-2x16x16" if args.multi_pod else "single-pod-16x16"
    manifest = {}
    rec = run_cell(args.arch, args.shape, mesh, name, manifest)
    if rec["status"] == "ok":
        print("\nmemory analysis:", rec["memory_analysis"])
        print("roofline:", {k: v for k, v in rec["roofline"].items()
                            if k not in ("flops_per_dev", "bytes_per_dev",
                                         "wire_bytes_per_dev")})


if __name__ == "__main__":
    main()
