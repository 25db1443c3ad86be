#!/usr/bin/env python3
"""Old against new, in one process on one card: redesigned CUDA kernels
against an earlier commit's sources.

    python3 kernel_ab.py OLD_DIR

Compares ``bitsim``, ``maxsim`` and ``ivf_scan``. OLD_DIR holds
``<name>/csrc/<name>.cu`` for each, as an earlier commit had them (for
example ``src/repro_torch/kernels`` of a ``git archive`` of that commit,
unpacked under ``build/``); each old source keeps the C interface its
wrapper below calls, ``bitsim_launch``, ``maxsim_launch`` and
``ivf_scan_launch`` as today (any commit since the port began). The old
kernels are built with the same ``nvcc`` flags into ``build/kernels_old/``
and called as their wrappers called them. Each shape is timed in turns
(old, new, new, old), by ``device_ms`` (20 calls in one CUDA graph) and by
the per-call ``ms`` of ``chip_smoke.py``; every call is first held to the
plain version. Prints the card line and one JSON line, last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def build_old(old_dir: str, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = os.path.join(old_dir, name, "csrc", f"{name}.cu")
    out_dir = os.path.join(ROOT, "build", "kernels_old")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                   check=True)
    return ctypes.CDLL(out)


def in_turns(old, new, check) -> dict:
    """old, new, new, old: each version's device_ms and per-call ms."""
    import chip_smoke
    res = {"old": {"device_ms": [], "ms": []},
           "new": {"device_ms": [], "ms": []}}
    for which in ("old", "new", "new", "old"):
        fn = old if which == "old" else new
        check(fn, which)
        res[which]["device_ms"].append(chip_smoke.device_ms(fn))
        res[which]["ms"].append(chip_smoke.time_ms(fn))
    return res


def old_maxsim(lib):
    """The earlier wrapper's launch (this commit's C interface)."""
    import torch

    def call(q, qm, docs, lens):
        lib.maxsim_launch.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.maxsim_launch.restype = ctypes.c_int
        k, t, d = docs.shape
        out = torch.empty(k, dtype=torch.float32, device=docs.device)
        err = lib.maxsim_launch(
            q.data_ptr(), qm.data_ptr(), docs.data_ptr(), lens.data_ptr(),
            out.data_ptr(), k, t, d, q.shape[0],
            int(docs.dtype == torch.float16),
            torch.cuda.current_stream(docs.device).cuda_stream)
        if err:
            raise RuntimeError(f"old maxsim: CUDA error {err}")
        return out
    return call


def old_ivf_scan(lib):
    """The earlier wrapper's launch (this commit's C interface)."""
    import torch

    def call(q, c):
        lib.ivf_scan_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ivf_scan_launch.restype = ctypes.c_int
        b, d = q.shape
        out = torch.empty(b, c.shape[0], dtype=torch.float32,
                          device=q.device)
        err = lib.ivf_scan_launch(
            q.data_ptr(), c.data_ptr(), out.data_ptr(), b, c.shape[0], d,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"old ivf_scan: CUDA error {err}")
        return out
    return call


def old_bitsim(lib):
    """The earlier wrapper's launch (this commit's C interface)."""
    import torch

    def call(q, qm, docs, lens):
        lib.bitsim_launch.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.bitsim_launch.restype = ctypes.c_int
        k, t, w = docs.shape
        out = torch.empty(k, dtype=torch.float32, device=docs.device)
        err = lib.bitsim_launch(
            q.data_ptr(), qm.data_ptr(), docs.data_ptr(), lens.data_ptr(),
            out.data_ptr(), k, t, w, q.shape[1], q.shape[0],
            torch.cuda.current_stream(docs.device).cuda_stream)
        if err:
            raise RuntimeError(f"old bitsim: CUDA error {err}")
        return out
    return call


def compare_bitsim(old_dir, dev, failures, results):
    """The bit filter's shape (K=1,000 docs of T=180 sign-packed tokens,
    W=1, D=32, Lq=24, Pareto lengths), K=1,000 at Lq=7, D=40 (W=2), and the
    bit filter's shape with every length 0, 16 or 180 (no tile, one 16-row
    tile or twelve a doc: the fixed cost of a launch and the cost of a
    tile)."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.bitsim.ops import bitsim
    from repro_torch.kernels.bitsim.ref import bitsim_ref
    old = old_bitsim(build_old(old_dir, "bitsim"))
    rng = np.random.default_rng(0)
    t = 180
    for lq, d, fill in ((24, 32, None), (7, 40, None), (24, 32, 0),
                        (24, 32, 16), (24, 32, 180)):
        lens = np.clip((rng.pareto(2.5, 1000) + 1) * 36, 8, t) \
            if fill is None else np.full(1000, fill)
        q, qm, docs, lens = chip_smoke.bitsim_inputs(dev, rng, 1000, t, lq,
                                                     d, lens)
        ref = bitsim_ref(q, qm, docs, lens)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        name = f"bitsim K=1000 T=180 W={docs.shape[2]} D={d} Lq={lq}" + (
            "" if fill is None else f" lengths all {fill}")

        def check(fn, which, name=name, ref=ref, tol=tol):
            err = float((fn() - ref).abs().max())
            if err > tol:
                failures.append(f"{name} {which}: err {err:.3g} > {tol:.3g}")
        results[name] = in_turns(
            lambda q=q, qm=qm, docs=docs, lens=lens: old(q, qm, docs, lens),
            lambda q=q, qm=qm, docs=docs, lens=lens: bitsim(q, qm, docs,
                                                            lens),
            check)


def compare_maxsim(old_dir, dev, failures, results):
    """The rerank's shape (K=1,000 fp16 docs) and espn's split of a
    query's candidates as the path logs it (666 prefetched hits, then 334
    misses: two launches in one timed call)."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.maxsim.ops import maxsim
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    old = old_maxsim(build_old(old_dir, "maxsim"))
    rng = np.random.default_rng(0)
    t, d, lq = 180, 32, 24
    q = torch.tensor(chip_smoke.unit(rng.standard_normal((lq, d))),
                     device=dev)
    qm = torch.ones(lq, device=dev)
    docs = torch.tensor(chip_smoke.unit(rng.standard_normal((1000, t, d))),
                        device=dev).half()
    lens = torch.tensor(np.clip((rng.pareto(2.5, 1000) + 1) * 36, 8, t)
                        .astype(np.int32), device=dev)
    ref = maxsim_ref(q, qm, docs, lens)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))

    def check(fn, which, name):
        got = fn()
        got = torch.cat(got) if isinstance(got, tuple) else got
        err = float((got - ref).abs().max())
        if err > tol:
            failures.append(f"maxsim {name} {which}: err {err:.3g} > "
                            f"{tol:.3g}")
    name = "maxsim K=1000 T=180 D=32 Lq=24 fp16"
    results[name] = in_turns(
        lambda: old(q, qm, docs, lens), lambda: maxsim(q, qm, docs, lens),
        lambda fn, which: check(fn, which, name))
    parts = ((docs[:666], lens[:666]), (docs[666:], lens[666:]))
    name = "maxsim espn split K=666 then K=334"
    results[name] = in_turns(
        lambda: tuple(old(q, qm, dd, ll) for dd, ll in parts),
        lambda: tuple(maxsim(q, qm, dd, ll) for dd, ll in parts),
        lambda fn, which: check(fn, which, name))


def compare_ivf_scan(old_dir, dev, failures, results):
    """The query path's shape, (64, 3,703, 128) fp32."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.ivf_scan.ops import centroid_scores
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref
    old = old_ivf_scan(build_old(old_dir, "ivf_scan"))
    rng = np.random.default_rng(0)
    q = torch.tensor(chip_smoke.unit(rng.standard_normal((64, 128))),
                     device=dev)
    c = torch.tensor(chip_smoke.unit(rng.standard_normal((3703, 128))),
                     device=dev)
    ref = ivf_scan_ref(q, c)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))

    def check(fn, which):
        err = float((fn() - ref).abs().max())
        if err > tol:
            failures.append(f"ivf_scan {which}: err {err:.3g} > {tol:.3g}")
    results["ivf_scan B=64 N=3703 D=128"] = in_turns(
        lambda: old(q, c), lambda: centroid_scores(q, c), check)
    results["ivf_scan B=64 N=3703 D=128"]["torch.matmul device_ms"] = \
        chip_smoke.device_ms(lambda: torch.matmul(q, c.T))


COMPARE = {"bitsim": compare_bitsim, "maxsim": compare_maxsim,
           "ivf_scan": compare_ivf_scan}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build(list(COMPARE))
    dev = torch.device("cuda")
    failures: list[str] = []
    results: dict = {}
    for compare in COMPARE.values():
        compare(args.old_dir, dev, failures, results)
        torch.cuda.empty_cache()

    for shape, r in results.items():
        print(f"{shape}: " + "; ".join(
            f"{w} device_ms {r[w]['device_ms'][0]:.4f}/"
            f"{r[w]['device_ms'][1]:.4f}, ms {r[w]['ms'][0]:.4f}/"
            f"{r[w]['ms'][1]:.4f}" for w in ("old", "new")), flush=True)
    if failures:
        print("kernel_ab.py FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    line = json.dumps({"order": "old, new, new, old", "results": results})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
