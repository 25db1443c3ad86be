#!/usr/bin/env python3
"""Old against new, in one process on one card: the redesigned fdescan and
flash_decode kernels against earlier versions of their CUDA sources.

    python3 kernel_ab.py OLD_DIR

OLD_DIR holds ``fdescan/csrc/fdescan.cu`` and
``flash_decode/csrc/flash_decode.cu`` as an earlier commit had them (for
example ``src/repro_torch/kernels`` of a ``git archive`` of that commit,
unpacked under ``build/``). Both sources must keep that commit's C
interface: ``fdescan_launch`` as today, ``flash_decode_launch`` with three
partial buffers (m, l, acc) and a separate combine launch. The old kernels
are built with the same ``nvcc`` flags into ``build/kernels_old/`` and
called as that commit's wrappers called them. Each shape is timed in turns
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


def old_fdescan(lib):
    """The earlier wrapper's launch: argtypes set on every call."""
    import torch

    def call(q, docs):
        lib.fdescan_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fdescan_launch.restype = ctypes.c_int
        b, d = q.shape
        out = torch.empty(b, docs.shape[0], dtype=torch.float32,
                          device=q.device)
        err = lib.fdescan_launch(
            q.data_ptr(), docs.data_ptr(), out.data_ptr(), b, docs.shape[0],
            d, int(docs.dtype == torch.float16),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"old fdescan: CUDA error {err}")
        return out
    return call


def old_split_slots(s: int, pairs: int, sms: int) -> tuple[int, int]:
    """The earlier rule: ~4 blocks an SM over (b, kv) pairs, 64-slot
    multiples."""
    n = max(1, min(-(-4 * sms // pairs), -(-s // 64)))
    split = -(-s // n)
    split = -(-split // 64) * 64
    return split, -(-s // split)


def old_flash_decode(lib):
    """The earlier wrapper's launch: the SM count looked up, three partial
    buffers allocated and argtypes set on every call; two kernels."""
    import torch
    dtypes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

    def call(q, kc, vc, lengths):
        lib.flash_decode_launch.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_decode_launch.restype = ctypes.c_int
        b, kv, g, dh = q.shape
        s = kc.shape[1]
        out = torch.empty_like(q)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        split, n = old_split_slots(s, b * kv, sms)
        pm = torch.empty(b, kv, g, n, dtype=torch.float32, device=q.device)
        pl = torch.empty_like(pm)
        pa = torch.empty(b, kv, g, n, dh, dtype=torch.float32,
                         device=q.device)
        err = lib.flash_decode_launch(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
            pm.data_ptr(), pl.data_ptr(), pa.data_ptr(), out.data_ptr(), b,
            s, kv, g, dh, split, n, dtypes[q.dtype], dh ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"old flash_decode: CUDA error {err}")
        return out
    return call


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.fdescan.ops import fdescan
    from repro_torch.kernels.fdescan.ref import fdescan_ref
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    _build.build(["fdescan", "flash_decode"])
    old_fd = old_fdescan(build_old(args.old_dir, "fdescan"))
    old_fl = old_flash_decode(build_old(args.old_dir, "flash_decode"))
    dev = torch.device("cuda")
    failures: list[str] = []
    results = {}

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((64, 256)).astype(np.float32),
                     device=dev)
    docs = (0.1 * torch.randn(1_000_000, 256, device=dev,
                              generator=gen)).half()
    ref = fdescan_ref(q, docs)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))

    def check_fd(fn, which):
        err = float((fn() - ref).abs().max())
        if err > tol:
            failures.append(f"fdescan {which}: err {err:.3g} > {tol:.3g}")
    results["fdescan B=64 N=1,000,000 D=256 fp16"] = in_turns(
        lambda: old_fd(q, docs), lambda: fdescan(q, docs), check_fd)
    del q, docs, ref

    for name, s, lens in (("path S=4128 lens 4097", 4128, 4097),
                          ("decode_32k S=32768", 32_768, 32_768)):
        qd, kc, vc = (torch.randn(shape, generator=gen, device=dev)
                      .to(torch.bfloat16)
                      for shape in ((8, 3, 3, 64), (8, s, 3, 64),
                                    (8, s, 3, 64)))
        lt = torch.full((8,), lens, dtype=torch.int32, device=dev)
        ref = flash_decode_ref(qd, kc, vc, lt).float()
        tol = 2**-7 * max(1.0, float(ref.abs().max()))

        def check_fl(fn, which, ref=ref, tol=tol, name=name):
            err = float((fn().float() - ref).abs().max())
            if err > tol:
                failures.append(f"flash_decode {name} {which}: err "
                                f"{err:.3g} > {tol:.3g}")
        results[f"flash_decode B=8 KV=3 G=3 Dh=64 bf16 {name}"] = in_turns(
            lambda qd=qd, kc=kc, vc=vc, lt=lt: old_fl(qd, kc, vc, lt),
            lambda qd=qd, kc=kc, vc=vc, lt=lt: flash_decode(qd, kc, vc, lt),
            check_fl)
        del qd, kc, vc, ref

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
