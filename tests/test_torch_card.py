"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason
(the kernels have no CPU mode; the CPU tests hold the plain versions to the
JAX package). This file imports neither ``jax`` nor ``repro``, so it runs on
a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fdescan import ops as fdescan_ops
from repro_torch.kernels.fdescan.ref import fdescan_ref
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain_version_on_the_card(card, dtype):
    """Every Dh, G of 1, 3 and 8, ragged lengths with 1, S and 0, and an S
    that is no multiple of the split. fp32 within 1e-5 x max(1, |ref|);
    bf16/fp16 within one ulp of the output dtype. One call is one launch,
    and a second call gives the same bits (the splits are combined in a
    fixed order)."""
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2**-7,
           torch.float16: 2**-10}[dtype]
    s = 300
    for dh in (16, 32, 64, 128):
        for g in (1, 3, 8):
            r = np.random.default_rng(dh + g)
            args = [torch.from_numpy(r.standard_normal(shape).astype(
                np.float32)).to(card, dtype)
                for shape in ((4, 3, g, dh), (4, s, 3, dh), (4, s, 3, dh))]
            args.append(torch.tensor([1, s, 0, 123], dtype=torch.int32,
                                     device=card))
            before = ops.flash_decode.launches
            out = ops.flash_decode(*args)
            again = ops.flash_decode(*args)
            ref = flash_decode_ref(*args)
            torch.cuda.synchronize()
            assert ops.flash_decode.launches == before + 2
            assert torch.equal(out, again)
            assert out.dtype == dtype and out.shape == ref.shape
            err = float((out.float() - ref.float()).abs().max())
            assert err <= ulp * max(1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,fp16,kernel", [
    (1, 1000, 256, True, "wgmma"), (33, 1037, 128, True, "wgmma"),
    (64, 4099, 256, True, "wgmma"), (70, 3001, 256, True, "wgmma"),
    (8, 300, 100, False, "simt"), (8, 300, 100, True, "simt"),
    (8, 300, 256, False, "simt")])
def test_fdescan_matches_plain_version_on_the_card(card, b, n, d, fp16,
                                                   kernel):
    """Both kernels: the tensor-core one (fp16 table, D a multiple of 8;
    B of 1, 33, 64 and 70, ragged N, D 128 and 256) and the SIMT one (an
    fp32 table, D=100), each within 1e-5 x max(1, |ref|) of the plain
    version on the slice's distribution, exactly (B, N)."""
    r = np.random.default_rng(b * 7 + n)
    q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(
        card)
    docs = torch.from_numpy(
        (0.1 * r.standard_normal((n, d))).astype(np.float32)).to(card)
    if fp16:
        docs = docs.half()
    assert fdescan_ops.kernel_for(q, docs) == kernel
    before = fdescan_ops.fdescan.launches
    out = fdescan_ops.fdescan(q, docs)
    ref = fdescan_ref(q, docs)
    torch.cuda.synchronize()
    assert fdescan_ops.fdescan.launches == before + 1
    assert out.shape == (b, n) and out.dtype == torch.float32
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max()))
