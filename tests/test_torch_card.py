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
    bf16/fp16 within one ulp of the output dtype."""
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
            ref = flash_decode_ref(*args)
            torch.cuda.synchronize()
            assert ops.flash_decode.launches == before + 1
            assert out.dtype == dtype and out.shape == ref.shape
            err = float((out.float() - ref.float()).abs().max())
            assert err <= ulp * max(1.0, float(ref.float().abs().max()))
