"""The port's ``core/quantize`` (``repro_torch.core.quantize``) against the
JAX package's, on the CPU: every case of ``tests/test_quantize.py`` on the
port, parametrised the same way; ``quantize``'s stored arrays and scales
bit for bit against the reference's in all four modes at several shapes
(odd ``d`` too), ``dequantize`` equal, ``memory_report`` field for field;
and ``examples/quickstart_torch.py`` at a small size on the CPU. Both
packages quantize in host numpy, so every comparison is exact.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import quantize as ref_q
from repro_torch.core.quantize import (BYTES, PACK_DTYPES, MemoryReport,
                                       binary_pack, binary_unpack,
                                       dequantize, memory_report, quantize,
                                       to_uint32_lanes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(3)
MODES = ("fp32", "fp16", "int8", "int4")


# ---------------------------------------------------------------- int4 / int8

@pytest.mark.parametrize("d", [8, 15, 32, 33])
def test_int4_pack_unpack_round_trip(d):
    x = RNG.standard_normal((16, d)).astype(np.float32)
    stored, scales = quantize(x, "int4")
    assert stored.dtype == np.uint8
    assert stored.shape[-1] == (d + 1) // 2          # two nibbles per byte
    back = dequantize(stored, scales, "int4", d=d)
    assert back.shape == x.shape
    # max quantization error is half an int4 step (scale = amax/7)
    np.testing.assert_allclose(back, x, atol=float(scales.max()) * 0.5 + 1e-6)


def test_int8_round_trip():
    x = RNG.standard_normal((8, 32)).astype(np.float32)
    stored, scales = quantize(x, "int8")
    back = dequantize(stored, scales, "int8")
    np.testing.assert_allclose(back, x, atol=float(scales.max()) * 0.5 + 1e-6)


def test_int4_values_survive_exactly():
    """Values already on the int4 grid (amax=7 -> scale 1) round-trip."""
    grid = np.arange(-7, 8, dtype=np.float32)[None]
    stored, scales = quantize(grid, "int4")
    back = dequantize(stored, scales, "int4", d=15)
    np.testing.assert_allclose(back, grid, atol=1e-5)


# -------------------------------------------------------------------- binary

@pytest.mark.parametrize("d", [1, 8, 31, 32, 33, 64, 96, 128])
@pytest.mark.parametrize("dtype", PACK_DTYPES)
def test_binary_pack_unpack_round_trip(d, dtype):
    x = RNG.standard_normal((5, 7, d)).astype(np.float32)
    packed = binary_pack(x, dtype=dtype)
    assert packed.dtype == np.dtype(dtype)
    lane_bits = np.dtype(dtype).itemsize * 8
    assert packed.shape == (5, 7, -(-d // lane_bits))
    back = binary_unpack(packed, d)
    np.testing.assert_array_equal(back, np.where(x > 0, 1.0, -1.0))


def test_binary_pack_dtypes_bit_identical():
    """All lane dtypes carry the same bits (little-endian byte order)."""
    x = RNG.standard_normal((4, 70)).astype(np.float32)
    lanes = [to_uint32_lanes(binary_pack(x, dtype=t)) for t in PACK_DTYPES]
    for a in lanes[1:]:
        np.testing.assert_array_equal(lanes[0], a)


def test_binary_pack_rejects_unknown_dtype():
    with pytest.raises(ValueError):
        binary_pack(np.zeros((2, 8), np.float32), dtype="int64")


# ------------------------------------------------------------- registry typo

def test_registry_typo_error_names_bitvec():
    """A typo'd backend name must fail loudly and list the real names."""
    from repro_torch.pipeline import get_backend
    with pytest.raises(KeyError) as e:
        get_backend("bitvce")
    msg = str(e.value)
    assert "bitvce" in msg
    for name in ("bitvec", "espn", "gds", "mmap", "swap", "dram"):
        assert name in msg


# --------------------------------------------------- against the reference

@pytest.mark.parametrize("shape", [(16, 32), (7, 33), (3, 5, 15), (1, 1),
                                   (4, 128)])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_equals_reference_bit_for_bit(mode, shape):
    """The stored array and the scales: same dtype, shape and bytes; then
    ``dequantize`` equal (int4 with and without ``d``)."""
    x = (RNG.standard_normal(shape) * RNG.uniform(0.01, 30)).astype(
        np.float32)
    x[..., 0] = 0.0                      # a zero column; rows keep an amax
    stored, scales = quantize(x, mode)
    want, want_scales = ref_q.quantize(x, mode)
    assert stored.dtype == want.dtype and stored.shape == want.shape
    assert stored.tobytes() == want.tobytes()
    if want_scales is None:
        assert scales is None
    else:
        assert scales.dtype == want_scales.dtype == np.float32
        assert scales.tobytes() == want_scales.tobytes()
    for d in ((None, shape[-1]) if mode == "int4" else (None,)):
        got = dequantize(stored, scales, mode, d=d)
        np.testing.assert_array_equal(
            got, ref_q.dequantize(want, want_scales, mode, d=d))


def test_quantize_all_zero_rows_and_unknown_modes():
    """A zero row takes the 1e-9 floor of the scale in both packages; an
    unknown mode raises ValueError in both functions."""
    x = np.zeros((2, 9), np.float32)
    for mode in ("int8", "int4"):
        stored, scales = quantize(x, mode)
        want, want_scales = ref_q.quantize(x, mode)
        assert stored.tobytes() == want.tobytes()
        assert scales.tobytes() == want_scales.tobytes()
    with pytest.raises(ValueError):
        quantize(x, "binary")
    with pytest.raises(ValueError):
        dequantize(x, None, "int2")


def test_bytes_table_equals_reference():
    assert BYTES == ref_q.BYTES


@pytest.mark.parametrize("n_docs,mean_tokens,ann_quant,bow_dtype", [
    (8_841_823, 68.0, "fp16", "fp16"),      # MS-MARCO v1 scale
    (1_000_000, 57.4, "fp32", "fp32"),
    (1_000_000, 57.4, "int8", "int8"),
    (20_000, 30.3, "int4", "binary"),
    (1, 1.0, "fp16", "int4"),
])
def test_memory_report_equals_reference(n_docs, mean_tokens, ann_quant,
                                        bow_dtype):
    got = memory_report(n_docs, mean_tokens, ann_quant=ann_quant,
                        bow_dtype=bow_dtype)
    want = ref_q.memory_report(n_docs, mean_tokens, ann_quant=ann_quant,
                               bow_dtype=bow_dtype)
    assert isinstance(got, MemoryReport)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


def test_quickstart_example_runs_on_the_cpu():
    """``examples/quickstart_torch.py`` at 2,000 docs: the four sections,
    ``memory_report`` included."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
         "--device", "cpu", "--docs", "2000", "--queries", "8"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for section in ("== 1.", "== 2.", "== 3.", "== 4."):
        assert any(ln.startswith(section) for ln in lines), section
    factor = [ln for ln in lines if "memory factor at msmarco-scale" in ln]
    assert len(factor) == 1 and float(factor[0].split()[-1][:-1]) > 1.0
    assert "MRR@10=" in out.stdout and "Recall@100=" in out.stdout
