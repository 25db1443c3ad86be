"""The port's roofline arithmetic, report, logical axes and partitioning
(``repro_torch.roofline``, ``repro_torch.launch.{mesh,partitioning}``, the
models' logical axes, the optimizers' ``init_shapes``) against the JAX
package's, on the CPU.

- Wire bytes: the port's ring formulas per kind (``wire_bytes``) give the
  figure ``parse_collectives`` reads off synthetic HLO lines, at group
  sizes 2, 16 and 256.
- ``extrapolate_raw`` bit for bit on seeded random raws.
- The FLOP count (``StepRecorder``, ``op_cost``): on small functions, one
  class of op a case (elementwise, reduction, transcendental, product, a
  mix), the FLOPs and transcendentals of XLA's ``cost_analysis()`` of the
  reference's jitted function, exactly; the products alone as
  ``product_flops``.
- ``report``: the same text from one synthetic manifest of ok, failed and
  tagged records.
- The logical axes of every LM and RecSys arch and of the tables: equal
  trees. ``AdamW``/``SGDM.init_shapes``: the reference's shapes and dtypes
  under the same flattened names.
- ``resolve_spec`` on the fake 2x16x16 and 16x16 meshes (a subprocess: the
  fake process group is the process's): the placements of every pattern of
  logical axes, mapped back to a spec tuple, are the reference's
  ``PartitionSpec``.
"""
import io
import json
import os
import random
import subprocess
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch import mesh as ref_mesh
from repro.launch import partitioning as ref_part
from repro.models import embedding as ref_emb
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tfm
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.models import embedding, recsys, transformer
from repro_torch.roofline import analysis, report
from repro_torch.train import optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
LM_ARCHS = ("smollm-135m", "qwen2-0.5b", "qwen2-72b", "granite-moe-1b-a400m",
            "llama4-scout-17b-a16e")
RECSYS_ARCHS = ("fm", "dlrm-mlperf", "autoint", "two-tower-retrieval")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def flat(tree, prefix=""):
    """A tree of dicts and tuples -> {"a/b/0": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not _axes_leaf(tree):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def _axes_leaf(t) -> bool:
    """A tuple of logical axes (names or None) is a leaf, not a node."""
    return all(a is None or isinstance(a, str) for a in t)


# -- collectives ------------------------------------------------------------

@pytest.mark.parametrize("g", [2, 16, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_parse_collectives(kind, g):
    out = "bf16[8,1024,512]"
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    line = (f"  %x.1 = {out} {kind}(bf16[8,1024,512] %y), "
            f"replica_groups={groups}, dimensions={{0}}")
    want = ref_analysis.parse_collectives(line)
    out_bytes = 8 * 1024 * 512 * 2
    got = analysis.wire_bytes(kind, out_bytes, g)
    assert want.by_kind == {kind: got}
    stats = analysis.CollectiveStats()
    stats.add(kind, got)
    assert (stats.counts, stats.by_kind, stats.wire_bytes) == (
        want.counts, want.by_kind, want.wire_bytes)


def test_wire_bytes_skip_a_group_of_one():
    line = ("  %x.1 = f32[64] all-reduce(f32[64] %y), replica_groups={{0}}")
    assert ref_analysis.parse_collectives(line).counts == {}
    assert analysis.wire_bytes("all-reduce", 256, 1) is None
    assert analysis.wire_bytes("collective-permute", 256, 1) == 256


# -- extrapolation ------------------------------------------------------------

def _random_raw(r: random.Random) -> dict:
    kinds = r.sample(KINDS[:4], r.randint(0, 4))
    return {"flops": r.uniform(0, 1e15), "bytes": r.uniform(0, 1e12),
            "wire_bytes": r.uniform(0, 1e10),
            "by_kind": {k: r.uniform(0, 1e9) for k in kinds},
            "counts": {k: r.randint(0, 500) for k in kinds}}


@pytest.mark.parametrize("seed", range(6))
def test_extrapolate_raw_bit_for_bit(seed):
    r = random.Random(seed)
    raw1, raw2 = _random_raw(r), _random_raw(r)
    n_layers = r.choice([1, 2, 24, 30, 48, 80])
    assert (analysis.extrapolate_raw(raw1, raw2, n_layers)
            == ref_analysis.extrapolate_raw(raw1, raw2, n_layers))


# -- the FLOP count ---------------------------------------------------------

_rng = np.random.default_rng(0)
_X, _Y = (_rng.standard_normal((64, 32)).astype(np.float32) for _ in "xy")
_W = _rng.standard_normal((32, 16)).astype(np.float32)
_B = _rng.standard_normal((4, 8, 16)).astype(np.float32)
_C = _rng.standard_normal((4, 16, 8)).astype(np.float32)
# (the reference's function, the port's, the inputs); each op's producer
# is one XLA does not fuse twice (a fusion that recomputes its input
# counts it again)
FLOP_CASES = {
    "elementwise": (
        lambda a, b: jnp.where(a > b, a * b, a - b).astype(jnp.bfloat16),
        lambda a, b: torch.where(a > b, a * b, a - b).to(torch.bfloat16),
        (_X, _Y)),
    "reduction": (
        lambda a, b: (a.sum(axis=1), b.max(axis=0), a.mean(axis=0)),
        lambda a, b: (a.sum(dim=1), b.amax(dim=0), a.mean(dim=0)),
        (_X, _Y)),
    "transcendental": (
        lambda a, b: (jnp.exp(a), jnp.log(jnp.abs(b)), jnp.tanh(a),
                      jax.lax.rsqrt(jnp.abs(b)), jax.nn.sigmoid(a)),
        lambda a, b: (a.exp(), b.abs().log(), a.tanh(), b.abs().rsqrt(),
                      torch.sigmoid(a)),
        (_X, _Y)),
    "product": (
        lambda a, w, b, c: (a @ w, jnp.einsum("bij,bjk->bik", b, c)),
        lambda a, w, b, c: (a @ w, torch.bmm(b, c)),
        (_X, _W, _B, _C)),
    "mix": (
        lambda a, w: (jax.nn.relu(jax.nn.logsumexp(a @ w, axis=-1) * 20.0)
                      .mean() + (a * jax.lax.rsqrt(
                          (a * a).sum(axis=-1, keepdims=True) + 1e-6)).sum()),
        lambda a, w: (torch.relu(torch.logsumexp(a @ w, dim=-1) * 20.0)
                      .mean() + (a * torch.rsqrt(
                          (a * a).sum(dim=-1, keepdim=True) + 1e-6)).sum()),
        (_X, _W)),
}


@pytest.mark.parametrize("case", list(FLOP_CASES))
def test_flops_equal_xla_cost_analysis(case):
    ref_fn, port_fn, ins = FLOP_CASES[case]
    cost = jax.jit(ref_fn).lower(*ins).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    rec, _ = analysis.record_step(
        port_fn, tuple(torch.from_numpy(a) for a in ins))
    assert rec.flops == cost.get("flops", 0.0) > 0
    assert rec.transcendentals == cost.get("transcendentals", 0.0)
    products = 2 * (64 * 32 * 16 + 4 * 8 * 16 * 8) if case == "product" \
        else 2 * 64 * 32 * 16 if case == "mix" else 0
    assert rec.product_flops == products
    raw = analysis.extract_raw(rec)
    assert raw["flops"] == rec.flops
    assert raw["product_flops"] == products


# -- report -----------------------------------------------------------------

def _manifest() -> dict:
    def ok(peak, c, m, x, counts, compile_s=3.2):
        return {"status": "ok", "kind": "serve", "raw_source": "direct",
                "compile_s": compile_s,
                "memory_analysis": {"argument_gb": 1.0, "output_gb": 0.1,
                                    "temp_gb": 0.5, "alias_gb": 0.0,
                                    "peak_gb": peak},
                "roofline": {"compute_ms": c, "memory_ms": m,
                             "collective_ms": x, "bottleneck": "memory",
                             "useful_ratio": 0.51234, "counts": counts}}
    return {
        "fm/serve_p99/single-pod-16x16": ok(0.165, 0.0, 0.527, 3.8,
                                            {"all-gather": 3,
                                             "all-reduce": 1}),
        "colberter/serve_q32/single-pod-16x16": ok(2.371, 0.029, 1.777, 0.0,
                                                   {}),
        "colberter/serve_q32/multi-pod-2x16x16": ok(1.2, 0.01, 0.9, 0.0,
                                                    {"collective-permute":
                                                     2}),
        "qwen2-72b/train_4k/multi-pod-2x16x16": {
            "status": "fail", "error": "RuntimeError: " + "x" * 80,
            "trace": "...", "compile_s": 40.5},
        "colberter/serve_q32/single-pod-16x16#t": ok(2.0, 0.02, 1.5, 0.1,
                                                     {}),
        "fm/serve_p99/single-pod-16x16#bad": {
            "status": "fail", "error": "ValueError: nope", "compile_s": 0.1},
    }


@pytest.mark.parametrize("table", ["roofline_table", "multi_pod_table",
                                   "perf_rows"])
def test_report_tables_equal_reference(table):
    m = _manifest()
    assert getattr(report, table)(m) == getattr(ref_report, table)(m)


def test_report_main_prints_the_reference_text(tmp_path, monkeypatch):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(_manifest()))
    outs = []
    for mod in (report, ref_report):
        monkeypatch.setattr(sys, "argv", ["report", str(path)])
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "5/6 cells OK" not in outs[0]
    assert outs[0].startswith("## 4/6 cells OK")


def test_report_both_meshes_table(tmp_path, monkeypatch):
    """``--both``: one row a 16x16 record that is ok and untagged, its
    2x16x16 record's peak, collective term and bottleneck beside it (dashes
    where there is none)."""
    path = tmp_path / "m.json"
    path.write_text(json.dumps(_manifest()))
    monkeypatch.setattr(sys, "argv", ["report", str(path), "--both"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        report.main()
    rows = buf.getvalue().strip().splitlines()
    assert rows == report.both_meshes_table(_manifest()).splitlines()
    assert len(rows) == 4
    assert rows[2] == ("| colberter | serve_q32 | serve | 2.37 | 0.03 | 1.8 "
                       "| 0.00 | memory | 0.512 | 1.20 | 0.00 | memory |")
    assert rows[3].endswith("| 0.512 | - | - | - |")


# -- logical axes and optimizer shapes ----------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_logical_axes_equal_reference(arch):
    want = ref_tfm.param_logical_axes(ref_get_config(arch))
    assert transformer.param_logical_axes(get_config(arch)) == want
    # the table's shapes are unchanged by the axes column
    shapes = {k: tuple(v.shape) for k, v in
              flat(transformer.param_shapes(get_config(arch))).items()}
    assert set(shapes) == set(flat(want))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_param_logical_axes_equal_reference(arch):
    want = ref_recsys.param_logical_axes(ref_get_config(arch))
    assert recsys.param_logical_axes(get_config(arch)) == want


def test_table_logical_axes_equal_reference():
    sizes = (3, 65_535, 65_536, 40_000_000, 512, 1_000_000)
    assert embedding.SHARD_MIN_ROWS == ref_emb.SHARD_MIN_ROWS
    assert (embedding.table_logical_axes(sizes)
            == ref_emb.table_logical_axes(sizes))


@pytest.mark.parametrize("opt", ["AdamW", "SGDM"])
@pytest.mark.parametrize("arch", ["smollm-135m", "fm"])
def test_optimizer_init_shapes_equal_reference(opt, arch):
    if arch == "fm":
        pshapes = recsys.param_shapes(get_config(arch))
        ref_pshapes = ref_recsys.param_shapes(ref_get_config(arch))
    else:
        pshapes = transformer.param_shapes(get_config(arch))
        ref_pshapes = ref_tfm.param_shapes(ref_get_config(arch))
    got = flat(getattr(optimizer, opt)().init_shapes(pshapes))
    want = flat(getattr(ref_opt, opt)().init_shapes(ref_pshapes))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == jnp.dtype(want[k].dtype).name


# -- resolve_spec on the fake meshes ------------------------------------------

def _patterns() -> list[tuple]:
    """Every logical-axes pattern the models use, and each logical axis of
    ``mesh_axes`` alone in the first, second and last of three dims."""
    pats = set()
    for arch in LM_ARCHS:
        pats |= set(flat(ref_tfm.param_logical_axes(ref_get_config(arch)))
                    .values())
    for arch in RECSYS_ARCHS:
        pats |= set(flat(ref_recsys.param_logical_axes(ref_get_config(arch)))
                    .values())
    names = sorted(ref_mesh.mesh_axes(
        SimpleNamespace(axis_names=("pod", "data", "model"))))
    for n in names:
        pats |= {(n,), (None, n), (n, None, None), (None, None, n)}
    pats |= {("batch", "tp"), ("batch", None, "tp"), ("fsdp", "tp"),
             ("tp", "fsdp"), ("batch", "seq", None, None)}
    return sorted(pats, key=str)


_RESOLVE = r"""
import json, sys
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.launch.partitioning import resolve_spec
from repro_torch.models.layers import placements_of
pats = [tuple(p) for p in json.loads(sys.argv[1])]
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    rules = mesh_axes(mesh)
    rows = []
    for p in pats:
        pl = placements_of(resolve_spec(p, rules), mesh)
        rows.append([p.dim if p.is_shard() else None for p in pl])
    out["multi" if multi else "single"] = {
        "names": list(mesh.mesh_dim_names), "rows": rows,
        "ranks": mesh.mesh.flatten().tolist()[:3] + [mesh.size()]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_placements():
    pats = _patterns()
    out = subprocess.run(
        [sys.executable, "-c", _RESOLVE, json.dumps(pats)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    return pats, json.loads(out.stdout.strip().splitlines()[-1])


def spec_of_placements(dims: list, names: list, ndim: int) -> tuple:
    """Placements (each the tensor dim a mesh dim shards, or None) -> one
    entry per tensor dim: the tuple of mesh axes over it, major first."""
    return tuple(tuple(n for n, d in zip(names, dims) if d == i)
                 for i in range(ndim))


def norm_spec(spec, ndim: int) -> tuple:
    out = []
    for i in range(ndim):
        a = spec[i] if i < len(spec) else None
        out.append(() if a is None else (a,) if isinstance(a, str)
                   else tuple(a))
    return tuple(out)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_resolve_spec_placements_equal_reference(port_placements, mesh):
    pats, got = port_placements
    names = ("pod", "data", "model") if mesh == "multi" else ("data", "model")
    assert got[mesh]["names"] == list(names)
    assert got[mesh]["ranks"] == [0, 1, 2, 512 if mesh == "multi" else 256]
    rules = ref_mesh.mesh_axes(SimpleNamespace(axis_names=names))
    for pat, dims in zip(pats, got[mesh]["rows"]):
        want = norm_spec(ref_part.resolve_spec(pat, rules), len(pat))
        assert spec_of_placements(dims, list(names), len(pat)) == want, pat


def test_placements_refuse_an_order_the_mesh_does_not_have():
    from repro_torch.models.layers import placements_of
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="order"):
        placements_of((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        placements_of(("data", "data"), mesh)
    pl = placements_of((("pod", "data"), "model"), mesh)
    assert [p.dim for p in pl] == [0, 0, 1]


def test_constraints_leave_plain_tensors_alone():
    """The models' sharding hooks are the identity on plain tensors."""
    from repro_torch.models.layers import constrain, whole_heads, write_slot
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert constrain(x, ("data", None, "model")) is x
    assert constrain(x, None) is x
    assert whole_heads(x, -1, 2) is x
    cache = torch.zeros(2, 5, 4)
    write_slot(cache, 1, 3, x[:, 0])
    want = torch.zeros(2, 5, 4)
    want[:, 3] = x[:, 0]
    assert torch.equal(cache, want)
