"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports ``jax`` or anything of the reference package
``repro``, at import time or lazily inside a function."""
import os
import pkgutil
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    modules = {m.name for m in pkgutil.walk_packages([PORT], "repro_torch.")}
    assert int(out.stdout.split()[-1]) == len(modules) >= 20


#: the serving path's modules: persistence, faults, observability, serving,
#: the disk IVF and the ColBERTer encoder
SERVING_MODULES = (
    "repro_torch.pipeline.persist", "repro_torch.storage.faults",
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.obs.analyze", "repro_torch.serve",
    "repro_torch.serve.scheduler", "repro_torch.serve.slo",
    "repro_torch.serve.workload", "repro_torch.serve.engine",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.core.disk_ivf", "repro_torch.configs.colberter",
    "repro_torch.models.colberter")


def test_serving_modules_are_walked_and_import_alone():
    """The walk above reaches every serving module (so the blocked import
    covers it), and each imports on its own with jax and repro refused."""
    modules = {m.name for m in pkgutil.walk_packages([PORT], "repro_torch.")}
    assert set(SERVING_MODULES) <= modules
    script = _BLOCKED_IMPORT.split("import repro_torch")[0] + "".join(
        f"import {name}\n" for name in SERVING_MODULES) + (
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr


#: the training path's modules: the optimizers, compression, checkpoints,
#: the trainer, the data pipeline, the launcher, the losses and quantize;
#: the LM configs it trains and the MoE layer
TRAIN_MODULES = (
    "repro_torch.train", "repro_torch.train.optimizer",
    "repro_torch.train.compress", "repro_torch.train.checkpoint",
    "repro_torch.train.trainer", "repro_torch.data.pipeline",
    "repro_torch.data.synthetic", "repro_torch.launch.train",
    "repro_torch.models.colberter", "repro_torch.models.transformer",
    "repro_torch.models.layers", "repro_torch.core.quantize",
    "repro_torch.convert", "repro_torch.models.moe",
    "repro_torch.configs.qwen2_0_5b", "repro_torch.configs.qwen2_72b",
    "repro_torch.configs.granite_moe_1b_a400m",
    "repro_torch.configs.llama4_scout_17b_a16e")


def test_train_modules_are_walked_and_import_alone():
    """As above, for the training path: walked, and each imports on its
    own with jax and repro refused."""
    modules = {m.name for m in pkgutil.walk_packages([PORT], "repro_torch.")}
    assert set(TRAIN_MODULES) <= modules
    script = _BLOCKED_IMPORT.split("import repro_torch")[0] + "".join(
        f"import {name}\n" for name in TRAIN_MODULES) + (
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_or_reference_import():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                         r"|from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "kernel_ab.py"),
             os.path.join(REPO, "examples", "espn_serving_torch.py"),
             os.path.join(REPO, "examples", "quickstart_torch.py"),
             os.path.join(REPO, "examples", "train_retriever_torch.py"),
             os.path.join(REPO, "examples", "multiarch_dryrun_torch.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            text = f.read()
        hits += [f"{path}: {m.group(0).strip()}"
                 for m in pattern.finditer(text)]
    assert not hits, hits
    assert len(files) > 20


#: the RecSys and GNN side: the embedding tables, the four RecSys models,
#: GatedGCN and its segment ops, the fanout sampler, ESPN-for-RecSys, and
#: their five configs
MULTIARCH_MODULES = (
    "repro_torch.models.embedding", "repro_torch.models.recsys",
    "repro_torch.models.gnn", "repro_torch.models.segment_ops",
    "repro_torch.data.sampler", "repro_torch.storage.espn_embedding",
    "repro_torch.configs.fm", "repro_torch.configs.dlrm_mlperf",
    "repro_torch.configs.autoint", "repro_torch.configs.two_tower_retrieval",
    "repro_torch.configs.gatedgcn")


def test_multiarch_modules_are_walked_and_import_alone():
    """As above, for the RecSys and GNN modules: walked, and each imports
    on its own with jax and repro refused."""
    modules = {m.name for m in pkgutil.walk_packages([PORT], "repro_torch.")}
    assert set(MULTIARCH_MODULES) <= modules
    script = _BLOCKED_IMPORT.split("import repro_torch")[0] + "".join(
        f"import {name}\n" for name in MULTIARCH_MODULES) + (
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr


#: the dry run: the meshes, partitioning, the cells, its entry point, the
#: roofline arithmetic and report, and the configs and models it reads the
#: logical axes of
DRYRUN_MODULES = (
    "repro_torch.launch.mesh", "repro_torch.launch.partitioning",
    "repro_torch.launch.steps", "repro_torch.launch.dryrun",
    "repro_torch.roofline", "repro_torch.roofline.analysis",
    "repro_torch.roofline.report", "repro_torch.configs.base",
    "repro_torch.models.transformer", "repro_torch.models.recsys",
    "repro_torch.models.embedding", "repro_torch.train.optimizer")


def test_dryrun_modules_are_walked_and_import_alone():
    """As above, for the dry run's modules; the example names the dry run's
    entry point and no jax or reference import."""
    modules = {m.name for m in pkgutil.walk_packages([PORT], "repro_torch.")}
    assert set(DRYRUN_MODULES) <= modules
    script = _BLOCKED_IMPORT.split("import repro_torch")[0] + "".join(
        f"import {name}\n" for name in DRYRUN_MODULES) + (
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    with open(os.path.join(REPO, "examples",
                           "multiarch_dryrun_torch.py")) as f:
        text = f.read()
    assert "repro_torch.launch.dryrun" in text
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)",
                         text, re.M)
