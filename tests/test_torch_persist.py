"""Saving and loading an index across the two packages, on the CPU.

A directory saved by the JAX reference (config, index, layout with record
checksums, corpus, bit and FDE tables) loads into the port and answers as
the reference does; a directory the port saves loads into the reference
the same way. Answers are held as ``tests/_torch_parity.py`` holds them:
ids equal up to adjacent swaps of scores within 1e-5, scores within 1e-5,
the simulated bill and the storage counters exactly equal. Also
``from_embeddings``, ``with_mode`` (which hands the resident tables over
without copying them), the record checksums, the crash-safe writer, and the
entry points' default device.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (artifacts, assert_same_response, configs,
                           index_arrays, layout_arrays)
from repro.core.pool import pool_corpus as ref_pool_corpus
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import persist as ref_persist
from repro.storage import faults as ref_faults
from repro.storage.layout import pack as ref_pack
from repro_torch import convert
from repro_torch.core.fde import (FDEConfig, FDEEncoder, build_fde_table,
                                  fde_from_layout)
from repro_torch.core.ivf import build_ivf
from repro_torch.pipeline import Pipeline, PipelineConfig, persist
from repro_torch.storage import faults
from repro_torch.storage.layout import pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("espn", "bitvec", "fde", "cascade")
POOL_K = 8


def queries():
    c, _, _ = artifacts()
    return c.queries_cls, c.queries_bow, c.query_lens


def tier_stats(pipe):
    return dict(pipe.tier.stats)


@functools.lru_cache(maxsize=1)
def ref_saved(root):
    """The reference's save of the parity artifacts in cascade mode (so
    the bit and FDE tables ride along), with record checksums and the
    corpus: every file its ``save`` writes."""
    c, index, layout = artifacts()
    ref_cfg, _ = configs("cascade")
    ref_cfg.faults.checksum = True
    out = os.path.join(root, "ref")
    with RefPipeline.from_artifacts(ref_cfg, index=index, layout=layout,
                                    corpus=c) as ref:
        ref.save(out)
    return out


@functools.lru_cache(maxsize=1)
def fixed_saved(root):
    """The reference's save of the pooled ``fixed_stride`` layout (cspn)."""
    c, index, _ = artifacts()
    bow = ref_pool_corpus(c.bow, POOL_K, seed=0)
    layout = ref_pack(c.cls, bow, dtype=np.float16, mode="fixed_stride",
                      pool_k=POOL_K, checksum=True)
    ref_cfg, _ = configs("cspn")
    ref_cfg.storage.layout_mode, ref_cfg.storage.pool_k = (
        "fixed_stride", POOL_K)
    out = os.path.join(root, "fixed")
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        ref.save(out)
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("persist"))


def answer(pipe):
    resp = pipe.search(*queries())
    return resp, tier_stats(pipe)


# -- reference saves, port loads ---------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_reference_directory_loads_into_the_port(root, mode):
    d = ref_saved(root)
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "bits.npz", "corpus.npz", "fde.npz", "index.npz", "layout.npz"]
    with RefPipeline.load(d, mode=mode) as ref:
        r, r_stats = answer(ref)
    with Pipeline.load(d, mode=mode, device="cpu") as port:
        assert port.layout.checksums is not None
        assert port.cfg.to_dict() == ref.cfg.to_dict()
        p, p_stats = answer(port)
    assert_same_response(r, p, r_stats, p_stats)


def test_fixed_stride_directory_loads_into_the_port(root):
    d = fixed_saved(root)
    with RefPipeline.load(d) as ref:
        r, r_stats = answer(ref)
    with Pipeline.load(d, device="cpu") as port:
        assert port.layout.mode == "fixed_stride"
        assert port.layout.meta_nbytes == 0
        p, p_stats = answer(port)
    assert_same_response(r, p, r_stats, p_stats)


# -- port saves, reference loads ---------------------------------------------

def npz_fields(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("which", ["ragged", "fixed"])
def test_port_save_is_the_reference_format(root, which):
    """Loaded and saved again by the port, every artifact holds the
    reference's fields, dtypes and values; the corpus too."""
    d = ref_saved(root) if which == "ragged" else fixed_saved(root)
    out = os.path.join(root, f"port-{which}")
    with Pipeline.load(d, device="cpu") as port:
        port.save(out)
    assert sorted(os.listdir(out)) == sorted(os.listdir(d))
    with open(os.path.join(d, "config.json")) as f, \
            open(os.path.join(out, "config.json")) as g:
        assert json.load(g) == json.load(f)
    for name in sorted(os.listdir(d)):
        if not name.endswith(".npz"):
            continue
        want, got = npz_fields(os.path.join(d, name)), \
            npz_fields(os.path.join(out, name))
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_port_directory_loads_into_the_reference(root, mode):
    """The port saves what it built itself on the CPU (the reference's
    artifacts carried over, tables built by the port); the reference
    loads it and answers as the port does."""
    c, index, layout = artifacts()
    _, port_cfg = configs("cascade")
    port_cfg.faults.checksum = True
    out = os.path.join(root, "port-built")
    if not os.path.exists(os.path.join(out, "config.json")):
        with Pipeline.from_artifacts(
                port_cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(layout)),
                corpus=c, device="cpu") as built:
            built.save(out)
    with Pipeline.load(out, mode=mode, device="cpu") as port:
        p, p_stats = answer(port)
    with RefPipeline.load(out, mode=mode) as ref:
        assert ref.layout.checksums is not None
        assert ref.corpus.qrels == c.qrels
        r, r_stats = answer(ref)
    assert_same_response(r, p, r_stats, p_stats)


# -- from_embeddings and with_mode --------------------------------------------

def test_from_embeddings_matches_reference():
    """The same embeddings indexed by both packages: the packed layout is
    byte for byte the reference's, the index puts every doc in the
    reference's cell (k-means sums in another order, held by assignment
    as in tests/test_torch_ivf.py), and with the reference's index handed
    over the answers are the reference's."""
    c, _, _ = artifacts()
    ref_cfg, port_cfg = configs("gds")
    for cfg in (ref_cfg, port_cfg):
        cfg.index.ncells, cfg.index.iters = 24, 4
    with RefPipeline.from_embeddings(ref_cfg, c.cls, c.bow) as ref, \
            Pipeline.from_embeddings(port_cfg, c.cls, c.bow,
                                     device="cpu") as port:
        assert port.corpus is None
        np.testing.assert_array_equal(port.layout.blob, ref.layout.blob)
        np.testing.assert_array_equal(port.layout.offsets,
                                      ref.layout.offsets)

        def cell_of(ids):
            ids = np.asarray(ids)
            out = np.full(len(c.cls), -1)
            cells = np.broadcast_to(np.arange(ids.shape[0])[:, None],
                                    ids.shape)
            out[ids[ids >= 0]] = cells[ids >= 0]
            return out
        agree = np.mean(cell_of(port.index.cell_ids.numpy())
                        == cell_of(ref.index.cell_ids))
        assert agree >= 0.99, agree
        r = ref.search(*queries())
        r_stats = dict(ref.tier.stats)
    with Pipeline.from_artifacts(
            port_cfg, index=convert.ivf_index_from_numpy(
                index_arrays(ref.index), "cpu"),
            layout=port.layout, device="cpu") as carried:
        p = carried.search(*queries())
        assert_same_response(r, p, r_stats, dict(carried.tier.stats))


@pytest.mark.parametrize("mode", ["bitvec", "fde", "espn"])
def test_with_mode_matches_reference_and_shares_tables(root, mode):
    d = ref_saved(root)
    with RefPipeline.load(d) as ref_base, \
            Pipeline.load(d, device="cpu") as base:
        with ref_base.with_mode(mode, alpha=0.5) as ref, \
                base.with_mode(mode, alpha=0.5) as port:
            assert port.cfg.to_dict() == ref.cfg.to_dict()
            assert port.index is base.index and port.layout is base.layout
            # the tables the new mode needs are the base's own objects
            if port.tier.bits is not None:
                assert port.tier.bits is base.tier.bits
            if port.tier.fde is not None:
                assert port.tier.fde is base.tier.fde
                assert (port.tier.fde.vecs.data_ptr()
                        == base.tier.fde.vecs.data_ptr())
            assert (port.tier.bits is None) == (mode != "bitvec")
            assert (port.tier.fde is None) == (mode != "fde")
            r, r_stats = answer(ref)
            p, p_stats = answer(port)
        with pytest.raises(TypeError, match="unknown RetrievalConfig field"):
            base.with_mode(mode, nprob=3)
    assert_same_response(r, p, r_stats, p_stats)


# -- record checksums ----------------------------------------------------------

@pytest.mark.parametrize("fixed", [False, True])
def test_checksums_equal_the_reference(fixed):
    c, _, _ = artifacts()
    bow = ref_pool_corpus(c.bow, POOL_K, seed=0) if fixed else c.bow
    kw = dict(mode="fixed_stride", pool_k=POOL_K) if fixed else {}
    ref = ref_pack(c.cls, bow, dtype=np.float16, checksum=True, **kw)
    ours = pack(c.cls, bow, dtype=np.float16, checksum=True, **kw)
    np.testing.assert_array_equal(ours.blob, ref.blob)
    assert ours.checksums.dtype == np.uint32
    np.testing.assert_array_equal(ours.checksums, ref.checksums)
    np.testing.assert_array_equal(faults.compute_checksums(ours),
                                  ref_faults.compute_checksums(ref))
    assert faults.verify_checksums(ours).all()
    # a flipped payload byte fails its record's check, and only that one
    ours.blob[int(ours.offsets[5, 0]) * ours.block + 3] ^= 0x10
    ok = faults.verify_checksums(ours)
    assert not ok[5] and ok.sum() == ours.n_docs - 1
    with pytest.raises(ValueError, match="no checksums"):
        faults.verify_checksums(pack(c.cls[:3], bow[:3], **kw))


# -- crash-safe writer (as tests/test_faults.py holds the reference's) --------

def small_layout(seed, checksum=False):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((60, 16)).astype(np.float32)
    bow = [rng.standard_normal((int(t), 8)).astype(np.float32)
           for t in rng.integers(4, 40, 60)]
    return pack(cls, bow, dtype=np.float16, checksum=checksum)


def test_atomic_save_and_verified_load_roundtrip(tmp_path):
    layout = small_layout(3, checksum=True)
    path = str(tmp_path / "layout.npz")
    persist.save_layout(layout, path)
    assert os.path.exists(path + ".crc32")
    back = persist.load_layout(path)
    np.testing.assert_array_equal(back.blob, layout.blob)
    np.testing.assert_array_equal(back.checksums, layout.checksums)
    # the reference reads the port's file and its sidecar
    np.testing.assert_array_equal(ref_persist.load_layout(path).checksums,
                                  layout.checksums)


def test_load_rejects_missing_and_mismatched_sidecar(tmp_path):
    layout = small_layout(3)
    path = str(tmp_path / "layout.npz")
    persist.save_layout(layout, path)
    os.remove(path + ".crc32")
    with pytest.raises(persist.ArtifactIntegrityError):
        persist.load_layout(path)
    persist.save_layout(layout, path)
    with open(path, "r+b") as f:               # bit-rot one byte mid-file
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(persist.ArtifactIntegrityError):
        persist.load_layout(path)


def test_mid_save_crash_leaves_previous_artifact_loadable(tmp_path,
                                                          monkeypatch):
    old, new = small_layout(1), small_layout(2)
    path = str(tmp_path / "layout.npz")
    persist.save_layout(old, path)
    real_replace = os.replace

    def crash_on_data_replace(src, dst):
        if dst == path:                        # die before publication
            raise OSError("simulated crash mid-save")
        return real_replace(src, dst)

    monkeypatch.setattr(persist.os, "replace", crash_on_data_replace)
    with pytest.raises(OSError):
        persist.save_layout(new, path)
    monkeypatch.setattr(persist.os, "replace", real_replace)
    assert not os.path.exists(path + ".tmp")   # no torn temp left behind
    back = persist.load_layout(path)           # OLD artifact, still valid
    np.testing.assert_array_equal(back.blob, old.blob)


# -- the entry points default to the card -------------------------------------

def test_entry_points_default_to_the_card(root):
    """Without a CUDA device every entry point raises unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c, _, layout = artifacts()
    port_layout = convert.layout_from_numpy(layout_arrays(layout))
    cfg = FDEConfig(d_bow=32, r_reps=2, d_final=16)
    calls = [lambda: Pipeline.load(ref_saved(root)),
             lambda: Pipeline.from_embeddings(PipelineConfig(), c.cls, c.bow),
             lambda: build_ivf(c.cls, ncells=8),
             lambda: FDEEncoder(cfg),
             lambda: build_fde_table(c.bow[:4], cfg),
             lambda: fde_from_layout(port_layout, cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--docs", "300",
         "--queries", "2"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_cluster_and_mutation_configs_raise(root):
    """A saved config that shards or replicates builds a
    ``StorageCluster``; one that asks for live mutation (alone or on a
    cluster) builds the ``MutableStorageCluster``, which saves its
    ``mutation/`` directory (no ``shards/``) and loads back as a mutable
    tier with the same base images and tombstones. ``rebalance`` on an
    immutable cluster raises for want of the mutable tier."""
    from repro_torch.storage.cluster import StorageCluster
    from repro_torch.storage.mutation import MutableStorageCluster
    c, index, layout = artifacts()
    for sections in ((("cluster", "n_shards", 2),),
                     (("cluster", "replication", 2),),
                     (("mutation", "enabled", True),),
                     (("cluster", "n_shards", 2),
                      ("mutation", "enabled", True))):
        _, cfg = configs("espn")
        for section, field, value in sections:
            setattr(getattr(cfg, section), field, value)
        with Pipeline.from_artifacts(
                cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(layout)),
                device="cpu") as pipe:
            assert isinstance(pipe.tier, StorageCluster)
            if cfg.mutation.active():
                assert isinstance(pipe.tier, MutableStorageCluster)
                out = pipe.save(os.path.join(
                    root, f"mutable-{cfg.cluster.n_shards}"))
                assert os.path.isdir(os.path.join(out, "mutation"))
                assert not os.path.exists(os.path.join(out, "shards"))
                with Pipeline.load(out, device="cpu") as back:
                    assert isinstance(back.tier, MutableStorageCluster)
                    np.testing.assert_array_equal(back.tier.alive,
                                                  pipe.tier.alive)
                    for s, sh in enumerate(pipe.tier.shards):
                        np.testing.assert_array_equal(
                            back.tier.shard_ids[s], pipe.tier.shard_ids[s])
                        np.testing.assert_array_equal(
                            back.tier.shards[s].layout.blob, sh.layout.blob)
            else:
                assert not isinstance(pipe.tier, MutableStorageCluster)
                with pytest.raises(RuntimeError, match="mutable tier"):
                    pipe.rebalance()
