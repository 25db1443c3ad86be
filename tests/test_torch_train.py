"""The port's training stack (``repro_torch.train``, ``repro_torch.data.
pipeline``, ``repro_torch.launch.train``) against the JAX package's, on the
CPU.

Every case of ``tests/test_train.py`` runs on the port (directories under
``tmp_path``; ``test_elastic_restore_resharding`` restores onto a device,
``test_compressed_psum_single_device`` on a gloo group of one). Then, from
the same numpy trees: ``AdamW`` and ``SGDM`` step for step against the
reference's ``update`` (fp32, 1e-6; the warm-up read at the incremented step
and the clipping included); ``quantize_int8`` and ``EFCompressor`` bit for
bit over 50 steps; checkpoints written by either package restored by the
other (file names, manifest keys, dtypes and values); ``make_lm_batch`` and
``ShardedPipeline.batch_for`` equal; the toy model's ``Trainer`` history
within 1e-5 of the reference's; the launcher and the training example end
to end.
"""
import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.data import pipeline as ref_pipe
from repro.data.synthetic import make_lm_batch as ref_make_lm_batch
from repro.train import compress as ref_compress
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.optimizer import SGDM as RefSGDM
from repro.train.optimizer import AdamW as RefAdamW
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import convert
from repro_torch.data import pipeline as port_pipe
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.compress import (EFCompressor, compressed_psum,
                                        dequantize_int8, quantize_int8)
from repro_torch.train.optimizer import SGDM, AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = ((pred - batch["y"]) ** 2).mean()
    return loss, {}


def _toy_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 1), generator=g) * 0.1,
            "b": torch.zeros((1,))}


def _toy_numpy(step):
    r = np.random.default_rng(step % 7)
    x = r.standard_normal((32, 8)).astype(np.float32)
    w_true = np.arange(8, dtype=np.float32)[:, None] / 8
    y = x @ w_true + 0.01 * r.standard_normal((32, 1)).astype(np.float32)
    return {"x": x, "y": y}


def _toy_data(step):
    return {k: torch.from_numpy(v) for k, v in _toy_numpy(step).items()}


# -- every case of tests/test_train.py ---------------------------------------

def test_loss_decreases(tmp_path):
    tr = Trainer(TrainerConfig(total_steps=60, ckpt_every=1000, log_every=1000,
                               ckpt_dir=str(tmp_path)),
                 _toy_loss, AdamW(lr=3e-2, warmup_steps=1), _toy_data,
                 _toy_params())
    hist = tr.run(verbose=False)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.2


def test_grad_accum_exact_for_mean_loss():
    opt = AdamW(lr=1e-2, warmup_steps=1)
    batch = _toy_data(0)
    p1, p4 = _toy_params(), _toy_params()
    for p in (*p1.values(), *p4.values()):
        p.requires_grad_(True)
    s1 = make_train_step(_toy_loss, opt, grad_accum=1)
    s4 = make_train_step(_toy_loss, opt, grad_accum=4)
    p1, _, m1 = s1(p1, opt.init(p1), batch)
    p4, _, m4 = s4(p4, opt.init(p4), batch)
    for k in p1:
        np.testing.assert_allclose(p1[k].detach().numpy(),
                                   p4[k].detach().numpy(), atol=1e-5)
    assert set(m4) == {"loss", "gnorm"} and abs(float(m1["loss"])
                                                 - float(m4["loss"])) < 1e-5


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    state = {"params": _toy_params(), "opt_state": {"step": torch.ones(())}}
    for s in (10, 20, 30):
        cm.save(s, state)
    assert cm.all_steps() == [20, 30]            # gc kept last 2
    step, restored = cm.restore()
    assert step == 30
    np.testing.assert_allclose(restored["params"]["w"],
                               state["params"]["w"].numpy())


def test_checkpoint_crashed_save_ignored(tmp_path):
    d = str(tmp_path)
    cm = CheckpointManager(d, async_save=False)
    cm.save(5, {"a": torch.ones((2,))})
    # simulate a crash mid-save: tmp dir without manifest
    os.makedirs(os.path.join(d, "step_9.tmp"))
    os.makedirs(os.path.join(d, "step_7"))       # no manifest -> not committed
    assert cm.latest_step() == 5


def test_elastic_restore_resharding(tmp_path):
    """Restore onto a device named by the caller (the reference's
    ``shardings=``): every leaf a tensor there, values as saved."""
    cm = CheckpointManager(str(tmp_path), async_save=False)
    state = {"params": {"w": torch.arange(16.0).reshape(4, 4)}}
    cm.save(1, state)
    step, restored = cm.restore(device="cpu")
    w = restored["params"]["w"]
    assert step == 1 and isinstance(w, torch.Tensor)
    assert w.device == torch.device("cpu") and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.arange(16.0).reshape(4, 4))
    assert isinstance(cm.restore()[1]["params"]["w"], np.ndarray)


def test_trainer_resume_identical_history(tmp_path):
    """Resumed from its step-10 checkpoint, a fresh Trainer replays steps
    10-19 bit for bit (the CPU is deterministic)."""
    d = str(tmp_path / "a")
    cfg = TrainerConfig(total_steps=20, ckpt_every=10, log_every=1000,
                        ckpt_dir=d)
    t1 = Trainer(cfg, _toy_loss, AdamW(lr=1e-2), _toy_data, _toy_params())
    h1 = t1.run(verbose=False)
    t2 = Trainer(cfg, _toy_loss, AdamW(lr=1e-2), _toy_data, _toy_params())
    assert t2.maybe_resume() == 20
    assert t2.run(verbose=False) == []
    # the older of the two checkpoints, alone in a directory of its own
    shutil.copytree(os.path.join(d, "step_10"), tmp_path / "b" / "step_10")
    t3 = Trainer(TrainerConfig(total_steps=20, ckpt_every=100,
                               log_every=1000, ckpt_dir=str(tmp_path / "b")),
                 _toy_loss, AdamW(lr=1e-2), _toy_data, _toy_params(seed=5))
    assert t3.maybe_resume() == 10
    h3 = t3.run(verbose=False)
    ref = {m["step"]: (m["loss"], m["gnorm"]) for m in h1}
    assert [m["step"] for m in h3] == list(range(10, 20))
    for m in h3:
        assert (m["loss"], m["gnorm"]) == ref[m["step"]]
    for k in ("w", "b"):
        assert torch.equal(t1.params[k], t3.params[k])


def test_int8_quantize_roundtrip_bound():
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((64, 32)).astype(np.float32))
    q, scale = quantize_int8(x)
    err = np.abs(q.numpy().astype(np.float32) * float(scale) - x.numpy())
    assert err.max() <= float(scale) * 0.5 + 1e-6


@pytest.fixture
def gloo_group(tmp_path):
    """A gloo process group of world size 1 (the data-parallel axis of one
    device), destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_compressed_psum_single_device(gloo_group):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16,)).astype(np.float32))
    y = compressed_psum(x, gloo_group)
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-2)
    # one rank: the int8 grid of x itself
    q, scale = quantize_int8(x)
    assert torch.equal(y, dequantize_int8(q.to(torch.int32), scale) / 1.0)


_PSUM_RANK = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.train.compress import compressed_psum
rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{path}/rdv",
                        world_size=world, rank=rank)
x = np.load(f"{path}/x.npy")[rank]
np.save(f"{path}/y{rank}.npy", compressed_psum(torch.from_numpy(x)).numpy())
dist.destroy_process_group()
"""


def test_compressed_psum_across_ranks(tmp_path):
    """Three gloo ranks, each with its own vector: every rank gets the
    reference's arithmetic (``compress.py:28-40``): the ranks' largest
    scale, each rank's int8 payload on that grid (the reference's
    ``quantize_int8`` with that scale), summed as int32, dequantized and
    divided by the world size, bit for bit."""
    world = 3
    x = np.random.default_rng(4).standard_normal((world, 40)).astype(
        np.float32) * np.array([[0.1], [1.0], [3.0]], np.float32)
    np.save(tmp_path / "x.npy", x)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PSUM_RANK, str(r), str(world), str(tmp_path)],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    scale = jnp.float32(max(jnp.maximum(jnp.max(jnp.abs(row)) / 127.0,
                                        1e-12) for row in jnp.asarray(x)))
    total = sum(np.asarray(ref_compress.quantize_int8(
        jnp.asarray(row), scale)[0]).astype(np.int32) for row in x)
    want = np.asarray(ref_compress.dequantize_int8(jnp.asarray(total), scale)
                      / jnp.float32(world))
    for r in range(world):
        got = np.load(tmp_path / f"y{r}.npy")
        assert got.dtype == np.float32
        assert got.tobytes() == want.tobytes(), r
    np.testing.assert_allclose(want, x.mean(0), atol=float(scale))


def test_error_feedback_reduces_bias():
    """With EF, mean compressed grad over steps converges to the true grad."""
    comp = EFCompressor()
    g = {"w": torch.full((16,), 0.001)}           # small grads quantize badly
    res = comp.init(g)
    acc = np.zeros(16)
    for _ in range(50):
        out, res = comp.compress(g, res)
        acc += out["w"].numpy()
    np.testing.assert_allclose(acc / 50, 0.001, rtol=0.05)


def test_grad_compression_training_parity(tmp_path):
    cfg = TrainerConfig(total_steps=40, ckpt_every=1000, log_every=1000,
                        ckpt_dir=str(tmp_path), grad_compression=True)
    tr = Trainer(cfg, _toy_loss, AdamW(lr=3e-2, warmup_steps=1), _toy_data,
                 _toy_params())
    hist = tr.run(verbose=False)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.3


# -- against the reference ---------------------------------------------------

def numpy_tree(seed):
    """A nested tree under the reference's kind of names, with a scalar
    leaf, in fp32."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": f(11, 6), "score_scale": f(),
            "layers": {"wq": f(2, 6, 6), "bq": f(2, 6),
                       "ln1": {"scale": f(2, 6)}}}


def to_jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()}


OPTIMIZERS = {
    "adamw-defaults": (RefAdamW(), AdamW()),
    "adamw-warmup3-clip": (RefAdamW(lr=1e-2, warmup_steps=3, grad_clip=0.5,
                                    weight_decay=0.1),
                           AdamW(lr=1e-2, warmup_steps=3, grad_clip=0.5,
                                 weight_decay=0.1)),
    "adamw-noclip": (RefAdamW(lr=1e-2, grad_clip=0.0, warmup_steps=1),
                     AdamW(lr=1e-2, grad_clip=0.0, warmup_steps=1)),
    "sgdm": (RefSGDM(), SGDM()),
    "sgdm-clip": (RefSGDM(lr=0.1, momentum=0.5, grad_clip=1.0),
                  SGDM(lr=0.1, momentum=0.5, grad_clip=1.0)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    """10 updates from the same numpy params with the same numpy grads
    (scaled 0.3-3x so clipping comes and goes): params, state and grad
    norm within 1e-6 x max(1, |ref|) at every step."""
    ref_opt, opt = OPTIMIZERS[name]
    ref_p = to_jnp(numpy_tree(0))
    params = to_port(numpy_tree(0))
    ref_s, state = ref_opt.init(ref_p), opt.init(params)
    assert set(state) == set(ref_s)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for i in range(10):
        g = jax.tree.map(lambda a, i=i: a * np.float32(0.3 + 0.3 * i),
                         numpy_tree(100 + i))
        ref_p, ref_s, ref_norm = ref_opt.update(to_jnp(g), ref_s, ref_p)
        params, state, gnorm = opt.update(to_port(g), state, params)
        assert abs(float(gnorm) - float(ref_norm)) <= 1e-6 * max(
            1.0, float(ref_norm))
        want = {"params": ref_p, **{k: v for k, v in ref_s.items()
                                    if k != "step"}}
        got = {"params": params, **{k: v for k, v in state.items()
                                    if k != "step"}}
        for part, tree in want.items():
            for leaf, a in flatten(jax.tree.map(np.asarray, tree)).items():
                b = got[part][leaf]
                assert b.dtype == torch.float32, (part, leaf)
                assert np.abs(b.numpy() - a).max() <= 1e-6 * max(
                    1.0, np.abs(a).max()), (i, part, leaf)
        assert int(state["step"]) == int(ref_s["step"]) == i + 1


def test_adamw_first_update_runs_at_the_incremented_step():
    """The schedule is read at step + 1: with warm-up 100 the first update
    moves a weight by lr x 2/100 (Adam's first step is +-lr_t), not 1/100,
    in both packages."""
    ref_opt, opt = RefAdamW(lr=1.0, weight_decay=0.0), AdamW(
        lr=1.0, weight_decay=0.0)
    p = {"w": np.zeros(4, np.float32)}
    g = {"w": np.array([1, -1, 0.5, -0.25], np.float32) * 1e-3}
    ref_p, _, _ = ref_opt.update(to_jnp(g), ref_opt.init(to_jnp(p)),
                                 to_jnp(p))
    params = to_port(p)
    opt.update(to_port(g), opt.init(params), params)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(ref_p["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.abs(params["w"].numpy()), 0.02, rtol=1e-4)


def test_int8_and_error_feedback_bit_for_bit():
    """``quantize_int8`` (payload and scale) and 50 ``EFCompressor`` steps
    (output and residual) equal the reference's bit for bit, with values
    on the half-way points of the grid included (round half to even)."""
    r = np.random.default_rng(2)
    x = r.standard_normal((33, 7)).astype(np.float32)
    step = np.abs(x).max() / np.float32(127)
    x[0, :5] = np.array([127, 0.5, 1.5, 2.5, -0.5], np.float32) * step
    q, scale = quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert float(scale) == float(rscale)
    comp, ref_comp = EFCompressor(), ref_compress.EFCompressor()
    grads = {"w": x, "b": r.standard_normal(5).astype(np.float32) * 1e-3}
    res, ref_res = comp.init(to_port(grads)), ref_comp.init(to_jnp(grads))
    for step in range(50):
        g = {k: v * np.float32(1 + 0.1 * step) for k, v in grads.items()}
        out, res = comp.compress(to_port(g), res)
        ref_out, ref_res = ref_comp.compress(to_jnp(g), ref_res)
        for k in g:
            assert out[k].numpy().tobytes() == np.asarray(
                ref_out[k]).tobytes(), (step, k)
            assert res[k].numpy().tobytes() == np.asarray(
                ref_res[k]).tobytes(), (step, k)


def train_state(seed):
    """A trainer's checkpoint state in the reference's shape."""
    tree = numpy_tree(seed)
    zeros = jax.tree.map(np.zeros_like, tree)
    return {"params": tree, "opt_state": {
        "m": jax.tree.map(lambda a: a * 0.5, tree), "v": zeros,
        "step": np.asarray(7, np.int32)}}


def listing(directory):
    files = sorted(os.listdir(directory))
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    return files, {k: (v["file"], v["shape"], v["dtype"])
                   for k, v in manifest["leaves"].items()}


def test_checkpoints_restore_across_the_packages(tmp_path):
    """The reference's checkpoint restored by the port (and put back
    through ``convert.opt_state_from_numpy``) and the port's by the
    reference: the same file names, manifest entries, dtypes and values."""
    state = train_state(0)
    ref_cm = RefCheckpointManager(str(tmp_path / "ref"), async_save=False)
    ref_cm.save(3, to_jnp(state))
    port_state = {"params": to_port(state["params"]),
                  "opt_state": convert.opt_state_from_numpy(
                      state["opt_state"], "cpu")}
    port_cm = CheckpointManager(str(tmp_path / "port"), async_save=False)
    port_cm.save(3, port_state)
    assert listing(tmp_path / "ref" / "step_3") == \
        listing(tmp_path / "port" / "step_3")
    for reader, writer in ((port_cm, ref_cm), (ref_cm, port_cm)):
        step, got = type(reader).restore(writer, 3)
        assert step == 3
        flat_got = flatten(jax.tree.map(np.asarray, got))
        flat_want = flatten(state)
        assert set(flat_got) == set(flat_want)
        for k, a in flat_want.items():
            assert flat_got[k].dtype == a.dtype, k
            np.testing.assert_array_equal(flat_got[k], a)
    _, restored = port_cm.restore(3)
    back = convert.opt_state_from_numpy(restored["opt_state"], "cpu")
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 7
    assert set(back["m"]) == set(flatten(state["params"]))
    again = convert.opt_state_to_numpy(back)
    for k, a in flatten(state["opt_state"]).items():
        np.testing.assert_array_equal(flatten(again)[k], a)


def test_params_to_numpy_round_trip():
    from repro_torch.configs import get_config
    from repro_torch.models import colberter
    cfg = colberter.smoke_config(get_config("colberter"))
    model = colberter.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    tree = convert.params_to_numpy(model)
    assert set(flatten(tree)) == set(colberter.param_table(cfg))
    again = convert.colberter_params_from_numpy(tree, cfg, "cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
    # copies: a later in-place update does not reach the arrays
    with torch.no_grad():
        model.embed.add_(1.0)
    assert not np.array_equal(tree["embed"], model.embed.detach().numpy())


def test_async_save_copies_before_the_write(tmp_path):
    """An update in place right after ``save`` returns does not reach the
    checkpoint: the leaves were copied to host in the caller's thread."""
    cm = CheckpointManager(str(tmp_path))
    w = torch.zeros(1000)
    cm.save(1, {"w": w})
    w.add_(1.0)
    cm.wait()
    assert not cm.restore(1)[1]["w"].any()


def test_lm_batches_equal_reference():
    for seed, b, s, v in ((0, 4, 16, 512), (7, 3, 9, 49_152)):
        got, want = make_lm_batch(seed, b, s, v), ref_make_lm_batch(seed, b,
                                                                    s, v)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_sharded_pipeline_equals_reference(gloo_group):
    """``batch_for(step)`` is the reference's for every step (a pure
    function of (seed, step)), as tensors on the pipeline's device; a gloo
    group of one gives the whole batch; the prefetch thread serves the
    same batches in order."""
    cfg = port_pipe.PipelineConfig(global_batch=6, seed=3)
    port = port_pipe.ShardedPipeline(cfg, port_pipe.lm_generator(512, 10),
                                     device="cpu")
    ref = ref_pipe.ShardedPipeline(ref_pipe.PipelineConfig(global_batch=6,
                                                           seed=3),
                                   ref_pipe.lm_generator(512, 10))
    assert port_pipe.world() == (1, 0)
    for step in (0, 1, 5, 1000):
        got, want = port.batch_for(step), ref.batch_for(step)
        np.testing.assert_array_equal(port.global_indices(step),
                                      ref.global_indices(step))
        assert port.host_slice(step)[1] == slice(0, 6)
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    port.start(first_step=2)
    try:
        for step in (2, 3, 4):
            s, batch = port.next()
            assert s == step
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          port.batch_for(step)["tokens"])
    finally:
        port.stop()
    assert not port._thread.is_alive()


def test_toy_trainer_history_equals_reference(tmp_path):
    """From the same numpy init and batches, 30 AdamW steps with grad
    clipping: every step's loss and grad norm within 1e-5, and the final
    weights."""
    w0 = np.random.default_rng(9).standard_normal((8, 1)).astype(
        np.float32) * 0.1
    init = {"w": w0, "b": np.zeros((1,), np.float32)}

    def ref_loss(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    ref = RefTrainer(RefTrainerConfig(total_steps=30, ckpt_every=1000,
                                      ckpt_dir=str(tmp_path / "ref")),
                     ref_loss, RefAdamW(lr=3e-2, warmup_steps=5),
                     lambda s: to_jnp(_toy_numpy(s)), to_jnp(init))
    port = Trainer(TrainerConfig(total_steps=30, ckpt_every=1000,
                                 ckpt_dir=str(tmp_path / "port")),
                   _toy_loss, AdamW(lr=3e-2, warmup_steps=5), _toy_data,
                   to_port(init))
    h_ref, h_port = ref.run(verbose=False), port.run(verbose=False)
    assert len(h_ref) == len(h_port) == 30
    for a, b in zip(h_ref, h_port):
        assert a["step"] == b["step"]
        for k in ("loss", "gnorm"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(a[k])), (a, b)
    for k in init:
        np.testing.assert_allclose(port.params[k].detach().numpy(),
                                   np.asarray(ref.params[k]), atol=1e-5)


def test_sigterm_saves_an_emergency_checkpoint(tmp_path):
    """SIGTERM during step 3 ends the run after that step with a blocking
    checkpoint of step 4, which a fresh Trainer resumes from."""
    def data(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return _toy_data(step)

    cfg = TrainerConfig(total_steps=50, ckpt_every=1000,
                        ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, _toy_loss, AdamW(lr=1e-2), data, _toy_params())
    hist = tr.run(verbose=False)
    assert [m["step"] for m in hist] == [0, 1, 2, 3]
    assert tr.ckpt.all_steps() == [4]
    assert signal.getsignal(signal.SIGTERM) is not tr._emergency
    fresh = Trainer(cfg, _toy_loss, AdamW(lr=1e-2), _toy_data,
                    _toy_params(seed=1))
    assert fresh.maybe_resume() == 4
    assert torch.equal(fresh.params["w"], tr.params["w"])
    assert int(fresh.opt_state["step"]) == 4


# -- the launcher and the example ------------------------------------------

def run(args, timeout=300):
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=timeout, cwd=REPO,
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def test_launch_train_colberter_then_resume(tmp_path):
    """``--steps 6``, then 55 steps (a checkpoint at 50), then ``--resume
    --steps 60``: it resumes at 50 and logs step 50 with the same loss and
    grad norm as the first run."""
    base = ["-m", "repro_torch.launch.train", "--arch", "colberter",
            "--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    short = run(base + ["--steps", "6"])
    assert short[0].startswith("arch=colberter") and "device=cpu" in short[0]
    assert short[-1].startswith("final loss")
    first = run(base + ["--steps", "55"])
    assert sorted(os.listdir(tmp_path)) == ["step_50"]
    resumed = run(base + ["--steps", "60", "--resume"])
    assert "resumed at 50" in resumed
    step50 = [ln.split(" (")[0] for ln in first + resumed
              if ln.startswith("step 50:")]
    assert len(step50) == 2 and step50[0] == step50[1]


def test_launch_train_lm_branch(tmp_path):
    out = run(["-m", "repro_torch.launch.train", "--arch", "smollm-135m",
               "--smoke", "--steps", "6", "--seq", "32", "--device", "cpu",
               "--ckpt-dir", str(tmp_path), "--grad-accum", "2",
               "--grad-compression"])
    assert out[0].startswith("arch=smollm-135m")
    loss = float(out[-1].split()[2])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0


def test_launch_train_moe_branch(tmp_path):
    """The MoE LM trains through the same branch: finite loss, ce and aux
    (the routers' Switch loss summed over the 2 smoke layers, ~1 each),
    loss = ce + 0.01 aux."""
    out = run(["-m", "repro_torch.launch.train", "--arch",
               "granite-moe-1b-a400m", "--smoke", "--steps", "4", "--seq",
               "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out[0].startswith("arch=granite-moe-1b-a400m")
    words = out[-1].split()
    loss = float(words[2])
    metrics = dict(w.split("=") for w in words[5:])
    ce, aux = float(metrics["ce"]), float(metrics["aux"])
    assert np.isfinite([loss, ce, aux]).all()
    assert abs(ce - np.log(512)) < 1.0 and 1.0 < aux < 4.0
    assert abs(loss - (ce + 0.01 * aux)) < 1e-3


def test_launch_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "1", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_train_retriever_example_runs_on_the_cpu(tmp_path):
    out = run([os.path.join(REPO, "examples", "train_retriever_torch.py"),
               "--device", "cpu", "--steps", "10", "--ckpt-dir",
               str(tmp_path)])
    loss = [ln for ln in out if ln.startswith("loss:")]
    assert len(loss) == 1
    start, end = (float(x) for x in loss[0].split()[1::2])
    assert end < start
    mrr = [float(ln.split()[-1]) for ln in out
           if ln.startswith("self-retrieval MRR@10")]
    assert len(mrr) == 2 and all(0.0 <= m <= 1.0 for m in mrr)
