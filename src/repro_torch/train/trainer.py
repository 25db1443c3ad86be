"""Training loop with gradient accumulation, periodic + on-signal
checkpointing, deterministic resume, and optional gradient compression.

Fault-tolerance posture: the data pipeline is step-indexed (the batch for
step i is a pure function of (seed, i)), so restart-from-checkpoint replays
the same batches; SIGTERM triggers an emergency checkpoint before exit
(preemption handling); checkpoints restore onto another device. The step is
eager PyTorch with autograd: ``params`` is a module (``Colberter``,
``TransformerLM``) or a dict of tensors, trained in place; the optimizer
state and the checkpoints name its leaves as the reference does.

Replay is bit for bit on the CPU. On the card it is as long as every
backward on the path is deterministic: the embedding's (an index-put with
accumulate) sorts its indices in PyTorch's CUDA kernel rather than adding
with atomics, but PyTorch promises this only under
``torch.use_deterministic_algorithms``, which is left off (it is
process-wide and would change the serving phases), so ``chip_smoke.py``
holds a replay on the card to a tolerance and reports whether it was bit
for bit.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch import convert
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.compress import EFCompressor
from repro_torch.train.optimizer import named_params


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    grad_accum: int = 1
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    grad_compression: bool = False


def make_train_step(loss_fn: Callable, optimizer, *, grad_accum: int = 1,
                    compressor: EFCompressor | None = None):
    """loss_fn(params, batch) -> (loss, metrics). Returns
    step(params, opt_state, batch[, ef_state]) with microbatch accumulation
    (the batch's leading dim is split into ``grad_accum`` contiguous
    microbatches; their gradients are summed, then divided by
    ``grad_accum``)."""

    def grads_of(params, batch):
        leaves = named_params(params)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), metrics, dict(zip(leaves, grads))

    def step(params, opt_state, batch, ef_state=None):
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads, loss = None, 0.0
            for i in range(grad_accum):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, _, g = grads_of(params, micro)
                grads = ({k: t.float() for k, t in g.items()} if grads is None
                         else {k: grads[k] + t for k, t in g.items()})
                loss = loss + l
            grads = {k: g / grad_accum for k, g in grads.items()}
            loss = loss / grad_accum
            metrics = {}
        # copied before the in-place update: a metric may be a view of a
        # parameter (the encoder's ``alpha``)
        metrics = {k: torch.as_tensor(v).detach().clone()
                   for k, v in metrics.items()}
        if compressor is not None:
            grads, ef_state = compressor.compress(grads, ef_state)
        new_p, new_o, gnorm = optimizer.update(grads, opt_state, params)
        out_metrics = {"loss": loss, "gnorm": gnorm, **metrics}
        if compressor is not None:
            return new_p, new_o, ef_state, out_metrics
        return new_p, new_o, out_metrics

    return step


def _tensors(tree: dict, device) -> dict:
    """A restored nested dict of arrays -> a flat dict of fp32 tensors."""
    return {k: torch.as_tensor(v, device=device).float()
            for k, v in flatten(tree).items()}


@dataclass
class Trainer:
    cfg: TrainerConfig
    loss_fn: Callable                     # (params, batch) -> (loss, aux)
    optimizer: object
    data_fn: Callable                     # step -> batch  (deterministic)
    params: object                        # a module or a dict of tensors
    history: list = field(default_factory=list)

    def __post_init__(self):
        self.ckpt = CheckpointManager(self.cfg.ckpt_dir,
                                      keep_last=self.cfg.keep_last)
        self.compressor = EFCompressor() if self.cfg.grad_compression else None
        self.step_fn = make_train_step(
            self.loss_fn, self.optimizer, grad_accum=self.cfg.grad_accum,
            compressor=self.compressor)
        for p in named_params(self.params).values():
            p.requires_grad_(True)
        self.device = next(iter(named_params(self.params).values())).device
        self.opt_state = self.optimizer.init(self.params)
        self.ef_state = (self.compressor.init(named_params(self.params))
                         if self.compressor else None)
        self.start_step = 0
        self._interrupted = False

    # -- fault tolerance -------------------------------------------------
    def _emergency(self, signum, frame):
        self._interrupted = True

    def maybe_resume(self) -> int:
        step, state = self.ckpt.restore()
        if state is not None:
            saved = flatten(state["params"])
            with torch.no_grad():
                for name, p in named_params(self.params).items():
                    p.copy_(torch.as_tensor(saved[name]))
            self.opt_state = convert.opt_state_from_numpy(state["opt_state"],
                                                          self.device)
            if self.compressor and "ef_state" in state:
                self.ef_state = {
                    k: torch.tensor(v, device=self.device)
                    for k, v in flatten(state["ef_state"]).items()}
            self.start_step = step
        return self.start_step

    def _save(self, step: int, block: bool = False):
        state = {"params": named_params(self.params),
                 "opt_state": self.opt_state}
        if self.compressor:
            state["ef_state"] = self.ef_state
        self.ckpt.save(step, state, block=block)

    # -- loop --------------------------------------------------------------
    def run(self, verbose: bool = True) -> list[dict]:
        old = signal.signal(signal.SIGTERM, self._emergency)
        try:
            for step in range(self.start_step, self.cfg.total_steps):
                batch = self.data_fn(step)
                t0 = time.time()
                if self.compressor:
                    self.params, self.opt_state, self.ef_state, m = \
                        self.step_fn(self.params, self.opt_state, batch,
                                     self.ef_state)
                else:
                    self.params, self.opt_state, m = self.step_fn(
                        self.params, self.opt_state, batch)
                m = {k: float(v) for k, v in m.items()}
                m["step"] = step
                m["step_s"] = time.time() - t0
                self.history.append(m)
                if verbose and step % self.cfg.log_every == 0:
                    print(f"step {step}: loss={m['loss']:.4f} "
                          f"gnorm={m.get('gnorm', 0):.3f} "
                          f"({m['step_s']*1e3:.0f}ms)", flush=True)
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step + 1)
                if self._interrupted:
                    self._save(step + 1, block=True)   # preemption checkpoint
                    break
        finally:
            signal.signal(signal.SIGTERM, old)
        self.ckpt.wait()
        return self.history
