"""Training launcher: ``python -m repro_torch.launch.train --arch colberter
--steps 200``. Trains on the card (``--device cpu`` to train on the CPU):
LM pretraining (a dense LM such as ``--arch smollm-135m``, or an MoE LM
such as ``--arch granite-moe-1b-a400m``, whose loss adds the routers' aux
loss) or ColBERTer contrastive retrieval training (``--arch colberter``),
with checkpoint/resume. The weights start from seed 0 on a CPU generator
through the model's ``init_params``, so the card and the CPU start alike.
The last line gives the final and first losses, and the LM's last ``ce``
and ``aux``."""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="colberter")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    gen = torch.Generator().manual_seed(0)

    if cfg.family in ("lm-dense", "lm-moe"):
        from repro_torch.data.synthetic import make_lm_batch
        from repro_torch.models import transformer as M
        if args.smoke:
            cfg = M.smoke_config(cfg)
        params = M.init_params(cfg, gen, dev)

        def data_fn(step):
            b = make_lm_batch(step, args.batch, args.seq, cfg.vocab_size)
            return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

        def loss_fn(p, b):
            return M.loss_fn(cfg, p, b)
    elif cfg.family == "retrieval":
        from repro_torch.models import colberter as M
        if args.smoke:
            cfg = M.smoke_config(cfg)
        params = M.init_params(cfg, gen, dev)

        def data_fn(step):
            r = np.random.default_rng(step)
            return {
                "query_tokens": torch.as_tensor(r.integers(
                    0, cfg.vocab_size, (args.batch, cfg.max_query_len)),
                    dtype=torch.int32, device=dev),
                "pos_doc_tokens": torch.as_tensor(r.integers(
                    0, cfg.vocab_size, (args.batch, cfg.max_doc_len)),
                    dtype=torch.int32, device=dev),
            }

        def loss_fn(p, b):
            return M.contrastive_loss(cfg, p, b)
    else:
        raise SystemExit(f"train launcher supports LM/retrieval archs, "
                         f"not {cfg.family}")

    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={args.arch} params={n_params/1e6:.1f}M device={dev}")
    tr = Trainer(TrainerConfig(total_steps=args.steps, ckpt_every=50,
                               log_every=10, grad_accum=args.grad_accum,
                               ckpt_dir=args.ckpt_dir,
                               grad_compression=args.grad_compression),
                 loss_fn, AdamW(lr=args.lr), data_fn, params)
    if args.resume:
        print("resumed at", tr.maybe_resume())
    hist = tr.run()
    parts = "".join(f" {k}={hist[-1][k]:.4f}" for k in ("ce", "aux")
                    if k in hist[-1])
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f}){parts}")


if __name__ == "__main__":
    main()
