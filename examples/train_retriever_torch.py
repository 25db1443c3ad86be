"""Train a ColBERTer-style late-interaction retriever with an in-batch
contrastive loss, then index + serve it through ESPN — the full lifecycle on
the PyTorch/CUDA port, the counterpart of ``examples/train_retriever.py``.
Everything runs on the card unless ``--device cpu`` is given.

Default is a small encoder (a few M params, 800 steps). --full configures
the paper-scale encoder (~110M params) — same code path.

    PYTHONPATH=src python examples/train_retriever_torch.py [--steps 200] [--full]
    PYTHONPATH=src python examples/train_retriever_torch.py --device cpu --steps 10
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.metrics import mrr_at_k
from repro_torch.device import resolve_device
from repro_torch.models import colberter as C
from repro_torch.pipeline import (IndexConfig, Pipeline, PipelineConfig,
                                  RetrievalConfig, StorageConfig)
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig


def synth_pairs(step: int, batch: int, cfg, device) -> dict:
    """Paired query/doc token ids: the query is a noisy subset of its doc."""
    r = np.random.default_rng(step)
    docs = r.integers(4, cfg.vocab_size, (batch, cfg.max_doc_len))
    take = r.integers(0, cfg.max_doc_len, (batch, cfg.max_query_len))
    qs = np.take_along_axis(docs, take, axis=1)
    drop = r.random((batch, cfg.max_query_len)) < 0.1
    qs = np.where(drop, r.integers(4, cfg.vocab_size, qs.shape), qs)
    return {"query_tokens": torch.as_tensor(qs, dtype=torch.int32,
                                            device=device),
            "pos_doc_tokens": torch.as_tensor(docs, dtype=torch.int32,
                                              device=device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_retriever_ckpt"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("colberter")
    if not args.full:
        cfg = C.smoke_config(cfg).scaled(d_model=128, n_layers=3, d_ff=256,
                                         vocab_size=4096, max_doc_len=48,
                                         max_query_len=12)
    model = C.init_params(cfg, torch.Generator().manual_seed(0), dev)
    init_model = C.init_params(cfg, torch.Generator().manual_seed(0), dev)
    print(f"encoder params: "
          f"{sum(p.numel() for p in model.parameters())/1e6:.1f}M on {dev}")

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=100, log_every=20,
                      ckpt_dir=args.ckpt_dir),
        lambda p, b: C.contrastive_loss(cfg, p, b),
        AdamW(lr=1e-3, grad_clip=5.0, warmup_steps=30),
        lambda step: synth_pairs(step, args.batch, cfg, dev),
        model)
    hist = trainer.run()
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # index a small corpus with the trained encoder and check retrieval
    print("indexing 2000 docs with the trained encoder ...")
    r = np.random.default_rng(123)
    doc_toks = r.integers(4, cfg.vocab_size, (2000, cfg.max_doc_len))

    def build_and_eval(params, label):
        cls_list, bow_list = [], []
        for s0 in range(0, 2000, 250):
            cls, bow, _ = C.encode(cfg, params, doc_toks[s0:s0 + 250])
            cls_list.append(cls.float().cpu().numpy())
            bow_list.append(bow.float().cpu().numpy())
        cls = np.concatenate(cls_list)
        bows = list(np.concatenate(bow_list))

        pcfg = PipelineConfig(
            index=IndexConfig(ncells=16, iters=5),
            storage=StorageConfig(t_max=cfg.max_doc_len),
            retrieval=RetrievalConfig(mode="espn", nprobe=8,
                                      k_candidates=100, prefetch_step=0.3))
        pipe = Pipeline.from_embeddings(pcfg, cls, bows, device=dev)
        # queries = noisy subsets of docs 0..31
        rq = np.random.default_rng(7)
        take = rq.integers(0, cfg.max_doc_len, (32, cfg.max_query_len))
        q_toks = np.take_along_axis(doc_toks[:32], take, axis=1)
        q_cls, q_bow, _ = C.encode(cfg, params, q_toks)
        resp = pipe.search(q_cls.float().cpu().numpy(),
                           q_bow.float().cpu().numpy(),
                           np.full(32, cfg.max_query_len, np.int32))
        ranked = [x.doc_ids for x in resp.ranked]
        qrels = [{i} for i in range(32)]
        mrr = mrr_at_k(ranked, qrels, 10)
        print(f"self-retrieval MRR@10 ({label}): {mrr:.3f}")
        pipe.close()
        return mrr

    m0 = build_and_eval(init_model, "untrained encoder")
    m1 = build_and_eval(model, f"trained {args.steps} steps")
    print(f"training gain: {m1/max(m0, 1e-3):.1f}x "
          f"(quality keeps climbing with steps; --full --steps 20000 is the "
          f"paper-scale configuration)")


if __name__ == "__main__":
    main()
