"""Seeded, vectorized generators of the benchmark's inputs.

Copies of the program's ``data/synthetic.make_corpus`` (the corpus and its
uniform queries) and ``serve/workload.affinity_queries`` (Zipf-skewed
queries), made in a few large calls on one ``torch`` device from one
``torch.Generator``: the same seed on the same kind of device gives the same
inputs. They draw from the same distributions as the program's generators,
not the same numbers:

- CLS vectors on a ``d_latent``-dim manifold, ``unit(z @ W + noise)``;
  documents' topics from the nearest latent anchor.
- Token counts ``clip(U**(-1/2.5) * 0.6 * mean_len, 8, max_len)``:
  numpy's ``pareto(2.5) + 1`` is ``U**(-1/2.5)``.
- Each document's first ``int(t * topical_frac)`` tokens are topical terms
  of its topic's pool, the rest uniform over the vocabulary. The program
  shuffles a document's tokens; that order is left out here, because
  MaxSim takes a maximum over a document's tokens and queries draw token
  positions uniformly, so no score or statistic depends on it.
- Uniform queries perturb a uniform target document in latent space;
  Zipf queries perturb a target drawn with popularity ``rank**-alpha`` over
  a seeded permutation, in CLS space, and sample the target's stored token
  rows. Both add ``token_noise`` to each query token and renormalize.

Token vectors are handed over in float16, the layout's stored type (the
layout would cast them to it), so the program and the reference see the
same stored values.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Corpus:
    cls: np.ndarray          # (N, d_cls) float32, unit rows
    tokens: np.ndarray       # (T, d_bow) float16, all documents' tokens
    lens: np.ndarray         # (N,) int64 tokens a document
    starts: np.ndarray       # (N,) int64 first token row of each document
    z: torch.Tensor          # (N, d_latent) latent points, on the device
    W: torch.Tensor          # (d_latent, d_cls)
    terms: torch.Tensor      # (n_terms, d_bow) unit term vectors
    tids: torch.Tensor       # (T,) int64 term of each token, on the device
    starts_dev: torch.Tensor
    lens_dev: torch.Tensor

    @property
    def n_docs(self) -> int:
        return len(self.lens)

    def bow_list(self) -> list[np.ndarray]:
        """Per-document views of ``tokens``, the program's input form."""
        return np.split(self.tokens, self.starts[1:])

    def release_device(self) -> None:
        """Drop the device-side tensors the query generators need."""
        self.z = self.W = self.terms = self.tids = None
        self.starts_dev = self.lens_dev = None


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def _normal(g, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def _uniform(g, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**64))
    return g


def make_cls(spec: dict, g: torch.Generator, device):
    """The corpus's first draws: the latent map ``W``, the latent points
    ``z`` and the unit CLS vectors (all ``make_corpus`` draws before its
    tokens)."""
    n, d_cls, d_lat = spec["n_docs"], spec["d_cls"], spec["d_latent"]
    W = _normal(g, (d_lat, d_cls), device) / float(np.sqrt(d_lat))
    z = _normal(g, (n, d_lat), device)
    cls = _unit(z @ W + spec["manifold_noise"]
                * _normal(g, (n, d_cls), device))
    return W, z, cls


def make_corpus(spec: dict, g: torch.Generator, device,
                token_chunk: int = 1 << 23) -> Corpus:
    """The corpus ``spec`` (a config's ``corpus`` section) describes."""
    n, d_bow = spec["n_docs"], spec["d_bow"]
    d_lat, n_clusters = spec["d_latent"], spec["n_clusters"]
    n_terms, pool = spec["n_terms"], spec["topic_pool"]
    W, z, cls = make_cls(spec, g, device)
    anchors = _normal(g, (n_clusters, d_lat), device)
    topic = torch.cat([torch.argmax(z[i:i + 65536] @ anchors.T, dim=-1)
                       for i in range(0, n, 65536)])
    u = _uniform(g, (n,), device).clamp_min(1e-300)
    lens = torch.clamp(u ** (-1.0 / 2.5) * (spec["mean_len"] * 0.6), 8,
                       spec["max_len"]).to(torch.int64)
    terms = _unit(_normal(g, (n_terms, d_bow), device))
    topic_pool = torch.randint(0, n_terms, (n_clusters, pool), generator=g,
                               device=device)
    starts = torch.cumsum(lens, 0) - lens
    total = int(lens.sum())
    n_topic = (lens.double() * spec["topical_frac"]).to(torch.int64)
    tids = torch.empty(total, dtype=torch.int64, device=device)
    tokens = np.empty((total, d_bow), np.float16)
    doc_of = torch.repeat_interleave(torch.arange(n, device=device), lens)
    for t0 in range(0, total, token_chunk):
        t1 = min(total, t0 + token_chunk)
        d = doc_of[t0:t1]
        pos = torch.arange(t0, t1, device=device) - starts[d]
        pick = torch.randint(0, pool, (t1 - t0,), generator=g, device=device)
        spec_t = torch.randint(0, n_terms, (t1 - t0,), generator=g,
                               device=device)
        tids[t0:t1] = torch.where(pos < n_topic[d],
                                  topic_pool[topic[d], pick], spec_t)
        tokens[t0:t1] = terms[tids[t0:t1]].half().cpu().numpy()
    del doc_of
    return Corpus(cls=cls.cpu().numpy(), tokens=tokens,
                  lens=lens.cpu().numpy(), starts=starts.cpu().numpy(),
                  z=z, W=W, terms=terms, tids=tids, starts_dev=starts,
                  lens_dev=lens)


@dataclass
class Queries:
    cls: np.ndarray          # (Q, d_cls) float32
    bow: np.ndarray          # (Q, q_len, d_bow) float32
    lens: np.ndarray         # (Q,) int32
    targets: np.ndarray      # (Q,) int64


def _query_tokens(c: Corpus, targets: torch.Tensor, q_len: int,
                  noise: float, g, device) -> torch.Tensor:
    """``q_len`` noisy copies of token rows of each target, renormalized."""
    take = (_uniform(g, (len(targets), q_len), device)
            * c.lens_dev[targets][:, None]).to(torch.int64)
    take = torch.minimum(take, c.lens_dev[targets][:, None] - 1)
    rows = c.terms[c.tids[c.starts_dev[targets][:, None] + take]]
    return _unit(rows + noise * _normal(g, rows.shape, device))


def uniform_queries(c: Corpus, spec: dict, traffic: dict, n: int,
                    g: torch.Generator, device) -> Queries:
    """``make_corpus``'s query model: uniform targets, perturbed in latent
    space, tokens drawn from the target's terms."""
    q_len = traffic["q_len"]
    targets = torch.randint(0, c.n_docs, (n,), generator=g, device=device)
    zq = c.z[targets] + traffic["query_noise"] * _normal(
        g, (n, c.z.shape[1]), device)
    q_cls = _unit(zq @ c.W + spec["manifold_noise"]
                  * _normal(g, (n, c.W.shape[1]), device))
    q_bow = _query_tokens(c, targets, q_len, traffic["token_noise"], g,
                          device)
    return Queries(cls=q_cls.cpu().numpy(), bow=q_bow.cpu().numpy(),
                   lens=np.full(n, q_len, np.int32),
                   targets=targets.cpu().numpy())


def zipf_queries(c: Corpus, traffic: dict, n: int, g: torch.Generator,
                 device) -> Queries:
    """``affinity_queries``: targets by popularity ``rank**-alpha`` over a
    seeded permutation of the doc ids, CLS noise in CLS space."""
    q_len = traffic["q_len"]
    order = torch.randperm(c.n_docs, generator=g, device=device)
    p = torch.arange(1, c.n_docs + 1, device=device,
                     dtype=torch.float64) ** (-traffic["zipf_alpha"])
    rank = torch.multinomial(p.float(), n, replacement=True, generator=g)
    targets = order[rank]
    cls = torch.as_tensor(c.cls, device=device)[targets]
    q_cls = _unit(cls + traffic["query_noise"]
                  * _normal(g, cls.shape, device))
    q_bow = _query_tokens(c, targets, q_len, traffic["token_noise"], g,
                          device)
    return Queries(cls=q_cls.cpu().numpy(), bow=q_bow.cpu().numpy(),
                   lens=np.full(n, q_len, np.int32),
                   targets=targets.cpu().numpy())


def make_queries(c: Corpus, spec: dict, traffic: dict, n: int,
                 g: torch.Generator, device) -> Queries:
    kind = traffic["queries"]
    if kind == "uniform":
        return uniform_queries(c, spec, traffic, n, g, device)
    if kind == "zipf":
        return zipf_queries(c, traffic, n, g, device)
    raise ValueError(f"unknown query model {kind!r}; expected uniform | zipf")


def arrival_times(traffic: dict, seconds: float,
                  g: torch.Generator) -> np.ndarray:
    """Open-loop arrival offsets in ``[0, seconds)``: ``rate * seconds``
    arrivals at sorted uniform times, a Poisson process given its count,
    so every seed offers the same number of requests. ``burst_factor`` > 1
    modulates the rate on and off (``burst_duty`` of each
    ``burst_period_s`` at the factor, the mean kept) by inverting the
    cumulative rate."""
    n = int(round(traffic["rate_qps"] * seconds))
    u = torch.sort(torch.rand(n, generator=g, device=g.device,
                              dtype=torch.float64)).values.cpu().numpy()
    factor = float(traffic.get("burst_factor", 1.0))
    if factor <= 1.0:
        return u * seconds
    duty, period = traffic["burst_duty"], traffic["burst_period_s"]
    off = max((1.0 - factor * duty) / (1.0 - duty), 0.0)
    grid = np.linspace(0.0, seconds, 200_001)
    rate = np.where((grid % period) / period < duty, factor, off)
    cum = np.concatenate([[0.0], np.cumsum((rate[1:] + rate[:-1]) / 2
                                           * np.diff(grid))])
    return np.interp(u * cum[-1], cum, grid)
