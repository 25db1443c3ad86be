"""The generators repeat under a seed and keep the statistics of the
program's generators; the frozen kernel counts equal hand counts."""
import numpy as np
import pytest
import torch

from espnbench import gen, harness, kernel_counts, reference

SPEC = dict(harness.load_config("espn-colberter-1m")["corpus"],
            n_docs=4000, n_terms=1024)
BATCH = harness.load_traffic("batch64-uniform")
SERVE = harness.load_traffic("serve-zipf-poisson")


def _draw(seed):
    g = gen.generator(seed, "cpu")
    c = gen.make_corpus(SPEC, g, "cpu")
    q = gen.make_queries(c, SPEC, BATCH, 32, g, "cpu")
    z = gen.make_queries(c, SPEC, SERVE, 32, g, "cpu")
    a = gen.arrival_times(SERVE, 3.0, g)
    return c, q, z, a


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 3_000_000_001])
def test_same_seed_same_inputs(seed):
    (c1, q1, z1, a1), (c2, q2, z2, a2) = _draw(seed), _draw(seed)
    assert np.array_equal(c1.cls, c2.cls)
    assert np.array_equal(c1.tokens, c2.tokens)
    assert np.array_equal(c1.lens, c2.lens)
    for x, y in ((q1, q2), (z1, z2)):
        assert np.array_equal(x.cls, y.cls) and np.array_equal(x.bow, y.bow)
        assert np.array_equal(x.targets, y.targets)
    assert np.array_equal(a1, a2)


def test_other_seed_other_inputs():
    (c1, q1, _, a1), (c2, q2, _, a2) = _draw(1), _draw(2)
    assert not np.array_equal(c1.cls, c2.cls)
    assert not np.array_equal(q1.bow, q2.bow)
    assert not np.array_equal(a1, a2)


def test_corpus_statistics_follow_the_program():
    c, q, z, _ = _draw(5)
    assert c.cls.shape == (4000, 128) and c.tokens.dtype == np.float16
    assert np.allclose(np.linalg.norm(c.cls, axis=1), 1, atol=1e-5)
    assert c.lens.min() >= 8 and c.lens.max() <= 180
    # numpy's (pareto(2.5) + 1) * 36 has mean 60; the clip at 180 takes
    # about 3 of it
    assert 52 < c.lens.mean() < 62
    assert len(c.tokens) == c.lens.sum()
    assert np.array_equal(c.starts, np.cumsum(c.lens) - c.lens)
    assert len(c.bow_list()) == 4000
    assert q.bow.shape == (32, 24, 32) and (q.lens == 24).all()
    assert np.allclose(np.linalg.norm(q.bow, axis=2), 1, atol=1e-5)
    # a query's CLS vector lies nearer its target than a random doc
    near = (q.cls * c.cls[q.targets]).sum(1)
    assert near.mean() > (q.cls * c.cls[:32]).sum(1).mean() + 0.2


def test_zipf_queries_are_skewed_and_arrivals_counted():
    c, _, _, _ = _draw(6)
    g = gen.generator(9, "cpu")
    z = gen.make_queries(c, SPEC, SERVE, 4000, g, "cpu")
    _, counts = np.unique(z.targets, return_counts=True)
    # Zipf 1.1 over 4,000 docs: the hottest doc takes over 10% of 4,000
    assert counts.max() > 400
    a = gen.arrival_times(dict(SERVE, rate_qps=50.0), 4.0, g)
    assert len(a) == 200 and (np.diff(a) >= 0).all()
    assert 0 <= a.min() and a.max() < 4.0
    b = gen.arrival_times(dict(SERVE, rate_qps=50.0, burst_factor=4.0,
                               burst_duty=0.25, burst_period_s=0.5), 4.0, g)
    on = ((b % 0.5) / 0.5 < 0.25).mean()
    assert len(b) == 200 and on > 0.9


def test_maxsim_counts_by_hand():
    # K=3 docs, Lq=2, D=4, 5 valid tokens of fp16
    n_bytes, ops = kernel_counts.maxsim_work(3, 2, 4, 5.0, 2)
    assert n_bytes == 4 * (2 * 4 + 2 + 2 * 3) + 2 * 4 * 5
    assert ops == 2 * 2 * 2 * 4 * 5
    assert kernel_counts.maxsim_bound_s(3, 2, 4, 5.0) == max(
        n_bytes / 3.35e12, ops / 989e12)


def test_ivf_scan_and_path_counts_by_hand():
    n_bytes, ops = kernel_counts.ivf_scan_work(2, 3, 4)
    assert n_bytes == 4 * (2 * 4 + 3 * 4 + 2 * 3) and ops == 3 * 2 * 2 * 3 * 4
    assert kernel_counts.ivf_scan_bound_s(2, 3, 4) == max(
        n_bytes / 3.35e12, ops / 495e12)
    assert kernel_counts.path_flops(10, 4, 7, 2, 3, 11.0) == \
        2 * (10 * 4 + 7 * 4 + 2 * 3 * 11)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10,
                      -1.5 - 2**-12])
    got = reference.tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, -1.5]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_make_cls_draws_the_corpus_cls(seed):
    """The index readings' CLS vectors are the corpus's of the same seed."""
    _, _, cls = gen.make_cls(SPEC, gen.generator(seed, "cpu"), "cpu")
    c = gen.make_corpus(SPEC, gen.generator(seed, "cpu"), "cpu")
    assert np.array_equal(cls.numpy(), c.cls)
