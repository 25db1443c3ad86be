import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_corpus():
    from repro.data.synthetic import make_corpus
    return make_corpus(n_docs=2000, n_queries=24, n_clusters=32,
                       mean_len=30, max_len=64, seed=0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason without one")
