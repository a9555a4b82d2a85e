"""The port's test modules run their torch work on one thread.

The test workers already fill the host (``pytest -n 6`` on a few cores),
and torch's intra-op threads, one per core in every worker, then only
spin against each other: the smoke models' tensors are tiny, and a
replayed ``fit`` ran 10× slower with torch's default threads than on one.
Import ``one_torch_thread`` into a test module (it is module-scoped and
autouse) to run the module on one thread, the worker's count restored
after it; subprocesses that run the port get ``OMP_NUM_THREADS=1`` from
``one_thread_env``.  No jax here: the card-only test files import this too.
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_thread_env(**extra) -> dict:
    """The environment of a subprocess that runs the port: ``src`` on the
    path and one torch thread."""
    return dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1", **extra)
