"""The averaging's divisions on the CPU and on the card.

The reference divides as XLA does: correctly rounded fp32 quotients
(``acc / I``, ``/ K``, ``/ W``, ``/ P``, int8's ``/ 127``).  On CUDA,
torch divides by a host scalar as a multiply by its reciprocal, up to one
ulp off, so ``bucketing.div`` divides by a tensor on the data's device.
Held here: ``div`` is the correctly rounded quotient (an fp32 quotient
computed in fp64 and rounded once is correctly rounded), and int8
quantization on the card equals the CPU's bitwise.  The card cases need
no jax: ``PYTHONPATH=src python -m pytest --noconftest -q -m cuda
tests/test_torch_bucketing.py``.
"""
import pytest
import torch

from repro_torch.core import bucketing as B
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device(request.param)


def _x(device, n=1 << 16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, generator=g) * torch.rand(n, generator=g) * 100).to(device)


@pytest.mark.parametrize("d", [3, 7, 127.0, 6])
def test_div_is_the_correctly_rounded_quotient(device, d):
    x = _x(device)
    want = (x.double() / d).float()
    assert torch.equal(B.div(x, d), want)
    assert torch.equal(B.div(x, torch.tensor(float(d), device=device)), want)
    assert torch.equal(B.mean0(x.reshape(4, -1)),
                       (x.reshape(4, -1).sum(0).double() / 4).float())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int8_quantize_on_the_card_equals_the_cpu(cuda_device):
    """Per-row max-abs scales (``/ 127``, a true division) and the rounded
    int8 payload, on [K, n] rows as the averaging quantizes them."""
    x = _x(torch.device("cpu"), seed=1).reshape(8, -1)
    q_cpu, s_cpu = B.int8_quantize(x, (1,))
    q, s = B.int8_quantize(x.to(cuda_device), (1,))
    assert torch.equal(s.cpu(), s_cpu) and torch.equal(q.cpu(), q_cpu)
