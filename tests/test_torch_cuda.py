"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; without a card they skip. They
import nothing of JAX, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances (fp32): kron_gather atol 1e-4 — outputs are sums of up to 32
unit-variance LN rows and the kernel takes the order-2 LN moments by the
separable formula; kron_matmul atol 1e-4 + rtol 1e-5 — the kernel sums a
depth-(r·q2) contraction in another order than the plain chain.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.kron_gather import ops as G
from repro_torch.kernels.kron_matmul import ops as M
from repro_torch.models import model as MD

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain chain in full fp32
    return torch.device("cuda")


def _factors(dev, rank, q, t, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((rank, qj, tj), generator=g, device=dev) * 0.3
            for qj, tj in zip(q, t)]


GATHER = [(2, (8, 8), (32, 32), 37, True), (3, (8, 4), (17, 13), 5, False),
          (32, (64, 32), (390, 390), 131, True)]


@pytest.mark.parametrize("rank,q,t,n,ln", GATHER)
def test_kron_gather_kernel_matches_plain(dev, rank, q, t, n, ln):
    f = _factors(dev, rank, q, t)
    total = math.prod(t)
    ids = torch.randint(0, total, (n,), device=dev, dtype=torch.int32)
    ids[0], ids[-1] = 0, total - 1
    dim = math.prod(q) - 1
    before = G.launches
    got = G.kron_gather(f, ids, dim, ln)
    torch.cuda.synchronize()
    assert G.launches == before + 1
    want = G.kron_gather(f, ids, dim, ln, use_kernel=False)
    assert got.shape == (n, dim) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_kron_gather_out_of_range_ids_give_nan_rows(dev):
    f = _factors(dev, 2, (8, 8), (32, 32))
    got = G.kron_gather(f, torch.tensor([-1, 5, 1024], device=dev, dtype=torch.int32), 64)
    assert torch.isnan(got[0]).all() and torch.isnan(got[2]).all()
    assert torch.isfinite(got[1]).all()


MATMUL = [(2, (8, 8), (32, 32), 3, 64, 1024), (4, (8, 4), (17, 13), 5, 29, 200),
          (32, (64, 32), (390, 390), 8, 2048, 151936),
          (32, (64, 32), (390, 390), 1, 2048, 151936)]


@pytest.mark.parametrize("rank,q,t,b,d_in,out_dim", MATMUL)
def test_kron_matmul_kernel_matches_plain(dev, rank, q, t, b, d_in, out_dim):
    f = _factors(dev, rank, q, t)
    x = torch.randn((b, d_in), device=dev)
    before = M.launches
    got = M.kron_matmul(f, x, out_dim)
    torch.cuda.synchronize()
    assert M.launches == before + 1
    want = M.kron_matmul(f, x, out_dim, use_kernel=False)
    assert got.shape == (b, out_dim) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_order_3_is_refused_on_the_card(dev):
    f = _factors(dev, 2, (2, 2, 2), (3, 3, 3))
    with pytest.raises(NotImplementedError):
        G.kron_gather(f, torch.zeros(2, device=dev, dtype=torch.int32), 8)
    with pytest.raises(NotImplementedError):
        M.kron_matmul(f, torch.zeros(2, 8, device=dev), 27)


def test_smoke_serving_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    params = MD.init_params(cfg, seed=0, device=dev)
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    lens = torch.tensor([8, 5], device=dev, dtype=torch.int32)
    outs = []
    for c in (cfg, plain_cfg):
        cache = MD.init_cache(c, 2, 16, device=dev)
        logits, cache = MD.prefill_chunk_fn(params, c, cache, toks, lens)
        step_logits, cache = MD.serve_step_fn(params, c, cache, logits.argmax(-1).int())
        outs.append((logits, step_logits))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
