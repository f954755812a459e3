"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; without a card they skip. They
import nothing of JAX, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances (fp32): kron_gather atol 1e-4 — outputs are sums of up to 32
unit-variance LN rows and the kernel takes the order-2 LN moments by the
separable formula; kron_matmul atol 1e-4 + rtol 1e-5 — the kernel sums a
depth-(r·q2) contraction in another order than the plain chain. The paged
split and combine: atol 1e-5 + rtol 1e-5 in fp32 (the same page-by-page
online softmax in another summation order); with bf16/fp16 pools atol 1e-2
+ rtol 1e-3, because a probability rounded to 16 bits before the PV product
can land one unit (2^-9 at 0.5 in bf16) apart when its fp32 score differs
in the last bit, times |v| up to about 5.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attn import ops as FA
from repro_torch.kernels.kron_gather import ops as G
from repro_torch.kernels.kron_matmul import ops as M
from repro_torch.models import model as MD
from repro_torch.serve.cache import identity_ptab

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


def _paged_inputs(dev, dtype, B, H, KVH, Dh, ps, NP, lens, seed=0):
    """Random pools with a NaN trash page (row 0), a permuted table whose
    entries past each slot's valid pages are trash, unless the slot runs
    past the table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + B * NP
    q = torch.randn((B, H, Dh), generator=g, device=dev).to(dtype)
    kp = torch.randn((P, ps, KVH, Dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, ps, KVH, Dh), generator=g, device=dev).to(dtype)
    kp[0] = float("nan")
    vp[0] = float("nan")
    ptab = (torch.randperm(P - 1, generator=g, device=dev)[:B * NP] + 1).reshape(B, NP)
    for b, n in enumerate(lens):
        ptab[b, -(-n // ps):] = 0  # past the table: fully mapped
    return q, kp, vp, ptab.to(torch.int32), torch.tensor(lens, dtype=torch.int32,
                                                          device=dev)


PAGED = [  # dtype, B, H, KVH, Dh, ps, NP, lens
    (torch.float32, 3, 4, 2, 16, 4, 5, (0, 13, 23)),
    (torch.float32, 8, 16, 8, 128, 16, 32, (0, 1, 17, 100, 512, 600, 333, 16)),
    (torch.bfloat16, 8, 16, 8, 128, 16, 32, (0, 1, 17, 100, 512, 600, 333, 16)),
    (torch.float16, 2, 8, 1, 64, 8, 6, (47, 5)),
]
PAGED_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-3),
             torch.float16: dict(atol=1e-2, rtol=1e-3)}


@pytest.mark.parametrize("kv_splits", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype,B,H,KVH,Dh,ps,NP,lens", PAGED)
def test_paged_split_and_combine_kernels_match_plain(dev, kv_splits, dtype, B, H, KVH,
                                                     Dh, ps, NP, lens):
    args = _paged_inputs(dev, dtype, B, H, KVH, Dh, ps, NP, lens)
    before = dict(FA.launches)
    got = FA.paged_attention_split(*args, kv_splits=kv_splits)
    out = FA.combine_splits(*got)
    torch.cuda.synchronize()
    assert FA.launches == {k: v + 1 for k, v in before.items()}
    want = FA.paged_attention_split(*args, kv_splits=kv_splits, use_kernel=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **PAGED_TOL[dtype])
    torch.testing.assert_close(out, FA.combine_splits(*got, use_kernel=False),
                               atol=1e-5, rtol=1e-5)
    assert (out[0] == 0).all() == (lens[0] == 0)


def test_paged_kernels_refuse_unsupported_shapes(dev):
    q, kp, vp, ptab, lens = _paged_inputs(dev, torch.bfloat16, 2, 6, 2, 128, 16, 4,
                                          (5, 9))
    with pytest.raises(ValueError):  # group 3
        FA.paged_attention_split(q, kp, vp, ptab, lens, kv_splits=2)
    with pytest.raises(ValueError):  # int64 table
        FA.paged_attention_split(q[:, :4].contiguous(), kp, vp, ptab.long(), lens,
                                 kv_splits=2)


def test_smoke_paged_serving_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    params = MD.init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    lens = torch.tensor([8, 5], device=dev, dtype=torch.int32)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, use_kernels=False)):
        cache = identity_ptab(MD.init_cache(c, 2, 64, paged=True, device=dev), 2)
        logits, cache = MD.prefill_chunk_fn(params, c, cache, toks, lens)
        before = dict(FA.launches)
        step_logits, cache = MD.serve_step_fn(params, c, cache, logits.argmax(-1).int())
        launched = FA.launches["paged_split"] - before["paged_split"]
        assert launched == (cfg.num_layers if c.use_kernels is None else 0)
        outs.append(step_logits)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-5)
