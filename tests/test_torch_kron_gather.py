"""Parity of the port's word2ketXS lookup (repro_torch.kernels.kron_gather)
with the JAX package: the plain version against ``kron_gather_ref`` and
against the Pallas kernel in interpret mode (as tests/test_kernels.py runs
it); the stats leg and the plain backward against ``kron_gather_fwd_pallas``
and ``kron_gather_bwd_pallas`` (interpret) and ``kron_gather_bwd_host``; a
float64 ``gradcheck`` of the autograd Function on its CPU route; plus the
route and the wrapper's input checks, which run here.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerance: atol 1e-5, rtol 1e-5 in fp32 for outputs, stats
and factor gradients — sums of a few unit-variance LN rows and of a few
dozen cotangent products, where only the reduction order differs; the
float64 gradcheck keeps torch's default eps 1e-6, atol 1e-5, rtol 1e-3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import embedding_for as jax_embedding_for
from repro.core.embedding import embed_lookup as jax_embed_lookup
from repro.kernels.kron_gather.kron_gather import (kron_gather_bwd_host,
                                                   kron_gather_bwd_pallas,
                                                   kron_gather_fwd_pallas, kron_gather_pallas)
from repro.kernels.kron_gather.ref import kron_gather_ref as jax_gather_ref
from repro_torch.configs import get_smoke
from repro_torch.configs.base import embedding_for
from repro_torch.core import ketops
from repro_torch.core.embedding import embed_lookup
from repro_torch.kernels import kernel_route
from repro_torch.kernels.kron_gather import ops as G

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)

# (rank, q_dims, t_dims, N, block_b of the Pallas run, LN)
CASES = [
    (2, (8, 8), (32, 32), 37, 16, True),      # the smoke embedding, ragged N
    (3, (8, 4), (17, 13), 5, 8, False),       # LN off, N < block
    (2, (4, 3, 2), (5, 4, 3), 21, 8, True),   # order 3
    (1, (2, 2, 2, 2), (3, 3, 3, 3), 9, 8, True),  # order 4
]


def _factors(seed, rank, q_dims, t_dims):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rank, q, t)) * 0.3).astype(np.float32)
            for q, t in zip(q_dims, t_dims)]


def _ids(seed, t_dims, n):
    total = math.prod(t_dims)
    ids = np.random.default_rng(seed + 100).integers(0, total, size=n).astype(np.int32)
    ids[0], ids[-1] = 0, total - 1
    return ids


@pytest.mark.parametrize("rank,q,t,n,blk,ln", CASES)
def test_plain_matches_jax_ref_and_pallas(rank, q, t, n, blk, ln):
    factors = _factors(rank, rank, q, t)
    ids = _ids(rank, t, n)
    embed_dim = math.prod(q) - 1  # exercises the slice
    got = G.kron_gather([torch.from_numpy(f) for f in factors], torch.from_numpy(ids),
                        embed_dim, ln)
    assert got.shape == (n, embed_dim) and got.dtype == torch.float32
    jf = [jnp.asarray(f) for f in factors]
    ref = jax_gather_ref(jf, jnp.asarray(ids), embed_dim=embed_dim, use_layernorm=ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    pallas = kron_gather_pallas(jf, jnp.asarray(ids), use_layernorm=ln, block_b=blk,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas)[:, :embed_dim], **TOL)


# (rank, q_dims, t_dims, N, block_b, LN): orders 2 and 3, with and without LN
GRAD_CASES = [
    (2, (8, 8), (32, 32), 37, 16, True),
    (3, (8, 4), (17, 13), 21, 8, False),
    (3, (4, 3, 2), (5, 4, 3), 13, 8, True),
    (2, (4, 3, 2), (5, 4, 3), 13, 8, False),
]


@pytest.mark.parametrize("rank,q,t,n,blk,ln", GRAD_CASES)
def test_stats_leg_and_backward_match_jax(rank, q, t, n, blk, ln):
    factors = _factors(10 + rank, rank, q, t)
    ids = _ids(rank, t, n)
    ids[1] = ids[2]  # a repeated id sums two cotangent rows into one column
    embed_dim = math.prod(q) - 1
    g = np.random.default_rng(5).standard_normal((n, embed_dim)).astype(np.float32)
    jf = [jnp.asarray(f) for f in factors]
    out_j, stats_j = kron_gather_fwd_pallas(jf, jnp.asarray(ids), use_layernorm=ln,
                                            block_b=blk, interpret=True)
    tf = [torch.from_numpy(f) for f in factors]
    out, stats = G.kron_gather_fwd_ref(tf, torch.from_numpy(ids), embed_dim=embed_dim,
                                       use_layernorm=ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j)[:, :embed_dim], **TOL)
    if ln:
        assert stats.shape == (n, 2 * (len(q) - 1), rank)
        np.testing.assert_allclose(stats.numpy(), np.asarray(stats_j), **TOL)
    else:
        assert stats is None and stats_j is None
    got = G.kron_gather_bwd_ref(tf, torch.from_numpy(ids), torch.from_numpy(g), stats,
                                use_layernorm=ln)
    gj = jnp.asarray(g)
    for want in (kron_gather_bwd_pallas(jf, jnp.asarray(ids), gj, stats_j,
                                        use_layernorm=ln, block_b=blk, interpret=True),
                 kron_gather_bwd_host(jf, jnp.asarray(ids), gj, stats_j, use_layernorm=ln)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_lookup_gradient_matches_jax_vjp():
    """Autograd through ``kron_gather`` (the Function, CPU route) equals the
    VJP of the JAX lookup."""
    factors = _factors(21, 2, (8, 8), (32, 32))
    ids = _ids(21, (32, 32), 19)
    g = np.random.default_rng(22).standard_normal((19, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda fs: jax_gather_ref(fs, jnp.asarray(ids), embed_dim=64),
                     [jnp.asarray(f) for f in factors])
    (want,) = vjp(jnp.asarray(g))
    tf = [torch.from_numpy(f).requires_grad_(True) for f in factors]
    out = G.kron_gather(tf, torch.from_numpy(ids), 64, True)
    out.backward(torch.from_numpy(g))
    for f, w in zip(tf, want):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("q,t,ln", [((4, 3), (5, 4), True), ((3, 2, 2), (2, 3, 2), True),
                                    ((4, 3), (5, 4), False)])
def test_autograd_function_gradcheck(q, t, ln):
    rng = np.random.default_rng(len(q))
    fs = tuple(torch.from_numpy(rng.standard_normal((2, qj, tj)) * 0.5).requires_grad_(True)
               for qj, tj in zip(q, t))
    ids = torch.tensor([0, 3, 3, math.prod(t) - 1, 7], dtype=torch.int32)
    dim = math.prod(q) - 1

    def fn(*factors):
        return G.KronGather.apply(ids, dim, ln, False, *factors)

    assert torch.autograd.gradcheck(fn, fs, eps=1e-6, atol=1e-5, rtol=1e-3)


def test_forward_takes_the_stats_leg_only_for_a_gradient():
    f = [torch.from_numpy(x) for x in _factors(4, 2, (8, 8), (32, 32))]
    ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert G.kron_gather(f, ids, 64, True).grad_fn is None
    with torch.no_grad():
        assert G.kron_gather([x.requires_grad_(True) for x in f], ids, 64).grad_fn is None
    assert G.kron_gather(f, ids, 64).grad_fn is not None


def test_embed_lookup_matches_jax_on_smoke_config():
    jcfg = jax_embedding_for(jax_smoke("qwen3-1.7b", dtype=jnp.float32))
    tcfg = embedding_for(get_smoke("qwen3-1.7b", dtype=torch.float32))
    assert tcfg.spec.resolved_q() == jcfg.spec.resolved_q() == (8, 8)
    assert tcfg.spec.resolved_t() == jcfg.spec.resolved_t() == (32, 32)
    factors = _factors(7, tcfg.rank, tcfg.resolved_q(), tcfg.resolved_t())
    ids = _ids(7, tcfg.resolved_t(), 24).reshape(4, 6)
    want = jax_embed_lookup(jcfg, {"factors": [jnp.asarray(f) for f in factors]},
                            jnp.asarray(ids))
    got = embed_lookup(tcfg, {"factors": [torch.from_numpy(f) for f in factors]},
                       torch.from_numpy(ids))
    assert got.shape == (4, 6, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_materialize_rows_are_lookups():
    tcfg = embedding_for(get_smoke("qwen3-1.7b", dtype=torch.float32))
    params = {"factors": [torch.from_numpy(f) for f in
                          _factors(3, tcfg.rank, tcfg.resolved_q(), tcfg.resolved_t())]}
    table = ketops.materialize(tcfg.spec, params, chunk=100)
    assert table.shape == (1024, 64)
    ids = torch.tensor([0, 99, 100, 1023])
    torch.testing.assert_close(table[ids], embed_lookup(tcfg, params, ids), **TOL)


def test_route_is_decided_by_the_tensor():
    cpu = torch.zeros(3, dtype=torch.int32)
    assert kernel_route(None, cpu) is False
    assert kernel_route(True, cpu) is False
    assert kernel_route(False, torch.zeros(3, device="meta")) is False
    with pytest.raises(ValueError):
        kernel_route(None, torch.zeros(3, device="meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    f = [torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        G.kron_gather_cuda(f, torch.zeros(3, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="CUDA"):
        G.kron_gather_bwd_cuda(f, torch.zeros(3, dtype=torch.int32), torch.zeros(3, 64),
                               torch.zeros(3, 2, 2))


@pytest.mark.parametrize("bad", ["order", "ids_dtype", "factor_dtype", "rank",
                                 "embed_dim", "noncontig"])
def test_input_checks(bad):
    f = [torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)]
    ids = torch.zeros(5, dtype=torch.int32)
    dim = 64
    if bad == "order":
        f = f + [torch.zeros(2, 2, 2)]
        with pytest.raises(NotImplementedError):
            G.check_inputs(f, ids, dim)
        return
    if bad == "ids_dtype":
        ids = ids.long()
    elif bad == "factor_dtype":
        f = [f[0].double(), f[1]]
    elif bad == "rank":
        f = [f[0], torch.zeros(3, 8, 32)]
    elif bad == "embed_dim":
        dim = 65
    elif bad == "noncontig":
        f = [torch.zeros(2, 32, 8).transpose(1, 2), f[1]]
    with pytest.raises(ValueError):
        G.check_inputs(f, ids, dim)
    G.check_inputs([torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)],
                   torch.zeros(5, dtype=torch.int32), 64)
