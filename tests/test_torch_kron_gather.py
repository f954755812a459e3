"""Parity of the port's word2ketXS lookup (repro_torch.kernels.kron_gather)
with the JAX package: the plain version against ``kron_gather_ref`` and
against the Pallas kernel in interpret mode (as tests/test_kernels.py runs
it), plus the route and the wrapper's input checks, which run here.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerance: atol 1e-5, rtol 1e-5 in fp32 — outputs are sums
of a few unit-variance LN rows, and only the reduction order differs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import embedding_for as jax_embedding_for
from repro.core.embedding import embed_lookup as jax_embed_lookup
from repro.kernels.kron_gather.kron_gather import kron_gather_pallas
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
