"""Parity of the port's Kronecker algebra (repro_torch.core.kron and the
plain kernel math in repro_torch.kernels.common) with the JAX package.

Index maps and factorizations must agree exactly (converted factor shapes
depend on them); the tree and the chain agree to fp32 rounding (atol/rtol
1e-5 for the tree, whose values are O(1); 1e-4 for the chain, summed over
contraction depths up to r·q).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kron as JK
from repro.kernels import common as JC
from repro_torch.core import kron as TK
from repro_torch.kernels import common as TC

torch.set_num_threads(2)

RADICES = [(7,), (390, 390), (32, 32), (5, 3, 4), (4, 4, 4, 4), (19, 19, 19, 19)]


@pytest.mark.parametrize("radices", RADICES, ids=str)
def test_mixed_radix_digits_match_jax(radices):
    total = int(np.prod(radices))
    ids = np.random.default_rng(0).integers(0, total, size=64)
    ids[:2] = (0, total - 1)
    want = JK.mixed_radix_digits(jnp.asarray(ids, jnp.int32), radices)
    got = TK.mixed_radix_digits(torch.from_numpy(ids), radices)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    np.testing.assert_array_equal(TK.mixed_radix_recompose(got, radices).numpy(), ids)


DIMS = [2, 64, 100, 300, 400, 1024, 2048, 4096, 6144, 30428, 118655, 151936, 152064,
        256000]


@pytest.mark.parametrize("order", [2, 3, 4])
def test_factorizations_match_jax(order):
    for dim in DIMS:
        assert TK.choose_factorization(dim, order) == JK.choose_factorization(dim, order)
        try:
            want = JK.factorize_dim(dim, order)
        except ValueError:
            with pytest.raises(ValueError):
                TK.factorize_dim(dim, order)
        else:
            assert TK.factorize_dim(dim, order) == want


def test_largest_divisor_leq_matches_jax():
    for n in (1, 7, 12, 390, 391):
        for k in (1, 2, 5, 13, 390, 1000):
            assert TC.largest_divisor_leq(n, k) == JC.largest_divisor_leq(n, k)
    with pytest.raises(ValueError):
        TC.largest_divisor_leq(12, 0)


TREE_Q = {2: (8, 4), 3: (3, 4, 2), 4: (2, 3, 2, 2)}


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("ln", [True, False])
def test_tree_forward_matches_jax(order, ln):
    rng = np.random.default_rng(order)
    leaves = [rng.standard_normal((5, 3, q)).astype(np.float32) for q in TREE_Q[order]]
    want, _ = JC.tree_forward([jnp.asarray(v) for v in leaves], ln)
    got = TC.tree_forward([torch.from_numpy(v) for v in leaves], ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    tree = TK.kron_vectors_tree([torch.from_numpy(v) for v in leaves], use_layernorm=ln)
    jtree = JK.kron_vectors_tree([jnp.asarray(v) for v in leaves], use_layernorm=ln)
    np.testing.assert_allclose(tree.numpy(), np.asarray(jtree), atol=1e-5, rtol=1e-5)


CHAIN = {1: ((12,), (9,)), 2: ((8, 4), (6, 5)), 3: ((3, 2, 4), (4, 3, 2)),
         4: ((2, 3, 2, 2), (3, 2, 2, 3))}


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_chain_fused_forward_matches_jax(order):
    rng = np.random.default_rng(10 + order)
    q, t = CHAIN[order]
    factors = [rng.standard_normal((3, qj, tj)).astype(np.float32) for qj, tj in zip(q, t)]
    x = rng.standard_normal((4, int(np.prod(q)))).astype(np.float32)
    want = JC.chain_fused_forward(jnp.asarray(x), [jnp.asarray(f) for f in factors])
    got = TC.chain_fused_forward(torch.from_numpy(x), [torch.from_numpy(f) for f in factors])
    assert got.dtype == torch.float32 and got.shape == (4, int(np.prod(t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_layernorm_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 7, 33)).astype(np.float32)
    np.testing.assert_allclose(TK.layernorm(torch.from_numpy(x)).numpy(),
                               np.asarray(JK.layernorm(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
