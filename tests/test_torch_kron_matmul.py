"""Parity of the port's rank-folded Kronecker chain
(repro_torch.kernels.kron_matmul) with the JAX package: the plain version
against ``kron_matmul_ref`` (the plain chain) and ``kron_matmul_host`` (the
host executor of the Pallas kernel's tiled algorithm), through the padding
(prod q > d_in) and slicing (out_dim < prod t) edges, plus the kron head and
the wrapper's input checks, which run here.

The backward: ``kron_matmul_bwd_ref`` against ``kron_matmul_bwd_host`` (the
host executor of the Pallas backward, which itself cannot run off the TPU:
``pl.store``) and against ``jax.vjp`` of ``kron_matmul_ref``, at the smoke
config's ket-linear shapes and at shapes with ``d_in < prod q`` and
``out_dim < prod t``; ``chain_fused_vjp`` against JAX's; the ``KronMatmul``
autograd Function by a float64 ``gradcheck`` on the CPU route.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py). Tolerance: forward atol 1e-4 in fp32, because the sum
order differs over contraction depths of up to r·q; backward atol 1e-5 +
rtol 1e-4 in fp32 (the same contractions summed in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import head_for as jax_head_for
from repro.core.logits import head_logits as jax_head_logits
from repro.kernels import common as JC
from repro.kernels.kron_matmul.kron_matmul import kron_matmul_bwd_host, kron_matmul_host
from repro.kernels.kron_matmul.ref import kron_matmul_ref as jax_matmul_ref
from repro_torch.configs import get_smoke
from repro_torch.configs.base import head_for
from repro_torch.core import ketops
from repro_torch.core.logits import head_logits
from repro_torch.kernels import common as TC
from repro_torch.kernels.kron_matmul import ops as M

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-5)

# (rank, q_dims, t_dims, B, d_in, out_dim)
CASES = [
    (2, (8, 8), (32, 32), 3, 64, 1024),      # the smoke head, exact dims
    (4, (8, 4), (17, 13), 5, 29, 200),       # pad x (32 > 29), slice (221 > 200)
    (3, (6, 5), (7, 9), 1, 30, 63),          # B = 1
    (2, (3, 2, 4), (4, 3, 5), 4, 22, 57),    # order 3, pad + slice
]


def _case(rank, q, t, B, d_in, seed=0):
    rng = np.random.default_rng(seed + rank + B)
    factors = [(rng.standard_normal((rank, qj, tj)) * 0.3).astype(np.float32)
               for qj, tj in zip(q, t)]
    x = rng.standard_normal((B, d_in)).astype(np.float32)
    return factors, x


@pytest.mark.parametrize("rank,q,t,B,d_in,out_dim", CASES)
def test_plain_matches_jax_ref_and_host(rank, q, t, B, d_in, out_dim):
    factors, x = _case(rank, q, t, B, d_in)
    got = M.kron_matmul([torch.from_numpy(f) for f in factors], torch.from_numpy(x),
                        out_dim)
    assert got.shape == (B, out_dim) and got.dtype == torch.float32
    jf = [jnp.asarray(f) for f in factors]
    ref = jax_matmul_ref(jf, jnp.asarray(x), out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    host = kron_matmul_host(jf, jnp.asarray(x), t1_block=2)[:, :out_dim]
    np.testing.assert_allclose(got.numpy(), np.asarray(host), **TOL)


def test_kron_head_matches_jax_on_smoke_config():
    jcfg = jax_head_for(jax_smoke("qwen3-1.7b", dtype=jnp.float32))
    tcfg = head_for(get_smoke("qwen3-1.7b", dtype=torch.float32))
    assert tcfg.resolved_q() == jcfg.resolved_q() and tcfg.resolved_t() == jcfg.resolved_t()
    factors, _ = _case(tcfg.rank, tcfg.resolved_q(), tcfg.resolved_t(), 1, 1, seed=5)
    h = np.random.default_rng(6).standard_normal((2, 3, 64)).astype(np.float32)
    want = jax_head_logits(jcfg, {"factors": [jnp.asarray(f) for f in factors]},
                           jnp.asarray(h))
    got = head_logits(tcfg, {"factors": [torch.from_numpy(f) for f in factors]},
                      torch.from_numpy(h))
    assert got.shape == (2, 3, 1024) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_matrix_keeps_activation_dtype_and_refuses_ln():
    spec = ketops.KronSpec(in_dim=16, out_dim=20, rank=2, use_layernorm=False)
    params = ketops.init(torch.Generator().manual_seed(0), spec, "cpu")
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    assert ketops.apply_matrix(spec, params, x).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        ketops.apply_matrix(ketops.KronSpec(in_dim=16, out_dim=20), params, x)


def test_cuda_wrapper_refuses_cpu_tensors():
    f = [torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        M.kron_matmul_cuda(f, torch.zeros(3, 64), 1024)


@pytest.mark.parametrize("bad", ["order", "x_dtype", "x_wide", "out_dim", "rank"])
def test_input_checks(bad):
    f = [torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)]
    x = torch.zeros(3, 64)
    out_dim = 1024
    if bad == "order":
        with pytest.raises(NotImplementedError):
            M.check_inputs(f + [torch.zeros(2, 2, 2)], x, out_dim)
        return
    if bad == "x_dtype":
        x = x.half()
    elif bad == "x_wide":
        x = torch.zeros(3, 65)
    elif bad == "out_dim":
        out_dim = 1025
    elif bad == "rank":
        f = [f[0], torch.zeros(1, 8, 32)]
    with pytest.raises(ValueError):
        M.check_inputs(f, x, out_dim)
    M.check_inputs([torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)], torch.zeros(3, 60),
                   math.prod((32, 32)) - 1)


BWD_TOL = dict(atol=1e-5, rtol=1e-4)

# (rank, q_dims, t_dims, B, d_in, out_dim): the smoke config's ket linears
# (q/k/v/o, wi/wg, FFN wo), then d_in < prod q with out_dim < prod t
BWD_CASES = [
    (8, (8, 8), (8, 4), 6, 64, 32),
    (8, (8, 8), (16, 12), 5, 64, 192),
    (8, (16, 12), (8, 8), 4, 192, 64),
    (4, (8, 4), (17, 13), 5, 29, 200),
    (3, (6, 5), (7, 9), 1, 30, 63),
]


@pytest.mark.parametrize("rank,q,t,B,d_in,out_dim", BWD_CASES)
def test_backward_matches_jax_host_and_vjp(rank, q, t, B, d_in, out_dim):
    factors, x = _case(rank, q, t, B, d_in, seed=11)
    g = np.random.default_rng(12).standard_normal((B, out_dim)).astype(np.float32)
    dx, dfs = M.kron_matmul_bwd_ref([torch.from_numpy(f) for f in factors],
                                    torch.from_numpy(x), torch.from_numpy(g))
    P, T = math.prod(q), math.prod(t)
    assert dx.shape == (B, P) and dx.dtype == torch.float32
    assert [tuple(d.shape) for d in dfs] == [f.shape for f in factors]
    jf = [jnp.asarray(f) for f in factors]
    gpad = jnp.pad(jnp.asarray(g), ((0, 0), (0, T - out_dim)))
    hdx, hdfs = kron_matmul_bwd_host(jf, jnp.asarray(x), gpad, t1_block=2)
    np.testing.assert_allclose(dx.numpy(), np.asarray(hdx), **BWD_TOL)
    for a, b in zip(dfs, hdfs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
    _, vjp = jax.vjp(lambda fs, xx: jax_matmul_ref(fs, xx, out_dim), jf, jnp.asarray(x))
    vdfs, vdx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx[:, :d_in].numpy(), np.asarray(vdx), **BWD_TOL)
    for a, b in zip(dfs, vdfs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)


@pytest.mark.parametrize("q,t", [((3, 4), (5, 2)), ((2, 3, 2), (3, 2, 4)), ((6,), (5,))])
def test_chain_fused_vjp_matches_jax(q, t):
    rng = np.random.default_rng(sum(q) + sum(t))
    factors = [rng.standard_normal((3, qj, tj)).astype(np.float32) for qj, tj in zip(q, t)]
    x = rng.standard_normal((4, math.prod(q))).astype(np.float32)
    d = rng.standard_normal((4, math.prod(t))).astype(np.float32)
    jdx, jdfs = JC.chain_fused_vjp(jnp.asarray(x), [jnp.asarray(f) for f in factors],
                                   jnp.asarray(d))
    dx, dfs = TC.chain_fused_vjp(torch.from_numpy(x), [torch.from_numpy(f) for f in factors],
                                 torch.from_numpy(d))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **BWD_TOL)
    for a, b in zip(dfs, jdfs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)


@pytest.mark.parametrize("rank,q,t,B,d_in,out_dim", [(2, (3, 4), (5, 2), 3, 12, 10),
                                                     (3, (4, 3), (3, 5), 2, 10, 13)])
def test_autograd_function_gradcheck(rank, q, t, B, d_in, out_dim):
    g = torch.Generator().manual_seed(rank)
    factors = [torch.randn((rank, qj, tj), generator=g, dtype=torch.float64,
                           requires_grad=True) for qj, tj in zip(q, t)]
    x = torch.randn((B, d_in), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda xx, *fs: M.KronMatmul.apply(xx, out_dim, False, *fs), (x, *factors),
        eps=1e-6, atol=1e-5, rtol=1e-3)


def test_backward_on_the_plain_route_launches_nothing():
    factors, x = _case(8, (8, 8), (16, 12), 3, 64)
    fs = [torch.from_numpy(f).requires_grad_(True) for f in factors]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    before = dict(M.launches)
    y = M.kron_matmul(fs, xt, 192)
    assert y.dtype == torch.bfloat16 and y.shape == (3, 192)
    y.float().square().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == (3, 64)
    assert all(f.grad.dtype == torch.float32 for f in fs)
    assert M.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        M.kron_matmul_bwd_cuda(fs, torch.zeros(3, 64), torch.zeros(3, 192))
