"""Parity of the port's rank-folded Kronecker chain
(repro_torch.kernels.kron_matmul) with the JAX package: the plain version
against ``kron_matmul_ref`` (the plain chain) and ``kron_matmul_host`` (the
host executor of the Pallas kernel's tiled algorithm), through the padding
(prod q > d_in) and slicing (out_dim < prod t) edges, plus the kron head and
the wrapper's input checks, which run here.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerance: atol 1e-4 in fp32, because the sum order differs
over contraction depths of up to r·q.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import head_for as jax_head_for
from repro.core.logits import head_logits as jax_head_logits
from repro.kernels.kron_matmul.kron_matmul import kron_matmul_host
from repro.kernels.kron_matmul.ref import kron_matmul_ref as jax_matmul_ref
from repro_torch.configs import get_smoke
from repro_torch.configs.base import head_for
from repro_torch.core import ketops
from repro_torch.core.logits import head_logits
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
