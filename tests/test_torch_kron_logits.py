"""Parity of the port's fused Kronecker-head cross-entropy
(repro_torch.kernels.kron_logits) with the JAX package.

* The plain forward ``kron_ce_fwd_ref`` against the Pallas kernel
  ``kron_ce_pallas`` in interpret mode (loss, m, l) and ``kron_ce_naive``.
* The plain backward ``kron_ce_bwd_ref`` against ``jax.vjp`` of
  ``kron_ce_tiled`` and of ``kron_ce_naive`` (the Pallas backward cannot run
  off the TPU on jax 0.9.0: ``pl.store`` raises), with a ragged vocab (masked
  columns) and ``h`` narrower than ``P = prod q`` (zero padding).
* ``kron_ce_tiled`` (the plain route of ``head_ce_loss``) and its autograd
  gradient against the same oracles, and ``head_ce_loss`` with a label mask
  against JAX's.
* ``torch.autograd.gradcheck`` in float64 of the ``FusedKronCE`` Function on
  its CPU route.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerances in fp32: losses atol 1e-5 + rtol 1e-5 (sums of
a few hundred exponentials in another order); gradients atol 1e-6 +
rtol 1e-4 (each a sum of softmax-weighted products of magnitude ~1e-3);
the float64 gradcheck keeps eps 1e-6, atol 1e-5, rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import head_for as jax_head_for
from repro.core.logits import head_ce_loss as jax_head_ce_loss
from repro.kernels.kron_logits.kron_logits import kron_ce_pallas
from repro.kernels.kron_logits.ref import kron_ce_naive as jax_naive
from repro.kernels.kron_logits.ref import kron_ce_tiled as jax_tiled
from repro_torch.configs import get_smoke
from repro_torch.configs.base import head_for
from repro_torch.core.logits import head_ce_loss
from repro_torch.kernels.kron_logits import ops as CE

torch.set_num_threads(2)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)

# (rank, q_dims, t_dims, vocab, N, h width, t1_block)
CASES = [
    (2, (8, 8), (32, 32), 1000, 37, 64, 4),   # smoke head shape, 24 masked columns
    (3, (4, 3), (7, 5), 33, 11, 10, 3),       # ragged vocab, h narrower than P
    (2, (2, 3, 2), (3, 4, 2), 20, 9, 12, 16),  # order 3
]


def _inputs(seed, rank, q, t, vocab, n, width):
    rng = np.random.default_rng(seed)
    factors = [(rng.standard_normal((rank, qj, tj)) * 0.4).astype(np.float32)
               for qj, tj in zip(q, t)]
    h = rng.standard_normal((n, width)).astype(np.float32)
    labels = rng.integers(0, vocab, size=n).astype(np.int32)
    labels[0], labels[-1] = 0, vocab - 1
    g = (rng.random(n) + 0.5).astype(np.float32) / n
    return factors, h, labels, g


@pytest.fixture(scope="module", params=range(len(CASES)), ids=["smoke", "ragged", "order3"])
def case(request):
    """One case's inputs and every JAX reference, computed once."""
    rank, q, t, vocab, n, width, blk = CASES[request.param]
    factors, h, labels, g = _inputs(request.param, rank, q, t, vocab, n, width)
    jf, jh, jy = [jnp.asarray(f) for f in factors], jnp.asarray(h), jnp.asarray(labels)
    ref = {"naive": np.asarray(jax_naive(jf, jh, jy, vocab))}
    loss, m, l = kron_ce_pallas(jf, jh, jy, vocab, t1_block=blk, block_b=64,
                                interpret=True, return_stats=True)
    ref["pallas"] = tuple(np.asarray(a) for a in (loss, m, l))
    for name, fn in (("tiled", lambda fs, hh: jax_tiled(fs, hh, jy, vocab, t1_block=blk)),
                     ("naive_vjp", lambda fs, hh: jax_naive(fs, hh, jy, vocab))):
        _, vjp = jax.vjp(fn, jf, jh)
        dfs, dh = vjp(jnp.asarray(g))
        ref[name] = ([np.asarray(d) for d in dfs], np.asarray(dh))
    return dict(factors=factors, h=h, labels=labels, g=g, vocab=vocab, blk=blk, ref=ref)


def _t(case):
    return ([torch.from_numpy(f) for f in case["factors"]], torch.from_numpy(case["h"]),
            torch.from_numpy(case["labels"]))


def test_plain_forward_matches_pallas_and_naive(case):
    fs, h, y = _t(case)
    loss, m, l = CE.kron_ce_fwd_ref(fs, h, y, case["vocab"], case["blk"])
    want_loss, want_m, want_l = case["ref"]["pallas"]
    np.testing.assert_allclose(loss.numpy(), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(m.numpy(), want_m, **LOSS_TOL)
    np.testing.assert_allclose(l.numpy(), want_l, **LOSS_TOL)
    np.testing.assert_allclose(loss.numpy(), case["ref"]["naive"], **LOSS_TOL)
    np.testing.assert_allclose(CE.kron_ce_naive(fs, h, y, case["vocab"]).numpy(),
                               case["ref"]["naive"], **LOSS_TOL)


@pytest.mark.parametrize("oracle", ["tiled", "naive_vjp"])
def test_plain_backward_matches_jax_vjp(case, oracle):
    fs, h, y = _t(case)
    _, m, l = CE.kron_ce_fwd_ref(fs, h, y, case["vocab"], case["blk"])
    dfs, dh = CE.kron_ce_bwd_ref(fs, h, y, m, l, torch.from_numpy(case["g"]),
                                 case["vocab"], case["blk"])
    want_dfs, want_dh = case["ref"][oracle]
    assert dh.shape == h.shape
    np.testing.assert_allclose(dh.numpy(), want_dh, **GRAD_TOL)
    for a, b in zip(dfs, want_dfs):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)


@pytest.mark.parametrize("route", ["fused", "tiled"])
def test_autograd_routes_match_jax(case, route):
    """The Function (CPU route: the kernels' plain versions) and the
    checkpointed tiled scan give JAX's losses and gradients."""
    fs, h, y = _t(case)
    fs = [f.requires_grad_(True) for f in fs]
    h.requires_grad_(True)
    if route == "fused":
        loss = CE.fused_kron_ce(fs, h, y, case["vocab"], case["blk"])
    else:
        loss = CE.kron_ce_tiled(fs, h, y, case["vocab"], case["blk"])
    np.testing.assert_allclose(loss.detach().numpy(), case["ref"]["naive"], **LOSS_TOL)
    loss.backward(torch.from_numpy(case["g"]))
    want_dfs, want_dh = case["ref"]["tiled"]
    np.testing.assert_allclose(h.grad.numpy(), want_dh, **GRAD_TOL)
    for f, b in zip(fs, want_dfs):
        np.testing.assert_allclose(f.grad.numpy(), b, **GRAD_TOL)


@pytest.mark.parametrize("width", [12, 11])
def test_fused_function_gradcheck(width):
    rng = np.random.default_rng(width)
    fs = tuple(torch.from_numpy(rng.standard_normal((2, qj, tj)) * 0.5).requires_grad_(True)
               for qj, tj in zip((4, 3), (5, 4)))
    h = torch.from_numpy(rng.standard_normal((6, width))).requires_grad_(True)
    y = torch.tensor([0, 17, 3, 18, 9, 9], dtype=torch.int32)

    def fn(h, *factors):
        return CE.FusedKronCE.apply(h, y, 19, 2, False, *factors)

    assert torch.autograd.gradcheck(fn, (h, *fs), eps=1e-6, atol=1e-5, rtol=1e-3)


def test_head_ce_loss_with_mask_matches_jax():
    jcfg = jax_head_for(jax_smoke("qwen3-1.7b", dtype=jnp.float32))
    tcfg = head_for(get_smoke("qwen3-1.7b", dtype=torch.float32))
    assert tcfg.vocab_tile == jcfg.vocab_tile == 4
    factors, h, labels, _ = _inputs(7, tcfg.rank, tcfg.resolved_q(), tcfg.resolved_t(),
                                    tcfg.vocab_size, 24, 64)
    mask = (np.random.default_rng(8).random(24) < 0.6).astype(np.float32)
    h3, y3, m3 = h.reshape(4, 6, 64), labels.reshape(4, 6), mask.reshape(4, 6)

    def jloss(fs, hh):
        return jax_head_ce_loss(jcfg, {"factors": fs}, hh, jnp.asarray(y3), jnp.asarray(m3))

    want, vjp = jax.vjp(jloss, [jnp.asarray(f) for f in factors], jnp.asarray(h3))
    want_dfs, want_dh = vjp(jnp.ones((), jnp.float32))
    fs = [torch.from_numpy(f).requires_grad_(True) for f in factors]
    ht = torch.from_numpy(h3).requires_grad_(True)
    got = head_ce_loss(tcfg, {"factors": fs}, ht, torch.from_numpy(y3), torch.from_numpy(m3))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    got.backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh), **GRAD_TOL)
    for f, b in zip(fs, want_dfs):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(b), **GRAD_TOL)


def test_vocab_splits_fill_the_card():
    # 2,048 tokens = 64 token blocks on 132 SMs: two splits fill one wave
    assert CE.vocab_splits(2048, 390, 132) == 2
    assert CE.vocab_splits(32, 390, 132) == 132
    assert CE.vocab_splits(8192, 390, 132) == 1
    assert CE.vocab_splits(37, 32, 132) == 32


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    f = [torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)]
    x, y = torch.zeros(3, 64), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CE.kron_ce_fwd_cuda(f, x, y, 1000)
    with pytest.raises(ValueError, match="CUDA"):
        CE.kron_ce_bwd_cuda(f, x, y, torch.zeros(3), torch.ones(3), torch.ones(3), 1000)
    CE.check_inputs(f, x, y)
    with pytest.raises(NotImplementedError):
        CE.check_inputs(f + [torch.zeros(2, 2, 2)], x, y)
    with pytest.raises(NotImplementedError):  # q_2 does not divide 32
        CE.check_inputs([torch.zeros(2, 8, 32), torch.zeros(2, 6, 32)], torch.zeros(3, 48), y)
    with pytest.raises(ValueError):
        CE.check_inputs(f, x, y.long())
    with pytest.raises(ValueError):
        CE.check_inputs(f, torch.zeros(3, 63), y)
