"""Parity of the port's split-KV paged decode read
(repro_torch.kernels.flash_attn) with the JAX package: the plain split
against ``paged_attention_split_pallas`` and the plain combine against
``combine_splits_pallas``, both in interpret mode (as
tests/test_flash_attn_kernel.py runs them), the whole read against the
gather oracles, the split-count heuristic, and the wrappers' route and
input checks.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py). Tolerance: partials and outputs atol 1e-5 in fp32 —
the same page-by-page online softmax, only the summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro.kernels.flash_attn.paged import (combine_splits_pallas,
                                            paged_attention_split_pallas)
from repro.kernels.flash_attn.ref import paged_attention_ref as jax_paged_ref
from repro_torch.configs import get_config
from repro_torch.kernels import autotune
from repro_torch.kernels.flash_attn import ops as O
from repro_torch.kernels.flash_attn import ref as R

torch.set_num_threads(2)

ATOL = 1e-5
B, H, KVH, Dh, PS, NP = 3, 4, 2, 16, 4, 5
P = 1 + B * NP + 2
# slot 0 idles (lens 0, all-trash table row); slot 1 has a ragged tail (13
# tokens: 3 full pages and one token, then trash); slot 2 runs past the
# table (23 > NP·ps = 20), as an idle engine slot's step can
LENS = np.array([0, 13, 23], np.int32)
SPLITS = [1, 2, 3, 7]  # 7 > NP clamps to NP

_split_pallas = jax.jit(paged_attention_split_pallas,
                        static_argnames=("kv_splits", "interpret"))
_combine_pallas = jax.jit(combine_splits_pallas, static_argnames=("interpret",))


def _inputs(nan_trash: bool):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((P, PS, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((P, PS, KVH, Dh)).astype(np.float32)
    if nan_trash:
        kp[0] = vp[0] = np.nan
    ptab = (rng.permutation(P - 1)[:B * NP] + 1).reshape(B, NP).astype(np.int32)
    ptab[0] = 0
    ptab[1, 4:] = 0
    return q, kp, vp, ptab, LENS


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def pallas_partials():
    """The JAX split kernel's partials per split count, on the NaN-poisoned
    trash page (computed once)."""
    q, kp, vp, ptab, lens = _inputs(nan_trash=True)
    return {s: [np.asarray(x) for x in _split_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(lens), kv_splits=s, interpret=True)] for s in SPLITS}


@pytest.mark.parametrize("kv_splits", SPLITS)
def test_split_plain_matches_pallas(pallas_partials, kv_splits):
    q, kp, vp, ptab, lens = _inputs(nan_trash=True)
    got = O.paged_attention_split(*_torch(q, kp, vp, ptab, lens), kv_splits=kv_splits)
    S = min(kv_splits, NP)
    shapes = [(B, KVH, S, H // KVH, Dh), (B, KVH, S, H // KVH, 1),
              (B, KVH, S, H // KVH, 1)]
    for name, g, want, shape in zip(("mid_o", "m", "l"), got,
                                    pallas_partials[kv_splits], shapes):
        assert tuple(g.shape) == want.shape == shape, name
        assert g.dtype == torch.float32
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=0, err_msg=name)
    # the idle slot's splits are all empty: (0, NEG, 0)
    assert (got[0][0] == 0).all() and (got[1][0] == R.NEG).all() and (got[2][0] == 0).all()


@pytest.mark.parametrize("kv_splits", SPLITS)
def test_combine_plain_matches_pallas(pallas_partials, kv_splits):
    parts = pallas_partials[kv_splits]
    want = np.asarray(_combine_pallas(*[jnp.asarray(x) for x in parts], interpret=True))
    got = O.combine_splits(*_torch(*parts))
    assert tuple(got.shape) == want.shape == (B, KVH, H // KVH, Dh)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert (got[0] == 0).all()  # lens == 0 gives 0


def test_combine_extreme_m_spread():
    """Partials whose m spread far past fp32's exp range: the merge takes
    only non-positive exponents and agrees with a float64 evaluation and
    with the Pallas combine."""
    rng = np.random.default_rng(3)
    shape = (2, 2, 4, 3, 8)
    mid_o = rng.standard_normal(shape).astype(np.float32)
    l = (rng.random(shape[:-1] + (1,)) + 0.5).astype(np.float32)
    m = rng.choice([-600.0, -88.0, 0.0, 250.0, 600.0], shape[:-1] + (1,)).astype(np.float32)
    m[0, 0, 1:] = R.NEG  # one row with a single live split
    mid_o[0, 0, 1:] = 0.0
    l[0, 0, 1:] = 0.0
    w = np.exp(m.astype(np.float64) - m.max(axis=2, keepdims=True))
    want = (mid_o * w).sum(axis=2) / (l * w).sum(axis=2)
    got = O.combine_splits(*_torch(mid_o, m, l)).numpy()
    pallas = np.asarray(_combine_pallas(jnp.asarray(mid_o), jnp.asarray(m),
                                        jnp.asarray(l), interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_splits", SPLITS)
def test_read_matches_gather_oracles(kv_splits):
    """Split + combine equals the JAX gather oracle and the port's (on a
    finite trash page: the gather oracles multiply masked probabilities by
    every gathered value); ``use_kernel=False`` is the port's oracle."""
    q, kp, vp, ptab, lens = _inputs(nan_trash=False)
    lens = np.minimum(lens, NP * PS)  # the oracles view NP·ps positions
    args = _torch(q, kp, vp, ptab, lens)
    want = np.asarray(jax_paged_ref(*[jnp.asarray(a) for a in (q, kp, vp, ptab, lens)]))
    got = O.paged_attention(*args, kv_splits=kv_splits)
    assert tuple(got.shape) == (B, H, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    oracle = O.paged_attention(*args, use_kernel=False)
    np.testing.assert_allclose(oracle.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(R.paged_attention_ref(*args).numpy(), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_heuristic_kv_splits_matches_jax(backend):
    for n_pages in (1, 2, 3, 7, 8, 16, 31, 32, 64, 256, 2048):
        for batch in (0, 1, 2, 8, 16, 64):
            assert autotune.heuristic_kv_splits(16, 2, 128, n_pages, batch=batch,
                                                backend=backend) == \
                jax_autotune.heuristic_kv_splits(16, 2, 128, n_pages, batch=batch,
                                                 backend=backend)


def test_engine_read_shape_gives_eight_splits():
    cfg = get_config("qwen3-1.7b")
    assert autotune.heuristic_kv_splits(cfg.page_size, cfg.q_heads_per_kv, cfg.head_dim,
                                        512 // cfg.page_size, batch=8) == 8
    assert autotune.backend_of(torch.device("cuda", 0)) == "gpu"
    assert autotune.backend_of(torch.device("cpu")) == "cpu"


def test_cuda_wrappers_refuse_cpu_tensors():
    q, kp, vp, ptab, lens = _torch(*_inputs(nan_trash=False))
    with pytest.raises(ValueError, match="CUDA"):
        O.paged_attention_split_cuda(q, kp, vp, ptab, lens, kv_splits=2)
    with pytest.raises(ValueError, match="CUDA"):
        O.combine_splits_cuda(*O.paged_attention_split(q, kp, vp, ptab, lens,
                                                       kv_splits=2))
    before = dict(O.launches)
    O.paged_attention(q, kp, vp, ptab, lens)
    assert O.launches == before  # the CPU route launches nothing


@pytest.mark.parametrize("bad", ["group", "head_dim", "dtype", "ptab_dtype", "lens_shape",
                                 "noncontig", "pool_shape"])
def test_split_input_checks(bad):
    q, kp, vp, ptab, lens = _torch(*_inputs(nan_trash=False))
    if bad == "group":
        q = torch.zeros(B, 6, Dh)  # 6 heads over 2 kv heads: group 3
    elif bad == "head_dim":
        q, kp, vp = torch.zeros(B, H, 12), torch.zeros(P, PS, KVH, 12), torch.zeros(
            P, PS, KVH, 12)
    elif bad == "dtype":
        kp = kp.double()
    elif bad == "ptab_dtype":
        ptab = ptab.long()
    elif bad == "lens_shape":
        lens = lens[:2]
    elif bad == "noncontig":
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "pool_shape":
        vp = vp[:, :2].contiguous()
    with pytest.raises(ValueError):
        O.check_split_inputs(q, kp, vp, ptab, lens)


def test_split_layout():
    assert R.split_layout(5, 2) == (2, 3)
    assert R.split_layout(5, 7) == (5, 1)
    assert R.split_layout(32, 8) == (8, 4)
    assert R.split_layout(3, 0) == (1, 3)
