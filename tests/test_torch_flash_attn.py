"""The port's full-sequence attention (``kernels/flash_attn``: the plain
``attention_ref`` and the ``FlashAttention`` op) and its full-prompt
``prefill_fn`` against the JAX package, on the CPU.

The CUDA kernel (``csrc/flash_attn.cu``) does not run here: on a CPU tensor
the op runs ``attention_ref``, and ``tests/test_torch_cuda.py`` holds the
kernel against it on the card. What runs here:

* the port's ``attention_ref`` against JAX's ``attention_ref`` and against
  ``flash_attention_pallas(..., interpret=True)`` on the cases of
  ``tests/test_flash_attn_kernel.py`` (GQA causal, MQA with a window at a
  ragged length, bidirectional) plus Sq != Skv both ways (not multiples of
  the block) and a bf16 case: rtol 2e-4 + atol 2e-5 in fp32 (the same
  softmax in another summation order; the Pallas kernel's online softmax
  over blocks of 8), 3e-2 in bf16 (outputs rounded to bf16, and the
  kernel rounds its probabilities to bf16 before the PV product);
* ``FlashAttention``'s output and dq, dk, dv against ``jax.vjp`` of JAX
  ``ops.flash_attention`` (the Pallas forward in interpret mode, the
  oracle's VJP backward), atol 1e-6 + rtol 1e-4;
* ``flash_tiles_ref`` (the tensor-core kernel's tile walk: 128-row query
  blocks, 128-key tiles from ``flash_kv_tiles``, base-2 softmax, the scale
  after the dot) against ``flash_attention_pallas(..., block_q=128,
  block_k=128, interpret=True)`` and JAX ``attention_ref``, at lengths 1,
  127, 128, 129 and 257, Sq != Skv both ways, windows whose last rows see
  no key, G 1, 2 and 8, Dh 16, 64 and 128, at the same tolerances. A
  row that sees no key is the mean of v over the Skv keys in both
  ``attention_ref``s and in the tile walk; the Pallas kernel pads the keys
  to its block with NEG scores and averages over the padded length there,
  so against it only the rows that see a key are compared (and the padded
  mean is checked on the others);
* the static route table of the flash wrappers: bf16 and fp16 at every
  head_dim to the tensor-core kernel, fp32 to the CUDA-core kernel;
* ``prefill_fn`` on ``get_smoke("qwen3-1.7b", dtype=float32)`` with the
  parameters of JAX ``PRNGKey(0)``: the last hidden state and every
  layer's k and v against JAX ``prefill_fn``, atol 2e-4 (3 layers of fp32
  matmuls in another order, the slice-1 tolerance); and
  ``forward(want_cache=False)`` returning the hidden states alone, equal
  to the ``want_cache=True`` run's and within atol 2e-4 of JAX's forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels.flash_attn import ops as JFA
from repro.kernels.flash_attn.flash_attn import flash_attention_pallas
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro.models import model as JMD
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.convert import jax_caches_to_torch, jax_params_to_torch
from repro_torch.kernels.flash_attn import ops as FA
from repro_torch.kernels.flash_attn.ref import attention_ref, flash_kv_tiles, flash_tiles_ref
from repro_torch.models import model as MD
from repro_torch.models import transformer as T

torch.set_num_threads(2)

CASES = {  # (B, Sq, Skv, H, KVH, Dh, causal, window, block, dtype)
    "gqa_causal": (2, 24, 24, 4, 2, 16, True, 0, 8, "float32"),
    "mqa_window_ragged": (1, 17, 17, 4, 1, 32, True, 8, 8, "float32"),
    "bidirectional": (2, 16, 16, 2, 2, 16, False, 0, 8, "float32"),
    "sq_lt_skv_ragged": (2, 13, 21, 4, 2, 16, True, 0, 8, "float32"),
    "sq_gt_skv_ragged": (1, 21, 13, 6, 3, 16, True, 0, 8, "float32"),
    "bf16_causal": (1, 16, 16, 2, 2, 16, True, 0, 8, "bfloat16"),
}
TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SEQ, BATCH, ATOL = 24, 2, 2e-4


def _inputs(B, Sq, Skv, H, KVH, Dh, dtype, seed=0):
    """q, k, v as fp32 numpy, and each in both packages in ``dtype`` (the
    same round-to-nearest-even bf16 on both sides)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, Sq, H, Dh), (B, Skv, KVH, Dh), (B, Skv, KVH, Dh))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.fixture(scope="module")
def jax_outputs():
    """Each case's JAX oracle and Pallas (interpret mode) outputs, once."""
    out = {}
    for name, (B, Sq, Skv, H, KVH, Dh, causal, window, blk, dtype) in CASES.items():
        (q, k, v), _ = _inputs(B, Sq, Skv, H, KVH, Dh, dtype)
        ref = jax.jit(lambda a, b, c: jax_attention_ref(a, b, c, causal=causal,
                                                        window=window))
        pallas = jax.jit(lambda a, b, c: flash_attention_pallas(
            a, b, c, causal=causal, window=window, block_q=blk, block_k=blk,
            interpret=True))
        out[name] = {"jax_ref": np.asarray(ref(q, k, v).astype(jnp.float32)),
                     "pallas": np.asarray(pallas(q, k, v).astype(jnp.float32))}
    return out


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_ref_matches_jax(jax_outputs, case, oracle):
    B, Sq, Skv, H, KVH, Dh, causal, window, _, dtype = CASES[case]
    _, (q, k, v) = _inputs(B, Sq, Skv, H, KVH, Dh, dtype)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, Dh)
    np.testing.assert_allclose(got.float().numpy(), jax_outputs[case][oracle],
                               **TOL[dtype])


TILE_CASES = {  # (B, Sq, Skv, H, KVH, Dh, causal, window, dtype)
    "len1_g2_d16": (1, 1, 1, 2, 1, 16, True, 0, "float32"),
    "len127_g8_d64": (1, 127, 127, 8, 1, 64, True, 0, "float32"),
    "len128_g1_d128": (1, 128, 128, 2, 2, 128, True, 0, "float32"),
    "len129_bidirectional_g2_d64": (1, 129, 129, 4, 2, 64, False, 0, "float32"),
    "len257_g8_d16": (1, 257, 257, 8, 1, 16, True, 0, "float32"),
    "sq_lt_skv_g2_d64": (1, 129, 257, 2, 1, 64, True, 0, "float32"),
    "sq_gt_skv_g1_d16": (2, 257, 129, 2, 2, 16, True, 0, "float32"),
    "blind_window_g2_d16": (1, 257, 130, 2, 1, 16, True, 40, "float32"),
    "bf16_len257_g2_d128": (1, 257, 257, 4, 2, 128, True, 0, "bfloat16"),
    "bf16_blind_window_g8_d64": (1, 257, 130, 8, 1, 64, True, 40, "bfloat16"),
}


def _sees_a_key(Sq, Skv, causal, window):
    """(Sq,) bool: the query rows with at least one valid key."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(Sq, dtype=int)
    return hi >= lo


@pytest.fixture(scope="module")
def jax_tile_outputs():
    """Each tile case's JAX oracle and Pallas (interpret mode, 128 x 128
    blocks) outputs, once."""
    out = {}
    for name, (B, Sq, Skv, H, KVH, Dh, causal, window, dtype) in TILE_CASES.items():
        (q, k, v), _ = _inputs(B, Sq, Skv, H, KVH, Dh, dtype, seed=4)
        ref = jax.jit(lambda a, b, c: jax_attention_ref(a, b, c, causal=causal,
                                                        window=window))
        pallas = jax.jit(lambda a, b, c: flash_attention_pallas(
            a, b, c, causal=causal, window=window, block_q=128, block_k=128,
            interpret=True))
        out[name] = {"jax_ref": np.asarray(ref(q, k, v).astype(jnp.float32)),
                     "pallas": np.asarray(pallas(q, k, v).astype(jnp.float32)),
                     "v": np.asarray(v.astype(jnp.float32))}
    return out


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas"])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_flash_tiles_ref_matches_jax(jax_tile_outputs, case, oracle):
    B, Sq, Skv, H, KVH, Dh, causal, window, dtype = TILE_CASES[case]
    _, (q, k, v) = _inputs(B, Sq, Skv, H, KVH, Dh, dtype, seed=4)
    got = flash_tiles_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, Dh)
    got, want = got.float().numpy(), jax_tile_outputs[case][oracle]
    if oracle == "pallas":
        sees = _sees_a_key(Sq, Skv, causal, window)
        # rows that see no key: the Pallas kernel's mean of v over Skv keys
        # padded to its 128-key block with zeros
        vv = jax_tile_outputs[case]["v"]
        padded = vv.sum(axis=1) / (-(-Skv // 128) * 128)  # (B, KVH, Dh)
        blind = np.repeat(padded, H // KVH, axis=1)[:, None]  # (B, 1, H, Dh)
        np.testing.assert_allclose(want[:, ~sees], np.broadcast_to(
            blind, want[:, ~sees].shape), **TOL[dtype])
        got, want = got[:, sees], want[:, sees]
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_flash_kv_tiles_walks_what_the_masks_leave():
    """The tile walk covers every key a block's rows see, and a blind block
    walks every tile."""
    for Sq, Skv, causal, window in ((257, 257, True, 0), (257, 130, True, 40),
                                    (129, 257, True, 0), (300, 300, True, 100),
                                    (257, 129, False, 0)):
        sees = _sees_a_key(Sq, Skv, causal, window)
        for q0 in range(0, Sq, 128):
            lo, hi = flash_kv_tiles(q0, Sq, Skv, causal, window)
            rows = np.arange(q0, min(q0 + 128, Sq))
            if not sees[rows[-1]]:
                assert (lo, hi) == (0, -(-Skv // 128))
                continue
            for i in rows:
                kmax = min(i, Skv - 1) if causal else Skv - 1
                kmin = max(0, i - window + 1) if window > 0 else 0
                assert lo * 128 <= kmin and kmax < hi * 128


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_route_table(dtype):
    for d in FA.FLASH_HEAD_DIMS:
        want = "flash_fwd" if dtype == torch.float32 else "flash_fwd_tc"
        assert FA.flash_route(dtype, d) == want
        assert ((dtype, d) in FA.FLASH_TC_ROUTES) == (want == "flash_fwd_tc")
    assert FA.FLASH_BLOCK_Q == {"flash_fwd": 64, "flash_fwd_tc": 128}
    assert set(FA.FLASH_BLOCK_Q) <= set(FA.launches)
    # the CPU route launches neither kernel
    before = dict(FA.launches)
    q, k, v = (torch.zeros((1, 3, 2, 16), dtype=dtype) for _ in range(3))
    FA.flash_attention(q, k, v)
    assert FA.launches == before


GRAD_CASES = {"gqa_causal": (1, 12, 12, 4, 2, 16, True, 0),
              "mqa_window": (2, 19, 19, 4, 1, 16, True, 5),
              "bidirectional_sq_ne_skv": (1, 9, 14, 2, 1, 16, False, 0)}


@pytest.fixture(scope="module")
def jax_vjps():
    """JAX ops.flash_attention's output and (dq, dk, dv) for a fixed
    cotangent, per case, once."""
    out = {}
    for name, (B, Sq, Skv, H, KVH, Dh, causal, window) in GRAD_CASES.items():
        (q, k, v), _ = _inputs(B, Sq, Skv, H, KVH, Dh, "float32", seed=1)
        g = np.random.default_rng(2).standard_normal((B, Sq, H, Dh)).astype(np.float32)

        def fwd_bwd(a, b, c, ct, causal=causal, window=window):
            o, vjp = jax.vjp(lambda x, y, z: JFA.flash_attention(x, y, z, causal, window,
                                                                 8, 8), a, b, c)
            return o, vjp(ct)

        o, grads = jax.jit(fwd_bwd)(q, k, v, jnp.asarray(g))
        out[name] = (g, np.asarray(o), [np.asarray(t) for t in grads])
    return out


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_flash_attention_op_and_grads_match_jax_vjp(jax_vjps, case):
    B, Sq, Skv, H, KVH, Dh, causal, window = GRAD_CASES[case]
    _, qkv = _inputs(B, Sq, Skv, H, KVH, Dh, "float32", seed=1)
    qkv = [t.requires_grad_(True) for t in qkv]
    g, want_o, want_grads = jax_vjps[case]
    before = dict(FA.launches)
    out = FA.flash_attention(*qkv, causal=causal, window=window)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    assert FA.launches == before  # the CPU route launches nothing
    np.testing.assert_allclose(out.detach().numpy(), want_o, atol=1e-6, rtol=1e-4)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-4)


@pytest.fixture(scope="module")
def prefill_run():
    """JAX prefill_fn and forward on the smoke config, and the port's
    parameters converted from the same JAX init, once."""
    jcfg = jax_smoke("qwen3-1.7b", dtype=jnp.float32)
    tcfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    jparams = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(BATCH, SEQ),
                                               dtype=np.int32)
    x_last, caches = jax.jit(lambda p, t: JMD.prefill_fn(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    x_full = jax.jit(lambda p, t: JT.forward(p, jcfg, t)[0])(jparams, jnp.asarray(tokens))
    return {
        "cfg": tcfg,
        "params": jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                      device="cpu"),
        "tokens": torch.from_numpy(tokens),
        "x_last": np.asarray(x_last),
        "caches": jax_caches_to_torch(jax.tree_util.tree_map(np.asarray, caches), tcfg,
                                      device="cpu"),
        "x_full": np.asarray(x_full),
    }


def test_prefill_fn_matches_jax(prefill_run):
    cfg = prefill_run["cfg"]
    x_last, caches = MD.prefill_fn(prefill_run["params"], cfg,
                                   {"tokens": prefill_run["tokens"]})
    assert tuple(x_last.shape) == (BATCH, cfg.d_model)
    np.testing.assert_allclose(x_last.numpy(), prefill_run["x_last"], atol=ATOL, rtol=0)
    assert isinstance(caches, list) and len(caches) == cfg.num_layers
    for layer, (got, want) in enumerate(zip(caches, prefill_run["caches"])):
        assert set(got) == {"k", "v"} == set(want)
        for name in ("k", "v"):
            assert tuple(got[name].shape) == (BATCH, SEQ, cfg.num_kv_heads, cfg.head_dim)
            assert got[name].dtype == cfg.dtype
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"layer {layer} {name}")


def test_forward_without_cache_is_unchanged(prefill_run):
    cfg, params, tokens = prefill_run["cfg"], prefill_run["params"], prefill_run["tokens"]
    with torch.no_grad():
        x = T.forward(params, cfg, tokens)
        x_cached, _ = T.forward(params, cfg, tokens, want_cache=True)
    assert isinstance(x, torch.Tensor) and tuple(x.shape) == (BATCH, SEQ, cfg.d_model)
    assert torch.equal(x, x_cached)
    np.testing.assert_allclose(x.numpy(), prefill_run["x_full"], atol=ATOL, rtol=0)
