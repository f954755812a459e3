"""The port's int8 / fp8 serving slice (``repro_torch.core.quant``, the
quantized legs of ``kron_gather`` and ``kron_matmul``, quantized ketops,
``ServingEngine(quant=...)``) against the JAX package, on the CPU.

* ``quantize`` / ``dequantize`` / ``quantize_params`` against
  ``repro.core.quant``: payloads equal bit for bit (fp8 compared as its
  bits), scales equal, tree structure kept, idempotent on quantized input;
  ``storage_bytes`` and the specs' ``num_bytes`` equal JAX's;
* ``materialize_error_bound`` holds for a quantized LN-free operator;
* the plain version of the quantized lookup against the Pallas kernel with
  ``scales`` in interpret mode (both modes, LN on and off, ids 0 and
  prod t - 1, a count not divisible by the block): rtol 1e-5, atol 1e-6,
  the JAX test's own tolerance (the same dequantized values, the same fp32
  math in another order);
* the plain version of the quantized chain against the Pallas kernel with
  ``scales`` in interpret mode and ``kron_matmul_quant`` (host executor),
  through the padding and slicing edges: rtol 1e-4, atol 1e-4, as
  tests/test_kron_matmul.py holds JAX's own legs;
* the smoke model with JAX parameters quantized by JAX's
  ``quantize_params`` and carried over: chunked prefill and decode logits
  against JAX's step functions, dense and ket (rank 4) linears, atol 2e-4
  (slice 1's serving tolerance: 3 layers of fp32 in another order);
  greedy outputs of ``ServingEngine(quant=...)`` against JAX's engine;
* the port's own quantized ``init_params`` against JAX's layout, engines on
  already-quantized parameters, mixed stacks and the forward-only guard.

The CUDA legs run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import embedding_for as jax_embedding_for
from repro.configs.base import head_for as jax_head_for
from repro.core import quant as JQ
from repro.core.embedding import embedding_num_bytes as jax_embedding_num_bytes
from repro.core.logits import head_ce_loss as jax_head_ce_loss
from repro.core.logits import head_num_bytes as jax_head_num_bytes
from repro.kernels.kron_gather.kron_gather import kron_gather_pallas
from repro.kernels.kron_matmul import ops as JMO
from repro.kernels.kron_matmul.kron_matmul import kron_matmul_pallas
from repro.models import model as JMD
from repro.serve import engine as JE
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import embedding_for, head_for
from repro_torch.convert import (array_to_torch, jax_params_to_torch, tensor_to_numpy,
                                 torch_params_to_numpy)
from repro_torch.core import ketops
from repro_torch.core import quant as Q
from repro_torch.core.embedding import embedding_num_bytes
from repro_torch.core.logits import head_ce_loss, head_num_bytes
from repro_torch.kernels.kron_gather import ops as G
from repro_torch.kernels.kron_matmul import ops as M
from repro_torch.models import model as MD
from repro_torch.serve.engine import Request, ServingEngine

torch.set_num_threads(2)

MODES = ("int8", "fp8")
CPU = torch.device("cpu")
SERVE_ATOL = 2e-4


def _bits(a) -> np.ndarray:
    """A payload's bits as numpy (fp8 as uint8); JAX array or tensor."""
    if isinstance(a, torch.Tensor):
        return tensor_to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _jax_quantized(x: np.ndarray, mode: str):
    """JAX's quantization of ``x`` and the same carried into the port."""
    jq = JQ.quantize(jnp.asarray(x), mode)
    return jq, {"q": array_to_torch(jq["q"], CPU), "scale": array_to_torch(jq["scale"], CPU)}


# ---------------------------------------------------------------------------
# core/quant against repro.core.quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quantize_matches_jax_bit_for_bit(mode):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 8, 13)) * rng.uniform(0.01, 3.0, (6, 1, 1))).astype(
        np.float32)
    x[2] = 0.0  # an all-zero slice takes the tiny floor of the scale
    want = JQ.quantize(jnp.asarray(x), mode)
    got = Q.quantize(torch.from_numpy(x), mode)
    assert got["q"].dtype == Q.payload_dtype(mode) and got["scale"].shape == (6, 1, 1)
    np.testing.assert_array_equal(_bits(got["q"]), _bits(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(Q.dequantize(got).numpy(),
                                  np.asarray(JQ.dequantize(want)))
    np.testing.assert_array_equal(Q.as_f32(got).numpy(), np.asarray(JQ.as_f32(want)))
    assert Q.quantize(got, mode) is got  # idempotent on quantized input
    assert Q.quantize(torch.from_numpy(x), "none").data_ptr() == torch.from_numpy(x).data_ptr()
    with pytest.raises(ValueError):
        Q.quantize(torch.from_numpy(x), "int4")


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_matches_jax_and_keeps_structure(mode):
    rng = np.random.default_rng(1)
    tree = {
        "embed": {"factors": [rng.standard_normal((2, 4, 5)).astype(np.float32),
                              rng.standard_normal((2, 3, 6)).astype(np.float32)]},
        "layer": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                  "ket": {"factors": (rng.standard_normal((3, 2, 2)).astype(np.float32),
                                      rng.standard_normal((3, 2, 5)).astype(np.float32))}},
    }
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    want = JQ.quantize_params(jtree, mode)
    got = Q.quantize_params(ttree, mode)
    assert isinstance(got["embed"]["factors"], list)
    assert isinstance(got["layer"]["ket"]["factors"], tuple)
    assert got["layer"]["w"] is ttree["layer"]["w"]  # dense tensors untouched
    for g, w in ((got["embed"]["factors"], want["embed"]["factors"]),
                 (got["layer"]["ket"]["factors"], want["layer"]["ket"]["factors"])):
        for gf, wf in zip(g, w):
            np.testing.assert_array_equal(_bits(gf["q"]), _bits(wf["q"]))
            np.testing.assert_array_equal(gf["scale"].numpy(), np.asarray(wf["scale"]))
    again = Q.quantize_params(got, mode)
    assert all(a is b for a, b in zip(again["embed"]["factors"], got["embed"]["factors"]))
    back = Q.dequantize_params(got)
    jback = JQ.dequantize_params(want)
    assert isinstance(back["layer"]["ket"]["factors"], tuple)
    for a, b in zip(back["embed"]["factors"], jback["embed"]["factors"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert Q.quantize_params(ttree, "none") is ttree


@pytest.mark.parametrize("mode", ("none",) + MODES)
def test_storage_bytes_and_num_bytes_match_jax(mode):
    shapes = [(32, 64, 390), (32, 32, 390), (8, 4, 7)]
    assert Q.storage_bytes(shapes, mode) == JQ.storage_bytes(shapes, mode)
    assert Q.num_scales(shapes) == JQ.num_scales(shapes) == 72
    assert Q.itemsize(mode) == JQ.itemsize(mode)
    for get, jax_get in ((get_config, jax_config), (get_smoke, jax_smoke)):
        arch_cfg, jax_cfg = get("qwen3-1.7b", quant=mode), jax_get("qwen3-1.7b", quant=mode)
        assert embedding_num_bytes(embedding_for(arch_cfg)) == \
            jax_embedding_num_bytes(jax_embedding_for(jax_cfg))
        assert head_num_bytes(head_for(arch_cfg)) == jax_head_num_bytes(jax_head_for(jax_cfg))
    if mode == "int8":  # the full embedding: 1,198,080 payload bytes + 64 scales
        assert embedding_num_bytes(embedding_for(get_config("qwen3-1.7b", quant=mode))) == \
            1_198_080 + 4 * 64


@pytest.mark.parametrize("mode", MODES)
def test_materialize_error_within_bound(mode):
    spec = ketops.KronSpec(in_dim=20, out_dim=40, order=2, rank=8, q_dims=(5, 4),
                           t_dims=(8, 5), use_layernorm=False)
    params = ketops.init(torch.Generator().manual_seed(3), spec, CPU)
    qparams = Q.quantize_params(params, mode)
    err = (ketops.materialize(spec, qparams) - ketops.materialize(spec, params)).abs().max()
    bound = Q.materialize_error_bound(params, mode)
    assert 0 < float(err) <= bound * 1.001 + 1e-7, (float(err), bound)
    jbound = JQ.materialize_error_bound(
        {"factors": [jnp.asarray(f.numpy()) for f in params["factors"]]}, mode)
    assert bound == pytest.approx(jbound, rel=1e-6)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX Pallas legs
# ---------------------------------------------------------------------------

GATHER_Q, GATHER_T, GATHER_N, GATHER_BLOCK = (8, 4), (7, 9), 13, 8


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_kron_gather_quant_plain_matches_pallas(mode, use_ln):
    rng = np.random.default_rng(4)
    carried = [_jax_quantized((rng.standard_normal((4, q, t)) * 0.3).astype(np.float32), mode)
               for q, t in zip(GATHER_Q, GATHER_T)]
    total = math.prod(GATHER_T)
    ids = rng.integers(0, total, size=GATHER_N).astype(np.int32)
    ids[0], ids[-1] = 0, total - 1
    embed_dim = math.prod(GATHER_Q) - 1
    want = kron_gather_pallas([j["q"] for j, _ in carried], jnp.asarray(ids),
                              use_layernorm=use_ln, block_b=GATHER_BLOCK, interpret=True,
                              scales=[j["scale"] for j, _ in carried])
    want = np.asarray(want)[:, :embed_dim]
    tids = torch.from_numpy(ids)
    before = dict(G.launches)
    got = G.kron_gather_quant([t["q"] for _, t in carried], [t["scale"] for _, t in carried],
                              tids, embed_dim, use_ln)
    assert got.shape == (GATHER_N, embed_dim) and got.dtype == torch.float32
    assert G.launches == before  # the CPU route launches nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    spec = ketops.KronSpec(in_dim=embed_dim, out_dim=total, rank=4, q_dims=GATHER_Q,
                           t_dims=GATHER_T, use_layernorm=use_ln)
    lookup = ketops.apply_vector(spec, {"factors": [t for _, t in carried]}, tids)
    np.testing.assert_allclose(lookup.numpy(), want, rtol=1e-5, atol=1e-6)


MATMUL_Q, MATMUL_T, MATMUL_B = (4, 3), (5, 6), 13


@pytest.mark.parametrize("rank", [1, 8])
@pytest.mark.parametrize("mode", MODES)
def test_kron_matmul_quant_plain_matches_pallas_and_host(mode, rank):
    rng = np.random.default_rng(5 + rank)
    carried = [_jax_quantized((rng.standard_normal((rank, q, t)) * 0.3).astype(np.float32),
                              mode) for q, t in zip(MATMUL_Q, MATMUL_T)]
    d_in, out_dim = math.prod(MATMUL_Q) - 1, math.prod(MATMUL_T) - 2
    x = rng.standard_normal((MATMUL_B, d_in)).astype(np.float32)
    payloads, scales = [j["q"] for j, _ in carried], [j["scale"] for j, _ in carried]
    pallas = kron_matmul_pallas(payloads, jnp.asarray(x), t1_block=2, block_b=8,
                                scales=scales)[:, :out_dim]
    host = JMO.kron_matmul_quant(payloads, scales, jnp.asarray(x), out_dim, 2, 8)
    got = M.kron_matmul_quant([t["q"] for _, t in carried], [t["scale"] for _, t in carried],
                              torch.from_numpy(x), out_dim)
    assert got.shape == (MATMUL_B, out_dim) and got.dtype == torch.float32
    for want in (pallas, host):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    via_ketops = ketops.apply_matrix_factors([t for _, t in carried],
                                             torch.from_numpy(x).to(torch.bfloat16), out_dim)
    assert via_ketops.dtype == torch.bfloat16 and via_ketops.shape == (MATMUL_B, out_dim)


# ---------------------------------------------------------------------------
# the smoke model: JAX-quantized parameters carried over, prefill + decode
# ---------------------------------------------------------------------------

B, C, MAX_LEN, STEPS = 2, 8, 32, 3
LENS = [(C, C), (C, 5)]


def _cfgs(linear: str):
    kw = dict(linear_kind="ket", linear_rank=4) if linear == "ket" else {}
    return (jax_smoke("qwen3-1.7b", dtype=jnp.float32, **kw),
            get_smoke("qwen3-1.7b", dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def fp32_params():
    """JAX's fp32 smoke params from PRNGKey(0) per linear kind (one jitted
    init each)."""
    out = {}
    for linear in ("dense", "ket"):
        jcfg, tcfg = _cfgs(linear)
        out[linear] = jax.jit(lambda k, c=jcfg: JMD.init_params(k, c))(jax.random.PRNGKey(0))
    return out


@pytest.fixture(scope="module")
def serving(fp32_params):
    """JAX and the port through two prefill chunks and greedy decode steps,
    on JAX's params quantized by JAX, for each linear kind and mode; the
    JAX side once."""
    rng = np.random.default_rng(2)
    chunks = [rng.integers(0, 1024, size=(B, C)).astype(np.int32) for _ in LENS]
    runs = {}
    for linear in ("dense", "ket"):
        jcfg, tcfg = _cfgs(linear)
        jfp = fp32_params[linear]
        jprefill = jax.jit(lambda p, c, t, n: JMD.prefill_chunk_fn(p, jcfg, c, t, n))
        jstep = jax.jit(lambda p, c, t: JMD.serve_step_fn(p, jcfg, c, t))
        for mode in MODES:
            jparams = JQ.quantize_params(jfp, mode)
            jnp_params = jax.tree_util.tree_map(np.asarray, jparams)
            tparams = jax_params_to_torch(jnp_params, tcfg, device="cpu")
            jcache = JMD.init_cache(jcfg, B, MAX_LEN)
            tcache = MD.init_cache(tcfg, B, MAX_LEN, device="cpu")
            out = {"jax": [], "torch": [], "params": (jnp_params, tparams, tcfg)}
            with torch.inference_mode():
                for toks, lens in zip(chunks, LENS):
                    jl, jcache = jprefill(jparams, jcache, jnp.asarray(toks),
                                          jnp.asarray(lens, jnp.int32))
                    tl, tcache = MD.prefill_chunk_fn(tparams, tcfg, tcache,
                                                     torch.from_numpy(toks),
                                                     torch.tensor(lens, dtype=torch.int32))
                    out["jax"].append(np.asarray(jl))
                    out["torch"].append(tl.numpy().copy())
                for _ in range(STEPS):
                    tok = np.argmax(out["jax"][-1], axis=-1).astype(np.int32)
                    jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
                    tl, tcache = MD.serve_step_fn(tparams, tcfg, tcache, torch.from_numpy(tok))
                    out["jax"].append(np.asarray(jl))
                    out["torch"].append(tl.numpy().copy())
            runs[linear, mode] = out
    return runs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("linear", ["dense", "ket"])
def test_quantized_serving_logits_match_jax(serving, linear, mode):
    run = serving[linear, mode]
    for call, (got, want) in enumerate(zip(run["torch"], run["jax"])):
        assert got.shape == want.shape == (B, 1024) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=SERVE_ATOL, rtol=0,
                                   err_msg=f"call {call}")
        np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


@pytest.mark.parametrize("mode", MODES)
def test_convert_carries_quantized_params_both_ways(serving, mode):
    """The ket linears' factors carried from JAX are the wire format (fp8 as
    torch.float8_e4m3fn), and torch_params_to_numpy gives JAX's bits back."""
    jnp_params, tparams, tcfg = serving["ket", mode]["params"]
    wq = tparams["layers"][1]["attn"]["wq"]["factors"][0]
    assert wq["q"].dtype == Q.payload_dtype(mode) and wq["scale"].dtype == torch.float32
    back = torch_params_to_numpy(tparams, tcfg)
    want = jax.tree_util.tree_leaves(jnp_params)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, _bits(w))


ENGINE_PROMPTS = [[5, 17, 33, 2, 9, 40, 11, 3, 8], [7, 3], [1, 2, 3, 4, 5, 6]]


@pytest.mark.parametrize("mode", MODES)
def test_quantized_engine_matches_jax_engine(fp32_params, mode):
    """Both engines calibrate the same fp32 parameters (dense linears: the
    embedding and head stacks) at construction and decode greedily."""
    jcfg, tcfg = _cfgs("dense")
    jparams = fp32_params["dense"]
    tparams = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                  device="cpu")
    kw = dict(batch_slots=2, max_len=32, page_size=4, prefill_chunk=4, quant=mode)
    jeng = JE.ServingEngine(jcfg, jparams, **kw)
    teng = ServingEngine(tcfg, tparams, **kw, device="cpu")
    jreqs = [JE.Request(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(ENGINE_PROMPTS)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(ENGINE_PROMPTS)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained()
    assert teng.run_until_drained().drained
    teng.check()
    embed = teng.params["embed"]["factors"]
    assert all(Q.is_quantized(f) and f["q"].dtype == Q.payload_dtype(mode) for f in embed)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(len(r.output) == 4 for r in treqs)


# ---------------------------------------------------------------------------
# the port's own quantized init, engines, mixed stacks, guards
# ---------------------------------------------------------------------------

def test_init_params_quantized_layout_matches_jax():
    jcfg = jax_smoke("qwen3-1.7b", linear_kind="ket", linear_rank=4, quant="int8")
    tcfg = get_smoke("qwen3-1.7b", linear_kind="ket", linear_rank=4, quant="int8")
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda k: JMD.init_params(k, jcfg), jax.random.PRNGKey(0)))[0]
    tparams = MD.init_params(tcfg, seed=0, device="cpu")
    got = jax.tree_util.tree_flatten_with_path(torch_params_to_numpy(tparams, tcfg))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    n_payloads = 0
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, jax.tree_util.keystr(path)
        n_payloads += g.dtype == np.int8
    # two factor stacks each: embed, head, and the 7 projections (JAX stacks
    # the 3 layers of the one layer group into each leaf)
    assert n_payloads == 2 * (2 + 7)
    scale = tparams["layers"][0]["ffn"]["wo"]["factors"][1]["scale"]
    assert scale.shape == (4, 1, 1) and scale.dtype == torch.float32
    with pytest.raises(ValueError, match="quant"):
        get_smoke("qwen3-1.7b", quant="int4")


def test_engine_does_not_requantize_quantized_params():
    tcfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    params = Q.quantize_params(MD.init_params(tcfg, seed=1, device="cpu"), "int8")
    eng = ServingEngine(tcfg, params, batch_slots=1, max_len=16, quant="fp8", device="cpu")
    for got, want in zip(eng.params["head"]["factors"], params["head"]["factors"]):
        assert got is want and got["q"].dtype == torch.int8


@pytest.mark.parametrize("mode", MODES)
def test_quantized_head_ce_matches_jax(mode):
    jcfg, tcfg = _cfgs("dense")
    rng = np.random.default_rng(6)
    head = [(rng.standard_normal((2, 8, 32)) * 0.3).astype(np.float32) for _ in range(2)]
    carried = [_jax_quantized(f, mode) for f in head]
    h = rng.standard_normal((5, 64)).astype(np.float32)
    y = rng.integers(0, 1024, size=5).astype(np.int32)
    want = jax_head_ce_loss(jax_head_for(jcfg), {"factors": [j for j, _ in carried]},
                            jnp.asarray(h), jnp.asarray(y))
    got = head_ce_loss(head_for(tcfg), {"factors": [t for _, t in carried]},
                       torch.from_numpy(h), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_mixed_stacks_run_the_plain_chain_on_cpu():
    rng = np.random.default_rng(7)
    f = [torch.from_numpy((rng.standard_normal((3, q, t)) * 0.3).astype(np.float32))
         for q, t in ((4, 3), (5, 6))]
    mixed = [Q.quantize(f[0], "int8"), f[1]]
    deq = [Q.as_f32(mixed[0]), f[1]]
    x = torch.from_numpy(rng.standard_normal((4, 20)).astype(np.float32))
    torch.testing.assert_close(ketops.apply_matrix_factors(mixed, x, 17),
                               M.kron_matmul(deq, x, 17), rtol=0, atol=0)
    spec = ketops.KronSpec(in_dim=20, out_dim=18, rank=3, q_dims=(4, 5), t_dims=(3, 6))
    ids = torch.tensor([0, 5, 17], dtype=torch.int32)
    torch.testing.assert_close(ketops.apply_vector(spec, {"factors": mixed}, ids),
                               ketops.apply_vector(spec, {"factors": deq}, ids),
                               rtol=0, atol=0)


def test_quant_legs_are_forward_only_and_check_their_inputs():
    q = Q.quantize(torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0)), "fp8")
    payloads, scales = [q["q"], q["q"]], [q["scale"], q["scale"]]
    x = torch.randn(3, 64)
    with torch.no_grad():
        M.kron_matmul_quant(payloads, scales, x.requires_grad_(True), 1024)
    with pytest.raises(RuntimeError, match="forward-only"):
        M.kron_matmul_quant(payloads, scales, x, 1024)
    with pytest.raises(RuntimeError, match="forward-only"):
        G.kron_gather_quant(payloads, [scales[0].clone().requires_grad_(True), scales[1]],
                            torch.zeros(3, dtype=torch.int32), 64)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        G.kron_gather_quant_cuda(payloads, scales, ids, 64)
    with pytest.raises(ValueError, match="CUDA"):
        M.kron_matmul_quant_cuda(payloads, scales, torch.zeros(3, 64), 1024)
    kind, flat = G.check_quant_inputs(payloads, scales, ids, 64)
    assert kind == 1 and [s.shape for s in flat] == [(2,), (2,)]
    kind, flat = M.check_quant_inputs([q["q"].view(torch.int8)] * 2,
                                      [torch.ones(1, 1, 1)] * 2, torch.zeros(3, 64), 1024)
    assert kind == 0 and torch.equal(flat[0], torch.ones(2))
    for bad_p, bad_s in (([q["q"], q["q"].view(torch.int8)], scales),  # mixed kinds
                         ([q["q"].float()] * 2, scales),               # fp32 payloads
                         (payloads, [torch.ones(2, 1), scales[1]]),    # scale shape
                         (payloads, [scales[0].double(), scales[1]])):  # scale dtype
        with pytest.raises(ValueError):
            G.check_quant_inputs(bad_p, bad_s, ids, 64)
