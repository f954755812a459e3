"""The ported serving slice as a whole against the JAX package, on the same
converted parameters and prompts: chunked prefill into the dense per-slot
cache (two chunks, unequal lens, one idle slot), then greedy decode steps,
plus the port's launcher.

JAX runs with ``use_kernels=None`` (its plain chain on the CPU), the port on
``device="cpu"`` (its plain versions). Logits atol 2e-4 in fp32: 3 layers of
fp32 matmuls in another summation order; greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import model as JMD
from repro_torch.configs import get_smoke
from repro_torch.convert import jax_params_to_torch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as MD

torch.set_num_threads(2)

B, C, MAX_LEN, STEPS = 3, 8, 32, 4
LENS = [(C, C, 0), (C, 3, 0)]  # slot 1's prompt ends mid-chunk, slot 2 idles
ATOL = 2e-4


@pytest.fixture(scope="module")
def run():
    """Both packages through prefill + greedy decode; the JAX side once."""
    jcfg = jax_smoke("qwen3-1.7b", dtype=jnp.float32)
    tcfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    jparams = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                  device="cpu")
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32)
              for _ in LENS]

    jprefill = jax.jit(lambda p, c, t, n: JMD.prefill_chunk_fn(p, jcfg, c, t, n))
    jstep = jax.jit(lambda p, c, t: JMD.serve_step_fn(p, jcfg, c, t))
    jcache = JMD.init_cache(jcfg, B, MAX_LEN)
    tcache = MD.init_cache(tcfg, B, MAX_LEN, device="cpu")
    out = {"jax": [], "torch": [], "jax_step": [], "torch_step": [], "tokens": []}
    with torch.inference_mode():
        for toks, lens in zip(chunks, LENS):
            jl, jcache = jprefill(jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(lens, jnp.int32))
            tl, tcache = MD.prefill_chunk_fn(tparams, tcfg, tcache, torch.from_numpy(toks),
                                             torch.tensor(lens, dtype=torch.int32))
            out["jax"].append(np.asarray(jl))
            out["torch"].append(tl.numpy().copy())
            out["jax_step"].append(np.asarray(jcache["step"]))
            out["torch_step"].append(tcache["step"].numpy().copy())
        for _ in range(STEPS):
            tok = np.argmax(out["jax"][-1], axis=-1).astype(np.int32)
            out["tokens"].append((tok, np.argmax(out["torch"][-1], axis=-1)))
            jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
            tl, tcache = MD.serve_step_fn(tparams, tcfg, tcache, torch.from_numpy(tok))
            out["jax"].append(np.asarray(jl))
            out["torch"].append(tl.numpy().copy())
            out["jax_step"].append(np.asarray(jcache["step"]))
            out["torch_step"].append(tcache["step"].numpy().copy())
    out["caches"] = (jcache, tcache)
    return out


@pytest.mark.parametrize("call", range(len(LENS) + STEPS))
def test_logits_match_jax(run, call):
    got, want = run["torch"][call], run["jax"][call]
    assert got.shape == want.shape == (B, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_greedy_tokens_identical(run):
    for want, got in run["tokens"]:
        np.testing.assert_array_equal(got, want)


def test_per_slot_step_advances_identically(run):
    expected = [(8, 8, 0), (16, 11, 0)] + [(16 + i, 11 + i, i) for i in range(1, 5)]
    for want, jax_step, torch_step in zip(expected, run["jax_step"], run["torch_step"]):
        np.testing.assert_array_equal(jax_step, want)
        np.testing.assert_array_equal(torch_step, want)


def test_dense_kv_cache_matches_jax(run):
    jcache, tcache = run["caches"]
    for i, layer in enumerate(tcache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jcache["groups"][0][name][i]),
                                       atol=ATOL, rtol=0)


def test_launcher_serves_on_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                              "--batch", "2", "--new-tokens", "3", "--max-len", "8"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] qwen3-1.7b-smoke mesh=OrderedDict({'data': 1, "
                           "'model': 1}) cache=dense: 6 tok in ")
    assert line.endswith(" tok/s)")


def test_decode_past_the_dense_cache_matches_jax():
    """Steps at or past max_len drop their K/V write, as JAX's scatter does
    (an idle engine slot advances its step with its neighbours): max_len + 2
    decode steps on a max_len = 4 cache match the JAX logits."""
    jcfg = jax_smoke("qwen3-1.7b", dtype=jnp.float32)
    tcfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    jparams = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                  device="cpu")
    jstep = jax.jit(lambda p, c, t: JMD.serve_step_fn(p, jcfg, c, t))
    jcache = JMD.init_cache(jcfg, 2, 4)
    tcache = MD.init_cache(tcfg, 2, 4, device="cpu")
    tok = np.array([3, 5], np.int32)
    with torch.inference_mode():
        for _ in range(4 + 2):
            jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
            tl, tcache = MD.serve_step_fn(tparams, tcfg, tcache, torch.from_numpy(tok))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
            tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(tcache["step"].numpy(), [6, 6])


def test_launcher_serves_paged_raw_steps_on_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                              "--paged", "--batch", "2", "--new-tokens", "3",
                              "--max-len", "8"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] qwen3-1.7b-smoke mesh=OrderedDict({'data': 1, "
                           "'model': 1}) cache=paged: 6 tok in ")


# the JAX launcher prints the same ticks and pages for these arguments
@pytest.mark.parametrize("extra,ticks,tail", [
    ([], "6 reqs in 10 ticks (6 prefill + 4 decode)", "pages free=6/6"),
    (["--prefix-cache", "--shared-prefix-len", "16", "--requests", "10", "--batch", "4"],
     "10 reqs in 11 ticks (5 prefill + 6 decode)",
     "pages free=7/8, prefix hit pages=6 (hits=6 misses=4 cow=0)"),
], ids=["random_prompts", "prefix_cache"])
def test_launcher_serves_engine_on_cpu(capsys, extra, ticks, tail):
    args = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--engine",
            "--requests", "6", "--batch", "3", "--prompt-len", "20",
            "--new-tokens", "3", "--max-len", "32", "--prefill-chunk", "8"]
    assert launch_serve.main(args + extra) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve:engine] qwen3-1.7b-smoke chunked/paged/optimistic: "
                           + ticks), line
    assert line.endswith(tail), line


def test_launcher_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--engine"])


@pytest.mark.parametrize("flag", [pytest.param(["--mesh", "1x2"], id="flag3")])
def test_launcher_refuses_unported_modes(flag):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", *flag])


# the smoke embedding and head: 4 stacks of 2 x 8 x 32 = 2,048 payloads and
# 8 scales
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("engine", [False, True], ids=["raw", "engine"])
def test_launcher_serves_quantized(capsys, engine, mode):
    args = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--quant", mode]
    if engine:
        args += ["--engine", "--requests", "6", "--batch", "3", "--prompt-len", "20",
                 "--new-tokens", "3", "--max-len", "32", "--prefill-chunk", "8"]
    else:
        args += ["--batch", "2", "--new-tokens", "3", "--max-len", "8"]
    assert launch_serve.main(args) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == (f"[serve] ket operators (4 factor stacks): 2,080 B stored as "
                         f"{mode}, 8,192 B in fp32")
    if engine:  # the JAX launcher prints the same ticks for these arguments
        assert lines[-1].startswith("[serve:engine] qwen3-1.7b-smoke chunked/paged/"
                                    "optimistic: 6 reqs in 10 ticks (6 prefill + 4 decode)")
        assert lines[-1].endswith("pages free=6/6")
    else:
        assert lines[-1].startswith("[serve] qwen3-1.7b-smoke mesh=OrderedDict({'data': 1, "
                                    "'model': 1}) cache=dense: 6 tok in ")
