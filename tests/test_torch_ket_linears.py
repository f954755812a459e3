"""The port's ket-linear path (``linear_kind="ket"``: every attention and
FFN projection stored as rank-8 Kronecker factor stacks) against the JAX
package, on the CPU.

At ``get_smoke("qwen3-1.7b", dtype=float32, linear_kind="ket")`` (3 layers,
d 64, d_ff 192; factor shapes q (8, 8) -> t (8, 8), (8, 4), (16, 12) and
q (16, 12) -> t (8, 8)), with JAX parameters from ``PRNGKey(0)`` carried
across by ``convert.py``:

* the parameter tree (factor shapes, counts) and the convert round trip;
* ``lm_loss`` and every gradient (the ket factors, the norms, the embedding
  and head factors) against ``jax.value_and_grad`` of JAX's ``loss_fn``,
  with a label mask, for both JAX routes of the ket linears: the
  ``kron_matmul`` custom VJP (``linear_use_kernel=True``, whose backward off
  the TPU is ``kron_matmul_bwd_host``) and the plain chain's VJP (None):
  loss atol 1e-6, gradients atol 1e-6 + rtol 1e-4 (slice 3's tolerance:
  the same fp32 math in another summation order);
* three ``make_train_step`` AdamW steps against JAX's jitted step: losses
  and grad norms atol 1e-5 + rtol 1e-5;
* serving: chunked prefill into the dense cache, then greedy decode steps,
  logits atol 2e-4 (as the dense serving slice), greedy tokens identical;
  and ``ServingEngine`` (paged, chunked prefill) with the ket parameters,
  whose greedy outputs equal greedy decoding by the full-sequence forward;
* the training launcher with ``--linear ket`` on the CPU.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import model as JMD
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch.configs import get_smoke
from repro_torch.convert import jax_params_to_torch, torch_params_to_numpy
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.models.common import is_ket_param
from repro_torch.optim import adamw as TA
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train.step import TrainConfig, make_train_step, with_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
BATCH, SEQ = 4, 16
# the JAX routes of the ket linears: the kron_matmul custom VJP (host
# executors of the Pallas kernels off the TPU) and the plain chain's VJP
JAX_ROUTES = {"kron_matmul": True, "chain": None}


def _jcfg(route="kron_matmul"):
    return jax_smoke("qwen3-1.7b", dtype=jnp.float32, linear_kind="ket",
                     linear_use_kernel=JAX_ROUTES[route])


def _tcfg():
    return get_smoke("qwen3-1.7b", dtype=torch.float32, linear_kind="ket")


@pytest.fixture(scope="module")
def jax_params():
    return JMD.init_params(jax.random.PRNGKey(0), _jcfg())


def _to_torch(jax_params):
    return jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jax_params), _tcfg(),
                               device="cpu")


def _batch(step, seed=0):
    return batch_at(DataConfig(vocab_size=1024, seq_len=SEQ, global_batch=BATCH, seed=seed),
                    step)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def test_ket_params_match_jax_and_round_trip(jax_params):
    cfg = _tcfg()
    ours = MD.init_params(cfg, seed=0, device="cpu")
    theirs = _to_torch(jax_params)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), theirs)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == shapes
    layer = ours["layers"][0]
    for proj in (layer["attn"]["wq"], layer["attn"]["wk"], layer["attn"]["wv"],
                 layer["attn"]["wo"], *layer["ffn"].values()):
        assert is_ket_param(proj) and [f.shape[0] for f in proj["factors"]] == [8, 8]
    assert [tuple(f.shape) for f in layer["ffn"]["wi"]["factors"]] == [(8, 8, 16), (8, 8, 12)]
    assert [tuple(f.shape) for f in layer["ffn"]["wo"]["factors"]] == [(8, 16, 8), (8, 12, 8)]
    assert MD.param_count(ours) == MD.param_count(theirs) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jax_params))
    back = torch_params_to_numpy(theirs, cfg)
    want = jax.tree_util.tree_map(np.asarray, jax_params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", list(JAX_ROUTES))
def test_lm_loss_and_every_gradient_match_jax(jax_params, route):
    b = _batch(0)
    mask = (np.random.default_rng(0).random((BATCH, SEQ)) < 0.7).astype(np.float32)
    jb = {"tokens": jnp.asarray(b["tokens"]), "labels": jnp.asarray(b["labels"]),
          "label_mask": jnp.asarray(mask)}
    jcfg = _jcfg(route)
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jb), has_aux=True))(jax_params)

    cfg = _tcfg()
    params = with_params(_to_torch(jax_params))["params"]
    loss, _ = MD.loss_fn(params, cfg, {"tokens": torch.from_numpy(b["tokens"]),
                                       "labels": torch.from_numpy(b["labels"]),
                                       "label_mask": torch.from_numpy(mask)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-6, rtol=0)
    got = torch_params_to_numpy(_grad_tree(params), cfg)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jgrads)
    paths = []
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            jax.tree_util.tree_leaves(got)):
        paths.append(jax.tree_util.keystr(path))
        assert np.abs(w).max() > 0, paths[-1]
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4, err_msg=paths[-1])
    assert sum("'factors'" in p and "'groups'" in p for p in paths) == 7 * 2


def test_three_adamw_steps_track_jax(jax_params):
    jstep = jax.jit(JS.make_train_step(_jcfg(), JS.TrainConfig(
        optimizer=JA.AdamWConfig(lr=LR))))
    jstate = {"params": jax_params, "opt": JA.adamw_init(jax_params)}
    state = with_params(_to_torch(jax_params))
    step = make_train_step(_tcfg(), TrainConfig(optimizer=TA.AdamWConfig(lr=LR)))
    for i in range(3):
        b = _batch(i, seed=1)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   atol=1e-5, rtol=1e-5)
    assert state["opt"]["step"] == int(jstate["opt"]["step"]) == 3


B, C, MAX_LEN, STEPS = 3, 8, 32, 3
LENS = [(C, C, 0), (C, 3, 0)]  # slot 1's prompt ends mid-chunk, slot 2 idles


def test_ket_serving_matches_jax(jax_params):
    jcfg = jax_smoke("qwen3-1.7b", dtype=jnp.float32, linear_kind="ket")
    tcfg = _tcfg()
    tparams = _to_torch(jax_params)
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32) for _ in LENS]
    jprefill = jax.jit(lambda p, c, t, n: JMD.prefill_chunk_fn(p, jcfg, c, t, n))
    jstep = jax.jit(lambda p, c, t: JMD.serve_step_fn(p, jcfg, c, t))
    jcache = JMD.init_cache(jcfg, B, MAX_LEN)
    tcache = MD.init_cache(tcfg, B, MAX_LEN, device="cpu")
    with torch.inference_mode():
        for toks, lens in zip(chunks, LENS):
            jl, jcache = jprefill(jax_params, jcache, jnp.asarray(toks),
                                  jnp.asarray(lens, jnp.int32))
            tl, tcache = MD.prefill_chunk_fn(tparams, tcfg, tcache, torch.from_numpy(toks),
                                             torch.tensor(lens, dtype=torch.int32))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
        for _ in range(STEPS):
            tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
            np.testing.assert_array_equal(tl.numpy().argmax(-1), tok)
            jl, jcache = jstep(jax_params, jcache, jnp.asarray(tok))
            tl, tcache = MD.serve_step_fn(tparams, tcfg, tcache, torch.from_numpy(tok))
            assert tl.shape == (B, 1024) and tl.dtype == torch.float32
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tcache["step"].numpy(), np.asarray(jcache["step"]))


def test_ket_engine_matches_the_full_sequence_forward(jax_params):
    cfg, params = _tcfg(), _to_torch(jax_params)
    prompts = [[5, 17, 33, 2, 9, 40, 11], [7, 3], [1, 2, 3, 4, 5]]
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32, prefill_chunk=3,
                        device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained().drained
    with torch.inference_mode():
        for p, r in zip(prompts, reqs):
            seq = list(p)
            for _ in range(4):
                x = T.forward(params, cfg, torch.tensor([seq]))
                seq.append(int(T.lm_logits_last(params, cfg, x[:, -1]).argmax(-1)))
            assert r.output == seq[len(p):]


def test_train_launcher_runs_with_ket_linears():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
         "--device", "cpu", "--steps", "2", "--linear", "ket", "--linear-rank", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[train] qwen3-1.7b-smoke on cpu: final step 2" in proc.stdout
    loss = float(proc.stdout.split(" loss ")[1].split()[0])
    assert math.isfinite(loss)
