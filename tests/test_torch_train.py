"""Parity of the port's training path (repro_torch.train, optim, models
lm_loss, data, fault) with the JAX package, on the CPU.

At ``get_smoke("qwen3-1.7b", dtype=float32)`` (3 layers, d 64, vocab 1024,
rank-2 word2ketXS embedding and Kronecker head), with JAX parameters from
``PRNGKey(0)`` converted to torch and batches from the synthetic Markov
corpus (numpy, shared by both):

* ``lm_loss`` and every parameter gradient against JAX's ``loss_fn`` under
  ``jax.value_and_grad``, with a label mask: loss atol 1e-6, gradients
  atol 1e-6 + rtol 1e-4 (the same fp32 math in another summation order);
* three ``make_train_step`` AdamW steps against JAX's jitted step, with
  microbatches 1 and 2 and the guard rejecting the second update: per-step
  losses and grad norms atol 1e-5 + rtol 1e-5 (the first step's gradients
  agree to ~1e-7; AdamW normalizes each update, so a near-zero gradient
  component that differs in its last bits can move its parameter by up to
  lr, which the next steps' losses see at the 1e-6 level), and whether each
  update was applied;
* AdamW, the cosine schedule, the synthetic batches and the anomaly
  detector against their JAX twins, exactly or to fp32 rounding;
* the launcher and the loop's ladder on the CPU.
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
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import batch_at as jax_batch_at
from repro.fault import LossAnomalyDetector as JaxDetector
from repro.models import model as JMD
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch.configs import get_smoke
from repro_torch.convert import jax_params_to_torch, torch_params_to_numpy
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.fault import LossAnomalyDetector
from repro_torch.models import model as MD
from repro_torch.optim import adamw as TA
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig, make_train_step, with_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
BATCH, SEQ = 4, 16


def _jcfg():
    return jax_smoke("qwen3-1.7b", dtype=jnp.float32)


def _tcfg():
    return get_smoke("qwen3-1.7b", dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params():
    return JMD.init_params(jax.random.PRNGKey(0), _jcfg())


def _batch(step, seed=0):
    return batch_at(DataConfig(vocab_size=1024, seq_len=SEQ, global_batch=BATCH, seed=seed),
                    step)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def test_lm_loss_and_every_gradient_match_jax(jax_params):
    b = _batch(0)
    mask = (np.random.default_rng(0).random((BATCH, SEQ)) < 0.7).astype(np.float32)
    jb = {"tokens": jnp.asarray(b["tokens"]), "labels": jnp.asarray(b["labels"]),
          "label_mask": jnp.asarray(mask)}
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JMD.loss_fn(p, _jcfg(), jb), has_aux=True))(jax_params)

    cfg = _tcfg()
    params = with_params(jax_params_to_torch(
        jax.tree_util.tree_map(np.asarray, jax_params), cfg, device="cpu"))["params"]
    loss, metrics = MD.loss_fn(params, cfg, {"tokens": torch.from_numpy(b["tokens"]),
                                             "labels": torch.from_numpy(b["labels"]),
                                             "label_mask": torch.from_numpy(mask)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-6, rtol=0)
    assert metrics["ce"] is loss
    got = torch_params_to_numpy(_grad_tree(params), cfg)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jgrads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            jax.tree_util.tree_leaves(got)):
        assert np.abs(w).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


# the guard's loss cap on the second step: below any loss of this model
REJECT = 1.0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_adamw_steps_track_jax(jax_params, microbatches):
    jcfg = _jcfg()
    jt = JS.TrainConfig(optimizer=JA.AdamWConfig(lr=LR), microbatches=microbatches)
    jstep = jax.jit(JS.make_train_step(jcfg, jt))
    jstate = {"params": jax_params, "opt": JA.adamw_init(jax_params)}
    cfg = _tcfg()
    state = with_params(jax_params_to_torch(
        jax.tree_util.tree_map(np.asarray, jax_params), cfg, device="cpu"))
    step = make_train_step(cfg, TrainConfig(optimizer=TA.AdamWConfig(lr=LR),
                                            microbatches=microbatches))
    for i in range(3):
        b = _batch(i, seed=1)
        cap = REJECT if i == 1 else math.inf
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           (jnp.float32(cap), jnp.float32(math.inf)))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        (cap, math.inf))
        assert bool(jm["applied"]) == m["applied"] == (i != 1)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    assert state["opt"]["step"] == int(jstate["opt"]["step"]) == 2


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((5, 4)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    cfg_j = JA.AdamWConfig(lr=0.01, schedule=JA.cosine_schedule(0.01, 2, 10))
    cfg_t = TA.AdamWConfig(lr=0.01, schedule=TA.cosine_schedule(0.01, 2, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = JA.adamw_init(jp)
    tp = {"a": torch.from_numpy(params["a"].copy()), "b": [torch.from_numpy(params["b"][0].copy())]}
    topt = TA.adamw_init(tp)
    for k in range(4):
        # the third step's norm exceeds the clip of 1.0
        grads = {"a": rng.standard_normal((5, 4)).astype(np.float32) * (3.0 if k == 2 else 0.1),
                 "b": [rng.standard_normal(7).astype(np.float32) * 0.1]}
        jp, jopt, jm = JA.adamw_update(cfg_j, jax.tree_util.tree_map(jnp.asarray, grads),
                                       jopt, jp)
        tm = TA.adamw_update(cfg_t, [torch.from_numpy(grads["a"]),
                                     torch.from_numpy(grads["b"][0])], topt, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(tp["b"][0].numpy(), np.asarray(jp["b"][0]), atol=1e-7,
                                   rtol=1e-6)
    assert topt["step"] == int(jopt["step"]) == 4


def test_cosine_schedule_matches_jax():
    jf, tf = JA.cosine_schedule(3e-4, 20, 100), TA.cosine_schedule(3e-4, 20, 100)
    for s in (0, 1, 19, 20, 21, 60, 99, 100, 150):
        np.testing.assert_allclose(tf(s), float(jf(jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["markov", "zipf"])
def test_synthetic_batches_are_the_jax_batches(kind):
    for step in (0, 5):
        kw = dict(vocab_size=1024, seq_len=12, global_batch=3, seed=4, kind=kind)
        want = jax_batch_at(JaxDataConfig(**kw), step)
        got = batch_at(DataConfig(**kw), step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_anomaly_detector_matches_jax():
    ours, theirs = LossAnomalyDetector(factor=3.0, window=4, warmup=2), JaxDetector(
        factor=3.0, window=4, warmup=2)
    for loss, gnorm in [(5.0, 1.0), (4.0, 2.0), (6.0, 0.5), (3.0, 1.5), (2.0, 1.0)]:
        assert ours.thresholds() == theirs.thresholds()
        ours.observe(loss, gnorm)
        theirs.observe(loss, gnorm)
    th = ours.thresholds()
    for loss, gnorm in [(float("nan"), 1.0), (1.0, float("inf")), (100.0, 1.0), (1.0, 100.0)]:
        assert ours.classify(loss, gnorm, th) == theirs.classify(loss, gnorm, th)


def test_loop_fails_with_a_reason_when_an_anomaly_persists():
    cfg = _tcfg()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    # after one applied step every loss is a "spike" of a 1e-6 x median bound
    out = train_loop(cfg, TrainConfig(), dcfg,
                     LoopConfig(total_steps=5, spike_warmup=1, spike_factor=1e-6),
                     device="cpu", log_fn=lambda s: None)
    assert out["failed"] and out["final_step"] == 1
    assert "rollback unavailable" in out["fail_reason"]
    assert out["skipped_steps"] == 3 and out["rollbacks"] == 1
    with pytest.raises(NotImplementedError):
        train_loop(cfg, TrainConfig(), dcfg, LoopConfig(ckpt_dir="ckpt"), device="cpu")
    with pytest.raises(NotImplementedError):
        make_train_step(cfg, TrainConfig(compress_grads=True))


def test_train_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
         "--device", "cpu", "--steps", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[train] qwen3-1.7b-smoke on cpu: final step 2" in proc.stdout
