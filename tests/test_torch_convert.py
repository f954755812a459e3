"""Parameter carry-over between the JAX package and the port
(repro_torch.convert), and the port's init against the JAX tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import model as JMD
from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import jax_params_to_torch, torch_params_to_numpy
from repro_torch.models import model as MD

torch.set_num_threads(2)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke("qwen3-1.7b", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, JMD.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, get_smoke("qwen3-1.7b", dtype=torch.float32), params


def test_smoke_tree_round_trips_bit_exactly(smoke):
    _, tcfg, params = smoke
    back = torch_params_to_numpy(jax_params_to_torch(params, tcfg, device="cpu"), tcfg)
    want, got = _leaves(params), _leaves(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_layers_follow_execution_order(smoke):
    _, tcfg, params = smoke
    tp = jax_params_to_torch(params, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers == 3
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["ffn"]["wi"].numpy(),
                                      params["groups"][0]["ffn"]["wi"][i])


def test_port_init_has_the_jax_tree_shapes(smoke):
    _, tcfg, params = smoke
    mine = torch_params_to_numpy(MD.init_params(tcfg, seed=1, device="cpu"), tcfg)
    want, got = _leaves(params), _leaves(mine)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path


def test_port_init_is_seeded(smoke):
    _, tcfg, _ = smoke
    a = MD.init_params(tcfg, seed=3, device="cpu")
    b = MD.init_params(tcfg, seed=3, device="cpu")
    torch.testing.assert_close(a["layers"][2]["attn"]["wq"], b["layers"][2]["attn"]["wq"],
                               rtol=0, atol=0)
    torch.testing.assert_close(a["head"]["factors"][1], b["head"]["factors"][1],
                               rtol=0, atol=0)


def test_full_config_parameter_count_matches_jax():
    jcfg = jax_config("qwen3-1.7b")
    shapes = jax.eval_shape(lambda: JMD.init_params(jax.random.PRNGKey(0), jcfg))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    got = MD.param_count(MD.init_params(get_config("qwen3-1.7b"), device="meta"))
    assert got == want == 1_411_806_208


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MD.init_params(get_smoke("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MD.init_cache(get_smoke("qwen3-1.7b"), 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
