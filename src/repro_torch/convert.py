"""Carry parameters between the JAX package and the port.

The JAX LM keeps its layers stacked per layer-pattern position under
``"groups"`` (a leading layer-group axis, scanned) plus unrolled remainder
layers under ``"rem"``; the port keeps one flat list ``"layers"`` in
execution order (group g, pattern position i -> layer g·len(pattern) + i,
then the remainder). Leaves are numpy arrays on the JAX side, torch
tensors on the port's. :func:`torch_params_to_numpy` is the exact inverse
of :func:`jax_params_to_torch`.

:func:`jax_caches_to_torch` maps the caches of JAX ``prefill_fn`` the same
way: ``{"groups": (per pattern position, stacked over groups), "rem":
[...]}`` -> the port's list, one ``{"k", "v"}`` per layer.

Quantized ket factors (core/quant) cross as they are: int8 payloads and
fp32 scales as any array. fp8 payloads cross as their bits, without
``ml_dtypes``: a numpy leaf whose dtype is ``float8_e4m3fn`` becomes a
``torch.float8_e4m3fn`` tensor of the same bits, and such a tensor comes
back as a ``uint8`` array of its bits (view it as ``float8_e4m3fn`` on the
JAX side).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = ["jax_params_to_torch", "torch_params_to_numpy", "jax_caches_to_torch",
           "array_to_torch", "tensor_to_numpy"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def array_to_torch(a, dev: torch.device) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``dev`` (fp8 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":  # torch.from_numpy has no such dtype
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy())
        return bits.view(torch.float8_e4m3fn).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array (an fp8 tensor as ``uint8`` bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.float8_e4m3fn:  # numpy has no such dtype: its bits
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _index(tree, i: int):
    return _map(tree, lambda a: a[i])


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[j] for t in trees]) for j in range(len(first))]
    return np.stack(trees)


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    n = len(cfg.layer_pattern)
    return cfg.num_layers // n, cfg.num_layers % n


def jax_params_to_torch(params_np: dict, cfg: ModelConfig, device="cuda") -> dict:
    """JAX param pytree (numpy leaves) -> the port's parameters on ``device``."""
    dev = resolve_device(device)
    n_groups, n_rem = _groups(cfg)
    n_pat = len(cfg.layer_pattern)
    layers = [_index(params_np["groups"][i], g)
              for g in range(n_groups) for i in range(n_pat)]
    layers += list(params_np["rem"])[:n_rem]
    tree = {
        "embed": params_np["embed"],
        "layers": layers,
        "final_norm": params_np["final_norm"],
        "head": params_np["head"],
    }
    return _map(tree, lambda a: array_to_torch(a, dev))


def jax_caches_to_torch(caches_np: dict, cfg: ModelConfig, device="cuda") -> list:
    """JAX ``prefill_fn`` caches (numpy leaves) -> the port's list of
    per-layer caches on ``device``, in execution order."""
    dev = resolve_device(device)
    n_groups, n_rem = _groups(cfg)
    n_pat = len(cfg.layer_pattern)
    groups = caches_np["groups"]
    layers = [_index(groups[i], g) for g in range(n_groups) for i in range(n_pat)]
    layers += list(caches_np["rem"])[:n_rem]
    return _map(layers, lambda a: array_to_torch(a, dev))


def torch_params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The port's parameters -> the JAX param pytree with numpy leaves;
    an fp8 payload comes back as a ``uint8`` array of its bits."""
    flat = _map(params, tensor_to_numpy)
    n_groups, n_rem = _groups(cfg)
    n_pat = len(cfg.layer_pattern)
    layers = flat["layers"]
    groups = [_stack([layers[g * n_pat + i] for g in range(n_groups)])
              for i in range(n_pat)] if n_groups else []
    return {
        "embed": flat["embed"],
        "groups": groups,
        "rem": layers[n_groups * n_pat:],
        "final_norm": flat["final_norm"],
        "head": flat["head"],
    }
