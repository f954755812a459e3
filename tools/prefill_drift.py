#!/usr/bin/env python3
"""Which kernel moves the bf16 ``prefill_fn`` away from ``use_kernels=False``.

    python3 tools/prefill_drift.py [--tokens 4096]

Runs ``prefill_fn`` of the full qwen3-1.7b (seed-0 weights, bf16
activations, one prompt of seeded random tokens, as ``chip_smoke.py``) four
times: no kernel (``use_kernels=False``), every kernel, the flash-attention
kernel alone (the embedding lookup on its plain version), and the lookup
kernel alone (the attention on the plain chunked version). For each run with
a kernel it prints, per layer, the worst row's relative error of k and of v
against the run with no kernel (a row: one token's k or v in one kv head,
relative to the plain row's norm, as ``chip_smoke.py`` gates it), and the
median over every row. The last line is a JSON summary. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs import base as B
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.models import model as MD
    from repro_torch.models import transformer as T

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3-1.7b")
    params = MD.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.tokens), generator=gen, device=dev,
                           dtype=torch.int32)

    def run(lookup_kernel: bool, flash_kernel: bool):
        """prefill_fn with each of the two kernels on or off; returns the
        caches and the launches of each kernel."""
        c = cfg if lookup_kernel or flash_kernel else dataclasses.replace(cfg, use_kernels=False)
        embedding_for, kernel_route = T.embedding_for, T.kernel_route
        if not lookup_kernel:
            T.embedding_for = lambda m: B.embedding_for(dataclasses.replace(m, use_kernels=False))
        if not flash_kernel:
            T.kernel_route = lambda flag, t: False  # apply_block's attention route only
        before = (G.launches["kron_gather_fwd"], FA.launches["flash_fwd_tc"])
        try:
            with torch.inference_mode():
                _, caches = MD.prefill_fn(params, c, {"tokens": tokens})
            torch.cuda.synchronize()
        finally:
            T.embedding_for, T.kernel_route = embedding_for, kernel_route
        ran = (G.launches["kron_gather_fwd"] - before[0], FA.launches["flash_fwd_tc"] - before[1])
        return caches, ran

    plain, ran = run(False, False)
    if ran != (0, 0):
        raise SystemExit(f"the plain run launched kernels: {ran}")
    summary = {"card": torch.cuda.get_device_name(0), "tokens": args.tokens}
    for name, lookup_kernel, flash_kernel in (("every kernel", True, True),
                                              ("flash kernel alone", False, True),
                                              ("lookup kernel alone", True, False)):
        caches, ran = run(lookup_kernel, flash_kernel)
        want = (int(lookup_kernel), cfg.num_layers if flash_kernel else 0)
        if ran != want:
            raise SystemExit(f"{name}: launches (lookup, flash) {ran}, expected {want}")
        worst, rows = {}, []
        for i, (a, b) in enumerate(zip(caches, plain)):
            for kv in ("k", "v"):
                x, y = a[kv].float(), b[kv].float()
                rel = (x - y).norm(dim=-1) / y.norm(dim=-1).clamp_min(1e-30)
                worst[f"{i}{kv}"] = rel.max().item()
                rows.append(rel.flatten())
        median = torch.cat(rows).median().item()
        layers = [(worst[f"{i}k"], worst[f"{i}v"]) for i in range(cfg.num_layers)]
        print(f"[{name}] launches (lookup, flash) {ran}; median row error {median:.3e}; "
              f"worst row per layer (k/v): " + ", ".join(
                  f"{i}: {k:.2e}/{v:.2e}" for i, (k, v) in enumerate(layers)), flush=True)
        summary[name] = {"median": median, "worst": max(worst.values()),
                         "layer0": layers[0], "layer_last": layers[-1]}
        del caches
        torch.cuda.empty_cache()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
