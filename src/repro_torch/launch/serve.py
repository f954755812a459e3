"""Serving launcher of the port: batched greedy decode on the dense cache.

Raw-step mode as in ``repro.launch.serve``: seeded random parameters, a
dense per-slot cache, a warm-up step, then ``--new-tokens`` timed greedy
decode steps, and one ``[serve] …`` line. The whole config runs in fp32,
as the JAX launcher runs it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 8 --new-tokens 32 [--smoke] [--device cpu]

``--paged``, ``--engine``, ``--quant`` other than ``none`` and a ``--mesh``
other than ``1x1`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import collections
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import model as MD

    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--mesh", default="1x1")
    p.add_argument("--quant", default="none", choices=["none", "int8", "fp8"])
    p.add_argument("--paged", action="store_true")
    p.add_argument("--engine", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to serve on; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    for flag, asked in (("--paged", args.paged), ("--engine", args.engine),
                        ("--quant", args.quant != "none"),
                        ("--mesh", args.mesh != "1x1")):
        if asked:
            raise NotImplementedError(f"{flag} is not ported yet")
    if args.new_tokens + 1 > args.max_len:
        raise SystemExit("--max-len must exceed --new-tokens (the warm-up step "
                         "takes one position)")
    device = resolve_device(args.device)

    cfg = (get_smoke if args.smoke else get_config)(args.arch, dtype=torch.float32)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    cache = MD.init_cache(cfg, args.batch, args.max_len, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch,), generator=gen,
                         device=device, dtype=torch.int32)
    with torch.inference_mode():
        logits, cache = MD.serve_step_fn(params, cfg, cache, toks)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.new_tokens):
            logits, cache = MD.serve_step_fn(params, cfg, cache, toks)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(device)
        dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    mesh = collections.OrderedDict([("data", 1), ("model", 1)])
    print(f"[serve] {cfg.name} mesh={mesh} cache=dense: {total} tok in {dt:.2f}s "
          f"({total / dt:.0f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
