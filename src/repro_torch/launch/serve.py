"""Serving launcher of the port (torch port of ``repro.launch.serve``).

Raw-step mode (default) times greedy decode steps over a dense or paged
(``--paged``, identity page table) cache after one warm-up step, and prints
one ``[serve] …`` line. ``--engine`` drives the continuous-batching
``ServingEngine`` (chunked prefill, paged pools, page-budget scheduler)
and prints its ``[serve:engine] …`` stats line. Seeded random parameters;
the whole config runs in fp32, as the JAX launcher runs it. ``--quant
int8|fp8`` serves the ket factor stacks from the low-bit wire format
(core/quant): the engine calibrates them at construction, raw-step mode
quantizes after ``init_params``; either prints the stored bytes of the
ket operators beside their fp32 bytes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 8 --new-tokens 32 [--paged] [--smoke] [--device cpu] [--quant int8]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \
        --engine --device cpu --prefix-cache --shared-prefix-len 16

A ``--mesh`` other than ``1x1`` is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ket_bytes_line(params, mode: str) -> str:
    """The stored bytes of every ket factor stack in ``params`` under
    ``mode`` beside their fp32 bytes (payloads plus fp32 scales)."""
    from repro_torch.core import quant as Q

    shapes = []

    def walk(tree):
        if isinstance(tree, dict):
            if isinstance(tree.get("factors"), list):
                shapes.extend(tuple((f["q"] if Q.is_quantized(f) else f).shape)
                              for f in tree["factors"])
                return
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(params)
    return (f"[serve] ket operators ({len(shapes)} factor stacks): "
            f"{Q.storage_bytes(shapes, mode):,} B stored as {mode}, "
            f"{Q.storage_bytes(shapes, 'none'):,} B in fp32")


def _run_engine(cfg, args, device) -> int:
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.faultinject import shared_prefix_prompts

    params = MD.init_params(cfg, seed=args.seed, device=device)
    eng = ServingEngine(
        cfg, params, batch_slots=args.batch, max_len=args.max_len,
        quant=args.quant, cache_mode="dense" if args.dense else "paged",
        prefill_chunk=args.prefill_chunk or None,
        prefill_mode=args.prefill_mode, admission=args.admission,
        num_pages=args.num_pages or None, prefix_cache=args.prefix_cache,
        handle_signals=True, device=device)  # SIGTERM drains instead of dropping
    if args.quant != "none":
        print(_ket_bytes_line(eng.params, args.quant))
    if args.shared_prefix_len:
        if args.shared_prefix_len > args.prompt_len:
            raise SystemExit("--shared-prefix-len exceeds --prompt-len")
        prompts = shared_prefix_prompts(
            args.seed + 1, args.requests, args.shared_prefix_len,
            args.prompt_len - args.shared_prefix_len, cfg.vocab_size)
    else:
        rng = np.random.default_rng(args.seed + 1)
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(args.requests, args.prompt_len)).tolist()
    for i, prompt in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.new_tokens,
                           deadline_s=args.deadline_s or None))
    res = eng.run_until_drained()
    st = eng.stats()
    pages = (f", pages free={st['free_pages']}/{st['page_capacity']}"
             if st["free_pages"] is not None else "")
    fault = (f", failed={st['failed']}" if st["failed"] else "") + \
        (f", preempted={st['preemptions']}" if st["preemptions"] else "") + \
        ("" if res.drained else f", UNDRAINED stranded={res.stranded}")
    if eng.prefix_cache is not None:
        fault += (f", prefix hit pages={st['prefix_hit_pages']}"
                  f" (hits={st['prefix_hits']} misses={st['prefix_misses']}"
                  f" cow={st['cow_copies']})")
    lat = ("p50=n/a p95=n/a" if st["p50_latency_s"] is None else
           f"p50={st['p50_latency_s']:.3f}s p95={st['p95_latency_s']:.3f}s")
    print(f"[serve:engine] {cfg.name} {eng.prefill_mode}/{eng.cache_mode}"
          f"/{eng.admission}: {st['completed']} reqs in {res.ticks} ticks "
          f"({st['prefill_ticks']} prefill + {st['decode_ticks']} decode), "
          f"{st['prompt_tokens_per_sec']:.0f} prompt tok/s, "
          f"{st['tokens_per_sec']:.0f} gen tok/s, {lat}"
          f"{pages}{fault}")
    return 0 if res.drained else 1


def main(argv=None) -> int:
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import model as MD
    from repro_torch.serve.cache import identity_ptab

    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--mesh", default="1x1")
    p.add_argument("--quant", default="none", choices=["none", "int8", "fp8"],
                   help="post-training ket-factor quantization (wire format)")
    p.add_argument("--paged", action="store_true",
                   help="raw-step mode: paged KV pools instead of dense")
    p.add_argument("--dense", action="store_true",
                   help="engine mode: dense slot caches instead of paged")
    p.add_argument("--engine", action="store_true",
                   help="drive the continuous-batching ServingEngine")
    p.add_argument("--requests", type=int, default=8,
                   help="engine mode: number of requests to submit")
    p.add_argument("--prompt-len", type=int, default=32,
                   help="engine mode: prompt tokens per request")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="engine mode: prompt tokens per prefill tick (0 = config)")
    p.add_argument("--prefill-mode", default="chunked", choices=["chunked", "stepwise"])
    p.add_argument("--admission", default="optimistic",
                   choices=["optimistic", "reserve"],
                   help="engine mode: incremental page growth with youngest-slot "
                        "preemption, or worst-case reservation")
    p.add_argument("--num-pages", type=int, default=0,
                   help="engine mode: page-pool size (0 = full capacity)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="engine mode: per-request TTL (0 = none)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="engine mode: content-addressed prefix caching")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="engine mode: tokens shared by every prompt (0 = random)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to serve on; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError("--mesh is not ported yet")
    device = resolve_device(args.device)
    cfg = (get_smoke if args.smoke else get_config)(args.arch, dtype=torch.float32)
    if args.engine:
        return _run_engine(cfg, args, device)
    if args.new_tokens + 1 > args.max_len:
        raise SystemExit("--max-len must exceed --new-tokens (the warm-up step "
                         "takes one position)")

    params = MD.init_params(cfg, seed=args.seed, device=device)
    if args.quant != "none":
        from repro_torch.serve.engine import quantize_params
        params = quantize_params(params, args.quant)
        print(_ket_bytes_line(params, args.quant))
    cache = MD.init_cache(cfg, args.batch, args.max_len, paged=args.paged, device=device)
    if args.paged:
        identity_ptab(cache, args.batch)
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
    print(f"[serve] {cfg.name} mesh={mesh} cache={'paged' if args.paged else 'dense'}: "
          f"{total} tok in {dt:.2f}s ({total / dt:.0f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
