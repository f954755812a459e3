#!/usr/bin/env python3
"""Time the full qwen3-1.7b training step and decode step of two checkouts on one card, in turns.

    python3 tools/ab_train_step.py OTHER_CHECKOUT [--rounds 1] [--steps 6]

Each run is a fresh process on one tree: OTHER, THIS, THIS, OTHER per round
(an A B B A order, so a drift of the card or its host over the call weighs
on both trees alike). A run builds its tree's kernels (untimed),
then trains the dense config and the ket config (rank 8) from seed 0 for
``--steps`` AdamW steps each at 8 x 256 synthetic tokens in bf16, as
``chip_smoke.py`` does, and prints the median step wall over steps 1 on
(host clock after a sync) and the device time of one more step by
``torch.profiler``: every kernel, and apart the flash-attention kernels,
the fused-CE kernels (forward, backward, their copies and reduces) and
the kron_gather kernels. Then the dense config serves 8 prompts of 128
tokens (chunked prefill into the dense cache) and takes ``4 x --steps``
greedy decode steps: the same numbers for one decode step ("decode"). The
last line is a JSON summary per tree. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS, SEQ, LR, KET_RANK = 2048, 256, 1e-3, 8
# the decode step: 8 slots of a 512-position cache after 128-token prompts
BATCH, PROMPT, MAX_LEN = 8, 128, 512
# the kernels of csrc/kron_logits.cu and csrc/kron_gather.cu, by name
CE_KEYS = ("ce_fwd_kernel", "ce_fwd_tc_kernel", "ce_combine", "ce_bwd", "prep_f2",
           "transpose_x_kernel", "df2_reduce", "dx_reduce", "sum_parts_kernel")
GATHER_KEYS = ("kron_gather2", "transpose_factors")
METRICS = ("wall_ms", "device_ms", "flash_ms", "ce_ms", "gather_ms")


def child(root: str, steps: int) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.kernels import build
    from repro_torch.models import model as MD
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig, make_train_step, with_params

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    build.build_all([p[:-3] for p in os.listdir(build.CSRC) if p.endswith(".cu")])

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    def is_ce(key):  # kron_matmul's kron_sum_parts_kernel is not one of them
        return any(k in key for k in CE_KEYS) and "kron_sum_parts" not in key

    def summary(prof, walls):
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
        return {"wall_ms": statistics.median(walls[1:]), "walls_ms": walls[1:],
                "device_ms": sum(dev_ms(e) for e in kernels),
                "flash_ms": sum(dev_ms(e) for e in kernels if "flash_fwd" in e.key),
                "ce_ms": sum(dev_ms(e) for e in kernels if is_ce(e.key)),
                "gather_ms": sum(dev_ms(e) for e in kernels
                                 if any(k in e.key for k in GATHER_KEYS))}

    out = {}
    for kind, cfg in (("dense", get_config("qwen3-1.7b")),
                      ("ket", get_config("qwen3-1.7b", linear_kind="ket",
                                         linear_rank=KET_RANK))):
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=TOKENS // SEQ,
                          seed=0)
        state = with_params(MD.init_params(cfg, seed=0, device=dev))
        step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=LR)))
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in batch_at(dcfg, i).items()}
                   for i in range(steps + 1)]
        walls = []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i])
            float(metrics["loss"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, batches[steps])
            torch.cuda.synchronize()
        out[kind] = summary(prof, walls)
        del state, step, batches
        torch.cuda.empty_cache()
    cfg = get_config("qwen3-1.7b")
    params = MD.init_params(cfg, seed=0, device=dev)
    chunk = cfg.prefill_chunk
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev, dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(2))
    lens = torch.full((BATCH,), chunk, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        cache = MD.init_cache(cfg, BATCH, MAX_LEN, device=dev)
        for c0 in range(0, PROMPT, chunk):
            logits, cache = MD.prefill_chunk_fn(params, cfg, cache, prompts[:, c0:c0 + chunk],
                                                lens)
        tok = logits.argmax(-1).to(torch.int32)
        walls = []
        for i in range(4 * steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = MD.serve_step_fn(params, cfg, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            MD.serve_step_fn(params, cfg, cache, tok)
            torch.cuda.synchronize()
    out["decode"] = summary(prof, walls)
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.other, args.steps)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    other = os.path.abspath(args.other)
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            root = other if name == "other" else THIS
            res = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--child",
                                  "--steps", str(args.steps)], capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"run on {root} failed:\n{res.stdout[-2000:]}"
                                 f"{res.stderr[-4000:]}")
            r = json.loads(res.stdout.strip().splitlines()[-1])
            runs[name].append(r)
            print(f"{name:5s} " + "  ".join(
                f"{k}: wall {v['wall_ms']:.1f} ms (steps "
                f"{', '.join(f'{w:.1f}' for w in v['walls_ms'])}), device "
                f"{v['device_ms']:.1f} ms, flash {v['flash_ms']:.3f} ms, CE "
                f"{v['ce_ms']:.2f} ms, kron_gather {v['gather_ms']:.3f} ms"
                for k, v in r.items()), flush=True)
    print(card)
    print(json.dumps({name: {k: {m: statistics.median(r[k][m] for r in rs) for m in METRICS}
                             for k in ("dense", "ket", "decode")}
                      for name, rs in runs.items()}))


if __name__ == "__main__":
    main()
