"""Training launcher of the port (torch port of ``repro.launch.train``, one
device, no mesh, no checkpoints).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 100 --batch 8 --seq 256 [--smoke] [--device cpu] \
        [--linear ket --linear-rank 8]

Trains the config with its word2ketXS embedding and Kronecker head (and,
with ``--linear ket``, its attention and FFN projections stored as rank-r
Kronecker factor stacks) on the seeded synthetic Markov corpus with AdamW under the cosine schedule, and
prints one ``[train] …`` line. Exit codes: 0 complete, 1 failed (reason
printed), 2 stopped by a preemption signal.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainConfig

    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="use the reduced config")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--linear", default=None, choices=[None, "dense", "ket"],
                   help="store FFN/attention projections as ket Kronecker factors")
    p.add_argument("--linear-rank", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    overrides = {}
    if args.linear:
        overrides["linear_kind"] = args.linear
    if args.linear_rank is not None:
        overrides["linear_rank"] = args.linear_rank
    device = resolve_device(args.device)
    cfg = (get_smoke if args.smoke else get_config)(args.arch, **overrides)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr,
                              schedule=cosine_schedule(args.lr, args.warmup, args.steps)),
        microbatches=args.microbatches,
    )
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    lcfg = LoopConfig(total_steps=args.steps, seed=args.seed)
    out = train_loop(cfg, tcfg, dcfg, lcfg, device=device)
    p50 = out.get("step_p50_s")
    print(f"[train] {cfg.name} on {device}: final step {out['final_step']} loss "
          f"{out['final_loss']:.4f} (first {out['first_loss']:.4f})"
          + (f", step p50 {p50 * 1e3:.0f} ms" if p50 is not None else ""))
    if out["skipped_steps"] or out["rollbacks"]:
        print(f"[train] fault summary: skipped {out['skipped_steps']} "
              f"rollbacks {out['rollbacks']}")
    if out["failed"]:
        print(f"[train] FAILED: {out['fail_reason']}")
        return 1
    if out["preempted"]:
        print("[train] preempted; no checkpoint is written (not ported)")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
