#!/usr/bin/env python3
"""How close the fused-CE backward on the card comes to a float64 backward.

    python3 tools/ce_bwd_accuracy.py [--tokens 1 65 2048] [--seeds 10] [--fwd-route ROUTE]

For the qwen3-1.7b head (rank 32, q (64, 32), t (390, 390), vocab 151,936)
and each token count, draws ``--seeds`` seeded inputs (factors, h of width
2,048, labels, g = (U + 0.5) / N) and runs the CUDA forward (on
``--fwd-route``, by default the one ``ops.fwd_route`` picks: its (m, l)
feed the backward and the references), then the CUDA
backward (``ops.kron_ce_bwd_cuda``, on the route ``ops.bwd_route`` picks),
the plain version in fp32 and the plain version in float64. It prints, per
draw, the backward's device time and for dh, dF1 and dF2 the kernel's
error against float64 over the card tests' limit, max(4 x the fp32 plain
version's error, 1e-5 x max|float64|) (under 1 passes), and over the plain
version's error. The last line is a JSON summary. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, nargs="+", default=[1, 65, 2048])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--fwd-route", choices=("kron_ce_fwd_tc", "kron_ce_fwd_simt"),
                    default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels.kron_logits import ops as CE

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rank, q, t, vocab, width = 32, (64, 32), (390, 390), 151936, 2048
    worst = {}
    for n in args.tokens:
        for seed in range(1, args.seeds + 1):
            gen = torch.Generator(device=dev).manual_seed(seed)
            f = [torch.randn((rank, qj, tj), generator=gen, device=dev) * 0.3
                 for qj, tj in zip(q, t)]
            h = torch.randn((n, width), generator=gen, device=dev)
            y = torch.randint(0, vocab, (n,), generator=gen, device=dev, dtype=torch.int32)
            _, m, l = CE.kron_ce_fwd_cuda(f, h, y, vocab, route=args.fwd_route)
            g = (torch.rand(n, generator=gen, device=dev) + 0.5) / n
            dfs, dh = CE.kron_ce_bwd_cuda(f, h, y, m, l, g, vocab)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            CE.kron_ce_bwd_cuda(f, h, y, m, l, g, vocab)
            end.record()
            torch.cuda.synchronize()
            plain_dfs, plain_dh = CE.kron_ce_bwd_ref(f, h, y, m, l, g, vocab, 4)
            exact_dfs, exact_dh = CE.kron_ce_bwd_ref([a.double() for a in f], h.double(), y,
                                                     m.double(), l.double(), g.double(), vocab, 4)
            cols = []
            for name, a, b, e in zip(("dh", "dF1", "dF2"), (dh, *dfs), (plain_dh, *plain_dfs),
                                     (exact_dh, *exact_dfs)):
                err_k = (a.double() - e).abs().max().item()
                err_p = (b.double() - e).abs().max().item()
                limit = max(4 * err_p, 1e-5 * e.abs().max().item())
                worst[n] = max(worst.get(n, 0.0), err_k / limit)
                cols.append(f"{name} {err_k / limit:.2f} of the limit, {err_k / err_p:.2f}x plain")
            print(f"N {n} seed {seed}: {start.elapsed_time(end):.2f} ms; " + "; ".join(cols),
                  flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "fwd_route": args.fwd_route or CE.fwd_route(rank, *q, t[1]),
                      "worst_of_limit": {str(n): v for n, v in worst.items()}}))


if __name__ == "__main__":
    main()
