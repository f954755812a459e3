"""The tensor-core route of the fused-CE backward, on the CPU.

``csrc/kron_logits.cu``'s ``ce_bwd_tc_kernel`` runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version there). Here:

* the static route (``bwd_route``), the chunking of kz (``tc_chunks``) and
  the split count of its 64-token blocks (``bwd_vocab_splits``), from the
  shape alone;
* why 3xTF32: the backward's three stage-2-sized products (logits = z F2,
  dF2 = z^T dlogit, dz = dlogit F2^T) emulated with tf32 operands (round to
  nearest, 10 mantissa bits, as ``cvt.rna.tf32.f32``) and fp32 sums, at the
  card tests' small heads. The card tests hold the kernel to a float64
  backward within max(4 x the fp32 plain version's error, 1e-5 max|exact|).
  The 3xTF32 split (hi.hi + hi.lo + lo.hi) meets that on dh, dF1 and dF2;
  one TF32 pass (hi.hi) misses it on at least one of them.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.kron_logits import ops as CE

torch.set_num_threads(2)


def test_bwd_vocab_splits_fill_the_card_with_64_token_blocks():
    # 2,048 tokens = 32 blocks of 64 on 132 SMs: four splits fill one wave
    assert CE.bwd_vocab_splits(2048, 390, 132) == 4
    assert CE.bwd_vocab_splits(2047, 390, 132) == 4
    assert CE.bwd_vocab_splits(2049, 390, 132) == 4  # 33 blocks
    assert CE.bwd_vocab_splits(2113, 390, 132) == 3  # 34 blocks
    assert CE.bwd_vocab_splits(1, 390, 132) == 132
    assert CE.bwd_vocab_splits(8192, 390, 132) == 1
    assert CE.bwd_vocab_splits(37, 32, 132) == 32


def test_bwd_route_by_shape():
    # qwen3-1.7b's head: two j of all 32 ranks per 64-row chunk
    assert CE.tc_chunks(32, 64, 32) == (2, 32)
    assert CE.bwd_route(32, 64, 32, 390) == "kron_ce_bwd_tc"
    # the card tests' small heads
    assert CE.tc_chunks(2, 8, 8) == (8, 2)
    assert CE.tc_chunks(3, 8, 4) == (4, 3)
    assert CE.bwd_route(2, 8, 8, 32) == CE.bwd_route(3, 8, 4, 13) == "kron_ce_bwd_tc"
    # more than 64 ranks: one j a chunk, k in chunks of 64
    assert CE.tc_chunks(100, 16, 8) == (1, 64)
    assert CE.bwd_route(100, 16, 8, 416) == "kron_ce_bwd_tc"
    # an x slice of one j past 8,192 floats, or an F1 column past shared memory
    assert CE.tc_chunks(2, 130, 8) is None
    assert CE.bwd_route(2, 130, 8, 32) == "kron_ce_bwd_simt"
    assert CE.bwd_route(1024, 8, 1, 416) == "kron_ce_bwd_simt"


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 to nearest, ties away from zero (cvt.rna)."""
    bits = (a.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _mm_fp32(a, b):
    return a @ b


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _emulated_bwd(factors, x, y, m, l, g, vocab, mm):
    """The fused backward of an order-2 head with ``mm`` for its three
    stage-2-sized products (batched over the t1 columns); the rest in the
    inputs' dtype."""
    f1, f2 = factors
    r, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    B = x.shape[0]
    xr = x.reshape(B, q1, q2)
    z = torch.einsum("bij,kic->cbkj", xr, f1).reshape(t1, B, r * q2)
    f2m = f2.reshape(r * q2, t2)
    logits = mm(z, f2m)  # (t1, B, t2)
    cols = torch.arange(t1)[:, None] * t2 + torch.arange(t2)[None, :]  # (t1, t2)
    p = torch.exp(logits - m[None, :, None]) / l[None, :, None]
    p = torch.where(cols[:, None, :] < vocab, p, torch.zeros((), dtype=p.dtype))
    onehot = (cols[:, None, :] == y[None, :, None]).to(p.dtype)
    dl = g[None, :, None] * (p - onehot)
    df2 = mm(z.transpose(1, 2), dl).sum(0).reshape(r, q2, t2)
    dz = mm(dl, f2m.T).reshape(t1, B, r, q2)
    dx = torch.einsum("kic,cbkj->bij", f1, dz).reshape(B, q1 * q2)
    df1 = torch.einsum("bij,cbkj->kic", xr, dz)
    return [df1, df2], dx


# (rank, q, t, vocab, N, h width): the card tests' small heads (CE_CASES)
SMALL = [(2, (8, 8), (32, 32), 1000, 37, 64), (3, (8, 4), (17, 13), 200, 70, 30)]


@pytest.mark.parametrize("rank,q,t,vocab,n,width", SMALL)
def test_3xtf32_meets_the_float64_criterion_and_one_pass_does_not(rank, q, t, vocab, n,
                                                                  width):
    rng = np.random.default_rng(1)
    factors = [torch.from_numpy((rng.standard_normal((rank, qj, tj)) * 0.3)
                                .astype(np.float32)) for qj, tj in zip(q, t)]
    P = math.prod(q)
    h = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32))
    x = torch.nn.functional.pad(h, (0, P - width))
    y = torch.from_numpy(rng.integers(0, vocab, n).astype(np.int32))
    y[0], y[-1] = 0, vocab - 1
    g = torch.from_numpy(((rng.random(n) + 0.5) / n).astype(np.float32))
    _, m, l = CE.kron_ce_fwd_ref([f.double() for f in factors], h.double(), y, vocab, 4)
    exact_dfs, exact_dh = CE.kron_ce_bwd_ref([f.double() for f in factors], h.double(), y, m,
                                             l, g.double(), vocab, 4)
    m, l = m.float(), l.float()
    plain_dfs, plain_dh = CE.kron_ce_bwd_ref(factors, h, y, m, l, g, vocab, 4)
    exact = [exact_dh, *exact_dfs]
    limits = [max(4 * (b.double() - e).abs().max().item(), 1e-5 * e.abs().max().item())
              for b, e in zip([plain_dh, *plain_dfs], exact)]

    def errors(mm):
        dfs, dx = _emulated_bwd(factors, x, y.long(), m, l, g, vocab, mm)
        return [(a.double() - e).abs().max().item()
                for a, e in zip([dx[:, :width], *dfs], exact)]

    # the emulation itself, in fp32, is the plain version's arithmetic
    assert all(e <= lim for e, lim in zip(errors(_mm_fp32), limits))
    assert all(e <= lim for e, lim in zip(errors(_mm_3xtf32), limits))
    assert any(e > lim for e, lim in zip(errors(_mm_1xtf32), limits))
