"""The tensor-core route of the fused-CE forward, on the CPU.

``csrc/kron_logits.cu``'s ``ce_fwd_tc_kernel`` runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version and a float64 forward there). Here:

* the static route (``fwd_route``) from the shape alone, beside the
  backward's, and the shared memory its wrapper checks the kernel against
  (the forward's launch geometry, 64-token blocks over
  ``bwd_vocab_splits`` t1 splits and ``tc_chunks`` kz chunks, is the
  backward's, pinned in tests/test_torch_ce_bwd_tc.py);
* why 3xTF32: the forward's stage-2-sized product (logits = z F2)
  emulated with tf32 operands (round to nearest, 10 mantissa bits, as
  ``cvt.rna.tf32.f32``) and fp32 sums, the online (m, l, label logit)
  taken column by column as the kernel does, at the card tests' small
  heads. The card tests hold the kernel's losses to a float64 forward
  within max(4 x the fp32 plain version's error, 1e-5 max|exact|). The
  3xTF32 split (hi.hi + hi.lo + lo.hi) meets that; one TF32 pass misses it.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.kron_logits import ops as CE

torch.set_num_threads(2)


def test_fwd_route_follows_the_backward_by_shape():
    # qwen3-1.7b's head and the card tests' small heads: the tensor cores
    for shape in ((32, 64, 32, 390), (2, 8, 8, 32), (3, 8, 4, 13), (100, 16, 8, 416)):
        assert CE.bwd_route(*shape) == "kron_ce_bwd_tc"
        assert CE.fwd_route(*shape) == "kron_ce_fwd_tc"
    # an x slice of one j past 8,192 floats, or an F1 column past shared memory
    for shape in ((2, 130, 8, 32), (1024, 8, 1, 416)):
        assert CE.bwd_route(*shape) == "kron_ce_bwd_simt"
        assert CE.fwd_route(*shape) == "kron_ce_fwd_simt"
    assert set(CE.routes) == {"kron_ce_fwd_tc", "kron_ce_fwd_simt", "kron_ce_bwd_tc",
                              "kron_ce_bwd_simt"}


def test_fwd_tc_shared_memory():
    # pass 1's region (178,176 B), the x chunk (32 KB), the F1 column as
    # [q1][rank rounded to 4], 1 KB of per-token statistics, 8 barriers and
    # 1 KB of alignment: under the backward's, and under the 227 KB a block
    # may take
    assert CE._tc_fwd_smem_bytes(32, 64) == 221_248
    assert CE._tc_fwd_smem_bytes(32, 64) < CE._tc_smem_bytes(32, 64) <= 227 * 1024
    assert CE._tc_fwd_smem_bytes(2, 8) == 213_184


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


def _emulated_fwd(factors, x, y, vocab, mm):
    """The fused forward of an order-2 head with ``mm`` for its stage-2
    product (batched over the t1 columns), then the kernel's online
    statistics column by column: ``(loss, m, l)``."""
    f1, f2 = factors
    r, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    B = x.shape[0]
    z = torch.einsum("bij,kic->cbkj", x.reshape(B, q1, q2), f1).reshape(t1, B, r * q2)
    logits = mm(z, f2.reshape(r * q2, t2))  # (t1, B, t2)
    m = torch.full((B,), -1e30)
    l, yl = torch.zeros(B), torch.zeros(B)
    for c in range(t1):
        lg = logits[c]
        valid = (c * t2 + torch.arange(t2)) < vocab
        m_new = torch.maximum(m, torch.where(valid, lg, -1e30).amax(-1))
        l = l * torch.exp(m - m_new) + torch.where(valid, torch.exp(lg - m_new[:, None]),
                                                   0.0).sum(-1)
        m = m_new
        hit = (y >= c * t2) & (y < (c + 1) * t2)
        picked = lg.gather(1, (y - c * t2).clamp(0, t2 - 1)[:, None])[:, 0]
        yl = torch.where(hit, picked, yl)
    return m + torch.log(l) - yl, m, l


# (rank, q, t, vocab, N, h width): the card tests' small heads (CE_CASES),
# one with the vocabulary ending inside a t1 column
SMALL = [(2, (8, 8), (32, 32), 1000, 37, 64), (3, (8, 4), (17, 13), 200, 70, 30)]


@pytest.mark.parametrize("rank,q,t,vocab,n,width", SMALL)
def test_3xtf32_meets_the_float64_loss_criterion_and_one_pass_does_not(rank, q, t, vocab, n,
                                                                       width):
    rng = np.random.default_rng(2)
    factors = [torch.from_numpy((rng.standard_normal((rank, qj, tj)) * 0.3)
                                .astype(np.float32)) for qj, tj in zip(q, t)]
    P = math.prod(q)
    h = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32))
    x = torch.nn.functional.pad(h, (0, P - width))
    y = torch.from_numpy(rng.integers(0, vocab, n).astype(np.int32))
    y[0], y[-1] = 0, vocab - 1
    exact, _, _ = CE.kron_ce_fwd_ref([f.double() for f in factors], h.double(), y, vocab, 4)
    plain, _, _ = CE.kron_ce_fwd_ref(factors, h, y, vocab, 4)
    limit = max(4 * (plain.double() - exact).abs().max().item(),
                1e-5 * exact.abs().max().item())

    def error(mm):
        loss, _, _ = _emulated_fwd(factors, x, y.long(), vocab, mm)
        return (loss.double() - exact).abs().max().item()

    # the emulation itself, in fp32, is the plain version's arithmetic
    assert error(_mm_fp32) <= limit
    assert error(_mm_3xtf32) <= limit
    assert error(_mm_1xtf32) > limit
