"""How the serving lookup (``csrc/kron_gather.cu``) is launched, on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py holds every
route and band count to the same bits there). Here, from the id count
alone: the blocks per id (``lookup_bands``, at most 8), which spread a
decode step's few ids over the free SMs of an H100 (132 SMs), and the fp32
leg's
route (``lookup_route``), whose threshold was measured on the card
(``chip_smoke.py``'s kron_gather row: the two routes timed at 8 to 32,768
ids).
"""

import pytest

from repro_torch.kernels.kron_gather import ops as G


@pytest.mark.parametrize("n_ids,bands", [(0, 1), (1, 8), (8, 8), (16, 8), (17, 7), (33, 4),
                                         (66, 2), (67, 1), (128, 1), (2049, 1),
                                         (32768, 1)])
def test_lookup_bands_fill_the_card(n_ids, bands):
    # qwen3-1.7b's embedding: q1 = 64 output rows per id
    assert G.lookup_bands(n_ids, 64, 132) == bands


def test_lookup_bands_leave_no_band_empty():
    for q1 in (1, 5, 17, 64, 96):
        for n in (1, 2, 7, 8, 50, 128, 300):
            bands = G.lookup_bands(n, q1, 132)
            rows = -(-q1 // bands)
            assert 1 <= bands <= min(q1, G.MAX_BANDS)
            assert (bands - 1) * rows < q1


def test_lookup_route_by_id_count():
    # on the card (NVIDIA H100 80GB HBM3, 700 W) the strided route was the
    # faster at 128 ids and the copy route from 256 on
    assert G.LOOKUP_ROWS_FROM == 256
    for n in (1, 8, 128, G.LOOKUP_ROWS_FROM - 1):
        assert G.lookup_route(n) == "strided"
    for n in (G.LOOKUP_ROWS_FROM, 2049, 32768):
        assert G.lookup_route(n) == "rows"
