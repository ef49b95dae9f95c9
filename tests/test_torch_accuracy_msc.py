"""tests/test_accuracy.py's fs-msc-max degradation curve on the port
(device "cpu": the plain PyTorch versions of its kernels), on
test_torch_accuracy.py's bundle: capping the similarity of the
references a family may hold must degrade the realignment gracefully,
within the reference's own bounds and avg_idty windows
(accuracy_kmer.test:70-95)."""

import pytest

from test_torch_accuracy import _one_torch_thread, bundle, run  # noqa: F401

# tests/test_accuracy.py:133-137, verbatim
MSC_BARS = [
    (0.9, 0.99, 0.001, 0.88, 0.90),
    (0.8, 0.97, 0.002, 0.78, 0.80),
    (0.7, 0.95, 0.010, 0.68, 0.70),
]


@pytest.mark.parametrize("cap,sps_min,cpm_max,idty_lo,idty_hi", MSC_BARS)
def test_realign_msc_capped(bundle, cap, sps_min, cpm_max, idty_lo, idty_hi):
    r = run(bundle, realign=True, fs_leave_query_out=True, fs_msc_max=cap, engine="graph")
    assert r["n_aligned"] == 48
    assert r["avg_sps"] > sps_min, r
    assert r["avg_cpm"] < cpm_max, r
    assert idty_lo < r["avg_idty"] < idty_hi, r
