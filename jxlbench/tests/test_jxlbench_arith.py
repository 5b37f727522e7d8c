"""The benchmark's arithmetic on made-up intervals, latencies and slices."""

import math

import pytest

from jxlbench import arith
from jxlbench.trace import Slice, short


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert arith.union(iv) == pytest.approx(3.0)
    assert arith.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_quantile_is_a_latency_some_request_had():
    lat = list(range(1, 101))
    assert arith.quantile(lat, 0.95) == 95
    assert arith.quantile(lat + [math.inf], 0.995) == math.inf
    assert arith.quantile([7.0], 0.95) == 7.0


def test_roofline():
    # 3.35e9 bytes take 1 ms at the peak; 67e9 operations take 1 ms
    assert arith.least_seconds(3.35e9, 0) == pytest.approx(1e-3)
    assert arith.least_seconds(3.35e9, 2 * 67e9) == pytest.approx(2e-3)
    assert arith.roofline_pct(3.35e9, 0, 4e-3) == pytest.approx(25.0)


def test_work_counts():
    f = {"group_bytes": 1000, "width": 8, "height": 8}
    assert arith.tokens_work(f) == (1000 + 4 * 3 * 64, 20 * 3 * 64)
    assert arith.wp_tree_work(f, 1) == (8 * 3 * 64, 158 * 3 * 64)


def test_slice_reads_and_loss():
    dev = [("void (anonymous namespace)::tokens_serial_setup<true>(int)", 1.0, 1.001),
           ("void (anonymous namespace)::tokens_serial_kernel<true>(int)", 1.001, 1.02),
           ("Memcpy DtoH (Device -> Pageable)", 1.03, 1.031),
           ("void (anonymous namespace)::tokens_serial_setup<true>(int)", 1.05, 1.051),
           ("void (anonymous namespace)::tokens_serial_kernel<true>(int)", 1.051, 1.07)]
    sl = Slice(t0=1.0, t1=1.1, device=dev, launches={"tokens": 2},
               samples=[(1.025, "j40_tpu_torch.decode:_one"), (1.08, "x:y"), (1.09, "x:y")])
    sl.check()
    assert sl.lost is None
    assert sl.busy() == pytest.approx(0.041)
    assert sl.seconds(("tokens_serial_kernel",)) == pytest.approx(0.038)
    bd = sl.breakdown()
    assert bd["device_ops"][0] == ["tokens_serial_kernel", pytest.approx(0.038)]
    assert bd["idle_gaps"][0] == ["host: x:y", pytest.approx(0.03)]
    sl.launches = {"tokens": 3}
    sl.check()
    assert sl.lost and "2 records of 3" in sl.lost
    assert short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
