"""B6_overlap_pct on made-up slices with known answers: launches one after
another, two that overlap in full, two that overlap in part beside a
copy, and a slice without a B6 record or without a slice."""

from types import SimpleNamespace

import pytest

from jxlbench import spec
from jxlbench.trace import Slice

READER = spec.load_module(spec.PKG / "metrics" / "B6_overlap_pct.py")
B6 = "tokens_serial_kernel<true>"


def read(device):
    return READER.read(SimpleNamespace(slice=Slice(0.0, 1.0, device=device)))


def test_launches_in_sequence_read_0():
    assert read([("tokens_serial_setup<true>", 0.0, 0.01), (B6, 0.01, 0.2),
                 (B6, 0.2, 0.4), (B6, 0.5, 0.6)]) == 0.0


def test_two_launches_overlapping_in_full_read_50():
    assert read([(B6, 0.1, 0.3), (B6, 0.1, 0.3)]) == pytest.approx(50.0)


def test_a_partial_overlap_counts_only_b6():
    # 0.1-0.3 and 0.2-0.4: 0.4 summed, 0.3 of union; the copy is not B6
    got = read([(B6, 0.1, 0.3), ("Memcpy DtoH (Device -> Pageable)", 0.0, 0.5),
                (B6, 0.2, 0.4)])
    assert got == pytest.approx(25.0)


def test_no_b6_record_reads_none():
    assert read([("wp_wavefront_kernel<2>", 0.1, 0.2)]) is None
    assert read([(B6, 1.5, 1.7)]) is None  # starts after the slice
    assert READER.read(SimpleNamespace(slice=None)) is None
