"""The decode's CUDA streams (`j40_tpu_torch/streams.py`).

On the CPU: a decode there takes no stream and its `request` span counts
stream 0; a thread keeps one stream a device and two threads have two
(`torch.cuda.Stream` replaced by a stand-in, so no card is needed); a
worker carries its caller's stream; a device cache shares every read, and
a CPU tensor is left as it is.  On a card (marked `cuda`): four threads decode lossless e3 tiles and
VarDCT images at once, each on its own stream, from emptied device caches,
bit-equal to a decode on one thread.
"""

import threading
from collections import deque

import numpy as np
import pytest
import torch

from j40_tpu_torch import streams as S
from j40_tpu_torch.decode import decode_animation, decode_file
from j40_tpu_torch.encode.vardct_enc import (
    VarDCTOptions, encode_vardct, encode_vardct_animation,
)

NAME, COUNTS = 0, 5


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        96 + 60 * np.sin(xx / 29) * np.cos(yy / 23) + 10 * np.sin(xx / (9 + 2 * c))
        + rng.normal(0, 0.7, (h, w)) for c in range(3)], -1).clip(0, 255).astype(np.uint8)


def _streams_of(dec):
    return [s[COUNTS]["stream"] for s in dec.stats["spans"] if s[NAME] == "request"]


class _FakeStream:
    """A stand-in for torch.cuda.Stream: which device it was made for."""

    def __init__(self, device):
        self.device = device


@pytest.fixture
def no_stream(monkeypatch):
    """Make any stream a failure."""
    def refuse(*a, **kw):
        raise AssertionError("a stream was made")

    monkeypatch.setattr(torch.cuda, "Stream", refuse)


@pytest.fixture
def fake_streams(monkeypatch):
    """torch.cuda.Stream and torch.cuda.stream stood in for, and the
    threads' streams kept apart from every other test's: each
    `torch.cuda.stream(s)` block appends `s` to the list while it runs."""
    entered: list = []
    monkeypatch.setattr(S, "_LOCAL", threading.local())

    class _Enter:
        def __init__(self, s):
            self.s = s

        def __enter__(self):
            entered.append(self.s)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", _Enter)
    return entered


def test_a_cpu_decode_takes_no_stream(no_stream):
    data = encode_vardct(_photo(40, 72, 1))
    dec, rgba = decode_file(data, backend="torch", device="cpu")
    assert rgba.shape == (40, 72, 4)
    assert _streams_of(dec) == [0]
    host, _ = decode_file(data, backend="numpy")
    assert _streams_of(host) == [0]


def test_a_cpu_animation_takes_no_stream(no_stream):
    data = encode_vardct_animation([(_photo(24, 40, s), 1) for s in (1, 2)])
    dec, frames = decode_animation(data, backend="torch", device="cpu")
    assert len(frames) == 2
    assert _streams_of(dec) == [0]


def test_a_thread_keeps_its_stream_and_threads_have_their_own(fake_streams):
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    s0, i0 = S.thread_stream(cuda0)
    assert S.thread_stream(cuda0) == (s0, i0) and s0.device == cuda0
    s1, i1 = S.thread_stream(cuda1)
    assert s1 is not s0 and s1.device == cuda1 and i1 > i0 > 0
    got: dict = {}

    def other():
        got["first"] = S.thread_stream(cuda0)
        got["again"] = S.thread_stream(cuda0)

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert got["first"] == got["again"]
    assert got["first"][0] is not s0 and got["first"][1] > i1
    assert S.thread_stream(cuda0) == (s0, i0)


def test_own_stream_enters_the_threads_stream(fake_streams):
    cuda0 = torch.device("cuda", 0)
    s, i = S.thread_stream(cuda0)
    with S.own_stream(cuda0) as index:
        assert index == i and fake_streams == [s]
    with S.own_stream(torch.device("cpu")) as index, S.own_stream(None) as none:
        assert index == none == 0
    assert fake_streams == [s]


def test_a_worker_carries_its_callers_stream(fake_streams, monkeypatch):
    caller = object()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: caller)
    ran = []

    def work(x):
        ran.append((x, list(fake_streams)))
        return 2 * x

    fn = S.carry(work, torch.device("cuda", 0))
    out: list = []
    th = threading.Thread(target=lambda: out.append(fn(21)))
    th.start()
    th.join()
    assert out == [42] and ran == [(21, [caller])]
    assert S.carry(work, torch.device("cpu")) is work and S.carry(work, None) is work


def test_a_cpu_tensor_is_shared_as_it_is():
    t = torch.arange(4)
    assert S.shared(t) is t


def test_a_device_cache_shares_every_read(monkeypatch):
    made, read = [], []
    monkeypatch.setattr(S, "shared", lambda t: read.append(t) or t)

    @S.device_cache(maxsize=2)
    def table(n):
        made.append(n)
        return torch.arange(n)

    a = table(3)
    assert table(3) is a and made == [3] and read == [a, a]
    table.cache_clear()
    assert table(3) is not a and made == [3, 3]


# ------------------------------------------------------------------ on a card

#: kWPFixedDC's cutoffs of the weighted predictor's max-error property, as
#: libjxl's MakeFixedTree splits them for cjxl -d 0 -e 3
WP_CUTOFFS = (-500, -392, -255, -191, -127, -95, -63, -47, -31, -23, -15, -11, -7, -4, -3, -1,
              0, 1, 3, 5, 7, 11, 15, 23, 31, 47, 63, 95, 127, 191, 255, 392, 500)


def _e3_tree():
    """The 67-node fixed tree: the median cutoff of property 15 splits, the
    upper half left, breadth first; every leaf the weighted predictor."""
    from j40_tpu_torch.encode.modular_enc import branch, leaf

    tree = [leaf(6)]
    todo = deque([(0, len(WP_CUTOFFS), 0)])
    while todo:
        begin, end, pos = todo.popleft()
        if begin >= end:
            continue
        mid = (begin + end) // 2
        n = len(tree)
        tree[pos] = branch(15, WP_CUTOFFS[mid], n, n + 1)
        todo.append((mid + 1, end, n))
        todo.append((begin, mid, n + 1))
        tree += [leaf(6), leaf(6)]
    return tree


def _e3(seed):
    """A lossless e3 tile: YCoCg, the fixed tree, one global rANS code."""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced

    return encode_modular_advanced(_photo(160, 320, seed), options=AdvancedOptions(
        tree=_e3_tree(), use_prefix=False, global_tree=True, rct_type=6))


def _clear_device_caches():
    from j40_tpu_torch.ops import combine, reconstruct, wavefront_kernels

    wavefront_kernels._device_tree.cache_clear()
    combine._DEVICE_CACHE.clear()
    combine._special_on.cache_clear()
    reconstruct._matrix.cache_clear()
    reconstruct._llf_scales.cache_clear()


@pytest.mark.cuda
def test_four_threads_decode_on_their_own_streams():
    """Four threads, three decodes each, at once: lossless e3 tiles on the
    device route, a VarDCT image on it, and a VarDCT image of two LF groups
    on the torch route with two workers (its groups' reconstructions
    dispatched from the pool's threads, which carry the decode's stream);
    the device caches emptied first, so their first fills race.  Each
    answer is bit-equal to the decode of the same image on one thread, and
    each thread's requests count one stream, another than every other
    thread's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device("cuda")
    assert len(_e3_tree()) == 67
    jobs = [(_e3(seed), "device", 1) for seed in range(4)]
    jobs.append((encode_vardct(_photo(96, 160, 9)), "device", 1))
    jobs.append((encode_vardct(_photo(32, 2112, 10)), "torch", 2))
    want = [decode_file(d, backend=b, device=cuda, workers=w)[1] for d, b, w in jobs]
    plan = [[i, 4 + i % 2, (i + 1) % 4] for i in range(4)]
    _clear_device_caches()
    got: dict = {}
    barrier = threading.Barrier(4)

    def client(t):
        barrier.wait()
        got[t] = [(j, decode_file(jobs[j][0], backend=jobs[j][1], device=cuda,
                                  workers=jobs[j][2])) for j in plan[t]]

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads) and len(got) == 4
    mine = []
    for t in range(4):
        seen = set()
        for j, (dec, rgba) in got[t]:
            np.testing.assert_array_equal(rgba, want[j])
            seen.update(_streams_of(dec))
        assert len(seen) == 1 and 0 not in seen, seen
        mine += seen
    assert len(set(mine)) == 4
