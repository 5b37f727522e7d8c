"""A run's whole path at small sizes on the CPU (the harness's look for a
card skipped): the corpus from the seed, set-up, the traffic, the check and
the metrics; with each fault a cell can have put under the timed path,
`correct` comes out false; and the run's process holds no jax, jaxlib,
flax or j40_tpu."""

import json
import subprocess
import sys
import time

import pytest

from jxlbench import faults, run, spec

BENCH = spec.load_benchmark()
SMALL = {
    "lossless_e3.tiles512_c4": {"image": {"height": 64, "width": 300}, "corpus": 2,
                                "entry_args": {"backend": "torch"}},
}
FAULTS = {"altered": faults.altered, "stale": faults.stale}
CASES = [(c, f) for c in SMALL for f in [None, *FAULTS]]


def small_run(cell_name, fault=None, seconds=1.5):
    ov = SMALL[cell_name]
    cell = spec.load_cell(BENCH, cell_name, overrides=ov)
    return run.run_cell(cell, 2**31 + 41, seconds, False, device="cpu",
                        t_start=time.perf_counter(), overrides=ov,
                        fault=FAULTS[fault] if fault else None, out=sys.stderr)


def test_every_cell_is_covered():
    assert set(SMALL) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell,fault", CASES)
def test_run_and_its_faults(cell, fault):
    res = small_run(cell, fault)
    assert res["checks"]["answers_compared"]["value"] > 0
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and "mpix_s" in res["metrics"]


def test_the_run_holds_no_jax(tmp_path):
    code = (
        "import sys, time, json\n"
        "from jxlbench import run, spec\n"
        f"ov = {SMALL['lossless_e3.tiles512_c4']!r}\n"
        "cell = spec.load_cell(spec.load_benchmark(), 'lossless_e3.tiles512_c4', overrides=ov)\n"
        "run.run_cell(cell, 3, 0.5, False, device='cpu', t_start=time.perf_counter(),"
        " overrides=ov, out=sys.stderr)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "j40_tpu_torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_a_machine_without_the_card_gets_no_result():
    out = subprocess.run([sys.executable, "-m", "jxlbench.run", "--workload",
                          "lossless_e3.tiles512_c4", "--seed", "1", "--seconds", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_loop_is_found_by_its_name():
    from jxlbench import traffic

    reqs, t0, t1 = traffic.drive(lambda i: (i, {}), {"loop": "closed", "clients": 3}, 6, 0.2,
                                 lambda r: False)
    assert {r.client for r in reqs} == {0, 1, 2} and all(r.ok for r in reqs)
    assert {r.item for r in reqs if r.seq == 0} == {0, 2, 4}
    assert all(r.item == (2 * r.client + r.seq) % 6 for r in reqs)
    assert all(t0 <= r.due < t1 and r.due <= r.end for r in reqs)
    with pytest.raises(FileNotFoundError):
        traffic.drive(lambda i: (i, {}), {"loop": "no_such_loop"}, 6, 0.1, lambda r: False)
