"""The inputs of a run, made from the seed.

    python -m jxlbench.corpus --cell CELL --seed N --index I --out PATH [--overrides JSON]

makes item I of a cell's corpus: the image from the configuration's
generator (images/<kind>.py), encoded by the configuration's module
(configs/<config>.py, on the frozen encoder), written to PATH.  A run makes
its items in such processes, all at once, into jxlbench/.cache/, keyed by
configuration, cell, seed and a hash of every file that shapes the bytes;
an item already there is read back.  Processes, not a multiprocessing pool:
a pool puts its semaphores in /dev/shm."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from jxlbench import spec

CACHE = spec.PKG / ".cache"


@dataclass
class Item:
    index: int
    data: bytes
    facts: dict


def image(cell: spec.Cell, seed: int, index: int):
    gen = spec.load_module(spec.PKG / "images" / f"{cell.config['image']}.py")
    return gen.make(cell.height, cell.width, seed, index)


def _key(cell: spec.Cell) -> str:
    h = hashlib.sha256()
    files = sorted((spec.PKG / "frozen").rglob("*.py")) + [
        spec.PKG / "corpus.py", spec.PKG / "images" / f"{cell.config['image']}.py",
        spec.PKG / "configs" / f"{cell.config_name}.py"]
    for f in files:
        h.update(f.relative_to(spec.PKG).as_posix().encode() + b"\0" + f.read_bytes())
    shaping = {"image": cell.config["image"], "encoder": cell.config.get("encoder"),
               "size": cell.workload["image"], "corpus": cell.workload["corpus"]}
    h.update(json.dumps(shaping, sort_keys=True).encode())
    return h.hexdigest()[:16]


def make(cell: spec.Cell, seed: int, overrides: dict | None = None) -> tuple[list[Item], float]:
    """The cell's corpus for `seed` and the seconds it took."""
    t0 = time.perf_counter()
    d = CACHE / cell.config_name / cell.name / f"{seed}-{_key(cell)}"
    d.mkdir(parents=True, exist_ok=True)
    n = cell.workload["corpus"]
    paths = [d / f"{i}.jxl" for i in range(n)]
    todo = [i for i, p in enumerate(paths) if not p.is_file()]
    procs = []
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    width = max(1, os.cpu_count() or 1)
    for i in todo:
        while len([p for p in procs if p.poll() is None]) >= width:
            time.sleep(0.05)
        cmd = [sys.executable, "-m", "jxlbench.corpus", "--cell", cell.name, "--seed", str(seed),
               "--index", str(i), "--out", str(paths[i])]
        if overrides:
            cmd += ["--overrides", json.dumps(overrides)]
        procs.append(subprocess.Popen(cmd, cwd=spec.ROOT, env=env))
    failed = [p.args for p in procs if p.wait() != 0]
    if failed:
        raise RuntimeError(f"corpus generation failed: {failed}")
    from jxlbench import stream

    items = []
    for i, p in enumerate(paths):
        data = p.read_bytes()
        items.append(Item(i, data, stream.facts(data)))
    return items, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--overrides", default=None)
    a = ap.parse_args(argv)
    cell = spec.cell_files(a.cell, json.loads(a.overrides) if a.overrides else None)
    data = cell.codec.encode(image(cell, a.seed, a.index), cell.config)
    out = Path(a.out)
    tmp = out.with_name(f"{out.name}.part{a.index}")
    tmp.write_bytes(data)
    os.replace(tmp, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
