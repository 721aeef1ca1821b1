"""The gloo worker ranks of the partition tests, started and collected.

``start`` spawns every rank of a (pod, data, model) mesh at once, each
writing its log to a file beside its output (a pipe the test does not
drain could fill and stall a chatty rank). ``Ranks.outputs`` waits for the
whole group together: it returns each rank's saved arrays once every rank
has exited 0, and otherwise ends the group, since a rank that dies leaves
its peers blocked in a collective, and fails with each rank's return code
and the tail of its log. A failure is kept: every later call fails at
once with the same report, not after another wait. ``Ranks.close`` ends
what still runs (the fixtures' teardown).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 600.0
TAIL = 3000


class Ranks:
    def __init__(self, dims, tmp: Path, procs, logs):
        self.dims, self.tmp, self.procs, self.logs = dims, tmp, procs, logs
        self._outputs = None
        self._failure = None

    def _report(self, codes, why: str) -> str:
        lines = [f"mesh {self.dims}: {why}"]
        for r, (code, log) in enumerate(zip(codes, self.logs)):
            text = Path(log).read_text(errors="replace")
            lines.append(f"--- rank {r}: return code {code}; the last "
                         f"{min(len(text), TAIL)} characters of its log:\n"
                         + text[-TAIL:])
        return "\n".join(lines)

    def outputs(self, deadline_s: float = DEADLINE_S):
        """Each rank's saved arrays (a dict a rank), once every rank has
        exited 0; else fail (pytest.fail) with every rank's return code
        and log tail, the group ended."""
        if self._outputs is None and self._failure is None:
            end = time.monotonic() + deadline_s
            while True:
                codes = [p.poll() for p in self.procs]
                if all(c == 0 for c in codes):
                    self._outputs = [dict(np.load(self.tmp / f"rank{r}.npz"))
                                     for r in range(len(self.procs))]
                    break
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed or time.monotonic() > end:
                    self.close()
                    why = (f"rank(s) {failed} exited with an error"
                           if failed else
                           f"not done after {deadline_s:.0f} s")
                    self._failure = self._report(
                        [p.returncode for p in self.procs],
                        why + "; the group was ended (a negative return "
                        "code is the signal that ended the rank)")
                    break
                time.sleep(0.2)
        if self._failure is not None:
            pytest.fail(self._failure, pytrace=False)
        return self._outputs

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def start(worker: Path, dims, tmp: Path, middle=(), tail=()) -> Ranks:
    """Every rank of mesh ``dims`` running ``worker RANK WORLD P,D,M STORE
    *middle OUT *tail`` (``OUT`` its ``rank<r>.npz`` in ``tmp``), with one
    intra-op thread and the port on the path."""
    world = int(np.prod(dims))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    tmp.mkdir()
    procs, logs = [], []
    for r in range(world):
        log = tmp / f"rank{r}.log"
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(r), str(world),
                 ",".join(map(str, dims)), str(tmp / "store"),
                 *map(str, middle), str(tmp / f"rank{r}.npz"),
                 *map(str, tail)],
                env=env, stdout=fh, stderr=subprocess.STDOUT, text=True))
        logs.append(log)
    return Ranks(dims, tmp, procs, logs)
