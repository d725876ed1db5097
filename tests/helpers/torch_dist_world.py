"""A gloo world of CPU ranks for the port's sharded-scan tests.

:class:`DistWorld` starts ``n`` processes of
``tests/helpers/torch_dist_worker.py``, each one rank of a gloo default
group (one torch thread each, the rendezvous a ``FileStore`` in a test's
temporary directory, so parallel test workers never share a port), and
sends every rank the same command; :meth:`DistWorld.run` returns each
rank's answer or raises, with the ranks' output, when one fails or a
command outlasts its time limit. A failed world is closed (its group
may be out of step), and the next command starts a new one.

No JAX is imported here or in the ranks.
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MARK = "@@RANK-RESULT "


class RankFailure(AssertionError):
    """A command failed on some rank, or did not finish in time."""


class DistWorld:
    def __init__(self, n: int, tmpdir, group_timeout_s: float = 60.0):
        self.n = n
        self.tmpdir = Path(tmpdir)
        self.group_timeout_s = group_timeout_s
        self.procs = []
        self._queues = []
        self._starts = 0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._starts += 1
        store = self.tmpdir / f"store-{self.n}-{self._starts}"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs, self._queues = [], []
        for rank in range(self.n):
            err = open(self.tmpdir / f"rank-{self.n}-{self._starts}-{rank}"
                                     ".err", "w")
            p = subprocess.Popen(
                [sys.executable, "-m", "tests.helpers.torch_dist_worker",
                 str(rank), str(self.n), str(store),
                 str(self.group_timeout_s)],
                cwd=ROOT, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True, bufsize=1)
            p._err_path = err.name
            err.close()
            q = queue.Queue()
            threading.Thread(target=self._pump, args=(p.stdout, q),
                             daemon=True).start()
            self.procs.append(p)
            self._queues.append(q)

    @staticmethod
    def _pump(stream, q) -> None:
        for line in stream:
            if line.startswith(MARK):
                q.put(json.loads(line[len(MARK):]))
        q.put(None)   # the rank's output ended

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.write(json.dumps({"op": "exit"}) + "\n")
                    p.stdin.flush()
                except OSError:
                    pass
        deadline = time.monotonic() + 10
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs, self._queues = [], []

    def _stderr(self) -> str:
        out = []
        for rank, p in enumerate(self.procs):
            try:
                tail = Path(p._err_path).read_text()[-3000:]
            except OSError:
                tail = ""
            out.append(f"--- rank {rank} stderr ---\n{tail}")
        return "\n".join(out)

    # -- commands ----------------------------------------------------------------

    def run(self, op: str, timeout: float, **args):
        """Send ``op`` to every rank and wait at most ``timeout`` seconds
        for all answers. Returns the ranks' ``out`` values in rank
        order."""
        if not self.procs or any(p.poll() is not None for p in self.procs):
            self.close()
            self.start()
        line = json.dumps({"op": op, "args": args}) + "\n"
        for p in self.procs:
            p.stdin.write(line)
            p.stdin.flush()
        deadline = time.monotonic() + timeout
        answers = []
        for rank, q in enumerate(self._queues):
            try:
                ans = q.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                ans = {"ok": False, "error": f"no answer in {timeout} s"}
            if ans is None:
                ans = {"ok": False, "error": "the rank exited"}
            answers.append(ans)
        bad = [(r, a["error"]) for r, a in enumerate(answers) if not a["ok"]]
        if bad:
            detail = "\n".join(f"--- rank {r} ---\n{e}" for r, e in bad)
            stderr = self._stderr()
            self.close()
            self.procs = []
            raise RankFailure(f"{op}{args} failed on ranks "
                              f"{[r for r, _ in bad]}:\n{detail}\n{stderr}")
        return [a["out"] for a in answers]
