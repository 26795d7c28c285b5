"""Run a command as local ranks under ``torchrun`` (``torch.distributed.run``)
for the multi-process tests.

:func:`torchrun` gives the rendezvous a free localhost port, so that tests
running side by side under xdist do not clash, reads each rank's standard
output back from torchrun's log directory, and raises with every rank's
standard error when a rank fails or the time runs out.  torchrun stops the
other ranks when one fails, and stops them all when it is itself stopped.
"""

import glob
import os
import signal
import socket
import subprocess
import sys
import tempfile


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(argv: list[str], nproc: int, timeout_s: float, env: dict | None = None,
             cwd: str | None = None) -> list[str]:
    """``torchrun --nproc-per-node nproc argv`` (``argv`` a script and its
    arguments, or ``-m module ...``); returns each rank's standard output."""
    with tempfile.TemporaryDirectory() as logs:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
               "--master-addr", "localhost", "--master-port", str(free_port()), "--monitor-interval", "0.1",
               "--redirects", "3", "--log-dir", logs, *argv]
        proc = subprocess.Popen(cmd, env={**os.environ, **(env or {})}, cwd=cwd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            agent, _ = proc.communicate(timeout=timeout_s)
            why = f"exited with {proc.returncode}" if proc.returncode else None
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)  # torchrun stops its ranks on SIGTERM
            try:
                agent, _ = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                agent, _ = proc.communicate()
            why = f"timed out after {timeout_s} s"

        def read(rank: int, stream: str) -> str:
            paths = glob.glob(os.path.join(logs, "*", "attempt_*", str(rank), f"{stream}.log"))
            return open(paths[0]).read() if paths else ""

        outs = [read(r, "stdout") for r in range(nproc)]
        if why is not None:
            tails = "\n".join(f"--- rank {r} stderr:\n{read(r, 'stderr')[-3000:]}" for r in range(nproc))
            raise RuntimeError(f"torchrun {why}\n{agent[-3000:]}\n{tails}")
    return outs
