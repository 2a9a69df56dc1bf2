"""Run a worker script on 4 ``gloo`` processes of one host (the port's
sharded tests): each gets its rank, a free port on 127.0.0.1 and the
caller's arguments as ``sys.argv[1:]``; every process is ended, and a
failed or hung one fails the caller with the logs' tail."""
import os
import socket
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script: str, *args, timeout: float = 240) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), port, *map(str, args)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
