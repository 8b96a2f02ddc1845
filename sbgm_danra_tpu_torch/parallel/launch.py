"""Ranks as child processes, for the CPU tests and the card check.

    spawn("package.module:function", 2, payload, backend="gloo", device="cpu")

starts one ``python -m sbgm_danra_tpu_torch.parallel.launch`` process a rank
with torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR=localhost``, ``MASTER_PORT`` a free port). Each child joins the
group (``mesh.initialize_distributed`` with the given backend and device),
calls ``function(payload)`` and writes what it returns with ``torch.save``;
the parent returns the ranks' results in rank order. A child that fails
fails the call: its exit code and the end of its output are raised, and the
other children are stopped. Nothing is caught and retried.

Children run from the current directory, so ``module`` may be any module
importable from there (a script beside the repo's root, a test helper).
``threads`` sets each child's torch threads (1 by default: several
processes share the host's cores).
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional

import torch


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(target: str, world_size: int, payload: Any = None, backend: Optional[str] = None,
          device: str = "cpu", timeout: float = 600.0, threads: int = 1,
          env: Optional[dict] = None) -> List[Any]:
    """``target(payload)`` on ``world_size`` ranks; returns their results."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="sbgm_ranks_") as tmp:
        inp = os.path.join(tmp, "payload.pt")
        torch.save(payload, inp)
        procs, logs = [], []
        for rank in range(world_size):
            child_env = dict(os.environ, **(env or {}))
            child_env["PYTHONPATH"] = os.pathsep.join(
                [_ROOT] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
            child_env.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                             MASTER_ADDR="localhost", MASTER_PORT=str(port),
                             SBGM_LAUNCH_BACKEND=backend or "", SBGM_LAUNCH_DEVICE=device,
                             SBGM_LAUNCH_THREADS=str(threads))
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "sbgm_danra_tpu_torch.parallel.launch", target, inp,
                 os.path.join(tmp, f"out{rank}.pt")],
                env=child_env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target} on {world_size} ranks: no end after "
                                       f"{timeout} s")
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
            if failed is not None:
                logs[failed].seek(0)
                tail = logs[failed].read()[-6000:]
                raise RuntimeError(f"{target}: rank {failed} of {world_size} exited with "
                                   f"{procs[failed].returncode}:\n{tail}")
            return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                    for r in range(world_size)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()


def _main(argv) -> int:
    target, inp, out = argv
    torch.set_num_threads(int(os.environ.get("SBGM_LAUNCH_THREADS", "1")))
    from sbgm_danra_tpu_torch.parallel.mesh import initialize_distributed

    import torch.distributed as dist

    initialize_distributed(backend=os.environ.get("SBGM_LAUNCH_BACKEND") or None,
                           device=os.environ.get("SBGM_LAUNCH_DEVICE", "cpu"))
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(torch.load(inp, weights_only=False))
    torch.save(result, out)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
