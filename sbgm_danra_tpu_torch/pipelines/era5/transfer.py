"""File transfer + remote inventory (rsync/ssh).

Re-design of era5_download_pipeline/pipeline/transfer.py:12-52 and
remote_utils.py:10-46 with injectable runners.

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/transfer.py``
(host only: no JAX, no torch).
"""

from __future__ import annotations

import logging
import re
import subprocess
from typing import Callable, List, Sequence, Set

logger = logging.getLogger(__name__)


def subprocess_capture(argv: Sequence[str]) -> str:
    try:
        out = subprocess.run(list(argv), check=True, capture_output=True, text=True)
        return out.stdout
    except FileNotFoundError as e:
        raise RuntimeError(f"External tool '{argv[0]}' is not installed") from e


def rsync_push(
    local_path: str,
    remote: str,
    remote_dir: str,
    runner: Callable[[Sequence[str]], str] = subprocess_capture,
    extra_args: Sequence[str] = ("-az", "--partial"),
) -> None:
    """rsync a file/dir to remote:dir (reference transfer.py:12-52)."""
    argv = ["rsync", *extra_args, local_path, f"{remote}:{remote_dir.rstrip('/')}/"]
    runner(argv)
    logger.info("pushed %s -> %s:%s", local_path, remote, remote_dir)


_YEAR_RE = re.compile(r"(\d{4})")


def remote_years_present(
    remote: str,
    remote_dir: str,
    variable: str,
    runner: Callable[[Sequence[str]], str] = subprocess_capture,
) -> Set[int]:
    """Inventory of years already transferred (reference remote_utils.py:10-46):
    ssh-ls the remote dir, extract years from filenames of this variable."""
    listing = runner(["ssh", remote, "ls", remote_dir])
    years: Set[int] = set()
    for name in listing.split():
        if variable in name:
            m = _YEAR_RE.search(name.replace(variable, ""))
            if m:
                years.add(int(m.group(1)))
    return years
