"""Streaming download -> transfer -> delete with remote resume.

Re-design of era5_download_pipeline/pipeline/stream.py:15-141: for each
(variable, year) the file is downloaded, rsynced to the cluster and deleted
locally to bound disk usage. Resume semantics preserved exactly (:100-123):
years already present remotely are skipped EXCEPT the newest one, which is
re-done because a crash may have left it partial (restartability).

The port's own copy of ``sbgm_danra_tpu/pipelines/era5/stream.py``
(host only: no JAX, no torch).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Set

from sbgm_danra_tpu_torch.pipelines.era5.download import DownloadSpec, download_year
from sbgm_danra_tpu_torch.pipelines.era5.transfer import remote_years_present, rsync_push

logger = logging.getLogger(__name__)


def years_to_process(requested: Sequence[int], present: Set[int]) -> List[int]:
    """Skip remotely complete years except the newest present one (:100-123)."""
    if not present:
        return list(requested)
    redo = max(present)
    return [y for y in requested if y not in present or y == redo]


def download_transfer_delete(
    client: Callable,
    spec: DownloadSpec,
    remote: str,
    remote_dir: str,
    runner: Optional[Callable[[Sequence[str]], str]] = None,
    keep_local: bool = False,
) -> Dict[str, List[int]]:
    """Stream every (variable, year): download -> rsync -> local delete."""
    from sbgm_danra_tpu_torch.pipelines.era5.transfer import subprocess_capture

    runner = runner or subprocess_capture
    levels = list(spec.pressure_levels) or [None]
    processed: Dict[str, List[int]] = {}
    for var in spec.variables:
        # per-variable remote layout: the reference's lumi dirs embed {var}
        # (era5_pipeline.yaml lumi: block)
        var_dir = remote_dir.format(var=var) if "{var}" in remote_dir else remote_dir
        # Per-(var, level) inventories: filenames encode _pl{level}, so each
        # level resumes independently — a crash between levels of a year
        # redoes only the levels not yet pushed, not every level's CDS
        # download. Generalized redo rule (reference stream.py:100-123): every
        # missing (year, level) is processed, plus ONE suspect redo — the
        # last-pushed level of the newest remotely-present year, whose rsync
        # the crash may have left partial.
        present_by_level: Dict[Optional[int], Set[int]] = {}
        for level in levels:
            key = var if level is None else f"{var}_pl{level}"
            present_by_level[level] = remote_years_present(remote, var_dir, key, runner)
            logger.info("%s: %d years remote", key, len(present_by_level[level]))
        todo_by_level = {
            lv: {y for y in spec.years if y not in present_by_level[lv]}
            for lv in levels
        }
        all_present = set().union(*present_by_level.values())
        if all_present:
            y_max = max(all_present)
            if y_max in spec.years:
                pushed = [lv for lv in levels if y_max in present_by_level[lv]]
                if pushed:
                    todo_by_level[pushed[-1]].add(y_max)
        done = []
        for year in spec.years:
            pending = [lv for lv in levels if year in todo_by_level[lv]]
            for level in pending:
                path = download_year(client, spec, var, year, level)
                rsync_push(path, remote, var_dir, runner)
                if not keep_local and os.path.exists(path):
                    os.remove(path)
            if pending:
                done.append(year)
        processed[var] = done
    return processed
