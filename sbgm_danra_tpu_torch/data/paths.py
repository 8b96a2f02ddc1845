"""On-disk layout conventions (a copy of ``sbgm_danra_tpu/data/paths.py``).

data_{MODEL}/size_{HxW}/{var}_{HxW}/{train|valid|test|all}/       (npz files)
data_{MODEL}/size_{HxW}/{var}_{HxW}/zarr_files/{split}.zarr      (zarr stores)
"""

from __future__ import annotations

import os
from typing import Sequence


def build_data_path(
    base_path: str,
    model: str,
    var: str,
    full_domain_dims: Sequence[int],
    split: str,
    zarr_file: bool = True,
) -> str:
    size = f"{full_domain_dims[0]}x{full_domain_dims[1]}"
    root = os.path.join(base_path, f"data_{model}", f"size_{size}", f"{var}_{size}")
    if zarr_file:
        return os.path.join(root, "zarr_files", f"{split}.zarr")
    return os.path.join(root, split)


def lsm_path(base_path: str) -> str:
    return os.path.join(base_path, "data_lsm", "truth_fullDomain", "lsm_full.npz")


def topo_path(base_path: str) -> str:
    return os.path.join(base_path, "data_topo", "truth_fullDomain", "topo_full.npz")
