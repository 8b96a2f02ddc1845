"""Physical-unit corrections (a copy of ``sbgm_danra_tpu/utils/units.py``, cut
to what the port reads): temperatures K -> degC, ERA5 precipitation m -> mm,
CAPE J -> kJ, MSL Pa -> hPa, geopotential -> geopotential height.
"""

from __future__ import annotations

import numpy as np

_TINY = 1e-10


def correct_variable_units(var_name: str, model: str, data: np.ndarray) -> np.ndarray:
    """Unit corrections per variable and model, on a float32 copy."""
    data = np.asarray(data).astype(np.float32, copy=True)
    if var_name in ("temp", "t2m"):
        data = data - 273.15
    elif var_name in ("prcp", "tp") and model == "DANRA":
        data[data < 0] = _TINY
    elif var_name == "prcp" and model == "ERA5":
        data = data * 1000.0  # m -> mm
        data[data < 0] = _TINY
    elif var_name == "cape" and model == "ERA5":
        data = data / 1000.0  # J/kg -> kJ/kg
        data[data < 0] = _TINY
    elif var_name == "msl" and model == "ERA5":
        data = data / 100.0  # Pa -> hPa
    elif var_name == "pev" and model == "ERA5":
        data = data / 1000.0
    elif var_name.startswith("z_pl_") and model == "ERA5":
        data = data / 9.81  # geopotential -> height (m)
    return data
