"""Physical-unit corrections and the variables' names, units and colormaps
(a copy of ``sbgm_danra_tpu/utils/units.py``, cut to what the port reads):
temperatures K -> degC, ERA5 precipitation m -> mm, CAPE J -> kJ, MSL Pa ->
hPa, geopotential -> geopotential height.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# long name, unit and colormap per variable (the figures read them)
VARIABLE_REGISTRY: Dict[str, Dict[str, str]] = {
    "temp": {"long_name": "2m temperature", "unit": "degC", "cmap": "plasma"},
    "prcp": {"long_name": "Total precipitation", "unit": "mm", "cmap": "inferno"},
    "cape": {"long_name": "CAPE", "unit": "kJ/kg", "cmap": "viridis"},
    "nwvf": {"long_name": "Northward water vapour flux", "unit": "kg/m/s", "cmap": "cividis"},
    "ewvf": {"long_name": "Eastward water vapour flux", "unit": "kg/m/s", "cmap": "cividis"},
    "msl": {"long_name": "Mean sea level pressure", "unit": "hPa", "cmap": "coolwarm"},
    "z_pl_250": {"long_name": "Geopotential height 250 hPa", "unit": "m", "cmap": "viridis"},
    "z_pl_500": {"long_name": "Geopotential height 500 hPa", "unit": "m", "cmap": "viridis"},
    "z_pl_850": {"long_name": "Geopotential height 850 hPa", "unit": "m", "cmap": "viridis"},
    "z_pl_1000": {"long_name": "Geopotential height 1000 hPa", "unit": "m", "cmap": "viridis"},
    "u10": {"long_name": "10m U wind", "unit": "m/s", "cmap": "RdBu_r"},
    "v10": {"long_name": "10m V wind", "unit": "m/s", "cmap": "RdBu_r"},
    "lsm": {"long_name": "Land-sea mask", "unit": "", "cmap": "binary"},
    "topo": {"long_name": "Topography", "unit": "m", "cmap": "terrain"},
}

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
