"""Date extraction and season / month / day-of-year classes (a copy of
``sbgm_danra_tpu/utils/dates.py``).

File names end in YYYYMMDD; the class index convention is season in {1..4}
(DJF=4, MAM=1, JJA=2, SON=3), month in {1..12}, day-of-year in {1..366};
index 0 is reserved for the CFG null token.
"""

from __future__ import annotations

import re
from typing import Optional

_DATE_RE = re.compile(r"(\d{8})$")

_DAYS_COMMON = [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_DAYS_LEAP = [0, 31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def file_date(filename: str) -> str:
    """The trailing YYYYMMDD date string of a file or group name."""
    stem = filename.split(".")[0]
    m = _DATE_RE.search(stem)
    if not m:
        raise ValueError(f"Could not extract date from filename: {filename}")
    return m.group(1)


def is_leap_year(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def season_of(date: str) -> int:
    """1=MAM, 2=JJA, 3=SON, 4=DJF."""
    month = int(date[4:6])
    if month in (3, 4, 5):
        return 1
    if month in (6, 7, 8):
        return 2
    if month in (9, 10, 11):
        return 3
    return 4


def month_of(date: str) -> int:
    return int(date[4:6])


def day_of_year(date: str) -> int:
    """1-indexed day of year, leap-aware."""
    year, month, day = int(date[:4]), int(date[4:6]), int(date[6:8])
    days = _DAYS_LEAP if is_leap_year(year) else _DAYS_COMMON
    return sum(days[:month]) + day


def classifier_from_date(date: str, n_classes: Optional[int]) -> int:
    """Class index for conditional sampling."""
    if n_classes == 4:
        return season_of(date)
    if n_classes == 12:
        return month_of(date)
    if n_classes == 366:
        return day_of_year(date)
    if n_classes is None:
        return month_of(date)
    raise ValueError(f"n_classes must be 4, 12 or 366, got {n_classes}")
