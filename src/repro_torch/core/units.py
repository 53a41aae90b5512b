"""Memory-unit conventions (paper §2.2), the port's copy of ``repro/core/units.py``.

ELANA reports sizes in SI units by default (1 GB = 1000³ bytes — the storage-
manufacturer convention the paper adopts) with binary units (1 GiB = 1024³)
as an option.
"""

from __future__ import annotations

from typing import Literal

Unit = Literal["B", "KB", "MB", "GB", "TB", "KiB", "MiB", "GiB", "TiB"]

_SI = {"B": 1, "KB": 1000, "MB": 1000**2, "GB": 1000**3, "TB": 1000**4}
_BIN = {"B": 1, "KiB": 1024, "MiB": 1024**2, "GiB": 1024**3, "TiB": 1024**4}
FACTORS = {**_SI, **_BIN}


def convert(num_bytes: int, unit: Unit = "GB") -> float:
    """Convert a byte count to the requested unit."""
    return num_bytes / FACTORS[unit]


def fmt_bytes(num_bytes: int, unit: Unit = "GB", digits: int = 2) -> str:
    return f"{convert(num_bytes, unit):.{digits}f} {unit}"


def auto_unit(num_bytes: int, binary: bool = False) -> Unit:
    """Pick the largest unit that keeps the value >= 1."""
    table = _BIN if binary else _SI
    best = "B"
    for unit, factor in table.items():
        if num_bytes >= factor:
            best = unit
    return best


def fmt_auto(num_bytes: int, binary: bool = False, digits: int = 2) -> str:
    return fmt_bytes(num_bytes, auto_unit(num_bytes, binary), digits)


def fmt_duration(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.2f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds:.2f} s"
