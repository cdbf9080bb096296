"""Argparse type coercions (counterpart of serenade_tpu/utils/types.py)."""

from __future__ import annotations

import argparse
from typing import Optional

_NONE = ("none", "null", "")


def str2bool(value) -> bool:
    """yes/true/t/y/1 and no/false/f/n/0 in any case; a bool passes
    through; anything else raises ``argparse.ArgumentTypeError``."""
    if isinstance(value, bool):
        return value
    v = value.lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {value!r}")


def int_or_none(value: str) -> Optional[int]:
    return None if value.lower() in _NONE else int(value)


def float_or_none(value: str) -> Optional[float]:
    return None if value.lower() in _NONE else float(value)


def str_or_none(value: str) -> Optional[str]:
    return None if value.lower() in _NONE else value
