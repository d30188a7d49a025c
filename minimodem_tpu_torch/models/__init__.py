"""Modem model families (baudmode presets) and the high-level Modem API."""

from .presets import PRESETS, Preset  # noqa: F401
from .modem import FskModem           # noqa: F401
