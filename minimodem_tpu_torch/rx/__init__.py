"""Receiver: event rendering over the device pipeline."""

from .engine import Receiver  # noqa: F401
