"""Receiver: the device engine's event rendering and the host engines."""

from .engine import Receiver, ScoreProvider  # noqa: F401
