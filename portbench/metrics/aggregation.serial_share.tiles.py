"""aggregation.serial_share.tiles: aggregation's host work with no sampler work queued,
over the window (spans.serial_share)."""
from portbench.spans import serial_share as read  # noqa: F401
