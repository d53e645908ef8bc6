"""device_idle.serve: the traced window's share with the card idle (readers.device_idle)."""
from portbench.readers import device_idle as read  # noqa: F401
