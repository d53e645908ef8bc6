"""mfu.train: the whole step's share of the card's dense bf16 peak (readers.mfu)."""
from portbench.readers import mfu as read  # noqa: F401
