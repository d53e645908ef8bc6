"""kernel_roofline.gen: the hand kernels' share of their roofline (readers.kernel_roofline)."""
from portbench.readers import kernel_roofline as read  # noqa: F401
