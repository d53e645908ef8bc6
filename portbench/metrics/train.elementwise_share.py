"""train.elementwise_share: the training step's device time in PyTorch's
elementwise and reduction kernels (float32 BatchNorm, pointwise ops), %."""
from portbench.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, ("elementwise_kernel", "reduce_kernel"))
