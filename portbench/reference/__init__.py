"""Plain PyTorch and NumPy reference of what the benchmark's cells compute.

It imports nothing of the program under test: the UNet's forward and
training step, the DDIM sampler with classifier-free guidance, the Gaussian
blend of aggregation sampling and the DownBlur degradation are written
here again, in float32 (``precision.float32``), or with every convolution
and linear layer's operands rounded to float8 e4m3 (``precision.fp8``), the
control that each comparison must fail.
"""
