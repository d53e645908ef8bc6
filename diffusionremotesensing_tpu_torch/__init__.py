"""PyTorch/CUDA port of ``diffusionremotesensing_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: each module here mirrors
its namesake there (``schedules``, ``models.blocks``, ``models.unet``,
``ops.*``, ``diffusion``, ``aggregation``, ``serving``) and is held equal to
it by ``tests/test_torch_port_*.py``. This package imports ``torch``, numpy
and the standard library only: nothing of JAX, flax or the JAX package, so
it runs on a machine that has none of them.

Layout follows the reference's public functions: images are NHWC, conv
kernels handed to the ``ops`` transforms are HWIO. Inside the model the
convolutions run as channels-last ``torch`` convolutions on permuted views,
so no layout copies are made at the boundary.

It serves the reference's three tasks: super-resolution, SAR->NDVI and
class-conditional generation with classifier-free guidance
(``serving.InferenceServer(task=...)``), and trains them
(``train.Trainer``: the reference's step, loop and ``s2d_train``, with the
host loader ``data.loader`` and the DownBlur on the device,
``data.device_degradation``). No hand kernel runs in training, as in the
reference.

The TPU kernels of the served paths are hand-written CUDA kernels here,
built with ``nvcc`` at first use and bound with ``ctypes``:
``ops/tap_block.py`` (ResConvBlock-0 fused, ``csrc/tap_block.cu``) and, in
the fully fused configuration, ``ops/att_block.py`` (``fused_att=True``),
``ops/dec_block.py`` (``dec_block=True``) and ``ops/fused_update.py`` (the
ancestral update, ``fused_update=True`` on the samplers). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; asked for ``cuda``
without a card they raise.
"""

__version__ = "0.1.0"
