"""The Residual Attention UNet and its blocks (port of
``diffusionremotesensing_tpu/models``)."""
