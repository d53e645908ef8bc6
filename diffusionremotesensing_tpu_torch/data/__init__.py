"""Data for training: the host loader and the on-device DownBlur."""
