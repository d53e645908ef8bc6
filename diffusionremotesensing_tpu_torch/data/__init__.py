"""Data for training: the host loader, the datasets of the three tasks
(``datasets``, ``cifar10``), the BSRGAN degradations (``degradations``)
and the on-device DownBlur (``device_degradation``)."""
