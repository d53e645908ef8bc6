"""The benchmark of ``diffusionremotesensing_tpu_torch`` on one NVIDIA card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root lists the configurations, cells
and metrics by name; this package finds each by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
driver, ``drivers/<kind>.py``) and ``metrics/<metric>.py``. The plain
reference that decides ``correct`` is ``reference/``; it imports nothing of
the program.
"""
