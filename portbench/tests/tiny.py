"""Each cell at a size the CPU runs in seconds, float32 (the reference agrees
with the program to float32 rounding there), for the harness's tests."""

import time

from portbench import run as prun

TINY = {
    "sr_x2.tiles": dict(tile_lr=32, patch_size=16, stride=8, batch_size=18, tiles_per_call=4,
                        ddim_steps=3, pool=8),
    "gen_eurosat10.bulk": dict(image_size=16, images_per_call=12, ddim_steps=3, check_images=4),
    "sr_x2.train": dict(hr=32, batch=4, pool=16),
    "sr_x2.serve": dict(lr=16, max_batch=6, ddim_steps=3, rate=20.0, pool=8, check_requests=5),
}


def bench():
    return prun.load_json(prun.ROOT, "BENCHMARK.json")


def cell(workload):
    """(config, traffic) of ``workload`` at the tiny size, in float32."""
    _, config, traffic, _ = prun.find(bench(), workload)
    config = dict(config, compute_dtype="float32")
    traffic = dict(traffic, **TINY[workload])
    return config, traffic


def run(workload, seed=2**31 + 77, trace=False, seconds=0.5):
    import torch

    config, traffic = cell(workload)
    return prun.run_cell(bench(), workload, seed, seconds, trace, torch.device("cpu"),
                         config=config, traffic=traffic, setup_t0=time.perf_counter())
