#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printing one line with its name, seconds and result:

1. device  - require a CUDA card; print its name and nvidia-smi's name and
             power limit.
2. build   - nvcc every CUDA source of the port (csrc/*.cu), in parallel.
3. kernel  - hold tap_block (csrc/tap_block.cu) against tap_block_plain on
             the card at the main path's shapes (B=48 and the B=1 remainder
             chunk, 64x64 s2d pixels) in bfloat16 and float32; time the
             kernel, the plain version and the cuDNN dense-s2d composition of
             the same block (the yardstick, never called by the port).
4. golden  - the full-width UNet on the card in float32 (plain forward, s2d,
             s2d with the kernel) against values the JAX reference package
             computed for the same weights and input (GOLDEN below).
5. model   - the full-width UNet forward at B=48, HR 128, with the kernel
             against the dense-s2d path, in bfloat16 and float32.
6. serve   - InferenceServer (super-resolution x2, cosine T=1500, bfloat16,
             s2d, tap_block) answers 4 concurrent 64x64 requests at DDIM-100,
             2 tiles of 256x256 at DDIM-100 and 2 tiles at the ancestral
             T=1500 chain (two of each, so that the spread within one run
             shows); checks shapes, finiteness, range and that tap_block
             launched exactly once per UNet forward.
7. profile - only with --profile: where one sampler step's time goes, for
             one UNet forward of the served configuration at B=48 and B=1:
             device ms, host ms to issue it, wall ms, and the top kernels by
             device time from torch.profiler.

Then a JSON line with each kernel's numbers, and last
{"ok": true, "device": {...}}. Any failure raises: the script exits non-zero
and prints no result. It needs one card, builds everything it runs from the
sources beside it, and imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusionremotesensing_tpu_torch.convert import init_params  # noqa: E402
from diffusionremotesensing_tpu_torch.diffusion import make_process  # noqa: E402
from diffusionremotesensing_tpu_torch.models.unet import (  # noqa: E402
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.ops import cuda_build  # noqa: E402
from diffusionremotesensing_tpu_torch.ops.s2d import conv_nhwc  # noqa: E402
from diffusionremotesensing_tpu_torch.ops.tap_block import tap_block, tap_block_plain  # noqa: E402
from diffusionremotesensing_tpu_torch.serving import InferenceServer  # noqa: E402

SEED = 0
T_STEPS = 1500
DDIM_STEPS = 100
HR = 128                      # HR patch edge of the main path (LR 64)
TILE_LR = 256                 # LR tile edge
B_FLAG = 48                   # patches per chunk on the main path
PEAK_BF16 = 989e12            # H100 SXM dense bf16 tensor FLOP/s
PEAK_F32 = 67e12              # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s

# Tolerances, max |kernel - plain| <= tol * max(1, max |plain|):
# bfloat16: both versions round h and the output to bf16 after float32 sums
# taken in different orders, so a value at a rounding boundary may land one
# ulp (2**-8 relative) apart, and such an h flip moves the output by less;
# 1e-2 is 2.5 ulps at the top of the range.
# float32: float32 sums of up to 1024 products in different orders.
KERNEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# whole UNet, kernel path against the dense-s2d path: float32 as above
# (TF32 off); bfloat16 rounds every layer's output, ~25 layers deep, and
# read 1.5e-3 at this shape on an H100, so 1e-2 leaves ~7x headroom.
MODEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
GOLDEN_TOL = 1e-4
PROFILE_N = 4  # forwards per profile reading (~200 launches each fit the launch queue)

# Values the JAX reference package computes for init_params(SEED) and
# golden_input() (tests/test_torch_port_imports.py recomputes them):
# the float32 output flattened and read at every 97th element, and the sum
# of |output|.
GOLDEN = {
    "stride": 97,
    "values": [
        0.05096697434782982, 0.14409835636615753, 0.014462698251008987, 0.04780956357717514,
        0.13677376508712769, -0.0037570204585790634, 0.10057226568460464, 0.1761390119791031,
        -0.015248360112309456, 0.11522963643074036, 0.12124008685350418, 0.009030509740114212,
        0.10207726061344147, 0.15788507461547852, 0.03325726091861725, 0.0809665396809578,
        0.13191251456737518, 0.020354028791189194, 0.07536162436008453, 0.1566077470779419,
        -0.021193502470850945, 0.05217009782791138, 0.1133221834897995, 0.014033039100468159,
        0.1344250738620758, 0.1590011715888977, -0.0014126794412732124, 0.09311191737651825,
        0.14676780998706818, -0.001918606460094452, 0.11543634533882141, 0.19701945781707764,
    ],
    "abs_sum": 258.037885354599,
}


def golden_input():
    rng = np.random.default_rng(1234)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    t = np.array([737], np.float32)
    cond = rng.random((1, 16, 16, 3)).astype(np.float32)
    return x, t, cond


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def phase(name, fn):
    t0 = time.perf_counter()
    try:
        summary = fn()
    except BaseException as e:
        print(f"[{name}] {time.perf_counter() - t0:.1f}s FAILED: {type(e).__name__}: {e}",
              flush=True)
        raise
    print(f"[{name}] {time.perf_counter() - t0:.1f}s ok {summary}", flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of fn() in ms over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def model_with(s2d, tap44, device, dtype=torch.float32):
    m = residual_attention_unet_superres(magnification_factor=2, s2d=s2d, tap44=tap44)
    m.load_state_dict(init_params(SEED, "cpu"))
    return m.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


def block_dense_s2d(h_s, te4, k):
    """The yardstick: ResConvBlock-0 as cuDNN convolutions on the dense s2d
    kernels (the port's tap44=False path, written out here)."""
    h = torch.relu(conv_nhwc(h_s, k["blk_conv1"], k["blk_b1"], padding=1) * k["bn0_a"] + k["bn0_c"])
    h = h + conv_nhwc(h_s, k["blk_skip"], k["blk_bsk"], padding=1) + te4[:, None, None, :]
    h = conv_nhwc(h, k["blk_conv2"], k["blk_b2"], padding=1) * k["bn1_a"] + k["bn1_c"]
    s = conv_nhwc(h_s, k["blk_short"], k["blk_bsh"]) * k["bn2_a"] + k["bn2_c"]
    return torch.relu(s + h)


def block_flops(B, H2, W2, C4, CO4):
    """(dense, issued) FLOPs of one tap_block call. Dense is the block's own
    work at full resolution (2*H2 x 2*W2 pixels, Ci = C4/4 in, Co = CO4/4
    out): conv1 and skip 3x3 Ci->Co, conv2 3x3 Co->Co, shortcut 1x1 Ci->Co.
    Issued is the size of the tap-formulation products the kernel runs
    (X1 @ W1 and im2col(h) @ W2), structural zeros included."""
    ci, co = C4 // 4, CO4 // 4
    dense = 2 * B * (2 * H2) * (2 * W2) * (2 * 9 * ci * co + 9 * co * co + ci * co)
    issued = 2 * B * H2 * W2 * (4 * C4 * 3 * CO4 + 4 * CO4 * CO4)
    return dense, issued


def block_bound(B, H2, W2, C4, CO4, itemsize, peak):
    """Least time (ms) for one tap_block call: bytes each read or written
    once, the block's dense operations at the card's peak for the input type."""
    flops, _ = block_flops(B, H2, W2, C4, CO4)
    nbytes = itemsize * (B * H2 * W2 * C4 + B * CO4 + 4 * C4 * 3 * CO4 + 4 * CO4 * CO4
                         + 4 * CO4 + B * H2 * W2 * CO4)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def profile_forward(proc, batch, dev):
    """Device, host and wall ms of one UNet forward at `batch`, and the top
    kernels by device time (empty if torch.profiler sees no device time)."""
    g = torch.Generator(device=dev).manual_seed(batch)
    x = torch.randn((batch, HR // 2, HR // 2, 12), generator=g, device=dev)  # s2d state
    t = torch.full((batch,), 750.0, device=dev)
    feats = proc.encode_cond_fn(torch.rand((batch, HR // 2, HR // 2, 3), generator=g, device=dev))

    def fn():
        proc.apply_fn(x, t, None, feats, proc.kernels)

    wall_ms = time_ms(fn, reps=PROFILE_N)  # host and device overlapping, as in the sampler
    # device time alone: a sleep kernel holds the device while the host
    # queues the forwards, which then run back to back; the host's time to
    # queue them is its issue time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(PROFILE_N):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_N
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / PROFILE_N
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_N):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(({"name": ev.key[:80], "ms_per_forward": ev.self_device_time_total / 1e3 / PROFILE_N,
                       "calls": ev.count // PROFILE_N}
                      for ev in prof.key_averages() if getattr(ev, "self_device_time_total", 0) > 0),
                     key=lambda r: -r["ms_per_forward"])
    return {"batch": batch, "device_ms": device_ms, "host_ms": host_ms, "wall_ms": wall_ms,
            "kernels": kernels[:12]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="also run the profile phase")
    args = ap.parse_args()
    state = {}
    dev = torch.device("cuda")

    def device():
        check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
        # float32 comparisons below mean full float32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state["kind"] = torch.cuda.get_device_name(0)
        state["count"] = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        print(smi[0], flush=True)
        return (f"{state['kind']}, {state['count']} visible, torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")

    def build():
        b = cuda_build.build("tap_block")
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        return f"tap_block: {b.seconds:.1f}s; " + " | ".join(ptxas)

    def kernel():
        rows = []
        for dt in (torch.bfloat16, torch.float32):
            kb = model_with(True, "block", dev).prepare_s2d_kernels(dt)
            kd = model_with(True, False, dev).prepare_s2d_kernels(dt)
            for B in (B_FLAG, 1):
                g = torch.Generator(device=dev).manual_seed(B)
                x = torch.randn((B, HR // 2, HR // 2, 64), generator=g, device=dev).to(dt)
                te4 = torch.relu(torch.randn((B, 128), generator=g, device=dev)).to(dt)
                got = tap_block(x, te4, kb["tap_block"])
                want = tap_block_plain(x, te4, kb["tap_block"])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                check(torch.isfinite(got.float()).all().item(), f"tap_block {dt} B={B}: non-finite")
                check(err <= KERNEL_TOL[dt] * scale,
                      f"tap_block {dt} B={B}: max|err| {err} > {KERNEL_TOL[dt]} * {scale}")
                row = {"dtype": str(dt).split(".")[-1], "B": B, "max_abs_err": err, "scale": scale}
                if B == B_FLAG:
                    row["ms"] = time_ms(lambda: tap_block(x, te4, kb["tap_block"]))
                    row["plain_ms"] = time_ms(lambda: tap_block_plain(x, te4, kb["tap_block"]),
                                              reps=5)
                    row["library_ms"] = time_ms(lambda: block_dense_s2d(x, te4, kd))
                    row["bound_ms"], row["bound_by"] = block_bound(
                        B, HR // 2, HR // 2, 64, 128, x.element_size(),
                        PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
                    row["dense_gflop"], row["issued_gflop"] = (
                        f / 1e9 for f in block_flops(B, HR // 2, HR // 2, 64, 128))
                rows.append(row)
        state["kernel_rows"] = rows
        return json.dumps(rows)

    def golden():
        check(len(GOLDEN["values"]) > 0, "GOLDEN values missing")
        x, t, cond = (torch.from_numpy(a).to(dev) for a in golden_input())
        want = np.asarray(GOLDEN["values"], np.float64)
        errs = {}
        for s2d, tap44 in ((False, False), (True, False), (True, "block")):
            before = tap_block.launches
            with torch.inference_mode():
                out = model_with(s2d, tap44, dev)(x, t, cond).cpu().numpy().astype(np.float64)
            if tap44 == "block":
                check(tap_block.launches == before + 1, "golden: tap_block did not launch")
            got = out.reshape(-1)[::GOLDEN["stride"]]
            err = float(np.abs(got - want).max())
            abs_sum_err = abs(float(np.abs(out).sum()) - GOLDEN["abs_sum"]) / out.size
            check(err <= GOLDEN_TOL and abs_sum_err <= GOLDEN_TOL,
                  f"golden s2d={s2d} tap44={tap44}: max|err| {err}, mean |abs| err {abs_sum_err}")
            errs[f"s2d={s2d},tap44={tap44}"] = err
        return json.dumps(errs)

    def model():
        res = {}
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)
            x = torch.randn((B_FLAG, HR, HR, 3), generator=g, device=dev)
            t = torch.randint(1, T_STEPS, (B_FLAG,), generator=g, device=dev).float()
            cond = torch.rand((B_FLAG, HR // 2, HR // 2, 3), generator=g, device=dev)
            outs = {}
            for tap44 in ("block", False):
                m = model_with(True, tap44, dev, dt)
                with torch.inference_mode():
                    outs[tap44] = m(x, t, cond, s2d_kernels=m.prepare_s2d_kernels())
            torch.cuda.synchronize()
            a, b = outs["block"], outs[False]
            check(a.shape == (B_FLAG, HR, HR, 3) and torch.isfinite(a).all().item(),
                  f"model {dt}: bad output {tuple(a.shape)}")
            err = (a - b).abs().max().item()
            scale = max(1.0, b.abs().max().item())
            check(err <= MODEL_TOL[dt] * scale,
                  f"model {dt}: max|block - dense| {err} > {MODEL_TOL[dt]} * {scale}")
            res[str(dt).split(".")[-1]] = {"max_abs_diff": err, "scale": scale}
        return json.dumps(res)

    def serve():
        model = model_with(True, "block", dev)
        rng = np.random.default_rng(SEED)
        lrs = [rng.random((HR // 2, HR // 2, 3)).astype(np.float32) for _ in range(4)]
        tile = rng.random((TILE_LR, TILE_LR, 3)).astype(np.float32)
        ddim = InferenceServer(model, "cosine", T_STEPS, HR, ddim_steps=DDIM_STEPS,
                               dtype=torch.bfloat16, device="cuda")
        ddpm = InferenceServer(model, "cosine", T_STEPS, HR, dtype=torch.bfloat16, device="cuda")
        secs = {}
        try:
            torch.cuda.synchronize()
            tap_block.launches = 0
            results = [None] * 4
            t0 = time.perf_counter()

            def one(i):
                results[i] = ddim.infer_batch([lrs[i]])[0]

            threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            secs["batch_4_requests_ddim100"] = time.perf_counter() - t0
            tiles = []
            for i in range(2):
                t0 = time.perf_counter()
                tiles.append(ddim.infer_tile(tile))
                secs[f"tile_ddim100_{i}"] = time.perf_counter() - t0
            for i in range(2):
                t0 = time.perf_counter()
                tiles.append(ddpm.infer_tile(tile))
                secs[f"tile_ddpm1500_{i}"] = time.perf_counter() - t0
            launches = tap_block.launches
            batches = ddim.batches_run
        finally:
            ddim.shutdown()
            ddpm.shutdown()
        for r in results:
            check(r is not None and r.shape == (HR, HR, 3), "batch request unanswered or misshapen")
            check(np.isfinite(r).all() and r.min() >= 0.0 and r.max() <= 1.0, "batch output range")
        for tl in tiles:
            check(tl.shape == (2 * TILE_LR, 2 * TILE_LR, 3), f"tile shape {tl.shape}")
            check(np.isfinite(tl).all() and tl.min() >= 0.0 and tl.max() <= 1.0, "tile output range")
        n_chunks = 2  # 49 patches: one chunk of 48 and the remainder of 1
        expected = batches * DDIM_STEPS + 2 * n_chunks * (DDIM_STEPS + T_STEPS - 1)
        check(launches == expected, f"tap_block launched {launches} times, expected {expected}")
        state["launches"] = launches
        return json.dumps({"micro_batches": batches, "tap_block_launches": launches,
                           "seconds": secs})

    def profile():
        proc = make_process(model_with(True, "block", dev), "cosine", T_STEPS, HR,
                            dtype=torch.bfloat16)
        with torch.inference_mode():
            return "\n".join(json.dumps(profile_forward(proc, b, dev)) for b in (B_FLAG, 1))

    phase("device", device)
    phase("build", build)
    phase("kernel", kernel)
    phase("golden", golden)
    phase("model", model)
    phase("serve", serve)
    if args.profile:
        phase("profile", profile)

    flag = next(r for r in state["kernel_rows"] if r["dtype"] == "bfloat16" and r["B"] == B_FLAG)
    print(json.dumps({"kernels": [{
        "name": "tap_block",
        "route": "cuda",
        "source": "diffusionremotesensing_tpu_torch/csrc/tap_block.cu",
        "replaces": "diffusionremotesensing_tpu/ops/tap_block.py:427",
        "launches": state["launches"],
        "max_abs_err": flag["max_abs_err"],
        "ms": flag["ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                             "count": state["count"]}}), flush=True)


if __name__ == "__main__":
    main()
