"""The CPU emulation's mbarrier waits with a lane that falls behind its warp.

On the card a producer warp's lanes run in step, so its non-issuing lanes
wait on each phase of an "empty" barrier as the issuing lane does. Under
the emulation every lane is a thread of its own, and a loaded machine can
hold one back while the ring runs on: two phases later the card's parity
test (csrc/sm90.cuh, mbar_wait) would never pass for it, and the kernel's
emulation spun forever (a lagging lane, not a fault of the kernel). The
emulated wait counts the phases each thread has waited through, so a
lagging lane catches up. Here the producer warp's lanes past the first
sleep before the ring starts, so that the ring completes every phase
before they wait on the first: the ring must still finish, in time."""

import ctypes
import threading

import pytest
import torch

from tests.torch_port_helpers import compile_emulated

_LAUNCHER = r"""
// nine rounds through three buffers, as test_torch_port_sm90.py's ring_ws,
// but the producer warp's lanes 1-31 sleep before their first wait
extern "C" void ring_lagging(const void* X, int rounds, float* out) {
  emu_run({1, 1, 1}, 160, [=] {
    unsigned char* base = smem_raw;
    uint64_t* full = (uint64_t*)(base + 3072);
    uint64_t* empty = full + 3;
    const int t = threadIdx.x;
    const sm90::TensorMap xmap{X, {64, rounds, 1, 1}, {2, 128, 0, 0}, {64, 1, 1, 1}};
    if (t == 0) {
      for (int s = 0; s < 3; ++s) {
        sm90::mbar_init(&full[s], 1);
        sm90::mbar_init(&empty[s], 128);
      }
      sm90::fence_mbar_init();
    }
    __syncthreads();
    if (t >= 128) {
      if (t > 128) std::this_thread::sleep_for(std::chrono::milliseconds(200));
      for (int i = 0; i < rounds; ++i) {
        const int s = i % 3;
        if (i >= 3) sm90::mbar_wait(&empty[s], (i / 3 - 1) & 1);
        if (t == 128) {
          sm90::mbar_arrive_expect_tx(&full[s], 128);
          sm90::tma_load_2d(base + 1024 * s, &xmap, 0, i, &full[s]);
        }
      }
      return;
    }
    for (int i = 0; i < rounds; ++i) {
      const int s = i % 3;
      sm90::mbar_wait(&full[s], (i / 3) & 1);
      if (t < 64) out[i * 64 + t] = __bfloat162float(((const __nv_bfloat16*)(base + 1024 * s))[t]);
      sm90::mbar_arrive(&empty[s]);
    }
  });
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("sm90.cuh", "#include <chrono>\n" + _LAUNCHER,
                           tmp_path_factory.mktemp("lag_emu"))
    lib.ring_lagging.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def test_lagging_producer_lanes_catch_up(emulated):
    rounds = 9
    x = torch.arange(rounds * 64, dtype=torch.float32).reshape(rounds, 64).bfloat16()
    out = torch.full((rounds, 64), float("nan"))
    # a hang would hold the test: run the ring on a thread and bound the wait
    th = threading.Thread(target=emulated.ring_lagging, args=(x.data_ptr(), rounds, out.data_ptr()),
                          daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "the lagging lanes never passed their waits"
    assert torch.equal(out, x.float())
