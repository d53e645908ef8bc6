"""The port's spans (``profiling``): off unless read, nesting and
attributes under ``recording()``, a profiler session turning them on with
its ``record_function`` ranges on the spans' clock, and the spans of the
benchmark's serving and tiles cells at a tiny size read by the benchmark's
five span metrics."""

import collections
import math

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu_torch import profiling
from diffusionremotesensing_tpu_torch.diffusion import make_ddim_sampler, make_sampler
from diffusionremotesensing_tpu_torch.schedules import make_schedule
from portbench import run as prun
from portbench.tests import tiny

SEED = 2**31 + 77
READERS = {"sr_x2.serve": ["serve.queue_wait_p95", "serve.batch_run_s", "host_issue_ms.serve"],
           "sr_x2.tiles": ["aggregation.serial_share.tiles", "host_issue_ms.tiles"]}


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(spans):
    return collections.Counter(s.name for s in spans)


def test_off_records_nothing():
    with profiling.annotate("outer", rows=3) as outer:
        with profiling.annotate("inner") as inner:
            outer["late"] = 1
            assert not outer and not inner and outer is inner is profiling.NULL
    queued = profiling.begin("queued", request=1)
    queued.finish(outer)
    assert queued is profiling.NULL
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    import tracemalloc

    class NoClock:
        def time_ns(self):
            raise AssertionError("a span site read the clock with recording off")

    monkeypatch.setattr(profiling, "time", NoClock())
    rows, step = 192, 7

    def site():
        with profiling.annotate("sampler.step", step=step, rows=rows) as span:
            span["rows"] = rows
        profiling.begin("serve.queue", request=step).finish(span)

    site()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(10000):
            site()
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 10,000 spans kept or made would hold ~1 MB; a loop of nothing holds a few hundred bytes
    assert now - before < 1024 and peak - before < 1024
    assert profiling.spans() == []


def test_recording_gives_parents_and_attributes():
    with profiling.recording():
        with profiling.annotate("outer", rows=3) as outer:
            outer["late"] = 1
            with profiling.annotate("inner", step=0):
                pass
            queued = profiling.begin("queued", request=5)
        queued.finish(outer)
    with profiling.annotate("after"):  # recording ended
        pass
    got = {s.name: s for s in profiling.spans()}
    assert set(got) == {"outer", "inner", "queued"}
    assert got["outer"].parent is None and got["outer"].attrs == {"rows": 3, "late": 1}
    assert got["inner"].parent == got["outer"].id and got["inner"].attrs == {"step": 0}
    assert got["queued"].parent == got["outer"].id and got["queued"].attrs == {"request": 5}
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert len({s.id for s in got.values()}) == 3


def test_the_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    with profiling.recording():
        for i in range(6):
            with profiling.annotate("s", i=i):
                pass
    assert [s.attrs["i"] for s in profiling.spans()] == [0, 1, 2, 3]
    assert profiling.dropped() == 2


def test_a_profiler_session_records_spans_on_its_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("port.region", rows=2):
            torch.ones(64).sum()
        queued = profiling.begin("port.queued")
        queued.finish()
    (span,) = [s for s in profiling.spans() if s.name == "port.region"]
    assert span.attrs == {"rows": 2}
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "port.region"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - span.start) < 1_000_000
    # a span that may end on another thread stays in memory only
    assert any(s.name == "port.queued" for s in profiling.spans())
    assert not any(e.name() == "port.queued" for e in prof.profiler.kineto_results.events())


@pytest.mark.parametrize("kind", ["ddim", "ancestral"])
def test_a_sampler_call_holds_one_span_a_step(kind):
    schedule = make_schedule("cosine", 101)
    apply_fn = lambda x, t, cond, feats, aux, **kw: 0.1 * x  # noqa: E731
    if kind == "ddim":
        sampler = make_ddim_sampler(apply_fn, schedule, 100)
    else:
        sampler = make_sampler(apply_fn, schedule, fused_update=False)
    x_T = torch.randn(3, 4, 4, 1, generator=torch.Generator().manual_seed(0))
    with profiling.recording():
        sampler(x_T, generator=torch.Generator().manual_seed(1))
    spans = profiling.spans()
    (call,) = [s for s in spans if s.name == "sampler.call"]
    steps = [s for s in spans if s.name == "sampler.step"]
    assert call.attrs == {"rows": 3}
    assert len(steps) == 100 and all(s.parent == call.id for s in steps)
    assert [s.attrs["step"] for s in steps] == list(range(100))
    ts = [s.attrs["t"] for s in steps]
    assert ts == sorted(ts, reverse=True) and ts[0] == 100 and ts[-1] == 1


def _cell(workload):
    config, traffic = tiny.cell(workload)
    driver = prun.find(tiny.bench(), workload)[3]
    return driver.Cell(config, traffic, SEED, torch.device("cpu")), traffic


def _read(workload, run):
    ctx = {"run": run}
    return {name: prun.metric_reader(name)(ctx) for name in READERS[workload]}


def test_serving_spans_account_for_each_request():
    cell, traffic = _cell("sr_x2.serve")
    cell.setup()
    assert profiling.spans() == []  # set-up records nothing
    with profiling.recording():
        run = cell.window(0.5)
    spans = profiling.spans()
    cell.free()
    byid = {s.id: s for s in spans}
    queued = [s for s in spans if s.name == "serve.queue"]
    batches = [s for s in spans if s.name == "serve.batch"]
    assert len(queued) == run["units"]
    assert len({s.attrs["request"] for s in queued}) == len(queued)
    assert all(byid[s.parent].name == "serve.batch" for s in queued)
    assert [b.attrs["rows"] for b in batches] == run["fills"]
    assert all(b.attrs["max_batch"] == traffic["max_batch"] for b in batches)
    per_batch = collections.Counter(s.parent for s in queued)
    assert [per_batch[b.id] for b in batches] == run["fills"]
    for b in batches:
        children = {s.name for s in spans if s.parent == b.id}
        assert children == {"serve.queue", "serve.prepare", "sampler.call", "serve.copy_out"}
    calls = [s for s in spans if s.name == "sampler.call"]
    steps = collections.Counter(s.parent for s in spans if s.name == "sampler.step")
    assert len(calls) == len(batches) and all(steps[c.id] == traffic["ddim_steps"] for c in calls)
    # a request's wait ends inside its batch: the two spans hold its time
    assert all(byid[s.parent].start <= s.end <= byid[s.parent].end for s in queued)
    read = _read("sr_x2.serve", run)
    assert all(math.isfinite(v) and v >= 0 for v in read.values()), read
    cell.check()
    assert len(profiling.spans()) == len(spans)  # the check records nothing


def test_tiles_spans_follow_the_chunk_plan():
    cell, traffic = _cell("sr_x2.tiles")
    cell.setup()
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run = cell.window(0.5)
    spans = profiling.spans()
    n_patches = traffic["tiles_per_call"] * cell.patches_per_tile()
    plan = [(c, min(size, n_patches - start))
            for c, (start, size) in enumerate(cell.sampler.chunk_plan(n_patches))]
    assert len(plan) > 1
    cell.free()
    cell.check()
    assert len(profiling.spans()) == len(spans)  # nor does the check
    names = _by_name(spans)
    calls = [s for s in spans if s.name == "aggregation.call"]
    assert len(calls) == run["units"]
    for c in calls:
        mine = [s for s in spans if s.parent == c.id]
        for name in ("aggregation.issue", "aggregation.wait", "aggregation.copy_out",
                     "aggregation.blend"):
            got = [(s.attrs["chunk"], s.attrs["rows"]) for s in mine if s.name == name]
            assert got == plan, name
        assert _by_name(mine)["aggregation.prepare"] == _by_name(mine)["aggregation.finish"] == 1
    steps = collections.Counter(s.parent for s in spans if s.name == "sampler.step")
    sampler_calls = [s for s in spans if s.name == "sampler.call"]
    assert names["aggregation.issue"] == len(sampler_calls) == len(plan) * run["units"]
    assert all(steps[s.id] == traffic["ddim_steps"] for s in sampler_calls)
    read = _read("sr_x2.tiles", run)
    assert all(math.isfinite(v) and v > 0 for v in read.values()), read
    assert read["aggregation.serial_share.tiles"] < 100.0


def test_off_again_the_same_run_records_nothing():
    cell, _ = _cell("sr_x2.tiles")
    cell.setup()
    run = cell.window(0.3)
    cell.free()
    assert run["units"] >= 1 and profiling.spans() == []
    assert all(prun.metric_reader(n)({"run": run}) is None for n in READERS["sr_x2.tiles"])
