"""The port's seeded cluster simulator (``sched/sim.py``) against the JAX
package's, on the same traces.

Each case replays one seeded trace through the reference's ``ClusterSim``
driving the reference's scheduler, and through the port's ``ClusterSim``
driving the port's: FIFO (``GangScheduler``) and fair-share, resize on and
off, over ``synthetic_trace`` and ``elastic_trace``.  The two ``SimReport``s
must be equal field for field, exactly (tolerance: none — the simulator is
host arithmetic on the same float operations in the same order).  The
traces themselves are compared first, so a difference in the generator
cannot hide behind a scheduler difference.  Everything runs on the host in
milliseconds; nothing sleeps or opens a socket.
"""

from __future__ import annotations

import dataclasses

import pytest

from finetune_controller_tpu.controller.backends.scheduler import GangScheduler as RefGang
from finetune_controller_tpu.sched import FairShareScheduler as RefFairShare
from finetune_controller_tpu.sched import sim as ref_sim
from finetune_controller_tpu_torch.controller.backends.scheduler import GangScheduler
from finetune_controller_tpu_torch.sched import FairShareScheduler
from finetune_controller_tpu_torch.sched import sim


def _factory(kind: str, catalog, resize: bool, ref: bool):
    gang, fair = (RefGang, RefFairShare) if ref else (GangScheduler, FairShareScheduler)
    queues = (ref_sim if ref else sim).TRACE_QUEUES
    if kind == "fifo":
        return lambda clock: gang(catalog)
    return lambda clock: fair(catalog, queues, clock=clock, resize=resize, grow_delay_s=5.0)


def _report(mod, kind: str, trace_name: str, seed: int, resize: bool):
    catalog = mod.sim_catalog(8)
    trace = getattr(mod, trace_name)(seed)
    report = mod.ClusterSim(
        catalog, _factory(kind, catalog, resize, ref=mod is ref_sim),
        queue_weights=mod.TRACE_QUEUES,
    ).run(trace)
    return trace, report


CASES = [
    (kind, trace, seed, resize)
    for trace in ("synthetic_trace", "elastic_trace")
    for seed in (0, 1, 2)
    for kind, resize in (("fifo", False), ("fairshare", False), ("fairshare", True))
]


@pytest.mark.parametrize("kind,trace_name,seed,resize", CASES,
                         ids=[f"{k}-{t.split('_')[0]}-s{s}-{'resize' if r else 'evict'}"
                              for k, t, s, r in CASES])
def test_sim_report_equals_the_reference(kind, trace_name, seed, resize):
    ref_trace, ref_report = _report(ref_sim, kind, trace_name, seed, resize)
    trace, report = _report(sim, kind, trace_name, seed, resize)
    assert [dataclasses.asdict(j) for j in trace] == [dataclasses.asdict(j) for j in ref_trace]
    assert dataclasses.asdict(report) == dataclasses.asdict(ref_report)
    assert report.progress_lost_chip_seconds == ref_report.progress_lost_chip_seconds
    for max_chips in (None, 1):
        waits = report.waits(max_chips=max_chips)
        assert waits == ref_report.waits(max_chips=max_chips)
        assert sim.percentile(waits, 95) == ref_sim.percentile(waits, 95)
    # the run is not vacuous: every job finished
    assert all(o.finish_s is not None for o in report.outcomes.values())


def test_sim_catalog_and_percentile_match_the_reference():
    assert sim.sim_catalog(5, "x").model_dump() == ref_sim.sim_catalog(5, "x").model_dump()
    for xs in ([], [3.0], [5.0, 1.0, 4.0, 2.0], [float(i) for i in range(37)]):
        for p in (0, 50, 95, 99, 100):
            assert sim.percentile(list(xs), p) == ref_sim.percentile(list(xs), p)


def test_sim_refuses_duplicates_and_a_starved_horizon():
    catalog = sim.sim_catalog(2)
    job = sim.SimJob("a", "sim-chip", 10.0)
    fair = _factory("fairshare", catalog, False, ref=False)
    with pytest.raises(ValueError, match="duplicate job_id"):
        sim.ClusterSim(catalog, fair).run([job, job])
    with pytest.raises(RuntimeError, match="passed the horizon"):
        sim.ClusterSim(catalog, fair).run(
            [sim.SimJob("a", "sim-chip", 100.0, arrival_s=50.0)], horizon_s=10.0)
