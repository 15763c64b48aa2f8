"""Scenarios: declarative fault timelines, run in one call per backend.

The port of ``ringpop_tpu/scenarios``:

* ``spec``    — the declarative ``ScenarioSpec`` and the ``--script``
  mini-DSL compiler into it;
* ``compile`` — ``ScenarioSpec -> CompiledScenario`` tensors and the
  segment-exact key schedule;
* ``faults``  — directed link loss, latency and jitter, gray periods:
  the tensors of the compiled runner and the plan of the host loop;
* ``runner``  — ``run_compiled``, the whole timeline in one call with
  per-tick telemetry, and its host-loop twin ``run_host_loop``;
* ``trace``   — the stacked telemetry, its ``.npz`` form and summary;
* ``stream``  — S-tick segments, the segment store, checkpoints every
  segment and ``resume``, and the streamed sweep;
* ``sweep``   — R replicas of a scenario (seed, loss scale, kill and
  flap jitter, protocol knobs), with the stacked ``SweepTrace``;
* ``library`` — the named incidents (a fault timeline and its serving
  workload each), their detect/heal/serve summary and the golden
  configuration pinned under ``tests/golden/incidents/``.

Entry points: ``SimCluster.run_scenario(spec[, segment_ticks=S,
param_knobs=...])``, ``SimCluster.run_sweep(spec, replicas)`` and
``stream.resume(checkpoint)``.
"""

from ringpop_tpu_torch.scenarios.spec import Event, ScenarioSpec, script_to_spec
from ringpop_tpu_torch.scenarios.compile import CompiledScenario, compile_spec
from ringpop_tpu_torch.scenarios.faults import (
    FaultTensors,
    HostPlan,
    LinkRule,
    compile_faults,
    delay_depth,
    link_rules,
    period_switches,
)
from ringpop_tpu_torch.scenarios.trace import Trace
from ringpop_tpu_torch.scenarios.runner import run_compiled, run_host_loop
from ringpop_tpu_torch.scenarios.sweep import (
    CompiledSweep,
    SweepTrace,
    compile_sweep,
    replica_spec,
    run_sweep_compiled,
)
from ringpop_tpu_torch.scenarios.stream import (
    SegmentStore,
    StreamInterrupted,
    resume,
    run_streamed,
    run_sweep_streamed,
)
from ringpop_tpu_torch.scenarios.library import (
    INCIDENTS,
    Incident,
    build_incident,
    incident_names,
    incident_summary,
)

__all__ = [
    "Event",
    "ScenarioSpec",
    "script_to_spec",
    "CompiledScenario",
    "compile_spec",
    "FaultTensors",
    "HostPlan",
    "LinkRule",
    "compile_faults",
    "delay_depth",
    "link_rules",
    "period_switches",
    "Trace",
    "run_compiled",
    "run_host_loop",
    "CompiledSweep",
    "SweepTrace",
    "compile_sweep",
    "replica_spec",
    "run_sweep_compiled",
    "SegmentStore",
    "StreamInterrupted",
    "resume",
    "run_streamed",
    "run_sweep_streamed",
    "INCIDENTS",
    "Incident",
    "build_incident",
    "incident_names",
    "incident_summary",
]
