"""The serving plane: compiled key workloads served against per-viewer
hash rings derived from the simulated membership state.

The port of ``ringpop_tpu/traffic``: fixed-shape workload generators
producing pre-hashed key tensors (``workloads``), masked ring lookups
and the handle-or-forward chain (``engine``), the SLO latency model
(``latency``), run inside the scenario runner so lookups happen under
churn.
"""

from ringpop_tpu_torch.traffic.workloads import (  # noqa: F401
    CompiledTraffic,
    WorkloadSpec,
    compile_traffic,
)
from ringpop_tpu_torch.traffic.engine import (  # noqa: F401
    TrafficStatic,
    TrafficTensors,
    counter_names,
    in_ring_from_rows,
    lookup_masked_idx,
    lookup_n_masked_idx,
    plane_names,
    sample_tick,
    serve_once,
    serve_tick,
)
from ringpop_tpu_torch.traffic import latency  # noqa: F401
