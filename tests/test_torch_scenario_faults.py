"""Every fault family of the reference's failure model through the
compiled scenario runner, dense backend, against the JAX reference.

Each family of ``test_torch_faults.py`` (the parity cases of
``tests/test_faults.py`` at N = 10, ``SwimParams(suspicion_ticks=8)``,
seed 7: directed link loss, gray periods, a flap storm, a rolling
restart, delay with jitter, every family with a partition at once, and
every link delayed around a kill) runs through ``SimCluster.run_scenario``
on both sides; the trace, state (the in-flight buffer included), net
(the link rules mirrored at the last tick, the int16 period row), key,
loss and ``metrics_log`` entry must be equal.  ``compile_spec``'s
tensors (the fault tensors with their dtypes) and ``key_schedule`` are
held against the reference's on the acceptance scenario, the mixed
fault spec and the revive and suspend scenarios.
"""

from __future__ import annotations

import json

import pytest
import torch

from test_torch_faults import FAMILIES, FAST, MIXED, N
from test_torch_harness import (
    assert_same_scenario,
    port_cluster,
    run_port,
    run_reference,
    run_reference_script,
)
from test_torch_scenario_compiled import REVIVE, SPEC, SUSPEND

from ringpop_tpu_torch.scenarios import compile as tcompile
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

CASES = [
    {"name": name, "n": N, "params": FAST, "seed": 7, "ops": [["run_scenario", spec]]}
    for name, spec in FAMILIES.items()
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("scenario_faults_ref")))


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for c in CASES:
        scen: dict[int, dict] = {}
        run_port(c, scenarios=scen)
        out[c["name"]] = scen[0]
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_matches_reference(reference, port_runs, name):
    assert_same_scenario(reference, BY_NAME[name], 0, port_runs[name])


@pytest.mark.parametrize("name", ["delay", "mixed", "delay_each_tick"])
def test_delayed_claims_park(port_runs, name):
    """The delay families carry claims in the buffer; around the kill the
    matured claims apply (elsewhere they bring nothing new)."""
    trace = port_runs[name]["trace"]
    assert trace["m.delayed_claims"].sum() > 0
    assert (trace["m.matured_applied"].sum() > 0) == (name == "delay_each_tick")


def test_mixed_outcome():
    """tests/test_faults.py's mixed smoke at the reference's LEAN params:
    the flap and rolling restart dip the live count, every storm heals,
    the post-run net mirrors the closed windows (rules present, zeroed;
    period row back to ones) and the buffer stays installed."""
    import torch

    from test_torch_faults import MIXED

    c = port_cluster({"n": N, "params": {"suspicion_ticks": 8, "ping_req_size": 1}, "seed": 3})
    trace = c.run_scenario(MIXED)
    live = trace.live.tolist()
    assert live[4] == N - 1
    assert min(live[5:12]) <= N - 2
    assert live[-1] == N
    assert int(trace.metrics["delayed_claims"].sum()) > 0
    assert trace.converged[-1]
    assert c.net.link_src is not None and float(c.net.link_p.max()) == 0.0
    assert c.net.period.tolist() == [1] * N and c.net.period.dtype == torch.int16
    assert c.state.pending is not None and tuple(c.state.pending.shape) == (4, N, N)


# -- compile_spec and key_schedule --------------------------------------------

_COMPILE = r"""
import jax
from ringpop_tpu.scenarios import compile as scompile
from ringpop_tpu.scenarios.spec import ScenarioSpec

specs = ARGS
out = {}
for name, (d, n) in specs.items():
    c = scompile.compile_spec(ScenarioSpec.from_dict(d), n, base_loss=0.01)
    rec = {}
    for f, v in c._asdict().items():
        if f == "faults":
            rec[f] = None if v is None else {
                k: None if a is None else [np.asarray(a).tolist(), str(np.asarray(a).dtype)]
                for k, a in v._asdict().items()}
        elif hasattr(v, "dtype"):
            rec[f] = [np.asarray(v).tolist(), str(np.asarray(v).dtype)]
        else:
            rec[f] = None if v is None else json.loads(json.dumps(v))
    state = {"key": jax.random.PRNGKey(9)}
    def split():
        state["key"], sub = jax.random.split(state["key"])
        return sub
    rec["keys"] = np.asarray(scompile.key_schedule(split, c)).tolist()
    rec["kinds"] = [scompile.EV_KILL, scompile.EV_SUSPEND, scompile.EV_RESUME, scompile.EV_REVIVE]
    out[name] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""
COMPILE_SPECS = {"spec": (SPEC, 12), "mixed": (MIXED, N), "revive": (REVIVE, N),
                 "suspend": (SUSPEND, 6)}


@pytest.fixture(scope="module")
def compiled_reference(tmp_path_factory):
    args = json.dumps(json.dumps(COMPILE_SPECS))
    code = f"\nARGS = json.loads({args})\n" + _COMPILE
    return run_reference_script(code, str(tmp_path_factory.mktemp("compile_ref")))


def _as_json(v):
    if torch.is_tensor(v):
        return [v.cpu().numpy().tolist(), str(v.cpu().numpy().dtype)]
    return None if v is None else json.loads(json.dumps(v))


@pytest.mark.parametrize("name", list(COMPILE_SPECS))
def test_compile_spec_and_key_schedule(compiled_reference, name):
    """Every field of ``CompiledScenario`` (the fault tensors with their
    dtypes) and the per-tick key schedule from one start key."""
    from ringpop_tpu_torch import prng

    want = compiled_reference[name]
    spec, n = COMPILE_SPECS[name]
    c = tcompile.compile_spec(ScenarioSpec.from_dict(spec), n, base_loss=0.01, device="cpu")
    for f, v in c._asdict().items():
        if f == "faults":
            got = None if v is None else {k: _as_json(a) for k, a in v._asdict().items()}
        else:
            got = _as_json(v)
        assert got == want[f], f
    key = {"k": prng.PRNGKey(9)}

    def split():
        key["k"], sub = prng.split(key["k"])
        return sub

    keys = tcompile.key_schedule(split, c)
    assert keys.shape == (c.ticks, 2)
    assert keys.tolist() == want["keys"]
    assert [tcompile.EV_KILL, tcompile.EV_SUSPEND, tcompile.EV_RESUME,
            tcompile.EV_REVIVE] == want["kinds"]
