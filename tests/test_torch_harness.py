"""Shared harness for the port's parity tests, plus its own checks.

The JAX reference's ``swim_sim`` and ``SimCluster`` do not import in a
process with jax 0.9 unless two runtime patches are applied (an alias
for ``pltpu.TPUMemorySpace`` and a ``__contains__`` on the batching
proxy).  Those patches are process-global, so they are applied only in
a child process: ``run_reference`` runs a list of cluster cases there
and returns each case's trajectory (per-tick state, metrics, keys, net
and checksums; ``pre{t}`` is the state a tick op starts from) as
numpy arrays.  ``run_port`` drives the port through
the same ops, and ``assert_same_trajectory`` compares the two exactly.

A case is ``{"name", "n", "params", "seed", "init", "checksums",
"ops"}``; each op is ``["tick", k]`` or a ``SimCluster`` method name
with its arguments (``["kill", 3]``, ``["partition", [[0, 1], [2]]]``,
``["heal_partition"]``, ...), the same on both sides.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STATE_FIELDS = ("view_key", "pb", "suspect_left", "tick")

_REFERENCE = r"""
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
if not hasattr(pltpu, "TPUMemorySpace"):
    pltpu.TPUMemorySpace = pltpu.MemorySpace
from jax._src.interpreters import batching
type(batching.primitive_batchers).__contains__ = lambda self, key: True
from ringpop_tpu.models import swim_sim as sim
from ringpop_tpu.models.cluster import SimCluster

with open(sys.argv[1]) as f:
    cases = json.load(f)
out = {}
for case in cases:
    name = case["name"]
    c = SimCluster(case["n"], sim.SwimParams(**case.get("params", {})),
                   seed=case.get("seed", 0), init=case.get("init", "converged"))
    snaps = []
    def snap():
        snaps.append({f: np.asarray(getattr(c.state, f)) for f in
                      ("view_key", "pb", "suspect_left", "tick")})
    snap()
    t = 0
    for op in case["ops"]:
        if op[0] != "tick":
            getattr(c, op[0])(*op[1:])
            continue
        for f in ("view_key", "pb", "suspect_left", "tick"):
            out[f"{name}/pre{t}/{f}"] = np.asarray(getattr(c.state, f))
        out[f"{name}/key{t}"] = np.asarray(c.key)
        out[f"{name}/up{t}"] = np.asarray(c.net.up)
        out[f"{name}/responsive{t}"] = np.asarray(c.net.responsive)
        if c.net.adj is not None:
            out[f"{name}/adj{t}"] = np.asarray(c.net.adj)
        for k, v in c.tick(op[1]).items():
            out[f"{name}/m{t}/{k}"] = np.asarray(v)
        snap()
        if case.get("checksums"):
            ck = c.checksums()
            out[f"{name}/ck{t}_addr"] = np.array(list(ck), dtype=object).astype(str)
            out[f"{name}/ck{t}_val"] = np.array(list(ck.values()), dtype=np.int64)
        t += 1
    for f in ("view_key", "pb", "suspect_left", "tick"):
        out[f"{name}/{f}"] = np.stack([s[f] for s in snaps])
np.savez_compressed(sys.argv[2], **out)
"""


def run_reference(cases: list[dict], tmp_dir: str) -> dict[str, np.ndarray]:
    """Run ``cases`` through the JAX reference in a child process."""
    spec = os.path.join(tmp_dir, "cases.json")
    out = os.path.join(tmp_dir, "reference.npz")
    with open(spec, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, spec, out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def port_cluster(case: dict):
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.models.cluster import SimCluster

    return SimCluster(
        case["n"], tsim.SwimParams(**case.get("params", {})),
        seed=case.get("seed", 0), init=case.get("init", "converged"), device="cpu",
    )


def run_port(case: dict, on_tick=None) -> list[dict]:
    """Drive the port's ``SimCluster`` on the CPU through ``case["ops"]``;
    returns one record per tick op: state after it and its metrics.
    ``on_tick(t, cluster)`` runs after each tick op."""
    c = port_cluster(case)
    recs = []
    for op in case["ops"]:
        if op[0] != "tick":
            getattr(c, op[0])(*op[1:])
            continue
        m = c.tick(op[1])
        recs.append({"metrics": m, **{f: c.state._asdict()[f].numpy() for f in STATE_FIELDS}})
        if on_tick is not None:
            on_tick(len(recs) - 1, c)
    return recs


def assert_same_trajectory(ref: dict[str, np.ndarray], case: dict, recs: list[dict]) -> None:
    """Every state field and metric equal on every tick op."""
    name = case["name"]
    for t, rec in enumerate(recs):
        for f in STATE_FIELDS:
            want = ref[f"{name}/{f}"][t + 1]
            np.testing.assert_array_equal(rec[f], want, err_msg=f"{name}: {f} at tick op {t}")
        want_m = {
            k.rsplit("/", 1)[1]: int(v) for k, v in ref.items()
            if k.startswith(f"{name}/m{t}/")
        }
        got_m = {k: v for k, v in rec["metrics"].items() if k != "ticks"}
        assert got_m == {k: v for k, v in want_m.items() if k != "ticks"}, (name, t)


# ---------------------------------------------------------------------------
# checks of the port's boundary
# ---------------------------------------------------------------------------

_PORT_MODULES = (
    "ringpop_tpu_torch",
    "ringpop_tpu_torch.prng",
    "ringpop_tpu_torch._build",
    "ringpop_tpu_torch.convert",
    "ringpop_tpu_torch.ops.recv_merge",
    "ringpop_tpu_torch.ops.farmhash",
    "ringpop_tpu_torch.ops.checksum_device",
    "ringpop_tpu_torch.models.swim_sim",
    "ringpop_tpu_torch.models.checksum",
    "ringpop_tpu_torch.models.cluster",
)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ringpop_tpu' or m.startswith('ringpop_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "ringpop_tpu." not in src.replace("ringpop_tpu_torch", "")


def test_no_cuda_raises(monkeypatch):
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.models.cluster import SimCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimCluster(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.init_state(8)


def test_kernels_refuse_without_their_build(monkeypatch):
    """A CUDA tensor never reaches a plain version: with no nvcc the
    wrapper raises instead of falling back."""
    from ringpop_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("recv_merge")


def test_convert_round_trip():
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_sim as tsim

    st = tsim.init_state(6, [0, 1, 2, 3, 4, 5], device="cpu")
    back = convert.state_from_numpy(convert.state_to_numpy(st), device="cpu")
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st, f), getattr(back, f))
        assert getattr(st, f).dtype == getattr(back, f).dtype
    net = tsim.make_net(6, partitioned=True, device="cpu")
    net2 = convert.net_from_numpy(convert.net_to_numpy(net), device="cpu")
    assert torch.equal(net.adj, net2.adj)
    key = np.array([1, 4294967295], dtype=np.uint32)
    assert (convert.key_to_numpy(convert.key_from_numpy(key)) == key).all()
    with pytest.raises(NotImplementedError):
        convert.net_from_numpy({**convert.net_to_numpy(net), "po_press": np.zeros(6)}, "cpu")
