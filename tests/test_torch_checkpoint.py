"""The port's checkpoints (``ringpop_tpu_torch/checkpoint.py``, format v5)
against the JAX reference's, both ways.

The port writes checkpoints (dense with traces and a log, delta with
the in-flight lanes, delta with the carried slot-base planes, a
streamed run's mid-soak checkpoint), and edits of them into the older
forms the loaders backfill: a v4 file without a cursor, a v3 file
without telemetry, a pre-digest delta file, a delta file with its
planes unpacked to bool, and a v2 dense file without ``probe``.  One
child process loads each with the reference's ``checkpoint.load``,
records every array (with its dtype), the key, log, traces and cursor,
ticks 3 and records the state and metrics; the port must see each file
alike, and ``save -> load -> tick`` must continue the run.  The other
direction is ``test_torch_checkpoint_reference.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from test_torch_faults import DELAY
from test_torch_faults_delta import TIGHT
from test_torch_harness import port_cluster, run_reference_script
from test_torch_scenario_compiled import SUSPEND

from ringpop_tpu_torch import checkpoint, convert
from ringpop_tpu_torch.scenarios import stream as tstream

DENSE = {"n": 8, "params": {"suspicion_ticks": 5, "loss": 0.05}, "seed": 5}
DELTA = {"n": 10, "params": {"suspicion_ticks": 8}, "seed": 7, "backend": "delta", "caps": TIGHT}
SOAK = {"ticks": 12, "events": [{"at": 3, "op": "kill", "node": 2}]}

# the child: load every file given, dump it, tick 3 and dump again; with
# an output directory, write the reference's own checkpoints there and
# dump those clusters
_CHILD = r"""
import os
from ringpop_tpu import checkpoint
from ringpop_tpu.models import swim_sim as sim
from ringpop_tpu.models.cluster import SimCluster
from ringpop_tpu.scenarios import stream

files, out_dir, dense, delta, soak, suspend, delay = ARGS

def arr(a):
    a = np.asarray(a)
    return [a.tolist(), str(a.dtype)]

def dump(c):
    return {
        "state": {f: arr(v) for f, v in c.state._asdict().items() if v is not None},
        "net": {f: arr(v) for f, v in c.net._asdict().items() if v is not None},
        "key": arr(c.key),
        "params": c.params._asdict(),
        "log": [dict(e) for e in c.metrics_log],
        "traces": [[t.meta(), {k: arr(v) for k, v in t.to_arrays().items()}] for t in c.traces],
        "cursor": getattr(c, "stream_cursor", None),
    }

def tick3(c):
    m = c.tick(3)
    return {"after": dump(c), "metrics": {k: int(v) for k, v in m.items()}}

def build(case):
    return SimCluster(case["n"], sim.SwimParams(**case["params"]), seed=case["seed"],
                      backend=case.get("backend", "dense"), **case.get("caps", {}))

res = {"loaded": {}, "written": {}}
for name, path in files.items():
    c = checkpoint.load(path)
    res["loaded"][name] = {"dump": dump(c), **tick3(c)}
if out_dir is not None:
    # the reference's own checkpoints
    c = build(dense)
    c.tick(3)
    c.run_scenario(suspend)
    p = os.path.join(out_dir, "ref-dense.npz")
    checkpoint.save(c, p)
    res["written"]["dense"] = {"path": p, "dump": dump(c), **tick3(c)}
    c = build(delta)
    c.run_scenario(delay)
    p = os.path.join(out_dir, "ref-delta.npz")
    checkpoint.save(c, p)
    res["written"]["delta"] = {"path": p, "dump": dump(c), **tick3(c)}
    os.environ["RINGPOP_CARRY_SLOTBASE"] = "1"
    c = build(delta)
    c.tick(3)
    del os.environ["RINGPOP_CARRY_SLOTBASE"]
    p = os.path.join(out_dir, "ref-carry.npz")
    checkpoint.save(c, p)
    res["written"]["carry"] = {"path": p, "dump": dump(c), **tick3(c)}
    c = build(dense)
    p = os.path.join(out_dir, "ref-soak.npz")
    try:
        stream.run_streamed(c, soak, segment_ticks=4, checkpoint_path=p, interrupt_after=1)
    except stream.StreamInterrupted:
        pass
    res["written"]["soak"] = {"path": p, "dump": dump(checkpoint.load(p))}
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
"""


def _arr(a) -> list:
    a = np.asarray(a)
    return [a.tolist(), str(a.dtype)]


def dump(c) -> dict:
    """The child's ``dump`` of a port cluster: every field under the
    reference's names and dtypes."""
    state = (convert.delta_state_to_numpy(c.state) if c.backend == "delta"
             else convert.state_to_numpy(c.state))
    return {
        "state": {f: _arr(v) for f, v in state.items() if v is not None},
        "net": {f: _arr(v) for f, v in convert.net_to_numpy(c.net).items() if v is not None},
        "key": _arr(convert.key_to_numpy(c.key)),
        "params": c.params._asdict(),
        "log": [dict(e) for e in c.metrics_log],
        "traces": [[t.meta(), {k: _arr(v) for k, v in t.to_arrays().items()}] for t in c.traces],
        "cursor": c.stream_cursor,
    }


def tick3(c) -> dict:
    m = c.tick(3)
    return {"after": dump(c), "metrics": m}


def _rewrite(src: str, dst: str, edit) -> str:
    """A copy of checkpoint ``src`` at ``dst`` with ``edit(arrays, meta)``
    applied."""
    data = dict(np.load(src, allow_pickle=False))
    meta = json.loads(bytes(data["meta"]).decode())
    edit(data, meta)
    data["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(dst, **data)
    return dst


def _port_files(d) -> dict[str, str]:
    """The port's checkpoints and their older forms."""
    from ringpop_tpu_torch.models import swim_delta as tdelta

    files = {}
    c = port_cluster(DENSE)
    c.tick(2)
    c.run_scenario(SUSPEND)
    files["dense"] = str(d / "dense.npz")
    checkpoint.save(c, files["dense"])
    c = port_cluster(DELTA)
    c.run_scenario(DELAY)
    files["delta"] = str(d / "delta.npz")
    checkpoint.save(c, files["delta"])
    c = port_cluster(DELTA)
    c.state = tdelta._with_slot_base(c.state)
    c.tick(4)
    files["carry"] = str(d / "carry.npz")
    checkpoint.save(c, files["carry"])
    c = port_cluster(DENSE)
    files["soak"] = str(d / "soak.npz")
    with pytest.raises(tstream.StreamInterrupted):
        tstream.run_streamed(c, SOAK, segment_ticks=4, checkpoint_path=files["soak"],
                             interrupt_after=1)

    def v4(data, meta):
        meta["version"] = 4

    def v3(data, meta):
        meta["version"] = 3
        del meta["metrics_log"], meta["traces"]
        for k in [k for k in data if k.startswith("trace")]:
            del data[k]

    def predigest(data, meta):
        for k in ("state.digest", "state.d_bpmask", "state.d_bprank"):
            data.pop(k, None)

    def unpacked(data, meta):
        from ringpop_tpu_torch.ops import bitpack

        import torch

        for k, length in (("state.bp_mask", meta["n"]), ("state.d_bpmask", meta["caps"]["capacity"])):
            words = torch.from_numpy(data[k].astype(np.int64))
            data[k] = bitpack.unpack_bits(words, length).numpy()

    def v2(data, meta):
        meta["version"] = 2
        del meta["params"]["probe"]

    files["v4"] = _rewrite(files["dense"], str(d / "v4.npz"), v4)
    files["v3"] = _rewrite(files["dense"], str(d / "v3.npz"), v3)
    files["predigest"] = _rewrite(files["delta"], str(d / "predigest.npz"), predigest)
    files["unpacked"] = _rewrite(files["carry"], str(d / "unpacked.npz"), unpacked)
    files["v2"] = _rewrite(files["dense"], str(d / "v2.npz"), v2)
    return files


def reference_checkpoints(files: dict[str, str], out_dir: str | None, tmp_dir: str) -> dict:
    """The child's record of loading ``files`` (and, with ``out_dir``, of
    the checkpoints it writes there)."""
    args = json.dumps(json.dumps([files, out_dir, DENSE, DELTA, SOAK, SUSPEND, DELAY]))
    return run_reference_script(f"\nARGS = json.loads({args})\n" + _CHILD, tmp_dir)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkpoints")
    files = _port_files(d)
    return files, reference_checkpoints(files, None, str(d))


PORT_FILES = ["dense", "delta", "carry", "soak", "v4", "v3", "predigest", "unpacked", "v2"]


@pytest.mark.parametrize("name", PORT_FILES)
def test_reference_loads_port_checkpoint(sides, name):
    """The reference reads what the port wrote as the port reads it, every
    array with its dtype, and both continue it alike for 3 ticks."""
    files, ref = sides
    want = ref["loaded"][name]
    c = checkpoint.load(files[name], device="cpu")
    assert dump(c) == want["dump"]
    assert tick3(c) == {"after": want["after"], "metrics": want["metrics"]}


def test_backfills(sides):
    """The older forms load with the reference's backfills: no cursor
    before v5 (and ``resume`` refuses), empty telemetry before v4, the
    digest recomputed, bool planes packed, ``probe="uniform"`` for v2."""
    files, _ = sides
    assert checkpoint.load(files["v4"], device="cpu").stream_cursor is None
    with pytest.raises(ValueError, match="no stream cursor"):
        tstream.resume(files["v4"], device="cpu")
    old = checkpoint.load(files["v3"], device="cpu")
    assert old.metrics_log == [] and old.traces == []
    new = checkpoint.load(files["delta"], device="cpu")
    pre = checkpoint.load(files["predigest"], device="cpu")
    assert pre.state.digest.tolist() == new.state.digest.tolist()
    assert pre.state.d_bpmask is None
    carry = checkpoint.load(files["carry"], device="cpu")
    unpacked = checkpoint.load(files["unpacked"], device="cpu")
    assert unpacked.state.bp_mask.tolist() == carry.state.bp_mask.tolist()
    assert unpacked.state.d_bpmask.tolist() == carry.state.d_bpmask.tolist()
    assert checkpoint.load(files["v2"], device="cpu").params.probe == "uniform"
    assert checkpoint.load(files["dense"], device="cpu").params.probe == "sweep"


def test_save_load_tick_continues(tmp_path):
    """``save -> load -> tick(k)`` equals ``tick(k)`` on the original, on
    both backends, and the file is written atomically (no ``.tmp``
    left)."""
    for case in (DENSE, DELTA):
        a = port_cluster(case)
        a.tick(3)
        path = str(tmp_path / "c.npz")
        checkpoint.save(a, path)
        assert not (tmp_path / "c.npz.tmp").exists()
        b = checkpoint.load(path, device="cpu")
        assert dump(b) == dump(a)
        assert tick3(a) == tick3(b)


def test_unsupported_version_and_missing_array(tmp_path):
    a = port_cluster(DENSE)
    path = str(tmp_path / "c.npz")
    checkpoint.save(a, path)

    def v9(data, meta):
        meta["version"] = 9

    def no_view(data, meta):
        del data["state.view_key"]

    with pytest.raises(ValueError, match="unsupported checkpoint version 9"):
        checkpoint.load(_rewrite(path, str(tmp_path / "v9.npz"), v9), device="cpu")
    with pytest.raises(KeyError, match="state.view_key"):
        checkpoint.load(_rewrite(path, str(tmp_path / "nv.npz"), no_view), device="cpu")


def test_no_card_raises(tmp_path, monkeypatch):
    """With no card visible and no device named, loading a checkpoint,
    resuming a soak and compiling a scenario raise rather than run on
    the CPU."""
    import torch

    from ringpop_tpu_torch.scenarios import compile as tcompile
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    path = str(tmp_path / "c.npz")
    checkpoint.save(port_cluster(DENSE), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.resume(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcompile.compile_spec(ScenarioSpec.from_dict(SOAK), DENSE["n"])
