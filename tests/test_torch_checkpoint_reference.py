"""The port loads the JAX reference's checkpoints.

One child process writes checkpoints with the reference's
``checkpoint.save`` (dense with a scenario trace and a log, delta with
the in-flight lanes, delta with the carried slot-base planes built
under ``RINGPOP_CARRY_SLOTBASE=1``, and a streamed soak's mid-run
checkpoint), records each cluster (every array with its dtype, key,
log, traces, cursor), ticks 3 and records it again.  The port's
``checkpoint.load`` must see each file as the reference's cluster was,
and continue it alike.  The other direction is
``test_torch_checkpoint.py``.
"""

from __future__ import annotations

import pytest

from test_torch_checkpoint import dump, reference_checkpoints, tick3

from ringpop_tpu_torch import checkpoint


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference_checkpoints")
    return reference_checkpoints({}, str(d), str(d))


@pytest.mark.parametrize("name", ["dense", "delta", "carry"])
def test_port_loads_reference_checkpoint(ref, name):
    """The port reads what the reference wrote as the reference's cluster
    was, and continues it as the reference did."""
    want = ref["written"][name]
    c = checkpoint.load(want["path"], device="cpu")
    assert dump(c) == want["dump"]
    assert tick3(c) == {"after": want["after"], "metrics": want["metrics"]}


def test_port_loads_reference_mid_soak(ref):
    """A reference soak's mid-run checkpoint: its state, net and cursor."""
    want = ref["written"]["soak"]
    c = checkpoint.load(want["path"], device="cpu")
    assert dump(c) == want["dump"]
    assert c.stream_cursor["ticks_done"] == 4
