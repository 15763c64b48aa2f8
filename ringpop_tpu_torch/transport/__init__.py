"""Transport layer — the TChannel replacement.

The reference injects a TChannel subchannel and calls
``channel.request({host, timeout}).send(endpoint, head, body, cb)``
(lib/swim/ping-sender.js:57-99), with 14 endpoints registered server-side
(server/index.js:32-75).  ``InProcessNetwork`` / ``InProcessChannel``
pass messages deterministically in one process on the shared scheduler,
with latency and fault injection (drop/partition/pause/kill): the
test/sim harness transport.

The port of ``ringpop_tpu/transport/__init__.py``.  The reference's
``TcpChannel`` (``transport/tcp.py``) waits for ROADMAP queue 1 item 12 (b).
"""

from ringpop_tpu_torch.transport.inproc import InProcessChannel, InProcessNetwork, TimeoutError_

__all__ = ["InProcessChannel", "InProcessNetwork", "TimeoutError_"]
