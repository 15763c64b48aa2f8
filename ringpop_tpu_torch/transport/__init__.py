"""Transport layer — the TChannel replacement.

The reference injects a TChannel subchannel and calls
``channel.request({host, timeout}).send(endpoint, head, body, cb)``
(lib/swim/ping-sender.js:57-99), with 14 endpoints registered server-side
(server/index.js:32-75).  This rebuild defines a minimal transport
interface with two implementations:

* ``InProcessNetwork`` / ``InProcessChannel`` — deterministic in-process
  message passing on the shared scheduler, with latency and fault
  injection (drop/partition/pause/kill) — the test/sim harness transport.
* ``TcpChannel`` (transport/tcp.py) — newline-delimited JSON frames over
  asyncio TCP for real multi-process clusters (CLI mode).

The port of ``ringpop_tpu/transport/__init__.py``.
"""

from ringpop_tpu_torch.transport.inproc import InProcessChannel, InProcessNetwork, TimeoutError_
from ringpop_tpu_torch.transport.tcp import TcpChannel

__all__ = ["InProcessChannel", "InProcessNetwork", "TcpChannel", "TimeoutError_"]
