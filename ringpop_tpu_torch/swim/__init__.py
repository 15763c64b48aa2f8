"""SWIM protocol engine: gossip loop, probes, indirect probes, joins.

Reference layer: lib/swim/* (gossip.js, suspicion.js, ping-sender.js,
ping-req-sender.js, join-sender.js, join-response-merge.js).

The port of ``ringpop_tpu/swim/__init__.py``.
"""

from ringpop_tpu_torch.swim.ping_sender import send_ping
from ringpop_tpu_torch.swim.ping_req_sender import send_ping_req
from ringpop_tpu_torch.swim.join_sender import join_cluster, create_joiner

__all__ = ["send_ping", "send_ping_req", "join_cluster", "create_joiner"]
