"""Request forwarding ("handle-or-forward") — reference: lib/request-proxy/.

The port of ``ringpop_tpu/request_proxy/__init__.py``.
"""

from ringpop_tpu_torch.request_proxy.proxy import RequestProxy
from ringpop_tpu_torch.request_proxy.head import raw_head, str_head
from ringpop_tpu_torch.request_proxy.http import ProxyRequest, ProxyResponse

__all__ = ["RequestProxy", "raw_head", "str_head", "ProxyRequest", "ProxyResponse"]
