"""Request forwarding on the in-process transport, the reference against
the port in process.

Every case of the reference's ``test_proxy.py`` (handleOrProxy and
handleOrProxyAll, retries and reroutes, the checksum gate, key
divergence, a custom endpoint, destroy) runs on the reference's
``harness.Cluster`` and on the port's ``Cluster(device="cpu")``, both in
this process.  Each case keeps the reference test's assertions, which
both sides must pass, and returns what it observed: the responses, the
events, the virtual time, every node's member list and ring.  The two
observations must be equal.
"""

from __future__ import annotations

import json
import types

import pytest

import ringpop_tpu.errors as ref_errors
import ringpop_tpu.harness as ref_harness
import ringpop_tpu.hashring as ref_hashring
import ringpop_tpu.request_proxy.http as ref_http
from ringpop_tpu_torch import errors as port_errors
from ringpop_tpu_torch import harness as port_harness
from ringpop_tpu_torch import hashring as port_hashring
from ringpop_tpu_torch.request_proxy import http as port_http

REF = types.SimpleNamespace(harness=ref_harness, errors=ref_errors, http=ref_http,
                            HashRing=ref_hashring.HashRing, kw={})
PORT = types.SimpleNamespace(harness=port_harness, errors=port_errors, http=port_http,
                             HashRing=port_hashring.HashRing, kw={"device": "cpu"})


def converged_cluster(pkg, size=3, **kw):
    c = pkg.harness.Cluster(size=size, **kw, **pkg.kw)
    c.bootstrap_all(run=False)
    assert c.run_until_converged(60000)
    return c


def cluster_view(c) -> dict:
    return {
        "now": c.scheduler.now(),
        "messages": c.network.message_count,
        "nodes": [
            ([(m.address, m.status, m.incarnation_number) for m in n.membership.members],
             n.membership.checksum, n.ring.checksum, list(n.ring.servers))
            for n in c.nodes
        ],
    }


def response(done) -> list:
    return [(type(err).__name__ if err else None, resp.status_code, resp.body,
             dict(resp.headers)) for err, resp in done]


def key_owned_by(node):
    for i in range(10000):
        key = f"key-{i}"
        if node.lookup(key) == node.whoami():
            return key
    raise AssertionError("no key found")


def key_not_owned_by(node):
    for i in range(10000):
        key = f"key-{i}"
        if node.lookup(key) != node.whoami():
            return key
    raise AssertionError("no key found")


def handle_or_proxy_local(pkg):
    c = converged_cluster(pkg)
    node = c.nodes[0]
    key = key_owned_by(node)
    res = pkg.http.ProxyResponse()
    assert node.handle_or_proxy(key, pkg.http.ProxyRequest(url="/x", method="GET"), res) is True
    out = key, cluster_view(c)
    c.destroy_all()
    return out


def handle_or_proxy_remote(pkg):
    c = converged_cluster(pkg)
    node = c.nodes[0]
    key = key_not_owned_by(node)
    dest = node.lookup(key)
    dest_node = next(n for n in c.nodes if n.whoami() == dest)

    def on_request(req, res, head):
        assert head["ringpopKeys"] == [key]
        assert (req.url, req.method, req.body) == ("/resource", "POST", "hello")
        res.set_header("x-handled-by", dest)
        res.status_code = 201
        res.end("created")

    dest_node.on("request", on_request)
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append((err, resp)))
    req = pkg.http.ProxyRequest(url="/resource", method="POST", body="hello")
    assert node.handle_or_proxy(key, req, res) is None
    c.run(1000)
    assert done and done[0][0] is None
    assert done[0][1].status_code == 201 and done[0][1].body == "created"
    assert done[0][1].headers["x-handled-by"] == dest
    out = response(done), cluster_view(c)
    c.destroy_all()
    return out


def checksum_gate(pkg):
    c = converged_cluster(pkg)
    receiver = c.nodes[1]
    head = {"url": "/x", "headers": {}, "method": "GET", "httpVersion": "1.1",
            "ringpopChecksum": 12345, "ringpopKeys": ["k"]}
    out = []
    receiver.request_proxy.handle_request(head, b"", lambda err, *r: out.append(err))
    assert getattr(out[0], "type", None) == "ringpop.request-proxy.invalid-checksum"
    receiver.request_proxy.enforce_consistency = False
    got = []
    receiver.on("request", lambda req, res, h: (res.end("ok"), got.append(1)))
    out2 = []
    receiver.request_proxy.handle_request(head, b"", lambda err, *r: out2.append((err, r)))
    assert out2[0][0] is None and got
    result = (str(out[0]), out2[0][1], cluster_view(c))
    c.destroy_all()
    return result


def retry_reroutes(pkg):
    c = converged_cluster(pkg, 3)
    node = c.nodes[0]
    key = key_not_owned_by(node)
    dest = node.lookup(key)
    served = []
    for n in c.nodes:
        n.on("request",
             lambda req, res, head, who=n.whoami(): (served.append(who), res.end("ok")))
    c.kill(c.host_ports.index(dest))
    c.run(30000)
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append((err, resp)))
    ret = node.handle_or_proxy(key, pkg.http.ProxyRequest(url="/y"), res)
    if ret is not True:
        c.run(60000)
        assert done and done[0][0] is None and done[0][1].body == "ok"
        assert served and served[0] != dest
    out = ret, served, response(done), cluster_view(c)
    c.destroy_all()
    return out


def _dead_owner(pkg, stop_gossip=True, **kw):
    c = converged_cluster(pkg, 3, **kw)
    node = c.nodes[0]
    key = key_not_owned_by(node)
    dest = node.lookup(key)
    if stop_gossip:
        for n in c.nodes:
            n.gossip.stop()
    c.kill(c.host_ports.index(dest))
    return c, node, key, dest


def max_retries_exceeded(pkg):
    c, node, key, dest = _dead_owner(pkg, latency_ms=1.0)
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append((err, resp)))
    node.proxy_req({"keys": [key], "dest": dest, "req": pkg.http.ProxyRequest(url="/z"),
                    "res": res, "maxRetries": 2, "retrySchedule": [0, 0.01]})
    c.run(60000)
    assert done and done[0][0] is None and done[0][1].status_code == 500
    out = response(done), cluster_view(c)
    c.destroy_all()
    return out


def no_retries_mode(pkg):
    c, node, key, dest = _dead_owner(pkg)
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append((err, resp)))
    node.proxy_req({"keys": [key], "dest": dest, "req": pkg.http.ProxyRequest(), "res": res,
                    "maxRetries": 0})
    c.run(10000)
    assert done and done[0][1].status_code == 500
    out = response(done), cluster_view(c)
    c.destroy_all()
    return out


def handle_or_proxy_all(pkg):
    c = converged_cluster(pkg, 3)
    node = c.nodes[0]
    keys = [f"key-{i}" for i in range(20)]
    for n in c.nodes:
        n.on("request", lambda req, res, head: res.end(json.dumps(head["ringpopKeys"])))
    done = []
    node.handle_or_proxy_all({"keys": keys, "req": pkg.http.ProxyRequest(url="/all")},
                             lambda err, responses: done.append((err, responses)))
    c.run(5000)
    assert done and done[0][0] is None
    all_keys = []
    for r in done[0][1]:
        all_keys.extend(r["keys"])
        assert r["dest"] == node.lookup(r["keys"][0])
    assert sorted(all_keys) == sorted(keys)
    out = ([(r["dest"], r["keys"], r["res"].body) for r in done[0][1]], cluster_view(c))
    c.destroy_all()
    return out


def proxy_req_validates(pkg):
    c = converged_cluster(pkg, 1)
    with pytest.raises(pkg.errors.PropertyRequiredError) as e1:
        c.nodes[0].proxy_req({"keys": ["k"], "dest": "x"})
    with pytest.raises(pkg.errors.OptionsRequiredError) as e2:
        c.nodes[0].proxy_req(None)
    c.destroy_all()
    return str(e1.value), str(e2.value)


def two_keys_that_diverge(pkg, cluster, owner):
    scratch = pkg.HashRing(**pkg.kw)
    scratch.add_remove_servers([n.whoami() for n in cluster.nodes if n is not owner], [])
    by_new_owner = {}
    for i in range(20000):
        key = f"div-{i}"
        if owner.lookup(key) != owner.whoami():
            continue
        by_new_owner.setdefault(scratch.lookup(key), key)
        if len(by_new_owner) >= 2:
            return list(by_new_owner.values())[:2]
    raise AssertionError("no diverging key pair found")


def key_divergence_aborts(pkg):
    c = converged_cluster(pkg, 3)
    sender, owner = c.nodes[0], c.nodes[1]
    k1, k2 = two_keys_that_diverge(pkg, c, owner)
    assert sender.lookup(k1) == owner.whoami() == sender.lookup(k2)
    events = []
    sender.on("requestProxy.retryAborted", lambda *a: events.append("aborted"))
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append((err, resp)))
    c.kill(1)
    sender.proxy_req({"keys": [k1, k2], "dest": owner.whoami(),
                      "req": pkg.http.ProxyRequest(url="/multi", method="POST", body="payload"),
                      "res": res, "timeout": 500, "retrySchedule": [30.0]})
    c.run(120000)
    assert c.run_until_converged(60000)
    c.run(5000)
    assert done and done[0][0] is None and done[0][1].status_code == 500
    assert "diverged" in done[0][1].body and events == ["aborted"]
    assert sender.lookup(k1) != sender.lookup(k2)
    out = (k1, k2), response(done), cluster_view(c)
    c.destroy_all()
    return out


def endpoint_override(pkg):
    c = converged_cluster(pkg, 3)
    sender = c.nodes[0]
    key = key_not_owned_by(sender)
    dest = sender.lookup(key)
    dest_node = next(n for n in c.nodes if n.whoami() == dest)
    hits = []

    def custom_handler(head, body, src, respond):
        hits.append((json.loads(head)["url"], body))
        respond(None, json.dumps({"statusCode": 299, "headers": {}}), "custom-body")

    dest_node.channel.register({"/custom/forward": custom_handler})
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append((err, resp)))
    sender.proxy_req({"keys": [key], "dest": dest,
                      "req": pkg.http.ProxyRequest(url="/x", method="GET", body="b"),
                      "res": res, "endpoint": "/custom/forward"})
    c.run(2000)
    assert done[0][0] is None and hits and hits[0][0] == "/x"
    assert (done[0][1].status_code, done[0][1].body) == (299, "custom-body")
    out = hits, response(done), cluster_view(c)
    c.destroy_all()
    return out


def destroy_cancels_retries(pkg):
    c = converged_cluster(pkg, 3)
    sender = c.nodes[0]
    key = key_not_owned_by(sender)
    dest = sender.lookup(key)
    attempts = []
    sender.on("requestProxy.retryAttempted", lambda *a: attempts.append(1))
    done = []
    res = pkg.http.ProxyResponse(lambda err, resp: done.append(err))
    c.kill([n.whoami() for n in c.nodes].index(dest))
    sender.proxy_req({"keys": [key], "dest": dest,
                      "req": pkg.http.ProxyRequest(url="/x", method="GET"), "res": res,
                      "timeout": 500, "retrySchedule": [5.0]})
    c.run(1000)
    assert sender.request_proxy.sends, "send not tracked in-flight"
    sender.destroy()
    assert not sender.request_proxy.sends, "destroy left sends tracked"
    c.run(20000)
    assert attempts == []
    out = done, cluster_view(c)
    c.destroy_all()
    return out


CASES = [
    handle_or_proxy_local, handle_or_proxy_remote, checksum_gate, retry_reroutes,
    max_retries_exceeded, no_retries_mode, handle_or_proxy_all, proxy_req_validates,
    key_divergence_aborts, endpoint_override, destroy_cancels_retries,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_proxy_case_equals_reference(case):
    assert case(PORT) == case(REF)
