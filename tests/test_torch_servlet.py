"""The port's REST service against the JAX package's, on the CPU.

Both packages' ``CruiseControlApp`` serve the same recipe (the JAX
package's ``tests/test_servlet.py`` server: a 4-broker simulated cluster,
the synthetic sampler; 4 chains x 40 SA steps, where that server runs 100)
on ``127.0.0.1:0``, the
port's façade on the CPU, with every request sent asynchronous at once
(``webserver.request.maxBlockTimeMs`` 0). The port's REST client drives
both: each endpoint answers 200 in the end (202 first where the work
outlasts the block time, which a dry-run ``rebalance`` always does), and
the JSON has the same keys (``state`` at every level); ``/metrics`` carries the ``compile-*`` and ``cost-*``
gauges, and the OpenAPI documents are equal. The JAX server is started
once, in a module fixture.
"""

from __future__ import annotations

import http.client
import time

import pytest

from ccx.config import CruiseControlConfig as JaxConfig
from ccx.executor.admin import SimulatedAdminClient as JaxAdmin
from ccx.executor.admin import SimulatedCluster as JaxSim
from ccx.service.facade import CruiseControl as JaxCruiseControl
from ccx.servlet.server import CruiseControlApp as JaxApp
from ccx_torch.client import CruiseControlClient
from ccx_torch.config import CruiseControlConfig
from ccx_torch.executor.admin import SimulatedAdminClient, SimulatedCluster
from ccx_torch.service.facade import CruiseControl
from ccx_torch.servlet.server import CruiseControlApp

#: blocks whose contents are not a schema: span trees (the port's spans
#: carry a ``compile`` block only where a kernel build ran), and maps keyed
#: by what the process has seen so far (fleet jobs; device-memory classes
#: and reasons)
OPAQUE = {"lastSpanTree", "convergence", "residentBytes", "residentCount", "evictions"}


def _serve(pkg: str, tmp: str):
    sim = (JaxSim if pkg == "jax" else SimulatedCluster)()
    for b in range(4):
        sim.add_broker(b, rack=f"r{b % 2}")
    sim.create_topic("t0", 8, 2, size_mb=10)
    props = {
        "metric.sampler.class": "ccx.monitor.sampling.sampler.SyntheticMetricSampler",
        "broker.capacity.config.resolver.class": "ccx.monitor.capacity.StaticCapacityResolver",
        "sample.store.dir": f"{tmp}/samples",
        "partition.metrics.window.ms": 1000,
        "num.partition.metrics.windows": 3,
        "broker.metrics.window.ms": 1000,
        "num.broker.metrics.windows": 3,
        "metric.sampling.interval.ms": 1000,
        "execution.progress.check.interval.ms": 20,
        "optimizer.num.chains": 4,
        "optimizer.num.steps": 40,
        "webserver.http.address": "127.0.0.1",
        "webserver.http.port": 0,
        "webserver.request.maxBlockTimeMs": 0,
    }
    clock = {"now": 0}
    kw = dict(clock=lambda: clock["now"], executor_waiter=lambda ms: sim.tick(int(ms)))
    if pkg == "jax":
        cfg = JaxConfig(props)
        cc = JaxCruiseControl(cfg, admin=JaxAdmin(sim), **kw)
    else:
        cfg = CruiseControlConfig(props)
        cc = CruiseControl(cfg, admin=SimulatedAdminClient(sim), device="cpu", **kw)
    cc.start_up(run_background_threads=False)
    for _ in range(5):
        clock["now"] += 1000
        cc.load_monitor.sample_once()
    app = (JaxApp if pkg == "jax" else CruiseControlApp)(cfg, cc, clock=lambda: clock["now"])
    host, port = app.start()
    return app, cc, CruiseControlClient(f"http://{host}:{port}", poll_interval_s=0.05,
                                        timeout_s=300)


def fetch(client, method: str, endpoint: str, params=None) -> tuple[list[int], dict]:
    """A request and its long-poll, with every status kept."""
    status, body, headers = client._request(method, endpoint, params)
    statuses, task = [status], headers.get("User-Task-ID")
    deadline = time.monotonic() + client.timeout_s
    while status == 202 and time.monotonic() < deadline:
        time.sleep(client.poll_interval_s)
        status, body, headers = client._request(method, endpoint, None, task_id=task)
        statuses.append(status)
    return statuses, body


def _keys(a, b, where):
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict) and isinstance(b[k], dict) and k not in OPAQUE:
            _keys(a[k], b[k], f"{where}.{k}")


#: (method, endpoint, params) of each compared request
REQUESTS = {
    "state": ("GET", "state", None),
    "load": ("GET", "load", None),
    "kafka_cluster_state": ("GET", "kafka_cluster_state", None),
    "proposals": ("GET", "proposals", None),
    "rebalance-dryrun": ("POST", "rebalance", {"dryrun": True, "reason": "parity"}),
    "openapi": ("GET", "openapi", None),
}


@pytest.fixture(scope="module")
def jax_answers(tmp_path_factory):
    app, cc, client = _serve("jax", str(tmp_path_factory.mktemp("jax")))
    try:
        yield {name: fetch(client, *req) for name, req in REQUESTS.items()}
    finally:
        app.stop()
        cc.shutdown()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    app, cc, client = _serve("port", str(tmp_path_factory.mktemp("port")))
    yield {"app": app, "cc": cc, "client": client}
    app.stop()
    cc.shutdown()


@pytest.mark.parametrize("name", list(REQUESTS))
def test_endpoint_answers_as_the_jax_service(jax_answers, port, name):
    jstatuses, jbody = jax_answers[name]
    statuses, body = fetch(port["client"], *REQUESTS[name])
    assert statuses[-1] == jstatuses[-1] == 200
    # a request answers 202 first unless it finished within
    # maxBlockTimeMs (0 here): a race for the quick reads
    assert {statuses[0], jstatuses[0]} <= {200, 202}
    if name == "state":
        _keys(jbody, body, "state")
    else:
        assert set(body) == set(jbody)
    if name == "rebalance-dryrun":
        assert statuses[0] == jstatuses[0] == 202
        assert body["dryRun"] is True and body["verified"]
    if name == "load":
        assert len(body["brokers"]) == 4


def _get_text(client, path: str) -> tuple[int, str, str]:
    host, port = client.base.split("//")[1].split("/")[0].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def test_metrics_carry_the_compile_and_cost_gauges(port):
    status, ctype, text = _get_text(port["client"], "/kafkacruisecontrol/metrics")
    assert status == 200 and "text/plain" in ctype
    names = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
             if ln and not ln.startswith("#")}
    assert any("compile" in n for n in names), sorted(names)[:20]
    assert any("cost" in n for n in names), sorted(names)[:20]


def test_openapi_document_equals_the_jax_services(jax_answers, port):
    statuses, body = fetch(port["client"], *REQUESTS["openapi"])
    assert statuses == jax_answers["openapi"][0] == [200]
    assert body == jax_answers["openapi"][1]
    assert "/kafkacruisecontrol/rebalance" in body["paths"]


def test_client_verbs_drive_the_ports_service(port):
    client = port["client"]
    assert client.state(("monitor",))["MonitorState"]["state"] == "RUNNING"
    assert client.kafka_cluster_state()["KafkaBrokerState"]["Summary"]["Brokers"] == 4
    res = client.rebalance(dryrun=True, reason="client")
    assert res["dryRun"] is True and res["verified"]
    assert client.partition_load(max_load_entries=3)["records"][2]["topic"] == "t0"
