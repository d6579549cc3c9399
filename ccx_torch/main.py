"""Service entry point: ``python -m ccx_torch``.

The port's counterpart of the JAX package's ``main.py`` (parity:
``KafkaCruiseControlMain.java``, SURVEY.md C22, call stack 3.1): parse the
properties file, build the façade (monitor → analyzer → executor →
detector) on the CUDA device, start the REST server, serve until SIGINT or
SIGTERM.

Usage::

    python -m ccx_torch [config/cruisecontrol.properties] [port] [hostname] [--device cpu]

The card is probed first (``ccx_torch.device.ensure_responsive_backend``):
a missing, failed or hung card raises, and the service never falls back to
the CPU; ``--device cpu`` asks for the CPU. Properties files written for the
JAX package work as they are: their ``ccx.*`` class paths resolve under
``ccx_torch``. With the default simulated admin client this boots a
self-contained demo cluster; pointing ``admin.client.class`` at a real
cluster adapter is the production path.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from ccx_torch.config import CruiseControlConfig
from ccx_torch.device import ensure_responsive_backend, resolve_device
from ccx_torch.service.facade import CruiseControl
from ccx_torch.servlet.server import CruiseControlApp


def build_demo_admin(n_brokers: int = 6, n_racks: int = 3,
                     topics: tuple[tuple[str, int, int], ...] = (
                         ("demo-a", 32, 2), ("demo-b", 16, 3)
                     )):
    from ccx_torch.executor.admin import SimulatedAdminClient, SimulatedCluster

    sim = SimulatedCluster()
    for b in range(n_brokers):
        sim.add_broker(b, rack=f"rack-{b % n_racks}", num_disks=2)
    for name, parts, rf in topics:
        sim.create_topic(name, parts, rf)
    return SimulatedAdminClient(sim)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccx_torch",
        description="ccx_torch REST service (Cruise Control API) on the CUDA device",
    )
    ap.add_argument("properties", nargs="?", default=None,
                    help="properties file (default: the built-in demo config)")
    ap.add_argument("port", nargs="?", type=int, default=None,
                    help="webserver.http.port override")
    ap.add_argument("host", nargs="?", default=None,
                    help="webserver.http.address override")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA device)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    # no card and no explicit device raises here; a card that fails or
    # hangs raises in the probe — the service never falls back to the CPU
    device = resolve_device(args.device)
    if device.type == "cuda":
        ensure_responsive_backend()
    if args.properties:
        cfg = CruiseControlConfig.from_properties_file(args.properties)
    else:
        cfg = CruiseControlConfig(
            {
                "metric.sampler.class":
                    "ccx_torch.monitor.sampling.sampler.SyntheticMetricSampler",
                "broker.capacity.config.resolver.class":
                    "ccx_torch.monitor.capacity.StaticCapacityResolver",
                "metric.sampling.interval.ms": 5000,
                "partition.metrics.window.ms": 10_000,
                "num.partition.metrics.windows": 3,
                "broker.metrics.window.ms": 10_000,
                "num.broker.metrics.windows": 3,
            }
        )
    if args.port is not None:
        cfg = cfg.with_overrides(**{"webserver.http.port": args.port})
    if args.host is not None:
        cfg = cfg.with_overrides(**{"webserver.http.address": args.host})

    admin = cfg.configured_instance("admin.client.class")
    from ccx_torch.executor.admin import SimulatedAdminClient

    if isinstance(admin, SimulatedAdminClient) and not admin.cluster._brokers:
        admin = build_demo_admin()

    facade = CruiseControl(cfg, admin=admin, device=device)
    facade.start_up()
    app = CruiseControlApp(cfg, facade)
    host, port = app.start()
    logging.info("ccx_torch REST API listening on http://%s:%s%s (device %s)",
                 host, port, "/kafkacruisecontrol/state", device)
    openapi_server = None
    if cfg["webserver.openapi.port"] > 0:
        from ccx_torch.servlet.openapi_server import OpenApiServer

        openapi_server = OpenApiServer(
            app, cfg["webserver.openapi.address"],
            cfg["webserver.openapi.port"],
        )
        oa_host, oa_port = openapi_server.start()
        logging.info(
            "ccx_torch OpenAPI surface listening on http://%s:%s%s",
            oa_host, oa_port, "/kafkacruisecontrol/openapi",
        )

    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        while not stop["flag"]:
            signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        if openapi_server is not None:
            openapi_server.stop()
        app.stop()
        facade.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
