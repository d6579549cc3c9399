"""cccli — the operator command line.

Parity: the ``cccli`` entrypoint of ``cruise-control-client`` (SURVEY.md
M4/C38): one subcommand per endpoint, ``--socket-address`` for the server,
JSON output (pretty by default, ``--raw`` for machine use), long-polling
handled by the client library.

Usage::

    python -m ccx.client state
    python -m ccx.client rebalance --dryrun
    python -m ccx.client remove-broker 3 --no-dryrun --reason decommission
"""

from __future__ import annotations

import argparse
import json
import sys

from ccx_torch.client.client import CruiseControlClient, CruiseControlClientError


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-a", "--socket-address", default="http://127.0.0.1:9090",
                   help="Cruise Control server address")
    p.add_argument("--user", help="basic-auth user:password")
    p.add_argument("--raw", action="store_true", help="compact JSON output")


def _add_dryrun(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument("--dryrun", dest="dryrun", action="store_true", default=True)
    g.add_argument("--no-dryrun", dest="dryrun", action="store_false")
    p.add_argument("--reason", default="")
    p.add_argument("--review-id", type=int, default=None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cccli", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    def cmd(name, **kw):
        p = sub.add_parser(name, **kw)
        _add_common(p)
        return p

    cmd("state").add_argument("--substates", default="")
    cmd("load")
    p = cmd("partition-load")
    p.add_argument("--max-entries", type=int, default=100)
    p.add_argument("--resource", default="CPU")
    p.add_argument("--topic", default="")
    cmd("proposals").add_argument("--ignore-cache", action="store_true")
    cmd("kafka-cluster-state")
    cmd("user-tasks")
    cmd("permissions")
    p = cmd("rebalance")
    _add_dryrun(p)
    p.add_argument("--goals", default="")
    p.add_argument("--excluded-topics", default="")
    p.add_argument("--rebalance-disk", action="store_true")
    p.add_argument("--destination-broker-ids", default="")
    for name in ("add-broker", "remove-broker", "demote-broker"):
        p = cmd(name)
        p.add_argument("brokers", help="comma-separated broker ids")
        _add_dryrun(p)
    p = cmd("fix-offline-replicas")
    _add_dryrun(p)
    p = cmd("topic-configuration")
    p.add_argument("topic")
    p.add_argument("replication_factor", type=int)
    _add_dryrun(p)
    cmd("rightsize")
    cmd("stop-proposal-execution")
    cmd("pause-sampling").add_argument("--reason", default="")
    cmd("resume-sampling").add_argument("--reason", default="")
    p = cmd("admin")
    p.add_argument("--enable-self-healing-for", default="")
    p.add_argument("--disable-self-healing-for", default="")
    p.add_argument("--concurrency", type=int, default=None)
    p = cmd("review")
    p.add_argument("--approve", default="")
    p.add_argument("--discard", default="")
    cmd("review-board")
    return ap


def _ids(csv: str) -> tuple[int, ...]:
    return tuple(int(x) for x in csv.split(",") if x.strip())


def _strs(csv: str) -> tuple[str, ...]:
    return tuple(x.strip() for x in csv.split(",") if x.strip())


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    auth = tuple(args.user.split(":", 1)) if getattr(args, "user", None) else None
    c = CruiseControlClient(args.socket_address, auth=auth)
    try:
        cmdname = args.command
        if cmdname == "state":
            out = c.state(_strs(args.substates))
        elif cmdname == "load":
            out = c.load()
        elif cmdname == "partition-load":
            out = c.partition_load(args.max_entries, args.resource, args.topic)
        elif cmdname == "proposals":
            out = c.proposals(args.ignore_cache)
        elif cmdname == "kafka-cluster-state":
            out = c.kafka_cluster_state()
        elif cmdname == "user-tasks":
            out = c.user_tasks()
        elif cmdname == "permissions":
            out = c.permissions()
        elif cmdname == "rebalance":
            out = c.rebalance(
                dryrun=args.dryrun, goals=_strs(args.goals),
                excluded_topics=args.excluded_topics,
                rebalance_disk=args.rebalance_disk,
                destination_broker_ids=_ids(args.destination_broker_ids),
                reason=args.reason, review_id=args.review_id,
            )
        elif cmdname == "add-broker":
            out = c.add_broker(_ids(args.brokers), args.dryrun, args.reason,
                               args.review_id)
        elif cmdname == "remove-broker":
            out = c.remove_broker(_ids(args.brokers), args.dryrun, args.reason,
                                  review_id=args.review_id)
        elif cmdname == "demote-broker":
            out = c.demote_broker(_ids(args.brokers), args.dryrun, args.reason,
                                  args.review_id)
        elif cmdname == "fix-offline-replicas":
            out = c.fix_offline_replicas(args.dryrun, args.reason)
        elif cmdname == "topic-configuration":
            out = c.topic_configuration(args.topic, args.replication_factor,
                                        args.dryrun)
        elif cmdname == "rightsize":
            out = c.rightsize()
        elif cmdname == "stop-proposal-execution":
            out = c.stop_proposal_execution()
        elif cmdname == "pause-sampling":
            out = c.pause_sampling(args.reason)
        elif cmdname == "resume-sampling":
            out = c.resume_sampling(args.reason)
        elif cmdname == "admin":
            out = c.admin(
                enable_self_healing_for=_strs(args.enable_self_healing_for) or None,
                disable_self_healing_for=_strs(args.disable_self_healing_for) or None,
                concurrent_partition_movements_per_broker=args.concurrency,
            )
        elif cmdname == "review":
            out = c.review(_ids(args.approve), _ids(args.discard))
        elif cmdname == "review-board":
            out = c.review_board()
        else:  # pragma: no cover
            raise SystemExit(f"unknown command {cmdname}")
    except CruiseControlClientError as e:
        print(json.dumps(e.body, indent=None if args.raw else 2),
              file=sys.stderr)
        return 1
    print(json.dumps(out, indent=None if args.raw else 2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
