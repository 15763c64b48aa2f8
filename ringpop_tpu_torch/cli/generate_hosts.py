"""``generate-hosts`` subcommand (reference: scripts/generate-hosts.js).

Writes a hosts.json containing the cross product
``hosts × [base_port, base_port + num_ports)`` (generate-hosts.js:24-57).

The port of ``ringpop_tpu/cli/generate_hosts.py``: the same file, byte
for byte, and the same printed line.
"""

from __future__ import annotations

import argparse
import json
import sys


def generate(hosts: list[str], base_port: int, num_ports: int) -> list[str]:
    return [f"{h}:{base_port + i}" for h in hosts for i in range(num_ports)]


def add_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--hosts", default="127.0.0.1",
                        help="comma-separated host IPs")
    parser.add_argument("--base-port", type=int, default=3000)
    parser.add_argument("--num-ports", "-n", type=int, default=5)
    parser.add_argument("--output", "-o", default="./hosts.json")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="ringpop-tpu-torch generate-hosts")
    add_args(parser)
    args = parser.parse_args(argv)
    host_ports = generate(args.hosts.split(","), args.base_port, args.num_ports)
    with open(args.output, "w") as f:
        json.dump(host_ports, f, indent=2)
    print(f"wrote {len(host_ports)} hosts to {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
