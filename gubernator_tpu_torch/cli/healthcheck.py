"""Container health probe (reference cmd/healthcheck/main.go:29-50).

GETs /v1/HealthCheck on the local daemon; exits 0 when healthy, 2 when
unhealthy or unreachable — the contract container runtimes expect.
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument(
        "--url", default="http://localhost:1050/v1/HealthCheck"
    )
    args = p.parse_args()
    try:
        with urllib.request.urlopen(args.url, timeout=5) as resp:
            payload = json.loads(resp.read())
    except Exception as e:  # noqa: BLE001
        print(f"unreachable: {e}", file=sys.stderr)
        sys.exit(2)
    if payload.get("status") != "healthy":
        print(payload.get("message", "unhealthy"), file=sys.stderr)
        sys.exit(2)
    print("healthy")


if __name__ == "__main__":
    main()
