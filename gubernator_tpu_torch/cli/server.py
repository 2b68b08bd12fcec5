"""The server CLI (reference cmd/gubernator/main.go:40-106).

    python -m gubernator_tpu_torch.cli.server [--config FILE]

Reads GUBER_* environment variables (optionally seeded from a --config
KEY=VALUE file), spawns the daemon, and serves until SIGINT/SIGTERM.  The
engine runs on the CUDA card unless GUBER_TPU_PLATFORM=cpu asks for the
CPU.
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from gubernator_tpu_torch.core.config import setup_daemon_config
from gubernator_tpu_torch.daemon import Daemon


def main() -> None:
    parser = argparse.ArgumentParser(
        description="gubernator daemon on the PyTorch/CUDA engine")
    parser.add_argument(
        "--config", default="", help="KEY=VALUE environment file"
    )
    args = parser.parse_args()

    conf = setup_daemon_config(args.config or None)
    from gubernator_tpu_torch.core.logging import setup_logging

    setup_logging(
        level=conf.log_level,
        fmt=os.environ.get("GUBER_LOG_FORMAT", "text"),
    )
    # Tracing from standard OTEL_* env vars (cmd/gubernator/main.go
    # initializes its tracer the same way, main.go:56-69).  The status
    # is logged HONESTLY: a configured OTLP endpoint whose exporter
    # packages are missing says so instead of pretending spans export
    # (the old bool return hid exactly that failure).
    from gubernator_tpu_torch.runtime.tracing import init_tracing

    trace_log = logging.getLogger("gubernator_tpu_torch.tracing")
    status = init_tracing()
    if status.enabled:
        if status.exporter_error:
            trace_log.warning(
                "tracing armed (sampler=%s) but NOT exporting: %s — "
                "spans stay in-process (breach dumps, /debug/vars)",
                status.sampler, status.exporter_error,
            )
        else:
            trace_log.info(
                "tracing armed: sampler=%s exporter=%s",
                status.sampler, status.exporter,
            )
    else:
        trace_log.info("tracing disabled: %s", status.reason)

    async def run() -> None:
        daemon = Daemon(conf)
        await daemon.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)

        def dump_flightrec() -> None:
            # SIGUSR2: operator-initiated flight-recorder dump (the Go
            # expvar/pprof-on-signal idiom).  Fire-and-forget on the loop;
            # a disarmed recorder just logs where to turn it on.
            if daemon.flightrec is None:
                logging.getLogger("gubernator_tpu_torch").warning(
                    "SIGUSR2: flight recorder disabled "
                    "(set GUBER_FLIGHTREC=1)"
                )
                return
            asyncio.ensure_future(daemon.flightrec.dump("signal"))

        loop.add_signal_handler(signal.SIGUSR2, dump_flightrec)
        await stop.wait()
        logging.getLogger("gubernator_tpu_torch").info("shutting down")
        await daemon.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
