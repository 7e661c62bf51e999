"""Cloud verify server of the port: the cloud half of two-process serving
(mirrors ``repro.launch.cloud``).

Listens for per-cell edge connections and serves VERIFY RPCs from a
``CloudVerifyEngine`` on ``--device`` (the card unless asked for the
CPU).  No model flags here: the session handshake carries the full
arch/smoke/method/engine config digest, and the server builds its target
model from it exactly as the edge launcher does (``bridge.seeded_model``
with seed + 1); parameters never cross the wire.

    PYTHONPATH=src python -m repro_torch.launch.cloud --port 0 \\
        --port-file /tmp/cloud.port                         # on the card

Then point the edge driver at it:

    PYTHONPATH=src python -m repro_torch.launch.serve ... --trace \\
        --transport tcp --cloud-port $(cat /tmp/cloud.port)

``--port 0`` binds an ephemeral port; ``--port-file`` publishes the
bound port for scripts (``serve.net.wait_port_file`` polls it).  SIGTERM
prints a ``[cloud] shutting down`` line with the verify-RPC and
decode-error counts and exits 0.
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, see --port-file)")
    ap.add_argument("--port-file", default="",
                    help="write the bound port number to this file "
                         "once listening")
    ap.add_argument("--io-timeout-s", type=float, default=300.0,
                    help="per-connection socket timeout")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the target model and verify run")
    ap.add_argument("--log-level", default="info",
                    choices=["debug", "info", "warning", "error"],
                    help="logging threshold for the server "
                         "(repro_torch.serve.net logs decode errors at "
                         "error, dropped connections at debug)")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="[cloud] %(levelname)s %(name)s: %(message)s")

    from repro_torch.serve.net import CloudServer

    server = CloudServer(host=args.host, port=args.port,
                         io_timeout_s=args.io_timeout_s,
                         device=args.device)
    print(f"[cloud] listening on {server.host}:{server.port}", flush=True)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))

    def _shutdown(why: str):
        server.stop()
        snap = server.stats_snapshot()["counters"]
        print(f"[cloud] shutting down ({why}): "
              f"{snap.get('cloud.verify_rpcs', 0)} verify RPCs, "
              f"{snap.get('cloud.wire_decode_errors', 0)} decode errors",
              flush=True)

    def _term(signum, frame):
        _shutdown("SIGTERM")
        sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _shutdown("KeyboardInterrupt")


if __name__ == "__main__":
    main()
