"""Shared stdlib HTTP scaffolding for the serving front-ends (the port's
copy of ``paddle_tpu/serving/httpd.py``).

`ServingFrontend` (and, once ported, the fleet `FleetRouter`) is a thin
threading-HTTP server; the server subclass (daemon handler threads +
a burst-safe listen backlog), the handler shim, the lifecycle thread
and the JSON responder live HERE so a server-level fix lands once.
"""
from __future__ import annotations

import http.server
import json
import threading


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True  # streaming handlers must not pin shutdown
    # socketserver's default listen backlog of 5 drops SYNs under a
    # concurrent-connect burst — the kernel's ~1s SYN retransmit then
    # dominates every latency percentile
    request_queue_size = 128


def start_http_server(host, port, on_get, on_post, name):
    """Bind + serve on a daemon thread. Returns ``(httpd, thread)``;
    read the ephemeral port back off ``httpd.server_address[1]``."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            on_get(self)

        def do_POST(self):
            on_post(self)

    httpd = _Server((host, int(port)), Handler)
    # a short poll: shutdown() returns within 50 ms, not socketserver's
    # default half second
    thread = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, name=name,
                              daemon=True)
    thread.start()
    return httpd, thread


def stop_http_server(httpd, thread, timeout_s=10):
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
    if thread is not None:
        thread.join(timeout=timeout_s)


def send_json(h, code, obj):
    """One JSON response on handler ``h``. Raises OSError upward if
    the client is gone — callers decide whether that matters."""
    data = json.dumps(obj, default=str).encode("utf-8")
    h.send_response(code)
    h.send_header("Content-Type", "application/json")
    h.send_header("Content-Length", str(len(data)))
    h.end_headers()
    h.wfile.write(data)


def send_text(h, code, body, content_type):
    h.send_response(code)
    h.send_header("Content-Type", content_type)
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    h.wfile.write(body)
