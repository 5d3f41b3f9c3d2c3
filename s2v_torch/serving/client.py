"""Client of the serving daemon: newline-delimited JSON over a unix-domain
socket (counterpart of ``s2v_tpu/serving/client.py``)."""

from __future__ import annotations

import json
import socket


def request(socket_path: str, payload: dict, timeout: float = 3600.0) -> dict:
    """Send one request and return the parsed response dict."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        conn.connect(socket_path)
        with conn.makefile("rwb") as stream:
            stream.write((json.dumps(payload) + "\n").encode())
            stream.flush()
            line = stream.readline()
            if not line:
                raise ConnectionError("daemon closed the connection without a response")
            return json.loads(line)
    finally:
        conn.close()
