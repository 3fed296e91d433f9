"""Small networking helpers (copy of the JAX package's ``utils/net.py``;
original: tensorflowonspark/util.py:52-75)."""

import socket


def get_ip_address():
    """Best-effort externally-routable IP of this host via the UDP-connect
    trick (original: util.py:52-66).  No packet is sent: ``connect`` on a
    datagram socket only picks the route; without one the loopback
    address is returned."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
    except Exception:
        ip = "127.0.0.1"
    finally:
        s.close()
    return ip


def free_port():
    """Grab an ephemeral TCP port (bind to 0 and release)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
