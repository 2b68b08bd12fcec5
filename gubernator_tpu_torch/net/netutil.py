"""Advertise-address resolution (reference net.go:28-122).

A daemon listening on 0.0.0.0/:: must advertise a concrete address to its
peers: try the hostname's resolved address, else scan interfaces for the
first external IPv4.
"""
from __future__ import annotations

import socket


def resolve_host_ip(listen_address: str) -> str:
    """Return an advertisable host:port for a listen address
    (ResolveHostIP, net.go:28-47)."""
    host, _, port = listen_address.rpartition(":")
    host = host.strip("[]")
    if host in ("0.0.0.0", "::", ""):
        return f"{discover_ip()}:{port}"
    return listen_address


def discover_ip() -> str:
    """First externally-routable local IPv4 (discoverIP, net.go:49-122)."""
    try:
        # The canonical trick: a UDP "connect" picks the egress interface
        # without sending a packet.
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        pass
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return "127.0.0.1"
