"""TLS subsystem: server/client credentials, mTLS, and AutoTLS.

Re-expresses the reference TLS feature set (tls.go:46-444,
config.go:338-368) for python gRPC + aiohttp:

- server TLS from cert/key files;
- mutual TLS with the four client-auth modes (request, require-any,
  verify-if-given, require-and-verify);
- AutoTLS: when no certs are configured, generate an in-memory CA and a
  server certificate for localhost/hostname (tls.go:59-62's self-signed
  path) so TLS "just works" in dev clusters;
- client-side credentials with optional insecure_skip_verify.

Client-auth mode mapping (reference config.go:348-362, tls.go:140-238):

| Go mode                     | here              | gRPC / ssl behavior    |
|-----------------------------|-------------------|------------------------|
| request                     | "request"         | cert optional, verified
|                             |                   | if presented (both
|                             |                   | listeners)             |
| verify-if-given             | "verify-if-given" | same as "request"      |
| require-any                 | "require-any"     | cert required AND
|                             |                   | verified (python cannot
|                             |                   | require-without-verify)|
| require-and-verify          | "require"/"verify"| cert required+verified |

Every row is exact or strictly STRICTER than Go's.  The reference's
spellings (`request-cert`, `verify-cert`, `require-any-cert` —
config.go:351-354) are accepted as aliases and canonicalized by
`core.config.normalize_tls_client_auth`; an UNKNOWN mode raises instead
of silently disabling client auth.  The optional rows
use ssl.CERT_OPTIONAL — directly on the HTTPS gateway, and on the gRPC
listener via `TLSTerminatingProxy`: grpc-python's credentials API has
no request-without-require option, so for optional modes the daemon
terminates TLS itself (python ssl, ALPN h2) and pipes plaintext HTTP/2
to an insecure gRPC listener on a private unix socket.  "Strictly stricter" = Go's `request`
ignores an unverifiable presented cert; here a presented cert must
chain to the CA or the handshake fails.
"""
from __future__ import annotations

import datetime
import ssl
from dataclasses import dataclass
from typing import Optional, Tuple

import grpc

from gubernator_tpu_torch.core.config import TLSConfig, normalize_tls_client_auth

# Client certs required (and verified — python offers no
# require-without-verify): Go's RequireAnyClientCert and
# RequireAndVerifyClientCert, plus the legacy spellings.
REQUIRED_MODES = ("require", "verify", "require-any", "require-and-verify")
# Client certs optional, verified when presented: Go's RequestClientCert
# (strictly stricter here) and VerifyClientCertIfGiven (exact).
OPTIONAL_MODES = ("request", "verify-if-given")


@dataclass
class TLSBundle:
    """Materialized credential set for one daemon."""

    ca_pem: bytes
    cert_pem: bytes
    key_pem: bytes
    client_auth: str = ""
    insecure_skip_verify: bool = False

    def server_credentials(self) -> grpc.ServerCredentials:
        # Optional modes intentionally pass NO roots: grpc maps
        # require_client_auth=False to DONT_REQUEST_CLIENT_CERTIFICATE,
        # so roots would be inert and imply verification that never
        # happens (the HTTPS gateway implements the optional modes).
        require = self.client_auth in REQUIRED_MODES
        return grpc.ssl_server_credentials(
            [(self.key_pem, self.cert_pem)],
            root_certificates=self.ca_pem if require else None,
            require_client_auth=require,
        )

    def client_credentials(self) -> grpc.ChannelCredentials:
        # For skip-verify we still need *a* root; gRPC has no insecure-TLS
        # mode, so trust our own CA bundle (dev clusters share the CA).
        return grpc.ssl_channel_credentials(
            root_certificates=self.ca_pem,
            private_key=self.key_pem,
            certificate_chain=self.cert_pem,
        )

    def _load_own_cert(self, ctx: ssl.SSLContext) -> None:
        """load_cert_chain needs files; round-trip the in-memory PEMs."""
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
                tempfile.NamedTemporaryFile(suffix=".pem") as kf:
            cf.write(self.cert_pem)
            cf.flush()
            kf.write(self.key_pem)
            kf.flush()
            ctx.load_cert_chain(cf.name, kf.name)

    def client_ssl_context(self) -> ssl.SSLContext:
        """aiohttp/HTTP-gateway client context; presents this bundle's
        cert so mTLS gateways (client_auth modes) accept the connection."""
        ctx = ssl.create_default_context(
            cadata=self.ca_pem.decode()
        )
        self._load_own_cert(ctx)
        if self.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def server_ssl_context(self) -> ssl.SSLContext:
        """aiohttp/HTTP-gateway server context."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._load_own_cert(ctx)
        if self.client_auth in REQUIRED_MODES:
            ctx.load_verify_locations(cadata=self.ca_pem.decode())
            ctx.verify_mode = ssl.CERT_REQUIRED
        elif self.client_auth in OPTIONAL_MODES:
            # verify-if-given (tls.go VerifyClientCertIfGiven): a client
            # may connect bare; a presented cert must chain to the CA.
            ctx.load_verify_locations(cadata=self.ca_pem.decode())
            ctx.verify_mode = ssl.CERT_OPTIONAL
        return ctx

    def grpc_proxy_ssl_context(self) -> ssl.SSLContext:
        """Server context for the gRPC TLS-terminating proxy (optional
        client-auth modes only): python ssl CAN express
        request-without-require (CERT_OPTIONAL), which grpc-python's
        credentials API cannot — so the daemon terminates TLS itself and
        pipes plaintext HTTP/2 to an insecure gRPC listener on a private
        unix socket.
        ALPN must advertise h2: gRPC clients refuse a TLS server that
        doesn't negotiate it."""
        ctx = self.server_ssl_context()
        ctx.set_alpn_protocols(["h2"])
        return ctx


class TLSTerminatingProxy:
    """Byte-level TLS terminator in front of an insecure gRPC listener
    on a private unix socket.  Exists for the optional client-auth modes
    (request / verify-if-given, tls.go VerifyClientCertIfGiven): the
    handshake requests a client certificate without requiring one and
    verifies it only when presented — semantics grpc-python's boolean
    require_client_auth cannot express.  HTTP/2 passes through untouched
    (the proxy never parses frames), so the gRPC server behind it serves
    the exact same wire bytes."""

    def __init__(self, ssl_ctx: ssl.SSLContext,
                 backend_unix_path: str) -> None:
        # The plaintext backend is a UNIX socket in a 0700 directory, not
        # a loopback TCP port: a TCP backend would hand any local process
        # a side door around TLS and client-auth entirely.
        self._ctx = ssl_ctx
        self._backend_path = backend_unix_path
        self._server: Optional[object] = None
        self._conns: set = set()

    async def start(self, listen_address: str) -> int:
        """Bind and return the bound port.  Accepts the grpc address
        forms the secure-port path accepts: host:port (port may be 0),
        bracketed IPv6 ([::]:port), and unix:path (returns 1, grpc's
        own convention for portless binds)."""
        import asyncio

        if listen_address.startswith("unix:"):
            self._server = await asyncio.start_unix_server(
                self._handle, listen_address[len("unix:"):], ssl=self._ctx
            )
            return 1
        host, _, port = listen_address.rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        self._server = await asyncio.start_server(
            self._handle, host or "0.0.0.0", int(port), ssl=self._ctx
        )
        return self._server.sockets[0].getsockname()[1]

    async def _handle(self, creader, cwriter) -> None:
        import asyncio

        task = asyncio.current_task()
        self._conns.add(task)
        breader = bwriter = None
        try:
            breader, bwriter = await asyncio.open_unix_connection(
                self._backend_path
            )

            async def pump(src, dst) -> None:
                while True:
                    data = await src.read(1 << 16)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
                if dst.can_write_eof():
                    dst.write_eof()

            # return_exceptions: one direction failing (client reset)
            # must not orphan the sibling pump — it runs to its own
            # EOF/error and is awaited here either way.
            await asyncio.gather(
                pump(creader, bwriter), pump(breader, cwriter),
                return_exceptions=True,
            )
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass  # half-closed pipes at teardown are normal
        finally:
            for w in (bwriter, cwriter):
                if w is not None:
                    try:
                        w.close()
                    except Exception:  # noqa: BLE001 — teardown
                        pass
            for w in (bwriter, cwriter):
                if w is not None:
                    # Flush close_notify / final buffered bytes before the
                    # transport is dropped — otherwise the client can see
                    # an RST-style end instead of a clean TLS shutdown.
                    try:
                        await w.wait_closed()
                    except asyncio.CancelledError:
                        break  # close() is cutting pipes: stop waiting
                    except Exception:  # noqa: BLE001 — teardown
                        pass
            self._conns.discard(task)

    async def stop_accepting(self) -> None:
        """Close the listener; live pipes keep flowing.  Call BEFORE the
        gRPC server's drain grace so a client dialing mid-shutdown gets
        connection-refused on the real socket rather than a handshake
        that dies on a dead backend."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def close(self) -> None:
        """Cut remaining pipes (after the gRPC drain grace has let
        in-flight requests finish through them)."""
        import asyncio

        await self.stop_accepting()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)


def setup_tls(
    cfg: Optional[TLSConfig],
    hostnames: Tuple[str, ...] = ("localhost",),
) -> Optional[TLSBundle]:
    """Materialize a TLSBundle from config (SetupTLS, tls.go:140-238).

    Three tiers:
    1. cert_file + key_file given — load them;
    2. ca_file + ca_key_file given — generate a per-daemon server cert
       signed by that SHARED CA (multi-node AutoTLS);
    3. nothing given — generate a private CA + cert (single-node dev
       AutoTLS; peers of different daemons would not trust each other).
    """
    if cfg is None:
        return None
    # Canonicalize (reference spellings -> our modes) and REJECT unknown
    # values: an unvalidated mode would match neither REQUIRED_MODES nor
    # OPTIONAL_MODES and silently disable client auth.
    client_auth = normalize_tls_client_auth(cfg.client_auth)
    if client_auth in OPTIONAL_MODES:
        import logging

        logging.getLogger("gubernator_tpu_torch.tls").info(
            "client_auth=%r: gRPC optional client-auth served via the "
            "in-process TLS terminator (grpc-python cannot "
            "request-without-require; python ssl CERT_OPTIONAL can)",
            client_auth,
        )
    if cfg.cert_file and cfg.key_file:
        cert_pem = open(cfg.cert_file, "rb").read()
        key_pem = open(cfg.key_file, "rb").read()
        ca_pem = (
            open(cfg.ca_file, "rb").read() if cfg.ca_file else cert_pem
        )
        return TLSBundle(
            ca_pem=ca_pem,
            cert_pem=cert_pem,
            key_pem=key_pem,
            client_auth=client_auth,
            insecure_skip_verify=cfg.insecure_skip_verify,
        )
    ca_material = None
    if cfg.ca_file and cfg.ca_key_file:
        ca_material = (
            open(cfg.ca_file, "rb").read(),
            open(cfg.ca_key_file, "rb").read(),
        )
    ca_pem, ca_key, cert_pem, key_pem = generate_auto_tls(
        hostnames=hostnames, ca_material=ca_material
    )
    return TLSBundle(
        ca_pem=ca_pem,
        cert_pem=cert_pem,
        key_pem=key_pem,
        client_auth=client_auth,
        insecure_skip_verify=cfg.insecure_skip_verify,
    )


def generate_auto_tls(
    hostnames: Tuple[str, ...] = ("localhost",),
    ca_material: Optional[Tuple[bytes, bytes]] = None,
) -> Tuple[bytes, bytes, bytes, bytes]:
    """Generate (ca_pem, ca_key_pem, server_cert_pem, server_key_pem) for
    dev/test TLS — the AutoTLS path (tls.go:59-62, 240-329).

    Pass `ca_material=(ca_pem, ca_key_pem)` to sign with an existing CA so
    multiple daemons share a trust root.
    """
    import ipaddress
    import socket

    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
    except ModuleNotFoundError as e:
        # AutoTLS is the only path that needs the extra; operators with
        # real cert/key files never reach here.
        raise RuntimeError(
            "AutoTLS (self-signed / shared-CA certificate generation) "
            "requires the optional 'cryptography' package: install "
            "gubernator-tpu[tls], or configure GUBER_TLS_CERT/"
            "GUBER_TLS_KEY with existing certificate files"
        ) from e

    def make_key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    now = datetime.datetime.now(datetime.timezone.utc)
    if ca_material is not None:
        ca_pem_in, ca_key_pem = ca_material
        ca_cert = x509.load_pem_x509_certificate(ca_pem_in)
        ca_key = serialization.load_pem_private_key(ca_key_pem, None)
        ca_name = ca_cert.subject
    else:
        ca_key = make_key()
        ca_name = x509.Name(
            [x509.NameAttribute(
                NameOID.COMMON_NAME, "gubernator-tpu-dev-ca"
            )]
        )
        ca_cert = (
            x509.CertificateBuilder()
            .subject_name(ca_name)
            .issuer_name(ca_name)
            .public_key(ca_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(
                x509.BasicConstraints(ca=True, path_length=None),
                critical=True,
            )
            .sign(ca_key, hashes.SHA256())
        )

    srv_key = make_key()
    # hostnames may mix DNS names and IPs (the daemon passes its advertise
    # address so cross-host peer dials verify).
    sans = []
    for h in hostnames:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    sans.append(x509.DNSName(socket.gethostname()))
    sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
    srv_cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, hostnames[0])]
            )
        )
        .issuer_name(ca_name)
        .public_key(srv_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(ca_key, hashes.SHA256())
    )

    pem = serialization.Encoding.PEM
    pk8 = serialization.PrivateFormat.PKCS8
    nenc = serialization.NoEncryption()
    return (
        ca_cert.public_bytes(pem),
        ca_key.private_bytes(pem, pk8, nenc),
        srv_cert.public_bytes(pem),
        srv_key.private_bytes(pem, pk8, nenc),
    )
