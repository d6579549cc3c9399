"""API security — pluggable authentication + role-based authorization.

Parity: ``servlet/security/`` (SURVEY.md C34): a ``SecurityProvider`` SPI
authenticates a request and yields roles; authorization is role-based —
VIEWER (read endpoints), USER (VIEWER + kafka admin reads + user tasks),
ADMIN (everything). Providers: HTTP basic over a credentials file
(``BasicSecurityProvider``), trusted-proxy header auth
(``TrustedProxySecurityProvider``), and a JWT flavor (HMAC-SHA256,
stdlib-only) mirroring ``JwtSecurityProvider``.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json

from ccx_torch.servlet.endpoints import GET_ENDPOINTS, EndPoint

ROLE_VIEWER = "VIEWER"
ROLE_USER = "USER"
ROLE_ADMIN = "ADMIN"
ALL_ROLES = frozenset({ROLE_VIEWER, ROLE_USER, ROLE_ADMIN})

#: minimum role per endpoint class (ref permissions endpoint semantics)
_VIEWER_OK = frozenset(
    {
        EndPoint.STATE, EndPoint.LOAD, EndPoint.PARTITION_LOAD,
        EndPoint.PROPOSALS, EndPoint.KAFKA_CLUSTER_STATE,
        EndPoint.PERMISSIONS,
    }
)
_USER_OK = _VIEWER_OK | {
    EndPoint.USER_TASKS, EndPoint.REVIEW_BOARD,
    # thread stack dumps + file paths: operator-grade, not viewer-grade
    EndPoint.OBSERVABILITY,
}
# everything else (mutating POSTs, admin, review) needs ADMIN


def authorized(roles: set[str], endpoint: EndPoint) -> bool:
    if ROLE_ADMIN in roles:
        return True
    if ROLE_USER in roles:
        return endpoint in _USER_OK
    if ROLE_VIEWER in roles:
        return endpoint in _VIEWER_OK
    return False


class AuthResult:
    def __init__(self, ok: bool, principal: str = "", roles: set[str] | None = None,
                 challenge: str = "") -> None:
        self.ok = ok
        self.principal = principal
        self.roles = roles or set()
        self.challenge = challenge  # WWW-Authenticate header when 401


class SecurityProvider:
    """SPI (ref C34). ``authenticate(headers)`` -> AuthResult."""

    def configure(self, config) -> None:
        pass

    def authenticate(self, headers: dict[str, str]) -> AuthResult:
        raise NotImplementedError


class NoopSecurityProvider(SecurityProvider):
    """Security disabled: everyone is ADMIN (the default when
    ``webserver.security.enable=false``)."""

    def __init__(self, config=None) -> None:
        pass

    def authenticate(self, headers) -> AuthResult:
        return AuthResult(True, "anonymous", {ROLE_ADMIN})


class BasicSecurityProvider(SecurityProvider):
    """HTTP basic auth over a Jetty-style credentials file (ref
    BasicSecurityProvider): lines of ``user: password,ROLE1,ROLE2``."""

    def __init__(self, credentials_file: str | None = None, config=None) -> None:
        self._users: dict[str, tuple[str, set[str]]] = {}
        if credentials_file:
            self._load(credentials_file)
        elif config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        path = config["webserver.auth.credentials.file"]
        if path:
            self._load(path)

    def _load(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                user, _, rest = line.partition(":")
                password, roles = self._split_password_roles(rest.strip())
                self._users[user.strip()] = (password, roles or {ROLE_VIEWER})

    @staticmethod
    def _split_password_roles(rest: str) -> tuple[str, set[str]]:
        """``password,role1,role2`` — the password may contain commas.

        Quoted passwords (Jetty-style ``"pass,word",ADMIN``) are taken
        verbatim; otherwise role names are parsed from the *end* (known role
        tokens only) so a comma inside the password is never silently
        truncated into bogus roles.
        """
        if rest.startswith('"'):
            end = rest.find('"', 1)
            if end > 0:
                password = rest[1:end]
                tail = rest[end + 1 :].lstrip(", ")
                roles = {r.strip().upper() for r in tail.split(",") if r.strip()}
                return password, roles
        parts = [p.strip() for p in rest.split(",")]
        n = len(parts)
        while n > 1 and parts[n - 1].upper() in ALL_ROLES:
            n -= 1
        password = ",".join(parts[:n])
        roles = {p.upper() for p in parts[n:]}
        return password, roles

    def authenticate(self, headers) -> AuthResult:
        auth = headers.get("authorization", "")
        if not auth.lower().startswith("basic "):
            return AuthResult(False, challenge='Basic realm="ccx"')
        try:
            decoded = base64.b64decode(auth.split(None, 1)[1]).decode()
            user, _, password = decoded.partition(":")
        except (binascii.Error, UnicodeDecodeError):
            return AuthResult(False, challenge='Basic realm="ccx"')
        known = self._users.get(user)
        if known is None or not hmac.compare_digest(known[0], password):
            return AuthResult(False, challenge='Basic realm="ccx"')
        return AuthResult(True, user, known[1])


class TrustedProxySecurityProvider(SecurityProvider):
    """Ref TrustedProxySecurityProvider: trust an upstream proxy's
    authenticated-principal header — but only when the TCP peer is one of
    the configured trusted proxies (the server injects the peer address as
    ``CLIENT_ADDRESS_HEADER``); a spoofed header from an untrusted source is
    rejected. Principals in ``admin_principals`` get ADMIN, others USER."""

    HEADER = "x-forwarded-principal"
    CLIENT_ADDRESS_HEADER = "x-ccx-peer-address"  # injected server-side

    def __init__(self, trusted_proxies: tuple[str, ...] = ("127.0.0.1",),
                 admin_principals: tuple[str, ...] = (), config=None) -> None:
        self.trusted_proxies = set(trusted_proxies)
        self.admin_principals = set(admin_principals)
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        ips = config.get("webserver.trusted.proxy.ips")
        if ips:
            self.trusted_proxies = set(ips)
        admins = config.get("webserver.trusted.proxy.admin.principals")
        if admins:
            self.admin_principals = set(admins)

    def authenticate(self, headers) -> AuthResult:
        peer = headers.get(self.CLIENT_ADDRESS_HEADER, "")
        if peer not in self.trusted_proxies:
            return AuthResult(False, challenge="TrustedProxy")
        principal = headers.get(self.HEADER, "")
        if not principal:
            return AuthResult(False, challenge="TrustedProxy")
        roles = (
            {ROLE_ADMIN} if principal in self.admin_principals else {ROLE_USER}
        )
        return AuthResult(True, principal, roles)


class JwtSecurityProvider(SecurityProvider):
    """Ref JwtSecurityProvider, HMAC-SHA256 flavor: ``Authorization: Bearer
    <jwt>`` with claims ``sub`` and ``roles``."""

    def __init__(self, secret: str = "", config=None) -> None:
        self.secret = secret.encode() if secret else b""
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        if not self.secret:
            # The credentials file holds the signing secret's *contents* —
            # never key off the (guessable) path itself.
            path = config["webserver.auth.credentials.file"]
            if path:
                with open(path, "rb") as f:
                    self.secret = f.read().strip()

    @staticmethod
    def _b64url(data: bytes) -> bytes:
        return base64.urlsafe_b64encode(data).rstrip(b"=")

    def issue(self, subject: str, roles: set[str],
              expires_at_s: int | None = None,
              not_before_s: int | None = None) -> str:
        claims: dict = {"sub": subject, "roles": sorted(roles)}
        if expires_at_s is not None:
            claims["exp"] = expires_at_s
        if not_before_s is not None:
            claims["nbf"] = not_before_s
        header = self._b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        payload = self._b64url(json.dumps(claims).encode())
        sig = self._b64url(
            hmac.new(self.secret, header + b"." + payload, hashlib.sha256).digest()
        )
        return (header + b"." + payload + b"." + sig).decode()

    def authenticate(self, headers) -> AuthResult:
        if not self.secret:
            # Fail closed: an unset secret must never verify tokens (an
            # empty HMAC key would accept attacker-signed claims).
            return AuthResult(False, challenge="Bearer")
        auth = headers.get("authorization", "")
        if not auth.lower().startswith("bearer "):
            return AuthResult(False, challenge="Bearer")
        token = auth.split(None, 1)[1]
        try:
            header_b, payload_b, sig_b = token.encode().split(b".")
            expect = self._b64url(
                hmac.new(self.secret, header_b + b"." + payload_b,
                         hashlib.sha256).digest()
            )
            if not hmac.compare_digest(expect, sig_b):
                return AuthResult(False, challenge="Bearer")
            pad = b"=" * (-len(payload_b) % 4)
            claims = json.loads(base64.urlsafe_b64decode(payload_b + pad))
        except (ValueError, binascii.Error):
            return AuthResult(False, challenge="Bearer")
        import time as _time

        now_s = _time.time()
        if "exp" in claims and now_s >= float(claims["exp"]):
            return AuthResult(False, challenge='Bearer error="token expired"')
        if "nbf" in claims and now_s < float(claims["nbf"]):
            return AuthResult(False, challenge='Bearer error="token not yet valid"')
        return AuthResult(
            True, claims.get("sub", ""), set(claims.get("roles", []))
        )


class SpnegoSecurityProvider(SecurityProvider):
    """Kerberos/SPNEGO via GSSAPI (ref SpnegoSecurityProvider, SURVEY.md
    C34): the client sends ``Authorization: Negotiate <base64 token>``; the
    server accepts the GSS security context under its HTTP service
    credential (keytab via standard ``KRB5_KTNAME``) and maps the initiator
    principal to roles.

    The ``gssapi`` package is NOT a hard dependency — construction fails
    with a clear message when it is missing (same import-guard pattern as
    ccx.executor.kafka_admin). Role mapping: principals (sans realm) listed
    in ``webserver.spnego.admin.principals`` get ADMIN, others USER.
    """

    def __init__(self, service_name: str = "HTTP",
                 admin_principals: tuple[str, ...] = (), config=None) -> None:
        try:
            import gssapi
        except ImportError as e:  # pragma: no cover - environment dependent
            raise ImportError(
                "SpnegoSecurityProvider requires the `gssapi` package "
                "(pip install gssapi) and a host Kerberos setup; use "
                "Basic/Jwt/TrustedProxy providers otherwise"
            ) from e
        self._gssapi = gssapi
        self.service_name = service_name
        self.admin_principals = set(admin_principals)
        self._server_creds = None
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        admins = config.get("webserver.spnego.admin.principals")
        if admins:
            self.admin_principals = set(admins)
        svc = config.get("webserver.spnego.service.name")
        if svc:
            self.service_name = svc

    def _creds(self):
        if self._server_creds is None:
            name = self._gssapi.Name(
                f"{self.service_name}@",  # host resolved by the library
                name_type=self._gssapi.NameType.hostbased_service,
            )
            self._server_creds = self._gssapi.Credentials(
                name=name, usage="accept"
            )
        return self._server_creds

    def authenticate(self, headers) -> AuthResult:
        auth = headers.get("authorization", "")
        if not auth.lower().startswith("negotiate "):
            return AuthResult(False, challenge="Negotiate")
        try:
            token = base64.b64decode(auth.split(None, 1)[1])
            ctx = self._gssapi.SecurityContext(creds=self._creds(), usage="accept")
            ctx.step(token)
            if not ctx.complete:
                # multi-round-trip contexts are not supported over stateless
                # HTTP here (ref behavior: single-token SPNEGO)
                return AuthResult(False, challenge="Negotiate")
            principal = str(ctx.initiator_name)
        except Exception:
            return AuthResult(False, challenge="Negotiate")
        short = principal.split("@", 1)[0]
        roles = {ROLE_ADMIN} if (
            principal in self.admin_principals or short in self.admin_principals
        ) else {ROLE_USER, ROLE_VIEWER}
        return AuthResult(True, principal, roles)
