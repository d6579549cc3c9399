"""Second API surface: contract-routed asyncio server (ref SURVEY.md C36).

The reference's optional Vert.x module mirrors the servlet endpoints behind
an OpenAPI contract on its own server. ccx's equivalent keeps the module's
two defining properties without a second endpoint table:

* **contract-first routing** — the route/parameter table is built FROM the
  generated OpenAPI document (``ccx.servlet.openapi.openapi_document``,
  itself generated from the endpoint registry), and every request is
  validated against that contract (unknown path / method / parameter and
  type mismatches are rejected) BEFORE dispatch;
* **a genuinely different HTTP engine** — non-blocking asyncio transport
  (the Vert.x role) instead of the servlet's threading ``BaseHTTPServer``.

Both surfaces share the transport-independent
``CruiseControlApp.handle()`` (auth, two-step review, user-task replay,
verbs), so behavior cannot drift. Enabled by ``webserver.openapi.port``
(0 = disabled — the upstream module is optional too).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import urllib.parse

from ccx_torch.common.exceptions import UserRequestException
from ccx_torch.servlet.endpoints import EndPoint, parse_params
from ccx_torch.servlet.security import authorized
from ccx_torch.servlet.server import URL_PREFIX

log = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 64 * 1024


class ContractViolation(Exception):
    """Request does not match the OpenAPI document."""


class OpenApiServer:
    """Asyncio HTTP server routed by the generated OpenAPI contract."""

    def __init__(self, app, address: str = "127.0.0.1", port: int = 0) -> None:
        from ccx_torch.servlet.openapi import openapi_document

        self.app = app
        self.address = address
        self.port = port
        self.document = openapi_document(URL_PREFIX)
        # path -> method -> {param: schema}; built once from the contract
        self.routes: dict[str, dict[str, dict[str, dict]]] = {}
        for path, methods in self.document["paths"].items():
            self.routes[path] = {
                m.upper(): {
                    p["name"]: p.get("schema", {})
                    for p in spec.get("parameters", [])
                }
                for m, spec in methods.items()
            }
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._started = threading.Event()
        self._boot_error: BaseException | None = None

    # ----- lifecycle --------------------------------------------------------

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(
            target=self._run, name="ccx-openapi", daemon=True
        )
        self._thread.start()
        # a swallowed bind failure would log "listening" while nothing
        # listens — surface boot errors to the caller
        if not self._started.wait(timeout=10):
            raise RuntimeError("OpenAPI surface failed to start within 10 s")
        if self._boot_error is not None:
            raise RuntimeError(
                f"OpenAPI surface failed to bind "
                f"{self.address}:{self.port}: {self._boot_error}"
            ) from self._boot_error
        return self.address, self.port

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            # limit > _MAX_HEADER_BYTES so readuntil can actually RETURN an
            # oversized head for the 431 check instead of erroring at the
            # exact threshold
            self._server = await asyncio.start_server(
                self._client, self.address, self.port,
                limit=2 * _MAX_HEADER_BYTES,
            )
            self.port = self._server.sockets[0].getsockname()[1]

        try:
            self._loop.run_until_complete(boot())
        except BaseException as e:  # noqa: BLE001 — reported by start()
            self._boot_error = e
            self._started.set()
            self._loop.close()
            return
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self) -> None:
        if self._loop is None:
            return

        def _shutdown():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10)

    # ----- contract validation ---------------------------------------------

    def _validate(self, path: str, method: str, query: dict) -> EndPoint:
        methods = self.routes.get(path)
        if methods is None:
            raise ContractViolation(f"path {path} is not in the contract")
        schema = methods.get(method)
        if schema is None:
            raise ContractViolation(
                f"{path} does not support {method} (contract methods: "
                f"{sorted(methods)})"
            )
        for name, value in query.items():
            if name not in schema:
                raise ContractViolation(
                    f"parameter {name!r} is not in the contract for {path}"
                )
            typ = schema[name].get("type")
            if typ == "integer":
                try:
                    int(value)
                except ValueError:
                    raise ContractViolation(
                        f"parameter {name!r} must be an integer, got {value!r}"
                    ) from None
            elif typ == "boolean" and value.lower() not in (
                "true", "false", "1", "0", "",
            ):
                raise ContractViolation(
                    f"parameter {name!r} must be a boolean, got {value!r}"
                )
        return EndPoint(path[len(URL_PREFIX) + 1:].strip("/").lower())

    # ----- request handling -------------------------------------------------

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        if len(head) > _MAX_HEADER_BYTES:
            await self._send(writer, 431, {"errorMessage": "headers too large"})
            return
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, _ = lines[0].split(" ", 2)
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length") or 0)
            body = await reader.readexactly(length) if length else b""
            parsed = urllib.parse.urlparse(target)
            query = {
                k: v[-1]
                for k, v in urllib.parse.parse_qs(
                    parsed.query, keep_blank_values=True
                ).items()
            }
            if "application/x-www-form-urlencoded" in headers.get(
                "content-type", ""
            ):
                query = {
                    **{
                        k: v[-1]
                        for k, v in urllib.parse.parse_qs(
                            body.decode(errors="replace"),
                            keep_blank_values=True,
                        ).items()
                    },
                    **query,
                }
            peer = writer.get_extra_info("peername") or ("", 0)
            headers["x-ccx-peer-address"] = peer[0]

            # same authentication gate as the servlet — including for the
            # contract document itself (the servlet 401s it too)
            auth = self.app.security.authenticate(headers)
            if not auth.ok:
                await self._send(
                    writer, 401, {"errorMessage": "Authentication required"},
                    {"WWW-Authenticate": auth.challenge or "Basic"},
                )
                return
            if method == "GET" and parsed.path == URL_PREFIX + "/openapi":
                await self._send(writer, 200, self.document)
                return
            try:
                endpoint = self._validate(parsed.path, method, query)
            except ContractViolation as e:
                await self._send(writer, 400, {"errorMessage": str(e)})
                return

            if not authorized(auth.roles, endpoint):
                await self._send(
                    writer, 403,
                    {"errorMessage":
                     f"{auth.principal} is not authorized for "
                     f"{endpoint.value}"},
                )
                return
            params = parse_params(endpoint, query)
            # handle() blocks up to maxBlockTimeMs — keep the event loop free
            status, resp, extra = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: self.app.handle(
                    method, endpoint, params, headers,
                    client=auth.principal or peer[0],
                ),
            )
            await self._send(writer, status, resp, extra)
        except UserRequestException as e:
            # same mapping as the servlet (400, not 500) — the async-replay
            # and parameter errors are client errors on both surfaces
            try:
                await self._send(writer, 400, {"errorMessage": str(e)})
            except Exception:  # noqa: BLE001
                writer.close()
        except Exception as e:  # noqa: BLE001 — server boundary
            log.exception("openapi request failed")
            try:
                await self._send(writer, 500, {"errorMessage": str(e)})
            except Exception:  # noqa: BLE001
                writer.close()

    async def _send(self, writer: asyncio.StreamWriter, status: int,
                    body: dict, extra: dict | None = None) -> None:
        payload = json.dumps({"version": 1, **body}).encode()
        reason = {200: "OK", 202: "Accepted", 400: "Bad Request",
                  401: "Unauthorized", 403: "Forbidden",
                  431: "Request Header Fields Too Large",
                  500: "Internal Server Error"}.get(status, "")
        head = [f"HTTP/1.1 {status} {reason}",
                "Content-Type: application/json",
                f"Content-Length: {len(payload)}",
                "Connection: close"]
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
        await writer.drain()
        writer.close()
