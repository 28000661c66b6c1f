"""The advisor over HTTP: the service app and the worker's client handle.

The port's own copy of ``rafiki_tpu/advisor/app.py``: ``AdvisorApp``
serves propose, propose_batch and feedback of an ``AdvisorService`` so
train workers in other processes share one optimisation state, guarded
by a shared-secret header; ``HttpAdvisorHandle`` is the worker's side.
The JAX package's app is a werkzeug WSGI app and its handle speaks
``requests``; here the app is a ``utils/httpd.py`` app (werkzeug is
absent on the card's machine) and the handle speaks ``urllib.request``.
Routes, bodies and status codes are the JAX package's: 401 for a
missing or wrong secret (every route but ``/healthz``), 404 for an
unknown advisor or route, 405 for a known route with another method,
400 for a ``propose_batch`` without an integer ``n >= 1`` or a body that
is not JSON, 500 otherwise. One route more than the JAX package's:
``POST /advisors/<id>/speculate`` (``score``, ``knobs`` and the curve
fit's record ``fit``), so a process worker's backfill speculates as an
in-process worker's does (``advisor/speculative.py``).
"""

from __future__ import annotations

import hmac
import json
import re
import time
import urllib.error
import urllib.request
from typing import Optional

from rafiki_tpu_torch.advisor.service import AdvisorService
from rafiki_tpu_torch.utils.httpd import Request, Response, json_response

_SECRET_HEADER = "X-Rafiki-Advisor-Secret"

#: werkzeug's descriptions of the two routing errors, which the JAX
#: package's app returns as its ``error``.
_NOT_FOUND = ("The requested URL was not found on the server. If you entered the URL "
              "manually please check your spelling and try again.")
_NOT_ALLOWED = "The method is not allowed for the requested URL."
_BAD_JSON = "The browser (or proxy) sent a request that this server could not understand."

_ROUTES = [
    ("GET", re.compile(r"/healthz\Z"), "healthz"),
    ("GET", re.compile(r"/advisors/(?P<advisor_id>[^/]+)/propose\Z"), "propose"),
    ("POST", re.compile(r"/advisors/(?P<advisor_id>[^/]+)/propose_batch\Z"), "propose_batch"),
    ("POST", re.compile(r"/advisors/(?P<advisor_id>[^/]+)/feedback\Z"), "feedback"),
    ("POST", re.compile(r"/advisors/(?P<advisor_id>[^/]+)/speculate\Z"), "speculate"),
]


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class AdvisorApp:
    """``app(request) -> Response`` over ``service``; ``secret`` (when
    given) must come in the ``X-Rafiki-Advisor-Secret`` header."""

    def __init__(self, service: AdvisorService, secret: Optional[str] = None):
        self.service = service
        self.secret = secret

    def __call__(self, request: Request) -> Response:
        try:
            endpoint, args = self._match(request)
            if endpoint != "healthz" and self.secret is not None:
                given = request.headers.get(_SECRET_HEADER) or ""
                if not hmac.compare_digest(given, self.secret):
                    raise PermissionError("Bad advisor secret")
            return getattr(self, f"ep_{endpoint}")(request, **args)
        except _HttpError as e:
            return json_response({"error": str(e)}, e.status)
        except PermissionError as e:
            return json_response({"error": str(e)}, 401)
        except KeyError as e:
            return json_response({"error": str(e)}, 404)
        except Exception as e:
            return json_response({"error": f"{type(e).__name__}: {e}"}, 500)

    @staticmethod
    def _match(request: Request):
        allowed = False
        for method, pattern, endpoint in _ROUTES:
            hit = pattern.match(request.path)
            if hit is None:
                continue
            if method != request.method:
                allowed = True
                continue
            return endpoint, hit.groupdict()
        if allowed:
            raise _HttpError(405, _NOT_ALLOWED)
        raise _HttpError(404, _NOT_FOUND)

    def ep_healthz(self, request: Request) -> Response:
        return json_response({"status": "ok"})

    def ep_propose(self, request: Request, advisor_id: str) -> Response:
        return json_response({"knobs": self.service.propose(advisor_id)})

    def ep_propose_batch(self, request: Request, advisor_id: str) -> Response:
        """q proposals in one round trip. A remote caller asking for n < 1
        gets a 400, not a silent 1 (the in-process path clamps)."""
        body = request.get_json() or {}
        try:
            n = int(body.get("n"))
        except (TypeError, ValueError):
            raise _HttpError(400, "propose_batch requires an integer 'n'")
        if n < 1:
            raise _HttpError(400, f"propose_batch n must be >= 1, got {n}")
        return json_response({"knobs_list": self.service.propose_batch(advisor_id, n)})

    def ep_feedback(self, request: Request, advisor_id: str) -> Response:
        body = request.get_json()
        if body is None:
            raise _HttpError(400, _BAD_JSON)
        self.service.feedback(advisor_id, float(body["score"]), body["knobs"])
        return json_response({"ok": True})

    def ep_speculate(self, request: Request, advisor_id: str) -> Response:
        body = request.get_json()
        if body is None:
            raise _HttpError(400, _BAD_JSON)
        self.service.speculate(advisor_id, float(body["score"]), body["knobs"],
                               fit=body.get("fit"))
        return json_response({"ok": True})


#: No proxy: the advisor server is on loopback, whatever proxy the
#: environment names.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class HttpAdvisorHandle:
    """The worker's ``AdvisorHandle`` speaking to an :class:`AdvisorApp`.

    Calls retry through connection errors and timeouts (the server may
    come up a beat after the worker process), ``retries`` times with
    ``retry_delay_s`` between; an HTTP error status raises at once."""

    def __init__(self, base_url: str, advisor_id: str, secret: Optional[str] = None,
                 retries: int = 10, retry_delay_s: float = 0.3):
        self._base = base_url.rstrip("/")
        self._id = advisor_id
        self._headers = {_SECRET_HEADER: secret} if secret else {}
        self._retries = retries
        self._retry_delay_s = retry_delay_s

    def _call(self, method: str, path: str, body: Optional[dict] = None):
        data = None if body is None else json.dumps(body).encode()
        headers = dict(self._headers)
        if data is not None:
            headers["Content-Type"] = "application/json"
        last = None
        for _ in range(self._retries):
            req = urllib.request.Request(self._base + path, data=data, method=method,
                                         headers=headers)
            try:
                with _OPENER.open(req, timeout=30.0) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                text = e.read().decode("utf-8", "replace")
                e.close()
                raise RuntimeError(f"advisor HTTP {e.code}: {text[:200]}") from None
            except (urllib.error.URLError, OSError) as e:
                last = e
                time.sleep(self._retry_delay_s)
        raise RuntimeError(f"advisor unreachable at {self._base}: {last}")

    def propose(self):
        return self._call("GET", f"/advisors/{self._id}/propose")["knobs"]

    def propose_batch(self, n: int):
        """q proposals in one round trip (n < 1 is the server's 400)."""
        return self._call("POST", f"/advisors/{self._id}/propose_batch",
                          {"n": int(n)})["knobs_list"]

    def feedback(self, score: float, knobs) -> None:
        self._call("POST", f"/advisors/{self._id}/feedback",
                   {"score": float(score), "knobs": knobs})

    def speculate(self, score: float, knobs, fit=None) -> None:
        self._call("POST", f"/advisors/{self._id}/speculate",
                   {"score": float(score), "knobs": knobs, "fit": fit})
