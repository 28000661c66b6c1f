"""Predictor HTTP frontend: the published ``POST /predict`` endpoint.

The port's own copy of ``rafiki_tpu/predictor/app.py`` on the standard
library's ``http.server`` (``utils/httpd.py``) instead of werkzeug, with
the same routes, status codes and bodies. Each inference job publishes
one of these (loopback by default); clients POST queries there and get
ensembled predictions. Every request goes through the serving
:class:`~rafiki_tpu_torch.gateway.Gateway`. Status mapping:

  200  admitted and answered
  400  malformed body (not JSON / queries not a list / bad deadline_s)
  413  more queries than ``max_queries_per_request``
  429  shed by admission control (``Retry-After`` header set)
  503  no live workers, or gateway draining (``Retry-After`` set)
  500  anything else

Each request runs under one trace: the caller's ``X-Rafiki-Trace-Id``
header, or a fresh id, echoed in the body's ``trace_id`` and the
response header, so callers can ``python -m rafiki_tpu_torch.obs trace
<id>`` it. A request's server time is split into three
telemetry spans, all under its trace: ``predictor_http.decode`` (JSON
body to the queries, numeric queries to arrays; the arrays alone in the
nested ``predictor_http.rows``), ``gateway.predict`` and
``predictor_http.encode``. ``GET /metrics?format=prom`` serves the
snapshot as Prometheus text (``obs/prom.py``).
"""

from __future__ import annotations

import json
import math
from typing import Any, List, Union

import numpy as np

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.gateway import Gateway, ShedError
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs import prom
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.utils.httpd import Request, Response, json_response, start_server
from rafiki_tpu_torch.utils.jsonable import jsonable

_BAD_BODY = {"error": "Body must be {\"queries\": [...]}"}


def _as_rows(queries: List[Any]) -> List[Any]:
    """Numeric queries of one shape become the rows of one array (the
    models stack them without walking nested lists); anything else
    (ragged, strings, booleans) passes on as decoded."""
    try:
        arr = np.asarray(queries)
    except ValueError:  # ragged
        return queries
    if arr.ndim < 2 or arr.dtype.kind not in "iuf":
        return queries
    return list(arr)


class PredictorApp:
    """POST /predict {"queries": [...], "deadline_s"?: float},
    GET /healthz (503 + draining while the gateway drains),
    GET /gateway (admission/breaker/routing stats),
    POST /drain (stop admitting, flush inflight),
    GET /metrics (telemetry snapshot of this process)."""

    def __init__(self, target: Union[Gateway, Predictor]):
        # A bare Predictor gets a default-config Gateway.
        self.gateway = target if isinstance(target, Gateway) else Gateway(target)

    def __call__(self, request: Request) -> Response:
        route = (request.method, request.path)
        try:
            if route == ("GET", "/healthz"):
                if self.gateway.draining:
                    return json_response({"status": "draining"}, 503)
                return json_response({"status": "ok"})
            if route == ("GET", "/metrics"):
                if request.args.get("format") == "prom":
                    return Response(prom.to_prometheus(telemetry.snapshot()).encode(),
                                    content_type="text/plain; version=0.0.4")
                return json_response(telemetry.snapshot())
            if route == ("GET", "/gateway"):
                return json_response(self.gateway.stats())
            if route == ("POST", "/drain"):
                flushed = self.gateway.drain()
                return json_response({"status": "draining", "flushed": flushed})
            if route == ("POST", "/predict"):
                return self._predict(request)
            return json_response({"error": "Not found"}, 404)
        except ShedError as e:
            response = json_response({"error": str(e), "reason": e.reason},
                                     503 if e.reason == "draining" else 429)
            response.headers["Retry-After"] = str(max(1, math.ceil(e.retry_after_s)))
            return response
        except RuntimeError as e:  # e.g. no live workers
            return json_response({"error": str(e)}, 503)
        except Exception as e:
            return json_response({"error": f"{type(e).__name__}: {e}"}, 500)

    def _predict(self, request: Request) -> Response:
        # Trace propagation in: a client (or upstream proxy) may pin the
        # trace id; otherwise one is minted here. Either way it is echoed.
        with trace_context.trace(request.headers.get("X-Rafiki-Trace-Id")) as tid:
            return self._predict_traced(request, tid)

    def _predict_traced(self, request: Request, trace_id: str) -> Response:
        with telemetry.span("predictor_http.decode", bytes=len(request.body)):
            body = request.get_json()
            if not isinstance(body, dict) or not isinstance(body.get("queries"), list):
                return json_response(_BAD_BODY, 400)
            queries = body["queries"]
            cap = self.gateway.cfg.max_queries_per_request
            if len(queries) > cap:
                return json_response(
                    {"error": f"{len(queries)} queries exceeds the "
                              f"per-request limit of {cap}"}, 413)
            deadline_s = body.get("deadline_s")
            if deadline_s is not None:
                try:
                    deadline_s = float(deadline_s)
                except (TypeError, ValueError):
                    return json_response({"error": "deadline_s must be a number"}, 400)
                if deadline_s <= 0:
                    return json_response({"error": "deadline_s must be > 0"}, 400)
            with telemetry.span("predictor_http.rows", queries=len(queries)):
                queries = _as_rows(queries)
        preds = self.gateway.predict(queries, deadline_s=deadline_s)
        with telemetry.span("predictor_http.encode", queries=len(preds)):
            response = Response(json.dumps({"predictions": jsonable(preds),
                                            "trace_id": trace_id}).encode())
        response.headers["X-Rafiki-Trace-Id"] = trace_id
        return response


def start_predictor_server(target: Union[Gateway, Predictor],
                           host: str = "127.0.0.1", port: int = 0):
    """Serve a gateway (or bare predictor) from a daemon thread; returns
    (server, "host:port")."""
    server, _ = start_server(PredictorApp(target), host, port, name="predictor-http")
    return server, f"{host}:{server.server_port}"
