"""Admin REST app: HTTP surface over the Admin business logic.

The port's own copy of ``rafiki_tpu/admin/app.py`` on the standard
library's ``http.server`` (``utils/httpd.py``) instead of werkzeug, with
the same paths, methods, status codes and JSON: 401 for a missing,
bad or insufficient token (a role that may not call a route gets 401,
as in the JAX package), 404 for an unknown route or entity, 405 for a
known path with another method, 400 for a missing field or a bad
value, 500 otherwise. Bodies are JSON, urlencoded or multipart (the
clients upload model templates as multipart).

Route table:
  POST /tokens                       login -> JWT
  POST /users                        create user            (admin)
  GET  /users                        list users             (admin)
  DELETE /users                      ban user               (admin)
  POST /models                       upload model template  (model dev)
  GET  /models                       list models
  GET  /models/<name>                model detail
  GET  /models/<name>/file           download template bytes
  POST /train_jobs                   create train job       (app dev)
  GET  /train_jobs                   list my train jobs
  GET  /train_jobs/<app>[/<v>]       latest or given version
  POST /train_jobs/<app>[/<v>]/stop  stop job
  GET  /train_jobs/<app>[/<v>]/trials  trials (?type=best&max_count=k)
  GET  /trials/<id>                  trial detail
  GET  /trials/<id>/logs             trial logs
  GET  /trials/<id>/parameters       trained params blob
  POST /inference_jobs               deploy app             (app dev)
  GET  /inference_jobs/<app>[/<v>]   inference job detail
  POST /inference_jobs/<app>[/<v>]/stop
  POST /predict/<app>                run queries through the ensemble
  POST /recovery                     re-run orphaned trials (admin;
                                     {"stale_after_s", "wait"}, wait
                                     false by default)
  GET  /advisors/<id>/propose, POST /advisors/<id>/feedback
  GET  /                             web admin UI (static page,
                                     ``rafiki_tpu_torch/web/index.html``,
                                     the port's copy of the JAX
                                     package's ``rafiki_tpu/web/index.html``)
  GET  /healthz                      liveness
  GET  /metrics                      telemetry snapshot (JSON;
                                     ?format=prom: Prometheus text)
"""

from __future__ import annotations

import json
import re
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.admin.admin import Admin, NotFoundError
from rafiki_tpu_torch.constants import UserType
from rafiki_tpu_torch.obs import prom
from rafiki_tpu_torch.utils.auth import AuthError, check_user_type, decode_token
from rafiki_tpu_torch.utils.backend import DeviceLike
from rafiki_tpu_torch.utils.httpd import AppServer, Request, Response, json_response
from rafiki_tpu_torch.utils.jsonable import jsonable

_WEB_DIR = Path(__file__).resolve().parent.parent / "web"

_APP = r"(?P<app>[^/]+)"
_VERSION = r"(?:/(?P<app_version>\d+))?"
#: (method, path pattern, endpoint), in werkzeug's rule syntax terms:
#: ``<name>`` is one path segment, ``<int:app_version>`` digits.
_ROUTES = [
    ("GET", r"/", "web_index"),
    ("GET", r"/healthz", "healthz"),
    ("GET", r"/metrics", "metrics"),
    ("POST", r"/tokens", "login"),
    ("POST", r"/users", "create_user"),
    ("GET", r"/users", "get_users"),
    ("DELETE", r"/users", "ban_user"),
    ("POST", r"/models", "create_model"),
    ("GET", r"/models", "get_models"),
    ("GET", r"/models/(?P<name>[^/]+)", "get_model"),
    ("GET", r"/models/(?P<name>[^/]+)/file", "get_model_file"),
    ("POST", r"/train_jobs", "create_train_job"),
    ("GET", r"/train_jobs", "get_train_jobs"),
    ("GET", rf"/train_jobs/{_APP}{_VERSION}", "get_train_job"),
    ("POST", rf"/train_jobs/{_APP}{_VERSION}/stop", "stop_train_job"),
    ("GET", rf"/train_jobs/{_APP}{_VERSION}/trials", "get_trials"),
    ("GET", r"/trials/(?P<trial_id>[^/]+)", "get_trial"),
    ("GET", r"/trials/(?P<trial_id>[^/]+)/logs", "get_trial_logs"),
    ("GET", r"/trials/(?P<trial_id>[^/]+)/parameters", "get_trial_parameters"),
    ("POST", r"/inference_jobs", "create_inference_job"),
    ("GET", rf"/inference_jobs/{_APP}{_VERSION}", "get_inference_job"),
    ("POST", rf"/inference_jobs/{_APP}{_VERSION}/stop", "stop_inference_job"),
    ("POST", rf"/predict/{_APP}", "predict"),
    ("POST", r"/recovery", "recover"),
    ("GET", r"/advisors/(?P<advisor_id>[^/]+)/propose", "advisor_propose"),
    ("POST", r"/advisors/(?P<advisor_id>[^/]+)/feedback", "advisor_feedback"),
]
_COMPILED = [(m, re.compile(p + r"\Z"), e) for m, p, e in _ROUTES]


class MethodNotAllowed(Exception):
    pass


def _match(method: str, path: str):
    allowed = False
    for m, pattern, endpoint in _COMPILED:
        hit = pattern.match(path)
        if hit is None:
            continue
        if m != method:
            allowed = True
            continue
        args = {k: v for k, v in hit.groupdict().items() if v is not None}
        if "app_version" in args:
            args["app_version"] = int(args["app_version"])
        return endpoint, args
    if allowed:
        raise MethodNotAllowed()
    raise NotFoundError("Not found")


class AdminApp:
    """``app(request) -> Response``; :func:`serve` runs it."""

    def __init__(self, admin: Admin):
        self.admin = admin

    def __call__(self, request: Request) -> Response:
        try:
            endpoint, args = _match(request.method, request.path)
            return getattr(self, f"ep_{endpoint}")(request, **args)
        except MethodNotAllowed:
            return json_response({"error": "The method is not allowed for the "
                                           "requested URL."}, 405)
        except AuthError as e:
            return json_response({"error": str(e)}, 401)
        except NotFoundError as e:
            return json_response({"error": str(e)}, 404)
        except ValueError as e:
            return json_response({"error": str(e)}, 400)
        except Exception as e:  # don't leak stack traces to clients
            return json_response({"error": f"Internal error: {type(e).__name__}: {e}"}, 500)

    # -- auth helper ---------------------------------------------------------

    def _auth(self, request: Request,
              user_types: Optional[List[str]] = None) -> Dict[str, Any]:
        header = request.headers.get("Authorization") or ""
        if not header.startswith("Bearer "):
            raise AuthError("Missing Bearer token")
        payload = decode_token(header[len("Bearer "):], self.admin.config.jwt_secret)
        if user_types is not None:
            check_user_type(payload.get("user_type", ""), user_types)
        return payload

    @staticmethod
    def _scope(user: Dict[str, Any]) -> Optional[str]:
        """Ownership scope for mutations: admins act on any user's jobs,
        developers only on their own."""
        if user.get("user_type") in (UserType.SUPERADMIN.value, UserType.ADMIN.value):
            return None
        return user.get("user_id")

    @staticmethod
    def _field(body: Dict[str, Any], key: str) -> Any:
        """Required request field; absence is the caller's fault (400)."""
        if key not in body:
            raise ValueError(f"Missing required field: {key}")
        return body[key]

    @staticmethod
    def _body(request: Request) -> Dict[str, Any]:
        if request.mimetype == "application/json":
            return request.get_json() or {}
        # multipart/form-urlencoded: values arrive as strings; JSON-decode
        # the ones the API defines as structured.
        out: Dict[str, Any] = dict(request.form[0])
        for key in ("budget", "dependencies", "model_names", "queries", "knobs"):
            if key in out and isinstance(out[key], str):
                try:
                    out[key] = json.loads(out[key])
                except json.JSONDecodeError:
                    pass
        return out

    # -- endpoints -----------------------------------------------------------

    def ep_healthz(self, request: Request) -> Response:
        return json_response({"status": "ok"})

    def ep_metrics(self, request: Request) -> Response:
        # Read-only process introspection, unauthenticated like
        # /healthz: the snapshot carries timings and counts, never
        # trial data or credentials. ?format=prom serves the same
        # snapshot in Prometheus text exposition for scrapers.
        if request.args.get("format") == "prom":
            return Response(prom.to_prometheus(telemetry.snapshot()).encode(),
                            content_type="text/plain; version=0.0.4")
        return json_response(telemetry.snapshot())

    def ep_web_index(self, request: Request) -> Response:
        index = _WEB_DIR / "index.html"
        if index.exists():
            return Response(index.read_bytes(), content_type="text/html; charset=utf-8")
        return json_response({"service": "rafiki-tpu admin", "docs": "/healthz"})

    def ep_login(self, request: Request) -> Response:
        body = self._body(request)
        return json_response(self.admin.authenticate_user(
            body.get("email", ""), body.get("password", "")))

    def ep_create_user(self, request: Request) -> Response:
        self._auth(request, [UserType.ADMIN.value])
        body = self._body(request)
        return json_response(self.admin.create_user(
            self._field(body, "email"), self._field(body, "password"),
            self._field(body, "user_type")), 201)

    def ep_get_users(self, request: Request) -> Response:
        self._auth(request, [UserType.ADMIN.value])
        return json_response(self.admin.get_users())

    def ep_ban_user(self, request: Request) -> Response:
        self._auth(request, [UserType.ADMIN.value])
        return json_response(self.admin.ban_user(self._field(self._body(request), "email")))

    def ep_create_model(self, request: Request) -> Response:
        user = self._auth(request, [UserType.MODEL_DEVELOPER.value])
        body = self._body(request)
        files = request.form[1]
        if "model_file" in files:
            model_file = files["model_file"]
        else:
            model_file = body.get("model_file", "").encode()
        return json_response(self.admin.create_model(
            user["user_id"], self._field(body, "name"), self._field(body, "task"),
            model_file, self._field(body, "model_class"),
            body.get("dependencies") or {},
            body.get("access_right", "PRIVATE"), body.get("docs", "")), 201)

    def ep_get_models(self, request: Request) -> Response:
        self._auth(request)
        return json_response(self.admin.get_models(request.args.get("task")))

    def ep_get_model(self, request: Request, name: str) -> Response:
        self._auth(request)
        return json_response(self.admin.get_model(name))

    def ep_get_model_file(self, request: Request, name: str) -> Response:
        user = self._auth(request, [UserType.MODEL_DEVELOPER.value])
        return Response(self.admin.get_model_file(name,
                                                  requester_id=user.get("user_id"),
                                                  requester_type=user.get("user_type")),
                        content_type="application/octet-stream")

    def ep_create_train_job(self, request: Request) -> Response:
        user = self._auth(request, [UserType.APP_DEVELOPER.value])
        body = self._body(request)
        return json_response(self.admin.create_train_job(
            user["user_id"], self._field(body, "app"), self._field(body, "task"),
            self._field(body, "train_dataset_uri"),
            self._field(body, "val_dataset_uri"), self._field(body, "budget"),
            model_names=body.get("model_names"),
            advisor_kind=body.get("advisor_kind", "gp"),
            devices_per_trial=int(body.get("devices_per_trial", 1))), 201)

    def ep_get_train_jobs(self, request: Request) -> Response:
        user = self._auth(request)
        return json_response(self.admin.get_train_jobs(user["user_id"]))

    def ep_get_train_job(self, request: Request, app: str,
                         app_version: int = -1) -> Response:
        self._auth(request)
        return json_response(self.admin.get_train_job(app, app_version))

    def ep_stop_train_job(self, request: Request, app: str,
                          app_version: int = -1) -> Response:
        user = self._auth(request, [UserType.APP_DEVELOPER.value])
        return json_response(self.admin.stop_train_job(app, app_version,
                                                       user_id=self._scope(user)))

    def ep_get_trials(self, request: Request, app: str,
                      app_version: int = -1) -> Response:
        self._auth(request)
        if request.args.get("type") == "best":
            max_count = int(request.args.get("max_count", 2))
            return json_response(self.admin.get_best_trials_of_train_job(
                app, app_version, max_count))
        return json_response(self.admin.get_trials_of_train_job(app, app_version))

    def ep_get_trial(self, request: Request, trial_id: str) -> Response:
        self._auth(request)
        return json_response(self.admin.get_trial(trial_id))

    def ep_get_trial_logs(self, request: Request, trial_id: str) -> Response:
        self._auth(request)
        return json_response(self.admin.get_trial_logs(trial_id))

    def ep_get_trial_parameters(self, request: Request, trial_id: str) -> Response:
        self._auth(request)
        return Response(self.admin.get_trial_parameters(trial_id),
                        content_type="application/octet-stream")

    def ep_create_inference_job(self, request: Request) -> Response:
        user = self._auth(request, [UserType.APP_DEVELOPER.value])
        body = self._body(request)
        gateway = body.get("gateway")
        if gateway is not None and not isinstance(gateway, dict):
            raise ValueError("gateway must be an object of gateway-config "
                             "overrides (e.g. {\"policy\": \"least-loaded\"})")
        return json_response(self.admin.create_inference_job(
            self._scope(user), self._field(body, "app"),
            int(body.get("app_version", -1)),
            max_models=int(body.get("max_models", 2)),
            gateway=gateway), 201)

    def ep_get_inference_job(self, request: Request, app: str,
                             app_version: int = -1) -> Response:
        self._auth(request)
        return json_response(self.admin.get_inference_job(app, app_version))

    def ep_stop_inference_job(self, request: Request, app: str,
                              app_version: int = -1) -> Response:
        user = self._auth(request, [UserType.APP_DEVELOPER.value])
        return json_response(self.admin.stop_inference_job(app, app_version,
                                                           user_id=self._scope(user)))

    def ep_predict(self, request: Request, app: str) -> Response:
        # No auth on predict: the predictor frontend is an
        # unauthenticated app-facing endpoint.
        body = self._body(request)
        queries = body.get("queries", [])
        preds = self.admin.predict(app, queries, int(body.get("app_version", -1)))
        return json_response({"predictions": jsonable(preds)})

    def ep_recover(self, request: Request) -> Response:
        self._auth(request, [UserType.ADMIN.value])
        body = self._body(request)
        stale = body.get("stale_after_s")
        # Asynchronous by default: re-training orphans can outlive any
        # HTTP timeout.
        return json_response(self.admin.recover_trials(
            float(stale) if stale is not None else None, wait=bool(body.get("wait", False))))

    def ep_advisor_propose(self, request: Request, advisor_id: str) -> Response:
        self._auth(request)
        try:
            knobs = self.admin.services.advisors.propose(advisor_id)
        except KeyError:
            raise NotFoundError(f"No advisor {advisor_id!r}")
        return json_response({"knobs": knobs})

    def ep_advisor_feedback(self, request: Request, advisor_id: str) -> Response:
        self._auth(request)
        body = self._body(request)
        try:
            self.admin.services.advisors.feedback(
                advisor_id, float(self._field(body, "score")),
                self._field(body, "knobs"))
        except KeyError:
            raise NotFoundError(f"No advisor {advisor_id!r}")
        return json_response({"ok": True})


def make_admin_app(admin: Optional[Admin] = None, device: DeviceLike = None) -> AdminApp:
    return AdminApp(admin or Admin(device=device))


def serve(host: Optional[str] = None, port: Optional[int] = None,
          admin: Optional[Admin] = None, device: DeviceLike = None,
          stop_event: Optional[threading.Event] = None) -> None:
    """Blocking server entry point (``python -m rafiki_tpu_torch
    serve``). ``device``: where jobs train and serve, CUDA unless
    ``"cpu"`` is asked for (used when ``admin`` is None). A caller that
    runs this in a thread sets ``stop_event`` to shut the server down;
    the admin's services stop with it."""
    admin = admin or Admin(device=device)
    server = AppServer(host or admin.config.admin_host,
                       admin.config.admin_port if port is None else port,
                       AdminApp(admin))
    if stop_event is not None:
        threading.Thread(target=lambda: (stop_event.wait(), server.shutdown()),
                         name="admin-http-stop", daemon=True).start()
    print(f"rafiki-tpu-torch admin listening on "
          f"http://{server.server_name}:{server.server_port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        admin.stop()
