"""Client: the user-facing SDK over the admin REST API.

The port's own copy of ``rafiki_tpu/client/client.py``, with the same
verbs and the same requests, on the standard library's
``urllib.request`` instead of ``requests``: JSON bodies, a multipart
upload for the model template, and a timeout on every call
(``timeout_s``). It drives either package's admin server.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional
from urllib.parse import urlencode


class ClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _multipart(fields: Dict[str, str], files: Dict[str, tuple]) -> tuple:
    """``(body, content type)`` of a multipart/form-data request;
    ``files`` maps a field to ``(filename, bytes)``."""
    boundary = uuid.uuid4().hex
    out = []
    for name, value in fields.items():
        out += [f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n"
                .encode(), value.encode(), b"\r\n"]
    for name, (filename, data) in files.items():
        out += [f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream\r\n\r\n"
                .encode(), data, b"\r\n"]
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


#: No proxy: the admin and predictors are addressed directly, whatever
#: proxy the environment names.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _send(method: str, url: str, headers: Dict[str, str], body: Optional[bytes],
          timeout_s: float) -> Any:
    req = urllib.request.Request(url, data=body, method=method, headers=headers)
    try:
        with _OPENER.open(req, timeout=timeout_s) as resp:
            data = resp.read()
            ctype = resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        text = e.read().decode("utf-8", "replace")
        e.close()
        try:
            message = json.loads(text).get("error", text)
        except (ValueError, AttributeError):
            message = text
        raise ClientError(e.code, message) from None
    return json.loads(data) if "json" in ctype else data


class Client:
    def __init__(self, admin_host: str = "127.0.0.1", admin_port: int = 3000,
                 timeout_s: float = 60.0):
        self._base = f"http://{admin_host}:{admin_port}"
        self._token: Optional[str] = None
        self.timeout_s = timeout_s

    # -- plumbing ------------------------------------------------------------

    def _headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self._token}"} if self._token else {}

    def _request(self, method: str, path: str, json_body: Any = None,
                 params: Optional[dict] = None) -> Any:
        url = self._base + path + (f"?{urlencode(params)}" if params else "")
        headers = self._headers()
        body = None
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        return _send(method, url, headers, body, self.timeout_s)

    def _get(self, path: str, params: Optional[dict] = None) -> Any:
        return self._request("GET", path, params=params)

    def _post(self, path: str, body: Optional[dict] = None) -> Any:
        return self._request("POST", path, json_body=body or {})

    # -- auth / users --------------------------------------------------------

    def login(self, email: str, password: str) -> Dict[str, Any]:
        out = self._post("/tokens", {"email": email, "password": password})
        self._token = out["token"]
        return out

    def logout(self) -> None:
        self._token = None

    def create_user(self, email: str, password: str, user_type: str) -> dict:
        return self._post("/users", {"email": email, "password": password,
                                     "user_type": user_type})

    def get_users(self) -> List[dict]:
        return self._get("/users")

    def ban_user(self, email: str) -> dict:
        return self._request("DELETE", "/users", json_body={"email": email})

    # -- models --------------------------------------------------------------

    def create_model(self, name: str, task: str, model_file_path: str | Path,
                     model_class: str, dependencies: Optional[dict] = None,
                     access_right: str = "PRIVATE", docs: str = "") -> dict:
        """Upload a model template .py (multipart)."""
        body, ctype = _multipart(
            {"name": name, "task": task, "model_class": model_class,
             "dependencies": json.dumps(dependencies or {}),
             "access_right": access_right, "docs": docs},
            {"model_file": (Path(model_file_path).name, Path(model_file_path).read_bytes())})
        headers = dict(self._headers(), **{"Content-Type": ctype})
        return _send("POST", self._base + "/models", headers, body, self.timeout_s)

    def get_models(self, task: Optional[str] = None) -> List[dict]:
        return self._get("/models", params={"task": task} if task else None)

    def get_model(self, name: str) -> dict:
        return self._get(f"/models/{name}")

    def download_model_file(self, name: str) -> bytes:
        return self._get(f"/models/{name}/file")

    # -- train jobs ----------------------------------------------------------

    def create_train_job(self, app: str, task: str, train_dataset_uri: str,
                         val_dataset_uri: str, budget: Dict[str, Any],
                         model_names: Optional[List[str]] = None,
                         advisor_kind: str = "gp",
                         devices_per_trial: int = 1) -> dict:
        return self._post("/train_jobs", {
            "app": app, "task": task, "train_dataset_uri": train_dataset_uri,
            "val_dataset_uri": val_dataset_uri, "budget": budget,
            "model_names": model_names, "advisor_kind": advisor_kind,
            "devices_per_trial": devices_per_trial})

    def get_train_jobs(self) -> List[dict]:
        return self._get("/train_jobs")

    def _vpath(self, prefix: str, app: str, app_version: int, suffix: str = "") -> str:
        """-1 (or 0) means "latest version" — the server resolves it."""
        if app_version > 0:
            return f"{prefix}/{app}/{app_version}{suffix}"
        return f"{prefix}/{app}{suffix}"

    def get_train_job(self, app: str, app_version: int = -1) -> dict:
        return self._get(self._vpath("/train_jobs", app, app_version))

    def stop_train_job(self, app: str, app_version: int = -1) -> dict:
        return self._post(self._vpath("/train_jobs", app, app_version, "/stop"))

    def wait_until_train_job_has_stopped(self, app: str, app_version: int = -1,
                                         timeout: float = 3600.0,
                                         poll_s: float = 1.0) -> dict:
        """Poll until the job leaves STARTED/RUNNING."""
        deadline = time.monotonic() + timeout
        while True:
            job = self.get_train_job(app, app_version)
            if job["status"] not in ("STARTED", "RUNNING"):
                return job
            if time.monotonic() > deadline:
                raise TimeoutError(f"Train job {app} still {job['status']}")
            time.sleep(poll_s)

    # -- trials --------------------------------------------------------------

    def get_trials_of_train_job(self, app: str, app_version: int = -1) -> List[dict]:
        return self._get(self._vpath("/train_jobs", app, app_version, "/trials"))

    def get_best_trials_of_train_job(self, app: str, app_version: int = -1,
                                     max_count: int = 2) -> List[dict]:
        return self._get(self._vpath("/train_jobs", app, app_version, "/trials"),
                         params={"type": "best", "max_count": max_count})

    def get_trial(self, trial_id: str) -> dict:
        return self._get(f"/trials/{trial_id}")

    def get_trial_logs(self, trial_id: str) -> List[dict]:
        return self._get(f"/trials/{trial_id}/logs")

    def get_trial_parameters(self, trial_id: str) -> bytes:
        return self._get(f"/trials/{trial_id}/parameters")

    # -- inference jobs ------------------------------------------------------

    def create_inference_job(self, app: str, app_version: int = -1,
                             max_models: int = 2,
                             gateway: Optional[dict] = None) -> dict:
        """``gateway`` carries per-job serving-gateway overrides —
        routing policy, admission limits, microbatching."""
        body = {"app": app, "app_version": app_version, "max_models": max_models}
        if gateway is not None:
            body["gateway"] = gateway
        return self._post("/inference_jobs", body)

    def get_inference_job(self, app: str, app_version: int = -1) -> dict:
        return self._get(self._vpath("/inference_jobs", app, app_version))

    def stop_inference_job(self, app: str, app_version: int = -1) -> dict:
        return self._post(self._vpath("/inference_jobs", app, app_version, "/stop"))

    def predict(self, app: str, queries: List[Any],
                app_version: int = -1) -> List[Any]:
        out = self._post(f"/predict/{app}",
                         {"queries": queries, "app_version": app_version})
        return out["predictions"]

    def predict_via_predictor(self, predictor_host: str,
                              queries: List[Any]) -> List[Any]:
        """POST straight to an inference job's published predictor
        endpoint (``get_inference_job()['predictor_host']``), bypassing
        the admin."""
        out = _send("POST", f"http://{predictor_host}/predict",
                    {"Content-Type": "application/json"},
                    json.dumps({"queries": queries}).encode(), self.timeout_s)
        return out["predictions"]
