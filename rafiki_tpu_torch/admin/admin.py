"""Admin: the control-plane business logic.

The port's own copy of ``rafiki_tpu/admin/admin.py``: user, model and
job lifecycle — create_user, create_model (validated on upload: the
template must load as a port ``BaseModel`` and its knob config must
serialize), create_train_job (budget validation, model selection for
the task), stop_train_job, create_inference_job over the top-k best
trials, trial queries, superadmin seeding, and the same row shapers.
The REST app (app.py) is a thin shim over this class, which is equally
usable in-process.

``device``: CUDA unless the caller asks for the CPU; it raises without
CUDA. Not ported yet: ``recover_trials`` (the recovery sweep), and
within-trial data parallelism, so ``devices_per_trial`` must be 1.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.admin.services_manager import ServicesManager
from rafiki_tpu_torch.config import Config, get_config
from rafiki_tpu_torch.constants import (
    BudgetType,
    InferenceJobStatus,
    TrainJobStatus,
    UserType,
)
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.model.knobs import serialize_knob_config
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.auth import (
    AuthError,
    generate_token,
    hash_password,
    verify_password,
)
from rafiki_tpu_torch.utils.backend import DeviceLike, resolve_device
from rafiki_tpu_torch.utils.events import events

_VALID_BUDGET_KEYS = {b.value for b in BudgetType}


class NotFoundError(KeyError):
    """Entity lookup failed (distinct from a missing-request-field
    KeyError so the REST layer can map them to 404 vs 400)."""

    def __str__(self) -> str:  # KeyError repr-quotes its arg; keep it readable
        return self.args[0] if self.args else "Not found"


class Admin:
    def __init__(self, config: Optional[Config] = None, device: DeviceLike = None):
        device = resolve_device(device)  # before anything is written
        self.config = (config or get_config()).ensure_dirs()
        self.store = MetaStore(self.config.db_path)
        self.params_store = ParamsStore(self.config.params_dir)
        self.services = ServicesManager(self.store, self.params_store, config=self.config,
                                        device=device)
        # Serializes inference-job creation per process: the duplicate
        # check below is check-then-act and the REST server is threaded.
        self._inference_lock = threading.Lock()
        events.configure(self.config.logs_dir)
        self._seed_superadmin()

    def _seed_superadmin(self) -> None:
        if self.store.get_user_by_email(self.config.superadmin_email) is None:
            self.store.create_user(
                self.config.superadmin_email,
                hash_password(self.config.superadmin_password),
                UserType.SUPERADMIN.value)

    # -- auth / users --------------------------------------------------------

    def authenticate_user(self, email: str, password: str) -> Dict[str, Any]:
        """Check credentials; returns a dict with a JWT ``token``."""
        user = self.store.get_user_by_email(email)
        if user is None or not verify_password(password, user["password_hash"]):
            raise AuthError("Invalid email or password")
        if user["banned"]:
            raise AuthError("User is banned")
        token = generate_token(
            {"user_id": user["id"], "user_type": user["user_type"]},
            self.config.jwt_secret, ttl_s=self.config.jwt_ttl_hours * 3600)
        return {"user_id": user["id"], "user_type": user["user_type"], "token": token}

    def create_user(self, email: str, password: str, user_type: str) -> Dict[str, Any]:
        if user_type not in {u.value for u in UserType}:
            raise ValueError(f"Invalid user type {user_type!r}")
        if self.store.get_user_by_email(email) is not None:
            raise ValueError(f"User {email!r} already exists")
        user = self.store.create_user(email, hash_password(password), user_type)
        return _public_user(user)

    def get_users(self) -> List[Dict[str, Any]]:
        return [_public_user(u) for u in self.store.get_users()]

    def ban_user(self, email: str) -> Dict[str, Any]:
        user = self.store.get_user_by_email(email)
        if user is None:
            raise NotFoundError(f"No user {email!r}")
        self.store.ban_user(user["id"])
        return _public_user({**user, "banned": 1})

    # -- models --------------------------------------------------------------

    def create_model(self, user_id: Optional[str], name: str, task: str,
                     model_file: bytes, model_class: str,
                     dependencies: Optional[Dict[str, str]] = None,
                     access_right: str = "PRIVATE", docs: str = "") -> Dict[str, Any]:
        """Validate the template on upload: the class must load and its
        knob config must serialize."""
        try:
            cls = load_model_class(model_file, model_class)
            serialize_knob_config(cls.get_knob_config())
        except Exception as e:
            raise ValueError(f"Invalid model template: {e}") from e
        row = self.store.create_model(name, task, user_id, model_file, model_class,
                                      dependencies, access_right, docs)
        return _public_model(row)

    def get_model(self, name: str) -> Dict[str, Any]:
        row = self.store.get_model_by_name(name)
        if row is None:
            raise NotFoundError(f"No model {name!r}")
        return _public_model(row)

    def get_model_file(self, name: str, requester_id: Optional[str] = None,
                       requester_type: Optional[str] = None) -> bytes:
        """Template source download. PRIVATE models are readable only by
        their owner (or an admin); pass requester_* from the auth layer
        — ``None`` means a trusted in-process caller."""
        row = self.store.get_model_by_name(name)
        if row is None:
            raise NotFoundError(f"No model {name!r}")
        if (requester_type is not None
                and requester_type not in (UserType.SUPERADMIN.value,
                                           UserType.ADMIN.value)
                and row["access_right"] == "PRIVATE"
                and row["user_id"] is not None
                and row["user_id"] != requester_id):
            raise AuthError(f"Model {name!r} is private")
        return row["model_file"]

    def get_models(self, task: Optional[str] = None) -> List[Dict[str, Any]]:
        if task:
            return [_public_model(m) for m in self.store.get_models_of_task(task)]
        return [_public_model(m) for m in self.store.get_models()]

    # -- train jobs ----------------------------------------------------------

    def create_train_job(self, user_id: Optional[str], app: str, task: str,
                         train_dataset_uri: str, val_dataset_uri: str,
                         budget: Dict[str, Any],
                         model_names: Optional[List[str]] = None,
                         advisor_kind: str = "gp",
                         devices_per_trial: int = 1) -> Dict[str, Any]:
        bad = set(budget) - _VALID_BUDGET_KEYS
        if bad:
            raise ValueError(f"Unknown budget keys {sorted(bad)}; valid: "
                             f"{sorted(_VALID_BUDGET_KEYS)}")
        if not budget:
            raise ValueError("Budget must not be empty "
                             "(e.g. {'MODEL_TRIAL_COUNT': 5})")
        if devices_per_trial != 1:
            raise ValueError("devices_per_trial must be 1: within-trial data "
                             "parallelism is not ported")

        if model_names:
            models = []
            for n in model_names:
                m = self.store.get_model_by_name(n)
                if m is None:
                    raise NotFoundError(f"No model {n!r}")
                models.append(m)
        else:
            models = self.store.get_models_of_task(task)
        if not models:
            raise ValueError(f"No models available for task {task!r}")

        job = self.store.create_train_job(app, task, user_id, train_dataset_uri,
                                          val_dataset_uri, budget)
        for m in models:
            self.store.create_sub_train_job(job["id"], m["id"])
        self.services.create_train_services(job["id"], advisor_kind=advisor_kind)
        return _public_train_job(job)

    def get_train_job(self, app: str, app_version: int = -1,
                      user_id: Optional[str] = None) -> Dict[str, Any]:
        job = self.store.get_train_job_by_app(app, app_version, user_id)
        if job is None:
            raise NotFoundError(f"No train job for app {app!r}")
        out = _public_train_job(job)
        out["sub_train_jobs"] = [
            {"id": s["id"], "model_id": s["model_id"], "status": s["status"]}
            for s in self.store.get_sub_train_jobs(job["id"])]
        out["services"] = self.store.get_services_of_job(job["id"])
        return out

    def get_train_jobs(self, user_id: Optional[str] = None) -> List[Dict[str, Any]]:
        return [_public_train_job(j) for j in self.store.get_train_jobs(user_id)]

    def stop_train_job(self, app: str, app_version: int = -1,
                       user_id: Optional[str] = None) -> Dict[str, Any]:
        job = self.store.get_train_job_by_app(app, app_version, user_id)
        if job is None:
            raise NotFoundError(f"No train job for app {app!r}")
        self.services.stop_train_services(job["id"])
        return _public_train_job(self.store.get_train_job(job["id"]))

    # -- trials --------------------------------------------------------------

    def get_trials_of_train_job(self, app: str, app_version: int = -1) -> List[dict]:
        job = self.store.get_train_job_by_app(app, app_version)
        if job is None:
            raise NotFoundError(f"No train job for app {app!r}")
        return [_public_trial(t) for t in self.store.get_trials_of_train_job(job["id"])]

    def get_best_trials_of_train_job(self, app: str, app_version: int = -1,
                                     max_count: int = 2) -> List[dict]:
        job = self.store.get_train_job_by_app(app, app_version)
        if job is None:
            raise NotFoundError(f"No train job for app {app!r}")
        return [_public_trial(t) for t in
                self.store.get_best_trials_of_train_job(job["id"], limit=max_count)]

    def get_trial(self, trial_id: str) -> dict:
        t = self.store.get_trial(trial_id)
        if t is None:
            raise NotFoundError(f"No trial {trial_id!r}")
        return _public_trial(t)

    def get_trial_logs(self, trial_id: str) -> List[dict]:
        return self.store.get_trial_logs(trial_id)

    def get_trial_parameters(self, trial_id: str) -> bytes:
        t = self.store.get_trial(trial_id)
        if t is None or not t.get("params_id"):
            raise NotFoundError(f"No parameters for trial {trial_id!r}")
        return self.params_store.load(t["params_id"])

    # -- inference jobs ------------------------------------------------------

    def create_inference_job(self, user_id: Optional[str], app: str,
                             app_version: int = -1,
                             max_models: int = 2,
                             gateway: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, Any]:
        job = self.store.get_train_job_by_app(app, app_version, user_id)
        if job is None:
            raise NotFoundError(f"No train job for app {app!r}")
        if job["status"] not in (TrainJobStatus.COMPLETED.value,
                                 TrainJobStatus.STOPPED.value):
            raise ValueError(
                f"Train job for {app!r} is {job['status']}; wait for it to finish")
        with self._inference_lock:
            existing = self.store.get_inference_job_of_train_job(job["id"])
            if existing is not None:
                raise ValueError(f"App {app!r} already has a running inference job")
            best = self.store.get_best_trials_of_train_job(job["id"], limit=max_models)
            if not best:
                raise ValueError(f"No completed trials for app {app!r}")
            inf = self.store.create_inference_job(job["id"], user_id)
            try:
                self.services.create_inference_services(
                    inf["id"], best, gateway_overrides=gateway)
            except Exception:
                self.store.update_inference_job(inf["id"],
                                                status=InferenceJobStatus.ERRORED.value)
                raise
        return self.get_inference_job(app, app_version)

    def get_inference_job(self, app: str, app_version: int = -1,
                          user_id: Optional[str] = None) -> Dict[str, Any]:
        job = self.store.get_train_job_by_app(app, app_version, user_id)
        if job is None:
            raise NotFoundError(f"No train job for app {app!r}")
        inf = self.store.get_inference_job_of_train_job(job["id"])
        if inf is None:
            raise NotFoundError(f"No running inference job for app {app!r}")
        return {**inf, "app": app, "app_version": job["app_version"]}

    def stop_inference_job(self, app: str, app_version: int = -1,
                           user_id: Optional[str] = None) -> Dict[str, Any]:
        inf = self.get_inference_job(app, app_version, user_id)
        self.services.stop_inference_services(inf["id"])
        return {**inf, "status": InferenceJobStatus.STOPPED.value}

    def predict(self, app: str, queries: List[Any],
                app_version: int = -1) -> List[Any]:
        """Route queries to the app's live predictor through its serving
        gateway (the in-process path; HTTP clients hit the predictor
        app directly)."""
        inf = self.get_inference_job(app, app_version)
        gateway = self.services.get_gateway(inf["id"])
        if gateway is None:
            raise RuntimeError(f"Inference job {inf['id']} has no live predictor "
                               "in this process")
        return gateway.predict(queries)

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        self.services.stop_all()
        self.store.close()


# -- row shapers (strip secrets/blobs from API responses) ---------------------


def _public_user(u: dict) -> dict:
    return {"id": u["id"], "email": u["email"], "user_type": u["user_type"],
            "banned": bool(u["banned"])}


def _public_model(m: dict) -> dict:
    return {k: m[k] for k in
            ("id", "name", "task", "user_id", "model_class", "dependencies",
             "access_right", "docs", "created_at")}


def _public_train_job(j: dict) -> dict:
    return {k: j[k] for k in
            ("id", "app", "app_version", "task", "user_id", "train_dataset_uri",
             "val_dataset_uri", "budget", "status", "created_at", "stopped_at")}


def _public_trial(t: dict) -> dict:
    return {k: t[k] for k in
            ("id", "no", "model_name", "knobs", "status", "score", "params_id",
             "worker_id", "error", "started_at", "stopped_at")}
