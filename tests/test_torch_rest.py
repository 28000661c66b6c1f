"""The port's admin REST API, Client and HTTP predictor against the JAX
package's, on the CPU.

The JAX package's ``AdminApp`` (werkzeug) and the port's stdlib app run
side by side, each over its own temporary data dir, and get the same
request sequences as ``tests/test_rest.py``: they must answer with the
same statuses and the same body keys. Each package's ``Client`` drives
the other's server, and tokens and password hashes made by one are
accepted by the other. The predictor apps answer the malformed, oversized,
shed and draining cases of ``tests/test_gateway.py`` alike. The whole
slice — upload, a GP train job, an inference job, predictions over HTTP
— runs in both packages on ``tests/test_torch_scheduler.py``'s float32
TinyFF template and must give the same knobs, scores and probabilities
within the bounds stated below.

Every HTTP call, join, job wait and server shutdown carries a timeout;
servers are shut down in fixture teardowns or ``finally`` blocks.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from werkzeug.serving import make_server

from rafiki_tpu.admin import Admin as JaxAdmin
from rafiki_tpu.admin.app import AdminApp as JaxAdminApp
from rafiki_tpu.client import Client as JaxClient, ClientError as JaxClientError
from rafiki_tpu.utils import auth as jax_auth
from rafiki_tpu_torch.admin import Admin, ServicesManager
from rafiki_tpu_torch.admin.app import AdminApp, serve
from rafiki_tpu_torch.client import Client, ClientError
from rafiki_tpu_torch.config import Config
from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.parallel.serving import build_stacked
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils import auth
from rafiki_tpu_torch.utils.httpd import start_server
from tests.test_gateway import _SlowConst
from tests.test_torch_ff import F32_TOL
from tests.test_torch_gateway import PACKAGES, PredictorServer, Serving, _gateway, http
from tests.test_torch_scheduler import TRAIN, VAL, sources  # noqa: F401 — fixture

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

TASK = "IMAGE_CLASSIFICATION"
SUPER = ("superadmin@rafiki", "rafiki")
# The same 2-trial GP job in both packages, from the same flax-drawn
# init, in float32: the ensemble's probabilities over HTTP, port vs
# JAX. Reading: 3.0e-8 max abs over 10 queries x 5 classes (two trials
# of 8 Adam steps each; the same in three runs). Bound: about 30x the
# reading, a few float32 ulps of a probability per step.
HTTP_PROB_ATOL = 1e-6


class Servers:
    """Both packages' admin servers over real HTTP, each on its own
    data dir; ``url[name]``."""

    def __init__(self, tmp_path, tmp_config):
        self.admin = {"jax": JaxAdmin(config=tmp_config),
                      "port": Admin(config=Config(data_dir=tmp_path / "port"), device="cpu")}
        self.server = {"jax": make_server("127.0.0.1", 0, JaxAdminApp(self.admin["jax"]),
                                          threaded=True)}
        self._jax_thread = threading.Thread(target=self.server["jax"].serve_forever,
                                            daemon=True)
        self._jax_thread.start()
        self.server["port"], _ = start_server(AdminApp(self.admin["port"]))
        self.port = {k: s.server_port for k, s in self.server.items()}
        self.url = {k: f"http://127.0.0.1:{p}" for k, p in self.port.items()}

    def close(self):
        for name in ("port", "jax"):
            self.server[name].shutdown()
            self.server[name].server_close()
            self.admin[name].stop()
        self._jax_thread.join(timeout=10)


@pytest.fixture()
def servers(tmp_path, tmp_config):
    s = Servers(tmp_path, tmp_config)
    try:
        yield s
    finally:
        s.close()


def call(url, method, path, body=None, token=None, raw=None, timeout_s=60.0):
    """(status, decoded body) of one request: JSON when the server says
    so, else bytes."""
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method, headers=headers)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout_s) as r:
            status, payload, ctype = r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, payload, ctype = e.code, e.read(), e.headers.get("Content-Type", "")
        e.close()
    return status, (json.loads(payload) if "json" in ctype else payload)


def _shape(body):
    if isinstance(body, dict):
        return sorted(body)
    if isinstance(body, list):
        return [_shape(b) for b in body]
    return type(body).__name__


def same(servers, method, path, body=None, token=None, raw=None):
    """The same request to both servers; the statuses and body keys
    must agree. ``token``: {name: token} or None. Returns (status,
    {name: body})."""
    out = {name: call(servers.url[name], method, path, body,
                      token and token[name], raw) for name in ("jax", "port")}
    assert out["port"][0] == out["jax"][0], (method, path, out)
    assert _shape(out["port"][1]) == _shape(out["jax"][1]), (method, path, out)
    return out["jax"][0], {k: v[1] for k, v in out.items()}


def login(servers, email, password):
    status, body = same(servers, "POST", "/tokens", {"email": email, "password": password})
    assert status == 200
    return {k: v["token"] for k, v in body.items()}


def wait_stopped(url, app, token, timeout_s=300.0):
    deadline = time.monotonic() + timeout_s
    while True:
        status, job = call(url, "GET", f"/train_jobs/{app}", token=token)
        assert status == 200, job
        if job["status"] not in ("STARTED", "RUNNING"):
            return job
        assert time.monotonic() < deadline, f"{app} still {job['status']}"
        time.sleep(0.1)


# -- statuses and bodies, request by request ----------------------------------


def test_login_and_auth_required_alike(servers):
    assert same(servers, "GET", "/models")[0] == 401
    assert same(servers, "POST", "/tokens", {"email": SUPER[0], "password": "wrong"})[0] == 401
    assert same(servers, "GET", "/models", token={"jax": "x.y.z", "port": "x.y.z"})[0] == 401
    tok = login(servers, *SUPER)
    status, body = same(servers, "GET", "/models", token=tok)
    assert status == 200 and body == {"jax": [], "port": []}
    assert same(servers, "GET", "/healthz")[0] == 200
    # /metrics: the port's snapshot holds the registry, the spans, the
    # program cache's collector, the observability plane's (perf, slo,
    # goodput), the search ledger's and the exemplar ring's (and, once a
    # gateway is built, the gateway's and its serving rollup's; once a
    # tenant fabric is made in the process, the fabric's; once an
    # autoscale controller is, the controller's); the JAX package's adds
    # the collectors of planes the port lacks.
    metrics = {k: call(servers.url[k], "GET", "/metrics") for k in ("jax", "port")}
    assert metrics["port"][0] == metrics["jax"][0] == 200
    base = {"counters", "gauges", "histograms", "spans", "ts", "program_cache", "perf", "slo",
            "goodput", "search", "serving_exemplars"}
    assert base <= set(metrics["port"][1]) <= base | {"gateway", "serving", "tenants",
                                                      "autoscale"}
    # The JAX package registers its perf and slo collectors at their first
    # use (a train epoch, a gateway request), the port at import.
    assert base - {"perf", "slo"} <= set(metrics["jax"][1])


def test_role_enforcement_alike(servers):
    tok = login(servers, *SUPER)
    assert same(servers, "POST", "/users", {"email": "app@x", "password": "pw",
                                            "user_type": "APP_DEVELOPER"}, tok)[0] == 201
    app = login(servers, "app@x", "pw")
    # An app developer can neither mint users nor list them: 401, as
    # the JAX package answers a role it refuses.
    assert same(servers, "POST", "/users", {"email": "o@x", "password": "pw",
                                            "user_type": "APP_DEVELOPER"}, app)[0] == 401
    assert same(servers, "GET", "/users", token=app)[0] == 401
    assert same(servers, "POST", "/models", {"name": "m", "task": TASK, "model_class": "M",
                                             "model_file": "x"}, app)[0] == 401
    assert same(servers, "POST", "/users", {"email": "app@x", "password": "pw",
                                            "user_type": "APP_DEVELOPER"}, tok)[0] == 400
    assert same(servers, "POST", "/users", {"email": "w@x", "password": "pw",
                                            "user_type": "WIZARD"}, tok)[0] == 400
    status, users = same(servers, "GET", "/users", token=tok)
    assert status == 200 and len(users["port"]) == 2
    assert same(servers, "DELETE", "/users", {"email": "app@x"}, tok)[0] == 200
    assert same(servers, "POST", "/tokens", {"email": "app@x", "password": "pw"})[0] == 401
    assert same(servers, "DELETE", "/users", {"email": "ghost@x"}, tok)[0] == 404


def test_missing_field_is_400_alike(servers):
    tok = login(servers, *SUPER)
    status, body = same(servers, "POST", "/users", {"email": "nopw@x"}, tok)
    assert status == 400 and all("password" in b["error"] for b in body.values())
    assert same(servers, "POST", "/train_jobs", {"app": "a"}, tok)[0] == 400
    assert same(servers, "POST", "/inference_jobs", {}, tok)[0] == 400
    assert same(servers, "POST", "/inference_jobs", {"app": "a", "gateway": 3}, tok)[0] == 400
    assert same(servers, "POST", "/train_jobs", {
        "app": "a", "task": TASK, "train_dataset_uri": TRAIN, "val_dataset_uri": VAL,
        "budget": {"COFFEE_COUNT": 1}}, tok)[0] == 400
    assert same(servers, "POST", "/models", {"name": "bad", "task": TASK,
                                             "model_class": "Nope",
                                             "model_file": "not python ]["}, tok)[0] == 400


def test_404s_and_405_alike(servers):
    tok = login(servers, *SUPER)
    for path in ("/models/ghost", "/models/ghost/file", "/train_jobs/ghost",
                 "/train_jobs/ghost/3", "/train_jobs/ghost/trials", "/trials/ghost",
                 "/trials/ghost/parameters", "/inference_jobs/ghost", "/nowhere",
                 "/advisors/ghost/propose"):
        assert same(servers, "GET", path, token=tok)[0] == 404, path
    for path in ("/train_jobs/ghost/stop", "/inference_jobs/ghost/2/stop"):
        assert same(servers, "POST", path, token=tok)[0] == 404, path
    assert same(servers, "POST", "/advisors/ghost/feedback",
                {"score": 0.5, "knobs": {}}, tok)[0] == 404
    assert same(servers, "GET", "/tokens")[0] == 405
    assert same(servers, "GET", "/train_jobs/ghost/stop", token=tok)[0] == 405


def _upload(servers, tok, name, sources, owner_tokens=None):
    for pkg in ("jax", "port"):
        status, body = call(servers.url[pkg], "POST", "/models", {
            "name": name, "task": TASK, "model_class": "TinyFF",
            "model_file": sources[pkg].decode()}, (owner_tokens or tok)[pkg])
        assert status == 201, body


def test_stop_scoped_to_owner_alike(servers, sources):
    tok = login(servers, *SUPER)
    for email, kind in (("dev1@x", "MODEL_DEVELOPER"), ("a1@x", "APP_DEVELOPER"),
                        ("a2@x", "APP_DEVELOPER")):
        assert same(servers, "POST", "/users", {"email": email, "password": "pw",
                                                "user_type": kind}, tok)[0] == 201
    dev, a1, a2 = (login(servers, e, "pw") for e in ("dev1@x", "a1@x", "a2@x"))
    _upload(servers, tok, "scopeff", sources, owner_tokens=dev)
    status, job = same(servers, "POST", "/train_jobs", {
        "app": "scopedapp", "task": TASK, "train_dataset_uri": TRAIN, "val_dataset_uri": VAL,
        "budget": {"MODEL_TRIAL_COUNT": 20, "CHIP_COUNT": 1}, "advisor_kind": "random"}, a1)
    assert status == 201 and job["port"]["status"] == "STARTED"
    assert same(servers, "POST", "/train_jobs/scopedapp/stop", token=a2)[0] == 404
    status, out = same(servers, "POST", "/train_jobs/scopedapp/stop", token=a1)
    assert status == 200
    for pkg in ("jax", "port"):
        assert wait_stopped(servers.url[pkg], "scopedapp", a1[pkg])["status"] in (
            "STOPPED", "COMPLETED")
    status, jobs = same(servers, "GET", "/train_jobs", token=a1)
    assert status == 200 and len(jobs["port"]) == 1
    assert same(servers, "GET", "/train_jobs", token=a2)[1]["port"] == []
    # Only the owner (or an admin) downloads a private template.
    assert same(servers, "GET", "/models/scopeff/file", token=dev)[0] == 200
    assert same(servers, "GET", "/models/scopeff/file", token=tok)[0] == 200


# -- the clients, both ways ------------------------------------------------------


def _client_round(client, error_cls, source, tmp_path):
    """One package's Client against the other package's server."""
    client.login(*SUPER)
    client.create_user("dev@x", "pw", "MODEL_DEVELOPER")
    assert [u["email"] for u in client.get_users()] == [SUPER[0], "dev@x"]
    client.logout()
    with pytest.raises(error_cls) as e:
        client.get_models()
    assert e.value.status == 401
    client.login("dev@x", "pw")
    path = tmp_path / "tinyff.py"
    path.write_bytes(source)
    m = client.create_model("tinyff", TASK, path, "TinyFF", dependencies={"numpy": "*"})
    assert m["name"] == "tinyff" and m["dependencies"] == {"numpy": "*"}
    assert client.download_model_file("tinyff") == source
    assert [x["name"] for x in client.get_models(task=TASK)] == ["tinyff"]
    assert client.get_models(task="POS_TAGGING") == []
    assert client.get_model("tinyff")["model_class"] == "TinyFF"
    with pytest.raises(error_cls) as e:
        client.get_train_job("ghost")
    assert e.value.status == 404
    client.login(*SUPER)
    assert client.ban_user("dev@x")["banned"] is True
    with pytest.raises(error_cls) as e:
        client.login("dev@x", "pw")
    assert e.value.status == 401 and "banned" in e.value.message


def test_each_client_drives_the_other_server(servers, sources, tmp_path):
    _client_round(Client(admin_port=servers.port["jax"], timeout_s=60), ClientError,
                  sources["jax"], tmp_path)
    _client_round(JaxClient(admin_port=servers.port["port"]), JaxClientError,
                  sources["port"], tmp_path)


def test_tokens_and_hashes_cross_packages(servers):
    secret = "s3cret"
    payload = {"user_id": "u1", "user_type": "ADMIN"}
    for make, read in ((auth.generate_token, jax_auth.decode_token),
                       (jax_auth.generate_token, auth.decode_token)):
        assert read(make(payload, secret, ttl_s=60), secret)["user_id"] == "u1"
        token = make(payload, secret, ttl_s=-1)
        with pytest.raises(Exception, match="expired"):
            read(token, secret)
        with pytest.raises(Exception, match="signature"):
            read(make(payload, "other"), secret)
    for make, check in ((auth.hash_password, jax_auth.verify_password),
                        (jax_auth.hash_password, auth.verify_password)):
        stored = make("pw")
        assert check("pw", stored) and not check("pw2", stored)
    # Under the same secret, a token minted by one server opens the other.
    tok = login(servers, *SUPER)
    assert call(servers.url["port"], "GET", "/models", token=tok["jax"])[0] == 200
    assert call(servers.url["jax"], "GET", "/models", token=tok["port"])[0] == 200
    # And a user row written by one package logs in through the other.
    port_store = servers.admin["port"].store
    port_store.create_user("x@x", jax_auth.hash_password("pw"), "APP_DEVELOPER")
    assert call(servers.url["port"], "POST", "/tokens",
                {"email": "x@x", "password": "pw"})[0] == 200


# -- the predictor app -----------------------------------------------------------


def _predictor_statuses(name):
    """``tests/test_gateway.py``'s request limits and malformed bodies,
    plus a shed (429) and a drain (503), over HTTP."""
    pkg = PACKAGES[name]
    out = []
    serving = Serving(pkg, [_SlowConst([0.5, 0.5])])
    slow = Serving(pkg, [_SlowConst([0.5, 0.5], 0.5)])
    empty = pkg.bus()
    servers = [PredictorServer(name, _gateway(pkg, pkg.predictor(serving.bus, "gwjob",
                                                                  timeout_s=2.0),
                                               max_queries_per_request=4)),
               PredictorServer(name, _gateway(pkg, pkg.predictor(slow.bus, "gwjob",
                                                                  timeout_s=5.0),
                                               max_inflight=1, max_queue=0)),
               PredictorServer(name, _gateway(pkg, pkg.predictor(empty, "gwjob",
                                                                  timeout_s=1.0)))]
    ok, shed, dead = (s.url for s in servers)
    try:
        for body in ({"queries": [[1.0]]}, {"queries": [[1.0]] * 5}, b"{[", [1, 2],
                     {"queries": "x"}, {"queries": [[1.0]], "deadline_s": "soon"},
                     {"queries": [[1.0]], "deadline_s": -1}, {"queries": []}):
            status, resp, _ = http("POST", ok + "/predict", body)
            out.append((status, sorted(resp)))
        out.append(http("GET", ok + "/nowhere")[:2])
        holder = threading.Thread(target=lambda: http("POST", shed + "/predict",
                                                      {"queries": [[1.0]]}))
        holder.start()
        wait_until_inflight = time.monotonic() + 10
        while http("GET", shed + "/gateway")[1]["inflight"] < 1:
            assert time.monotonic() < wait_until_inflight, "holder never admitted"
            time.sleep(0.01)
        status, resp, headers = http("POST", shed + "/predict", {"queries": [[1.0]]})
        out.append((status, resp["reason"], int(headers["Retry-After"]) >= 1))
        holder.join(timeout=30)
        status, resp, _ = http("POST", dead + "/predict", {"queries": [[1.0]]})
        out.append((status, sorted(resp)))
        out.append(http("POST", ok + "/drain")[:2])
        status, resp, headers = http("POST", ok + "/predict", {"queries": [[1.0]]})
        out.append((status, resp["reason"], "Retry-After" in headers))
        out.append(http("GET", ok + "/healthz")[:2])
        out.append(http("GET", ok + "/gateway")[1]["draining"])
    finally:
        for s in servers:
            s.close()
        serving.close()
        slow.close()
    return out


def test_predictor_app_statuses_alike():
    got = {name: _predictor_statuses(name) for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert [x[0] for x in got["port"][:9]] == [200, 413, 400, 400, 400, 400, 400, 200, 404]
    assert got["port"][9:] == [(429, "queue_full", True), (503, ["error"]),
                               (200, {"status": "draining", "flushed": True}),
                               (503, "draining", True), (503, {"status": "draining"}), True]


# -- the whole slice in both packages --------------------------------------------


def _journey(servers, name, source, tmp_path):
    """superadmin -> users -> upload -> 2-trial GP job -> inference job
    -> predictions over HTTP, through the package's own Client."""
    cls = {"jax": JaxClient, "port": Client}[name]
    kw = {} if name == "jax" else {"timeout_s": 60}
    root = cls(admin_port=servers.port[name], **kw)
    root.login(*SUPER)
    root.create_user("modeldev@x", "pw", "MODEL_DEVELOPER")
    root.create_user("appdev@x", "pw", "APP_DEVELOPER")
    dev = cls(admin_port=servers.port[name], **kw)
    dev.login("modeldev@x", "pw")
    path = tmp_path / f"{name}-tinyff.py"
    path.write_bytes(source)
    dev.create_model("tinyff", TASK, path, "TinyFF")
    app = cls(admin_port=servers.port[name], **kw)
    app.login("appdev@x", "pw")
    # CHIP_COUNT 1: one worker, so the GP proposes in order in both.
    job = app.create_train_job("restapp", TASK, TRAIN, VAL,
                               {"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1}, advisor_kind="gp")
    assert job["status"] == "STARTED"
    done = app.wait_until_train_job_has_stopped("restapp", timeout=300, poll_s=0.1)
    assert done["status"] == "COMPLETED"
    trials = app.get_trials_of_train_job("restapp")
    best = app.get_best_trials_of_train_job("restapp", max_count=2)
    logs = app.get_trial_logs(best[0]["id"])
    blobs = [app.get_trial_parameters(t["id"]) for t in best]
    inf = app.create_inference_job("restapp", max_models=2)
    queries = np.random.default_rng(3).uniform(0, 1, size=(10, 8, 8, 1)).tolist()
    direct = app.predict_via_predictor(inf["predictor_host"], queries)
    via_admin = app.predict("restapp", queries)
    app.stop_inference_job("restapp")
    with pytest.raises(Exception) as e:
        app.get_inference_job("restapp")
    assert e.value.status == 404
    return {"trials": trials, "best": best, "logs": logs, "blobs": blobs, "inf": inf,
            "direct": np.asarray(direct, np.float64), "via_admin": via_admin}


def test_whole_slice_in_both_packages(servers, sources, tmp_path):
    got = {name: _journey(servers, name, sources[name], tmp_path) for name in ("jax", "port")}
    port, jax = got["port"], got["jax"]
    assert [t["knobs"] for t in port["trials"]] == [t["knobs"] for t in jax["trials"]]
    assert all(t["status"] == "COMPLETED" for t in port["trials"] + jax["trials"])
    scores = [(a["score"], b["score"]) for a, b in zip(port["trials"], jax["trials"])]
    assert max(abs(a - b) for a, b in scores) <= F32_TOL["score"], scores
    assert [t["id"] for t in port["best"]] == [t["id"] for t in sorted(
        port["trials"], key=lambda t: -t["score"])][:2]
    assert any(e["type"] == "plot" for e in port["logs"])
    assert port["inf"]["status"] == "RUNNING" and port["inf"]["predictor_host"]
    assert sorted(port["inf"]) == sorted(jax["inf"])
    # Over HTTP, the port's ensemble agrees with the JAX package's ...
    assert port["direct"].shape == (10, 5)
    np.testing.assert_allclose(port["direct"].sum(-1), 1.0, atol=1e-6)
    print("HTTP probabilities, port vs JAX, max abs:",
          float(np.abs(port["direct"] - jax["direct"]).max()))
    np.testing.assert_allclose(port["direct"], jax["direct"], rtol=0, atol=HTTP_PROB_ATOL)
    np.testing.assert_array_equal(np.asarray(port["via_admin"]), port["direct"])
    # ... and equals the port's in-process stacked ensemble of the same
    # stored blobs, gathered as the predictor gathers one stacked reply.
    cls = load_model_class(sources["port"], "TinyFF")
    models = []
    for t, blob in zip(port["best"], port["blobs"]):
        m = cls(device="cpu", **t["knobs"])
        m.load_parameters(blob)
        models.append(m)
    stacked, reason = build_stacked(port["best"], models)
    assert reason == "stacked"
    queries = np.random.default_rng(3).uniform(0, 1, size=(10, 8, 8, 1)).tolist()
    want = [ensemble_predictions([p]) for p in stacked.predict(queries)]
    np.testing.assert_array_equal(port["direct"], np.asarray(want, np.float64))
    # The journey's services are gone: every worker row of the port's
    # inference job is STOPPED.
    store = servers.admin["port"].store
    inf_rows = store.get_services_of_job(port["inf"]["id"])
    assert sorted(r["service_type"] for r in inf_rows) == ["INFERENCE_WORKER", "PREDICTOR"]
    assert [r["status"] for r in inf_rows if r["service_type"] == "INFERENCE_WORKER"] == [
        "STOPPED"]


# -- devices and the command line ------------------------------------------------


def test_admin_entry_points_raise_without_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(data_dir=tmp_path / "d")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Admin(config=cfg)
    assert not cfg.data_dir.exists()  # refused before anything was written
    store, params = MetaStore(tmp_path / "m.sqlite3"), ParamsStore(tmp_path / "p")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServicesManager(store, params, config=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(port=0, admin=None)  # refused before the default data dir is touched
    manager = ServicesManager(store, params, config=cfg, device="cpu")
    assert manager.device == torch.device("cpu")
    # A bare predictor behind the app gets a default gateway.
    gw = Gateway(Predictor(None, "j"), GatewayConfig.from_config(cfg, max_batch=2))
    assert gw.stats()["limits"]["max_batch"] == 2 and gw.cfg.default_deadline_s == 10.0
    gw.close()
    with pytest.raises(ValueError, match="unknown gateway config keys"):
        GatewayConfig.from_config(cfg, bogus=1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_on_the_cpu_when_asked(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RAFIKI_TPU_DATA_DIR=str(tmp_path / "data"),
               CUDA_VISIBLE_DEVICES="")
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "rafiki_tpu_torch", "serve", "--host",
                             "127.0.0.1", "--port", str(port), "--device", "cpu"],
                            cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                if call(f"http://127.0.0.1:{port}", "GET", "/healthz", timeout_s=5)[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "the server never answered"
            time.sleep(0.1)
        client = Client(admin_port=port, timeout_s=30)
        assert client.login(*SUPER)["user_type"] == "SUPERADMIN"
        assert (tmp_path / "data" / "meta.sqlite3").exists()
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert f"listening on http://127.0.0.1:{port}" in out


def test_cli_asks_for_the_card_unless_cpu_is_asked(tmp_path, monkeypatch, capsys):
    from rafiki_tpu_torch.__main__ import main

    monkeypatch.setenv("RAFIKI_TPU_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve", "--port", str(_free_port())])
    assert not (tmp_path / "data").exists()
    assert main(["version"]) == 0 and capsys.readouterr().out.strip() == "0.1.0"
    assert main([]) == 1
