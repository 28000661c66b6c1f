"""The web admin UI in the port, against the JAX package's, on the CPU.

``GET /`` on the port's admin serves ``rafiki_tpu_torch/web/index.html``
with the status, content type and body of the JAX app's page, and the
same JSON answer when the page is absent. Then every ``api(VERB, path)``
call the page makes, parsed out of the page itself, is sent to both
packages' servers as the page would send it, one logged-in session after
another (users, a model upload, a one-trial train job, its trials, an
inference job): each reaches a port route that answers with the JAX
route's status and body keys.
"""

import pathlib
import re

import pytest
import torch

from rafiki_tpu.admin import app as jax_app_mod
from rafiki_tpu_torch.admin import app as app_mod
from tests.test_torch_rest import (SUPER, TASK, _shape, call, login, servers,  # noqa: F401
                                   wait_stopped)
from tests.test_torch_scheduler import TRAIN, VAL, sources  # noqa: F401 — fixture

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

PAGE = pathlib.Path(app_mod.__file__).resolve().parent.parent / "web" / "index.html"
# ``api("POST", "/tokens", ...)`` and ``api("GET", `/trials/${...}`)`` alike.
API_CALL = re.compile(r"""\bapi\("([A-Z]+)",\s*["`]([^"`]+)["`]""")


def _raw(url, path="/"):
    """(status, content type, body bytes) of one GET."""
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(urllib.request.Request(url + path), timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_the_page_is_served_as_the_jax_app_serves_it(servers, tmp_path, monkeypatch):
    got = {name: _raw(servers.url[name]) for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    status, ctype, body = got["port"]
    assert (status, ctype) == (200, "text/html; charset=utf-8")
    assert body == PAGE.read_bytes()
    assert body == (pathlib.Path(jax_app_mod.__file__).resolve().parent.parent / "web"
                    / "index.html").read_bytes()
    # Without the page both answer with the same JSON pointer.
    monkeypatch.setattr(app_mod, "_WEB_DIR", tmp_path)
    monkeypatch.setattr(jax_app_mod, "_WEB_DIR", tmp_path)
    got = {name: call(servers.url[name], "GET", "/") for name in ("jax", "port")}
    assert got["port"] == got["jax"] == (200, {"service": "rafiki-tpu admin",
                                               "docs": "/healthz"})


def test_every_call_of_the_page_reaches_a_port_route(servers, sources):
    calls = sorted(set(API_CALL.findall(PAGE.read_text())))
    app, tid = "${encodeURIComponent(app)}", "${encodeURIComponent(tid)}"
    assert calls == sorted([
        ("DELETE", "/users"), ("GET", "/models"), ("GET", "/train_jobs"),
        ("GET", "/users"), ("GET", f"/inference_jobs/{app}/${{v}}"),
        ("GET", f"/train_jobs/{app}/${{v}}"), ("GET", f"/train_jobs/{app}/${{v}}/trials"),
        ("GET", f"/trials/{tid}"), ("GET", f"/trials/{tid}/logs"),
        ("POST", "/inference_jobs"), ("POST", "/models"), ("POST", "/tokens"),
        ("POST", "/train_jobs"), ("POST", "/users"),
        ("POST", f"/inference_jobs/{app}/${{v}}/stop"),
        ("POST", f"/train_jobs/{app}/${{v}}/stop")])
    seen = set()

    def page(method, template, body=None, token=None, per_package=None, want=None):
        """One of the page's calls, in both packages; ``per_package``
        fills the path's trial id (or the body) per package."""
        seen.add((method, template))
        path = (template.replace(app, "webapp").replace("${v}", "1")
                .replace(tid, "{tid}"))
        out = {}
        for name in ("jax", "port"):
            p, b = path, body
            if per_package is not None:
                p, b = per_package(name, path, body)
            out[name] = call(servers.url[name], method, p, b, token and token[name])
        status = {name: s for name, (s, _) in out.items()}
        assert status["port"] == status["jax"], (method, template, out)
        if want is not None:
            assert status["port"] == want, (method, template, out)
        assert _shape(out["port"][1]) == _shape(out["jax"][1]), (method, template, out)
        return {name: b for name, (_, b) in out.items()}

    root = login(servers, *SUPER)
    seen.add(("POST", "/tokens"))
    for email, role in (("modeldev@web", "MODEL_DEVELOPER"), ("appdev@web", "APP_DEVELOPER")):
        page("POST", "/users", {"email": email, "password": "pw", "user_type": role}, root,
             want=201)
    page("GET", "/users", token=root, want=200)
    dev = login(servers, "modeldev@web", "pw")
    page("POST", "/models", {"name": "tinyff", "task": TASK, "model_class": "TinyFF",
                             "access_right": "PRIVATE"}, dev, want=201,
         per_package=lambda name, p, b: (p, dict(b, model_file=sources[name].decode())))
    page("GET", "/models", token=dev, want=200)
    user = login(servers, "appdev@web", "pw")
    assert page("GET", "/train_jobs", token=user, want=200) == {"jax": [], "port": []}
    page("POST", "/train_jobs", {"app": "webapp", "task": TASK, "train_dataset_uri": TRAIN,
                                 "val_dataset_uri": VAL, "budget": {"MODEL_TRIAL_COUNT": 1},
                                 "advisor_kind": "random"}, user, want=201)
    for name in ("jax", "port"):
        assert wait_stopped(servers.url[name], "webapp", user[name])["status"] == "COMPLETED"
    page("GET", f"/train_jobs/{app}/${{v}}", token=user, want=200)
    trials = page("GET", f"/train_jobs/{app}/${{v}}/trials", token=user, want=200)
    assert [len(t) for t in trials.values()] == [1, 1]

    def trial_of(name, p, b):
        return p.format(tid=trials[name][0]["id"]), b

    page("GET", f"/trials/{tid}", token=user, per_package=trial_of, want=200)
    page("GET", f"/trials/{tid}/logs", token=user, per_package=trial_of, want=200)
    page("POST", "/inference_jobs", {"app": "webapp", "app_version": 1}, user, want=201)
    page("GET", f"/inference_jobs/{app}/${{v}}", token=user, want=200)
    page("POST", f"/inference_jobs/{app}/${{v}}/stop", token=user, want=200)
    page("POST", f"/train_jobs/{app}/${{v}}/stop", token=user)
    page("DELETE", "/users", {"email": "appdev@web"}, root, want=200)
    assert seen == set(calls)


@pytest.mark.parametrize("path", ["/", "/index.html"])
def test_only_the_root_serves_the_page(servers, path):
    got = {name: call(servers.url[name], "GET", path)[0] for name in ("jax", "port")}
    assert got["port"] == got["jax"] == (200 if path == "/" else 404)
