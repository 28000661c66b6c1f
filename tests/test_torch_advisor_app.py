"""The port's advisor over HTTP against the JAX package's, on the CPU.

Both packages' ``AdvisorApp`` serve an ``AdvisorService`` with the same
knob space and seed on loopback (the JAX package's on werkzeug, the
port's on ``utils/httpd.py``), behind the same shared secret. The same
requests go to both: ``propose``, ``propose_batch`` and ``feedback``
through a GP past its random warm-up, and the error paths (no secret,
a wrong secret, an unknown advisor or route, a wrong method, a bad
``n``, a body that is not JSON). Status codes and JSON bodies must be
equal. Then each package's ``HttpAdvisorHandle`` drives the other's
server.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch
from werkzeug.serving import make_server

import rafiki_tpu.model.knobs as jax_knobs
import rafiki_tpu_torch.model.knobs as port_knobs
from rafiki_tpu.advisor import AdvisorService as JaxAdvisorService
from rafiki_tpu.advisor.app import AdvisorApp as JaxAdvisorApp, HttpAdvisorHandle as JaxHandle
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.advisor.app import AdvisorApp, HttpAdvisorHandle
from rafiki_tpu_torch.utils.httpd import start_server
from tests.test_torch_advisor import score, small_space

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

SECRET = "s3cret"
HEADER = "X-Rafiki-Advisor-Secret"
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture()
def servers():
    """Both apps on loopback, one advisor each (GP, seed 0, the same
    space and id). Yields ``{"jax": url, "port": url}`` and the id."""
    jax_svc, port_svc = JaxAdvisorService(), AdvisorService()
    aid = jax_svc.create_advisor(small_space(jax_knobs), kind="gp", seed=0, advisor_id="adv")
    port_svc.create_advisor(small_space(port_knobs), kind="gp", seed=0, advisor_id=aid)
    wz = make_server("127.0.0.1", 0, JaxAdvisorApp(jax_svc, secret=SECRET), threaded=True)
    th = threading.Thread(target=wz.serve_forever, daemon=True)
    th.start()
    port_server, port_thread = start_server(AdvisorApp(port_svc, secret=SECRET))
    yield {"jax": f"http://127.0.0.1:{wz.server_port}",
           "port": f"http://127.0.0.1:{port_server.server_port}"}, aid
    wz.shutdown()
    port_server.shutdown()
    port_server.server_close()
    th.join(timeout=5)
    port_thread.join(timeout=5)


def call(base, method, path, body=None, secret=SECRET, raw=None):
    """(status, parsed JSON body) of one request."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    headers = {"Content-Type": "application/json"} if data is not None else {}
    if secret is not None:
        headers[HEADER] = secret
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    try:
        with OPENER.open(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        out = e.code, json.loads(e.read())
        e.close()
        return out


def both(urls, *args, **kwargs):
    got, want = call(urls["port"], *args, **kwargs), call(urls["jax"], *args, **kwargs)
    assert got == want, (args, kwargs)
    return got


def test_the_same_requests_get_the_same_answers(servers):
    urls, aid = servers
    assert both(urls, "GET", "/healthz", secret=None) == (200, {"status": "ok"})
    # A GP past its 8 random proposals: propose, tell, and q-batches.
    for _ in range(10):
        status, body = both(urls, "GET", f"/advisors/{aid}/propose")
        assert status == 200 and set(body["knobs"]) == {"units", "layers", "lr"}
        assert both(urls, "POST", f"/advisors/{aid}/feedback",
                    {"score": score(body["knobs"]), "knobs": body["knobs"]}) == (200, {"ok": True})
    status, body = both(urls, "POST", f"/advisors/{aid}/propose_batch", {"n": 3})
    assert status == 200 and len(body["knobs_list"]) == 3
    # The error paths.
    for secret in (None, "wrong"):
        assert both(urls, "GET", f"/advisors/{aid}/propose", secret=secret) == \
            (401, {"error": "Bad advisor secret"})
        assert both(urls, "POST", f"/advisors/{aid}/feedback", {"score": 1.0, "knobs": {}},
                    secret=secret)[0] == 401
    assert both(urls, "GET", "/advisors/nope/propose")[0] == 404
    assert both(urls, "POST", "/advisors/nope/propose_batch", {"n": 2})[0] == 404
    assert both(urls, "POST", "/advisors/nope/feedback", {"score": 1.0, "knobs": {}})[0] == 404
    for body in ({"n": 0}, {"n": "x"}, {}):
        assert both(urls, "POST", f"/advisors/{aid}/propose_batch", body)[0] == 400
    assert both(urls, "POST", f"/advisors/{aid}/propose_batch", raw=b"not json")[0] == 400
    assert both(urls, "POST", f"/advisors/{aid}/feedback", {"knobs": {}})[0] == 404
    assert both(urls, "GET", "/nowhere")[0] == 404
    assert both(urls, "POST", f"/advisors/{aid}/propose")[0] == 405
    assert both(urls, "GET", f"/advisors/{aid}/feedback")[0] == 405


def test_each_handle_drives_the_other_packages_server(servers):
    """The port's handle against the JAX package's server and the JAX
    package's against the port's: the same proposals as each would get
    from its own package, in step."""
    urls, aid = servers
    port_on_jax = HttpAdvisorHandle(urls["jax"], aid, secret=SECRET)
    jax_on_port = JaxHandle(urls["port"], aid, secret=SECRET)
    for _ in range(9):
        a, b = port_on_jax.propose(), jax_on_port.propose()
        assert a == b
        port_on_jax.feedback(score(a), a)
        jax_on_port.feedback(score(b), b)
    assert port_on_jax.propose_batch(2) == jax_on_port.propose_batch(2)
    with pytest.raises(RuntimeError, match="advisor HTTP 400"):
        port_on_jax.propose_batch(0)
    with pytest.raises(RuntimeError, match="advisor HTTP 401"):
        HttpAdvisorHandle(urls["jax"], aid, secret="wrong").propose()


def test_the_handle_gives_up_on_an_unreachable_server():
    handle = HttpAdvisorHandle("http://127.0.0.1:1", "adv", retries=2, retry_delay_s=0.01)
    with pytest.raises(RuntimeError, match="advisor unreachable"):
        handle.propose()
