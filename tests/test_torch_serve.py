"""The port's continuous batcher and HTTP server against the JAX reference
on the CPU: the same requests on the same weights give the same tokens,
a request migrates between the two packages mid-decode, and the server
answers like a solo decode."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import paged as jpaged
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu.models.serve import ContinuousBatcher as JBatcher
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import generate as tgen
from k8s_operator_libs_tpu_torch.models import paged as tpaged
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
from k8s_operator_libs_tpu_torch.server import ServingRuntime, make_server
from k8s_operator_libs_tpu_torch.utils.clock import FakeClock

JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = TConfig.tiny(dtype=torch.float32)
PREFIX = np.arange(100, 113, dtype=np.int32)   # 1 whole block of 8 + 5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once: keep torch's CPU
    thread pool small so these tests do not crowd out timing-sensitive
    tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    tree = jax.device_get(init_params(jax.random.PRNGKey(0), JCFG))
    return tree, convert.to_torch(tree, device="cpu")


def _requests(n=5, seed=11):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 20, size=n)
    news = rng.integers(2, 9, size=n)
    return [(rng.integers(0, JCFG.vocab_size, size=int(t)).astype(np.int32),
             int(m)) for t, m in zip(lens, news)]


def _drive(srv, reqs, chunk):
    """Submit two requests, then one more per step: the 2-slot server
    must interleave, retire and recycle."""
    pending = list(reqs)
    rids, out = [], {}
    for _ in range(2):
        p, m = pending.pop(0)
        rids.append(srv.submit(p, m))
    steps = 0
    while not srv.idle or pending:
        srv.step(chunk)
        out.update(srv.poll())
        if pending:
            p, m = pending.pop(0)
            rids.append(srv.submit(p, m))
        steps += 1
        assert steps < 200, "server did not converge"
    out.update(srv.poll())
    return [out[r] for r in rids]


def test_batcher_token_identical_to_reference(weights):
    tree, params = weights
    reqs = _requests()
    kw = dict(max_slots=2, capacity_per_slot=40, block_size=8,
              shared_prefix=PREFIX)
    ref = _drive(JBatcher(tree, JCFG, **kw), reqs, 3)
    hub = MetricsHub()
    srv = ContinuousBatcher(params, TCFG, metrics=hub, clock=FakeClock(),
                            **kw)
    got = _drive(srv, reqs, 3)
    for (p, m), r, g in zip(reqs, ref, got):
        assert len(g) == len(p) + m
        np.testing.assert_array_equal(g, r)
    assert srv.decode_steps > 0
    assert hub.get_histogram("serve_ttft_seconds").count() == len(reqs)
    assert hub.gauge("serve_requests_completed") == len(reqs)


def test_batcher_matches_solo_decodes_without_prefix(weights):
    _, params = weights
    reqs = _requests(4, seed=12)
    srv = ContinuousBatcher(params, TCFG, max_slots=2, capacity_per_slot=32,
                            block_size=8)
    got = _drive(srv, reqs, 1)
    for (p, m), g in zip(reqs, got):
        solo = tgen.generate(params, torch.as_tensor(p[None]), TCFG,
                             max_new_tokens=m)[0].numpy()
        np.testing.assert_array_equal(g, solo)


def _run_to_end(srv, rid):
    out = {}
    while rid not in out:
        srv.step()
        out.update(srv.poll())
    return out[rid]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_migration_across_packages_finishes_identically(weights, direction):
    tree, params = weights
    prompt, max_new = _requests(1, seed=13)[0][0], 9
    kw = dict(max_slots=2, capacity_per_slot=40, block_size=8,
              shared_prefix=PREFIX)
    jsrv = JBatcher(tree, JCFG, **kw)
    tsrv = ContinuousBatcher(params, TCFG, **kw)
    donor, peer = (jsrv, tsrv) if direction == "jax_to_torch" else (tsrv,
                                                                    jsrv)
    encode = (jpaged.encode_kv_payload if donor is jsrv
              else tpaged.encode_kv_payload)
    decode = (tpaged.decode_kv_payload if peer is tsrv
              else jpaged.decode_kv_payload)
    # reference result: the peer's package decoding the prompt unmoved
    solo_rid = peer.submit(prompt, max_new)
    expected = _run_to_end(peer, solo_rid)

    rid = donor.submit(prompt, max_new)
    donor.step()
    donor.step()
    payload = donor.export_slot(rid)
    assert len(payload["generated"]) == 2
    payload["kv"] = encode(payload["kv"])
    wire = json.loads(json.dumps(payload))
    wire["kv"] = decode(wire["kv"])
    new_rid = peer.adopt_slot(wire)
    np.testing.assert_array_equal(_run_to_end(peer, new_rid), expected)


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST" if data
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_http_server_serves_drains_and_exposes_metrics(weights):
    _, params = weights
    rt = ServingRuntime(params, TCFG, max_slots=2, capacity=48, block_size=8,
                        chunk=4)
    httpd = make_server(rt, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _http(base + "/healthz")[0] == 200
        prompts = [p for p, _ in _requests(3, seed=14)]
        results = [None] * len(prompts)

        def call(i):
            results[i] = _http(base + "/generate",
                               {"tokens": prompts[i].tolist(), "max_new": 6})

        callers = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for c in callers:
            c.start()
        for c in callers:
            c.join()
        for p, (code, body) in zip(prompts, results):
            assert code == 200, body
            solo = tgen.generate(params, torch.as_tensor(p[None]), TCFG,
                                 max_new_tokens=6)[0].tolist()
            assert json.loads(body)["tokens"] == solo
        code, body = _http(base + "/generate", {"tokens": [1] * 45,
                                                "max_new": 6})
        assert code == 422
        assert _http(base + "/generate", {"max_new": 2})[0] == 400
        code, metrics = _http(base + "/metrics")
        assert code == 200
        for family in ("tpu_workload_serve_ttft_seconds_count 3",
                       "tpu_workload_serve_requests_completed 3",
                       "tpu_workload_serve_inter_token_seconds_bucket",
                       "tpu_workload_weight_stream_gbs",
                       'tpu_workload_serve_up{component="serve"} 1.0'):
            assert family in metrics, family
        code, body = _http(base + "/drain", {})
        assert code == 200 and json.loads(body) == {"handoff": []}
        assert _http(base + "/healthz")[0] == 503
        assert _http(base + "/generate", {"tokens": [1, 2],
                                          "max_new": 2})[0] == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        rt.stop()
        thread.join(timeout=10)


def test_stopped_server_frees_its_weights_without_a_collection(weights):
    """Once the server is shut down and the runtime stopped, dropping the
    last references frees the batcher and its weights at once: nothing
    of the server holds them in a reference cycle that waits for the
    garbage collector."""
    import gc
    import weakref

    _, shared = weights
    params = {k: (v.clone() if torch.is_tensor(v) else
                  {n: t.clone() for n, t in v.items()})
              for k, v in shared.items()}
    alive = weakref.ref(params["embed"])
    gc.disable()
    try:
        rt = ServingRuntime(params, TCFG, max_slots=2, capacity=48,
                            block_size=8, chunk=4)
        httpd = make_server(rt, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        code, _ = _http(base + "/generate", {"tokens": [1, 2, 3],
                                             "max_new": 2})
        assert code == 200
        httpd.shutdown()
        httpd.server_close()
        rt.stop()
        thread.join(timeout=10)
        del rt, httpd, thread, params
        assert alive() is None
    finally:
        gc.enable()
