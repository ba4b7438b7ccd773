"""The port's serving-side workload telemetry and ``status.py --goodput``
held to the JAX package's own tests (``tests/test_workload_obs.py``),
run on the port through :mod:`torch_twin`: the instrumented
``ContinuousBatcher`` (TTFT, queue wait, inter-token, occupancy, drain
and handoff gauges) on the port's seeded tiny Llama on the CPU, the
serving runtime's ``/metrics`` (the port's ``server.py`` where the
reference loads ``cmd/serve.py``), and the status CLI's goodput view
and watch dashboard (the port's ``status.py``).
"""

import pytest

from torch_twin import reference_tests

globals().update(reference_tests(
    "test_workload_obs.py",
    renames=[
        ("import jax\nimport jax.numpy as jnp\n", "import torch\n"),
        ("LlamaConfig.tiny(dtype=jnp.float32)",
         "LlamaConfig.tiny(dtype=torch.float32)"),
        ("init_params(jax.random.PRNGKey(0), CFG)",
         'init_params(CFG, seed=0, device="cpu")'),
        ('''    path = os.path.join(os.path.dirname(__file__), "..", "cmd", "serve.py")
    spec = importlib.util.spec_from_file_location("tpu_serve_obs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod''', '''    import importlib
    return importlib.import_module("k8s_operator_libs_tpu_torch.server")'''),
        ('ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(rt))',
         'mod.make_server(rt, "127.0.0.1", 0)'),
        ('''    path = os.path.join(os.path.dirname(__file__), "..", "cmd", "status.py")
    spec = importlib.util.spec_from_file_location("tpu_status_obs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod''', '''    import importlib
    return importlib.import_module("k8s_operator_libs_tpu_torch.status")''')]))


@pytest.fixture(autouse=True)
def _torch_threads():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
