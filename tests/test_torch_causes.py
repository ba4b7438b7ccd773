"""The port's root-cause engine (``obs/causes.py``) and its chaos ground
truth held to the JAX package's own tests (``tests/test_causes.py``),
run on the port through :mod:`torch_twin`: the campaign's attribution
gates run the port's ``chaos/`` campaign on its GPU fleet, and the HTTP
surfaces the port's operator, router and status binaries (``operator.py``,
``router.py``, ``status.py``) where the reference loads ``cmd/``.
"""

from torch_twin import reference_tests

globals().update(reference_tests(
    "test_causes.py",
    renames=[("from tests.test_router import _load_cmd  # noqa: F401  "
              "(cmd loader)",
              "def _load_cmd(name):\n"
              "    import importlib\n"
              "    return importlib.import_module("
              "f\"k8s_operator_libs_tpu_torch.{name}\")"),
             # the port's hub renders under the workload prefix unless
             # told (its first users were the serving metrics)
             ("hub.render()", 'hub.render(prefix="tpu_operator")')]))
