"""The port's log-level convention (``consts.py``) held to the JAX
package's own tests (``tests/test_consts.py``), run on the port through
:mod:`torch_twin`."""

from torch_twin import reference_tests

globals().update(reference_tests("test_consts.py"))
