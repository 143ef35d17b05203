"""Session set-up shared by every test directory of the repository."""
import importlib.util
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    """Build the native I/O library (``native/deepatlas_io.cpp``) once, in
    the process that starts the run, before any pytest-xdist worker exists.

    ``tests/test_native.py`` calls the JAX binding's ``available()`` in a
    module-level ``skipif``, so every worker calls it while collecting, and
    that binding builds with an in-place ``make -C native``: concurrent
    workers write the same ``native/build/libdeepatlas_io.so``, and a worker
    can find it half-written or gone.  Built here first, the workers load
    the file and build nothing.  The port's binding is built too, into its
    own directory.  The JAX binding's module is loaded from its file, so
    that this process does not import the JAX package (whose ``data``
    package imports JAX).  A failed build raises nothing: the tests then
    fail or skip as they would, and the port's ``_native.build_error``
    keeps the compiler's output.
    """
    if hasattr(config, "workerinput"):
        return
    from deepatlas_torch.data import _native
    _native.available()
    spec = importlib.util.spec_from_file_location(
        "jax_native_build",
        os.path.join(ROOT, "deepatlas_tpu", "data", "_native.py"))
    jax_native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_native)
    jax_native.available()
