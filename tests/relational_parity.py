"""Shared helpers of the relational parity suites
(``tests/test_torch_{relational,exprc,groupby}.py``): the port's sessions
on the CPU, and byte comparisons of ``collect()`` results.

The reference's ``jax`` expression backend needs
``jax.experimental.enable_x64``, which JAX 0.9.0 does not have, so the port
is held against the reference's ``numpy`` (and ``interp``) backends."""
import numpy as np

PORT_BACKENDS = ("interp", "numpy", "torch")


def port_session(expr_backend="numpy", **kw):
    """A session of the port; its torch backend on the CPU, where the
    kernels' plain versions run."""
    from repro_torch.core import Session
    if expr_backend == "torch":
        kw.setdefault("device", "cpu")
    return Session(expr_backend=expr_backend, **kw)


def assert_bytes_equal(results):
    """Every result has the first's columns, dtypes, shapes and bytes."""
    ref = results[0]
    for other in results[1:]:
        assert set(ref) == set(other)
        for col in ref:
            x, y = np.asarray(ref[col]), np.asarray(other[col])
            assert x.dtype == y.dtype, col
            assert x.shape == y.shape, col
            assert x.tobytes() == y.tobytes(), col
