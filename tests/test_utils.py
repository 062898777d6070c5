"""utils/debug tests: checkify wrapper, finite validation, smoke driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.utils import checked, no_jit, validate_finite


def test_checked_catches_nan():
    def bad(x):
        return jnp.log(x)  # NaN for negative input

    safe = checked(jax.jit(bad))
    # fine on valid input
    assert np.isfinite(float(safe(jnp.asarray(2.0))))
    with pytest.raises(Exception):
        safe(jnp.asarray(-1.0))


def test_validate_finite():
    validate_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError):
        validate_finite({"a": jnp.asarray([1.0, np.nan])}, "params")


def test_no_jit_context(rng):
    from big_linear_algebra.ops import matmul

    a = jnp.asarray(rng.standard_normal((4, 5)))
    b = jnp.asarray(rng.standard_normal((5, 6)))
    with no_jit():
        out = matmul(a, b)
    np.testing.assert_allclose(np.asarray(out), np.asarray(a) @ np.asarray(b),
                               rtol=1e-10)


def test_smoke_driver(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    from big_linear_algebra.models import smoke

    assert smoke.main([]) == 0
    out = capsys.readouterr().out
    assert "a @ b" in out
    assert "output after one step" in out
