"""Load the reference's shipped *trained* weights (SURVEY.md §2.3) through
our CSV layouts and check behavioral parity."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tests import oracle

pytestmark = pytest.mark.skipif(
    not oracle.reference_available(), reason="no reference"
)

REF_DATA = "/root/reference/data"


@pytest.fixture
def ref_data_dir():
    os.environ["BLA_DATA_DIR"] = REF_DATA
    yield REF_DATA
    del os.environ["BLA_DATA_DIR"]


def test_my_first_model_shipped_weights_forward_parity(ref_data_dir):
    """Our Layer-graph forward on the shipped trained 2→3→2 weights must
    match the C matrix pipeline (matmul → bias add → relu per layer,
    lib/layer.c:6-20) exactly.

    Note the shipped weights are themselves degenerate — the output layer is
    strongly negative so both relu outputs are 0 for any input and the
    reference's ``run`` always prints "Different signs!" (its Layer path was
    float-era and is float/double-broken as committed, SURVEY.md §7.13) —
    parity here means reproducing that exact behavior."""
    from big_linear_algebra.models import my_first_model as mfm
    from big_linear_algebra.nn import layer_graph

    params = mfm.load_params()
    assert params[0][0].shape == (3, 2) and params[1][0].shape == (2, 3)

    for pair in [(0.7, 0.8), (-0.7, -0.8), (-0.3, 0.9), (0.5, -0.1)]:
        ours = np.asarray(
            layer_graph.predict(params, mfm.ACTS,
                                jnp.asarray(pair, jnp.float32)))
        # C pipeline: relu(W2 @ relu(W1 @ x + b1) + b2)
        a = np.asarray(pair, np.float64).reshape(2, 1)
        for (w, b) in params:
            z = oracle.c_matmul(np.asarray(w, np.float64), a)
            z = oracle.c_add(z, np.asarray(b, np.float64).reshape(-1, 1))
            a = oracle.c_relu(z)
        np.testing.assert_allclose(ours, a[:, 0], atol=1e-5)


def test_mnist_nn_shipped_weights_load_and_roundtrip(tmp_path):
    from pathlib import Path

    from big_linear_algebra.models import mnist_nn

    params = mnist_nn.load_params_csv(base=Path(REF_DATA) / "mnist_nn")
    for i, (o, i_) in enumerate([(256, 784), (128, 256), (10, 128)], 1):
        assert params[f"w{i}"].shape == (i_, o)
        assert np.isfinite(np.asarray(params[f"w{i}"])).all()
    # round-trip through our writer and back: values preserved to CSV %f
    mnist_nn.save_params_csv(params, base=tmp_path)
    back = mnist_nn.load_params_csv(base=tmp_path)
    for k in params:
        np.testing.assert_allclose(np.asarray(back[k]),
                                   np.asarray(params[k]), atol=5e-7)


def test_mnist_hinge_shipped_weights_load():
    import importlib

    from big_linear_algebra.models import mnist_hinge

    os.environ["BLA_DATA_DIR"] = REF_DATA
    try:
        w = mnist_hinge.load_weights()
    finally:
        del os.environ["BLA_DATA_DIR"]
    assert w.shape == (784, 10)
    arr = np.asarray(w)
    assert np.isfinite(arr).all()
    # trained weights are not all identical across ensemble members
    assert np.abs(arr[:, 0] - arr[:, 1]).max() > 1e-4
