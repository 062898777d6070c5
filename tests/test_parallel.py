"""Distribution tests on the 8-virtual-device CPU mesh: mesh construction,
DP/TP shardings, sharded training steps, and the driver dryrun entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from big_linear_algebra.parallel import (
    batch_sharding,
    default_mesh,
    distributed_init,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_params_tp,
)


def test_virtual_device_count():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_make_mesh_shapes():
    mesh = make_mesh({"data": 4, "model": 2})
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        make_mesh({"data": 3})


def test_distributed_init_single_host_noop():
    # no coordinator configured → no-op, process 0 (SURVEY.md §5)
    assert distributed_init() == 0
    assert len(jax.devices()) == 8  # runtime untouched


def test_make_hybrid_mesh_single_slice_fallback():
    # all virtual CPU devices are in one process: host axes must be 1 and
    # the result is the flat (host..., local...) mesh
    mesh = make_hybrid_mesh({"dp_dcn": 1}, {"data": 4, "model": 2})
    assert mesh.axis_names == ("dp_dcn", "data", "model")
    assert mesh.devices.shape == (1, 4, 2)
    with pytest.raises(ValueError):
        make_hybrid_mesh({"dp_dcn": 2}, {"data": 4})


def test_dp_training_step_matches_single_device(rng):
    """The DP-sharded mnist_nn step must produce the same updated params as
    the unsharded step (XLA inserts the gradient psum)."""
    from big_linear_algebra.models import mnist_nn

    cfg = mnist_nn.Config(learn_rate=0.5)
    params = mnist_nn.init_params(jax.random.key(0), cfg)
    x = jnp.asarray(rng.random((64, 784)), jnp.float32)
    onehot = jnp.asarray(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, 64)])
    mask = jnp.ones((64,), jnp.float32)

    p_single, c_single, l_single = mnist_nn.train_step(
        jax.tree.map(jnp.copy, params), x, onehot, mask, cfg)

    mesh = default_mesh()
    bsh = batch_sharding(mesh)
    repl = replicate(mesh)
    p_sharded = jax.device_put(jax.tree.map(jnp.copy, params), repl)
    p_dp, c_dp, l_dp = mnist_nn.train_step(
        p_sharded,
        jax.device_put(x, bsh),
        jax.device_put(onehot, bsh),
        jax.device_put(mask, bsh),
        cfg,
    )
    assert float(c_dp) == float(c_single)
    np.testing.assert_allclose(float(l_dp), float(l_single), rtol=1e-5)
    for k in p_single:
        np.testing.assert_allclose(
            np.asarray(p_dp[k]), np.asarray(p_single[k]), rtol=1e-5,
            atol=1e-6, err_msg=k)


def test_tp_sharded_forward_matches(rng):
    from big_linear_algebra.models import mnist_nn

    params = mnist_nn.init_params(jax.random.key(1))
    x = jnp.asarray(rng.random((16, 784)), jnp.float32)
    want = np.asarray(mnist_nn.forward(params, x))

    mesh = make_mesh({"data": 4, "model": 2})
    tp = shard_params_tp(mesh, params)
    got = np.asarray(mnist_nn.forward(tp, jax.device_put(
        x, NamedSharding(mesh, P("data")))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_prefetch_with_sharding(rng):
    from big_linear_algebra.data import prefetch_to_device

    mesh = default_mesh()
    bsh = batch_sharding(mesh)
    batches = [rng.random((16, 8)).astype(np.float32) for _ in range(3)]
    out = list(prefetch_to_device(iter(batches), size=2, sharding=bsh))
    assert len(out) == 3
    assert out[0].sharding == bsh
    np.testing.assert_array_equal(np.asarray(out[1]), batches[1])


# ---------------------------------------------------------------------------
# shard_map SPMD steps (parallel/spmd.py): the Pallas GEMMs execute per shard
# (interpret mode on this CPU mesh) — no GSPMD partitioning rule needed.
# ---------------------------------------------------------------------------


def _mnist_batch(rng, n=64):
    x = jnp.asarray(rng.random((n, 784)), jnp.float32)
    onehot = jnp.asarray(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, n)])
    mask = jnp.ones((n,), jnp.float32)
    return x, onehot, mask


def test_spmd_dp_step_matches_single_device(rng):
    """make_train_step_dp (shard_map, explicit psum, per-shard Pallas GEMMs)
    must reproduce the unsharded step exactly (sum-based loss)."""
    from big_linear_algebra.models import mnist_nn

    cfg = mnist_nn.Config(learn_rate=0.5)
    params = mnist_nn.init_params(jax.random.key(0), cfg)
    x, onehot, mask = _mnist_batch(rng)

    p_single, c_single, l_single = mnist_nn.train_step(
        jax.tree.map(jnp.copy, params), x, onehot, mask, cfg)

    step = mnist_nn.make_train_step_dp(default_mesh(), cfg)
    p_dp, c_dp, l_dp = step(jax.tree.map(jnp.copy, params), x, onehot, mask)
    assert float(c_dp) == float(c_single)
    np.testing.assert_allclose(float(l_dp), float(l_single), rtol=1e-5)
    for k in p_single:
        np.testing.assert_allclose(
            np.asarray(p_dp[k]), np.asarray(p_single[k]), rtol=1e-5,
            atol=1e-6, err_msg=k)


def test_spmd_dp_tp_step_matches_single_device(rng):
    """DP×TP: batch over 'data', dense output dims over 'model'; the
    all_gather/reduce_scatter pair must leave the update exactly the
    full-model SGD step."""
    from big_linear_algebra.models import mnist_nn

    cfg = mnist_nn.Config(learn_rate=0.5)
    params = mnist_nn.init_params(jax.random.key(0), cfg)
    x, onehot, mask = _mnist_batch(rng)

    p_single, c_single, l_single = mnist_nn.train_step(
        jax.tree.map(jnp.copy, params), x, onehot, mask, cfg)

    mesh = make_mesh({"data": 4, "model": 2})
    step = mnist_nn.make_train_step_dp_tp(mesh, cfg)
    p_tp = mnist_nn.place_params_tp(mesh, jax.tree.map(jnp.copy, params))
    p_tp, c_tp, l_tp = step(p_tp, x, onehot, mask)
    assert float(c_tp) == float(c_single)
    np.testing.assert_allclose(float(l_tp), float(l_single), rtol=1e-5)
    for k in p_single:
        np.testing.assert_allclose(
            np.asarray(p_tp[k]), np.asarray(p_single[k]), rtol=1e-5,
            atol=1e-6, err_msg=k)


def test_spmd_epoch_resident_dp_matches(rng):
    """The DP resident-epoch scan must match the single-device epoch scan."""
    from big_linear_algebra.models import mnist_nn

    cfg = mnist_nn.Config(learn_rate=0.1)
    params = mnist_nn.init_params(jax.random.key(2), cfg)
    n = 200  # ragged: 200 = 3*64 + 8 → last batch masked
    x_dev = jnp.asarray(rng.random((n, 784)) * 255.0, jnp.float32)
    y_dev = jnp.asarray(rng.integers(0, 10, n), jnp.float32)
    padded = -(-n // cfg.batch_size) * cfg.batch_size
    perm = np.full(padded, -1, np.int32)
    perm[:n] = rng.permutation(n).astype(np.int32)
    perm = jnp.asarray(perm)

    p1, c1, l1 = mnist_nn.epoch_step_resident(
        jax.tree.map(jnp.copy, params), x_dev, y_dev, perm, cfg)
    epoch_dp = mnist_nn.make_epoch_resident_dp(default_mesh(), cfg)
    p2, c2, l2 = epoch_dp(jax.tree.map(jnp.copy, params), x_dev, y_dev, perm)
    assert float(c1) == float(c2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p2[k]), np.asarray(p1[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_spmd_hinge_chunk_matches(rng):
    from big_linear_algebra.models import mnist_hinge

    n = 160
    w0 = jnp.asarray(rng.normal(0, 0.05, (784, 10)), jnp.float32)
    x = jnp.asarray(rng.random((n, 784)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 10, n), jnp.int32)

    w1, norms1 = mnist_hinge._train_chunk(jnp.copy(w0), x, labels, 0.01, 5)
    chunk_dp = mnist_hinge.make_train_chunk_dp(default_mesh(), n, 5)
    w2, norms2 = chunk_dp(jnp.copy(w0), x, labels, 0.01)
    np.testing.assert_allclose(np.asarray(norms2), np.asarray(norms1),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w1), rtol=1e-5,
                               atol=1e-6)


def test_spmd_unet_dp_step(rng):
    """U-Net DP train step over the mesh: finite loss, params move, and the
    update stays replicated across shards (pmean'd grads)."""
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init

    cfg = cu.TINY
    params = cu.init_params(jax.random.key(0), cfg)
    opt = adam_init(params)
    x0 = jnp.asarray(rng.standard_normal((16, 3, 32, 32)), jnp.float32)
    step = cu.make_train_step_dp(default_mesh(), cfg)
    p2, opt2, loss = step(params, opt, x0, jax.random.key(1))
    assert np.isfinite(float(loss))
    moved = jax.tree.map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))),
        cu.init_params(jax.random.key(0), cfg), p2)
    assert max(jax.tree.leaves(moved)) > 0.0


def test_unet_tp_grads_match_single_device(rng):
    """U-Net conv-GEMM tensor parallelism (SURVEY §2.4 TP row): grads of
    the DDPM loss with channel-sharded conv kernels match the unsharded
    computation — GSPMD inserts the activation collectives, math unchanged.

    Run in f64 so reduction-order noise cannot mask a partitioning bug:
    in f32 the reference-style GN (divides by raw variance, §7.5) amplifies
    the different reduction order to ~1e-2 on some grads; in f64 TP matches
    unsharded to ~1e-10."""
    import dataclasses

    from big_linear_algebra.models import cifar_unet as cu

    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"model": 2}, devices=jax.devices()[:2])
    params = jax.tree.map(lambda p: p.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    x0 = jnp.asarray(rng.standard_normal((4, 3, 32, 32)), jnp.float64)

    # at least one conv kernel actually sharded
    specs = cu.tp_param_specs(params, 2)
    assert any(s != P() for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P)))

    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: cu.loss_fn(p, x0, jax.random.key(3), cfg)))
    l_ref, g_ref = grad_fn(params)
    l_tp, g_tp = grad_fn(cu.place_tp(mesh, params))
    np.testing.assert_allclose(float(l_tp), float(l_ref), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g_tp), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-9)


def test_unet_dp_tp_step_matches_single_device(rng):
    """Combined DP×TP on a 2-D data×model mesh (VERDICT r2 missing #3; the
    combination place_tp's note promises): batch sharded over "data", conv
    kernels channel-sharded over "model", the regular jitted train_step runs
    both via GSPMD. Unlike the shard_map DP path the RNG draw stays global,
    so the whole step — params, opt moments, loss — must match the
    single-device step exactly (f64, ~1e-10)."""
    import dataclasses

    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init

    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"data": 4, "model": 2})
    params = jax.tree.map(lambda p: p.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    opt = adam_init(params)
    x0 = jnp.asarray(rng.standard_normal((8, 3, 32, 32)), jnp.float64)
    key = jax.random.key(5)

    def step(p, o, x, k):
        loss, grads = jax.value_and_grad(cu.loss_fn)(p, x, k, cfg)
        p, o = cu.adam_update(p, grads, o, cfg.learn_rate)
        return p, o, loss

    jstep = jax.jit(step)
    p_ref, o_ref, l_ref = jstep(params, opt, x0, key)

    p_tp, o_tp = cu.place_dp_tp(mesh, params, opt)
    x_sh = jax.device_put(x0, cu.dp_tp_batch_sharding(mesh))
    p_got, o_got, l_got = jstep(p_tp, o_tp, x_sh, key)

    np.testing.assert_allclose(float(l_got), float(l_ref), rtol=1e-10)
    flat_got = jax.tree_util.tree_leaves_with_path(p_got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(p_ref))
    for path, leaf in flat_got:
        np.testing.assert_allclose(
            np.asarray(leaf), np.asarray(flat_ref[path]),
            rtol=1e-7, atol=1e-10,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")
    for a, b in zip(jax.tree.leaves(o_got.m), jax.tree.leaves(o_ref.m)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-10)
    # the updated params keep their DP×TP sharding (no silent gather)
    sharded = [
        leaf for leaf in jax.tree.leaves(p_got)
        if not leaf.sharding.is_fully_replicated
    ]
    assert sharded, "no updated param leaf stayed model-sharded"


def test_dryrun_multichip(monkeypatch):
    import importlib.util
    from pathlib import Path

    # Persistent-cache WRITES off for the in-process dryrun (reads still
    # hit): serializing the 8-device executable inside a process that has
    # already run the full suite segfaults jaxlib 0.9's
    # LoadedExecutable.serialize (reproduced 2/2 full-suite runs, round 5;
    # the same dryrun passes solo and in the fresh-subprocess
    # test_driver_env runs, which keep writes on).
    monkeypatch.setenv("BLA_DRYRUN_CACHE_WRITES", "0")
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        mod.dryrun_multichip(8)
    finally:
        # dryrun_multichip set min_compile_time to 1e9 under the knob —
        # restore the conftest value so later tests keep caching
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", prev_min)


def test_entry_compiles():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "graft_entry2", Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    # lowering (trace + shape check) is enough on the CPU; the card runs
    # the reference-scale U-Net end to end in chip_smoke.py
    jax.jit(fn).lower(*args)
