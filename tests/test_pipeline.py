"""GPipe stage-splitter parity vs sequential execution on the virtual mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.parallel import make_mesh
from big_linear_algebra.parallel.pipeline import gpipe


def _stage_fn(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _sequential(stacked, xs):
    out = xs
    n_stages = stacked[0].shape[0]
    for s in range(n_stages):
        out = jax.vmap(lambda m: _stage_fn((stacked[0][s], stacked[1][s]), m))(out)
    return out


def test_gpipe_matches_sequential(rng):
    mesh = make_mesh({"stage": 4, "data": 2})
    S, D, B, M = 4, 16, 8, 6  # stages, width, microbatch size, n_micro
    ws = jnp.asarray(rng.standard_normal((S, D, D)) * 0.3, jnp.float32)
    bs = jnp.asarray(rng.standard_normal((S, D)) * 0.1, jnp.float32)
    xs = jnp.asarray(rng.standard_normal((M, B, D)), jnp.float32)

    got = np.asarray(gpipe(_stage_fn, (ws, bs), xs, mesh))
    want = np.asarray(_sequential((ws, bs), xs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gpipe_gradients_flow(rng):
    mesh = make_mesh({"stage": 8})
    S, D, B, M = 8, 8, 4, 3
    ws = jnp.asarray(rng.standard_normal((S, D, D)) * 0.3, jnp.float32)
    bs = jnp.zeros((S, D), jnp.float32)
    xs = jnp.asarray(rng.standard_normal((M, B, D)), jnp.float32)

    def loss_pipe(ws, bs):
        return jnp.sum(gpipe(_stage_fn, (ws, bs), xs, mesh) ** 2)

    def loss_seq(ws, bs):
        return jnp.sum(_sequential((ws, bs), xs) ** 2)

    gw_p, gb_p = jax.grad(loss_pipe, argnums=(0, 1))(ws, bs)
    gw_s, gb_s = jax.grad(loss_seq, argnums=(0, 1))(ws, bs)
    np.testing.assert_allclose(np.asarray(gw_p), np.asarray(gw_s), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(gb_p), np.asarray(gb_s), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Heterogeneous stages (gpipe_hetero)
# ---------------------------------------------------------------------------


def _hetero_fns_params(rng):
    """Three stages with genuinely different activation and param shapes:
    (B,6) -> (B,10) -> dict{a:(B,4), s:(B,)} -> (B,3)."""
    w1 = jnp.asarray(rng.standard_normal((6, 10)) * 0.4, jnp.float32)
    p2 = {"w": jnp.asarray(rng.standard_normal((10, 4)) * 0.4, jnp.float32),
          "b": jnp.asarray(rng.standard_normal((4,)) * 0.1, jnp.float32)}
    w3 = jnp.asarray(rng.standard_normal((5, 3)) * 0.4, jnp.float32)

    def f1(p, x):
        return jnp.tanh(x @ p)

    def f2(p, x):
        h = x @ p["w"] + p["b"]
        return {"a": jnp.tanh(h), "s": jnp.sum(x, axis=-1)}

    def f3(p, d):
        h = jnp.concatenate([d["a"], d["s"][:, None]], axis=-1)
        return h @ p

    return [f1, f2, f3], [w1, p2, w3]


def test_gpipe_hetero_matches_sequential(rng):
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    fns, params = _hetero_fns_params(rng)
    M, B = 5, 4
    xs = jnp.asarray(rng.standard_normal((M, B, 6)), jnp.float32)

    got = np.asarray(gpipe_hetero(fns, params, xs, mesh))
    want = np.stack([
        np.asarray(fns[2](params[2], fns[1](params[1], fns[0](params[0],
                                                              xs[t]))))
        for t in range(M)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_hetero_stats(rng):
    """hetero_stats reports the packing plan gpipe_hetero actually uses:
    padded width = widest boundary, tick count, padding fractions."""
    from big_linear_algebra.parallel.pipeline import hetero_stats

    fns, params = _hetero_fns_params(rng)
    M, B = 5, 4
    xs = jnp.zeros((M, B, 6), jnp.float32)
    s = hetero_stats(fns, params, xs)
    # boundaries: (B,6)=24, (B,10)=40, {a:(B,4), s:(B,)}=20, (B,3)=12
    assert s["boundary_widths"] == [24, 40, 20, 12]
    assert s["padded_width"] == 40
    assert s["n_stages"] == 3 and s["n_micro"] == M
    assert s["n_ticks"] == M + 2 and s["fill_drain_ticks"] == 2
    np.testing.assert_allclose(s["padding_frac"],
                               [1 - 24 / 40, 0.0, 0.5, 1 - 12 / 40])
    assert s["bytes_per_tick"] == 40 * 4
    assert s["ppermute_bytes_total"] == (M + 2) * 40 * 4
    assert s["ring_bytes_total"] == 3 * (M + 2) * 40 * 4
    # steady-state useful bytes: internal boundaries (40 + 20) per microbatch
    assert s["useful_boundary_bytes"] == (40 + 20) * M * 4
    np.testing.assert_allclose(s["utilization"], M / (M + 2))
    # param widths: 60, 44, 15 -> padded 60
    assert s["param_widths"] == [60, 44, 15]
    assert s["param_padded_width"] == 60


def test_gpipe_hetero_gradients_match(rng):
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    fns, params = _hetero_fns_params(rng)
    M, B = 3, 4
    xs = jnp.asarray(rng.standard_normal((M, B, 6)), jnp.float32)

    def loss_pipe(params):
        return jnp.sum(gpipe_hetero(fns, params, xs, mesh) ** 2)

    def loss_seq(params):
        tot = 0.0
        for t in range(M):
            out = fns[2](params[2], fns[1](params[1], fns[0](params[0],
                                                             xs[t])))
            tot = tot + jnp.sum(out ** 2)
        return tot

    gp = jax.grad(loss_pipe)(params)
    gs = jax.grad(loss_seq)(params)
    for a, b in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_gpipe_hetero_unet_stages(rng):
    """The U-Net down/mid/up split (SURVEY §2.4 PP row) matches the
    sequential forward, microbatch for microbatch."""
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    cfg = cu.TINY
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = cu.init_params(jax.random.key(0), cfg)
    fns = cu.unet_pipeline_stages(cfg)
    stage_params = cu.split_params_stages(params)

    M, B = 3, 2
    xs = jnp.asarray(
        rng.standard_normal((M, B, 3, cfg.image_size, cfg.image_size)),
        jnp.float32)
    ts = jnp.asarray(rng.integers(0, cfg.timesteps, (M, B)), jnp.float32)

    got = np.asarray(gpipe_hetero(fns, stage_params, (xs, ts), mesh))
    want = np.stack([
        np.asarray(cu.forward(params, xs[t], ts[t].astype(jnp.int32), cfg,
                              train=False))
        for t in range(M)])
    # The stage-fn chain run sequentially is bit-exact vs forward(); inside
    # the pipeline XLA compiles the same f32 math through switch/fori_loop
    # with different fusion order, and the reference-style GN (divides by
    # variance, lib/norm.c §7.5) amplifies the reordering noise through ~20
    # blocks — measured ≤1.2e-3 abs on O(0.3) outputs.
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-3)


def test_gpipe_hetero_unet_training_mode(rng):
    """Training-mode pipeline (dropout ON via per-(stage, microbatch) keys)
    matches a sequential run of the stage fns given the SAME fold_in chain —
    so the stochastic layers are reproducible across the two executions."""
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    import dataclasses
    # f64: the keyed parity must be tight — any key mismatch flips ~10% of
    # activations, while f64 reordering noise stays ≤1e-9 (f32 noise through
    # the GN chain reaches 1e-2 and would mask a wrong key)
    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    fns = cu.unet_pipeline_stages(cfg, train=True)
    stage_params = cu.split_params_stages(params)

    M, B = 3, 2
    xs = jnp.asarray(
        rng.standard_normal((M, B, 3, cfg.image_size, cfg.image_size)))
    ts = jnp.asarray(rng.integers(0, cfg.timesteps, (M, B)), jnp.float64)
    base = jax.random.key(7)

    got = np.asarray(
        gpipe_hetero(fns, stage_params, (xs, ts), mesh, key=base))

    # Sequential reference: same stage fns, same fold_in(key, s*M + m) keys.
    outs = []
    for m in range(M):
        b = (xs[m], ts[m])
        for s, (fn, p) in enumerate(zip(fns, stage_params)):
            b = fn(p, b, jax.random.fold_in(base, s * M + m))
        outs.append(np.asarray(b))
    want = np.stack(outs)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


def test_gpipe_hetero_key_mismatch_errors(rng):
    """train=True without a key, or a key on inference stages, fails loudly
    instead of silently running the wrong dropout mode."""
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    cfg = cu.TINY
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = cu.init_params(jax.random.key(0), cfg)
    sp = cu.split_params_stages(params)
    xs = jnp.asarray(rng.standard_normal((2, 1, 3, 32, 32)), jnp.float32)
    ts = jnp.zeros((2, 1), jnp.float32)

    with pytest.raises(ValueError, match="key"):
        gpipe_hetero(cu.unet_pipeline_stages(cfg, train=True), sp,
                     (xs, ts), mesh)
    with pytest.raises(ValueError, match="train=True"):
        gpipe_hetero(cu.unet_pipeline_stages(cfg, train=False), sp,
                     (xs, ts), mesh, key=jax.random.key(0))


def test_gpipe_hetero_unet_nhwc_layout(rng):
    """cfg.layout="NHWC" is honored by the pipeline stages (boundary stays
    external NCHW; transpose happens at entry/exit like forward())."""
    import dataclasses
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    cfg_c = dataclasses.replace(cu.TINY, compute_dtype="float64")
    cfg_h = dataclasses.replace(cfg_c, layout="NHWC")
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    sp = cu.split_params_stages(params)
    xs = jnp.asarray(rng.standard_normal((2, 1, 3, 32, 32)))
    ts = jnp.asarray(rng.integers(0, cfg_c.timesteps, (2, 1)), jnp.float64)

    got_c = np.asarray(gpipe_hetero(
        cu.unet_pipeline_stages(cfg_c), sp, (xs, ts), mesh))
    got_h = np.asarray(gpipe_hetero(
        cu.unet_pipeline_stages(cfg_h), sp, (xs, ts), mesh))
    assert got_h.shape == got_c.shape == (2, 1, 3, 32, 32)
    np.testing.assert_allclose(got_h, got_c, rtol=1e-7, atol=1e-7)


def test_pp_train_step_matches_sequential(rng):
    """make_train_step_pp (microbatched gpipe_hetero loss + grad
    accumulation + Adam) produces the same updated params/opt/loss as a
    sequential microbatched step with the same DDPM draws and the same
    dropout fold chain (f64 — reordering noise ≤1e-9, a wrong key or a
    dropped microbatch gradient would show at O(1e-2))."""
    import dataclasses
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init, adam_update

    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    opt = adam_init(params)
    M = 2
    x0 = jnp.asarray(rng.standard_normal((4, 3, 32, 32)))
    key = jax.random.key(11)

    # Sequential reference first (pp_step donates its params/opt buffers).
    fns = cu.unet_pipeline_stages(cfg, train=True)
    xt, t, noise, kd = cu._ddpm_draws(x0, key, cfg)
    mb = x0.shape[0] // M
    xs = xt.reshape(M, mb, *x0.shape[1:])
    ts = t.reshape(M, mb).astype(x0.dtype)

    def loss_seq(p):
        sp = cu.split_params_stages(p)
        preds = []
        for m in range(M):
            b = (xs[m], ts[m])
            for s, (fn, stage_p) in enumerate(zip(fns, sp)):
                b = fn(stage_p, b, jax.random.fold_in(kd, s * M + m))
            preds.append(b)
        pred = jnp.stack(preds).reshape(x0.shape)
        return cu.mse_loss(pred, noise) / float(np.prod(x0.shape))

    loss_want, grads = jax.value_and_grad(loss_seq)(params)
    p_want, o_want = adam_update(params, grads, opt, cfg.learn_rate)

    pp_step = cu.make_train_step_pp(mesh, cfg, n_micro=M)
    p_pp, o_pp, loss_pp = pp_step(params, opt, x0, key)

    np.testing.assert_allclose(float(loss_pp), float(loss_want), rtol=1e-9)
    flat_got = jax.tree_util.tree_leaves_with_path(p_pp)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(p_want))
    for path, leaf in flat_got:
        a, b = np.asarray(leaf), np.asarray(flat_want[path])
        np.testing.assert_allclose(
            a, b, rtol=1e-8, atol=1e-10,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")
    # optimizer moments advanced identically
    np.testing.assert_allclose(int(o_pp.step), int(o_want.step))


def test_pp_train_step_mixed_precision(rng):
    """The PP step runs at the production bf16 config with f32 master
    params — the stage fns must cast params to the compute dtype like
    ``forward`` does (regression: the cast was missing, so ``--pp`` at the
    default bf16 config crashed at trace time with a conv dtype mismatch)."""
    import dataclasses
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init

    cfg = dataclasses.replace(cu.TINY, compute_dtype="bfloat16")
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = cu.init_params(jax.random.key(0), cu.TINY)  # f32 masters
    opt = adam_init(params)
    x0 = jnp.asarray(rng.standard_normal((4, 3, 32, 32)), jnp.float32)

    pp_step = cu.make_train_step_pp(mesh, cfg, n_micro=2)
    p2, o2, loss = pp_step(params, opt, x0, jax.random.key(3))
    assert np.isfinite(float(loss))
    # master params stay f32 (the cast happens inside the stage fns)
    assert all(l.dtype == jnp.float32
               for l in jax.tree_util.tree_leaves(p2))


def test_gpipe_hetero_training_mode_gradients(rng):
    """Gradients flow through the keyed pipeline and match the sequential
    chain with the same keys."""
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    import dataclasses
    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    fns = cu.unet_pipeline_stages(cfg, train=True)
    M, B = 3, 2
    xs = jnp.asarray(
        rng.standard_normal((M, B, 3, cfg.image_size, cfg.image_size)))
    ts = jnp.asarray(rng.integers(0, cfg.timesteps, (M, B)), jnp.float64)
    base = jax.random.key(7)

    def loss_pipe(sp):
        return jnp.sum(gpipe_hetero(fns, sp, (xs, ts), mesh, key=base) ** 2)

    def loss_seq(sp):
        tot = 0.0
        for m in range(M):
            b = (xs[m], ts[m])
            for s, (fn, p) in enumerate(zip(fns, sp)):
                b = fn(p, b, jax.random.fold_in(base, s * M + m))
            tot = tot + jnp.sum(b ** 2)
        return tot

    sp = cu.split_params_stages(params)
    g_pipe = jax.grad(loss_pipe)(sp)
    g_seq = jax.grad(loss_seq)(sp)
    flat_p = jax.tree_util.tree_leaves_with_path(g_pipe)
    flat_s = dict(jax.tree_util.tree_leaves_with_path(g_seq))
    for path, leaf in flat_p:
        a, b = np.asarray(leaf), np.asarray(flat_s[path])
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(
            a / scale, b / scale, rtol=0, atol=1e-7,
            err_msg=f"grad mismatch at {jax.tree_util.keystr(path)}")


def test_gpipe_grads_finite_with_nontotal_stage(rng):
    """Fill/drain ticks must not execute the stage on garbage buffers: a
    stage that is non-total on zeros (x/||x||) previously produced a finite
    forward but all-NaN parameter gradients (0 x NaN through the discarded
    chain's VJP). lax.cond now skips invalid ticks entirely."""
    mesh = make_mesh({"stage": 4}, devices=jax.devices()[:4])
    sw = jnp.asarray(rng.standard_normal((4, 6, 6)) * 0.3, jnp.float64)
    xs = jnp.asarray(rng.standard_normal((3, 2, 6)), jnp.float64)

    def stage(p, x):
        x = x / jnp.sqrt(jnp.sum(x * x))  # NaN at x = 0
        return jnp.tanh(x @ p)

    def loss(p):
        return jnp.sum(gpipe(stage, p, xs, mesh) ** 2)

    out = gpipe(stage, sw, xs, mesh)
    assert np.isfinite(np.asarray(out)).all()
    grads = jax.grad(loss)(sw)
    assert np.isfinite(np.asarray(grads)).all(), "fill/drain ticks poisoned grads"
    # parity with the sequential reference on the same non-total stage
    seq = xs
    for i in range(4):
        seq = jax.vmap(lambda x, i=i: stage(sw[i], x))(seq)
    np.testing.assert_allclose(np.asarray(out), np.asarray(seq), atol=1e-10)


def test_pp_dp_train_step_matches_sequential(rng):
    """PP×DP (VERDICT r3 #3): make_train_step_pp on a 2-D 3-stage × 2-data
    mesh — each data shard pipelines half the global microbatches, the
    shard_map transpose all-reduces param grads over the data axis — must
    match the same sequential microbatched reference as the 1-D PP test
    (identical global-microbatch dropout fold chain), in f64 to ~1e-9."""
    import dataclasses
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init, adam_update

    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"stage": 3, "data": 2}, devices=jax.devices()[:6])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    opt = adam_init(params)
    M = 4  # global microbatches: 2 per data shard
    x0 = jnp.asarray(rng.standard_normal((8, 3, 32, 32)))
    key = jax.random.key(11)

    # Sequential reference first (pp_step donates its params/opt buffers).
    fns = cu.unet_pipeline_stages(cfg, train=True)
    xt, t, noise, kd = cu._ddpm_draws(x0, key, cfg)
    mb = x0.shape[0] // M
    xs = xt.reshape(M, mb, *x0.shape[1:])
    ts = t.reshape(M, mb).astype(x0.dtype)

    def loss_seq(p):
        sp = cu.split_params_stages(p)
        preds = []
        for m in range(M):
            b = (xs[m], ts[m])
            for s, (fn, stage_p) in enumerate(zip(fns, sp)):
                b = fn(stage_p, b, jax.random.fold_in(kd, s * M + m))
            preds.append(b)
        pred = jnp.stack(preds).reshape(x0.shape)
        return cu.mse_loss(pred, noise) / float(np.prod(x0.shape))

    loss_want, grads = jax.value_and_grad(loss_seq)(params)
    p_want, o_want = adam_update(params, grads, opt, cfg.learn_rate)

    pp_step = cu.make_train_step_pp(mesh, cfg, n_micro=M, data_axis="data")
    p_pp, o_pp, loss_pp = pp_step(params, opt, x0, key)

    np.testing.assert_allclose(float(loss_pp), float(loss_want), rtol=1e-9)
    flat_got = jax.tree_util.tree_leaves_with_path(p_pp)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(p_want))
    for path, leaf in flat_got:
        a, b = np.asarray(leaf), np.asarray(flat_want[path])
        np.testing.assert_allclose(
            a, b, rtol=1e-8, atol=1e-10,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")
    assert int(o_pp.step) == int(o_want.step)


def test_gpipe_hetero_data_axis_validation():
    """n_micro not divisible by the data axis is a loud error."""
    from big_linear_algebra.parallel.pipeline import gpipe_hetero

    mesh = make_mesh({"stage": 2, "data": 2}, devices=jax.devices()[:4])
    fns = [lambda p, x: jnp.tanh(x @ p), lambda p, x: x @ p]
    ps = [jnp.eye(4), jnp.eye(4)]
    xs = jnp.ones((3, 2, 4))  # 3 microbatches over a 2-wide data axis
    with pytest.raises(ValueError, match="not divisible by data axis"):
        gpipe_hetero(fns, ps, xs, mesh, data_axis="data")


def test_pp_1f1b_train_step_matches_sequential(rng):
    """schedule="1f1b" (hand-scheduled one-forward-one-backward with the
    analytic MSE seed at the last stage and in-slot vjp recompute) must
    produce the same loss/params as the sequential microbatched reference —
    the same comparator as the GPipe-autodiff test, f64 ~1e-9."""
    import dataclasses
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init, adam_update

    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    opt = adam_init(params)
    M = 4
    x0 = jnp.asarray(rng.standard_normal((4, 3, 32, 32)))
    key = jax.random.key(11)

    fns = cu.unet_pipeline_stages(cfg, train=True)
    xt, t, noise, kd = cu._ddpm_draws(x0, key, cfg)
    mb = x0.shape[0] // M
    xs = xt.reshape(M, mb, *x0.shape[1:])
    ts = t.reshape(M, mb).astype(x0.dtype)

    def loss_seq(p):
        sp = cu.split_params_stages(p)
        preds = []
        for m in range(M):
            b = (xs[m], ts[m])
            for s, (fn, stage_p) in enumerate(zip(fns, sp)):
                b = fn(stage_p, b, jax.random.fold_in(kd, s * M + m))
            preds.append(b)
        pred = jnp.stack(preds).reshape(x0.shape)
        return cu.mse_loss(pred, noise) / float(np.prod(x0.shape))

    loss_want, grads = jax.value_and_grad(loss_seq)(params)
    p_want, _ = adam_update(params, grads, opt, cfg.learn_rate)

    pp_step = cu.make_train_step_pp(mesh, cfg, n_micro=M, schedule="1f1b")
    p_pp, o_pp, loss_pp = pp_step(params, opt, x0, key)

    np.testing.assert_allclose(float(loss_pp), float(loss_want), rtol=1e-9)
    flat_got = jax.tree_util.tree_leaves_with_path(p_pp)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(p_want))
    for path, leaf in flat_got:
        a, b = np.asarray(leaf), np.asarray(flat_want[path])
        np.testing.assert_allclose(
            a, b, rtol=1e-8, atol=1e-10,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_pp_1f1b_dp_train_step_matches_sequential(rng):
    """1F1B × DP: schedule="1f1b" on a 2-D 3-stage × 2-data mesh — each
    data shard runs its own hand-scheduled ring over half the global
    microbatches, grads/loss psum over the data axis — must match the SAME
    sequential reference as the 1-D 1F1B test (global-microbatch dropout
    folds), f64 ~1e-9."""
    import dataclasses
    from big_linear_algebra.models import cifar_unet as cu
    from big_linear_algebra.nn.optim import adam_init, adam_update

    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    mesh = make_mesh({"stage": 3, "data": 2}, devices=jax.devices()[:6])
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          cu.init_params(jax.random.key(0), cu.TINY))
    opt = adam_init(params)
    M = 4  # global microbatches: 2 per data shard
    x0 = jnp.asarray(rng.standard_normal((8, 3, 32, 32)))
    key = jax.random.key(11)

    fns = cu.unet_pipeline_stages(cfg, train=True)
    xt, t, noise, kd = cu._ddpm_draws(x0, key, cfg)
    mb = x0.shape[0] // M
    xs = xt.reshape(M, mb, *x0.shape[1:])
    ts = t.reshape(M, mb).astype(x0.dtype)

    def loss_seq(p):
        sp = cu.split_params_stages(p)
        preds = []
        for m in range(M):
            b = (xs[m], ts[m])
            for s, (fn, stage_p) in enumerate(zip(fns, sp)):
                b = fn(stage_p, b, jax.random.fold_in(kd, s * M + m))
            preds.append(b)
        pred = jnp.stack(preds).reshape(x0.shape)
        return cu.mse_loss(pred, noise) / float(np.prod(x0.shape))

    loss_want, grads = jax.value_and_grad(loss_seq)(params)
    p_want, _ = adam_update(params, grads, opt, cfg.learn_rate)

    pp_step = cu.make_train_step_pp(mesh, cfg, n_micro=M, schedule="1f1b",
                                    data_axis="data")
    p_pp, o_pp, loss_pp = pp_step(params, opt, x0, key)

    np.testing.assert_allclose(float(loss_pp), float(loss_want), rtol=1e-9)
    flat_got = jax.tree_util.tree_leaves_with_path(p_pp)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(p_want))
    for path, leaf in flat_got:
        a, b = np.asarray(leaf), np.asarray(flat_want[path])
        np.testing.assert_allclose(
            a, b, rtol=1e-8, atol=1e-10,
            err_msg=f"param mismatch at {jax.tree_util.keystr(path)}")


def test_gpipe_hetero_1f1b_data_axis_validation():
    """n_micro not divisible by the data axis is a loud error (1F1B)."""
    from big_linear_algebra.parallel.pipeline import gpipe_hetero_1f1b

    mesh = make_mesh({"stage": 2, "data": 2}, devices=jax.devices()[:4])
    fns = [lambda p, x: jnp.tanh(x @ p), lambda p, x: x @ p]
    ps = [jnp.eye(4), jnp.eye(4)]
    xs = jnp.ones((3, 2, 4))  # 3 microbatches over a 2-wide data axis
    tg = jnp.zeros((3, 2, 4))

    def seed(pred, t):
        d = pred[:8] - t[:8]
        return jnp.sum(d * d), 2.0 * d

    with pytest.raises(ValueError, match="not divisible by data axis"):
        gpipe_hetero_1f1b(fns, ps, xs, tg, seed, mesh, data_axis="data")


def test_hetero_stats_1f1b_fields():
    from big_linear_algebra.parallel.pipeline import hetero_stats

    fns = [lambda p, x: jnp.tanh(x @ p), lambda p, x: x @ p]
    ps = [jnp.eye(4), jnp.eye(4)]
    xs = jnp.ones((6, 2, 4))
    st = hetero_stats(fns, ps, xs)
    assert st["n_slots_1f1b"] == 6 + 2 * (2 - 1)
    assert st["utilization_1f1b"] == pytest.approx(6 / 8)
    assert st["n_slots_1f1b"] < 2 * st["n_ticks"]
