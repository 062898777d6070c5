"""cifar_unet end-to-end tests (TINY config on CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.models import cifar_unet as cu


@pytest.fixture
def env_data_dir(tmp_path):
    os.environ["BLA_DATA_DIR"] = str(tmp_path)
    yield tmp_path
    del os.environ["BLA_DATA_DIR"]


CFG = cu.TINY


def test_forward_shape_and_finiteness(rng):
    params = cu.init_params(jax.random.key(0), CFG)
    x = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)
    t = jnp.asarray([0, CFG.timesteps - 1])
    out = cu.forward(params, x, t, CFG)
    assert out.shape == (2, 3, 32, 32)
    assert np.isfinite(np.asarray(out)).all()


def test_time_embedding_changes_output(rng):
    params = cu.init_params(jax.random.key(0), CFG)
    x = jnp.asarray(rng.standard_normal((1, 3, 32, 32)), jnp.float32)
    o0 = np.asarray(cu.forward(params, x, jnp.asarray([0]), CFG))
    o1 = np.asarray(cu.forward(params, x, jnp.asarray([CFG.timesteps - 1]),
                               CFG))
    assert np.abs(o0 - o1).max() > 1e-6


def test_gradients_reach_every_parameter(rng):
    params = cu.init_params(jax.random.key(0), CFG)
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)
    grads = jax.grad(cu.loss_fn)(params, x0, jax.random.key(1), CFG)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    for path, leaf in flat:
        arr = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        assert np.isfinite(arr).all(), f"non-finite grad at {name}"
        # conv_3 (1x1 residual conv) is only applied when channels change
        # (model/cifar_unet.c:1061-1071) — zero grad is correct elsewhere.
        if "conv_3" in name:
            used = any(f"'{blk}'" in name and "'resnet_1'" in name
                       for blk in ("down_1", "up_1", "up_2", "up_3", "up_4"))
            if not used:
                continue
        # up_1/up_2 channel-matching convs are skipped when dims are equal
        # (model/cifar_unet.c:1130-1133) — TINY/CONFIG both have d4==d3==d2.
        if ("'up_1'" in name or "'up_2'" in name) and "'conv'" in name:
            continue
        assert np.abs(arr).max() > 0, f"zero grad at {name} (dead wiring?)"


def test_train_step_reduces_loss(rng):
    params = cu.init_params(jax.random.key(0), CFG)
    opt = cu.adam_init(params)
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)) * 0.5, jnp.float32)
    cfg = cu.TINY
    key = jax.random.key(2)
    losses = []
    for _ in range(40):
        key, k = jax.random.split(key)
        params, opt, loss = cu.train_step(params, opt, x0, k, cfg)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses


def test_scan_unroll_preserves_training_math(rng):
    """Config.scan_unroll only changes code generation (slice-overhead
    amortization): the per-step op ORDER is unchanged,
    but XLA fuses the unrolled body differently, reassociating float
    reductions at the ulp level (measured ~1e-6 rel on an f32 loss). In f64
    the reassociation noise stays far below f32-grad resolution, so
    train_chunk losses and final params must agree tightly across unroll
    factors — including a K not divisible by the factor."""
    import dataclasses

    x = jnp.asarray(rng.standard_normal((5, 2, 3, 32, 32)) * 0.5,
                    jnp.float32)  # K=5: exercises the unroll remainder
    keys = jax.random.split(jax.random.key(3), 5)
    results = {}
    for unroll in (1, 4):
        cfg = dataclasses.replace(cu.TINY, compute_dtype="float64",
                                  scan_unroll=unroll)
        params = cu.init_params(jax.random.key(0), cfg)
        opt = cu.adam_init(params)
        p, o, losses = jax.jit(
            lambda p, o, x, k, cfg=cfg: cu.train_chunk(p, o, x, k, cfg)
        )(params, opt, x, keys)
        results[unroll] = (np.asarray(losses),
                           np.asarray(p["output_conv"], np.float64))
    np.testing.assert_allclose(results[1][0], results[4][0], rtol=1e-6)
    np.testing.assert_allclose(results[1][1], results[4][1],
                               rtol=1e-5, atol=1e-8)


def test_cli_scan_unroll_flag(env_data_dir, capsys):
    """--scan-unroll=N reaches Config; non-positive values are loud."""
    from big_linear_algebra.data import synth
    from big_linear_algebra.models import common

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--scan-unroll=2"]) == 0
    assert "avg_loss" in capsys.readouterr().out
    _, flags = common.parse_flags(["--scan-unroll=0"])
    with pytest.raises(ValueError, match="must be positive"):
        cu._cfg_from_flags({**flags, "tiny": ""})


def test_bf16_compute_forward_and_learning(rng):
    import dataclasses

    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    params = cu.init_params(jax.random.key(0), cfg)
    x = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)
    out = cu.forward(params, x, jnp.asarray([0, 5]), cfg)
    assert out.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(out, np.float32)).all()
    opt = cu.adam_init(params)
    key = jax.random.key(1)
    losses = []
    for _ in range(12):
        key, k = jax.random.split(key)
        params, opt, loss = cu.train_step(params, opt, x, k, cfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # master params stay f32 under mixed precision
    assert params["output_conv"].dtype == jnp.float32


def test_csv_checkpoint_roundtrip(env_data_dir, rng):
    params = cu.init_params(jax.random.key(3), CFG)
    cu.save_params_csv(params, CFG)
    back = cu.load_params_csv(CFG)
    x = jnp.asarray(rng.standard_normal((1, 3, 32, 32)), jnp.float32)
    t = jnp.asarray([5])
    o1 = np.asarray(cu.forward(params, x, t, CFG))
    o2 = np.asarray(cu.forward(back, x, t, CFG))
    np.testing.assert_allclose(o1, o2, atol=1e-4)


def test_sampling_shape(rng):
    params = cu.init_params(jax.random.key(4), CFG)
    # num_samples=1 shares the compiled graph with the run-CLI test
    imgs = cu.sample(params, jax.random.key(0), CFG, 1)
    assert imgs.shape == (1, 3, 32, 32)
    arr = np.asarray(imgs)
    assert np.isfinite(arr).all()
    assert arr.min() >= -1.0 and arr.max() <= 1.0


def test_cli_end_to_end(env_data_dir, capsys):
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert "avg_loss" in out
    # resume: second train run restores the saved train state, continues the
    # epoch numbering AND the RNG stream (key/epoch ride the checkpoint —
    # replaying run 1's permutations/noise would correlate the updates)
    assert cu.main(["train", "1", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert "resumed train state" in out
    assert "epoch: 1" in out and "epoch: 0" not in out
    assert cu.main(["run", "1", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert "sample_0.bmp" in out
    assert (env_data_dir / "cifar_unet/samples/sample_0.bmp").is_file()


def test_denoise_psnr_improves_with_training(rng):
    """Sample quality as a pass/fail metric (VERDICT r2 #6): one-shot
    denoising PSNR on held-out data rises after training — fails if the
    training path regresses to not-learning."""
    from big_linear_algebra.nn.optim import adam_init

    cfg = cu.TINY
    params = cu.init_params(jax.random.key(0), cfg)
    # structured held-out images (quadrant blocks) matching the synthetic
    # training distribution's learnable statistics
    data = jnp.asarray(
        np.repeat(np.repeat(rng.random((96, 3, 8, 8)) * 2 - 1, 4, 2), 4, 3),
        jnp.float32)
    train, held = data[:64], data[64:]
    ts = (1, 4, 6)  # early/mid/late of TINY's 8 timesteps

    before = np.asarray(cu.denoise_psnr(params, held, jax.random.key(9),
                                        cfg, ts))
    assert np.all(np.isfinite(before))

    opt = adam_init(params)
    key = jax.random.key(3)
    for _ in range(12):
        key, kp, ks = jax.random.split(key, 3)
        idx = jax.random.permutation(kp, 64)[: cfg.batch_size * 8]
        xs = train[idx].reshape(8, cfg.batch_size, 3, 32, 32)
        params, opt, _ = cu.train_chunk(
            params, opt, xs, jax.random.split(ks, 8), cfg)

    after = np.asarray(cu.denoise_psnr(params, held, jax.random.key(9),
                                       cfg, ts))
    assert np.all(np.isfinite(after))
    # training must improve one-shot denoising at every probed timestep
    assert np.all(after > before), (before, after)
    # and by a sane margin in aggregate (an untrained net is ~0 dB gain)
    assert after.mean() - before.mean() > 0.5, (before, after)


def test_run_from_train_state(env_data_dir, capsys):
    """Crash-resume → sample: a killed train leaves only (or a newer)
    train_state; ``run`` must sample from it instead of the stale/absent CSV
    tree (training-is-resume contract, model/mnist_nn.c:165-170)."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny", "--max-steps=1"]) == 0
    capsys.readouterr()
    ckpt = env_data_dir / "cifar_unet"
    # stale CSV tree (as if the run was killed after a checkpoint but before
    # the train-exit CSV save): backdate every CSV → prefer the train_state
    for p in ckpt.rglob("*.csv"):
        os.utime(p, (1.0, 1.0))
    assert cu.main(["run", "1", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert "sampling from train_state" in out
    assert (ckpt / "samples/sample_0.bmp").is_file()
    # no CSV tree at all (killed before the first train exit): the state
    # alone is enough to sample
    for p in list(ckpt.rglob("*.csv")):
        p.unlink()
    (ckpt / "samples/sample_0.bmp").unlink()
    assert cu.main(["run", "1", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert "no CSV tree" in out
    assert (ckpt / "samples/sample_0.bmp").is_file()


def test_cli_pp_flag(env_data_dir, capsys):
    """--pp: the down/mid/up stages train as a 3-device gpipe_hetero
    pipeline with microbatched gradient accumulation (make_train_step_pp)."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--pp", "--pp-micro=2",
                    "--max-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "--pp: 3-stage pipeline" in out
    assert "avg_loss" in out
    with pytest.raises(SystemExit):
        cu.main(["train", "1", "--tiny", "--pp", "--tp"])  # no --pp --tp
    with pytest.raises(SystemExit):
        # batch 2 not divisible into 4 microbatches
        cu.main(["train", "1", "--tiny", "--pp"])
    with pytest.raises(ValueError):
        # strict flag policy: 0/negative/bare --pp-micro are hard errors,
        # not ZeroDivisionError / silent defaults
        cu.main(["train", "1", "--tiny", "--pp", "--pp-micro=0"])
    with pytest.raises(ValueError):
        cu.main(["train", "1", "--tiny", "--pp", "--pp-micro"])


def test_cli_pp_schedule_flag(env_data_dir, capsys):
    """--pp-schedule=1f1b trains via the hand-scheduled pipeline; bad
    values / --dp composition are hard errors."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--pp", "--pp-micro=2",
                    "--pp-schedule=1f1b", "--max-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "1f1b schedule" in out and "avg_loss" in out
    with pytest.raises(SystemExit, match="gpipe or 1f1b"):
        cu.main(["train", "1", "--tiny", "--pp", "--pp-micro=2",
                 "--pp-schedule=zigzag"])
    # 1F1B composes with --dp (2-D stage×data mesh, 1f1b ring per shard)
    assert cu.main(["train", "1", "--tiny", "--pp", "--dp", "--pp-micro=2",
                    "--pp-schedule=1f1b", "--max-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "data shards, 2 global microbatches, 1f1b schedule" in out
    assert "avg_loss" in out


def test_cli_pp_dp_flag(env_data_dir, capsys):
    """--pp --dp (VERDICT r3 #3): a 2-D 3-stage × N-data mesh trains via
    make_train_step_pp(data_axis="data"); microbatch/data divisibility is a
    hard error."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--pp", "--dp", "--pp-micro=2",
                    "--max-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "--pp --dp: 3-stage pipeline" in out and "data shards" in out
    assert "avg_loss" in out
    with pytest.raises(SystemExit, match="not .*divisible"):
        # 8 CPU devices -> 2 data shards; 1 microbatch cannot split over 2
        cu.main(["train", "1", "--tiny", "--pp", "--dp", "--pp-micro=1"])


def test_cli_tp_flag(env_data_dir, capsys):
    """--tp: conv kernels channel-shard over the local devices; the epoch
    runs TP via GSPMD and still converges/logs normally."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    # --max-steps uses the per-step path: the whole-epoch scan under GSPMD
    # partitioning is a multi-minute XLA:CPU compile, the single step is not
    assert cu.main(["train", "1", "--tiny", "--tp", "--max-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "channel-sharded over" in out
    assert "avg_loss" in out
    with pytest.raises(SystemExit):
        cu.main(["train", "1", "--tiny", "--tp", "--dp"])


def test_cli_dp_with_batch_layout_remat(env_data_dir, capsys):
    """The new config flags compose with --dp: batch 8 over the 8-device
    mesh, channels-last layout, remat blocks — one DP step runs and logs."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--dp", "--batch=8",
                    "--layout=NHWC", "--remat", "--max-steps=1"]) == 0
    out = capsys.readouterr().out
    assert "avg_loss" in out
    with pytest.raises(ValueError):
        cu.main(["train", "1", "--tiny", "--batch"])  # bare flag: hard error
    with pytest.raises(ValueError):
        # --remat takes no value: --remat=false must NOT silently enable it
        cu.main(["train", "1", "--tiny", "--remat=false"])


def test_prng_config_and_flag():
    """--prng selects the key impl (rbg = XLA's RngBitGenerator for random
    bits; threefry = the bit-stable-across-compilers stream). Bad values
    are hard errors."""
    import dataclasses

    assert cu._cfg_from_flags({"prng": "threefry"}).prng == "threefry2x32"
    assert cu._cfg_from_flags({"prng": "rbg"}).prng == "rbg"
    assert cu._cfg_from_flags({"prng": "unsafe_rbg"}).prng == "unsafe_rbg"
    with pytest.raises(ValueError):
        cu._cfg_from_flags({"prng": "xorshift"})
    with pytest.raises(ValueError):
        cu._cfg_from_flags({"prng": ""})  # bare --prng
    # the impl rides the key dtype and survives split/fold_in
    k = cu.root_key(0, cu._cfg_from_flags({"prng": "rbg"}))
    assert "rbg" in str(k.dtype)
    assert "rbg" in str(jax.random.split(jax.random.fold_in(k, 3), 2).dtype)
    with pytest.raises(ValueError):
        cu.root_key(0, dataclasses.replace(CFG, prng="bogus"))


def test_train_step_learns_with_rbg_keys(rng):
    """The shipped default (cfg.prng="rbg"): dropout masks come from the
    hardware-RNG key family; training still learns and stays finite."""
    params = cu.init_params(cu.root_key(0, CFG), CFG)
    opt = cu.adam_init(params)
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)) * 0.5, jnp.float32)
    key = cu.root_key(2, CFG)
    losses = []
    for _ in range(30):
        key, k = jax.random.split(key)
        params, opt, loss = cu.train_step(params, opt, x0, k, CFG)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses


def test_wrap_restored_key_infers_impl(capsys):
    """Resume across a --prng switch: the stored key_data width identifies
    the impl family; the resumed run continues the original stream."""
    kd_tf = jax.random.key_data(jax.random.key(7, impl="threefry2x32"))
    kd_rbg = jax.random.key_data(jax.random.key(7, impl="rbg"))
    # rbg config resuming a threefry checkpoint keeps the threefry stream
    k = cu._wrap_restored_key(kd_tf, CFG)
    assert "fry" in str(k.dtype)
    assert "original impl threefry2x32" in capsys.readouterr().out
    np.testing.assert_array_equal(jax.random.key_data(k), kd_tf)
    # same-family restore is silent
    k2 = cu._wrap_restored_key(kd_rbg, CFG)
    assert "rbg" in str(k2.dtype)
    assert "original impl" not in capsys.readouterr().out
    # threefry config resuming an rbg checkpoint: width 4 -> rbg family
    import dataclasses

    k3 = cu._wrap_restored_key(
        kd_rbg, dataclasses.replace(CFG, prng="threefry2x32"))
    assert "rbg" in str(k3.dtype)
    assert "original impl rbg" in capsys.readouterr().out


def test_cli_resume_across_prng_switch(env_data_dir, capsys):
    """train --prng=threefry then plain train (rbg default): the second run
    restores the threefry checkpoint (different key_data width) and keeps
    its RNG stream rather than silently restarting it."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny", "--prng=threefry",
                    "--max-steps=1"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--max-steps=1"]) == 0
    out = capsys.readouterr().out
    assert "resumed train state" in out
    assert "original impl threefry2x32" in out


def test_image_size_64_engages_flash_in_model(rng, monkeypatch):
    """Config.image_size is general; at 64x64 the down_2/up_3 attention
    sites run at N = 32x32 = 1024 tokens = the flash dispatch threshold,
    so the flash Pallas kernels execute inside the real train step (the
    32x32 reference scale stays dense: its N = 256 is below the
    threshold)."""
    import dataclasses

    import importlib

    # the module (nn/__init__ re-exports a same-named function, which
    # shadows `import ... as` attribute resolution)
    attn = importlib.import_module("big_linear_algebra.nn.attention")

    cfg = dataclasses.replace(cu.TINY, image_size=64)
    params = cu.init_params(jax.random.key(0), cfg)
    calls = []
    real = attn.flash_attention

    def counting(q, k, v, *a, **kw):
        calls.append(q.shape)
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(attn, "flash_attention", counting)
    x = jnp.asarray(rng.standard_normal((1, 3, 64, 64)) * 0.5, jnp.float32)
    out = cu.forward(params, x, jnp.asarray([3]), cfg)
    assert out.shape == (1, 3, 64, 64)
    assert np.isfinite(np.asarray(out)).all()
    # down_2 attn_1/attn_2 and up_3 attn_1/attn_2 cross the threshold;
    # mid (8x8 = 64 tokens) stays dense
    assert len(calls) == 4, calls
    assert all(s[1] == 1024 for s in calls), calls


def test_wrap_restored_key_prng_code_disambiguates(capsys):
    """rbg and unsafe_rbg share a key_data width; the checkpoint's explicit
    prng code names the stream exactly (width inference is the legacy
    fallback)."""
    kd = jax.random.key_data(jax.random.key(5, impl="unsafe_rbg"))
    k = cu._wrap_restored_key(kd, CFG, prng_code=cu._PRNG_CODES["unsafe_rbg"])
    assert "urbg" in str(k.dtype)  # unsafe_rbg's dtype tag
    assert "original impl unsafe_rbg" in capsys.readouterr().out
    st = cu._key_state(jax.random.key(5, impl="unsafe_rbg"))
    assert int(st["prng"]) == cu._PRNG_CODES["unsafe_rbg"]
    assert st["key_data"].shape[-1] == 4


def test_wrap_restored_key_unknown_code_falls_back(capsys):
    """A corrupted / future-valued prng code must fall back to the width
    inference (with a diagnostic), not raise a bare KeyError far from the
    cause (ADVICE r3)."""
    kd_tf = jax.random.key_data(jax.random.key(7, impl="threefry2x32"))
    k = cu._wrap_restored_key(kd_tf, CFG, prng_code=99)
    out = capsys.readouterr().out
    assert "unknown prng code 99" in out
    assert "fry" in str(k.dtype)  # width 2 -> threefry by inference
    np.testing.assert_array_equal(jax.random.key_data(k), kd_tf)


def test_cli_resume_across_unsafe_rbg(env_data_dir, capsys):
    """unsafe_rbg checkpoints resume as unsafe_rbg under the rbg default —
    the explicit prng field survives the save/restore round trip."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny", "--prng=unsafe_rbg",
                    "--max-steps=1"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--max-steps=1"]) == 0
    out = capsys.readouterr().out
    assert "resumed train state" in out
    assert "original impl unsafe_rbg" in out


def test_cli_image_size(env_data_dir, capsys):
    """--image-size=64: the 32x32 CIFAR records nearest-upscale on device
    and the same (resolution-independent) parameters train/sample at the
    higher resolution — where the attention sites cross the flash
    threshold (see test_image_size_64_engages_flash_in_model)."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--image-size=64",
                    "--max-steps=1"]) == 0
    out = capsys.readouterr().out
    assert "avg_loss" in out
    assert cu.main(["run", "1", "--tiny", "--image-size=64"]) == 0
    out = capsys.readouterr().out
    assert "sample_0.bmp" in out
    with pytest.raises(ValueError):
        cu.main(["train", "1", "--tiny", "--image-size=40"])  # not x32
    with pytest.raises(ValueError):
        cu.main(["train", "1", "--tiny", "--image-size"])  # bare flag


def test_fit_images_upscale():
    import dataclasses

    x = jnp.arange(2 * 3 * 2 * 2, dtype=jnp.float32).reshape(2, 3, 2, 2)
    cfg = dataclasses.replace(cu.TINY, image_size=4)
    y = cu._fit_images(x, cfg)
    assert y.shape == (2, 3, 4, 4)
    # nearest-neighbor: each source pixel becomes a 2x2 block
    np.testing.assert_array_equal(np.asarray(y)[:, :, ::2, ::2],
                                  np.asarray(x))
    np.testing.assert_array_equal(np.asarray(y)[:, :, 1::2, 1::2],
                                  np.asarray(x))
    assert cu._fit_images(y, cfg) is y  # already at size: no-op


def test_load_params_csv_rejects_other_config_tree(env_data_dir):
    """A CSV tree written by a different config must hard-error on load
    (exact=True), not silently reinterpret file prefixes as weights that
    the exit save would then write back over the original tree."""
    import dataclasses

    big = dataclasses.replace(cu.TINY, embed_dims=(12, 16, 16, 16))
    cu.save_params_csv(cu.init_params(jax.random.key(0), big), big)
    with pytest.raises(ValueError, match="different model configuration"):
        cu.load_params_csv(cu.TINY)


def test_strict_int_flags(env_data_dir):
    """--max-steps/--scan-steps/--keep/--sample-seed follow the hard-error
    flag policy: bare or out-of-range values never fall back silently."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    for argv in (["train", "1", "--tiny", "--max-steps"],
                 ["train", "1", "--tiny", "--max-steps=0"],
                 ["train", "1", "--tiny", "--scan-steps=0"],
                 ["train", "1", "--tiny", "--keep=-2"],
                 ["run", "1", "--tiny", "--sample-seed=x"]):
        with pytest.raises(ValueError):
            cu.main(argv)


def test_batch_exceeding_dataset_is_loud(env_data_dir):
    """Zero full batches would log avg_loss=nan and checkpoint a nan
    metric; it must be a hard error instead."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    with pytest.raises(SystemExit, match="exceeds the dataset"):
        cu.main(["train", "1", "--tiny", "--batch=100000"])


def test_cli_scan_steps_and_host_loop(env_data_dir, capsys):
    """Positive paths of the dispatch-mode flags: --scan-steps=2 (chunked
    scan with ragged tail) and --host-loop (per-batch dispatch) both train
    and log normally."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=10)
    assert cu.main(["init", "--tiny"]) == 0
    capsys.readouterr()
    # 10 examples / batch 2 = 5 steps: two chunks of 2 + 1 ragged step
    assert cu.main(["train", "1", "--tiny", "--scan-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "avg_loss" in out
    assert cu.main(["train", "1", "--tiny", "--host-loop",
                    "--max-steps=2"]) == 0
    out = capsys.readouterr().out
    assert "avg_loss" in out


# ---------------------------------------------------------------------------
# bf16-resident params (--bf16-params): VERDICT r3 #1
# ---------------------------------------------------------------------------

BF16_CFG = __import__("dataclasses").replace(
    CFG, param_dtype="bfloat16", compute_dtype="bfloat16")


def test_bf16_params_tree_and_train_step(rng):
    """param_dtype="bfloat16": every stored leaf is bf16, the Adam moments
    are f32, a train step keeps the tree bf16, and a short run still
    reduces the loss (the f32-in-optimizer round-trip must not destroy the
    updates)."""
    params = cu.init_params(jax.random.key(0), BF16_CFG)
    for leaf in jax.tree.leaves(params):
        assert leaf.dtype == jnp.bfloat16
    opt = cu.adam_init(params)
    for leaf in jax.tree.leaves(opt.m):
        assert leaf.dtype == jnp.float32
    x0 = jnp.asarray(rng.standard_normal((2, 3, 32, 32)) * 0.5, jnp.float32)
    key = jax.random.key(2)
    losses = []
    for i in range(40):
        key, ks = jax.random.split(key)
        params, opt, loss = cu.train_step(params, opt, x0, ks, BF16_CFG)
        losses.append(float(loss))
    assert jax.tree.leaves(params)[0].dtype == jnp.bfloat16
    assert np.isfinite(losses).all()
    # same criterion as the f32 test_train_step_reduces_loss (the DDPM loss
    # at TINY scale is dominated by the per-step timestep draw)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses


def test_bf16_params_csv_round_trip(env_data_dir):
    """bf16 params survive the CSV tree within the format's own precision:
    the text layout is the reference's ``%f`` (6 decimals, lib/csv.c:59), so
    the absolute truncation error is ≤5e-7 exactly as for f32 masters; a
    value that lands on a bf16 rounding midpoint may additionally flip one
    bf16 ulp (rel 2^-8)."""
    params = cu.init_params(jax.random.key(0), BF16_CFG)
    cu.save_params_csv(params, BF16_CFG)
    loaded = cu.load_params_csv(BF16_CFG)
    flat, _ = jax.tree_util.tree_flatten(params)
    flat2, _ = jax.tree_util.tree_flatten(loaded)
    for a, b in zip(flat, flat2):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=1 / 128, atol=1e-6)


@pytest.mark.parametrize("first,second", [
    ([], ["--bf16-params"]),      # f32 checkpoint resumed bf16-resident
    (["--bf16-params"], []),      # bf16 checkpoint resumed full-precision
])
def test_cli_resume_across_param_dtype_switch(env_data_dir, capsys,
                                              first, second):
    """A train_state written under one param_dtype resumes under the other:
    the restore dtype-aligns to the requested schema instead of failing or
    silently keeping the saved dtypes (VERDICT r3 #1 'version the schema')."""
    from big_linear_algebra.data import synth

    synth.ensure_cifar(str(env_data_dir), n_batches=1, per_batch=8)
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny", "--max-steps=2"] + first) == 0
    capsys.readouterr()
    assert cu.main(["train", "1", "--tiny", "--max-steps=2"] + second) == 0
    out = capsys.readouterr().out
    assert "resumed train state at step 2" in out
    assert "avg_loss" in out or "epoch" in out
