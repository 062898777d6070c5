"""Checkpoint tests: CSV layouts + npz pytree save/restore/resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra.ckpt import (
    latest_step,
    load_matrices,
    restore_pytree,
    save_matrices,
    save_pytree,
)
from big_linear_algebra.ckpt.csv_layouts import layout_exists


def test_csv_layout_roundtrip(tmp_path, rng):
    arrays = {
        "weights_1.csv": rng.standard_normal((8, 4)).astype(np.float32),
        "sub/biases_1.csv": rng.standard_normal((8, 1)).astype(np.float32),
    }
    spec = {k: v.shape for k, v in arrays.items()}
    assert not layout_exists(str(tmp_path), spec)
    save_matrices(str(tmp_path), arrays)
    assert layout_exists(str(tmp_path), spec)
    back = load_matrices(str(tmp_path), spec)
    for k in arrays:
        np.testing.assert_allclose(back[k], arrays[k], atol=5e-7)


def test_pytree_save_restore_latest(tmp_path, rng):
    tree = {
        "params": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32),
                   "b": jnp.zeros((3,), jnp.float32)},
        "step": jnp.asarray(7),
    }
    base = str(tmp_path / "ckpt")
    assert latest_step(base) is None
    save_pytree(base, 7, tree)
    tree2 = {
        "params": {"w": tree["params"]["w"] + 1, "b": tree["params"]["b"]},
        "step": jnp.asarray(13),
    }
    save_pytree(base, 13, tree2)
    assert latest_step(base) == 13

    restored = restore_pytree(
        base,
        target={"params": {"w": jnp.zeros((4, 3), jnp.float32),
                           "b": jnp.zeros((3,), jnp.float32)},
                "step": jnp.asarray(0)},
    )
    np.testing.assert_allclose(
        np.asarray(restored["params"]["w"]), np.asarray(tree2["params"]["w"])
    )
    assert int(restored["step"]) == 13

    older = restore_pytree(
        base,
        target={"params": {"w": jnp.zeros((4, 3), jnp.float32),
                           "b": jnp.zeros((3,), jnp.float32)},
                "step": jnp.asarray(0)},
        step=7,
    )
    assert int(older["step"]) == 7


def test_save_pytree_keep_last(tmp_path, rng):
    tree = {"w": jnp.asarray(rng.standard_normal((3, 2)), jnp.float32)}
    for s in (1, 2, 3, 4):
        save_pytree(str(tmp_path), s, tree, keep_last=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_3", "step_4"]
    assert latest_step(str(tmp_path)) == 4


def test_latest_step_skips_empty_partial_dir(tmp_path, rng):
    tree = {"w": jnp.asarray(rng.standard_normal((3, 2)), jnp.float32)}
    save_pytree(str(tmp_path), 5, tree)
    (tmp_path / "step_9").mkdir()  # crash left an empty dir
    assert latest_step(str(tmp_path)) == 5


def test_partial_step_dirs_ignored(tmp_path, rng):
    """A step directory without its manifest (a crash between the arrays
    and the manifest) and a leftover tmp directory are not restorable."""
    tree = {"w": jnp.asarray(rng.standard_normal((3, 2)), jnp.float32)}
    save_pytree(str(tmp_path), 5, tree)
    save_pytree(str(tmp_path), 8, tree)
    (tmp_path / "step_8" / "meta.json").unlink()
    (tmp_path / "step_11.tmp1234").mkdir()
    np.savez(tmp_path / "step_11.tmp1234" / "arrays.npz", np.zeros(3))
    assert latest_step(str(tmp_path)) == 5
    restored = restore_pytree(str(tmp_path), {"w": jnp.zeros((3, 2))})
    np.testing.assert_array_equal(np.asarray(restored["w"]),
                                  np.asarray(tree["w"]))


def test_pytree_round_trip_dtypes_and_cast(tmp_path, rng):
    """bf16, int, bool and 0-d leaves round-trip bit-exactly; restore casts
    to the target's dtypes (f32 → bf16 and back); a structure or shape
    mismatch is a ValueError, not a silent partial restore."""
    from big_linear_algebra.nn.optim import adam_init

    w = jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16)
    tree = {"params": {"w": w}, "opt": adam_init({"w": w}),
            "key_data": jnp.arange(4, dtype=jnp.uint32),
            "flag": np.asarray(True), "epoch": np.asarray(3, np.int32)}
    save_pytree(str(tmp_path), 1, tree)
    same = restore_pytree(str(tmp_path), tree)
    for a, b in zip(jax.tree.leaves(same), jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    f32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)
                       if jnp.asarray(x).dtype == jnp.bfloat16 else x, tree)
    cast = restore_pytree(str(tmp_path), f32)
    assert cast["params"]["w"].dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(cast["params"]["w"]),
                                  np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(str(tmp_path),
                       dict(tree, key_data=jnp.zeros(2, jnp.uint32)))
    with pytest.raises(ValueError, match="structure"):
        restore_pytree(str(tmp_path), {"params": {"w": w}})


def test_train_checkpointer_async_retention_restore(tmp_path, rng):
    from big_linear_algebra.ckpt.pytree import TrainCheckpointer

    tree = {"w": jnp.asarray(rng.standard_normal((4, 4)), jnp.float32),
            "step": jnp.asarray(0)}
    with TrainCheckpointer(str(tmp_path), max_to_keep=2) as ck:
        for s, loss in [(1, 5.0), (2, 3.0), (3, 4.0)]:
            ck.save(s, dict(tree, step=jnp.asarray(s)),
                    metrics={"loss": loss})
        ck.wait()
        assert ck.all_steps() == [2, 3]      # keep-last-2
        restored = ck.restore(tree)
        assert int(restored["step"]) == 3
        np.testing.assert_allclose(np.asarray(restored["w"]),
                                   np.asarray(tree["w"]))


def test_train_checkpointer_best_k(tmp_path, rng):
    from big_linear_algebra.ckpt.pytree import TrainCheckpointer

    tree = {"w": jnp.zeros((2, 2), jnp.float32)}
    with TrainCheckpointer(str(tmp_path), max_to_keep=2,
                           best_metric="loss") as ck:
        for s, loss in [(1, 2.0), (2, 9.0), (3, 1.0), (4, 8.0)]:
            ck.save(s, tree, metrics={"loss": loss})
        ck.wait()
        # keeps the two LOWEST-loss steps, not the two most recent
        assert ck.all_steps() == [1, 3]


def test_train_checkpointer_sync_and_writer_error(tmp_path, rng):
    """async_saves=False writes before returning; a failure in the writer
    thread surfaces in the caller at wait(), not silently."""
    from big_linear_algebra.ckpt.pytree import TrainCheckpointer

    tree = {"w": jnp.ones((2, 2), jnp.float32)}
    ck = TrainCheckpointer(str(tmp_path / "a"), max_to_keep=None,
                           async_saves=False)
    ck.save(4, tree)
    assert ck.all_steps() == [4]
    (tmp_path / "b").write_text("a file where the directory should be")
    ck = TrainCheckpointer(str(tmp_path / "b"))
    ck.save(1, tree)
    with pytest.raises(OSError):
        ck.wait()
