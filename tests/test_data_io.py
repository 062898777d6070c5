"""Data-layer tests: CSV contract (incl. parity with reference-shipped files),
MNIST loaders, CIFAR-10 binary format, BMP round-trip, native-vs-Python
fallback equivalence, prefetch iterator."""

import numpy as np
import pytest

from big_linear_algebra.data import (
    MnistCSVStream,
    MnistDataset,
    count_num_lines,
    read_batch,
    read_bmp,
    read_csv_matrix,
    read_csv_values,
    visualize_digit,
    write_bmp,
    write_csv_matrix,
    pixels_to_chw,
    chw_to_pixels,
    Cifar10Batches,
    prefetch_to_device,
)
from big_linear_algebra.data import _native, synth
from big_linear_algebra.data.csv import _py_read_values
from tests import oracle


def test_csv_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((7, 5)).astype(np.float32)
    path = tmp_path / "m.csv"
    write_csv_matrix(str(path), arr)
    # reference format: trailing comma per value, newline per row
    first_line = path.read_text().splitlines()[0]
    assert first_line.endswith(",")
    assert first_line.count(",") == 5
    back = read_csv_matrix(str(path), 7, 5)
    np.testing.assert_allclose(back, arr, atol=5e-7)  # %f = 6 decimals
    assert count_num_lines(str(path)) == 7


def test_csv_contract_empty_and_standard(tmp_path):
    # ',' always closes a value (empty -> 0.0); newline closes non-empty;
    # standard CSV without trailing commas must parse fully (intended
    # semantics; the reference would drop/overflow, SURVEY.md §7.12).
    p = tmp_path / "c.csv"
    p.write_text("1.5,,2.5,\n3.5,4.5\n")
    vals = read_csv_values(str(p))
    np.testing.assert_allclose(vals, [1.5, 0.0, 2.5, 3.5, 4.5])


def test_csv_native_matches_python_fallback(tmp_path, rng):
    p = tmp_path / "x.csv"
    arr = rng.standard_normal((11, 3)).astype(np.float32)
    write_csv_matrix(str(p), arr)
    py = _py_read_values(str(p))
    native = _native.csv_read(str(p))
    if native is None:
        pytest.skip("native IO unavailable")
    np.testing.assert_array_equal(py, native)


@pytest.mark.skipif(not oracle.reference_available(), reason="no reference")
def test_reads_reference_shipped_csvs():
    # The reference's tiny fixtures: data/a.csv is 3x3 (main.c:43-70).
    vals = read_csv_values("/root/reference/data/a.csv")
    assert vals.size == 9
    m = read_csv_matrix("/root/reference/data/mnist_nn/weights_1.csv", 256, 784)
    assert m.shape == (256, 784)
    assert np.isfinite(m).all() and np.abs(m).max() < 10


@pytest.mark.skipif(not oracle.reference_available(), reason="no reference")
def test_write_readable_by_c_reference(tmp_path, rng):
    """Byte-level interop: the C reference parses our CSV output."""
    import ctypes

    arr = rng.standard_normal((4, 6)).astype(np.float32)
    p = tmp_path / "interop.csv"
    write_csv_matrix(str(p), arr)
    lib = oracle.load_oracle()
    lib.read_csv_contents.restype = ctypes.POINTER(ctypes.c_float)
    got = lib.read_csv_contents(str(p).encode())
    back = np.ctypeslib.as_array(got, shape=(24,)).copy()
    np.testing.assert_allclose(back.reshape(4, 6), arr, atol=5e-7)


def test_mnist_dataset_and_stream(tmp_path, rng):
    path = tmp_path / "mnist.csv"
    synth.write_mnist_csv(str(path), rng, 32)
    ds = MnistDataset.from_csv(str(path))
    assert ds.x.shape == (32, 784) and ds.y.shape == (32,)
    assert set(np.unique(ds.y)) <= set(range(10))
    assert ds.x.min() >= 0 and ds.x.max() <= 255

    # streaming reader sees identical rows
    stream = MnistCSVStream(str(path))
    row0 = next(iter(stream))
    assert row0[0] == ds.y[0]
    np.testing.assert_array_equal(row0[1:], ds.x[0])
    stream.close()

    # sampling
    xb, yb = ds.sample_with_replacement(rng, 16)
    assert xb.shape == (16, 784)
    batches = list(ds.epoch_batches(rng, 10))
    assert sum(b[0].shape[0] for b in batches) == 32
    # without replacement: every example exactly once
    all_labels = np.concatenate([b[1] for b in batches])
    assert sorted(all_labels.tolist()) == sorted(ds.y.tolist())


def test_visualize_digit(rng):
    _, pixels = synth.synth_mnist_examples(rng, 1)
    art = visualize_digit(pixels[0] / 255.0, label=3.0)
    lines = art.splitlines()
    assert "digit 3" in lines[1]
    assert len(lines) == 31  # 28 rows + 2 rules + label line
    assert any("#" in ln for ln in lines)


def test_cifar_batch_roundtrip(tmp_path, rng):
    p = tmp_path / "data_batch_1.bin"
    synth.write_cifar_batch(str(p), rng, 50)
    labels, pixels = read_batch(str(p))
    assert labels.shape == (50,) and pixels.shape == (50, 3072)
    assert p.stat().st_size == 50 * 3073

    chw = pixels_to_chw(pixels)
    assert chw.shape == (50, 3, 32, 32)
    assert chw.min() >= -1.0 and chw.max() <= 1.0
    # scale inversion
    np.testing.assert_array_equal(chw_to_pixels(chw), pixels)

    batches = Cifar10Batches([str(p)])
    lab, imgs = batches.sample(rng, 8)
    assert imgs.shape == (8, 3, 32, 32)


def test_bmp_roundtrip(tmp_path, rng):
    h, w = 32, 30  # w*3 = 90 -> needs row padding to 92
    r = rng.integers(0, 256, (h, w)).astype(np.uint8)
    g = rng.integers(0, 256, (h, w)).astype(np.uint8)
    b = rng.integers(0, 256, (h, w)).astype(np.uint8)
    p = tmp_path / "img.bmp"
    write_bmp(str(p), r, g, b)
    raw = p.read_bytes()
    assert raw[:2] == b"BM"
    assert len(raw) == 54 + 92 * h
    r2, g2, b2 = read_bmp(str(p))
    np.testing.assert_array_equal(r2, r)
    np.testing.assert_array_equal(g2, g)
    np.testing.assert_array_equal(b2, b)


def test_prefetch_to_device(rng):
    data = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(5)]
    out = list(prefetch_to_device(iter(data), size=2))
    assert len(out) == 5
    for a, b in zip(out, data):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_ensure_synthetic_datasets(tmp_path):
    train, test = synth.ensure_mnist(str(tmp_path), train_n=64, test_n=16)
    ds = MnistDataset.from_csv(train)
    assert ds.num_examples == 64
    # idempotent
    train2, _ = synth.ensure_mnist(str(tmp_path), train_n=64, test_n=16)
    assert train2 == train

    paths = synth.ensure_cifar(str(tmp_path), n_batches=2, per_batch=20)
    assert len(paths) == 2
    labels, pixels = read_batch(paths[0])
    assert labels.shape == (20,)


def test_csv_malformed_tokens_strtof_semantics(tmp_path):
    """Native strtof and the Python fallback must agree on malformed input
    (ADVICE r1): non-numeric → 0.0, numeric prefix parsed, >63-char tokens
    truncated — the same file must load identically on both paths."""
    from big_linear_algebra.data import _native
    from big_linear_algebra.data.csv import _py_read_values

    long_tok = "1" * 70
    content = f"1.5,abc,2e3x,,-.5,nanq,1e,{long_tok},+inf,\n"
    p = tmp_path / "weird.csv"
    p.write_text(content)
    py = _py_read_values(str(p))
    # "1"*63 ≈ 1.1e62 overflows float32 → inf on both paths
    expect = np.asarray([1.5, 0.0, 2000.0, 0.0, -0.5, np.nan, 1.0,
                         np.inf, np.inf], np.float32)
    np.testing.assert_allclose(py, expect, rtol=1e-6, equal_nan=True)
    native = _native.csv_read(str(p))
    if native is not None:  # g++ available: both paths must agree exactly
        np.testing.assert_allclose(native, py, rtol=1e-6, equal_nan=True)
