"""Data IO: reference-format CSV, MNIST, CIFAR-10, BMP, prefetch, synthesis.

≈ reference ``lib/{csv,mnist_csv,mnist_csv2,cifar10,bmp}.c``; host-side fast
paths are native C++ (native/bla_io.cc) with pure-Python fallbacks.
"""

from big_linear_algebra.data.csv import (  # noqa: F401
    count_num_lines,
    read_csv_matrix,
    read_csv_values,
    write_csv_matrix,
)
from big_linear_algebra.data.mnist import (  # noqa: F401
    MnistCSVStream,
    MnistDataset,
    visualize_digit,
)
from big_linear_algebra.data.cifar10 import (  # noqa: F401
    Cifar10Batches,
    chw_to_pixels,
    pixels_to_chw,
    read_batch,
)
from big_linear_algebra.data.bmp import read_bmp, write_bmp  # noqa: F401
from big_linear_algebra.data.prefetch import prefetch_to_device  # noqa: F401
from big_linear_algebra.data import synth  # noqa: F401
