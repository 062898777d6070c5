"""big-linear-algebra: a dense linear-algebra + NN training library in JAX.

A from-scratch (JAX / XLA / Pallas / shard_map) framework providing the
full capability set of the C99 reference `damians13/big-linear-algebra`:

- ``ops``      — dense matrix core (matmul, transposed-matmul
                 variants, elementwise ops, reductions, softmax/relu) with
                 hand-written VJPs (≈ reference ``lib/matrix.c`` + ``lib/util.c``).
- ``nn``       — dense / conv / group-norm / attention / dropout layers, losses,
                 and initializers, each with an explicit ``jax.custom_vjp``
                 mirroring the reference's hand-derived backward passes
                 (≈ ``lib/layer.c``, ``lib/conv.c``, ``lib/norm.c``).
- ``data``     — reference-format CSV, MNIST (streaming and in-RAM samplers),
                 CIFAR-10 binary batches, BMP writer, and device-prefetching
                 batch iterators (≈ ``lib/{csv,mnist_csv,mnist_csv2,cifar10,bmp}.c``).
- ``ckpt``     — pytree checkpoints plus CSV layouts bit-compatible with the
                 reference's per-model checkpoint formats.
- ``parallel`` — mesh construction, DP/TP/FSDP shardings, and collective
                 helpers (XLA collectives only, which use NCCL on the GPU).
- ``models``   — the five model programs (``my_first_model``, ``mnist``,
                 ``mnist_hinge``, ``mnist_nn``, ``cifar_unet``) with
                 ``init | train | run`` CLIs (≈ reference ``model/*.c``).

Design stance (see SURVEY.md §8): hand-written backward passes are a
first-class feature — autodiff is used only as a test oracle. Hot compute is
XLA (cuBLAS/cuDNN on the GPU) plus one Pallas kernel where it measured faster
(flash attention, through Triton); orchestration, configs, CLIs and IO are
Python; performance-critical host-side IO (CSV parsing, binary loaders, BMP)
has a native C++ fast path with a pure-Python fallback.
"""

__version__ = "0.1.0"

from big_linear_algebra import ops  # noqa: F401
