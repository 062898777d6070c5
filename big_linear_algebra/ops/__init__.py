"""Dense matrix core: matmuls with hand-written VJPs + the full reference
matrix-op surface.

Covers the public interface of the reference's ``lib/matrix.h:7-32`` and
``lib/util.h:7-11`` as dtype-polymorphic functional ops over ``jax.Array``s.
"""

from big_linear_algebra.ops.matmul import (  # noqa: F401
    matmul,
    matmul_nt,
    matmul_tn,
)
from big_linear_algebra.ops.matrix import (  # noqa: F401
    matrix_add,
    matrix_add_tile_columns,
    matrix_add_tile_rows,
    matrix_col_sum,
    matrix_multiply_elementwise,
    matrix_row_sum,
    matrix_scale,
    matrix_transpose,
    frobenius_norm,
    max_value,
    matrix_z_score_normalize,
    print_matrix,
)
from big_linear_algebra.ops.activations import (  # noqa: F401
    relu,
    softmax,
    softmax_row_wise,
)
