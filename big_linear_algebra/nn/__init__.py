"""NN layers, losses, initializers — each with an explicit hand-written VJP
(≈ reference lib/layer.c, lib/conv.c, lib/norm.c and the models' in-line
backward derivations)."""

from big_linear_algebra.nn.dense import dense  # noqa: F401
from big_linear_algebra.nn.losses import (  # noqa: F401
    cross_entropy_loss,
    hinge_loss,
    mse_loss,
    softmax_cross_entropy,
)
from big_linear_algebra.nn.init import (  # noqa: F401
    he_uniform,
    uniform_init,
    xavier_uniform,
)
from big_linear_algebra.nn.conv import (  # noqa: F401
    conv2d,
    conv2d_nhwc,
    conv2d_single,
)
from big_linear_algebra.nn.norm import (  # noqa: F401
    group_norm,
    group_norm_nhwc,
)
from big_linear_algebra.nn.dropout import dropout  # noqa: F401
from big_linear_algebra.nn.attention import (  # noqa: F401
    attention,
    attention_dense,
    flash_attention,
    self_attention_block,
    self_attention_block_nhwc,
)
from big_linear_algebra.nn import optim  # noqa: F401
