"""The legacy ``Layer``-graph MLP (≈ lib/layer.c) as a functional module.

The reference builds a linked list of ``Layer`` structs and backprops
recursively with in-place SGD applied *after* the recursion, so upstream
gradients see pre-update weights (lib/layer.c:48-78: the recursive call at
:70 precedes the ``matrix_add`` updates at :72-73). Functionally that is
exactly standard backprop-then-update on the whole stack, which is what
``sgd_step`` computes — one jit-compilable fused step.

Math, per the reference derivation (lib/layer.c:80-106):
- forward: ``raw = W @ a_prev + b``; ``a = act(raw)`` (:6-20, keeping the
  pre-activation ``raw_nodes``)
- seed: ``dC/da_L = 2·(a_L − y)`` (:86-88) — squared-error loss
- per layer: ``δ = act'(raw) ⊙ dC/da``; ``ΔW = δ @ a_prevᵀ``; ``Δb = δ``
  (:90-97); ``dC/da_prev = Wᵀ @ δ`` (:53-58)
- update: ``W −= lr·ΔW``, ``b −= lr·Δb`` (the reference folds −lr into δ)

Parameters are a list of ``(weights, biases)`` pairs with weights in the
reference's (out, in) orientation (so CSV layouts load without reshaping);
activation names are a static tuple (one per layer), mirroring the
reference's function-pointer pairs (lib/layer.h:11-12).

``softmax_legacy`` implements the *intent* of model/mnist.c:27-46 — a true
softmax forward (the reference forgot the ``exp`` in the numerator,
SURVEY.md §7.7) with the deliberate diagonal-only Jacobian ``p·(1−p)``
backward (the independence approximation is written out intentionally in
softmax_ddx).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from big_linear_algebra.ops.precision import matmul_precision as _matmul_precision

Params = List[Tuple[jax.Array, jax.Array]]  # [(W (out,in), b (out,)), ...]


class Activation(NamedTuple):
    fn: callable
    # ddx receives (raw, activated) and returns act'(raw)
    ddx: callable


def _softmax_fn(raw):
    e = jnp.exp(raw - jax.lax.stop_gradient(jnp.max(raw)))
    return e / jnp.sum(e)


ACTIVATIONS: Dict[str, Activation] = {
    "relu": Activation(lambda r: jnp.maximum(r, 0),
                       lambda r, a: (r > 0).astype(r.dtype)),
    "linear": Activation(lambda r: r, lambda r, a: jnp.ones_like(r)),
    # main.c:7-17's toy 0.1x activation
    "scale_0.1": Activation(lambda r: 0.1 * r,
                            lambda r, a: jnp.full_like(r, 0.1)),
    "softmax_legacy": Activation(_softmax_fn, lambda r, a: a * (1 - a)),
}


def feed_forward(params: Params, activations: Sequence[str], x: jax.Array):
    """Forward a single example (in,) through the stack.
    Returns (acts, raws): acts[0] is x, acts[i+1] the i-th layer output."""
    acts, raws = [x], []
    a = x
    for (w, b), name in zip(params, activations):
        # explicit precision: a bare @ may run these f32 matvecs in TF32
        # on the GPU (repo policy, ops/precision.py)
        raw = jnp.matmul(w, a, precision=_matmul_precision(w.dtype)) + b
        a = ACTIVATIONS[name].fn(raw)
        raws.append(raw)
        acts.append(a)
    return acts, raws


def predict(params: Params, activations: Sequence[str],
            x: jax.Array) -> jax.Array:
    return feed_forward(params, activations, x)[0][-1]


def predict_batch(params: Params, activations: Sequence[str],
                  xb: jax.Array) -> jax.Array:
    """vmapped batched forward for evaluation: (B, in) → (B, out)."""
    return jax.vmap(lambda x: predict(params, activations, x))(xb)


def cost(params: Params, activations: Sequence[str], x: jax.Array,
         y: jax.Array) -> jax.Array:
    """Squared-error cost Σ(y − a)² (model/my_first_model.c:102-105)."""
    out = predict(params, activations, x)
    return jnp.sum((y - out) ** 2)


def _sgd_step_cost(params: Params, activations: Sequence[str],
                   x: jax.Array, y: jax.Array, lr):
    """One reference backprop + SGD update (lib/layer.c:80), returning
    (new_params, pre-update cost) from the SAME forward pass — the scan
    driver logs the cost the reference computes from the pass it then
    backprops (model/my_first_model.c:102-105), without a second forward."""
    acts, raws = feed_forward(params, activations, x)
    c = jnp.sum((y - acts[-1]) ** 2)
    dCda = 2.0 * (acts[-1] - y)
    new_params: Params = [None] * len(params)
    for i in reversed(range(len(params))):
        w, b = params[i]
        delta = ACTIVATIONS[activations[i]].ddx(raws[i], acts[i + 1]) * dCda
        dW = jnp.outer(delta, acts[i])
        # pre-update weights (lib/layer.c:70); explicit matmul precision
        dCda = jnp.matmul(w.T, delta, precision=_matmul_precision(w.dtype))
        new_params[i] = (w - lr * dW, b - lr * delta)
    return new_params, c


def sgd_step(params: Params, activations: Sequence[str], x: jax.Array,
             y: jax.Array, lr) -> Params:
    """One reference backprop + SGD update (lib/layer.c:80)."""
    return _sgd_step_cost(params, activations, x, y, lr)[0]


def make_sgd_step(activations: Sequence[str]):
    """jit-compiled fused step for a fixed activation stack:
    ``step(params, x, y, lr) -> new_params``."""
    acts = tuple(activations)

    @jax.jit
    def step(params, x, y, lr):
        return sgd_step(params, acts, x, y, lr)

    return step


def make_sgd_scan(activations: Sequence[str], unroll: int = 2):
    """Many per-example SGD steps in one dispatch:
    ``run(params, xs (T, in), ys (T, out), lr) -> (params, costs (T,))``.

    Semantically identical to T sequential ``sgd_step`` calls (online SGD in
    example order); each cost is the pre-update squared error, matching the
    reference's logging (model/my_first_model.c:102-105 computes the cost
    from the forward pass it then backprops).

    ``unroll``: scan codegen knob — a per-example step is tiny, so the
    scan's fixed per-iteration slice cost is a measurable fraction;
    unrolling amortizes it without changing the per-step op order (the same
    lever as ``cifar_unet.Config.scan_unroll``). The default of 2 was chosen
    on another machine and is to be re-measured on the card (ROADMAP queue 1
    item 5)."""
    acts = tuple(activations)

    @jax.jit
    def run(params, xs, ys, lr):
        def body(p, xy):
            x, y = xy
            new_p, c = _sgd_step_cost(p, acts, x, y, lr)
            return new_p, c

        return jax.lax.scan(body, params, (xs, ys), unroll=unroll)

    return run
