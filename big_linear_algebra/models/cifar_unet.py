"""cifar_unet: DDPM noise-prediction U-Net on CIFAR-10 (≈ model/cifar_unet.c).

Architecture (model/cifar_unet.c:26-37,1099-1165, citing Ho et al. 2020):
4 resolutions (32/16/8/4) with embed dims 128/256/256/256; per resolution two
resnet blocks (GN→ReLU→conv3×3 → +time-dense → GN→ReLU→dropout(0.1)→conv3×3,
plus 1×1-conv residual when channels change); self-attention (key_dim 16)
after each resnet at resolution 2 on the down path, around the mid resnets,
and at resolution 2 on the up path; strided-conv downsample; nearest-
neighbour ×2 upsample + channel-matching conv (applied only when dims differ,
:1130-1133); skip concatenation from each down level (:1088-1097); output
GN→ReLU→conv3×3 → 3 channels.

The reference's ``train`` is a stub of intent (SURVEY.md §7.11): one example,
loss vs pure noise with no noise schedule, Adam moments allocated but unused,
uninitialized time embedding, empty ``run``. This module finishes the intent:
- full DDPM: linear β schedule, x_t = √ᾱ·x₀ + √(1−ᾱ)·ε, predict ε, MSE
- sinusoidal timestep embedding (dim 512) → ReLU (the reference's
  ``time_embedding`` comment says "Passed through ReLU already", :168)
- hand-rolled Adam (nn/optim.py — the allocated ``gm``/``gsm`` moments)
- epoch loop over the 5 binary batches, batched (B, 3, 32, 32)
- ``run``: DDPM ancestral sampling inside one jit (lax.fori_loop over
  timesteps) + BMP dumps
- CSV checkpoint tree bit-compatible with the reference layout
  (save_parameters, :1545-1660; with correct per-block channel counts — the
  reference's save passes in_channels=3 for down_1/resnet_2, truncating the
  file) plus pytree checkpoints (ckpt/pytree.py) for train state resume

Further intended-semantics deviations (documented per SURVEY.md §7 policy):
fixed up-path wiring (§7.2 second up_3 attention reads the right buffer),
gradients via the library's explicit-VJP ops instead of the §7.3/§7.4
clobbering backward, conv-kernel He init with fan_in = k²·C_in (the
reference uses k² alone, :1452-1460), textbook group norm (§7.5).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from pathlib import Path
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from big_linear_algebra.ckpt import pytree as ckpt_pytree
from big_linear_algebra.data import bmp as bmp_io
from big_linear_algebra.data import synth
from big_linear_algebra.data.cifar10 import Cifar10Batches, chw_to_pixels
from big_linear_algebra.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra.models import common
from big_linear_algebra.nn import (
    conv2d,
    conv2d_nhwc,
    dropout,
    group_norm,
    group_norm_nhwc,
    he_uniform,
    mse_loss,
    self_attention_block,
    self_attention_block_nhwc,
    xavier_uniform,
)
from big_linear_algebra.nn.optim import AdamState, adam_init, adam_update
from big_linear_algebra.ops.precision import matmul_precision as _matmul_precision
from big_linear_algebra.ops import relu
from big_linear_algebra.parallel import spmd


@dataclasses.dataclass(frozen=True)
class Config:
    image_size: int = 32                      # IMAGE_HEIGHT/WIDTH, :26-27
    in_channels: int = 3
    embed_dims: tuple = (128, 256, 256, 256)  # RESOLUTION_N_EMBED_DIM, :29-32
    time_embed_dim: int = 512                 # TIME_EMBED_DIM, :33
    kernel_size: int = 3                      # KERNEL_SIZE, :34
    group_size: int = 32                      # GROUP_SIZE, :35
    key_dim: int = 16                         # SELF_ATTENTION_KEY_DIM, :36
    dropout_rate: float = 0.1                 # DROPOUT_RATE, :37
    resize_stride: int = 2                    # RESIZE_STRIDE, :28
    # DDPM schedule (Ho et al. 2020 defaults — intent of the :16-24 citation)
    timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    batch_size: int = 16
    learn_rate: float = 2e-4
    seed: int = 42
    # mixed precision by default: f32 master params/optimizer, bf16
    # activations+weights inside the network (the tensor cores' native
    # input type); set "float32" for the full-precision parity mode. A
    # default chosen on another machine, to be re-decided by measurement on
    # the card (ROADMAP queue 1 item 5).
    compute_dtype: str = "bfloat16"
    # Stored-parameter dtype. "float32" (default): f32 master weights, cast
    # to compute_dtype at every use. "bfloat16": the stored tree IS bf16 —
    # the forward reads it directly with zero converts; full precision lives
    # only in the optimizer (f32 Adam moments + f32 update math, stochastic-
    # rounded bf16 write — nn/optim.py). CLI: --bf16-params.
    param_dtype: str = "float32"
    # Internal activation layout: "NCHW" keeps the reference's channels-first
    # maps end-to-end; "NHWC" transposes once at entry/exit and runs every
    # conv/GN/attention channels-last (attention tokenization and skip
    # concats become reshape-only). The external interface (x, checkpoints,
    # kernels) stays channels-first either way. Which one the card prefers
    # is open (ROADMAP queue 1 item 3).
    layout: str = "NCHW"
    # jax.checkpoint each resnet block: backward recomputes block
    # activations from the boundary — trades ~1/3 more FLOPs for the
    # activation memory of the whole block chain (bigger batches per card)
    remat: bool = False
    # PRNG impl for the model's root keys (dropout masks, DDPM draws,
    # sampling noise). "rbg" draws bits with XLA's RngBitGenerator instead
    # of threefry's shift/xor chains; whether that pays on the card is open
    # (ROADMAP queue 1 item 4). Key *derivation* (split/fold_in) stays
    # threefry-based under "rbg", so per-(step, block) key chains keep
    # their mixing guarantees. "threefry2x32" is the bit-stable-across-
    # compilers option (the reference's srand(42)+rand() has no bit
    # parity with either — SURVEY.md §8.2 RNG-parity note).
    prng: str = "rbg"
    # lax.scan unroll factor for the chunked/epoch training loops: each
    # scan iteration pays a fixed per-step slice cost on its xs/carry
    # traffic, and unrolling amortizes it across k steps without changing
    # the per-step op order (XLA's fusion of the unrolled body reassociates
    # float reductions at the ulp level — equivalence tested in f64).
    # CLI: --scan-unroll=N (1 = no unrolling).
    scan_unroll: int = 4


CONFIG = Config()
# Tiny config for CPU tests / fast smoke runs
TINY = Config(embed_dims=(8, 12, 12, 12), time_embed_dim=16, group_size=4,
              key_dim=4, timesteps=8, batch_size=2, image_size=32,
              compute_dtype="float32")  # full-precision for CPU parity tests

_PRNG_IMPLS = ("rbg", "unsafe_rbg", "threefry2x32")


def root_key(seed, cfg: Config = CONFIG) -> jax.Array:
    """Model root key under ``cfg.prng`` — the impl propagates through
    every split/fold_in, so this one choice switches all downstream
    dropout masks / DDPM draws to the configured generator."""
    if cfg.prng not in _PRNG_IMPLS:
        raise ValueError(f"cfg.prng must be one of {_PRNG_IMPLS}, "
                         f"got {cfg.prng!r}")
    return jax.random.key(int(seed), impl=cfg.prng)


def ckpt_dir() -> Path:
    return common.data_dir() / "cifar_unet"


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_resnet(key, in_ch, out_ch, cfg: Config):
    ks = jax.random.split(key, 4)
    k = cfg.kernel_size
    return {
        "conv_1": he_uniform(ks[0], (out_ch, in_ch, k, k),
                             fan_in=k * k * in_ch),
        "conv_2": he_uniform(ks[1], (out_ch, out_ch, k, k),
                             fan_in=k * k * out_ch),
        "conv_3": he_uniform(ks[2], (out_ch, in_ch, 1, 1), fan_in=in_ch),
        "time_w": he_uniform(ks[3], (cfg.time_embed_dim, out_ch),
                             fan_in=cfg.time_embed_dim),
        "time_b": jnp.zeros((out_ch,), jnp.float32),
    }


def _init_attn(key, ch, cfg: Config):
    ks = jax.random.split(key, 4)
    kd = cfg.key_dim
    return {
        "q": xavier_uniform(ks[0], (ch, kd), fan_in=ch, fan_out=kd),
        "k": xavier_uniform(ks[1], (ch, kd), fan_in=ch, fan_out=kd),
        "v": he_uniform(ks[2], (ch, kd), fan_in=ch),
        "w": he_uniform(ks[3], (kd, ch), fan_in=kd),
        "b": jnp.zeros((ch,), jnp.float32),
    }


def init_params(key, cfg: Config = CONFIG) -> Dict[str, Any]:
    d1, d2, d3, d4 = cfg.embed_dims
    k = cfg.kernel_size
    keys = iter(jax.random.split(key, 40))
    nk = lambda: next(keys)
    p: Dict[str, Any] = {
        "down_1": {
            "resnet_1": _init_resnet(nk(), cfg.in_channels, d1, cfg),
            "resnet_2": _init_resnet(nk(), d1, d1, cfg),
            "conv": he_uniform(nk(), (d2, d1, k, k), fan_in=k * k * d1),
        },
        "down_2": {
            "resnet_1": _init_resnet(nk(), d2, d2, cfg),
            "attn_1": _init_attn(nk(), d2, cfg),
            "resnet_2": _init_resnet(nk(), d2, d2, cfg),
            "attn_2": _init_attn(nk(), d2, cfg),
            "conv": he_uniform(nk(), (d3, d2, k, k), fan_in=k * k * d2),
        },
        "down_3": {
            "resnet_1": _init_resnet(nk(), d3, d3, cfg),
            "resnet_2": _init_resnet(nk(), d3, d3, cfg),
            "conv": he_uniform(nk(), (d4, d3, k, k), fan_in=k * k * d3),
        },
        "down_4": {
            "resnet_1": _init_resnet(nk(), d4, d4, cfg),
            "resnet_2": _init_resnet(nk(), d4, d4, cfg),
        },
        "mid": {
            "resnet_1": _init_resnet(nk(), d4, d4, cfg),
            "attn": _init_attn(nk(), d4, cfg),
            "resnet_2": _init_resnet(nk(), d4, d4, cfg),
        },
        "up_1": {
            "resnet_1": _init_resnet(nk(), 2 * d4, d4, cfg),
            "resnet_2": _init_resnet(nk(), d4, d4, cfg),
            "conv": he_uniform(nk(), (d3, d4, k, k), fan_in=k * k * d4),
        },
        "up_2": {
            "resnet_1": _init_resnet(nk(), 2 * d3, d3, cfg),
            "resnet_2": _init_resnet(nk(), d3, d3, cfg),
            "conv": he_uniform(nk(), (d2, d3, k, k), fan_in=k * k * d3),
        },
        "up_3": {
            "resnet_1": _init_resnet(nk(), 2 * d2, d2, cfg),
            "attn_1": _init_attn(nk(), d2, cfg),
            "resnet_2": _init_resnet(nk(), d2, d2, cfg),
            "attn_2": _init_attn(nk(), d2, cfg),
            "conv": he_uniform(nk(), (d1, d2, k, k), fan_in=k * k * d2),
        },
        "up_4": {
            "resnet_1": _init_resnet(nk(), 2 * d1, d1, cfg),
            "resnet_2": _init_resnet(nk(), d1, d1, cfg),
        },
        "output_conv": he_uniform(nk(), (cfg.in_channels, d1, k, k),
                                  fan_in=k * k * d1),
    }
    return cast_params(p, cfg)


def cast_params(params, cfg: Config):
    """Round a parameter tree to ``cfg.param_dtype`` (no-op for the f32
    default — every leaf above initializes f32)."""
    pdt = jnp.dtype(cfg.param_dtype)
    return jax.tree.map(lambda a: a.astype(pdt), params)


# ---------------------------------------------------------------------------
# Reference CSV checkpoint tree
# ---------------------------------------------------------------------------


def _kernels_to_rows(k: np.ndarray) -> np.ndarray:
    """(F, C, kh, kw) → (F·C, kh·kw) — the reference _save_conv_kernels
    layout (row i·C+j = kernel [f=i][c=j], model/cifar_unet.c:1520-1538)."""
    f, c, kh, kw = k.shape
    return np.asarray(k).reshape(f * c, kh * kw)


def _rows_to_kernels(rows: np.ndarray, f, c, kh, kw) -> np.ndarray:
    return rows.reshape(f, c, kh, kw)


def save_params_csv(params, cfg: Config = CONFIG, base: Path | None = None):
    base = base or ckpt_dir()
    # CSV text is written from f32 values (bf16 → f32 upcast is exact; the
    # %f text itself truncates at 6 decimals for both, reference parity)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)

    def save_resnet(p, prefix):
        write_csv_matrix(str(base / prefix / "conv_1.csv"),
                         _kernels_to_rows(np.asarray(p["conv_1"])))
        write_csv_matrix(str(base / prefix / "conv_2.csv"),
                         _kernels_to_rows(np.asarray(p["conv_2"])))
        write_csv_matrix(str(base / prefix / "conv_3.csv"),
                         _kernels_to_rows(np.asarray(p["conv_3"])))
        write_csv_matrix(str(base / prefix / "time_weight.csv"),
                         np.asarray(p["time_w"]))
        write_csv_matrix(str(base / prefix / "time_bias.csv"),
                         np.asarray(p["time_b"]).reshape(1, -1))

    def save_attn(p, prefix):
        names = {"q": "query.csv", "k": "key.csv", "v": "value.csv",
                 "w": "weight.csv"}
        for key_, fname in names.items():
            write_csv_matrix(str(base / prefix / fname), np.asarray(p[key_]))
        write_csv_matrix(str(base / prefix / "bias.csv"),
                         np.asarray(p["b"]).reshape(1, -1))

    for lvl in (1, 2, 3, 4):
        grp = params[f"down_{lvl}"]
        save_resnet(grp["resnet_1"], f"down_{lvl}/resnet_1")
        save_resnet(grp["resnet_2"], f"down_{lvl}/resnet_2")
        if "conv" in grp:
            write_csv_matrix(str(base / f"down_{lvl}/conv_0.csv"),
                             _kernels_to_rows(np.asarray(grp["conv"])))
        if lvl == 2:
            save_attn(grp["attn_1"], "down_2/self_attention_1")
            save_attn(grp["attn_2"], "down_2/self_attention_2")
    save_resnet(params["mid"]["resnet_1"], "mid/resnet_1")
    save_attn(params["mid"]["attn"], "mid/self_attention_0")
    save_resnet(params["mid"]["resnet_2"], "mid/resnet_2")
    for lvl in (1, 2, 3, 4):
        grp = params[f"up_{lvl}"]
        save_resnet(grp["resnet_1"], f"up_{lvl}/resnet_1")
        save_resnet(grp["resnet_2"], f"up_{lvl}/resnet_2")
        if "conv" in grp:
            write_csv_matrix(str(base / f"up_{lvl}/conv_0.csv"),
                             _kernels_to_rows(np.asarray(grp["conv"])))
        if lvl == 3:
            save_attn(grp["attn_1"], "up_3/self_attention_1")
            save_attn(grp["attn_2"], "up_3/self_attention_2")
    write_csv_matrix(str(base / "output_conv.csv"),
                     _kernels_to_rows(np.asarray(params["output_conv"])))


def load_params_csv(cfg: Config = CONFIG,
                    base: Path | None = None) -> Dict[str, Any]:
    base = base or ckpt_dir()
    d1, d2, d3, d4 = cfg.embed_dims
    k = cfg.kernel_size
    # exact=True: a CSV tree written by a different config (e.g. a full-
    # size checkpoint read under --tiny) must hard-error, not silently
    # load the file prefix as garbage weights that the exit save would
    # then write back over the original tree
    read_exact = functools.partial(read_csv_matrix, exact=True)

    def load_kernels(rel, f, c, kh, kw):
        rows = read_exact(str(base / rel), f * c, kh * kw)
        return jnp.asarray(_rows_to_kernels(rows, f, c, kh, kw))

    def load_resnet(prefix, in_ch, out_ch):
        return {
            "conv_1": load_kernels(f"{prefix}/conv_1.csv", out_ch, in_ch, k, k),
            "conv_2": load_kernels(f"{prefix}/conv_2.csv", out_ch, out_ch, k, k),
            "conv_3": load_kernels(f"{prefix}/conv_3.csv", out_ch, in_ch, 1, 1),
            "time_w": jnp.asarray(read_exact(
                str(base / prefix / "time_weight.csv"),
                cfg.time_embed_dim, out_ch)),
            "time_b": jnp.asarray(read_exact(
                str(base / prefix / "time_bias.csv"), 1, out_ch)[0]),
        }

    def load_attn(prefix, ch):
        kd = cfg.key_dim
        return {
            "q": jnp.asarray(read_exact(
                str(base / prefix / "query.csv"), ch, kd)),
            "k": jnp.asarray(read_exact(
                str(base / prefix / "key.csv"), ch, kd)),
            "v": jnp.asarray(read_exact(
                str(base / prefix / "value.csv"), ch, kd)),
            "w": jnp.asarray(read_exact(
                str(base / prefix / "weight.csv"), kd, ch)),
            "b": jnp.asarray(read_exact(
                str(base / prefix / "bias.csv"), 1, ch)[0]),
        }

    p = {
        "down_1": {"resnet_1": load_resnet("down_1/resnet_1",
                                           cfg.in_channels, d1),
                   "resnet_2": load_resnet("down_1/resnet_2", d1, d1),
                   "conv": load_kernels("down_1/conv_0.csv", d2, d1, k, k)},
        "down_2": {"resnet_1": load_resnet("down_2/resnet_1", d2, d2),
                   "attn_1": load_attn("down_2/self_attention_1", d2),
                   "resnet_2": load_resnet("down_2/resnet_2", d2, d2),
                   "attn_2": load_attn("down_2/self_attention_2", d2),
                   "conv": load_kernels("down_2/conv_0.csv", d3, d2, k, k)},
        "down_3": {"resnet_1": load_resnet("down_3/resnet_1", d3, d3),
                   "resnet_2": load_resnet("down_3/resnet_2", d3, d3),
                   "conv": load_kernels("down_3/conv_0.csv", d4, d3, k, k)},
        "down_4": {"resnet_1": load_resnet("down_4/resnet_1", d4, d4),
                   "resnet_2": load_resnet("down_4/resnet_2", d4, d4)},
        "mid": {"resnet_1": load_resnet("mid/resnet_1", d4, d4),
                "attn": load_attn("mid/self_attention_0", d4),
                "resnet_2": load_resnet("mid/resnet_2", d4, d4)},
        "up_1": {"resnet_1": load_resnet("up_1/resnet_1", 2 * d4, d4),
                 "resnet_2": load_resnet("up_1/resnet_2", d4, d4),
                 "conv": load_kernels("up_1/conv_0.csv", d3, d4, k, k)},
        "up_2": {"resnet_1": load_resnet("up_2/resnet_1", 2 * d3, d3),
                 "resnet_2": load_resnet("up_2/resnet_2", d3, d3),
                 "conv": load_kernels("up_2/conv_0.csv", d2, d3, k, k)},
        "up_3": {"resnet_1": load_resnet("up_3/resnet_1", 2 * d2, d2),
                 "attn_1": load_attn("up_3/self_attention_1", d2),
                 "resnet_2": load_resnet("up_3/resnet_2", d2, d2),
                 "attn_2": load_attn("up_3/self_attention_2", d2),
                 "conv": load_kernels("up_3/conv_0.csv", d1, d2, k, k)},
        "up_4": {"resnet_1": load_resnet("up_4/resnet_1", 2 * d1, d1),
                 "resnet_2": load_resnet("up_4/resnet_2", d1, d1)},
        "output_conv": load_kernels("output_conv.csv", cfg.in_channels,
                                    d1, k, k),
    }
    return cast_params(p, cfg)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def time_embedding(t: jax.Array, cfg: Config) -> jax.Array:
    """Sinusoidal timestep embedding (Ho et al. 2020 §B) → ReLU. The
    reference allocates but never fills ``d->time_embedding`` (:532-535,
    SURVEY.md §7.11); the comment at :168 records the ReLU intent.

    Internals run at ≥f32; the f64 parity mode computes in f64 — an f32
    sin/cos seed here perturbs the whole net by ~1e-7 and the GN chain
    amplifies that ~1e3×, which would swamp f64 parity tests."""
    half = cfg.time_embed_dim // 2
    dt = (jnp.float64 if jnp.dtype(cfg.compute_dtype) == jnp.float64
          else jnp.float32)
    freqs = jnp.exp(
        -jnp.log(10000.0) * jnp.arange(half, dtype=dt)
        / max(half - 1, 1)
    )
    ang = t.astype(dt)[:, None] * freqs[None, :]
    emb = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)
    return relu(emb)


def _gn_relu(x, cfg: Config, nhwc: bool = False):
    """The gn→relu pair every reference block opens with
    (model/cifar_unet.c:1046-1047), as composed XLA ops that XLA fuses."""
    gn = group_norm_nhwc if nhwc else group_norm
    return relu(gn(x, cfg.group_size))


def _resnet_block(x, temb, p, cfg: Config, key, train: bool,
                  nhwc: bool = False):
    """GN→ReLU→conv3×3 → +time → GN→ReLU→dropout→conv3×3 + residual
    (``_forward_resnet``, model/cifar_unet.c:1044-1072).

    With ``cfg.remat`` the block is wrapped in ``jax.checkpoint``: the
    backward recomputes the block's activations from its boundary instead of
    keeping them live — per-block activation memory drops from every
    intermediate (2 GN, 2 ReLU, dropout mask, 2 conv inputs) to just the
    boundary, trading ~⅓ more FLOPs for U-Net-depth × that saving."""
    if cfg.remat:
        fn = jax.checkpoint(functools.partial(
            _resnet_block_body, cfg=cfg, train=train, nhwc=nhwc))
        return fn(x, temb, p, key)
    return _resnet_block_body(x, temb, p, key, cfg=cfg, train=train,
                              nhwc=nhwc)


def _resnet_block_body(x, temb, p, key, *, cfg: Config, train: bool,
                       nhwc: bool):
    conv = conv2d_nhwc if nhwc else conv2d
    in_ch = x.shape[-1] if nhwc else x.shape[1]
    out_ch = p["conv_1"].shape[0]
    # (B, out) — explicit precision: f32 mode must not silently run in TF32
    # (same policy as ops/matmul.py / nn/conv.py)
    td = jnp.matmul(temb, p["time_w"],
                    precision=_matmul_precision(temb.dtype)) + p["time_b"]
    h = _gn_relu(x, cfg, nhwc)
    h = conv(h, p["conv_1"], 1)
    h = h + (td[:, None, None, :] if nhwc else td[:, :, None, None])
    h = _gn_relu(h, cfg, nhwc)
    h = dropout(h, cfg.dropout_rate, key, deterministic=not train)
    h = conv(h, p["conv_2"], 1)
    residual = x if in_ch == out_ch else conv(x, p["conv_3"], 1)
    return h + residual


def _upsample(x, stride, nhwc: bool = False):
    """Nearest-neighbour ×stride (``_nearest_neighbours``,
    model/cifar_unet.c:1074-1086)."""
    hw = (1, 2) if nhwc else (2, 3)
    return jnp.repeat(jnp.repeat(x, stride, axis=hw[0]), stride, axis=hw[1])


def _down_stage(params, x, temb, cfg: Config, keys, train: bool,
                nhwc: bool = False):
    """Down path (model/cifar_unet.c:1103-1118): returns the four skip
    activations (skip_4 is also the mid-stage input)."""
    conv = conv2d_nhwc if nhwc else conv2d
    attn = self_attention_block_nhwc if nhwc else self_attention_block
    s = cfg.resize_stride
    h = _resnet_block(x, temb, params["down_1"]["resnet_1"], cfg, keys[0],
                      train, nhwc)
    skip_1 = _resnet_block(h, temb, params["down_1"]["resnet_2"], cfg,
                           keys[1], train, nhwc)
    h = conv(skip_1, params["down_1"]["conv"], s)

    h = _resnet_block(h, temb, params["down_2"]["resnet_1"], cfg, keys[2],
                      train, nhwc)
    h = attn(h, params["down_2"]["attn_1"])
    h = _resnet_block(h, temb, params["down_2"]["resnet_2"], cfg, keys[3],
                      train, nhwc)
    skip_2 = attn(h, params["down_2"]["attn_2"])
    h = conv(skip_2, params["down_2"]["conv"], s)

    h = _resnet_block(h, temb, params["down_3"]["resnet_1"], cfg, keys[4],
                      train, nhwc)
    skip_3 = _resnet_block(h, temb, params["down_3"]["resnet_2"], cfg,
                           keys[5], train, nhwc)
    h = conv(skip_3, params["down_3"]["conv"], s)

    h = _resnet_block(h, temb, params["down_4"]["resnet_1"], cfg, keys[6],
                      train, nhwc)
    skip_4 = _resnet_block(h, temb, params["down_4"]["resnet_2"], cfg,
                           keys[7], train, nhwc)
    return skip_1, skip_2, skip_3, skip_4


def _mid_stage(params, skip_4, temb, cfg: Config, keys, train: bool,
               nhwc: bool = False):
    """Mid: resnet → attention → resnet (model/cifar_unet.c:1121-1123)."""
    attn = self_attention_block_nhwc if nhwc else self_attention_block
    h = _resnet_block(skip_4, temb, params["mid"]["resnet_1"], cfg, keys[0],
                      train, nhwc)
    h = attn(h, params["mid"]["attn"])
    return _resnet_block(h, temb, params["mid"]["resnet_2"], cfg, keys[1],
                         train, nhwc)


def _up_stage(params, h, skips, temb, cfg: Config, keys, train: bool,
              nhwc: bool = False):
    """Up path + output head (model/cifar_unet.c:1126-1165; skip concat along
    channels per :1088-1097, §7.2 up_3 wiring fixed)."""
    conv = conv2d_nhwc if nhwc else conv2d
    attn = self_attention_block_nhwc if nhwc else self_attention_block
    cat_ax = -1 if nhwc else 1
    skip_1, skip_2, skip_3, skip_4 = skips
    s = cfg.resize_stride
    d1, d2, d3, d4 = cfg.embed_dims

    h = jnp.concatenate([h, skip_4], axis=cat_ax)
    h = _resnet_block(h, temb, params["up_1"]["resnet_1"], cfg, keys[0],
                      train, nhwc)
    h = _resnet_block(h, temb, params["up_1"]["resnet_2"], cfg, keys[1],
                      train, nhwc)
    h = _upsample(h, s, nhwc)
    if d4 != d3:
        h = conv(h, params["up_1"]["conv"], 1)

    h = jnp.concatenate([h, skip_3], axis=cat_ax)
    h = _resnet_block(h, temb, params["up_2"]["resnet_1"], cfg, keys[2],
                      train, nhwc)
    h = _resnet_block(h, temb, params["up_2"]["resnet_2"], cfg, keys[3],
                      train, nhwc)
    h = _upsample(h, s, nhwc)
    if d3 != d2:
        h = conv(h, params["up_2"]["conv"], 1)

    h = jnp.concatenate([h, skip_2], axis=cat_ax)
    h = _resnet_block(h, temb, params["up_3"]["resnet_1"], cfg, keys[4],
                      train, nhwc)
    h = attn(h, params["up_3"]["attn_1"])
    h = _resnet_block(h, temb, params["up_3"]["resnet_2"], cfg, keys[5],
                      train, nhwc)
    h = attn(h, params["up_3"]["attn_2"])  # §7.2 fixed
    h = _upsample(h, s, nhwc)
    if d2 != d1:
        h = conv(h, params["up_3"]["conv"], 1)

    h = jnp.concatenate([h, skip_1], axis=cat_ax)
    h = _resnet_block(h, temb, params["up_4"]["resnet_1"], cfg, keys[6],
                      train, nhwc)
    h = _resnet_block(h, temb, params["up_4"]["resnet_2"], cfg, keys[7],
                      train, nhwc)

    # Output (:1163-1165)
    h = _gn_relu(h, cfg, nhwc)
    return conv(h, params["output_conv"], 1)


def forward(params, x, t, cfg: Config = CONFIG, key=None,
            train: bool = False) -> jax.Array:
    """Full U-Net forward (≈ ``forward``, model/cifar_unet.c:1099-1165, with
    the §7.2 up_3 wiring fixed). x: (B, 3, 32, 32) in [−1, 1]; t: (B,).

    Composed from the down/mid/up stage functions so the same code runs
    sequentially here and stage-split under ``gpipe_hetero`` (see
    ``unet_pipeline_stages``); key consumption order matches the previous
    single-body implementation (down keys 0-7, mid 8-9, up 10-17)."""
    if key is None:
        key = jax.random.key(0)
    dt = jnp.dtype(cfg.compute_dtype)
    if x.dtype != dt:
        x = x.astype(dt)
    # Cast params to the compute dtype (a traced no-op when they already
    # match — the bf16-resident param_dtype="bfloat16" mode, where the
    # stored tree needs zero converts). For f32 masters under bf16 compute
    # XLA may duplicate this convert per consumer; the at-source fix is
    # --bf16-params.
    params = jax.tree.map(lambda p: p.astype(dt), params)
    keys = jax.random.split(key, 24)
    temb = time_embedding(t, cfg).astype(dt)

    nhwc = cfg.layout == "NHWC"
    if nhwc:
        x = x.transpose(0, 2, 3, 1)
    skips = _down_stage(params, x, temb, cfg, keys[0:8], train, nhwc)
    h = _mid_stage(params, skips[3], temb, cfg, keys[8:10], train, nhwc)
    out = _up_stage(params, h, skips, temb, cfg, keys[10:18], train, nhwc)
    return out.transpose(0, 3, 1, 2) if nhwc else out


def split_params_stages(params):
    """Partition the parameter dict into the three pipeline stages'
    subtrees (down / mid / up+output head)."""
    down = {k: params[k] for k in ("down_1", "down_2", "down_3", "down_4")}
    mid = {"mid": params["mid"]}
    up = {k: params[k]
          for k in ("up_1", "up_2", "up_3", "up_4", "output_conv")}
    return [down, mid, up]


def unet_pipeline_stages(cfg: Config = CONFIG, train: bool = False):
    """The U-Net as three heterogeneous GPipe stages (SURVEY.md §2.4 PP row:
    "an optional shard_map-based stage splitter for the U-Net down/mid/up
    stages"; reference sequential layers model/cifar_unet.c:1099-1165).

    Returns ``stage_fns`` for ``parallel.pipeline.gpipe_hetero``: boundary 0
    is ``(x, t_float)``; skips and the time embedding travel through the
    pipeline as part of the boundary payload.

    ``train=False``: deterministic (inference) stages ``(p, boundary)`` —
    dropout off, as in the reference's forward. ``train=True``: stages take
    ``(p, boundary, key)`` and run dropout with per-stage block keys split
    from the per-(stage, microbatch) key ``gpipe_hetero(key=...)`` supplies;
    a sequential reference reproduces the masks by applying the same
    ``fold_in(key, stage·n_micro + micro)`` chain (see
    tests/test_pipeline.py). The stage boundary is external-layout (NCHW);
    ``cfg.layout="NHWC"`` transposes at pipeline entry/exit exactly like
    ``forward``."""
    dt = jnp.dtype(cfg.compute_dtype)
    nhwc = cfg.layout == "NHWC"
    dead = jax.random.key(0)  # inference mode: keys are never consumed

    def _keys(key, n):
        # loud mismatch errors: a silently-ignored key would run
        # deterministic when the caller believes dropout is on
        if train and not key:
            raise ValueError(
                "train=True pipeline stages need gpipe_hetero(..., key=...)")
        if not train and key:
            raise ValueError(
                "inference stages got a key; build unet_pipeline_stages("
                "cfg, train=True) for training-mode dropout")
        return jax.random.split(key[0], n) if train else [dead] * n

    def _cast(p):
        # mixed precision: master params (f32) meet dt activations — cast
        # like ``forward`` does (:550-552); no-op when dtypes already match
        return jax.tree.map(lambda a: a.astype(dt), p)

    def stage_down(p, boundary, *key):
        x, t = boundary
        keys = _keys(key, 8)
        temb = time_embedding(t, cfg).astype(dt)
        x = x.astype(dt)
        if nhwc:
            x = x.transpose(0, 2, 3, 1)
        skips = _down_stage(_cast(p), x, temb, cfg, keys, train, nhwc)
        return skips + (temb,)

    def stage_mid(p, boundary, *key):
        s1, s2, s3, s4, temb = boundary
        keys = _keys(key, 2)
        h = _mid_stage(_cast(p), s4, temb, cfg, keys, train, nhwc)
        return h, (s1, s2, s3, s4), temb

    def stage_up(p, boundary, *key):
        h, skips, temb = boundary
        keys = _keys(key, 8)
        out = _up_stage(_cast(p), h, skips, temb, cfg, keys, train, nhwc)
        return out.transpose(0, 3, 1, 2) if nhwc else out

    return [stage_down, stage_mid, stage_up]


# ---------------------------------------------------------------------------
# DDPM schedule / loss / train step
# ---------------------------------------------------------------------------


def ddpm_schedule(cfg: Config):
    betas = jnp.linspace(cfg.beta_start, cfg.beta_end, cfg.timesteps,
                         dtype=jnp.float32)
    alphas = 1.0 - betas
    alpha_bars = jnp.cumprod(alphas)
    return betas, alphas, alpha_bars


def loss_fn(params, x0, key, cfg: Config = CONFIG):
    """DDPM simple loss: ‖ε − ε̂(√ᾱ_t·x₀ + √(1−ᾱ_t)·ε, t)‖² (mean)."""
    xt, t, noise, kd = _ddpm_draws(x0, key, cfg)
    pred = forward(params, xt, t, cfg, key=kd, train=True)
    # mse_loss (nn/losses.py) carries the reference's 2(pred−target) seed;
    # normalize to a mean like compute_mse_loss (model/cifar_unet.c:1858).
    # Master loss/seed in ≥f32 under bf16 compute (mixed precision); f64
    # inputs keep f64 (truncating would inject f32 noise into parity tests).
    acc_dt = jnp.promote_types(jnp.float32, x0.dtype)
    return mse_loss(pred.astype(acc_dt), noise.astype(acc_dt)) / np.prod(
        x0.shape)


def _sr_key(key, cfg: Config):
    """Per-step stochastic-rounding key for bf16-resident params (None for
    the f32 default — round-to-nearest bf16 writes put a measured loss
    floor under training, 0.078 vs 0.058 at 16 synthetic epochs; see
    nn/optim.stochastic_round_bf16). Folded with a fixed constant so the
    SR stream decorrelates from the DDPM/dropout draws of the same step
    key. Under DP this MUST be derived from the pre-fold (replicated) key,
    or replicas would round differently and the replicated params drift."""
    if jnp.dtype(cfg.param_dtype) != jnp.bfloat16:
        return None
    return jax.random.fold_in(key, 0x5feed)


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnums=(0, 1))
def train_step(params, opt_state: AdamState, x0, key,
               cfg: Config = CONFIG):
    loss, grads = jax.value_and_grad(loss_fn)(params, x0, key, cfg)
    params, opt_state = adam_update(params, grads, opt_state, cfg.learn_rate,
                                    sr_key=_sr_key(key, cfg))
    return params, opt_state, loss


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnums=(0, 1))
def train_chunk(params, opt_state: AdamState, xs, keys,
                cfg: Config = CONFIG):
    """K train steps as one jitted lax.scan (one dispatch per chunk).
    xs: (K, B, 3, H, W); keys: (K,) PRNG keys. Numerically identical to K
    sequential ``train_step`` calls."""

    def body(carry, inp):
        p, o = carry
        x0, k = inp
        loss, grads = jax.value_and_grad(loss_fn)(p, x0, k, cfg)
        p, o = adam_update(p, grads, o, cfg.learn_rate,
                           sr_key=_sr_key(k, cfg))
        return (p, o), loss

    (params, opt_state), losses = jax.lax.scan(
        body, (params, opt_state), (xs, keys), unroll=cfg.scan_unroll)
    return params, opt_state, losses


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnums=(0, 1))
def epoch_step(params, opt_state: AdamState, data, perm, key,
               cfg: Config = CONFIG):
    """A whole epoch as one dispatch over a device-resident dataset.

    ``data``: (N, 3, H, W) — transferred to HBM once, reused every epoch.
    ``perm``: (n_batches·B,) int32 permutation for this epoch; each batch is
    gathered on device *inside* the scan body (one B-row gather per step),
    so the host sends only the tiny index array per epoch and no permuted
    full-dataset copy is ever materialized — peak temp HBM is ~dataset +
    one batch instead of 2× dataset. Returns (params, opt_state, losses).
    """
    b = cfg.batch_size
    n_batches = perm.shape[0] // b
    idx = perm[: n_batches * b].reshape(n_batches, b)

    def body(carry, batch_idx):
        p, o, k = carry
        k, ks = jax.random.split(k)
        x0 = data[batch_idx]
        loss, grads = jax.value_and_grad(loss_fn)(p, x0, ks, cfg)
        p, o = adam_update(p, grads, o, cfg.learn_rate,
                           sr_key=_sr_key(ks, cfg))
        return (p, o, k), loss

    (params, opt_state, _), losses = jax.lax.scan(
        body, (params, opt_state, key), idx, unroll=cfg.scan_unroll)
    return params, opt_state, losses


# ---------------------------------------------------------------------------
# SPMD (shard_map) training. Written per-shard so the Pallas kernel inside
# the forward (flash attention) runs on each device's local batch block, with an
# explicit pmean gradient all-reduce (SURVEY.md §2.4 DP row).
# ---------------------------------------------------------------------------


def _local_grad_step(params, opt_state, x0, key, cfg, axis):
    """Per-shard body shared by the DP step/epoch: per-shard DDPM noise draw
    (key folded by mesh position), local grads, pmean all-reduce (loss_fn is
    a local mean), replicated Adam update. The stochastic-rounding key comes
    from the PRE-fold key — every shard must round the replicated params
    identically or the replicas drift apart."""
    sr = _sr_key(key, cfg)
    key = jax.random.fold_in(key, jax.lax.axis_index(axis))
    loss, grads = jax.value_and_grad(loss_fn)(params, x0, key, cfg)
    grads = spmd.pmean_tree(grads, axis)
    loss = jax.lax.pmean(loss, axis)
    params, opt_state = adam_update(params, grads, opt_state, cfg.learn_rate,
                                    sr_key=sr)
    return params, opt_state, loss


def make_train_step_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP train step over ``mesh``: x0 batch-sharded, params/opt replicated.
    Statistically identical to ``train_step`` at the same global batch (each
    shard draws its own timesteps/noise — RNG trajectories differ, as they
    must; SURVEY.md §8.2)."""
    from jax.sharding import PartitionSpec as P

    def local_step(params, opt_state, x0, key):
        return _local_grad_step(params, opt_state, x0, key, cfg, axis)

    fn = spmd.shard_map_fn(local_step, mesh,
                           in_specs=(P(), P(), P(axis), P()),
                           out_specs=(P(), P(), P()))
    return jax.jit(fn, donate_argnums=(0, 1))


def make_epoch_step_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP variant of ``epoch_step``: dataset replicated per device (CIFAR is
    120 MB — one HBM transfer), per-step batch slices gathered locally by
    mesh position, grads pmean'd inside one lax.scan dispatch per epoch."""
    from jax.sharding import PartitionSpec as P

    ndev = mesh.shape[axis]
    if cfg.batch_size % ndev:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by {ndev} devices")
    b_local = cfg.batch_size // ndev

    def local_epoch(params, opt_state, data, perm, key):
        r = jax.lax.axis_index(axis)
        n_batches = perm.shape[0] // cfg.batch_size
        idx = perm[: n_batches * cfg.batch_size].reshape(
            n_batches, ndev, b_local)

        def body(carry, batch_idx_all):
            p, o, k = carry
            k, ks = jax.random.split(k)
            x0 = data[batch_idx_all[r]]
            p, o, loss = _local_grad_step(p, o, x0, ks, cfg, axis)
            return (p, o, k), loss

        (params, opt_state, _), losses = jax.lax.scan(
            body, (params, opt_state, key), idx, unroll=cfg.scan_unroll)
        return params, opt_state, losses

    fn = spmd.shard_map_fn(local_epoch, mesh,
                           in_specs=(P(), P(), P(), P(), P()),
                           out_specs=(P(), P(), P()))
    return jax.jit(fn, donate_argnums=(0, 1))


def tp_param_specs(params, n_shards: int, model_axis: str = "model"):
    """Tensor-parallel PartitionSpecs for the U-Net conv GEMMs (SURVEY.md
    §2.4 TP row; reference GEMMs lib/conv.c:210, model/cifar_unet.c:1003-1021):
    conv kernels ``(O, I, kh, kw)`` shard the output-channel dim, the
    time-embedding dense ``(T, O)``/``(O,)`` shards its output dim —
    activations then carry a channel shard and GSPMD inserts the halo/
    reduce collectives. Attention projections replicate (key_dim 16 is
    too narrow to split into useful GEMMs), as does any leaf whose output dim is not divisible (e.g. the 3-channel
    output head)."""
    from jax.sharding import PartitionSpec as P

    def spec(path, leaf):
        name = getattr(path[-1], "key", None)
        if name in ("q", "k", "v", "w", "b"):
            return P()
        if leaf.ndim == 4 and leaf.shape[0] % n_shards == 0:
            return P(model_axis, None, None, None)
        if name == "time_w" and leaf.shape[1] % n_shards == 0:
            return P(None, model_axis)
        if name == "time_b" and leaf.shape[0] % n_shards == 0:
            return P(model_axis)
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


def place_tp(mesh, params, opt_state: AdamState | None = None,
             model_axis: str = "model"):
    """Lay params (and optionally Adam moments, which shard identically)
    out tensor-parallel on ``mesh``. The regular jitted ``train_step``/
    ``forward`` then run TP automatically: jit honors argument shardings
    and GSPMD partitions the conv GEMMs, inserting the activation
    collectives.

    Note on when TP pays (reasoning, not yet measured): at the reference
    widths (embed dims ≤256) the convs are small and DP's single gradient
    all-reduce per step should beat TP's per-layer activation collectives;
    TP is the memory-side lever for
    scaled-up widths (params + Adam moments split P ways). Combine both on
    a 2D ``data×model`` mesh."""
    from jax.sharding import NamedSharding

    specs = tp_param_specs(params, mesh.shape[model_axis], model_axis)
    place = lambda t: jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), t, specs)
    params = place(params)
    if opt_state is None:
        return params
    opt_state = AdamState(step=opt_state.step, m=place(opt_state.m),
                          v=place(opt_state.v))
    return params, opt_state


def _ddpm_draws(x0, key, cfg: Config):
    """The DDPM corruption draws shared by ``loss_fn`` and the PP step:
    split(key, 3) → (t, noise, dropout key), x_t = √ᾱ·x₀ + √(1−ᾱ)·ε.
    Identical key-split chain to ``loss_fn`` so the two paths corrupt the
    batch identically given the same key (only the dropout fold differs)."""
    _, _, alpha_bars = ddpm_schedule(cfg)
    kt, kn, kd = jax.random.split(key, 3)
    b = x0.shape[0]
    t = jax.random.randint(kt, (b,), 0, cfg.timesteps)
    noise = jax.random.normal(kn, x0.shape, x0.dtype)
    ab = alpha_bars[t][:, None, None, None]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * noise
    return xt, t, noise, kd


def make_train_step_pp(mesh, cfg: Config = CONFIG, axis: str = "stage",
                       n_micro: int = 4, data_axis: str | None = None,
                       schedule: str = "gpipe"):
    """Pipeline-parallel train step (SURVEY.md §2.4 PP row; the reference's
    sequential forward+backward+update loop, model/cifar_unet.c:1099-1165,
    1874-1934, stage-split over the ``axis`` mesh dimension).

    The U-Net's down/mid/up stages each live on one device of ``axis``
    (``gpipe_hetero``); the batch is split into ``n_micro`` microbatches
    that stream through the pipeline, so all three stages compute
    concurrently after the 2-tick fill. Gradient accumulation across
    microbatches is the autodiff transpose of the microbatch-mean loss (the
    ppermute ring carries each stage's gradients home); Adam then updates
    once per global batch. The DDPM draws reuse ``loss_fn``'s exact
    key-split chain; dropout uses gpipe_hetero's per-(stage, microbatch)
    ``fold_in(kd, s·n_micro + m)`` keys — reproducible by a sequential run
    of the same chain (parity-tested in f64, tests/test_pipeline.py).

    ``data_axis`` (PP×DP, VERDICT r3 #3): on a 2-D ``stage×data`` mesh the
    ``n_micro`` global microbatches are sharded over the data axis — each
    data coordinate pipelines its share through its own stage ring, and the
    shard_map transpose all-reduces the param grads over the data axis
    (params are data-replicated). Same math as the 1-D pipeline at the
    same global batch (global-microbatch dropout folds).

    ``schedule``: "gpipe" (all-forward-then-all-backward by autodiff of the
    tick loop) or "1f1b" (hand-scheduled one-forward-one-backward,
    ``gpipe_hetero_1f1b`` — same math, analytic MSE loss seed at the last
    stage, lower peak liveness and fewer slot traversals; VERDICT r3 #6)."""
    from big_linear_algebra.parallel.pipeline import (gpipe_hetero,
                                                          gpipe_hetero_1f1b)

    fns = unet_pipeline_stages(cfg, train=True)
    if data_axis is not None and n_micro % mesh.shape[data_axis]:
        raise ValueError(
            f"n_micro={n_micro} not divisible by data axis "
            f"{data_axis!r} of size {mesh.shape[data_axis]}")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule must be gpipe or 1f1b, got {schedule!r}")

    def step(params, opt_state: AdamState, x0, key):
        b = x0.shape[0]
        if b % n_micro:
            raise ValueError(
                f"batch {b} not divisible by n_micro={n_micro}")
        xt, t, noise, kd = _ddpm_draws(x0, key, cfg)
        mb = b // n_micro
        xs = xt.reshape(n_micro, mb, *x0.shape[1:])
        ts = t.reshape(n_micro, mb).astype(x0.dtype)
        acc_dt = jnp.promote_types(jnp.float32, x0.dtype)
        n_total = np.prod(x0.shape)

        if schedule == "1f1b":
            noise_m = noise.reshape(n_micro, mb, *x0.shape[1:])
            tw = int(np.prod((mb,) + x0.shape[1:]))

            def seed_fn(pred_flat, tg_flat):
                # the analytic dL/dpred for one microbatch: mse_loss's
                # 2(pred − target) seed over the GLOBAL-batch normalizer,
                # same master dtype as loss_fn
                d = (pred_flat[:tw].astype(acc_dt)
                     - tg_flat[:tw].astype(acc_dt))
                return jnp.sum(d * d) / n_total, 2.0 * d / n_total

            loss, stage_grads = gpipe_hetero_1f1b(
                fns, split_params_stages(params), (xs, ts), noise_m,
                seed_fn, mesh, axis, key=kd, data_axis=data_axis)
            grads = {}
            for g_tree in stage_grads:  # disjoint stage subtrees
                grads.update(g_tree)
            loss = loss.astype(acc_dt)
        else:
            def loss_of(p):
                sp = split_params_stages(p)
                pred = gpipe_hetero(fns, sp, (xs, ts), mesh, axis, key=kd,
                                    data_axis=data_axis)
                # same master-loss dtype + normalization as loss_fn
                pred = pred.reshape(b, *x0.shape[1:]).astype(acc_dt)
                return mse_loss(pred, noise.astype(acc_dt)) / n_total

            loss, grads = jax.value_and_grad(loss_of)(params)
        params2, opt2 = adam_update(params, grads, opt_state, cfg.learn_rate,
                                    sr_key=_sr_key(key, cfg))
        return params2, opt2, loss

    return jax.jit(step, donate_argnums=(0, 1))


def place_dp_tp(mesh, params, opt_state: AdamState | None = None,
                model_axis: str = "model"):
    """Combined DP×TP layout on a 2-D ``data×model`` mesh (the combination
    ``place_tp``'s note promises; reference all-in-one-address-space loop
    model/cifar_unet.c:1874). Params and Adam moments shard their output
    channels over ``model_axis`` (``tp_param_specs``) and replicate over
    every other mesh axis; the caller shards each batch over the data
    axis (``dp_tp_batch_sharding``). The regular jitted ``train_step`` then runs
    DP×TP via GSPMD — batch-partitioned conv GEMMs with channel-sharded
    kernels, gradient reduce over the data axis inserted by XLA. Unlike the
    shard_map DP path, the RNG draw stays global, so the step is numerically
    the SAME math as the single-device ``train_step`` (f64 parity-tested)."""
    return place_tp(mesh, params, opt_state, model_axis=model_axis)


def dp_tp_batch_sharding(mesh, data_axis: str = "data"):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(data_axis))


@functools.partial(jax.jit, static_argnames=("cfg", "num_samples"))
def sample(params, key, cfg: Config = CONFIG, num_samples: int = 1):
    """DDPM ancestral sampling (Ho et al. alg. 2) as one jitted
    lax.fori_loop — finishing the reference's empty ``run`` (:1936-1938)."""
    betas, alphas, alpha_bars = ddpm_schedule(cfg)
    shape = (num_samples, cfg.in_channels, cfg.image_size, cfg.image_size)
    key, k0 = jax.random.split(key)
    x_init = jax.random.normal(k0, shape, jnp.float32)

    def body(i, carry):
        x, key = carry
        t = cfg.timesteps - 1 - i
        key, kz = jax.random.split(key)
        tb = jnp.full((num_samples,), t, jnp.int32)
        eps = forward(params, x, tb, cfg, train=False).astype(jnp.float32)
        beta = betas[t]
        alpha = alphas[t]
        ab = alpha_bars[t]
        mean = (x - beta / jnp.sqrt(1.0 - ab) * eps) / jnp.sqrt(alpha)
        z = jax.random.normal(kz, shape, jnp.float32)
        x = jnp.where(t > 0, mean + jnp.sqrt(beta) * z, mean)
        return x, key

    x, _ = jax.lax.fori_loop(0, cfg.timesteps, body, (x_init, key))
    return jnp.clip(x, -1.0, 1.0)


# ---------------------------------------------------------------------------
# CLI verbs
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "timesteps"))
def denoise_psnr(params, x0, key, cfg: Config = CONFIG,
                 timesteps: tuple = None):
    """Quantified sample quality (the DDPM intent of
    model/cifar_unet.c:1936-1938, replacing the eyeball check): noise
    held-out images to x_t, one-shot reconstruct
    x̂₀ = (x_t − √(1−ᾱ_t)·ε̂)/√ᾱ_t from the model's noise prediction, and
    return PSNR(x̂₀, x₀) in dB per timestep (peak-to-peak 2.0 for [−1,1]
    pixels). A model that has learned nothing scores at/below the
    noisy-input PSNR; training raises it — a pass/fail training-regression
    gate (tests/test_cifar_unet.py)."""
    if timesteps is None:
        # schedule quartiles — valid for ANY cfg.timesteps (a fixed
        # (1, 250, 500, 750) default would silently index-clamp on
        # reduced schedules like TINY's 8 while feeding the raw t to the
        # model: inconsistent (x_t, t) pairs, garbage PSNRs)
        T = cfg.timesteps
        timesteps = tuple(sorted({1, T // 4, T // 2, (3 * T) // 4}))
    bad = [t for t in timesteps if not 0 <= t < cfg.timesteps]
    if bad:
        raise ValueError(f"timesteps {bad} outside [0, {cfg.timesteps})")
    _, _, alpha_bars = ddpm_schedule(cfg)
    noise = jax.random.normal(key, x0.shape, x0.dtype)

    def psnr_at(t):
        ab = alpha_bars[t]
        xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * noise
        tb = jnp.full((x0.shape[0],), t, jnp.int32)
        eps = forward(params, xt, tb, cfg, train=False).astype(jnp.float32)
        x0_hat = (xt.astype(jnp.float32)
                  - jnp.sqrt(1.0 - ab) * eps) / jnp.sqrt(ab)
        mse = jnp.mean((x0_hat - x0.astype(jnp.float32)) ** 2)
        return 10.0 * jnp.log10(4.0 / jnp.maximum(mse, 1e-12))

    return jnp.stack([psnr_at(t) for t in timesteps])


_PRNG_CODES = {"threefry2x32": 0, "rbg": 1, "unsafe_rbg": 2}
_PRNG_NAMES = {v: k for k, v in _PRNG_CODES.items()}


def _key_state(key) -> dict:
    """Checkpoint fields for an RNG key: the raw ``key_data`` plus an
    explicit impl code — rbg and unsafe_rbg share a key_data width, so
    width alone cannot name the stream a checkpoint carries."""
    impl = str(jax.random.key_impl(key))
    if impl not in _PRNG_CODES:
        # checkpointing a mislabeled code would only surface much later, at
        # resume inside wrap_key_data (or worse: silently resume the wrong
        # stream family) — fail here, at the cause (ADVICE r3)
        raise ValueError(
            f"cannot checkpoint RNG keys of impl {impl!r}; known impls: "
            f"{sorted(_PRNG_CODES)}")
    return {"key_data": jax.random.key_data(key),
            "prng": np.asarray(_PRNG_CODES[impl], np.int32)}


def _restore_train_target(state_dir: str, target: dict, step: int):
    """Restore a ``train_state`` checkpoint, first at the target's RNG key
    width and then at the other key-impl family's (threefry 2 words, rbg
    family 4), so a stream restores across a --prng switch."""
    width = target["key_data"].shape[-1]
    alt_impl = "threefry2x32" if width == 4 else "rbg"
    alt_kd = jax.random.key_data(jax.random.key(0, impl=alt_impl))
    try:
        return ckpt_pytree.restore_pytree(state_dir, target, step=step)
    except ValueError:
        return ckpt_pytree.restore_pytree(
            state_dir, dict(target, key_data=alt_kd), step=step)


def _wrap_restored_key(key_data, cfg: Config, prng_code=None) -> jax.Array:
    """Rehydrate a restored RNG key. The impl comes from the checkpoint's
    explicit ``prng`` code when present; older checkpoints fall back to
    width inference (threefry 2 uint32 words, rbg family 4 — a width-4
    legacy checkpoint is assumed rbg/cfg-impl, since rbg and unsafe_rbg
    are indistinguishable by width). A checkpoint written under a
    different impl than ``cfg.prng`` keeps its own stream — the resumed
    run continues the original draws exactly (at the original impl's
    speed) rather than silently restarting the stream."""
    kd = jnp.asarray(key_data)
    impl = _PRNG_NAMES.get(int(prng_code)) if prng_code is not None else None
    if prng_code is not None and impl is None:
        # corrupted / future-valued code: fall through to the width
        # inference this function already implements instead of a bare
        # KeyError far from the cause (ADVICE r3)
        print(f"checkpoint carries unknown prng code {int(prng_code)}; "
              f"inferring the impl from the key width instead")
    if impl is None:
        if kd.shape[-1] == 2:
            impl = "threefry2x32"
        else:
            impl = cfg.prng if cfg.prng in ("rbg", "unsafe_rbg") else "rbg"
    if impl != cfg.prng:
        print(f"resuming the checkpoint's RNG stream with its original "
              f"impl {impl} (config requests {cfg.prng})")
    return jax.random.wrap_key_data(kd, impl=impl)


def _params_for_run(cfg: Config):
    """Parameters for sampling: the freshest of the CSV tree (written at
    normal train exit, models/cifar_unet save_parameters parity) and the
    ``train_state`` (written asynchronously every epoch). A run killed
    mid-train leaves only the train_state — the reference contract is that
    training progress is never lost (model/mnist_nn.c:165-170), so ``run``
    must be able to sample from it (VERDICT r2 missing #4)."""
    state_dir = ckpt_dir() / "train_state"
    step = ckpt_pytree.latest_step(str(state_dir))
    csv_file = ckpt_dir() / "output_conv.csv"
    use_state = False
    if step is not None:
        if not csv_file.is_file():
            use_state = True
        else:
            step_dir = state_dir / f"step_{step}"
            state_mtime = max(
                (p.stat().st_mtime for p in step_dir.rglob("*")),
                default=step_dir.stat().st_mtime)
            use_state = state_mtime > csv_file.stat().st_mtime
    if not use_state:
        return load_params_csv(cfg)
    # init draws stay threefry: bit-stable across compiler versions and
    # backends, and a one-time cost (the rbg speed win is per-step masks)
    params = init_params(jax.random.key(cfg.seed), cfg)
    target = {"params": params, "opt": adam_init(params),
              **_key_state(root_key(cfg.seed, cfg)),
              "epoch": np.zeros((), np.int32)}
    restored = _restore_train_target(str(state_dir), target, step)
    print(f"sampling from train_state step {step}"
          + ("" if csv_file.is_file() else " (no CSV tree)"))
    return restored["params"]


def _cfg_from_flags(flags) -> Config:
    cfg = TINY if "tiny" in (flags or {}) else CONFIG
    flags = flags or {}
    if "batch" in flags:
        cfg = dataclasses.replace(
            cfg, batch_size=common.positive_int_flag(flags, "batch"))
    if "layout" in flags:
        layout = str(flags["layout"]).upper()
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(
                f"--layout must be NCHW or NHWC, got {flags['layout']!r}")
        cfg = dataclasses.replace(cfg, layout=layout)
    if common.presence_flag(flags, "remat"):
        cfg = dataclasses.replace(cfg, remat=True)
    if "image-size" in flags:
        size = common.positive_int_flag(flags, "image-size")
        if size % 32:
            # the model itself needs a multiple of 8 (three stride-2
            # stages); the CLI data path also nearest-upscales the fixed
            # 32x32 CIFAR records (lib/cifar10.c), so require x32
            raise ValueError(
                f"--image-size must be a multiple of 32, got {size}")
        cfg = dataclasses.replace(cfg, image_size=size)
    if "prng" in flags:
        impl = {"threefry": "threefry2x32"}.get(
            str(flags["prng"]), str(flags["prng"]))
        if impl not in _PRNG_IMPLS:
            raise ValueError(
                f"--prng must be one of threefry, rbg, unsafe_rbg; "
                f"got {flags['prng']!r}")
        cfg = dataclasses.replace(cfg, prng=impl)
    if common.presence_flag(flags, "bf16-params"):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if "scan-unroll" in flags:
        cfg = dataclasses.replace(
            cfg, scan_unroll=common.positive_int_flag(flags, "scan-unroll"))
    return cfg


def init(flags=None) -> None:
    cfg = _cfg_from_flags(flags)
    # threefry init: bit-stable across compiler versions/backends; the rbg
    # perf win is entirely in per-step mask bits, not this one-time draw
    params = init_params(jax.random.key(cfg.seed), cfg)
    save_params_csv(params, cfg)
    print(f"initialized parameters in {ckpt_dir()}")


def _fit_images(x, cfg: Config):
    """Nearest-neighbor upscale of stored 32x32 CIFAR records to
    ``cfg.image_size``. The on-disk record format is fixed by the
    reference (3073-byte rows, lib/cifar10.c:6-13); params are
    resolution-independent (fully convolutional, attention over
    whatever H·W produces), so ``--image-size=64`` runs the same model
    at higher resolution — where the down_2/up_3 attention sites cross
    the flash-kernel dispatch threshold (nn/attention.py)."""
    k = cfg.image_size // x.shape[-1]
    if k == 1:
        return x
    return jnp.repeat(jnp.repeat(x, k, -2), k, -1)


def train(num_epochs: int, *args, flags=None) -> None:
    flags = flags or {}
    cfg = _cfg_from_flags(flags)
    batch_paths = synth.ensure_cifar(str(common.data_dir()))
    data = Cifar10Batches(batch_paths)
    if data.num_examples < cfg.batch_size:
        # zero full batches: every epoch path would "complete" with no
        # steps and log avg_loss=nan (np.mean of an empty list), poisoning
        # --keep-best metric ordering — fail loudly instead
        raise SystemExit(
            f"batch size {cfg.batch_size} exceeds the dataset "
            f"({data.num_examples} examples): no full batch to train on")
    state_dir = str(ckpt_dir() / "train_state")
    step0 = ckpt_pytree.latest_step(state_dir)
    if step0 is None and (ckpt_dir() / "output_conv.csv").is_file():
        params = load_params_csv(cfg)
    elif step0 is None:
        print("no checkpoint found; initializing")
        params = init_params(jax.random.key(cfg.seed), cfg)  # threefry:
        # bit-stable init; the rbg win is per-step masks, not this draw
    else:
        # a train_state exists — restore() below supplies params; skip the
        # multi-megabyte CSV tree parse it would immediately overwrite
        params = init_params(jax.random.key(cfg.seed), cfg)
    opt_state = adam_init(params)
    key = root_key(cfg.seed, cfg)
    epoch0 = 0
    # Async checkpointer: per-epoch saves overlap training, keep-last-k
    # retention (--keep=k, 0 = unbounded), optional best-k by loss
    # (--keep-best). SURVEY.md §5 failure-recovery row.
    # --keep=0 = unbounded retention; bare/negative values hard-error
    keep = common.int_flag(flags, "keep", default=3, minimum=0) or None
    manager = ckpt_pytree.TrainCheckpointer(
        state_dir, max_to_keep=keep,
        best_metric="loss" if "keep-best" in flags else None)
    target = {"params": params, "opt": opt_state,
              **_key_state(key),
              "epoch": np.zeros((), np.int32)}
    if step0 is not None:
        # restore casts to this run's dtypes, so a checkpoint written under
        # the other param_dtype (f32 ↔ bf16-resident, --bf16-params) resumes
        # into the requested one
        restored = _restore_train_target(state_dir, target, step0)
        params, opt_state = restored["params"], restored["opt"]
        # resume the RNG stream where it left off — replaying the first
        # run's permutations/noise draws would correlate the updates
        key = _wrap_restored_key(restored["key_data"], cfg,
                                 restored["prng"])
        epoch0 = int(restored["epoch"])
        print(f"resumed train state at step {int(opt_state.step)}"
              f" (epoch {epoch0})")
    logger = common.MetricsLogger(flags.get("jsonl") or None)
    rng = np.random.default_rng([cfg.seed, epoch0])
    dp_mesh = None
    if "dp" in flags and "pp" not in flags:
        from big_linear_algebra.parallel import default_mesh

        mesh = default_mesh()
        if mesh.devices.size > 1:
            if cfg.batch_size % mesh.devices.size:
                raise SystemExit(
                    f"--dp: batch size {cfg.batch_size} is not divisible "
                    f"by {mesh.devices.size} devices")
            dp_mesh = mesh
        else:
            print("--dp: single device, running unsharded")
    if "tp" in flags:
        # Tensor parallel: conv kernels channel-sharded over all local
        # devices; the jitted steps below run TP via GSPMD (jit honors
        # argument shardings). Mutually exclusive with --dp here — the DP
        # path is an explicit shard_map with replicated-param in_specs.
        if dp_mesh is not None:
            raise SystemExit("--tp cannot be combined with --dp on this CLI "
                             "(use the DP×TP API on a 2-D data×model mesh)")
        from big_linear_algebra.parallel import make_mesh

        n_local = len(jax.local_devices())
        if n_local > 1:
            tp_mesh = make_mesh({"model": n_local})
            params, opt_state = place_tp(tp_mesh, params, opt_state)
            print(f"--tp: conv kernels channel-sharded over {n_local} "
                  f"devices")
        else:
            print("--tp: single device, running unsharded")
    pp_step = None
    if "pp" in flags:
        # Pipeline parallel: down/mid/up stages on a 3-device stage axis,
        # microbatched gpipe_hetero train step (make_train_step_pp).
        # --pp --dp composes a 2-D stage×data mesh (VERDICT r3 #3).
        if "tp" in flags:
            raise SystemExit("--pp cannot be combined with --tp on this "
                             "CLI (use --pp --dp for the 2-D composition)")
        from big_linear_algebra.parallel import make_mesh

        n_micro = (common.positive_int_flag(flags, "pp-micro")
                   if "pp-micro" in flags else 4)
        if cfg.batch_size % n_micro:
            raise SystemExit(
                f"--pp: batch size {cfg.batch_size} is not divisible by "
                f"--pp-micro={n_micro} microbatches")
        schedule = str(flags.get("pp-schedule") or "gpipe")
        if schedule not in ("gpipe", "1f1b"):
            raise SystemExit(
                f"--pp-schedule must be gpipe or 1f1b, got {schedule!r}")
        n_local = len(jax.local_devices())
        if "dp" in flags and n_local >= 6:
            # PP×DP: stage axis 3 (down/mid/up), the rest data-parallel
            n_data = n_local // 3
            if n_micro % n_data:
                raise SystemExit(
                    f"--pp --dp: --pp-micro={n_micro} microbatches are not "
                    f"divisible by the {n_data} data shards (3 stages × "
                    f"{n_data} data on {n_local} devices)")
            pp_mesh = make_mesh({"stage": 3, "data": n_data},
                                devices=jax.devices()[:3 * n_data])
            pp_step = make_train_step_pp(pp_mesh, cfg, n_micro=n_micro,
                                         data_axis="data",
                                         schedule=schedule)
            print(f"--pp --dp: 3-stage pipeline × {n_data} data shards, "
                  f"{n_micro} global microbatches, {schedule} schedule")
        elif "dp" in flags:
            print(f"--pp --dp needs >= 6 devices (3 stages × >=2 data "
                  f"shards), have {n_local}; running pure --pp")
        if pp_step is None and n_local >= 3:
            pp_mesh = make_mesh({"stage": 3}, devices=jax.devices()[:3])
            pp_step = make_train_step_pp(pp_mesh, cfg, n_micro=n_micro,
                                         schedule=schedule)
            print(f"--pp: 3-stage pipeline (down/mid/up), "
                  f"{n_micro} microbatches, {schedule} schedule")
        elif pp_step is None:
            print("--pp: fewer than 3 devices, running unsharded")
        if pp_step is not None:
            # Replicate the train state onto the pipeline mesh: a resumed
            # checkpoint arrives committed to the default device, and jit
            # rejects single-device-committed args against the pipeline's
            # in-jit mesh placement ("incompatible devices") — fresh-init
            # numpy trees were only uncommitted by luck.
            from jax.sharding import NamedSharding, PartitionSpec

            rep = NamedSharding(pp_mesh, PartitionSpec())
            params = jax.device_put(params, rep)
            opt_state = jax.device_put(opt_state, rep)
            # the RNG key too: a checkpoint-restored key is committed to
            # the default device, and jax.random.split propagates that
            # commitment to every per-step key (fresh root_key outputs are
            # uncommitted, which is why only RESUMED --pp runs tripped the
            # "incompatible devices" error)
            key = jax.device_put(key, rep)
    # absent = whole epoch; --max-steps must be >= 1 when given (a bare
    # flag silently meaning "no limit" would invert the intent)
    max_steps = common.int_flag(flags, "max-steps", default=0, minimum=1)
    scan_steps = common.int_flag(flags, "scan-steps", default=1,
                                 minimum=1)  # steps per dispatch
    # Default full-epoch mode: ship the dataset to HBM once and run each
    # epoch as a single device dispatch (host sends only a permutation).
    # epoch_step gathers one batch per scan step (no permuted dataset copy),
    # so peak temp HBM ≈ dataset + activations; 2 GiB keeps the same
    # headroom the old 1 GiB cutoff had when the gather doubled the dataset
    data_bytes = data.num_examples * 3 * cfg.image_size ** 2 * 4
    device_epoch = (max_steps == 0 and scan_steps == 1
                    and "host-loop" not in flags
                    and pp_step is None  # PP trains via the per-step path
                    and data_bytes < (2 << 30))
    if device_epoch:
        from big_linear_algebra.data.cifar10 import pixels_to_chw

        data_dev = _fit_images(jnp.asarray(pixels_to_chw(data.pixels)), cfg)
        epoch_dp = (make_epoch_step_dp(dp_mesh, cfg)
                    if dp_mesh is not None else None)
        for epoch in range(epoch0, epoch0 + num_epochs):
            t0 = time.perf_counter()
            key, kep = jax.random.split(key)
            perm = jnp.asarray(
                rng.permutation(data.num_examples).astype(np.int32))
            if epoch_dp is not None:
                params, opt_state, losses = epoch_dp(
                    params, opt_state, data_dev, perm, kep)
            else:
                params, opt_state, losses = epoch_step(
                    params, opt_state, data_dev, perm, kep, cfg)
            losses = np.asarray(losses)
            dt = time.perf_counter() - t0
            n = losses.size * cfg.batch_size
            logger.log(epoch=epoch, avg_loss=float(losses.mean()),
                       epoch_seconds=dt, images_per_sec=n / dt,
                       step=int(opt_state.step))
            # async: serialization overlaps the next epoch's compute
            manager.save(int(opt_state.step),
                         {"params": params, "opt": opt_state,
                          **_key_state(key),
                          "epoch": np.asarray(epoch + 1, np.int32)},
                         metrics={"loss": float(losses.mean())})
        save_params_csv(params, cfg)
        manager.wait()
        manager.close()
        logger.close()
        return
    step_dp = make_train_step_dp(dp_mesh, cfg) if dp_mesh is not None else None
    if dp_mesh is not None and scan_steps > 1:
        # the chunked scan path runs the unsharded train_chunk — silently
        # dropping DP would record wrong throughput (common.py flag policy)
        raise SystemExit("--scan-steps>1 is not supported with --dp; use "
                         "the default device-resident DP epoch mode")
    if pp_step is not None and scan_steps > 1:
        raise SystemExit("--scan-steps>1 is not supported with --pp (the "
                         "chunked scan path runs the unsharded train_chunk)")
    for epoch in range(epoch0, epoch0 + num_epochs):
        t0 = time.perf_counter()
        losses = []
        chunk = []
        batches = (imgs for _, imgs in data.epoch_batches(rng,
                                                          cfg.batch_size))
        if scan_steps == 1:
            # per-step dispatch: keep 2 batches already in HBM so the
            # host→device copy hides behind the previous step's compute
            # (the scan path stacks on host and must stay numpy); under
            # --dp, place each batch directly in its P("data") sharding so
            # no reshard hop runs per step
            from big_linear_algebra.data import prefetch_to_device
            sharding = None
            if dp_mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                sharding = NamedSharding(dp_mesh,
                                         PartitionSpec("data"))
            elif pp_step is not None:
                # place batches replicated on the PIPELINE mesh: a batch
                # committed to the default device conflicts with the
                # pipeline-mesh train state ("incompatible devices")
                from jax.sharding import NamedSharding, PartitionSpec
                sharding = NamedSharding(pp_mesh, PartitionSpec())
            batches = prefetch_to_device(batches, size=2, sharding=sharding)
        for step_i, imgs in enumerate(batches):
            if max_steps and step_i >= max_steps:
                break
            if scan_steps > 1:
                chunk.append(imgs)
                if len(chunk) == scan_steps:
                    key, *ks = jax.random.split(key, scan_steps + 1)
                    params, opt_state, chunk_losses = train_chunk(
                        params, opt_state,
                        _fit_images(jnp.asarray(np.stack(chunk)), cfg),
                        jnp.stack(ks), cfg)
                    losses.extend(list(chunk_losses))
                    chunk = []
            else:
                key, kstep = jax.random.split(key)
                x0 = _fit_images(jnp.asarray(imgs), cfg)
                if step_dp is not None:
                    params, opt_state, loss = step_dp(
                        params, opt_state, x0, kstep)
                elif pp_step is not None:
                    params, opt_state, loss = pp_step(
                        params, opt_state, x0, kstep)
                else:
                    params, opt_state, loss = train_step(
                        params, opt_state, x0, kstep, cfg)
                losses.append(loss)
        for imgs in chunk:  # ragged tail: per-step path
            key, kstep = jax.random.split(key)
            params, opt_state, loss = train_step(
                params, opt_state, _fit_images(jnp.asarray(imgs), cfg),
                kstep, cfg)
            losses.append(loss)
        losses = [float(l) for l in losses]
        dt = time.perf_counter() - t0
        n = len(losses) * cfg.batch_size
        logger.log(epoch=epoch, avg_loss=float(np.mean(losses)),
                   epoch_seconds=dt, images_per_sec=n / dt,
                   step=int(opt_state.step))
        manager.save(int(opt_state.step),
                     {"params": params, "opt": opt_state,
                      **_key_state(key),
                      "epoch": np.asarray(epoch + 1, np.int32)},
                     metrics={"loss": float(np.mean(losses))})
    save_params_csv(params, cfg)
    manager.wait()
    manager.close()
    logger.close()


def run(num_predictions: int = 1, flags=None) -> None:
    """Sample images and write BMPs (the reference's intended ``run``)."""
    flags = flags or {}
    cfg = _cfg_from_flags(flags)
    # -1 = reference "whole set" convention → one sample here; any other
    # non-positive count would become a negative array shape
    n = 1 if num_predictions < 1 else num_predictions
    params = _params_for_run(cfg)
    seed = common.int_flag(flags, "sample-seed", default=0,
                           minimum=-(2 ** 62))
    imgs = sample(params, root_key(seed, cfg),
                  cfg, n)
    out_dir = ckpt_dir() / "samples"
    for i in range(n):
        pix = chw_to_pixels(np.asarray(imgs[i])).reshape(
            3, cfg.image_size, cfg.image_size)
        # flip rows: BMP renders bottom-up (lib/cifar10.c:19-30)
        path = out_dir / f"sample_{i}.bmp"
        bmp_io.write_bmp(str(path), pix[0][::-1], pix[1][::-1], pix[2][::-1])
        print(f"wrote {path}")


def main(argv=None) -> int:
    return common.run_cli(
        "cifar_unet", init, train, run, argv=argv,
        train_usage="train <num epochs>",
        run_usage="run [<num samples> (default 1)]",
        extra_flags=("dp", "tp", "pp", "pp-micro", "tiny", "max-steps",
                     "scan-steps", "host-loop", "sample-seed", "keep",
                     "keep-best", "batch", "layout", "remat", "prng",
                     "image-size", "bf16-params",
                     "pp-schedule", "scan-unroll"),
    )


if __name__ == "__main__":
    raise SystemExit(main())
