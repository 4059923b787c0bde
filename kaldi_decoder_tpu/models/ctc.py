"""Minimal CTC acoustic encoder for end-to-end demos and tests.

The reference has **no** model layer — its acoustic model lives in
icefall/torch behind ``DecodableInterface`` (SURVEY §1, L6).  This module
exists so the framework is usable standalone end-to-end on the device:
features → log-softmax posteriors → decoder, all in one jitted program.
It is a deliberately small conv + MLP-mixer-style encoder (dense matmuls,
bf16-ready), not a competitive ASR model.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class CtcEncoderConfig:
    num_features: int = 80
    hidden_dim: int = 256
    num_layers: int = 4
    vocab_size: int = 500
    subsampling: int = 4  # conformer-style 4x time reduction
    context: int = 3  # conv kernel width per subsample stage


def init_params(cfg: CtcEncoderConfig, key) -> dict:
    keys = jax.random.split(key, 3 + 2 * cfg.num_layers)
    params = {
        "in_proj": jax.random.normal(
            keys[0], (cfg.num_features * cfg.subsampling, cfg.hidden_dim)
        )
        / np.sqrt(cfg.num_features * cfg.subsampling),
        "out_proj": jax.random.normal(keys[1], (cfg.hidden_dim, cfg.vocab_size))
        / np.sqrt(cfg.hidden_dim),
        "out_bias": jnp.zeros((cfg.vocab_size,)),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        k1, k2 = keys[3 + 2 * i], keys[4 + 2 * i]
        params["layers"].append(
            {
                "w1": jax.random.normal(k1, (cfg.hidden_dim, 4 * cfg.hidden_dim))
                / np.sqrt(cfg.hidden_dim),
                "w2": jax.random.normal(k2, (4 * cfg.hidden_dim, cfg.hidden_dim))
                / np.sqrt(4 * cfg.hidden_dim),
                "scale": jnp.ones((cfg.hidden_dim,)),
            }
        )
    return params


def forward(
    params: dict, feats: jnp.ndarray, cfg: CtcEncoderConfig
) -> jnp.ndarray:
    """(B, T, F) features -> (B, T // subsampling, V) log-softmax posteriors.

    Compute is dominated by large matmuls; normalization and GELU fuse
    around them under XLA.
    """
    B, T, F = feats.shape
    Ts = T // cfg.subsampling
    # Subsample by stacking frames (equivalent compute shape to conv
    # subsampling; keeps everything a matmul).
    x = feats[:, : Ts * cfg.subsampling].reshape(B, Ts, F * cfg.subsampling)
    x = x @ params["in_proj"]
    for layer in params["layers"]:
        # RMSNorm -> MLP -> residual.
        h = x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + 1e-6)
        h = h * layer["scale"]
        h = jax.nn.gelu(h @ layer["w1"]) @ layer["w2"]
        x = x + h
    logits = x @ params["out_proj"] + params["out_bias"]
    return jax.nn.log_softmax(logits, axis=-1)


def make_forward_fn(cfg: CtcEncoderConfig):
    return jax.jit(lambda params, feats: forward(params, feats, cfg))
