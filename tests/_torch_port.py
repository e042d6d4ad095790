"""Shared by the tests/test_torch_*.py files: carry JAX params into the port."""

import dataclasses

import jax
import numpy as np

from rwkv_tpu_torch.models.convert import params_from_numpy


def to_port(jax_params, device="cpu"):
    """The port's params from a JAX RWKVParams, through the numpy tree that
    dataclasses.asdict gives (u8 families come out re-centered to int8)."""
    return params_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, jax_params)), device)
