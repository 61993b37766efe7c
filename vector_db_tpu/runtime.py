"""Runtime/session configuration helpers."""

from __future__ import annotations

import os
from pathlib import Path

import jax

_CACHE_ENABLED = False
_DEVICES = ("gpu", "cpu")
# fixed default cache path: the path is part of the cache key, so a
# directory that moves between runs never hits
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def apply_device(device: str) -> None:
    """Pin the JAX platform from the config ``device`` key.

    ``gpu`` pins the CUDA platform and raises when no GPU is visible;
    ``cpu`` pins the CPU. Any other value raises. Nothing falls back
    silently: a GPU deployment that lands on the CPU is a failure, not a
    slow success. Must run before the first JAX computation.
    """
    device = (device or "").lower()
    if device not in _DEVICES:
        raise ValueError(
            f"unknown device {device!r}; choose one of {_DEVICES}")
    jax.config.update("jax_platforms", "cuda" if device == "gpu" else "cpu")
    try:
        devices = jax.devices()
    except Exception as e:  # no plugin for the platform fails variously
        raise RuntimeError(
            f"device: {device} requested but unavailable: {e!r}") from e
    if devices[0].platform != device:
        raise RuntimeError(
            f"device: {device} requested but JAX runs on "
            f"{devices[0].platform}")


def device_pull(x):
    """Fetch a device array to host as a numpy array in one
    ``jax.device_get`` transfer. Host-resident inputs (numpy arrays,
    lists) pass through unchanged."""
    import numpy as np

    if isinstance(x, jax.Array):
        return np.asarray(jax.device_get(x))
    return np.asarray(x)


def enable_compilation_cache() -> str:
    """Enable the persistent XLA compilation cache; returns its directory.

    Graph kernels (bulk edge construction, beam search per ef config)
    compile once per shape, so every entry point (bench, API server,
    graft entry) turns this on. Where ``JAX_COMPILATION_CACHE_DIR`` is set
    JAX already reads it and nothing is set here; otherwise the cache goes
    to the fixed ``<repo>/.jax_cache``.
    """
    global _CACHE_ENABLED
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if not _CACHE_ENABLED:
        DEFAULT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _CACHE_ENABLED = True
    return str(DEFAULT_CACHE_DIR)
