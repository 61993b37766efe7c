"""Device selection utilities — the jax analog of the reference's torch
device picker (src/vector_db/inference/device.py:17-106: auto -> cuda ->
mps -> cpu). Here the accelerator hierarchy is auto -> gpu -> cpu, resolved
through jax.
"""

from __future__ import annotations

from typing import Any, Dict

import jax


def get_device(preference: str = "auto") -> str:
    """Resolve a device string. preference: 'auto' | 'gpu' | 'cpu'
    (case-insensitive, as the reference accepts 'CPU' in config.yaml:3).
    'auto' names the platform JAX computes on; 'gpu' raises when JAX sees
    no GPU, as ``runtime.apply_device`` does; anything else raises."""
    pref = (preference or "auto").lower()
    if pref == "cpu":
        return "cpu"
    if pref == "auto":
        return jax.default_backend()
    if pref == "gpu":
        if not any(d.platform == "gpu" for d in jax.devices()):
            raise RuntimeError("device 'gpu' requested but JAX sees no GPU")
        return "gpu"
    raise ValueError(f"unknown device {preference!r}; use auto, gpu or cpu")


def is_accelerator_available() -> bool:
    """True when jax sees a non-CPU device (reference is_gpu_available,
    device.py:59-72)."""
    return any(d.platform != "cpu" for d in jax.devices())


def get_device_info() -> Dict[str, Any]:
    """Summary of visible devices (reference get_device_info,
    device.py:75-106)."""
    devices = jax.devices()
    return {
        "selected": get_device("auto"),
        "accelerator_available": is_accelerator_available(),
        "device_count": len(devices),
        "platforms": sorted({d.platform for d in devices}),
        "devices": [str(d) for d in devices],
        "backend": jax.default_backend(),
    }
