"""What a measurement ran on: JAX's device description and, on NVIDIA
cards, the name and power limit nvidia-smi reports (a card set below its
maximum power runs slower under load, so every reading carries both)."""

from __future__ import annotations

import subprocess


def card_info() -> list[str]:
    """`name, power.limit` per card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


def describe() -> dict:
    """Fields every benchmark row carries."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card_info()[0] if d.platform == "gpu" else None,
    }
