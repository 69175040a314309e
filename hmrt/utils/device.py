"""What a measurement records about the device it ran on."""

from __future__ import annotations

import os
import subprocess

import jax


def card_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    None where there is no nvidia-smi. A card set below its top power
    limit runs slower under load, so every timing keeps this beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_record() -> dict:
    """Platform, kind and count of JAX's devices, the card's name and
    power limit, and XLA_FLAGS."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card_name_and_power_limit(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}
