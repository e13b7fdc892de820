"""Pieces the cell runners share: the program's model configuration from a
configuration file, the device's name and memory peak."""

from __future__ import annotations

import dataclasses

import torch

MODE_KEYS = ("depth_mode", "conf_mode", "desc_conf_mode")


def model_config(cfg: dict):
    """The program's `ModelConfig` holding the file's architecture keys."""
    from monst3r_slam_torch.models.config import ModelConfig

    kw = {}
    for f in dataclasses.fields(ModelConfig):
        v = cfg[f.name]
        if f.name in MODE_KEYS:
            v = (v[0], float(v[1]), float(v[2]))
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return ModelConfig(**kw)


def device_kind(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def memory_peak(device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def finite(x: float, bad: float = 1e30) -> float:
    """A compared number as JSON can carry it: NaN and infinity read `bad`."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else bad
