"""The one traffic generator: a mix is a data file (``traffic/<mix>.json``)
that names its driver (``drivers/<kind>.py``) and lists its images; this
module makes those images from the run's seed.

An entry of ``images`` is ``{"w", "h", "count", "channels"}`` (3 RGB, 4
RGBA); a driver may read further keys of its own. Every seed gets the same
sizes in the same order; the seed draws their content.

A photo is u8 with a natural image's 1/f amplitude spectrum and random
phases (the smoke test's ``natural_image``, copied and drawn on the device):
its energy sits at low frequencies, where uniform noise has none. An alpha
channel is one more such field, smooth like a real matte.
"""

from __future__ import annotations

import json
import math
import os

import torch

from benchmark.weights import STREAM_IMAGES, generator


def load_mix(root: str, name: str) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def entries(mix: dict) -> list:
    """The mix's images one by one: [{"w", "h", "channels", ...}]."""
    out = []
    for group in mix["images"]:
        one = {k: v for k, v in group.items() if k != "count"}
        out += [dict(one) for _ in range(group.get("count", 1))]
    return out


def _fields(g: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """``n`` unit-variance fields [n, h, w] with a 1/f amplitude spectrum."""
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    amp = 1.0 / torch.clamp(torch.hypot(fy, fx), min=1.0 / max(h, w))
    phase = torch.rand((n, h, w // 2 + 1), generator=g, device=device)
    f = torch.fft.irfft2(amp * torch.exp(2j * math.pi * phase), s=(h, w))
    f = f - f.mean(dim=(1, 2), keepdim=True)
    return f / f.std(dim=(1, 2), keepdim=True)


def photo(g: torch.Generator, h: int, w: int, channels: int, device) -> torch.Tensor:
    """One u8 [h, w, channels] photo on ``device``."""
    f = _fields(g, 4 + (channels == 4), h, w, device)
    rgb = f[0][..., None] + 0.3 * f[1:4].permute(1, 2, 0)
    planes = [torch.floor(127.5 + 45.0 * rgb + 0.5)]
    if channels == 4:
        planes.append(torch.floor(127.5 + 60.0 * f[4] + 0.5)[..., None])
    return torch.cat(planes, dim=-1).clamp_(0, 255).to(torch.uint8)


def make_images(mix: dict, seed: int, device) -> list:
    """The mix's images as host u8 numpy arrays [h, w, c], drawn on
    ``device`` from ``seed``."""
    g = generator(seed, STREAM_IMAGES, device)
    return [photo(g, e["h"], e["w"], e.get("channels", 3), device).cpu().numpy() for e in entries(mix)]
