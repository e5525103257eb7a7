"""Hosek-Wilkie 2012 sky-dataset machinery: exact coefficient cooking.

The reference computes its sky state with the ``hw_skymodel`` crate
(src/raytracer/mod.rs:567-595), a port of the authors' public-domain
``ArHosekSkyModel.c``: the fitted dataset (per RGB channel, 2 albedos x
10 turbidities x 6 solar-elevation control points x 9 distribution
parameters, plus matching radiance tables) is interpolated with a quintic
Bezier over solar elevation and linearly over turbidity and albedo. The
nine cooked parameters feed the exact evaluator the fused kernel
implements (csrc/megakernel.cu sky_channel <-> raytracer.wgsl:316-343) in
the same order: p0..p8 with expM = e^{p4 gamma}, mieM driven by p8.

This module implements that cooking *exactly*, parameterized by the
dataset. The fitted dataset itself (~3.6k floats, published with the paper
as ``ArHosekSkyModelData_RGB.h``) cannot be vendored from this offline
build environment, so:

- ``load_dataset(path)`` accepts either a ``.npz`` with arrays
  ``config [3, 2, 10, 6, 9]`` and ``radiance [3, 2, 10, 6]``, or the
  original ``ArHosekSkyModelData_RGB.h`` C header, which is parsed
  directly (datasets appear as datasetRGB1/2/3 + datasetRGBRad1/2/3 in
  albedo-major, turbidity-next layout).
- Set ``WRT_HW_DATASET=/path/to/dataset`` (or pass ``hw_dataset_path`` to
  ``to_sky_state``) and every render uses the true Hosek-Wilkie sky; the
  built-in Preetham-fit coefficients (models/sky.py) remain the fallback.
"""
from __future__ import annotations

import math
import os
import re
from typing import Optional, Tuple

import numpy as np

_N_TURBIDITY = 10
_N_CTRL = 6
_N_PARAM = 9


def parse_rgb_header(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ArHosekSkyModelData_RGB.h into (config, radiance) arrays.

    Layout per the authors' C source: ``datasetRGBn`` holds
    [albedo][turbidity][ctrl][param] contiguously (2*10*6*9 = 1080 floats)
    and ``datasetRGBRadn`` holds [albedo][turbidity][ctrl] (120 floats),
    n = 1..3 for the R, G, B channels.
    """
    text = open(path, "r", errors="replace").read()
    # The published header carries // and /* */ comments (including
    # "// albedo 0, turbidity 1" markers INSIDE the array initializers,
    # whose digits a bare number scan would swallow) — strip them first.
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    num = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")

    def block(name, count):
        m = re.search(name + r"\s*\[\s*\]\s*=\s*\{(.*?)\}\s*;", text, re.S)
        if m is None:
            raise ValueError(f"{name} not found in {path}")
        vals = [float(v) for v in num.findall(m.group(1))]
        if len(vals) != count:
            raise ValueError(
                f"{name}: expected {count} values, found {len(vals)}")
        return np.asarray(vals, dtype=np.float64)

    config = np.stack([
        block(f"datasetRGB{i}", 2 * _N_TURBIDITY * _N_CTRL * _N_PARAM)
        .reshape(2, _N_TURBIDITY, _N_CTRL, _N_PARAM)
        for i in (1, 2, 3)
    ])
    radiance = np.stack([
        block(f"datasetRGBRad{i}", 2 * _N_TURBIDITY * _N_CTRL)
        .reshape(2, _N_TURBIDITY, _N_CTRL)
        for i in (1, 2, 3)
    ])
    return config, radiance


def load_dataset(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load (config [3,2,10,6,9], radiance [3,2,10,6]) from .npz or .h."""
    if path.endswith(".npz"):
        data = np.load(path)
        config = np.asarray(data["config"], dtype=np.float64)
        radiance = np.asarray(data["radiance"], dtype=np.float64)
    else:
        config, radiance = parse_rgb_header(path)
    if config.shape != (3, 2, _N_TURBIDITY, _N_CTRL, _N_PARAM):
        raise ValueError(f"config shape {config.shape}")
    if radiance.shape != (3, 2, _N_TURBIDITY, _N_CTRL):
        raise ValueError(f"radiance shape {radiance.shape}")
    return config, radiance


def _bezier(ctrl: np.ndarray, t: float) -> np.ndarray:
    """Quintic Bezier over the 6 elevation control points (axis 0),
    exactly as ArHosekSkyModel_CookConfiguration."""
    s = 1.0 - t
    w = np.array([
        s ** 5,
        5.0 * t * s ** 4,
        10.0 * t ** 2 * s ** 3,
        10.0 * t ** 3 * s ** 2,
        5.0 * t ** 4 * s,
        t ** 5,
    ])
    return np.tensordot(w, ctrl, axes=(0, 0))


def cook(config: np.ndarray, radiance: np.ndarray, turbidity: float,
         albedo: np.ndarray, solar_elevation: float):
    """Cook the 9 per-channel parameters + radiance scales.

    Mirrors ArHosekSkyModel_CookConfiguration/CookRadianceConfiguration:
    elevation is gamma-warped (t = (eta / (pi/2))^(1/3)), turbidity
    interpolates linearly between its integer neighbours, albedo linearly
    between the fitted 0 and 1 tables (here per RGB channel, like the
    reference passing its albedo triple to hw_skymodel, mod.rs:572-578).

    Returns (params [3, 9], radiances [3]).
    """
    turbidity = min(max(float(turbidity), 1.0), 10.0)
    eta = min(max(float(solar_elevation), 0.0), 0.5 * math.pi)
    t = (eta / (0.5 * math.pi)) ** (1.0 / 3.0)
    it = int(turbidity)
    rem = turbidity - it
    lo = it - 1
    hi = min(it, _N_TURBIDITY - 1)
    alb = np.clip(np.asarray(albedo, dtype=np.float64), 0.0, 1.0)

    def blend(table):
        # table axes: [channel, albedo, turbidity, ctrl, ...]
        a0 = (1.0 - rem) * _bezier(np.moveaxis(table[:, 0, lo], 1, 0), t) \
            + rem * _bezier(np.moveaxis(table[:, 0, hi], 1, 0), t)
        a1 = (1.0 - rem) * _bezier(np.moveaxis(table[:, 1, lo], 1, 0), t) \
            + rem * _bezier(np.moveaxis(table[:, 1, hi], 1, 0), t)
        shape = (3,) + (1,) * (a0.ndim - 1)
        w = alb.reshape(shape)
        return (1.0 - w) * a0 + w * a1

    params = blend(config)  # [3, 9]
    rads = blend(radiance[..., None])[..., 0]  # [3]
    return params, rads


def to_sky_state_hw(sky, dataset_path: Optional[str] = None,
                    exposure_scale: float = 1.0, *, device):
    """Exact Hosek-Wilkie SkyState from a user-provided dataset, on
    ``device``.

    Returns None when no dataset is configured (caller falls back to the
    built-in Preetham-fit coefficients)."""
    path = dataset_path or os.environ.get("WRT_HW_DATASET")
    if not path:
        return None
    config, radiance = _load_cached(path)
    from .angle import Angle
    from .sky import SkyState

    azimuth = Angle.degrees(sky.azimuth_degrees).as_radians()
    zenith = Angle.degrees(sky.zenith_degrees).as_radians()
    elevation = 0.5 * math.pi - zenith
    params, rads = cook(config, radiance, sky.turbidity,
                        np.asarray(sky.albedo), elevation)
    sun_direction = np.array([
        math.sin(zenith) * math.cos(azimuth),
        math.cos(zenith),
        math.sin(zenith) * math.sin(azimuth),
    ])
    return SkyState.from_raw(params, exposure_scale * rads, sun_direction,
                             device=device)


_cache = {}


def _load_cached(path: str):
    key = (path, os.path.getmtime(path))
    if key not in _cache:
        _cache.clear()
        _cache[key] = load_dataset(path)
    return _cache[key]
