"""Analytic daylight sky: azimuth/zenith/turbidity/albedo -> SkyState tensors.

Counterpart of weekend_raytracer_tpu/models/sky.py; the coefficient work is
numpy/scipy on the host, and only the finished state becomes tensors.
Capability parity with the reference's ``SkyParams::to_sky_state``
(src/raytracer/mod.rs:543-595), which feeds the 27-param + 3-radiance
Hosek-Wilkie-form evaluator in the shader (raytracer.wgsl:316-343). The
rebuild keeps the reference's *exact evaluation formula* (see
csrc/megakernel.cu sky_channel) so the state has the same shape and
meaning:

    SkyState { params: f32[3, 9], radiances: f32[3], sun_direction: f32[3] }

Coefficient source: the reference uses the external ``hw_skymodel`` crate,
which embeds the fitted Hosek-Wilkie 2012 dataset (~3.6k values, not
redistributable here and unavailable offline). This module instead derives
the nine per-channel parameters from the Preetham 1999 model ("A Practical
Analytic Model for Daylight"), whose coefficients are closed form in
turbidity, via a two-tier scheme:

1. **Preferred (scipy present):** sample the full Preetham model (Yxy ->
   linear sRGB) over the (theta, gamma) manifold and least-squares fit all
   nine HW-form parameters *per RGB channel* — spatially varying
   chromaticity (blue zenith, warm horizon, sun glow, golden sunsets).
   The fit depends only on (turbidity, sun zenith) and is cached.
2. **Fallback (no scipy, or a channel fit fails to improve):** map the
   luminance Perez coefficients into the HW slots (p0..p5 = A, B, 1, C, D,
   E; p6 = p7 = 0) for all channels and bake the zenith chromaticity into
   the per-channel radiance scales — correct luminance distribution,
   spatially constant chromaticity.

    Preetham/Perez:  F(theta, gamma) = (1 + A e^{B/cos theta})
                                       (1 + C e^{D gamma} + E cos^2 gamma)
    HW form (wgsl):  (1 + p0 e^{p1/(cos theta + 0.01)})
                     (p2 + p3 e^{p4 gamma} + p5 cos^2 gamma
                      + p6 mieM(p8) + p7 sqrt(cos theta))

Users with the fitted Hosek-Wilkie dataset can inject exact coefficients
via ``SkyState.from_raw``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import logging

import numpy as np
import torch

from .angle import Angle

# Preetham Perez coefficients (A..E), linear in turbidity T, for the
# luminance (Y) and CIE chromaticity (x, y) distributions.
_PEREZ_Y = np.array(
    [
        [0.1787, -1.4630],
        [-0.3554, 0.4275],
        [-0.0227, 5.3251],
        [0.1206, -2.5771],
        [-0.0670, 0.3703],
    ]
)
_PEREZ_X = np.array(
    [
        [-0.0193, -0.2592],
        [-0.0665, 0.0008],
        [-0.0004, 0.2125],
        [-0.0641, -0.8989],
        [-0.0033, 0.0452],
    ]
)
_PEREZ_YC = np.array(
    [
        [-0.0167, -0.2608],
        [-0.0950, 0.0092],
        [-0.0079, 0.2102],
        [-0.0441, -1.6537],
        [-0.0109, 0.0529],
    ]
)

# Preetham zenith chromaticity: [T^2, T, 1] . M . [ts^3, ts^2, ts, 1]
_ZENITH_X = np.array(
    [
        [0.00166, -0.00375, 0.00209, 0.0],
        [-0.02903, 0.06377, -0.03202, 0.00394],
        [0.11693, -0.21196, 0.06052, 0.25886],
    ]
)
_ZENITH_Y = np.array(
    [
        [0.00275, -0.00610, 0.00317, 0.0],
        [-0.04214, 0.08970, -0.04153, 0.00516],
        [0.15346, -0.26756, 0.06670, 0.26688],
    ]
)

# XYZ -> linear sRGB (IEC 61966-2-1)
_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ]
)


@dataclasses.dataclass(frozen=True)
class SkyParams:
    """User-facing sky parameters (reference mod.rs:545-565).

    azimuth_degrees in [0, 360]; zenith_degrees in [0, 90] (sun zenith
    angle — 0 is overhead); turbidity in [1, 10]; albedo RGB in [0, 1].

    Note: the analytic coefficient source (a Preetham-fit in Hosek-Wilkie
    form, see to_sky_state) degenerates below turbidity ~1.9, so values in
    [1, 1.9) render with the 1.9 coefficients (a one-time warning is
    logged when the clamp engages). Ground albedo enters as a first-order
    brightness lift, not the full HW dataset response.
    """

    azimuth_degrees: float = 0.0
    zenith_degrees: float = 85.0
    turbidity: float = 4.0
    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SkyState:
    """Sky state tensors, same shape as the reference's GpuSkyState
    (mod.rs:888-896): 9 params per RGB channel + radiance scale + sun dir."""

    params: torch.Tensor  # f32 [3, 9]
    radiances: torch.Tensor  # f32 [3]
    sun_direction: torch.Tensor  # f32 [3]

    @staticmethod
    def from_raw(params, radiances, sun_direction, *, device) -> "SkyState":
        """Inject externally-computed coefficients (e.g. the real fitted
        Hosek-Wilkie dataset), matching hw_skymodel's ``state.raw()``."""
        def put(a, shape):
            a = np.array(a, dtype=np.float32).reshape(shape)
            return torch.as_tensor(a, device=device)

        return SkyState(
            params=put(params, (3, 9)),
            radiances=put(radiances, (3,)),
            sun_direction=put(sun_direction, (3,)),
        )

    @staticmethod
    def from_numpy(params, radiances, sun_direction, *, device) -> "SkyState":
        """State from numpy arrays (the JAX package's SkyState leaves, in
        field order) on ``device``."""
        return SkyState.from_raw(params, radiances, sun_direction,
                                 device=device)


def _perez_hw_form(cos_theta: float, gamma: float, a, b, c, d, e) -> float:
    """Host-side evaluation of the HW-form distribution with the Preetham
    mapping (p2=1, p6=p7=0); used to normalize the zenith radiance scale.

    The quadratic term is e*cos^2(GAMMA) — matching the device evaluator
    (csrc/megakernel.cu) and the vectorized _perez below; it was briefly
    e*cos^2(theta), dimming the scipy-less fallback sky ~8% off-zenith."""
    return (1.0 + a * math.exp(b / (cos_theta + 0.01))) * (
        1.0 + c * math.exp(d * gamma) + e * math.cos(gamma) ** 2
    )


def _perez(coeffs: np.ndarray, t: float, cos_theta, gamma):
    """Vectorized Perez distribution F(theta, gamma) for one channel."""
    a, b, c, d, e = (coeffs[:, 0] * t + coeffs[:, 1]).tolist()
    ct = np.maximum(np.asarray(cos_theta, dtype=np.float64), 1e-2)
    g = np.asarray(gamma, dtype=np.float64)
    return (1.0 + a * np.exp(b / ct)) * (
        1.0 + c * np.exp(d * g) + e * np.cos(g) ** 2
    )


def _preetham_rgb(cos_theta, gamma, t: float, ts: float) -> np.ndarray:
    """Full Preetham model: absolute Yxy at (theta, gamma) -> linear sRGB.

    cos_theta/gamma are arrays of view angles; ts is the sun zenith angle.
    """
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * ts)
    y_zenith = max(1e-4, (4.0453 * t - 4.9710) * math.tan(chi) - 0.2155 * t + 2.4192)
    t_vec = np.array([t * t, t, 1.0])
    s_vec = np.array([ts**3, ts**2, ts, 1.0])
    x_zenith = float(t_vec @ _ZENITH_X @ s_vec)
    yc_zenith = float(t_vec @ _ZENITH_Y @ s_vec)

    def dist(coeffs, zenith_value):
        return zenith_value * _perez(coeffs, t, cos_theta, gamma) / _perez(
            coeffs, t, 1.0, ts
        )

    big_y = dist(_PEREZ_Y, y_zenith)
    x = dist(_PEREZ_X, x_zenith)
    yc = dist(_PEREZ_YC, yc_zenith)
    yc = np.maximum(yc, 1e-4)
    big_x = x / yc * big_y
    big_z = (1.0 - x - yc) / yc * big_y
    rgb = np.stack([big_x, big_y, big_z], axis=-1) @ _XYZ_TO_SRGB.T
    return np.maximum(rgb, 1e-5)


def _fit_hw_params(cos_theta, gamma, target, x0) -> np.ndarray | None:
    """Least-squares fit of the 9 HW-form parameters to one channel's
    sampled radiance (target pre-divided by its scale). Returns None when
    scipy is unavailable or the fit fails to improve on the init."""
    try:
        from scipy.optimize import least_squares
    except ImportError:
        return None

    ct = np.asarray(cos_theta)
    g = np.asarray(gamma)
    cg = np.cos(g)
    w = 1.0 / (target + 0.05 * target.max())

    def model(p):
        mie_base = np.maximum(1.0 + p[8] * p[8] - 2.0 * p[8] * cg, 1e-4)
        mie = (1.0 + cg**2) / (mie_base * np.sqrt(mie_base))
        lhs = 1.0 + p[0] * np.exp(p[1] / (ct + 0.01))
        rhs = (p[2] + p[3] * np.exp(p[4] * g) + p[5] * cg**2
               + p[6] * mie + p[7] * np.sqrt(ct))
        return lhs * rhs

    def resid(p):
        return (model(p) - target) * w

    lo = [-5.0, -8.0, 0.0, -5.0, -20.0, -5.0, 0.0, -5.0, 0.0]
    hi = [5.0, -1e-3, 5.0, 20.0, -1e-3, 5.0, 10.0, 5.0, 0.95]
    x0 = np.clip(x0, lo, hi)
    try:
        res = least_squares(resid, x0, bounds=(lo, hi), max_nfev=200)
    except Exception:
        return None
    if not np.isfinite(res.x).all():
        return None
    if np.mean(resid(res.x) ** 2) > 0.995 * np.mean(resid(x0) ** 2):
        return None  # no real improvement; keep the analytic mapping
    return res.x


SKY_MODEL_EXACT = "hosek-wilkie-2012-exact"
SKY_MODEL_FIT = "preetham-fit-builtin"


def resolve_sky_state(sky: SkyParams, exposure_scale: float = 1.0,
                      hw_dataset_path: str | None = None, *, device,
                      ) -> tuple[SkyState, str]:
    """``to_sky_state`` plus the name of the model that ACTUALLY produced
    the state — derived from whether the exact dataset cooking returned,
    not from the configuration alone, so provenance stats can never name
    a model the render didn't use (ADVICE r3 #2). Surfaced by the CLI /
    bench.py so every render states its sky provenance plainly."""
    from .hw_dataset import to_sky_state_hw

    exact = to_sky_state_hw(sky, hw_dataset_path, exposure_scale,
                            device=device)
    if exact is not None:
        return exact, SKY_MODEL_EXACT
    sky = dataclasses.replace(sky, albedo=tuple(float(a) for a in sky.albedo))
    params, radiances, sun = _to_sky_state_cached(sky, float(exposure_scale))
    return (SkyState.from_raw(params, radiances, sun, device=device),
            SKY_MODEL_FIT)


def to_sky_state(sky: SkyParams, exposure_scale: float = 1.0,
                 hw_dataset_path: str | None = None, *, device) -> SkyState:
    """Compute the SkyState on ``device`` (reference mod.rs:567-595).

    When the fitted Hosek-Wilkie dataset is available (``hw_dataset_path``
    or the ``WRT_HW_DATASET`` env var pointing at the published
    ArHosekSkyModelData_RGB.h or an equivalent .npz), coefficients are
    cooked exactly like the reference's hw_skymodel crate
    (models/hw_dataset.py). Otherwise the built-in Preetham-derived fit
    supplies them (module docstring).

    The sun direction convention matches mod.rs:573-579:
    [sin(zenith) cos(azimuth), cos(zenith), sin(zenith) sin(azimuth)].
    The expensive per-channel fit is cached on (turbidity, sun zenith)
    only — it is azimuth-invariant — so interactive azimuth sweeps are
    free. Albedo is normalized to a tuple for hashability.
    """
    return resolve_sky_state(sky, exposure_scale, hw_dataset_path,
                             device=device)[0]


_warned_turbidity_clamp = False


@functools.lru_cache(maxsize=64)
def _to_sky_state_cached(sky: SkyParams, exposure_scale: float):
    """(params [3, 9], radiances [3], sun direction [3]) as f32 numpy
    arrays; the caller places them on its device."""
    azimuth = Angle.degrees(sky.azimuth_degrees).as_radians()
    zenith = Angle.degrees(sky.zenith_degrees).as_radians()
    # The Preetham luminance distribution degenerates below T ~ 1.7 (the
    # 1 + A e^{B/cos(theta)} factor goes negative at the zenith, flipping
    # the normalized radiance sign at the horizon) — a known limitation of
    # the model. Clamp the coefficient turbidity; the user-facing range
    # stays [1, 10] (documented on SkyParams; warn once so sweeps over
    # [1, 1.9) aren't silently identical).
    t = max(1.9, min(10.0, float(sky.turbidity)))
    if float(sky.turbidity) < 1.9:
        global _warned_turbidity_clamp
        if not _warned_turbidity_clamp:
            _warned_turbidity_clamp = True
            logging.getLogger(__name__).warning(
                "sky turbidity %.2f below the analytic model's valid range;"
                " rendering with turbidity 1.9 (see SkyParams docs)",
                float(sky.turbidity),
            )

    sun_direction = np.array(
        [
            math.sin(zenith) * math.cos(azimuth),
            math.cos(zenith),
            math.sin(zenith) * math.sin(azimuth),
        ]
    )

    # Perez luminance coefficients at this turbidity.
    a, b, c, d, e = (_PEREZ_Y[:, 0] * t + _PEREZ_Y[:, 1]).tolist()

    # Zenith radiance via the shared full-model helper (Preetham eq.
    # A.2-A.4 + Yxy -> sRGB live in one place: _preetham_rgb).
    ts = zenith  # sun zenith angle
    rgb_zenith = _preetham_rgb(np.array([1.0]), np.array([ts]), t, ts)[0]

    # First-order ground-albedo lift (the Preetham model has no albedo
    # input; Hosek-Wilkie's dataset does — approximate it as a small
    # per-channel brightening from ground bounce).
    albedo = np.asarray(sky.albedo, dtype=np.float64)

    # Fallback mapping: luminance distribution shared by all channels,
    # chromaticity baked into the per-channel radiance scale.
    f_zenith = _perez_hw_form(1.0, ts, a, b, c, d, e)
    radiances = (
        exposure_scale * rgb_zenith * (1.0 + 0.15 * albedo)
        / max(f_zenith, 1e-6)
    )
    params_one = np.array([a, b, 1.0, c, d, e, 0.0, 0.0, 0.8])
    params = np.tile(params_one, (3, 1))

    # Preferred: fit the 9 HW-form parameters per RGB channel to the full
    # Preetham chromaticity surfaces (blue zenith, warm horizon, sun glow)
    # sampled over the (theta, gamma) manifold. Falls back to the shared-
    # distribution mapping above when scipy is missing or a channel fit
    # doesn't improve.
    fitted = _fit_channels(t, ts)
    if fitted is not None:
        params_f, scales_f = fitted
        params = np.asarray(params_f)
        radiances = exposure_scale * np.asarray(scales_f) * (1.0 + 0.15 * albedo)

    # read-only: the arrays are shared by every hit of the cache
    out = tuple(np.asarray(a, dtype=np.float32)
                for a in (params, radiances, sun_direction))
    for a in out:
        a.flags.writeable = False
    return out


@functools.lru_cache(maxsize=64)
def _fit_channels(t: float, ts: float):
    """Sample the full Preetham RGB sky and fit per-channel HW params.

    Returns (params [3, 9] tuple-of-tuples, scales [3] tuple) or None when
    fitting isn't possible/profitable for all three channels. The sky
    radiance depends only on (theta from zenith, gamma from sun), so the
    fit is azimuth-invariant and cached on (turbidity, sun zenith) —
    interactive azimuth sweeps cost nothing.
    """
    # Deterministic sampling of the reachable (theta, gamma) manifold:
    # for a view angle theta and sun zenith ts, gamma spans
    # [|theta - ts|, theta + ts]. Sample each theta at several gammas,
    # plus a dense circumsolar set (small gammas at theta ~ ts).
    thetas = np.linspace(0.02, 1.53, 16)
    th_list, ga_list = [], []
    for th in thetas:
        g_lo = abs(th - ts) + 1e-3
        g_hi = min(th + ts, math.pi) - 1e-3
        if g_hi <= g_lo:
            continue
        for frac in (0.0, 0.2, 0.45, 0.7, 1.0):
            th_list.append(th)
            ga_list.append(g_lo + frac * (g_hi - g_lo))
    for g in (0.02, 0.05, 0.1, 0.2, 0.35):
        # circumsolar: theta must make gamma reachable (|th-ts| <= g <=
        # th+ts); at sun zenith ts=0 that forces th == g exactly
        lo = abs(g - ts) + 1e-4
        hi = max(min(g + ts, 1.53) - 1e-4, lo)
        th_list.append(min(max(ts + 0.5 * g, lo), hi))
        ga_list.append(g)
    if len(th_list) < 24:
        # overhead-sun corner: the reachable manifold collapses and a
        # 9-parameter fit would be wildly underdetermined — use the
        # shared-distribution fallback instead
        return None
    theta = np.asarray(th_list)
    gamma = np.asarray(ga_list)
    cos_theta = np.clip(np.cos(theta), 1e-3, 1.0)
    target_rgb = _preetham_rgb(cos_theta, gamma, t, ts)

    a, b, c, d, e = (_PEREZ_Y[:, 0] * t + _PEREZ_Y[:, 1]).tolist()
    x0 = np.array([a, b, 1.0, c, d, e, 0.0, 0.0, 0.3])
    params = np.zeros((3, 9))
    scales = np.zeros(3)
    for ch in range(3):
        scale = float(target_rgb[:, ch].mean())
        if not (scale > 0):
            return None
        fit = _fit_hw_params(cos_theta, gamma, target_rgb[:, ch] / scale, x0)
        if fit is None:
            return None
        params[ch] = fit
        scales[ch] = scale
    # tuples: lru_cache-stored values should be immutable
    return tuple(map(tuple, params)), tuple(scales)
